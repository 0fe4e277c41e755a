"""Hand-written Hopper kernels for the write and the read path.

Kernels (CUDA C++ for sm_90a, sources in `../csrc/`):
  fused_compress  — the single-pass hash -> last-value-table candidate ->
                    bounded-match datapath of paper Fig. 5;
  emit_scatter    — device-side byte emission, the write path's last stage;
  window_select   — the single-match free-pointer scan over the windows;
  decode_wave     — pointer-doubling resolve + byte gather of the read path;
  plan_speculative — a candidate LZ4 header at every offset + chain select;
  plan_layout     — the chain's checks and status, and decode_wave's source
                    maps, from the header fields (no plan columns);
  crc32           — CRC-32 of rows of any length (chunks + GF(2) combine);
  fibhash         — word + Fibonacci hash per position (staged compress path);
  match_extend    — bounded match extension given candidates (staged path).

Layout per kernel: <name>.py (wrapper: checks, launch, launch counter, and
the plain version re-exported as `<name>_plain`), `../csrc/<name>.cu` (the
kernel and its C entry point), ref.py (the plain PyTorch versions), ops.py
(stock torch layout stages + dispatch), _build.py (nvcc -> .so -> ctypes).
A wrapper runs the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""
