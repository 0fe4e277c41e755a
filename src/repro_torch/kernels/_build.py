"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for ``sm_90a`` into its own shared library
with a plain C interface and loaded with `ctypes` — no PyTorch headers, so a
build takes seconds.  All sources are compiled in parallel (one `nvcc`
process each) on the first use of any kernel; libraries are named after a
hash of their source and flags, so an edited source rebuilds and an unchanged
one is reused.  Nothing here runs at import time: a machine without `nvcc`
can import the package and run every CPU path.

Build directory: ``$REPRO_TORCH_BUILD_DIR`` or ``build/`` beside ``src/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
KERNEL_SOURCES = ("fused_compress", "emit_scatter", "window_select",
                  "decode_wave", "plan_speculative", "crc32", "fibhash",
                  "match_extend", "plan_layout")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Dynamic shared memory one CTA may use on Hopper (227 KB, after
# cudaFuncSetAttribute); the wrappers check their kernels' needs against it.
SMEM_PER_CTA = 232448


class KernelRefusal(ValueError):
    """A kernel wrapper refused its inputs (shape, width, alignment, device
    placement) — a caller's bug or a limit of the kernel, never corrupt data.

    A ValueError, as the wrappers always raised; its own type lets code that
    treats ValueError as damage (`checkpoint.restore_with_fallback`, which
    steps back past a step whose manifest does not match its data) let a
    refusal through to the caller instead."""


# The dry run's counters (`launch/dryrun.py` pushes one while it traces): a
# wrapper given ``meta`` tensors launches nothing and adds here the bytes
# its kernel would move.
meta_counters: list = []


def count_meta_call(kernel: str, nbytes: int) -> None:
    """One call of ``kernel`` on ``meta`` tensors, moving ``nbytes``."""
    for counter in meta_counters:
        counter.kernel(kernel, nbytes)


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None   # wall time of the last real build
build_log: dict[str, str] = {}       # nvcc output per source (ptxas -v lines)


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build"


def find_nvcc() -> str | None:
    """`nvcc` from PATH, else from $CUDA_HOME / the conventional location."""
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    return None


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{tag}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel source that has no up-to-date library.

    One `nvcc` per source, all started together.  Raises RuntimeError (with
    the compiler's output) if `nvcc` is missing or any compile fails.
    """
    global build_seconds
    paths = {name: _lib_path(name) for name in KERNEL_SOURCES}
    todo = [name for name, path in paths.items() if not path.is_file()]
    if not todo:
        return paths
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels of repro_torch cannot be built on this machine")
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        tmp = paths[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, paths[name])   # atomic: no half-written library
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source (building all on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a refused launch."""
    if err != 0:
        raise RuntimeError(
            f"{kernel}: CUDA launch failed with error code {err} "
            "(cudaGetLastError after the launch)")
