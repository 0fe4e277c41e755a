"""End-to-end training on the port: train a ~100M-parameter qwen3-family model
with the full substrate stack — LZ4-compressed data shards, LZ4 checkpoints
(async), cosine schedule, failure-recovery drill, gradient compression —
through `repro_torch.launch.train`.

  PYTHONPATH=src python examples/torch_train_lm.py                       # ~100M, 200 steps, on the card
  PYTHONPATH=src python examples/torch_train_lm.py --quick               # tiny, 30 steps
  PYTHONPATH=src python examples/torch_train_lm.py --quick --device cpu  # tiny, on the CPU

The port's twin of `examples/train_lm.py`, with the same arguments to the
trainer.  Checkpoints and token shards go to ``--ckpt-dir``, by default a
fresh temporary directory that is removed afterwards (so every run starts
at step 0).
"""
import argparse
import math
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_")
    if args.quick:
        argv = [
            "--arch", "qwen3-1.7b", "--scale", "tiny",
            "--steps", str(args.steps or 30), "--batch", "4", "--seq", "128",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "10",
            "--grad-compress", "--async-ckpt",
        ]
    else:
        argv = [
            "--arch", "qwen3-1.7b", "--scale", "100m",
            "--steps", str(args.steps or 200), "--batch", "8", "--seq", "256",
            "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
            "--simulate-failure", "60",  # prove recovery mid-run
            "--async-ckpt",
        ]
    try:
        out = train_main(argv + ["--device", args.device])
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if out["final_loss"] is None or not math.isfinite(out["final_loss"]):
        raise SystemExit(f"training ended without a finite loss: {out['final_loss']}")


if __name__ == "__main__":
    main()
