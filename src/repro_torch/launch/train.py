"""End-to-end training entry point: config -> data -> train loop with LZ4
checkpointing, failure recovery, straggler monitoring, optional gradient
compression — the port of the JAX package's `launch/train.py`.

Runs on the card unless ``--device cpu``; on the card the checkpoints,
restores and token shards go through the hand kernels (`LZ4Engine`,
`LZ4DecodeEngine`), on the CPU through their plain versions.

Examples:
  # ~100M-param qwen3-family model for a few hundred steps:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --scale 100m \\
      --steps 200 --batch 8 --seq 256

  # a reduced model on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --scale tiny

  # failure-recovery drill (dies at step 7, restarts from the checkpoint):
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --scale tiny \\
      --steps 20 --simulate-failure 7 --ckpt-every 5
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import get_config
from repro_torch.core.decode_engine import LZ4DecodeEngine
from repro_torch.core.engine import LZ4Engine
from repro_torch.data.pipeline import ShardedTokenPipeline
from repro_torch.distributed.fault import RestartPolicy, SimulatedFailure, StepMonitor
from repro_torch.distributed.sharding import single_device_mesh, use_mesh
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.inputs import make_batch
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.optim.grad_compress import ef_init, quantize_with_error_feedback


def scale_config(cfg, scale: str):
    """Shrink an arch config to a trainable size, keeping its family."""
    if scale == "full":
        return cfg
    if scale == "tiny":
        return cfg.reduced()
    if scale == "100m":
        segs = tuple(
            dataclasses.replace(s, repeats=max(1, min(s.repeats, 8 // len(s.unit))))
            for s in cfg.segments
        )
        return dataclasses.replace(
            cfg,
            d_model=512, n_heads=8,
            n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 8,
            head_dim=64, d_ff=2048 if cfg.d_ff else 0,
            vocab_size=32000, window=min(cfg.window, 512),
            segments=segs,
            n_layers=sum(len(s.unit) * s.repeats for s in segs),
            lru_width=512 if cfg.lru_width else 0,
            d_inner=1024 if cfg.family == "ssm" else 0,
            n_enc_layers=min(cfg.n_enc_layers, 2), enc_seq=64 if cfg.n_enc_layers else 0,
            vision_tokens=16 if cfg.vision_tokens else 0,
            fsdp=False, compute_dtype="float32",
        )
    raise ValueError(scale)


def opt_config(args) -> adamw.AdamWConfig:
    """The optimizer settings of a run (WSD for minicpm, else cosine)."""
    return adamw.AdamWConfig(
        lr=args.lr, total_steps=args.steps,
        schedule="wsd" if args.arch == "minicpm-2b" else "cosine",
        warmup_steps=max(args.steps // 20, 5),
    )


def train(args) -> dict:
    cfg = scale_config(get_config(args.arch), args.scale)
    opt_cfg = opt_config(args)
    # getattr: callers that build their own args namespace predate the flags.
    device = torch.device(getattr(args, "device", "cuda"))
    mesh = single_device_mesh(device)
    restart = RestartPolicy()
    monitor = StepMonitor()
    os.makedirs(args.ckpt_dir, exist_ok=True)
    # --shard-compress N: checkpoint leaves compress through the sharded
    # fabric (host-partition path: block bytes are identical to a mesh run).
    # On the CPU the window select's plain sequential version is a Python
    # loop of 8192 steps per dispatch; the associative scan writes the same
    # blocks ~3x faster there.  The card runs its kernel.
    scan = "associative" if device.type == "cpu" else "sequential"
    ckpt_engine = LZ4Engine(shards=getattr(args, "shard_compress", None), device=device,
                            scan_impl=scan)
    decode_engine = LZ4DecodeEngine(device=device)
    pipe = ShardedTokenPipeline(
        os.path.join(args.ckpt_dir, "data"), cfg.vocab_size, seed=args.seed,
        engine=LZ4Engine(device=device, scan_impl=scan), decode_engine=decode_engine,
    )
    losses = []
    writers = []   # async checkpoint writers, joined before returning

    def fresh_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = lm.init_params(cfg, gen, device=device)
        return params, adamw.init(params)

    def train_step(params, opt_state, ef, batch):
        loss, grads = steps_mod.loss_and_grads(params, batch, cfg)
        with torch.no_grad():
            if ef is not None:
                grads, ef = quantize_with_error_feedback(grads, ef)
            params, opt_state, metrics = adamw.update(grads, opt_state, params, opt_cfg)
        return params, opt_state, ef, {"loss": loss, **metrics}

    with use_mesh(mesh):
        params, opt_state = fresh_state()
        ef = ef_init(params) if args.grad_compress else None
        start_step = 0

        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None and args.resume:
            state_like = {"params": params, "opt": opt_state}
            restored, _ = ckpt.restore(args.ckpt_dir, latest, state_like,
                                       decode_engine=decode_engine)
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

        step = start_step
        while step < args.steps:
            try:
                monitor.start()
                tokens = pipe.batch(step, args.batch, args.seq)
                batch = {"tokens": torch.from_numpy(tokens).to(device)}
                extra = make_batch(step, cfg, args.batch, args.seq, device=device)
                for k in ("enc_embeds", "vision_embeds"):
                    if k in extra:
                        batch[k] = extra[k]
                        batch["tokens"] = extra["tokens"]
                if args.simulate_failure is not None and step == args.simulate_failure:
                    args.simulate_failure = None  # fail exactly once
                    raise SimulatedFailure(f"injected failure at step {step}")
                params, opt_state, ef, metrics = train_step(params, opt_state, ef, batch)
                m = monitor.stop()
                loss = float(metrics["loss"])
                losses.append(loss)
                step += 1
                if step % args.log_every == 0 or step == args.steps:
                    print(
                        f"[train] step {step} loss {loss:.4f} "
                        f"lr {float(metrics['lr']):.2e} gnorm {float(metrics['grad_norm']):.3f} "
                        f"dt {m['step_time']:.2f}s", flush=True,
                    )
                if step % args.ckpt_every == 0 or step == args.steps:
                    written = ckpt.save(
                        args.ckpt_dir, step, {"params": params, "opt": opt_state},
                        async_write=args.async_ckpt, engine=ckpt_engine,
                    )
                    if args.async_ckpt:
                        writers.append(written)
            except SimulatedFailure as e:
                wait = restart.record_failure()
                print(f"[train] FAILURE: {e}; restarting in {wait:.1f}s", flush=True)
                time.sleep(min(wait, 0.1))
                latest = ckpt.latest_step(args.ckpt_dir)
                if latest is None:
                    params, opt_state = fresh_state()
                    step = 0
                else:
                    restored, _ = ckpt.restore(
                        args.ckpt_dir, latest, {"params": params, "opt": opt_state},
                        decode_engine=decode_engine,
                    )
                    params, opt_state = restored["params"], restored["opt"]
                    step = latest
                    print(f"[train] recovered at step {step}", flush=True)
        if monitor.should_remesh():
            print("[train] persistent stragglers detected -> re-mesh requested", flush=True)
    # A writer still running when the interpreter exits would be killed
    # mid-save (and torch aborts the process): finish every async save.
    for w in writers:
        w.join()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "straggler_events": monitor.straggler_events}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--scale", default="tiny", choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--async-ckpt", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--shard-compress", type=int, default=None, metavar="N",
                    help="compress checkpoints through the sharded fabric "
                         "with N shards (host-partition path)")
    ap.add_argument("--simulate-failure", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device that trains (and runs the checkpoint's "
                         "engines): cuda, or cpu for the kernels' plain versions")
    args = ap.parse_args(argv)
    out = train(args)
    print(f"[train] done; final loss {out['final_loss']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()
