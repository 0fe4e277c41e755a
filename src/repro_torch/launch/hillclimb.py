"""Perf hill-climb driver: trace a cell with config variants over ``meta``
tensors and report the roofline terms per variant (hypothesis -> change ->
measure -> record).  The port of the JAX package's `launch/hillclimb.py`.

The counts are the dry run's (`launch/dryrun.py`): FLOPs and bytes of the
traced step, per device under an even split.  It counts no collectives, so
the collective and fused-memory terms are None and the bound is the larger
of compute and memory.  Variants that only steer the reference's compiler
(``seq_shard``, ``decode_cache_axes``) change nothing here.

  python -m repro_torch.launch.hillclimb --cell internlm2-train

Writes ``experiments/torch_hillclimb_<cell>.json`` beside the dry run's
records.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.distributed.sharding import use_mesh
from repro_torch.launch.dryrun import OUT_DIR, run_lz4_cell, step_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import PEAK_FLOPS, dash, model_flops, roofline_terms
from repro_torch.launch.steps import serving_config


def _ms(x) -> str:
    return dash(x, ".1f", 1e3)


def measure(cfg, shape, mesh, label: str) -> dict:
    """Roofline terms of ``cfg`` at ``shape`` on ``mesh`` (under the current
    mesh, which moe_ffn reads)."""
    t0 = time.time()
    tot, _ = step_cost(cfg, shape)
    tot = {k: v / mesh.size for k, v in tot.items()}
    out = {"label": label, **roofline_terms(tot),
           "flops": tot["flops"], "bytes": tot["bytes"], "dot_bytes": tot["dot_bytes"],
           "coll_bytes": None, "coll_by_op": None, "wall_s": time.time() - t0}
    mf = model_flops(cfg, shape, mesh.size)
    useful_s = mf / PEAK_FLOPS
    bound = max(t for t in (out["compute_s"], out["memory_s"], out["collective_s"])
                if t is not None)
    out["useful_ratio"] = mf / max(tot["flops"], 1.0)
    out["roofline_fraction"] = useful_s / bound if bound else 0.0
    # the fused memory term needs the collectives, which the port does not count
    out["roofline_fraction_fused"] = None
    print(
        f"[{label:>28}] comp {_ms(out['compute_s']):>8}ms  "
        f"mem {_ms(out['memory_s']):>8}ms (fused {_ms(out['memory_fused_s'])})  "
        f"coll {_ms(out['collective_s'])}ms  "
        f"useful {out['useful_ratio']:.2f}  frac {out['roofline_fraction']:.4f}",
        flush=True,
    )
    return out


def cell_internlm2_train():
    cfg0 = get_config("internlm2-1.8b")
    shape = SHAPES["train_4k"]
    mesh = make_production_mesh(device="meta")
    results = []
    with use_mesh(mesh):
        results.append(measure(cfg0, shape, mesh, "baseline (paper-faithful)"))
        results.append(
            measure(dataclasses.replace(cfg0, seq_shard=True), shape, mesh,
                    "H2: megatron-SP residual")
        )
        results.append(
            measure(dataclasses.replace(cfg0, remat_policy="dots"), shape, mesh,
                    "H3: dots-saveable remat")
        )
        results.append(
            measure(dataclasses.replace(cfg0, seq_shard=True, remat_policy="dots"),
                    shape, mesh, "H2+H3 combined")
        )
        results.append(
            measure(dataclasses.replace(cfg0, pure_dp=True, remat_policy="dots"),
                    shape, mesh, "H4: pure-DP (model axis=DP)")
        )
    return results


def cell_gemma2_long_decode():
    """The reference's most collective-bound cell: 500k-token decode."""
    cfg0 = get_config("gemma2-9b")
    shape = SHAPES["long_500k"]
    mesh = make_production_mesh(device="meta")
    results = []
    with use_mesh(mesh):
        base = serving_config(cfg0, mesh)
        results.append(measure(base, shape, mesh, "baseline (dus cache write)"))
        results.append(
            measure(dataclasses.replace(base, cache_update="masked"), shape, mesh,
                    "H1: masked cache update")
        )
        pinned = dataclasses.replace(base, decode_cache_axes=("data", "model"))
        results.append(
            measure(pinned, shape, mesh, "H2: pin flash-decode sharding")
        )
        results.append(
            measure(dataclasses.replace(pinned, cache_update="masked"), shape, mesh,
                    "H2+H1 pinned + masked")
        )
    return results


def cell_lz4_engine():
    """The paper's own workload: iterate the engine's roofline."""
    results = []
    for label, kw in [
        ("baseline associative", dict(scan_impl="associative")),
        ("H1: scatter-max candidates", dict(scan_impl="associative", candidate_impl="scatter")),
        ("H2: key-packed sort", dict(scan_impl="associative", candidate_impl="sortkey")),
        ("hash_bits=12 (4K entries)", dict(scan_impl="associative", hash_bits=12)),
    ]:
        rec = run_lz4_cell(False, verbose=False, **kw)
        t = roofline_terms(rec["probe"]["total"])
        out = {"label": label, "compute_s": t["compute_s"], "memory_s": t["memory_s"],
               "collective_s": t["collective_s"], "bytes_per_step": rec["bytes_per_step"]}
        bound = max(x for x in (t["compute_s"], t["memory_s"], t["collective_s"])
                    if x is not None)
        out["gbps_per_chip"] = rec["bytes_per_step"] / rec["chips"] / bound * 8 / 1e9
        print(f"[{label:>28}] comp {_ms(out['compute_s']):>8}ms mem {_ms(out['memory_s']):>8}ms "
              f"coll {_ms(out['collective_s'])}ms -> {out['gbps_per_chip']:.1f} Gb/s/chip",
              flush=True)
        results.append(out)
    return results


def cell_small_arch_posture():
    """Beyond-paper posture fix for the small archs with padded/replicated
    attention (whisper 12 heads, minicpm 36 heads vs TP=16): pure DP."""
    shape = SHAPES["train_4k"]
    mesh = make_production_mesh(device="meta")
    results = []
    with use_mesh(mesh):
        for arch in ("whisper-small", "minicpm-2b", "xlstm-125m"):
            cfg0 = get_config(arch)
            results.append(measure(cfg0, shape, mesh, f"{arch} baseline"))
            results.append(
                measure(
                    dataclasses.replace(cfg0, pure_dp=True, remat_policy="dots",
                                        fsdp=True),
                    shape, mesh, f"{arch} pure-DP+dots",
                )
            )
    return results


CELLS = {
    "internlm2-train": cell_internlm2_train,
    "gemma2-long-decode": cell_gemma2_long_decode,
    "lz4-engine": cell_lz4_engine,
    "small-arch-posture": cell_small_arch_posture,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="internlm2-train", choices=sorted(CELLS))
    args = ap.parse_args(argv)
    results = CELLS[args.cell]()
    path = os.path.join(OUT_DIR, "..", f"torch_hillclimb_{args.cell}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
