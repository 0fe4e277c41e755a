"""Roofline analysis: the port of the JAX package's `launch/roofline.py`
(pure Python; no torch needed).

Per (arch x shape) single-pod cell of the port's dry run
(`launch/dryrun.py`, records in ``experiments/torch_dryrun/``):
    compute    = FLOPs_per_dev / peak_FLOPs          [s]
    memory     = bytes_per_dev / HBM_bw              [s]
    collective = collective_bytes_per_dev / link_bw  [s]
The port's records count FLOPs and bytes but no collectives, so their
collective term (and the fused memory term, dot + collective bytes) is
None in a row: a term a record lacks is never taken as 0, and ``dominant``
is the largest of the terms present.

MODEL_FLOPS (useful work): 6*N*D for training, 2*N*D for prefill/decode
(forward only), with N = non-embedding params (+ d*V logits matmul) and
N_active for MoE.  The ratio of measured step time to MODEL_FLOPS / peak is
the model FLOPs utilization (MFU).

The rates are one NVIDIA H100 SXM5 80 GB's, from NVIDIA's H100 data sheet
(https://www.nvidia.com/en-us/data-center/h100/), dense (no sparsity), at
the card's full 700 W power limit.  Rows keep the reference's key names
(``hlo_flops_per_dev`` is the dry run's counted FLOPs).

Usage: python -m repro_torch.launch.roofline [--markdown]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs.base import SHAPES, get_config

PEAK_FLOPS = 989e12   # bfloat16 tensor-core FLOP/s, dense, H100 SXM5 80 GB
HBM_BW = 3.35e12      # B/s of HBM3, H100 SXM5 80 GB
# NVLink 4: 900 GB/s per card, the sum over its 18 links of both directions.
LINK_BW = 900e9

DRYRUN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                          "torch_dryrun")

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "layer_param_count", "model_param_count",
           "model_flops", "roofline_terms", "analyze_cell", "suggest", "load_all",
           "dash", "merged_table", "markdown_table", "main"]


def layer_param_count(spec, cfg) -> tuple[float, float]:
    """(total, active) params of one layer."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    if spec.kind in ("attn", "moe"):
        attn = d * nq * hd * 2 + d * nkv * hd * 2
        if spec.cross_attn:
            attn *= 2
        if spec.kind == "moe":
            total = attn + d * cfg.n_experts + cfg.n_experts * 3 * d * f
            active = attn + d * cfg.n_experts + cfg.top_k * 3 * d * f
            return total, active
        mlp = (3 if not cfg.layer_norm else 2) * d * f if (spec.has_mlp and f) else 0
        n = attn + mlp
        return n, n
    if spec.kind == "rglru":
        r = cfg.lru_width or d
        n = 2 * d * r + 2 * r * r + r * d + (3 * d * f if f else 0)
        return n, n
    if spec.kind == "mlstm":
        di = cfg.d_inner or 2 * d
        n = 2 * d * di + 3 * di * di + di * 2 * cfg.n_heads + di * d
        return n, n
    if spec.kind == "slstm":
        n = 4 * d * d + 4 * d * (d // cfg.n_heads) + 3 * d * (4 * d // 3)
        return n, n
    raise ValueError(spec.kind)


def model_param_count(cfg) -> tuple[float, float]:
    """(N_total, N_active) excluding the embedding gather, including logits."""
    total = active = cfg.d_model * cfg.vocab_size  # logits matmul
    for seg in cfg.segments:
        for spec in seg.unit:
            t, a = layer_param_count(spec, cfg)
            total += t * seg.repeats
            active += a * seg.repeats
    if cfg.family == "encdec":
        t, _ = layer_param_count(
            type(cfg.segments[0].unit[0])(kind="attn", attn_type="bidir"), cfg
        )
        total += t * cfg.n_enc_layers
        active += t * cfg.n_enc_layers
    return total, active


def model_flops(cfg, shape, chips: int) -> float:
    """Useful FLOPs per step per device."""
    _, n_active = model_param_count(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch
        mult = 2.0
    return mult * n_active * tokens / chips


def _seconds(tot: dict, keys, rate: float):
    """Sum of ``tot[k]`` over ``keys`` / ``rate``; None where one is absent."""
    if any(tot.get(k) is None for k in keys):
        return None
    return sum(tot[k] for k in keys) / rate


def roofline_terms(tot: dict) -> dict:
    """Seconds of each roofline term from per-device totals (``flops``,
    ``bytes``, ``dot_bytes``, ``coll_bytes``); None for a term whose count
    the totals lack."""
    return {
        "compute_s": _seconds(tot, ("flops",), PEAK_FLOPS),
        "memory_s": _seconds(tot, ("bytes",), HBM_BW),
        # the fused-kernel memory floor: matmul traffic + collectives
        "memory_fused_s": _seconds(tot, ("dot_bytes", "coll_bytes"), HBM_BW),
        "collective_s": _seconds(tot, ("coll_bytes",), LINK_BW),
    }


def _largest(*terms):
    present = [t for t in terms if t is not None]
    return max(present) if present else None


def analyze_cell(rec: dict) -> dict | None:
    if "probe" not in rec:
        return None
    tot = rec["probe"]["total"]
    t = roofline_terms(tot)
    compute, memory, coll = t["compute_s"], t["memory_s"], t["collective_s"]
    if rec["arch"] == "lz4-engine":  # the engine cell reports Gb/s, not 6ND
        bound = _largest(compute, memory, coll)
        return {
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "compute_s": compute, "memory_s": memory, "memory_fused_s": memory,
            "collective_s": coll, "dominant": "memory",
            "model_flops_per_dev": 0.0, "hlo_flops_per_dev": tot["flops"],
            "useful_flops_ratio": 0.0, "roofline_fraction": 0.0,
            "roofline_fraction_fused": 0.0,
            "gbps_per_chip": rec["bytes_per_step"] / rec["chips"] / bound * 8 / 1e9
            if bound else 0.0,
            "coll_by_op": rec["probe"].get("coll_by_op"),
        }
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    memory_fused = t["memory_fused_s"]
    dominant = max(((name, v) for name, v in
                    (("compute", compute), ("memory", memory), ("collective", coll))
                    if v is not None), key=lambda nv: nv[1])
    mf = model_flops(cfg, shape, rec["chips"])
    bound_time = _largest(compute, memory, coll)
    bound_fused = None if memory_fused is None else _largest(compute, memory_fused, coll)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dominant[0],
        "model_flops_per_dev": mf,
        "hlo_flops_per_dev": tot["flops"],
        "useful_flops_ratio": mf / max(tot["flops"], 1.0),
        # fraction of roofline-best: time if only the compute term existed on
        # USEFUL flops, over the actual bounding term
        "roofline_fraction": (mf / PEAK_FLOPS) / bound_time if bound_time else 0.0,
        "roofline_fraction_fused": None if bound_fused is None else (
            (mf / PEAK_FLOPS) / bound_fused if bound_fused else 0.0),
        "memory_fused_s": memory_fused,
        "coll_by_op": rec["probe"].get("coll_by_op"),
    }


def suggest(row: dict) -> str:
    if row["dominant"] == "collective":
        return "reshard/overlap: biggest collective is " + (
            max(row["coll_by_op"], key=row["coll_by_op"].get) if row["coll_by_op"] else "?"
        )
    if row["dominant"] == "memory":
        return "cut bytes: remat policy / bf16 master / fused attention"
    if row["useful_flops_ratio"] < 0.5:
        return "compute-bound but wasteful: cut remat/padded-head/masked-attn waste"
    return "compute-bound: near roofline, overlap remaining collectives"


def load_all(optimized: bool = False) -> list[dict]:
    suffix = "*__single_opt.json" if optimized else "*__single.json"
    rows = []
    for path in sorted(glob.glob(os.path.join(DRYRUN_DIR, suffix))):
        with open(path) as f:
            rec = json.load(f)
        row = analyze_cell(rec)
        if row:
            row["optimized"] = optimized
            rows.append(row)
    return rows


def dash(x, spec: str, scale: float = 1.0) -> str:
    """``x * scale`` formatted, or an em dash for a term that is absent."""
    return "—" if x is None else format(x * scale, spec)


def merged_table() -> str:
    base = {(r["arch"], r["shape"]): r for r in load_all(False)}
    opt = {(r["arch"], r["shape"]): r for r in load_all(True)}
    lines = [
        "| arch | shape | dominant | useful/HLO base→opt | roofline frac base→opt | fused frac base→opt |",
        "|---|---|---|---|---|---|",
    ]
    for key in sorted(base):
        b = base[key]
        o = opt.get(key) or {}
        lines.append(
            f"| {key[0]} | {key[1]} | {b['dominant']} | "
            f"{dash(b['useful_flops_ratio'], '.2f')}→{dash(o.get('useful_flops_ratio'), '.3f')} | "
            f"{dash(b['roofline_fraction'], '.3f')}→{dash(o.get('roofline_fraction'), '.3f')} | "
            f"{dash(b.get('roofline_fraction_fused', 0), '.3f')}→"
            f"{dash(o.get('roofline_fraction_fused'), '.3f')} |"
        )
    return "\n".join(lines)


def markdown_table(rows: list[dict]) -> str:
    lines = [
        "| arch | shape | compute (ms) | memory (ms) | collective (ms) | dominant | useful/HLO | roofline frac | next move |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {dash(r['compute_s'], '.2f', 1e3)} | "
            f"{dash(r['memory_s'], '.2f', 1e3)} | {dash(r['collective_s'], '.2f', 1e3)} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {suggest(r)} |"
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = load_all()
    out = os.path.join(DRYRUN_DIR, "..", "torch_roofline.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    if args.markdown:
        print(markdown_table(rows))
    else:
        for r in rows:
            print(f"{r['arch']:>18} {r['shape']:>12} dom={r['dominant']:>10} "
                  f"frac={r['roofline_fraction']:.3f} useful={r['useful_flops_ratio']:.2f}")
    print(f"\n[{len(rows)} cells] -> {os.path.abspath(out)}")


if __name__ == "__main__":
    main()
