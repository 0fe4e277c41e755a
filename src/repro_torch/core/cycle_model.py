"""Hardware cycle/throughput model reproducing the paper's Table IV analysis.

The paper's scheme is *deterministic*: one parallelization window per clock
cycle regardless of data (the whole point of restrictions S1+S2), so

    cycles(ours)      = n_windows + PIPELINE_DEPTH
    throughput(ours)  = PWS bytes x f_clk              (16.10 Gb/s @ 251.57 MHz)

The multi-match/unbounded baselines ([10] FIFO, [11] window advance) lose
cycles to (a) each additional match recovered inside a window and (b) each
feedback-loop trip of the unbounded extended-match stage:

    cycles(baseline)  = sum_w max(1, matches_w + extension_reads_w)

which reproduces the ~30-40 % parallelism loss the paper reports (6.4->4.5,
10->6.08 Gb/s).  Frequencies are the clocks of the published FPGA
implementations (paper Table IV), not measurements of any GPU: the Gb/s
this module returns describe the paper's hardware, never this package's
kernels on a card.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .lz4_types import DEFAULT_PWS
from .schemes import MultiMatchResult

PIPELINE_DEPTH = 12  # fill latency of the feedforward pipeline; amortized over a block

# Published clock frequencies (paper Table IV).
FREQ_OURS_MHZ = 251.57
FREQ_BENES_MHZ = 156.25   # [10] — feedback loop limits frequency


@dataclasses.dataclass(frozen=True)
class Throughput:
    cycles: int
    bytes_in: int
    bytes_per_cycle: float
    gbps_at: dict[str, float]  # label -> Gb/s at that frequency


def ours_cycles(n_bytes: int, pws: int = DEFAULT_PWS) -> int:
    return -(-n_bytes // pws) + PIPELINE_DEPTH


def ours_throughput(n_bytes: int, pws: int = DEFAULT_PWS) -> Throughput:
    cycles = ours_cycles(n_bytes, pws)
    bpc = n_bytes / cycles
    return Throughput(
        cycles=cycles,
        bytes_in=n_bytes,
        bytes_per_cycle=bpc,
        gbps_at={
            f"{FREQ_OURS_MHZ}MHz": bpc * FREQ_OURS_MHZ * 1e6 * 8 / 1e9,
        },
    )


def baseline_cycles(result: MultiMatchResult, n_bytes: int, pws: int = DEFAULT_PWS) -> int:
    """Cycle count for the multi-match FIFO baseline on actual data."""
    per_window = np.maximum(1, result.matches_per_window + result.extension_reads)
    return int(per_window.sum()) + PIPELINE_DEPTH


def baseline_throughput(result: MultiMatchResult, n_bytes: int, pws: int = DEFAULT_PWS) -> Throughput:
    cycles = baseline_cycles(result, n_bytes, pws)
    bpc = n_bytes / cycles
    return Throughput(
        cycles=cycles,
        bytes_in=n_bytes,
        bytes_per_cycle=bpc,
        gbps_at={
            f"{FREQ_BENES_MHZ}MHz": bpc * FREQ_BENES_MHZ * 1e6 * 8 / 1e9,
        },
    )


def peak_gbps(pws: int = DEFAULT_PWS, mhz: float = FREQ_OURS_MHZ) -> float:
    """Theoretical peak: PWS bytes/cycle at f_clk."""
    return pws * mhz * 1e6 * 8 / 1e9
