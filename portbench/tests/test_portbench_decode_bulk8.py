"""`paper.decode.bulk8` on the CPU, past the harness's look for a card, at
16 blocks (two dispatches of 8): sound, under its control (a literal byte
altered in one coded block in 16, the CRCs unchecked), and with the timed
path broken underneath (half of a dispatch's rows zeroed, or one byte
altered, where `plan_decode` produces them, after the CRCs)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import harness  # noqa: E402
from portbench.tests.test_portbench_faults import first_byte, half_rows  # noqa: E402

BENCH = harness.load_json(ROOT.parent / "BENCHMARK.json")
CELL = "paper.decode.bulk8"
SEED = 2**33 + 17
BLOCKS = 16


def run(control=False):
    cell = harness.resolve(BENCH, CELL)
    assert cell.traffic["blocks_per_dispatch"] == 8
    return harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                            object_bytes=BLOCKS * 65536, control=control)


@pytest.mark.parametrize("case", ["sound", "control", half_rows, first_byte],
                         ids=["sound", "control", "half_rows", "first_byte"])
def test_decode_bulk8_is_correct_only_when_sound(monkeypatch, case):
    if callable(case):
        from repro_torch.kernels import ops

        real = ops.plan_decode

        def broken(*args, **kw):
            out, status, crc = real(*args, **kw)
            case(out)
            return out, status, crc

        monkeypatch.setattr(ops, "plan_decode", broken)
    r = run(control=case == "control")
    wrong = r["compared"]["bytes_wrong"]["value"]
    if case == "sound":
        assert r["correct"] and wrong == 0 and list(r)[-1] == "compared"
    else:
        assert not r["correct"] and wrong > 0
