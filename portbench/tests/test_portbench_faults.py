"""Runs of the cells on the CPU, past the harness's look for a card, at a
size a test run holds: sound, with each cell's control, and with the timed
path broken underneath (half of a dispatch's rows left out; a byte altered
where it is produced).  Each broken run must come out not correct.  Also:
`run.py` refuses to run without a card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import harness  # noqa: E402

BENCH = harness.load_json(ROOT.parent / "BENCHMARK.json")
SEED = 2**31 + 99
SMALL = 4 * 65536            # four blocks: one dispatch
BITMAP = 18 * 65536          # reaches the corpus's bitmap, whose runs pass 36 bytes


def run(workload, object_bytes=SMALL, control=False):
    cell = harness.resolve(BENCH, workload)
    return harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                            object_bytes=object_bytes, control=control)


def test_compress_sound():
    r = run("paper.compress.bulk")
    assert r["correct"] and r["attempted"] == 1
    assert r["compared"] == {"table_errors": {"value": 0, "limit": 0},
                             "payload_errors": {"value": 0, "limit": 0},
                             "decode_errors": {"value": 0, "limit": 0}}
    assert list(r)[-1] == "compared"


def test_compress_control_is_not_correct():
    r = run("paper.compress.bulk", BITMAP, control=True)
    assert not r["correct"]
    assert r["compared"]["payload_errors"]["value"] > 0
    assert r["compared"]["decode_errors"]["value"] == 0     # still valid LZ4


def test_decode_sound():
    r = run("paper.decode.bulk64")
    assert r["correct"] and r["compared"]["bytes_wrong"]["value"] == 0


def test_decode_control_is_not_correct():
    r = run("paper.decode.bulk64", control=True)
    assert not r["correct"] and r["compared"]["bytes_wrong"]["value"] > 0


def half_rows(out):
    out[out.shape[0] // 2:] = 0


def first_byte(out):
    out[0, 0] ^= 1


@pytest.mark.parametrize("fault", [half_rows, first_byte])
def test_compress_broken_underneath_is_not_correct(monkeypatch, fault):
    from repro_torch.core import engine

    real = engine.compress_blocks_bytes

    def broken(blocks_u8, ns, **kw):
        if fault is half_rows:          # the rows' lengths never reach the kernels
            ns = ns.clone()
            ns[ns.shape[0] // 2:] = 0
            return real(blocks_u8, ns, **kw)
        out, size = real(blocks_u8, ns, **kw)
        fault(out)
        return out, size

    monkeypatch.setattr(engine, "compress_blocks_bytes", broken)
    r = run("paper.compress.bulk")
    assert not r["correct"] and r["compared"]["payload_errors"]["value"] > 0
    if fault is first_byte:
        assert r["compared"]["decode_errors"]["value"] > 0


def test_compress_planted_fault_is_not_correct():
    """The driver's own fault (control.py --mode fault): one row of every
    dispatch altered where produced; every coded block is decoded, so it
    shows whichever blocks the sample draws."""
    cell = harness.resolve(BENCH, "paper.compress.bulk")
    with cell.driver.plant_fault():
        r = harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                             object_bytes=8 * 65536)
    assert not r["correct"] and r["compared"]["decode_errors"]["value"] == 1


@pytest.mark.parametrize("fault", [half_rows, first_byte])
def test_decode_broken_underneath_is_not_correct(monkeypatch, fault):
    from repro_torch.kernels import ops

    real = ops.plan_decode

    def broken(*args, **kw):
        out, status, crc = real(*args, **kw)
        fault(out)
        return out, status, crc

    monkeypatch.setattr(ops, "plan_decode", broken)
    r = run("paper.decode.bulk64")      # after the CRCs: the program does not see it
    assert not r["correct"] and r["compared"]["bytes_wrong"]["value"] > 0


def command(cwd: Path, workload="paper.compress.bulk"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def no_result(p) -> bool:
    lines = p.stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return "correct" not in json.loads(lines[-1])
    except ValueError:
        return True


def test_run_refuses_without_a_card():
    p = command(ROOT.parent)
    assert p.returncode != 0 and no_result(p)
    assert "CUDA" in p.stderr


def test_run_refuses_in_a_bare_directory(tmp_path):
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = command(tmp_path)
    assert p.returncode != 0 and no_result(p)
