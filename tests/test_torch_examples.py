"""The port's examples (`examples/torch_*.py`), its docs page and its CPU
workflow, on the CPU.

Each example runs in a subprocess with ``--device cpu`` at a reduced size
(the kernels' plain versions), and must exit 0 and print the "OK" lines of
its reference twin (`examples/{quickstart,compress_file,serve_lm,train_lm}.py`);
without ``--device`` an example asks for the card and must refuse here
rather than fall back.  `tools/check_docs.py` must pass over every
`docs/*.md`, `docs/torch-port.md` must name every module of the port, and
`.github/workflows/torch-port.yml` must run what this file runs.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.cycle_model import ours_throughput as ref_throughput

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ("torch_quickstart", "torch_compress_file", "torch_serve_lm", "torch_train_lm")


def run_example(name: str, *args: str, tmp_path: Path, timeout: int = 120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"), *args],
                          capture_output=True, text=True, timeout=timeout, env=env,
                          cwd=str(ROOT))


def ok(proc) -> list[str]:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def test_quickstart_prints_the_references_ok_lines(tmp_path):
    lines = ok(run_example("torch_quickstart", "--device", "cpu", tmp_path=tmp_path))
    assert lines[0].startswith("LZ4Engine(cpu): ratio ")
    assert lines[0].endswith("1 block(s), 1 dispatch(es), frame round-trip OK")
    assert "frames bit-identical" in lines[1]
    assert lines[2] == ("random access: read_range(200000, 1000) decoded 1/6 blocks; "
                        "parallel decode OK")
    assert lines[3].endswith("device-resident restore fetched 0 plaintext bytes to host")
    t = ref_throughput(32768)
    assert lines[7] == (f"hardware model: {t.bytes_per_cycle:.3f} B/cycle -> "
                        f"{list(t.gbps_at.values())[0]:.2f} Gb/s @ 251.57 MHz (paper: 16.10)")
    assert lines[8] == "golden numpy model == exact LZ4 block format, decoder verified"


def test_compress_file_round_trips_a_small_file(tmp_path):
    """Three blocks at micro-batch 2: two dispatches, one raw block."""
    rng = np.random.default_rng(5)
    data = (b"compress_file example " * 6000)[:131072] + rng.bytes(20000)
    path = tmp_path / "small.bin"
    path.write_bytes(data)
    lines = ok(run_example("torch_compress_file", str(path), "--micro-batch", "2",
                           "--device", "cpu", tmp_path=tmp_path))
    assert len(lines) == 1 and lines[0].endswith("round-trip OK")
    assert f"{len(data):>8} -> " in lines[0]
    assert "[3 blocks / 2 dispatches, 1 raw]" in lines[0]


def test_serve_lm_restores_the_kv_cache_bit_exactly(tmp_path):
    lines = ok(run_example("torch_serve_lm", "--device", "cpu", tmp_path=tmp_path))
    reqs = [ln for ln in lines if ln.startswith("req ")]
    assert [ln.split(":")[0] for ln in reqs] == [f"req {i}" for i in range(6)]
    for ln in reqs:
        assert len(json.loads(ln.split("-> ")[1])) == 8
    assert lines[-1].startswith("KV offload: ")
    assert lines[-1].endswith("bit-exact restore: True")


def test_train_lm_quick_trains_and_finishes_its_async_checkpoint(tmp_path):
    """Four steps, one (async) checkpoint at step 4: the process exits 0 and
    the checkpoint is complete when it does."""
    ckpt_dir = tmp_path / "ckpt"
    lines = ok(run_example("torch_train_lm", "--quick", "--steps", "4",
                           "--ckpt-dir", str(ckpt_dir), "--device", "cpu",
                           tmp_path=tmp_path))
    assert lines[0].startswith("[train] step 4 loss ")
    assert lines[-1].startswith("[train] done; final loss ")
    assert np.isfinite(float(lines[-1].rsplit(" ", 1)[1]))
    assert sorted(p.name for p in ckpt_dir.iterdir()) == ["ckpt_4", "data"]
    assert (ckpt_dir / "ckpt_4" / "manifest.json").is_file()


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_ask_for_the_card_by_default(name, tmp_path):
    """Without ``--device`` each example runs on the card; where there is
    none it raises, and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without CUDA devices")
    args = {"torch_compress_file": (str(ROOT / "docs" / "torch-port.md"),),
            "torch_train_lm": ("--quick", "--steps", "1")}.get(name, ())
    proc = run_example(name, *args, tmp_path=tmp_path)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr or \
        "Torch not compiled with CUDA" in proc.stderr, proc.stderr[-2000:]
    assert "OK" not in proc.stdout


def test_check_docs_passes():
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "check_docs.py")],
                          capture_output=True, text=True, timeout=60, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK: ")


def test_port_doc_names_every_module():
    text = (ROOT / "docs" / "torch-port.md").read_text()
    modules = sorted(p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py"))
    assert len(modules) > 80
    assert [m for m in modules if f"`{m}`" not in text] == []
    for cu in sorted(PORT.glob("csrc/*.cu")):
        assert f"`{cu.name}`" in text


def test_workflow_runs_the_port_tests_docs_and_examples():
    wf = (ROOT / ".github" / "workflows" / "torch-port.yml").read_text()
    assert 'python-version: "3.12"' in wf
    assert "download.pytorch.org/whl/cpu" in wf
    assert "-n auto tests/test_torch_*.py" in wf
    assert "python tools/check_docs.py" in wf
    runs = [ln.strip() for ln in wf.splitlines() if "python examples/" in ln]
    assert [r.split("examples/")[1].split(".py")[0] for r in runs] == list(EXAMPLES)
    assert all(r.endswith("--device cpu") for r in runs)
