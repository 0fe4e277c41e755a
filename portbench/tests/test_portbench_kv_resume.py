"""`qwen3kv.resume.sessions4` on the CPU, past the harness's look for a card,
on a copy of `portbench/` with a small configuration and traffic of its own:
qwen3-1.7b's layer pattern at one layer, hidden size 64 and bfloat16
compute, with the published K/V widths (8 heads of 128) so that a layer's
K and V at ``cache_len`` 64 span two 64 KiB blocks; sessions of 32, 48, 56
and 64 tokens (1/2, 3/4, 7/8 and all of it).  The frames then hold raw
blocks (filled positions) beside coded ones (zero tails).

The program's `restore_cache` equals the plain reference's `resume` and the
original caches, the reference's `park` is restored by the program, the
cell is correct when sound and not under its control or its planted fault,
and it passes the three checks of `checks.py`."""
import contextlib
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT.parent), str(ROOT.parent / "src")]

from portbench import harness  # noqa: E402
from portbench.reference import kv_resume as ref  # noqa: E402
from portbench.reference import lz4_paper  # noqa: E402
from portbench.tests import checks  # noqa: E402
from portbench.tests.test_portbench_metrics import EXPECTED  # noqa: E402

BENCH = harness.load_json(ROOT.parent / "BENCHMARK.json")
CELL = "qwen3kv.resume.sessions4"
SMALL = "qwen3kv.resume.small"
SEED = 2**33 + 29
SMALL_MODEL = dict(num_hidden_layers=1, hidden_size=64, intermediate_size=128,
                   vocab_size=256)
CACHE_LEN = 64
SESSIONS = [32, 48, 56, 64]


def add_small_cell(root: Path) -> dict:
    """The small configuration, traffic and cell, as new files and entries
    under ``root``, reporting every metric the full cell reports; the
    BENCHMARK.json."""
    config = harness.load_json(root / "configs" / "kv-qwen3-1.7b.json")
    config.update(name="kv-small", cache_len=CACHE_LEN)
    config["model"].update(SMALL_MODEL)
    (root / "configs" / "kv-small.json").write_text(json.dumps(config))
    traffic = harness.load_json(root / "traffic" / "kv.resume.sessions4.json")
    traffic["sessions"] = SESSIONS
    (root / "traffic" / "kv.resume.small.json").write_text(json.dumps(traffic))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "kv-small", "source": "a test",
                             "file": "portbench/configs/kv-small.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": SMALL, "config": "kv-small",
                               "traffic": "kv.resume.small", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(SMALL)
    return bench


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(BENCHMARK.json, root) of a copy of portbench/ with the small cell."""
    root = tmp_path_factory.mktemp("kv") / "portbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns("__pycache__"))
    return add_small_cell(root), root


@pytest.fixture(scope="module")
def driver(small):
    """The small cell's driver after set-up: sessions built and parked."""
    bench, root = small
    cell = harness.resolve(bench, SMALL, root)
    return cell.driver.Driver(cell.config, cell.traffic, b"", "cpu", telemetry=False,
                              seed=SEED)


def plain(tree):
    """A cache tree as the reference's `Leaf`s."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(plain(v) for v in tree)
    if tree is None:
        return None
    return ref.Leaf(tree.reshape(-1).view(torch.uint8).numpy().tobytes(),
                    str(tree.dtype).removeprefix("torch."), tree.shape)


def leaf_bytes(x) -> bytes:
    if isinstance(x, ref.Leaf):
        return bytes(x.data)
    return x.reshape(-1).view(torch.uint8).numpy().tobytes()


def assert_same(got, want) -> None:
    """Leaf for leaf, ``got`` (tensors or `Leaf`s) has ``want``'s dtype,
    shape and bytes."""
    g, w = ref.flatten(got), ref.flatten(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype).removeprefix("torch.")
        assert tuple(a.shape) == tuple(b.shape)
        assert leaf_bytes(a) == leaf_bytes(b)


def test_the_full_size_model_is_qwen3_1_7b():
    from repro_torch.configs import get_config

    cell = harness.resolve(BENCH, CELL)
    cfg = cell.driver.model_config(cell.config["model"])
    assert cfg == get_config("qwen3-1.7b") and cfg.compute_dtype == "bfloat16"
    assert (cfg.n_layers, cfg.n_kv_heads, cfg.hd) == (28, 8, 128)
    assert cell.config["cache_len"] == 4096 and cell.traffic["sessions"] == [
        2048, 3072, 3584, 4096]
    # One session's bytes: K and V of 28 x 4096 x 8 x 128 bfloat16, the
    # layers' int32 positions and the int32 step.
    assert 2 * 28 * 4096 * 8 * 128 * 2 + 28 * 4096 * 4 + 4 == 470_220_804


def test_frames_hold_raw_and_coded_blocks(driver):
    kinds = []
    for n, (_, blobs) in zip(SESSIONS, driver.blobs):
        for b in blobs:
            raw = lz4_paper.read_frame(b["frame"])["raw"]
            kinds.append((n, b["dtype"], int(raw.sum()), int(raw.size)))
    kv = [k for k in kinds if k[1] == "bfloat16"]
    assert len(kv) == 2 * len(SESSIONS)
    assert any(0 < r < size for _, _, r, size in kv)            # mixed frames
    assert all(r == size == 2 for n, _, r, size in kv if n == CACHE_LEN)
    assert all(r == 1 for n, _, r, _ in kv if n == CACHE_LEN // 2)


def test_program_restore_equals_reference_resume_and_originals(driver):
    from repro_torch import LZ4DecodeEngine
    from repro_torch.serving import engine as serving

    eng = LZ4DecodeEngine(device="cpu", plan_on_device=True, micro_batch=8)
    for blob, cache in zip(driver.blobs, driver.caches):
        got = serving.restore_cache(blob, eng, to_device=True)
        assert_same(got, cache)
        assert all(x._is_view() for x in ref.flatten(got))
        assert_same(ref.resume(blob), cache)
    assert eng.totals.host_bytes == 0


def test_reference_park_is_restored_by_the_program(driver):
    from repro_torch import LZ4DecodeEngine
    from repro_torch.serving import engine as serving

    eng = LZ4DecodeEngine(device="cpu", plan_on_device=True, micro_batch=8)
    for blob, cache in zip(driver.blobs, driver.caches):
        parked = ref.park(plain(cache))
        # The reference writes the program's frames byte for byte.
        assert [b["frame"] for b in parked[1]] == [b["frame"] for b in blob[1]]
        assert_same(serving.restore_cache(parked, eng, to_device=True), cache)


def test_reference_refuses_a_damaged_frame(driver):
    blob = driver.blobs[0]
    frame = bytearray(blob[1][0]["frame"])
    frame[-1] ^= 1
    with pytest.raises(ValueError):
        ref.resume([blob[0], [dict(blob[1][0], frame=bytes(frame)), *blob[1][1:]]])


@pytest.mark.parametrize("case", ["sound", "control", "fault"])
def test_kv_resume_is_correct_only_when_sound(small, case):
    bench, root = small
    cell = harness.resolve(bench, SMALL, root)
    planted = cell.driver.plant_fault() if case == "fault" else contextlib.nullcontext()
    with planted:
        r = harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                             control=case == "control")
    c = {k: v["value"] for k, v in r["compared"].items()}
    assert set(c) == {"bytes_wrong", "leaves_wrong", "host_bytes"}
    if case == "sound":
        assert r["correct"] and c == dict.fromkeys(c, 0)
        assert set(r["metrics"]) == {"decode_GBps", "setup_s"}
    else:
        assert not r["correct"] and c["bytes_wrong"] > 0
        assert c["leaves_wrong"] == c["host_bytes"] == 0


def test_the_cell_passes_the_three_checks(small):
    bench, root = small
    checks.check_cell_files(bench, SMALL, root)
    checks.check_fixtures(bench, root, EXPECTED)
    r = checks.check_traced_run(bench, SMALL, root)
    for name in ("raw_ms_per_MiB.decode", "restore_loop_ms_per_MiB.decode"):
        assert r["metrics"][name]["value"] > 0
