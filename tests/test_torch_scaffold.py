"""Scaffold of the PyTorch port: it imports without the reference, probes
its environment, and refuses to run silently on the wrong device.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import test_torch_util  # noqa: F401  (one torch thread per test worker)

ROOT = Path(__file__).resolve().parent.parent

_IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"imported": names, "bad": bad,
                  "probe": repro_torch.probe()}))
"""


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_imports_without_jax_or_the_reference():
    res = _run(_IMPORT_ALL)
    assert res["bad"] == []
    for mod in ("repro_torch.core.engine", "repro_torch.core.compressor",
                "repro_torch.core.frame", "repro_torch.core.decoder",
                "repro_torch.core.emitter", "repro_torch.core.corpus",
                "repro_torch.core.lz4_types", "repro_torch.kernels.ops",
                "repro_torch.kernels.ref", "repro_torch.kernels._build",
                "repro_torch.kernels.fused_compress",
                "repro_torch.kernels.emit_scatter",
                "repro_torch.kernels.window_select",
                "repro_torch.kernels.decode_wave",
                "repro_torch.kernels.plan_speculative",
                "repro_torch.kernels.crc32", "repro_torch.kernels.fibhash",
                "repro_torch.kernels.match_extend",
                "repro_torch.core.reference", "repro_torch.core.schemes",
                "repro_torch.core.encoder", "repro_torch.core.cycle_model",
                "repro_torch.core.decode_plan",
                "repro_torch.core.decode_engine", "repro_torch.compat",
                "repro_torch.obs.trace", "repro_torch.obs.metrics",
                "repro_torch.resilience.errors"):
        assert mod in res["imported"], mod
    probe = res["probe"]
    assert probe["torch"] == torch.__version__
    assert probe["cuda_available"] == torch.cuda.is_available()


def test_probe_reports_and_never_raises():
    import repro_torch

    p = repro_torch.probe()
    assert set(p) >= {"torch", "torch_cuda", "cuda_available", "device_count",
                      "device_name", "compute_capability", "nvcc_on_path",
                      "nvcc"}
    if not p["cuda_available"]:
        assert p["device_name"] is None and p["device_count"] == 0


def test_engine_defaults_to_the_card_and_says_so(monkeypatch):
    from repro_torch import LZ4Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LZ4Engine()
    with pytest.raises(RuntimeError, match="is_available"):
        LZ4Engine(device="cuda")
    with pytest.raises(ValueError):
        LZ4Engine(device="meta")
    eng = LZ4Engine(device="cpu")
    assert eng.device == torch.device("cpu")
    data = b"scaffold " * 300
    assert eng.decompress(eng.compress(data)) == data
    assert eng.stats.candidate_impl == "fused"


def test_decode_engine_defaults_to_the_card_and_says_so(monkeypatch):
    from repro_torch import LZ4DecodeEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LZ4DecodeEngine()
    with pytest.raises(RuntimeError, match="is_available"):
        LZ4DecodeEngine(device="cuda")
    with pytest.raises(ValueError):
        LZ4DecodeEngine(device="meta")
    eng = LZ4DecodeEngine(device="cpu")
    assert eng.executor == "device" and eng.device == torch.device("cpu")


def test_kernel_sources_and_build_plan():
    from repro_torch.kernels import _build

    assert _build.KERNEL_SOURCES == (
        "fused_compress", "emit_scatter", "window_select", "decode_wave",
        "plan_speculative", "crc32", "fibhash", "match_extend")
    for name in _build.KERNEL_SOURCES:
        src = _build.CSRC / f"{name}.cu"
        assert src.is_file(), src
        text = src.read_text()
        assert f'extern "C" int {name}_launch' in text
        assert "cudaGetLastError" in text
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.build_dir() == ROOT / "build"
    # Library names follow the source's content hash.
    a = _build._lib_path("emit_scatter")
    assert a.parent == ROOT / "build" and a.name.startswith("libemit_scatter-")


def test_build_without_compiler_raises_clearly(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="error code 7"):
        _build.check_launch(7, "some_kernel")
    _build.check_launch(0, "some_kernel")


def test_nvtx_bridge_is_optional():
    from repro_torch import obs

    obs.configure(nvtx=True)
    try:
        with obs.live_span("bridge.check"):
            pass
        # Without a CUDA device the bridge switches itself off silently.
        if not torch.cuda.is_available():
            assert obs.tracer()._nvtx_module() is None
    finally:
        obs.configure(nvtx=False)
        obs.reset()
