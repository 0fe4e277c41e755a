"""The port's training loop (`repro_torch.launch.train.train`) on the CPU:
the five tests of `tests/test_system.py` run on the port (loss decreases,
failure recovery finishes, recovery equals the uninterrupted run within
rtol 1e-4, int8 + error-feedback training converges, minicpm takes the WSD
schedule), and a resume across packages in both directions: one package
trains 10 steps with a checkpoint every 5, the other resumes from its
``ckpt_5`` (same steps, same data directory) and its losses for steps 6-10
equal the first package's within rtol 1e-4.
"""
import shutil

import numpy as np
import pytest

from repro.launch import train as jax_train
from repro_torch.launch import train as train_mod

import test_torch_util  # noqa: F401  (one torch thread per worker)


def _args(tmp_path, **kw):
    defaults = dict(
        arch="internlm2-1.8b", scale="tiny", steps=30, batch=4, seq=64,
        lr=1e-3, ckpt_dir=str(tmp_path), ckpt_every=10, log_every=100,
        resume=True, async_ckpt=False, grad_compress=False,
        simulate_failure=None, seed=0, device="cpu",
    )
    defaults.update(kw)
    return type("Args", (), defaults)()


def test_training_loss_decreases(tmp_path):
    out = train_mod.train(_args(tmp_path))
    losses = out["losses"]
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert np.isfinite(last)
    assert last < first * 0.98, (first, last)


def test_failure_recovery_resumes_and_finishes(tmp_path):
    out = train_mod.train(_args(tmp_path, steps=24, simulate_failure=15, ckpt_every=6))
    assert len(out["losses"]) >= 24
    assert np.isfinite(out["final_loss"])


def test_recovery_matches_uninterrupted_run(tmp_path):
    """A crash+restore run ends at the same loss as an uninterrupted run (the
    checkpoint captures the full state; batches are a pure function of
    step)."""
    a = train_mod.train(_args(tmp_path / "a", steps=20, ckpt_every=5))
    b = train_mod.train(
        _args(tmp_path / "b", steps=20, ckpt_every=5, simulate_failure=10)
    )
    np.testing.assert_allclose(a["final_loss"], b["final_loss"], rtol=1e-4)


def test_grad_compressed_training_converges(tmp_path):
    base = train_mod.train(_args(tmp_path / "fp", steps=25, lr=1e-3))
    comp = train_mod.train(_args(tmp_path / "q8", steps=25, lr=1e-3, grad_compress=True))
    # int8+EF tracks fp32 closely on this scale
    assert abs(comp["final_loss"] - base["final_loss"]) < 0.15 * base["final_loss"]


def test_wsd_schedule_selected_for_minicpm(tmp_path):
    args = _args(tmp_path, arch="minicpm-2b", steps=8, batch=2, seq=32)
    assert train_mod.opt_config(args).schedule == "wsd"
    assert train_mod.opt_config(_args(tmp_path)).schedule == "cosine"
    out = train_mod.train(args)
    assert np.isfinite(out["final_loss"])


@pytest.mark.parametrize("first,then", [("jax", "torch"), ("torch", "jax")])
def test_resume_across_packages(tmp_path, first, then):
    """Each package resumes the other's training run from its checkpoint."""
    trainers = {"jax": jax_train.train, "torch": train_mod.train}
    run = tmp_path / "run"
    whole = trainers[first](_args(run, steps=10, ckpt_every=5))
    assert len(whole["losses"]) == 10
    # the resuming package finds the first one's ckpt_5 as its latest step,
    # beside the first one's token shards
    resumed_dir = tmp_path / "resumed"
    shutil.copytree(run, resumed_dir)
    shutil.rmtree(resumed_dir / "ckpt_10")
    out = trainers[then](_args(resumed_dir, steps=10, ckpt_every=5))
    assert len(out["losses"]) == 5
    np.testing.assert_allclose(out["losses"], whole["losses"][5:], rtol=1e-4)
