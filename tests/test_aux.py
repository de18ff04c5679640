"""Auxiliary subsystem tests: checkpoint/resume, metrics, video."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from gan_mpc_tpu.utils.checkpoint import TrainCheckpointer
from gan_mpc_tpu.utils.metrics import MetricsRecorder, solver_stats
from gan_mpc_tpu.utils.video import render_episode, save_video


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "params": {"w": jnp.arange(6.0).reshape(2, 3)},
        "step_key": jax.random.PRNGKey(3),
        "epoch": jnp.int32(4),
    }
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), every=2)
    assert not ckpt.maybe_save(1, state)  # off-cadence
    assert ckpt.maybe_save(2, state)
    assert ckpt.latest_step() == 2
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    restored = ckpt.restore(template)
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["w"]), np.asarray(state["params"]["w"])
    )
    np.testing.assert_array_equal(
        np.asarray(restored["step_key"]), np.asarray(state["step_key"])
    )
    ckpt.close()


def test_checkpoint_keeps_latest(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), keep=2, every=1)
    s = {"x": jnp.zeros(1)}
    for i in range(1, 5):
        ckpt.maybe_save(i, {"x": jnp.full((1,), float(i))})
    assert ckpt.latest_step() == 4
    restored = ckpt.restore(s)
    assert float(restored["x"][0]) == 4.0
    ckpt.close()


def test_checkpoint_is_atomic_and_checks_the_tree(tmp_path):
    """A torn write (leftover temp file) is never a checkpoint, and a
    restore into another tree or shape fails loudly."""
    import pytest

    ckpt = TrainCheckpointer(str(tmp_path / "ck"), keep=3, every=1)
    ckpt.maybe_save(1, {"x": jnp.ones(2), "n": jnp.int32(1)})
    (tmp_path / "ck" / "2.npz.tmp").write_bytes(b"partial")
    assert ckpt.all_steps() == [1]
    assert ckpt.latest_step() == 1
    with pytest.raises(ValueError, match="another state tree"):
        ckpt.restore({"y": jnp.ones(2), "n": jnp.int32(0)})
    with pytest.raises(ValueError, match="expected"):
        ckpt.restore({"x": jnp.ones(3), "n": jnp.int32(0)})
    ckpt.clear()
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"x": jnp.ones(2), "n": jnp.int32(0)})


def test_metrics_recorder(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = MetricsRecorder(path)
    m.record(1, loss=0.5, reward=10)
    with m.timed("phase", step=1):
        pass
    m.record(2, loss=0.25)
    m.close()
    rows = [json.loads(l) for l in open(path)]
    assert rows[0]["loss"] == 0.5
    assert any("phase_seconds" in r for r in rows)
    assert m.latest("loss") == 0.25
    assert m.history["loss"] == [(1, 0.5), (2, 0.25)]


def test_solver_stats():
    from gan_mpc_tpu.planner.ilqr import ILQRSolution

    sol = ILQRSolution(
        X=jnp.zeros((2, 3, 2)),
        U=jnp.zeros((2, 2, 1)),
        obj=jnp.array([1.0, 3.0]),
        grad=jnp.zeros((2, 2, 1)),
        adjoints=jnp.zeros((2, 3, 2)),
        iterations=jnp.array([4, 8]),
        converged=jnp.array([True, False]),
    )
    stats = solver_stats(sol)
    assert stats["ilqr_iterations_mean"] == 6.0
    assert stats["ilqr_converged_frac"] == 0.5


def test_render_and_save_video(tmp_path):
    qpos = np.stack([np.linspace(0, np.pi, 12)]).T  # (12, 1)
    frames = render_episode("pendulum_swingup", qpos)
    assert frames.shape == (12, 240, 320, 3)
    assert frames.dtype == np.uint8
    # frames change over time (the pole moves)
    assert np.abs(frames[0].astype(int) - frames[-1].astype(int)).max() > 0

    cart = np.stack([np.linspace(-1, 1, 5), np.linspace(0, 0.5, 5)], axis=1)
    frames_c = render_episode("cartpole_balance", cart)
    assert frames_c.shape[0] == 5

    qpos9 = np.zeros((4, 9), np.float32)
    qpos9[:, 1] = 0.64
    frames_ch = render_episode("cheetah_run", qpos9)
    assert frames_ch.shape[0] == 4

    out = save_video(frames, str(tmp_path / "v.mp4"))
    assert os.path.exists(out)
    assert os.path.getsize(out) > 0


def test_debug_checks_and_interfaces():
    from gan_mpc_tpu.interfaces import CostModel, CriticModel, DynamicsModel
    from gan_mpc_tpu.models import (
        CostFeatureNet,
        LearnedDynamics,
        MPCCost,
        ResidualMLPDynamicsNet,
        SequenceCritic,
    )
    from gan_mpc_tpu.utils.debug import assert_finite, debug_checks

    assert isinstance(MPCCost(CostFeatureNet(), 5), CostModel)
    assert isinstance(
        LearnedDynamics(ResidualMLPDynamicsNet(x_size=3)), DynamicsModel
    )
    assert isinstance(SequenceCritic(), CriticModel)

    assert_finite({"a": jnp.ones(3)}, "ok")
    import pytest as _pytest

    with _pytest.raises(FloatingPointError):
        assert_finite({"a": jnp.array([1.0, jnp.nan])})
    with debug_checks():
        assert jax.config.jax_debug_nans
    assert not jax.config.jax_debug_nans


def test_candidate_pool_and_honest_selection(monkeypatch):
    """note_candidate keeps the top-k noisy-scored checkpoints;
    select_best_params re-ranks them (plus the final params) with the
    full evaluation budget and keeps the honest winner — guarding
    against lucky midrun evals (measured: 781 midrun -> 518 honest)."""
    from gan_mpc_tpu.config import Config
    from gan_mpc_tpu.runners import l2 as l2_runner

    ctx = {}
    # Noisy midrun scores; params are just labels here.
    for score, tag in [(100.0, "a"), (781.0, "lucky"), (300.0, "b"),
                       (250.0, "c"), (400.0, "d")]:
        l2_runner.note_candidate(ctx, score, {"tag": tag}, k=3)
    pool = ctx["candidates"]
    assert [p["tag"] for _, p in pool] == ["lucky", "d", "b"]

    # Honest full-budget evals disagree with the noisy ranking.
    honest = {"lucky": 518.0, "d": 610.0, "b": 420.0, "final": 95.0}

    def fake_evaluate(config, c, key, num_runs=None):
        return honest[c["params"]["tag"]]

    monkeypatch.setattr(l2_runner, "evaluate", fake_evaluate)
    cfg = Config.from_dict({"mpc": {"evaluate": {"keep_best": True}}})
    import jax

    out = l2_runner.select_best_params(
        cfg, ctx, {"tag": "final"}, jax.random.PRNGKey(0)
    )
    assert out["tag"] == "d"

    # keep_best=False returns the final params untouched.
    cfg_off = Config.from_dict({"mpc": {"evaluate": {"keep_best": False}}})
    out2 = l2_runner.select_best_params(
        cfg_off, ctx, {"tag": "final"}, jax.random.PRNGKey(0)
    )
    assert out2["tag"] == "final"
