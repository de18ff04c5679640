"""The plain-JAX models, params codec and YAML reader against the flax,
msgpack and PyYAML originals they replace.

The originals are optional here: each test skips when its package is
missing. The committed params files were written by the flax models, so
identical trees and outputs on the same params mean every saved run still
loads and plans as it did.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_mpc_tpu.models import (
    CostFeatureNet,
    ExpertPredictor,
    LSTMDynamicsNet,
    ResidualMLPDynamicsNet,
    SequenceCritic,
)
from gan_mpc_tpu.utils import serialization

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS_FILES = sorted(
    glob.glob(os.path.join(ROOT, "runs", "**", "params.msgpack"), recursive=True)
)
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _flax_models():
    """The flax.linen definitions the plain-JAX models replaced."""
    nn = pytest.importorskip("flax.linen")

    class ResidualMLP(nn.Module):
        x_size: int
        hidden: tuple

        @nn.compact
        def __call__(self, xc, u):
            x = xc[: self.x_size]
            h = jnp.concatenate([x, u], axis=-1)
            for width in self.hidden:
                h = nn.relu(nn.Dense(width)(h))
            dx = nn.Dense(self.x_size)(h)
            return jnp.concatenate([x + dx, xc[self.x_size :]], axis=-1)

    class LSTMDyn(nn.Module):
        x_size: int
        features: int
        hidden: tuple

        @nn.compact
        def __call__(self, xc, u):
            x = xc[: self.x_size]
            h_state = xc[self.x_size : self.x_size + self.features]
            c_state = xc[self.x_size + self.features :]
            q = jnp.concatenate([x, u], axis=-1)
            (c_new, h_new), q = nn.OptimizedLSTMCell(self.features)(
                (c_state, h_state), q
            )
            for width in self.hidden:
                q = nn.relu(nn.Dense(width)(q))
            dx = nn.Dense(self.x_size)(q)
            return jnp.concatenate([x + dx, h_new, c_new], axis=-1)

    class Cost(nn.Module):
        hidden: tuple
        features_out: int

        @nn.compact
        def __call__(self, xc):
            h = xc
            for width in self.hidden:
                h = nn.relu(nn.Dense(width)(h))
            f = nn.Dense(self.features_out)(h)
            return jnp.vdot(f, f)

    class Critic(nn.Module):
        features: int
        hidden: tuple

        @nn.compact
        def __call__(self, xseq):
            cell = nn.scan(
                nn.OptimizedLSTMCell,
                variable_broadcast="params",
                split_rngs={"params": False},
                in_axes=0,
                out_axes=0,
            )(features=self.features)
            zeros = jnp.zeros((self.features,), dtype=xseq.dtype)
            _, outs = cell((zeros, zeros), xseq)
            h = outs[-1]
            for width in self.hidden:
                h = nn.relu(nn.Dense(width)(h))
            return nn.Dense(1)(h)[0]

    class _PredictionHeads(nn.Module):
        x_size: int
        u_size: int
        hidden: tuple

        @nn.compact
        def __call__(self, y, x):
            hx = y
            for width in self.hidden:
                hx = nn.relu(nn.Dense(width)(hx))
            next_x = nn.Dense(self.x_size)(hx) + x
            hu = y
            for width in self.hidden:
                hu = nn.relu(nn.Dense(width)(hu))
            return next_x, nn.tanh(nn.Dense(self.u_size)(hu))

    class _MLPCell(nn.Module):
        x_size: int
        u_size: int
        hidden: tuple

        @nn.compact
        def __call__(self, carry, x_t, tf):
            (x_prev,) = carry
            x = jnp.where(tf, x_t, x_prev)
            y = nn.relu(nn.Dense(self.hidden[0])(x))
            next_x, u = _PredictionHeads(self.x_size, self.u_size, self.hidden)(
                y, x
            )
            return (next_x,), (next_x, u)

    class _LSTMCell(nn.Module):
        x_size: int
        u_size: int
        features: int
        hidden: tuple

        @nn.compact
        def __call__(self, carry, x_t, tf):
            lstm_state, x_prev = carry
            x = jnp.where(tf, x_t, x_prev)
            lstm_state, y = nn.OptimizedLSTMCell(self.features)(lstm_state, x)
            next_x, u = _PredictionHeads(self.x_size, self.u_size, self.hidden)(
                y, x
            )
            return (lstm_state, next_x), (next_x, u)

    class Expert(nn.Module):
        x_size: int
        u_size: int
        arch: str
        features: int
        hidden: tuple

        @nn.compact
        def __call__(self, carry, xseq, tf):
            cell = (
                _LSTMCell(self.x_size, self.u_size, self.features, self.hidden)
                if self.arch == "lstm"
                else _MLPCell(self.x_size, self.u_size, self.hidden)
            )
            scan = nn.scan(
                lambda c, carry, x: c(carry, x, tf),
                variable_broadcast="params",
                split_rngs={"params": False},
                in_axes=0,
                out_axes=0,
            )
            return scan(cell, carry, xseq)

    return ResidualMLP, LSTMDyn, Cost, Critic, Expert


def _shapes(tree):
    return jax.tree_util.tree_map(lambda a: a.shape, tree)


def _assert_close(a, b, atol=1e-5):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol)


def _model_cases():
    ResidualMLP, LSTMDyn, Cost, Critic, Expert = _flax_models()
    x_size, u_size = 5, 2
    xc = jnp.linspace(-1.0, 1.0, x_size)
    u = jnp.array([0.3, -0.7])
    xseq = jnp.sin(jnp.arange(4 * x_size, dtype=jnp.float32)).reshape(4, x_size)
    lstm_xc = jnp.concatenate([xc, 0.1 * jnp.ones(2 * 6)])
    cases = {
        "residual_mlp": (
            ResidualMLPDynamicsNet(x_size=x_size, hidden=(16, 8)),
            ResidualMLP(x_size, (16, 8)),
            (xc, u),
        ),
        "lstm_dynamics": (
            LSTMDynamicsNet(x_size=x_size, features=6, hidden=(8,)),
            LSTMDyn(x_size, 6, (8,)),
            (lstm_xc, u),
        ),
        "cost": (
            CostFeatureNet(hidden=(16, 16), features_out=4),
            Cost((16, 16), 4),
            (xc,),
        ),
        "critic": (
            SequenceCritic(features=6, hidden=(8,)),
            Critic(6, (8,)),
            (xseq,),
        ),
    }
    for arch in ("lstm", "mlp"):
        ours = ExpertPredictor(
            x_size=x_size, u_size=u_size, arch=arch, features=6, hidden=(8, 7)
        )
        carry = ours.init_carry(xc)
        for tf in (True, False):
            cases[f"expert_{arch}_tf{int(tf)}"] = (
                ours,
                Expert(x_size, u_size, arch, 6, (8, 7)),
                (carry, xseq, jnp.asarray(tf)),
            )
    return cases


CASE_NAMES = [
    "residual_mlp", "lstm_dynamics", "cost", "critic",
    "expert_lstm_tf1", "expert_lstm_tf0", "expert_mlp_tf1", "expert_mlp_tf0",
]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_model_matches_flax(name):
    """Same parameter tree key for key, same outputs on flax's params,
    and an init whose leaves have flax's shapes and scale."""
    ours, theirs, args = _model_cases()[name]
    flax_params = theirs.init(jax.random.PRNGKey(0), *args)
    our_params = ours.init(jax.random.PRNGKey(1), *args)
    assert _shapes(our_params) == _shapes(jax.tree_util.tree_map(
        jnp.asarray, flax_params
    ))
    _assert_close(ours.apply(flax_params, *args), theirs.apply(flax_params, *args))
    for a, b in zip(
        jax.tree_util.tree_leaves(our_params),
        jax.tree_util.tree_leaves(flax_params),
    ):
        if a.ndim == 2 and a.size >= 32:  # lecun-normal / orthogonal: same scale
            assert 0.5 < float(jnp.std(a)) / float(jnp.std(b)) < 2.0
        elif a.ndim == 1:
            assert float(jnp.max(jnp.abs(a))) == 0.0  # zero biases


@pytest.mark.parametrize(
    "path", PARAMS_FILES, ids=lambda p: os.path.relpath(p, ROOT)
)
def test_committed_params_read_like_flax(path):
    """Every committed params file decodes to flax's tree, and writing
    that tree back gives the file's exact bytes."""
    fs = pytest.importorskip("flax.serialization")
    with open(path, "rb") as fp:
        raw = fp.read()
    ours = serialization.msgpack_restore(raw)
    _assert_close(ours, fs.msgpack_restore(raw), atol=0)
    assert serialization.to_bytes(ours) == raw


def test_params_codec_round_trip_and_flax_bytes(tmp_path):
    """A tree of every leaf kind survives write -> read, with the bytes
    flax writes for it."""
    from gan_mpc_tpu.utils import io

    tree = {
        "w": jnp.arange(6.0).reshape(2, 3),
        "key": jax.random.PRNGKey(7),
        "t": (np.float32(2.5), jnp.zeros((0, 4)), jnp.ones(40, jnp.bfloat16)),
        "meta": [1, -3, 300, -70000, 1 << 40, 2.5, "name", None, True],
    }
    path = str(tmp_path / "p.msgpack")
    io.save_params(tree, path)
    back = io.load_params(tree, path)
    assert back["meta"] == tree["meta"]
    _assert_close(
        {k: v for k, v in back.items() if k != "meta"},
        {k: v for k, v in tree.items() if k != "meta"},
        atol=0,
    )
    assert back["t"][2].dtype == jnp.bfloat16
    fs = pytest.importorskip("flax.serialization")
    with open(path, "rb") as fp:
        assert fp.read() == fs.to_bytes(tree)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_pyyaml(path):
    """Each committed config reads as PyYAML reads it, and the writer's
    output reads back (by both readers) to the same tree."""
    from gan_mpc_tpu.utils import yaml_lite

    yaml = pytest.importorskip("yaml")
    with open(path) as fp:
        text = fp.read()
    expected = yaml.safe_load(text)
    assert yaml_lite.load(text) == expected
    dumped = yaml_lite.dump(expected)
    assert yaml_lite.load(dumped) == expected
    assert yaml.safe_load(dumped) == expected
