"""What the program needs from its installation, and how it starts.

The main path runs on JAX, numpy and optax alone (flax, PyYAML, Orbax
and msgpack are replaced in-repo), keeps its compile cache where the
rule in ``runtime_setup`` says, and ``chip_smoke.py`` refuses to report
success anywhere but on a GPU.
"""

import os
import shutil
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_mpc_tpu import runtime_setup
from gan_mpc_tpu.utils import struct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, timeout=600):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


def test_main_path_without_flax_yaml_orbax_msgpack(tmp_path):
    """Import every entry point and run config -> policy -> plan -> params
    file -> checkpoint with the replaced packages unimportable."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("flax", "yaml", "orbax", "msgpack"):
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import jax, jax.numpy as jnp, numpy as np
        import bench, chip_smoke, __graft_entry__
        import gan_mpc_tpu.runners.gan, gan_mpc_tpu.runners.l2
        from gan_mpc_tpu.config import Config
        from gan_mpc_tpu.runners import common
        from gan_mpc_tpu.utils import io
        from gan_mpc_tpu.utils.checkpoint import TrainCheckpointer
        for name in ("flax", "yaml", "orbax", "msgpack"):
            try:
                __import__(name)
            except ImportError:
                pass
            else:
                raise SystemExit(name + " was importable")
        cfg = Config.from_yaml({ROOT!r} + "/configs/gan_pendulum_quality.yaml")
        cfg = cfg.replace(mpc__horizon=3, mpc__solver__max_iterations=2)
        assert Config.from_yaml_str(cfg.to_yaml()) == cfg
        policy, params = common.build_policy(cfg, 3, 1, with_critic=True)
        hX = 0.1 * jnp.ones((2, 2, 3))
        sol = jax.jit(policy.plan_batch)(params, hX, jnp.zeros((2, 1, 1)))
        assert np.all(np.isfinite(np.asarray(sol.obj)))
        io.save_params(params, {str(tmp_path)!r} + "/p.msgpack")
        back = io.load_params(params, {str(tmp_path)!r} + "/p.msgpack")
        ck = TrainCheckpointer({str(tmp_path)!r} + "/ck")
        ck.maybe_save(1, {{"params": back}})
        got = ck.restore({{"params": params}})
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(params)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        print("standalone ok")
    """)
    out = _run(["-c", script])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "standalone ok" in out.stdout


@pytest.mark.parametrize(
    "backend,environ,expected",
    [
        ("gpu", {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
        ("cpu", {"JAX_COMPILATION_CACHE_DIR": "/elsewhere",
                 "GAN_MPC_TPU_FORCE_COMPILE_CACHE": "1"}, None),
        ("gpu", {}, "checkout"),
        ("cpu", {}, None),
        ("cpu", {"GAN_MPC_TPU_FORCE_COMPILE_CACHE": "1"}, "checkout"),
    ],
    ids=["env-set", "env-set-cpu-forced", "unset", "cpu", "cpu-forced"],
)
def test_compile_cache_rule(backend, environ, expected):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code;
    otherwise one fixed directory inside the checkout."""
    got = runtime_setup.cache_dir_for(backend, environ)
    if expected is None:
        assert got is None
    else:
        assert got == os.path.join(ROOT, ".jax_cache")
        assert got == runtime_setup.cache_dir_for(backend, dict(environ))


def test_chip_smoke_refuses_the_cpu():
    out = _run(["chip_smoke.py"], timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not a GPU" in out.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py", "--cpu-rehearsal"], cwd=tmp_path, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


class _Node(struct.PyTreeNode):
    a: jax.Array
    b: jax.Array = struct.field(default_factory=lambda: jnp.zeros(2))
    tag: str = struct.field(pytree_node=False, default="x")


def test_pytree_node_under_jit_vmap_replace():
    node = _Node(a=jnp.arange(3.0))
    assert [np.asarray(l).shape for l in jax.tree_util.tree_leaves(node)] == [
        (3,), (2,)
    ]
    doubled = jax.jit(lambda n: n.replace(a=2 * n.a))(node)
    np.testing.assert_array_equal(np.asarray(doubled.a), [0.0, 2.0, 4.0])
    assert doubled.tag == "x" and isinstance(doubled, _Node)
    batch = _Node(a=jnp.ones((4, 3)), b=jnp.ones((4, 2)), tag="y")
    sums = jax.vmap(lambda n: jnp.sum(n.a) + jnp.sum(n.b))(batch)
    np.testing.assert_array_equal(np.asarray(sums), [5.0] * 4)
    # static fields are part of the treedef: a new value retraces
    assert jax.tree_util.tree_structure(batch) != jax.tree_util.tree_structure(
        batch.replace(tag="z")
    )
    with pytest.raises(Exception):
        node.a = jnp.zeros(3)  # frozen
