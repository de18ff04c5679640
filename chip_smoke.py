"""Smoke test of the system's main path on one NVIDIA GPU.

    python chip_smoke.py                                # needs a GPU
    JAX_PLATFORMS=cpu python chip_smoke.py --cpu-rehearsal   # tiny, on CPU

Phases, each of which stops the script with a nonzero exit on failure:

0. device: JAX's default device must be a GPU (the script never goes on
   on the CPU unless ``--cpu-rehearsal`` is given); prints the card's
   name and power limit from ``nvidia-smi``;
1. planner: the flagship ``bench.py`` row (cheetah_run, 512 envs, H=5,
   iLQR <= 5, random weights at the flagship widths) for 20 control
   steps; rewards must be finite;
2. references on the card at real widths: (i) ``mlp_value_and_jac`` at
   8192 rows through the 23->200->200->200->17 dynamics stack against
   numpy float64, at default matmul precision (TF32 allowed) and at
   "highest"; (ii) ``plan_batch`` on 16 lanes against the vmapped
   single-instance ``planner/ilqr.py`` plan run at "highest";
3. trained checkpoint: the ``bench.py`` row of the committed
   cheetah_run gan/4 run, loaded through the in-repo params reader;
4. trainer: ``runners.gan.run`` on ``configs/gan_pendulum_quality.yaml``
   at its own widths in a scratch workdir, with the epoch count cut to 2
   and the DAgger block to one round without continuation epochs (see
   ``TRAINER_CUTS``); losses must be finite, and the trained params must
   save and restore through the training checkpointer and the params
   file.

The last line of stdout is ``{"ok": true, "device": {...}}``; no such
line is printed when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Full sizes (GPU) and the CPU rehearsal's tiny ones.
SIZES = {
    False: dict(envs=512, steps=20, mlp_rows=8192, lanes=16),
    True: dict(envs=4, steps=2, mlp_rows=256, lanes=2),
}
# The trainer's cuts of configs/gan_pendulum_quality.yaml. Its DAgger
# block (3 rounds x 15 continuation epochs, each with corrective
# collection and midrun evals) took ~300 s per round on an H100, which
# alone would overrun the smoke's time budget; one round with no
# continuation epochs still runs every DAgger step once.
TRAINER_CUTS = {
    "mpc__train__num_epochs": 2,
    "expert_prediction__dagger__rounds": 1,
    "expert_prediction__dagger__extra_epochs": 0,
}
# Normalized max error limits of phase 2 (i), by matmul precision.
MLP_LIMITS = {"default": 1e-2, "highest": 1e-5}


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def phase(name: str):
    """Prints the phase's wall time when it ends."""

    class _Phase:
        def __enter__(self):
            self.t0 = time.perf_counter()
            log(f"== phase {name}")

        def __exit__(self, exc_type, *_):
            if exc_type is None:
                log(f"== phase {name} done in "
                    f"{time.perf_counter() - self.t0:.1f} s")

    return _Phase()


def device_check(rehearsal: bool):
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not rehearsal:
        sys.exit(f"chip_smoke: JAX's default device is {dev.platform!r}, "
                 "not a GPU; refusing to run on it")
    if rehearsal:
        card = "no GPU (CPU rehearsal)"
    else:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    log(f"nvidia-smi: {card}")
    log(f"jax: {jax.__version__} devices: {jax.devices()}")
    return dev, card


def planner_row(bench, sizes, card):
    row = bench.bench_row(
        bench._flagship_setup("cheetah_run", 5, 5), sizes["envs"],
        sizes["steps"],
    )
    log(f"[{card}] {json.dumps(row)}")
    return row


def _np_value_and_jac(x, params):
    """float64 numpy forward + input Jacobian of a relu MLP, and every
    hidden layer's pre-activation."""
    h = x
    pre, masks = [], []
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            pre.append(h)
            masks.append((h > 0).astype(np.float64))
            h = h * masks[-1]
    n, fin = x.shape
    Jt = np.broadcast_to(params[0][0][None], (n,) + params[0][0].shape)
    if masks:
        Jt = Jt * masks[0][:, None, :]
    for i in range(1, len(params)):  # Jt: (n, fin, width) = J transposed
        Jt = (Jt.reshape(n * fin, -1) @ params[i][0]).reshape(n, fin, -1)
        if i < len(params) - 1:
            Jt = Jt * masks[i][:, None, :]
    return h, np.swapaxes(Jt, 1, 2), pre


def _device_preacts(x, params):
    """Hidden pre-activations computed on the device the way
    ``mlp_value_and_jac``'s forward computes them."""
    from gan_mpc_tpu.ops.fused_mlp import _mm

    h, out = x, []
    for w, b in params[:-1]:
        h = _mm(h, w, None) + b
        out.append(h)
        h = h * (h > 0.0).astype(h.dtype)
    return out


def mlp_reference(sizes):
    """Phase 2 (i): the planner's linearization op against float64.

    The relu Jacobian jumps where a pre-activation crosses zero, and a
    pre-activation within rounding distance of zero may land on either
    side of it. So values are compared on every row, and the Jacobian on
    the rows where every hidden pre-activation computed on the device has
    float64's sign with a margin of 4x its own error; the number of such
    rows is printed."""
    import jax

    from gan_mpc_tpu.ops.fused_mlp import mlp_params, mlp_value_and_jac

    layer_sizes = [23, 200, 200, 200, 17]
    params = mlp_params(jax.random.PRNGKey(11), layer_sizes)
    x = jax.random.normal(jax.random.PRNGKey(12), (sizes["mlp_rows"], 23))
    p64 = [(np.asarray(w, np.float64), np.asarray(b, np.float64))
           for w, b in params]
    y_ref, J_ref, pre_ref = _np_value_and_jac(np.asarray(x, np.float64), p64)
    value_and_jac = jax.jit(mlp_value_and_jac)
    preacts = jax.jit(_device_preacts)
    results = {}
    for name in ("default", "highest"):
        with jax.default_matmul_precision(
            None if name == "default" else "highest"
        ):
            y, J = jax.block_until_ready(value_and_jac(x, params))
            pre_dev = [np.asarray(z, np.float64) for z in preacts(x, params)]
        clean = np.all(
            [np.all((np.abs(r) > 4 * np.abs(d - r)) & ((d > 0) == (r > 0)),
                    axis=1)
             for d, r in zip(pre_dev, pre_ref)],
            axis=0,
        )
        err_y = np.max(np.abs(np.asarray(y) - y_ref)) / np.max(np.abs(y_ref))
        err_J = (np.max(np.abs(np.asarray(J)[clean] - J_ref[clean]))
                 / np.max(np.abs(J_ref[clean]))) if clean.any() else math.inf
        err = max(err_y, err_J)
        log(f"  mlp_value_and_jac {sizes['mlp_rows']}x23 -> 200x3 -> 17, "
            f"precision={name}: value err {err_y:.3e}, jacobian err "
            f"{err_J:.3e} on {int(clean.sum())}/{clean.size} rows "
            f"(limit {MLP_LIMITS[name]:.0e}) "
            f"{'ok' if err <= MLP_LIMITS[name] else 'FAIL'}")
        if not err <= MLP_LIMITS[name]:
            raise AssertionError(f"mlp_value_and_jac error {err} at {name}")
        results[name] = err
    return results


def plan_reference(sizes):
    """Phase 2 (ii): the batch solver against the vmapped single-instance
    solver, both at "highest", on lanes of the flagship batch (reset
    states of the flagship envs), within the tolerance of
    tests/test_batch_ilqr.py. The batch solver at the card's default
    precision (TF32 GEMMs) is printed beside it, unchecked: it changes
    the iterates, which ROADMAP Queue 1 #3 measures."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from gan_mpc_tpu.envs import make_env

    env = make_env("cheetah_run")
    env_params = env.default_params()
    policy, params, x_size, u_size = ge._flagship(
        horizon=5, max_iterations=5, x_size=env.obs_size, u_size=env.act_size,
    )
    keys = jax.random.split(jax.random.PRNGKey(0), sizes["lanes"])
    obs = jax.vmap(
        lambda k: env.observe(env_params, env.reset(env_params, k))
    )(keys)
    hX = jnp.stack([obs, obs], axis=1)
    hU = jnp.zeros((sizes["lanes"], 1, u_size))
    plan_batch = jax.jit(policy.plan_batch)
    obj_default = np.asarray(plan_batch(params, hX, hU).obj)
    with jax.default_matmul_precision("highest"):
        obj_batch = np.asarray(plan_batch(params, hX, hU).obj)
        obj_ref = np.asarray(jax.jit(jax.vmap(
            lambda hx, hu: policy.plan(params, hx, hu)
        ))(hX, hU).obj)

    def excess(obj):  # <= 0.02 is assert_allclose(rtol=0.05, atol=0.02)
        return float(np.max(np.abs(obj - obj_ref) - 0.05 * np.abs(obj_ref)))

    err = excess(obj_batch)
    ok = bool(np.all(np.isfinite(obj_batch)) and err <= 0.02)
    log(f"  plan_batch vs vmapped plan, both highest, {sizes['lanes']} "
        f"lanes: max(|d obj| - 0.05 |obj|) = {err:.3e} (limit 0.02) "
        f"{'ok' if ok else 'FAIL'}; objectives "
        f"{np.round(obj_batch[:4], 4).tolist()}...")
    rel = np.abs(obj_default - obj_ref) / np.abs(obj_ref)
    log(f"  plan_batch at default precision vs the same reference "
        f"(unchecked): max(|d obj| - 0.05 |obj|) = {excess(obj_default):.3e}, "
        f"max relative {float(np.max(rel)):.3e}, median relative "
        f"{float(np.median(rel)):.3e}")
    if not ok:
        raise AssertionError("plan_batch disagrees with the vmapped plan")
    return err


def checkpoint_row(bench, sizes, card):
    row = bench.bench_row(
        bench._load_checkpoint(os.path.join(ROOT, bench.DEFAULT_CHECKPOINT)),
        sizes["envs"], sizes["steps"],
    )
    log(f"[{card}] {json.dumps(row)}")
    return row


def trainer(rehearsal: bool, workdir: str):
    import jax
    import jax.numpy as jnp

    from gan_mpc_tpu.config import Config
    from gan_mpc_tpu.runners import gan
    from gan_mpc_tpu.utils import io
    from gan_mpc_tpu.utils.checkpoint import TrainCheckpointer

    config = Config.from_yaml(
        os.path.join(ROOT, "configs", "gan_pendulum_quality.yaml")
    )
    overrides = dict(TRAINER_CUTS, runtime__workdir=workdir)
    if rehearsal:  # CPU-sized: the fast recipe of the verify notes
        overrides.update(
            mpc__train__num_epochs=1,
            mpc__train__num_trajectories=4,
            mpc__train__trajectory_len=150,
            mpc__train__dynamics__max_interactions_per_episode=20,
            mpc__train__dynamics__num_updates=1,
            mpc__train__cost__num_updates=1,
            mpc__train__critic__num_updates=1,
            mpc__evaluate__max_interactions=20,
            mpc__evaluate__num_runs_for_avg=2,
            mpc__evaluate__fresh_eval_episodes=2,
            mpc__evaluate__dm_control_episodes=0,
            mpc__solver__max_iterations=3,
            expert_prediction__train__num_epochs=1,
            expert_prediction__dagger__num_segments=4,
            expert_prediction__dagger__segment_steps=10,
            expert_prediction__dagger__policy_episodes=1,
            expert_prediction__dagger__finetune_epochs=1,
            env__collect_trajectories=4,
            env__expert_episode_steps=150,
            mpc__train__min_expert_reward=0.0,
            runtime__num_parallel_envs=2,
        )
    config = config.replace(**overrides)
    out = gan.run(config, log_fn=log)
    hist = out["history"]
    epochs = len(hist["episode_returns"])
    if epochs != config.mpc.train.num_epochs:
        raise AssertionError(f"trainer ran {epochs} epochs, expected "
                             f"{config.mpc.train.num_epochs}")
    losses = {k: v for k, v in hist.items() if k.endswith("losses")}
    for name, values in losses.items():
        if not values or not all(math.isfinite(v) for v in values):
            raise AssertionError(f"trainer {name} not finite: {values}")
    log(f"  trainer: {epochs} epochs, last losses "
        + ", ".join(f"{k} {v[-1]:.5f}" for k, v in losses.items())
        + f", avg_reward {out['avg_reward']:.2f}")

    params = out["params"]
    ckpt = TrainCheckpointer(os.path.join(workdir, "smoke_ckpt"), keep=1)
    ckpt.maybe_save(1, {"params": params, "key": jax.random.PRNGKey(5)})
    template = jax.tree_util.tree_map(
        jnp.zeros_like, {"params": params, "key": jax.random.PRNGKey(0)}
    )
    restored = ckpt.restore(template)
    from_file = io.load_params(
        params, os.path.join(out["run_dir"], "params.msgpack")
    )
    for tree in (restored["params"], from_file):
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(params)):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise AssertionError("restored params differ from trained")
    log(f"  checkpoint: step {ckpt.latest_step()} saved and restored, "
        f"params.msgpack re-read bit-exact ({out['run_dir']})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--cpu-rehearsal", action="store_true",
        help="allow a non-GPU device and shrink every phase to tiny sizes",
    )
    args = ap.parse_args(argv)
    rehearsal = args.cpu_rehearsal
    sizes = SIZES[rehearsal]
    sys.path.insert(0, ROOT)

    with phase("0 device"):
        dev, card = device_check(rehearsal)
        from gan_mpc_tpu import runtime_setup

        runtime_setup.setup()
        import bench
    with phase("1 planner (flagship bench row)"):
        planner_row(bench, sizes, card)
    with phase("2 references"):
        mlp_reference(sizes)
        plan_reference(sizes)
    with phase("3 trained checkpoint (cheetah_run gan/4 bench row)"):
        checkpoint_row(bench, sizes, card)
    workdir = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    try:
        with phase("4 trainer (gan_pendulum_quality, cut)"):
            trainer(rehearsal, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    import jax

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
