"""Tune a humanoid walking gait over the differentiable engine.

Three controller parameterizations:

  * ``small`` (round 2): the CEM-tuned stand balance policy
    (runners/collect.py) plus an 8-parameter open-loop phase gait
    (antiphase hip swing, knee flexion on the swing leg, ankle
    push-off). Plateaued at 186.8/500 — too few degrees of freedom for
    a real gait.
  * ``full`` (round 3, default): balance blend + a per-actuator CPG
    ``u_i += amp_i * sin(2 pi f t dt + phase_i)`` over all 12 actuators
    (27 params) — the same parameterization class as the cheetah gait
    that works (runners/collect.py _CHEETAH_GAIT), warm-started from the
    round-2 small-space optimum.

Search = CEM (evaluations batched on device), optionally followed by an
Adam polish on the analytic episode-return gradient through the
differentiable engine (--polish N) — we own the physics, so BPTT through
contacts is one jax.grad.

``--apg N`` instead trains a small MLP policy (obs + gait-phase features
-> 12 torques, blended over the balance controller) by pure analytic
policy gradient: N Adam steps on the full-episode return, gradients by
BPTT through the contact dynamics (Brax-style APG). The MLP head starts
at zero so step 0 IS the stand controller; the phase features let it
express a periodic gait the reactive CPG class cannot. Warm-start CPG
terms come along via --apg-cpg (adds the CEM-best CPG drive underneath).

  * ``pd`` (round 3, ``--pd``): a kinematic gait cycle (hip/knee/ankle
    joint-angle trajectories, arms antiphase) tracked by per-joint PD
    loops with learnable stiffness, over the balance blend + a
    speed-servoed lean (13 params). The PD inner loop rejects contact
    perturbations that knock purely additive torque CPGs over.

Usage: python scripts/tune_humanoid_walk.py [iters] [--small|--fb|--pd]
       [--polish N] [--apg N] [--steps N] [--seeds N]
"""

import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

# persistent compile cache (gan_mpc_tpu/runtime_setup.py)
from gan_mpc_tpu import runtime_setup  # noqa: E402

runtime_setup.setup()

from gan_mpc_tpu.envs import make_env
from gan_mpc_tpu.runners.collect import (
    _HUMANOID_STAND_GAINS,
    humanoid_balance_policy,
)

args = [a for a in sys.argv[1:]]
ITERS = int(args[0]) if args and args[0].isdigit() else 40
SMALL = "--small" in args
POLISH = int(args[args.index("--polish") + 1]) if "--polish" in args else 0
APG = int(args[args.index("--apg") + 1]) if "--apg" in args else 0
APG_CPG = "--apg-cpg" in args
APG_LR = (
    float(args[args.index("--apg-lr") + 1]) if "--apg-lr" in args else 1e-3
)
# truncated-BPTT window (0 = full-episode BPTT). Gradients through
# hundreds of contact steps are chaotic (positive Lyapunov exponents);
# stopping the chain every K steps keeps them informative about local
# control while the forward state still spans the whole episode.
APG_TRUNC = (
    int(args[args.index("--apg-trunc") + 1]) if "--apg-trunc" in args else 0
)
STEPS = int(args[args.index("--steps") + 1]) if "--steps" in args else 500
POP, ELITE = 128, 12
SEEDS = int(args[args.index("--seeds") + 1]) if "--seeds" in args else 4
# --w "v1,v2,..." warm-starts the search at a specific weight vector
# (e.g. a previous run's printed best); with ITERS==0 it just scores it.
W_INIT = (
    jnp.array([float(v) for v in args[args.index("--w") + 1].split(",")])
    if "--w" in args
    else None
)

env = make_env("humanoid_walk")
P = env.default_params()
G_STAND = jnp.asarray(_HUMANOID_STAND_GAINS)

# round-2 best of the small space (186.8/500): slow forward shuffle
W0_SMALL = jnp.array(
    [2.1968, 0.3703, -0.2143, 0.2345, 0.8791, 5.1957, -0.0852, 1.9435]
)
SIG0_SMALL = jnp.array([0.5, 0.25, 0.25, 0.15, 1.0, 1.0, 0.1, 0.3])


def walk_action_small(w, obs, t, dt):
    u = w[7] * humanoid_balance_policy(G_STAND, obs, env)
    ph = 2.0 * jnp.pi * w[0] * t * dt
    s = jnp.sin(ph)
    u = u.at[2].add(w[1] * s).at[5].add(-w[1] * s)
    ks = jnp.sin(ph + w[4])
    u = u.at[3].add(-w[2] * jnp.maximum(ks, 0.0))
    u = u.at[6].add(-w[2] * jnp.maximum(-ks, 0.0))
    a_s = jnp.sin(ph + w[5])
    u = u.at[4].add(w[3] * a_s).at[7].add(-w[3] * a_s)
    u = u.at[0].add(-w[6])  # forward lean
    return jnp.clip(u, -1.0, 1.0)


# full space: [freq, lean, balance_scale, amp(12), phase(12)]
def _full_init():
    amp = jnp.zeros(12)
    phase = jnp.zeros(12)
    w = W0_SMALL
    # hips antiphase
    amp = amp.at[2].set(w[1]).at[5].set(w[1])
    phase = phase.at[5].set(jnp.pi)
    # knees: the rectified swing-leg flexion of the small space maps to
    # antiphase sin at half amplitude
    amp = amp.at[3].set(0.5 * w[2]).at[6].set(0.5 * w[2])
    phase = phase.at[3].set(w[4]).at[6].set(w[4] + jnp.pi)
    # ankles antiphase push-off
    amp = amp.at[4].set(w[3]).at[7].set(w[3])
    phase = phase.at[4].set(w[5]).at[7].set(w[5] + jnp.pi)
    mu = jnp.concatenate(
        [jnp.array([w[0], w[6], w[7]]), amp, phase]
    )
    sig = jnp.concatenate(
        [jnp.array([0.4, 0.1, 0.3]), 0.15 * jnp.ones(12),
         0.8 * jnp.ones(12)]
    )
    return mu, sig


def walk_action_full(w, obs, t, dt):
    freq, lean, bal = w[0], w[1], w[2]
    amp, phase = w[3:15], w[15:27]
    u = bal * humanoid_balance_policy(G_STAND, obs, env)
    ph = 2.0 * jnp.pi * freq * t * dt
    u = u + amp * jnp.sin(ph + phase)
    u = u.at[0].add(-lean)
    return jnp.clip(u, -1.0, 1.0)


# fb space: full + [k_v, v_ref, k_amp_pitch] (30 params) — closes two
# loops the open-loop CPG cannot: lean follows the forward-speed error
# (so the gait neither stalls nor runaway-pitches), and CPG amplitude
# backs off quadratically with trunk pitch (let the balance terms
# recover before stepping again).
def walk_action_fb(w, obs, t, dt):
    freq, lean, bal = w[0], w[1], w[2]
    amp, phase = w[3:15], w[15:27]
    k_v, v_ref, k_ap = w[27], w[28], w[29]
    vx, pitch = obs[14], obs[1]
    u = bal * humanoid_balance_policy(G_STAND, obs, env)
    ph = 2.0 * jnp.pi * freq * t * dt
    scale = 1.0 / (1.0 + k_ap * pitch * pitch)
    u = u + scale * amp * jnp.sin(ph + phase)
    u = u.at[0].add(-(lean + k_v * (v_ref - vx)))
    return jnp.clip(u, -1.0, 1.0)


# pd space (round 3): a KINEMATIC gait cycle tracked by per-joint PD
# loops instead of additive torque CPGs. Joint-angle targets:
#   hips antiphase sin, knees rectified flexion on the swing leg (a knee
#   can only bend backward: target in [-A_k, 0]), ankles push-off sin,
#   arms swing opposite their hips; waist/neck targets 0 (trunk is
#   handled by the balance blend + speed-servoed lean).
# u_i = kp_i (qt_i - q_i) - kd_i qd_i maps target curves to torques with
# the tracking stiffness itself learnable; this inner loop rejects the
# contact perturbations that knock open-loop CPGs over.
# w = [freq, lean, bal, A_hip, A_knee, ph_knee, A_ank, ph_ank, A_arm,
#      kp_leg, kd_leg, k_v, v_ref]  (13 params)
_PD_QIDX = jnp.arange(3, 15)  # actuated hinge q indices


def _pd_targets(w, ph):
    freq, A_h, A_k, ph_k, A_a, ph_a, A_arm = (
        w[0], w[3], w[4], w[5], w[6], w[7], w[8],
    )
    del freq
    s_l, s_r = jnp.sin(ph), jnp.sin(ph + jnp.pi)
    hip_l, hip_r = A_h * s_l, A_h * s_r
    # rectified swing-leg knee flexion (knee range is [-2, 0])
    knee_l = -A_k * jnp.maximum(jnp.sin(ph + ph_k), 0.0)
    knee_r = -A_k * jnp.maximum(jnp.sin(ph + jnp.pi + ph_k), 0.0)
    ank_l = A_a * jnp.sin(ph + ph_a)
    ank_r = A_a * jnp.sin(ph + jnp.pi + ph_a)
    sho_l, sho_r = -A_arm * s_l, -A_arm * s_r
    z = jnp.zeros(())
    return jnp.stack(
        [z, z, hip_l, knee_l, ank_l, hip_r, knee_r, ank_r,
         sho_l, z, sho_r, z]
    )


def walk_action_pd(w, obs, t, dt):
    lean, bal = w[1], w[2]
    kp, kd = jnp.abs(w[9]), jnp.abs(w[10])
    k_v, v_ref = w[11], w[12]
    q = jnp.concatenate([jnp.zeros(1), obs[:14]])  # qpos (x unobserved)
    qd = obs[14:]
    vx = qd[0]
    ph = 2.0 * jnp.pi * w[0] * t * dt
    qt = _pd_targets(w, ph)
    u_pd = kp * (qt - q[_PD_QIDX]) - kd * qd[_PD_QIDX]
    # legs get the gait PD; waist/neck/arm torques mostly from balance
    u = bal * humanoid_balance_policy(G_STAND, obs, env) + u_pd
    u = u.at[0].add(-(lean + k_v * (v_ref - vx)))
    return jnp.clip(u, -1.0, 1.0)


# CEM init for the pd space: modest gait, stiff tracking, dm walk speed
W0_PD = jnp.array(
    [1.4, 0.05, 1.0, 0.35, 0.5, 1.2, 0.25, -0.8, 0.15, 2.0, 0.1, 0.3, 1.0]
)
SIG0_PD = jnp.array(
    [0.4, 0.1, 0.3, 0.15, 0.25, 0.8, 0.15, 0.8, 0.1, 1.0, 0.1, 0.3, 0.4]
)

FB = "--fb" in args
PD = "--pd" in args
walk_action = (
    walk_action_small
    if SMALL
    else (
        walk_action_pd
        if PD
        else (walk_action_fb if FB else walk_action_full)
    )
)


def episode(w, key):
    s = env.reset(P, key)

    def body(carry, t):
        s = carry
        obs = env.observe(P, s)
        s, r = env.step(P, s, walk_action(w, obs, t, env.dt))
        return s, r

    _, rs = jax.lax.scan(body, s, jnp.arange(STEPS))
    return jnp.sum(rs)


@jax.jit
def score(ws, key):
    ks = jax.random.split(key, SEEDS)
    return jax.vmap(
        lambda w: jnp.mean(jax.vmap(lambda k: episode(w, k))(ks))
    )(ws)


@jax.jit
def mean_return_and_grad(w, key):
    ks = jax.random.split(key, SEEDS)

    def f(w):
        return jnp.mean(jax.vmap(lambda k: episode(w, k))(ks))

    return jax.value_and_grad(f)(w)


# ---------------------------------------------------------------------
# APG: MLP policy trained by BPTT through the differentiable engine.
# ---------------------------------------------------------------------
APG_HIDDEN = 32


def apg_init(key, cpg_w=None):
    k1, _ = jax.random.split(key)
    nin = env.obs_size + 2  # obs + (sin, cos) gait phase
    params = {
        # zero head: step 0 IS the balance (+ optional CPG) controller
        "W1": 0.5 * jax.random.normal(k1, (APG_HIDDEN, nin)) / jnp.sqrt(nin),
        "b1": jnp.zeros(APG_HIDDEN),
        "W2": jnp.zeros((12, APG_HIDDEN)),
        "b2": jnp.zeros(12),
        "freq": jnp.asarray(float(W0_SMALL[0])),
        "bal": jnp.asarray(1.0),
        "cpg": (
            cpg_w if cpg_w is not None else jnp.zeros(27)
        ),  # frozen CPG drive underneath (when --apg-cpg)
    }
    return params


def apg_action(p, obs, t, dt):
    ph = 2.0 * jnp.pi * p["freq"] * t * dt
    u = p["bal"] * humanoid_balance_policy(G_STAND, obs, env)
    if APG_CPG:
        amp, phase = p["cpg"][3:15], p["cpg"][15:27]
        u = u + amp * jnp.sin(ph + phase)
        u = u.at[0].add(-p["cpg"][1])
    feat = jnp.concatenate([obs, jnp.array([jnp.sin(ph), jnp.cos(ph)])])
    h = jnp.tanh(p["W1"] @ feat + p["b1"])
    u = u + p["W2"] @ h + p["b2"]
    return jnp.clip(u, -1.0, 1.0)


def apg_episode(p, key):
    s = env.reset(P, key)

    def body(carry, t):
        s = carry
        obs = env.observe(P, s)
        s, r = env.step(P, s, apg_action(p, obs, t, env.dt))
        # an aggressive policy can blow the contact integrator up; keep
        # the state finite with huge-but-finite clamps (inactive in any
        # normal gait; clip's zero-gradient outside the bounds cleanly
        # kills the BPTT chain of a diverged rollout instead of feeding
        # inf-inf/0*inf NaNs through the backward pass)
        s = s.replace(
            qpos=jnp.clip(s.qpos, -1e3, 1e3),
            qvel=jnp.clip(s.qvel, -1e2, 1e2),
        )
        return s, jnp.where(jnp.isfinite(r), r, 0.0)

    # rematerialize each step on the backward pass: BPTT memory stays
    # O(T * state) instead of O(T * substeps * intermediates)
    if APG_TRUNC <= 0:
        _, rs = jax.lax.scan(jax.checkpoint(body), s, jnp.arange(STEPS))
        return jnp.sum(rs)
    k = APG_TRUNC
    n_win = STEPS // k

    def window(carry, w):
        s = jax.tree_util.tree_map(jax.lax.stop_gradient, carry)
        s, rs = jax.lax.scan(
            jax.checkpoint(body), s, w * k + jnp.arange(k)
        )
        return s, jnp.sum(rs)

    _, r_win = jax.lax.scan(window, s, jnp.arange(n_win))
    return jnp.sum(r_win)


def run_apg(steps, cpg_w=None):
    import optax

    p = apg_init(jax.random.PRNGKey(0), cpg_w)
    # apply_if_finite: a diverged rollout's gradient (inf/NaN through the
    # blown-up contact state) skips the update instead of permanently
    # poisoning the params (observed: one bad step at lr 3e-3 NaN'd the
    # whole run)
    opt = optax.apply_if_finite(
        optax.chain(optax.clip_by_global_norm(1.0), optax.adam(APG_LR)),
        max_consecutive_errors=50,
    )
    st = opt.init(p)

    @jax.jit
    def apg_step(p, st, key):
        ks = jax.random.split(key, SEEDS)

        def neg_ret(p):
            return -jnp.mean(jax.vmap(lambda k: apg_episode(p, k))(ks))

        loss, g = jax.value_and_grad(neg_ret)(p)
        upd, st = opt.update(g, st, p)
        return optax.apply_updates(p, upd), st, -loss

    @jax.jit
    def apg_eval(p, key):
        ks = jax.random.split(key, 8)
        return jnp.mean(jax.vmap(lambda k: apg_episode(p, k))(ks))

    best_p, best_r = p, -jnp.inf
    for it in range(steps):
        p, st, r = apg_step(p, st, jax.random.PRNGKey(3000 + it))
        if it % 10 == 0 or it == steps - 1:
            r_eval = float(apg_eval(p, jax.random.PRNGKey(7000 + it)))
            if r_eval > best_r:
                best_r, best_p = r_eval, p
            print(
                f"apg {it:3d}: return {float(r):7.1f} "
                f"(eval {r_eval:7.1f}, global {best_r:7.1f}/{STEPS})",
                flush=True,
            )
    import numpy as np

    out = {k: np.asarray(v) for k, v in best_p.items()}
    out["apg_cpg"] = np.asarray(1.0 if APG_CPG else 0.0)
    np.savez("/tmp/humanoid_walk_apg.npz", **out)
    print("\nsaved best APG policy to /tmp/humanoid_walk_apg.npz")
    print("best eval return:", best_r, "/", STEPS)
    return best_p, best_r


def main():
    if APG > 0 and ITERS == 0:
        # standalone APG: seed the CPG drive with the round-2 CEM optimum
        # mapped into the full space (the 186.8/500 shuffle) when asked
        run_apg(APG, cpg_w=_full_init()[0] if APG_CPG else None)
        return
    if SMALL:
        mu, sig = W0_SMALL, SIG0_SMALL
    elif PD:
        mu, sig = W0_PD, SIG0_PD
    else:
        mu, sig = _full_init()
        if FB:
            # feedback terms start OFF (k_v=0, k_amp_pitch=0) at the
            # dm walk target speed; CEM discovers how hard to close
            # each loop
            mu = jnp.concatenate([mu, jnp.array([0.0, 1.0, 0.0])])
            sig = jnp.concatenate([sig, jnp.array([0.5, 0.4, 2.0])])
    if W_INIT is not None:
        assert W_INIT.shape == mu.shape, (W_INIT.shape, mu.shape)
        mu, sig = W_INIT, 0.3 * sig
    best_w, best_r = mu, -jnp.inf
    if ITERS == 0 and W_INIT is not None:
        r = float(jnp.mean(score(mu[None], jax.random.PRNGKey(0))[0]))
        print(f"eval-only: return {r:.1f} / {STEPS} over {SEEDS} seeds")
        best_r = r
    for it in range(ITERS):
        k1 = jax.random.PRNGKey(1000 + it)
        pop = mu + sig * jax.random.normal(k1, (POP, mu.shape[0]))
        pop = pop.at[0].set(best_w)  # elitism: keep the incumbent alive
        rs = score(pop, jax.random.PRNGKey(it))
        elite = pop[jnp.argsort(-rs)[:ELITE]]
        mu = jnp.mean(elite, axis=0)
        sig = jnp.std(elite, axis=0) + 0.02
        r_best = float(jnp.max(rs))
        if r_best > best_r:
            best_r, best_w = r_best, pop[int(jnp.argmax(rs))]
        print(
            f"it {it:2d}: best {r_best:7.1f} (global {best_r:7.1f}/"
            f"{STEPS}) mu {float(jnp.mean(rs)):7.1f}",
            flush=True,
        )

    if POLISH > 0:
        import optax

        opt = optax.adam(3e-3)
        w, st = best_w, opt.init(best_w)
        for it in range(POLISH):
            r, g = mean_return_and_grad(w, jax.random.PRNGKey(5000 + it))
            upd, st = opt.update(
                jax.tree_util.tree_map(lambda x: -x, g), st, w
            )
            w = optax.apply_updates(w, upd)
            r_eval = float(
                jnp.mean(score(w[None], jax.random.PRNGKey(9000 + it))[0])
            )
            if r_eval > best_r:
                best_r, best_w = r_eval, w
            print(f"polish {it:2d}: return {float(r):7.1f} "
                  f"(eval {r_eval:7.1f}, global {best_r:7.1f})", flush=True)

    print("\nbest w:", [round(float(v), 4) for v in best_w])
    print("best return:", best_r, "/", STEPS)

    if APG > 0:
        # hand the CEM-best CPG drive to the APG stage (--apg-cpg blends
        # it under the MLP; without the flag only the frequency carries)
        cpg = best_w[:27] if best_w.shape[0] >= 27 else None
        run_apg(APG, cpg_w=cpg)


if __name__ == "__main__":
    main()
