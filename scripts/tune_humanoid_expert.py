"""Tune the scripted humanoid stand expert's feedback gains by CEM.

The humanoid is the heaviest planar body (46 kg, head at 1.85 m); manual
PD gains that work for the walker do not transfer. This searches the gain
vector of the balance controller with a cross-entropy method over the
vmapped differentiable engine (same approach that found the cheetah gait).

Usage: python scripts/tune_humanoid_expert.py [env_name] [iters]
Prints the best gain vector + mean return; paste into runners/collect.py.
"""

import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

# persistent compile cache (gan_mpc_tpu/runtime_setup.py)
from gan_mpc_tpu import runtime_setup  # noqa: E402

runtime_setup.setup()

from gan_mpc_tpu.envs import make_env

ENV = sys.argv[1] if len(sys.argv) > 1 else "humanoid_stand"
ITERS = int(sys.argv[2]) if len(sys.argv) > 2 else 30
POP = 128
SEEDS = 4
STEPS = 600
ELITE = 8

env = make_env(ENV)
P = env.default_params()

from gan_mpc_tpu.runners.collect import humanoid_balance_policy

# g: kp, kd, ank_e, ank_edot, hip_trunk_p, hip_trunk_d, waist_p,
#    waist_d, hip_e — feedback terms init at 0 with generous sigma so
# CEM discovers signs itself (joint-torque sign chains are error-prone).
G0 = jnp.array([3.0, 0.3, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
SIG0 = jnp.array([1.5, 0.2, 8.0, 2.0, 6.0, 1.5, 4.0, 1.0, 6.0])


def policy(g, obs):
    return humanoid_balance_policy(g, obs)


def episode(g, key):
    s = env.reset(P, key)

    def body(s, _):
        obs = env.observe(P, s)
        s, r = env.step(P, s, policy(g, obs))
        return s, r

    _, rs = jax.lax.scan(body, s, None, length=STEPS)
    return jnp.sum(rs)


@jax.jit
def score(gs, key):
    ks = jax.random.split(key, SEEDS)
    return jax.vmap(
        lambda g: jnp.mean(jax.vmap(lambda k: episode(g, k))(ks))
    )(gs)


def main():
    mu, sig = G0, SIG0
    key = jax.random.PRNGKey(0)
    best_g, best_r = G0, -jnp.inf
    for it in range(ITERS):
        key, k1 = jax.random.split(key)
        pop = mu + sig * jax.random.normal(k1, (POP, mu.shape[0]))
        rs = score(pop, jax.random.PRNGKey(it))
        elite = pop[jnp.argsort(-rs)[:ELITE]]
        mu = jnp.mean(elite, axis=0)
        sig = jnp.std(elite, axis=0) + 0.02
        r_best = float(jnp.max(rs))
        if r_best > best_r:
            best_r = r_best
            best_g = pop[int(jnp.argmax(rs))]
        print(
            f"it {it:2d}: best {r_best:7.1f} (global {best_r:7.1f}/"
            f"{STEPS}) mu_ret {float(jnp.mean(rs)):7.1f}"
        )
    print("\nbest gains:", [round(float(v), 4) for v in best_g])
    print("best return:", best_r, "/", STEPS)


if __name__ == "__main__":
    main()
