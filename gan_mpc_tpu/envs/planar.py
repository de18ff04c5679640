"""Differentiable planar articulated-rigid-body physics (pure JAX).

A small "MJX-style" engine for locomotion tasks (cheetah / walker class):
a kinematic tree of rigid links in the x-z plane with a 3-DoF floating
root (x, z, pitch) and hinge joints, Lagrangian dynamics assembled with
autodiff, and penalty-based ground contacts. Everything is a pure
function of (model, q, qd, tau) — jit/vmap/shard_map-friendly, static
shapes, no data-dependent control flow — so whole episodes batch on the device.

Dynamics assembly (textbook Lagrangian mechanics, autodiff-powered):
  * forward kinematics gives per-body COM positions c_i(q) and world
    angles a_i(q);
  * mass matrix  M(q) = Jc^T diag(m) Jc + Ja^T diag(I) Ja  with the
    Jacobians from ``jax.jacfwd`` — exact, no hand-derived equations;
  * bias forces  h(q, qd) = (d/dq)[M(q) qd] qd - 1/2 d/dq (qd^T M qd)
                  + dV/dq  (Coriolis/centrifugal + gravity);
  * contacts: spring-damper normal force + smooth tanh friction at
    declared contact points, mapped to joint space via J^T;
  * integration: semi-implicit Euler with substeps,
    qdd = solve(M + eps I, tau - h + J^T f).

The engine replaces the reference's dependence on the MuJoCo C library
(``/root/reference/utils.py:38-62``) for cheetah-class tasks with a
device-resident step; SURVEY.md §2.9-bis row 1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class PlanarModel(NamedTuple):
    """Static description of a planar kinematic tree.

    nb bodies; body 0 is the root (its joint is the free planar root
    accounting for generalized coords q[0:3] = (x, z, pitch)); body i>0
    attaches to ``parent[i]`` through a hinge at ``joint_anchor[i]``
    (expressed in the parent's frame) with joint angle q[2 + i].
    nq = 3 + (nb - 1).

    Per-body geometry: the COM offset ``com_offset[i]`` in the body frame.
    Arrays here are *structure* (static python/numpy at trace time is fine
    since they are jnp arrays captured in closures).
    """

    parent: tuple  # len nb, parent[0] = -1
    joint_anchor: jnp.ndarray  # (nb, 2) anchor in parent frame (root row unused)
    com_offset: jnp.ndarray  # (nb, 2) COM in body frame
    mass: jnp.ndarray  # (nb,)
    inertia: jnp.ndarray  # (nb,) about COM (out-of-plane axis)
    joint_stiffness: jnp.ndarray  # (nb,) hinge stiffness (row 0 unused)
    joint_damping: jnp.ndarray  # (nb,)
    joint_ref: jnp.ndarray  # (nb,) hinge rest angle
    joint_range: jnp.ndarray  # (nb, 2) hinge limits [lo, hi]
    gear: jnp.ndarray  # (nb,) actuator gear (0 = unactuated; row 0 unused)
    contact_body: tuple  # bodies carrying a contact point
    contact_offset: jnp.ndarray  # (nc, 2) point in body frame
    gravity: float = 9.81
    ground_kp: float = 4000.0
    ground_kd: float = 100.0
    friction_mu: float = 1.0
    friction_vslip: float = 0.1
    limit_kp: float = 300.0


def _rot(a):
    c, s = jnp.cos(a), jnp.sin(a)
    return jnp.array([[c, -s], [s, c]])


def forward_kinematics(model: PlanarModel, q: jnp.ndarray):
    """World angle, joint-origin position, and COM position per body."""
    nb = len(model.parent)
    angles = [q[2]]
    origins = [q[:2]]
    for i in range(1, nb):
        p = model.parent[i]
        ang = angles[p] + q[2 + i]
        org = origins[p] + _rot(angles[p]) @ model.joint_anchor[i]
        angles.append(ang)
        origins.append(org)
    angles = jnp.stack(angles)  # (nb,)
    origins = jnp.stack(origins)  # (nb, 2)
    coms = origins + jax.vmap(lambda a, o: _rot(a) @ o)(
        angles, model.com_offset
    )
    return angles, origins, coms


def contact_points(model: PlanarModel, q: jnp.ndarray) -> jnp.ndarray:
    angles, origins, _ = forward_kinematics(model, q)
    pts = []
    for k, b in enumerate(model.contact_body):
        pts.append(origins[b] + _rot(angles[b]) @ model.contact_offset[k])
    return jnp.stack(pts)  # (nc, 2)


def mass_matrix(model: PlanarModel, q: jnp.ndarray) -> jnp.ndarray:
    Jc = jax.jacfwd(lambda q_: forward_kinematics(model, q_)[2])(q)
    Ja = jax.jacfwd(lambda q_: forward_kinematics(model, q_)[0])(q)
    M = jnp.einsum("bxi,b,bxj->ij", Jc, model.mass, Jc)
    M = M + jnp.einsum("bi,b,bj->ij", Ja, model.inertia, Ja)
    return M


def potential_energy(model: PlanarModel, q: jnp.ndarray) -> jnp.ndarray:
    _, _, coms = forward_kinematics(model, q)
    return model.gravity * jnp.sum(model.mass * coms[:, 1])


def bias_forces(model: PlanarModel, q, qd) -> jnp.ndarray:
    """Coriolis/centrifugal + gravity: h(q, qd) = Mdot qd - 1/2 d(qd^T M
    qd)/dq + dV/dq.

    Mdot = sum_k dM/dq_k qd_k is a directional derivative along qd — ONE
    jvp of the mass matrix, not a full (nq, nq, nq) Jacobian (the
    difference is the hot-path cost of the whole engine)."""
    _, Mdot = jax.jvp(lambda q_: mass_matrix(model, q_), (q,), (qd,))
    quad = jax.grad(lambda q_: 0.5 * qd @ mass_matrix(model, q_) @ qd)(q)
    grav = jax.grad(lambda q_: potential_energy(model, q_))(q)
    return Mdot @ qd - quad + grav


def joint_forces(model: PlanarModel, q, qd) -> jnp.ndarray:
    """Passive hinge forces: stiffness toward rest, damping, soft limits."""
    nq = q.shape[0]
    hinge_q = q[3:]
    hinge_qd = qd[3:]
    stiff = model.joint_stiffness[1:]
    damp = model.joint_damping[1:]
    ref = model.joint_ref[1:]
    lo, hi = model.joint_range[1:, 0], model.joint_range[1:, 1]
    tau = -stiff * (hinge_q - ref) - damp * hinge_qd
    tau = tau - model.limit_kp * (
        jnp.maximum(hinge_q - hi, 0.0) + jnp.minimum(hinge_q - lo, 0.0)
    )
    return jnp.concatenate([jnp.zeros(3, q.dtype), tau])


def contact_forces(model: PlanarModel, q, qd) -> jnp.ndarray:
    """Penalty ground contact mapped to joint space (J^T f)."""
    pts_fn = lambda q_: contact_points(model, q_)
    pts = pts_fn(q)
    J = jax.jacfwd(pts_fn)(q)  # (nc, 2, nq)
    vel = jnp.einsum("cxi,i->cx", J, qd)
    depth = -pts[:, 1]  # penetration > 0
    in_contact = depth > 0.0
    fn = jnp.where(
        in_contact,
        model.ground_kp * depth - model.ground_kd * jnp.minimum(vel[:, 1], 0.0),
        0.0,
    )
    fn = jnp.maximum(fn, 0.0)
    ft = -model.friction_mu * fn * jnp.tanh(vel[:, 0] / model.friction_vslip)
    f = jnp.stack([ft, fn], axis=-1)  # (nc, 2)
    return jnp.einsum("cxi,cx->i", J, f)


def actuation(model: PlanarModel, u: jnp.ndarray) -> jnp.ndarray:
    """Map bounded controls to hinge torques; u has one entry per actuated
    hinge (gear > 0), in body order."""
    gears = model.gear[1:]
    act_idx = jnp.cumsum(jnp.asarray(gears > 0, jnp.int32)) - 1
    full = jnp.where(
        gears > 0, gears * u[jnp.clip(act_idx, 0, u.shape[0] - 1)], 0.0
    )
    return jnp.concatenate([jnp.zeros(3, u.dtype), full])


def _damping_matrix(model: PlanarModel, q) -> jnp.ndarray:
    """Velocity-proportional force Jacobian D (tau_damp ~= -D qd): joint
    damping plus the normal-direction contact damper for active contacts.
    Folded into the implicit solve (MuJoCo-style implicit damping) so that
    light links with strong dampers stay stable at practical step sizes."""
    nq = q.shape[0]
    D = jnp.zeros((nq, nq), q.dtype)
    D = D + jnp.diag(
        jnp.concatenate([jnp.zeros(3, q.dtype), model.joint_damping[1:]])
    )
    pts_fn = lambda q_: contact_points(model, q_)
    pts = pts_fn(q)
    J = jax.jacfwd(pts_fn)(q)  # (nc, 2, nq)
    active = (pts[:, 1] < 0.0).astype(q.dtype) * model.ground_kd
    Jz = J[:, 1, :]  # (nc, nq) vertical rows
    D = D + jnp.einsum("c,ci,cj->ij", active, Jz, Jz)
    return D


def step(model: PlanarModel, q, qd, u, dt: float, substeps: int = 2):
    """One control step (semi-implicit Euler with implicit damping)."""
    h = dt / substeps
    tau_a = actuation(model, u)

    def sub(carry, _):
        q, qd = carry
        M = mass_matrix(model, q)
        rhs = (
            tau_a
            - bias_forces(model, q, qd)
            + joint_forces(model, q, qd)
            + contact_forces(model, q, qd)
        )
        # Linearize damping about qd: f(qd_next) ~= f(qd) - D (qd_next-qd)
        # => (M + h D) (qd_next - qd) = h rhs(qd), i.e. the damper acts on
        # qd_next (unconditionally stable) while rhs keeps its explicit
        # value.
        A = (
            M
            + h * _damping_matrix(model, q)
            + 1e-6 * jnp.eye(q.shape[0], dtype=q.dtype)
        )
        qd_next = qd + h * jnp.linalg.solve(A, rhs)
        q = q + h * qd_next
        return (q, qd_next), None

    (q, qd), _ = jax.lax.scan(sub, (q, qd), None, length=substeps)
    return q, qd
