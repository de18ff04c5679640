"""Device mesh + sharding helpers.

The reference is single-process single-device (SURVEY.md §2 parallelism
table: no pmap/pjit/shard_map/psum anywhere). Scale-out here is a
1-D ``jax.sharding.Mesh`` over the data-parallel ("dp") axis — thousands
of env+planner instances sharded across devices, params replicated,
gradient reduction via ``psum`` (NCCL collectives on GPUs; the cards of
one host are joined all to all by NVLink, so the mesh follows the
algorithm alone).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    num_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp",),
    shape: Optional[Sequence[int]] = None,
) -> Mesh:
    devices = jax.devices()
    n = num_devices or len(devices)
    if shape is None:
        shape = (n,)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev_array, axis_names)


def make_hybrid_mesh(
    axis_names: Sequence[str] = ("dcn", "ici"),
    dcn_size: Optional[int] = None,
) -> Mesh:
    """2-D multi-host mesh: slow axis ("dcn") crosses hosts, fast axis
    ("ici") stays within one host's devices, so that gradient reductions
    reduce hierarchically — intra-host traffic stays on the host's own
    links and only the host-level partial crosses the network between
    hosts.

    Under ``jax.distributed`` the dcn axis defaults to ``process_count()``
    and devices are grouped so each mesh row is one process's local chips.
    Single-process (tests), pass ``dcn_size`` to split the virtual devices
    into fake slices.
    """
    devices = jax.devices()
    dcn = dcn_size or max(jax.process_count(), 1)
    if len(devices) % dcn != 0:
        raise ValueError(
            f"{len(devices)} devices not divisible into {dcn} slices"
        )
    # group by owning process so rows = slices; stable order within a row
    devs = sorted(devices, key=lambda d: (d.process_index, d.id))
    dev_array = np.asarray(devs).reshape(dcn, -1)
    return Mesh(dev_array, tuple(axis_names))


def data_axes(mesh: Mesh):
    """The mesh axes a data batch shards over: all of ("dcn", "ici") that
    exist, else the 1-D "dp" axis. Usable directly as the ``axis``
    argument of every sharded step (P() and pmean both accept tuples)."""
    names = tuple(a for a in ("dcn", "ici") if a in mesh.axis_names)
    return names if names else "dp"


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, axis: str = "dp") -> NamedSharding:
    """Shard the leading (batch) dimension over the mesh axis."""
    return NamedSharding(mesh, P(axis))


def shard_batch(tree, mesh: Mesh, axis: str = "dp"):
    """Place every array's leading dim across the mesh (pads not handled —
    callers keep batch % num_devices == 0, standard practice)."""
    sharding = batch_sharding(mesh, axis)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree
    )


def mlp_tensor_parallel_sharding(params, mesh: Mesh, axis: str = "tp"):
    """Tensor-parallel NamedShardings for an MLP parameter pytree: hidden
    (last) axes of kernels and biases shard over ``axis``; everything else
    replicates. For the model sizes of this framework TP is optional
    (SURVEY.md §2 parallelism table: largest layer 200 units), but the
    humanoid-scale ensemble config can enable it for its 256-wide stacks;
    XLA inserts the (all-gather/reduce-scatter) collectives.
    """
    size = mesh.shape[axis]

    def spec(leaf):
        if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[-1] % size == 0:
            return NamedSharding(
                mesh, P(*([None] * (leaf.ndim - 1) + [axis]))
            )
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(spec, params)


def apply_tensor_parallel(params, mesh: Mesh, axis: str = "tp"):
    """device_put params according to ``mlp_tensor_parallel_sharding``."""
    shardings = mlp_tensor_parallel_sharding(params, mesh, axis)
    return jax.tree_util.tree_map(jax.device_put, params, shardings)
