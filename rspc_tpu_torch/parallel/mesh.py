"""Device meshes over ``torch.distributed`` (port of
``rspc_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh``; the
port runs one process per rank over a
``torch.distributed.device_mesh.DeviceMesh`` with the same named axes:

  * ``data``   -- independent work items (sequences, frame pairs): each
                  rank runs its own share, and results are gathered with
                  one SUM all-reduce of zero-filled buffers;
  * ``points`` -- the long axis of one problem (the source rows of an
                  ICP or NDT solve, the target rows of an NN sweep):
                  each rank sweeps its chunk, and the additive moments
                  are all-reduced over the axis's process group
                  (``mesh.get_group(axis)``).

The caller starts the default process group (backend, address, world
size and rank are its choice); nothing here starts one.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_shape(n: int, n_axes: int) -> tuple:
    """The JAX package's factoring of ``n`` devices onto ``n_axes`` (1
    or 2) axes: one axis takes everything; two take ``(a, n // a)`` with
    ``a`` the largest divisor of ``n`` not above its square root (the
    ``data`` axis gets the smaller factor)."""
    if n_axes == 1:
        return (n,)
    if n_axes != 2:
        raise ValueError(f"a mesh has 1 or 2 axes, got {n_axes}")
    a = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return (a, n // a)


def make_mesh(
    n_devices: Optional[int] = None,
    axes: Sequence[str] = ("data", "points"),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``DeviceMesh`` over the initialised default group's ranks (all
    of them: ``n_devices``, where given, must be the world size), shaped
    by :func:`mesh_shape` and named by ``axes``. ``device_type`` is the
    device of the tensors the mesh's collectives carry: ``"cuda"`` (the
    card; NCCL, or gloo where the caller built a gloo group) or
    ``"cpu"`` (gloo). Under NCCL every rank on this host needs a card of
    its own."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: the default process group is not initialised; call "
            "torch.distributed.init_process_group(backend, init_method, "
            "world_size, rank) first"
        )
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(
            f"make_mesh: {n} devices asked of a world of {world} ranks; every "
            "rank of the default group is one device of the mesh"
        )
    if dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count()
        if local > cards:
            raise ValueError(
                f"make_mesh: {local} NCCL ranks on this host but {cards} cards; "
                "NCCL needs a card per rank"
            )
    return init_device_mesh(device_type, mesh_shape(n, len(axes)),
                            mesh_dim_names=tuple(axes))
