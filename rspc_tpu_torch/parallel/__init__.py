"""Scale-out over ``torch.distributed`` (port of ``rspc_tpu/parallel/``):
one process per rank over a ``DeviceMesh`` with the JAX package's axis
names, ``"data"`` (independent sequences or pairs) and ``"points"`` (the
source or target rows of one solve, reduced by all-reduces)."""

from rspc_tpu_torch.parallel.chain import (  # noqa: F401
    batched_registration,
    points_sharded_registration,
)
from rspc_tpu_torch.parallel.icp import (  # noqa: F401
    batched_sharded_icp_align,
    sharded_icp_align,
)
from rspc_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from rspc_tpu_torch.parallel.ndt import sharded_ndt_align  # noqa: F401
from rspc_tpu_torch.parallel.nn import sharded_nearest_neighbors  # noqa: F401
