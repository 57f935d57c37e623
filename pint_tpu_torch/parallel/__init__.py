"""The multi-device tier: a (dp, tp) mesh of processes under
``torch.distributed`` and the mesh-sharded solvers (port of
``pint_tpu/parallel``)."""

from pint_tpu_torch.parallel.mesh import host_local_mesh, make_mesh
from pint_tpu_torch.parallel.solver import ShardedConstrainedPGD, ShardedPGD

__all__ = [
    "make_mesh",
    "host_local_mesh",
    "ShardedPGD",
    "ShardedConstrainedPGD",
]
