"""Multi-device execution: the x-slab halo chain on `torch.distributed`.

Port of `ins_tpu/parallel` for its explicit 1-D mesh path: `make_mesh`
and `shard_state` (`mesh.py`), `make_halo_fast_step`, `shard_interior`
and `shard_scalar` (`halo.py`).  `solve_unsteady(mesh=make_mesh(),
halo=True)` drives it.
"""

from .halo import make_halo_fast_step, shard_interior, shard_scalar  # noqa: F401
from .mesh import make_mesh, shard_state  # noqa: F401
