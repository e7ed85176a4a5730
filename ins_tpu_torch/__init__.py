"""ins_tpu_torch: the PyTorch/CUDA port of ins_tpu for NVIDIA Hopper.

The JAX package `ins_tpu` is the reference; this package runs six of its
paths in PyTorch — 3-D decaying turbulence on a uniform periodic box
(explicit RK or LMWray3, spectral projection, optionally with a closure
model and with opt-in bf16 stream storage), its Smagorinsky LES
(`smagorinsky_closure_natural`, optionally with a steady body force),
periodic Boussinesq convection (`temperature_equation`,
`temperaturefield`, `observe_nusselt`), a-posteriori training of a CNN
closure through the unrolled solver (`ins_tpu_torch.models`) and the
wall-bounded turbulent channel (x/y periodic, stretched no-slip z walls,
steady body force, FDM projection) — and the 3-D periodic cube, its
Smagorinsky LES and a steady body force on an x-slab mesh of devices
(`parallel`: `solve_unsteady(mesh=make_mesh(), halo=True)` over
`torch.distributed`), with the TPU kernels of those paths rewritten as
hand-written CUDA for `sm_90a` (`csrc/`, built at first use by
`_build.py`); so are the JAX package's remaining kernels: the CNN
layer's tap-matmul / pack-tile form (`make_conv_layer`, `tapconv_3d`,
`packconv_3d`, `tapconv_wgrad_3d`) and the unfused projection step's
stage (`momentum_stage_div_3d`). Every other setup — walls, lids,
inflow and outflow, symmetric sides, stretched grids, non-periodic
temperature, the ghosted Smagorinsky closures, `psolver_cg`,
`psolver_cg_matrix` and the host `psolver_direct` (on
`ops/matrices.py`), the IMEX AB-CN and one-leg steppers and the
Newton-Krylov implicit Runge-Kutta tableaus — steps the general ghosted
path in plain PyTorch (`apply_bc_*`, `ops/operators.py`, `project`,
`timestep`), as `ins_tpu`'s is plain JAX; its observers
(`fieldobserver`, `observe_wallshear`, `get_streamfunction`) and the
tensor basis (`tensorbasis`) too.
Every tensor of a run lives on `Setup(device=...)`, the
card by default; with ``device="cpu"`` each kernel wrapper runs its
plain PyTorch version. It imports torch and never jax.
"""

from . import parallel, processors  # noqa: F401
from .boundary_conditions import (  # noqa: F401
    DirichletBC,
    PeriodicBC,
    PressureBC,
    SymmetricBC,
    apply_bc_p,
    apply_bc_temp,
    apply_bc_u,
)
from .grid import (  # noqa: F401
    cosine_grid,
    make_grid,
    max_size,
    stretched_grid,
    tanh_grid,
)
from .ops import *  # noqa: F401,F403
from .processors import (  # noqa: F401
    Processor,
    fieldobserver,
    fieldsaver,
    get_streamfunction,
    observe_nusselt,
    observe_wallshear,
    observefield,
    observespectrum,
    processor,
    timelogger,
    total_kinetic_energy,
)
from .setup import Setup, Temperature, temperature_equation  # noqa: F401
from .solver import SolverDivergedError, get_state, solve_unsteady  # noqa: F401
from .time_steppers import (  # noqa: F401
    LMWray3,
    RKMethods,
    create_stepper,
    runge_kutta_method,
    timestep,
)

__version__ = "0.1.0"
