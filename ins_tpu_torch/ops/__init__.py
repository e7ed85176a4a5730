from .diffkernels import convdiff_roll  # noqa: F401
from .eddyviscosity import (  # noqa: F401
    smagorinsky_closure_natural,
    smagorinsky_natural_interior,
)
from .fdm import psolver_fdm  # noqa: F401
from .initializers import (  # noqa: F401
    create_spectrum,
    random_field,
    scalarfield,
    temperaturefield,
    velocityfield,
)
from .poisson_kernels import make_fused_projection  # noqa: F401
from .pressure import default_psolver, psolver_spectral  # noqa: F401
from .smag_kernels import smagorinsky_force_3d, smagorinsky_force_halo_3d  # noqa: F401
