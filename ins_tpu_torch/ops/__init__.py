from .conv_kernels import (  # noqa: F401
    make_conv_layer,
    packconv_3d,
    tapconv_3d,
    tapconv_wgrad_3d,
)
from .diffkernels import convdiff_roll  # noqa: F401
from .eddyviscosity import (  # noqa: F401
    apply_eddy_viscosity,
    divoftensor,
    divoftensor_natural,
    smagorinsky_closure,
    smagorinsky_closure_natural,
    smagorinsky_natural_interior,
    smagorinsky_viscosity,
    strain_natural,
)
from .fdm import psolver_fdm  # noqa: F401
from .initializers import (  # noqa: F401
    create_spectrum,
    random_field,
    scalarfield,
    temperaturefield,
    vectorfield,
    velocityfield,
)
from .operators import *  # noqa: F401,F403
from .perop_kernels import (  # noqa: F401
    convdiff_periodic_uniform_3d,
    momentum_stage_div_3d,
)
from .poisson_kernels import make_fused_projection  # noqa: F401
from .pressure import (  # noqa: F401
    default_psolver,
    poisson,
    pressure,
    project,
    psolver_cg,
    psolver_cg_matrix,
    psolver_direct,
    psolver_spectral,
)
from .tensorbasis import lastdimcontract, monitor, tensorbasis  # noqa: F401
from .smag_kernels import smagorinsky_force_3d, smagorinsky_force_halo_3d  # noqa: F401
