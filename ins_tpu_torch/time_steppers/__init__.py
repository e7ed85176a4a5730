from . import rk_methods as RKMethods  # noqa: F401
from .methods import (  # noqa: F401
    ExplicitRungeKuttaMethod,
    ImplicitRungeKuttaMethod,
    LMWray3,
    runge_kutta_method,
)
from .step import StepperState, create_stepper, timestep  # noqa: F401
