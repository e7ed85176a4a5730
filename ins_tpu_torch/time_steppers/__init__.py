from . import rk_methods as RKMethods  # noqa: F401
from .methods import (  # noqa: F401
    AdamsBashforthCrankNicolsonMethod,
    ExplicitRungeKuttaMethod,
    ImplicitRungeKuttaMethod,
    LMWray3,
    OneLegMethod,
    runge_kutta_method,
)
from .imex import ABCNState, OneLegState  # noqa: F401
from .step import StepperState, create_stepper, timestep  # noqa: F401
