"""Neural closure models for LES.

Port of `ins_tpu/models` for the a-posteriori training path: the
closure adapters, the CNN closure on the port's conv kernels, and the
a-posteriori (grad-through-solver) and a-priori losses with an Adam
training loop.  FNO, group-equivariant CNNs, filters, data generation
and the symmetry errors wait for ROADMAP queue 1 item 9.
"""

from .closure import collocate, create_closure, decollocate, wrappedclosure  # noqa: F401
from .cnn import CNN, cnn  # noqa: F401
from .training import (  # noqa: F401
    create_dataloader_post,
    create_loss_post,
    create_loss_prior,
    create_relerr_post,
    create_relerr_prior,
    create_trainstate,
    train,
)
