"""Neural closure models for LES.

Port of `ins_tpu/models`: the closure adapters; CNN, FNO and p4
group-equivariant CNN closures (a 3-D tanh/identity CNN on the port's
conv kernels, everything else plain PyTorch as in the JAX package);
face and volume filters; filtered-DNS data generation; a-priori and
a-posteriori (grad-through-solver) losses, the symmetry errors and the
Adam training loops.
"""

from .closure import collocate, create_closure, decollocate, wrappedclosure  # noqa: F401
from .cnn import CNN, cnn  # noqa: F401
from .data_generation import (  # noqa: F401
    create_io_arrays,
    create_les_data,
    filtersaver,
    gaussian_bump,
    gaussian_force,
)
from .filters import FaceAverage, VolumeAverage, reconstruct  # noqa: F401
from .fno import FNO, FourierLayer, fno  # noqa: F401
from .groupconv import GCNN, GroupConv2D, gcnn, rot2, rot2stag, vecrot2  # noqa: F401
from .training import (  # noqa: F401
    create_callback,
    create_dataloader_post,
    create_dataloader_prior,
    create_loss_post,
    create_loss_prior,
    create_relerr_post,
    create_relerr_prior,
    create_relerr_symmetry_post,
    create_relerr_symmetry_prior,
    create_trainstate,
    train,
    trainepoch,
)
