"""JAX oracles the port's tests build, compiled once.

`jax_cnn` is `ins_tpu.models.cnn` with the parameters drawn under
`jax.jit`: the same model, the same closure and the same draw from
``rng``, where the package's `create_closure` initialises the model op
by op (~3x the time on the CPU).
"""

import jax
import jax.numpy as jnp

from ins_tpu.models.cnn import CNN


def jax_cnn(*, setup, radii, channels, activations, use_bias, rng, compute_dtype=None,
            pallas="auto"):
    """`(closure, theta)` as `ins_tpu.models.cnn` returns them."""
    g = setup.grid
    model = CNN(radii=tuple(radii), channels=tuple(channels), activations=tuple(activations),
                use_bias=tuple(use_bias), dtype=setup.dtype, compute_dtype=compute_dtype,
                pallas=pallas)
    n = tuple(e - s for (s, e) in g.Iu[0])
    x0 = jnp.zeros((1, *n, g.dim), setup.dtype)
    theta = jax.jit(model.init)(rng, x0)["params"]

    def closure(x, theta):
        return model.apply({"params": theta}, x)

    return closure, theta
