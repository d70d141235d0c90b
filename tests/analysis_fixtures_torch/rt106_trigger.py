"""Must trigger RT106: jax and the reference anywhere, triton at module
level."""
import jax.numpy as jnp
import triton

from repro.core import state


def fallback(x):
    import optax
    from flax import linen

    return jnp.asarray(x), optax, linen, state, triton
