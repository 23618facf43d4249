"""Seeded random flax params for the port's parity tests.

The tree comes from ``jax.eval_shape`` of the flax model's ``init`` (its
names and shapes, with nothing compiled); the values come from numpy, so
both frameworks get the same numbers: conv and linear kernels normal with
the He / LeCun variance, biases and batch-norm statistics randomised so that
every leaf matters."""

import jax
import jax.numpy as jnp
import numpy as np

from wsinsight_tpu.models import create_model


def random_flax_params(arch: str, num_classes: int, size: int, seed: int = 0):
    """(flax model, params as nested dicts of float32 numpy arrays)."""
    model = create_model(arch, num_classes)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)
    params = {}
    for mod, leaves in shapes["params"].items():
        params[mod] = {}
        for name, leaf in leaves.items():
            shape = leaf.shape
            if name == "kernel":
                gain = 2.0 if len(shape) == 4 else 1.0
                value = rng.standard_normal(shape) * np.sqrt(gain / np.prod(shape[:-1]))
            elif name in ("weight", "running_var"):  # batch norm: positive
                value = rng.random(shape) + 0.5
            else:  # bias, running_mean
                value = rng.standard_normal(shape) * 0.1
            params[mod][name] = value.astype(np.float32)
    return model, params
