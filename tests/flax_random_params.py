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


def random_flax_params(arch, num_classes: int, size: int, seed: int = 0,
                       conv_gain: float = 2.0):
    """(flax model, params as nested dicts of float32 numpy arrays).
    ``arch`` is a registry name or a flax module (StarDist's U-Net, which
    the registry does not hold). ``conv_gain`` is the conv kernels' variance
    times their fan-in (1/3 is torch's default init, which keeps a deep net
    without working batch norm from growing)."""
    model = create_model(arch, num_classes) if isinstance(arch, str) else arch
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for name, leaf in tree.items():
            if not hasattr(leaf, "shape"):  # a submodule (HoVer-Net nests them)
                out[name] = fill(leaf)
                continue
            shape = leaf.shape
            if name == "kernel":
                gain = conv_gain if len(shape) == 4 else 1.0
                value = rng.standard_normal(shape) * np.sqrt(gain / np.prod(shape[:-1]))
            elif name in ("weight", "running_var"):  # batch norm: positive
                value = rng.random(shape) + 0.5
            else:  # bias, running_mean
                value = rng.standard_normal(shape) * 0.1
            out[name] = value.astype(np.float32)
        return out

    return model, fill(shapes["params"])
