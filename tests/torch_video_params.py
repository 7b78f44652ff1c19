"""Seeded flax parameter trees for the port's video tests.

A flax ``init`` of the video nets takes tens of seconds on the CPU and
zero-initialises every offset conv, which would leave the deformable
sampling on the grid. So the tree's structure and shapes come from the
flax module (``jax.eval_shape`` of its ``init``) and its values from
numpy: each conv kernel N(0, 1 / fan_in) (activations keep their scale
through the layers), each bias and 1-D weight N(0, 0.01) (0.1 with
``live_bias``)."""
import jax
import numpy as np


def random_params(module, inputs, seed, scale=1.0, kwargs=None):
    """``module.init``'s parameter tree with seeded numpy values."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.PRNGKey(0), *a, **(kwargs or {})),
        *inputs)['params']
    rng = np.random.RandomState(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        shape = node.shape
        if len(shape) >= 2:
            std = scale / np.sqrt(np.prod(shape[:-1]))
        else:
            std = 0.01
        return (rng.randn(*shape) * std).astype(np.float32)

    return fill(dict(shapes))
