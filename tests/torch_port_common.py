"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Everything random comes from ``np.random.default_rng(seed)`` and is handed
to both packages as numpy, so the JAX reference and the port see the same
numbers.
"""

from __future__ import annotations

import numpy as np
import torch

# Two intra-op threads a process.  The suite runs six pytest-xdist workers on
# the CPU, each importing this module when it collects the tests; at torch's
# default of one OpenMP thread a core their pools oversubscribe the cores, and
# the port's files took about three times as long.
torch.set_num_threads(2)


def random_variables(model, x_shape, seed: int = 0, obj_bias: float = 0.0, no: int = 9):
    """Numpy ``{'params', 'batch_stats'}`` tree for the flax ``model``: He-normal
    kernels, small conv biases, non-trivial BatchNorm affine and running
    stats, and the Detect objectness biases (column 4 of each anchor's ``no``
    outputs) set to ``obj_bias`` so that random weights produce detections
    above ``conf_thres``.  Shapes come from ``jax.eval_shape`` (no compile)."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32), train=False))
    return random_tree(shapes, seed, obj_bias, no)


def random_tree(shapes, seed: int = 0, obj_bias: float = 0.0, no: int = 9):
    """Numpy leaves for a tree of shapes (``jax.eval_shape`` of an init), by
    the rules of ``random_variables``."""
    rng = np.random.default_rng(seed)

    def walk(node, path):
        if hasattr(node, "items"):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        shape = tuple(node.shape)
        leaf, parent = path[-1], path[-2] if len(path) > 1 else ""
        if leaf == "kernel":
            out = rng.standard_normal(shape) * np.sqrt(2.0 / int(np.prod(shape[:-1])))
        elif leaf == "scale":
            out = rng.uniform(0.8, 1.2, shape)
        elif leaf == "mean":
            out = rng.standard_normal(shape) * 0.1
        elif leaf == "var":
            out = rng.uniform(0.5, 1.5, shape)
        elif leaf == "bias" and parent.startswith("det"):
            out = (rng.standard_normal(shape) * 0.05).reshape(-1, no)
            out[:, 4] += obj_bias
        else:                                             # conv / BN biases
            out = rng.standard_normal(shape) * 0.05
        return np.asarray(out, np.float32).reshape(shape)

    return {k: walk(v, (k,)) for k, v in shapes.items()}
