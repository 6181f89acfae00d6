"""Parameter trees between the JAX package's layout and the port's.

Both packages keep parameters as nested dicts with the same keys and the
same einsum layouts, so a JAX tree carries over leaf by leaf. The port
never imports JAX: the caller turns JAX arrays into numpy first (for
example ``jax.tree_util.tree_map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> leaf tensors on ``device`` that
    require grad, with the same keys, shapes and dtypes."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True)).to(device)
        return t.requires_grad_(t.is_floating_point())
    return tree_map(leaf, tree)


def params_to_numpy(tree):
    """The reverse of :func:`params_from_numpy`: nested dicts of numpy."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
