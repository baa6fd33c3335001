"""Carrying parameters across from the JAX package.

The raw-parameter tree has the same nesting and keys in both packages
(``coreg_diags``, ``coreg_vecs``, ``kernels``, ``noise``), and the flat
``param_array`` has the same order: ``jax.flatten_util.ravel_pytree``
visits dict keys sorted as strings (so ``q10`` comes before ``q2``), and
:func:`ravel_params` does the same. A JAX model's ``param_array`` can
therefore be assigned to the port's ``InterpolatedLLGP.param_array``
as it is, and its raw-parameter tree, pulled to numpy, converts with
:func:`from_reference_params`.
"""

import numpy as np
import torch


def from_reference_params(raw_params_numpy, dtype, device):
    """Nested dict of numpy arrays (or anything ``np.asarray`` takes)
    -> the same nesting of tensors at ``dtype`` on ``device``."""
    if isinstance(raw_params_numpy, dict):
        return {
            k: from_reference_params(v, dtype, device)
            for k, v in raw_params_numpy.items()
        }
    return torch.as_tensor(
        np.asarray(raw_params_numpy), dtype=dtype, device=device
    )


def cast_params(tree, dtype):
    """The same tree with every leaf cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _leaves(tree):
    """(path, leaf) pairs in ``ravel_pytree`` order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in _leaves(tree[k]):
                yield (k,) + path, leaf
    else:
        yield (), tree


def ravel_params(params):
    """Flat 1-D tensor of every leaf, in ``ravel_pytree`` order."""
    return torch.cat([leaf.reshape(-1) for _, leaf in _leaves(params)])


def unravel_params(flat, like):
    """Inverse of :func:`ravel_params`: a tree shaped like ``like``
    whose leaves are consecutive slices of ``flat``, cast to each leaf's
    dtype and device."""
    out = {}
    off = 0
    for path, leaf in _leaves(like):
        size = leaf.numel()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = (
            flat[off: off + size]
            .reshape(leaf.shape)
            .to(dtype=leaf.dtype, device=leaf.device)
        )
        off += size
    if off != flat.numel():
        raise ValueError(
            "flat parameter vector has %d entries, expected %d"
            % (flat.numel(), off)
        )
    # keep the empty sub-dicts of the template (e.g. no lmc kernels)
    for k, v in like.items():
        if isinstance(v, dict) and k not in out:
            out[k] = {}
    return out
