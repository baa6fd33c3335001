"""Host-side numpy conveniences (parity: runlmc_tpu/utils/np_utils.py).

They run on the host at model construction, never on the card.
"""

import numpy as np


def begin_end_indices(lens):
    """Begin/end index pairs for contiguous segments of the given
    lengths."""
    ends = np.cumsum(lens)
    begins = np.roll(ends, 1)
    if len(begins):
        begins[0] = 0
    return begins, ends


def tesselate(flat, lens):
    """Split a flat array into consecutive ragged segments of lengths
    ``lens``."""
    lens = np.asarray(lens)
    if lens.sum() != len(flat):
        raise ValueError(
            "lengths {} sum to {} != len(flat) {}".format(
                lens, lens.sum(), len(flat)
            )
        )
    return np.split(np.asarray(flat), np.cumsum(lens)[:-1])


def chunks(array, size):
    """Split ``array`` into consecutive chunks of length ``size``."""
    if len(array) % size:
        raise ValueError("len {} not divisible by {}".format(len(array), size))
    return [array[i:i + size] for i in range(0, len(array), size)]


def cartesian_product(*arrays):
    """Cartesian product of 1-D arrays; row-major (last array fastest)."""
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def search_descending(x, xs, inclusive=True):
    """Number of leading entries of descending ``xs`` that are > x (or
    >= x with ``inclusive``)."""
    xs = np.asarray(xs)
    if len(xs) and np.any(np.diff(xs) > 0):
        raise ValueError("expected descending array")
    side = "right" if inclusive else "left"
    return int(np.searchsorted(-xs, -x, side=side))


def smallest_eig(sym):
    """Smallest eigenvalue of a symmetric matrix (host-side, LAPACK)."""
    return float(np.linalg.eigvalsh(sym)[0])


def symm_2d_list_map(f, xs, d, *args):
    """Map ``f`` over a d x d array of items, exploiting symmetry:
    computes f on the upper triangle and mirrors the result."""
    out = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i, d):
            out[i][j] = f(xs[i][j], *args)
            out[j][i] = out[i][j]
    return out
