"""Host-side numpy conveniences (parity: runlmc_tpu/utils/np_utils.py)."""

import numpy as np


def cartesian_product(*arrays):
    """Cartesian product of 1-D arrays; row-major (last array fastest)."""
    grids = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)
