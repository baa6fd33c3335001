"""A seeded mid-run state of K12 (the MINRES update, ``hopper/minres.py``)
for the CPU tests of its order of operations and the card tests of its
kernel. numpy and torch only, so that the card suite can import it."""

import numpy as np
import torch

NP = {torch.float32: np.float32, torch.float64: np.float64}


def minres_state(B, n, dtype, seed):
    """A mid-run MINRES state of a diagonal operator (and its diagonal),
    as CPU tensors in ``minres_update``'s argument order: w = diag * v,
    unit v orthogonal to a unit v_prev, Givens scalars on the unit
    circle, tol 0 (a row stops only where s' or gamma is 0). Where B > 1
    row 0 is inactive, where B > 2 row 1's v is an eigenvector with beta
    = 0 (beta' = 0), and where B > 3 row 2 also has c = s = 0 (gamma =
    0)."""
    rng = np.random.RandomState(seed)
    dt = NP[dtype]
    diag = rng.uniform(0.5, 1.5, n)
    v = rng.standard_normal((B, n))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    vp = rng.standard_normal((B, n))
    vp -= np.sum(vp * v, axis=1, keepdims=True) * v
    vp /= np.linalg.norm(vp, axis=1, keepdims=True)
    d, dp, x = (rng.standard_normal((B, n)) for _ in range(3))
    th = rng.uniform(0, 2 * np.pi, (2, B))
    beta = rng.uniform(0.1, 0.5, B)
    phi = rng.uniform(0.5, 2.0, B)
    c, s, cp, sp = np.cos(th[0]), np.sin(th[0]), np.cos(th[1]), np.sin(th[1])
    active = np.ones(B, np.int32)
    active[0] = 0 if B > 1 else 1
    for r in range(1, min(B, 3)):
        if B > r + 1:  # rows 1 (and 2): an eigenvector, beta 0
            v[r] = 0.0
            v[r, (7 * r) % n] = 1.0
            beta[r] = 0.0
    if B > 3:
        c[2] = s[2] = 0.0
    vecs = [v * diag] + [x, v, vp, d, dp]
    scal = [beta, c, s, cp, sp, phi]
    out = [torch.as_tensor(np.ascontiguousarray(a).astype(dt))
           for a in vecs + scal]
    out += [torch.as_tensor(active), torch.zeros(B, dtype=torch.int32),
            torch.zeros(1, dtype=dtype)]
    return out, torch.as_tensor(diag.astype(dt))
