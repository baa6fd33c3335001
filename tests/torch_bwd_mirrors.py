"""numpy mirrors of the work plans and walks of two of the port's CUDA
kernels, which run only on the card: K1's backward
(runlmc_tpu_torch/hopper/csrc/kuu_dense_bwd.cu: the tile walk over the
host plan's band items, then the second pass over offsets and (d, e)
blocks) and K7's backward (csrc/cross_kernel_bwd.cu: the tile pairs of
one point set, each unordered pair once, then the finishing pass). The
tests hold them against the plain versions; they follow the kernels'
index arithmetic and the order of their cross-thread sums."""

import numpy as np

from runlmc_tpu_torch.hopper import cross, kuu

# the second pass's CTA shape (kR, kDe in csrc/kuu_dense_bwd.cu)
KUU_R, KUU_DE = kuu._R, 32


def kern_grads(kind, d2, gamma, period):
    """common.cuh ``kern_grads`` (RBF and Identity from d2 = r^2, as K7's
    backward takes them): (k~, dk~/dgamma, dk~/dperiod)."""
    r = np.sqrt(d2)
    z = np.zeros_like(r)
    if kind == 0:
        k = np.exp(-0.5 * d2 * gamma)
        return k, -0.5 * d2 * k, z
    if kind == 1:
        s = r * (np.sqrt(3.0) * gamma)
        e = np.exp(-s)
        return (1 + s) * e, -(np.sqrt(3.0) * r) * s * e, z
    if kind == 2:
        arg = (np.pi / period) * r
        s = np.sin(arg)
        k = np.exp(-0.5 * s * s * gamma)
        return (k, -0.5 * s * s * k,
                gamma * s * np.cos(arg) * (np.pi * r / (period * period)) * k)
    return (d2 == 0).astype(float), z, z


def butterfly(vals):
    """The lane-0 result of a warp's xor-shuffle butterfly (offsets 16,
    8, 4, 2, 1) over 32 lane values."""
    v = np.array(vals, dtype=float)
    for off in (16, 8, 4, 2, 1):
        v = v + v[np.arange(32) ^ off]
    return v[0]


def kuu_tile_walk(G, D, m, sizes, band=None):
    """K1 backward's stage 1: (D*D, nitems, SLOTS) partial slots. Per
    (d, e) and item, lane k takes row ii of each tile at column
    (ii + k) mod T (loaded by lane (ii + k) mod T, handed over by a
    shuffle) and adds it to its diagonal-k sum (ii + k < T) or its
    diagonal-(k - T) sum, tiles in the item's order, rows in order.
    ``band`` defaults to the wrapper's, ``kuu.band_for``."""
    n0, n1, N2 = kuu._sizes_inner(sizes)
    tile = min(kuu.TILE, N2)
    nbk = -(-N2 // tile)
    items = kuu.bwd_items(sizes, band or kuu.band_for(sizes, D))
    part = np.zeros((D * D, len(items), kuu.SLOTS))
    ii, k = np.meshgrid(np.arange(tile), np.arange(tile), indexing="ij")
    cc = (ii + k) % tile
    hi = ii + k < tile
    for de in range(D * D):
        d, e = divmod(de, D)
        blk = G[d * m:(d + 1) * m, e * m:(e + 1) * m]
        for it, (s0, s1, kb, start, count) in enumerate(items):
            a1, a2 = n1 - abs(s1), nbk - abs(kb)
            acc_hi, acc_lo = np.zeros(tile), np.zeros(tile)
            for u in range(start, start + count):
                u2, u1, u0 = u % a2, (u // a2) % a1, u // (a2 * a1)
                i0, i1 = u0 + max(0, -s0), u1 + max(0, -s1)
                bi = u2 + max(0, -kb)
                rb = (i0 * n1 + i1) * N2 + bi * tile
                cb = ((i0 + s0) * n1 + i1 + s1) * N2 + (bi + kb) * tile
                rl = min(tile, N2 - bi * tile)
                cl = min(tile, N2 - (bi + kb) * tile)
                ok = (ii < rl) & (cc < cl)
                v = np.where(ok, blk[np.minimum(rb + ii, m - 1),
                                     np.minimum(cb + cc, m - 1)], 0.0)
                for row in range(tile):  # the lane's rows in order
                    acc_hi += np.where(hi[row], v[row], 0.0)
                    acc_lo += np.where(hi[row], 0.0, v[row])
            part[de, it, :tile] = acc_hi
            part[de, it, kuu.TILE:kuu.TILE + tile] = acc_lo
    return part


def sum4(terms):
    """The kernels' ``sum4``: term t into running sum t mod 4, then
    (s0 + s1) + (s2 + s3)."""
    s = [0.0] * 4
    for t, v in enumerate(terms):
        s[t % 4] += v
    return (s[0] + s[1]) + (s[2] + s[3])


def kuu_offset_sums(part, D, m, sizes, band=None):
    """H (D, D, m) from stage 1's slots through the plan's CSR over
    offsets, each offset's slots in list order (``sum4``)."""
    _, optr, oent = kuu.bwd_plan(sizes, band or kuu.band_for(sizes, D))
    flat = part.reshape(D * D, -1)
    H = np.zeros((D, D, m))
    for de in range(D * D):
        for o in range(m):
            H[de // D, de % D, o] = sum4(flat[de, oent[optr[o]:optr[o + 1]]])
    return H


def kuu_reduce(kinds, prm, dists, B, H):
    """K1 backward's second pass from the offset sums H: per CTA (KUU_R
    offsets, KUU_DE blocks) the sums over its offsets in order, then the
    CTAs' sums (``sum4`` in CTA order), d B, and d prm by a warp per q
    (lanes striding over (d, e), then the butterfly)."""
    Q, D = B.shape[0], B.shape[1]
    m, dd = len(dists), B.shape[1] ** 2
    kg = np.stack([np.stack(kern_grads(kd, np.asarray(dists) ** 2, g, p))
                   for kd, (g, p, _) in zip(kinds, prm)])  # (Q, 3, m)
    Hf = H.reshape(dd, m)
    noc = -(-m // KUU_R)
    spart = np.zeros((noc, Q, 3, dd))
    for c in range(noc):
        for de in range(dd):
            for q in range(Q):
                for kk in range(3):
                    s = 0.0
                    for o in range(c * KUU_R, min(m, c * KUU_R + KUU_R)):
                        s += Hf[de, o] * kg[q, kk, o]
                    spart[c, q, kk, de] = s
    S = np.zeros((Q, 3, dd))
    for i in np.ndindex(Q, 3, dd):
        S[i] = sum4(spart[(slice(None),) + i])
    dB = prm[:, 2, None] * S[:, 0]
    dprm = np.zeros((Q, 3))
    for q in range(Q):
        lanes = np.zeros((3, 32))
        for de in range(dd):
            lanes[:, de % 32] += B.reshape(Q, dd)[q, de] * S[q, :, de]
        a = [butterfly(lanes[i]) for i in range(3)]
        dprm[q] = (prm[q, 2] * a[1], prm[q, 2] * a[2], a[0])
    return dprm, dB.reshape(Q, D, D)


def k7_pair_walk(x, o, B, kinds, masks, prm, G, alpha=None, pair=True):
    """K7 backward on inputs sorted by output (one point set ``x``, ``o``
    for rows and columns): the plan's tile pairs (I >= J on the pair
    path), each element's k~_q and derivatives once for G[a, b] (slot 2p)
    and, on the pair path, G[b, a] (slot 2p + 1; a diagonal tile takes a
    > b for both and a = b for the first only), then per (d, e, q) the
    listed slots in order and the four small products. Returns
    ``(dB, dprm, visits)``: ``visits`` counts each element of G."""
    Q, D = B.shape[0], B.shape[1]
    counts = tuple(int(c) for c in np.bincount(o, minlength=D))
    ta, tb, pairs, ptr, idx = cross.bwd_plan(counts, counts, pair)
    Gm = G - np.outer(alpha, alpha) if alpha is not None else G
    part = np.zeros((2 * len(pairs), Q, 3))
    visits = np.zeros(G.shape, dtype=int)
    for p, (I, J) in enumerate(pairs):
        r0, rl, _ = ta[I]
        c0, cl, _ = tb[J]
        rows, cols = np.arange(r0, r0 + rl), np.arange(c0, c0 + cl)
        w1 = np.ones((rl, cl), dtype=bool)
        w2 = np.full((rl, cl), pair)
        if pair and I == J:
            w1 = rows[:, None] >= cols[None, :]
            w2 = rows[:, None] > cols[None, :]
        g1 = np.where(w1, Gm[np.ix_(rows, cols)], 0.0)
        g2 = np.where(w2, Gm[np.ix_(cols, rows)].T, 0.0)
        visits[np.ix_(rows, cols)] += w1
        visits[np.ix_(cols, rows)] += w2.T
        for q in range(Q):
            dims = [i for i in range(x.shape[1]) if (masks[q] >> i) & 1]
            diff = x[rows][:, None, dims] - x[cols][None, :, dims]
            kg = kern_grads(kinds[q], np.sum(diff * diff, -1), prm[q, 0],
                            prm[q, 1])
            part[2 * p, q] = [np.sum(g1 * f) for f in kg]
            part[2 * p + 1, q] = [np.sum(g2 * f) for f in kg]
    S = np.zeros((Q, 3, D * D))
    for de in range(D * D):
        for j in idx[ptr[de]:ptr[de + 1]]:
            S[:, :, de] += part[j]
    Bf = B.reshape(Q, D * D)
    dB = (prm[:, 2, None] * S[:, 0]).reshape(Q, D, D)
    dprm = np.stack([prm[:, 2] * np.sum(Bf * S[:, 1], 1),
                     prm[:, 2] * np.sum(Bf * S[:, 2], 1),
                     np.sum(Bf * S[:, 0], 1)], axis=1)
    return dB, dprm, visits
