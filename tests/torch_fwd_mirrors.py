"""numpy mirrors of the walks of two of the port's forward CUDA kernels,
which run only on the card: K1 (runlmc_tpu_torch/hopper/csrc/
kuu_dense.cu: the fold over q per (d, e, offset), then the write pass's
ranges of rows, (row, vector) walk, row heads and tails, the doubled row
of a 1-D grid and the coordinates of a 2-D or 3-D one) and K7 (csrc/
cross_kernel.cu: the pair path's tile pairs I >= J with the transposed
write, and the general path). The tests hold them against the plain
versions; they follow the kernels' index arithmetic and the order of
their sums (the FMAs as a product and a sum)."""

import numpy as np

from runlmc_tpu_torch.hopper import cross

# csrc/kuu_dense.cu kThreads; csrc/cross_kernel.cu kMaxQ
KUU_THREADS = 256
K7_MAX_Q = 8


def kern_eval(kind, r, gamma, period):
    """common.cuh ``kern_eval``: k~(r) of a table row."""
    if kind == 0:
        return np.exp(-0.5 * (r * r) * gamma)
    if kind == 1:
        s = r * (1.7320508075688772 * gamma)
        return (1.0 + s) * np.exp(-s)
    if kind == 2:
        s = np.sin((3.141592653589793 / period) * r)
        return np.exp(-0.5 * (s * s) * gamma)
    return (r == 0).astype(r.dtype)


def fast_div(d):
    """kuu_dense.cu ``fast_div``: (mul, shift) of the round-up method."""
    if d <= 1:
        return 0, 0
    ell = 0
    while (1 << ell) < d:
        ell += 1
    return ((1 << (31 + ell)) + d - 1) // d, ell - 1


def div_by(n, f):
    """kuu_dense.cu ``div_by``: n // d for 0 <= n < 2^31 by a multiply-high
    (``__umulhi``) and a shift."""
    mul, shift = f
    n = np.asarray(n, dtype=np.int64)
    if mul == 0:
        return n
    hi = (n.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32)
    return (hi >> np.uint64(shift)).astype(np.int64)


def kuu_fold(kinds, prm, dists, B):
    """c (D * D, m): c[d * D + e, o] = sum over q, in q order, of
    B[q, d, e] * (scale_q * k~_q(dists[o]))."""
    Q, D = B.shape[0], B.shape[1]
    c = np.zeros((D * D, len(dists)), dtype=B.dtype)
    for q in range(Q):
        t = prm[q, 2] * kern_eval(kinds[q], dists, prm[q, 0], prm[q, 1])
        c = B[q].reshape(-1, 1) * t[None, :] + c
    return c


def inner_last(sizes):
    """The launch's (n0, n1, n2): trailing ones moved to the front, so that
    the innermost (stride 1) axis is last."""
    n = list(sizes) + [1] * (3 - len(sizes))
    for _ in range(2):
        if n[2] == 1:
            n = [1, n[0], n[1]]
    return tuple(n)


def kuu_ranges(m, D, ctas):
    """The launch's CTAs' ranges of block rows (block de's row i is block
    row de * m + i) with ``ctas`` resident CTAs: one contiguous range a
    CTA, lengths within one of each other."""
    total = D * D * m
    g = min(total, ctas)
    per, rem = divmod(total, g)
    first = [per * c + min(c, rem) for c in range(g)]
    return [(f, f + per + (c < rem)) for c, f in enumerate(first)]


def kuu_write(c, D, sizes, V, ctas, one_d=None):
    """K_UU (D*m, D*m) as kuu_write_kernel writes it from the folded rows
    ``c`` with V elements a 16-byte vector, and the number of times each
    element is stored. ``one_d`` (default: the grid is 1-D) selects the
    doubled row, else c is read element by element; shared memory the
    kernel never fills reads NaN."""
    m = c.shape[1]
    n0, n1, n2 = inner_last(sizes)
    if one_d is None:
        one_d = n0 == 1 and n1 == 1
    dm = D * m
    out = np.full(dm * dm, np.nan)
    count = np.zeros(dm * dm, dtype=int)
    o = np.arange(m)
    for first, last in kuu_ranges(m, D, ctas):
        r0 = first
        while r0 < last:
            de = r0 // m
            i_begin = r0 - de * m
            nrows = min(last - r0, m - i_begin)
            d, e = divmod(de, D)
            r0 += nrows
            if one_d:
                sm = np.full(2 * m + 4 * V, np.nan)
                sm[V + m - 1 - o] = c[de]
                sm[V + m - 1 + o] = c[de]
            else:
                sm = np.full(m + V, np.nan)
                sm[:m] = c[de]
            _write_rows(out, count, sm, d, e, i_begin, nrows, m, D, V, one_d,
                        (n1, n2))
    return out.reshape(dm, dm), count.reshape(dm, dm)


def _write_rows(out, count, sm, d, e, i_begin, nrows, m, D, V, one_d,
                grid):
    """One CTA's walk over rows [i_begin, i_begin + nrows) of block
    (d, e)."""
    dm = D * m
    nv = (m + 2 * V - 2) // V
    if one_d:
        _write_rows_1d(out, count, sm, d, e, i_begin, nrows, m, dm, V, nv)
    else:
        _write_rows_gather(out, count, sm, d, e, i_begin, nrows, m, dm, V,
                           nv, grid)


def _store(out, count, dst, j0, vals, m, V):
    """A vector's 16-byte store where it lies inside the segment, else
    its elements that do (the head and the tail)."""
    assert np.all(dst % V == 0)  # a 16-byte store's alignment
    for u in range(V):
        j = j0 + u
        ok = (j >= 0) & (j < m)
        out[dst[ok] + u] = vals[ok, u]
        np.add.at(count, dst[ok] + u, 1)


def _write_rows_1d(out, count, sm, d, e, i_begin, nrows, m, dm, V, nv):
    """A 1-D grid: a row a slot of G threads (lane k takes vectors k,
    k + G, ...), the row's values two 16-byte words of the doubled row a
    vector, taken S = base mod V elements into the first."""
    G = 32
    while G < nv and G < KUU_THREADS:
        G *= 2
    for row in range(nrows):  # slot row % (KUU_THREADS // G)
        i = i_begin + row
        start = (d * m + i) * dm + e * m
        phi = start & (V - 1)
        base = V + m - 1 - i - phi
        assert base >= 1
        S, w0 = base & (V - 1), base // V
        lanes = np.arange(G)
        for k in (lanes + G * t for t in range(-(-nv // G))):
            k = k[k < nv]
            idx = (w0 + k)[:, None] * V + S + np.arange(V)
            assert idx.max() < len(sm) and (w0 + k + 2).max() * V <= len(sm)
            _store(out, count, start - phi + k * V, k * V - phi, sm[idx], m,
                   V)


def _write_rows_gather(out, count, sm, d, e, i_begin, nrows, m, dm, V, nv,
                       grid):
    """Any grid: (row, vector) pairs stepped by the CTA's width, each
    value read at its offset, the column stepped by one."""
    n1, n2 = grid
    s0 = n1 * n2
    step_rows, step_k = divmod(KUU_THREADS, nv)
    f1, f2 = fast_div(n1), fast_div(n2)
    tid = np.arange(KUU_THREADS)
    row, k = tid // nv, tid % nv
    while np.any(row < nrows):
        act = row < nrows
        i, kk = i_begin + row[act], k[act]
        start = (d * m + i) * dm + e * m
        phi = start & (V - 1)
        j0 = kk * V - phi
        io = div_by(i, f2)
        i2 = i - io * n2
        i0 = div_by(io, f1)
        i1 = io - i0 * n1
        jc = np.maximum(j0, 0)
        jo = div_by(jc, f2)
        c2 = jc - jo * n2
        c0 = div_by(jo, f1)
        c1 = jo - c0 * n1
        vals = np.empty((len(i), V))
        for u in range(V):
            off = (np.abs(i0 - c0) * s0 + np.abs(i1 - c1) * n2
                   + np.abs(i2 - c2))
            vals[:, u] = sm[np.minimum(off, m - 1)]
            c2 = c2 + (j0 + u >= 0)
            wrap = c2 == n2
            c2 = np.where(wrap, 0, c2)
            c1 = c1 + wrap
            wrap = c1 == n1
            c1 = np.where(wrap, 0, c1)
            c0 = c0 + wrap
        _store(out, count, start - phi + kk * V, j0, vals, m, V)
        row = row + step_rows
        k = k + step_k
        wrap = k >= nv
        k = np.where(wrap, k - nv, k)
        row = row + wrap


def k7_table_passes(kinds, masks):
    """Per q the first kernel of its pass (kMaxQ kernels, or all of them
    when fewer) on the same mask, and whether that mask needs r there;
    and whether the table is RBF only on one mask."""
    Q = len(kinds)
    nq = min(Q, K7_MAX_Q)
    first, needr = [], []
    for q in range(Q):
        q0 = q - q % nq
        same = [g for g in range(q0, min(Q, q0 + nq))
                if masks[g] == masks[q]]
        first.append(min(same))
        needr.append(any(kinds[g] in (1, 2) for g in same))
    one_rbf = all(k == 0 for k in kinds) and len(set(masks)) == 1
    return first, needr, one_rbf


def k7_values(kinds, masks, prm, xa, xb, P):
    """k~_q (Q, na, nb) from the squared distance over each mask's dims
    (summed in dim order, each distinct mask once a pass), RBF from d2,
    r = sqrt(d2) only where a kernel of the mask needs it."""
    first, needr, one_rbf = k7_table_passes(kinds, masks)
    out = []
    d2s = {}
    for q, (kind, mk) in enumerate(zip(kinds, masks)):
        if one_rbf or first[q] == q:
            d2 = np.zeros((xa.shape[0], xb.shape[0]))
            for p in range(P):
                if (mk >> p) & 1:
                    df = xa[:, None, p] - xb[None, :, p]
                    d2 = d2 + df * df
            d2s[mk] = (d2, np.sqrt(d2) if needr[q] else None)
        d2, r = d2s[mk]
        g, per = prm[q, 0], prm[q, 1]
        if kind == 0:
            out.append(np.exp(-0.5 * d2 * g))
        elif kind in (1, 2):
            out.append(kern_eval(kind, r, g, per))
        else:
            out.append((d2 == 0).astype(float))
    return out


def k7_general(xa, oa, xb, ob, B, kinds, masks, prm):
    """K7's general path: every element, B[q, oa[a], ob[b]] * scale_q and
    k~_q summed in q order."""
    P = xa.shape[1]
    kt = k7_values(kinds, masks, prm, xa, xb, P)
    acc = np.zeros((len(xa), len(xb)))
    for q in range(len(kinds)):
        bs = B[q][np.ix_(oa, ob)] * prm[q, 2]
        acc = bs * kt[q] + acc
    return acc


def k7_pair(x, o, B, kinds, masks, prm):
    """K7's pair path on one point set sorted by output: the tile pairs
    I >= J of the plan, each pair's k~_q once for K[a, b] (with B[q, out
    I, out J] * scale_q) and K[b, a] (with B[q, out J, out I] * scale_q,
    through the transposed tile); a diagonal tile writes a >= b directly
    and a > b transposed. Returns ``(K, visits)``."""
    D, P = B.shape[1], x.shape[1]
    counts = tuple(int(c) for c in np.bincount(o, minlength=D))
    ta, _, pairs, _, _ = cross.bwd_plan(counts, counts, True)
    n = len(x)
    K = np.full((n, n), np.nan)
    visits = np.zeros((n, n), dtype=int)
    for I, J in pairs:
        r0, rl, dI = ta[I]
        c0, cl, dJ = ta[J]
        rows, cols = np.arange(r0, r0 + rl), np.arange(c0, c0 + cl)
        kt = k7_values(kinds, masks, prm, x[rows], x[cols], P)
        acc1 = np.zeros((rl, cl))
        acc2 = np.zeros((rl, cl))
        for q in range(len(kinds)):
            acc1 = (B[q, dI, dJ] * prm[q, 2]) * kt[q] + acc1
            acc2 = (B[q, dJ, dI] * prm[q, 2]) * kt[q] + acc2
        lower = rows[:, None] >= cols[None, :]
        w1 = lower if I == J else np.ones((rl, cl), dtype=bool)
        w2 = (rows[:, None] > cols[None, :]) if I == J else w1
        blk = K[np.ix_(rows, cols)]
        K[np.ix_(rows, cols)] = np.where(w1, acc1, blk)
        visits[np.ix_(rows, cols)] += w1
        blk = K[np.ix_(cols, rows)]
        K[np.ix_(cols, rows)] = np.where(w2.T, acc2.T, blk)
        visits[np.ix_(cols, rows)] += w2.T
    return K, visits
