"""Triton kernels of K13, one Lanczos step split over row blocks (see
``lanczos.py``, which imports this module only at the first launch on a
CUDA tensor).

Each kernel runs a (B, n_blocks) grid; a row's partial sums go to a
(B, n_blocks) buffer that the next kernel reduces in one fixed-shape
``tl.sum``, so every program of a row reads the same scalar and the
result is the same on every run.
"""

import triton
import triton.language as tl


@triton.jit
def lanczos_dot_kernel(w_ptr, vp_ptr, v_ptr, beta_ptr, apart_ptr, n, nblk,
                       BLOCK: tl.constexpr):
    """w -= beta v_prev (kept in w); apart[row, blk] = <w, v> over the
    block."""
    row = tl.program_id(0)
    blk = tl.program_id(1)
    base = row.to(tl.int64) * n
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    beta = tl.load(beta_ptr + row)
    w = tl.load(w_ptr + base + offs, mask=m, other=0.0)
    vp = tl.load(vp_ptr + base + offs, mask=m, other=0.0)
    v = tl.load(v_ptr + base + offs, mask=m, other=0.0)
    w1 = w - beta * vp
    tl.store(w_ptr + base + offs, w1, mask=m)
    tl.store(apart_ptr + row * nblk + blk, tl.sum(w1 * v, axis=0))


@triton.jit
def lanczos_norm_kernel(w_ptr, v_ptr, apart_ptr, bpart_ptr, n, nblk,
                        BLOCK: tl.constexpr, NB: tl.constexpr):
    """alpha = sum of the row's partials; w -= alpha v (kept in w);
    bpart[row, blk] = ||w||^2 over the block."""
    row = tl.program_id(0)
    blk = tl.program_id(1)
    base = row.to(tl.int64) * n
    poffs = tl.arange(0, NB)
    alpha = tl.sum(tl.load(apart_ptr + row * nblk + poffs,
                           mask=poffs < nblk, other=0.0), axis=0)
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    w = tl.load(w_ptr + base + offs, mask=m, other=0.0)
    v = tl.load(v_ptr + base + offs, mask=m, other=0.0)
    w2 = w - alpha * v
    tl.store(w_ptr + base + offs, w2, mask=m)
    tl.store(bpart_ptr + row * nblk + blk, tl.sum(w2 * w2, axis=0))


@triton.jit
def lanczos_next_kernel(w_ptr, out_ptr, apart_ptr, bpart_ptr, alive_ptr,
                        alive_out_ptr, alpha_out_ptr, beta_out_ptr, eps_ptr,
                        n, nblk, BLOCK: tl.constexpr, NB: tl.constexpr):
    """beta' = sqrt(sum of the row's partials), the breakdown mask, and
    v' = w / beta' on live rows (0 after a breakdown) into ``out``; the
    first block of a row writes its scalars."""
    row = tl.program_id(0)
    blk = tl.program_id(1)
    base = row.to(tl.int64) * n
    poffs = tl.arange(0, NB)
    pm = poffs < nblk
    alpha = tl.sum(tl.load(apart_ptr + row * nblk + poffs, mask=pm,
                           other=0.0), axis=0)
    beta_n = tl.sqrt(tl.sum(tl.load(bpart_ptr + row * nblk + poffs, mask=pm,
                                    other=0.0), axis=0))
    alive = tl.load(alive_ptr + row) != 0
    alive_n = alive & (beta_n > tl.load(eps_ptr))
    safe = tl.where(beta_n > 0, beta_n, 1.0)
    offs = blk * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    w = tl.load(w_ptr + base + offs, mask=m, other=0.0)
    v_next = tl.where(alive_n, w / safe, 0.0)
    tl.store(out_ptr + base + offs, v_next, mask=m)
    if blk == 0:
        tl.store(alive_out_ptr + row, alive_n.to(tl.int32))
        tl.store(alpha_out_ptr + row, tl.where(alive, alpha, 1.0))
        tl.store(beta_out_ptr + row, tl.where(alive_n, beta_n, 0.0))
