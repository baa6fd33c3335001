"""Triton kernel of K12, the fused MINRES iteration (see ``minres.py``,
which imports this module only at the first launch on a CUDA tensor)."""

import triton
import triton.language as tl


@triton.jit
def minres_kernel(w_ptr, x_ptr, v_ptr, vp_ptr, d_ptr, dp_ptr, beta_ptr,
                  c_ptr, s_ptr, cp_ptr, sp_ptr, phi_ptr, act_ptr, it_ptr,
                  tol_ptr, n, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    base = row.to(tl.int64) * n
    offs0 = tl.arange(0, BLOCK)
    beta = tl.load(beta_ptr + row)
    # sweep 1: w -= beta v_prev (kept in w), alpha = <v, w>
    acc = tl.zeros([BLOCK], dtype=w_ptr.dtype.element_ty)
    for start in range(0, n, BLOCK):
        offs = start + offs0
        m = offs < n
        w = tl.load(w_ptr + base + offs, mask=m, other=0.0)
        vp = tl.load(vp_ptr + base + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + base + offs, mask=m, other=0.0)
        w1 = w - beta * vp
        acc += v * w1
        tl.store(w_ptr + base + offs, w1, mask=m)
    alpha = tl.sum(acc, axis=0)
    # sweep 2: beta' = ||w - alpha v||
    acc2 = tl.zeros([BLOCK], dtype=w_ptr.dtype.element_ty)
    for start in range(0, n, BLOCK):
        offs = start + offs0
        m = offs < n
        w1 = tl.load(w_ptr + base + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + base + offs, mask=m, other=0.0)
        w2 = w1 - alpha * v
        acc2 += w2 * w2
    beta_next = tl.sqrt(tl.sum(acc2, axis=0))
    # the Givens rotation of this row
    c = tl.load(c_ptr + row)
    s = tl.load(s_ptr + row)
    c_prev = tl.load(cp_ptr + row)
    s_prev = tl.load(sp_ptr + row)
    phi_bar = tl.load(phi_ptr + row)
    active = tl.load(act_ptr + row) != 0
    safe_bn = tl.where(beta_next > 0, beta_next, 1.0)
    eps = s_prev * beta
    delta = c_prev * beta
    delta2 = c * delta + s * alpha
    gamma_t = -s * delta + c * alpha
    gamma = tl.sqrt(gamma_t * gamma_t + beta_next * beta_next)
    pos = gamma > 0
    safe_gamma = tl.where(pos, gamma, 1.0)
    c_new = tl.where(pos, gamma_t / safe_gamma, 1.0)
    s_new = tl.where(pos, beta_next / safe_gamma, 0.0)
    tau = c_new * phi_bar
    phi_bar_new = -s_new * phi_bar
    # sweep 3: the masked vector updates
    for start in range(0, n, BLOCK):
        offs = start + offs0
        m = offs < n
        w1 = tl.load(w_ptr + base + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + base + offs, mask=m, other=0.0)
        d = tl.load(d_ptr + base + offs, mask=m, other=0.0)
        dp = tl.load(dp_ptr + base + offs, mask=m, other=0.0)
        x = tl.load(x_ptr + base + offs, mask=m, other=0.0)
        w2 = w1 - alpha * v
        d_new = (v - delta2 * d - eps * dp) / safe_gamma
        mu = m & active
        tl.store(x_ptr + base + offs, x + tau * d_new, mask=mu)
        tl.store(v_ptr + base + offs, w2 / safe_bn, mask=mu)
        tl.store(vp_ptr + base + offs, v, mask=mu)
        tl.store(d_ptr + base + offs, d_new, mask=mu)
        tl.store(dp_ptr + base + offs, d, mask=mu)
    tl.store(beta_ptr + row, tl.where(active, beta_next, beta))
    tl.store(c_ptr + row, tl.where(active, c_new, c))
    tl.store(s_ptr + row, tl.where(active, s_new, s))
    tl.store(cp_ptr + row, tl.where(active, c, c_prev))
    tl.store(sp_ptr + row, tl.where(active, s, s_prev))
    tl.store(phi_ptr + row, tl.where(active, phi_bar_new, phi_bar))
    tol = tl.load(tol_ptr)
    still = active & (tl.abs(phi_bar_new) >= tol) & pos
    tl.store(it_ptr + row, tl.load(it_ptr + row) + active.to(tl.int32))
    tl.store(act_ptr + row, still.to(tl.int32))
