"""Triton kernels of K6, the fused CG update (see ``cg.py``, which
imports this module only at the first launch on a CUDA tensor)."""

import triton
import triton.language as tl

@triton.jit
def xr_kernel(p_ptr, ap_ptr, x_ptr, r_ptr, rz_ptr, act_ptr,
              pap_ptr, rn_ptr, n, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    base = row.to(tl.int64) * n
    offs0 = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=p_ptr.dtype.element_ty)
    for start in range(0, n, BLOCK):
        offs = start + offs0
        m = offs < n
        p = tl.load(p_ptr + base + offs, mask=m, other=0.0)
        ap = tl.load(ap_ptr + base + offs, mask=m, other=0.0)
        acc += p * ap
    pap = tl.sum(acc, axis=0)
    rz = tl.load(rz_ptr + row)
    active = tl.load(act_ptr + row) != 0
    pos = pap > 0
    alpha = tl.where(pos, rz / tl.where(pos, pap, 1.0), 0.0)
    acc2 = tl.zeros([BLOCK], dtype=p_ptr.dtype.element_ty)
    for start in range(0, n, BLOCK):
        offs = start + offs0
        m = offs < n
        p = tl.load(p_ptr + base + offs, mask=m, other=0.0)
        ap = tl.load(ap_ptr + base + offs, mask=m, other=0.0)
        x = tl.load(x_ptr + base + offs, mask=m, other=0.0)
        r = tl.load(r_ptr + base + offs, mask=m, other=0.0)
        r_new = r - alpha * ap
        acc2 += r_new * r_new
        tl.store(x_ptr + base + offs, x + alpha * p, mask=m & active)
        tl.store(r_ptr + base + offs, r_new, mask=m & active)
    tl.store(pap_ptr + row, pap)
    tl.store(rn_ptr + row, tl.sqrt(tl.sum(acc2, axis=0)))

@triton.jit
def p_kernel(r_ptr, z_ptr, p_ptr, rz_ptr, act_ptr, it_ptr, pap_ptr,
             rn_ptr, tol_ptr, n, BLOCK: tl.constexpr):
    row = tl.program_id(0)
    base = row.to(tl.int64) * n
    offs0 = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=p_ptr.dtype.element_ty)
    for start in range(0, n, BLOCK):
        offs = start + offs0
        m = offs < n
        r = tl.load(r_ptr + base + offs, mask=m, other=0.0)
        z = tl.load(z_ptr + base + offs, mask=m, other=0.0)
        acc += r * z
    rz_new = tl.sum(acc, axis=0)
    rz = tl.load(rz_ptr + row)
    beta = rz_new / tl.where(rz != 0, rz, 1.0)
    active = tl.load(act_ptr + row) != 0
    for start in range(0, n, BLOCK):
        offs = start + offs0
        m = offs < n
        z = tl.load(z_ptr + base + offs, mask=m, other=0.0)
        p = tl.load(p_ptr + base + offs, mask=m, other=0.0)
        tl.store(p_ptr + base + offs, z + beta * p, mask=m & active)
    tl.store(rz_ptr + row, tl.where(active, rz_new, rz))
    tol = tl.load(tol_ptr)
    still = active & (tl.load(rn_ptr + row) >= tol) & (
        tl.load(pap_ptr + row) > 0)
    tl.store(it_ptr + row,
             tl.load(it_ptr + row) + active.to(tl.int32))
    tl.store(act_ptr + row, still.to(tl.int32))
