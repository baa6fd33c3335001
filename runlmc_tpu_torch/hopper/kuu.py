"""K1: the dense LMC grid kernel K_UU of one active-dim group.

    K_UU[(d,i),(e,j)] = sum_q B_q[d,e] * tops_q[off(i,j)],
    off(i,j) = sum_p |i_p - j_p| * stride_p

Replaces runlmc_tpu/lmc/grid.py:537-547 (``build_group_state``, dense
branch: an index-map gather of a (Q, m, m) stack, then an einsum with
B). The CUDA kernel (``csrc/kuu_dense.cu``) works out each element's
BTTB offset from the two flat grid indices and reads no index map; it
is bound by its (Dm)^2 output write. :func:`kuu_dense_plain` is the
plain PyTorch version, which the wrapper runs for CPU tensors.
"""

import ctypes

import torch

from runlmc_tpu_torch.hopper import build
from runlmc_tpu_torch.ops.bttb import bttb_index_map


def _sizes3(sizes):
    sizes = tuple(int(s) for s in sizes)
    if not 1 <= len(sizes) <= 3:
        raise ValueError("kuu_dense takes grids of 1 to 3 dims, got %s"
                         % (sizes,))
    return sizes + (1,) * (3 - len(sizes))


def kuu_dense_plain(tops, B, sizes):
    """Plain version: gather the (Q, m, m) BTTB stack through the host
    index map and contract it with B, as the XLA code does."""
    Q, m = tops.shape
    D = B.shape[1]
    idx = torch.as_tensor(bttb_index_map(sizes), dtype=torch.int64,
                          device=tops.device)
    T = tops[:, idx]
    return torch.einsum("qde,qij->diej", B, T).reshape(D * m, D * m)


def kuu_dense(tops, B, sizes):
    """K_UU (D*m, D*m) from ``tops`` (Q, m) and ``B`` (Q, D, D) on a
    grid of ``sizes``; the CUDA kernel for CUDA tensors."""
    if build.use_plain("kuu_dense", tops):
        return kuu_dense_plain(tops, B, sizes)
    Q, m = tops.shape
    D = B.shape[1]
    n0, n1, n2 = _sizes3(sizes)
    if D * m > 1 << 20:
        raise ValueError("kuu_dense: D*m = %d exceeds the kernel's grid"
                         % (D * m))
    if n0 * n1 * n2 != m or B.shape != (Q, D, D) or B.dtype != tops.dtype:
        raise ValueError("kuu_dense: tops %s, B %s, sizes %s disagree"
                         % (tuple(tops.shape), tuple(B.shape), sizes))
    tops = tops.contiguous()
    B = B.contiguous()
    build.require_cuda("kuu_dense", tops, B)
    out = torch.empty((D * m, D * m), dtype=tops.dtype, device=tops.device)
    sfx = build.suffix("kuu_dense", tops.dtype)
    fn = build.function(
        "kuu_dense", "kuu_dense_" + sfx,
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    )
    build.check(fn(build.ptr(tops), build.ptr(B), build.ptr(out), Q, D, m,
                   n0, n1, n2, build.stream_ptr()), "kuu_dense")
    kuu_dense.launches[sfx] += 1
    return out


kuu_dense.launches = build.counter()
