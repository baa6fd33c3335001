"""cuSOLVER's Cholesky factorization in place: the factorization of
runlmc_tpu/lmc/woodbury.py:121 (``jnp.linalg.cholesky``), a library call
by design, as the JAX package leaves it to XLA.

    potrf_(M) -> (M, info)

factors the lower triangle of a column-major (n, n) ``M`` where it lies.
On the card this is ``cusolverDnXpotrf`` (lower, ``lda = n``), called
through ctypes from the very ``libcusolver`` that torch has loaded (found
by its soname, never loaded anew: another build could round apart), on
torch's current stream, its workspace from torch's allocator and its
``info`` an int32 scalar on the card. It is the call
``torch.linalg.cholesky_ex`` makes, so the factor's bits are torch's;
unlike ``torch.linalg.cholesky_ex`` it neither copies M into a new factor
nor runs ``tril_`` after it: M's strict upper triangle keeps what it held
(K3's prologue writes zeros there). For a CPU tensor, ``potrf_`` is
``torch.linalg.cholesky_ex(M, out=(M, info))`` (LAPACK, which also clears
the upper triangle).
"""

import ctypes
import os

import torch

from runlmc_tpu_torch.hopper import build

# cublasFillMode_t and cudaDataType
_LOWER = 0
_DATA_TYPE = {torch.float32: 0, torch.float64: 1}
# the sonames of cuSOLVER 11 (CUDA 12) and 12 (CUDA 13)
_SONAMES = ("libcusolver.so.11", "libcusolver.so.12")

_LIB = []
_HANDLES = {}
_SIZES = {}


def _library():
    """torch's loaded libcusolver, with the entry points' types."""
    if _LIB:
        return _LIB[0]
    # torch loads its linear-algebra libraries at their first use
    torch.linalg.cholesky_ex(torch.ones((1, 1), device="cuda"))
    lib = None
    for name in _SONAMES:
        try:
            lib = ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_LAZY)
            break
        except OSError:
            continue
    if lib is None:
        raise RuntimeError("potrf_: torch's libcusolver is not loaded "
                           "under any of %s" % (_SONAMES,))
    P, I, I64, SZ = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                     ctypes.c_size_t)
    for fn, args in (
            ("cusolverDnCreate", [ctypes.POINTER(P)]),
            ("cusolverDnCreateParams", [ctypes.POINTER(P)]),
            ("cusolverDnSetStream", [P, P]),
            ("cusolverDnXpotrf_bufferSize",
             [P, P, I, I64, I, P, I64, I, ctypes.POINTER(SZ),
              ctypes.POINTER(SZ)]),
            ("cusolverDnXpotrf",
             [P, P, I, I64, I, P, I64, I, P, SZ, P, SZ, P])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = ctypes.c_int
    _LIB.append(lib)
    return lib


def _check(status, what):
    if status != 0:
        raise RuntimeError("potrf_: %s returned cuSOLVER status %d"
                           % (what, status))


def _handle(lib, dev):
    """(handle, params) for ``dev``, made once, on that device."""
    if dev.index not in _HANDLES:
        handle, params = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(dev):
            _check(lib.cusolverDnCreate(ctypes.byref(handle)),
                   "cusolverDnCreate")
            _check(lib.cusolverDnCreateParams(ctypes.byref(params)),
                   "cusolverDnCreateParams")
        _HANDLES[dev.index] = (handle, params)
    return _HANDLES[dev.index]


def potrf_(M):
    """``(M, info)``: M's lower triangle factored in place (module
    docstring). ``M`` is a square float32 or float64 tensor, on the card
    stored column-major."""
    if M.dim() != 2 or M.shape[0] != M.shape[1]:
        raise ValueError("potrf_: M must be square, got %s"
                         % (tuple(M.shape),))
    if M.dtype not in _DATA_TYPE:
        raise ValueError("potrf_: float32 or float64 only, got %s" % M.dtype)
    if M.device.type == "cpu":
        info = torch.empty((), dtype=torch.int32)
        torch.linalg.cholesky_ex(M, out=(M, info))
        return M, info
    if M.device.type != "cuda":
        raise ValueError("potrf_: unsupported device %s" % M.device)
    if not M.mT.is_contiguous():
        raise ValueError("potrf_: M must be stored column-major on the card")
    lib = _library()
    dev = M.device
    handle, params = _handle(lib, dev)
    n, dt = M.shape[0], _DATA_TYPE[M.dtype]
    info = torch.empty((), dtype=torch.int32, device=dev)  # potrf sets it
    if n == 0:
        return M, info.zero_()
    _check(lib.cusolverDnSetStream(handle, build.stream_ptr(dev)),
           "cusolverDnSetStream")
    key = (n, M.dtype, dev.index)
    if key not in _SIZES:
        on_dev, on_host = ctypes.c_size_t(), ctypes.c_size_t()
        _check(lib.cusolverDnXpotrf_bufferSize(
            handle, params, _LOWER, n, dt, M.data_ptr(), n, dt,
            ctypes.byref(on_dev), ctypes.byref(on_host)),
            "cusolverDnXpotrf_bufferSize")
        _SIZES[key] = (on_dev.value, on_host.value,
                       (ctypes.c_char * max(on_host.value, 1))())
    dev_bytes, host_bytes, host_buf = _SIZES[key]
    work = torch.empty(max(dev_bytes, 1), dtype=torch.uint8, device=dev)
    _check(lib.cusolverDnXpotrf(
        handle, params, _LOWER, n, dt, M.data_ptr(), n, dt,
        work.data_ptr(), dev_bytes, ctypes.addressof(host_buf), host_bytes,
        info.data_ptr()), "cusolverDnXpotrf")
    return M, info
