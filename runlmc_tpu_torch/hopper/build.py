"""Build the CUDA sources under ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared
library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

inside ``runlmc_tpu_torch/hopper/_build/`` (listed in ``.gitignore``).
The file name carries a hash of the sources and flags, so an edited
source never loads a stale library. :func:`build_all` starts one
``nvcc`` per source, all at once, and waits for them together.

A C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0. There is
no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
BUILD_DIR = os.path.join(HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS = {}


def source_names():
    """Names of the CUDA sources, without the ``.cu`` suffix."""
    return sorted(
        os.path.splitext(os.path.basename(p))[0]
        for p in glob.glob(os.path.join(CSRC, "*.cu"))
    )


def nvcc_path():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use"
        )
    return path


def library_path(name):
    h = hashlib.sha256()
    for p in [os.path.join(CSRC, name + ".cu")] + sorted(
        glob.glob(os.path.join(CSRC, "*.cuh"))
    ):
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def build_all(names=None):
    """Compile every named source that has no current library, one
    ``nvcc`` each, all started together. Returns the names built."""
    names = source_names() if names is None else list(names)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return []
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        target = library_path(name)
        tmp = "%s.tmp%d" % (target, os.getpid())
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failed = []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append("%s:\n%s" % (name, out.decode(errors="replace")))
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for\n" + "\n".join(failed))
    return todo


_FNS = {}


def function(name, symbol, argtypes):
    """The C entry point ``symbol`` of library ``name`` (built on first
    use), with its argument types declared and an int return; bound once
    per symbol."""
    fn = _FNS.get(symbol)
    if fn is None:
        if name not in _LIBS:
            build_all([name])
            _LIBS[name] = ctypes.CDLL(library_path(name))
        fn = getattr(_LIBS[name], symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def check(rc, what):
    if rc != 0:
        raise RuntimeError("%s: CUDA launch failed with error %d" % (what, rc))


def stream_ptr(device=None):
    """The handle of the current CUDA stream of ``device`` (the current
    device when None or without an index). The raw handle comes from
    torch's C binding: building a ``torch.cuda.Stream`` took 5-11 µs of
    host time a launch on an H100 host, the raw handle and the current
    device under 1 µs (``chip_smoke.py --k10-k9-times``)."""
    index = None if device is None else device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


# an H100's multiprocessors: the selectors' default count (the wrappers
# pass their card's, sm_count)
H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(index):
    """Multiprocessors of the card of device index ``index`` (a CUDA
    tensor's ``get_device()``), read once a device."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(what, *tensors):
    """The kernels take contiguous CUDA tensors on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError("%s: every tensor must be on %s, got %s"
                             % (what, dev, t.device))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % what)


def use_plain(what, t):
    """True for a CPU tensor (run the plain version), False for a CUDA
    one (launch the kernel); raises on any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError("%s: unsupported device %s" % (what, t.device))


_WORK = {}


def device_work(key, dev, make):
    """A kernel's host-built work list (``make()``, an int32 array) on
    ``dev``, made once per key and device."""
    key = key + (str(dev),)
    if key not in _WORK:
        _WORK[key] = torch.as_tensor(make(), device=dev)
    return _WORK[key]


_TICKETS = {}


def ticket(name, dev):
    """Kernel ``name``'s last-CTA counter on ``dev``: one int32, zero
    between launches (the CTA that finishes a launch resets it)."""
    key = (name, dev)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def counter():
    """A wrapper's launch counts, keyed by the dtype suffix of the
    kernel it launched."""
    return {"f32": 0, "f64": 0}


def suffix(what, dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError("%s: float32 or float64 only, got %s" % (what, dtype))
