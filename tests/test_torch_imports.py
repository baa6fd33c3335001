"""The PyTorch port stands alone: it imports neither JAX nor runlmc_tpu,
and its entry points run on the CUDA device unless the caller asks for
the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import runlmc_tpu_torch as T
from runlmc_tpu_torch import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "runlmc_tpu")


def test_import_loads_no_jax_or_reference():
    code = (
        "import sys, runlmc_tpu_torch, runlmc_tpu_torch.hopper.build\n"
        "import runlmc_tpu_torch.datasets, runlmc_tpu_torch.ops.slq\n"
        "import runlmc_tpu_torch.ops.operators, runlmc_tpu_torch.priors\n"
        "import runlmc_tpu_torch.metrics, runlmc_tpu_torch.mean\n"
        "import runlmc_tpu_torch.models.exact_lmc\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN,)
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


_IMPORT = re.compile(r"^\s*(?:import|from)\s+([A-Za-z_][\w.]*)", re.M)


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f)
     for d, _, fs in os.walk(os.path.join(REPO, "runlmc_tpu_torch"))
     for f in fs if f.endswith(".py")]
    + [os.path.join(REPO, "chip_smoke.py")]
), ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax_or_reference(path):
    with open(path) as f:
        mods = _IMPORT.findall(f.read())
    bad = [m for m in mods if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_tf32_off_after_import():
    assert config.tf32_disabled()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def _tiny_problem():
    rng = np.random.RandomState(0)
    Xs = [np.sort(rng.uniform(0, 1, 20)) for _ in range(2)]
    Ys = [np.sin(5 * X) + 0.1 * rng.randn(20) for X in Xs]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    return Xs, Ys, spec


def test_entry_point_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Xs, Ys, spec = _tiny_problem()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                           device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        config.default_device()


def test_cpu_only_when_asked():
    Xs, Ys, spec = _tiny_problem()
    model = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                               device="cpu")
    assert model.device.type == "cpu"
    assert model.dtype == torch.float64
    assert model.y.device.type == "cpu"
