"""The port's public API against the JAX package's: the parameter names
of the public signatures (``MultiGP.save``/``restore`` included),
``mesh``/``max_procs``, ``warm_rescue``'s key and ``MultiGP.optimize``."""

import inspect

import jax
import numpy as np
import pytest

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.models.multigp import MultiGP as JMultiGP
from runlmc_tpu_torch.models import interpolated_llgp as tllgp
from runlmc_tpu_torch.models.multigp import MultiGP as TMultiGP

# The port's only extra parameter: the device its tensors live on.
PORT_ONLY_PARAMS = ("device",)


def _names(fn):
    return [p for p in inspect.signature(fn).parameters
            if p not in PORT_ONLY_PARAMS]


def _public_methods(cls):
    return sorted(k for k, v in vars(cls).items()
                  if not k.startswith("_") and callable(v))


@pytest.mark.parametrize("owner, method", [
    ("InterpolatedLLGP", "__init__"), ("InterpolatedLLGP", "optimize"),
    ("InterpolatedLLGP", "predict"), ("InterpolatedLLGP", "log_likelihood"),
    ("InterpolatedLLGP", "warm_rescue"), ("ExactLMC", "__init__"),
])
def test_signature_matches_jax(owner, method):
    want = list(inspect.signature(getattr(getattr(R, owner), method))
                .parameters)
    assert _names(getattr(getattr(T, owner), method)) == want


def test_multigp_methods_match_jax():
    want = _public_methods(JMultiGP)
    assert "save" in want and "restore" in want
    assert _public_methods(TMultiGP) == want
    for m in want:
        assert _names(getattr(TMultiGP, m)) == _names(getattr(JMultiGP, m))


def test_device_is_the_last_constructor_parameter():
    """Positional calls written for the JAX package bind as there."""
    for cls in (T.InterpolatedLLGP, T.ExactLMC):
        assert list(inspect.signature(cls.__init__).parameters)[-1] == \
            "device"


def _data():
    rng = np.random.RandomState(3)
    Xs = [np.sort(rng.uniform(0, 4, (n, 1)), axis=0) for n in (24, 20)]
    Ys = [np.sin(2 * X[:, 0] + d) + 0.1 * rng.standard_normal(len(X))
          for d, X in enumerate(Xs)]
    spec = T.LMCKernelSpec.create(D=2, lmc_kernels=[T.RBF()], lmc_ranks=[1])
    return Xs, Ys, spec


def test_mesh_raises_and_max_procs_is_accepted():
    Xs, Ys, spec = _data()
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                           mesh=object(), device="cpu")
    m = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                           mesh=None, max_procs=4, device="cpu")
    assert m.n_params > 0


def test_multigp_optimize_raises():
    Xs, Ys, _ = _data()
    with pytest.raises(NotImplementedError):
        TMultiGP(Xs, Ys).optimize()


@pytest.mark.parametrize("key, seed", [
    (None, 0), (7, 7), (np.int64(9), 9),
    (np.array([1, 2], dtype=np.uint32), (1 << 32) | 2),
    (np.asarray(jax.random.PRNGKey(5)), 5),
])
def test_warm_rescue_key_is_the_run_seed(key, seed):
    Xs, Ys, spec = _data()
    m = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                           grid_mode="fft", objective="stochastic",
                           device="cpu")
    seen = []
    probes = m._probes
    m._probes = lambda run_seed, it: (seen.append(run_seed),
                                      probes(run_seed, it))[1]
    m.warm_rescue(key)
    assert seen and set(seen) == {seed}


def test_warm_rescue_rejects_other_keys():
    with pytest.raises(ValueError, match="uint32"):
        tllgp._run_seed_of(np.zeros(3, dtype=np.uint32))
