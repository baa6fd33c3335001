"""The port's public API against the JAX package's: the parameter names
of the public signatures (``MultiGP.save``/``restore`` included),
``mesh`` (a ``runlmc_tpu_torch.parallel`` Mesh, anything else refused)
and ``max_procs``, ``warm_rescue``'s key and ``MultiGP.optimize``."""

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
    """A mesh that is not the port's ``parallel.Mesh`` raises; the port's
    own mesh is taken (one rank here: no process group)."""
    import runlmc_tpu_torch.parallel as par

    Xs, Ys, spec = _data()
    with pytest.raises(ValueError, match="runlmc_tpu_torch.parallel Mesh"):
        T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                           mesh=object(), device="cpu")
    m = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                           mesh=None, max_procs=4, device="cpu")
    assert m.n_params > 0
    mm = T.InterpolatedLLGP(Xs, Ys, functional_kernel=spec, m=[8],
                            mesh=par.default_mesh(), device="cpu")
    assert mm.mesh.size == 1 and mm._rhs_sharding[1] == "probe"


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


# ---- every public name of the JAX package, module by module

# Names of the JAX package the port leaves out on purpose, each with its
# reason: the TPU workarounds (ROADMAP "Not to port").
_TILED = "the 'tiled' grid mode, a TPU workaround (no f64 FFT there)"
_WBLOCKS = ("dense W blocks, the TPU's MXU route of the W applies; every "
            "W apply of the port is kernel K9")
EXEMPT = {
    "runlmc_tpu.lmc.grid.GroupState.grid_tops": _TILED,
    "runlmc_tpu.ops.bttb.bttb_tiled_kuu_matvec": _TILED,
    "runlmc_tpu.ops.bttb.jax_slice": _TILED + " (its slicing helper)",
    "runlmc_tpu.lmc.grid.GroupState.W_blocks": _WBLOCKS,
    "runlmc_tpu.lmc.woodbury.DeviceWoodbury.W_blocks": _WBLOCKS,
    "runlmc_tpu.models.interpolated_llgp.InterpolatedLLGP.SOLVE_SLICE":
        "the watchdog-bounded solve rounds, a TPU workaround",
}


def _jax_public_names():
    """{module: [public names]} of the JAX package: ``__all__`` where a
    module has one, else the functions, classes and top-level constants
    it defines; the public attributes and fields of its classes as
    ``Class.name``."""
    import ast
    import dataclasses
    import importlib
    import pkgutil

    out = {}
    for info in pkgutil.walk_packages(R.__path__, "runlmc_tpu."):
        mod = importlib.import_module(info.name)
        if hasattr(mod, "__all__"):
            names = list(mod.__all__)
        else:
            tree = ast.parse(inspect.getsource(mod))
            names = []
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                    names.append(node.name)
                elif isinstance(node, ast.Assign):
                    names += [t.id for t in node.targets
                              if isinstance(t, ast.Name)]
            names = [n for n in names if not n.startswith("_")]
        members = []
        for n in names:
            obj = getattr(mod, n, None)
            if inspect.isclass(obj) and obj.__module__ == info.name:
                attrs = [k for k in vars(obj) if not k.startswith("_")]
                if dataclasses.is_dataclass(obj):
                    attrs += [f.name for f in dataclasses.fields(obj)]
                members += ["%s.%s" % (n, a) for a in sorted(set(attrs))]
        out[info.name] = sorted(set(names)) + members
    return out


def _has(mod, dotted):
    import dataclasses

    obj = mod
    parts = dotted.split(".")
    for i, p in enumerate(parts):
        if hasattr(obj, p):
            obj = getattr(obj, p)
        elif (i == len(parts) - 1 and dataclasses.is_dataclass(obj)
              and p in {f.name for f in dataclasses.fields(obj)}):
            return True
        else:
            return False
    return True


def test_every_public_name_of_the_jax_package_is_ported():
    import importlib

    missing = []
    for name, publics in _jax_public_names().items():
        if name in EXEMPT:
            continue
        tmod = importlib.import_module(
            name.replace("runlmc_tpu", "runlmc_tpu_torch", 1))
        missing += ["%s.%s" % (name, p) for p in publics
                    if "%s.%s" % (name, p) not in EXEMPT
                    and not _has(tmod, p)]
    assert missing == []


def test_config_names_in_torch_dtypes():
    import torch

    assert T.config in [getattr(T, n) for n in T.__all__]
    assert T.config.default_dtype() is torch.float64
    assert T.config.default_int_dtype() is torch.int64
    assert T.config.EPS == R.config.EPS


def test_group_state_and_kski_shapes_match_jax():
    """GroupState.D, GroupState.fourier_shape() and KSKI.shape of an fft
    model and a dense one, against the JAX package's."""
    import torch

    from runlmc_tpu.lmc import grid as jgrid
    from runlmc_tpu_torch.lmc import grid as tgrid
    from runlmc_tpu_torch.utils.carry import from_reference_params

    rng = np.random.RandomState(0)
    Xs = [rng.uniform(0, 1, (n, 1)) for n in (21, 17, 12)]
    for mode in ("fft", "dense"):
        sj = R.LMCKernelSpec.create(D=3, lmc_kernels=[R.RBF()],
                                    lmc_ranks=[1]).with_input_dim(1)
        st = T.LMCKernelSpec.create(D=3, lmc_kernels=[T.RBF()],
                                    lmc_ranks=[1]).with_input_dim(1)
        raw = sj.init_raw_params()
        gj, _ = jgrid.make_grids(sj, Xs, m=[9], mode=mode)
        gt, _ = tgrid.make_grids(st, Xs, m=[9], mode=mode)
        lens = [len(X) for X in Xs]
        Kj = jgrid.build_kski(sj, jax.tree.map(jax.numpy.asarray, raw), gj,
                              lens)
        Kt = tgrid.build_kski(st, from_reference_params(raw, torch.float64,
                                                        "cpu"),
                              tuple(g.to(torch.float64, "cpu") for g in gt),
                              lens)
        assert Kt.shape == Kj.shape == (50, 50)
        for a, b in zip(Kt.groups, Kj.groups):
            assert a.D == b.D == 3
            assert a.fourier_shape() == b.fourier_shape()
        if mode == "dense":
            np.testing.assert_array_equal(gt[0].idx_map, gj[0].idx_map)
