"""K10's forward and K9's gather: the host side of their kernels (the
selectors that pick an instance, a layout and a chunk of batch rows,
the gather's grid and what the wrappers pass) and the port against
the JAX package in float64 on the CPU, where the wrappers run their
plain versions."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import runlmc_tpu as R
import runlmc_tpu_torch as T
from runlmc_tpu.lmc import grid as jgrid
from runlmc_tpu.ops import interpolation as ji
from runlmc_tpu_torch.hopper import build, fourier, interp
from runlmc_tpu_torch.lmc import grid as tgrid
from runlmc_tpu_torch.ops import interpolation as ti
from runlmc_tpu_torch.utils.carry import from_reference_params

# the same few-term contractions and FFTs (pocketfft on both sides)
RTOL = 1e-12

# K9's gather on the paths: (n rows, taps, batch rows, layout) -> chunk
# (gather_chunk takes no taps: every tap instance walks its chunk alike)
ROWS, COLS = interp.GATHER_ROWS, interp.GATHER_COLS
GATHER_SITES = {
    (15768, 4, 16, ROWS): 2,     # weather step, float32 and float64
    (3113, 4, 151, ROWS): 4,     # fx2007 predict preconditioner
    (47480, 16, 1, ROWS): 1,     # synth exact step
    (3113, 4, 3094, COLS): 2,    # fx2007 kinv_diag V = W F (F^T)
}
# K10's weather shape: 'slfm', 16 batch rows, D = 4, R = 2, F = 4097
WEATHER_K10 = (16, 4, 2, 4097)


def test_gather_selectors_are_pure_functions_of_the_shape():
    for (n, _, nb, layout), want in GATHER_SITES.items():
        assert [interp.gather_chunk(n, nb, layout)
                for _ in range(3)] == [want] * 3
        assert interp.gather_chunk(n=n, nbatch=nb, layout=layout) == want
    assert interp.gather_chunk(3113, 3094, ROWS) == 4
    assert [interp.gather_taps(t) for t in (1, 4, 9, 16, 64)] \
        == [0, 4, 0, 16, 0]
    assert interp.gather_chunk(10, 0, ROWS) == 1  # no batch rows


def test_k10_instance_is_a_pure_function_of_the_shape():
    sites = {
        ("slfm", 4, 2): fourier.SMALL,     # the weather group
        ("slfm", 1, 1): fourier.SMALL,
        ("slfm", 4, 3): fourier.GENERIC,
        ("slfm", 5, 2): fourier.GENERIC,
        ("slfm", 9, 2): fourier.GENERIC,
        ("sum", 3, 2): fourier.SMALL,
        ("sum", 3, 4): fourier.GENERIC,
        ("bt", 4, 0): fourier.SMALL,
        ("bt", 5, 0): fourier.GENERIC,
    }
    for args, want in sites.items():
        assert [fourier.fourier_instance(*args) for _ in range(3)] \
            == [want] * 3
        assert fourier.fourier_instance(**dict(zip(("rep", "D", "K"),
                                                   args))) == want


def _covered(n_items, grid, per, strided):
    """How often each item of a grid axis is taken: grid index y takes
    items [y per, y per + per) and, on a strided axis, then the blocks
    y + grid, y + 2 grid, ..."""
    count = np.zeros(n_items, np.int64)
    for y in range(grid):
        lo = y * per
        while lo < n_items:
            count[lo:min(lo + per, n_items)] += 1
            if not strided:
                break
            lo += grid * per
    return count


@pytest.mark.parametrize("layout", [ROWS, COLS])
@pytest.mark.parametrize("n, taps, nb", [k[:3] for k in GATHER_SITES]
                         + [(5, 4, 2_000_001), (257, 3, 7)])
def test_gather_chunks_cover_every_row_and_batch_row_once(n, taps, nb,
                                                          layout):
    """The gather's launch (``gather_grid``: CTAs over rows; grid rows
    over chunks or tiles of batch rows, striding past the grid's 65535
    rows) takes every (row, batch row) once: each axis once, so every
    pair once."""
    chunk = interp.gather_chunk(n, nb, layout)
    assert chunk in interp.GATHER_CHUNKS[layout]
    (gx, gy), rows, batch = interp.gather_grid(n, nb, chunk, layout)
    assert gy <= interp.MAX_GRID_Y
    assert (gx, gy) == (rows[0], batch[0])
    assert batch[1] == chunk * (1 if layout == ROWS else interp.GATHER_TILE)
    for axis, items in ((rows, n), (batch, nb)):
        assert (_covered(items, *axis) == 1).all()


def test_gather_layout_is_a_pure_function_of_the_strides():
    sites = {
        (3113, 1, 16): interp.GATHER_ROWS,      # row-major operands
        (1, 3094, 3094): interp.GATHER_COLS,    # kinv_diag's F^T
        (1, 6, 6): interp.GATHER_ROWS,          # too few batch rows
        (1, 1, 40): interp.GATHER_ROWS,         # one column
        (0, 1, 40): interp.GATHER_ROWS,         # a broadcast row
    }
    for args, want in sites.items():
        assert [interp.gather_layout(*args) for _ in range(3)] == [want] * 3
        assert interp.gather_layout(**dict(zip(("sb", "sc", "nbatch"),
                                               args))) == want


def _stub_card(monkeypatch, seen):
    """The wrappers' host path with the card's calls stubbed: each
    launch records its symbol and arguments."""
    def fake_function(name, symbol, argtypes):
        def fn(*args):
            seen.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(build, "use_plain", lambda what, t: False)
    monkeypatch.setattr(build, "require_cuda", lambda what, *ts: None)
    monkeypatch.setattr(build, "function", fake_function)
    monkeypatch.setattr(build, "stream_ptr", lambda device=None: None)
    monkeypatch.setattr(build, "sm_count", lambda index: build.H100_SMS)


def test_gather_wrapper_passes_its_selectors_and_the_strides(monkeypatch):
    """interp_gather passes gather_taps and gather_chunk of its shape, and
    a transposed operand's own pointer and strides (no copy); taps that
    are not 16-byte aligned take the generic instance."""
    rng = np.random.RandomState(3)
    Xs = [rng.uniform(0, 1, (40, 1)), rng.uniform(0, 1, (33, 1))]
    W = ti.multi_interpolant(Xs, [np.linspace(0, 1, 12)]).to(
        torch.float64, "cpu")
    n, taps = W.indices.shape
    seen = []
    _stub_card(monkeypatch, seen)
    before = dict(interp.interp_gather.launches)
    Fm = torch.as_tensor(rng.standard_normal((W.ncols, 40)))
    rows = torch.as_tensor(rng.standard_normal((5, W.ncols)))
    for v in (Fm.T, Fm[:, :6].T, rows):
        interp.interp_gather(W.indices, W.weights, v)
    # taps at a 4-byte offset: not 16-byte aligned
    buf = torch.zeros(n * taps + 1, dtype=torch.int32)
    idx_off = buf[1:].view(n, taps)
    idx_off.copy_(W.indices)
    interp.interp_gather(idx_off, W.weights, rows)
    got = [(s, a[2], a[6:12]) for s, a in seen]

    def chunk(nb, layout):
        return interp.gather_chunk(n, nb, layout)

    assert got == [
        ("interp_gather_f64", Fm.data_ptr(),
         (40, 1, 40, 4, chunk(40, COLS), COLS)),
        ("interp_gather_f64", Fm.data_ptr(),
         (6, 1, 40, 4, chunk(6, ROWS), ROWS)),
        ("interp_gather_f64", rows.data_ptr(),
         (5, W.ncols, 1, 4, chunk(5, ROWS), ROWS)),
        ("interp_gather_f64", rows.data_ptr(),
         (5, W.ncols, 1, 0, chunk(5, ROWS), ROWS)),
    ]
    assert interp.interp_gather.launches["f64"] == before["f64"] + 4


def test_fourier_wrapper_passes_its_selectors(monkeypatch):
    seen = []
    _stub_card(monkeypatch, seen)
    rng = np.random.RandomState(4)

    def c(*shape):
        return torch.as_tensor(rng.standard_normal(shape)
                               + 1j * rng.standard_normal(shape))

    def r(*shape):
        return torch.as_tensor(rng.standard_normal(shape))

    nb, D, K, F = WEATHER_K10
    calls = [("slfm", c(nb, D, F), r(D, K), c(K, F), c(D, F)),
             ("slfm", c(3, 9, 33), r(9, 2), c(2, 33), c(9, 33)),
             ("sum", c(5, 3, 33), r(4, 3, 3), c(4, 33), None),
             ("bt", c(5, 3, 33), None, c(3, 3, 33), None)]
    for rep, vf, mat, sym, diag in calls:
        fourier.fourier_contract(rep, vf, mat, sym, diag)
    got = [(s, a[:2], a[7:11]) for s, a in seen]
    assert got == [
        ("fourier_fwd_f64", (2, fourier.SMALL), (nb, D, K, F)),
        ("fourier_fwd_f64", (2, fourier.GENERIC), (3, 9, 2, 33)),
        ("fourier_fwd_f64", (0, fourier.GENERIC), (5, 3, 4, 33)),
        ("fourier_fwd_f64", (1, fourier.SMALL), (5, 3, 0, 33)),
    ]


def _slfm_states(D, m, seed):
    """JAX's and the port's 'slfm' group state of one lmc kernel of rank
    2 plus an indep kernel on a regular 1-D grid of m points, built from
    the grid alone (the distances and an interpolant that states only
    its column count), from the same raw parameters."""
    sj, st = (pkg.LMCKernelSpec.create(
        D=D, lmc_kernels=[pkg.RBF(name="a")], lmc_ranks=[2],
        indep_gp=[pkg.RBF(name="c")]).with_input_dim(1) for pkg in (R, T))
    rng = np.random.RandomState(seed)
    raw = jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rng.standard_normal(np.shape(a)),
        sj.init_raw_params(seed=seed))
    dists = np.linspace(0, 1, m)
    cols = types.SimpleNamespace(ncols=D * m)
    plan = dict(active_dim=(0,), kidxs=(0, 1), rep="slfm", sizes=(m,),
                mode="fft")
    gsj = jgrid.build_group_state(
        sj, jax.tree.map(jnp.asarray, raw), jgrid.GridPlan(**plan),
        jnp.asarray(dists), cols)
    gst = tgrid.build_group_state(
        st, from_reference_params(raw, torch.float64, "cpu"),
        tgrid.GridData(plan=tgrid.GridPlan(**plan),
                       dists=torch.as_tensor(dists), interp=cols))
    return gsj, gst


@pytest.mark.parametrize("D, instance", [(4, fourier.SMALL),
                                         (9, fourier.GENERIC)])
def test_slfm_grid_matvec_matches_jax(D, instance):
    """GroupState.grid_matvec at the weather group's widths (D = 4, R =
    2, 16 batch rows, an odd F) and at D = 9 (the generic kernel's)
    against the JAX package's fft-mode grid_matvec."""
    m = 20
    gsj, gst = _slfm_states(D, m, seed=D)
    assert gst.rep == "slfm" and tuple(gst.A.shape) == (D, 2)
    F = gst.diag_That.shape[1]
    assert F % 2 == 1
    assert fourier.fourier_instance("slfm", D, 2) == instance
    u = np.random.RandomState(7).standard_normal((16, D * m))
    got = gst.grid_matvec(torch.as_tensor(u)).numpy()
    want = np.asarray(gsj.grid_matvec(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def test_interp_matvec_on_a_transposed_operand():
    """W F^T^T as kinv_diag forms it: the transposed view gives the bits
    of its contiguous copy, and JAX's Interp.matvec's values."""
    rng = np.random.RandomState(9)
    Xs = [np.sort(rng.uniform(0, 1, 31)), np.sort(rng.uniform(0, 1, 26))]
    axes = [np.linspace(0, 1, 14)]
    Wt = ti.multi_interpolant([X[:, None] for X in Xs], axes)
    Wj = ji.multi_interpolant([X[:, None] for X in Xs], axes)
    W = Wt.to(torch.float64, "cpu")
    Fm = torch.as_tensor(rng.standard_normal((W.ncols, 11)))
    got = W.matvec(Fm.T)
    assert not Fm.T.is_contiguous()
    assert torch.equal(got, W.matvec(Fm.T.contiguous()))
    want = np.asarray(Wj.matvec(jnp.asarray(Fm.numpy().T)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                               atol=1e-13 * float(np.abs(want).max()))
