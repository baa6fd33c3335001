"""The SKI grid covariance K = sum_g W_g K_UU_g W_g^T + diag(eps) (parity:
runlmc_tpu/lmc/grid.py).

Each active-dim group's grid kernel K_UU = sum_q B_q (x) T_q runs in
one of two modes:

- 'dense' (D*m <= ``DENSE_MAX_GRID``): K_UU materialized once per
  parameter setting as one (Dm, Dm) matrix through kernel K1 and its
  backward (runlmc_tpu_torch/hopper/kuu.py); its matvec is one GEMM, in
  any dtype — on the H100 in native f64;
- 'fft' (larger grids): K_UU u = irfftn(contract(rfftn(u))), the
  circulant embedding's Fourier symbol (ops/bttb.py, K11) contracted
  with the coregionalization per frequency by kernel K10
  (runlmc_tpu_torch/hopper/fourier.py), in the representation 'sum',
  'bt' or 'slfm' that :func:`choose_rep` picks; cuFFT has f64, so the
  model-dtype operator stays in fft mode (the JAX package's 'tiled'
  mode is a TPU workaround and not ported).

W and W^T go through the sparse interpolant, kernel K9 with its
autograd pair (runlmc_tpu_torch/hopper/interp.py), which is also K4: the
per-output dense interpolation blocks (``W_BLOCKS_MAX_ELEMS``) and their
grams stay on the host, where they make the capacitance plan (the grams
``WtW``, their nonzero tiles, and the cross grams of multi-group models,
once per grid) that kernel K2 (runlmc_tpu_torch/hopper/capacitance.py)
reads. An fft group also carries a dense-mode twin (``GridData.coarse``)
whose float32 Woodbury factorization preconditions its solves: the exact
fine geometry when D*m fits under ``PRECOND_MAX_GRID``, else a
proportionally coarsened grid.
"""

import dataclasses
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from runlmc_tpu_torch.hopper.capacitance import tile_plan
from runlmc_tpu_torch.hopper.fourier import contract
from runlmc_tpu_torch.hopper.kuu import KUUDense
from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu_torch.ops import bttb
from runlmc_tpu_torch.ops.interpolation import (
    Interp,
    autogrid,
    interp_output_blocks,
    multi_interpolant,
)
from runlmc_tpu_torch.utils.np_utils import cartesian_product

# The caps of runlmc_tpu/lmc/grid.py:67-88, kept at the same values for
# parity. They were measured on a TPU and await a measurement on the
# card. Above DENSE_MAX_GRID points per group (D * m) a group runs in fft
# mode; its preconditioner twin keeps the fine geometry up to
# PRECOND_MAX_GRID points; dense interpolation blocks are built while
# n * m stays under W_BLOCKS_MAX_ELEMS.
DENSE_MAX_GRID = 8192
PRECOND_MAX_GRID = 16384
W_BLOCKS_MAX_ELEMS = 50_000_000


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Static per-active-dim-group plan: which kernels, which
    representation, grid sizes, and the mode ('dense' or 'fft')."""

    active_dim: Tuple[int, ...]
    kidxs: Tuple[int, ...]
    rep: str
    sizes: Tuple[int, ...]
    mode: str = "dense"


def choose_rep(spec: LMCKernelSpec, active_dim) -> str:
    """Representation auto-selection (parity: runlmc_tpu/lmc/grid.py:151):
    the fft contraction's path; dense mode materializes K_UU whatever the
    representation."""
    if spec.Q == 1:
        return "sum"
    tot_rank = spec.total_rank(active_dim)
    num_lmc, _, num_indep = spec.counts(active_dim)
    correction_if_no_diagonal = spec.D if (not num_lmc and not num_indep) else 0
    if tot_rank + spec.D < spec.D**2 + correction_if_no_diagonal:
        return "slfm"
    return "bt"


class Gram(NamedTuple):
    """One gram of the capacitance plan, G (D, m_a, m_b) with
    G[d] = W_{a,d}^T W_{b,d}, and the tile plan (ptr, rblk) of its
    nonzero tiles that kernel K2 follows."""

    G: Any
    ptr: Any
    rblk: Any

    def map(self, values, plan):
        """The same gram with ``values`` applied to G and ``plan`` to
        each array of its tile plan."""
        return Gram(values(self.G), plan(self.ptr), plan(self.rblk))


@dataclasses.dataclass(frozen=True)
class GridData:
    """Parameter-independent grid artifacts for one group: host numpy from
    :func:`make_grids`, tensors after :meth:`to`."""

    plan: GridPlan
    dists: Any = None  # (m,) flattened BTTB first-row distances
    interp: Interp = None  # W for the training inputs, (n, D*m)
    W_blocks: Any = None  # host only: per-output dense (n_d, m) blocks
    WtW: Any = None  # (D, m, m) stacked per-output grams ('dense')
    coarse: Any = None  # 'fft': the dense-mode preconditioner twin (host)
    gram_tiles: Any = None  # WtW's tile plan (ptr, rblk) for kernel K2
    # the Woodbury set's cross grams with each later group b: one
    # (Gram G_ab, Gram G_ba) pair per b
    cross: Any = ()

    def to(self, dtype, device, memo=None):
        """Placed copy at ``dtype`` on ``device``, without the host-side
        ``coarse`` twin (:func:`precond_dense_f32` places that) and the
        dense W blocks (every W apply runs through ``interp``). Arrays
        already placed at this dtype through the same ``memo`` dict are
        shared, not copied."""
        memo = {} if memo is None else memo

        def _f(a, kind=dtype):
            key = (id(a), kind)
            if key not in memo:
                memo[key] = torch.as_tensor(np.asarray(a), dtype=kind,
                                            device=device)
            return memo[key]

        def _plan(a):
            return _f(a, torch.int32)

        key = (id(self.interp), dtype)
        if key not in memo:
            memo[key] = self.interp.to(dtype, device)
        return GridData(
            plan=self.plan,
            dists=_f(self.dists),
            interp=memo[key],
            WtW=None if self.WtW is None else _f(self.WtW),
            gram_tiles=(None if self.gram_tiles is None else tuple(
                _plan(a) for a in self.gram_tiles)),
            cross=tuple(tuple(g.map(_f, _plan) for g in c)
                        for c in self.cross),
        )


def coarse_sizes(sizes, D, cap=None):
    """Per-dim sizes of the coarsened preconditioner grid (parity:
    grid.py:189-207): the largest proportional shrink of ``sizes`` with
    D * prod(out) <= ``cap`` (default ``DENSE_MAX_GRID``) and every dim
    >= 4 (the cubic-interpolation minimum)."""
    cap = cap or DENSE_MAX_GRID
    sizes = tuple(int(s) for s in sizes)
    P = len(sizes)
    budget = max(cap // max(D, 1), 4**P)
    if int(np.prod(sizes)) <= budget:
        return sizes
    factor = (budget / float(np.prod(sizes))) ** (1.0 / P)
    out = [max(4, int(np.floor(s * factor))) for s in sizes]
    while int(np.prod(out)) > budget:
        i = int(np.argmax(out))
        if out[i] <= 4:
            break
        out[i] -= 1
    return tuple(out)


def _dense_artifacts(Xs_active, axes, W_blocks=None):
    """(W_blocks, WtW, WtW's tile plan) for a dense-mode group."""
    if W_blocks is None:
        W_blocks = tuple(interp_output_blocks(Xs_active, axes))
    wtw = np.stack([b.T @ b for b in W_blocks])
    return W_blocks, wtw, tile_plan(wtw)


def _with_cross_grams(out):
    """``out`` with the cross grams of its Woodbury set: each group's
    dense artifacts (itself, or the coarse twin of an fft group) get
    G_ab = W_{a,d}^T W_{b,d} against every later group's, with both
    orientations' tile plans (parity: the grams of woodbury.py:266-272,
    made there per factorization)."""
    arts = [gd if gd.plan.mode == "dense" else gd.coarse for gd in out]
    if len(arts) < 2:
        return out
    new = []
    for a, art in enumerate(arts):
        cross = []
        for b in range(a + 1, len(arts)):
            g_ab = np.stack([wa.T @ wb for wa, wb in
                             zip(art.W_blocks, arts[b].W_blocks)])
            g_ba = np.ascontiguousarray(np.swapaxes(g_ab, 1, 2))
            cross.append((Gram(g_ab, *tile_plan(g_ab)),
                          Gram(g_ba, *tile_plan(g_ba))))
        art = dataclasses.replace(art, cross=tuple(cross))
        gd = out[a]
        new.append(art if gd.plan.mode == "dense"
                   else dataclasses.replace(gd, coarse=art))
    return new


def make_grids(spec: LMCKernelSpec, Xs, lo=None, hi=None, m=None,
               rep=None, mode="auto"):
    """Build grids, distances and interpolants per active-dim group, on
    the host (parity: runlmc_tpu/lmc/grid.py:218-324). ``mode``: 'auto'
    (dense when D*m <= DENSE_MAX_GRID, else fft), 'dense' or 'fft'.
    An fft group gets dense W blocks while n*m <= W_BLOCKS_MAX_ELEMS,
    and its dense-mode preconditioner twin in ``coarse``. Returns
    ``(grid_data, axes)``."""
    if mode == "tiled":
        raise ValueError(
            "grid_mode='tiled' is the JAX package's TPU-only mode (an exact "
            "first-row contraction standing in for the f64 FFT the TPU "
            "lacks); the card has f64 FFTs, so use 'fft' or 'auto'"
        )
    if mode not in ("auto", "dense", "fft"):
        raise ValueError("unknown grid mode %r" % (mode,))

    def _sub(v, active_dim):
        if v is None:
            return None
        v = np.asarray(v)
        if v.ndim == 0:
            if len(active_dim) != 1:
                raise ValueError("scalar grid bound for a multi-dim group")
            return v.reshape(1)
        return v[list(active_dim)]

    out = []
    all_axes = []
    for active_dim, kidxs in spec.active_dims.items():
        Xs_active = [np.asarray(X)[:, list(active_dim)] for X in Xs]
        axes = autogrid(
            Xs_active, _sub(lo, active_dim), _sub(hi, active_dim),
            _sub(m, active_dim),
        )
        grid = cartesian_product(*axes)
        dists = np.linalg.norm(grid - grid[0], axis=-1)
        sizes = tuple(len(a) for a in axes)
        interp = multi_interpolant(Xs_active, axes)
        m_tot = int(np.prod(sizes))
        group_mode = mode
        if mode == "auto":
            group_mode = "dense" if spec.D * m_tot <= DENSE_MAX_GRID else "fft"
        plan = GridPlan(
            active_dim=tuple(active_dim),
            kidxs=tuple(kidxs),
            rep=rep or choose_rep(spec, active_dim),
            sizes=sizes,
            mode=group_mode,
        )
        W_blocks = wtw = tiles = coarse = None
        if group_mode == "dense":
            W_blocks, wtw, tiles = _dense_artifacts(Xs_active, axes)
        else:
            n_total = sum(len(X) for X in Xs_active)
            if n_total * m_tot <= W_BLOCKS_MAX_ELEMS:
                W_blocks = tuple(interp_output_blocks(Xs_active, axes))
            c_sizes = coarse_sizes(sizes, spec.D, cap=PRECOND_MAX_GRID)
            if c_sizes == sizes:
                # the exact fine geometry: share the fine artifacts
                c_dists, c_interp = dists, interp
                c_blocks, c_wtw, c_tiles = _dense_artifacts(
                    Xs_active, axes, W_blocks)
            else:
                c_axes = [np.linspace(a[0], a[-1], s)
                          for a, s in zip(axes, c_sizes)]
                c_grid = cartesian_product(*c_axes)
                c_dists = np.linalg.norm(c_grid - c_grid[0], axis=-1)
                c_interp = multi_interpolant(Xs_active, c_axes)
                c_blocks, c_wtw, c_tiles = _dense_artifacts(Xs_active,
                                                            c_axes)
            coarse = GridData(
                plan=GridPlan(active_dim=tuple(active_dim),
                              kidxs=tuple(kidxs), rep=plan.rep,
                              sizes=c_sizes, mode="dense"),
                dists=c_dists, interp=c_interp, W_blocks=c_blocks,
                WtW=c_wtw, gram_tiles=c_tiles,
            )
        out.append(GridData(plan=plan, dists=dists, interp=interp,
                            W_blocks=W_blocks, WtW=wtw, coarse=coarse,
                            gram_tiles=tiles))
        all_axes.append(axes)
    return _with_cross_grams(out), all_axes


def to_dense_f32(grid_data):
    """Float32 copies of placed dense-mode artifacts — the inputs to the
    float32 Woodbury factor (woodbury.py) of an all-dense model."""
    return tuple(
        GridData(
            plan=gd.plan,
            dists=gd.dists.float(),
            interp=dataclasses.replace(
                gd.interp, weights=gd.interp.weights.float(),
                t_weights=gd.interp.t_weights.float(),
            ),
            WtW=gd.WtW.float(),
            gram_tiles=gd.gram_tiles,
            cross=tuple(tuple(g._replace(G=g.G.float()) for g in c)
                        for c in gd.cross),
        )
        for gd in grid_data
    )


def precond_dense_f32(grid_data, device, memo=None):
    """Per-group float32 dense-mode artifacts of the Woodbury
    preconditioner factor, placed on ``device`` from the host-side
    :func:`make_grids` output (parity: grid.py:470-485): a dense group
    contributes itself, an fft group its ``coarse`` twin."""
    return tuple(
        (gd if gd.plan.mode == "dense" else gd.coarse).to(
            torch.float32, device, memo)
        for gd in grid_data
    )


def fine_fft_f32(grid_data, device, memo=None):
    """Float32 copies of the fine artifacts, placed on ``device`` from the
    host-side :func:`make_grids` output — the inner operator of the
    mixed-precision solves (parity: grid.py:488-521). Dense groups stay
    dense."""
    return tuple(gd.to(torch.float32, device, memo) for gd in grid_data)


def gram_nest(grids):
    """The (groups, groups) nest of :class:`Gram` that kernel K2 reads,
    from a Woodbury set of placed dense-mode artifacts: each group's own
    ``WtW`` on the diagonal, the cross grams off it."""
    n = len(grids)
    nest = [[None] * n for _ in range(n)]
    for a, gd in enumerate(grids):
        nest[a][a] = Gram(gd.WtW, *gd.gram_tiles)
        for j, (g_ab, g_ba) in enumerate(gd.cross):
            nest[a][a + 1 + j], nest[a + 1 + j][a] = g_ab, g_ba
    return nest


@dataclasses.dataclass(frozen=True)
class GroupState:
    """One active-dim group's grid kernel and its interpolation: the
    dense K_UU, or the Fourier symbol of its representation — 'sum':
    ``B`` (Q, D, D) and ``That`` (Q, F); 'bt': ``BThat`` (D, D, F);
    'slfm': ``A`` (D, R), ``That_rep`` (R, F) and ``diag_That``
    (D, F)."""

    interp: Interp
    sizes: Tuple[int, ...] = ()
    rep: str = "sum"
    mode: str = "dense"
    KUU_dense: Any = None  # (D*m, D*m)
    B: Any = None
    That: Any = None
    BThat: Any = None
    A: Any = None
    That_rep: Any = None
    diag_That: Any = None

    def grid_matvec(self, u):
        """K_UU u for this group: u (..., D*m) -> (..., D*m)."""
        if self.mode == "dense":
            return u @ self.KUU_dense.T
        sizes = self.sizes
        m = int(np.prod(sizes))
        d = self.interp.ncols // m
        batch = u.shape[:-1]
        fsh = bttb.fourier_shape(sizes)
        F = int(np.prod(fsh))
        vhat = bttb.operand_fft(u.reshape(batch + (d, m)), sizes)
        vf = vhat.reshape(-1, d, F)
        if self.rep == "sum":
            g = contract("sum", vf, self.B, self.That)
        elif self.rep == "bt":
            g = contract("bt", vf, None, self.BThat)
        else:
            g = contract("slfm", vf, self.A, self.That_rep, self.diag_That)
        out = bttb.operand_ifft(g.reshape(batch + (d,) + fsh), sizes)
        return out.reshape(batch + (d * m,))

    def matvec(self, x):
        """Full SKI term W K_UU W^T x: (..., n) -> (..., n) (parity:
        grid.py:413-444, where the dense W blocks' GEMMs are K4), through
        K9's scatter and gather."""
        return self.interp.matvec(self.grid_matvec(self.interp.rmatvec(x)))


def build_group_state(spec: LMCKernelSpec, raw_params, gd: GridData):
    """Evaluate the kernels on the grid and assemble the group's operator
    (parity: grid.py:524-596): dense mode materializes K_UU through
    kernel K1 (gradients reach ``tops`` and ``B`` through K1's backward);
    fft mode precomputes the Fourier symbol of its representation, which
    kernel K10 and its backward contract."""
    plan = gd.plan
    kidxs = plan.kidxs
    tops = spec.eval_kernels_stacked(raw_params, gd.dists, kidxs)
    base = dict(interp=gd.interp, sizes=plan.sizes, rep=plan.rep,
                mode=plan.mode)
    if plan.mode == "dense":
        B = spec.coreg_mats(raw_params, kidxs)
        return GroupState(KUU_dense=KUUDense.apply(tops, B, plan.sizes),
                          **base)
    that = bttb.bttb_fft(tops, plan.sizes).reshape(len(kidxs), -1)
    if plan.rep == "sum":
        return GroupState(B=spec.coreg_mats(raw_params, kidxs), That=that,
                          **base)
    if plan.rep == "bt":
        B = spec.coreg_mats(raw_params, kidxs)
        return GroupState(
            BThat=torch.einsum("qde,qf->def", B.to(that.dtype), that),
            **base)
    non_indep = spec.non_indep_idxs(kidxs)
    pos_of = {q: i for i, q in enumerate(kidxs)}
    if non_indep:
        A = torch.cat([spec.coreg_vec(raw_params, q) for q in non_indep],
                      dim=0).T  # (D, R_tot)
        reps = [pos_of[q] for q in non_indep for _ in range(spec.ranks[q])]
        # rows picked one by one: the backward of an index tensor would
        # accumulate with atomics, in another order on every run
        That_rep = torch.stack([that[i] for i in reps])
    else:
        A = torch.zeros((spec.D, 1), dtype=tops.dtype, device=tops.device)
        That_rep = torch.zeros((1, that.shape[1]), dtype=that.dtype,
                               device=that.device)
    kappa = torch.stack([spec.coreg_diag(raw_params, q) for q in kidxs])
    return GroupState(
        A=A, That_rep=That_rep,
        diag_That=torch.einsum("qd,qf->df", kappa.to(that.dtype), that),
        **base)


@dataclasses.dataclass(frozen=True)
class KSKI:
    """The full SKI LMC covariance operator over the stacked data vector:
    K = sum_groups W_g K_UU_g W_g^T + diag(noise per point)."""

    groups: Tuple[GroupState, ...]
    noise_n: Any  # (n,) per-data-point noise

    def matvec(self, x):
        out = self.noise_n * x
        for g in self.groups:
            out = out + g.matvec(x)
        return out


def build_kski(spec: LMCKernelSpec, raw_params, grid_data, lens) -> KSKI:
    """Assemble the covariance operator from raw parameters (parity:
    grid.py:626-641)."""
    groups = tuple(build_group_state(spec, raw_params, gd) for gd in grid_data)
    noise = spec.noise(raw_params)
    # each output's noise expanded over its points: the backward sums each
    # segment in a fixed order (repeat_interleave's would accumulate with
    # atomics on the card, so that two trainings part after a few steps)
    noise_n = torch.cat([noise[d].expand(int(n)) for d, n in enumerate(lens)])
    return KSKI(groups=groups, noise_n=noise_n)
