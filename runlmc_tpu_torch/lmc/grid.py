"""The SKI grid covariance K = sum_g W_g K_UU_g W_g^T + diag(eps), dense
grid mode (parity: runlmc_tpu/lmc/grid.py).

Dense mode materializes each active-dim group's grid kernel
K_UU = sum_q B_q (x) T_q as one (Dm, Dm) matrix per parameter setting,
through kernel K1 (runlmc_tpu_torch/hopper/kuu.py), and applies W and
W^T through per-output dense interpolation blocks (plain matmuls). Its
matvecs are then one GEMM per group, in any dtype — on the H100 in
native f64. Groups above ``DENSE_MAX_GRID`` points use the fft mode,
which a later slice of the port brings; here they raise.
"""

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from runlmc_tpu_torch.hopper.kuu import kuu_dense
from runlmc_tpu_torch.lmc.kernel_spec import LMCKernelSpec
from runlmc_tpu_torch.ops.interpolation import (
    Interp,
    autogrid,
    interp_output_blocks,
    multi_interpolant,
)
from runlmc_tpu_torch.utils.np_utils import cartesian_product

# Above this many grid points per group (D * m), the JAX package leaves
# dense mode for the FFT path (runlmc_tpu/lmc/grid.py:67). Kept at the
# same value for parity; it was measured on a TPU and awaits a
# measurement on the card.
DENSE_MAX_GRID = 8192

FFT_MODE_SLICE = (
    "grid groups above DENSE_MAX_GRID = %d points (D * m) need the fft "
    "grid mode, which slice 3 of the PyTorch port brings; this slice "
    "runs dense grid mode only" % DENSE_MAX_GRID
)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Static per-active-dim-group plan: which kernels, which
    representation, grid sizes, and the mode ('dense' only here)."""

    active_dim: Tuple[int, ...]
    kidxs: Tuple[int, ...]
    rep: str
    sizes: Tuple[int, ...]
    mode: str = "dense"


def choose_rep(spec: LMCKernelSpec, active_dim) -> str:
    """Representation auto-selection (parity: runlmc_tpu/lmc/grid.py:151).
    Dense mode materializes K_UU whatever the representation; the choice
    is recorded for the fft mode."""
    if spec.Q == 1:
        return "sum"
    tot_rank = spec.total_rank(active_dim)
    num_lmc, _, num_indep = spec.counts(active_dim)
    correction_if_no_diagonal = spec.D if (not num_lmc and not num_indep) else 0
    if tot_rank + spec.D < spec.D**2 + correction_if_no_diagonal:
        return "slfm"
    return "bt"


@dataclasses.dataclass(frozen=True)
class GridData:
    """Parameter-independent grid artifacts for one dense-mode group:
    host numpy from :func:`make_grids`, tensors after :meth:`to`."""

    plan: GridPlan
    dists: Any = None  # (m,) flattened BTTB first-row distances
    interp: Interp = None  # W for the training inputs, (n, D*m)
    W_blocks: Any = None  # per-output dense (n_d, m) blocks
    WtW: Any = None  # (D, m, m) stacked per-output grams W_d^T W_d

    def to(self, dtype, device):
        def _f(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        return GridData(
            plan=self.plan,
            dists=_f(self.dists),
            interp=self.interp.to(dtype, device),
            W_blocks=tuple(_f(b) for b in self.W_blocks),
            WtW=_f(self.WtW),
        )


def _dense_artifacts(Xs_active, axes):
    """(W_blocks, WtW) for a dense-mode group."""
    W_blocks = tuple(interp_output_blocks(Xs_active, axes))
    wtw = np.stack([b.T @ b for b in W_blocks])
    return W_blocks, wtw


def make_grids(spec: LMCKernelSpec, Xs, lo=None, hi=None, m=None,
               rep=None, mode="auto"):
    """Build grids, distances and interpolants per active-dim group, on
    the host. ``mode``: 'auto' or 'dense'; a group with
    D*m > DENSE_MAX_GRID (or ``mode`` 'fft') raises
    ``NotImplementedError``. Returns ``(grid_data, axes)``."""
    if mode not in ("auto", "dense"):
        if mode in ("fft", "tiled"):
            raise NotImplementedError(FFT_MODE_SLICE)
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
        sizes = tuple(len(a) for a in axes)
        if mode == "auto" and spec.D * int(np.prod(sizes)) > DENSE_MAX_GRID:
            raise NotImplementedError(FFT_MODE_SLICE)
        grid = cartesian_product(*axes)
        W_blocks, wtw = _dense_artifacts(Xs_active, axes)
        out.append(GridData(
            plan=GridPlan(
                active_dim=tuple(active_dim),
                kidxs=tuple(kidxs),
                rep=rep or choose_rep(spec, active_dim),
                sizes=sizes,
            ),
            dists=np.linalg.norm(grid - grid[0], axis=-1),
            interp=multi_interpolant(Xs_active, axes),
            W_blocks=W_blocks,
            WtW=wtw,
        ))
        all_axes.append(axes)
    return out, all_axes


def to_dense_f32(grid_data):
    """Float32 copies of placed dense-mode artifacts — the inputs to the
    float32 Woodbury preconditioner factor (woodbury.py)."""
    return tuple(
        GridData(
            plan=gd.plan,
            dists=gd.dists.float(),
            interp=dataclasses.replace(
                gd.interp, weights=gd.interp.weights.float(),
                t_weights=gd.interp.t_weights.float(),
            ),
            W_blocks=tuple(b.float() for b in gd.W_blocks),
            WtW=gd.WtW.float(),
        )
        for gd in grid_data
    )


def wt_apply(blocks, x):
    """W^T x from the per-output dense (n_d, m) interp blocks:
    (..., n) -> (..., D*m), one matmul per output (K4)."""
    xs = torch.split(x, [b.shape[0] for b in blocks], dim=-1)
    return torch.cat([xd @ b for b, xd in zip(blocks, xs)], dim=-1)


def w_apply(blocks, u):
    """W u from the per-output dense (n_d, m) interp blocks:
    (..., D*m) -> (..., n), one matmul per output (K4)."""
    m = blocks[0].shape[1]
    return torch.cat(
        [u[..., d * m:(d + 1) * m] @ b.T for d, b in enumerate(blocks)],
        dim=-1,
    )


@dataclasses.dataclass(frozen=True)
class GroupState:
    """One active-dim group's dense grid kernel and its interpolation."""

    interp: Interp
    W_blocks: Any  # per-output dense (n_d, m) interp blocks
    KUU_dense: Any  # (D*m, D*m)

    def grid_matvec(self, u):
        """K_UU u for this group: u (..., D*m) -> (..., D*m)."""
        return u @ self.KUU_dense.T

    def matvec(self, x):
        """Full SKI term W K_UU W^T x: (..., n) -> (..., n) (parity:
        grid.py:420-444)."""
        return w_apply(self.W_blocks,
                       self.grid_matvec(wt_apply(self.W_blocks, x)))


def build_group_state(spec: LMCKernelSpec, raw_params, gd: GridData):
    """Evaluate the kernels on the grid and materialize K_UU through
    kernel K1 (parity: grid.py:524-547, dense branch)."""
    tops = spec.eval_kernels_stacked(raw_params, gd.dists, gd.plan.kidxs)
    B = spec.coreg_mats(raw_params, gd.plan.kidxs)
    return GroupState(
        interp=gd.interp, W_blocks=gd.W_blocks,
        KUU_dense=kuu_dense(tops, B, gd.plan.sizes),
    )


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
    noise_n = torch.repeat_interleave(
        noise, torch.as_tensor(np.asarray(lens), device=noise.device)
    )
    return KSKI(groups=groups, noise_n=noise_n)
