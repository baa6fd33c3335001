"""LMC kernel specification: static structure + raw-parameter dicts
(parity: runlmc_tpu/lmc/kernel_spec.py).

The LMC covariance between inputs x, x' on outputs a, b is

    K((x,a), (x',b)) = sum_q B_q[a,b] k_q(||x - x'||),
    B_q = A_q^T A_q + diag(kappa_q)

with three kernel kinds:
  'lmc'   rank-r_q trainable A_q, trainable positive kappa_q
  'slfm'  rank-1 trainable A_q, kappa_q fixed at 0
  'indep' A_q = 0 fixed, kappa_q = e_d fixed (one independent GP per
          listed output)

Raw parameters are a plain dict of tensors with the JAX package's
nesting and keys: ``coreg_vecs``, ``coreg_diags``, ``kernels`` (each
keyed ``q<index>``) and ``noise``. The computation dtype and device
follow the ``noise`` leaf.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.stats
import torch

from runlmc_tpu_torch.kernels.stationary import StationaryKernel, eval_table
from runlmc_tpu_torch.params import POSITIVE


@dataclasses.dataclass(frozen=True)
class LMCKernelSpec:
    """Static spec for an LMC kernel over D outputs, built with the
    reference vocabulary: ``lmc_kernels`` + ``lmc_ranks``,
    ``slfm_kernels``, ``indep_gp`` (+ ``indep_gp_index``)."""

    D: int
    kernels: Tuple[StationaryKernel, ...]  # lmc, then slfm, then indep
    kinds: Tuple[str, ...]  # 'lmc' | 'slfm' | 'indep' per kernel
    ranks: Tuple[int, ...]  # A_q rank (lmc: r_q; slfm: 1; indep: 0)
    indep_idx: Tuple[int, ...]  # for each 'indep' kernel, its output index
    P: Optional[int] = None  # input dimension; set via with_input_dim

    # ---------------------------------------------------------------- init

    @staticmethod
    def create(
        D,
        lmc_kernels=None,
        lmc_ranks=None,
        slfm_kernels=None,
        indep_gp=None,
        indep_gp_index=None,
    ):
        if not D:
            raise ValueError("D should be specified")
        lmc_kernels = list(lmc_kernels or [])
        lmc_ranks = list(lmc_ranks or [])
        slfm_kernels = list(slfm_kernels or [])
        indep_gp = list(indep_gp or [])
        if not lmc_kernels and not slfm_kernels and not indep_gp:
            raise ValueError("number of kernels should be > 0")
        if len(lmc_kernels) != len(lmc_ranks):
            raise ValueError("# LMC kernels should equal # LMC ranks")
        if not all(r > 0 for r in lmc_ranks):
            raise ValueError("LMC ranks must be positive")
        indep_gp_index = list(
            indep_gp_index
            if indep_gp_index is not None
            else range(len(indep_gp))
        )
        if len(indep_gp) != len(indep_gp_index):
            raise ValueError("indep GP kernel count must match indices")
        return LMCKernelSpec(
            D=D,
            kernels=tuple(lmc_kernels + slfm_kernels + indep_gp),
            kinds=tuple(
                ["lmc"] * len(lmc_kernels)
                + ["slfm"] * len(slfm_kernels)
                + ["indep"] * len(indep_gp)
            ),
            ranks=tuple(
                list(lmc_ranks) + [1] * len(slfm_kernels)
                + [0] * len(indep_gp)
            ),
            indep_idx=tuple(indep_gp_index),
        )

    # ------------------------------------------------------------ structure

    @property
    def Q(self):
        return len(self.kernels)

    def with_input_dim(self, P):
        """Resolve each kernel's active dims against input dimension P."""
        if self.P == P:
            return self
        if self.P is not None:
            raise ValueError("cannot set input dimension twice")
        all_dims = tuple(range(P))
        kernels = tuple(
            k.with_active_dims(k.active_dims or all_dims)
            for k in self.kernels
        )
        return dataclasses.replace(self, kernels=kernels, P=P)

    @property
    def active_dims(self) -> Dict[Tuple[int, ...], Tuple[int, ...]]:
        """Map active-dims tuple -> kernel indices with those dims, in
        kernel order."""
        if self.P is None:
            raise ValueError("call with_input_dim first")
        groups = {}
        for i, k in enumerate(self.kernels):
            groups.setdefault(k.active_dims, []).append(i)
        return {k: tuple(v) for k, v in groups.items()}

    def counts(self, active_dim):
        """(num_lmc, num_slfm, num_indep) within one active-dims group."""
        kinds = [self.kinds[i] for i in self.active_dims[active_dim]]
        return (
            kinds.count("lmc"),
            kinds.count("slfm"),
            kinds.count("indep"),
        )

    def total_rank(self, active_dim):
        """Total coregionalization rank within a group."""
        return sum(
            self.ranks[i]
            for i in self.active_dims[active_dim]
            if self.kinds[i] != "indep"
        )

    def non_indep_idxs(self, idxs):
        """The kernel indices among ``idxs`` that are not 'indep' (parity:
        runlmc_tpu/lmc/kernel_spec.py:146-148): the rank-carrying kernels
        of the fft 'slfm' representation."""
        return tuple(i for i in idxs if self.kinds[i] != "indep")

    # ----------------------------------------------------------- parameters

    def init_raw_params(self, seed=0):
        """Initial raw-parameter dict, as numpy arrays: the same values,
        bit for bit, as the JAX package's ``init_raw_params(seed)``
        (numpy ``RandomState`` + scipy ``truncnorm`` draws in the same
        order)."""
        rng = np.random.RandomState(seed)
        trunc = scipy.stats.truncnorm(-1, 1)
        coreg_vecs = {}
        coreg_diags = {}
        kernel_params = {}
        for q, (kind, rank) in enumerate(zip(self.kinds, self.ranks)):
            if kind in ("lmc", "slfm"):
                coreg_vecs["q%d" % q] = trunc.rvs(
                    size=(rank, self.D), random_state=rng
                )
            if kind == "lmc":
                coreg_diags["q%d" % q] = np.asarray(
                    POSITIVE.inverse(np.ones(self.D))
                )
            kp = self.kernels[q].init_raw_params()
            if kp:
                kernel_params["q%d" % q] = kp
        return {
            "coreg_vecs": coreg_vecs,
            "coreg_diags": coreg_diags,
            "kernels": kernel_params,
            "noise": np.asarray(POSITIVE.inverse(0.1 * np.ones(self.D))),
        }

    # ---------------------------------------------------------- evaluation

    @staticmethod
    def _like(raw_params):
        return raw_params["noise"]

    def coreg_vec(self, raw_params, q):
        """A_q as an (r_q, D) tensor (fixed zeros for indep kernels)."""
        if self.kinds[q] == "indep":
            like = self._like(raw_params)
            return torch.zeros(
                (1, self.D), dtype=like.dtype, device=like.device
            )
        return raw_params["coreg_vecs"]["q%d" % q]

    def coreg_diag(self, raw_params, q):
        """kappa_q as a (D,) tensor (constrained; fixed for slfm/indep)."""
        kind = self.kinds[q]
        like = self._like(raw_params)
        if kind == "lmc":
            return POSITIVE.forward(raw_params["coreg_diags"]["q%d" % q])
        if kind == "slfm":
            return torch.zeros(self.D, dtype=like.dtype, device=like.device)
        basis = np.zeros(self.D)
        basis[self.indep_idx[self._indep_pos(q)]] = 1.0
        return torch.as_tensor(basis, dtype=like.dtype, device=like.device)

    def _indep_pos(self, q):
        return [i for i, k in enumerate(self.kinds) if k == "indep"].index(q)

    def coreg_mats(self, raw_params, idxs=None):
        """B_q = A_q^T A_q + diag(kappa_q), stacked (|idxs|, D, D)."""
        if idxs is None:
            idxs = range(self.Q)
        mats = []
        for q in idxs:
            a = self.coreg_vec(raw_params, q)
            mats.append(a.T @ a + torch.diag(self.coreg_diag(raw_params, q)))
        return torch.stack(mats)

    def noise(self, raw_params):
        """Constrained per-output noise vector epsilon (D,)."""
        return POSITIVE.forward(raw_params["noise"])

    def eval_kernel(self, raw_params, q, dists):
        kp = raw_params["kernels"].get("q%d" % q, {})
        return self.kernels[q].from_dist(kp, dists)

    def eval_kernels_stacked(self, raw_params, dists, idxs):
        """Stacked k_q(dists) for kernel indices ``idxs`` — (|idxs|, ...),
        from their table rows."""
        return eval_table(*self.table_rows(raw_params, idxs), dists)

    def table_rows(self, raw_params, idxs):
        """Kernel K1's slice of the kernel table: the kind codes of the
        kernels ``idxs`` as a tuple of ints, and their constrained
        ``[gamma, period, scale]`` as a (|idxs|, 3) tensor, stacked row
        by row (no index tensor, whose backward would accumulate with
        atomics)."""
        like = self._like(raw_params)
        kinds, rows = [], []
        for q in idxs:
            kp = raw_params["kernels"].get("q%d" % q, {})
            kind, row = self.kernels[q].table_row(kp, like)
            kinds.append(kind)
            rows.append(row)
        return tuple(kinds), torch.stack(rows)

    def kernel_table(self, raw_params):
        """The cross-kernel table: ``(kinds, dim_masks, params)`` with
        per-q int32 kind codes, int32 bitmasks of active input dims and
        an (Q, 3) tensor of constrained ``[gamma, period, scale]``
        (hopper/cross.py)."""
        kinds, prm = self.table_rows(raw_params, range(self.Q))
        masks = [sum(1 << int(p) for p in k.active_dims)
                 for k in self.kernels]
        dev = prm.device
        return (
            torch.as_tensor(kinds, dtype=torch.int32, device=dev),
            torch.as_tensor(masks, dtype=torch.int32, device=dev),
            prm,
        )
