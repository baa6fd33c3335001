"""Device-mesh helpers on ``torch.distributed`` (parity:
runlmc_tpu/parallel/mesh.py:21-59).

The JAX package runs one SPMD program over a device mesh and lets GSPMD
insert the collectives. The port runs one process per rank, each with
its own device, and names its layouts with a small :class:`Mesh` of
ranks: its axes, this rank's position on each axis, and the process
group of this rank's line along each axis (and of the whole mesh).

The embarrassingly parallel axis of LMC inference is the solve batch
(the observation vector and the Hutchinson probes): its rows shard over
the first non-'grid' axis ('probe'), each rank solving its rows
(``lmc.likelihood.sharded_solve``); the exact objective shards its data
rows over the same axis. A second axis, 'grid', shards the Fourier axis
of fft-mode grid matvecs (``lmc.grid.GridPlan.grid_shard``).

Without a started process group a mesh holds this process alone, and
every collective is the identity, as JAX's single-host mode is.
"""

import dataclasses
import os
from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist


def shard_sizes(n, parts):
    """The sizes of ``parts`` contiguous slices of ``n`` items, the first
    ``n % parts`` one longer (``numpy.array_split``'s split)."""
    n, parts = int(n), int(parts)
    base, extra = divmod(n, parts)
    return tuple(base + (i < extra) for i in range(parts))


def shard_range(n, parts, index):
    """``(lo, hi)`` of slice ``index`` of :func:`shard_sizes`."""
    sizes = shard_sizes(n, parts)
    lo = sum(sizes[:index])
    return lo, lo + sizes[index]


def _world():
    """(rank, world size) of the running process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def rank_device(rank=None):
    """The device of a rank: CUDA device ``LOCAL_RANK`` (else the rank)
    modulo the visible card count, or the CPU without a card."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if rank is None:
        rank = int(os.environ.get("LOCAL_RANK", _world()[0]))
    return torch.device("cuda", int(rank) % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out over named axes.

    ``devices`` is an ndarray of global ranks (``devices.size`` is the
    rank count), ``shape`` maps each axis to its size (as JAX's
    ``mesh.shape["grid"]``), ``device`` is this rank's device.
    :meth:`group` is the process group of this rank's line along an axis
    (of the whole mesh with no axis), ``None`` without a started
    process group; :meth:`index` is this rank's position on an axis.
    Build it with :func:`make_mesh` (or the constructors below), the
    same call on every rank: the groups are made collectively."""

    devices: Any
    axis_names: Tuple[str, ...]
    device: Any
    rank: int = 0
    groups: Any = dataclasses.field(default_factory=dict, repr=False)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def _coords(self):
        where = np.argwhere(self.devices == self.rank)
        if not len(where):
            raise ValueError("rank %d is not in the mesh %s"
                             % (self.rank, self.devices.tolist()))
        return tuple(int(c) for c in where[0])

    def index(self, axis):
        """This rank's position on ``axis``."""
        return self._coords()[self.axis_names.index(axis)]

    def group(self, axis=None):
        """The process group of this rank's line along ``axis`` (of the
        whole mesh for ``None``); ``None`` without a process group."""
        if axis is not None and axis not in self.axis_names:
            raise ValueError("no axis %r in the mesh %s"
                             % (axis, self.axis_names))
        return self.groups.get(axis)


def make_mesh(ranks, axis_names):
    """A :class:`Mesh` over the global ``ranks`` (an ndarray with one
    dimension per axis name). With a started process group every rank
    must make the same call: the groups of the whole mesh and of each
    axis's lines are made with ``dist.new_group`` in one fixed order (the
    mesh, then each axis in turn, its lines in C order), since
    ``new_group`` is collective and another order deadlocks."""
    from runlmc_tpu_torch.parallel import launcher

    ranks = np.asarray(ranks, dtype=np.int64)
    axis_names = tuple(axis_names)
    if ranks.ndim != len(axis_names):
        raise ValueError("%d axis names for a %d-D array of ranks"
                         % (len(axis_names), ranks.ndim))
    rank, world = _world()
    if ranks.size and (ranks.min() < 0 or ranks.max() >= world):
        raise ValueError("mesh ranks %s outside the %d running ranks"
                         % (ranks.tolist(), world))
    groups = {}
    if dist.is_available() and dist.is_initialized():
        timeout = launcher.group_timeout()

        def new(line):
            line = [int(r) for r in line]
            g = dist.new_group(line, timeout=timeout)
            return g if rank in line else None

        groups[None] = new(ranks.ravel())
        for i, ax in enumerate(axis_names):
            lines = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
            for line in lines:
                g = new(line)
                if g is not None:
                    groups[ax] = g
    return Mesh(devices=ranks, axis_names=axis_names, device=rank_device(),
                rank=rank, groups=groups)


def _first_ranks(count, what):
    _, world = _world()
    if count > world:
        raise ValueError("%s needs %d ranks, %d are running"
                         % (what, count, world))
    return np.arange(count)


def default_mesh(n_devices=None, axis_name="probe"):
    """1-D mesh over the first ``n_devices`` ranks of the running group
    (all of them by default; this process alone without a group)."""
    _, world = _world()
    n = world if n_devices is None else min(int(n_devices), world)
    return make_mesh(np.arange(n), (axis_name,))


def probe_grid_mesh(n_probe, n_grid):
    """2-D mesh ('probe', 'grid') over the first ``n_probe * n_grid``
    ranks: the solve/probe batch shards over 'probe'; fft-mode grid
    matvecs shard their Fourier axis over 'grid' (consecutive ranks)."""
    ranks = _first_ranks(n_probe * n_grid, "probe_grid_mesh(%d, %d)"
                         % (n_probe, n_grid))
    return make_mesh(ranks.reshape(n_probe, n_grid), ("probe", "grid"))


def pad_batch(b, n_shards):
    """Pad the leading axis of ``b`` (numpy) with zero rows to a multiple
    of ``n_shards`` (zero RHS rows solve instantly to zero and are
    sliced off by the caller)."""
    B = b.shape[0]
    rem = (-B) % n_shards
    if rem == 0:
        return b, B
    pad = np.zeros((rem,) + b.shape[1:], dtype=b.dtype)
    return np.concatenate([b, pad], axis=0), B


def shard_batch(b, mesh, axis_name="probe"):
    """This rank's rows of the (B, ...) array ``b`` on its device: the
    slice :func:`shard_range` gives its position on ``axis_name``."""
    b = torch.as_tensor(b)
    lo, hi = shard_range(b.shape[0], mesh.shape[axis_name],
                         mesh.index(axis_name))
    return b[lo:hi].to(mesh.device)


def replicated(x, mesh):
    """``x`` on this rank's device (every rank holds all of it)."""
    return torch.as_tensor(x).to(mesh.device)
