"""The collectives of the mesh layouts: what GSPMD inserts in the JAX
package, written as autograd functions on ``dist.all_gather`` (the list
form, which NCCL and Gloo both take on CUDA tensors).

- :func:`group_sum`: the sum over a group, in rank order (a gather,
  then a fixed-order sum on every rank, so that every rank holds the
  same bits whatever the backend's reduction order);
- :func:`gather_last`: the concatenation along the last axis of each
  rank's slice (slices may differ in width by one: they are padded to
  the widest for the transfer);
- :func:`gather_rows`: the same along the first axis;
- :func:`shared`: a replicated value that a rank uses on its own rows
  or range only (the identity forward).

Gradients across ranks. Every rank computes the same replicated loss, so
the backward of the three joins sums the cotangents over the group (the
sum is the adjoint of the broadcast that a replicated value is), and the
model averages its flat parameter gradient over the mesh once a step
(:func:`mesh_mean`), as DDP does. A rank-local value (a rank's rows, its
Fourier range) then carries its share of the cotangent times the group
size, and a replicated one the whole cotangent: where a replicated value
feeds a rank-local use, :func:`shared`'s backward takes the mean of the
ranks' cotangents, which is the whole cotangent again. So every
replicated backward (the factorizations' VJPs, K8's, the symbol's FFT)
sees the whole cotangent, as the single process's does: applying an
ill-conditioned float32 backward to each rank's share and summing after
would lose the shares' cancellation.

Without a process group (``group=None``) every function is the
identity.
"""

import torch
import torch.distributed as dist
from torch.profiler import record_function

# the profiler range around every transfer (chip_smoke.py reads the
# device time of the collectives from it)
RANGE = "runlmc.collective"


def _all_gather(x, group):
    """Every group rank's ``x`` (the same shape on every rank), in group
    rank order."""
    x = x.contiguous()
    dtype = x.dtype
    t = x
    if t.is_complex():
        t = torch.view_as_real(t)
    elif dtype == torch.bool:
        t = t.to(torch.uint8)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    with record_function(RANGE):
        dist.all_gather(parts, t, group=group)
    if dtype.is_complex:
        return [torch.view_as_complex(p) for p in parts]
    if dtype == torch.bool:
        return [p.to(torch.bool) for p in parts]
    return parts


def _ordered_sum(parts):
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _sum(x, group):
    return _ordered_sum(_all_gather(x, group))


def _gather(x, group, sizes, dim):
    """Concatenate each rank's slice along ``dim`` (sizes per rank)."""
    n = max(sizes)
    if x.shape[dim] < n:
        pad = list(x.shape)
        pad[dim] = n - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    parts = _all_gather(x, group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim=dim)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, sizes, dim):
        ctx.group, ctx.sizes, ctx.dim = group, sizes, dim
        return _gather(x, group, sizes, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        lo = sum(ctx.sizes[:r])
        total = _sum(g, ctx.group)
        return (total.narrow(ctx.dim, lo, ctx.sizes[r]).contiguous(), None,
                None, None)


class _Shared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group) / dist.get_world_size(ctx.group), None


def shared(x, group):
    """``x``, a value every rank of ``group`` holds, as this rank uses it
    on its own rows or range: the identity forward; the backward is the
    mean of the group's cotangents (each rank's share times the group
    size)."""
    if group is None:
        return x
    return _Shared.apply(x, group)


def group_sum(x, group):
    """The sum of ``x`` over ``group``, the same bits on every rank;
    differentiable (the backward sums the cotangents)."""
    if group is None:
        return x
    return _GroupSum.apply(x, group)


def _check(x, group, sizes, dim):
    r = dist.get_rank(group)
    if len(sizes) != dist.get_world_size(group) or x.shape[dim] != sizes[r]:
        raise ValueError("gather: rank %d holds %d of %s along axis %d"
                         % (r, x.shape[dim], list(sizes), dim))


def gather_last(x, group, sizes):
    """The concatenation along the last axis of every rank's ``x``,
    rank r holding ``sizes[r]`` entries; differentiable (the backward
    sums the cotangent over the group, then keeps this rank's slice)."""
    if group is None:
        return x
    sizes = tuple(int(s) for s in sizes)
    _check(x, group, sizes, x.ndim - 1)
    return _Gather.apply(x, group, sizes, x.ndim - 1)


def gather_rows(x, group, sizes):
    """The concatenation along the first axis of every rank's ``x``,
    rank r holding ``sizes[r]`` rows; differentiable as
    :func:`gather_last`."""
    if group is None:
        return x
    sizes = tuple(int(s) for s in sizes)
    _check(x, group, sizes, 0)
    return _Gather.apply(x, group, sizes, 0)


def mesh_mean(x, mesh):
    """The mean of ``x`` over every rank of ``mesh`` (no gradient): the
    once-a-step average of the flat parameter gradient. The identity
    without a mesh or a process group."""
    group = None if mesh is None else mesh.group()
    if group is None:
        return x
    with torch.no_grad():
        return _sum(x, group) / mesh.size
