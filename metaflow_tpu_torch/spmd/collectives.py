"""The collectives a mesh step runs, on plain local tensors: all-gather
and reduce-scatter along any dimension, an in-place all-reduce, and the
parameter gather of FSDP as an autograd Function (all-gather forward,
reduce-scatter backward).

Each takes a process group (a mesh axis's, `Mesh.group`) and is the
identity on a group of one rank, so a one-card mesh runs no collective.
NCCL moves CUDA tensors and gloo CPU tensors, as the gang's group is set
up (plugins/gpu/gpu_parallel.py).
"""

import torch
import torch.distributed as dist

# torch 2.12 renamed the single-tensor collectives; the chip machine's
# torch has the older names only
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def all_gather(x, dim, group):
    """The blocks of every rank of `group`, joined along `dim` in rank
    order."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_single(out, x, group=group)
    if dim == 0:
        return out
    # the blocks stacked on a new leading axis, then moved next to `dim`
    return out.view((n,) + tuple(x.shape)).movedim(0, dim).flatten(
        dim, dim + 1).contiguous()


def reduce_scatter(x, dim, group):
    """x summed over the ranks of `group`, this rank's block along `dim`
    kept."""
    n = group_size(group)
    if n == 1:
        return x
    parts = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    parts = parts.contiguous()
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    _reduce_scatter_single(out, parts.flatten(0, 1), group=group)
    return out


def all_reduce(x, group):
    """x summed over the ranks of `group`, in place."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


class _GatherShards(torch.autograd.Function):
    """A weight whole from its shards: all-gather in the forward pass; the
    backward pass sums the whole gradient over the ranks and keeps this
    rank's block (reduce-scatter), so each rank's gradient is its shard's
    over the whole batch."""

    @staticmethod
    def forward(ctx, x, dims):
        ctx.dims = dims
        for dim, group in reversed(dims):
            x = all_gather(x, dim, group)
        return x

    @staticmethod
    def backward(ctx, grad):
        for dim, group in ctx.dims:
            grad = reduce_scatter(grad, dim, group)
        return grad, None


def gather_shards(x, dims):
    """x's block made whole along each (dim, group) of `dims` (major axis
    first), differentiably; x itself when `dims` is empty."""
    if not dims:
        return x
    return _GatherShards.apply(x, tuple(dims))
