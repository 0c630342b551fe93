"""All-to-all (DeepSpeed-Ulysses-style) sequence parallelism.

The port of metaflow_tpu/ops/ulysses_attention.py, the other long-context
layout beside ring attention: instead of streaming K/V blocks around a
ring, all-to-alls re-shard the activations from sequence-sharded to
HEAD-sharded, each rank runs ordinary full attention over the ENTIRE
sequence for H/n of the heads, and a final all-to-all restores the
sequence sharding (four all-to-alls: q, k, v in, the output out; k and v
cross at their GQA width). The head count must divide by the ring's size.

The inner attention is `attention()`: on a CUDA tensor the flash kernels
(K1 forward, K2 and K3 backward) at the full sequence length, which must
meet their block contract; on a CPU tensor the plain path.

The transport is the `mesh` argument, one of ring_attention's sequence
meshes:
- `LocalRing(n)`: n sequence shards of global [B, S, ...] tensors on the
  calling device. The all-to-all of its shards is a regrouping of one
  tensor: rank j's head-sharded block is the global tensor's j-th group
  of heads (a view), and the output's sequence shards joined are the
  groups' outputs joined along the heads.
- `ProcessGroupRing(group)`: one sequence shard per rank of a
  torch.distributed process group; each all-to-all is
  `all_to_all_single`, whose gradient is the same exchange back.
"""

import torch
import torch.distributed as dist

from .attention import attention
from .ring_attention import LocalRing, _Ring


def _widen_kv_minimal(x, n_heads, n):
    """Repeat K/V heads to the SMALLEST count that (a) splits over the
    ring and (b) still divides the query head count per rank (so the
    inner attention's GQA broadcast stays valid)."""
    kv = x.shape[2]
    reps = 1
    while ((kv * reps) % n or n_heads % (kv * reps)) \
            and kv * reps < n_heads:
        reps += 1
    if reps == 1:
        return x
    return torch.repeat_interleave(x, reps, dim=2)


class _AllToAll(torch.autograd.Function):
    """all_to_all_single over a ProcessGroupRing on x [n, ...]: slice i
    goes to rank i, and slice i of the result came from rank i. Its
    gradient is the same exchange of the output gradient."""

    @staticmethod
    def forward(ctx, ring, x):
        ctx.ring = ring
        return _exchange(ring, x)

    @staticmethod
    def backward(ctx, g):
        return None, _exchange(ctx.ring, g)


def _exchange(ring, x):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ring.group)
    return out


def _seq_to_heads(ring, x):
    """[B, S/n, h, D] on each rank -> [B, S, h/n, D]: rank j keeps head
    group j of every rank's sequence shard, joined in rank order."""
    n = ring.size
    B, s, h, D = x.shape
    parts = x.reshape(B, s, n, h // n, D).permute(2, 0, 1, 3, 4)
    got = _AllToAll.apply(ring, parts)
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * s, h // n, D)


def _heads_to_seq(ring, x):
    """[B, S, h/n, D] -> [B, S/n, h, D]: the inverse exchange."""
    n = ring.size
    B, S, hn, D = x.shape
    parts = x.reshape(B, n, S // n, hn, D).permute(1, 0, 2, 3, 4)
    got = _AllToAll.apply(ring, parts)
    return got.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * hn, D)


def _inner_impl(impl, on_cuda):
    """'auto' is the flash path on a CUDA tensor (a sequence the kernels
    cannot take raises) and attention()'s own choice on a CPU one."""
    if impl == "auto" and on_cuda:
        return "flash"
    return impl


def ulysses_attention(q, k, v, mesh, axis_name="sequence", causal=True,
                      scale=None, impl="auto"):
    """Attention over a sequence split into `mesh.size` shards by
    all-to-alls: q [B, S, H, D], k, v [B, S, KV, D] (KV divides H), whole
    sequences on a `LocalRing`, the rank's own shard on a
    `ProcessGroupRing`. Returns the output in q's layout and dtype.

    impl: the inner attention's ('auto' | 'flash' | 'flash_interpret' |
    'xla'); 'auto' takes the flash kernels on a CUDA tensor and the plain
    path on a CPU one."""
    if not isinstance(mesh, _Ring):
        raise ValueError("Ulysses attention needs a LocalRing or "
                         "ProcessGroupRing mesh, got %r" % (mesh,))
    n = mesh.size if axis_name in mesh.axis_names else 1
    impl = _inner_impl(impl, q.is_cuda)

    def inner(q, k, v):
        return attention(q, k, v, causal=causal, scale=scale, impl=impl)

    if n == 1:
        return inner(q, k, v)
    H = q.shape[2]
    if H % n:
        raise ValueError(
            "Ulysses needs heads %% mesh axis == 0 (H=%d, %s=%d); "
            "use ring_attention for indivisible head counts"
            % (H, axis_name, n))
    kw = _widen_kv_minimal(k, H, n)
    vw = _widen_kv_minimal(v, H, n)
    if isinstance(mesh, LocalRing):
        mesh.local_len(q.shape[1])  # the sequence must split into n shards
        outs = [inner(*group) for group in zip(
            *(t.split(t.shape[2] // n, dim=2) for t in (q, kw, vw)))]
        return torch.cat(outs, dim=2)
    out = inner(_seq_to_heads(mesh, q), _seq_to_heads(mesh, kw),
                _seq_to_heads(mesh, vw))
    return _heads_to_seq(mesh, out)
