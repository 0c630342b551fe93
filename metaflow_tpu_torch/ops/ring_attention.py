"""Ring attention: causal attention over a sequence split into shards.

The port of metaflow_tpu/ops/ring_attention.py. The sequence of [B, S, H, D]
queries and [B, S, KV, D] keys and values is cut into n shards along S; in
n hops, every shard's queries meet every shard's keys and values, which
move one rank along the ring after each hop, and an online softmax merges
the hops' contributions.

Two inner blocks, as in the JAX package:
- 'flash': a hop is `flash_block_fwd` (the Hopper kernel K4, unnormalized,
  with its row max m and denominator l), merged in plain PyTorch. The
  backward is a second ring pass (`_RingFlash`, the JAX custom_vjp): per
  live hop `flash_block_bwd` (K2, K3) with the GLOBAL lse and delta, which
  make every hop's probabilities exact; dq sums at home, and the f32 dk, dv
  sums travel with their k, v block and arrive home after n hops.
- 'xla': per hop plain einsum attention with position masks
  (`_block_attn`), differentiated by autograd.

A hop's source shard is my own (diagonal mask), an earlier one (every key
counts) or a later one (skipped under causality), so the kernels take no
offsets. The ring body is written once; what moves a hop's tensors to the
next rank is the transport, the `mesh` argument:
- `LocalRing(n)`: n shards of global tensors held on the calling device,
  all advanced in lock step; a hop's send rotates a list of references
  (shards are views; nothing is copied). The one-device counterpart of the
  virtual CPU mesh on which the JAX package runs its ring.
- `ProcessGroupRing(group)`: one shard per rank of a torch.distributed
  process group; a hop's send is `batch_isend_irecv` to rank + 1 and from
  rank - 1 (differentiable, for the 'xla' block).
"""

import math

import torch
import torch.distributed as dist

from .attention import (BLOCK_K, BLOCK_Q, NEG_INF, _broadcast_gqa,
                        _kernel_layout, blocks_aligned, flash_block_bwd,
                        flash_block_fwd, flash_block_output, per_row)

RING_IMPLS = ("flash", "xla")


class _Ring:
    """What the ring body needs of a transport: the ring's size, the ranks
    whose shards this caller holds, how a held tensor splits into those
    shards and joins back, and `shift`."""

    axis_names = ("sequence",)  # the JAX mesh axis a ring stands for

    def shift(self, held):
        """Send each held rank's tuple of tensors to rank + 1; returns what
        each held rank receives from rank - 1, in `ranks` order."""
        raise NotImplementedError


class LocalRing(_Ring):
    """n sequence shards of global [B, S, ...] tensors on the calling
    device: the ring's every rank is held here."""

    def __init__(self, n):
        if n < 1:
            raise ValueError("a ring needs at least one shard, got %d" % n)
        self.size = n
        self.ranks = tuple(range(n))

    def __repr__(self):
        return "LocalRing(%d)" % self.size

    def local_len(self, S):
        if S % self.size:
            raise ValueError("sequence length %d does not split into %d "
                             "ring shards" % (S, self.size))
        return S // self.size

    def split(self, t):
        return list(torch.split(t, self.local_len(t.shape[1]), dim=1))

    def join(self, parts):
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def shift(self, held):
        n = self.size
        return [held[(j - 1) % n] for j in range(n)]


class ProcessGroupRing(_Ring):
    """One sequence shard per rank of a torch.distributed process group
    (None: the default group); tensors given to the ring are the rank's
    own shard."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = (self.rank,)

    def __repr__(self):
        return "ProcessGroupRing(rank %d of %d)" % (self.rank, self.size)

    def local_len(self, S):
        return S

    def split(self, t):
        return [t]

    def join(self, parts):
        return parts[0]

    def shift(self, held):
        return [_GroupShift.apply(self, *held[0])]

    def _peer(self, offset):
        r = (self.rank + offset) % self.size
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def send_recv(self, tensors, step):
        """Send `tensors` to rank + step and receive as many from
        rank - step."""
        if self.size == 1:
            return list(tensors)
        tensors = [t.contiguous() for t in tensors]
        out = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, o in zip(tensors, out):
            ops.append(dist.P2POp(dist.isend, t, self._peer(step),
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, o, self._peer(-step),
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class _GroupShift(torch.autograd.Function):
    """A hop's send over a process group; its gradient goes back the other
    way (lax.ppermute's transpose)."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(ring.send_recv(tensors, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.ring.send_recv(grads, -1))


def _ring_branch_index(src, my_idx):
    """0 = diagonal (own shard: causal mask), 1 = full (earlier shard),
    2 = skip (later shard contributes nothing under causality)."""
    return 0 if src == my_idx else (1 if src < my_idx else 2)


def _merge(run, hop, B, H):
    """Merge a hop's (acc, m, l) into the running ones (the JAX ring's
    online-softmax combine)."""
    acc, m, l = run
    acc_b, m_b, l_b = hop
    m_new = torch.maximum(m, m_b)
    c_run = torch.exp(m - m_new)
    c_b = torch.exp(m_b - m_new)
    l_new = l * c_run + l_b * c_b
    acc = acc * per_row(c_run, B, H) + acc_b * per_row(c_b, B, H)
    return acc, m_new, l_new


def _ring_forward(ring, q, k, v, block):
    """The ring body's forward pass. Per hop, each held shard's
    block(q, k, v, my rank, source rank) -> (acc [B, S, H, D] f32, m, l
    [B*H, S]) or None (skipped) is merged into its running sums; k and v
    move on after every hop but the last. The first hop (the shard's own
    keys) starts the sums, as the JAX ring's merge into zeros and m = -1e30
    does exactly. Returns each held shard's (acc, m, l)."""
    B, _, H, _ = q.shape
    n = ring.size
    qs = ring.split(q)
    kv = list(zip(ring.split(k), ring.split(v)))
    run = [None] * len(qs)
    for r in range(n):
        for j, my in enumerate(ring.ranks):
            hop = block(qs[j], kv[j][0], kv[j][1], my, (my - r) % n)
            if hop is not None:
                run[j] = hop if run[j] is None else _merge(run[j], hop, B, H)
        if r + 1 < n:
            kv = ring.shift(kv)
    return run


def _ring_backward(ring, qs, ks, vs, gs, lses, deltas, causal, scale, bwd):
    """The ring body's backward pass (flash only): per live hop,
    bwd(q, k, v, g, lse, delta, scale, diag) -> f32 (dq, dk, dv) with the
    global lse and delta. dq sums at home; dk, dv sum into the buffers that
    travel with their k, v block, and one shift after the last hop (the
    n-th) takes them home. Returns each held shard's (dq, dk, dv)."""
    n = ring.size
    dq = [None] * len(qs)
    state = [(k, v, None, None) for k, v in zip(ks, vs)]
    for r in range(n):
        for j, my in enumerate(ring.ranks):
            k, v, dk, dv = state[j]
            branch = _ring_branch_index((my - r) % n, my) if causal else 1
            if branch != 2:
                dq_b, dk_b, dv_b = bwd(qs[j], k, v, gs[j], lses[j],
                                       deltas[j], scale, branch == 0)
                dq[j] = dq_b if dq[j] is None else dq[j].add_(dq_b)
                dk = dk_b if dk is None else dk.add_(dk_b)
                dv = dv_b if dv is None else dv.add_(dv_b)
            state[j] = (k, v, dk, dv)
        if r + 1 < n:
            state = ring.shift(state)
    # only the gradient sums take the last hop home
    home = ring.shift([(dk, dv) for _, _, dk, dv in state])
    return [(dq[j],) + tuple(home[j]) for j in range(len(qs))]


def _flash_block(causal, scale, fwd):
    """The flash inner block: diagonal, full or skipped by the source."""
    def block(q, k, v, my, src):
        branch = _ring_branch_index(src, my) if causal else 1
        if branch == 2:
            return None
        return fwd(q, k, v, scale, branch == 0)

    return block


def _delta(g, out):
    """rowsum(dO * O) in f32 as [B*H, S], contiguous."""
    B, S, H, _ = g.shape
    return (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, S).contiguous()


class _RingFlash(torch.autograd.Function):
    """The flash ring with its gradient (the JAX `_ring_flash` custom_vjp):
    the forward saves q, k, v, O and each shard's lse = m + log l; the
    backward runs the ring backward and casts the f32 gradients to the
    input dtypes once. The kernels' wrappers launch K4 and K2/K3 on CUDA
    tensors and run their plain versions on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        outs, lses = [], []
        for acc, m, l in _ring_forward(
                ring, q, k, v, _flash_block(causal, scale, flash_block_fwd)):
            outs.append(flash_block_output(acc, l).to(q.dtype))
            lses.append(m + torch.log(l))
        out = ring.join(outs)
        ctx.save_for_backward(q, k, v, out, *lses)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, out, *lses = ctx.saved_tensors
        ring = ctx.ring
        if g.is_cuda:
            g = _kernel_layout(g)
        gs, outs = ring.split(g), ring.split(out)
        deltas = [_delta(gj, oj) for gj, oj in zip(gs, outs)]
        grads = _ring_backward(ring, ring.split(q), ring.split(k),
                               ring.split(v), gs, lses, deltas, ctx.causal,
                               ctx.scale, flash_block_bwd)
        dq, dk, dv = (ring.join(list(t)) for t in zip(*grads))
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _block_attn(q, k, v, scale, q_offset, k_offset, causal):
    """One blockwise attention contribution and its online-softmax stats
    (the 'xla' inner block). q [B, Sq, H, D], k, v [B, Sk, KV, D], the GQA
    repeat after the hop. Returns (unnormalized out [B, Sq, H, D] f32,
    m and l [B*H, Sq])."""
    B, Sq, H, _ = q.shape
    k = _broadcast_gqa(k, H)
    v = _broadcast_gqa(v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)[None]
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out, m.reshape(B * H, Sq), l.reshape(B * H, Sq)


def _ring_xla(q, k, v, ring, causal, scale):
    """The ring with the einsum inner block: every hop computed and masked
    by positions (a later shard's hop merges with weight 0)."""
    S_local = ring.local_len(q.shape[1])

    def block(qj, kj, vj, my, src):
        return _block_attn(qj, kj, vj, scale, my * S_local, src * S_local,
                           causal)

    return ring.join([flash_block_output(acc, l).to(q.dtype)
                      for acc, m, l in _ring_forward(ring, q, k, v, block)])


def _resolve_impl(impl, S_local, on_cuda):
    """'auto' is the flash ring on a CUDA tensor, where a shard the
    kernels cannot take raises, and the einsum ring on a CPU one (the JAX
    package's choice off the TPU)."""
    if impl == "auto":
        impl = "flash" if on_cuda else "xla"
    if impl not in RING_IMPLS:
        raise ValueError("ring attention impl must be auto or one of %s, "
                         "got %r" % (RING_IMPLS, impl))
    # the predicate flash_block_fwd / bwd enforce
    if impl == "flash" and not blocks_aligned(S_local):
        # the flash ring must not drop the unaligned tail
        raise ValueError(
            "ring flash attention needs the per-device sequence shard "
            "(%d) to be a multiple of both block sizes (q=%d, k=%d via "
            "TPUFLOW_FLASH_BLOCK_Q/K), with one block dividing the "
            "other; use impl='xla' or pad the sequence"
            % (S_local, min(BLOCK_Q, S_local), min(BLOCK_K, S_local)))
    return impl


def ring_attention(q, k, v, mesh, causal=True, scale=None, impl="auto"):
    """Attention over a sequence split into `mesh.size` shards: q
    [B, S, H, D], k, v [B, S, KV, D] (KV divides H), whole sequences on a
    `LocalRing`, the rank's own shard on a `ProcessGroupRing`. Returns the
    output in q's layout and dtype.

    impl: 'auto' | 'flash' | 'xla'; 'auto' takes 'flash' on a CUDA tensor
    and 'xla' on a CPU one. 'flash' launches K4 and K2/K3 on a CUDA tensor
    and runs their plain versions on a CPU one; its shard must meet
    blocks_aligned."""
    if not isinstance(mesh, _Ring):
        raise ValueError("ring attention needs a LocalRing or "
                         "ProcessGroupRing mesh, got %r" % (mesh,))
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or H % k.shape[2]:
        raise ValueError("ring attention: bad shapes q %s k %s v %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    S_local = mesh.local_len(S)
    scale = scale or (1.0 / math.sqrt(D))
    chosen = _resolve_impl(impl, S_local, q.is_cuda)
    if chosen == "xla":
        return _ring_xla(q, k, v, mesh, causal, scale)
    return _RingFlash.apply(q, k, v, mesh, causal, scale)
