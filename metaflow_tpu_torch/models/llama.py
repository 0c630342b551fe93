"""Llama-family transformer in PyTorch: forward, loss and remat.

Parameters are a plain dict of tensors with the JAX package's names and
layout: per-layer weights stacked on a leading [L] axis, projections stored
[in, out] and applied as `h @ w`. The layer stack is a Python loop over
that axis; with cfg.remat each layer runs under torch.utils.checkpoint, as
the JAX package wraps its scanned layer in jax.checkpoint, with the
reference's remat policies.

On a mesh (spmd.Mesh) the parameters are DTensors placed by the rule
table of `logical_axes` (training.make_train_state), and each rank runs
its rows of the batch: a weight the table shards is gathered whole just
before the layer uses it (inside the layer's checkpoint, so the backward
pass gathers it again and frees it after), its gradient reduce-scattered
back to the shard, and the loss is the mean over every rank's tokens.
"""

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..ops.attention import attention
from ..ops.matmul import matmul_f32
from ..ops.norms import rms_norm
from ..ops.ring_attention import LocalRing, ring_attention
from ..ops.rope import apply_rope, rope_frequencies
from ..ops.ulysses_attention import ulysses_attention
from ..spmd.collectives import all_reduce, gather_shards
from ..spmd.device import resolve_device
from ..spmd.mesh import Mesh, batch_group, batch_sharding
from ..spmd.sharding import Layout, entry_axes, spec_of


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    rope_llama3_scaling: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attention_impl: str = "auto"
    remat: bool = True
    # None recomputes the whole layer in the backward pass; "dots" keeps
    # the outputs of its products (less recompute, more memory); "attn_out"
    # keeps the attention's output (REMAT_POLICIES, _remat_layer)
    remat_policy: str = None
    # cross-entropy chunk length (tokens): the [B, chunk, vocab] f32 logits
    # are computed, and recomputed in the backward pass, one chunk at a
    # time. 0 = unchunked.
    loss_chunk: int = 256

    @property
    def head_dim(self):
        return self.dim // self.n_heads

    @staticmethod
    def llama3_8b(**kw):
        return replace(LlamaConfig(), **kw)

    @staticmethod
    def llama3_1b(**kw):
        """Llama-3.2-1B-shaped."""
        return replace(
            LlamaConfig(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                        ffn_dim=8192),
            **kw)

    @staticmethod
    def tiny(**kw):
        """Test-sized config (CPU-runnable)."""
        return replace(
            LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=256, max_seq_len=256,
                        rope_llama3_scaling=False, dtype="float32"),
            **kw)

    @staticmethod
    def bench_1b(**kw):
        """~1.2B params."""
        return replace(
            LlamaConfig(vocab_size=32_000, dim=2048, n_layers=16, n_heads=16,
                        n_kv_heads=8, ffn_dim=5632, max_seq_len=2048,
                        rope_llama3_scaling=False),
            **kw)


def param_dtype(cfg):
    return getattr(torch, cfg.dtype)


def check_params_device(params, device):
    where = params["embed"].device
    if where.type != device.type or device.index not in (None, where.index):
        raise ValueError("parameters live on %s, not on %s"
                         % (where, device))


def init_params(cfg, generator=None, device="cuda"):
    """Random parameters from a seeded torch.Generator, made on `device`
    (the generator must live there too; None seeds one with 0). Per-layer
    tensors are stacked on a leading 'layers' axis."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = param_dtype(cfg)
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.ffn_dim
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def norm_init(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def dense_init(fan_in, *shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w * fan_in ** -0.5).to(dt)

    return {
        "embed": dense_init(D, cfg.vocab_size, D),
        "layers": {
            "attn_norm": norm_init(L, D),
            "wq": dense_init(D, L, D, H * Hd),
            "wk": dense_init(D, L, D, KV * Hd),
            "wv": dense_init(D, L, D, KV * Hd),
            "wo": dense_init(H * Hd, L, H * Hd, D),
            "ffn_norm": norm_init(L, D),
            "w_gate": dense_init(D, L, D, F_),
            "w_up": dense_init(D, L, D, F_),
            "w_down": dense_init(F_, L, F_, D),
        },
        "final_norm": norm_init(D),
        "lm_head": dense_init(D, D, cfg.vocab_size),
    }


def logical_axes(cfg):
    """Logical axis names for every parameter (same tree structure)."""
    return {
        "embed": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("layers", "embed"),
            "wq": ("layers", "embed", "heads"),
            "wk": ("layers", "embed", "kv_heads"),
            "wv": ("layers", "embed", "kv_heads"),
            "wo": ("layers", "heads", "embed"),
            "ffn_norm": ("layers", "embed"),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def from_jax_params(np_params, cfg, device="cuda"):
    """The JAX package's parameter tree (leaves as numpy arrays, per-layer
    leaves stacked [L, ...]) as the port's parameters on `device`, in the
    config's dtype. Both packages store projections [in, out], so no
    transpose or split is needed."""
    device = resolve_device(device)
    dt = param_dtype(cfg)

    def conv(a):
        a = np.array(a, dtype=np.float32)  # a writable copy
        return torch.from_numpy(a).to(device=device, dtype=dt)

    return {
        "embed": conv(np_params["embed"]),
        "layers": {name: conv(a)
                   for name, a in np_params["layers"].items()},
        "final_norm": conv(np_params["final_norm"]),
        "lm_head": conv(np_params["lm_head"]),
    }


def num_params(params):
    n = 0
    for v in params.values():
        n += num_params(v) if isinstance(v, dict) else v.numel()
    return n


def layer_params(params, i):
    """Layer i's weights: views into the stacked tensors."""
    return {name: w[i] for name, w in params["layers"].items()}


def _gather_dims(p, mesh, stacked=False):
    """The (dim, group) pairs, major axis first, along which a DTensor
    parameter's block must be gathered to make it whole; for a stacked
    layer leaf, the dims of one layer's slice."""
    dims = []
    for dim, entry in enumerate(spec_of(p, mesh)):
        for axis in entry_axes(entry):
            if mesh.shape[axis] == 1:
                continue
            if stacked and dim == 0:
                raise NotImplementedError(
                    "a rule table that shards the stacked 'layers' axis "
                    "(ROADMAP.md, slice 5, pipelines)")
            dims.append((dim - stacked, mesh.group(axis)))
    return tuple(dims)


def _local_params(params, mesh):
    """(this rank's blocks of the parameters, the gather dims of each
    leaf): on a mesh each DTensor leaf becomes its local block
    (differentiably, so its gradient lands on the DTensor); without one
    the parameters and no dims."""
    if not isinstance(mesh, Mesh):
        return params, None
    local, dims = {}, {}
    for key, value in params.items():
        if key == "layers":
            local[key] = {n: w.to_local() for n, w in value.items()}
            dims[key] = {n: _gather_dims(w, mesh, stacked=True)
                         for n, w in value.items()}
        else:
            local[key] = value.to_local()
            dims[key] = _gather_dims(value, mesh)
    return local, dims


def _whole(lp, dims, names):
    """The named weights of lp made whole where the mesh shards them."""
    if dims is None:
        return lp
    return dict(lp, **{n: gather_shards(lp[n], dims[n]) for n in names})


def _rows(value, mesh, device):
    """This rank's rows of a batch array on a mesh: a DTensor's local
    block, or the block of a global array that every rank holds; the
    array itself without a mesh."""
    if hasattr(value, "to_local"):
        return value.to_local().to(device)
    value = torch.as_tensor(value, device=device)
    if isinstance(mesh, Mesh):
        value = Layout(mesh, batch_sharding(mesh), value.shape).local(value)
    return value


class _GlobalSum(torch.autograd.Function):
    """x summed over every rank of the batch; the backward pass hands the
    gradient to this rank's x unchanged, since each rank's parameter
    gradients are then summed over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _sequence_attention(cfg, q, k, v, mesh):
    """attention_impl 'ring' or 'ulysses' over the mesh's 'sequence' axis:
    'ring' rotates KV blocks (ops/ring_attention.py), 'ulysses' re-shards
    sequence to heads with all-to-alls and runs full-sequence attention
    per head group (ops/ulysses_attention.py). The model runs global
    arrays, so the mesh is a LocalRing: the shards of one sequence on this
    device, as the JAX model's global arrays are sharded only inside its
    attention."""
    if mesh is None or "sequence" not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            "attention_impl=%r needs a mesh with a 'sequence' axis passed "
            "to forward/loss_fn" % cfg.attention_impl)
    if not isinstance(mesh, LocalRing):
        raise NotImplementedError(
            "the model runs whole sequences; a ring of one shard per "
            "process (%r) needs positions and the loss per shard "
            "(ROADMAP.md, slice 5, multi-GPU: sequence shards per rank)"
            % (mesh,))
    if cfg.attention_impl == "ulysses":
        return ulysses_attention(q, k, v, mesh, causal=True)
    return ring_attention(q, k, v, mesh, causal=True)


ATTENTION_WEIGHTS = ("attn_norm", "wq", "wk", "wv")
FFN_WEIGHTS = ("wo", "ffn_norm", "w_gate", "w_up", "w_down")


def _attention(cfg, cos, sin, x, lp, mesh=None, dims=None):
    """The attention half of a block: its output [B, S, H, Hd] for x:
    [B, S, D]."""
    lp = _whole(lp, dims, ATTENTION_WEIGHTS)
    B, S, _ = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, H, Hd)
    k = (h @ lp["wk"]).reshape(B, S, KV, Hd)
    v = (h @ lp["wv"]).reshape(B, S, KV, Hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attention_impl in ("ring", "ulysses"):
        return _sequence_attention(cfg, q, k, v, mesh)
    return attention(q, k, v, causal=True, impl=cfg.attention_impl)


def _after_attention(cfg, x, attn, lp, dims=None):
    """The rest of a block: the output projection, the residual and the
    feed-forward half."""
    lp = _whole(lp, dims, FFN_WEIGHTS)
    B, S, _ = x.shape
    x = x + attn.reshape(B, S, -1) @ lp["wo"]
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["w_gate"])
    up = h @ lp["w_up"]
    return x + (gate * up) @ lp["w_down"]


def _layer(cfg, cos, sin, x, lp, mesh=None, dims=None):
    """One transformer block; x: [B, S, D]. `dims`: the gather dims of
    lp's sharded weights on a mesh."""
    return _after_attention(
        cfg, x, _attention(cfg, cos, sin, x, lp, mesh, dims), lp, dims)


def _tokens_on(tokens, device):
    return torch.as_tensor(tokens, device=device).long()


def _remat(fn, *args, **checkpoint_kw):
    """fn(*args), recomputed in the backward pass instead of keeping its
    intermediates when autograd records (jax.checkpoint with policy None,
    or the selective policy a context_fn gives); a plain call when it does
    not."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, **checkpoint_kw)
    return fn(*args)


def _save_products(ctx, op, *args, **kwargs):
    """jax.checkpoint_policies.dots_with_no_batch_dims_saveable: keep the
    output of every product without batch dims. `h @ w` of a [B, S, D]
    activation and a [D, N] weight reaches aten.mm; the attention's
    batched products (bmm) and everything else are recomputed."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = (None, "dots", "attn_out")


def _remat_layer(cfg, cos, sin, x, lp, mesh, dims=None):
    """One block under cfg.remat_policy, the JAX package's policies:
    None keeps only the block's input; "dots" also keeps the outputs of
    its products without batch dims (q, k, v, the output projection, gate,
    up and down); "attn_out" also keeps the attention's output, the block
    split there into two checkpoints. The backward pass recomputes
    everything else. The attention kernel K1 is no aten op, so every
    policy runs it again in the backward pass (for the lse its backward
    needs), as the reference's flash forward runs twice under each of its
    policies."""
    policy = cfg.remat_policy
    if policy is None:
        return _remat(_layer, cfg, cos, sin, x, lp, mesh, dims)
    if policy == "dots":
        return _remat(_layer, cfg, cos, sin, x, lp, mesh, dims,
                      context_fn=functools.partial(
                          create_selective_checkpoint_contexts,
                          _save_products))
    if policy == "attn_out":
        attn = _remat(_attention, cfg, cos, sin, x, lp, mesh, dims)
        return _remat(_after_attention, cfg, x, attn, lp, dims)
    raise ValueError("remat_policy=%r: the policies are %s"
                     % (policy, REMAT_POLICIES))


def _hidden_states(params, dims, tokens, cfg, device, mesh):
    """hidden_states on local parameter blocks and their gather dims."""
    tokens = _tokens_on(tokens, device)
    dt = param_dtype(cfg)
    embed = params["embed"] if dims is None else \
        gather_shards(params["embed"], dims["embed"])
    x = embed[tokens].to(dt)
    del embed
    cos, sin = rope_frequencies(
        cfg.head_dim, tokens.shape[1], cfg.rope_theta, dtype=dt,
        llama3_scaling=cfg.rope_llama3_scaling, device=device)
    ldims = None if dims is None else dims["layers"]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat:
            x = _remat_layer(cfg, cos, sin, x, lp, mesh, ldims)
        else:
            x = _layer(cfg, cos, sin, x, lp, mesh, ldims)
    norm = params["final_norm"] if dims is None else \
        gather_shards(params["final_norm"], dims["final_norm"])
    return rms_norm(x, norm, cfg.norm_eps)


def hidden_states(params, tokens, cfg, device="cuda", mesh=None):
    """tokens: [B, S] int → final-norm hidden states [B, S, D] (model
    dtype). With cfg.remat each layer's intermediates are recomputed in the
    backward pass. `mesh`: a LocalRing for attention_impl='ring' or
    'ulysses', or the spmd.Mesh of DTensor parameters, where the result is
    this rank's rows."""
    device = resolve_device(device)
    params, dims = _local_params(params, mesh)
    check_params_device(params, device)
    return _hidden_states(params, dims, _rows(tokens, mesh, device), cfg,
                          device, mesh)


def _head(params, dims):
    """The output projection, whole."""
    if dims is None:
        return params["lm_head"]
    return gather_shards(params["lm_head"], dims["lm_head"])


def forward(params, tokens, cfg, device="cuda", mesh=None):
    """tokens: [B, S] int → logits [B, S, vocab] (float32). `mesh` as
    hidden_states takes it."""
    device = resolve_device(device)
    params, dims = _local_params(params, mesh)
    check_params_device(params, device)
    x = _hidden_states(params, dims, _rows(tokens, mesh, device), cfg,
                       device, mesh)
    return matmul_f32(x, _head(params, dims))


def _ce_sums(x, lm_head, targets, mask):
    """Summed cross-entropy and token count for one [B, C, D] hidden chunk.
    The f32 logits live only inside this function."""
    logits = matmul_f32(x, lm_head)
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets[..., None])[..., 0]
    nll = lse - tl
    if mask is None:
        return nll.sum(), torch.tensor(float(nll.numel()), device=x.device)
    mask = mask.float()
    return (nll * mask).sum(), mask.sum()


def loss_fn(params, batch, cfg, device="cuda", mesh=None):
    """Next-token cross-entropy; batch: {'tokens': [B, S+1]} or
    {'inputs': [B, S], 'targets': [B, S]} (+ optional 'mask'), numpy arrays
    or tensors.

    When cfg.loss_chunk divides the sequence, the head product and
    log-softmax run chunk by chunk along the sequence, each chunk
    recomputed in the backward pass, so peak activation memory is
    [B, chunk, vocab] f32 instead of [B, S, vocab] in both passes. An
    off-size sequence snaps the chunk to the largest divisor of S that fits
    the bound (below 32, unchunked), as the JAX package does. `mesh`: a
    LocalRing for attention_impl='ring' or 'ulysses', or the spmd.Mesh of
    DTensor parameters; there each rank takes its rows of the batch (a
    DTensor's local block, or its block of a global array) and the loss is
    the mean over every rank's tokens: the cross-entropy sums and token
    counts are summed over the ranks before the division."""
    device = resolve_device(device)
    params, dims = _local_params(params, mesh)
    check_params_device(params, device)
    if "tokens" in batch:
        tokens = _tokens_on(_rows(batch["tokens"], mesh, device), device)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs = _tokens_on(_rows(batch["inputs"], mesh, device), device)
        targets = _tokens_on(_rows(batch["targets"], mesh, device), device)
    mask = batch.get("mask")
    if mask is not None:
        mask = _rows(mask, mesh, device)
    x = _hidden_states(params, dims, inputs, cfg, device, mesh)
    head = _head(params, dims)

    S = x.shape[1]
    chunk = cfg.loss_chunk
    if chunk and S % chunk:
        chunk = next(c for c in range(min(chunk, S), 0, -1) if S % c == 0)
        if chunk < 32:
            chunk = 0  # degenerate chunking would be slower than the win
    if not chunk or S == chunk:
        loss_sum, count = _ce_sums(x, head, targets, mask)
    else:
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        count = torch.zeros((), dtype=torch.float32, device=device)
        for start in range(0, S, chunk):
            sl = slice(start, start + chunk)
            s, c = _remat(_ce_sums, x[:, sl], head, targets[:, sl],
                          None if mask is None else mask[:, sl])
            loss_sum = loss_sum + s
            count = count + c
    if isinstance(mesh, Mesh):
        loss_sum, count = _GlobalSum.apply(torch.stack([loss_sum, count]),
                                           batch_group(mesh))
    return loss_sum / torch.clamp(count, min=1)
