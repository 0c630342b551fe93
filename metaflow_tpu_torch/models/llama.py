"""Llama-family transformer in PyTorch: forward, loss and remat.

Parameters are a plain dict of tensors with the JAX package's names and
layout: per-layer weights stacked on a leading [L] axis, projections stored
[in, out] and applied as `h @ w`. The layer stack is a Python loop over
that axis; with cfg.remat each layer runs under torch.utils.checkpoint, as
the JAX package wraps its scanned layer in jax.checkpoint.
"""

from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies


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
    # None recomputes the whole layer in the backward pass; the JAX
    # package's "dots" and "attn_out" policies are not ported yet
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


def resolve_device(device):
    """The torch.device an entry point runs on. A CUDA device without a
    card raises: the port never falls back to the CPU on its own."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return device


def check_params_device(params, device):
    where = params["embed"].device
    if where.type != device.type or device.index not in (None, where.index):
        raise ValueError("parameters live on %s, not on %s"
                         % (where, device))


class _MatmulBF16F32(torch.autograd.Function):
    """bf16 a [N, K] @ bf16 b [K, M] with float32 products, sums and result
    on the card (torch.mm with out_dtype, which autograd cannot
    differentiate). The gradients are the JAX package's transpose of its
    bf16 x bf16 -> f32 einsum as XLA on a TPU computes it at default
    precision: the f32 cotangent enters the products rounded to bf16, the
    sums are f32, and each gradient is cast to bf16."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        return g @ b.t(), a.t() @ g


def _matmul_f32(a, b):
    """a @ b with float32 products and sums and a float32 result (the JAX
    package's preferred_element_type=float32 on bf16 operands). On the card
    a bf16 product writes float32 directly; elsewhere the operands are cast
    up first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16 and b.ndim == 2:
        out = _MatmulBF16F32.apply(a.reshape(-1, a.shape[-1]), b)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())


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


def _layer(cfg, cos, sin, x, lp):
    """One transformer block; x: [B, S, D]."""
    B, S, _ = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, S, H, Hd)
    k = (h @ lp["wk"]).reshape(B, S, KV, Hd)
    v = (h @ lp["wv"]).reshape(B, S, KV, Hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cfg.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            "attention_impl=%r (sequence parallelism) is not ported yet"
            % cfg.attention_impl)
    attn = attention(q, k, v, causal=True, impl=cfg.attention_impl)
    x = x + attn.reshape(B, S, H * Hd) @ lp["wo"]
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    gate = F.silu(h @ lp["w_gate"])
    up = h @ lp["w_up"]
    return x + (gate * up) @ lp["w_down"]


def _tokens_on(tokens, device):
    return torch.as_tensor(tokens, device=device).long()


def _remat(fn, *args):
    """fn(*args), recomputed in the backward pass instead of keeping its
    intermediates when autograd records (jax.checkpoint with policy None);
    a plain call when it does not."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def hidden_states(params, tokens, cfg, device="cuda"):
    """tokens: [B, S] int → final-norm hidden states [B, S, D] (model
    dtype). With cfg.remat each layer's intermediates are recomputed in the
    backward pass."""
    device = resolve_device(device)
    check_params_device(params, device)
    if cfg.remat and cfg.remat_policy is not None:
        raise NotImplementedError(
            "remat_policy=%r is not ported yet (ROADMAP.md, slice 2b); use "
            "remat_policy=None" % cfg.remat_policy)
    tokens = _tokens_on(tokens, device)
    dt = param_dtype(cfg)
    x = params["embed"][tokens].to(dt)
    cos, sin = rope_frequencies(
        cfg.head_dim, tokens.shape[1], cfg.rope_theta, dtype=dt,
        llama3_scaling=cfg.rope_llama3_scaling, device=device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat:
            x = _remat(_layer, cfg, cos, sin, x, lp)
        else:
            x = _layer(cfg, cos, sin, x, lp)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params, tokens, cfg, device="cuda"):
    """tokens: [B, S] int → logits [B, S, vocab] (float32)."""
    x = hidden_states(params, tokens, cfg, device=device)
    return _matmul_f32(x, params["lm_head"])


def _ce_sums(x, lm_head, targets, mask):
    """Summed cross-entropy and token count for one [B, C, D] hidden chunk.
    The f32 logits live only inside this function."""
    logits = _matmul_f32(x, lm_head)
    lse = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, targets[..., None])[..., 0]
    nll = lse - tl
    if mask is None:
        return nll.sum(), torch.tensor(float(nll.numel()), device=x.device)
    mask = mask.float()
    return (nll * mask).sum(), mask.sum()


def loss_fn(params, batch, cfg, device="cuda"):
    """Next-token cross-entropy; batch: {'tokens': [B, S+1]} or
    {'inputs': [B, S], 'targets': [B, S]} (+ optional 'mask'), numpy arrays
    or tensors.

    When cfg.loss_chunk divides the sequence, the head product and
    log-softmax run chunk by chunk along the sequence, each chunk
    recomputed in the backward pass, so peak activation memory is
    [B, chunk, vocab] f32 instead of [B, S, vocab] in both passes. An
    off-size sequence snaps the chunk to the largest divisor of S that fits
    the bound (below 32, unchunked), as the JAX package does."""
    device = resolve_device(device)
    if "tokens" in batch:
        tokens = _tokens_on(batch["tokens"], device)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs = _tokens_on(batch["inputs"], device)
        targets = _tokens_on(batch["targets"], device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=device)
    x = hidden_states(params, inputs, cfg, device=device)

    S = x.shape[1]
    chunk = cfg.loss_chunk
    if chunk and S % chunk:
        chunk = next(c for c in range(min(chunk, S), 0, -1) if S % c == 0)
        if chunk < 32:
            chunk = 0  # degenerate chunking would be slower than the win
    if not chunk or S == chunk:
        loss_sum, count = _ce_sums(x, params["lm_head"], targets, mask)
        return loss_sum / torch.clamp(count, min=1)

    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    count = torch.zeros((), dtype=torch.float32, device=device)
    for start in range(0, S, chunk):
        sl = slice(start, start + chunk)
        s, c = _remat(_ce_sums, x[:, sl], params["lm_head"], targets[:, sl],
                      None if mask is None else mask[:, sl])
        loss_sum = loss_sum + s
        count = count + c
    return loss_sum / torch.clamp(count, min=1)
