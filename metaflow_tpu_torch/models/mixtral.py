"""Mixtral-style MoE transformer in PyTorch: forward, loss and remat.

The same plain-dict design as models/llama.py (per-layer weights stacked on
a leading [L] axis, projections stored [in, out]); the FFN is a top-k-of-N
MoE (ops/moe.py). With moe_dispatch="gmm" the experts run on the grouped
matmul kernels K5 and K6. Rope has no Llama-3 scaling. With cfg.remat each
layer runs under torch.utils.checkpoint, as the JAX package wraps its
scanned layer in jax.checkpoint.
"""

from dataclasses import dataclass, replace

import torch

from ..ops.attention import attention
from ..ops.matmul import matmul_f32
from ..ops.moe import moe_ffn
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from .llama import (_remat, _tokens_on, check_params_device,
                    from_jax_params, layer_params, num_params, param_dtype,
                    resolve_device)

__all__ = ["MixtralConfig", "check_params_device", "forward",
           "from_jax_params", "init_params", "loss_fn", "num_params"]


@dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32_000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    n_experts: int = 8
    experts_per_tok: int = 2
    max_seq_len: int = 32_768
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attention_impl: str = "auto"
    remat: bool = True
    router_aux_coef: float = 0.02
    # sparse = capacity-bucketed dispatch; gmm = dropless grouped matmul
    # (K5, K6); dense = the O(num_experts x tokens) oracle; gmm_ep needs an
    # expert mesh across GPUs and raises (not ported yet)
    moe_dispatch: str = "sparse"
    capacity_factor: float = 2.0
    ep_buffer_factor: float = None  # gmm_ep only

    @property
    def head_dim(self):
        return self.dim // self.n_heads

    @staticmethod
    def mixtral_8x7b(**kw):
        return replace(MixtralConfig(), **kw)

    @staticmethod
    def tiny(**kw):
        return replace(
            MixtralConfig(
                vocab_size=512, dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
                ffn_dim=256, n_experts=4, experts_per_tok=2, max_seq_len=256,
                dtype="float32",
            ),
            **kw,
        )


def init_params(cfg, generator=None, device="cuda"):
    """Random parameters from a seeded torch.Generator, made on `device`
    (the generator must live there too; None seeds one with 0), with the
    JAX package's leaves: per-layer tensors stacked on a leading 'layers'
    axis, experts on the next."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = param_dtype(cfg)
    L, D, F = cfg.n_layers, cfg.dim, cfg.ffn_dim
    H, KV, Hd, N = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_experts

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
            "router": dense_init(D, L, D, N),
            "w_gate": dense_init(D, L, N, D, F),
            "w_up": dense_init(D, L, N, D, F),
            "w_down": dense_init(F, L, N, F, D),
        },
        "final_norm": norm_init(D),
        "lm_head": dense_init(D, D, cfg.vocab_size),
    }


def _layer(cfg, cos, sin, x, lp):
    """One block; x: [B, S, D]. Returns (x, this layer's aux loss)."""
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
    dropless = cfg.moe_dispatch in ("gmm", "gmm_ep")
    moe_out, aux = moe_ffn(
        h, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
        num_experts_per_tok=cfg.experts_per_tok,
        # gmm/gmm_ep are dropless: the capacity knob does not apply
        capacity_factor=None if dropless else cfg.capacity_factor,
        dispatch=cfg.moe_dispatch,
        ep_buffer_factor=(cfg.ep_buffer_factor
                          if cfg.moe_dispatch == "gmm_ep" else None),
    )
    return x + moe_out, aux


def forward(params, tokens, cfg, return_aux=False, device="cuda"):
    """tokens: [B, S] int -> logits [B, S, vocab] (float32), and with
    return_aux the router loss averaged over the layers (f32)."""
    device = resolve_device(device)
    check_params_device(params, device)
    tokens = _tokens_on(tokens, device)
    dt = param_dtype(cfg)
    x = params["embed"][tokens].to(dt)
    cos, sin = rope_frequencies(cfg.head_dim, tokens.shape[1],
                                cfg.rope_theta, dtype=dt, device=device)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        if cfg.remat:
            x, layer_aux = _remat(_layer, cfg, cos, sin, x, lp)
        else:
            x, layer_aux = _layer(cfg, cos, sin, x, lp)
        aux = aux + layer_aux
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = matmul_f32(x, params["lm_head"])
    if return_aux:
        return logits, aux / cfg.n_layers
    return logits


def loss_fn(params, batch, cfg, device="cuda"):
    """Next-token cross-entropy over the full log-softmax plus
    router_aux_coef times the mean router loss; batch: {'tokens': [B, S+1]}
    or {'inputs': [B, S], 'targets': [B, S]}, numpy arrays or tensors."""
    device = resolve_device(device)
    if "tokens" in batch:
        tokens = _tokens_on(batch["tokens"], device)
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs = _tokens_on(batch["inputs"], device)
        targets = _tokens_on(batch["targets"], device)
    logits, aux = forward(params, inputs, cfg, return_aux=True, device=device)
    logps = torch.log_softmax(logits, dim=-1)
    token_lp = logps.gather(-1, targets[..., None])[..., 0]
    return -token_lp.mean() + cfg.router_aux_coef * aux
