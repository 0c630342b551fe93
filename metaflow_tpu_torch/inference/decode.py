"""Autoregressive decoding with a KV cache (Llama and Mixtral), in PyTorch.

Prefill runs the prompt through the stack once and fills a static-shape
[layers, batch, max_seq, kv_heads, head_dim] cache; each decode step
appends one position and attends over the cache with a position mask.

Where the JAX package rebuilds the cache functionally, this port writes it
IN PLACE: decode_forward mutates the cache tensors it is given and returns
the same dict. A write that would run past the cache end is clamped to end
at it, exactly as the JAX package's dynamic_update_slice clamps; the entry
points guard against such writes before they happen. The layer stack and
the decode steps are Python loops where the JAX package has lax.scan.

Sampling cannot reproduce jax.random. Each row of each step draws its
Gumbel noise from a torch.Generator seeded with that row's step seed
(request_step_keys), so a row's draw depends only on its own seed and a
request gives the same tokens alone or batched with others.
"""

import math

import numpy as np
import torch

from .. import knobs
from ..models.llama import (
    _tokens_on,
    check_params_device,
    layer_params,
    param_dtype,
)
from ..ops.attention import NEG_INF, _broadcast_gqa
from ..ops.matmul import matmul_f32
from ..ops.moe import moe_ffn
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_frequencies
from ..spmd.device import resolve_device

# KV-chunk size of the flash-decode path and the pivot of the
# attn_impl="auto" switchover (TPUFLOW_DECODE_CHUNK, read once at import)
DECODE_CHUNK = max(1, knobs.get_int("TPUFLOW_DECODE_CHUNK"))


def init_kv_cache(cfg, batch_size, max_seq_len, dtype=None, device="cuda"):
    """Zeroed [layers, batch, max_seq, kv_heads, head_dim] cache pair."""
    device = resolve_device(device)
    if dtype is None:
        dt = param_dtype(cfg)
    else:
        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    shape = (cfg.n_layers, batch_size, max_seq_len, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _query_positions(pos, T, device):
    """Absolute query positions for T new tokens at offset `pos`: a Python
    int (the batch decodes in lockstep) gives [T]; a [B] tensor (every row
    at its own offset, the slot engine) gives [B, T]."""
    offsets = torch.arange(T, device=device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return pos[:, None] + offsets[None, :]
    return int(pos) + offsets


def _mask_positions(q_positions):
    """[T] or [B, T] query positions -> broadcastable [*, 1, T, 1] for the
    [B, H, T, S] logits layout."""
    if q_positions.ndim == 1:
        return q_positions[None, None, :, None]
    return q_positions[:, None, :, None]


def _write_cache(cache, new, pos):
    """Write new [B, T, KV, Hd] into cache [B, Smax, KV, Hd] in place at
    `pos` (int, or [B] per-row cursors), each start clamped to [0, Smax-T]
    as dynamic_update_slice clamps."""
    T, Smax = new.shape[1], cache.shape[1]
    new = new.to(cache.dtype)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        start = pos.clamp(0, Smax - T)
        idx = start[:, None] + torch.arange(T, device=cache.device)
        rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[rows, idx] = new
    else:
        start = min(max(int(pos), 0), Smax - T)
        cache[:, start:start + T] = new


def _cached_attention(q, cache_k, cache_v, pos):
    """q: [B, T, H, Hd] at absolute positions pos..pos+T-1; cache_k/v:
    [B, Smax, KV, Hd]. Key i is visible to query t iff i <= pos + t.

    Dense: touches the WHOLE cache every step."""
    B, T, H, Hd = q.shape
    k = _broadcast_gqa(cache_k, H)
    v = _broadcast_gqa(cache_v, H)
    scale = 1.0 / math.sqrt(Hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    key_idx = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    q_pos = _mask_positions(_query_positions(pos, T, q.device))
    logits = torch.where(key_idx <= q_pos, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _streamed_attention(q, pos, chunk, n_chunks, fetch):
    """Online-softmax attention over KV streamed in `chunk`-sized blocks.

    fetch(i) -> (k_blk [B, chunk, KV, Hd], v_blk, key_pos [chunk]): the
    i-th KV block and the absolute key positions it holds. Keys are
    visible iff key_pos <= q_pos AND key_pos >= i * chunk; the second term
    masks a clamped edge block's re-read of earlier keys."""
    B, T, H, Hd = q.shape
    scale = 1.0 / math.sqrt(Hd)
    qf = q.float()
    q_pos = _mask_positions(_query_positions(pos, T, q.device))
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, T, Hd), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        k_raw, v_raw, key_pos = fetch(i)
        k_blk = _broadcast_gqa(k_raw, H)
        v_blk = _broadcast_gqa(v_raw, H)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, k_blk.float()) * scale
        key_idx = key_pos[None, None, None, :]
        visible = (key_idx <= q_pos) & (key_idx >= i * chunk)
        logits = torch.where(visible, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
    out = acc / l[..., None]
    return out.transpose(1, 2).to(q.dtype)  # [B, T, H, Hd]


def _max_position(pos):
    return int(pos.max()) if isinstance(pos, torch.Tensor) else int(pos)


def _chunked_cached_attention(q, cache_k, cache_v, pos, chunk=DECODE_CHUNK,
                              pos_max=None):
    """Flash-decode: the same attention reading ONLY the filled prefix.
    The trip count is ceil((max(pos) + T) / chunk): with per-slot
    positions the loop runs to the DEEPEST slot's fill and shallower slots
    mask the extra chunks. The edge chunk's slice is clamped to end at the
    cache end; its re-read of earlier keys is masked out."""
    T = q.shape[1]
    Smax = cache_k.shape[1]
    chunk = min(chunk, Smax)
    if pos_max is None:
        pos_max = _max_position(pos)
    n_chunks = (pos_max + T + chunk - 1) // chunk

    def fetch(i):
        start = min(i * chunk, Smax - chunk)
        key_pos = start + torch.arange(chunk, device=q.device)
        return (cache_k[:, start:start + chunk],
                cache_v[:, start:start + chunk], key_pos)

    return _streamed_attention(q, pos, chunk, n_chunks, fetch)


def _attn_qkv(cfg, cos, sin, pos, x, lp):
    """Attn-norm, QKV projections and rope at the absolute positions `pos`
    implies."""
    B, T, _ = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, T, H, Hd)
    k = (h @ lp["wk"]).reshape(B, T, KV, Hd)
    v = (h @ lp["wv"]).reshape(B, T, KV, Hd)
    positions = _query_positions(pos, T, x.device)
    q = apply_rope(q, cos, sin, positions=positions)
    k = apply_rope(k, cos, sin, positions=positions)
    return q, k, v


def _block_ffn(cfg, x, attn, lp):
    """Output projection, residual and the dense (Llama) or MoE (Mixtral)
    FFN, picked off the layer's parameters."""
    B, T, _ = x.shape
    x = x + attn.reshape(B, T, cfg.n_heads * cfg.head_dim) @ lp["wo"]
    h = rms_norm(x, lp["ffn_norm"], cfg.norm_eps)
    if "router" in lp:  # Mixtral: token-choice MoE FFN
        dispatch = cfg.moe_dispatch
        if dispatch in ("gmm", "gmm_ep"):
            # gmm pads every expert to 128-row tiles, sized for training
            # batches; sparse with no capacity is lossless, the same
            # function
            dispatch = "sparse"
        moe_out, _aux = moe_ffn(
            h, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
            num_experts_per_tok=cfg.experts_per_tok,
            capacity_factor=None,  # decode batches are tiny: lossless
            dispatch=dispatch)
        return x + moe_out
    gate = torch.nn.functional.silu(h @ lp["w_gate"])
    up = h @ lp["w_up"]
    return x + (gate * up) @ lp["w_down"]


def _decode_layer(cfg, cos, sin, pos, x, lp, cache_k, cache_v,
                  attn_impl="dense", pos_max=None):
    """One block over T new tokens; writes this layer's cache in place at
    `pos` (int, or [B] per-row cursors) and reads it back."""
    q, k, v = _attn_qkv(cfg, cos, sin, pos, x, lp)
    _write_cache(cache_k, k, pos)
    _write_cache(cache_v, v, pos)
    if attn_impl == "chunked":
        attn = _chunked_cached_attention(q, cache_k, cache_v, pos,
                                         pos_max=pos_max)
    else:
        attn = _cached_attention(q, cache_k, cache_v, pos)
    return _block_ffn(cfg, x, attn, lp)


def decode_forward(params, tokens, cache, pos, cfg, attn_impl="dense",
                   device="cuda"):
    """Forward over T new tokens at absolute position `pos` (an int, or a
    [B] tensor when every row decodes at its own offset), extending the
    cache in place. tokens: [B, T]. Returns (logits [B, T, vocab] f32,
    cache)."""
    device = resolve_device(device)
    check_params_device(params, device)
    tokens = _tokens_on(tokens, device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        pos = pos.to(device=device, dtype=torch.long)
    else:
        pos = int(pos)
    dt = param_dtype(cfg)
    max_seq = cache["k"].shape[2]
    x = params["embed"][tokens].to(dt)
    cos, sin = rope_frequencies(
        cfg.head_dim, max_seq, cfg.rope_theta, dtype=dt,
        llama3_scaling=getattr(cfg, "rope_llama3_scaling", False),
        device=device)
    pos_max = _max_position(pos) if attn_impl == "chunked" else None
    for i in range(cfg.n_layers):
        x = _decode_layer(cfg, cos, sin, pos, x, layer_params(params, i),
                          cache["k"][i], cache["v"][i], attn_impl=attn_impl,
                          pos_max=pos_max)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return matmul_f32(x, params["lm_head"]), cache


def request_step_keys(seed, max_new_tokens, row=0):
    """The per-token noise seeds of one request (or of row `row` of a
    generate batch): [max_new_tokens] uint32, a pure function of
    (seed, row). The JAX package's counterpart returns jax.random keys."""
    return np.random.SeedSequence([int(seed), int(row)]).generate_state(
        max_new_tokens)


def gumbel_noise(seeds, vocab, device, generator=None):
    """[len(seeds), vocab] f32 Gumbel noise; row b is drawn from a
    generator seeded with seeds[b] alone, and a None seed gives a row of
    zeros (a greedy or masked row)."""
    generator = generator or torch.Generator(device=device)
    rows = []
    for s in seeds:
        if s is None:
            rows.append(torch.zeros(vocab, device=device))
            continue
        generator.manual_seed(int(s))
        u = torch.rand(vocab, generator=generator, device=device)
        rows.append(-torch.log(-torch.log(
            u.clamp_min(torch.finfo(torch.float32).tiny))))
    return torch.stack(rows)


def _sample(logits, temperature, seeds, top_k=None, top_p=None):
    """logits: [B, vocab] f32 → [B] int64; seeds: one noise seed per row.

    top_k keeps the k highest-logit tokens; top_p keeps the smallest
    nucleus whose probability mass reaches p (the top token always
    survives). Both compose (top_k filters first)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    logits = logits / temperature
    if top_k is not None and top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None and top_p < 1.0:
        logits = _top_p_filter(logits, torch.full(
            (logits.shape[0],), float(top_p), device=logits.device))
    noise = gumbel_noise(seeds, logits.shape[-1], logits.device)
    return (logits + noise).argmax(dim=-1)


def _top_p_filter(logits, top_p):
    """Drop tokens whose EXCLUSIVE cumulative mass (in descending order)
    is >= top_p[row]; the top token always survives."""
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    drop_sorted = before >= top_p[:, None]
    drop = torch.zeros_like(drop_sorted).scatter(-1, order, drop_sorted)
    return torch.where(drop, NEG_INF, logits)


def generate(params, prompt_tokens, cfg, max_new_tokens, temperature=0.0,
             rng=0, eos_id=None, max_seq_len=None, attn_impl="auto",
             top_k=None, top_p=None, prompt_len=None, device="cuda"):
    """Generate max_new_tokens continuations of prompt_tokens [B, P].
    Returns [B, P + max_new_tokens] int64; once a row emits eos_id its
    tail is padded with eos_id. `rng` is an int seed: row b samples with
    request_step_keys(rng, max_new_tokens, row=b).

    attn_impl: 'dense', 'chunked' (flash-decode over the filled prefix)
    or 'auto', which picks 'chunked' once the cache is deeper than
    2 * DECODE_CHUNK positions.

    prompt_len: None when prompt_tokens is exactly the prompt; else the
    true length of a right-PADDED prompt: the first token samples from the
    logits at prompt_len - 1 and decode starts writing at prompt_len, so
    the pad positions are overwritten before they become visible."""
    device = resolve_device(device)
    check_params_device(params, device)
    prompt = _tokens_on(prompt_tokens, device)
    B, P = prompt.shape
    total = P + max_new_tokens
    if max_seq_len is not None and max_seq_len < total:
        # a write past the cache end would be clamped onto live positions
        raise ValueError(
            "max_seq_len=%d < prompt_len (%d) + max_new_tokens (%d); "
            "the KV cache cannot hold the generation" %
            (max_seq_len, P, max_new_tokens))
    if attn_impl not in ("auto", "dense", "chunked"):
        raise ValueError("attn_impl must be 'auto', 'dense' or "
                         "'chunked', got %r" % (attn_impl,))
    cache = init_kv_cache(cfg, B, max_seq_len or total, device=device)
    if attn_impl == "auto":
        attn_impl = ("chunked" if cache["k"].shape[2] > 2 * DECODE_CHUNK
                     else "dense")
    seeds = np.stack([request_step_keys(rng, max_new_tokens, row=b)
                      for b in range(B)], axis=1)  # [steps, B]

    logits, cache = decode_forward(params, prompt, cache, 0, cfg,
                                   attn_impl=attn_impl, device=device)
    pos = P if prompt_len is None else int(prompt_len)
    tok = _sample(logits[:, pos - 1], temperature, seeds[0], top_k, top_p)
    done = (tok == eos_id) if eos_id is not None else None
    new_tokens = [tok]
    for step in range(1, max_new_tokens):
        logits, cache = decode_forward(params, tok[:, None], cache, pos, cfg,
                                       attn_impl=attn_impl, device=device)
        nxt = _sample(logits[:, 0], temperature, seeds[step], top_k, top_p)
        if done is not None:
            nxt = torch.where(done, eos_id, nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        new_tokens.append(tok)
        pos += 1
    return torch.cat([prompt, torch.stack(new_tokens, dim=1)], dim=1)


def bucket_length(n, minimum=16, maximum=None):
    """The smallest power-of-two >= n, floored at `minimum` and capped at
    `maximum` (n must still fit): the prompt-length bucketing policy shared
    by make_generator and the serving engine."""
    if n < 0:
        raise ValueError("length must be >= 0, got %d" % n)
    b = max(1, int(minimum))
    while b < n:
        b *= 2
    if maximum is not None:
        b = min(b, int(maximum))
        if b < n:
            raise ValueError(
                "prompt length %d exceeds the bucket cap %d" % (n, maximum))
    return b


def pad_to_bucket(tokens, bucket=None, pad_id=0, minimum=16):
    """Right-pad [B, P] prompt tokens to `bucket` (default: the
    power-of-two bucket of P). Returns (padded [B, bucket], P)."""
    tokens = torch.as_tensor(tokens)
    B, P = tokens.shape
    if bucket is None:
        bucket = bucket_length(P, minimum=minimum)
    if bucket < P:
        raise ValueError("bucket %d < prompt length %d" % (bucket, P))
    if bucket == P:
        return tokens, P
    pad = torch.full((B, bucket - P), pad_id, dtype=tokens.dtype,
                     device=tokens.device)
    return torch.cat([tokens, pad], dim=1), P


def make_generator(cfg, max_new_tokens, temperature=0.0, eos_id=None,
                   max_seq_len=None, attn_impl="auto", top_k=None,
                   top_p=None, pad_id=0, min_bucket=16, device="cuda"):
    """A (params, prompt_tokens, rng) -> tokens generator that right-pads
    prompts to power-of-two buckets, as the JAX package's jitted generator
    does. PyTorch runs eagerly, so nothing is compiled per bucket; outputs
    equal generate() on the unpadded prompt."""

    def gen(params, prompt_tokens, rng):
        prompt = torch.as_tensor(prompt_tokens)
        B, P = prompt.shape
        cap = max_seq_len - max_new_tokens if max_seq_len else None
        bucket = bucket_length(P, minimum=min_bucket, maximum=cap)
        padded, _ = pad_to_bucket(prompt, bucket, pad_id=pad_id)
        out = generate(params, padded, cfg, max_new_tokens,
                       temperature=temperature, rng=rng, eos_id=eos_id,
                       max_seq_len=max_seq_len, attn_impl=attn_impl,
                       top_k=top_k, top_p=top_p, prompt_len=P,
                       device=device)
        if bucket == P:
            return out
        # drop the pad gap: [prompt | pad | new] -> [prompt | new]
        return torch.cat([out[:, :P], out[:, bucket:]], dim=1)

    return gen
