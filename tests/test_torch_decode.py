"""The PyTorch port's KV-cache decoding against the JAX package's, on the
CPU: greedy generate token for token (dense and chunked attention, padded
prompt), decode_forward logits at scalar and per-row positions, and the
chunked attention's clamped edge chunk."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from metaflow_tpu.inference import decode as ref_decode  # noqa: E402
from metaflow_tpu.models import llama as ref_llama  # noqa: E402
from metaflow_tpu_torch.inference import decode as port_decode  # noqa: E402
from metaflow_tpu_torch.models import llama as port_llama  # noqa: E402

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

LOGIT_TOL = dict(atol=1e-4, rtol=1e-3)   # float32, as test_torch_llama
ATTN_TOL = dict(atol=2e-5, rtol=2e-4)    # float32 attention


@pytest.fixture(scope="module")
def model():
    cfg = ref_llama.LlamaConfig.tiny()
    ref_params = ref_llama.init_params(jax.random.PRNGKey(0), cfg)
    params = port_llama.from_jax_params(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return cfg, ref_params, params


@pytest.mark.parametrize("attn_impl", ["dense", "chunked"])
def test_greedy_generate_token_identical(model, attn_impl):
    cfg, ref_params, params = model
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 19))
    ref = ref_decode.generate(ref_params, jnp.asarray(prompt), cfg, 6,
                              attn_impl=attn_impl, max_seq_len=64)
    port = port_decode.generate(params, prompt, cfg, 6, attn_impl=attn_impl,
                                max_seq_len=64, device="cpu")
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    # the padded-prompt call (pad-to-bucket serving path) gives the same
    # continuation after the pad gap
    padded = np.concatenate([prompt, np.zeros((2, 13), prompt.dtype)], 1)
    port_pad = port_decode.generate(params, padded, cfg, 6,
                                    attn_impl=attn_impl, max_seq_len=64,
                                    prompt_len=19, device="cpu")
    np.testing.assert_array_equal(port_pad[:, 32:].numpy(),
                                  np.asarray(ref)[:, 19:])
    gen = port_decode.make_generator(cfg, 6, max_seq_len=64,
                                     attn_impl=attn_impl, device="cpu")
    np.testing.assert_array_equal(gen(params, prompt, 0).numpy(),
                                  np.asarray(ref))


def test_generate_refuses_overflowing_cache(model):
    cfg, _, params = model
    with pytest.raises(ValueError, match="cannot hold"):
        port_decode.generate(params, np.zeros((1, 10), np.int64), cfg, 8,
                             max_seq_len=16, device="cpu")


@pytest.mark.parametrize("pos_kind", ["scalar", "per_row"])
def test_decode_forward_logits_match(model, pos_kind):
    """One decode step over a cache that already holds a prefix: logits
    and the written cache match, at a lockstep position and at per-row
    positions."""
    cfg, ref_params, params = model
    rng = np.random.default_rng(4)
    B, Smax = 3, 40
    shape = (cfg.n_layers, B, Smax, cfg.n_kv_heads, cfg.head_dim)
    cache_np = {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    tokens = rng.integers(0, cfg.vocab_size, (B, 2))
    pos = 17 if pos_kind == "scalar" else np.array([3, 30, 17])
    ref_logits, ref_cache = ref_decode.decode_forward(
        ref_params, jnp.asarray(tokens),
        jax.tree.map(jnp.asarray, cache_np), jnp.asarray(pos), cfg)
    cache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    port_pos = pos if pos_kind == "scalar" else torch.from_numpy(pos)
    port_logits, cache = port_decode.decode_forward(
        params, tokens, cache, port_pos, cfg, device="cpu")
    np.testing.assert_allclose(port_logits.numpy(), np.asarray(ref_logits),
                               **LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(ref_cache[name]), **ATTN_TOL)


@pytest.mark.parametrize("pos", [5, 37, "per_row"])
def test_chunked_attention_matches_with_clamped_edge(pos):
    """chunk 16 over a 40-deep cache: the third chunk's slice is clamped to
    [24, 40) and its re-read of keys 24..31 must stay masked; with per-row
    positions the loop runs to the deepest row."""
    rng = np.random.default_rng(5)
    B, T, H, KV, Hd, Smax = 3, 2, 4, 2, 32, 40
    q = rng.standard_normal((B, T, H, Hd)).astype(np.float32)
    ck = rng.standard_normal((B, Smax, KV, Hd)).astype(np.float32)
    cv = rng.standard_normal((B, Smax, KV, Hd)).astype(np.float32)
    p = np.array([1, 37, 20]) if pos == "per_row" else pos
    ref = ref_decode._chunked_cached_attention(q, ck, cv, jnp.asarray(p),
                                               chunk=16)
    port_p = torch.from_numpy(p) if pos == "per_row" else p
    port = port_decode._chunked_cached_attention(
        *[torch.from_numpy(a) for a in (q, ck, cv)], port_p, chunk=16)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **ATTN_TOL)
    dense = port_decode._cached_attention(
        *[torch.from_numpy(a) for a in (q, ck, cv)], port_p)
    np.testing.assert_allclose(port.numpy(), dense.numpy(), **ATTN_TOL)


def test_bucketing_matches_reference():
    for n, lo, hi in [(0, 16, None), (17, 16, None), (40, 16, 48),
                      (5, 1, None), (64, 16, 64)]:
        assert port_decode.bucket_length(n, lo, hi) == \
            ref_decode.bucket_length(n, lo, hi)
    with pytest.raises(ValueError):
        port_decode.bucket_length(65, 16, 64)
    tokens = np.arange(10).reshape(2, 5)
    ref_pad, ref_n = ref_decode.pad_to_bucket(tokens, pad_id=7)
    port_pad, port_n = port_decode.pad_to_bucket(tokens, pad_id=7)
    assert port_n == ref_n
    np.testing.assert_array_equal(port_pad.numpy(), np.asarray(ref_pad))
