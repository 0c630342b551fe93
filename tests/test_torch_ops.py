"""The PyTorch port's ops against the JAX package's, on the CPU in float32:
norms, rope, plain attention, and the flash kernels through their plain
versions against the JAX kernels in interpret mode: the forward (K1) and
the gradients of the flash path (K2, K3)."""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from metaflow_tpu.ops import norms as ref_norms  # noqa: E402
from metaflow_tpu.ops import rope as ref_rope  # noqa: E402
from metaflow_tpu_torch.ops import norms as port_norms  # noqa: E402
from metaflow_tpu_torch.ops import rope as port_rope  # noqa: E402

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

# the packages export a function named `attention` over the module's name
ref_attn = importlib.import_module("metaflow_tpu.ops.attention")
port_attn = importlib.import_module("metaflow_tpu_torch.ops.attention")

# the float32 op tolerances; the attention ones are the JAX package's own
# flash-vs-reference tolerances (tests/test_ops.py)
OP_TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_TOL = dict(atol=2e-5, rtol=2e-4)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(B=1, S=128, H=4, KV=None, D=64, seed=0):
    KV = KV or H
    return (_randn(seed, B, S, H, D), _randn(seed + 1, B, S, KV, D),
            _randn(seed + 2, B, S, KV, D))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("with_bias", [False, True])
def test_norms_match(with_bias):
    x, w, b = _randn(0, 3, 5, 64), _randn(1, 64), _randn(2, 64)
    np.testing.assert_allclose(
        port_norms.rms_norm(*_t(x, w), eps=1e-5).numpy(),
        np.asarray(ref_norms.rms_norm(x, w, eps=1e-5)), **OP_TOL)
    bias = b if with_bias else None
    port = port_norms.layer_norm(
        torch.from_numpy(x), torch.from_numpy(w),
        None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(
        port.numpy(), np.asarray(ref_norms.layer_norm(x, w, bias)), **OP_TOL)


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("positions", ["none", "flat", "per_row"])
def test_rope_matches(scaling, positions):
    cos_r, sin_r = ref_rope.rope_frequencies(64, 96, llama3_scaling=scaling)
    cos_p, sin_p = port_rope.rope_frequencies(64, 96, llama3_scaling=scaling)
    np.testing.assert_allclose(cos_p.numpy(), np.asarray(cos_r), **OP_TOL)
    np.testing.assert_allclose(sin_p.numpy(), np.asarray(sin_r), **OP_TOL)
    x = _randn(3, 2, 7, 4, 64)
    pos = {"none": None,
           "flat": np.arange(5, 12),
           "per_row": np.stack([np.arange(7), np.arange(40, 47)])}[positions]
    ref = ref_rope.apply_rope(x, cos_r, sin_r, positions=pos)
    port = port_rope.apply_rope(
        torch.from_numpy(x), cos_p, sin_p,
        positions=None if pos is None else torch.from_numpy(pos))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **OP_TOL)


ATTN_CASES = {
    "causal": dict(S=256, H=2, causal=True),
    "non_causal": dict(S=128, H=4, causal=False),
    "gqa": dict(S=128, H=8, KV=2, causal=True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_reference_attention_matches(case):
    kw = dict(ATTN_CASES[case])
    causal = kw.pop("causal")
    q, k, v = _qkv(**kw)
    ref = ref_attn.reference_attention(q, k, v, causal=causal)
    port = port_attn.reference_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_flash_forward_matches_interpreted_kernel(case):
    """O and lse of K1's CPU path against the Pallas kernel run in
    interpret mode on the same inputs."""
    kw = dict(ATTN_CASES[case])
    causal = kw.pop("causal")
    q, k, v = _qkv(**kw)
    B, S, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    fold = lambda x: ref_attn._fold_heads(ref_attn._broadcast_gqa(x, H))
    ref_o, ref_lse = ref_attn._flash_forward(
        fold(q), fold(k), fold(v), causal, scale, interpret=True)
    port_o, port_lse = port_attn._flash_forward(*_t(q, k, v), causal, scale)
    np.testing.assert_allclose(
        port_o.numpy(), np.asarray(ref_attn._unfold_heads(ref_o, B, H)),
        **ATTN_TOL)
    np.testing.assert_allclose(port_lse.numpy(), np.asarray(ref_lse),
                               **ATTN_TOL)
    # the dispatcher's flash impl reaches the same function
    port_attn_out = port_attn.attention(*_t(q, k, v), causal=causal,
                                        impl="flash")
    np.testing.assert_allclose(port_attn_out.numpy(), port_o.numpy(),
                               atol=0, rtol=0)


def test_bf16_row_limit_holds_reference_and_catches_late_rows():
    """K1's bf16 row limit (FLASH_BF16_ROW_LIMIT): the JAX kernel in
    interpret mode and the port's plain version round at their own places
    and stay within it; an error of 2^-5 |O| in the late causal rows only,
    where |O| is a small share of max|v|, goes past it."""
    q, k, v = _qkv(S=256, H=2, D=64)
    B, S, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    fold = lambda x: ref_attn._fold_heads(jnp.asarray(x, jnp.bfloat16))
    ref_o, _ = ref_attn._flash_forward(fold(q), fold(k), fold(v), True,
                                       scale, interpret=True)
    ref_o = torch.from_numpy(np.array(
        ref_attn._unfold_heads(ref_o, B, H).astype(jnp.float32)))
    port_o, _ = port_attn._flash_forward(
        *(x.to(torch.bfloat16) for x in _t(q, k, v)), True, scale)
    limit = port_attn.FLASH_BF16_ROW_LIMIT
    assert port_attn.flash_out_error(port_o, ref_o) <= limit
    faulty = port_o.float().clone()
    faulty[:, S // 2:] *= 1 + 2.0 ** -5
    assert port_attn.flash_out_error(faulty, ref_o) > limit
    # a bound of 2^-7 max|v| over the whole tensor lets it through
    assert ((faulty - ref_o).abs().max()
            <= 2.0 ** -7 * np.abs(v).max())


def test_auto_takes_plain_path_on_cpu():
    q, k, v = _t(*_qkv(S=128, D=128))
    np.testing.assert_array_equal(
        port_attn.attention(q, k, v, impl="auto").numpy(),
        port_attn.reference_attention(q, k, v).numpy())


@pytest.mark.parametrize("blocks,S", [((128, 128), 200),
                                      ((128, 96), 384)])
def test_flash_refusals_match_reference(monkeypatch, blocks, S):
    """An unaligned S, or block sizes that do not divide one another,
    raise in both packages instead of dropping the sequence tail."""
    for mod in (ref_attn, port_attn):
        monkeypatch.setattr(mod, "BLOCK_Q", blocks[0])
        monkeypatch.setattr(mod, "BLOCK_K", blocks[1])
    q, k, v = _qkv(S=S, H=2, D=32)
    assert not port_attn.blocks_aligned(S)
    with pytest.raises(ValueError) as ref_err:
        ref_attn.flash_attention(q, k, v, interpret=True)
    with pytest.raises(ValueError) as port_err:
        port_attn.flash_attention(*_t(q, k, v))
    assert str(port_err.value) == str(ref_err.value)


def _jax_flash_grads(q, k, v, w, causal, dtype):
    """Grads of sum(flash_attention(q, k, v) * w) through the JAX package's
    custom_vjp, its backward kernels (K2, K3) in interpret mode."""
    def loss(q, k, v):
        out = ref_attn.flash_attention(q, k, v, causal=causal,
                                       interpret=True)
        return jnp.sum(out.astype(jnp.float32) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in grads]


def _port_flash_grads(q, k, v, w, causal, dtype):
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True)
              for x in (q, k, v)]
    out = port_attn.flash_attention(*leaves, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert all(t.grad.dtype == dtype for t in leaves)
    return [t.grad for t in leaves]


GRAD_CASES = {
    "causal_gqa": dict(S=128, H=4, KV=2, causal=True),
    "non_causal": dict(S=128, H=2, causal=False),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_flash_grads_match_interpreted_kernels(case):
    """f32 dq, dk, dv of the port's flash path (its plain backward on the
    CPU) against jax.grad through the interpreted K2 and K3, within the JAX
    package's own flash grad tolerance (tests/test_ops.py)."""
    kw = dict(GRAD_CASES[case])
    causal = kw.pop("causal")
    q, k, v = _qkv(**kw)
    w = _randn(9, *q.shape)
    want = _jax_flash_grads(q, k, v, w, causal, jnp.float32)
    got = _port_flash_grads(q, k, v, w, causal, torch.float32)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-3, err_msg="d" + name)


def test_flash_grads_bf16_within_row_limit():
    """bf16 grads, causal GQA: each side rounds every gradient to bf16 once
    (JAX also sums dk, dv over the group in bf16, the port in f32), so the
    row error stays within the bf16 row limit that holds K1's output."""
    q, k, v = _qkv(S=128, H=4, KV=2)
    w = _randn(9, *q.shape)
    want = _jax_flash_grads(q, k, v, w, True, jnp.bfloat16)
    got = _port_flash_grads(q, k, v, w, True, torch.bfloat16)
    for name, a, b in zip("qkv", got, want):
        err = port_attn.flash_out_error(a, b)
        assert err <= port_attn.FLASH_BF16_ROW_LIMIT, ("d" + name, err)
        # a gradient off by 2^-5 of its magnitude goes past it
        assert port_attn.flash_out_error(a.float() * (1 + 2.0 ** -5),
                                         b) > port_attn.FLASH_BF16_ROW_LIMIT


def test_flash_block_bwd_matches_reference():
    """flash_block_bwd (the seam ring attention reuses) against the JAX
    package's on the same lse and delta: f32 (dq, dk, dv), the port's dk
    and dv summed over each GQA group where JAX keeps one per q head."""
    q, k, v = _qkv(S=128, H=4, KV=2)
    g = _randn(9, *q.shape)
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = 1.0 / np.sqrt(D)
    fold = lambda x: ref_attn._fold_heads(ref_attn._broadcast_gqa(x, H))
    out, lse = ref_attn._flash_forward(fold(q), fold(k), fold(v), True, scale,
                                       interpret=True)
    delta = jnp.sum(fold(g) * out, axis=-1)
    ref = ref_attn.flash_block_bwd(fold(q), fold(k), fold(v), fold(g), lse,
                                   delta, scale, True, interpret=True)
    port = port_attn.flash_block_bwd(
        *_t(q, k, v, g), torch.from_numpy(np.array(lse)),
        torch.from_numpy(np.array(delta)), scale, True)
    assert all(t.dtype == torch.float32 for t in port)
    want_dq = np.asarray(ref_attn._unfold_heads(ref[0], B, H))
    np.testing.assert_allclose(port[0].numpy(), want_dq, atol=1e-5,
                               rtol=1e-3)
    for got, want in zip(port[1:], ref[1:]):
        want = np.asarray(ref_attn._unfold_heads(want, B, H))
        want = want.reshape(B, S, KV, H // KV, D).sum(3)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-3)
