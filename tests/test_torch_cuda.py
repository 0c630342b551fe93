"""The flash kernels on the card against their plain versions, at shapes
beyond chip_smoke.py's: the forward (K1) and the backward (K2, K3) at
ragged sequence lengths, strided inputs and output gradients, head dim 64,
GQA, the dispatcher's and autograd's routes to the kernels, and one
trainer step through them. Needs an NVIDIA GPU (tests/conftest.py imports
jax, so skip it where jax is missing):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import importlib

import pytest
import torch

A = importlib.import_module("metaflow_tpu_torch.ops.attention")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _check(q, k, v, causal):
    scale = q.shape[-1] ** -0.5
    out, lse = A._flash_forward_cuda(q, k, v, causal, scale)
    ref_out, ref_lse = A._flash_forward_plain(q, k, v, causal, scale)
    torch.cuda.synchronize()
    if q.dtype == torch.float32:
        tol_lse = 1e-5  # f32 sums in another order
        assert (out - ref_out).abs().max().item() <= 1e-5
    else:
        # each row against its own magnitude, as chip_smoke.py holds it
        tol_lse = q.shape[1] * 2.0 ** -24 * ref_lse.abs().max().item() + 1e-6
        assert A.flash_out_error(out, ref_out) <= A.FLASH_BF16_ROW_LIMIT
    assert (lse - ref_lse).abs().max().item() <= tol_lse


@pytest.mark.parametrize("S", [1, 50, 64, 200, 384])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_matches_plain(cuda, S, dtype, D, causal):
    dt = getattr(torch, dtype)
    q = torch.randn(2, S, 4, D, generator=cuda, device="cuda").to(dt)
    k = torch.randn(2, S, 2, D, generator=cuda, device="cuda").to(dt)
    v = torch.randn(2, S, 2, D, generator=cuda, device="cuda").to(dt)
    _check(q, k, v, causal)


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views into one fused [B, S, H + 2 KV, D] projection."""
    qkv = torch.randn(2, 256, 12, 128, generator=cuda, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _check(q, k, v, True)


def test_dispatcher_launches_the_kernel(cuda):
    q = torch.randn(1, 256, 4, 128, generator=cuda, device="cuda").to(
        torch.bfloat16)
    A.reset_launch_counts()
    A.attention(q, q, q, impl="auto")
    assert A.LAUNCHES["flash_fwd"] == 1
    A.attention(q[:, :, :, :64], q[:, :, :, :64], q[:, :, :, :64],
                impl="auto")  # D % 128 != 0: the plain path
    assert A.LAUNCHES["flash_fwd"] == 1
    with pytest.raises(ValueError, match="head dims"):
        A.flash_attention(*(torch.zeros(1, 128, 2, 96, device="cuda"),) * 3)


def test_llama_forward_on_card_matches_cpu(cuda):
    from metaflow_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1)  # Hd 128
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(1))
    want = llama.forward(params, tokens, cfg, device="cpu")
    on_card = {k: ({n: w.cuda() for n, w in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in params.items()}
    A.reset_launch_counts()
    got = llama.forward(on_card, tokens, cfg)
    assert A.LAUNCHES["flash_fwd"] == cfg.n_layers
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-3)


def _check_bwd(q, k, v, g, causal):
    """K2 and K3 against their plain version on the same lse and delta."""
    B, S, H, D = q.shape
    scale = D ** -0.5
    out, lse = A._flash_forward_cuda(q, k, v, causal, scale)
    delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, S).contiguous()
    dq = A._flash_bwd_dq_cuda(q, k, v, g, lse, delta, scale, causal)
    dk, dv = A._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal)
    ref = A._flash_block_bwd_plain(q, k, v, g, lse, delta, scale, causal)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == torch.float32 and got.shape == want.shape
        if q.dtype == torch.float32:
            # f32 on both sides: the sums differ only in order
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-3,
                                       msg=name)
        else:
            err = A.flash_out_error(got, want)
            assert err <= A.FLASH_BWD_ROW_LIMIT, (name, err)


@pytest.mark.parametrize("S", [1, 50, 64, 200, 384])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_kernels_match_plain(cuda, S, dtype, D, causal):
    dt = getattr(torch, dtype)
    q, g = (torch.randn(2, S, 4, D, generator=cuda, device="cuda").to(dt)
            for _ in range(2))
    k, v = (torch.randn(2, S, 2, D, generator=cuda, device="cuda").to(dt)
            for _ in range(2))
    _check_bwd(q, k, v, g, causal)


def test_backward_kernels_read_strided_inputs(cuda):
    """q, k, v as views into one fused projection, dO as a view into a
    wider tensor: read through their strides."""
    qkv = torch.randn(2, 256, 12, 128, generator=cuda, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    g = torch.randn(2, 256, 10, 128, generator=cuda, device="cuda").to(
        torch.bfloat16)[:, :, 1:9]
    _check_bwd(q, k, v, g, True)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_autograd_runs_the_backward_kernels(cuda, dtype):
    """attention(impl='auto') on tensors that require grad launches K1 and,
    in backward, K2 and K3 once each; its grads agree with the flash path's
    plain route (interpret). The output gradient of .sum() is an expanded
    view, which the backward copies into a layout the kernels read."""
    dt = getattr(torch, dtype)

    def grads(impl, weight):
        torch.manual_seed(0)
        leaves = [torch.randn(2, 256, h, 128, device="cuda").to(dt)
                  .requires_grad_(True) for h in (8, 2, 2)]
        out = A.attention(*leaves, impl=impl)
        (out.sum() if weight is None else (out.float() * weight).sum()
         ).backward()
        return [t.grad for t in leaves]

    weight = torch.randn(2, 256, 8, 128, generator=cuda, device="cuda")
    for w in (None, weight):
        A.reset_launch_counts()
        got = grads("auto", w)
        assert (A.LAUNCHES["flash_fwd"], A.LAUNCHES["flash_bwd_dq"],
                A.LAUNCHES["flash_bwd_dkv"]) == (1, 1, 1)
        want = grads("flash_interpret", w)
        for a, b in zip(got, want):
            assert a.dtype == dt
            if dt == torch.float32:
                torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-3)
            else:  # each side rounds the gradient to bf16 once
                assert A.flash_out_error(a, b) <= A.FLASH_BF16_ROW_LIMIT


def test_trainer_step_flash_matches_plain_attention(cuda):
    """Two trainer steps of a float32 model with head dim 128 through K1,
    K2 and K3 against the same steps through plain attention."""
    from metaflow_tpu_torch import training
    from metaflow_tpu_torch.models import llama

    tokens = torch.randint(0, 512, (2, 129),
                           generator=torch.Generator().manual_seed(1))
    runs = {}
    for impl in ("auto", "xla"):
        cfg = llama.LlamaConfig.tiny(dim=256, n_heads=2, n_kv_heads=1,
                                     attention_impl=impl, loss_chunk=64)
        params = llama.init_params(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0))
        state, step = training.make_trainer(
            cfg, llama, optimizer=training.default_optimizer(
                warmup_steps=1, total_steps=10), params=params)
        A.reset_launch_counts()
        runs[impl] = [{k: v.item() for k, v in step(state, {"tokens": tokens}
                                                    )[1].items()}
                      for _ in range(3)]
        if impl == "auto":
            assert A.LAUNCHES["flash_bwd_dq"] == 3 * cfg.n_layers
            assert A.LAUNCHES["flash_bwd_dkv"] == 3 * cfg.n_layers
            assert A.LAUNCHES["flash_fwd"] == 6 * cfg.n_layers  # remat
    for got, want in zip(runs["auto"], runs["xla"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-4)
