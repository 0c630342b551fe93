"""The kernels on the card against their plain versions, at shapes beyond
chip_smoke.py's: the flash forward (K1) and backward (K2, K3) at ragged
and long sequence lengths, strided inputs and output gradients, head dim
64, GQA, the dispatcher's and autograd's routes to the kernels, and one
trainer step through them; K3 over GQA groups of 1, 2 and 4 and on ring
shard views; K2 over GQA groups of 1, 2 and 4 on more work items than
SMs and on ragged ring shard views; the grouped matmul K5 (both weight
layouts, both producers, a persistent grid over more tiles than SMs, a
single tile) and K6 over empty and one-row groups, row_valid padding, D
and F tails and both dtypes, an empty group, a single tile, a group of
many waves and skewed routing on both producers, its bf16 output, its
autograd route, a Mixtral trainer step through K5/K6 against plain gmm,
and that step with no host synchronisation; the ring hop's forward K4 on
shard views (diagonal and full, ragged lengths, head dim 64, GQA, more
work items than SMs), ring attention on LocalRing(n) against the flash
path through autograd, and a trainer step through the ring. Needs an
NVIDIA GPU (tests/conftest.py imports jax, so skip it where jax is
missing):

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import importlib

import pytest
import torch

A = importlib.import_module("metaflow_tpu_torch.ops.attention")
R = importlib.import_module("metaflow_tpu_torch.ops.ring_attention")
G = importlib.import_module("metaflow_tpu_torch.ops.gmm")
L = importlib.import_module("metaflow_tpu_torch.ops.launches")

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


@pytest.mark.parametrize("B,S,H,KV,D,causal", [
    (1, 4096, 4, 2, 128, False),  # 32 key tiles a block, both stages reused
    (2, 1000, 4, 1, 64, True),    # D 64, S not a multiple of 128
])
def test_kernel_at_long_and_ragged_lengths(cuda, B, S, H, KV, D, causal):
    q, k, v = (torch.randn(B, S, h, D, generator=cuda, device="cuda").to(
        torch.bfloat16) for h in (H, KV, KV))
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
    L.reset_launch_counts()
    A.attention(q, q, q, impl="auto")
    assert L.LAUNCHES["flash_fwd"] == 1
    A.attention(q[:, :, :, :64], q[:, :, :, :64], q[:, :, :, :64],
                impl="auto")  # D % 128 != 0: the plain path
    assert L.LAUNCHES["flash_fwd"] == 1
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
    L.reset_launch_counts()
    got = llama.forward(on_card, tokens, cfg)
    assert L.LAUNCHES["flash_fwd"] == cfg.n_layers
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


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_kernel_over_gqa_groups(cuda, group, D, causal):
    """K3 (with K2) at GQA groups of 1, 2 and 4 q heads a kv head, over a
    ragged length: more work items than SMs, q tiles streamed over every
    head of a group."""
    KV, S = 2, 320
    q, g = (torch.randn(3, S, KV * group, D, generator=cuda,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(3, S, KV, D, generator=cuda, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    _check_bwd(q, k, v, g, causal)


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_dkv_kernel_reads_ring_shard_views(cuda, diag, D):
    """K3 and K2 as the ring's backward runs them: q, dO the second shard
    of a two-shard sequence, k, v the same shard (diagonal, causal) or the
    first (full, non-causal), all views read through their strides."""
    q, k, v = _shard_views(cuda, 2, 256, 8, 4, D, torch.bfloat16, diag)
    g = torch.randn(2, 512, 8, D, generator=cuda, device="cuda").to(
        torch.bfloat16)[:, 256:]
    _check_bwd(q, k, v, g, diag)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_dq_kernel_over_more_items_than_sms(cuda, group, D, causal):
    """K2 (with K3) at GQA groups of 1, 2 and 4 over a ragged length with
    more work items (128 q rows of a q head) than the card has SMs, so each
    persistent block walks several items and its K / V ring runs on across
    them."""
    B, KV, S = 5, 4, 1000  # 8 q blocks x 20 group heads: 160 items or more
    q, g = (torch.randn(B, S, KV * group, D, generator=cuda,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, S, KV, D, generator=cuda, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    _check_bwd(q, k, v, g, causal)


@pytest.mark.parametrize("S", [200, 333])
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_dq_kernel_reads_ragged_ring_shard_views(cuda, S, diag, D):
    """K2 and K3 on ring shard views whose length is no multiple of a key
    tile or of a work item's rows: q, dO the second shard of a two-shard
    sequence, k, v the same shard (diagonal, causal) or the first (full)."""
    q, k, v = _shard_views(cuda, 2, S, 8, 2, D, torch.bfloat16, diag)
    g = torch.randn(2, 2 * S, 8, D, generator=cuda, device="cuda").to(
        torch.bfloat16)[:, S:]
    _check_bwd(q, k, v, g, diag)


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
        L.reset_launch_counts()
        got = grads("auto", w)
        assert (L.LAUNCHES["flash_fwd"], L.LAUNCHES["flash_bwd_dq"],
                L.LAUNCHES["flash_bwd_dkv"]) == (1, 1, 1)
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
        L.reset_launch_counts()
        runs[impl] = [{k: v.item() for k, v in step(state, {"tokens": tokens}
                                                    )[1].items()}
                      for _ in range(3)]
        if impl == "auto":
            assert L.LAUNCHES["flash_bwd_dq"] == 3 * cfg.n_layers
            assert L.LAUNCHES["flash_bwd_dkv"] == 3 * cfg.n_layers
            assert L.LAUNCHES["flash_fwd"] == 6 * cfg.n_layers  # remat
    for got, want in zip(runs["auto"], runs["xla"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-4)


def _shard_views(gen, B, S, H, KV, D, dt, diag):
    """q, k, v of one ring hop as views of two-shard sequences: q the
    second shard, k and v the same shard (diagonal) or the first (full)."""
    q, k, v = (torch.randn(B, 2 * S, h, D, generator=gen, device="cuda")
               .to(dt) for h in (H, KV, KV))
    kv = slice(S, 2 * S) if diag else slice(0, S)
    return q[:, S:], k[:, kv], v[:, kv]


@pytest.mark.parametrize("S", [1, 50, 64, 256, 384, 333, 1000, 2100])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("diag", [True, False])
def test_block_fwd_kernel_matches_plain(cuda, S, dtype, D, diag):
    """K4 on strided shard views against its plain version: acc / l, m
    and lse, as chip_smoke.py's phase 8a holds them. Ragged lengths mask
    the last key tile past S; at S 2100 the bf16 kernel has more work
    items (17 q blocks x 2 batches x 4 heads) than the card has SMs."""
    dt = getattr(torch, dtype)
    q, k, v = _shard_views(cuda, 2, S, 4, 2, D, dt, diag)
    assert not q.is_contiguous()
    scale = D ** -0.5
    got = A._flash_block_fwd_cuda(q, k, v, scale, diag)
    want = A._flash_block_fwd_plain(q, k, v, scale, diag)
    torch.cuda.synchronize()
    r = A.flash_block_readings(*got, want)
    assert r["m"] <= A.FLASH_BLOCK_STATS_LIMIT, r
    assert r["lse"] <= A.FLASH_BLOCK_STATS_LIMIT, r
    if dt == torch.float32:
        torch.testing.assert_close(A.flash_block_output(got[0], got[2]),
                                   A.flash_block_output(want[0], want[2]),
                                   atol=1e-5, rtol=0)
    else:
        assert r["acc"] <= A.FLASH_BLOCK_ROW_LIMIT, r


def test_block_fwd_dispatch_and_refusals(cuda):
    q = torch.randn(1, 256, 2, 128, generator=cuda, device="cuda").to(
        torch.bfloat16)
    L.reset_launch_counts()
    acc, m, l = A.flash_block_fwd(q, q, q, 0.1, True)
    assert L.LAUNCHES["flash_block_fwd"] == 1 and acc.is_cuda
    with pytest.raises(ValueError, match="head dims"):
        A.flash_block_fwd(*(torch.zeros(1, 128, 2, 96, device="cuda"),) * 3,
                          0.1, True)
    with pytest.raises(ValueError, match="divisible by the"):
        A.flash_block_fwd(q[:, :130], q[:, :130], q[:, :130], 0.1, True)
    assert L.LAUNCHES["flash_block_fwd"] == 1


def _ring_grads(fn, leaves, g):
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    out.backward(g)
    return [out.detach()] + [t.grad for t in leaves]


@pytest.mark.parametrize("n,S,causal", [(2, 256, True), (3, 384, True),
                                        (4, 256, False)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("D", [64, 128])
def test_ring_matches_flash_path(cuda, n, S, causal, dtype, D):
    """ring_attention on LocalRing(n) through autograd (K4 forward, K2/K3
    backward) against flash_attention (K1-K3) on the same whole-sequence
    views: the JAX ring tests' tolerances in f32, the row limits in bf16.
    A causal ring launches K4 and K2, K3 on the n diagonal and
    n (n - 1) / 2 earlier-shard hops; a non-causal one on all n^2."""
    dt = getattr(torch, dtype)
    qkv = torch.randn(2, S, 8, D, generator=cuda, device="cuda").to(dt)
    leaves = (qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:])  # GQA views
    g = torch.randn(2, S, 4, D, generator=cuda, device="cuda").to(dt)
    L.reset_launch_counts()
    got = _ring_grads(lambda a, b, c: R.ring_attention(
        a, b, c, R.LocalRing(n), causal=causal), leaves, g)
    hops = n * (n + 1) // 2 if causal else n * n
    assert (L.LAUNCHES["flash_block_fwd"], L.LAUNCHES["flash_bwd_dq"],
            L.LAUNCHES["flash_bwd_dkv"], L.LAUNCHES["flash_fwd"]) == (
                hops, hops, hops, 0)
    want = _ring_grads(lambda a, b, c: A.flash_attention(
        a, b, c, causal=causal), leaves, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == dt and a.shape == b.shape, name
        if dt == torch.float32:
            tol = (dict(atol=2e-5, rtol=2e-4) if name == "out"
                   else dict(atol=1e-5, rtol=1e-3))
            torch.testing.assert_close(a, b, msg=name, **tol)
        else:
            limit = (A.FLASH_BF16_ROW_LIMIT if name == "out"
                     else A.FLASH_BWD_ROW_LIMIT)
            assert A.flash_out_error(a, b) <= limit, name


def test_ring_auto_takes_the_kernels_on_aligned_shards(cuda):
    """impl='auto' on a CUDA tensor is the flash ring: aligned shards
    launch K4, unaligned ones raise (auto and flash alike) and launch
    nothing; only an explicit impl='xla' runs the einsum ring."""
    q = torch.randn(1, 520, 2, 128, generator=cuda, device="cuda").to(
        torch.bfloat16)
    aligned = q[:, :512]
    L.reset_launch_counts()
    R.ring_attention(aligned, aligned, aligned, R.LocalRing(4))
    assert L.LAUNCHES["flash_block_fwd"] == 10
    for impl in ("auto", "flash"):  # shards of 130
        with pytest.raises(ValueError, match="per-device sequence shard"):
            R.ring_attention(q, q, q, R.LocalRing(4), impl=impl)
    R.ring_attention(q, q, q, R.LocalRing(4), impl="xla")
    assert L.LAUNCHES["flash_block_fwd"] == 10


def test_trainer_step_through_the_ring(cuda):
    """Two trainer steps of a 2-layer full-width bench_1b in float32
    through the ring on LocalRing(4) (K4, K2, K3 on 256-row shards)
    against the same steps through K1-K3 with no mesh."""
    from metaflow_tpu_torch import training
    from metaflow_tpu_torch.models import llama

    tokens = torch.randint(0, 32000, (1, 1025),
                           generator=torch.Generator().manual_seed(1))
    runs = {}
    for impl, mesh in (("ring", R.LocalRing(4)), ("auto", None)):
        cfg = llama.LlamaConfig.bench_1b(n_layers=2, dtype="float32",
                                         attention_impl=impl)
        params = llama.init_params(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0))
        state, step = training.make_trainer(
            cfg, llama, optimizer=training.default_optimizer(
                warmup_steps=1, total_steps=10), params=params, mesh=mesh)
        L.reset_launch_counts()
        runs[impl] = [{k: v.item() for k, v in step(state, {"tokens": tokens}
                                                    )[1].items()}
                      for _ in range(2)]
        if impl == "ring":  # 10 live hops a layer pass, the forward twice
            assert L.LAUNCHES["flash_block_fwd"] == 2 * 2 * 10 * cfg.n_layers
            assert L.LAUNCHES["flash_bwd_dq"] == 2 * 10 * cfg.n_layers
            assert L.LAUNCHES["flash_fwd"] == 0
        del state, step, params
    for got, want in zip(runs["ring"], runs["auto"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-4)


# (group ids, groups, D, F, valid share): empty groups and a one-row group,
# row_valid padding, D and F tails (multiples of 8 read by cp.async, odd
# ones element by element), several row tiles per group
GMM_CASES = {
    "empty_and_one_row": ([3] * 250 + [0] * 5 + [2] * 1, 4, 32, 64, None),
    "row_valid": ("random", 3, 64, 128, 0.3),
    "tails_aligned": ("random", 5, 40, 72, None),
    "tails_unaligned": ("random", 3, 37, 50, None),
    "multi_tile": ("random", 8, 256, 384, None),
}


def _gmm_inputs(case, dtype, gen):
    gids, groups, D, F, valid_share = GMM_CASES[case]
    if gids == "random":
        gids = torch.randint(0, groups, (700,), generator=gen, device="cuda")
    gids = torch.as_tensor(gids, device="cuda")
    valid = None
    if valid_share is not None:
        valid = (torch.rand(gids.shape, generator=gen, device="cuda")
                 < valid_share).long()
    layout = G.make_group_layout(gids, groups, row_valid=valid)
    rows = torch.randn(gids.shape[0], D, generator=gen, device="cuda")
    if valid is not None:  # padding rows carry zeros, as gmm_ep's do
        rows = rows * valid[:, None]
    x = G.scatter_rows(rows, layout).to(dtype)
    w = (torch.randn(groups, D, F, generator=gen, device="cuda") * 0.1).to(
        dtype)
    dy = torch.randn(x.shape[0], F, generator=gen, device="cuda").to(dtype)
    return x, w, dy, layout


def _assert_gmm_close(got, want, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype == torch.float32 and name != "dw_bf16":
        # f32 on both sides: the sums differ only in order
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5, msg=name)
    else:
        # K6's f32 dw from bf16 operands is held to its own limit; an
        # output rounded to bf16 (K5's, or a bf16 weight gradient) to K5's
        err = A.flash_out_error(got, want)
        limit = (G.GMM_DW_ROW_LIMIT if got.dtype == torch.float32
                 else G.GMM_FWD_ROW_LIMIT)
        assert err <= limit, (name, err)


@pytest.mark.parametrize("case", sorted(GMM_CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gmm_kernels_match_plain(cuda, case, dtype):
    """K5 (w as stored, and transposed for dx) and K6 against their plain
    versions."""
    dt = getattr(torch, dtype)
    x, w, dy, layout = _gmm_inputs(case, dt, cuda)
    tg, ta = layout["tile_group"], layout["tile_active"]
    tag = "" if dt == torch.float32 else "_bf16"
    _assert_gmm_close(G._gmm_fwd_cuda(x, w, tg, ta),
                      G._gmm_fwd_plain(x, w, tg, ta), "y" + tag)
    _assert_gmm_close(G._gmm_fwd_cuda(dy, w, tg, ta, w_transposed=True),
                      G._gmm_fwd_plain(dy, w, tg, ta, w_transposed=True),
                      "dx" + tag)
    _assert_gmm_close(G._gmm_dw_cuda(x, dy, tg, ta, w.shape[0]),
                      G._gmm_dw_plain(x, dy, tg, ta, w.shape[0]), "dw" + tag)


def test_gmm_inactive_tile_is_skipped_and_zeroed(cuda):
    """A real tile forced inactive: K5 writes zeros over whatever the
    output memory held, and K6 leaves its rows out."""
    x, w, dy, layout = _gmm_inputs("multi_tile", torch.bfloat16, cuda)
    tg, ta = layout["tile_group"], layout["tile_active"].clone()
    ta[1] = 0
    assert torch.count_nonzero(x[128:256]) > 0
    torch.full((x.shape[0], w.shape[2]), float("nan"), dtype=x.dtype,
               device="cuda")
    y = G._gmm_fwd_cuda(x, w, tg, ta)  # reuses the freed NaN block
    assert torch.isfinite(y).all() and y[128:256].abs().max() == 0
    _assert_gmm_close(y, G._gmm_fwd_plain(x, w, tg, ta), "y_bf16")
    _assert_gmm_close(G._gmm_dw_cuda(x, dy, tg, ta, w.shape[0]),
                      G._gmm_dw_plain(x, dy, tg, ta, w.shape[0]), "dw_bf16")


def _unaligned_copy(t):
    """t's values in a tensor whose base is one element past a 16-byte
    boundary, which no TMA tensor map can describe."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("producer", ["tma", "cp_async"])
def test_gmm_persistent_grid_over_many_tiles(cuda, producer):
    """K5 (forward and dx) with more output tiles than the card has SMs,
    so each persistent block walks several, and inactive tiles between
    active ones, on both producers."""
    n, groups, D, F = 4800, 6, 256, 1024
    gids = torch.randint(0, groups, (n,), generator=cuda, device="cuda")
    layout = G.make_group_layout(gids, groups)
    x = G.scatter_rows(torch.randn(n, D, generator=cuda, device="cuda"),
                       layout).to(torch.bfloat16)
    w = (torch.randn(groups, D, F, generator=cuda, device="cuda")
         * D ** -0.5).to(torch.bfloat16)
    dy = torch.randn(x.shape[0], F, generator=cuda, device="cuda").to(
        torch.bfloat16)
    tg, ta = layout["tile_group"], layout["tile_active"].clone()
    ta[1::3] = 0  # every third tile inactive, real rows or not
    n_tiles = tg.shape[0] * ((F + 255) // 256)
    assert n_tiles > torch.cuda.get_device_properties(0).multi_processor_count
    if producer == "cp_async":
        x, w, dy = (_unaligned_copy(t) for t in (x, w, dy))
    assert G._gmm_producer(x, w) == producer
    assert G._gmm_producer(dy, w) == producer
    torch.full((x.shape[0], F), float("nan"), dtype=x.dtype, device="cuda")
    y = G._gmm_fwd_cuda(x, w, tg, ta)  # reuses the freed NaN block
    assert torch.isfinite(y).all()
    assert y.view(-1, 128, F)[1::3].abs().max() == 0
    _assert_gmm_close(y, G._gmm_fwd_plain(x, w, tg, ta), "y_bf16")
    _assert_gmm_close(G._gmm_fwd_cuda(dy, w, tg, ta, w_transposed=True),
                      G._gmm_fwd_plain(dy, w, tg, ta, w_transposed=True),
                      "dx_bf16")


@pytest.mark.parametrize("producer", ["tma", "cp_async"])
def test_gmm_single_tile(cuda, producer):
    """K5 on one 128-row tile and one column block: a grid of one block."""
    x = torch.randn(128, 64, generator=cuda, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn(1, 64, 192, generator=cuda, device="cuda") * 0.1).to(
        torch.bfloat16)
    dy = torch.randn(128, 192, generator=cuda, device="cuda").to(
        torch.bfloat16)
    if producer == "cp_async":
        x, w, dy = (_unaligned_copy(t) for t in (x, w, dy))
    assert G._gmm_producer(x, w) == producer
    tg = torch.zeros(1, dtype=torch.int32, device="cuda")
    ta = torch.ones_like(tg)
    _assert_gmm_close(G._gmm_fwd_cuda(x, w, tg, ta),
                      G._gmm_fwd_plain(x, w, tg, ta), "y_bf16")
    _assert_gmm_close(G._gmm_fwd_cuda(dy, w, tg, ta, w_transposed=True),
                      G._gmm_fwd_plain(dy, w, tg, ta, w_transposed=True),
                      "dx_bf16")


# K6 cases: (group of each 128-row tile, groups, D, F). "empty_group"
# leaves group 1 without a tile; "single_tile" is one group of one tile;
# "many_waves" gives one group more (D block, F block) items than the card
# has SMs, each over 12 tiles; "skewed" routes most rows to one group.
DW_CASES = {
    "empty_group": ([0, 0, 2, 2, 2], 3, 256, 512),
    "single_tile": ([0], 1, 192, 320),
    "many_waves": ([0] * 12 + [1] * 2, 2, 2048, 4096),
    "skewed": ([0] + [1] * 20 + [2] + [3], 4, 512, 1024),
}


@pytest.mark.parametrize("producer", ["tma", "cp_async"])
@pytest.mark.parametrize("case", sorted(DW_CASES))
def test_gmm_dw_kernel_cases(cuda, case, producer):
    """K6 against its plain version (f32 out within GMM_DW_ROW_LIMIT), a
    group without tiles written as zeros over poisoned memory, and its
    bf16 output bit for bit its own f32 sum rounded once (the cast the
    backward made before), on both producers."""
    tiles, groups, D, F = DW_CASES[case]
    tg = torch.tensor(tiles, dtype=torch.int32, device="cuda")
    ta = torch.ones_like(tg)
    S = 128 * len(tiles)
    x = torch.randn(S, D, generator=cuda, device="cuda").to(torch.bfloat16)
    dy = torch.randn(S, F, generator=cuda, device="cuda").to(torch.bfloat16)
    if producer == "cp_async":
        x, dy = (_unaligned_copy(t) for t in (x, dy))
    assert G._gmm_producer(x, dy) == producer
    torch.full((groups, D, F), float("nan"), device="cuda")
    got = G._gmm_dw_cuda(x, dy, tg, ta, groups)  # reuses the NaN block
    want = G._gmm_dw_plain(x, dy, tg, ta, groups)
    assert torch.isfinite(got).all()
    for g in range(groups):
        if g not in tiles:
            assert got[g].abs().max() == 0
    _assert_gmm_close(got, want, "dw_bf16")
    got_bf16 = G._gmm_dw_cuda(x, dy, tg, ta, groups,
                              out_dtype=torch.bfloat16)
    assert got_bf16.dtype == torch.bfloat16
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


def test_gmm_dw_refuses_what_it_does_not_write(cuda):
    """K6 writes f32 or the operands' dtype; bf16 out from f32 operands is
    refused."""
    x = torch.randn(128, 64, generator=cuda, device="cuda")
    tg = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="writes float32"):
        G._gmm_dw_cuda(x, x, tg, torch.ones_like(tg), 1,
                       out_dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gmm_autograd_runs_the_kernels(cuda, dtype):
    """gmm on tensors that require grad launches K5 once forward and once
    for dx, K6 once; its gradients equal the plain versions'."""
    dt = getattr(torch, dtype)
    x, w, dy, layout = _gmm_inputs("multi_tile", dt, cuda)
    tg, ta = layout["tile_group"], layout["tile_active"]
    xl, wl = (t.clone().requires_grad_(True) for t in (x, w))
    L.reset_launch_counts()
    y = G.gmm(xl, wl, tg, tile_active=ta)
    y.backward(dy)
    assert (L.LAUNCHES["gmm_fwd"], L.LAUNCHES["gmm_dw"]) == (2, 1)
    assert xl.grad.dtype == wl.grad.dtype == dt
    want_dx = G._gmm_fwd_plain(dy, w, tg, ta, w_transposed=True)
    want_dw = G._gmm_dw_plain(x, dy, tg, ta, w.shape[0]).to(dt)
    tag = "" if dt == torch.float32 else "_bf16"
    _assert_gmm_close(xl.grad, want_dx, "dx" + tag)
    _assert_gmm_close(wl.grad, want_dw, "dw" + tag)
    with pytest.raises(ValueError, match="block_s"):
        G.gmm(x, w, tg, tile_active=ta, block_s=64)


def _tiny_mixtral(**kw):
    from metaflow_tpu_torch.models import mixtral

    # head dim 128 for the flash kernels; 4 experts of 256
    return mixtral, mixtral.MixtralConfig.tiny(
        dim=256, n_heads=2, n_kv_heads=1, moe_dispatch="gmm", **kw)


def test_mixtral_trainer_step_matches_plain_gmm(cuda, monkeypatch):
    """Two trainer steps of a float32 Mixtral (gmm dispatch) through K5
    and K6 against the same steps with gmm's plain versions."""
    from metaflow_tpu_torch import training

    mixtral, cfg = _tiny_mixtral()
    tokens = torch.randint(0, cfg.vocab_size, (2, 129),
                           generator=torch.Generator().manual_seed(1))
    runs = {}
    for route in ("kernels", "plain"):
        if route == "plain":
            monkeypatch.setattr(G, "_gmm_fwd_cuda", G._gmm_fwd_plain)
            monkeypatch.setattr(G, "_gmm_dw_cuda", G._gmm_dw_plain)
        params = mixtral.init_params(cfg, torch.Generator(device="cuda")
                                     .manual_seed(0))
        state, step = training.make_trainer(
            cfg, mixtral, optimizer=training.default_optimizer(
                warmup_steps=1, total_steps=10), params=params)
        L.reset_launch_counts()
        runs[route] = [{k: v.item() for k, v in step(
            state, {"tokens": tokens})[1].items()} for _ in range(2)]
        if route == "kernels":  # 3 forward, 3 recomputed, 3 dx a layer
            assert L.LAUNCHES["gmm_fwd"] == 2 * 9 * cfg.n_layers
            assert L.LAUNCHES["gmm_dw"] == 2 * 3 * cfg.n_layers
    for got, want in zip(runs["kernels"], runs["plain"]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-4)


def test_mixtral_step_does_not_synchronise(cuda):
    """A bf16 trainer step of the Mixtral (gmm dispatch) on tokens already
    on the card reads nothing back to the host."""
    from metaflow_tpu_torch import training

    mixtral, cfg = _tiny_mixtral(dtype="bfloat16")
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), generator=cuda,
                           device="cuda")
    state, step = training.make_trainer(cfg, mixtral, generator=cuda)
    step(state, {"tokens": tokens})  # builds and loads the kernels
    torch.cuda.synchronize()
    L.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, metrics = step(state, {"tokens": tokens})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert L.LAUNCHES["gmm_fwd"] == 9 * cfg.n_layers
    assert torch.isfinite(metrics["loss"]).item()


CARD_GANG = '''
from metaflow_tpu_torch import FlowSpec, current, gpu, step


def reduce_both():
    """All-reduce a CPU tensor and a CUDA tensor over the gang."""
    import torch
    import torch.distributed as dist

    rank = current.parallel.node_index
    on_cpu = torch.tensor([float(rank + 1)])
    dist.all_reduce(on_cpu)
    on_card = torch.full((1024,), float(rank + 1), device="cuda")
    dist.all_reduce(on_card)
    return [rank, dist.get_backend(), torch.cuda.current_device(),
            on_cpu.item(), on_card.min().item(), on_card.max().item()]


class CardGangFlow(FlowSpec):
    @step
    def start(self):
        self.next(self.on_gpu, num_parallel=RANKS)

    @gpu(require_gpu=True)
    @step
    def on_gpu(self):
        self.out = reduce_both()
        self.next(self.join_gpu)

    @step
    def join_gpu(self, inputs):
        self.outs = sorted(inp.out for inp in inputs)
        self.next(self.between)

    @step
    def between(self):
        self.next(self.plain, num_parallel=RANKS)

    @step
    def plain(self):
        self.out = reduce_both()
        self.next(self.join_plain)

    @step
    def join_plain(self, inputs):
        self.outs = sorted(inp.out for inp in inputs)
        self.next(self.end)

    @step
    def end(self):
        pass


if __name__ == "__main__":
    CardGangFlow()
'''


def test_card_gang_reduces_cpu_and_cuda_tensors(tmp_path, monkeypatch):
    """A num_parallel gang of one rank per card (up to 4), once with @gpu
    and once without: in both, each rank sits on card node_index, and an
    all_reduce of a CPU tensor (gloo) and of a CUDA tensor (NCCL) gives the
    sum over the ranks."""
    import os
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards or more: NCCL refuses two ranks on "
                    "one card")
    ranks = min(torch.cuda.device_count(), 4)
    path = tmp_path / "card_gang_flow.py"
    path.write_text(CARD_GANG.replace("RANKS", str(ranks)))
    root = str(tmp_path / "root")
    env = dict(os.environ, TPUFLOW_DATASTORE_SYSROOT_LOCAL=root,
               TPUFLOW_CLIENT_CACHE=str(tmp_path / "cache"),
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, str(path), "run"], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    monkeypatch.setenv("TPUFLOW_DATASTORE_SYSROOT_LOCAL", root)
    from metaflow_tpu_torch import client

    client.namespace(None)
    run = client.Flow("CardGangFlow").latest_run
    assert run.successful
    total = float(ranks * (ranks + 1) // 2)
    want = [[r, "cpu:gloo,cuda:nccl", r, total, total, total]
            for r in range(ranks)]
    assert run["join_gpu"].task.data.outs == want
    assert run["join_plain"].task.data.outs == want
