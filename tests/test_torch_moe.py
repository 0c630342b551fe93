"""The PyTorch port's MoE path against the JAX package's, on the CPU: the
grouped layout, gmm (the plain versions of K5 and K6 against the JAX
kernels in interpret mode), moe_ffn's three dispatches with gradients, the
tiny Mixtral's loss and gradients, three trainer steps and greedy
generation. Inputs are made with numpy seeds and handed to both sides.

Tolerances: float32 gmm within atol/rtol 1e-5 (f32 sums of the same
products in another order); bf16 gmm by attention.flash_out_error within
GMM_FWD_ROW_LIMIT (each side rounds its f32 sums to bf16 once, the weight
gradient included); moe_ffn at the JAX package's own gmm-vs-dense
tolerances (tests/test_ops.py: 1e-4 outputs, 1e-3 gradients, aux rtol
1e-6); the model at the Llama parity tests' (loss rtol 1e-5, gradients
atol 1e-5 rtol 1e-3).

Routing: torch.topk and jax.lax.top_k agree only where no two router
logits tie, and a one-ulp difference in the router product can pick
another expert. So each comparison first checks that both sides chose the
same experts and that the top-k / top-(k+1) margin is far above the f32
difference of the two router products (ROUTE_MARGIN)."""

import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from metaflow_tpu.inference import decode as ref_decode  # noqa: E402
from metaflow_tpu.models import mixtral as ref_mixtral  # noqa: E402
from metaflow_tpu.spmd import MeshSpec, create_mesh  # noqa: E402
from metaflow_tpu.training import train_step as ref_ts  # noqa: E402
from metaflow_tpu_torch.inference import decode as port_decode  # noqa: E402
from metaflow_tpu_torch.models import mixtral as port_mixtral  # noqa: E402
from metaflow_tpu_torch.training import train_step as port_ts  # noqa: E402

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

# the packages export functions named `gmm` and `moe_ffn` over the modules
ref_gmm = importlib.import_module("metaflow_tpu.ops.gmm")
port_gmm = importlib.import_module("metaflow_tpu_torch.ops.gmm")
ref_moe = importlib.import_module("metaflow_tpu.ops.moe")
port_moe = importlib.import_module("metaflow_tpu_torch.ops.moe")
port_attn = importlib.import_module("metaflow_tpu_torch.ops.attention")

GMM_F32 = dict(atol=1e-5, rtol=1e-5)
MOE_OUT = dict(atol=1e-4, rtol=1e-4)
MOE_GRAD = dict(atol=1e-3, rtol=1e-3)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
# the smallest top-k / top-(k+1) router-logit gap a comparison accepts:
# the two sides' f32 router products differ by about 1e-6 here
ROUTE_MARGIN = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _layouts(gids, G, valid=None):
    ref = ref_gmm.make_group_layout(
        jnp.asarray(gids, jnp.int32), G,
        row_valid=None if valid is None else jnp.asarray(valid, jnp.int32))
    port = port_gmm.make_group_layout(
        torch.from_numpy(gids), G,
        row_valid=None if valid is None else torch.from_numpy(valid))
    return ref, port


LAYOUT_CASES = {
    "random": (_rng(0).integers(0, 4, 300), 4, None),
    "skewed_empty_and_one_row": (
        np.array([3] * 250 + [0] * 5 + [2] * 1), 4, None),
    "row_valid": (_rng(1).integers(0, 3, 300), 3,
                  (_rng(2).random(300) < 0.3).astype(np.int64)),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_group_layout_matches_exactly(case):
    gids, G, valid = LAYOUT_CASES[case]
    ref, port = _layouts(gids, G, valid)
    assert port["padded_len"] == ref["padded_len"]
    for key in ("dest", "tile_group", "tile_active"):
        np.testing.assert_array_equal(port[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    assert port["tile_group"].dtype == port["tile_active"].dtype == \
        torch.int32
    rows = torch.from_numpy(
        _rng(3).standard_normal((len(gids), 8)).astype(np.float32))
    padded = port_gmm.scatter_rows(rows, port)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(ref_gmm.scatter_rows(
            jnp.asarray(rows.numpy()), ref)))
    assert torch.equal(port_gmm.gather_rows(padded, port), rows)


def _gmm_case(gids, G, D, F, seed, dtype):
    rng = _rng(seed)
    rows = rng.standard_normal((len(gids), D)).astype(np.float32)
    w = (rng.standard_normal((G, D, F)) * 0.1).astype(np.float32)
    ref_layout, layout = _layouts(gids, G)
    x = np.array(ref_gmm.scatter_rows(jnp.asarray(rows), ref_layout))
    wt = rng.standard_normal((x.shape[0], F)).astype(np.float32)  # loss wt
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = (jnp.asarray(x, jdt), jnp.asarray(w, jdt), ref_layout)
    port = (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
            layout)
    return ref, port, wt


def _ref_gmm_and_grads(x, w, layout, wt):
    tg, ta = layout["tile_group"], layout["tile_active"]

    def loss(x, w):
        y = ref_gmm.gmm(x, w, tg, tile_active=ta)
        return jnp.sum(y.astype(jnp.float32) * wt), y

    (_, y), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                       has_aux=True)(x, w)
    return [np.array(t.astype(jnp.float32)) for t in (y, *grads)]


def _port_gmm_and_grads(x, w, layout, wt):
    x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = port_gmm.gmm(x, w, layout["tile_group"],
                     tile_active=layout["tile_active"])
    (y.float() * torch.from_numpy(wt)).sum().backward()
    assert x.grad.dtype == x.dtype and w.grad.dtype == w.dtype
    return [t.detach().float() for t in (y, x.grad, w.grad)]


GMM_CASES = {  # (group ids, G, D, F, seed, dtype)
    "f32_random": (_rng(4).integers(0, 4, 300), 4, 64, 128, 5, "float32"),
    "f32_empty_group_one_row": (np.array([3] * 250 + [0] * 5 + [2] * 1), 4,
                                32, 64, 6, "float32"),
    "bf16_random": (_rng(7).integers(0, 3, 517), 3, 32, 64, 8, "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_gmm_and_grads_match_jax(case):
    """y, dx and dw of the port's gmm (its Function on the plain versions)
    against the JAX gmm's custom_vjp in interpret mode."""
    ref_in, port_in, wt = _gmm_case(*GMM_CASES[case])
    want = _ref_gmm_and_grads(*ref_in, wt)
    got = _port_gmm_and_grads(*port_in, wt)
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        if GMM_CASES[case][-1] == "float32":
            np.testing.assert_allclose(a.numpy(), b, **GMM_F32, err_msg=name)
        else:
            err = port_attn.flash_out_error(a, torch.from_numpy(b))
            assert err <= port_gmm.GMM_FWD_ROW_LIMIT, (name, err)


def test_empty_group_gets_zero_weight_grad():
    """A group with no rows owns no tile: its dw comes back zero, and so
    does the last group's, which owns only the clamped padding tiles."""
    ref_in, (x, w, layout), wt = _gmm_case(
        np.array([0] * 100 + [2] * 100), 4, 32, 64, 9, "float32")
    _, _, dw = _port_gmm_and_grads(x, w, layout, wt)
    assert dw[1].abs().max() == 0 and dw[3].abs().max() == 0
    assert dw[0].abs().max() > 0 and dw[2].abs().max() > 0


def test_inactive_tiles_are_skipped():
    """A real tile forced inactive: its output rows are zero, the other
    tile's rows unchanged, and dw leaves its rows out."""
    rng = _rng(10)
    _, layout = _layouts(np.zeros(256, np.int64), 1)
    x = port_gmm.scatter_rows(
        torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32)),
        layout)
    w = torch.from_numpy(rng.standard_normal((1, 32, 64)).astype(np.float32))
    tg, ta = layout["tile_group"], layout["tile_active"]
    full = port_gmm.gmm(x, w, tg, tile_active=ta)
    forced = ta.clone()
    forced[1] = 0
    skipped = port_gmm.gmm(x, w, tg, tile_active=forced)
    assert skipped[128:256].abs().max() == 0
    assert torch.equal(skipped[:128], full[:128])
    dw = port_gmm._gmm_dw_plain(x, torch.ones(x.shape[0], 64), tg, forced, 1)
    np.testing.assert_allclose(
        dw[0].numpy(), (x[:128].t() @ torch.ones(128, 64)).numpy(),
        **GMM_F32)


def test_gmm_refusals():
    """The JAX package's refusals: D indivisible by the backward's block
    fails at the forward, also under autograd; the tuning args are
    keyword-only."""
    x = torch.ones(128, 192)
    w = torch.ones(2, 192, 128, requires_grad=True)
    tg = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="backward"):
        port_gmm.gmm(x, w, tg)
    with pytest.raises(ValueError, match="block_s"):
        port_gmm.gmm(torch.ones(100, 64), torch.ones(1, 64, 64), tg)
    with pytest.raises(TypeError):
        port_gmm.gmm(torch.ones(128, 64), torch.ones(1, 64, 64), tg, 128)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("x,w,want", [
    (_bf16(256, 64), _bf16(2, 64, 128), "tma"),
    # dx: the output gradient against the stored [G, N, K] weights
    (_bf16(256, 128), _bf16(2, 64, 128), "tma"),
    # rows padded to a 16-byte multiple (144 bytes), read in place
    (_bf16(256, 72)[:, :64], _bf16(2, 64, 128), "tma"),
    # K 37: x's rows are 74 bytes apart
    (_bf16(256, 37), _bf16(2, 37, 64), "cp_async"),
    # F 50: w's rows are 100 bytes apart
    (_bf16(256, 64), _bf16(2, 64, 50), "cp_async"),
    # a base one element past a 16-byte boundary
    (_bf16(256 * 64 + 1)[1:].view(256, 64), _bf16(2, 64, 128), "cp_async"),
    (_bf16(256, 64), _bf16(2 * 64 * 128 + 8)[8:].view(2, 64, 128), "tma"),
    # groups 8200 elements apart: a multiple of 8 elements, 16 bytes
    (_bf16(256, 64), _bf16(2, 8200)[:, :8192].view(2, 64, 128), "tma"),
    (_bf16(256, 64), _bf16(2, 8196)[:, :8192].view(2, 64, 128), "cp_async"),
    # K6's operands x [S, D] and dy [S, F]
    (_bf16(256, 64), _bf16(256, 128), "tma"),
    (_bf16(256, 64), _bf16(256, 50), "cp_async"),
    (_bf16(256, 64), _bf16(256 * 128 + 1)[1:].view(256, 128), "cp_async"),
], ids=["forward", "dx", "padded_rows", "x_rows_unaligned",
        "w_rows_unaligned", "x_base_unaligned", "w_base_aligned_offset",
        "w_groups_aligned", "w_groups_unaligned", "dw", "dw_dy_rows_unaligned",
        "dw_dy_base_unaligned"])
def test_gmm_fwd_producer_follows_strides_and_pointers(x, w, want):
    """The producer choice of K5 (x, w) and K6 (x, dy): TMA where tensor
    maps can describe every operand (16-byte aligned bases, strides but
    the last multiples of 16 bytes), cp.async otherwise; from pointers and
    strides alone, so a CPU tensor answers as a CUDA one would."""
    assert port_gmm._gmm_producer(x, w) == want


def test_gmm_dw_rounds_its_f32_sum_once():
    """K6's plain version in bf16 out is its f32 sum rounded once, the
    cast the backward made before it asked for w's dtype."""
    rng = _rng(12)
    _, layout = _layouts(rng.integers(0, 3, 300), 3)
    x = port_gmm.scatter_rows(torch.from_numpy(
        rng.standard_normal((300, 32)).astype(np.float32)), layout).to(
        torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((x.shape[0], 48)).astype(
        np.float32)).to(torch.bfloat16)
    tg, ta = layout["tile_group"], layout["tile_active"]
    f32 = port_gmm._gmm_dw_plain(x, dy, tg, ta, 3)
    bf16 = port_gmm._gmm_dw_plain(x, dy, tg, ta, 3, torch.bfloat16)
    assert f32.dtype == torch.float32 and bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    assert port_gmm.bf16_ulps(bf16, f32).max() == 0


def _moe_inputs(seed=2, B=2, S=16, E=128, F=128, N=4):
    rng = _rng(seed)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    router = (rng.standard_normal((E, N)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal(shape) * 0.05).astype(np.float32)
          for shape in ((N, E, F), (N, E, F), (N, F, E))]
    return x, router, ws


def _route_margin(logits, k):
    top = np.sort(logits, axis=-1)[:, ::-1]
    return float((top[:, k - 1] - top[:, k]).min())


def _ref_moe(x, router, ws, dispatch, capacity_factor, g):
    def fn(x, router, wg, wu, wd):
        out, aux = ref_moe.moe_ffn(x, router, wg, wu, wd,
                                   num_experts_per_tok=2,
                                   capacity_factor=capacity_factor,
                                   dispatch=dispatch)
        return jnp.sum(out * g) + 0.01 * aux, (out, aux)

    (_, (out, aux)), grads = jax.value_and_grad(
        fn, argnums=(0, 1, 2, 3, 4), has_aux=True)(x, router, *ws)
    return np.asarray(out), float(aux), [np.asarray(t) for t in grads]


def _port_moe(x, router, ws, dispatch, capacity_factor, g):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (x, router, *ws)]
    out, aux = port_moe.moe_ffn(*leaves, num_experts_per_tok=2,
                                capacity_factor=capacity_factor,
                                dispatch=dispatch)
    ((out * torch.from_numpy(g)).sum() + 0.01 * aux).backward()
    return out.detach().numpy(), aux.item(), [t.grad.numpy()
                                              for t in leaves]


@pytest.mark.parametrize("dispatch,capacity_factor", [
    ("gmm", None), ("sparse", None), ("sparse", 1.0), ("dense", None),
    ("dense", 1.0)])
def test_moe_ffn_matches_jax(dispatch, capacity_factor):
    """Output, aux and the gradients of x, the router and the three expert
    weights, each dispatch (with and without capacity drops) against the
    same dispatch of the JAX package, after checking that both routed
    every token to the same experts."""
    x, router, ws = _moe_inputs()
    g = _rng(3).standard_normal(x.shape).astype(np.float32)
    tokens = x.reshape(-1, x.shape[-1])
    ref_logits = np.asarray(jnp.asarray(tokens) @ jnp.asarray(router))
    port_logits = (torch.from_numpy(tokens) @ torch.from_numpy(router))
    _, ref_idx = jax.lax.top_k(jnp.asarray(ref_logits), 2)
    _, port_idx = port_moe.top_k_router(port_logits, 4, 2)
    np.testing.assert_array_equal(port_idx.numpy(), np.asarray(ref_idx))
    assert _route_margin(ref_logits, 2) > ROUTE_MARGIN

    want = _ref_moe(x, router, ws, dispatch, capacity_factor, g)
    got = _port_moe(x, router, ws, dispatch, capacity_factor, g)
    np.testing.assert_allclose(got[0], want[0], **MOE_OUT)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for name, a, b in zip(("x", "router", "w_gate", "w_up", "w_down"),
                          got[2], want[2]):
        np.testing.assert_allclose(a, b, **MOE_GRAD, err_msg=name)


@pytest.mark.parametrize("dispatch", ["gmm", "sparse", "dense"])
def test_dispatch_on_given_routing(dispatch):
    """Each dispatch function of the port on the JAX side's router choice
    (idx, weights) given explicitly, against the JAX moe_ffn's output."""
    x, router, ws = _moe_inputs(seed=4)
    tokens = x.reshape(-1, x.shape[-1])
    logits = jnp.asarray(tokens) @ jnp.asarray(router)
    weights, idx = ref_moe.top_k_router(logits, 4, 2)
    want, _ = ref_moe.moe_ffn(jnp.asarray(x), jnp.asarray(router),
                              *map(jnp.asarray, ws), num_experts_per_tok=2,
                              capacity_factor=None, dispatch="dense")
    t = torch.from_numpy(tokens)
    w_t = torch.from_numpy(np.array(weights))
    idx_t = torch.from_numpy(np.array(idx)).long()
    tw = [torch.from_numpy(a) for a in ws]
    if dispatch == "gmm":
        out = port_moe._gmm_dispatch_ffn(t, w_t, idx_t, *tw, 4, 2,
                                         torch.nn.functional.silu)
    elif dispatch == "sparse":
        out = port_moe._sparse_dispatch_ffn(t, w_t, idx_t, *tw, 4, 2, None,
                                            torch.nn.functional.silu)
    else:
        one_hot = torch.nn.functional.one_hot(idx_t, 4).float()
        out = port_moe._dense_dispatch_ffn(t, w_t, idx_t, one_hot, *tw, 4,
                                           2, None, torch.nn.functional.silu)
    np.testing.assert_allclose(out.reshape(x.shape).numpy(),
                               np.asarray(want), **MOE_OUT)


def test_moe_refuses_what_is_not_ported():
    x, router, ws = _moe_inputs()
    args = [torch.from_numpy(a) for a in (x, router, *ws)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_moe.moe_ffn(*args, dispatch="gmm_ep")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_moe.moe_ffn(*args, dispatch="sparse", mesh=object())
    with pytest.raises(ValueError, match="dropless"):
        port_moe.moe_ffn(*args, dispatch="gmm", capacity_factor=1.0)


def _recorded_margins(monkeypatch):
    """Patch the port's router to record each call's top-k margin."""
    margins, route = [], port_moe.top_k_router

    def recording(logits, num_experts, k, dtype=torch.float32):
        margins.append(_route_margin(logits.detach().float().numpy(), k))
        return route(logits, num_experts, k, dtype)

    monkeypatch.setattr(port_moe, "top_k_router", recording)
    return margins


@pytest.fixture(scope="module")
def jax_model():
    cfg = ref_mixtral.MixtralConfig.tiny(moe_dispatch="gmm")
    params = ref_mixtral.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jax.tree.map(lambda a: np.array(a, copy=True), params)


def test_mixtral_loss_and_grads_match_jax(jax_model, monkeypatch):
    """The tiny Mixtral (gmm dispatch, remat) loss and every gradient."""
    cfg, np_params = jax_model
    tokens = _rng(11).integers(0, cfg.vocab_size, (2, 17))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: ref_mixtral.loss_fn(p, {"tokens": t}, cfg)))(
            np_params, jnp.asarray(tokens, jnp.int32))
    port_cfg = port_mixtral.MixtralConfig.tiny(moe_dispatch="gmm")
    params = port_mixtral.from_jax_params(np_params, port_cfg, device="cpu")
    for _, p in port_ts.leaves(params):
        p.requires_grad_(True)
    margins = _recorded_margins(monkeypatch)
    got = port_mixtral.loss_fn(params, {"tokens": tokens}, port_cfg,
                               device="cpu")
    got.backward()
    # each layer routes twice: in the forward and in its recompute
    assert len(margins) == 2 * cfg.n_layers
    assert min(margins) > ROUTE_MARGIN
    np.testing.assert_allclose(got.item(), float(loss), rtol=1e-5)
    for path, p in port_ts.leaves(params):
        want = grads
        for key in path:
            want = want[key]
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want),
                                   **GRAD_TOL, err_msg="/".join(path))


def test_trainer_matches_jax(jax_model, monkeypatch):
    """Three steps of the port's make_trainer on the tiny Mixtral (gmm
    dispatch) against the JAX make_trainer on a one-device CPU mesh: loss
    and grad norm per step within 1e-4 relative, as the Llama trainer
    test holds them."""
    cfg, np_params = jax_model
    mesh = create_mesh(MeshSpec.dp(), devices=jax.devices()[:1])
    opt = ref_ts.default_optimizer(warmup_steps=1, total_steps=10)
    state, step, _ = ref_ts.make_trainer(jax.random.PRNGKey(0), cfg, mesh,
                                         ref_mixtral, optimizer=opt)
    params0 = jax.tree.map(lambda a: np.array(a, copy=True), state["params"])
    tokens = _rng(12).integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    batch = ref_ts.shard_batch({"tokens": tokens}, mesh)
    want = []
    with mesh:
        for _ in range(3):
            state, m = step(state, batch)
            want.append((float(m["loss"]), float(m["grad_norm"])))

    port_cfg = port_mixtral.MixtralConfig.tiny(moe_dispatch="gmm")
    params = port_mixtral.from_jax_params(params0, port_cfg, device="cpu")
    pstate, pstep = port_ts.make_trainer(
        port_cfg, port_mixtral, optimizer=port_ts.default_optimizer(
            warmup_steps=1, total_steps=10), params=params, device="cpu")
    margins = _recorded_margins(monkeypatch)
    for i in range(3):
        pstate, m = pstep(pstate, {"tokens": tokens})
        np.testing.assert_allclose(
            [m["loss"].item(), m["grad_norm"].item()], want[i], rtol=1e-4,
            err_msg="step %d" % i)
    assert min(margins) > ROUTE_MARGIN


def test_greedy_generate_matches_jax(jax_model):
    """Greedy decoding of the tiny Mixtral (the MoE decode branch: gmm
    routed to lossless sparse) gives the JAX package's tokens."""
    cfg, np_params = jax_model
    prompt = _rng(13).integers(0, cfg.vocab_size, (2, 7))
    want = ref_decode.generate(jax.tree.map(jnp.asarray, np_params),
                               jnp.asarray(prompt, jnp.int32), cfg, 6)
    port_cfg = port_mixtral.MixtralConfig.tiny(moe_dispatch="gmm")
    params = port_mixtral.from_jax_params(np_params, port_cfg, device="cpu")
    with torch.no_grad():
        got = port_decode.generate(params, prompt, port_cfg, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
