"""The port's memory_efficient_optimizer (factored Adafactor) against the
JAX package's, on the CPU: the update against eager optax in f32 and
against the reference's chain inside one jitted step in bf16, the factored
axes and state shapes, the opt-state guard across the two optimizers, and
three steps of the tiny trainer against the JAX make_trainer."""

import numpy as np
import pytest
import torch

from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.training import train_step as port_ts

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

STEPS = 3
KW = dict(lr=1e-2, warmup_steps=0, total_steps=10)


@pytest.fixture(scope="module")
def ref():
    """The JAX side, imported only here."""
    jax = pytest.importorskip("jax")
    import optax

    from metaflow_tpu.models import llama as ref_llama
    from metaflow_tpu.spmd import MeshSpec, create_mesh
    from metaflow_tpu.training import train_step as ref_ts

    return jax, optax, ref_llama, ref_ts, MeshSpec, create_mesh


def _tree(rng, dtype):
    """Leaves of each kind: unfactored ([4, 8], [100]), a stacked layer
    leaf factored over its last two axes and one factored over [0, 1]
    with the larger axis first."""
    return {"a": rng.standard_normal((4, 8)).astype(dtype),
            "b": {"c": rng.standard_normal((100,)).astype(dtype)},
            "w": rng.standard_normal((2, 128, 160)).astype(dtype),
            "e": rng.standard_normal((300, 130)).astype(dtype)}


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _port_state(ref_state, port_opt, params, to_torch):
    """The reference's optimizer state as the port's."""
    factored, ema = ref_state[1]["inner"][0], ref_state[1]["inner"][2]
    state = port_opt.init(params)
    for name, tree in (("v_row", factored.v_row), ("v_col", factored.v_col),
                       ("v", factored.v), ("mu", ema.ema)):
        for path, t in port_ts.leaves(state[name]):
            t.copy_(to_torch(_at(tree, path)))
    state["count"] = int(factored.count)
    return state


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_factored_update_matches_optax(ref, grad_scale):
    """Three f32 updates, each from the reference's state after the one
    before, with the global norm below (no clip) and above the threshold:
    the parameters and the factored statistics within rtol 1e-6 (the row
    and column means sum in another order than XLA). The first moment is
    stored in bf16; where its f32 value sits on a bf16 rounding boundary
    the two may round it apart, by one bf16 ulp (the update itself uses
    the unrounded f32 value)."""
    jax, optax, _, ref_ts, _, _ = ref
    rng = np.random.default_rng(3)
    tree = _tree(rng, np.float32)
    grads = [jax.tree.map(lambda x: (grad_scale * rng.standard_normal(
        x.shape)).astype(np.float32), tree) for _ in range(STEPS)]
    assert (float(optax.global_norm(grads[0])) < 1.0) == (grad_scale < 1.0)
    opt = ref_ts.memory_efficient_optimizer(**KW)
    port_opt = port_ts.memory_efficient_optimizer(**KW)
    ref_params, ref_state = tree, opt.init(tree)
    for g in grads:
        params = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                              ref_params)
        state = _port_state(ref_state, port_opt, params,
                            lambda x: torch.from_numpy(
                                np.array(x, np.float32)))
        norm = port_opt.update(params, jax.tree.map(torch.from_numpy, g),
                               state)
        updates, ref_state = opt.update(g, ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)),
                                   rtol=1e-6)
        factored, ema = ref_state[1]["inner"][0], ref_state[1]["inner"][2]
        for path, p in port_ts.leaves(params):
            np.testing.assert_allclose(p.numpy(), _at(ref_params, path),
                                       rtol=1e-6, atol=1e-7)
            for name in ("v_row", "v_col", "v"):
                want = np.asarray(_at(getattr(factored, name), path))
                got = dict(port_ts.leaves(state[name]))[path].numpy()
                assert got.shape == want.shape, (name, path)
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           err_msg=name)
            want = np.asarray(_at(ema.ema, path), np.float32)
            got = dict(port_ts.leaves(state["mu"]))[path].float().numpy()
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want) + 1e-30)) - 7)
            assert np.all(np.abs(got - want) <= ulp), path
            assert np.mean(got != want) < 1e-3, path
        assert state["count"] == int(factored.count)


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])
def test_factored_bf16_matches_jitted_optax(ref, grad_scale):
    """Three updates on bf16 leaves against the reference's chain run as
    its trainer runs it, inside one jitted step, unclipped and clipped.
    Found tolerance: none. The parameters, the momentum and the factored
    statistics come out bit for bit: the update rounds to bf16 where that
    program rounds (each bf16 product, quotient, sum and power, the Python
    constants as bf16 literals, lr * weight_decay rounded to bf16 beside a
    bf16 parameter; the means summed in f32 and rounded once)."""
    jax, optax, _, ref_ts, _, _ = ref
    bf16 = jax.numpy.bfloat16
    rng = np.random.default_rng(11)
    tree = _tree(rng, bf16)
    grads = [jax.tree.map(lambda x: (grad_scale * rng.standard_normal(
        x.shape)).astype(bf16), tree) for _ in range(STEPS)]
    assert (float(optax.global_norm(grads[0])) < 1.0) == (grad_scale < 1.0)
    opt = ref_ts.memory_efficient_optimizer(**KW)

    @jax.jit
    def ref_step(p, g, s):
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s

    ref_params, ref_state = tree, opt.init(tree)
    for g in grads:
        ref_params, ref_state = ref_step(ref_params, g, ref_state)

    def to_torch(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16)

    port_opt = port_ts.memory_efficient_optimizer(**KW)
    params = jax.tree.map(to_torch, tree)
    state = port_opt.init(params)
    for g in grads:
        port_opt.update(params, jax.tree.map(to_torch, g), state)
    factored, ema = ref_state[1]["inner"][0], ref_state[1]["inner"][2]
    for path, p in port_ts.leaves(params):
        for got, want in [(p, _at(ref_params, path)),
                          (dict(port_ts.leaves(state["mu"]))[path],
                           _at(ema.ema, path))] + [
                (dict(port_ts.leaves(state[name]))[path],
                 _at(getattr(factored, name), path))
                for name in ("v_row", "v_col", "v")]:
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32),
                                          err_msg="/".join(path))


@pytest.mark.parametrize("shape", [
    (32, 4096, 14336),       # stacked [L, D, F]: (D, F), L kept
    (32, 14336, 4096),       # stacked [L, F, D]: (D, F) in argsort order
    (32, 4096),              # [L, D] norm, L < 128: not factored
    (128256, 4096),          # [V, D] embedding: largest axis first
    (32, 8, 4096, 14336),    # stacked experts [L, E, D, F]
    (200, 200), (4096,), (4, 8), (127, 300), (128, 5, 300),
])
def test_factored_dims_match_optax(ref, shape):
    jax = ref[0]
    from optax._src import factorized

    want = factorized._factored_dims(shape, True, 128)
    assert port_ts.factored_dims(shape) == want
    opt = port_ts.memory_efficient_optimizer()
    state = opt.init({"x": torch.empty(shape, device="meta")})
    ref_state = jax.eval_shape(
        ref[3].memory_efficient_optimizer().init,
        {"x": jax.ShapeDtypeStruct(shape, np.float32)})
    inner = ref_state[1]["inner"]
    for name in ("v_row", "v_col", "v"):
        assert tuple(state[name]["x"].shape) == \
            getattr(inner[0], name)["x"].shape, name
    assert state["mu"]["x"].dtype == torch.bfloat16
    assert inner[2].ema["x"].dtype == np.dtype("bfloat16")


def test_check_opt_state_across_optimizers():
    """A state built by one optimizer refused by the other, the optimizer
    it came from named; the factored state's shapes checked leaf by
    leaf."""
    cfg = port_llama.LlamaConfig.tiny()
    params = port_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    adamw, factored = (port_ts.default_optimizer(),
                       port_ts.memory_efficient_optimizer())
    state = {"params": params, "opt_state": adamw.init(params), "step": 0}
    port_ts.check_opt_state(adamw, state)
    with pytest.raises(ValueError, match="Adafactor.init.*AdamW's state"):
        port_ts.check_opt_state(factored, state)
    state["opt_state"] = factored.init(params)
    port_ts.check_opt_state(factored, state)
    with pytest.raises(ValueError, match="AdamW.init.*Adafactor's state"):
        port_ts.check_opt_state(adamw, state)
    state["opt_state"]["v_row"]["lm_head"] = torch.zeros(3)
    with pytest.raises(ValueError, match="opt_state\\['v_row'\\]/lm_head"):
        port_ts.check_opt_state(factored, state)


def test_factored_update_does_not_depend_on_its_split(monkeypatch):
    """A factored leaf is walked in row chunks of UPDATE_CHUNK elements
    (the column sums carried across them), an unfactored one in flat
    chunks: on bf16 leaves, whose means round to bf16 once, the weights and
    the state come out bit for bit however they are split."""
    rng = np.random.default_rng(5)
    tree = {"e": rng.standard_normal((300, 130)),
            "w": rng.standard_normal((2, 128, 160)),
            "n": rng.standard_normal((2, 300))}
    grads = {k: torch.from_numpy(1e-2 * rng.standard_normal(v.shape)).to(
        torch.bfloat16) for k, v in tree.items()}
    runs = []
    for chunk in (port_ts.UPDATE_CHUNK, 1000):
        monkeypatch.setattr(port_ts, "UPDATE_CHUNK", chunk)
        opt = port_ts.memory_efficient_optimizer(**KW)
        params = {k: torch.from_numpy(v).to(torch.bfloat16)
                  for k, v in tree.items()}
        state = opt.init(params)
        for _ in range(2):
            opt.update(params, grads, state)
        runs.append((params, state))
    (p0, s0), (p1, s1) = runs
    for k in tree:
        assert torch.equal(p0[k], p1[k]), k
        for name in ("v_row", "v_col", "v", "mu"):
            assert torch.equal(s0[name][k], s1[name][k]), (name, k)


def _copy(jax, tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


# loss and grad norm per step: f32 sums in another order through two
# layers, the head and two updates (as tests/test_torch_train.py)
STEP_REL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_matches_jax(ref, dtype):
    """Three steps of the tiny trainer on memory_efficient_optimizer
    (warmup 1, total 10) from the JAX trainer's initial weights on the
    same batch: loss and grad norm per step, and the weights after the
    last step. In bf16 the model's own products and sums round in both
    packages at other points, so the loss and norm are held to 2e-2, and a
    weight, which the factored update moves by about lr(t) |g| / rms(g) a
    step, to the sum of the learning rates of the steps (lr(0) = 0, then
    about 3e-4 each) or one bf16 ulp of it, whichever is larger; 98 % of
    each leaf's weights must come out bit for bit."""
    jax, _, ref_llama, ref_ts, MeshSpec, create_mesh = ref
    cfg = ref_llama.LlamaConfig.tiny(dtype=dtype)
    mesh = create_mesh(MeshSpec.dp(), devices=jax.devices()[:1])
    opt = ref_ts.memory_efficient_optimizer(warmup_steps=1, total_steps=10)
    state, step, _ = ref_ts.make_trainer(jax.random.PRNGKey(0), cfg, mesh,
                                         ref_llama, optimizer=opt)
    params0 = _copy(jax, state["params"])
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)
    batch = ref_ts.shard_batch({"tokens": tokens}, mesh)
    want = []
    with mesh:
        for _ in range(STEPS):
            state, m = step(state, batch)
            want.append((float(m["loss"]), float(m["grad_norm"])))
    ref_params = _copy(jax, state["params"])

    pcfg = port_llama.LlamaConfig.tiny(dtype=dtype)
    port_opt = port_ts.memory_efficient_optimizer(warmup_steps=1,
                                                  total_steps=10)
    pstate, pstep = port_ts.make_trainer(
        pcfg, port_llama, optimizer=port_opt,
        params=port_llama.from_jax_params(params0, pcfg, device="cpu"),
        device="cpu")
    for i in range(STEPS):
        pstate, m = pstep(pstate, {"tokens": tokens})
        np.testing.assert_allclose(
            [m["loss"].item(), m["grad_norm"].item()], want[i],
            rtol=STEP_REL[dtype], err_msg="step %d" % i)
    assert pstate["step"] == STEPS and pstate["opt_state"]["count"] == STEPS
    lr_total = sum(port_opt.schedule(c) for c in range(STEPS))
    for path, p in port_ts.leaves(pstate["params"]):
        want_p = np.asarray(_at(ref_params, path), np.float32)
        got = p.detach().float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want_p, atol=1e-5, rtol=1e-5,
                                       err_msg="/".join(path))
            continue
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want_p) + 1e-30)) - 7)
        assert np.all(np.abs(got - want_p) <= np.maximum(ulp, lr_total)), \
            "/".join(path)
        assert np.mean(got == want_p) >= 0.98, "/".join(path)
