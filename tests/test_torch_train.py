"""The PyTorch port's trainer against the JAX package's, on the CPU: the
tiny config in float32, the JAX trainer's initial weights carried over with
from_jax_params, the same batch and default_optimizer(warmup_steps=1,
total_steps=10); then the optimizer's pieces (schedule, clipping, moment
dtypes, the opt-state guard) against optax."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import optax  # noqa: E402
import torch  # noqa: E402

from metaflow_tpu.models import llama as ref_llama  # noqa: E402
from metaflow_tpu.spmd import MeshSpec, create_mesh  # noqa: E402
from metaflow_tpu.training import train_step as ref_ts  # noqa: E402
from metaflow_tpu_torch.models import llama as port_llama  # noqa: E402
from metaflow_tpu_torch.training import train_step as port_ts  # noqa: E402

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

STEPS = 3
# loss and grad norm per step: f32 sums over the same terms in another
# order, through two layers, the head and two AdamW updates
STEP_REL = 1e-4


def _copy(tree):
    return jax.tree.map(lambda x: np.array(x, copy=True), tree)


@pytest.fixture(scope="module")
def jax_run():
    """Three steps of the JAX make_trainer on a one-device CPU mesh."""
    cfg = ref_llama.LlamaConfig.tiny()
    mesh = create_mesh(MeshSpec.dp(), devices=jax.devices()[:1])
    opt = ref_ts.default_optimizer(warmup_steps=1, total_steps=10)
    state, step, _ = ref_ts.make_trainer(jax.random.PRNGKey(0), cfg, mesh,
                                         ref_llama, optimizer=opt)
    params0 = _copy(state["params"])  # the step donates its state
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 65)).astype(np.int32)
    batch = ref_ts.shard_batch({"tokens": tokens}, mesh)
    metrics = []
    with mesh:
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params0, tokens, metrics, _copy(state["params"])


def _port_trainer(np_params, impl="xla", dtype="float32", **opt_kw):
    cfg = port_llama.LlamaConfig.tiny(attention_impl=impl, dtype=dtype)
    params = port_llama.from_jax_params(np_params, cfg, device="cpu")
    opt = port_ts.default_optimizer(warmup_steps=1, total_steps=10, **opt_kw)
    state, step = port_ts.make_trainer(cfg, port_llama, optimizer=opt,
                                       params=params, device="cpu")
    return cfg, state, step


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_trainer_matches_jax(jax_run, impl):
    """Loss and grad norm per step within 1e-4 relative, and the weights
    after the last step, through plain attention and through the flash
    path's autograd Function (its plain route on the CPU)."""
    params0, tokens, want, ref_params = jax_run
    _, state, step = _port_trainer(params0, impl)
    for i in range(STEPS):
        state, m = step(state, {"tokens": tokens})
        np.testing.assert_allclose(
            [m["loss"].item(), m["grad_norm"].item()], want[i],
            rtol=STEP_REL, err_msg="step %d" % i)
    assert state["step"] == STEPS
    for path, p in port_ts.leaves(state["params"]):
        ref = ref_params
        for key in path:
            ref = ref[key]
        # each update moves a weight by about lr (3e-4) times Adam's
        # normalised step g / |g|, which a gradient near zero makes
        # sensitive to the grads' f32 differences: up to 1/30 of a step
        # here. The update's arithmetic itself is held to 1e-6 by
        # test_adamw_step_matches_optax.
        np.testing.assert_allclose(p.detach().numpy(), ref, atol=1e-5,
                                   rtol=1e-5, err_msg="/".join(path))


def test_first_step_leaves_params_unchanged(jax_run):
    """The schedule gives lr 0 on the first update: the weights stay
    bit-identical and the second step sees the first step's loss."""
    params0, tokens, want, _ = jax_run
    _, state, step = _port_trainer(params0)
    before = {path: p.detach().clone()
              for path, p in port_ts.leaves(state["params"])}
    state, m0 = step(state, {"tokens": tokens})
    for path, p in port_ts.leaves(state["params"]):
        assert torch.equal(p, before[path]), path
    _, m1 = step(state, {"tokens": tokens})
    assert m0["loss"].item() == m1["loss"].item()
    assert want[0][0] == want[1][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_opt_state_dtypes_match_optax(dtype):
    """mu in f32 and nu in the parameter's dtype, leaf for leaf as optax's
    scale_by_adam builds them (checked on the JAX tree with eval_shape)."""
    cfg = port_llama.LlamaConfig.tiny(dtype=dtype)
    params = port_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    opt_state = port_ts.default_optimizer().init(params)
    ref_cfg = ref_llama.LlamaConfig.tiny(dtype=dtype)
    ref_params = jax.eval_shape(lambda k: ref_llama.init_params(k, ref_cfg),
                                jax.ShapeDtypeStruct((2,), np.uint32))
    adam = jax.eval_shape(ref_ts.default_optimizer().init, ref_params)[1][0]
    for name, ref_tree in (("mu", adam.mu), ("nu", adam.nu)):
        for path, t in port_ts.leaves(opt_state[name]):
            ref = ref_tree
            for key in path:
                ref = ref[key]
            assert str(t.dtype).split(".")[-1] == str(ref.dtype), (name, path)
            assert tuple(t.shape) == ref.shape
    assert opt_state["mu"]["embed"].dtype == torch.float32
    assert opt_state["nu"]["embed"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("lr,warmup,total", [(3e-4, 1, 10), (1e-3, 4, 12),
                                             (2e-4, 0, 5), (5e-4, 10, 3)])
def test_schedule_matches_optax(lr, warmup, total):
    port = port_ts._lr_schedule(lr, warmup, total)
    ref = ref_ts._lr_schedule(lr, warmup, total)
    got = [port(c) for c in range(13)]
    want = [float(ref(c)) for c in range(13)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert got[0] == 0.0 or warmup == 0


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adamw_step_matches_optax(grad_scale):
    """One update of the port's AdamW against optax's chain on the same
    weights and grads, with the global norm below (no clip) and above the
    threshold: the updated weights and moments within f32 rounding."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal((16,)).astype(np.float32)}}
    grads = jax.tree.map(
        lambda x: grad_scale * rng.standard_normal(x.shape).astype(
            np.float32), tree)
    norm = float(optax.global_norm(grads))
    assert (norm < 1.0) == (grad_scale < 1.0)
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    opt = ref_ts.default_optimizer(**kw)
    ref_state = opt.init(tree)
    ref_params = tree
    for _ in range(2):
        updates, ref_state = opt.update(grads, ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)

    port_opt = port_ts.default_optimizer(**kw)
    params = jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree)
    tgrads = jax.tree.map(torch.from_numpy, grads)
    state = port_opt.init(params)
    for _ in range(2):
        got_norm = port_opt.update(params, tgrads, state)
    np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
    adam = ref_state[1][0]
    for path, p in port_ts.leaves(params):
        want = ref_params
        mu, nu = adam.mu, adam.nu
        for key in path:
            want, mu, nu = want[key], mu[key], nu[key]
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-6, atol=1e-7)
        got_mu = dict(port_ts.leaves(state["mu"]))[path]
        got_nu = dict(port_ts.leaves(state["nu"]))[path]
        np.testing.assert_allclose(got_mu.numpy(), mu, rtol=1e-6)
        np.testing.assert_allclose(got_nu.numpy(), nu, rtol=1e-6)


def test_check_opt_state_names_the_mismatch(jax_run):
    params0 = jax_run[0]
    cfg, state, _ = _port_trainer(params0, mu_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="opt_state\\['mu'\\]/embed"):
        port_ts.check_opt_state(port_ts.default_optimizer(), state)
    port_ts.check_opt_state(port_ts.default_optimizer(
        mu_dtype=torch.bfloat16), state)
    state["opt_state"]["nu"].pop("lm_head")
    with pytest.raises(ValueError, match="nu"):
        port_ts.check_opt_state(port_ts.default_optimizer(
            mu_dtype=torch.bfloat16), state)


def test_eval_step_matches_jax(jax_run):
    params0, tokens, want, _ = jax_run
    cfg, state, _ = _port_trainer(params0)
    ev = port_ts.make_eval_step(cfg, port_llama, device="cpu")
    loss = ev(state["params"], {"tokens": tokens})
    assert not loss.requires_grad
    np.testing.assert_allclose(loss.item(), want[0][0], rtol=1e-5)
