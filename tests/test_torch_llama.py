"""The PyTorch port's Llama forward and loss against the JAX package's, on
the CPU: the tiny config in float32, the JAX parameters carried over with
from_jax_params, logits, losses and gradients compared on the same
tokens."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from metaflow_tpu.models import llama as ref_llama  # noqa: E402
from metaflow_tpu_torch.models import llama as port_llama  # noqa: E402
from metaflow_tpu_torch.training import train_step as port_ts  # noqa: E402

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

# float32 logits after two layers and the head: sums over 128..512 terms
# in another order
LOGIT_TOL = dict(atol=1e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def weights():
    cfg = ref_llama.LlamaConfig.tiny()
    params = jax.tree.map(np.asarray,
                          ref_llama.init_params(jax.random.PRNGKey(0), cfg))
    return cfg, params


@pytest.mark.parametrize("port_impl,ref_impl,S", [
    ("xla", "xla", 48),
    ("flash", "flash_interpret", 128),
])
def test_forward_logits_match(weights, port_impl, ref_impl, S):
    cfg, np_params = weights
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S))
    ref = ref_llama.forward(
        np_params, tokens, dataclasses.replace(cfg, attention_impl=ref_impl))
    pcfg = port_llama.LlamaConfig.tiny(attention_impl=port_impl)
    params = port_llama.from_jax_params(np_params, pcfg, device="cpu")
    port = port_llama.forward(params, tokens, pcfg, device="cpu")
    assert port.dtype == torch.float32 and port.shape == (2, S,
                                                          cfg.vocab_size)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **LOGIT_TOL)


def test_configs_match_reference():
    """Same presets, every field, the training ones included."""
    for name in ("tiny", "bench_1b", "llama3_1b", "llama3_8b"):
        ref = dataclasses.asdict(getattr(ref_llama.LlamaConfig, name)())
        port = dataclasses.asdict(getattr(port_llama.LlamaConfig, name)())
        assert port == ref, name
        assert getattr(port_llama.LlamaConfig, name)().head_dim == \
            getattr(ref_llama.LlamaConfig, name)().head_dim


def _batch(case):
    """(loss_chunk, batch) for a loss case; S=96 with chunk 40 snaps to 32,
    S=50 with chunk 40 snaps below 32 and runs unchunked."""
    rng = np.random.default_rng(2)
    chunk, S = {"unchunked": (0, 64), "chunked": (32, 64),
                "snapped_masked": (40, 96),
                "floor_inputs_targets": (40, 50)}[case]
    tokens = rng.integers(0, 512, (2, S + 1)).astype(np.int32)
    if case == "floor_inputs_targets":
        batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    else:
        batch = {"tokens": tokens}
    if case in ("snapped_masked", "floor_inputs_targets"):
        batch["mask"] = (rng.random((2, S)) > 0.3).astype(np.float32)
    return chunk, batch


def _port_loss(np_params, chunk, batch, **cfg_kw):
    cfg = port_llama.LlamaConfig.tiny(loss_chunk=chunk, **cfg_kw)
    params = port_llama.from_jax_params(np_params, cfg, device="cpu")
    for w in [params["embed"], params["final_norm"], params["lm_head"],
              *params["layers"].values()]:
        w.requires_grad_(True)
    loss = port_llama.loss_fn(params, batch, cfg, device="cpu")
    loss.backward()
    return loss, params


@pytest.mark.parametrize("case", ["unchunked", "chunked", "snapped_masked",
                                  "floor_inputs_targets"])
def test_loss_matches_reference(weights, case):
    """The loss within 1e-5 relative; for the cases that reach the divisor
    snap, the mask and both batch forms, every gradient against jax.grad
    within the JAX package's grad tolerance."""
    cfg, np_params = weights
    chunk, batch = _batch(case)
    rcfg = dataclasses.replace(cfg, loss_chunk=chunk)
    loss, params = _port_loss(np_params, chunk, batch)
    if case in ("unchunked", "chunked"):
        ref = jax.jit(lambda p, b: ref_llama.loss_fn(p, b, rcfg))(
            np_params, batch)
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
        return
    ref, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_llama.loss_fn(p, b, rcfg)))(np_params, batch)
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for name in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(params[name].grad.numpy(),
                                   np.asarray(grads[name]), atol=1e-5,
                                   rtol=1e-3, err_msg=name)
    for name, w in params["layers"].items():
        np.testing.assert_allclose(w.grad.numpy(),
                                   np.asarray(grads["layers"][name]),
                                   atol=1e-5, rtol=1e-3, err_msg=name)


def test_remat_changes_memory_not_values(weights):
    """remat=False gives the same loss and grads as the default remat=True;
    the JAX package's named remat policies "dots" and "attn_out" give remat
    None's loss and grads bit for bit (they only keep more of the forward),
    and "dots" matches the JAX loss_fn's grads under that policy."""
    cfg, np_params = weights
    chunk, batch = _batch("chunked")
    loss, params = _port_loss(np_params, chunk, batch)
    loss_nr, params_nr = _port_loss(np_params, chunk, batch, remat=False)
    assert loss.item() == loss_nr.item()
    for name, w in params["layers"].items():
        torch.testing.assert_close(w.grad, params_nr["layers"][name].grad,
                                   atol=1e-7, rtol=1e-6)
    runs = {}
    for policy in ("dots", "attn_out"):
        runs[policy] = _port_loss(np_params, chunk, batch,
                                  remat_policy=policy)
        assert runs[policy][0].item() == loss.item(), policy
        got = dict(port_ts.leaves(runs[policy][1]))
        for path, w in port_ts.leaves(params):
            assert torch.equal(got[path].grad, w.grad), (policy, path)
    rcfg = dataclasses.replace(cfg, loss_chunk=chunk, remat_policy="dots")
    ref, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_llama.loss_fn(p, b, rcfg)))(np_params, batch)
    loss_p, params_p = runs["dots"]
    np.testing.assert_allclose(loss_p.item(), float(ref), rtol=1e-5)
    for name, w in params_p["layers"].items():
        np.testing.assert_allclose(w.grad.numpy(),
                                   np.asarray(grads["layers"][name]),
                                   atol=1e-5, rtol=1e-3, err_msg=name)


def test_init_params_shapes_match_reference():
    cfg = port_llama.LlamaConfig.tiny()
    ref = jax.eval_shape(lambda k: ref_llama.init_params(k, cfg),
                         jax.ShapeDtypeStruct((2,), np.uint32))
    gen = torch.Generator().manual_seed(0)
    port = port_llama.init_params(cfg, gen, device="cpu")
    ref_shapes = {k: v.shape for k, v in ref["layers"].items()}
    assert {k: tuple(v.shape) for k, v in port["layers"].items()} == \
        ref_shapes
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(port[name].shape) == ref[name].shape
    again = port_llama.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["layers"]["wq"], port["layers"]["wq"])
