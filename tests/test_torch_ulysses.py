"""The port's Ulysses (all-to-all) sequence parallelism against the JAX
package's, on the CPU: `ulysses_attention` on `LocalRing(2/4)` against
the JAX one on a `sequence` mesh of the virtual CPU devices (causal and
not, GQA widening, the inner flash path through the kernels' plain
versions against interpret mode), the refusals, the torch.distributed
transport in four `gloo` processes, and the tiny Llama with
attention_impl="ulysses": loss, gradients and a trainer step.

The JAX package is imported inside the `ref` fixture, so the spawned gloo
workers, which import this module, stay free of jax."""

import dataclasses
import importlib
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.training import train_step as port_ts

port_ring = importlib.import_module("metaflow_tpu_torch.ops.ring_attention")
port_uly = importlib.import_module("metaflow_tpu_torch.ops.ulysses_attention")
port_attn = importlib.import_module("metaflow_tpu_torch.ops.attention")

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

# the JAX package's tolerance for Ulysses against reference attention
# (tests/test_ops.py TestUlyssesAttention), here for outputs and
# gradients alike: both packages compute the same sums
TOL = dict(atol=2e-5, rtol=2e-5)

# (B, S, H, KV, D, causal, impl) of the attention cases; 'gqa' widens its
# two kv heads to four on a ring of four
CASES = {
    "causal": (2, 64, 8, 8, 16, True, "xla"),
    "non_causal": (2, 64, 8, 8, 16, False, "xla"),
    "gqa": (1, 32, 8, 2, 16, True, "xla"),
    "flash": (1, 128, 4, 2, 64, True, "flash"),
}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from metaflow_tpu.models import llama
    from metaflow_tpu.spmd import MeshSpec, create_mesh

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, llama=llama,
        uly=importlib.import_module("metaflow_tpu.ops.ulysses_attention"),
        mesh=lambda n: create_mesh(MeshSpec({"sequence": n}), n_devices=n))


def _inputs(B, S, H, KV, D, seed=0):
    """q, k, v and an output gradient g, float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                          (B, S, H, D))]


def _port_grads(fn, q, k, v, g):
    """fn's output and the gradients of <fn(q, k, v), g> (numpy)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _jax_grads(ref, fn, q, k, v, g):
    """The same from the JAX package, jitted."""
    def run(q, k, v, g):
        out, vjp = ref.jax.vjp(fn, q, k, v)
        return (out,) + vjp(g)

    return [np.asarray(t) for t in ref.jax.jit(run)(q, k, v, g)]


def _jax_impl(impl):
    return "flash_interpret" if impl == "flash" else impl


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_local_ring_matches_jax(ref, case, n):
    """Output and gradients of ulysses_attention on LocalRing(n) against
    the JAX one on a {"sequence": n} mesh; 'flash' runs the port's inner
    flash path through the kernels' plain versions against the JAX kernels
    in interpret mode."""
    B, S, H, KV, D, causal, impl = CASES[case]
    q, k, v, g = _inputs(B, S, H, KV, D)
    got = _port_grads(lambda a, b, c: port_uly.ulysses_attention(
        a, b, c, port_ring.LocalRing(n), causal=causal, impl=impl),
        q, k, v, g)
    mesh = ref.mesh(n)
    want = _jax_grads(ref, lambda a, b, c: ref.uly.ulysses_attention(
        a, b, c, mesh, causal=causal, impl=_jax_impl(impl)), q, k, v, g)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, **TOL, err_msg=name)


@pytest.mark.parametrize("kv,n,want", [(2, 4, 4), (2, 2, 2), (8, 4, 8),
                                       (1, 4, 4), (3, 2, 6)])
def test_widen_kv_minimal_matches_jax(ref, kv, n, want):
    """The smallest widening of the kv heads, as the JAX package's, for
    8 query heads (3 kv heads of 6 query heads in the last case)."""
    H = 6 if kv == 3 else 8
    x = np.random.default_rng(1).standard_normal((1, 4, kv, 2)).astype(
        np.float32)
    got = port_uly._widen_kv_minimal(torch.from_numpy(x), H, n)
    assert got.shape[2] == want
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.uly._widen_kv_minimal(x, H, n)))


def test_refusals(ref):
    """Indivisible heads raise, naming ring_attention, as the JAX one
    does; a mesh that is no sequence ring and a sequence that does not
    split raise too; a ring of one is plain attention."""
    q = torch.zeros(1, 32, 6, 8)
    with pytest.raises(ValueError, match="ring_attention"):
        port_uly.ulysses_attention(q, q, q, port_ring.LocalRing(4))
    mesh = ref.mesh(4)
    jq = ref.jnp.zeros((1, 32, 6, 8))
    with pytest.raises(Exception, match="ring_attention"):
        np.asarray(ref.uly.ulysses_attention(jq, jq, jq, mesh, impl="xla"))
    with pytest.raises(ValueError, match="LocalRing or"):
        port_uly.ulysses_attention(q, q, q, None)
    q = torch.zeros(1, 30, 8, 8)
    with pytest.raises(ValueError, match="does not split"):
        port_uly.ulysses_attention(q, q, q, port_ring.LocalRing(4))
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 32, 4, 2, 8))
    torch.testing.assert_close(
        port_uly.ulysses_attention(q, k, v, port_ring.LocalRing(1)),
        port_attn.attention(q, k, v, causal=True), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the all-to-alls across processes
# ---------------------------------------------------------------------------

GLOO_WORLD = 4
GLOO_TIMEOUT_S = 120.0
GLOO_RUNS = ("causal", "gqa", "non_causal")


def _gloo_worker(rank, init_file, out_dir):
    """One rank of the process-group transport: its sequence shard of
    every GLOO_RUNS case, forward and backward, saved as
    <out_dir>/<case>_<rank>.npz."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=GLOO_WORLD)
    try:
        ring = port_ring.ProcessGroupRing()
        for case in GLOO_RUNS:
            B, S, H, KV, D, causal, impl = CASES[case]
            q, k, v, g = _inputs(B, S, H, KV, D)
            part = slice(rank * S // GLOO_WORLD, (rank + 1) * S // GLOO_WORLD)
            out, dq, dk, dv = _port_grads(
                lambda a, b, c: port_uly.ulysses_attention(
                    a, b, c, ring, causal=causal, impl=impl),
                *(np.ascontiguousarray(a[:, part]) for a in (q, k, v, g)))
            np.savez("%s/%s_%d.npz" % (out_dir, case, rank), out=out, dq=dq,
                     dk=dk, dv=dv)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Every GLOO_RUNS case from four spawned gloo processes, the ranks'
    shards joined along the sequence."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo")
    ctx = mp.spawn(_gloo_worker, args=(str(tmp / "init"), str(tmp)),
                   nprocs=GLOO_WORLD, join=False)
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError("the gloo workers did not finish in %.0f s"
                                 % GLOO_TIMEOUT_S)
    results = {}
    for case in GLOO_RUNS:
        parts = [np.load(tmp / ("%s_%d.npz" % (case, r)))
                 for r in range(GLOO_WORLD)]
        results[case] = [np.concatenate([p[key] for p in parts], axis=1)
                         for key in ("out", "dq", "dk", "dv")]
    return results


@pytest.mark.parametrize("case", GLOO_RUNS)
def test_process_group_matches_local_ring_and_jax(ref, gloo_results, case):
    """The four ranks' output and gradient shards, joined, equal
    LocalRing(4)'s (each head group's attention is the same computation)
    and match the JAX Ulysses on four devices."""
    B, S, H, KV, D, causal, impl = CASES[case]
    q, k, v, g = _inputs(B, S, H, KV, D)
    local = _port_grads(lambda a, b, c: port_uly.ulysses_attention(
        a, b, c, port_ring.LocalRing(GLOO_WORLD), causal=causal, impl=impl),
        q, k, v, g)
    mesh = ref.mesh(GLOO_WORLD)
    want = _jax_grads(ref, lambda a, b, c: ref.uly.ulysses_attention(
        a, b, c, mesh, causal=causal, impl=impl), q, k, v, g)
    for name, got, same, jx in zip(("out", "dq", "dk", "dv"),
                                   gloo_results[case], local, want):
        np.testing.assert_allclose(got, same, atol=1e-6, rtol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(got, jx, **TOL, err_msg=name)


# ---------------------------------------------------------------------------
# the model and the trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(ref):
    cfg = ref.llama.LlamaConfig.tiny(attention_impl="ulysses")
    params = ref.jax.tree.map(
        np.asarray, ref.llama.init_params(ref.jax.random.PRNGKey(0), cfg))
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)
    return cfg, params, tokens


def test_llama_ulysses_loss_and_grads_match_jax(ref, tiny):
    """The tiny Llama's loss and every gradient with
    attention_impl="ulysses" on LocalRing(4) against the JAX loss_fn on a
    {"sequence": 4} mesh (the einsum inner attention in both packages off
    the TPU and the card)."""
    cfg, np_params, tokens = tiny
    mesh = ref.mesh(4)
    loss, grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p: ref.llama.loss_fn(p, {"tokens": tokens}, cfg, mesh=mesh)))(
            np_params)
    pcfg = port_llama.LlamaConfig.tiny(attention_impl="ulysses")
    params = port_llama.from_jax_params(np_params, pcfg, device="cpu")
    for _, p in port_ts.leaves(params):
        p.requires_grad_(True)
    port_loss = port_llama.loss_fn(params, {"tokens": tokens}, pcfg,
                                   device="cpu",
                                   mesh=port_ring.LocalRing(4))
    port_loss.backward()
    np.testing.assert_allclose(port_loss.item(), float(loss), rtol=1e-5)
    want = dict(port_ts.leaves(ref.jax.tree.map(np.asarray, grads)))
    for path, p in port_ts.leaves(params):
        np.testing.assert_allclose(p.grad.numpy(), want[path], atol=1e-5,
                                   rtol=1e-3, err_msg="/".join(path))


def test_trainer_step_through_ulysses(tiny):
    """One trainer step with mesh=LocalRing(4) and
    attention_impl="ulysses" against one with plain attention and no
    mesh: the loss, the grad norm and the first moment (the first update
    has learning rate 0, so the weights stay as they were); make_eval_step
    takes the mesh too."""
    _, np_params, tokens = tiny
    batch = {"tokens": tokens}
    runs = {}
    for impl, mesh in (("ulysses", port_ring.LocalRing(4)), ("xla", None)):
        cfg = port_llama.LlamaConfig.tiny(attention_impl=impl)
        params = port_llama.from_jax_params(np_params, cfg, device="cpu")
        opt = port_ts.default_optimizer(warmup_steps=1, total_steps=10)
        state, step = port_ts.make_trainer(cfg, port_llama, optimizer=opt,
                                           params=params, device="cpu",
                                           mesh=mesh)
        state, metrics = step(state, batch)
        evaluate = port_ts.make_eval_step(cfg, port_llama, device="cpu",
                                          mesh=mesh)
        runs[impl] = (metrics, state, evaluate(state["params"], batch))
    (m_u, s_u, e_u), (m_plain, s_plain, _) = runs["ulysses"], runs["xla"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(m_u[key].item(), m_plain[key].item(),
                                   rtol=1e-5)
    np.testing.assert_allclose(e_u.item(), m_u["loss"].item(), rtol=1e-6)
    for (path, a), (_, b) in zip(port_ts.leaves(s_u["opt_state"]["mu"]),
                                 port_ts.leaves(s_plain["opt_state"]["mu"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-3, err_msg="/".join(path))
    for (path, a), (_, b) in zip(port_ts.leaves(s_u["params"]),
                                 port_ts.leaves(s_plain["params"])):
        assert torch.equal(a, b), path


def test_llama_ulysses_needs_a_local_ring(tiny):
    """Without a sequence mesh Ulysses raises the JAX ValueError; a
    process-group ring raises NotImplementedError naming ROADMAP's
    slice 5, as the ring does."""
    _, np_params, tokens = tiny
    pcfg = port_llama.LlamaConfig.tiny(attention_impl="ulysses")
    params = port_llama.from_jax_params(np_params, pcfg, device="cpu")
    with pytest.raises(ValueError, match="'sequence' axis"):
        port_llama.forward(params, tokens, pcfg, device="cpu")
    pg_ring = port_ring.ProcessGroupRing.__new__(port_ring.ProcessGroupRing)
    pg_ring.rank, pg_ring.size = 0, 4
    with pytest.raises(NotImplementedError, match="ROADMAP.md, slice 5"):
        port_llama.forward(params, tokens, dataclasses.replace(pcfg),
                           device="cpu", mesh=pg_ring)
