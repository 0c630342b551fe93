"""The port's ring attention against the JAX package's, on the CPU: K4's
plain version (`flash_block_fwd`) against the JAX kernel in interpret mode,
`ring_attention` on `LocalRing(2/4)` against the JAX ring on a `sequence`
mesh of the virtual CPU devices (flash through the kernels' plain versions
and interpret mode, and the einsum block), the refusals, the
torch.distributed transport in four `gloo` processes, and the tiny Llama
with attention_impl="ring": loss, gradients and a trainer step.

The JAX package is imported inside the `ref` fixture, so the spawned gloo
workers, which import this module, stay free of jax."""

import dataclasses
import functools
import importlib
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metaflow_tpu_torch.models import llama as port_llama
port_ring = importlib.import_module("metaflow_tpu_torch.ops.ring_attention")
from metaflow_tpu_torch.training import train_step as port_ts

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

port_attn = importlib.import_module("metaflow_tpu_torch.ops.attention")

# the JAX package's own tolerances (tests/test_ops.py): ring and flash
# outputs against reference attention, and their gradients
FWD_TOL = dict(atol=2e-5, rtol=2e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
# the same computation in both packages, f32 sums in another order
STAT_TOL = dict(atol=1e-5, rtol=1e-5)

# (B, S, H, KV, D, causal) of the ring cases; every shard is 32 or 64
# positions, aligned for the flash blocks
RING_CASES = {
    "causal": (1, 128, 2, 2, 64, True),
    "non_causal": (1, 128, 2, 2, 64, False),
    "gqa": (2, 128, 4, 2, 64, True),
}


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from metaflow_tpu.models import llama
    from metaflow_tpu.spmd import MeshSpec, create_mesh

    return types.SimpleNamespace(
        jax=jax, jnp=jax.numpy, llama=llama,
        ring=importlib.import_module("metaflow_tpu.ops.ring_attention"),
        attn=importlib.import_module("metaflow_tpu.ops.attention"),
        mesh=lambda n: create_mesh(MeshSpec({"sequence": n}), n_devices=n))


def _inputs(B, S, H, KV, D, seed=0):
    """q, k, v and an output gradient g, float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                          (B, S, H, D))]


def _fold(ref, x, H):
    return ref.attn._fold_heads(ref.attn._broadcast_gqa(x, H))


def _port_grads(fn, q, k, v, g):
    """fn's output and the gradients of <fn(q, k, v), g> (numpy)."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return [out.detach().numpy()] + [t.grad.numpy() for t in ts]


def _jax_grads(ref, fn, q, k, v, g):
    """The same from the JAX package, jitted (eager shard_map dispatches
    op by op and takes ten times as long)."""
    def run(q, k, v, g):
        out, vjp = ref.jax.vjp(fn, q, k, v)
        return (out,) + vjp(g)

    return [np.asarray(t) for t in ref.jax.jit(run)(q, k, v, g)]


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("diag", [True, False])
def test_flash_block_fwd_matches_interpreted_kernel(ref, dtype, diag):
    """acc, m and l against the JAX kernel in interpret mode on the same
    (bf16-rounded) inputs, GQA, one 128-key block so both round the
    probabilities at the same max. bf16's acc is held as K1's O is, row by
    row, after dividing by l."""
    B, S, H, KV, D = 2, 128, 4, 2, 64
    q, k, v, _ = _inputs(B, S, H, KV, D, seed=3)
    dt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(dt) for a in (q, k, v))
    scale = D ** -0.5
    acc, m, l = port_attn.flash_block_fwd(tq, tk, tv, scale, diag)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    assert acc.shape == (B, S, H, D) and m.shape == l.shape == (B * H, S)
    assert m.is_contiguous() and l.is_contiguous()
    jq, jk, jv = (ref.jnp.asarray(t.float().numpy()).astype(dtype)
                  for t in (tq, tk, tv))
    r_acc, r_m, r_l = ref.attn.flash_block_fwd(
        _fold(ref, jq, H), _fold(ref, jk, H), _fold(ref, jv, H), scale, diag,
        interpret=True)
    got_acc = acc.transpose(1, 2).reshape(B * H, S, D).numpy()
    np.testing.assert_allclose(m.numpy(), np.asarray(r_m), **STAT_TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(r_l), **STAT_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(got_acc, np.asarray(r_acc), **FWD_TOL)
    else:
        want_acc = torch.from_numpy(np.array(r_acc)).reshape(
            B, H, S, D).transpose(1, 2)
        err = port_attn.flash_out_error(
            port_attn.flash_block_output(acc, l),
            port_attn.flash_block_output(
                want_acc, torch.from_numpy(np.array(r_l))))
        assert err <= port_attn.FLASH_BLOCK_ROW_LIMIT, err


def test_flash_block_fwd_reads_shard_views():
    """A shard taken as a view of the whole sequence (strided along the
    batch) gives what its contiguous copy gives, and m is in natural-log
    units: lse = m + log l is the full-attention lse of a diagonal hop."""
    q, k, v, _ = _inputs(2, 256, 4, 2, 64, seed=4)
    tq, tk, tv = (torch.from_numpy(a)[:, 128:] for a in (q, k, v))
    assert not tq.is_contiguous()
    got = port_attn.flash_block_fwd(tq, tk, tv, 0.125, True)
    want = port_attn.flash_block_fwd(tq.contiguous(), tk.contiguous(),
                                     tv.contiguous(), 0.125, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    _, lse = port_attn._flash_forward_plain(tq, tk, tv, True, 0.125)
    torch.testing.assert_close(got[1] + torch.log(got[2]), lse, atol=1e-5,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the ring on one process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(RING_CASES))
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("port_impl,ref_impl", [
    ("flash", "flash_interpret"), ("xla", "xla")])
def test_ring_matches_jax_ring(ref, case, n, port_impl, ref_impl):
    """Output and gradients of LocalRing(n) against the JAX ring on a
    {"sequence": n} mesh and the same inputs, within the JAX package's
    ring tolerances."""
    B, S, H, KV, D, causal = RING_CASES[case]
    q, k, v, g = _inputs(B, S, H, KV, D)
    mesh = ref.mesh(n)
    want = _jax_grads(ref, lambda a, b, c: ref.ring.ring_attention(
        a, b, c, mesh, causal=causal, impl=ref_impl), q, k, v, g)
    got = _port_grads(lambda a, b, c: port_ring.ring_attention(
        a, b, c, port_ring.LocalRing(n), causal=causal, impl=port_impl),
        q, k, v, g)
    np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_ring_matches_plain_attention(impl):
    """Every impl against plain attention, a ring of one shard included;
    the flash backward runs its kernels' plain versions on CPU tensors."""
    q, k, v, g = _inputs(2, 96, 4, 1, 64, seed=5)
    want = _port_grads(lambda a, b, c: port_attn.reference_attention(
        a, b, c, causal=True), q, k, v, g)
    for n in (1, 3):
        got = _port_grads(lambda a, b, c: port_ring.ring_attention(
            a, b, c, port_ring.LocalRing(n), impl=impl), q, k, v, g)
        np.testing.assert_allclose(got[0], want[0], **FWD_TOL)
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, **GRAD_TOL)


def test_auto_takes_the_kernels_on_the_card():
    """impl='auto' takes the einsum block on CPU tensors, aligned or not,
    and the flash ring on CUDA ones, where an unaligned shard raises
    rather than falling back; an explicit 'xla' stays the einsum ring. A
    flash ring launches nothing on the CPU (the plain versions run)."""
    launches = importlib.import_module("metaflow_tpu_torch.ops.launches")
    assert port_ring._resolve_impl("auto", 128, False) == "xla"
    assert port_ring._resolve_impl("auto", 130, False) == "xla"
    assert port_ring._resolve_impl("auto", 128, True) == "flash"
    assert port_ring._resolve_impl("xla", 130, True) == "xla"
    with pytest.raises(ValueError, match="per-device sequence shard"):
        port_ring._resolve_impl("auto", 130, True)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 2, 64))
    launches.reset_launch_counts()
    out = port_ring.ring_attention(q, k, v, port_ring.LocalRing(2),
                                   impl="flash")
    assert out.shape == q.shape and not any(launches.LAUNCHES.values())


def test_refusals_match_reference(ref):
    """An explicit flash ring on an unaligned shard raises as the JAX one
    does; so do flash_block_fwd on an unaligned length, a sequence that
    does not split into the ring's shards, kv heads that do not divide the
    q heads, an unknown impl and a mesh that is not a ring."""
    q = torch.zeros(1, 260, 2, 64)
    with pytest.raises(ValueError) as port_err:
        port_ring.ring_attention(q, q, q, port_ring.LocalRing(2),
                                 impl="flash")
    with pytest.raises(ValueError) as ref_err:
        ref.ring.ring_attention(np.zeros((1, 260, 2, 64), np.float32),
                                *(np.zeros((1, 260, 2, 64), np.float32),) * 2,
                                ref.mesh(2), impl="flash_interpret")
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="divisible by the"):
        port_attn.flash_block_fwd(q[:, :130], q[:, :130], q[:, :130], 0.1,
                                  True)
    with pytest.raises(ValueError, match="does not split"):
        port_ring.ring_attention(q, q, q, port_ring.LocalRing(3))
    with pytest.raises(ValueError, match="bad shapes"):
        port_ring.ring_attention(torch.zeros(1, 64, 3, 64),
                                 *(torch.zeros(1, 64, 2, 64),) * 2,
                                 port_ring.LocalRing(2))
    with pytest.raises(ValueError, match="must divide"):
        port_attn.flash_block_fwd(torch.zeros(1, 64, 3, 64),
                                  *(torch.zeros(1, 64, 2, 64),) * 2, 0.1,
                                  True)
    with pytest.raises(ValueError, match="impl must be"):
        port_ring.ring_attention(q, q, q, port_ring.LocalRing(2),
                                 impl="manual")
    with pytest.raises(ValueError, match="LocalRing"):
        port_ring.ring_attention(q, q, q, None)
    with pytest.raises(ValueError, match="at least one"):
        port_ring.LocalRing(0)


# ---------------------------------------------------------------------------
# the ring across processes
# ---------------------------------------------------------------------------

GLOO_WORLD = 4
# (name, ring case, impl) run by the gloo workers
GLOO_RUNS = [("causal_flash", "causal", "flash"),
             ("gqa_flash", "gqa", "flash"),
             ("non_causal_xla", "non_causal", "xla")]


def _gloo_worker(rank, init_file, out_dir):
    """One rank of the process-group ring: its shard of every GLOO_RUNS
    case, forward and backward, saved as <out_dir>/<run>_<rank>.npz."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            rank=rank, world_size=GLOO_WORLD)
    try:
        ring = port_ring.ProcessGroupRing()
        for name, case, impl in GLOO_RUNS:
            B, S, H, KV, D, causal = RING_CASES[case]
            q, k, v, g = _inputs(B, S, H, KV, D)
            part = slice(rank * S // GLOO_WORLD, (rank + 1) * S // GLOO_WORLD)
            out, dq, dk, dv = _port_grads(
                lambda a, b, c: port_ring.ring_attention(
                    a, b, c, ring, causal=causal, impl=impl),
                *(np.ascontiguousarray(a[:, part]) for a in (q, k, v, g)))
            np.savez("%s/%s_%d.npz" % (out_dir, name, rank), out=out, dq=dq,
                     dk=dk, dv=dv)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """Every GLOO_RUNS case from four spawned gloo processes, the ranks'
    shards joined along the sequence."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("gloo")
    mp.spawn(_gloo_worker, args=(str(tmp / "init"), str(tmp)),
             nprocs=GLOO_WORLD, join=True)
    results = {}
    for name, _, _ in GLOO_RUNS:
        parts = [np.load(tmp / ("%s_%d.npz" % (name, r)))
                 for r in range(GLOO_WORLD)]
        results[name] = [np.concatenate([p[key] for p in parts], axis=1)
                         for key in ("out", "dq", "dk", "dv")]
    return results


@pytest.mark.parametrize("name,case,impl", GLOO_RUNS)
def test_process_group_ring_matches_local_ring_and_jax(ref, gloo_results,
                                                       name, case, impl):
    """The four ranks' output and gradient shards, joined, equal
    LocalRing(4)'s (the same ring body on one process: the same sums in
    the same order) and match the JAX ring on four devices."""
    B, S, H, KV, D, causal = RING_CASES[case]
    q, k, v, g = _inputs(B, S, H, KV, D)
    local = _port_grads(lambda a, b, c: port_ring.ring_attention(
        a, b, c, port_ring.LocalRing(GLOO_WORLD), causal=causal, impl=impl),
        q, k, v, g)
    mesh = ref.mesh(GLOO_WORLD)
    want = _jax_grads(ref, lambda a, b, c: ref.ring.ring_attention(
        a, b, c, mesh, causal=causal,
        impl="flash_interpret" if impl == "flash" else "xla"), q, k, v, g)
    for got, same, jx in zip(gloo_results[name], local, want):
        np.testing.assert_allclose(got, same, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(gloo_results[name][0], want[0], **FWD_TOL)
    for got, jx in zip(gloo_results[name][1:], want[1:]):
        np.testing.assert_allclose(got, jx, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the model and the trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(ref):
    cfg = ref.llama.LlamaConfig.tiny(attention_impl="ring")
    params = ref.jax.tree.map(
        np.asarray, ref.llama.init_params(ref.jax.random.PRNGKey(0), cfg))
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 129)).astype(np.int32)
    return cfg, params, tokens


@pytest.mark.parametrize("ring_impl,ref_impl", [
    ("auto", "auto"), ("flash", "flash_interpret")])
def test_llama_ring_loss_and_grads_match_jax(ref, tiny, monkeypatch,
                                             ring_impl, ref_impl):
    """The tiny Llama's loss and every gradient with attention_impl="ring"
    on LocalRing(4) against the JAX loss_fn on a {"sequence": 4} mesh.
    'auto' is the einsum block in both packages off the TPU and the card;
    'flash' runs the port's flash ring through the kernels' plain versions
    (the model's ring_attention call given impl='flash') against the JAX
    flash ring in interpret mode (its TPUFLOW_RING_IMPL knob)."""
    cfg, np_params, tokens = tiny
    monkeypatch.setenv("TPUFLOW_RING_IMPL", ref_impl)
    monkeypatch.setattr(port_llama, "ring_attention", functools.partial(
        port_ring.ring_attention, impl=ring_impl))
    mesh = ref.mesh(4)
    loss, grads = ref.jax.jit(ref.jax.value_and_grad(
        lambda p: ref.llama.loss_fn(p, {"tokens": tokens}, cfg, mesh=mesh)))(
            np_params)
    pcfg = port_llama.LlamaConfig.tiny(attention_impl="ring")
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
        np.testing.assert_allclose(p.grad.numpy(), want[path], **GRAD_TOL,
                                   err_msg="/".join(path))


def test_llama_ring_needs_a_local_ring(tiny):
    """Without a ring mesh the ring branch raises the JAX ValueError; a
    ring of one shard per process, whose positions and loss would be per
    shard, raises NotImplementedError naming ROADMAP, for the ring and
    for Ulysses alike."""
    _, np_params, tokens = tiny
    pcfg = port_llama.LlamaConfig.tiny(attention_impl="ring")
    params = port_llama.from_jax_params(np_params, pcfg, device="cpu")
    with pytest.raises(ValueError, match="'sequence' axis"):
        port_llama.forward(params, tokens, pcfg, device="cpu")
    pg_ring = port_ring.ProcessGroupRing.__new__(port_ring.ProcessGroupRing)
    pg_ring.rank, pg_ring.size = 0, 4
    with pytest.raises(NotImplementedError, match="ROADMAP.md, slice 5"):
        port_llama.forward(params, tokens, pcfg, device="cpu", mesh=pg_ring)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, slice 5"):
        port_llama.forward(params, tokens, dataclasses.replace(
            pcfg, attention_impl="ulysses"), device="cpu", mesh=pg_ring)


def test_trainer_step_through_the_ring(tiny):
    """One trainer step with mesh=LocalRing(4) and attention_impl="ring"
    against one with plain attention and no mesh: the loss, the grad norm
    and the first moment (a tenth of each gradient; the first update has
    learning rate 0, so the weights stay as they were); make_eval_step
    takes the mesh too."""
    _, np_params, tokens = tiny
    batch = {"tokens": tokens}
    runs = {}
    for impl, mesh in (("ring", port_ring.LocalRing(4)), ("xla", None)):
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
    (m_ring, s_ring, e_ring), (m_plain, s_plain, e_plain) = (runs["ring"],
                                                             runs["xla"])
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(m_ring[key].item(), m_plain[key].item(),
                                   rtol=1e-5)
    np.testing.assert_allclose(e_ring.item(), m_ring["loss"].item(),
                               rtol=1e-6)
    np.testing.assert_allclose(e_plain.item(), m_plain["loss"].item(),
                               rtol=1e-6)
    for (path, a), (_, b) in zip(port_ts.leaves(s_ring["opt_state"]["mu"]),
                                 port_ts.leaves(s_plain["opt_state"]["mu"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-3, err_msg="/".join(path))
    for (path, a), (_, b) in zip(port_ts.leaves(s_ring["params"]),
                                 port_ts.leaves(s_plain["params"])):
        assert torch.equal(a, b), path
