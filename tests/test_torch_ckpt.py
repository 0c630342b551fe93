"""The port's resumable data stream and async checkpoints, on the CPU:
batches and stamps against the JAX package's loaders, prefetch, the
checkpoint manager's contract, blobs that each package's serializer reads
from the other, and a resumed run bit for bit an uninterrupted one."""

import threading
import time

import numpy as np
import pytest
import torch

from metaflow_tpu_torch.datastore import LocalFlowDataStore
from metaflow_tpu_torch.datastore import serializers as port_ser
from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.training import checkpoint as port_ckpt
from metaflow_tpu_torch.training import data as port_data
from metaflow_tpu_torch.training import train_step as port_ts

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

# every wait on a thread in these tests is bounded
JOIN_S = 30


@pytest.fixture(scope="module")
def ref():
    """The JAX package's data, datastore and checkpoint modules, imported
    only here."""
    pytest.importorskip("jax")
    from metaflow_tpu.datastore import serializers as ref_ser
    from metaflow_tpu.datastore.flow_datastore import FlowDataStore
    from metaflow_tpu.datastore.storage import LocalStorage
    from metaflow_tpu.models import llama as ref_llama
    from metaflow_tpu.training import checkpoint as ref_ckpt
    from metaflow_tpu.training import data as ref_data

    return ref_data, ref_ser, FlowDataStore, LocalStorage, ref_llama, ref_ckpt


def _tokens(n=2000, seed=0):
    return np.random.default_rng(seed).integers(0, 512, n).astype(np.int32)


@pytest.mark.parametrize("shard_windows", [None, 5])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batches_and_stamps_match_reference(ref, shard_windows, drop_last):
    """Two epochs of batches and stamps bit for bit the reference's, and a
    stream restored from a stamp in the middle continues as both do."""
    ref_data = ref[0]
    kw = dict(seed=7, epochs=2, drop_last=drop_last,
              shard_windows=shard_windows)
    data = _tokens()
    want = list(ref_data.ResumableTokenBatches(data, 4, 15, **kw))
    got = list(port_data.ResumableTokenBatches(data, 4, 15, **kw))
    assert len(got) == len(want) > 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
        assert g[port_data.STATE_KEY] == w[ref_data.STATE_KEY]
    stamp = got[5][port_data.STATE_KEY]
    rest = list(port_data.ResumableTokenBatches(data, 4, 15, **kw)
                .restore(stamp))
    for g, w in zip(rest, want[6:]):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])
    assert len(rest) == len(want) - 6
    with pytest.raises(ValueError, match="seed"):
        port_data.ResumableTokenBatches(data, 4, 15, seed=8).restore(stamp)


def test_token_batches_match_reference(ref):
    ref_data = ref[0]
    data = _tokens(1000)
    for drop_last in (True, False):
        want = list(ref_data.token_batches(
            data, 3, 31, rng=np.random.default_rng(2), drop_last=drop_last))
        got = list(port_data.token_batches(
            data, 3, 31, rng=np.random.default_rng(2), drop_last=drop_last))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_prefetch_to_device_keeps_the_stamp_on_the_host():
    stream = port_data.ResumableTokenBatches(_tokens(), 2, 15, seed=1,
                                             epochs=1)
    want = list(port_data.ResumableTokenBatches(_tokens(), 2, 15, seed=1,
                                                epochs=1))
    got = list(port_data.prefetch(iter(stream), depth=2, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g["tokens"], torch.Tensor)
        np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
        assert g[port_data.STATE_KEY] == w[port_data.STATE_KEY]
    # without a device the items pass as they are
    items = list(port_data.prefetch(iter(range(5)), depth=1))
    assert items == list(range(5))


def test_prefetch_raises_the_producers_error():
    def failing():
        yield {"tokens": np.zeros((1, 2), np.int32)}
        raise RuntimeError("corrupt shard")

    it = port_data.prefetch(failing(), device="cpu")
    next(it)
    with pytest.raises(RuntimeError, match="corrupt shard"):
        next(it)


def _state(gen):
    return {"params": {"w": torch.randn(4, 6, generator=gen).to(
                           torch.bfloat16),
                       "b": torch.randn(6, generator=gen)},
            "opt_state": {"count": 3, "mu": {"w": torch.zeros(4, 6)}},
            "step": 3}


def _zeros_like(state):
    return {k: _zeros_like(v) if isinstance(v, dict) else
            (torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0)
            for k, v in state.items()}


def test_save_restore_keep(tmp_path):
    """restore() finds the newest complete step; restore(like=) copies
    into the live tensors and takes the saved scalars; keep prunes the
    older manifests."""
    store = LocalFlowDataStore("Flow", str(tmp_path))
    mgr = port_ckpt.AsyncCheckpointManager(store, "run", keep=2)
    assert mgr.restore() is None
    gen = torch.Generator().manual_seed(0)
    states, saved_b = {}, {}
    for step in (1, 2, 3):
        states[step] = _state(gen)
        saved_b[step] = states[step]["params"]["b"].clone()
        mgr.save(states[step], step, extra={"cursor": step})
        # the step after the save updates in place: the snapshot holds
        states[step]["params"]["b"].add_(1.0)
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.done()
    live = _zeros_like(states[3])
    w = live["params"]["w"]
    ck = mgr.restore(like=live)
    assert (ck.step, ck.extra) == (3, {"cursor": 3})
    assert ck.state["params"]["w"] is w and w.dtype == torch.bfloat16
    assert torch.equal(w, states[3]["params"]["w"])
    assert torch.equal(ck.state["params"]["b"], saved_b[3])
    assert ck.state["step"] == 3 and ck.state["opt_state"]["count"] == 3
    assert mgr.last_restored is ck
    assert mgr.restore(step=2).state["params"]["b"].shape == (6,)
    live["params"]["w"] = torch.zeros(4, 7, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="params/w is torch.bfloat16"):
        mgr.restore(like=live)


def test_one_save_in_flight(tmp_path):
    """A second save waits for the first's background write."""
    store = LocalFlowDataStore("Flow", str(tmp_path))
    gate = threading.Event()
    save_blobs = store.ca_store.save_blobs

    def gated(blobs, **kw):
        assert gate.wait(JOIN_S)
        return save_blobs(blobs, **kw)

    store.ca_store.save_blobs = gated
    mgr = port_ckpt.AsyncCheckpointManager(store)
    state = _state(torch.Generator().manual_seed(1))
    mgr.save(state, 1)  # returns with the write held at the gate
    assert not mgr.done()
    second = threading.Thread(target=mgr.save, args=(state, 2))
    second.start()
    second.join(0.3)
    assert second.is_alive() and mgr.steps() == []
    gate.set()
    second.join(JOIN_S)
    assert not second.is_alive()
    mgr.wait()
    assert mgr.steps() == [1, 2]


def test_background_error_surfaces(tmp_path):
    store = LocalFlowDataStore("Flow", str(tmp_path))

    def full(blobs, **kw):
        raise OSError("disk full")

    store.ca_store.save_blobs = full
    mgr = port_ckpt.AsyncCheckpointManager(store)
    state = _state(torch.Generator().manual_seed(2))
    mgr.save(state, 1)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # reported once
    mgr.save(state, 2)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(state, 3)  # the next save reports the last one's failure
    mgr.save(state, 4)
    with pytest.raises(OSError, match="disk full"):  # done() reports it too
        deadline = time.monotonic() + JOIN_S
        while not mgr.done() and time.monotonic() < deadline:
            time.sleep(0.01)
    assert mgr.steps() == []


def test_crash_before_the_manifest_leaves_the_previous_checkpoint(tmp_path):
    store = LocalFlowDataStore("Flow", str(tmp_path))
    mgr = port_ckpt.AsyncCheckpointManager(store)
    gen = torch.Generator().manual_seed(3)
    first = _state(gen)
    mgr.save(first, 1)
    mgr.wait()
    save_bytes = store.storage.save_bytes

    def crash(pairs, **kw):
        pairs = list(pairs)
        if any(path.endswith(".json") for path, _ in pairs):
            raise RuntimeError("killed before the manifest")
        return save_bytes(pairs, **kw)

    store.storage.save_bytes = crash
    mgr.save(_state(gen), 2)
    with pytest.raises(RuntimeError, match="killed"):
        mgr.wait()
    store.storage.save_bytes = save_bytes
    assert mgr.steps() == [1]
    ck = port_ckpt.AsyncCheckpointManager(store).restore()
    assert ck.step == 1
    assert torch.equal(ck.state["params"]["w"], first["params"]["w"])


def _tiny_trainer(opt, seed, checkpoint=None, dtype="float32"):
    cfg = port_llama.LlamaConfig.tiny(dtype=dtype)
    return port_ts.make_trainer(
        cfg, port_llama, optimizer=opt, device="cpu", checkpoint=checkpoint,
        generator=torch.Generator().manual_seed(seed))


def test_restore_under_another_optimizer_names_it(tmp_path):
    """A checkpoint of an AdamW trainer refused by an Adafactor one."""
    mgr = port_ckpt.AsyncCheckpointManager(
        LocalFlowDataStore("Flow", str(tmp_path)))
    state, _ = _tiny_trainer(port_ts.default_optimizer(), 0)
    mgr.save(state, 0)
    mgr.wait()
    with pytest.raises(ValueError, match="different optimizer"):
        _tiny_trainer(port_ts.memory_efficient_optimizer(), 0,
                      checkpoint=mgr)


def test_jax_datastore_reads_the_ports_checkpoint(ref, tmp_path):
    """The port's manager writes through the JAX package's FlowDataStore on
    LocalStorage; the JAX manager restores it (bf16 through ml_dtypes), the
    port restores it, and the port reads a blob of JAX parameters that the
    JAX serializer wrote."""
    _, ref_ser, FlowDataStore, LocalStorage, ref_llama, ref_ckpt = ref
    import jax

    fds = FlowDataStore("TorchFlow", LocalStorage, ds_root=str(tmp_path))
    state, _ = _tiny_trainer(port_ts.memory_efficient_optimizer(), 4,
                             dtype="bfloat16")
    mgr = port_ckpt.AsyncCheckpointManager(fds, "train")
    mgr.save(state, 7, extra={"epoch": 0})
    mgr.wait()
    ck = ref_ckpt.AsyncCheckpointManager(fds, "train").restore()
    assert (ck.step, ck.extra) == (7, {"epoch": 0})
    for path, t in port_ts.leaves(state["params"]):
        got = ck.state["params"]
        for key in path:
            got = got[key]
        assert got.dtype == np.dtype("bfloat16")
        np.testing.assert_array_equal(got.astype(np.float32),
                                      t.detach().float().numpy())
    assert ck.state["opt_state"]["count"] == 0 and ck.state["step"] == 0
    mu = ck.state["opt_state"]["mu"]["layers"]["wq"]
    assert mu.dtype == np.dtype("bfloat16") and mu.shape == (2, 128, 128)
    assert port_ckpt.AsyncCheckpointManager(fds, "train").restore(
        like=state).step == 7

    cfg = ref_llama.LlamaConfig.tiny(dtype="bfloat16")
    jax_params = ref_llama.init_params(jax.random.PRNGKey(1), cfg)
    payload, tag = ref_ser.serialize(jax_params)
    [(_, key)] = fds.ca_store.save_blobs([payload])
    [(_, blob)] = list(fds.ca_store.load_blobs([key]))
    got = port_ser.deserialize(blob, tag)
    want = port_llama.from_jax_params(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jax_params),
        port_llama.LlamaConfig.tiny(dtype="bfloat16"), device="cpu")
    for path, t in port_ts.leaves(want):
        g = got
        for key in path:
            g = g[key]
        assert g.dtype == torch.bfloat16 and torch.equal(g, t), path


def test_resume_is_bit_identical(tmp_path):
    """2 steps, a save, a new make_trainer(checkpoint=) from other initial
    weights and the data stream restored from the saved stamp, then 3 more
    steps: the losses and the weights bit for bit those of 5 steps
    uninterrupted."""
    data = _tokens(4000, seed=5)

    def stream(stamp=None):
        ds = port_data.ResumableTokenBatches(data, 2, 32, seed=3)
        if stamp is not None:
            ds.restore(stamp)
        return port_data.prefetch(iter(ds), device="cpu")

    def opt():
        return port_ts.memory_efficient_optimizer(warmup_steps=1,
                                                  total_steps=10)

    state, step = _tiny_trainer(opt(), 0)
    batches = stream()
    losses = []
    for _ in range(5):
        state, m = step(state, next(batches))
        losses.append(m["loss"].item())
    batches.close()

    mgr = port_ckpt.AsyncCheckpointManager(
        LocalFlowDataStore("Flow", str(tmp_path)))
    state2, step2 = _tiny_trainer(opt(), 0)
    batches = stream()
    for _ in range(2):
        batch = next(batches)
        state2, m = step2(state2, batch)
    mgr.save(state2, state2["step"], extra=batch[port_data.STATE_KEY])
    batches.close()
    mgr.wait()

    state3, step3 = _tiny_trainer(opt(), 9, checkpoint=mgr)
    assert state3["step"] == 2 and state3["opt_state"]["count"] == 2
    batches = stream(mgr.last_restored.extra)
    resumed = []
    for _ in range(3):
        state3, m = step3(state3, next(batches))
        resumed.append(m["loss"].item())
    batches.close()
    assert resumed == losses[2:]
    assert state3["step"] == 5
    for (path, a), (_, b) in zip(port_ts.leaves(state3["params"]),
                                 port_ts.leaves(state["params"])):
        assert torch.equal(a, b), path
    for name in ("v_row", "v_col", "v", "mu"):
        for (path, a), (_, b) in zip(
                port_ts.leaves(state3["opt_state"][name]),
                port_ts.leaves(state["opt_state"][name])):
            assert torch.equal(a, b), (name, path)
