"""The port's streamed corpus against the JAX package's data subsystem, on
the CPU: a corpus built by either package streams, through the other's
StreamingTokenBatches, the same batches and resume stamps bit for bit
(the same blob keys, tags and manifest); host slices with two hosts;
resume at every cut; the zero-window tail shard; a flipped byte raising
ShardCorruptionError; the data.* records valid under the pinned schema;
and packing equal to the JAX package's (the cases of tests/test_data.py).

Every comparison here is exact: both packages run the same numpy code on
the same bytes. The JAX package is imported inside the `ref` fixture."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from metaflow_tpu_torch import data as port_data
from metaflow_tpu_torch import telemetry as port_tel
from metaflow_tpu_torch.datastore import LocalFlowDataStore
from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.training import data as port_training_data

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from schema_validate import (  # noqa: E402
    validate_data_record,
    validate_dataset_manifest,
)

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

STATE_KEY = port_data.STATE_KEY
SEQ = 9
W = SEQ + 1
SHARD_WINDOWS = 3
SHARD_TOKENS = SHARD_WINDOWS * W


def make_data(n_shards=7, tail_tokens=0):
    n = n_shards * SHARD_TOKENS + tail_tokens
    return (np.arange(n) % 251).astype(np.int32)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from metaflow_tpu import data, telemetry
    from metaflow_tpu.datastore import FlowDataStore
    from metaflow_tpu.datastore.storage import LocalStorage
    from metaflow_tpu.training import data as training_data

    def fds(root):
        return FlowDataStore("DataFlow", LocalStorage, ds_root=str(root),
                             blob_cache=False)

    return types.SimpleNamespace(data=data, telemetry=telemetry, fds=fds,
                                 training_data=training_data)


@pytest.fixture()
def stores(ref, tmp_path):
    """The port's and the JAX package's datastore over one root."""
    root = tmp_path / "root"
    return LocalFlowDataStore("DataFlow", str(root)), ref.fds(root)


def _stream(pkg, fds, **kw):
    """Every batch of a StreamingTokenBatches over corpus 'c': (tokens
    bytes, stamp) pairs."""
    ds = pkg.StreamingTokenBatches(fds, "c", kw.pop("batch", 4), SEQ, **kw)
    return [(b["tokens"].tobytes(), b[STATE_KEY]) for b in ds]


@pytest.mark.parametrize("seed", [None, 0, 11])
@pytest.mark.parametrize("built_by", ["port", "jax"])
def test_either_package_reads_the_others_corpus(ref, tmp_path, built_by,
                                                seed):
    """A corpus built by one package streams, through both packages'
    loaders, the same batches and stamps bit for bit, over two epochs and
    a short last shard; the two packages' builds of the same tokens give
    the same manifest and the same blob files (keys and raw tag)."""
    data = make_data(5, tail_tokens=2 * W + 3)
    port_fds = LocalFlowDataStore("DataFlow", str(tmp_path / "port"))
    jax_fds = ref.fds(tmp_path / "jax")
    built = {"port": port_data.build_corpus(port_fds, "c", data,
                                            shard_tokens=SHARD_TOKENS),
             "jax": ref.data.build_corpus(jax_fds, "c", data,
                                          shard_tokens=SHARD_TOKENS)}
    assert built["port"] == built["jax"]
    validate_dataset_manifest(built["port"])
    for shard in built["port"]["shards"]:
        paths = [os.path.join(str(tmp_path / side), "DataFlow", "data",
                              shard["key"][:2], shard["key"])
                 for side in ("port", "jax")]
        blobs = [open(p, "rb").read() for p in paths]
        assert blobs[0] == blobs[1] and blobs[0][:1] == b"0"
    # read one package's corpus with both packages' loaders on one root
    root = tmp_path / built_by
    readers = {"port": LocalFlowDataStore("DataFlow", str(root)),
               "jax": ref.fds(root)}
    got = _stream(port_data, readers["port"], seed=seed, epochs=2,
                  drop_last=False)
    want = _stream(ref.data, readers["jax"], seed=seed, epochs=2,
                   drop_last=False)
    assert len(got) == len(want) > 4
    assert got == want
    assert port_data.list_datasets(readers["port"]) == \
        ref.data.list_datasets(readers["jax"]) == ["c"]


def test_append_corpus_matches_jax(ref, tmp_path):
    """append_corpus writes the JAX package's manifest (revision,
    generation) and its appended shards stream alike."""
    data = make_data(3)
    port_fds = LocalFlowDataStore("DataFlow", str(tmp_path / "port"))
    jax_fds = ref.fds(tmp_path / "jax")
    for mod, fds in ((port_data, port_fds), (ref.data, jax_fds)):
        mod.build_corpus(fds, "c", data, shard_tokens=SHARD_TOKENS)
    extra = make_data(2)[::-1].copy()
    got = port_data.shards.append_corpus(port_fds, "c", extra,
                                         generation=3)
    want = ref.data.shards.append_corpus(jax_fds, "c", extra, generation=3)
    assert got == want and got["revision"] == 1
    assert _stream(port_data, port_fds, seed=2, epochs=1) == \
        _stream(ref.data, jax_fds, seed=2, epochs=1)


def test_host_slices_two_hosts(ref, stores):
    """With n_hosts 2 each host streams what the JAX loader streams for
    it, the hosts' shard sets are disjoint and together cover the
    corpus."""
    port_fds, jax_fds = stores
    manifest = port_data.build_corpus(port_fds, "c", make_data(8),
                                      shard_tokens=SHARD_TOKENS)
    seen = []
    for host in (0, 1):
        kw = dict(seed=4, epochs=2, host_index=host, n_hosts=2)
        got = _stream(port_data, port_fds, batch=2, **kw)
        assert got == _stream(ref.data, jax_fds, batch=2, **kw)
        order = port_data.epoch_shard_order(4, 0, manifest["n_shards"])
        mine = port_data.reader.host_slice(order, host, 2)
        assert mine == ref.data.reader.host_slice(order, host, 2)
        seen.append(set(mine))
    assert not seen[0] & seen[1]
    assert seen[0] | seen[1] == set(range(manifest["n_shards"]))
    with pytest.raises(ValueError):
        port_data.reader.host_slice([0, 1], 2, 2)


def test_resume_at_every_cut(ref, stores):
    """The stamp after batch k, through JSON, restored into a new port
    loader and into a new JAX loader: both continue with the
    uninterrupted stream's next batch and stamp, for every k (cuts inside
    shards, on shard boundaries and across the epoch rollover)."""
    port_fds, jax_fds = stores
    port_data.build_corpus(port_fds, "c", make_data(6),
                           shard_tokens=SHARD_TOKENS)
    full = _stream(port_data, port_fds, seed=11, epochs=2)
    assert len(full) > 4
    for cut in range(1, len(full)):
        stamp = json.loads(json.dumps(full[cut - 1][1]))
        for mod, fds in ((port_data, port_fds), (ref.data, jax_fds)):
            ds = mod.StreamingTokenBatches(fds, "c", 4, SEQ, seed=11,
                                           epochs=2).restore(stamp)
            rest = [(b["tokens"].tobytes(), b[STATE_KEY]) for b in ds]
            assert rest == full[cut:], (mod.__name__, cut)


@pytest.mark.parametrize("seed", [None, 2])
def test_zero_window_tail_shard(ref, stores, seed):
    """A trailing shard too short for one window stays out of the shard
    order: the port's stream equals the JAX one and the in-memory
    ResumableTokenBatches over the same tokens."""
    port_fds, jax_fds = stores
    data = make_data(4, tail_tokens=W - 3)
    port_data.build_corpus(port_fds, "c", data, shard_tokens=SHARD_TOKENS)
    got = _stream(port_data, port_fds, seed=seed, epochs=3)
    assert got == _stream(ref.data, jax_fds, seed=seed, epochs=3)
    rtb = port_training_data.ResumableTokenBatches(
        data, 4, SEQ, seed=seed, epochs=3, shard_windows=SHARD_WINDOWS)
    assert [g for g, _ in got] == [b["tokens"].tobytes() for b in rtb]


def test_flipped_byte_raises_shard_corruption(ref, stores):
    """One byte of a shard flipped in the store: the port's reader
    refetches once, then raises ShardCorruptionError, as the JAX reader
    does on the same store."""
    port_fds, jax_fds = stores
    manifest = port_data.build_corpus(port_fds, "c", make_data(3),
                                      shard_tokens=SHARD_TOKENS)
    victim = manifest["shards"][1]["key"]
    path = port_fds.storage.full_uri(port_fds.ca_store.blob_path(victim))
    blob = bytearray(open(path, "rb").read())
    blob[7] ^= 0x01
    open(path, "wb").write(bytes(blob))
    reader = port_data.ShardReader(port_fds, manifest)
    with pytest.raises(port_data.ShardCorruptionError, match="shard 1"):
        for _ in reader.stream([0, 1, 2]):
            pass
    assert reader.stats["retries"] == 1
    ref_reader = ref.data.ShardReader(jax_fds, manifest)
    with pytest.raises(ref.data.ShardCorruptionError):
        for _ in ref_reader.stream([0, 1, 2]):
            pass
    assert ref_reader.stats["retries"] == 1


def _records(tel, fds, fn):
    tel.init_recorder(fds, "r1", "train", "t1")
    try:
        fn()
    finally:
        tel.close_recorder()
    return tel.read_run_records(fds, "r1")


def test_data_records_match_the_schema_and_jax(ref, stores, monkeypatch):
    """The port's data.* records are valid under the pinned schema, and a
    stream of one epoch emits the names the JAX stream emits, in number;
    each shard_fetch carries the bytes the JAX one carries."""
    port_fds, jax_fds = stores
    port_data.build_corpus(port_fds, "c", make_data(4),
                           shard_tokens=SHARD_TOKENS)
    # one fetch worker: the records of a fetch and its gauge interleave
    # in one order in both packages
    monkeypatch.setenv("TPUFLOW_DATA_WORKERS", "1")

    def consume(mod, fds):
        return lambda: [None for _ in mod.StreamingTokenBatches(
            fds, "c", 4, SEQ, seed=1, epochs=1)]

    got = _records(port_tel, port_fds, consume(port_data, port_fds))
    want = _records(ref.telemetry, jax_fds, consume(ref.data, jax_fds))
    got = [r for r in got if r["name"].startswith("data.")]
    want = [r for r in want if r["name"].startswith("data.")]
    assert {"data.shard_fetch", "data.batch_wait",
            "data.readahead_occupancy"} <= {r["name"] for r in got}
    for rec in got:
        validate_data_record(rec)
    assert sorted(r["name"] for r in got) == sorted(r["name"] for r in want)
    fetched = [sorted((r["data"]["shard"], r["data"]["bytes"]) for r in recs
                      if r["name"] == "data.shard_fetch")
               for recs in (got, want)]
    assert fetched[0] == fetched[1]


def test_streamed_batches_feed_the_trainer(stores):
    """StreamingTokenBatches through prefetch(device="cpu") hands the
    trainer tensors with the stamp kept on the host."""
    port_fds, _ = stores
    port_data.build_corpus(port_fds, "c", make_data(4),
                           shard_tokens=SHARD_TOKENS)
    ds = port_data.StreamingTokenBatches(port_fds, "c", 2, SEQ, seed=0,
                                         epochs=1)
    it = port_training_data.prefetch(iter(ds), depth=2, device="cpu")
    try:
        batch = next(it)
    finally:
        it.close()
    assert isinstance(batch["tokens"], torch.Tensor)
    assert tuple(batch["tokens"].shape) == (2, W)
    assert isinstance(batch[STATE_KEY]["epoch"], int)


def test_sanitize_knob_raises(stores, monkeypatch):
    port_fds, _ = stores
    port_data.build_corpus(port_fds, "c", make_data(2),
                           shard_tokens=SHARD_TOKENS)
    monkeypatch.setenv("TPUFLOW_SANITIZE", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_data.StreamingTokenBatches(port_fds, "c", 2, SEQ)


# ---------------------------------------------------------------------------
# packing (tests/test_data.py TestPacking's cases)
# ---------------------------------------------------------------------------


def _docs(case):
    rng = np.random.default_rng(1)
    return {
        "segments_and_padding": ([[1, 2, 3], [4, 5], [6, 7, 8, 9]], 4),
        "long_doc": ([list(range(1, 13))], 4),
        "exact_boundary": ([[1, 2, 3, 4, 5], [6, 7]], 4),
        "many": ([rng.integers(1, 100, rng.integers(1, 23))
                  for _ in range(50)], 9),
    }[case]


@pytest.mark.parametrize("case", ["segments_and_padding", "long_doc",
                                  "exact_boundary", "many"])
def test_pack_documents_matches_jax(ref, case):
    docs, seq_len = _docs(case)
    got = list(port_data.pack_documents(docs, seq_len))
    want = list(ref.data.pack_documents(docs, seq_len))
    assert len(got) == len(want) > 0
    for (t, s), (rt, rs) in zip(got, want):
        assert t.dtype == rt.dtype and s.dtype == rs.dtype
        np.testing.assert_array_equal(t, rt)
        np.testing.assert_array_equal(s, rs)
    if case == "segments_and_padding":
        assert [s.tolist() for _, s in got] == [[1, 1, 1, 2, 2],
                                                [1, 1, 1, 1, 0]]


def test_segment_loss_mask_matches_jax(ref):
    segs = np.array([[1, 1, 2, 2, 0], [1, 1, 1, 1, 1]])
    got = port_data.segment_loss_mask(segs)
    np.testing.assert_array_equal(got, ref.data.segment_loss_mask(segs))
    assert got.tolist()[0] == [1.0, 0.0, 1.0, 0.0]


@pytest.mark.parametrize("drop_last", [False, True])
def test_packed_batches_match_jax_and_feed_the_loss(ref, drop_last):
    """packed_batches equals the JAX one, key by key, and its first batch
    (inputs, targets, mask) gives the port's tiny Llama a finite loss."""
    rng = np.random.default_rng(0)
    cfg = port_llama.LlamaConfig.tiny()
    docs = [rng.integers(1, cfg.vocab_size, rng.integers(3, 40))
            for _ in range(12)]
    got = list(port_data.packed_batches(docs, 2, 16, drop_last=drop_last))
    want = list(ref.data.packed_batches(docs, 2, 16, drop_last=drop_last))
    assert len(got) == len(want) > 0
    for b, rb in zip(got, want):
        assert sorted(b) == sorted(rb)
        for key in b:
            np.testing.assert_array_equal(b[key], rb[key])
    params = port_llama.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = {k: got[0][k] for k in ("inputs", "targets", "mask")}
    loss = port_llama.loss_fn(params, batch, cfg, device="cpu")
    assert torch.isfinite(loss)
