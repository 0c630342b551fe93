"""StreamingTokenBatches: the ResumableTokenBatches contract over a
sharded on-datastore corpus. The port's copy of the JAX package's
data/loader.py: the same batches and resume stamps, bit for bit.

Yields {'tokens': [B, seq_len+1], STATE_KEY: {...}} batches, exactly like
training/data.py::ResumableTokenBatches — but the corpus never
materializes in host memory: shards stream through the bounded-readahead
ShardReader, and each host of a gang reads only its deterministic slice
of the epoch's shard order.

Resume stamp (flat ints, stamped onto EVERY batch under STATE_KEY):

    epoch          epochs completed
    shard_cursor   position in THIS HOST's slice of the epoch shard order
    window_cursor  windows consumed within the current shard's order
    seed           shuffle seed (orders are pure functions of it)
    + geometry cross-checks: batch_size, window, n_shards, total_tokens,
      shard_tokens, host_index, n_hosts, drop_last

`restore(stamp)` positions the stream just after the batch that carried
the stamp — iteration continues with the exact next token, zero replay,
zero skip, including across shard boundaries and epoch rollovers.

Byte-identity with the in-memory loader: when shard_tokens is a multiple
of (seq_len+1), the stream equals ResumableTokenBatches over the
concatenated token array with the same seed and
shard_windows=shard_tokens//(seq_len+1) — both walk the shared
hierarchical order in ordering.py (seed=None matches plain sequential
ResumableTokenBatches too).
"""

import time

import numpy as np

from .. import knobs, telemetry
from .ordering import STATE_KEY, epoch_shard_order, shard_window_order
from .reader import ShardReader, host_slice
from .shards import DatasetError, load_manifest


class StreamingTokenBatches(object):
    def __init__(self, flow_datastore, corpus, batch_size, seq_len, *,
                 seed=None, epochs=None, drop_last=True, host_index=None,
                 n_hosts=None, readahead_bytes=None, max_workers=None,
                 reader=None, verify=True):
        """corpus: a dataset name (manifest loaded from the datastore) or
        an already-loaded manifest dict. host_index/n_hosts default to the
        gang env (MF_PARALLEL_NODE_INDEX / MF_PARALLEL_NUM_NODES) so a
        gang worker picks up its slice with no extra wiring."""
        self._manifest = (corpus if isinstance(corpus, dict)
                          else load_manifest(flow_datastore, corpus))
        self._batch_size = int(batch_size)
        self._window = int(seq_len) + 1
        self._seed = seed
        self._epochs = epochs
        self._drop_last = bool(drop_last)
        if host_index is None:
            host_index = _env_int("MF_PARALLEL_NODE_INDEX", 0)
        if n_hosts is None:
            n_hosts = _env_int("MF_PARALLEL_NUM_NODES", 1)
        self._host_index = int(host_index)
        self._n_hosts = int(n_hosts)
        if not 0 <= self._host_index < self._n_hosts:
            raise DatasetError(
                "host_index=%d out of range for n_hosts=%d"
                % (self._host_index, self._n_hosts))
        self._wins = [s["tokens"] // self._window
                      for s in self._manifest["shards"]]
        self._n_shards = len(self._wins)
        if sum(self._wins) == 0:
            raise DatasetError(
                "corpus %r holds no complete %d-token window in any shard"
                % (self._manifest.get("name"), self._window))
        # only the TRAILING shard can be short (fixed shard_tokens), so
        # any zero-window shard sits at the end; it never enters the
        # epoch order — matching hierarchical_window_order's
        # ceil(n_windows/shard_windows) shard count, so streaming and
        # in-memory orders stay identical even when the tail shard holds
        # no complete window
        self._n_order = self._n_shards
        while self._n_order and self._wins[self._n_order - 1] == 0:
            self._n_order -= 1
        self._reader = reader or ShardReader(
            flow_datastore, self._manifest, max_workers=max_workers,
            readahead_bytes=readahead_bytes, verify=verify)
        self._epoch = 0
        self._shard_cursor = 0
        self._window_cursor = 0
        if knobs.get_bool("TPUFLOW_SANITIZE"):
            raise NotImplementedError(
                "TPUFLOW_SANITIZE is set, but the port has no collective "
                "sanitizer yet (ROADMAP.md, slice 5: the sanitizer)")

    # ---------- geometry ----------

    @property
    def reader(self):
        return self._reader

    def _host_order(self, epoch):
        return host_slice(
            epoch_shard_order(self._seed, epoch, self._n_order),
            self._host_index, self._n_hosts)

    def host_windows(self, epoch=None):
        """Windows this host consumes in `epoch` (membership of the host
        slice varies with the epoch's shard order when shards are
        unequal)."""
        order = self._host_order(self._epoch if epoch is None else epoch)
        return sum(self._wins[s] for s in order)

    def batches_per_epoch(self, epoch=None):
        n = self.host_windows(epoch)
        if self._drop_last:
            return n // self._batch_size
        return -(-n // self._batch_size)

    # ---------- resume contract ----------

    def state(self):
        """Resume state BEFORE the next batch to be produced (flat ints;
        JSON- and orbax-serializable). Carries the full stream geometry,
        so restoring onto a differently-shaped stream is a hard error,
        not a silently different token sequence."""
        return {
            "epoch": int(self._epoch),
            "shard_cursor": int(self._shard_cursor),
            "window_cursor": int(self._window_cursor),
            "seed": self._seed,
            "batch_size": int(self._batch_size),
            "window": int(self._window),
            "n_shards": int(self._n_shards),
            "total_tokens": int(self._manifest["total_tokens"]),
            "shard_tokens": int(self._manifest["shard_tokens"]),
            "host_index": int(self._host_index),
            "n_hosts": int(self._n_hosts),
            "drop_last": int(self._drop_last),
        }

    def restore(self, state, reslice=False):
        """Position the stream just after the batch that carried `state`
        — iteration continues with the batch that would have come next.

        reslice=True accepts a stamp recorded under a DIFFERENT gang
        geometry (host_index/n_hosts — an elastic resize): per-host
        slices are disjoint stride slices of the epoch shard order, so a
        mid-epoch position under the old slicing has no exact equivalent
        under the new one. The stamp must therefore sit at an epoch
        boundary (start of an epoch, or the old slice fully drained);
        the new layout then re-slices that epoch deterministically and
        the GLOBAL token order stays exact. A mid-epoch stamp with a
        changed geometry is a hard error either way — align resizes to
        checkpoint-at-epoch-boundary (or use a global, non-sharded
        stream, which is resize-invariant)."""
        if state.get("seed") != self._seed:
            raise ValueError(
                "checkpointed stream seed %r != this stream's %r — "
                "restoring would produce a different shuffle order"
                % (state.get("seed"), self._seed))
        old_hosts = (int(state.get("host_index", self._host_index)),
                     int(state.get("n_hosts", self._n_hosts)))
        if reslice and old_hosts != (self._host_index, self._n_hosts):
            return self._restore_resliced(state, old_hosts)
        for key, mine in (("batch_size", self._batch_size),
                          ("window", self._window),
                          ("n_shards", self._n_shards),
                          ("total_tokens", self._manifest["total_tokens"]),
                          ("shard_tokens", self._manifest["shard_tokens"]),
                          ("host_index", self._host_index),
                          ("n_hosts", self._n_hosts),
                          ("drop_last", int(self._drop_last))):
            theirs = int(state[key])
            if theirs != int(mine):
                raise ValueError(
                    "checkpointed stream %s=%d != this stream's %d — the "
                    "cursor would address different tokens (the same "
                    "corpus, geometry and host slice are required to "
                    "resume)" % (key, theirs, int(mine)))
        epoch = int(state["epoch"])
        shard_cursor = int(state["shard_cursor"])
        window_cursor = int(state["window_cursor"])
        if epoch < 0 or (self._epochs is not None and epoch > self._epochs):
            raise ValueError(
                "checkpointed stream epoch=%d out of range [0, %s] — "
                "corrupted resume stamp" % (epoch, self._epochs))
        order = self._host_order(epoch)
        # shard_cursor == len(order) is the legal "epoch drained" stamp
        if not 0 <= shard_cursor <= len(order):
            raise ValueError(
                "checkpointed stream shard_cursor=%d out of range [0, %d] "
                "— corrupted resume stamp" % (shard_cursor, len(order)))
        if shard_cursor < len(order):
            wins = self._wins[order[shard_cursor]]
        else:
            wins = 0
        if not 0 <= window_cursor <= max(0, wins):
            raise ValueError(
                "checkpointed stream window_cursor=%d out of range [0, %d]"
                " — corrupted resume stamp" % (window_cursor, wins))
        self._epoch = epoch
        self._shard_cursor = shard_cursor
        self._window_cursor = window_cursor
        return self

    def _restore_resliced(self, state, old_hosts):
        """Epoch-boundary restore across a gang-geometry change."""
        old_index, old_n = old_hosts
        for key, mine in (("batch_size", self._batch_size),
                          ("window", self._window),
                          ("n_shards", self._n_shards),
                          ("total_tokens", self._manifest["total_tokens"]),
                          ("shard_tokens", self._manifest["shard_tokens"]),
                          ("drop_last", int(self._drop_last))):
            theirs = int(state[key])
            if theirs != int(mine):
                raise ValueError(
                    "checkpointed stream %s=%d != this stream's %d — a "
                    "resize can re-slice the SAME corpus, not a "
                    "different one" % (key, theirs, int(mine)))
        if not 0 <= old_index < old_n:
            raise ValueError(
                "checkpointed stream host_index=%d out of range for "
                "n_hosts=%d — corrupted resume stamp" % (old_index, old_n))
        epoch = int(state["epoch"])
        shard_cursor = int(state["shard_cursor"])
        window_cursor = int(state["window_cursor"])
        if epoch < 0 or (self._epochs is not None and epoch > self._epochs):
            raise ValueError(
                "checkpointed stream epoch=%d out of range [0, %s] — "
                "corrupted resume stamp" % (epoch, self._epochs))
        old_order = host_slice(
            epoch_shard_order(self._seed, epoch, self._n_order),
            old_index, old_n)
        if shard_cursor == 0 and window_cursor == 0:
            pass  # start of `epoch` — globally aligned under any slicing
        elif shard_cursor == len(old_order) and window_cursor == 0:
            epoch += 1  # old slice fully drained: next epoch's start
        else:
            raise ValueError(
                "cannot re-slice a mid-epoch stamp (epoch=%d, "
                "shard_cursor=%d/%d, window_cursor=%d) from %d host(s) "
                "onto %d: per-host slices are disjoint, so the position "
                "has no exact equivalent. Align elastic resizes to an "
                "epoch boundary, or stream a global (non-sharded) "
                "source." % (epoch, shard_cursor, len(old_order),
                             window_cursor, old_n, self._n_hosts))
        if self._epochs is not None and epoch > self._epochs:
            raise ValueError(
                "checkpointed stream epoch=%d out of range [0, %s] — "
                "corrupted resume stamp" % (epoch, self._epochs))
        self._epoch = epoch
        self._shard_cursor = 0
        self._window_cursor = 0
        return self

    # ---------- iteration ----------

    def __iter__(self):
        B, W = self._batch_size, self._window
        while self._epochs is None or self._epoch < self._epochs:
            order = self._host_order(self._epoch)
            from_start = (self._shard_cursor == 0
                          and self._window_cursor == 0)
            yielded = False
            buf = []
            t_batch = time.perf_counter()
            pos = self._shard_cursor
            stream = self._reader.stream(order[pos:])
            try:
                for sid, tokens in stream:
                    wins = self._wins[sid]
                    worder = shard_window_order(
                        self._seed, self._epoch, sid, wins)
                    j = self._window_cursor
                    while j < wins:
                        w = int(worder[j])
                        j += 1
                        # cursor advances BEFORE the yield so the stamp
                        # always points at the NEXT window — device
                        # prefetch running the iterator ahead cannot
                        # desynchronize it from consumed batches
                        if j == wins:
                            self._shard_cursor = pos + 1
                            self._window_cursor = 0
                        else:
                            self._shard_cursor = pos
                            self._window_cursor = j
                        buf.append(tokens[w * W:(w + 1) * W])
                        if len(buf) == B:
                            telemetry.emit(
                                "timer", "data.batch_wait",
                                ms=(time.perf_counter() - t_batch) * 1000,
                                ok=True)
                            batch = np.stack(buf)
                            yield {"tokens": batch,
                                   STATE_KEY: self.state()}
                            yielded = True
                            buf = []
                            t_batch = time.perf_counter()
                    pos += 1
                    self._shard_cursor = pos
                    self._window_cursor = 0
            finally:
                stream.close()
            if buf and not self._drop_last:
                telemetry.emit(
                    "timer", "data.batch_wait",
                    ms=(time.perf_counter() - t_batch) * 1000, ok=True)
                batch = np.stack(buf)
                yield {"tokens": batch, STATE_KEY: self.state()}
                yielded = True
            if not yielded and self._epochs is None and from_start:
                # an epoch consumed from its start produced NO batch (this
                # host's slice holds fewer than batch_size windows under
                # drop_last, or no shards at all): with epochs=None the
                # loop would spin forever, re-downloading the slice each
                # pass while next() never returns
                raise DatasetError(
                    "host %d/%d drew %d window(s) in epoch %d — not "
                    "enough for one batch of %d (drop_last=%s); an "
                    "unbounded stream would never yield. Shrink "
                    "batch_size or n_hosts, or grow the corpus."
                    % (self._host_index, self._n_hosts,
                       self.host_windows(self._epoch), self._epoch,
                       self._batch_size, self._drop_last))
            self._epoch += 1
            self._shard_cursor = 0
            self._window_cursor = 0


def _env_int(name, default):
    import os

    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default
