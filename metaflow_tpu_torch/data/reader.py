"""Bounded-readahead parallel shard reader: the port's copy of the JAX
package's data/reader.py.

The datastore→host side of the streaming input pipeline: a thread pool
fetches shard blobs AHEAD of consumption so the loader (and through it
the device) never waits on storage in steady state.

  - the readahead window is measured in BYTES (TPUFLOW_DATA_READAHEAD_MB,
    default 64), not shards, so corpora with different shard sizes get
    the same memory bound;
  - every fetched blob is checksum-verified in flight against the
    manifest (the CAS key is the sha256); a mismatch retries ONCE
    bypassing the blob cache — a corrupted cache entry heals, a
    corrupted object in the store is a hard ShardCorruptionError;
  - shard ORDER is the caller's: the loader passes each host its own
    deterministic slice of the epoch's shard order (host_slice), so every
    host of a gang reads only its 1/n of the corpus.

Telemetry (names pinned in tests/schema_validate.py):
  data.shard_fetch        timer, per fetched blob ({shard, bytes, retried})
  data.readahead_occupancy gauge, readahead-window fill fraction at each
                          consumer take ({bytes, shards, window_bytes})
  data.shard_retry        counter, checksum-mismatch refetches
"""

import collections
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout

from .. import knobs, telemetry
from ..exception import TpuFlowException
from .shards import decode_shard, verify_blob

DEFAULT_READAHEAD_MB = 64
DEFAULT_WORKERS = 8


class ShardCorruptionError(TpuFlowException):
    headline = "Corrupted dataset shard"


def storage_timeout_s():
    """TPUFLOW_STORAGE_TIMEOUT_S: per-operation deadline for blocking
    storage reads (0 / unset = no deadline), as the JAX package's
    datastore reads it."""
    return knobs.get_float("TPUFLOW_STORAGE_TIMEOUT_S")


def readahead_bytes_from_env():
    mb = knobs.get_float("TPUFLOW_DATA_READAHEAD_MB")
    return max(1, int(mb * 1024 * 1024))


def host_slice(order, host_index, n_hosts):
    """The shards host `host_index` of `n_hosts` consumes, given the
    epoch's global shard order: a stride-slice, so host sets are disjoint
    and together cover every shard exactly once."""
    if not 0 <= int(host_index) < int(n_hosts):
        raise ValueError("host_index=%s out of range for n_hosts=%s"
                         % (host_index, n_hosts))
    return [int(s) for s in order[int(host_index)::int(n_hosts)]]


class ShardReader(object):
    """Parallel prefetching reader over one corpus manifest.

    `stream(shard_ids)` yields (shard_id, token_array) in the GIVEN
    order; up to `readahead_bytes` of further shards are in flight or
    ready at any time. `stats` accumulates fetch/retry/occupancy/wait
    figures across streams (the data bench reads them)."""

    def __init__(self, flow_datastore, manifest, max_workers=None,
                 readahead_bytes=None, verify=True):
        self._fds = flow_datastore
        self._manifest = manifest
        if max_workers is None:
            max_workers = knobs.get_int("TPUFLOW_DATA_WORKERS")
        self._max_workers = max(1, max_workers)
        self._readahead = (readahead_bytes if readahead_bytes
                           else readahead_bytes_from_env())
        self._verify = verify
        self.stats = {"fetches": 0, "retries": 0, "bytes": 0,
                      "wait_ms": 0.0, "occupancy_sum": 0.0,
                      "occupancy_samples": 0}
        # fetches/retries/bytes are bumped from pool worker threads;
        # += on a dict entry is a read-modify-write that loses updates
        # without a lock (the bench and tests read exact counts)
        self._stats_lock = threading.Lock()

    # ---------- blob fetch (worker threads) ----------

    def _fetch_from_storage(self, key):
        """Cache-bypassing fetch straight from storage (the retry path:
        the blob cache may hold the corrupted copy)."""
        cas = self._fds.ca_store
        with cas.storage.load_bytes([cas.blob_path(key)]) as loaded:
            for _path, local, _meta in loaded:
                if local is None:
                    raise KeyError(
                        "dataset shard blob %s not found in datastore"
                        % key)
                with open(local, "rb") as f:
                    return cas._unpack(f.read())

    def _fetch(self, shard_id):
        shard = self._manifest["shards"][shard_id]
        key = shard["key"]
        start = time.perf_counter()
        retried = False
        blob = None
        for _k, b in self._fds.ca_store.load_blobs([key]):
            blob = b
        if self._verify and not (blob is not None
                                 and verify_blob(shard, blob)):
            # a bad cache entry (bit rot on local disk) must not kill the
            # run: refetch once from the store itself, bypassing the cache
            retried = True
            with self._stats_lock:
                self.stats["retries"] += 1
            telemetry.counter("data.shard_retry",
                              data={"shard": int(shard_id)})
            blob = self._fetch_from_storage(key)
            if not verify_blob(shard, blob):
                raise ShardCorruptionError(
                    "shard %d of dataset %r is corrupted in the datastore "
                    "(sha256 mismatch for key %s after cache-bypass "
                    "refetch)" % (shard_id, self._manifest.get("name"),
                                  key))
            cache = self._fds.ca_store.blob_cache
            if cache is not None:  # heal the poisoned cache entry
                cache.store_key(key, blob)
        tokens = decode_shard(self._manifest, shard_id, blob)
        with self._stats_lock:
            self.stats["fetches"] += 1
            self.stats["bytes"] += len(blob)
        telemetry.emit(
            "timer", "data.shard_fetch",
            ms=(time.perf_counter() - start) * 1000, ok=True,
            data={"shard": int(shard_id), "bytes": len(blob),
                  "retried": retried})
        return tokens

    # ---------- ordered, bounded streaming (consumer side) ----------

    def stream(self, shard_ids):
        """Yield (shard_id, tokens) for `shard_ids` in order, keeping up
        to the readahead window of further shards in flight."""
        shard_ids = [int(s) for s in shard_ids]
        if not shard_ids:
            return
        sizes = [self._manifest["shards"][s]["bytes"] for s in shard_ids]
        # consumer-side deadline (TPUFLOW_STORAGE_TIMEOUT_S, 0 = none):
        # the retried network layer underneath has its own per-attempt
        # deadline, so allow the full retry budget's worth of wall clock
        # before declaring the fetch wedged
        timeout_s = storage_timeout_s()
        fetch_timeout = (timeout_s * 8) if timeout_s > 0 else None
        pending = collections.deque()  # (shard_id, size, future)
        inflight = 0
        nxt = 0
        pool = ThreadPoolExecutor(max_workers=self._max_workers)
        wedged = False
        try:
            while pending or nxt < len(shard_ids):
                # top up: always at least one in flight; beyond that,
                # submit while the byte window has room
                while nxt < len(shard_ids) and (
                        not pending
                        or inflight + sizes[nxt] <= self._readahead):
                    sid = shard_ids[nxt]
                    pending.append(
                        (sid, sizes[nxt],
                         pool.submit(self._fetch, sid)))
                    inflight += sizes[nxt]
                    nxt += 1
                occ = min(1.0, inflight / float(self._readahead))
                with self._stats_lock:
                    self.stats["occupancy_sum"] += occ
                    self.stats["occupancy_samples"] += 1
                telemetry.gauge(
                    "data.readahead_occupancy", round(occ, 4),
                    data={"bytes": inflight, "shards": len(pending),
                          "window_bytes": self._readahead})
                sid, size, fut = pending.popleft()
                t0 = time.perf_counter()
                try:
                    tokens = fut.result(timeout=fetch_timeout)
                except FuturesTimeout:
                    wedged = True
                    raise TimeoutError(
                        "shard %d fetch exceeded %.1fs — wedged transfer "
                        "(TPUFLOW_STORAGE_TIMEOUT_S)"
                        % (sid, fetch_timeout))
                with self._stats_lock:
                    self.stats["wait_ms"] += (
                        time.perf_counter() - t0) * 1000
                inflight -= size
                yield sid, tokens
        finally:
            # an abandoned generator (consumer broke out early) exits
            # through GeneratorExit here: cancel the fetches still
            # queued behind the workers — the default pool shutdown
            # would WAIT for them, stalling teardown by up to a full
            # readahead window of downloads nobody will consume — then
            # wait out only the ≤max_workers already running. UNLESS a
            # fetch wedged past its deadline: then even the running
            # workers are unjoinable and the pool is abandoned outright
            # (the TimeoutError must reach the caller, not hang here)
            for _sid, _size, fut in pending:
                fut.cancel()
            pool.shutdown(wait=not wedged, cancel_futures=wedged)

    def mean_occupancy(self):
        n = self.stats["occupancy_samples"]
        return (self.stats["occupancy_sum"] / n) if n else 0.0
