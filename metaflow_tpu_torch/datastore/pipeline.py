"""Pipelined artifact persist: overlap serialization with upload (the JAX
package's datastore/pipeline.py).

The serial persist path (TaskDataStore.save_artifacts → serializers →
ContentAddressedStore.save_blobs) serializes every artifact to bytes one
at a time — each a device→host copy plus a sha256/gzip pass — and only
then starts writing. This module is the overlapped version:

  stage 1 (worker pool)     serialize + hash + pack per artifact; the
                            device→host copy, sha256 and gzip release the
                            interpreter lock, so threads scale
  stage 2 (upload pool)     completed packed payloads stream into storage
                            in ready order — the write of artifact k
                            overlaps serialization of artifact k+1

Memory is bounded: packed payloads waiting for upload count against an
in-flight byte budget (TPUFLOW_PERSIST_INFLIGHT_MB, default 512), so a
task with 100 GB of artifacts never materializes the full set in RAM —
producers stall until the uploader drains. An oversized single artifact
(bigger than the whole budget) is admitted alone rather than deadlocking.

Equivalence guarantee: keys and packed bytes come from the SAME
ContentAddressedStore.pack_blob the serial path uses, and manifests are
assembled from the same (name → key/type_tag/size) tuples — the pipelined
and serial paths are byte-identical on storage. Any worker or upload
failure propagates to the caller; nothing is swallowed.
"""

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed

from .. import tracing
from .. import knobs
from . import serializers

DEFAULT_INFLIGHT_BYTES = 512 << 20
# serialize workers: hash/compress are the CPU cost and release the GIL;
# beyond ~8 threads the memory bus, not the GIL, is the limit
DEFAULT_WORKERS = min(8, max(2, os.cpu_count() or 2))
# upload workers: cross-object concurrency keeps the store busy
DEFAULT_UPLOADS = min(8, max(2, os.cpu_count() or 2))


class PipelineCancelled(Exception):
    """Raised inside stalled producers when the pipeline aborts."""


class _ByteBudget(object):
    """Counting semaphore in bytes with cancellation.

    acquire() admits when the budget has room — or unconditionally when
    nothing is in flight, so one oversized payload passes alone instead
    of deadlocking.
    """

    def __init__(self, cap):
        self._cap = cap
        self._used = 0
        self._cancelled = False
        self._cv = threading.Condition()

    def acquire(self, n):
        with self._cv:
            while (not self._cancelled and self._used
                   and self._used + n > self._cap):
                self._cv.wait()
            if self._cancelled:
                raise PipelineCancelled()
            self._used += n

    def release(self, n):
        with self._cv:
            self._used -= n
            self._cv.notify_all()

    def cancel(self):
        with self._cv:
            self._cancelled = True
            self._cv.notify_all()


_DONE = object()


def persist_pipeline(artifacts, ca_store, raw=False, workers=None,
                     upload_workers=None, max_inflight_bytes=None):
    """Persist [(name, obj)] pairs through `ca_store` with serialization
    overlapped against upload. Returns [(name, key, type_tag, size)] in
    input order — the tuples TaskDataStore records in its manifest.

    Raises the first error from any stage; on error the remaining work is
    cancelled (artifacts already uploaded stay in the CAS — harmless:
    content-addressed objects without a manifest reference are inert).
    """
    items = list(artifacts)
    if not items:
        return []
    workers = workers or knobs.get_int(
        "TPUFLOW_PERSIST_WORKERS", fallback=DEFAULT_WORKERS)
    upload_workers = upload_workers or knobs.get_int(
        "TPUFLOW_PERSIST_UPLOADS", fallback=DEFAULT_UPLOADS)
    cap = max_inflight_bytes or (
        knobs.get_int("TPUFLOW_PERSIST_INFLIGHT_MB") << 20
        or DEFAULT_INFLIGHT_BYTES)

    budget = _ByteBudget(cap)
    upload_q = queue.Queue()
    results = [None] * len(items)
    blob_cache = ca_store.blob_cache
    errors = []
    errors_lock = threading.Lock()

    def fail(ex):
        with errors_lock:
            errors.append(ex)
        budget.cancel()

    def serialize_one(idx):
        name, obj = items[idx]
        payload, tag = serializers.serialize(obj)
        size = len(payload)
        key, packed = ca_store.pack_blob(payload, raw=raw)
        if blob_cache is not None:
            # write-through before upload: a local reader that races the
            # upload hits disk; the sha-verified cache cannot serve torn
            # bytes
            blob_cache.store_key(key, payload)
        del payload
        budget.acquire(len(packed))
        return idx, name, key, packed, tag, size

    def uploader():
        # len_hint announces the FULL stream so a backend can tune for
        # cross-object concurrency even though each call carries one
        # object
        storage = ca_store.storage
        while True:
            entry = upload_q.get()
            if entry is _DONE:
                return
            idx, name, key, packed, tag, size = entry
            try:
                # overwrite=False: content-addressed ⇒ same key, same bytes
                storage.save_bytes(
                    iter([(ca_store.blob_path(key), packed)]),
                    overwrite=False, len_hint=len(items),
                )
                results[idx] = (name, key, tag, size)
            except BaseException as ex:
                fail(ex)
            finally:
                budget.release(len(packed))

    n_uploads = min(upload_workers, len(items))
    up_threads = [
        threading.Thread(target=uploader, name="persist-upload-%d" % i,
                         daemon=True)
        for i in range(n_uploads)
    ]
    for t in up_threads:
        t.start()
    with tracing.span("persist.pipeline",
                      {"artifacts": len(items), "workers": workers,
                       "upload_workers": n_uploads}):
        try:
            with ThreadPoolExecutor(
                max_workers=min(workers, len(items)),
                thread_name_prefix="persist-serialize",
            ) as pool:
                futs = [pool.submit(serialize_one, i)
                        for i in range(len(items))]
                for fut in as_completed(futs):
                    try:
                        entry = fut.result()
                    except PipelineCancelled:
                        continue  # secondary casualty of the real error
                    except BaseException as ex:
                        fail(ex)
                        for f in futs:
                            f.cancel()
                        continue
                    upload_q.put(entry)
        finally:
            for _ in up_threads:
                upload_q.put(_DONE)
            for t in up_threads:
                t.join()
    if errors:
        raise errors[0]
    return results
