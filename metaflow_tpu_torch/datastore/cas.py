"""Content-addressed blob store: hash-keyed, de-duplicated, per-flow (the
JAX package's datastore/cas.py).

Reference behavior: metaflow/datastore/content_addressed_store.py
(ContentAddressedStore:11, _pack_v1:211/_unpack_v1:218), with:
  - SHA-256 instead of SHA-1;
  - per-blob compression as a *format tag*, so large tensor blobs skip
    gzip (the device-to-host-to-disk path stays memory-bandwidth bound,
    not CPU bound).
A blob's key and stored bytes are the JAX package's, so either package
reads what the other wrote.
"""

import gzip
import hashlib
import io
import os


class BlobCache(object):
    def load_key(self, key):
        return None

    def store_key(self, key, blob):
        pass

    def key_lock(self, key):
        """Context manager serializing fetches of one key across readers
        (in-flight dedup). The base cache does not dedup: concurrent
        fetchers proceed independently."""
        import contextlib

        return contextlib.nullcontext()


class _TaggedFileReader(object):
    """File-like that serves a pack-format tag byte, then the file —
    lets save_bytes stream a tagged blob without materializing it."""

    def __init__(self, path, tag):
        self._path = path
        self._tag = tag
        self._file = None

    def read(self, n=-1):
        if n == 0:
            return b""
        if self._file is None:
            self._file = open(self._path, "rb")
            if n is None or n < 0:
                return self._tag + self._file.read()
            return self._tag + self._file.read(max(0, n - len(self._tag)))
        return self._file.read(n)

    def close(self):
        if self._file is not None:
            self._file.close()


class ContentAddressedStore(object):
    # pack formats: first byte of the stored object selects the decoder
    FMT_RAW = b"0"      # raw bytes
    FMT_GZIP = b"1"     # gzip-compressed

    # blobs larger than this skip gzip (tensor data is incompressible and
    # gzip becomes the bottleneck at HBM-scale artifact sizes)
    COMPRESS_MAX = 8 * 1024 * 1024

    def __init__(self, prefix, storage):
        self._prefix = prefix
        self._storage = storage
        self._blob_cache = None

    def set_blob_cache(self, blob_cache):
        self._blob_cache = blob_cache

    @property
    def blob_cache(self):
        return self._blob_cache

    @property
    def storage(self):
        return self._storage

    def _path(self, key):
        return self._storage.path_join(self._prefix, key[:2], key)

    def blob_path(self, key):
        """Storage path of a content key (the persist pipeline streams
        packed blobs straight to storage under these paths)."""
        return self._path(key)

    # once a persist has streamed this much hash+gzip work, the REMAINING
    # blobs are packed on a thread pool (sha256 and zlib release the
    # interpreter lock; the JAX package forks workers here, which a task
    # holding a CUDA context must not). The prefix stays streaming so
    # small persists never buffer and big ones only materialize the
    # parallel tail.
    PARALLEL_PACK_MIN_BYTES = 8 << 20
    PARALLEL_PACK_MIN_BLOBS = 4
    PARALLEL_PACK_WORKERS = None  # None = min(8, cpu count)

    def pack_blob(self, blob, raw=False):
        """(sha256 hex key, packed bytes) for one blob — the SINGLE pack
        implementation, shared by the serial save path and the pipelined
        one so both produce byte-identical objects and keys."""
        sha = hashlib.sha256(blob).hexdigest()
        if raw or len(blob) > self.COMPRESS_MAX:
            packed = self.FMT_RAW + blob
        else:
            # mtime=0: gzip otherwise stamps wall-clock into the header,
            # making packed bytes non-reproducible — a CAS object's bytes
            # must be a pure function of its payload
            packed = self.FMT_GZIP + gzip.compress(blob, compresslevel=3,
                                                   mtime=0)
        return sha, packed

    _pack_blob = pack_blob

    def save_blobs(self, blob_iter, raw=False, len_hint=0, cacheable=True):
        """Save blobs; returns list of (uri, key) in input order.

        cacheable=False skips the blob-cache write-through (checkpoint
        snapshots use it: a superseded multi-GB checkpoint payload in
        the LRU cache would only evict the artifact blobs the cache
        exists for)."""
        # write-through happens INLINE at pack time: a resumed/forked
        # task on this host reads the artifact back from disk instead of
        # re-downloading, and no raw payload is pinned past its pack (the
        # streaming prefix keeps its one-blob-at-a-time memory profile)
        keep = cacheable and self._blob_cache is not None
        packed_all = []
        it = iter(blob_iter)
        count = 0
        total = 0
        tail = None
        for blob in it:
            count += 1
            total += len(blob)
            sha, packed = self._pack_blob(blob, raw)
            packed_all.append((sha, packed))
            if keep:
                self._blob_cache.store_key(sha, blob)
            if (count >= self.PARALLEL_PACK_MIN_BLOBS
                    and total >= self.PARALLEL_PACK_MIN_BYTES):
                tail = list(it)
                break
        if tail:
            from concurrent.futures import ThreadPoolExecutor

            workers = self.PARALLEL_PACK_WORKERS or min(
                8, os.cpu_count() or 1)
            with ThreadPoolExecutor(max_workers=workers) as pool:
                packed_tail = list(pool.map(
                    lambda b: self._pack_blob(b, raw), tail))
            if keep:
                # tail blobs are already materialized (tail list) — this
                # adds no pinning beyond the pre-existing parallel_map
                for (sha, _packed), blob in zip(packed_tail, tail):
                    self._blob_cache.store_key(sha, blob)
            packed_all.extend(packed_tail)
        results = []
        to_save = []
        for sha, packed in packed_all:
            path = self._path(sha)
            results.append((self._storage.full_uri(path), sha))
            to_save.append((path, packed))
        # overwrite=False: content-addressed ⇒ existing key has same bytes
        self._storage.save_bytes(iter(to_save), overwrite=False,
                                 len_hint=len(to_save))
        return results

    CHUNK = 1 << 20

    def save_file(self, path):
        """Stream one FILE into the store at bounded RSS: chunked SHA-256,
        then a tag-prefixed reader handed to the storage backend (local
        storage copies it file-to-file). Stored FMT_RAW — include
        payloads are arbitrary user data, often incompressible, and raw
        keeps the download side streamable too. Returns (uri, key)."""
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(self.CHUNK), b""):
                h.update(chunk)
        sha = h.hexdigest()
        storage_path = self._path(sha)
        self._storage.save_bytes(
            iter([(storage_path, _TaggedFileReader(path, self.FMT_RAW))]),
            overwrite=False, len_hint=1,
        )
        return self._storage.full_uri(storage_path), sha

    def open_blob_stream(self, key):
        """Context manager yielding a binary file object positioned at the
        blob's payload (pack tag consumed, gzip transparently wrapped) —
        the bounded-RSS read path for large raw blobs."""
        import contextlib

        @contextlib.contextmanager
        def opened():
            with self._storage.load_bytes([self._path(key)]) as loaded:
                for _path, local, _meta in loaded:
                    if local is None:
                        raise KeyError(
                            "Content-addressed blob %s not found in "
                            "datastore" % key
                        )
                    with open(local, "rb") as f:
                        fmt = f.read(1)
                        if fmt == self.FMT_RAW:
                            yield f
                        elif fmt == self.FMT_GZIP:
                            yield gzip.GzipFile(fileobj=f, mode="rb")
                        else:
                            # no tag byte: MIRROR _unpack's fallback —
                            # pre-tag-era blobs are whole-object gzip;
                            # only yield raw when it isn't gzip at all
                            f.seek(0)
                            gz = gzip.GzipFile(fileobj=f, mode="rb")
                            try:
                                gz.peek(1)
                                yield gz
                            except OSError:
                                f.seek(0)
                                yield f
                    return

        return opened()

    def load_blobs(self, keys, force_raw=False, missing_ok=False,
                   cacheable=True):
        """Yield (key, bytes) for each key (order not guaranteed).

        missing_ok=True skips absent keys instead of raising — for
        opportunistic prefetch, where a missing blob should surface (or
        not) at the actual read.

        cacheable=False reads THROUGH the cache (hits still served) but
        never stores into it — for one-shot multi-GB payloads (checkpoint
        restore) that would only evict the artifact blobs the LRU cache
        exists for. Also skips the key locks: without a store there is
        nothing for a deduped second reader to pick up."""
        remaining = []
        for key in keys:
            if self._blob_cache is not None:
                cached = self._blob_cache.load_key(key)
                if cached is not None:
                    yield key, cached
                    continue
            remaining.append(key)
        if not remaining:
            return
        for pair in self._fetch_blobs(remaining, missing_ok,
                                      cacheable=cacheable):
            yield pair

    def _fetch_blobs(self, keys, missing_ok, cacheable=True):
        """Fetch keys from storage with in-flight dedup: when the blob
        cache provides key locks (FileCache does), concurrent gang
        workers racing on the same keys serialize per key and all but the
        first fetcher resolve from the cache instead of re-downloading.
        Locks are taken in sorted key order, and the cache's key_lock is
        BOUNDED (times out into an unlocked fetch) — nested loads across
        workers can interleave lock batches in conflicting orders, so an
        untimed lock could cycle; a timeout costs at most one duplicate
        download, never a hang.

        Streaming: blobs yield ONE at a time (bulk data stages on disk
        via load_bytes), so peak RSS is one unpacked blob regardless of
        the artifact set size. The key locks consequently stay held
        while the consumer iterates — that can extend another worker's
        wait, but never beyond this reader's own load, and the
        alternative (buffering every blob to release locks early) trades
        a wait for an OOM."""
        cache = self._blob_cache if cacheable else None
        lock_fn = getattr(cache, "key_lock", None) if cache else None
        locks = []
        try:
            if lock_fn is not None:
                for key in sorted(set(keys)):
                    lk = lock_fn(key)
                    lk.__enter__()
                    locks.append(lk)
                # under the locks another worker may have landed the blob
                still = []
                for key in keys:
                    cached = cache.load_key(key)
                    if cached is not None:
                        yield key, cached
                    else:
                        still.append(key)
                keys = still
            if keys:
                paths = {self._path(k): k for k in keys}
                with self._storage.load_bytes(list(paths)) as loaded:
                    for path, local, _meta in loaded:
                        key = paths[path]
                        if local is None:
                            if missing_ok:
                                continue
                            raise KeyError(
                                "Content-addressed blob %s not found in "
                                "datastore" % key
                            )
                        with open(local, "rb") as f:
                            packed = f.read()
                        blob = self._unpack(packed)
                        if cache is not None:
                            cache.store_key(key, blob)
                        yield key, blob
        finally:
            for lk in reversed(locks):
                lk.__exit__(None, None, None)

    def blob_exists(self, keys):
        return self._storage.is_file([self._path(k) for k in keys])

    def _unpack(self, packed):
        fmt, payload = packed[:1], packed[1:]
        if fmt == self.FMT_RAW:
            return payload
        if fmt == self.FMT_GZIP:
            return gzip.decompress(payload)
        # backward-compatible fallback: whole object is gzip (no tag byte)
        try:
            return gzip.GzipFile(fileobj=io.BytesIO(packed)).read()
        except OSError:
            return packed
