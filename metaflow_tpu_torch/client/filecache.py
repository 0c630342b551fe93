"""Shared on-disk blob cache (LRU by atime, size-capped), the JAX package's
client/filecache.py.

Reference behavior: metaflow/client/filecache.py:44 — artifacts fetched from
remote storage are cached locally keyed by content hash; content addressing
makes entries immutable so invalidation is just eviction.

Beyond the reference this cache is shared read-through/write-through for
the whole datastore (FlowDataStore attaches it for remote storage): tasks
write artifacts through it on persist, and resumed/forked tasks plus
`load_artifacts` read locally-present keys from disk instead of the
remote store. The
`key_lock` hook gives the CAS in-flight dedup — N gang workers on one host
racing on the same blob serialize per key (fcntl across processes, a lock
table across threads) and N-1 of them resolve from the cache.
"""

import contextlib
import os
import tempfile
import threading

from .. import knobs


class FileCache(object):
    """Plugs into ContentAddressedStore.set_blob_cache."""

    def __init__(self, cache_dir=None, max_size=4 << 30):
        self._dir = cache_dir or knobs.get_str(
            "TPUFLOW_CLIENT_CACHE",
            fallback=os.path.join(tempfile.gettempdir(), "tpuflow_cache"),
        )
        self._max_size = max_size
        self._approx_total = None  # lazily initialized running size counter
        self._tlocks = {}  # key -> threading.RLock (in-process dedup)
        self._tlocks_mu = threading.Lock()
        self._held = {}  # key -> [fh|None, refcount] for reentrant flock
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, key):
        return os.path.join(self._dir, key[:2], key)

    def _thread_lock(self, key):
        with self._tlocks_mu:
            lk = self._tlocks.get(key)
            if lk is None:
                # bound the table: these locks only matter while a fetch
                # of that key is in flight — never drop entries whose
                # flock is currently held (self._held)
                if len(self._tlocks) > 4096:
                    self._tlocks = {k: v for k, v in self._tlocks.items()
                                    if k in self._held}
                lk = self._tlocks[key] = threading.RLock()
            return lk

    def key_lock(self, key):
        """Context manager serializing fetches of `key` across threads of
        this process AND across processes sharing the cache dir (fcntl).
        The CAS re-checks the cache under this lock, so concurrent gang
        workers download a missing blob once, not N times.

        REENTRANT per thread: load_blobs acquires every requested key's
        lock for the lifetime of its generator, so a consumer that
        triggers a nested load of an overlapping key from the same thread
        must not self-deadlock — the thread layer is an RLock and the
        flock layer refcounts (only the first acquire flocks, only the
        last release unlocks).

        BOUNDED, never deadlocking: both layers acquire with a timeout
        (LOCK_WAIT_SECS) and fall back to proceeding UNLOCKED on expiry.
        Nested loads across workers can order lock batches arbitrarily
        (per-call sorted order cannot rule out an A-B/B-A cycle between
        two generators' held sets), so an untimed flock could hang two
        gang workers forever; dedup is opportunistic — the worst case of
        the fallback is one duplicate download, kept correct by the
        sha-verified cache."""

        @contextlib.contextmanager
        def locked():
            rlock = self._thread_lock(key)
            if not rlock.acquire(timeout=self.LOCK_WAIT_SECS):
                yield  # degraded: duplicate download possible, no hang
                return
            try:
                # under the RLock this thread is the only one touching
                # self._held[key]
                entry = self._held.get(key)
                if entry is not None:
                    entry[1] += 1
                else:
                    entry = self._held[key] = [self._flock(key), 1]
                try:
                    yield
                finally:
                    entry[1] -= 1
                    if entry[1] == 0:
                        del self._held[key]
                        if entry[0] is not None:
                            entry[0].close()  # releases the flock
                            # unlink the sidecar so the cache dir doesn't
                            # grow one permanent file per key ever
                            # fetched. A waiter still holding the old
                            # inode's flock races a fresh opener onto a
                            # NEW inode — worst case one duplicate
                            # download (dedup is opportunistic; the
                            # sha-verified cache keeps it correct)
                            try:
                                os.unlink(self._path(key) + ".lock")
                            except OSError:
                                pass
            finally:
                rlock.release()

        return locked()

    # how long a fetch waits for another worker's in-flight download of
    # the same key before giving up on dedup and downloading itself
    LOCK_WAIT_SECS = 20.0

    def _flock(self, key):
        """Exclusive flock on the key's sidecar with a bounded wait;
        returns the open file handle, or None (degraded, no lock)."""
        import time

        path = self._path(key) + ".lock"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = open(path, "a+")
        except OSError:
            return None
        import fcntl

        deadline = time.monotonic() + self.LOCK_WAIT_SECS
        while True:
            try:
                fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
                return fh
            except OSError:
                if time.monotonic() >= deadline:
                    fh.close()
                    return None
                time.sleep(0.05)

    def load_key(self, key):
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        # the key IS the blob's sha256: verify before trusting — the cache
        # dir may be shared (e.g. /tmp), and these bytes feed pickle in
        # task processes. A mismatch (corruption or poisoning) is evicted
        # and treated as a miss.
        import hashlib

        if hashlib.sha256(data).hexdigest() != key:
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return data

    def store_key(self, key, blob):
        # a blob near the cache cap would evict everything else on store
        # and often itself too — pass it through uncached
        if len(blob) * 4 > self._max_size:
            return
        path = self._path(key)
        if os.path.exists(path):
            # content-addressed: same key ⇒ same bytes. Re-storing would
            # add zero real bytes but inflate the running size counter
            # into spurious full-dir eviction walks (retried tasks and
            # gang workers re-store the same artifact sets constantly)
            try:
                os.utime(path)  # LRU touch
            except OSError:
                pass
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            # pid AND thread id: the persist pipeline calls store_key
            # from concurrent serialize workers — a pid-only suffix lets
            # two same-key writers interleave on one tmp file
            tmp = path + ".tmp.%d.%d" % (os.getpid(),
                                         threading.get_ident())
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except OSError:
            return
        if self._approx_total is None:
            self._approx_total = self._scan_total()
        else:
            self._approx_total += len(blob)
        if self._approx_total > self._max_size:
            self._evict()

    @staticmethod
    def _is_blob(name):
        # .lock files must survive eviction (unlinking one out from under
        # a holder breaks the cross-process dedup) and .tmp.* are races
        # in progress; neither counts against the budget
        return not (name.endswith(".lock") or ".tmp." in name)

    def _scan_total(self):
        total = 0
        for dirpath, _dirs, files in os.walk(self._dir):
            for name in files:
                if not self._is_blob(name):
                    continue
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    continue
        return total

    # a .tmp.* older than this is an orphan from a crashed writer (the
    # normal preemption failure mode), not a write in flight
    STALE_TMP_SECS = 3600.0

    def _evict(self):
        import time

        entries = []
        total = 0
        stale_cutoff = time.time() - self.STALE_TMP_SECS
        for dirpath, _dirs, files in os.walk(self._dir):
            for name in files:
                full = os.path.join(dirpath, name)
                if not self._is_blob(name):
                    # reap orphaned tmp files from SIGKILLed writers so
                    # the dir can't grow unbounded outside the budget;
                    # fresh ones are writes in flight — leave them
                    if ".tmp." in name:
                        try:
                            if os.stat(full).st_mtime < stale_cutoff:
                                os.unlink(full)
                        except OSError:
                            pass
                    continue
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                entries.append((st.st_atime, st.st_size, full))
                total += st.st_size
        entries.sort()  # oldest atime first
        for _atime, size, full in entries:
            if total <= self._max_size:
                break
            try:
                os.unlink(full)
            except OSError:
                continue
            total -= size
        self._approx_total = total
