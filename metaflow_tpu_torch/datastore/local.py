"""A flow datastore on a local directory, with the interface the port's
checkpoint manager (training/checkpoint.py), flight recorder
(telemetry.py) and streamed corpus (data/) speak: `.flow_name`,
`.storage`, `.ca_store` and `save_data`. A flow step hands them the
run's own FlowDataStore instead; this one serves runs outside a flow.

The layout is the JAX package's local datastore's: files under
<root>/<path>, blobs in a content-addressed store under
<root>/<flow>/data/<key[:2]>/<key>, each a one-byte tag (b"0" raw, b"1"
gzip) and the payload, keyed by the payload's sha256. So either package's
FlowDataStore over the same root reads what the other wrote.
"""

import contextlib
import fcntl
import gzip
import hashlib
import json
import os
import tempfile
import time


class LocalStorage:
    """Byte storage under a root directory; paths are relative to it."""

    def __init__(self, root):
        self.datastore_root = root

    def full_uri(self, path):
        return os.path.join(self.datastore_root, path)

    def path_join(self, *components):
        return os.path.join(*components)

    def basename(self, path):
        return os.path.basename(path)

    def list_content(self, paths):
        """(path, is_file) of each entry one level under each path."""
        out = []
        for path in paths:
            full = self.full_uri(path)
            if os.path.isdir(full):
                for name in sorted(os.listdir(full)):
                    child = os.path.join(path, name)
                    out.append((child, os.path.isfile(self.full_uri(child))))
        return out

    def save_bytes(self, path_and_bytes_iter, overwrite=False, len_hint=0):
        """Write each (path, bytes) pair, or (path, (bytes, metadata)), to
        a temporary file renamed into place, so a reader never sees a
        partial file. An existing file stays unless `overwrite`."""
        del len_hint
        for path, payload in path_and_bytes_iter:
            data = payload[0] if isinstance(payload, tuple) else payload
            full = self.full_uri(path)
            if os.path.exists(full) and not overwrite:
                continue
            os.makedirs(os.path.dirname(full), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(full))
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, full)
            except BaseException:
                os.unlink(tmp)
                raise

    @contextlib.contextmanager
    def load_bytes(self, paths):
        """Yields an iterator of (path, local file or None, None)."""
        yield ((p, self.full_uri(p) if os.path.isfile(self.full_uri(p))
                else None, None) for p in paths)

    def delete(self, paths):
        for path in paths:
            with contextlib.suppress(FileNotFoundError):
                os.unlink(self.full_uri(path))


class ContentAddressedStore:
    """Blobs keyed by their sha256 under `prefix` of `storage`."""

    FMT_RAW = b"0"
    FMT_GZIP = b"1"

    def __init__(self, prefix, storage):
        self._prefix = prefix
        self._storage = storage

    @property
    def storage(self):
        return self._storage

    @property
    def blob_cache(self):
        """No local blob cache: the blobs already live on local disk."""
        return None

    def _path(self, key):
        return self._storage.path_join(self._prefix, key[:2], key)

    def blob_path(self, key):
        """Storage path of a content key."""
        return self._path(key)

    def _unpack(self, packed):
        fmt, payload = packed[:1], packed[1:]
        if fmt == self.FMT_GZIP:
            return gzip.decompress(payload)
        if fmt != self.FMT_RAW:
            raise ValueError("blob has unknown tag %r" % fmt)
        return payload

    def save_blobs(self, blob_iter, raw=False, len_hint=0, cacheable=True):
        """Store each blob (raw: checkpoint blobs are tensors, which do
        not compress); returns [(uri, key)] in order."""
        del raw, len_hint, cacheable
        out, writes = [], []
        for blob in blob_iter:
            key = hashlib.sha256(blob).hexdigest()
            path = self._path(key)
            out.append((self._storage.full_uri(path), key))
            writes.append((path, self.FMT_RAW + blob))
        self._storage.save_bytes(writes, overwrite=False)
        return out

    def load_blobs(self, keys, force_raw=False, missing_ok=False,
                   cacheable=True):
        """Yield (key, blob) for each key; a missing key raises KeyError
        unless missing_ok."""
        del force_raw, cacheable
        paths = {self._path(k): k for k in keys}
        with self._storage.load_bytes(list(paths)) as loaded:
            for path, local, _meta in loaded:
                if local is None:
                    if missing_ok:
                        continue
                    raise KeyError("blob %s not found in the datastore"
                                   % paths[path])
                with open(local, "rb") as f:
                    packed = f.read()
                try:
                    payload = self._unpack(packed)
                except ValueError:
                    raise ValueError("blob %s has unknown tag %r"
                                     % (paths[path], packed[:1]))
                yield paths[path], payload


class LocalFlowDataStore:
    """`flow_name`, `storage`, `ca_store` and `save_data` of one flow
    under `root`."""

    def __init__(self, flow_name, root):
        self.flow_name = flow_name
        self.storage = LocalStorage(root)
        self.ca_store = ContentAddressedStore(
            self.storage.path_join(flow_name, "data"), self.storage)

    def save_data(self, data_iter):
        """Save raw byte blobs (e.g. corpus shards); returns [(uri, key)]
        in order. The keys are recorded in the flow's package registry
        (`<flow>/_packages.json`, key -> newest registration time), so
        the JAX package's gc keeps them live."""
        results = self.ca_store.save_blobs(data_iter, raw=True)
        self._register_data_keys([key for _uri, key in results])
        return results

    def _registry_path(self):
        return self.storage.path_join(self.flow_name, "_packages.json")

    def _register_data_keys(self, keys):
        if not keys:
            return
        path = self.storage.full_uri(self._registry_path())
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".lock", "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            registry = {}
            with self.storage.load_bytes([self._registry_path()]) as loaded:
                for _p, local, _m in loaded:
                    if local is not None:
                        with open(local) as f:
                            registry = json.load(f)
            if isinstance(registry, list):  # the pre-timestamp format
                registry = {k: 0 for k in registry}
            now = time.time()
            # max(): a stamp never moves backwards
            for key in keys:
                registry[key] = max(now, registry.get(key, 0))
            self.storage.save_bytes(
                [(self._registry_path(),
                  json.dumps(registry, sort_keys=True).encode("utf-8"))],
                overwrite=True)
