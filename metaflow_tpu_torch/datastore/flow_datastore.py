"""Per-flow datastore: creates/finds TaskDataStores + raw data (code pkgs).

Reference behavior: metaflow/datastore/flow_datastore.py (FlowDataStore:13,
get_task_datastores:79 latest-attempt resolution, save_data:348).
"""

import os

from .. import knobs
from .cas import ContentAddressedStore
from .task_datastore import TaskDataStore


class FlowDataStore(object):
    def __init__(self, flow_name, storage_impl, ds_root=None,
                 blob_cache=None):
        """storage_impl: a DataStoreStorage subclass; ds_root overrides its
        configured root.

        blob_cache: None (default) auto-attaches the shared on-disk
        FileCache for REMOTE storage — tasks then write artifacts through
        the cache on persist and resumed/forked tasks + load_artifacts
        read locally-present keys from disk instead of the remote store, with
        in-flight dedup across gang workers on one host. Pass False to
        disable, or any BlobCache-shaped object to override.
        TPUFLOW_BLOB_CACHE=0 disables the auto-attach globally (local
        storage never attaches one: the datastore already IS local disk).
        """
        root = ds_root or storage_impl.get_datastore_root_from_config()
        self.flow_name = flow_name
        self.storage = storage_impl(root)
        self.ca_store = ContentAddressedStore(
            self.storage.path_join(flow_name, "data"), self.storage
        )
        if blob_cache is None:
            if (self.storage.TYPE != "local"
                    and knobs.get_bool("TPUFLOW_BLOB_CACHE")):
                from ..client.filecache import FileCache

                self.ca_store.set_blob_cache(FileCache())
        elif blob_cache is not False:
            self.ca_store.set_blob_cache(blob_cache)

    @property
    def ds_type(self):
        return self.storage.TYPE

    @property
    def ds_root(self):
        return self.storage.datastore_root

    def get_task_datastore(
        self,
        run_id,
        step_name,
        task_id,
        attempt=None,
        mode="r",
        allow_not_done=False,
    ):
        return TaskDataStore(
            self,
            run_id,
            step_name,
            task_id,
            attempt=attempt,
            mode=mode,
            allow_not_done=allow_not_done,
        )

    RUNSTATE_FILE = "_runstate.json"

    def save_runstate(self, run_id, snapshot):
        """Persist the scheduler's live-state snapshot for a run (the
        counterpart reader is load_runstate; see runtime._persist_runstate
        for the shape)."""
        import json

        path = self.storage.path_join(
            self.flow_name, str(run_id), self.RUNSTATE_FILE
        )
        self.storage.save_bytes(
            [(path, json.dumps(snapshot).encode("utf-8"))], overwrite=True
        )

    def load_runstate(self, run_id):
        """The latest scheduler snapshot for a run, or None."""
        import json

        path = self.storage.path_join(
            self.flow_name, str(run_id), self.RUNSTATE_FILE
        )
        with self.storage.load_bytes([path]) as loaded:
            for _key, local, _meta in loaded:
                if local:
                    with open(local) as f:
                        return json.load(f)
        return None

    def prefetch_task_artifacts(self, datastores, names=None,
                                max_bytes=256 << 20):
        """Warm the blob cache with the (requested) artifacts of many task
        datastores in ONE batched storage fetch.

        Reference behavior: metaflow/datastore/datastore_set.py — a join
        over N inputs otherwise issues N x M sequential blob gets; batching
        lets the storage backend parallelize, and the shared blob cache
        makes the per-name loads that follow pure disk hits.

        Opportunistic by design: blobs over the max_bytes budget (largest
        first) and missing blobs are skipped — a fat carried-forward
        artifact the join never reads must not be downloaded up front, and
        a genuinely missing one should fail (or not) at its actual read.
        No-op without a blob cache (local storage needs no prefetch).
        """
        if self.ca_store._blob_cache is None:
            return 0
        sizes = {}
        for ds in datastores:
            for name, key in ds.items():
                if names is None or name in names:
                    info = ds.artifact_info(name) or {}
                    sizes[key] = info.get("size", 0)
        budget = max_bytes
        keys = []
        for key, size in sorted(sizes.items(), key=lambda kv: kv[1]):
            if size > budget:
                break  # sorted ascending: everything after is bigger
            budget -= size
            keys.append(key)
        fetched = 0
        for _key, _blob in self.ca_store.load_blobs(keys, missing_ok=True):
            fetched += 1  # side effect: blob cache now holds the key
        return fetched

    def get_task_datastores(
        self, run_id=None, steps=None, pathspecs=None, allow_not_done=False
    ):
        """Return read-mode TaskDataStores for many tasks at once.

        Either (run_id, steps) — all tasks of those steps — or explicit
        pathspecs 'run/step/task'.
        """
        task_specs = []
        if pathspecs is not None:
            for ps in pathspecs:
                parts = ps.split("/")
                if len(parts) == 4:  # flow/run/step/task
                    parts = parts[1:]
                run, step, task = parts
                task_specs.append((run, step, task))
        else:
            steps = steps or self.list_steps(run_id)
            for step in steps:
                for task in self.list_tasks(run_id, step):
                    task_specs.append((run_id, step, task))
        out = []
        for run, step, task in task_specs:
            ds = self.get_task_datastore(
                run, step, task, mode="r", allow_not_done=allow_not_done
            )
            if ds.has_attempt():
                out.append(ds)
        return out

    # ---------- run/step/task listing (powers the local client) ----------

    def list_runs(self):
        out = []
        for path, is_file in self.storage.list_content([self.flow_name]):
            name = self.storage.basename(path)
            # 'data' is the CAS; 'checkpoints' is the @checkpoint
            # decorator's tree; '_'-prefixed dirs are flow-level state —
            # none is a run (gc would otherwise age them out as phantom
            # runs, and run listings would surface them)
            if (not is_file and name not in ("data", "checkpoints")
                    and not name.startswith("_")):
                out.append(name)
        return out

    def list_steps(self, run_id):
        prefix = self.storage.path_join(self.flow_name, str(run_id))
        return [
            self.storage.basename(p)
            for p, is_file in self.storage.list_content([prefix])
            if not is_file and not self.storage.basename(p).startswith("_")
        ]

    def list_tasks(self, run_id, step_name):
        prefix = self.storage.path_join(self.flow_name, str(run_id), step_name)
        return [
            self.storage.basename(p)
            for p, is_file in self.storage.list_content([prefix])
            if not is_file
        ]

    # ---------- raw data (code packages, include files) ----------

    def save_data(self, data_iter):
        """Save raw byte blobs (code packages, include files); returns
        [(uri, key)] in order. Keys are recorded in the flow's package
        registry so gc's mark phase keeps them live."""
        results = self.ca_store.save_blobs(data_iter, raw=True)
        self._register_data_keys([key for _uri, key in results])
        return results

    def _registry_path(self):
        return self.storage.path_join(self.flow_name, "_packages.json")

    def _registry_lock(self):
        """Exclusive lock for registry read-modify-write (local storage);
        remote stores get best-effort last-writer-wins."""
        import contextlib

        if self.ds_type != "local":
            return contextlib.nullcontext()

        import fcntl

        path = self.storage.full_uri(self._registry_path()) + ".lock"
        os.makedirs(os.path.dirname(path), exist_ok=True)

        @contextlib.contextmanager
        def locked():
            with open(path, "a+") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                yield

        return locked()

    def _read_registry(self):
        import json

        with self.storage.load_bytes([self._registry_path()]) as loaded:
            for _p, local, _m in loaded:
                if local is None:
                    return {}
                with open(local) as f:
                    data = json.load(f)
                    if isinstance(data, list):  # pre-timestamp format
                        return {k: 0 for k in data}
                    return data
        return {}

    def _write_registry(self, registry):
        import json

        self.storage.save_bytes(
            [(self._registry_path(),
              json.dumps(registry, sort_keys=True).encode("utf-8"))],
            overwrite=True,
        )

    def _register_data_keys(self, keys):
        import time

        with self._registry_lock():
            registry = self._read_registry()
            now = time.time()
            # refresh the timestamp on EVERY registration, including
            # dedup hits: gc's mark phase keeps keys newer than the
            # oldest kept run, so a payload re-included by a recent run
            # must carry that run's timestamp, not its first upload's.
            # Every call therefore rewrites the registry JSON — it is
            # small (one entry per code package) and registration is
            # once per run, not per artifact. max(): a clock-skewed
            # writer must never move a stamp backwards (the lock is
            # best-effort on remote stores) — that could expose a live
            # package to gc pruning.
            for key in keys:
                registry[key] = max(now, registry.get(key, 0))
            if keys:
                self._write_registry(registry)

    def registered_data_keys(self, newer_than=None):
        registry = self._read_registry()
        if newer_than is None:
            return sorted(registry)
        return sorted(k for k, ts in registry.items() if ts >= newer_than)

    def prune_registered_data_keys(self, older_than):
        """Drop registry entries older than the cutoff (gc of packages that
        belonged to deleted runs). Returns the dropped keys."""
        with self._registry_lock():
            registry = self._read_registry()
            dropped = [k for k, ts in registry.items() if ts < older_than]
            if dropped:
                self._write_registry(
                    {k: ts for k, ts in registry.items() if ts >= older_than}
                )
            return dropped

    def save_file(self, path):
        """Stream a file into the CAS at bounded RSS (IncludeFile upload
        path); registers the key for gc. Returns (uri, key)."""
        uri, key = self.ca_store.save_file(path)
        self._register_data_keys([key])
        return uri, key

    def open_data_stream(self, key):
        """Context manager yielding a readable binary stream over a raw
        data blob (IncludeFile download path, bounded RSS)."""
        return self.ca_store.open_blob_stream(key)

    def load_data(self, keys):
        return {k: blob for k, blob in self.ca_store.load_blobs(keys, force_raw=True)}
