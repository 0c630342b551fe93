"""Per-task artifact dictionary backed by the content-addressed store (the
JAX package's datastore/task_datastore.py).

Reference behavior: metaflow/datastore/task_datastore.py (TaskDataStore:93,
save_artifacts:379, load_artifacts:499, persist:880, done():796, clone:850).
Artifacts are serialized via the registry in serializers.py (tensors take
the raw-bytes tensor format) and stored deduplicated in the flow's CAS; per-task state
is a small JSON manifest mapping name → (content key, type tag).
"""

import json
import time
from functools import wraps

from .. import knobs, tracing
from ..exception import TpuFlowDataMissing, MetaflowInternalError
from . import serializers

MAX_ATTEMPTS = 6


def only_if_not_done(f):
    @wraps(f)
    def method(self, *args, **kwargs):
        if self._is_done_set:
            raise MetaflowInternalError(
                "Tried to write to datastore of %s after it was marked done"
                % self._path
            )
        return f(self, *args, **kwargs)

    return method


def require_mode(mode):
    def wrapper(f):
        @wraps(f)
        def method(self, *args, **kwargs):
            if mode is not None and self._mode != mode:
                raise MetaflowInternalError(
                    "%s requires mode %r (datastore is %r)"
                    % (f.__name__, mode, self._mode)
                )
            return f(self, *args, **kwargs)

        return method

    return wrapper


class TaskDataStore(object):
    METADATA_ATTEMPT_SUFFIX = "attempt.json"
    METADATA_DONE_SUFFIX = "DONE.lock"
    METADATA_DATA_SUFFIX = "artifacts.json"
    METADATA_USER_SUFFIX = "metadata.json"

    def __init__(
        self,
        flow_datastore,
        run_id,
        step_name,
        task_id,
        attempt=None,
        mode="r",
        allow_not_done=False,
    ):
        self._flow_datastore = flow_datastore
        self._ca_store = flow_datastore.ca_store
        self._storage = flow_datastore.storage
        self.run_id = str(run_id)
        self.step_name = step_name
        self.task_id = str(task_id)
        self._mode = mode
        self._attempt = attempt
        self._is_done_set = False
        self._objects = {}   # name -> content key
        self._info = {}      # name -> {"type_tag":..., "size":...}

        self._path = self._storage.path_join(
            flow_datastore.flow_name, self.run_id, step_name, self.task_id
        )

        if mode == "w":
            if attempt is None:
                raise MetaflowInternalError(
                    "'w' mode TaskDataStore requires an explicit attempt"
                )
        elif mode == "r":
            if attempt is None:
                # resolve the latest attempt (prefer DONE ones)
                self._attempt = self._latest_attempt(require_done=not allow_not_done)
            if self._attempt is not None:
                self._load_manifest()
        elif mode == "d":
            # data-check mode: look only at manifests
            if attempt is None:
                self._attempt = self._latest_attempt(require_done=not allow_not_done)
            if self._attempt is not None:
                self._load_manifest()
        else:
            raise MetaflowInternalError("Unknown datastore mode %r" % mode)

    # ---------- path & manifest helpers ----------

    @property
    def pathspec(self):
        return "/".join(
            (self._flow_datastore.flow_name, self.run_id, self.step_name, self.task_id)
        )

    @property
    def attempt(self):
        return self._attempt

    def _fname(self, suffix, attempt=None):
        a = self._attempt if attempt is None else attempt
        return self._storage.path_join(self._path, "%d.%s" % (a, suffix))

    def _latest_attempt(self, require_done=True):
        files = dict(self._storage.list_content([self._path]))
        attempts = []
        for path in files:
            base = self._storage.basename(path)
            parts = base.split(".", 1)
            if len(parts) != 2 or not parts[0].isdigit():
                continue
            attempt, suffix = int(parts[0]), parts[1]
            if suffix == self.METADATA_DONE_SUFFIX:
                attempts.append((attempt, True))
            elif suffix == self.METADATA_ATTEMPT_SUFFIX:
                attempts.append((attempt, False))
        done_attempts = [a for a, done in attempts if done]
        if done_attempts:
            return max(done_attempts)
        if not require_done and attempts:
            return max(a for a, _ in attempts)
        return None

    def _load_manifest(self):
        data = self._load_json(self._fname(self.METADATA_DATA_SUFFIX))
        if data:
            self._objects = data.get("objects", {})
            self._info = data.get("info", {})

    def _load_json(self, path):
        with self._storage.load_bytes([path]) as loaded:
            for _path, local, _meta in loaded:
                if local is None:
                    return None
                with open(local, "rb") as f:
                    return json.loads(f.read().decode("utf-8"))
        return None

    def _save_json(self, path, obj):
        blob = json.dumps(obj).encode("utf-8")
        self._storage.save_bytes([(path, blob)], overwrite=True)

    # ---------- write path ----------

    @only_if_not_done
    @require_mode("w")
    def init_task(self):
        """Mark this attempt as started."""
        self._save_json(
            self._fname(self.METADATA_ATTEMPT_SUFFIX),
            {"time": time.time(), "attempt": self._attempt},
        )

    @only_if_not_done
    @require_mode("w")
    def save_artifacts(self, artifacts_iter, pipelined=None):
        """Save {name: obj} pairs; dedup via CAS.

        pipelined=None (default) picks the overlapped persist pipeline
        (datastore/pipeline.py) for multi-artifact saves unless
        TPUFLOW_PERSIST_PIPELINE=0; both paths produce byte-identical
        CAS objects and manifests — the pipelined one overlaps
        device→host transfer + serialization with upload."""
        items = list(artifacts_iter)
        if pipelined is None:
            pipelined = (
                len(items) > 1
                and knobs.get_bool("TPUFLOW_PERSIST_PIPELINE")
            )
        with tracing.span(
            "persist.save_artifacts",
            {"task": self.pathspec, "artifacts": len(items),
             "pipelined": bool(pipelined)},
        ):
            if pipelined:
                from .pipeline import persist_pipeline

                for name, key, tag, size in persist_pipeline(
                    items, self._ca_store
                ):
                    self._objects[name] = key
                    self._info[name] = {"type_tag": tag, "size": size}
                return
            names, blobs, tags = [], [], []
            for name, obj in items:
                payload, tag = serializers.serialize(obj)
                names.append(name)
                blobs.append(payload)
                tags.append(tag)
            results = self._ca_store.save_blobs(blobs)
            for name, (uri, key), tag, blob in zip(
                names, results, tags, blobs
            ):
                self._objects[name] = key
                self._info[name] = {"type_tag": tag, "size": len(blob)}

    @only_if_not_done
    @require_mode("w")
    def persist(self, flow):
        """Persist all non-ephemeral attributes of a flow instance."""
        if flow._datastore:
            # carry forward upstream artifacts not redefined by this task
            self._objects.update(flow._datastore._objects)
            self._info.update(flow._datastore._info)
        to_save = []
        for name, value in flow.__dict__.items():
            if name in flow._EPHEMERAL:
                continue
            if name in ("_graph_info",):
                continue
            to_save.append((name, value))
        self.save_artifacts(to_save)

    @only_if_not_done
    @require_mode("w")
    def done(self):
        """Write the manifest and the DONE marker; freeze the datastore."""
        self._save_json(
            self._fname(self.METADATA_DATA_SUFFIX),
            {"objects": self._objects, "info": self._info},
        )
        self._save_json(
            self._fname(self.METADATA_DONE_SUFFIX), {"time": time.time()}
        )
        self._is_done_set = True

    @only_if_not_done
    @require_mode("w")
    def clone(self, origin):
        """Clone artifacts from another task datastore (resume fast path:
        only manifests are copied — CAS blobs are shared, zero data motion)."""
        self._objects = dict(origin._objects)
        self._info = dict(origin._info)

    @only_if_not_done
    @require_mode("w")
    def passdown_partial(self, origin, vars):
        for var in vars:
            if var in origin._objects:
                self._objects[var] = origin._objects[var]
                self._info[var] = origin._info[var]

    @only_if_not_done
    @require_mode("w")
    def save_metadata(self, contents):
        """Save {name: json-able} auxiliary metadata files for this attempt."""
        for name, obj in contents.items():
            self._save_json(self._fname(name + ".json"), obj)

    # ---------- read path ----------

    def is_done(self):
        if self._attempt is None:
            return False
        return self._storage.is_file(
            [self._fname(self.METADATA_DONE_SUFFIX)]
        )[0]

    def has_attempt(self):
        return self._attempt is not None

    def load_metadata(self, names):
        out = {}
        for name in names:
            out[name] = self._load_json(self._fname(name + ".json"))
        return out

    def load_artifacts(self, names):
        """Yield (name, obj) for requested artifact names."""
        names = list(names)  # callers may pass a generator; len() below
        keys = {}
        for name in names:
            if name not in self._objects:
                raise TpuFlowDataMissing(
                    "Artifact *%s* not found in task %s" % (name, self.pathspec)
                )
            keys.setdefault(self._objects[name], []).append(name)
        with tracing.span(
            "persist.load_artifacts",
            {"task": self.pathspec, "artifacts": len(names)},
        ):
            for key, blob in self._ca_store.load_blobs(list(keys)):
                for name in keys[key]:
                    yield name, serializers.deserialize(
                        blob, self._info[name]["type_tag"]
                    )

    def __contains__(self, name):
        return name in self._objects

    def __getitem__(self, name):
        _, obj = next(self.load_artifacts([name]))
        return obj

    def get(self, name, default=None):
        try:
            return self[name]
        except (TpuFlowDataMissing, KeyError):
            return default

    def keys(self):
        return self._objects.keys()

    def items(self):
        """Yield (name, content_key): identity comparison without loading."""
        return self._objects.items()

    def artifact_info(self, name):
        return self._info.get(name)

    @require_mode(None)
    def to_dict(self, show_private=False):
        names = [
            n for n in self._objects if show_private or not n.startswith("_")
        ]
        return dict(self.load_artifacts(names))

    # ---------- logs ----------

    def save_logs(self, logsource, contents):
        """contents: {logname ('stdout'/'stderr'): bytes}"""
        to_save = []
        for logname, data in contents.items():
            path = self._fname("%s_%s.log" % (logsource, logname))
            to_save.append((path, data))
        self._storage.save_bytes(iter(to_save), overwrite=True)

    def load_log_legacy(self, logsource, logname, attempt=None):
        path = self._fname("%s_%s.log" % (logsource, logname), attempt=attempt)
        with self._storage.load_bytes([path]) as loaded:
            for _p, local, _m in loaded:
                if local is None:
                    return b""
                with open(local, "rb") as f:
                    return f.read()
        return b""

    def __repr__(self):
        return "TaskDataStore(%s attempt=%s mode=%s)" % (
            self.pathspec,
            self._attempt,
            self._mode,
        )
