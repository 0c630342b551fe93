"""Local JSON metadata provider.

Reference behavior: metaflow/plugins/metadata_providers/local.py:19 — metadata
lives as JSON files inside the local datastore tree, task listing is a
directory scan. Layout (under TPUFLOW root):

  <flow>/<run>/_run.json                    run registration + tags
  <flow>/<run>/_heartbeat.json              run heartbeat
  <flow>/<run>/<step>/<task>/_task.json     task registration
  <flow>/<run>/<step>/<task>/_metadata.json list of MetaDatum dicts
"""

import fcntl
import json
import os
import time

from ..util import get_tpuflow_root, get_username, write_latest_run_id
from .metadata import MetadataProvider, timestamp_millis


class LocalMetadataProvider(MetadataProvider):
    TYPE = "local"

    def __init__(self, environment=None, flow=None, event_logger=None, monitor=None,
                 root=None):
        super().__init__(environment, flow, event_logger, monitor)
        self._root = root or get_tpuflow_root()
        self._sticky_tags = set()
        self._sticky_sys_tags = set()

    @classmethod
    def compute_info(cls, val):
        return val

    def add_sticky_tags(self, tags=None, sys_tags=None):
        self._sticky_tags.update(tags or [])
        self._sticky_sys_tags.update(sys_tags or [])

    # ---------- helpers ----------

    def _run_dir(self, run_id, flow_name=None):
        return os.path.join(self._root, flow_name or self.flow_name, str(run_id))

    def _task_dir(self, run_id, step_name, task_id, flow_name=None):
        return os.path.join(self._run_dir(run_id, flow_name), step_name, str(task_id))

    @staticmethod
    def _write_json(path, obj):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)

    @staticmethod
    def _read_json(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (IOError, ValueError):
            return None

    # ---------- write side ----------

    def new_run_id(self, tags=None, sys_tags=None):
        # time-ordered numeric ids; a lock file serializes concurrent starts
        flow_dir = os.path.join(self._root, self.flow_name)
        os.makedirs(flow_dir, exist_ok=True)
        lock_path = os.path.join(flow_dir, ".run_id_lock")
        with open(lock_path, "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            run_id = str(timestamp_millis())
            while os.path.exists(os.path.join(flow_dir, run_id)):
                run_id = str(int(run_id) + 1)
            os.makedirs(os.path.join(flow_dir, run_id), exist_ok=True)
        self.register_run_id(run_id, tags, sys_tags)
        return run_id

    def register_run_id(self, run_id, tags=None, sys_tags=None):
        path = os.path.join(self._run_dir(run_id), "_run.json")
        if self._read_json(path) is not None:
            return False
        self._write_json(
            path,
            {
                "flow_id": self.flow_name,
                "run_number": str(run_id),
                "user": get_username(),
                "tags": sorted(set(tags or []) | self._sticky_tags),
                "system_tags": sorted(
                    set(sys_tags or []) | self._sticky_sys_tags
                ),
                "ts_epoch": timestamp_millis(),
            },
        )
        if not str(run_id).startswith("spin-"):
            write_latest_run_id(self.flow_name, run_id, root=self._root)
        return True

    def new_task_id(self, run_id, step_name, tags=None, sys_tags=None):
        # task ids are assigned by the runtime's in-process counter; for
        # standalone `step` invocations generate a time-based id
        task_id = str(timestamp_millis())
        self.register_task_id(run_id, step_name, task_id, 0, tags, sys_tags)
        return task_id

    def register_task_id(self, run_id, step_name, task_id, attempt=0,
                         tags=None, sys_tags=None):
        path = os.path.join(self._task_dir(run_id, step_name, task_id), "_task.json")
        existing = self._read_json(path)
        if existing is None:
            self._write_json(
                path,
                {
                    "flow_id": self.flow_name,
                    "run_number": str(run_id),
                    "step_name": step_name,
                    "task_id": str(task_id),
                    "attempt": attempt,
                    "tags": sorted(set(tags or []) | self._sticky_tags),
                    "system_tags": sorted(
                        set(sys_tags or []) | self._sticky_sys_tags
                    ),
                    "ts_epoch": timestamp_millis(),
                },
            )

    def register_metadata(self, run_id, step_name, task_id, metadata):
        """Append MetaDatum records to the task's metadata list."""
        path = os.path.join(
            self._task_dir(run_id, step_name, task_id), "_metadata.json"
        )
        os.makedirs(os.path.dirname(path), exist_ok=True)
        records = [
            {
                "field_name": m.field,
                "value": m.value,
                "type": m.type,
                "tags": list(m.tags or []),
                "ts_epoch": timestamp_millis(),
            }
            for m in metadata
        ]
        # append under an exclusive lock: task + runtime may both write
        lock_path = path + ".lock"
        with open(lock_path, "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            existing = self._read_json(path) or []
            existing.extend(records)
            self._write_json(path, existing)

    # ---------- heartbeats (file mtime = liveness) ----------

    def start_run_heartbeat(self, flow_id, run_id):
        self._heartbeat_path = os.path.join(
            self._run_dir(run_id, flow_id), "_heartbeat.json"
        )
        self._beat()

    def start_task_heartbeat(self, flow_id, run_id, step_id, task_id):
        self._heartbeat_path = os.path.join(
            self._task_dir(run_id, step_id, task_id, flow_id), "_heartbeat.json"
        )
        self._beat()

    def _beat(self):
        try:
            self._write_json(self._heartbeat_path, {"ts": time.time()})
        except (OSError, AttributeError):
            pass

    def heartbeat(self):
        self._beat()

    # ---------- read side ----------

    def get_run_info(self, flow_name, run_id):
        return self._read_json(
            os.path.join(self._root, flow_name, str(run_id), "_run.json")
        )

    def list_runs(self, flow_name):
        flow_dir = os.path.join(self._root, flow_name)
        if not os.path.isdir(flow_dir):
            return []
        runs = []
        for name in os.listdir(flow_dir):
            info = self.get_run_info(flow_name, name)
            if info is not None:
                runs.append(info)
        runs.sort(key=lambda r: r.get("ts_epoch", 0), reverse=True)
        return runs

    def get_task_info(self, flow_name, run_id, step_name, task_id):
        return self._read_json(
            os.path.join(
                self._task_dir(run_id, step_name, task_id, flow_name), "_task.json"
            )
        )

    def get_task_metadata(self, flow_name, run_id, step_name, task_id):
        return (
            self._read_json(
                os.path.join(
                    self._task_dir(run_id, step_name, task_id, flow_name),
                    "_metadata.json",
                )
            )
            or []
        )

    def task_heartbeat_age(self, flow_name, run_id, step_name, task_id):
        path = os.path.join(
            self._task_dir(run_id, step_name, task_id, flow_name),
            "_heartbeat.json",
        )
        try:
            return time.time() - os.path.getmtime(path)
        except OSError:
            return None

    def mutate_run_tags(self, flow_name, run_id, add=None, remove=None):
        """Optimistic tag mutation under the run lock."""
        path = os.path.join(self._root, flow_name, str(run_id), "_run.json")
        if not os.path.exists(path):
            return None
        lock_path = path + ".lock"
        with open(lock_path, "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            info = self._read_json(path)
            if info is None:
                return None
            tags = set(info.get("tags", []))
            # removals BEFORE additions so replace_tag(x, x) keeps x
            tags -= set(remove or [])
            tags |= set(add or [])
            info["tags"] = sorted(tags)
            self._write_json(path, info)
            return info
