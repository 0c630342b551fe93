"""Client (inspection) API: Metaflow → Flow → Run → Step → Task → DataArtifact
(the JAX package's client). Tensor artifacts load as CPU tensors.

Reference behavior: metaflow/client/core.py (object hierarchy, namespace
filtering `namespace():154`, `Run.data`, `Task.artifacts`). Reads go through
the same FlowDataStore/metadata providers the runtime writes with.
"""

import json
import os

from ..datastore import FlowDataStore, LocalStorage, STORAGE_BACKENDS
from ..exception import (
    MetaflowNamespaceMismatch,
    MetaflowNotFound,
    MetaflowTaggingError,
)
from ..metadata import LocalMetadataProvider
from ..util import get_tpuflow_root, get_username

_current_namespace = None
_namespace_initialized = False


def default_namespace():
    global _current_namespace, _namespace_initialized
    _current_namespace = "user:%s" % get_username()
    _namespace_initialized = True
    return _current_namespace


def namespace(ns):
    """Set the global namespace filter; None disables filtering."""
    global _current_namespace, _namespace_initialized
    _current_namespace = ns
    _namespace_initialized = True
    return _current_namespace


def get_namespace():
    if not _namespace_initialized:
        default_namespace()
    return _current_namespace


def _metadata_provider():
    from ..metaflow_config import default_metadata

    if default_metadata() == "service":
        raise NotImplementedError(
            "the metadata service provider is not in the port yet: use "
            "the local metadata")
    return LocalMetadataProvider()


def _flow_datastore(flow_name):
    from ..metaflow_config import default_datastore

    ds_type = default_datastore()
    # FlowDataStore auto-attaches the shared on-disk blob cache for
    # remote storage (read-through for the client, write-through for
    # tasks) — no client-side special case needed anymore
    return FlowDataStore(flow_name, STORAGE_BACKENDS[ds_type])


class MetaflowObject(object):
    _NAME = "base"

    def __init__(self, pathspec=None, _namespace_check=True):
        self.pathspec = pathspec
        self._check_ns = _namespace_check

    def _check_namespace(self, tags):
        ns = get_namespace()
        if ns is None or not self._check_ns:
            return
        if ns not in tags:
            raise MetaflowNamespaceMismatch(ns)

    def __repr__(self):
        return "%s('%s')" % (self.__class__.__name__, self.pathspec)

    def __eq__(self, other):
        return (
            isinstance(other, self.__class__) and self.pathspec == other.pathspec
        )

    def __hash__(self):
        return hash((self.__class__.__name__, self.pathspec))


class Metaflow(object):
    """Entry point: all flows in the datastore."""

    @property
    def flows(self):
        root = get_tpuflow_root()
        if not os.path.isdir(root):
            return []
        out = []
        for name in sorted(os.listdir(root)):
            if os.path.isdir(os.path.join(root, name)):
                try:
                    out.append(Flow(name))
                except (MetaflowNotFound, MetaflowNamespaceMismatch):
                    pass
        return out

    def __iter__(self):
        return iter(self.flows)

    def __repr__(self):
        return "Metaflow()"


class Flow(MetaflowObject):
    _NAME = "flow"

    def __init__(self, name, _namespace_check=True):
        super().__init__(name, _namespace_check)
        self.id = name
        root = os.path.join(get_tpuflow_root(), name)
        if not os.path.isdir(root):
            raise MetaflowNotFound("Flow *%s* does not exist" % name)

    @property
    def runs(self):
        return list(self)

    def __iter__(self):
        meta = _metadata_provider()
        for info in meta.list_runs(self.id):
            try:
                yield Run(
                    "%s/%s" % (self.id, info["run_number"]),
                    _namespace_check=self._check_ns,
                )
            except MetaflowNamespaceMismatch:
                continue

    @property
    def latest_run(self):
        for run in self:
            return run
        return None

    @property
    def latest_successful_run(self):
        for run in self:
            if run.successful:
                return run
        return None

    def __getitem__(self, run_id):
        return Run("%s/%s" % (self.id, run_id), _namespace_check=self._check_ns)


class Run(MetaflowObject):
    _NAME = "run"

    def __init__(self, pathspec, _namespace_check=True):
        super().__init__(pathspec, _namespace_check)
        parts = pathspec.split("/")
        if len(parts) != 2:
            raise MetaflowNotFound("Specify a run as FlowName/run_id")
        self.flow_name, self.id = parts
        self._meta = _metadata_provider()
        info = self._meta.get_run_info(self.flow_name, self.id)
        if info is None:
            raise MetaflowNotFound("Run *%s* does not exist" % pathspec)
        self._info = info
        self._check_namespace(
            set(info.get("tags", [])) | set(info.get("system_tags", []))
        )
        self._ds = _flow_datastore(self.flow_name)

    @property
    def tags(self):
        return frozenset(self._info.get("tags", []))

    @property
    def system_tags(self):
        return frozenset(self._info.get("system_tags", []))

    # ---- tag mutation (reference: client/core.py Run.add_tag region) ----
    # same optimistic-concurrency provider path as the `tag` CLI, so
    # client and CLI mutations compose safely under concurrency

    def _mutate_tags(self, add=(), remove=()):
        add, remove = list(add), list(remove)  # generators: consume once
        for t in add + remove:
            if not isinstance(t, str):
                raise MetaflowTaggingError(
                    "Tags must be strings, got %r" % (t,)
                )
        info = self._meta.mutate_run_tags(
            self.flow_name, self.id, add=add, remove=remove
        )
        if info is None:
            raise MetaflowNotFound(
                "Run %s/%s disappeared while mutating tags"
                % (self.flow_name, self.id)
            )
        self._info = info
        return self.tags

    def add_tag(self, tag):
        """Add one user tag to this run."""
        return self._mutate_tags(add=[tag])

    def add_tags(self, tags):
        """Add several user tags to this run."""
        return self._mutate_tags(add=tags)

    def remove_tag(self, tag):
        """Remove one user tag from this run."""
        return self._mutate_tags(remove=[tag])

    def remove_tags(self, tags):
        """Remove several user tags from this run."""
        return self._mutate_tags(remove=tags)

    def replace_tag(self, tag_to_remove, tag_to_add):
        """Atomically swap one tag for another (one provider round-trip,
        so concurrent mutators never observe the intermediate state)."""
        return self._mutate_tags(add=[tag_to_add], remove=[tag_to_remove])

    def replace_tags(self, tags_to_remove, tags_to_add):
        """Atomically swap several tags."""
        return self._mutate_tags(add=tags_to_add, remove=tags_to_remove)

    @property
    def created_at(self):
        return self._info.get("ts_epoch")

    def steps(self):
        for name in self._ds.list_steps(self.id):
            yield Step("%s/%s/%s" % (self.flow_name, self.id, name),
                       _namespace_check=False)

    def __iter__(self):
        return self.steps()

    def __getitem__(self, step_name):
        if step_name not in self._ds.list_steps(self.id):
            raise MetaflowNotFound(
                "Step *%s* does not exist in run %s" % (step_name, self.pathspec)
            )
        return Step("%s/%s/%s" % (self.flow_name, self.id, step_name),
                    _namespace_check=False)

    @property
    def finished(self):
        try:
            return self["end"].task.finished
        except MetaflowNotFound:
            return False

    @property
    def successful(self):
        return self.finished

    @property
    def data(self):
        """Artifacts of the end task (the run's final state)."""
        try:
            return self["end"].task.data
        except MetaflowNotFound:
            return None

    def end_task(self):
        try:
            return self["end"].task
        except MetaflowNotFound:
            return None

    def lineage_index(self):
        """Reverse input-paths index: parent pathspec → [child pathspecs].
        Built in ONE pass over the run's task metadata (cached per Run)."""
        if getattr(self, "_lineage_index", None) is not None:
            return self._lineage_index
        index = {}
        meta = _metadata_provider()
        for step_name in self._ds.list_steps(self.id):
            for task_id in self._ds.list_tasks(self.id, step_name):
                records = meta.get_task_metadata(
                    self.flow_name, self.id, step_name, task_id
                )
                child = "%s/%s/%s" % (self.id, step_name, task_id)
                for m in records:
                    if m.get("field_name") == "input-paths":
                        for parent in json.loads(m["value"]):
                            index.setdefault(parent, []).append(child)
        self._lineage_index = index
        return index


class Step(MetaflowObject):
    _NAME = "step"

    def __init__(self, pathspec, _namespace_check=True):
        super().__init__(pathspec, _namespace_check)
        self.flow_name, self.run_id, self.id = pathspec.split("/")
        self._ds = _flow_datastore(self.flow_name)

    def tasks(self):
        for task_id in sorted(self._ds.list_tasks(self.run_id, self.id)):
            yield Task("%s/%s/%s/%s"
                       % (self.flow_name, self.run_id, self.id, task_id),
                       _namespace_check=False)

    def __iter__(self):
        return self.tasks()

    def __getitem__(self, task_id):
        return Task("%s/%s/%s/%s"
                    % (self.flow_name, self.run_id, self.id, task_id),
                    _namespace_check=False)

    @property
    def task(self):
        """Any one task of this step (the only one, for non-foreach steps)."""
        for task in self.tasks():
            return task
        raise MetaflowNotFound("Step %s has no tasks" % self.pathspec)

    @property
    def finished_at(self):
        return max((t.finished_at or 0) for t in self.tasks())

    @property
    def environment_info(self):
        return {}


class MetaflowData(object):
    """Attribute-style view over a task's artifacts."""

    def __init__(self, artifacts):
        self._artifacts = artifacts

    def __getattr__(self, name):
        arts = object.__getattribute__(self, "_artifacts")
        if name in arts:
            return arts[name].data
        raise AttributeError("No artifact '%s'" % name)

    def __contains__(self, var):
        return var in self._artifacts

    def _asdict(self):
        return {k: v.data for k, v in self._artifacts.items()}

    def __repr__(self):
        return "<MetaflowData: %s>" % ", ".join(sorted(self._artifacts))


class Task(MetaflowObject):
    _NAME = "task"

    def __init__(self, pathspec, _namespace_check=True):
        super().__init__(pathspec, _namespace_check)
        self.flow_name, self.run_id, self.step_name, self.id = pathspec.split("/")
        self._flow_ds = _flow_datastore(self.flow_name)
        self._task_ds = self._flow_ds.get_task_datastore(
            self.run_id, self.step_name, self.id, allow_not_done=True
        )
        if not self._task_ds.has_attempt():
            raise MetaflowNotFound("Task *%s* does not exist" % pathspec)

    @property
    def current_attempt(self):
        return self._task_ds.attempt

    @property
    def finished(self):
        return self._task_ds.is_done()

    @property
    def successful(self):
        meta = _metadata_provider().get_task_metadata(
            self.flow_name, self.run_id, self.step_name, self.id
        )
        oks = [
            m for m in meta if m.get("field_name") == "attempt_ok"
        ]
        if oks:
            try:
                return json.loads(oks[-1]["value"]) is True
            except (ValueError, TypeError):
                return False
        return self.finished

    @property
    def finished_at(self):
        meta = _metadata_provider().get_task_metadata(
            self.flow_name, self.run_id, self.step_name, self.id
        )
        ts = [m.get("ts_epoch") for m in meta if m.get("ts_epoch")]
        return max(ts) if ts else None

    @property
    def exception(self):
        ds = self._task_ds
        return ds.get("_exception_str")

    @property
    def artifacts(self):
        return MetaflowData(
            {
                name: DataArtifact(
                    "%s/%s" % (self.pathspec, name), _task_ds=self._task_ds
                )
                for name in self._task_ds.keys()
                if not name.startswith("_")
            }
        )

    @property
    def data(self):
        return self.artifacts

    def __getitem__(self, name):
        return DataArtifact("%s/%s" % (self.pathspec, name),
                            _task_ds=self._task_ds)

    def __iter__(self):
        for name in self._task_ds.keys():
            if not name.startswith("_"):
                yield self[name]

    @property
    def metadata_dict(self):
        meta = _metadata_provider().get_task_metadata(
            self.flow_name, self.run_id, self.step_name, self.id
        )
        return {m["field_name"]: m["value"] for m in meta}

    @property
    def index(self):
        stack = self._task_ds.get("_foreach_stack")
        if stack:
            return stack[-1][1]
        return None

    @property
    def stdout(self):
        return self._load_log("stdout")

    @property
    def stderr(self):
        return self._load_log("stderr")

    def _load_log(self, name):
        from .. import mflog

        data = self._task_ds.load_log_legacy("runtime", name)
        return mflog.format_merged([data]).decode("utf-8", errors="replace")

    @property
    def parent_tasks(self):
        meta = self.metadata_dict
        paths = meta.get("input-paths")
        if not paths:
            return []
        return [
            Task("%s/%s" % (self.flow_name, p), _namespace_check=False)
            for p in json.loads(paths)
        ]

    @property
    def child_tasks(self):
        """Tasks of this run whose recorded input-paths include this task.

        One metadata pass over the run per call; to traverse lineage for
        MANY tasks, build `Run.lineage_index()` once instead."""
        run = Run("%s/%s" % (self.flow_name, self.run_id),
                  _namespace_check=False)
        me = "%s/%s/%s" % (self.run_id, self.step_name, self.id)
        index = run.lineage_index()
        return [
            Task("%s/%s" % (self.flow_name, child), _namespace_check=False)
            for child in index.get(me, [])
        ]


class DataArtifact(MetaflowObject):
    _NAME = "artifact"

    def __init__(self, pathspec, _namespace_check=True, _task_ds=None):
        super().__init__(pathspec, _namespace_check)
        parts = pathspec.split("/")
        self.flow_name, self.run_id, self.step_name, self.task_id, self.id = parts
        if _task_ds is None:
            _task_ds = _flow_datastore(self.flow_name).get_task_datastore(
                self.run_id, self.step_name, self.task_id
            )
        self._task_ds = _task_ds
        if self.id not in self._task_ds:
            raise MetaflowNotFound("Artifact *%s* does not exist" % pathspec)

    @property
    def data(self):
        return self._task_ds[self.id]

    @property
    def size(self):
        info = self._task_ds.artifact_info(self.id)
        return info.get("size") if info else None

    @property
    def sha(self):
        return self._task_ds._objects.get(self.id)
