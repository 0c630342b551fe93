"""@checkpoint: within-step model checkpointing, the port's counterpart of
the JAX package's plugins/tpu/checkpoint_decorator.py.

`current.checkpoint` saves and loads pytrees (model and optimizer state:
dicts, lists and tuples of tensors and scalars) into the run's datastore
tree, scoped so that

  - a task retry (same run/step/task, higher attempt) sees prior
    checkpoints;
  - `resume` of a failed run can load the origin run's checkpoints
    (load_origin=True, the default).

Where the JAX package writes an orbax checkpoint directory, the port
writes one file in the pytree blob format (datastore/serializers.py, the
format of the port's training checkpoints), streamed one tensor at a
time: `<ds_root>/<flow>/checkpoints/<run>/<step>/<scope>/step_<n>/
checkpoint.pytree`. A save lands in a temporary directory that is renamed
into place whole, so a listing never sees a partial checkpoint.
"""

import os
import shutil

from ... import tracing
from ...current import current
from ...datastore import serializers
from ...decorators import StepDecorator

CHECKPOINT_FILE = "checkpoint.pytree"


def _refuse_remote(root):
    if root.startswith("gs://"):
        raise NotImplementedError(
            "checkpoints on a gs datastore (%s) are not in the port yet: "
            "use the local datastore" % (root,))


class Checkpointer(object):
    """Exposed as `current.checkpoint`."""

    def __init__(self, root, origin_root=None):
        self._root = root
        self._origin_root = origin_root

    def directory(self, step=None):
        return os.path.join(self._root,
                            "step_%d" % step if step is not None else "")

    def list(self, root=None):
        root = root or self._root
        _refuse_remote(root)
        if not os.path.isdir(root):
            return []
        steps = []
        for name in os.listdir(root):
            if name.startswith("step_") and name[5:].isdigit():
                steps.append(int(name[5:]))
        return sorted(steps)

    def save(self, state, step=0):
        """Save a pytree checkpoint for logical step `step` (an existing
        one of that step is replaced). Returns its directory."""
        _refuse_remote(self._root)
        path = os.path.join(self._root, "step_%d" % step)
        tmp = os.path.join(self._root, ".step_%d.tmp-%d" % (step, os.getpid()))
        # the span lands in the run's flight recorder, where the goodput
        # ledger books it as checkpoint_blocked time
        with tracing.span("checkpoint.snapshot", {"step": int(step)}):
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            with open(os.path.join(tmp, CHECKPOINT_FILE), "wb") as f:
                serializers.write_pytree(state, f)
            if os.path.isdir(path):
                old = tmp + ".old"
                os.rename(path, old)
                os.rename(tmp, path)
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.rename(tmp, path)
        return path

    def load(self, step=None, like=None):
        """Load a checkpoint: `step` or the latest. Falls back to the origin
        run's checkpoints under `resume`. Returns None when none exist.
        Tensors come back on the CPU; with `like` (a live tree with a
        tensor at every saved tensor's position) they are copied into the
        live tensors, which the returned tree holds."""
        for root in (self._root, self._origin_root):
            if not root:
                continue
            steps = self.list(root)
            if not steps:
                continue
            chosen = step if step is not None else steps[-1]
            if chosen not in steps:
                continue
            path = os.path.join(root, "step_%d" % chosen, CHECKPOINT_FILE)
            # restore time is part of the run's recovery cost: the
            # goodput ledger books it under restore_replay
            with tracing.span("checkpoint.restore", {"step": int(chosen)}):
                with open(path, "rb") as f:
                    return serializers.read_pytree(f, like=like)
        return None

    @property
    def latest_step(self):
        steps = self.list()
        if steps:
            return steps[-1]
        if self._origin_root:
            steps = self.list(self._origin_root)
            if steps:
                return steps[-1]
        return None


class CheckpointDecorator(StepDecorator):
    """@checkpoint — activates `current.checkpoint` for the step."""

    name = "checkpoint"
    defaults = {"load_origin": True}

    def task_pre_step(self, step_name, task_datastore, metadata, run_id,
                      task_id, flow, graph, retry_count, max_user_code_retries,
                      ubf_context, inputs):
        ds_root = task_datastore._flow_datastore.ds_root
        flow_name = task_datastore._flow_datastore.flow_name
        # scope = step + foreach-index path (NOT task id): retries share it,
        # and `resume` finds the origin run's checkpoints even though the
        # re-executed task gets a fresh task id
        # exclude gang frames (var == _parallel_ubf_iter): every rank of a
        # gang shares ONE checkpoint root
        stack = [
            frame for frame in (getattr(flow, "_foreach_stack", None) or [])
            if frame[0] != "_parallel_ubf_iter"
        ]
        scope = "-".join(str(int(frame[1])) for frame in stack) or "root"
        root = _join(ds_root, flow_name, "checkpoints", str(run_id), step_name,
                     scope)
        origin_root = None
        origin_run = current.origin_run_id
        if self.attributes.get("load_origin", True) and origin_run:
            origin_root = _join(
                ds_root, flow_name, "checkpoints", str(origin_run), step_name,
                scope,
            )
        current._update_env({"checkpoint": Checkpointer(root, origin_root)})


def _join(root, *parts):
    if root.startswith("gs://"):
        return "/".join([root.rstrip("/")] + list(parts))
    return os.path.join(root, *parts)
