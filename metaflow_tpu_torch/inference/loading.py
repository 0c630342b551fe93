"""Serve from a past run's @checkpoint without re-entering a flow (the JAX
package's inference/loading.py).

Training steps save model state through `current.checkpoint` (the pytree
blob format, into the run's datastore tree —
plugins/gpu/checkpoint_decorator.py). This is the read side for serving:
resolve a run through the client API, locate its checkpoint root, read
the pytree, hand it to the decode engine.
"""

import os

from ..exception import TpuFlowException


def _ds_root():
    from .. import metaflow_config as cfg

    if cfg.default_datastore() == "gs":
        raise NotImplementedError(
            "the gs datastore is not in the port yet: use the local "
            "datastore")
    return cfg.datastore_sysroot_local(), "local"


def _with_namespace(run_namespace, fn):
    from ..client import get_namespace, namespace

    saved = get_namespace()
    namespace(run_namespace)
    try:
        return fn()
    finally:
        namespace(saved)


def _latest_successful_run_id(flow_name, run_namespace):
    """Newest successful run id (lazy — stops at the first hit). Serving
    usually runs as a different identity than training, so the default
    looks across ALL namespaces (pass run_namespace='user:alice' etc. to
    narrow)."""
    from ..client import Flow

    def scan():
        for run in Flow(flow_name):
            if run.successful:
                return run.id
        return None

    return _with_namespace(run_namespace, scan)


def _origin_run_of(flow_name, run_id, run_namespace):
    """The origin run a resumed run cloned from, via task metadata
    ('origin-run-id' on re-executed tasks, 'origin-task' pathspecs on
    clones); None for a fresh run."""
    from ..client import Run

    def scan():
        try:
            run = Run("%s/%s" % (flow_name, run_id))
        except Exception:
            return None
        for step_obj in run:
            for task in step_obj:
                md = task.metadata_dict
                origin = md.get("origin-run-id")
                if origin:
                    return str(origin)
                origin_task = md.get("origin-task")
                if origin_task and origin_task.count("/") == 3:
                    return origin_task.split("/")[1]
        return None

    return _with_namespace(run_namespace, scan)


def _resolve_tree(run_root, ds_type, flow_name, run_id, step_name):
    """(step_name, missing_reason): auto-detect the checkpointing step."""
    if step_name is not None:
        return step_name, None
    if ds_type != "local":
        raise TpuFlowException(
            "step_name is required on non-local datastores (listing "
            "gs:// checkpoint trees is ambiguous)."
        )
    candidates = sorted(os.listdir(run_root)) if os.path.isdir(
        run_root) else []
    if len(candidates) == 1:
        return candidates[0], None
    if not candidates:
        return None, "no checkpoints"
    raise TpuFlowException(
        "Run %s/%s has %d checkpointing steps (%s); pass step_name "
        "explicitly." % (flow_name, run_id, len(candidates),
                         ", ".join(candidates))
    )


def load_run_checkpoint(flow_name, run_id=None, step_name=None,
                        scope="root", ckpt_step=None, like=None,
                        run_namespace=None):
    """Restore the pytree a past run checkpointed.

    flow_name: the flow whose run saved the checkpoint.
    run_id:    default = the newest successful run; when that run has no
               checkpoints of its own (resume clones the checkpointing
               step, writing nothing), the loader follows its recorded
               origin-run lineage back to the run that actually saved —
               it never falls through to unrelated older runs.
    step_name: the @checkpoint step; auto-detected when the run has
               exactly one checkpointing step.
    scope:     foreach-index path ('root' outside any foreach — the same
               scoping checkpoint_decorator writes).
    ckpt_step: which saved step to load (default: latest).
    like:      a live tree to copy the saved tensors into (same shapes
               and dtypes); without it the tensors load on the CPU.
    run_namespace: client namespace for the run scan (default: all
               namespaces — serving rarely shares the trainer's user tag).
    """
    from ..plugins.gpu.checkpoint_decorator import Checkpointer, _join

    ds_root, ds_type = _ds_root()
    if run_id is None:
        run_id = _latest_successful_run_id(flow_name, run_namespace)
        if run_id is None:
            raise TpuFlowException(
                "No successful run of %s to load a checkpoint from."
                % flow_name
            )
    # follow the resume lineage (bounded — cycles are impossible but a
    # corrupt metadata chain must not loop forever)
    tried = []
    rid = str(run_id)
    while rid and rid not in tried and len(tried) < 16:
        tried.append(rid)
        run_root = _join(ds_root, flow_name, "checkpoints", rid)
        step, missing = _resolve_tree(run_root, ds_type, flow_name, rid,
                                      step_name)
        if not missing:
            root = _join(run_root, step, scope)
            ckpt = Checkpointer(root)
            restored = ckpt.load(step=ckpt_step, like=like)
            if restored is not None:
                return restored
            if ckpt_step is not None and ckpt.list():
                # the run HAS a checkpoint tree but not this step: raise
                # rather than silently serving some other run's weights.
                # (An EMPTY tree — explicit step_name on a resumed run —
                # falls through to the origin lineage below.)
                raise TpuFlowException(
                    "Run %s/%s has checkpoints under %s but none for "
                    "ckpt_step=%r." % (flow_name, rid, root, ckpt_step)
                )
        rid = _origin_run_of(flow_name, rid, run_namespace)
    raise TpuFlowException(
        "No checkpoint found for %s (resume lineage tried: %s) — saved "
        "with current.checkpoint.save()?" % (flow_name, ", ".join(tried))
    )
