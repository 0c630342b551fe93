"""Async training checkpoints through a flow datastore's content-addressed
store: the JAX package's AsyncCheckpointManager for the port's train state.

`save(state, step)` blocks only for the device-to-host snapshot: every
tensor's copy into pinned host memory is issued first and the copies are
then waited for together, and the serialization, the blob write and the
manifest write run in a background thread, overlapping the steps that
follow.

Contract (the reference's):

  - `save(state, step)` returns once the snapshot is on the host. The
    caller may update its tensors in place right after (the trainer's
    step does): the background thread touches only the host copy.
  - One save is in flight at a time: `save` waits for the previous
    background write first.
  - A background failure is never lost: it re-raises at the next
    `save()`, `wait()` or `done()`.
  - The per-step manifest is written only after the blob is whole in the
    store. A crash mid-write leaves no manifest, so `restore()` sees the
    previous complete checkpoint.
  - `restore(like=live_state)` copies the restored tensors into the live
    ones (same tree, shapes and dtypes, checked), so a trainer resumes in
    the memory it was built in.

A sharded state (DTensor leaves, a trainer's on a mesh) is saved whole:
each leaf is all-gathered in turn, and only rank 0 of the group keeps the
host copy and writes the blob, so the file is the unsharded tree in the
reference's format and reads the same on any mesh or off one. Every rank
calls save(); wait() is then a barrier of the group, after which the
checkpoint is durable for every rank. Rank 0 holds the whole state on
the host while it writes (and keeps those pinned buffers for the next
save): the host needs the state's bytes free beside the serialized blob.
`restore(like=)` streams the blob one leaf at a time: each rank holds one
whole leaf on the host at once and keeps its blocks under the live
placements (another mesh than the saving one's, or ZeRO on where it was
off, included).

The datastore is duck-typed: anything with `.flow_name`, `.storage`
(`path_join`, `basename`, `save_bytes`, `load_bytes`, `list_content`,
`delete`) and `.ca_store` (`save_blobs`, `load_blobs`), such as the
workflow layer's FlowDataStore or datastore.LocalFlowDataStore. Blobs are
the JAX package's pytree format (datastore/serializers.py).
"""

import collections
import json
import threading
import time

import torch

from ..datastore import serializers

Checkpoint = collections.namedtuple("Checkpoint", ["state", "step", "extra"])


class AsyncCheckpointManager:
    """Checkpoints train states (nested dicts of tensors and scalars) into
    a flow datastore's content-addressed store.

    flow_datastore: see the module docstring.
    name: the stream's name, one manager per trainer; manifests live under
          <flow>/_checkpoints/<name>/step_<n>.json.
    keep: keep only the newest N manifests (None keeps all). Blobs stay in
          the store (content-addressed, shared).
    """

    def __init__(self, flow_datastore, name="default", keep=None):
        self._storage = flow_datastore.storage
        self._ca = flow_datastore.ca_store
        self._prefix = self._storage.path_join(
            flow_datastore.flow_name, "_checkpoints", name)
        self._keep = keep
        self._thread = None
        self._error = None
        self._lock = threading.Lock()
        # pinned host buffers of the last snapshot, by tree path: reused by
        # the next save, which starts only after the last write is done
        self._host = {}
        # the last save was of a sharded state: wait() ends with a barrier
        # of the group, so every rank sees the checkpoint rank 0 writes
        self._sharded = False
        # the last restore()'s Checkpoint: a trainer built with
        # make_trainer(checkpoint=...) reads the resumed step and the data
        # stream's stamp here
        self.last_restored = None

    # ---------- write path ----------

    def save(self, state, step, extra=None):
        """Snapshot `state` for logical `step` and return once the
        snapshot is on the host. `extra` (JSON-able, e.g. the data stream's
        resume stamp) rides in the manifest. Serialization and the writes
        happen in the background; their errors surface at the next
        save()/wait()/done(). A sharded state is gathered and written by
        rank 0 alone; every rank calls save()."""
        self.wait()  # one save in flight
        host, sharded = self._snapshot(state)
        self._sharded = sharded
        if sharded and not _writer():
            return
        t = threading.Thread(target=self._persist,
                             args=(host, int(step), extra),
                             name="ckpt-persist", daemon=True)
        with self._lock:
            self._thread = t
        t.start()

    def _snapshot(self, state):
        """(a host copy of `state`, whether it was sharded): every tensor
        copied into a pinned host buffer (a CPU tensor into a new one), all
        copies issued before any is waited for. A DTensor leaf is gathered
        whole first, and only the writing rank keeps its copy."""
        issued = []
        sharded = []
        keep = _writer()

        def copy(node, path):
            if isinstance(node, dict):
                return {k: copy(v, path + (k,)) for k, v in node.items()}
            if not isinstance(node, torch.Tensor):
                return node
            node = node.detach()
            if hasattr(node, "full_tensor"):
                sharded.append(path)
                node = node.full_tensor()
                if not keep:
                    return None
            if not node.is_cuda:
                return node.clone()
            buf = self._host.get(path)
            if buf is None or buf.shape != node.shape or \
                    buf.dtype != node.dtype:
                buf = torch.empty(node.shape, dtype=node.dtype,
                                  pin_memory=True)
                self._host[path] = buf
            buf.copy_(node, non_blocking=True)
            issued.append(node.device)
            return buf

        with torch.no_grad():
            host = copy(state, ())
        for device in set(issued):
            torch.cuda.current_stream(device).synchronize()
        return host, bool(sharded)

    def _persist(self, host_state, step, extra):
        try:
            payload, tag = serializers.serialize(host_state)
            [(_uri, key)] = self._ca.save_blobs([payload], cacheable=False)
            manifest = {"step": step, "key": key, "type_tag": tag,
                        "size": len(payload), "time": time.time()}
            if extra is not None:
                manifest["extra"] = extra
            # manifest last: its existence asserts the blob is whole
            self._storage.save_bytes(
                [(self._manifest_path(step),
                  json.dumps(manifest).encode("utf-8"))], overwrite=True)
            self._prune(keep_step=step)
        except BaseException as ex:  # re-raised in the caller's thread
            with self._lock:
                self._error = ex

    def wait(self):
        """Block until the in-flight write (if any) ends; re-raise its
        error. After wait() returns, the last save is durable (after a
        sharded save, for every rank of the group: each must call
        wait())."""
        self._join()
        if self._sharded:
            self._sharded = False
            import torch.distributed as dist

            dist.barrier()
        self._raise_pending()

    def _join(self):
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()
            with self._lock:
                if self._thread is t:
                    self._thread = None

    def done(self):
        """Non-blocking: True when no write is in flight. Re-raises a
        background failure."""
        self._raise_pending()
        with self._lock:
            t = self._thread
        if t is not None and t.is_alive():
            return False
        self._join()
        self._raise_pending()
        return True

    def _raise_pending(self):
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    def _prune(self, keep_step):
        if not self._keep:
            return
        steps = self.steps()
        # never prune the step just written, whatever the listing says
        stale = [s for s in steps if s != keep_step][
            :max(0, len(steps) - self._keep)]
        if stale:
            self._storage.delete([self._manifest_path(s) for s in stale])

    # ---------- read path ----------

    def _manifest_path(self, step):
        return self._storage.path_join(self._prefix, "step_%d.json" % step)

    def steps(self):
        """Sorted steps with complete checkpoints (manifest present)."""
        out = []
        for path, is_file in self._storage.list_content([self._prefix]):
            name = self._storage.basename(path)
            if is_file and name.startswith("step_") and \
                    name.endswith(".json") and name[5:-5].isdigit():
                out.append(int(name[5:-5]))
        return sorted(out)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step=None, like=None):
        """Load checkpoint `step` (default: the latest complete one) as a
        Checkpoint(state, step, extra), or None when there is none. The
        state's tensors are CPU tensors; with `like` (a live state of the
        same tree) they are copied into like's tensors, which the returned
        state then holds, and its scalars (counts, the step) are the
        restored ones. A DTensor of `like` gets this rank's block of the
        restored tensor under its own placements. After a sharded save,
        every rank waits for it (wait()) first."""
        if self._sharded:
            self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        manifest = self._load_manifest(step)
        if manifest is None:
            return None
        if like is not None and manifest["type_tag"] == \
                serializers.TYPE_PYTREE:
            # one leaf on the host at a time, copied (a DTensor: its
            # block) into the live state before the next is read; the
            # tree, shapes and dtypes checked before any is
            with self._ca.open_blob_stream(manifest["key"]) as f:
                _check_like(serializers.pytree_skeleton(f), like, step)
            with self._ca.open_blob_stream(manifest["key"]) as f:
                state = serializers.read_pytree(f, like=like, put=_put)
        else:
            state = None
            for _key, blob in self._ca.load_blobs([manifest["key"]],
                                                  cacheable=False):
                state = serializers.deserialize(blob, manifest["type_tag"])
            if like is not None:
                _check_like(state, like, step)
                state = _copy_into(state, like)
        ck = Checkpoint(state, manifest["step"], manifest.get("extra"))
        self.last_restored = ck
        return ck

    def _load_manifest(self, step):
        with self._storage.load_bytes([self._manifest_path(step)]) as loaded:
            for _path, local, _meta in loaded:
                if local is None:
                    return None
                with open(local, "rb") as f:
                    return json.loads(f.read().decode("utf-8"))
        return None


def _paths(tree, prefix=()):
    """{path: leaf} of a nested dict."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_paths(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def _check_like(state, like, step):
    """Refuse a restore onto a live state of another tree, shape or dtype.
    A tree that differs most likely comes from another optimizer (the
    opt_state trees of AdamW and Adafactor differ), so say so."""
    saved, live = _paths(state), _paths(like)
    if set(saved) != set(live):
        only = lambda a, b: sorted("/".join(p) for p in set(a) - set(b))[:6]
        raise ValueError(
            "checkpoint step %s does not match the live state tree: only "
            "saved %s, only live %s. Most likely the checkpoint was saved "
            "under a different optimizer (or model) than this trainer was "
            "built with; rebuild the trainer with the original optimizer, "
            "or start a fresh run for the new one."
            % (step, only(saved, live), only(live, saved)))
    for path, want in live.items():
        got = saved[path]
        if isinstance(want, torch.Tensor) != isinstance(got, torch.Tensor) \
                or isinstance(want, torch.Tensor) and (
                    got.shape != want.shape or got.dtype != want.dtype):
            describe = lambda t: ("%s%s" % (t.dtype, tuple(t.shape))
                                  if isinstance(t, torch.Tensor)
                                  else type(t).__name__)
            raise ValueError(
                "checkpoint step %s: %s is %s in the checkpoint and %s in "
                "the live state (another model config or dtype?)"
                % (step, "/".join(path), describe(got), describe(want)))


@torch.no_grad()
def _copy_into(state, like):
    """like's tree with each tensor overwritten by the restored one (a
    DTensor's local block by its block of it), and the restored
    scalars."""
    if isinstance(like, dict):
        return {k: _copy_into(state[k], v) for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        _put(like, state)
        return like
    return state


def _put(live, restored):
    """Copy a restored whole tensor into a live one; a DTensor's local
    block takes its block of it."""
    if hasattr(live, "to_local"):
        from .train_step import reshard_like

        live.to_local().copy_(reshard_like(restored, live).to_local())
    else:
        live.copy_(restored)


def _writer():
    """Whether this process writes a sharded state's checkpoint: rank 0 of
    the group, or a process outside any group."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0
