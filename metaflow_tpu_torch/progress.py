"""Per-rank progress beats: the liveness signal heartbeats cannot give.

The port's copy of the JAX package's progress module (the parts a train
loop calls). A progress beat is stamped from the MAIN thread at each unit
of real forward progress (a train step), so a rank wedged in a stuck
collective or a deadlocked read lets it go stale while a thread-driven
heartbeat stays fresh: the HUNG signature a gang watchdog keys on.

Each beat atomically rewrites `_progress.json` in the rank's own task
directory (`<root>/<flow>/<run>/<step>/<task>`):

    {ts, step_num, pid, rank, attempt, phase, deadline_s, done}

The task computes its OWN deadline, `max(floor, mult × step-time EMA)`,
with a much larger grace while a compile (for the port: the first build
or load of a kernel library) is still possible, because only the task
knows its step cadence; the watchdog compares `now - ts > deadline_s`. A
terminal `done()` beat tells the watchdog to stop watching. Beats carry
the attempt number so a retried attempt never inherits a stale file.

The module-level `beat` and `done` find the ambient task as the JAX
package's do, through the flow runtime (`current`); a caller running
outside a flow can name a task with `set_task`, which takes precedence.
Outside a task they are no-ops, as they are in the JAX package outside a
flow.
"""

import json
import os
import time

from . import knobs

PROGRESS_FILE = "_progress.json"

BEAT_EVERY_ENV = "TPUFLOW_PROGRESS_EVERY_S"      # write throttle
FLOOR_ENV = "TPUFLOW_HANG_FLOOR_S"               # deadline floor
MULT_ENV = "TPUFLOW_HANG_DEADLINE_MULT"          # k in max(floor, k*EMA)
COMPILE_GRACE_ENV = "TPUFLOW_HANG_COMPILE_GRACE_S"


def get_tpuflow_root():
    """Root directory of the local datastore and metadata tree:
    TPUFLOW_DATASTORE_SYSROOT_LOCAL, else ./.tpuflow (the JAX package's
    default)."""
    return (knobs.get_str("TPUFLOW_DATASTORE_SYSROOT_LOCAL")
            or os.path.join(os.getcwd(), ".tpuflow"))


def task_dir(root, flow_name, run_id, step_name, task_id):
    return os.path.join(
        root, flow_name, str(run_id), step_name, str(task_id))


def progress_path(root, flow_name, run_id, step_name, task_id):
    return os.path.join(
        task_dir(root, flow_name, run_id, step_name, task_id),
        PROGRESS_FILE)


def read_progress(root, flow_name, run_id, step_name, task_id):
    """The rank's latest beat dict, or None (never beaten / unreadable)."""
    try:
        with open(progress_path(root, flow_name, run_id, step_name,
                                task_id)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def hang_deadline_s(ema_s=None, compile_possible=False):
    """The adaptive progress deadline: max(floor, mult × EMA), swapped
    for the (much larger) compile grace while a compile could still be
    in flight — a compile is only seen AFTER the step returns, so the
    suspension must be prospective."""
    floor = knobs.get_float(FLOOR_ENV)
    if compile_possible:
        return max(floor, knobs.get_float(COMPILE_GRACE_ENV))
    if ema_s:
        return max(floor, knobs.get_float(MULT_ENV) * ema_s)
    return floor


class ProgressBeater(object):
    """Throttled atomic writer of one rank's `_progress.json`."""

    def __init__(self, path, rank=0, attempt=0, every_s=None):
        self.path = path
        self.rank = int(rank)
        self.attempt = int(attempt)
        self.every_s = (knobs.get_float(BEAT_EVERY_ENV)
                        if every_s is None else float(every_s))
        self._last_write = 0.0

    def beat(self, step_num=None, phase="progress", deadline_s=None,
             done=False):
        now = time.time()
        if not done and now - self._last_write < self.every_s:
            return
        payload = {
            "ts": now,
            "step_num": step_num,
            "pid": os.getpid(),
            "rank": self.rank,
            "attempt": self.attempt,
            "phase": phase,
            "deadline_s": (hang_deadline_s() if deadline_s is None
                           else float(deadline_s)),
            "done": bool(done),
        }
        tmp = "%s.%d" % (self.path, os.getpid())
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, self.path)
        except OSError:
            return
        self._last_write = now

    def done(self, step_num=None, phase="done"):
        """Terminal beat: 'stop watching me' — never throttled."""
        self.beat(step_num=step_num, phase=phase, done=True)


# ---------------------------------------------------------------------------
# module-level API bound to the task named by set_task
# ---------------------------------------------------------------------------

_task = None  # (flow_name, run_id, step_name, task_id, attempt, rank, root)
_beater = None
_beater_key = None


def set_task(flow_name, run_id, step_name, task_id, attempt=0, rank=None,
             root=None):
    """Bind the module-level beats to one task attempt. rank defaults to
    MF_PARALLEL_NODE_INDEX (0), root to get_tpuflow_root()."""
    global _task
    if rank is None:
        rank = int(os.environ.get("MF_PARALLEL_NODE_INDEX", "0"))
    _task = (flow_name, str(run_id), step_name, str(task_id), int(attempt),
             int(rank), root)


def clear_task():
    global _task, _beater, _beater_key
    _task = _beater = _beater_key = None


def _ambient_task():
    """The task named by set_task, else the running flow task's identity
    from `current`, else None."""
    if _task is not None:
        return _task
    from .current import current

    if not current.is_running_flow:
        return None
    return (current.flow_name, str(current.run_id), current.step_name,
            str(current.task_id), int(current.retry_count or 0),
            int(os.environ.get("MF_PARALLEL_NODE_INDEX", "0")), None)


def _current_beater():
    """The process's ProgressBeater for the ambient task, or None outside
    one. Re-resolved when the task identity (or the process) changes."""
    global _beater, _beater_key
    task = _ambient_task()
    if task is None:
        return None
    key = task + (os.getpid(),)
    if _beater is None or _beater_key != key:
        flow_name, run_id, step_name, task_id, attempt, rank, root = task
        path = progress_path(root or get_tpuflow_root(), flow_name, run_id,
                             step_name, task_id)
        _beater = ProgressBeater(path, rank=rank, attempt=attempt)
        _beater_key = key
    return _beater


def beat(step_num=None, phase="progress", deadline_s=None):
    """Generic progress beat: call once per unit of real progress. No-op
    outside a task."""
    b = _current_beater()
    if b is not None:
        b.beat(step_num=step_num, phase=phase, deadline_s=deadline_s)


def done(step_num=None):
    """Mark this rank's loop complete: the watchdog stops watching."""
    b = _current_beater()
    if b is not None:
        b.done(step_num=step_num)


def finish():
    """Task-exit hook: a terminal beat IF this process ever beat. Tasks
    that never reported progress (join steps, plain steps) never get a
    progress file at all."""
    if _beater is not None:
        _beater.done()
