"""Spot/preemption handling: monitor sidecar + in-task graceful handler (the
JAX package's plugins/tpu/preemption.py).

Preemptible (spot) capacity is common for accelerator fleets, so preemption
is a first-class event here, not an afterthought:

  - `PreemptionMonitor` (run as `python -m
    metaflow_tpu_torch.plugins.gpu.preemption`, started by @gpu(spot=True))
    polls the GCE metadata server's
    preemption endpoint (the reference polls EC2 IMDS the same way,
    metaflow/plugins/aws/batch/spot_monitor_sidecar.py:12-16) and, when the
    VM is marked for preemption, SIGTERMs the task process — turning the
    platform's ~30s warning into a catchable in-process event.

  - `PreemptionHandler` (installed in the task process) converts SIGTERM
    into a `TaskPreempted` exception raised in the main thread, giving the
    step its normal failure path: the attempt is recorded as failed and
    retryable, and a `@checkpoint`-enabled step resumes from its last saved
    state on the next attempt. User code can defer the raise across
    critical sections with `current.preemption.shield()` (e.g. while a
    checkpoint is written) or poll `current.preemption.requested` in a
    training loop to checkpoint-then-exit at a step boundary.

Gang semantics: any preempted rank fails its process; the control task's
reaper tears down the remaining ranks (parallel_decorator teardown), the
attempt fails, and the scheduler's retry relaunches the WHOLE gang — which
re-forms its process group and resumes from the shared checkpoint root
(checkpoint scope excludes the gang frame precisely so all ranks of every
attempt share one root).
"""

import contextlib
import json
import os
import signal
import sys
import tempfile
import threading
import time

from ... import knobs
from ...exception import TaskPreempted

# GCE metadata: TRUE once the VM is scheduled for preemption
DEFAULT_METADATA_URL = (
    "http://metadata.google.internal/computeMetadata/v1/instance/preempted"
)
POLL_SECS = 5.0

# a notice marker older than this is STALE: the process it was meant for
# died before handling SIGTERM and the PID was recycled — a later task
# reusing the PID must read a routine teardown, not a spot notice
MARKER_TTL_S = 900.0


def _notice_marker(pid):
    return os.path.join(tempfile.gettempdir(), "tpuflow-preempted-%d" % pid)


def _read_marker(path):
    """(ts, kind) of a notice marker; (None, None) when unreadable.
    Accepts both the JSON form written today and the legacy bare-float
    form, so an in-flight upgrade never misclassifies a live notice."""
    try:
        with open(path) as f:
            body = f.read().strip()
    except OSError:
        return None, None
    try:
        obj = json.loads(body)
        if isinstance(obj, dict):
            return float(obj.get("ts", 0)), str(obj.get("kind", "spot"))
        return float(obj), "spot"
    except (ValueError, TypeError):
        return None, None


def notify_preemption(pid, kind="spot"):
    """Deliver a preemption notice to a task process: drop the marker file
    (distinguishes a real spot reclaim from a routine teardown SIGTERM, e.g.
    the gang control terminating workers after a rank-0 failure), then
    SIGTERM it. The marker is timestamped so a stale leftover (task died
    before handling SIGTERM, PID recycled) is ignored by the next reader;
    a notice raced against process exit is cleaned up here immediately —
    a FRESH marker for a pid that is already gone would otherwise hand a
    recycled pid a notice meant for its predecessor."""
    marker = _notice_marker(pid)
    with open(marker, "w") as f:
        f.write(json.dumps({"ts": time.time(), "kind": kind}))
    try:
        os.kill(pid, signal.SIGTERM)
    except ProcessLookupError:
        try:
            os.unlink(marker)
        except OSError:
            pass
        raise


class PreemptionHandler(object):
    """In-task SIGTERM → TaskPreempted bridge. Exposed as
    `current.preemption`."""

    def __init__(self, marker_ttl_s=None):
        self.requested = threading.Event()
        # True when the SIGTERM was a real spot notice (fresh monitor
        # marker) rather than a teardown kill
        self.spot_notice = False
        self._marker_ttl_s = (
            marker_ttl_s if marker_ttl_s is not None
            else knobs.get_float("TPUFLOW_SPOT_MARKER_TTL_S"))
        self._shield_depth = 0
        self._pending_exc = None
        self._prev_handler = None
        self._installed = False

    def install(self):
        if self._installed or threading.current_thread() is not threading.main_thread():
            return self
        self._prev_handler = signal.signal(signal.SIGTERM, self._on_sigterm)
        self._installed = True
        return self

    def uninstall(self):
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev_handler or signal.SIG_DFL)
            self._installed = False
        # never leave a marker behind for a recycled PID to misread: a
        # notice that arrives between here and process exit is a routine
        # teardown as far as the NEXT process with this PID is concerned
        try:
            os.unlink(_notice_marker(os.getpid()))
        except OSError:
            pass

    def _consume_marker(self):
        """Read-and-clear this PID's notice marker; returns its kind or
        None when absent or STALE (written for an earlier process that
        died before handling SIGTERM — PID reuse must not turn a routine
        teardown into a spot notice)."""
        marker = _notice_marker(os.getpid())
        ts, kind = _read_marker(marker)
        if ts is None:
            return None
        try:
            os.unlink(marker)
        except OSError:
            pass
        if time.time() - ts > self._marker_ttl_s:
            return None  # stale leftover: cleaned up, not a notice
        return kind

    def _on_sigterm(self, signum, frame):
        self.requested.set()
        kind = self._consume_marker()
        if kind == "spot":
            self.spot_notice = True
        self.deliver(TaskPreempted(
            "Preemption notice received (SIGTERM): failing the attempt so "
            "retry can resume from the last checkpoint."
        ))

    def deliver(self, exc):
        """Raise `exc` in the main thread now, or defer it past any active
        shield()ed critical section. Other async failure sources (e.g. the
        gang control's worker watcher) route through this too, so a shield
        around a checkpoint save protects against EVERY mid-save raise, not
        just SIGTERM."""
        if self._shield_depth > 0:
            self._pending_exc = exc
            return
        raise exc

    @contextlib.contextmanager
    def shield(self):
        """Defer the TaskPreempted raise across a critical section (e.g. a
        checkpoint save); re-raised on exit if a notice arrived meanwhile."""
        self._shield_depth += 1
        try:
            yield self
        finally:
            self._shield_depth -= 1
            if self._shield_depth == 0 and self._pending_exc is not None:
                exc = self._pending_exc
                self._pending_exc = None
                if sys.exc_info()[0] is None:
                    raise exc
                # the body is already unwinding with its own exception —
                # don't replace the real error with a clean-looking
                # preemption (requested stays set for callers to inspect)


class PreemptionMonitor(object):
    """Sidecar body: poll the metadata endpoint, signal the task on TRUE."""

    def __init__(self, task_pid, metadata_url=None, poll_secs=POLL_SECS):
        self.task_pid = task_pid
        self.metadata_url = metadata_url or knobs.get_str(
            "TPUFLOW_SPOT_METADATA_URL"
        )
        self.poll_secs = poll_secs

    def preempted(self):
        import urllib.request

        req = urllib.request.Request(
            self.metadata_url, headers={"Metadata-Flavor": "Google"}
        )
        try:
            with urllib.request.urlopen(req, timeout=2) as resp:
                return resp.read().decode("utf-8", "replace").strip().upper() == "TRUE"
        except Exception:
            return False  # metadata server unreachable ≠ preempted

    def run(self):
        while True:
            if self.preempted():
                try:
                    notify_preemption(self.task_pid)
                except ProcessLookupError:
                    return 0
                return 0  # one notice is enough; the handler does the rest
            # exit when the task is gone (don't outlive it)
            try:
                os.kill(self.task_pid, 0)
            except ProcessLookupError:
                return 0
            time.sleep(self.poll_secs)


def main():
    import argparse

    parser = argparse.ArgumentParser(prog="preemption-monitor")
    parser.add_argument("--task-pid", type=int, default=os.getppid())
    parser.add_argument("--metadata-url", default=None)
    parser.add_argument("--poll-secs", type=float, default=POLL_SECS)
    args = parser.parse_args()
    raise SystemExit(
        PreemptionMonitor(
            args.task_pid, args.metadata_url, args.poll_secs
        ).run()
    )


if __name__ == "__main__":
    main()
