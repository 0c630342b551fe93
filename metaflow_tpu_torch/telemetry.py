"""Run flight recorder: datastore-backed telemetry records.

A copy of the JAX package's recorder for the port. Every record carries
full identity (run/step/task/attempt/rank/host/pid/trace) and is buffered,
then persisted through the flow datastore's storage (`save_bytes`,
`path_join`; the port's `datastore/local.py` or any object with that
interface) under the run's `_telemetry/` prefix, in the same part files and
the same record schema, so the JAX package's `read_run_records` reads
what this module writes:

    {"v": 1, "type": "timer|counter|gauge|event", "name": str,
     "ts": float, "run_id": str, "step": str, "task_id": str,
     "attempt": int, "rank": int, "host": str, "pid": int,
     # optional, by type:
     "ms": float, "ok": bool,        # timer
     "inc": number,                  # counter
     "value": number,                # gauge
     "step_num": int,                # training-step records
     "trace": str,                   # W3C trace id (TRACEPARENT)
     "data": {...}}                  # free-form extras

Crash safety: records flush in numbered part files
(`_telemetry/<step>.<task>.<attempt>.<part>.jsonl`) — a task that dies
mid-run loses at most the unflushed tail, never already-persisted parts.

Env vars:
    TPUFLOW_TELEMETRY=0            disable the recorder entirely
    TPUFLOW_TELEMETRY_FLUSH_EVERY  buffer size before an auto-flush (512)
    TPUFLOW_PROFILE_STEPS=A:B      capture a torch.profiler trace for train
                                   steps [A, B) and upload it
    TPUFLOW_PROFILE_REQUEST=path   touch this file (content: step count)
                                   to trigger a capture on a live run
    TPUFLOW_PROFILE_SIGNAL=1       SIGUSR2 triggers a capture too
"""

import io
import json
import os
import socket
import sys
import threading
import time
import zipfile
from contextlib import contextmanager

from . import knobs

RECORD_VERSION = 1
TELEMETRY_PREFIX = "_telemetry"
PROFILE_PREFIX = "_telemetry/profiles"

_current = None


def _rank_from_env():
    """The gang rank (MF_PARALLEL_NODE_INDEX); outside a gang, the rank of
    an initialised torch.distributed group, so a mesh step's records carry
    their rank either way; else 0."""
    if "MF_PARALLEL_NODE_INDEX" not in os.environ:
        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and \
                dist.is_initialized():
            return dist.get_rank()
    try:
        return int(os.environ.get("MF_PARALLEL_NODE_INDEX", "0"))
    except ValueError:
        return 0


def trace_id_from_env(env=None):
    """The 32-hex trace id of the ambient W3C TRACEPARENT, or ''."""
    tp = (env or os.environ).get("TRACEPARENT", "")
    parts = tp.split("-")
    if len(parts) >= 2 and len(parts[1]) == 32:
        return parts[1]
    return ""


class FlightRecorder(object):
    """Buffered, identity-stamped telemetry sink for ONE task attempt
    (or one scheduler process), persisting to the run's datastore."""

    def __init__(self, flow_datastore, run_id, step_name, task_id,
                 attempt=0, rank=None, flush_every=None):
        self._fds = flow_datastore
        self.run_id = str(run_id)
        self.step_name = step_name
        self.task_id = str(task_id)
        self.attempt = int(attempt)
        self.rank = _rank_from_env() if rank is None else int(rank)
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.trace = trace_id_from_env()
        if flush_every is None:
            flush_every = knobs.get_int("TPUFLOW_TELEMETRY_FLUSH_EVERY")
        self._flush_every = max(1, flush_every)
        # records arrive from more than one thread (the training loop and
        # the async-checkpoint upload thread both emit through the
        # module-global recorder): buffer + part counter are lock-guarded
        self._lock = threading.Lock()
        self._buf = []
        self._part = 0
        # a broken storage backend must not turn every emit into a
        # blocking failed upload (nor grow the buffer without bound)
        self._flush_fail_until = 0.0
        self._max_buffered = max(self._flush_every * 8, 4096)
        # flush-failure visibility: failed attempts / shed records are
        # counted here and reported as telemetry.flush_failed +
        # telemetry.dropped_records on the first flush that lands again
        self._flush_failures = 0
        self._fail_buffered = 0
        self._dropped = 0
        self._dropped_reported = 0

    # ---------- emit ----------

    def emit(self, rtype, name, ms=None, ok=None, inc=None, value=None,
             step_num=None, data=None):
        rec = {
            "v": RECORD_VERSION,
            "type": rtype,
            "name": name,
            "ts": time.time(),
            "run_id": self.run_id,
            "step": self.step_name,
            "task_id": self.task_id,
            "attempt": self.attempt,
            "rank": self.rank,
            "host": self.host,
            "pid": self.pid,
        }
        if ms is not None:
            rec["ms"] = round(float(ms), 3)
        if ok is not None:
            rec["ok"] = bool(ok)
        if inc is not None:
            rec["inc"] = inc
        if value is not None:
            rec["value"] = value
        if step_num is not None:
            rec["step_num"] = int(step_num)
        if self.trace:
            rec["trace"] = self.trace
        if data:
            rec["data"] = data
        with self._lock:
            self._buf.append(rec)
            if len(self._buf) > self._max_buffered:
                # storage has been down long enough to hit the cap: shed
                # the oldest half rather than grow without bound
                shed = len(self._buf) // 2
                del self._buf[:shed]
                self._dropped += shed
            want_flush = len(self._buf) >= self._flush_every
        if want_flush:
            self.flush()
        return rec

    @contextmanager
    def timer(self, name, step_num=None, data=None):
        """Time a block; the record lands even when the block raises
        (ok: false) and the exception propagates. GeneratorExit is NOT a
        failure: it is how a consumer closes a generator-shaped span
        early (e.g. a single-artifact load)."""
        start = time.perf_counter()
        try:
            yield
        except GeneratorExit:
            self.emit("timer", name,
                      ms=(time.perf_counter() - start) * 1000,
                      ok=True, step_num=step_num, data=data)
            raise
        except BaseException:
            self.emit("timer", name,
                      ms=(time.perf_counter() - start) * 1000,
                      ok=False, step_num=step_num, data=data)
            raise
        self.emit("timer", name, ms=(time.perf_counter() - start) * 1000,
                  ok=True, step_num=step_num, data=data)

    def counter(self, name, inc=1, data=None):
        self.emit("counter", name, inc=inc, data=data)

    def gauge(self, name, value, step_num=None, data=None):
        self.emit("gauge", name, value=value, step_num=step_num, data=data)

    def event(self, name, data=None):
        self.emit("event", name, data=data)

    # ---------- persistence ----------

    def _part_path(self, part):
        fname = "%s.%s.%d.%06d.jsonl" % (
            self.step_name, self.task_id, self.attempt, part)
        return self._fds.storage.path_join(
            self._fds.flow_name, self.run_id, TELEMETRY_PREFIX, fname)

    def flush(self, force=False):
        """Persist the buffered records as the next part file. Telemetry
        must never fail the work it observes: storage errors are
        swallowed, the buffer is retained, and further emit-triggered
        flushes back off for a cooldown so a dead backend cannot turn
        every record into a blocking failed upload (force=True — the
        finalization path — always tries)."""
        with self._lock:
            if not self._buf:
                return 0
            if not force and time.monotonic() < self._flush_fail_until:
                return 0
            records, self._buf = self._buf, []
            part = self._part
            self._part += 1
        payload = "\n".join(
            json.dumps(r, sort_keys=True) for r in records
        ).encode("utf-8") + b"\n"
        try:
            self._fds.storage.save_bytes(
                [(self._part_path(part), payload)], overwrite=True)
        except Exception:
            with self._lock:
                # put the records back (front) for the next attempt; the
                # part number is NOT reused — a later retry writing a
                # lower part number than an already-landed one is fine
                # (readers take every part), a clobber is not
                self._buf[:0] = records
                self._flush_fail_until = time.monotonic() + 30.0
                self._flush_failures += 1
                self._fail_buffered = len(self._buf)
            return 0
        with self._lock:
            failures, self._flush_failures = self._flush_failures, 0
            buffered, self._fail_buffered = self._fail_buffered, 0
            dropped_new = self._dropped - self._dropped_reported
            self._dropped_reported = self._dropped
        if failures:
            # first flush to land after an outage: make the outage (and
            # anything shed during it) visible in the record stream
            self.counter("telemetry.flush_failed", inc=failures,
                         data={"buffered": buffered})
        if dropped_new:
            self.gauge("telemetry.dropped_records", self._dropped,
                       data={"dropped_since_last_flush": dropped_new})
        if failures or dropped_new:
            # persist the visibility records now — the recursion is
            # bounded: the counters were just zeroed, so the inner call
            # cannot emit again (and a close() must not strand them)
            self.flush(force=force)
        return len(records)

    def close(self):
        return self.flush(force=True)

    # ---------- artifacts (profiler traces, ...) ----------

    def save_artifact(self, name, payload, prefix=PROFILE_PREFIX):
        """Persist an opaque artifact under the run's telemetry tree;
        returns the datastore-relative path (or None on error)."""
        path = self._fds.storage.path_join(
            self._fds.flow_name, self.run_id, prefix, name)
        try:
            self._fds.storage.save_bytes([(path, payload)], overwrite=True)
        except Exception:
            return None
        return path


# ---------------------------------------------------------------------------
# module-level current recorder: hot paths emit through these helpers and
# stay no-ops outside a run context (bench standalone, library use)
# ---------------------------------------------------------------------------


def enabled():
    return knobs.get_bool("TPUFLOW_TELEMETRY")


def init_recorder(flow_datastore, run_id, step_name, task_id, attempt=0,
                  rank=None):
    """Install the process-wide recorder for this task attempt. Returns
    None (and clears any inherited recorder) when telemetry is off."""
    global _current
    if not enabled():
        _current = None
        return None
    _current = FlightRecorder(flow_datastore, run_id, step_name, task_id,
                              attempt=attempt, rank=rank)
    return _current


def set_recorder(recorder):
    global _current
    _current = recorder
    return recorder


def current_recorder():
    return _current


def close_recorder():
    global _current
    rec, _current = _current, None
    # a capture window that never reached its stop step (loop ended
    # early, telemetry=True user never called close()) must still land:
    # stop + upload any in-flight capture before the final flush
    for trigger in list(_live_triggers):
        try:
            trigger.stop()
        except Exception:
            pass
    if rec is not None:
        rec.close()


def emit(rtype, name, **kwargs):
    if _current is not None:
        _current.emit(rtype, name, **kwargs)


@contextmanager
def timer(name, step_num=None, data=None):
    if _current is None:
        yield
        return
    with _current.timer(name, step_num=step_num, data=data):
        yield


def counter(name, inc=1, data=None):
    if _current is not None:
        _current.counter(name, inc=inc, data=data)


def gauge(name, value, step_num=None, data=None):
    if _current is not None:
        _current.gauge(name, value, step_num=step_num, data=data)


def event(name, data=None):
    if _current is not None:
        _current.event(name, data=data)


def flush():
    if _current is not None:
        _current.flush()


def read_run_records(flow_datastore, run_id):
    """All telemetry records persisted for a run, across every task/rank/
    host, sorted by timestamp."""
    storage = flow_datastore.storage
    prefix = storage.path_join(
        flow_datastore.flow_name, str(run_id), TELEMETRY_PREFIX)
    paths = [p for p, is_file in storage.list_content([prefix])
             if is_file and p.endswith(".jsonl")]
    records = []
    if paths:
        with storage.load_bytes(paths) as loaded:
            for _path, local, _meta in loaded:
                if local is None:
                    continue
                with open(local, "rb") as f:
                    for line in f.read().decode("utf-8").splitlines():
                        if not line.strip():
                            continue
                        try:
                            records.append(json.loads(line))
                        except ValueError:
                            continue
    records.sort(key=lambda r: r.get("ts", 0))
    return records


def list_run_profiles(flow_datastore, run_id):
    """Datastore paths of profiler trace artifacts captured for a run."""
    storage = flow_datastore.storage
    prefix = storage.path_join(
        flow_datastore.flow_name, str(run_id), PROFILE_PREFIX)
    return [p for p, is_file in storage.list_content([prefix]) if is_file]


# ---------------------------------------------------------------------------
# on-demand torch.profiler capture
# ---------------------------------------------------------------------------


# ProfileTriggers with an IN-FLIGHT capture: registered at _start, removed
# at stop — close_recorder() drains them so a window that outlives the
# train loop (or a telemetry=True user who never calls close()) still
# stops the profiler and uploads the trace
_live_triggers = set()

PROFILE_TRACE_FILE = "trace.json"


def _zip_dir(root):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirpath, _dirs, files in os.walk(root):
            for name in files:
                full = os.path.join(dirpath, name)
                zf.write(full, os.path.relpath(full, root))
    return buf.getvalue()


class ProfileTrigger(object):
    """Step-window torch.profiler capture for a live training loop.

    Call `on_step(step_num)` once per train step, from the thread that
    runs the steps (the profiler starts and stops there: kineto complains
    when it is started in another thread). Capture starts when any
    trigger fires and stops `length` steps later; the Chrome trace
    (`trace.json`) is zipped and uploaded to the run's datastore under
    `_telemetry/profiles/`, with a `profile.captured` event linking it.
    The window records CPU activity, and CUDA activity when `cuda` (the
    steps run on the card; default: a card is present). Before it stops,
    a CUDA window waits for the card, so the window's last kernels are in
    the trace.

    Triggers:
      - env window: TPUFLOW_PROFILE_STEPS="start:stop" (absolute step
        numbers, capture is [start, stop))
      - file: the TPUFLOW_PROFILE_REQUEST path appears (its content, an
        integer, is the capture length; default 5 steps). The file is
        removed once the capture starts, so it can be re-touched.
      - signal: SIGUSR2 when TPUFLOW_PROFILE_SIGNAL=1 (install via
        install_signal_trigger()).
    """

    DEFAULT_LENGTH = 5

    def __init__(self, recorder=None, steps=None, request_file=None,
                 check_every=1.0, cuda=None):
        self._recorder = recorder
        spec = (steps if steps is not None
                else knobs.get_str("TPUFLOW_PROFILE_STEPS"))
        self._window = self._parse_window(spec)
        self._request_file = request_file or knobs.get_str(
            "TPUFLOW_PROFILE_REQUEST")
        self._check_every = check_every
        self._cuda = cuda
        self._last_check = 0.0
        self._signal_pending = [0]
        self._active = None  # (start_step, stop_step, tmpdir, profiler)
        if knobs.get_bool("TPUFLOW_PROFILE_SIGNAL"):
            self.install_signal_trigger()

    @staticmethod
    def _parse_window(spec):
        if not spec:
            return None
        try:
            start, _, stop = spec.partition(":")
            start, stop = int(start), int(stop)
        except ValueError:
            sys.stderr.write(
                "telemetry: ignoring malformed TPUFLOW_PROFILE_STEPS=%r "
                "(want start:stop)\n" % spec)
            return None
        if stop <= start:
            return None
        return (start, stop)

    def install_signal_trigger(self, signum=None):
        import signal as _signal

        signum = signum or _signal.SIGUSR2
        pending = self._signal_pending

        def _on_signal(_s, _f):
            pending[0] = self.DEFAULT_LENGTH

        try:
            _signal.signal(signum, _on_signal)
        except ValueError:
            pass  # not the main thread: signal trigger unavailable

    def _poll_request_file(self):
        if not self._request_file:
            return 0
        now = time.monotonic()
        if now - self._last_check < self._check_every:
            return 0
        self._last_check = now
        try:
            with open(self._request_file) as f:
                content = f.read().strip()
            os.unlink(self._request_file)
        except OSError:
            return 0
        try:
            return max(1, int(content)) if content else self.DEFAULT_LENGTH
        except ValueError:
            return self.DEFAULT_LENGTH

    def on_step(self, step_num):
        """Drive the capture state machine; cheap when idle."""
        if self._active is None:
            length = 0
            if self._window and step_num >= self._window[0]:
                start, stop = self._window
                self._window = None
                if step_num < stop:
                    length = stop - step_num
            if not length and self._signal_pending[0]:
                length, self._signal_pending[0] = self._signal_pending[0], 0
            if not length:
                length = self._poll_request_file()
            if length:
                self._start(step_num, step_num + length)
        elif step_num >= self._active[1]:
            self.stop(step_num)

    def _wants_cuda(self):
        import torch

        if self._cuda is None:
            self._cuda = torch.cuda.is_available()
        return self._cuda

    def _start(self, start_step, stop_step):
        import shutil
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self._wants_cuda():
            activities.append(ProfilerActivity.CUDA)
        tmpdir = tempfile.mkdtemp(prefix="tpuflow_profile_")
        prof = profile(activities=activities)
        try:
            prof.start()
        except Exception as ex:
            sys.stderr.write("telemetry: profiler start failed: %s\n" % ex)
            shutil.rmtree(tmpdir, ignore_errors=True)
            return
        self._active = (start_step, stop_step, tmpdir, prof)
        _live_triggers.add(self)
        if self._recorder is not None:
            self._recorder.event(
                "profile.start",
                data={"start_step": start_step, "stop_step": stop_step})

    def stop(self, step_num=None):
        """Stop an in-flight capture, upload the zipped trace, link it."""
        if self._active is None:
            return None
        import shutil

        import torch

        start_step, stop_step, tmpdir, prof = self._active
        self._active = None
        _live_triggers.discard(self)
        try:
            if self._cuda:
                torch.cuda.synchronize()
            prof.stop()
            prof.export_chrome_trace(
                os.path.join(tmpdir, PROFILE_TRACE_FILE))
        except Exception as ex:
            sys.stderr.write("telemetry: profiler stop failed: %s\n" % ex)
            shutil.rmtree(tmpdir, ignore_errors=True)
            return None
        payload = _zip_dir(tmpdir)
        shutil.rmtree(tmpdir, ignore_errors=True)
        path = None
        if self._recorder is not None:
            name = "trace_%s_%s_a%d_s%d-%d.zip" % (
                self._recorder.step_name, self._recorder.task_id,
                self._recorder.attempt, start_step,
                stop_step if step_num is None else step_num)
            path = self._recorder.save_artifact(name, payload)
            self._recorder.event(
                "profile.captured",
                data={"artifact": path, "start_step": start_step,
                      "stop_step": stop_step, "bytes": len(payload)})
        else:
            # no run context: keep the trace on local disk
            out = os.path.abspath("tpuflow_profile_s%d-%d.zip"
                                  % (start_step, stop_step))
            with open(out, "wb") as f:
                f.write(payload)
            sys.stderr.write("telemetry: profiler trace saved to %s\n" % out)
            path = out
        return path
