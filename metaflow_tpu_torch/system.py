"""System telemetry: event logger + monitor (counters/timers/gauges).

Reference behavior: metaflow/event_logger.py + monitor.py — pluggable
telemetry with debug implementations; the task executor wraps user code in a
timer and counts task starts/ends (reference task.py:793-807). Records here
flush to a JSONL under the datastore root ('debug' impl prints to stderr).
"""

import json
import os
import sys
import time
from contextlib import contextmanager

from . import knobs


class BaseEventLogger(object):
    TYPE = "null"

    def log(self, payload):
        pass


class BaseMonitor(object):
    TYPE = "null"

    @contextmanager
    def measure(self, name):
        yield

    @contextmanager
    def count(self, name):
        yield

    def gauge(self, name, value):
        pass


class DebugEventLogger(BaseEventLogger):
    TYPE = "debug"

    def log(self, payload):
        sys.stderr.write("event: %s\n" % json.dumps(payload))


class DebugMonitor(BaseMonitor):
    TYPE = "debug"

    @contextmanager
    def measure(self, name):
        # the record must land even when the wrapped block raises (a
        # failed task's timing is the interesting one); the exception
        # always propagates
        start = time.time()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            sys.stderr.write(
                "timer %s: %.1f ms%s\n"
                % (name, (time.time() - start) * 1000,
                   "" if ok else " (failed)")
            )

    @contextmanager
    def count(self, name):
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            sys.stderr.write(
                "counter %s: +1%s\n" % (name, "" if ok else " (failed)")
            )

    def gauge(self, name, value):
        sys.stderr.write("gauge %s: %s\n" % (name, value))


class FileMonitor(BaseMonitor):
    """Append metrics to <root>/_telemetry/metrics.jsonl (local default)."""

    TYPE = "file"

    def __init__(self, root=None):
        from .util import get_tpuflow_root

        self._path = os.path.join(
            root or get_tpuflow_root(), "_telemetry", "metrics.jsonl"
        )

    def _write(self, record):
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            record["ts"] = time.time()
            record["pid"] = os.getpid()
            with open(self._path, "a") as f:
                f.write(json.dumps(record) + "\n")
        except OSError:
            pass

    @contextmanager
    def measure(self, name):
        # emit with ok:false and re-raise when the wrapped block fails —
        # dropping the record entirely hid exactly the attempts worth
        # timing (failed/retried ones)
        start = time.time()
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            self._write(
                {"type": "timer", "name": name,
                 "ms": round((time.time() - start) * 1000, 3), "ok": ok}
            )

    @contextmanager
    def count(self, name):
        ok = True
        try:
            yield
        except BaseException:
            ok = False
            raise
        finally:
            self._write({"type": "counter", "name": name, "inc": 1,
                         "ok": ok})

    def gauge(self, name, value):
        self._write({"type": "gauge", "name": name, "value": value})


class FileEventLogger(BaseEventLogger):
    TYPE = "file"

    def __init__(self, root=None):
        from .util import get_tpuflow_root

        self._path = os.path.join(
            root or get_tpuflow_root(), "_telemetry", "events.jsonl"
        )

    def log(self, payload):
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            with open(self._path, "a") as f:
                f.write(json.dumps({"ts": time.time(), **payload}) + "\n")
        except OSError:
            pass


MONITORS = {"null": BaseMonitor, "debug": DebugMonitor, "file": FileMonitor}
EVENT_LOGGERS = {
    "null": BaseEventLogger,
    "debug": DebugEventLogger,
    "file": FileEventLogger,
}


def _resolve_kind(kind, registry, default_cls, what, env_var):
    cls = registry.get(kind)
    if cls is None:
        # a typo'd env var must not silently disable telemetry
        sys.stderr.write(
            "warning: unknown %s kind %r (%s) — falling back to the "
            "null implementation; known kinds: %s\n"
            % (what, kind, env_var, ", ".join(sorted(registry)))
        )
        cls = default_cls
    return cls()


def get_monitor(kind=None):
    kind = kind or knobs.get_str("TPUFLOW_MONITOR")
    return _resolve_kind(kind, MONITORS, BaseMonitor, "monitor",
                         "TPUFLOW_MONITOR")


def get_event_logger(kind=None):
    kind = kind or knobs.get_str("TPUFLOW_EVENT_LOGGER")
    return _resolve_kind(kind, EVENT_LOGGERS, BaseEventLogger,
                         "event logger", "TPUFLOW_EVENT_LOGGER")


def read_metrics(root=None):
    from .util import get_tpuflow_root

    path = os.path.join(root or get_tpuflow_root(), "_telemetry",
                        "metrics.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
