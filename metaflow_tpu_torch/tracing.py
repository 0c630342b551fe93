"""Tracing: the parts of the JAX package's tracing module that the flow
runtime, the scheduler and the HTTP server call.

`span` tees a timed block into the run's flight recorder (telemetry.py)
when one is active and is a no-op otherwise; the port ships no
OpenTelemetry exporter. The per-request trace context is the JAX
package's, id for id: the fleet router mints one traceparent per request
and forwards it as an HTTP header; replicas stamp the received trace/span
into every serve.request.* record. All ids are deterministic sha256
derivations, so a JAX replica and a port replica derive the same tree.
"""

import hashlib
import os
from contextlib import contextmanager

from . import knobs

_TRACEPARENT_VAR = "TRACEPARENT"
_TRACE_REQUESTS_VAR = "TPUFLOW_TRACE_REQUESTS"


@contextmanager
def span(name, attributes=None):
    """Span context manager: a timer record in the active flight recorder
    (exceptions mark it ok: false and propagate), else a no-op."""
    from . import telemetry

    if telemetry.current_recorder() is None:
        yield None
        return
    with telemetry.timer(name, data=_span_data(attributes)):
        yield None


def _span_data(attributes):
    if not attributes:
        return None
    # telemetry records are JSON: keep attribute values primitive
    return {
        k: (v if isinstance(v, (str, int, float, bool)) else str(v))
        for k, v in attributes.items()
    }


def inject_tracing_vars(env):
    """Propagate the trace context into a subprocess env: an ambient
    TRACEPARENT (set by a CI driver, a parent scheduler, or
    ensure_traceparent) is forwarded, so every task and gang rank of a
    run share one trace id in their telemetry records."""
    if _TRACEPARENT_VAR in os.environ:
        env.setdefault(_TRACEPARENT_VAR, os.environ[_TRACEPARENT_VAR])
    return env


def ensure_traceparent(seed):
    """Make sure this process carries a W3C TRACEPARENT, synthesizing a
    deterministic one from `seed` (the run id) when absent. Returns the
    value."""
    existing = os.environ.get(_TRACEPARENT_VAR)
    if existing:
        return existing
    digest = hashlib.sha256(("tpuflow-run:%s" % seed).encode()).hexdigest()
    value = "00-%s-%s-01" % (digest[:32], digest[32:48])
    os.environ[_TRACEPARENT_VAR] = value
    return value


def trace_requests_enabled(env=None):
    """Per-request tracing is on unless TPUFLOW_TRACE_REQUESTS=0."""
    return knobs.get_bool(_TRACE_REQUESTS_VAR, env=env)


def _hexdigest(seed, n):
    return hashlib.sha256(seed.encode()).hexdigest()[:n]


def request_traceparent(request_id):
    """Mint the root traceparent for one serving request.

    The trace id joins the ambient run trace (TRACEPARENT) when one
    exists, so request subtrees nest under the run; otherwise it is
    derived from the request id alone. The span id is always derived from
    the request id — it is the root of the request's subtree."""
    ambient = os.environ.get(_TRACEPARENT_VAR, "")
    parts = ambient.split("-")
    if len(parts) >= 3 and len(parts[1]) == 32:
        trace_id = parts[1]
    else:
        trace_id = _hexdigest("tpuflow-request-trace:%s" % request_id, 32)
    span_id = _hexdigest("tpuflow-request:%s" % request_id, 16)
    return "00-%s-%s-01" % (trace_id, span_id)


def child_traceparent(traceparent, key):
    """Derive a child traceparent: same trace id, span id keyed off the
    parent span + `key` (e.g. "dispatch-2" for the second dispatch
    attempt). Deterministic so the assembler can re-derive parentage."""
    trace_id, span_id = traceparent_ids(traceparent)
    child = _hexdigest("tpuflow-span:%s:%s" % (span_id, key), 16)
    return "00-%s-%s-01" % (trace_id, child)


def traceparent_ids(traceparent):
    """Split a W3C traceparent into (trace_id, span_id); ("", "") when
    malformed or absent."""
    parts = (traceparent or "").split("-")
    if len(parts) >= 3 and len(parts[1]) == 32 and len(parts[2]) == 16:
        return parts[1], parts[2]
    return "", ""
