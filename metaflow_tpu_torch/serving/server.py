"""HTTP front end for the continuous-batching engines (stdlib only),
ported from the JAX package with the same routes, bodies and status codes.

A ThreadingHTTPServer JSON API: each connection thread blocks on its
request's token stream while the single scheduler loop drives the card.

    POST /v1/generate   {"tokens": [1,2,3], "max_new_tokens": 16,
                         "temperature": 0.0, "top_k": null,
                         "top_p": null, "eos_id": null, "seed": 0,
                         "deadline_ms": null, "stream": false}
      -> 200 {"id", "tokens", "new_tokens", "reason", "usage"}
      -> 200 chunked stream when "stream": true — one JSON line per
         token {"token": t, "index": i}, then a terminal line
         {"done": true, "reason": ..., "new_tokens": [...]}
      -> 400 malformed body / oversized request
      -> 413 a request that can never fit (with Retry-After)
      -> 429 queue full or tenant throttled (backpressure)
      -> 503 draining (graceful shutdown in progress)
    POST /v1/prefill    prefill only; answers the KV handoff frame
    POST /v1/decode     a KV handoff frame in; answers as /v1/generate
    GET /healthz        admission signals in one probe
    GET /v1/stats       scheduler + engine counters
    GET /metrics        the same counters as OpenMetrics text

Graceful shutdown: shutdown() flips /healthz to draining, rejects new
work with 503, lets every accepted request finish (scheduler.drain), then
stops the listener.
"""

import json
import math
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import tracing
from .disagg import decode_handoff, encode_handoff
from .scheduler import (CapacityError, DrainingError, QueueFullError,
                        Request, TenantThrottledError)

STREAM_TIMEOUT_S = 300.0


def retry_after_hint(pending, capacity):
    """Retry-After seconds for a shed response: pending work units per
    unit of capacity, clamped to [1, 60]. Deliberately coarse — the
    point is that a backoff proportional to observed pressure stops
    clients from hammering a shedding server, not that the estimate is
    exact."""
    return int(min(60, max(1, math.ceil(
        float(pending) / max(1.0, float(capacity))))))


def _request_from_payload(payload, prefill_only=False, prefilled=None):
    if not isinstance(payload, dict):
        raise ValueError("body must be a JSON object")
    tokens = payload.get("tokens")
    if (not isinstance(tokens, list) or not tokens
            or not all(isinstance(t, int) for t in tokens)):
        raise ValueError("'tokens' must be a non-empty list of ints")
    deadline = None
    if payload.get("deadline_ms") is not None:
        import time

        deadline = time.time() + float(payload["deadline_ms"]) / 1000.0
    tenant = payload.get("tenant")
    if tenant is not None and not isinstance(tenant, str):
        raise ValueError("'tenant' must be a string")
    return Request(
        tokens,
        max_new_tokens=int(payload.get("max_new_tokens", 16)),
        temperature=float(payload.get("temperature", 0.0)),
        top_k=payload.get("top_k"),
        top_p=payload.get("top_p"),
        eos_id=payload.get("eos_id"),
        rng=int(payload.get("seed", 0)),
        deadline=deadline,
        request_id=payload.get("request_id"),
        prefill_only=prefill_only,
        prefilled=prefilled,
        tenant=tenant or None,
    )


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "tpuflow-serve/1"

    # quiet by default; the scheduler's telemetry is the real log
    def log_message(self, fmt, *args):
        pass

    @property
    def scheduler(self):
        return self.server.scheduler

    def _json(self, code, obj, headers=None):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _bytes(self, code, data, content_type="application/octet-stream"):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _shed_headers(self, draining):
        """Retry-After for 429/503: queue pressure when shedding on
        backpressure, remaining in-flight work when draining."""
        stats = self.scheduler.stats()
        pending = (stats["in_flight"] if draining
                   else stats["queue_depth"] + stats["in_flight"])
        return {"Retry-After": str(retry_after_hint(pending,
                                                    stats["slots"]))}

    def do_GET(self):
        if self.path == "/healthz":
            # one probe carries everything an admission decision needs
            # (the fleet router and external LBs both read this):
            # readiness, drain state, queue pressure, slot occupancy.
            # Schema pinned in tests/schema_validate.py::HEALTHZ_SCHEMA.
            stats = self.scheduler.stats()
            prefix = stats["prefix_cache"]
            kv = stats["kv_pages"]
            self._json(200, {
                "ok": True,
                "draining": self.server.draining or stats["draining"],
                "role": self.server.role,
                "queue_depth": stats["queue_depth"],
                "in_flight": stats["in_flight"],
                "slots": stats["slots"],
                "occupancy": stats["occupancy"],
                # admission capacity: the fleet router sheds requests
                # that can never fit ANY ready replica against this
                "max_context_tokens": stats["max_context_tokens"],
                # paged-KV pool health ({"enabled": False} on the slot
                # engine — the schema stays total either way)
                "kv_pages": ({
                    "enabled": True,
                    "occupancy": kv["occupancy"],
                    "pages_free": kv["pages_free"],
                    "pages_total": kv["pages_total"],
                    "shared_pages": kv["shared_pages"],
                    "cow_pages": kv["cow_pages"],
                    "exhausted": kv["exhausted"],
                } if kv["enabled"] else {"enabled": False}),
                # rolling tail latency: the SLO monitor polls this
                "p50_ttft_ms": stats["p50_ttft_ms"],
                "p99_ttft_ms": stats["p99_ttft_ms"],
                "p50_itl_ms": stats["p50_itl_ms"],
                "p99_itl_ms": stats["p99_itl_ms"],
                # prefix-cache effectiveness (hit rate / bytes /
                # evictions) + the compact routing-digest summary the
                # fleet's cache-aware dispatch scores against
                "prefix_cache": {
                    "enabled": prefix["enabled"],
                    "hit_rate": prefix["hit_rate"],
                    "cached_bytes": prefix.get("cached_bytes", 0),
                    "evictions": prefix.get("evictions", 0),
                    "route_block": prefix.get("route_block", 0),
                    "digests": prefix.get("digests", []),
                },
            })
            return
        if self.path == "/v1/stats":
            self._json(200, self.scheduler.stats())
            return
        if self.path == "/metrics":
            # OpenMetrics text for Prometheus-style scrapers, rendered
            # from the SAME stats dict /v1/stats serves (vocabulary
            # pinned in tests/schema_validate.py)
            from .. import goodput

            text = goodput.render_openmetrics(
                goodput.scheduler_metric_families(self.scheduler.stats()))
            self._bytes(200, text.encode("utf-8"),
                        content_type=goodput.OPENMETRICS_CONTENT_TYPE)
            return
        self._json(404, {"error": "not found"})

    def do_POST(self):
        if self.path == "/v1/generate":
            self._post_generate()
        elif self.path == "/v1/prefill":
            self._post_prefill()
        elif self.path == "/v1/decode":
            self._post_decode()
        else:
            self._json(404, {"error": "not found"})

    def _read_body(self):
        length = int(self.headers.get("Content-Length", "0"))
        return self.rfile.read(length)

    def _bind_trace(self, req):
        # trace context: the fleet router forwards a per-attempt
        # Traceparent header; a direct (router-less) request gets a root
        # traceparent minted here so its records still form a tree
        tp = self.headers.get("Traceparent")
        if not tp and tracing.trace_requests_enabled():
            tp = tracing.request_traceparent(req.id)
        req.traceparent = tp or None

    def _submit_or_shed(self, req):
        """Submit into the scheduler; on shed, answer 429/503 WITH a
        Retry-After derived from current pressure and return False."""
        try:
            self.scheduler.submit(req)
            return True
        except CapacityError as ex:
            # the request can NEVER fit this engine: a permanent 413,
            # not backpressure — but still carry Retry-After so generic
            # clients that only look at the header back off sanely
            self._json(413, {"error": str(ex)},
                       headers=self._shed_headers(draining=False))
            return False
        except TenantThrottledError as ex:
            # the TENANT's own backoff hint (budget-window remainder or
            # its queue-share drain time), never the global capacity
            # hint — and the tenant id rides the body for client-side
            # per-tenant backoff state
            self._json(429, {"error": str(ex), "reason": ex.reason,
                             "tenant": ex.tenant},
                       headers={"Retry-After": str(int(max(
                           1, math.ceil(ex.retry_after_s))))})
            return False
        except QueueFullError as ex:
            self._json(429, {"error": str(ex)},
                       headers=self._shed_headers(draining=False))
            return False
        except DrainingError as ex:
            self._json(503, {"error": str(ex)},
                       headers=self._shed_headers(draining=True))
            return False

    def _post_generate(self):
        try:
            payload = json.loads(self._read_body() or b"{}")
            req = _request_from_payload(payload)
        except (ValueError, TypeError) as ex:
            self._json(400, {"error": str(ex)})
            return
        self._bind_trace(req)
        stream = bool(payload.get("stream", False))
        if not self._submit_or_shed(req):
            return
        if stream:
            self._stream(req)
        else:
            try:
                tokens = req.result(timeout=STREAM_TIMEOUT_S)
            except TimeoutError:
                req.cancel()
                self._json(504, {"error": "generation timed out"})
                return
            if req.reason == "rejected":
                self._json(400, {"error": getattr(req, "error",
                                                  "rejected")})
                return
            if req.reason == "shed":
                # evicted from the queue by a higher-priority tenant:
                # backpressure (retryable), tenant echoed for client
                # backoff bookkeeping
                self._json(429, {"error": "shed by a higher-priority "
                                          "tenant", "reason": "priority",
                                 "tenant": req.tenant},
                           headers=self._shed_headers(draining=False))
                return
            self._json(200, {
                "id": req.id,
                "tokens": req.tokens + tokens,
                "new_tokens": tokens,
                "reason": req.reason,
                "usage": {"prompt_tokens": len(req.tokens),
                          "new_tokens": len(tokens)},
            })

    # ---------- disaggregation endpoints ----------

    def _post_prefill(self):
        """Prefill-worker entry: run chunked prefill only, answer with
        the KV handoff frame (disagg.encode_handoff) the router ships to
        a decode replica."""
        try:
            payload = json.loads(self._read_body() or b"{}")
            req = _request_from_payload(payload, prefill_only=True)
        except (ValueError, TypeError) as ex:
            self._json(400, {"error": str(ex)})
            return
        self._bind_trace(req)
        if not self._submit_or_shed(req):
            return
        try:
            req.result(timeout=STREAM_TIMEOUT_S)
        except TimeoutError:
            req.cancel()
            self._json(504, {"error": "prefill timed out"})
            return
        if req.reason == "rejected":
            self._json(400, {"error": getattr(req, "error", "rejected")})
            return
        if req.reason != "prefilled" or req.handoff is None:
            self._json(500, {"error": "prefill ended as %r" % req.reason})
            return
        # the frame embeds the ORIGINAL payload: a router can POST it to
        # a decode replica's /v1/decode verbatim, no re-framing needed
        self._bytes(200, encode_handoff(
            {"id": req.id, "first": req.handoff["first"],
             "prompt_tokens": len(req.tokens), "payload": payload},
            req.handoff["kv"]))

    def _post_decode(self):
        """Decode-replica entry: accept a KV handoff frame whose header
        carries the ORIGINAL generate payload plus the first sampled
        token, seed a slot with the KV, and stream/answer exactly like
        /v1/generate (the first token included, so clients and the
        router see an identical response shape)."""
        try:
            meta, kv = decode_handoff(self._read_body())
            payload = meta["payload"]
            req = _request_from_payload(
                payload, prefilled={"first": int(meta["first"]), "kv": kv})
        except (ValueError, TypeError, KeyError) as ex:
            self._json(400, {"error": str(ex)})
            return
        self._bind_trace(req)
        stream = bool(payload.get("stream", False))
        if not self._submit_or_shed(req):
            return
        if stream:
            self._stream(req)
            return
        try:
            tokens = req.result(timeout=STREAM_TIMEOUT_S)
        except TimeoutError:
            req.cancel()
            self._json(504, {"error": "generation timed out"})
            return
        if req.reason == "rejected":
            self._json(400, {"error": getattr(req, "error", "rejected")})
            return
        self._json(200, {
            "id": req.id,
            "tokens": req.tokens + tokens,
            "new_tokens": tokens,
            "reason": req.reason,
            "usage": {"prompt_tokens": len(req.tokens),
                      "new_tokens": len(tokens)},
        })

    # ---------- chunked streaming ----------

    def _chunk(self, data):
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))

    def _stream(self, req):
        import queue as _q

        # hold the status line until the request's first event: a
        # rejected request must get the same 400 the non-stream path
        # returns, not a 200 with an error buried in the tail
        try:
            first = req.out.get(timeout=STREAM_TIMEOUT_S)
        except _q.Empty:
            req.cancel()
            self._json(504, {"error": "generation timed out"})
            return
        if first is None and req.reason == "rejected":
            self._json(400, {"error": getattr(req, "error", "rejected")})
            return
        if first is None and req.reason == "shed":
            self._json(429, {"error": "shed by a higher-priority tenant",
                             "reason": "priority", "tenant": req.tenant},
                       headers=self._shed_headers(draining=False))
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            item, i = first, 0
            while item is not None:
                self._chunk(json.dumps(
                    {"token": item, "index": i}).encode() + b"\n")
                self.wfile.flush()
                i += 1
                try:
                    item = req.out.get(timeout=STREAM_TIMEOUT_S)
                except _q.Empty:
                    raise TimeoutError()
            self._chunk(json.dumps(
                {"done": True, "reason": req.reason,
                 "new_tokens": req.generated}).encode() + b"\n")
            self._chunk(b"")  # terminal zero-length chunk
        except (BrokenPipeError, ConnectionResetError, TimeoutError):
            # client went away (or the engine stalled): free the slot
            # and drop the keep-alive socket — a half-finished chunked
            # response must not leave the client waiting on it
            req.cancel()
            self.close_connection = True


class ServingServer(object):
    """The listener + its scheduler, with graceful-drain plumbing."""

    def __init__(self, scheduler, host="127.0.0.1", port=0,
                 role="unified"):
        if role not in ("unified", "prefill", "decode"):
            raise ValueError("role must be unified/prefill/decode, got %r"
                             % (role,))
        self.scheduler = scheduler
        self.role = role
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.scheduler = scheduler
        self._httpd.draining = False
        self._httpd.role = role
        self._thread = None

    @property
    def host(self):
        return self._httpd.server_address[0]

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def draining(self):
        return self._httpd.draining

    def start(self):
        self.scheduler.start()
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="tpuflow-serve-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self):
        """Blocking variant for the CLI: runs until SIGTERM/SIGINT."""
        self.install_signal_handlers()
        self.start()
        try:
            self._done = getattr(self, "_done", threading.Event())
            self._done.wait()
        except KeyboardInterrupt:
            self.shutdown()

    def install_signal_handlers(self):
        self._done = threading.Event()

        def _on_signal(_sig, _frame):
            threading.Thread(target=self.shutdown, daemon=True).start()

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, _on_signal)
            except ValueError:
                pass  # not the main thread (tests)

    def shutdown(self, timeout=60.0):
        """Graceful drain: flip /healthz, 503 new work, finish accepted
        requests, stop the listener."""
        self._httpd.draining = True
        drained = self.scheduler.drain(timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        if getattr(self, "_done", None) is not None:
            self._done.set()
        return drained

    def close(self):
        """Hard stop (tests)."""
        self.scheduler.stop()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
