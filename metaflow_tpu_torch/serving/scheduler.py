"""Request scheduler for the continuous-batching engines, ported from the
JAX package: a bounded request queue with backpressure, per-iteration
admission into free slots, a token-budget prefill/decode interleave (long
prompts prefill in chunks between decode steps), per-request deadlines and
cancellation, and graceful drain. It is engine-agnostic (SlotEngine or
PagedEngine, duck-typed) and emits the JAX package's serve.* events and
gauges through the port's flight recorder.

One scheduler iteration (`step()`):

  1. reap  — cancelled/deadline-expired requests free their slot NOW
  2. admit — free slots refill from the queue head (FIFO, or DRR across
     tenants)
  3. prefill — up to `prefill_budget` prompt tokens, round-robin over
     prefilling slots; a slot whose final chunk lands emits its first
     token (TTFT) and joins the decode set
  4. decode — ONE fused step advances every decoding slot; eos /
     max_new_tokens finishes a request and releases its slot immediately

The request lifecycle events (serve.request.queued / prefill /
first_token / finished / cancelled, serve.kv.*, serve.prefix.*,
serve.tenant.*) follow tests/schema_validate.py's serving schema.
"""

import itertools
import threading
import time
from collections import deque

import torch

from .. import knobs, telemetry
from .. import tracing
from .paged import PageExhaustedError
from .tenancy import (TenancyConfig, TenantQueues, TenantThrottledError,
                      TokenBudgets)

_request_ids = itertools.count(1)


def _pctl(values, q):
    """Nearest-rank percentile of an unsorted sequence; 0.0 when empty."""
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
    return round(float(ordered[idx]), 3)


class QueueFullError(Exception):
    """Backpressure: the request queue is at capacity."""


class DrainingError(Exception):
    """The scheduler is draining (SIGTERM) and admits no new requests."""


class CapacityError(Exception):
    """The request can NEVER be served by this engine (prompt +
    max_new_tokens exceeds max_seq_len or the whole page pool) — a
    permanent 413 at admission time, not backpressure. Queueing it
    would only fail later, mid-decode or at admit."""


class Request(object):
    """One generation request: prompt tokens in, a stream of generated
    tokens out (thread-safe queue the HTTP layer consumes)."""

    def __init__(self, tokens, max_new_tokens, temperature=0.0, top_k=None,
                 top_p=None, eos_id=None, rng=0, deadline=None,
                 request_id=None, traceparent=None, prefill_only=False,
                 prefilled=None, tenant=None):
        self.id = str(request_id) if request_id is not None \
            else "req-%d" % next(_request_ids)
        # multi-tenancy: None == untagged (single-tenant traffic) — no
        # per-tenant bookkeeping, no serve.tenant.* telemetry
        self.tenant = str(tenant) if tenant else None
        # W3C trace context for this request (minted by the fleet router
        # or the HTTP server; None = untraced). Stamped into every
        # serve.request.* telemetry record.
        self.traceparent = traceparent
        self.tokens = [int(t) for t in tokens]
        if not self.tokens:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.rng = rng
        self.deadline = deadline  # absolute time.time(), or None
        self.generated = []
        self.token_times = []
        self.state = "new"   # queued|prefill|decode|finished|cancelled
        self.reason = None   # eos|length|cancelled|deadline|shutdown
        self.slot = None
        self.out = None      # created on submit
        self.t_submit = None
        self.t_admit = None
        self.t_first = None
        self.t_done = None
        self.admit_iteration = None
        self.finish_iteration = None
        # disaggregation: a prefill-only request stops after its first
        # token and parks {"first", "kv"} in `handoff`; a `prefilled`
        # request carries that dict in and enters decode directly
        self.prefill_only = bool(prefill_only)
        self.prefilled = prefilled
        self.handoff = None
        self._prefix_handle = None   # pinned prefix-cache match
        self._cancelled = threading.Event()

    def cancel(self):
        self._cancelled.set()

    @property
    def cancelled(self):
        return self._cancelled.is_set()

    def stream(self, timeout=None):
        """Yield generated token ids as they land; raises TimeoutError if
        the engine stalls past `timeout` between tokens. Terminates when
        the request finishes (self.reason says why)."""
        import queue as _q

        while True:
            try:
                item = self.out.get(timeout=timeout)
            except _q.Empty:
                raise TimeoutError(
                    "request %s: no token within %.1fs" % (self.id, timeout))
            if item is None:  # terminal sentinel; reason is already set
                return
            yield item

    def result(self, timeout=None):
        """Block until finished; returns the generated token list."""
        for _ in self.stream(timeout=timeout):
            pass
        return list(self.generated)


class Scheduler(object):
    def __init__(self, engine, max_queue=64, prefill_budget=None,
                 prefix_cache=None, tenancy=None):
        self.engine = engine
        self.max_queue = int(max_queue)
        # multi-tenancy: per-tenant DRR queues + budgets (tenancy.py).
        # An empty config (the default) makes every surface below
        # degrade to the exact single-FIFO behavior it replaced.
        self.tenancy = (TenancyConfig.from_env() if tenancy is None
                        else tenancy)
        self._budgets = TokenBudgets(self.tenancy)
        self._tenant_counts = {}     # tenant -> counts dict
        self._tenant_ttft = {}       # tenant -> rolling TTFT window
        # optional RadixPrefixCache: admit seeds the longest cached
        # prefix into the slot, prefill resumes at the boundary, and a
        # finished prefill inserts the slot's KV back for the next hit
        self.prefix_cache = prefix_cache
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens = 0
        self.prefix_prompt_tokens = 0
        # per-iteration prefill token budget: enough to land one chunk
        # per free slot by default, so admission keeps pace with decode
        # without ever stalling active slots behind one long prompt
        self.prefill_budget = int(engine.prefill_chunk * 2
                                  if prefill_budget is None
                                  else prefill_budget)
        if self.prefill_budget < 1:
            raise ValueError("prefill_budget must be >= 1, got %d"
                             % self.prefill_budget)
        self._queue = TenantQueues(self.tenancy)
        self._slots = {}          # slot index -> Request
        self._cond = threading.Condition()
        self._draining = False
        self._stopped = False
        self._thread = None
        self.iteration = 0
        self._prefill_rr = 0      # round-robin cursor over prefill slots
        # paged-engine plumbing (duck-typed: the slot engine has none of
        # these surfaces and every branch degrades to the old behavior)
        self._paged = hasattr(engine, "kv_stats")
        self.kv_exhausted = 0      # admission stalls on page exhaustion
        self._exhausted_blocked = False
        # stats
        self.served = 0
        self.cancelled_count = 0
        self.decode_steps = 0
        self.peak_in_flight = 0
        self._occupancy_sum = 0.0
        # goodput accounting: device-busy seconds split prefill/decode;
        # idle = elapsed - busy (stats()["goodput"], /metrics)
        self.busy_prefill_s = 0.0
        self.busy_decode_s = 0.0
        self._t_started = time.perf_counter()
        # rolling latency windows for /v1/stats and /healthz percentiles:
        # bounded so a long-lived server reports RECENT tail latency, not
        # an all-time blend that a morning incident pollutes forever
        window = knobs.get_int("TPUFLOW_SERVE_LATENCY_WINDOW")
        self._ttft_window = deque(maxlen=max(1, window))
        self._itl_window = deque(maxlen=max(1, window * 4))

    # ---------- intake ----------

    def submit(self, request):
        """Enqueue a request; raises QueueFullError (backpressure),
        DrainingError (shutdown in progress), or CapacityError (the
        request can never fit this engine — reject NOW instead of
        failing after it reaches a slot)."""
        import queue as _q

        fits = getattr(self.engine, "fits", None)
        if fits is not None and not fits(len(request.tokens),
                                         request.max_new_tokens):
            raise CapacityError(
                "prompt (%d) + max_new_tokens (%d) can never fit this "
                "engine (max context %d tokens)"
                % (len(request.tokens), request.max_new_tokens,
                   self.max_context_tokens()))
        tenant = request.tenant
        with self._cond:
            if self._draining or self._stopped:
                raise DrainingError("scheduler is draining")
            if tenant is not None and self.tenancy.enabled():
                self._tenant_admission_locked(request, tenant)
            if len(self._queue) >= self.max_queue:
                # a higher-priority tenant may evict the newest queued
                # request of a lower tier instead of being turned away
                if not self._priority_shed_locked(request):
                    raise QueueFullError(
                        "queue full (%d requests)" % len(self._queue))
            request.out = _q.Queue()
            request.state = "queued"
            request.t_submit = time.time()
            self._queue.append(request)
            depth = len(self._queue)
            tdepth = (self._queue.tenant_depth(tenant)
                      if tenant is not None else 0)
            self._cond.notify_all()
        telemetry.event("serve.request.queued", data=self._tdata(request, {
            "request_id": request.id, "queue_depth": depth,
            "prompt_tokens": len(request.tokens),
            "max_new_tokens": request.max_new_tokens}))
        telemetry.gauge("serve.queue_depth", depth)
        if tenant is not None:
            telemetry.gauge("serve.tenant.queue_depth", tdepth,
                            data={"tenant": tenant})
        return request

    # ---------- multi-tenant admission ----------

    def _counts_for(self, tenant):
        counts = self._tenant_counts.get(tenant)
        if counts is None:
            counts = self._tenant_counts[tenant] = {
                "admitted": 0, "throttled": 0, "shed": 0,
                "prompt_tokens": 0, "generated_tokens": 0}
        return counts

    def _tenant_admission_locked(self, request, tenant):
        """Budget + queue-share checks; raises TenantThrottledError
        with the tenant's OWN Retry-After."""
        share = self.tenancy.share(tenant, self.max_queue)
        if self._queue.tenant_depth(tenant) >= share:
            # back off on the tenant's queue drain rate, not global
            # pressure: its share of slots drains its share of queue
            slots = max(1, self.tenancy.share(
                tenant, self.engine.max_slots))
            wait = min(60, max(1, -(-share // slots)))
            self._throttle(request, tenant, "queue_share", wait)
        cost = len(request.tokens) + request.max_new_tokens
        wait = self._budgets.charge(tenant, cost)
        if wait > 0:
            self._throttle(request, tenant, "budget", wait)

    def _throttle(self, request, tenant, reason, retry_after_s):
        self._counts_for(tenant)["throttled"] += 1
        telemetry.event("serve.tenant.throttled", data=self._tdata(
            request, {"request_id": request.id, "tenant": tenant,
                      "reason": reason,
                      "retry_after_s": round(float(retry_after_s), 3)}))
        raise TenantThrottledError(
            "tenant %s throttled (%s); retry in %.1fs"
            % (tenant, reason, retry_after_s),
            tenant=tenant, reason=reason, retry_after_s=retry_after_s)

    def _priority_shed_locked(self, request):
        """Queue full: a strictly higher-priority submission evicts the
        newest queued request of the worst lower tier. Returns True
        when a slot was freed."""
        if request.tenant is None or not self.tenancy.enabled():
            return False
        victim = self._queue.shed_lowest_priority(
            below_tier=self.tenancy.priority(request.tenant))
        if victim is None:
            return False
        vtenant = victim.tenant or self.tenancy.default_tenant
        self._counts_for(vtenant)["shed"] += 1
        telemetry.event("serve.tenant.shed", data=self._tdata(victim, {
            "request_id": victim.id, "tenant": vtenant,
            "reason": "priority"}))
        self._finish(victim, "shed")
        return True

    def cancel(self, request_id):
        """Flag a queued or in-flight request; the next iteration reaps
        it. Returns True if the id was found."""
        with self._cond:
            for req in list(self._queue) + list(self._slots.values()):
                if req.id == request_id:
                    req.cancel()
                    self._cond.notify_all()
                    return True
        return False

    # ---------- lifecycle helpers ----------

    @staticmethod
    def _tdata(req, data):
        """Stamp the request's trace context into an event payload so the
        trace assembler (cmd/trace.py) can join records across replicas.
        `span` is the dispatch-attempt span the router forwarded — two
        attempts of one request share `trace` but differ in `span`."""
        trace_id, span_id = tracing.traceparent_ids(
            getattr(req, "traceparent", None))
        if trace_id:
            data["trace"] = trace_id
            data["span"] = span_id
        return data

    def _finish(self, req, reason):
        if req.state in ("finished", "cancelled"):
            # terminal already: finishing twice would release a slot
            # that may hold the NEXT occupant, and put a second None
            # sentinel into the stream
            return
        if req.slot is not None:
            if self._paged:
                before = self.engine.pool.free_pages()
                self.engine.release(req.slot)
                freed = self.engine.pool.free_pages() - before
                telemetry.event("serve.kv.page_free", data=self._tdata(
                    req, {"request_id": req.id, "slot": req.slot,
                          "pages": int(freed),
                          "free_pages": self.engine.pool.free_pages()}))
            else:
                self.engine.release(req.slot)
            del self._slots[req.slot]
        if req._prefix_handle is not None:
            # every terminal path drops the pin — including cancel /
            # deadline / shutdown mid-prefill, so no eviction-blocking
            # refs leak from requests that never finished prefill
            self.prefix_cache.release(req._prefix_handle)
            req._prefix_handle = None
        req.reason = reason
        req.t_done = time.time()
        req.finish_iteration = self.iteration
        ok = reason in ("eos", "length", "prefilled")
        req.state = "finished" if ok else "cancelled"
        name = ("serve.request.finished" if ok
                else "serve.request.cancelled")
        data = {"request_id": req.id, "reason": reason,
                "new_tokens": len(req.generated)}
        if req.tenant is not None:
            data["tenant"] = req.tenant
        if req.slot is not None:
            data["slot"] = req.slot
        if req.t_first is not None and req.t_submit is not None:
            data["ttft_ms"] = round((req.t_first - req.t_submit) * 1000, 3)
        if req.t_submit is not None:
            data["total_ms"] = round((req.t_done - req.t_submit) * 1000, 3)
        telemetry.event(name, data=self._tdata(req, data))
        if ok:
            self.served += 1
        else:
            self.cancelled_count += 1
        if req.tenant is not None and req.generated:
            self._counts_for(req.tenant)["generated_tokens"] += len(
                req.generated)
        req.out.put(None)

    def _deliver(self, req, token):
        now = time.time()
        prev = req.token_times[-1] if req.token_times else None
        req.generated.append(token)
        req.token_times.append(now)
        if req.t_first is None:
            req.t_first = now
            ttft_ms = (now - req.t_submit) * 1000
            self._ttft_window.append(ttft_ms)
            if req.tenant is not None:
                window = self._tenant_ttft.get(req.tenant)
                if window is None:
                    window = self._tenant_ttft[req.tenant] = deque(
                        maxlen=self._ttft_window.maxlen)
                window.append(ttft_ms)
            data = {"request_id": req.id, "slot": req.slot,
                    "ttft_ms": round(ttft_ms, 3)}
            if req.tenant is not None:
                data["tenant"] = req.tenant
            telemetry.event("serve.request.first_token",
                            data=self._tdata(req, data))
        elif prev is not None:
            self._itl_window.append((now - prev) * 1000)
        req.out.put(token)
        if req.eos_id is not None and token == req.eos_id:
            self._finish(req, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._finish(req, "length")

    def _reap(self, now):
        for slot, req in list(self._slots.items()):
            if req.cancelled:
                self._finish(req, "cancelled")
            elif req.deadline is not None and now > req.deadline:
                self._finish(req, "deadline")
        with self._cond:
            queued = list(self._queue)
        for req in queued:
            expired = (req.deadline is not None and now > req.deadline)
            if req.cancelled or expired:
                with self._cond:
                    try:
                        self._queue.remove(req)
                    except ValueError:
                        continue
                self._finish(req, "cancelled" if req.cancelled
                             else "deadline")

    def max_context_tokens(self):
        """The largest prompt+max_new this engine can ever hold."""
        mct = getattr(self.engine, "max_context_tokens", None)
        return int(mct() if mct is not None else self.engine.max_seq_len)

    def _kv_exhausted(self, req):
        """Admission blocked on page exhaustion: head-of-line waits
        (FIFO order is preserved — backpressure, not rejection). The
        event fires once per blocked EPISODE, not per spin."""
        if self._exhausted_blocked:
            return
        self._exhausted_blocked = True
        self.kv_exhausted += 1
        telemetry.event("serve.kv.exhausted", data=self._tdata(req, {
            "request_id": req.id,
            "needed_pages": self.engine._pages_needed(
                len(req.tokens), req.max_new_tokens),
            "free_pages": self.engine.pool.free_pages(),
            "queue_depth": len(self._queue)}))

    def _admit(self):
        free = self.engine.free_slots()
        admitted = 0
        can_admit = getattr(self.engine, "can_admit", None)
        for slot in free:
            req = None
            while req is None:
                with self._cond:
                    if not self._queue:
                        return admitted
                    head = self._queue[0]
                    blocked = (
                        can_admit is not None
                        and not head.cancelled
                        and not can_admit(len(head.tokens),
                                          head.max_new_tokens))
                    if blocked:
                        self._kv_exhausted(head)
                        return admitted
                    req = self._queue.popleft()
                # the reap->admit race: a request cancelled (or expired)
                # after _reap scanned the queue but before this pop must
                # finish HERE, without ever taking the slot — admitting
                # it would spend a prefill chunk on a corpse and free
                # the slot a second time one iteration later
                now = time.time()
                expired = (req.deadline is not None and now > req.deadline)
                if req.cancelled or expired:
                    self._finish(req, "cancelled" if req.cancelled
                                 else "deadline")
                    req = None
            try:
                if req.prefilled is not None:
                    # disaggregation decode side: KV arrived with the
                    # request; seed it and skip prefill entirely
                    self.engine.admit_prefilled(
                        slot, req.tokens, req.prefilled["first"],
                        req.prefilled["kv"], req.max_new_tokens,
                        temperature=req.temperature, top_k=req.top_k,
                        top_p=req.top_p, rng=req.rng)
                else:
                    self.engine.admit(
                        slot, req.tokens, req.max_new_tokens,
                        temperature=req.temperature, top_k=req.top_k,
                        top_p=req.top_p, rng=req.rng)
            except PageExhaustedError:
                # backstop: can_admit raced a concurrent alloc (e.g. a
                # prefix-index insert). Requeue at the HEAD — this is
                # backpressure, FIFO order holds, next tick retries.
                with self._cond:
                    self._queue.appendleft(req)
                self._kv_exhausted(req)
                return admitted
            except ValueError as ex:
                # oversized request: reject it, keep serving
                req.reason = "rejected"
                req.state = "cancelled"
                req.error = str(ex)
                telemetry.event("serve.request.cancelled",
                                data=self._tdata(req, {
                                    "request_id": req.id,
                                    "reason": "rejected"}))
                self.cancelled_count += 1
                req.out.put(None)
                continue
            bind = getattr(self.engine, "bind_slot_context", None)
            if bind is not None:
                bind(slot, self._tdata(req, {"request_id": req.id}))
            req.slot = slot
            req.state = "prefill"
            req.t_admit = time.time()
            req.admit_iteration = self.iteration
            self._slots[slot] = req
            admitted += 1
            self.peak_in_flight = max(self.peak_in_flight,
                                      len(self._slots))
            if self._paged:
                # a successful admit ends any exhaustion episode
                self._exhausted_blocked = False
                telemetry.event("serve.kv.page_alloc", data=self._tdata(
                    req, {"request_id": req.id, "slot": slot,
                          "pages": int(self.engine._n_pages[slot]),
                          "free_pages": self.engine.pool.free_pages()}))
            telemetry.event("serve.request.prefill", data=self._tdata(req, {
                "request_id": req.id, "slot": slot,
                "queue_ms": round((req.t_admit - req.t_submit) * 1000, 3)}))
            if req.tenant is not None:
                counts = self._counts_for(req.tenant)
                counts["admitted"] += 1
                counts["prompt_tokens"] += len(req.tokens)
                telemetry.event("serve.tenant.admitted",
                                data=self._tdata(req, {
                                    "request_id": req.id,
                                    "tenant": req.tenant,
                                    "prompt_tokens": len(req.tokens),
                                    "queue_ms": round(
                                        (req.t_admit - req.t_submit)
                                        * 1000, 3)}))
                telemetry.gauge(
                    "serve.tenant.queue_depth",
                    self._queue.tenant_depth(req.tenant),
                    data={"tenant": req.tenant})
            if req.prefilled is not None:
                # already past prefill: emit the first token now so the
                # stream carries ALL tokens and eos/length still apply
                req.state = "decode"
                self._deliver(req, int(req.prefilled["first"]))
            elif self.prefix_cache is not None:
                self._seed_from_cache(req, slot)
        return admitted

    def _seed_from_cache(self, req, slot):
        # match prompt[:-1]: at least one token must prefill so the
        # final chunk's logits exist for first-token sampling
        self.prefix_prompt_tokens += len(req.tokens)
        handle = self.prefix_cache.match(req.tokens[:-1])
        if handle is None:
            self.prefix_misses += 1
            telemetry.event("serve.prefix.miss", data=self._tdata(req, {
                "request_id": req.id,
                "prompt_tokens": len(req.tokens)}))
            return
        if hasattr(handle, "pages"):
            # paged engine + paged index: ZERO-COPY attach — the slot's
            # block table repoints at the shared pages (one device copy
            # only for a partially-filled tail page, CoW)
            self.engine.seed_pages(slot, handle)
            telemetry.event("serve.kv.page_shared", data=self._tdata(
                req, {"request_id": req.id, "slot": slot,
                      "pages": len(handle.pages)
                      + (1 if handle.partial is not None else 0),
                      "tokens": handle.length}))
        else:
            self.engine.seed_prefix(slot, handle.kv())
        req._prefix_handle = handle
        self.prefix_hits += 1
        self.prefix_hit_tokens += handle.length
        telemetry.event("serve.prefix.hit", data=self._tdata(req, {
            "request_id": req.id, "matched_tokens": handle.length,
            "prompt_tokens": len(req.tokens)}))

    def _prefill(self):
        budget = self.prefill_budget
        worked = False
        while budget > 0:
            slots = [s for s, r in sorted(self._slots.items())
                     if r.state == "prefill"]
            if not slots:
                break
            # round-robin so one long prompt cannot starve the others
            self._prefill_rr += 1
            slot = slots[self._prefill_rr % len(slots)]
            req = self._slots[slot]
            t0 = time.perf_counter()
            consumed, first = self.engine.prefill_step(slot)
            # the chunk's attribution comes from the ENGINE's slot
            # binding (bind_slot_context at admit): device work is
            # stamped by the layer that performed it
            ctx = (self.engine.slot_context(slot)
                   if hasattr(self.engine, "slot_context") else None)
            chunk_data = dict(ctx) if ctx \
                else self._tdata(req, {"request_id": req.id})
            chunk_data.update({"slot": slot, "tokens": consumed})
            chunk_s = time.perf_counter() - t0
            self.busy_prefill_s += chunk_s
            telemetry.emit(
                "timer", "serve.prefill_chunk",
                ms=chunk_s * 1000, ok=True,
                data=chunk_data)
            budget -= consumed
            worked = True
            if first is not None:
                self._prefill_done(req, slot, first)
        return worked

    def _prefill_done(self, req, slot, first):
        """The final prefill chunk landed: populate the prefix cache,
        drop the request's pin, and either enter decode or (prefill-only
        mode) park the KV handoff and finish."""
        kv = None
        paged_insert = (self.prefix_cache is not None
                        and hasattr(self.prefix_cache, "insert_pages")
                        and hasattr(self.engine, "slot_prefix_pages"))
        if req.prefill_only or (self.prefix_cache is not None
                                and not paged_insert):
            kv = self.engine.extract_kv(slot, len(req.tokens))
        if paged_insert:
            # paged path: register the slot's OWN pages with the index
            # (it takes its own refs) — no KV bytes move
            full, tail = self.engine.slot_prefix_pages(
                slot, len(req.tokens))
            self.prefix_cache.insert_pages(req.tokens, full, tail)
            if req._prefix_handle is not None:
                self.prefix_cache.release(req._prefix_handle)
                req._prefix_handle = None
        elif self.prefix_cache is not None:
            self.prefix_cache.insert(req.tokens, kv)
            if req._prefix_handle is not None:
                self.prefix_cache.release(req._prefix_handle)
                req._prefix_handle = None
        if req.prefill_only:
            now = time.time()
            req.generated.append(int(first))
            req.token_times.append(now)
            req.t_first = now
            self._ttft_window.append((now - req.t_submit) * 1000)
            telemetry.event("serve.request.first_token",
                            data=self._tdata(req, {
                                "request_id": req.id, "slot": req.slot,
                                "ttft_ms": round(
                                    (now - req.t_submit) * 1000, 3)}))
            req.handoff = {"first": int(first), "kv": kv}
            req.out.put(int(first))
            self._finish(req, "prefilled")
            return
        req.state = "decode"
        self._deliver(req, first)

    def _decode(self):
        active = [r for r in self._slots.values() if r.state == "decode"]
        if not active:
            return False
        t0 = time.perf_counter()
        tokens = self.engine.decode_step()
        step_s = time.perf_counter() - t0
        self.busy_decode_s += step_s
        telemetry.emit(
            "timer", "serve.decode_step",
            ms=step_s * 1000, ok=True,
            data={"active": len(tokens)})
        self.decode_steps += 1
        self._occupancy_sum += self.engine.occupancy()
        telemetry.gauge("serve.batch_occupancy", self.engine.occupancy())
        if self._paged:
            ks = self.engine.kv_stats()
            telemetry.gauge("serve.kv.page_occupancy", ks["occupancy"])
            telemetry.gauge("serve.kv.cow_pages", ks["cow_pages"])
            ss = self.engine.spec_stats()
            if ss["enabled"]:
                telemetry.gauge("serve.spec.accept_rate",
                                ss["accept_rate"])
        for slot, toks in tokens.items():
            req = self._slots.get(slot)
            if req is None:
                continue
            # speculative decode emits up to spec_k+1 tokens per slot
            # per step; eos/length inside the burst stops delivery of
            # the remainder (the engine over-generated, the stream must
            # not)
            for token in (toks if isinstance(toks, list) else [toks]):
                if req.state != "decode":
                    break
                self._deliver(req, token)
        return True

    # ---------- the loop ----------

    def step(self):
        """One scheduler iteration; returns True if any work was done."""
        self._reap(time.time())
        admitted = self._admit()
        prefilled = self._prefill()
        decoded = self._decode()
        self.iteration += 1
        return bool(admitted or prefilled or decoded)

    def pending(self):
        with self._cond:
            return len(self._queue) + len(self._slots)

    def run_until_idle(self, max_iterations=None):
        """Drive step() until queue and slots are empty (bench/tests —
        no thread)."""
        n = 0
        while self.pending():
            self.step()
            n += 1
            if max_iterations is not None and n >= max_iterations:
                raise RuntimeError(
                    "scheduler did not go idle in %d iterations"
                    % max_iterations)
        return n

    def _loop(self):
        # torch.inference_mode() is thread-local: the loop thread enters it
        # itself (entering it where the engine was built does not carry
        # over); the engine's device is its own, never the "current" one
        with torch.inference_mode():
            self._run_loop()

    def _run_loop(self):
        while True:
            with self._cond:
                if self._stopped:
                    break
                if self._draining and not self._queue and not self._slots:
                    break
            if not self.step():
                with self._cond:
                    if (self._stopped
                            or (self._draining and not self._queue
                                and not self._slots)):
                        break
                    self._cond.wait(timeout=0.02)
        # loop exit: anything still queued/in-flight dies with "shutdown"
        with self._cond:
            leftovers = list(self._queue) + list(self._slots.values())
            self._queue.clear()
        for req in leftovers:
            self._finish(req, "shutdown")

    def start(self):
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="tpuflow-serve-scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def drain(self, timeout=None):
        """Graceful shutdown (SIGTERM): stop admitting NEW submissions,
        finish everything already accepted, then stop the loop. Returns
        True once the loop has exited."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            return not self._thread.is_alive()
        # no thread: drive synchronously
        self.run_until_idle()
        return True

    def stop(self):
        """Hard stop: in-flight and queued requests finish as
        'shutdown'."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def stats(self):
        with self._cond:
            depth = len(self._queue)
            in_flight = len(self._slots)
            tenant_depths = self._queue.depths()
        return {
            "tenancy": self.tenant_stats(tenant_depths),
            "queue_depth": depth,
            "in_flight": in_flight,
            "slots": self.engine.max_slots,
            "occupancy": self.engine.occupancy(),
            "mean_batch_occupancy": (
                round(self._occupancy_sum / self.decode_steps, 4)
                if self.decode_steps else 0.0),
            "served": self.served,
            "cancelled": self.cancelled_count,
            "decode_steps": self.decode_steps,
            "iterations": self.iteration,
            "draining": self._draining,
            # rolling-window tail latency (the SLO monitor's poll surface)
            "p50_ttft_ms": _pctl(list(self._ttft_window), 0.50),
            "p99_ttft_ms": _pctl(list(self._ttft_window), 0.99),
            "p50_itl_ms": _pctl(list(self._itl_window), 0.50),
            "p99_itl_ms": _pctl(list(self._itl_window), 0.99),
            "peak_in_flight": self.peak_in_flight,
            "max_context_tokens": self.max_context_tokens(),
            "prefix_cache": self.prefix_stats(),
            "kv_pages": self.kv_pages_stats(),
            "speculative": (self.engine.spec_stats() if self._paged
                            else {"enabled": False}),
            "goodput": self.goodput_stats(),
        }

    def tenant_stats(self, tenant_depths=None):
        """Per-tenant admission/latency rollup for /v1/stats and the
        `tpuflow metrics`/`watch` tenant sections."""
        if tenant_depths is None:
            with self._cond:
                tenant_depths = self._queue.depths()
        tenants = {}
        # the default bucket holds UNTAGGED requests — it only shows up
        # here if a tagged tenant actually uses that name
        names = (set(self._tenant_counts)
                 | set(self.tenancy.known_tenants())
                 | (set(tenant_depths)
                    - {self.tenancy.default_tenant}))
        for t in sorted(names):
            counts = self._tenant_counts.get(t) or {
                "admitted": 0, "throttled": 0, "shed": 0,
                "prompt_tokens": 0, "generated_tokens": 0}
            window = list(self._tenant_ttft.get(t, ()))
            tenants[t] = {
                "queued": tenant_depths.get(t, 0),
                "admitted": counts["admitted"],
                "throttled": counts["throttled"],
                "shed": counts["shed"],
                "prompt_tokens": counts["prompt_tokens"],
                "generated_tokens": counts["generated_tokens"],
                "priority": self.tenancy.priority_name(t),
                "weight": self.tenancy.weight(t),
                "p50_ttft_ms": _pctl(window, 0.50),
                "p99_ttft_ms": _pctl(window, 0.99),
            }
        return {"enabled": self.tenancy.enabled(), "tenants": tenants}

    def goodput_stats(self):
        """Chip-second split in the goodput taxonomy
        (metaflow_tpu/goodput.py): device-busy prefill/decode seconds
        plus the scheduler-lifetime remainder as idle."""
        elapsed = max(0.0, time.perf_counter() - self._t_started)
        busy = self.busy_prefill_s + self.busy_decode_s
        return {
            "serve_prefill_s": round(self.busy_prefill_s, 3),
            "serve_decode_s": round(self.busy_decode_s, 3),
            "serve_idle_s": round(max(0.0, elapsed - busy), 3),
            "elapsed_s": round(elapsed, 3),
        }

    def kv_pages_stats(self):
        """Page-pool health for /v1/stats and /healthz; {"enabled":
        False} on the slot engine so the schema stays total."""
        if not self._paged:
            return {"enabled": False}
        out = self.engine.kv_stats()
        out["exhausted"] = self.kv_exhausted
        return out

    def prefix_stats(self):
        """Prefix-cache effectiveness for /v1/stats and /healthz.
        `prefill_tokens_skipped_frac` is the FLOPs-skip proxy: prefill
        cost is linear in tokens at fixed model size, so the fraction of
        prompt tokens served from cache IS the fraction of prefill FLOPs
        never spent (the ROADMAP >=90% gate measures this)."""
        out = {
            "enabled": self.prefix_cache is not None,
            "hits": self.prefix_hits,
            "misses": self.prefix_misses,
            "hit_rate": round(
                self.prefix_hits
                / max(1, self.prefix_hits + self.prefix_misses), 4),
            "hit_tokens": self.prefix_hit_tokens,
            "prompt_tokens": self.prefix_prompt_tokens,
            "prefill_tokens_skipped_frac": round(
                self.prefix_hit_tokens
                / max(1, self.prefix_prompt_tokens), 4),
        }
        if self.prefix_cache is not None:
            out.update(self.prefix_cache.stats())
            # cache-aware routing summary: the compact digest set the
            # fleet router scores dispatch against (cache_router.py).
            # Rides the stats/healthz channel — no new wire protocol.
            block = self.route_block()
            out["route_block"] = block
            out["digests"] = self.prefix_cache.route_digests(
                block,
                limit=knobs.get_int("TPUFLOW_CACHE_ROUTE_DIGESTS"))
        return out

    def route_block(self):
        """The digest block size this replica publishes: a paged index
        digests at page granularity (its keys ARE page-chain digests),
        the radix cache at the configured routing block."""
        if self.prefix_cache is None:
            return 0
        return int(getattr(self.prefix_cache, "page_tokens", 0)
                   or knobs.get_int("TPUFLOW_CACHE_ROUTE_BLOCK"))
