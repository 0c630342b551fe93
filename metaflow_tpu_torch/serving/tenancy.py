"""Multi-tenant admission, ported from the JAX package: the policy layer
the scheduler consults.

  * TenancyConfig — declarative tenant classes from TPUFLOW_TENANT_*
    knobs: DRR weight, priority class (high/normal/low) and an optional
    token budget per rolling window. Unconfigured == single-tenant and
    every surface degrades to the exact pre-tenancy behavior.
  * TenantQueues — per-tenant FIFOs behind a deque-compatible facade:
    strict priority tiers, deficit-round-robin (DRR) within a tier.
  * TokenBudgets — per-tenant token buckets over a rolling window; the
    refusal carries the seconds until the tenant's OWN window resets.

TenantThrottledError is defined here (the JAX package keeps it in
scheduler.py, which imports it from here in the port). The federation
front tier (FederationRouter) waits for the fleet slice.

DRR admission math (per priority tier): each tenant t has a deficit
counter D_t. When no queued head is affordable, every active tenant is
credited quantum * weight_t; the first tenant whose head request cost
(prompt_tokens + max_new_tokens) <= D_t is served and pays its cost.
"""

import threading
import time
from collections import deque

from .. import knobs

class TenantThrottledError(Exception):
    """Per-tenant admission control rejected the request (token budget
    exhausted or queue share exceeded). Carries the TENANT-scoped
    Retry-After — a throttled low-priority tenant must not inherit the
    global capacity hint."""

    def __init__(self, message, tenant, reason, retry_after_s):
        super(TenantThrottledError, self).__init__(message)
        self.tenant = tenant
        self.reason = reason          # "budget" | "queue_share"
        self.retry_after_s = float(retry_after_s)


PRIORITY_CLASSES = {"high": 0, "normal": 1, "low": 2}
_PRIORITY_NAMES = {v: k for k, v in PRIORITY_CLASSES.items()}


def _parse_kv_spec(spec):
    """'gold=4,free=1' -> {'gold': '4', 'free': '1'}; empty/garbage-safe
    (a malformed entry is dropped, matching the knob registry's
    malformed-value contract)."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        name, value = part.split("=", 1)
        if name.strip():
            out[name.strip()] = value.strip()
    return out


class TenancyConfig(object):
    """Declarative per-tenant policy: DRR weights, priority classes and
    token budgets. Empty config == single-tenant (enabled() False) and
    every consumer falls back to pre-tenancy behavior."""

    def __init__(self, weights=None, priorities=None, budgets=None,
                 default_tenant="default", quantum=256,
                 budget_window_s=10.0):
        self.weights = {}
        for t, w in (weights or {}).items():
            try:
                w = float(w)
            except (TypeError, ValueError):
                continue
            if w > 0:
                self.weights[str(t)] = w
        self.priorities = {}
        for t, p in (priorities or {}).items():
            if isinstance(p, str) and p.lower() in PRIORITY_CLASSES:
                self.priorities[str(t)] = PRIORITY_CLASSES[p.lower()]
            else:
                try:
                    self.priorities[str(t)] = int(p)
                except (TypeError, ValueError):
                    continue
        self.budgets = {}
        for t, b in (budgets or {}).items():
            try:
                b = int(float(b))
            except (TypeError, ValueError):
                continue
            if b > 0:
                self.budgets[str(t)] = b
        self.default_tenant = str(default_tenant or "default")
        self.quantum = max(1, int(quantum))
        self.budget_window_s = max(0.1, float(budget_window_s))

    @classmethod
    def from_env(cls):
        return cls(
            weights=_parse_kv_spec(knobs.get_str("TPUFLOW_TENANT_WEIGHTS")),
            priorities=_parse_kv_spec(
                knobs.get_str("TPUFLOW_TENANT_PRIORITIES")),
            budgets=_parse_kv_spec(knobs.get_str("TPUFLOW_TENANT_BUDGETS")),
            default_tenant=knobs.get_str("TPUFLOW_TENANT_DEFAULT"),
            quantum=knobs.get_int("TPUFLOW_TENANT_QUANTUM"),
            budget_window_s=knobs.get_float(
                "TPUFLOW_TENANT_BUDGET_WINDOW_S"),
        )

    def enabled(self):
        return bool(self.weights or self.priorities or self.budgets)

    def weight(self, tenant):
        return self.weights.get(tenant, 1.0)

    def priority(self, tenant):
        return self.priorities.get(tenant, PRIORITY_CLASSES["normal"])

    def priority_name(self, tenant):
        return _PRIORITY_NAMES.get(self.priority(tenant), "normal")

    def budget(self, tenant):
        return self.budgets.get(tenant)

    def known_tenants(self):
        return sorted(set(self.weights) | set(self.priorities)
                      | set(self.budgets))

    def share(self, tenant, capacity):
        """`tenant`'s weight-proportional share of an integer capacity
        (queue slots, inflight budget), never below 1."""
        total = sum(self.weights.get(t, 1.0)
                    for t in set(self.known_tenants()) | {tenant})
        return max(1, int(capacity * self.weight(tenant)
                          / max(1.0, total)))

    def low_priority_share(self, capacity):
        """The collective capacity share of every NON-high tier: what
        the fleet router caps background tenants at so a saturating
        low-priority tenant leaves headroom for high-priority traffic.
        Full capacity when no high-priority tenant is configured."""
        tenants = self.known_tenants()
        if not any(self.priority(t) == PRIORITY_CLASSES["high"]
                   for t in tenants):
            return capacity
        total = sum(self.weight(t) for t in tenants) or 1.0
        low = sum(self.weight(t) for t in tenants
                  if self.priority(t) != PRIORITY_CLASSES["high"])
        return max(1, int(capacity * low / total))

    def describe(self):
        return {
            "enabled": self.enabled(),
            "tenants": {
                t: {"weight": self.weight(t),
                    "priority": self.priority_name(t),
                    "budget_tokens": self.budget(t)}
                for t in self.known_tenants()},
            "quantum": self.quantum,
            "budget_window_s": self.budget_window_s,
        }


class TenantQueues(object):
    """Per-tenant FIFOs behind the deque surface the scheduler already
    speaks (`append`/`appendleft`/`popleft`/`[0]`/`remove`/iteration):
    strict priority tiers, DRR within a tier, exact FIFO within a
    tenant. Single-bucket operation (nothing configured, or one active
    tenant) short-circuits to plain FIFO — bit-identical to the deque
    it replaces. NOT internally locked: the scheduler serializes every
    call under its own condition variable, and peek-then-pop under that
    lock always returns the same request."""

    MAX_CREDIT_ROUNDS = 64   # bounds the DRR credit loop per pick

    def __init__(self, config=None):
        self.config = config or TenancyConfig()
        self._queues = {}     # tenant -> deque[Request]
        self._rr = []         # rotation order (every tenant ever seen)
        self._deficit = {}
        self._len = 0

    def _bucket(self, req):
        return getattr(req, "tenant", None) or self.config.default_tenant

    @staticmethod
    def _cost(req):
        # the DRR cost unit is TOKENS, not requests: one tenant sending
        # huge prompts cannot out-admit a tenant sending small ones
        return len(req.tokens) + req.max_new_tokens

    def append(self, req):
        t = self._bucket(req)
        q = self._queues.get(t)
        if q is None:
            q = self._queues[t] = deque()
            self._rr.append(t)
            self._deficit.setdefault(t, 0.0)
        q.append(req)
        self._len += 1

    def appendleft(self, req):
        """Head requeue (page-exhaustion backpressure): FIFO order holds
        and the tenant's already-paid DRR cost is refunded."""
        t = self._bucket(req)
        q = self._queues.get(t)
        if q is None:
            q = self._queues[t] = deque()
            self._rr.append(t)
            self._deficit.setdefault(t, 0.0)
        q.appendleft(req)
        self._deficit[t] = self._deficit.get(t, 0.0) + self._cost(req)
        self._len += 1

    def remove(self, req):
        q = self._queues.get(self._bucket(req))
        if q is None:
            raise ValueError("request not queued")
        q.remove(req)   # ValueError when absent, like deque.remove
        self._len -= 1

    def clear(self):
        for q in self._queues.values():
            q.clear()
        self._len = 0

    def __len__(self):
        return self._len

    def __bool__(self):
        return self._len > 0

    def __iter__(self):
        for t in list(self._rr):
            for req in list(self._queues.get(t, ())):
                yield req

    def __getitem__(self, idx):
        if idx != 0:
            raise IndexError("only head peek is supported")
        req = self._pick(consume=False)
        if req is None:
            raise IndexError("peek from empty queue")
        return req

    def popleft(self):
        req = self._pick(consume=True)
        if req is None:
            raise IndexError("pop from an empty queue")
        return req

    def depths(self):
        return {t: len(q) for t, q in self._queues.items() if q}

    def tenant_depth(self, tenant):
        q = self._queues.get(tenant or self.config.default_tenant)
        return len(q) if q else 0

    # ---------- the DRR pick ----------

    def _active_tier(self):
        tiers = {}
        for t in self._rr:
            q = self._queues.get(t)
            if q:
                tiers.setdefault(self.config.priority(t), []).append(t)
        if not tiers:
            return []
        return tiers[min(tiers)]

    def _pick(self, consume):
        active = self._active_tier()
        if not active:
            return None
        if len(active) == 1:
            t = active[0]
        else:
            t = None
            for _ in range(self.MAX_CREDIT_ROUNDS):
                for cand in active:
                    if (self._deficit[cand]
                            >= self._cost(self._queues[cand][0])):
                        t = cand
                        break
                if t is not None:
                    break
                # classic DRR credit pass: one quantum * weight each
                for cand in active:
                    self._deficit[cand] += (self.config.quantum
                                            * self.config.weight(cand))
            if t is None:
                t = active[0]   # cost >> credit cap: serve head anyway
        if not consume:
            return self._queues[t][0]
        req = self._queues[t].popleft()
        self._len -= 1
        if len(active) > 1:
            self._deficit[t] = max(
                0.0, self._deficit[t] - self._cost(req))
            # rotate the served tenant to the back so ties cycle
            self._rr.remove(t)
            self._rr.append(t)
        return req

    def shed_lowest_priority(self, below_tier):
        """Evict (and return) the NEWEST queued request of the worst
        tenant whose tier is strictly lower-priority than `below_tier`;
        None when no such victim exists. Newest-first keeps the victim
        tenant's oldest (closest to service) work intact."""
        worst_t, worst_tier = None, below_tier
        for t in self._rr:
            q = self._queues.get(t)
            if not q:
                continue
            tier = self.config.priority(t)
            if tier > worst_tier:
                worst_t, worst_tier = t, tier
        if worst_t is None:
            return None
        victim = self._queues[worst_t].pop()
        self._len -= 1
        return victim


class TokenBudgets(object):
    """Per-tenant token buckets over a rolling window. charge() returns
    0.0 on admit or the seconds until the tenant's own window resets —
    the Retry-After a throttled tenant gets instead of the global
    capacity hint. A tenant with no configured budget is never
    throttled. Thread-safe (the fleet router and scheduler both call
    it from handler threads)."""

    def __init__(self, config):
        self.config = config
        self._lock = threading.Lock()
        self._window_start = time.monotonic()
        self._spent = {}

    def charge(self, tenant, tokens, now=None):
        budget = self.config.budget(tenant)
        if budget is None:
            return 0.0
        now = time.monotonic() if now is None else now
        with self._lock:
            if now - self._window_start >= self.config.budget_window_s:
                self._window_start = now
                self._spent.clear()
            spent = self._spent.get(tenant, 0)
            if spent >= budget:
                return max(0.1, self.config.budget_window_s
                           - (now - self._window_start))
            # admit-then-charge: one oversized request may overshoot the
            # budget rather than starve forever behind it
            self._spent[tenant] = spent + int(tokens)
            return 0.0

    def spent(self, tenant):
        with self._lock:
            return self._spent.get(tenant, 0)

