"""Continuous-batching serving, in PyTorch: the slot engine, the paged-KV
engine with speculative decoding, the request scheduler, the HTTP API, the
prefix caches and the prefill/decode handoff frame. The replica fleet, the
cache-aware router and the federation front tier wait for the fleet
slice."""

from .disagg import decode_handoff, encode_handoff
from .engine import SlotEngine, request_step_keys, sample_slots
from .paged import (
    PagedEngine,
    PageExhaustedError,
    PagePool,
    ngram_draft,
)
from .prefix_cache import (
    PagedPrefixHandle,
    PagedPrefixIndex,
    PrefixHandle,
    RadixPrefixCache,
    route_digest_chain,
)
from .scheduler import (
    CapacityError,
    DrainingError,
    QueueFullError,
    Request,
    Scheduler,
    TenantThrottledError,
)
from .server import ServingServer, retry_after_hint
from .tenancy import TenancyConfig, TenantQueues, TokenBudgets

__all__ = [
    "SlotEngine",
    "PagedEngine",
    "PagePool",
    "PageExhaustedError",
    "ngram_draft",
    "request_step_keys",
    "sample_slots",
    "Request",
    "Scheduler",
    "QueueFullError",
    "DrainingError",
    "CapacityError",
    "ServingServer",
    "RadixPrefixCache",
    "PrefixHandle",
    "PagedPrefixIndex",
    "PagedPrefixHandle",
    "encode_handoff",
    "decode_handoff",
    "retry_after_hint",
    "route_digest_chain",
    "TenancyConfig",
    "TenantQueues",
    "TokenBudgets",
    "TenantThrottledError",
]
