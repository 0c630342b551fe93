"""Prefix caches for the serving scheduler, ported from the JAX package.

RadixPrefixCache: a compressed radix tree over prompt tokens whose nodes
carry host-side KV ranges (CPU torch tensors); on admit the scheduler
seeds the longest cached prefix into the slot (seed_prefix) and starts
chunked prefill at the match boundary; a finished prefill inserts the
slot's KV back (extract_kv). match() returns a PIN — every node on the
matched path is ref-counted until release(), so LRU eviction (byte budget,
leaf-first) never frees KV an in-flight request still depends on.

PagedPrefixIndex: the paged engine's zero-copy counterpart. A FULL page of
prompt tokens is keyed by the sha1 digest chain of every page before it
plus its own tokens; a hit points the new slot's block table at the SAME
device pages (PagedEngine.seed_pages). A partially filled tail page is
shared through copy-on-write.

The digest chain (route_digest_chain, route_digests, the index's page
keys) hashes the tokens as little-endian int32, as the JAX package does,
so both packages give the same digests for the same tokens and routers
can compare them across replicas.
"""

import hashlib
import threading

import numpy as np
import torch

from .. import knobs, telemetry


def _as_tokens(tokens):
    return np.asarray(tokens, np.int32).reshape(-1)


def _host(a):
    """A KV range as a CPU tensor (numpy arrays are taken as they are)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu")
    return torch.from_numpy(np.asarray(a))


def _nbytes(t):
    return int(t.numel()) * t.element_size()


def _common_prefix(a, b):
    n = min(a.size, b.size)
    if n == 0:
        return 0
    eq = a[:n] == b[:n]
    if eq.all():
        return n
    return int(np.argmin(eq))


# ---------------------------------------------------------------------------
# Routing digests: the compact prefix summary replicas publish through
# /healthz so the fleet router can score "who already holds this prompt's
# longest prefix" without shipping token sequences over the wire. The
# vocabulary is a rolling sha1 chain over BLOCK-aligned token blocks —
# identical to the paged index's page-key chain, so for a paged replica
# the published digests ARE its cached page keys. A digest identifies
# both content and position (the chain folds in everything before it),
# so set-membership of the request's chain against a replica's digest
# set is exactly "this block-aligned prefix is cached there".
# ---------------------------------------------------------------------------

ROUTE_DIGEST_HEX = 16     # published hex chars per digest (64-bit)


def _chain_key(prev_key, tokens):
    h = hashlib.sha1(prev_key)
    h.update(np.ascontiguousarray(tokens, np.int32).tobytes())
    return h.digest()


def route_digest_chain(tokens, block):
    """The rolling block-digest chain of a token sequence: one hex
    digest per complete `block`-token prefix, in prefix order. The
    router computes this for a request's prompt; replicas publish the
    same chains for their cached prefixes."""
    tokens = _as_tokens(tokens)
    block = int(block)
    if block <= 0:
        return []
    out = []
    key = b"root"
    for i in range(tokens.size // block):
        key = _chain_key(key, tokens[i * block:(i + 1) * block])
        out.append(key.hex()[:ROUTE_DIGEST_HEX])
    return out


class _Node(object):
    __slots__ = ("tokens", "k", "v", "children", "parent", "refs",
                 "last_use")

    def __init__(self, tokens, k, v, parent):
        self.tokens = tokens          # np.int32 [T] edge labels
        self.k = k                    # [layers, T, kv_heads, head_dim] CPU
        self.v = v
        self.children = {}            # first token -> _Node
        self.parent = parent
        self.refs = 0
        self.last_use = 0

    def nbytes(self):
        if self.k is None:
            return 0
        return _nbytes(self.k) + _nbytes(self.v)


class PrefixHandle(object):
    """A pinned match: `length` cached tokens and the KV that backs
    them. Hold it until the request is past prefill (or dead), then
    release() exactly once."""

    __slots__ = ("_nodes", "_parts", "length", "_released")

    def __init__(self, nodes, parts, length):
        self._nodes = nodes           # pinned path, root-exclusive
        self._parts = parts           # [(k_view, v_view), ...] in order
        self.length = length
        self._released = False

    def kv(self):
        """{"k": [layers, length, kv_heads, head_dim], "v": ...} — the
        cached KV for the matched prefix, concatenated host-side (CPU
        tensors)."""
        ks = [p[0] for p in self._parts]
        vs = [p[1] for p in self._parts]
        if len(ks) == 1:
            return {"k": ks[0], "v": vs[0]}
        return {"k": torch.cat(ks, dim=1), "v": torch.cat(vs, dim=1)}


class RadixPrefixCache(object):
    """Compressed radix tree over prompt tokens with per-node KV ranges,
    ref-count pinning and LRU leaf eviction under a byte budget."""

    def __init__(self, max_bytes):
        self.max_bytes = int(max_bytes)
        if self.max_bytes <= 0:
            raise ValueError("max_bytes must be > 0")
        self._root = _Node(np.zeros(0, np.int32), None, None, None)
        self._lock = threading.Lock()
        self._clock = 0
        self._bytes = 0
        self._nodes = 0
        self._tokens = 0
        self._evicted_nodes = 0
        self._evicted_tokens = 0
        self._evictions = 0           # evict() sweeps that freed memory

    @classmethod
    def from_env(cls, default_mb=0):
        """Build from TPUFLOW_PREFIX_CACHE_MB, or None when the budget
        is 0 (the cache is opt-in: no budget, no cache)."""
        mb = knobs.get_float("TPUFLOW_PREFIX_CACHE_MB",
                             fallback=default_mb)
        if mb <= 0:
            return None
        return cls(int(mb * 1024 * 1024))

    # ---------- lookup ----------

    def match(self, tokens):
        """Longest cached prefix of `tokens`: a pinned PrefixHandle, or
        None on a zero-length match. Callers cap reuse themselves (the
        scheduler matches prompt[:-1] so at least one token prefills and
        final-chunk logits exist for first-token sampling)."""
        tokens = _as_tokens(tokens)
        with self._lock:
            self._clock += 1
            node = self._root
            i = 0
            nodes, parts = [], []
            while i < tokens.size:
                child = node.children.get(int(tokens[i]))
                if child is None:
                    break
                common = _common_prefix(child.tokens, tokens[i:])
                if common == 0:
                    break
                child.last_use = self._clock
                nodes.append(child)
                parts.append((child.k[:, :common], child.v[:, :common]))
                i += common
                if common < child.tokens.size:
                    break
                node = child
            if i == 0:
                return None
            for n in nodes:
                n.refs += 1
            return PrefixHandle(nodes, parts, i)

    def release(self, handle):
        """Drop a match's pins. Idempotent per handle."""
        if handle is None or handle._released:
            return
        handle._released = True
        with self._lock:
            for n in handle._nodes:
                n.refs -= 1

    # ---------- insert / evict ----------

    def insert(self, tokens, kv):
        """Cache the KV for `tokens` (kv: {"k": [layers, T, kv_heads,
        head_dim], "v": ...}, T == len(tokens)). Shared prefixes with
        existing entries are deduplicated via node splits; only the
        novel suffix adds bytes. Evicts LRU leaves if over budget."""
        tokens = _as_tokens(tokens)
        k, v = _host(kv["k"]), _host(kv["v"])
        if k.shape[1] != tokens.size:
            raise ValueError("kv length %d != token count %d"
                             % (k.shape[1], tokens.size))
        with self._lock:
            self._clock += 1
            node = self._root
            i = 0
            while i < tokens.size:
                child = node.children.get(int(tokens[i]))
                if child is None:
                    # copy the suffix: a view would pin the caller's FULL
                    # prompt-KV buffer, breaking the byte-budget accounting
                    leaf = _Node(tokens[i:].copy(), k[:, i:].clone(),
                                 v[:, i:].clone(), node)
                    leaf.last_use = self._clock
                    node.children[int(tokens[i])] = leaf
                    self._bytes += leaf.nbytes()
                    self._nodes += 1
                    self._tokens += int(leaf.tokens.size)
                    break
                child.last_use = self._clock
                common = _common_prefix(child.tokens, tokens[i:])
                if common < child.tokens.size:
                    # split the edge: a NEW prefix node takes the head;
                    # `child` (possibly pinned) keeps its object identity
                    # and becomes the suffix below it
                    mid = _Node(child.tokens[:common], child.k[:, :common],
                                child.v[:, :common], node)
                    mid.last_use = self._clock
                    node.children[int(child.tokens[0])] = mid
                    child.tokens = child.tokens[common:]
                    child.k = child.k[:, common:]
                    child.v = child.v[:, common:]
                    child.parent = mid
                    mid.children[int(child.tokens[0])] = child
                    self._nodes += 1
                    node = mid
                    i += common
                    continue
                node = child
                i += common
            self._evict_locked()

    def _evict_locked(self):
        freed_nodes = freed_tokens = freed_bytes = 0
        while self._bytes > self.max_bytes:
            victim = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n is self._root or n.children or n.refs > 0:
                    continue
                if victim is None or n.last_use < victim.last_use:
                    victim = n
            if victim is None:
                break  # everything left is pinned or interior
            victim.parent.children.pop(int(victim.tokens[0]))
            nb = victim.nbytes()
            self._bytes -= nb
            self._nodes -= 1
            self._tokens -= int(victim.tokens.size)
            freed_nodes += 1
            freed_tokens += int(victim.tokens.size)
            freed_bytes += nb
        if freed_nodes:
            self._evictions += 1
            self._evicted_nodes += freed_nodes
            self._evicted_tokens += freed_tokens
            telemetry.event("serve.prefix.evict", data={
                "nodes": freed_nodes, "tokens": freed_tokens,
                "bytes": freed_bytes})

    # ---------- introspection ----------

    def pinned_nodes(self):
        with self._lock:
            count = 0
            stack = [self._root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n is not self._root and n.refs > 0:
                    count += 1
            return count

    def stats(self):
        with self._lock:
            return {
                "nodes": self._nodes,
                "cached_tokens": self._tokens,
                "cached_bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "evictions": self._evictions,
                "evicted_nodes": self._evicted_nodes,
                "evicted_tokens": self._evicted_tokens,
            }

    def route_digests(self, block, limit=512):
        """Block-digest summary of every cached prefix (newest-capped):
        the compact routing vocabulary published through /healthz. A
        radix edge can end mid-block; the partial remainder rides down
        to the children, so only block-aligned prefixes produce
        digests — the same alignment the router's request chain uses."""
        block = int(block)
        if block <= 0:
            return []
        out = []
        with self._lock:
            empty = np.zeros(0, np.int32)
            stack = [(self._root, b"root", empty)]
            while stack and len(out) < limit:
                node, key, rem = stack.pop()
                if node is self._root:
                    toks = rem
                else:
                    toks = np.concatenate([rem, node.tokens])
                n_full = toks.size // block
                for i in range(n_full):
                    key = _chain_key(key,
                                     toks[i * block:(i + 1) * block])
                    out.append(key.hex()[:ROUTE_DIGEST_HEX])
                    if len(out) >= limit:
                        break
                rem = toks[n_full * block:]
                for child in node.children.values():
                    stack.append((child, key, rem))
        return out


# ---------------------------------------------------------------------------
# Page-granular prefix index (the paged engine's zero-copy counterpart)
# ---------------------------------------------------------------------------


class _PageEntry(object):
    __slots__ = ("pid", "key", "prev", "last_use")

    def __init__(self, pid, key, prev, last_use):
        self.pid = pid          # device page id (index-owned pool ref)
        self.key = key
        self.prev = prev        # parent chain key (eviction bookkeeping)
        self.last_use = last_use


class _TailEntry(object):
    __slots__ = ("pid", "tokens", "last_use")

    def __init__(self, pid, tokens, last_use):
        self.pid = pid
        self.tokens = tokens    # np.int32 [<page_tokens] valid prefix
        self.last_use = last_use


class PagedPrefixHandle(object):
    """A pinned page-granular match: `pages` full device pages holding
    the first len(pages)*page_tokens prompt tokens verbatim, plus an
    optional `partial` (page_id, n_tokens) tail the engine privatizes
    with one copy-on-write page copy. `length` is the total matched
    token count. The handle holds one pool ref per referenced page
    until release()."""

    __slots__ = ("pages", "length", "partial", "_pool", "_released")

    def __init__(self, pool, pages, length, partial):
        self.pages = pages
        self.length = length
        self.partial = partial
        self._pool = pool
        self._released = False


class PagedPrefixIndex(object):
    """Prefix reuse at PAGE granularity over the paged engine's pool —
    the zero-copy successor of the radix tree above (vLLM hash-chain
    lineage). A FULL page of prompt tokens is keyed by the digest chain
    of every page before it plus its own tokens, so a key identifies
    both content and position; a hit points the new slot's block table
    at the SAME device pages (PagedEngine.seed_pages) and no KV bytes
    move. A partially-filled tail page is indexed with its token prefix
    and shared via copy-on-write (the one copy a hit can cost).

    Ownership: the index holds ONE pool ref per registered page, so
    "eviction" is simply dropping that ref — a page a live slot still
    reads survives until its last ref drains, which is what makes
    eviction always safe (no pinned_nodes() dance needed). match()
    additionally refs every returned page for the handle's lifetime so
    an eviction between match and seed cannot free them.
    """

    MAX_TAILS_PER_CHAIN = 4   # bounded CoW candidates per chain point

    def __init__(self, pool, max_pages=None):
        self.pool = pool
        self.page_tokens = pool.page_tokens
        # default budget: the whole pool — the refcounts already keep
        # live pages safe, and unreferenced cached pages are exactly
        # what a KV cache is for
        self.max_pages = int(max_pages) if max_pages else pool.usable_pages
        if self.max_pages < 1:
            raise ValueError("max_pages must be >= 1")
        self._lock = threading.Lock()
        self._full = {}       # chain key -> _PageEntry
        self._tails = {}      # chain key -> [_TailEntry, ...]
        self._clock = 0
        self._evictions = 0
        self._evicted_pages = 0

    @classmethod
    def from_env(cls, pool, default_mb=0):
        """Budget from TPUFLOW_PREFIX_CACHE_MB (page-rounded); 0/unset
        disables — the same opt-in contract as RadixPrefixCache."""
        mb = knobs.get_float("TPUFLOW_PREFIX_CACHE_MB",
                             fallback=default_mb)
        if mb <= 0:
            return None
        pages = max(1, int(mb * 1024 * 1024) // max(1, pool.page_bytes()))
        return cls(pool, max_pages=min(pages, pool.usable_pages))

    @staticmethod
    def _chain(prev_key, tokens):
        # shared with route_digest_chain: a paged replica's published
        # routing digests are literally its cached page keys
        return _chain_key(prev_key, tokens)

    # ---------- lookup ----------

    def match(self, tokens):
        """Longest page-aligned cached prefix of `tokens` (plus at most
        one partial tail page): a pinned PagedPrefixHandle, or None."""
        tokens = _as_tokens(tokens)
        ptok = self.page_tokens
        with self._lock:
            self._clock += 1
            key = b"root"
            pages = []
            n_full = tokens.size // ptok
            for i in range(n_full):
                page = tokens[i * ptok:(i + 1) * ptok]
                key = self._chain(key, page)
                entry = self._full.get(key)
                if entry is None:
                    break
                entry.last_use = self._clock
                pages.append(entry.pid)
            partial = None
            # a tail can only extend a FULLY matched page chain: tail
            # entries hang off the chain key of everything before them
            if len(pages) == n_full:
                rem = tokens[n_full * ptok:]
                if rem.size > 0:
                    best, best_m = None, 0
                    for t in self._tails.get(key, []):
                        m = _common_prefix(t.tokens, rem)
                        if m > best_m:
                            best, best_m = t, m
                    if best is not None:
                        best.last_use = self._clock
                        partial = (best.pid, best_m)
            length = len(pages) * ptok + (partial[1] if partial else 0)
            if length == 0:
                return None
            pinned = list(pages) + ([partial[0]] if partial else [])
            self.pool.ref(pinned)
            return PagedPrefixHandle(self.pool, list(pages), length,
                                     partial)

    def release(self, handle):
        """Drop a match's pins. Idempotent per handle."""
        if handle is None or handle._released:
            return
        handle._released = True
        pinned = list(handle.pages)
        if handle.partial is not None:
            pinned.append(handle.partial[0])
        self.pool.unref(pinned)

    # ---------- insert / evict ----------

    def insert_pages(self, tokens, full_pids, tail_pid=None):
        """Register a finished prompt's pages: full_pids cover the
        len(tokens) // page_tokens complete pages IN ORDER, tail_pid
        (optional) holds the remainder. The index refs every NEWLY
        registered page (dedup: an already-cached chain point keeps its
        existing page — the new slot's copy stays private and drains
        with the slot)."""
        tokens = _as_tokens(tokens)
        ptok = self.page_tokens
        n_full = tokens.size // ptok
        if len(full_pids) < n_full:
            raise ValueError("need %d full pages, got %d"
                             % (n_full, len(full_pids)))
        with self._lock:
            self._clock += 1
            key = b"root"
            for i in range(n_full):
                page = tokens[i * ptok:(i + 1) * ptok]
                prev = key
                key = self._chain(key, page)
                entry = self._full.get(key)
                if entry is not None:
                    entry.last_use = self._clock
                    continue
                pid = int(full_pids[i])
                self.pool.ref([pid])
                self._full[key] = _PageEntry(pid, key, prev, self._clock)
            rem = tokens[n_full * ptok:]
            if rem.size and tail_pid is not None:
                bucket = self._tails.setdefault(key, [])
                covered = any(
                    t.tokens.size >= rem.size
                    and _common_prefix(t.tokens, rem) == rem.size
                    for t in bucket)
                if not covered:
                    self.pool.ref([int(tail_pid)])
                    bucket.append(_TailEntry(int(tail_pid), rem.copy(),
                                             self._clock))
                    if len(bucket) > self.MAX_TAILS_PER_CHAIN:
                        bucket.sort(key=lambda t: t.last_use)
                        old = bucket.pop(0)
                        self.pool.unref([old.pid])
            self._evict_locked()

    # scheduler duck-typing: the radix cache's insert(tokens, kv) has no
    # page-sharing analogue — the scheduler calls insert_pages instead

    def _evict_locked(self):
        over = self._registered_locked() - self.max_pages
        if over <= 0:
            return
        victims = sorted(
            [("full", k, e) for k, e in self._full.items()]
            + [("tail", k, t) for k, ts in self._tails.items()
               for t in ts],
            key=lambda item: item[2].last_use)
        freed = 0
        for kind, key, entry in victims:
            if freed >= over:
                break
            if kind == "full":
                del self._full[key]
            else:
                bucket = self._tails.get(key, [])
                if entry in bucket:
                    bucket.remove(entry)
                    if not bucket:
                        del self._tails[key]
            self.pool.unref([entry.pid])
            freed += 1
        if freed:
            self._evictions += 1
            self._evicted_pages += freed
            telemetry.event("serve.prefix.evict", data={
                "nodes": freed,
                "tokens": freed * self.page_tokens,
                "bytes": freed * self.pool.page_bytes()})

    def _registered_locked(self):
        return len(self._full) + sum(len(ts)
                                     for ts in self._tails.values())

    def clear(self):
        """Drop every registered page ref (drain/shutdown teardown; a
        leak assert after clear() expects the pool fully free)."""
        with self._lock:
            entries = list(self._full.values()) + [
                t for ts in self._tails.values() for t in ts]
            self._full.clear()
            self._tails.clear()
        self.pool.unref([e.pid for e in entries])

    # ---------- introspection ----------

    def registered_pages(self):
        with self._lock:
            return self._registered_locked()

    def stats(self):
        with self._lock:
            full = len(self._full)
            tails = sum(len(ts) for ts in self._tails.values())
            tail_tokens = sum(int(t.tokens.size)
                              for ts in self._tails.values() for t in ts)
        return {
            "pages": full + tails,
            "cached_tokens": full * self.page_tokens + tail_tokens,
            "cached_bytes": (full + tails) * self.pool.page_bytes(),
            "max_bytes": self.max_pages * self.pool.page_bytes(),
            "evictions": self._evictions,
            "evicted_pages": self._evicted_pages,
        }

    def route_digests(self, block=None, limit=512):
        """Routing summary for the fleet router: the cached full-page
        chain keys, most-recently-used first. `block` is ignored — a
        paged index's digest block IS its page size (publish
        page_tokens as route_block alongside these)."""
        with self._lock:
            entries = sorted(self._full.values(),
                             key=lambda e: e.last_use, reverse=True)
        return [e.key.hex()[:ROUTE_DIGEST_HEX]
                for e in entries[:int(limit)]]
