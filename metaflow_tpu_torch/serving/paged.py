"""Paged-KV continuous-batching engine + speculative decoding, in PyTorch.

Layout: a global PagePool of fixed-size KV pages ({"k": [layers, n_pages,
page_tokens, kv_heads, head_dim], "v": ...} on the engine's device) plus a
per-slot BLOCK TABLE ([B, n_blocks] on the host, mirrored on the device).
Token position p of a slot lives in page table[p // page_tokens] at offset
p % page_tokens.

  - prefill: write one prompt chunk through one slot's block-table row;
  - decode: advance ALL slots one token in one fused forward; attention
    gathers KV back through the tables (a dense gathered view at small
    depth, pages streamed through the online softmax of
    decode._streamed_attention beyond it);
  - spec: verify a K-token self-drafted proposal in ONE fused forward
    ([B, K+1] tokens at per-slot offsets); the host keeps the longest
    prefix of drafts the model's own argmax agrees with, so greedy output
    is token-identical to the non-speculative path.

Page 0 is a reserved SCRATCH page: free and mid-prefill slots ride through
fused steps as masked lanes whose writes land in their own table (all
zeros for a free slot, so scratch) and are overwritten before they can
become visible.

Admission is RESERVATION-based and so deadlock-free: admit() allocates
every page the request could ever touch (ceil((prompt + max_new + spec_k)
/ page_tokens)) up front; page exhaustion surfaces at admission
(backpressure), never mid-decode.

Zero-copy prefix sharing: prefix_cache.PagedPrefixIndex registers a
finished prompt's pages under a hash chain and holds its own pool ref per
page; a later hit points the new slot's block table at the same device
pages (refcount++, no KV bytes move). Only a partially filled tail page is
copied (copy-on-write).

Where this port departs from a line-by-line translation of the JAX
engine, and why:

  - IN-PLACE POOL. The JAX layer scan returns a new pool per layer and XLA
    updates it in place under buffer donation. Eager PyTorch would copy
    the whole pool each call (gigabytes per token at Llama-3-8B's pool
    size), so every write is an index_put_ into the one pool tensor.
  - OUT-OF-RANGE INDICES. JAX clamps gathers and drops out-of-bounds
    scatters; on CUDA an out-of-range index is a device-side assert that
    poisons the context. The table width (max_seq_len + spec_k) and the
    prefill bucket bounded by the reserved pages are kept as in the JAX
    engine, and before any launch the host (which knows pos and the
    tables) checks every lane's positions against its table and every
    active slot's against its reserved pages, raising ValueError.
  - LAUNCHES IN THE CHUNKED PATH. The JAX engine streams one page per
    iteration inside a compiled loop; eagerly that is layers x pages of
    small launches per step. The port fetches a group of pages per
    iteration (DECODE_CHUNK positions' worth of table columns) and bounds
    the loop by the host's copy of max(pos) + T, never by a device read.
  - HOST SYNCS. Each step's sampled tokens come back with one .cpu() of
    the [B] or [B, K+1] result; host state is uploaded only when dirty.
  - SAMPLING. Sampled decoding keeps the port's seeded Gumbel noise
    (sample_slots, request_step_keys), so sampled tokens match the port's
    SlotEngine and generate(); greedy tokens match the JAX engine.

The JAX engine's compile_counts() has no counterpart: PyTorch runs
eagerly and compiles nothing per shape.
"""

import threading

import numpy as np
import torch

from .. import knobs
from ..inference.decode import (
    DECODE_CHUNK,
    _attn_qkv,
    _block_ffn,
    _cached_attention,
    _streamed_attention,
    bucket_length,
    request_step_keys,
)
from ..models.llama import (
    check_params_device,
    layer_params,
    param_dtype,
    resolve_device,
)
from ..ops.matmul import matmul_f32
from ..ops.norms import rms_norm
from ..ops.rope import rope_frequencies
from .engine import sample_slots

DEFAULT_PAGE_TOKENS = 16


def page_tokens_from_env(default=DEFAULT_PAGE_TOKENS):
    """TPUFLOW_KV_PAGE_TOKENS: tokens per KV page (the paged engine's
    allocation granule)."""
    return max(1, knobs.get_int("TPUFLOW_KV_PAGE_TOKENS",
                                fallback=default))


def spec_k_from_env(default=0):
    """TPUFLOW_SPEC_K: speculative draft length (0 disables)."""
    return max(0, knobs.get_int("TPUFLOW_SPEC_K", fallback=default))


class PageExhaustedError(RuntimeError):
    """The page pool cannot satisfy an allocation right now. NOT a
    ValueError on purpose: the scheduler rejects ValueError admits as
    malformed, but exhaustion is backpressure — the request waits."""


class PagePool(object):
    """The global device KV page pool + host-side free list/refcounts.

    Pages are ref-counted, not owned: a slot refs every page in its block
    table, the prefix index refs every page it registers, and a page
    returns to the free list only when the LAST ref drops — which is what
    makes prefix hits zero-copy-safe."""

    def __init__(self, cfg, n_pages, page_tokens, dtype=None,
                 device="cuda"):
        if n_pages < 2:
            raise ValueError("n_pages must be >= 2 (page 0 is scratch)")
        if page_tokens < 1:
            raise ValueError("page_tokens must be >= 1")
        if dtype is None:
            dt = param_dtype(cfg)
        else:
            dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        shape = (cfg.n_layers, int(n_pages), int(page_tokens),
                 cfg.n_kv_heads, cfg.head_dim)
        device = resolve_device(device)
        self.kv = {"k": torch.zeros(shape, dtype=dt, device=device),
                   "v": torch.zeros(shape, dtype=dt, device=device)}
        self.n_pages = int(n_pages)
        self.page_tokens = int(page_tokens)
        self._lock = threading.Lock()
        self.refs = np.zeros(self.n_pages, np.int32)
        self.refs[0] = 1  # scratch: permanently held, never allocated
        self._free = list(range(self.n_pages - 1, 0, -1))
        self.alloc_count = 0       # cumulative pages handed out
        self.freed_count = 0       # cumulative pages returned

    @property
    def usable_pages(self):
        return self.n_pages - 1    # minus the scratch page

    def page_bytes(self):
        k = self.kv["k"]
        layers, _, ptok, kv_heads, head_dim = k.shape
        return 2 * layers * ptok * kv_heads * head_dim * k.element_size()

    def free_pages(self):
        with self._lock:
            return len(self._free)

    def pages_in_use(self):
        with self._lock:
            return self.usable_pages - len(self._free)

    def shared_pages(self):
        """Pages currently held by more than one owner (scratch excluded)."""
        with self._lock:
            return int((self.refs[1:] > 1).sum())

    def can_alloc(self, n):
        with self._lock:
            return len(self._free) >= n

    def alloc(self, n):
        """Take n pages (each with one ref). Raises PageExhaustedError —
        callers gate on can_alloc/can_admit, so this raising is the
        backstop, not the control flow."""
        with self._lock:
            if len(self._free) < n:
                raise PageExhaustedError(
                    "need %d pages, %d free" % (n, len(self._free)))
            pids = [self._free.pop() for _ in range(n)]
            for p in pids:
                self.refs[p] = 1
            self.alloc_count += n
            return pids

    def ref(self, pids):
        with self._lock:
            for p in pids:
                p = int(p)
                if p == 0:
                    continue
                if self.refs[p] <= 0:
                    raise RuntimeError("ref of free page %d" % p)
                self.refs[p] += 1

    def unref(self, pids):
        """Drop one ref per page; pages reaching zero return to the free
        list. Returns how many were actually freed."""
        freed = 0
        with self._lock:
            for p in pids:
                p = int(p)
                if p == 0:
                    continue
                if self.refs[p] <= 0:
                    raise RuntimeError("unref of free page %d" % p)
                self.refs[p] -= 1
                if self.refs[p] == 0:
                    self._free.append(p)
                    freed += 1
            self.freed_count += freed
        return freed

    def stats(self):
        with self._lock:
            free = len(self._free)
            shared = int((self.refs[1:] > 1).sum())
        total = self.usable_pages
        return {
            "page_tokens": self.page_tokens,
            "page_bytes": self.page_bytes(),
            "pages_total": total,
            "pages_free": free,
            "pages_in_use": total - free,
            "occupancy": round((total - free) / max(1, total), 4),
            "shared_pages": shared,
            "page_allocs": self.alloc_count,
            "page_frees": self.freed_count,
        }


def ngram_draft(context, k, max_ngram=3):
    """Prompt-lookup self-drafting (the default draft policy): find the
    most recent earlier occurrence of the longest trailing n-gram of the
    context and propose its continuation."""
    ctx = [int(t) for t in context]
    for ng in range(min(max_ngram, max(0, len(ctx) - 1)), 0, -1):
        tail = ctx[-ng:]
        for i in range(len(ctx) - ng - 1, -1, -1):
            if ctx[i:i + ng] == tail:
                cont = ctx[i + ng:i + ng + k]
                if cont:
                    while len(cont) < k:
                        cont.append(cont[-1])
                    return cont
    last = ctx[-1] if ctx else 0
    return [last] * k


def _paged_forward(params, tokens, pool_kv, tables, pos, cfg, page_tokens,
                   attn_impl="dense", pos_max=None):
    """decode_forward through a block table: forward T new tokens per row
    at per-row offsets `pos` [B], writing their KV IN PLACE into the pages
    `tables` [B, n_blocks] names and attending back through them. tokens,
    tables and pos are int64 tensors on the pool's device; the caller has
    checked every position against the tables. Returns (logits [B, T,
    vocab] f32, pool_kv).

    Numerics follow the contiguous path: the qkv/rope and FFN halves are
    decode._attn_qkv/_block_ffn, 'dense' gathers the table into a
    contiguous [B, S] view and runs _cached_attention, and 'chunked'
    streams groups of pages through _streamed_attention. pos_max is the
    host's max(pos) (read off the device when None)."""
    dt = param_dtype(cfg)
    B, T = tokens.shape
    n_blocks = tables.shape[1]
    S = n_blocks * page_tokens
    KV, Hd = cfg.n_kv_heads, cfg.head_dim
    device = tokens.device
    x = params["embed"][tokens].to(dt)
    cos, sin = rope_frequencies(
        cfg.head_dim, S, cfg.rope_theta, dtype=dt,
        llama3_scaling=getattr(cfg, "rope_llama3_scaling", False),
        device=device)
    abs_pos = pos[:, None] + torch.arange(T, device=device)[None, :]
    offs = abs_pos % page_tokens
    pids = torch.gather(tables, 1, abs_pos // page_tokens)     # [B, T]
    if attn_impl == "chunked":
        if pos_max is None:
            pos_max = int(pos.max())
        # a group of pages per fetch: DECODE_CHUNK positions' worth of
        # table columns, where the JAX engine fetches one page per step of
        # a compiled loop; the trip count comes from the host's max(pos)
        group = max(1, DECODE_CHUNK // page_tokens)
        chunk = group * page_tokens
        n_chunks = min(-(-(pos_max + T) // chunk), -(-n_blocks // group))
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        pk, pv = pool_kv["k"][i], pool_kv["v"][i]  # [n_pages, ptok, KV, Hd]
        q, k, v = _attn_qkv(cfg, cos, sin, pos, x, lp)
        # the paged cache write: token t of row b lands in page pids[b, t]
        # at offset offs[b, t], written into the one pool tensor in place
        pk.index_put_((pids, offs), k.to(pk.dtype))
        pv.index_put_((pids, offs), v.to(pv.dtype))
        if attn_impl == "chunked":
            def fetch(c, pk=pk, pv=pv):
                cols = tables[:, c * group:(c + 1) * group]   # [B, g]
                n = cols.shape[1] * page_tokens
                return (pk[cols].reshape(B, n, KV, Hd),
                        pv[cols].reshape(B, n, KV, Hd),
                        c * chunk + torch.arange(n, device=device))

            attn = _streamed_attention(q, pos, chunk, n_chunks, fetch)
        else:
            view_k = pk[tables].reshape(B, S, KV, Hd)
            view_v = pv[tables].reshape(B, S, KV, Hd)
            attn = _cached_attention(q, view_k, view_v, pos)
        x = _block_ffn(cfg, x, attn, lp)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return matmul_f32(x, params["lm_head"]), pool_kv


class PagedEngine(object):
    """SlotEngine-compatible engine over a paged KV pool.

    The API surface the scheduler drives (admit/prefill_step/decode_step/
    release/seed_prefix/extract_kv/admit_prefilled), plus the paged
    extensions: can_admit/fits (reservation capacity), seed_pages
    (zero-copy prefix attach), slot_prefix_pages (prefix registration read
    path), kv_stats/spec_stats.

    NOT thread-safe — exactly one scheduler loop drives it. Device work
    runs under torch.inference_mode(), entered by each method in the
    calling thread.
    """

    def __init__(self, params, cfg, max_slots=8, max_seq_len=None,
                 prefill_chunk=64, attn_impl="auto", cache_dtype=None,
                 pad_id=0, min_bucket=16, page_tokens=None,
                 total_pages=None, spec_k=None, draft_fn=None,
                 device="cuda"):
        if attn_impl not in ("auto", "dense", "chunked"):
            raise ValueError("attn_impl must be 'auto', 'dense' or "
                             "'chunked', got %r" % (attn_impl,))
        self.device = resolve_device(device)
        check_params_device(params, self.device)
        self.params = params
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len or cfg.max_seq_len)
        self.prefill_chunk = int(prefill_chunk)
        if self.max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1, got %d"
                             % self.prefill_chunk)
        self.pad_id = int(pad_id)
        self.min_bucket = min(int(min_bucket), self.prefill_chunk)
        self._vocab = cfg.vocab_size
        self.page_tokens = int(page_tokens or page_tokens_from_env())
        self.spec_k = int(spec_k_from_env() if spec_k is None else spec_k)
        if self.spec_k < 0:
            raise ValueError("spec_k must be >= 0")
        self.draft_fn = draft_fn or ngram_draft
        ptok = self.page_tokens
        # table width covers max_seq PLUS the spec margin: a verify step
        # writes up to K positions past the last accepted token
        self.n_blocks = -(-(self.max_seq_len + self.spec_k) // ptok)
        if total_pages is None:
            # default: the slot engine's memory shape — every slot can hold
            # a full max_seq sequence (+1 scratch page)
            total_pages = self.max_slots * self.n_blocks + 1
        self.pool = PagePool(cfg, total_pages, ptok, dtype=cache_dtype,
                             device=self.device)
        if attn_impl == "auto":
            attn_impl = ("chunked"
                         if self.n_blocks * ptok > 2 * DECODE_CHUNK
                         else "dense")
        self.attn_impl = attn_impl

        B = self.max_slots
        # host-side per-slot state
        self.pos = np.zeros(B, np.int64)
        self.active = np.zeros(B, bool)
        self.decoding = np.zeros(B, bool)
        self.block_tables = np.zeros((B, self.n_blocks), np.int64)
        self._n_pages = np.zeros(B, np.int64)
        self._tok = np.zeros(B, np.int64)
        self._temp = np.zeros(B, np.float32)
        self._top_k = np.full(B, self._vocab, np.int64)
        self._top_p = np.ones(B, np.float32)
        self._step_seeds = [None] * B
        self._slot_ctx = [None] * B
        self._key_cursor = np.zeros(B, np.int64)
        self._prompt = [None] * B
        self._prefill_cursor = np.zeros(B, np.int64)
        self._max_new = np.zeros(B, np.int64)
        self._emitted = np.zeros(B, np.int64)
        self._context = [None] * B       # prompt+generated (draft source)
        self._noise_gen = torch.Generator(device=self.device)
        # device mirrors of the step inputs, re-uploaded only when dirty
        self._dirty = True
        self._d_tok = self._d_pos = self._d_mask = self._d_tables = None
        self._d_temp = self._d_top_k = self._d_top_p = None
        # counters
        self.kv_bytes_copied = 0   # host<->page copies (0 on zero-copy hits)
        self.cow_pages = 0         # partial tail pages privatized
        self.cow_bytes = 0
        self.shared_pages_attached = 0  # zero-copy pages attached to slots
        self.shared_tokens = 0     # tokens those pages carried
        self.spec_steps = 0
        self.spec_proposed = 0
        self.spec_accepted = 0

    # ---------- pool / capacity state ----------

    def free_slots(self):
        return [i for i in range(self.max_slots) if not self.active[i]]

    def occupancy(self):
        return float(self.active.sum()) / self.max_slots

    def kv_token_bytes(self):
        k = self.pool.kv["k"]
        layers, _, _, kv_heads, head_dim = k.shape
        return 2 * layers * kv_heads * head_dim * k.element_size()

    def _pages_needed(self, prompt_len, max_new_tokens):
        need = prompt_len + max_new_tokens + self.spec_k
        return -(-need // self.page_tokens)

    def fits(self, prompt_len, max_new_tokens):
        """Could this request EVER be admitted (empty pool)? A False here
        is a permanent 413, not backpressure."""
        if prompt_len + max_new_tokens > self.max_seq_len:
            return False
        return (self._pages_needed(prompt_len, max_new_tokens)
                <= self.pool.usable_pages)

    def can_admit(self, prompt_len, max_new_tokens):
        """Can this request be admitted NOW (enough free pages for its
        full reservation)? A False is backpressure."""
        return self.pool.can_alloc(
            self._pages_needed(prompt_len, max_new_tokens))

    def max_context_tokens(self):
        """The largest prompt+max_new any request may carry."""
        return min(self.max_seq_len,
                   self.pool.usable_pages * self.page_tokens - self.spec_k)

    def kv_stats(self):
        out = {"enabled": True}
        out.update(self.pool.stats())
        out.update({
            "cow_pages": self.cow_pages,
            "cow_bytes": self.cow_bytes,
            "kv_bytes_copied": self.kv_bytes_copied,
            "shared_pages_attached": self.shared_pages_attached,
            "shared_tokens": self.shared_tokens,
            "spec_k": self.spec_k,
        })
        return out

    def spec_stats(self):
        return {
            "enabled": self.spec_k > 0,
            "k": self.spec_k,
            "steps": self.spec_steps,
            "proposed": self.spec_proposed,
            "accepted": self.spec_accepted,
            "accept_rate": round(
                self.spec_accepted / max(1, self.spec_proposed), 4),
        }

    # ---------- slot lifecycle ----------

    def admit(self, slot, prompt_tokens, max_new_tokens, temperature=0.0,
              top_k=None, top_p=None, rng=0):
        """Bind a request to a free slot and RESERVE its full page budget.
        Raises ValueError for malformed/never-fits requests and
        PageExhaustedError when the pool is momentarily out of pages."""
        if self.active[slot]:
            raise ValueError("slot %d is busy" % slot)
        prompt = np.asarray(prompt_tokens, np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.size + max_new_tokens > self.max_seq_len:
            raise ValueError(
                "prompt (%d) + max_new_tokens (%d) exceeds the engine's "
                "max_seq_len (%d)" % (prompt.size, max_new_tokens,
                                      self.max_seq_len))
        n_pages = self._pages_needed(prompt.size, max_new_tokens)
        if n_pages > self.pool.usable_pages:
            raise ValueError(
                "request needs %d KV pages but the pool only has %d"
                % (n_pages, self.pool.usable_pages))
        pids = self.pool.alloc(n_pages)   # may raise PageExhaustedError
        self.active[slot] = True
        self.decoding[slot] = False
        self.pos[slot] = 0
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :n_pages] = pids
        self._n_pages[slot] = n_pages
        self._prompt[slot] = prompt
        self._prefill_cursor[slot] = 0
        self._temp[slot] = float(temperature)
        self._top_k[slot] = (self._vocab if top_k is None
                             else min(int(top_k), self._vocab))
        self._top_p[slot] = 1.0 if top_p is None else float(top_p)
        self._step_seeds[slot] = request_step_keys(rng, max_new_tokens)
        self._key_cursor[slot] = 0
        self._max_new[slot] = int(max_new_tokens)
        self._emitted[slot] = 0
        self._context[slot] = [int(t) for t in prompt]
        self._dirty = True

    def bind_slot_context(self, slot, ctx):
        self._slot_ctx[slot] = dict(ctx) if ctx else None

    def slot_context(self, slot):
        return self._slot_ctx[slot]

    def release(self, slot):
        """Reclaim the slot and drop its page refs. Pages the prefix index
        (or another holder) still refs survive; everything else returns
        to the free list, so every terminal path releases the full
        reservation."""
        n = int(self._n_pages[slot])
        if n:
            self.pool.unref(self.block_tables[slot, :n])
        self.block_tables[slot, :] = 0
        self._n_pages[slot] = 0
        self.active[slot] = False
        self._slot_ctx[slot] = None
        self.decoding[slot] = False
        self.pos[slot] = 0
        self._prompt[slot] = None
        self._step_seeds[slot] = None
        self._context[slot] = None
        self._temp[slot] = 0.0
        self._top_k[slot] = self._vocab
        self._top_p[slot] = 1.0
        self._dirty = True

    # ---------- prefix seeding ----------

    def _check_prefilling(self, slot):
        if not self.active[slot] or self.decoding[slot]:
            raise ValueError("slot %d is not prefilling" % slot)
        if int(self._prefill_cursor[slot]) != 0:
            raise ValueError("slot %d already started prefill" % slot)

    @torch.inference_mode()
    def seed_pages(self, slot, handle):
        """ZERO-COPY prefix attach: point the slot's block table at the
        shared pages a PagedPrefixIndex match pinned. The slot's own pages
        for those positions go straight back to the pool. A partially
        filled tail page is privatized with one device page copy
        (copy-on-write) — the only KV bytes that ever move on a hit."""
        self._check_prefilling(slot)
        prompt = self._prompt[slot]
        if not (0 < handle.length < prompt.size):
            raise ValueError(
                "seed length %d must be in [1, prompt %d)"
                % (handle.length, prompt.size))
        n_full = len(handle.pages)
        if n_full:
            own = self.block_tables[slot, :n_full].copy()
            self.pool.ref(handle.pages)
            self.pool.unref(own)
            self.block_tables[slot, :n_full] = handle.pages
            self.shared_pages_attached += n_full
            self.shared_tokens += n_full * self.page_tokens
        if handle.partial is not None:
            src, _ntok = handle.partial
            dst = int(self.block_tables[slot, n_full])
            # copy-on-write: the shared tail page would be appended to
            for name in ("k", "v"):
                pool = self.pool.kv[name]
                pool[:, dst].copy_(pool[:, int(src)])
            self.cow_pages += 1
            self.cow_bytes += self.pool.page_bytes()
        self._prefill_cursor[slot] = handle.length
        self.pos[slot] = handle.length
        self._dirty = True

    def slot_prefix_pages(self, slot, prompt_len):
        """The pages holding the first prompt_len cached tokens of a slot:
        (full_page_ids, tail_page_id_or_None) — what the prefix index
        registers after a finished prefill."""
        ptok = self.page_tokens
        n_full = prompt_len // ptok
        full = [int(p) for p in self.block_tables[slot, :n_full]]
        tail = None
        if prompt_len % ptok:
            tail = int(self.block_tables[slot, n_full])
        return full, tail

    def seed_prefix(self, slot, kv):
        """Host-KV copy seeding (radix-cache / compat path): upload a
        cached [layers, T, kv, hd] range into the slot's pages at
        positions [0, T). The zero-copy path is seed_pages."""
        self._check_prefilling(slot)
        T = kv["k"].shape[1]
        prompt = self._prompt[slot]
        if not (0 < T < prompt.size):
            raise ValueError(
                "seed length %d must be in [1, prompt %d)"
                % (T, prompt.size))
        self._upload_kv(slot, kv, T)
        self._prefill_cursor[slot] = T
        self.pos[slot] = T
        self._dirty = True

    @torch.inference_mode()
    def _upload_kv(self, slot, kv, T):
        pos = torch.arange(T, device=self.device)
        row = torch.as_tensor(self.block_tables[slot]).to(self.device)
        pids, offs = row[pos // self.page_tokens], pos % self.page_tokens
        # counted as the JAX engine counts it: the host range padded to its
        # power-of-two bucket
        bucket = bucket_length(T, minimum=self.min_bucket,
                               maximum=self.n_blocks * self.page_tokens)
        for name in ("k", "v"):
            src = kv[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.asarray(src, dtype=np.float32))
            pool = self.pool.kv[name]
            pool[:, pids, offs] = src[:, :T].to(device=self.device,
                                                dtype=pool.dtype)
            self.kv_bytes_copied += bucket * (src.numel() // src.shape[1]) \
                * src.element_size()

    @torch.inference_mode()
    def extract_kv(self, slot, length):
        """The first `length` cached positions of a slot as CPU tensors
        ({"k": [layers, length, kv_heads, head_dim], "v": ...}) — the
        disaggregation-handoff read path."""
        if length < 1 or length > self.max_seq_len:
            raise ValueError("length %d out of range" % length)
        n = -(-length // self.page_tokens)
        row = torch.as_tensor(self.block_tables[slot, :n]).to(self.device)
        out = {}
        for name in ("k", "v"):
            pages = self.pool.kv[name][:, row]      # [L, n, ptok, KV, Hd]
            L, _, ptok, KV, Hd = pages.shape
            out[name] = pages.reshape(L, n * ptok, KV, Hd)[:, :length].to(
                "cpu", copy=True)
        return out

    def admit_prefilled(self, slot, prompt_tokens, first_token, kv,
                        max_new_tokens, temperature=0.0, top_k=None,
                        top_p=None, rng=0):
        """Bind a request prefilled ELSEWHERE (disaggregation): seed the
        full prompt KV into fresh pages and enter decode directly."""
        self.admit(slot, prompt_tokens, max_new_tokens,
                   temperature=temperature, top_k=top_k, top_p=top_p,
                   rng=rng)
        prompt = self._prompt[slot]
        if kv["k"].shape[1] != prompt.size:
            self.release(slot)
            raise ValueError("handoff kv length %d != prompt %d"
                             % (kv["k"].shape[1], prompt.size))
        self._upload_kv(slot, kv, prompt.size)
        self._prefill_cursor[slot] = prompt.size
        self.decoding[slot] = True
        self.pos[slot] = prompt.size
        self._tok[slot] = int(first_token)
        self._key_cursor[slot] = 1
        self._emitted[slot] = 1
        self._context[slot].append(int(first_token))
        self._dirty = True

    # ---------- device work ----------

    def _check_positions(self, slots, starts, T):
        """Every lane's positions [start, start + T) must name a column of
        its block table, and an active slot's must lie in the pages it
        reserved: checked here, on the host, before any launch, because on
        CUDA an out-of-range index is a device-side assert."""
        ptok = self.page_tokens
        for slot, start in zip(slots, starts):
            last = int(start) + T - 1
            if last // ptok >= self.n_blocks:
                raise ValueError(
                    "slot %d: position %d is past its block table (%d "
                    "pages of %d)" % (slot, last, self.n_blocks, ptok))
            if self.active[slot] and last >= int(self._n_pages[slot]) * ptok:
                raise ValueError(
                    "slot %d: position %d is past its %d reserved pages"
                    % (slot, last, int(self._n_pages[slot])))

    def _forward(self, tokens, tables, pos, pos_max):
        return _paged_forward(self.params, tokens, self.pool.kv, tables, pos,
                              self.cfg, self.page_tokens,
                              attn_impl=self.attn_impl, pos_max=pos_max)

    @torch.inference_mode()
    def prefill_step(self, slot):
        """Write the next prompt chunk of `slot` through its block table.
        Same contract as SlotEngine.prefill_step: returns
        (tokens_consumed, first_token_or_None)."""
        if not self.active[slot] or self.decoding[slot]:
            raise ValueError("slot %d is not prefilling" % slot)
        prompt = self._prompt[slot]
        start = int(self._prefill_cursor[slot])
        end = min(start + self.prefill_chunk, prompt.size)
        chunk = prompt[start:end]
        # the pad bucket must stay inside the slot's RESERVED pages: a
        # write through a table index past n_pages would land in page 0
        # columns or (clamped) in live positions
        bucket = bucket_length(
            chunk.size, minimum=self.min_bucket,
            maximum=min(self.prefill_chunk,
                        int(self._n_pages[slot]) * self.page_tokens
                        - start))
        if bucket > chunk.size:
            chunk = np.concatenate([
                chunk, np.full(bucket - chunk.size, self.pad_id, np.int64)])
        self._check_positions([slot], [start], bucket)
        to = lambda a: torch.as_tensor(a).to(self.device)
        logits, _ = self._forward(
            to(chunk)[None], to(self.block_tables[slot])[None],
            torch.full((1,), start, dtype=torch.long, device=self.device),
            start)
        self._prefill_cursor[slot] = end
        self.pos[slot] = end
        self._dirty = True
        consumed = end - start
        if end < prompt.size:
            return consumed, None
        first = int(self._sample_one(
            logits[:, prompt.size - 1 - start], slot)[0])
        self.decoding[slot] = True
        self.pos[slot] = prompt.size
        self._tok[slot] = first
        self._key_cursor[slot] += 1
        self._emitted[slot] = 1
        self._context[slot].append(first)
        self._dirty = True
        return consumed, first

    def _sample_one(self, last, slot):
        seed = self._seed_for(slot) if self._temp[slot] > 0.0 else None
        knobs_ = [torch.as_tensor(a[slot:slot + 1]).to(self.device)
                  for a in (self._temp, self._top_k, self._top_p)]
        return sample_slots(last, [seed], *knobs_, self._noise_gen)

    def _seed_for(self, slot):
        seeds = self._step_seeds[slot]
        cursor = int(self._key_cursor[slot])
        if cursor >= len(seeds):
            raise ValueError("slot %d ran past its seed schedule" % slot)
        return seeds[cursor]

    def _stage(self):
        if self._dirty:
            to = lambda a: torch.as_tensor(a).to(self.device)
            self._d_tok = to(self._tok)
            self._d_pos = to(self.pos)
            self._d_mask = to(self.decoding)
            self._d_tables = to(self.block_tables)
            self._d_temp = to(self._temp)
            self._d_top_k = to(self._top_k)
            self._d_top_p = to(self._top_p)
            self._dirty = False

    @torch.inference_mode()
    def decode_step(self):
        """One fused step over the whole pool. Returns {slot: token}
        (plain path) or {slot: [tokens]} (speculative path — up to
        spec_k+1 tokens per slot per step)."""
        decoding = [i for i in range(self.max_slots) if self.decoding[i]]
        if not decoding:
            return {}
        sampled = any(self._temp[i] > 0.0 for i in decoding)
        if self.spec_k > 0 and not sampled:
            return self._spec_decode_step(decoding)
        self._check_positions(range(self.max_slots), self.pos, 1)
        self._stage()
        logits, _ = self._forward(self._d_tok[:, None], self._d_tables,
                                  self._d_pos, int(self.pos.max()))
        if sampled:
            # SAMPLING: the port's seeded Gumbel noise (sample_slots), so
            # tokens match the port's SlotEngine and generate(), not
            # jax.random; every decoding slot consumes its step's seed, as
            # in the JAX engine; only sampled slots draw noise
            seeds = [None] * self.max_slots
            for i in decoding:
                seed = self._seed_for(i)
                if self._temp[i] > 0.0:
                    seeds[i] = seed
            nxt = sample_slots(logits[:, 0], seeds, self._d_temp,
                               self._d_top_k, self._d_top_p,
                               self._noise_gen)
        else:
            nxt = logits[:, 0].argmax(dim=-1)
        # decoding lanes take the new token and move their cursor; masked
        # lanes hold still; the host mirrors replay the same update
        self._d_tok = torch.where(self._d_mask, nxt, self._d_tok)
        self._d_pos = self._d_pos + self._d_mask.long()
        out = nxt.cpu().numpy()   # the step's one read-back
        tokens = {}
        for i in decoding:
            tokens[i] = int(out[i])
            self._tok[i] = out[i]
            self.pos[i] += 1
            self._key_cursor[i] += 1
            self._emitted[i] += 1
            self._context[i].append(int(out[i]))
        return tokens

    def _spec_decode_step(self, decoding):
        """Speculative decode: draft K tokens per decoding slot
        (prompt-lookup by default, draft_fn pluggable), verify all K+1
        positions in ONE fused forward, keep the prefix the model agrees
        with. Greedy-only (sampled batches take the plain step), so
        acceptance is exact token identity."""
        K = self.spec_k
        B = self.max_slots
        drafts = np.zeros((B, K), np.int64)
        for i in decoding:
            d = self.draft_fn(self._context[i], K)
            drafts[i] = np.asarray(d[:K], np.int64)
        toks = np.concatenate([self._tok[:, None], drafts], axis=1)
        self._check_positions(range(B), self.pos, K + 1)
        self._stage()
        logits, _ = self._forward(torch.as_tensor(toks).to(self.device),
                                  self._d_tables, self._d_pos,
                                  int(self.pos.max()))
        out = logits.argmax(dim=-1).cpu().numpy()   # one [B, K+1] read-back
        tokens = {}
        for i in decoding:
            remaining = int(self._max_new[i] - self._emitted[i])
            n_acc = 0
            while n_acc < K and drafts[i, n_acc] == out[i, n_acc]:
                n_acc += 1
            n_emit = max(1, min(n_acc + 1, remaining))
            emitted = [int(t) for t in out[i, :n_emit]]
            tokens[i] = emitted
            self._tok[i] = emitted[-1]
            self.pos[i] += n_emit
            self._key_cursor[i] += n_emit
            self._emitted[i] += n_emit
            self._context[i].extend(emitted)
            self.spec_proposed += K
            self.spec_accepted += n_acc
        self.spec_steps += 1
        # pos/tok advanced on the HOST (acceptance is data-dependent):
        # restage before the next fused step
        self._dirty = True
        return tokens
