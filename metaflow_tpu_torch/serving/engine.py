"""Slot-based continuous-batching decode engine, in PyTorch.

A pool of B slots shares one static [layers, B, max_seq, kv_heads,
head_dim] KV cache. Each slot holds at most one in-flight request and
carries host-side state (pos, sampling knobs, per-token noise seeds).
Device work is three operations:

  - prefill: write one PROMPT CHUNK of one slot into the cache through a
    single-slot view of the pool cache (the chunk is right-padded to a
    power-of-two bucket, as in the JAX package);
  - decode: advance ALL slots one token in one fused forward, with
    per-slot positions, per-slot cache writes and per-slot sampling;
  - first-token: sample the token the final prefill chunk's logits imply.

Slots never wait for each other: a finished slot is released and can be
refilled while its neighbours keep decoding. Free and prefilling slots
ride through the fused decode step as masked lanes: their writes land at
their own parked cursor and are overwritten before they become visible
(prefill rewrites the range, decode overwrites pad garbage exactly one
position before it would become visible), so no flag tensor is needed.

Token identity with generate(): same forward, same sampling ops
(sample_slots reproduces decode._sample row for row) and the same noise
seeds (request_step_keys), so a request served through the engine emits
the tokens single-request generate() gives it.

The cache is written in place. The JAX engine's compile_counts() has no
counterpart: PyTorch runs eagerly and compiles nothing per shape.
"""

import numpy as np
import torch

from ..inference.decode import (
    DECODE_CHUNK,
    _top_p_filter,
    bucket_length,
    decode_forward,
    gumbel_noise,
    init_kv_cache,
    request_step_keys,
)
from ..models.llama import check_params_device
from ..ops.attention import NEG_INF
from ..spmd.device import resolve_device


def sample_slots(logits, seeds, temperature, top_k, top_p, generator=None):
    """Per-slot sampling: [B, vocab] f32 logits -> [B] int64, with
    per-slot knobs as tensors (temperature[B], top_k[B] int — vocab size
    disables, top_p[B] — 1.0 disables) and one noise seed per slot (None
    for a greedy or masked slot).

    Row for row identical to decode._sample with the same scalar knobs:
    same filter order (temperature scale, top_k, exclusive-mass top_p),
    same tie handling, and the same per-row noise."""
    B, V = logits.shape
    greedy = logits.argmax(dim=-1)
    is_greedy = temperature <= 0.0
    safe_t = torch.where(is_greedy, 1.0, temperature)
    lt = logits / safe_t[:, None]
    k = top_k.clamp(1, V)
    sorted_desc = torch.sort(lt, dim=-1, descending=True).values
    kth = torch.gather(sorted_desc, -1, (k - 1)[:, None])
    lt = torch.where((k < V)[:, None] & (lt < kth), NEG_INF, lt)
    lt = torch.where((top_p < 1.0)[:, None], _top_p_filter(lt, top_p), lt)
    noise = gumbel_noise(seeds, V, logits.device, generator)
    sampled = (lt + noise).argmax(dim=-1)
    return torch.where(is_greedy, greedy, sampled)


class SlotEngine(object):
    """Fixed pool of decode slots over one shared static KV cache.

    Host-side bookkeeping (which slot holds which request, positions,
    sampling knobs) lives in numpy arrays. The engine is NOT thread-safe:
    exactly one scheduler loop drives it.
    """

    def __init__(self, params, cfg, max_slots=8, max_seq_len=None,
                 prefill_chunk=64, attn_impl="auto", cache_dtype=None,
                 pad_id=0, min_bucket=16, device="cuda"):
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
            # a 0-chunk engine would admit requests and never prefill them
            raise ValueError("prefill_chunk must be >= 1, got %d"
                             % self.prefill_chunk)
        self.pad_id = int(pad_id)
        self.min_bucket = min(int(min_bucket), self.prefill_chunk)
        if attn_impl == "auto":
            attn_impl = ("chunked" if self.max_seq_len > 2 * DECODE_CHUNK
                         else "dense")
        self.attn_impl = attn_impl
        self._vocab = cfg.vocab_size

        self._cache = init_kv_cache(cfg, self.max_slots, self.max_seq_len,
                                    dtype=cache_dtype, device=self.device)
        B = self.max_slots
        self.pos = np.zeros(B, np.int64)          # next cache write index
        self.active = np.zeros(B, bool)           # slot holds a request
        self.decoding = np.zeros(B, bool)         # past prefill
        self._tok = np.zeros(B, np.int64)         # last emitted token
        self._temp = np.zeros(B, np.float32)
        self._top_k = np.full(B, self._vocab, np.int64)
        self._top_p = np.ones(B, np.float32)
        self._step_seeds = [None] * B             # [max_new] per slot
        self._key_cursor = np.zeros(B, np.int64)
        self._prompt = [None] * B                 # remaining host prompt
        self._prefill_cursor = np.zeros(B, np.int64)
        self._noise_gen = torch.Generator(device=self.device)
        self._slot_ctx = [None] * B               # occupant's identity
        # device mirrors of the decode-step inputs: steady-state decode
        # re-uploads nothing (the step advances tok/pos on the device);
        # slot membership or knob changes set _dirty and the next step
        # re-stages them from the host arrays above
        self._dirty = True
        self._d_tok = self._d_pos = self._d_mask = None
        self._d_temp = self._d_top_k = self._d_top_p = None

    # ---------- pool state ----------

    def free_slots(self):
        return [i for i in range(self.max_slots) if not self.active[i]]

    def occupancy(self):
        return float(self.active.sum()) / self.max_slots

    def fits(self, prompt_len, max_new_tokens):
        """Could this request EVER be admitted? False is a permanent 413
        at submit time (the scheduler's admission capacity check), not
        backpressure."""
        return prompt_len + max_new_tokens <= self.max_seq_len

    def max_context_tokens(self):
        """The largest prompt+max_new any request may carry."""
        return self.max_seq_len

    def kv_token_bytes(self):
        """Bytes one cached token costs (k + v across layers): the unit
        the prefix-cache byte budget is denominated in."""
        k = self._cache["k"]
        layers, _, _, kv_heads, head_dim = k.shape
        return 2 * layers * kv_heads * head_dim * k.element_size()

    def bind_slot_context(self, slot, ctx):
        """Attach the occupant's identity/trace context ({"request_id",
        "trace", "span"} from the scheduler) to a slot, so engine-level
        instrumentation (the serve.prefill_chunk timer) attributes device
        work to the request that bought it."""
        self._slot_ctx[slot] = dict(ctx) if ctx else None

    def slot_context(self, slot):
        """The context bound at admit time, or None for a free slot."""
        return self._slot_ctx[slot]

    # ---------- slot lifecycle ----------

    def admit(self, slot, prompt_tokens, max_new_tokens, temperature=0.0,
              top_k=None, top_p=None, rng=0):
        """Bind a request to a free slot; prefill starts on the next
        prefill_step calls. prompt_tokens: 1-D int sequence."""
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
        self.active[slot] = True
        self.decoding[slot] = False
        self.pos[slot] = 0
        self._prompt[slot] = prompt
        self._prefill_cursor[slot] = 0
        self._temp[slot] = float(temperature)
        self._top_k[slot] = (self._vocab if top_k is None
                             else min(int(top_k), self._vocab))
        self._top_p[slot] = 1.0 if top_p is None else float(top_p)
        self._step_seeds[slot] = request_step_keys(rng, max_new_tokens)
        self._key_cursor[slot] = 0
        self._dirty = True

    def _write_slot_kv(self, slot, kv, T):
        """Copy T positions of a [layers, T, kv_heads, head_dim] KV range
        into the slot's cache at positions [0, T). Eager PyTorch needs no
        power-of-two padding of the upload."""
        for name in ("k", "v"):
            src = kv[name]
            if not isinstance(src, torch.Tensor):
                src = torch.from_numpy(np.asarray(src, dtype=np.float32))
            self._cache[name][:, slot, :T] = src[:, :T].to(
                device=self.device, dtype=self._cache[name].dtype)

    def seed_prefix(self, slot, kv):
        """Copy a cached KV range ({"k": [layers, T, kv_heads, head_dim],
        "v": ...}) into the slot's cache at positions [0, T) and move the
        prefill cursor to T, so chunked prefill resumes at the match
        boundary. Must run after admit(), before the first prefill_step;
        T must be < the slot's prompt length (at least one token has to
        prefill so final-chunk logits exist for first-token sampling)."""
        if not self.active[slot] or self.decoding[slot]:
            raise ValueError("slot %d is not prefilling" % slot)
        if int(self._prefill_cursor[slot]) != 0:
            raise ValueError("slot %d already started prefill" % slot)
        T = kv["k"].shape[1]
        prompt = self._prompt[slot]
        if not (0 < T < prompt.size):
            raise ValueError("seed length %d must be in [1, prompt %d)"
                             % (T, prompt.size))
        self._write_slot_kv(slot, kv, T)
        self._prefill_cursor[slot] = T
        self.pos[slot] = T
        self._dirty = True

    def extract_kv(self, slot, length):
        """The first `length` cache positions of a slot as CPU tensors
        ({"k": [layers, length, kv_heads, head_dim], "v": ...})."""
        if length < 1 or length > self.max_seq_len:
            raise ValueError("length %d out of range" % length)
        # a copy even on the CPU: masked lanes keep writing the slot
        return {name: self._cache[name][:, slot, :length].to("cpu",
                                                              copy=True)
                for name in ("k", "v")}

    def admit_prefilled(self, slot, prompt_tokens, first_token, kv,
                        max_new_tokens, temperature=0.0, top_k=None,
                        top_p=None, rng=0):
        """Bind a request whose prefill ALREADY happened elsewhere: seed
        the full prompt's KV, accept the first sampled token, and enter
        the decode state directly. The seed schedule resumes at cursor 1,
        mirroring prefill_step's final chunk."""
        self.admit(slot, prompt_tokens, max_new_tokens,
                   temperature=temperature, top_k=top_k, top_p=top_p,
                   rng=rng)
        prompt = self._prompt[slot]
        if kv["k"].shape[1] != prompt.size:
            self.release(slot)
            raise ValueError("handoff kv length %d != prompt %d"
                             % (kv["k"].shape[1], prompt.size))
        self._write_slot_kv(slot, kv, prompt.size)
        self._prefill_cursor[slot] = prompt.size
        self.decoding[slot] = True
        self.pos[slot] = prompt.size
        self._tok[slot] = int(first_token)
        self._key_cursor[slot] = 1
        self._dirty = True

    def release(self, slot):
        """Reclaim a slot immediately; the stale cache contents stay and
        are overwritten by the next occupant's prefill."""
        self.active[slot] = False
        self._slot_ctx[slot] = None
        self.decoding[slot] = False
        self.pos[slot] = 0  # park the masked-lane write cursor
        self._prompt[slot] = None
        self._step_seeds[slot] = None
        self._temp[slot] = 0.0
        self._top_k[slot] = self._vocab
        self._top_p[slot] = 1.0
        self._dirty = True

    # ---------- device work ----------

    def prefill_step(self, slot):
        """Write the next prompt chunk of `slot` into the cache.

        Returns (tokens_consumed, first_token_or_None): first_token is
        the request's first sampled token, produced when the final chunk
        lands (chunked prefill: long prompts spread over several calls so
        decode steps for other slots interleave between them)."""
        if not self.active[slot] or self.decoding[slot]:
            raise ValueError("slot %d is not prefilling" % slot)
        prompt = self._prompt[slot]
        start = int(self._prefill_cursor[slot])
        end = min(start + self.prefill_chunk, prompt.size)
        chunk = prompt[start:end]
        # cap the pad bucket at the cache edge: a bucketed write spilling
        # past max_seq would be clamped back onto live positions
        bucket = bucket_length(
            chunk.size, minimum=self.min_bucket,
            maximum=min(self.prefill_chunk, self.max_seq_len - start))
        if bucket > chunk.size:
            chunk = np.concatenate([
                chunk, np.full(bucket - chunk.size, self.pad_id, np.int64)])
        # a single-slot VIEW of the pool cache: the writes land in the pool
        sub = {name: arr[:, slot:slot + 1]
               for name, arr in self._cache.items()}
        logits, _ = decode_forward(
            self.params, torch.as_tensor(chunk)[None], sub, start, self.cfg,
            attn_impl=self.attn_impl, device=self.device)
        self._prefill_cursor[slot] = end
        # keep pos at the prefill cursor: a mid-prefill slot rides through
        # fused decode steps as a masked lane whose write lands at pos, where
        # the NEXT chunk overwrites it
        self.pos[slot] = end
        self._dirty = True
        consumed = end - start
        if end < prompt.size:
            return consumed, None
        # final chunk: the first generated token comes off these logits
        first = int(self._sample_one(
            logits[:, prompt.size - 1 - start], slot)[0])
        self.decoding[slot] = True
        self.pos[slot] = prompt.size
        self._tok[slot] = first
        self._key_cursor[slot] += 1
        self._dirty = True
        return consumed, first

    def _sample_one(self, last, slot):
        seed = self._seed_for(slot) if self._temp[slot] > 0.0 else None
        knobs = [torch.as_tensor(a[slot:slot + 1]).to(self.device)
                 for a in (self._temp, self._top_k, self._top_p)]
        return sample_slots(last, [seed], *knobs, self._noise_gen)

    def _seed_for(self, slot):
        seeds = self._step_seeds[slot]
        cursor = int(self._key_cursor[slot])
        if cursor >= len(seeds):
            raise ValueError("slot %d ran past its seed schedule" % slot)
        return seeds[cursor]

    def decode_step(self):
        """One fused decode step over the WHOLE pool. Returns {slot: token}
        for slots in the decode state; other slots ride through as masked
        lanes (their writes are overwritten before becoming visible).
        Advances pos/seed cursors for decoding slots only."""
        decoding = [i for i in range(self.max_slots) if self.decoding[i]]
        if not decoding:
            return {}
        if self._dirty:
            to = lambda a: torch.as_tensor(a).to(self.device)
            self._d_tok = to(self._tok)
            self._d_pos = to(self.pos)
            self._d_mask = to(self.decoding)
            self._d_temp = to(self._temp)
            self._d_top_k = to(self._top_k)
            self._d_top_p = to(self._top_p)
            self._dirty = False
        logits, self._cache = decode_forward(
            self.params, self._d_tok[:, None], self._cache, self._d_pos,
            self.cfg, attn_impl=self.attn_impl, device=self.device)
        if any(self._temp[i] > 0.0 for i in decoding):
            # every decoding slot consumes its step's seed, as in the JAX
            # engine; only sampled slots draw noise
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
        out = nxt.cpu().numpy()
        tokens = {}
        for i in decoding:
            tokens[i] = int(out[i])
            self._tok[i] = out[i]
            self.pos[i] += 1
            self._key_cursor[i] += 1
        return tokens
