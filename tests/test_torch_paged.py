"""The port's paged-KV engine on the CPU against the JAX package's.

_paged_forward (dense and chunked) against the JAX _paged_forward on the
same pool, tables and positions across a page boundary; token identity of
the PagedEngine across page boundaries (greedy against the JAX PagedEngine
and the port's generate(), sampled against the port's SlotEngine and
generate(), a tiny Mixtral greedy); the speculative-decoding contracts;
PagePool, RadixPrefixCache and PagedPrefixIndex driven call by call beside
the JAX package's classes; zero-copy hits, copy-on-write of a shared tail
and no page leaked on any terminal path."""

import time

import numpy as np
import pytest
import torch

from metaflow_tpu_torch.inference import decode as port_decode
from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.models import mixtral as port_mixtral
from metaflow_tpu_torch.serving import paged as port_paged
from metaflow_tpu_torch.serving import prefix_cache as port_prefix
from metaflow_tpu_torch.serving import scheduler as port_sched
from metaflow_tpu_torch.serving import (
    PagedEngine,
    PagedPrefixIndex,
    Request,
    Scheduler,
    SlotEngine,
)

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

PTOK = 16  # page size everywhere here: boundaries land on multiples
# _paged_forward in f32 against the JAX one: the logits agree to ~1e-6
# relative (different matmul and softmax summation orders)
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules, the tiny Llama's weights in both
    packages, and one JAX PagedEngine per spec_k for the greedy traces."""
    jax = pytest.importorskip("jax")
    from metaflow_tpu.inference import decode as ref_decode
    from metaflow_tpu.models import llama as ref_llama
    from metaflow_tpu.serving import paged as ref_paged
    from metaflow_tpu.serving import prefix_cache as ref_prefix
    from metaflow_tpu.serving import scheduler as ref_sched

    cfg = ref_llama.LlamaConfig.tiny()
    ref_params = ref_llama.init_params(jax.random.PRNGKey(0), cfg)
    params = port_llama.from_jax_params(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu")

    class Ref:
        pass

    r = Ref()
    r.jax, r.decode, r.llama, r.paged = jax, ref_decode, ref_llama, ref_paged
    r.prefix, r.sched = ref_prefix, ref_sched
    r.cfg, r.ref_params, r.params = cfg, ref_params, params
    return r


def _engine(r, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("spec_k", 0)
    return PagedEngine(r.params, r.cfg, max_seq_len=128, prefill_chunk=16,
                       page_tokens=PTOK, device="cpu", **kw)


def _port_tokens(params, cfg, req):
    out = port_decode.generate(
        params, [req.tokens], cfg, req.max_new_tokens,
        temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
        rng=req.rng, eos_id=req.eos_id, device="cpu")
    new = out[0, len(req.tokens):].tolist()
    if req.eos_id is not None and req.eos_id in new:
        new = new[:new.index(req.eos_id) + 1]
    return new


def _serve(sched_mod, engine, traces, **kw):
    sched = sched_mod.Scheduler(engine)
    reqs = [sched.submit(sched_mod.Request(list(p), max_new_tokens=n,
                                           rng=i, request_id="r%d" % i,
                                           **kw))
            for i, (p, n) in enumerate(traces)]
    sched.run_until_idle(10_000)
    return reqs


def _assert_pool_free(eng):
    assert eng.pool.free_pages() == eng.pool.usable_pages, \
        "leaked KV pages: %s" % (eng.pool.stats(),)


# ---------------------------------------------------------------------------
# _paged_forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_paged_forward_matches_jax(ref, impl, monkeypatch):
    """Rows at offsets 14 (its 4 tokens cross the first page boundary)
    and 30 over pools of random KV, through shuffled tables; row 2 is a
    free slot (table all zeros) whose writes must land in scratch page 0.
    The chunked form streams two pages a fetch here, so the loop runs
    more than once."""
    monkeypatch.setattr(port_paged, "DECODE_CHUNK", 2 * PTOK)
    jnp = ref.jax.numpy
    cfg = ref.cfg
    rng = np.random.default_rng(3)
    n_pages, n_blocks, T = 12, 4, 4
    shape = (cfg.n_layers, n_pages, PTOK, cfg.n_kv_heads, cfg.head_dim)
    pool_k = rng.standard_normal(shape).astype(np.float32)
    pool_v = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((3, n_blocks), np.int32)
    tables[0] = perm[:4]
    tables[1] = perm[4:8]
    pos = np.array([14, 30, 0], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (3, T)).astype(np.int32)

    want, ref_pool = ref.paged._paged_forward(
        ref.ref_params, jnp.asarray(tokens),
        {"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
        jnp.asarray(tables), jnp.asarray(pos), cfg, PTOK, attn_impl=impl)
    port_pool = {"k": torch.from_numpy(pool_k.copy()),
                 "v": torch.from_numpy(pool_v.copy())}
    got, out_pool = port_paged._paged_forward(
        ref.params, torch.from_numpy(tokens).long(), port_pool,
        torch.from_numpy(tables).long(), torch.from_numpy(pos).long(),
        cfg, PTOK, attn_impl=impl, pos_max=int(pos.max()))
    assert out_pool is port_pool      # written in place, not copied
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    for name, before in (("k", pool_k), ("v", pool_v)):
        new = port_pool[name].numpy()
        np.testing.assert_allclose(new, np.asarray(ref_pool[name]),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
        # the live rows wrote exactly their positions' slots
        changed = np.argwhere((new != before).any(axis=(0, 3, 4)))
        expect = {(int(tables[b, p // PTOK]), p % PTOK)
                  for b in range(2) for p in range(pos[b], pos[b] + T)}
        expect |= {(0, p) for p in range(T)}   # the masked lane: scratch
        assert {tuple(c) for c in changed} == expect


def test_out_of_range_positions_raise_before_any_launch(ref):
    eng = _engine(ref, max_slots=2)
    eng.admit(0, list(range(1, 10)), 4)
    eng.prefill_step(0)
    eng.pos[0] = eng._n_pages[0] * PTOK   # past the reserved pages
    before = eng.pool.kv["k"].clone()
    with pytest.raises(ValueError, match="reserved pages"):
        eng.decode_step()
    assert torch.equal(before, eng.pool.kv["k"])
    eng.pos[0] = eng.n_blocks * PTOK      # past the block table
    with pytest.raises(ValueError, match="block table"):
        eng.decode_step()
    eng.release(0)
    _assert_pool_free(eng)


# ---------------------------------------------------------------------------
# token identity across page boundaries
# ---------------------------------------------------------------------------

GREEDY_CASES = [(PTOK - 1, 3), (PTOK, 4), (PTOK + 1, 4), (2 * PTOK - 2, 6),
                (3 * PTOK, 9), (7, 2 * PTOK + 3), (90, 8), (33, PTOK)]


def _greedy_traces(cfg):
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, plen).tolist(), n)
            for plen, n in GREEDY_CASES]


@pytest.fixture(scope="module")
def ref_greedy(ref):
    """The JAX PagedEngine's greedy tokens and spec_stats on the traces
    (spec_k 0 and 3, the default drafter)."""
    traces = _greedy_traces(ref.cfg)
    out = {}
    for k in (0, 3):
        eng = ref.paged.PagedEngine(
            ref.ref_params, ref.cfg, max_slots=4, max_seq_len=128,
            prefill_chunk=16, page_tokens=PTOK, spec_k=k)
        reqs = _serve(ref.sched, eng, traces)
        out[k] = ([r.generated for r in reqs], eng.spec_stats())
    return traces, out


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_greedy_identity_at_page_boundaries(ref, ref_greedy, impl,
                                            monkeypatch):
    """Prompt lengths straddling every page-boundary case with generation
    lengths that cross page edges mid-decode: port PagedEngine == JAX
    PagedEngine == port generate(), token for token."""
    monkeypatch.setattr(port_paged, "DECODE_CHUNK", 2 * PTOK)
    traces, want = ref_greedy
    eng = _engine(ref, attn_impl=impl)
    reqs = _serve(port_sched, eng, traces)
    for req, jax_tokens in zip(reqs, want[0][0]):
        assert req.reason == "length"
        assert req.generated == jax_tokens
        assert req.generated == _port_tokens(ref.params, ref.cfg, req)
    _assert_pool_free(eng)


def test_sampled_identity_at_page_boundaries(ref):
    """Sampled (temperature / top-k / top-p) through the paged engine ==
    the port's SlotEngine == the port's generate(), across a page boundary
    mid-stream (the port's seeded noise, not jax.random)."""
    eng = _engine(ref)
    sched = Scheduler(eng)
    reqs = []
    for i, (tk, tp) in enumerate([(None, None), (20, None), (None, 0.9),
                                  (20, 0.9)]):
        toks = list(range(3 + i, 3 + i + PTOK - 2))
        reqs.append(sched.submit(Request(
            toks, max_new_tokens=PTOK, temperature=0.8, top_k=tk,
            top_p=tp, rng=100 + i)))
    sched.run_until_idle(10_000)
    slot = SlotEngine(ref.params, ref.cfg, max_slots=4, max_seq_len=128,
                      prefill_chunk=16, device="cpu")
    ssched = Scheduler(slot)
    twins = [ssched.submit(Request(r.tokens, max_new_tokens=PTOK,
                                   temperature=0.8, top_k=r.top_k,
                                   top_p=r.top_p, rng=r.rng))
             for r in reqs]
    ssched.run_until_idle(10_000)
    for req, twin in zip(reqs, twins):
        assert req.generated == twin.generated \
            == _port_tokens(ref.params, ref.cfg, req)
    _assert_pool_free(eng)


def test_mixtral_greedy_identity(ref):
    """The tiny Mixtral through the paged engine (the MoE branch of
    _block_ffn) gives the port's generate() tokens and the JAX
    PagedEngine's."""
    from metaflow_tpu.models import mixtral as ref_mixtral

    jax = ref.jax
    cfg = ref_mixtral.MixtralConfig.tiny()
    ref_params = ref_mixtral.init_params(jax.random.PRNGKey(1), cfg)
    params = port_mixtral.from_jax_params(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    traces = [(list(range(2, 2 + PTOK + 3)), 6), (list(range(9, 20)), 8)]
    eng = PagedEngine(params, cfg, max_slots=2, max_seq_len=64,
                      prefill_chunk=16, page_tokens=PTOK, spec_k=0,
                      device="cpu")
    reqs = _serve(port_sched, eng, traces)
    ref_eng = ref.paged.PagedEngine(ref_params, cfg, max_slots=2,
                                    max_seq_len=64, prefill_chunk=16,
                                    page_tokens=PTOK, spec_k=0)
    want = _serve(ref.sched, ref_eng, traces)
    for req, w in zip(reqs, want):
        assert req.generated == w.generated \
            == _port_tokens(params, cfg, req)
    _assert_pool_free(eng)


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spec_engine(ref):
    return _engine(ref, spec_k=3)


def test_spec_stats_equal_the_jax_engines(ref, ref_greedy):
    """The same greedy requests through both engines at spec_k 3 with the
    default prompt-lookup drafter: the same tokens and the same
    steps/proposed/accepted counters."""
    traces, want = ref_greedy
    eng = _engine(ref, spec_k=3)
    reqs = _serve(port_sched, eng, traces)
    assert [r.generated for r in reqs] == want[3][0] == want[0][0]
    assert eng.spec_stats() == want[3][1]
    assert eng.spec_stats()["steps"] > 0
    _assert_pool_free(eng)


def test_oracle_drafts_accept_all_bit_exact(ref, spec_engine):
    cfg, params = ref.cfg, ref.params
    rng = np.random.default_rng(7)
    traces = [(rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, 30))).tolist(), 18)
              for _ in range(4)]
    refs = [list(p) + _port_tokens(
        params, cfg, Request(list(p), max_new_tokens=n, rng=i))
        for i, (p, n) in enumerate(traces)]

    def oracle(context, k):
        for r in refs:
            n = len(context)
            if len(r) > n and r[:n] == context:
                out = r[n:n + k]
                return out + [0] * (k - len(out))
        return [0] * k

    old = spec_engine.draft_fn
    spec_engine.draft_fn = oracle
    p0, a0 = spec_engine.spec_proposed, spec_engine.spec_accepted
    steps0 = spec_engine.spec_steps
    try:
        reqs = _serve(port_sched, spec_engine, traces)
    finally:
        spec_engine.draft_fn = old
    for req, r in zip(reqs, refs):
        assert req.generated == r[len(req.tokens):]
    proposed = spec_engine.spec_proposed - p0
    accepted = spec_engine.spec_accepted - a0
    steps = spec_engine.spec_steps - steps0
    assert accepted / proposed >= 0.8, (accepted, proposed)
    assert steps < sum(len(r.generated) for r in reqs)
    _assert_pool_free(spec_engine)


def test_garbage_drafts_still_exact(ref, spec_engine):
    bad = ref.cfg.vocab_size - 1
    traces = [(list(range(5, 30)), 12), (list(range(2, 9)), 10)]
    old = spec_engine.draft_fn
    p0, a0 = spec_engine.spec_proposed, spec_engine.spec_accepted
    spec_engine.draft_fn = lambda context, k: [bad] * k
    try:
        reqs = _serve(port_sched, spec_engine, traces)
    finally:
        spec_engine.draft_fn = old
    for req in reqs:
        assert req.generated == _port_tokens(ref.params, ref.cfg, req)
    proposed = spec_engine.spec_proposed - p0
    assert proposed > 0
    assert (spec_engine.spec_accepted - a0) / proposed < 0.5
    _assert_pool_free(spec_engine)


def test_default_ngram_drafter_identity(ref, spec_engine):
    base = [5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9]
    reqs = _serve(port_sched, spec_engine,
                  [(base, 14), (base[1:], 10)])
    for req in reqs:
        assert req.generated == _port_tokens(ref.params, ref.cfg, req)
    ss = spec_engine.spec_stats()
    assert ss["enabled"] and ss["k"] == 3
    assert 0 <= ss["accepted"] <= ss["proposed"]
    assert ss["accept_rate"] == round(
        ss["accepted"] / max(1, ss["proposed"]), 4)
    for ctx in ([1], [1, 2, 3, 1, 2, 3, 1], list(range(50))):
        for k in (1, 3, 4):
            d = port_paged.ngram_draft(ctx, k)
            assert d == ref.paged.ngram_draft(ctx, k) and len(d) == k
    _assert_pool_free(spec_engine)


def test_sampled_requests_fall_back_to_exact_sampling(ref, spec_engine):
    sched = Scheduler(spec_engine)
    mixed = [
        Request(list(range(4, 24)), max_new_tokens=8, rng=0),
        Request(list(range(6, 26)), max_new_tokens=8,
                temperature=0.8, top_k=20, rng=1),
        Request(list(range(8, 28)), max_new_tokens=8,
                temperature=0.7, top_p=0.9, rng=2),
    ]
    for r in mixed:
        sched.submit(r)
    sched.run_until_idle(10_000)
    for req in mixed:
        assert req.generated == _port_tokens(ref.params, ref.cfg, req)
    _assert_pool_free(spec_engine)


# ---------------------------------------------------------------------------
# the page pool and the prefix caches, beside the JAX package's
# ---------------------------------------------------------------------------


def test_page_pool_beside_the_reference(ref):
    cfg = ref.cfg
    port = port_paged.PagePool(cfg, 9, PTOK, device="cpu")
    jax_pool = ref.paged.PagePool(cfg, 9, PTOK)
    assert port.stats() == jax_pool.stats()
    calls = [("alloc", 3), ("alloc", 2), ("ref", [1, 2]), ("unref", [1]),
             ("unref", [1, 2, 3]), ("alloc", 4), ("unref", [4, 5, 6, 7]),
             ("ref", [2]), ("unref", [2, 2])]
    for name, arg in calls:
        a = getattr(port, name)(arg)
        b = getattr(jax_pool, name)(arg)
        assert a == b, name
        assert port.stats() == jax_pool.stats(), name
        assert port.shared_pages() == jax_pool.shared_pages()
        assert list(port.refs) == list(jax_pool.refs)
    with pytest.raises(port_paged.PageExhaustedError):
        port.alloc(9)
    with pytest.raises(RuntimeError, match="unref of free page"):
        port.unref([2])


def test_radix_cache_beside_the_reference(ref):
    rng = np.random.default_rng(5)
    shape = (2, 0, 2, 4)
    seqs = [list(range(1, 30)), list(range(1, 20)) + [99, 98, 97],
            list(range(1, 10)), [7, 7, 7, 7, 7, 7], list(range(1, 40))]
    kvs = [{n: rng.standard_normal(
        (shape[0], len(s)) + shape[2:]).astype(np.float32)
        for n in ("k", "v")} for s in seqs]
    budget = 40 * 2 * 2 * 2 * 4 * 4     # 40 tokens of k and v
    port = port_prefix.RadixPrefixCache(budget)
    jax_cache = ref.prefix.RadixPrefixCache(budget)
    handles = []
    for s, kv in zip(seqs, kvs):
        hp = port.match(s)
        hj = jax_cache.match(s)
        assert (hp is None) == (hj is None)
        if hp is not None:
            assert hp.length == hj.length
            for n in ("k", "v"):
                np.testing.assert_array_equal(hp.kv()[n].numpy(),
                                              np.asarray(hj.kv()[n]))
            handles.append((hp, hj))
        port.insert(s, {n: torch.from_numpy(a) for n, a in kv.items()})
        jax_cache.insert(s, kv)
        assert port.stats() == jax_cache.stats()
        assert port.pinned_nodes() == jax_cache.pinned_nodes()
        assert port.route_digests(4) == jax_cache.route_digests(4)
    for hp, hj in handles:
        port.release(hp)
        jax_cache.release(hj)
        assert port.pinned_nodes() == jax_cache.pinned_nodes()
    port.insert([50, 51, 52], {n: torch.zeros(2, 3, 2, 4)
                               for n in ("k", "v")})
    jax_cache.insert([50, 51, 52], {n: np.zeros((2, 3, 2, 4), np.float32)
                                    for n in ("k", "v")})
    assert port.stats() == jax_cache.stats()
    assert port.stats()["evictions"] > 0


def test_paged_index_beside_the_reference(ref):
    cfg = ref.cfg
    port_pool = port_paged.PagePool(cfg, 24, 4, device="cpu")
    jax_pool = ref.paged.PagePool(cfg, 24, 4)
    port = PagedPrefixIndex(port_pool, max_pages=6)
    jax_index = ref.prefix.PagedPrefixIndex(jax_pool, max_pages=6)
    seqs = [list(range(1, 11)), list(range(1, 9)) + [40, 41, 42],
            list(range(1, 14)), [3] * 9, list(range(1, 11))]
    held = []
    for s in seqs:
        hp, hj = port.match(s[:-1]), jax_index.match(s[:-1])
        assert (hp is None) == (hj is None)
        if hp is not None:
            assert (hp.pages, hp.length, hp.partial) == \
                (hj.pages, hj.length, hj.partial)
            held.append((hp, hj))
        n = -(-len(s) // 4)
        pp, pj = port_pool.alloc(n), jax_pool.alloc(n)
        assert pp == pj
        full, tail = pp[:len(s) // 4], (pp[len(s) // 4]
                                        if len(s) % 4 else None)
        port.insert_pages(s, full, tail)
        jax_index.insert_pages(s, full, tail)
        port_pool.unref(pp)
        jax_pool.unref(pj)
        assert port.stats() == jax_index.stats()
        assert port_pool.stats() == jax_pool.stats()
        assert port.route_digests() == jax_index.route_digests()
    for hp, hj in held:
        port.release(hp)
        jax_index.release(hj)
        assert port_pool.stats() == jax_pool.stats()
    assert port.stats()["evicted_pages"] > 0
    port.clear()
    jax_index.clear()
    assert port_pool.stats() == jax_pool.stats()
    assert port_pool.free_pages() == port_pool.usable_pages


def test_route_digests_equal_the_references(ref):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 128_256, 100).tolist()
    for block in (0, 1, 7, 16, 64):
        assert port_prefix.route_digest_chain(toks, block) == \
            ref.prefix.route_digest_chain(toks, block)


# ---------------------------------------------------------------------------
# zero-copy sharing and leaks on the real engine
# ---------------------------------------------------------------------------


def test_prefix_hit_is_zero_copy(ref):
    eng = _engine(ref)
    cache = PagedPrefixIndex(eng.pool)
    system = list(range(2, 2 + 2 * PTOK))   # exactly 2 full pages
    sched = Scheduler(eng, prefix_cache=cache)
    sched.submit(Request(system + [60, 61, 62], max_new_tokens=6, rng=0))
    sched.run_until_idle(10_000)
    h = cache.match(system + [70, 71, 72])
    pids = list(h.pages)
    cache.release(h)
    assert len(pids) == 2
    assert all(eng.pool.refs[p] == 1 for p in pids)  # the index only
    copied0, attached0 = eng.kv_bytes_copied, eng.shared_pages_attached
    warm = sched.submit(Request(system + [70, 71, 72], max_new_tokens=6,
                                rng=1))
    while warm.state != "decode":
        sched.step()
    assert all(eng.pool.refs[p] == 2 for p in pids)
    assert list(eng.block_tables[warm.slot, :2]) == pids
    sched.run_until_idle(10_000)
    assert all(eng.pool.refs[p] == 1 for p in pids)
    assert eng.kv_bytes_copied == copied0 == 0
    assert eng.shared_pages_attached == attached0 + 2
    assert sched.prefix_hits >= 1
    assert warm.generated == _port_tokens(ref.params, ref.cfg, warm)
    cache.clear()
    _assert_pool_free(eng)


def test_partial_tail_shares_via_cow(ref):
    eng = _engine(ref)
    cache = PagedPrefixIndex(eng.pool)
    prefix = list(range(2, 2 + PTOK + PTOK // 2))  # 1 page + half
    sched = Scheduler(eng, prefix_cache=cache)
    firsts = []
    for i, tail in enumerate([[90, 91, 92, 93], [95, 96, 97, 98]]):
        firsts.append(sched.submit(Request(prefix + tail, max_new_tokens=5,
                                           rng=i)))
        sched.run_until_idle(10_000)
    cow0 = eng.cow_pages
    again = sched.submit(Request(prefix + [90, 91, 92, 93],
                                 max_new_tokens=5, rng=0))
    sched.run_until_idle(10_000)
    assert eng.cow_pages == cow0 + 1, eng.kv_stats()
    assert eng.cow_bytes == eng.cow_pages * eng.pool.page_bytes()
    assert again.generated == firsts[0].generated \
        == _port_tokens(ref.params, ref.cfg, again)
    cache.clear()
    _assert_pool_free(eng)


def test_no_pages_leak_on_any_terminal_path(ref):
    eng = _engine(ref)
    cache = PagedPrefixIndex(eng.pool)
    prompt = list(range(1, 40))
    sched = Scheduler(eng, prefix_cache=cache)
    victim = sched.submit(Request(prompt, max_new_tokens=80, rng=0))
    sched.step()
    assert victim.state == "prefill"        # cancelled mid-prefill
    sched.cancel(victim.id)
    sched.run_until_idle(10_000)
    assert victim.reason == "cancelled"

    sched = Scheduler(eng, prefix_cache=cache)
    req = sched.submit(Request(prompt, max_new_tokens=80,
                               deadline=time.time() + 3600))
    t0 = time.time()
    while not req.generated and time.time() - t0 < 60:
        sched.step()
    req.deadline = time.time() - 0.001
    while req.reason is None and time.time() - t0 < 60:
        sched.step()
    assert req.reason == "deadline"

    sched = Scheduler(eng, prefix_cache=cache).start()
    drained = sched.submit(Request(prompt, max_new_tokens=12, rng=1))
    assert sched.drain(timeout=60)
    assert drained.reason == "length"

    sched = Scheduler(eng, prefix_cache=cache).start()
    corpse = sched.submit(Request(prompt, max_new_tokens=50, rng=2))
    killed = sched.submit(Request(prompt, max_new_tokens=80, rng=3))
    sched.stop()
    assert killed.reason in ("shutdown", "length")
    assert corpse.reason in ("shutdown", "length")

    assert eng.free_slots() == list(range(eng.max_slots))
    assert eng.pool.free_pages() == \
        eng.pool.usable_pages - cache.registered_pages()
    cache.clear()
    _assert_pool_free(eng)
