"""The port's serving stack above the engine on the CPU, against the JAX
package's: the Scheduler driven beside the reference one by the same
pure-Python engine (admits, prefills, decodes, releases and emitted events
in the same order), the HTTP server over the port's PagedEngine (generate,
stream, healthz, stats, metrics, 413/429/503, the prefill -> decode
handoff), the serve.* records the port's flight recorder writes, the
serve command's builders, and the TPUFLOW_PEAK_TFLOPS override (F2)."""

import http.client
import json
import time

import numpy as np
import pytest
import torch

from metaflow_tpu_torch import goodput as port_goodput
from metaflow_tpu_torch import telemetry as port_telemetry
from metaflow_tpu_torch.cmd import serve as port_serve
from metaflow_tpu_torch.datastore.local import LocalFlowDataStore
from metaflow_tpu_torch.inference import decode as port_decode
from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.serving import disagg as port_disagg
from metaflow_tpu_torch.serving import scheduler as port_sched
from metaflow_tpu_torch.serving import tenancy as port_tenancy
from metaflow_tpu_torch.serving import (
    PagedEngine,
    PagedPrefixIndex,
    RadixPrefixCache,
    Request,
    Scheduler,
    ServingServer,
    SlotEngine,
)
from metaflow_tpu_torch.training import metrics as port_metrics

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

HTTP_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import importlib

    class Ref:
        pass

    r = Ref()
    for name in ("telemetry", "goodput", "serving.scheduler",
                 "serving.tenancy", "serving.disagg", "serving.paged",
                 "cmd.serve", "training.metrics", "models.llama"):
        setattr(r, name.split(".")[-1],
                importlib.import_module("metaflow_tpu." + name))
    return r


# ---------------------------------------------------------------------------
# F2: peak_tflops honours TPUFLOW_PEAK_TFLOPS by the reference's rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "123.5", "abc", ""])
def test_peak_tflops_override(ref, monkeypatch, value):
    if value is None:
        monkeypatch.delenv("TPUFLOW_PEAK_TFLOPS", raising=False)
    else:
        monkeypatch.setenv("TPUFLOW_PEAK_TFLOPS", value)
    for kind in ("NVIDIA H100 80GB HBM3", "TPU v5p", "cpu", None):
        got = port_metrics.peak_tflops(kind)
        want = ref.metrics.peak_tflops(kind)
        if value == "123.5":
            assert got == want == 123.5
        else:
            # each falls through to its own table
            low = (kind or "").lower()
            assert got == next((tf for sub, tf in
                                port_metrics.GPU_PEAK_TFLOPS
                                if sub in low), None)
            assert want == next((tf for sub, tf in
                                 ref.metrics.TPU_PEAK_TFLOPS
                                 if sub in low), None)
    assert port_metrics.peak_tflops("NVIDIA H100 80GB HBM3") == (
        123.5 if value == "123.5" else 989.0)


# ---------------------------------------------------------------------------
# the Scheduler beside the reference's, on one pure-Python engine
# ---------------------------------------------------------------------------


class _Log(object):
    """One ordered log of engine calls and telemetry records; the timing
    fields (ms, *_ms, ts) are left out."""

    def __init__(self):
        self.items = []

    def emit(self, rtype, name, ms=None, ok=None, inc=None, value=None,
             step_num=None, data=None):
        data = {k: v for k, v in (data or {}).items()
                if not k.endswith("_ms")}
        self.items.append((rtype, name, value, data))

    def event(self, name, data=None):
        self.emit("event", name, data=data)

    def gauge(self, name, value, step_num=None, data=None):
        self.emit("gauge", name, value=value, data=data)

    def counter(self, name, inc=1, data=None):
        self.emit("counter", name, inc=inc, data=data)


class _FakePool(object):
    def __init__(self, n_pages):
        self.usable_pages = n_pages
        self.free = n_pages

    def free_pages(self):
        return self.free

    def page_bytes(self):
        return 1024


class FakePagedEngine(object):
    """A paged engine with no device: tokens are a pure function of the
    prompt and the position, pages are a counter; every call is logged."""

    def __init__(self, log, max_slots=2, prefill_chunk=4, page_tokens=4,
                 pages=8, max_seq_len=64):
        self.log = log
        self.max_slots = max_slots
        self.prefill_chunk = prefill_chunk
        self.page_tokens = page_tokens
        self.max_seq_len = max_seq_len
        self.pool = _FakePool(pages)
        self.active = [False] * max_slots
        self._n_pages = [0] * max_slots
        self._ctx = [None] * max_slots
        self._state = [None] * max_slots

    def _call(self, *item):
        self.log.items.append(("engine",) + item)

    def free_slots(self):
        return [i for i in range(self.max_slots) if not self.active[i]]

    def occupancy(self):
        return sum(self.active) / self.max_slots

    def _pages_needed(self, prompt_len, max_new_tokens):
        return -(-(prompt_len + max_new_tokens) // self.page_tokens)

    def fits(self, prompt_len, max_new_tokens):
        return (prompt_len + max_new_tokens <= self.max_seq_len
                and self._pages_needed(prompt_len, max_new_tokens)
                <= self.pool.usable_pages)

    def can_admit(self, prompt_len, max_new_tokens):
        return self._pages_needed(prompt_len, max_new_tokens) \
            <= self.pool.free

    def max_context_tokens(self):
        return min(self.max_seq_len,
                   self.pool.usable_pages * self.page_tokens)

    def kv_stats(self):
        total = self.pool.usable_pages
        return {"enabled": True, "pages_total": total,
                "pages_free": self.pool.free,
                "occupancy": round((total - self.pool.free) / total, 4),
                "shared_pages": 0, "cow_pages": 0}

    def spec_stats(self):
        return {"enabled": False, "k": 0}

    def bind_slot_context(self, slot, ctx):
        self._ctx[slot] = dict(ctx) if ctx else None

    def slot_context(self, slot):
        return self._ctx[slot]

    def admit(self, slot, tokens, max_new_tokens, temperature=0.0,
              top_k=None, top_p=None, rng=0):
        self._call("admit", slot, list(tokens), max_new_tokens, rng)
        n = self._pages_needed(len(tokens), max_new_tokens)
        if n > self.pool.usable_pages:
            raise ValueError("never fits")
        self.pool.free -= n
        self._n_pages[slot] = n
        self.active[slot] = True
        self._state[slot] = {"prompt": list(tokens), "cursor": 0,
                             "tok": None, "pos": 0}

    def prefill_step(self, slot):
        st = self._state[slot]
        start = st["cursor"]
        end = min(start + self.prefill_chunk, len(st["prompt"]))
        st["cursor"] = end
        self._call("prefill", slot, start, end)
        if end < len(st["prompt"]):
            return end - start, None
        st["tok"] = sum(st["prompt"]) % 97
        st["pos"] = end
        return end - start, st["tok"]

    def decode_step(self):
        out = {}
        for slot in range(self.max_slots):
            st = self._state[slot]
            if st is None or st["tok"] is None:
                continue
            st["tok"] = (st["tok"] * 31 + st["pos"]) % 97
            st["pos"] += 1
            out[slot] = st["tok"]
        self._call("decode", sorted(out.items()))
        return out

    def release(self, slot):
        self._call("release", slot)
        self.pool.free += self._n_pages[slot]
        self._n_pages[slot] = 0
        self.active[slot] = False
        self._state[slot] = None
        self._ctx[slot] = None


def _scenario_fifo(m, eng):
    sched = m.scheduler.Scheduler(eng)
    reqs = [sched.submit(m.scheduler.Request(
        list(range(1 + i, 6 + 2 * i)), max_new_tokens=3 + i % 3,
        request_id="r%d" % i, eos_id=(13 if i == 3 else None)))
        for i in range(5)]
    sched.run_until_idle(1000)
    return reqs, sched


def _scenario_drr(m, eng):
    ten = m.tenancy.TenancyConfig(weights={"gold": 8, "free": 1, "bulk": 1},
                                  priorities={"gold": "high",
                                              "free": "normal",
                                              "bulk": "low"},
                                  budgets={"free": 12}, quantum=8)
    sched = m.scheduler.Scheduler(eng, tenancy=ten, max_queue=4)
    reqs, throttled = [], []
    # the fourth gold request finds the queue full and sheds the newest
    # bulk one; the second free one is over its queue share and budget
    for i, tenant in enumerate(["free", "bulk", "gold", "gold", "gold",
                                "free", "bulk"]):
        req = m.scheduler.Request(list(range(2, 8 + i)),
                                  max_new_tokens=2 + i % 2,
                                  request_id="t%d" % i, tenant=tenant)
        try:
            reqs.append(sched.submit(req))
        except m.scheduler.TenantThrottledError as ex:
            throttled.append((req.id, ex.tenant, ex.reason))
        except m.scheduler.QueueFullError:
            throttled.append((req.id, tenant, "queue_full"))
    sched.run_until_idle(1000)
    assert throttled
    reqs.append(m.scheduler.Request([1], max_new_tokens=1,
                                    request_id=repr(throttled)))
    return reqs, sched


def _scenario_deadline_cancel(m, eng):
    sched = m.scheduler.Scheduler(eng)
    past = m.scheduler.Request([1, 2, 3], max_new_tokens=4,
                               request_id="late", deadline=time.time() - 1)
    long = m.scheduler.Request(list(range(1, 20)), max_new_tokens=6,
                               request_id="long")
    mid = m.scheduler.Request(list(range(3, 10)), max_new_tokens=9,
                              request_id="mid")
    queued = m.scheduler.Request([4, 5], max_new_tokens=2,
                                 request_id="queued")
    tail = m.scheduler.Request([9, 8, 7], max_new_tokens=3,
                               request_id="tail")
    reqs = [sched.submit(r) for r in (past, long, mid, queued, tail)]
    sched.step()                      # reaps "late", admits long + mid
    assert long.state == "prefill"
    sched.cancel("long")              # cancelled mid-prefill
    sched.cancel("queued")            # cancelled in the queue
    sched.step()
    for _ in range(3):
        sched.step()
    mid.deadline = time.time() - 1    # expires mid-decode
    sched.run_until_idle(1000)
    return reqs, sched


def _scenario_drain(m, eng):
    sched = m.scheduler.Scheduler(eng)
    reqs = [sched.submit(m.scheduler.Request(
        list(range(1, 4 + i)), max_new_tokens=3, request_id="d%d" % i))
        for i in range(3)]
    sched.start()
    assert sched.drain(timeout=HTTP_TIMEOUT_S)
    with pytest.raises(m.scheduler.DrainingError):
        sched.submit(m.scheduler.Request([1], max_new_tokens=1))
    return reqs, sched


def _scenario_exhaustion(m, eng):
    sched = m.scheduler.Scheduler(eng)
    big = list(range(1, 9))           # 8 + 8 new = 4 pages
    little = [1, 2]                   # 2 + 2 new = 1 page
    reqs = [sched.submit(m.scheduler.Request(
        list(p), max_new_tokens=n, request_id="x%d" % i))
        for i, (p, n) in enumerate([(big, 8), (little, 2), (big, 8),
                                    (little, 2)])]
    for _ in range(3):
        sched.step()
    # the head (4 pages) waits for the pool; the little one behind it
    # would fit now but may not jump it
    assert reqs[2].state == "queued" and reqs[3].state == "queued"
    with pytest.raises(m.scheduler.CapacityError):
        sched.submit(m.scheduler.Request(list(range(40)),
                                         max_new_tokens=20))
    sched.run_until_idle(1000)
    return reqs, sched


SCENARIOS = {
    "fifo": (_scenario_fifo, {}),
    "drr_tenancy": (_scenario_drr, {"max_slots": 1}),
    "deadline_and_cancel": (_scenario_deadline_cancel, {}),
    "drain": (_scenario_drain, {}),
    "exhaustion_and_capacity": (_scenario_exhaustion,
                                {"max_slots": 4, "pages": 5}),
}


def _run_scenario(mods, name):
    run, kw = SCENARIOS[name]
    log = _Log()
    eng = FakePagedEngine(log, **kw)
    mods.telemetry.set_recorder(log)
    try:
        reqs, sched = run(mods, eng)
    finally:
        mods.telemetry.set_recorder(None)
    outcome = [(r.id, r.state, r.reason, list(r.generated), r.slot)
               for r in reqs]
    stats = sched.stats()
    counters = {k: stats[k] for k in ("served", "cancelled",
                                      "decode_steps", "peak_in_flight",
                                      "queue_depth", "in_flight")}
    counters["kv_exhausted"] = sched.kv_exhausted
    counters["tenancy"] = stats["tenancy"]
    for t in counters["tenancy"]["tenants"].values():
        t.pop("p50_ttft_ms"), t.pop("p99_ttft_ms")
    return log.items, outcome, counters


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_matches_the_reference(ref, name):
    class Port:
        scheduler, tenancy, telemetry = port_sched, port_tenancy, \
            port_telemetry

    class Jax:
        scheduler, tenancy, telemetry = ref.scheduler, ref.tenancy, \
            ref.telemetry

    got = _run_scenario(Port, name)
    want = _run_scenario(Jax, name)
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[0] == want[0]
    assert any(item[0] == "engine" for item in got[0])


# ---------------------------------------------------------------------------
# the HTTP server over the port's PagedEngine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = port_llama.LlamaConfig.tiny()
    params = port_llama.init_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    return cfg, params


def _paged(tiny, **kw):
    cfg, params = tiny
    kw.setdefault("spec_k", 3)
    return PagedEngine(params, cfg, max_slots=4, max_seq_len=128,
                       prefill_chunk=16, page_tokens=16, device="cpu", **kw)


def _http(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        data = body if isinstance(body, (bytes, type(None))) \
            else json.dumps(body).encode()
        conn.request(method, path, data)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _generate_tokens(tiny, prompt, n, **kw):
    cfg, params = tiny
    out = port_decode.generate(params, [prompt], cfg, n, device="cpu", **kw)
    return out[0, len(prompt):].tolist()


def test_server_generate_stream_stats_and_metrics(ref, tiny):
    from schema_validate import validate_healthz

    eng = _paged(tiny)
    cache = PagedPrefixIndex(eng.pool)
    srv = ServingServer(Scheduler(eng, prefix_cache=cache)).start()
    try:
        prompt = list(range(3, 40))
        code, _, body = _http(srv, "POST", "/v1/generate",
                              {"tokens": prompt, "max_new_tokens": 7})
        assert code == 200
        body = json.loads(body)
        assert body["reason"] == "length"
        assert body["new_tokens"] == _generate_tokens(tiny, prompt, 7)
        assert body["tokens"] == prompt + body["new_tokens"]
        sampled = {"tokens": prompt[:20], "max_new_tokens": 6,
                   "temperature": 0.8, "top_p": 0.95, "seed": 4,
                   "stream": True}
        code, headers, raw = _http(srv, "POST", "/v1/generate", sampled)
        assert code == 200 and headers["Transfer-Encoding"] == "chunked"
        lines = [json.loads(x) for x in raw.decode().splitlines()
                 if x.startswith("{")]
        want = _generate_tokens(tiny, prompt[:20], 6, temperature=0.8,
                                top_p=0.95, rng=4)
        assert [x["token"] for x in lines[:-1]] == want
        assert lines[-1] == {"done": True, "reason": "length",
                             "new_tokens": want}
        code, _, body = _http(srv, "GET", "/healthz")
        health = json.loads(body)
        validate_healthz(health)
        assert health["kv_pages"]["enabled"] is True
        assert health["prefix_cache"]["enabled"] is True
        code, _, body = _http(srv, "GET", "/v1/stats")
        stats = json.loads(body)
        assert stats["kv_pages"]["pages_total"] == eng.pool.usable_pages
        assert stats["speculative"] == eng.spec_stats()
        assert stats["speculative"]["enabled"] and stats["served"] == 2
        # /metrics renders the SAME stats dict /v1/stats serves
        frozen = srv.scheduler.stats()
        srv.scheduler.stats = lambda: frozen
        code, headers, body = _http(srv, "GET", "/metrics")
        assert code == 200
        assert headers["Content-Type"] == \
            ref.goodput.OPENMETRICS_CONTENT_TYPE
        want = ref.goodput.render_openmetrics(
            ref.goodput.scheduler_metric_families(frozen))
        assert body.decode() == want
        assert port_goodput.render_openmetrics(
            port_goodput.scheduler_metric_families(frozen)) == want
        ref.goodput.parse_openmetrics(body.decode())
    finally:
        srv.close()
    cache.clear()
    assert eng.pool.free_pages() == eng.pool.usable_pages


def test_server_sheds_413_429_503(tiny):
    eng = _paged(tiny, spec_k=0)
    srv = ServingServer(Scheduler(eng, max_queue=0)).start()
    try:
        code, headers, _ = _http(srv, "POST", "/v1/generate", {
            "tokens": list(range(1, 60)), "max_new_tokens": 500})
        assert code == 413 and int(headers["Retry-After"]) >= 1
        code, headers, _ = _http(srv, "POST", "/v1/generate", {
            "tokens": [1, 2, 3], "max_new_tokens": 2})
        assert code == 429 and "Retry-After" in headers
        code, _, _ = _http(srv, "POST", "/v1/generate", {"tokens": []})
        assert code == 400
        assert srv.scheduler.drain(timeout=HTTP_TIMEOUT_S)
        code, headers, _ = _http(srv, "POST", "/v1/generate", {
            "tokens": [1, 2, 3], "max_new_tokens": 2})
        assert code == 503 and "Retry-After" in headers
    finally:
        srv.close()


def test_prefill_decode_handoff(ref, tiny):
    """/v1/prefill on one server answers the handoff frame; /v1/decode on
    another takes it and gives generate()'s tokens. The JAX package's
    decode_handoff reads the frame."""
    prefill = ServingServer(Scheduler(_paged(tiny, spec_k=0)),
                            role="prefill").start()
    decode = ServingServer(Scheduler(_paged(tiny, spec_k=0)),
                           role="decode").start()
    try:
        prompt = list(range(7, 30))
        code, _, frame = _http(prefill, "POST", "/v1/prefill",
                               {"tokens": prompt, "max_new_tokens": 6})
        assert code == 200
        meta, kv = ref.disagg.decode_handoff(frame)
        port_meta, port_kv = port_disagg.decode_handoff(frame)
        assert meta == port_meta and meta["prompt_tokens"] == len(prompt)
        for name in ("k", "v"):
            np.testing.assert_array_equal(np.asarray(kv[name]),
                                          port_kv[name].numpy())
        assert port_disagg.encode_handoff(meta, port_kv) == \
            ref.disagg.encode_handoff(meta, kv)
        code, _, body = _http(decode, "POST", "/v1/decode", frame)
        assert code == 200
        assert json.loads(body)["new_tokens"] == \
            _generate_tokens(tiny, prompt, 6)
    finally:
        prefill.close()
        decode.close()
    bf16 = {"k": torch.randn(2, 3, 2, 4).bfloat16(),
            "v": torch.randn(2, 3, 2, 4).bfloat16()}
    frame = port_disagg.encode_handoff({"first": 1}, bf16)
    meta, kv = ref.disagg.decode_handoff(frame)
    assert str(kv["k"].dtype) == "bfloat16"
    _, back = port_disagg.decode_handoff(
        ref.disagg.encode_handoff(meta, kv))
    assert torch.equal(back["k"], bf16["k"])
    assert torch.equal(back["v"], bf16["v"])


# ---------------------------------------------------------------------------
# the flight recorder's serve.* records
# ---------------------------------------------------------------------------


def test_serving_records_pass_the_schema(ref, tiny, tmp_path):
    from schema_validate import validate_serving_record

    from metaflow_tpu.datastore import FlowDataStore, LocalStorage

    eng = _paged(tiny, spec_k=2, total_pages=12)
    cache = PagedPrefixIndex(eng.pool, max_pages=3)
    fds = LocalFlowDataStore("PortServe", str(tmp_path))
    port_telemetry.init_recorder(fds, "1", "_serve", "port-test")
    try:
        sched = Scheduler(eng, prefix_cache=cache)
        system = list(range(2, 34))
        reqs = [sched.submit(Request(system + [59], max_new_tokens=4))]
        sched.run_until_idle(10_000)     # registers the system prompt
        reqs += [sched.submit(Request(system + [60 + i], max_new_tokens=4,
                                      rng=i, tenant="t%d" % (i % 2)))
                 for i in range(3)]
        reqs.append(sched.submit(Request(list(range(1, 60)),
                                         max_new_tokens=40)))
        victim = sched.submit(Request([1, 2, 3], max_new_tokens=50))
        for _ in range(2):
            sched.step()
        sched.cancel(victim.id)
        sched.run_until_idle(10_000)
    finally:
        port_telemetry.close_recorder()
    records = port_telemetry.read_run_records(fds, "1")
    serve = [r for r in records if r["name"].startswith("serve.")]
    for rec in serve:
        validate_serving_record(rec)
    names = {r["name"] for r in serve}
    for name in ("serve.request.queued", "serve.request.prefill",
                 "serve.request.first_token", "serve.request.finished",
                 "serve.request.cancelled", "serve.kv.page_alloc",
                 "serve.kv.page_free", "serve.kv.page_shared",
                 "serve.kv.exhausted", "serve.prefix.hit",
                 "serve.prefix.miss", "serve.decode_step",
                 "serve.prefill_chunk", "serve.spec.accept_rate"):
        assert name in names, name
    jax_fds = FlowDataStore("PortServe", LocalStorage, ds_root=str(tmp_path))
    assert ref.telemetry.read_run_records(jax_fds, "1") == records
    cache.clear()
    assert eng.pool.free_pages() == eng.pool.usable_pages


# ---------------------------------------------------------------------------
# the serve command's builders
# ---------------------------------------------------------------------------


def test_build_config_matches_the_reference(ref):
    import dataclasses

    fields = json.dumps({"vocab_size": 512, "dim": 128, "n_layers": 2,
                         "n_heads": 4, "n_kv_heads": 2, "ffn_dim": 256,
                         "dtype": "float32"})
    got = port_serve.build_config(None, config_json=fields)
    want = ref.serve.build_config(None, config_json=fields)
    common = set(f.name for f in dataclasses.fields(got)) & \
        set(f.name for f in dataclasses.fields(want))
    assert common >= set(json.loads(fields))
    assert {n: getattr(got, n) for n in common} == \
        {n: getattr(want, n) for n in common}
    assert port_serve.build_config({"cfg": {"dim": 64}}).dim == \
        ref.serve.build_config({"cfg": {"dim": 64}}).dim == 64
    for bad in ('{"dim": 64, "bogus": 1}', "not json", None):
        with pytest.raises(Exception) as want_ex:
            ref.serve.build_config({}, config_json=bad)
        with pytest.raises(port_serve.ServeError) as got_ex:
            port_serve.build_config({}, config_json=bad)
        assert str(got_ex.value) == str(want_ex.value)
    assert port_serve.extract_params({"params": 1}) == 1
    assert port_serve.extract_params({"w": 1}) == {"w": 1}


def test_build_engine_and_prefix_cache(ref, tiny, monkeypatch):
    cfg, params = tiny
    kw = dict(slots=2, max_seq_len=64, prefill_chunk=16, device="cpu")
    monkeypatch.delenv("TPUFLOW_PAGED", raising=False)
    monkeypatch.delenv("TPUFLOW_PREFIX_CACHE_MB", raising=False)
    assert isinstance(port_serve.build_engine(params, cfg, **kw),
                      SlotEngine)
    eng = port_serve.build_engine(params, cfg, paged=True, page_tokens=16,
                                  spec_k=2, **kw)
    assert isinstance(eng, PagedEngine) and eng.spec_k == 2
    monkeypatch.setenv("TPUFLOW_PAGED", "1")
    assert isinstance(port_serve.build_engine(params, cfg, **kw),
                      PagedEngine)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        port_serve.build_engine(params, cfg, mesh_spec="fsdp", **kw)

    ref_pool = ref.paged.PagePool(ref.llama.LlamaConfig.tiny(),
                                  eng.pool.n_pages, 16)
    assert ref_pool.page_bytes() == eng.pool.page_bytes()

    class RefEngine:
        pool = ref_pool

    slot = SlotEngine(params, cfg, max_slots=2, max_seq_len=64,
                      device="cpu")
    for mb in (None, 0, 1, 64):
        got = port_serve.build_prefix_cache(eng, mb)
        want = ref.serve.build_prefix_cache(RefEngine(), mb)
        assert type(got).__name__ == type(want).__name__
        if got is not None:
            assert got.max_pages == want.max_pages
        got = port_serve.build_prefix_cache(slot, mb)
        want = ref.serve.build_prefix_cache(object(), mb)
        assert type(got).__name__ == type(want).__name__
        if got is not None:
            assert isinstance(got, RadixPrefixCache)
            assert got.max_bytes == want.max_bytes
    monkeypatch.setenv("TPUFLOW_PREFIX_CACHE_MB", "1")
    got = port_serve.build_prefix_cache(eng)
    want = ref.serve.build_prefix_cache(RefEngine())
    assert got.max_pages == want.max_pages
    assert port_serve.build_prefix_cache(slot).max_bytes == \
        ref.serve.build_prefix_cache(object()).max_bytes


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "slot"])
def test_serve_entry_point(tiny, paged):
    """serve(block=False) wires engine -> prefix cache -> Scheduler ->
    ServingServer and returns the running server."""
    cfg, params = tiny
    echoed = []
    srv = port_serve.serve(params, cfg, port=0, slots=2, max_seq_len=64,
                           prefill_chunk=16, paged=paged, page_tokens=16,
                           spec_k=2, prefix_cache_mb=1, device="cpu",
                           echo=echoed.append, block=False)
    sched = srv.scheduler
    try:
        assert "127.0.0.1:%d" % srv.port in echoed[0]
        assert ("paged" in echoed[0]) == paged
        assert isinstance(sched.engine, PagedEngine if paged else SlotEngine)
        assert isinstance(sched.prefix_cache,
                          PagedPrefixIndex if paged else RadixPrefixCache)
        prompt = list(range(5, 30))
        code, _, body = _http(srv, "POST", "/v1/generate",
                              {"tokens": prompt, "max_new_tokens": 5})
        assert code == 200
        assert json.loads(body)["new_tokens"] == \
            _generate_tokens(tiny, prompt, 5)
        code, _, body = _http(srv, "GET", "/v1/stats")
        stats = json.loads(body)
        assert stats["served"] == 1
        assert stats["speculative"]["enabled"] == paged
    finally:
        assert srv.shutdown(timeout=HTTP_TIMEOUT_S)
    if paged:
        sched.prefix_cache.clear()
        pool = sched.engine.pool
        assert pool.free_pages() == pool.usable_pages
