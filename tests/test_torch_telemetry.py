"""The port's training telemetry against the JAX package's, on the CPU:
`make_trainer(telemetry=...)` on the tiny Llama in both packages gives
the same ordered records with the same data keys (timing values
dropped); every port record is valid under tests/schema_validate.py; the
params and optimizer-state bytes equal the reference's (less its scalar
step counters); `tpuflow metrics`' aggregate over the port's records
agrees with report(); ProfileTrigger's window, request-file and
close_recorder cases (tests/test_telemetry.py's, with torch.profiler);
progress beats and deadlines equal to the reference's; timed_update
giving the unsplit step's parameters; the lagged reading of CUDA events
(faked on the CPU); the card tables; and the knobs the port has no
subsystem for raising.

The JAX package is imported inside the `ref` fixture."""

import json
import os
import sys
import types
import zipfile

import numpy as np
import pytest
import torch

from metaflow_tpu_torch import progress as port_progress
from metaflow_tpu_torch import telemetry as port_tel
from metaflow_tpu_torch.datastore import LocalFlowDataStore
from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.training import metrics as port_metrics
from metaflow_tpu_torch.training import train_step as port_ts

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from schema_validate import (  # noqa: E402
    validate_core_record,
    validate_goodput_interval_record,
    validate_telemetry_record,
    validate_train_step_record,
)

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

STEPS = 4
TOKENS = (2, 65)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from metaflow_tpu import progress, telemetry
    from metaflow_tpu.cmd.metrics import aggregate
    from metaflow_tpu.datastore import FlowDataStore, LocalStorage
    from metaflow_tpu.models import llama
    from metaflow_tpu.spmd import MeshSpec, create_mesh
    from metaflow_tpu.training import metrics
    from metaflow_tpu.training import train_step

    return types.SimpleNamespace(
        jax=jax, llama=llama, ts=train_step, metrics=metrics,
        telemetry=telemetry, progress=progress, aggregate=aggregate,
        fds=lambda root: FlowDataStore("TelFlow", LocalStorage,
                                       ds_root=str(root)),
        mesh=lambda: create_mesh(MeshSpec.dp(), devices=jax.devices()[:1]))


@pytest.fixture(autouse=True)
def _quiet_knobs(monkeypatch):
    for name in ("TPUFLOW_PROFILE_STEPS", "TPUFLOW_PROFILE_REQUEST",
                 "TPUFLOW_PROFILE_SIGNAL", "TPUFLOW_CHAOS",
                 "TPUFLOW_SANITIZE"):
        monkeypatch.delenv(name, raising=False)
    # a peak for the CPU, so both packages put mfu on their records
    monkeypatch.setenv("TPUFLOW_PEAK_TFLOPS", "100")


def _tel_kwargs():
    B, S1 = TOKENS
    return {"tokens_per_step": B * (S1 - 1), "flops_per_step": 1e9,
            "memory_every": 2}


def _tokens(vocab):
    return np.random.default_rng(1).integers(0, vocab, TOKENS).astype(
        np.int32)


def _run_port(root, timed_update=False, steps=STEPS):
    """`steps` telemetry-wrapped steps of the port's tiny Llama trainer
    recording into a local datastore: (records, report)."""
    cfg = port_llama.LlamaConfig.tiny()
    fds = LocalFlowDataStore("TelFlow", str(root))
    port_tel.init_recorder(fds, "r1", "train", "7", attempt=1)
    try:
        state, step = port_ts.make_trainer(
            cfg, port_llama, device="cpu",
            generator=torch.Generator().manual_seed(0),
            optimizer=port_ts.default_optimizer(warmup_steps=1,
                                                total_steps=10),
            telemetry=_tel_kwargs(), timed_update=timed_update)
        batch = {"tokens": _tokens(cfg.vocab_size)}
        for _ in range(steps):
            state, _m = step(state, batch)
        step.telemetry.close()
        report = step.telemetry.report()
    finally:
        port_tel.close_recorder()
    return port_tel.read_run_records(fds, "r1"), report


def _run_ref(ref, root, timed_update=False):
    cfg = ref.llama.LlamaConfig.tiny()
    mesh = ref.mesh()
    fds = ref.fds(root)
    ref.telemetry.init_recorder(fds, "r1", "train", "7", attempt=1)
    try:
        state, step, _ = ref.ts.make_trainer(
            ref.jax.random.PRNGKey(0), cfg, mesh, ref.llama,
            optimizer=ref.ts.default_optimizer(warmup_steps=1,
                                               total_steps=10),
            telemetry=_tel_kwargs(), timed_update=timed_update)
        batch = ref.ts.shard_batch({"tokens": _tokens(cfg.vocab_size)},
                                   mesh)
        with mesh:
            for _ in range(STEPS):
                state, _m = step(state, batch)
        opt_scalars = sum(int(x.nbytes) for x in
                          ref.jax.tree.leaves(state["opt_state"])
                          if x.ndim == 0)
        step.telemetry.close()
        report = step.telemetry.report()
    finally:
        ref.telemetry.close_recorder()
    return ref.telemetry.read_run_records(fds, "r1"), report, opt_scalars


_COMPILE_RECORDS = ("train.compile", "train.compile_cache_miss")


def _shape(records, drop_compile=False):
    """(type, name, step_num, data keys) of every record, in order; with
    drop_compile, the JAX step's compile records and its step's compile
    flag are left out (the port's CPU step builds no kernel library)."""
    out = []
    for r in records:
        if drop_compile and r["name"] in _COMPILE_RECORDS:
            continue
        keys = set(r.get("data", {}))
        if drop_compile and r["name"] == "train.step":
            keys.discard("compile")
        out.append((r["type"], r["name"], r.get("step_num"),
                    tuple(sorted(keys))))
    return out


@pytest.mark.parametrize("timed_update", [False, True])
def test_records_match_jax(ref, tmp_path, timed_update):
    """The same records in the same order, with the same data keys, as the
    JAX trainer's, once the JAX step's compiles (its first jitted calls)
    are mapped away; the params split equal and the optimizer state's less
    the JAX state's scalar step counters (the port keeps its counts as
    Python ints); every record valid under the pinned schemas."""
    got, report = _run_port(tmp_path / "port", timed_update)
    want, ref_report, opt_scalars = _run_ref(ref, tmp_path / "jax",
                                             timed_update)
    assert _shape(got) == _shape(want, drop_compile=True)
    names = [r["name"] for r in got]
    assert names.count("train.step") == STEPS
    assert "goodput.interval" in names
    for rec in got:
        validate_telemetry_record(rec)
        if rec["name"] == "train.step":
            validate_train_step_record(rec)
            assert ("optimizer_update_ms" in rec["data"]) == timed_update
            assert "compile" not in rec["data"]
        elif rec["name"] == "goodput.interval":
            validate_goodput_interval_record(rec)
    assert report["memory_params_bytes"] == ref_report["memory_params_bytes"]
    assert opt_scalars == 8  # two int32 counts: adam's and the schedule's
    assert report["memory_opt_state_bytes"] == \
        ref_report["memory_opt_state_bytes"] - opt_scalars
    assert report["steps"] == STEPS and report["compiles"] == 0
    # the jitted JAX step compiles on its first calls (two on the CPU: the
    # donated state comes back committed), the split step never reports
    ref_compiles = [r for r in want if r["name"] == "train.compile"]
    assert ref_report["compiles"] == len(ref_compiles)
    assert bool(ref_compiles) != timed_update


def test_aggregate_agrees_with_report(ref, tmp_path):
    """`tpuflow metrics`' aggregate over the port's records gives
    report()'s step ms, input stall, update ms, memory and compiles (its
    tokens/s is a mean of per-step rates, report()'s the rate of the mean
    step, so it is held to the records' own mean)."""
    records, report = _run_port(tmp_path, timed_update=True)
    train = ref.aggregate(records)["train"]
    assert train["steps"] == STEPS
    assert train["mean_step_ms"] == pytest.approx(report["mean_step_ms"],
                                                  abs=2e-3)
    assert train["input_stall_ms"] == pytest.approx(
        report["input_stall_ms"], abs=2e-3)
    assert train["optimizer_update_ms"] == pytest.approx(
        report["optimizer_update_ms"], abs=2e-3)
    steps = [r for r in records if r["name"] == "train.step"]
    assert train["tokens_per_sec"] == pytest.approx(
        np.mean([r["data"]["tokens_per_sec"] for r in steps]), abs=0.1)
    assert train["mfu"] == pytest.approx(
        np.mean([r["data"]["mfu"] for r in steps]), abs=1e-4)
    assert train["compiles_total"] == report["compiles"] == 0
    for key in ("memory_params_bytes", "memory_opt_state_bytes",
                "device_memory_peak_bytes"):
        assert train[key + "_max"] == report[key]


def test_timed_update_gives_the_unsplit_parameters(tmp_path):
    """Three steps of the split step (backward, fence, update, fence)
    leave the parameters and moments of three unsplit steps, bit for bit,
    and the step reports each update's time."""
    cfg = port_llama.LlamaConfig.tiny()
    batch = {"tokens": _tokens(cfg.vocab_size)}
    states = {}
    for timed in (False, True):
        state, step = port_ts.make_trainer(
            cfg, port_llama, device="cpu",
            generator=torch.Generator().manual_seed(0),
            optimizer=port_ts.default_optimizer(warmup_steps=1,
                                                total_steps=10),
            timed_update=timed)
        for _ in range(3):
            state, _m = step(state, batch)
            assert (getattr(step, "last_update_ms", None) is not None) \
                == timed
        states[timed] = state
    for tree in ("params", "opt_state"):
        for (path, a), (_, b) in zip(
                port_ts.leaves(states[False][tree]),
                port_ts.leaves(states[True][tree])):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), path


def test_lagged_cuda_event_reads(monkeypatch):
    """On the card a step's record waits until the next step's start
    event has completed; nothing synchronizes before close(), which
    synchronizes once and emits the rest. Faked events that complete two
    marks after they are recorded stand in for the card."""
    emitted = []
    syncs = []

    class FakeEvent:
        def __init__(self, t):
            self.t, self.done = t, False

        def query(self):
            return self.done

        def elapsed_time(self, other):
            return (other.t - self.t) * 1000.0

    events = []

    def mark(self):
        for ev in events[:-1]:
            ev.done = True  # events complete two marks later
        events.append(FakeEvent(0.01 * len(events) ** 2))
        return events[-1]

    monkeypatch.setattr(port_metrics.TrainStepTelemetry, "_mark", mark)
    monkeypatch.setattr(port_metrics, "_device_memory_bytes",
                        lambda device, state: (1, 2))
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: syncs.append(device))
    monkeypatch.setattr(port_metrics.telemetry, "emit",
                        lambda rtype, name, **kw: emitted.append(
                            (name, kw.get("step_num"), kw.get("ms"))))
    monkeypatch.setattr(port_metrics.progress_mod, "beat",
                        lambda **kw: None)
    wrapped = port_metrics.instrument_train_step(lambda state: state,
                                                 tokens_per_step=10,
                                                 profile=False)
    wrapped.telemetry._device = torch.device("cuda")
    steps = [e for e in emitted if e[0] == "train.step"]
    for i in range(5):
        wrapped({})
        steps = [e for e in emitted if e[0] == "train.step"]
        # step j is read once mark j+1 completes, at mark j+3
        assert [s[1] for s in steps] == list(range(max(0, i - 2)))
    assert not syncs
    for e in events:
        e.done = False  # close() must not wait on query()
    wrapped.telemetry.close()
    assert len(syncs) == 1
    steps = [e for e in emitted if e[0] == "train.step"]
    assert [s[1] for s in steps] == list(range(5))
    for n, (_name, _step, ms) in enumerate(steps):
        assert ms == pytest.approx(10.0 * ((n + 1) ** 2 - n ** 2))


# ---------------------------------------------------------------------------
# the profiler window (tests/test_telemetry.py's cases, torch.profiler)
# ---------------------------------------------------------------------------


@pytest.fixture()
def recorder(tmp_path):
    fds = LocalFlowDataStore("TelFlow", str(tmp_path))
    rec = port_tel.init_recorder(fds, "r1", "train", "7", attempt=1)
    yield fds, rec
    port_tel.close_recorder()


def _tiny_step(state, batch):
    return state + batch.sum(), {"loss": batch.mean()}


def _trace_events(fds, path):
    with zipfile.ZipFile(fds.storage.full_uri(path)) as zf:
        assert zf.namelist() == [port_tel.PROFILE_TRACE_FILE]
        return json.loads(zf.read(port_tel.PROFILE_TRACE_FILE))["traceEvents"]


def test_window_trigger_uploads_artifact(recorder, monkeypatch):
    monkeypatch.setenv("TPUFLOW_PROFILE_STEPS", "1:3")
    fds, _rec = recorder
    wrapped = port_metrics.instrument_train_step(_tiny_step,
                                                 tokens_per_step=32)
    s = torch.zeros(())
    for _ in range(5):
        s, _m = wrapped(s, torch.ones(4, 8))
    wrapped.telemetry.close()
    profiles = port_tel.list_run_profiles(fds, "r1")
    assert len(profiles) == 1 and profiles[0].endswith(".zip")
    records = port_tel.read_run_records(fds, "r1")
    captured = [r for r in records if r["name"] == "profile.captured"]
    assert captured and captured[0]["data"]["artifact"] == profiles[0]
    assert captured[0]["data"]["start_step"] == 1
    assert captured[0]["data"]["stop_step"] == 3
    for rec in records:
        if rec["name"].startswith("profile."):
            validate_core_record(rec)
    names = {e.get("name") for e in _trace_events(fds, profiles[0])}
    assert "aten::sum" in names


def test_file_trigger(recorder, tmp_path):
    fds, rec = recorder
    request = tmp_path / "profile_request"
    request.write_text("2")
    trigger = port_tel.ProfileTrigger(
        recorder=rec, request_file=str(request), check_every=0.0,
        cuda=False)
    for i in range(6):
        trigger.on_step(i)
        torch.ones(4) * 2
    assert not request.exists()  # consumed when the capture started
    assert port_tel.list_run_profiles(fds, "r1")


def test_inflight_capture_stopped_at_recorder_close(recorder, monkeypatch):
    """A window that outlives the loop still uploads when the recorder
    closes (the task-finalization path)."""
    monkeypatch.setenv("TPUFLOW_PROFILE_STEPS", "1:100")
    fds, _rec = recorder
    wrapped = port_metrics.instrument_train_step(lambda x: x * 2)
    for _ in range(3):  # capture starts at step 1, never reaches 100
        wrapped(torch.ones(4))
    port_tel.close_recorder()
    assert port_tel.list_run_profiles(fds, "r1")
    assert not port_tel._live_triggers


# ---------------------------------------------------------------------------
# progress beats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [{}, {"TPUFLOW_HANG_FLOOR_S": "5",
                                      "TPUFLOW_HANG_DEADLINE_MULT": "3",
                                      "TPUFLOW_HANG_COMPILE_GRACE_S": "50"},
                                 {"TPUFLOW_HANG_FLOOR_S": "bad"}])
def test_hang_deadlines_match_jax(ref, monkeypatch, env):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for ema in (None, 0.0, 0.5, 30.0):
        for compile_possible in (False, True):
            assert port_progress.hang_deadline_s(ema, compile_possible) == \
                ref.progress.hang_deadline_s(ema, compile_possible)


def test_beats_match_jax(ref, tmp_path, monkeypatch):
    """The beater's payloads (throttled beats, the terminal beat) equal
    the JAX beater's but for the clock and pid; the module-level beats of
    a trainer with telemetry land in the bound task's `_progress.json`,
    as the JAX trainer's do inside a flow task."""
    monkeypatch.setenv("TPUFLOW_PROGRESS_EVERY_S", "0")
    payloads = []
    for mod, name in ((port_progress, "port"), (ref.progress, "jax")):
        path = str(tmp_path / name / "_progress.json")
        beater = mod.ProgressBeater(path, rank=2, attempt=1)
        beater.beat(step_num=3, phase="train", deadline_s=9.0)
        first = json.load(open(path))
        beater.done(step_num=4)
        payloads.append((first, json.load(open(path))))
    for port_p, jax_p in zip(*payloads):
        assert set(port_p) == set(jax_p)
        for key in ("step_num", "rank", "attempt", "phase", "deadline_s",
                    "done"):
            assert port_p[key] == jax_p[key], key
    # a trainer inside a bound task beats every step, then once done
    port_progress.set_task("TelFlow", "r1", "train", "7", attempt=1,
                           root=str(tmp_path / "tasks"))
    try:
        _run_port(tmp_path / "ds", steps=2)
        got = port_progress.read_progress(str(tmp_path / "tasks"),
                                          "TelFlow", "r1", "train", "7")
    finally:
        port_progress.clear_task()
    assert got["done"] and got["step_num"] == 2 and got["attempt"] == 1
    assert got["phase"] == "done"
    # outside a task the module-level beats are no-ops, as in the JAX
    # package outside a flow
    port_progress.beat(step_num=0)
    assert port_progress._beater is None


# ---------------------------------------------------------------------------
# tables and refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "NVIDIA H200",
                                  "TPU v5 lite", "TPU v5p", "cpu", None])
def test_card_tables_beside_jax(ref, monkeypatch, kind):
    """The port's tables name the cards it runs on, the JAX package's the
    TPUs: a kind is in at most one of them, and the override rules both."""
    monkeypatch.delenv("TPUFLOW_PEAK_TFLOPS")
    port = (port_metrics.hbm_gbps(kind), port_metrics.peak_tflops(kind))
    jax_ = (ref.metrics.hbm_gbps(kind), ref.metrics.peak_tflops(kind))
    assert None in (port[0], jax_[0]) and None in (port[1], jax_[1])
    if kind and "H100" in kind:
        assert port == (3350.0, 989.0)
    monkeypatch.setenv("TPUFLOW_PEAK_TFLOPS", "123.5")
    assert port_metrics.peak_tflops(kind) == \
        ref.metrics.peak_tflops(kind) == 123.5


def test_unported_knobs_raise(monkeypatch):
    cfg = port_llama.LlamaConfig.tiny()
    monkeypatch.setenv("TPUFLOW_CHAOS", "seed=1")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        port_metrics.instrument_train_step(lambda s: s)
    with pytest.raises(NotImplementedError, match="chaos"):
        port_ts.make_trainer(cfg, port_llama, device="cpu", telemetry=True)
    monkeypatch.delenv("TPUFLOW_CHAOS")
    monkeypatch.setenv("TPUFLOW_SANITIZE", "1")
    with pytest.raises(NotImplementedError, match="sanitizer"):
        port_ts.make_trainer(cfg, port_llama, device="cpu")
