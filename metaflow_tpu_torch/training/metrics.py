"""Training-step telemetry: step time, tokens/sec, MFU, kernel-library
builds, device-memory high-water — emitted through the run's flight
recorder, under the JAX package's record and gauge names.

Wrap a train step with `instrument_train_step` (or pass `telemetry=...`
to `make_trainer`) and every step emits a `train.step` timer record with
tokens/sec and MFU attached; the first build or load of a kernel library
inside a step is the port's compile; an on-demand torch.profiler window
(telemetry.ProfileTrigger) can be armed on a live run.

Timing semantics: step N's duration is the interval between the starts
of step N and step N+1. The port's step is eager PyTorch: it enqueues
kernels and returns without waiting for the card, so on the CPU's clock
that interval measures dispatch until the launch queue fills. On a CUDA
device the interval therefore comes from CUDA events recorded on the
current stream at each step start: an event is read once it has
completed (`query()`), a step or two after it was recorded, and no step
synchronizes; `close()` synchronizes once and emits the rest. The input
stall (host time between a step's return and the next call) stays host
time. On the CPU the intervals are `perf_counter` readings, as in the JAX
package.
"""

import collections
import functools
import time

from .. import knobs
from .. import progress as progress_mod
from .. import telemetry
from ..ops import _build

# dense bf16 peak TFLOP/s per card, from NVIDIA's data sheets (SXM parts),
# substring-matched against torch.cuda.get_device_name
GPU_PEAK_TFLOPS = [
    ("h100", 989.0),
    ("h200", 989.0),
]

# HBM bandwidth GB/s per card, same sources (H100 SXM: HBM3, 3.35 TB/s)
GPU_HBM_GBPS = [
    ("h100", 3350.0),
    ("h200", 4800.0),
]


def peak_tflops(device_kind):
    """Published dense bf16 peak TFLOP/s for a card's name, or None.

    TPUFLOW_PEAK_TFLOPS overrides the table when it is set and parses, as
    in the JAX package; an empty or unparsable value falls through."""
    override = knobs.get_raw("TPUFLOW_PEAK_TFLOPS")
    if override:
        try:
            return float(override)
        except ValueError:
            pass
    kind = (device_kind or "").lower()
    return next((tf for sub, tf in GPU_PEAK_TFLOPS if sub in kind), None)


def hbm_gbps(device_kind):
    kind = (device_kind or "").lower()
    return next((bw for sub, bw in GPU_HBM_GBPS if sub in kind), None)


def flops_per_token_dense(n_params, n_layers, dim, seq):
    """Train-step FLOPs/token for a dense transformer (fwd+bwd = 3x fwd):
    6*N + 12*L*D*S, the PaLM appendix-B convention. Recomputation under
    remat is not counted, as MFU does not count it."""
    return 6.0 * n_params + 12.0 * n_layers * dim * seq


def _libraries_loaded():
    """Kernel libraries this process has built or loaded: the port's
    counterpart of the JAX step's compile cache."""
    return len(_build._LOADED)


def _tensors(tree):
    """The tensors of a tensor or a nested dict (other leaves skipped); of
    a DTensor (a state on a mesh), this rank's block."""
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree.to_local() if hasattr(tree, "to_local") else tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tensors(tree[key])


def _tree_device_bytes(tree):
    """Resident bytes of the tensors of a tree on this rank's device (a
    DTensor's block only)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _device_memory_bytes(device, state):
    """(in_use, peak) device memory in bytes: the allocator's counters on
    a CUDA device; on the CPU, which keeps no such counters, the bytes of
    the live train state, as the JAX package falls back to its live
    arrays."""
    import torch

    if device is not None and device.type == "cuda":
        return (torch.cuda.memory_allocated(device),
                torch.cuda.max_memory_allocated(device))
    in_use = _tree_device_bytes(state)
    return in_use, in_use


class TrainStepTelemetry(object):
    """Per-step metric emitter driven by instrument_train_step."""

    def __init__(self, tokens_per_step=None, flops_per_step=None,
                 prefix="train", memory_every=10, profile=True):
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.prefix = prefix
        self.memory_every = max(1, int(memory_every))
        self.step_num = 0
        self.compiles = 0
        self.compile_ms = 0.0
        self._compile_steps = set()
        self._device = None
        self._marks = collections.deque()  # (step_num, start mark)
        self._extra = {}  # step_num -> its stall_s and update_ms
        self._prev_return = None
        self._stalls = []
        self._intervals = []
        self._mem_peak = 0
        self._mem_split = {}
        self._update_ms = []
        self._per_chip = None  # (n_devices, peak_tflops, kind) lazy
        self._profile = None
        self._want_profile = profile
        self._closed = False
        self._step_ema_s = None  # steady-state step-time EMA (hang deadline)

    # ---------- lazy hardware context ----------

    def _bind(self, args):
        """The device the step runs on: that of the first tensor of its
        first argument (the train state); the CPU when there is none."""
        import torch

        first = next(_tensors(args[0] if args else None), None)
        self._device = (first.device if first is not None
                        else torch.device("cpu"))

    def _on_cuda(self):
        return self._device is not None and self._device.type == "cuda"

    def _chip_context(self):
        if self._per_chip is None:
            import torch
            import torch.distributed as dist

            n = (dist.get_world_size()
                 if dist.is_available() and dist.is_initialized() else 1)
            kind = (torch.cuda.get_device_name(self._device)
                    if self._on_cuda() else "cpu")
            self._per_chip = (n, peak_tflops(kind), kind)
        return self._per_chip

    def _trigger(self):
        if self._profile is None and self._want_profile:
            self._profile = telemetry.ProfileTrigger(
                recorder=telemetry.current_recorder(),
                cuda=self._on_cuda())
        return self._profile

    # ---------- step boundaries ----------

    def _mark(self):
        """A step-start mark: a CUDA event recorded on the current stream,
        or the host clock."""
        if self._on_cuda():
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self._device))
            return ev
        return time.perf_counter()

    def _drain(self, wait=False):
        """Emit every step whose own start and the next step's start are
        both known: on the card, once the later event has completed
        (without waiting unless `wait`)."""
        while len(self._marks) >= 2:
            (step_num, start), (_, stop) = self._marks[0], self._marks[1]
            if isinstance(stop, float):
                interval_s = stop - start
            else:
                if not (wait or stop.query()):
                    return
                interval_s = start.elapsed_time(stop) / 1000.0
            self._marks.popleft()
            self._emit_step(step_num, interval_s,
                            **self._extra.pop(step_num, {}))

    # ---------- per-step hooks ----------

    def before_step(self, args=()):
        now = time.perf_counter()
        if self._device is None:
            self._bind(args)
        trigger = self._trigger()
        if trigger is not None:
            trigger.on_step(self.step_num)
        # host time between the previous step's return and this call is
        # the input stall: the train loop was blocked in next(iterator)
        # (plus loop overhead) instead of dispatching — the signal that a
        # run is INPUT-bound. It lands inside step N-1's interval, so it
        # rides that step's record.
        if self._prev_return is not None:
            self._extra.setdefault(self.step_num - 1, {})["stall_s"] = (
                now - self._prev_return)
        self._marks.append((self.step_num, self._mark()))
        self._drain()
        # per-rank progress beat: the hang watchdog's liveness channel.
        # While a compile is still POSSIBLE — no steady-state interval
        # yet, or the step just before this one built a kernel library —
        # the much larger compile grace applies.
        compile_possible = (
            self._step_ema_s is None
            or (self.step_num - 1) in self._compile_steps)
        progress_mod.beat(
            step_num=self.step_num, phase=self.prefix,
            deadline_s=progress_mod.hang_deadline_s(
                ema_s=self._step_ema_s,
                compile_possible=compile_possible))
        return now

    def after_step(self, step_fn, call_started, pre_libraries, args):
        """Compile detection and the memory gauges."""
        dt = time.perf_counter() - call_started
        loaded = _libraries_loaded()
        if loaded > pre_libraries:
            # the step built or loaded a kernel library: the port's compile
            self.compiles += loaded - pre_libraries
            self.compile_ms += dt * 1000
            self._compile_steps.add(self.step_num)
            telemetry.emit("timer", "%s.compile" % self.prefix,
                           ms=dt * 1000, ok=True, step_num=self.step_num)
            telemetry.counter("%s.compile_cache_miss" % self.prefix)
        if self.step_num % self.memory_every == 0:
            state = args[0] if args else None
            in_use, peak = _device_memory_bytes(self._device, state)
            self._mem_peak = max(self._mem_peak, peak or in_use)
            telemetry.gauge(
                "%s.device_memory_bytes" % self.prefix, in_use,
                step_num=self.step_num,
                data={"peak": peak} if peak else None)
            self._emit_memory_split(state, peak or in_use)
        # diagnostic split-step mode (make_train_step timed_update=True)
        # exposes the update's time as an attribute; it rides this step's
        # record
        update_ms = getattr(step_fn, "last_update_ms", None)
        if update_ms is not None:
            self._extra.setdefault(self.step_num, {})["update_ms"] = float(
                update_ms)
        self.step_num += 1
        self._prev_return = time.perf_counter()

    def _emit_memory_split(self, state, peak):
        """Split the high-water gauge: params and optimizer state are the
        bytes of their tensors; activations is the remainder of the
        allocator peak (on the CPU, of the live state's bytes)."""
        if not (isinstance(state, dict) and "params" in state
                and "opt_state" in state):
            return
        params_b = _tree_device_bytes(state["params"])
        opt_b = _tree_device_bytes(state["opt_state"])
        split = {"params": params_b, "opt_state": opt_b}
        if peak:
            split["activations"] = max(0, int(peak) - params_b - opt_b)
        self._mem_split = split
        for key, value in split.items():
            telemetry.gauge("%s.memory.%s_bytes" % (self.prefix, key),
                            value, step_num=self.step_num)

    def _emit_step(self, step_num, interval_s, stall_s=None,
                   update_ms=None):
        if interval_s <= 0:
            return
        data = {}
        if step_num in self._compile_steps:
            # a library was built or loaded inside this interval: the
            # record is still emitted (with the flag), but it stays out of
            # the steady-state summary — its time is compile_ms
            data["compile"] = True
        else:
            self._intervals.append(interval_s)
            if stall_s is not None:
                self._stalls.append(stall_s)
            self._step_ema_s = (
                interval_s if self._step_ema_s is None
                else 0.8 * self._step_ema_s + 0.2 * interval_s)
        if stall_s is not None:
            data["input_stall_ms"] = round(stall_s * 1000, 3)
        if update_ms is not None:
            data["optimizer_update_ms"] = round(update_ms, 3)
            if "compile" not in data:
                self._update_ms.append(update_ms)
        if self.tokens_per_step:
            data["tokens_per_sec"] = round(
                self.tokens_per_step / interval_s, 1)
        if self.flops_per_step:
            n_devices, peak, _kind = self._chip_context()
            achieved_tflops = (
                self.flops_per_step / interval_s / n_devices / 1e12)
            data["tflops_per_chip"] = round(achieved_tflops, 3)
            if peak:
                data["mfu"] = round(achieved_tflops / peak, 4)
        telemetry.emit("timer", "%s.step" % self.prefix,
                       ms=interval_s * 1000, ok=True, step_num=step_num,
                       data=data or None)

    # ---------- finalization ----------

    def close(self):
        """Emit the trailing steps + summary gauges; stop any in-flight
        profiler capture. On the card this is the one synchronize.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._marks and self.step_num > 0:
            self._marks.append((self.step_num, self._mark()))
            if self._on_cuda():
                import torch

                torch.cuda.synchronize(self._device)
            self._drain(wait=True)
        # terminal progress beat: the loop is over
        progress_mod.done(step_num=self.step_num)
        if self._profile is not None:
            self._profile.stop(self.step_num)
        interval = self._goodput_interval()
        if interval is not None:
            # per-rank chip-second rollup in the goodput taxonomy
            telemetry.event("goodput.interval", data=interval)
        summary = self.report()
        for key in ("steps", "mean_step_ms", "tokens_per_sec", "mfu",
                    "input_stall_ms", "optimizer_update_ms",
                    "memory_params_bytes", "memory_opt_state_bytes",
                    "memory_activations_bytes",
                    "compiles", "compile_ms", "device_memory_peak_bytes"):
            value = summary.get(key)
            if value is not None:
                telemetry.gauge("%s.summary.%s" % (self.prefix, key), value)
        telemetry.flush()

    def _goodput_interval(self):
        """This rank's step time split into goodput categories
        (seconds): the `goodput.interval` event payload, schema pinned
        in tests/schema_validate.py::GOODPUT_INTERVAL_DATA_SCHEMA."""
        steady_s = sum(self._intervals)
        compile_s = self.compile_ms / 1000.0
        if steady_s <= 0 and compile_s <= 0:
            return None
        stall_s = sum(self._stalls)
        update_s = sum(self._update_ms) / 1000.0
        productive = max(0.0, steady_s - stall_s - update_s)
        return {
            "span_s": round(steady_s + compile_s, 3),
            "steps": len(self._intervals),
            "categories": {
                "productive_step": round(productive, 3),
                "compile": round(compile_s, 3),
                "input_stall": round(stall_s, 3),
                "transfer_stall": 0.0,  # no pipeline stage transport yet
                "update": round(update_s, 3),
            },
        }

    def report(self):
        """Summary dict over the recorded steps (steady-state: compile-
        flagged steps are left out; their time is compile_ms)."""
        out = {"steps": len(self._intervals), "compiles": self.compiles,
               "compile_cache_hits": max(0, self.step_num - self.compiles),
               "compile_ms": round(self.compile_ms, 1)}
        if self._mem_peak:
            out["device_memory_peak_bytes"] = self._mem_peak
        for key, value in self._mem_split.items():
            out["memory_%s_bytes" % key] = value
        if self._update_ms:
            out["optimizer_update_ms"] = round(
                sum(self._update_ms) / len(self._update_ms), 3)
        if not self._intervals:
            return out
        mean = sum(self._intervals) / len(self._intervals)
        out["mean_step_ms"] = round(mean * 1000, 3)
        if self._stalls:
            out["input_stall_ms"] = round(
                sum(self._stalls) / len(self._stalls) * 1000, 3)
        if self.tokens_per_step:
            out["tokens_per_sec"] = round(self.tokens_per_step / mean, 1)
        if self.flops_per_step:
            n_devices, peak, kind = self._chip_context()
            achieved = self.flops_per_step / mean / n_devices / 1e12
            out["tflops_per_chip"] = round(achieved, 3)
            out["device_kind"] = kind
            if peak:
                out["mfu"] = round(achieved / peak, 4)
        return out


def instrument_train_step(step_fn, tokens_per_step=None, flops_per_step=None,
                          prefix="train", memory_every=10, profile=True):
    """Wrap a train step so every call emits per-step telemetry.

    The wrapper adds only host-side bookkeeping: two perf_counter reads,
    on the card one CUDA event recorded and the pending ones queried, a
    count of the loaded kernel libraries, and one buffered record per
    step; it never synchronizes with the card.

    tokens_per_step: GLOBAL tokens consumed per step (batch*seq) — enables
        tokens/sec on every record.
    flops_per_step: GLOBAL FLOPs per step (e.g. flops_per_token_dense(...)
        * tokens) — enables achieved TFLOP/s and, with a known peak, MFU.
    profile: arm telemetry.ProfileTrigger (TPUFLOW_PROFILE_STEPS window,
        file/signal triggers) on this step counter.

    Returns the wrapped callable; `.telemetry` is the TrainStepTelemetry
    (call `.telemetry.close()` after the loop).
    """
    if knobs.get_str("TPUFLOW_CHAOS"):
        raise NotImplementedError(
            "TPUFLOW_CHAOS is set, but the port has no chaos harness yet "
            "(ROADMAP.md, slice 5: the chaos harness)")
    tel = TrainStepTelemetry(
        tokens_per_step=tokens_per_step, flops_per_step=flops_per_step,
        prefix=prefix, memory_every=memory_every, profile=profile)

    @functools.wraps(step_fn, assigned=("__name__", "__doc__"), updated=())
    def wrapped(*args, **kwargs):
        started = tel.before_step(args)
        pre = _libraries_loaded()
        out = step_fn(*args, **kwargs)
        tel.after_step(step_fn, started, pre, args)
        return out

    wrapped.telemetry = tel
    return wrapped
