#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--baseline CHECKOUT] [--phases 0,3,10]

--phases: run phase 0 (always) and the listed phases only (default: every
phase). A phase that needs another's output builds its own (phase 3 the
8B weights); the kernel report then carries each kernel with its numbers
null, since they come from phases 1, 2 and 4-9.

--baseline CHECKOUT: a directory holding an earlier checkout's
metaflow_tpu_torch/ops/csrc (e.g. `git archive <commit>
metaflow_tpu_torch/ops/csrc | tar -x -C _checkout/old`) whose C entry
points take this tree's arguments; its flash_bwd.cu, flash_fwd.cu and
gmm.cu are built beside this tree's, and its K2 and K3 (phase 4), K6
(phase 6) and K4 (phase 8a, diagonal and full hop) are timed against this
tree's in turns (earlier, this, this, earlier), each through this tree's
wrappers. Without it those timings are left out and everything else
runs.

Phase 0  prints the card's name and power limit, builds every kernel
         (K1 and K4 in flash_fwd.cu, K2/K3 in flash_bwd.cu, K5/K6 in
         gmm.cu) from metaflow_tpu_torch/ops/csrc with one nvcc per source
         started together, prints ptxas' registers and spills and, for the
         wgmma kernels (K1 and K4, K2, K3, K5, K6), their dynamic shared
         memory and the HGMMA (wgmma) and UTMALDG (TMA) instructions in
         their SASS, and turns TF32 off.
Phase 1  holds K1 against its plain PyTorch version at the cases of
         ops/fault_check.py's FWD_CASES, the inference shape last, and
         times K1, the plain version and PyTorch's
         scaled_dot_product_attention under each backend that runs (flash,
         cuDNN, efficient; a yardstick only: the port never calls it) at
         the inference shape.
Phase 2  runs the Llama-3-8B forward at full width and depth in bf16 with
         random weights on tokens [2, 2048]: attention_impl="auto" must
         launch K1 once per layer, and its logits must agree with the
         plain-attention forward.
Phase 3  serves requests through SlotEngine: (a) a 2-layer full-width
         float32 model must give the tokens generate() gives, request for
         request; (b) the full bf16 model serves 8 mixed requests to
         completion with no slot leaked.
Phase 4  holds K2 (dq) and K3 (dk, dv) against their plain version at four
         shapes, the training shape last, and times K1, K2, K3, their plain
         versions and SDPA's forward and backward under each backend (the
         fastest is K1's and the K2 + K3 pair's yardstick) at the training
         shape.
Phase 5  trains bench_1b: (a) a 2-layer full-width float32 model's loss
         gradients through K1/K2/K3 must equal the plain-attention ones;
         (b) the full bf16 model takes 5 AdamW steps on tokens [8, 2049],
         each launching K1 32 times and K2, K3 16 times, every K2/K3 launch
         of step 2 held against its plain version, the loss falling from
         step 1 to step 4; prints step ms, tokens/s, MFU and peak memory.
Phase 6  holds the grouped-matmul kernels K5 (forward, and on the
         transposed weights for dx) and K6 (dw, f32 and bf16 out) against
         their plain versions at the cases of ops/fault_check.py's
         GMM_CASES (empty and one-row groups, row_valid padding, D and F
         tails, a real tile forced inactive, f32 and bf16), Mixtral-8x7B's
         down and gate/up training shapes and the gate/up shape with 70 %
         of the rows in one group last; K6's bf16 output must equal its f32
         one rounded once, and its distance from the plain sum rounded once
         is counted in bf16 ulps. Times K5, K6, their plain versions and
         torch._grouped_mm (a yardstick only: the port never calls it)
         with K6's output dtype there.
Phase 7  trains Mixtral-8x7B at full width, 2 of 32 layers, with
         moe_dispatch="gmm": (a) in float32 on tokens [2, 513], the loss and
         every gradient through K5/K6 (and K1-K3) must equal the ones
         through plain gmm, with both runs routing every token alike;
         (b) in bf16, 5 AdamW steps on tokens [4, 2049], each launching K5
         18 and K6 6 times (and K1 4, K2 and K3 2), step 0 profiled by
         kernel, every K5/K6 launch of step 2 held against its plain
         version, step 3 run with host synchronisation forbidden, the loss
         falling from step 1 to step 4;
         prints step ms, tokens/s, MFU and peak memory; (c) generate()
         serves 2 prompts x 16 new tokens with the trained bf16 model.
Phase 8  runs ring attention over the sequence axis on a LocalRing (n
         sequence shards of one device's tensors): (a) holds the ring hop's
         forward K4 (flash_block_fwd) against its plain version at the cases
         of ops/fault_check.py's BLOCK_FWD_CASES (shard views, diagonal and
         full, f32 and bf16, head dims 64 and 128, GQA), bench_1b's 8k hop
         last, and times K4, the plain version and SDPA's flash forward
         with its lse (a yardstick only) there; (b) ring_attention on
         LocalRing(2) and (4) against flash_attention (K1-K3), outputs and
         gradients; (c) a 2-layer full-width float32 bench_1b on tokens
         [1, 2049] with LocalRing(4): the loss and every gradient through
         K4/K2/K3 must equal plain attention's; (d) trains bench_1b with
         attention_impl="ring" at 8k context, 5 AdamW steps on tokens
         [2, 8193] with LocalRing(4), each launching K4 320 and K2, K3 160
         times and K1 never, step 0 profiled, every K4 launch of step 2 held
         against its plain version, step 0's loss within 5e-3 of the K1
         model's, the loss falling from step 1 to step 4; (e) the
         Llama-3-8B forward on tokens [1, 8192] through the ring (320 K4
         launches) against the K1 forward.
Phase 9  trains as the JAX package's benchmark does on an accelerator, on
         memory_efficient_optimizer (factored Adafactor): (a) bench_1b
         uncut in bf16 on tokens [32, 2049], 5 steps under each of
         remat_policy None, "dots" and "attn_out" (a policy out of memory
         at 32 rows is recorded and run at 16), each step launching K1 32
         and K2, K3 16 times, the loss falling; (b) bench_1b fed by
         ResumableTokenBatches through prefetch onto the card, an async
         checkpoint saved after step 2 through the port's local datastore,
         a new trainer restored from it reruns steps 3-4 from the saved
         data stamp: its losses and weights within 1e-3 of the
         uninterrupted run's (bit identity and save()'s blocking time
         printed); (c) Llama-3-8B uncut (32 layers, 8.03 B parameters) in
         bf16 on tokens [4, 2049], 5 steps, each launching K1 64 and K2, K3
         32 times, step 1 profiled by operator (select_backward's share),
         every K2/K3 launch of step 2 held against its plain version, the
         loss falling; peak memory split into parameters, gradients,
         optimizer state and the rest. Each prints step ms, tokens/s and
         MFU.

Phase 10 serves through the whole stack users run, built by the port's
         entry point cmd/serve.py serve(): HTTP -> ServingServer ->
         Scheduler -> PagedEngine with the paged prefix index: (a) a narrow float32 Llama (dim 512, 4 layers, GQA 8/2,
         vocab 32000, pages of 16 tokens) must give, token for token,
         generate()'s greedy tokens, the same with spec_k 0 and 3, with
         the chunked and the dense attention path, with prefix hits as
         cold, and SlotEngine's sampled tokens (a position whose f32 top-2
         logit gap is under 1e-5 is printed and let pass); (b) Llama-3-8B
         uncut in bf16 (8.03 B parameters) on PagedEngine(max_slots=16,
         max_seq_len=4096, page_tokens=16, prefill_chunk=64) with a
         2048 MB PagedPrefixIndex serves 32 requests posted at once from
         32 client threads (prompts of 17-2000 tokens, 16 of them after
         one warmed 1024-token system prompt, 64 new tokens each, half
         greedy, half sampled, 8 streamed), once with spec_k 0 and once
         with spec_k 3: every response 200 and "length", at least 15
         zero-copy prefix hits with no KV bytes copied, no page leaked
         after the drain; prints TTFT, decode tokens/s, requests/s, page
         occupancy, the spec accept rate and peak memory, with phase 3b's
         SlotEngine figures beside them; a third pass of spec_k 0's
         traffic profiles decode steps 40-49 (device-busy time against
         wall time, device operations and launch calls per step, the loop
         thread's CPU share) and cancels the rest; where a greedy
         request's spec_k 3 tokens part from its spec_k 0 tokens, the
         first differing position's top-2 logit gap, the gap between the
         two chosen tokens and the K1-vs-plain logit difference there are
         printed, and a chosen gap over that difference (no bf16 near
         tie) fails the phase. The engine's prefill and decode
         launch no kernel (the JAX engine reaches no Pallas kernel
         either); their launch counts are printed.
Phase 11 trains as a user's flow step does: (a) Llama-3-8B uncut in bf16
         on memory_efficient_optimizer at tokens [4, 2049] for 8 steps,
         fed by StreamingTokenBatches from a seeded corpus built with
         build_corpus into a LocalFlowDataStore (through prefetch onto the
         card), make_trainer(telemetry=...) recording into a
         FlightRecorder, TPUFLOW_PROFILE_STEPS=4:6: one train.step record
         a step with the pinned keys, the records' tokens/s within 3 % of
         CUDA events around each call (one synchronize at the end), mfu =
         tflops_per_chip / peak, train.memory.params_bytes the parameters'
         bytes, the recorded peak torch.cuda.max_memory_allocated(), one
         profile whose trace holds 64/32/32 K1/K2/K3 launches a step,
         goodput.interval and the data.* records; (b) bench_1b as 5b with
         timed_update: optimizer_update_ms on every record, the
         parameters after 3 steps bit for bit the unsplit step's; (c)
         Ulysses: ulysses_attention on LocalRing(2) and (4) against
         K1-K3 at bench_1b's heads and S 8192, bench_1b trained at 8k
         through Ulysses (K1 128, K2/K3 64 launches a step, step 0 within
         5e-3 of the K1 model's loss) beside the ring's step in turns, and
         the Llama-3-8B 8k prefill through it beside the ring and K1.

Phase 12 runs a user's flow on the card through the port's own command
         line and flow layer: (a) writes train_flow.py into a temporary
         directory (its free bytes printed) and runs `python train_flow.py
         run` as a subprocess with TPUFLOW_DATASTORE_SYSROOT_LOCAL there:
         start -> train (@gpu(require_gpu=True) @checkpoint) -> end, where
         train builds Llama-3-8B uncut on memory_efficient_optimizer with
         phase 9c's seeds, takes 3 steps on tokens [4, 2049], records its
         losses, current.gpu's card, its K1/K2/K3 launches a step and a
         digest of every parameter's bytes, and saves the parameters with
         current.checkpoint (16.06 GB); the run is read back through the
         port's client: successful, finite losses, the H100, 64/32/32
         launches a step; (b) `python -m metaflow_tpu_torch serve TrainFlow
         --paged --spec-k 3` as a subprocess on a free port: /healthz,
         8 requests (prompts of 17-2000 tokens, 64 new tokens, 4 streamed)
         all 200 and whole, SIGTERM, a drained exit 0; then
         load_run_checkpoint("TrainFlow") here, whose parameters' digest
         must be the trained ones'. Prints the run's wall seconds, the
         median step ms beside 9c's, save seconds and bytes, restore
         seconds, load-to-ready seconds, client TTFT p50 and decode tok/s.

Phase 13 runs a user's flow whose gang step trains on a mesh of every
         card: this process first returns its cached blocks on card 0
         (gc, empty_cache; its CUDA context stays) and prints what it
         still holds, then runs `python mesh_flow.py run` in a temporary
         directory: start -> train (num_parallel = device_count, one rank
         per card, @gpu) -> join -> end. Each rank builds
         create_mesh(MeshSpec.fsdp()) and MeshSpec.dp() over the gang's
         group. (a) bench_1b cut to 2 layers in f32, AdamW, 3 steps on
         tokens [8, 1025] on fsdp=N, then on data=N with ZeRO; rank 0 runs
         the same steps on its card off any mesh: losses and grad norms
         within 1e-4 relative, weights within atol/rtol 1e-5 for all but
         1 in 1000 and within 2 sum(lr) each (tests/test_torch_mesh.py's
         f32 rule); each rank holds 1/N of the ZeRO moments. (c) the fsdp
         state saved by AsyncCheckpointManager (each leaf gathered, rank 0
         writes the whole tree) and restored by make_trainer(checkpoint=)
         onto the ZeRO mesh (on one card: off any mesh); its digest must
         be the saved one's on every rank. (b) Llama-3-8B uncut, fed by
         sharded_dataset: with four cards or more AdamW on fsdp=N at
         [4N, 2049], else the factored optimizer on fsdp=N (the one-card
         mesh holds the 8B as 9c does); 3 steps, losses finite and equal
         on every rank, 2L/L/L K1/K2/K3 launches a step on every rank,
         each card's peak under 80 GB; prints the median step ms, global
         tokens/s, MFU over the world's peak and each card's peak.

Every phase asserts; the script exits non-zero on the first failure, when
no CUDA device is present, or when the port's package is missing. Its last
lines are the kernel report, one SUMMARY line per phase (its pass result
and headline numbers, at most 200 bytes), the card and
{"ok": true, "device": {...}}; on a failure the SUMMARY lines so far and
the failing phase are printed before the traceback.
"""

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, bf16
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3


ALL_PHASES = ("1", "2", "3", "4", "5", "6", "7", "8", "9", "10", "11",
              "12", "13")
ROWS = {}  # the last JSON row each phase (or phase and variant) logged
# the numbers a summary line shows first
HEADLINES = ("records_vs_clock", "median_step_ms", "median_step_ms_9c",
             "input_stall_ms", "input_stall_share", "update_ms",
             "ring_step_ms", "ring_forward_ms", "k1_forward_ms",
             "token_identical", "ttft_p50_s", "ttft_p99_s",
             "server_ttft_p50_ms", "server_ttft_p99_ms",
             "device_busy_share", "device_ops_per_step",
             "launch_calls_per_step", "loop_thread_cpu_share",
             "decode_tokens_per_s", "requests_per_s", "step_ms",
             "tokens_per_s", "mfu", "forward_ms", "ms", "plain_ms",
             "library_ms", "bound_ms", "launches", "prefix_hits",
             "peak_page_occupancy", "peak_mem_gb", "max_abs_err_o",
             "greedy_identical_share_spec3_vs_spec0")


def log(msg):
    print(msg, flush=True)


def log_row(row, key=None):
    """Print a phase's JSON row and keep it (the last one per key) for the
    summary lines."""
    log(json.dumps(row))
    ROWS[key or str(row["phase"])] = row


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(kernel, B, S, H, KV, D, dtype_bytes, causal):
    """(operations, bytes) the least a flash kernel must do on [B, S, H, D]
    queries and [B, S, KV, D] keys and values: K1 ('flash_fwd') does two
    products (4*D flop per live (q, k) pair), K2 ('flash_bwd_dq') three
    and K3 ('flash_bwd_dkv') four. Bytes count each input read once (q, k,
    v; the backward also dO, lse, delta) and each output written once (K1:
    O and lse; K2: f32 dq; K3: f32 dk and dv)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    q_bytes = B * S * H * D * dtype_bytes
    qkv = q_bytes + 2 * B * S * KV * D * dtype_bytes
    stats = 4 * B * H * S
    if kernel == "flash_fwd":
        return 4.0 * B * H * D * pairs, qkv + q_bytes + stats
    grad_inputs = qkv + q_bytes + 2 * stats
    if kernel == "flash_bwd_dq":
        return 6.0 * B * H * D * pairs, grad_inputs + 4 * B * S * H * D
    return 8.0 * B * H * D * pairs, grad_inputs + 8 * B * S * KV * D


def bound_ms(work, tensor_cores):
    """The least time the card could take for (operations, bytes): the
    larger of the operations over the peak rate and the bytes over the
    memory rate, and which of the two it is."""
    flops, nbytes = work
    t_ops = flops / (H100_BF16_FLOPS if tensor_cores else H100_F32_FLOPS)
    t_bytes = nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _demangle(names):
    """names demangled by the toolkit's cu++filt (or c++filt), else as
    they are."""
    from metaflow_tpu_torch.ops import _build

    for tool in (os.path.join(os.path.dirname(_build._nvcc()), "cu++filt"),
                 "c++filt"):
        try:
            out = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, check=True)
        except (OSError, subprocess.CalledProcessError):
            continue
        got = out.stdout.splitlines()
        if len(got) == len(names):
            return got
    return list(names)


def wgmma_kernel_report(_build):
    """Phase 0's lines on the wgmma kernels (K1 and K4, K2, K3, K5, K6):
    for each, ptxas' registers and spills, the dynamic shared memory its
    launch asks for, and, where the toolkit has cuobjdump, the count of
    HGMMA (wgmma) and UTMALDG (TMA load) instructions in its SASS."""
    # the dynamic shared memory of each kernel, from its mangled name
    smem = {"gmm": lambda lib, name: (lib.gmm_dw_smem_bytes()
                                      if "gmm_dw" in name
                                      else lib.gmm_fwd_smem_bytes()),
            "flash_fwd": lambda lib, name: lib.flash_fwd_smem_bytes(
                64 if "ILi64E" in name else 128),
            "flash_bwd": lambda lib, name: (
                lib.flash_bwd_dq_smem_bytes if "flash_bwd_dq" in name
                else lib.flash_bwd_dkv_smem_bytes)(
                    64 if "ILi64E" in name else 128)}
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    lines = []
    for source, smem_of in smem.items():
        info = _build.build_info(source)
        ptxas, fn = {}, None
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn and ("registers" in line or "spill" in line):
                ptxas.setdefault(fn, []).append(
                    line.split(":", 1)[-1].strip() if "ptxas" in line
                    else line.strip())
        sass = {}
        if os.path.exists(cuobjdump):
            dump = subprocess.run([cuobjdump, "-sass", info["path"]],
                                  capture_output=True, text=True).stdout
            fn = None
            for line in dump.splitlines():
                if "Function :" in line:
                    fn = line.split("Function :")[1].strip()
                    sass[fn] = {"HGMMA": 0, "UTMALDG": 0}
                elif fn:
                    for op in sass[fn]:
                        sass[fn][op] += op in line
        lib = _build.load(source)
        names = sorted(n for n in ptxas if "wgmma_kernel" in n)
        for mangled, pretty in zip(names, _demangle(names)):
            lines.append("  %s: %s; dynamic smem %d bytes; SASS %s" % (
                pretty, "; ".join(ptxas[mangled]), smem_of(lib, mangled),
                sass.get(mangled, "not read (no cuobjdump)")))
    return lines


def sdpa_backend_ms(torch, q_t, k_t, v_t, causal, iters=20):
    """F.scaled_dot_product_attention's forward on [B, H, S, D] timed under
    each torch.nn.attention.sdpa_kernel backend that takes these inputs
    (flash, cuDNN, efficient): ({backend: ms, or why it refused}, the
    fastest backend, its ms). A yardstick only: the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        try:
            with sdpa_kernel([backend]), torch.no_grad():
                times[name] = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q_t, k_t, v_t, is_causal=causal), iters)
        except RuntimeError as e:
            times[name] = "refused: %s" % str(e).splitlines()[0][:120]
    ran = {k: v for k, v in times.items() if isinstance(v, float)}
    if not ran:
        raise AssertionError("no SDPA backend ran: %s" % times)
    best = min(ran, key=ran.get)
    return times, best, ran[best]


def sdpa_backward_backend_ms(torch, q_t, k_t, v_t, g_t, causal, iters=10):
    """F.scaled_dot_product_attention's backward (dq, dk, dv together) on
    [B, H, S, D] under each sdpa_kernel backend that takes these inputs,
    timed as forward + backward minus the forward: ({backend: ms, or why
    it refused}, the fastest backend, its ms). A yardstick only."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().requires_grad_(True) for t in (q_t, k_t, v_t)]

    def fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        torch.autograd.grad(o, leaves, g_t)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(*leaves, is_causal=causal)

    times = {}
    for name, backend in (("flash", SDPBackend.FLASH_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION)):
        try:
            with sdpa_kernel([backend]):
                times[name] = cuda_ms(fwd_bwd, iters) - cuda_ms(fwd, iters)
        except RuntimeError as e:
            times[name] = "refused: %s" % str(e).splitlines()[0][:120]
    ran = {k: v for k, v in times.items() if isinstance(v, float)}
    if not ran:
        raise AssertionError("no SDPA backend ran the backward: %s" % times)
    best = min(ran, key=ran.get)
    return times, best, ran[best]


def in_turns(a, b, iters):
    """The times of two calls measured in turns on one card (a, b, b, a),
    so that drift between the turns (clocks, power) falls on both alike:
    (a's ms, b's ms, the four turns' ms)."""
    turns = [cuda_ms(fn, iters) for fn in (a, b, b, a)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def old_new_ms(old, new, iters):
    """An earlier build's time and this one's of the same call, in turns:
    {'old_ms', 'new_ms', 'turns_ms'}."""
    old_ms, new_ms, turns = in_turns(old, new, iters)
    return {"old_ms": old_ms, "new_ms": new_ms, "turns_ms": turns}


def baseline_library(_build, root, name):
    """The ctypes library of csrc/<name>.cu of an earlier checkout at
    `root` (chip_smoke.py --baseline ROOT), built into
    metaflow_tpu_torch/_build/baseline/ by phase 0."""
    import ctypes

    src, out = _build.library_path(
        name, csrc=_baseline_csrc(root),
        build_dir=_build.BUILD_DIR / "baseline")
    return ctypes.CDLL(str(out))


def _baseline_csrc(root):
    from pathlib import Path

    return Path(root).resolve() / "metaflow_tpu_torch" / "ops" / "csrc"


BASELINE_SOURCES = ("flash_bwd", "flash_fwd", "gmm")


@contextlib.contextmanager
def baseline_source(_build, name, lib):
    """Inside the block, the wrappers of csrc/<name>.cu launch the earlier
    build `lib` (its C entry points take the same arguments)."""
    _build.load(name)
    saved = _build._LOADED[name]
    _build._LOADED[name] = (lib, saved[1])
    try:
        yield
    finally:
        _build._LOADED[name] = saved


def baseline_turns(_build, name, lib, new, iters):
    """new() timed in turns against the same call on the earlier build of
    csrc/<name>.cu (old_new_ms), with the two builds' outputs: (times,
    old output, new output)."""
    def old():
        with baseline_source(_build, name, lib):
            return new()

    return old_new_ms(old, new, iters), old(), new()


def phase1_kernel_vs_plain(A, FC, torch):
    """K1 against its plain version at fault_check.FWD_CASES; returns the
    main-shape record, timed against SDPA's backends."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    record = None
    for case in FC.FWD_CASES:
        B, S, H, KV, D, dt, causal = case
        q, k, v = FC.fwd_inputs(case, gen)
        readings = FC.fwd_case_readings(q, k, v, causal)
        if dt == torch.float32:
            # f32 on both sides: the sums differ only in order, within 1e-5
            limit = {"o": 1.0, "lse": 1.0}
        else:
            # O row by row against its own magnitude (attention.py,
            # FLASH_BF16_ROW_LIMIT), lse in f32 rounding units of a sum
            # over up to S terms (FLASH_LSE_LIMIT)
            limit = {"o": A.FLASH_BF16_ROW_LIMIT, "lse": A.FLASH_LSE_LIMIT}
        row = {"shape": [B, S, H, KV, D], "dtype": str(dt).split(".")[-1],
               "causal": causal, "readings": readings, "limit": limit}
        if not all(readings[n] <= limit[n] for n in limit):
            log(json.dumps(row))
            raise AssertionError("K1 disagrees with its plain version: %s"
                                 % json.dumps(row))
        if case == FC.FWD_CASES[-1]:  # the inference shape
            scale = D ** -0.5
            out, _ = A._flash_forward_cuda(q, k, v, causal, scale)
            ref_out, _ = A._flash_forward_plain(q, k, v, causal, scale)
            row["max_abs_err_o"] = (out.float() - ref_out.float()).abs(
            ).max().item()
            del out, ref_out
            k_rep, v_rep = (A._broadcast_gqa(t, H).transpose(1, 2)
                            .contiguous() for t in (k, v))
            q_t = q.transpose(1, 2).contiguous()
            row["ms"] = cuda_ms(
                lambda: A._flash_forward_cuda(q, k, v, causal, scale), 20)
            row["plain_ms"] = cuda_ms(
                lambda: A._flash_forward_plain(q, k, v, causal, scale), 5)
            row["library_by_backend_ms"], row["library"], \
                row["library_ms"] = sdpa_backend_ms(torch, q_t, k_rep,
                                                    v_rep, causal)
            row["bound_ms"], row["bound_by"] = bound_ms(
                attention_work("flash_fwd", B, S, H, KV, D, 2, causal),
                tensor_cores=True)
            record = row
            del k_rep, v_rep, q_t
        log(json.dumps(row))
    return record


def phase2_forward(torch, llama, A, L):
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log("phase 2: llama3_8b bf16 params %.2fB, depth %d of %d, init %.1fs"
        % (llama.num_params(params) / 1e9, cfg.n_layers, cfg.n_layers,
           time.perf_counter() - t0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda")

    def run(impl):
        c = llama.LlamaConfig.llama3_8b(attention_impl=impl)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = llama.forward(params, tokens, c, device="cuda")
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t) * 1e3

    with torch.no_grad():
        L.reset_launch_counts()
        flash_logits, first_ms = run("auto")
        launches = dict(L.LAUNCHES)
        if launches["flash_fwd"] != cfg.n_layers:
            raise AssertionError("forward launched K1 %d times, expected %d"
                                 % (launches["flash_fwd"], cfg.n_layers))
        _, flash_ms = run("auto")
        plain_logits, plain_ms = run("xla")
        # K1's plain version in the model (unnormalized probabilities
        # rounded to bf16, as the kernel rounds them)
        interp_logits, _ = run("flash_interpret")
        layer_err = checked_layers(A, lambda: run("auto"))
    if not torch.isfinite(flash_logits).all():
        raise AssertionError("non-finite logits from the flash forward")

    def compare(a, b):
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        return agree, rel

    agree, rel = compare(flash_logits, plain_logits)
    floor_agree, floor_rel = compare(interp_logits, plain_logits)
    kernel_agree, kernel_rel = compare(flash_logits, interp_logits)
    n_tok = tokens.numel()
    result = {"phase": 2, "launches": launches["flash_fwd"],
              "forward_ms": flash_ms,
              "first_forward_ms": first_ms, "plain_forward_ms": plain_ms,
              "tokens_per_s": n_tok / flash_ms * 1e3,
              "top1_agree_kernel_vs_plain": agree,
              "max_rel_logit_diff_kernel_vs_plain": rel,
              "top1_agree_k1plain_vs_plain": floor_agree,
              "max_rel_logit_diff_k1plain_vs_plain": floor_rel,
              "top1_agree_kernel_vs_k1plain": kernel_agree,
              "max_rel_logit_diff_kernel_vs_k1plain": kernel_rel,
              "layer_err_over_bound_max": max(layer_err)}
    log_row(result)
    # 1) inside the model, at every layer, K1 agrees with its plain version
    #    on the same q, k, v within phase 1's row limit;
    # 2) end to end, the kernel is no farther from the plain-attention
    #    forward than K1's own plain version is: the two attention paths
    #    round at different places (unnormalized vs normalized
    #    probabilities), and with random weights 32 layers carry that ulp
    #    to near-tied logits. 0.02 of top-1 agreement is ~6 standard
    #    errors of a share measured on 4096 positions.
    if max(layer_err) > 1.0:
        raise AssertionError("K1 off its plain version inside the model: "
                             "%s" % layer_err)
    if agree < floor_agree - 0.02 or rel > 2 * floor_rel:
        raise AssertionError(
            "flash and plain forwards disagree beyond the rounding floor: "
            "%s" % json.dumps(result))
    del flash_logits, plain_logits, interp_logits
    return params, launches


def checked_layers(A, run_forward):
    """Run a forward with every K1 launch held against the plain version
    on the same inputs; returns each layer's row error over its limit
    (A.flash_out_error / A.FLASH_BF16_ROW_LIMIT, as in phase 1)."""
    ratios, launch = [], A._flash_forward_cuda

    def checked(q, k, v, causal, scale):
        out, lse = launch(q, k, v, causal, scale)
        ref, _ = A._flash_forward_plain(q, k, v, causal, scale)
        ratios.append(A.flash_out_error(out, ref) / A.FLASH_BF16_ROW_LIMIT)
        return out, lse

    A._flash_forward_cuda = checked
    try:
        run_forward()
    finally:
        A._flash_forward_cuda = launch
    return ratios


def drive(engine, requests):
    """Serve `requests` (dicts with prompt, max_new, temperature, top_k,
    top_p, seed) to completion: admit into free slots, one prefill chunk
    per iteration, then one fused decode step. Returns per-request tokens,
    first-token seconds and the decode-step totals."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    queue = list(range(len(requests)))
    slot_of, out, ttft = {}, {i: [] for i in queue}, {}
    decode_s, decode_tokens = 0.0, 0
    while queue or slot_of:
        for slot in engine.free_slots():
            if not queue:
                break
            i = queue.pop(0)
            r = requests[i]
            engine.admit(slot, r["prompt"], r["max_new"],
                         temperature=r.get("temperature", 0.0),
                         top_k=r.get("top_k"), top_p=r.get("top_p"),
                         rng=r.get("seed", 0))
            slot_of[slot] = i
        prefilling = [s for s in slot_of if not engine.decoding[s]]
        if prefilling:
            _, first = engine.prefill_step(prefilling[0])
            torch.cuda.synchronize()  # decode_s below times decode alone
            if first is not None:
                i = slot_of[prefilling[0]]
                out[i].append(first)
                ttft[i] = time.perf_counter() - t0
        t = time.perf_counter()
        step = engine.decode_step()
        if step:
            decode_s += time.perf_counter() - t
            decode_tokens += len(step)
        for slot, tok in step.items():
            out[slot_of[slot]].append(tok)
        for slot in list(slot_of):
            i = slot_of[slot]
            if len(out[i]) >= requests[i]["max_new"]:
                out[i] = out[i][:requests[i]["max_new"]]
                engine.release(slot)
                del slot_of[slot]
    if engine.free_slots() != list(range(engine.max_slots)) or \
            np.any(engine.active):
        raise AssertionError("slots leaked: %s" % engine.active)
    return out, ttft, decode_tokens, decode_s


def phase3_serve(torch, llama, decode, engine_mod, params_8b):
    import numpy as np

    rng = np.random.default_rng(0)
    # (a) token identity against generate(), float32, 2 layers
    cfg = llama.LlamaConfig.llama3_8b(n_layers=2, dtype="float32")
    small = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(2), device="cuda")
    eng = engine_mod.SlotEngine(small, cfg, max_slots=4, max_seq_len=256,
                                prefill_chunk=32, device="cuda")
    reqs = [{"prompt": rng.integers(0, cfg.vocab_size, n).tolist(),
             "max_new": 8, "seed": i}
            for i, n in enumerate([5, 17, 40, 64, 90, 33])]
    with torch.no_grad():
        got, _, _, _ = drive(eng, reqs)
        for i, r in enumerate(reqs):
            ref = decode.generate(small, [r["prompt"]], cfg, r["max_new"],
                                  max_seq_len=256, device="cuda")
            want = ref[0, len(r["prompt"]):].tolist()
            if got[i] != want:
                raise AssertionError("request %d: engine %s != generate %s"
                                     % (i, got[i], want))
    log_row({"phase": "3a", "requests": len(reqs),
             "token_identical": True})
    del eng, small

    # (b) the full bf16 model, 8 slots x 4096 positions
    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    eng = engine_mod.SlotEngine(params_8b, cfg, max_slots=8,
                                max_seq_len=4096, prefill_chunk=512,
                                device="cuda")
    lengths = [17, 100, 300, 511, 513, 1000, 1500, 2000]
    reqs = []
    for i, n in enumerate(lengths):
        r = {"prompt": rng.integers(0, cfg.vocab_size, n).tolist(),
             "max_new": 32, "seed": 100 + i}
        if i % 2:
            r.update(temperature=0.8, top_k=50, top_p=0.9)
        reqs.append(r)
    with torch.no_grad():
        got, ttft, n_dec, dec_s = drive(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, toks in got.items():
        if len(toks) != 32 or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError("request %d finished badly: %s" % (i, toks))
    ttfts = sorted(ttft.values())
    result = {"phase": "3b", "requests": len(reqs), "finished": len(got),
              "attn_impl": eng.attn_impl,
              "ttft_s": [ttft[i] for i in range(len(reqs))],
              "ttft_p50_s": ttfts[len(ttfts) // 2],
              "decode_tokens": n_dec, "decode_s": dec_s,
              "decode_tokens_per_s": n_dec / dec_s, "wall_s": wall,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log_row(result)


TRAIN_SHAPE = (8, 2048, 16, 8, 128)  # bench_1b at tokens [8, 2048]


def _bwd_inputs(torch, gen, B, S, H, KV, D, dt):
    q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
    g = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
    return q, k, v, g


def _delta(g, out):
    B, S, H, _ = g.shape
    return (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
        B * H, S).contiguous()


def _f32_excess(got, want):
    """The largest |got - want| over atol 1e-5 + rtol 1e-3 |want| (the JAX
    package's grad tolerance): at most 1 when they agree."""
    return ((got - want).abs() / (1e-5 + 1e-3 * want.abs())).max().item()


def phase4_backward(A, torch, baseline=None):
    """K2 and K3 against their plain version at four shapes, the training
    shape last; at the training shape K1 too, and the times of K1, K2, K3,
    the plain versions, SDPA and (baseline: an earlier build of
    flash_bwd.cu) the earlier K3. Returns {kernel name: record}."""
    import torch.nn.functional as F

    shapes = [  # (B, S, H, KV, D, dtype, causal)
        (1, 128, 4, 4, 64, torch.float32, True),
        (2, 256, 8, 2, 128, torch.bfloat16, True),
        (1, 512, 4, 4, 128, torch.bfloat16, False),
        TRAIN_SHAPE + (torch.bfloat16, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(4)
    records = {}
    for B, S, H, KV, D, dt, causal in shapes:
        q, k, v, g = _bwd_inputs(torch, gen, B, S, H, KV, D, dt)
        scale = D ** -0.5
        out, lse = A._flash_forward_cuda(q, k, v, causal, scale)
        delta = _delta(g, out)
        got = (A._flash_bwd_dq_cuda(q, k, v, g, lse, delta, scale, causal),
               *A._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal))
        want = A._flash_block_bwd_plain(q, k, v, g, lse, delta, scale, causal)
        torch.cuda.synchronize()
        row = {"phase": 4, "shape": [B, S, H, KV, D],
               "dtype": str(dt).split(".")[-1], "causal": causal}
        ok = all(bool(torch.isfinite(t).all()) for t in got)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            row["max_abs_err_" + name] = (a - b).abs().max().item()
            if dt == torch.float32:
                # f32 on both sides: the sums differ only in order
                row["f32_excess_" + name] = _f32_excess(a, b)
                ok = ok and row["f32_excess_" + name] <= 1.0
            else:
                row["row_err_" + name] = A.flash_out_error(a, b)
                ok = ok and row["row_err_" + name] <= A.FLASH_BWD_ROW_LIMIT
        row["row_limit"] = (None if dt == torch.float32
                            else A.FLASH_BWD_ROW_LIMIT)
        if not ok:
            log_row(row)
            raise AssertionError("K2/K3 disagree with their plain version: "
                                 "%s" % json.dumps(row))
        if (B, S, H, KV, D) == TRAIN_SHAPE:
            records = _time_training_shape(A, torch, F, q, k, v, g, out, lse,
                                           delta, row, baseline)
        log_row(row)
    return records


def _time_training_shape(A, torch, F, q, k, v, g, out, lse, delta, row,
                         baseline=None):
    """K1 held against its plain version at the training shape, then every
    time of the kernel report: each kernel, the plain versions, SDPA (its
    backward under each backend, K2 + K3's yardstick the fastest) and,
    with a baseline library, the earlier K2 and K3 in turns with this
    tree's."""
    B, S, H, KV, D = TRAIN_SHAPE
    scale = D ** -0.5
    ref_out, _ = A._flash_forward_plain(q, k, v, True, scale)
    row["row_err_o"] = A.flash_out_error(out, ref_out)
    if row["row_err_o"] > A.FLASH_BF16_ROW_LIMIT:
        raise AssertionError("K1 off its plain version at the training "
                             "shape: %s" % row["row_err_o"])
    fwd_err = (out.float() - ref_out.float()).abs().max().item()
    del ref_out
    ms = {
        "flash_fwd": cuda_ms(
            lambda: A._flash_forward_cuda(q, k, v, True, scale), 20),
        "flash_bwd_dq": cuda_ms(lambda: A._flash_bwd_dq_cuda(
            q, k, v, g, lse, delta, scale, True), 20),
        "flash_bwd_dkv": cuda_ms(lambda: A._flash_bwd_dkv_cuda(
            q, k, v, g, lse, delta, scale, True), 20),
    }
    plain_fwd = cuda_ms(lambda: A._flash_forward_plain(q, k, v, True, scale),
                        3)
    plain_bwd = cuda_ms(lambda: A._flash_block_bwd_plain(
        q, k, v, g, lse, delta, scale, True), 3)
    # SDPA on [B, H, S, D] with the kv heads repeated; its backward is
    # timed as forward + backward minus forward, under each backend
    q_t, g_t = (t.transpose(1, 2).contiguous() for t in (q, g))
    k_t, v_t = (A._broadcast_gqa(t, H).transpose(1, 2).contiguous()
                for t in (k, v))
    bwd_by_backend, bwd_backend, sdpa_bwd_ms = sdpa_backward_backend_ms(
        torch, q_t, k_t, v_t, g_t, True)
    # K1's yardstick: the fastest backend's forward
    by_backend, backend, k1_library_ms = sdpa_backend_ms(
        torch, q_t, k_t, v_t, True)
    if baseline is not None:
        from metaflow_tpu_torch.ops import _build

        times, old, new = baseline_turns(
            _build, "flash_bwd", baseline, lambda: A._flash_bwd_dq_cuda(
                q, k, v, g, lse, delta, scale, True), 20)
        times["row_err_new_vs_old"] = A.flash_out_error(new, old)
        row["dq_old_new"] = times
        times, old, new = baseline_turns(
            _build, "flash_bwd", baseline, lambda: A._flash_bwd_dkv_cuda(
                q, k, v, g, lse, delta, scale, True), 20)
        times["row_err_new_vs_old"] = max(A.flash_out_error(new[0], old[0]),
                                          A.flash_out_error(new[1], old[1]))
        row["dkv_old_new"] = times
        del old, new
        for name, key in (("K2", "dq_old_new"), ("K3", "dkv_old_new")):
            log("phase 4: %s earlier build %.4f ms, this build %.4f ms "
                "(turns %s)" % (name, row[key]["old_ms"], row[key]["new_ms"],
                                row[key]["turns_ms"]))
    records = {}
    for name in ms:
        work = attention_work(name, B, S, H, KV, D, 2, True)
        bound, by = bound_ms(work, tensor_cores=True)
        records[name] = {
            "ms": ms[name], "bound_ms": bound, "bound_by": by,
            "gflop": work[0] / 1e9, "gbytes": work[1] / 1e9,
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": (k1_library_ms if name == "flash_fwd"
                           else sdpa_bwd_ms),
            "library": (backend if name == "flash_fwd" else bwd_backend),
            "library_by_backend_ms": (by_backend if name == "flash_fwd"
                                      else bwd_by_backend),
            "max_abs_err": {
                "flash_fwd": fwd_err,
                "flash_bwd_dq": row["max_abs_err_dq"],
                "flash_bwd_dkv": max(row["max_abs_err_dk"],
                                     row["max_abs_err_dv"])}[name]}
        log("phase 4: %s at the training shape: %.4f ms, bound %.4f ms "
            "(%s; %.1f GFLOP, %.3f GB)" % (name, ms[name], bound, by,
                                          work[0] / 1e9, work[1] / 1e9))
    if "dq_old_new" in row:
        records["flash_bwd_dq"]["old_new"] = row["dq_old_new"]
        records["flash_bwd_dkv"]["old_new"] = row["dkv_old_new"]
    pair = ms["flash_bwd_dq"] + ms["flash_bwd_dkv"]
    log("phase 4: K2 + K3 %.4f ms against SDPA's fastest backward (%s) "
        "%.4f ms: %.2fx; backward by backend %s" % (
            pair, bwd_backend, sdpa_bwd_ms, pair / sdpa_bwd_ms,
            bwd_by_backend))
    row.update(plain_bwd_ms=plain_bwd, sdpa_bwd_ms=sdpa_bwd_ms,
               sdpa_bwd_backend=bwd_backend,
               sdpa_bwd_by_backend_ms=bwd_by_backend,
               sdpa_fwd_by_backend_ms=by_backend,
               k2_k3_over_sdpa_bwd=pair / sdpa_bwd_ms,
               ms={n: r["ms"] for n, r in records.items()})
    return records


def _leaf_params(torch, params):
    """A copy of a parameter tree whose tensors are leaves requiring
    grad."""
    return {k: _leaf_params(torch, v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def phase5a_exact_grads(torch, llama, A, L, leaves):
    """A 2-layer full-width bench_1b in float32: the loss gradients through
    K1/K2/K3 against the ones through plain attention."""
    cfg = llama.LlamaConfig.bench_1b(n_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = llama.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 1025), generator=gen,
                           device="cuda")
    grads, losses, launches = {}, {}, {}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        p = _leaf_params(torch, params)
        L.reset_launch_counts()
        loss = llama.loss_fn(p, {"tokens": tokens}, c)
        loss.backward()
        torch.cuda.synchronize()
        launches[impl] = dict(L.LAUNCHES)
        losses[impl] = loss.item()
        grads[impl] = {"/".join(path): t.grad for path, t in leaves(p)}
    excess = {name: _f32_excess(grads["auto"][name], grads["xla"][name])
              for name in grads["auto"]}
    result = {"phase": "5a", "layers": cfg.n_layers, "tokens": [2, 1025],
              "loss_auto": losses["auto"], "loss_plain": losses["xla"],
              "launches_auto": launches["auto"],
              "launches_plain": launches["xla"],
              "grad_excess_max": max(excess.values()),
              "grad_excess_by_leaf": excess}
    log_row(result)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "flash_block_fwd": 0,
            "gmm_fwd": 0, "gmm_dw": 0}
    if launches["auto"] != want or any(launches["xla"].values()):
        raise AssertionError("phase 5a launches %s, expected %s"
                             % (launches, want))
    if max(excess.values()) > 1.0:
        raise AssertionError("f32 gradients through the kernels disagree "
                             "with plain attention: %s" % excess)


def checked_backward(A, run):
    """run() with every K2 and K3 launch held against the plain version on
    the same inputs; returns (run's result, {kernel: each launch's row
    error over FLASH_BWD_ROW_LIMIT})."""
    ratios = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    dq_launch, dkv_launch = A._flash_bwd_dq_cuda, A._flash_bwd_dkv_cuda

    def dq_checked(q, k, v, g, lse, delta, scale, causal):
        dq = dq_launch(q, k, v, g, lse, delta, scale, causal)
        ref = A._flash_block_bwd_plain(q, k, v, g, lse, delta, scale, causal)
        ratios["flash_bwd_dq"].append(
            A.flash_out_error(dq, ref[0]) / A.FLASH_BWD_ROW_LIMIT)
        return dq

    def dkv_checked(q, k, v, g, lse, delta, scale, causal):
        dk, dv = dkv_launch(q, k, v, g, lse, delta, scale, causal)
        _, rk, rv = A._flash_block_bwd_plain(q, k, v, g, lse, delta, scale,
                                             causal)
        ratios["flash_bwd_dkv"].append(max(
            A.flash_out_error(dk, rk), A.flash_out_error(dv, rv))
            / A.FLASH_BWD_ROW_LIMIT)
        return dk, dv

    A._flash_bwd_dq_cuda, A._flash_bwd_dkv_cuda = dq_checked, dkv_checked
    try:
        result = run()
    finally:
        A._flash_bwd_dq_cuda, A._flash_bwd_dkv_cuda = dq_launch, dkv_launch
    return result, ratios


def phase5b_train(torch, llama, A, L, training):
    """bench_1b in bf16 at full width and depth: 5 trainer steps on one
    fixed batch of tokens [8, 2049]. Returns the launches of the run."""
    cfg = llama.LlamaConfig.bench_1b()
    gen = torch.Generator(device="cuda").manual_seed(6)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    n_params = llama.num_params(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 2049),
                                     generator=gen, device="cuda")}
    state, step = training.make_trainer(
        cfg, llama, optimizer=training.default_optimizer(
            warmup_steps=1, total_steps=10), params=params)
    torch.cuda.synchronize()
    log("phase 5b: bench_1b bf16 params %.3fB, depth %d of %d, init %.1fs"
        % (n_params / 1e9, cfg.n_layers, cfg.n_layers,
           time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    steps, ratios = [], None
    L.reset_launch_counts()
    for i in range(5):
        before = dict(L.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 2:
            (state, m), ratios = checked_backward(
                A, lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        steps.append({"step": i, "ms": (time.perf_counter() - t) * 1e3,
                      "loss": loss, "grad_norm": norm,
                      "launches": {n: L.LAUNCHES[n] - before[n]
                                   for n in L.LAUNCHES}})
    launches = dict(L.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(s["ms"] for s in steps if s["step"] != 2
                                and s["step"] > 0)
    tokens = 8 * 2048
    tokens_per_s = tokens / step_ms * 1e3
    fpt = training.flops_per_token_dense(n_params, cfg.n_layers, cfg.dim,
                                         2048)
    peak = training.peak_tflops(torch.cuda.get_device_name(0))
    if peak is None:
        raise AssertionError("no peak rate for %s"
                             % torch.cuda.get_device_name(0))
    result = {"phase": "5b", "steps": steps, "step_ms": step_ms,
              "tokens_per_s": tokens_per_s, "flops_per_token": fpt,
              "peak_tflops": peak, "mfu": tokens_per_s * fpt / (peak * 1e12),
              "peak_mem_gb": peak_gb, "launches": launches,
              "in_model_row_err_over_limit": {
                  n: max(r) for n, r in ratios.items()},
              "in_model_checks": {n: len(r) for n, r in ratios.items()}}
    log_row(result)
    want = {"flash_fwd": 2 * cfg.n_layers, "flash_bwd_dq": cfg.n_layers,
            "flash_bwd_dkv": cfg.n_layers, "flash_block_fwd": 0,
            "gmm_fwd": 0, "gmm_dw": 0}
    for s_ in steps:
        if s_["launches"] != want:
            raise AssertionError("step %d launched %s, expected %s"
                                 % (s_["step"], s_["launches"], want))
    if any(len(r) != cfg.n_layers or max(r) > 1.0 for r in ratios.values()):
        raise AssertionError("K2/K3 off their plain version inside the "
                             "model: %s" % ratios)
    losses = [s_["loss"] for s_ in steps]
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)):
        raise AssertionError("non-finite losses %s" % losses)
    if abs(losses[0] - losses[1]) > 1e-5 * abs(losses[0]) or \
            not losses[4] < losses[1]:
        raise AssertionError("the loss must hold at step 1 (lr 0 on the "
                             "first update) and fall to step 4: %s" % losses)
    return launches


def gmm_work(kernel, n, S, K, N, groups, out_bytes=2):
    """(operations, bytes) the least a grouped product must do for n routed
    rows: 2 n K N flop. Bytes: K5 ('gmm_fwd', x [S, K] @ w [G, K, N]) reads
    the n rows and the weights once and writes all S rows of y; K6
    ('gmm_dw', K = D, N = F) reads the n rows of x and of dy once and
    writes dw, out_bytes an element (2 in bf16, as the backward asks for
    it; 4 in f32)."""
    flops = 2.0 * n * K * N
    if kernel == "gmm_fwd":
        return flops, 2.0 * (n * K + groups * K * N + S * N)
    return flops, 2.0 * n * (K + N) + out_bytes * groups * K * N


def library_gmm(torch, x, w, dy, layout):
    """One PyTorch call for each of K5, K5 on the transposed weights and
    K6 (bf16 out, and f32 out where the call takes out_dtype) on the same
    inputs, as a yardstick of speed: torch._grouped_mm over the active
    tiles' group offsets where the card's torch has it and takes these
    operands, else a loop of torch.mm over the groups. Returns
    ({'fwd', 'dx', 'dw', 'dw_f32': callable or None}, the name of what was
    used)."""
    tg, ta = layout["tile_group"], layout["tile_active"]
    groups = w.shape[0]
    rows = torch.bincount(tg[ta != 0].long(), minlength=groups) * 128
    offs = torch.cumsum(rows, 0).to(torch.int32)
    total = int(offs[-1])
    xa, dya = x[:total], dy[:total]
    calls = {"fwd": lambda: torch._grouped_mm(xa, w, offs=offs),
             "dx": lambda: torch._grouped_mm(dya, w.transpose(-2, -1),
                                             offs=offs),
             "dw": lambda: torch._grouped_mm(xa.t(), dya, offs=offs)}
    try:
        if not hasattr(torch, "_grouped_mm"):
            raise AttributeError("torch has no _grouped_mm")
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
    except (AttributeError, NotImplementedError, RuntimeError, TypeError,
            ValueError) as e:
        log("phase 6: torch._grouped_mm refused (%s); timing a loop of "
            "torch.mm over the groups" % str(e).splitlines()[0])
        calls = None
    if calls is not None:
        def dw_f32():
            return torch._grouped_mm(xa.t(), dya, offs=offs,
                                     out_dtype=torch.float32)

        try:
            dw_f32()
            torch.cuda.synchronize()
            calls["dw_f32"] = dw_f32
        except (NotImplementedError, RuntimeError, TypeError,
                ValueError) as e:
            log("phase 6: torch._grouped_mm refused f32 out (%s)"
                % str(e).splitlines()[0])
            calls["dw_f32"] = None
        return calls, "torch._grouped_mm"
    bounds = [0] + offs.tolist()
    spans = [(g, bounds[g], bounds[g + 1]) for g in range(groups)
             if bounds[g + 1] > bounds[g]]

    def loop(fn):
        return lambda: [fn(g, a, b) for g, a, b in spans]

    calls = {"fwd": loop(lambda g, a, b: torch.mm(x[a:b], w[g])),
             "dx": loop(lambda g, a, b: torch.mm(dy[a:b], w[g].t())),
             "dw": loop(lambda g, a, b: torch.mm(x[a:b].t(), dy[a:b])),
             "dw_f32": None}
    return calls, "a loop of torch.mm over the groups"


def time_gmm_shape(torch, G, x, w, dy, layout, n_rows, with_plain,
                   baseline=None):
    """K5, K5 transposed (dx) and K6 times at one training shape (K6 in
    bf16 out, as the backward launches it, and in f32), with their bounds,
    the library calls' and (with_plain) the plain versions' times and the
    largest |kernel - plain| of y and dw; with a baseline library, the
    earlier K6 (bf16 out, then f32 out) in turns with this one."""
    tg, ta = layout["tile_group"], layout["tile_active"]
    S, (groups, D, F) = x.shape[0], w.shape
    bf16 = torch.bfloat16
    lib, lib_name = library_gmm(torch, x, w, dy, layout)

    def dw_new():
        return G._gmm_dw_cuda(x, dy, tg, ta, groups, out_dtype=bf16)

    # K6's two outputs in turns, so that drift falls on both alike
    dw_ms, dw_f32_ms, dw_turns = in_turns(
        dw_new, lambda: G._gmm_dw_cuda(x, dy, tg, ta, groups), 10)
    rec = {
        "ms": cuda_ms(lambda: G._gmm_fwd_cuda(x, w, tg, ta), 10),
        "dx_ms": cuda_ms(lambda: G._gmm_fwd_cuda(
            dy, w, tg, ta, w_transposed=True), 10),
        "dw_ms": dw_ms, "dw_f32_ms": dw_f32_ms,
        "dw_turns_ms": dw_turns,
        "library": lib_name,
        "library_ms": cuda_ms(lib["fwd"], 10),
        "library_dx_ms": cuda_ms(lib["dx"], 10),
        "library_dw_ms": cuda_ms(lib["dw"], 10),
        "library_dw_f32_ms": (cuda_ms(lib["dw_f32"], 10)
                              if lib["dw_f32"] else None)}
    for name, work in (
            ("", gmm_work("gmm_fwd", n_rows, S, D, F, groups)),
            ("dx_", gmm_work("gmm_fwd", n_rows, S, F, D, groups)),
            ("dw_", gmm_work("gmm_dw", n_rows, S, D, F, groups)),
            ("dw_f32_", gmm_work("gmm_dw", n_rows, S, D, F, groups, 4))):
        rec[name + "bound_ms"], rec[name + "bound_by"] = bound_ms(
            work, tensor_cores=True)
        rec[name + "tflop"] = work[0] / 1e12
    if baseline is not None:
        from metaflow_tpu_torch.ops import _build

        A = importlib.import_module("metaflow_tpu_torch.ops.attention")
        rec["dw_old_new"], old, new = baseline_turns(_build, "gmm", baseline,
                                                     dw_new, 5)
        rec["dw_old_new"]["row_err_new_vs_old"] = A.flash_out_error(new, old)
        rec["dw_f32_old_new"] = baseline_turns(
            _build, "gmm", baseline,
            lambda: G._gmm_dw_cuda(x, dy, tg, ta, groups), 5)[0]
        del old, new
    if with_plain:
        rec["plain_ms"] = cuda_ms(lambda: G._gmm_fwd_plain(x, w, tg, ta), 3)
        rec["plain_dw_ms"] = cuda_ms(
            lambda: G._gmm_dw_plain(x, dy, tg, ta, groups), 3)
        y, dw = G._gmm_fwd_cuda(x, w, tg, ta), dw_new()
        rec["max_abs_err"] = (y.float() - G._gmm_fwd_plain(
            x, w, tg, ta).float()).abs().max().item()
        rec["max_abs_err_dw"] = (dw.float() - G._gmm_dw_plain(
            x, dy, tg, ta, groups)).abs().max().item()
    return rec


def dw_bf16_counts(torch, G, x, dy, layout, groups):
    """K6's bf16 output against its own f32 output and its plain
    version's f32 sum, each rounded once: whether it equals the first bit
    for bit, and how many elements equal the second, lie one bf16 ulp
    from it, or further (sums that cancel, where the f32 sums' order moves
    the result by more than an ulp of the small result)."""
    tg, ta = layout["tile_group"], layout["tile_active"]
    got = G._gmm_dw_cuda(x, dy, tg, ta, groups, out_dtype=torch.bfloat16)
    own = G._gmm_dw_cuda(x, dy, tg, ta, groups).to(torch.bfloat16)
    ulps = G.bf16_ulps(got, G._gmm_dw_plain(x, dy, tg, ta, groups))
    return {"equals_own_f32_rounded": bool(torch.equal(got, own)),
            "elements": got.numel(),
            "equal_to_plain_rounded": int((ulps == 0).sum()),
            "one_ulp": int(((ulps > 0) & (ulps <= 1)).sum()),
            "over_one_ulp": int((ulps > 1).sum()),
            "max_ulps": ulps.max().item()}


def phase6_gmm(torch, G, FC, baseline=None):
    """K5 and K6 against their plain versions at every case of
    FC.GMM_CASES (each output poisoned with NaN first, so a block left
    unwritten shows), K6's bf16 output against its f32 one, then the times
    at the training shapes (with a baseline library, the earlier K6 beside
    this one). Returns {'gate_up', 'down', 'skewed': record}."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    records = {}
    for name, n, groups, D, F, dt, kind in FC.GMM_CASES:
        x, w, dy, layout = FC.gmm_inputs(n, groups, D, F, dt, kind, gen)
        readings = FC.gmm_case_readings(x, w, dy, layout)
        if dt == torch.bfloat16:
            limit = {"y": G.GMM_FWD_ROW_LIMIT, "dx": G.GMM_FWD_ROW_LIMIT,
                     "dw": G.GMM_DW_ROW_LIMIT,
                     "dw_bf16": G.GMM_FWD_ROW_LIMIT}
        else:  # f32: within 1e-5 of the largest |plain|
            limit = {"y": 1.0, "dx": 1.0, "dw": 1.0}
        row = {"phase": 6, "case": name, "rows": n,
               "padded_rows": x.shape[0], "groups": groups, "D": D, "F": F,
               "dtype": str(dt).split(".")[-1], "readings": readings,
               "limit": limit,
               "active_tiles": int(layout["tile_active"].sum())}
        ok = all(v <= limit[k] for k, v in readings.items())
        if dt == torch.bfloat16:
            row["dw_bf16"] = dw_bf16_counts(torch, G, x, dy, layout, groups)
            ok = ok and row["dw_bf16"]["equals_own_f32_rounded"]
        if not ok:
            log_row(row)
            raise AssertionError("K5/K6 disagree with their plain versions:"
                                 " %s" % json.dumps(row))
        if name.startswith("bf16_train"):
            key = name[len("bf16_train_"):]
            records[key] = time_gmm_shape(torch, G, x, w, dy, layout, n,
                                          with_plain=key == "gate_up",
                                          baseline=baseline)
            row["times"] = records[key]
            log("phase 6: %s: K5 %.3f ms (bound %.3f), K5 dx %.3f ms, K6 "
                "%.3f ms bf16 out / %.3f ms f32 out (bound %.3f); %s fwd / "
                "dx / dw %.3f / %.3f / %.3f ms" % (
                    key, records[key]["ms"], records[key]["bound_ms"],
                    records[key]["dx_ms"], records[key]["dw_ms"],
                    records[key]["dw_f32_ms"], records[key]["dw_bound_ms"],
                    records[key]["library"], records[key]["library_ms"],
                    records[key]["library_dx_ms"],
                    records[key]["library_dw_ms"]))
            if baseline is not None:
                log("phase 6: %s: K6 earlier build %.3f ms, this build "
                    "%.3f ms (bf16 out); f32 out %.3f / %.3f ms" % (
                        key, records[key]["dw_old_new"]["old_ms"],
                        records[key]["dw_old_new"]["new_ms"],
                        records[key]["dw_f32_old_new"]["old_ms"],
                        records[key]["dw_f32_old_new"]["new_ms"]))
        log_row(row)
        del x, w, dy, layout
        torch.cuda.empty_cache()
    return records


@contextlib.contextmanager
def gmm_route(G, fwd, dw):
    """Inside the block, gmm's kernel launches go to `fwd` and `dw` (the
    plain versions, or checking wrappers)."""
    old = G._gmm_fwd_cuda, G._gmm_dw_cuda
    G._gmm_fwd_cuda, G._gmm_dw_cuda = fwd, dw
    try:
        yield
    finally:
        G._gmm_fwd_cuda, G._gmm_dw_cuda = old


@contextlib.contextmanager
def recorded_routing(M, torch):
    """Inside the block, every call of ops/moe.py's router records its
    experts and its top-k / top-(k+1) logit margin in the yielded list."""
    calls, route = [], M.top_k_router

    def recording(logits, num_experts, k, dtype=torch.float32):
        weights, idx = route(logits, num_experts, k, dtype)
        top = torch.topk(logits.detach(), k + 1, dim=-1).values
        calls.append((idx.clone(), (top[:, k - 1] - top[:, k]).min().item()))
        return weights, idx

    M.top_k_router = recording
    try:
        yield calls
    finally:
        M.top_k_router = route


def _excess_by_slice(got, want):
    """_f32_excess over the leading dimension's slices, one at a time (the
    expert leaves are 3.8 GB each in f32)."""
    if got.ndim < 3:
        return _f32_excess(got, want)
    return max(_f32_excess(a, b) for a, b in zip(got, want))


def phase7a_exact_grads(torch, mixtral, L, G, M, leaves):
    """Mixtral-8x7B at full width, 2 layers, float32: the loss gradients
    through K5/K6 (and K1-K3) against the ones through plain gmm."""
    cfg = mixtral.MixtralConfig.mixtral_8x7b(n_layers=2, moe_dispatch="gmm",
                                             dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = mixtral.init_params(cfg, gen)
    for _, p in leaves(params):
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 513), generator=gen,
                           device="cuda")
    runs = {}
    for route in ("kernels", "plain"):
        plain = (G._gmm_fwd_plain, G._gmm_dw_plain)
        kernels = (G._gmm_fwd_cuda, G._gmm_dw_cuda)
        with gmm_route(G, *(plain if route == "plain" else kernels)), \
                recorded_routing(M, torch) as routing:
            L.reset_launch_counts()
            loss = mixtral.loss_fn(params, {"tokens": tokens}, cfg)
            loss.backward()
            torch.cuda.synchronize()
        runs[route] = {"loss": loss.item(), "launches": dict(L.LAUNCHES),
                       "routing": routing,
                       "grads": {"/".join(path): p.grad
                                 for path, p in leaves(params)}}
        for _, p in leaves(params):
            p.grad = None
    same_route = [bool(torch.equal(a[0], b[0])) for a, b in
                  zip(runs["kernels"]["routing"], runs["plain"]["routing"])]
    excess = {name: _excess_by_slice(runs["kernels"]["grads"][name], g)
              for name, g in runs["plain"]["grads"].items()}
    result = {"phase": "7a", "layers": cfg.n_layers, "tokens": [2, 513],
              "loss_kernels": runs["kernels"]["loss"],
              "loss_plain": runs["plain"]["loss"],
              "launches_kernels": runs["kernels"]["launches"],
              "launches_plain": runs["plain"]["launches"],
              "router_calls_same_experts": same_route,
              "router_min_margin": min(m for _, m in
                                       runs["kernels"]["routing"]),
              "grad_excess_max": max(excess.values()),
              "grad_excess_by_leaf": excess}
    log_row(result)
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "flash_block_fwd": 0, "gmm_fwd": 9 * L, "gmm_dw": 3 * L}
    if runs["kernels"]["launches"] != want or \
            runs["plain"]["launches"]["gmm_fwd"] or \
            runs["plain"]["launches"]["gmm_dw"]:
        raise AssertionError("phase 7a launches %s / %s, expected %s"
                             % (runs["kernels"]["launches"],
                                runs["plain"]["launches"], want))
    if len(same_route) != 2 * L or not all(same_route):
        raise AssertionError("the kernel and plain runs routed tokens "
                             "differently: %s" % same_route)
    if abs(result["loss_kernels"] - result["loss_plain"]) > \
            1e-5 * abs(result["loss_plain"]) or max(excess.values()) > 1.0:
        raise AssertionError("f32 loss or gradients through K5/K6 disagree "
                             "with plain gmm: %s" % json.dumps(result))


def checked_gmm(G, FC, run):
    """run() with every K5 and K6 launch held against the plain version on
    the same inputs; returns (run's result, {kernel: each launch's reading
    over its limit, GMM_FWD_ROW_LIMIT or GMM_DW_ROW_LIMIT})."""
    import torch

    ratios = {"gmm_fwd": [], "gmm_dw": []}
    fwd, dw = G._gmm_fwd_cuda, G._gmm_dw_cuda

    def fwd_checked(x, w, tg, ta, w_transposed=False):
        y = fwd(x, w, tg, ta, w_transposed)
        ratios["gmm_fwd"].append(FC.gmm_reading(
            y, G._gmm_fwd_plain(x, w, tg, ta, w_transposed), True)
            / G.GMM_FWD_ROW_LIMIT)
        return y

    def dw_checked(x, dy, tg, ta, groups, out_dtype=torch.float32):
        out = dw(x, dy, tg, ta, groups, out_dtype)
        want = G._gmm_dw_plain(x, dy, tg, ta, groups, out_dtype)
        # f32 out to GMM_DW_ROW_LIMIT; an output rounded to bf16, against
        # the plain sum rounded once, to K5's limit as a bf16 output
        limit = (G.GMM_DW_ROW_LIMIT if out_dtype == torch.float32
                 else G.GMM_FWD_ROW_LIMIT)
        ratios["gmm_dw"].append(FC.gmm_reading(out, want, True) / limit)
        return out

    with gmm_route(G, fwd_checked, dw_checked):
        result = run()
    return result, ratios


def active_params(params, cfg):
    """Parameters a token passes through: all but the embedding table and
    the unchosen experts' share of the expert weights."""
    experts = sum(params["layers"][k].numel()
                  for k in ("w_gate", "w_up", "w_down"))
    unchosen = experts * (cfg.n_experts - cfg.experts_per_tok) // \
        cfg.n_experts
    total = sum(t.numel() for t in params["layers"].values()) + sum(
        params[k].numel() for k in ("final_norm", "lm_head"))
    return total - unchosen


KERNEL_GROUPS = (  # device-time buckets of a profiled step, first match
    ("NCCL collectives", ("nccl",)),
    ("K4 flash_block_fwd", ("flash_fwd_wgmma_kernel<128, true>",
                            "flash_fwd_wgmma_kernel<64, true>",
                            "flash_fwd_f32_kernel<128, true>",
                            "flash_fwd_f32_kernel<64, true>")),
    ("K5 gmm_fwd", ("gmm_fwd_wgmma", "gmm_fwd_f32")),
    ("K6 gmm_dw", ("gmm_dw_wgmma", "gmm_dw_f32")),
    ("K3 flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("K2 flash_bwd_dq", ("flash_bwd_dq",)),
    ("K1 flash_fwd", ("flash_fwd",)),
    ("cuBLAS products", ("nvjet", "gemm", "xmma", "cutlass", "sm90_",
                         "sm80_")),
    ("optimizer and other elementwise", ("elementwise", "vectorized",
                                         "foreach", "unrolled")),
    ("reductions", ("reduce",)),
    ("index, scatter, sort", ("index", "scatter", "gather", "sort",
                              "radix", "cub")),
)


def profiled(torch, run):
    """run() under torch.profiler; returns (run's result, device time by
    KERNEL_GROUPS bucket and by kernel, in ms, and the wall ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    kernels = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        # c10d's "nccl:<op>" ranges on the device repeat their kernel's time
        if us and getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA") and \
                not ev.key.startswith("nccl:"):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    buckets = {}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        buckets[group] = buckets.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    # from the trace's timeline: the time some kernel, copy or fill ran
    # on the card, the time NCCL's kernels ran, and how much other work
    # ran beside them
    spans = device_spans(prof)
    nccl = [(a, b) for name, a, b in spans if "nccl" in name.lower()]
    rest = [(a, b) for name, a, b in spans if "nccl" not in name.lower()]
    return result, {"wall_ms": wall, "device_ms": sum(kernels.values()),
                    "by_group_ms": buckets,
                    "top_kernels_ms": [[k[:90], v] for k, v in top],
                    "busy_ms": covered_ms(nccl + rest),
                    "nccl_ms": covered_ms(nccl),
                    "nccl_beside_other_ms": covered_ms(nccl) +
                    covered_ms(rest) - covered_ms(nccl + rest)}


def device_spans(prof):
    """(name, start ms, end ms) of each event on the card in a finished
    torch.profiler trace: kernels, copies, fills; c10d's "nccl:" ranges,
    annotations over their kernels, left out."""
    return [(ev.name, ev.time_range.start / 1e3, ev.time_range.end / 1e3)
            for ev in prof.events()
            if str(ev.device_type).endswith("CUDA") and
            not ev.name.startswith("nccl:") and
            ev.time_range.elapsed_us() > 0]


def covered_ms(spans):
    """The length of the union of (start, end) spans."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def phase7b_train(torch, mixtral, L, G, FC, training):
    """Mixtral-8x7B in bf16 at full width, 2 of 32 layers: 5 trainer steps
    on one fixed batch of tokens [4, 2049]. Returns (the launches of the
    run, its result, the trained params, the config)."""
    cfg = mixtral.MixtralConfig.mixtral_8x7b(n_layers=2, moe_dispatch="gmm")
    gen = torch.Generator(device="cuda").manual_seed(8)
    t0 = time.perf_counter()
    params = mixtral.init_params(cfg, gen)
    n_params, n_active = mixtral.num_params(params), active_params(params,
                                                                   cfg)
    B, S = 4, 2048
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device="cuda")}
    state, step = training.make_trainer(
        cfg, mixtral, optimizer=training.default_optimizer(
            warmup_steps=1, total_steps=10), params=params)
    torch.cuda.synchronize()
    log("phase 7b: mixtral_8x7b bf16 params %.3fB (%.3fB active a token), "
        "depth %d of 32, init %.1fs" % (n_params / 1e9, n_active / 1e9,
                                        cfg.n_layers,
                                        time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    steps, ratios, profile = [], None, None
    L.reset_launch_counts()
    for i in range(5):
        before = dict(L.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 0:  # outside the median: the profiler slows the host
            (state, m), profile = profiled(torch, lambda: step(state, batch))
        elif i == 2:
            (state, m), ratios = checked_gmm(G, FC,
                                             lambda: step(state, batch))
        elif i == 3:  # the main path reads nothing back to the host
            torch.cuda.set_sync_debug_mode("error")
            try:
                state, m = step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            state, m = step(state, batch)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        steps.append({"step": i, "ms": (time.perf_counter() - t) * 1e3,
                      "loss": loss, "grad_norm": norm,
                      "launches": {n: L.LAUNCHES[n] - before[n]
                                   for n in L.LAUNCHES}})
    launches = dict(L.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(s_["ms"] for s_ in steps
                                if s_["step"] in (1, 3, 4))
    tokens_per_s = B * S / step_ms * 1e3
    fpt = training.flops_per_token_dense(n_active, cfg.n_layers, cfg.dim, S)
    peak = training.peak_tflops(torch.cuda.get_device_name(0))
    if peak is None:
        raise AssertionError("no peak rate for %s"
                             % torch.cuda.get_device_name(0))
    result = {"phase": "7b", "steps": steps, "step_ms": step_ms,
              "tokens_per_s": tokens_per_s, "params": n_params,
              "active_params": n_active, "flops_per_token": fpt,
              "peak_tflops": peak, "mfu": tokens_per_s * fpt / (peak * 1e12),
              "peak_mem_gb": peak_gb, "launches": launches,
              "in_model_reading_over_limit": {
                  n: max(r) for n, r in ratios.items()},
              "in_model_checks": {n: len(r) for n, r in ratios.items()},
              "profile_step_0": profile}
    log_row(result)
    L = cfg.n_layers
    want = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "flash_block_fwd": 0, "gmm_fwd": 9 * L, "gmm_dw": 3 * L}
    for s_ in steps:
        if s_["launches"] != want:
            raise AssertionError("step %d launched %s, expected %s"
                                 % (s_["step"], s_["launches"], want))
    if len(ratios["gmm_fwd"]) != 9 * L or len(ratios["gmm_dw"]) != 3 * L \
            or max(max(r) for r in ratios.values()) > 1.0:
        raise AssertionError("K5/K6 off their plain versions inside the "
                             "model: %s" % ratios)
    losses = [s_["loss"] for s_ in steps]
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)):
        raise AssertionError("non-finite losses %s" % losses)
    if abs(losses[0] - losses[1]) > 1e-5 * abs(losses[0]) or \
            not losses[4] < losses[1]:
        raise AssertionError("the loss must hold at step 1 (lr 0 on the "
                             "first update) and fall to step 4: %s" % losses)
    return launches, result, state["params"], cfg


def phase7c_generate(torch, decode, params, cfg):
    """generate() with the trained bf16 Mixtral: 2 prompts x 16 new
    tokens through the MoE decode branch."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    prompts = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                            device="cuda")
    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = decode.generate(params, prompts, cfg, 16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    new = out[:, 40:]
    result = {"phase": "7c", "prompts": 2, "new_tokens": 16, "wall_s": wall,
              "tokens_per_s": new.numel() / wall,
              "first_tokens": new[:, :4].tolist()}
    log_row(result)
    if out.shape != (2, 56) or not torch.equal(out[:, :40], prompts) or \
            not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError("generate returned %s" % out.tolist())


RING_HOP = (2, 2048, 16, 8, 128)  # bench_1b's ring hop at 8k: a shard of 4


def block_fwd_work(B, S, H, KV, D, dtype_bytes, diag):
    """(operations, bytes) the least K4 must do on one hop: two products
    (4*D flop per live (q, k) pair: S(S+1)/2 of them on a diagonal hop,
    S^2 on a full one); q, k, v read once, the f32 acc and m, l written
    once."""
    pairs = S * (S + 1) // 2 if diag else S * S
    qkv = (B * S * H * D + 2 * B * S * KV * D) * dtype_bytes
    return 4.0 * B * H * D * pairs, qkv + 4 * B * S * H * D + 8 * B * H * S


def block_fwd_limits(A, torch, dt):
    """K4's limits per reading (FC.block_fwd_case_readings): f32's acc is
    read in units of 1e-5."""
    return {"acc": 1.0 if dt == torch.float32 else A.FLASH_BLOCK_ROW_LIMIT,
            "m": A.FLASH_BLOCK_STATS_LIMIT, "lse": A.FLASH_BLOCK_STATS_LIMIT}


def phase8a_block_fwd(A, FC, torch, baseline=None):
    """K4 against its plain version at every case of FC.BLOCK_FWD_CASES
    (shard views), then its times at bench_1b's 8k ring hop, diagonal and
    full, beside the plain version's and SDPA's flash forward with lse
    (baseline: an earlier build of flash_fwd.cu, whose K4 is timed in turns
    with this tree's). Returns {'diag': record, 'full': record}."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    records = {}
    for case in FC.BLOCK_FWD_CASES:
        B, S, H, KV, D, dt, diag = case
        q, k, v = FC.block_fwd_inputs(case, gen)
        readings = FC.block_fwd_case_readings(q, k, v, diag)
        limit = block_fwd_limits(A, torch, dt)
        row = {"phase": "8a", "shape": [B, S, H, KV, D],
               "dtype": str(dt).split(".")[-1], "diagonal": diag,
               "readings": readings, "limit": limit}
        if not all(readings[key] <= limit[key] for key in limit):
            log_row(row)
            raise AssertionError("K4 disagrees with its plain version: %s"
                                 % json.dumps(row))
        if (B, S, H, KV, D) == RING_HOP:
            key = "diag" if diag else "full"
            records[key] = time_block_fwd(A, torch, q, k, v, diag, baseline)
            row["times"] = records[key]
            if "old_new" in records[key]:
                log("phase 8a: K4 %s hop: earlier build %.4f ms, this build "
                    "%.4f ms (turns %s)" % (
                        key, records[key]["old_new"]["old_ms"],
                        records[key]["old_new"]["new_ms"],
                        records[key]["old_new"]["turns_ms"]))
            log("phase 8a: K4 %s hop: %.4f ms, bound %.4f ms (%s), plain "
                "%.3f ms, SDPA flash fwd + lse %.4f ms" % (
                    key, records[key]["ms"], records[key]["bound_ms"],
                    records[key]["bound_by"], records[key]["plain_ms"],
                    records[key]["library_ms"]))
        log_row(row)
        del q, k, v
        torch.cuda.empty_cache()
    return records


def time_block_fwd(A, torch, q, k, v, diag, baseline=None):
    """K4's times on one hop beside its plain version, SDPA's flash forward
    with its lse and (baseline) the earlier build's K4, in turns."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = D ** -0.5
    acc, _, l = A._flash_block_fwd_cuda(q, k, v, scale, diag)
    r_acc, _, r_l = A._flash_block_fwd_plain(q, k, v, scale, diag)
    err = (A.flash_block_output(acc, l) - A.flash_block_output(
        r_acc, r_l)).abs().max().item()
    del acc, l, r_acc, r_l
    # SDPA's flash forward on [B, H, S, D] with the kv heads repeated,
    # returning O and its lse: what the ring's merge needs of a hop
    q_t = q.transpose(1, 2).contiguous()
    k_t, v_t = (A._broadcast_gqa(t, H).transpose(1, 2).contiguous()
                for t in (k, v))
    work = block_fwd_work(B, S, H, KV, D, 2, diag)
    bound, by = bound_ms(work, tensor_cores=True)
    record = {
        "ms": cuda_ms(lambda: A._flash_block_fwd_cuda(q, k, v, scale, diag),
                      20),
        "plain_ms": cuda_ms(
            lambda: A._flash_block_fwd_plain(q, k, v, scale, diag), 3),
        "library_ms": cuda_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                q_t, k_t, v_t, 0.0, diag, False, scale=scale), 20),
        "bound_ms": bound, "bound_by": by, "gflop": work[0] / 1e9,
        "gbytes": work[1] / 1e9, "max_abs_err": err}
    if baseline is not None:
        from metaflow_tpu_torch.ops import _build

        times, old, new = baseline_turns(
            _build, "flash_fwd", baseline,
            lambda: A._flash_block_fwd_cuda(q, k, v, scale, diag), 20)
        times["readings_new_vs_old"] = A.flash_block_readings(*new, old)
        record["old_new"] = times
    return record


def _grads(torch, fn, leaves, g):
    """fn's output and the gradients of <fn(*leaves), g>."""
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    out = fn(*leaves)
    out.backward(g)
    return [out.detach()] + [t.grad for t in leaves]


def phase8b_ring_vs_flash(A, R, L, torch):
    """ring_attention on LocalRing(2) and (4) against flash_attention
    (K1-K3) on the same whole-sequence tensors, output and gradients:
    f32 within the JAX ring tests' tolerances (atol 2e-5 / rtol 2e-4
    forward, atol 1e-5 / rtol 1e-3 gradients), bf16 row by row
    (FLASH_BF16_ROW_LIMIT for the output, FLASH_BWD_ROW_LIMIT for the
    gradients)."""
    cases = [  # (n, B, S, H, KV, D, dtype, causal)
        (2, 1, 1024, 8, 8, 128, torch.float32, True),
        (4, 1, 1024, 8, 2, 128, torch.float32, True),
        (4, 1, 1024, 4, 4, 64, torch.float32, False),
        (2, 2, 2048, 16, 8, 128, torch.bfloat16, True),
        (4, 1, 2048, 8, 8, 128, torch.bfloat16, False),
        (4, 2, 8192, 16, 8, 128, torch.bfloat16, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(11)
    for n, B, S, H, KV, D, dt, causal in cases:
        leaves = [torch.randn(B, S, h, D, generator=gen, device="cuda").to(dt)
                  for h in (H, KV, KV)]
        g = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
        L.reset_launch_counts()
        got = _grads(torch, lambda a, b, c: R.ring_attention(
            a, b, c, R.LocalRing(n), causal=causal, impl="flash"), leaves, g)
        torch.cuda.synchronize()
        launches = dict(L.LAUNCHES)
        want = _grads(torch, lambda a, b, c: A.flash_attention(
            a, b, c, causal=causal), leaves, g)
        torch.cuda.synchronize()
        row = {"phase": "8b", "ring": n, "shape": [B, S, H, KV, D],
               "dtype": str(dt).split(".")[-1], "causal": causal,
               "launches": {k: v for k, v in launches.items() if v}}
        ok = all(bool(torch.isfinite(t.float()).all()) for t in got)
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            if dt == torch.float32:
                atol, rtol = (2e-5, 2e-4) if name == "out" else (1e-5, 1e-3)
                row[name] = ((a - b).abs() / (atol + rtol * b.abs())).max(
                ).item()
                ok = ok and row[name] <= 1.0
            else:
                row[name] = A.flash_out_error(a, b)
                ok = ok and row[name] <= (A.FLASH_BF16_ROW_LIMIT
                                          if name == "out"
                                          else A.FLASH_BWD_ROW_LIMIT)
        hops = n * (n + 1) // 2 if causal else n * n
        ok = ok and (launches["flash_block_fwd"], launches["flash_bwd_dq"],
                     launches["flash_bwd_dkv"], launches["flash_fwd"]) == (
                         hops, hops, hops, 0)
        log_row(row)
        if not ok:
            raise AssertionError("the ring disagrees with the flash path: %s"
                                 % json.dumps(row))
        del leaves, g, got, want
    torch.cuda.empty_cache()


def phase8c_ring_exact_grads(torch, llama, R, L, leaves):
    """A 2-layer full-width bench_1b in float32 with LocalRing(4): the loss
    and its gradients through the ring (K4, K2, K3) against plain
    attention's."""
    cfg = llama.LlamaConfig.bench_1b(n_layers=2, dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(12)
    params = llama.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2049), generator=gen,
                           device="cuda")
    grads, losses, launches = {}, {}, {}
    for impl, mesh in (("ring", R.LocalRing(4)), ("xla", None)):
        c = dataclasses.replace(cfg, attention_impl=impl)
        p = _leaf_params(torch, params)
        L.reset_launch_counts()
        loss = llama.loss_fn(p, {"tokens": tokens}, c, mesh=mesh)
        loss.backward()
        torch.cuda.synchronize()
        launches[impl] = dict(L.LAUNCHES)
        losses[impl] = loss.item()
        grads[impl] = {"/".join(path): t.grad for path, t in leaves(p)}
    excess = {name: _f32_excess(grads["ring"][name], grads["xla"][name])
              for name in grads["ring"]}
    result = {"phase": "8c", "layers": cfg.n_layers, "tokens": [1, 2049],
              "ring": 4, "loss_ring": losses["ring"],
              "loss_plain": losses["xla"], "launches_ring": launches["ring"],
              "grad_excess_max": max(excess.values()),
              "grad_excess_by_leaf": excess}
    log_row(result)
    n = cfg.n_layers
    want = {"flash_fwd": 0, "flash_bwd_dq": 10 * n, "flash_bwd_dkv": 10 * n,
            "flash_block_fwd": 2 * 10 * n, "gmm_fwd": 0, "gmm_dw": 0}
    if launches["ring"] != want or any(launches["xla"].values()):
        raise AssertionError("phase 8c launches %s, expected %s"
                             % (launches, want))
    if abs(losses["ring"] - losses["xla"]) > 1e-5 * abs(losses["xla"]) or \
            max(excess.values()) > 1.0:
        raise AssertionError("f32 loss or gradients through the ring "
                             "disagree with plain attention: %s"
                             % json.dumps(result))


def checked_block_fwd(A, run):
    """run() with every K4 launch held against its plain version on the
    same inputs; returns (run's result, each launch's largest reading over
    its limit)."""
    ratios, launch = [], A._flash_block_fwd_cuda

    def checked(q, k, v, scale, diag):
        out = launch(q, k, v, scale, diag)
        r = A.flash_block_readings(
            *out, A._flash_block_fwd_plain(q, k, v, scale, diag))
        ratios.append(max(r["acc"] / A.FLASH_BLOCK_ROW_LIMIT,
                          r["m"] / A.FLASH_BLOCK_STATS_LIMIT,
                          r["lse"] / A.FLASH_BLOCK_STATS_LIMIT))
        return out

    A._flash_block_fwd_cuda = checked
    try:
        result = run()
    finally:
        A._flash_block_fwd_cuda = launch
    return result, ratios


def phase8d_train_ring(torch, llama, A, R, L, training):
    """bench_1b in bf16 at full width and depth, at 8k context with ring
    attention on LocalRing(4): 5 trainer steps on one fixed batch of tokens
    [2, 8193]. Returns (the launches of the run, its result)."""
    S, B, n = 8192, 2, 4
    cfg = llama.LlamaConfig.bench_1b(attention_impl="ring", max_seq_len=S)
    gen = torch.Generator(device="cuda").manual_seed(13)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    n_params = llama.num_params(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device="cuda")}
    with torch.no_grad():  # the same model's step-0 loss through K1
        L.reset_launch_counts()
        k1_loss = llama.loss_fn(params, batch, dataclasses.replace(
            cfg, attention_impl="auto")).item()
        k1_launches = L.LAUNCHES["flash_fwd"]
    mesh = R.LocalRing(n)
    state, step = training.make_trainer(
        cfg, llama, optimizer=training.default_optimizer(
            warmup_steps=1, total_steps=10), params=params, mesh=mesh)
    torch.cuda.synchronize()
    log("phase 8d: bench_1b bf16 params %.3fB, depth %d of %d, tokens "
        "[%d, %d], %r, init %.1fs" % (n_params / 1e9, cfg.n_layers,
                                      cfg.n_layers, B, S + 1, mesh,
                                      time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    steps, ratios, profile = [], None, None
    L.reset_launch_counts()
    for i in range(5):
        before = dict(L.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if i == 0:  # outside the median: the profiler slows the host
            (state, m), profile = profiled(torch, lambda: step(state, batch))
        elif i == 2:
            (state, m), ratios = checked_block_fwd(
                A, lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        steps.append({"step": i, "ms": (time.perf_counter() - t) * 1e3,
                      "loss": loss, "grad_norm": norm,
                      "launches": {k: L.LAUNCHES[k] - before[k]
                                   for k in L.LAUNCHES}})
    launches = dict(L.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = statistics.median(s_["ms"] for s_ in steps
                                if s_["step"] in (1, 3, 4))
    tokens_per_s = B * S / step_ms * 1e3
    fpt = training.flops_per_token_dense(n_params, cfg.n_layers, cfg.dim, S)
    peak = training.peak_tflops(torch.cuda.get_device_name(0))
    if peak is None:
        raise AssertionError("no peak rate for %s"
                             % torch.cuda.get_device_name(0))
    result = {"phase": "8d", "steps": steps, "step_ms": step_ms,
              "tokens_per_s": tokens_per_s, "flops_per_token": fpt,
              "peak_tflops": peak, "mfu": tokens_per_s * fpt / (peak * 1e12),
              "peak_mem_gb": peak_gb, "launches": launches,
              "k1_step0_loss": k1_loss, "k1_launches": k1_launches,
              "in_model_k4_reading_over_limit": max(ratios),
              "in_model_k4_checks": len(ratios),
              "profile_step_0": profile}
    log_row(result)
    n_l = cfg.n_layers
    want = {"flash_fwd": 0, "flash_bwd_dq": 10 * n_l,
            "flash_bwd_dkv": 10 * n_l, "flash_block_fwd": 2 * 10 * n_l,
            "gmm_fwd": 0, "gmm_dw": 0}
    for s_ in steps:
        if s_["launches"] != want:
            raise AssertionError("step %d launched %s, expected %s"
                                 % (s_["step"], s_["launches"], want))
    if len(ratios) != 2 * 10 * n_l or max(ratios) > 1.0:
        raise AssertionError("K4 off its plain version inside the model: "
                             "%s" % ratios)
    losses = [s_["loss"] for s_ in steps]
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)):
        raise AssertionError("non-finite losses %s" % losses)
    if abs(losses[0] - losses[1]) > 1e-5 * abs(losses[0]) or \
            not losses[4] < losses[1]:
        raise AssertionError("the loss must hold at step 1 (lr 0 on the "
                             "first update) and fall to step 4: %s" % losses)
    # the JAX dry run's bound between its ring and single-mesh losses
    if k1_launches != n_l or abs(losses[0] - k1_loss) > 5e-3:
        raise AssertionError("step 0's ring loss %.6f is not within 5e-3 of "
                             "the K1 model's %.6f" % (losses[0], k1_loss))
    return launches, result


def phase8e_prefill_ring(torch, llama, A, R, L):
    """The Llama-3-8B forward at full width and depth in bf16 on tokens
    [1, 8192] through the ring on LocalRing(4), against the K1 forward on
    the same tokens and weights: 320 K4 launches, every one held against
    its plain version, and the logits within phase 2's end-to-end bound
    (top-1 agreement and largest relative difference against K1's, no
    farther than K1 from plain attention plus 0.02, twice its relative
    difference)."""
    cfg = llama.LlamaConfig.llama3_8b(attention_impl="ring")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    torch.cuda.synchronize()
    log("phase 8e: llama3_8b bf16 params %.2fB, init %.1fs"
        % (llama.num_params(params) / 1e9, time.perf_counter() - t0))
    tokens = torch.randint(0, cfg.vocab_size, (1, 8192), generator=gen,
                           device="cuda")
    mesh = R.LocalRing(4)

    def run(impl, ring):
        c = dataclasses.replace(cfg, attention_impl=impl)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = llama.forward(params, tokens, c, mesh=ring)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t) * 1e3

    def compare(a, b):
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        return agree, rel

    with torch.no_grad():
        L.reset_launch_counts()
        ring_logits, first_ms = run("ring", mesh)
        launches = dict(L.LAUNCHES)
        _, ring_ms = run("ring", mesh)
        k1_logits, _ = run("auto", None)
        _, k1_ms = run("auto", None)
        agree, rel = compare(ring_logits, k1_logits)
        finite = bool(torch.isfinite(ring_logits).all())
        del ring_logits
        _, ratios = checked_block_fwd(A, lambda: run("ring", mesh))
        plain_logits, plain_ms = run("xla", None)
        floor_agree, floor_rel = compare(k1_logits, plain_logits)
        del plain_logits, k1_logits
    n_tok = tokens.numel()
    result = {"phase": "8e", "tokens": [1, 8192], "ring": 4,
              "launches": {k: v for k, v in launches.items() if v},
              "forward_ms": ring_ms, "first_forward_ms": first_ms,
              "tokens_per_s": n_tok / ring_ms * 1e3,
              "k1_forward_ms": k1_ms, "k1_tokens_per_s": n_tok / k1_ms * 1e3,
              "plain_forward_ms": plain_ms,
              "top1_agree_ring_vs_k1": agree,
              "max_rel_logit_diff_ring_vs_k1": rel,
              "top1_agree_k1_vs_plain": floor_agree,
              "max_rel_logit_diff_k1_vs_plain": floor_rel,
              "in_model_k4_reading_over_limit": max(ratios),
              "in_model_k4_checks": len(ratios)}
    log_row(result)
    if launches["flash_block_fwd"] != 10 * cfg.n_layers or \
            launches["flash_fwd"] or not finite:
        raise AssertionError("the 8k ring prefill launched %s, expected "
                             "K4 %d times" % (launches, 10 * cfg.n_layers))
    if len(ratios) != 10 * cfg.n_layers or max(ratios) > 1.0:
        raise AssertionError("K4 off its plain version inside the model: "
                             "%s" % ratios)
    if agree < floor_agree - 0.02 or rel > 2 * floor_rel:
        raise AssertionError("ring and K1 forwards disagree beyond the "
                             "rounding floor: %s" % json.dumps(result))
    del params
    return launches, result


def _train_steps(torch, L, step, state, batches, steps, special=None):
    """`steps` trainer steps on the batches `batches(i)` gives; special
    maps a step index to a wrapper of that step's call (a profile, a
    check). Returns (state, one record a step, the wrappers' results)."""
    records, extra = [], {}
    for i in range(steps):
        before = dict(L.LAUNCHES)
        batch = batches(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        if special and i in special:
            (state, m), extra[i] = special[i](lambda: step(state, batch))
        else:
            state, m = step(state, batch)
        loss, norm = m["loss"].item(), m["grad_norm"].item()
        torch.cuda.synchronize()
        records.append({"step": i, "ms": (time.perf_counter() - t) * 1e3,
                        "loss": loss, "grad_norm": norm,
                        "launches": {n: L.LAUNCHES[n] - before[n]
                                     for n in L.LAUNCHES}})
    return state, records, extra


def _check_training(records, n_layers, label, one_batch=True):
    """Every step launched K1 2L and K2, K3 L times and nothing else; the
    losses are finite and, on one fixed batch, hold at step 1 (lr 0 on the
    first update) and fall to the last step."""
    want = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers, "flash_block_fwd": 0,
            "gmm_fwd": 0, "gmm_dw": 0}
    for r in records:
        if r["launches"] != want:
            raise AssertionError("%s: step %d launched %s, expected %s"
                                 % (label, r["step"], r["launches"], want))
    losses = [r["loss"] for r in records]
    if not all(x == x and abs(x) < 1e4 for x in losses):
        raise AssertionError("%s: non-finite losses %s" % (label, losses))
    if one_batch and (abs(losses[0] - losses[1]) > 1e-5 * abs(losses[0])
                      or not losses[-1] < losses[1]):
        raise AssertionError("%s: the loss must hold at step 1 (lr 0 on the "
                             "first update) and fall to the last step: %s"
                             % (label, losses))


def _rates(torch, training, n_params, cfg, B, S, step_ms):
    tokens_per_s = B * S / step_ms * 1e3
    fpt = training.flops_per_token_dense(n_params, cfg.n_layers, cfg.dim, S)
    peak = training.peak_tflops(torch.cuda.get_device_name(0))
    if peak is None:
        raise AssertionError("no peak rate for %s"
                             % torch.cuda.get_device_name(0))
    return {"step_ms": step_ms, "tokens_per_s": tokens_per_s,
            "flops_per_token": fpt, "peak_tflops": peak,
            "mfu": tokens_per_s * fpt / (peak * 1e12)}


def _free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def _bench_1b_factored(torch, llama, L, training, policy, B, seed=9,
                       steps=5):
    """bench_1b uncut in bf16 under `policy` on
    memory_efficient_optimizer(warmup_steps=1, total_steps=10): `steps`
    steps on one fixed batch of tokens [B, 2049]."""
    cfg = llama.LlamaConfig.bench_1b(remat_policy=policy)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init_params(cfg, gen)
    n_params = llama.num_params(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, 2049),
                                     generator=gen, device="cuda")}
    state, step = training.make_trainer(
        cfg, llama, optimizer=training.memory_efficient_optimizer(
            warmup_steps=1, total_steps=10), params=params)
    del params
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    L.reset_launch_counts()
    try:
        _, records, _ = _train_steps(torch, L, step, state,
                                     lambda i: batch, steps)
    finally:
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        del state, step, batch
        _free(torch)
    result = {"remat_policy": policy, "tokens": [B, 2049],
              "params": n_params, "peak_mem_gb": peak_gb,
              "launches": dict(L.LAUNCHES), "steps": records}
    result.update(_rates(torch, training, n_params, cfg, B, 2048,
                         statistics.median(r["ms"] for r in records[1:])))
    _check_training(records, cfg.n_layers, "phase 9a (%s)" % policy)
    return result


def phase9a_factored_policies(torch, llama, L, training):
    """bench.py's accelerator setup: bench_1b uncut, bf16, on
    memory_efficient_optimizer at tokens [32, 2049], 5 steps under each of
    remat_policy None, "dots" and "attn_out". A policy that runs out of
    memory at 32 rows is recorded with the peak it reached and run at 16.
    Returns {policy: result}."""
    out = {}
    for policy in (None, "dots", "attn_out"):
        oom = None
        try:
            out[policy] = _bench_1b_factored(torch, llama, L, training,
                                             policy, 32)
        except torch.cuda.OutOfMemoryError as ex:
            oom = {"tokens": [32, 2049],
                   "peak_mem_gb_reached":
                       torch.cuda.max_memory_allocated() / 1e9,
                   "error": str(ex).splitlines()[0]}
        if oom is not None:  # the traceback's frames are gone by now
            _free(torch)
            log("phase 9a: remat_policy=%r out of memory at [32, 2049]: %s"
                % (policy, json.dumps(oom)))
            out[policy] = _bench_1b_factored(torch, llama, L, training,
                                             policy, 16)
            out[policy]["out_of_memory_at_32"] = oom
        r = out[policy]
        log_row(dict(r, phase="9a"), "9a.%s" % policy)
        log("phase 9a: remat_policy=%r [%d, 2049]: %.1f ms a step, %.0f "
            "tokens/s, MFU %.4f, peak %.2f GB" % (
                policy, r["tokens"][0], r["step_ms"], r["tokens_per_s"],
                r["mfu"], r["peak_mem_gb"]))
    return out


def phase9b_resume(torch, llama, L, training, tmp_root):
    """Resume from an async checkpoint: bench_1b in bf16 on the factored
    optimizer, fed by ResumableTokenBatches through prefetch onto the card
    from a seeded random token array, checkpoints written through the
    port's local datastore under `tmp_root`. Steps 1-4 with a save after
    step 2; then a new trainer built with checkpoint= from other initial
    weights reruns steps 3-4 from the restored data stamp. The resumed
    losses and weights must agree within 1e-3 relative; bit identity and
    how long save() blocked are printed."""
    import numpy as np

    from metaflow_tpu_torch.datastore import LocalFlowDataStore
    from metaflow_tpu_torch.training import data as data_mod

    cfg = llama.LlamaConfig.bench_1b()
    B = 8
    tokens = np.random.default_rng(10).integers(
        0, cfg.vocab_size, 12 * B * 2049).astype(np.int32)

    def trainer(seed, checkpoint=None):
        return training.make_trainer(
            cfg, llama, optimizer=training.memory_efficient_optimizer(
                warmup_steps=1, total_steps=10),
            generator=torch.Generator(device="cuda").manual_seed(seed),
            checkpoint=checkpoint)

    def stream(stamp=None):
        ds = data_mod.ResumableTokenBatches(tokens, B, 2048, seed=11)
        if stamp is not None:
            ds.restore(stamp)
        return data_mod.prefetch(iter(ds), depth=2, device="cuda")

    mgr = training.AsyncCheckpointManager(
        LocalFlowDataStore("ChipSmoke", tmp_root), "bench_1b", keep=2)
    state, step = trainer(12)
    batches = stream()
    got = []
    save = {}

    def take(i):
        got.append(next(batches))
        return got[-1]

    def save_after(run):
        out = run()
        torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save(out[0], out[0]["step"], extra=got[-1][data_mod.STATE_KEY])
        save["blocked_ms"] = (time.perf_counter() - t) * 1e3
        return out, None

    L.reset_launch_counts()
    state, records, _ = _train_steps(torch, L, step, state, take, 4,
                                     special={1: save_after})
    batches.close()
    t = time.perf_counter()
    mgr.wait()
    save["background_ms_after_steps"] = (time.perf_counter() - t) * 1e3
    want = {path: p.detach().clone()
            for path, p in training.train_step.leaves(state["params"])}
    del state, step
    _free(torch)

    t = time.perf_counter()
    state, step = trainer(13, checkpoint=mgr)
    restore_s = time.perf_counter() - t
    ck = mgr.last_restored
    if ck is None or ck.step != 2 or state["step"] != 2 or \
            state["opt_state"]["count"] != 2:
        raise AssertionError("phase 9b: restored %s, state step %s"
                             % (ck and ck.step, state["step"]))
    batches = stream(ck.extra)
    state, resumed, _ = _train_steps(torch, L, step, state,
                                     lambda i: next(batches), 2)
    batches.close()
    worst, identical = 0.0, True
    for path, p in training.train_step.leaves(state["params"]):
        w = want[path]
        identical &= bool(torch.equal(p, w))
        worst = max(worst, ((p.float() - w.float()).abs().max()
                            / w.float().abs().max()).item())
    losses = [r["loss"] for r in records[2:]]
    again = [r["loss"] for r in resumed]
    result = {"phase": "9b", "tokens": [B, 2049], "steps": records,
              "resumed_steps": resumed, "save_step": 2,
              "save_blocked_ms": save["blocked_ms"],
              # the resumed run's steps: no write in flight
              "step_ms": statistics.median(r["ms"] for r in resumed),
              "step_ms_while_writing": [r["ms"] for r in records[2:]],
              "write_left_after_step_4_ms":
                  save["background_ms_after_steps"],
              "restore_s": restore_s, "manifests": mgr.steps(),
              "losses": losses, "resumed_losses": again,
              "losses_bit_identical": losses == again,
              "params_bit_identical": identical,
              "params_max_rel_diff": worst}
    log_row(result)
    log("phase 9b: save blocked %.1f ms against a %.1f ms step (steps 3-4 "
        "%s ms while the write ran, %.1f ms of it left after them); resumed "
        "losses %s vs %s (bit identical: %s), parameters bit identical: %s"
        % (save["blocked_ms"], result["step_ms"],
           [round(r["ms"], 1) for r in records[2:]],
           save["background_ms_after_steps"], again, losses,
           losses == again, identical))
    _check_training(records + resumed, cfg.n_layers, "phase 9b",
                    one_batch=False)
    if any(abs(a - b) > 1e-3 * abs(b) for a, b in zip(again, losses)) or \
            worst > 1e-3:
        raise AssertionError("phase 9b: the resumed run is off the "
                             "uninterrupted one: %s" % json.dumps(result))
    del state, step, want
    _free(torch)
    return result


def profiled_ops(torch, run):
    """run() under torch.profiler; returns (run's result, the step's
    device time and its split by operator: each op's device time with the
    kernels of the ops it calls, the top ones, and select_backward's)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = run()
        torch.cuda.synchronize()
    rows, device_ms = [], 0.0
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0)) / 1e3
        self_ms = getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            device_ms += self_ms  # kernels: each counted once
        elif total:
            rows.append([ev.key[:60], total, ev.count])
    rows.sort(key=lambda r: -r[1])
    by_op = {k: ms for k, ms, _ in rows}
    return result, {
        "device_ms": device_ms,
        "select_backward_ms": by_op.get("aten::select_backward", 0.0),
        # the node's whole backward: select_backward's full-size zeros and
        # the engine's sum of the layers' full-size gradients of a leaf
        "select_backward_node_ms": by_op.get(
            "autograd::engine::evaluate_function: SelectBackward0", 0.0),
        "top_ops_ms": rows[:25]}


def _bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase9c_llama3_8b(torch, llama, A, L, training):
    """Llama-3-8B uncut (32 layers, 8.03 B parameters) in bf16 on
    memory_efficient_optimizer(warmup_steps=1, total_steps=10), 5 steps on
    one fixed batch of tokens [4, 2049]: step 1 profiled by operator,
    every K2/K3 launch of step 2 held against its plain version. Returns
    its result."""
    leaves = training.train_step.leaves
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(14)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen)
    n_params = llama.num_params(params)
    B, S = 4, 2048
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device="cuda")}
    opt = training.memory_efficient_optimizer(warmup_steps=1,
                                              total_steps=10)
    state, step = training.make_trainer(cfg, llama, optimizer=opt,
                                        params=params)
    del params
    torch.cuda.synchronize()
    memory = {
        "params_gb": _bytes(p for _, p in leaves(state["params"])) / 1e9,
        "grads_gb": _bytes(p for _, p in leaves(state["params"])) / 1e9,
        "optimizer_state_gb": _bytes(
            t for name in ("v_row", "v_col", "v", "mu")
            for _, t in leaves(state["opt_state"][name])) / 1e9,
        "second_moment_mb": _bytes(
            t for name in ("v_row", "v_col", "v")
            for _, t in leaves(state["opt_state"][name])) / 1e6}
    log("phase 9c: llama3_8b bf16 params %.3fB, depth %d of %d, init %.1fs"
        % (n_params / 1e9, cfg.n_layers, cfg.n_layers,
           time.perf_counter() - t0))
    torch.cuda.reset_peak_memory_stats()
    L.reset_launch_counts()
    state, records, extra = _train_steps(
        torch, L, step, state, lambda i: batch, 5,
        special={1: lambda run: profiled_ops(torch, run),
                 2: lambda run: checked_backward(A, run)})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    memory["peak_gb"] = peak_gb
    memory["rest_gb"] = peak_gb - memory["params_gb"] - \
        memory["grads_gb"] - memory["optimizer_state_gb"]
    ratios = extra[2]
    result = {"phase": "9c", "tokens": [B, S + 1], "params": n_params,
              "layers": cfg.n_layers, "memory": memory,
              "launches": dict(L.LAUNCHES), "steps": records,
              "profile_step_1": extra[1],
              "in_model_row_err_over_limit": {
                  n: max(r) for n, r in ratios.items()},
              "in_model_checks": {n: len(r) for n, r in ratios.items()}}
    result.update(_rates(torch, training, n_params, cfg, B, S,
                         statistics.median(r["ms"] for r in records[3:])))
    log_row(result)
    prof = extra[1]
    log("phase 9c: %.1f ms a step, %.0f tokens/s, MFU %.4f, peak %.2f GB "
        "(params %.2f, grads %.2f, optimizer state %.2f, rest %.2f); "
        "step 1's device time %.1f ms, select_backward %.1f ms (%.1f ms "
        "with the gradient sums of its node)" % (
            result["step_ms"], result["tokens_per_s"], result["mfu"],
            peak_gb, memory["params_gb"], memory["grads_gb"],
            memory["optimizer_state_gb"], memory["rest_gb"],
            prof["device_ms"], prof["select_backward_ms"],
            prof["select_backward_node_ms"]))
    _check_training(records, cfg.n_layers, "phase 9c")
    if any(len(r) != cfg.n_layers or max(r) > 1.0 for r in ratios.values()):
        raise AssertionError("K2/K3 off their plain version inside the "
                             "8B model: %s" % ratios)
    if abs(n_params - 8.03e9) > 0.01e9:
        raise AssertionError("phase 9c: %d parameters" % n_params)
    del state, step, batch
    _free(torch)
    return result


# ---------------------------------------------------------------------------
# phase 10: serving through the whole stack (HTTP -> Scheduler ->
# PagedEngine, the paged prefix index)
# ---------------------------------------------------------------------------

HTTP_TIMEOUT_S = 600.0


def http_generate(port, body):
    """POST /v1/generate on 127.0.0.1:port. Returns (status, body dict,
    seconds to the first token, seconds to the end). A streamed request
    reads its JSON lines as they arrive; the first token's time is taken
    at its line (for a plain request it is the whole response's)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body).encode())
        resp = conn.getresponse()
        if not body.get("stream") or resp.status != 200:
            out = json.loads(resp.read() or b"{}")
            t = time.perf_counter() - t0
            return resp.status, out, t, t
        first, tokens, last = None, [], None
        while True:
            line = resp.readline()
            if not line:
                break
            item = json.loads(line)
            if "token" in item:
                if first is None:
                    first = time.perf_counter() - t0
                tokens.append(item["token"])
            elif item.get("done"):
                last = item
        resp.read()
        out = {"new_tokens": tokens, "reason": (last or {}).get("reason"),
               "streamed_tail": (last or {}).get("new_tokens")}
        return resp.status, out, first, time.perf_counter() - t0
    finally:
        conn.close()


def post_all(port, bodies):
    """Post every body at once, one client thread each; returns the
    results in order."""
    import threading

    results = [None] * len(bodies)

    def worker(i):
        try:
            results[i] = http_generate(port, bodies[i])
        except Exception as ex:  # recorded; the caller fails on it
            results[i] = (None, {"error": repr(ex)}, None, None)

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError("an HTTP client did not finish in %.0fs"
                             % HTTP_TIMEOUT_S)
    return results


def serve_stack(params, cfg, **kw):
    """The port's serving entry point, cmd/serve.py serve(), on the card:
    PagedEngine -> Scheduler -> ServingServer, started on 127.0.0.1 port 0
    with pages of 16 positions and prefill chunks of 64."""
    from metaflow_tpu_torch.cmd.serve import serve

    return serve(params, cfg, host="127.0.0.1", port=0, paged=True,
                 page_tokens=16, prefill_chunk=64, echo=log, block=False,
                 **kw)


def stop_stack(server):
    """Drain the server, clear its prefix index, and fail on a leaked
    page or slot."""
    sched = server.scheduler
    if not server.shutdown(timeout=HTTP_TIMEOUT_S):
        raise AssertionError("the scheduler did not drain")
    if sched.prefix_cache is not None:
        sched.prefix_cache.clear()
    engine = sched.engine
    pool = engine.pool
    if pool.free_pages() != pool.usable_pages or \
            engine.free_slots() != list(range(engine.max_slots)):
        raise AssertionError("leaked KV pages or slots after drain: %s"
                             % pool.stats())


def profile_decode_window(torch, engine, first, count):
    """Mark the engine's decode steps first .. first + count - 1 as a
    window that profiled_window() profiles from the main thread (where the
    profiler is set up; it sees every kernel of the process). The loop
    thread waits at the window's edges for the profiler to start and to
    stop, and measures the window's wall and CPU seconds itself
    (time.thread_time: less than the wall time where the thread waited,
    for the interpreter lock or the card). Returns the window's dict."""
    import threading

    window = {"decode_steps": count, "prefill_steps": 0,
              "open": threading.Event(), "started": threading.Event(),
              "close": threading.Event(), "stopped": threading.Event()}
    decode, prefill = engine.decode_step, engine.prefill_step
    seen = [0]

    def prefill_step(*args, **kw):
        if window["started"].is_set() and not window["close"].is_set():
            window["prefill_steps"] += 1
        return prefill(*args, **kw)

    def decode_step(*args, **kw):
        n = seen[0]
        seen[0] += 1
        if n == first:
            window["open"].set()
            if window["started"].wait(60.0):
                window["t"] = time.perf_counter()
                window["cpu"] = time.thread_time()
        out = decode(*args, **kw)
        if n == first + count - 1 and "t" in window:
            torch.cuda.synchronize()
            window["wall_s"] = time.perf_counter() - window["t"]
            window["thread_cpu_s"] = time.thread_time() - window["cpu"]
            window["close"].set()
            window["stopped"].wait(60.0)
        return out

    engine.decode_step, engine.prefill_step = decode_step, prefill_step
    return window


def profiled_window(torch, window, busy):
    """In the main thread: start torch.profiler when the loop thread opens
    the window and stop it when the thread closes it, while busy() (the
    traffic) lasts."""
    from torch.profiler import ProfilerActivity, profile

    while not window["open"].wait(0.01):
        if not busy():
            raise AssertionError("phase 10b: the traffic ended before "
                                 "the profiled decode window")
    torch.cuda.synchronize()
    t = time.perf_counter()
    window["profiler"] = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
    window["profiler"].start()
    window["profiler_start_s"] = time.perf_counter() - t
    window["started"].set()
    while not window["close"].wait(0.01):
        if not busy():
            break
    t = time.perf_counter()
    window["profiler"].stop()
    window["profiler_stop_s"] = time.perf_counter() - t
    window["stopped"].set()


def window_summary(window):
    """Device-busy time against wall time, and the device operations
    (kernels, copies, fills: one stream, so their summed time is the busy
    time) and kernel launch calls per engine step, of a closed
    profile_decode_window."""
    if "wall_s" not in window or "profiler" not in window:
        raise AssertionError("phase 10b: the profiled decode window did "
                             "not close")
    device_ms, device_ops, launch_calls = 0.0, 0, 0
    for ev in window["profiler"].key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            device_ms += getattr(ev, "self_device_time_total", getattr(
                ev, "self_cuda_time_total", 0)) / 1e3
            device_ops += ev.count
        elif ev.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                        "cuLaunchKernel"):
            launch_calls += ev.count
    wall_ms = window["wall_s"] * 1e3
    steps = window["decode_steps"] + window["prefill_steps"]
    return {"decode_steps": window["decode_steps"],
            "prefill_steps": window["prefill_steps"], "wall_ms": wall_ms,
            "step_ms": wall_ms / steps, "device_busy_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_ops_per_step": device_ops / steps,
            "launch_calls_per_step": launch_calls / steps,
            "host_us_per_launch": wall_ms * 1e3 / max(1, launch_calls),
            "loop_thread_cpu_share": window["thread_cpu_s"]
            / window["wall_s"],
            "profiler_start_s": window["profiler_start_s"],
            "profiler_stop_s": window["profiler_stop_s"]}


def top2_gap(torch, llama, params, cfg, context):
    """The f32 gap between the two largest next-token logits after
    `context`, from the plain-attention forward."""
    c = dataclasses.replace(cfg, attention_impl="xla")
    with torch.no_grad():
        logits = llama.forward(params, [context], c,
                               device=params["embed"].device)
    top = torch.topk(logits[0, -1].float(), 2).values
    return (top[0] - top[1]).item()


def bf16_divergence(torch, llama, params, cfg, context, a, b):
    """Where two greedy runs of a bf16 model chose tokens `a` and `b` after
    `context`: the next-token logits' top-2 gap and the gap between the
    two chosen tokens, both from the plain-attention forward, beside the
    largest difference between the K1 forward's logits and the plain
    forward's at that position, the size of bf16's own rounding there.
    A chosen gap within that difference is a near tie that bf16 rounding
    can decide either way. The context is padded on the right to K1's
    block contract; under causal attention the padding leaves the logits
    at the context's last position as they are."""
    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    n = len(context)
    padded = n
    while not A.blocks_aligned(padded):
        padded += 1
    tokens = list(context) + [0] * (padded - n)
    with torch.no_grad():
        logits = {impl: llama.forward(
            params, [tokens], dataclasses.replace(cfg, attention_impl=impl),
            device=params["embed"].device)[0, n - 1].float()
            for impl in ("xla", "flash")}
    plain = logits["xla"]
    top = torch.topk(plain, 2).values
    chosen = abs((plain[a] - plain[b]).item())
    noise = (logits["flash"] - plain).abs().max().item()
    return {"top2_gap": (top[0] - top[1]).item(), "chosen_gap": chosen,
            "kernel_vs_plain_max_diff": noise,
            "near_tie": chosen <= noise}


def compare_tokens(torch, llama, params, cfg, label, prompts, got, want,
                   tie_log):
    """Token identity, request by request. The one exception is a position
    where the f32 top-2 logit gap is below 1e-5 (two orders of summation
    may pick either token): it is printed with its gap and the request
    compared up to it."""
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        if a == b:
            continue
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        gap = top2_gap(torch, llama, params, cfg, list(p) + list(b[:j]))
        entry = {"check": label, "request": i, "position": j,
                 "got": a[j:j + 1], "want": b[j:j + 1], "top2_gap": gap}
        log("phase 10a: mismatch %s" % json.dumps(entry))
        if gap >= 1e-5 or len(a) != len(b):
            raise AssertionError("phase 10a %s: request %d differs at "
                                 "token %d (top-2 gap %.3g)"
                                 % (label, i, j, gap))
        tie_log.append(entry)


def phase10a_exact(torch, llama, decode, serving):
    """A narrow f32 Llama (dim 512, 4 layers, GQA 8/2, vocab 32000, pages
    of 16) served through PagedEngine -> Scheduler -> ServingServer on the
    card: greedy against generate(), spec_k 0 against spec_k 3, prefix
    hits against a cold run, sampled against SlotEngine, and the chunked
    path against the dense one."""
    import numpy as np

    cfg = llama.LlamaConfig.llama3_8b(dim=512, n_layers=4, n_heads=8,
                                      n_kv_heads=2, ffn_dim=1536,
                                      vocab_size=32000, dtype="float32",
                                      max_seq_len=1024)
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(10), device="cuda")
    rng = np.random.default_rng(10)
    greedy = [rng.integers(0, cfg.vocab_size, n).tolist()
              for n in (5, 17, 40, 64, 90, 200, 333, 600)]
    n_new = 24
    sampled = [{"tokens": rng.integers(0, cfg.vocab_size, n).tolist(),
                "max_new_tokens": n_new, "temperature": 0.8,
                "top_p": 0.95, "seed": 40 + i, "stream": i % 2 == 1}
               for i, n in enumerate((9, 77, 130, 401))]
    prefix = rng.integers(0, cfg.vocab_size, 300).tolist()
    shared = [prefix + rng.integers(0, cfg.vocab_size, n).tolist()
              for n in (1, 7, 16, 33, 80)]
    ties = []

    def serve(prompts, bodies=None, first=None, **kw):
        kw.setdefault("attn_impl", "dense")
        kw.setdefault("spec_k", 0)
        kw.setdefault("prefix_cache_mb", 0)   # 0: no prefix cache
        srv = serve_stack(params, cfg, slots=4, max_seq_len=1024, **kw)
        try:
            if first is not None:   # registers the prefix before the rest
                post_all(srv.port, [{"tokens": first,
                                     "max_new_tokens": n_new}])
            bodies = bodies or [{"tokens": p, "max_new_tokens": n_new,
                                 "stream": i % 3 == 0}
                                for i, p in enumerate(prompts)]
            res = post_all(srv.port, bodies)
            stats = srv.scheduler.stats()
        finally:
            stop_stack(srv)
        for status, body, _, _ in res:
            if status != 200 or body.get("reason") != "length":
                raise AssertionError("phase 10a: a response was %s %s"
                                     % (status, body))
        return [r[1]["new_tokens"] for r in res], stats

    t0 = time.perf_counter()
    with torch.no_grad():
        want = [decode.generate(params, [p], cfg, n_new, max_seq_len=1024,
                                device="cuda")[0, len(p):].tolist()
                for p in greedy]
    dense, _ = serve(greedy)
    compare_tokens(torch, llama, params, cfg, "greedy vs generate",
                   greedy, dense, want, ties)
    spec, spec_stats = serve(greedy, spec_k=3)
    compare_tokens(torch, llama, params, cfg, "spec_k 3 vs spec_k 0",
                   greedy, spec, dense, ties)
    if spec_stats["speculative"]["steps"] < 1:
        raise AssertionError("phase 10a: spec_k 3 ran no verify step")
    chunked, _ = serve(greedy, attn_impl="chunked")
    compare_tokens(torch, llama, params, cfg, "chunked vs dense", greedy,
                   chunked, dense, ties)
    cold, _ = serve(shared)
    hits, hit_stats = serve(shared, first=prefix + [7], prefix_cache_mb=256)
    compare_tokens(torch, llama, params, cfg, "prefix hits vs cold",
                   shared, hits, cold, ties)
    pstats = hit_stats["prefix_cache"]
    if pstats["hits"] < len(shared) or \
            hit_stats["kv_pages"]["kv_bytes_copied"] != 0:
        raise AssertionError("phase 10a: prefix hits %s" % pstats)
    paged_sampled, _ = serve(None, bodies=sampled, spec_k=3)
    slot = serving.SlotEngine(params, cfg, max_slots=4, max_seq_len=1024,
                              prefill_chunk=64, device="cuda")
    sched = serving.Scheduler(slot)
    reqs = [sched.submit(serving.Request(
        b["tokens"], max_new_tokens=n_new, temperature=b["temperature"],
        top_p=b["top_p"], rng=b["seed"])) for b in sampled]
    with torch.inference_mode():
        sched.run_until_idle(100_000)
    compare_tokens(torch, llama, params, cfg, "sampled vs SlotEngine",
                   [b["tokens"] for b in sampled], paged_sampled,
                   [r.generated for r in reqs], ties)
    result = {"phase": "10a", "greedy_requests": len(greedy),
              "sampled_requests": len(sampled),
              "prefix_requests": len(shared), "new_tokens": n_new,
              "checks": ["greedy vs generate", "spec_k 3 vs spec_k 0",
                         "chunked vs dense", "prefix hits vs cold",
                         "sampled vs SlotEngine"],
              "near_ties": ties, "spec": spec_stats["speculative"],
              "prefix_hits": pstats["hits"],
              "prefix_hit_tokens": pstats["hit_tokens"],
              "token_identical": not ties,
              "seconds": time.perf_counter() - t0}
    log_row(result)
    del params
    _free(torch)
    return result


def phase10b_serve_8b(torch, llama, L, slot_result=None):
    """Llama-3-8B uncut in bf16 (random weights from a seed) served over
    HTTP through serve(): PagedEngine(max_slots=16, max_seq_len=4096,
    page_tokens=16, prefill_chunk=64) with a 2048 MB PagedPrefixIndex; 32
    requests posted at once from 32 client threads, once with spec_k 0
    and once with spec_k 3, each on an engine of its own. A third pass of
    spec_k 0's traffic profiles decode steps 40-49 and whatever ran
    between them, then cancels what is left."""
    import threading

    import numpy as np

    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, gen, device="cuda")
    n_params = llama.num_params(params)
    torch.cuda.synchronize()
    log("phase 10b: llama3_8b bf16 params %.3fB, depth %d of %d, init %.1fs"
        % (n_params / 1e9, cfg.n_layers, cfg.n_layers,
           time.perf_counter() - t0))
    if abs(n_params - 8.03e9) > 0.01e9:
        raise AssertionError("phase 10b: %d parameters" % n_params)
    rng = np.random.default_rng(100)
    system = rng.integers(0, cfg.vocab_size, 1024).tolist()
    bodies = []
    for i in range(32):
        if i % 2 == 0:   # the system prompt and at least 17 own tokens
            n = int(rng.integers(1024 + 17, 2001))
            toks = system + rng.integers(0, cfg.vocab_size,
                                         n - 1024).tolist()
        else:
            n = int(rng.integers(17, 2001))
            toks = rng.integers(0, cfg.vocab_size, n).tolist()
        body = {"tokens": toks, "max_new_tokens": 64,
                "stream": i % 4 == 1}
        if i % 4 >= 2:   # half sampled, half greedy
            body.update(temperature=0.8, top_p=0.95, seed=1000 + i)
        bodies.append(body)
    order = rng.permutation(32).tolist()   # the posting order
    bodies = [bodies[i] for i in order]
    runs = {}
    # the third pass repeats spec_k 0's traffic to profile decode steps
    # 40-49 (the profiler would slow the measured passes), then cancels
    # what is left of it
    for spec_k, profile in ((0, False), (3, False), (0, True)):
        srv = serve_stack(params, cfg, slots=16, max_seq_len=4096,
                          spec_k=spec_k, prefix_cache_mb=2048)
        sched = srv.scheduler
        eng = sched.engine
        pool = eng.pool
        window = (profile_decode_window(torch, eng, 40, 10) if profile
                  else None)
        posted = [dict(b, request_id="p%d" % i) for i, b in enumerate(
            bodies)] if profile else bodies
        peak = {"pages": 0, "shared": 0}
        done = threading.Event()

        def monitor():
            while not done.wait(0.02):
                s = pool.stats()
                peak["pages"] = max(peak["pages"], s["pages_in_use"])
                peak["shared"] = max(peak["shared"], s["shared_pages"])

        watcher = threading.Thread(target=monitor, daemon=True)
        try:
            # the system prompt is warmed once, as a deployment warms it
            # before traffic: its pages are registered in the index
            warm = post_all(srv.port, [{"tokens": system + [1],
                                        "max_new_tokens": 1}])[0]
            if warm[0] != 200:
                raise AssertionError("phase 10b warm-up: %s" % (warm,))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            watcher.start()
            dec0 = sched.busy_decode_s
            hits0, miss0 = sched.prefix_hits, sched.prefix_misses
            L.reset_launch_counts()
            t = time.perf_counter()
            box = {}
            poster = threading.Thread(target=lambda: box.update(
                results=post_all(srv.port, posted)), daemon=True)
            poster.start()
            if window is not None:
                profiled_window(torch, window, poster.is_alive)
                for i in range(len(posted)):
                    sched.cancel("p%d" % i)
            poster.join(HTTP_TIMEOUT_S + 60)
            wall = time.perf_counter() - t
            if "results" not in box:
                raise AssertionError("phase 10b spec_k %d: the clients did "
                                     "not finish" % spec_k)
            results = box["results"]
            launches = dict(L.LAUNCHES)
            stats = sched.stats()
            decode_s = sched.busy_decode_s - dec0
        finally:
            done.set()
            stop_stack(srv)   # drains, clears the index, checks leaks
        reasons = ("length", "cancelled") if profile else ("length",)
        bad = [(i, r[0], r[1].get("reason"), r[1].get("error"))
               for i, r in enumerate(results)
               if r[0] != 200 or r[1].get("reason") not in reasons
               or (not profile and len(r[1].get("new_tokens", ())) != 64)]
        if bad:
            raise AssertionError("phase 10b spec_k %d: bad responses %s"
                                 % (spec_k, bad))
        if profile:
            summary = dict(window_summary(window), cancelled=sum(
                r[1].get("reason") == "cancelled" for r in results))
            log("phase 10b: profiled window of a third spec_k 0 pass %s"
                % json.dumps(summary))
            ROWS["10b.window"] = summary
            del eng, pool, sched, srv, window
            _free(torch)
            continue
        ttft = sorted(r[2] for r, b in zip(results, bodies)
                      if b.get("stream"))
        tokens = [r[1]["new_tokens"] for r in results]
        for toks in tokens:
            if not all(0 <= x < cfg.vocab_size for x in toks):
                raise AssertionError("phase 10b: a token out of range")
        hits = stats["prefix_cache"]["hits"] - hits0
        kv = stats["kv_pages"]
        prompt_tokens = sum(len(b["tokens"]) for b in bodies)
        prefilled = prompt_tokens - hits * len(system)
        run = {"spec_k": spec_k, "requests": len(bodies), "wall_s": wall,
               "requests_per_s": len(bodies) / wall,
               "ttft_stream_s": ttft,
               "ttft_p50_s": ttft[len(ttft) // 2],
               "ttft_p99_s": ttft[-1],
               "server_ttft_p50_ms": stats["p50_ttft_ms"],
               "server_ttft_p99_ms": stats["p99_ttft_ms"],
               "decode_tokens": sum(len(x) - 1 for x in tokens),
               "decode_s": decode_s,
               "decode_tokens_per_s": sum(len(x) - 1 for x in tokens)
               / decode_s,
               "output_tokens_per_s": sum(len(x) for x in tokens) / wall,
               "prefill_s": stats["goodput"]["serve_prefill_s"],
               "prompt_tokens": prompt_tokens,
               "prefill_tokens": prefilled,
               "prefill_tokens_per_s": prefilled
               / stats["goodput"]["serve_prefill_s"],
               "decode_steps": stats["decode_steps"],
               "decode_step_ms": decode_s / stats["decode_steps"] * 1e3,
               "peak_pages_in_use": peak["pages"],
               "pages_total": pool.usable_pages,
               "peak_page_occupancy": peak["pages"] / pool.usable_pages,
               "peak_shared_pages": peak["shared"],
               "prefix_hits": hits,
               "prefix_misses": stats["prefix_cache"]["misses"] - miss0,
               "prefix_hit_tokens": stats["prefix_cache"]["hit_tokens"],
               "shared_pages_attached": kv["shared_pages_attached"],
               "kv_bytes_copied": kv["kv_bytes_copied"],
               "cow_pages": kv["cow_pages"],
               "spec": stats["speculative"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "pool_gb": 2 * pool.kv["k"].numel()
               * pool.kv["k"].element_size() / 1e9,
               "launches": launches, "attn_impl": eng.attn_impl}
        runs[spec_k] = (run, tokens)
        log_row(dict({"phase": "10b"}, **run), "10b.k%d" % spec_k)
        if hits < 15 or kv["kv_bytes_copied"] != 0:
            raise AssertionError("phase 10b: %d prefix hits, %d KV bytes "
                                 "copied" % (hits, kv["kv_bytes_copied"]))
        del eng, pool, sched, srv
        _free(torch)
    greedy = [i for i, b in enumerate(bodies) if not b.get("temperature")]
    same = sum(runs[0][1][i] == runs[3][1][i] for i in greedy)
    # where spec_k 3 and spec_k 0 part, the logits at the first differing
    # token say whether it was a bf16 near tie
    divergences = []
    for i in greedy:
        got, want = runs[3][1][i], runs[0][1][i]
        if got == want:
            continue
        j = next(j for j, (x, y) in enumerate(zip(got, want)) if x != y)
        entry = dict({"request": i, "position": j, "spec3": got[j],
                      "spec0": want[j]}, **bf16_divergence(
            torch, llama, params, cfg, bodies[i]["tokens"] + want[:j],
            got[j], want[j]))
        log("phase 10b: greedy spec_k 3 and spec_k 0 part %s"
            % json.dumps(entry))
        if not entry["near_tie"]:
            raise AssertionError(
                "phase 10b: greedy request %d parts at token %d with a "
                "chosen gap %.3g over bf16's rounding there (%.3g): not a "
                "near tie" % (i, j, entry["chosen_gap"],
                              entry["kernel_vs_plain_max_diff"]))
        divergences.append(entry)
    result = {"phase": "10b", "params": n_params,
              "greedy_identical_share_spec3_vs_spec0": same / len(greedy),
              "greedy_divergences": divergences,
              "spec0": runs[0][0], "spec3": runs[3][0],
              "slot_engine_3b": slot_result}
    log_row({"phase": "10b", "params": n_params,
             "greedy_identical_share_spec3_vs_spec0": same / len(greedy),
             "greedy_divergences": divergences,
             "slot_engine_3b": slot_result})
    del params
    _free(torch)
    return result


# ---------------------------------------------------------------------------
# phase 11: training as users run it (the streamed corpus, the train.step
# telemetry and its profiler window, the split update, Ulysses)
# ---------------------------------------------------------------------------

# the data keys a train.step record may carry (tests/schema_validate.py
# TRAIN_STEP_DATA_SCHEMA), and those every 11a step carries
TRAIN_STEP_KEYS = {"tokens_per_sec", "tflops_per_chip", "mfu", "compile",
                   "input_stall_ms", "optimizer_update_ms",
                   "transfer_stall_ms"}
TRAIN_STEP_RATES = {"tokens_per_sec", "tflops_per_chip", "mfu"}


def kernel_group(name):
    """The KERNEL_GROUPS bucket of a kernel's name, or None."""
    low = name.lower()
    return next((g for g, keys in KERNEL_GROUPS
                 if any(k in low for k in keys)), None)


def trace_kernel_counts(fds, path):
    """Launches by kernel bucket in a profile artifact's Chrome trace (the
    zip ProfileTrigger saved)."""
    import zipfile

    with zipfile.ZipFile(fds.storage.full_uri(path)) as zf:
        events = json.loads(zf.read(zf.namelist()[0]))["traceEvents"]
    counts = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            group = kernel_group(ev.get("name", ""))
            if group is not None:
                counts[group] = counts.get(group, 0) + 1
    return counts


def _step_records(records):
    steps = [r for r in records
             if r["name"] == "train.step" and r["type"] == "timer"]
    return sorted(steps, key=lambda r: r["step_num"])


def phase11a_stream_telemetry(torch, llama, L, training, tmp_root):
    """Llama-3-8B uncut in bf16 on memory_efficient_optimizer at tokens
    [4, 2049] for 8 steps, as a user's flow step runs it: a seeded corpus
    built with build_corpus into a LocalFlowDataStore (5 shards of 8
    windows and a short tail), streamed by StreamingTokenBatches through
    prefetch onto the card; make_trainer(telemetry=...) recording into a
    FlightRecorder on the same datastore; TPUFLOW_PROFILE_STEPS=4:6. The
    records are held against an independent clock (CUDA events around
    each call, one synchronize at the end) and the profile's kernels
    counted."""
    import numpy as np

    from metaflow_tpu_torch import data as data_mod
    from metaflow_tpu_torch import progress, telemetry
    from metaflow_tpu_torch.datastore import LocalFlowDataStore

    cfg = llama.LlamaConfig.llama3_8b()
    B, S, steps = 4, 2048, 8
    W = S + 1
    fds = LocalFlowDataStore("ChipSmoke", tmp_root)
    tokens = np.random.default_rng(16).integers(
        0, cfg.vocab_size, 40 * W + 100).astype(np.int32)
    t0 = time.perf_counter()
    manifest = data_mod.build_corpus(fds, "corpus", tokens,
                                     shard_tokens=8 * W)
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(17)
    params = llama.init_params(cfg, gen)
    n_params = llama.num_params(params)
    params_bytes = _bytes(params["layers"].values()) + _bytes(
        params[k] for k in ("embed", "final_norm", "lm_head"))
    fpt = training.flops_per_token_dense(n_params, cfg.n_layers, cfg.dim, S)
    recorder = telemetry.init_recorder(fds, "r1", "train", "0")
    progress.set_task("ChipSmoke", "r1", "train", "0", root=tmp_root)
    previous = os.environ.get("TPUFLOW_PROFILE_STEPS")
    os.environ["TPUFLOW_PROFILE_STEPS"] = "4:6"
    try:
        state, step = training.make_trainer(
            cfg, llama, optimizer=training.memory_efficient_optimizer(
                warmup_steps=1, total_steps=10), params=params,
            telemetry={"tokens_per_step": B * S,
                       "flops_per_step": fpt * B * S, "memory_every": 2})
        del params
        stream = data_mod.StreamingTokenBatches(fds, "corpus", B, S,
                                                seed=18)
        batches = training.prefetch(iter(stream), depth=2, device="cuda")
        # the losses land in one buffer: a loss tensor kept a step would
        # raise the allocator's peak after the last gauge reads it
        losses = torch.empty(steps, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        L.reset_launch_counts()
        clock, launches = [], []
        for i in range(steps):
            batch = next(batches)
            before = dict(L.LAUNCHES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch)
            end.record()
            clock.append((start, end))
            losses[i] = m["loss"]
            launches.append({k: L.LAUNCHES[k] - before[k]
                             for k in L.LAUNCHES})
            del m
        batches.close()
        tel = step.telemetry
        tel.close()  # the one synchronize, then the records of the rest
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        report = tel.report()
        telemetry.close_recorder()
        beat = progress.read_progress(tmp_root, "ChipSmoke", "r1", "train",
                                      "0")
    finally:
        progress.clear_task()
        if previous is None:
            os.environ.pop("TPUFLOW_PROFILE_STEPS", None)
        else:
            os.environ["TPUFLOW_PROFILE_STEPS"] = previous
        if telemetry.current_recorder() is recorder:
            telemetry.close_recorder()
    records = telemetry.read_run_records(fds, "r1")
    step_recs = _step_records(records)
    clock_ms = [s.elapsed_time(e) for s, e in clock]
    steady = [r["step_num"] for r in step_recs
              if not r.get("data", {}).get("compile")]
    clock_step_ms = statistics.mean(clock_ms[i] for i in steady)
    clock_tps = B * S / clock_step_ms * 1e3
    profiles = telemetry.list_run_profiles(fds, "r1")
    window = trace_kernel_counts(fds, profiles[0]) if profiles else {}
    stalls = [r["data"]["input_stall_ms"] for r in step_recs
              if "input_stall_ms" in r.get("data", {})]
    names = {r["name"] for r in records}
    peak = training.peak_tflops(torch.cuda.get_device_name(0))
    mem = {r["name"]: r["value"] for r in records
           if r["name"].startswith("train.memory.")}
    losses = losses.tolist()
    record_ms = [r["ms"] for r in step_recs]
    result = {
        "phase": "11a", "tokens": [B, W], "steps": steps,
        # outside the first step (allocator and library warm-up) and the
        # profile window's stop (its trace export lands in step 5)
        "median_step_ms": statistics.median(
            ms for i, ms in enumerate(record_ms) if i not in (0, 5)),
        "median_step_ms_9c": ROWS.get("9c", {}).get("step_ms"),
        "corpus_shards": manifest["n_shards"],
        "corpus_tokens": manifest["total_tokens"], "corpus_build_s": build_s,
        "step_ms": report["mean_step_ms"],
        "tokens_per_s": report["tokens_per_sec"], "mfu": report["mfu"],
        "clock_tokens_per_s": clock_tps, "clock_step_ms": clock_step_ms,
        "records_vs_clock": report["tokens_per_sec"] / clock_tps - 1,
        "input_stall_ms": statistics.mean(stalls) if stalls else None,
        "input_stall_share": (statistics.mean(stalls) / report["mean_step_ms"]
                              if stalls else None),
        "peak_mem_gb": peak_bytes / 1e9,
        "recorded_peak_gb": report.get("device_memory_peak_bytes", 0) / 1e9,
        "params_gb": params_bytes / 1e9,
        "window_launches": window, "profiles": len(profiles),
        "steady_steps": len(steady), "losses": losses,
        "record_ms": record_ms, "clock_ms": clock_ms,
        "input_stalls_ms": stalls,
        "final_beat": beat and {k: beat[k] for k in ("step_num", "done",
                                                     "phase")},
        "report": report}
    log_row(result)
    log("phase 11a: %.1f ms a step, median %.1f (9c in this call: %s), "
        "%.0f tokens/s from the records against %.0f by CUDA events "
        "(%+.2f %%), MFU %.4f, input stall %s ms a step, peak %.2f GB; "
        "profile window %s"
        % (result["step_ms"], result["median_step_ms"],
           result["median_step_ms_9c"], result["tokens_per_s"],
           clock_tps, 100 * result["records_vs_clock"], result["mfu"],
           result["input_stall_ms"], result["peak_mem_gb"], window))
    failures = []
    if [r["step_num"] for r in step_recs] != list(range(steps)):
        failures.append("train.step records for steps %s"
                        % [r["step_num"] for r in step_recs])
    for r in step_recs:
        keys = set(r.get("data", {}))
        if not keys <= TRAIN_STEP_KEYS or not TRAIN_STEP_RATES <= keys:
            failures.append("step %d's record carries %s"
                            % (r["step_num"], sorted(keys)))
        elif abs(r["data"]["mfu"] - r["data"]["tflops_per_chip"] / peak) \
                > 1.01e-4:
            failures.append("step %d: mfu %s is not tflops %s / %s"
                            % (r["step_num"], r["data"]["mfu"],
                               r["data"]["tflops_per_chip"], peak))
    if len(stalls) != steps - 1:
        failures.append("%d input stalls for %d steps" % (len(stalls), steps))
    if abs(result["records_vs_clock"]) > 0.03:
        failures.append("the records' tokens/s is off the CUDA-event clock")
    if mem.get("train.memory.params_bytes") != params_bytes or \
            abs(params_bytes / 1e9 - 16.06) > 0.01:
        failures.append("train.memory.params_bytes %s against %d"
                        % (mem.get("train.memory.params_bytes"),
                           params_bytes))
    if report.get("device_memory_peak_bytes") != peak_bytes:
        failures.append("recorded peak %s against max_memory_allocated %d"
                        % (report.get("device_memory_peak_bytes"),
                           peak_bytes))
    want = {"K1 flash_fwd": 2 * 2 * cfg.n_layers,
            "K2 flash_bwd_dq": 2 * cfg.n_layers,
            "K3 flash_bwd_dkv": 2 * cfg.n_layers}
    if len(profiles) != 1 or {k: window.get(k) for k in want} != want:
        failures.append("%d profiles, window launches %s, expected %s over "
                        "steps 4-5" % (len(profiles), window, want))
    missing = {"goodput.interval", "profile.captured", "data.shard_fetch",
               "data.batch_wait", "data.readahead_occupancy",
               "train.summary.tokens_per_sec"} - names
    if missing:
        failures.append("no %s records" % sorted(missing))
    per_step = {"flash_fwd": 2 * cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers,
                "flash_bwd_dkv": cfg.n_layers, "flash_block_fwd": 0,
                "gmm_fwd": 0, "gmm_dw": 0}
    if any(c != per_step for c in launches):
        failures.append("launches a step %s" % launches)
    if not all(x == x and abs(x) < 1e4 for x in losses):
        failures.append("non-finite losses %s" % losses)
    if not beat or not beat["done"] or beat["step_num"] != steps:
        failures.append("final progress beat %s" % beat)
    if failures:
        raise AssertionError("phase 11a: " + "; ".join(failures))
    del state, step
    _free(torch)
    return result


def phase11b_timed_update(torch, llama, training, tmp_root):
    """bench_1b uncut in bf16 on AdamW at tokens [8, 2049] (5b's
    configuration): 3 steps of the unsplit step, then 3 of the split one
    (make_trainer(timed_update=True), with telemetry) from the same seeded
    weights and batch. Every split step's record carries
    optimizer_update_ms, and the parameters after 3 steps equal the
    unsplit ones bit for bit."""
    from metaflow_tpu_torch import telemetry
    from metaflow_tpu_torch.datastore import LocalFlowDataStore

    cfg = llama.LlamaConfig.bench_1b()
    B, S = 8, 2048
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S + 1),
        generator=torch.Generator(device="cuda").manual_seed(19),
        device="cuda")}
    fds = LocalFlowDataStore("ChipSmoke", tmp_root)
    params = {}
    for timed in (False, True):
        init = llama.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(6))
        n_params = llama.num_params(init)
        kw = {}
        if timed:
            telemetry.init_recorder(fds, "r2", "train", "0")
            kw = {"timed_update": True, "telemetry": {
                "tokens_per_step": B * S,
                "flops_per_step": B * S * training.flops_per_token_dense(
                    n_params, cfg.n_layers, cfg.dim, S)}}
        state, step = training.make_trainer(
            cfg, llama, optimizer=training.default_optimizer(
                warmup_steps=1, total_steps=10), params=init, **kw)
        del init
        for _ in range(3):
            state, _m = step(state, batch)
        if timed:
            step.telemetry.close()
            telemetry.close_recorder()
        torch.cuda.synchronize()
        params[timed] = state["params"]
        del state, step
    records = _step_records(telemetry.read_run_records(fds, "r2"))
    identical = all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            training.train_step.leaves(params[False]),
            training.train_step.leaves(params[True])))
    update_ms = [r["data"].get("optimizer_update_ms") for r in records]
    step_ms = [r["ms"] for r in records]
    result = {"phase": "11b", "tokens": [B, S + 1],
              "update_ms": (statistics.mean(update_ms[1:])
                            if None not in update_ms else None),
              "step_ms": statistics.mean(step_ms[1:]),
              "records_update_ms": update_ms, "records_step_ms": step_ms,
              "params_bit_identical": identical}
    log_row(result)
    log("phase 11b: the update %s ms of a %.1f ms split step; parameters "
        "bit identical to the unsplit step's: %s"
        % (result["update_ms"], result["step_ms"], identical))
    del params
    _free(torch)
    if len(records) != 3 or None in update_ms or not identical:
        raise AssertionError("phase 11b: %s" % json.dumps(result))
    return result


def phase11c_ulysses(torch, llama, A, R, L, training):
    """Ulysses on the card: (1) ulysses_attention on LocalRing(2) and (4)
    against flash_attention (K1-K3), output and gradients, bf16, bench_1b's
    heads (16/8, D 128) at S 8192, under 8b's row limits; (2) bench_1b in
    bf16 at 8k context (tokens [2, 8193], attention_impl="ulysses",
    LocalRing(4)), 5 AdamW steps, each launching K1 2·L·4, K2 and K3 L·4
    times and K4 never, step 0 within 5e-3 of the K1 model's loss, the
    ring's step (8d) on the same state timed in turns; (3) the Llama-3-8B
    forward on tokens [1, 8192] through Ulysses beside the ring and K1."""
    U = importlib.import_module("metaflow_tpu_torch.ops.ulysses_attention")
    gen = torch.Generator(device="cuda").manual_seed(21)
    B, S, H, KV, D = 2, 8192, 16, 8, 128
    for n in (2, 4):
        leaves = [torch.randn(B, S, h, D, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for h in (H, KV, KV)]
        g = torch.randn(B, S, H, D, generator=gen,
                        device="cuda").to(torch.bfloat16)
        L.reset_launch_counts()
        got = _grads(torch, lambda a, b, c: U.ulysses_attention(
            a, b, c, R.LocalRing(n), causal=True), leaves, g)
        torch.cuda.synchronize()
        launches = {k: v for k, v in L.LAUNCHES.items() if v}
        want = _grads(torch, lambda a, b, c: A.flash_attention(
            a, b, c, causal=True), leaves, g)
        torch.cuda.synchronize()
        row = {"phase": "11c", "ulysses": n, "shape": [B, S, H, KV, D],
               "launches": launches}
        ok = all(bool(torch.isfinite(t.float()).all()) for t in got)
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            row[name] = A.flash_out_error(a, b)
            ok = ok and row[name] <= (A.FLASH_BF16_ROW_LIMIT if name == "out"
                                      else A.FLASH_BWD_ROW_LIMIT)
        ok = ok and launches == {"flash_fwd": n, "flash_bwd_dq": n,
                                 "flash_bwd_dkv": n}
        log_row(row, "11c.kernels%d" % n)
        if not ok:
            raise AssertionError("Ulysses disagrees with the flash path: %s"
                                 % json.dumps(row))
        del leaves, g, got, want
    _free(torch)
    train = _ulysses_train(torch, llama, R, L, training)
    _free(torch)
    return train, _ulysses_prefill(torch, llama, R, L)


def _ulysses_train(torch, llama, R, L, training):
    S, B, n = 8192, 2, 4
    cfg = llama.LlamaConfig.bench_1b(attention_impl="ulysses",
                                     max_seq_len=S)
    gen = torch.Generator(device="cuda").manual_seed(13)
    params = llama.init_params(cfg, gen)
    n_params = llama.num_params(params)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S + 1),
                                     generator=gen, device="cuda")}
    with torch.no_grad():  # the same model's step-0 loss through K1
        k1_loss = llama.loss_fn(params, batch, dataclasses.replace(
            cfg, attention_impl="auto")).item()
    mesh = R.LocalRing(n)
    opt = training.default_optimizer(warmup_steps=1, total_steps=20)
    state, uly_step = training.make_trainer(cfg, llama, optimizer=opt,
                                            params=params, mesh=mesh)
    del params
    # the ring's step (8d) on the same state and optimizer
    ring_step = training.make_train_step(
        dataclasses.replace(cfg, attention_impl="ring"), llama,
        optimizer=opt, mesh=mesh)
    steps = {"ulysses": uly_step, "ring": ring_step}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = {"ulysses": [], "ring": []}
    # step 0 of each, then in turns: U R R U U R R U
    for impl in ["ulysses", "ring"] + ["ulysses", "ring", "ring",
                                       "ulysses"] * 2:
        before = dict(L.LAUNCHES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = steps[impl](state, batch)
        loss = m["loss"].item()
        torch.cuda.synchronize()
        runs[impl].append({"ms": (time.perf_counter() - t) * 1e3,
                           "loss": loss,
                           "launches": {k: L.LAUNCHES[k] - before[k]
                                        for k in L.LAUNCHES}})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rates = {impl: _rates(torch, training, n_params, cfg, B, S,
                          statistics.median(r["ms"] for r in rs[1:]))
             for impl, rs in runs.items()}
    n_l = cfg.n_layers
    want = {"ulysses": {"flash_fwd": 2 * n_l * n, "flash_bwd_dq": n_l * n,
                        "flash_bwd_dkv": n_l * n, "flash_block_fwd": 0,
                        "gmm_fwd": 0, "gmm_dw": 0},
            "ring": {"flash_fwd": 0, "flash_bwd_dq": 10 * n_l,
                     "flash_bwd_dkv": 10 * n_l,
                     "flash_block_fwd": 2 * 10 * n_l, "gmm_fwd": 0,
                     "gmm_dw": 0}}
    result = {"phase": "11c", "tokens": [B, S + 1], "ulysses": n,
              "step_ms": rates["ulysses"]["step_ms"],
              "tokens_per_s": rates["ulysses"]["tokens_per_s"],
              "mfu": rates["ulysses"]["mfu"],
              "ring_step_ms": rates["ring"]["step_ms"],
              "ring_mfu": rates["ring"]["mfu"], "peak_mem_gb": peak_gb,
              "k1_step0_loss": k1_loss,
              "step0_loss": runs["ulysses"][0]["loss"],
              "launches": runs["ulysses"][-1]["launches"],
              "ulysses_ms": [r["ms"] for r in runs["ulysses"]],
              "ring_ms": [r["ms"] for r in runs["ring"]],
              "losses": [r["loss"] for r in runs["ulysses"]]}
    log_row(result, "11c.train")
    log("phase 11c: bench_1b 8k through Ulysses %.1f ms a step (MFU %.4f) "
        "against the ring's %.1f ms in turns; peak %.2f GB"
        % (result["step_ms"], result["mfu"], result["ring_step_ms"],
           peak_gb))
    bad = [(impl, i) for impl, rs in runs.items()
           for i, r in enumerate(rs) if r["launches"] != want[impl]]
    losses = [r["loss"] for rs in runs.values() for r in rs]
    if bad or not all(x == x and abs(x) < 1e4 for x in losses):
        raise AssertionError("phase 11c: launches off %s (expected %s) or "
                             "non-finite losses %s" % (bad, want, losses))
    if abs(runs["ulysses"][0]["loss"] - k1_loss) > 5e-3:
        raise AssertionError("step 0's Ulysses loss %.6f is not within 5e-3 "
                             "of the K1 model's %.6f"
                             % (runs["ulysses"][0]["loss"], k1_loss))
    return result


def _ulysses_prefill(torch, llama, R, L):
    cfg = llama.LlamaConfig.llama3_8b(attention_impl="ulysses")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 8192), generator=gen,
                           device="cuda")
    mesh = R.LocalRing(4)

    def run(impl, ring):
        c = dataclasses.replace(cfg, attention_impl=impl)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = llama.forward(params, tokens, c, mesh=ring)
        torch.cuda.synchronize()
        return logits, (time.perf_counter() - t) * 1e3

    def compare(a, b):
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        return agree, rel

    with torch.no_grad():
        L.reset_launch_counts()
        uly_logits, _ = run("ulysses", mesh)
        launches = {k: v for k, v in L.LAUNCHES.items() if v}
        _, uly_ms = run("ulysses", mesh)
        _, ring_ms = run("ring", mesh)
        k1_logits, k1_ms = run("auto", None)
        agree, rel = compare(uly_logits, k1_logits)
        finite = bool(torch.isfinite(uly_logits).all())
        del uly_logits
        plain_logits, _ = run("xla", None)
        floor_agree, floor_rel = compare(k1_logits, plain_logits)
        del plain_logits, k1_logits
    result = {"phase": "11c", "tokens": [1, 8192], "ulysses": 4,
              "forward_ms": uly_ms, "tokens_per_s": 8192 / uly_ms * 1e3,
              "ring_forward_ms": ring_ms, "k1_forward_ms": k1_ms,
              "launches": launches,
              "top1_agree_ulysses_vs_k1": agree,
              "max_rel_logit_diff_ulysses_vs_k1": rel,
              "top1_agree_k1_vs_plain": floor_agree,
              "max_rel_logit_diff_k1_vs_plain": floor_rel}
    log_row(result, "11c.prefill")
    del params
    _free(torch)
    if launches != {"flash_fwd": 4 * cfg.n_layers} or not finite:
        raise AssertionError("the 8k Ulysses prefill launched %s, expected "
                             "K1 %d times" % (launches, 4 * cfg.n_layers))
    if agree < floor_agree - 0.02 or rel > 2 * floor_rel:
        raise AssertionError("Ulysses and K1 forwards disagree beyond the "
                             "rounding floor: %s" % json.dumps(result))
    return result


# ---------------------------------------------------------------------------
# phase 12: a user's flow on the card (python train_flow.py run: the flow
# runtime, the datastore, @gpu, @checkpoint), then
# `python -m metaflow_tpu_torch serve TrainFlow` from that run's checkpoint
# ---------------------------------------------------------------------------

def params_digest(params):
    """sha256 over every parameter's tree path, dtype, shape and the
    sha256 of its bytes, in sorted path order. The leaves are hashed on 8
    threads (sha256 releases the interpreter lock), each copied from the
    card to the host once."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    import torch

    def paths(tree, prefix=()):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from paths(tree[key], prefix + (key,))
            else:
                yield prefix + (key,), tree[key]

    def leaf(item):
        path, value = item
        t = value.detach().to("cpu").contiguous()
        data = hashlib.sha256(memoryview(
            t.reshape(-1).view(torch.uint8).numpy())).hexdigest()
        return "%s %s %s %s" % ("/".join(path), t.dtype, tuple(t.shape),
                                data)

    with ThreadPoolExecutor(max_workers=8) as pool:
        lines = list(pool.map(leaf, paths(params)))
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


# the user's flow file; PARAMS_DIGEST is replaced by params_digest's source
TRAIN_FLOW = '''
from metaflow_tpu_torch import FlowSpec, checkpoint, current, gpu, step

PARAMS_DIGEST


class TrainFlow(FlowSpec):
    """Llama-3-8B uncut on the card: 3 steps on memory_efficient_optimizer
    (phase 9c's seeds and batch), then a checkpoint to serve."""

    @step
    def start(self):
        self.next(self.train)

    @gpu(require_gpu=True)
    @checkpoint
    @step
    def train(self):
        import dataclasses
        import os
        import time

        import torch

        from metaflow_tpu_torch import training
        from metaflow_tpu_torch.models import llama
        from metaflow_tpu_torch.ops import launches

        cfg = llama.LlamaConfig.llama3_8b()
        gen = torch.Generator(device="cuda").manual_seed(14)
        params = llama.init_params(cfg, gen)
        self.n_params = llama.num_params(params)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2049),
                                         generator=gen, device="cuda")}
        opt = training.memory_efficient_optimizer(warmup_steps=1,
                                                  total_steps=10)
        state, train_step = training.make_trainer(cfg, llama, optimizer=opt,
                                                  params=params)
        del params
        self.losses, self.step_ms, self.launches = [], [], []
        for _ in range(3):
            launches.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = train_step(state, batch)
            self.losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            self.step_ms.append((time.perf_counter() - t) * 1e3)
            self.launches.append(dict(launches.LAUNCHES))
        self.peak_gb = torch.cuda.max_memory_allocated() / 1e9
        self.device_kind = current.gpu.device_kind
        self.num_devices = current.gpu.num_devices
        params = state["params"]
        del state
        t = time.perf_counter()
        self.digest = params_digest(params)
        self.digest_s = time.perf_counter() - t
        t = time.perf_counter()
        path = current.checkpoint.save(
            {"params": params, "config": dataclasses.asdict(cfg),
             "step": 2}, step=2)
        self.save_s = time.perf_counter() - t
        self.save_bytes = os.path.getsize(
            os.path.join(path, "checkpoint.pytree"))
        self.next(self.end)

    @step
    def end(self):
        pass


if __name__ == "__main__":
    TrainFlow()
'''

FLOW_LAUNCHES = {"flash_fwd": 64, "flash_bwd_dq": 32, "flash_bwd_dkv": 32,
                 "flash_block_fwd": 0, "gmm_fwd": 0, "gmm_dw": 0}


def _tail(path, n=60):
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-n:])


@contextlib.contextmanager
def _datastore_root(root):
    """The flow datastore root for this process's client calls."""
    old = os.environ.get("TPUFLOW_DATASTORE_SYSROOT_LOCAL")
    os.environ["TPUFLOW_DATASTORE_SYSROOT_LOCAL"] = root
    try:
        yield
    finally:
        if old is None:
            del os.environ["TPUFLOW_DATASTORE_SYSROOT_LOCAL"]
        else:
            os.environ["TPUFLOW_DATASTORE_SYSROOT_LOCAL"] = old


def phase12a_flow_run(torch, tmp, env):
    """`python train_flow.py run` in a subprocess; the run read back
    through the port's client. Returns (run id, the train task's data)."""
    import inspect

    flow_file = os.path.join(tmp, "train_flow.py")
    with open(flow_file, "w") as f:
        f.write(TRAIN_FLOW.replace("PARAMS_DIGEST",
                                   inspect.getsource(params_digest)))
    out = os.path.join(tmp, "run.log")
    t = time.perf_counter()
    with open(out, "w") as f:
        rc = subprocess.run([sys.executable, flow_file, "run"], cwd=tmp,
                            env=env, stdout=f, stderr=subprocess.STDOUT,
                            timeout=900).returncode
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError("phase 12a: train_flow.py run exited %d:\n%s"
                             % (rc, _tail(out)))
    from metaflow_tpu_torch import client

    client.namespace(None)
    run = client.Flow("TrainFlow").latest_run
    if not run.successful:
        raise AssertionError("phase 12a: run %s not successful:\n%s"
                             % (run.id, _tail(out)))
    data = run["train"].task.data
    losses = list(data.losses)
    if not all(x == x and abs(x) < 1e4 for x in losses):
        raise AssertionError("phase 12a: non-finite losses %s" % losses)
    kind = torch.cuda.get_device_name(0)
    if data.device_kind != kind or "H100" not in data.device_kind or \
            data.num_devices != torch.cuda.device_count():
        raise AssertionError("phase 12a: current.gpu says %s x %r, the card "
                             "is %r" % (data.num_devices, data.device_kind,
                                        kind))
    if any(dict(r) != FLOW_LAUNCHES for r in data.launches):
        raise AssertionError("phase 12a: the train task's steps launched "
                             "%s, expected %s each"
                             % (data.launches, FLOW_LAUNCHES))
    if abs(data.n_params - 8.03e9) > 0.01e9:
        raise AssertionError("phase 12a: %d parameters" % data.n_params)
    return run.id, wall, data


def _wait_serving(proc, out, deadline_s):
    """The port the server prints it listens on, and the seconds until
    /healthz said ok."""
    import http.client

    t0 = time.perf_counter()
    port = None
    while time.perf_counter() - t0 < deadline_s:
        if proc.poll() is not None:
            raise AssertionError("phase 12b: the server exited %s:\n%s"
                                 % (proc.returncode, _tail(out)))
        if port is None:
            with open(out, errors="replace") as f:
                for line in f:
                    if " on http://127.0.0.1:" in line:
                        port = int(line.split("http://127.0.0.1:")[1]
                                   .split()[0])
        if port is not None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=10)
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                body = json.loads(resp.read() or b"{}")
                conn.close()
                if resp.status == 200 and body.get("ok"):
                    return port, time.perf_counter() - t0
            except OSError:
                pass
        time.sleep(0.5)
    raise AssertionError("phase 12b: no healthy server in %.0fs:\n%s"
                         % (deadline_s, _tail(out)))


def _get_stats(port):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("GET", "/v1/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def phase12b_serve_run(torch, tmp, env, vocab_size):
    """`python -m metaflow_tpu_torch serve TrainFlow --paged --spec-k 3`
    in a subprocess: 8 requests (prompts of 17-2000 tokens, 64 new
    tokens, 4 streamed), then SIGTERM and a drained exit 0."""
    import numpy as np

    out = os.path.join(tmp, "serve.log")
    cmd = [sys.executable, "-m", "metaflow_tpu_torch", "serve", "TrainFlow",
           "--paged", "--spec-k", "3", "--port", "0"]
    log("phase 12b: %s" % " ".join(cmd[1:]))
    with open(out, "w") as f:
        proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=f,
                                stderr=subprocess.STDOUT)
    try:
        port, ready_s = _wait_serving(proc, out, 600)
        rng = np.random.default_rng(120)
        bodies = []
        for i in range(8):
            n = 17 if i == 0 else 2000 if i == 1 else \
                int(rng.integers(17, 2001))
            bodies.append({"tokens": rng.integers(0, vocab_size, n).tolist(),
                           "max_new_tokens": 64, "stream": i % 2 == 1})
        before = _get_stats(port)
        t = time.perf_counter()
        results = post_all(port, bodies)
        wall = time.perf_counter() - t
        after = _get_stats(port)
        bad = [(i, r[0], r[1].get("reason"), r[1].get("error"))
               for i, r in enumerate(results)
               if r[0] != 200 or len(r[1].get("new_tokens") or ()) != 64]
        if bad:
            raise AssertionError("phase 12b: bad responses %s\n%s"
                                 % (bad, _tail(out)))
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=HTTP_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    text = _tail(out, 400)
    if rc != 0 or "drained" not in text:
        raise AssertionError("phase 12b: after SIGTERM the server exited %s"
                             " (drained: %s):\n%s"
                             % (rc, "drained" in text, _tail(out)))
    ttft = sorted(r[2] for r, b in zip(results, bodies) if b["stream"])
    decode_s = after["goodput"]["serve_decode_s"] - \
        before["goodput"]["serve_decode_s"]
    decoded = sum(len(r[1]["new_tokens"]) - 1 for r in results)
    return {"load_to_ready_s": ready_s, "requests": len(bodies),
            "wall_s": wall, "ttft_stream_s": ttft,
            "ttft_p50_s": ttft[len(ttft) // 2],
            "decode_tokens": decoded, "decode_s": decode_s,
            "decode_tokens_per_s": decoded / decode_s,
            "server_ttft_p50_ms": after["p50_ttft_ms"],
            "spec": after["speculative"], "exit_code": rc}


def phase12_flow(torch, flagship=None):
    """A user's flow run by its own command line on the card, then served
    from its checkpoint, and the served weights held to the trained
    ones."""
    import shutil

    from metaflow_tpu_torch.inference import load_run_checkpoint

    _free(torch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_flow_")
    try:
        free = shutil.disk_usage(tmp).free
        log("phase 12: flow directory %s, %.1f GB free" % (tmp, free / 1e9))
        if free < 40e9:
            raise AssertionError("phase 12: %s has %.1f GB free; the "
                                 "checkpoint and its copy need 40"
                                 % (tmp, free / 1e9))
        root = os.path.join(tmp, "tpuflow")
        env = dict(os.environ, PYTHONPATH=HERE,
                   TPUFLOW_DATASTORE_SYSROOT_LOCAL=root)
        with _datastore_root(root):
            run_id, wall, data = phase12a_flow_run(torch, tmp, env)
            base = flagship and statistics.median(
                r["ms"] for r in flagship["steps"][3:])
            median = statistics.median(data.step_ms[1:])
            log("phase 12a: TrainFlow/%s succeeded in %.1fs of wall time; "
                "%s; steps %s ms (median of steps 1-2 %.1f ms, phase 9c's "
                "%s), losses %s, K1/K2/K3 launches a step %s, peak %.2f GB; "
                "save %.1fs for %.3f GB, digest %.1fs"
                % (run_id, wall, data.device_kind,
                   ["%.1f" % x for x in data.step_ms], median,
                   "%.1f ms" % base if base else "not run",
                   data.losses, [(r["flash_fwd"], r["flash_bwd_dq"],
                                  r["flash_bwd_dkv"]) for r in data.launches],
                   data.peak_gb, data.save_s, data.save_bytes / 1e9,
                   data.digest_s))
            served = phase12b_serve_run(torch, tmp, env, 128_256)
            log("phase 12b: load-to-ready %.1fs, %d requests in %.1fs, "
                "client TTFT p50 %.2fs (streamed), decode %.2f tok/s, "
                "spec %s, exit %d after SIGTERM"
                % (served["load_to_ready_s"], served["requests"],
                   served["wall_s"], served["ttft_p50_s"],
                   served["decode_tokens_per_s"],
                   json.dumps(served["spec"]), served["exit_code"]))
            t = time.perf_counter()
            restored = load_run_checkpoint("TrainFlow")
            restore_s = time.perf_counter() - t
            digest = params_digest(restored["params"])
            del restored
        if digest != data.digest:
            raise AssertionError("phase 12: the served checkpoint's digest "
                                 "%s is not the trained parameters' %s"
                                 % (digest, data.digest))
        log("phase 12: restore %.1fs; the checkpoint's digest is the trained "
            "parameters' (%s)" % (restore_s, digest[:16]))
        row = {"phase": "12", "run_wall_s": wall,
               "median_step_ms": median, "median_step_ms_9c": base,
               "save_s": data.save_s, "save_gb": data.save_bytes / 1e9,
               "restore_s": restore_s,
               "load_to_ready_s": served["load_to_ready_s"],
               "ttft_p50_s": served["ttft_p50_s"],
               "decode_tokens_per_s": served["decode_tokens_per_s"],
               "digest_equal": True, "run_id": run_id,
               "step_ms": data.step_ms, "losses": data.losses,
               "launches": data.launches[-1], "peak_gb": data.peak_gb,
               "digest_s": data.digest_s, "serve": served}
        log_row(row)
        return row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 13: a user's gang step trains on a mesh of every card
# ---------------------------------------------------------------------------

# the user's flow file; PARAMS_DIGEST is replaced by the sources of
# params_digest and profiled (with KERNEL_GROUPS), and the settings come
# from CHIP_SMOKE_MESH (json): the ranks, the device,
# the configurations and sizes of 13a-13c, the checkpoint directory
MESH_FLOW = '''
import json
import os

from metaflow_tpu_torch import FlowSpec, current, gpu, step

PARAMS_DIGEST

SETTINGS = json.loads(os.environ["CHIP_SMOKE_MESH"])


def whole(tree):
    """The tensors of a state, each made whole (a collective on a mesh:
    every rank calls it, in the same order)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = whole(value)
        elif hasattr(value, "full_tensor"):
            out[key] = value.full_tensor()
        elif hasattr(value, "shape"):
            out[key] = value.detach()
    return out


def config(spec):
    from metaflow_tpu_torch.models import llama

    spec = dict(spec)
    return getattr(llama.LlamaConfig, spec.pop("base"))(**spec)


def close(got, want, lrs):
    """f32 weights after steps with learning rates `lrs` against another
    run's: (share of weights off atol/rtol 1e-5, max abs difference,
    the bound 2 sum(lr) every weight must stay within)."""
    import torch

    off, n, worst = 0, 0, 0.0
    for key in got:
        if isinstance(got[key], dict):
            o, m, w, _ = close(got[key], want[key], lrs)
            off, n, worst = off + o * m, n + m, max(worst, w)
            continue
        d = (got[key].float() - want[key].float()).abs()
        off += int((d > 1e-5 + 1e-5 * want[key].float().abs()).sum())
        n += d.numel()
        worst = max(worst, d.max().item())
    return off / max(n, 1), n, worst, 2 * sum(lrs)


class MeshTrainFlow(FlowSpec):
    """A gang of one rank per card: bench_1b cut in depth on a mesh of
    every card, fsdp then data with ZeRO, held to one card (13a); the
    fsdp state saved sharded and restored onto the ZeRO mesh, or off any
    mesh on one card (13c); Llama-3-8B on fsdp over every card (13b)."""

    @step
    def start(self):
        self.next(self.train, num_parallel=SETTINGS["ranks"])

    @gpu(require_gpu=SETTINGS["device"] == "cuda")
    @step
    def train(self):
        import gc
        import statistics
        import time

        import numpy as np
        import torch
        import torch.distributed as dist

        from metaflow_tpu_torch import spmd, training
        from metaflow_tpu_torch.datastore import LocalFlowDataStore
        from metaflow_tpu_torch.models import llama
        from metaflow_tpu_torch.ops import launches

        s = SETTINGS
        dev = s["device"]
        rank = current.parallel.node_index
        n = current.parallel.num_nodes
        on_card = dev == "cuda"

        def sync():
            if on_card:
                torch.cuda.synchronize()

        fsdp = spmd.create_mesh(spmd.MeshSpec.fsdp(), device=dev)
        data = spmd.create_mesh(spmd.MeshSpec.dp(), device=dev)
        out = {"rank": rank, "world": dist.get_world_size(),
               "fsdp_mesh": dict(fsdp.shape), "data_mesh": dict(data.shape),
               "device": torch.cuda.get_device_name() if on_card else "cpu"}

        # 13a: three AdamW steps in f32 on each mesh and on one card
        small = config(s["small"])
        tokens = torch.randint(
            0, small.vocab_size, (s["small_rows"], s["small_seq"] + 1),
            generator=torch.Generator().manual_seed(7))
        adamw = training.default_optimizer(warmup_steps=1, total_steps=10)
        lrs = [adamw.schedule(c) for c in range(3)]

        def three_steps(mesh, zero=None, checkpoint=None):
            state, step = training.make_trainer(
                small, llama, optimizer=adamw, device=dev, mesh=mesh,
                zero=zero, checkpoint=checkpoint,
                generator=torch.Generator(device=dev).manual_seed(3))
            if checkpoint is not None:
                return state, None
            losses, norms = [], []
            for _ in range(3):
                state, m = step(state, {"tokens": tokens})
                losses.append(m["loss"].item())
                norms.append(m["grad_norm"].item())
            return state, (losses, norms)

        runs = {}
        t = time.perf_counter()
        state, runs["fsdp"] = three_steps(fsdp)
        out["13a_fsdp_s"] = time.perf_counter() - t
        params_fsdp = whole(state["params"])
        # 13c: the fsdp state saved sharded (rank 0 writes the whole tree)
        mgr = training.AsyncCheckpointManager(
            LocalFlowDataStore("MeshTrainFlow", s["checkpoint_dir"]),
            name="mesh")
        t = time.perf_counter()
        mgr.save(state, 3)
        mgr.wait()
        out["13c_save_s"] = time.perf_counter() - t
        saved = params_digest(whole(state))
        del state
        t = time.perf_counter()
        state, runs["data_zero"] = three_steps(data, zero=True)
        out["13a_data_zero_s"] = time.perf_counter() - t
        params_zero = whole(state["params"])
        out["13a_zero_state_share"] = sum(
            t.to_local().numel() for t in dtensors(state["opt_state"])) / \
            sum(t.numel() for t in dtensors(state["opt_state"]))
        del state
        # 13c: restored onto the ZeRO mesh, or off any mesh on one card
        target = data if n > 1 else None
        t = time.perf_counter()
        state, _ = three_steps(target, zero=True if n > 1 else None,
                               checkpoint=mgr)
        out["13c_restore_s"] = time.perf_counter() - t
        out["13c_restored_onto"] = dict(data.shape) if n > 1 else "one card"
        out["13c_digest_equal"] = params_digest(whole(state)) == saved
        out["13c_digest"] = saved[:16]
        del state
        out["13a_runs"] = runs
        if rank == 0:  # the same three steps on this card, off any mesh
            one, runs["one_card"] = three_steps(None)
            one = whole(one["params"])
            for name in ("fsdp", "data_zero"):
                share, count, worst, bound = close(
                    params_fsdp if name == "fsdp" else params_zero, one, lrs)
                out["13a_%s_vs_one_card" % name] = {
                    "share_off_1e-5": share, "weights": count,
                    "max_abs": worst, "bound": bound,
                    "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(
                        runs[name][0], runs["one_card"][0])),
                    "grad_norm_rel": max(abs(a - b) / abs(b) for a, b in zip(
                        runs[name][1], runs["one_card"][1]))}
            del one
        # the manager's last_restored holds the restored state: let both
        # go, so 13b starts on an empty card
        del params_fsdp, params_zero, mgr
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            out["13b_held_before_gb"] = torch.cuda.memory_allocated() / 1e9
        dist.barrier()

        # 13b: the big model on fsdp over every card, fed by
        # sharded_dataset: AdamW on four cards or more, else the factored
        # optimizer (the one-card mesh holds the 8B as phase 9c does)
        big = config(s["big"])
        use_adamw = n >= 4
        opt = adamw if use_adamw else training.memory_efficient_optimizer(
            warmup_steps=1, total_steps=10)
        rows = s["big_rows_per_rank"] * n
        t = time.perf_counter()
        state, step = training.make_trainer(
            big, llama, optimizer=opt, device=dev, mesh=fsdp,
            generator=torch.Generator(device=dev).manual_seed(14))
        sync()
        out["13b_init_s"] = time.perf_counter() - t
        n_params = sum(p.numel() for _, p in
                       training.train_step.leaves(state["params"]))
        corpus = np.random.default_rng(15).integers(
            0, big.vocab_size, rows * (s["seq"] + 1) * 8, dtype=np.int64)
        batches = training.sharded_dataset(corpus, rows, s["seq"], fsdp,
                                           seed=16)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        # three steps timed, a fourth under torch.profiler (on the card)
        losses, ms, counts, profile = [], [], [], None
        try:
            for i in range(4 if on_card else 3):
                batch = next(batches)
                batch.pop(training.STATE_KEY)
                launches.reset_launch_counts()
                sync()
                t = time.perf_counter()
                if i == 3:
                    (state, m), profile = profiled(
                        torch, lambda: step(state, batch))
                else:
                    state, m = step(state, batch)
                losses.append(m["loss"].item())
                sync()
                if i < 3:
                    ms.append((time.perf_counter() - t) * 1e3)
                counts.append(dict(launches.LAUNCHES))
        finally:
            batches.close()
        median = statistics.median(ms[1:])
        fpt = training.flops_per_token_dense(n_params, big.n_layers,
                                             big.dim, s["seq"])
        peak = training.peak_tflops(out["device"])
        tokens_per_s = rows * s["seq"] / median * 1e3
        out["13b"] = {
            "optimizer": "adamw" if use_adamw else "factored",
            "mesh": dict(fsdp.shape), "tokens": [rows, s["seq"] + 1],
            "params": n_params, "layers": big.n_layers,
            "losses": losses, "step_ms": ms, "median_step_ms": median,
            "tokens_per_s": tokens_per_s,
            "mfu": tokens_per_s * fpt / (n * peak * 1e12) if peak else None,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if on_card else None),
            "launches": counts, "profile": profile,
            "checkpoint": big_checkpoint(state, len(losses), big, opt, fsdp,
                                         s, dev) if use_adamw else None}
        del state, step
        dist.barrier()
        self.result = out
        self.next(self.join)

    @step
    def join(self, inputs):
        self.ranks = sorted((inp.result for inp in inputs),
                            key=lambda r: r["rank"])
        self.next(self.end)

    @step
    def end(self):
        pass


def big_checkpoint(state, step, cfg, opt, mesh, s, dev):
    """The 8B AdamW state saved sharded (rank 0 gathers and writes the
    whole tree) and restored by make_trainer(checkpoint=) onto the same
    mesh, one leaf at a time; each rank's blocks held to the live state's
    bit for bit. Rank 0 decides, for every rank, whether the host and the
    disk have room: the host for three copies of the state on rank 0 (the
    pinned snapshot, the serialized blob and its packed copy), the disk
    for one."""
    import resource
    import shutil
    import time

    import torch
    import torch.distributed as dist

    from metaflow_tpu_torch import training
    from metaflow_tpu_torch.datastore import LocalFlowDataStore
    from metaflow_tpu_torch.models import llama

    leaves = training.train_step.leaves
    state_gb = sum(t.numel() * t.element_size() for _, t in leaves(state)
                   if isinstance(t, torch.Tensor)) / 1e9
    os.makedirs(s["checkpoint_dir"], exist_ok=True)
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) for line in f
                     if line.startswith("MemAvailable:")) / 1e6
    out = {"state_gb": state_gb,
           "need_host_gb": 3 * state_gb, "need_disk_gb": 1.1 * state_gb,
           "host_available_gb": avail,
           "disk_free_gb": shutil.disk_usage(s["checkpoint_dir"]).free / 1e9}
    go = torch.tensor([float(avail >= out["need_host_gb"] and
                             out["disk_free_gb"] >= out["need_disk_gb"])],
                      device=dev)
    dist.broadcast(go, 0)
    out["ran"] = bool(go.item())
    if not out["ran"]:
        return out
    on_card = dev == "cuda"
    mgr = training.AsyncCheckpointManager(
        LocalFlowDataStore("MeshTrainFlow", s["checkpoint_dir"]), name="big")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    mgr.save(state, step)
    out["save_blocked_s"] = time.perf_counter() - t
    mgr.wait()
    out["save_s"] = time.perf_counter() - t
    t = time.perf_counter()
    restored, _ = training.make_trainer(
        cfg, llama, optimizer=opt, device=dev, mesh=mesh, checkpoint=mgr,
        generator=torch.Generator(device=dev).manual_seed(99))
    if on_card:
        torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if on_card
                      else None)
    out["host_rss_peak_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6
    local = lambda t: t.to_local() if hasattr(t, "to_local") else t
    pairs = list(zip(leaves(state), leaves(restored)))
    out["equal"] = all(
        pa == pb and (torch.equal(local(a), local(b))
                      if isinstance(a, torch.Tensor) else a == b)
        for (pa, a), (pb, b) in pairs)
    del restored, mgr
    return out


def dtensors(tree):
    """The DTensor leaves of a state."""
    for value in tree.values():
        if isinstance(value, dict):
            yield from dtensors(value)
        elif hasattr(value, "to_local"):
            yield value


if __name__ == "__main__":
    MeshTrainFlow()
'''

# 13a-13c at the sizes the card runs them (MESH_FLOW's settings)
MESH_SETTINGS = {"small": {"base": "bench_1b", "n_layers": 2,
                           "dtype": "float32"},
                 "small_rows": 8, "small_seq": 1024,
                 "big": {"base": "llama3_8b"}, "big_rows_per_rank": 4,
                 "seq": 2048}


def run_mesh_flow(tmp, settings, timeout_s=900):
    """`python mesh_flow.py run` in `tmp` with `settings` (MESH_FLOW's),
    its datastore under tmp; returns (run id, wall seconds, each rank's
    result in rank order)."""
    import inspect

    flow_file = os.path.join(tmp, "mesh_flow.py")
    helpers = "import time\n\nKERNEL_GROUPS = %r\n\n\n%s" % (
        KERNEL_GROUPS, "\n\n".join(inspect.getsource(fn) for fn in (
            profiled, device_spans, covered_ms, params_digest)))
    with open(flow_file, "w") as f:
        f.write(MESH_FLOW.replace("PARAMS_DIGEST", helpers))
    root = os.path.join(tmp, "tpuflow")
    env = dict(os.environ, PYTHONPATH=HERE,
               TPUFLOW_DATASTORE_SYSROOT_LOCAL=root,
               CHIP_SMOKE_MESH=json.dumps(settings))
    out = os.path.join(tmp, "mesh_run.log")
    t = time.perf_counter()
    with open(out, "w") as f:
        rc = subprocess.run([sys.executable, flow_file, "run"], cwd=tmp,
                            env=env, stdout=f, stderr=subprocess.STDOUT,
                            timeout=timeout_s).returncode
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError("phase 13: mesh_flow.py run exited %d:\n%s"
                             % (rc, _tail(out, 80)))
    from metaflow_tpu_torch import client

    with _datastore_root(root):
        client.namespace(None)
        run = client.Flow("MeshTrainFlow").latest_run
        if not run.successful:
            raise AssertionError("phase 13: run %s not successful:\n%s"
                                 % (run.id, _tail(out, 80)))
        return run.id, wall, run["join"].task.data.ranks


def check_mesh_run(ranks, settings):
    """Phase 13's checks on every rank's result; raises on the first
    failure."""
    n = settings["ranks"]
    n_layers = ranks[0]["13b"]["layers"]
    if [r["rank"] for r in ranks] != list(range(n)) or \
            any(r["world"] != n for r in ranks):
        raise AssertionError("phase 13: ranks %s, expected %d of a world "
                             "of %d" % ([(r["rank"], r["world"])
                                         for r in ranks], n, n))
    for name in ("fsdp", "data_zero"):
        if len({json.dumps(r["13a_runs"][name]) for r in ranks}) != 1:
            raise AssertionError("phase 13a: the ranks' %s losses differ: %s"
                                 % (name, [r["13a_runs"][name]
                                           for r in ranks]))
        c = ranks[0]["13a_%s_vs_one_card" % name]
        # f32: losses and grad norms as tests/test_torch_optim.py's
        # STEP_REL, weights as tests/test_torch_mesh.py's f32 rule
        if not (c["loss_rel"] <= 1e-4 and c["grad_norm_rel"] <= 1e-4 and
                c["share_off_1e-5"] <= 1e-3 and c["max_abs"] <= c["bound"]):
            raise AssertionError("phase 13a: %s on %s against one card: %s"
                                 % (name, ranks[0]["%s_mesh" % name.split(
                                     "_")[0]], c))
    if n > 1 and ranks[0]["13a_zero_state_share"] > 1.0 / n + 1e-3:
        raise AssertionError("phase 13a: each rank holds %.4f of the ZeRO "
                             "optimizer state, not 1/%d"
                             % (ranks[0]["13a_zero_state_share"], n))
    if not all(r["13c_digest_equal"] for r in ranks):
        raise AssertionError("phase 13c: the restored state's digest is not "
                             "the saved one's on ranks %s"
                             % [r["rank"] for r in ranks
                                if not r["13c_digest_equal"]])
    big = [r["13b"] for r in ranks]
    if len({json.dumps(b["losses"]) for b in big}) != 1 or \
            not all(x == x and abs(x) < 1e4 for x in big[0]["losses"]):
        raise AssertionError("phase 13b: losses %s" % [b["losses"]
                                                       for b in big])
    if settings["device"] == "cuda":
        want = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
                "flash_bwd_dkv": n_layers, "flash_block_fwd": 0,
                "gmm_fwd": 0, "gmm_dw": 0}
        for r, b in zip(ranks, big):
            if any(c != want for c in b["launches"]):
                raise AssertionError("phase 13b: rank %d launched %s a "
                                     "step, expected %s"
                                     % (r["rank"], b["launches"], want))
            if not b["peak_gb"] < 80:
                raise AssertionError("phase 13b: rank %d peaked at %.2f GB"
                                     % (r["rank"], b["peak_gb"]))
    bad = [r["rank"] for r, b in zip(ranks, big) if b["checkpoint"] and
           b["checkpoint"]["ran"] and not b["checkpoint"]["equal"]]
    if bad:
        raise AssertionError("phase 13b: the blocks of the restored 8B "
                             "state differ from the saved ones on ranks %s"
                             % bad)


def phase13_mesh_flow(torch):
    """A user's flow whose gang step trains on a mesh of every card."""
    import shutil

    # this process holds a CUDA context and the allocator's cached blocks
    # on card 0, where rank 0 runs: the blocks go back to the card here
    _free(torch)
    held = (torch.cuda.memory_allocated(0) / 1e9,
            torch.cuda.memory_reserved(0) / 1e9)
    log("phase 13: before the gang this process holds %.3f GB allocated, "
        "%.3f GB reserved on card 0 (its CUDA context stays)" % held)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    log("phase 13: %d cards: %s" % (len(cards), "; ".join(cards)))
    n = torch.cuda.device_count()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        settings = dict(MESH_SETTINGS, ranks=n, device="cuda",
                        checkpoint_dir=os.path.join(tmp, "ckpt"))
        run_id, wall, ranks = run_mesh_flow(tmp, settings)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    small = {k: r0["13a_%s_vs_one_card" % k] for k in ("fsdp", "data_zero")}
    ROWS["13a"] = {"phase": "13a", "ranks": n, "run_wall_s": wall,
                   "fsdp_loss_rel": small["fsdp"]["loss_rel"],
                   "fsdp_max_abs": small["fsdp"]["max_abs"],
                   "zero_loss_rel": small["data_zero"]["loss_rel"],
                   "zero_max_abs": small["data_zero"]["max_abs"],
                   "bound": small["fsdp"]["bound"],
                   "zero_state_share": r0["13a_zero_state_share"],
                   "fsdp_s": r0["13a_fsdp_s"],
                   "zero_s": r0["13a_data_zero_s"], "detail": small,
                   "losses": r0["13a_runs"]}
    big = [r["13b"] for r in ranks]
    ROWS["13b"] = {"phase": "13b", "optimizer": big[0]["optimizer"],
                   "mesh": json.dumps(big[0]["mesh"]),
                   "median_step_ms": big[0]["median_step_ms"],
                   "tokens_per_s": big[0]["tokens_per_s"],
                   "mfu": big[0]["mfu"],
                   "peak_gb_max": max(b["peak_gb"] for b in big),
                   "init_s": r0["13b_init_s"], "params": big[0]["params"],
                   "held_before_gb": [r.get("13b_held_before_gb")
                                      for r in ranks],
                   "tokens": big[0]["tokens"],
                   "peak_gb": [b["peak_gb"] for b in big],
                   "step_ms": [b["step_ms"] for b in big],
                   "losses": big[0]["losses"],
                   "launches": big[0]["launches"][-1],
                   "profile_step_3": [b["profile"] for b in big],
                   "checkpoint": [b["checkpoint"] for b in big]}
    ck = big[0]["checkpoint"]
    ROWS["13b.ckpt"] = {"phase": "13b.ckpt", "ran": bool(ck and ck["ran"])}
    if ck:
        ROWS["13b.ckpt"].update(
            (k, ck[k]) for k in ("state_gb", "save_s", "save_blocked_s",
                                 "restore_s", "peak_gb", "equal",
                                 "host_available_gb", "disk_free_gb")
            if k in ck)
        ROWS["13b.ckpt"]["host_rss_peak_gb"] = [
            b["checkpoint"].get("host_rss_peak_gb") for b in big]
    else:
        ROWS["13b.ckpt"]["why"] = "one card: the factored 8B"
    ROWS["13c"] = {"phase": "13c", "digest_equal": True,
                   "restored_onto": json.dumps(r0["13c_restored_onto"]),
                   "save_s": r0["13c_save_s"],
                   "restore_s": r0["13c_restore_s"],
                   "digest": r0["13c_digest"]}
    for key in ("13a", "13b", "13b.ckpt", "13c"):
        log(json.dumps(ROWS[key]))
    check_mesh_run(ranks, settings)
    b = ROWS["13b"]
    log("phase 13: MeshTrainFlow/%s, %d ranks, %.1fs of wall time; 13b "
        "Llama-3-8B %s on %s, tokens %s: %.1f ms a step, %.0f tokens/s, MFU "
        "%.4f, peak %s GB, K1/K2/K3 %s a step per rank; 13a fsdp and ZeRO "
        "within %s of one card; 13c digest equal" % (
            run_id, n, wall, b["optimizer"], b["mesh"], b["tokens"],
            b["median_step_ms"], b["tokens_per_s"], b["mfu"],
            ["%.2f" % x for x in b["peak_gb"]],
            [(c["flash_fwd"], c["flash_bwd_dq"], c["flash_bwd_dkv"])
             for c in big[0]["launches"]],
            {k: "%.3g" % v["max_abs"] for k, v in small.items()}))
    prof = big[0]["profile"]
    if prof:
        log("phase 13b: rank 0's step 3 under torch.profiler: %.1f ms of "
            "wall, %.1f ms of kernels (all streams), by group %s; on the "
            "timeline the card was busy %.1f ms, NCCL's kernels ran %.1f "
            "ms, %.1f ms of it beside other work"
            % (prof["wall_ms"], prof["device_ms"],
               {k: round(v, 1) for k, v in sorted(
                   prof["by_group_ms"].items(), key=lambda kv: -kv[1])},
               prof["busy_ms"], prof["nccl_ms"],
               prof["nccl_beside_other_ms"]))
        ROWS["13b.timeline"] = {
            "phase": "13b.timeline", "wall_ms": prof["wall_ms"],
            "busy_ms": prof["busy_ms"], "kernel_sum_ms": prof["device_ms"],
            "nccl_ms": prof["nccl_ms"],
            "nccl_beside_other_ms": prof["nccl_beside_other_ms"]}
    return ROWS["13b"]


def summary_lines(done, failed=None):
    """One compact line (at most 200 bytes) per logged phase row: its
    pass result and its headline numbers, printed at the end where the
    tail of the output keeps them."""
    out = []
    for key, row in ROWS.items():
        group = key.split(".")[0].rstrip("abcde")
        state = "ok" if group in done else (
            "FAILED" if group == failed else "partial")
        text = "SUMMARY %s %s" % (key, state)
        keys = [k for k in HEADLINES if k in row] + [
            k for k in row if k not in HEADLINES]
        for k in keys:
            v = row[k]
            if k == "phase" or isinstance(v, (dict, list)) or v is None:
                continue
            if isinstance(v, float):
                v = "%.5g" % v
            elif isinstance(v, str) and len(v) > 16:
                continue
            item = " %s=%s" % (k, v)
            if len(text) + len(item) > 200:
                break
            text += item
        out.append(text)
    return out


def main(argv=None):
    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    baseline_root, selected = None, set(ALL_PHASES)
    usage = "usage: chip_smoke.py [--baseline CHECKOUT] [--phases 0,3,10]"
    while args:
        flag = args.pop(0)
        if flag in ("--baseline", "--phases") and args:
            value = args.pop(0)
            if flag == "--baseline":
                baseline_root = value
            else:
                selected = {x.strip() for x in value.split(",")
                            if x.strip()} - {"0"}
                if not selected <= set(ALL_PHASES):
                    print(usage, file=sys.stderr)
                    return 2
        else:
            print(usage, file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "metaflow_tpu_torch")):
        print("chip_smoke: the metaflow_tpu_torch package is missing",
              file=sys.stderr)
        return 2
    done, current = [], ["0"]
    try:
        return run_phases(torch, baseline_root, selected, done, current)
    except BaseException as ex:
        for line in summary_lines(done, failed=current[0]):
            log(line)
        log("SUMMARY %s FAILED: %s" % (
            current[0], (str(ex).splitlines() or [repr(ex)])[0][:160]))
        raise


def run_phases(torch, baseline_root, selected, done, current):
    sys.path.insert(0, HERE)
    from metaflow_tpu_torch import serving, training
    from metaflow_tpu_torch.inference import decode
    from metaflow_tpu_torch.models import llama, mixtral
    from metaflow_tpu_torch.ops import KERNELS, _build
    from metaflow_tpu_torch.ops import fault_check as FC
    from metaflow_tpu_torch.serving import engine as engine_mod
    from metaflow_tpu_torch.training.train_step import leaves

    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    L = importlib.import_module("metaflow_tpu_torch.ops.launches")
    G = importlib.import_module("metaflow_tpu_torch.ops.gmm")
    M = importlib.import_module("metaflow_tpu_torch.ops.moe")
    R = importlib.import_module("metaflow_tpu_torch.ops.ring_attention")
    start = time.perf_counter()

    def begin(phase):
        current[0] = phase
        return phase in selected

    def end(phase, label=None):
        done.append(phase)
        log("phase %s done at %.1fs" % (label or phase,
                                        time.perf_counter() - start))

    # phase 0: the card, the builds, the numerics settings
    card = card_line()
    log("card: %s" % card)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))
    log("phases: 0,%s" % ",".join(p for p in ALL_PHASES if p in selected))
    sources = sorted({k["source"].split("/")[-1][:-3] for k in KERNELS
                      if k.get("source")})
    t = time.perf_counter()
    jobs = _build.start_builds(sources)  # one nvcc per source, together
    if baseline_root is not None:  # the earlier K2-K4, K6: phases 4, 6, 8a
        jobs += _build.start_builds(
            BASELINE_SOURCES, csrc=_baseline_csrc(baseline_root),
            build_dir=_build.BUILD_DIR / "baseline")
    _build.finish_builds(jobs)
    log("kernel builds: %.1fs for %s%s" % (
        time.perf_counter() - t, sources,
        "" if baseline_root is None
        else " and the earlier %s of %s" % (list(BASELINE_SOURCES),
                                            baseline_root)))
    baseline = {} if baseline_root is None else {
        name: baseline_library(_build, baseline_root, name)
        for name in BASELINE_SOURCES}
    for name in sources:
        info = _build.build_info(name)
        log("%s: %s in %.1fs (%s)" % (
            name, "built" if info["built"] else "loaded", info["seconds"],
            os.path.relpath(info["path"], HERE)))
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    for line in wgmma_kernel_report(_build):
        log(line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("allow_tf32: matmul=%s cudnn=%s" % (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32))
    ROWS["0"] = {"kernel_build_s": time.perf_counter() - t,
                 "sources": len(sources)}
    end("0")

    inference = records = train_launches = gmm_records = None
    moe_launches = block_records = ring_launches = None
    prefill_launches = factored = flagship = fwd_launches = None
    if begin("1"):
        inference = phase1_kernel_vs_plain(A, FC, torch)
        ROWS["1"] = inference
        end("1")
    params = None
    if begin("2"):
        params, fwd_launches = phase2_forward(torch, llama, A, L)
        end("2")
    if begin("3"):
        if params is None:
            params = llama.init_params(
                llama.LlamaConfig.llama3_8b(),
                torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
        phase3_serve(torch, llama, decode, engine_mod, params)
        end("3")
    del params  # the 8B weights: phases 4 and 5 need the memory
    _free(torch)
    if begin("4"):
        records = phase4_backward(A, torch, baseline.get("flash_bwd"))
        end("4")
    if begin("5"):
        phase5a_exact_grads(torch, llama, A, L, leaves)
        log("phase 5a done at %.1fs" % (time.perf_counter() - start))
        train_launches = phase5b_train(torch, llama, A, L, training)
        end("5", "5b")
        _free(torch)  # bench_1b's state: the Mixtral phases need the memory
    if begin("6"):
        gmm_records = phase6_gmm(torch, G, FC, baseline.get("gmm"))
        end("6")
    if begin("7"):
        phase7a_exact_grads(torch, mixtral, L, G, M, leaves)
        _free(torch)
        log("phase 7a done at %.1fs" % (time.perf_counter() - start))
        moe_launches, _, moe_params, moe_cfg = phase7b_train(
            torch, mixtral, L, G, FC, training)
        log("phase 7b done at %.1fs" % (time.perf_counter() - start))
        phase7c_generate(torch, decode, moe_params, moe_cfg)
        end("7", "7c")
        del moe_params  # the Mixtral weights: the ring phases need memory
        _free(torch)
    if begin("8"):
        block_records = phase8a_block_fwd(A, FC, torch,
                                          baseline.get("flash_fwd"))
        log("phase 8a done at %.1fs" % (time.perf_counter() - start))
        phase8b_ring_vs_flash(A, R, L, torch)
        log("phase 8b done at %.1fs" % (time.perf_counter() - start))
        phase8c_ring_exact_grads(torch, llama, R, L, leaves)
        _free(torch)
        log("phase 8c done at %.1fs" % (time.perf_counter() - start))
        ring_launches, _ = phase8d_train_ring(torch, llama, A, R, L,
                                              training)
        _free(torch)  # bench_1b's state: the 8B prefill needs the memory
        log("phase 8d done at %.1fs" % (time.perf_counter() - start))
        prefill_launches, _ = phase8e_prefill_ring(torch, llama, A, R, L)
        end("8", "8e")
        _free(torch)
    if begin("9"):
        factored = phase9a_factored_policies(torch, llama, L, training)
        log("phase 9a done at %.1fs" % (time.perf_counter() - start))
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
            phase9b_resume(torch, llama, L, training, tmp)
        log("phase 9b done at %.1fs" % (time.perf_counter() - start))
        flagship = phase9c_llama3_8b(torch, llama, A, L, training)
        end("9", "9c")
    if begin("10"):
        phase10a_exact(torch, llama, decode, serving)
        log("phase 10a done at %.1fs" % (time.perf_counter() - start))
        slot = ROWS.get("3b")
        phase10b_serve_8b(torch, llama, L, slot_result=None if
                          slot is None else {
                              k: slot[k] for k in (
                                  "requests", "ttft_p50_s",
                                  "decode_tokens_per_s", "wall_s",
                                  "peak_mem_gb")})
        end("10", "10b")
    if begin("11"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
            phase11a_stream_telemetry(torch, llama, L, training, tmp)
            log("phase 11a done at %.1fs" % (time.perf_counter() - start))
            phase11b_timed_update(torch, llama, training, tmp)
            log("phase 11b done at %.1fs" % (time.perf_counter() - start))
        phase11c_ulysses(torch, llama, A, R, L, training)
        end("11", "11c")
    flow = mesh = None
    if begin("12"):
        flow = phase12_flow(torch, flagship)
        end("12")
    if begin("13"):
        mesh = phase13_mesh_flow(torch)
        end("13")
    current[0] = "report"

    # the kernel report needs every phase that times or counts a kernel;
    # a run of some phases reports each kernel with its numbers null
    every_phase = all(p in selected for p in ("1", "2", "4", "5", "6", "7",
                                              "8", "9"))
    ported, not_yet = [], []
    for k in KERNELS:
        if k.get("source") is None:
            not_yet.append({"name": k["name"], "replaces": k["replaces"],
                            "status": "not yet ported"})
            continue
        line = {"name": k["name"], "route": k["route"],
                "source": k["source"], "replaces": k["replaces"],
                "status": "ported"}
        if flow is not None:  # the flow's train task (phase 12a), a step
            line["launches_flow_train_task"] = flow["launches"][k["name"]]
        if mesh is not None:  # a rank of the gang's mesh step (13b)
            line["launches_mesh_step_per_rank"] = \
                mesh["launches"][k["name"]]
        if not every_phase:
            line.update(launches=None, max_abs_err=None, ms=None,
                        plain_ms=None, bound_ms=None, bound_by=None,
                        library_ms=None,
                        note="not measured: this run drove phases 0,%s"
                        % ",".join(p for p in ALL_PHASES if p in selected))
            ported.append(line)
            continue
        if k["name"] == "flash_block_fwd":
            diag, full = block_records["diag"], block_records["full"]
            line.update(
                launches=ring_launches["flash_block_fwd"],
                max_abs_err=max(diag["max_abs_err"], full["max_abs_err"]),
                ms=diag["ms"], plain_ms=diag["plain_ms"],
                bound_ms=diag["bound_ms"], bound_by=diag["bound_by"],
                library_ms=diag["library_ms"],
                library="SDPA flash forward with its lse, kv heads repeated",
                shape="ring hop B, S, H, KV, D = %s bf16, diagonal (acc f32)"
                      % (RING_HOP,),
                full_ms=full["ms"], full_plain_ms=full["plain_ms"],
                full_bound_ms=full["bound_ms"],
                full_library_ms=full["library_ms"],
                launches_llama3_8b_8k_prefill=prefill_launches[
                    "flash_block_fwd"])
            if "old_new" in diag:
                line.update(
                    earlier_build_ms=diag["old_new"]["old_ms"],
                    in_turns_ms=diag["old_new"]["new_ms"],
                    full_earlier_build_ms=full["old_new"]["old_ms"],
                    full_in_turns_ms=full["old_new"]["new_ms"])
            ported.append(line)
            continue
        if k["name"].startswith("gmm"):
            up, down = gmm_records["gate_up"], gmm_records["down"]
            shape = ("16384 routed rows (17408 padded) in 8 groups, "
                     "D 4096, F 14336, bf16")
            if k["name"] == "gmm_fwd":
                line.update(
                    launches=moe_launches["gmm_fwd"],
                    max_abs_err=up["max_abs_err"], ms=up["ms"],
                    plain_ms=up["plain_ms"], bound_ms=up["bound_ms"],
                    bound_by=up["bound_by"], library_ms=up["library_ms"],
                    library=up["library"], shape="gate/up forward: " + shape,
                    down_ms=down["ms"], down_bound_ms=down["bound_ms"],
                    dx_ms=up["dx_ms"], dx_bound_ms=up["dx_bound_ms"],
                    down_dx_ms=down["dx_ms"],
                    down_dx_bound_ms=down["dx_bound_ms"],
                    library_down_ms=down["library_ms"],
                    library_dx_ms=up["library_dx_ms"],
                    library_down_dx_ms=down["library_dx_ms"])
            else:
                skewed = gmm_records["skewed"]
                line.update(
                    launches=moe_launches["gmm_dw"],
                    max_abs_err=up["max_abs_err_dw"], ms=up["dw_ms"],
                    plain_ms=up["plain_dw_ms"], bound_ms=up["dw_bound_ms"],
                    bound_by=up["dw_bound_by"],
                    library_ms=up["library_dw_ms"],
                    library=up["library"] + ", bf16 out as K6's",
                    shape="dw of the gate/up weights, bf16 out: " + shape,
                    f32_out_ms=up["dw_f32_ms"],
                    f32_out_bound_ms=up["dw_f32_bound_ms"],
                    library_f32_out_ms=up["library_dw_f32_ms"],
                    down_ms=down["dw_ms"],
                    down_bound_ms=down["dw_bound_ms"],
                    library_down_ms=down["library_dw_ms"],
                    skewed_ms=skewed["dw_ms"],
                    skewed_bound_ms=skewed["dw_bound_ms"],
                    library_skewed_ms=skewed["library_dw_ms"])
                if "dw_old_new" in up:
                    line.update(
                        earlier_build_ms=up["dw_old_new"]["old_ms"],
                        in_turns_ms=up["dw_old_new"]["new_ms"],
                        earlier_build_f32_out_ms=up["dw_f32_old_new"][
                            "old_ms"])
            ported.append(line)
            continue
        rec = records[k["name"]]
        line["launches_bench_1b_factored_step"] = {
            str(policy): r["steps"][-1]["launches"][k["name"]]
            for policy, r in factored.items()}
        line["launches_llama3_8b_step"] = \
            flagship["steps"][-1]["launches"][k["name"]]
        line.update(launches=train_launches[k["name"]],
                    max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                    plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
                    bound_by=rec["bound_by"], library_ms=rec["library_ms"],
                    shape="B, S, H, KV, D = %s bf16 causal" % (TRAIN_SHAPE,))
        if k["name"] == "flash_fwd":
            line["inference_shape"] = {
                "shape": "B, S, H, KV, D = (2, 2048, 32, 8, 128) bf16 "
                         "causal",
                "launches_llama3_8b_forward": fwd_launches["flash_fwd"],
                "max_abs_err": inference["max_abs_err_o"],
                "ms": inference["ms"], "plain_ms": inference["plain_ms"],
                "bound_ms": inference["bound_ms"],
                "library_ms": inference["library_ms"],
                "library": "SDPA forward, %s backend (the fastest of %s)" % (
                    inference["library"],
                    inference["library_by_backend_ms"])}
            line["library"] = "SDPA forward, %s backend (the fastest of %s)" \
                % (rec["library"], rec["library_by_backend_ms"])
        else:
            line["library"] = (
                "SDPA backward (dq, dk, dv together), %s backend (the "
                "fastest of %s)" % (rec["library"],
                                    rec["library_by_backend_ms"]))
            line["plain"] = "the plain backward: dq, dk, dv together"
            line["launches_ring_8k_step"] = ring_launches[k["name"]] // 5
            if "old_new" in rec:
                line["earlier_build_ms"] = rec["old_new"]["old_ms"]
                line["in_turns_ms"] = rec["old_new"]["new_ms"]
        ported.append(line)
    log(json.dumps({"kernels": ported, "not_yet_ported": not_yet}))
    for line in summary_lines(done):
        log(line)
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
