#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--baseline CHECKOUT]

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

Every run drives every phase, and every phase asserts; the script exits
non-zero on the first failure, when no CUDA device is present, or when the
port's package is missing. Its last lines are the kernel report and
{"ok": true, "device": {...}}.
"""

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, bf16
H100_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12    # HBM3


def log(msg):
    print(msg, flush=True)


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
    log(json.dumps(result))
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
    log(json.dumps({"phase": "3a", "requests": len(reqs),
                    "token_identical": True}))
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
    log(json.dumps(result))


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
            log(json.dumps(row))
            raise AssertionError("K2/K3 disagree with their plain version: "
                                 "%s" % json.dumps(row))
        if (B, S, H, KV, D) == TRAIN_SHAPE:
            records = _time_training_shape(A, torch, F, q, k, v, g, out, lse,
                                           delta, row, baseline)
        log(json.dumps(row))
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
    log(json.dumps(result))
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
    log(json.dumps(result))
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
            log(json.dumps(row))
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
        log(json.dumps(row))
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
    log(json.dumps(result))
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
        if us and getattr(ev, "device_type", None) is not None and \
                str(ev.device_type).endswith("CUDA"):
            kernels[ev.key] = kernels.get(ev.key, 0.0) + us / 1e3
    buckets = {}
    for name, ms in kernels.items():
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        buckets[group] = buckets.get(group, 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return result, {"wall_ms": wall, "device_ms": sum(kernels.values()),
                    "by_group_ms": buckets,
                    "top_kernels_ms": [[k[:90], v] for k, v in top]}


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
    log(json.dumps(result))
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
    log(json.dumps(result))
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
            log(json.dumps(row))
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
        log(json.dumps(row))
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
        log(json.dumps(row))
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
    log(json.dumps(result))
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
    log(json.dumps(result))
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
    log(json.dumps(result))
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


def main(argv=None):
    import torch

    args = list(sys.argv[1:] if argv is None else argv)
    baseline_root = None
    if args[:1] == ["--baseline"] and len(args) == 2:
        baseline_root = args[1]
    elif args:
        print("usage: chip_smoke.py [--baseline CHECKOUT]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "metaflow_tpu_torch")):
        print("chip_smoke: the metaflow_tpu_torch package is missing",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from metaflow_tpu_torch import training
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

    # phase 0: the card, the builds, the numerics settings
    card = card_line()
    log("card: %s" % card)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))
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
    log("phase 0 done at %.1fs" % (time.perf_counter() - start))

    inference = phase1_kernel_vs_plain(A, FC, torch)
    log("phase 1 done at %.1fs" % (time.perf_counter() - start))
    params, fwd_launches = phase2_forward(torch, llama, A, L)
    log("phase 2 done at %.1fs" % (time.perf_counter() - start))
    phase3_serve(torch, llama, decode, engine_mod, params)
    log("phase 3 done at %.1fs" % (time.perf_counter() - start))
    del params  # the 8B weights: phases 4 and 5 need the memory
    gc.collect()
    torch.cuda.empty_cache()
    records = phase4_backward(A, torch, baseline.get("flash_bwd"))
    log("phase 4 done at %.1fs" % (time.perf_counter() - start))
    phase5a_exact_grads(torch, llama, A, L, leaves)
    log("phase 5a done at %.1fs" % (time.perf_counter() - start))
    train_launches = phase5b_train(torch, llama, A, L, training)
    log("phase 5b done at %.1fs" % (time.perf_counter() - start))
    gc.collect()  # bench_1b's state: the Mixtral phases need the memory
    torch.cuda.empty_cache()
    gmm_records = phase6_gmm(torch, G, FC, baseline.get("gmm"))
    log("phase 6 done at %.1fs" % (time.perf_counter() - start))
    phase7a_exact_grads(torch, mixtral, L, G, M, leaves)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 7a done at %.1fs" % (time.perf_counter() - start))
    moe_launches, _, moe_params, moe_cfg = phase7b_train(
        torch, mixtral, L, G, FC, training)
    log("phase 7b done at %.1fs" % (time.perf_counter() - start))
    phase7c_generate(torch, decode, moe_params, moe_cfg)
    log("phase 7c done at %.1fs" % (time.perf_counter() - start))
    del moe_params  # the Mixtral weights: the ring phases need the memory
    gc.collect()
    torch.cuda.empty_cache()
    block_records = phase8a_block_fwd(A, FC, torch, baseline.get("flash_fwd"))
    log("phase 8a done at %.1fs" % (time.perf_counter() - start))
    phase8b_ring_vs_flash(A, R, L, torch)
    log("phase 8b done at %.1fs" % (time.perf_counter() - start))
    phase8c_ring_exact_grads(torch, llama, R, L, leaves)
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 8c done at %.1fs" % (time.perf_counter() - start))
    ring_launches, _ = phase8d_train_ring(torch, llama, A, R, L, training)
    gc.collect()  # bench_1b's state: the 8B prefill needs the memory
    torch.cuda.empty_cache()
    log("phase 8d done at %.1fs" % (time.perf_counter() - start))
    prefill_launches, _ = phase8e_prefill_ring(torch, llama, A, R, L)
    log("phase 8e done at %.1fs" % (time.perf_counter() - start))

    # one line per kernel: the flash kernels' launches in the bench_1b run
    # (phase 5b) and times at its training shape (phase 4), K1 also at the
    # inference shape (phases 1, 2), K2 and K3 also their launches in the
    # 8k ring run (phase 8d); K4's launches in the 8k ring run (phase 8d)
    # and times at its diagonal hop (phase 8a), with the full hop beside
    # them; K5 and K6's launches in the Mixtral run (phase 7b) and times at
    # its gate/up shape (phase 6), with the down shape and K5's dx beside
    # them
    ported, not_yet = [], []
    for k in KERNELS:
        if k.get("source") is None:
            not_yet.append({"name": k["name"], "replaces": k["replaces"],
                            "status": "not yet ported"})
            continue
        line = {"name": k["name"], "route": k["route"],
                "source": k["source"], "replaces": k["replaces"],
                "status": "ported"}
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
    log(card_line())
    log(json.dumps({"kernels": ported, "not_yet_ported": not_yet}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
