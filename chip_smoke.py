#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phase 0  prints the card's name and power limit, builds the flash kernels
         (K1 forward, K2/K3 backward) from metaflow_tpu_torch/ops/csrc with
         one nvcc per source started together, and turns TF32 off.
Phase 1  holds K1 against its plain PyTorch version at four shapes, the
         inference shape last, and times K1, the plain version and
         PyTorch's scaled_dot_product_attention (a yardstick only: the port
         never calls it) at the inference shape.
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
         versions and SDPA's forward and backward at the training shape.
Phase 5  trains bench_1b: (a) a 2-layer full-width float32 model's loss
         gradients through K1/K2/K3 must equal the plain-attention ones;
         (b) the full bf16 model takes 5 AdamW steps on tokens [8, 2049],
         each launching K1 32 times and K2, K3 16 times, every K2/K3 launch
         of step 2 held against its plain version, the loss falling from
         step 1 to step 4; prints step ms, tokens/s, MFU and peak memory.

Every run drives every phase, and every phase asserts; the script exits
non-zero on the first failure, when no CUDA device is present, or when the
port's package is missing. Its last lines are the kernel report and
{"ok": true, "device": {...}}.
"""

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


def phase1_kernel_vs_plain(A, torch):
    """K1 against its plain version; returns the main-shape record."""
    import torch.nn.functional as F

    shapes = [  # (B, S, H, KV, D, dtype, causal)
        (1, 128, 4, 4, 64, torch.float32, True),
        (2, 256, 8, 2, 128, torch.bfloat16, True),
        (1, 512, 4, 4, 128, torch.bfloat16, False),
        (2, 2048, 32, 8, 128, torch.bfloat16, True),
    ]
    gen = torch.Generator(device="cuda").manual_seed(1)
    record = None
    for B, S, H, KV, D, dt, causal in shapes:
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, KV, D, generator=gen, device="cuda").to(dt)
        scale = D ** -0.5
        out, lse = A._flash_forward_cuda(q, k, v, causal, scale)
        ref_out, ref_lse = A._flash_forward_plain(q, k, v, causal, scale)
        torch.cuda.synchronize()
        err_o = (out.float() - ref_out.float()).abs().max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        row_err = A.flash_out_error(out, ref_out)
        rel_rms = ((out.float() - ref_out.float()).norm()
                   / ref_out.float().norm()).item()
        if dt == torch.float32:
            # f32 on both sides: the sums differ only in order
            tol_o, tol_lse, row_limit = 1e-5, 1e-5, None
            ok_o = err_o <= tol_o
        else:
            # O row by row against its own magnitude (attention.py,
            # FLASH_BF16_ROW_LIMIT). lse is f32 on both sides, a sum over
            # up to S terms in another order: S * 2^-24 * max|lse|.
            tol_o, row_limit = None, A.FLASH_BF16_ROW_LIMIT
            tol_lse = S * 2.0 ** -24 * ref_lse.abs().max().item() + 1e-6
            ok_o = row_err <= row_limit
        row = {"shape": [B, S, H, KV, D], "dtype": str(dt).split(".")[-1],
               "causal": causal, "max_abs_err_o": err_o,
               "max_abs_err_lse": err_lse, "tol_o": tol_o,
               "row_err": row_err, "row_limit": row_limit,
               "rel_rms_err_o": rel_rms,
               "tol_lse": tol_lse}
        if not (torch.isfinite(out.float()).all() and ok_o
                and err_lse <= tol_lse):
            log(json.dumps(row))
            raise AssertionError("K1 disagrees with its plain version: %s"
                                 % json.dumps(row))
        if (B, S, H, KV, D) == (2, 2048, 32, 8, 128):
            k_rep, v_rep = (A._broadcast_gqa(t, H).transpose(1, 2)
                            .contiguous() for t in (k, v))
            q_t = q.transpose(1, 2).contiguous()
            row["ms"] = cuda_ms(
                lambda: A._flash_forward_cuda(q, k, v, causal, scale), 20)
            row["plain_ms"] = cuda_ms(
                lambda: A._flash_forward_plain(q, k, v, causal, scale), 5)
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q_t, k_rep, v_rep, is_causal=causal), 20)
            row["bound_ms"], row["bound_by"] = bound_ms(
                attention_work("flash_fwd", B, S, H, KV, D, 2, causal),
                tensor_cores=True)
            record = row
            del k_rep, v_rep, q_t
        log(json.dumps(row))
    return record


def phase2_forward(torch, llama, A):
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
        A.reset_launch_counts()
        flash_logits, first_ms = run("auto")
        launches = dict(A.LAUNCHES)
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


def phase4_backward(A, torch):
    """K2 and K3 against their plain version at four shapes, the training
    shape last; at the training shape K1 too, and the times of K1, K2, K3,
    the plain versions and SDPA. Returns {kernel name: record}."""
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
                                           delta, row)
        log(json.dumps(row))
    return records


def _time_training_shape(A, torch, F, q, k, v, g, out, lse, delta, row):
    """K1 held against its plain version at the training shape, then every
    time of the kernel report: each kernel, the plain versions, SDPA."""
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
    # timed as forward + backward minus forward
    q_t, g_t = (t.transpose(1, 2).contiguous() for t in (q, g))
    k_t, v_t = (A._broadcast_gqa(t, H).transpose(1, 2).contiguous()
                for t in (k, v))
    leaves = [t.requires_grad_(True) for t in (q_t, k_t, v_t)]

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(*leaves, is_causal=True)
        torch.autograd.grad(o, leaves, g_t)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(*leaves, is_causal=True)

    sdpa_fwd_ms = cuda_ms(sdpa_fwd, 20)
    sdpa_bwd_ms = cuda_ms(sdpa_fwd_bwd, 20) - sdpa_fwd_ms
    records = {}
    for name in ms:
        work = attention_work(name, B, S, H, KV, D, 2, True)
        bound, by = bound_ms(work, tensor_cores=True)
        records[name] = {
            "ms": ms[name], "bound_ms": bound, "bound_by": by,
            "gflop": work[0] / 1e9, "gbytes": work[1] / 1e9,
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd_ms,
            "max_abs_err": {
                "flash_fwd": fwd_err,
                "flash_bwd_dq": row["max_abs_err_dq"],
                "flash_bwd_dkv": max(row["max_abs_err_dk"],
                                     row["max_abs_err_dv"])}[name]}
        log("phase 4: %s at the training shape: %.4f ms, bound %.4f ms "
            "(%s; %.1f GFLOP, %.3f GB)" % (name, ms[name], bound, by,
                                          work[0] / 1e9, work[1] / 1e9))
    row.update(plain_bwd_ms=plain_bwd, sdpa_fwd_ms=sdpa_fwd_ms,
               sdpa_bwd_ms=sdpa_bwd_ms,
               ms={n: r["ms"] for n, r in records.items()})
    return records


def _leaf_params(torch, params):
    """A copy of a parameter tree whose tensors are leaves requiring
    grad."""
    return {k: _leaf_params(torch, v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def phase5a_exact_grads(torch, llama, A, leaves):
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
        A.reset_launch_counts()
        loss = llama.loss_fn(p, {"tokens": tokens}, c)
        loss.backward()
        torch.cuda.synchronize()
        launches[impl] = dict(A.LAUNCHES)
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
            "flash_bwd_dkv": cfg.n_layers}
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


def phase5b_train(torch, llama, A, training):
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
    A.reset_launch_counts()
    for i in range(5):
        before = dict(A.LAUNCHES)
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
                      "launches": {n: A.LAUNCHES[n] - before[n]
                                   for n in A.LAUNCHES}})
    launches = dict(A.LAUNCHES)
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
            "flash_bwd_dkv": cfg.n_layers}
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


def main():
    import torch

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
    from metaflow_tpu_torch.models import llama
    from metaflow_tpu_torch.ops import KERNELS, _build
    from metaflow_tpu_torch.serving import engine as engine_mod
    from metaflow_tpu_torch.training.train_step import leaves

    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    start = time.perf_counter()

    # phase 0: the card, the builds, the numerics settings
    card = card_line()
    log("card: %s" % card)
    log("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                   torch.cuda.get_device_name(0)))
    sources = sorted({k["source"].split("/")[-1][:-3] for k in KERNELS
                      if k.get("source")})
    t = time.perf_counter()
    _build.build_all(sources)  # one nvcc per source, started together
    log("kernel builds: %.1fs for %s" % (time.perf_counter() - t, sources))
    for name in sources:
        info = _build.build_info(name)
        log("%s: %s in %.1fs (%s)" % (
            name, "built" if info["built"] else "loaded", info["seconds"],
            os.path.relpath(info["path"], HERE)))
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("allow_tf32: matmul=%s cudnn=%s" % (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32))
    log("phase 0 done at %.1fs" % (time.perf_counter() - start))

    inference = phase1_kernel_vs_plain(A, torch)
    log("phase 1 done at %.1fs" % (time.perf_counter() - start))
    params, fwd_launches = phase2_forward(torch, llama, A)
    log("phase 2 done at %.1fs" % (time.perf_counter() - start))
    phase3_serve(torch, llama, decode, engine_mod, params)
    log("phase 3 done at %.1fs" % (time.perf_counter() - start))
    del params  # the 8B weights: phases 4 and 5 need the memory
    gc.collect()
    torch.cuda.empty_cache()
    records = phase4_backward(A, torch)
    log("phase 4 done at %.1fs" % (time.perf_counter() - start))
    phase5a_exact_grads(torch, llama, A, leaves)
    log("phase 5a done at %.1fs" % (time.perf_counter() - start))
    train_launches = phase5b_train(torch, llama, A, training)
    log("phase 5b done at %.1fs" % (time.perf_counter() - start))

    # one line per kernel: its launches in the training run (phase 5b),
    # its times at the training shape (phase 4); K1 also at the inference
    # shape (phase 1) with its launches in the forward (phase 2)
    ported, not_yet = [], []
    for k in KERNELS:
        if k.get("source") is None:
            not_yet.append({"name": k["name"], "replaces": k["replaces"],
                            "status": "not yet ported"})
            continue
        rec = records[k["name"]]
        line = {"name": k["name"], "route": k["route"],
                "source": k["source"], "replaces": k["replaces"],
                "status": "ported", "launches": train_launches[k["name"]],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                "shape": "B, S, H, KV, D = %s bf16 causal" % (TRAIN_SHAPE,)}
        if k["name"] == "flash_fwd":
            line["inference_shape"] = {
                "shape": "B, S, H, KV, D = (2, 2048, 32, 8, 128) bf16 "
                         "causal",
                "launches_llama3_8b_forward": fwd_launches["flash_fwd"],
                "max_abs_err": inference["max_abs_err_o"],
                "ms": inference["ms"], "plain_ms": inference["plain_ms"],
                "bound_ms": inference["bound_ms"],
                "library_ms": inference["library_ms"]}
        else:
            line["library"] = "SDPA backward: dq, dk, dv together"
            line["plain"] = "the plain backward: dq, dk, dv together"
        ported.append(line)
    log(card_line())
    log(json.dumps({"kernels": ported, "not_yet_ported": not_yet}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
