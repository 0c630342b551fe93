"""Plant faults in copies of a kernel source and read each against the
plain version: the evidence behind attention.FLASH_BF16_ROW_LIMIT and
FLASH_LSE_LIMIT (faults in K1, the bf16 wgmma kernel of csrc/flash_fwd.cu,
read at chip_smoke.py's phase-1 cases, FWD_CASES below),
attention.FLASH_BWD_ROW_LIMIT (faults in csrc/flash_bwd.cu, read at
chip_smoke.py's phase-4 shapes), attention.FLASH_BLOCK_ROW_LIMIT and
FLASH_BLOCK_STATS_LIMIT (faults in the ring hop's forward K4 of
csrc/flash_fwd.cu, read at phase 8a's cases, BLOCK_FWD_CASES below) and
gmm's GMM_FWD_ROW_LIMIT and GMM_DW_ROW_LIMIT (faults in csrc/gmm.cu, read
at phase 6's cases, which chip_smoke.py takes from GMM_CASES below). Needs
the card:

    python -m metaflow_tpu_torch.ops.fault_check [flash_fwd] [flash_bwd]
        [flash_block_fwd] [gmm]

(every mode when none is named). Each fault is a small edit of the
source, built into its own directory under metaflow_tpu_torch/_build/
faults/ (all of a mode's builds at once) and read in a process of its own,
so a fault that deadlocks a pipeline (the mbarrier wait's watchdog traps,
and the CUDA context is lost) reads inf without stopping the others; the
sound source is read first. Prints one JSON line per fault with each
shape's readings: the row error (attention.flash_out_error) for bf16, and
for f32 the largest |error| over 1e-5 + 1e-3 |plain| (flash backward),
over 1e-5 (K1's O and lse, K4's acc / l) or over 1e-5 of the largest
|plain| (gmm); K1's lse and K4's m and lse read
attention.flash_stats_error."""

import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from . import _build

SHAPES = [  # (B, S, H, KV, D, dtype, causal), as chip_smoke.py's phase 4
    (1, 128, 4, 4, 64, torch.float32, True),
    (2, 256, 8, 2, 128, torch.bfloat16, True),
    (1, 512, 4, 4, 128, torch.bfloat16, False),
    (8, 2048, 16, 8, 128, torch.bfloat16, True),
]

_ROUND4 = ("__uint_as_float((__float_as_uint(%s) + 0x40000u) & "
           "0xfff80000u)")  # round to 4 mantissa bits

FLASH_FAULTS = {
    "sound": [],
    # K2 keeps the keys past the diagonal
    "k2_causal_mask_dropped": [
        ("if (key >= S || (p.causal && key > row)) pv = 0.f;",
         "if (key >= S) pv = 0.f;")],
    # K2's dS rounded to 4 mantissa bits before dS K
    "k2_ds_4_mantissa_bits": [
        ("        s[j][e] = pv * (dp[j][e] - dlt[i]) * p.scale;",
         "        s[j][e] = " + _ROUND4 % "(pv * (dp[j][e] - dlt[i]) * "
         "p.scale)" + ";")],
    # faults in K3's wgmma body (flash_bwd_dkv_wgmma_kernel):
    # the consumer never flips its full barriers' phase bit: from a stage's
    # second use a wait passes on its previous phase, before the stage is
    # refilled (or deadlocks, which the watchdog traps)
    "k3_phase_bit_not_flipped": [
        ("        mbar_wait(&full[st], (it / KV_STAGES) & 1);",
         "        mbar_wait(&full[st], 0);")],
    # the consumer hands its Q / dO stage back as soon as it is full,
    # before any of the products that read it have been waited for (handed
    # back after the dV, dK commit instead, it reads sound: the refill
    # lands later than those products finish)
    "k3_stage_released_before_wgmma_wait": [
        ("        mbar_wait(&full[st], (it / KV_STAGES) & 1);\n",
         "        mbar_wait(&full[st], (it / KV_STAGES) & 1);\n"
         "        if (tid == 0) mbar_arrive(&empty[st]);\n"),
        ("        if (tid == 0) mbar_arrive(&empty[st]);  // the stage, read "
         "for good\n", "")],
    # K3 keeps the queries before the diagonal
    "k3_causal_mask_dropped": [
        ("              if (qpos >= S || (p.causal && qpos < key)) pv = 0.f;",
         "              if (qpos >= S) pv = 0.f;")],
    # producer and consumer skip the last q head of each GQA group
    "k3_gqa_head_skipped": [
        ("const int n_iter = group * per_head;",
         "const int n_iter = (group - 1) * per_head;")],
    # K3's P rounded to 4 mantissa bits before P^T dO
    "k3_p_4_mantissa_bits": [
        ("            sp[4 * jj + e] = pv;",
         "            sp[4 * jj + e] = " + _ROUND4 % "pv" + ";")],
}

# faults in K1's bf16 wgmma body (flash_fwd.cu's flash_fwd_wgmma_kernel)
FWD_FAULTS = {
    "sound": [],
    # the consumers never flip their K and V barriers' phase bit: from a
    # stage's second use a wait passes on its previous phase, before the
    # stage is refilled (or deadlocks, which the watchdog traps)
    "k1_phase_bit_not_flipped": [
        ("        const uint32_t full_phase = (it / FA_STAGES) & 1;",
         "        const uint32_t full_phase = 0;")],
    # the diagonal tile lets keys past the diagonal count (the tile loop
    # still stops at the diagonal tile)
    "k1_diagonal_mask_dropped": [
        ("if (key >= p.S || (p.causal && key > row)) x = -INFINITY;",
         "if (key >= p.S) x = -INFINITY;")],
    # the probabilities rounded to 4 mantissa bits (in P V and in l)
    "k1_p_4_mantissa_bits": [
        ("            s[4 * jj + e] = fast_exp2(s[4 * jj + e] - mu[e / 2]);",
         "            s[4 * jj + e] = "
         + _ROUND4 % "fast_exp2(s[4 * jj + e] - mu[e / 2])" + ";")],
}

# chip_smoke.py's phase-1 cases: (B, S, H, KV, D, dtype, causal), the
# Llama-3-8B inference shape last
FWD_CASES = [
    (1, 128, 4, 4, 64, torch.float32, True),
    (2, 256, 8, 2, 128, torch.bfloat16, True),
    (1, 512, 4, 4, 128, torch.bfloat16, False),
    (2, 200, 4, 2, 64, torch.bfloat16, True),
    (2, 2048, 32, 8, 128, torch.bfloat16, True),
]


def fwd_case_readings(q, k, v, causal):
    """K1 against its plain version on one case: {'o': flash_out_error,
    'lse': flash_stats_error} for bf16, each max |error| over 1e-5 for
    f32 (the sums differ only in order). NaN reads inf."""
    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    scale = q.shape[-1] ** -0.5
    out, lse = A._flash_forward_cuda(q, k, v, causal, scale)
    ref_out, ref_lse = A._flash_forward_plain(q, k, v, causal, scale)
    if not (torch.isfinite(out.float()).all() and torch.isfinite(lse).all()):
        return {"o": float("inf"), "lse": float("inf")}
    if q.dtype == torch.float32:
        return {"o": (out - ref_out).abs().max().item() / 1e-5,
                "lse": (lse - ref_lse).abs().max().item() / 1e-5}
    return {"o": A.flash_out_error(out, ref_out),
            "lse": A.flash_stats_error(lse, ref_lse)}


def fwd_inputs(case, gen):
    """One phase-1 case's q, k, v on the card."""
    B, S, H, KV, D, dt, _ = case
    return tuple(torch.randn(B, S, h, D, generator=gen, device="cuda").to(dt)
                 for h in (H, KV, KV))


def fwd_readings():
    """Each phase-1 case's readings of K1, on phase 1's inputs."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for case in FWD_CASES:
        q, k, v = fwd_inputs(case, gen)
        B, S, H, KV, D, dt, causal = case
        row = {"shape": [B, S, H, KV, D], "dtype": str(dt).split(".")[-1],
               "causal": causal}
        row.update(fwd_case_readings(q, k, v, causal))
        rows.append(row)
    return rows


# faults in K4, the ring hop's forward (flash_fwd.cu's
# flash_block_fwd_bf16_kernel, and the kBlock variant of the f32 kernel,
# whose edited lines K1's f32 variant shares but is not read here)
BLOCK_FWD_FAULTS = {
    "sound": [],
    # m written in the loop's log2 units (acc / l still looks right)
    "k4_m_in_log2_units": [
        ("p.lse[base + row] = m_r[i] * kLn2;",
         "p.lse[base + row] = m_r[i];")],
    # the diagonal hop lets keys past the diagonal count (its tile loop
    # still stops at the diagonal tile)
    "k4_diagonal_mask_dropped": [
        ("if (key >= S || (p.causal && key > row)) x = -INFINITY;",
         "if (key >= S) x = -INFINITY;")],
    # acc written normalized by l
    "k4_acc_normalized": [
        ("make_float2(acc[n][0], acc[n][1]);",
         "make_float2(acc[n][0] / l_r[0], acc[n][1] / l_r[0]);"),
        ("make_float2(acc[n][2], acc[n][3]);",
         "make_float2(acc[n][2] / l_r[1], acc[n][3] / l_r[1]);")],
    # a full hop skips its last key tile
    "k4_full_hop_last_tile_skipped": [
        ("  if (p.causal) n_tiles = min(n_tiles, (q0 + BM + BN - 1) / BN);\n",
         "  if (p.causal) n_tiles = min(n_tiles, (q0 + BM + BN - 1) / BN);\n"
         "  else n_tiles -= 1;\n")],
    # the probabilities rounded to 4 mantissa bits (in P.V and in l)
    "k4_p_4_mantissa_bits": [
        ("      rs[0] += s[j][0] + s[j][1];",
         "      for (int e = 0; e < 4; ++e) s[j][e] = "
         + _ROUND4 % "s[j][e]" + ";\n      rs[0] += s[j][0] + s[j][1];")],
    # the f32 (FMA) variant's faults, read at the f32 cases: acc written
    # normalized by l, the diagonal mask dropped within the last key tile,
    # and m written in log2 units
    "k4_f32_acc_normalized": [
        ("og[lane + 32 * i] = acc[i];", "og[lane + 32 * i] = acc[i] / l;")],
    "k4_f32_diagonal_mask_dropped": [
        ("if (key >= S || (p.causal && key > row)) sc = -INFINITY;",
         "if (key >= S) sc = -INFINITY;")],
    "k4_f32_m_in_log2_units": [
        ("        p.lse[at] = m;",
         "        p.lse[at] = m * 1.4426950408889634f;")],
}

# chip_smoke.py's phase-8a cases: (B, S, H, KV, D, dtype, diagonal), each
# read through shard views of a two-shard sequence (block_fwd_inputs); the
# last two are bench_1b's ring hop at 8k context (a 2048-row shard of 4),
# diagonal and full
BLOCK_FWD_CASES = [
    (1, 128, 4, 4, 64, torch.float32, True),
    (2, 256, 4, 2, 128, torch.float32, False),
    (2, 256, 8, 2, 128, torch.bfloat16, True),
    (1, 512, 4, 4, 64, torch.bfloat16, False),
    (2, 384, 8, 4, 128, torch.bfloat16, True),
    (2, 2048, 16, 8, 128, torch.bfloat16, True),
    (2, 2048, 16, 8, 128, torch.bfloat16, False),
]


def block_fwd_inputs(case, gen):
    """One phase-8a case's q, k, v on the card: views of [B, 2S, ...]
    sequences, q the second shard, k and v the same shard (diagonal) or the
    first (full), as a ring hop reads them."""
    B, S, H, KV, D, dt, diag = case
    q, k, v = (torch.randn(B, 2 * S, h, D, generator=gen, device="cuda")
               .to(dt) for h in (H, KV, KV))
    kv = slice(S, 2 * S) if diag else slice(0, S)
    return q[:, S:], k[:, kv], v[:, kv]


def block_fwd_case_readings(q, k, v, diag):
    """K4 against its plain version on one case: {'acc', 'm', 'lse'} as
    attention.flash_block_readings gives them, acc for f32 operands as
    max |acc / l - plain| over 1e-5 (K1's f32 check). NaN reads inf."""
    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    scale = q.shape[-1] ** -0.5
    got = A._flash_block_fwd_cuda(q, k, v, scale, diag)
    want = A._flash_block_fwd_plain(q, k, v, scale, diag)
    if not all(bool(torch.isfinite(t).all()) for t in got):
        return {"acc": float("inf"), "m": float("inf"), "lse": float("inf")}
    out = A.flash_block_readings(*got, want)
    if q.dtype == torch.float32:
        out["acc"] = (A.flash_block_output(got[0], got[2])
                      - A.flash_block_output(want[0], want[2])).abs(
        ).max().item() / 1e-5
    return out


def block_fwd_readings():
    """Each phase-8a case's readings of K4, on phase 8a's inputs."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for case in BLOCK_FWD_CASES:
        q, k, v = block_fwd_inputs(case, gen)
        B, S, H, KV, D, dt, diag = case
        row = {"shape": [B, S, H, KV, D], "dtype": str(dt).split(".")[-1],
               "diagonal": diag}
        row.update(block_fwd_case_readings(q, k, v, diag))
        rows.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


_ACC_TO_BF16 = (
    "wgmma_wait<0>();\n"
    "#pragma unroll\n"
    "          for (int i = 0; i < 128; ++i)\n"
    "            acc[i] = __bfloat162float(__float2bfloat16(acc[i]));\n")

# faults in K5's wgmma body (the kTma and cp.async producers alike, unless
# named) and in K6's
GMM_FAULTS = {
    "sound": [],
    # the consumers never flip their full-barrier phase bit: from the
    # second pass over the ring a wait passes on a stage's previous phase,
    # before the stage is refilled (or deadlocks, which the watchdog traps)
    "k5_phase_bit_not_flipped": [
        ("            read_phase ^= 1;\n", "")],
    # a consumer hands its stage back right after committing the wgmma
    # that read it, before waiting for them, so the producer may refill it
    # under the running products
    "k5_stage_released_before_wgmma_wait": [
        ("          wgmma_commit();\n"
         "          wgmma_wait<1>();  // the previous k slice's group has "
         "finished\n"
         "          fence_operand(acc);\n"
         "          if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);\n"
         "          held = stage;\n",
         "          wgmma_commit();\n"
         "          if (tid == 0) mbar_arrive(&empty[stage]);\n"
         "          wgmma_wait<1>();\n"
         "          fence_operand(acc);\n"
         "          held = -1;\n")],
    # dx's B (w[g] stored [N, K], K-major) read with the forward's
    # transpose bit, as if MN-major
    "k5_dx_transpose_bit_ignored": [
        ("wgmma_m64n256k16_ss<0>(acc, da, desc_k_major(sb + kk * 32), 1);",
         "wgmma_m64n256k16_ss<1>(acc, da, desc_k_major(sb + kk * 32), 1);")],
    # the producer loads the previous tile's group's weights
    "k5_wrong_group_weights": [
        ("      const int g = p.tile_group[tile];\n",
         "      const int g = p.tile_group[tile > 0 ? tile - 1 : 0];\n")],
    # an inactive tile's output is left unwritten
    "k5_inactive_tile_unwritten": [
        ("        if (col >= p.N) continue;",
         "        if (col >= p.N || !active) continue;")],
    # producer and consumers skip the last 64-deep k slice
    "k5_last_k_slice_skipped": [
        ("  const int nk = (p.K + WG_BK - 1) / WG_BK;",
         "  const int nk = (p.K + WG_BK - 1) / WG_BK - 1;")],
    # the running sum kept in bf16 (rounded after every k slice)
    "k5_bf16_accumulator": [
        ("wgmma_wait<1>();  // the previous k slice's group has finished\n",
         _ACC_TO_BF16)],
    # faults in K6's wgmma body (gmm_dw_wgmma_kernel), both producers:
    # the consumers never flip their full barriers' phase bit
    "k6_phase_bit_not_flipped": [
        ("          next_stage(stage, read_phase);",
         "          if (++stage == WG_STAGES) stage = 0;")],
    # a consumer hands its stage back right after committing the wgmma
    # that read it, before waiting for them
    "k6_stage_released_before_wgmma_wait": [
        ("          wgmma_commit();\n"
         "          wgmma_wait<1>();  // the previous stage's group has "
         "finished\n"
         "          fence_operand(acc);\n"
         "          if (held >= 0 && tid == 0) mbar_arrive(&empty[held]);\n"
         "          held = stage;\n",
         "          wgmma_commit();\n"
         "          if (tid == 0) mbar_arrive(&empty[stage]);\n"
         "          wgmma_wait<1>();\n"
         "          fence_operand(acc);\n"
         "          held = -1;\n")],
    # A (x^T, stored M-major) read without wgmma's transpose bit for A
    "k6_a_transpose_bit_ignored": [
        ("wgmma_m64n256k16_ss<1, 1>(", "wgmma_m64n256k16_ss<1, 0>(")],
    # producer and consumers load and multiply inactive tiles too
    "k6_counts_inactive_tiles": [
        ("if (p.tile_active[t] == 0) continue;  // K6 skips inactive tiles",
         "// inactive tiles counted")],
    # producer and consumers walk one tile past their group: the next
    # group's first tile
    "k6_reads_next_groups_rows": [
        ("      const int last = lower_bound(p.tile_group, p.n_tiles, g + 1);",
         "      const int last = min(\n"
         "          lower_bound(p.tile_group, p.n_tiles, g + 1) + 1, "
         "p.n_tiles);")],
}

# chip_smoke.py's phase-6 cases: (name, rows, groups, D, F, dtype, how the
# rows are grouped). "empty_one_row" leaves group 1 empty and gives group 2
# one row; "row_valid" marks 70 % of the rows as padding; "inactive" forces
# a real tile inactive; "train" is Mixtral-8x7B's gate/up and down shapes
# at 16384 routed rows (tokens [4, 2048], top-2 of 8), "skewed" the gate/up
# shape with 70 % of the rows routed to one group.
GMM_CASES = [
    ("f32_tails", 700, 5, 40, 72, torch.float32, "random"),
    ("f32_inactive", 2000, 8, 256, 384, torch.float32, "inactive"),
    ("bf16_empty_one_row", 256, 4, 32, 64, torch.bfloat16, "empty_one_row"),
    ("bf16_row_valid", 700, 3, 64, 128, torch.bfloat16, "row_valid"),
    ("bf16_unaligned_tails", 700, 3, 37, 50, torch.bfloat16, "random"),
    ("bf16_inactive", 2000, 8, 256, 384, torch.bfloat16, "inactive"),
    ("bf16_train_down", 16384, 8, 14336, 4096, torch.bfloat16, "random"),
    ("bf16_train_gate_up", 16384, 8, 4096, 14336, torch.bfloat16, "random"),
    ("bf16_train_skewed", 16384, 8, 4096, 14336, torch.bfloat16, "skewed"),
]


def gmm_inputs(n, groups, D, F, dtype, kind, gen):
    """One phase-6 case's inputs on the card: x [S, D] in the grouped
    layout, w [G, D, F], an output gradient dy [S, F], the layout."""
    G = importlib.import_module("metaflow_tpu_torch.ops.gmm")
    valid = None
    if kind == "empty_one_row":
        gids = torch.tensor([3] * (n - 6) + [0] * 5 + [2], device="cuda")
    elif kind == "skewed":  # 70 % to group 0, the rest spread
        gids = torch.where(
            torch.rand(n, generator=gen, device="cuda") < 0.7, 0,
            torch.randint(1, groups, (n,), generator=gen, device="cuda"))
    else:
        gids = torch.randint(0, groups, (n,), generator=gen, device="cuda")
    if kind == "row_valid":
        valid = (torch.rand(n, generator=gen, device="cuda") < 0.3).long()
    layout = G.make_group_layout(gids, groups, row_valid=valid)
    rows = torch.randn(n, D, generator=gen, device="cuda", dtype=dtype)
    if valid is not None:  # padding rows carry zeros, as gmm_ep's do
        rows = rows * valid[:, None].to(dtype)
    x = G.scatter_rows(rows, layout)
    del rows
    w = torch.randn(groups, D, F, generator=gen, device="cuda", dtype=dtype)
    w *= D ** -0.5
    dy = torch.randn(x.shape[0], F, generator=gen, device="cuda", dtype=dtype)
    if kind == "inactive":  # a tile of real rows, forced inactive
        layout["tile_active"] = layout["tile_active"].clone()
        layout["tile_active"][1] = 0
    return x, w, dy, layout


def _poisoned(launch, shape, dtype):
    """launch() after freeing a NaN block of the output's size, which the
    caching allocator hands to the kernel's torch.empty: output the kernel
    leaves unwritten reads NaN instead of stale numbers."""
    torch.full(shape, float("nan"), dtype=dtype, device="cuda")
    return launch()


def gmm_reading(got, want, bf16_operands):
    """bf16 operands: attention.flash_out_error, the unit of gmm's
    GMM_FWD_ROW_LIMIT and GMM_DW_ROW_LIMIT (also for K6's f32 dw); f32
    operands: max |error| over 1e-5 of the largest |plain| (f32 sums of the
    same products in another order differ by about 1e-6 of it here). NaN
    reads inf."""
    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    if not torch.isfinite(got).all():
        return float("inf")
    if bf16_operands:
        return A.flash_out_error(got, want)
    return ((got - want).abs().max() / (1e-5 * want.abs().max() + 1e-30)
            ).item()


def gmm_case_readings(x, w, dy, layout):
    """K5 (y), K5 on the transposed weights (dx) and K6 (dw, and for bf16
    operands dw_bf16, its bf16 output against the plain f32 sum rounded
    once) against their plain versions on one case's inputs: {'y':
    reading, 'dx': ..., 'dw': ...}, each kernel's output poisoned
    beforehand."""
    G = importlib.import_module("metaflow_tpu_torch.ops.gmm")
    tg, ta = layout["tile_group"], layout["tile_active"]
    S, (n_g, D, F) = x.shape[0], w.shape
    bf16 = x.dtype == torch.bfloat16
    y = _poisoned(lambda: G._gmm_fwd_cuda(x, w, tg, ta), (S, F), x.dtype)
    out = {"y": gmm_reading(y, G._gmm_fwd_plain(x, w, tg, ta), bf16)}
    del y
    dx = _poisoned(lambda: G._gmm_fwd_cuda(dy, w, tg, ta, w_transposed=True),
                   (S, D), x.dtype)
    out["dx"] = gmm_reading(dx, G._gmm_fwd_plain(dy, w, tg, ta,
                                                 w_transposed=True), bf16)
    del dx
    dw = _poisoned(lambda: G._gmm_dw_cuda(x, dy, tg, ta, n_g), (n_g, D, F),
                   torch.float32)
    want = G._gmm_dw_plain(x, dy, tg, ta, n_g)
    out["dw"] = gmm_reading(dw, want, bf16)
    del dw
    if bf16:
        dw = _poisoned(lambda: G._gmm_dw_cuda(x, dy, tg, ta, n_g,
                                              out_dtype=torch.bfloat16),
                       (n_g, D, F), torch.bfloat16)
        out["dw_bf16"] = gmm_reading(dw, want.to(torch.bfloat16), True)
    return out


def gmm_readings():
    """Each phase-6 case's readings of K5 and K6, on phase 6's inputs."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    for name, n, groups, D, F, dt, kind in GMM_CASES:
        x, w, dy, layout = gmm_inputs(n, groups, D, F, dt, kind, gen)
        row = {"case": name, "dtype": str(dt).split(".")[-1]}
        row.update(gmm_case_readings(x, w, dy, layout))
        rows.append(row)
        del x, w, dy, layout
        torch.cuda.empty_cache()
    return rows


def flash_readings():
    """Each phase-4 shape's readings of K2 and K3 against the plain
    version, on phase 4's inputs."""
    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for B, S, H, KV, D, dt, causal in SHAPES:
        q, k, v, g = (torch.randn(B, S, h, D, generator=gen,
                                  device="cuda").to(dt)
                      for h in (H, KV, KV, H))
        scale = D ** -0.5
        out, lse = A._flash_forward_cuda(q, k, v, causal, scale)
        delta = (g.float() * out.float()).sum(-1).transpose(1, 2).reshape(
            B * H, S).contiguous()
        got = (A._flash_bwd_dq_cuda(q, k, v, g, lse, delta, scale, causal),
               *A._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, causal))
        want = A._flash_block_bwd_plain(q, k, v, g, lse, delta, scale, causal)
        torch.cuda.synchronize()
        row = {"shape": [B, S, H, KV, D], "dtype": str(dt).split(".")[-1],
               "causal": causal}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if dt == torch.float32:
                row[name] = ((a - b).abs() / (1e-5 + 1e-3 * b.abs())).max(
                ).item()
            else:
                row[name] = A.flash_out_error(a, b)
        rows.append(row)
        del q, k, v, g, out, lse, delta, got, want
    return rows


SOURCES = {  # mode -> (source, faults, readings, {reading: limit's name})
    "flash_fwd": ("flash_fwd", FWD_FAULTS, fwd_readings, (
        "attention", {"o": "FLASH_BF16_ROW_LIMIT",
                      "lse": "FLASH_LSE_LIMIT"})),
    "flash_bwd": ("flash_bwd", FLASH_FAULTS, flash_readings, (
        "attention", {k: "FLASH_BWD_ROW_LIMIT" for k in ("dq", "dk", "dv")})),
    "flash_block_fwd": ("flash_fwd", BLOCK_FWD_FAULTS, block_fwd_readings, (
        "attention", {"acc": "FLASH_BLOCK_ROW_LIMIT",
                      "m": "FLASH_BLOCK_STATS_LIMIT",
                      "lse": "FLASH_BLOCK_STATS_LIMIT"})),
    "gmm": ("gmm", GMM_FAULTS, gmm_readings, (
        "gmm", {"y": "GMM_FWD_ROW_LIMIT", "dx": "GMM_FWD_ROW_LIMIT",
                "dw": "GMM_DW_ROW_LIMIT", "dw_bf16": "GMM_FWD_ROW_LIMIT"})),
}


def _fault_root(mode, name):
    return _build.BUILD_DIR / "faults" / mode / name


def _plant(mode, name):
    """Write the fault's copy of csrc/ and start its build; returns the
    build jobs."""
    source, faults = SOURCES[mode][:2]
    text = (_build.CSRC / (source + ".cu")).read_text()
    for old, new in faults[name]:
        if old not in text:
            raise ValueError("fault %s: %r is not in %s.cu"
                             % (name, old, source))
        text = text.replace(old, new)
    root = _fault_root(mode, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root / "csrc")
    (root / "csrc" / (source + ".cu")).write_text(text)
    return _build.start_builds([source], root / "csrc", root / "build")


def read_fault(mode, name):
    """This process's reading of one planted fault (built by _plant): the
    JSON line run() prints."""
    source, _, readings, (module, limit_names) = SOURCES[mode]
    mod = importlib.import_module("metaflow_tpu_torch.ops." + module)
    limit = {k: getattr(mod, n) for k, n in limit_names.items()}
    root = _fault_root(mode, name)
    _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "build"
    _build._LOADED.pop(source, None)
    rows = readings()
    worst = {dt: {n: max([r[n] for r in rows if r["dtype"] == dt
                          and n in r], default=None) for n in limit}
             for dt in ("bfloat16", "float32")}
    return {"mode": mode, "fault": name, "worst_bf16": worst["bfloat16"],
            "worst_f32": worst["float32"], "limit": limit, "shapes": rows}


def run(mode):
    """Plant every fault of `mode`, build them all at once, then read each
    in a process of its own and print its JSON line. A reading process
    that dies (a CUDA error, the watchdog's trap) reads inf."""
    faults, limit_names = SOURCES[mode][1], SOURCES[mode][3][1]
    jobs = []
    for name in faults:
        jobs += _plant(mode, name)
    _build.finish_builds(jobs)
    package_root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [package_root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    for name in faults:
        proc = subprocess.run(
            [sys.executable, "-m", "metaflow_tpu_torch.ops.fault_check",
             "--read", mode, name], capture_output=True, text=True, env=env,
            cwd=package_root)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode == 0 and lines:
            print(lines[-1], flush=True)
            continue
        said = proc.stderr.strip().splitlines() or ["no output"]
        err = next((ln for ln in reversed(said) if "CUDA error" in ln),
                   said[-1])
        inf = {n: float("inf") for n in limit_names}
        print(json.dumps({"mode": mode, "fault": name, "worst_bf16": inf,
                          "worst_f32": inf, "error": err[:300]}), flush=True)


def main(argv=None):
    if not torch.cuda.is_available():
        print("fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    args = list(argv if argv is not None else sys.argv[1:])
    if args[:1] == ["--read"]:
        print(json.dumps(read_fault(args[1], args[2])), flush=True)
        return 0
    for mode in args or list(SOURCES):
        run(mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
