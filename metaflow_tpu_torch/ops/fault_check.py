"""Plant faults in copies of a kernel source and read each against the
plain version: the evidence behind attention.FLASH_BWD_ROW_LIMIT (faults
in csrc/flash_bwd.cu, read at chip_smoke.py's phase-4 shapes),
attention.FLASH_BLOCK_ROW_LIMIT and FLASH_BLOCK_STATS_LIMIT (faults in the
ring hop's forward K4 of csrc/flash_fwd.cu, read at phase 8a's cases,
BLOCK_FWD_CASES below) and gmm's GMM_FWD_ROW_LIMIT and GMM_DW_ROW_LIMIT
(faults in csrc/gmm.cu, read at phase 6's cases, which chip_smoke.py takes
from GMM_CASES below). Needs the card:

    python -m metaflow_tpu_torch.ops.fault_check [flash_bwd]
        [flash_block_fwd] [gmm]

(every mode when none is named). Each fault is a small edit of the
source, built into its own directory under metaflow_tpu_torch/_build/
faults/; the sound source is read first. Prints one JSON line per fault
with each shape's readings: the row error (attention.flash_out_error) for
bf16, and for f32 the largest |error| over 1e-5 + 1e-3 |plain| (flash
backward), over 1e-5 (K4's acc / l) or over 1e-5 of the largest |plain|
(gmm); K4's m and lse read attention.flash_stats_error."""

import importlib
import json
import shutil
import sys

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
    # K3 keeps the queries before the diagonal
    "k3_causal_mask_dropped": [
        ("if (qpos >= S || (p.causal && qpos < key)) pv = 0.f;",
         "if (qpos >= S) pv = 0.f;")],
    # K3 skips the last q head of each GQA group
    "k3_gqa_head_skipped": [
        ("const int n_iter = group * per_head;",
         "const int n_iter = (group - 1) * per_head;"),
        ("for (int gi = 0; gi < group; ++gi) {",
         "for (int gi = 0; gi < group - 1; ++gi) {")],
    # K3's P rounded to 4 mantissa bits before P^T dO
    "k3_p_4_mantissa_bits": [
        ("        st[j][e] = pv;",
         "        st[j][e] = " + _ROUND4 % "pv" + ";")],
}

# faults in K4, the ring hop's forward (the kBlock variant of
# flash_fwd.cu's kernels; K1 shares the edited lines but is not read)
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
    "#pragma unroll\n"
    "    for (int mi = 0; mi < MI; ++mi)\n"
    "      for (int ni = 0; ni < NI; ++ni)\n"
    "        for (int e = 0; e < 4; ++e)\n"
    "          acc[mi][ni][e] = __bfloat162float(__float2bfloat16("
    "acc[mi][ni][e]));\n")

GMM_FAULTS = {
    "sound": [],
    # K5 multiplies each tile by the previous tile's group's weights
    "k5_wrong_group_weights": [
        ("const int g = p.tile_group[tile];",
         "const int g = p.tile_group[tile > 0 ? tile - 1 : 0];")],
    # K5 leaves an inactive tile's output unwritten
    "k5_inactive_tile_unwritten": [
        ("if (p.tile_active[tile] == 0) {  // padding only: write zeros",
         "if (p.tile_active[tile] == 0) { return;")],
    # K5 skips the last 64-deep k slice
    "k5_last_k_slice_skipped": [
        ("for (int kt = 0; kt < nk; ++kt) {  // K5 k loop",
         "for (int kt = 0; kt < nk - 1; ++kt) {")],
    # K5 keeps its running sum in bf16 (rounded after every k slice)
    "k5_bf16_accumulator": [
        ("    const __nv_bfloat16* cA = sA + (kt % STAGES) * A_STAGE;",
         _ACC_TO_BF16
         + "    const __nv_bfloat16* cA = sA + (kt % STAGES) * A_STAGE;")],
    # K6 loads and multiplies the rows of inactive tiles too
    "k6_counts_inactive_tiles": [
        ("auto active = [&](int kt) { return p.tile_active[first + kt / KPT]"
         " != 0; };",
         "auto active = [&](int kt) { return true; };")],
}

# chip_smoke.py's phase-6 cases: (name, rows, groups, D, F, dtype, how the
# rows are grouped). "empty_one_row" leaves group 1 empty and gives group 2
# one row; "row_valid" marks 70 % of the rows as padding; "inactive" forces
# a real tile inactive; "train" is Mixtral-8x7B's gate/up and down shapes
# at 16384 routed rows (tokens [4, 2048], top-2 of 8).
GMM_CASES = [
    ("f32_tails", 700, 5, 40, 72, torch.float32, "random"),
    ("f32_inactive", 2000, 8, 256, 384, torch.float32, "inactive"),
    ("bf16_empty_one_row", 256, 4, 32, 64, torch.bfloat16, "empty_one_row"),
    ("bf16_row_valid", 700, 3, 64, 128, torch.bfloat16, "row_valid"),
    ("bf16_unaligned_tails", 700, 3, 37, 50, torch.bfloat16, "random"),
    ("bf16_inactive", 2000, 8, 256, 384, torch.bfloat16, "inactive"),
    ("bf16_train_down", 16384, 8, 14336, 4096, torch.bfloat16, "random"),
    ("bf16_train_gate_up", 16384, 8, 4096, 14336, torch.bfloat16, "random"),
]


def gmm_inputs(n, groups, D, F, dtype, kind, gen):
    """One phase-6 case's inputs on the card: x [S, D] in the grouped
    layout, w [G, D, F], an output gradient dy [S, F], the layout."""
    G = importlib.import_module("metaflow_tpu_torch.ops.gmm")
    valid = None
    if kind == "empty_one_row":
        gids = torch.tensor([3] * (n - 6) + [0] * 5 + [2], device="cuda")
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
    """K5 (y), K5 on the transposed weights (dx) and K6 (dw) against their
    plain versions on one case's inputs: {'y': reading, 'dx': ...,
    'dw': ...}, each kernel's output poisoned beforehand."""
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
    out["dw"] = gmm_reading(dw, G._gmm_dw_plain(x, dy, tg, ta, n_g), bf16)
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
    "flash_bwd": ("flash_bwd", FLASH_FAULTS, flash_readings, (
        "attention", {k: "FLASH_BWD_ROW_LIMIT" for k in ("dq", "dk", "dv")})),
    "flash_block_fwd": ("flash_fwd", BLOCK_FWD_FAULTS, block_fwd_readings, (
        "attention", {"acc": "FLASH_BLOCK_ROW_LIMIT",
                      "m": "FLASH_BLOCK_STATS_LIMIT",
                      "lse": "FLASH_BLOCK_STATS_LIMIT"})),
    "gmm": ("gmm", GMM_FAULTS, gmm_readings, (
        "gmm", {"y": "GMM_FWD_ROW_LIMIT", "dx": "GMM_FWD_ROW_LIMIT",
                "dw": "GMM_DW_ROW_LIMIT"})),
}


def run(mode):
    source, faults, readings, (module, limit_names) = SOURCES[mode]
    mod = importlib.import_module("metaflow_tpu_torch.ops." + module)
    limit = {k: getattr(mod, name) for k, name in limit_names.items()}
    keys = tuple(limit_names)
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    text0 = (csrc / (source + ".cu")).read_text()
    try:
        for name, edits in faults.items():
            text = text0
            for old, new in edits:
                if old not in text:
                    raise ValueError("fault %s: %r is not in %s.cu"
                                     % (name, old, source))
                text = text.replace(old, new)
            root = build_dir / "faults" / mode / name
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(csrc, root / "csrc")
            (root / "csrc" / (source + ".cu")).write_text(text)
            _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "build"
            _build._LOADED.pop(source, None)
            rows = readings()
            worst = {n: max(r[n] for r in rows if r["dtype"] == "bfloat16")
                     for n in keys}
            worst_f32 = {n: max(r[n] for r in rows if r["dtype"] == "float32")
                         for n in keys}
            print(json.dumps({"mode": mode, "fault": name,
                              "worst_bf16": worst, "worst_f32": worst_f32,
                              "limit": limit, "shapes": rows}), flush=True)
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build._LOADED.pop(source, None)


def main(argv=None):
    if not torch.cuda.is_available():
        print("fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    names = list(argv if argv is not None else sys.argv[1:]) or list(SOURCES)
    for mode in names:
        run(mode)
    return 0


if __name__ == "__main__":
    sys.exit(main())
