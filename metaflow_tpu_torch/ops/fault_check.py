"""Plant faults in copies of the flash backward source and read each
against the plain version, at chip_smoke.py's phase-4 shapes and inputs:
the evidence behind attention.FLASH_BWD_ROW_LIMIT. Needs the card:

    python -m metaflow_tpu_torch.ops.fault_check

Each fault is a small edit of csrc/flash_bwd.cu, built into its own
directory under metaflow_tpu_torch/_build/faults/; the sound source is read
first. Prints one JSON line per fault with each shape's readings: the row
error (flash_out_error) of dq, dk, dv for bf16, and for f32 the largest
|error| over atol 1e-5 + rtol 1e-3 |plain|."""

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

FAULTS = {
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


def readings(A):
    """Each phase-4 shape's readings of K2 and K3 against the plain
    version, on phase 4's inputs."""
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


def main():
    if not torch.cuda.is_available():
        print("fault_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    csrc, build_dir = _build.CSRC, _build.BUILD_DIR
    source = (csrc / "flash_bwd.cu").read_text()
    try:
        for name, edits in FAULTS.items():
            text = source
            for old, new in edits:
                if old not in text:
                    raise ValueError("fault %s: %r is not in flash_bwd.cu"
                                     % (name, old))
                text = text.replace(old, new)
            root = build_dir / "faults" / name
            shutil.rmtree(root, ignore_errors=True)
            shutil.copytree(csrc, root / "csrc")
            (root / "csrc" / "flash_bwd.cu").write_text(text)
            _build.CSRC, _build.BUILD_DIR = root / "csrc", root / "build"
            _build._LOADED.pop("flash_bwd", None)
            rows = readings(A)
            worst = {n: max(r[n] for r in rows if r["dtype"] == "bfloat16")
                     for n in ("dq", "dk", "dv")}
            print(json.dumps({"fault": name, "worst_bf16": worst,
                              "limit": A.FLASH_BWD_ROW_LIMIT,
                              "shapes": rows}), flush=True)
    finally:
        _build.CSRC, _build.BUILD_DIR = csrc, build_dir
        _build._LOADED.pop("flash_bwd", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
