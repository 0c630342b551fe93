"""What holds K3 back: its wgmma body (csrc/flash_bwd.cu,
flash_bwd_dkv_wgmma_kernel) timed against copies of itself with part of
its work taken out, in turns on one card (sound, variant, variant, sound)
at bench_1b's training shape (B=8, S=2048, H=16, KV=8, D=128, bf16,
causal). The variants are text edits of the source, built beside it under
metaflow_tpu_torch/_build/controls/:
  no_exp          P^T without the exponential (the special-function
                  units' share);
  no_elementwise  neither P^T nor dS^T formed between the products (what
                  the products and their pipeline take alone).
Their outputs are wrong by design; only their times are read. Needs the
card:

    python scripts/k3_controls.py
"""

import importlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402

EXP = ("            float pv = fast_exp2(fmaf(sp[4 * jj + e], scale_log2, "
       "-cL[col]));")
ELEMENTWISE_START = ("#pragma unroll\n          for (int e = 0; e < 4; ++e)"
                     " {\n            const int col = jj * 8 + t4 * 2 + "
                     "(e & 1);\n" + EXP)
ELEMENTWISE_END = ("          pa[jj / 2][(jj & 1) * 2] = pack_bf16(sp[4 * jj],"
                   " sp[4 * jj + 1]);")


def variant(text, name):
    """The source with variant `name`'s edit."""
    if name == "no_exp":
        if text.count(EXP) != 1:
            raise ValueError("flash_bwd.cu: K3's exponential not found")
        return text.replace(EXP, EXP.replace("fast_exp2(", "(", 1))
    start, end = text.index(ELEMENTWISE_START), text.index(ELEMENTWISE_END)
    return text[:start] + text[end:]


def main():
    import torch

    from metaflow_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("k3_controls: no CUDA device", file=sys.stderr)
        return 2
    A = importlib.import_module("metaflow_tpu_torch.ops.attention")
    names = ("no_exp", "no_elementwise")
    jobs = _build.start_builds(["flash_bwd"])
    roots = {}
    for name in names:
        root = _build.BUILD_DIR / "controls" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(_build.CSRC, root / "csrc")
        src = root / "csrc" / "flash_bwd.cu"
        src.write_text(variant(src.read_text(), name))
        jobs += _build.start_builds(["flash_bwd"], root / "csrc",
                                    root / "build")
        roots[name] = root
    _build.finish_builds(jobs)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, H, KV, D = C.TRAIN_SHAPE
    q, k, v, g = C._bwd_inputs(torch, gen, B, S, H, KV, D, torch.bfloat16)
    scale = D ** -0.5
    out, lse = A._flash_forward_cuda(q, k, v, True, scale)
    delta = C._delta(g, out)

    def sound():
        return A._flash_bwd_dkv_cuda(q, k, v, g, lse, delta, scale, True)

    print(C.card_line(), flush=True)
    for name in names:
        import ctypes

        lib = ctypes.CDLL(str(_build.library_path(
            "flash_bwd", roots[name] / "csrc", roots[name] / "build")[1]))

        def control():
            with C.baseline_source(_build, "flash_bwd", lib):
                return sound()

        sound_ms, control_ms, turns = C.in_turns(sound, control, 20)
        print(json.dumps({"variant": name, "sound_ms": sound_ms,
                          "variant_ms": control_ms, "turns_ms": turns}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
