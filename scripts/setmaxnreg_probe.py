"""Does ptxas give a consumer warpgroup more registers than the launch
bound allows once the kernel raises them with setmaxnreg.inc?

Compiles one small sm_90a kernel three ways and prints, for each, what
`ptxas -v` reports (registers, spill stores and loads) and the highest
register its SASS names (cuobjdump -sass). The kernel holds N = 200 f32
values live in the consumer branch:
  setmaxnreg_384: __launch_bounds__(384, 1), the producer warpgroup lowers
                  its registers to 40 and the consumers raise theirs to 232;
  plain_384:      the same block without setmaxnreg;
  plain_256:      __launch_bounds__(256, 1), one consumer warpgroup.
Needs nvcc and cuobjdump (the CUDA toolkit); runs nothing on the card:

    python scripts/setmaxnreg_probe.py
"""

import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from metaflow_tpu_torch.ops import _build  # noqa: E402

SOURCE = r"""
template <int kThreads, bool kSetmaxnreg>
__global__ void __launch_bounds__(kThreads, 1)
    probe(const float* in, float* out) {
  constexpr int N = 200;
  if (threadIdx.x < 128) {
    if (kSetmaxnreg) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    return;
  }
  if (kSetmaxnreg) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = in[threadIdx.x * N + i];
#pragma unroll 1
  for (int r = 0; r < 64; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = fmaf(acc[i], acc[(i + 7) % N], 1.f);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[threadIdx.x * N + i] = acc[i];
}
template __global__ void probe<384, true>(const float*, float*);
template __global__ void probe<384, false>(const float*, float*);
template __global__ void probe<256, false>(const float*, float*);
"""

NAMES = {"Li384ELb1E": "setmaxnreg_384", "Li384ELb0E": "plain_384",
         "Li256ELb0E": "plain_256"}


def main():
    nvcc = _build._nvcc()
    out = _build.BUILD_DIR / "setmaxnreg_probe"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "probe.cu"
    src.write_text(SOURCE)
    cubin = out / "probe.cubin"
    ptxas = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin",
         "-Xptxas", "-v", "-o", str(cubin), str(src)],
        capture_output=True, text=True, check=True).stderr
    sass = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
        capture_output=True, text=True, check=True).stdout
    report = {}
    for block in re.split(r"Compiling entry function", ptxas)[1:]:
        name = next((v for k, v in NAMES.items() if k in block), block[:40])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        report[name] = {"registers": int(regs.group(1)) if regs else None,
                        "spill_stores": int(spill.group(1)) if spill else None,
                        "spill_loads": int(spill.group(2)) if spill else None}
    for func in re.split(r"\n\s+Function : ", sass)[1:]:
        head = func.split("\n", 1)[0]
        name = next((v for k, v in NAMES.items() if k in head), head)
        used = [int(r) for r in re.findall(r"\bR(\d+)\b", func)]
        report.setdefault(name, {})["highest_register"] = max(used,
                                                              default=None)
        report[name]["usetmaxreg"] = "USETMAXREG" in func
    print(json.dumps(report, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
