"""Build a CUDA source of ops/csrc into a shared library and load it.

Each source has a plain C entry point and is bound with ctypes, so the build
is one nvcc call (seconds) and includes no PyTorch header. The library is
built at first use into metaflow_tpu_torch/_build/, under a name keyed by a
hash of the source, the shared headers and the flags, so an edited source
rebuilds and an unchanged one loads at once. `build_all` starts one nvcc
per source at once."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED = {}  # name -> (ctypes.CDLL, build info)
_BUILT = {}  # name -> what this process's nvcc run of it took and said


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    found = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found.append(shutil.which("nvcc"))
    for path in found:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found; set CUDA_HOME to the CUDA toolkit")


def library_path(name):
    """The source of `name` and its library's path, keyed by a hash of the
    source, the shared headers of csrc/ and the flags."""
    src = CSRC / (name + ".cu")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def build_all(names):
    """Build the libraries of `names` that are not built yet, one nvcc per
    source, all started at once. Raises if any nvcc fails."""
    jobs = []
    for name in names:
        src, out = library_path(name)
        if name in _LOADED or out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, out, tmp, proc, start in jobs:
        log = proc.communicate()[0]
        _BUILT[name] = {"built": True, "log": log,
                        "seconds": time.perf_counter() - start}
        if proc.returncode != 0:
            failed.append("nvcc failed on %s:\n%s" % (src.name, log))
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name):
    """The ctypes library built from csrc/<name>.cu, building it first if
    this source has not been built. Raises if nvcc fails."""
    if name in _LOADED:
        return _LOADED[name][0]
    src, out = library_path(name)
    if not out.exists():
        build_all([name])
    info = {"path": str(out), "built": False, "seconds": 0.0, "log": ""}
    info.update(_BUILT.get(name, {}))
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, info)
    return lib


def device_index(t):
    """The index of the CUDA device tensor t lives on, the C entry points'
    `device` argument."""
    import torch

    return (t.device.index if t.device.index is not None
            else torch.cuda.current_device())


def build_info(name):
    """Where the library of `name` came from: path, whether this process
    built it, the build's seconds and nvcc's output (ptxas register and
    spill report). Loads the library first."""
    load(name)
    return dict(_LOADED[name][1])
