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


def library_path(name, csrc=None, build_dir=None):
    """The source of `name` and its library's path, keyed by a hash of the
    source, the shared headers of csrc/ and the flags (csrc and build_dir
    default to the package's)."""
    csrc, build_dir = csrc or CSRC, build_dir or BUILD_DIR
    src = csrc / (name + ".cu")
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, build_dir / ("lib%s-%s.so" % (name, h.hexdigest()[:16]))


def start_builds(names, csrc=None, build_dir=None):
    """Start one nvcc for each library of `names` (from csrc into
    build_dir, the package's by default) that is not built yet; returns
    the jobs for finish_builds."""
    jobs = []
    for name in names:
        src, out = library_path(name, csrc, build_dir)
        if (csrc is None and name in _LOADED) or out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".%d.tmp" % os.getpid())
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, src, out, tmp, proc, time.perf_counter(),
                     csrc is None))
    return jobs


def finish_builds(jobs):
    """Wait for the nvcc runs of start_builds; raises if any failed."""
    failed = []
    for name, src, out, tmp, proc, start, package in jobs:
        log = proc.communicate()[0]
        if package:  # what build_info reports for the package's library
            _BUILT[name] = {"built": True, "log": log,
                            "seconds": time.perf_counter() - start}
        if proc.returncode != 0:
            failed.append("nvcc failed on %s:\n%s" % (src, log))
        else:
            out.with_name(out.name + ".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_all(names):
    """Build the libraries of `names` that are not built yet, one nvcc per
    source, all started at once. Raises if any nvcc fails."""
    finish_builds(start_builds(names))


def load(name):
    """The ctypes library built from csrc/<name>.cu, building it first if
    this source has not been built. Raises if nvcc fails."""
    if name in _LOADED:
        return _LOADED[name][0]
    src, out = library_path(name)
    if not out.exists():
        build_all([name])
    log = out.with_name(out.name + ".log")
    info = {"path": str(out), "built": False, "seconds": 0.0,
            "log": log.read_text() if log.exists() else ""}
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
    spill report, kept beside the library). Loads the library first."""
    load(name)
    return dict(_LOADED[name][1])
