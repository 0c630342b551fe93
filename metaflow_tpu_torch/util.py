"""Small shared utilities (reference shape: metaflow/util.py)."""

import os
import pwd
import sys
import zlib
import base64
from functools import wraps

from .exception import MetaflowUnknownUser  # noqa: F401  (re-export site)


# resolved ONCE at import time (main thread, pre-fork): fork children must
# not import — a thread holding the import lock at the fork instant would
# deadlock the child before exec
try:
    import ctypes as _ctypes

    _prctl = _ctypes.CDLL(None, use_errno=True).prctl
except Exception:  # non-Linux / restricted: hardening becomes a no-op
    _prctl = None

_PR_SET_PDEATHSIG = 1


def env_int(name, default):
    """int(os.environ[name]) with the default on missing OR malformed
    values — config knobs must degrade to their default, never crash the
    scheduler/loader that reads them."""
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return int(default)


def env_float(name, default):
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return float(default)


def preexec_die_with_parent(expected_ppid=None, sig=9, setsid=False):
    """A Popen preexec_fn arming PR_SET_PDEATHSIG: the kernel signals the
    child the instant its parent dies — no matter how the parent died
    (SIGKILL, OOM, crash), which Python-level cleanup can never cover.

    sig defaults to SIGKILL, deliberately: this is the last-resort edge,
    and a Python-level SIGTERM handler (every task installs the
    preemption handler) only runs at a bytecode boundary — a rank wedged
    inside a collective would never reach one and would hold the
    chips forever. Graceful paths (spot preemption, scheduler teardown)
    signal explicitly; the kernel edge must actually kill.

    expected_ppid closes the inherent race: if the parent died before the
    prctl took effect, the child was already reparented, so exit at once
    (checked on every platform — only the prctl itself is Linux-only).
    setsid=True additionally makes the child a session leader (the
    scheduler's process-group kills rely on it)."""

    def preexec():
        # only already-resolved calls here: the fork child may hold
        # inherited locks no other thread will ever release
        if setsid:
            os.setsid()
        if _prctl is not None:
            _prctl(_PR_SET_PDEATHSIG, sig, 0, 0, 0)
        if expected_ppid is not None and os.getppid() != expected_ppid:
            os._exit(1)  # parent already gone

    return preexec


def get_username():
    """Resolve the current user for namespacing and tags."""
    for var in ("METAFLOW_USER", "TPUFLOW_USER", "SUDO_USER", "USERNAME", "USER"):
        user = os.environ.get(var)
        if user and user != "root":
            return user
    try:
        return pwd.getpwuid(os.getuid()).pw_name
    except Exception:
        return os.environ.get("USER", "unknown")


def resolve_identity():
    return "user:%s" % get_username()


def pathspec(*components):
    return "/".join(str(c) for c in components)


def compress_list(lst, separator=",", zlibmarker="!", zlibmin=500):
    """Encode a list of strings into a single CLI-safe token: the joined
    list, switching to zlib+base64 once it grows past zlibmin (fills the
    same role as the reference's input-path encoding, metaflow/util.py).
    Items must not contain the separator or marker characters."""
    bad = [x for x in lst if separator in x or zlibmarker in x]
    if bad:
        raise RuntimeError("Item(s) %s contain reserved characters" % bad)
    res = separator.join(lst)
    if len(res) < zlibmin:
        return res
    return zlibmarker + base64.b64encode(
        zlib.compress(res.encode("utf-8"))
    ).decode("utf-8")


def decompress_list(lststr, separator=",", zlibmarker="!"):
    if lststr.startswith(zlibmarker):
        lststr = zlib.decompress(
            base64.b64decode(lststr[1:].encode("utf-8"))
        ).decode("utf-8")
    return lststr.split(separator) if lststr else []


def to_unicode(x):
    if isinstance(x, bytes):
        return x.decode("utf-8", errors="replace")
    return str(x)


def to_bytes(x):
    if isinstance(x, bytes):
        return x
    return str(x).encode("utf-8")


def cached_property(fn):
    attr = "_cached_" + fn.__name__

    @wraps(fn)
    def getter(self):
        if not hasattr(self, attr):
            setattr(self, attr, fn(self))
        return getattr(self, attr)

    return property(getter)


def is_stringish(x):
    return isinstance(x, (str, bytes))


def all_equal(it):
    lst = list(it)
    return not lst or lst.count(lst[0]) == len(lst)


def get_tpuflow_root():
    """Root directory for the local datastore/metadata tree (env →
    profile config → ./.tpuflow)."""
    from .metaflow_config import datastore_sysroot_local

    return datastore_sysroot_local()


def write_latest_run_id(flow_name, run_id, root=None):
    root = root or get_tpuflow_root()
    d = os.path.join(root, flow_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "latest_run"), "w") as f:
        f.write(str(run_id))


def read_latest_run_id(flow_name, root=None):
    root = root or get_tpuflow_root()
    try:
        with open(os.path.join(root, flow_name, "latest_run")) as f:
            return f.read().strip()
    except IOError:
        return None


def unicode_to_stream(text, stream=None):
    (stream or sys.stdout).write(to_unicode(text))
