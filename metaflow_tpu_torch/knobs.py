"""The environment knobs the PyTorch port reads.

A copy of the entries of the JAX package's knob registry that the port
needs, with the same names, defaults, types and parse rules:

* unset OR empty-string value -> the default;
* malformed int/float -> the default;
* bool: a set value counts as false only for 0/false/no/off
  (case-insensitive), everything else is true;
* `fallback=` overrides the default at one call site;
* a "path" knob reads as a str.
"""

import os

_UNSET = object()

#: values (lowercased, stripped) that make a *set* bool knob false
_FALSEY = ("0", "false", "no", "off")

# name -> (type, default)
KNOBS = {
    "TPUFLOW_FLASH_BLOCK_Q": ("int", 128),
    "TPUFLOW_FLASH_BLOCK_K": ("int", 128),
    "TPUFLOW_DECODE_CHUNK": ("int", 256),
    # training
    "TPUFLOW_PEAK_TFLOPS": ("float", None),
    # ZeRO-style optimizer-state sharding over the data axis
    "TPUFLOW_ZERO": ("bool", False),
    # knobs whose subsystem the port has not yet: setting one raises
    # (the chaos harness and the collective sanitizer, ROADMAP.md slice 5)
    "TPUFLOW_CHAOS": ("str", ""),
    "TPUFLOW_SANITIZE": ("bool", False),
    # progress beats and the hang deadline (progress.py)
    "TPUFLOW_PROGRESS_EVERY_S": ("float", 1.0),
    "TPUFLOW_HANG_FLOOR_S": ("float", 60.0),
    "TPUFLOW_HANG_DEADLINE_MULT": ("float", 8.0),
    "TPUFLOW_HANG_COMPILE_GRACE_S": ("float", 600.0),
    # datastore and the streamed corpus (data/)
    "TPUFLOW_DATASTORE_SYSROOT_LOCAL": ("str", None),
    "TPUFLOW_STORAGE_TIMEOUT_S": ("float", 0.0),
    "TPUFLOW_DATA_READAHEAD_MB": ("float", 64.0),
    "TPUFLOW_DATA_WORKERS": ("int", 8),
    # serving
    "TPUFLOW_PAGED": ("bool", False),
    "TPUFLOW_KV_PAGE_TOKENS": ("int", 16),
    "TPUFLOW_SPEC_K": ("int", 0),
    "TPUFLOW_PREFIX_CACHE_MB": ("float", 0.0),
    "TPUFLOW_SERVE_LATENCY_WINDOW": ("int", 1024),
    "TPUFLOW_TRACE_REQUESTS": ("bool", True),
    # telemetry
    "TPUFLOW_TELEMETRY": ("bool", True),
    "TPUFLOW_TELEMETRY_FLUSH_EVERY": ("int", 512),
    "TPUFLOW_PROFILE_STEPS": ("str", ""),
    "TPUFLOW_PROFILE_REQUEST": ("str", ""),
    "TPUFLOW_PROFILE_SIGNAL": ("bool", False),
    # tenancy
    "TPUFLOW_TENANT_WEIGHTS": ("str", ""),
    "TPUFLOW_TENANT_PRIORITIES": ("str", ""),
    "TPUFLOW_TENANT_BUDGETS": ("str", ""),
    "TPUFLOW_TENANT_BUDGET_WINDOW_S": ("float", 10.0),
    "TPUFLOW_TENANT_DEFAULT": ("str", "default"),
    "TPUFLOW_TENANT_QUANTUM": ("int", 256),
    "TPUFLOW_CACHE_ROUTE_BLOCK": ("int", 16),
    "TPUFLOW_CACHE_ROUTE_DIGESTS": ("int", 512),
    # config (metaflow_config.py, util.py, cli.py)
    "TPUFLOW_PROFILE": ("str", ""),
    "TPUFLOW_HOME": ("path", "~/.tpuflowconfig"),
    "TPUFLOW_DATASTORE_SYSROOT_GS": ("str", None),
    "TPUFLOW_USER": ("str", None),
    "TPUFLOW_DEBUG": ("bool", False),
    "TPUFLOW_MONITOR": ("str", "file"),
    "TPUFLOW_EVENT_LOGGER": ("str", "file"),
    "TPUFLOW_ARGO_EVENTS_URL": ("str", None),
    # the flow runtime (runtime.py, task.py, plugins/parallel_decorator.py)
    "TPUFLOW_FORK_WORKERS": ("bool", True),
    "TPUFLOW_GANG_FINALIZE_TIMEOUT": ("float", 300.0),
    "TPUFLOW_GANG_NODE_WAIT_TIMEOUT_S": ("float", 0.0),
    "TPUFLOW_QUEUE_TS": ("float", None),
    "TPUFLOW_TRIGGER_EVENTS": ("str", None),
    # knobs of the flow runtime's subsystems the port has not yet (the
    # elastic supervisor, the hang watchdog, the strict pre-run analysis):
    # setting one true raises (runtime.py)
    "TPUFLOW_ELASTIC": ("bool", True),
    "TPUFLOW_HANG_DETECT": ("bool", True),
    "TPUFLOW_STRICT_CHECK": ("bool", False),
    # artifact datastore (datastore/, client/)
    "TPUFLOW_BLOB_CACHE": ("bool", True),
    "TPUFLOW_PERSIST_PIPELINE": ("bool", True),
    "TPUFLOW_PERSIST_WORKERS": ("int", None),
    "TPUFLOW_PERSIST_UPLOADS": ("int", None),
    "TPUFLOW_PERSIST_INFLIGHT_MB": ("int", 0),
    "TPUFLOW_CLIENT_CACHE": ("path", None),
    # accelerator steps (plugins/gpu/)
    "TPUFLOW_TPU_LAUNCHER": ("str", None),
    "TPUFLOW_SPOT_MARKER_TTL_S": ("float", 900.0),
    "TPUFLOW_SPOT_METADATA_URL": (
        "str", "http://metadata.google.internal/computeMetadata/v1/"
        "instance/preempted"),
}


def _default(name, fallback):
    if name not in KNOBS:
        raise KeyError("unregistered knob %r" % (name,))
    return KNOBS[name][1] if fallback is _UNSET else fallback


def _raw(name, env):
    value = (env if env is not None else os.environ).get(name)
    if value is None or value == "":
        return None
    return value


def is_set(name, env=None):
    """True when the knob has a non-empty value in the environment."""
    _default(name, _UNSET)
    return _raw(name, env) is not None


def get_raw(name, env=None):
    """The raw string value ('' and unset both -> None)."""
    _default(name, _UNSET)
    return _raw(name, env)


def get_str(name, env=None, fallback=_UNSET):
    default = _default(name, fallback)
    value = _raw(name, env)
    return default if value is None else value


def get_bool(name, env=None, fallback=_UNSET):
    default = _default(name, fallback)
    value = _raw(name, env)
    if value is None:
        return default
    return value.strip().lower() not in _FALSEY


def get_int(name, env=None, fallback=_UNSET):
    default = _default(name, fallback)
    value = _raw(name, env)
    if value is None:
        return default
    try:
        return int(float(value))
    except (TypeError, ValueError):
        return default


def get_float(name, env=None, fallback=_UNSET):
    default = _default(name, fallback)
    value = _raw(name, env)
    if value is None:
        return default
    try:
        return float(value)
    except (TypeError, ValueError):
        return default
