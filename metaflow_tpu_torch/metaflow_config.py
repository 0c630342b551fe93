"""Layered system configuration.

Reference behavior: metaflow/metaflow_config.py + metaflow_config_funcs
(§5.6): a JSON profile at ~/.tpuflowconfig/config_<profile>.json overridden
by TPUFLOW_* env vars (METAFLOW_* accepted as aliases), plus a per-project
.tpuflow/config.json. `from_conf(name, default)` is the single lookup point.
"""

import json
import os

from . import knobs

_conf_cache = None


def _profile_path():
    profile = knobs.get_str("TPUFLOW_PROFILE")
    home = os.path.expanduser(knobs.get_str("TPUFLOW_HOME"))
    name = "config_%s.json" % profile if profile else "config.json"
    return os.path.join(home, name)


def _load():
    global _conf_cache
    if _conf_cache is not None:
        return _conf_cache
    conf = {}
    # 1. user profile
    try:
        with open(_profile_path()) as f:
            conf.update(json.load(f))
    except (IOError, ValueError):
        pass
    # 2. per-project overrides
    try:
        with open(os.path.join(os.getcwd(), ".tpuflow", "config.json")) as f:
            conf.update(json.load(f))
    except (IOError, ValueError):
        pass
    _conf_cache = conf
    return conf


def reset_conf_cache():
    global _conf_cache
    _conf_cache = None


def from_conf(name, default=None):
    """Lookup order: TPUFLOW_<name> env → METAFLOW_<name> env → profile
    JSON (key with or without the TPUFLOW_ prefix) → default."""
    name = name.upper()
    # prefixed env vars only: a generic SERVICE_URL/DEFAULT_* in the shell
    # must not silently steer the framework
    for env_name in ("TPUFLOW_" + name, "METAFLOW_" + name):
        # empty-string env values count as unset (CI templates often
        # export VAR= to mean "use the default")
        if os.environ.get(env_name):
            return os.environ[env_name]
    conf = _load()
    for key in ("TPUFLOW_" + name, name):
        if key in conf:
            return conf[key]
    return default


def set_conf(name, value, profile_file=None):
    """Persist a key into the profile JSON (configure CLI)."""
    path = profile_file or _profile_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        with open(path) as f:
            conf = json.load(f)
    except (IOError, ValueError):
        conf = {}
    if value is None:
        conf.pop(name.upper(), None)
    else:
        conf[name.upper()] = value
    with open(path, "w") as f:
        json.dump(conf, f, indent=2, sort_keys=True)
    reset_conf_cache()
    return path


# ---- the knobs (resolved lazily where hot paths need current env) ----

def datastore_sysroot_local():
    return from_conf(
        "DATASTORE_SYSROOT_LOCAL",
        os.path.join(os.getcwd(), ".tpuflow"),
    )


def datastore_sysroot_gs():
    return from_conf("DATASTORE_SYSROOT_GS")


def default_datastore():
    return from_conf("DEFAULT_DATASTORE", "local")


def default_metadata():
    return from_conf("DEFAULT_METADATA", "local")


def service_url():
    return from_conf("SERVICE_URL")
