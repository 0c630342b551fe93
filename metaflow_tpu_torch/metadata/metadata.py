"""Metadata provider ABC + MetaDatum model.

Reference behavior: metaflow/metadata_provider/metadata.py (abstract provider:
register_run_id / register_task_id / register_metadata / heartbeats). The
local JSON provider is the default; a REST service provider can be added with
the same interface.
"""

import time
from collections import namedtuple

# field: name, value: str, type: str, tags: list of strings
MetaDatum = namedtuple("MetaDatum", "field value type tags")


class MetadataProvider(object):
    TYPE = None

    def __init__(self, environment=None, flow=None, event_logger=None, monitor=None):
        self._environment = environment
        self._flow = flow
        self._event_logger = event_logger
        self._monitor = monitor
        self.flow_name = flow.name if flow is not None else None

    @classmethod
    def compute_info(cls, val):
        """Validate/canonicalize the metadata service location string."""
        return val

    @classmethod
    def default_info(cls):
        return ""

    def version(self):
        return "tpuflow-local"

    def new_run_id(self, tags=None, sys_tags=None):
        raise NotImplementedError

    def register_run_id(self, run_id, tags=None, sys_tags=None):
        raise NotImplementedError

    def new_task_id(self, run_id, step_name, tags=None, sys_tags=None):
        raise NotImplementedError

    def register_task_id(self, run_id, step_name, task_id, attempt=0,
                         tags=None, sys_tags=None):
        raise NotImplementedError

    def register_data_artifacts(self, run_id, step_name, task_id, attempt, artifacts):
        pass

    def register_metadata(self, run_id, step_name, task_id, metadata):
        raise NotImplementedError

    def start_run_heartbeat(self, flow_id, run_id):
        pass

    def start_task_heartbeat(self, flow_id, run_id, step_id, task_id):
        pass

    def stop_heartbeat(self):
        pass

    def add_sticky_tags(self, tags=None, sys_tags=None):
        pass

    @staticmethod
    def sticky_sys_tags(environment, username):
        return [
            "metaflow_version:tpuflow",
            "runtime:dev",
            "user:%s" % username,
            "python_version:%s" % _python_version(),
        ]

    # ---- read side (used by the client) ----

    def get_run_info(self, flow_name, run_id):
        raise NotImplementedError

    def list_runs(self, flow_name):
        raise NotImplementedError

    def get_task_metadata(self, flow_name, run_id, step_name, task_id):
        raise NotImplementedError

    def task_heartbeat_age(self, flow_name, run_id, step_name, task_id):
        """Seconds since the task's last heartbeat, or None if unknown."""
        return None


def _python_version():
    import sys

    return "%d.%d.%d" % sys.version_info[:3]


def timestamp_millis():
    return int(time.time() * 1000)
