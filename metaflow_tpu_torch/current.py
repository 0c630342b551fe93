"""The `current` singleton: per-task runtime info exposed to user step code.

Reference shape: metaflow/metaflow_current.py (Current:15). Decorators inject
extra properties via `current._update_env` (e.g. `current.parallel`,
`current.checkpoint`, `current.gpu`).
"""

from collections import namedtuple

Parallel = namedtuple(
    "Parallel",
    ["main_ip", "num_nodes", "node_index", "control_task_id", "coordinator_port"],
)


class Current(object):
    def __init__(self):
        self._flow_name = None
        self._run_id = None
        self._step_name = None
        self._task_id = None
        self._retry_count = None
        self._origin_run_id = None
        self._namespace = None
        self._username = None
        self._metadata_str = None
        self._is_running = False
        self._tags = ()
        self._env = {}

        def _raise(ex):
            raise ex

        self.__class__.graph = property(fget=lambda self: self._graph_info)
        self._graph_info = None

    def _set_env(
        self,
        flow=None,
        run_id=None,
        step_name=None,
        task_id=None,
        retry_count=None,
        origin_run_id=None,
        namespace=None,
        username=None,
        metadata_str=None,
        is_running=True,
        tags=None,
    ):
        if flow is not None:
            self._flow = flow
            self._flow_name = flow.name
            self._graph_info = flow._graph_info
        self._run_id = run_id
        self._step_name = step_name
        self._task_id = task_id
        self._retry_count = retry_count
        self._origin_run_id = origin_run_id
        self._namespace = namespace
        self._username = username
        self._metadata_str = metadata_str
        self._is_running = is_running
        if tags is not None:
            self._tags = tuple(tags)

    def _update_env(self, env_vars):
        """Decorators register additional `current.<name>` attributes here."""
        for k, v in env_vars.items():
            self._env[k] = v
            setattr(self.__class__, k, property(fget=lambda _self, _v=v: _v))

    def __contains__(self, key):
        return getattr(self, key, None) is not None

    def get(self, key, default=None):
        return getattr(self, key, default)

    @property
    def is_running_flow(self):
        return self._is_running

    @property
    def flow_name(self):
        return self._flow_name

    @property
    def run_id(self):
        return self._run_id

    @property
    def step_name(self):
        return self._step_name

    @property
    def task_id(self):
        return self._task_id

    @property
    def retry_count(self):
        return self._retry_count

    @property
    def origin_run_id(self):
        return self._origin_run_id

    @property
    def pathspec(self):
        if None in (self._flow_name, self._run_id, self._step_name, self._task_id):
            return None
        return "/".join(
            (self._flow_name, self._run_id, self._step_name, self._task_id)
        )

    @property
    def namespace(self):
        return self._namespace

    @property
    def username(self):
        return self._username

    @property
    def tags(self):
        return self._tags


current = Current()
