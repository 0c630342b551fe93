"""Unbounded-foreach marker types.

Reference behavior: metaflow/unbounded_foreach.py + flowspec.py ParallelUBF:68.
An unbounded foreach is one whose cardinality the scheduler does not expand
itself: it queues ONE control task which is responsible for the gang (rank
0 of a `torch.distributed` process group, plugins/gpu/gpu_parallel.py)."""

UBF_CONTROL = "ubf_control"
UBF_TASK = "ubf_task"
CONTROL_TASK_TAG = "control_task"


class UnboundedForeachInput(object):
    """Marker base class: a foreach over an instance of this class is
    scheduled as a single control task."""

    NAME = "UnboundedForeachInput"

    def __getitem__(self, item):
        # the control task "indexes" the input with None
        return self


class ParallelUBF(UnboundedForeachInput):
    """Unbounded-foreach behind `self.next(step, num_parallel=N)`."""

    def __init__(self, num_parallel):
        self.num_parallel = num_parallel

    def __getitem__(self, item):
        # the gang rank for workers; the control task passes None
        return item or 0

    def __len__(self):
        return self.num_parallel

    def __repr__(self):
        return "ParallelUBF(%d)" % self.num_parallel
