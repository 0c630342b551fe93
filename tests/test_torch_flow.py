"""The port's flow layer held to the JAX package's: the same flow text,
rendered for each package by one substitution (metaflow_tpu ->
metaflow_tpu_torch), runs through each package's `python flow.py run`,
and the runs must agree artifact for artifact (compared exactly: plain
values by ==, tensors and arrays bit for bit after a cast to numpy).
The JAX package runs with TPUFLOW_ELASTIC=0, TPUFLOW_HANG_DETECT=0 and
TPUFLOW_ANALYZE=0, the paths the port takes.

Each package's client reads the other's runs too (a bf16 tensor and a
pytree of tensors among the artifacts), a num_parallel=2 gang forms a
gloo process group, and the port's guards (the fork guard, @gpu without
a card, the knobs of the subsystems it has not yet) hold.
"""

import importlib
import os
import sys
import textwrap

import numpy as np
import pytest
import torch

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

PKGS = {"ref": "metaflow_tpu", "port": "metaflow_tpu_torch"}
# the JAX package's paths that the port takes (it has no elastic
# supervisor, hang watchdog or pre-run analysis yet)
REF_ENV = {"TPUFLOW_ELASTIC": "0", "TPUFLOW_HANG_DETECT": "0",
           "TPUFLOW_ANALYZE": "0"}

LINEAR = '''
from metaflow_tpu import FlowSpec, JSONType, Parameter, current, step

# True in the port's rendering of this text
PORT = "metaflow_tpu".endswith("_torch")


def tensors():
    """A bf16 tensor and a pytree of tensors: torch in the port, numpy
    (ml_dtypes bf16) in the JAX package; the same values."""
    vals = [[0.5, -1.25, 3.0], [2.0, 0.0, -0.75]]
    if PORT:
        import torch

        t = torch.tensor(vals, dtype=torch.float32).to(torch.bfloat16)
        tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": (torch.tensor([1, 2, 3], dtype=torch.int32),
                      torch.tensor([True, False])),
                "n": 7}
    else:
        import ml_dtypes
        import numpy as np

        t = np.asarray(vals, np.float32).astype(ml_dtypes.bfloat16)
        tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                "b": (np.asarray([1, 2, 3], np.int32),
                      np.asarray([True, False])),
                "n": 7}
    return t, tree


class LinearFlow(FlowSpec):
    alpha = Parameter("alpha", default=0.5, type=float)
    count = Parameter("count", default=3, type=int)
    tag = Parameter("tag", default="plain")
    config = Parameter("config", default={"lr": 0.1}, type=JSONType)

    @step
    def start(self):
        self.x = [self.alpha * i for i in range(self.count)]
        self.name_seen = current.flow_name
        self.bf16, self.tree = tensors()
        self.next(self.middle)

    @step
    def middle(self):
        self.y = {"sum": sum(self.x), "tag": self.tag,
                  "lr": self.config["lr"]}
        self.retry_count_seen = current.retry_count
        self.next(self.end)

    @step
    def end(self):
        self.total = self.y["sum"] * 2


if __name__ == "__main__":
    LinearFlow()
'''

BRANCH = '''
from metaflow_tpu import FlowSpec, step


class BranchFlow(FlowSpec):
    @step
    def start(self):
        self.base = 10
        self.shared = "same"
        self.next(self.left, self.right)

    @step
    def left(self):
        self.value = self.base + 1
        self.side = "left"
        self.next(self.join)

    @step
    def right(self):
        self.value = self.base + 2
        self.side = "right"
        self.next(self.join)

    @step
    def join(self, inputs):
        self.values = sorted(inp.value for inp in inputs)
        self.by_name = [inputs.left.side, inputs.right.side]
        self.merge_artifacts(inputs, exclude=["value", "side"])
        self.next(self.end)

    @step
    def end(self):
        self.total = sum(self.values) + self.base


if __name__ == "__main__":
    BranchFlow()
'''

FOREACH = '''
from metaflow_tpu import FlowSpec, step


class ForeachFlow(FlowSpec):
    @step
    def start(self):
        self.items = ["a", "bb", "ccc"]
        self.next(self.outer, foreach="items")

    @step
    def outer(self):
        self.word = self.input
        self.reps = list(range(len(self.input)))
        self.next(self.inner, foreach="reps")

    @step
    def inner(self):
        self.piece = "%s%d" % (self.word, self.input)
        self.depth = [f[0] for f in self.foreach_stack()]
        self.next(self.inner_join)

    @step
    def inner_join(self, inputs):
        self.pieces = [inp.piece for inp in inputs]
        self.word = inputs[0].word
        self.next(self.outer_join)

    @step
    def outer_join(self, inputs):
        self.all_pieces = [inp.pieces for inp in inputs]
        self.words = [inp.word for inp in inputs]
        self.next(self.end)

    @step
    def end(self):
        self.n = sum(len(p) for p in self.all_pieces)


if __name__ == "__main__":
    ForeachFlow()
'''

RETRY_CATCH = '''
from metaflow_tpu import FlowSpec, catch, current, retry, step


class RetryCatchFlow(FlowSpec):
    @step
    def start(self):
        self.next(self.flaky, self.doomed)

    @retry(times=2, minutes_between_retries=0)
    @step
    def flaky(self):
        # fails on the first attempt, succeeds on the retry
        if current.retry_count == 0:
            raise RuntimeError("flaky failure")
        self.attempt = current.retry_count
        self.next(self.join)

    @catch(var="failure", print_exception=False)
    @step
    def doomed(self):
        raise ValueError("always fails")
        self.next(self.join)  # noqa: unreachable, @catch re-derives it

    @step
    def join(self, inputs):
        self.attempt = inputs.flaky.attempt
        self.failure = inputs.doomed.failure
        self.next(self.end)

    @step
    def end(self):
        self.failure_type = self.failure.type


if __name__ == "__main__":
    RetryCatchFlow()
'''

GANG = '''
from metaflow_tpu import FlowSpec, current, step

PORT = "metaflow_tpu".endswith("_torch")


class GangFlow(FlowSpec):
    @step
    def start(self):
        self.base = 100
        self.next(self.train, num_parallel=2)

    @step
    def train(self):
        p = current.parallel
        self.rank = p.node_index
        self.world = p.num_nodes
        self.main_ip = p.main_ip
        self.same_port = p.coordinator_port > 0
        self.value = self.base + self.rank
        if PORT:
            # the port's gang is a torch.distributed process group
            import torch
            import torch.distributed as dist

            t = torch.tensor([float(self.value)])
            dist.all_reduce(t)
            self.group = [dist.get_backend(), dist.get_rank(),
                          dist.get_world_size(), float(t.item())]
        self.next(self.join)

    @step
    def join(self, inputs):
        self.ranks = sorted(inp.rank for inp in inputs)
        self.values = sorted(inp.value for inp in inputs)
        self.worlds = sorted(inp.world for inp in inputs)
        self.ips = sorted(set(inp.main_ip for inp in inputs))
        if PORT:
            self.groups = sorted(inp.group for inp in inputs)
        self.next(self.end)

    @step
    def end(self):
        pass


if __name__ == "__main__":
    GangFlow()
'''

GPU = '''
from metaflow_tpu import FlowSpec, current, gpu, step


class GpuFlow(FlowSpec):
    @step
    def start(self):
        self.next(self.train)

    @gpu(topology="1xH100", mesh={"data": 1})
    @step
    def train(self):
        g = current.gpu
        self.info = [g.num_devices, g.device_kind, g.topology, g.mesh_axes]
        self.next(self.end)

    @step
    def end(self):
        pass


class RequireGpuFlow(FlowSpec):
    @step
    def start(self):
        self.next(self.train)

    @gpu(require_gpu=True)
    @step
    def train(self):
        self.ran = True
        self.next(self.end)

    @step
    def end(self):
        pass


if __name__ == "__main__":
    import os

    {"GpuFlow": GpuFlow, "RequireGpuFlow": RequireGpuFlow}[
        os.environ["FLOW_CLASS"]]()
'''

FLOWS = {"linear": ("LinearFlow", LINEAR,
                    ["--alpha", "0.25", "--count", "4",
                     "--config", '{"lr": 0.5}']),
         "branch": ("BranchFlow", BRANCH, []),
         "foreach": ("ForeachFlow", FOREACH, []),
         "retry_catch": ("RetryCatchFlow", RETRY_CATCH, [])}


def render(template, pkg, tmp_path, name):
    """The flow text for one package, written to <tmp>/<pkg>/<name>.py."""
    path = tmp_path / pkg / ("%s.py" % name)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(template).replace("metaflow_tpu", pkg))
    return str(path)


def run_both(run_flow, tmp_path, template, name, args=(), env=None):
    """Run the flow through each package's CLI; {side: run id}."""
    ids = {}
    for side, pkg in PKGS.items():
        path = render(template, pkg, tmp_path, name)
        id_file = tmp_path / ("%s-%s.run_id" % (name, side))
        extra = dict(REF_ENV) if side == "ref" else {}
        extra.update(env or {})
        run_flow(path, "run", "--run-id-file", str(id_file), *args,
                 env_extra=extra)
        ids[side] = id_file.read_text().strip()
    return ids


def client(side):
    mod = importlib.import_module(PKGS[side] + ".client")
    mod.namespace(None)
    return mod


def norm(value):
    """A comparable form: arrays and tensors as (dtype, numpy value),
    caught-exception proxies as (type, repr)."""
    if isinstance(value, torch.Tensor):
        return ("array", str(value.dtype).split(".")[-1],
                value.float().numpy().tolist()
                if value.dtype == torch.bfloat16 else value.numpy().tolist())
    if isinstance(value, np.ndarray):
        return ("array", value.dtype.name,
                value.astype(np.float32).tolist()
                if value.dtype.name == "bfloat16" else value.tolist())
    if hasattr(value, "stacktrace"):
        return ("exception", value.type, value.exception)
    if isinstance(value, dict):
        return {k: norm(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(norm(v) for v in value)
    return value


def snapshot(side, flow_name, run_id):
    """{(step, foreach index path): {"artifacts": {name: norm(value)},
    "successful": bool}} of a run, read through one package's client;
    also the task count of each step."""
    c = client(side)
    run = c.Run("%s/%s" % (flow_name, run_id))
    tasks, counts = {}, {}
    for step_obj in run:
        n = 0
        for task in step_obj:
            n += 1
            stack = task["_foreach_stack"].data or []
            key = (step_obj.id, tuple(int(f[1]) for f in stack))
            assert key not in tasks, key
            tasks[key] = {
                "artifacts": {a.id: norm(a.data) for a in task},
                "successful": task.successful,
            }
        counts[step_obj.id] = n
    return {"tasks": tasks, "counts": counts, "successful": run.successful}


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_same_artifacts(run_flow, tmp_path, name):
    """Per step and foreach index: the same artifact names and values, the
    same task counts and the same successful status; and each package's
    client reads the other's run as its own."""
    flow_name, template, args = FLOWS[name]
    ids = run_both(run_flow, tmp_path, template, name, args)
    own = {side: snapshot(side, flow_name, ids[side]) for side in PKGS}
    assert own["port"] == own["ref"]
    assert own["port"]["successful"]
    # cross reads: the JAX client on the port's run, the port's client on
    # the JAX package's run
    assert snapshot("ref", flow_name, ids["port"]) == own["port"]
    assert snapshot("port", flow_name, ids["ref"]) == own["ref"]
    if name == "linear":
        check_tensor_cross_reads(flow_name, ids)


def check_tensor_cross_reads(flow_name, ids):
    """A bf16 tensor and a pytree of tensors: the port's artifacts read by
    the JAX client as ml_dtypes/numpy arrays, the JAX package's read by
    the port's client as CPU tensors, bit for bit."""
    got = client("ref").Run("%s/%s" % (flow_name, ids["port"]))["start"] \
        .task.data
    assert got.bf16.dtype.name == "bfloat16" and got.bf16.shape == (2, 3)
    assert got.bf16.astype(np.float32).tolist() == \
        [[0.5, -1.25, 3.0], [2.0, 0.0, -0.75]]
    assert got.tree["w"].dtype == np.float32
    assert got.tree["b"][0].dtype == np.int32 and got.tree["n"] == 7
    got = client("port").Run("%s/%s" % (flow_name, ids["ref"]))["start"] \
        .task.data
    assert got.bf16.dtype == torch.bfloat16 and got.bf16.device.type == "cpu"
    assert torch.equal(got.bf16, torch.tensor(
        [[0.5, -1.25, 3.0], [2.0, 0.0, -0.75]]).to(torch.bfloat16))
    assert torch.equal(got.tree["w"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(got.tree["b"][1], torch.tensor([True, False]))


def test_gang(run_flow, tmp_path):
    """num_parallel=2: the same current.parallel facts and join result as
    the JAX package's gang; the port's ranks form one gloo process group
    (rank, world size and an all_reduce of their values)."""
    ids = run_both(run_flow, tmp_path, GANG, "gang")
    joins = {side: client(side).Run("GangFlow/%s" % ids[side])["join"]
             .task.data for side in PKGS}
    for name in ("ranks", "values", "worlds", "ips"):
        assert getattr(joins["port"], name) == getattr(joins["ref"], name)
    assert joins["port"].ranks == [0, 1] and joins["port"].worlds == [2, 2]
    assert joins["port"].groups == [["gloo", 0, 2, 201.0],
                                    ["gloo", 1, 2, 201.0]]
    train = {side: sorted(
        (t.data.rank, t.data.world, t.data.main_ip, t.data.same_port)
        for t in client(side).Run("GangFlow/%s" % ids[side])["train"])
        for side in PKGS}
    assert train["port"] == train["ref"]


@pytest.mark.parametrize("cards", [0, 2])
def test_gang_backend_follows_the_device(cards, monkeypatch):
    """A gang's process group does not depend on the step's decorators:
    where a card is visible it holds NCCL for CUDA tensors and gloo for
    CPU tensors, and each rank takes card node_index % device_count;
    where none is, it is gloo alone and no card is touched."""
    import torch.distributed as dist

    from metaflow_tpu_torch.current import Parallel
    from metaflow_tpu_torch.plugins.gpu import gpu_parallel

    calls = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.setdefault("device", i))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.setdefault("group", kw))
    p = Parallel(main_ip="10.0.0.7", num_nodes=4, node_index=3,
                 control_task_id="t", coordinator_port=29500)
    backend = gpu_parallel.init_gang(p)
    want = "cpu:gloo,cuda:nccl" if cards else "gloo"
    assert backend == want == calls["group"]["backend"]
    assert calls.get("device") == (1 if cards else None)
    assert {k: calls["group"][k] for k in ("init_method", "rank",
                                            "world_size")} == {
        "init_method": "tcp://10.0.0.7:29500", "rank": 3, "world_size": 4}


def _flow_instance(tmp_path, monkeypatch, template, name, class_name):
    """An in-process instance of a rendered port flow (no CLI)."""
    path = render(template, PKGS["port"], tmp_path, name)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    # the graph is parsed from the class's source, found through its module
    monkeypatch.setitem(sys.modules, name, mod)
    spec.loader.exec_module(mod)
    return getattr(mod, class_name)(use_cli=False)


def test_fork_guard(tmp_path, monkeypatch):
    """A plain step forks, unless this process holds a CUDA context (it
    cannot cross fork); a @gpu step is always launched by exec."""
    from metaflow_tpu_torch.runtime import NativeRuntime, _Task

    rt = NativeRuntime.__new__(NativeRuntime)
    rt._flow = _flow_instance(tmp_path, monkeypatch, GPU, "gpu_guard",
                              "GpuFlow")
    monkeypatch.delenv("TPUFLOW_FORK_WORKERS", raising=False)
    plain, on_gpu = _Task("start", "1", []), _Task("train", "2", [])
    assert rt._can_fork(plain)
    assert not rt._can_fork(on_gpu)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert not rt._can_fork(plain)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    monkeypatch.setenv("TPUFLOW_FORK_WORKERS", "0")
    assert not rt._can_fork(plain)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is attached")
def test_gpu_without_card(run_flow, tmp_path):
    """@gpu on a machine without a card: current.gpu reports 0 devices;
    with require_gpu=True the step fails (and does not carry on on the
    CPU), with the JAX package's message shape."""
    path = render(GPU, PKGS["port"], tmp_path, "gpu_flow")
    run_flow(path, "run", env_extra={"FLOW_CLASS": "GpuFlow"})
    info = client("port").Flow("GpuFlow").latest_run["train"].task.data.info
    assert info == [0, "none", "1xH100", {"data": 1}]
    proc = run_flow(path, "run", expect_fail=True,
                    env_extra={"FLOW_CLASS": "RequireGpuFlow"})
    assert ("@gpu(require_gpu=True) on step *train* but no GPU devices are "
            "attached (found: cpu).") in proc.stdout + proc.stderr
    run = client("port").Flow("RequireGpuFlow").latest_run
    assert not run.successful and "ran" not in run["train"].task.data


@pytest.mark.parametrize("knob", ["TPUFLOW_ELASTIC", "TPUFLOW_HANG_DETECT",
                                  "TPUFLOW_STRICT_CHECK"])
def test_refused_knobs(knob, tmp_path, monkeypatch):
    """A knob of a subsystem the port has not yet raises when set true,
    before the run starts; set to 0 (or unset) the run goes on."""
    from metaflow_tpu_torch.runtime import NativeRuntime

    for name in REF_ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("TPUFLOW_STRICT_CHECK", raising=False)
    monkeypatch.setenv(knob, "1")
    with pytest.raises(NotImplementedError, match=knob):
        NativeRuntime(None, None, None, None)
    monkeypatch.setenv(knob, "0")
    with pytest.raises(AttributeError):  # past the refusal: no metadata
        NativeRuntime(None, None, None, None)
    assert os.environ[knob] == "0"
