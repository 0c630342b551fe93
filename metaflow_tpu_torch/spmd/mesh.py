"""Device meshes and parallelism presets: the JAX package's MeshSpec over
torch.distributed's DeviceMesh.

A mesh names the axes the ranks of a process group are laid out on, one
rank (and one card) per mesh position. Canonical axis names, outermost
first, as in the JAX package:

    data      pure data parallelism (gradient all-reduce)
    fsdp      data parallelism with sharded params/optimizer (ZeRO-3 style)
    expert    expert parallelism for MoE layers
    sequence  context/sequence parallelism (ring attention)
    tensor    tensor (megatron-style) model parallelism
    pipeline  pipeline stages

The port trains on the `data` and `fsdp` axes; a mesh with any other axis
larger than 1 raises NotImplementedError naming its ROADMAP item.
"""

import math
from dataclasses import dataclass, field
from typing import Dict

AXIS_ORDER = ("pipeline", "data", "fsdp", "expert", "sequence", "tensor")

# the axes the port shards over, and the ROADMAP item of each other axis
SUPPORTED_AXES = ("data", "fsdp")
UNPORTED_AXES = {
    "sequence": "ROADMAP.md, slice 5, multi-GPU: sequence shards per rank",
    "tensor": "ROADMAP.md, slice 5, multi-GPU: the tensor axis",
    "expert": "ROADMAP.md, slice 5, multi-GPU: gmm_ep",
    "pipeline": "ROADMAP.md, slice 5, pipelines",
}


@dataclass(frozen=True)
class MeshSpec:
    """Sizes for each mesh axis; -1 means 'absorb remaining devices'."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolved(self, n_devices):
        sizes = {k: v for k, v in self.axes.items() if v not in (None, 1)}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("Only one axis may be -1, got %s" % wild)
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    "%d devices not divisible by fixed axes %s"
                    % (n_devices, sizes)
                )
            sizes[wild[0]] = n_devices // fixed
        else:
            if fixed != n_devices:
                raise ValueError(
                    "Mesh %s needs %d devices but %d are available"
                    % (sizes, fixed, n_devices)
                )
        # canonical ordering, dropping size-1 axes
        return {k: sizes[k] for k in AXIS_ORDER if sizes.get(k, 1) > 1} or {
            "data": n_devices
        }

    # ---- presets ----

    @staticmethod
    def dp():
        return MeshSpec({"data": -1})

    @staticmethod
    def fsdp():
        return MeshSpec({"fsdp": -1})

    @staticmethod
    def fsdp_tp(tensor):
        return MeshSpec({"fsdp": -1, "tensor": tensor})

    @staticmethod
    def dp_tp(tensor):
        return MeshSpec({"data": -1, "tensor": tensor})

    @staticmethod
    def moe(expert, tensor=1):
        return MeshSpec({"fsdp": -1, "expert": expert, "tensor": tensor})

    @staticmethod
    def long_context(sequence, tensor=1):
        return MeshSpec({"fsdp": -1, "sequence": sequence, "tensor": tensor})

    @staticmethod
    def pipelined(pipeline, tensor=1):
        return MeshSpec({"pipeline": pipeline, "fsdp": -1, "tensor": tensor})


class Mesh:
    """Named axes over the ranks of the default process group: the port's
    counterpart of jax.sharding.Mesh. `shape` maps each axis name to its
    size in AXIS_ORDER, as the JAX mesh's does; `device_mesh` is the
    torch.distributed DeviceMesh the collectives run on (None for a mesh
    that only names sizes, which the rule tables accept), `device` this
    rank's device."""

    def __init__(self, shape, device_mesh=None, device=None):
        self.shape = dict(shape)
        self.device_mesh = device_mesh
        self.device = device

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self):
        return math.prod(self.shape.values())

    def group(self, axis):
        """The process group of this rank's line along `axis`."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis):
        """This rank's index along `axis`."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, self.device)


def check_supported(shape):
    """Raise NotImplementedError for an axis the port does not shard over
    that is larger than 1."""
    for axis, size in shape.items():
        if size > 1 and axis not in SUPPORTED_AXES:
            raise NotImplementedError(
                "mesh axis %r of size %d: the port shards over %s only "
                "(%s)" % (axis, size, " and ".join(SUPPORTED_AXES),
                          UNPORTED_AXES.get(axis, "ROADMAP.md, slice 5")))


def create_mesh(spec=None, device="cuda", n_devices=None):
    """A Mesh from a MeshSpec (or axis dict) over every rank of the
    default process group, one rank per position in row-major order of
    the axes (AXIS_ORDER). Where no group exists yet (one process, or a
    gang of one rank, which gets none), a group of this one rank is made
    first: on the card it is a real NCCL group of one.

    device: "cuda" (this rank's current card; raises without one) or
    "cpu" (gloo), as the rest of the port's entry points take it.
    n_devices, where given, must be the group's size: a mesh spans the
    whole group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from .device import resolve_device
    from .distributed import ensure_group

    device = resolve_device(device)

    ensure_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError("a mesh spans the whole process group: %d ranks, "
                         "not %d" % (world, n_devices))
    if spec is None:
        spec = MeshSpec.dp()
    if isinstance(spec, dict):
        spec = MeshSpec(spec)
    sizes = spec.resolved(world)
    check_supported(sizes)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    device_mesh = init_device_mesh(device.type, tuple(sizes.values()),
                                   mesh_dim_names=tuple(sizes))
    return Mesh(sizes, device_mesh, device)


def create_hybrid_mesh(ici_spec, dcn_axis="data", num_slices=None,
                       devices=None):
    """The JAX package's multi-slice mesh; not ported."""
    raise NotImplementedError(
        "create_hybrid_mesh is not ported (ROADMAP.md, slice 5, multi-GPU: "
        "create_hybrid_mesh)")


def mesh_axis_size(mesh, name):
    return mesh.shape.get(name, 1)


def data_axes(mesh):
    """Axes over which the batch dimension is split."""
    return tuple(a for a in ("data", "fsdp") if a in mesh.axis_names)


def batch_sharding(mesh):
    """The spec of [batch, ...] inputs: batch over the data axes."""
    axes = data_axes(mesh)
    return (axes if axes else None,)


def batch_group(mesh):
    """The process group of every rank the batch is split over: the whole
    group, since every axis of a mesh the port trains on is a data axis."""
    import torch.distributed as dist

    check_supported(mesh.shape)
    return dist.group.WORLD
