"""Logical-axis sharding: parameters carry semantic axis names, a rule
table maps them onto mesh axes, and the placements follow: the JAX
package's rule tables and ZeRO specs, over torch.distributed.

A spec is the port's PartitionSpec: a tuple with one entry per tensor
dimension, each None (replicated), a mesh axis name, or a tuple of axis
names (major first), so a spec compares one for one with the JAX one
(`tuple(PartitionSpec(...))`). A sharded tensor of the train state is a
DTensor whose placements come from its spec (`placements`): Shard(d) on
each mesh axis that dimension d is split over, Replicate() on the others.
The compute path works on each rank's local block and moves blocks with
explicit collectives (spmd/collectives.py); no DTensor reaches a kernel
or an autograd Function.
"""

import math

import torch

from .collectives import all_gather, all_reduce, reduce_scatter

# rule tables: logical axis name -> mesh axis (None = replicate).
# 'fsdp' shards the *parameter* dim that is largest/most even; 'tensor'
# shards the dim contracted inside the layer (megatron pattern).

FSDP_RULES = {
    "vocab": None,
    "embed": "fsdp",
    "mlp": None,
    "heads": None,
    "kv_heads": None,
    "head_dim": None,
    "qkv": None,
    "layers": None,
    "expert": None,
    "batch": ("data", "fsdp"),
    "seq": None,
}

FSDP_TP_RULES = {
    "vocab": "tensor",
    "embed": "fsdp",
    "mlp": "tensor",
    "heads": "tensor",
    "kv_heads": "tensor",
    "head_dim": None,
    "qkv": "tensor",
    "layers": None,
    "expert": None,
    "batch": ("data", "fsdp"),
    "seq": None,
}

MOE_RULES = dict(FSDP_TP_RULES, expert="expert")

LONG_CONTEXT_RULES = dict(FSDP_TP_RULES, seq="sequence")


def rules_for_mesh(mesh):
    """Pick the most specific rule table for the mesh's axes."""
    axes = set(mesh.axis_names)
    if "expert" in axes:
        rules = dict(MOE_RULES)
    elif "sequence" in axes:
        rules = dict(LONG_CONTEXT_RULES)
    elif "tensor" in axes:
        rules = dict(FSDP_TP_RULES)
    else:
        rules = dict(FSDP_RULES)

    # drop references to axes the mesh doesn't have
    def _filter(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            kept = tuple(a for a in v if a in axes)
            return kept or None
        return v if v in axes else None

    return {k: _filter(v) for k, v in rules.items()}


def spec_for(logical_axes, rules):
    """Map a tuple of logical axis names to a spec."""
    used = set()
    parts = []
    for name in logical_axes:
        axis = rules.get(name)
        if axis is None:
            parts.append(None)
            continue
        flat = axis if isinstance(axis, tuple) else (axis,)
        flat = tuple(a for a in flat if a not in used)
        used.update(flat)
        if not flat:
            parts.append(None)
        elif len(flat) == 1:
            parts.append(flat[0])
        else:
            parts.append(flat)
    return tuple(parts)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _tree_map(fn, tree, *rest, is_leaf=None):
    """fn over the leaves of nested dicts (and the matching leaves of
    `rest`); a leaf is any non-dict, or what is_leaf accepts."""
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_specs(logical_tree, rules):
    """Map a tree of logical-axis tuples to a tree of specs."""
    return _tree_map(lambda axes: spec_for(axes, rules), logical_tree)


def entry_axes(entry):
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec):
    """Every mesh axis a spec names."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def placements(spec, mesh):
    """The DTensor placements of `spec` on `mesh`: for each mesh axis in
    the mesh's order, Shard(d) where dimension d is split over it, else
    Replicate(). A dimension split over several axes lists them in the
    mesh's order, the order DTensor nests its shards in."""
    from torch.distributed.tensor import Replicate, Shard

    order = list(mesh.axis_names)
    out = [Replicate() for _ in order]
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        idx = [order.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError("spec %s splits dimension %d over %s, against "
                             "the mesh's order %s" % (spec, dim, axes, order))
        for i in idx:
            out[i] = Shard(dim)
    return out


def spec_of(tensor, mesh):
    """The spec a DTensor's placements stand for (a plain tensor's is
    replicated)."""
    spec = [[] for _ in range(tensor.dim())]
    for axis, p in zip(mesh.axis_names, getattr(tensor, "placements", ())):
        if p.is_shard():
            spec[p.dim].append(axis)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in spec)


class NamedSharding:
    """A spec on a mesh: the port's jax.sharding.NamedSharding."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, tuple(spec)

    @property
    def placements(self):
        return placements(self.spec, self.mesh)

    def __repr__(self):
        return "NamedSharding(%s, %s)" % (self.mesh.shape, self.spec)


def tree_shardings(logical_tree, mesh, rules=None):
    rules = rules or rules_for_mesh(mesh)
    return _tree_map(lambda spec: NamedSharding(mesh, spec),
                     tree_specs(logical_tree, rules), is_leaf=_is_axes)


class Layout:
    """How one tensor lies on a mesh: its global shape and its spec. The
    optimizers read a leaf's layout to sum a statistic over every shard
    of the dimensions it was taken over."""

    def __init__(self, mesh, spec, shape):
        shape = tuple(shape)
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        for dim, entry in enumerate(spec):
            n = math.prod(mesh.shape[a] for a in entry_axes(entry))
            if shape[dim] % n:
                raise ValueError(
                    "dimension %d of %s cannot be split %d ways (%s)"
                    % (dim, shape, n, entry))
        self.mesh, self.spec, self.shape = mesh, spec, shape

    def axes(self, dims):
        """The mesh axes larger than 1 that split any of `dims`."""
        return tuple(a for d in dims for a in entry_axes(self.spec[d])
                     if self.mesh.shape[a] > 1)

    def local_shape(self):
        return tuple(
            n // math.prod(self.mesh.shape[a] for a in entry_axes(e))
            for n, e in zip(self.shape, self.spec))

    def drop(self, dim):
        """The layout of a reduction of this tensor over `dim`."""
        keep = [d for d in range(len(self.shape)) if d != dim]
        return Layout(self.mesh, [self.spec[d] for d in keep],
                      [self.shape[d] for d in keep])

    def sum(self, t, dims):
        """t, a sum over this rank's block of `dims`, summed in place over
        every rank that holds another block of them."""
        for axis in self.axes(dims):
            all_reduce(t, self.mesh.group(axis))
        return t

    def local(self, full):
        """This rank's block of the global tensor `full`, a contiguous
        copy."""
        return local_block(full, self.spec, self.mesh)

    def dtensor(self, local):
        """`local`, this rank's block, as a DTensor of this layout."""
        from torch.distributed.tensor import DTensor

        stride = [1] * len(self.shape)
        for d in range(len(self.shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * self.shape[d + 1]
        return DTensor.from_local(local, self.mesh.device_mesh,
                                  placements(self.spec, self.mesh),
                                  run_check=False, shape=self.shape,
                                  stride=tuple(stride))


def _block_index(entry, mesh):
    """(index, count) of this rank's block along a dimension split over
    the axes of `entry`, major first."""
    index, count = 0, 1
    for axis in entry_axes(entry):
        size = mesh.shape[axis]
        index = index * size + (mesh.coordinate(axis) if size > 1 else 0)
        count *= size
    return index, count


def local_block(full, spec, mesh):
    """This rank's block of a global tensor under `spec`, as a contiguous
    copy (never a view, so the global tensor can be freed)."""
    out = full
    for dim, entry in enumerate(spec):
        index, count = _block_index(entry, mesh)
        if count > 1:
            size = out.shape[dim] // count
            out = out.narrow(dim, index * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, logical_tree, mesh, rules=None):
    """Place a tree of global tensors per its logical axes: each leaf
    becomes a DTensor holding this rank's block."""
    rules = rules or rules_for_mesh(mesh)
    specs = tree_specs(logical_tree, rules)
    return _tree_map(
        lambda x, spec: Layout(mesh, spec, x.shape).dtensor(
            local_block(x, spec, mesh)), tree, specs)


def constrain(x, logical_axes, mesh, rules=None):
    """Re-place x (a DTensor, or a global tensor every rank holds) onto
    the spec of its logical axes."""
    rules = rules or rules_for_mesh(mesh)
    spec = spec_for(logical_axes, rules)
    if hasattr(x, "redistribute"):
        return x.redistribute(mesh.device_mesh, placements(spec, mesh))
    return Layout(mesh, spec, x.shape).dtensor(local_block(x, spec, mesh))


# ---------------------------------------------------------------------------
# ZeRO-style cross-replica weight-update sharding ("Automatic Cross-Replica
# Sharding of Weight Update in Data-Parallel Training").
#
# Data parallelism replicates the weight update N times. The transform
# below re-specs grads, params and optimizer state over the pure-DP mesh
# axis inside the update only:
#
#     grad reduce-scatter -> 1/N-sharded optimizer update -> param all-gather
#
# The 'fsdp' axis needs none of this: its rule table already shards
# params/state at rest (ZeRO-3). Only the 'data' axis replicates the
# update, so that is the only axis zero_update_axis ever returns.

ZERO_ENV = "TPUFLOW_ZERO"


def zero_update_axis(mesh):
    """The mesh axis the weight update shards over, or None: 'data' iff
    the mesh has a data axis of size > 1."""
    return "data" if mesh.shape.get("data", 1) > 1 else None


def zero_enabled(mesh, zero=None):
    """Resolve the sharded-update switch: explicit arg wins, else the
    TPUFLOW_ZERO env knob; always off when the mesh has no DP axis to
    shard over."""
    if zero is None:
        from .. import knobs

        zero = knobs.get_bool(ZERO_ENV)
    return bool(zero) and zero_update_axis(mesh) is not None


def zero_spec(spec, shape, mesh, axis=None):
    """Extend one leaf's spec for the sharded update: the largest dim
    still unsharded in `spec` and divisible by the DP-axis size gets the
    DP axis (ties -> lowest index). Leaves with no such dim keep their
    spec (their update stays replicated); leaves already touching the DP
    axis are left alone. The rule is deterministic, so every rank picks
    the same dim and a checkpoint restores onto the layout it was saved
    from."""
    axis = axis or zero_update_axis(mesh)
    if axis is None:
        return spec
    size = mesh.shape[axis]
    ndim = len(shape)
    parts = list(spec) + [None] * (ndim - len(spec))
    if axis in spec_axes(parts):
        return spec
    best = None
    for i in range(ndim):
        if parts[i] is None and shape[i] > 0 and shape[i] % size == 0:
            if best is None or shape[i] > shape[best]:
                best = i
    if best is None:
        return spec
    parts[best] = axis
    return tuple(parts)


def zero_tree_specs(tree, mesh, axis=None, base_specs=None):
    """Per-leaf zero specs for a tree of tensors (or anything with a
    .shape). base_specs: a matching tree of base specs (e.g. the rule
    table's for a param tree); by default each leaf's live spec (a
    DTensor's placements, else replicated)."""
    axis = axis or zero_update_axis(mesh)
    if base_specs is None:
        base_specs = _tree_map(lambda leaf: spec_of(leaf, mesh), tree)
    return _tree_map(
        lambda leaf, sp: zero_spec(sp, tuple(leaf.shape), mesh, axis=axis),
        tree, base_specs)


def zero_tree_shardings(tree, mesh, axis=None, base_specs=None):
    """NamedShardings of zero_tree_specs: the placement of the optimizer
    state."""
    return _tree_map(
        lambda sp: NamedSharding(mesh, sp),
        zero_tree_specs(tree, mesh, axis=axis, base_specs=base_specs),
        is_leaf=_is_axes)


def _zero_dim(spec, axis):
    for dim, entry in enumerate(spec):
        if axis in entry_axes(entry):
            return dim
    return None


def zero_constrain(tree, mesh, specs, phase):
    """Move a tree of local blocks between the base placement (whole along
    the DP axis) and the zero specs `specs` (split along it), leaf by
    leaf: `reduce_scatter` sums per-rank partial gradients and keeps this
    rank's part, `shard` keeps this rank's part of a replicated tensor,
    `all_gather` and `unshard` rebuild the whole from the parts. A leaf
    whose zero spec names no DP axis passes through (reduce_scatter then
    all-reduces it)."""
    axis = zero_update_axis(mesh)
    group = mesh.group(axis) if axis else None

    def move(x, spec):
        dim = _zero_dim(spec, axis) if axis else None
        if phase == "reduce_scatter":
            if dim is None:
                return all_reduce(x, group) if group is not None else x
            return reduce_scatter(x, dim, group)
        if dim is None:
            return x
        if phase == "shard":
            size = x.shape[dim] // mesh.shape[axis]
            return x.narrow(dim, mesh.coordinate(axis) * size,
                            size).clone(memory_format=torch.contiguous_format)
        if phase in ("all_gather", "unshard"):
            return all_gather(x, dim, group)
        raise ValueError("zero_constrain phase %r: reduce_scatter, shard, "
                         "all_gather or unshard" % phase)

    return _tree_map(move, tree, specs)
