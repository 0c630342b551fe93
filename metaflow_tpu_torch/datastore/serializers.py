"""Artifact serializer registry, with tensors first-class: the JAX
package's datastore/serializers.py for torch tensors (after the reference
Metaflow's metaflow/datastore/artifacts/serializer.py: a priority-ordered
registry with pickle as the 9999 fallback).

  - a `torch.Tensor` (or a numpy array) is written in the raw-bytes
    `tensor` format after one device-to-host copy, never through pickle;
  - an exact dict/list/tuple tree of tensors and scalars goes through the
    `pytree` format (a structure header and packed tensor blocks);
  - everything else falls back to `pickle` (highest protocol), with CUDA
    tensors inside moved to the host first.

Each serializer returns (payload bytes, type tag), and deserialization
dispatches on the stored tag. The formats are the JAX package's byte for
byte: bf16 is written as its raw 2-byte words under the dtype name
'bfloat16', which the JAX package reads through ml_dtypes and the port
reads without it. So either package reads the other's artifacts and
checkpoints. Tensor and pytree payloads load as CPU tensors (a dtype torch
lacks loads as a numpy array).

    tensor  = u32 len(head) | head | bytes,  head = {"dtype", "shape"}
    pytree  = u64 len(header) | header | block 0 | block 1 | ...
    header  = {"structure": node, "sizes": [len(block i), ...]}
    node    = {"t": "d", "v": {key: node}} | {"t": "l" | "t", "v": [node]}
            | {"t": "a", "i": block index} | {"t": "s", "v": JSON scalar}
    block   = a tensor payload

`write_pytree` and `read_pytree` stream the pytree format to and from a
file one leaf at a time (the @checkpoint decorator's path for
multi-gigabyte states).

torch is imported lazily: no object is a tensor before torch is imported,
so the flow layer, which imports this module, stays free of it until a
step or a load needs it.
"""

import io
import json
import pickle
import sys

import numpy as np

TYPE_NPY = "npy"        # legacy numpy .npy payloads (read-only support)
TYPE_TENSOR = "tensor"  # raw-bytes tensor format
TYPE_PYTREE = "pytree"
TYPE_PICKLE = "pickle"

if sys.byteorder != "little":  # the formats are little-endian on every host
    raise ImportError("the tensor formats need a little-endian host")

_TENSOR_KINDS = frozenset("biufc")  # bool/int/uint/float/complex


def _torch():
    """The torch module when it is imported, else None."""
    return sys.modules.get("torch")


def _is_tensor(obj):
    torch = _torch()
    return torch is not None and isinstance(obj, torch.Tensor)


def _dtype_name(dtype):
    """torch.bfloat16 -> 'bfloat16': the numpy (ml_dtypes) name."""
    return str(dtype).split(".")[-1]


def _tensor_dtype_ok(dtype):
    """True when the tensor format can round-trip this numpy dtype: the
    numeric kinds, and the extended types torch names alike (bfloat16,
    float8_*)."""
    if dtype.kind in _TENSOR_KINDS:
        return True
    import torch

    return isinstance(getattr(torch, dtype.name, None), torch.dtype)


def _is_leaf_array(obj):
    if _is_tensor(obj):
        return obj.layout == _torch().strided
    return isinstance(obj, np.ndarray) and _tensor_dtype_ok(obj.dtype)


def _tree_only_arrays(obj, depth=0):
    """True if obj is a (nested) dict/list/tuple whose leaves are all
    tensors/arrays/scalars: eligible for the pytree format.

    Container types must match EXACTLY: subclasses (namedtuples,
    OrderedDict, defaultdict...) fall through to pickle, which preserves
    their type."""
    if depth > 16:
        return False
    if isinstance(obj, np.ndarray) or _is_tensor(obj):
        return _is_leaf_array(obj)
    if obj is None or type(obj) in (int, float, bool):
        return True
    if type(obj) is dict:
        return all(isinstance(k, str) for k in obj) and all(
            _tree_only_arrays(v, depth + 1) for v in obj.values()
        )
    if type(obj) in (list, tuple):
        return bool(obj) and all(_tree_only_arrays(v, depth + 1) for v in obj)
    return False


def _head(dtype_name, shape):
    head = json.dumps({"dtype": dtype_name, "shape": list(shape)}).encode(
        "utf-8")
    return len(head).to_bytes(4, "little") + head


def _host_view(t):
    """(dtype name, shape, uint8 numpy view of the C-order bytes) of a
    tensor or array; a CUDA tensor is copied to the host once."""
    if isinstance(t, np.ndarray):
        arr = np.ascontiguousarray(t)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr.dtype.name, arr.shape, arr.reshape(-1).view(np.uint8)
    t = t.detach()
    if t.is_cuda:
        t = t.to("cpu")
    t = t.contiguous()
    if t.is_conj():
        t = t.resolve_conj()
    return (_dtype_name(t.dtype), tuple(t.shape),
            t.reshape(-1).view(_torch().uint8).numpy())


def _tensor_bytes(t):
    name, shape, data = _host_view(t)
    return _head(name, shape) + data.tobytes()


def _tensor_nbytes(t):
    """Length of a leaf's tensor payload, without copying it."""
    if isinstance(t, np.ndarray):
        name, shape, nbytes = t.dtype.name, t.shape, t.nbytes
    else:
        name, shape = _dtype_name(t.dtype), tuple(t.shape)
        nbytes = t.numel() * t.element_size()
    return len(_head(name, shape)) + nbytes


def _resolve_dtype(name):
    """The torch dtype of a stored dtype name, else its numpy dtype."""
    import torch

    dtype = getattr(torch, name, None)
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return np.dtype(name)
    except TypeError:
        raise ValueError("stored dtype %r is known to neither torch nor "
                         "numpy" % name)


def _from_bytes(raw, dtype, shape):
    """A CPU tensor (or numpy array) of `dtype` over the uint8 array
    `raw`, which it takes over."""
    if isinstance(dtype, np.dtype):
        return raw.view(dtype).reshape(shape)
    return _torch().from_numpy(raw).view(dtype).reshape(shape)


def _tensor_load(data):
    view = memoryview(data)
    hlen = int.from_bytes(view[:4], "little")
    head = json.loads(bytes(view[4:4 + hlen]).decode("utf-8"))
    raw = np.frombuffer(view, dtype=np.uint8, offset=4 + hlen).copy()
    return _from_bytes(raw, _resolve_dtype(head["dtype"]), head["shape"])


class ArtifactSerializer(object):
    """One pluggable artifact format. Subclass, set a unique `type_tag`
    and a `priority` (lower runs earlier; the pickle fallback sits at
    9999), and register with `register_serializer`."""

    type_tag = None
    priority = 100

    def can_serialize(self, obj):  # pragma: no cover - interface
        raise NotImplementedError

    def serialize(self, obj):  # -> bytes
        raise NotImplementedError

    def deserialize(self, payload):  # -> object
        raise NotImplementedError


_SERIALIZERS = []  # kept sorted by (priority, registration order)
_BY_TAG = {}


def register_serializer(serializer):
    """Register (or override, by type_tag) an ArtifactSerializer
    INSTANCE; returns it."""
    if not serializer.type_tag:
        raise ValueError("serializer needs a non-empty type_tag")
    existing = _BY_TAG.get(serializer.type_tag)
    if existing is not None:
        _SERIALIZERS.remove(existing)
    _BY_TAG[serializer.type_tag] = serializer
    _SERIALIZERS.append(serializer)
    _SERIALIZERS.sort(key=lambda s: s.priority)
    return serializer


def serialize(obj):
    """Return (payload_bytes, type_tag) via the first serializer that
    accepts obj (priority order; pickle always accepts)."""
    for s in _SERIALIZERS:
        if s.can_serialize(obj):
            return s.serialize(obj), s.type_tag
    raise RuntimeError("no serializer accepted %r" % type(obj))


def deserialize(payload, type_tag):
    s = _BY_TAG.get(type_tag)
    if s is None:
        raise ValueError(
            "artifact has unknown type_tag %r — written by a newer version "
            "or by an extension serializer that isn't installed here"
            % type_tag
        )
    return s.deserialize(payload)


class _TensorSerializer(ArtifactSerializer):
    """torch.Tensor / np.ndarray -> header + raw bytes."""

    type_tag = TYPE_TENSOR
    priority = 10

    def can_serialize(self, obj):
        return (isinstance(obj, np.ndarray) or _is_tensor(obj)) and \
            _is_leaf_array(obj)

    def serialize(self, obj):
        return _tensor_bytes(obj)

    def deserialize(self, payload):
        return _tensor_load(payload)


class _PytreeSerializer(ArtifactSerializer):
    """Exact dict/list/tuple trees of tensors -> structure + packed
    tensors."""

    type_tag = TYPE_PYTREE
    priority = 20

    def can_serialize(self, obj):
        return type(obj) in (dict, list, tuple) and _tree_only_arrays(obj)

    def serialize(self, obj):
        out = io.BytesIO()
        write_pytree(obj, out)
        return out.getvalue()

    def deserialize(self, payload):
        return _pytree_load(payload)


class _LegacyNpySerializer(ArtifactSerializer):
    """Read-only: artifacts written as real .npy by earlier versions."""

    type_tag = TYPE_NPY
    priority = 10_000  # never chosen for writes

    def can_serialize(self, obj):
        return False

    def deserialize(self, payload):
        arr = np.load(io.BytesIO(payload), allow_pickle=False)
        if arr.dtype.kind not in _TENSOR_KINDS:
            return arr
        import torch

        return torch.from_numpy(arr)


class _PickleSerializer(ArtifactSerializer):
    """The universal fallback (CUDA tensors moved to the host first)."""

    type_tag = TYPE_PICKLE
    priority = 9999

    def can_serialize(self, obj):
        return True

    def serialize(self, obj):
        return pickle.dumps(
            _pickle_safe(obj), protocol=pickle.HIGHEST_PROTOCOL
        )

    def deserialize(self, payload):
        return pickle.loads(payload)


for _s in (_TensorSerializer(), _PytreeSerializer(), _LegacyNpySerializer(),
           _PickleSerializer()):
    register_serializer(_s)


def _pickle_safe(obj):
    """Move CUDA tensors in an arbitrary object graph to the host before
    pickling, so the payload loads on a machine without a card. Container
    *types* are preserved: namedtuples rebuild via their class, dict
    subclasses via .copy()."""
    if _is_tensor(obj):
        return obj.detach().cpu() if obj.is_cuda else obj
    if type(obj) is dict:
        return {k: _pickle_safe(v) for k, v in obj.items()}
    if type(obj) is list:
        return [_pickle_safe(v) for v in obj]
    if type(obj) is tuple:
        return tuple(_pickle_safe(v) for v in obj)
    if isinstance(obj, tuple):
        vals = [_pickle_safe(v) for v in obj]
        if all(v is o for v, o in zip(vals, obj)):
            return obj  # nothing on the card inside: keep as-is
        if hasattr(obj, "_fields"):  # namedtuple: _make bypasses __new__
            try:
                return type(obj)._make(vals)
            except Exception:
                return tuple(vals)
        try:
            return type(obj)(vals)
        except Exception:
            return tuple(vals)  # host transfer beats type fidelity
    if isinstance(obj, dict):
        vals = {k: _pickle_safe(v) for k, v in obj.items()}
        if all(vals[k] is obj[k] for k in obj):
            return obj
        try:
            clone = obj.copy()  # preserves OrderedDict/defaultdict/UserDict
            clone.update(vals)
            return clone
        except Exception:
            return vals
    if isinstance(obj, list):
        vals = [_pickle_safe(v) for v in obj]
        if all(v is o for v, o in zip(vals, obj)):
            return obj
        try:
            clone = obj.copy()
            clone[:] = vals
            return clone
        except Exception:
            return vals
    return obj


# ---- the pytree format, streamed one leaf at a time ----

def _pytree_header(tree):
    """(header bytes, leaves in block order) of a pytree."""
    leaves = []

    def encode(node):
        # exact-type dispatch mirrors _tree_only_arrays: subclasses never
        # reach here (they route the whole tree to pickle)
        if type(node) is dict:
            if not all(isinstance(k, str) for k in node):
                raise TypeError("pytree dict keys must be str")
            return {"t": "d", "v": {k: encode(v) for k, v in node.items()}}
        if type(node) is list:
            return {"t": "l", "v": [encode(v) for v in node]}
        if type(node) is tuple:
            return {"t": "t", "v": [encode(v) for v in node]}
        if isinstance(node, np.ndarray) or _is_tensor(node):
            leaves.append(node)
            return {"t": "a", "i": len(leaves) - 1}
        # a str leaf is a JSON scalar too: artifacts with one go to
        # pickle (_tree_only_arrays), but a checkpoint may carry its
        # model config's strings
        if node is None or type(node) in (int, float, bool, str):
            return {"t": "s", "v": node}
        raise TypeError("pytree leaf of type %s" % type(node).__name__)

    structure = encode(tree)
    header = json.dumps(
        {"structure": structure,
         "sizes": [_tensor_nbytes(t) for t in leaves]}).encode("utf-8")
    return len(header).to_bytes(8, "little") + header, leaves


def write_pytree(tree, f):
    """Write `tree` in the pytree format to the binary file `f`, one leaf
    at a time (each CUDA leaf copied to the host once, and written from
    that copy). Returns the bytes written."""
    header, leaves = _pytree_header(tree)
    f.write(header)
    total = len(header)
    for t in leaves:
        name, shape, data = _host_view(t)
        head = _head(name, shape)
        f.write(head)
        f.write(memoryview(data))
        total += len(head) + data.nbytes
    return total


def _decode(node, leaves):
    t = node["t"]
    if t == "d":
        return {k: _decode(v, leaves) for k, v in node["v"].items()}
    if t == "l":
        return [_decode(v, leaves) for v in node["v"]]
    if t == "t":
        return tuple(_decode(v, leaves) for v in node["v"])
    if t == "a":
        return leaves[node["i"]]
    return node["v"]


def _pytree_load(data):
    view = memoryview(data)
    hlen = int.from_bytes(view[:8], "little")
    header = json.loads(bytes(view[8:8 + hlen]).decode("utf-8"))
    offset = 8 + hlen
    leaves = []
    for size in header["sizes"]:
        leaves.append(_tensor_load(view[offset:offset + size]))
        offset += size
    return _decode(header["structure"], leaves)


def _like_leaves(structure, like):
    """{block index: live tensor} of the leaves of `like` at the tree
    positions of `structure`'s blocks."""
    out = {}

    def walk(node, live, path):
        if node["t"] == "a":
            if not _is_tensor(live):
                raise ValueError("checkpoint leaf %s has no live tensor"
                                 % "/".join(path))
            out[node["i"]] = (live, path)
        elif node["t"] == "d":
            for k, v in node["v"].items():
                walk(v, live[k], path + (k,))
        elif node["t"] in ("l", "t"):
            for i, v in enumerate(node["v"]):
                walk(v, live[i], path + (str(i),))

    walk(structure, like, ())
    return out


def pytree_skeleton(f):
    """The tree of the pytree file `f` with each tensor leaf a meta
    tensor of its saved dtype and shape (a numpy dtype's leaf a zero-stride
    array), read without its data: `f` seeks past each leaf (forward
    only, as a gzip stream can)."""
    import torch

    hlen = int.from_bytes(f.read(8), "little")
    header = json.loads(f.read(hlen).decode("utf-8"))
    leaves = []
    for size in header["sizes"]:
        head_len = int.from_bytes(f.read(4), "little")
        head = json.loads(f.read(head_len).decode("utf-8"))
        dtype = _resolve_dtype(head["dtype"])
        if isinstance(dtype, np.dtype):
            leaves.append(np.broadcast_to(np.zeros((), dtype),
                                          head["shape"]))
        else:
            leaves.append(torch.empty(head["shape"], dtype=dtype,
                                      device="meta"))
        f.seek(size - 4 - head_len, 1)
    return _decode(header["structure"], leaves)


def read_pytree(f, like=None, put=None):
    """Read a pytree written by `write_pytree` (or serialized as
    'pytree') from the binary file `f`, one leaf at a time. Tensor leaves
    come back as CPU tensors; with `like`, a live tree holding a tensor at
    every leaf position of the saved one, each saved leaf is copied into
    its live tensor (same shape and dtype, checked), which the returned
    tree then holds, before the next leaf is read. `put(live, saved)`,
    where given, does that copy (e.g. of a sharded live tensor's own
    block)."""
    import torch

    hlen = int.from_bytes(f.read(8), "little")
    header = json.loads(f.read(hlen).decode("utf-8"))
    live = _like_leaves(header["structure"], like) if like is not None \
        else {}
    leaves = []
    for i, size in enumerate(header["sizes"]):
        head_len = int.from_bytes(f.read(4), "little")
        head = json.loads(f.read(head_len).decode("utf-8"))
        raw = np.empty(size - 4 - head_len, dtype=np.uint8)
        if f.readinto(memoryview(raw)) != raw.nbytes:
            raise ValueError("pytree file ends inside leaf %d" % i)
        t = _from_bytes(raw, _resolve_dtype(head["dtype"]), head["shape"])
        if i in live:
            dst, path = live[i]
            if not isinstance(t, torch.Tensor) or t.shape != dst.shape or \
                    t.dtype != dst.dtype:
                raise ValueError(
                    "checkpoint leaf %s is %s%s, the live tensor %s%s"
                    % ("/".join(path), head["dtype"], tuple(head["shape"]),
                       dst.dtype, tuple(dst.shape)))
            with torch.no_grad():
                if put is None:
                    dst.copy_(t)
                else:
                    put(dst, t)
            t = dst
        leaves.append(t)
    return _decode(header["structure"], leaves)
