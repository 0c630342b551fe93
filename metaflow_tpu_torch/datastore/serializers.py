"""The JAX package's pytree blob format (datastore/serializers.py), kept
as the port's own copy for tensors: a JSON header of the tree's structure
and the byte size of each leaf's block, then the blocks. Each block is a
JSON header {dtype, shape} and the leaf's C-order bytes, native
(little-endian) order. bf16 is written as its raw 2-byte words under the
dtype name 'bfloat16', which the JAX package reads through ml_dtypes; the
port reads it without ml_dtypes. So a port checkpoint deserializes in the
JAX package and a JAX parameter blob in the port.

    blob    = u64 len(header) | header | block 0 | block 1 | ...
    header  = {"structure": node, "sizes": [len(block i), ...]}
    node    = {"t": "d", "v": {key: node}} | {"t": "l" | "t", "v": [node]}
            | {"t": "a", "i": block index} | {"t": "s", "v": JSON scalar}
    block   = u32 len(head) | head | bytes,  head = {"dtype", "shape"}
"""

import json
import sys

import numpy as np
import torch

TYPE_PYTREE = "pytree"

if sys.byteorder != "little":  # the format is little-endian on every host
    raise ImportError("the pytree blob format needs a little-endian host")


def _dtype_name(dtype):
    """torch.bfloat16 -> 'bfloat16': the numpy (ml_dtypes) name."""
    return str(dtype).split(".")[-1]


def _block(t):
    """One leaf's block: the tensor's (or array's) header and bytes."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = t.detach().cpu().contiguous()
    head = json.dumps({"dtype": _dtype_name(t.dtype),
                       "shape": list(t.shape)}).encode("utf-8")
    data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
    return len(head).to_bytes(4, "little") + head + data


def _load_block(data):
    hlen = int.from_bytes(data[:4], "little")
    head = json.loads(bytes(data[4:4 + hlen]).decode("utf-8"))
    dtype = getattr(torch, head["dtype"], None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError("blob leaf of dtype %r, which torch does not have"
                         % head["dtype"])
    raw = np.frombuffer(data, dtype=np.uint8, offset=4 + hlen).copy()
    return torch.from_numpy(raw).view(dtype).reshape(head["shape"])


def serialize(tree):
    """(blob bytes, 'pytree') of a tree of dicts (str keys), lists and
    tuples whose leaves are tensors, numpy arrays and scalars (int, float,
    bool, None)."""
    blocks = []

    def encode(node):
        if type(node) is dict:
            if not all(isinstance(k, str) for k in node):
                raise TypeError("pytree dict keys must be str")
            return {"t": "d", "v": {k: encode(v) for k, v in node.items()}}
        if type(node) in (list, tuple):
            return {"t": "l" if type(node) is list else "t",
                    "v": [encode(v) for v in node]}
        if isinstance(node, (torch.Tensor, np.ndarray)):
            blocks.append(_block(node))
            return {"t": "a", "i": len(blocks) - 1}
        if node is None or type(node) in (int, float, bool):
            return {"t": "s", "v": node}
        raise TypeError("pytree leaf of type %s" % type(node).__name__)

    structure = encode(tree)
    header = json.dumps({"structure": structure,
                         "sizes": [len(b) for b in blocks]}).encode("utf-8")
    return b"".join([len(header).to_bytes(8, "little"), header] + blocks), \
        TYPE_PYTREE


def deserialize(payload, type_tag):
    """The tree of a 'pytree' blob, its array leaves as CPU tensors."""
    if type_tag != TYPE_PYTREE:
        raise ValueError("blob type %r is not %r" % (type_tag, TYPE_PYTREE))
    view = memoryview(payload)
    hlen = int.from_bytes(view[:8], "little")
    header = json.loads(bytes(view[8:8 + hlen]).decode("utf-8"))
    offset = 8 + hlen
    tensors = []
    for size in header["sizes"]:
        tensors.append(_load_block(view[offset:offset + size]))
        offset += size

    def decode(node):
        t = node["t"]
        if t == "d":
            return {k: decode(v) for k, v in node["v"].items()}
        if t == "l":
            return [decode(v) for v in node["v"]]
        if t == "t":
            return tuple(decode(v) for v in node["v"])
        if t == "a":
            return tensors[node["i"]]
        return node["v"]

    return decode(header["structure"])
