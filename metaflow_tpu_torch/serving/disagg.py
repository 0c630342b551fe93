"""Disaggregated prefill/decode: the KV-handoff wire format, ported from
the JAX package byte for byte.

A prefill replica runs only chunked prefill (`POST /v1/prefill` ->
Request(prefill_only=True)) and answers this frame; a decode replica takes
it (`POST /v1/decode` -> Request(prefilled=...)), seeds its slot with the
KV and continues from the first token. The engines' extract_kv /
admit_prefilled are the two ends of the pipe.

The frame is self-describing:
  MAGIC | u32 header length | JSON header | raw k bytes | raw v bytes
where the header carries the array dtype name ("float32", "bfloat16",
...) and shapes plus arbitrary JSON metadata (the original request
payload, the first sampled token). The bytes are the arrays' raw
little-endian words, bfloat16 included, so a JAX replica and a port
replica can exchange frames.
"""

import json
import struct

import numpy as np
import torch

MAGIC = b"TPFKV1\n"

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}
# the integer word each dtype's raw bytes are moved through numpy as
_WORDS = {torch.bfloat16: torch.int16}


def _host(a):
    """A KV array as a contiguous CPU tensor (numpy arrays are taken as
    they are; a numpy bfloat16 goes through its raw 16-bit words)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu").contiguous()
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _raw_bytes(t):
    word = _WORDS.get(t.dtype)
    return (t.view(word) if word is not None else t).numpy().tobytes()


def encode_handoff(meta, kv):
    """Frame a KV handoff: `meta` is JSON-safe metadata, `kv` is
    {"k": [layers, T, kv_heads, head_dim], "v": ...} (CPU tensors or
    numpy arrays)."""
    k = _host(kv["k"])
    v = _host(kv["v"])
    if k.dtype not in _NAMES:
        raise ValueError("unsupported KV dtype %s" % (k.dtype,))
    header = dict(meta)
    header["dtype"] = _NAMES[k.dtype]
    header["k_shape"] = list(k.shape)
    header["v_shape"] = list(v.shape)
    hb = json.dumps(header).encode("utf-8")
    return b"".join([MAGIC, struct.pack("<I", len(hb)), hb,
                     _raw_bytes(k), _raw_bytes(v)])


def _from_bytes(data, dtype, shape, offset):
    count = int(np.prod(shape))
    word = _WORDS.get(dtype, dtype)
    np_word = torch.empty(0, dtype=word).numpy().dtype
    arr = np.frombuffer(data, np_word, count=count, offset=offset).copy()
    return torch.from_numpy(arr).view(dtype).reshape(shape)


def decode_handoff(data):
    """Inverse of encode_handoff: returns (meta, {"k": ..., "v": ...}) with
    the arrays as CPU tensors."""
    if not data.startswith(MAGIC):
        raise ValueError("not a KV handoff frame")
    off = len(MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    header = json.loads(data[off:off + hlen].decode("utf-8"))
    off += hlen
    name = header.pop("dtype")
    if name not in _DTYPES:
        raise ValueError("unsupported KV dtype %r" % (name,))
    dtype = _DTYPES[name]
    k_shape = tuple(header.pop("k_shape"))
    v_shape = tuple(header.pop("v_shape"))
    itemsize = torch.empty(0, dtype=dtype).element_size()
    k_bytes = int(np.prod(k_shape)) * itemsize
    v_bytes = int(np.prod(v_shape)) * itemsize
    if len(data) != off + k_bytes + v_bytes:
        raise ValueError("KV handoff frame truncated")
    return header, {"k": _from_bytes(data, dtype, k_shape, off),
                    "v": _from_bytes(data, dtype, v_shape, off + k_bytes)}
