"""Sharded on-datastore corpus format: fixed-size token shard blobs plus
a JSON index manifest. The port's copy of the JAX package's
data/shards.py: either package reads a corpus the other built.

Layout (all under the flow's datastore):

    <flow>/data/<xx>/<sha256>          one raw CAS blob per shard
    <flow>/_datasets/<name>/manifest.json

Shard blobs are the little-endian bytes of a 1-D token array slice,
stored RAW (token data is incompressible; gzip would only burn CPU on
the hot read path) through the content-addressed store's `save_data`.
The CAS key IS the shard checksum: sha256 of the payload, verified in
flight by the reader (reader.py).

The manifest is the index: dtype (with explicit byte order), token
counts, per-shard keys/sizes. Its schema is pinned in
tests/schema_validate.py::DATASET_MANIFEST_SCHEMA.
"""

import hashlib
import json

import numpy as np

from ..exception import TpuFlowException

DATASET_PREFIX = "_datasets"
MANIFEST_VERSION = 1

# 4M tokens/shard: 16 MB of int32 — large enough that per-request
# overhead amortizes, small enough that a readahead window holds several
DEFAULT_SHARD_TOKENS = 4 * 1024 * 1024


class DatasetError(TpuFlowException):
    headline = "Dataset error"


def dataset_path(flow_datastore, name, *suffix):
    return flow_datastore.storage.path_join(
        flow_datastore.flow_name, DATASET_PREFIX, name, *suffix)


def _manifest_path(flow_datastore, name):
    return dataset_path(flow_datastore, name, "manifest.json")


def _check_name(name):
    if not name or "/" in name or name.startswith("_") or name != name.strip():
        raise DatasetError(
            "invalid dataset name %r (no slashes, no leading underscore)"
            % name)


def build_corpus(flow_datastore, name, tokens,
                 shard_tokens=DEFAULT_SHARD_TOKENS, overwrite=False,
                 dtype=None):
    """Pack a 1-D token array into shard blobs + manifest; returns the
    manifest dict.

    `tokens` may be any 1-D array-like (incl. a np.memmap over a corpus
    file — shards are sliced and converted one at a time, so peak RSS is
    one shard regardless of corpus size). `dtype` recasts per shard on
    the way out (a whole-array cast would materialize the memmap);
    default preserves the input dtype. Either way the manifest pins it
    little-endian so a corpus built on any host decodes identically
    everywhere.
    """
    _check_name(name)
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise DatasetError("tokens must be 1-D, got shape %s"
                           % (tokens.shape,))
    if tokens.size == 0:
        raise DatasetError("refusing to build an empty corpus")
    shard_tokens = int(shard_tokens)
    if shard_tokens <= 0:
        raise DatasetError("shard_tokens must be positive, got %d"
                           % shard_tokens)
    if not overwrite and load_manifest(flow_datastore, name,
                                       missing_ok=True) is not None:
        raise DatasetError(
            "dataset %r already exists (pass overwrite to rebuild)" % name)

    dtype = (np.dtype(dtype) if dtype is not None
             else tokens.dtype).newbyteorder("<")
    bounds = [(start, min(start + shard_tokens, tokens.size))
              for start in range(0, tokens.size, shard_tokens)]

    def blob_iter():
        for start, stop in bounds:
            yield np.ascontiguousarray(
                tokens[start:stop], dtype=dtype).tobytes()

    # raw CAS blobs through the batched persist path; save_data also
    # registers the keys so gc's mark phase keeps the corpus live
    results = flow_datastore.save_data(blob_iter())
    shards = [
        {"key": key, "tokens": int(stop - start),
         "bytes": int((stop - start) * dtype.itemsize), "sha256": key}
        for (_uri, key), (start, stop) in zip(results, bounds)
    ]
    manifest = {
        "v": MANIFEST_VERSION,
        "name": name,
        "dtype": dtype.str,
        "total_tokens": int(tokens.size),
        "shard_tokens": shard_tokens,
        "n_shards": len(shards),
        "shards": shards,
    }
    flow_datastore.storage.save_bytes(
        [(_manifest_path(flow_datastore, name),
          json.dumps(manifest, sort_keys=True).encode("utf-8"))],
        overwrite=True,
    )
    return manifest


def append_corpus(flow_datastore, name, tokens, generation=None,
                  dtype=None):
    """Append a 1-D token array to an EXISTING corpus as new shard blobs
    plus a manifest rewrite; returns the updated manifest dict.

    This is the JAX package's replay-buffer write path and its
    `tpuflow dataset build --append`. The manifest stays v1 but
    gains/bumps an integer `revision` (absent == 0 for manifests written
    before appends existed), so a writer's publish is observable:
    readers that hold the OLD manifest dict keep streaming exactly the
    token order they started with (shard entries are append-only and
    existing blobs are immutable CAS objects), while readers that reload
    the manifest see the growth and pick it up at their next epoch
    boundary.

    `generation` optionally stamps every appended shard entry with the
    weight generation that produced its tokens — the freshness key the
    online ReplayReader's max-staleness window filters on. Shards from
    the original build (or generation-less appends) count as
    generation 0.

    The append's trailing shard may be short (shard_tokens is the pack
    size, not a guarantee): StreamingTokenBatches windows are sliced
    per-shard, so appended text never straddles a shard boundary, and a
    mid-corpus short shard simply contributes fewer windows. Writers
    that must not lose tokens to partial windows (the replay path) keep
    both shard_tokens and each append a multiple of their window size.
    """
    manifest = load_manifest(flow_datastore, name)
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise DatasetError("tokens must be 1-D, got shape %s"
                           % (tokens.shape,))
    if tokens.size == 0:
        raise DatasetError("refusing to append zero tokens to %r" % name)
    want = np.dtype(manifest["dtype"])
    if dtype is not None and np.dtype(dtype).newbyteorder("<") != want:
        raise DatasetError(
            "dataset %r stores %s tokens; cannot append as %s"
            % (name, manifest["dtype"], np.dtype(dtype).str))
    shard_tokens = int(manifest["shard_tokens"])
    bounds = [(start, min(start + shard_tokens, tokens.size))
              for start in range(0, tokens.size, shard_tokens)]

    def blob_iter():
        for start, stop in bounds:
            yield np.ascontiguousarray(
                tokens[start:stop], dtype=want).tobytes()

    results = flow_datastore.save_data(blob_iter())
    for (_uri, key), (start, stop) in zip(results, bounds):
        shard = {"key": key, "tokens": int(stop - start),
                 "bytes": int((stop - start) * want.itemsize),
                 "sha256": key}
        if generation is not None:
            shard["generation"] = int(generation)
        manifest["shards"].append(shard)
    manifest["n_shards"] = len(manifest["shards"])
    manifest["total_tokens"] = int(manifest["total_tokens"]
                                   + tokens.size)
    manifest["revision"] = int(manifest.get("revision", 0)) + 1
    flow_datastore.storage.save_bytes(
        [(_manifest_path(flow_datastore, name),
          json.dumps(manifest, sort_keys=True).encode("utf-8"))],
        overwrite=True,
    )
    return manifest


def load_manifest(flow_datastore, name, missing_ok=False):
    """The manifest dict of a built dataset, or None (missing_ok)."""
    _check_name(name)
    path = _manifest_path(flow_datastore, name)
    with flow_datastore.storage.load_bytes([path]) as loaded:
        for _p, local, _m in loaded:
            if local is None:
                break
            with open(local) as f:
                manifest = json.load(f)
            if manifest.get("v") != MANIFEST_VERSION:
                raise DatasetError(
                    "dataset %r has manifest version %r; this reader "
                    "understands v%d" % (name, manifest.get("v"),
                                         MANIFEST_VERSION))
            return manifest
    if missing_ok:
        return None
    raise DatasetError(
        "dataset %r not found in flow %s's datastore (build it with "
        "build_corpus)"
        % (name, flow_datastore.flow_name))


def list_datasets(flow_datastore):
    """Names of built datasets in this flow's datastore."""
    prefix = flow_datastore.storage.path_join(
        flow_datastore.flow_name, DATASET_PREFIX)
    return sorted(
        flow_datastore.storage.basename(p)
        for p, is_file in flow_datastore.storage.list_content([prefix])
        if not is_file
    )


def decode_shard(manifest, index, blob):
    """One shard blob → its 1-D token array (zero-copy view over the
    fetched bytes; callers slice windows out of it)."""
    shard = manifest["shards"][index]
    arr = np.frombuffer(blob, dtype=np.dtype(manifest["dtype"]),
                        count=shard["tokens"])
    if arr.size != shard["tokens"]:
        raise DatasetError(
            "shard %d of %s decoded to %d tokens, manifest says %d"
            % (index, manifest.get("name"), arr.size, shard["tokens"]))
    return arr


def verify_blob(shard, blob):
    """True iff `blob` matches the shard's manifest checksum."""
    return (len(blob) == shard["bytes"]
            and hashlib.sha256(blob).hexdigest() == shard["sha256"])
