"""The streamed corpus: the JAX package's data/ subsystem for the port,
numpy and the port's datastore only.

  - shards.py   — a token corpus as fixed-size shard blobs
                  (content-addressed, per-shard checksums) plus a JSON
                  index manifest, written through the datastore.
  - reader.py   — bounded-readahead parallel reader: a worker pool
                  fetches shards ahead of consumption (readahead window
                  in bytes, in-flight checksum verify), deterministic
                  per-host shard assignment.
  - loader.py   — StreamingTokenBatches: the ResumableTokenBatches
                  contract (STATE_KEY resume stamp on every batch, zero
                  replay on restore) over an on-datastore corpus.
  - packing.py  — sequence packing: fill fixed seq_len windows from
                  variable-length documents with segment-id masks.
  - ordering.py — the pure (seed, epoch) shuffle functions shared with
                  training/data.py.

A corpus built by either package streams the same batches and stamps
through the other's loader.
"""

from .ordering import (
    STATE_KEY,
    epoch_shard_order,
    hierarchical_window_order,
    shard_window_order,
)
from .packing import pack_documents, packed_batches, segment_loss_mask
from .reader import ShardCorruptionError, ShardReader
from .shards import (
    DATASET_PREFIX,
    build_corpus,
    dataset_path,
    list_datasets,
    load_manifest,
)
from .loader import StreamingTokenBatches

__all__ = [
    "STATE_KEY",
    "epoch_shard_order",
    "shard_window_order",
    "hierarchical_window_order",
    "DATASET_PREFIX",
    "build_corpus",
    "dataset_path",
    "list_datasets",
    "load_manifest",
    "ShardReader",
    "ShardCorruptionError",
    "StreamingTokenBatches",
    "pack_documents",
    "packed_batches",
    "segment_loss_mask",
]
