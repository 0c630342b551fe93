"""Sequence packing: fill fixed-length windows from variable-length
documents, with segment-id masks.

Training on documents shorter than seq_len wastes compute on padding;
packing concatenates documents into full (seq_len+1)-token windows and
carries a per-token SEGMENT ID so the loss can refuse to predict across
document boundaries. Windows feed the existing training path directly:
`packed_batches` yields {'inputs', 'targets', 'mask', 'segment_ids'}
batches, and models/llama.py::loss_fn already consumes the
inputs/targets/mask form (the mask zeroes boundary-crossing and padding
targets). `segment_ids` ride along (host→device like any other leaf) for
attention implementations that support intra-segment masking.

Semantics:
  - documents are packed greedily in input order; a document longer than
    the remaining space in a window continues into the next window (its
    continuation restarts as segment 1 of that window);
  - segment ids are 1-based PER WINDOW; 0 marks padding (only ever in
    the final window's tail);
  - the target at position i (= token i+1 predicting from token i) is
    masked out unless tokens i and i+1 belong to the same segment —
    so the first token of every document and all padding contribute no
    loss.
"""

import numpy as np


def pack_documents(docs, seq_len, *, pad_id=0, dtype=None):
    """Pack an iterable of 1-D token docs into (tokens[W], segment_ids[W])
    windows, W = seq_len + 1. The final partial window is padded with
    pad_id / segment 0. Yields nothing for an empty doc stream."""
    W = int(seq_len) + 1
    if W < 2:
        raise ValueError("seq_len must be >= 1, got %r" % seq_len)
    cur_t, cur_s = [], []
    seg = 1
    out_dtype = dtype
    for doc in docs:
        doc = np.asarray(doc).ravel()
        if out_dtype is None:
            out_dtype = doc.dtype
        offset = 0
        while offset < doc.size:
            space = W - len(cur_t)
            take = min(space, doc.size - offset)
            cur_t.extend(doc[offset:offset + take].tolist())
            cur_s.extend([seg] * take)
            offset += take
            if len(cur_t) == W:
                yield (np.asarray(cur_t, dtype=out_dtype),
                       np.asarray(cur_s, dtype=np.int32))
                cur_t, cur_s = [], []
                # a continuing doc restarts as segment 1 of the new
                # window; a doc that ended exactly at the boundary lets
                # the NEXT doc start at segment 1 too
                seg = 1
        if cur_t:
            seg += 1
    if cur_t:
        pad = W - len(cur_t)
        cur_t.extend([pad_id] * pad)
        cur_s.extend([0] * pad)
        yield (np.asarray(cur_t, dtype=out_dtype or np.int32),
               np.asarray(cur_s, dtype=np.int32))


def segment_loss_mask(segment_ids):
    """[..., W] segment ids → [..., W-1] float32 loss mask: target i is
    live iff positions i and i+1 share a non-padding segment."""
    segment_ids = np.asarray(segment_ids)
    same = segment_ids[..., 1:] == segment_ids[..., :-1]
    live = segment_ids[..., 1:] != 0
    return (same & live).astype(np.float32)


def packed_batches(docs, batch_size, seq_len, *, pad_id=0, drop_last=False):
    """Pack docs and batch the windows: yields
    {'inputs': [B, S], 'targets': [B, S], 'mask': [B, S] float32,
     'segment_ids': [B, S+1] int32} — directly consumable by the existing
    loss path (llama.loss_fn reads inputs/targets/mask; segment_ids ride
    along for segment-aware attention)."""
    toks, segs = [], []
    for tokens, segment_ids in pack_documents(docs, seq_len, pad_id=pad_id):
        toks.append(tokens)
        segs.append(segment_ids)
        if len(toks) == batch_size:
            yield _finish(toks, segs)
            toks, segs = [], []
    if toks and not drop_last:
        yield _finish(toks, segs)


def _finish(toks, segs):
    tokens = np.stack(toks)
    segment_ids = np.stack(segs)
    return {
        "inputs": tokens[:, :-1],
        "targets": tokens[:, 1:],
        "mask": segment_loss_mask(segment_ids),
        "segment_ids": segment_ids,
    }
