"""Deterministic shuffle orders of the resumable token loader, the JAX
package's data/ordering.py kept as the port's own copy (numpy only), so
the two packages walk byte-identical token sequences for a seed.

Every order here is a PURE function of (seed, epoch[, shard]) — no
iterator state, no RNG objects carried across calls — so a resume stamp
of flat ints fully determines the rest of a stream. The hierarchical
order (the SHARD order permuted per epoch, then the windows WITHIN each
shard per (epoch, shard)) is what a loader streaming a sharded corpus
walks; ResumableTokenBatches(shard_windows=...) walks it over an array.
"""

import numpy as np

# key under which resumable loaders stamp their resume state into each
# batch dict; prefetch keeps it on the host (never on the device)
STATE_KEY = "data_state"


def epoch_shard_order(seed, epoch, n_shards):
    """The order shards are consumed in `epoch`. seed=None → sequential."""
    if seed is None:
        return np.arange(n_shards)
    rng = np.random.default_rng([int(seed), int(epoch)])
    return rng.permutation(n_shards)


def shard_window_order(seed, epoch, shard_index, n_windows):
    """The order windows of one shard are consumed in `epoch`. The GLOBAL
    shard index (not its position in the epoch order) keys the RNG, so a
    host reading only its slice of the shard order computes the same
    within-shard orders as a host reading everything."""
    if seed is None:
        return np.arange(n_windows)
    rng = np.random.default_rng([int(seed), int(epoch), int(shard_index)])
    return rng.permutation(n_windows)


def hierarchical_window_order(seed, epoch, n_windows, shard_windows):
    """The epoch's GLOBAL window order when a flat array of `n_windows`
    windows is viewed as shards of `shard_windows` windows each (the last
    shard may be short) — i.e. what a streaming loader over such a corpus
    yields, expressed as indices into the concatenated array. This is how
    ResumableTokenBatches(shard_windows=...) matches StreamingTokenBatches
    byte for byte."""
    shard_windows = int(shard_windows)
    if shard_windows <= 0:
        raise ValueError("shard_windows must be positive, got %d"
                         % shard_windows)
    n_shards = -(-n_windows // shard_windows)
    parts = []
    for s in epoch_shard_order(seed, epoch, n_shards):
        base = int(s) * shard_windows
        count = min(shard_windows, n_windows - base)
        parts.append(base + shard_window_order(seed, epoch, int(s), count))
    if not parts:
        return np.arange(0)
    return np.concatenate(parts)
