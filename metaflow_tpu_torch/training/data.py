"""Input pipeline: resumable token batches and prefetch onto the card.

The JAX package's training/data.py for one GPU. ResumableTokenBatches
carries explicit state (epoch, batch cursor, shuffle seed) and stamps it
onto every batch: checkpoint the stamp with the model and a preempted run
resumes its token sequence exactly, no replay, no skip. `prefetch` runs
the iterator one or more batches ahead in a thread and, given a device,
puts each batch there while the current step runs. Mesh placement
(shard_iterator, sharded_dataset) waits for the multi-GPU slice.
"""

import collections
import threading

import numpy as np
import torch

from ..data.ordering import STATE_KEY, hierarchical_window_order


class ResumableTokenBatches:
    """Deterministic, resumable epoch iterator over a 1-D token array.

    Yields {'tokens': [B, seq_len+1], STATE_KEY: {...}} batches. The
    per-epoch shuffle is a pure function of (seed, epoch), so the stamped
    state — three ints — fully determines the rest of the stream:

        ds = ResumableTokenBatches(data, 8, 128, seed=0)
        ...train, checkpoint batch[STATE_KEY] with the model...
        ds2 = ResumableTokenBatches(data, 8, 128, seed=0)
        ds2.restore(saved_state)   # continues with the NEXT batch

    The stamp rides inside the batch (not on the iterator) so device
    prefetch — which runs the iterator ahead of consumption — cannot
    desynchronize the checkpointed cursor from the batches the train
    loop actually consumed. Batches and stamps are the JAX package's,
    bit for bit, for the same data and seed.
    """

    def __init__(self, data, batch_size, seq_len, *, seed=None,
                 epochs=None, drop_last=True, shard_windows=None):
        """shard_windows: view the array as consecutive shards of this
        many windows and shuffle hierarchically (shard order, then
        windows within each shard) instead of globally — the order a
        loader streaming the equivalent sharded corpus walks
        (data/ordering.py). Default None keeps the global permutation."""
        self._data = np.asarray(data)
        self._batch_size = batch_size
        self._window = seq_len + 1
        self._seed = seed
        self._epochs = epochs
        self._drop_last = bool(drop_last)
        self._shard_windows = (None if shard_windows is None
                               else int(shard_windows))
        self._epoch = 0
        self._cursor = 0  # batches already yielded in the current epoch
        n_windows = len(self._data) // self._window
        if n_windows == 0:
            raise ValueError(
                "data holds %d tokens — shorter than one %d-token window"
                % (len(self._data), self._window))
        self._n_windows = n_windows

    @property
    def batches_per_epoch(self):
        if self._drop_last:
            return self._n_windows // self._batch_size
        return -(-self._n_windows // self._batch_size)

    def state(self):
        """Resume state BEFORE the next batch to be produced (flat ints;
        JSON-serializable). Carries the stream geometry too,
        so restoring onto a differently-shaped stream is a hard error,
        not a silently different token sequence."""
        state = {"epoch": int(self._epoch), "cursor": int(self._cursor),
                 "seed": self._seed,
                 "batch_size": int(self._batch_size),
                 "window": int(self._window),
                 "n_windows": int(self._n_windows),
                 # drop_last changes batches_per_epoch, so a stamp from a
                 # drop_last=False stream must not restore into a
                 # drop_last=True one (and vice versa)
                 "drop_last": int(self._drop_last)}
        if self._shard_windows is not None:
            state["shard_windows"] = int(self._shard_windows)
        return state

    def restore(self, state):
        """Position the stream just after the batch that carried `state`
        — iteration continues with the batch that would have come next."""
        if state.get("seed") != self._seed:
            raise ValueError(
                "checkpointed stream seed %r != this stream's %r — "
                "restoring would produce a different shuffle order"
                % (state.get("seed"), self._seed))
        for key, mine in (("batch_size", self._batch_size),
                          ("window", self._window),
                          ("n_windows", self._n_windows)):
            theirs = int(state[key])
            if theirs != mine:
                raise ValueError(
                    "checkpointed stream %s=%d != this stream's %d — the "
                    "cursor would address different tokens (same data, "
                    "batch_size and seq_len are required to resume)"
                    % (key, theirs, mine))
        # drop_last changes batches_per_epoch: a mismatched stamp would
        # restore into a stream whose cursor addresses different batches.
        # Pre-drop_last stamps don't carry the key; skip only then.
        theirs = state.get("drop_last")
        if theirs is not None and bool(int(theirs)) != self._drop_last:
            raise ValueError(
                "checkpointed stream drop_last=%r != this stream's %r — "
                "batches_per_epoch differs, the cursor would address "
                "different batches" % (bool(int(theirs)), self._drop_last))
        # a stamp without shard_windows came from a global-permutation
        # stream (shard_windows=None): the orders differ, so None vs set
        # is a mismatch, not a missing key
        theirs = state.get("shard_windows")
        if (theirs is None) != (self._shard_windows is None) or (
                theirs is not None
                and int(theirs) != self._shard_windows):
            raise ValueError(
                "checkpointed stream shard_windows=%r != this stream's %r "
                "— the shuffle orders differ, restoring would produce a "
                "different token sequence"
                % (theirs, self._shard_windows))
        epoch = int(state["epoch"])
        cursor = int(state["cursor"])
        # a corrupted stamp must fail loudly, not silently truncate or
        # shift the token stream: cursor == batches_per_epoch is the
        # legal "last batch of the epoch" stamp, anything past it (or
        # negative) addresses batches that don't exist
        per_epoch = self.batches_per_epoch
        if epoch < 0 or (self._epochs is not None and epoch > self._epochs):
            raise ValueError(
                "checkpointed stream epoch=%d out of range [0, %s] — "
                "corrupted resume stamp" % (epoch, self._epochs))
        if not 0 <= cursor <= per_epoch:
            raise ValueError(
                "checkpointed stream cursor=%d out of range [0, %d] — "
                "corrupted resume stamp" % (cursor, per_epoch))
        self._epoch = epoch
        self._cursor = cursor
        return self

    def _order(self, epoch):
        if self._shard_windows is not None:
            # hierarchical (shard order, then windows within shard): the
            # shared pure function the streaming loader also walks
            return hierarchical_window_order(
                self._seed, epoch, self._n_windows, self._shard_windows)
        if self._seed is None:
            return np.arange(self._n_windows)
        rng = np.random.default_rng([int(self._seed), int(epoch)])
        return rng.permutation(self._n_windows)

    def __iter__(self):
        data, W, B = self._data, self._window, self._batch_size
        while self._epochs is None or self._epoch < self._epochs:
            order = self._order(self._epoch)
            per_epoch = self.batches_per_epoch
            while self._cursor < per_epoch:
                idxs = order[self._cursor * B:(self._cursor + 1) * B]
                rows = [data[i * W:(i + 1) * W] for i in idxs]
                self._cursor += 1
                yield {"tokens": np.stack(rows), STATE_KEY: self.state()}
            self._epoch += 1
            self._cursor = 0


def token_batches(data, batch_size, seq_len, *, rng=None, drop_last=True):
    """Yield {'tokens': [B, seq_len+1]} batches from a 1-D token array
    (next-token LM convention: targets are inputs shifted by one)."""
    data = np.asarray(data)
    window = seq_len + 1
    n_windows = len(data) // window
    order = np.arange(n_windows)
    if rng is not None:
        rng.shuffle(order)
    batch = []
    for idx in order:
        batch.append(data[idx * window:(idx + 1) * window])
        if len(batch) == batch_size:
            yield {"tokens": np.stack(batch)}
            batch = []
    if batch and not drop_last:
        yield {"tokens": np.stack(batch)}


def token_batches(data, batch_size, seq_len, *, rng=None, drop_last=True):
    """Yield {'tokens': [B, seq_len+1]} batches from a 1-D token array
    (next-token LM convention: targets are inputs shifted by one)."""
    data = np.asarray(data)
    window = seq_len + 1
    n_windows = len(data) // window
    order = np.arange(n_windows)
    if rng is not None:
        rng.shuffle(order)
    batch = []
    for idx in order:
        batch.append(data[idx * window:(idx + 1) * window])
        if len(batch) == batch_size:
            yield {"tokens": np.stack(batch)}
            batch = []
    if batch and not drop_last:
        yield {"tokens": np.stack(batch)}



def prefetch(iterator, depth=2, device=None):
    """Run `iterator` in a background thread, keeping `depth` items ready.

    With `device`, each item (a dict batch) arrives with its arrays as
    tensors on that device and its STATE_KEY stamp untouched on the host.
    On a CUDA device the producer thread pins each array and copies it on a
    stream of its own, so the copy of the next batch overlaps the current
    step; the consumer's stream waits for the copy before the batch is
    handed over. device=None hands the items over as they are."""
    device = None if device is None else torch.device(device)
    stream = None
    if device is not None and device.type == "cuda":
        stream = torch.cuda.Stream(device)
    queue = collections.deque()
    lock = threading.Condition()
    done = []
    error = []
    stopped = []

    def producer():
        try:
            for item in iterator:
                if device is not None:
                    item = _to_device(item, device, stream)
                with lock:
                    while len(queue) >= depth and not stopped:
                        lock.wait()
                    if stopped:
                        return
                    queue.append(item)
                    lock.notify_all()
        except BaseException as ex:  # surface in the consumer, never swallow
            with lock:
                error.append(ex)
                lock.notify_all()
        finally:
            with lock:
                done.append(True)
                lock.notify_all()

    thread = threading.Thread(target=producer, daemon=True,
                              name="prefetch")
    thread.start()
    try:
        while True:
            with lock:
                while not queue and not done:
                    lock.wait()
                if queue:
                    item = queue.popleft()
                    lock.notify_all()
                elif error:
                    raise error[0]
                else:
                    return
            if stream is not None:
                item = _handed_over(item, device)
            yield item
    finally:
        # consumer stopped early (break / close): release the producer so
        # the thread and its prefetched device buffers are reclaimed
        with lock:
            stopped.append(True)
            queue.clear()
            lock.notify_all()


def _to_device(batch, device, stream):
    """The batch's arrays as tensors on `device`, the stamp kept on the
    host; on a CUDA device copied from pinned memory on `stream`, with the
    event that marks the copies' end."""
    out = {}
    for key, value in batch.items():
        if key == STATE_KEY:
            out[key] = value
            continue
        t = torch.as_tensor(value)
        if stream is None:
            out[key] = t.to(device)
            continue
        with torch.cuda.stream(stream):
            out[key] = t.pin_memory().to(device, non_blocking=True)
    if stream is None:
        return out
    done = torch.cuda.Event()
    done.record(stream)
    return out, done


def _handed_over(item, device):
    """A copied batch, once the consumer's stream has waited for its
    copies; its tensors are marked as used there, so the allocator does not
    hand their memory to the copy stream while the step still reads it."""
    batch, done = item
    current = torch.cuda.current_stream(device)
    current.wait_event(done)
    for key, value in batch.items():
        if key != STATE_KEY:
            value.record_stream(current)
    return batch
