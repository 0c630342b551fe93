"""Remote log capture wrapper: run a task command, persist its logs.

On a cluster there is no local scheduler reaping worker pipes (runtime.py
does that for local runs), so a remote pod wraps its `step` command in this
module:

    python -m metaflow_tpu_torch.mflog_capture \
        --flow-name F --run-id R --step S --task-id T --attempt 0 \
        --datastore local --datastore-root /path/to/root \
        -- python flow.py --quiet ... step ...

It tees the child's stdout/stderr through (so `kubectl logs` still works),
buffers them with mflog structured headers, and persists both streams to the
task datastore when the child exits — success OR failure — then exits with
the child's return code. Fills the role of the reference's bash capture
wrapper + save_logs (metaflow/metaflow_environment.py:192,
metaflow/mflog/save_logs.py), as one supervising process instead of shell
redirection.

Flush cadence: logs are (re)persisted on a sigmoid schedule over task age —
sub-second-ish early (when a user is most likely watching a fresh task) and
settling at 30s for long runs, so a killed pod loses at most the last window
of output (ref: metaflow/mflog/__init__.py:69-81 uses the same curve shape).
"""

import argparse
import math
import os
import selectors
import subprocess
import sys
import time

from . import mflog
from .datastore import FlowDataStore
from .datastore.storage import STORAGE_BACKENDS

MIN_FLUSH_SECS = 1.0
MAX_FLUSH_SECS = 30.0
# sigmoid midpoint/steepness: ~MIN for the first few minutes, ~half-range
# at 10 minutes, ~MAX from 20 minutes on
_HALFWAY_SECS = 600.0
_RAMP_SECS = 150.0


def _flush_delay(secs_since_start):
    s = 1.0 / (1.0 + math.exp((_HALFWAY_SECS - secs_since_start)
                              / _RAMP_SECS))
    return MIN_FLUSH_SECS + s * (MAX_FLUSH_SECS - MIN_FLUSH_SECS)


def capture(args, child_argv):
    storage_impl = STORAGE_BACKENDS[args.datastore]
    flow_ds = FlowDataStore(
        args.flow_name, storage_impl, ds_root=args.datastore_root
    )
    task_ds = flow_ds.get_task_datastore(
        args.run_id, args.step, args.task_id, attempt=args.attempt, mode="w"
    )

    from .util import preexec_die_with_parent

    # the child must not outlive this supervisor: locally the gang
    # teardown chain is control →(PDEATHSIG) capture →(PDEATHSIG) step,
    # and a SIGKILLed capture must never orphan a rank wedged in a
    # collective (on a cluster the pod cgroup covers this; arming it
    # everywhere keeps local semantics identical)
    proc = subprocess.Popen(
        child_argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        preexec_fn=preexec_die_with_parent(os.getpid()),
    )
    os.set_blocking(proc.stdout.fileno(), False)
    os.set_blocking(proc.stderr.fileno(), False)

    # graceful-stop parity with the unsupervised rank: a SIGTERM to this
    # supervisor FORWARDS to the child (whose preemption/shield handler
    # gets its grace window) rather than dying instantly and letting
    # PDEATHSIG SIGKILL the rank mid-checkpoint; the loop below then
    # drains the tail and persists a final log snapshot
    import signal

    def _forward_term(signum, frame):
        try:
            proc.terminate()
        except OSError:
            pass

    signal.signal(signal.SIGTERM, _forward_term)

    bufs = {"stdout": b"", "stderr": b""}
    partial = {"stdout": b"", "stderr": b""}
    passthrough = {"stdout": sys.stdout.buffer, "stderr": sys.stderr.buffer}

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ, "stdout")
    sel.register(proc.stderr, selectors.EVENT_READ, "stderr")
    open_streams = 2

    def drain(fileobj, name):
        nonlocal open_streams
        try:
            data = fileobj.read()
        except (OSError, ValueError):
            data = b""
        if not data:
            sel.unregister(fileobj)
            open_streams -= 1
            return
        passthrough[name].write(data)
        passthrough[name].flush()
        chunk = partial[name] + data
        lines = chunk.split(b"\n")
        partial[name] = lines.pop()
        for line in lines:
            bufs[name] += mflog.decorate(mflog.TASK, line)

    def persist():
        out = {
            n: bufs[n] + (mflog.decorate(mflog.TASK, partial[n])
                          if partial[n] else b"")
            for n in bufs
        }
        try:
            # same logsource name the local scheduler uses when it reaps
            # worker pipes — the logs CLI and client read this file
            task_ds.save_logs("runtime", out)
        except Exception as ex:  # a failed upload must not kill the task
            sys.stderr.write("mflog_capture: log upload failed: %s\n" % ex)

    start = time.time()
    next_flush = start + _flush_delay(0)
    rc = None
    while True:
        if open_streams:
            events = sel.select(timeout=0.2)
        else:  # child closed its stdio but still runs: just poll it
            time.sleep(0.2)
            events = []
        for key, _ in events:
            drain(key.fileobj, key.data)
        now = time.time()
        if now >= next_flush:
            persist()
            next_flush = now + _flush_delay(now - start)
        if rc is None:
            rc = proc.poll()
        # exit on child death even while pipe write-ends survive in a
        # grandchild — the gang watcher polls THIS process's rc to
        # detect a dead rank, so lingering here would stall failure
        # detection (it used to poll the rank directly). Keep draining
        # only while data is actually arriving.
        if rc is not None and (not open_streams or not events):
            # final non-blocking drain: the child can write and exit in
            # the window between the (empty) select above and poll() —
            # those last bytes are still sitting in the pipes and would
            # otherwise never be persisted
            while open_streams:
                events = sel.select(timeout=0)
                if not events:
                    break
                for key, _ in events:
                    drain(key.fileobj, key.data)
            break
    for name in partial:
        if partial[name]:
            bufs[name] += mflog.decorate(mflog.TASK, partial[name])
            partial[name] = b""
    persist()
    return rc


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mflog_capture")
    parser.add_argument("--flow-name", required=True)
    parser.add_argument("--run-id", required=True)
    parser.add_argument("--step", required=True)
    parser.add_argument("--task-id", required=True)
    parser.add_argument("--attempt", type=int, default=0)
    parser.add_argument("--datastore", default="local")
    parser.add_argument("--datastore-root", default=None)
    args, rest = parser.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    if not rest:
        parser.error("no command given after '--'")
    sys.exit(capture(args, rest))


if __name__ == "__main__":
    main()
