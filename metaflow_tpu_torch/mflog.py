"""Structured task-log protocol.

Reference behavior: metaflow/mflog/ — lines are tagged
`[MFLOG|0|timestamp|source|id]message` so streams from different sources
(runtime vs task, multiple attempts) merge deterministically by timestamp.
The runtime's Worker tags captured lines on persist; readers merge + strip.
"""

from datetime import datetime, timezone

VERSION = b"0"
RUNTIME = b"runtime"
TASK = b"task"

_DELIM = b"|"
_HEAD = b"[MFLOG" + _DELIM


def utc_timestamp():
    return datetime.now(timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%f")


def decorate(source, line, now=None):
    """Tag one raw line (bytes) with the mflog header."""
    if isinstance(line, str):
        line = line.encode("utf-8")
    now = now or utc_timestamp()
    return b"".join(
        (_HEAD, VERSION, _DELIM, now.encode("ascii"), _DELIM, source, b"]",
         line.rstrip(b"\n"), b"\n")
    )


def decorate_stream(source, data):
    """Tag every line of a raw byte stream."""
    now = utc_timestamp()
    return b"".join(
        decorate(source, line, now) for line in data.split(b"\n") if line
    )


def parse(line):
    """Parse a tagged line → (timestamp_str, source, message) or None."""
    if not line.startswith(_HEAD):
        return None
    try:
        rest = line[len(_HEAD):]
        version, ts, rest = rest.split(_DELIM, 2)
        source, _, message = rest.partition(b"]")
        return ts.decode("ascii"), source.decode("ascii"), message
    except ValueError:
        return None


def merge_logs(streams):
    """Merge multiple tagged byte streams in timestamp order.

    streams: iterable of bytes. Untagged lines sort with their neighbours'
    timestamps (legacy logs stay readable)."""
    records = []
    for stream_idx, data in enumerate(streams):
        last_ts = ""
        for line_idx, line in enumerate(data.split(b"\n")):
            if not line:
                continue
            parsed = parse(line)
            if parsed:
                ts, source, message = parsed
                last_ts = ts
            else:
                ts, source, message = last_ts, "raw", line
            records.append((ts, stream_idx, line_idx, source, message))
    records.sort(key=lambda r: (r[0], r[1], r[2]))
    return records


def format_merged(streams, show_source=False, show_timestamp=False):
    out = []
    for ts, _si, _li, source, message in merge_logs(streams):
        prefix = b""
        if show_timestamp and ts:
            prefix += ts.encode("ascii") + b" "
        if show_source:
            prefix += b"[" + source.encode("ascii") + b"] "
        out.append(prefix + message)
    return b"\n".join(out) + (b"\n" if out else b"")
