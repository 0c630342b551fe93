"""Event publishing + the `current.trigger` view (the JAX package's
events module, which follows metaflow/events.py and
plugins/argo/argo_events.py ArgoEvent.publish).

Events append to a JSONL bus under the datastore root; the publisher
POSTs to an Argo Events webhook instead when TPUFLOW_ARGO_EVENTS_URL is
configured. A run announces its successful end here; a run started by an
event reads it back as `current.trigger`. The flow decorators that
subscribe to events (@trigger, @trigger_on_finish) and the local trigger
listener are not in the port yet.
"""

import json
import os
import time

from . import knobs
from .util import get_tpuflow_root


class MetaflowEvent(object):
    """A consumed event, exposed via `current.trigger.event`."""

    def __init__(self, name, payload=None, timestamp=None, id=None):
        self.name = name
        self.payload = payload or {}
        self.timestamp = timestamp or time.time()
        self.id = id

    def __repr__(self):
        return "MetaflowEvent(name=%r)" % self.name


class Trigger(object):
    """`current.trigger` for event-triggered runs."""

    def __init__(self, events):
        self._events = [
            e if isinstance(e, MetaflowEvent) else MetaflowEvent(**e)
            for e in events
        ]

    @property
    def event(self):
        return self._events[0] if self._events else None

    @property
    def events(self):
        return list(self._events)

    def __bool__(self):
        return bool(self._events)


class ArgoEvent(object):
    """Publisher: ArgoEvent('new_data').publish(payload={...})."""

    def __init__(self, name, url=None):
        self.name = name
        self.url = url or knobs.get_str("TPUFLOW_ARGO_EVENTS_URL")
        self._payload = {}

    def add_to_payload(self, key, value):
        self._payload[key] = value
        return self

    def publish(self, payload=None, force=True):
        body = dict(self._payload)
        body.update(payload or {})
        record = {
            "name": self.name,
            "payload": body,
            "timestamp": time.time(),
        }
        if self.url:
            import urllib.request

            req = urllib.request.Request(
                self.url,
                data=json.dumps(record).encode("utf-8"),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=10)
        else:
            # local bus: append-only JSONL under the datastore root
            path = os.path.join(get_tpuflow_root(), "_events", "events.jsonl")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record


def publish_event(name, payload=None):
    return ArgoEvent(name).publish(payload=payload)


def run_finished_event_names(flow):
    """Event names announcing a successful run of `flow`: the plain flow
    name, plus the @project-namespaced variant when one is active
    (reference: argo_events.py publishes both forms so
    @trigger_on_finish works across and within projects)."""
    names = ["run-finished.%s" % flow.name]
    from .current import current

    project_flow = getattr(current, "project_flow_name", None)
    if project_flow:
        names.append("run-finished.%s" % project_flow)
    return names


def publish_run_finished(flow, run_id):
    """Emit run-finished events at run completion — local JSONL bus
    always, Argo Events webhook when TPUFLOW_ARGO_EVENTS_URL is set.
    Publishing is observability: it must never fail the run."""
    import sys

    records = []
    for name in run_finished_event_names(flow):
        try:
            records.append(publish_event(name, payload={
                "flow": flow.name,
                "run_id": str(run_id),
                "status": "successful",
            }))
        except Exception as ex:
            print("warning: could not publish %s: %s" % (name, ex),
                  file=sys.stderr)
    return records


def list_events(since=None, root=None):
    path = os.path.join(root or get_tpuflow_root(), "_events",
                        "events.jsonl")
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                record = json.loads(line)
            except json.JSONDecodeError:
                continue
            if since is None or record.get("timestamp", 0) >= since:
                out.append(record)
    return out
