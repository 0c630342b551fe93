"""OpenMetrics rendering of the serving scheduler's counters (GET
/metrics): the part of the JAX package's goodput module that the HTTP
server needs. `render_openmetrics(scheduler_metric_families(stats))`
gives, byte for byte, the text the JAX package renders from the same
Scheduler.stats() dict. The goodput ledger of training runs waits for the
training-telemetry slice.
"""

SERVE_PREFILL = "serve_prefill"
SERVE_DECODE = "serve_decode"
SERVE_IDLE = "serve_idle"

OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")

_TYPES = ("gauge", "counter", "summary", "info", "unknown")


class Family(object):
    """One OpenMetrics metric family: a TYPE + HELP header and its
    samples. Counter samples get the mandatory `_total` suffix at
    render time; summary samples carry their quantile label."""

    def __init__(self, name, mtype, help_text=""):
        if mtype not in _TYPES:
            raise ValueError("bad metric type %r" % (mtype,))
        self.name = name
        self.mtype = mtype
        self.help_text = help_text
        self.samples = []  # (suffix, labels, value)

    def add(self, value, labels=None, suffix=None):
        if suffix is None:
            suffix = "_total" if self.mtype == "counter" else ""
        self.samples.append((suffix, dict(labels or {}), value))
        return self


def _escape_label(value):
    return (str(value).replace("\\", "\\\\").replace("\"", "\\\"")
            .replace("\n", "\\n"))


def _escape_help(value):
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value):
    if isinstance(value, bool):
        return "1" if value else "0"
    if value is None:
        return "0"
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_openmetrics(families):
    """Families -> OpenMetrics text (terminated by the mandatory
    `# EOF` line)."""
    lines = []
    for fam in families:
        lines.append("# TYPE %s %s" % (fam.name, fam.mtype))
        if fam.help_text:
            lines.append("# HELP %s %s"
                         % (fam.name, _escape_help(fam.help_text)))
        for suffix, labels, value in fam.samples:
            if labels:
                label_str = "{%s}" % ",".join(
                    "%s=\"%s\"" % (k, _escape_label(v))
                    for k, v in sorted(labels.items()))
            else:
                label_str = ""
            lines.append("%s%s%s %s" % (fam.name, suffix, label_str,
                                        _format_value(value)))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def scheduler_metric_families(stats):
    """Scheduler.stats() -> replica-scope metric families. Every value
    is read from the SAME stats dict /v1/stats serves, so the two
    surfaces cannot disagree."""
    fams = []

    def gauge(name, value, help_text="", labels=None):
        fams.append(Family(name, "gauge", help_text).add(value, labels))

    gauge("tpuflow_serve_queue_depth", stats["queue_depth"],
          "Requests waiting for a slot")
    gauge("tpuflow_serve_in_flight", stats["in_flight"],
          "Requests occupying slots")
    gauge("tpuflow_serve_slots", stats["slots"], "Decode slot capacity")
    gauge("tpuflow_serve_occupancy", stats["occupancy"],
          "Instantaneous slot occupancy")
    gauge("tpuflow_serve_mean_batch_occupancy",
          stats["mean_batch_occupancy"],
          "Mean decode-batch occupancy over all decode steps")
    gauge("tpuflow_serve_draining", bool(stats["draining"]),
          "1 while a graceful drain is in progress")
    gauge("tpuflow_serve_peak_in_flight", stats["peak_in_flight"],
          "High-water mark of concurrent requests")
    gauge("tpuflow_serve_max_context_tokens",
          stats["max_context_tokens"],
          "Largest prompt+max_new this engine admits")
    fams.append(
        Family("tpuflow_serve_requests", "counter",
               "Requests finished, by outcome")
        .add(stats["served"], {"outcome": "served"})
        .add(stats["cancelled"], {"outcome": "cancelled"}))
    fams.append(Family("tpuflow_serve_decode_steps", "counter",
                       "Batched decode steps executed")
                .add(stats["decode_steps"]))
    fams.append(Family("tpuflow_serve_iterations", "counter",
                       "Scheduler loop iterations")
                .add(stats["iterations"]))
    ttft = Family("tpuflow_serve_ttft_ms", "summary",
                  "Time to first token, rolling window")
    ttft.add(stats["p50_ttft_ms"] or 0.0, {"quantile": "0.5"})
    ttft.add(stats["p99_ttft_ms"] or 0.0, {"quantile": "0.99"})
    fams.append(ttft)
    itl = Family("tpuflow_serve_itl_ms", "summary",
                 "Inter-token latency, rolling window")
    itl.add(stats["p50_itl_ms"] or 0.0, {"quantile": "0.5"})
    itl.add(stats["p99_itl_ms"] or 0.0, {"quantile": "0.99"})
    fams.append(itl)
    prefix = stats.get("prefix_cache") or {}
    if prefix.get("enabled"):
        fams.append(
            Family("tpuflow_serve_prefix_lookups", "counter",
                   "Prefix-cache lookups, by result")
            .add(prefix["hits"], {"result": "hit"})
            .add(prefix["misses"], {"result": "miss"}))
        gauge("tpuflow_serve_prefix_hit_rate", prefix["hit_rate"],
              "Prefix-cache hit rate")
        gauge("tpuflow_serve_prefix_tokens_skipped_frac",
              prefix["prefill_tokens_skipped_frac"],
              "Fraction of prompt tokens served from cache")
    kv = stats.get("kv_pages") or {}
    if kv.get("enabled"):
        used = int(kv.get("pages_total", 0)) - int(kv.get("pages_free", 0))
        pages = Family("tpuflow_serve_kv_pages", "gauge",
                       "Paged-KV pool pages, by state")
        pages.add(used, {"state": "used"})
        pages.add(kv.get("pages_free", 0), {"state": "free"})
        pages.add(kv.get("shared_pages", 0), {"state": "shared"})
        pages.add(kv.get("cow_pages", 0), {"state": "cow"})
        fams.append(pages)
        gauge("tpuflow_serve_kv_occupancy", kv.get("occupancy", 0.0),
              "Paged-KV pool occupancy")
        fams.append(Family("tpuflow_serve_kv_exhausted", "counter",
                           "Admission stalls on page exhaustion")
                    .add(kv.get("exhausted", 0)))
    spec = stats.get("speculative") or {}
    if spec.get("enabled"):
        gauge("tpuflow_serve_spec_accept_rate",
              spec.get("accept_rate", 0.0),
              "Speculative-decode draft acceptance rate")
    goodput = stats.get("goodput") or {}
    if goodput:
        chip = Family("tpuflow_serve_goodput_seconds", "counter",
                      "Serving chip-seconds, by goodput category")
        chip.add(goodput.get("serve_prefill_s", 0.0),
                 {"category": SERVE_PREFILL})
        chip.add(goodput.get("serve_decode_s", 0.0),
                 {"category": SERVE_DECODE})
        chip.add(goodput.get("serve_idle_s", 0.0),
                 {"category": SERVE_IDLE})
        fams.append(chip)
    return fams
