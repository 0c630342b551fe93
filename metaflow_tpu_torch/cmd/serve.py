"""Serve a model over HTTP on the card: the port of the JAX package's
`tpuflow serve` building blocks.

build_config, extract_params, build_engine and build_prefix_cache resolve
a checkpoint pytree into a config, weights, an engine (the slot engine, or
the paged engine with speculative decoding) and its prefix cache, as the
JAX package does; serve() then wires engine -> Scheduler -> ServingServer
and serves until SIGTERM/SIGINT (or returns the running server).

Not ported yet: loading a flow run's checkpoint (load_run_checkpoint and
the FLOW/RUN form of serve, which need the flow client) and the command
line, the replica fleet (serve_fleet, reload_fleet), the federation front
tier (serve_federate) and serving on a mesh of several cards (mesh_spec).
"""

import json
import os

from .. import knobs


class ServeError(Exception):
    """A serve configuration the port cannot act on (the JAX package
    raises its TpuFlowException with the same message)."""


def build_config(restored, config_json=None, model="llama"):
    """Resolve the model config for a restored checkpoint pytree.

    Priority: config_json (a file path or inline JSON object of
    LlamaConfig/MixtralConfig field overrides) > a 'cfg'/'config' dict
    the checkpoint itself carries. The named `model` family supplies the
    dataclass."""
    if model == "mixtral":
        from ..models.mixtral import MixtralConfig as config_cls
    elif model == "llama":
        from ..models.llama import LlamaConfig as config_cls
    else:
        raise ServeError("unknown model family %r" % (model,))
    fields = None
    if config_json:
        if os.path.exists(config_json):
            with open(config_json) as f:
                fields = json.load(f)
        else:
            try:
                fields = json.loads(config_json)
            except ValueError:
                raise ServeError(
                    "--config-json is neither a file nor valid JSON: %r"
                    % (config_json,))
    elif isinstance(restored, dict):
        for key in ("cfg", "config"):
            if isinstance(restored.get(key), dict):
                fields = dict(restored[key])
                break
    if fields is None:
        raise ServeError(
            "no model config: pass --config-json (LlamaConfig fields as "
            "JSON) or checkpoint a 'cfg' dict next to the params")
    if not isinstance(fields, dict):
        raise ServeError("model config must be a JSON object")
    known = {f.name for f in config_cls.__dataclass_fields__.values()}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ServeError(
            "unknown %s field(s): %s" % (config_cls.__name__,
                                         ", ".join(unknown)))
    return config_cls(**fields)


def extract_params(restored, params_key="params"):
    """The weight pytree inside a checkpoint: restored[params_key] when
    present, else the whole tree (a bare-params checkpoint)."""
    if isinstance(restored, dict) and params_key in restored:
        return restored[params_key]
    return restored


def build_engine(params, cfg, slots=8, max_seq_len=None, prefill_chunk=64,
                 mesh_spec=None, attn_impl="auto", paged=False,
                 page_tokens=None, spec_k=None, device="cuda"):
    """The engine over `params` (already on `device`): the slot engine, or
    (paged=True / TPUFLOW_PAGED=1) the paged-KV engine with optional
    speculative decoding."""
    from ..serving import PagedEngine, SlotEngine

    if mesh_spec:
        raise NotImplementedError(
            "serving on a mesh (mesh_spec=%r) needs several cards; it "
            "waits for the multi-GPU slice of the port" % (mesh_spec,))
    if paged or knobs.get_bool("TPUFLOW_PAGED"):
        return PagedEngine(params, cfg, max_slots=slots,
                           max_seq_len=max_seq_len,
                           prefill_chunk=prefill_chunk, attn_impl=attn_impl,
                           page_tokens=page_tokens, spec_k=spec_k,
                           device=device)
    return SlotEngine(params, cfg, max_slots=slots, max_seq_len=max_seq_len,
                      prefill_chunk=prefill_chunk, attn_impl=attn_impl,
                      device=device)


def build_prefix_cache(engine, prefix_cache_mb=None):
    """The prefix cache matched to the engine: a zero-copy
    PagedPrefixIndex over the paged engine's own pool, a host-side
    RadixPrefixCache otherwise. No byte budget (argument or
    TPUFLOW_PREFIX_CACHE_MB), no cache."""
    from ..serving import PagedPrefixIndex, RadixPrefixCache

    pool = getattr(engine, "pool", None)
    if pool is not None:
        if prefix_cache_mb is None:
            return PagedPrefixIndex.from_env(pool)
        if int(prefix_cache_mb) <= 0:
            return None
        pages = max(1, (int(prefix_cache_mb) << 20)
                    // max(1, pool.page_bytes()))
        return PagedPrefixIndex(pool,
                                max_pages=min(pages, pool.usable_pages))
    if prefix_cache_mb is None:
        return RadixPrefixCache.from_env()
    return (RadixPrefixCache(int(prefix_cache_mb) << 20)
            if int(prefix_cache_mb) > 0 else None)


def serve(params, cfg, host="127.0.0.1", port=8000, slots=8,
          max_seq_len=None, prefill_chunk=64, max_queue=64, mesh_spec=None,
          attn_impl="auto", prefix_cache_mb=None, paged=False,
          page_tokens=None, spec_k=None, device="cuda", echo=print,
          block=True):
    """Serve `params` (on `device`) over HTTP: engine -> Scheduler ->
    ServingServer, as the JAX package's serve() does once it has loaded
    the checkpoint. Returns the running ServingServer when block=False;
    otherwise serves until SIGTERM/SIGINT, draining in-flight requests
    before it returns."""
    from .. import telemetry
    from ..serving import Scheduler, ServingServer

    engine = build_engine(params, cfg, slots=slots, max_seq_len=max_seq_len,
                          prefill_chunk=prefill_chunk, mesh_spec=mesh_spec,
                          attn_impl=attn_impl, paged=paged,
                          page_tokens=page_tokens, spec_k=spec_k,
                          device=device)
    cache = build_prefix_cache(engine, prefix_cache_mb)
    scheduler = Scheduler(engine, max_queue=max_queue, prefix_cache=cache)
    server = ServingServer(scheduler, host=host, port=port)
    if hasattr(engine, "pool"):
        echo("serving on http://%s:%d  (paged: %d slots, %d pages x %d "
             "tokens, spec_k=%d, attn=%s)"
             % (server.host, server.port, engine.max_slots,
                engine.pool.usable_pages, engine.page_tokens,
                engine.spec_k, engine.attn_impl))
    else:
        echo("serving on http://%s:%d  (%d slots x %d positions, attn=%s)"
             % (server.host, server.port, engine.max_slots,
                engine.max_seq_len, engine.attn_impl))
    echo("  POST /v1/generate  {\"tokens\": [...], \"max_new_tokens\": N,"
         " \"stream\": true}")
    if not block:
        server.start()
        return server
    try:
        server.serve_forever()
    finally:
        telemetry.close_recorder()
    echo("drained — all in-flight requests finished")

