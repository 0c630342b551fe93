"""Serve a model over HTTP on the card: the port of the JAX package's
`tpuflow serve` (cmd/serve.py).

build_config, extract_params, build_engine and build_prefix_cache resolve
a checkpoint pytree into a config, weights, an engine (the slot engine, or
the paged engine with speculative decoding) and its prefix cache, as the
JAX package does; serve() then wires engine -> Scheduler -> ServingServer
and serves until SIGTERM/SIGINT (or returns the running server). serve()
takes either weights already in this process, `serve(params, cfg)`, or a
flow run whose @checkpoint it loads, `serve("FLOW[/RUN]")` (the command
line: `python -m metaflow_tpu_torch serve FLOW[/RUN] --paged ...`).

Not ported yet: the replica fleet (serve_fleet, reload_fleet: --replicas,
--prefill-workers, --reload), the federation front tier (serve_federate:
--federate) and serving on a mesh of several cards (mesh_spec).
"""

import json
import os

from .. import knobs
from ..exception import TpuFlowException


class ServeError(TpuFlowException):
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
            "serving on a mesh (mesh_spec=%r) is not ported yet "
            "(ROADMAP.md, slice 5, multi-GPU: serving on a mesh)"
            % (mesh_spec,))
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


def serve(params, cfg=None, host="127.0.0.1", port=8000, slots=8,
          max_seq_len=None, prefill_chunk=64, max_queue=64, mesh_spec=None,
          attn_impl="auto", prefix_cache_mb=None, paged=False,
          page_tokens=None, spec_k=None, device="cuda", echo=print,
          block=True, **run_kw):
    """Serve `params` (on `device`) over HTTP: engine -> Scheduler ->
    ServingServer, as the JAX package's serve() does once it has loaded
    the checkpoint. Returns the running ServingServer when block=False;
    otherwise serves until SIGTERM/SIGINT, draining in-flight requests
    before it returns.

    With a str first argument, `serve("FLOW[/RUN]", run_id=None, ...)`
    serves a flow run's checkpoint instead (serve_run; `run_kw` takes its
    other arguments, and a str `cfg` is the run id)."""
    if isinstance(params, str):
        if cfg is not None:
            run_kw.setdefault("run_id", cfg)
        return serve_run(params, host=host, port=port, slots=slots,
                         max_seq_len=max_seq_len,
                         prefill_chunk=prefill_chunk, max_queue=max_queue,
                         mesh_spec=mesh_spec, attn_impl=attn_impl,
                         prefix_cache_mb=prefix_cache_mb, paged=paged,
                         page_tokens=page_tokens, spec_k=spec_k,
                         device=device, echo=echo, block=block, **run_kw)
    if run_kw:
        raise TypeError("serve(params, cfg) takes no %s"
                        % ", ".join(sorted(run_kw)))
    engine = build_engine(params, cfg, slots=slots, max_seq_len=max_seq_len,
                          prefill_chunk=prefill_chunk, mesh_spec=mesh_spec,
                          attn_impl=attn_impl, paged=paged,
                          page_tokens=page_tokens, spec_k=spec_k,
                          device=device)
    return _serve_engine(engine, "", host=host, port=port,
                         max_queue=max_queue,
                         prefix_cache_mb=prefix_cache_mb, echo=echo,
                         block=block)


def _serve_engine(engine, label, host, port, max_queue, prefix_cache_mb,
                  echo, block):
    """engine -> prefix cache -> Scheduler -> ServingServer."""
    from .. import telemetry
    from ..serving import Scheduler, ServingServer

    cache = build_prefix_cache(engine, prefix_cache_mb)
    scheduler = Scheduler(engine, max_queue=max_queue, prefix_cache=cache)
    server = ServingServer(scheduler, host=host, port=port)
    if hasattr(engine, "pool"):
        echo("serving %son http://%s:%d  (paged: %d slots, %d pages x %d "
             "tokens, spec_k=%d, attn=%s)"
             % (label, server.host, server.port, engine.max_slots,
                engine.pool.usable_pages, engine.page_tokens,
                engine.spec_k, engine.attn_impl))
    else:
        echo("serving %son http://%s:%d  (%d slots x %d positions, attn=%s)"
             % (label, server.host, server.port, engine.max_slots,
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


def _init_serve_telemetry(flow_name, run_id, task_prefix="server"):
    """Record serving telemetry into the served run's datastore under a
    synthetic `_serve` step, riding the FlightRecorder."""
    from .. import metaflow_config as cfg
    from .. import telemetry
    from ..datastore import STORAGE_BACKENDS, FlowDataStore

    if not telemetry.enabled():
        return None
    try:
        storage = STORAGE_BACKENDS[cfg.default_datastore()]
        fds = FlowDataStore(flow_name, storage)
        return telemetry.init_recorder(
            fds, run_id, "_serve",
            "%s-%d" % (task_prefix, os.getpid()))
    except Exception:
        return None  # serving must come up even if telemetry cannot


def _resolve_flow_run(flow_run, run_id):
    """FLOW/RUN (or FLOW + run_id) -> (flow_name, run_id), falling back
    to the latest successful run so telemetry lands under the real run
    id."""
    if run_id is None:
        flow_name, _, run_id = flow_run.rpartition("/")
        if not flow_name:
            flow_name, run_id = flow_run, None
    else:
        flow_name = flow_run
    if run_id is None:
        from ..inference.loading import _latest_successful_run_id

        run_id = _latest_successful_run_id(flow_name, None)
        if run_id is None:
            raise TpuFlowException(
                "No successful run of %s to serve." % flow_name)
    return flow_name, run_id


def _to_device(tree, device):
    """Move a restored tree's tensors to `device` in place, leaf by leaf,
    so at most one leaf exists twice (the 8B's 16 GB of weights never
    twice on the host)."""
    import torch

    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in list(items):
        if isinstance(value, torch.Tensor):
            tree[key] = value.to(device)
        elif isinstance(value, (dict, list)):
            _to_device(value, device)
    return tree


def serve_run(flow_run, run_id=None, step_name=None, ckpt_step=None,
              params_key="params", config_json=None, model="llama",
              host="127.0.0.1", port=8000, replicas=1, slots=8,
              max_seq_len=None, prefill_chunk=64, max_queue=64,
              mesh_spec=None, attn_impl="auto", prefill_workers=0,
              prefix_cache_mb=None, paged=False, page_tokens=None,
              spec_k=None, reload_checkpoint=False, federate=None,
              device="cuda", echo=print, block=True):
    """Load FLOW/RUN's checkpoint (load_run_checkpoint: the newest
    successful run by default, following its resume lineage) onto
    `device` and serve it. Returns the running ServingServer when
    block=False; otherwise serves until SIGTERM/SIGINT, draining
    in-flight requests before it returns."""
    from ..inference.loading import load_run_checkpoint

    if federate:
        raise NotImplementedError(
            "--federate: the federation front tier is not in the port yet")
    if reload_checkpoint:
        raise NotImplementedError(
            "--reload: rolling a checkpoint onto a running fleet needs the "
            "replica fleet, which is not in the port yet")
    if int(replicas) > 1 or int(prefill_workers) > 0:
        raise NotImplementedError(
            "--replicas/--prefill-workers: the replica fleet is not in the "
            "port yet; serve with one replica")
    # resolve the run HERE (not only inside load_run_checkpoint) so
    # telemetry lands under the real run id, next to its training records
    flow_name, run_id = _resolve_flow_run(flow_run, run_id)
    restored = load_run_checkpoint(flow_name, run_id=run_id,
                                   step_name=step_name, ckpt_step=ckpt_step)
    cfg = build_config(restored, config_json=config_json, model=model)
    params = _to_device(extract_params(restored, params_key=params_key),
                        device)
    del restored
    engine = build_engine(params, cfg, slots=slots, max_seq_len=max_seq_len,
                          prefill_chunk=prefill_chunk, mesh_spec=mesh_spec,
                          attn_impl=attn_impl, paged=paged,
                          page_tokens=page_tokens, spec_k=spec_k,
                          device=device)
    _init_serve_telemetry(flow_name, run_id)
    return _serve_engine(engine, "%s/%s " % (flow_name, run_id), host=host,
                         port=port, max_queue=max_queue,
                         prefix_cache_mb=prefix_cache_mb, echo=echo,
                         block=block)
