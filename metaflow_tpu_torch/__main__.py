"""The framework-level CLI: `python -m metaflow_tpu_torch <cmd>` (the JAX
package's __main__.py). Subcommands:

    version                      print the framework version
    serve FLOW[/RUN]             serve a run's checkpoint over HTTP

The JAX package's other subcommands (configure, tutorials, stubs, dataset,
metrics, goodput, trace, watch, knobs, online, devstack) are not in the
port yet.
"""

import click


@click.group()
def main():
    pass


@main.command()
def version():
    from . import __version__

    click.echo("metaflow_tpu_torch %s" % __version__)


@main.command(
    help="Serve a trained run's checkpoint over HTTP with the "
         "continuous-batching engine: `serve FLOW/RUN_ID` (or `serve "
         "FLOW` for the newest successful run). Slot-based or paged KV "
         "cache, per-request admission/eviction, streamed token output, "
         "graceful SIGTERM drain. The replica fleet (--replicas, "
         "--prefill-workers, --reload) and the federation tier "
         "(--federate) are not in the port yet: they raise.")
@click.argument("flow_run", required=False)
@click.argument("run_id", required=False)
@click.option("--step-name", default=None,
              help="The @checkpoint step (auto-detected when unique).")
@click.option("--ckpt-step", default=None, type=int,
              help="Which saved step to serve (default: latest).")
@click.option("--params-key", default="params",
              help="Key of the weight pytree inside the checkpoint.")
@click.option("--config-json", default=None,
              help="Model config as a JSON file or inline object "
                   "(default: the checkpoint's 'cfg' or 'config' entry).")
@click.option("--model", default="llama",
              type=click.Choice(["llama", "mixtral"]),
              help="Model family of the checkpoint.")
@click.option("--host", default="127.0.0.1")
@click.option("--port", default=8000, type=int)
@click.option("--replicas", default=1, type=int,
              help="Engine replica processes (the fleet: not in the port "
                   "yet; only 1 runs).")
@click.option("--slots", default=8, type=int,
              help="Concurrent sequences (KV-cache pool size).")
@click.option("--max-seq-len", default=None, type=int,
              help="KV-cache depth per slot (default: config max).")
@click.option("--prefill-chunk", default=64, type=int,
              help="Prompt tokens prefilled per chunk.")
@click.option("--max-queue", default=64, type=int,
              help="Queued requests before 429 backpressure.")
@click.option("--mesh", "mesh_spec", default=None,
              type=click.Choice(["dp", "fsdp", "fsdp_tp"]),
              help="Shard params over a device mesh (several cards: not "
                   "in the port yet).")
@click.option("--attn-impl", default="auto",
              type=click.Choice(["auto", "dense", "chunked"]))
@click.option("--prefill-workers", default=0, type=int,
              help="Dedicated prefill replicas (the fleet: not in the "
                   "port yet).")
@click.option("--prefix-cache-mb", default=None, type=int,
              help="Prefix-cache budget in MiB (0 disables; default: "
                   "TPUFLOW_PREFIX_CACHE_MB).")
@click.option("--paged", is_flag=True,
              help="Use the paged-KV engine: a global page pool + "
                   "per-slot block tables; prefix hits share pages "
                   "zero-copy.")
@click.option("--page-tokens", default=None, type=int,
              help="Tokens per KV page (default: "
                   "TPUFLOW_KV_PAGE_TOKENS or 16). Paged engine only.")
@click.option("--spec-k", default=None, type=int,
              help="Speculative decoding draft length (greedy traffic "
                   "only; 0 disables; default: TPUFLOW_SPEC_K). Paged "
                   "engine only.")
@click.option("--device", default="cuda",
              help="Device the weights and the KV cache live on.")
@click.option("--reload", "reload_checkpoint", is_flag=True,
              help="Roll the checkpoint onto a running fleet (not in the "
                   "port yet).")
@click.option("--federate", default=None, metavar="URLS",
              help="Run the federation front tier (not in the port yet).")
def serve(flow_run, run_id, step_name, ckpt_step, params_key, config_json,
          model, host, port, replicas, slots, max_seq_len, prefill_chunk,
          max_queue, mesh_spec, attn_impl, prefill_workers,
          prefix_cache_mb, paged, page_tokens, spec_k, device,
          reload_checkpoint, federate):
    from .cmd.serve import serve_run
    from .exception import TpuFlowException

    if not flow_run and not federate:
        raise click.ClickException(
            "FLOW_RUN is required (or pass --federate URL,URL)")
    try:
        serve_run(flow_run, run_id=run_id, step_name=step_name,
                  ckpt_step=ckpt_step, params_key=params_key,
                  config_json=config_json, model=model, host=host,
                  port=port, replicas=replicas, slots=slots,
                  max_seq_len=max_seq_len, prefill_chunk=prefill_chunk,
                  max_queue=max_queue, mesh_spec=mesh_spec,
                  attn_impl=attn_impl, prefill_workers=prefill_workers,
                  prefix_cache_mb=prefix_cache_mb, paged=paged,
                  page_tokens=page_tokens, spec_k=spec_k,
                  reload_checkpoint=reload_checkpoint, federate=federate,
                  device=device, echo=click.echo)
    except TpuFlowException as ex:
        raise click.ClickException(str(ex))


if __name__ == "__main__":
    main()
