"""The port's mesh training against the JAX package's, on the CPU.

MeshSpec presets and `resolved` against the JAX ones (errors included);
rules_for_mesh, tree_specs and zero_tree_specs of the tiny Llama's
logical_axes leaf by leaf against the PartitionSpecs JAX builds over its
virtual CPU devices; then one world of two gloo processes (a module
fixture) that trains the tiny Llama on {fsdp: 2} and on {data: 2} with
ZeRO off and on, in f32 and bf16, with AdamW and the factored optimizer,
for three steps, records telemetry, reads its rows from shard_iterator,
saves a sharded checkpoint and restores one saved off the mesh. The
workers also run the port's trainer off the mesh (each half of the
trajectories) and save the checkpoint the meshes restore. The test cases
read their results:

  - every one of the twelve trajectories against the port's own trainer
    off the mesh (whose parity with the JAX trainer tests/test_torch_train
    .py and tests/test_torch_optim.py hold), and seven of them against the
    JAX make_trainer on the same MeshSpec: each mesh and ZeRO setting with
    each optimizer once, in alternating dtypes, and {fsdp: 2} with AdamW
    in bf16, the chip's main path (each JAX configuration compiles for
    several seconds, so the other five are left to the chain above);
  - the checkpoint saved on the mesh read in this process, and the one
    saved off the mesh restored on the mesh, bit for bit.

The JAX package is imported inside the `ref` fixture, so the spawned gloo
workers, which import this module, stay free of jax."""

import os
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metaflow_tpu_torch.datastore import LocalFlowDataStore
from metaflow_tpu_torch.models import llama as port_llama
from metaflow_tpu_torch.spmd import mesh as port_mesh
from metaflow_tpu_torch.spmd import sharding as port_shd
from metaflow_tpu_torch.training import checkpoint as port_ckpt
from metaflow_tpu_torch.training import data as port_data
from metaflow_tpu_torch.training import train_step as port_ts

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

WORLD = 2
TIMEOUT_S = 180.0
STEPS = 3
BATCH = (4, 65)  # [B, S + 1]: two rows a rank

# loss and grad norm per step (tests/test_torch_optim.py's STEP_REL)
STEP_REL = {"float32": 1e-4, "bfloat16": 2e-2}

# (mesh, zero, optimizer, dtype) of each trajectory the workers run
MESHES = {"fsdp2": {"fsdp": 2}, "data2": {"data": 2}}
CONFIGS = [(m, z, o, d) for m, z in (("fsdp2", False), ("data2", False),
                                     ("data2", True))
           for o in ("adamw", "factored") for d in ("float32", "bfloat16")]
# the ones also held against the JAX make_trainer on the same MeshSpec
JAX_CONFIGS = [("fsdp2", False, "adamw", "float32"),
               ("fsdp2", False, "adamw", "bfloat16"),
               ("fsdp2", False, "factored", "bfloat16"),
               ("data2", False, "adamw", "bfloat16"),
               ("data2", False, "factored", "float32"),
               ("data2", True, "adamw", "float32"),
               ("data2", True, "factored", "bfloat16")]


def _id(config):
    m, z, o, d = config
    return "-".join([m] + (["zero"] if z else []) + [o, d])


def _optimizer(module, name):
    if name == "adamw":
        return module.default_optimizer(warmup_steps=1, total_steps=10)
    return module.memory_efficient_optimizer(warmup_steps=1,
                                             total_steps=10)


def _tokens():
    cfg = port_llama.LlamaConfig.tiny()
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, BATCH).astype(np.int32)


def _flat(tree, prefix=""):
    """{'a/b': array} of a nested dict of tensors (DTensors gathered)."""
    out = {}
    for key, value in tree.items():
        name = prefix + key
        if isinstance(value, dict):
            out.update(_flat(value, name + "/"))
        elif isinstance(value, torch.Tensor):
            if hasattr(value, "full_tensor"):
                value = value.full_tensor()
            out[name] = value.detach().float().numpy()
    return out


def _nest(flat):
    out = {}
    for name, value in flat.items():
        node = out
        *head, last = name.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = value
    return out


def _port_params(flat_f32, dtype):
    cfg = port_llama.LlamaConfig.tiny(dtype=dtype)
    return port_llama.from_jax_params(_nest(flat_f32), cfg, device="cpu")


def _train(config, params_f32, tokens, mesh=None, **kw):
    """Three steps of the port's trainer; (losses, grad norms, state)."""
    _, zero, opt, dtype = config
    cfg = port_llama.LlamaConfig.tiny(dtype=dtype)
    state, step = port_ts.make_trainer(
        cfg, port_llama, optimizer=_optimizer(port_ts, opt),
        params=_port_params(params_f32, dtype), device="cpu", mesh=mesh,
        zero=zero if mesh is not None else None, **kw)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, {"tokens": tokens})
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, state, step


# ---------------------------------------------------------------------------
# the gloo world
# ---------------------------------------------------------------------------

def _worker(rank, tmp):
    """One rank: every CONFIGS trajectory, telemetry, shard_iterator,
    the checkpoints and the refusals; results in <tmp>/rank<r>.npz."""
    from metaflow_tpu_torch import spmd, telemetry

    torch.set_num_threads(1)
    os.environ.pop("MF_PARALLEL_NODE_INDEX", None)
    dist.init_process_group("gloo", init_method="file://%s/init" % tmp,
                            rank=rank, world_size=WORLD)
    try:
        params = dict(np.load(os.path.join(tmp, "params.npz")))
        tokens = _tokens()
        meshes = {name: spmd.create_mesh(spmd.MeshSpec(axes), device="cpu")
                  for name, axes in MESHES.items()}
        out = {}
        # the port's trainer off the mesh, each rank half the trajectories;
        # rank 0's first one saved as the checkpoint the meshes restore
        for config in CONFIGS[rank::WORLD]:
            losses, norms, state, _ = _train(config, params, tokens)
            key = "single|" + _id(config)
            out[key + "|loss"] = np.array(losses)
            out[key + "|norm"] = np.array(norms)
            for part in ("params", "opt_state"):
                for name, value in _flat(state[part]).items():
                    out["%s|%s/%s" % (key, part, name)] = value
            if config == CONFIGS[0]:
                single = port_ckpt.AsyncCheckpointManager(
                    LocalFlowDataStore("MeshFlow",
                                       os.path.join(tmp, "single")),
                    name="single")
                single.save(state, STEPS)
                single.wait()
        dist.barrier()
        fds = LocalFlowDataStore("MeshFlow", os.path.join(tmp, "ds"))
        for config in CONFIGS:
            key = _id(config)
            tel = None
            if config == CONFIGS[0]:
                telemetry.init_recorder(fds, "r1", "train", "t%d" % rank)
                tel = {"tokens_per_step": BATCH[0] * (BATCH[1] - 1),
                       "flops_per_step": 1e9}
            losses, norms, state, step = _train(
                config, params, tokens, meshes[config[0]], telemetry=tel)
            out[key + "|loss"] = np.array(losses)
            out[key + "|norm"] = np.array(norms)
            for name, value in _flat(state["params"]).items():
                out[key + "|params/" + name] = value
            if tel:
                step.telemetry.close()
                out["n_devices"] = np.array(step.telemetry._chip_context()[0])
                telemetry.close_recorder()
                mgr = port_ckpt.AsyncCheckpointManager(fds, name="mesh")
                mgr.save(state, STEPS, extra={"rank": rank})
                mgr.wait()
                for name, value in _flat(state["opt_state"]).items():
                    out[key + "|opt_state/" + name] = value
        if rank == 0:
            records = telemetry.read_run_records(fds, "r1")
            out["record_ranks"] = np.array(sorted(
                {r["rank"] for r in records if r["name"] == "train.step"}))
        # the checkpoint saved off the mesh, restored onto each mesh one
        # leaf at a time (the whole blob is never loaded)
        store = LocalFlowDataStore("MeshFlow", os.path.join(tmp, "single"))
        store.ca_store.load_blobs = None
        single = port_ckpt.AsyncCheckpointManager(store, name="single")
        for mesh_name, zero in (("fsdp2", False), ("data2", True)):
            cfg = port_llama.LlamaConfig.tiny()
            state, _ = port_ts.make_trainer(
                cfg, port_llama, optimizer=_optimizer(port_ts, "adamw"),
                generator=torch.Generator().manual_seed(5), device="cpu",
                mesh=meshes[mesh_name], zero=zero, checkpoint=single)
            for part in ("params", "opt_state"):
                for name, value in _flat(state[part]).items():
                    out["restored_%s_%s|%s/%s" % (mesh_name, zero, part,
                                                  name)] = value
            out["restored_%s_%s|step" % (mesh_name, zero)] = np.array(
                [state["step"], state["opt_state"]["count"]])
        # this rank's rows of two stamped batches
        data = np.arange(40 * 9, dtype=np.int32)
        batches = port_data.sharded_dataset(data, 4, 8, meshes["data2"],
                                            seed=3)
        for i in range(2):
            batch = next(batches)
            out["rows%d" % i] = batch["tokens"].to_local().numpy()
            out["rows%d_shape" % i] = np.array(batch["tokens"].shape)
            out["stamp%d" % i] = np.array(
                [batch[port_data.STATE_KEY]["cursor"]])
        batches.close()
        # a corpus source resumed from the first batch's stamp
        corpus = port_data.ResumableTokenBatches(data, 4, 8, seed=3)
        batches = port_data.sharded_dataset(
            None, 4, 8, meshes["data2"], corpus=corpus,
            state=next(iter(port_data.ResumableTokenBatches(
                data, 4, 8, seed=3)))[port_data.STATE_KEY])
        out["corpus_rows"] = next(batches)["tokens"].to_local().numpy()
        batches.close()
        # placement helpers on the tiny Llama's weights: shard_tree's
        # leaves lie as tree_shardings says and gather back to the whole;
        # constrain re-places a whole tensor and a DTensor
        cfg = port_llama.LlamaConfig.tiny()
        whole = port_llama.init_params(cfg, torch.Generator().manual_seed(4),
                                       device="cpu")
        axes = port_llama.logical_axes(cfg)
        placed_ok = []
        for name, mesh in sorted(meshes.items()):
            placed = spmd.shard_tree(whole, axes, mesh)
            shardings = spmd.tree_shardings(axes, mesh)
            for path, leaf in port_ts.leaves(placed):
                want = port_ts.leaves(whole)
                sharding = shardings
                for key in path:
                    sharding = sharding[key]
                placed_ok.append(
                    port_shd.spec_of(leaf, mesh) == sharding.spec and
                    torch.equal(leaf.full_tensor(), dict(want)[path]))
            moved = spmd.constrain(placed["lm_head"], ("vocab", "embed"),
                                   mesh)
            fresh = spmd.constrain(whole["lm_head"], ("vocab", "embed"),
                                   mesh)
            placed_ok.append(torch.equal(moved.to_local(), fresh.to_local())
                             and torch.equal(moved.full_tensor(),
                                             whole["lm_head"]))
        out["placed_ok"] = np.array(placed_ok)
        info = spmd.process_info()
        out["process_info"] = np.array(
            [info["process_index"], info["process_count"],
             info["global_devices"], spmd.initialize_from_current(),
             spmd.initialize_from_env()])
        # the refusals
        errors = []
        for spec in (spmd.MeshSpec.fsdp_tp(2), spmd.MeshSpec.moe(2),
                     spmd.MeshSpec.long_context(2),
                     spmd.MeshSpec.pipelined(2)):
            try:
                spmd.create_mesh(spec, device="cpu")
                errors.append("no error")
            except NotImplementedError as ex:
                errors.append(str(ex))
        out["refusals"] = np.array(errors)
        np.savez(os.path.join(tmp, "rank%d.npz" % rank), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    from metaflow_tpu.models import llama
    from metaflow_tpu.spmd import MeshSpec, create_mesh
    from metaflow_tpu.spmd import sharding
    from metaflow_tpu.training import train_step

    return types.SimpleNamespace(jax=jax, llama=llama, MeshSpec=MeshSpec,
                                 create_mesh=create_mesh, shd=sharding,
                                 ts=train_step)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """The workers' results (their mesh runs, and the port's trainer off
    the mesh) and the JAX references, which run here while the two
    workers train."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh")
    # the weights every trainer here starts from, f32 from a seed
    params = _flat(port_llama.init_params(
        port_llama.LlamaConfig.tiny(), torch.Generator().manual_seed(0),
        device="cpu"))
    np.savez(tmp / "params.npz", **params)
    tokens = _tokens()
    ctx = mp.spawn(_worker, args=(str(tmp),), nprocs=WORLD, join=False)
    try:
        # three at a time: XLA compiles outside the interpreter lock
        with ThreadPoolExecutor(3) as pool:
            jax_runs = dict(zip(map(_id, JAX_CONFIGS), pool.map(
                lambda c: _jax_trajectory(ref, c, params, tokens),
                JAX_CONFIGS)))
    finally:
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise AssertionError("the gloo workers did not finish in "
                                     "%.0f s" % TIMEOUT_S)
    ranks = [dict(np.load(tmp / ("rank%d.npz" % r))) for r in range(WORLD)]
    single = {}
    for result in ranks:
        single.update({k[len("single|"):]: v for k, v in result.items()
                       if k.startswith("single|")})
    return types.SimpleNamespace(ranks=ranks, jax=jax_runs, single=single,
                                 tmp=tmp)


def _flat_np(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat_np(value, prefix + key + "/"))
        else:
            out[prefix + key] = np.asarray(value, np.float32)
    return out


def _jax_trajectory(ref, config, params, tokens):
    """Three steps of the JAX make_trainer on the same MeshSpec from the
    same weights: (losses, grad norms, weights)."""
    jax = ref.jax
    from jax.sharding import NamedSharding, PartitionSpec

    mesh_name, zero, opt, dtype = config
    cfg = ref.llama.LlamaConfig.tiny(dtype=dtype)
    mesh = ref.create_mesh(ref.MeshSpec(MESHES[mesh_name]),
                           n_devices=WORLD)
    state, step, _ = ref.ts.make_trainer(
        jax.random.PRNGKey(0), cfg, mesh, ref.llama,
        optimizer=_optimizer(ref.ts, opt), zero=zero)
    # the weights the port starts from, rounded to the model's dtype
    state["params"] = jax.tree.map(
        lambda x, value: jax.device_put(
            jax.numpy.asarray(value).astype(x.dtype), x.sharding),
        state["params"], _nest(params))

    # place the state on the shardings its step returns, so the step
    # compiles once: trailing replicated dims dropped, each optimizer slot
    # as its parameter lies on the dims it keeps (a factored second
    # moment lacks one of them), scalars replicated
    def strip(parts):
        parts = list(parts)
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    pspecs = {}
    for name, p in _leaves_with_names(state["params"]):
        spec = tuple(p.sharding.spec)
        pspecs[name] = (p.shape, spec + (None,) * (p.ndim - len(spec)))

    def slot_spec(path, shape):
        names = [str(getattr(k, "key", getattr(k, "name", ""))) for k in path]
        for pname, (pshape, pspec) in pspecs.items():
            if "/".join(names[-len(pname.split("/")):]) != pname:
                continue
            if shape == pshape:
                return strip(pspec)
            dims = port_ts.factored_dims(pshape)
            if dims and len(shape) == len(pshape) - 1:
                # v_row: the mean over the largest axis, v_col the other
                d = dims[1] if "v_row" in names else dims[0]
                return strip(pspec[:d] + pspec[d + 1:])
        return PartitionSpec()

    def place(path, x):
        if isinstance(x.sharding, NamedSharding) and zero:
            spec = strip(x.sharding.spec)
        else:
            spec = slot_spec(path, x.shape)
        return jax.device_put(x, NamedSharding(mesh, spec))

    state = jax.tree_util.tree_map_with_path(place, state)
    batch = ref.ts.shard_batch({"tokens": tokens}, mesh)
    losses, norms = [], []
    with mesh:
        for _ in range(STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, _flat_np(state["params"])


def _leaves_with_names(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves_with_names(value, prefix + key + "/")
        else:
            yield prefix + key, value


# ---------------------------------------------------------------------------
# MeshSpec and the rule tables
# ---------------------------------------------------------------------------

# (axes, n_devices): each preset's shape, the -1 axis, size-1 axes
# dropped, the empty spec, and each error
RESOLVE_CASES = [
    ({"data": -1}, 8), ({"fsdp": -1}, 4), ({"fsdp": -1, "tensor": 2}, 8),
    ({"data": -1, "tensor": 4}, 8), ({"fsdp": -1, "expert": 2,
                                      "tensor": 1}, 8),
    ({"fsdp": -1, "sequence": 2, "tensor": 2}, 8),
    ({"pipeline": 2, "fsdp": -1, "tensor": 1}, 4), ({"data": 2,
                                                     "fsdp": 2}, 4),
    ({"tensor": 1, "data": 1}, 1), ({}, 4), ({"fsdp": 1}, 3),
    ({"data": -1, "fsdp": -1}, 4), ({"fsdp": -1, "tensor": 3}, 8),
    ({"data": 2, "fsdp": 2}, 8),
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as ex:
        return ("ValueError", str(ex))


@pytest.mark.parametrize("case", range(len(RESOLVE_CASES)))
def test_meshspec_resolved_matches_jax(ref, case):
    axes, n = RESOLVE_CASES[case]
    want = _outcome(lambda: ref.MeshSpec(dict(axes)).resolved(n))
    got = _outcome(lambda: port_mesh.MeshSpec(dict(axes)).resolved(n))
    assert got == want
    if want[0] == "ok":
        assert list(got[1]) == list(want[1])  # the axis order too


PRESETS = [("dp", ()), ("fsdp", ()), ("fsdp_tp", (2,)), ("dp_tp", (4,)),
           ("moe", (2,)), ("moe", (2, 2)), ("long_context", (2,)),
           ("long_context", (2, 2)), ("pipelined", (2,)),
           ("pipelined", (2, 2))]


@pytest.mark.parametrize("preset", PRESETS,
                         ids=["%s%s" % (n, a) for n, a in PRESETS])
def test_meshspec_presets_match_jax(ref, preset):
    name, args = preset
    assert getattr(port_mesh.MeshSpec, name)(*args).axes == \
        getattr(ref.MeshSpec, name)(*args).axes


SPEC_MESHES = {"dp2": {"data": 2}, "fsdp2": {"fsdp": 2},
               "data2_fsdp2": {"data": 2, "fsdp": 2},
               "fsdp2_tensor2": {"fsdp": 2, "tensor": 2}}


@pytest.mark.parametrize("zero", [False, True], ids=["zero_off", "zero_on"])
@pytest.mark.parametrize("mesh_name", sorted(SPEC_MESHES))
def test_specs_match_jax(ref, mesh_name, zero):
    """rules_for_mesh, then tree_specs of the tiny Llama's logical_axes
    (with ZeRO: zero_tree_specs over the rule table's specs, where the
    mesh has a data axis to shard the update over), leaf by leaf."""
    axes = SPEC_MESHES[mesh_name]
    n = int(np.prod(list(axes.values())))
    jmesh = ref.create_mesh(ref.MeshSpec(axes), n_devices=n)
    pmesh = port_mesh.Mesh(port_mesh.MeshSpec(axes).resolved(n))
    assert pmesh.shape == dict(jmesh.shape)
    jrules = ref.shd.rules_for_mesh(jmesh)
    prules = port_shd.rules_for_mesh(pmesh)
    assert prules == jrules
    cfg = ref.llama.LlamaConfig.tiny()
    jspecs = ref.shd.tree_specs(ref.llama.logical_axes(cfg), jrules)
    pspecs = port_shd.tree_specs(
        port_llama.logical_axes(port_llama.LlamaConfig.tiny()), prules)
    if zero:
        assert port_shd.zero_enabled(pmesh, True) == \
            ref.shd.zero_enabled(jmesh, True)
        shapes = ref.jax.eval_shape(
            lambda: ref.llama.init_params(ref.jax.random.PRNGKey(0), cfg))
        jspecs = ref.shd.zero_tree_specs(shapes, jmesh, base_specs=jspecs)
        pspecs = port_shd.zero_tree_specs(
            _nest(dict(_leaves_with_names(shapes))), pmesh,
            base_specs=pspecs)
    want = dict(_leaves_with_names(jspecs))
    got = dict(_leaves_with_names(pspecs))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == tuple(want[name]), name


def test_zero_knob_and_spec_rule(ref, monkeypatch):
    """TPUFLOW_ZERO read as the JAX package reads it; zero_spec's
    largest-divisible-dim rule on odd shapes."""
    pmesh = port_mesh.Mesh({"data": 2})
    jmesh = ref.create_mesh(ref.MeshSpec({"data": 2}), n_devices=2)
    for value in (None, "", "1", "0", "false", "yes"):
        if value is None:
            monkeypatch.delenv("TPUFLOW_ZERO", raising=False)
        else:
            monkeypatch.setenv("TPUFLOW_ZERO", value)
        assert port_shd.zero_enabled(pmesh) == ref.shd.zero_enabled(jmesh)
    P = ref.jax.sharding.PartitionSpec
    for spec, shape in (((), (3, 5)), ((None, "fsdp"), (6, 4)), ((), ()),
                        (("data",), (4, 4)), ((None,), (8, 8, 2))):
        assert port_shd.zero_spec(spec, shape, pmesh) == tuple(
            ref.shd.zero_spec(P(*spec), shape, jmesh)), (spec, shape)


def test_unported_mesh_pieces_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port_mesh.create_hybrid_mesh(port_mesh.MeshSpec.fsdp())
    for axis in ("tensor", "expert", "sequence", "pipeline"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port_mesh.check_supported({"fsdp": 2, axis: 2})


# ---------------------------------------------------------------------------
# the workers' results
# ---------------------------------------------------------------------------

def _params_close(got, want, dtype, lrs, err, against_jax=False):
    """The weights after STEPS updates with learning rates `lrs`.

    Adam's update moves each weight by about lr(t) times g / |g|, so a
    gradient near zero, whose sign or size the order of a sum decides,
    moves the weight by up to lr(t) either way: two trajectories part by
    at most 2 sum(lr) there. In bf16 a step also rounds to the weight's
    grid, so each update with lr > 0 moves a weight by up to one ulp more.

    f32: atol/rtol 1e-5 (tests/test_torch_optim.py's), against the JAX
    trainer for all but 1 in 1000 of a leaf's weights, those within
    2 sum(lr): the JAX trainer on two devices and on one part by up to
    2.4e-5 (0.04 sum(lr)) on the tiny Llama's lm_head under AdamW.
    bf16: every weight within 2 (sum(lr) + n ulp), n the updates with
    lr > 0, and 95 % of each leaf's weights bit for bit (97 % seen
    against the JAX trainer under AdamW, 98 % under the factored
    optimizer)."""
    lr_total = float(sum(lrs))
    if dtype == "float32":
        if not against_jax:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=err)
            return
        off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        assert np.mean(off) <= 1e-3, (err, int(off.sum()))
        assert np.all(np.abs(got - want) <= 2 * lr_total), err
        return
    larger = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(larger + 1e-30)) - 7)
    moving = sum(1 for lr in lrs if lr > 0)
    assert np.all(np.abs(got - want) <= 2 * (lr_total + moving * ulp)), err
    assert np.mean(got == want) >= 0.95, err


def _unprefix(flat, prefix):
    """The entries of `flat` under `prefix`, the prefix dropped."""
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _check_trajectory(result, losses, norms, params, config,
                      against_jax=False):
    dtype = config[3]
    key = _id(config)
    for i in range(STEPS):
        np.testing.assert_allclose(
            [result[key + "|loss"][i], result[key + "|norm"][i]],
            [losses[i], norms[i]], rtol=STEP_REL[dtype],
            err_msg="%s step %d" % (key, i))
    opt = _optimizer(port_ts, config[2])
    lrs = [opt.schedule(c) for c in range(STEPS)]
    for name, want in params.items():
        _params_close(result[key + "|params/" + name], want, dtype, lrs,
                      "%s %s" % (key, name), against_jax)


@pytest.mark.parametrize("config", CONFIGS, ids=[_id(c) for c in CONFIGS])
def test_mesh_trainer_matches_off_mesh(runs, config):
    """Three steps on the 2-rank mesh against the port's trainer off the
    mesh from the same weights on the same global batch; every rank
    reports the same losses and holds the same gathered weights."""
    key = _id(config)
    want = _unprefix(runs.single, key + "|")
    losses, norms = want.pop("loss"), want.pop("norm")
    params = _unprefix(want, "params/")
    r0, r1 = runs.ranks
    np.testing.assert_array_equal(r0[key + "|loss"], r1[key + "|loss"])
    for name in params:
        np.testing.assert_array_equal(r0[key + "|params/" + name],
                                      r1[key + "|params/" + name])
    _check_trajectory(r0, losses, norms, params, config)


@pytest.mark.parametrize("config", JAX_CONFIGS,
                         ids=[_id(c) for c in JAX_CONFIGS])
def test_mesh_trainer_matches_jax(runs, config):
    """Three steps on the 2-rank mesh against the JAX make_trainer on the
    same MeshSpec (and ZeRO setting) from the same weights and batch."""
    losses, norms, params = runs.jax[_id(config)]
    _check_trajectory(runs.ranks[0], losses, norms, params, config,
                      against_jax=True)


def test_mesh_records_carry_rank_and_world(runs):
    """The train.step records of each rank carry that rank, and MFU is
    taken over the world's two devices."""
    assert list(runs.ranks[0]["record_ranks"]) == [0, 1]
    assert int(runs.ranks[0]["n_devices"]) == WORLD


def test_sharded_checkpoint_reads_whole_off_the_mesh(runs):
    """The state saved by both ranks on {fsdp: 2} is read here, off any
    mesh, as the whole tree: bit for bit the gathered state."""
    key = _id(CONFIGS[0])
    mgr = port_ckpt.AsyncCheckpointManager(
        LocalFlowDataStore("MeshFlow", str(runs.tmp / "ds")), name="mesh")
    ck = mgr.restore()
    assert ck.step == STEPS and ck.extra == {"rank": 0}
    assert ck.state["step"] == STEPS
    assert ck.state["opt_state"]["count"] == STEPS
    for part in ("params", "opt_state"):
        for name, value in _flat(ck.state[part]).items():
            np.testing.assert_array_equal(
                value, runs.ranks[0]["%s|%s/%s" % (key, part, name)],
                err_msg=name)


@pytest.mark.parametrize("target", [("fsdp2", False), ("data2", True)],
                         ids=["fsdp2", "data2-zero"])
def test_checkpoint_restores_onto_a_mesh(runs, target):
    """A state saved off the mesh, restored by make_trainer(checkpoint=)
    onto {fsdp: 2} and onto {data: 2} with ZeRO: every rank's gathered
    state is the saved one bit for bit, step and count included."""
    for result in runs.ranks:
        prefix = "restored_%s_%s|" % target
        assert list(result[prefix + "step"]) == [STEPS, STEPS]
        saved = _unprefix(runs.single, _id(CONFIGS[0]) + "|")
        for name in saved:
            if "/" in name:  # params/... and opt_state/...
                np.testing.assert_array_equal(
                    result[prefix + name], saved[name], err_msg=name)


def test_shard_iterator_rows(runs):
    """Each rank's rows of sharded_dataset's batches, joined in rank
    order, are the global batch; the resume stamp stays the host's; a
    corpus source resumes from a stamp."""
    source = iter(port_data.ResumableTokenBatches(
        np.arange(40 * 9, dtype=np.int32), 4, 8, seed=3))
    for i in range(2):
        batch = next(source)
        joined = np.concatenate([r["rows%d" % i] for r in runs.ranks])
        np.testing.assert_array_equal(joined, batch["tokens"])
        for r in runs.ranks:
            assert list(r["rows%d_shape" % i]) == [4, 9]
            assert int(r["stamp%d" % i][0]) == \
                batch[port_data.STATE_KEY]["cursor"]
    # sharded_dataset(corpus=) resumed after the first batch: the second
    np.testing.assert_array_equal(
        np.concatenate([r["corpus_rows"] for r in runs.ranks]),
        batch["tokens"])


def test_placement_helpers_on_the_mesh(runs):
    """shard_tree, tree_shardings and constrain on both meshes; the
    gang's process_info; initialize_from_current and _env leave a group
    that exists alone."""
    for rank, result in enumerate(runs.ranks):
        assert result["placed_ok"].all()
        assert list(result["process_info"]) == [rank, WORLD, WORLD, 0, 0]


def test_unported_axes_refused_on_the_mesh(runs):
    for message in runs.ranks[0]["refusals"]:
        assert "ROADMAP" in str(message), message


def test_one_rank_mesh_makes_its_group():
    """create_mesh where no process group exists makes a group of this
    one rank; a trainer on it takes the path off the mesh's numbers."""
    if dist.is_initialized():
        pytest.skip("this process already belongs to a process group")
    from metaflow_tpu_torch import spmd

    try:
        mesh = spmd.create_mesh(spmd.MeshSpec.fsdp(), device="cpu")
        assert mesh.shape == {"data": 1} and dist.get_world_size() == 1
        cfg = port_llama.LlamaConfig.tiny()
        tokens = _tokens()
        got = []
        for m in (mesh, None):
            state, step = port_ts.make_trainer(
                cfg, port_llama, optimizer=_optimizer(port_ts, "adamw"),
                generator=torch.Generator().manual_seed(2), device="cpu",
                mesh=m)
            state, metrics = step(state, {"tokens": tokens})
            got.append((metrics["loss"].item(), _flat(state["params"])))
        assert got[0][0] == got[1][0]
        for name, value in got[1][1].items():
            np.testing.assert_array_equal(got[0][1][name], value)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
