"""The PyTorch port stands alone: importing it pulls in neither jax nor the
JAX package, no source of it names either, and its entry points run on the
card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "metaflow_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "metaflow_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_leaves_jax_out():
    code = ("import sys, metaflow_tpu_torch, metaflow_tpu_torch.ops.attention,"
            " metaflow_tpu_torch.ops.gmm, metaflow_tpu_torch.ops.moe,"
            " metaflow_tpu_torch.ops.ring_attention,"
            " metaflow_tpu_torch.models.mixtral,"
            " metaflow_tpu_torch.training.train_step,"
            " metaflow_tpu_torch.training.metrics,"
            " metaflow_tpu_torch.flowspec, metaflow_tpu_torch.runtime,"
            " metaflow_tpu_torch.task, metaflow_tpu_torch.cli,"
            " metaflow_tpu_torch.client, metaflow_tpu_torch.plugins,"
            " metaflow_tpu_torch.inference.loading;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'metaflow_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(p, ROOT) for p in _port_sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_default_to_cuda():
    """Called without device=, every entry point asks for the card, and
    without one it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from metaflow_tpu_torch.inference import decode
    from metaflow_tpu_torch.models import llama
    from metaflow_tpu_torch.serving import SlotEngine
    from metaflow_tpu_torch import training

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = np.zeros((1, 8), np.int64)
    calls = [
        lambda: llama.init_params(cfg),
        lambda: llama.forward(params, tokens, cfg),
        lambda: llama.from_jax_params({}, cfg),
        lambda: decode.generate(params, tokens, cfg, 2),
        lambda: decode.init_kv_cache(cfg, 1, 16),
        lambda: decode.decode_forward(
            params, tokens, decode.init_kv_cache(cfg, 1, 16, device="cpu"),
            0, cfg),
        lambda: SlotEngine(params, cfg, max_seq_len=32),
        lambda: llama.loss_fn(params, {"tokens": tokens}, cfg),
        lambda: training.make_trainer(cfg, llama),
        lambda: training.make_train_state(cfg, llama),
        lambda: training.make_train_step(cfg, llama),
        lambda: training.make_eval_step(cfg, llama),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the same calls with device="cpu" run
    assert llama.forward(params, tokens, cfg, device="cpu").shape == \
        (1, 8, cfg.vocab_size)
    state, step = training.make_trainer(cfg, llama, params=params,
                                        device="cpu")
    _, metrics = step(state, {"tokens": tokens})
    assert metrics["loss"].device.type == "cpu"


def test_mixtral_entry_points_default_to_cuda():
    """Mixtral's entry points, called without device=, ask for the card and
    raise without one; with device="cpu" they run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from metaflow_tpu_torch import training
    from metaflow_tpu_torch.inference import decode
    from metaflow_tpu_torch.models import mixtral

    cfg = mixtral.MixtralConfig.tiny(moe_dispatch="gmm")
    params = mixtral.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    tokens = np.zeros((1, 8), np.int64)
    calls = [
        lambda: mixtral.init_params(cfg),
        lambda: mixtral.forward(params, tokens, cfg),
        lambda: mixtral.from_jax_params({}, cfg),
        lambda: mixtral.loss_fn(params, {"tokens": tokens}, cfg),
        lambda: decode.generate(params, tokens, cfg, 2),
        lambda: training.make_trainer(cfg, mixtral),
        lambda: training.make_eval_step(cfg, mixtral),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    logits, aux = mixtral.forward(params, tokens, cfg, return_aux=True,
                                  device="cpu")
    assert logits.shape == (1, 8, cfg.vocab_size) and aux.ndim == 0
    state, step = training.make_trainer(cfg, mixtral, params=params,
                                        device="cpu")
    _, metrics = step(state, {"tokens": tokens})
    assert metrics["loss"].device.type == "cpu"


def test_params_on_another_device_are_refused():
    from metaflow_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(ValueError, match="parameters live on"):
        llama.check_params_device(params, torch.device("meta"))
