"""The port's @checkpoint and serving from a flow run, on the CPU.

@checkpoint keeps the JAX package's semantics (tests/flows/
checkpoint_flow.py) with torch tensors: a task that crashes at step 2 on
its first attempt resumes from step 3 on the retry (w_sum 24, not
restarted), and `resume` of a failed run reads the origin run's
checkpoints. A tiny float32 Llama trained in a flow step and checkpointed
comes back from load_run_checkpoint bit for bit (also through a resumed
run's lineage), and serve("FLOW", ...) and `python -m metaflow_tpu_torch
serve FLOW` answer a greedy request with the tokens of the port's
generate() on the restored weights (token for token: float32 on the CPU
is deterministic).
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest
import torch

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HTTP_TIMEOUT_S = 120.0

CHECKPOINT = '''
import os

import torch

from metaflow_tpu_torch import FlowSpec, checkpoint, current, retry, step


class CheckpointFlow(FlowSpec):
    @step
    def start(self):
        self.total_steps = 6
        self.next(self.train)

    @retry(times=int(os.environ["RETRIES"]), minutes_between_retries=0)
    @checkpoint
    @step
    def train(self):
        ckpt = current.checkpoint
        live = {"w": torch.zeros(4), "step": 0}
        restored = ckpt.load(like=live)
        if restored is not None:
            assert restored["w"] is live["w"]  # copied into the live tensor
            start_step = int(restored["step"]) + 1
        else:
            start_step = 0
        w = live["w"]
        self.resumed_from = start_step
        self.attempt = current.retry_count
        for i in range(start_step, self.total_steps):
            w = w + 1.0
            ckpt.save({"w": w, "step": i}, step=i)
            # crash mid-training on the first attempt
            if i == 2 and current.retry_count == 0:
                raise RuntimeError("simulated preemption at step %d" % i)
        self.steps_saved = ckpt.list()
        self.w_sum = float(w.sum())
        self.next(self.end)

    @step
    def end(self):
        # 6 increments of a 4-vector: 24, NOT restarted from zero
        assert self.w_sum == 24.0, self.w_sum


if __name__ == "__main__":
    CheckpointFlow()
'''

TINY = '''
import dataclasses

import torch

from metaflow_tpu_torch import FlowSpec, checkpoint, current, step


class TinyFlow(FlowSpec):
    @step
    def start(self):
        self.next(self.train)

    @checkpoint
    @step
    def train(self):
        from metaflow_tpu_torch import training
        from metaflow_tpu_torch.models import llama

        cfg = llama.LlamaConfig.tiny(dtype="float32")
        params = llama.init_params(cfg, torch.Generator().manual_seed(5),
                                   device="cpu")
        state, train_step = training.make_trainer(cfg, llama, params=params,
                                                  device="cpu")
        gen = torch.Generator().manual_seed(6)
        self.losses = []
        for _ in range(2):
            tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
            state, metrics = train_step(state, {"tokens": tokens})
            self.losses.append(float(metrics["loss"]))
        current.checkpoint.save({"params": state["params"],
                                 "config": dataclasses.asdict(cfg),
                                 "step": 1}, step=1)
        self.params = state["params"]  # a pytree-of-tensors artifact
        self.next(self.end)

    @step
    def end(self):
        pass


if __name__ == "__main__":
    TinyFlow()
'''


def _write(tmp_path, name, src):
    path = tmp_path / ("%s.py" % name)
    path.write_text(textwrap.dedent(src))
    return str(path)


def _client():
    from metaflow_tpu_torch import client

    client.namespace(None)
    return client


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype and torch.equal(got[path], t), path


def test_checkpoint_retry(run_flow, tmp_path):
    """Crash at step 2 on attempt 0; the retry resumes from step 3 in the
    same checkpoint scope (w_sum 24)."""
    path = _write(tmp_path, "ckpt_flow", CHECKPOINT)
    run_flow(path, "run", env_extra={"RETRIES": "2"})
    train = _client().Flow("CheckpointFlow").latest_run["train"].task.data
    assert (train.resumed_from, train.attempt, train.w_sum) == (3, 1, 24.0)
    assert train.steps_saved == [0, 1, 2, 3, 4, 5]


def test_checkpoint_resume(run_flow, tmp_path):
    """A run without retries fails at step 2; `resume` re-executes the
    step under a fresh task id, which reads the origin run's
    checkpoints and continues from step 3."""
    path = _write(tmp_path, "ckpt_flow", CHECKPOINT)
    run_flow(path, "run", expect_fail=True, env_extra={"RETRIES": "0"})
    c = _client()
    origin = c.Flow("CheckpointFlow").latest_run
    assert not origin.successful
    run_flow(path, "resume", env_extra={"RETRIES": "0"})
    run = c.Flow("CheckpointFlow").latest_run
    assert run.id != origin.id and run.successful
    train = run["train"].task.data
    assert (train.resumed_from, train.attempt, train.w_sum) == (3, 0, 24.0)
    # this run saved steps 3-5 itself; steps 0-2 stay the origin's
    assert train.steps_saved == [3, 4, 5]


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body).encode())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_serve_from_run(run_flow, tmp_path, tpuflow_root):
    """load_run_checkpoint gives the trained parameters bit for bit (the
    run's own and through a resumed run's lineage); serve("TinyFlow") and
    the command line answer greedy requests with generate()'s tokens."""
    from metaflow_tpu_torch.cmd.serve import serve
    from metaflow_tpu_torch.inference import decode, load_run_checkpoint
    from metaflow_tpu_torch.models import llama

    path = _write(tmp_path, "tiny_flow", TINY)
    run_flow(path, "run")
    c = _client()
    trained = c.Flow("TinyFlow").latest_run
    data = trained["train"].task.data
    assert len(data.losses) == 2 and all(
        l == l and l < 10 for l in data.losses)
    restored = load_run_checkpoint("TinyFlow")
    assert restored["step"] == 1
    _assert_bit_equal(restored["params"], data.params)
    cfg = llama.LlamaConfig(**restored["config"])
    assert cfg == llama.LlamaConfig.tiny(dtype="float32")

    # a resumed run clones the checkpointing step and writes no
    # checkpoint: the loader follows its origin-run lineage
    run_flow(path, "resume", "end")
    resumed = c.Flow("TinyFlow").latest_run
    assert resumed.id != trained.id and resumed.successful
    for run_id in (None, resumed.id):
        _assert_bit_equal(
            load_run_checkpoint("TinyFlow", run_id=run_id)["params"],
            data.params)

    prompt = list(range(3, 20))
    want = decode.generate(restored["params"], [prompt], cfg, 6,
                           device="cpu")[0, len(prompt):].tolist()
    echoed = []
    srv = serve("TinyFlow", device="cpu", port=0, block=False, slots=2,
                max_seq_len=64, prefill_chunk=16, echo=echoed.append)
    try:
        assert "TinyFlow/%s" % resumed.id in echoed[0]
        code, body = _post(srv.port, {"tokens": prompt, "max_new_tokens": 6})
        assert code == 200 and body["new_tokens"] == want
    finally:
        assert srv.shutdown(timeout=HTTP_TIMEOUT_S)

    # the command line: serve, answer, drain on SIGTERM and exit 0
    env = dict(os.environ, TPUFLOW_DATASTORE_SYSROOT_LOCAL=tpuflow_root,
               PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "metaflow_tpu_torch", "serve",
         "TinyFlow/%s" % trained.id, "--device", "cpu", "--port", "0",
         "--paged", "--spec-k", "2", "--slots", "2", "--max-seq-len", "64",
         "--prefill-chunk", "16"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "serving TinyFlow/%s on http://127.0.0.1:" % trained.id \
            in line, line + proc.stderr.read()
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        code, body = _post(port, {"tokens": prompt, "max_new_tokens": 6})
        assert code == 200 and body["new_tokens"] == want
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=HTTP_TIMEOUT_S) == 0
        assert "drained" in proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=HTTP_TIMEOUT_S)


def test_serve_fleet_options_raise():
    """The fleet and federation options wait for the fleet tier."""
    from metaflow_tpu_torch.cmd.serve import serve_run

    for kw in ({"replicas": 2}, {"prefill_workers": 1},
               {"reload_checkpoint": True}, {"federate": "http://a"}):
        with pytest.raises(NotImplementedError):
            serve_run("NoSuchFlow", device="cpu", **kw)
