"""The PyTorch port's SlotEngine on the CPU: greedy tokens identical to the
port's generate() and to the JAX package's generate() while slots
interleave, sampled decoding identical to the port's single-request
generate(), per-row noise, the extract_kv -> seed_prefix round trip, and
no slot leaked after eos, release or completion."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from metaflow_tpu.inference import decode as ref_decode  # noqa: E402
from metaflow_tpu.models import llama as ref_llama  # noqa: E402
from metaflow_tpu_torch.inference import decode as port_decode  # noqa: E402
from metaflow_tpu_torch.models import llama as port_llama  # noqa: E402
from metaflow_tpu_torch.serving import engine as port_engine  # noqa: E402

# one intra-op thread: the tests share the CPU with the other pytest
# workers, on which torch's pool of a thread per core would spin
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = ref_llama.LlamaConfig.tiny()
    ref_params = ref_llama.init_params(jax.random.PRNGKey(0), cfg)
    params = port_llama.from_jax_params(
        jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return cfg, ref_params, params


def _engine(params, cfg, **kw):
    kw.setdefault("max_slots", 4)
    return port_engine.SlotEngine(params, cfg, max_seq_len=128,
                                  prefill_chunk=16, device="cpu", **kw)


def _serve(engine, requests, eos_id=None):
    """Admit into free slots, one prefill chunk per iteration, then one
    fused decode step; a request ends at max_new tokens or at eos_id."""
    queue = list(range(len(requests)))
    slot_of, out = {}, {i: [] for i in queue}
    while queue or slot_of:
        for slot in engine.free_slots():
            if queue:
                i = queue.pop(0)
                r = requests[i]
                engine.admit(slot, r["prompt"], r["max_new"],
                             temperature=r.get("temperature", 0.0),
                             top_k=r.get("top_k"), top_p=r.get("top_p"),
                             rng=r.get("seed", 0))
                slot_of[slot] = i
        prefilling = [s for s in slot_of if not engine.decoding[s]]
        if prefilling:
            _, first = engine.prefill_step(prefilling[0])
            if first is not None:
                out[slot_of[prefilling[0]]].append(first)
        for slot, tok in engine.decode_step().items():
            out[slot_of[slot]].append(tok)
        for slot in list(slot_of):
            toks = out[slot_of[slot]]
            if eos_id in toks:
                del toks[toks.index(eos_id) + 1:]
            if eos_id in toks or len(toks) >= requests[slot_of[slot]][
                    "max_new"]:
                del toks[requests[slot_of[slot]]["max_new"]:]
                engine.release(slot)
                del slot_of[slot]
    assert engine.free_slots() == list(range(engine.max_slots))
    return out


def _port_tokens(params, cfg, r, eos_id=None):
    out = port_decode.generate(
        params, [r["prompt"]], cfg, r["max_new"],
        temperature=r.get("temperature", 0.0), top_k=r.get("top_k"),
        top_p=r.get("top_p"), rng=r.get("seed", 0), eos_id=eos_id,
        device="cpu")
    new = out[0, len(r["prompt"]):].tolist()
    if eos_id in new:
        new = new[:new.index(eos_id) + 1]
    return new


def test_greedy_identical_to_both_generates(model):
    """Prompt lengths spanning one to several prefill chunks, more
    requests than slots, so admission and prefill interleave with decode
    steps of other slots."""
    cfg, ref_params, params = model
    rng = np.random.default_rng(0)
    reqs = [{"prompt": rng.integers(0, cfg.vocab_size, n).tolist(),
             "max_new": int(rng.integers(2, 8)), "seed": i}
            for i, n in enumerate([3, 16, 17, 40, 90, 7])]
    got = _serve(_engine(params, cfg), reqs)
    for i, r in enumerate(reqs):
        assert got[i] == _port_tokens(params, cfg, r), i
    # the JAX package's generate, batched: prompts right-padded to one
    # length and the continuation read per row at its own prompt_len
    for i in (1, 4):
        r = reqs[i]
        ref = ref_decode.generate(ref_params, jnp.asarray([r["prompt"]]),
                                  cfg, r["max_new"])
        assert got[i] == np.asarray(ref)[0, len(r["prompt"]):].tolist()


def test_sampled_identical_to_port_generate(model):
    cfg, _, params = model
    reqs = []
    for i, (tk, tp) in enumerate([(None, None), (20, None), (None, 0.9),
                                  (20, 0.9), (None, None)]):
        reqs.append({"prompt": list(range(5 + i, 25 + 3 * i)), "max_new": 6,
                     "temperature": 0.8 if i < 4 else 0.0, "top_k": tk,
                     "top_p": tp, "seed": 100 + i})
    got = _serve(_engine(params, cfg), reqs)
    for i, r in enumerate(reqs):
        assert got[i] == _port_tokens(params, cfg, r), i


def test_noise_depends_only_on_the_rows_seed():
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32))
    knobs = dict(temperature=torch.tensor([1.0, 1.0, 0.7]),
                 top_k=torch.tensor([64, 10, 64]),
                 top_p=torch.tensor([1.0, 1.0, 0.8]))
    batch = port_engine.sample_slots(logits, [11, 12, 13], **knobs)
    for b, seed in enumerate([11, 12, 13]):
        alone = port_engine.sample_slots(
            logits[b:b + 1], [seed], **{k: v[b:b + 1]
                                        for k, v in knobs.items()})
        assert int(alone[0]) == int(batch[b])
        same = port_decode._sample(
            logits[b:b + 1], float(knobs["temperature"][b]), [seed],
            top_k=int(knobs["top_k"][b]), top_p=float(knobs["top_p"][b]))
        assert int(same[0]) == int(batch[b])


def test_extract_seed_round_trip(model):
    """A prefix extracted from one slot seeds another request's prefill;
    a full prompt's KV hands off through admit_prefilled."""
    cfg, _, params = model
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 37).tolist()
    r = {"prompt": prompt, "max_new": 5}
    want = _port_tokens(params, cfg, r)

    eng = _engine(params, cfg, max_slots=2)
    eng.admit(0, prompt, 5)
    first = None
    while first is None:
        _, first = eng.prefill_step(0)
    kv_prefix = eng.extract_kv(0, 30)
    kv_full = eng.extract_kv(0, len(prompt))
    eng.release(0)

    eng.admit(1, prompt, 5)
    eng.seed_prefix(1, kv_prefix)
    toks = []
    while not toks:
        _, first = eng.prefill_step(1)
        if first is not None:
            toks.append(first)
    while len(toks) < 5:
        toks.append(eng.decode_step()[1])
    eng.release(1)
    assert toks == want

    eng.admit_prefilled(0, prompt, want[0], kv_full, 5)
    toks = [want[0]]
    while len(toks) < 5:
        toks.append(eng.decode_step()[0])
    eng.release(0)
    assert toks == want
    assert eng.free_slots() == [0, 1]


def test_eos_and_release_free_slots(model):
    cfg, _, params = model
    eng = _engine(params, cfg)
    probe = _serve(eng, [{"prompt": list(range(1, 9)), "max_new": 1}])
    eos = probe[0][0]
    got = _serve(eng, [{"prompt": list(range(1, 9)), "max_new": 10},
                       {"prompt": list(range(3, 30)), "max_new": 4}],
                 eos_id=eos)
    assert got[0] == [eos]
    assert len(got[1]) <= 4
    assert eng.free_slots() == list(range(eng.max_slots))
    assert not eng.active.any() and not eng.decoding.any()
    with pytest.raises(ValueError, match="exceeds"):
        eng.admit(0, list(range(100)), 40)
    assert eng.free_slots() == list(range(eng.max_slots))
