"""The port's serving engine (``repro_torch.serve.engine``) against the
reference's ``ServeEngine`` on the same weights in float32: token for
token, on the dense GQA model of ``test_continuous_batching_matches_
sequential`` and on the OLMoE SMOKE config (whose idle slots compete for
expert capacity); and against per-request greedy generation."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import olmoe_1b_7b as ref_olmoe
from repro.models import transformer as jt
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServeEngine as RefEngine
from repro_torch.configs import olmoe_1b_7b as port_olmoe
from repro_torch.models import transformer as pt
from repro_torch.serve.engine import Request, ServeEngine

_TINY = dict(name="tiny", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_ff=64, vocab_size=61, block_q=8, block_kv=8)


def _pair(kind):
    if kind == "tiny":
        jc = jt.TransformerConfig(**_TINY, dtype=jnp.float32)
        pc = pt.TransformerConfig(**_TINY, dtype=torch.float32)
    else:
        jc = dataclasses.replace(ref_olmoe.SMOKE, dtype=jnp.float32)
        pc = dataclasses.replace(port_olmoe.SMOKE, dtype=torch.float32)
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    model = pt.params_from_reference(pc, jax.tree.map(np.asarray, params),
                                     device="cpu")
    return jc, params, pc, model


def _prompts(vocab, n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("kind,n_req,n_slots,max_tokens", [
    ("tiny", 5, 2, 4), ("olmoe_smoke", 6, 3, 5)])
def test_engine_matches_reference_engine(kind, n_req, n_slots, max_tokens):
    jc, params, pc, model = _pair(kind)
    prompts = _prompts(pc.vocab_size, n_req, 3, 9)
    ref = RefEngine(jc, params, n_slots=n_slots, max_len=32, eos_id=-1)
    port = ServeEngine(pc, model, n_slots=n_slots, max_len=32, eos_id=-1,
                       device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(rid=i, prompt=p, max_tokens=max_tokens))
        port.submit(Request(rid=i, prompt=p, max_tokens=max_tokens))
    want, got = ref.run(), port.run()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done and len(r.out_tokens) == max_tokens for r in got)
    assert port.ticks == ref.ticks


def test_engine_matches_per_request_greedy():
    """The port's twin of the reference's continuous-batching test."""
    _, _, cfg, model = _pair("tiny")

    def naive(prompt, n):
        toks, out = list(prompt), []
        for _ in range(n):
            logits, _, _ = pt.forward(model, torch.tensor([toks]), cfg)
            out.append(int(torch.argmax(logits[0, -1])))
            toks.append(out[-1])
        return out

    reqs = [Request(rid=i, prompt=p, max_tokens=4)
            for i, p in enumerate(_prompts(61, 5, 3, 8))]
    eng = ServeEngine(cfg, model, n_slots=2, max_len=32, eos_id=-1,
                      device="cpu")
    for r in reqs:
        eng.submit(r)
    done = {r.rid: r for r in eng.run()}
    for r in reqs:
        assert done[r.rid].out_tokens == naive(r.prompt.tolist(), 4), r.rid


def test_engine_stops_on_eos_and_full_slot():
    _, _, cfg, model = _pair("tiny")
    prompt = _prompts(61, 1, 5, 6)[0]
    probe = ServeEngine(cfg, model, n_slots=1, max_len=32, eos_id=-1,
                        device="cpu")
    probe.submit(Request(rid=0, prompt=prompt, max_tokens=6))
    toks = probe.run()[0].out_tokens
    eng = ServeEngine(cfg, model, n_slots=1, max_len=32, eos_id=toks[2],
                      device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_tokens=6))
    # the prefill's token is never checked against EOS (as the reference)
    first = next(i for i in range(1, 6) if toks[i] == toks[2])
    assert eng.run()[0].out_tokens == toks[:first + 1]
    # a slot of max_len 8 holding a 5-token prompt ends at position 7
    eng = ServeEngine(cfg, model, n_slots=1, max_len=8, eos_id=-1,
                      device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, max_tokens=100))
    assert len(eng.run()[0].out_tokens) == 3


def test_slot_past_the_cache_end_drops_its_write_as_the_reference():
    """A 15-token prompt fills its 16-row slot after one tick, and the
    next ticks decode that idle slot at position 16: the reference drops
    the out-of-range cache write (``.at[].set``), so must the port."""
    jc, params, pc, model = _pair("tiny")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in (15, 3)]
    ref = RefEngine(jc, params, n_slots=2, max_len=16, eos_id=-1)
    port = ServeEngine(pc, model, n_slots=2, max_len=16, eos_id=-1,
                       device="cpu")
    for i, p in enumerate(prompts):
        ref.submit(RefRequest(rid=i, prompt=p, max_tokens=4))
        port.submit(Request(rid=i, prompt=p, max_tokens=4))
    want, got = ref.run(), port.run()
    assert ref.ticks == port.ticks == 3
    done = {r.rid: r.out_tokens for r in got}
    assert [len(done[0]), len(done[1])] == [2, 4]
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


def test_engine_accepts_the_greedy_keyword_as_the_reference():
    """``greedy=True`` is accepted and changes nothing, in both engines."""
    jc, params, pc, model = _pair("tiny")
    prompt = _prompts(61, 1, 4, 5, seed=3)[0]
    outs = []
    for eng in (RefEngine(jc, params, n_slots=1, max_len=16, eos_id=-1,
                          greedy=True),
                ServeEngine(pc, model, n_slots=1, max_len=16, eos_id=-1,
                            greedy=True, device="cpu"),
                ServeEngine(pc, model, n_slots=1, max_len=16, eos_id=-1,
                            device="cpu")):
        req_type = RefRequest if isinstance(eng, RefEngine) else Request
        eng.submit(req_type(rid=0, prompt=prompt, max_tokens=3))
        outs.append(eng.run()[0].out_tokens)
    assert outs[0] == outs[1] == outs[2] and len(outs[0]) == 3


def test_engine_device_rules():
    _, _, cfg, model = _pair("tiny")
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(cfg, model, device="meta")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, model)
