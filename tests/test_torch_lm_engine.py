"""The port's LM slot engine (``repro_torch.serve.engine``) against the JAX
package's ``Engine`` on smoke configs in float32: greedy tokens for 5
prompts over 3 slots (as ``tests/test_data_serve.py``'s continuous-batching
test) for a dense GQA, an MLA, an MoE and the xLSTM arch; zamba2-7b (whose
unstacked tail the reference ``Engine`` writes at the wrong axis, ROADMAP
Queue 3 item 6) at 2 slots against a one-row greedy loop of the
reference's own ``prefill`` + ``decode_step``; eos; temperature sampling on
the reference's key chain; the recorded logits; and the launcher's LM
path and its refusals (whisper-tiny: requests carry no encoder frames).
The reference's params are drawn by the port (``tests/torch_lm_params.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import model as JM
from repro.serve.engine import Engine as JEngine, Request as JRequest

from repro_torch import convert
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.launch import serve as launch_serve
from repro_torch.models.params import tree_flatten
from repro_torch.serve.engine import Engine, Request, check_servable
from torch_lm_params import reference_params
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

MAX_LEN, MAX_NEW = 32, 4


def _cfgs(arch):
    return (dataclasses.replace(j_smoke(arch), dtype="float32", remat="none"),
            dataclasses.replace(t_smoke(arch), dtype="float32", remat="none"))


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.integers(3, 9))) for _ in range(5)]


def _serve(engine, request_cls, prompts, **kw):
    for uid, p in enumerate(prompts):
        engine.submit(request_cls(uid=uid, prompt=p, max_new_tokens=MAX_NEW, **kw))
    return {u: r.out_tokens for u, r in engine.run_until_done().items()}


@pytest.fixture(scope="module")
def served():
    """Per arch: the reference's params (numpy) and its Engine's tokens,
    greedy at 3 slots, and sampled at temperature 0.7 (seed 3)."""
    memo = {}

    def get(arch):
        if arch not in memo:
            jc, tc = _cfgs(arch)
            params = reference_params(tc)
            prompts = _prompts(jc.vocab_size)
            greedy = _serve(JEngine(jc, params, n_slots=3, max_len=MAX_LEN), JRequest, prompts)
            sampled = None
            if arch == "llama3.2-3b":
                sampled = _serve(JEngine(jc, params, n_slots=3, max_len=MAX_LEN,
                                         temperature=0.7, seed=3), JRequest, prompts)
            memo[arch] = (jax.tree.map(np.asarray, params), prompts, greedy, sampled)
        return memo[arch]
    return get


def _port_params(arch, params_np):
    return convert.lm_params_from_numpy(params_np, _cfgs(arch)[1], "cpu")


@pytest.mark.parametrize("arch", ["llama3.2-3b", "minicpm3-4b", "mixtral-8x22b", "xlstm-125m"])
def test_greedy_tokens_match_reference(arch, served):
    params_np, prompts, want, _ = served(arch)
    cfg = _cfgs(arch)[1]
    eng = Engine(cfg, _port_params(arch, params_np), n_slots=3, max_len=MAX_LEN, device="cpu")
    got = _serve(eng, Request, prompts)
    assert sorted(got) == list(range(5))
    assert got == want
    assert len(eng.prefill_ms) == 5 and len(eng.decode_ms) >= MAX_NEW - 1


def _reference_one_row(jc, params, prompts):
    """The reference model's greedy tokens for each prompt, one row at a
    time: its prefill into a bf16 cache (the engine's), then decode steps,
    stopping as the engine does."""
    prefill = jax.jit(lambda p, t, c: JM.prefill(p, jc, t, c))
    decode = jax.jit(lambda p, t, pos, c: JM.decode_step(p, jc, t, pos, c))
    return [_one_row(prefill, decode, jc, params, p) for p in prompts]


def _one_row(prefill, decode, jc, params, prompt):
    cache = JM.init_cache(jc, 1, MAX_LEN, jnp.bfloat16)
    logits, cache = prefill(params, jnp.asarray(prompt, jnp.int32)[None], cache)
    out = [int(jnp.argmax(logits[0]))]
    pos = len(prompt)
    while len(out) < MAX_NEW and pos < MAX_LEN - 1:
        logits, cache = decode(params, jnp.asarray([out[-1]], jnp.int32),
                               jnp.asarray([pos], jnp.int32), cache)
        out.append(int(jnp.argmax(logits[0])))
        pos += 1
    return out


def test_zamba2_two_slots_equal_reference_one_row_loop():
    """The hybrid's batched engine (its tail cache written at axis 0) gives
    every request the tokens of the reference model's one-row greedy loop."""
    jc, tc = _cfgs("zamba2-7b")
    params = reference_params(tc)
    prompts = _prompts(jc.vocab_size)
    eng = Engine(tc, convert.lm_params_from_numpy(jax.tree.map(np.asarray, params), tc, "cpu"),
                 n_slots=2, max_len=MAX_LEN, device="cpu")
    got = _serve(eng, Request, prompts)
    assert sorted(got) == list(range(5))
    assert [got[uid] for uid in range(5)] == _reference_one_row(jc, params, prompts)
    h, conv = eng.cache["tail"]["0_mamba"]
    assert h.dtype == torch.float32 and h.shape[0] == 2 and conv.dtype == torch.bfloat16


def test_engine_refuses_encoder_decoder():
    cfg = _cfgs("whisper-tiny")[1]
    with pytest.raises(ValueError, match="ROADMAP Queue 3 item 9"):
        check_servable(cfg)
    with pytest.raises(ValueError, match="encoder frames"):
        Engine(cfg, {}, n_slots=2, max_len=MAX_LEN, device="cpu")


def test_continuous_batching_equals_single_slot(served):
    params_np, prompts, want, _ = served("llama3.2-3b")
    cfg = _cfgs("llama3.2-3b")[1]
    params = _port_params("llama3.2-3b", params_np)
    for uid, p in enumerate(prompts):
        solo = Engine(cfg, params, n_slots=1, max_len=MAX_LEN, device="cpu")
        assert _serve(solo, Request, [p])[0] == want[uid], uid


def test_temperature_sampling_follows_reference(served):
    params_np, prompts, greedy, want = served("llama3.2-3b")
    cfg = _cfgs("llama3.2-3b")[1]
    eng = Engine(cfg, _port_params("llama3.2-3b", params_np), n_slots=3, max_len=MAX_LEN,
                 temperature=0.7, seed=3, device="cpu")
    got = _serve(eng, Request, prompts)
    assert got == want
    assert got != greedy     # the draws did change some tokens


def test_eos_stops_early(served):
    params_np, _, _, _ = served("llama3.2-3b")
    cfg = _cfgs("llama3.2-3b")[1]
    params = _port_params("llama3.2-3b", params_np)
    prompt = np.asarray([1, 2, 3])
    eng = Engine(cfg, params, n_slots=1, max_len=MAX_LEN, device="cpu")
    eng.submit(Request(uid=1, prompt=prompt, max_new_tokens=20))
    first = eng.run_until_done()[1].out_tokens
    eos = first[1] if len(first) > 1 else first[0]
    eng2 = Engine(cfg, params, n_slots=1, max_len=MAX_LEN, device="cpu")
    eng2.submit(Request(uid=2, prompt=prompt, max_new_tokens=20, eos_id=int(eos)))
    out = eng2.run_until_done()[2].out_tokens
    assert out == first[:first.index(eos) + 1]
    # max_len - 1 stops a slot too: 3 prompt tokens, positions up to 7
    eng3 = Engine(cfg, params, n_slots=1, max_len=8, device="cpu")
    eng3.submit(Request(uid=3, prompt=prompt, max_new_tokens=20))
    assert len(eng3.run_until_done()[3].out_tokens) == 8 - 1 - len(prompt) + 1


def test_record_keeps_logits_and_increments(served):
    params_np, prompts, want, _ = served("llama3.2-3b")
    cfg = _cfgs("llama3.2-3b")[1]
    eng = Engine(cfg, _port_params("llama3.2-3b", params_np), n_slots=3, max_len=MAX_LEN,
                 device="cpu", record=True)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p, max_new_tokens=MAX_NEW))
    done = eng.run_until_done()
    for uid, req in done.items():
        assert req.out_tokens == want[uid]
        assert len(req.logits) == len(req.increments) == len(req.out_tokens)
        assert [int(torch.argmax(lg)) for lg in req.logits] == req.out_tokens
        assert all(i.shape == (cfg.d_model,) and i.dtype == torch.float32
                   for i in req.increments)


def test_launcher_serves_an_lm_on_the_cpu(capsys):
    rep = launch_serve.main(["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
                             "--requests", "5", "--slots", "2", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "served 5 requests / 30 tokens" in out and "[lm-stats]" in out
    assert sorted(rep.done) == list(range(5)) and rep.tokens == 30
    prompts = [r.prompt for r in launch_serve.lm_requests(rep.cfg, 5, 6)]
    assert [len(p) for p in prompts] == [len(rep.done[u].prompt) for u in range(5)]
    assert all(4 <= len(p) < 16 for p in prompts)


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-7b"])
def test_launcher_serves_recurrent_archs(arch, capsys):
    """The SSM and hybrid archs serve through the launcher; the parameter
    count it prints is the spec tree's (the floats drawn)."""
    rep = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--requests", "3", "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out
    n = sum(t.numel() for _, t in tree_flatten(rep.params))
    assert f"({n:,} parameters)" in out


@pytest.mark.parametrize("argv,reason", [
    (["--arch", "whisper-tiny"], "ROADMAP Queue 3 item 9"),
    (["--arch", "llama3.2-3b", "--mesh", "2x2"], "the reference serves an LM unsharded")])
def test_launcher_refuses(argv, reason, capsys):
    with pytest.raises(SystemExit) as e:
        launch_serve.main(argv + ["--smoke", "--device", "cpu"])
    assert e.value.code == 2
    assert reason in capsys.readouterr().err
