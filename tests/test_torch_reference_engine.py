"""repro_torch's ReferenceEngine against the JAX ReferenceEngine on the
CPU: the same params and requests give identical greedy (and seeded
temperature) tokens, statuses and stats counts, float and quantized, with
reject and truncate admission; the quantized engines' serving ledgers
equal the reference's; ``launch/serve.py --engine reference`` runs."""
import dataclasses

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.runtime.serve import ReferenceEngine as JReferenceEngine
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeEngine as JServeEngine
except ImportError:
    jax = None
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

COUNTS = ("prefill_tokens", "decode_tokens", "rejected", "truncated")


@pytest.fixture(scope="module")
def lm32():
    """float32 tiny dense LM and its params in both packages."""
    kw = dict(n_layers=2, vocab=64, remat=False, dtype="float32")
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(), **kw)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **kw)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(seed, lens, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _run_both(lm32, prompts, max_new=6, **kw):
    jcfg, tcfg, jp, tp = lm32
    jeng = JReferenceEngine(jcfg, jp, eos_id=-1, **kw)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng = ReferenceEngine(tcfg, tp, eos_id=-1, device="cpu", **kw)
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    teng.run(treqs)
    return jeng, jreqs, teng, treqs


def _same(jeng, jreqs, teng, treqs):
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [(r.status, r.done, r.truncated) for r in treqs] == \
        [(r.status, r.done, r.truncated) for r in jreqs]
    for a, b in zip(treqs, jreqs):
        np.testing.assert_array_equal(np.asarray(a.prompt),
                                      np.asarray(b.prompt))
    assert {k: teng.stats[k] for k in COUNTS} == \
        {k: jeng.stats[k] for k in COUNTS}
    assert set(teng.stats) == set(jeng.stats)


@pytest.mark.parametrize("admission", ["reject", "truncate"])
@pytest.mark.parametrize("quantized", [False, True])
def test_reference_engine_parity_with_jax(lm32, quantized, admission):
    """Seven prompts in batches of 3 (left-padded to each batch's longest),
    one over the context: rejected, or cut to its last 31 tokens, which
    clamps its batch to 32 + 1 - 31 = 2 new tokens."""
    prompts = _prompts(4, (3, 17, 9, 40, 22, 5, 13))
    res = _run_both(lm32, prompts, max_batch=3, max_context=32,
                    quantized=quantized, admission=admission)
    _same(*res)
    teng, treqs = res[2], res[3]
    assert teng.stats["rejected" if admission == "reject"
                      else "truncated"] == 1
    want = [6, 6, 6, 0, 6, 6, 6] if admission == "reject" \
        else [6, 6, 6, 2, 2, 2, 6]
    assert [len(r.out_tokens) for r in treqs] == want


def test_reference_engine_max_new_clamp_and_eos(lm32):
    """A prompt near the context clamps the batch's new tokens; an eos
    token that the model emits ends a request early (the JAX engine's
    rules)."""
    prompts = _prompts(5, (29, 4))
    _same(*_run_both(lm32, prompts, max_new=8, max_batch=2, max_context=32))
    jeng, jreqs, teng, treqs = _run_both(lm32, prompts, max_new=8,
                                         max_batch=2, max_context=32)
    eos = treqs[1].out_tokens[2]
    jcfg, tcfg, jp, tp = lm32
    outs = []
    for eng in (JReferenceEngine(jcfg, jp, eos_id=eos, max_batch=2,
                                 max_context=32),
                ReferenceEngine(tcfg, tp, eos_id=eos, max_batch=2,
                                max_context=32, device="cpu")):
        cls = JRequest if isinstance(eng, JReferenceEngine) else Request
        reqs = [cls(rid=i, prompt=p.copy(), max_new_tokens=8)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    assert outs[1][1][-1] == eos and len(outs[1][1]) < 8


def test_reference_engine_temperature_sampling(lm32):
    """temperature > 0: both draw with numpy's default_rng(seed).choice."""
    prompts = _prompts(6, (5, 11, 7))
    _same(*_run_both(lm32, prompts, max_batch=2, max_context=32,
                     temperature=0.8, seed=3))


def test_serving_ledgers_match_jax(lm32):
    """Both quantized engines price the served bits with serving_ledger:
    the reference's sheet, exactly."""
    jcfg, tcfg, jp, tp = lm32
    for bits in (8, 4):
        want = JReferenceEngine(jcfg, jp, quantized=True, quant_bits=bits)
        got = ReferenceEngine(tcfg, tp, quantized=True, quant_bits=bits,
                              device="cpu")
        assert got.serving_sheet.to_dict() == want.serving_sheet.to_dict()
        want = JServeEngine(jcfg, jp, quantized=True, quant_bits=bits)
        got = ServeEngine(tcfg, tp, quantized=True, quant_bits=bits,
                          device="cpu")
        assert got.serving_sheet.to_dict() == want.serving_sheet.to_dict()
    assert ReferenceEngine(tcfg, tp, device="cpu").serving_sheet is None


def test_reference_engine_streams_tokens(lm32):
    _, tcfg, _, tp = lm32
    seen = []
    eng = ReferenceEngine(tcfg, tp, eos_id=-1, max_batch=2, max_context=32,
                          device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4,
                    on_token=lambda rid, i, t: seen.append((rid, i, t)))
            for i, p in enumerate(_prompts(7, (6, 3, 8)))]
    eng.run(reqs)
    assert sorted(seen) == sorted((r.rid, i, t) for r in reqs
                                  for i, t in enumerate(r.out_tokens))


def test_reference_engine_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError):
        ReferenceEngine(cfg, {})


def test_launcher_reference_engine_on_cpu(capsys):
    launch_serve.main(["--arch", "qwen2-0.5b", "--reduced", "--engine",
                       "reference", "--quantized", "--device", "cpu",
                       "--requests", "3", "--batch", "2", "--prompt-len",
                       "6", "--max-new", "3", "--context", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "engine=reference" in out
    assert "decode: 6 tok" in out


@pytest.mark.gpu
def test_gpu_reference_engine_matches_cpu():
    """On the card the prefill attends through the flash kernel (one launch
    per layer and batch) and gives the CPU engine's greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2,
                               vocab=64, dtype="float32")
    tp = Model(tcfg, device="cpu").init(0)
    prompts = _prompts(8, (3, 17, 9, 22, 30))
    outs = []
    for dev in ("cpu", "cuda"):
        n0 = flash_attention_kernel.launches
        eng = ReferenceEngine(tcfg, tp, eos_id=-1, max_batch=2,
                              max_context=48, device=dev)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert flash_attention_kernel.launches - n0 == 3 * tcfg.n_layers
    assert outs[0] == outs[1]
