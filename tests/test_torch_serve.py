"""repro_torch's ServeEngine against the JAX ServeEngine on the CPU: the
same params and requests give identical greedy token streams and event
logs, float and quantized, over the contiguous, dense-gather, reference
and fused routes; the kvcache host code decides identically; sampling at
temperature > 0 does not depend on the batch."""
import dataclasses

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.runtime import kvcache as jkv
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeEngine as JServeEngine
except ImportError:
    jax = None
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.paged_gather import paged_gather_pair_kernel
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.runtime import kvcache as tkv
from repro_torch.runtime.serve import Request, ServeEngine, summarize


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


def _serve_both(lm32, prompts, max_new=6, jax_kw=None, **kw):
    jcfg, tcfg, jp, tp = lm32
    jeng = JServeEngine(jcfg, jp, eos_id=-1, **(jax_kw or kw))
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng = ServeEngine(tcfg, tp, eos_id=-1, device="cpu", **kw)
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    teng.run(treqs)
    return jeng, jreqs, teng, treqs


_ROUTES = {
    "contiguous": {},
    "paged-take-dense": dict(kv_block_size=8),
    "paged-cuda-dense": dict(kv_block_size=8, kv_gather="cuda"),
    "paged-take-reference": dict(kv_block_size=8, decode_kernel="reference"),
    "paged-cuda-fused": dict(kv_block_size=8, kv_gather="cuda",
                             decode_kernel="fused"),
}


def _jax_kw(kw):
    """The reference's name for the gather kernel route is "pallas"."""
    return {k: ("pallas" if v == "cuda" else v) for k, v in kw.items()}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_engine_parity_with_jax(lm32, route, quantized):
    """Mixed prompt lengths, a chunk size that divides none of them, batched
    prefill (2 rows), several KV blocks per slot, slot churn, and one
    prompt over the context (rejected): identical greedy tokens, event
    logs, statuses and token counters."""
    prompts = _prompts(30, (3, 17, 9, 40, 22, 5, 13))
    kw = dict(max_batch=3, max_context=32, prefill_chunk=5, prefill_batch=2,
              quantized=quantized, **_ROUTES[route])
    jeng, jreqs, teng, treqs = _serve_both(lm32, prompts, max_new=8,
                                           jax_kw=_jax_kw(kw), **kw)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert teng.events == jeng.events
    for key in ("prefill_tokens", "decode_tokens", "prefill_chunks",
                "prefill_dispatches", "decode_steps", "rejected",
                "kv_bytes_read"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.quant_bytes == jeng.quant_bytes
    if teng.kv_block_size:
        assert teng.cache.n_free_blocks == teng.cache.n_blocks


def test_engine_parity_truncate_deadline_eos(lm32):
    """Admission truncation, a queue deadline on an injected clock and an
    EOS stop give the same decisions and tokens as the reference."""
    jcfg, tcfg, jp, tp = lm32
    prompts = _prompts(31, (40, 6, 9, 4))
    outs = []
    for Eng, Req, params, cfg, dev in (
            (JServeEngine, JRequest, jp, jcfg, {}),
            (ServeEngine, Request, tp, tcfg, {"device": "cpu"})):
        t = [0.0]
        eng = Eng(cfg, params, max_batch=1, max_context=16, eos_id=5,
                  prefill_chunk=4, kv_block_size=8, admission="truncate",
                  clock=lambda: t[0], **dev)
        reqs = [Req(rid=i, prompt=p.copy(), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        reqs[2].deadline_s = 2.0
        for r in reqs:
            eng.submit(r)
        while eng.queue or eng.slots:
            t[0] += 1.0
            eng.step()
        outs.append(([r.out_tokens for r in reqs], [r.status for r in reqs],
                     eng.events, [r.stats["queue_s"] for r in reqs]))
    assert outs[0] == outs[1]
    assert "expired" in outs[1][1]


def _trace(rng, n):
    arrivals = sorted((int(rng.integers(0, 12)), rid) for rid in range(n))
    finishes = {rid: t + int(rng.integers(1, 9)) for t, rid in arrivals
                if rng.random() < 0.85}
    deadlines = {rid: t + int(rng.integers(0, 6)) for t, rid in arrivals
                 if rng.random() < 0.4}
    return arrivals, finishes, deadlines


@pytest.mark.parametrize("seed", range(4))
def test_kvcache_host_code_matches_reference(seed):
    """admit / assign_slots / expire / block grants and the simulate oracle
    (slot-only and scarce-block modes) decide identically on seeded traces."""
    rng = np.random.default_rng(seed)
    for _ in range(20):
        n, ctx = int(rng.integers(0, 80)), int(rng.integers(2, 64))
        for pol in ("reject", "truncate"):
            assert tkv.admit(n, ctx, pol) == jkv.admit(n, ctx, pol)
    free = list(rng.permutation(10)[:6])
    assert tkv.assign_slots([7, 3, 9], free) == jkv.assign_slots([7, 3, 9],
                                                                 free)
    meta = [(i, 0.0, None if i % 3 else float(i)) for i in range(8)]
    assert tkv.expire(meta, 4.0) == jkv.expire(meta, 4.0)
    assert tkv.alloc_blocks(free, 3) == jkv.alloc_blocks(free, 3)
    arrivals, finishes, deadlines = _trace(rng, 12)
    kw = dict(deadlines=deadlines)
    assert tkv.simulate(arrivals, finishes, 3, **kw) == \
        jkv.simulate(arrivals, finishes, 3, **kw)
    blocks_of = {rid: int(rng.integers(1, 5)) for _, rid in arrivals}
    kw.update(n_blocks=8, blocks_of=blocks_of)
    assert tkv.simulate(arrivals, finishes, 3, **kw) == \
        jkv.simulate(arrivals, finishes, 3, **kw)
    with pytest.raises(RuntimeError):
        tkv.alloc_blocks([1, 2], 3)


def test_sampling_independent_of_batch(lm32):
    """temperature > 0: each request's stream depends only on (seed, rid,
    token index): rerun-stable, the same alone or in any batch mix, and
    another seed gives another stream."""
    _, tcfg, _, tp = lm32
    prompts = _prompts(11, (6, 6, 6, 6))

    def toks(idxs, seed=7, **kw):
        eng = ServeEngine(tcfg, tp, eos_id=-1, temperature=0.8, seed=seed,
                          max_context=32, device="cpu", **kw)
        reqs = [Request(rid=i, prompt=prompts[i].copy(), max_new_tokens=5)
                for i in idxs]
        eng.run(reqs)
        return {r.rid: r.out_tokens for r in reqs}

    full = toks(range(4), max_batch=4)
    assert toks(range(4), max_batch=4) == full
    solo = {}
    for i in range(4):
        solo.update(toks([i], max_batch=1))
    assert solo == full
    pairs = toks([2, 0], max_batch=2, kv_block_size=8, decode_kernel="fused")
    assert pairs[0] == full[0] and pairs[2] == full[2]
    assert toks(range(4), max_batch=4, seed=8) != full


def test_engine_stats_and_summary(lm32):
    _, tcfg, _, tp = lm32
    eng = ServeEngine(tcfg, tp, eos_id=-1, max_batch=2, max_context=32,
                      device="cpu", kv_block_size=8, decode_kernel="fused")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
            for i, p in enumerate(_prompts(10, (5, 5, 5)))]
    eng.run(reqs)
    for r in reqs:
        assert r.stats["decode_tokens"] == len(r.out_tokens) - 1 == 3
        assert r.stats["first_token_s"] <= r.stats["total_s"]
    s = summarize(reqs, eng)
    assert s["done"] == 3 and s["decode_tok_s"] > 0
    assert eng.serving_sheet is None


def test_engine_guards(lm32):
    _, tcfg, _, tp = lm32
    with pytest.raises(ValueError, match="kv_block_size"):
        ServeEngine(tcfg, tp, device="cpu", decode_kernel="fused")
    with pytest.raises(ValueError, match="kv_gather"):
        ServeEngine(tcfg, tp, device="cpu", kv_gather="pallas")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(tcfg, tp)                   # the default is the card


@pytest.mark.gpu
def test_gpu_engine_matches_cpu_and_launches_kernels():
    """On the card (f32, tiny model): the fused/cuda routes launch both
    kernels (the gather as K+V pairs) and emit the CPU engine's greedy
    tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2,
                               vocab=64, dtype="float32")
    tp = Model(tcfg, device="cpu").init(0)
    prompts = _prompts(12, (3, 17, 9, 22))
    outs = []
    for dev in ("cpu", "cuda"):
        g0 = paged_gather_pair_kernel.launches
        a0 = paged_attention_kernel.launches
        eng = ServeEngine(tcfg, tp, eos_id=-1, max_batch=3, max_context=32,
                          prefill_chunk=5, prefill_batch=2, kv_block_size=8,
                          kv_gather="cuda", decode_kernel="fused", device=dev)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
        launched = (paged_gather_pair_kernel.launches > g0,
                    paged_attention_kernel.launches > a0)
        assert launched == ((True, True) if dev == "cuda" else (False, False))
    assert outs[0] == outs[1]
