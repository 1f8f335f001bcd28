"""repro_torch's MoE family (qwen2-moe: 60 routed top-4 + shared experts;
arctic: 128 routed top-2 + a dense residual) against the JAX package on
the CPU, on the reduced configs in f32 with the reference's own init
carried across by ``params_from_jax``:

- ``moe_apply``: y within 1e-5 relative, aux within 1e-6, expert ids and
  keep mask equal to the reference's routing, at S in {1, 6, 32} and
  capacity factors 1.25, 0.1 (pairs dropped) and 64;
- a forced tie (router columns duplicated): the same experts as
  ``lax.top_k``, which puts the lower index first among equals;
- ``Model.loss`` (xent and aux), ``prefill`` (logits and cache),
  ``prefill_chunks`` (contiguous and block-paged) and ``prefill_chunk``
  within 1e-5; token-by-token ``decode_step`` against ``prefill`` within
  2e-4, the bound of the reference's own prefill/decode test;
- ``ServeEngine`` on every route, float and int8-PoT, and
  ``ReferenceEngine``: greedy tokens, event logs and counters identical
  to the JAX engines';
- the quantized tree's paths, mantissas, exponents, ``quant_bytes`` and
  ``serving_ledger``; ``params_count`` / ``active_params_count`` of every
  reference config; the launcher on a reduced MoE.

All float differences are f32 sums in another order.  On the card
(``gpu`` marker) a tiny MoE model serves through both paged kernels and
``ReferenceEngine`` through the flash kernel, with the CPU's tokens and
exact launch counts."""
import dataclasses

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.nn import Model as JModel
    from repro.nn import blocks as jblocks
    from repro.nn import get_config as jget_config
    from repro.nn import list_configs as jlist_configs
    from repro.quant import ptq as jptq
    from repro.runtime.serve import ReferenceEngine as JReferenceEngine
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeEngine as JServeEngine
except ImportError:
    jax = None
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.paged_attention import paged_attention_kernel
from repro_torch.kernels.paged_gather import (paged_gather_kernel,
                                              paged_gather_pair_kernel)
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import Model, blocks, get_config, params_from_jax
from repro_torch.nn.types import ArchConfig
from repro_torch.quant import ptq
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
TOL = 1e-5          # one forward, f32 sums in another order
AUX_TOL = 1e-6
DECODE_TOL = 2e-4   # tests/test_models.py::test_prefill_decode_consistency
COUNTS = ("prefill_tokens", "decode_tokens", "rejected", "truncated")


def _cfgs(arch, **kw):
    kw = dict(dict(dtype="float32"), **kw)
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _ref_route(p, x, cfg):
    """The reference's routing steps (``repro/nn/blocks.py:253-270``):
    (probs, expert ids, keep mask (B, S*K))."""
    B, S, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = min(max(4, int(np.ceil(cfg.capacity_factor * S * K / E))), S)
    logits = (x @ p["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    flat = idx.reshape(B, S * K)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) * onehot,
                              flat[..., None], axis=-1)[..., 0] - 1
    return np.array(probs), np.array(idx), np.array(pos < C)


def _moe_params(jcfg, seed=0):
    jp = jblocks.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.mark.parametrize("cf", [1.25, 0.1, 64.0])
@pytest.mark.parametrize("S", [1, 6, 32])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, S, cf):
    jcfg, tcfg = _cfgs(arch, capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    x = np.random.default_rng(S).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    jy, jaux = jblocks.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, taux = blocks.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    assert _rel(ty.numpy(), jy) <= TOL
    assert abs(float(taux) - float(jaux)) <= AUX_TOL
    probs, idx, keep = _ref_route(jp, jnp.asarray(x), jcfg)
    C = blocks.moe_capacity(tcfg, S)
    _, t_idx, t_keep, t_slot = blocks.moe_route(torch.from_numpy(probs),
                                                tcfg.top_k, C)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    E = tcfg.n_experts
    assert (t_slot.numpy()[~keep] == E * C).all()
    if cf == 0.1 and S == 32:
        assert not keep.all()            # the case drops pairs


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_tie_routes_like_lax_top_k(arch):
    """Router columns copied in groups of three, so probabilities tie
    across the top-k boundary (K = 4 takes a whole group and one of the
    next; K = 2 two of a group of three): the port picks lax.top_k's
    experts and its y follows."""
    jcfg, tcfg = _cfgs(arch)
    jp, _ = _moe_params(jcfg)
    E, K = jcfg.n_experts, jcfg.top_k
    router = np.asarray(jp["router"])[:, [3 * (e // 3) for e in range(E)]]
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(7).standard_normal(
        (2, 6, jcfg.d_model)).astype(np.float32)
    probs, idx, keep = _ref_route(jp, jnp.asarray(x), jcfg)
    srt = -np.sort(-probs, axis=-1)
    assert (srt[..., K - 1] == srt[..., K]).any()      # ties straddle K
    C = blocks.moe_capacity(tcfg, 6)
    _, t_idx, t_keep, _ = blocks.moe_route(torch.from_numpy(probs), K, C)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    jy, _ = jblocks.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, _ = blocks.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert _rel(ty.numpy(), jy) <= TOL


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    jcfg, tcfg = _cfgs(request.param)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jm, jp, Model(tcfg, device="cpu"), tp


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape) \
        .astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    else:
        out[prefix] = tree
    return out


def test_init_layout_and_params_from_jax(moe):
    """The port's init has the reference's paths and shapes (``moe`` in
    place of ``mlp``, nested ``shared`` / ``dense``), and
    ``params_from_jax`` carries the reference's tree across unchanged."""
    jcfg, tcfg, jm, jp, tm, tp = moe
    jflat = _flat(jax.tree.map(np.asarray, jp))
    mine = {k: tuple(v.shape) for k, v in _flat(tm.init(0)).items()}
    assert mine == {k: v.shape for k, v in jflat.items()}
    assert ("/layers/moe/shared/wu" in mine) == bool(tcfg.n_shared_experts)
    assert ("/layers/moe/dense/wd" in mine) == tcfg.moe_dense_residual
    for k, v in _flat(tp).items():
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)


def test_loss_matches_reference(moe):
    jcfg, tcfg, jm, jp, tm, tp = moe
    toks = _tokens(1, (2, 24), tcfg.vocab)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl, jmet = jm.loss(jp, jax.tree.map(jnp.asarray, batch))
    tl, tmet = tm.loss(tp, batch)
    assert _rel(float(tmet["xent"]), float(jmet["xent"])) <= TOL
    assert _rel(float(tmet["aux"]), float(jmet["aux"])) <= TOL
    assert float(tmet["aux"]) > 0
    assert _rel(float(tl), float(jl)) <= TOL


def test_prefill_matches_reference(moe):
    jcfg, tcfg, jm, jp, tm, tp = moe
    toks = _tokens(2, (2, 10), tcfg.vocab)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    assert tl.shape == (2, 1, tcfg.vocab)
    assert _rel(tl.numpy(), jl) <= TOL
    assert set(tc) == set(jc) == {"k", "v"}
    for key in tc:
        assert _rel(tc[key].numpy(), jc[key]) <= TOL, key


def test_decode_step_matches_prefill(moe):
    """capacity_factor 8 as in the reference's test: the prefill drops
    nothing, so decode (C = 1 a token) sees the same experts."""
    jcfg, tcfg, jm, jp, tm, tp = moe
    tm = Model(dataclasses.replace(tcfg, capacity_factor=8.0), device="cpu")
    B, S = 2, 10
    toks = _tokens(3, (B, S), tcfg.vocab)
    want, _ = tm.prefill(tp, {"tokens": toks})
    cache = tm.init_cache(B, S + 4)
    for t in range(S):
        got, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def _chunk_inputs(context):
    """Three rows and a dummy: slots 2, 0, 1 at offsets 0, 5, 3 with 5, 4
    and 2 valid tokens, the dummy at offset = context."""
    toks = _tokens(4, (4, 5), 256)
    return (toks, np.array([2, 0, 1, 3], np.int32),
            np.array([0, 5, 3, context], np.int32),
            np.array([5, 4, 2, 1], np.int32))


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_chunks_matches_reference(moe, paged):
    """Two batched chunk dispatches into a cache, contiguous or as a block
    pool through a permuted table with sentinels: the real rows' logits
    and every cache leaf within 1e-5 (the dummy row's writes all drop)."""
    jcfg, tcfg, jm, jp, tm, tp = moe
    n_slots, context, bs = 4, 24, 4
    tbl = None
    if paged:
        nb = context // bs
        tbl = np.random.default_rng(5).permutation(n_slots * nb) \
            .reshape(n_slots, nb).astype(np.int32)
        tbl[:, 4:] = n_slots * nb     # sentinels: past every written position
        jc = jm.init_cache(n_slots * nb, bs)
        tc = tm.init_cache(n_slots * nb, bs)
    else:
        jc = jm.init_cache(n_slots, context)
        tc = tm.init_cache(n_slots, context)
    toks, slots, offs, nval = _chunk_inputs(context)
    for step in range(2):
        o = offs + 5 * step * (offs < context)
        jl, jc = jm.prefill_chunks(
            jp, jc, jnp.asarray(toks + step), jnp.asarray(slots),
            jnp.asarray(o), jnp.asarray(nval),
            block_table=None if tbl is None else jnp.asarray(tbl))
        tl, tc = tm.prefill_chunks(tp, tc, toks + step, slots, o, nval,
                                   block_table=tbl)
        assert _rel(tl.numpy()[:3], np.asarray(jl)[:3]) <= TOL
    for key in ("k", "v"):
        assert _rel(tc[key].numpy(), jc[key]) <= TOL, key


def test_prefill_chunk_matches_reference(moe):
    jcfg, tcfg, jm, jp, tm, tp = moe
    toks = _tokens(6, (1, 7), tcfg.vocab)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    jl, jc = jm.prefill_chunk(jp, jc, jnp.asarray(toks), 1, 3, 6)
    tl, tc = tm.prefill_chunk(tp, tc, toks, 1, 3, 6)
    assert tl.shape == (1, tcfg.vocab)
    assert _rel(tl.numpy(), jl) <= TOL
    for key in ("k", "v"):
        assert _rel(tc[key].numpy(), jc[key]) <= TOL, key


# ------------------------------------------------------------------ engines

@pytest.fixture(scope="module")
def lm():
    """float32 tiny qwen2-moe (2 layers, vocab 64) in both packages."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b", n_layers=2, vocab=64)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def _prompts(seed, lens, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


_ROUTES = {
    "contiguous": {},
    "paged-take-dense": dict(kv_block_size=8),
    "paged-cuda-dense": dict(kv_block_size=8, kv_gather="cuda"),
    "paged-take-reference": dict(kv_block_size=8, decode_kernel="reference"),
    "paged-cuda-fused": dict(kv_block_size=8, kv_gather="cuda",
                             decode_kernel="fused"),
}


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_serve_engine_parity_with_jax(lm, route, quantized):
    """Mixed prompt lengths, a chunk size that divides none of them,
    batched prefill (2 rows, a dummy row when one is left), slot churn and
    one prompt over the context (rejected): identical greedy tokens, event
    logs, statuses, counters and resident bytes."""
    jcfg, tcfg, jp, tp = lm
    prompts = _prompts(30, (3, 17, 9, 40, 22, 5, 13))
    kw = dict(max_batch=3, max_context=32, prefill_chunk=5, prefill_batch=2,
              quantized=quantized, **_ROUTES[route])
    jeng = JServeEngine(jcfg, jp, eos_id=-1, **{
        k: ("pallas" if v == "cuda" else v) for k, v in kw.items()})
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=8)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng = ServeEngine(tcfg, tp, eos_id=-1, device="cpu", **kw)
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=8)
             for i, p in enumerate(prompts)]
    teng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert teng.events == jeng.events
    for key in ("prefill_tokens", "decode_tokens", "prefill_chunks",
                "prefill_dispatches", "decode_steps", "rejected",
                "kv_bytes_read"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.quant_bytes == jeng.quant_bytes


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_engine_parity_with_jax(lm, quantized):
    """Seven prompts in batches of 3, left-padded with unmasked token 0
    (the padding is routed and takes capacity, as in the reference), one
    over the context and rejected."""
    jcfg, tcfg, jp, tp = lm
    prompts = _prompts(4, (3, 17, 9, 40, 22, 5, 13))
    kw = dict(max_batch=3, max_context=32, quantized=quantized)
    jeng = JReferenceEngine(jcfg, jp, eos_id=-1, **kw)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=6)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng = ReferenceEngine(tcfg, tp, eos_id=-1, device="cpu", **kw)
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
             for i, p in enumerate(prompts)]
    teng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert {k: teng.stats[k] for k in COUNTS} == \
        {k: jeng.stats[k] for k in COUNTS}


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_moe_tree_matches_reference(arch):
    """The int8-PoT tree: the same paths, mantissas and exponents leaf for
    leaf; ``router`` and every ``wu`` (experts', shared, dense) stay
    float; an expert leaf has one exponent per output channel over (L, E,
    d); ``quant_bytes`` and ``serving_ledger`` equal the reference's."""
    jcfg, tcfg = _cfgs(arch)
    jp = JModel(jcfg).init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jq = _flat(jax.tree.map(np.asarray, jptq.quantize_tree(jp, bits=8)))
    tq_tree = ptq.quantize_tree(tp, bits=8)
    tq = _flat(tq_tree)
    assert set(tq) == set(jq)
    for k, v in tq.items():
        if torch.is_tensor(v):
            np.testing.assert_array_equal(v.numpy(), jq[k], err_msg=k)
            assert v.numpy().dtype == np.asarray(jq[k]).dtype, k
        else:
            assert v == jq[k], k
    L, E, d, f = tcfg.n_layers, tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert "/layers/moe/router" in tq and "/layers/moe/wu" in tq
    assert not any(k.endswith("/wu/q") for k in tq)
    assert tuple(tq["/layers/moe/wg/exp"].shape) == (f,)
    assert tuple(tq["/layers/moe/wd/exp"].shape) == (d,)
    assert tuple(tq["/layers/moe/wg/q"].shape) == (L, E, d, f)
    sub = "shared" if tcfg.n_shared_experts else "dense"
    assert f"/layers/moe/{sub}/wg/q" in tq and f"/layers/moe/{sub}/wu" in tq
    assert ptq.quant_bytes(tq_tree) == jptq.quant_bytes(
        jptq.quantize_tree(jp, bits=8))
    for bits in (8, {"layers/moe/wd": 4, "layers/moe/wg": 6}):
        kw = dict(bits=bits, act_itemsize=4.0)
        assert ptq.serving_ledger(tp, **kw).to_dict() == \
            jptq.serving_ledger(jp, **kw).to_dict()
    want = jptq.dequant(jptq.quantize_tree(jp, bits=8), dtype=jnp.float32)
    got = ptq.dequant(tq_tree, dtype=torch.float32)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(_flat(
            jax.tree.map(np.asarray, want))[k]), err_msg=k)


@pytest.mark.parametrize("name", sorted(jlist_configs()) if jax else [])
def test_params_counts_match_reference(name):
    """Every reference config, rebuilt as the port's ArchConfig, at full
    size and reduced, and the port's registered config of that name equal
    to it (every reference config is ported)."""
    jcfg = jget_config(name)
    for ref in (jcfg, jcfg.reduced()):
        mine = ArchConfig(**{f.name: getattr(ref, f.name)
                             for f in dataclasses.fields(ArchConfig)})
        assert mine.params_count() == ref.params_count()
        assert mine.active_params_count() == ref.active_params_count()
    assert get_config(name) == ArchConfig(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(ArchConfig)})
    if name == "qwen2-moe-a2.7b":
        assert get_config(name).params_count() == 14_004_422_656
        assert get_config(name).active_params_count() == 2_377_811_968


@pytest.mark.parametrize("engine", ["paged", "reference"])
def test_launcher_serves_moe_on_cpu(engine, capsys):
    launch_serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--batch", "2",
                       "--prompt-len", "6", "--max-new", "3", "--context",
                       "32", "--kv-block-size", "8", "--engine", engine])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode: 6 tok" in out


# ------------------------------------------------------------------ the card

@pytest.mark.gpu
def test_gpu_moe_matches_cpu_and_launches_kernels():
    """On the card (f32, tiny qwen2-moe): ServeEngine on the fused / cuda
    routes gives the CPU's greedy tokens with one K+V pair gather a layer
    and prefill dispatch, one attention (and combine) launch a layer and
    decode step; ReferenceEngine gives the CPU's tokens with one flash
    launch a layer and prefill; Model.loss the CPU's within 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    tcfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                               n_layers=2, vocab=64, dtype="float32")
    tp = Model(tcfg, device="cpu").init(0)
    prompts = _prompts(12, (3, 17, 9, 22))
    outs, ref_outs, losses = [], [], []
    toks = _tokens(8, (2, 24), 64)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    for dev in ("cpu", "cuda"):
        paged_gather_kernel.launches = paged_gather_pair_kernel.launches = 0
        paged_attention_kernel.launches = 0
        paged_attention_kernel.combine_launches = 0
        flash_attention_kernel.launches = 0
        eng = ServeEngine(tcfg, tp, eos_id=-1, max_batch=3, max_context=32,
                          prefill_chunk=5, prefill_batch=2, kv_block_size=8,
                          kv_gather="cuda", decode_kernel="fused", device=dev)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
        s, L = eng.stats, tcfg.n_layers
        want = (s["prefill_dispatches"] * L, s["decode_steps"] * L) \
            if dev == "cuda" else (0, 0)
        assert (paged_gather_pair_kernel.launches,
                paged_attention_kernel.launches) == want
        assert paged_gather_kernel.launches == 0
        assert paged_attention_kernel.combine_launches in (0, want[1])
        reng = ReferenceEngine(tcfg, tp, eos_id=-1, max_batch=2,
                               max_context=32, device=dev)
        rreqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=4)
                 for i, p in enumerate(prompts)]
        reng.run(rreqs)
        ref_outs.append([r.out_tokens for r in rreqs])
        assert flash_attention_kernel.launches == \
            (2 * L if dev == "cuda" else 0)
        m = Model(tcfg, device=dev)
        losses.append(float(m.loss(
            {k: v for k, v in _to(tp, dev).items()}, batch)[0]))
    assert outs[0] == outs[1]
    assert ref_outs[0] == ref_outs[1]
    assert abs(losses[1] - losses[0]) <= TOL * abs(losses[0])


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
