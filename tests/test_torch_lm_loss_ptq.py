"""repro_torch's LM loss, prefill and post-training quantization against
the JAX package on the CPU: ``TokenPipeline`` batches identical,
``Model.loss`` within 1e-5 relative, ``Model.prefill`` logits and cache
within 1e-5, ``min_bitwidth_search`` (batched and serial) choosing the
same bits with history losses within 1e-5 relative, ``sls_rescale``
raising the same exponents (equal mantissas), ``serving_ledger`` equal
exactly, and the ``serve_quantized`` launcher on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.data.tokens import TokenPipeline as JTokenPipeline
    from repro.nn import Model as JModel
    from repro.nn import blocks as jblocks
    from repro.nn import get_config as jget_config
    from repro.quant import min_bitwidth_search as jmin_bitwidth_search
    from repro.quant import quantize_tree as jquantize_tree
    from repro.quant import serving_ledger as jserving_ledger
    from repro.quant import sls_rescale as jsls_rescale
except ImportError:
    jax = None
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import serve_quantized
from repro_torch.nn import Model, blocks, get_config, params_from_jax
from repro_torch.quant import (min_bitwidth_search, quantize_tree,
                               serving_ledger, sls_rescale)

REL = 1e-5          # f32 loss: the same graph summed in another order


def _cfgs(**kw):
    kw = dict(dict(n_layers=2, vocab=256, remat=False, dtype="float32"), **kw)
    return (dataclasses.replace(jget_config("qwen2-0.5b").reduced(), **kw),
            dataclasses.replace(get_config("qwen2-0.5b").reduced(), **kw))


@pytest.fixture(scope="module")
def lm():
    """A float32 tiny dense LM in both packages, its params, and a jitted
    JAX loss on one validation batch (8 rows x 64 tokens)."""
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    batch = TokenPipeline(vocab=256, seq_len=64, global_batch=8).batch(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss = jax.jit(lambda p: jm.loss(p, jbatch)[0])
    tm = Model(tcfg, device="cpu")
    return jm, jp, tm, tp, batch, jloss


@pytest.fixture(scope="module")
def sharp(lm):
    """The same LM with embed and lm_head scaled by 10: its logits are not
    flat, so the bit ladder moves the loss (by -0.004 %, +0.5 %, +0.7 %
    and +1.0 % at 8, 6, 5 and 4 bits) and a budget can stop the walk
    mid-ladder."""
    jm, jp, tm, _, batch, jloss = lm
    jp = dict(jp, embed=jp["embed"] * 10, lm_head=jp["lm_head"] * 10)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp, batch, jloss


@pytest.mark.parametrize("seed,shards", [(0, 1), (3, 2)])
def test_token_pipeline_identical(seed, shards):
    for shard in range(shards):
        a = TokenPipeline(vocab=151936, seq_len=48, global_batch=4, seed=seed,
                          n_shards=shards, shard=shard)
        b = JTokenPipeline(vocab=151936, seq_len=48, global_batch=4,
                           seed=seed, n_shards=shards, shard=shard)
        for step in (0, 5):
            x, y = a.batch(step), b.batch(step)
            assert set(x) == set(y) == {"tokens", "labels"}
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seq_len", [64, 600])
def test_loss_matches_jax(lm, seq_len):
    """600 tokens: two cross-entropy chunks and two attention blocks."""
    jm, jp, tm, tp, _, _ = lm
    batch = TokenPipeline(vocab=256, seq_len=seq_len, global_batch=2,
                          seed=1).batch(0)
    jl, jmet = jm.loss(jp, jax.tree.map(jnp.asarray, batch))
    tl, tmet = tm.loss(tp, batch)
    assert tl.dtype == torch.float32 and tl.ndim == 0
    assert abs(float(tl) - float(jl)) <= REL * abs(float(jl))
    assert float(tmet["aux"]) == float(jmet["aux"]) == 0.0
    assert float(tmet["xent"]) == float(tl)


def test_prefill_matches_jax(lm):
    jm, jp, tm, tp, _, _ = lm
    toks = np.random.default_rng(2).integers(0, 256, (3, 37)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": toks})
    assert tl.shape == (3, 1, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=REL,
                               atol=REL)
    assert set(tc) == set(jc) == {"k", "v"}
    for key in ("k", "v"):
        assert tc[key].shape == (2, 3, 37, 2, 16)
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   rtol=REL, atol=REL)


@pytest.mark.parametrize("window", [0, 9])
def test_attention_seq_matches_jax(lm, window):
    jm, jp, _, tp, _, _ = lm
    jcfg, tcfg = _cfgs()
    x = np.random.default_rng(3).normal(0, 1, (2, 70, 64)).astype(np.float32)
    want = jblocks.attention_seq(jax.tree.map(lambda a: a[0],
                                              jp["layers"]["attn"]),
                                 jnp.asarray(x), jcfg, window=window,
                                 block_q=32, block_kv=16)
    got = blocks.attention_seq({k: v[0] for k, v in
                                tp["layers"]["attn"].items()},
                               torch.from_numpy(x), tcfg, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL,
                               atol=REL)
    # kv_override: cross-attention to 23 other positions' K and V (with
    # qwen's QKV bias), q unroped, non-causal; at the reference's default
    # blocks, since under the window rows past key 31 see no key and
    # average v over the kv length padded to the key block
    src = np.random.default_rng(4).normal(0, 1, (2, 23, 64)).astype(
        np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tattn = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    jkv = jblocks.kv_proj(jattn, jnp.asarray(src), jcfg)
    tkv = blocks.kv_proj(tattn, torch.from_numpy(src), tcfg)
    want = jblocks.attention_seq(jattn, jnp.asarray(x), jcfg, window=window,
                                 causal=False, kv_override=jkv)
    got = blocks.attention_seq(tattn, torch.from_numpy(x), tcfg,
                               window=window, kv_override=tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=REL,
                               atol=REL)


def _assert_far_from_budget(history, budget):
    """Every rung's loss lies farther than the tolerance from the budget
    line, so the accept/stop comparisons mean the same in both packages."""
    line = history[0][1] * (1.0 + budget)
    for _, loss in history[1:]:
        assert abs(loss - line) > REL * abs(line), (loss, line)


@pytest.mark.parametrize("budget,bits", [(0.003, 8), (0.006, 6), (0.02, 4)])
def test_min_bitwidth_search_matches_jax(sharp, budget, bits):
    """0.003: 6 bits breaks the budget at once; 0.006: 8 and 6 bits pass
    and 5 bits stops the walk; 0.02: every rung passes.  The oracle is the
    reference's serial engine (its batched one is held bit-identical to it
    by the reference's own tests, and compiles for ten seconds here)."""
    jm, jp, tm, tp, batch, jloss = sharp
    _, jbits, jhist = jmin_bitwidth_search(jp, jloss, budget=budget,
                                           engine="serial")
    assert jbits == bits
    for engine in ("batched", "serial"):
        qt, tbits, thist = min_bitwidth_search(
            tp, lambda p: tm.loss(p, batch)[0], budget=budget, engine=engine)
        assert tbits == jbits
        assert [b for b, _ in thist] == [b for b, _ in jhist]
        for (_, a), (_, b) in zip(thist, jhist):
            assert abs(a - b) <= REL * abs(b)
        _assert_far_from_budget(thist, budget)
        leaf = qt["layers"]["attn"]["wq"]
        assert leaf["bits"] == bits and leaf["q"].dtype == torch.int8


@pytest.mark.parametrize("bits", [8, 4])
def test_sls_rescale_matches_jax(sharp, bits):
    """Same raises, same mantissas and exponents, on an int8 tree (every
    raise lowers this model's loss, so all 16 hold) and on a nibble-packed
    int4 tree (some raises break the budget)."""
    jm, jp, tm, tp, batch, jloss = sharp
    budget = 0.002
    jt, jraised = jsls_rescale(jquantize_tree(jp, bits=bits), jloss,
                               budget=budget, max_raise=2)
    losses = []

    def ev(p):
        losses.append(float(tm.loss(p, batch)[0]))
        return losses[-1]
    tt, traised = sls_rescale(quantize_tree(tp, bits=bits), ev,
                              budget=budget, max_raise=2)
    assert traised == jraised and (traised < 16) == (bits == 4)
    _assert_far_from_budget([("base", losses[0])] +
                            [(None, x) for x in losses[1:]], budget)
    jleaves = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        jt, is_leaf=lambda x: isinstance(x, dict) and "q" in x)[0]}
    n = 0
    for path, leaf in jleaves.items():
        if not isinstance(leaf, dict):
            continue
        t = tt
        for key in path:
            t = t[key.key]
        assert t["bits"] == leaf["bits"] == bits
        assert bool(t.get("packed")) == bool(leaf.get("packed"))
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(leaf["q"]))
        np.testing.assert_array_equal(t["exp"].numpy(),
                                      np.asarray(leaf["exp"]))
        n += 1
    assert n == 8


@pytest.mark.parametrize("bits", [8, 5, "mixed"])
def test_serving_ledger_matches_jax(lm, bits):
    _, jp, _, tp, _, _ = lm
    if bits == "mixed":
        bits = {"layers/attn/wq": 4, "lm_head": 6, "layers/mlp/wd": 5}
    kw = dict(bits=bits, act_itemsize=2.0, meta={"arch": "tiny"})
    want = jserving_ledger(jp, **kw).to_dict()
    got = serving_ledger(tp, **kw).to_dict()
    assert got == want
    assert [r["name"] for r in got["layers"]] == [
        "embed", "layers/attn/wk", "layers/attn/wo", "layers/attn/wq",
        "layers/attn/wv", "layers/mlp/wd", "layers/mlp/wg", "lm_head"]


def test_batched_search_scores_one_tree_at_a_time(lm):
    """The default scorer receives the dequantized trees lazily."""
    _, _, tm, tp, batch, _ = lm
    seen = []

    def eval_many(trees):
        assert not isinstance(trees, list)
        out = []
        for t in trees:
            seen.append(t["layers"]["attn"]["wq"].dtype)
            out.append(tm.loss(t, batch)[0])
        return out
    _, bits, hist = min_bitwidth_search(
        tp, lambda p: tm.loss(p, batch)[0], budget=0.02, eval_many=eval_many)
    assert seen == [torch.bfloat16] * 4 and len(hist) == 5
    with pytest.raises(ValueError):
        min_bitwidth_search(tp, lambda p: 0.0, engine="stacked")


def test_serve_quantized_launcher_on_cpu(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve_quantized --device cpu`` at a
    reduced size: search (batched == serial), rescale, ReferenceEngine."""
    _, tcfg = _cfgs(n_layers=1, vocab=128)
    full = serve_quantized.run_pipeline
    runs = []
    for name, value in dict(get_config=lambda arch: tcfg, SEQ_LEN=48,
                            BATCH=2, N_REQUESTS=3, PROMPT_LENS=(4, 12),
                            MAX_NEW=3, MAX_BATCH=2, MAX_CONTEXT=24).items():
        monkeypatch.setattr(serve_quantized, name, value)
    monkeypatch.setattr(serve_quantized, "run_pipeline",
                        lambda device: runs.append(full(device)) or runs[-1])
    serve_quantized.main(["--device", "cpu"])
    out = capsys.readouterr().out
    r = runs[0]
    assert "same bits and history" in out and "served 3/3" in out
    assert r.serial == (r.bits, r.history)
    assert r.loss_calls["search"] == 5 and r.launches["search"] == 0
    assert r.ledger.bits_by_layer()["lm_head"] == r.bits
    assert all(len(q.out_tokens) == 3 for q in r.requests)
    lens = [len(p) for p in serve_quantized.prompts(128)]
    assert r.engine.stats["prefill_tokens"] == 2 * max(lens[:2]) + lens[2]
