"""repro_torch's RWKV6 family (``ssm``: rwkv6-3b) against the JAX package
on the CPU, on the reduced config (4 layers, d_model 64, heads of 16) in
f32.  The reference's init sets ``u = 0``, ``mu = cm_mu = 0.5``,
``ln_x = 0`` and ``w0 = -6`` everywhere, which would hide a wrong axis, a
swapped mix index or a missing ``ln_x``; so the parameters here are the
reference's init with those five leaves overwritten by seeded numpy
values, carried across with ``params_from_jax``.

- ``init_rwkv``'s leaf names, shapes and dtypes equal the reference's;
- ``wkv6_plain`` within 1e-5 of a float64 loop of the reference's step,
  on bf16 r, k, v bit for bit its result on their f32 upcasts;
  ``ops.wkv6`` hands bf16 r, k, v on uncast; the kernel's tiling a pure
  function of hd; the time mix (y, state, tm_prev) and the channel mix
  within 1e-5, the bf16 time mix within bf16's rounding;
- ``Model.loss``, ``prefill`` (logits and the three cache leaves) within
  1e-5; decode steps from a prefill and decode after ``prefill(S)``
  against ``prefill(S+1)`` within 2e-4 (the reference's own bound);
- ``ReferenceEngine``: greedy tokens and stats equal the reference's,
  float and int8-PoT, on left-padded batches of mixed lengths; the
  serving ledger equal, and the leaves it quantizes;
- ``ServeEngine``, chunked prefill and block-paged decode raise, as in
  the reference; the launcher serves ``--arch rwkv6-3b``.

The ``gpu`` tests (they skip without a card) hold the ``wkv6`` kernel
against its plain version at the chip run's shapes and around a ring
stage, f32 and bf16 r, k, v, every hd: the final state bit for bit, y
within 2e-5 of its row's max |y| (the kernel adds the hd terms in its
own order, then the bonus term, the plain ``einsum`` in a batched
product's order); one launch a call; an unsupported hd, f16, f64 and
mixed dtypes raise; the library's tiling is :func:`tiling`'s."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.nn import Model as JModel
    from repro.nn import blocks as jblocks
    from repro.nn import get_config as jget_config
    from repro.quant import ptq as jptq
    from repro.runtime.serve import ReferenceEngine as JReferenceEngine
    from repro.runtime.serve import Request as JRequest
except ImportError:
    jax = None
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import Model, blocks, get_config, params_from_jax
from repro_torch.quant import ptq
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

wkv6_mod = importlib.import_module("repro_torch.kernels.wkv6")

TOL = 1e-5          # one forward, f32 sums in another order
DECODE_TOL = 2e-4   # tests/test_models.py::test_prefill_decode_consistency
Y_TOL = 2e-5        # the kernel's y, x its row's max |y|
COUNTS = ("prefill_tokens", "decode_tokens", "rejected", "truncated")
ARCH = "rwkv6-3b"


def _overrides(tree, seed=0):
    """The reference's init tree (numpy) with ``u``, ``mu``, ``cm_mu``,
    ``ln_x`` and ``w0`` drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    lay = dict(tree["layers"])
    draw = {"u": lambda s: rng.normal(0.0, 0.5, s),
            "mu": lambda s: rng.uniform(0.0, 1.0, s),
            "cm_mu": lambda s: rng.uniform(0.0, 1.0, s),
            "ln_x": lambda s: rng.normal(0.0, 0.3, s),
            "w0": lambda s: rng.normal(-1.5, 1.0, s)}
    for name, f in draw.items():
        lay[name] = f(lay[name].shape).astype(np.float32)
    return {**tree, "layers": lay}


@pytest.fixture(scope="module")
def rwkv():
    jcfg = dataclasses.replace(jget_config(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    jm = JModel(jcfg)
    npp = _overrides(jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))))
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(npp, device="cpu")
    return jcfg, tcfg, jm, jp, Model(tcfg, device="cpu"), tp


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


def test_config_and_init_layout(rwkv):
    """The config is the reference's, at full size too; the port's init
    has the reference's leaf names, shapes and f32 dtypes, stacked on a
    leading layer axis; ``params_from_jax`` carries the tree unchanged."""
    jcfg, tcfg, jm, jp, _, tp = rwkv
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    want = _layout(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    assert _layout(Model(tcfg, device="cpu").init(0)) == want
    assert set(want["layers"]) == {
        "mu", "wr", "wk", "wv", "wg", "wo", "w0", "wA", "wB", "u", "ln_x",
        "cm_mu", "cm_k", "cm_v"}
    assert _layout(tp) == want
    for key, val in jp["layers"].items():
        assert np.array_equal(tp["layers"][key].numpy(), np.asarray(val))
    # one layer's leaves, unstacked, as the reference's init_rwkv
    g = torch.Generator().manual_seed(0)
    assert _layout(blocks.init_rwkv(g, tcfg)) == _layout(
        jax.eval_shape(lambda k: jblocks.init_rwkv(k, jcfg),
                       jax.random.PRNGKey(0)))


def _wkv_inputs(seed, B, S, H, hd):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-1.5, 1.0, (B, S, H, hd)))).astype(
        np.float32)
    u = rng.normal(0, 0.5, (H, hd)).astype(np.float32)
    s0 = rng.normal(0, 1, (B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


def _wkv_f64(r, k, v, w, u, s0):
    """The reference's step in float64 numpy: u and w on the key axis i
    (rows of s), v on the value axis j."""
    r, k, v, w, u, s = (np.asarray(a, np.float64) for a in
                        (r, k, v, w, u, s0))
    y = np.empty_like(r)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        y[:, t] = np.einsum("bhk,bhkv->bhv", r[:, t],
                            s + u[None, :, :, None] * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s


@pytest.mark.parametrize("B,S,H,hd", [(2, 13, 3, 16), (1, 1, 2, 8),
                                      (3, 5, 1, 32)])
def test_wkv6_plain_matches_the_reference_step(B, S, H, hd):
    args = _wkv_inputs(B * 100 + S, B, S, H, hd)
    y, sS = wkv6_mod.wkv6_plain(*map(torch.from_numpy, args))
    wy, ws = _wkv_f64(*args)
    assert y.dtype == sS.dtype == torch.float32
    _close(y.numpy(), wy)
    _close(sS.numpy(), ws)
    # the op takes the plain version on the CPU, and raises elsewhere
    y2, s2 = ops.wkv6(*map(torch.from_numpy, args))
    assert torch.equal(y2, y) and torch.equal(s2, sS)
    with pytest.raises(RuntimeError):
        ops.wkv6(*(torch.from_numpy(a).to("meta") for a in args))


@pytest.mark.parametrize("B,S,H,hd", [(2, 13, 3, 16), (1, 17, 2, 64),
                                      (3, 1, 1, 32)])
def test_wkv6_plain_bf16_equals_its_f32_upcasts(B, S, H, hd):
    """bf16 to f32 is exact, so the plain version on bf16 r, k, v equals
    it on their f32 upcasts bit for bit (y and the state)."""
    r, k, v, w, u, s0 = map(torch.from_numpy,
                            _wkv_inputs(B * 10 + S, B, S, H, hd))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    y, sS = wkv6_mod.wkv6_plain(rb, kb, vb, w, u, s0)
    wy, ws = wkv6_mod.wkv6_plain(rb.float(), kb.float(), vb.float(), w, u,
                                 s0)
    assert y.dtype == sS.dtype == torch.float32
    assert torch.equal(y.view(torch.int32), wy.view(torch.int32))
    assert torch.equal(sS.view(torch.int32), ws.view(torch.int32))


def test_ops_wkv6_takes_bf16_without_a_cast(monkeypatch):
    """``ops.wkv6`` hands bf16 r, k, v to the plain version as they are
    (the kernel takes them so on the card) and gives its result."""
    r, k, v, w, u, s0 = map(torch.from_numpy, _wkv_inputs(5, 2, 9, 3, 32))
    rb, kb, vb = (t.to(torch.bfloat16) for t in (r, k, v))
    seen = []
    plain = ops.wkv6_plain

    def spy(*args):
        seen.append([a.dtype for a in args])
        return plain(*args)
    monkeypatch.setattr(ops, "wkv6_plain", spy)
    y, sS = ops.wkv6(rb, kb, vb, w, u, s0)
    assert seen == [[torch.bfloat16] * 3 + [torch.float32] * 3]
    wy, ws = plain(rb, kb, vb, w, u, s0)
    assert torch.equal(y, wy) and torch.equal(sS, ws)


@pytest.mark.parametrize("hd", wkv6_mod.HEAD_DIMS)
def test_wkv6_tiling_is_a_function_of_hd(hd):
    """The kernel's sizes at every head width: a pair's lanes split the
    key axis into rows of 16-byte groups, the warps tile the block's
    columns, the blocks the chain's, and the ring fits the blocks an SM
    must hold (five at hd = 64: 640 blocks at the loss's batch on 132
    SMs)."""
    t = wkv6_mod.tiling(hd)
    assert t == wkv6_mod.tiling(hd)
    assert t.p * t.g == 32 and t.p * t.r == hd and t.r % 4 == 0
    assert t.c in (2, 4) and t.p >= t.c
    assert t.w * t.c * t.g == t.cb and t.cb * t.ncb == hd
    assert t.threads == 32 * (t.w + 1)
    assert t.ns >= 2 and t.smem_f32 < t.smem_bf16 <= 227 * 1024
    sm_bytes = 228 * 1024
    per_sm = sm_bytes // (t.smem_bf16 + 1024)
    assert per_sm >= {16: 8, 32: 4, 64: 4, 128: 2}[hd]
    if hd == 64:
        assert (t.p, t.c, t.r, t.cb, t.ncb, t.w, t.t, t.ns) == (
            16, 4, 4, 32, 2, 4, 16, 2)
        assert (t.smem_f32, t.smem_bf16) == (33152, 43392)
        assert -(-4 * 40 * t.ncb // 132) <= per_sm     # serving: 3 an SM
        assert -(-8 * 40 * t.ncb // 132) <= per_sm     # the loss: 5
    with pytest.raises(ValueError):
        wkv6_mod.tiling(hd + 8)


def test_wkv6_route_rule():
    """A decode step (S = 1) takes the step route, every longer sequence
    the ring; a pure function of S."""
    assert wkv6_mod.ROUTES == ("ring", "step")
    assert wkv6_mod.route(1) == "step"
    assert {wkv6_mod.route(S) for S in (2, 15, 16, 17, 1024, 1345)} == {
        "ring"}


def test_time_mix_matches_jax(rwkv):
    """From a nonzero state and previous token, 9 steps: y, the state and
    tm_prev within 1e-5."""
    jcfg, tcfg, _, jp, _, tp = rwkv
    rng = np.random.default_rng(3)
    B, S, d, hd = 2, 9, tcfg.d_model, tcfg.rwkv_head_dim
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    st = rng.normal(0, 0.5, (B, d // hd, hd, hd)).astype(np.float32)
    xp = rng.normal(0, 1, (B, d)).astype(np.float32)
    want = jblocks.rwkv_time_mix_seq(_layer(jp["layers"]), jnp.asarray(x),
                                     jcfg, jnp.asarray(st), jnp.asarray(xp))
    got = blocks.rwkv_time_mix_seq(_layer(tp["layers"]), torch.from_numpy(x),
                                   tcfg, torch.from_numpy(st),
                                   torch.from_numpy(xp))
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape
        _close(g.numpy(), w_)
    # from the defaults (zero state and previous token)
    want = jblocks.rwkv_time_mix_seq(_layer(jp["layers"], 2), jnp.asarray(x),
                                     jcfg)
    got = blocks.rwkv_time_mix_seq(_layer(tp["layers"], 2),
                                   torch.from_numpy(x), tcfg)
    for g, w_ in zip(got, want):
        _close(g.numpy(), w_)


def test_time_mix_bf16_matches_jax(rwkv, monkeypatch):
    """The time mix in bf16 (a bf16 layer and x, as the bf16 serving path
    runs it) hands ``wkv6`` its bf16 r, k, v uncast, and agrees with the
    reference's bf16 time mix: the state within 1e-5 of its max (w's f32
    products differ in order, ~1 ulp), y within 1e-2 of its max |y| (one
    bf16 ulp near the max is 2^-8 to 2^-7 of it; the two frameworks' bf16
    matmuls round r, k, v, g and the output in their own order), tm_prev
    exactly."""
    jcfg, tcfg, _, jp, _, tp = rwkv
    rng = np.random.default_rng(3)
    B, S, d, hd = 2, 9, tcfg.d_model, tcfg.rwkv_head_dim
    x = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    st = rng.normal(0, 0.5, (B, d // hd, hd, hd)).astype(np.float32)
    xp = rng.normal(0, 1, (B, d)).astype(np.float32)
    seen = []
    plain = ops.wkv6_plain

    def spy(*args):
        seen.append([a.dtype for a in args[:3]])
        return plain(*args)
    monkeypatch.setattr(ops, "wkv6_plain", spy)
    jl = {k: v.astype(jnp.bfloat16) for k, v in _layer(jp["layers"]).items()}
    tl = {k: v.to(torch.bfloat16) for k, v in _layer(tp["layers"]).items()}
    want = jblocks.rwkv_time_mix_seq(jl, jnp.asarray(x, jnp.bfloat16), jcfg,
                                     jnp.asarray(st),
                                     jnp.asarray(xp, jnp.bfloat16))
    got = blocks.rwkv_time_mix_seq(tl, torch.from_numpy(x).bfloat16(), tcfg,
                                   torch.from_numpy(st),
                                   torch.from_numpy(xp).bfloat16())
    assert seen == [[torch.bfloat16] * 3]
    y, state, prev = (t.float().numpy() for t in got)
    wy, wstate, wprev = (np.asarray(t.astype(jnp.float32)) for t in want)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    assert np.abs(y - wy).max() <= 1e-2 * np.abs(wy).max()
    assert np.abs(state - wstate).max() <= TOL * np.abs(wstate).max()
    assert np.array_equal(prev, wprev)


def test_channel_mix_matches_jax(rwkv):
    _, _, _, jp, _, tp = rwkv
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 7, 64)).astype(np.float32)
    xp = rng.normal(0, 1, (2, 64)).astype(np.float32)
    for prev in (xp, None):
        want = jblocks.rwkv_channel_mix(
            _layer(jp["layers"], 1), jnp.asarray(x),
            None if prev is None else jnp.asarray(prev))
        got = blocks.rwkv_channel_mix(
            _layer(tp["layers"], 1), torch.from_numpy(x),
            None if prev is None else torch.from_numpy(prev))
        for g, w_ in zip(got, want):
            _close(g.numpy(), w_)


def test_loss_matches_jax(rwkv):
    _, _, jm, jp, tm, tp = rwkv
    toks = _tokens(1, (2, 24))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = float(jm.loss(jp, jax.tree.map(jnp.asarray, batch))[0])
    got, mets = tm.loss(tp, batch)
    assert set(mets) == {"xent", "aux"} and float(mets["aux"]) == 0.0
    assert abs(float(got) - want) <= TOL * abs(want)


def test_prefill_cache_matches_jax(rwkv):
    """Logits and all three cache leaves (state f32; tm_prev and cm_prev
    the mixes' last normed inputs) within 1e-5, in the reference's
    dtypes and the init_cache layout."""
    _, _, jm, jp, tm, tp = rwkv
    toks = _tokens(2, (3, 11))
    jlg, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    lg, cache = tm.prefill(tp, {"tokens": toks})
    _close(lg.numpy(), jlg)
    assert set(cache) == set(jc) == {"state", "tm_prev", "cm_prev"}
    assert _layout(cache) == _layout(tm.init_cache(3, 99))
    for key in jc:
        assert cache[key].dtype == getattr(torch, str(jc[key].dtype))
        _close(cache[key].numpy(), jc[key])


def test_decode_steps_match_jax(rwkv):
    """Prefill 6 tokens, then decode 5 one at a time (``pos`` is ignored):
    every step's logits and cache within 2e-4 of the reference's, and the
    last logits within 2e-4 of the port's own prefill of all 11."""
    _, _, jm, jp, tm, tp = rwkv
    toks = _tokens(3, (2, 11))
    _, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :6])})
    _, cache = tm.prefill(tp, {"tokens": toks[:, :6]})
    jdecode = jax.jit(jm.decode_step)
    for t in range(6, 11):
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], 10 ** 6)
        _close(lg.numpy(), jlg, DECODE_TOL)
        for key in jcache:
            _close(cache[key].numpy(), jcache[key], DECODE_TOL)
    _close(lg.numpy(), tm.prefill(tp, {"tokens": toks})[0].numpy(),
           DECODE_TOL)


def test_decode_after_prefill_matches_longer_prefill(rwkv):
    """From init_cache, token by token, as the reference's own test; and
    decode of token S + 1 after prefill(S) against prefill(S + 1)."""
    _, _, _, _, tm, tp = rwkv
    toks = _tokens(4, (2, 10))
    cache = tm.init_cache(2, 14)
    for t in range(10):
        lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
    full = tm.prefill(tp, {"tokens": toks})[0]
    _close(lg.numpy(), full.numpy(), DECODE_TOL)
    _, cache = tm.prefill(tp, {"tokens": toks[:, :9]})
    got = tm.decode_step(tp, cache, toks[:, 9:], 9)[0]
    _close(got.numpy(), full.numpy(), DECODE_TOL)


def test_init_cache_is_context_free(rwkv):
    """The counterpart of tests/test_models.py's
    test_rwkv_state_decode_is_context_free, against the reference's
    shapes and dtypes."""
    _, tcfg, jm, _, tm, _ = rwkv
    c1, c2 = tm.init_cache(1, 128), tm.init_cache(1, 1 << 19)
    assert _layout(c1) == _layout(c2) == _layout(jm.init_cache(1, 128))
    H, hd = tcfg.d_model // tcfg.rwkv_head_dim, tcfg.rwkv_head_dim
    assert c1["state"].shape == (tcfg.n_layers, 1, H, hd, hd)
    assert all(float(v.abs().sum()) == 0 for v in c1.values())


def _run_both(rwkv, prompts, max_new, **kw):
    jcfg, tcfg, _, jp, _, tp = rwkv
    jeng = JReferenceEngine(jcfg, jp, eos_id=-1, **kw)
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    teng = ReferenceEngine(tcfg, tp, eos_id=-1, device="cpu", **kw)
    treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    teng.run(treqs)
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert {k: teng.stats[k] for k in COUNTS} == \
        {k: jeng.stats[k] for k in COUNTS}
    assert set(teng.stats) == set(jeng.stats)
    return teng, treqs


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_engine_matches_jax(rwkv, quantized):
    """Left-padded batches of mixed lengths (the padding enters the state,
    unmasked, as in the reference): equal greedy tokens and stats; the
    prefill cache's fixed-size leaves pass ``_pad_kv`` unchanged."""
    prompts = [_tokens(10 + i, n) for i, n in enumerate((5, 12, 3, 9, 7))]
    teng, treqs = _run_both(rwkv, prompts, 6, max_batch=2, max_context=24,
                            quantized=quantized)
    assert all(len(r.out_tokens) == 6 for r in treqs)
    _, cache = teng.model.prefill(teng._deq(teng.params),
                                  {"tokens": _tokens(5, (2, 4))})
    assert set(cache) == {"state", "tm_prev", "cm_prev"}


def test_quantized_tree_and_ledger_match_jax(rwkv):
    """Under the reference's skip rule mu, cm_mu, u, w0 and ln_x stay
    float; wA, wB, cm_k, cm_v and the five d x d projections are
    quantized.  The serving ledger equals the reference's."""
    jcfg, tcfg, _, jp, _, tp = rwkv
    eng = ReferenceEngine(tcfg, tp, quantized=True, device="cpu")
    lay = eng.params["layers"]
    quantized = {k for k, v in lay.items() if isinstance(v, dict)}
    assert quantized == {"wr", "wk", "wv", "wg", "wo", "wA", "wB", "cm_k",
                         "cm_v"}
    for kw in (dict(bits=8), dict(bits=4)):
        assert ptq.serving_ledger(tp, **kw).to_dict() == \
            jptq.serving_ledger(jp, **kw).to_dict()
    want = JReferenceEngine(jcfg, jp, quantized=True).serving_sheet
    assert eng.serving_sheet.to_dict() == want.to_dict()


def test_paged_paths_raise_for_ssm(rwkv):
    """As in the reference: ServeEngine refuses the family, and so do the
    chunked prefill and block-paged decode."""
    _, tcfg, _, _, tm, tp = rwkv
    with pytest.raises(NotImplementedError):
        ServeEngine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError):
        tm.prefill_chunks(tp, tm.init_cache(1, 8), _tokens(0, (1, 4)), [0],
                          [0], [4])
    with pytest.raises(NotImplementedError):
        tm.decode_step(tp, tm.init_cache(1, 8), _tokens(0, (1, 1)),
                       np.zeros(1, np.int32),
                       block_table=np.zeros((1, 1), np.int32))


def test_rwkv_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        Model(get_config(ARCH).reduced())
    with pytest.raises(RuntimeError):
        ReferenceEngine(get_config(ARCH).reduced(), {})


def test_launcher_serves_rwkv_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--batch", "2", "--prompt-len",
                       "6", "--max-new", "3", "--context", "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode: 6 tok" in out


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


def _card_inputs(B, S, H, hd, seed=0, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(randn(B, S, H, hd) - 1.5))
    return r, k, v, w, randn(H, hd) * 0.5, randn(B, H, hd, hd)


def _check_against_plain(args, route=None):
    n0 = wkv6_mod.wkv6_kernel.launches
    how = route or wkv6_mod.route(args[0].shape[1])
    r0 = wkv6_mod.wkv6_kernel.route_launches[how]
    y, sS = wkv6_mod.wkv6_kernel(*args, _route=route)
    torch.cuda.synchronize()
    assert wkv6_mod.wkv6_kernel.launches == n0 + 1
    assert wkv6_mod.wkv6_kernel.route_launches[how] == r0 + 1
    wy, ws = wkv6_mod.wkv6_plain(*args)
    assert y.dtype == torch.float32 and y.shape == args[0].shape
    assert torch.equal(sS.view(torch.int32), ws.view(torch.int32))
    row = wy.abs().amax(dim=-1, keepdim=True)
    assert bool(((y - wy).abs() <= Y_TOL * row).all())


_T = wkv6_mod.tiling(64).t          # the ring's steps a stage (every hd)
_GPU_SHAPES = [(B, S, H, hd) for n, (hd, S) in enumerate(
    (hd, S) for hd in wkv6_mod.HEAD_DIMS
    for S in (1, _T - 1, _T, _T + 1, 1000, 1345))
    for B, H in [((1, 3, 8)[n % 3], (3, 5, 7)[n // 3 % 3])]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd", [
    (8, 1024, 40, 64),      # Model.loss at full width
    (4, 1345, 40, 64),      # the first ReferenceEngine prefill batch
    (4, 1, 40, 64),         # a decode step from a nonzero state
    (2, 63, 4, 16), (3, 1000, 2, 128), (1, 1, 3, 16), (2, 63, 5, 32),
    *_GPU_SHAPES])
def test_gpu_wkv6_matches_plain(B, S, H, hd, dtype):
    """The state bit for bit and y within ``Y_TOL`` of its row's max |y|,
    f32 and bf16 r, k, v, every hd, S around a ring stage (1, T - 1, T,
    T + 1) and long, B in {1, 3, 8}, H not a multiple of the column
    blocks a chain."""
    _needs_card()
    _check_against_plain(_card_inputs(B, S, H, hd, dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("route", wkv6_mod.ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,H,hd", [(4, 1, 40, 64), (3, 2, 5, 64),
                                      (1, 17, 3, 16), (8, 63, 7, 32),
                                      (3, 1, 5, 128), (1, 33, 3, 128)])
def test_gpu_wkv6_both_routes(B, S, H, hd, dtype, route):
    """Each route forced, where the rule would not take it too: the state
    bit for bit and y within ``Y_TOL``, the route counted."""
    _needs_card()
    _check_against_plain(_card_inputs(B, S, H, hd, dtype=dtype), route)


@pytest.mark.gpu
def test_gpu_wkv6_op_launches_once_and_refuses_bad_hd():
    _needs_card()
    args = _card_inputs(2, 5, 2, 64)
    n0 = wkv6_mod.wkv6_kernel.launches
    ops.wkv6(*args)
    assert wkv6_mod.wkv6_kernel.launches == n0 + 1
    bf = _card_inputs(2, 5, 2, 64, dtype=torch.bfloat16)
    y, sS = ops.wkv6(*bf)                  # bf16 r, k, v: one launch
    assert wkv6_mod.wkv6_kernel.launches == n0 + 2
    wy, ws = wkv6_mod.wkv6_plain(*bf)
    assert torch.equal(sS.view(torch.int32), ws.view(torch.int32))
    with pytest.raises(ValueError):
        ops.wkv6(*_card_inputs(2, 5, 2, 48))
    with pytest.raises(ValueError):
        wkv6_mod.wkv6_kernel(*args, _route="chunked")
    with pytest.raises(ValueError):
        wkv6_mod.wkv6_kernel(*(a.double() for a in args))
    for bad in ([args[0].half(), args[1].half(), args[2].half()],
                [args[0].double(), args[1].double(), args[2].double()],
                [args[0], bf[1], args[2]]):          # f16, f64, mixed
        with pytest.raises(ValueError):
            ops.wkv6(*bad, *args[3:])
        with pytest.raises(ValueError):
            wkv6_mod.wkv6_kernel(*bad, *args[3:])
    assert wkv6_mod.wkv6_kernel.launches == n0 + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_wkv6_op_takes_views_off_16_bytes(dtype):
    """r, k, v, w as contiguous views one element past a 16-byte boundary:
    the kernel refuses them (its TMA tensor maps need aligned bases) and
    ``ops.wkv6`` copies them first, the plain version's state bit for
    bit."""
    _needs_card()
    args = _card_inputs(2, 37, 3, 64, dtype=dtype)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view
    views = [shifted(t) for t in args[:4]]
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in views)
    with pytest.raises(ValueError):
        wkv6_mod.wkv6_kernel(*views, *args[4:])
    y, sS = ops.wkv6(*views, *args[4:])
    wy, ws = wkv6_mod.wkv6_plain(*args)
    assert torch.equal(sS.view(torch.int32), ws.view(torch.int32))
    assert bool(((y - wy).abs() <= Y_TOL * wy.abs().amax(-1, True)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("hd", wkv6_mod.HEAD_DIMS)
def test_gpu_wkv6_tiling_is_the_library_s(hd):
    _needs_card()
    assert wkv6_mod.library_tiling(hd) == wkv6_mod.tiling(hd)


@pytest.mark.gpu
def test_gpu_rwkv_matches_cpu():
    """A tiny f32 rwkv on the card: one wkv6 launch a layer and loss
    forward, its loss the CPU's within 1e-5 relative, and ReferenceEngine
    the CPU's greedy tokens, float and int8-PoT."""
    _needs_card()
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    tp = Model(cfg, device="cpu").init(0)
    toks = _tokens(7, (2, 40))
    losses = []
    for dev in ("cpu", "cuda"):
        n0 = wkv6_mod.wkv6_kernel.launches
        losses.append(float(Model(cfg, device=dev).loss(
            _to(tp, dev),
            {"tokens": toks, "labels": toks})[0]))
    assert wkv6_mod.wkv6_kernel.launches - n0 == cfg.n_layers
    assert abs(losses[1] - losses[0]) <= TOL * abs(losses[0])
    prompts = [_tokens(20 + i, n) for i, n in enumerate((30, 7, 22))]
    for quantized in (False, True):
        outs = []
        for dev in ("cpu", "cuda"):
            eng = ReferenceEngine(cfg, tp, eos_id=-1, max_batch=2,
                                  max_context=48, quantized=quantized,
                                  device=dev)
            reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=8)
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            outs.append([r.out_tokens for r in reqs])
        assert outs[0] == outs[1]

