"""repro_torch's hybrid family (recurrentgemma: RG-LRU + local attention)
against the JAX package on the CPU, on the reduced config in f32 with 5
layers (one unit plus two tail layers) and the reference's own init:

- ``rglru_seq`` from nonzero recurrent and conv states: out, hS and the
  conv state within 1e-5;
- ``Model.loss`` within 1e-5 relative; ``prefill`` logits and every cache
  leaf within 1e-5, below and past the 32-token window (the ring);
- token-by-token ``decode_step`` past the window within 2e-4, the bound
  of the reference's own prefill/decode test;
- ``ReferenceEngine``: equal greedy tokens and stats, inside the window
  and past it with ``max_context`` > window, where both engines pad the
  K/V ring as the reference does and decode the same, faulty, tokens.

All differences are f32 sums in another order (XLA fuses and reorders
the reference's elementwise chains).  On the card (``gpu`` marker) a
tiny hybrid runs through the linear-scan and flash kernels and gives the
CPU's loss and tokens."""
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
    from repro.runtime.serve import ReferenceEngine as JReferenceEngine
    from repro.runtime.serve import Request as JRequest
except ImportError:
    jax = None
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.linear_scan import linear_scan_kernel
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import Model, blocks, get_config, params_from_jax
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

TOL = 1e-5          # one forward, f32 sums in another order
DECODE_TOL = 2e-4   # tests/test_models.py::test_prefill_decode_consistency
COUNTS = ("prefill_tokens", "decode_tokens", "rejected", "truncated")
KW = dict(n_layers=5, dtype="float32")     # 1 unit + 2 tail layers
WINDOW = 32                                # the reduced local_window


def _cfgs():
    return (dataclasses.replace(jget_config("recurrentgemma-9b").reduced(),
                                **KW),
            dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                                **KW))


@pytest.fixture(scope="module")
def hyb():
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jm, jp, Model(tcfg, device="cpu"), tp


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def test_config_and_init_layout(hyb):
    """The config is the reference's; the port's own init has the
    reference's tree (the tail a list of 2) and shapes."""
    _, tcfg, _, jp, _, tp = hyb
    assert dataclasses.asdict(get_config("recurrentgemma-9b")) == \
        dataclasses.asdict(jget_config("recurrentgemma-9b"))
    assert isinstance(tp["tail"], list) and len(tp["tail"]) == 2
    assert _shapes(Model(tcfg, device="cpu").init(0)) == _shapes(jp) == \
        _shapes(tp)


def test_rglru_seq_matches_jax(hyb):
    """From nonzero h0 and conv state, 12 steps."""
    jcfg, tcfg, _, jp, _, tp = hyb
    rng = np.random.default_rng(3)
    B, S, w = 2, 12, tcfg.rglru_width
    x = rng.normal(0, 1, (B, S, tcfg.d_model)).astype(np.float32)
    h0 = rng.normal(0, 0.5, (B, w)).astype(np.float32)
    c0 = rng.normal(0, 0.5, (B, 3, w)).astype(np.float32)
    jp_rg = jax.tree.map(lambda t: t[0], jp["layers"]["rg1"])
    tp_rg = {k: v[0] for k, v in tp["layers"]["rg1"].items()}
    want = jblocks.rglru_seq(jp_rg, jnp.asarray(x), jcfg, jnp.asarray(h0),
                             jnp.asarray(c0))
    got = blocks.rglru_seq(tp_rg, torch.from_numpy(x), tcfg,
                           torch.from_numpy(h0), torch.from_numpy(c0))
    for g, w_ in zip(got, want):
        assert tuple(g.shape) == w_.shape
        _close(g.numpy(), w_)


def test_loss_matches_jax(hyb):
    _, _, jm, jp, tm, tp = hyb
    toks = _tokens(1, (2, 40))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    want = float(jm.loss(jp, jax.tree.map(jnp.asarray, batch))[0])
    got, mets = tm.loss(tp, batch)
    assert set(mets) == {"xent", "aux"}
    assert abs(float(got) - want) <= TOL * abs(want)


@pytest.mark.parametrize("S", [20, 45])
def test_prefill_cache_matches_jax(hyb, S):
    """S <= window: the cache holds every position; S > window: a ring of
    32 slots, position p in slot p % 32."""
    _, tcfg, jm, jp, tm, tp = hyb
    toks = _tokens(2, (2, S))
    jlg, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    lg, cache = tm.prefill(tp, {"tokens": toks})
    _close(lg.numpy(), jlg)
    assert set(cache) == set(jc)
    assert cache["k"].shape[2] == min(S, WINDOW)
    for key in jc:
        assert cache[key].dtype == getattr(torch, str(jc[key].dtype))
        _close(cache[key].numpy(), jc[key])


def test_decode_past_the_window_matches_jax(hyb):
    """40 tokens one at a time from init_cache(context 48): the ring wraps
    after 32; every step's logits within 2e-4 of the reference's, and the
    last within 2e-4 of the port's own prefill of all 40."""
    _, tcfg, jm, jp, tm, tp = hyb
    B, S = 2, 40
    toks = _tokens(4, (B, S))
    jdecode = jax.jit(jm.decode_step)
    jcache = jm.init_cache(B, 48)
    cache = tm.init_cache(B, 48)
    assert cache["k"].shape[2] == WINDOW
    for t in range(S):
        jlg, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                              jnp.int32(t))
        lg, cache = tm.decode_step(tp, cache, toks[:, t:t + 1], t)
        _close(lg.numpy(), jlg, DECODE_TOL)
    for key in jcache:
        _close(cache[key].numpy(), jcache[key], DECODE_TOL)
    _close(lg.numpy(), tm.prefill(tp, {"tokens": toks})[0].numpy(),
           DECODE_TOL)


def test_ring_pad_fault_is_held(hyb):
    """The reference's ReferenceEngine pads the K/V ring to max_context.
    Prefill 40 tokens, decode the 41st: on the ring the port matches a
    41-token prefill; on the ring padded to 64 it is off, and equals the
    reference's decode on the same padded cache."""
    _, tcfg, jm, jp, tm, tp = hyb
    toks = _tokens(5, (1, 41))
    full = tm.prefill(tp, {"tokens": toks})[0]
    _, ring = tm.prefill(tp, {"tokens": toks[:, :40]})
    _, jring = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :40])})
    pad = {k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 64 - WINDOW))
               if k in ("k", "v") else v.clone()) for k, v in ring.items()}
    jpad = {k: (jnp.pad(v, [(0, 0), (0, 0), (0, 64 - WINDOW), (0, 0),
                            (0, 0)]) if k in ("k", "v") else v)
            for k, v in jring.items()}
    on_ring = tm.decode_step(tp, ring, toks[:, 40:], 40)[0]
    padded = tm.decode_step(tp, pad, toks[:, 40:], 40)[0]
    jpadded = jm.decode_step(jp, jpad, jnp.asarray(toks[:, 40:]),
                             jnp.int32(40))[0]
    _close(on_ring.numpy(), full.numpy())
    assert (padded - full).abs().max().item() > 1e-3
    _close(padded.numpy(), jpadded, DECODE_TOL)


def _run_both(hyb, prompts, max_new, **kw):
    jcfg, tcfg, _, jp, _, tp = hyb
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
    return treqs


@pytest.mark.parametrize("lens,max_context,max_new", [
    ((5, 12, 9, 20), WINDOW, 6),   # every prompt + new tokens inside
    ((30, 7, 22), 48, 8),          # 30 + 8 > window < max_context
])
def test_reference_engine_hybrid_parity(hyb, lens, max_context, max_new):
    prompts = [_tokens(10 + i, n) for i, n in enumerate(lens)]
    treqs = _run_both(hyb, prompts, max_new, max_batch=2,
                      max_context=max_context)
    assert all(len(r.out_tokens) == max_new for r in treqs)


def test_quantized_hybrid_matches_jax(hyb):
    """int8-PoT serving quantizes the tail layers too (list items, path
    ``tail/[i]/...``): the serving ledger equals the reference's, and so
    do the greedy tokens."""
    jcfg, tcfg, _, jp, _, tp = hyb
    want = JReferenceEngine(jcfg, jp, quantized=True).serving_sheet.to_dict()
    got = ReferenceEngine(tcfg, tp, quantized=True, device="cpu")
    assert got.serving_sheet.to_dict() == want
    assert isinstance(got.params["tail"][0]["rg"]["w_in_x"], dict)
    prompts = [_tokens(30 + i, n) for i, n in enumerate((9, 17, 4))]
    _run_both(hyb, prompts, 5, max_batch=2, max_context=WINDOW,
              quantized=True)


def test_dense_prefill_cache_is_kv_only():
    """Padding only "k"/"v" leaves a dense engine as it was: its prefill
    cache has no other leaf."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2)
    m = Model(cfg, device="cpu")
    assert set(m.prefill(m.init(0), {"tokens": _tokens(6, (1, 5))})[1]) == \
        {"k", "v"}


def test_hybrid_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        Model(_cfgs()[1])


def test_unported_families_and_engines_raise(hyb):
    _, tcfg, _, _, _, tp = hyb
    with pytest.raises(NotImplementedError):
        Model(dataclasses.replace(tcfg, family="nope"), device="cpu")
    with pytest.raises(NotImplementedError):
        ServeEngine(tcfg, tp, device="cpu")
    m = Model(tcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        m.decode_step(tp, m.init_cache(1, 8), np.zeros((1, 1), np.int32),
                      np.zeros(1, np.int32),
                      block_table=np.zeros((1, 1), np.int32))


def test_launcher_serves_the_hybrid_on_cpu(capsys):
    launch_serve.main(["--arch", "recurrentgemma-9b", "--reduced",
                       "--device", "cpu", "--requests", "3", "--batch", "2",
                       "--prompt-len", "6", "--max-new", "3", "--context",
                       "32"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "decode: 6 tok" in out


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
def test_gpu_hybrid_matches_cpu():
    """On the card a tiny f32 hybrid runs every RG-LRU through the
    linear-scan kernel (4 per forward: 2 per unit, 1 per tail layer) and
    every local attention through the flash kernel (1 per unit): its loss
    is the CPU's within 1e-5 relative and ReferenceEngine, inside the
    window and past it, gives the CPU's greedy tokens."""
    _needs_card()
    tcfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                               **KW)
    tp = Model(tcfg, device="cpu").init(0)
    toks = _tokens(7, (2, 40))
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for dev in ("cpu", "cuda"):
        n_scan = linear_scan_kernel.launches
        n_flash = flash_attention_kernel.launches
        losses.append(float(Model(tcfg, device=dev).loss(_to(tp, dev),
                                                         batch)[0]))
    assert linear_scan_kernel.launches - n_scan == 4
    assert flash_attention_kernel.launches - n_flash == 1
    assert abs(losses[1] - losses[0]) <= TOL * abs(losses[0])
    prompts = [_tokens(20 + i, n) for i, n in enumerate((30, 7, 22))]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ReferenceEngine(tcfg, tp, eos_id=-1, max_batch=2,
                              max_context=48, device=dev)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=8)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
