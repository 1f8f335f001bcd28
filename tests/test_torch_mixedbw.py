"""repro_torch's mixed bit-width searches against the JAX package on the
CPU, on ``tests/test_mixedbw.py``'s inputs: ``quantizable_paths`` in the
reference's order; ``_embed_layer`` bit for bit; ``mixed_bitwidth_search``
on the toy tree (integer-valued loss) with histories equal exactly and on
the reduced LM ``lm32`` with decisions equal and losses within 1e-5
relative; the calibration-set cases; ``mixed_minq_search`` on the
JAX-trained 16-10-10 with every result equal; the explorer's ``mixedbw``
variant; the mixed tree served by both engines; and the
``mixed_bitwidth`` launcher at a reduced size.  On the card (``gpu``
marker) the pendigits search on ``csd`` equals ``numpy``, the mixed tree
serves through the paged kernels as the dequantized tree does, and the
LM search makes the CPU's decisions."""
import dataclasses
from dataclasses import astuple

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.core import quantize_inputs as jquantize_inputs
    from repro.core.intmlp import FRAC
    from repro.core.intmlp import act_requant as jact_requant
    from repro.core.planner import SynthesisPlanner as JPlanner
    from repro.core.quantize import quantize_value as jquantize_value
    from repro.data import pendigits as jpd
    from repro.explore import explore as jexplore
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.quant import dequant as jdequant
    from repro.quant import mixed_bitwidth_search as jmixed_bitwidth_search
    from repro.quant import mixed_minq_search as jmixed_minq_search
    from repro.quant import quantizable_paths as jquantizable_paths
    from repro.quant import quantize_tree as jquantize_tree
    from repro.quant.mixed import _embed_layer as j_embed_layer
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeEngine as JServeEngine
    from repro.train.zaal import TrainConfig as JTrainConfig
    from repro.train.zaal import train as jtrain
except ImportError:
    jax = None
from repro_torch.core.intmlp import IntMLP, forward_int
from repro_torch.core.planner import SynthesisPlanner
from repro_torch.explore import explore
from repro_torch.kernels.csd_matvec import csd_qsweep_kernel
from repro_torch.launch import explore as lx
from repro_torch.launch import mixed_bitwidth
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.quant import (dequant, mixed_bitwidth_search,
                               mixed_minq_search, quantizable_paths,
                               quantize_tree, serving_ledger)
from repro_torch.quant.mixed import _embed_layer
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

REL = 1e-5          # f32 loss: the same graph summed in another order
ACTS = ("htanh", "hsig")
ENGINES = ("batched", "serial")
LM32 = dict(n_layers=2, vocab=64, remat=False, dtype="float32")
MIXED_BITS = [8, 6, 5, 8, 6, 5, 8, 6]
TIMINGS = ("tune_s", "wall_s")


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def toy():
    """``test_mixedbw.py::toy_tree`` in both packages, with its eval_fn
    written once in each.  The loss is integer-valued at float32; the
    global search scores bf16 trees, which both packages round alike."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jp = {"wq": jax.random.normal(k1, (8, 16)) * 0.1,
          "wk": jax.random.normal(k2, (8, 16)) * 0.03,
          "wv": jax.random.normal(k3, (8, 16)) * 0.05,
          "ln": jnp.ones((16,))}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}

    def weighted(lib, p, coef):
        return sum(c * lib.sum(lib.round(lib.abs(p[k]) * 256.0))
                   for k, c in zip(("wq", "wk", "wv"), coef))

    def jeval(p):
        return weighted(jnp, p, (4.0, 2.0, 1.0)) + jnp.sum(p["ln"])

    def jeval2(p):
        return weighted(jnp, p, (2.0, 6.0, 1.0))

    def teval(p):
        return weighted(torch, p, (4.0, 2.0, 1.0)) + torch.sum(p["ln"])

    def teval2(p):
        return weighted(torch, p, (2.0, 6.0, 1.0))

    return jp, tp, (jeval, jeval2), (teval, teval2)


@pytest.fixture(scope="module")
def lm32():
    """``test_mixedbw.py::lm32`` (2 layers, vocab 64, f32) in both
    packages: the reference's params moved to the port, one batch of
    2 x 16 tokens, a jitted JAX loss and the port's."""
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(), **LM32)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **LM32)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 16), 0, jcfg.vocab)
    jbatch = {"tokens": toks, "labels": toks}
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tbatch = {k: np.asarray(v) for k, v in jbatch.items()}
    tm = Model(tcfg, device="cpu")
    jloss = jax.jit(lambda p: jm.loss(p, jbatch)[0])
    return jcfg, tcfg, jp, tp, jloss, lambda p: tm.loss(p, tbatch)[0]


@pytest.fixture(scope="module")
def lm32_reference(lm32):
    """The reference's search on lm32 at budget 1e-3, default ladder, on
    its serial engine (its batched one is held identical to it by its own
    tests, and compiles a stacked map for every round size here)."""
    _, _, jp, _, jloss, _ = lm32
    return jmixed_bitwidth_search(jp, jloss, budget=1e-3, engine="serial")


@pytest.fixture(scope="module")
def trained():
    """``test_mixedbw.py``'s pendigits inputs: 16-10-10 trained by the JAX
    trainer (5 epochs, seed 3), the quantized validation split."""
    ds = jpd.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    res = jtrain(JTrainConfig(structure=(16, 10, 10), epochs=5, seed=3),
                 jpd.to_unit(xtr), ytr, jpd.to_unit(xval), yval)
    return ([np.asarray(w) for w in res.weights],
            [np.asarray(b) for b in res.biases],
            jquantize_inputs(jpd.to_unit(xval)), yval)


# ------------------------------------------------------- quantizable paths

@pytest.mark.parametrize("tree", ["toy", "lm32", "qwen2-reduced"])
def test_quantizable_paths_order(tree, toy, lm32):
    """The reference's tree order (dict keys sorted), whatever order the
    port's dicts were built in."""
    if tree == "toy":
        jp, tp = toy[:2]
        assert list(tp) == ["wq", "wk", "wv", "ln"]
        assert quantizable_paths(tp) == ["wk", "wq", "wv"]
    elif tree == "lm32":
        jp, tp = lm32[2:4]
    else:
        jp = JModel(jget_config("qwen2-0.5b").reduced()).init(
            jax.random.PRNGKey(0))
        tp = Model(get_config("qwen2-0.5b").reduced(), device="cpu").init(0)
    got = quantizable_paths(tp)
    assert got == jquantizable_paths(jp)
    if tree != "toy":
        assert got == ["embed", "layers/attn/wk", "layers/attn/wo",
                       "layers/attn/wq", "layers/attn/wv", "layers/mlp/wd",
                       "layers/mlp/wg", "lm_head"]


# ------------------------------------------------------- shift embedding

def _native_mixed_forward(ws_int, bs_int, acts, qs, x_int):
    """``test_mixedbw.py``'s mixed-q forward: every layer requantizes at
    its OWN q (the reference's ``act_requant``)."""
    a = x_int.astype(np.int64)
    for w, b, act, q in zip(ws_int, bs_int, acts, qs):
        acc = a @ w.astype(np.int64) + (b.astype(np.int64) << FRAC)
        a = jact_requant(acc, act, q)
    return a


@pytest.mark.parametrize("seed", range(12))
def test_embed_layer_equals_reference(seed):
    """``_check_embedding_exact``'s generator: the embedded layers equal
    the reference's bit for bit, and the port's integer forward of the
    embedded network equals native mixed-q arithmetic."""
    rng = np.random.default_rng(seed)
    structure = tuple(rng.integers(3, 9, rng.integers(2, 4)))
    ws = [rng.uniform(-1, 1, (a, b))
          for a, b in zip(structure[:-1], structure[1:])]
    bs = [rng.uniform(-0.5, 0.5, b) for b in structure[1:]]
    acts = [("htanh", "hsig", "relu", "lin")[int(rng.integers(0, 4))]
            for _ in ws]
    q_star = int(rng.integers(2, 7))
    qs = [int(rng.integers(1, q_star + 1)) for _ in ws]
    x = rng.integers(-128, 128, (17, structure[0]))
    emb = [_embed_layer(w, b, qk, q_star) for w, b, qk in zip(ws, bs, qs)]
    for (ew, eb), w, b, qk in zip(emb, ws, bs, qs):
        jw, jb = j_embed_layer(w, b, qk, q_star)
        for got, want in ((ew, jw), (eb, jb)):
            assert got.dtype == want.dtype == np.int64
            np.testing.assert_array_equal(got, want)
    native = _native_mixed_forward(
        [jquantize_value(w, qk) for w, qk in zip(ws, qs)],
        [jquantize_value(b, qk) for b, qk in zip(bs, qs)], acts, qs, x)
    mlp = IntMLP([w for w, _ in emb], [b for _, b in emb], acts, q_star)
    np.testing.assert_array_equal(forward_int(mlp, x), native)


# ---------------------------------------------- the LM adapter, toy tree

def _same_search(got, want):
    return (got.bits, got.start_bits, got.history) == \
        (want.bits, want.start_bits, want.history)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("budget", [1e-9, 0.01, 0.05, 10.0])
def test_mixed_bitwidth_toy_equals_reference(toy, budget, engine):
    """Bits, start rung and every round's candidates, losses, pick and
    flag equal the reference's on the same engine.  The sheet equals the
    reference's serial one: at 0.05 and 10.0 no round is accepted, so its
    ``loss`` is the global search's at the start rung, scored on a bf16
    tree, and there the reference's stacked map rounds the bf16 sums
    otherwise than its per-tree call (15608 against 15632 at 0.05).  The
    port scores one tree at a time on both engines."""
    jp, tp, (jeval, _), (teval, _) = toy
    got = mixed_bitwidth_search(tp, teval, budget=budget, engine=engine)
    want = jmixed_bitwidth_search(jp, jeval, budget=budget, engine=engine)
    assert _same_search(got, want)
    serial = want if engine == "serial" else jmixed_bitwidth_search(
        jp, jeval, budget=budget, engine="serial")
    assert got.sheet.to_dict() == dict(
        serial.sheet.to_dict(), meta=dict(serial.sheet.meta, engine=engine))
    assert set(got.bits) == {"wq", "wk", "wv"}
    assert got.qtree["ln"] is tp["ln"]                  # shared, not copied
    for path, b in got.bits.items():
        assert got.qtree[path]["bits"] == b
    assert (len(got.history) > 0) == (budget <= 0.01)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", [("pair", 0.01), ("pair", 0.05),
                                  ("single", 0.05)])
def test_mixed_bitwidth_calibration_set_equals_reference(toy, case, engine):
    """``test_mixed_bitwidth_calibration_set_parity``'s cases: a two-batch
    calibration set scored on the mean loss, and a singleton set, which
    reproduces the plain search."""
    kind, budget = case
    jp, tp, jevals, tevals = toy
    n = 2 if kind == "pair" else 1
    got = mixed_bitwidth_search(tp, list(tevals[:n]), budget=budget,
                                engine=engine)
    want = jmixed_bitwidth_search(jp, list(jevals[:n]), budget=budget,
                                  engine=engine)
    assert _same_search(got, want)
    if kind == "single":
        plain = mixed_bitwidth_search(tp, tevals[0], budget=budget,
                                      engine=engine)
        assert _same_search(got, plain)


# ---------------------------------------------------- the LM adapter, lm32

def _assert_far_from_threshold(res, budget):
    """Every candidate lies farther than the tolerance from the budget
    line, and so does each round's second-lowest candidate from its
    lowest, so accept / stop and the pick mean the same in both
    packages."""
    line = res.base * (1.0 + budget)
    for _, cands, _, _ in res.history:
        losses = sorted(loss for _, _, loss in cands)
        for loss in losses:
            assert abs(loss - line) > REL * abs(line), (loss, line)
        if len(losses) > 1:
            assert losses[1] - losses[0] > REL * abs(losses[0]), losses


@pytest.mark.parametrize("engine", ENGINES)
def test_mixed_bitwidth_lm32_equals_reference(lm32, lm32_reference, engine):
    """Budget 1e-3, ladder 8-6-5-4: the search starts at 5 and plays 8
    rounds (7 accepted).  Decisions equal, losses within 1e-5 relative."""
    _, _, _, tp, _, tloss = lm32
    want = lm32_reference
    _assert_far_from_threshold(want, 1e-3)
    got = mixed_bitwidth_search(tp, tloss, budget=1e-3, engine=engine)
    assert (got.bits, got.start_bits) == (want.bits, want.start_bits)
    assert want.start_bits == 5
    assert len(got.history) == len(want.history)
    for (r, cands, picked, ok), (wr, wcands, wpicked, wok) in zip(
            got.history, want.history):
        assert (r, picked, ok) == (wr, wpicked, wok)
        assert [c[:2] for c in cands] == [c[:2] for c in wcands]
        for (_, _, a), (_, _, b) in zip(cands, wcands):
            assert abs(a - b) <= REL * abs(b)
    assert sum(ok for *_, ok in got.history) >= 2
    for a, b in ((got.base, want.base), (got.loss, want.loss)):
        assert abs(a - b) <= REL * abs(b)
    gd, wd = got.sheet.to_dict(), want.sheet.to_dict()
    strip = ("base_loss", "loss", "engine")
    assert dict(gd, meta=None) == dict(wd, meta=None)
    assert {k: v for k, v in gd["meta"].items() if k not in strip} == \
        {k: v for k, v in wd["meta"].items() if k not in strip}
    assert got.sheet.weight_bytes() == serving_ledger(
        tp, bits=got.bits).weight_bytes()


# -------------------------------------------------- the pendigits adapter

@pytest.fixture(scope="module")
def minq_reference(trained):
    """The reference's ``mixed_minq_search`` on both engines, on the
    single split and on the two-half calibration set."""
    ws, bs, x, y = trained
    h = len(x) // 2
    splits = {"single": (x, y), "halves": ([x[:h], x[h:]], [y[:h], y[h:]])}
    return splits, {(e, s): jmixed_minq_search(ws, bs, ACTS, *xy, engine=e)
                    for e in ENGINES for s, xy in splits.items()}


@pytest.mark.parametrize("split", ["single", "halves"])
@pytest.mark.parametrize("backend", ["numpy", "csd"])
@pytest.mark.parametrize("engine", ENGINES)
def test_mixed_minq_equals_reference(trained, minq_reference, engine,
                                     backend, split):
    """``qs``, ``ha``, ``q*``, ``history``, every embedded weight and the
    sheet equal the reference's exactly (``csd`` through its plain
    version on the CPU)."""
    ws, bs, _, _ = trained
    splits, refs = minq_reference
    want = refs[(engine, split)]
    got = mixed_minq_search(ws, bs, ACTS, *splits[split], engine=engine,
                            backend=backend, device="cpu")
    assert (got.qs, got.ha, got.base_ha, got.q_star, got.history) == \
        (want.qs, want.ha, want.base_ha, want.q_star, want.history)
    for a, b in zip(got.mlp.weights + got.mlp.biases,
                    want.mlp.weights + want.mlp.biases):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.sheet.to_dict() == want.sheet.to_dict()
    assert len(got.history) >= 1 and all(q <= got.q_star for q in got.qs)


# ------------------------------------------------------------ the explorer

def test_explore_mixedbw_equals_reference(trained):
    """``test_explore_weight_bytes_axis``'s call: every DesignPoint, the
    fronts and the non-timing stats equal the reference's, one
    ``mixedbw`` point, and the weight-bytes front sorted by cost."""
    ws, bs, x, y = trained
    kw = dict(tuners=("none", "mixedbw"), q_span=1,
              arch_styles=(("parallel", "behavioral"),))
    got = explore(ws, bs, ACTS, x, y, planner=SynthesisPlanner(),
                  device="cpu", **kw)
    want = jexplore(ws, bs, ACTS, x, y, planner=JPlanner(), **kw)
    assert [astuple(p) for p in got.points] == \
        [astuple(p) for p in want.points]
    for metric in ("area_um2", "weight_bytes"):
        assert [astuple(p) for p in got.front(metric)] == \
            [astuple(p) for p in want.front(metric)]
    assert {k: v for k, v in got.stats.items() if k not in TIMINGS} == \
        {k: v for k, v in want.stats.items() if k not in TIMINGS}
    assert [p.tuner for p in got.points].count("mixedbw") == 1
    assert all(p.weight_bytes > 0 for p in got.points)
    costs = [p.weight_bytes for p in got.front("weight_bytes")]
    assert costs and costs == sorted(costs)


# ------------------------------------------------------ serving the tree

def _serve(engcls, cfg, params, prompts, device="cpu", **kw):
    eng = engcls(cfg, params, max_batch=2, max_context=32, eos_id=-1,
                 device=device, **kw)
    reqs = [Request(rid=i, prompt=np.asarray(p, np.int32), max_new_tokens=5)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.out_tokens for r in reqs], eng


def _serving_prompts(vocab):
    """``test_mixed_serving_parity_engines``'s equal-length prompts."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 6) for _ in range(3)]


def test_mixed_serving_parity_engines(lm32):
    """The mixed tree served by ServeEngine gives the dequantized tree's
    tokens, ReferenceEngine's and the reference's; the engine's ledger
    carries the bits and is below uniform 8-bit residency."""
    jcfg, tcfg, jp, tp, _, _ = lm32
    bits = dict(zip(quantizable_paths(tp), MIXED_BITS))
    prompts = _serving_prompts(tcfg.vocab)
    deq = dequant(quantize_tree(tp, bits=bits), dtype=torch.float32)
    float_out, _ = _serve(ServeEngine, tcfg, deq, prompts, prefill_chunk=4)
    mixed_out, eng = _serve(ServeEngine, tcfg, tp, prompts, quantized=True,
                            quant_bits=bits, prefill_chunk=4)
    ref_out, reng = _serve(ReferenceEngine, tcfg, tp, prompts,
                           quantized=True, quant_bits=bits)
    jeng = JServeEngine(jcfg, jp, max_batch=2, max_context=32, eos_id=-1,
                        quantized=True, quant_bits=bits, prefill_chunk=4)
    jreqs = [JRequest(rid=i, prompt=np.asarray(p, np.int32),
                      max_new_tokens=5) for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    assert mixed_out == float_out == ref_out == [r.out_tokens for r in jreqs]
    assert eng.serving_sheet.bits_by_layer() == bits
    assert eng.serving_sheet.to_dict() == jeng.serving_sheet.to_dict()
    assert reng.serving_sheet.weight_bytes() == \
        eng.serving_sheet.weight_bytes()
    assert eng.serving_sheet.weight_bytes() < serving_ledger(
        tp, bits=8).weight_bytes()
    # the dequantized tree the engine serves is the reference's
    jdeq = jdequant(jquantize_tree(jp, bits=bits), dtype=jnp.float32)
    np.testing.assert_array_equal(
        deq["layers"]["attn"]["wk"].numpy(),
        np.asarray(jdeq["layers"]["attn"]["wk"]))


# ------------------------------------------------------------ the launcher

def test_mixed_bitwidth_launcher_on_cpu(monkeypatch, capsys, tmp_path):
    """``python -m repro_torch.launch.mixed_bitwidth --device cpu --out
    DIR`` at a reduced size: the batched and serial searches agree, the
    mixed tree serves as its dequantized tree does, and the pendigits
    result equals ``mixed_minq_search``'s on the trained weights."""
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               **dict(LM32, vocab=256))
    full = mixed_bitwidth.run_pipeline
    runs = []
    for name, value in dict(get_config=lambda arch: tcfg, SEQ_LEN=64,
                            BATCH=4, BUDGET=1e-4, N_REQUESTS=3,
                            PROMPT_LENS=(4, 12), MAX_NEW=3,
                            SERVE=dict(max_batch=2, max_context=32,
                                       kv_block_size=8, prefill_chunk=8,
                                       prefill_batch=2)).items():
        monkeypatch.setattr(mixed_bitwidth, name, value)
    monkeypatch.setattr(lx, "EPOCHS", 2)
    monkeypatch.setattr(mixed_bitwidth, "run_pipeline",
                        lambda device, out: runs.append(full(device, out))
                        or runs[-1])
    mixed_bitwidth.main(["--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    r = runs[0]
    assert "serial same bits, start and history" in out
    assert mixed_bitwidth.same_search(r.result, r.serial)
    assert r.result.history and r.result.start_bits > 4
    # the float base twice, then the global search's rungs: all four
    # batched, serially down to the first that breaks the budget
    n_cands = sum(len(c) for _, c, _, _ in r.result.history)
    ladder = mixed_bitwidth.BIT_LADDER
    assert r.loss_calls == {
        "search": 2 + len(ladder) + n_cands,
        "serial": 2 + ladder.index(r.result.start_bits) + 2 + n_cands}
    assert r.launches["search"]["flash_attention"] == 0     # CPU: plain
    toks = {k: [q.out_tokens for q in s.requests]
            for k, s in r.served.items()}
    assert toks["mixed"] == toks["dequant"]
    assert all(len(t) == 3 for t in toks["reference"])
    assert torch.equal(r.served["mixed"].first_logits,
                       r.served["dequant"].first_logits)
    assert r.engine.serving_sheet.bits_by_layer() == r.result.bits
    assert r.result.sheet.weight_bytes() <= r.global_ledger.weight_bytes()
    assert (tmp_path / "mixed_sheet.json").exists()
    want = mixed_minq_search(r.pd_train.weights, r.pd_train.biases,
                             lx.ACTIVATIONS, *r.pd_val, device="cpu")
    assert (r.pd.qs, r.pd.ha, r.pd.q_star, r.pd.history) == \
        (want.qs, want.ha, want.q_star, want.history)
    assert r.pd.sheet.to_dict() == want.sheet.to_dict()


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.to("cuda")


def _port_lm32():
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), **LM32)
    return cfg, Model(cfg, device="cpu").init(0)


@pytest.mark.gpu
def test_gpu_mixed_minq_csd_equals_numpy():
    """``mixed_minq_search`` on the card's ``auto`` backend (csd) runs its
    rounds through ``csd_qsweep`` and equals the numpy backend exactly."""
    _needs_card()
    from repro_torch.data import pendigits
    from repro_torch.train.zaal import TrainConfig, train
    from repro_torch.core import quantize_inputs
    ds = pendigits.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    res = train(TrainConfig(structure=(16, 10, 10), epochs=5, seed=3),
                pendigits.to_unit(xtr), ytr, pendigits.to_unit(xval), yval,
                device="cuda")
    x = quantize_inputs(pendigits.to_unit(xval))
    n0 = sum(csd_qsweep_kernel.route_launches.values())
    got = mixed_minq_search(res.weights, res.biases, ACTS, x, yval)
    assert sum(csd_qsweep_kernel.route_launches.values()) > n0
    want = mixed_minq_search(res.weights, res.biases, ACTS, x, yval,
                             backend="numpy", device="cpu")
    assert (got.qs, got.ha, got.q_star, got.history) == \
        (want.qs, want.ha, want.q_star, want.history)
    for a, b in zip(got.mlp.weights + got.mlp.biases,
                    want.mlp.weights + want.mlp.biases):
        np.testing.assert_array_equal(a, b)
    assert got.sheet.to_dict() == dict(want.sheet.to_dict())


@pytest.mark.gpu
def test_gpu_mixed_serving_lm32():
    """lm32 on the card, f32: the mixed tree through the paged K+V gather
    and the fused decode attention gives the dequantized tree's tokens and
    ReferenceEngine's."""
    _needs_card()
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_gather import paged_gather_pair_kernel
    cfg, params = _port_lm32()
    bits = dict(zip(quantizable_paths(params), MIXED_BITS))
    prompts = _serving_prompts(cfg.vocab)
    paged = dict(prefill_chunk=4, kv_block_size=8, kv_gather="cuda",
                 decode_kernel="fused")
    n0 = (paged_gather_pair_kernel.launches, paged_attention_kernel.launches)
    mixed_out, eng = _serve(ServeEngine, cfg, params, prompts, "cuda",
                            quantized=True, quant_bits=bits, **paged)
    assert paged_gather_pair_kernel.launches > n0[0]
    assert paged_attention_kernel.launches > n0[1]
    deq = dequant(quantize_tree(params, bits=bits), dtype=torch.float32)
    float_out, _ = _serve(ServeEngine, cfg, deq, prompts, "cuda", **paged)
    ref_out, _ = _serve(ReferenceEngine, cfg, params, prompts, "cuda",
                        quantized=True, quant_bits=bits)
    assert mixed_out == float_out == ref_out
    assert eng.serving_sheet.bits_by_layer() == bits


@pytest.mark.gpu
def test_gpu_mixed_bitwidth_lm32():
    """The search on lm32 on the card (every loss through the flash
    kernel's f32 route) makes the CPU port's decisions."""
    _needs_card()
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    cfg, params = _port_lm32()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    cpu = Model(cfg, device="cpu")
    want = mixed_bitwidth_search(params, lambda p: cpu.loss(p, batch)[0],
                                 budget=1e-3)
    _assert_far_from_threshold(want, 1e-3)
    card = Model(cfg, device="cuda")
    cparams = _to_cuda(params)
    n0 = flash_attention_kernel.launches
    got = mixed_bitwidth_search(cparams, lambda p: card.loss(p, batch)[0],
                                budget=1e-3)
    assert flash_attention_kernel.launches > n0
    assert (got.bits, got.start_bits) == (want.bits, want.start_bits)
    assert [(r, p, ok, [c[:2] for c in cs]) for r, cs, p, ok in got.history] \
        == [(r, p, ok, [c[:2] for c in cs]) for r, cs, p, ok in want.history]

