"""repro_torch's measured-dispatch autotuner (DESIGN.md 17) on the CPU: the
16 cases of ``test_autotune.py`` ported to ``repro_torch.tune`` -- cache
round trip and self-invalidation, deterministic races under an injected
fake clock, the card-only exclusion rule, decide's hit / miss / fill and
autosave, and every ``auto`` selection point falling back to its static
heuristic on a miss and honouring (without changing results under) a
forced cache pick: the evaluators' backends, the TM chain engine and the
serving decode kernel (tiny f32 model, identical greedy tokens).  Also
``shape_bucket``, ``make_key`` and ``config_hash`` against ``repro.tune``
on a grid of inputs, and a file written by the JAX package loading stale.
On the card (``gpu`` marker) the evaluators' ``auto`` is the kernel
whatever the cache holds."""
import dataclasses
import json

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro import tune as jtune
except ImportError:
    jtune = None
from repro_torch import tune
from repro_torch.core.quantize import quantize_mlp
from repro_torch.eval import BatchedHWEvaluator, Candidate, QSweepEvaluator
from repro_torch.eval.batched import TMStep
from repro_torch.tune.cache import SCHEMA_VERSION, DispatchCache

RNG = np.random.default_rng(7)


# ---------------------------------------------------------------- cache


def test_shape_bucket_and_key():
    assert tune.shape_bucket((1124, 16)) == "2048x16"
    assert tune.shape_bucket((1, 128, 129)) == "1x128x256"
    assert tune.shape_bucket((0, 5)) == "0x8"
    assert tune.make_key("cpu", "op", "2048x16", "int64") == \
        "cpu|op|2048x16|int64"


@pytest.mark.parametrize("shape", [(1124, 16), (1, 128, 129), (0, 5), (),
                                   (2248, 16, 10, 10), (3, 1 << 20, 7)])
def test_keys_equal_the_reference(shape):
    """The port's bucketing, keys and config hashes are the reference's."""
    assert tune.shape_bucket(shape) == jtune.shape_bucket(shape)
    bucket = tune.shape_bucket(shape)
    for plat, op, dt in (("cpu", "bhw_backend", "int64"),
                         ("cuda", "tm_chain", "int64"),
                         ("cuda", "decode_kernel", "")):
        assert tune.make_key(plat, op, bucket, dt) == \
            jtune.make_key(plat, op, bucket, dt)
    for cfg in ({}, {"platform": "cpu"}, {"platform": "cuda", "n": shape}):
        assert tune.config_hash(cfg) == jtune.config_hash(cfg)
    assert SCHEMA_VERSION == jtune.SCHEMA_VERSION


def test_cache_json_round_trip_exact(tmp_path):
    cache = DispatchCache({"platform": "cpu"})
    cache.put("cpu|op|64x16|int64", "numpy",
              timings={"numpy": 0.1 + 0.2, "torch": 1e-7, "csd": None},
              candidates=["numpy", "torch", "csd"])
    cache.put("cpu|tm|8x2|", "host", source="measured")
    path = tmp_path / "cache.json"
    cache.save(str(path))
    back = DispatchCache.load(str(path), config={"platform": "cpu"})
    # exact: entries (including binary64 float timings) survive the trip
    assert back.entries == cache.entries
    assert back.config_hash() == cache.config_hash()
    assert back.entries["cpu|op|64x16|int64"]["timings"]["numpy"] == 0.1 + 0.2


def test_cache_schema_version_invalidation(tmp_path):
    cache = DispatchCache({"platform": "cpu"})
    cache.put("k", "numpy")
    path = tmp_path / "cache.json"
    cache.save(str(path))
    doc = json.loads(path.read_text())
    doc["schema_version"] = SCHEMA_VERSION + 1
    path.write_text(json.dumps(doc))
    back = DispatchCache.load(str(path), config={"platform": "cpu"})
    assert back.entries == {}                  # stale: self-invalidated
    assert back.stats["stale_dropped"] == 1


def test_cache_config_hash_invalidation(tmp_path):
    cache = DispatchCache({"platform": "cuda"})
    cache.put("k", "csd")
    path = tmp_path / "cache.json"
    cache.save(str(path))
    # same schema, different environment: the card's entry must not leak
    # into a cpu session
    back = DispatchCache.load(str(path), config={"platform": "cpu"})
    assert back.entries == {}
    assert back.stats["stale_dropped"] == 1
    # matching config adopts the entries unchanged
    same = DispatchCache.load(str(path), config={"platform": "cuda"})
    assert same.entries == cache.entries


def test_jax_written_file_loads_stale(tmp_path):
    """A cache file written by the JAX package is never trusted: under the
    port's config stamp (platform, torch, CUDA, card) it loads empty."""
    path = tmp_path / "cache.json"
    jcache = jtune.DispatchCache({"platform": "cpu"})
    jcache.put("cpu|qsweep_backend|2048x16|int64", "numpy")
    jcache.save(str(path))
    cfg = tune.default_config()
    assert cfg == {"platform": "cpu", "torch": torch.__version__,
                   "cuda": torch.version.cuda, "device": None}
    back = DispatchCache.load(str(path), config=cfg)
    assert back.entries == {} and back.stats["stale_dropped"] == 1


def test_cache_load_garbage_is_empty(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json")
    assert DispatchCache.load(str(path), config={}).entries == {}
    path.write_text(json.dumps([1, 2, 3]))
    assert DispatchCache.load(str(path), config={}).entries == {}


# ---------------------------------------------------------------- bench


class FakeClock:
    """Scripted monotonic clock: each call returns the next value."""

    def __init__(self, *vals):
        self.vals = list(vals)

    def __call__(self):
        return self.vals.pop(0)


def test_measure_median_with_fake_clock():
    calls = []
    # k=3 timed runs bracketed by (t0, t1) pairs: durations 5, 1, 9
    clock = FakeClock(0, 5, 10, 11, 20, 29)
    t = tune.measure(lambda: calls.append(1), warmup=2, k=3, clock=clock)
    assert t == 5.0                      # median of {5, 1, 9}
    assert len(calls) == 5               # 2 warmup + 3 timed


def test_measure_syncs_around_each_timed_call():
    """On the card the device is synchronised before each clock read, so a
    timing covers finished work."""
    log = []
    clock = FakeClock(0, 1, 2, 3)
    tune.measure(lambda: log.append("run"), warmup=1, k=2, clock=clock,
                 sync=lambda: log.append("sync"))
    assert log == ["run"] + ["sync", "run", "sync"] * 2


def test_race_deterministic_winner_and_tie_break():
    mk = lambda: tune.Thunk(run=lambda: None)  # noqa: E731
    # slow=2s, fast=1s per timed run
    clock = FakeClock(0, 2, 2, 4, 10, 11, 11, 12)
    winner, timings = tune.race({"slow": mk(), "fast": mk()},
                                platform="cpu", warmup=0, k=2, clock=clock)
    assert winner == "fast"
    assert timings == {"slow": 2.0, "fast": 1.0}
    # exact tie: lexicographically first name wins (stable across runs)
    clock = FakeClock(0, 1, 1, 2, 10, 11, 11, 12)
    winner, _ = tune.race({"b": mk(), "a": mk()},
                          platform="cpu", warmup=0, k=2, clock=clock)
    assert winner == "a"


def test_race_excludes_cuda_off_card():
    ran = {"csd": 0, "torch": 0}
    thunks = {
        "csd": tune.Thunk(
            run=lambda: ran.__setitem__("csd", ran["csd"] + 1), cuda=True),
        "torch": tune.Thunk(
            run=lambda: ran.__setitem__("torch", ran["torch"] + 1)),
    }
    clock = FakeClock(*range(100))
    winner, timings = tune.race(thunks, platform="cpu", warmup=0, k=1,
                                clock=clock)
    assert winner == "torch"
    assert timings["csd"] is None        # excluded, never run
    assert ran["csd"] == 0 and ran["torch"] == 1
    # all-excluded race: no winner, so the caller's heuristic stands
    winner, timings = tune.race({"csd": thunks["csd"]},
                                platform="cpu", warmup=0, k=1, clock=clock)
    assert winner is None and timings == {"csd": None}


# -------------------------------------------------------------- dispatch


def test_decide_hit_miss_and_fill():
    cache = DispatchCache({"platform": "cpu"})
    with tune.use_cache(cache, measure=False):
        # miss + disabled -> heuristic, nothing cached
        pick = tune.decide("op", shape=(100, 16), dtype="int64",
                           candidates=("a", "b"), heuristic="b")
        assert pick == "b" and cache.entries == {}
    # hit: the cached winner is used and measure is NEVER invoked
    cache.put("cpu|op|128x16|int64", "a")
    boom = lambda: (_ for _ in ()).throw(AssertionError("measured on hit"))  # noqa: E731
    with tune.use_cache(cache, measure=True):
        pick = tune.decide("op", shape=(100, 16), dtype="int64",
                           candidates=("a", "b"), heuristic="b",
                           plat="cpu", measure=boom)
        assert pick == "a"
        # the card's key is another entry: a cpu winner is not read there
        assert tune.decide("op", shape=(100, 16), dtype="int64",
                           candidates=("a", "b"), heuristic="b",
                           plat="cuda") == "b"
    # a cached winner outside the candidate set is ignored (stale entry
    # from an older candidate grid): heuristic fallback
    with tune.use_cache(cache, measure=False):
        pick = tune.decide("op", shape=(100, 16), dtype="int64",
                           candidates=("b", "c"), heuristic="c",
                           plat="cpu")
        assert pick == "c"
    # miss + enabled + measure -> race fills the cache
    cache2 = DispatchCache({"platform": "cpu"})
    mk = lambda: {"a": tune.Thunk(run=lambda: None),  # noqa: E731
                  "b": tune.Thunk(run=lambda: None, cuda=True)}
    with tune.use_cache(cache2, measure=True):
        pick = tune.decide("op", shape=(100, 16), dtype="int64",
                           candidates=("a", "b"), heuristic="b",
                           plat="cpu", measure=mk)
    assert pick == "a"
    rec = cache2.entries["cpu|op|128x16|int64"]
    assert rec["winner"] == "a" and rec["timings"]["b"] is None


def test_decide_autosave_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "tunecache.json"
    monkeypatch.setenv(tune.ENV_CACHE, str(path))
    monkeypatch.setenv(tune.ENV_ENABLED, "1")
    tune.set_cache(None)                 # force a reload from the env path
    tune.set_enabled(None)
    try:
        pick = tune.decide(
            "op", shape=(8,), candidates=("x", "y"), heuristic="y",
            measure=lambda: {"x": tune.Thunk(run=lambda: None)})
        assert pick == "x"
        assert path.exists()
        doc = json.loads(path.read_text())
        assert any(v["winner"] == "x" for v in doc["entries"].values())
        # a fresh session with the same env adopts the persisted winner
        tune.set_cache(None)
        assert tune.decide("op", shape=(8,), candidates=("x", "y"),
                           heuristic="y") == "x"
    finally:
        tune.set_cache(None)
        tune.set_enabled(None)


# ------------------------------- selection points: miss == old heuristic


def _pendigits_like(n=96, k=16):
    x = RNG.integers(0, 101, (n, k)).astype(np.int64)
    y = RNG.integers(0, 10, (n,)).astype(np.int64)
    return x, y


def _small_mlp(k=16, h=8, c=10, q=4):
    ws = [RNG.standard_normal((k, h)) * 0.3, RNG.standard_normal((h, c)) * 0.3]
    bs = [RNG.standard_normal((h,)) * 0.1, RNG.standard_normal((c,)) * 0.1]
    return quantize_mlp(ws, bs, ("htanh", "hsig"), q)


def _forced(op, shape, dtype, winner, plat="cpu"):
    cache = DispatchCache({"platform": plat})
    cache.put(tune.make_key(plat, op, tune.shape_bucket(shape), dtype),
              winner)
    return cache


def test_qsweep_auto_miss_matches_heuristic_and_forced_pick():
    x, y = _pendigits_like()
    with tune.use_cache(DispatchCache(), measure=False):
        ev = QSweepEvaluator(x, y, device="cpu")
        assert ev.backend == "numpy"     # empty cache -> today's static rule
    # forced pick: a cache entry overrides the heuristic...
    forced = _forced("qsweep_backend", x.shape, "int64", "torch")
    with tune.use_cache(forced, measure=False):
        ev_t = QSweepEvaluator(x, y, device="cpu")
        assert ev_t.backend == "torch"
    # ...and a card's entry is not read by a CPU evaluator
    with tune.use_cache(_forced("qsweep_backend", x.shape, "int64", "torch",
                                plat="cuda"), measure=False):
        assert QSweepEvaluator(x, y, device="cpu").backend == "numpy"
    # ...and cannot change results (the bit-identical-candidates contract)
    mlps = [_small_mlp(q=q) for q in (3, 4, 5)]
    ev_ref = QSweepEvaluator(x, y, backend="numpy", device="cpu")
    assert ev_t.evaluate(mlps) == ev_ref.evaluate(mlps)


def test_bhw_auto_miss_matches_heuristic_and_forced_pick():
    x, y = _pendigits_like()
    mlp = _small_mlp()
    with tune.use_cache(DispatchCache(), measure=False):
        ev = BatchedHWEvaluator(mlp, x, y, device="cpu")
        assert ev.backend == "torch"
    forced = _forced("bhw_backend", x.shape, "int64", "numpy")
    with tune.use_cache(forced, measure=False):
        ev_np = BatchedHWEvaluator(mlp, x, y, device="cpu")
        assert ev_np.backend == "numpy"
    cands = [Candidate(layer=0, col=j, row=i,
                       wnew=int(mlp.weights[0][i, j]) - 1)
             for i in range(4) for j in range(4)]
    ev_ref = BatchedHWEvaluator(mlp, x, y, backend="torch", device="cpu")
    assert ev_np.evaluate(cands) == ev_ref.evaluate(cands)


def test_backend_race_fills_on_cpu():
    """Measure-and-fill on the CPU: the race is between the host backends
    (``csd``, the card's kernel, is no entrant), so a CPU winner is numpy
    or torch; the result is unchanged."""
    x, y = _pendigits_like()
    mlp = _small_mlp()
    cache = DispatchCache({"platform": "cpu"})
    with tune.use_cache(cache, measure=True):
        ev = BatchedHWEvaluator(mlp, x, y, device="cpu")
        sweep = QSweepEvaluator(x, y, device="cpu")
    recs = {key.split("|")[1]: rec for key, rec in cache.entries.items()}
    assert set(recs) == {"bhw_backend", "qsweep_backend"}
    for rec in recs.values():
        assert set(rec["timings"]) == {"numpy", "torch"}
        assert rec["winner"] in ("numpy", "torch")
    assert (ev.backend, sweep.backend) == (recs["bhw_backend"]["winner"],
                                           recs["qsweep_backend"]["winner"])
    mlps = [_small_mlp(q=q) for q in (3, 4)]
    assert sweep.evaluate(mlps) == QSweepEvaluator(
        x, y, backend="numpy", device="cpu").evaluate(mlps)


def test_tm_chain_auto_miss_matches_heuristic_and_forced_pick():
    x, y = _pendigits_like()
    mlp = _small_mlp()
    ev = BatchedHWEvaluator(mlp, x, y, backend="torch", device="cpu")
    w0 = np.asarray(mlp.weights[0])
    steps = [TMStep(layer=0, col=j, row=i,
                    pws=(int(w0[i, j]) + 1, int(w0[i, j]) - 1),
                    dbs=(-1, 1))
             for i in range(3) for j in range(3)]
    bha = ev.accuracy()
    host = ev.evaluate_tm_chain(steps, bha, engine="host")
    with tune.use_cache(DispatchCache(), measure=False):
        auto = ev.evaluate_tm_chain(steps, bha)   # miss -> _chain_scan rule
    assert auto == host
    forced = _forced("tm_chain", (ev.n_val, len(steps)), "int64", "device")
    n0 = ev.stats["candidates"]
    with tune.use_cache(forced, measure=False):
        dev = ev.evaluate_tm_chain(steps, bha)    # forced device engine
    assert dev == host                   # bit-identical decisions
    # the device engine's count: every nudge of a failed pair
    assert ev.stats["candidates"] - n0 == sum(
        len(s.pws) + (0 if ok and not db else len(s.dbs))
        for s, (ok, _pw, db, _ha) in zip(steps, dev))
    # a race on the CPU admits the device entrant (its plain version is
    # what that engine runs here) and fills the cache
    cache = DispatchCache({"platform": "cpu"})
    with tune.use_cache(cache, measure=True):
        assert ev.evaluate_tm_chain(steps, bha) == host
    (rec,) = cache.entries.values()
    assert set(rec["timings"]) == {"host", "device"}


@pytest.mark.parametrize("backends", [("numpy",), ("torch",),
                                      ("numpy", "torch")])
def test_backend_thunks_race_the_host_backends(backends):
    """The backend factories build one host evaluator an entrant, none of
    them card-only, and each entrant scores its batch."""
    x, y = _pendigits_like()
    mlp = _small_mlp()
    for thunks in (tune.qsweep_backend_thunks(x, y, backends=backends),
                   tune.bhw_backend_thunks(mlp, x, y, backends=backends,
                                           n_cands=8)):
        assert tuple(thunks) == backends
        assert not any(t.cuda for t in thunks.values())
        for t in thunks.values():
            t.run()
    assert tune.qsweep_backend_thunks.__kwdefaults__["backends"] == \
        tune.bhw_backend_thunks.__kwdefaults__["backends"] == \
        ("numpy", "torch")


@pytest.fixture(scope="module")
def tiny_lm():
    from repro_torch.nn import Model, get_config
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              n_layers=1, vocab=64, remat=False,
                              dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    return cfg, params


def test_decode_kernel_auto_resolution(tiny_lm):
    from repro_torch.runtime.serve import ServeEngine
    cfg, params = tiny_lm
    with tune.use_cache(DispatchCache(), measure=False):
        # no block pool: only the gather+dense route exists
        eng = ServeEngine(cfg, params, max_batch=2, max_context=32,
                          decode_kernel="auto", device="cpu")
        assert eng.decode_kernel == "dense"
        # block pool + empty cache: the static "dense" heuristic
        eng = ServeEngine(cfg, params, max_batch=2, max_context=32,
                          kv_block_size=8, decode_kernel="auto",
                          device="cpu")
        assert eng.decode_kernel == "dense"
    forced = _forced("decode_kernel", (2, 32, 8), str(cfg.dtype), "fused")
    with tune.use_cache(forced, measure=False):
        eng = ServeEngine(cfg, params, max_batch=2, max_context=32,
                          kv_block_size=8, decode_kernel="auto",
                          device="cpu")
        assert eng.decode_kernel == "fused"
    # bf16: "fused" is no candidate, so no cache entry can pick it
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    with tune.use_cache(_forced("decode_kernel", (2, 32, 8), "bfloat16",
                                "fused"), measure=False):
        eng = ServeEngine(bf, params, max_batch=2, max_context=32,
                          kv_block_size=8, decode_kernel="auto",
                          device="cpu")
        assert eng.decode_kernel == "dense"


def test_decode_kernel_race_leaves_fused_out_off_card(tiny_lm):
    """``decode_kernel_thunks``: dense and fused engines on a short greedy
    run; off the card the fused kernel's entrant is left out, so a race
    there picks "dense"."""
    cfg, params = tiny_lm
    thunks = tune.decode_kernel_thunks(cfg, params, kv_block_size=8,
                                       max_context=32, n_tokens=2,
                                       device="cpu")
    assert (thunks["dense"].cuda, thunks["fused"].cuda) == (False, True)
    winner, timings = tune.race(thunks, platform="cpu", warmup=0, k=1)
    assert winner == "dense" and timings["fused"] is None


def test_decode_kernel_forced_pick_token_parity(tiny_lm):
    from repro_torch.runtime.serve import Request, ServeEngine
    cfg, params = tiny_lm
    prompt = np.arange(1, 7, dtype=np.int32)

    def run(kernel_cache):
        with tune.use_cache(kernel_cache, measure=False):
            eng = ServeEngine(cfg, params, max_batch=2, max_context=32,
                              eos_id=-1, prefill_chunk=8, kv_block_size=8,
                              decode_kernel="auto", admission="truncate",
                              device="cpu")
        req = Request(rid=0, prompt=prompt, max_new_tokens=4)
        eng.run([req])
        return eng.decode_kernel, list(req.out_tokens)

    k_dense, toks_dense = run(DispatchCache())
    k_fused, toks_fused = run(_forced("decode_kernel", (2, 32, 8),
                                      str(cfg.dtype), "fused"))
    assert (k_dense, k_fused) == ("dense", "fused")
    # the decision-parity contract: a cache swap can never change tokens
    assert toks_dense == toks_fused


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
def test_gpu_auto_backends_are_the_kernel():
    """On a CUDA evaluator ``auto`` is ``csd`` whatever the cache holds for
    the card: the card's kernel is the one candidate there, and no race
    is run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    x, y = _pendigits_like()
    mlp = _small_mlp()
    for pick in ("numpy", "torch"):
        cache = DispatchCache({"platform": "cuda"})
        for op in ("bhw_backend", "qsweep_backend"):
            cache.put(tune.make_key("cuda", op, tune.shape_bucket(x.shape),
                                    "int64"), pick)
        with tune.use_cache(cache, measure=True):
            assert BatchedHWEvaluator(mlp, x, y).backend == "csd"
            assert QSweepEvaluator(x, y).backend == "csd"
        assert len(cache.entries) == 2
