"""repro_torch's training path against the JAX package on the CPU.

``Model.loss`` and every leaf of its gradient against
``jax.value_and_grad`` of the reference's (f32 within 1e-5 of each leaf's
largest magnitude, remat on and off; bf16 within 2e-2), with every norm and
QKV bias seeded (the reference zeros them, which would hide a swapped
leaf); ``AdamW`` (f32 and bf16 state), ``Sgd``, ``clip_by_global_norm``
and ``cosine_schedule`` over 3 steps; ``pot_compressor`` with the two
deliberate differences pinned; ``make_train_step`` with and without the
compressor after 3 steps against the reference's jitted step; the mirrors
of ``tests/test_runtime_ckpt.py`` and of ``test_loss_decreases_tiny_train``;
checkpoints across the two packages; the launcher; scoring calls build no
graph.  The card's training path is in ``chip_smoke.py`` (phase 15) and
``tests/test_torch_flash_backward.py``."""
import dataclasses
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle
    import jax
    import jax.numpy as jnp
    from repro.ckpt import CheckpointManager as JCheckpointManager
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.optim import adamw as jadamw
    from repro.optim import compress as jcompress
    from repro.runtime.step import make_train_step as jmake_train_step
except ImportError:
    jax = None
from repro_torch.ckpt import CheckpointManager
from repro_torch.data.tokens import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.optim.adamw import (AdamW, Sgd, clip_by_global_norm,
                                     cosine_schedule)
from repro_torch.optim.compress import pot_compressor, pot_quantize_dequantize
from repro_torch.runtime.step import make_train_step
from repro_torch.runtime.train import TrainConfig, TrainLoop
from repro_torch.tree import flatten_with_path, leaves, tree_map

REL = 1e-5          # f32: the same graph summed in another order


def _cfgs(**kw):
    kw = dict(dict(n_layers=2, vocab=64), **kw)
    return (dataclasses.replace(jget_config("qwen2-0.5b").reduced(), **kw),
            dataclasses.replace(get_config("qwen2-0.5b").reduced(), **kw))


def _seeded(jtree, seed=0):
    """The reference's init as numpy, every norm and QKV bias drawn from
    a seeded generator (the reference zeros them)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
            elif key.startswith("ln") or key.endswith("norm") \
                    or key in ("bq", "bk", "bv"):
                out[key] = rng.normal(0, 0.3, val.shape).astype(np.float32)
            else:
                out[key] = np.asarray(val)
        return out
    return walk(jax.tree.map(np.asarray, jtree))


def _both(cfgs, seed=0):
    """The same parameters in both packages: (jax tree, torch tree)."""
    jcfg, _ = cfgs
    npp = _seeded(JModel(jcfg).init(jax.random.PRNGKey(seed)), seed)
    return (jax.tree.map(jnp.asarray, npp),
            params_from_jax(npp, device="cpu"))


def _batch(vocab=64, seq=32, batch=4, step=0):
    return TokenPipeline(vocab=vocab, seq_len=seq,
                         global_batch=batch).batch(step)


def _assert_tree_close(got, want, rel):
    """Every leaf of ``got`` (torch) within ``rel`` of the largest
    magnitude of the matching leaf of ``want`` (numpy-able)."""
    want = dict(flatten_with_path(jax.tree.map(np.asarray, want)))
    for path, g in flatten_with_path(got):
        w = want[path]
        g = g.detach().float().numpy()
        assert g.shape == w.shape, path
        err = np.abs(g - w.astype(np.float32)).max()
        assert err <= rel * max(np.abs(w).max(), 1e-30), (path, err)


# ------------------------------------------------------------ loss + grads

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradient_match_jax(remat):
    """f32 loss within 1e-5 relative and every gradient leaf within 1e-5
    of its largest magnitude, with and without per-layer remat."""
    cfgs = _cfgs(dtype="float32", remat=remat)
    jp, tp = _both(cfgs)
    batch = _batch()
    (jl, jmet), jg = jax.value_and_grad(JModel(cfgs[0]).loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.requires_grad_(), tp)
    tl, tmet = Model(cfgs[1], device="cpu").loss(live, batch)
    tg = torch.autograd.grad(tl, leaves(live))
    assert abs(float(tl.detach()) - float(jl)) <= REL * abs(float(jl))
    assert float(tmet["xent"].detach()) == pytest.approx(float(jmet["xent"]), rel=REL)
    _assert_tree_close(_regrow(live, tg), jg, REL)


def _regrow(like, values):
    it = iter(values)
    return tree_map(lambda _: next(it), like)


def test_bf16_loss_and_gradient_match_jax():
    """bf16 activations on f32 masters (the configs' default): loss within
    2e-2 relative; each gradient leaf's largest difference within 2^-3 of
    its largest magnitude and its mean difference within 2^-4 of its mean
    magnitude.  PyTorch rounds to bf16 after every op, XLA at its fusions'
    outputs, so the gradients part by 1-3.4 % of their largest magnitude
    (0.7-2.6 % in the mean) at seeds 1-3; a wrong gradient path parts them
    by orders of magnitude more."""
    cfgs = _cfgs(remat=True)
    assert cfgs[1].dtype == "bfloat16"
    jp, tp = _both(cfgs, seed=1)
    batch = _batch(step=1)
    (jl, _), jg = jax.value_and_grad(JModel(cfgs[0]).loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.requires_grad_(), tp)
    tl, _ = Model(cfgs[1], device="cpu").loss(live, batch)
    tg = torch.autograd.grad(tl, leaves(live))
    assert abs(float(tl.detach()) - float(jl)) <= 2e-2 * abs(float(jl))
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jg)))
    for (path, _), g in zip(flatten_with_path(live), tg):
        err = np.abs(g.float().numpy() - want[path])
        w = np.abs(want[path])
        assert err.max() <= 2 ** -3 * w.max(), path
        assert err.mean() <= 2 ** -4 * w.mean(), path


def test_scoring_builds_no_graph():
    """Parameters that require no gradient (the PTQ searches' and
    serving_ledger's) give a loss with no graph, remat on or off, and a
    search's loss calls build none either."""
    from repro_torch.quant import min_bitwidth_search
    for remat in (False, True):
        cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                  n_layers=2, vocab=64, remat=remat)
        m = Model(cfg, device="cpu")
        params = m.init(0)
        loss, mets = m.loss(params, _batch())
        assert loss.grad_fn is None and not loss.requires_grad
        assert mets["xent"].grad_fn is None
    seen = []

    def eval_fn(tree):
        loss = m.loss(tree, _batch())[0]
        seen.append(loss.grad_fn)
        return float(loss)
    min_bitwidth_search(params, eval_fn, budget=0.01, engine="serial")
    assert seen and all(g is None for g in seen)


# --------------------------------------------------------------- optimizers

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 8), "b": (8,), "stack": {"u": (2, 3, 5)}}
    return jax.tree.map(lambda s: rng.normal(0, 1, s).astype(np.float32),
                        shapes, is_leaf=lambda s: isinstance(s, tuple))


def _run_both(jopt, topt, steps=3):
    p = _opt_trees(0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _opt_trees(10 + i)
        jp, js = jopt.apply(jp, js, jax.tree.map(jnp.asarray, g))
        tp, ts = topt.apply(tp, ts, tree_map(torch.from_numpy, g))
    return jp, js, tp, ts


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_jax(state_dtype, schedule):
    """3 AdamW steps: params within 1e-6 of their largest magnitude,
    moments within 1e-6 (f32) or one bf16 ulp (bf16 state), count equal."""
    kw = dict(lr=1e-2, state_dtype=state_dtype)
    jopt = jadamw.AdamW(**kw, schedule=jadamw.cosine_schedule(1e-2, 2, 10)
                        if schedule else None)
    topt = AdamW(**kw, schedule=cosine_schedule(1e-2, 2, 10)
                 if schedule else None)
    jp, js, tp, ts = _run_both(jopt, topt)
    _assert_tree_close(tp, jp, 1e-6)
    rel = 1e-6 if state_dtype == "float32" else 2 ** -8
    for key in ("m", "v"):
        assert all(t.dtype == getattr(torch, state_dtype)
                   for t in leaves(ts[key]))
        _assert_tree_close(ts[key], js[key], rel)
    assert int(ts["count"]) == int(js["count"]) == 3


def test_sgd_matches_jax():
    jp, js, tp, ts = _run_both(jadamw.Sgd(lr=1e-2, momentum=0.9),
                               Sgd(lr=1e-2, momentum=0.9))
    _assert_tree_close(tp, jp, 1e-6)
    _assert_tree_close(ts["mom"], js["mom"], 1e-6)
    assert int(ts["count"]) == int(js["count"]) == 3


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _opt_trees(3)
    jg, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                        max_norm)
    tg, tn = clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    _assert_tree_close(tg, jg, 1e-6)


def test_cosine_schedule_matches_jax():
    j, t = jadamw.cosine_schedule(3e-4, 5, 20), cosine_schedule(3e-4, 5, 20)
    for step in range(25):
        assert float(t(step)) == pytest.approx(float(j(step)), rel=1e-6,
                                               abs=1e-12)


# --------------------------------------------------------------- compressor

def _oracle(g, bits=8):
    """The compressor's numbers exactly: e = floor(log2(qmax / amax)) of
    the f32 quotient, scales 2^e and 2^-e exact."""
    qmax = 2.0 ** (bits - 1) - 1
    y = np.float32(qmax) / np.float32(np.abs(g).max())
    e = int(np.floor(np.log2(np.float64(y))))
    q = np.clip(np.round(g.astype(np.float64) * 2.0 ** e), -qmax - 1, qmax)
    return (q * 2.0 ** -e).astype(np.float32), e


@pytest.mark.parametrize("e", [12, 13, 14])
def test_pot_compressor_exact_and_against_jax(e):
    """The port equals the exact oracle at every exponent; the reference
    equals it where XLA's CPU exp2(+-e) is exact (e = 12, 14) and misses
    it at e = 13, where exp2 is inexact (the deliberate difference): its
    values off by ~5e-7 relative, and a few moved a whole quantization
    step (2^-13) where the inexact scale crosses a rounding boundary."""
    rng = np.random.default_rng(e)
    g = rng.normal(0, 1, (256, 64)).astype(np.float32)
    g *= np.float32(127 * 0.75 / 2.0 ** e / np.abs(g).max())
    want, e_want = _oracle(g)
    assert e_want == e
    got = pot_quantize_dequantize(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = np.asarray(jcompress.pot_quantize_dequantize(jnp.asarray(g)))
    if e == 13:
        assert float(jnp.exp2(jnp.float32(13))) != 8192.0
        assert not np.array_equal(ref, want)
        off = np.abs(ref - want)
        assert off.max() <= 2.0 ** -13
        assert np.mean(off > 1e-6 * np.abs(want)) < 0.01
    else:
        np.testing.assert_array_equal(ref, want)


def test_pot_compressor_frexp_exponent_pinned():
    """qmax / amax an exact power of two (8192): the port's frexp reads
    e = 13, the reference's XLA CPU log2 gives 12.99999 and floors to 12,
    so it quantizes on a grid twice as coarse."""
    q = np.random.default_rng(5).integers(-127, 128, 4096)
    q[0] = 127
    g = (q / 8192).astype(np.float32)            # on the 2^-13 grid
    assert np.float32(127) / np.abs(g).max() == 8192
    got = pot_quantize_dequantize(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, _oracle(g)[0])
    np.testing.assert_array_equal(got, g)        # e = 13: exact
    ref = np.asarray(jcompress.pot_quantize_dequantize(jnp.asarray(g)))
    assert float(jnp.floor(jnp.log2(jnp.float32(8192)))) == 12
    np.testing.assert_array_equal(
        ref, np.clip(np.round(q / 2), -128, 127) / 4096)    # e = 12


def test_pot_compressor_numerics_and_passthrough():
    """The reference test's bounds: int8 on a PoT scale within 2 % of the
    largest magnitude, and tensors below min_size pass through."""
    g = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.01, (256, 64)).astype(np.float32))
    gq = pot_quantize_dequantize(g)
    assert float((gq - g).abs().max() / g.abs().max()) < 0.02
    out = pot_compressor(min_size=10 ** 9)({"g": g})
    assert out["g"] is g
    tree = pot_compressor()({"big": g, "small": g[:2, :2]})
    assert torch.equal(tree["big"], gq) and tree["small"] is not None
    assert torch.equal(tree["small"], g[:2, :2])


# --------------------------------------------------------------- train step

@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_jax(compress):
    """make_train_step against the reference's jitted step over 3 steps
    (AdamW, clip 1.0; f32, seeded norms and biases): loss, grad norm and
    xent within 1e-5 relative each step, and each leaf's update (params
    after the 3 steps less before) within 2^-6 of its largest element.
    Adam's m / sqrt(v) turns an f32 difference in a gradient element near
    0 into a visible one in its update: 3.4e-3 of the largest at most here,
    with and without the compressor, whose exp2 the reference computes
    inexactly at e = 13 (see below)."""
    cfgs = _cfgs(dtype="float32")
    jp, tp = _both(cfgs, seed=2)
    before = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    jopt, topt = jadamw.AdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jmake_train_step(
        JModel(cfgs[0]), jopt,
        compressor=jcompress.pot_compressor() if compress else None))
    tstep = make_train_step(Model(cfgs[1], device="cpu"), topt,
                            compressor=pot_compressor() if compress
                            else None)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        batch = _batch(step=i)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, batch)
        for key in ("loss", "grad_norm", "xent"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=REL)
    after = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    for path, t in flatten_with_path(tp):
        want = after[path] - before[path]
        err = np.abs(t.numpy() - before[path] - want).max()
        assert err <= 2 ** -6 * np.abs(want).max(), path
    assert not any(p.requires_grad for p in leaves(tp))


def test_loss_decreases_tiny_train():
    """The mirror of tests/test_models.py's: 60 AdamW steps on the reduced
    qwen2-0.5b (vocab 64) lower the synthetic LM loss by more than 0.5."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), vocab=64)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    opt = AdamW(lr=3e-3)
    state = opt.init(params)
    step = make_train_step(m, opt)
    pipe = TokenPipeline(vocab=64, seq_len=32, global_batch=8)
    losses = []
    for i in range(60):
        params, state, mets = step(params, state, pipe.batch(i))
        losses.append(float(mets["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]


# ---------------------------------------------- the loop and checkpoints

@pytest.fixture()
def tiny():
    """The reference test's fixture: qwen2-0.5b reduced, 2 layers, vocab
    64, AdamW(1e-3), 4 x 16 batches."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              n_layers=2, vocab=64)
    m = Model(cfg, device="cpu")
    params = m.init(0)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    step = make_train_step(m, opt)
    pipe = TokenPipeline(vocab=64, seq_len=16, global_batch=4)
    return params, state, step, pipe


def _clone(tree):
    """A copy: the step updates its trees in place."""
    return tree_map(torch.clone, tree)


def test_restart_reproduces_uninterrupted_run(tiny, tmp_path):
    """A failure injected at step 9 (checkpoints every 4 steps) restores
    step 8 and replays: every final leaf equal to the uninterrupted run's,
    params and optimizer state."""
    params, state, step, pipe = tiny
    cfg = TrainConfig(total_steps=12, ckpt_every=4,
                      ckpt_dir=str(tmp_path / "a"), log_every=50)
    p1, o1 = TrainLoop(cfg, step, pipe).run(_clone(params), _clone(state))
    boom = {"armed": True}

    def failure_hook(s):
        if s == 9 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    cfg2 = dataclasses.replace(cfg, ckpt_dir=str(tmp_path / "b"))
    loop = TrainLoop(cfg2, step, pipe, failure_hook=failure_hook)
    p2, o2 = loop.run(_clone(params), _clone(state))
    assert loop.restarts == 1
    assert {"step": 9, "event": "restart after RuntimeError"} in \
        loop.metrics_log
    for a, b in zip(leaves({"p": p1, "o": o1}), leaves({"p": p2, "o": o2})):
        assert torch.equal(a, b)


def test_checkpoint_atomic_and_pruned(tiny, tmp_path):
    params, _, _, _ = tiny
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"params": params})
    assert mgr.all_steps() == [3, 4]
    assert not glob.glob(str(tmp_path / "*.tmp"))
    restored, step, _ = mgr.restore({"params": params})
    assert step == 4
    for a, b in zip(leaves(restored), leaves({"params": params})):
        assert torch.equal(a, b)


def test_checkpoint_corruption_detected(tiny, tmp_path):
    params, _, _, _ = tiny
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(1, {"params": {"embed": params["embed"]}})
    victim = glob.glob(str(tmp_path / "step_1" / "*.npy"))[0]
    arr = np.load(victim)
    np.save(victim, arr.ravel()[: arr.size // 2])   # truncate
    with pytest.raises(IOError):
        mgr.restore({"params": {"embed": params["embed"]}})


def test_async_save_then_restore(tiny, tmp_path):
    """The host copy is taken before save returns: an in-place update right
    after an async save does not reach the checkpoint."""
    params, _, _, _ = tiny
    mgr = CheckpointManager(str(tmp_path))
    want = params["embed"].clone()
    mgr.save(7, {"p": params}, blocking=False)
    params["embed"].add_(1.0)
    mgr.wait()
    restored, step, _ = mgr.restore({"p": params})
    assert step == 7
    assert torch.equal(restored["p"]["embed"], want)


def test_restore_onto_a_device(tiny, tmp_path):
    """The reference's elastic restore takes a sharding; the port's takes
    the device to place every leaf on."""
    params, _, _, _ = tiny
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"p": {"w": params["embed"]}})
    restored, _, _ = mgr.restore({"p": {"w": params["embed"]}},
                                 shardings=torch.device("cpu"))
    assert restored["p"]["w"].device == torch.device("cpu")
    assert torch.equal(restored["p"]["w"], params["embed"])


def test_straggler_detection(tiny, tmp_path):
    """A step made slower than 3x the median is reported.  The injected
    delay is 1 s plus 4x the slowest of steps 1-8, so it stands out however
    loaded the machine running the test is."""
    params, state, step, pipe = tiny
    slow = {"hit": []}
    seen = {"last": None, "longest": 0.0}

    def failure_hook(s):          # the hook injects the latency
        now = time.perf_counter()
        if s >= 2:                # the time since the last call: step s - 1
            seen["longest"] = max(seen["longest"], now - seen["last"])
        seen["last"] = now
        if s == 10:
            time.sleep(1.0 + 4 * seen["longest"])

    cfg = TrainConfig(total_steps=13, ckpt_every=100,
                      ckpt_dir=str(tmp_path), straggler_factor=3.0,
                      log_every=50)
    loop = TrainLoop(cfg, step, pipe, failure_hook=failure_hook,
                     on_straggler=lambda s, dt, med: slow["hit"].append(s))
    loop.run(params, state)
    assert 10 in slow["hit"]
    assert any(s == 10 for s, _, _ in loop.straggler_steps)


def test_checkpoints_move_between_packages(tmp_path):
    """An f32 checkpoint of {params, AdamW state} written by the reference
    restores in the port bit for bit, keys and all, and the port's restores
    in the reference."""
    cfgs = _cfgs(dtype="float32")
    jp, tp = _both(cfgs, seed=3)
    jstate = {"params": jp, "opt": jadamw.AdamW().init(jp)}
    tstate = {"params": tp, "opt": AdamW().init(tp)}
    JCheckpointManager(str(tmp_path / "j")).save(5, jstate, extra={"a": 1})
    got, step, extra = CheckpointManager(str(tmp_path / "j")).restore(tstate)
    assert step == 5 and extra == {"a": 1}
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jstate)))
    assert set(want) == set(dict(flatten_with_path(got)))
    for path, t in flatten_with_path(got):
        np.testing.assert_array_equal(t.numpy(), want[path])
        assert t.numpy().dtype == want[path].dtype
    CheckpointManager(str(tmp_path / "t")).save(6, tstate)
    back, step, _ = JCheckpointManager(str(tmp_path / "t")).restore(jstate)
    assert step == 6
    mine = dict(flatten_with_path(tstate))
    for path, a in flatten_with_path(jax.tree.map(np.asarray, back)):
        np.testing.assert_array_equal(a, mine[path].numpy())
    names = sorted(os.listdir(tmp_path / "t" / "step_6"))
    assert names == sorted(os.listdir(tmp_path / "j" / "step_5"))


def test_bf16_leaves_round_trip(tmp_path):
    """bf16 leaves (arctic's moments) are stored as 2-byte words with
    dtype "bfloat16" in the manifest and come back bit for bit."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        0, 1, (3, 5)).astype(np.float32)).bfloat16()
    state = {"m": x, "count": torch.tensor(3, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    with open(tmp_path / "step_2" / "manifest.json") as f:
        meta = json.load(f)["leaves"]
    assert meta["m"] == {"shape": [3, 5], "dtype": "bfloat16", "nbytes": 30}
    assert meta["count"]["dtype"] == "int32"
    got, _, _ = mgr.restore(state)
    assert got["m"].dtype == torch.bfloat16
    assert torch.equal(got["m"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(got["count"], state["count"])


# ---------------------------------------------------------------- launcher

@pytest.mark.parametrize("compress", [False, True])
def test_launcher_trains_on_the_cpu(tmp_path, compress):
    """``python -m repro_torch.launch.train --arch qwen2-0.5b --reduced
    --device cpu``: 3 steps, a record a step, a final checkpoint."""
    argv = ["--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "32", "--log-every",
            "1", "--ckpt-dir", str(tmp_path)]
    loop = launch_train.main(argv + (["--compress-grads"] if compress
                                     else []))
    assert [r["step"] for r in loop.metrics_log] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in loop.metrics_log)
    assert CheckpointManager(str(tmp_path)).latest_step() == 2


def test_launcher_refuses_meshes():
    with pytest.raises(NotImplementedError, match="item 10"):
        launch_train.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                           "cpu", "--mesh", "pod"])
