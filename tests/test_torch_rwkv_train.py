"""RWKV6 training (``ssm``: rwkv6-3b) in repro_torch against the JAX package
on the CPU, on the reduced config (4 layers, d_model 64, heads of 16).  The
reference's init sets ``u = 0``, ``mu = cm_mu = 0.5``, ``ln_x = 0`` and
``w0 = -6`` everywhere: a zero u hides the bonus terms of dr, dk and dv, one
decay for every channel hides a dw on the wrong axis.  So the parameters
are the reference's init with those five leaves drawn from a seeded
generator (as ``tests/test_torch_rwkv.py`` does), carried across with
``params_from_jax``.  ``rms_norm`` over a small wkv output magnifies its
gradient (|du| is ~1000x the matrix leaves'), so each leaf is held against
its own largest magnitude.

- ``wkv6_bwd_plain`` within 1e-5 of each gradient's largest magnitude of
  autograd through ``wkv6_plain``, from a nonzero state and a nonzero
  final-state gradient, S = 1 among the shapes;
- the kernel's two passes in plain PyTorch (``wkv6_bwd_twopass_plain``:
  the gradient of log w as a reverse running sum, no rebuilt state)
  within ``WKV_BWD_TOL`` of ``wkv6_bwd_plain`` at S = 1024, d(log w)
  against w dw, also where w underflows to 0; its dv and ds0 the forward
  recurrence run backward in time; ``_rwkv_proj``'s w the bits of
  exp(-exp(dd)), and the model's gradient where w is 0;
- ``Model.loss`` and every gradient leaf, f32, remat on and off, against
  ``jax.value_and_grad`` of the reference's, within ``GRAD_TOL``; bf16
  within the bounds ``tests/test_torch_train.py`` states;
- one AdamW step through ``make_train_step`` against the reference's
  jitted step; the launcher trains ``--arch rwkv6-3b --reduced``.

The ``gpu`` tests (they skip without a card) hold the backward kernel
against ``wkv6_bwd_plain`` (the gradient of log w against w dw) at every
hd, S in {1, 16, 37, 1024}, f32 and bf16 r, k, v, views off 16 bytes, w
underflowing to 0, within ``WKV_BWD_TOL`` of each gradient's largest
magnitude; repeats bit-identical; one count a call; ``ops.wkv6`` under
grad on the card through both kernels on log w and never a plain version,
a gradient through w given without log w refused, one through r alone
with w given served; the library's tiling; a reduced rwkv6's gradient
card against CPU."""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.optim import adamw as jadamw
    from repro.runtime.step import make_train_step as jmake_train_step
except ImportError:
    jax = None
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.step import make_train_step
from repro_torch.tree import flatten_with_path, leaves, tree_map

wkv6_mod = importlib.import_module("repro_torch.kernels.wkv6")

ARCH = "rwkv6-3b"
PLAIN_TOL = 1e-5     # wkv6_bwd_plain against autograd: f32 sums reordered
GRAD_TOL = 1e-4      # chip_smoke.TRAIN_GRAD_TOL: each leaf, x its max
WKV_BWD_TOL = 2e-5   # the kernel against wkv6_bwd_plain, x each max


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


def _cfgs(**kw):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _both(cfgs, seed=0):
    """The same seeded parameters in both packages."""
    npp = _overrides(jax.tree.map(
        np.asarray, JModel(cfgs[0]).init(jax.random.PRNGKey(seed))), seed)
    return jax.tree.map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


def _batch(vocab=256, seq=32, batch=2, step=0):
    return TokenPipeline(vocab=vocab, seq_len=seq,
                         global_batch=batch).batch(step)


def _regrow(like, values):
    it = iter(values)
    return tree_map(lambda _: next(it), like)


def _wkv_inputs(seed, B, S, H, hd, dtype=torch.float32, device="cpu",
                log_w=False, dd_shift=-1.5):
    """r, k, v (in ``dtype``), w, u, s0, dy, dsT from a seeded numpy
    generator, all nonzero; w = exp(lw), lw = -exp(dd), and with ``log_w``
    lw follows them."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(0, scale, shape) + shift).astype(
            np.float32)).to(device)
    r, k, v = (f32(B, S, H, hd).to(dtype) for _ in range(3))
    lw = -torch.exp(f32(B, S, H, hd, shift=dd_shift))
    out = (r, k, v, torch.exp(lw), f32(H, hd, scale=0.5), f32(B, H, hd, hd),
           f32(B, S, H, hd), f32(B, H, hd, hd, scale=0.1))
    return out + (lw,) if log_w else out


def _underflowing(seed, B, S, H, hd, dtype=torch.float32, device="cpu"):
    """``_wkv_inputs`` where every other key's decay has dd >= 5, so w =
    exp(-exp(dd)) is 0 in f32 (exp(-148) is below the least subnormal)."""
    args = list(_wkv_inputs(seed, B, S, H, hd, dtype, device))
    lw = torch.log(args[3])
    lw[..., ::2] = -torch.exp(5.0 + lw[..., ::2].abs())
    args[3] = torch.exp(lw)
    assert bool((args[3][..., ::2] == 0).all()) and bool(
        (args[3][..., 1::2] > 0).all())
    return tuple(args)


def _rel_errors(got, want):
    """Each gradient's largest difference over its largest magnitude."""
    return [((g.float() - x.float()).abs().max()
             / x.float().abs().max().clamp_min(1e-30)).item()
            for g, x in zip(got, want)]


# ------------------------------------------------------ the plain backward

@pytest.mark.parametrize("B,S,H,hd,final", [
    (2, 7, 3, 16, True), (1, 1, 2, 16, True), (2, 1, 1, 32, False),
    (3, 20, 2, 8, True), (1, 33, 1, 64, False), (2, 5, 1, 128, True)])
def test_wkv6_bwd_plain_matches_autograd(B, S, H, hd, final):
    """The recurrence's gradient, walked back a token at a time, against
    autograd through ``wkv6_plain``: every gradient within 1e-5 of its
    largest magnitude; ``dsT=None`` is a zero final-state gradient (one
    step without it leaves w unused: dw is zero)."""
    r, k, v, w, u, s0, dy, dsT = _wkv_inputs(B * 100 + S, B, S, H, hd)
    ins = [t.clone().requires_grad_() for t in (r, k, v, w, u, s0)]
    y, sT = wkv6_mod.wkv6_plain(*ins)
    target = (y * dy).sum() + ((sT * dsT).sum() if final else 0.0)
    want = [torch.zeros_like(t) if g is None else g for t, g in zip(
        ins, torch.autograd.grad(target, ins, allow_unused=True))]
    got = wkv6_mod.wkv6_bwd_plain(r, k, v, w, u, s0, dy,
                                  dsT if final else None)
    assert [g.dtype for g in got] == [torch.float32] * 6
    assert [g.shape for g in got] == [t.shape for t in ins]
    assert max(_rel_errors(got, want)) <= PLAIN_TOL


def test_wkv6_bwd_plain_takes_bf16_as_its_upcasts():
    """bf16 r, k, v give the gradients of their f32 upcasts, bit for bit."""
    args = _wkv_inputs(5, 2, 9, 2, 16, torch.bfloat16)
    up = (*(t.float() for t in args[:3]), *args[3:])
    for a, b in zip(wkv6_mod.wkv6_bwd_plain(*args),
                    wkv6_mod.wkv6_bwd_plain(*up)):
        assert torch.equal(a, b)


def test_bwd_tiling_is_a_function_of_hd():
    """The backward's tiling: pass A's row blocks hold whole rows and pass
    B's column blocks whole columns; pass B holds a chain's columns in one
    block up to hd 64, four column blocks at 128; a whole number of
    groups a stage; shared memory within a block's 227 KB, at hd 64
    several blocks an SM in each pass (228 KB an SM, 1 KB of it reserved a
    block), and at hd 128 two pass B blocks (two clusters' worth) an SM."""
    for hd in wkv6_mod.HEAD_DIMS:
        t = wkv6_mod.bwd_tiling(hd)
        assert t.rb * t.nrb == hd and t.cb * t.ncb == hd
        assert t.t % t.u == 0 and t.ns >= 2
        assert t.a_threads % 32 == 0 and t.b_threads % 32 == 0
        assert t.a_smem <= 232448 and t.b_smem <= 232448
        assert (t.b_threads - 32) % hd == 0     # a thread a (step, key)
    t = wkv6_mod.bwd_tiling(64)
    assert t.ncb == 1 and t.nrb == 2
    assert 233472 // (t.a_smem + 1024) >= 4
    assert 233472 // (t.b_smem + 1024) >= 2
    t = wkv6_mod.bwd_tiling(128)
    assert t.ncb == 4 and 233472 // (t.b_smem + 1024) >= 2
    with pytest.raises(ValueError):
        wkv6_mod.bwd_tiling(48)


@pytest.mark.parametrize("final", [True, False], ids=["dsT", "no_dsT"])
@pytest.mark.parametrize("hd", [16, 64])
def test_twopass_matches_plain(hd, final):
    """The kernel's algorithm in plain PyTorch against the oracle at S =
    1024 (B = H = 1): every gradient within ``WKV_BWD_TOL`` of its largest
    magnitude, d(log w) against w dw (the reverse running sum adds ~1e-6
    over the sequence; dr, dv, du and ds0 are the oracle's own sums)."""
    args = _wkv_inputs(hd, 1, 1024, 1, hd)
    dsT = args[7] if final else None
    got = wkv6_mod.wkv6_bwd_twopass_plain(*args[:7], dsT)
    want = wkv6_mod.wkv6_bwd_plain(*args[:7], dsT, log_w=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(_rel_errors(got, want)) <= WKV_BWD_TOL


def test_twopass_dv_and_ds0_are_the_forward_run_backward():
    """Pass B is the forward recurrence run backward in time: ``wkv6_plain``
    on the time-reversed (k, r, dy, w), with the same u and s0 = dsT,
    gives dv (its y, flipped back; a_t = sum r u k is symmetric in r and k)
    and ds0 (its final state, bit for bit)."""
    r, k, v, w, u, s0, dy, dsT = _wkv_inputs(8, 2, 37, 3, 16)
    _, _, dv, _, _, ds0 = wkv6_mod.wkv6_bwd_twopass_plain(r, k, v, w, u, s0,
                                                          dy, dsT)
    y, sT = wkv6_mod.wkv6_plain(*(t.flip(1) for t in (k, r, dy, w)), u, dsT)
    assert torch.equal(sT, ds0)
    assert _rel_errors([y.flip(1)], [dv])[0] <= WKV_BWD_TOL


def test_twopass_where_w_underflows():
    """Where dd >= 5 the decay w = exp(-exp(dd)) is 0 in f32, and w dw is
    0 there: the two passes (which never divide by w) give a finite
    d(log w) within ``WKV_BWD_TOL`` of it, of the largest |w dw| over
    every key, and every other gradient as the oracle does."""
    args = _underflowing(21, 2, 64, 2, 16)
    got = wkv6_mod.wkv6_bwd_twopass_plain(*args)
    want = wkv6_mod.wkv6_bwd_plain(*args, log_w=True)
    assert bool((want[3][..., ::2] == 0).all())
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert max(_rel_errors(got, want)) <= WKV_BWD_TOL


def test_rwkv_proj_w_is_exp_of_log_w():
    """``_rwkv_proj`` returns lw = -exp(dd), and w = exp(lw) (as
    ``ops.wkv6`` forms it) is the bits of exp(-exp(dd)) that the model
    used before it handed ``wkv6`` log w."""
    from repro_torch.nn import blocks
    cfg = get_config(ARCH).reduced()
    p = {k: v[0] for k, v in Model(cfg, device="cpu").init(3)[
        "layers"].items()}
    rng = np.random.default_rng(4)
    p["w0"] = torch.from_numpy(rng.normal(-1.5, 3.0, p["w0"].shape).astype(
        np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (2, 9, cfg.d_model)).astype(
        np.float32))
    xp = torch.from_numpy(rng.normal(0, 1, (2, cfg.d_model)).astype(
        np.float32))
    *_, lw = blocks._rwkv_proj(p, x, xp, cfg)
    w = torch.exp(lw)
    mix = x + (torch.cat([xp[:, None], x[:, :-1]], 1) - x) * p["mu"][4]
    dd = p["w0"] + torch.tanh(mix @ p["wA"]) @ p["wB"]
    assert torch.equal(w, torch.exp(-torch.exp(dd)))
    assert torch.equal(lw, -torch.exp(dd))
    assert bool((w == 0).any())                # dd past 5 somewhere


# ---------------------------------------------------------- loss and grads

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradient_match_jax(remat):
    """f32: the loss within 1e-5 relative and every gradient leaf within
    ``GRAD_TOL`` of its largest magnitude, with and without per-layer
    remat (on the CPU autograd differentiates ``wkv6_plain``)."""
    cfgs = _cfgs(dtype="float32", remat=remat)
    jp, tp = _both(cfgs)
    batch = _batch()
    (jl, jmet), jg = jax.value_and_grad(JModel(cfgs[0]).loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.requires_grad_(), tp)
    tl, tmet = Model(cfgs[1], device="cpu").loss(live, batch)
    tg = torch.autograd.grad(tl, leaves(live))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    assert float(tmet["xent"].detach()) == pytest.approx(
        float(jmet["xent"]), rel=1e-5)
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jg)))
    for path, g in flatten_with_path(_regrow(live, tg)):
        w = want[path]
        assert g.shape == w.shape, path
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_TOL * max(np.abs(w).max(), 1e-30), (path, err)
    # the seeded leaves carry real gradients (the reference's init would
    # give u's and ln_x's as zeros in part)
    for name in ("u", "w0", "mu", "cm_mu", "ln_x"):
        assert np.abs(want[("layers", name)]).max() > 0, name


def test_gradient_matches_jax_where_w_underflows():
    """f32, remat on, ``w0`` = 6 on every other channel (w = exp(-exp(6 +
    ...)) is 0 in f32 there): the loss and every gradient leaf, ``w0``'s
    among them, within ``GRAD_TOL`` of ``jax.value_and_grad`` of the
    reference's, so the path through log w holds where w is 0."""
    cfgs = _cfgs(dtype="float32", remat=True)
    npp = _overrides(jax.tree.map(
        np.asarray, JModel(cfgs[0]).init(jax.random.PRNGKey(5))), 5)
    w0 = npp["layers"]["w0"].copy()
    w0[..., ::2] = 6.0
    npp = {**npp, "layers": {**npp["layers"], "w0": w0}}
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(npp, device="cpu")
    batch = _batch(step=5)
    (jl, _), jg = jax.value_and_grad(JModel(cfgs[0]).loss, has_aux=True)(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.requires_grad_(), tp)
    tl, _ = Model(cfgs[1], device="cpu").loss(live, batch)
    tg = torch.autograd.grad(tl, leaves(live))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jg)))
    for path, g in flatten_with_path(_regrow(live, tg)):
        assert bool(torch.isfinite(g).all()), path
        err = np.abs(g.numpy() - want[path]).max()
        assert err <= GRAD_TOL * max(np.abs(want[path]).max(), 1e-30), \
            (path, err)
    gw0 = want[("layers", "w0")]
    assert np.abs(gw0[..., 1::2]).max() > 0


def test_bf16_loss_and_gradient_match_jax():
    """bf16 activations on f32 masters (remat on, the full config's
    setting): the loss within 2e-2 relative; each leaf's largest
    difference within 2^-3 of its largest magnitude and its mean within
    2^-4 of its mean magnitude (``tests/test_torch_train.py``'s bounds:
    PyTorch rounds to bf16 after every op, XLA at its fusions' outputs)."""
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


def test_train_step_matches_jax():
    """One AdamW step (lr 1e-3, clip 1.0, f32) through ``make_train_step``
    against the reference's jitted step: loss, grad norm and xent within
    1e-5 relative; each leaf's update within 2^-6 of its largest element.
    Adam's first step is lr g / (|g| + eps) (+ decay): sign-like, so where
    the reference's |g| is below 100 eps a difference of 1e-7 of the
    leaf's largest gradient moves the update by up to 2 lr (wg's worst by
    0.23 lr at |g| = 1.4e-9).  Those elements, at most 1 % of a leaf's
    nonzero gradients (39 of cm_k's 32768 here), are held to 2 lr, the
    most such a step can move."""
    cfgs = _cfgs(dtype="float32")
    jp, tp = _both(cfgs, seed=2)
    batch = jax.tree.map(jnp.asarray, _batch(step=3))
    before = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    grad = dict(flatten_with_path(jax.tree.map(np.asarray, jax.grad(
        lambda p: JModel(cfgs[0]).loss(p, batch)[0])(jp))))
    jopt, topt = jadamw.AdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jmake_train_step(JModel(cfgs[0]), jopt))
    tstep = make_train_step(Model(cfgs[1], device="cpu"), topt)
    jp, _, jm = jstep(jp, jopt.init(jp), batch)
    tp, ts, tm = tstep(tp, topt.init(tp), _batch(step=3))
    for key in ("loss", "grad_norm", "xent"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5)
    after = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    for path, t in flatten_with_path(tp):
        want = after[path] - before[path]
        err = np.abs(t.numpy() - before[path] - want)
        near0 = np.abs(grad[path]) < 100 * jopt.eps
        assert err[~near0].max(initial=0.0) <= 2 ** -6 * np.abs(want).max(), \
            path
        assert err[near0].max(initial=0.0) <= 2 * 1e-3, path
        assert np.count_nonzero(grad[path][near0]) <= 0.01 * near0.size, path
    assert int(ts["count"]) == 1
    assert not any(p.requires_grad for p in leaves(tp))


def test_launcher_trains_rwkv_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --arch rwkv6-3b --reduced
    --device cpu``: 40 steps on vocab 64, a record a step, finite, the
    last five losses' mean below the first five's by more than 0.2, and a
    final checkpoint."""
    loop = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--vocab", "64",
        "--steps", "40", "--batch", "8", "--seq", "32", "--lr", "3e-3",
        "--log-every", "1", "--ckpt-dir", str(tmp_path)])
    losses = [r["loss"] for r in loop.metrics_log]
    assert [r["step"] for r in loop.metrics_log] == list(range(40))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in loop.metrics_log)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses[::5]
    assert loop.restarts == 0


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


def _card(seed, B, S, H, hd, dtype, log_w=False):
    return _wkv_inputs(seed, B, S, H, hd, dtype, device="cuda", log_w=log_w)


def _check_kernel(args, final=True):
    r, k, v, w, u, s0, dy, dsT = args
    got = wkv6_mod.wkv6_bwd_kernel(r, k, v, w, u, s0, dy,
                                   dsT if final else None)
    torch.cuda.synchronize()
    want = wkv6_mod.wkv6_bwd_plain(r, k, v, w, u, s0, dy,
                                   dsT if final else None, log_w=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    errs = _rel_errors(got, want)
    assert max(errs) <= WKV_BWD_TOL, errs
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 16, 37, 1024])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_gpu_wkv6_bwd_matches_plain(hd, S, dtype):
    _needs_card()
    B, H = (2, 3) if S < 1024 else (1, 2)
    _check_kernel(_card(hd + S, B, S, H, hd, dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_gpu_wkv6_bwd_without_a_final_gradient(hd):
    _needs_card()
    _check_kernel(_card(7, 2, 21, 2, hd, torch.bfloat16), final=False)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_gpu_wkv6_bwd_where_w_underflows(hd):
    """w = 0 on every other key (dd >= 5): d(log w) there within
    ``WKV_BWD_TOL`` of w dw = 0, every gradient finite and as the plain
    version's."""
    _needs_card()
    _check_kernel(_underflowing(23, 2, 70, 2, hd, torch.bfloat16, "cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_wkv6_bwd_takes_views_off_16_bytes(dtype):
    """Inputs one element past a 16-byte boundary (contiguous views into
    larger buffers) give the same gradients as aligned copies."""
    _needs_card()
    args = _card(11, 2, 37, 3, 64, dtype)

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 and view.is_contiguous()
        return view
    got = wkv6_mod.wkv6_bwd_kernel(*(off(t) for t in args))
    want = wkv6_mod.wkv6_bwd_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128])
def test_gpu_wkv6_bwd_repeats_bit_identical(hd):
    _needs_card()
    args = _card(13, 3, 100, 4, hd, torch.bfloat16)
    first = wkv6_mod.wkv6_bwd_kernel(*args)
    again = wkv6_mod.wkv6_bwd_kernel(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_gpu_wkv6_bwd_counts_one_a_call_and_refuses():
    _needs_card()
    args = _card(17, 1, 40, 2, 64, torch.float32)
    n = wkv6_mod.wkv6_bwd_kernel.launches
    wkv6_mod.wkv6_bwd_kernel(*args)
    assert wkv6_mod.wkv6_bwd_kernel.launches == n + 1
    r, k, v, w, u, s0, dy, dsT = args
    for bad in ((r[..., :48].contiguous(), k[..., :48].contiguous(),
                 v[..., :48].contiguous(), w[..., :48].contiguous(),
                 u[:, :48].contiguous(), s0[..., :48, :48].contiguous(),
                 dy[..., :48].contiguous(), None),
                (r.half(), k.half(), v.half(), w, u, s0, dy, dsT),
                (r, k, v, w, u, s0, dy.double(), dsT),
                (r.cpu(), k, v, w, u, s0, dy, dsT)):
        with pytest.raises(ValueError):
            wkv6_mod.wkv6_bwd_kernel(*bad)
    assert wkv6_mod.wkv6_bwd_kernel.launches == n + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_ops_wkv6_under_grad_runs_both_kernels(dtype, monkeypatch):
    """``ops.wkv6`` on CUDA tensors that need a gradient, the decay given
    as log w (as the model hands it): one forward and one backward kernel
    launch, never a plain version; dr, dk, dv in r's dtype, within one
    bf16 ulp of the plain f32 gradient rounded plus ``WKV_BWD_TOL`` of its
    largest magnitude; d(log w) (against w dw), du, ds0 in f32.  With w
    given instead, a gradient through w is refused, and one through r
    alone runs both kernels and matches dr."""
    _needs_card()
    r, k, v, w, u, s0, dy, dsT, lw = _card(19, 2, 50, 3, 64, dtype,
                                           log_w=True)
    want = wkv6_mod.wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT, log_w=True)

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")
    monkeypatch.setattr(ops, "wkv6_plain", refuse)
    monkeypatch.setattr(wkv6_mod, "wkv6_bwd_plain", refuse)
    ins = [t.clone().requires_grad_() for t in (r, k, v, lw, u, s0)]
    f0 = wkv6_mod.wkv6_kernel.launches
    b0 = wkv6_mod.wkv6_bwd_kernel.launches
    y, sT = ops.wkv6(*ins[:3], None, *ins[4:], log_w=ins[3])
    got = torch.autograd.grad((y * dy).sum() + (sT * dsT).sum(), ins)
    torch.cuda.synchronize()
    assert wkv6_mod.wkv6_kernel.launches == f0 + 1
    assert wkv6_mod.wkv6_bwd_kernel.launches == b0 + 1
    assert [g.dtype for g in got] == [dtype] * 3 + [torch.float32] * 3
    for g, x in zip(got, want):
        x = x.to(g.dtype).float()
        ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8) \
            if g.dtype == torch.bfloat16 else torch.zeros_like(x)
        limit = ulp + WKV_BWD_TOL * x.abs().max()
        assert bool(((g.float() - x).abs() <= limit).all())
    with pytest.raises(ValueError):        # through w
        ops.wkv6(r, k, v, w.clone().requires_grad_(), u, s0)
    assert wkv6_mod.wkv6_kernel.launches == f0 + 1
    rg = r.clone().requires_grad_()        # through r alone
    y, sT = ops.wkv6(rg, k, v, w, u, s0)
    (dr,) = torch.autograd.grad((y * dy).sum() + (sT * dsT).sum(), rg)
    torch.cuda.synchronize()
    assert wkv6_mod.wkv6_kernel.launches == f0 + 2
    assert wkv6_mod.wkv6_bwd_kernel.launches == b0 + 2
    assert torch.equal(dr, got[0])


_AUTOGRAD_THREAD = """
import importlib, sys, torch
m = importlib.import_module("repro_torch.kernels.wkv6")
B, S, H, hd = 2, 37, 3, 64
g = torch.Generator(device="cuda").manual_seed(0)
def randn(*s):
    return torch.randn(s, generator=g, device="cuda")
r, k, v = (randn(B, S, H, hd).bfloat16() for _ in range(3))
lw = -torch.exp(randn(B, S, H, hd) - 1.5)
u, s0, dy, dsT = (randn(H, hd), randn(B, H, hd, hd), randn(B, S, H, hd),
                  randn(B, H, hd, hd))
m.wkv6_bwd_kernel(r, k, v, torch.exp(lw), u, s0, dy, dsT)  # main thread
ins = [x.clone().requires_grad_() for x in (r, k, v, lw, u, s0)]
y, sT = m.Wkv6.apply(*ins)
got = torch.autograd.grad((y, sT), ins, (dy, dsT))
torch.cuda.synchronize()
print("ok", all(bool(torch.isfinite(x).all()) for x in got))
"""


@pytest.mark.gpu
def test_gpu_wkv6_backward_on_autograd_s_own_thread():
    """In a fresh process, the library set up by a call on the main thread,
    then ``Wkv6``'s backward with f32 gradients given, so that the kernel's
    entry makes the first CUDA call on autograd's thread: the driver's
    tensor-map encoder needs the context current there (it failed with
    CUDA_ERROR_INVALID_CONTEXT before the entry bound it)."""
    _needs_card()
    import os
    import subprocess
    import sys
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(importlib.import_module("repro_torch").__path__[0] + "/..")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    done = subprocess.run([sys.executable, "-c", _AUTOGRAD_THREAD], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().endswith("ok True"), done.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_gpu_wkv6_bwd_tiling_is_the_library_s(hd):
    _needs_card()
    assert wkv6_mod.library_bwd_tiling(hd) == wkv6_mod.bwd_tiling(hd)


@pytest.mark.gpu
def test_gpu_rwkv_gradient_matches_cpu():
    """The reduced rwkv6 (hd 16) in f32, remat on, seeded as above: its
    loss gradient on the card (both wkv6 kernels, 2 forward and 1 backward
    launches a layer) within ``GRAD_TOL`` of the CPU's, leaf by leaf."""
    _needs_card()
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                              remat=True)
    params = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(0)
    for path, leaf in flatten_with_path(params):
        if path[-1] in ("u", "mu", "cm_mu", "ln_x", "w0"):
            leaf.copy_(torch.from_numpy(rng.normal(
                -1.5 if path[-1] == "w0" else 0.3, 0.5,
                tuple(leaf.shape)).astype(np.float32)))
    batch = _batch()
    grads = {}
    for dev in ("cpu", "cuda"):
        live = tree_map(lambda p: p.detach().to(dev).requires_grad_(),
                        params)
        f0 = wkv6_mod.wkv6_kernel.launches
        b0 = wkv6_mod.wkv6_bwd_kernel.launches
        loss, _ = Model(cfg, device=dev).loss(live, batch)
        grads[dev] = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    assert wkv6_mod.wkv6_kernel.launches - f0 == 2 * cfg.n_layers
    assert wkv6_mod.wkv6_bwd_kernel.launches - b0 == cfg.n_layers
    for c, g in zip(grads["cpu"], grads["cuda"]):
        assert (g.cpu() - c).abs().max() <= GRAD_TOL * c.abs().max()
