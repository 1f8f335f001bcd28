"""Hybrid training (recurrentgemma-9b: RG-LRU + local attention) in
repro_torch against the JAX package on the CPU, on the reduced config in
f32 with 5 layers: one scanned unit (two RG-LRU layers and the windowed
attention) and two unrolled RG-LRU tail layers, so the tail is trained
too.  Sequences of 80 tokens run past the reduced window of 32.  The
reference's init sets every norm to 0 and ``lam`` to 3 everywhere, which
hides a norm or a decay on the wrong axis, so ``ln``, ``ln1``, ``ln2``,
``final_norm``, ``lam``, ``gate_i``, ``gate_r`` and ``conv_k`` are drawn
from a seeded generator and carried across with ``params_from_jax``.

- ``linear_scan_bwd`` (the gradient of h_t = a_t h_{t-1} + x_t as the same
  scan run backward in time) with ``linear_scan_plain`` against autograd
  through ``linear_scan_plain``, and the port's ``_rglru_scan`` with that
  backward against ``jax.grad`` of the reference's ``_rglru_scan``;
- ``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the reference's, within ``GRAD_TOL`` of each leaf's largest magnitude,
  remat on and off, through autograd and through the reversed scan;
- one AdamW step through ``make_train_step`` against the reference's
  jitted step; the launcher's ``train`` trains the reduced hybrid.

The ``gpu`` tests (they skip without a card) hold the scan's backward on
the kernel bit for bit against the plain reversed scan, and bit-identical
on repeat; ``ops.linear_scan`` under grad against autograd through the
plain version; every entry that encodes a tensor map called from a fresh
thread; a reduced hybrid's gradient card against CPU."""
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
    from repro.optim import adamw as jadamw
    from repro.runtime.step import make_train_step as jmake_train_step
except ImportError:
    jax = None
import repro_torch.kernels as kernels_pkg
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention import (flash_attention_bwd_kernel,
                                                 flash_attention_kernel)
from repro_torch.kernels.linear_scan import (LinearScan, linear_scan_bwd,
                                             linear_scan_kernel,
                                             linear_scan_plain)
from repro_torch.launch import train as launch_train
from repro_torch.nn import Model, blocks, get_config, params_from_jax
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.step import make_train_step
from repro_torch.tree import flatten_with_path, leaves, tree_map

ARCH = "recurrentgemma-9b"
KW = dict(n_layers=5, dtype="float32")     # 1 unit + 2 tail layers
SEQ = 80                                   # past the reduced window of 32
SCAN_TOL = 1e-5     # the reversed scan against autograd, x each max
GRAD_TOL = 1e-4     # chip_smoke.TRAIN_GRAD_TOL: each leaf, x its max
SEEDED = ("ln", "ln1", "ln2", "final_norm", "lam", "gate_i", "gate_r",
          "conv_k")


def _cfgs(**kw):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **KW, **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **KW, **kw))


def _seeded(tree, seed):
    """The reference's init tree (numpy) with the ``SEEDED`` leaves drawn
    from a seeded generator: norms around 0, lam around 3, the gates and
    the conv around their init's scale."""
    rng = np.random.default_rng(seed)
    draw = {"lam": (3.0, 1.0), "conv_k": (0.0, 0.3)}

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        out = {}
        for k, v in t.items():
            if isinstance(v, (dict, list)):
                out[k] = walk(v)
            elif k in SEEDED:
                mean, sd = draw.get(k, (0.0, 0.5))
                out[k] = rng.normal(mean, sd, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(tree)


def _both(cfgs, seed=0):
    """The same seeded parameters in both packages."""
    npp = _seeded(jax.tree.map(
        np.asarray, JModel(cfgs[0]).init(jax.random.PRNGKey(seed))), seed)
    return jax.tree.map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


def _batch(vocab=256, seq=SEQ, batch=2, step=0):
    return TokenPipeline(vocab=vocab, seq_len=seq,
                         global_batch=batch).batch(step)


def _regrow(like, values):
    it = iter(values)
    return tree_map(lambda _: next(it), like)


class _ReversedPlainScan(torch.autograd.Function):
    """``LinearScan`` with the plain version in the kernel's place: the
    card's backward arithmetic, run on the CPU."""

    @staticmethod
    def forward(ctx, a, x):
        h = linear_scan_plain(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return linear_scan_bwd(linear_scan_plain, a, h, dh.contiguous())


def _reverse_the_scan(monkeypatch):
    """The model's ``linear_scan`` (``_rglru_scan`` imports it from
    ``repro_torch.kernels``) differentiated by the reversed scan."""
    monkeypatch.setattr(kernels_pkg, "linear_scan", lambda a, x: (
        _ReversedPlainScan.apply(a.float().contiguous(),
                                 x.float().contiguous())))


def _scan_inputs(seed, B, S, W):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, W)).astype(np.float32))
    x, dh = (torch.from_numpy(rng.normal(0, 1, (B, S, W)).astype(np.float32))
             for _ in range(2))
    return a, x, dh


# ------------------------------------------------------------- the scan

@pytest.mark.parametrize("shape", [(2, 37, 8), (1, 1, 5), (3, 80, 64)],
                         ids=str)
def test_linear_scan_bwd_matches_autograd(shape):
    """da and dx from the reversed scan (a'_t = a_{t+1}, g_t = dh_t +
    a'_t g_{t+1}, da_t = g_t h_{t-1}) within ``SCAN_TOL`` of each one's
    largest magnitude of autograd through ``linear_scan_plain``; S = 1
    (no a' at all) among the shapes."""
    a, x, dh = _scan_inputs(1, *shape)
    aa, xx = a.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.autograd.grad(linear_scan_plain(aa, xx), (aa, xx), dh)
    got = linear_scan_bwd(linear_scan_plain, a, linear_scan_plain(a, x), dh)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert (g - w).abs().max() <= SCAN_TOL * w.abs().max()


def test_rglru_scan_backward_matches_jax(monkeypatch):
    """The port's ``_rglru_scan`` differentiated through the reversed scan
    against ``jax.grad`` of the reference's (its ``lax.scan`` under XLA's
    autodiff): the gradients of gate_i, gate_r, lam, u and h0, from
    nonzero h0 and cotangents of y and hS, within ``SCAN_TOL`` of each
    one's largest magnitude."""
    _reverse_the_scan(monkeypatch)
    rng = np.random.default_rng(2)
    B, S, w = 2, 40, 16
    npp = {"gate_i": rng.normal(0, 1, w), "gate_r": rng.normal(0, 1, w),
           "lam": rng.normal(3, 1, w)}
    npp = {k: v.astype(np.float32) for k, v in npp.items()}
    u, dy = (rng.normal(0, 1, (B, S, w)).astype(np.float32)
             for _ in range(2))
    h0, dhs = (rng.normal(0, 0.5, (B, w)).astype(np.float32)
               for _ in range(2))

    def jloss(p, u, h0):
        y, hS = jblocks._rglru_scan(p, u, h0)
        return jnp.sum(y * dy) + jnp.sum(hS * dhs)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        {k: jnp.asarray(v) for k, v in npp.items()}, jnp.asarray(u),
        jnp.asarray(h0))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in npp.items()}
    tu, th0 = (torch.from_numpy(t).requires_grad_() for t in (u, h0))
    y, hS = blocks._rglru_scan(tp, tu, th0)
    loss = (y * torch.from_numpy(dy)).sum() + (hS * torch.from_numpy(
        dhs)).sum()
    got = torch.autograd.grad(loss, [tp[k] for k in npp] + [tu, th0])
    wants = [want[0][k] for k in npp] + [want[1], want[2]]
    for name, g, w_ in zip(list(npp) + ["u", "h0"], got, wants):
        w_ = np.asarray(w_)
        err = np.abs(g.numpy() - w_).max()
        assert err <= SCAN_TOL * np.abs(w_).max(), (name, err)


# ------------------------------------------------------- loss and grads

@pytest.mark.parametrize("scan", ["autograd", "reversed"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradient_match_jax(remat, scan, monkeypatch):
    """f32: the loss within 1e-5 relative and every gradient leaf, the
    tail's among them, within ``GRAD_TOL`` of its largest magnitude of
    ``jax.value_and_grad`` of the reference's, with and without per-unit
    remat, through autograd of the plain scan and through the reversed
    scan (the card's backward arithmetic)."""
    if scan == "reversed":
        _reverse_the_scan(monkeypatch)
    cfgs = _cfgs(remat=remat)
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
    for path in (("tail", 1, "rg", "lam"), ("layers", "rg1", "lam"),
                 ("tail", 0, "ln1"), ("layers", "attn", "wq")):
        assert np.abs(want[path]).max() > 0, path


def test_train_step_matches_jax():
    """One AdamW step (lr 1e-3, clip 1.0, f32) through ``make_train_step``
    against the reference's jitted step: loss, grad norm and xent within
    1e-5 relative; each leaf's update within 2^-6 of its largest element,
    and where the reference's |g| is below 100 eps within 2 lr, the most
    Adam's sign-like first step can move (``tests/test_torch_rwkv_train.py``
    states why).  Those elements are at most 5 % of a leaf (1.9 % of the
    first tail layer's ``wg`` here: the tail's small gradients)."""
    cfgs = _cfgs()
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
        assert np.count_nonzero(grad[path][near0]) <= 0.05 * near0.size, path
    assert int(ts["count"]) == 1
    assert not any(p.requires_grad for p in leaves(tp))


def test_launcher_train_trains_the_hybrid_on_the_cpu(tmp_path):
    """``launch.train.train`` on the reduced hybrid at 5 layers, vocab 64,
    2 x 80 tokens: 30 steps (lr 3e-3), a record a step, finite, the first
    loss near ln V, the last five losses' mean below the first five's by
    more than 0.2, a final checkpoint; ``main`` with the same arguments
    gives the same losses (it parses, then calls ``train``)."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=5,
                              vocab=64)
    loop = launch_train.train(cfg, steps=30, batch=2, seq=SEQ, lr=3e-3,
                              ckpt_dir=str(tmp_path / "a"), log_every=1,
                              device="cpu")
    losses = [r["loss"] for r in loop.metrics_log]
    assert [r["step"] for r in loop.metrics_log] == list(range(30))
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in loop.metrics_log)
    assert abs(losses[0] - np.log(64)) < 0.5, losses[0]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses[::5]
    assert loop.restarts == 0
    assert (tmp_path / "a" / "step_29").exists()
    again = launch_train.main([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--vocab", "64",
        "--steps", "4", "--batch", "2", "--seq", str(SEQ), "--lr", "3e-3",
        "--log-every", "1", "--ckpt-dir", str(tmp_path / "b")])
    short = launch_train.train(
        dataclasses.replace(get_config(ARCH).reduced(), vocab=64), steps=4,
        batch=2, seq=SEQ, lr=3e-3, ckpt_dir=str(tmp_path / "c"),
        log_every=1, device="cpu")
    assert [r["loss"] for r in again.metrics_log] == \
        [r["loss"] for r in short.metrics_log]


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1000, 512), (1, 4096, 256),
                                   (3, 17, 70), (2, 1, 64)], ids=str)
def test_gpu_linear_scan_bwd_is_the_plain_reversed_scan(shape):
    """``linear_scan_bwd`` on the kernel equals it on the plain version
    bit for bit (the kernel is bit-identical to the plain scan) on every
    route (ring, tiled at W = 70, step at S = 1), and two runs are
    bit-identical."""
    _needs_card()
    a, x, dh = (t.cuda() for t in _scan_inputs(3, *shape))
    h = linear_scan_kernel(a, x)
    got = linear_scan_bwd(linear_scan_kernel, a, h, dh)
    again = linear_scan_bwd(linear_scan_kernel, a, h, dh)
    want = linear_scan_bwd(linear_scan_plain, a, h, dh)
    torch.cuda.synchronize()
    for g, r, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(g, r)


@pytest.mark.gpu
def test_gpu_ops_linear_scan_under_grad():
    """``ops.linear_scan`` under grad on the card: one forward and one
    backward launch of the kernel, da and dx within ``SCAN_TOL`` of each
    one's largest magnitude of autograd through ``linear_scan_plain``."""
    from repro_torch.kernels import ops
    _needs_card()
    a, x, dh = (t.cuda() for t in _scan_inputs(4, 2, 300, 128))
    aa, xx = a.clone().requires_grad_(), x.clone().requires_grad_()
    n0, b0 = linear_scan_kernel.launches, LinearScan.backward_launches
    got = torch.autograd.grad(ops.linear_scan(aa, xx), (aa, xx), dh)
    torch.cuda.synchronize()
    assert linear_scan_kernel.launches == n0 + 2
    assert LinearScan.backward_launches == b0 + 1
    pa, px = a.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.autograd.grad(linear_scan_plain(pa, px), (pa, px), dh)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= SCAN_TOL * w.abs().max()


_FRESH_THREADS = """
import threading, torch
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_kernel,
                                                 flash_attention_kernel)
from repro_torch.kernels.linear_scan import linear_scan_bwd, linear_scan_kernel
from repro_torch.kernels.wkv6 import wkv6_bwd_kernel
g = torch.Generator(device="cuda").manual_seed(0)
def rn(*s, dt=torch.float32):
    return torch.randn(s, generator=g, device="cuda").to(dt)
bf = torch.bfloat16
a, x = torch.rand(2, 64, 64, device="cuda"), rn(2, 64, 64)
h = linear_scan_kernel(a, x)
q, k, v = rn(1, 128, 16, 256, dt=bf), rn(1, 128, 1, 256, dt=bf), \\
    rn(1, 128, 1, 256, dt=bf)
out, lse = flash_attention_kernel(q, k, v, window=64, lse=True)
xi = torch.randint(-128, 128, (32, 64), device="cuda", dtype=torch.int8)
wi = torch.randint(-128, 128, (64, 64), device="cuda", dtype=torch.int8)
e = torch.zeros(64, device="cuda", dtype=torch.int32)
r6, k6, v6 = (rn(1, 40, 2, 64, dt=bf) for _ in range(3))
lw = -torch.exp(rn(1, 40, 2, 64) - 1.5)
u, s0 = rn(2, 64), rn(1, 2, 64, 64)
calls = {
    "linear_scan": lambda: ops.linear_scan(a, x),
    "linear_scan backward": lambda: linear_scan_bwd(linear_scan_kernel, a,
                                                    h, x),
    "flash_attention": lambda: ops.flash_attention(q, k, v, window=64),
    "flash_attention_bwd": lambda: flash_attention_bwd_kernel(
        q, k, v, out, q, lse, window=64),
    "qmatmul": lambda: ops.qmatmul(xi, wi, e),
    "wkv6": lambda: ops.wkv6(r6, k6, v6, None, u, s0, log_w=lw),
    "wkv6_bwd": lambda: wkv6_bwd_kernel(r6, k6, v6, torch.exp(lw), u, s0,
                                        rn(1, 40, 2, 64), s0),
}
for f in calls.values():      # built, loaded, set up on the main thread
    f()
torch.cuda.synchronize()
bad = {}
for name, f in calls.items():
    def run(name=name, f=f):
        try:
            f()
            torch.cuda.synchronize()
        except Exception as err:
            bad[name] = repr(err)[:300]
    t = threading.Thread(target=run)
    t.start()
    t.join()
print("failed", bad)
print("ok", not bad)
"""


@pytest.mark.gpu
def test_gpu_entries_from_a_fresh_thread():
    """In a fresh process, each op set up once on the main thread, then
    each entry that encodes a tensor map (the linear scan's ring, flash
    forward and backward in bf16, qmatmul's TMA route, wkv6 and its
    backward) called from a new ``threading.Thread``, where it is the
    first CUDA call: each makes the device's primary context current
    before ``cuTensorMapEncodeTiled`` (autograd's own thread is such a
    thread; the encoder failed there with CUDA_ERROR_INVALID_CONTEXT)."""
    import importlib
    import os
    import subprocess
    import sys
    _needs_card()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(importlib.import_module("repro_torch").__path__[0] + "/..")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    done = subprocess.run([sys.executable, "-c", _FRESH_THREADS], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    assert done.stdout.strip().endswith("ok True"), done.stdout


@pytest.mark.gpu
def test_gpu_hybrid_gradient_matches_cpu():
    """The reduced hybrid (5 layers, head dim 16) in f32, remat on, the
    ``SEEDED`` leaves seeded: its loss gradient on the card (flash forward
    and backward, the linear scan forward and backward) within
    ``GRAD_TOL`` of the CPU's, leaf by leaf; launches: flash 2 forward (the
    remat's recompute) and 1 backward, the scan 2 x 2 + 2 forward (the
    tail is not under remat) and 4 backward."""
    _needs_card()
    cfg = dataclasses.replace(get_config(ARCH).reduced(), remat=True, **KW)
    params = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(0)
    for path, leaf in flatten_with_path(params):
        if path[-1] in SEEDED:
            leaf.copy_(torch.from_numpy(rng.normal(
                3.0 if path[-1] == "lam" else 0.0, 0.5,
                tuple(leaf.shape)).astype(np.float32)))
    batch = _batch()
    grads = {}
    for dev in ("cpu", "cuda"):
        live = tree_map(lambda p: p.detach().to(dev).requires_grad_(),
                        params)
        n0 = (flash_attention_kernel.launches,
              flash_attention_bwd_kernel.launches,
              linear_scan_kernel.launches, LinearScan.backward_launches)
        loss, _ = Model(cfg, device=dev).loss(live, batch)
        grads[dev] = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    n = (flash_attention_kernel.launches - n0[0],
         flash_attention_bwd_kernel.launches - n0[1],
         linear_scan_kernel.launches - n0[2],
         LinearScan.backward_launches - n0[3])
    assert n == (2, 1, 6 + 4, 4), n
    for c, g in zip(grads["cpu"], grads["cuda"]):
        assert (g.cpu() - c).abs().max() <= GRAD_TOL * c.abs().max()
