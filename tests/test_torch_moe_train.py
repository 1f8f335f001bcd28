"""MoE training (qwen2-moe: 60 routed top-4 + shared experts; arctic: 128
routed top-2 + a dense residual) in repro_torch against the JAX package on
the CPU, on the reduced configs in f32 (parameters too: arctic's masters
are bf16 at full size).  The reference's init zeros the norms and the QKV
biases, which would hide a swapped leaf, so ``ln1``, ``ln2``,
``final_norm``, ``bq``, ``bk`` and ``bv`` are drawn from a seeded
generator and carried across with ``params_from_jax``.

- ``MoeDispatch`` (the dispatch gather whose backward gathers each token's
  K slot gradients and adds them in k order, with no scatter) against
  autograd through ``torch.gather``: equal in f64 on values whose sums are
  exact, within 1e-6 of the largest in f32, bit-identical on repeat, with
  and without dropped pairs; the combine gather's slots have one writer a
  kept pair;
- ``Model.loss`` and every gradient leaf against ``jax.value_and_grad`` of
  the reference's, remat on and off, and with a capacity factor that drops
  pairs; ``moe_apply``'s gradient under a forced router tie; aux's
  gradient alone through the checkpoint (the router's leaf among them);
  the recomputed forward under remat routing exactly as the first;
- one AdamW step, params and both moments, against the reference's jitted
  step; ``launch.train.train`` against the reference launcher's losses.

The ``gpu`` tests (they skip without a card) hold the dispatch backward
bit-identical on repeat and against autograd through ``torch.gather`` on
the card, and a reduced MoE's gradient card against CPU."""
import ast
import contextlib
import dataclasses
import functools
import io
import math

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.launch import train as jlaunch_train
    from repro.nn import Model as JModel
    from repro.nn import blocks as jblocks
    from repro.nn import get_config as jget_config
    from repro.optim import adamw as jadamw
    from repro.runtime.step import make_train_step as jmake_train_step
except ImportError:
    jax = None
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.flash_attention import (flash_attention_bwd_kernel,
                                                 flash_attention_kernel)
from repro_torch.launch import train as launch_train
from repro_torch.nn import Model, blocks, get_config, params_from_jax
from repro_torch.optim import adamw
from repro_torch.optim.adamw import (AdamW, clip_by_global_norm,
                                     clip_by_global_norm_)
from repro_torch.runtime.step import make_train_step
from repro_torch.tree import flatten_with_path, leaves, tree_map

ARCHS = ("qwen2-moe-a2.7b", "arctic-480b")
F32 = dict(dtype="float32", param_dtype="float32")
SEQ = 32
GRAD_TOL = 1e-4     # chip_smoke.TRAIN_GRAD_TOL: each leaf, x its max
DISPATCH_TOL = 1e-6
SEEDED = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), **F32, **kw),
            dataclasses.replace(get_config(arch).reduced(), **F32, **kw))


def _seeded(tree, seed):
    """The reference's init tree (numpy) with the ``SEEDED`` leaves drawn
    from a seeded generator."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                rng.normal(0.0, 0.3, v.shape).astype(np.float32)
                if k in SEEDED else v for k, v in t.items()}
    return walk(tree)


def _np_params(jcfg, seed=0):
    return _seeded(jax.tree.map(
        np.asarray, JModel(jcfg).init(jax.random.PRNGKey(seed))), seed)


def _both(jcfg, seed=0):
    """The same seeded parameters in both packages."""
    npp = _np_params(jcfg, seed)
    return jax.tree.map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


def _batch(vocab, step=0, batch=2, seq=SEQ):
    return TokenPipeline(vocab=vocab, seq_len=seq,
                         global_batch=batch).batch(step)


def _regrow(like, values):
    it = iter(values)
    return tree_map(lambda _: next(it), like)


def _grads(tl, live):
    """Every leaf's gradient of ``tl``, zeros where a leaf is unused."""
    flat = leaves(live)
    got = torch.autograd.grad(tl, flat, allow_unused=True)
    return _regrow(live, [torch.zeros_like(p) if g is None else g
                          for p, g in zip(flat, got)])


def _assert_leaves_close(got, jgrads, tol=GRAD_TOL):
    """Each leaf of the port's tree ``got`` within ``tol`` of its largest
    magnitude of the reference's; a leaf the reference leaves at zero is
    zero."""
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jgrads)))
    seen = set()
    for path, g in flatten_with_path(got):
        w = want[path]
        assert g.shape == w.shape, path
        err = np.abs(g.detach().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (path, err, np.abs(w).max())
        seen.add(path)
    assert seen == set(want)
    return want


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(jcfg):
    """The reference's loss and gradient, jitted once a config (its eager
    scans take longer than the compile)."""
    return jax.jit(jax.value_and_grad(JModel(jcfg).loss, has_aux=True))


def _loss_and_grads(jcfg, tcfg, jp, tp, batch):
    (jl, jmet), jg = _jax_value_and_grad(jcfg)(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    tl, tmet = Model(tcfg, device="cpu").loss(live, batch)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    for key in ("xent", "aux"):
        assert float(tmet[key].detach()) == pytest.approx(
            float(jmet[key]), rel=1e-5), key
    return _grads(tl, live), jg


# ------------------------------------------------------------ the dispatch

def _dispatch_case(seed, B, S, E, K, cf, dtype, dyadic=False, d=24):
    """Routing of seeded probabilities as ``moe_apply`` routes them, x (B,
    S, d) and a cotangent dxe (B, E*C, d) in ``dtype``; with ``dyadic``
    every value a multiple of 1/8 below 8 in magnitude, so that any order
    of adding four of them is exact."""
    rng = np.random.default_rng(seed)
    probs = torch.softmax(torch.from_numpy(
        rng.normal(0, 1, (B, S, E)).astype(np.float32)), dim=-1)
    C = min(max(4, int(math.ceil(cf * S * K / E))), S)
    _, _, keep, slot = blocks.moe_route(probs, K, C)
    idx, filled = blocks.moe_slot_table(slot, S, E * C)

    def draw(shape):
        if dyadic:
            return torch.from_numpy(rng.integers(-63, 64, shape) / 8.0) \
                .to(dtype)
        return torch.from_numpy(rng.normal(0, 1, shape)).to(dtype)
    return draw((B, S, d)), draw((B, E * C, d)), idx, filled, slot, keep


def _gather_autograd(x, dxe, idx, filled):
    """dx by autograd through the gather and mask (``torch.gather``'s
    backward scatter-adds the slots' gradients)."""
    xx = x.clone().requires_grad_()
    xe = torch.gather(xx, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))
    xe = torch.where(filled[..., None], xe, 0)
    return torch.autograd.grad(xe, xx, dxe)[0]


def _dispatch_grad(x, dxe, idx, filled, slot, keep):
    xx = x.clone().requires_grad_()
    xe = blocks.MoeDispatch.apply(xx, idx, filled, slot, keep)
    return xe, torch.autograd.grad(xe, xx, dxe)[0]


DISPATCH_CASES = {"qwen2-moe": (2, 48, 60, 4, 1.25),
                  "arctic": (2, 48, 128, 2, 1.25),
                  "drops": (3, 40, 8, 4, 0.1),
                  "one token": (2, 1, 8, 2, 1.25)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_dispatch_backward_matches_gather_autograd(case, dtype):
    """``MoeDispatch``: its forward bit for bit the gather and mask; its
    backward (each token's K slot gradients gathered through ``slot`` and
    added in k order) equal to autograd through ``torch.gather`` in f64 on
    dyadic values, within ``DISPATCH_TOL`` of the largest in f32, and
    bit-identical on repeat; the drop case drops pairs, and every kept pair
    holds a slot of its own (so the combine gather's backward has one
    writer a slot but for the drop row)."""
    B, S, E, K, cf = DISPATCH_CASES[case]
    x, dxe, idx, filled, slot, keep = _dispatch_case(
        1, B, S, E, K, cf, dtype, dyadic=dtype == torch.float64)
    xe, got = _dispatch_grad(x, dxe, idx, filled, slot, keep)
    _, again = _dispatch_grad(x, dxe, idx, filled, slot, keep)
    want = _gather_autograd(x, dxe, idx, filled)
    assert torch.equal(xe, torch.where(filled[..., None], torch.gather(
        x, 1, idx[..., None].expand(*idx.shape, x.shape[-1])), 0))
    assert got.dtype == dtype and torch.equal(got, again)
    if dtype == torch.float64:
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max() <= DISPATCH_TOL * want.abs().max()
    for b in range(B):
        kept = slot[b][keep[b]]
        assert kept.unique().numel() == kept.numel() == int(filled[b].sum())
    if case == "drops":
        assert keep.float().mean() < 0.5


def test_moe_layer_gradient_is_bit_identical_on_repeat():
    """The whole MoE layer's gradient (x and every leaf) twice, equal bit
    for bit: the dispatch's backward adds in k order, the combine's
    scatters one writer a slot, the sort's values one a probability."""
    jcfg, tcfg = _cfgs("qwen2-moe-a2.7b")
    tp = params_from_jax(jax.tree.map(np.asarray, jblocks.init_moe(
        jax.random.PRNGKey(3), jcfg)), device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32))
    runs = []
    for _ in range(2):
        live = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
        xx = x.clone().requires_grad_()
        y, aux = blocks.moe_apply(live, xx, tcfg)
        runs.append(torch.autograd.grad((y * y).sum() + aux,
                                        [xx] + leaves(live)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# ------------------------------------------------------- loss and grads

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch, remat):
    """f32: the loss, xent and aux within 1e-5 relative and every gradient
    leaf (router, experts, shared or dense, attention, norms, embedding,
    head) within ``GRAD_TOL`` of its largest magnitude of
    ``jax.value_and_grad`` of the reference's ``Model.loss``, with and
    without per-layer remat (the reference's ``jax.checkpoint``'d scan)."""
    jcfg, tcfg = _cfgs(arch, remat=remat)
    jp, tp = _both(jcfg)
    got, jg = _loss_and_grads(jcfg, tcfg, jp, tp, _batch(tcfg.vocab))
    want = _assert_leaves_close(got, jg)
    for path in (("layers", "moe", "router"), ("layers", "moe", "wg"),
                 ("layers", "attn", "bq"), ("layers", "ln2")):
        assert np.abs(want.get(path, 1.0)).max() > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_with_dropped_pairs_matches_jax(arch):
    """Capacity factor 0.1 (C = 4 of the 32 x K pairs a row): many pairs
    are dropped at every layer, and the loss and every leaf still follow
    the reference's, remat on."""
    jcfg, tcfg = _cfgs(arch, capacity_factor=0.1, remat=True)
    jp, tp = _both(jcfg, seed=1)
    assert blocks.moe_capacity(tcfg, SEQ) == 4
    assert 4 * tcfg.n_experts < SEQ * tcfg.top_k       # pairs must drop
    got, jg = _loss_and_grads(jcfg, tcfg, jp, tp, _batch(tcfg.vocab, 1))
    _assert_leaves_close(got, jg)


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_gradient_under_a_forced_tie_matches_jax(arch):
    """Router columns copied in groups of three, so probabilities tie
    across the top-k boundary: ``moe_apply``'s gradient (x and every leaf
    of sum(y * dy) + 0.37 aux) against ``jax.grad`` of the reference's,
    the tied experts picked as ``lax.top_k`` picks them."""
    jcfg, tcfg = _cfgs(arch)
    jp = jblocks.init_moe(jax.random.PRNGKey(5), jcfg)
    E, K = jcfg.n_experts, jcfg.top_k
    router = np.asarray(jp["router"])[:, [3 * (e // 3) for e in range(E)]]
    jp = dict(jp, router=jnp.asarray(router))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    srt = -np.sort(-np.asarray(probs), axis=-1)
    assert (srt[..., K - 1] == srt[..., K]).any()      # ties straddle K

    def jloss(p, x):
        y, aux = jblocks.moe_apply(p, x, jcfg)
        return jnp.sum(y * dy) + 0.37 * aux

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    xx = torch.from_numpy(x).requires_grad_()
    y, aux = blocks.moe_apply(live, xx, tcfg)
    loss = (y * torch.from_numpy(dy)).sum() + 0.37 * aux
    got = torch.autograd.grad(loss, [xx] + leaves(live))
    _assert_leaves_close(_regrow(live, got[1:]), jg[0])
    w = np.asarray(jg[1])
    assert np.abs(got[0].numpy() - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_gradient_alone_matches_jax(arch):
    """The gradient of the loss's aux alone (the Switch term summed over
    the layers): it reaches every layer's router through the gates'
    softmax and, under remat, through the checkpoint, and every upstream
    leaf (attention, norms, embedding) through the router's input; each
    leaf within ``GRAD_TOL`` of its largest of the reference's; the last
    layer's experts and the head have none, in both."""
    jcfg, tcfg = _cfgs(arch, remat=True)
    jp, tp = _both(jcfg, seed=2)
    batch = _batch(tcfg.vocab, 2)
    jg = jax.jit(jax.grad(lambda p, b: JModel(jcfg).loss(p, b)[1]["aux"]))(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    _, tmet = Model(tcfg, device="cpu").loss(live, batch)
    want = _assert_leaves_close(_grads(tmet["aux"], live), jg)
    assert np.abs(want[("layers", "moe", "router")]).max() > 0
    assert np.abs(want[("layers", "attn", "wq")]).max() > 0
    assert not np.abs(want[("layers", "moe", "wd")][-1]).any()
    assert np.abs(want[("layers", "moe", "wd")][0]).max() > 0
    assert not np.abs(want[("lm_head",)]).any()


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_routing(arch, monkeypatch):
    """Under remat the backward recomputes each layer's forward: every
    recomputed ``moe_route`` call (layers in reverse) returns the first
    forward's gates, expert ids, keep mask and slots exactly."""
    jcfg, tcfg = _cfgs(arch, remat=True)
    _, tp = _both(jcfg, seed=4)
    calls, route = [], blocks.moe_route

    def recording(probs, K, C):
        out = route(probs, K, C)
        calls.append([t.detach().clone() for t in out])
        return out
    monkeypatch.setattr(blocks, "moe_route", recording)
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    loss, _ = Model(tcfg, device="cpu").loss(live, _batch(tcfg.vocab, 4))
    L = tcfg.n_layers
    assert len(calls) == L
    torch.autograd.grad(loss, leaves(live))
    assert len(calls) == 2 * L
    for i in range(L):
        assert all(torch.equal(a, b)
                   for a, b in zip(calls[i], calls[2 * L - 1 - i])), i


# ------------------------------------------------------------ the trainer

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step (lr 1e-3, clip 1.0, f32) through ``make_train_step``
    against the reference's jitted step: loss, grad norm, xent and aux
    within 1e-5 relative; the moments m and v each within ``GRAD_TOL``
    and 2 ``GRAD_TOL`` of their largest element (v is g^2); each leaf's
    update within 2^-6 of its largest element, and where the reference's
    |g| is below 100 eps within 2 lr (Adam's first step is sign-like
    there, ``tests/test_torch_rwkv_train.py`` states why), such elements
    being at most 5 % of a leaf but for ``bk``, whose exact gradient is
    zero (a key bias adds q . b to every key of a query's softmax)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(jcfg, seed=6)
    batch = _batch(tcfg.vocab, 3)
    jbatch = jax.tree.map(jnp.asarray, batch)
    before = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    grad = dict(flatten_with_path(jax.tree.map(
        np.asarray, _jax_value_and_grad(jcfg)(jp, jbatch)[1])))
    jopt, topt = jadamw.AdamW(lr=1e-3), AdamW(lr=1e-3)
    jstep = jax.jit(jmake_train_step(JModel(jcfg), jopt))
    tstep = make_train_step(Model(tcfg, device="cpu"), topt)
    jp, js, jm = jstep(jp, jopt.init(jp), jbatch)
    tp, ts, tm = tstep(tp, topt.init(tp), batch)
    for key in ("loss", "grad_norm", "xent", "aux"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-5), key
    for name, tol in (("m", GRAD_TOL), ("v", 2 * GRAD_TOL)):
        _assert_leaves_close(ts[name], js[name], tol)
    after = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    for path, t in flatten_with_path(tp):
        want = after[path] - before[path]
        err = np.abs(t.numpy() - before[path] - want)
        near0 = np.abs(grad[path]) < 100 * jopt.eps
        assert err[~near0].max(initial=0.0) <= 2 ** -6 * np.abs(want).max(), \
            path
        assert err[near0].max(initial=0.0) <= 2 * 1e-3, path
        if path[-1] != "bk":    # zero but for rounding: softmax ignores it
            assert np.count_nonzero(grad[path][near0]) <= 0.05 * near0.size, \
                path
    assert int(ts["count"]) == 1
    assert not any(p.requires_grad for p in leaves(tp))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_chunked_adamw_and_clip_in_place_are_bit_identical(state_dtype,
                                                           monkeypatch):
    """The step's memory savers change no bit: AdamW updating a leaf 100
    elements at a time (leaves of 1, 37 and 3 x 257 elements, one a matrix
    under weight decay) against one chunk a leaf, over 3 steps, params and
    both moments; ``clip_by_global_norm_`` (in place) against
    ``clip_by_global_norm``, f32 and bf16 leaves, clipping and not."""
    rng = np.random.default_rng(9)

    def tree():
        return {"a": torch.from_numpy(rng.normal(0, 1, (3, 257))
                                      .astype(np.float32)),
                "b": {"c": torch.from_numpy(rng.normal(0, 1, 37)
                                            .astype(np.float32)),
                      "d": torch.tensor(0.5)}}
    params, grads = tree(), [tree() for _ in range(3)]
    runs = []
    for chunk in (100, 1 << 26):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        opt = AdamW(lr=1e-2, state_dtype=state_dtype)
        p, st = tree_map(torch.clone, params), opt.init(params)
        for g in grads:
            p, st = opt.apply(p, st, g)
        runs.append(leaves(p) + leaves(st))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    for max_norm in (1.0, 1e3):
        g = tree_map(torch.clone, grads[0])
        g["b"]["c"] = g["b"]["c"].bfloat16()
        want, wnorm = clip_by_global_norm(g, max_norm)
        got, gnorm = clip_by_global_norm_(tree_map(torch.clone, g), max_norm)
        assert torch.equal(gnorm, wnorm)
        assert all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(leaves(got), leaves(want)))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_train_matches_the_reference_launcher(arch, tmp_path,
                                                       monkeypatch):
    """``launch.train.train`` on the reduced MoE on the CPU (remat on, as
    the configs train) against ``python -m repro.launch.train --arch
    <name> --reduced``, both given the same seeded f32 tree (each
    package's init draws from its own generator) through a patched
    ``Model``: 12 steps of 2 x 32 tokens at lr 3e-3 on the cosine
    schedule; the records the reference prints (steps 0, 10, 11) have the
    port's step numbers, losses within 1e-5 relative at step 0 and 1e-4
    after (Adam's steps carry f32 differences forward), xent and aux
    alike; a final checkpoint, no restart."""
    jcfg, tcfg = _cfgs(arch, remat=True)
    npp = _np_params(jcfg, seed=7)

    class JSeeded(JModel):
        def init(self, key):
            return jax.tree.map(jnp.asarray, npp)

    class TSeeded(Model):
        def init(self, gen):
            return params_from_jax(npp, device="cpu")

    monkeypatch.setattr(jlaunch_train, "Model", JSeeded)
    monkeypatch.setattr(jlaunch_train, "get_config", lambda name: (
        dataclasses.replace(jget_config(name), **F32, remat=True)))
    monkeypatch.setattr(launch_train, "Model", TSeeded)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch_train.main(["--arch", arch, "--reduced", "--steps", "12",
                            "--batch", "2", "--seq", str(SEQ), "--lr", "3e-3",
                            "--ckpt-dir", str(tmp_path / "j")])
    ref = [ast.literal_eval(line) for line in buf.getvalue().splitlines()
           if line.startswith("{")]
    loop = launch_train.train(tcfg, steps=12, batch=2, seq=SEQ, lr=3e-3,
                              ckpt_dir=str(tmp_path / "t"), device="cpu")
    got = loop.metrics_log
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [0, 10, 11]
    for i, (g, r) in enumerate(zip(got, ref)):
        for key in ("loss", "xent", "aux"):
            assert g[key] == pytest.approx(r[key], rel=1e-5 if i == 0
                                           else 1e-4), (g["step"], key)
    assert all(np.isfinite(r["grad_norm"]) for r in got)
    assert loop.restarts == 0 and (tmp_path / "t" / "step_11").exists()


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gpu_dispatch_backward_is_repeatable(dtype):
    """On the card at qwen2-moe's dispatch (60 experts, top 4, 8 x 1024
    tokens, C = 86) and width 2048: the dispatch backward twice, bit for
    bit equal, with deterministic algorithms off; in f32 within
    ``DISPATCH_TOL`` of the largest of autograd through ``torch.gather``,
    and equal to the CPU's bit for bit (a gather and three adds)."""
    _needs_card()
    x, dxe, idx, filled, slot, keep = _dispatch_case(
        8, 8, 1024, 60, 4, 1.25, torch.float32, d=2048)
    assert idx.shape[1] == 60 * 86
    cpu = _dispatch_grad(x.to(dtype), dxe.to(dtype), idx, filled, slot,
                         keep)[1]
    dev = [t.cuda() for t in (x.to(dtype), dxe.to(dtype), idx, filled, slot,
                              keep)]
    got = _dispatch_grad(*dev)[1]
    again = _dispatch_grad(*dev)[1]
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got.cpu(), cpu)
    if dtype == torch.float32:
        want = _gather_autograd(*dev[:4])
        assert (got - want).abs().max() <= DISPATCH_TOL * want.abs().max()


@pytest.mark.gpu
def test_gpu_moe_gradient_matches_cpu():
    """The reduced qwen2-moe (4 layers, 4 / 4 heads of 16) in f32, remat
    on, the ``SEEDED`` leaves seeded: its loss gradient on the card (flash
    forward and backward, the dispatch's gather backward) within
    ``GRAD_TOL`` of the CPU's, leaf by leaf, with the same expert choices
    at every layer; flash launches 2 a layer forward (remat's recompute)
    and 1 backward."""
    _needs_card()
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b").reduced(),
                              remat=True, **F32)
    params = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(0)
    for path, leaf in flatten_with_path(params):
        if path[-1] in SEEDED:
            leaf.copy_(torch.from_numpy(rng.normal(
                0.0, 0.3, tuple(leaf.shape)).astype(np.float32)))
    batch = _batch(cfg.vocab)
    grads, routes, route = {}, {}, blocks.moe_route
    for dev in ("cpu", "cuda"):
        seen = routes[dev] = []

        def recording(probs, K, C, seen=seen):
            out = route(probs, K, C)
            seen.append([t.cpu() for t in out[1:]])
            return out
        blocks.moe_route = recording
        try:
            live = tree_map(lambda p: p.detach().to(dev).requires_grad_(),
                            params)
            n0 = (flash_attention_kernel.launches,
                  flash_attention_bwd_kernel.launches)
            loss, _ = Model(cfg, device=dev).loss(live, batch)
            grads[dev] = torch.autograd.grad(loss, leaves(live))
        finally:
            blocks.moe_route = route
    torch.cuda.synchronize()
    n = (flash_attention_kernel.launches - n0[0],
         flash_attention_bwd_kernel.launches - n0[1])
    assert n == (2 * cfg.n_layers, cfg.n_layers), n
    for a, b in zip(routes["cpu"], routes["cuda"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for c, g in zip(grads["cpu"], grads["cuda"]):
        assert (g.cpu() - c).abs().max() <= GRAD_TOL * c.abs().max()
