"""VLM training (llava-next-34b: the dense decoder over projected patch
embeddings put in front of the tokens) in repro_torch against the JAX
package on the CPU, on the reduced config (4 layers, d_model 64, 4 / 4
heads of 16, vocab 256, 8 patches) and on its GQA variant (4 / 1 heads:
the reduced config is MHA, which would hide a grouping fault), in f32.
The reference's init zeros ``ln1``, ``ln2`` and ``final_norm``, which
would let a swapped norm pass, so they are drawn from a seeded generator
and carried across with ``params_from_jax``.

Neither train launcher feeds patches, so the VLM trains through
``make_train_step`` and ``TrainLoop`` on batches laid out as the
reference's train cell (``launch/specs.py::input_specs``): the tokens and
labels of ``TokenPipeline`` after patch embeddings (B, P, 1024) drawn in
f32 from a numpy generator seeded by (seed, step) -- ``chip_smoke.py``'s
``SpecBatches`` (laid out by the port's ``launch/specs.py``), which phase
19 feeds llava-next-34b at full width.

- ``chip_smoke.vlm_leaves`` against the reference's ``eval_shape`` of
  ``Model.init`` at 1, 2 and 60 layers;
- ``Model.loss`` and every gradient leaf (``vision_proj`` among them)
  against ``jax.value_and_grad`` of the reference's, with remat on and
  off, within 1e-5 of each leaf's largest magnitude;
- one ``make_train_step`` step (params, m, v) against the reference's
  jitted step; ``TrainLoop``'s records against the reference
  ``TrainLoop``'s over the same batches; a restart after an injected
  failure equal leaf for leaf to an uninterrupted run;
- both train launchers failing with ``KeyError: 'patch_embeds'``.

The ``gpu`` tests (they skip without a card) hold the flash backward at
llava-next-34b's layout (56 / 8 heads of 128, causal) over 4096 positions
and a ragged length against autograd through the plain version, f32 and
bf16, and a reduced VLM's gradient card against CPU."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.launch import train as jlaunch_train
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.optim import adamw as jadamw
    from repro.runtime import train as jtrain
    from repro.runtime.step import make_train_step as jmake_train_step
except ImportError:
    jax = None
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    BWD_BF16_MAX, BWD_BF16_MEAN, BWD_F32_TOL, KEY_TILE,
    bf16_grad_disagreement, flash_attention_bwd_kernel,
    flash_attention_kernel, flash_attention_plain)
from repro_torch.launch import train as launch_train
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.nn.types import ShapeSpec
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.step import make_train_step
from repro_torch.runtime.train import TrainConfig, TrainLoop
from repro_torch.tree import flatten_with_path, leaves, tree_map

ARCH = "llava-next-34b"
TOL = 1e-5          # loss and each gradient leaf, x its largest magnitude
CARD_TOL = 1e-4     # chip_smoke.TRAIN_GRAD_TOL: card against CPU
B, T = 2, 24        # rows, text tokens after the reduced config's 8 patches
LR, STEPS = 3e-3, 12
SEEDED = ("ln1", "ln2", "final_norm")


@functools.lru_cache(maxsize=None)
def _smoke():
    """``chip_smoke.py``, loaded by path (it is no package)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(variant, **kw):
    """(reference, port) configs in f32: the reduced one, or its GQA
    variant."""
    kv = dict(n_kv_heads=1) if variant == "gqa" else {}
    return tuple(dataclasses.replace(get(ARCH).reduced(), dtype="float32",
                                     **kv, **kw)
                 for get in (jget_config, get_config))


def _pipe(cfg, seed=0):
    return _smoke().SpecBatches(
        cfg, ShapeSpec("reduced", cfg.n_patches + T, B, "train"), B,
        seed=seed)


@functools.lru_cache(maxsize=None)
def _np_params(variant, seed=0):
    """The reference's init tree (numpy) with the ``SEEDED`` leaves drawn
    from a seeded generator."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                rng.normal(0.0, 0.3, v.shape).astype(np.float32)
                if k in SEEDED else v for k, v in t.items()}
    jcfg = _cfgs(variant)[0]
    return walk(jax.tree.map(np.asarray,
                             JModel(jcfg).init(jax.random.PRNGKey(seed))))


def _both(variant, seed=0):
    npp = _np_params(variant, seed)
    return jax.tree.map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


def _assert_leaves_close(got, want, tol=TOL):
    """Each leaf of the port's tree ``got`` within ``tol`` of its largest
    magnitude of the reference's ``want``; the same paths in both."""
    want = dict(flatten_with_path(jax.tree.map(np.asarray, want)))
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
    return jax.jit(jax.value_and_grad(JModel(jcfg).loss, has_aux=True))


def _optimizers():
    """Both packages' AdamW as the launchers build it: cosine schedule,
    20 warm-up steps."""
    return (jadamw.AdamW(lr=LR, schedule=jadamw.cosine_schedule(LR, 20,
                                                                STEPS)),
            AdamW(lr=LR, schedule=cosine_schedule(LR, 20, STEPS)))


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    """The reference's jitted train step with ``_optimizers()``'s AdamW,
    once a config."""
    return jax.jit(jmake_train_step(JModel(jcfg), _optimizers()[0]))


# ------------------------------------------------------------ the batches

def test_batches_follow_the_train_cell_layout():
    """``SpecBatches`` for the VLM: the tokens and labels of
    ``TokenPipeline`` at ``seq - n_patches`` and f32 patches (B, P, 1024),
    the same for the same step, other for another step."""
    from repro_torch.data.tokens import TokenPipeline
    cfg = get_config(ARCH).reduced()
    pipe = _pipe(cfg, seed=3)
    b = pipe.batch(5)
    text = TokenPipeline(vocab=cfg.vocab, seq_len=T, global_batch=B,
                         seed=3).batch(5)
    assert set(b) == {"tokens", "labels", "patch_embeds"}
    assert all(np.array_equal(b[k], text[k]) for k in ("tokens", "labels"))
    assert b["patch_embeds"].shape == (B, cfg.n_patches, 1024)
    assert b["patch_embeds"].dtype == np.float32
    assert np.array_equal(pipe.batch(5)["patch_embeds"], b["patch_embeds"])
    assert not np.array_equal(pipe.batch(6)["patch_embeds"],
                              b["patch_embeds"])


@pytest.mark.parametrize("layers", [1, 2, 60])
def test_vlm_leaves_match_reference(layers):
    """``chip_smoke.vlm_leaves`` is the leaf count of the reference's
    ``Model.init`` at full width, by ``eval_shape``; phase 19's cut and
    full depth are the figures its constants state."""
    smoke = _smoke()
    jcfg = dataclasses.replace(jget_config(ARCH), n_layers=layers)
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    assert smoke.vlm_leaves(cfg) == want
    if layers == 60:
        assert want == smoke.VLM_FULL_LEAVES
    cut = dataclasses.replace(cfg, n_layers=smoke.VLM_TRAIN_LAYERS)
    assert smoke.vlm_leaves(cut) == 3_714_135_040
    assert cut.params_count() == 3_248_043_008


@pytest.mark.parametrize("arch,layers,formula", [
    ("qwen2.5-3b", 18, "dense_leaves"), ("qwen2.5-3b", 36, "dense_leaves"),
    ("internlm2-1.8b", 12, "dense_leaves"), ("qwen1.5-4b", 20, "dense_leaves"),
    ("qwen1.5-4b", 40, "dense_leaves"), ("qwen2-moe-a2.7b", 12, "moe_leaves"),
    ("qwen2-moe-a2.7b", 24, "moe_leaves")])
def test_cut_leaf_counts_match_reference(arch, layers, formula):
    """``chip_smoke.dense_leaves`` and ``moe_leaves``, which hold the
    serving phases' cut and full depths, are the reference's
    ``Model.init`` leaf counts by ``eval_shape``; full depth's are the
    figures ``DENSE_PARAMS`` and ``MOE_PARAMS`` state."""
    smoke = _smoke()
    jcfg = dataclasses.replace(jget_config(arch), n_layers=layers)
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    full = get_config(arch)
    assert getattr(smoke, formula)(
        dataclasses.replace(full, n_layers=layers)) == want
    if layers == full.n_layers:
        assert want == smoke.DENSE_PARAMS.get(arch, smoke.MOE_PARAMS)


@pytest.mark.parametrize("arch,layers,count", [
    ("recurrentgemma-9b", "HYB_LAYERS", "HYB_PARAMS"),
    ("rwkv6-3b", "RWKV_LAYERS", "RWKV_PARAMS"),
    ("llava-next-34b", "VLM_LAYERS", "VLM_PARAMS"),
    ("qwen2-moe-a2.7b", "MOE_QUANT_LAYERS", "MOE_QUANT_PARAMS")])
def test_serving_cut_counts_match_reference(arch, layers, count):
    """The leaf counts ``chip_smoke.py`` holds its cut serving phases to
    are the reference's ``Model.init`` leaves at those depths."""
    smoke = _smoke()
    jcfg = dataclasses.replace(jget_config(arch),
                               n_layers=getattr(smoke, layers))
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) \
        == getattr(smoke, count)


# ------------------------------------------------------- loss and grads

@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("variant", ["reduced", "gqa"])
def test_loss_and_gradient_match_jax(variant, remat):
    """f32: the loss within 1e-5 relative and every gradient leaf
    (``vision_proj``, attention, MLP, norms, embedding, head) within 1e-5
    of its largest magnitude of ``jax.value_and_grad`` of the reference's
    ``Model.loss``, with and without per-layer remat; the patches' rows
    of the embedding get no gradient, ``vision_proj`` does."""
    jcfg, tcfg = _cfgs(variant, remat=remat)
    jp, tp = _both(variant)
    batch = _pipe(tcfg).batch(0)
    (jl, _), jg = _jax_value_and_grad(jcfg)(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    tl, _ = Model(tcfg, device="cpu").loss(live, batch)
    got = torch.autograd.grad(tl, leaves(live))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=TOL)
    it = iter(got)
    want = _assert_leaves_close(tree_map(lambda _: next(it), live), jg)
    assert np.abs(want[("vision_proj",)]).max() > 0
    for path in (("layers", "ln1"), ("layers", "ln2"), ("final_norm",)):
        assert np.abs(want[path]).max() > 0, path


# ------------------------------------------------------------ the trainer

def test_train_step_matches_jax():
    """One step of ``make_train_step`` (GQA variant, AdamW as the
    launchers build it, clip 1.0, remat on) against the reference's jitted
    step: loss, grad norm and xent within 1e-5 relative; the moments m and
    v each within 1e-5 and 2e-5 of their largest element (v is g^2); each
    leaf's update within 2^-6 of its largest element, and where the
    reference's |g| is below 100 eps within 2 lr / 20 (Adam's first step
    is sign-like there, ``tests/test_torch_rwkv_train.py`` states why),
    such elements at most 5 % of a leaf."""
    jcfg, tcfg = _cfgs("gqa", remat=True)
    jp, tp = _both("gqa", seed=1)
    batch = _pipe(tcfg, seed=1).batch(0)
    jbatch = jax.tree.map(jnp.asarray, batch)
    before = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    grad = dict(flatten_with_path(jax.tree.map(
        np.asarray, _jax_value_and_grad(jcfg)(jp, jbatch)[1])))
    jopt, topt = _optimizers()
    jp, js, jm = _jax_step(jcfg)(jp, jopt.init(jp), jbatch)
    tp, ts, tm = make_train_step(Model(tcfg, device="cpu"), topt)(
        tp, topt.init(tp), batch)
    for key in ("loss", "grad_norm", "xent"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=TOL), key
    for name, tol in (("m", TOL), ("v", 2 * TOL)):
        _assert_leaves_close(ts[name], js[name], tol)
    after = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    for path, t in flatten_with_path(tp):
        want = after[path] - before[path]
        err = np.abs(t.numpy() - before[path] - want)
        near0 = np.abs(grad[path]) < 100 * jopt.eps
        assert err[~near0].max(initial=0.0) <= 2 ** -6 * np.abs(want).max(), \
            path
        assert err[near0].max(initial=0.0) <= 2 * LR / 20, path
        assert np.count_nonzero(grad[path][near0]) <= 0.05 * near0.size, path
    assert int(ts["count"]) == 1


def test_train_loop_matches_the_reference_loop(tmp_path):
    """The port's ``TrainLoop`` over ``make_train_step`` against the
    reference's ``TrainLoop`` over its jitted step, GQA variant, remat on,
    both from the same seeded tree on the same ``SpecBatches`` stream,
    ``STEPS`` steps at lr 3e-3 on the cosine schedule, a record every 5
    steps and the last: the same steps recorded, losses and xent within
    1e-5 relative at step 0 and 1e-4 after (Adam's steps carry f32
    differences forward), a final checkpoint, no restart."""
    jcfg, tcfg = _cfgs("gqa", remat=True)
    jp, tp = _both("gqa", seed=2)
    jopt, topt = _optimizers()
    pipe = _pipe(tcfg, seed=2)
    cfg = dict(total_steps=STEPS, ckpt_every=100, log_every=5)
    jloop = jtrain.TrainLoop(jtrain.TrainConfig(
        ckpt_dir=str(tmp_path / "j"), **cfg), _jax_step(jcfg), pipe)
    jloop.run(jp, jopt.init(jp))
    tloop = TrainLoop(TrainConfig(ckpt_dir=str(tmp_path / "t"), **cfg),
                      make_train_step(Model(tcfg, device="cpu"), topt), pipe)
    tloop.run(tp, topt.init(tp))
    ref, got = jloop.metrics_log, tloop.metrics_log
    assert [r["step"] for r in got] == [r["step"] for r in ref] \
        == [0, 5, 10, 11]
    for i, (g, r) in enumerate(zip(got, ref)):
        for key in ("loss", "xent"):
            assert g[key] == pytest.approx(float(r[key]), rel=TOL if i == 0
                                           else 1e-4), (g["step"], key)
    assert all(np.isfinite(r["grad_norm"]) for r in got)
    assert tloop.restarts == jloop.restarts == 0
    assert (tmp_path / "t" / f"step_{STEPS - 1}").exists()


def test_restart_replays_the_run(tmp_path):
    """``TrainLoop`` with a checkpoint every 4 steps and a failure injected
    at step 6 restores step 4 and replays the ``SpecBatches`` stream from
    step 5: every final leaf, params and optimizer state, equal bit for
    bit to an uninterrupted run's."""
    _, tcfg = _cfgs("gqa", remat=True)
    tp = Model(tcfg, device="cpu").init(0)
    fired = []

    def fail_once(step):
        if step == 6 and not fired:
            fired.append(step)
            raise RuntimeError("simulated node failure")

    ends, restarts = [], []
    for hook in (None, fail_once):
        opt = AdamW(lr=LR)
        loop = TrainLoop(
            TrainConfig(total_steps=8, ckpt_every=4, log_every=100,
                        ckpt_dir=str(tmp_path / str(len(ends)))),
            make_train_step(Model(tcfg, device="cpu"), opt), _pipe(tcfg, 4),
            failure_hook=hook)
        p, o = loop.run(tree_map(torch.clone, tp), opt.init(tp))
        ends.append(leaves({"p": p, "o": o}))
        restarts.append(loop.restarts)
    assert restarts == [0, 1] and fired == [6]
    assert len(ends[0]) == len(ends[1])
    assert all(torch.equal(a, b) for a, b in zip(*ends))


@pytest.mark.parametrize("launcher", ["jax", "torch"])
def test_train_launchers_fail_without_patches(launcher, tmp_path):
    """Both train launchers feed ``TokenPipeline`` batches, tokens and
    labels only, so the VLM's loss fails with ``KeyError:
    'patch_embeds'`` (after the loop's restarts) and no step is taken."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path)]
    main = jlaunch_train.main if launcher == "jax" else launch_train.main
    if launcher == "torch":
        argv += ["--device", "cpu"]
    with pytest.raises(KeyError, match="patch_embeds"):
        main(argv)
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [4096, 3001])
def test_gpu_flash_backward_at_llava_layout(S, dtype):
    """Row 4b at 56 / 8 heads of 128, causal, one row of ``S`` positions
    (the train cell's 4096, and 3001, off every tile), through
    ``FlashAttention`` against autograd through the plain version: f32
    within ``BWD_F32_TOL`` of each gradient's largest magnitude, bf16
    under ``bf16_grad_disagreement``; one backward call, two calls
    bit-identical."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(S)
    q, k, v, dout = (torch.randn(s, generator=g, device="cuda", dtype=dtype)
                     for s in ((1, S, 56, 128), (1, S, 8, 128),
                               (1, S, 8, 128), (1, S, 56, 128)))

    def kernel_grads():
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*xs, bk=512, offset=0)
        return torch.autograd.grad(out, xs, dout)

    n0 = flash_attention_bwd_kernel.launches
    got = kernel_grads()
    torch.cuda.synchronize()
    assert flash_attention_bwd_kernel.launches == n0 + 1
    again = kernel_grads()
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention_plain(
        *xs, offset=0, bk=512 if dtype == torch.float32 else KEY_TILE)
    want = torch.autograd.grad(out, xs, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(x).all()) for x in got)
    for a, w in zip(got, want):
        if dtype == torch.float32:
            err = (a - w).abs().max().item()
            assert err <= BWD_F32_TOL * w.abs().max().item()
        else:
            mx, mean = bf16_grad_disagreement(a, w)
            assert mx <= BWD_BF16_MAX and mean <= BWD_BF16_MEAN


@pytest.mark.gpu
def test_gpu_vlm_gradient_matches_cpu():
    """A reduced f32 VLM (GQA 4:1, remat on, norms seeded): ``Model.loss``
    and every gradient leaf on the card against the CPU within
    ``CARD_TOL`` of each leaf's largest magnitude, with two flash forward
    launches a layer (remat's recompute) and one backward call."""
    _needs_card()
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                              n_kv_heads=1, remat=True)
    tp = Model(cfg, device="cpu").init(0)
    _smoke()._seed_leaves(torch, tp, SEEDED)
    batch = _pipe(cfg, seed=5).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        live = tree_map(lambda p: p.detach().to(dev).requires_grad_(), tp)
        n0 = (flash_attention_kernel.launches,
              flash_attention_bwd_kernel.launches)
        loss, _ = Model(cfg, device=dev).loss(live, batch)
        grads = torch.autograd.grad(loss, leaves(live))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (flash_attention_kernel.launches - n0[0],
                    flash_attention_bwd_kernel.launches - n0[1]) == \
                (2 * cfg.n_layers, cfg.n_layers)
        out[dev] = (float(loss), [x.cpu() for x in grads])
    (lc, gc_), (lg, gg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, w in zip(gg, gc_):
        assert (a - w).abs().max() <= CARD_TOL * w.abs().max()


@pytest.mark.gpu
def test_gpu_rope_matches_cpu_at_long_positions():
    """``rope`` on the card rotates by the CPU's frequency table: at heads
    of 128 over the train cell's 4096 positions (theta 1e4) the card's q
    is the CPU's within 1e-6 of its largest magnitude (cos and sin of the
    same f32 angles); a table from the card's own ``expf`` would move the
    angles at p ~ 3000 by p times its last-bit differences, 2e-4 of q."""
    _needs_card()
    from repro_torch.nn.layers import rope
    q = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 4096, 8, 128)).astype(np.float32))
    pos = torch.arange(4096)[None, :]
    want = rope(q, pos)
    got = rope(q.cuda(), pos.cuda()).cpu()
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
