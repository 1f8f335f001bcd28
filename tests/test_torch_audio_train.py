"""Audio training (whisper-base: an encoder over stub frame embeddings and
a decoder with cross-attention to its output) in repro_torch against the
JAX package on the CPU, on the reduced config (2 encoder and 4 decoder
layers, d_model 64, 4 / 4 heads of 16, vocab 256, 24 frames) in f32.  The
reference's init zeros every norm (ln1, ln_x, ln2, enc_norm,
final_norm), which would let a swapped or misaxed norm pass, so they are
drawn from a seeded generator and carried across with
``params_from_jax``.

Neither train launcher feeds frames, so the audio model trains through
``make_train_step`` and ``TrainLoop`` on batches laid out by the train
cell's ``launch/specs.py::input_specs``: ``chip_smoke.py``'s
``SpecBatches`` (tokens and labels of ``TokenPipeline``, f32 frames from a
numpy generator seeded by (seed, step)), which phase 20 feeds
whisper-base at full width and depth.

- ``SpecBatches`` laid out as ``input_specs`` for the audio config, and
  for the VLM bit for bit the stream of the ``VlmBatches`` it replaced;
- ``chip_smoke.audio_leaves`` against the reference's ``eval_shape``;
- ``Model.loss`` and every gradient leaf (encoder, cross-attention and
  ``enc_norm`` among them) within 2e-5 of each leaf's largest magnitude
  of ``jax.value_and_grad`` of the reference's, remat on and off;
- three ``make_train_step`` steps against the reference's jitted step
  (loss, grad norm and xent within 1e-5 relative each step; each leaf's
  update within 2^-6 of its largest element); a ``TrainLoop`` restart
  leaf for leaf; an audio checkpoint read across the packages bit for
  bit;
- both train launchers failing with ``KeyError: 'frames'``.

The ``gpu`` tests (they skip without a card) hold the flash backward at
small MHA layouts of whisper's kinds, D = 64 -- non-causal self-attention,
cross-attention with more queries than keys (query row 0 at a negative
key position), causal self-attention -- against autograd through the
plain version, f32 and bf16, and a reduced f32 whisper train step card
against CPU."""
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
    from repro.ckpt import CheckpointManager as JCheckpointManager
    from repro.launch import train as jlaunch_train
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.optim import adamw as jadamw
    from repro.runtime.step import make_train_step as jmake_train_step
except ImportError:
    jax = None
from repro_torch.ckpt import CheckpointManager
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    BWD_BF16_MAX, BWD_BF16_MEAN, BWD_F32_TOL, KEY_TILE,
    bf16_grad_disagreement, flash_attention_bwd_kernel,
    flash_attention_kernel, flash_attention_plain)
from repro_torch.launch import specs
from repro_torch.launch import train as launch_train
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.nn.types import SHAPES, ShapeSpec
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.step import make_train_step
from repro_torch.runtime.train import TrainConfig, TrainLoop
from repro_torch.tree import flatten_with_path, leaves, tree_map

ARCH = "whisper-base"
TOL = 2e-5          # each gradient leaf, x its largest magnitude
REL = 1e-5          # loss, grad norm, xent: the same graph in another order
CARD_TOL = 1e-4     # chip_smoke.TRAIN_GRAD_TOL: card against CPU
B, T = 2, 16        # rows, tokens beside the reduced config's 24 frames
SHAPE = ShapeSpec("reduced", T, B, "train")
NORMS = ("ln1", "ln_x", "ln2", "enc_norm", "final_norm")
LR = 1e-3


@functools.lru_cache(maxsize=None)
def _smoke():
    """``chip_smoke.py``, loaded by path (it is no package)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfgs(**kw):
    """(reference, port) reduced configs in f32."""
    return tuple(dataclasses.replace(get(ARCH).reduced(), dtype="float32",
                                     **kw)
                 for get in (jget_config, get_config))


def _pipe(cfg, seed=0, rows=B):
    return _smoke().SpecBatches(cfg, SHAPE, rows, seed=seed)


@functools.lru_cache(maxsize=None)
def _np_params(seed=0):
    """The reference's init tree (numpy) with every norm leaf drawn from a
    seeded generator."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else
                rng.normal(0.0, 0.3, v.shape).astype(np.float32)
                if k in NORMS else v for k, v in t.items()}
    return walk(jax.tree.map(np.asarray, JModel(_cfgs()[0]).init(
        jax.random.PRNGKey(seed))))


def _both(seed=0):
    npp = _np_params(seed)
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


# ------------------------------------------------------------ the batches

class _OldVlmBatches:
    """``chip_smoke.VlmBatches`` as it was before ``SpecBatches`` replaced
    it: the stream phase 19 fed llava-next-34b."""

    def __init__(self, vocab, batch, seq, n_patches, seed=0):
        from repro_torch.data.tokens import TokenPipeline
        self.text = TokenPipeline(vocab=vocab, seq_len=seq - n_patches,
                                  global_batch=batch, seed=seed)
        self.n_patches, self.seed = n_patches, seed

    def batch(self, step):
        out = self.text.batch(step)
        rng = np.random.default_rng((self.seed, step))
        out["patch_embeds"] = rng.standard_normal(
            (self.text.local_batch, self.n_patches, 1024), dtype=np.float32)
        return out


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "phase19"])
def test_spec_batches_replay_the_vlm_stream(full):
    """For llava-next-34b ``SpecBatches`` is the old ``VlmBatches`` stream
    bit for bit: phase 19's (2 rows at the train cell, 2880 patches and
    1216 tokens) and the reduced config's, seeds 0 and 3, steps 0-2."""
    cfg = get_config("llava-next-34b")
    if full:
        shape, rows = SHAPES["train_4k"], 2
    else:
        cfg = cfg.reduced()
        shape, rows = ShapeSpec("reduced", cfg.n_patches + 24, 2, "train"), 2
    for seed in (0, 3):
        new = _smoke().SpecBatches(cfg, shape, rows, seed=seed)
        old = _OldVlmBatches(cfg.vocab, rows, shape.seq_len, cfg.n_patches,
                             seed=seed)
        for step in range(3):
            a, b = new.batch(step), old.batch(step)
            assert list(a) == list(b)
            for key in a:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "train_4k"])
def test_spec_batches_follow_input_specs_for_audio(full):
    """For whisper-base ``SpecBatches`` holds the keys and shapes of
    ``input_specs`` (frames (B, n_frames, d_model) beside tokens and labels
    of ``seq_len``): ``TokenPipeline``'s tokens and labels (int32), frames
    drawn in f32, the same for the same step and other for another."""
    from repro_torch.data.tokens import TokenPipeline
    cfg = get_config(ARCH)
    shape, rows = (SHAPES["train_4k"], 2) if full else (SHAPE, B)
    if not full:
        cfg = cfg.reduced()
    pipe = _smoke().SpecBatches(cfg, shape, rows, seed=5)
    want = specs.input_specs(cfg, dataclasses.replace(shape,
                                                      global_batch=rows))
    b = pipe.batch(4)
    assert set(b) == set(want) == {"frames", "tokens", "labels"}
    for key, spec in want.items():
        assert b[key].shape == tuple(spec.shape), key
    assert b["frames"].shape == (rows, cfg.n_frames, cfg.d_model)
    assert b["frames"].dtype == np.float32
    text = TokenPipeline(vocab=cfg.vocab, seq_len=shape.seq_len,
                         global_batch=rows, seed=5).batch(4)
    for key in ("tokens", "labels"):
        assert b[key].dtype == np.int32
        np.testing.assert_array_equal(b[key], text[key])
    np.testing.assert_array_equal(pipe.batch(4)["frames"], b["frames"])
    assert not np.array_equal(pipe.batch(5)["frames"], b["frames"])


@pytest.mark.parametrize("reduced", [False, True])
def test_audio_leaves_match_reference(reduced):
    """``chip_smoke.audio_leaves`` is the leaf count of the reference's
    ``Model.init`` by ``eval_shape``; whisper-base's is ``AUD_PARAMS``,
    and phase 20 counts 36 flash forward and 18 backward calls a step."""
    smoke = _smoke()
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    shapes = jax.eval_shape(lambda: JModel(jcfg).init(jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert smoke.audio_leaves(cfg) == want
    if not reduced:
        assert want == smoke.AUD_PARAMS
        assert smoke.audio_flash_calls(cfg) == (36, 18)


# ------------------------------------------------------- loss and grads

@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradient_match_jax(remat):
    """f32: the loss within 1e-5 relative and every gradient leaf -- the
    encoder's layers and ``enc_norm``, each decoder layer's self- and
    cross-attention (``kv_proj`` of the encoder output) and MLP, the norms,
    the embedding and the head -- within 2e-5 of its largest magnitude of
    ``jax.value_and_grad`` of the reference's ``Model.loss``, with and
    without per-layer remat."""
    jcfg, tcfg = _cfgs(remat=remat)
    jp, tp = _both()
    batch = _pipe(tcfg).batch(0)
    (jl, _), jg = _jax_value_and_grad(jcfg)(
        jp, jax.tree.map(jnp.asarray, batch))
    live = tree_map(lambda p: p.detach().clone().requires_grad_(), tp)
    tl, _ = Model(tcfg, device="cpu").loss(live, batch)
    got = torch.autograd.grad(tl, leaves(live))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=REL)
    it = iter(got)
    want = _assert_leaves_close(tree_map(lambda _: next(it), live), jg)
    for path in (("enc_norm",), ("enc_layers", "attn", "wq"),
                 ("layers", "xattn", "wk"), ("layers", "xattn", "wq"),
                 ("layers", "ln_x"), ("final_norm",)):
        assert np.abs(want[path]).max() > 0, path


# ------------------------------------------------------------ the trainer

def test_train_step_matches_jax():
    """Three steps of ``make_train_step`` (AdamW, clip 1.0, remat on) on
    ``SpecBatches`` against the reference's jitted step: loss, grad norm
    and xent within 1e-5 relative each step, and each leaf's update
    (params after the 3 steps less before) within 2^-6 of its largest
    element, as ``tests/test_torch_train.py`` holds the dense model --
    but where the reference's first gradient is below 100 eps, within 2
    lr a step: Adam's first step is sign-like there, so f32 noise in such
    a gradient element can turn its update (one encoder ``wv`` element
    here, |g| 3e-9), as ``tests/test_torch_vlm_train.py`` states; such
    elements, zeros aside, at most 5 % of a leaf."""
    jcfg, tcfg = _cfgs(remat=True)
    jp, tp = _both(seed=1)
    pipe = _pipe(tcfg, seed=1)
    before = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    grad = dict(flatten_with_path(jax.tree.map(
        np.asarray, _jax_value_and_grad(jcfg)(
            jp, jax.tree.map(jnp.asarray, pipe.batch(0)))[1])))
    jopt, topt = jadamw.AdamW(lr=LR), AdamW(lr=LR)
    jstep = jax.jit(jmake_train_step(JModel(jcfg), jopt))
    tstep = make_train_step(Model(tcfg, device="cpu"), topt)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        batch = pipe.batch(i)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, batch)
        for key in ("loss", "grad_norm", "xent"):
            assert float(tm[key]) == pytest.approx(float(jm[key]),
                                                   rel=REL), (i, key)
    after = dict(flatten_with_path(jax.tree.map(np.asarray, jp)))
    for path, t in flatten_with_path(tp):
        want = after[path] - before[path]
        err = np.abs(t.numpy() - before[path] - want)
        near0 = np.abs(grad[path]) < 100 * jopt.eps
        assert err[~near0].max(initial=0.0) <= 2 ** -6 * np.abs(want).max(), \
            path
        assert err[near0].max(initial=0.0) <= 3 * 2 * LR, path
        assert np.count_nonzero(grad[path][near0]) <= 0.05 * near0.size, \
            path
    assert int(ts["count"]) == 3


def test_restart_replays_the_run(tmp_path):
    """``TrainLoop`` with a checkpoint every 4 steps and a failure injected
    at step 6 restores step 4 and replays the ``SpecBatches`` stream from
    step 5: every final leaf, params and optimizer state, and the loss of
    every step equal bit for bit to an uninterrupted run's."""
    _, tcfg = _cfgs(remat=True)
    tp = Model(tcfg, device="cpu").init(0)
    fired = []

    def fail_once(step):
        if step == 6 and not fired:
            fired.append(step)
            raise RuntimeError("simulated node failure")

    ends, losses, restarts = [], [], []
    for hook in (None, fail_once):
        opt = AdamW(lr=1e-3)
        loop = TrainLoop(
            TrainConfig(total_steps=8, ckpt_every=4, log_every=1,
                        ckpt_dir=str(tmp_path / str(len(ends)))),
            make_train_step(Model(tcfg, device="cpu"), opt),
            _pipe(tcfg, 4), failure_hook=hook)
        p, o = loop.run(tree_map(torch.clone, tp), opt.init(tp))
        ends.append(leaves({"p": p, "o": o}))
        losses.append({r["step"]: r["loss"] for r in loop.metrics_log
                       if "loss" in r})
        restarts.append(loop.restarts)
    assert restarts == [0, 1] and fired == [6]
    assert losses[0] == losses[1] and sorted(losses[0]) == list(range(8))
    assert len(ends[0]) == len(ends[1])
    assert all(torch.equal(a, b) for a, b in zip(*ends))


def test_audio_checkpoint_moves_between_packages(tmp_path):
    """An f32 checkpoint of whisper's {params, AdamW state} -- ``enc_layers``
    and ``enc_norm`` among its leaves -- written by the reference restores
    in the port bit for bit, keys and all, and the port's in the
    reference."""
    jp, tp = _both(seed=3)
    jstate = {"params": jp, "opt": jadamw.AdamW().init(jp)}
    tstate = {"params": tp, "opt": AdamW().init(tp)}
    JCheckpointManager(str(tmp_path / "j")).save(5, jstate, extra={"a": 1})
    got, step, extra = CheckpointManager(str(tmp_path / "j")).restore(tstate)
    assert step == 5 and extra == {"a": 1}
    want = dict(flatten_with_path(jax.tree.map(np.asarray, jstate)))
    assert set(want) == set(dict(flatten_with_path(got)))
    assert ("params", "enc_layers", "attn", "wq") in want
    for path, t in flatten_with_path(got):
        np.testing.assert_array_equal(t.numpy(), want[path])
        assert t.numpy().dtype == want[path].dtype
    CheckpointManager(str(tmp_path / "t")).save(6, tstate)
    back, step, _ = JCheckpointManager(str(tmp_path / "t")).restore(jstate)
    assert step == 6
    mine = dict(flatten_with_path(tstate))
    for path, a in flatten_with_path(jax.tree.map(np.asarray, back)):
        np.testing.assert_array_equal(a, mine[path].numpy())


@pytest.mark.parametrize("launcher", ["jax", "torch"])
def test_train_launchers_fail_without_frames(launcher, tmp_path):
    """Both train launchers feed ``TokenPipeline`` batches, tokens and
    labels only, so the audio model's loss fails with ``KeyError:
    'frames'`` (after the loop's restarts) and no step is taken."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--ckpt-dir", str(tmp_path)]
    main = jlaunch_train.main if launcher == "jax" else launch_train.main
    if launcher == "torch":
        argv += ["--device", "cpu"]
    with pytest.raises(KeyError, match="frames"):
        main(argv)
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", [
    (2, 300, 300, False),       # the encoder's: non-causal, ragged tiles
    (2, 333, 150, False),       # cross: more queries than keys, offset < 0
    (2, 257, 257, True)],       # the decoder's causal self-attention
    ids=["encoder", "cross", "decoder"])
def test_gpu_flash_backward_at_whisper_layouts(layout, dtype):
    """Row 4b at 8 / 8 heads of 64 in whisper's three kinds of attention,
    through ``FlashAttention`` as the model calls it (query row 0 at key
    position Skv - Sq) against autograd through the plain version: f32
    within ``BWD_F32_TOL`` of each gradient's largest magnitude, bf16
    under ``bf16_grad_disagreement``; one backward call, two calls
    bit-identical."""
    _needs_card()
    Bq, Sq, Skv, causal = layout
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv)
    q, k, v, dout = (torch.randn(s, generator=g, device="cuda", dtype=dtype)
                     for s in ((Bq, Sq, 8, 64), (Bq, Skv, 8, 64),
                               (Bq, Skv, 8, 64), (Bq, Sq, 8, 64)))

    def kernel_grads():
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*xs, causal=causal)
        return torch.autograd.grad(out, xs, dout)

    n0 = flash_attention_bwd_kernel.launches
    got = kernel_grads()
    torch.cuda.synchronize()
    assert flash_attention_bwd_kernel.launches == n0 + 1
    again = kernel_grads()
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    out = flash_attention_plain(
        *xs, causal=causal,
        bk=256 if dtype == torch.float32 else KEY_TILE)
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
def test_gpu_audio_train_step_matches_cpu():
    """A reduced f32 whisper (remat on, norms seeded): one
    ``make_train_step`` step on the card against the CPU -- loss, grad norm
    and xent within 1e-5 relative, every leaf of AdamW's m (the clipped
    gradient's share) within ``CARD_TOL`` of its largest magnitude and of
    v within twice that -- with 2 flash forward launches (remat's
    recompute) and 1 backward call for each encoder layer and each
    decoder layer's self- and cross-attention.  The parameters are not
    compared: Adam's first step is sign-like, so a gradient element near 0
    may move its parameter by +-lr on either device."""
    _needs_card()
    _, cfg = _cfgs(remat=True)
    tp = Model(cfg, device="cpu").init(0)
    _smoke()._seed_leaves(torch, tp, NORMS)
    batch = _pipe(cfg, seed=5).batch(0)
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda p: p.detach().clone().to(dev), tp)
        opt = AdamW(lr=1e-3)
        n0 = (flash_attention_kernel.launches,
              flash_attention_bwd_kernel.launches)
        params, state, mets = make_train_step(Model(cfg, device=dev), opt)(
            params, opt.init(params), batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            n = cfg.n_enc_layers + 2 * cfg.n_layers
            assert (flash_attention_kernel.launches - n0[0],
                    flash_attention_bwd_kernel.launches - n0[1]) == (2 * n, n)
        out[dev] = ({k: float(v) for k, v in mets.items()},
                    {name: [x.cpu() for x in leaves(state[name])]
                     for name in ("m", "v")})
    (mc, sc), (mg, sg) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm", "xent"):
        assert mg[key] == pytest.approx(mc[key], rel=REL), key
    for name, tol in (("m", CARD_TOL), ("v", 2 * CARD_TOL)):
        assert len(sg[name]) == len(sc[name]) == len(leaves(tp))
        for a, w in zip(sg[name], sc[name]):
            assert (a - w).abs().max() <= tol * w.abs().max(), name
