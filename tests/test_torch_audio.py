"""repro_torch's audio family (whisper-base: an encoder-decoder over stub
frame embeddings) against the JAX package on the CPU, on the reduced
config (4 decoder layers with cross-attention, 2 encoder layers, d_model
64, 4 heads of 16, vocab 256, 24 frames) with seeded numpy inputs.  The
reference's init sets every norm (ln1, ln_x, ln2, enc_norm, final_norm)
to zeros, which would let a swapped norm pass; so the parameters here are
the reference's init with every norm leaf overwritten by seeded values,
carried across with ``params_from_jax``.

- the config and ``params_count`` are the reference's, full and reduced;
  the init tree's paths and shapes are the reference's;
- ``kv_proj`` and ``attention_seq(kv_override=...)`` within 1e-5 of max
  |y| in f32, with and without the QKV bias, non-causal whatever
  ``causal`` says;
- ``_encode_audio`` and ``Model.loss`` within 1e-5 in f32 and 2e-2
  relative in bf16; ``prefill``'s logits and its four cache leaves within
  1e-5;
- decode token by token from ``init_cache(B, S + 4)`` with the prefill's
  cross leaves, then greedy, within the reference test's 2e-4 at every
  step with equal greedy tokens; decode after a padded prefill against a
  longer prefill;
- the int8-PoT tree, ``quantizable_paths``, ``quant_bytes`` and the
  serving ledger equal to the reference's;
- ``ReferenceEngine`` and the launcher fail with ``KeyError: 'frames'`` in
  both packages (the reference's engine prefills tokens only);
  ``ServeEngine``, chunked prefill and block-paged decode refuse the
  family.

The ``gpu`` tests (they skip without a card) hold the flash kernel against
its plain version at whisper-base's shapes (the encoder's 1500 x 1500
MHA, cross-attention of 448 tokens against 1500 frames, the decoder's
causal 448), f32 within 2e-5 and bf16 under ``bf16_disagreement``, and
a reduced f32 whisper on the card against the CPU."""
import dataclasses

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.launch import serve as jlaunch_serve
    from repro.nn import Model as JModel
    from repro.nn import blocks as jblocks
    from repro.nn import get_config as jget_config
    from repro.quant import ptq as jptq
    from repro.runtime.serve import ReferenceEngine as JReferenceEngine
    from repro.runtime.serve import Request as JRequest
except ImportError:
    jax = None
from repro_torch.kernels.flash_attention import (BF16_SHARE, KEY_TILE,
                                                 bf16_disagreement,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import Model, blocks, get_config, params_from_jax
from repro_torch.quant import ptq
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

ARCH = "whisper-base"
TOL = 1e-5          # one forward, f32 sums in another order
BF16_REL = 2e-2     # x max |reference|: bf16 activations, another order
DECODE_TOL = 2e-4   # tests/test_models.py::test_prefill_decode_consistency
FLASH_F32_TOL = 2e-5
WHISPER_PARAMS = 109_749_248    # leaves of the reference's Model.init
B, S = 2, 10


def _seed_norms(tree, rng):
    """Every norm leaf (ln1, ln_x, ln2, enc_norm, final_norm) of a numpy
    tree drawn from ``rng``; the rest unchanged."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _seed_norms(val, rng)
        elif key.startswith("ln") or key.endswith("norm"):
            out[key] = rng.normal(0.0, 0.3, val.shape).astype(np.float32)
        else:
            out[key] = val
    return out


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jget_config(ARCH).reduced(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).reduced(), dtype=dtype))


@pytest.fixture(scope="module")
def audio():
    jcfg, tcfg = _cfgs()
    jm = JModel(jcfg)
    npp = _seed_norms(jax.tree.map(np.asarray,
                                   jm.init(jax.random.PRNGKey(0))),
                      np.random.default_rng(0))
    jp = jax.tree.map(jnp.asarray, npp)
    tp = params_from_jax(npp, device="cpu")
    return jcfg, tcfg, jm, jp, Model(tcfg, device="cpu"), tp, npp


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _frames(seed, batch=B, n=24, d=64):
    return np.random.default_rng(seed).normal(0, 1, (batch, n, d)).astype(
        np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _layout(tree):
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def test_config_and_params_count():
    """The registered config is the reference's; ``params_count`` equals
    the reference's at full size and reduced, and the reference's init
    holds ``WHISPER_PARAMS`` leaves at full size."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    for ref, mine in ((jget_config(ARCH), get_config(ARCH)), _cfgs()):
        assert mine.params_count() == ref.params_count()
    shapes = jax.eval_shape(JModel(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes)) == WHISPER_PARAMS


def test_init_layout(audio):
    """The port's init has the reference's paths, shapes and f32 dtypes:
    ``enc_layers`` (ln1, ln2, attn, mlp), the cross ``layers`` (ln1,
    ln_x, ln2, attn, xattn, mlp), ``enc_norm``; ``params_from_jax``
    carries the tree unchanged."""
    _, tcfg, jm, _, tm, tp, npp = audio
    want = _layout(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    assert _layout(tm.init(0)) == want
    assert set(want) == {"embed", "final_norm", "lm_head", "enc_layers",
                         "layers", "enc_norm"}
    assert set(want["enc_layers"]) == {"ln1", "ln2", "attn", "mlp"}
    assert set(want["layers"]) == {"ln1", "ln_x", "ln2", "attn", "xattn",
                                   "mlp"}
    assert want["enc_layers"]["ln1"][0] == (tcfg.n_enc_layers, 64)
    assert _layout(tp) == want
    for key, val in _flat(npp).items():
        assert np.array_equal(_flat(tp)[key].numpy(), val), key


@pytest.mark.parametrize("bias", [False, True], ids=["no-bias", "bias"])
def test_kv_proj_and_cross_attention(audio, bias):
    """``kv_proj`` and cross-attention (``attention_seq`` with
    ``kv_override``: q unroped, non-causal even when asked for causal)
    within 1e-5 of max |y|; with the QKV bias, seeded biases."""
    jcfg, tcfg, _, _, _, _, npp = audio
    p = dict(_layer(npp["layers"]["xattn"], 1))
    if bias:
        jcfg = dataclasses.replace(jcfg, qkv_bias=True)
        tcfg = dataclasses.replace(tcfg, qkv_bias=True)
        rng = np.random.default_rng(5)
        for name in ("bq", "bk", "bv"):
            p[name] = rng.normal(0, 0.5, (64,)).astype(np.float32)
    x = np.random.default_rng(1).normal(0, 1, (B, S, 64)).astype(np.float32)
    src = _frames(2)
    tpp = params_from_jax(p, device="cpu")
    jk, jv = jblocks.kv_proj(p, jnp.asarray(src), jcfg)
    tk, tv = blocks.kv_proj(tpp, torch.from_numpy(src), tcfg)
    assert tuple(tk.shape) == (B, 24, 4, 16)
    for got, want in ((tk, jk), (tv, jv)):
        _close(got.numpy() / np.abs(want).max(),
               np.asarray(want) / np.abs(want).max())
    want = jblocks.attention_seq(p, jnp.asarray(x), jcfg, causal=False,
                                 kv_override=(jk, jv))
    scale = float(np.abs(want).max())
    for causal in (False, True):
        got = blocks.attention_seq(tpp, torch.from_numpy(x), tcfg,
                                   causal=causal, kv_override=(tk, tv))
        _close(got.numpy() / scale, np.asarray(want) / scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_and_loss_match_jax(audio, dtype):
    """The encoder output and ``Model.loss`` (xent; aux zero): f32 within
    1e-5, bf16 within 2e-2 of the reference's largest magnitude."""
    _, _, _, jp, _, tp, _ = audio
    jcfg, tcfg = _cfgs(dtype)
    jm, tm = JModel(jcfg), Model(tcfg, device="cpu")
    fr, toks = _frames(3), _tokens(4, (B, S))
    want = jm._encode_audio(jp, jnp.asarray(fr))
    got = tm._encode_audio(tp, fr)
    assert got.dtype == getattr(torch, dtype)
    batch = {"tokens": toks, "labels": _tokens(5, (B, S)), "frames": fr}
    jl, jmets = jm.loss(jp, batch)
    tl, tmets = tm.loss(tp, batch)
    assert set(jmets) == {"xent"} and float(tmets["aux"]) == 0.0
    assert float(tl) == float(tmets["xent"])
    if dtype == "float32":
        _close(got.numpy(), want)
        _close(float(tl), float(jl))
    else:
        assert _rel(got.float().numpy(), want.astype(jnp.float32)) \
            <= BF16_REL
        assert abs(float(tl) - float(jl)) <= BF16_REL * abs(float(jl))


def test_prefill_matches_jax(audio):
    """Logits and the four cache leaves: k (roped), v, cross_k, cross_v."""
    _, tcfg, jm, jp, tm, tp, _ = audio
    batch = {"tokens": _tokens(6, (B, S)), "frames": _frames(7)}
    jl, jc = jm.prefill(jp, batch)
    tl, tc = tm.prefill(tp, batch)
    _close(tl.numpy(), jl)
    assert set(tc) == set(jc) == {"k", "v", "cross_k", "cross_v"}
    L, H, hd = tcfg.n_layers, tcfg.n_kv_heads, tcfg.head_dim_
    assert tuple(tc["k"].shape) == (L, B, S, H, hd)
    assert tuple(tc["cross_k"].shape) == (L, B, tcfg.n_frames, H, hd)
    for key in jc:
        _close(tc[key].numpy(), jc[key])


def test_decode_token_by_token_matches_jax(audio):
    """From ``init_cache(B, S + 4)`` with the prefill's cross leaves: the
    prompt token by token, then 4 greedy tokens, in both packages; every
    step's logits within 2e-4 of the reference's, the last prompt step's
    within 2e-4 of the prefill's, the greedy tokens equal, and the cross
    leaves unchanged."""
    _, _, jm, jp, tm, tp, _ = audio
    toks = _tokens(8, (B, S))
    batch = {"tokens": toks, "frames": _frames(9)}
    jl_pf, jpc = jm.prefill(jp, batch)
    tl_pf, tpc = tm.prefill(tp, batch)
    jc, tc = jm.init_cache(B, S + 4), tm.init_cache(B, S + 4)
    jc["cross_k"], jc["cross_v"] = jpc["cross_k"], jpc["cross_v"]
    tc["cross_k"], tc["cross_v"] = tpc["cross_k"], tpc["cross_v"]
    jnext = tnext = None
    jgreedy, tgreedy = [], []
    for t in range(S + 4):
        jin = toks[:, t:t + 1] if t < S else jnext
        tin = toks[:, t:t + 1] if t < S else tnext
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(jin), jnp.int32(t))
        tlg, tc = tm.decode_step(tp, tc, tin, t)
        _close(tlg.numpy(), jlg, DECODE_TOL)
        if t == S - 1:
            _close(tlg.numpy(), jl_pf, DECODE_TOL)
            _close(tlg.numpy(), tl_pf.numpy(), DECODE_TOL)
        jnext = np.asarray(jlg).argmax(-1).astype(np.int32)
        tnext = tlg.numpy().argmax(-1).astype(np.int32)
        if t >= S - 1:
            jgreedy.append(jnext[:, 0].tolist())
            tgreedy.append(tnext[:, 0].tolist())
    assert tgreedy == jgreedy
    assert torch.equal(tc["cross_k"], tpc["cross_k"])
    assert torch.equal(tc["cross_v"], tpc["cross_v"])


def test_decode_after_padded_prefill(audio):
    """``prefill(S)`` with k and v padded to the context (cross leaves at
    n_frames), then token S decoded: within 2e-4 of ``prefill(S + 1)``'s
    logits."""
    _, _, _, _, tm, tp, _ = audio
    toks, fr = _tokens(10, (B, S + 1)), _frames(11)
    full = tm.prefill(tp, {"tokens": toks, "frames": fr})[0]
    _, cache = tm.prefill(tp, {"tokens": toks[:, :S], "frames": fr})
    for key in ("k", "v"):
        cache[key] = torch.nn.functional.pad(cache[key],
                                             (0, 0, 0, 0, 0, 6))
    got, cache = tm.decode_step(tp, cache, toks[:, S:], S)
    _close(got.numpy(), full.numpy(), DECODE_TOL)
    assert cache["k"].shape[2] == S + 6 and cache["cross_k"].shape[2] == 24


def test_quantized_tree_and_ledger_match_jax(audio):
    """The int8-PoT tree leaf for leaf (mantissas, exponents), the
    quantizable paths in order, ``quant_bytes``, the serving ledger and a
    prefill on the dequantized tree equal to the reference's; norms and
    ``wu`` stay float."""
    _, _, jm, jp, tm, tp, _ = audio
    jq = _flat(jax.tree.map(np.asarray, jptq.quantize_tree(jp, bits=8)))
    tq_tree = ptq.quantize_tree(tp, bits=8)
    tq = _flat(tq_tree)
    assert set(tq) == set(jq)
    for k, v in tq.items():
        if torch.is_tensor(v):
            np.testing.assert_array_equal(v.numpy(), jq[k], err_msg=k)
        else:
            assert v == jq[k], k
    floats = {k for k in tq if not k.endswith(("/q", "/exp", "/bits"))}
    assert floats == {"/final_norm", "/enc_norm", "/enc_layers/ln1",
                      "/enc_layers/ln2", "/enc_layers/mlp/wu",
                      "/layers/ln1", "/layers/ln_x", "/layers/ln2",
                      "/layers/mlp/wu"}
    assert "/layers/xattn/wq/q" in tq and "/enc_layers/attn/wk/q" in tq
    assert ptq.quantizable_paths(tp) == jptq.quantizable_paths(jp)
    assert ptq.quant_bytes(tq_tree) == jptq.quant_bytes(
        jptq.quantize_tree(jp, bits=8))
    for kw in (dict(bits=8), dict(bits=4), dict(bits=8, act_itemsize=4.0)):
        assert ptq.serving_ledger(tp, **kw).to_dict() == \
            jptq.serving_ledger(jp, **kw).to_dict()
    batch = {"tokens": _tokens(12, (B, S)), "frames": _frames(13)}
    want = jm.prefill(jptq.dequant(jptq.quantize_tree(jp, bits=8),
                                   dtype=jnp.float32), batch)[0]
    got = tm.prefill(ptq.dequant(tq_tree, dtype=torch.float32), batch)[0]
    _close(got.numpy(), want)


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_engines_fail_without_frames(audio, quantized):
    """Both packages' ``ReferenceEngine`` prefill tokens only, so an audio
    batch fails with ``KeyError: 'frames'`` and no token is served."""
    jcfg, tcfg, _, jp, _, tp, _ = audio
    for make, req in ((lambda: JReferenceEngine(jcfg, jp, eos_id=-1,
                                                quantized=quantized),
                       JRequest),
                      (lambda: ReferenceEngine(tcfg, tp, eos_id=-1,
                                               quantized=quantized,
                                               device="cpu"), Request)):
        reqs = [req(rid=0, prompt=_tokens(14, 5), max_new_tokens=3)]
        with pytest.raises(KeyError, match="frames"):
            make().run(reqs)
        assert reqs[0].out_tokens == []


@pytest.mark.parametrize("launcher", ["jax", "torch"])
def test_launchers_fail_without_frames(launcher):
    argv = ["--arch", ARCH, "--reduced", "--requests", "2", "--batch", "2",
            "--prompt-len", "4", "--max-new", "2", "--context", "16"]
    if launcher == "jax":
        main = jlaunch_serve.main
    else:
        main, argv = launch_serve.main, argv + ["--device", "cpu"]
    with pytest.raises(KeyError, match="frames"):
        main(argv)


def test_paged_paths_refuse_audio(audio):
    """As in the reference: ServeEngine, chunked prefill and block-paged
    decode refuse the family."""
    _, tcfg, _, _, tm, tp, _ = audio
    with pytest.raises(NotImplementedError):
        ServeEngine(tcfg, tp, device="cpu")
    with pytest.raises(NotImplementedError):
        tm.prefill_chunks(tp, tm.init_cache(1, 8), _tokens(0, (1, 4)), [0],
                          [0], [4])
    with pytest.raises(NotImplementedError):
        tm.decode_step(tp, tm.init_cache(1, 8), _tokens(0, (1, 1)),
                       np.zeros(1, np.int32),
                       block_table=np.zeros((1, 1), np.int32))


def test_audio_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        Model(get_config(ARCH).reduced())
    with pytest.raises(RuntimeError):
        Model(get_config(ARCH))
    Model(get_config(ARCH).reduced(), device="cpu")


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("Sq,Skv,causal", [
    (1500, 1500, False),    # the encoder's self-attention
    (448, 1500, False),     # cross-attention: decoder tokens to frames
    (448, 448, True),       # the decoder's self-attention
    (5, 1500, False), (1, 1500, False), (33, 70, False)])
def test_gpu_flash_at_audio_shapes(Sq, Skv, causal, dtype):
    """8 / 8 heads of 64 at batch 4, offset 0 as ``chunked_attention``
    passes it: f32 within 2e-5, bf16 under ``bf16_disagreement`` at
    ``KEY_TILE``; one launch a call."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(Sq + Skv)
    q, k, v = (torch.randn(s, generator=g, device="cuda", dtype=dtype)
               for s in ((4, Sq, 8, 64), (4, Skv, 8, 64), (4, Skv, 8, 64)))
    kw = dict(causal=causal, offset=0,
              bk=512 if dtype == torch.float32 else KEY_TILE)
    n0 = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert torch.allclose(got, want, atol=FLASH_F32_TOL,
                              rtol=FLASH_F32_TOL)
    else:
        ratio, share = bf16_disagreement(got, want)
        assert ratio <= 1 and share <= BF16_SHARE


@pytest.mark.gpu
def test_gpu_whisper_matches_cpu():
    """A reduced f32 whisper on the card: 10 flash launches a forward (2
    encoder layers, 4 x (self + cross)) and none a decode step; its loss
    and prefill logits the CPU's within 1e-5 relative, decode after a
    padded prefill the CPU's within 2e-4."""
    _needs_card()
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    tp = Model(cfg, device="cpu").init(0)
    toks, fr = _tokens(15, (B, S + 1)), _frames(16)
    per_forward = cfg.n_enc_layers + 2 * cfg.n_layers
    out = {}
    for dev in ("cpu", "cuda"):
        m, p = Model(cfg, device=dev), _to(tp, dev)
        n0 = flash_attention_kernel.launches
        loss = float(m.loss(p, {"tokens": toks, "labels": toks,
                                "frames": fr})[0])
        logits, cache = m.prefill(p, {"tokens": toks[:, :S], "frames": fr})
        n1 = flash_attention_kernel.launches
        for key in ("k", "v"):
            cache[key] = torch.nn.functional.pad(cache[key],
                                                 (0, 0, 0, 0, 0, 4))
        step = m.decode_step(p, cache, toks[:, S:], S)[0]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert n1 - n0 == 2 * per_forward
            assert flash_attention_kernel.launches == n1
        out[dev] = (loss, logits.cpu().numpy(), step.cpu().numpy())
    (lc, pc, sc), (lg, pg, sg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= TOL * abs(lc)
    assert _rel(pg, pc) <= TOL
    _close(sg, sc, DECODE_TOL)
