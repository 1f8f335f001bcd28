"""repro_torch's VLM family (llava-next-34b: a decoder over projected patch
embeddings put in front of the tokens) against the JAX package on the
CPU, on the reduced config (4 layers, d_model 64, 4 / 4 heads of 16, vocab
256, 8 patches) and on its GQA variant (4 / 1 heads: the reduced config
is MHA, which would hide a grouping fault), with seeded numpy inputs.  The
reference's init sets every norm (ln1, ln2, final_norm) to zeros, which
would let a swapped norm pass; so the parameters here are the reference's
init with every norm leaf overwritten by seeded values, carried across
with ``params_from_jax``.

- the config and ``params_count`` are the reference's, full and reduced;
  the init tree's paths and shapes are the reference's, ``vision_proj``
  among them;
- ``_embed_inputs`` gives the reference's x, labels and mask (zeros over
  the patches), with and without labels;
- ``Model.loss`` within 1e-5 in f32 and 2e-2 relative in bf16, the mean
  over the text positions only; ``prefill``'s logits and its K/V cache
  (roped at 0..P+T-1) within 1e-5;
- decode after a prefill padded to the context, 4 greedy tokens at
  positions P + T + t, within the reference test's 2e-4 of the
  reference's ``decode_step`` at every step with equal greedy tokens; f32
  decode after a padded prefill against a longer prefill;
- the int8-PoT tree (``vision_proj`` quantized), ``quantizable_paths``,
  ``quant_bytes`` and the serving ledger equal to the reference's;
- ``ReferenceEngine`` and the launcher fail with ``KeyError:
  'patch_embeds'`` in both packages (the reference's engine prefills
  tokens only); ``ServeEngine``, chunked prefill and block-paged decode
  refuse the family in both.

The ``gpu`` tests (they skip without a card) hold the flash kernel against
its plain version at llava-next-34b's shapes (56 / 8 heads of 128, causal,
over the 2880 patches and the prompt), f32 within 2e-5 and bf16 under
``bf16_disagreement``, and a reduced f32 VLM on the card against the
CPU."""
import dataclasses

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.launch import serve as jlaunch_serve
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.quant import ptq as jptq
    from repro.runtime.serve import ReferenceEngine as JReferenceEngine
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeEngine as JServeEngine
except ImportError:
    jax = None
from repro_torch.kernels.flash_attention import (BF16_SHARE, KEY_TILE,
                                                 bf16_disagreement,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.quant import ptq
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

ARCH = "llava-next-34b"
TOL = 1e-5          # one forward, f32 sums in another order
BF16_REL = 2e-2     # x max |reference|: bf16 activations, another order
DECODE_TOL = 2e-4   # tests/test_models.py::test_prefill_decode_consistency
FLASH_F32_TOL = 2e-5
LLAVA_PARAMS = 34_396_257_280   # leaves of the reference's Model.init
LLAVA_COUNT = 33_930_165_248    # its params_count(): V x d once, no
B, S, P = 2, 10, 8              # vision_proj


def _seed_norms(tree, rng):
    """Every norm leaf (ln1, ln2, final_norm) of a numpy tree drawn from
    ``rng``; the rest unchanged."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _seed_norms(val, rng)
        elif key.startswith("ln") or key.endswith("norm"):
            out[key] = rng.normal(0.0, 0.3, val.shape).astype(np.float32)
        else:
            out[key] = val
    return out


def _cfgs(variant="reduced", dtype="float32"):
    """(reference, port) configs: the reduced one, or its GQA variant."""
    kv = dict(n_kv_heads=1) if variant == "gqa" else {}
    return tuple(dataclasses.replace(get(ARCH).reduced(), dtype=dtype, **kv)
                 for get in (jget_config, get_config))


@pytest.fixture(scope="module", params=["reduced", "gqa"])
def vlm(request):
    jcfg, tcfg = _cfgs(request.param)
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


def _patches(seed, batch=B, n=P):
    return np.random.default_rng(seed).normal(0, 1, (batch, n, 1024)) \
        .astype(np.float32)


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


def _pad_kv(cache, extra, pad):
    """k and v of a prefill cache grown by ``extra`` positions."""
    return {key: pad(val, extra) for key, val in cache.items()}


def _pad_torch(t, extra):
    return torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra))


def _pad_jax(t, extra):
    return jnp.pad(t, ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0)))


def test_config_and_params_count():
    """The registered config is the reference's; ``params_count`` equals
    the reference's at full size, reduced and GQA; the reference's init
    holds ``LLAVA_PARAMS`` leaves at full size, and its ``params_count``
    leaves out ``vision_proj`` and counts V x d once."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(ARCH))
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.vocab, cfg.n_patches) == \
        ("vlm", 60, 7168, 56, 8, 20480, 64000, 2880)
    pairs = [(jget_config(ARCH), cfg), _cfgs("reduced"), _cfgs("gqa")]
    for ref, mine in pairs:
        assert mine.params_count() == ref.params_count()
    assert cfg.params_count() == LLAVA_COUNT
    shapes = jax.eval_shape(JModel(jget_config(ARCH)).init,
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes)) == LLAVA_PARAMS
    d, V = cfg.d_model, cfg.vocab
    assert LLAVA_PARAMS - LLAVA_COUNT == V * d + 1024 * d


def test_init_layout(vlm):
    """The port's init has the reference's paths, shapes and f32 dtypes:
    the dense decoder's ``layers`` (ln1, ln2, attn, mlp) and
    ``vision_proj`` (1024, d); ``params_from_jax`` carries the tree
    unchanged."""
    _, tcfg, jm, _, tm, tp, npp = vlm
    want = _layout(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    assert _layout(tm.init(0)) == want
    assert set(want) == {"embed", "final_norm", "lm_head", "layers",
                         "vision_proj"}
    assert set(want["layers"]) == {"ln1", "ln2", "attn", "mlp"}
    assert want["vision_proj"] == ((1024, 64), "float32")
    assert want["layers"]["attn"]["wk"][0] == (
        tcfg.n_layers, 64, tcfg.n_kv_heads * tcfg.head_dim_)
    assert _layout(tp) == want
    for key, val in _flat(npp).items():
        assert np.array_equal(_flat(tp)[key].numpy(), val), key


@pytest.mark.parametrize("labels", [False, True], ids=["prefill", "loss"])
def test_embed_inputs_match_jax(vlm, labels):
    """x (the projected patches, then the token embeddings), and with
    labels the labels and mask, both zero over the patches."""
    _, _, jm, jp, tm, tp, _ = vlm
    batch = {"tokens": _tokens(1, (B, S)), "patch_embeds": _patches(2)}
    if labels:
        batch["labels"] = _tokens(3, (B, S))
    jx, jl, jmask = jm._embed_inputs(jp, batch)
    tx, tl, tmask = tm._embed_inputs(tp, batch)
    assert tuple(tx.shape) == (B, P + S, 64)
    _close(tx.numpy(), jx)
    if not labels:
        assert jl is jmask is tl is tmask is None
        return
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tmask[:, :P].sum() == 0 and bool((tmask[:, P:] == 1).all())
    np.testing.assert_array_equal(tl[:, P:].numpy(), batch["labels"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_jax(vlm, dtype):
    """``Model.loss`` (xent; aux zero): f32 within 1e-5, bf16 within 2e-2
    relative; the mean counts the S text positions of each row only."""
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in vlm[:2])
    jp, tp = vlm[3], vlm[5]
    jm, tm = JModel(jcfg), Model(tcfg, device="cpu")
    batch = {"tokens": _tokens(4, (B, S)), "labels": _tokens(5, (B, S)),
             "patch_embeds": _patches(6)}
    jl, jmets = jm.loss(jp, batch)
    tl, tmets = tm.loss(tp, batch)
    assert float(tmets["aux"]) == 0.0 and float(tl) == float(tmets["xent"])
    if dtype == "float32":
        _close(float(tl), float(jl))
        x, labels, mask = tm._embed_inputs(tp, batch)
        x, _ = tm._backbone(tp, x)
        logits = (x @ tp["lm_head"]).float()[:, P:]
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels[:, P:, None])[..., 0]
        _close(float(tl), float(nll.mean()))
    else:
        assert abs(float(tl) - float(jl)) <= BF16_REL * abs(float(jl))


def test_prefill_matches_jax(vlm):
    """Logits and the K/V cache, (L, B, P + S, Hkv, hd), K roped at
    positions 0..P+S-1."""
    _, tcfg, jm, jp, tm, tp, _ = vlm
    batch = {"tokens": _tokens(7, (B, S)), "patch_embeds": _patches(8)}
    jl, jc = jm.prefill(jp, batch)
    tl, tc = tm.prefill(tp, batch)
    _close(tl.numpy(), jl)
    assert set(tc) == set(jc) == {"k", "v"}
    assert tuple(tc["k"].shape) == (tcfg.n_layers, B, P + S,
                                    tcfg.n_kv_heads, tcfg.head_dim_)
    for key in jc:
        _close(tc[key].numpy(), jc[key])


def test_decode_after_prefill_matches_jax(vlm):
    """Both packages' prefill of the patches and S tokens, k and v padded
    to P + S + 4, then 4 greedy tokens at positions P + S + t: every
    step's logits within 2e-4 of the reference's and equal greedy tokens;
    ``init_cache`` is the padded cache's layout."""
    _, _, jm, jp, tm, tp, _ = vlm
    batch = {"tokens": _tokens(9, (B, S)), "patch_embeds": _patches(10)}
    jlg, jc = jm.prefill(jp, batch)
    tlg, tc = tm.prefill(tp, batch)
    jc, tc = _pad_kv(jc, 4, _pad_jax), _pad_kv(tc, 4, _pad_torch)
    assert _layout(tc) == _layout(tm.init_cache(B, P + S + 4))
    assert jax.tree.map(lambda t: t.shape, jc) == jax.tree.map(
        lambda t: t.shape, jm.init_cache(B, P + S + 4))
    jgreedy, tgreedy = [], []
    for t in range(4):
        jnext = np.asarray(jlg)[:, -1:].argmax(-1).astype(np.int32)
        tnext = tlg.numpy()[:, -1:].argmax(-1).astype(np.int32)
        jgreedy.append(jnext[:, 0].tolist())
        tgreedy.append(tnext[:, 0].tolist())
        jlg, jc = jm.decode_step(jp, jc, jnp.asarray(jnext),
                                 jnp.int32(P + S + t))
        tlg, tc = tm.decode_step(tp, tc, tnext, P + S + t)
        _close(tlg.numpy(), jlg, DECODE_TOL)
    assert tgreedy == jgreedy
    for key in jc:
        _close(tc[key].numpy(), jc[key], DECODE_TOL)


def test_decode_after_padded_prefill(vlm):
    """``prefill`` of the patches and S tokens with k and v padded to the
    context, then token S + 1 decoded at position P + S: within 2e-4 of
    the logits of ``prefill`` of the patches and S + 1 tokens."""
    _, _, _, _, tm, tp, _ = vlm
    toks, pe = _tokens(11, (B, S + 1)), _patches(12)
    full = tm.prefill(tp, {"tokens": toks, "patch_embeds": pe})[0]
    _, cache = tm.prefill(tp, {"tokens": toks[:, :S], "patch_embeds": pe})
    got, cache = tm.decode_step(tp, _pad_kv(cache, 6, _pad_torch),
                                toks[:, S:], P + S)
    _close(got.numpy(), full.numpy(), DECODE_TOL)
    assert cache["k"].shape[2] == P + S + 6


def test_quantized_tree_and_ledger_match_jax(vlm):
    """The int8-PoT tree leaf for leaf (mantissas, exponents), the
    quantizable paths in order (``vision_proj`` among them),
    ``quant_bytes``, the serving ledger and a prefill on the dequantized
    tree equal to the reference's; norms and ``wu`` stay float."""
    _, _, jm, jp, tm, tp, _ = vlm
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
    assert floats == {"/final_norm", "/layers/ln1", "/layers/ln2",
                      "/layers/mlp/wu"}
    paths = ptq.quantizable_paths(tp)
    assert paths == jptq.quantizable_paths(jp)
    assert set(paths) == {"embed", "lm_head", "vision_proj"} | {
        f"layers/{g}/{w}" for g, ws in (("attn", ("wq", "wk", "wv", "wo")),
                                        ("mlp", ("wg", "wd")))
        for w in ws}
    assert ptq.quant_bytes(tq_tree) == jptq.quant_bytes(
        jptq.quantize_tree(jp, bits=8))
    for kw in (dict(bits=8), dict(bits=4), dict(bits=8, act_itemsize=4.0)):
        assert ptq.serving_ledger(tp, **kw).to_dict() == \
            jptq.serving_ledger(jp, **kw).to_dict()
    batch = {"tokens": _tokens(13, (B, S)), "patch_embeds": _patches(14)}
    want = jm.prefill(jptq.dequant(jptq.quantize_tree(jp, bits=8),
                                   dtype=jnp.float32), batch)[0]
    got = tm.prefill(ptq.dequant(tq_tree, dtype=torch.float32), batch)[0]
    _close(got.numpy(), want)


@pytest.mark.parametrize("quantized", [False, True])
def test_reference_engines_fail_without_patches(vlm, quantized):
    """Both packages' ``ReferenceEngine`` prefill tokens only, so a VLM
    batch fails with ``KeyError: 'patch_embeds'`` and no token is
    served."""
    jcfg, tcfg, _, jp, _, tp, _ = vlm
    for make, req in ((lambda: JReferenceEngine(jcfg, jp, eos_id=-1,
                                                quantized=quantized),
                       JRequest),
                      (lambda: ReferenceEngine(tcfg, tp, eos_id=-1,
                                               quantized=quantized,
                                               device="cpu"), Request)):
        reqs = [req(rid=0, prompt=_tokens(15, 5), max_new_tokens=3)]
        with pytest.raises(KeyError, match="patch_embeds"):
            make().run(reqs)
        assert reqs[0].out_tokens == []


@pytest.mark.parametrize("launcher", ["jax", "torch"])
def test_launchers_fail_without_patches(launcher):
    """Both launchers route the family to ``ReferenceEngine`` (every
    family but dense and MoE goes there), which fails on the missing
    patches."""
    argv = ["--arch", ARCH, "--reduced", "--requests", "2", "--batch", "2",
            "--prompt-len", "4", "--max-new", "2", "--context", "16"]
    if launcher == "jax":
        main = jlaunch_serve.main
    else:
        main, argv = launch_serve.main, argv + ["--device", "cpu"]
    with pytest.raises(KeyError, match="patch_embeds"):
        main(argv)


def test_paged_paths_refuse_vlm(vlm):
    """As in the reference: ServeEngine, chunked prefill and block-paged
    decode refuse the family, in both packages."""
    jcfg, tcfg, jm, jp, tm, tp, _ = vlm
    table = np.zeros((1, 1), np.int32)
    for engine, cfg, p, m, pos, kw in (
            (JServeEngine, jcfg, jp, jm, jnp.zeros(1, jnp.int32), {}),
            (ServeEngine, tcfg, tp, tm, np.zeros(1, np.int32),
             dict(device="cpu"))):
        with pytest.raises(NotImplementedError):
            engine(cfg, p, **kw)
        with pytest.raises(NotImplementedError):
            m.prefill_chunks(p, m.init_cache(1, 8), _tokens(0, (1, 4)),
                             np.zeros(1, np.int32), np.zeros(1, np.int32),
                             np.full(1, 4, np.int32))
        with pytest.raises(NotImplementedError):
            m.decode_step(p, m.init_cache(1, 8), _tokens(0, (1, 1)), pos,
                          block_table=table)


def test_vlm_needs_a_card_unless_told():
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
@pytest.mark.parametrize("Bq,S_", [
    (1, 3904),      # the loss: 2880 patches and 1024 tokens, 30 x 128 + 64
    (1, 2896),      # the greedy prefill: 2880 patches and 16 tokens
    (1, 2945),      # the f32 check's prefill: 23 x 128 + 1
    (2, 2881), (2, 200), (3, 1)])
def test_gpu_flash_at_llava_shapes(Bq, S_, dtype):
    """56 / 8 heads of 128, causal, offset 0 as ``chunked_attention``
    passes it: f32 within 2e-5, bf16 under ``bf16_disagreement`` at
    ``KEY_TILE``; one launch a call."""
    _needs_card()
    g = torch.Generator(device="cuda").manual_seed(S_)
    q, k, v = (torch.randn(s, generator=g, device="cuda", dtype=dtype)
               for s in ((Bq, S_, 56, 128), (Bq, S_, 8, 128),
                         (Bq, S_, 8, 128)))
    kw = dict(causal=True, offset=0,
              bk=min(512, S_) if dtype == torch.float32 else KEY_TILE)
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
def test_gpu_vlm_matches_cpu():
    """A reduced f32 VLM (GQA 4:1) on the card: one flash launch a layer
    a forward and none a decode step; its loss and prefill logits the
    CPU's within 1e-5 relative, decode after a padded prefill the CPU's
    within 2e-4."""
    _needs_card()
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32",
                              n_kv_heads=1)
    tp = Model(cfg, device="cpu").init(0)
    toks, pe = _tokens(16, (B, S + 1)), _patches(17)
    out = {}
    for dev in ("cpu", "cuda"):
        m, p = Model(cfg, device=dev), _to(tp, dev)
        n0 = flash_attention_kernel.launches
        loss = float(m.loss(p, {"tokens": toks, "labels": toks,
                                "patch_embeds": pe})[0])
        logits, cache = m.prefill(p, {"tokens": toks[:, :S],
                                      "patch_embeds": pe})
        n1 = flash_attention_kernel.launches
        step = m.decode_step(p, _pad_kv(cache, 4, _pad_torch), toks[:, S:],
                             P + S)[0]
        if dev == "cuda":
            torch.cuda.synchronize()
            assert n1 - n0 == 2 * cfg.n_layers
            assert flash_attention_kernel.launches == n1
        out[dev] = (loss, logits.cpu().numpy(), step.cpu().numpy())
    (lc, pc, sc), (lg, pg, sg) = out["cpu"], out["cuda"]
    assert abs(lg - lc) <= TOL * abs(lc)
    assert _rel(pg, pc) <= TOL
    _close(sg, sc, DECODE_TOL)
