"""repro_torch layers and model against the JAX package on the CPU, in f32:
layer primitives (atol 1e-5), parameter conversion and init layout, and
``prefill_chunks`` / ``decode_step`` logits (atol 1e-4) in the contiguous
and block-paged layouts."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")    # the oracle; the GPU machine has none
import jax.numpy as jnp  # noqa: E402

from repro.nn import Model as JModel
from repro.nn import get_config as jget_config
from repro.nn import layers as jl
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.nn import layers as tl

ATOL_LAYER = 1e-5        # f32, summation order and libm ulps differ
ATOL_LOGITS = 1e-4       # f32 through two layers and the LM head


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def lm():
    jcfg = dataclasses.replace(jget_config("qwen2-0.5b").reduced(),
                               n_layers=2, dtype="float32")
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               n_layers=2, dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jm, jp, Model(tcfg, device="cpu"), tp


def test_config_matches_reference():
    """The port's own copy of the config equals the reference's, field by
    field, full width and reduced."""
    for full in (True, False):
        j = jget_config("qwen2-0.5b")
        t = get_config("qwen2-0.5b")
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.head_dim_ == j.head_dim_


def test_rms_norm_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tl.rms_norm(_t(x), _t(scale)).numpy(),
        np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=0, atol=ATOL_LAYER)
    pos = rng.integers(0, 40, size=(2, 5))
    np.testing.assert_allclose(
        tl.rope(_t(x), _t(pos)).numpy(),
        np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=0, atol=ATOL_LAYER)


def test_rms_norm_keeps_reference_cast_order():
    """bf16: variance in f32, the multiply in bf16 with (1 + scale)."""
    x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
    xb, scale = x.bfloat16(), torch.full((64,), 0.25, dtype=torch.bfloat16)
    var = x.bfloat16().float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + 1e-6).bfloat16()
    want = xb * inv * (1.0 + scale)
    got = tl.rms_norm(xb, scale)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("per_row", [False, True])
def test_chunk_cache_attention(per_row):
    rng = np.random.default_rng(1)
    B, c, Hq, Hkv, D, S = 3, 4, 4, 2, 16, 12
    q = rng.normal(size=(B, c, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    q_pos = (rng.integers(0, 8, size=(B, 1)) + np.arange(c)) if per_row \
        else np.arange(3, 3 + c)
    want = jl.chunk_cache_attention(*[jnp.asarray(a) for a in (q, k, v)],
                                    jnp.asarray(q_pos))
    got = tl.chunk_cache_attention(_t(q), _t(k), _t(v), _t(q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_LAYER)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention(window):
    rng = np.random.default_rng(2)
    B, Hq, Hkv, D, S = 3, 6, 2, 8, 20
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    clen = np.array([1, 9, 20], np.int32)
    want = jl.decode_attention(*[jnp.asarray(a) for a in (q, k, v, clen)],
                               window=window)
    got = tl.decode_attention(_t(q), _t(k), _t(v), _t(clen), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_LAYER)


def test_params_from_jax_and_init_layout(lm):
    """params_from_jax keeps structure, shapes and values exactly; the
    port's own init builds the same tree (keys, shapes, f32) from a
    torch.Generator."""
    jcfg, tcfg, jm, jp, tm, tp = lm
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            key = f"{prefix}['{k}']"
            out.update(flat(v, key) if isinstance(v, dict) else {key: v})
        return out

    tflat = flat(tp)
    assert set(tflat) == set(jflat)
    for k, v in tflat.items():
        np.testing.assert_array_equal(v.numpy(), jflat[k], err_msg=k)
    own = flat(tm.init(torch.Generator().manual_seed(0)))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), torch.float32) for k, v in tflat.items()}


def _tables(n_slots, nb, NB, rng):
    """A shuffled block table with sentinel entries past each row's
    grant (numpy int32)."""
    perm = rng.permutation(NB)[:n_slots * nb].reshape(n_slots, nb)
    tbl = perm.astype(np.int32)
    tbl[:, nb - 1] = NB                   # the last logical block: not granted
    return tbl


@pytest.mark.parametrize("layout,gather,kernel", [
    ("contiguous", "take", "dense"),
    ("paged", "take", "dense"),
    ("paged", "cuda", "dense"),
    ("paged", "take", "reference"),
    ("paged", "cuda", "fused"),
])
def test_prefill_and_decode_logits_vs_jax(lm, layout, gather, kernel):
    """One batched prefill_chunks dispatch (a dummy row included) and one
    decode_step: logits within atol 1e-4 of the JAX model's, and the
    written caches within atol 1e-5, in f32."""
    jcfg, tcfg, jm, jp, tm, tp = lm
    rng = np.random.default_rng(3)
    n_slots, C, bs = 3, 32, 8
    nb = C // bs
    toks = rng.integers(0, jcfg.vocab, size=(3, 6)).astype(np.int32)
    slots = np.array([2, 0, 0], np.int32)
    offs = np.array([0, 5, C], np.int32)       # row 2: dummy, all writes drop
    nval = np.array([6, 4, 1], np.int32)
    if layout == "contiguous":
        jc, tc = jm.init_cache(n_slots, C), tm.init_cache(n_slots, C)
        tbl = None
    else:
        NB = n_slots * nb + 2
        jc, tc = jm.init_cache(NB, bs), tm.init_cache(NB, bs)
        tbl = _tables(n_slots, nb, NB, rng)
    jkw = {} if tbl is None else dict(block_table=jnp.asarray(tbl),
                                      kv_gather="pallas" if gather == "cuda"
                                      else "take")
    tkw = {} if tbl is None else dict(block_table=_t(tbl), kv_gather=gather)
    jl_, jc = jm.prefill_chunks(jp, jc, jnp.asarray(toks), jnp.asarray(slots),
                                jnp.asarray(offs), jnp.asarray(nval), **jkw)
    tl_, tc = tm.prefill_chunks(tp, tc, toks, slots, offs, nval, **tkw)
    np.testing.assert_allclose(tl_.numpy()[:2], np.asarray(jl_)[:2], rtol=0,
                               atol=ATOL_LOGITS)
    dtoks = rng.integers(0, jcfg.vocab, size=(n_slots, 1)).astype(np.int32)
    pos = np.array([3, 20, 6], np.int32)
    jkw2 = dict(jkw, decode_kernel=kernel) if tbl is not None else {}
    tkw2 = dict(tkw, decode_kernel=kernel) if tbl is not None else {}
    jd, jc = jm.decode_step(jp, jc, jnp.asarray(dtoks), jnp.asarray(pos),
                            **jkw2)
    td, tc = tm.decode_step(tp, tc, dtoks, pos, **tkw2)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=ATOL_LOGITS)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   rtol=0, atol=ATOL_LAYER, err_msg=name)


def test_decode_step_scalar_pos_contiguous(lm):
    """A scalar position shared by every row (the reference's contiguous
    decode signature)."""
    jcfg, tcfg, jm, jp, tm, tp = lm
    toks = np.array([[1], [7]], np.int32)
    jd, jc = jm.decode_step(jp, jm.init_cache(2, 8), jnp.asarray(toks), 3)
    td, tc = tm.decode_step(tp, tm.init_cache(2, 8), toks, 3)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=ATOL_LOGITS)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0,
                               atol=ATOL_LAYER)


def test_model_defaults_to_the_card():
    """Entry points run on the card unless the caller asks for the CPU:
    with no card visible they raise instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_config("qwen2-0.5b").reduced())
