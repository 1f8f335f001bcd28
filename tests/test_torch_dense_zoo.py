"""repro_torch's last three dense configs -- qwen2.5-3b (16 / 2 heads, QKV
bias, rope theta 1e6), internlm2-1.8b (16 / 8, no bias, vocab 92544) and
qwen1.5-4b (20 / 20 MHA, QKV bias) -- against the JAX package on the CPU.

``reduced()`` keeps 4 / 2 heads for qwen2.5-3b and makes the other two
MHA (4 / 4), so the grouping the full configs run is never seen there:
the tests also run qwen2.5-3b's G = 8 variant (8 / 1 heads of 16) and
internlm2-1.8b's G = 2 variant (4 / 2 heads).  The reference's init zeros
every norm (ln1, ln2, final_norm), which would let a swapped norm pass;
so the parameters are the reference's init with every norm overwritten by
seeded values, carried across with ``params_from_jax``.  Inputs come from
seeded numpy generators.

- the configs equal the reference's, and so do ``params_count`` and
  ``active_params_count``, full size, reduced and in each variant; the
  reference's init holds the leaves the chip run counts;
- the init tree's paths and shapes are the reference's, ``bq`` / ``bk`` /
  ``bv`` present only where ``qkv_bias``;
- ``Model.loss`` within 1e-5 relative in f32 and 2e-2 relative in bf16;
- ``prefill``'s logits and K/V cache within 1e-5, qwen2.5-3b's over 1040
  positions (a rope theta dropped or defaulted to 1e4 moves them far past
  that, which the test checks too);
- ``ServeEngine`` on the block-paged take/dense, reference and fused
  routes, float and int8-PoT, gives the reference ``ServeEngine``'s greedy
  tokens and event log, and ``ReferenceEngine`` the reference's tokens;
- the serve launcher at ``--arch <name> --reduced`` prints the same tokens
  in both packages (both given the same seeded tree, in f32);
- ``Model`` refuses the CPU unless asked for it.

The ``gpu`` tests (they skip without a card) hold the three kernels of
the path against their plain versions at the full configs' head layouts,
D = 128 -- the K+V pair gather at 2, 8 and 20 KV heads bit for bit, the
split ``paged_attention`` at G = 8, 2 and 1 in bf16 and f32, flash at
each config's (8, 1024) loss shape -- and a reduced G = 8 qwen2.5-3b on
the card against the CPU."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.launch import serve as jlaunch_serve
    from repro.nn import Model as JModel
    from repro.nn import get_config as jget_config
    from repro.runtime.serve import ReferenceEngine as JReferenceEngine
    from repro.runtime.serve import Request as JRequest
    from repro.runtime.serve import ServeEngine as JServeEngine
except ImportError:
    jax = None
from repro_torch.kernels.flash_attention import (BF16_SHARE, KEY_TILE,
                                                 bf16_disagreement,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                 paged_attention_plain)
from repro_torch.kernels.paged_gather import (paged_gather_kernel,
                                              paged_gather_pair_kernel,
                                              paged_gather_plain)
from repro_torch.launch import serve as launch_serve
from repro_torch.nn import Model, get_config, params_from_jax
from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine

ARCHS = ("qwen2.5-3b", "internlm2-1.8b", "qwen1.5-4b")
# params_count() (V x d once, no biases) and the leaves of the
# reference's Model.init at full size
COUNTS = {"qwen2.5-3b": (3_085_846_528, 3_397_103_616),
          "internlm2-1.8b": (1_699_579_904, 1_889_110_016),
          "qwen1.5-4b": (3_561_105_920, 3_950_369_280)}
VARIANTS = {"reduced": {},
            "g8": dict(n_heads=8, n_kv_heads=1, head_dim=16),
            "g2": dict(n_heads=4, n_kv_heads=2)}
CASES = [("qwen2.5-3b", "reduced"), ("qwen2.5-3b", "g8"),
         ("internlm2-1.8b", "reduced"), ("internlm2-1.8b", "g2"),
         ("qwen1.5-4b", "reduced")]
TOL = 1e-5          # one forward, f32 sums in another order
BF16_REL = 2e-2     # x |reference|: bf16 activations, another order
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2     # the serving kernels' bf16 bound
FLASH_F32_TOL = 2e-5
LONG = 1040         # qwen2.5-3b's prefill: past position 1024
B, S = 2, 10


def _cfgs(arch, variant, dtype="float32"):
    """(reference, port) configs: ``arch`` reduced, in ``variant``."""
    return tuple(dataclasses.replace(get(arch).reduced(), dtype=dtype,
                                     **VARIANTS[variant])
                 for get in (jget_config, get_config))


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


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(c))
def dense(request):
    jcfg, tcfg = _cfgs(*request.param)
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


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


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


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_counts(arch):
    """The registered config is the reference's, ``rope_theta`` and
    ``qkv_bias`` included; ``params_count`` and ``active_params_count``
    equal the reference's at full size, reduced and in the variants; the
    reference's init holds the leaves the chip run counts."""
    cfg, ref = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.family == "dense" and cfg.head_dim_ == 128
    assert (cfg.rope_theta, cfg.qkv_bias) == {
        "qwen2.5-3b": (1e6, True), "internlm2-1.8b": (1e4, False),
        "qwen1.5-4b": (1e4, True)}[arch]
    pairs = [(ref, cfg)] + [_cfgs(arch, v) for v in VARIANTS]
    for want, got in pairs:
        assert got.params_count() == want.params_count()
        assert got.active_params_count() == want.active_params_count()
    count, leaves = COUNTS[arch]
    assert cfg.params_count() == count
    shapes = jax.eval_shape(JModel(ref).init, jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes)) == leaves


def test_init_layout(dense):
    """The port's init has the reference's paths, shapes and f32 dtypes;
    ``bq`` / ``bk`` / ``bv`` exist exactly where ``qkv_bias``;
    ``params_from_jax`` carries the tree unchanged."""
    _, tcfg, jm, _, tm, tp, npp = dense
    want = _layout(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    assert _layout(tm.init(0)) == want
    assert set(want) == {"embed", "final_norm", "lm_head", "layers"}
    attn = want["layers"]["attn"]
    biases = {"bq", "bk", "bv"} & set(attn)
    assert biases == ({"bq", "bk", "bv"} if tcfg.qkv_bias else set())
    hd, L = tcfg.head_dim_, tcfg.n_layers
    assert attn["wq"][0] == (L, 64, tcfg.n_heads * hd)
    assert attn["wk"][0] == (L, 64, tcfg.n_kv_heads * hd)
    assert _layout(tp) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_matches_jax(dense, dtype):
    """``Model.loss`` (xent; aux zero): f32 within 1e-5 relative, bf16
    within 2e-2 relative."""
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in dense[:2])
    jp, tp = dense[3], dense[5]
    batch = {"tokens": _tokens(4, (B, S)), "labels": _tokens(5, (B, S))}
    jl, _ = JModel(jcfg).loss(jp, batch)
    tl, tmets = Model(tcfg, device="cpu").loss(tp, batch)
    assert float(tmets["aux"]) == 0.0 and float(tl) == float(tmets["xent"])
    rel = TOL if dtype == "float32" else BF16_REL
    assert abs(float(tl) - float(jl)) <= rel * abs(float(jl))


def test_prefill_matches_jax(dense):
    """Logits and the K/V cache (L, B, S, Hkv, hd), K roped at 0..S-1;
    qwen2.5-3b over 1040 positions, where a rope theta of 1e4 in place of
    its 1e6 moves the logits by far more than the tolerance."""
    jcfg, tcfg, jm, jp, tm, tp, _ = dense
    shape = (1, LONG) if tcfg.rope_theta != 1e4 else (B, S)
    toks = {"tokens": _tokens(7, shape)}
    jl, jc = jm.prefill(jp, toks)
    tl, tc = tm.prefill(tp, toks)
    _close(tl.numpy(), jl)
    assert set(tc) == set(jc) == {"k", "v"}
    assert tuple(tc["k"].shape) == (tcfg.n_layers, *shape,
                                    tcfg.n_kv_heads, tcfg.head_dim_)
    for key in jc:
        _close(tc[key].numpy(), jc[key])
    if tcfg.rope_theta != 1e4:
        other = Model(dataclasses.replace(tcfg, rope_theta=1e4),
                      device="cpu").prefill(tp, toks)[0]
        assert _rel(other.numpy(), jl) > 100 * TOL


_ROUTES = {
    "take-dense": dict(kv_block_size=8),
    "reference": dict(kv_block_size=8, decode_kernel="reference"),
    "fused": dict(kv_block_size=8, kv_gather="cuda", decode_kernel="fused"),
}


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "int8"])
def test_serve_engine_matches_jax(dense, quantized):
    """Mixed prompt lengths, a chunk size that divides none of them,
    batched prefill (2 rows), several KV blocks a slot and slot churn: the
    port's block-paged take/dense, reference and fused routes each give
    the reference ``ServeEngine``'s greedy tokens, statuses, event log and
    token counts (its take/dense route: the reference's routes agree, and
    its engine compiles for seconds a run)."""
    jcfg, tcfg, _, jp, _, tp, _ = dense
    prompts = _prompts(30, (3, 17, 9, 5))
    kw = dict(max_batch=3, max_context=32, prefill_chunk=5, prefill_batch=2,
              quantized=quantized, eos_id=-1)
    jeng = JServeEngine(jcfg, jp, **kw, **_ROUTES["take-dense"])
    jreqs = [JRequest(rid=i, prompt=p.copy(), max_new_tokens=4)
             for i, p in enumerate(prompts)]
    jeng.run(jreqs)
    for route, rkw in _ROUTES.items():
        teng = ServeEngine(tcfg, tp, device="cpu", **kw, **rkw)
        treqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=4)
                 for i, p in enumerate(prompts)]
        teng.run(treqs)
        assert [r.out_tokens for r in treqs] == \
            [r.out_tokens for r in jreqs], route
        assert [r.status for r in treqs] == [r.status for r in jreqs]
        assert teng.events == jeng.events, route
        for key in ("prefill_tokens", "decode_tokens", "prefill_dispatches",
                    "decode_steps"):
            assert teng.stats[key] == jeng.stats[key], (route, key)
        assert teng.cache.n_free_blocks == teng.cache.n_blocks


def test_reference_engine_matches_jax(dense):
    """``ReferenceEngine`` (one batch of 2, left-padded): the reference's
    greedy tokens and token counts."""
    jcfg, tcfg, _, jp, _, tp, _ = dense
    prompts = _prompts(4, (3, 17))
    outs = []
    for eng, req in ((JReferenceEngine(jcfg, jp, eos_id=-1, max_batch=2,
                                       max_context=32), JRequest),
                     (ReferenceEngine(tcfg, tp, eos_id=-1, max_batch=2,
                                      max_context=32, device="cpu"),
                      Request)):
        reqs = [req(rid=i, prompt=p.copy(), max_new_tokens=5)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append(([r.out_tokens for r in reqs],
                     eng.stats["prefill_tokens"],
                     eng.stats["decode_tokens"]))
    assert outs[0] == outs[1]
    assert all(len(t) == 5 for t in outs[1][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_tokens_match_jax(arch, monkeypatch):
    """``launch/serve.py --arch <name> --reduced`` in both packages, each
    given the same seeded tree and the config in f32 (each package's own
    init draws from its own generator, and bf16 greedy ties would part on
    rounding): the same served counts and tokens.  The port runs with
    ``--device cpu``; the reference has no such flag."""
    jcfg, tcfg = _cfgs(arch, "reduced")
    npp = _seed_norms(jax.tree.map(
        np.asarray, JModel(jcfg).init(jax.random.PRNGKey(0))),
        np.random.default_rng(1))

    class JSeeded(JModel):
        def init(self, key):
            return jax.tree.map(jnp.asarray, npp)

    class TSeeded(Model):
        def init(self, gen):
            return params_from_jax(npp, device="cpu")

    def f32(get):
        return lambda name: dataclasses.replace(get(name), dtype="float32")

    monkeypatch.setattr(jlaunch_serve, "Model", JSeeded)
    monkeypatch.setattr(jlaunch_serve, "get_config", f32(jget_config))
    monkeypatch.setattr(launch_serve, "Model", TSeeded)
    monkeypatch.setattr(launch_serve, "get_config", f32(get_config))
    argv = ["--arch", arch, "--reduced", "--requests", "3", "--batch", "2",
            "--prompt-len", "6", "--max-new", "4", "--context", "32",
            "--kv-block-size", "8", "--prefill-chunk", "4"]
    outs = []
    for main, extra in ((jlaunch_serve.main, []),
                        (launch_serve.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(argv + extra)
        lines = buf.getvalue().splitlines()
        outs.append([ln for ln in lines if ln.startswith("  req ")]
                    + [ln.split(";")[-1] for ln in lines
                       if ln.startswith("latency:")])
    assert outs[0] == outs[1]
    assert len(outs[1]) == 4 and "done=3" in outs[1][-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_needs_a_card_unless_told(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError):
        Model(get_config(arch).reduced())
    Model(get_config(arch).reduced(), device="cpu")


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


HEADS = {"qwen2.5-3b": (16, 2), "internlm2-1.8b": (16, 8),
         "qwen1.5-4b": (20, 20)}


def _pools(Hq, Hkv, dtype, seed, B_=8, bs=32, C=1024):
    """The serving cell's decode inputs: 8 slots of mixed lengths in
    32-token blocks, each slot's unused table entries the sentinel NB."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = C // bs
    NB = B_ * nb
    lens = np.array([1, 33, 100, 257, 511, 640, 900, 1024], np.int32)
    tbl = rng.permutation(NB).reshape(B_, nb).astype(np.int32)
    for b in range(B_):
        tbl[b, -(-lens[b] // bs):] = NB
    k, v = (torch.randn((NB, bs, Hkv, 128), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    q = torch.randn((B_, 1, Hq, 128), generator=g, device="cuda",
                    dtype=dtype)
    return q, k, v, torch.from_numpy(tbl).cuda(), \
        torch.from_numpy(lens).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_gather_pair_at_dense_heads(arch):
    """The K+V pair gather at the config's KV heads of 128, bf16, through
    the int64 table with sentinels: bit for bit the plain version on the
    clamped table, one launch."""
    _needs_card()
    _, k, v, table, _ = _pools(*HEADS[arch], torch.bfloat16, 1)
    g_tbl = table[:4].long()
    g_cl = torch.clamp(g_tbl, max=k.shape[0] - 1)
    n0 = paged_gather_pair_kernel.launches
    gk, gv = paged_gather_pair_kernel(k, v, g_tbl)
    torch.cuda.synchronize()
    assert paged_gather_pair_kernel.launches == n0 + 1
    assert torch.equal(gk, paged_gather_plain(k, g_cl))
    assert torch.equal(gv, paged_gather_plain(v, g_cl))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_paged_attention_at_dense_heads(arch, dtype):
    """The split ``paged_attention`` at the config's G (8, 2, 1), D = 128:
    within the serving bound of the plain version; one split launch and
    one combine."""
    _needs_card()
    q, k, v, table, lens = _pools(*HEADS[arch], dtype, 2)
    tbl_c = torch.clamp(table, max=k.shape[0] - 1)
    a0 = paged_attention_kernel.launches
    c0 = paged_attention_kernel.combine_launches
    got = paged_attention_kernel(q, k, v, tbl_c, lens)
    want = paged_attention_plain(q, k, v, table, lens)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == a0 + 1
    assert paged_attention_kernel.combine_launches == c0 + 1
    assert bool(torch.isfinite(got).all())
    atol, rtol = (ATTN_ATOL, ATTN_RTOL) if dtype == torch.bfloat16 \
        else (FLASH_F32_TOL, FLASH_F32_TOL)
    assert torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_gpu_flash_at_dense_loss_shape(arch):
    """Flash at the config's (8, 1024) loss shape, causal, bf16 under
    ``bf16_disagreement`` at ``KEY_TILE``; one launch."""
    _needs_card()
    Hq, Hkv = HEADS[arch]
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device="cuda",
                           dtype=torch.bfloat16)
               for s in ((8, 1024, Hq, 128), (8, 1024, Hkv, 128),
                         (8, 1024, Hkv, 128)))
    kw = dict(causal=True, offset=0, bk=KEY_TILE)
    n0 = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    ratio, share = bf16_disagreement(got, want)
    assert bool(torch.isfinite(got).all()) and ratio <= 1 \
        and share <= BF16_SHARE


@pytest.mark.gpu
def test_gpu_dense_g8_matches_cpu():
    """A reduced f32 qwen2.5-3b at G = 8 on the card: ``Model.loss``
    within 1e-5 relative of the CPU's with one flash launch a layer;
    ``ServeEngine`` on the fused / cuda route gives the CPU's greedy
    tokens with one K+V pair gather a layer and prefill dispatch, and one
    attention and one combine launch a layer and decode step."""
    _needs_card()
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              dtype="float32", **VARIANTS["g8"])
    tp = Model(cfg, device="cpu").init(0)
    toks = _tokens(8, (2, 24))
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    prompts = _prompts(12, (3, 17, 9, 22))
    outs, losses = [], []
    for dev in ("cpu", "cuda"):
        paged_gather_kernel.launches = paged_gather_pair_kernel.launches = 0
        paged_attention_kernel.launches = 0
        paged_attention_kernel.combine_launches = 0
        flash_attention_kernel.launches = 0
        losses.append(float(Model(cfg, device=dev).loss(_to(tp, dev),
                                                        batch)[0]))
        assert flash_attention_kernel.launches == \
            (cfg.n_layers if dev == "cuda" else 0)
        eng = ServeEngine(cfg, tp, eos_id=-1, max_batch=3, max_context=32,
                          prefill_chunk=5, prefill_batch=2, kv_block_size=8,
                          kv_gather="cuda", decode_kernel="fused", device=dev)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
        s, L = eng.stats, cfg.n_layers
        want = (s["prefill_dispatches"] * L, s["decode_steps"] * L) \
            if dev == "cuda" else (0, 0)
        assert (paged_gather_pair_kernel.launches,
                paged_attention_kernel.launches) == want
        assert paged_gather_kernel.launches == 0
        assert paged_attention_kernel.combine_launches in (0, want[1])
    assert outs[0] == outs[1]
    assert abs(losses[1] - losses[0]) <= TOL * abs(losses[0])
