"""The gradient of repro_torch's flash attention.

On the CPU: autograd through the plain route (``ops.flash_attention``)
against ``jax.grad`` of the reference's ``chunked_attention`` within 2e-5
(causal GQA, a window with an offset, non-causal, cross-length); the
backward kernels' arithmetic in plain PyTorch (``flash_attention_bwd_plain``)
against autograd through the plain forward, f32 within 2e-5 of each
gradient's largest magnitude and bf16 under ``bf16_grad_disagreement``; the
plain version's lse against a dense log-sum-exp.

On the CPU also the bf16 kernels' schedule (``bwd_walks``, the walks split
over a cluster of every size, the dQ walks) against the visible (head,
row, key) triples, and the cluster-size rule ``bwd_cluster`` at phase
15's shapes.

On the card (``gpu`` marker): the backward kernels through
``FlashAttention`` against autograd through the plain version -- f32 (the
CUDA cores) within ``BWD_F32_TOL`` of each gradient's largest magnitude,
bf16 (the tensor cores) under ``bf16_grad_disagreement`` -- at causal GQA
7:1, 8:1, 4:1, 9:1 and 16:1, windows crossing tile edges with an offset,
non-causal, MHA, ragged and cross-length shapes at every head dim the
backward takes, D = 256 (the hybrid's MQA 16:1, with and without a
window) among them; bf16 dK/dV on clusters of every size; two runs
bit-identical; the forward's lse; ``linear_scan`` and flash at D = 256
under grad."""
import math

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.nn.layers import chunked_attention as jchunked
except ImportError:
    jax = None
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    BWD_BF16_MAX, BWD_BF16_MEAN, BWD_F32_TOL, BWD_HEAD_DIMS, KEY_TILE,
    bf16_grad_disagreement, bwd_cluster, bwd_walks,
    flash_attention_bwd_kernel,
    flash_attention_bwd_plain, flash_attention_kernel, flash_attention_plain)

TOL = 2e-5          # f32: the same sums in another order

# (B, Sq, Skv, Hq, Hkv, D, causal, window, offset); offset None is
# Skv - Sq, as Model.loss and prefill pass it
CASES = [
    (2, 96, 96, 14, 2, 64, True, 0, None),      # causal GQA 7:1
    (1, 100, 300, 4, 1, 32, True, 40, 200),     # window + offset, cross-len
    (2, 64, 150, 4, 4, 16, False, 0, None),     # non-causal, cross-length
    (1, 80, 80, 8, 1, 16, True, 0, None),       # GQA 8:1
    (1, 130, 130, 8, 1, 128, True, 0, None),    # GQA 8:1 at D = 128
    (1, 77, 129, 4, 2, 32, True, 0, None),      # ragged tiles, cross-length
    (1, 96, 96, 16, 1, 256, True, 0, None),     # MQA 16:1 at D = 256
    (1, 100, 100, 16, 1, 256, True, 32, None),  # the same under a window
    (1, 70, 130, 4, 2, 256, True, 40, 60),      # window + offset at D = 256
]


def _inputs(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                      (B, Sq, Hq, D))]


def _kw(case):
    B, Sq, Skv, Hq, Hkv, D, causal, window, offset = case
    return dict(causal=causal, window=window,
                offset=Skv - Sq if offset is None else offset)


def _plain_grads(q, k, v, dout, kw, bk=256):
    """Autograd through the plain forward: (out, dq, dk, dv)."""
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = flash_attention_plain(q, k, v, kv_len=k.shape[1], bk=bk, **kw)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


def _assert_rel(got, want, tol):
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        assert err <= tol * w.abs().max().item(), (err, w.abs().max())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_gradient_matches_jax_grad(case):
    """ops.flash_attention on the CPU differentiates the plain version:
    dq, dk, dv within 2e-5 of jax.grad of the reference's
    chunked_attention on the same inputs and output gradient."""
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    kw = _kw(case)
    x = _inputs(1, B, Sq, Skv, Hq, Hkv, D)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in x[:3])
    out = ops.flash_attention(q, k, v, bk=64, **kw)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(x[3]))

    def f(q, k, v):
        o = jchunked(q, k, v, causal=kw["causal"], window=kw["window"],
                     block_q=32, block_kv=64, q_offset=kw["offset"])
        return jnp.sum(o * jnp.asarray(x[3]))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in x[:3]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_arithmetic_matches_autograd_f32(case):
    """The backward kernels' formulas (lse, delta, P, dS) in plain PyTorch
    give autograd's dq, dk, dv within 2e-5 of each one's largest
    magnitude."""
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    kw = _kw(case)
    q, k, v, dout = (torch.from_numpy(a)
                     for a in _inputs(2, B, Sq, Skv, Hq, Hkv, D))
    out, lse = flash_attention_plain(q, k, v, kv_len=Skv, return_lse=True,
                                     **kw)
    want = _plain_grads(q, k, v, dout, kw)[1:]
    got = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    _assert_rel(got, want, TOL)


def test_backward_arithmetic_bf16_rule():
    """In bf16 the backward's arithmetic (P rounded for dv, dS for dq and
    dk) and autograd through the bf16 plain forward agree under
    ``bf16_grad_disagreement``'s limits; a wrong mask breaks them."""
    case = (2, 128, 128, 14, 2, 64, True, 0, None)
    kw = _kw(case)
    q, k, v, dout = (torch.from_numpy(a).bfloat16()
                     for a in _inputs(3, *case[:6]))
    out, lse = flash_attention_plain(q, k, v, kv_len=128, bk=KEY_TILE,
                                     return_lse=True, **kw)
    want = _plain_grads(q, k, v, dout, kw, bk=KEY_TILE)[1:]
    got = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    for g, w in zip(got, want):
        mx, mean = bf16_grad_disagreement(g, w)
        assert mx <= BWD_BF16_MAX and mean <= BWD_BF16_MEAN, (mx, mean)
    wrong = flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                      **dict(kw, causal=False))
    assert any(bf16_grad_disagreement(g, w)[1] > BWD_BF16_MEAN
               for g, w in zip(wrong, want))


def test_plain_lse_is_the_rows_log_sum_exp():
    """return_lse gives m + ln l, the log-sum-exp of each row's visible
    scores, (B, Hq, Sq)."""
    B, Sq, Skv, Hq, Hkv, D = 1, 50, 120, 4, 2, 32
    q, k, v, _ = (torch.from_numpy(a)
                  for a in _inputs(4, B, Sq, Skv, Hq, Hkv, D))
    _, lse = flash_attention_plain(q, k, v, window=30, bk=32,
                                   return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(Hq // Hkv, dim=2)) / math.sqrt(D)
    qp = torch.arange(Sq)[:, None] + Skv - Sq
    kp = torch.arange(Skv)[None, :]
    s = torch.where((kp <= qp) & (kp > qp - 30), s, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5,
                               rtol=1e-5)


def test_cpu_grad_takes_the_plain_route():
    """On the CPU a call that needs a gradient launches no kernel."""
    q, k, v, dout = (torch.from_numpy(a).requires_grad_()
                     for a in _inputs(5, 1, 40, 40, 4, 2, 16))
    n0 = flash_attention_kernel.launches
    b0 = flash_attention_bwd_kernel.launches
    ops.flash_attention(q, k, v).backward(dout.detach())
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert flash_attention_kernel.launches == n0
    assert flash_attention_bwd_kernel.launches == b0


# The bf16 kernels' schedule, as flash_attention_bwd.cu walks it: a dK/dV
# block per (KV head, cluster rank, key tile of 64 NW keys), NW consumer
# warpgroups of 64 keys each (NW = 2 at D = 128), rank r of a cluster of
# bwd_cluster(G) walking query heads r, r + c, ... and, for each, the
# 64-row query tiles Mask::rows gives its keys, a warpgroup skipping tiles
# outside its own keys' rows; a dQ block per (query head, 64 NW rows), each
# warpgroup walking the 64-key tiles of Mask::keys of the block's rows that
# meet its own rows' keys.

def _sched_rows(k0, k1, Sq, kw):
    """Mask::rows: rows [lo, hi) that see a key of [k0, k1)."""
    lo = max(k0 - kw["offset"], 0) if kw["causal"] else 0
    hi = min(Sq, k1 - 1 + kw["window"] - kw["offset"]) if kw["window"] \
        else Sq
    return (lo, lo) if k0 >= k1 or hi < lo else (lo, hi)


def _sched_keys(r0, r1, kv_len, kw):
    """Mask::keys: keys [lo, hi) that rows [r0, r1) see."""
    lo = max(r0 + kw["offset"] - kw["window"] + 1, 0) if kw["window"] else 0
    hi = min(r1 + kw["offset"], kv_len) if kw["causal"] else kv_len
    return (lo, max(hi, lo))


def _visible(Sq, Skv, kw):
    qp = np.arange(Sq)[:, None] + kw["offset"]
    kp = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if kw["causal"]:
        vis = vis & (kp <= qp)
    if kw["window"]:
        vis = vis & (kp > qp - kw["window"])
    return vis


def _dkdv_cover(Sq, Skv, Hq, Hkv, D, kw, c):
    G, NW = Hq // Hkv, 2 if D == 128 else 1
    rows = 64 * NW
    vis = _visible(Sq, Skv, kw)
    seen = np.zeros((Hq, Sq, Skv), np.int64)
    walks = bwd_walks(Sq, Skv, D, kv_len=Skv, **kw)
    for hk in range(Hkv):
        for k0, nt in zip(range(0, Skv, rows), walks):
            lo, hi = _sched_rows(k0, min(k0 + rows, Skv), Sq, kw)
            t0 = lo // 64
            assert nt == (-(-hi // 64) - t0 if hi > lo else 0)
            for rank in range(c):       # steps (head, query tile) split
                for u in range(rank * G * nt // c, (rank + 1) * G * nt // c):
                    g, i0 = u // nt, 64 * (t0 + u % nt)
                    for cw in range(NW):
                        k_w = k0 + 64 * cw
                        wlo, whi = _sched_rows(k_w, min(k_w + 64, Skv), Sq,
                                               kw)
                        if i0 < whi and i0 + 64 > wlo:
                            seen[hk * G + g, i0:i0 + 64, k_w:k_w + 64] += \
                                vis[i0:i0 + 64, k_w:k_w + 64]
    return seen, vis


def _dq_cover(Sq, Skv, Hq, D, kw):
    NW = 2 if D == 128 else 1
    vis = _visible(Sq, Skv, kw)
    seen = np.zeros((Hq, Sq, Skv), np.int64)
    for h in range(Hq):
        for q0 in range(0, Sq, 64 * NW):
            lo, hi = _sched_keys(q0, min(q0 + 64 * NW, Sq), Skv, kw)
            j_lo = lo // 64 * 64
            n = -(-(hi - j_lo) // 64) if hi > lo else 0
            for cw in range(NW):
                w0 = q0 + 64 * cw
                if w0 >= Sq:
                    continue
                wlo, whi = _sched_keys(w0, min(w0 + 64, Sq), Skv, kw)
                for j0 in range(j_lo, j_lo + 64 * n, 64):
                    if j0 < whi and j0 + 64 > wlo:
                        seen[h, w0:w0 + 64, j0:j0 + 64] += \
                            vis[w0:w0 + 64, j0:j0 + 64]
    return seen, vis


@pytest.mark.parametrize("case", CASES + [
    (2, 200, 200, 14, 2, 64, True, 0, None),
    (1, 190, 190, 16, 2, 128, True, 0, None),
    (1, 150, 333, 8, 2, 128, True, 70, 120),
    (1, 129, 129, 16, 1, 64, True, 0, None),
    (1, 64, 64, 9, 1, 32, True, 0, None),
    (2, 77, 200, 8, 1, 64, False, 0, None),
    (1, 333, 333, 4, 2, 128, True, 0, None),
    (1, 1024, 1024, 14, 2, 64, True, 0, None),
    (1, 300, 300, 16, 1, 256, True, 128, None),
], ids=str)
def test_bf16_schedule_covers_every_visible_pair_once(case):
    """The bf16 kernels' walks (the query tiles of a key tile, bwd_walks,
    split step by step over a cluster of every size the kernel takes; the
    key tiles of a query tile; a warpgroup's skips) meet every visible
    (head, row, key) triple exactly once, in dK/dV and in dQ, and no
    other; bwd_cluster picks a size in 1..min(G, 8)."""
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    kw = _kw(case)
    G = Hq // Hkv
    for sms in (1, 132):
        assert 1 <= bwd_cluster(B, Sq, Skv, Hq, Hkv, D, kv_len=Skv, sms=sms,
                                **kw) <= min(G, 8)
    covers = [_dkdv_cover(Sq, Skv, Hq, Hkv, D, kw, c)
              for c in range(1, min(G, 8) + 1)]
    for seen, vis in covers + [_dq_cover(Sq, Skv, Hq, D, kw)]:
        assert vis.any()
        np.testing.assert_array_equal(seen, np.broadcast_to(vis, seen.shape))


@pytest.mark.parametrize("causal, window, sizes", [
    (True, 0, (2, 2)), (False, 0, (1, 1)), (True, 300, (2, 2))], ids=str)
def test_bwd_cluster_rule_at_the_timed_shapes(causal, window, sizes):
    """The cluster-size rule at phase 15's shapes on 132 SMs: the causal
    walks (16 query tiles at key tile 0, 1 at the last) give 2 blocks a
    cluster at G = 7, D = 64 and G = 8, D = 128 (the longest of 1 would
    be twice the balanced share); equal non-causal walks give 1.  The
    walks are Mask::rows's."""
    got = tuple(bwd_cluster(8, 1024, 1024, Hq, 2, D, causal=causal,
                            window=window, kv_len=1024, offset=0, sms=132)
                for Hq, D in ((14, 64), (16, 128)))
    assert got == sizes
    walks = bwd_walks(1024, 1024, 64, causal=causal, window=window,
                      kv_len=1024, offset=0)
    vis = _visible(1024, 1024, dict(causal=causal, window=window,
                                    offset=0))
    want = [int(np.unique(np.nonzero(vis[:, k:k + 64].any(1))[0] // 64)
                .size) for k in range(0, 1024, 64)]
    assert walks == want


def test_bwd_cluster_rule_at_the_hybrid_shapes():
    """recurrentgemma-9b's local attention, 16 / 1 heads of 256, causal,
    window 2048, 4096 rows, on 132 SMs: 64 key tiles of 64 keys, each
    seen by 33 query tiles until the last 2048 keys' walks shorten (1584
    in all); a cluster of 1 walks 16 x 33 = 528 steps against a balanced
    share of 384 at B = 2 (2 blocks a cluster) and 192 at B = 1 (3)."""
    walks = bwd_walks(4096, 4096, 256, causal=True, window=2048,
                      kv_len=4096, offset=0)
    assert len(walks) == 64 and max(walks) == 33 and sum(walks) == 1584
    got = [bwd_cluster(B, 4096, 4096, 16, 1, 256, causal=True, window=2048,
                       kv_len=4096, offset=0, sms=132) for B in (2, 1)]
    assert got == [2, 3]


# ----------------------------------------------------------------- the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


GPU_CASES = [
    (2, 200, 200, 14, 2, 64, True, 0, None),     # causal GQA 7:1 (qwen2)
    (1, 190, 190, 16, 2, 128, True, 0, None),    # GQA 8:1 at D = 128
    (1, 150, 333, 4, 1, 64, True, 100, 120),     # window + offset, cross
    (2, 64, 200, 4, 4, 32, False, 0, None),      # non-causal, cross-length
    (1, 129, 129, 8, 8, 128, True, 0, None),     # MHA, a ragged tile
    (2, 100, 300, 4, 1, 64, True, 0, None),      # causal cross-length
    (1, 150, 150, 14, 2, 128, True, 0, None),    # G = 7 at D = 128
    (1, 100, 100, 8, 2, 64, True, 0, None),      # G = 4
    (1, 129, 129, 16, 1, 64, True, 0, None),     # G = 16: 2 heads a rank
    (1, 64, 64, 9, 1, 32, True, 0, None),        # G = 9: ranks walk 2 or 1
    (1, 333, 333, 4, 2, 128, True, 0, None),     # 3 ragged 128-key tiles
    (1, 150, 333, 8, 2, 128, True, 70, 120),     # window across tile edges
    (1, 150, 333, 8, 2, 64, True, 70, 120),      # the same at D = 64
    (2, 77, 200, 8, 1, 64, False, 0, None),      # non-causal cross, G = 8
    (1, 300, 300, 16, 1, 256, True, 0, None),    # MQA 16:1 at D = 256
    (2, 333, 333, 16, 1, 256, True, 128, None),  # the hybrid's, windowed
    (1, 150, 333, 4, 1, 256, True, 70, 120),     # window + offset, cross
    (2, 64, 150, 4, 4, 256, False, 0, None),     # non-causal MHA, D = 256
] + [(2, 77, 77, 4, 2, D, True, 0, None) for D in BWD_HEAD_DIMS]


def _card_inputs(case, dt, seed=6):
    return [torch.from_numpy(a).to("cuda", dt)
            for a in _inputs(seed, *case[:6])]


def _kernel_grads(q, k, v, dout, kw):
    q, k, v = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(q, k, v, **kw)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_CASES, ids=str)
def test_gpu_backward_vs_plain_autograd(dtype, case):
    """The backward kernels through FlashAttention against autograd
    through the plain version: f32 within BWD_F32_TOL of each gradient's
    largest magnitude, bf16 under bf16_grad_disagreement (the plain
    version at the kernel's key tile).  One forward launch and one backward
    call are counted."""
    _needs_card()
    dt = getattr(torch, dtype)
    q, k, v, dout = _card_inputs(case, dt)
    kw = _kw(case)
    n0 = flash_attention_kernel.launches
    b0 = flash_attention_bwd_kernel.launches
    got = _kernel_grads(q, k, v, dout, kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert flash_attention_bwd_kernel.launches == b0 + 1
    want = _plain_grads(q, k, v, dout, kw,
                        bk=256 if dtype == "float32" else KEY_TILE)
    for g in got:
        assert g.dtype == dt and bool(torch.isfinite(g).all())
    if dtype == "float32":
        _assert_rel(got[1:], want[1:], BWD_F32_TOL)
    else:
        for g, w in zip(got[1:], want[1:]):
            mx, mean = bf16_grad_disagreement(g, w)
            assert mx <= BWD_BF16_MAX and mean <= BWD_BF16_MEAN, (mx, mean)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(14, 2, 64), (16, 2, 128), (16, 1, 256)],
                         ids=str)
def test_gpu_backward_is_deterministic(dtype, heads):
    """Two backward calls on the same inputs give bit-identical dq, dk,
    dv (no atomics: each output is written once; GQA's head sum in a
    fixed order), at G = 7, D = 64, G = 8, D = 128 and G = 16, D = 256."""
    _needs_card()
    dt = getattr(torch, dtype)
    Hq, Hkv, D = heads
    case = (2, 300, 300, Hq, Hkv, D, True, 0, None)
    q, k, v, dout = _card_inputs(case, dt, seed=7)
    out, lse = flash_attention_kernel(q, k, v, lse=True)
    kw = dict(causal=True, window=0, kv_len=300, offset=0)
    a = flash_attention_bwd_kernel(q, k, v, out, dout, lse, **kw)
    b = flash_attention_bwd_kernel(q, k, v, out, dout, lse, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_forward_lse(dtype):
    """The forward's lse against the plain version's, and the output with
    lse written equal to the output without."""
    _needs_card()
    dt = getattr(torch, dtype)
    case = (2, 150, 333, 14, 2, 64, True, 100, 120)
    q, k, v, _ = _card_inputs(case, dt, seed=8)
    kw = dict(causal=True, window=100, offset=120)
    out, lse = flash_attention_kernel(q, k, v, lse=True, **kw)
    assert torch.equal(out, flash_attention_kernel(q, k, v, **kw))
    _, want = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(lse, want, atol=2e-5 if dtype == "float32"
                               else 1e-3, rtol=1e-5)


def _bwd_on_cluster(q, k, v, out, dout, lse, kw, c):
    """The bf16 backward launched through the C entry point on clusters of
    c blocks (the wrapper picks c by bwd_cluster): (dq, dk, dv)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import _bwd_entry
    lib, _, fn = _bwd_entry()
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    for which in (2, 1):
        build.check(lib, "flash_attention_bwd", fn(
            which, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(g.data_ptr() for g in grads), B, Sq, Skv, Hq, Hkv, D, Skv,
            kw["offset"], int(kw["causal"]), kw["window"],
            1.0 / math.sqrt(D), 1, c,
            torch.cuda.current_stream(q.device).cuda_stream))
    return grads


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    (2, 200, 200, 14, 2, 64, True, 0, None),     # G = 7
    (1, 150, 333, 16, 2, 128, True, 70, 120),    # G = 8, window, D = 128
    (1, 129, 129, 16, 1, 64, True, 0, None),     # G = 16
    (2, 77, 200, 9, 1, 32, False, 0, None),      # G = 9, non-causal
    (1, 200, 200, 16, 1, 256, True, 64, None),   # G = 16, window, D = 256
], ids=str)
def test_gpu_backward_on_every_cluster_size(case):
    """bf16 dK/dV on clusters of every size 1..min(G, 8) (the walks split
    unevenly where G nt is no multiple of it) against autograd through the
    plain version under bf16_grad_disagreement, each size's two runs
    bit-identical, and dq the same whatever the size."""
    _needs_card()
    q, k, v, dout = _card_inputs(case, torch.bfloat16, seed=9)
    kw = _kw(case)
    out, lse = flash_attention_kernel(q, k, v, lse=True, **kw)
    want = _plain_grads(q, k, v, dout, kw, bk=KEY_TILE)[1:]
    G = case[3] // case[4]
    first = None
    for c in range(1, min(G, 8) + 1):
        got = _bwd_on_cluster(q, k, v, out, dout, lse, kw, c)
        again = _bwd_on_cluster(q, k, v, out, dout, lse, kw, c)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), c
        for g, w in zip(got, want):
            mx, mean = bf16_grad_disagreement(g, w)
            assert mx <= BWD_BF16_MAX and mean <= BWD_BF16_MEAN, (c, mx, mean)
        first = first if first is not None else got[0]
        assert torch.equal(got[0], first), c


@pytest.mark.gpu
def test_gpu_hybrid_kernels_run_under_grad():
    """Under grad on the card linear_scan and flash at D = 256 launch their
    kernels forward and backward and return gradients of the inputs'
    shapes (they raised NotImplementedError before their backwards)."""
    from repro_torch.kernels.linear_scan import LinearScan, linear_scan_kernel
    _needs_card()
    a = torch.rand(1, 8, 16, device="cuda", requires_grad=True)
    x = torch.rand(1, 8, 16, device="cuda", requires_grad=True)
    n0, b0 = linear_scan_kernel.launches, LinearScan.backward_launches
    da, dx = torch.autograd.grad(ops.linear_scan(a, x).sum(), (a, x))
    assert da.shape == a.shape and dx.shape == x.shape
    assert linear_scan_kernel.launches == n0 + 2
    assert LinearScan.backward_launches == b0 + 1
    q, k, v = (torch.rand(1, 8, h, 256, device="cuda", dtype=torch.bfloat16,
                          requires_grad=True) for h in (2, 1, 1))
    f0 = flash_attention_kernel.launches
    g0 = flash_attention_bwd_kernel.launches
    out = ops.flash_attention(q, k, v, window=4)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert flash_attention_kernel.launches == f0 + 1
    assert flash_attention_bwd_kernel.launches == g0 + 1
