"""repro_torch kernels against the JAX package: the plain versions of the
paged gather and the fused paged decode attention on the CPU, and the CUDA
kernels against their plain versions on the card (``gpu`` marker)."""
import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.nn.layers import paged_decode_attention_ref as jax_paged_ref
except ImportError:
    jnp = None
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                 paged_attention_plain,
                                                 pow2_int)
from repro_torch.kernels.paged_gather import paged_gather_kernel
from repro_torch.nn.layers import gather_block_rows, paged_decode_attention_ref


def _case(rng, B, Hq, Hkv, D, bs, nb, *, extra_blocks=3, lens=None):
    """numpy pool + per-row permutation block table with the sentinel NB at
    every logical block past the row's needed count."""
    NB = B * nb + extra_blocks
    kp = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(NB, bs, Hkv, D)).astype(np.float32)
    q = rng.normal(size=(B, 1, Hq, D)).astype(np.float32)
    if lens is None:
        lens = rng.integers(1, nb * bs + 1, size=B)
    clen = np.asarray(lens, np.int32)
    tbl = rng.permutation(NB)[:B * nb].reshape(B, nb).astype(np.int32)
    need = np.maximum(-(-clen // bs), 1)
    for b in range(B):
        tbl[b, need[b]:] = NB
    return q, kp, vp, tbl, clen


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


# ----------------------------------------------------------- paged gather

@pytest.mark.parametrize("NB,bs,H,D,B,nb", [
    (10, 4, 2, 8, 3, 3), (7, 8, 1, 16, 2, 4), (12, 2, 3, 4, 4, 2)])
def test_gather_plain_bit_exact_vs_jax(NB, bs, H, D, B, nb):
    """The plain gather equals the JAX Pallas gather (interpret mode) bit
    for bit, sentinel entries (NB, clamped to NB - 1) included."""
    rng = np.random.default_rng(NB * 10 + bs)
    leaf = rng.normal(size=(NB, bs, H, D)).astype(np.float32)
    tbl = rng.integers(0, NB + 1, size=(B, nb)).astype(np.int32)
    tbl[0, -1] = NB                                   # a sentinel for sure
    want = np.asarray(jops.paged_gather(jnp.asarray(leaf), jnp.asarray(tbl)))
    leaf_t, tbl_t = _t(leaf, tbl)
    got = ops.paged_gather(leaf_t, tbl_t).numpy()
    np.testing.assert_array_equal(got, want)
    rows = gather_block_rows(leaf_t, tbl_t, engine="cuda").numpy()
    np.testing.assert_array_equal(
        rows, gather_block_rows(leaf_t, tbl_t, engine="take").numpy())
    assert rows.shape == (B, nb * bs, H, D)


# ------------------------------------------------ fused paged attention

@pytest.mark.parametrize("B,Hq,Hkv,D,bs,nb,window", [
    (4, 4, 2, 16, 8, 4, 0),       # GQA G=2
    (3, 8, 8, 8, 4, 5, 0),        # MHA
    (2, 4, 1, 32, 16, 2, 0),      # MQA G=4
    (4, 4, 2, 16, 8, 4, 5),       # window smaller than a block
    (2, 6, 2, 8, 8, 3, 13),       # window crossing block boundaries
    (2, 14, 2, 16, 4, 6, 0),      # the qwen2 group G=7, many small blocks
])
def test_attention_plain_vs_jax(B, Hq, Hkv, D, bs, nb, window):
    """f32, atol 1e-6 (only summation order differs): the port's
    ``ops.paged_attention`` on the CPU against the JAX Pallas kernel
    (interpret mode) and the JAX scan reference."""
    rng = np.random.default_rng(B * 100 + Hq * 10 + window)
    q, kp, vp, tbl, clen = _case(rng, B, Hq, Hkv, D, bs, nb)
    jargs = [jnp.asarray(x) for x in (q, kp, vp, tbl, clen)]
    want_k = np.asarray(jops.paged_attention(*jargs, window=window))
    want_r = np.asarray(jax_paged_ref(*jargs, window=window))
    got = ops.paged_attention(*_t(q, kp, vp, tbl, clen), window=window)
    np.testing.assert_allclose(got.numpy(), want_k, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_r, rtol=0, atol=1e-6)
    ref = paged_decode_attention_ref(*_t(q, kp, vp, tbl, clen), window=window)
    np.testing.assert_allclose(ref.numpy(), want_r, rtol=0, atol=1e-6)


def test_attention_non_dividing_lengths():
    """Every cache length from 1 to the full row, final block partially
    masked: the port matches the JAX kernel within atol 1e-6 (f32)."""
    rng = np.random.default_rng(7)
    bs, nb = 8, 3
    for ln in range(1, nb * bs + 1):
        q, kp, vp, tbl, clen = _case(rng, 2, 4, 2, 8, bs, nb,
                                     lens=[ln, nb * bs + 1 - ln])
        want = np.asarray(jops.paged_attention(
            *[jnp.asarray(x) for x in (q, kp, vp, tbl, clen)]))
        got = ops.paged_attention(*_t(q, kp, vp, tbl, clen)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=ln)


def test_attention_sentinel_blocks_contribute_exactly_zero():
    """Poisoning every block outside the rows' needed sets leaves the
    plain version bitwise unchanged (masked weight is exactly 0)."""
    rng = np.random.default_rng(8)
    q, kp, vp, tbl, clen = _case(rng, 3, 4, 2, 16, 8, 4)
    used = np.unique(tbl[tbl < kp.shape[0]])
    poison = np.ones(kp.shape[0], bool)
    poison[used] = False
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[poison], vp2[poison] = 1e4, -1e4
    clean = ops.paged_attention(*_t(q, kp, vp, tbl, clen))
    dirty = ops.paged_attention(*_t(q, kp2, vp2, tbl, clen))
    np.testing.assert_array_equal(clean.numpy(), dirty.numpy())


def test_attention_scalar_cache_len_and_effective_table():
    """A scalar cache_len serves every row, and the effective-table remap
    is invisible: the wrapper equals the plain loop on the raw table."""
    rng = np.random.default_rng(10)
    q, kp, vp, tbl, _ = _case(rng, 3, 4, 2, 8, 4, 3, lens=[9, 9, 9])
    args = _t(q, kp, vp, tbl)
    vec = ops.paged_attention(*args, torch.tensor([9, 9, 9], dtype=torch.int32))
    sca = ops.paged_attention(*args, 9)
    raw = paged_attention_plain(*args, 9)
    np.testing.assert_array_equal(vec.numpy(), sca.numpy())
    np.testing.assert_array_equal(vec.numpy(), raw.numpy())


def test_pow2_int_exact():
    """pow2_int is the exact power of two on [-126, 0], 0 below, and agrees
    with the JAX helper bit for bit."""
    from repro.kernels.paged_attention import pow2_int as jax_pow2
    d = np.concatenate([np.arange(-200, 1), [-1e30]]).astype(np.float32)
    got = pow2_int(torch.from_numpy(d)).numpy()
    want = np.where(d >= -126, np.ldexp(np.float32(1), np.maximum(
        d, -126).astype(np.int32)), 0).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_pow2(jnp.asarray(d))))


def test_wrappers_raise_off_cpu_without_kernel():
    """No fallback: a tensor that is neither on the CPU nor on the card
    reaches no plain version, and a kernel refuses CPU tensors."""
    leaf = torch.zeros((4, 2, 1, 8), device="meta")
    tbl = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.paged_gather(leaf, tbl)
    with pytest.raises(ValueError, match="CUDA"):
        paged_gather_kernel(torch.zeros(4, 2, 1, 8),
                            torch.zeros(1, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_kernel(*[torch.zeros(1)] * 5)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_gather_kernel_bit_exact(dtype):
    """The CUDA gather equals index_select on the clamped table bit for
    bit, and counts its launch."""
    _needs_card()
    rng = np.random.default_rng(0)
    q, kp, vp, tbl, clen = _case(rng, 8, 14, 2, 64, 32, 32)
    leaf = torch.from_numpy(kp).to("cuda", getattr(torch, dtype))
    t = torch.from_numpy(tbl).cuda()
    n0 = paged_gather_kernel.launches
    got = ops.paged_gather(leaf, t)
    torch.cuda.synchronize()
    assert paged_gather_kernel.launches == n0 + 1
    want = leaf.index_select(
        0, torch.clamp(t.long(), max=leaf.shape[0] - 1).reshape(-1))
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-3)])
@pytest.mark.parametrize("window", [0, 40])
def test_gpu_attention_kernel_vs_plain(dtype, atol, window):
    """The CUDA kernel against its plain version on the card: f32 within
    2e-5, bf16 outputs within 2e-3 + 1e-2 rel (summation order differs;
    bf16 rounds the output)."""
    _needs_card()
    rng = np.random.default_rng(1)
    q, kp, vp, tbl, clen = _case(rng, 8, 14, 2, 64, 32, 32)
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to("cuda", dt) for x in (q, kp, vp)]
    t, c = torch.from_numpy(tbl).cuda(), torch.from_numpy(clen).cuda()
    n0 = paged_attention_kernel.launches
    got = ops.paged_attention(*args, t, c, window=window)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == n0 + 1
    want = paged_attention_plain(*args, torch.clamp(t, max=kp.shape[0] - 1),
                                 c, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=0 if dtype == "float32" else 1e-2)
