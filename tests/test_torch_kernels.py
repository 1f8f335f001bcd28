"""repro_torch kernels against the JAX package: the plain versions of the
paged gather (one leaf, and K and V through one table) and the fused paged
decode attention on the CPU (the attention's split-and-combine rule and its
split rule among them), and the CUDA kernels against their plain versions
on the card (``gpu`` marker)."""
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
from repro_torch.kernels.paged_attention import (SMS, BLOCKS_PER_SM,
                                                 paged_attention_kernel,
                                                 paged_attention_plain,
                                                 paged_attention_split_plain,
                                                 pow2_int, split_shape, splits)
from repro_torch.kernels.paged_gather import (ROUTES as GATHER_ROUTES,
                                              paged_gather_kernel,
                                              paged_gather_pair_kernel,
                                              paged_gather_plain)
from repro_torch.nn.layers import (_gather_kv_rows, gather_block_rows,
                                   paged_decode_attention_ref)


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


GATHER_SHAPES = [(10, 4, 2, 8, 3, 3), (7, 8, 1, 16, 2, 4), (12, 2, 3, 4, 4, 2)]


def _gather_case(NB, bs, H, D, B, nb, tdtype):
    """K and V pools and a table with sentinel entries NB, as numpy."""
    rng = np.random.default_rng(NB * 10 + bs + B)
    k = rng.normal(size=(NB, bs, H, D)).astype(np.float32)
    v = rng.normal(size=(NB, bs, H, D)).astype(np.float32)
    tbl = rng.integers(0, NB + 1, size=(B, nb)).astype(tdtype)
    tbl[0, -1] = NB                                   # a sentinel for sure
    tbl[-1, 0] = NB
    return k, v, tbl


@pytest.mark.parametrize("tdtype", ["int32", "int64"])
@pytest.mark.parametrize("NB,bs,H,D,B,nb", GATHER_SHAPES)
def test_gather_pair_plain_bit_exact_vs_jax(NB, bs, H, D, B, nb, tdtype):
    """The K+V helper's ``cuda`` engine (on the CPU: the plain version of
    each leaf) equals the JAX Pallas gather of each leaf bit for bit, with
    int32 and int64 tables holding the sentinel NB; so does its ``take``
    engine, and ``ops.paged_gather_pair``."""
    k, v, tbl = _gather_case(NB, bs, H, D, B, nb, tdtype)
    jt = jnp.asarray(tbl.astype(np.int32))
    want = [np.asarray(jops.paged_gather(jnp.asarray(a), jt)) for a in (k, v)]
    kt, vt, tt = _t(k, v, tbl)
    for engine in ("cuda", "take"):
        got = _gather_kv_rows(kt, vt, tt, engine=engine)
        for g, w in zip(got, want):
            assert g.shape == (B, nb * bs, H, D)
            np.testing.assert_array_equal(g.numpy(), w.reshape(g.shape))
    for g, w in zip(ops.paged_gather_pair(kt, vt, tt), want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("engine", ["take", "cuda"])
@pytest.mark.parametrize("tdtype", ["int32", "int64"])
@pytest.mark.parametrize("NB,bs,H,D,B,nb", GATHER_SHAPES)
def test_gather_block_rows_unchanged(NB, bs, H, D, B, nb, tdtype, engine):
    """``gather_block_rows`` keeps its contract on both engines: the JAX
    gather's logical rows, (B, nb * bs, H, D), whatever the table's
    integer type, and the table left as it was."""
    k, _, tbl = _gather_case(NB, bs, H, D, B, nb, tdtype)
    want = np.asarray(jops.paged_gather(jnp.asarray(k),
                                        jnp.asarray(tbl.astype(np.int32))))
    kt, tt = _t(k, tbl)
    got = gather_block_rows(kt, tt, engine=engine)
    assert got.shape == (B, nb * bs, H, D)
    np.testing.assert_array_equal(got.numpy(), want.reshape(got.shape))
    np.testing.assert_array_equal(tt.numpy(), tbl)


def test_gather_pair_refuses_what_it_cannot_take():
    """No fallback for the pair either, and its kernel takes one shape and
    dtype for both leaves and an int32 or int64 table."""
    leaf = torch.zeros((4, 2, 1, 8), device="meta")
    tbl = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.paged_gather_pair(leaf, leaf, tbl)
    with pytest.raises(ValueError, match="CUDA"):
        paged_gather_pair_kernel(torch.zeros(4, 2, 1, 8),
                                 torch.zeros(4, 2, 1, 8),
                                 torch.zeros(1, 2, dtype=torch.int32))


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


# lengths 1, bs, bs + 1 and the full row; with window 40 the slot of 48
# positions enters no block before position 8, so its first split is empty
SPLIT_LENS = [1, 8, 9, 48, 20, 33]


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("n_splits", [1, 2, 3, 6])
def test_split_plain_vs_plain_and_jax(n_splits, window):
    """The kernel's split-and-combine rule (plain version) at 1, 2, 3 and nb
    = 6 splits: within the kernel's f32 tolerance 2e-5 of the sequential
    plain loop and of the JAX Pallas kernel (interpret mode); at one split
    bit-identical to the sequential loop."""
    rng = np.random.default_rng(11 + n_splits + window)
    q, kp, vp, tbl, clen = _case(rng, 6, 14, 2, 16, 8, 6, lens=SPLIT_LENS)
    args = _t(q, kp, vp, tbl, clen)
    got = paged_attention_split_plain(*args, window=window,
                                      n_splits=n_splits)
    seq = paged_attention_plain(*args, window=window)
    want = np.asarray(jops.paged_attention(
        *[jnp.asarray(x) for x in (q, kp, vp, tbl, clen)], window=window))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    if n_splits == 1:
        np.testing.assert_array_equal(got.numpy(), seq.numpy())


@pytest.mark.parametrize("n_splits", [2, 6])
def test_split_plain_bf16_vs_plain(n_splits):
    """bf16 pools: the split rule within the kernel's bf16 tolerance (atol
    2e-3, rtol 1e-2) of the sequential loop, a window that empties the
    first splits included."""
    rng = np.random.default_rng(5)
    q, kp, vp, tbl, clen = _case(rng, 6, 14, 2, 16, 8, 6, lens=SPLIT_LENS)
    args = [x.to(torch.bfloat16) for x in _t(q, kp, vp)] + _t(tbl, clen)
    for window in (0, 40):
        got = paged_attention_split_plain(*args, window=window,
                                          n_splits=n_splits)
        want = paged_attention_plain(*args, window=window)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-3,
                                   rtol=1e-2)


def test_split_plain_enters_only_the_blocks_it_needs():
    """A split steps only over blocks inside the slot's length and window,
    and one that enters none keeps (NEG_INF, 0, 0): NaN in every block no
    slot enters (before the windows, the sentinel's NB - 1, the unused)
    leaves the output bitwise unchanged at 1, 3 and 6 splits."""
    rng = np.random.default_rng(12)
    q, kp, vp, tbl, clen = _case(rng, 2, 4, 2, 8, 8, 6, lens=[48, 41])
    window = 10
    entered = np.concatenate([tbl[b, (n - window) // 8:-(-n // 8)]
                              for b, n in enumerate(clen)])
    idle = np.setdiff1d(np.arange(kp.shape[0]), entered)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[idle], vp2[idle] = np.nan, np.nan
    for n in (1, 3, 6):
        clean = paged_attention_split_plain(*_t(q, kp, vp, tbl, clen),
                                            window=window, n_splits=n)
        dirty = paged_attention_split_plain(*_t(q, kp2, vp2, tbl, clen),
                                            window=window, n_splits=n)
        assert bool(torch.isfinite(dirty).all())
        np.testing.assert_array_equal(clean.numpy(), dirty.numpy())


@pytest.mark.parametrize("nb,n,want", [(32, 16, (16, 2)), (32, 17, (16, 2)),
                                       (32, 1, (1, 32)), (32, 99, (32, 1)),
                                       (4, 3, (2, 2)), (7, 4, (4, 2)),
                                       (128, 64, (32, 4))])
def test_split_shape(nb, n, want):
    """At most n (and 32, a lane each in the combine) splits of ceil(nb /
    n) blocks; none starts past nb."""
    S, c = split_shape(nb, n)
    assert (S, c) == want
    assert S <= max(1, min(n, nb, 32)) and (S - 1) * c < nb <= S * c


def test_split_rule_at_the_path_shapes():
    """Shapes only: the serving shape (8 slots, 2 KV heads, 32 blocks of
    32) splits into 16 runs of 2 blocks, 256 thread blocks, about two an
    SM; the tiny f32 model of the serving check (3 slots, 2 KV heads, 4
    blocks of 8) into one block a split; a grid that fills the card alone
    keeps one split."""
    assert splits(8, 2, 32) == (16, 2)
    assert 8 * 2 * 16 >= BLOCKS_PER_SM * SMS - 8 * 2
    assert splits(3, 2, 4) == (4, 1)
    assert splits(132, 2, 32) == (1, 32)
    assert splits(1, 1, 1) == (1, 1)


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
    c0 = paged_attention_kernel.combine_launches
    got = ops.paged_attention(*args, t, c, window=window)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == n0 + 1
    assert paged_attention_kernel.combine_launches == c0 + 1   # S = 16
    want = paged_attention_plain(*args, torch.clamp(t, max=kp.shape[0] - 1),
                                 c, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=0 if dtype == "float32" else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 2e-5, 0),
                                             ("bfloat16", 2e-3, 1e-2)])
@pytest.mark.parametrize("window", [0, 40, 200])
@pytest.mark.parametrize("n_splits", [1, 2, 4, 32])
def test_gpu_attention_forced_splits(n_splits, window, dtype, atol, rtol):
    """The CUDA kernel at a forced split count (S = 1, 2, 4 and one a
    block) against the sequential plain version: lengths 1, 32 (= bs), 33
    and 1024 (the whole row), sentinel tables, windows that empty the first
    splits; one launch a call, and one of the combine kernel for S > 1."""
    _needs_card()
    rng = np.random.default_rng(n_splits + window)
    q, kp, vp, tbl, clen = _case(rng, 4, 14, 2, 64, 32, 32,
                                 lens=[1, 32, 33, 1024])
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to("cuda", dt) for x in (q, kp, vp)]
    t = torch.clamp(torch.from_numpy(tbl).cuda(), max=kp.shape[0] - 1)
    c = torch.from_numpy(clen).cuda()
    n0 = paged_attention_kernel.launches
    c0 = paged_attention_kernel.combine_launches
    got = paged_attention_kernel(*args, t, c, window=window,
                                 n_splits=n_splits)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == n0 + 1
    assert paged_attention_kernel.combine_launches == c0 + (n_splits > 1)
    want = paged_attention_plain(*args, t, c, window=window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("Hq,Hkv,D,bs,dtype", [
    (14, 2, 128, 32, "bfloat16"),   # tensor cores, D = 128
    (14, 2, 64, 16, "bfloat16"),    # tensor cores, blocks of 16
    (14, 2, 64, 64, "bfloat16"),    # tensor cores, blocks of 64
    (32, 2, 64, 32, "bfloat16"),    # tensor cores, G = 16
    (4, 4, 64, 32, "bfloat16"),     # tensor cores, MHA
    (16, 16, 128, 32, "bfloat16"),  # tensor cores, MHA at D = 128: qwen2-moe
    (56, 8, 128, 32, "bfloat16"),   # tensor cores, G = 7 at D = 128: arctic
    (14, 2, 32, 32, "bfloat16"),    # CUDA cores: D = 32
    (34, 2, 64, 32, "bfloat16"),    # CUDA cores: G = 17
    (14, 2, 64, 8, "bfloat16"),     # CUDA cores: blocks of 8
    (4, 1, 16, 8, "float32"),       # CUDA cores, f32
])
@pytest.mark.parametrize("window", [0, 40])
def test_gpu_attention_kernel_shapes(Hq, Hkv, D, bs, dtype, window):
    """Both compute routes of the kernel (tensor cores for bf16 with G <=
    16, D in {64, 128} and bs in {16, 32, 64}; CUDA cores elsewhere)
    against the sequential plain version at the kernel's tolerances, split
    by the rule and into one split."""
    _needs_card()
    rng = np.random.default_rng(Hq + D + bs + window)
    nb = 256 // bs
    q, kp, vp, tbl, clen = _case(rng, 4, Hq, Hkv, D, bs, nb,
                                 lens=[1, bs, bs + 1, nb * bs])
    dt = getattr(torch, dtype)
    args = [torch.from_numpy(x).to("cuda", dt) for x in (q, kp, vp)]
    t = torch.clamp(torch.from_numpy(tbl).cuda(), max=kp.shape[0] - 1)
    c = torch.from_numpy(clen).cuda()
    want = paged_attention_plain(*args, t, c, window=window).float()
    atol, rtol = (2e-5, 0) if dtype == "float32" else (2e-3, 1e-2)
    for n_splits in (None, 1):
        got = paged_attention_kernel(*args, t, c, window=window,
                                     n_splits=n_splits)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want, atol=atol, rtol=rtol)


def _pool_view(rng, shape, dtype, offset):
    """A contiguous (NB, bs, H, D) pool ``offset`` elements into a larger
    buffer: off a 16-byte boundary for offset * itemsize % 16 != 0."""
    n = int(np.prod(shape))
    base = torch.from_numpy(rng.normal(size=n + offset).astype(np.float32))
    base = base.to("cuda", dtype)
    return base[offset:].view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("route", GATHER_ROUTES)
@pytest.mark.parametrize("tdtype", ["int32", "int64"])
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_gather_pair_bit_exact(dtype, bs, tdtype, route):
    """The pair kernel equals paged_gather_plain of each leaf on the clamped
    table bit for bit, sentinel entries read as NB - 1 by the kernel, with
    one launch a call; so does the one-leaf kernel."""
    _needs_card()
    rng = np.random.default_rng(bs)
    nb = 1024 // bs
    _, kp, vp, tbl, _ = _case(rng, 8, 14, 2, 64, bs, nb)
    dt = getattr(torch, dtype)
    k, v = (torch.from_numpy(a).to("cuda", dt) for a in (kp, vp))
    t = torch.from_numpy(tbl.astype(tdtype)).cuda()
    assert bool((t == kp.shape[0]).any())
    tc = torch.clamp(t, max=kp.shape[0] - 1)
    n0, s0 = paged_gather_pair_kernel.launches, paged_gather_kernel.launches
    gk, gv = paged_gather_pair_kernel(k, v, t, route=route)
    one = paged_gather_kernel(v, t, route=route)
    torch.cuda.synchronize()
    assert paged_gather_pair_kernel.launches == n0 + 1
    assert paged_gather_kernel.launches == s0 + 1
    assert torch.equal(gk, paged_gather_plain(k, tc))
    assert torch.equal(gv, paged_gather_plain(v, tc))
    assert torch.equal(one, gv)


@pytest.mark.gpu
@pytest.mark.parametrize("tdtype", ["int32", "int64"])
def test_gpu_gather_pair_at_the_serving_shape(tdtype):
    """One prefill dispatch's gather: pools (256, 32, 2, 64) bf16, a (4, 32)
    table with sentinels, through the model's helper: one pair launch and
    no other gather launch; each leaf bit for bit."""
    _needs_card()
    rng = np.random.default_rng(7)
    NB, bs, H, D, P, nb = 256, 32, 2, 64, 4, 32
    k = torch.from_numpy(rng.normal(size=(NB, bs, H, D)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    v = torch.from_numpy(rng.normal(size=(NB, bs, H, D)).astype(
        np.float32)).to("cuda", torch.bfloat16)
    tbl = rng.permutation(NB)[:P * nb].reshape(P, nb).astype(tdtype)
    tbl[1, 20:] = NB
    tbl[3, 5:] = NB
    t = torch.from_numpy(tbl).cuda()
    n0, s0 = paged_gather_pair_kernel.launches, paged_gather_kernel.launches
    krow, vrow = _gather_kv_rows(k, v, t, engine="cuda")
    torch.cuda.synchronize()
    assert paged_gather_pair_kernel.launches == n0 + 1
    assert paged_gather_kernel.launches == s0
    tc = torch.clamp(t.long(), max=NB - 1)
    assert torch.equal(krow, paged_gather_plain(k, tc).reshape(krow.shape))
    assert torch.equal(vrow, paged_gather_plain(v, tc).reshape(vrow.shape))
    assert torch.equal(krow, gather_block_rows(k, t, engine="take"))


@pytest.mark.gpu
@pytest.mark.parametrize("route", GATHER_ROUTES)
@pytest.mark.parametrize("dtype,offset", [("bfloat16", 1), ("float32", 1),
                                          ("float32", 2), ("bfloat16", 8)])
def test_gpu_gather_pair_off_16_bytes(dtype, offset, route):
    """Pools off a 16-byte boundary take the 4- or 1-byte vector kernel,
    pools on one (bf16 at offset 8) the rule's route; each bit for bit."""
    _needs_card()
    rng = np.random.default_rng(offset)
    NB, bs, H, D, B, nb = 40, 16, 2, 64, 3, 12
    dt = getattr(torch, dtype)
    k = _pool_view(rng, (NB, bs, H, D), dt, offset)
    v = _pool_view(rng, (NB, bs, H, D), dt, offset)
    tbl = rng.integers(0, NB + 1, size=(B, nb))
    tbl[0, -1] = NB
    t = torch.from_numpy(tbl).cuda()
    n0 = paged_gather_pair_kernel.launches
    gk, gv = ops.paged_gather_pair(k, v, t) if route == "bulk" else \
        paged_gather_pair_kernel(k, v, t, route=route)
    torch.cuda.synchronize()
    assert paged_gather_pair_kernel.launches == n0 + 1
    tc = torch.clamp(t, max=NB - 1)
    assert torch.equal(gk, paged_gather_plain(k, tc))
    assert torch.equal(gv, paged_gather_plain(v, tc))
