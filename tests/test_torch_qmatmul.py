"""repro_torch's int8 power-of-two matmul against the JAX package on the
CPU.

Inputs are seeded numpy int8 x and w and int32 exponents e drawn across
[-20, 20], with +13 and -13 always present.  The oracle is exact: the
int64 product, rounded once to f32, scaled in float64 by ``ldexp(1, -e)``
(a power of two, so exact) and cast back to f32.  The port's plain
version and its op ``ops.qmatmul`` equal that oracle bit for bit in every
column.  The reference -- ``qmatmul_ref``, the op ``repro.kernels.qmatmul``
(the Pallas kernel in interpret mode off a TPU, padded) and the Pallas
kernel ``qmatmul_kernel(..., interpret=True)`` itself -- builds its scale
with XLA's CPU ``exp2``, which is inexact at some integer exponents (13
and -13 among them).  So the columns are split by what XLA's ``exp2``
gives for each exponent, computed here as ``qmatmul_ref`` computes it:
where it is exact, reference and port are bit-identical; where it is not,
the reference differs from the exact oracle in every element whose sum is
non-zero, and the port does not.  No column is left unchecked.  bf16
output is the f32 product rounded to nearest even: the port's is the
oracle rounded, and equals the Pallas kernel's on the XLA-exact columns.
On the card (``gpu`` marker) the CUDA kernel equals the plain version bit
for bit on both of its routes.  On the CPU the route and split-K rules are
held as pure functions, and a split of K into int32 partial sums, added in
any order with wraparound, is held to the plain version at a sum past
2^31."""
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax.numpy as jnp
    from repro.kernels import qmatmul as jqmatmul
    from repro.kernels import ref as kref
    from repro.kernels.qmatmul import qmatmul_kernel as jqmatmul_kernel
except ImportError:
    jnp = None
from repro_torch.kernels import ops
from repro_torch.kernels.qmatmul import (Tiling, qmatmul_kernel,
                                         qmatmul_plain, route, tiling)

# the module (``repro_torch.kernels.qmatmul`` is the op, as in the
# reference)
qm = importlib.import_module("repro_torch.kernels.qmatmul")

# the reference tests' shapes (tests/test_kernels.py); (300, 700, 130)
# does not tile, so the Pallas kernel alone is run at the other four, with
# block sizes that tile them
SHAPES = [(256, 512, 256), (128, 1024, 128), (8, 512, 256), (300, 700, 130),
          (1024, 512, 512)]
PALLAS_BLOCKS = {(256, 512, 256): (256, 256, 512),
                 (128, 1024, 128): (128, 128, 512),
                 (8, 512, 256): (8, 256, 512),
                 (1024, 512, 512): (256, 256, 512)}


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    e = rng.integers(-20, 21, (N,)).astype(np.int32)
    e[: min(N, 2)] = [13, -13][: min(N, 2)]
    return x, w, e


def _oracle(x, w, e):
    """(int64 sums, exact f32 result) of x @ w * 2^-e."""
    acc = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(acc).max(initial=0) < 2 ** 31
    y = np.ldexp(acc.astype(np.float32).astype(np.float64), -e[None, :])
    return acc, y.astype(np.float32)


def _xla_exact(e):
    """Columns whose scale XLA's CPU exp2 gives exactly, computed as
    ``qmatmul_ref`` computes the scale."""
    xla = np.asarray(jnp.exp2(-jnp.asarray(e).astype(jnp.float32)))
    return xla == np.ldexp(np.float32(1), -e).astype(np.float32)


def _hold_reference(ref, port, acc, want, exact):
    """Bit-identical to the port on the XLA-exact columns; off the exact
    oracle in every element with a non-zero sum on the others."""
    ref = np.asarray(ref).astype(np.float32)
    np.testing.assert_array_equal(ref[:, exact], port[:, exact])
    inexact = ~exact
    nz = acc[:, inexact] != 0
    assert (ref[:, inexact] != want[:, inexact])[nz].all()


def _port(x, w, e, out_dtype=torch.float32):
    return qmatmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(e), out_dtype)


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_and_op_exact_and_match_reference(M, K, N):
    x, w, e = _inputs(M, K, N, seed=M + K + N)
    acc, want = _oracle(x, w, e)
    got = _port(x, w, e).numpy()
    op = ops.qmatmul(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(e))
    assert op.dtype == torch.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(op.numpy(), want)
    exact = _xla_exact(e)
    assert not exact[e == 13].any() and not exact[e == -13].any()
    jx, jw, je = jnp.asarray(x), jnp.asarray(w), jnp.asarray(e)
    _hold_reference(kref.qmatmul_ref(jx, jw, je), got, acc, want, exact)
    _hold_reference(jqmatmul(jx, jw, je), got, acc, want, exact)
    if (M, K, N) in PALLAS_BLOCKS:
        bm, bn, bk = PALLAS_BLOCKS[(M, K, N)]
        pallas = jqmatmul_kernel(jx, jw, je, bm=bm, bn=bn, bk=bk,
                                 interpret=True)
        _hold_reference(pallas, got, acc, want, exact)


@pytest.mark.parametrize("seed", range(10))
def test_random_small_shapes(seed):
    """The reference's property test's shape ranges, seeded."""
    rng = np.random.default_rng(1000 + seed)
    M, K, N = (int(rng.integers(1, 64)), int(rng.integers(1, 600)),
               int(rng.integers(1, 300)))
    x, w, e = _inputs(M, K, N, seed=seed)
    acc, want = _oracle(x, w, e)
    got = ops.qmatmul(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, want)
    exact = _xla_exact(e)
    jx, jw, je = jnp.asarray(x), jnp.asarray(w), jnp.asarray(e)
    _hold_reference(kref.qmatmul_ref(jx, jw, je), got, acc, want, exact)
    _hold_reference(jqmatmul(jx, jw, je), got, acc, want, exact)


@pytest.mark.parametrize("M,K,N", [(256, 512, 256), (8, 512, 256)])
def test_bf16_output(M, K, N):
    """bf16 is the f32 product rounded to nearest even, as the Pallas
    kernel's ``out_dtype=bfloat16`` rounds it: the port's is the exact
    oracle rounded, bit-identical to the Pallas kernel's on the XLA-exact
    columns; on the others the Pallas kernel rounds its own, inexact, f32
    product (``qmatmul_ref``'s), which the rounding often hides."""
    x, w, e = _inputs(M, K, N, seed=7)
    _, want = _oracle(x, w, e)
    got = _port(x, w, e, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(want).to(torch.bfloat16))
    jx, jw, je = jnp.asarray(x), jnp.asarray(w), jnp.asarray(e)
    bm, bn, bk = PALLAS_BLOCKS[(M, K, N)]
    pallas = jqmatmul_kernel(jx, jw, je, bm=bm, bn=bn, bk=bk,
                             out_dtype=jnp.bfloat16, interpret=True)
    assert pallas.dtype == jnp.bfloat16
    pallas = torch.from_numpy(np.array(pallas).astype(np.float32))
    exact = torch.from_numpy(_xla_exact(e))
    assert torch.equal(pallas[:, exact], got[:, exact].float())
    ref32 = torch.from_numpy(np.array(kref.qmatmul_ref(jx, jw, je)))
    assert torch.equal(pallas, ref32.to(torch.bfloat16).float())


def test_accumulator_wraps_like_int32():
    """Past 2^31 the sum wraps modulo 2^32, as the reference's int32
    accumulator does (an exponent of 0 keeps XLA's exp2 exact)."""
    K = 140_000                           # 128 * 128 * K > 2^31
    x = np.full((2, K), -128, np.int8)
    w = np.full((K, 3), -128, np.int8)
    w[:, 1] = 127
    e = np.zeros(3, np.int32)
    got = _port(x, w, e).numpy()
    ref = np.asarray(kref.qmatmul_ref(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(e)))
    wrapped = np.int64(128 * 128 * K)
    wrapped = (wrapped + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert got[0, 0] == np.float32(wrapped)
    np.testing.assert_array_equal(got, ref)


def test_cpu_tensors_take_the_plain_version():
    x, w, e = _inputs(9, 33, 17, seed=3)
    n0 = qmatmul_kernel.launches
    got = ops.qmatmul(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(e))
    assert qmatmul_kernel.launches == n0
    assert torch.equal(got, _port(x, w, e))


def test_kernel_refuses_cpu_tensors():
    x, w, e = (torch.from_numpy(t) for t in _inputs(9, 33, 17, seed=3))
    with pytest.raises(ValueError):
        qmatmul_kernel(x, w, e)


def test_public_export_is_the_op():
    """``repro_torch.kernels.qmatmul`` is the op, as in the reference; the
    module stays importable by its dotted name."""
    import repro_torch.kernels as kernels
    assert kernels.qmatmul is ops.qmatmul
    mod = sys.modules["repro_torch.kernels.qmatmul"]
    assert mod.qmatmul_kernel is qmatmul_kernel


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one byte past an
    aligned address (the kernel's byte-load path)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", SHAPES + [(1, 896, 4864), (1, 7, 3),
                                            (65, 129, 67), (8, 4864, 896)])
def test_gpu_kernel_bit_exact(M, K, N, out_dtype):
    """The CUDA kernel equals its plain version bit for bit on the card,
    ragged tiles and both load paths included; one launch is counted."""
    _needs_card()
    x, w, e = (torch.from_numpy(t).cuda() for t in _inputs(M, K, N, seed=2))
    n0 = qmatmul_kernel.launches
    got = qmatmul_kernel(x, w, e, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qmatmul_kernel.launches == n0 + 1
    assert got.dtype == out_dtype
    assert torch.equal(got, qmatmul_plain(x, w, e, out_dtype))
    odd = qmatmul_kernel(_misaligned(x), _misaligned(w), e,
                         out_dtype=out_dtype)
    assert torch.equal(odd, got)


@pytest.mark.gpu
def test_gpu_op_launches_the_kernel_and_checks_inputs():
    _needs_card()
    x, w, e = (torch.from_numpy(t).cuda() for t in _inputs(64, 96, 40, 5))
    n0 = qmatmul_kernel.launches
    got = ops.qmatmul(x, w, e)
    torch.cuda.synchronize()
    assert qmatmul_kernel.launches == n0 + 1
    assert torch.equal(got, qmatmul_plain(x, w, e))
    with pytest.raises(ValueError):
        qmatmul_kernel(x.to(torch.int32), w, e)
    with pytest.raises(ValueError):
        qmatmul_kernel(x, w.t(), e[:w.shape[0]])
    with pytest.raises(ValueError):
        qmatmul_kernel(x, w, e, out_dtype=torch.float16)


# qwen2-0.5b's int8-PoT widths (K, N): q / o, k / v, the gate, down, the
# embedding and the head (chip_smoke.py's qmatmul phase)
QWEN_WIDTHS = [(896, 896), (896, 128), (896, 4864), (4864, 896),
               (151936, 896), (896, 151936)]
# the TMA route's grid at those widths: (M, K, N) -> (bm, split, kt_per)
QWEN_TILING = {
    (8, 896, 896): (8, 1, 7), (8, 896, 128): (8, 1, 7),
    (8, 896, 4864): (8, 1, 7), (8, 4864, 896): (8, 7, 6),
    (8, 151936, 896): (8, 18, 66), (8, 896, 151936): (8, 1, 7),
    (512, 896, 896): (32, 1, 7), (512, 896, 128): (32, 1, 7),
    (512, 896, 4864): (64, 1, 7), (512, 4864, 896): (32, 1, 38),
    (512, 151936, 896): (32, 1, 1187), (512, 896, 151936): (64, 1, 7)}


def _smoke_shapes():
    """chip_smoke.py's QM_SHAPES, (label, (M, K, N)) each."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(label, s) for label, group in mod.QM_SHAPES.items()
            for s in group]


@pytest.mark.parametrize("M,K,N", sorted(QWEN_TILING))
def test_route_and_tiling_at_qwen_widths(M, K, N):
    """Every qwen width takes the TMA route, with the split written down
    in ``QWEN_TILING``; a 1-byte-offset view of x or w takes the mma
    route."""
    assert route(K, N, 0, 256) == "tma"
    assert route(K, N, 1, 256) == "mma" and route(K, N, 0, 257) == "mma"
    assert tiling(M, K, N) == Tiling(*QWEN_TILING[M, K, N])


def test_route_at_smoke_shapes():
    """The reference tests' (300, 700, 130) and M = 1's (1, 700, 130) have
    row pitches no tensor map takes; every other smoke shape is TMA's."""
    got = {s: route(s[1], s[2], 0, 0) for _, s in _smoke_shapes()}
    assert {s for s, r in got.items() if r == "mma"} == {(300, 700, 130),
                                                        (1, 700, 130)}
    assert route(0, 16, 0, 0) == "mma"          # K = 0: no tensor map


@pytest.mark.parametrize("seed", range(4))
def test_tiling_rule_invariants(seed):
    """bm is the power of two >= M in [8, 64], or 32 where 64 leaves
    fewer tiles than SMS; the split covers K's k-tiles with none empty;
    split only where the tiles are fewer than SMS, into walks of at least
    SPLIT_MIN_K_TILES k-tiles, and then the grid stays within SMS
    blocks."""
    rng = np.random.default_rng(seed)
    for _ in range(500):
        M = int(rng.integers(1, 2000))
        K = 16 * int(rng.integers(1, 12000))
        N = 16 * int(rng.integers(1, 12000))
        bm, split, kt_per = tiling(M, K, N)
        assert bm in (8, 16, 32, 64)
        chan = -(-N // qm.CHANNELS)
        if M > 32 and -(-M // 64) * chan < qm.SMS:
            assert bm == 32
        else:
            assert bm >= min(M, 64) and (bm == 8 or bm // 2 < M)
        n_k = -(-K // qm.K_TILE)
        assert split * kt_per >= n_k > (split - 1) * kt_per
        tiles = -(-M // bm) * -(-N // qm.CHANNELS)
        if tiles >= qm.SMS or n_k < 2 * qm.SPLIT_MIN_K_TILES:
            assert split == 1
        if split > 1:
            assert bm < 64 and tiles * split <= qm.SMS
            assert kt_per >= qm.SPLIT_MIN_K_TILES


def _wrapped(v):
    return (np.int64(v) + 2 ** 31) % 2 ** 32 - 2 ** 31


@pytest.mark.parametrize("seed", range(3))
def test_split_partial_sums_wrap_like_plain(seed):
    """x = w = -128 at K = 151936: 16384 x 151936 > 2^31.  K cut into any
    number of parts (the kernel's split at (8, 151936, 896) among them),
    each part's sum taken to int32 and the parts added in any order with
    int32 wraparound, gives the plain version's wrapped sum."""
    K = 151936
    rng = np.random.default_rng(seed)
    x = np.full((2, K), -128, np.int8)
    w = np.full((K, 3), -128, np.int8)
    w[:, 1] = 127
    w[:, 2] = rng.integers(-128, 128, K)
    e = np.zeros(3, np.int32)
    want = _port(x, w, e).numpy()
    assert want[0, 0] == np.float32(_wrapped(128 * 128 * K))
    kt = tiling(8, K, 896).kt_per * qm.K_TILE
    cuts = [list(range(kt, K, kt))]
    for _ in range(4):
        n = int(rng.integers(1, 60))
        cuts.append(sorted(set(rng.integers(1, K, n).tolist())))
    for cut in cuts:
        bounds = [0, *cut, K]
        parts = [(x[:, a:b].astype(np.int64) @ w[a:b].astype(np.int64))
                 .astype(np.int32) for a, b in zip(bounds, bounds[1:])]
        total = np.zeros((2, 3), np.int32)
        for i in rng.permutation(len(parts)):
            total += parts[i]                  # int32 arrays wrap
        np.testing.assert_array_equal(total.astype(np.float32), want)


def _count_route(fn):
    """(result, {route: launches}) of one call of ``fn``."""
    before = dict(qmatmul_kernel.route_launches)
    out = fn()
    return out, {r: qmatmul_kernel.route_launches[r] - before[r]
                 for r in before}


def _gpu_inputs(M, K, N, seed):
    return tuple(torch.from_numpy(t).cuda() for t in _inputs(M, K, N, seed))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 63, 64, 65, 512])
def test_gpu_tma_route_every_m_tile(M, out_dtype):
    """Each M tile (8 to 64, ragged included) on the TMA route, bit for
    bit against the plain version and the mma route, at a split (9728,
    128) and an unsplit (896, 4864) width."""
    _needs_card()
    assert tiling(M, 9728, 128).split > 1 and tiling(M, 896, 4864).split == 1
    for K, N in [(9728, 128), (896, 4864)]:
        x, w, e = _gpu_inputs(M, K, N, seed=M)
        got, used = _count_route(
            lambda: qmatmul_kernel(x, w, e, out_dtype=out_dtype))
        assert used == {"tma": 1, "mma": 0}
        mma, used = _count_route(
            lambda: qm.launch(x, w, e, out_dtype, "mma"))
        assert used == {"tma": 0, "mma": 1}
        torch.cuda.synchronize()
        assert torch.equal(got, qmatmul_plain(x, w, e, out_dtype))
        assert torch.equal(mma, got)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", sorted(QWEN_TILING))
def test_gpu_qwen_widths_bit_exact(M, K, N, out_dtype):
    """Every qwen width at M = 8 and 512 on the TMA route, the split-K
    ones (8, 4864, 896) and (8, 151936, 896) among them, e across
    [-20, 20]: bit for bit against the plain version."""
    _needs_card()
    if (M, K, N) in [(8, 4864, 896), (8, 151936, 896)]:
        assert tiling(M, K, N).split > 1
    x, w, e = _gpu_inputs(M, K, N, seed=K + N)
    got, used = _count_route(
        lambda: qmatmul_kernel(x, w, e, out_dtype=out_dtype))
    torch.cuda.synchronize()
    assert used == {"tma": 1, "mma": 0}
    assert torch.equal(got, qmatmul_plain(x, w, e, out_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("how", ["tma", "mma"])
def test_gpu_int32_wrap(how):
    """x = w = -128 at K = 151936 (a split-K shape on the TMA route):
    16384 x 151936 > 2^31 wraps modulo 2^32 on both routes."""
    _needs_card()
    K = 151936
    x = torch.full((8, K), -128, dtype=torch.int8, device="cuda")
    w = torch.full((K, 128), -128, dtype=torch.int8, device="cuda")
    w[:, 1] = 127
    e = torch.zeros(128, dtype=torch.int32, device="cuda")
    got, used = _count_route(lambda: qm.launch(x, w, e, torch.float32, how))
    torch.cuda.synchronize()
    assert used[how] == 1
    assert got[0, 0].item() == float(np.float32(_wrapped(128 * 128 * K)))
    assert got[0, 1].item() == float(np.float32(_wrapped(-128 * 127 * K)))
    assert torch.equal(got, qmatmul_plain(x, w, e))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gpu_routes_by_rule(out_dtype):
    """The rule's route is the one launched: TMA at an aligned qwen width,
    mma at a row pitch of 700 bytes and at a 1-byte-offset view; every
    result bit for bit to the plain version."""
    _needs_card()
    for (M, K, N), view, want in [((8, 896, 896), False, "tma"),
                                  ((300, 700, 130), False, "mma"),
                                  ((8, 896, 896), True, "mma")]:
        x, w, e = _gpu_inputs(M, K, N, seed=11)
        if view:
            x = _misaligned(x)
        got, used = _count_route(
            lambda: qmatmul_kernel(x, w, e, out_dtype=out_dtype))
        torch.cuda.synchronize()
        assert used[want] == 1 and sum(used.values()) == 1
        assert torch.equal(got, qmatmul_plain(x, w, e, out_dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bm,split", [(8, 1), (8, 3), (16, 1), (16, 3),
                                      (32, 1), (32, 3), (64, 1)])
def test_gpu_every_instantiation(bm, split, out_dtype):
    """Each M tile, split and unsplit (64 is never split), forced past the
    rule, at ragged M (two tiles and a row) and N (a partial channel
    tile): bit for bit; a split at 64 is refused at launch."""
    _needs_card()
    M, K, N = 2 * bm + 1, 4864, 912
    x, w, e = _gpu_inputs(M, K, N, seed=bm + split)
    n_k = -(-K // qm.K_TILE)
    tile = Tiling(bm, split, -(-n_k // split))
    got, used = _count_route(
        lambda: qm.launch(x, w, e, out_dtype, "tma", tile))
    torch.cuda.synchronize()
    assert used == {"tma": 1, "mma": 0}
    assert torch.equal(got, qmatmul_plain(x, w, e, out_dtype))
    if bm == 64:
        with pytest.raises(RuntimeError):
            qm.launch(x, w, e, out_dtype, "tma", Tiling(64, 2, 19))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(1, 16, 16), (5, 48, 16), (33, 16, 144),
                                   (9, 144, 48), (70, 272, 400)])
def test_gpu_tma_route_below_one_box(M, K, N):
    """K or N below the 128-byte box (TMA fills zeros past the array in
    both dimensions), every M tile ragged: on the TMA route, bit for bit
    against the plain version, f32 and bf16."""
    _needs_card()
    x, w, e = _gpu_inputs(M, K, N, seed=M + K + N)
    for out_dtype in (torch.float32, torch.bfloat16):
        got, used = _count_route(
            lambda: qmatmul_kernel(x, w, e, out_dtype=out_dtype))
        torch.cuda.synchronize()
        assert used == {"tma": 1, "mma": 0}
        assert torch.equal(got, qmatmul_plain(x, w, e, out_dtype))
