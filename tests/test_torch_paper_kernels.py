"""The CSD digit-plane kernels of repro_torch against the JAX package: the
plain versions of ``csd_matvec`` and ``csd_qsweep`` on the CPU against the
Pallas kernels (interpret mode) and ``csd_matvec_ref``, bit for bit, the
``csd_qsweep`` and ``csd_matvec`` route rules at the paper's layer shapes,
and the CUDA kernels against their plain versions on the card (``gpu``
marker), both routes of each among them."""
import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.ref import csd_matvec_ref
except ImportError:
    jnp = None
from repro_torch.configs.pendigits_mlp import STRUCTURES
from repro_torch.kernels import ops
from repro_torch.kernels.csd_matvec import (MATVEC_ROUTES, ROUTES,
                                            csd_matvec_kernel,
                                            csd_matvec_plain,
                                            csd_qsweep_kernel,
                                            csd_qsweep_plain, route,
                                            route_matvec)


def _weights(rng, shape, depth):
    """Integers whose CSD needs up to ``depth`` digits, zeros included."""
    hi = (1 << depth) // 3 + 1
    w = rng.integers(-hi, hi + 1, size=shape)
    w[rng.random(shape) < 0.2] = 0
    return w.astype(np.int64)


def _acts(rng, shape):
    """8-bit activations, negatives included."""
    return rng.integers(-128, 128, size=shape).astype(np.int32)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.parametrize("M,K,N,depth", [
    (7, 5, 3, 1),          # odd shapes, D = 1 (every weight in {-1, 0, 1})
    (33, 17, 11, 9),       # odd M, N, K
    (130, 16, 10, 20),     # a deep D, past one 128-row tile
    (1, 1, 1, 4),
])
def test_csd_matvec_plain_vs_jax(M, K, N, depth):
    rng = np.random.default_rng(M * 100 + K)
    x = _acts(rng, (M, K))
    w = _weights(rng, (K, N), depth)
    planes = ops.csd_expand(w)
    np.testing.assert_array_equal(planes, np.asarray(jops.csd_expand(w)))
    want = np.asarray(jops.csd_matvec(jnp.asarray(x), planes=jnp.asarray(planes)))
    np.testing.assert_array_equal(
        want, np.asarray(csd_matvec_ref(jnp.asarray(x), jnp.asarray(planes))))
    got = ops.csd_matvec(torch.from_numpy(x), planes=planes)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.csd_matvec(torch.from_numpy(x), w_int=w).numpy(), want)
    np.testing.assert_array_equal(want, x.astype(np.int64) @ w)


@pytest.mark.parametrize("Q,M,K,N", [(3, 9, 7, 5), (4, 40, 16, 10),
                                     (1, 5, 3, 2)])
def test_csd_qsweep_plain_vs_jax(Q, M, K, N):
    """Networks of different depths stacked at a shared depth: the zero
    planes that pad the shallower ones add nothing."""
    rng = np.random.default_rng(Q * 10 + M)
    x = _acts(rng, (Q, M, K))
    ws = [_weights(rng, (K, N), d) for d in (2, 12, 5, 7)[:Q]]
    planes = ops.csd_expand_stack(ws)
    np.testing.assert_array_equal(planes, np.asarray(jops.csd_expand_stack(ws)))
    assert planes.shape[1] == max(ops.csd_expand(w).shape[0] for w in ws)
    want = np.asarray(jops.csd_qsweep(jnp.asarray(x), jnp.asarray(planes),
                                      bm=128, bn=128))
    got = ops.csd_qsweep(torch.from_numpy(x), planes)
    assert got.dtype == torch.int32 and got.shape == (Q, M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    for q in range(Q):
        np.testing.assert_array_equal(want[q], x[q].astype(np.int64) @ ws[q])


def test_plain_wraps_like_int32():
    """Out of int32 range the plain version wraps modulo 2^32, as the
    reference's int32 sum does."""
    x = np.full((2, 3), 2 ** 30, np.int32)
    x[1] = -(2 ** 31)
    w = np.array([[5, -7], [3, 1], [9, 30]], np.int64)
    planes = ops.csd_expand(w)
    want = np.asarray(csd_matvec_ref(jnp.asarray(x), jnp.asarray(planes)))
    got = csd_matvec_plain(torch.from_numpy(x), torch.from_numpy(planes))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = (x.astype(np.int64) @ w + 2 ** 31) % 2 ** 32 - 2 ** 31
    np.testing.assert_array_equal(got.numpy(), exact)


@pytest.mark.parametrize("structure", STRUCTURES)
def test_qsweep_route_rule_at_the_paper_layers(structure):
    """Every layer of the paper's five structures (the paper path's
    16-16-10-10 and the explorer's 16-16-10 among them: K, N in {10, 16})
    takes the resident route."""
    for K, N in zip(structure[:-1], structure[1:]):
        assert route(K, N) == "resident", (K, N)


@pytest.mark.parametrize("K,N,want", [
    (19, 5, "resident"), (1, 1, "resident"), (24, 24, "resident"),
    (32, 32, "chunked"), (200, 70, "chunked"), (37, 200, "chunked"),
    (4096, 1, "chunked")])
def test_qsweep_route_rule_by_shared_memory(K, N, want):
    """Resident where the padded weights, a 64-row tile of x and y and 32
    planes fit 48 KB, chunked elsewhere; a pure function of (K, N)."""
    assert route(K, N) == want
    smem = 4 * (K * 4 * -(-N // 4) + 64 * (K + N)) + 32 * K * N
    assert (smem <= 48 * 1024) == (want == "resident")


@pytest.mark.parametrize("structure", STRUCTURES)
def test_matvec_route_rule_at_the_paper_layers(structure):
    """Every layer of the paper's five structures, each dense-tail layer
    among them (K, N in {10, 16}), takes csd_matvec's streaming route."""
    for K, N in zip(structure[:-1], structure[1:]):
        assert route_matvec(K, N) == "streaming", (K, N)


@pytest.mark.parametrize("K,N,want", [
    (10, 10, "streaming"), (16, 16, "streaming"), (1, 1, "streaming"),
    (37, 45, "streaming"), (200, 70, "planes"), (64, 64, "planes"),
    (4096, 1, "planes")])
def test_matvec_route_rule_by_shared_memory(K, N, want):
    """Streaming where the padded weights, 3 stages of a 128-row x tile
    (widened by 8 words) and 2 of y fit 112 KB, planes elsewhere; a pure
    function of (K, N)."""
    assert route_matvec(K, N) == want
    smem = 64 + 4 * (K * 4 * -(-N // 4) + 3 * (128 * K + 8) + 2 * 128 * N)
    assert (smem <= 112 * 1024) == (want == "streaming")


def test_no_fallback_off_cpu():
    """A tensor that is neither on the CPU nor on the card reaches no plain
    version, and the kernels refuse CPU tensors."""
    x = torch.zeros((4, 3), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.csd_matvec(x, planes=np.zeros((1, 3, 2), np.int8))
    with pytest.raises(RuntimeError, match="no kernel"):
        ops.csd_qsweep(x[None], np.zeros((1, 1, 3, 2), np.int8))
    with pytest.raises(ValueError, match="CUDA"):
        csd_matvec_kernel(torch.zeros((4, 3), dtype=torch.int32),
                          torch.zeros((1, 3, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="CUDA"):
        csd_qsweep_kernel(torch.zeros((1, 4, 3), dtype=torch.int32),
                          torch.zeros((1, 1, 3, 2), dtype=torch.int8))


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,depth", [
    (287744, 10, 10, 16),  # one polish call's tail: 128 candidates x 2248
    (2248, 16, 16, 1), (1001, 37, 45, 9), (3, 200, 70, 30)])
def test_gpu_csd_matvec_bit_exact(M, K, N, depth):
    """The CUDA kernel equals its plain version bit for bit and counts its
    launch."""
    _needs_card()
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(_acts(rng, (M, K))).cuda()
    planes = torch.from_numpy(ops.csd_expand(_weights(rng, (K, N), depth),
                                             depth=depth)).cuda()
    n0 = csd_matvec_kernel.launches
    got = ops.csd_matvec(x, planes=planes)
    torch.cuda.synchronize()
    assert csd_matvec_kernel.launches == n0 + 1
    assert torch.equal(got, csd_matvec_plain(x, planes))


@pytest.mark.gpu
@pytest.mark.parametrize("Q,M,K,N", [(4, 2248, 16, 16), (4, 2248, 16, 10),
                                     (4, 2248, 10, 10), (3, 77, 19, 5)])
def test_gpu_csd_qsweep_bit_exact(Q, M, K, N):
    _needs_card()
    rng = np.random.default_rng(Q * M + N)
    x = torch.from_numpy(_acts(rng, (Q, M, K))).cuda()
    planes = torch.from_numpy(ops.csd_expand_stack(
        [_weights(rng, (K, N), d) for d in (3, 11, 6, 8)[:Q]])).cuda()
    n0 = csd_qsweep_kernel.launches
    got = ops.csd_qsweep(x, planes)
    torch.cuda.synchronize()
    assert csd_qsweep_kernel.launches == n0 + 1
    assert torch.equal(got, csd_qsweep_plain(x, planes))


def _stack_at_depth(rng, Q, K, N, depth, digits):
    """Q networks' planes at the shared depth ``depth``, their weights
    needing up to ``digits[q]`` CSD digits."""
    return np.stack([ops.csd_expand(_weights(rng, (K, N), d), depth=depth)
                     for d in digits[:Q]])


@pytest.mark.gpu
@pytest.mark.parametrize("how", ROUTES)
@pytest.mark.parametrize("Q,M,K,N,D", [
    (4, 2248, 16, 16, 8), (4, 2248, 16, 10, 8), (4, 2248, 10, 16, 8),
    (4, 2248, 10, 10, 8),           # the sweeps' layers
    (3, 77, 19, 5, 11),             # odd shapes, rows past one tile
    (2, 130, 16, 10, 40),           # planes d >= 32 add 0 mod 2^32
    (1, 1, 3, 1, 1)])
def test_gpu_csd_qsweep_routes_bit_exact(Q, M, K, N, D, how):
    """Both csd_qsweep routes equal the plain version bit for bit; each
    call counts one launch on its route."""
    _needs_card()
    rng = np.random.default_rng(Q * M + K * N + D)
    x = torch.from_numpy(_acts(rng, (Q, M, K))).cuda()
    planes = torch.from_numpy(_stack_at_depth(
        rng, Q, K, N, D, (min(D, 8), D, 3, D))).cuda()
    assert planes.shape == (Q, D, K, N)
    n0, r0 = csd_qsweep_kernel.launches, dict(csd_qsweep_kernel.route_launches)
    got = csd_qsweep_kernel(x, planes, how=how)
    torch.cuda.synchronize()
    assert csd_qsweep_kernel.launches == n0 + 1
    assert csd_qsweep_kernel.route_launches == {
        r: r0[r] + (r == how) for r in ROUTES}
    assert torch.equal(got, csd_qsweep_plain(x, planes))


@pytest.mark.gpu
@pytest.mark.parametrize("how", ROUTES)
def test_gpu_csd_qsweep_wraps_like_int32(how):
    """Activations near +-2^31: products and sums wrap modulo 2^32 on both
    routes exactly as the plain version's int32 does."""
    _needs_card()
    rng = np.random.default_rng(3)
    x = rng.integers(-2 ** 31, 2 ** 31, size=(2, 300, 16)).astype(np.int32)
    planes = _stack_at_depth(rng, 2, 16, 10, 12, (12, 9))
    xt, pt = torch.from_numpy(x).cuda(), torch.from_numpy(planes).cuda()
    got = csd_qsweep_kernel(xt, pt, how=how)
    want = csd_qsweep_plain(xt, pt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ws = [csd_matvec_plain(torch.eye(16, dtype=torch.int32),
                           torch.from_numpy(p)).numpy() for p in planes]
    exact = np.stack([(x[q].astype(np.int64) @ ws[q] + 2 ** 31) % 2 ** 32
                      - 2 ** 31 for q in range(2)])
    np.testing.assert_array_equal(got.cpu().numpy(), exact)


def _x_view(rng, shape, offset, lo=-128, hi=128):
    """Contiguous int32 activations ``offset`` words into a larger buffer:
    off a 16-byte boundary for offset % 4 != 0."""
    n = int(np.prod(shape))
    base = torch.from_numpy(rng.integers(lo, hi, size=n + offset).astype(
        np.int32)).cuda()
    return base[offset:].view(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("how", MATVEC_ROUTES)
@pytest.mark.parametrize("M,K,N,D", [
    (287744, 10, 10, 8),            # one polish call's tail
    (1, 10, 10, 8), (127, 10, 10, 8), (129, 10, 10, 8), (1001, 10, 10, 8),
    (2248, 16, 16, 8), (2248, 16, 10, 8), (2248, 10, 16, 8),
    (1001, 37, 45, 9),              # odd K, N: the generic column loop
    (130, 16, 10, 40)])             # planes d >= 32 add 0 mod 2^32
def test_gpu_csd_matvec_routes_bit_exact(M, K, N, D, how):
    """Both csd_matvec routes equal the plain version bit for bit; each
    call counts one launch on its route."""
    _needs_card()
    rng = np.random.default_rng(M + K * N + D)
    x = torch.from_numpy(_acts(rng, (M, K))).cuda()
    planes = torch.from_numpy(ops.csd_expand(_weights(rng, (K, N), D),
                                             depth=D)).cuda()
    assert planes.shape == (D, K, N)
    n0 = csd_matvec_kernel.launches
    r0 = dict(csd_matvec_kernel.route_launches)
    got = csd_matvec_kernel(x, planes, how=how)
    torch.cuda.synchronize()
    assert csd_matvec_kernel.launches == n0 + 1
    assert csd_matvec_kernel.route_launches == {
        r: r0[r] + (r == how) for r in MATVEC_ROUTES}
    assert torch.equal(got, csd_matvec_plain(x, planes))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("M,K,N", [(1001, 10, 10), (300, 16, 16),
                                   (257, 37, 45)])
def test_gpu_csd_matvec_streaming_x_off_16_bytes(M, K, N, offset):
    """x a view 1-4 words into its buffer: the streaming route widens each
    tile's copy to 16-byte boundaries and reads past the words it adds."""
    _needs_card()
    rng = np.random.default_rng(M + offset)
    x = _x_view(rng, (M, K), offset)
    planes = torch.from_numpy(ops.csd_expand(_weights(rng, (K, N), 8),
                                             depth=8)).cuda()
    r0 = csd_matvec_kernel.route_launches["streaming"]
    got = ops.csd_matvec(x, planes=planes)
    torch.cuda.synchronize()
    assert csd_matvec_kernel.route_launches["streaming"] == r0 + 1
    assert torch.equal(got, csd_matvec_plain(x, planes))


@pytest.mark.gpu
@pytest.mark.parametrize("how", MATVEC_ROUTES)
def test_gpu_csd_matvec_wraps_like_int32(how):
    """Activations across int32's range: products and sums wrap modulo
    2^32 on both csd_matvec routes exactly as int32 does."""
    _needs_card()
    rng = np.random.default_rng(5)
    x = rng.integers(-2 ** 31, 2 ** 31, size=(1001, 10)).astype(np.int32)
    planes = ops.csd_expand(_weights(rng, (10, 10), 12), depth=12)
    xt, pt = torch.from_numpy(x).cuda(), torch.from_numpy(planes).cuda()
    got = csd_matvec_kernel(xt, pt, how=how)
    want = csd_matvec_plain(xt, pt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    w = csd_matvec_plain(torch.eye(10, dtype=torch.int32),
                         torch.from_numpy(planes)).numpy()
    exact = (x.astype(np.int64) @ w + 2 ** 31) % 2 ** 32 - 2 ** 31
    np.testing.assert_array_equal(got.cpu().numpy(), exact)
