"""The CSD digit-plane kernels of repro_torch against the JAX package: the
plain versions of ``csd_matvec`` and ``csd_qsweep`` on the CPU against the
Pallas kernels (interpret mode) and ``csd_matvec_ref``, bit for bit, and
the CUDA kernels against their plain versions on the card (``gpu``
marker)."""
import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.ref import csd_matvec_ref
except ImportError:
    jnp = None
from repro_torch.kernels import ops
from repro_torch.kernels.csd_matvec import (csd_matvec_kernel,
                                            csd_matvec_plain,
                                            csd_qsweep_kernel,
                                            csd_qsweep_plain)


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
