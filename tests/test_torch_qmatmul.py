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
for bit."""
import sys

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
from repro_torch.kernels.qmatmul import qmatmul_kernel, qmatmul_plain

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
