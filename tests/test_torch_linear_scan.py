"""repro_torch's linear scan ``h_t = a_t h_{t-1} + x_t`` against the JAX
package on the CPU: the plain version against ``linear_scan_ref`` and the
Pallas kernel in interpret mode within 1e-5 (f32 sums of up to 256 steps
in another grouping: XLA may fuse the step into one FMA), and bit for bit
against a numpy float32 loop that rounds the product and the sum apart.
On the card (``gpu`` marker) the CUDA kernel equals the plain version bit
for bit."""
import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax.numpy as jnp
    from repro.kernels.linear_scan import linear_scan as jlinear_scan
    from repro.kernels.linear_scan import linear_scan_ref as jlinear_scan_ref
except ImportError:
    jnp = None
from repro_torch.kernels import ops
from repro_torch.kernels.linear_scan import (linear_scan_kernel,
                                             linear_scan_plain)

TOL = 1e-5
SHAPES = [(2, 64, 128), (1, 100, 70), (2, 256, 256)]   # the reference's


def _inputs(B, S, W, seed=4):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 1.0, (B, S, W)).astype(np.float32)
    x = rng.normal(0, 0.1, (B, S, W)).astype(np.float32)
    return a, x


@pytest.mark.parametrize("B,S,W", SHAPES)
def test_plain_matches_ref_and_pallas(B, S, W):
    a, x = _inputs(B, S, W)
    got = linear_scan_plain(torch.from_numpy(a), torch.from_numpy(x)).numpy()
    ref = np.asarray(jlinear_scan_ref(jnp.asarray(a), jnp.asarray(x)))
    pallas = np.asarray(jlinear_scan(jnp.asarray(a), jnp.asarray(x), bt=32,
                                     bw=64, interpret=True))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)


def test_plain_rounds_product_and_sum_apart():
    """The plain version is the two-rounding step the kernel copies: a
    numpy float32 loop gives the same bits."""
    a, x = _inputs(2, 50, 33, seed=5)
    h = np.zeros((2, 33), np.float32)
    want = np.empty_like(a)
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + x[:, t]
        want[:, t] = h
    got = linear_scan_plain(torch.from_numpy(a), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version():
    a, x = _inputs(1, 7, 5)
    n0 = linear_scan_kernel.launches
    got = ops.linear_scan(torch.from_numpy(a), torch.from_numpy(x))
    assert linear_scan_kernel.launches == n0
    want = linear_scan_plain(torch.from_numpy(a), torch.from_numpy(x))
    assert torch.equal(got, want)


def test_kernel_refuses_cpu_tensors():
    a, x = _inputs(1, 7, 5)
    with pytest.raises(ValueError):
        linear_scan_kernel(torch.from_numpy(a), torch.from_numpy(x))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,W", SHAPES + [(3, 1, 4096), (1, 129, 33),
                                            (4, 700, 4096)])
def test_gpu_kernel_bit_exact(B, S, W):
    """The CUDA kernel equals its plain version bit for bit on the card,
    ragged tiles (S % 64, W % 32) included; one launch is counted."""
    _needs_card()
    a, x = (torch.from_numpy(t).cuda() for t in _inputs(B, S, W))
    n0 = linear_scan_kernel.launches
    got = ops.linear_scan(a, x)
    torch.cuda.synchronize()
    assert linear_scan_kernel.launches == n0 + 1
    assert torch.equal(got, linear_scan_plain(a, x))
