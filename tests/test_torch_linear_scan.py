"""repro_torch's linear scan ``h_t = a_t h_{t-1} + x_t`` against the JAX
package on the CPU: the plain version against ``linear_scan_ref`` and the
Pallas kernel in interpret mode within 1e-5 (f32 sums of up to 256 steps
in another grouping: XLA may fuse the step into one FMA), and bit for bit
against a numpy float32 loop that rounds the product and the sum apart.
The route rule (``linear_scan.route``) is a pure function of S, W and the
base addresses, pinned here at the hybrid's shapes.  On the card (``gpu``
marker) every route of the CUDA kernel equals the plain version bit for
bit: the int32 views are compared, so -0.0 and +0.0 differ."""
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
from repro_torch.kernels.linear_scan import (ROUTES, STEP_MAX_S,
                                             linear_scan_kernel,
                                             linear_scan_plain, route)

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


# (S, W, base addresses of a, x, h) -> route.  H_PRE stands for the
# hybrid's first prefill batch (about 1345 steps); 4096 is its RG-LRU width.
H_PRE, BASE = 1345, 0x7F0000000000
ROUTE_CASES = [
    (1, 4096, (BASE, BASE + 2**20, BASE + 2**21), "step"),     # decode
    (2, 4096, (BASE, BASE + 2**20, BASE + 2**21), "step"),
    (STEP_MAX_S, 4096, (BASE, BASE, BASE), "step"),
    (1, 70, (BASE, BASE, BASE), "tiled"),
    (3, 33, (BASE, BASE, BASE), "tiled"),
    (1, 4096, (BASE + 4, BASE, BASE), "tiled"),               # offset view
    (STEP_MAX_S + 1, 4096, (BASE, BASE, BASE), "ring"),
    (4096, 4096, (BASE, BASE + 2**26, BASE + 2**27), "ring"),  # Model.loss
    (H_PRE, 4096, (BASE, BASE + 2**26, BASE + 2**27), "ring"),  # prefill
    (257, 4100, (BASE, BASE, BASE), "ring"),
    (100, 70, (BASE, BASE, BASE), "tiled"),                   # the reference's
    (129, 33, (BASE, BASE, BASE), "tiled"),
    (4096, 4096, (BASE + 4, BASE, BASE), "tiled"),            # offset view
    (4096, 4096, (BASE, BASE + 8, BASE), "tiled"),
]


@pytest.mark.parametrize("S,W,ptrs,want", ROUTE_CASES)
def test_route_rule(S, W, ptrs, want):
    assert route(S, W, *ptrs) == want


def test_route_of_a_storage_offset_view():
    """A contiguous view one float into its storage keeps the offset in
    its address (``.contiguous()`` does not copy it), so it leaves the
    bulk-copy routes; a view 4 floats in keeps them."""
    n = 2 * 64 * 4096
    store = torch.zeros(4 + n)
    assert store.data_ptr() % 16 == 0
    for off, want in ((1, "tiled"), (4, "ring")):
        v = store[off:off + n].view(2, 64, 4096).contiguous()
        assert v.data_ptr() == store.data_ptr() + 4 * off
        assert route(64, 4096, v.data_ptr(), store.data_ptr(),
                     store.data_ptr()) == want


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


def _bits_equal(got, want):
    """Bit for bit: torch.equal alone takes -0.0 for +0.0."""
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


GPU_SHAPES = SHAPES + [(3, 1, 4096), (1, 129, 33), (4, 700, 4096),
                       (1, 4096, 4096), (4, H_PRE, 4096), (1, 257, 4096),
                       (2, 3, 4096), (3, 1, 4100), (4, 1, 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,W", GPU_SHAPES)
def test_gpu_kernel_bit_exact(B, S, W):
    """The CUDA kernel equals its plain version bit for bit on the card,
    on the route :func:`route` picks, ragged tiles (S past a tile, W % 32)
    included; one launch is counted."""
    _needs_card()
    a, x = (torch.from_numpy(t).cuda() for t in _inputs(B, S, W))
    n0 = linear_scan_kernel.launches
    how = route(S, W, a.data_ptr(), x.data_ptr(), a.data_ptr())
    r0 = linear_scan_kernel.route_launches[how]
    got = ops.linear_scan(a, x)
    torch.cuda.synchronize()
    assert linear_scan_kernel.launches == n0 + 1
    assert linear_scan_kernel.route_launches[how] == r0 + 1
    assert _bits_equal(got, linear_scan_plain(a, x))


@pytest.mark.gpu
@pytest.mark.parametrize("how", ROUTES)
@pytest.mark.parametrize("B,S,W", [(2, 3, 4096), (1, 257, 4100),
                                   (2, 300, 64)])
def test_gpu_every_route_forced(how, B, S, W):
    """Each route, forced, at a short, a ragged and a narrow shape, with
    signed zeros in x and a = 0 steps: bit for bit, one launch."""
    _needs_card()
    a, x = _inputs(B, S, W, seed=6)
    a[:, ::5] = 0.0
    x[:, ::7] = -0.0
    a, x = torch.from_numpy(a).cuda(), torch.from_numpy(x).cuda()
    n0 = linear_scan_kernel.route_launches[how]
    got = linear_scan_kernel(a, x, how=how)
    torch.cuda.synchronize()
    assert linear_scan_kernel.route_launches[how] == n0 + 1
    assert _bits_equal(got, linear_scan_plain(a, x))


@pytest.mark.gpu
@pytest.mark.parametrize("off", [1, 4])
def test_gpu_storage_offset_view(off):
    """A contiguous view at a storage offset: off 16 bytes the scan takes
    the tiled route, on them the ring; bit for bit either way, and the
    bulk-copy routes refuse the view that breaks their rule."""
    _needs_card()
    B, S, W = 2, 300, 4096
    a, x = _inputs(B, S, W, seed=7)
    n = B * S * W
    sa = torch.zeros(off + n, device="cuda")
    sx = torch.zeros(off + n, device="cuda")
    sa[off:] = torch.from_numpy(a).cuda().reshape(-1)
    sx[off:] = torch.from_numpy(x).cuda().reshape(-1)
    av, xv = sa[off:].view(B, S, W), sx[off:].view(B, S, W)
    want = "tiled" if off % 4 else "ring"
    n0 = linear_scan_kernel.route_launches[want]
    got = ops.linear_scan(av, xv)
    torch.cuda.synchronize()
    assert linear_scan_kernel.route_launches[want] == n0 + 1
    assert _bits_equal(got, linear_scan_plain(av, xv))
    if off % 4:
        for how in ("ring", "step"):
            with pytest.raises(ValueError):
                linear_scan_kernel(av, xv, how=how)
