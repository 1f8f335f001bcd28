"""repro_torch's flash attention against the JAX package on the CPU: the
plain version and the port's ``chunked_attention`` against the Pallas
``flash_attention`` (interpret mode), JAX ``chunked_attention`` and
``kref.flash_attention_ref``, within 2e-5; rows that see no key give what
JAX ``chunked_attention`` gives.  On the card (``gpu`` marker) the CUDA
kernel against its plain version."""
import math

import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax.numpy as jnp
    from repro.kernels import flash_attention as jflash
    from repro.kernels import ref as kref
    from repro.kernels.flash_attention import \
        flash_attention_kernel as jflash_kernel
    from repro.nn.layers import chunked_attention as jchunked
except ImportError:
    jnp = None
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (BF16_SHARE, HEAD_DIMS,
                                                 KEY_TILE, bf16_disagreement,
                                                 flash_attention_kernel,
                                                 flash_attention_plain)
from repro_torch.nn.layers import chunked_attention

TOL = 2e-5          # f32: the reference's own kernel-vs-oracle tolerance

# the reference's cases (tests/test_kernels.py) and a windowed
# cross-length one: rows 0..99 at positions 200..299, window 40
CASES = [
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 128, True, 0),
    (2, 100, 300, 4, 1, 64, True, 0),     # padding + cross-length causal
    (1, 256, 256, 4, 2, 64, True, 64),    # local window
    (2, 64, 200, 4, 4, 32, False, 0),     # non-causal
    (1, 100, 300, 4, 1, 64, True, 40),    # window + cross-length
]


def _qkv(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, Sq, Hq, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(0, 1, (B, Skv, Hkv, D)).astype(np.float32))


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window", CASES)
def test_flash_plain_vs_pallas_and_oracle(B, Sq, Skv, Hq, Hkv, D, causal,
                                          window):
    """The wrapper's plain route against the Pallas kernel (interpret mode)
    and the materialized oracle, at the reference test's tiles."""
    x = _qkv(1, B, Sq, Skv, Hq, Hkv, D)
    got = ops.flash_attention(*_t(x), causal=causal, window=window, bk=64)
    assert got.shape == (B, Sq, Hq, D) and got.dtype == torch.float32
    _close(got, jflash(*_j(x), causal=causal, window=window, bq=64, bk=64))
    _close(got, kref.flash_attention_ref(*_j(x), causal=causal,
                                         window=window))
    direct = flash_attention_plain(*_t(x), causal=causal, window=window,
                                   bk=64)
    assert torch.equal(direct, got)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,window", CASES)
def test_chunked_attention_vs_jax(B, Sq, Skv, Hq, Hkv, D, causal, window):
    """The port's chunked_attention against the JAX one at q_offset 0 and
    at the kernel's alignment Skv - Sq, and (aligned) against the
    oracle."""
    x = _qkv(2, B, Sq, Skv, Hq, Hkv, D)
    for q_offset in sorted({0, Skv - Sq}):
        kw = dict(causal=causal, window=window, block_kv=48,
                  q_offset=q_offset)
        got = chunked_attention(*_t(x), **kw)
        _close(got, jchunked(*_j(x), block_q=64, **kw))
        if q_offset == Skv - Sq:
            _close(got, kref.flash_attention_ref(*_j(x), causal=causal,
                                                 window=window))


def test_rows_that_see_no_key():
    """Sq > Skv, causal: rows 0..55 sit before every key.  The port walks
    every block, as the JAX scan does, and gives its mean of v over them;
    the Pallas kernel's causal skip walks fewer tiles for those rows and
    gives another mean, and the same values on every row that sees a
    key."""
    x = _qkv(3, 1, 96, 40, 2, 1, 32)
    kw = dict(causal=True, block_kv=32, q_offset=-56)
    scan = np.asarray(jchunked(*_j(x), block_q=32, **kw))
    _close(chunked_attention(*_t(x), **kw), scan)
    _close(ops.flash_attention(*_t(x), causal=True, bk=32), scan)
    pallas = np.asarray(jflash(*_j(x), causal=True, bq=32, bk=32))
    assert np.abs(pallas[:, :56] - scan[:, :56]).max() > 1e-2
    _close(pallas[:, 56:], scan[:, 56:])


def test_window_and_offset_rows_that_see_no_key():
    """A window and an explicit offset push rows 58..63 past kv_len: the
    Pallas kernel itself (kv_len < Skv, offset given) and the plain
    version agree on every row that sees a key, and the plain version
    gives a row that sees none the mean of v over every key it walks."""
    x = _qkv(4, 2, 64, 96, 4, 2, 16)
    kw = dict(causal=True, window=9, kv_len=70, offset=20, bk=32)
    got = flash_attention_plain(*_t(x), **kw)
    want = jflash_kernel(*_j(x), interpret=True, bq=32, **kw)
    _close(got[:, :58], np.asarray(want)[:, :58])
    v = _t(x)[2]
    mean = v.repeat_interleave(2, dim=2).mean(dim=1, keepdim=True)
    _close(got[:, 58:], mean.expand(-1, 6, -1, -1))
    kw.update(causal=False, window=0)
    _close(flash_attention_plain(*_t(x), **kw),
           jflash_kernel(*_j(x), interpret=True, bq=32, **kw))


# (key tile, head dim): the CUDA-core kernel's 32 keys, and the bf16
# kernel's tile at qwen2-0.5b's D = 64 and recurrentgemma-9b's D = 256
TILE_RULE = [(32, 32), (KEY_TILE, 64), (KEY_TILE, 256)]


@pytest.mark.parametrize("bk,D", TILE_RULE)
def test_bf16_plain_rounds_p_like_the_reference(bk, D):
    """bf16 inputs: p is rounded to bf16 before the PV product in both
    packages.  At one key tile both round p against the same running max,
    so they are held to the kernel's bf16 check (``bf16_disagreement``);
    with p left unrounded the plain version fails it."""
    x = _qkv(5, 1, 2 * bk, 2 * bk, 4, 2, D)
    xb = [t.to(torch.bfloat16) for t in _t(x)]
    got = flash_attention_plain(*xb, bk=bk)
    want = jflash(*[a.astype(jnp.bfloat16) for a in _j(x)], bq=32, bk=bk)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16
    ratio, share = bf16_disagreement(got, want)
    assert ratio <= 1 and share <= BF16_SHARE, (ratio, share)
    unrounded = flash_attention_plain(*[t.float() for t in xb], bk=bk)
    assert bf16_disagreement(unrounded.bfloat16(), want)[1] > BF16_SHARE


def test_kernel_and_wrapper_refuse_what_they_cannot_run():
    x = _t(_qkv(6, 1, 8, 8, 2, 1, 16))
    with pytest.raises(ValueError):
        flash_attention_kernel(*x)             # CPU tensors
    meta = [t.to("meta") for t in x]
    with pytest.raises(RuntimeError):
        ops.flash_attention(*meta)             # no kernel for this device


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


GPU_CASES = CASES + [
    (2, 70, 70, 4, 2, 16, True, 9, 13),   # rows past kv_len: no key seen
    (1, 96, 40, 2, 1, 32, True, 0, None),  # rows before every key
    (2, 129, 129, 14, 2, 64, True, 0, None),   # GQA 7:1, ragged tile
    (2, 300, 300, 16, 1, 256, True, 100, None),
    (1, 333, 333, 14, 14, 64, True, 0, None),  # MHA
    (2, 1, 300, 14, 2, 64, True, 0, None),     # one query row
    (1, 77, 205, 4, 2, 64, True, 0, None),     # Sq, Skv off every tile
    (1, 150, 333, 16, 1, 256, True, 100, 120),  # MQA 16:1, window, offset
    (2, 190, 190, 16, 16, 128, True, 0, None),  # MHA at D = 128: qwen2-moe
] + [(2, 190, 190, 4, 2, D, True, 0, None) for D in HEAD_DIMS]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GPU_CASES, ids=str)
def test_gpu_flash_kernel_vs_plain(dtype, case):
    """The CUDA kernel against its plain version on the card: f32 (the
    CUDA cores) within 2e-5 at a key tile of 48, bf16 (the tensor cores)
    at the kernel's own key tile under ``bf16_disagreement``'s limits.
    One launch is counted."""
    _needs_card()
    B, Sq, Skv, Hq, Hkv, D, causal, window = case[:8]
    offset = case[8] if len(case) > 8 else None
    dt = getattr(torch, dtype)
    q, k, v = (t.to("cuda", dt) for t in _t(_qkv(6, B, Sq, Skv, Hq, Hkv, D)))
    kw = dict(causal=causal, window=window, offset=offset,
              bk=48 if dtype == "float32" else KEY_TILE)
    n0 = flash_attention_kernel.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    kw.update(kv_len=Skv, offset=Skv - Sq if offset is None else offset)
    want = flash_attention_plain(q, k, v, **kw)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    else:
        ratio, share = bf16_disagreement(got, want)
        assert ratio <= 1 and share <= BF16_SHARE, (ratio, share)


@pytest.mark.gpu
def test_gpu_chunked_attention_routes_through_the_kernel():
    """chunked_attention on CUDA tensors launches the kernel (no knob) and
    matches its CPU result."""
    _needs_card()
    x = _t(_qkv(7, 2, 200, 200, 14, 2, 64))
    kw = dict(causal=True, block_kv=64)
    n0 = flash_attention_kernel.launches
    got = chunked_attention(*[t.cuda() for t in x], **kw)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    torch.testing.assert_close(got.cpu(), chunked_attention(*x, **kw),
                               atol=TOL, rtol=TOL)
    assert math.isfinite(got.abs().max().item())


@pytest.mark.gpu
def test_gpu_each_route_counts_one_launch():
    """An f32 call (CUDA cores) and a bf16 call (tensor cores) each add
    one launch to the counter."""
    _needs_card()
    x = _t(_qkv(8, 1, 100, 100, 4, 2, 64))
    for dt in (torch.float32, torch.bfloat16):
        n0 = flash_attention_kernel.launches
        out = flash_attention_kernel(*[t.to("cuda", dt) for t in x])
        torch.cuda.synchronize()
        assert flash_attention_kernel.launches == n0 + 1
        assert out.dtype == dt and bool(torch.isfinite(out).all())


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 256])
def test_gpu_bf16_rows_that_see_no_key_walk_padded_tiles(D):
    """bf16, window 9 and offset 40 over 70 keys: rows 38..63 see no key
    and walk all kv_pad = 512 keys, tiles wholly past the array among
    them (read as zeros): the mean of v over 512 keys, as the plain
    version at bk = 512 gives it.  The rows that see a key match the plain
    version at the kernel's own tile, which kv_pad does not move."""
    _needs_card()
    q, k, v = (t.to("cuda", torch.bfloat16)
               for t in _t(_qkv(9, 2, 64, 70, 4, 2, D)))
    kw = dict(causal=True, window=9, offset=40)
    got = flash_attention_kernel(q, k, v, bk=512, **kw)
    for rows, bk in ((slice(38, None), 512), (slice(None, 38), KEY_TILE)):
        want = flash_attention_plain(q, k, v, bk=bk, **kw)
        ratio, share = bf16_disagreement(got[:, rows], want[:, rows])
        assert ratio <= 1 and share <= BF16_SHARE, (rows, ratio, share)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 20)])
def test_gpu_kv_len_short_of_the_array(dtype, causal, window):
    """kv_len = 70 of Skv = 96 keys and an explicit offset, causal or a
    window alone: both routes against the plain version (f32 within 2e-5,
    bf16 at ``KEY_TILE`` under ``bf16_disagreement``)."""
    _needs_card()
    dt = getattr(torch, dtype)
    q, k, v = (t.to("cuda", dt) for t in _t(_qkv(10, 2, 75, 96, 8, 2, 64)))
    kw = dict(causal=causal, window=window, kv_len=70, offset=10,
              bk=64 if dtype == "float32" else KEY_TILE)
    got = flash_attention_kernel(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    else:
        ratio, share = bf16_disagreement(got, want)
        assert ratio <= 1 and share <= BF16_SHARE, (ratio, share)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_no_keys_gives_zeros(dtype):
    """Skv = 0: no key to walk, l = acc = 0, so both routes give zeros, as
    the plain version does; one launch is counted."""
    _needs_card()
    dt = getattr(torch, dtype)
    q = torch.ones((1, 5, 4, 64), device="cuda", dtype=dt)
    k = torch.ones((1, 0, 2, 64), device="cuda", dtype=dt)
    n0 = flash_attention_kernel.launches
    got = flash_attention_kernel(q, k, k.clone(), causal=False)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == n0 + 1
    assert torch.equal(got, flash_attention_plain(q, k, k, causal=False))
    assert not got.any()
