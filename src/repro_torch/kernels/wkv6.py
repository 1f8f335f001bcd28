"""The RWKV6 time mix's WKV recurrence over one layer's sequence.

Per (batch row b, head h) the state s is an (hd, hd) f32 matrix, rows i
on the key axis and columns j on the value axis, and each step t does::

    kv_ij  = k_i v_j
    out_j  = sum_i r_i (s_ij + u_i kv_ij)     (from the state before t)
    s_ij  <- w_i s_ij + kv_ij

r, k, v: (B, S, H, hd), all f32 or all bf16 (as the projections give
them); w: (B, S, H, hd) f32; u: (H, hd) f32; s0: (B, H, hd, hd) f32 ->
y (B, S, H, hd) f32 and the final state (B, H, hd, hd) f32, for any
B >= 1 and S >= 1 (S = 1 is a decode step from a carried state).  bf16
to f32 is exact, so bf16 r, k, v give the state their f32 upcasts give.

Source note.  :func:`wkv6_kernel` launches ``csrc/wkv6.cu``.  It replaces
no Pallas kernel: the reference runs this recurrence as a ``lax.scan``
over tokens (``repro/nn/blocks.py::rwkv_time_mix_seq``, its ``step``),
its one device loop on the RWKV path, and a token-by-token Python loop
would issue ~6 launches a token and layer.

What bounds it: FP32 issue slots at prefill and loss shapes, bytes at
decode.  The final state must equal :func:`wkv6_plain`'s bit for bit, so
the update stays ``__fadd_rn(__fmul_rn(w_i, s_ij), __fmul_rn(k_i,
v_j))``, three instructions a state entry a step, and the output one
FFMA: four issue slots a state entry a step, 160 us at (8, 1024, 40, 64)
and 105 us at (4, 1345, 40, 64) on an H100 SXM (132 SMs x 128 lanes x
1.98 GHz), above the bytes (91 / 59 us with bf16 r, k, v).  At decode the
state, read and written once, is the bound (1.6 us at (4, 1, 40, 64)).

Design (:func:`tiling` gives the sizes, a function of hd alone).  A (b,
h) chain is hd independent column chains, so the grid is (column block,
h, b): ``ncb`` blocks of ``cb`` columns a chain.  A block's ``w``
consumer warps hold ``c`` = 4 columns a thread, ``p`` = hd / 4 lanes
splitting the key axis (``r`` = 4 rows each), so one 16-byte shared load
each of r, k and w serves 16 state entries; they add a group of four
steps' partial outputs with ``__shfl_xor_sync`` after the group, no
barrier a step.  A producer warp keeps a ring of ``ns`` stages of ``t``
steps filled by TMA boxes of r, k, w and the block's v columns (the part
past S lands as zeros), computes the bonus term's scalar a_t = sum_i r_i
u_i k_i once a step (out_j = sum_i r_i s_ij + v_j a_t), converts bf16
inputs to f32 once a block, and stores each chunk's y as one TMA box;
threads wait on one mbarrier a chunk.  A decode step (S = 1,
:func:`route`) takes the step route: one block of hd threads a chain, a
thread a state column, the state read and written a whole row at a time
and a step's inputs shared through one barrier.  Predicted for the
first design on an NVIDIA H100 80GB HBM3 at 700 W, before its first run:
220-350 us at (8, 1024, 40, 64), 180-300 us at (4, 1345, 40, 64), 2.5-4.5
us at decode (4, 1); measured in ``PERF.md`` (row 10).

y differs from the plain version only in the order of its sums (the
plain ``einsum`` is a batched product; the kernel adds rows in its own
order, then a_t v_j).

The gradient (:class:`Wkv6`, :func:`wkv6_bwd_kernel`, ``csrc/wkv6_bwd.cu``;
the reference's XLA differentiates its scan).  With G_t = dL/dS_t (S_t the
state after step t, G_{S-1} the final state's incoming gradient ``dsT`` or
zeros), walking t from S - 1 down to 0::

    dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u_i k_t[i] c_t,  c_t = dy_t . v_t
    dk_t[i] = sum_j G_t[i,j] v_t[j]      + r_t[i] u_i c_t
    dv_t[j] = sum_i G_t[i,j] k_t[i]      + dy_t[j] a_t,   a_t = sum_i r u k
    dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
    du_i   += r_t[i] k_t[i] c_t                     (over b and t)
    G_{t-1} = w_t[i] G_t[i,j] + r_t[i] dy_t[j]      (ds0 = G_{-1})

S_{t-1} runs forward in time and G_t backward, and dividing by w_t (which
can come near 0) to walk S back is not exact, so the kernel rebuilds the
states from checkpoints with the forward's own update (see the source).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

__all__ = ["wkv6_plain", "wkv6_kernel", "wkv6_bwd_plain", "wkv6_bwd_kernel",
           "Wkv6", "HEAD_DIMS", "ROUTES", "Tiling", "tiling", "route",
           "BwdTiling", "bwd_tiling"]

HEAD_DIMS = (16, 32, 64, 128)   # the head widths the kernel is built for
ROUTES = ("ring", "step")       # the C entry's route ids 0, 1


class Tiling(NamedTuple):
    """The kernel's sizes at one hd (``Tiling<HD>`` in ``csrc/wkv6.cu``)."""
    p: int          # lanes splitting the key axis for a column group
    c: int          # columns a consumer thread holds
    r: int          # key rows a consumer thread holds
    g: int          # column groups a warp
    cb: int         # columns a block
    w: int          # consumer warps a block
    ncb: int        # blocks a (b, h) chain
    t: int          # steps a ring stage
    ns: int         # stages in the ring
    threads: int    # the consumers and one producer warp
    smem_f32: int   # shared bytes a block with f32 r, k, v
    smem_bf16: int  # ... with bf16 r, k, v


def tiling(hd: int) -> Tiling:
    """The kernel's tiling at head width ``hd`` (in :data:`HEAD_DIMS`): a
    pure function of hd, the same as the library's ``wkv6_tiling``."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes hd in {HEAD_DIMS}, not {hd}")
    r = 4
    p, c = hd // r, 2 if hd == 16 else 4
    g = 32 // p
    cb = 16 if hd == 16 else 32
    w = cb // (c * g)
    t, ns = 16, 2
    f32 = 4 * (3 * t * hd + 2 * t * cb) + 128           # f32 arrays and a
    half = 2 * (2 * t * hd + t * cb)                     # bf16 landing boxes
    return Tiling(p=p, c=c, r=r, g=g, cb=cb, w=w, ncb=hd // cb, t=t, ns=ns,
                  threads=32 * (w + 1), smem_f32=128 + ns * f32,
                  smem_bf16=128 + ns * (f32 + half))


def route(S: int) -> str:
    """The kernel's route for a sequence of S steps: ``step`` (each step's
    inputs straight from device memory) for a decode step, S = 1, where
    the ring's load, hand-off and store would be the whole time;
    ``ring`` otherwise."""
    return "step" if S == 1 else "ring"


def wkv6_plain(r, k, v, w, u, s0):
    """The reference's ``step`` in PyTorch, one token at a time, on the f32
    upcasts of its inputs: returns (y (B, S, H, hd) f32, the final state
    (B, H, hd, hd) f32)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    B, S, H, hd = r.shape
    s = s0.float()
    uu = u.float()[None, :, :, None]                      # key axis i
    y = torch.empty((B, S, H, hd), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # (B, H, i, j)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], s + uu * kv)
        s = w[:, t, :, :, None] * s + kv
    return y, s


@functools.cache
def _entry():
    lib = build.load("wkv6")
    fn = lib.wkv6
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def library_tiling(hd: int) -> Tiling:
    """The built library's ``Tiling<hd>`` (needs the build; on the card)."""
    lib, _ = _entry()
    out = (ctypes.c_int * 12)()
    if lib.wkv6_tiling(ctypes.c_int(hd), out) != 0:
        raise ValueError(f"wkv6 takes hd in {HEAD_DIMS}, not {hd}")
    return Tiling(*out)


def wkv6_kernel(r, k, v, w, u, s0, _route=None):
    """The CUDA kernel: :func:`wkv6_plain`'s contract on contiguous CUDA
    tensors, r, k, v all f32 or all bf16, w, u, s0 f32, each 16 bytes
    aligned; the final state bit-identical to it.  Raises ``ValueError``
    on anything else, an hd outside :data:`HEAD_DIMS` among it.  The
    route is :func:`route`'s unless ``_route`` (a test's) names one."""
    if not (r.is_cuda and all(t.device == r.device
                              for t in (k, v, w, u, s0))):
        raise ValueError("wkv6_kernel takes CUDA tensors on one device")
    if r.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != r.dtype for t in (k, v)):
        raise ValueError(f"wkv6_kernel takes r, k, v all float32 or all "
                         f"bfloat16, not {[t.dtype for t in (r, k, v)]}")
    if any(t.dtype != torch.float32 for t in (w, u, s0)):
        raise ValueError("wkv6_kernel takes float32 w, u and s0")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"r, k, v, w must share one (B, S, H, hd) shape, "
                         f"not {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6_kernel takes hd in {HEAD_DIMS}, not {hd}")
    if B < 1 or S < 1:
        raise ValueError(f"wkv6_kernel takes B >= 1 and S >= 1, not "
                         f"({B}, {S})")
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd):
        raise ValueError(f"bad shapes: u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)} for r {tuple(r.shape)}")
    if not all(t.is_contiguous() for t in (r, k, v, w, u, s0)):
        raise ValueError("wkv6_kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6_kernel needs r, k, v, w on 16-byte "
                         "boundaries (its TMA tensor maps)")
    how = route(S) if _route is None else _route
    if how not in ROUTES:
        raise ValueError(f"wkv6_kernel routes are {ROUTES}, not {how!r}")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    sS = torch.empty_like(s0)
    lib, fn = _entry()
    err = fn(*(t.data_ptr() for t in (r, k, v, w, u, s0, y, sS)),
             B, S, H, hd, int(r.dtype == torch.bfloat16), ROUTES.index(how),
             torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, "wkv6", err)
    wkv6_kernel.launches += 1
    wkv6_kernel.route_launches[how] += 1
    return y, sS


wkv6_kernel.launches = 0
wkv6_kernel.route_launches = dict.fromkeys(ROUTES, 0)


class BwdTiling(NamedTuple):
    """The backward kernel's sizes at one hd (``Bwd<HD>`` in
    ``csrc/wkv6_bwd.cu``)."""
    cb: int         # state columns a block
    ncb: int        # blocks a (b, h) chain
    tc: int         # steps a chunk (a checkpoint every tc steps)
    sw: int         # columns a row owner holds
    sh: int         # rows a column owner holds
    threads: int    # the row owners, then the column owners
    smem: int       # dynamic shared bytes a block


def bwd_tiling(hd: int) -> BwdTiling:
    """The backward kernel's tiling at head width ``hd`` (in
    :data:`HEAD_DIMS`): a pure function of hd, the same as the library's
    ``wkv6_bwd_tiling``."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes hd in {HEAD_DIMS}, not {hd}")
    cb = 32 if hd == 128 else hd
    tc = 16 if hd <= 32 else 8
    sw, sh = min(cb, 32), min(hd, 32)
    threads = hd * (cb // sw) + cb * (hd // sh)
    row = hd + hd // 32 * 4              # a staged row, padded
    smem = 4 * (tc * hd * cb + 5 * tc * row + 2 * tc + hd)
    return BwdTiling(cb=cb, ncb=hd // cb, tc=tc, sw=sw, sh=sh,
                     threads=threads, smem=smem)


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT=None):
    """The gradient of :func:`wkv6_plain` (the recurrence in the module's
    docstring), one token at a time on the f32 upcasts of r, k, v: returns
    (dr, dk, dv, dw (B, S, H, hd), du (H, hd), ds0 (B, H, hd, hd)), all
    f32.  ``dsT`` None is zeros.  The states S_{t-1} are rebuilt with
    :func:`wkv6_plain`'s own update, so they are its states bit for bit."""
    r, k, v, w, dy = (t.float() for t in (r, k, v, w, dy))
    B, S, H, hd = r.shape
    uu = u.float()
    states, s = [], s0.float()
    for t in range(S):
        states.append(s)
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    G = torch.zeros_like(s) if dsT is None else dsT.float()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(uu)
    for t in reversed(range(S)):
        sp, rt, kt, vt, dyt = states[t], r[:, t], k[:, t], v[:, t], dy[:, t]
        c = (dyt * vt).sum(-1, keepdim=True)                   # (B, H, 1)
        a = (rt * uu * kt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + uu * kt * c
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vt) + rt * uu * c
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) + dyt * a
        dw[:, t] = (G * sp).sum(-1)
        du += (rt * kt * c).sum(0)
        G = w[:, t, :, :, None] * G + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, G


@functools.cache
def _bwd_entry():
    lib = build.load("wkv6_bwd")
    fn = lib.wkv6_bwd
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def library_bwd_tiling(hd: int) -> BwdTiling:
    """The built library's ``Bwd<hd>`` (needs the build; on the card)."""
    lib, _ = _bwd_entry()
    out = (ctypes.c_int * 7)()
    if lib.wkv6_bwd_tiling(ctypes.c_int(hd), out) != 0:
        raise ValueError(f"wkv6 takes hd in {HEAD_DIMS}, not {hd}")
    return BwdTiling(*out)


def wkv6_bwd_kernel(r, k, v, w, u, s0, dy, dsT=None):
    """The CUDA backward: :func:`wkv6_bwd_plain`'s contract on contiguous
    CUDA tensors, r, k, v all f32 or all bf16, w, u, s0, dy and ``dsT``
    (None: zeros) f32.  One call, one count: the kernel, then a short one
    that adds du's per-row partials (and, at hd = 128, the column blocks'
    partial sums) in a fixed order; no atomics, so repeats are
    bit-identical.  Raises ``ValueError`` on anything else."""
    if not (r.is_cuda and all(t.device == r.device
                              for t in (k, v, w, u, s0, dy))):
        raise ValueError("wkv6_bwd_kernel takes CUDA tensors on one device")
    if r.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != r.dtype for t in (k, v)):
        raise ValueError(f"wkv6_bwd_kernel takes r, k, v all float32 or all "
                         f"bfloat16, not {[t.dtype for t in (r, k, v)]}")
    tail = (w, u, s0, dy) if dsT is None else (w, u, s0, dy, dsT)
    if any(t.dtype != torch.float32 for t in tail):
        raise ValueError("wkv6_bwd_kernel takes float32 w, u, s0, dy, dsT")
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w, dy)):
        raise ValueError(f"r, k, v, w, dy must share one (B, S, H, hd) "
                         f"shape, not "
                         f"{[tuple(t.shape) for t in (r, k, v, w, dy)]}")
    B, S, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6_bwd_kernel takes hd in {HEAD_DIMS}, not {hd}")
    if B < 1 or S < 1:
        raise ValueError(f"wkv6_bwd_kernel takes B >= 1 and S >= 1, not "
                         f"({B}, {S})")
    if tuple(u.shape) != (H, hd) or tuple(s0.shape) != (B, H, hd, hd) or (
            dsT is not None and dsT.shape != s0.shape):
        raise ValueError(f"bad shapes: u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)} for r {tuple(r.shape)}")
    if dsT is not None and dsT.device != r.device:
        raise ValueError("wkv6_bwd_kernel takes CUDA tensors on one device")
    if not all(t.is_contiguous() for t in (r, k, v) + tail):
        raise ValueError("wkv6_bwd_kernel needs contiguous inputs")
    t = bwd_tiling(hd)
    nck = -(-S // t.tc)
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (torch.empty(r.shape, **f32) for _ in range(4))
    du = torch.empty((H, hd), **f32)
    ds0 = torch.empty((B, H, hd, hd), **f32)
    ck = torch.empty(B * H * nck * hd * hd, **f32)      # the checkpoints
    du_part = torch.empty((B, H, hd), **f32)
    part = torch.empty((3, t.ncb) + tuple(r.shape) if t.ncb > 1 else (1,),
                       **f32)
    lib, fn = _bwd_entry()
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, s0, dy)]
    ptrs.append(0 if dsT is None else dsT.data_ptr())
    ptrs += [x.data_ptr() for x in (dr, dk, dv, dw, du, ds0, ck, du_part,
                                    part)]
    err = fn(*ptrs, B, S, H, hd, int(r.dtype == torch.bfloat16),
             torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, "wkv6_bwd", err)
    wkv6_bwd_kernel.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv6_bwd_kernel.launches = 0


class Wkv6(torch.autograd.Function):
    """The kernel pair under autograd: the forward kernel, unchanged, and
    the backward kernel.  Only the inputs are saved: under remat the
    forward runs again before the backward, so y or per-step states would
    only hold memory.  dr, dk, dv come back in r's dtype (computed in f32
    and cast once), dw, du, ds0 in f32."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, sT = wkv6_kernel(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return y, sT

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device) \
            if dy is None else dy.float().contiguous()
        if dsT is not None:
            dsT = dsT.float().contiguous()
        dr, dk, dv, dw, du, ds0 = wkv6_bwd_kernel(r, k, v, w, u, s0, dy, dsT)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du,
                ds0)
