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
the reference's XLA differentiates its scan) is taken with respect to log
w: the model's decay is w = exp(-exp(dd)), so autograd needs d/d(log w)
anyway.  With G_t = dL/dS_t (S_t the state after step t, G_{S-1} the final
state's incoming gradient ``dsT`` or zeros), walking t from S - 1 down to
0::

    dr_t[i] = dr'_t[i] + u_i k_t[i] c_t,  dr'_t[i] = sum_j S_{t-1}[i,j] dy_t[j]
    dk_t[i] = dk'_t[i] + r_t[i] u_i c_t,  dk'_t[i] = sum_j G_t[i,j] v_t[j]
    dv_t[j] = sum_i G_t[i,j] k_t[i] + dy_t[j] a_t   (c_t = dy_t . v_t,
    du_i   += r_t[i] k_t[i] c_t                      a_t = sum_i r u k)
    G_{t-1} = w_t[i] G_t[i,j] + r_t[i] dy_t[j]      (ds0 = G_{-1})
    dlw_t   = w_t dw_t = P_t - k_t dk'_t,  P_{t-1} = dlw_t + r_t dr'_t

where P_t[i] = sum_j G_t[i,j] S_t[i,j] (P_{S-1} from dsT): since w_t
S_{t-1} = S_t - k_t v_t^T, the gradient of log w is a reverse running sum
of the state parts of dr and dk.  So the kernel walks S forward once for
dr (pass A) and G back once for the rest (pass B, the forward recurrence
run backward in time on (k, r, dy, w)), rebuilds no state and never
divides by w (:func:`wkv6_bwd_twopass_plain` renders the two passes).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

__all__ = ["wkv6_plain", "wkv6_kernel", "wkv6_bwd_plain", "wkv6_bwd_kernel",
           "wkv6_bwd_twopass_plain", "Wkv6", "HEAD_DIMS", "ROUTES", "Tiling",
           "tiling", "route", "BwdTiling", "bwd_tiling"]

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
    """The backward's sizes at one hd (``Bwd<HD>`` in
    ``csrc/wkv6_bwd.cu``)."""
    t: int          # steps a ring stage (both passes)
    ns: int         # stages in a ring
    u: int          # steps a group (one exchange of the lanes' sums)
    rb: int         # pass A: state rows a block (all columns)
    nrb: int        # pass A: blocks a (b, h) chain
    a_threads: int  # pass A: consumers and one producer warp
    a_smem: int     # pass A: dynamic shared bytes a block
    cb: int         # pass B: state columns a block (all rows)
    ncb: int        # pass B: blocks a (b, h) chain
    b_threads: int  # pass B: consumers and one producer warp
    b_smem: int     # pass B: dynamic shared bytes a block


def bwd_tiling(hd: int) -> BwdTiling:
    """The backward's tiling at head width ``hd`` (in :data:`HEAD_DIMS`):
    a pure function of hd, the same as the library's ``wkv6_bwd_tiling``.
    A consumer thread holds 4 rows x 4 columns of the state (2 columns at
    hd 16): in pass A the lanes split the columns (dr' sums over them), in
    pass B the rows (dv sums over them)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"wkv6 takes hd in {HEAD_DIMS}, not {hd}")
    t, ns, u, bars = 8 if hd == 128 else 16, 2, 4, 128
    ca = cc = 2 if hd == 16 else 4
    rb = min(hd, 32)
    wa = rb // (4 * (32 // (hd // ca)))
    stage_a = 4 * t * (3 * rb + 2 * hd) + 128 + 2 * t * (rb + hd)
    cb = 32 if hd == 128 else hd
    wb = cb // (cc * (32 // (hd // 4)))
    nt = 32 * wb
    slots = wb * (32 // (hd // 4))
    stage_b = 4 * t * (6 * hd + cb) + 128 + 2 * t * 3 * hd
    smem_b = (bars + ns * stage_b + 8 * u * slots * hd + 16 * u * cb + 4 * nt
              + (16 * u * hd if cb < hd else 0))     # hd 128's exchange
    return BwdTiling(t=t, ns=ns, u=u, rb=rb, nrb=hd // rb,
                     a_threads=32 * (wa + 1), a_smem=bars + ns * stage_a,
                     cb=cb, ncb=hd // cb, b_threads=nt + 32, b_smem=smem_b)


def wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT=None, log_w=False):
    """The gradient of :func:`wkv6_plain` (the recurrence in the module's
    docstring), one token at a time on the f32 upcasts of r, k, v: returns
    (dr, dk, dv, dw (B, S, H, hd), du (H, hd), ds0 (B, H, hd, hd)), all
    f32.  ``dsT`` None is zeros.  The states S_{t-1} are rebuilt with
    :func:`wkv6_plain`'s own update, so they are its states bit for bit.
    With ``log_w`` the fourth is w · dw instead, one f32 product: the
    gradient of log w, as :func:`wkv6_bwd_kernel` returns it."""
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
    return dr, dk, dv, w * dw if log_w else dw, du, G


def wkv6_bwd_twopass_plain(r, k, v, w, u, s0, dy, dsT=None):
    """The CUDA backward's two passes in plain PyTorch, one token at a
    time, the same sums in its order (the tests' rendering of the kernel's
    algorithm; the kernel is held against :func:`wkv6_bwd_plain`).

    Pass A walks the state forward from s0: dr'_t = S_{t-1} dy_t, dr_t =
    dr'_t + u k_t c_t (c_t = dy_t . v_t), and at the end P_{S-1} = sum_j
    dsT S_{S-1} (zeros without dsT).  Pass B walks G back from dsT: dv_t
    = G_t^T k_t + dy_t a_t, dk'_t = G_t v_t, dk_t = dk'_t + r_t u c_t, the
    gradient of log w dlw_t = P_t - k_t dk'_t and P_{t-1} = dlw_t + r_t
    dr'_t (dr' = dr - u k c, from pass A's dr), G_{t-1} = w_t G_t + r_t
    dy_t^T.  Returns (dr, dk, dv, dlw, du, ds0), all f32: no state is
    rebuilt and nothing divides by w."""
    r, k, v, w, dy = (t.float() for t in (r, k, v, w, dy))
    B, S, H, hd = r.shape
    uu = u.float()
    c = (dy * v).sum(-1, keepdim=True)                     # (B, S, H, 1)
    dr = torch.empty_like(r)
    s = s0.float()
    for t in range(S):
        drp = torch.einsum("bhij,bhj->bhi", s, dy[:, t])
        dr[:, t] = drp + uu * k[:, t] * c[:, t]
        s = w[:, t, :, :, None] * s + k[:, t, :, :, None] * v[:, t, :, None, :]
    P = torch.zeros((B, H, hd), device=r.device) if dsT is None \
        else (dsT.float() * s).sum(-1)
    G = torch.zeros_like(s) if dsT is None else dsT.float()
    dk, dv, dlw = (torch.empty_like(r) for _ in range(3))
    du = torch.zeros_like(uu)
    for t in reversed(range(S)):
        rt, kt, vt, dyt, ct = r[:, t], k[:, t], v[:, t], dy[:, t], c[:, t]
        a = (rt * uu * kt).sum(-1, keepdim=True)
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kt) + dyt * a
        dkp = torch.einsum("bhij,bhj->bhi", G, vt)
        dk[:, t] = dkp + rt * uu * ct
        dlw[:, t] = P - kt * dkp
        P = dlw[:, t] + rt * (dr[:, t] - uu * kt * ct)
        du += (rt * kt * ct).sum(0)
        G = w[:, t, :, :, None] * G + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dlw, du, G


@functools.cache
def _bwd_entry():
    lib = build.load("wkv6_bwd")
    for fn, n_int in ((lib.wkv6_bwd, 5), (lib.wkv6_bwd_passes, 6)):
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, lib.wkv6_bwd


def library_bwd_tiling(hd: int) -> BwdTiling:
    """The built library's ``Bwd<hd>`` (needs the build; on the card)."""
    lib, _ = _bwd_entry()
    out = (ctypes.c_int * 11)()
    if lib.wkv6_bwd_tiling(ctypes.c_int(hd), out) != 0:
        raise ValueError(f"wkv6 takes hd in {HEAD_DIMS}, not {hd}")
    return BwdTiling(*out)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where it starts off a 16-byte boundary (a
    view into a larger tensor): TMA tensor maps need aligned bases."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_BWD_OUTPUTS = ("dr", "dk", "dv", "dlw", "du", "ds0")


def _bwd_buffers(r: torch.Tensor) -> dict:
    """The backward's outputs (:data:`_BWD_OUTPUTS`) and scratch, f32, for
    r's (B, S, H, hd): ``pend`` is P_{S-1}, ``du_part`` du's partial a (b,
    h) chain."""
    B, S, H, hd = r.shape
    f32 = dict(dtype=torch.float32, device=r.device)
    o = {x: torch.empty(r.shape, **f32) for x in ("dr", "dk", "dv", "dlw")}
    o["du"] = torch.empty((H, hd), **f32)
    o["ds0"] = torch.empty((B, H, hd, hd), **f32)
    o["pend"] = torch.empty((B, H, hd), **f32)
    o["du_part"] = torch.empty((B, H, hd), **f32)
    return o


def _bwd_pointers(ins, dsT, o) -> list:
    """The library's 16 pointer arguments: the inputs (r, k, v, w, u, s0,
    dy), ``dsT`` (0 for None), then :func:`_bwd_buffers`' ``o``."""
    return ([x.data_ptr() for x in ins] + [0 if dsT is None else
                                           dsT.data_ptr()]
            + [o[x].data_ptr() for x in _BWD_OUTPUTS + ("pend", "du_part")])


def wkv6_bwd_kernel(r, k, v, w, u, s0, dy, dsT=None):
    """The CUDA backward: :func:`wkv6_bwd_plain`'s contract with
    ``log_w=True`` on contiguous CUDA tensors, r, k, v all f32 or all bf16,
    w, u, s0, dy and ``dsT`` (None: zeros) f32: returns (dr, dk, dv, dlw,
    du, ds0), dlw the gradient of log w.  One call, one count: pass A, pass
    B, then a short kernel that adds du's per-chain partials over b in a
    fixed order; no atomics, so repeats are bit-identical.  Raises
    ``ValueError`` on anything else."""
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
    r, k, v, w, dy = (_aligned16(t) for t in (r, k, v, w, dy))
    o = _bwd_buffers(r)
    lib, fn = _bwd_entry()
    err = fn(*_bwd_pointers((r, k, v, w, u, s0, dy), dsT, o), B, S, H, hd,
             int(r.dtype == torch.bfloat16),
             torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, "wkv6_bwd", err)
    wkv6_bwd_kernel.launches += 1
    return tuple(o[x] for x in _BWD_OUTPUTS)


wkv6_bwd_kernel.launches = 0


class Wkv6(torch.autograd.Function):
    """The kernel pair under autograd, on log w: the forward computes w =
    ``torch.exp(log_w)`` and runs the forward kernel, unchanged; the
    backward kernel returns the gradient of log w in w's place, so nothing
    divides by w, which underflows to 0 where the decay is strong.  A decay
    that needs no gradient may come as w instead: ``Wkv6.apply(r, k, v,
    None, u, s0, w)``.  Only r, k, v, w, u, s0 are saved: under remat the
    forward runs again before the backward, so y or per-step states would
    only hold memory.  dr, dk, dv come back in r's dtype (computed in f32
    and cast once), dlw, du, ds0 in f32."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0, w=None):
        if (log_w is None) == (w is None):
            raise ValueError("Wkv6 takes log w or, without its gradient, w")
        if w is None:
            w = torch.exp(log_w)
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
        dr, dk, dv, dlw, du, ds0 = wkv6_bwd_kernel(r, k, v, w, u, s0, dy,
                                                   dsT)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype),
                dlw if ctx.needs_input_grad[3] else None, du, ds0, None)
