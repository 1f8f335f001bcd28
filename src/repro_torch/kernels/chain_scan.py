"""The batched evaluator's device decision chains: one launch per chain.

Counterpart of the two ``lax.scan`` chains of ``repro/eval/jaxtail.py``
(``JaxState._build_chain``, scanned at :346, and ``_build_tm_chain``,
scanned at :267).  They are not Pallas kernels; on the TPU each is one XLA
loop over a whole candidate run, and on the card each is one CUDA kernel
(``csrc/chain_scan.cu``, whose note gives the design):

* :func:`chain_scan_kernel`: the serial greedy chain of ``tune_parallel``.
  Step t scores candidate t -- weight ``[wi, wj]`` of layer k moved by
  ``dw``, column ``wj``'s bias by ``db`` (already ``<< FRAC``) -- against
  the chain state with every earlier accepted step applied, accepts iff
  its correct count clears the running one (``>=``), and applies it.
  Returns (n, 2) int32: the count and the accept flag of every step.
* :func:`tm_chain_kernel`: the time-multiplexed tuner's decision tree.
  Step t scores its one or two candidate values, ranks them by
  ``(count, value)``, accepts the best iff it clears the running count,
  and else tries the bias nudges ``dbsh`` in order with the best value,
  the first that clears it accepted.  Returns (n, 6) int32: ``ok, sel,
  pair_ok, db_idx, cnt_best, cnt_dec`` per step, the outputs of the
  reference's scan.

Both take the evaluator's layer caches as the reference's ``core`` does:
``a`` (inputs of every layer and the final outputs), ``acc``, ``w`` and
``bsh`` (biases ``<< FRAC``) as lists of int32 tensors, ``lab`` and
``lab_safe`` (int64), the activations, ``q``, the layer ``k`` and the
running count ``count0``; the steps are host integers.  The caches are
read, never written.  :func:`chain_scan_plain` and :func:`tm_chain_plain`
are the same functions in plain PyTorch, a Python loop over the steps with
a full recount of every row at each, as in the ``lax.scan``; the CPU path
and the kernels' on-card checks use them.

Each kernel has two routes, both bit-identical to the plain versions:

* ``cluster``: one chain on one thread-block cluster of C CTAs (C in
  ``CLUSTER_SIZES``), each holding a contiguous share of the rows' state
  in its shared memory for the whole launch; a step's counts are summed
  across the cluster through distributed shared memory and one cluster
  barrier.  Taken wherever a CTA's shared memory holds its share of the
  rows (:func:`cluster_smem`), the first size of ``CLUSTER_SIZES`` that
  does (the fastest at the paper's shapes) and the card can place
  (``cudaOccupancyMaxActiveClusters``, queried once a shape).
* ``block``: one block on one SM, the state in a device-memory
  workspace; every case the cluster cannot hold, up to 65,280 rows.

:func:`route` is the rule, a pure function of the shapes and the card's
limits; :func:`fits` / :func:`refusal` are the kernels' whole contract,
the same on both routes.  ``chain_scan_kernel.launches`` and
``tm_chain_kernel.launches`` count every launch, their ``route_launches``
the launches of each route and ``size_launches`` the cluster launches of
each size.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.intmlp import act_requant, matmul_int

from . import build

__all__ = ["chain_scan_plain", "tm_chain_plain", "chain_scan_kernel",
           "tm_chain_kernel", "fits", "refusal", "route", "cluster_size",
           "cluster_smem", "ACT_CODES", "MAX_LAYERS", "WIDTHS", "ROUTES",
           "CLUSTER_SIZES", "SMEM_OPTIN"]

_NEG = -(1 << 30)
ACT_CODES = {"htanh": 0, "satlin": 1, "relu": 2, "hsig": 3, "lin": 4}
MAX_LAYERS = 8          # csrc/chain_scan.cu's kMaxLayers
WIDTHS = (12, 16)       # the kernels' padded widths of layers past k+1
_META_INTS = 8 + (MAX_LAYERS + 1) + 3 * MAX_LAYERS
_I32 = (-(1 << 31), (1 << 31) - 1)
ROUTES = ("cluster", "block")
# The cluster route's sizes, the fastest at the paper's shapes first.
CLUSTER_SIZES = (16, 8, 4, 2)
SMEM_OPTIN = 232448     # shared memory a block may opt into on an H100
# csrc/chain_scan.cu: the cluster's reduction slots (2 x kGroup x 16 CTAs
# x 8 warps ints), and room for a CTA's static shared memory (its Shared)
_SLOT_INTS = 2 * 8 * 16 * 8
_STATIC_BYTES = 4096


def _count(act_a: torch.Tensor, lab: torch.Tensor,
           lab_safe: torch.Tensor) -> int:
    """Correct count of one network's final activations (M, n_out)."""
    n_out = act_a.shape[1]
    pen = n_out - 1 - torch.arange(n_out, dtype=act_a.dtype,
                                   device=act_a.device)
    score = act_a * n_out + pen
    smax = score.amax(dim=1)
    slab = torch.gather(score, 1, lab_safe[:, None])[:, 0]
    slab = torch.where(lab < 0, _NEG, slab)
    return int((slab == smax).sum())


class _Tail:
    """The candidate scorer of both plain chains: layer k's column
    ``wj`` at ``h`` -> the correct count, against the chain state."""

    def __init__(self, a, acc, w, bsh, lab, lab_safe, acts, q, k):
        self.w, self.bsh, self.acts, self.q, self.k = w, bsh, acts, q, k
        self.lab, self.lab_safe = lab, lab_safe
        self.last = k == len(w) - 1
        self.a_k = a[k]
        self.acc_k = acc[k].clone()
        self.a_k1 = a[k + 1].clone()
        self.acc_n = None if self.last else acc[k + 1].clone()

    def column(self, i, j, dw, db):
        buf = self.acc_k[:, j] + self.a_k[:, i] * dw + db
        return buf, act_requant(buf, self.acts[self.k], self.q)

    def count(self, j, h):
        """(count, layer k+1 state) with column j of layer k's output at h."""
        k = self.k
        if self.last:
            a_c = self.a_k1.clone()
            a_c[:, j] = h
            return _count(a_c, self.lab, self.lab_safe), None
        dcol = h - self.a_k1[:, j]
        acc_c = self.acc_n + dcol[:, None] * self.w[k + 1][j][None, :]
        act = act_requant(acc_c, self.acts[k + 1], self.q)
        for l in range(k + 2, len(self.w)):
            act = act_requant(matmul_int(act, self.w[l])
                              + self.bsh[l][None, :], self.acts[l], self.q)
        return _count(act, self.lab, self.lab_safe), acc_c

    def apply(self, j, buf, h, acc_c):
        self.acc_k[:, j] = buf
        self.a_k1[:, j] = h
        if not self.last:
            self.acc_n = acc_c


def chain_scan_plain(a, acc, w, bsh, lab, lab_safe, acts, q, k, count0,
                     wi, wj, dw, db) -> torch.Tensor:
    """The serial greedy chain in plain PyTorch: (n, 2) int32 (count,
    accepted) per step."""
    tail = _Tail(a, acc, w, bsh, lab, lab_safe, acts, q, k)
    cnt = int(count0)
    out = []
    for t in range(len(wi)):
        j = int(wj[t])
        buf, h = tail.column(int(wi[t]), j, int(dw[t]), int(db[t]))
        cnt_c, acc_c = tail.count(j, h)
        ok = cnt_c >= cnt
        if ok:
            tail.apply(j, buf, h, acc_c)
            cnt = cnt_c
        out.append((cnt_c, int(ok)))
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 2)


def tm_chain_plain(a, acc, w, bsh, lab, lab_safe, acts, q, k, count0, dbsh,
                   wi, wj, dw0, dw1, has2, valid, pw0, pw1) -> torch.Tensor:
    """The TM decision-tree chain in plain PyTorch: (n, 6) int32 (ok, sel,
    pair_ok, db_idx, cnt_best, cnt_dec) per step.  As in the reference's
    scan, a failed pair scores every nudge."""
    tail = _Tail(a, acc, w, bsh, lab, lab_safe, acts, q, k)
    cnt = int(count0)
    out = []
    for t in range(len(wi)):
        i, j = int(wi[t]), int(wj[t])
        c0 = tail.count(j, tail.column(i, j, int(dw0[t]), 0)[1])[0]
        c1 = (tail.count(j, tail.column(i, j, int(dw1[t]), 0)[1])[0]
              if has2[t] else -1)
        sel = c1 > c0 or (c1 == c0 and int(pw1[t]) > int(pw0[t]))
        cnt_best = c1 if sel else c0
        dw_best = int(dw1[t]) if sel else int(dw0[t])
        pair_ok = cnt_best >= cnt
        db_ok, db_idx, cnt_db = False, 0, 0
        if valid[t] and not pair_ok:
            cs = [tail.count(j, tail.column(i, j, dw_best, int(d))[1])[0]
                  for d in dbsh] or [0]
            hits = [c >= cnt for c in cs]
            db_ok = any(hits)
            db_idx = hits.index(True) if db_ok else 0
            cnt_db = cs[db_idx]
        ok = bool(valid[t]) and (pair_ok or db_ok)
        db_fin = 0 if pair_ok or not dbsh else int(dbsh[db_idx])
        cnt_dec = cnt_best if pair_ok else cnt_db
        if ok:
            buf, h = tail.column(i, j, dw_best, db_fin)
            tail.apply(j, buf, h, tail.count(j, h)[1])
            cnt = cnt_dec
        out.append((int(ok), int(sel), int(pair_ok), db_idx, cnt_best,
                    cnt_dec))
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 6)


# -- the CUDA kernels -------------------------------------------------------

@functools.cache
def _entry(name: str):
    lib = build.load("chain_scan")
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _card_limits(name: str, index: int, width: int, size: int,
                 smem: int) -> tuple[int, int]:
    """(shared memory a block may opt into, clusters the card holds at
    once) on card ``index`` for ``name``'s cluster kernel at ``width`` on
    ``size`` CTAs of ``smem`` dynamic bytes each; queried once."""
    lib = build.load("chain_scan")
    fn = lib.chain_cluster_limits
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    optin, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(int(name == "tm_chain"), width, size, smem,
                 ctypes.byref(optin), ctypes.byref(clusters))
    build.check(lib, "chain_cluster_limits", err)
    return optin.value, clusters.value


def _plan(name, dev, widths, k, M, n_db, width, how, size):
    """(route, cluster size or 0) of a launch: :func:`route`'s under the
    card's queried limits, or the one forced by ``how`` (and ``size``),
    which raises where the card cannot take it."""
    if how not in (None, *ROUTES):
        raise ValueError(f"route must be one of {ROUTES}, not {how!r}")
    if how == "block":
        return "block", 0
    sizes = CLUSTER_SIZES
    if size is not None:
        if how != "cluster" or size not in CLUSTER_SIZES:
            raise ValueError(f"a cluster size is one of {CLUSTER_SIZES} "
                             f"on the cluster route, not {size!r}")
        sizes = (size,)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    limits = {c: _card_limits(name, index, width, c,
                              cluster_smem(widths, k, M, n_db, c)
                              - _STATIC_BYTES) for c in sizes}
    c = cluster_size(widths, k, M, n_db, smem_max=limits[sizes[0]][0],
                     sizes=tuple(c for c in sizes if limits[c][1] > 0))
    if c is not None:
        return "cluster", c
    if how == "cluster":
        raise ValueError(f"{name}_kernel: no cluster of {sizes} holds {M} "
                         f"rows at layer {k} of {list(widths)} on this card")
    return "block", 0


def _int32(values, what: str) -> np.ndarray:
    arr = np.asarray(values, dtype=np.int64).reshape(-1)
    if arr.size and (arr.min() < _I32[0] or arr.max() > _I32[1]):
        raise ValueError(f"{what} does not fit int32")
    return arr.astype(np.int32)


def _width(widths, k: int) -> int | None:
    """The kernels' padded width: the smallest of ``WIDTHS`` that holds
    every layer past k+1 (the last layer's outputs when k is the last);
    None when none does."""
    need = max(widths[k + 2:] or widths[-1:])
    return next((wd for wd in WIDTHS if need <= wd), None)


def _weight_ints(widths, k: int, width: int) -> int:
    """int32 words of the packed weights past layer k: W[k+1] at its own
    rows, the deeper layers and their biases padded to ``width``."""
    L = len(widths) - 1
    return sum((widths[l] if l == k + 1 else width + 1) * width
               for l in range(k + 1, L))


def refusal(widths, k: int, M: int, q: int, n_db: int) -> str | None:
    """Why the kernels cannot take layer k of a net of ``widths`` (inputs,
    then every layer's outputs) at M rows, or None when they can."""
    L = len(widths) - 1
    if L > MAX_LAYERS:
        return f"at most {MAX_LAYERS} layers, not {L}"
    if not 0 <= q <= 23:
        return f"0 <= q <= 23, not {q}"
    width = _width(widths, k)
    if width is None:
        return (f"layers past k+1 of at most {WIDTHS[-1]} outputs, not "
                f"{list(widths)}")
    if M > 255 * 256:
        return f"at most {255 * 256} rows, not {M}"
    smem = 4 * (_weight_ints(widths, k, width) + n_db)
    if smem > 48 * 1024:
        return f"{smem} bytes of weights past the 48 KB of shared memory"
    return None


def fits(widths, k: int, M: int, q: int, n_db: int = 0) -> bool:
    """Do the kernels take layer ``k`` of a net of ``widths`` (inputs, then
    every layer's outputs) over M rows at ``q``, with ``n_db`` nudges?  The
    evaluator runs a chain that does not fit on the host, as it does a run
    the int32 guard refuses."""
    return refusal(widths, k, M, q, n_db) is None


def cluster_smem(widths, k: int, M: int, n_db: int, size: int) -> int:
    """Shared-memory bytes a CTA of the cluster route takes at layer k of
    a net of ``widths`` over M rows with ``n_db`` nudges on a cluster of
    ``size`` CTAs: the reduction slots, the packed weights and nudges,
    ceil(M / size) rows of state (layer k's inputs, accumulators and
    outputs, layer k+1's accumulators at their padded stride, the row's
    bit, its candidates' bits and its label) and the static share."""
    width = _width(widths, k)
    last = k == len(widths) - 2
    stride = width + 4 if width % 8 == 0 else width
    row = (0 if last else stride) + widths[k] + 2 * widths[k + 1] + 3
    words = _weight_ints(widths, k, width) + n_db
    return (4 * (_SLOT_INTS + -(-words // 4) * 4 + -(-M // size) * row)
            + _STATIC_BYTES)


def cluster_size(widths, k: int, M: int, n_db: int = 0, *,
                 smem_max: int = SMEM_OPTIN,
                 sizes=CLUSTER_SIZES) -> int | None:
    """The cluster route's size for a shape the kernels take: the first of
    ``sizes`` whose CTAs' shared memory (at most ``smem_max`` bytes) holds
    their rows; None when none does.  ``smem_max`` and ``sizes`` are the
    card's limits (an H100's by default; the wrapper passes the queried
    ones)."""
    if _width(widths, k) is None:
        return None
    return next((c for c in sizes
                 if cluster_smem(widths, k, M, n_db, c) <= smem_max), None)


def route(widths, k: int, M: int, n_db: int = 0, *,
          smem_max: int = SMEM_OPTIN, sizes=CLUSTER_SIZES) -> str:
    """``"cluster"`` where :func:`cluster_size` finds a size, else
    ``"block"``: a pure function of the shapes and the card's limits."""
    return "block" if cluster_size(widths, k, M, n_db, smem_max=smem_max,
                                   sizes=sizes) is None else "cluster"


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``t`` (2-D, or 1-D as one row) zero-padded to (rows, cols), flat."""
    t = t.reshape(-1, t.shape[-1])
    return torch.nn.functional.pad(
        t, (0, cols - t.shape[1], 0, rows - t.shape[0])).reshape(-1)


def _launch(name, a, acc, w, bsh, lab, lab_safe, acts, q, k, count0,
            n_steps, n_db, step_ints, n_out_cols, how, size):
    """Check the caches, pack the weights and the Net, launch ``name`` on
    its route; returns the (n_steps, n_out_cols) int32 output, the route
    and the cluster's size (0 on the block)."""
    L = len(w)
    dev = a[k].device
    if dev.type != "cuda":
        raise ValueError(f"{name}_kernel takes CUDA tensors")
    last = k == L - 1
    state = [a[k], acc[k], a[k + 1]] + ([] if last else [acc[k + 1]])
    deep = [] if last else [w[k + 1]] + [t for l in range(k + 2, L)
                                         for t in (w[l], bsh[l])]
    for t in state + deep:
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}_kernel takes contiguous int32 caches "
                             f"on one CUDA device")
    if lab.dtype != torch.int64 or lab_safe.dtype != torch.int64 \
            or lab.device != dev or lab_safe.device != dev:
        raise ValueError(f"{name}_kernel takes int64 labels on the device")
    widths = [a[0].shape[1]] + [x.shape[1] for x in w]
    M = a[k].shape[0]
    why = refusal(widths, k, M, q, n_db)
    if why is not None:
        raise ValueError(f"{name}_kernel takes {why}")
    width = _width(widths, k)
    woff = [0] * MAX_LAYERS
    boff = [0] * MAX_LAYERS
    packed = []
    off = 0
    for l in range(k + 1, L):       # W[k+1] keeps its rows; deeper ones pad
        rows = widths[l] if l == k + 1 else width
        woff[l] = off
        packed.append(_padded(w[l], rows, width))
        off += rows * width
        if l > k + 1:
            boff[l] = off
            packed.append(_padded(bsh[l], 1, width))
            off += width
    meta = np.zeros(_META_INTS, np.int32)
    meta[:8] = (L, k, M, q, n_steps, count0, n_db, off)
    meta[8:8 + L + 1] = widths
    base = 8 + MAX_LAYERS + 1
    meta[base:base + L] = [ACT_CODES[x] for x in acts[:L]]
    meta[base + MAX_LAYERS:base + 2 * MAX_LAYERS] = woff
    meta[base + 2 * MAX_LAYERS:] = boff
    wpack = (torch.cat(packed) if packed
             else torch.zeros(4, dtype=torch.int32, device=dev))
    steps = torch.from_numpy(step_ints).to(dev)
    how, size = _plan(name, dev, widths, k, M, n_db, width, how, size)
    if how == "block":
        n1 = widths[k + 1]
        ws = torch.empty(M * (widths[k] + 2 * n1 + (0 if last else width)
                              + 2), dtype=torch.int32, device=dev)
        ws_ptr, smem = ws.data_ptr(), 0
    else:
        ws_ptr = 0
        smem = cluster_smem(widths, k, M, n_db, size) - _STATIC_BYTES
    out = torch.empty((n_steps, n_out_cols), dtype=torch.int32, device=dev)
    lib, fn = _entry(name)
    err = fn(meta.ctypes.data, a[k].data_ptr(), acc[k].data_ptr(),
             a[k + 1].data_ptr(), 0 if last else acc[k + 1].data_ptr(),
             wpack.data_ptr(), lab.data_ptr(), lab_safe.data_ptr(),
             steps.data_ptr(), ws_ptr, out.data_ptr(), width, size, smem,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, name, err)
    return out, how, size


def chain_scan_kernel(a, acc, w, bsh, lab, lab_safe, acts, q, k, count0,
                      wi, wj, dw, db, *, _route=None,
                      _size=None) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`chain_scan_plain`, bit
    identical to it, in one launch.  Up to ``MAX_LAYERS`` layers, layers
    past k+1 at most ``WIDTHS[-1]`` wide, at most 65,280 rows, ``0 <= q <=
    23``.  The route is :func:`route`'s under the card's limits; the tests
    force one with ``_route`` (and the cluster's size with ``_size``)."""
    steps = np.stack([_int32(x, "a step") for x in (wi, wj, dw, db)],
                     axis=1).reshape(-1) if len(wi) else \
        np.zeros(0, np.int32)
    out, how, size = _launch("chain_scan", a, acc, w, bsh, lab, lab_safe,
                             acts, q, k, count0, len(wi), 0, steps, 2,
                             _route, _size)
    chain_scan_kernel.launches += 1
    chain_scan_kernel.route_launches[how] += 1
    if size:
        chain_scan_kernel.size_launches[size] += 1
    return out


def tm_chain_kernel(a, acc, w, bsh, lab, lab_safe, acts, q, k, count0, dbsh,
                    wi, wj, dw0, dw1, has2, valid, pw0, pw1, *, _route=None,
                    _size=None) -> torch.Tensor:
    """The CUDA kernel: the contract of :func:`tm_chain_plain`, bit
    identical to it, in one launch.  Limits and routes as
    :func:`chain_scan_kernel`."""
    cols = (wi, wj, dw0, dw1, has2, valid, pw0, pw1)
    steps = np.stack([_int32(x, "a step") for x in cols], axis=1) \
        .reshape(-1) if len(wi) else np.zeros(0, np.int32)
    steps = np.concatenate([_int32(dbsh, "a nudge"), steps])
    out, how, size = _launch("tm_chain", a, acc, w, bsh, lab, lab_safe,
                             acts, q, k, count0, len(wi), len(dbsh), steps,
                             6, _route, _size)
    tm_chain_kernel.launches += 1
    tm_chain_kernel.route_launches[how] += 1
    if size:
        tm_chain_kernel.size_launches[size] += 1
    return out


chain_scan_kernel.launches = 0
chain_scan_kernel.route_launches = dict.fromkeys(ROUTES, 0)
chain_scan_kernel.size_launches = dict.fromkeys(CLUSTER_SIZES, 0)
tm_chain_kernel.launches = 0
tm_chain_kernel.route_launches = dict.fromkeys(ROUTES, 0)
tm_chain_kernel.size_launches = dict.fromkeys(CLUSTER_SIZES, 0)
