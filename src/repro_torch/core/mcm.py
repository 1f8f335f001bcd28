"""Multiplierless constant multiplication synthesis (paper Section V), a
numpy copy of ``repro/core/mcm.py``.

Realizes SCM / MCM / CAVM / CMVM operations as shift-add networks:

* ``dbr``  — digit-based recoding baseline [23]: each constant expanded into
  its CSD digits, summed directly (Fig. 3b).
* ``cse``  — greedy common-subexpression elimination in the spirit of
  [17]-[19]: repeatedly extract the most frequent two-term pattern across all
  outputs (Fig. 3c regime).  DESIGN.md 8 notes this is a faithful heuristic,
  not the exact CP formulation of [17].

The result is an :class:`AdderGraph` — a list of two-operand add/sub ops over
shifted terms — which SIMURG lowers to Verilog, the cost model prices, and
``evaluate`` executes exactly for the correctness tests.

An MCM operation (m constants, one variable) is a CMVM with an (m x 1) matrix;
a CAVM (one output row) is a (1 x n) matrix; SCM is (1 x 1).

The greedy CSE loop's pattern counting runs as a batched numpy pass
(packed-int canonical pair keys over ``triu_indices`` pair grids,
unique-counted per output) that picks the reference's patterns, including
``Counter.most_common``'s first-inserted tie-break (DESIGN.md 11.2); the
tests hold the graphs equal to ``repro.core.mcm.synthesize``'s.
Memoized plans over this synthesis live in :mod:`repro_torch.core.planner`.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["AdderGraph", "synthesize", "dbr_adder_count", "evaluate"]

# A term is (var, shift, sign): var < n_inputs refers to input x_var, otherwise
# to intermediate node var - n_inputs.  sign in {+1, -1}.


@dataclass
class AdderGraph:
    n_inputs: int
    matrix: np.ndarray                    # the (m, n) constant matrix realized
    nodes: list = field(default_factory=list)    # node i: (termA, termB)
    outputs: list = field(default_factory=list)  # output j: list of terms (sum)
    # planner-shared graphs are priced many times; depth / value_bounds are
    # pure functions of the final structure, so memoize them on the instance
    # (populated lazily, never part of equality/repr)
    _memo: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def n_adders(self) -> int:
        """Two-operand adder/subtractor count (shifts are wires)."""
        total = len(self.nodes)
        for terms in self.outputs:
            total += max(0, len(terms) - 1)
        return total

    @property
    def depth(self) -> int:
        """Adder-stage depth of the critical path (for the latency model)."""
        cached = self._memo.get("depth")
        if cached is not None:
            return cached
        memo = {}

        def node_depth(v):
            if v < self.n_inputs:
                return 0
            if v not in memo:
                (a, b) = self.nodes[v - self.n_inputs]
                memo[v] = 1 + max(node_depth(a[0]), node_depth(b[0]))
            return memo[v]

        d = 0
        for terms in self.outputs:
            if not terms:
                continue
            base = max(node_depth(t[0]) for t in terms)
            # remaining terms summed as a balanced tree
            tree = int(np.ceil(np.log2(max(1, len(terms)))))
            d = max(d, base + tree)
        self._memo["depth"] = d
        return d

    def value_bounds(self, input_max: int = 255) -> list:
        """Max |value| each node/output can take — sizes adder bitwidths."""
        cached = self._memo.get(("bounds", input_max))
        if cached is not None:
            return cached
        coeffs = {}  # var -> np.ndarray coefficient over inputs

        def coeff(v):
            if v < self.n_inputs:
                c = np.zeros(self.n_inputs, dtype=np.int64)
                c[v] = 1
                return c
            if v not in coeffs:
                (a, b) = self.nodes[v - self.n_inputs]
                coeffs[v] = (coeff(a[0]) * (a[2] << a[1])
                             + coeff(b[0]) * (b[2] << b[1]))
            return coeffs[v]

        bounds = []
        for i in range(len(self.nodes)):
            bounds.append(int(np.abs(coeff(self.n_inputs + i)).sum()) * input_max)
        for terms in self.outputs:
            c = np.zeros(self.n_inputs, dtype=np.int64)
            for t in terms:
                c = c + coeff(t[0]) * (t[2] << t[1])
            bounds.append(int(np.abs(c).sum()) * input_max)
        self._memo[("bounds", input_max)] = bounds
        return bounds


def _csd_terms(matrix: np.ndarray) -> list:
    """Expand each row of the constant matrix into signed shifted input terms.

    One array-CSD recoding of the whole matrix; ``argwhere`` on the
    ``(row, input, digit)`` transpose yields the scalar loop's exact term
    order (input k ascending, then digit position ascending)."""
    from . import csd

    m, n = matrix.shape
    planes = csd.to_csd_array(matrix).transpose(1, 2, 0)   # (m, n, D)
    outputs = [[] for _ in range(m)]
    for j, k, pos in np.argwhere(planes):
        outputs[j].append((int(k), int(pos), int(planes[j, k, pos])))
    return outputs


def dbr_adder_count(matrix: np.ndarray) -> int:
    """Adder count of the digit-based recoding baseline (no sharing)."""
    outputs = _csd_terms(np.atleast_2d(np.asarray(matrix, dtype=np.int64)))
    return sum(max(0, len(t) - 1) for t in outputs)


def _canonical_pair(t1, t2):
    """Canonical form of a two-term pattern: shift-normalized, sign-normalized.

    Returns (key, base_shift, sigma): the pattern occurs at left-shift
    ``base_shift`` with overall sign ``sigma``.
    """
    (a, b) = sorted((t1, t2), key=lambda t: (t[0], t[1], t[2]))
    base = min(a[1], b[1])
    a = (a[0], a[1] - base, a[2])
    b = (b[0], b[1] - base, b[2])
    sigma = 1
    if a[2] < 0 or (a[2] == 0 and b[2] < 0):
        sigma = -1
        a = (a[0], a[1], -a[2])
        b = (b[0], b[1], -b[2])
    return (a, b), base, sigma


# packed canonical-key layout: (var << 7 | shift << 1 | sign>0) per term,
# two terms side by side in one int64.  Packed-int ordering == the tuple
# ordering (var, shift, sign) that _canonical_pair sorts by, because var is
# most significant, shifts stay < 64, and sign maps -1 -> 0, +1 -> 1.
_SHIFT_BITS = 6
_TERM_BITS = 31
_VAR_LIMIT = 1 << (_TERM_BITS - _SHIFT_BITS - 1)


def _pair_keys_np(terms: list):
    """Canonical keys of every (i < j) term pair of one output, vectorized.

    Returns ``(keys, pi, pj)`` — int64 canonical pair keys in the scalar
    loop's ``(i, jj)`` scan order plus the pair index arrays — or ``None``
    when the output has fewer than two terms.
    """
    t = len(terms)
    if t < 2:
        return None
    arr = np.asarray(terms, dtype=np.int64)          # (t, 3): var, shift, sign
    var, sh, sg = arr[:, 0], arr[:, 1], arr[:, 2]
    if int(var.max()) >= _VAR_LIMIT or int(sh.max()) >= (1 << _SHIFT_BITS):
        raise OverflowError("term var/shift exceeds packed-key capacity")
    packed = (var << (_SHIFT_BITS + 1)) | (sh << 1) | (sg > 0)
    pi, pj = np.triu_indices(t, 1)                   # row-major == (i, jj) scan
    swap = packed[pi] > packed[pj]
    ai, bi = np.where(swap, pj, pi), np.where(swap, pi, pj)
    va, sa, ga = var[ai], sh[ai], sg[ai]
    vb, sb, gb = var[bi], sh[bi], sg[bi]
    base = np.minimum(sa, sb)
    sa, sb = sa - base, sb - base
    sigma = np.where(ga < 0, -1, 1)
    ga, gb = ga * sigma, gb * sigma
    ka = (va << (_SHIFT_BITS + 1)) | (sa << 1) | (ga > 0)
    kb = (vb << (_SHIFT_BITS + 1)) | (sb << 1) | (gb > 0)
    return (ka << _TERM_BITS) | kb, pi, pj


def _unpack_key(key: int) -> tuple:
    """Packed int64 canonical key -> the ((var, shift, sign) x 2) tuple."""
    def term(k):
        return (int(k) >> (_SHIFT_BITS + 1),
                (int(k) >> 1) & ((1 << _SHIFT_BITS) - 1),
                1 if (int(k) & 1) else -1)
    return term(key >> _TERM_BITS), term(key & ((1 << _TERM_BITS) - 1))


def _most_common_pair_np(outputs: list):
    """Batched pattern-count pass (DESIGN.md 11.2): canonical keys of every
    output's pair grid, unique-counted once per output, aggregated with the
    global first-occurrence position.  Returns ``((key_tuple, keys_per_out),
    freq)`` with exactly ``Counter.most_common(1)``'s selection: max count,
    ties to the first key encountered in the outputs-then-pairs scan."""
    uniq_keys, uniq_pos, keys_per_out = [], [], []
    offset = 0
    for terms in outputs:
        kp = _pair_keys_np(terms)
        keys_per_out.append(kp)
        if kp is None:
            continue
        keys, _, _ = kp
        uk, first = np.unique(keys, return_index=True)  # seen-once-per-output
        uniq_keys.append(uk)
        uniq_pos.append(first + offset)
        offset += len(keys)
    if not uniq_keys:
        return None, 0, keys_per_out
    allk = np.concatenate(uniq_keys)
    allp = np.concatenate(uniq_pos)
    gk, inv = np.unique(allk, return_inverse=True)
    counts = np.bincount(inv)
    firstpos = np.full(len(gk), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(firstpos, inv, allp)
    best = int(counts.max())
    chosen = int(gk[np.where(counts == best, firstpos,
                             np.iinfo(np.int64).max).argmin()])
    return _unpack_key(chosen), best, keys_per_out


def synthesize(matrix, method: str = "cse") -> AdderGraph:
    """Build a shift-add network for the CMVM ``y = matrix @ x``."""
    matrix = np.atleast_2d(np.asarray(matrix, dtype=np.int64))
    m, n = matrix.shape
    graph = AdderGraph(n_inputs=n, matrix=matrix)
    outputs = _csd_terms(matrix)

    if method == "dbr":
        graph.outputs = outputs
        return graph
    if method != "cse":
        raise ValueError(method)

    next_var = n
    while True:
        key, freq, keys_per_out = _most_common_pair_np(outputs)
        if key is None or freq < 2:
            break
        (a, b) = key
        graph.nodes.append((a, b))
        new_var = next_var
        next_var += 1
        ka = (a[0] << (_SHIFT_BITS + 1)) | (a[1] << 1) | (a[2] > 0)
        kb = (b[0] << (_SHIFT_BITS + 1)) | (b[1] << 1) | (b[2] > 0)
        packed_key = (ka << _TERM_BITS) | kb
        for terms, kp in zip(outputs, keys_per_out):
            # replace the first occurrence of the pattern in each output
            if kp is None:
                continue
            keys, pi, pj = kp
            hits = np.nonzero(keys == packed_key)[0]
            if len(hits) == 0:
                continue
            i, jj = int(pi[hits[0]]), int(pj[hits[0]])
            _, base, sigma = _canonical_pair(terms[i], terms[jj])
            rest = [terms[x] for x in range(len(terms)) if x not in (i, jj)]
            terms[:] = rest + [(new_var, base, sigma)]
    graph.outputs = outputs
    return graph


def evaluate(graph: AdderGraph, x: np.ndarray) -> np.ndarray:
    """Execute the shift-add network exactly; x is (..., n_inputs) int64."""
    x = np.asarray(x, dtype=np.int64)
    vals = [x[..., i] for i in range(graph.n_inputs)]
    for (a, b) in graph.nodes:
        va = vals[a[0]] * (a[2] << a[1])
        vb = vals[b[0]] * (b[2] << b[1])
        vals.append(va + vb)
    outs = []
    for terms in graph.outputs:
        acc = np.zeros(x.shape[:-1], dtype=np.int64)
        for t in terms:
            acc = acc + vals[t[0]] * (t[2] << t[1])
        outs.append(acc)
    return np.stack(outs, axis=-1)
