"""The device decision chains of repro_torch against the JAX package on the
CPU, with no tolerance: ``evaluate_tm_chain(engine="device")`` and
``evaluate_chain`` with ``_chain_scan`` set, through the port's CPU
evaluator (the plain versions ``tm_chain_plain`` / ``chain_scan_plain``),
against the reference's device engines (its ``lax.scan`` chains on a
``jnp`` evaluator) at every layer of the five structures and activations
of ``test_batched_eval.py``, nudge hits and misses among them; whole
``TuneResult``s, stats included, of ``tune_time_multiplexed(chain_engine=
"device")`` and of ``tune_parallel`` on the serial device chain on a
reduced pendigits case; every fall-back condition of the device engines;
and the kernels' route rule (``chain_scan.route``: ``cluster`` wherever
a CTA's shared memory holds its share of the rows, ``block`` elsewhere).
On the card (``gpu`` marker) each chain kernel against its plain version
bit for bit, one launch a call, on both routes and every cluster size
that holds the rows, each launch's route read off ``route_launches``."""
import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import repro.core.tuning as jtuning
    from repro.core.intmlp import IntMLP as JIntMLP
    from repro.core.intmlp import quantize_inputs as jquantize_inputs
    from repro.core.quantize import quantize_mlp as jquantize_mlp
    from repro.data import pendigits as jpd
    from repro.eval import BatchedHWEvaluator as JEvaluator
    from repro.eval import Candidate as JCandidate
    from repro.eval import TMStep as JTMStep
    from repro.train.zaal import TrainConfig as JTrainConfig
    from repro.train.zaal import train as jtrain
except ImportError:
    jtuning = None
import repro_torch.core.tuning as tuning
from repro_torch.core.intmlp import FRAC, IntMLP
from repro_torch.eval import BatchedHWEvaluator, Candidate, TMStep
from repro_torch.kernels import ops
from repro_torch.configs.pendigits_mlp import STRUCTURES
from repro_torch.kernels.chain_scan import (CLUSTER_SIZES, SMEM_OPTIN,
                                            WIDTHS, _width,
                                            chain_scan_kernel,
                                            chain_scan_plain, cluster_size,
                                            cluster_smem, fits, refusal,
                                            route, tm_chain_kernel,
                                            tm_chain_plain)

# test_batched_eval.py's structures and activations: its STRUCTS, the
# commit test's and the deep-tail fallback test's
STRUCTS = [
    ((8, 6, 4), ("htanh", "hsig")),
    ((8, 5), ("lin",)),
    ((6, 7, 7, 6, 4), ("htanh", "relu", "satlin", "hsig")),
    ((8, 10, 6, 5), ("htanh", "satlin", "hsig")),
    ((6, 5, 5, 4), ("htanh", "satlin", "lin")),
]
DBS = (-4, -3, -2, -1, 1, 2, 3, 4)


def _rand_case(rng, struct, acts, q, m=211):
    ws = [rng.integers(-(1 << (q + 1)), 1 << (q + 1), (a, b)).astype(np.int64)
          for a, b in zip(struct[:-1], struct[1:])]
    bs = [rng.integers(-(1 << q), 1 << q, (b,)).astype(np.int64)
          for b in struct[1:]]
    x = rng.integers(-128, 128, (m, struct[0])).astype(np.int64)
    y = rng.integers(0, struct[-1], m)
    y[rng.random(m) < 0.05] = -1            # rows that never count
    return (ws, bs, list(acts), q), x, y


def _port(net):
    ws, bs, acts, q = net
    return IntMLP([w.copy() for w in ws], [b.copy() for b in bs], acts, q)


def _jref(net):
    ws, bs, acts, q = net
    return JIntMLP([w.copy() for w in ws], [b.copy() for b in bs], acts, q)


def _tm_steps(rng, w, k, n, spread, dbs=DBS):
    """n TM steps over distinct weights of layer k: one or two candidate
    values ``spread`` around the weight, the nudges ``dbs``."""
    cells = [(i, j) for i in range(w.shape[0]) for j in range(w.shape[1])]
    rng.shuffle(cells)
    steps = []
    for i, j in cells[:n]:
        v = int(w[i, j])
        pws = tuple(v + int(rng.integers(-spread, spread + 1))
                    for _ in range(1 if rng.random() < 0.3 else 2))
        steps.append((k, j, i, pws, dbs))
    return steps


def _chain_cands(rng, w, k, n, spread):
    cells = [(i, j) for i in range(w.shape[0]) for j in range(w.shape[1])]
    rng.shuffle(cells)
    return [(k, j, i, int(w[i, j]) + int(rng.integers(-spread, spread + 1)),
             int(rng.integers(-3, 4))) for i, j in cells[:n]]


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain chains' calls through ``ops``."""
    calls = {"chain_scan": 0, "tm_chain": 0}

    def counting(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped
    monkeypatch.setattr(ops, "chain_scan_plain",
                        counting("chain_scan", chain_scan_plain))
    monkeypatch.setattr(ops, "tm_chain_plain",
                        counting("tm_chain", tm_chain_plain))
    return calls


@pytest.mark.parametrize("struct,acts", STRUCTS,
                         ids=[str(s) for s, _ in STRUCTS])
def test_tm_chain_device_equals_reference(struct, acts, plain_calls):
    """``evaluate_tm_chain(engine="device")``: decisions and
    ``stats["candidates"]`` equal the reference's device engine at every
    layer; decisions equal the host chain's."""
    rng = np.random.default_rng(sum(struct))
    net, x, y = _rand_case(rng, struct, acts, 5)
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device="cpu")
    jev = JEvaluator(_jref(net), x, y, backend="jnp")
    host_ev = BatchedHWEvaluator(_port(net), x, y, backend="torch",
                                 device="cpu")
    kinds = set()
    for k in range(len(net[0])):
        steps = _tm_steps(rng, net[0][k], k, 18, 40)
        bha = ev.accuracy()
        assert bha == jev.accuracy()
        got = ev.evaluate_tm_chain([TMStep(*s) for s in steps], bha,
                                   engine="device")
        want = jev.evaluate_tm_chain([JTMStep(*s) for s in steps], bha,
                                     engine="device")
        assert got == want, k
        assert got == host_ev.evaluate_tm_chain(
            [TMStep(*s) for s in steps], bha, engine="host")
        assert ev.stats == {key: jev.stats[key] for key in ev.stats}
        kinds |= {"pair" if ok and not db else "nudge" if ok else "miss"
                  for ok, _pw, db, _ha in got}
    assert plain_calls["tm_chain"] == len(net[0])
    # a pair accepted, a nudge hit and a step where every nudge failed
    assert kinds == {"pair", "nudge", "miss"}


@pytest.mark.parametrize("struct,acts", STRUCTS,
                         ids=[str(s) for s, _ in STRUCTS])
def test_chain_scan_equals_reference(struct, acts, plain_calls):
    """``evaluate_chain`` with ``_chain_scan`` set (the serial device
    chain): flags and accuracies equal the reference's scan and the host
    chain at every layer, at the spec chunk (32) and past it (padded to
    ``chunk``)."""
    rng = np.random.default_rng(3 * sum(struct))
    net, x, y = _rand_case(rng, struct, acts, 4)
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device="cpu",
                            chunk=64)
    jev = JEvaluator(_jref(net), x, y, backend="jnp", chunk=64)
    ev._chain_scan = jev._chain_scan = True
    host_ev = BatchedHWEvaluator(_port(net), x, y, backend="torch",
                                 device="cpu", chunk=64)
    n_calls = 0
    for k in range(len(net[0])):
        w = net[0][k]
        for n in sorted({min(w.size, 9), min(w.size, 40)}):
            cands = _chain_cands(rng, w, k, n, 20)
            bha = ev.accuracy()
            got = ev.evaluate_chain([Candidate(*c) for c in cands], bha)
            assert got == jev.evaluate_chain([JCandidate(*c) for c in cands],
                                             bha), (k, n)
            assert got == host_ev.evaluate_chain(
                [Candidate(*c) for c in cands], bha)
            n_calls += 1
    assert plain_calls["chain_scan"] == n_calls
    assert ev.stats == {key: jev.stats[key] for key in ev.stats}


@pytest.mark.parametrize("struct,acts", STRUCTS,
                         ids=[str(s) for s, _ in STRUCTS])
def test_plain_chains_equal_the_reference_scans(struct, acts):
    """The plain chains' raw outputs equal the reference's scans'
    (``JaxState.chain`` / ``tm_chain``) step for step, the reference's
    padding included: zero steps for the serial chain, invalid steps
    (never accepted, nudges never tried) for the TM chain."""
    rng = np.random.default_rng(7 * sum(struct))
    net, x, y = _rand_case(rng, struct, acts, 5)
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device="cpu")
    jev = JEvaluator(_jref(net), x, y, backend="jnp")
    dev, jdev = ev._device_state(), jev._jax_state()
    pad_to = 32
    for k in range(len(net[0])):
        args = dev._chain_args(k, ev._count)
        cands = [Candidate(*c) for c in _chain_cands(rng, net[0][k], k, 9,
                                                     20)]
        _, wi, wj, dw, db = ev._pack(cands)
        pad = [np.pad(a, (0, pad_to - len(a))) for a in (wi, wj, dw, db)]
        counts, flags = jdev.chain(k, pad_to, ev._count, *pad)
        got = chain_scan_plain(*args, *pad).numpy()
        np.testing.assert_array_equal(got[:, 0], counts)
        np.testing.assert_array_equal(got[:, 1], flags)
        steps = [TMStep(*s) for s in _tm_steps(rng, net[0][k], k, 12, 40)]
        dbsh, *cols = ev._tm_pack(k, steps)
        cols[5][::4] = False                # some real steps invalid too
        cols = [np.pad(c, (0, pad_to - len(c))) for c in cols]
        want = jdev.tm_chain(k, pad_to, ev._count, dbsh, *cols)
        got = tm_chain_plain(*args, dbsh, *cols).numpy()
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[:, i], w, err_msg=f"{k}, {i}")


@pytest.mark.parametrize("k", [0, 1, 2])
def test_plain_chains_on_committed_state(k):
    """The plain chains read the caches and never write them: a chain
    after commits sees the committed state, and the state is unchanged."""
    rng = np.random.default_rng(11 + k)
    net, x, y = _rand_case(rng, (8, 10, 6, 5), ("htanh", "satlin", "hsig"), 5)
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device="cpu")
    jev = JEvaluator(_jref(net), x, y, backend="jnp")
    first = _chain_cands(rng, net[0][k], k, 6, 30)
    ev.commit_many([Candidate(*c) for c in first])
    jev.commit_many([JCandidate(*c) for c in first])
    dev = ev._device_state()
    before = [t.clone() for t in dev.a + dev.acc]
    steps = _tm_steps(rng, ev.mlp.weights[k], k, 12, 30)
    bha = ev.accuracy()
    assert ev.evaluate_tm_chain([TMStep(*s) for s in steps], bha,
                                engine="device") == \
        jev.evaluate_tm_chain([JTMStep(*s) for s in steps], bha,
                              engine="device")
    assert all(torch.equal(a, b) for a, b in zip(before, dev.a + dev.acc))


@pytest.fixture(scope="module")
def pendigits_case():
    """A reduced pendigits case: 16-8-10 trained for 5 epochs by the
    reference's trainer, quantized at q = 6, the first 400 validation
    rows."""
    ds = jpd.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    res = jtrain(JTrainConfig(structure=(16, 8, 10), epochs=5, seed=1),
                 jpd.to_unit(xtr), ytr, jpd.to_unit(xval), yval)
    x = jquantize_inputs(jpd.to_unit(xval))[:400]
    mlp = jquantize_mlp(res.weights, res.biases, ("htanh", "hsig"), 6)
    net = ([np.asarray(w, np.int64) for w in mlp.weights],
           [np.asarray(b, np.int64) for b in mlp.biases],
           list(mlp.activations), mlp.q)
    return net, x, np.asarray(yval[:400])


def _summary(tr):
    return (tr.bha, tr.initial_ha, tr.replacements, tr.sweeps, tr.log,
            [w.tolist() for w in tr.mlp.weights + tr.mlp.biases],
            {k: v for k, v in tr.stats.items() if k != "backend"})


def test_tune_tm_device_equals_reference(pendigits_case, plain_calls):
    """``tune_time_multiplexed(chain_engine="device")``: the whole
    ``TuneResult``, stats included, equals the reference's device engine's;
    ``mlp``, ``bha``, ``log``, ``replacements`` and ``sweeps`` equal the
    host chain's."""
    net, x, y = pendigits_case
    got = tuning.tune_time_multiplexed(_port(net), x, y, scope="neuron",
                                       max_sweeps=2, chain_engine="device",
                                       backend="torch", device="cpu")
    want = jtuning.tune_time_multiplexed(_jref(net), x, y, scope="neuron",
                                         max_sweeps=2, chain_engine="device",
                                         backend="jnp")
    assert _summary(got) == _summary(want)
    assert plain_calls["tm_chain"] == got.stats["eval_calls"] > 0
    host = tuning.tune_time_multiplexed(_port(net), x, y, scope="neuron",
                                        max_sweeps=2, chain_engine="host",
                                        backend="torch", device="cpu")
    assert _summary(got)[:6] == _summary(host)[:6]


def test_tune_parallel_device_chain_equals_reference(pendigits_case,
                                                     plain_calls,
                                                     monkeypatch):
    """``tune_parallel`` with the evaluator's ``_chain_scan`` set in both
    packages: the whole ``TuneResult`` equals the reference's and the host
    chain's."""
    net, x, y = pendigits_case

    def scanning(make):
        def build(*args, **kw):
            ev = make(*args, **kw)
            ev._chain_scan = True
            return ev
        return build
    host = tuning.tune_parallel(_port(net), x, y, max_sweeps=2,
                                backend="torch", device="cpu")
    monkeypatch.setattr(tuning, "_batched_ev", scanning(tuning._batched_ev))
    monkeypatch.setattr(jtuning, "_batched_ev", scanning(jtuning._batched_ev))
    got = tuning.tune_parallel(_port(net), x, y, max_sweeps=2,
                               backend="torch", device="cpu")
    want = jtuning.tune_parallel(_jref(net), x, y, max_sweeps=2,
                                 backend="jnp")
    assert plain_calls["chain_scan"] > 0
    assert _summary(got) == _summary(want) == _summary(host)


def _fallback_cases(rng, w):
    """(name, steps) of the device TM engine's contract fall-backs."""
    v = int(w[0, 0])
    three = [(0, 0, 0, (v + 1, v - 1, v + 2), DBS)]
    mixed = [(0, 0, 0, (v + 1,), DBS), (0, 1, 0, (int(w[0, 1]) + 1,), (1,))]
    unsafe = [(0, 0, 0, (v + (1 << 24),), DBS)]
    return [("three values", three), ("mixed nudges", mixed),
            ("int32-unsafe", unsafe)]


@pytest.mark.parametrize("case", ["numpy backend", "three values",
                                  "mixed nudges", "int32-unsafe"])
def test_device_engine_fallbacks(case, plain_calls):
    """Each of the reference's fall-back conditions runs the host chain:
    the host's decisions, the reference's stats, no device call."""
    rng = np.random.default_rng(5)
    net, x, y = _rand_case(rng, (8, 6, 4), ("htanh", "hsig"), 5)
    backend = "numpy" if case == "numpy backend" else "torch"
    ev = BatchedHWEvaluator(_port(net), x, y, backend=backend, device="cpu")
    jev = JEvaluator(_jref(net), x, y,
                     backend="numpy" if backend == "numpy" else "jnp")
    cases = dict(_fallback_cases(rng, net[0][0]))
    steps = cases.get(case) or _tm_steps(rng, net[0][0], 0, 6, 30)
    bha = ev.accuracy()
    got = ev.evaluate_tm_chain([TMStep(*s) for s in steps], bha,
                               engine="device")
    assert got == jev.evaluate_tm_chain([JTMStep(*s) for s in steps], bha,
                                        engine="device")
    assert ev.stats == {key: jev.stats[key] for key in ev.stats}
    host = BatchedHWEvaluator(_port(net), x, y, backend=backend,
                              device="cpu")
    assert got == host.evaluate_tm_chain([TMStep(*s) for s in steps], bha,
                                         engine="host")
    assert host.stats == ev.stats
    assert plain_calls["tm_chain"] == 0


def test_serial_chain_guard_falls_back(plain_calls):
    """With ``_chain_scan`` set, a run whose composed deltas fail the int32
    guard runs the host chain, as the reference's does."""
    rng = np.random.default_rng(9)
    net, x, y = _rand_case(rng, (8, 6, 4), ("htanh", "hsig"), 5)
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device="cpu")
    jev = JEvaluator(_jref(net), x, y, backend="jnp")
    ev._chain_scan = jev._chain_scan = True
    cands = _chain_cands(rng, net[0][0], 0, 5, 10)
    cands[2] = (0, cands[2][1], cands[2][2], 1 << 24, 0)
    bha = ev.accuracy()
    assert ev.evaluate_chain([Candidate(*c) for c in cands], bha) == \
        jev.evaluate_chain([JCandidate(*c) for c in cands], bha)
    assert plain_calls["chain_scan"] == 0


def test_chain_kernel_limits():
    """The kernels' padded width holds every layer past k+1 (the outputs
    when k is the last layer): 12 on every layer of the paper's
    structures; wider nets are refused, as are CPU tensors.  The plain
    versions take any width."""
    for struct in STRUCTURES:
        for k in range(len(struct) - 1):
            assert _width(list(struct), k) == 12, (struct, k)
            assert fits(list(struct), k, 2248, 6, len(DBS)), (struct, k)
    assert _width([8, 40, 16, 4], 0) == 16
    assert _width([8, 40, 16, 4], 1) == 12
    assert _width([16, 16, 40, 10], 0) is None
    assert "at most 16 outputs" in refusal([16, 16, 40, 10], 0, 300, 5, 0)
    assert _width([16, 16, 40, 10], 1) == 12
    rng = np.random.default_rng(1)
    net, x, y = _rand_case(rng, (8, 40, 4), ("htanh", "hsig"), 5)
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device="cpu")
    args = ev._device_state()._chain_args(0, ev._count)
    with pytest.raises(ValueError, match="CUDA"):
        chain_scan_kernel(*args, [0], [0], [1], [0])
    assert WIDTHS[-1] == 16 and FRAC == 7


@pytest.mark.parametrize("widths,k,M,q,n_db,ok", [
    ((16, 16, 10, 10), 0, 2248, 6, 8, True),
    ((16, 16, 10, 10), 2, 65280, 23, 8, True),
    ((16, 16, 24, 10), 0, 2248, 6, 8, False),     # 24 outputs past k+1
    ((16, 16, 24, 10), 1, 2248, 6, 8, True),      # ... but not past k=1's
    ((16, 16, 10, 10), 0, 65281, 6, 0, False),    # rows
    ((16, 16, 10, 10), 0, 2248, 24, 0, False),    # q
    ((4,) * 10, 0, 100, 5, 0, False),             # 9 layers
    ((4,) * 9, 0, 100, 5, 0, True),               # 8 layers
    ((16, 800, 16, 10), 0, 2248, 6, 0, False),    # W[k+1] past 48 KB
    ((16, 700, 16, 10), 0, 2248, 6, 8, True),
])
def test_chain_kernel_fits(widths, k, M, q, n_db, ok):
    """``fits`` is the kernels' whole contract: what it admits the launch
    takes, what it refuses the launch refuses with the same reason."""
    assert fits(widths, k, M, q, n_db) is ok
    assert (refusal(widths, k, M, q, n_db) is None) is ok


@pytest.mark.parametrize("M", [1, 211, 2248])
@pytest.mark.parametrize("struct", STRUCTURES, ids=str)
def test_chain_route_is_cluster_on_the_paper_structures(struct, M):
    """At every layer of the paper's five structures, with eight nudges,
    the rule takes the cluster route, at its fastest size (the first of
    ``CLUSTER_SIZES``), and a CTA's shared memory stays within the 227 KB
    a block may opt into."""
    for k in range(len(struct) - 1):
        assert route(list(struct), k, M, len(DBS)) == "cluster", (k, M)
        assert cluster_size(list(struct), k, M, len(DBS)) == \
            CLUSTER_SIZES[0]
        assert cluster_smem(list(struct), k, M, len(DBS),
                            CLUSTER_SIZES[0]) <= SMEM_OPTIN == 227 * 1024


@pytest.mark.parametrize("widths,k,M,n_db,size", [
    ((16, 16, 10, 10), 0, 65280, 8, None),       # the block's most rows
    ((16, 16, 10, 10), 2, 65280, 0, None),
    ((16, 16, 10, 10), 0, 20000, 8, None),       # 1250 rows a CTA
    ((16, 16, 10, 10), 2, 16000, 0, 16),         # k last: no layer k+1 row
    ((16, 16, 10, 10), 0, 9000, 8, 16),          # only 16 holds
    ((16, 16, 10, 10), 0, 4000, 8, 16),
    ((16, 700, 16, 10), 0, 2248, 8, None),       # 700 wide layer k+1
    ((16, 150, 16, 10), 0, 2248, 8, 16),
    ((8, 40, 16, 4), 0, 2248, 9, 16),            # W = 16, stride 20
    ((4,) * 9, 3, 65280, 0, None),
])
def test_chain_route_block_where_the_cluster_cannot_hold(widths, k, M, n_db,
                                                         size):
    """Where no cluster size's CTAs hold their rows in shared memory the
    rule takes the block route; where one does, the first that does."""
    assert fits(widths, k, M, 6, n_db)
    assert cluster_size(widths, k, M, n_db) == size
    assert route(widths, k, M, n_db) == ("block" if size is None
                                         else "cluster")


@pytest.mark.parametrize("k", [0, 1, 2])
@pytest.mark.parametrize("n_db", [0, 8, 9, 400])
def test_chain_cluster_smem_stays_within_the_card(k, n_db):
    """Whenever the rule picks the cluster, the reckoned shared memory a
    CTA stays within ``smem_max`` (227 KB by default), over rows from 1 to
    past the block's limit; the bytes grow with the rows, shrink with the
    size, and the card's queried limits (fewer sizes, less memory) only
    move shapes to the block route."""
    widths = [16, 16, 10, 10]
    for M in [1, 2, 15, 16, 17, 211, 2248, 4097, 8191, 12000, 16385, 30000,
              65280]:
        picked = cluster_size(widths, k, M, n_db)
        if picked is not None:
            assert cluster_smem(widths, k, M, n_db, picked) <= SMEM_OPTIN
            assert all(cluster_smem(widths, k, M, n_db, c) > SMEM_OPTIN
                       for c in CLUSTER_SIZES[:CLUSTER_SIZES.index(picked)])
        smem = [cluster_smem(widths, k, M, n_db, c) for c in CLUSTER_SIZES]
        assert smem == sorted(smem)         # 16 CTAs hold fewer rows each
        assert cluster_smem(widths, k, M + 16, n_db, 16) > smem[0]
        assert route(widths, k, M, n_db, sizes=()) == "block"
        assert route(widths, k, M, n_db, smem_max=100 * 1024,
                     sizes=(4, 2)) in (("cluster",) if smem[2] <= 100 * 1024
                                       else ("block",))


def test_wide_net_device_engine_on_the_cpu(plain_calls):
    """The kernels' limits are the card's: on a CPU evaluator a net wider
    than the kernels take still runs the device engine, its plain version,
    with the host's decisions."""
    rng = np.random.default_rng(3)
    net, x, y = _rand_case(rng, (8, 8, 24, 4), ("htanh", "relu", "hsig"), 5)
    assert not fits([8, 8, 24, 4], 0, len(y), 5, len(DBS))
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device="cpu")
    assert ev._chain_refusal(0, len(DBS)) is None
    ev.device = torch.device("cuda")    # the card's limits, read off shapes
    assert "at most 16 outputs" in ev._chain_refusal(0, len(DBS))
    assert ev._chain_refusal(1, len(DBS)) is None
    ev.device = torch.device("cpu")
    steps = [TMStep(*s) for s in _tm_steps(rng, net[0][0], 0, 8, 30)]
    bha = ev.accuracy()
    assert ev.evaluate_tm_chain(steps, bha, engine="device") == \
        ev.evaluate_tm_chain(steps, bha, engine="host")
    assert plain_calls["tm_chain"] == 1


# ------------------------------------------------------------ on the card

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")


def _state(rng, struct, acts, q, M, device):
    """A random committed network's layer caches (the evaluator's), on
    ``device``."""
    net, x, y = _rand_case(rng, struct, acts, q, m=M)
    ev = BatchedHWEvaluator(_port(net), x, y, backend="torch", device=device)
    return ev, net


PAPER = ((16, 16, 10, 10), ("htanh", "htanh", "hsig"))


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 1023, 1025, 2248])
@pytest.mark.parametrize("struct,acts", [PAPER, STRUCTS[2], STRUCTS[1],
                                         ((16, 16, 16, 16, 10),
                                          ("htanh", "satlin", "relu",
                                           "hsig"))],
                         ids=["paper", "deep", "one-layer", "width-16"])
def test_gpu_chain_kernels_bit_exact(M, struct, acts):
    """Both chain kernels equal their plain versions on the card, bit for
    bit, at every layer, one launch a call."""
    _needs_card()
    rng = np.random.default_rng(M + sum(struct))
    ev, net = _state(rng, struct, acts, 5, M, "cuda")
    dev = ev._device_state()
    for k in range(len(net[0])):
        w = net[0][k]
        _, wi, wj, dw, db = ev._pack([Candidate(*c) for c in _chain_cands(
            rng, w, k, min(w.size, 128), 20)])
        args = dev._chain_args(k, ev._count)
        n0 = chain_scan_kernel.launches
        got = ops.chain_scan(*args, wi, wj, dw, db)
        torch.cuda.synchronize()
        assert chain_scan_kernel.launches == n0 + 1
        assert torch.equal(got.cpu(), chain_scan_plain(*args, wi, wj, dw,
                                                          db).cpu())
        packed = ev._tm_pack(k, [TMStep(*s) for s in
                                 _tm_steps(rng, w, k, min(w.size, 64), 40)])
        packed[6][::5] = False              # invalid steps never accept
        n0 = tm_chain_kernel.launches
        got = ops.tm_chain(*args, *packed)
        torch.cuda.synchronize()
        assert tm_chain_kernel.launches == n0 + 1
        assert torch.equal(got.cpu(), tm_chain_plain(*args, *packed).cpu())


NUDGES = {0: (), 8: DBS, 9: DBS + (5,)}       # n_db 9: a group boundary
ROUTE_NETS = [PAPER, *STRUCTS, ((8, 40, 16, 4), ("htanh", "relu", "hsig"))]


def _routes(widths, k, M, n_db):
    """(route, size) pairs to force: the block, and the cluster at every
    size whose CTAs hold their rows."""
    return [("block", None)] + [
        ("cluster", c) for c in CLUSTER_SIZES
        if cluster_smem(widths, k, M, n_db, c) <= SMEM_OPTIN]


def _forced(kernel, args, how, size):
    """One launch of ``kernel`` on a forced route; asserts the route from
    ``route_launches``."""
    before = dict(kernel.route_launches)
    out = kernel(*args, _route=how, _size=size)
    torch.cuda.synchronize()
    after = kernel.route_launches
    assert {r: after[r] - before[r] for r in after} == \
        {r: int(r == how) for r in after}, (how, size)
    return out.cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 15, 2248, 4097])
@pytest.mark.parametrize("struct,acts", ROUTE_NETS,
                         ids=["paper", *[str(s) for s, _ in STRUCTS],
                              "width-16"])
def test_gpu_chain_routes_bit_exact(M, struct, acts):
    """Both chain kernels on both routes, the cluster at every size that
    holds the rows, equal their plain versions bit for bit at every layer
    (the last included): M = 1 (CTAs with no row), C - 1, the paper's 2248
    and one past 16 CTAs x 256 threads; W = 16 (``[8, 40, 16, 4]``); 0, 8
    and 9 nudges (one past a group).  At the larger M the TM runs see pair
    accepts, nudge hits and misses."""
    _needs_card()
    rng = np.random.default_rng(M + 3 * sum(struct))
    ev, net = _state(rng, struct, acts, 5, M, "cuda")
    dev = ev._device_state()
    widths = list(struct)
    kinds = set()
    for k in range(len(net[0])):
        w = net[0][k]
        args = dev._chain_args(k, ev._count)
        _, wi, wj, dw, db = ev._pack([Candidate(*c) for c in _chain_cands(
            rng, w, k, min(w.size, 48), 20)])
        want = chain_scan_plain(*args, wi, wj, dw, db).cpu()
        for how, size in _routes(widths, k, M, 0):
            got = _forced(chain_scan_kernel, (*args, wi, wj, dw, db), how,
                          size)
            assert torch.equal(got, want), (k, how, size)
        for n_db, dbs in NUDGES.items():
            steps = [TMStep(*s) for s in _tm_steps(rng, w, k,
                                                   min(w.size, 32), 40, dbs)]
            packed = ev._tm_pack(k, steps)
            assert len(packed[0]) == n_db
            packed[6][::5] = False          # invalid steps never accept
            want = tm_chain_plain(*args, *packed).cpu()
            kinds |= {"pair" if ok and pair else "nudge" if ok else "miss"
                      for ok, pair in want[:, [0, 2]].tolist()}
            for how, size in _routes(widths, k, M, n_db):
                got = _forced(tm_chain_kernel, (*args, *packed), how, size)
                assert torch.equal(got, want), (k, n_db, how, size)
    if M >= 2248:
        assert kinds == {"pair", "nudge", "miss"}


@pytest.mark.gpu
@pytest.mark.parametrize("M,how", [(2248, "cluster"), (211, "cluster"),
                                   (30000, "block")])
def test_gpu_default_route_is_the_rule(M, how):
    """Unforced, each kernel takes :func:`route`'s route (the cluster at
    the paper's shapes, the block where no cluster holds the rows), one
    launch a call, bit for bit; a forced cluster that cannot hold the
    rows raises, and launches nothing."""
    _needs_card()
    rng = np.random.default_rng(M)
    ev, net = _state(rng, *PAPER, 6, M, "cuda")
    dev = ev._device_state()
    assert route(list(PAPER[0]), 0, M, len(DBS)) == how
    args = dev._chain_args(0, ev._count)
    _, wi, wj, dw, db = ev._pack([Candidate(*c) for c in _chain_cands(
        rng, net[0][0], 0, 24, 20)])
    before = dict(chain_scan_kernel.route_launches)
    got = ops.chain_scan(*args, wi, wj, dw, db)
    torch.cuda.synchronize()
    assert chain_scan_kernel.route_launches[how] == before[how] + 1
    assert torch.equal(got.cpu(), chain_scan_plain(*args, wi, wj, dw,
                                                   db).cpu())
    packed = ev._tm_pack(0, [TMStep(*s) for s in _tm_steps(
        rng, net[0][0], 0, 24, 40)])
    before = dict(tm_chain_kernel.route_launches)
    got = ops.tm_chain(*args, *packed)
    torch.cuda.synchronize()
    assert tm_chain_kernel.route_launches[how] == before[how] + 1
    assert torch.equal(got.cpu(), tm_chain_plain(*args, *packed).cpu())
    if how == "block":
        n0 = chain_scan_kernel.launches
        with pytest.raises(ValueError, match="cluster"):
            chain_scan_kernel(*args, wi, wj, dw, db, _route="cluster")
        with pytest.raises(ValueError, match="cluster"):
            chain_scan_kernel(*args, wi, wj, dw, db, _route="cluster",
                              _size=16)
        assert chain_scan_kernel.launches == n0


@pytest.mark.gpu
def test_gpu_too_wide_is_refused():
    """A layer past k+1 wider than 16 is refused on the card, not run
    another way; the layers the kernels take still run."""
    _needs_card()
    rng = np.random.default_rng(2)
    ev, net = _state(rng, (16, 16, 24, 10), ("htanh", "htanh", "hsig"), 5,
                     300, "cuda")
    steps = [TMStep(*s) for s in _tm_steps(rng, net[0][0], 0, 8, 20)]
    with pytest.raises(ValueError, match="at most 16"):
        ev.evaluate_tm_chain(steps, ev.accuracy(), engine="device")
    steps = [TMStep(*s) for s in _tm_steps(rng, net[0][1], 1, 8, 20)]
    assert ev.evaluate_tm_chain(steps, ev.accuracy(), engine="device") == \
        ev.evaluate_tm_chain(steps, ev.accuracy(), engine="host")


@pytest.mark.gpu
def test_gpu_too_wide_runs_on_the_host_under_auto():
    """Where the kernels do not take the net, a cached ``device`` pick for
    the TM chain and the serial chain (on by default on the card) run the
    host chain, with the host's decisions, and launch no kernel; the race
    leaves the device entrant out."""
    _needs_card()
    from repro_torch import tune
    from repro_torch.tune.cache import DispatchCache
    rng = np.random.default_rng(6)
    ev, net = _state(rng, (16, 16, 24, 10), ("htanh", "htanh", "hsig"), 5,
                     300, "cuda")
    assert ev._chain_scan and ev._chain_refusal(0) is not None
    steps = [TMStep(*s) for s in _tm_steps(rng, net[0][0], 0, 8, 20)]
    cache = DispatchCache({"platform": "cuda"})
    cache.put(tune.make_key("cuda", "tm_chain", tune.shape_bucket(
        (ev.n_val, len(steps))), "int64"), "device")
    n_tm, n_cs = tm_chain_kernel.launches, chain_scan_kernel.launches
    bha = ev.accuracy()
    with tune.use_cache(cache, measure=False):
        got = ev.evaluate_tm_chain(steps, bha)
    assert got == ev.evaluate_tm_chain(steps, bha, engine="host")
    assert set(tune.tm_chain_thunks(ev, 0, steps)) == {"host"}
    cands = [Candidate(*c) for c in _chain_cands(rng, net[0][0], 0, 20, 20)]
    host = BatchedHWEvaluator(_port(net), ev._x, ev._labels,
                              backend="numpy", device="cpu")
    assert ev.evaluate_chain(cands, bha) == host.evaluate_chain(cands, bha)
    assert (tm_chain_kernel.launches, chain_scan_kernel.launches) == \
        (n_tm, n_cs)


@pytest.mark.gpu
def test_gpu_serial_chain_is_the_kernel_on_the_card():
    """On a CUDA evaluator the serial chain is the kernel, one launch a
    call, with the host chain's decisions."""
    _needs_card()
    rng = np.random.default_rng(8)
    ev, net = _state(rng, *PAPER, 6, 2248, "cuda")
    host = BatchedHWEvaluator(_port(net), ev._x, ev._labels,
                              backend="numpy", device="cpu")
    assert ev._chain_scan and not host._chain_scan
    cands = [Candidate(*c) for c in _chain_cands(rng, net[0][1], 1, 40, 20)]
    n0 = chain_scan_kernel.launches
    assert ev.evaluate_chain(cands, ev.accuracy()) == \
        host.evaluate_chain(cands, host.accuracy())
    assert chain_scan_kernel.launches == n0 + 1


@pytest.mark.gpu
def test_gpu_tm_chain_engine_launches_once():
    """On a CUDA evaluator ``engine="device"`` launches the kernel once a
    call and decides as the host chain."""
    _needs_card()
    rng = np.random.default_rng(4)
    ev, net = _state(rng, *PAPER, 6, 2248, "cuda")
    steps = [TMStep(*s) for s in _tm_steps(rng, net[0][1], 1, 40, 40)]
    n0 = tm_chain_kernel.launches
    got = ev.evaluate_tm_chain(steps, ev.accuracy(), engine="device")
    assert tm_chain_kernel.launches == n0 + 1
    assert got == ev.evaluate_tm_chain(steps, ev.accuracy(), engine="host")
