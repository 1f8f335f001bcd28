"""The paper slice's numpy core of repro_torch against the JAX package on
the CPU, exactly: the pendigits surrogate, CSD arithmetic, the integer MLP
(including ``act_requant`` on torch tensors with per-network q), the
shift-add synthesis and its planner, and the quantizer."""
import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax.numpy as jnp
    from repro.configs import pendigits_mlp as jcfg
    from repro.core import csd as jcsd
    from repro.core import intmlp as jint
    from repro.core import mcm as jmcm
    from repro.core import planner as jplanner
    from repro.core import quantize as jquant
    from repro.data import pendigits as jpd
except ImportError:
    jnp = None
from repro_torch.configs import pendigits_mlp
from repro_torch.core import csd, intmlp, mcm, planner, quantize
from repro_torch.data import pendigits


def test_pendigits_arrays_equal():
    ds, jds = pendigits.load(), jpd.load()
    for name in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name))
    for (a, b), (c, d) in zip(ds.validation_split(), jds.validation_split()):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    (xtr, _), (xval, _) = ds.validation_split()
    assert (xtr.shape[0], xval.shape[0]) == (5246, 2248)
    np.testing.assert_array_equal(pendigits.to_unit(xval),
                                  jpd.to_unit(xval))
    assert pendigits_mlp.STRUCTURES == jcfg.STRUCTURES
    for s in pendigits_mlp.STRUCTURES:
        assert pendigits_mlp.hw_activations(s) == jcfg.hw_activations(s)


def test_csd_array_engine_equal():
    rng = np.random.default_rng(0)
    v = rng.integers(-5000, 5000, size=(13, 7))
    v[0, :3] = [0, 1, -1]
    np.testing.assert_array_equal(csd.to_csd_array(v), jcsd.to_csd_array(v))
    np.testing.assert_array_equal(csd.to_csd_array(v, depth=20),
                                  jcsd.to_csd_array(v, depth=20))
    np.testing.assert_array_equal(csd.from_csd_array(csd.to_csd_array(v)), v)
    np.testing.assert_array_equal(csd.nnz_array(v), jcsd.nnz_array(v))
    np.testing.assert_array_equal(csd.drop_least_significant_digit_array(v),
                                  jcsd.drop_least_significant_digit_array(v))
    np.testing.assert_array_equal(csd.largest_left_shift_array(v),
                                  jcsd.largest_left_shift_array(v))
    assert csd.tnzd([v, v[0]]) == jcsd.tnzd([v, v[0]])
    for x in v.ravel()[:40].tolist() + [0, 1, -1, 2 ** 40 - 1]:
        assert csd.to_csd(x) == jcsd.to_csd(x)
        assert int(csd.nnz_array(x)) == jcsd.nnz(x)
        assert csd.drop_least_significant_digit(x) == \
            jcsd.drop_least_significant_digit(x)
    with pytest.raises(ValueError):
        csd.to_csd_array(v, depth=3)


@pytest.mark.parametrize("act", intmlp.HW_ACTIVATIONS)
def test_act_requant_equal(act):
    """numpy int64, torch int32 with a scalar q, and torch with an array q
    of shape (Q, 1, 1) against the reference's numpy and jnp forms."""
    rng = np.random.default_rng(1)
    acc = rng.integers(-(1 << 20), 1 << 20, size=(4, 9, 5)).astype(np.int64)
    qs = np.array([1, 3, 6, 11], np.int64)[:, None, None]
    for q in (0, 4, 9):
        want = jint.act_requant(acc, act, q)
        np.testing.assert_array_equal(intmlp.act_requant(acc, act, q), want)
        got = intmlp.act_requant(torch.from_numpy(acc.astype(np.int32)),
                                 act, q)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jint.act_requant(jnp.asarray(acc, jnp.int32), act,
                                       jnp.asarray(qs, jnp.int32), xp=jnp))
    np.testing.assert_array_equal(want, jint.act_requant(acc, act, qs))
    for q_arr in (qs, torch.from_numpy(qs)):
        got = intmlp.act_requant(torch.from_numpy(acc.astype(np.int32)),
                                 act, q_arr)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(intmlp.act_requant(acc, act, qs), want)


def _int_mlp(rng, structure=(16, 10, 10, 10), q=5):
    acts = ["htanh"] * (len(structure) - 2) + ["hsig"]
    ws = [rng.integers(-40, 41, size=(a, b)) for a, b in
          zip(structure[:-1], structure[1:])]
    bs = [rng.integers(-30, 31, size=b) for b in structure[1:]]
    return intmlp.IntMLP(ws, bs, acts, q)


def test_forward_int_and_accuracy_equal():
    rng = np.random.default_rng(2)
    m = _int_mlp(rng)
    jm = jint.IntMLP([w.copy() for w in m.weights],
                     [b.copy() for b in m.biases], list(m.activations), m.q)
    xf = rng.uniform(-1, 1, size=(57, 16))
    x = intmlp.quantize_inputs(xf)
    np.testing.assert_array_equal(x, jint.quantize_inputs(xf))
    labels = rng.integers(0, 10, size=57)
    np.testing.assert_array_equal(intmlp.forward_int(m, x),
                                  jint.forward_int(jm, x))
    np.testing.assert_array_equal(intmlp.forward_int(m, x, return_acc=True),
                                  jint.forward_int(jm, x, return_acc=True))
    assert intmlp.hardware_accuracy(m, x, labels) == \
        jint.hardware_accuracy(jm, x, labels)
    got = intmlp.forward_int_torch(m, x, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jint.forward_int_jax(jm, x)))
    assert m.structure == jm.structure == [16, 10, 10, 10]


def test_synthesis_and_planner_equal():
    """CSE shift-add graphs equal the reference's node for node; the
    planner prices and caches alike."""
    rng = np.random.default_rng(3)
    for shape in ((10, 16), (10, 10), (1, 7), (5, 1)):
        mat = rng.integers(-60, 61, size=shape)
        for method in ("cse", "dbr"):
            g, jg = mcm.synthesize(mat, method), jmcm.synthesize(mat, method)
            assert g.nodes == jg.nodes and g.outputs == jg.outputs
            assert g.n_adders == jg.n_adders
            assert g.depth == jg.depth
            assert g.value_bounds() == jg.value_bounds()
        x = rng.integers(-128, 128, size=(6, shape[1]))
        np.testing.assert_array_equal(mcm.evaluate(g, x), x @ mat.T)
        assert mcm.dbr_adder_count(mat) == jmcm.dbr_adder_count(mat)
    p, jp = planner.SynthesisPlanner(), jplanner.SynthesisPlanner()
    ws = [rng.integers(-30, 31, size=(16, 10)), rng.integers(-30, 31, (10, 10))]
    for _ in range(2):
        assert p.cmvm_adder_cost(ws) == jp.cmvm_adder_cost(ws)
        assert p.cmvm_adders(ws[0]) == jp.cmvm_adders(ws[0])
    assert p.stats == jp.stats and len(p) == len(jp)
    assert isinstance(planner.default_planner, planner.SynthesisPlanner)


def test_quantize_equal():
    rng = np.random.default_rng(4)
    ws = [rng.normal(size=(16, 10)), rng.normal(size=(10, 10))]
    bs = [rng.normal(size=10), rng.normal(size=10)]
    for q in (1, 5, 12):
        np.testing.assert_array_equal(quantize.quantize_value(ws[0], q),
                                      jquant.quantize_value(ws[0], q))
        m = quantize.quantize_mlp(ws, bs, ("htanh", "hsig"), q)
        jm = jquant.quantize_mlp(ws, bs, ("htanh", "hsig"), q)
        for a, b in zip(m.weights + m.biases, jm.weights + jm.biases):
            np.testing.assert_array_equal(a, b)
        assert m.q == jm.q and m.activations == jm.activations
    with pytest.warns(UserWarning, match="zip-truncates"):
        quantize.quantize_mlp(ws, bs, ("htanh",), 3)
