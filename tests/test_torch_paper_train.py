"""The ZAAL trainer of repro_torch against the reference's on the CPU:
forward and loss from the same parameters within 1e-6 relative, one Adam
and one SGD step within 1e-5, and a whole training run to a validation
accuracy within 3 points of the reference's at the same configuration
(the initial weights come from different generators, so the runs cannot
be held bit for bit)."""
import numpy as np
import pytest
import torch

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    import jax
    import jax.numpy as jnp
    from repro.train import zaal as jzaal
except ImportError:
    jzaal = None
from repro_torch.data import pendigits
from repro_torch.train import zaal

REL = 1e-6            # f32 sums in another order, relative to the scale
STEP_ATOL = 1e-5      # f32 gradients summed in another order
VAL_POINTS = 3.0      # accuracy points, different initial weights


def _case(structure, acts, seed=0, n=64):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0, 0.5, (a, b)).astype(np.float32)
          for a, b in zip(structure[:-1], structure[1:])]
    bs = [rng.normal(0, 0.1, b).astype(np.float32) for b in structure[1:]]
    x = rng.uniform(-1, 1, (n, structure[0])).astype(np.float32)
    y = rng.integers(0, structure[-1], n)
    return ws, bs, x, y


def _jparams(ws, bs):
    return [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in zip(ws, bs)]


@pytest.mark.parametrize("acts", [("htanh", "htanh", "sigmoid"),
                                  ("tanh", "relu", "softmax"),
                                  ("satlin", "lin", "hsig")])
def test_apply_and_loss_match(acts):
    ws, bs, x, y = _case((16, 12, 10, 10), acts)
    params = zaal.params_from_numpy(ws, bs, device="cpu")
    got = zaal.mlp_apply(params, acts, torch.from_numpy(x)).numpy()
    want = np.asarray(jzaal.mlp_apply(_jparams(ws, bs), acts,
                                      jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=REL,
                               atol=REL * np.abs(want).max())
    onehot = np.eye(10, dtype=np.float32)[y]
    got = float(zaal.loss_fn(params, acts, torch.from_numpy(x),
                             torch.from_numpy(onehot)))
    want = float(jzaal._loss_fn(_jparams(ws, bs), acts, jnp.asarray(x),
                                jnp.asarray(onehot)))
    assert got == pytest.approx(want, rel=REL)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_one_step_matches(optimizer):
    ws, bs, x, y = _case((16, 12, 10), ("htanh", "sigmoid"), seed=1)
    cfg = zaal.TrainConfig(structure=(16, 12, 10), optimizer=optimizer,
                           lr=0.05)
    jcfg = jzaal.TrainConfig(structure=(16, 12, 10), optimizer=optimizer,
                             lr=0.05)
    onehot = np.eye(10, dtype=np.float32)[y]
    params = zaal.params_from_numpy(ws, bs, device="cpu")
    opt = zaal.init_opt(params)
    update = zaal.make_update(cfg)
    jp = _jparams(ws, bs)
    jopt = (jax.tree.map(jnp.zeros_like, jp), jax.tree.map(jnp.zeros_like, jp))
    jupdate = jzaal._make_update(jcfg)
    params, opt, loss = update(params, opt, torch.from_numpy(x),
                               torch.from_numpy(onehot), 1)
    jp, jopt, jloss = jupdate(jp, jopt, jnp.asarray(x), jnp.asarray(onehot),
                              1)
    assert float(loss) == pytest.approx(float(jloss), rel=REL)
    for p, q in zip(params, jp):
        for key in ("w", "b"):
            np.testing.assert_allclose(p[key].numpy(), np.asarray(q[key]),
                                       atol=STEP_ATOL, rtol=0)
    assert not np.allclose(params[0]["w"].numpy(), ws[0], atol=1e-3)


def test_train_reaches_reference_accuracy():
    """16-10-10-10 for 40 epochs on the full surrogate split: the port's
    validation accuracy is within 3 points of the reference's, and a run
    started from the reference's initial weights takes the reference's
    minibatch order."""
    ds = pendigits.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    xtr_u, xval_u = pendigits.to_unit(xtr), pendigits.to_unit(xval)
    cfg = zaal.TrainConfig(structure=(16, 10, 10, 10), epochs=40)
    got = zaal.train(cfg, xtr_u, ytr, xval_u, yval, device="cpu")
    want = jzaal.train(jzaal.TrainConfig(structure=(16, 10, 10, 10),
                                         epochs=40),
                       xtr_u, ytr, xval_u, yval)
    assert abs(got.val_acc - want.val_acc) <= VAL_POINTS
    assert got.val_acc > 85.0
    assert [w.shape for w in got.weights] == [w.shape for w in want.weights]
    assert all(w.dtype == np.float64 for w in got.weights + got.biases)
    # the same initial weights and batch order give the same early losses
    init = jzaal.init_params(jzaal.TrainConfig(structure=(16, 10, 10, 10)),
                             jax.random.PRNGKey(0))
    short = zaal.TrainConfig(structure=(16, 10, 10, 10), epochs=2)
    got = zaal.train(short, xtr_u, ytr, xval_u, yval, device="cpu",
                     params=zaal.params_from_numpy(
                         [np.asarray(p["w"]) for p in init],
                         [np.asarray(p["b"]) for p in init], device="cpu"))
    want = jzaal.train(jzaal.TrainConfig(structure=(16, 10, 10, 10),
                                         epochs=2), xtr_u, ytr, xval_u, yval)
    np.testing.assert_allclose(got.loss_history, want.loss_history,
                               rtol=1e-4)


def test_init_params():
    for init in ("xavier", "he", "random"):
        cfg = zaal.TrainConfig(structure=(16, 10, 10), init=init)
        p = zaal.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        assert [t["w"].shape for t in p] == [(16, 10), (10, 10)]
        assert all(t["w"].dtype == torch.float32 for t in p)
        q = zaal.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        assert all(torch.equal(a["w"], b["w"]) for a, b in zip(p, q))
    with pytest.raises(ValueError):
        zaal.init_params(zaal.TrainConfig(structure=(4, 2), init="bad"),
                         torch.Generator(), device="cpu")
