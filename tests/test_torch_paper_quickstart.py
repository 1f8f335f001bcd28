"""The port's quickstart pipeline (train -> ``find_min_q`` ->
``tune_parallel(cost="adders")``, every backend on ``auto``) run on the CPU
at a small size, and held against the JAX package's search and tuner from
the same float weights: the same ``(q, ha, history)``, the same
``TuneResult`` and the same test-split scores."""
import numpy as np

try:    # the JAX package is the oracle; without JAX only -m gpu runs here
    from repro.core import find_min_q as jfind_min_q
    from repro.core import tune_parallel as jtune_parallel
    from repro.core.intmlp import hardware_accuracy as jhardware_accuracy
except ImportError:
    jfind_min_q = None
from repro_torch.launch import quickstart

SWEEPS, ROWS, CHUNK = 1, 300, 16


def test_quickstart_pipeline_equals_reference():
    r = quickstart.run_pipeline("cpu", epochs=2, max_sweeps=SWEEPS,
                                val_rows=ROWS, chunk=CHUNK)
    assert r.x_val.shape == (ROWS, quickstart.STRUCTURE[0])
    assert r.sweep_ev.backend == "numpy" and r.tp.stats["backend"] == "torch"
    assert set(r.seconds) == {"train", "min_q", "tune"}

    want_q = jfind_min_q(r.train.weights, r.train.biases, r.acts, r.x_val,
                         r.y_val)
    assert (r.qr.q, r.qr.ha, r.qr.history) == \
        (want_q.q, want_q.ha, want_q.history)

    want = jtune_parallel(want_q.mlp, r.x_val, r.y_val, cost="adders",
                          max_sweeps=SWEEPS, chunk=CHUNK, backend="jnp")
    got = r.tp
    for a, b in zip(got.mlp.weights + got.mlp.biases,
                    want.mlp.weights + want.mlp.biases):
        np.testing.assert_array_equal(a, b)
    assert (got.bha, got.initial_ha, got.replacements, got.sweeps,
            got.log) == (want.bha, want.initial_ha, want.replacements,
                         want.sweeps, want.log)
    assert dict(got.stats, backend="jnp") == want.stats
    assert got.stats["tnzd_final"] < got.stats["tnzd_initial"]

    assert r.test_ha == (
        jhardware_accuracy(want_q.mlp, r.x_test, r.y_test),
        jhardware_accuracy(want.mlp, r.x_test, r.y_test))
