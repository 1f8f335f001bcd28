"""The paper pipeline's search and tuning path, end to end:
``python -m repro_torch.launch.quickstart [--device cuda|cpu]``.

The counterpart of steps 1-3 of ``examples/quickstart.py``, on the paper's
largest structure 16-16-10-10:

1. train the float ANN on the pendigits surrogate with the ZAAL trainer;
2. find the minimum quantization value (paper IV-A) on the multi-q sweep
   evaluator, and score the test split through the same kind of evaluator;
3. tune the integer weights for the parallel architecture (paper IV-B)
   with the planner-priced polish (``cost="adders"``).

On a CUDA device both evaluators default to the ``csd`` backend, so the
sweep runs through the ``csd_qsweep`` kernel and the polish through
``csd_matvec``; the script prints each kernel's launches.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.pendigits_mlp import hw_activations
from repro_torch.core import find_min_q, quantize_inputs, tune_parallel
from repro_torch.core.csd import tnzd
from repro_torch.core.quantize import QuantResult
from repro_torch.core.tuning import TuneResult
from repro_torch.data import pendigits
from repro_torch.eval import QSweepEvaluator
from repro_torch.eval.batched import resolve_device
from repro_torch.kernels.csd_matvec import (csd_matvec_kernel,
                                            csd_qsweep_kernel)
from repro_torch.train.zaal import TrainConfig, TrainResult, train

STRUCTURE = (16, 16, 10, 10)
EPOCHS = 40
MAX_SWEEPS = 4
CHUNK = 128


@dataclass
class PaperRun:
    """What one run of the pipeline produced, with the integer inputs it
    scored on, so that a caller can rerun a step on them."""
    train: TrainResult
    acts: tuple
    x_val: np.ndarray           # quantized validation inputs the search used
    y_val: np.ndarray
    x_test: np.ndarray          # quantized test inputs
    y_test: np.ndarray
    qr: QuantResult
    tp: TuneResult
    sweep_ev: QSweepEvaluator   # the evaluator find_min_q swept on
    test_ev: QSweepEvaluator
    test_ha: tuple              # test accuracy after min-q, after tuning
    seconds: dict               # wall time of "train", "min_q", "tune"


def run_pipeline(device="cuda", *, epochs=EPOCHS, max_sweeps=MAX_SWEEPS,
                 val_rows=None, chunk=CHUNK) -> PaperRun:
    """Train, min-q and tune on ``device`` with every backend on ``auto``.
    ``val_rows`` keeps only the first rows of the validation split for the
    search and the tuner (the full split when None)."""
    dev = resolve_device(device)

    def clock():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    ds = pendigits.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    t0 = clock()
    res = train(TrainConfig(structure=STRUCTURE, epochs=epochs),
                pendigits.to_unit(xtr), ytr, pendigits.to_unit(xval), yval,
                device=dev)
    t1 = clock()
    xval, yval = xval[:val_rows], yval[:val_rows]
    acts = hw_activations(STRUCTURE)
    xval_int = quantize_inputs(pendigits.to_unit(xval))
    xte_int = quantize_inputs(pendigits.to_unit(ds.x_test))
    t2 = clock()
    sweep_ev = QSweepEvaluator(xval_int, yval, device=dev)
    qr = find_min_q(res.weights, res.biases, acts, xval_int, yval,
                    evaluator=sweep_ev)
    t3 = clock()
    tp = tune_parallel(qr.mlp, xval_int, yval, max_sweeps=max_sweeps,
                       cost="adders", chunk=chunk, device=dev)
    t4 = clock()
    test_ev = QSweepEvaluator(xte_int, ds.y_test, device=dev)
    return PaperRun(
        train=res, acts=acts, x_val=xval_int, y_val=yval, x_test=xte_int,
        y_test=ds.y_test, qr=qr, tp=tp, sweep_ev=sweep_ev, test_ev=test_ev,
        test_ha=tuple(test_ev.evaluate([qr.mlp, tp.mlp])),
        seconds={"train": t1 - t0, "min_q": t3 - t2, "tune": t4 - t3})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    r = run_pipeline(args.device)
    res, qr, tp, s = r.train, r.qr, r.tp, r.tp.stats

    print("== 1. train (ZAAL, htanh/sigmoid) ==")
    print(f"   float: train={res.train_acc:.1f}% val={res.val_acc:.1f}% "
          f"[{r.seconds['train']:.2f} s on {args.device}]")

    print("== 2. minimum quantization value (paper IV-A, batched sweep) ==")
    print(f"   q={qr.q}  hw-val-acc={qr.ha:.2f}%  "
          f"history={[(q, round(h, 1)) for q, h in qr.history]}")
    print(f"   tnzd={tnzd(qr.mlp.weights + qr.mlp.biases)}  "
          f"hw-test-acc={r.test_ha[0]:.2f}%  "
          f"[sweep: {len(qr.history)} levels in "
          f"{r.seconds['min_q']*1e3:.1f} ms, "
          f"{r.sweep_ev.stats['eval_calls']} evaluator calls, backend "
          f"{r.sweep_ev.backend}]")

    print("== 3. post-training weight tuning (paper IV-B, cost=adders) ==")
    print(f"   parallel: bha={tp.bha:.2f}% repl={tp.replacements} "
          f"tnzd {s['tnzd_initial']} -> {s['tnzd_final']}, adders "
          f"{s['adders_initial']} -> {s['adders_final']}, "
          f"hw-test={r.test_ha[1]:.2f}%")
    print(f"   [batched engine: {r.seconds['tune']:.2f} s, "
          f"{s['candidates']} candidates in {s['eval_calls']} evaluator "
          f"calls, backend={s['backend']}]")
    print(f"   kernel launches: csd_qsweep {csd_qsweep_kernel.launches}, "
          f"csd_matvec {csd_matvec_kernel.launches}")


if __name__ == "__main__":
    main()
