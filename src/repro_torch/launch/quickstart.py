"""The paper pipeline, end to end:
``python -m repro_torch.launch.quickstart [--device cuda|cpu] [--out DIR]``.

The counterpart of ``examples/quickstart.py``, on the paper's largest
structure 16-16-10-10:

1. train the float ANN on the pendigits surrogate with the ZAAL trainer;
2. find the minimum quantization value (paper IV-A) on the multi-q sweep
   evaluator, and score the test split through the same kind of evaluator;
3. tune the integer weights for the parallel architecture (paper IV-B)
   with the planner-priced polish (``cost="adders"``), and for the
   time-multiplexed SMAC_NEURON one (paper IV-C, ``scope="neuron"``);
4. price the three design architectures (Section III) and the
   multiplierless styles (Section V) with the analytic cost model;
5. emit hardware: SIMURG writes the parallel CMVM design's Verilog,
   testbench, vectors, synthesis script and cost report (Section VI) to
   ``--out`` (default ``out/simurg_pendigits``, git-ignored).

On a CUDA device both evaluators default to the ``csd`` backend, so the
sweep runs through the ``csd_qsweep`` kernel and the polish through
``csd_matvec``; the script prints each kernel's launches.  The IV-C
tuner's decision chains, the pricing and SIMURG run on the host.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.pendigits_mlp import hw_activations
from repro_torch.core import (find_min_q, quantize_inputs, simurg,
                              tune_parallel, tune_time_multiplexed)
from repro_torch.core.archs import DesignReport, design_cost
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
TM_SWEEPS = 2
CHUNK = 128
OUT_DIR = "out/simurg_pendigits"
#: the design rows the reference quickstart prints: (arch, tuned network,
#: styles), "parallel" priced on the IV-B result, the SMAC ones on IV-C's
DESIGN_ROWS = (("parallel", "tp", ("behavioral", "cavm", "cmvm")),
               ("smac_neuron", "tm", ("behavioral", "mcm")),
               ("smac_ann", "tm", ("behavioral",)))


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
    tm: TuneResult              # the IV-C tuner's (scope="neuron")
    designs: list               # DesignReports of DESIGN_ROWS, in order
    simurg: simurg.SimurgOutput  # the parallel CMVM design of tp.mlp
    out_dir: str                # where SIMURG wrote its files
    seconds: dict   # wall time of "train", "min_q", "tune", "tm", "price",
                    # "simurg"


def price_designs(tp: TuneResult, tm: TuneResult,
                  engine: str = "array") -> list[DesignReport]:
    """The quickstart's design rows (:data:`DESIGN_ROWS`) priced on
    ``engine``."""
    nets = {"tp": tp.mlp, "tm": tm.mlp}
    return [design_cost(nets[net], arch, style, engine=engine)
            for arch, net, styles in DESIGN_ROWS for style in styles]


def run_pipeline(device="cuda", *, epochs=EPOCHS, max_sweeps=MAX_SWEEPS,
                 val_rows=None, chunk=CHUNK, out_dir=OUT_DIR) -> PaperRun:
    """Train, min-q, tune, price and emit on ``device`` with every backend
    on ``auto``; SIMURG writes to ``out_dir``.  ``val_rows`` keeps only the
    first rows of the validation split for the search and the tuners (the
    full split when None)."""
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
    test_ha = tuple(test_ev.evaluate([qr.mlp, tp.mlp]))
    t5 = clock()
    tm = tune_time_multiplexed(qr.mlp, xval_int, yval, scope="neuron",
                               max_sweeps=TM_SWEEPS, device=dev)
    t6 = clock()
    designs = price_designs(tp, tm)
    t7 = clock()
    out = simurg.generate(tp.mlp, arch="parallel", style="cmvm",
                          top="pendigits_ann")
    out.write(out_dir)
    t8 = clock()
    return PaperRun(
        train=res, acts=acts, x_val=xval_int, y_val=yval, x_test=xte_int,
        y_test=ds.y_test, qr=qr, tp=tp, sweep_ev=sweep_ev, test_ev=test_ev,
        test_ha=test_ha, tm=tm, designs=designs, simurg=out, out_dir=out_dir,
        seconds={"train": t1 - t0, "min_q": t3 - t2, "tune": t4 - t3,
                 "tm": t6 - t5, "price": t7 - t6, "simurg": t8 - t7})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory SIMURG writes the design to")
    args = ap.parse_args(argv)
    r = run_pipeline(args.device, out_dir=args.out)
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
    tm = r.tm
    print(f"   smac_neuron: bha={tm.bha:.2f}% repl={tm.replacements} "
          f"[tm chain: {tm.stats['eval_calls']} evaluator calls, "
          f"{r.seconds['tm']:.2f} s on the host, backend "
          f"{tm.stats['backend']}]")
    print(f"   kernel launches: csd_qsweep {csd_qsweep_kernel.launches}, "
          f"csd_matvec {csd_matvec_kernel.launches}")

    print("== 4. design-architecture costs (paper III + V) ==")
    for rep in r.designs:
        print("   " + rep.row())
    print(f"   [{r.seconds['price']*1e3:.1f} ms]")

    print("== 5. SIMURG: emit hardware (paper VI) ==")
    top = r.simurg.top
    print(f"   wrote {r.out_dir}/{{{top}.v, tb_{top}.v, vectors.txt, "
          f"synth.tcl, report.json}} [{r.seconds['simurg']*1e3:.1f} ms]")


if __name__ == "__main__":
    main()
