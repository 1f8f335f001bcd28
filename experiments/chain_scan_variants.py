#!/usr/bin/env python3
"""Time text variants of ``csrc/chain_scan.cu`` on the paper's own chain
runs, in one process on one card.

    python3 experiments/chain_scan_variants.py NAME=[TRANSFORM[+...]] ...
        [--layer K] [--sizes 16,8,4]

``NAME=`` with no transform is the source itself; the transforms are the
keys of ``EDITS`` (text edits of the source, so a variant differs from it
by that edit only).  The net is ``chip_smoke.py``'s: 16-16-10-10 trained
on the card (40 epochs), min-q on the 2248 validation rows; the runs are
the tuners' first-sweep runs at layer K (0 by default), each also with
every move zeroed (the no-move run: no row runs a tail, so its time a
step is the route's synchronisation floor).

Each variant is built with the package's nvcc flags and loaded in place
of the package's library, so the wrapper (its route rule, forced routes
and sizes) runs unchanged; every output is held bit for bit against the
plain version (printed, not asserted).  Both kernels are timed by
``torch.profiler`` on the cluster route at each size and on the block,
in the order a, b, ..., b, a.  Needs a CUDA card and nvcc; builds into
``src/repro_torch/kernels/_build/``.
"""
import ctypes
import importlib
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
import chip_smoke as smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

cs = importlib.import_module("repro_torch.kernels.chain_scan")
SRC = (build.CSRC / "chain_scan.cu").read_text()

# name -> [(old text, new text), ...]
EDITS = {
    # 128 threads a cluster CTA
    "t128": [("constexpr int kClusterThreads = 256;",
              "constexpr int kClusterThreads = 128;")],
    # diagnostic, no outputs: the steps' outputs are not written, so the
    # time without the writer's device-memory stores (which a cluster
    # barrier's release waits for) shows
    "noout": [("    if (red.writer()) {", "    if (false && red.writer()) {")],
    # diagnostic, wrong counts: no partial is stored across the cluster
    # (the barrier stays), so the time without the remote stores shows
    "nostore": [("if (lane < n_ctas) store_remote(",
                 "if (lane < 0) store_remote(")],
}


def variant(transforms):
    src = SRC
    for t in transforms:
        for a, b in EDITS[t]:
            if a not in src:
                raise ValueError(f"{t}: the source no longer holds {a!r}")
            src = src.replace(a, b)
    return src


def paper_runs(layer, device="cuda"):
    """The trained, min-q'd paper net's evaluator on the card and its
    layer-``layer`` first-sweep runs as the kernels take them."""
    from repro_torch.core import find_min_q, quantize_inputs
    from repro_torch.configs.pendigits_mlp import hw_activations
    from repro_torch.data import pendigits
    from repro_torch.eval import BatchedHWEvaluator
    from repro_torch.launch.quickstart import EPOCHS, STRUCTURE
    from repro_torch.train.zaal import TrainConfig, train
    ds = pendigits.load()
    (xtr, ytr), (xval, yval) = ds.validation_split()
    res = train(TrainConfig(structure=STRUCTURE, epochs=EPOCHS),
                pendigits.to_unit(xtr), ytr, pendigits.to_unit(xval), yval,
                device=device)
    xval = quantize_inputs(pendigits.to_unit(xval))
    qr = find_min_q(res.weights, res.biases, hw_activations(STRUCTURE),
                    xval, yval, device=device)
    ev = BatchedHWEvaluator(qr.mlp, xval, yval, device=device)
    cands, steps = smoke._first_sweep_runs(ev, layer)
    args = ev._device_state()._chain_args(layer, ev._count)
    return args, tuple(ev._pack(cands)[1:]), ev._tm_pack(layer, steps)


def main():
    args = sys.argv[1:]
    opts = {a: args[i + 1] for i, a in enumerate(args)
            if a in ("--layer", "--sizes")}
    specs = [a for i, a in enumerate(args)
             if a not in opts and (i == 0 or args[i - 1] not in opts)]
    layer = int(opts.get("--layer", 0))
    sizes = [int(c) for c in opts.get("--sizes", "16,8,4").split(",")]
    variants = {}
    for spec in specs:
        name, _, parts = spec.partition("=")
        variants[name] = variant([p for p in parts.split("+") if p])
    vdir = build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    csrc = build.CSRC
    build.CSRC = vdir
    for name, text in variants.items():
        (vdir / f"cs_{name}.cu").write_text(text)
    t0 = time.perf_counter()
    build.build([f"cs_{n}" for n in variants])
    print(f"build {time.perf_counter() - t0:.1f} s")
    libs = {}
    for name in variants:
        for fn, line in smoke.ptxas_lines(build.build_log(f"cs_{name}")):
            print(f"  {name} {fn}: {line}")
        libs[name] = ctypes.CDLL(str(build.library_path(f"cs_{name}")))
    build.CSRC = csrc

    load = build.load

    def use(name):
        build.load = lambda n: libs[name] if n == "chain_scan" else load(n)
        cs._entry.cache_clear()
        cs._card_limits.cache_clear()

    smoke.CARD = smoke.card_line()
    print(smoke.CARD)
    use(next(iter(variants)))
    chain_args, run, packed = paper_runs(layer)
    runs = {"chain_scan": (cs.chain_scan_kernel, cs.chain_scan_plain, run),
            "tm_chain": (cs.tm_chain_kernel, cs.tm_chain_plain, packed)}
    want = {}
    for kname, (kernel, plain, r) in runs.items():
        still = smoke._no_move(r, kname == "tm_chain")
        want[kname] = [(r, plain(*chain_args, *r).cpu()),
                       (still, plain(*chain_args, *still).cpu())]
    routes = [("cluster", c) for c in sizes] + [("block", None)]
    order = list(variants) + list(variants)[::-1]
    times = {}
    for name in order:
        use(name)
        for kname, (kernel, _plain, _r) in runs.items():
            for how, size in routes:
                dev_name = f"{kname}_{'cluster_' if how == 'cluster' else ''}" \
                           f"kernel"
                for i, (r, w) in enumerate(want[kname]):
                    call = lambda: kernel(  # noqa: E731
                        *chain_args, *r, _route=how, _size=size)
                    exact = torch.equal(call().cpu(), w)
                    ms = smoke.kernel_device_ms(torch, call, dev_name, 20)
                    key = (kname, how, size, "no-move" if i else "run")
                    times.setdefault(key, {}).setdefault(name, []).append(
                        (ms, exact))
    n_steps = {"chain_scan": len(run[0]), "tm_chain": len(packed[1])}
    print(f"layer {layer} first sweep, {n_steps} steps [{smoke.CARD}]")
    for (kname, how, size, kind), by in times.items():
        label = how if size is None else f"cluster C={size}"
        print(f"{kname} {label} {kind}: " + ", ".join(
            f"{n} " + " / ".join(f"{ms*1e3:.2f}" for ms, _ in v) +
            f" us ({v[0][0]*1e3/n_steps[kname]:.3f} us a step)" +
            ("" if all(e for _, e in v) else " (NOT EXACT)")
            for n, v in by.items()))


if __name__ == "__main__":
    main()
