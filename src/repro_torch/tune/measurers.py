"""Thunk factories for the measured races behind each ``auto`` knob
(DESIGN.md 17.5), the counterpart of ``repro/tune/measurers.py``.

One factory per selection point, each returning ``{candidate: Thunk}`` for
:func:`repro_torch.tune.bench.race`.  Factories are only invoked on a cache
miss with tuning enabled (or by a caller filling the cache on purpose), so
the hot paths never pay for the imports or the synthetic workloads here.

Every candidate set is drawn from implementations the tests already prove
bit-identical -- the DESIGN.md 17.4 contract: the host evaluator backends
(numpy / torch parity tests), host vs device TM chains (chain-parity
tests), and dense vs fused paged decode in f32 (greedy tokens equal).  A
race can therefore pick any entrant without changing results -- only
wall-clock.  Entrants that are CUDA kernels carry ``cuda=True``: off the
card they would time their plain versions, so the race leaves them out
there.

The reference also races ``csd_qsweep`` *tilings* of its Pallas kernel.
The port has no such knob: ``csd_qsweep_kernel``'s route is the rule
``repro_torch.kernels.csd_matvec.route`` of the layer's shape.
"""
from __future__ import annotations

from .bench import Thunk


def qsweep_backend_thunks(x_val_int, labels, *,
                          backends=("numpy", "torch"),
                          qs=(4, 5, 6, 7), device="cpu"):
    """Race QSweepEvaluator backends on the caller's real validation split
    with a synthetic 2-layer MLP quantized at a few q levels (the sweep
    consumers' workload shape).  The evaluators race the host backends
    only: on the card ``csd``, the kernel, is the one candidate."""
    import numpy as np
    from repro_torch.core.quantize import quantize_mlp
    from repro_torch.eval.batched import QSweepEvaluator

    x = np.asarray(x_val_int)
    lab = np.asarray(labels)
    n_cls = int(lab.max()) + 1 if lab.size else 2
    rng = np.random.default_rng(0)
    h = 16
    ws = [rng.standard_normal((x.shape[1], h)) * 0.5,
          rng.standard_normal((h, n_cls)) * 0.5]
    bs = [rng.standard_normal((h,)) * 0.1,
          rng.standard_normal((n_cls,)) * 0.1]
    mlps = [quantize_mlp(ws, bs, ("htanh", "hsig"), q) for q in qs]
    thunks = {}
    for b in backends:
        ev = QSweepEvaluator(x, lab, backend=b, device=device)
        thunks[b] = Thunk(run=lambda ev=ev: ev.evaluate(mlps),
                          cuda=(b == "csd"))
    return thunks


def bhw_backend_thunks(mlp, x_val_int, labels, *,
                       backends=("numpy", "torch"),
                       n_cands: int = 64, device="cpu"):
    """Race BatchedHWEvaluator backends on the caller's committed network
    and validation split with a first-layer candidate batch (the tuners'
    workload shape).  As :func:`qsweep_backend_thunks`, host backends."""
    import numpy as np
    from repro_torch.eval.batched import BatchedHWEvaluator, Candidate

    w0 = np.asarray(mlp.weights[0])
    cands = [Candidate(layer=0, col=int(c), row=int(r),
                       wnew=int(w0[r, c]) - 1)
             for r in range(w0.shape[0]) for c in range(w0.shape[1])]
    cands = cands[:max(1, n_cands)]
    thunks = {}
    for b in backends:
        ev = BatchedHWEvaluator(mlp, x_val_int, labels, backend=b,
                                device=device)
        thunks[b] = Thunk(run=lambda ev=ev: ev.evaluate(cands),
                          cuda=(b == "csd"))
    return thunks


def tm_chain_thunks(ev, layer: int, steps):
    """Race the host vs device TM decision chains on the caller's OWN
    evaluator and step list (both chains leave committed state untouched,
    so racing them is free of side effects).  The device entrant is only
    admitted when its contract probe holds -- a chain that instantly returns
    ``(None, 0)`` must not win by doing nothing."""
    thunks = {"host": Thunk(run=lambda: ev._tm_chain_np(layer, steps))}
    probe, _ = ev._tm_chain_device(layer, steps)
    if probe is not None:
        thunks["device"] = Thunk(
            run=lambda: ev._tm_chain_device(layer, steps))
    return thunks


def decode_kernel_thunks(cfg, params, *, kv_block_size: int = 16,
                         max_batch: int = 2, max_context: int = 64,
                         prompt_len: int = 8, n_tokens: int = 8,
                         candidates=("dense", "fused"), device="cuda"):
    """Race the paged engine's decode kernels (gather+dense vs the fused
    block-paged attention kernel) on a short greedy run.  The fused entrant
    is a CUDA kernel, so off the card it is excluded and "dense" stands."""
    import numpy as np
    from repro_torch.runtime.serve import Request, ServeEngine

    thunks = {}
    for kernel in candidates:
        eng = ServeEngine(cfg, params, max_batch=max_batch,
                          max_context=max_context, eos_id=-1,
                          prefill_chunk=16, kv_block_size=kv_block_size,
                          decode_kernel=kernel, admission="truncate",
                          device=device)
        prompt = np.arange(1, prompt_len + 1, dtype=np.int32) % cfg.vocab

        def run(eng=eng, prompt=prompt):
            eng.run([Request(rid=-1, prompt=prompt,
                             max_new_tokens=n_tokens)])

        thunks[kernel] = Thunk(run=run, cuda=(kernel == "fused"))
    return thunks
