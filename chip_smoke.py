#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, and the build of every CUDA kernel of every path from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
   together; ptxas's registers and spills printed, a spill in the chain
   kernels, ``wkv6`` or the flash backward fails the run, one in
   ``wkv6_bwd`` at hd = 64 in phase 16);
2. kernels: each kernel against its plain PyTorch version on the card at
   its path's shapes, and their device times beside the bound and the
   plain and library times.  The serving kernels at bf16, Hq=14, Hkv=2,
   D=64, block 32, 8 slots of mixed lengths up to 1024, sentinel table
   entries -- the gather bit-exact on both routes, K and V as one pair
   launch and one leaf alone, through the int64 table a prefill dispatch
   hoists (the kernel maps the sentinels), the model's K+V helper profiled
   as exactly one device kernel, the pair timed on both routes and one
   leaf alone beside the bound and ``index_select``; the split-KV
   attention (its split
   count and workspace printed) within atol 2e-3 + rtol 1e-2 at windows 0
   and 200, timed at window 0, and also at window 200 and at one split.
   The CSD digit-plane kernels bit-exact (``torch.equal``) at one polish
   call's tail (287,744 x 10 rows by 10 x 10 planes, D = 1, 8, 16), ragged
   and odd shapes, a depth of 40, the sweep's three layers of 16-16-10-10
   (4 networks x 2248 rows), each kernel on both of its routes where both
   apply (``csd_matvec``: streaming and planes); both timed on both
   routes between two timings of the float64 matmul;
   The flash-attention kernel against its plain version in f32 (its
   CUDA-core route, within 2e-5) and bf16 (its tensor-core route, the
   plain version at the kernel's own key tile ``KEY_TILE``, under
   ``bf16_disagreement``: each element within two bf16 ulps of its own
   magnitude plus 2^-8 of its row's largest, at most 1 % of elements
   different; the kernel in f32 on the same inputs, i.e. p left unrounded,
   must fail it at the loss shape): causal GQA 7:1, a window with an
   offset, rows that see no key, non-causal, MHA, the loss shape (8 x
   1024, 14 / 2 heads of 64), the first reference prefill batch's shape,
   and the hybrid's loss (1 x 4096) and first prefill batch shapes (16 / 1
   heads of 256, window 2048); ptxas's registers and spills of the bf16
   instantiations at D = 64 and 256 (a spill fails the run); bf16 timed at
   the loss shapes and the prefill shapes beside
   ``scaled_dot_product_attention``, the f32 route once at the loss
   shape.  The linear-scan kernel bit for bit (int32 views) at the
   reference test's three shapes on the route its rule picks and at the
   hybrid's loss, first prefill batch and decode shapes on every route
   (ring, step and tiled, the first version), every route timed at
   those three;
2b. the int8 power-of-two matmul's path, the port's public op
   ``repro_torch.kernels.qmatmul``, at qwen2-0.5b's full widths: one call
   per distinct (K, N) of the int8-PoT tree of random weights from seed 0
   (q and o 896 x 896, k and v 896 x 128, the gate 896 x 4864, down
   4864 x 896, the embedding 151936 x 896, the head 896 x 151936; ``wu``
   stays float under the reference's skip rule), at M = 8 and M = 512,
   the counters zeroed just before and read just after (every call on
   the TMA route), each result equal to the plain version and to x @
   dequant(w) in float64 rounded once; ptxas's registers and spills of
   the TMA route's instantiations (a spill fails the run); the kernel bit
   for bit against its plain version, f32 and bf16, on both routes where
   the TMA route applies, at the reference tests' shapes, the kernel
   lane's, M = 1 and those widths, e across [-20, 20]; its times at every
   width but the embedding's (no step multiplies by the embedding table)
   beside the bound, the plain version, the mma route at two widths
   and ``torch._int_mm`` on w stored column-major, as cuBLASLt's int8
   GEMM wants it, then the scale multiply (at M = 8 on x zero-padded to 32
   rows), that route checked equal to the plain version;
3. small-input references: a tiny f32 model served on the card through
   both serving kernels gives the CPU engine's greedy tokens; the tiny
   model's ``Model.loss`` on the card is the CPU's within 1e-5 relative and
   ``ReferenceEngine`` (float and int8-PoT) gives the CPU's greedy tokens;
   a tiny f32 rwkv6 (4 layers, d_model 64, heads of 16) likewise: its
   loss within 1e-5 relative of the CPU's with one ``wkv6`` launch a
   layer (hd = 16 on the card), and ``ReferenceEngine``'s greedy tokens,
   float and int8-PoT;
4. serving, full width: qwen2-0.5b (24 layers, d_model 896, vocab 151936)
   with random weights from a seed, int8-PoT quantized, block-paged KV,
   ``kv_gather="cuda"``, ``decode_kernel="fused"``, 16 requests; launch
   counters are zeroed just before and read just after (one K+V pair
   gather a layer and prefill dispatch, no one-leaf gather).  The same
   requests then go through ``kv_gather="take"``, ``decode_kernel="dense"``
   and the first decode step's logits are compared; and through
   ``kv_gather="cuda"``, ``decode_kernel="dense"``, whose tokens and first
   logits must equal take/dense's exactly (the gather is a copy);
5. a ``torch.profiler`` window over a few engine steps: device busy share,
   the top kernels and ``paged_attention``'s share of the busy time;
6. the paper's pipeline, full size, through the quickstart's
   ``run_pipeline``: 16-16-10-10 trained on the card on the pendigits
   surrogate (5246 train / 2248 validation / 3498 test rows, 40 epochs),
   ``find_min_q`` and ``tune_parallel(cost="adders", max_sweeps=4)`` with
   their default ``auto`` backend (``csd`` on the card, so both CSD
   kernels run, and the serial chain on the ``chain_scan`` kernel;
   counters zeroed just before and read just after, the (Q, M, K, N, D)
   of each ``csd_qsweep`` launch printed, every one on its resident
   route, every ``csd_matvec`` on its streaming route), the test split
   scored, ``tune_time_multiplexed(scope="neuron", max_sweeps=2)`` (its
   chains on the ``tm_chain`` kernel), ``design_cost`` of the six
   design rows and SIMURG's parallel CMVM design written to
   ``out/chip_smoke/csd``; a ``torch.profiler`` rerun of the tune call for
   the device busy share and a cProfile rerun for the host's time by
   function; then every step on the ``numpy`` backend from the same float
   weights (host chains): identical min-q, ``TuneResult``s (the TM
   tuner's ``stats["candidates"]`` aside: the device engine counts every
   nudge of a failed pair) and test scores, design rows
   equal on the array engine and on the scalar one (which must agree),
   and SIMURG files byte-identical;
6c. the device decision chains and measured dispatch on phase 6's net
   and validation rows: both chain kernels (``chain_scan``, ``tm_chain``)
   on both routes (``cluster``, ``block``) against their plain versions
   bit for bit (``torch.equal`` on every output), the serial one also
   against the host chain, on the tuners' own first-sweep runs and on
   random runs at every layer of 16-16-10-10 and of a 5-layer net (pair
   accepts, nudge hits and steps where every nudge fails all seen); each
   timed on layer 0's first-sweep run (device time from
   ``torch.profiler``) on the cluster at every size that holds the rows
   and on the block, each also on the run's no-move twin (every move
   zeroed: the route's synchronisation floor a step), beside the host
   chain's wall time and the bytes bound, the rule's route and size
   printed; the chain launches of phases 6, 6c and 6b counted by route
   and size, every one on the cluster route;
   ``tune_time_multiplexed(scope="neuron", max_sweeps=2,
   chain_engine="device")`` on ``csd`` identical to phase 6's run and,
   ``stats["candidates"]`` aside, to ``chain_engine="host"``'s on ``csd``
   and to numpy's (host chains, each timed), ``tm_chain`` launched once
   per chain call; ``tune_parallel(cost="adders",
   max_sweeps=4)`` on the card (the serial chain on ``chain_scan``)
   identical to phase 6's; every kernel's counter zeroed just before and
   read just after the two tuners; then ``REPRO_TUNE`` on with the cache
   in a temporary file: races of ``qsweep_backend`` and ``bhw_backend``
   on CPU evaluators (on the card ``csd`` is their one candidate, which
   a CUDA evaluator must resolve to under the filled cache) and of
   ``tm_chain`` on the card at the paper's shapes (each entrant's time
   and the winner printed), a second decide of each a hit, the reloaded
   file keeping every winner, ``find_min_q`` and both tuners identical
   under the filled cache, and ``ServeEngine(decode_kernel="auto")`` on a tiny
   f32 model "dense" on a miss and a forced cache pick ("fused") when one
   exists, with equal greedy tokens;
6b. the design-space explorer at the reference walkthrough's size through
   ``launch/explore.py``: 16-16-10 trained on the card (25 epochs, seed
   3), ``q_span=2``, tuners ``none``, ``parallel``, ``parallel-adders``
   and ``tm-neuron`` (``max_sweeps=3``) and the per-layer mixed-q variant
   ``mixedbw``, once with the sweep evaluator on
   ``auto`` (which must be ``csd``; ``csd_qsweep`` counted from zero and
   launched, its shapes printed as on the paper path), again under
   ``torch.profiler`` for the device busy share,
   and once on ``numpy``: every ``DesignPoint``, the three fronts and the
   non-timing stats identical;
7. the LM-scale quantization path, full width, through
   ``repro_torch.launch.serve_quantized.run_pipeline``: qwen2-0.5b with
   random weights from seed 0, ``min_bitwidth_search(budget=0.02)`` on one
   8 x 1024 ``TokenPipeline`` batch, batched and serial (identical bits and
   history), ``sls_rescale(max_raise=1)``, then ``ReferenceEngine``
   (int8-PoT at the searched bits, 8 rows x 2048 context) serving 16
   seeded prompts of 128-1536 tokens, 32 new tokens each.  The
   flash-attention counter is zeroed just before and read just after: 24
   launches per ``Model.loss`` call and per prefill batch;
8. a ``torch.profiler`` window over one more ``ReferenceEngine`` batch:
   device busy share and the top kernels;
8b. mixed bit widths, full width, through
   ``repro_torch.launch.mixed_bitwidth.run_pipeline``: qwen2-0.5b from
   seed 0 on the same validation batch, ``mixed_bitwidth_search(budget=
   1e-3)`` batched and serial (identical bits, start rung and history;
   the start above the ladder's floor, at least one round scored; 24
   flash launches per ``Model.loss`` call; weight bytes no more than the
   global rung's ledger), then the searched ``{path: bits}`` served by
   ``ServeEngine`` at the serving phase's configuration on its 16
   requests (K+V pair gathers and split attention launched, no one-leaf
   gather; the engine's ledger carries the bits), again with the
   dequantized tree as float parameters (greedy tokens and first decode
   logits identical) and on ``ReferenceEngine`` (its share of equal
   tokens printed); the pendigits ``mixed_minq_search`` (16-16-10, 25
   epochs, seed 3) on ``csd`` (``csd_qsweep`` launched) and again on
   ``numpy`` (identical); the kernels' counters zeroed just before and
   read just after; then a ``torch.profiler`` window over a few steps
   of the mixed engine;
9. the hybrid family, full width: recurrentgemma-9b (d_model 4096, 16 / 1
   heads of 256, window 2048, vocab 256000) at ``HYB_LAYERS`` (20) of its
   38 layers (6,036,172,800 parameters, 22.49 GiB of f32 masters, after the
   earlier phases free theirs) with random weights from seed 0: the f32 decode
   of token 2101 after ``prefill(2100)`` against ``prefill(2101)`` (the ring
   wraps), a bf16 ``Model.loss`` on one 4096-token ``TokenPipeline`` row, and
   ``ReferenceEngine`` (4 rows x 2048 context) serving 8 seeded prompts of
   256-1536 tokens, 32 new tokens each, then one more batch under the
   profiler.  The counters are zeroed before the loss and read after the
   serving: 14 linear-scan and 6 flash launches per prefill or loss
   forward at 20 layers, 14 linear-scan and no flash launches per decode
   step; the
   loss's scans all on the ring route, the serving's on the ring
   (prefill) and step (decode) routes;
10. the MoE family, after the hybrid's memory is freed: first the three
   attention-path kernels at its new shapes against their plain versions
   and timed (the K+V pair gather bit for bit and the split paged
   attention, bf16 and f32, at 16 / 16 and 56 / 8 heads of 128, flash
   at qwen2-moe's loss and first ReferenceEngine prefill shapes under
   ``bf16_disagreement``); then qwen2-moe-a2.7b at full width and
   ``MOE_SERVE_LAYERS`` (12) of its 24 layers (7,469,033,472 f32
   parameters from seed 0, full depth's 14,315,735,040 held by shape,
   each leaf cast to bf16 once): ``ServeEngine`` at the serving cell's
   settings on its 16 requests on the fused route (counters zeroed just
   before and read just after: one K+V pair gather a layer and prefill
   dispatch, one attention
   and one combine launch a layer and decode step), then take/dense
   (first decode logits within ``LOGIT_REL_TOL``) and cuda/dense (tokens
   and logits identical to take/dense); the fused run's first prefill
   dispatch's layer-0 routing (``moe_route`` on the card) identical to a
   numpy recomputation on the same probabilities; ``ReferenceEngine`` (4
   rows x 2048, the hybrid's 8 prompts, one flash launch a layer and
   prefill); one 8 x 1024 ``Model.loss`` (xent near ln V + s2/2, aux
   printed); the int8-PoT engine at 8 of the 24 layers (both routes, its
   serving ledger and ``quant_bytes`` printed, the f32 masters dropped
   once the engines are built); arctic-480b's full-width layer (1 of 35)
   in bf16 on both routes, 8 of the serving cell's requests;
11. the RWKV6 family, after the MoE's memory is freed: (a) ptxas's
   registers and spills for every hd instantiation of both ``wkv6``
   routes (a spill fails) and the library's tiling against ``wkv6.tiling``; the kernel
   against its plain version (the final state bit for bit, y within
   ``WKV_Y_TOL`` of its row's max |y|) at the loss shape (8, 1024, 40,
   64), the first ReferenceEngine prefill batch's, a decode step (4, 1)
   from a nonzero state, hd = 16 and 128 and S = 1, 63 and 1000 in f32,
   and at the first three with bf16 r, k, v (as the bf16 path gives
   them); timed at the first three, bf16 and f32, beside both bounds
   (FP32 issue slots, ``wkv_slots``; bytes, ``wkv_bytes``) and the plain
   version; then rwkv6-3b at full width and ``RWKV_LAYERS`` (16) of its 32
   layers (d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536; 1,599,490,560
   f32 parameters from seed 0): (b) the f32 decode of token 2101 after
   ``prefill(2100)`` against ``prefill(2101)``; the int8-PoT engine built
   from the f32 masters, which are then cast to bf16 once; (c) a bf16
   ``Model.loss`` on one 8 x 1024 ``TokenPipeline`` batch; (d)
   ``ReferenceEngine`` (4 rows x 2048) on the hybrid phase's 8 prompts,
   32 new tokens each; (e) the int8-PoT engine on the same prompts (its
   serving ledger and its share of greedy tokens equal to bf16's); the
   ``wkv6`` counter zeroed just before (c) and read after (e): one launch
   a layer (16) a loss forward, prefill and decode step; (f) a
   ``torch.profiler``
   window over one more bf16 batch (``wkv6``'s share of the busy time,
   the direct copies' count);
12. the audio family, after the RWKV6's memory is freed: (a) the flash
   kernel at whisper-base's shapes against its plain version in f32
   (within ``FLASH_F32_TOL``) and bf16 (under ``bf16_disagreement``) --
   the encoder's non-causal MHA (16, 1500, 8 / 8 heads of 64), the
   cross-attention of 448 decoder tokens against 1500 frames, the
   decoder's causal 448 -- and each timed in bf16 beside the bound, the
   plain version and ``scaled_dot_product_attention``; then whisper-base
   at full width and depth (6 encoder and 6 decoder layers, d_model 512,
   vocab 51865; 109,749,248 f32 parameters from seed 0, frames (B, 1500,
   512) from a seeded numpy generator): (b) the f32 decode of token 65
   after ``prefill(64)`` (k and v padded to the 448-token context)
   against ``prefill(65)``; the int8-PoT tree (``serving_quant``) from the
   f32 masters, which are then cast to bf16 once; (c) a bf16
   ``Model.loss`` on 16 x 448 tokens and their frames; (d) a greedy
   serving loop through ``Model.prefill`` / ``decode_step`` (8 rows of
   frames, 4-token prompts, 128 new tokens, context 448), bf16 and
   int8-PoT (dequantized every dispatch, as ``ReferenceEngine`` does),
   with the int8-PoT tokens' share equal to bf16's; the flash counter
   zeroed just before (c) and read just after (d): 18 launches a forward
   (6 encoder, 6 decoder self, 6 cross) and none a decode step; (e) a
   ``torch.profiler`` window over 16 bf16 decode steps;
13. the VLM family, after the audio phase's memory is freed: (a) ptxas's
   registers and spills of both flash routes' D = 128 instantiations (a
   spill fails), and the flash kernel at llava-next-34b's shapes, GQA 7:1
   (56 / 8 heads of 128), causal, against its plain version -- the loss
   (2, 3904) and the greedy prefill (4, 2896) in bf16 under
   ``bf16_disagreement``, each timed beside the bound, the plain version
   and ``scaled_dot_product_attention``; the f32 check's prefill (1,
   2945) within ``FLASH_F32_TOL``, timed on its own; then llava-next-34b
   at full width and ``VLM_LAYERS`` (8) of its 60 layers (d_model 7168,
   d_ff 20480, vocab 64000; 5,387,705,344 f32 parameters from seed 0, patch
   embeddings (B, 2880, 1024) from a seeded numpy generator, the vision
   tower a stub): (b) the f32 decode of token 65 after a prefill of the
   2880 patches and 64 tokens (k and v padded to the 3072-position
   context) against a prefill of the patches and 65 tokens; the int8-PoT
   tree (``serving_quant``, ``vision_proj`` quantized) from the f32
   masters, which are then cast to bf16 once; (c) a bf16 ``Model.loss``
   on 2 x 1024 tokens after their patches, the mask zero over the
   patches; (d) a greedy loop through ``Model.prefill`` / ``decode_step``
   (4 rows, 16-token prompts after the patches, 64 new tokens, context
   3072), bf16 and int8-PoT (dequantized every dispatch), with the
   int8-PoT tokens' share equal to bf16's and each loop's peak memory;
   the flash counter zeroed just before (c) and read just after (d): one
   launch a layer (8) a forward and none a decode step; (e) a
   ``torch.profiler``
   window over 16 bf16 decode steps;
14. the dense configs, after the VLM phase's memory is freed: (a) the
   attention path's kernels at their head layouts, D = 128 -- the K+V
   pair gather at 2, 8 and 20 KV heads bit for bit (its route printed)
   and the split paged attention at G = 8, 2 and 1 (16 / 2, 16 / 8, 20 /
   20) in bf16 (atol 2e-3 + rtol 1e-2) and f32 (``FLASH_F32_TOL``), its
   split count and workspace printed, on the serving cell's 8 slots with
   sentinel entries; flash at each config's (8, 1024) loss shape, causal,
   under ``bf16_disagreement``; each timed beside the bound, the plain
   version and the library call (``index_select`` x 2, SDPA); then
   qwen2.5-3b, internlm2-1.8b and qwen1.5-4b in turn, each at full width
   and half its depth (``DENSE_SERVE_LAYERS``: 18, 12 and 20 layers; full
   depth's 3,397,103,616, 1,889,110,016 and 3,950,369,280 f32 parameters
   held by shape; random weights from seed 0) and freed before the next:
   (b) ``ServeEngine`` in f32 on the fused and take/dense routes (8
   requests, 2 new tokens: equal greedy tokens, first decode logits within
   ``LOGIT_REL_TOL``);
   for qwen2.5-3b the int8-PoT ``ReferenceEngine`` from the f32 masters;
   one cast to bf16; (c) ``ServeEngine`` on the serving cell's settings and 16
   requests: the fused route with the cuda gather, its counters zeroed
   just before and read just after (one K+V pair a layer and prefill
   dispatch, no one-leaf gather, one attention and one combine launch a
   layer and decode step), then, for qwen2.5-3b, take/dense (first
   decode logits within ``LOGIT_REL_TOL``), cuda/dense (tokens and logits
   identical to take/dense's) and a ``torch.profiler`` window over 8
   fused decode steps; (d) ``ReferenceEngine`` (4 rows x 2048, the
   hybrid's 8 prompts) in bf16 (and int8-PoT for qwen2.5-3b), one flash
   launch a layer and prefill batch, and one 8 x 1024 bf16 ``Model.loss``
   (xent near ln V + s2/2, one flash launch a layer: 36, 24, 40); (e) the
   serve launcher,
   ``--quantized --kv-gather cuda --decode-kernel fused`` on the serving
   cell's settings and 16 prompts of 256 tokens, every request done and
   both paged kernels launched;
15. training, after the dense phase's memory is freed: (a) ptxas's
   registers and spills of every instantiation of the flash backward
   (``flash_attention_bwd.cu``: delta, dk/dv and dq, f32 on the CUDA cores
   and bf16 on the tensor cores, 25; a spill fails the run), then the
   backward through ``FlashAttention`` against autograd through the plain
   version at qwen2-0.5b's loss shape (8, 1024, 14 / 2 heads of 64) and at
   D = 128, GQA 8:1 (qwen2.5-3b's 16 / 2), causal, f32 within
   ``BWD_F32_TOL`` of each gradient's largest magnitude and bf16 under
   ``bf16_grad_disagreement``, two runs bit-identical in each dtype, and
   in bf16 timed beside its bound (five products), autograd's backward
   through the plain version and ``scaled_dot_product_attention``'s
   backward (the device time of its kernels, and eager), the device time
   of each of its two bf16 kernels (dq, which writes delta, and dk/dv, on
   the cluster size ``bwd_cluster`` picks) printed; the forward
   at the loss shape timed with and without its lse; (b) the f32
   ``Model.loss`` gradient of qwen2-0.5b at full width and 2 layers
   (norms and biases seeded), 2 x 256, on the card against the same call
   on the CPU, each leaf within ``TRAIN_GRAD_TOL`` of its largest
   magnitude; (c) ``launch/train.py`` at qwen2-0.5b's full width and
   depth, 8 x 1024 bf16 batches on f32 masters and f32 AdamW moments, 6
   steps, the flash counters zeroed just before and read just after (48
   forward launches a step, 24 of them remat's recompute, and 24 backward
   calls), the first loss near ln V + s2/2, every loss and grad norm
   finite, the step's time, tokens/s, the 6 N D share of the bf16 peak and
   the peak memory, the checkpoint written to a temporary directory and
   removed; (d) ``TrainLoop`` at full width, 2 layers, vocab 4096, with
   deterministic algorithms on (``CUBLAS_WORKSPACE_CONFIG`` is set before
   the first cuBLAS call): a failure injected at step 6 of 8, a checkpoint
   every 4 steps, every final leaf equal to an uninterrupted run's; (e)
   the tiny-train mirror on the card (60 steps, vocab 64): the loss drops
   by more than 0.5;
16. RWKV6 training, after phase 15's memory is freed: (a) ptxas's
   registers and spills of every kernel of the WKV backward
   (``wkv6_bwd.cu``: passes A and B at hd 16-128, f32 and bf16 r, k, v; a
   spill in either at hd = 64, the path's width, fails) and the library's
   tiling, then the backward against its plain version, the gradient of
   log w against w dw, from a nonzero state, at every hd and S in {1, 16,
   37, 1024} (the loss shape (8, 1024, 40, 64) at hd 64), f32 and bf16,
   with and without the final state's gradient, and with w = 0 on every
   other key, each gradient within ``WKV_BWD_TOL`` of its largest
   magnitude, two calls bit-identical; through ``Wkv6`` on log w at the
   loss shape in bf16, dr, dk, dv within one bf16 ulp (plus the
   tolerance) of the plain f32 gradients rounded; both dtypes timed at the
   loss shape, the whole call and each pass alone, beside the bound (FP32
   issue slots, ``wkv_bwd_slots``; bytes, ``wkv_bwd_bytes``), the two
   passes' floor (``wkv_bwd_pass_floors``) and autograd through
   ``wkv6_plain``; (b) the f32
   ``Model.loss`` gradient of rwkv6-3b at full width and 2 layers (``u``,
   ``mu``, ``cm_mu``, ``ln_x``, ``w0`` seeded), 2 x 256, card against CPU,
   each leaf within ``TRAIN_GRAD_TOL`` of its largest magnitude; (c)
   ``launch/train.py --arch rwkv6-3b`` at full width and depth (2,863,434,240
   f32 leaves), 8 x 1024 bf16 batches on f32 masters and f32 AdamW moments,
   6 steps, the wkv6 counters zeroed just before and read just after (64
   forward launches a step, 32 of them remat's recompute, and 32 backward
   calls), the first loss near ln V + s2/2, every loss and grad norm
   finite, no restart, the step's time, tokens/s, the 6 N D share and the
   peak memory, the checkpoint written to a temporary directory and
   removed; (c') one more step under ``torch.profiler``: the device busy
   share and the wkv6 kernels' shares of it;
17. hybrid training, after phase 16's memory is freed: (a) ptxas's
   registers and spills of the flash backward's five D = 256
   instantiations (a spill fails the run), then the backward through
   ``FlashAttention`` against autograd through the plain version, f32 and
   bf16, two calls bit-identical, at recurrentgemma-9b's local attention
   (16 / 1 heads of 256, causal, window 2048) at (2, 4096) and (1, 4096),
   and at (1, 300) under a window of 128 and (2, 333) without one; in
   bf16 timed at both 4096-row shapes beside its bound, autograd through
   the plain version and ``scaled_dot_product_attention``'s backward with
   the window as a mask (its backend named); (b) the linear scan's
   backward (the forward kernel over the time-reversed inputs) at (2,
   4096, 4096): bit-identical to the plain reversed scan and on repeat,
   within ``SCAN_BWD_TOL`` of autograd through the plain scan, timed
   beside its bytes bound; (c) the f32 ``Model.loss`` gradient of
   recurrentgemma-9b at full width, 4 layers (a unit and a tail layer),
   vocab 4096, 1 x 2304, norms, ``lam``, gates and conv seeded, card
   against CPU, each leaf within ``TRAIN_GRAD_TOL`` of its largest
   magnitude; (d) the train launcher's ``train`` at recurrentgemma-9b's
   full width and ``HYB_TRAIN_LAYERS`` (5) of its 38 layers (a unit and the two
   tail layers; the cut printed), 2 x 4096 bf16 batches on f32 masters and f32
   AdamW moments, remat a unit, 6 steps, the counters zeroed just before and
   read just after (a step at 5 layers: 2 flash forward launches and 1 backward
   call, 6 forward and 4 backward scans), the first loss near ln V + s2/2,
   every loss and grad norm finite, no restart, the step's time, tokens/s, the
   6 N D share and the peak memory, the checkpoint written
   to a temporary directory and removed; (e) one more step under
   ``torch.profiler``: the device busy share and the shares of the flash
   kernels and the scan;
18. MoE training, after phase 17's memory is freed: (a) the flash
   backward at qwen2-moe's MHA layout (16 / 16 heads of 128, G = 1) at
   the train cell's (8, 1024) through ``FlashAttention`` against autograd
   through the plain version, f32 and bf16, two calls bit-identical,
   timed in bf16 beside its bound, the plain version and SDPA's
   backward; (b) the expert dispatch's backward (``MoeDispatch``: a
   gather and adds in k order, no scatter) at the train cell's dispatch
   (60 experts, top 4, C = 86, d 2048): two calls bit-identical with
   deterministic algorithms off, f32 within ``MOE_DISPATCH_TOL`` of
   autograd through ``torch.gather``, timed beside that scatter-add
   backward and its bytes bound; a full-width MoE layer's bf16 gradient
   twice, bit-identical; (c) the f32 ``Model.loss`` gradient of
   qwen2-moe-a2.7b at full width, 2 layers, 2 x 256, norms and QKV biases
   seeded: every layer's expert ids and keep mask equal card against CPU
   (the CPU side in the child process, after the hybrid's), remat's
   recomputed routing equal to the forward's, then each leaf within
   ``TRAIN_GRAD_TOL`` of its largest magnitude; (d) the train launcher's
   ``train`` at full width and ``MOE_TRAIN_LAYERS`` (5) of 24 layers (the
   cut printed beside full depth's state and the checkpoint one more layer
   would write), 8 x 1024 bf16 batches on f32 masters and f32 AdamW
   moments, 6 steps, the flash counters zeroed just before and read just
   after (2 forward launches a layer and 1 backward call a step), the
   first loss near ln V + s2/2 + 0.01 aux, every loss and grad norm finite, no
   restart, the step's time, tokens/s, the 6 N D share with N =
   ``active_params_count()`` and ``params_count()``, the peak memory, the
   checkpoint written and removed; (e) the step's parts on synchronized
   host clocks (forward, backward, AdamW) and one step under
   ``torch.profiler``: busy share, top kernels, the flash backward's and
   the gather and scatter kernels' shares; (f) ``TrainLoop``'s restart at
   full width, ``MOE_RESTART_LAYERS`` layer, vocab 4096: every final leaf
   ``torch.equal`` to an uninterrupted run's.
19. VLM training, after phase 18's memory is freed: (a) the flash
   backward at llava-next-34b's train cell, (2, 4096, 56 / 8 heads of
   128), GQA 7:1, causal, before the model's state is on the card: through
   ``FlashAttention`` against autograd through the plain version, f32 and
   bf16, two calls bit-identical, timed in bf16 beside its bound, the
   plain version and SDPA's backward; the forward with and without lse
   timed beside its bound, the plain version and SDPA; (c) the f32
   ``Model.loss`` gradient of llava-next-34b at full width, 2 layers,
   vocab 4096, one row of the 2880 patches and 128 tokens, norms seeded,
   card against CPU (the CPU side in the child process, after the MoE's),
   each leaf within ``TRAIN_GRAD_TOL`` of its largest magnitude; (d)
   ``VLM_TRAIN_LAYERS`` (5) of 60 layers at full width (the cut printed
   beside full depth's state and the checkpoint one more layer would
   write) through ``make_train_step`` and ``TrainLoop`` built as the train
   launcher builds them, on ``SpecBatches`` (2 rows of 2880 patches and
   1216 tokens a step, the reference's train-cell layout; the launcher
   feeds no patches), bf16 on f32 masters and f32 AdamW moments, remat a
   layer, 6 steps, the flash counters zeroed just before and read just
   after (2 forward launches a layer and 1 backward call a step), the
   first loss near ln V + s2/2, every loss and grad norm finite, no
   restart, the step's time, positions/s, text tokens/s, the 6 N D share,
   the peak memory, the checkpoint written and removed; (e) the step's
   parts on synchronized host clocks and one step under
   ``torch.profiler``: busy share, top kernels, the flash kernels'
   shares.
20. Audio training, last: whisper-base at full width and depth (6
   encoder and 6 decoder layers, 109,749,248 leaves), on ``SpecBatches``
   at the train cell's layout (``launch/specs.py::input_specs`` at
   ``SHAPES["train_4k"]``: 4096 tokens and 1500 frames a row). (a) The
   flash backward at whisper's three training layouts, 16 rows, 8 / 8
   heads of 64 -- encoder (1500, non-causal), decoder (4096, causal),
   cross (4096 against 1500, non-causal) --, against autograd through the
   plain version, f32 and bf16, bit-identical on repeat, timed beside its
   bound, the plain version and SDPA's backward, and the forward beside
   SDPA; (c) one step's peak at 16 rows picks the run's rows (32 where it
   stays under ``AUD_TRAIN_PEAK_GIB``), then ``make_train_step`` and
   ``TrainLoop`` built as the train launcher builds them (it feeds no
   frames), bf16 on f32 masters, remat a layer, ``AUD_TRAIN_STEPS``
   steps, 36 flash forward launches and 18 backward calls a step (6
   encoder, 6 decoder, 6 cross, each recomputed once), the loss finite
   and falling, the step's time, tokens/s, the 6 N D share, the peak, the
   checkpoint written and removed; (e) a profiled step: busy share, the
   flash kernels' shares; (d) ``TrainLoop``'s restart on ``SpecBatches``:
   every final leaf and every step's loss equal to an uninterrupted run's;
   (b) the f32 gradient at full width, depth and vocabulary, one row of
   512 tokens and 1500 frames, every norm seeded, card against CPU within
   ``TRAIN_GRAD_TOL``.  The CPU sides of phases 17-19 (c) and 20 (b) come
   from the child process through a pipe, each as soon as it is computed,
   and no training checkpoint shares the disk with another: a run may
   keep ``RUN_DISK_GIB`` on disk at once.

Then one ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Needs one CUDA card; without one it exits non-zero and prints no
result.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
# FP32 instructions a second: 132 SMs x 128 lanes x 1.98 GHz, the data
# sheet's f32 rate counting an FMA as one (an unfused multiply or add
# takes the same slot)
F32_SLOTS_PER_S = F32_FLOPS_PER_S / 2
L2_BYTES = 50 * 2**20              # H100 SXM L2 cache, NVIDIA data sheet
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
INT8_OPS = 1979e12                 # H100 SXM dense int8 tensor-core peak
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2  # bf16 outputs, f32 sums in another order
FLASH_F32_TOL = 2e-5               # the reference's kernel-vs-oracle bound
# first-decode logits of the fused and the dense route: the two reduce the
# softmax in another order and round p to bf16 at other places, and the
# difference passes through the bf16 residual stream of the layers above
LOGIT_REL_TOL = 5e-2
# The hybrid path: recurrentgemma-9b at full width and 20 of its 38
# layers (six units and the two tail layers; full depth's 9,572,462,592
# leaves) to keep the whole run within its time budget, random weights
# from seed 0; ReferenceEngine serves 8 seeded prompts of 256-1536 tokens,
# 4 rows x 2048 context (= local_window, so the padded K/V ring never
# meets the reference's ring fault), 32 new tokens each.
HYB_ARCH = "recurrentgemma-9b"
HYB_LAYERS, HYB_PARAMS = 20, 6_036_172_800   # the reference's leaves
HYB_REQUESTS, HYB_PROMPT_LENS = 8, (256, 1536)
HYB_BATCH, HYB_CONTEXT, HYB_NEW = 4, 2048, 32
HYB_LOSS_SEQ = 4096
# f32 decode of token 2101 against prefill(2101): past the 2048 window, so
# the ring wraps.  Both routes run the same f32 operations, but their
# matmuls have other shapes (1 row against 2101: other cuBLAS kernels and
# summation orders, each off by ~sqrt(K) 2^-24 ~ 1e-5 relative at K =
# 12288) and attention reduces in another order (a softmax over the ring
# against the flash kernel's online one).  ~190 products over 38 layers
# add such errors to ~1e-4-1e-3 of the logits' scale; a wrong ring slot or
# a lost recurrent or conv state moves them by a large share of it.
HYB_DECODE_PROMPT = 2100
HYB_DECODE_REL = 2e-3          # x max |logit|
# The MoE path: qwen2-moe-a2.7b at full width (24 layers,
# d_model 2048, 16 / 16 heads of 128, 60 routed experts of width 1408, top
# 4, and 4 shared, vocab 151936) with random weights from seed 0, f32
# masters cast to bf16 once; the serving cell's engine and 16 requests,
# the hybrid cell's ReferenceEngine batch and prompts, one 8 x 1024 loss.
# The int8-PoT engine does not fit at full depth (a 25.72 GiB qtree, a
# 26.67 GiB bf16 dequantized transient a dispatch, quantized from 53.33
# GiB of f32 masters): it runs 8 of the 24 layers (19.32 GiB of masters,
# an 8.96 GiB qtree).  arctic-480b (d_model 7168, 56 / 8 heads of 128,
# 128 experts of width 4864, top 2, a dense residual of width 4864) is
# 14.07 B parameters a layer, 52.41 GiB in f32: one layer of 35, on 8 of
# the serving cell's requests.
# Its serving phase runs 12 of the 24 layers (7,469,033,472 leaves,
# ``moe_leaves``; full depth's are held against MOE_PARAMS) to keep the
# whole run within its time budget: a decode step's host time grows with
# the layers, and deeper layers run the same code.
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_PARAMS = 14_315_735_040        # leaves of the reference's Model.init
MOE_SERVE_LAYERS = 12
MOE_QUANT_LAYERS, MOE_QUANT_PARAMS = 8, 5_186_799_616
MOE_LOSS_BATCH, MOE_LOSS_SEQ = 8, 1024
ARCTIC_ARCH = "arctic-480b"
ARCTIC_LAYERS, ARCTIC_PARAMS = 1, 14_069_945_344
ARCTIC_REQUESTS = 8
# The RWKV6 path: rwkv6-3b at full width (d_model 2560, 40 heads of 64,
# d_ff 8960, vocab 65536) and 16 of its 32 layers (full depth's
# 2,863,434,240 leaves) to keep the whole run within its time budget,
# random weights from seed 0; the hybrid cell's ReferenceEngine batch and
# prompts, one 8 x 1024 loss.  Phase 16 trains it at full depth.
RWKV_ARCH = "rwkv6-3b"
RWKV_LAYERS, RWKV_PARAMS = 16, 1_599_490_560   # the reference's leaves
RWKV_LOSS_BATCH, RWKV_LOSS_SEQ = 8, 1024
# f32 decode of token 2101 against prefill(2101): the WKV state steps the
# same f32 operations either way, but the projections are products of
# other shapes (1 row against 2101: other cuBLAS kernels and summation
# orders, ~sqrt(K) 2^-24 relative at K = 8960) through 32 layers; a lost
# state or token shift moves the logits by a large share of their scale.
RWKV_DECODE_PROMPT = 2100
RWKV_DECODE_REL = 2e-3         # x max |logit|
# The audio path: whisper-base at full width and depth (6 encoder and 6
# decoder layers, d_model 512, 8 / 8 heads of 64, d_ff 2048, vocab 51865),
# random weights from seed 0, frames (B, 1500, 512) from a seeded numpy
# generator.  Whisper's window is 30 s of audio, 1500 frames; its decoder
# context is 448 tokens.  Nothing is cut.
AUD_ARCH = "whisper-base"
AUD_PARAMS = 109_749_248           # leaves of the reference's Model.init
AUD_LOSS_BATCH, AUD_CONTEXT = 16, 448
AUD_SERVE_BATCH, AUD_PROMPT, AUD_NEW = 8, 4, 128
AUD_PROFILE_STEPS = 16
# f32 decode of token 65 against prefill(65): the same f32 operations on
# other shapes (1 row against 65: other cuBLAS kernels and summation
# orders; decode's softmax over the cache against the flash kernel's
# online one) through 6 layers; a lost cross leaf, a roped cross query or
# a wrong cache slot moves the logits by a large share of their scale.
AUD_DECODE_PROMPT = 64
AUD_DECODE_REL = 2e-3          # x max |logit|
# The VLM path: llava-next-34b at full width (d_model 7168, 56 / 8 heads
# of 128, d_ff 20480, vocab 64000), random weights from seed 0, patch
# embeddings (B, 2880, 1024) from a seeded numpy generator (the vision
# tower is a stub in both packages; 2880 patches are LLaVA-NeXT's anyres
# tiling, 5 tiles x 576).  Depth is cut to 8 of 60 layers: a layer is
# 557,856,768 parameters (2.08 GiB in f32), and the reference's init tree
# at 60 layers is 34,396,257,280 parameters, 128.1 GiB in f32.  16 layers
# (9,850,559,488, 36.70 GiB of f32 masters) fit beside the f32 check, the
# int8-PoT tree and its transients; 8 (5,387,705,344, 20.07 GiB) keep the
# whole run within its time budget.  Deeper layers run the same code.
VLM_ARCH = "llava-next-34b"
VLM_LAYERS, VLM_PARAMS = 8, 5_387_705_344   # the reference's leaves
VLM_LOSS_BATCH, VLM_LOSS_SEQ = 2, 1024
VLM_SERVE_BATCH, VLM_PROMPT, VLM_NEW, VLM_CONTEXT = 4, 16, 64, 3072
VLM_PROFILE_STEPS = 16
# f32 decode of token 65 after the patches and 64 tokens against a
# prefill of the patches and 65: the same f32 operations on other shapes
# (1 row against 2945: other cuBLAS kernels and summation orders, ~sqrt(K)
# 2^-24 relative at K = 20480; decode's softmax over the cache against
# the flash kernel's online one) through the layers; a wrong position,
# a patch left out of the cache or a lost K/V row moves the logits by a
# large share of their scale.
VLM_DECODE_PROMPT = 64
VLM_DECODE_REL = 2e-3          # x max |logit|
# The dense path: the reference's last three dense configs at full width
# and depth, random weights from seed 0, each alone on the card and freed
# before the next: qwen2.5-3b (36 layers, d_model 2048, 16 / 2 heads of
# 128, d_ff 11008, vocab 151936, QKV bias, rope theta 1e6),
# internlm2-1.8b (24 layers, 2048, 16 / 8 heads, d_ff 8192, vocab 92544)
# and qwen1.5-4b (40 layers, 2560, 20 / 20 heads, d_ff 6912, vocab 151936,
# QKV bias).  The serving cell's engine and 16 requests, the hybrid
# cell's ReferenceEngine batch and prompts, one 8 x 1024 loss and the
# serve launcher (at full depth).  In the process the configs run half
# their depth (DENSE_SERVE_LAYERS; ``dense_leaves``, full depth's held
# against DENSE_PARAMS) to keep the run within its time budget, as the
# MoE's serving does.
DENSE_ARCHS = ("qwen2.5-3b", "internlm2-1.8b", "qwen1.5-4b")
DENSE_PARAMS = {"qwen2.5-3b": 3_397_103_616,   # the reference's leaves
                "internlm2-1.8b": 1_889_110_016,
                "qwen1.5-4b": 3_950_369_280}
DENSE_LOSS_BATCH, DENSE_LOSS_SEQ = 8, 1024
DENSE_SERVE_LAYERS = {"qwen2.5-3b": 18, "internlm2-1.8b": 12,
                      "qwen1.5-4b": 20}
DENSE_PROFILE_STEPS = 8
DENSE_LAUNCHER = ["--quantized", "--kv-block-size", "32", "--kv-gather",
                  "cuda", "--decode-kernel", "fused", "--batch", "8",
                  "--context", "1024", "--prefill-chunk", "128",
                  "--prefill-batch", "4", "--requests", "16", "--prompt-len",
                  "256", "--max-new", "32"]
# The training path: qwen2-0.5b at full width and depth through the train
# launcher, bf16 activations on f32 masters and f32 AdamW moments, remat a
# layer; one 8 x 1024 TokenPipeline batch a step.  630,167,424 f32 leaves
# (params_count() 494,005,120, which counts V x d once, the 6 N D
# convention's N).
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_LEAVES = 630_167_424
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 6
# (b): the f32 gradient at full width and 2 layers, B = 2, S = 256, card
# against CPU: each leaf within TRAIN_GRAD_TOL of its largest magnitude
# (cuBLAS and the CPU's BLAS add in other orders; TF32 is off).
TRAIN_GRAD_TOL = 1e-4
# (d): the restart check at full width, 2 layers, vocab 4096, 4 x 256
# batches, 8 steps, a checkpoint every 4, a failure injected at step 6.
RESTART_VOCAB, RESTART_STEPS, RESTART_FAIL = 4096, 8, 6
# The hybrid's training (phase 17): recurrentgemma-9b at full width and
# HYB_TRAIN_LAYERS of its 38 layers -- a scanned unit and the config's two
# unrolled tail layers (n_layers % 3 == 2, as 38 = 12 x 3 + 2) -- through
# the train launcher's code: 3,089,264,640 f32 leaves, 46.03 GiB of
# masters, gradients and AdamW moments, a 34.53 GiB checkpoint (142.6 GiB
# of state at full depth; 8 layers, 54.8 GiB, ran until the run needed
# the time).  Two TokenPipeline rows of 4096 tokens a step, past the 2048
# window.
HYB_TRAIN_LAYERS = 5
HYB_TRAIN_BATCH, HYB_TRAIN_SEQ = 2, 4096
# (c): the f32 gradient at full width, one unit and one tail layer, vocab
# 4096, one row of 2304 positions (the window bites on 256 rows), card
# against CPU within TRAIN_GRAD_TOL; these leaves seeded (the reference's
# init zeros the norms and sets lam to 3 everywhere)
HYB_GRAD_LAYERS, HYB_GRAD_VOCAB, HYB_GRAD_SEQ = 4, 4096, 2304
# its CPU side took 337.7 s on the H100 host's 8 cores, so it runs in a
# child process (this flag, these threads) beside phases 2-16, and phase
# 18 (c)'s after it in the same child
CPU_REFERENCE_FLAG = "--cpu-reference"
HYB_CPU_THREADS = 4
HYB_SEEDED = ("ln", "ln1", "ln2", "final_norm", "lam", "gate_i", "gate_r",
              "conv_k")
# The disk a run of this script may fill at once on the H100 machines it
# runs on.  A training checkpoint is 12 B a leaf (f32 masters and two f32
# AdamW moments), so a training cell's depth is cut until its checkpoint,
# written and removed while nothing else of the run is on disk, fits.
RUN_DISK_GIB = 45
# The MoE's training (phase 18): qwen2-moe-a2.7b at full width (d 2048, 16
# / 16 heads of 128, 60 routed experts of width 1408, top 4, 4 shared,
# vocab 151936, QKV bias) and MOE_TRAIN_LAYERS of its 24 layers through the
# train launcher's code, the train cell's batches: 3,475,124,224 f32
# leaves, 51.78 GiB of masters, gradients and AdamW moments, a 38.84 GiB
# checkpoint (213.3 GiB of state at full depth, more than the card; 6
# layers fit the card, 60.28 GiB, but their 45.21 GiB checkpoint not the
# disk).
MOE_TRAIN_LAYERS = 5
# (c): the f32 gradient at full width, 2 layers, 2 x 256, card against CPU
# (in the child process, after the hybrid's) within TRAIN_GRAD_TOL, after
# every layer's expert ids and keep mask were found equal; these leaves
# seeded (the reference's init zeros them)
MOE_GRAD_LAYERS, MOE_GRAD_BATCH, MOE_GRAD_SEQ = 2, 2, 256
MOE_SEEDED = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")
# (f): the restart at full width and this many layers (at 2 it took 50-77
# s of the run's budget; one layer runs the same loop and checkpoints)
MOE_RESTART_LAYERS = 1
# (b): the dispatch's backward against autograd through torch.gather in
# f32, within this of the largest magnitude (sums of K = 4 terms in
# another order)
MOE_DISPATCH_TOL = 1e-6
# The VLM's training (phase 19): llava-next-34b at full width (d 7168, 56
# / 8 heads of 128, d_ff 20480, vocab 64000, 2880 patches of 1024) and
# VLM_TRAIN_LAYERS of its 60 layers through the port's make_train_step
# and TrainLoop, built as launch.train.train builds them (its command line
# feeds no patches, as the reference's does not).  A layer is 557,856,768
# f32 leaves; the embedding, the head, vision_proj (1024 x 7168) and the
# final norm 924,851,200 more (``vlm_leaves``).  At 6 layers that is
# 4,271,991,808 leaves, 63.66 GiB of masters, gradients and AdamW moments
# at 16 B a leaf (5 layers 55.34 GiB, 7 layers 71.97 GiB, which leaves
# under 8 GiB for activations and a layer's bf16 casts; full depth's
# 34,396,257,280 leaves 512.5 GiB).  Two rows a step, laid out as the
# reference's train cell (``launch/specs.py::input_specs`` at
# ``SHAPES["train_4k"]``): 2880 patches, then 1216 tokens.  6 layers fit
# the card (67.0-67.1 GiB at the peak) but their 47.74 GiB checkpoint not
# ``RUN_DISK_GIB``, so the cell runs 5: 3,714,135,040 leaves, 55.34 GiB of
# state, a 41.51 GiB checkpoint.
VLM_TRAIN_LAYERS = 5
VLM_FULL_LEAVES = 34_396_257_280
VLM_TRAIN_BATCH, VLM_TRAIN_SEQ = 2, 4096
# (c): the f32 gradient at full width, 2 layers, vocab 4096, one row of the
# 2880 patches and 128 tokens (1,181,780,992 leaves, 4.40 GiB a copy), card
# against CPU (in the child process, after the MoE's) within
# TRAIN_GRAD_TOL; these leaves seeded (the reference's init zeros them)
VLM_GRAD_LAYERS, VLM_GRAD_VOCAB, VLM_GRAD_TOKENS = 2, 4096, 128
VLM_SEEDED = ("ln1", "ln2", "final_norm")
# The audio family's training (phase 20): whisper-base at full width and
# depth (6 encoder and 6 decoder layers, d 512, 8 / 8 heads of 64, d_ff
# 2048, vocab 51865): AUD_PARAMS f32 leaves (``audio_leaves``), 1.64 GiB
# of masters, gradients and AdamW moments, a 1.23 GiB checkpoint.  Neither
# train launcher feeds frames, so it trains through make_train_step and
# TrainLoop built as launch.train.train builds them, on ``SpecBatches``
# at the train cell's layout (``SHAPES["train_4k"]``: 4096 tokens and
# 1500 frames a row).  AUD_TRAIN_BATCH rows a step, raised to
# AUD_TRAIN_BATCH_MAX where one step's peak at AUD_TRAIN_BATCH stays under
# AUD_TRAIN_PEAK_GIB (the loss's saved f32 logits, 4 x 51865 B a
# position, set the peak: 12.7 GiB at 16 rows).  AUD_TRAIN_STEPS steps:
# the schedule warms up over 20, so step 0 runs at lr 0 and the loss has
# a dozen steps to fall.
AUD_TRAIN_BATCH, AUD_TRAIN_BATCH_MAX, AUD_TRAIN_PEAK_GIB = 16, 32, 45
AUD_TRAIN_STEPS = 12
# (b): the f32 gradient at full width, depth and vocabulary, one row of
# AUD_GRAD_TOKENS tokens and the 1500 frames, card against CPU (in the
# child process, after the VLM's) within TRAIN_GRAD_TOL; every norm
# seeded (the reference's init zeros them, which would hide a swapped
# norm)
AUD_GRAD_TOKENS = 512
AUD_SEEDED = ("ln1", "ln2", "ln_x", "enc_norm", "final_norm")
# (d): the restart at full width and depth, AUD_RESTART_BATCH rows of the
# train cell's layout a step, phase 15 (d)'s steps and failure
AUD_RESTART_BATCH = 2
# (b): the linear scan's backward against autograd through the plain scan,
# each gradient within this of its largest magnitude
SCAN_BWD_TOL = 1e-5
# wkv6's y against the plain version: the kernel adds sum_i r_i s_ij with
# FMAs over each lane's rows, then across lanes, then v_j a_t, the plain
# einsum as a batched product does; each is within a few ulps of the
# row's larger terms.
WKV_Y_TOL = 2e-5               # x the (b, t, h) row's max |y|
# wkv6's backward against its plain version: each gradient within
# WKV_BWD_TOL of its largest magnitude (f32 sums of hd terms in another
# order, and G's update fused; the states are the same bits).
WKV_BWD_TOL = 2e-5
# The int8 power-of-two matmul: held bit for bit at the reference tests'
# shapes, the kernel lane's (benchmarks/run.py) and M = 1; then at
# qwen2-0.5b's widths at M = 8 (a decode step of 8 slots) and M = 512 (a
# 128 x 4 prefill chunk).  (M, K, N).
QM_SHAPES = {"reference tests": [(256, 512, 256), (128, 1024, 128),
                                 (8, 512, 256), (300, 700, 130),
                                 (1024, 512, 512)],
             "kernel lane": [(256, 512, 256), (512, 1024, 512)],
             "M = 1": [(1, 896, 4864), (1, 700, 130)]}
QM_M = (8, 512)
# the widths where the mma route (the first version) is timed beside the
# TMA route
QM_MMA_TIMED = ((512, 896, 4864), (8, 4864, 896))
# SIMURG output of the paper phase, one directory per backend (git-ignored)
SIMURG_OUT = os.path.join(HERE, "out", "chip_smoke")
CARD = "card not read yet"     # nvidia-smi name and power limit, set in main


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_events(prof):
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(events):
    """Union of the device events' intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def report_profile(prof, wall_us, label, top, digits=2):
    """Print the device busy share of a profiled window and its ``top``
    kernels by device time; fails if the device recorded nothing."""
    evs = device_events(prof)
    busy = busy_us(evs)
    check(busy > 0, "profiler window recorded no device time")
    by_name = {}
    for e in evs:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
    print(f"profile ({label}): wall {wall_us/1e3:.3f} ms, device busy "
          f"{busy/1e3:.3f} ms ({100*busy/wall_us:.{digits}f} %), idle "
          f"{100*(1-busy/wall_us):.{digits}f} %")
    for name, (t, n) in sorted(by_name.items(), key=lambda x: -x[1][0])[:top]:
        print(f"  {t/1e3:9.3f} ms {n:6d} x  {name[:90]}")
    return busy, by_name


def time_calls(torch, fn, arg_sets, reps):
    """Milliseconds per call, both from CUDA events: (replays of a CUDA
    graph that holds one call per entry of ``arg_sets`` -- the device's
    time, without the host's launch gaps; the same calls made eagerly from
    Python -- what a caller pays per call).  ``arg_sets`` cycle through
    every layer's pool, together larger than the 50 MB L2 cache, so each
    call finds its pool cold, as the serving path does."""
    for a in arg_sets[:2]:                      # build, load, allocator
        fn(*a)
    torch.cuda.synchronize()
    n = reps * len(arg_sets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for a in arg_sets:
            fn(*a)
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / n
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*arg_sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for a in arg_sets:
            fn(*a)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, eager_ms


def ptxas_lines(log):
    """(kernel, line) for each register and spill line of a ptxas -v log;
    the kernel is its mangled name cut to the template arguments
    (``flash_attention_kernelIfLi256EE``: float, D = 256)."""
    fn = "?"
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            k = re.search(r"[a-z][a-z_]*_kernel(?:I\w*?EE)?", m.group(1))
            fn = k.group(0) if k else m.group(1)[:60]
        elif "registers" in line or "spill" in line:
            yield fn, line.strip()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_phase(torch):
    """Each kernel against its plain version at the serving path's shapes,
    and their times."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_plain,
                                                     splits, workspace_bytes)
    from repro_torch.kernels.paged_gather import (ROUTES as GATHER_ROUTES,
                                                  paged_gather_kernel,
                                                  paged_gather_pair_kernel,
                                                  paged_gather_plain)
    rng = np.random.default_rng(0)
    L, B, Hq, Hkv, D, bs, C = 24, 8, 14, 2, 64, 32, 1024
    nb = C // bs
    NB = B * nb
    dt = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    kpool = torch.randn((L, NB, bs, Hkv, D), generator=gen, device="cuda",
                        dtype=dt)
    vpool = torch.randn((L, NB, bs, Hkv, D), generator=gen, device="cuda",
                        dtype=dt)
    q = torch.randn((B, 1, Hq, D), generator=gen, device="cuda", dtype=dt)
    lens = np.array([1, 33, 100, 257, 511, 640, 900, 1024], np.int32)
    tbl = rng.permutation(NB).reshape(B, nb).astype(np.int32)
    for b in range(B):
        tbl[b, -(-lens[b] // bs):] = NB                 # not granted: sentinel
    table = torch.from_numpy(tbl).cuda()
    clen = torch.from_numpy(lens).cuda()
    tbl_c = torch.clamp(table, max=NB - 1)
    results = []

    # --- paged gather, at the prefill dispatch's shape: 4 slot rows, the
    # int64 table the model hoists once a dispatch, sentinels unclamped
    # (the kernel maps them); the path gathers K and V as one pair launch
    P = 4
    g_tbl = table[:P].long()
    g_cl = tbl_c[:P].long()
    for route in GATHER_ROUTES:
        n0 = paged_gather_pair_kernel.launches
        s0 = paged_gather_kernel.launches
        gk, gv = paged_gather_pair_kernel(kpool[0], vpool[0], g_tbl,
                                          route=route)
        one = paged_gather_kernel(kpool[0], g_tbl, route=route)
        torch.cuda.synchronize()
        check(paged_gather_pair_kernel.launches == n0 + 1
              and paged_gather_kernel.launches == s0 + 1,
              "a gather call did not count one launch")
        check(torch.equal(gk, paged_gather_plain(kpool[0], g_cl))
              and torch.equal(gv, paged_gather_plain(vpool[0], g_cl))
              and torch.equal(one, gk),
              f"paged_gather kernel ({route}) != plain version")
    # the model's helper launches the pair kernel and nothing else: no
    # cast, no clamp
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.nn.layers import _gather_kv_rows
    _gather_kv_rows(kpool[1], vpool[1], g_tbl, engine="cuda")
    torch.cuda.synchronize()
    for _ in range(3):      # a window whose trace recorded nothing again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _gather_kv_rows(kpool[1], vpool[1], g_tbl, engine="cuda")
            torch.cuda.synchronize()
        names = [e.name for e in device_events(prof)]
        if names:
            break
        print("paged_gather: the profiler recorded no device event; "
              "profiling again")
    check(len(names) == 1 and "gather_bulk_kernel" in names[0],
          f"the K+V gather launched {names}, not one bulk pair kernel")
    print(f"paged_gather: bit-exact on both routes (pair and one leaf); the "
          f"model's K+V gather is one device kernel: {names[0]}")
    block_bytes = bs * Hkv * D * 2
    uniq = int(torch.unique(g_cl).numel())
    one_bytes = uniq * block_bytes + P * nb * block_bytes + P * nb * 8
    pair_bytes = 2 * (uniq * block_bytes + P * nb * block_bytes) + P * nb * 8
    flat = g_cl.reshape(-1)
    one_sets = [(pool[i], g_tbl) for pool in (kpool, vpool) for i in range(L)]
    pair_sets = [(kpool[i], vpool[i], g_tbl) for i in range(L)]
    ms, eager_ms = time_calls(torch, paged_gather_pair_kernel, pair_sets, 10)
    vec_ms, _ = time_calls(torch, lambda k, v, t: paged_gather_pair_kernel(
        k, v, t, route="vector"), pair_sets, 10)
    plain_ms, _ = time_calls(torch, lambda k, v, t: (
        paged_gather_plain(k, g_cl), paged_gather_plain(v, g_cl)),
        pair_sets, 5)
    lib_ms, _ = time_calls(torch, lambda k, v, t: (
        k.index_select(0, flat), v.index_select(0, flat)), pair_sets, 10)
    one_ms, one_eager = time_calls(torch, paged_gather_kernel, one_sets, 10)
    one_plain, _ = time_calls(torch, lambda leaf, t: paged_gather_plain(
        leaf, g_cl), one_sets, 5)
    one_lib, _ = time_calls(torch, lambda leaf, t: leaf.index_select(0, flat),
                            one_sets, 10)
    ms2, _ = time_calls(torch, paged_gather_pair_kernel, pair_sets, 10)
    one = {"ms": one_ms, "eager_ms": one_eager, "plain_ms": one_plain,
           "bound_ms": one_bytes / HBM_BYTES_PER_S * 1e3,
           "library_ms": one_lib}
    print(f"paged_gather one leaf: {one_ms*1e3:.2f} us ({one_eager*1e3:.2f} "
          f"us eager), plain {one_plain*1e3:.2f} us, bound "
          f"{one['bound_ms']*1e3:.3f} us, index_select {one_lib*1e3:.2f} us; "
          f"pair {ms*1e3:.2f} / {ms2*1e3:.2f} us, on the vector route "
          f"{vec_ms*1e3:.2f} us [{CARD}]")
    results.append({
        "name": "paged_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_gather.cu",
        "replaces": "src/repro/kernels/paged_gather.py:34",
        "max_abs_err": 0.0, "ms": ms, "ms_repeat": ms2, "eager_ms": eager_ms,
        "vector_route_ms": vec_ms, "one_leaf": one,
        "plain_ms": plain_ms, "bound_ms": pair_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": lib_ms,
        "library": "torch.index_select on each leaf (two calls: no one "
                   "PyTorch call gathers two tensors)",
        "shape": f"pools ({NB},{bs},{Hkv},{D}) bf16, K and V, table "
                 f"({P},{nb}) int64 with sentinels: one prefill dispatch's "
                 f"K+V gather (pair kernel, bulk route)"})

    # --- split-KV paged attention, at the decode step's shape
    S, c = splits(B, Hkv, nb)
    ws_bytes = workspace_bytes(B, Hq, D, S)
    print(f"paged_attention split rule: S = {S} splits of {c} blocks, grid "
          f"{B * Hkv} x {S} = {B * Hkv * S} blocks, workspace {ws_bytes} "
          f"bytes")
    for window in (0, 200):
        n0 = paged_attention_kernel.launches
        c0 = paged_attention_kernel.combine_launches
        got = ops.paged_attention(q, kpool[0], vpool[0], table, clen,
                                  window=window)
        check(paged_attention_kernel.launches == n0 + 1
              and paged_attention_kernel.combine_launches == c0 + (S > 1),
              "ops.paged_attention did not launch the kernel (and its "
              "combine) once")
        want = paged_attention_plain(q, kpool[0], vpool[0], table, clen,
                                     window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(bool(torch.isfinite(got).all()), "attention output not finite")
        check(torch.allclose(got.float(), want.float(), atol=ATTN_ATOL,
                             rtol=ATTN_RTOL),
              f"paged_attention kernel vs plain: max abs err {err} "
              f"(window {window})")
        print(f"paged_attention window={window}: max abs err {err:.3e} "
              f"(atol {ATTN_ATOL}, rtol {ATTN_RTOL})")
        if window == 0:
            attn_err = err
    sets = [(q, kpool[i], vpool[i], tbl_c, clen) for i in range(L)]
    ms, eager_ms = time_calls(torch, paged_attention_kernel, sets, 10)
    w200_ms, _ = time_calls(torch, lambda *a: paged_attention_kernel(
        *a, window=200), sets, 10)
    s1_ms, _ = time_calls(torch, lambda *a: paged_attention_kernel(
        *a, n_splits=1), sets, 10)
    plain_ms, _ = time_calls(torch, paged_attention_plain, sets, 1)
    tokens = int(lens.sum())
    a_bytes = (tokens * Hkv * D * 2 * 2 + 2 * q.numel() * 2
               + table.numel() * 4 + clen.numel() * 4)
    a_flops = 4 * Hq * D * tokens
    bound = max(a_bytes / HBM_BYTES_PER_S, a_flops / BF16_FLOPS) * 1e3
    print(f"paged_attention times: window 200 {w200_ms*1e3:.2f} us, one "
          f"split (S = 1) {s1_ms*1e3:.2f} us, the rule's S = {S} "
          f"{ms*1e3:.2f} us [{CARD}]")
    results.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:122",
        "max_abs_err": attn_err, "ms": ms, "eager_ms": eager_ms,
        "window200_ms": w200_ms, "one_split_ms": s1_ms,
        "splits": [S, c], "workspace_bytes": ws_bytes,
        "compute": "bf16 mma.sync m16n8k16, two computing warps a split; "
                   "a second kernel (programmatic dependent launch) "
                   "combines the splits",
        "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": "bytes" if a_bytes / HBM_BYTES_PER_S
        >= a_flops / BF16_FLOPS else "operations",
        "library_ms": None,
        "library": "none: no single PyTorch call computes attention "
                   "through a block table",
        "shape": f"q ({B},1,{Hq},{D}) bf16, pools ({NB},{bs},{Hkv},{D}), "
                 f"lengths {lens.tolist()}, window 0: one decode step's "
                 f"layer"})
    for r in results:
        print(f"{r['name']}: {r['ms']*1e3:.2f} us on the card "
              f"({r['eager_ms']*1e3:.2f} us per eager call), plain "
              f"{r['plain_ms']*1e3:.2f} us, bound {r['bound_ms']*1e3:.2f} us"
              + (f", library {r['library_ms']*1e3:.2f} us"
                 if r["library_ms"] is not None else ""))
    return results


def tiny_reference_phase(torch):
    """A tiny f32 model served on the card through both kernels gives the
    CPU engine's greedy tokens (the plain versions there)."""
    import dataclasses
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2,
                              vocab=64, dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 64, n).astype(np.int32) for n in (3, 17, 9, 22)]
    outs = []
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, eos_id=-1, max_batch=3, max_context=32,
                          prefill_chunk=5, prefill_batch=2, kv_block_size=8,
                          kv_gather="cuda", decode_kernel="fused", device=dev)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs.append([r.out_tokens for r in reqs])
    check(outs[0] == outs[1], f"tiny model: card {outs[1]} != cpu {outs[0]}")
    print(f"tiny f32 model: card tokens == CPU tokens ({outs[1][0]} ...)")


def serving_spec(vocab):
    """The serving cell's 16 requests: seeded prompts of 64-700 tokens, 32
    new tokens each."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 701, 16)
    return [(rng.integers(0, vocab, n).astype(np.int32), 32) for n in lens]


def serve(torch, cfg, params, reqs_spec, record_first, **kw):
    """A fresh ``ServeEngine`` on the card run over ``reqs_spec``; returns
    (engine, requests, summary, wall s, first decode logits or None)."""
    from repro_torch.runtime.serve import ServeEngine
    eng = ServeEngine(cfg, params, eos_id=-1, device="cuda", **kw)
    return (eng,) + run_engine(torch, eng, reqs_spec, record_first)


def run_engine(torch, eng, reqs_spec, record_first):
    """Serve ``reqs_spec`` [(prompt, max_new)] on ``eng``; returns
    (requests, summary, wall s, the first decode dispatch's logits when
    ``record_first``)."""
    from repro_torch.runtime.serve import Request, summarize
    first = {}
    dispatch = eng._decode

    def recording(toks, pos):
        lg, cache = dispatch(toks, pos)
        if record_first and "logits" not in first:
            first["logits"] = lg.float().clone()
        return lg, cache
    eng._decode = recording
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=n)
            for i, (p, n) in enumerate(reqs_spec)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng._decode = dispatch
    return reqs, summarize(reqs, eng), wall, first.get("logits")


def serving_phase(torch):
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_gather import (paged_gather_kernel,
                                                  paged_gather_pair_kernel)
    from repro_torch.nn import Model, get_config
    cfg = get_config("qwen2-0.5b")                         # full width
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(v) for v in tree.values())
        return tree.numel()
    print(f"qwen2-0.5b params: {numel(params)/1e9:.3f} B (f32), init "
          f"{time.perf_counter()-t0:.2f} s")
    spec = serving_spec(cfg.vocab)
    kw = dict(max_batch=8, max_context=1024, kv_block_size=32,
              prefill_chunk=128, prefill_batch=4, quantized=True,
              quant_bits=8)
    main = dict(kw, kv_gather="cuda", decode_kernel="fused")
    serve(torch, cfg, params, spec[:2], False, **main)      # warm-up
    torch.cuda.reset_peak_memory_stats()
    paged_gather_kernel.launches = 0
    paged_gather_pair_kernel.launches = 0
    paged_attention_kernel.launches = 0
    paged_attention_kernel.combine_launches = 0
    eng, reqs, summ, wall, lg_fused = serve(torch, cfg, params, spec, True,
                                            **main)
    pairs = paged_gather_pair_kernel.launches
    launches = {"paged_gather": paged_gather_kernel.launches + pairs,
                "paged_attention": paged_attention_kernel.launches}
    check(pairs > 0 and paged_gather_kernel.launches == 0,
          f"the K+V gathers did not all go as pairs: {pairs} pair and "
          f"{paged_gather_kernel.launches} one-leaf launches")
    combines = paged_attention_kernel.combine_launches
    peak = torch.cuda.max_memory_allocated()
    check(all(r.status == "done" and len(r.out_tokens) == 32 for r in reqs),
          "a request did not finish with 32 tokens")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(lg_fused is not None and lg_fused.shape == (8, 1, cfg.vocab)
          and bool(torch.isfinite(lg_fused).all()),
          "first decode logits missing, misshapen or not finite")
    toks = np.array([r.out_tokens for r in reqs])
    check(toks.min() >= 0 and toks.max() < cfg.vocab, "token out of range")
    s = eng.stats
    print(f"serving (fused, cuda gather, int8-PoT): {len(reqs)} requests in "
          f"{wall:.3f} s; prefill {s['prefill_tokens']} tok in "
          f"{s['prefill_s']:.3f} s ({s['prefill_dispatches']} dispatches); "
          f"decode {s['decode_tokens']} tok in {s['decode_s']:.3f} s "
          f"({s['decode_steps']} steps, {summ['decode_tok_s']:.1f} tok/s)")
    print(f"latency: first token p50 {summ['p50_first_token_s']*1e3:.1f} ms "
          f"p99 {summ['p99_first_token_s']*1e3:.1f} ms; total p50 "
          f"{summ['p50_total_s']*1e3:.1f} ms p99 "
          f"{summ['p99_total_s']*1e3:.1f} ms; peak memory "
          f"{peak/2**30:.3f} GiB; resident weights "
          f"{eng.quant_bytes/2**30:.3f} GiB")
    print(f"launches on the main path: {launches} (paged_gather: {pairs} "
          f"K+V pairs, {s['prefill_dispatches']} prefill dispatches x "
          f"{cfg.n_layers} layers); paged_attention's combine kernel "
          f"{combines}")
    check(pairs == s["prefill_dispatches"] * cfg.n_layers,
          "not one K+V gather a layer and prefill dispatch")
    check(combines == launches["paged_attention"],
          "a decode step's attention ran without its split")
    _, ref_reqs, ref_summ, ref_wall, lg_dense = serve(
        torch, cfg, params, spec, True,
        **dict(kw, kv_gather="take", decode_kernel="dense"))
    same = np.mean([a == b for r, q in zip(reqs, ref_reqs)
                    for a, b in zip(r.out_tokens, q.out_tokens)])
    diff = (lg_fused - lg_dense).abs().max().item()
    scale = lg_dense.abs().max().item()
    print(f"take/dense route: {ref_wall:.3f} s, decode "
          f"{ref_summ['decode_tok_s']:.1f} tok/s; identical greedy tokens "
          f"{same*100:.2f} %; first decode logits max abs diff {diff:.4e} "
          f"(max |logit| {scale:.4e}, tolerance {LOGIT_REL_TOL} x max)")
    check(diff <= LOGIT_REL_TOL * scale,
          "fused and dense first-decode logits disagree")
    # the gather alone: the cuda K+V pair against index_select, both on the
    # dense route (prefill and decode gather), must change nothing
    _, cd_reqs, cd_summ, cd_wall, lg_cd = serve(
        torch, cfg, params, spec, True,
        **dict(kw, kv_gather="cuda", decode_kernel="dense"))
    check(all(r.out_tokens == q.out_tokens for r, q in zip(cd_reqs, ref_reqs))
          and torch.equal(lg_cd, lg_dense),
          "the cuda gather changed the dense route's tokens or logits")
    print(f"cuda/dense route: {cd_wall:.3f} s, decode "
          f"{cd_summ['decode_tok_s']:.1f} tok/s; greedy tokens and first "
          f"decode logits identical to take/dense")
    return launches, combines, eng, spec, cfg


def profile_phase(torch, eng, spec):
    """Device busy share and top kernels over a few engine steps of a
    fresh batch on the main engine (prefill and decode mixed)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import Request
    for i, (p, _) in enumerate(spec[:8]):
        eng.submit(Request(rid=100 + i, prompt=p.copy(), max_new_tokens=16))
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(6):
            eng.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name = report_profile(prof, wall_us, "6 engine steps", 10)
    t, n = (sum(v[i] for k, v in by_name.items() if "paged_attention" in k)
            for i in (0, 1))
    print(f"paged_attention in the window: {t/1e3:.3f} ms of {busy/1e3:.3f} "
          f"ms busy ({100*t/busy:.2f} %), {n} launches [{CARD}]")
    t, n = (sum(v[i] for k, v in by_name.items() if "gather_bulk" in k)
            for i in (0, 1))
    c = sum(v[1] for k, v in by_name.items() if "clamp" in k)
    print(f"paged_gather in the window: {t/1e3:.3f} ms, {n} K+V pair "
          f"launches; clamp kernels {c} (paged_attention's wrapper and the "
          f"model's; the gather launches none, kernel phase)")
    while eng.queue or eng.slots:
        eng.step()


def _csd_inputs(torch, rng, x_shape, w_shape, depth):
    """8-bit activations and CSD planes of random integer weights whose
    digits reach ``depth`` (stacked per network for a 3-d ``x_shape``)."""
    from repro_torch.kernels import ops
    x = torch.from_numpy(rng.integers(-128, 128, x_shape).astype(np.int32))
    hi = (1 << depth) // 3 + 1
    nets = x_shape[0] if len(x_shape) == 3 else 1
    ws = [rng.integers(-hi, hi + 1, w_shape) for _ in range(nets)]
    if len(x_shape) == 3:
        planes = ops.csd_expand_stack(ws)
    else:
        planes = ops.csd_expand(ws[0], depth=depth)
    return x.cuda(), torch.from_numpy(planes).cuda()


def csd_kernel_phase(torch):
    """Both CSD digit-plane kernels against their plain versions on the
    card, bit for bit, at the paper path's shapes and odd ones
    (``csd_qsweep`` on both of its routes); their times beside the bound
    and the plain and library times, ``csd_qsweep``'s on both routes."""
    from repro_torch.kernels.csd_matvec import (MATVEC_ROUTES, ROUTES,
                                                csd_matvec_kernel,
                                                csd_matvec_plain,
                                                csd_qsweep_kernel,
                                                csd_qsweep_plain, route,
                                                route_matvec)
    rng = np.random.default_rng(0)
    rows = 128 * 2248                  # one polish call: 128 candidates
    cases = [("csd_matvec", (rows, 10), (10, 10), d) for d in (1, 8, 16)]
    cases += [("csd_matvec", (m, 10), (10, 10), 8) for m in (1, 127, 1001)]
    cases += [("csd_matvec", (1001, 37), (37, 45), 9),
              ("csd_matvec", (130, 16), (16, 10), 40),
              ("csd_matvec", (3, 200), (200, 70), 30)]
    cases += [("csd_qsweep", (4, 2248, k), (k, n), 8)
              for k, n in ((16, 16), (16, 10), (10, 10))]
    cases += [("csd_qsweep", (3, 77, 19), (19, 5), 11)]
    fns = {"csd_matvec": (csd_matvec_kernel, csd_matvec_plain),
           "csd_qsweep": (csd_qsweep_kernel, csd_qsweep_plain)}
    timed = {"csd_matvec": ((rows, 10), (10, 10), 8),
             "csd_qsweep": ((4, 2248, 16), (16, 16), 8)}
    results = {}
    for name, xs, ws, depth in cases:
        kernel, plain = fns[name]
        x, planes = _csd_inputs(torch, rng, xs, ws, depth)
        want = plain(x, planes)
        rule = route(*ws) if name == "csd_qsweep" else route_matvec(*ws)
        if name == "csd_qsweep":
            hows = ROUTES
        else:
            hows = MATVEC_ROUTES if rule == "streaming" else (rule,)
        for how in hows:
            got = kernel(x, planes, how=how)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"{name} kernel ({how}) != plain version "
                  f"at x {xs}, planes {tuple(planes.shape)}")
        print(f"{name}: bit-exact against the plain version at x {xs}, "
              f"planes {tuple(planes.shape)} on the routes {hows} (the "
              f"rule's: {rule})")
        if timed[name] != (xs, ws, depth):
            continue
        # distinct inputs per call, together at least twice the 50 MB L2,
        # so each call reads its inputs from HBM, as the bound assumes
        M, K = xs[-2], xs[-1]
        Q = xs[0] if len(xs) == 3 else 1
        D, N = planes.shape[-3], planes.shape[-1]
        nbytes = Q * (M * K * 4 + D * K * N + M * N * 4)
        sets = [_csd_inputs(torch, rng, xs, ws, depth)
                for _ in range(max(6, -(-2 * L2_BYTES // nbytes)))]
        pw = (torch.arange(planes.shape[-3], device="cuda", dtype=torch.float64)
              .exp2().reshape(-1, 1, 1))
        lib_sets = [(a.double(), (p.double() * pw).sum(dim=-3))
                    for a, p in sets]
        # the kernel and the library call in turns: library, kernel,
        # kernel, library
        lib_a, _ = time_calls(torch, torch.matmul, lib_sets, 20)
        ms, eager_ms = time_calls(torch, kernel, sets, 20)
        how = route(K, N) if name == "csd_qsweep" else route_matvec(K, N)
        other = [r for r in (ROUTES if name == "csd_qsweep"
                             else MATVEC_ROUTES) if r != how][0]
        o_ms, _ = time_calls(torch, lambda a, p: kernel(a, p, how=other),
                             sets, 20)
        ms2, _ = time_calls(torch, kernel, sets, 20)
        extra = {"rule": how, "ms_repeat": ms2, "other": other,
                 "other_ms": o_ms}
        lib_b, _ = time_calls(torch, torch.matmul, lib_sets, 20)
        plain_ms, _ = time_calls(torch, plain, sets, 3)
        ops_ = 2 * Q * M * N * K * D
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops_ / INT8_OPS
        results[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/csd_matvec.cu",
            "replaces": ("src/repro/kernels/csd_matvec.py:50"
                         if name == "csd_matvec"
                         else "src/repro/kernels/csd_matvec.py:90"),
            "max_abs_err": 0.0, "ms": ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_a, "library_ms_repeat": lib_b,
            "library": "torch.matmul in float64 on the reconstructed "
                       "W = sum_d p_d 2^d",
            "shape": f"x {xs} int32, planes {tuple(planes.shape)} int8, "
                     f"timed over {len(sets)} input sets of "
                     f"{nbytes/1e6:.2f} MB"}
        results[name]["routes"] = extra
    for r in results.values():
        print(f"{r['name']}: {r['ms']*1e3:.2f} us on the card "
              f"({r['eager_ms']*1e3:.2f} us per eager call), plain "
              f"{r['plain_ms']*1e3:.2f} us, bound {r['bound_ms']*1e3:.2f} us "
              f"({r['bound_by']}), library {r['library_ms']*1e3:.2f} / "
              f"{r['library_ms_repeat']*1e3:.2f} us; {r['shape']} [{CARD}]")
    for name in ("csd_matvec", "csd_qsweep"):
        rt = results[name]["routes"]
        print(f"{name}: the rule's route ({rt['rule']}) "
              f"{results[name]['ms']*1e3:.2f} / {rt['ms_repeat']*1e3:.2f}"
              f" us, the {rt['other']} route {rt['other_ms']*1e3:.2f} us "
              f"[{CARD}]")
    return [results["csd_matvec"], results["csd_qsweep"]]


def visible_pairs(Sq, Skv, causal, window, offset):
    """(query, key) pairs the mask lets through, for these shapes."""
    qp = np.arange(Sq)[:, None] + offset
    kv = np.arange(Skv)[None, :]
    ok = np.ones((Sq, Skv), bool)
    if causal:
        ok &= kv <= qp
    if window:
        ok &= kv > qp - window
    return int(ok.sum())


def flash_timing(torch, qkv, shape, kw, reps, dt):
    """The flash kernel's time at ``shape`` (B, Sq, Skv, Hq, Hkv, D) over
    input sets from ``qkv(shape, dt)`` (at least twice the L2 together);
    in bf16 also the plain version's, ``scaled_dot_product_attention``'s
    and the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_plain)
    B, Sq, Skv, Hq, Hkv, D = shape
    one = dt.itemsize * (2 * B * Sq * Hq * D + 2 * B * Skv * Hkv * D)
    sets = [qkv(shape, dt)                              # q, o, k, v
            for _ in range(max(2, -(-2 * L2_BYTES // one)))]
    ms, eager_ms = time_calls(
        torch, lambda q, k, v: flash_attention_kernel(q, k, v, **kw),
        sets, reps)
    if dt == torch.float32:        # the f32 route's own time only
        return {"ms": ms, "eager_ms": eager_ms, "sets": len(sets)}
    plain_ms, _ = time_calls(
        torch, lambda q, k, v: flash_attention_plain(q, k, v, **kw),
        sets, 1)
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s)
                for s in sets]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    if window:                     # SDPA takes the window as a mask
        pos = torch.arange(Sq, device="cuda")[:, None] + kw["offset"]
        kpos = torch.arange(Skv, device="cuda")[None, :]
        mask = (kpos <= pos) & (kpos > pos - window)
        sdpa = dict(attn_mask=mask)
    else:
        sdpa = dict(is_causal=causal)
    lib_ms, _ = time_calls(
        torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True, **sdpa), lib_sets, reps)
    pairs = visible_pairs(Sq, Skv, causal, window, kw["offset"])
    t_ops = 4 * D * pairs * Hq * B / BF16_FLOPS
    t_bytes = one / HBM_BYTES_PER_S
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "visible_pairs": pairs,
            "sets": len(sets)}


def flash_kernel_phase(torch):
    """The flash-attention kernel against its plain version on the card,
    f32 and bf16, and its time at the loss shape beside the bound, the
    plain version and scaled_dot_product_attention; the same at the hybrid
    path's shapes (D = 256, MQA 16:1, window 2048)."""
    from repro_torch.kernels.flash_attention import (
        BF16_SHARE, KEY_TILE, bf16_disagreement, flash_attention_kernel,
        flash_attention_plain)
    from repro_torch.launch import serve_quantized as sq
    S_pre = max(len(p) for p in sq.prompts(151936)[:sq.MAX_BATCH])
    H_pre = hybrid_prefill_len()
    chunked = dict(bk=512, offset=0)          # chunked_attention's call
    local = dict(chunked, window=2048)        # the hybrid's local attention
    # name, (B, Sq, Skv, Hq, Hkv, D), semantics
    cases = [
        ("causal GQA 7:1", (2, 1024, 1024, 14, 2, 64),
         dict(causal=True, **chunked)),
        ("window 40, cross-length, offset 200", (1, 100, 300, 4, 1, 64),
         dict(causal=True, window=40)),
        ("rows past kv_len see no key", (2, 70, 70, 4, 2, 16),
         dict(causal=True, window=9, offset=13, bk=64)),
        ("rows before every key", (1, 96, 40, 2, 1, 32),
         dict(causal=True, bk=48)),
        ("non-causal", (2, 64, 200, 4, 4, 32), dict(causal=False)),
        ("MHA", (1, 333, 333, 14, 14, 64), dict(causal=True)),
        ("loss shape", (8, 1024, 1024, 14, 2, 64),
         dict(causal=True, **chunked)),
        (f"prefill shape (first batch, S={S_pre})",
         (8, S_pre, S_pre, 14, 2, 64), dict(causal=True, **chunked)),
        ("hybrid loss shape, window 2048", (1, HYB_LOSS_SEQ, HYB_LOSS_SEQ,
                                            16, 1, 256),
         dict(causal=True, **local)),
        (f"hybrid prefill shape (first batch, S={H_pre}), window 2048",
         (HYB_BATCH, H_pre, H_pre, 16, 1, 256), dict(causal=True, **local)),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dt):
        B, Sq, Skv, Hq, Hkv, D = shape
        return [torch.randn(s, generator=gen, device="cuda", dtype=dt)
                for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]

    loss_err = bf16_check = None
    for name, shape, kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = qkv(shape, dt)
            # in bf16, p is rounded against the running max of a key tile
            args = kw if dt == torch.float32 else dict(kw, bk=KEY_TILE)
            got = flash_attention_kernel(q, k, v, **args)
            want = flash_attention_plain(q, k, v, **args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if dt == torch.float32:
                ok = torch.allclose(got, want, atol=FLASH_F32_TOL,
                                    rtol=FLASH_F32_TOL)
                tol = f"atol = rtol = {FLASH_F32_TOL}"
            else:
                ratio, share = bf16_disagreement(got, want)
                ok = ratio <= 1 and share <= BF16_SHARE
                tol = (f"key tile {KEY_TILE}: largest err / limit {ratio:.3f} "
                       f"(<= 1), share of elements that differ {share:.3e} "
                       f"(<= {BF16_SHARE})")
            check(ok and bool(torch.isfinite(got).all()),
                  f"flash_attention kernel vs plain, {name} {dt}: max abs "
                  f"err {err}, {tol}")
            print(f"flash_attention {name} {tuple(shape)} {dt}: max abs err "
                  f"{err:.3e} ({tol})")
            if name == "loss shape" and dt == torch.bfloat16:
                loss_err = err
                # the control: the same kernel in f32 leaves p unrounded
                ctl = flash_attention_kernel(q.float(), k.float(), v.float(),
                                             **args).bfloat16()
                c_ratio, c_share = bf16_disagreement(ctl, want)
                bf16_check = {"ratio": ratio, "share": share,
                              "control_ratio": c_ratio,
                              "control_share": c_share}
                check(c_share > BF16_SHARE, "flash_attention bf16 check: "
                      f"p left unrounded passes it (share {c_share})")
                print(f"flash_attention {name} bf16 control, p left "
                      f"unrounded: largest err / limit {c_ratio:.3f}, share "
                      f"{c_share:.3e} (must exceed {BF16_SHARE})")

    def timing(shape, kw, reps, dt=torch.bfloat16):
        return flash_timing(torch, qkv, shape, kw, reps, dt)

    row = timing((8, 1024, 1024, 14, 2, 64), dict(causal=True, **chunked), 3)
    pre = timing((8, S_pre, S_pre, 14, 2, 64), dict(causal=True, **chunked),
                 2)
    h_loss = timing((1, HYB_LOSS_SEQ, HYB_LOSS_SEQ, 16, 1, 256),
                    dict(causal=True, **local), 2)
    h_pre = timing((HYB_BATCH, H_pre, H_pre, 16, 1, 256),
                   dict(causal=True, **local), 2)
    f32 = timing((8, 1024, 1024, 14, 2, 64), dict(causal=True, **chunked), 1,
                 torch.float32)
    # ptxas's report of the tensor-core instantiations on the main paths
    ptxas = {}
    for D in (64, 256):
        ptxas[f"D{D}"] = lines = flash_ptxas(
            f"flash_attention_wgmma_kernelILi{D}EE")
        print(f"flash_attention bf16 D = {D}, key tile {KEY_TILE}: ptxas "
              f"{' / '.join(lines)}")
    keep = ("ms", "plain_ms", "bound_ms", "library_ms", "visible_pairs")
    row.update({
        "name": "flash_attention", "route": "cuda",
        "routes": {"bfloat16": "tensor cores: wgmma, TMA ring of 2 stages",
                   "float32": "CUDA cores"},
        "key_tile": {"bfloat16": KEY_TILE, "float32": 32},
        "ptxas": ptxas,
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:84",
        "max_abs_err": loss_err, "bf16_check": bf16_check,
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "(is_causal, enable_gqa), (B, H, S, D) layout",
        "shape": f"q (8,1024,14,64), k/v (8,1024,2,64) bf16 causal: one "
                 f"Model.loss layer; timed over {row['sets']} input sets",
        "prefill": {k: pre[k] for k in keep},
        "hybrid_loss": {k: h_loss[k] for k in keep},
        "hybrid_prefill": {k: h_pre[k] for k in keep},
        "f32_loss_shape": {"ms": f32["ms"], "eager_ms": f32["eager_ms"]},
    })
    for name, r in (("loss shape", row), (f"prefill S={S_pre}", pre),
                    (f"hybrid loss (1, {HYB_LOSS_SEQ}, 16/1 heads of 256, "
                     f"window 2048)", h_loss),
                    (f"hybrid prefill ({HYB_BATCH}, {H_pre}), window 2048",
                     h_pre)):
        print(f"flash_attention ({name}): {r['ms']*1e3:.2f} us on the card "
              f"({r['eager_ms']*1e3:.2f} us per eager call), plain "
              f"{r['plain_ms']*1e3:.2f} us, bound {r['bound_ms']*1e3:.2f} us "
              f"({r['bound_by']}, {r['visible_pairs']} visible pairs per "
              f"head), scaled_dot_product_attention "
              f"{r['library_ms']*1e3:.2f} us")
    print(f"flash_attention (loss shape, f32 route on the CUDA cores): "
          f"{f32['ms']*1e3:.2f} us on the card ({f32['eager_ms']*1e3:.2f} us "
          f"per eager call) over {f32['sets']} input sets")
    return row


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def tiny_lm_phase(torch):
    """A tiny f32 model: Model.loss on the card equals the CPU's within 1e-5
    relative, through the flash kernel (one launch per layer), and
    ReferenceEngine gives the CPU's greedy tokens, float and int8-PoT."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import ReferenceEngine, Request
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2,
                              vocab=64, dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    batch = TokenPipeline(vocab=64, seq_len=200, global_batch=2).batch(0)
    losses = []
    for dev in ("cpu", "cuda"):
        n0 = flash_attention_kernel.launches
        losses.append(float(Model(cfg, device=dev).loss(_to(params, dev),
                                                         batch)[0]))
        launched = flash_attention_kernel.launches - n0
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    check(rel <= 1e-5 and launched == cfg.n_layers,
          f"tiny Model.loss: card {losses[1]!r} cpu {losses[0]!r} (rel "
          f"{rel:.3e}), {launched} flash launches")
    print(f"tiny f32 Model.loss: card {losses[1]!r}, CPU {losses[0]!r}, "
          f"rel diff {rel:.3e} (tolerance 1e-5), {launched} flash launches")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 64, n).astype(np.int32)
               for n in (3, 17, 9, 22, 30)]
    for quantized in (False, True):
        outs = []
        for dev in ("cpu", "cuda"):
            eng = ReferenceEngine(cfg, params, max_batch=2, max_context=48,
                                  eos_id=-1, quantized=quantized, device=dev)
            reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            outs.append([r.out_tokens for r in reqs])
        check(outs[0] == outs[1], f"tiny ReferenceEngine (quantized="
              f"{quantized}): card {outs[1]} != cpu {outs[0]}")
        print(f"tiny ReferenceEngine (quantized={quantized}): card tokens == "
              f"CPU tokens ({outs[1][0]} ...)")


def tiny_rwkv_phase(torch):
    """A tiny f32 rwkv6 (the reduced config: 4 layers, d_model 64, heads
    of 16): Model.loss on the card equals the CPU's within 1e-5 relative
    through the wkv6 kernel (one launch a layer), and ReferenceEngine
    gives the CPU's greedy tokens, float and int8-PoT."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.wkv6 import wkv6_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import ReferenceEngine, Request
    cfg = dataclasses.replace(get_config(RWKV_ARCH).reduced(),
                              dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=200,
                          global_batch=2).batch(0)
    losses = []
    for dev in ("cpu", "cuda"):
        n0 = wkv6_kernel.launches
        losses.append(float(Model(cfg, device=dev).loss(_to(params, dev),
                                                         batch)[0]))
        launched = wkv6_kernel.launches - n0
    rel = abs(losses[1] - losses[0]) / abs(losses[0])
    check(rel <= 1e-5 and launched == cfg.n_layers,
          f"tiny rwkv Model.loss: card {losses[1]!r} cpu {losses[0]!r} (rel "
          f"{rel:.3e}), {launched} wkv6 launches")
    print(f"tiny f32 rwkv Model.loss: card {losses[1]!r}, CPU {losses[0]!r}, "
          f"rel diff {rel:.3e} (tolerance 1e-5), {launched} wkv6 launches")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (3, 17, 9, 22, 30)]
    for quantized in (False, True):
        outs = []
        for dev in ("cpu", "cuda"):
            eng = ReferenceEngine(cfg, params, max_batch=2, max_context=48,
                                  eos_id=-1, quantized=quantized, device=dev)
            reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                    for i, p in enumerate(prompts)]
            eng.run(reqs)
            outs.append([r.out_tokens for r in reqs])
        check(outs[0] == outs[1], f"tiny rwkv ReferenceEngine (quantized="
              f"{quantized}): card {outs[1]} != cpu {outs[0]}")
        print(f"tiny rwkv ReferenceEngine (quantized={quantized}): card "
              f"tokens == CPU tokens ({outs[1][0]} ...)")


# host functions of the tune call whose cumulative time the paper phase
# reads off cProfile (nested ones overlap: commit_many holds _refresh)
HOST_SPANS = ("tuning.py:_adders_polish_batched", "batched.py:evaluate_chain",
              "batched.py:_chain_np", "torchtail.py:chain",
              "batched.py:commit_many",
              "batched.py:commit", "batched.py:evaluate",
              "torchtail.py:counts", "torchtail.py:sync",
              "planner.py:plan", "mcm.py:synthesize")


def host_breakdown(torch, fn):
    """Run ``fn`` under cProfile; its wall time and the cumulative host
    seconds of each ``HOST_SPANS`` function."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    out = fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    spans = {}
    for (path, _, name), (_, calls, _, cum, _) in \
            pstats.Stats(prof).stats.items():
        key = f"{os.path.basename(path)}:{name}"
        if key in HOST_SPANS:
            c0, t0_ = spans.get(key, (0, 0.0))
            spans[key] = (c0 + calls, t0_ + cum)
    return out, wall, spans


def host_top(torch, fn, top):
    """Run ``fn`` under cProfile and print its wall time and the ``top``
    functions by their own (not cumulative) host seconds."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    print(f"host profile: wall {wall*1e3:.3f} ms under cProfile")
    for (path, line, name), (_, calls, own, cum, _) in rows[:top]:
        print(f"  {own*1e3:9.3f} ms own {cum*1e3:9.3f} ms cum {calls:7d} x  "
              f"{os.path.basename(path)}:{line}:{name}"[:110])


def _tune_summary(tp, candidates=True):
    """A TuneResult's fields and stats but its backend; with ``candidates``
    False also without ``stats["candidates"]``, which the TM tuner's device
    chain engine counts otherwise than the host's."""
    drop = {"backend"} if candidates else {"backend", "candidates"}
    return (tp.bha, tp.initial_ha, tp.replacements, tp.sweeps, tp.log,
            [w.tolist() for w in tp.mlp.weights + tp.mlp.biases],
            {k: v for k, v in tp.stats.items() if k not in drop})


_REPORT_FIELDS = ("arch", "style", "area_um2", "latency_ns", "energy_pj",
                  "cycles", "clock_ns", "n_adders", "n_mults")


def _report_fields(reps):
    return [tuple(getattr(r, f) for f in _REPORT_FIELDS) for r in reps]


def _dir_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@contextlib.contextmanager
def qsweep_shapes():
    """Counts of the (Q, M, K, N, D, route) each ``csd_qsweep`` launch
    made through ``repro_torch.kernels.ops`` saw while the block runs (the
    kernel's own counters go on counting)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.csd_matvec import route
    seen = collections.Counter()
    kernel = ops.csd_qsweep_kernel

    def recording(x, planes, **kw):
        (Q, M, K), (D, N) = x.shape, planes.shape[1::2]
        seen[(Q, M, K, N, D, kw.get("how") or route(K, N))] += 1
        return kernel(x, planes, **kw)
    ops.csd_qsweep_kernel = recording
    try:
        yield seen
    finally:
        ops.csd_qsweep_kernel = kernel


def _print_shapes(label, seen):
    print(f"csd_qsweep launches on the {label} path by (Q, M, K, N, D, "
          f"route): " + ", ".join(f"{k}: {n}" for k, n in sorted(seen.items())))


def paper_phase(torch):
    """The paper's search and tuning path at full size on the card, through
    the quickstart's pipeline, held against the numpy backend from the same
    float weights."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import (find_min_q, simurg, tune_parallel,
                                  tune_time_multiplexed)
    from repro_torch.core.csd import tnzd
    from repro_torch.eval import QSweepEvaluator
    from repro_torch.kernels.chain_scan import (chain_scan_kernel,
                                                tm_chain_kernel)
    from repro_torch.kernels.csd_matvec import (csd_matvec_kernel,
                                                csd_qsweep_kernel)
    from repro_torch.launch import quickstart
    sweeps = quickstart.MAX_SWEEPS
    csd_qsweep_kernel.launches = 0
    csd_matvec_kernel.launches = 0
    chain_scan_kernel.launches = 0
    tm_chain_kernel.launches = 0
    csd_qsweep_kernel.route_launches.update(resident=0, chunked=0)
    csd_matvec_kernel.route_launches.update(streaming=0, planes=0)
    zero_chain_routes()
    with qsweep_shapes() as seen:
        run = quickstart.run_pipeline("cuda",
                                      out_dir=os.path.join(SIMURG_OUT, "csd"))
    launches = {"csd_qsweep": csd_qsweep_kernel.launches,
                "csd_matvec": csd_matvec_kernel.launches,
                "chain_scan": chain_scan_kernel.launches,
                "tm_chain": tm_chain_kernel.launches}
    routes = dict(csd_qsweep_kernel.route_launches)
    mv_routes = dict(csd_matvec_kernel.route_launches)
    check_chain_routes("paper", launches)
    res, qr, tp, sweep_ev = run.train, run.qr, run.tp, run.sweep_ev
    xval_int, yval = run.x_val, run.y_val
    test_ha, tune_test_ha = run.test_ha
    print(f"paper: trained 16-16-10-10 on the card in "
          f"{run.seconds['train']:.3f} s: train {res.train_acc:.2f} %, "
          f"val {res.val_acc:.2f} % ({len(res.loss_history)} epochs)")
    check(res.val_acc > 80.0, f"float validation accuracy {res.val_acc}")
    check(sweep_ev.backend == run.test_ev.backend == "csd"
          and tp.stats["backend"] == "csd",
          f"auto did not pick csd: {sweep_ev.backend}, {tp.stats['backend']}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the path was not launched: {launches}")
    check(launches["tm_chain"] == run.tm.stats["eval_calls"],
          f"tm_chain launches {launches['tm_chain']}, TM chain calls "
          f"{run.tm.stats['eval_calls']}")
    s = tp.stats
    print(f"paper min-q (csd): q={qr.q} ha={qr.ha!r} history="
          f"{[(q, h) for q, h in qr.history]}; {run.seconds['min_q']:.3f} s, "
          f"{sweep_ev.stats['eval_calls']} evaluator calls, "
          f"{sweep_ev.stats['networks']} networks, "
          f"{sweep_ev.stats['demoted']} demoted; test ha {test_ha!r}")
    print(f"paper tune (csd, cost=adders, max_sweeps={sweeps}): "
          f"{run.seconds['tune']:.3f} s; bha {tp.initial_ha!r} -> {tp.bha!r}, "
          f"{tp.replacements} replacements in {tp.sweeps} sweeps, log "
          f"{tp.log}; tnzd {s['tnzd_initial']} -> {s['tnzd_final']} "
          f"(check {tnzd(tp.mlp.weights + tp.mlp.biases)}), adders "
          f"{s['adders_initial']} -> {s['adders_after_drop']} -> "
          f"{s['adders_final']}; {s['eval_calls']} evaluator calls, "
          f"{s['candidates']} candidates, {s['commits']} commits, "
          f"demoted: {s.get('demoted', 'no')}; test ha {tune_test_ha!r}")
    tm = run.tm
    check(tm.stats["backend"] == "csd", f"TM tuner on {tm.stats['backend']}")
    print(f"paper tm tune (csd, scope=neuron, max_sweeps="
          f"{quickstart.TM_SWEEPS}, chains on the tm_chain kernel): "
          f"{run.seconds['tm']:.3f} s [{CARD}]; bha {tm.initial_ha!r} -> "
          f"{tm.bha!r}, {tm.replacements} replacements in {tm.sweeps} "
          f"sweeps, log {tm.log}; {tm.stats['eval_calls']} evaluator calls, "
          f"{tm.stats['candidates']} candidates, {tm.stats['commits']} "
          f"commits, demoted: {tm.stats.get('demoted', 'no')}")
    print(f"paper pricing (array engine, {len(run.designs)} rows): "
          f"{run.seconds['price']*1e3:.3f} ms [{CARD}]")
    for rep in run.designs:
        print("  " + rep.row())
    print(f"paper SIMURG (parallel, cmvm) generate + write: "
          f"{run.seconds['simurg']*1e3:.3f} ms [{CARD}] -> {run.out_dir}")
    print(f"launches on the paper path: {launches}; csd_qsweep by route "
          f"{routes}, csd_matvec by route {mv_routes}")
    check(mv_routes["streaming"] == launches["csd_matvec"],
          f"a dense tail left the streaming route: {mv_routes}")
    _print_shapes("paper", seen)
    check(sum(seen.values()) == launches["csd_qsweep"] == routes["resident"],
          f"csd_qsweep launches {launches}, routes {routes}, shapes {seen}")

    # the same tune call under the profiler: device busy share
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tp_prof = tune_parallel(qr.mlp, xval_int, yval, cost="adders",
                                max_sweeps=sweeps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(_tune_summary(tp_prof) == _tune_summary(tp),
          "profiled tune rerun differs")
    report_profile(prof, wall_us, "tune call, csd", 8, digits=3)

    # and under cProfile: where the host's time goes
    tp_host, wall, spans = host_breakdown(torch, lambda: tune_parallel(
        qr.mlp, xval_int, yval, cost="adders", max_sweeps=sweeps))
    check(_tune_summary(tp_host) == _tune_summary(tp),
          "cProfile tune rerun differs")
    print(f"host spans (tune call, csd, under cProfile): wall {wall:.3f} s")
    for key in HOST_SPANS:
        calls, cum = spans.get(key, (0, 0.0))
        print(f"  {cum:8.3f} s {calls:7d} x  {key}")

    # the same search and tune on the host's numpy backend
    t0 = time.perf_counter()
    qr_np = find_min_q(res.weights, res.biases, run.acts, xval_int, yval,
                       backend="numpy")
    t_q_np = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp_np = tune_parallel(qr_np.mlp, xval_int, yval, cost="adders",
                          max_sweeps=sweeps, backend="numpy")
    t_tune_np = time.perf_counter() - t0
    test_np = QSweepEvaluator(run.x_test, run.y_test, backend="numpy")
    check((qr.q, qr.ha, qr.history) == (qr_np.q, qr_np.ha, qr_np.history),
          f"min-q differs: csd {qr.history} numpy {qr_np.history}")
    check(_tune_summary(tp) == _tune_summary(tp_np),
          "tune_parallel on csd differs from numpy")
    check(test_np.evaluate([qr.mlp, tp.mlp]) == [test_ha, tune_test_ha],
          "test-split scores differ between csd and numpy")
    t0 = time.perf_counter()
    tm_np = tune_time_multiplexed(qr_np.mlp, xval_int, yval, scope="neuron",
                                  max_sweeps=quickstart.TM_SWEEPS,
                                  backend="numpy")
    t_tm_np = time.perf_counter() - t0
    check(_tune_summary(tm, candidates=False)
          == _tune_summary(tm_np, candidates=False),
          "tune_time_multiplexed on csd differs from numpy")
    designs_np = quickstart.price_designs(tp_np, tm_np)
    check(designs_np == run.designs,
          "design_cost rows (array engine) differ between csd and numpy")
    scalar = quickstart.price_designs(tp, tm, engine="scalar")
    check(_report_fields(scalar) == _report_fields(
        quickstart.price_designs(tp_np, tm_np, engine="scalar")),
        "design_cost rows (scalar engine) differ between csd and numpy")
    check(_report_fields(scalar) == _report_fields(run.designs),
          "the array and scalar engines' reports differ")
    t0 = time.perf_counter()
    np_dir = os.path.join(SIMURG_OUT, "numpy")
    simurg.generate(tp_np.mlp, arch="parallel", style="cmvm",
                    top="pendigits_ann").write(np_dir)
    t_simurg_np = time.perf_counter() - t0
    got, want = _dir_bytes(run.out_dir), _dir_bytes(np_dir)
    check(len(got) == 5 and got == want,
          f"SIMURG files differ between csd and numpy: {sorted(got)}")
    print(f"paper on numpy: min-q {t_q_np:.3f} s, tune {t_tune_np:.3f} s, "
          f"tm tune {t_tm_np:.3f} s, SIMURG {t_simurg_np*1e3:.3f} ms "
          f"[{CARD}]; (q, ha, history), both TuneResults, test scores, "
          f"{len(designs_np)} design rows (array and scalar engines, which "
          f"agree) and {len(got)} SIMURG files "
          f"({sum(map(len, got.values()))} bytes) identical to csd")
    return launches, run, tm_np


def event_ms(torch, fn, reps):
    """Milliseconds a call from CUDA events around ``reps`` calls, after
    one untimed call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(torch, fn, reps):
    """Device milliseconds a call of ``fn``: ``reps`` calls enqueued behind
    a ``torch.cuda._sleep`` longer than the host takes to enqueue them,
    between two CUDA events, so the host's own time (Python, autograd,
    launch gaps) stays out of the reading; after one untimed call, and one
    timed on the host that sizes the sleep."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 2_000_000)  # > host_s at 2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_device_ms(torch, fn, name, reps, tries=6):
    """Device milliseconds a launch of the kernel whose name holds
    ``name``, from ``torch.profiler`` over ``reps`` calls of ``fn`` (one
    launch each) after one untimed call.  A window whose trace lost a
    launch's record is profiled again, up to ``tries`` windows (a chain
    kernel's trace has lost a record in three windows in a row)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in device_events(prof) if name in e.name]
        if len(evs) == reps:
            break
        print(f"{name}: {len(evs)} device events for {reps} calls; "
              f"profiling again")
    check(len(evs) == reps, f"{name}: {len(evs)} device events for {reps} "
                            f"calls in each of {tries} windows")
    return sum(e.time_range.end - e.time_range.start for e in evs) \
        / reps / 1e3


def host_ms(fn, reps=3):
    """Median wall milliseconds of ``reps`` calls of a host function."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return sorted(ts)[len(ts) // 2]


def on_route(torch, kernel, how, args):
    """One launch of a chain kernel on route ``how`` (the cluster at the
    rule's size), checked to be one launch on that route."""
    n0, r0 = kernel.launches, dict(kernel.route_launches)
    out = kernel(*args, _route=how)
    torch.cuda.synchronize()
    check(kernel.launches == n0 + 1 and kernel.route_launches[how]
          == r0[how] + 1, f"{kernel.__name__}: not one launch on {how}")
    return out


def time_chain(torch, kernel, plain, args, run, got, host):
    """Device times of a chain kernel on layer 0's first-sweep ``run``: on
    the rule's route, on the cluster at every size that holds the rows and
    on the block, each also on the run's no-move twin (every move zeroed);
    the plain version's and the host chain's wall times, and the bytes
    bound."""
    from repro_torch.kernels.chain_scan import (CLUSTER_SIZES, SMEM_OPTIN,
                                                cluster_smem, route)
    tm = kernel.__name__ == "tm_chain_kernel"
    name = "tm_chain" if tm else "chain_scan"
    a = args[0]
    widths = [a[0].shape[1]] + [x.shape[1] for x in args[2]]
    k, M = args[8], a[args[8]].shape[0]
    n_db = len(run[0]) if tm else 0
    sizes0 = dict(kernel.size_launches)
    check(torch.equal(on_route(torch, kernel, "cluster", (*args, *run)).cpu(),
                      got.cpu()), f"{name}: the cluster route differs")
    first = [c for c, n in kernel.size_launches.items() if n > sizes0[c]]
    check(route(widths, k, M, n_db) == "cluster" and len(first) == 1,
          f"{name}: not one cluster launch at layer 0: {first}")
    still = _no_move(run, tm)
    still_want = plain(*args, *still).cpu()
    variants = [("cluster", c) for c in CLUSTER_SIZES
                if cluster_smem(widths, k, M, n_db, c) <= SMEM_OPTIN]
    routes = {}
    for how, size in variants + [("block", None)]:
        label = how if size is None else f"cluster C={size}"
        kname = f"{name}_cluster_kernel" if how == "cluster" \
            else f"{name}_kernel"
        call = lambda: kernel(*args, *run, _route=how,  # noqa: E731
                              _size=size)
        out = call()
        check(torch.equal(out.cpu(), got.cpu()),
              f"{name} on {label} differs from the rule's route")
        still_call = lambda: kernel(*args, *still,  # noqa: E731
                                    _route=how, _size=size)
        check(torch.equal(still_call().cpu(), still_want),
              f"{name}'s no-move run on {label} differs from the plain "
              f"version")
        routes[label] = dict(
            ms=kernel_device_ms(torch, call, kname, 20),
            eager_ms=event_ms(torch, call, 20),
            floor_ms=kernel_device_ms(torch, still_call, kname, 20))
    n_ok = int(got[:, 0 if tm else 1].sum().item())
    n = len(run[1]) if tm else len(run[0])
    return dict(
        steps=n, accepted=n_ok, route=f"cluster C={first[0]}", routes=routes,
        plain_ms=host_ms(lambda: (plain(*args, *run),
                                  torch.cuda.synchronize()), 1),
        host_ms=host_ms(host),
        bytes=_chain_bytes(args, n, n_ok, 6 if tm else 2))


def _first_sweep_runs(ev, k):
    """The tuners' own first-sweep runs at layer k of ``ev``'s network:
    ``tune_parallel``'s first chunk of CSD-digit drops (the serial chain)
    and ``tune_time_multiplexed``'s smallest-left-shift steps of every
    neuron of layer k (the TM chain, nudges +-1..4)."""
    from repro_torch.core import csd
    from repro_torch.core.tuning import _neuron_groups, _sls_candidates
    from repro_torch.eval import Candidate, TMStep
    w = ev.mlp.weights[k]
    flat = w.ravel()
    alts = csd.drop_least_significant_digit_array(flat)
    cands = [Candidate(k, int(i) % w.shape[1], int(i) // w.shape[1],
                       int(alts[i])) for i in np.nonzero(flat)[0]]
    dbs = tuple(d for d in range(-4, 5) if d)
    steps = [TMStep(kk, m, n, tuple(pws), dbs)
             for g in _neuron_groups(ev.mlp, "neuron")
             for kk, m, n, _w, pws in _sls_candidates(ev.mlp, g) if kk == k]
    return cands[:ev.chunk], steps


def _random_runs(rng, ev, k, n, spread):
    """Random runs at layer k: n candidates / TM steps over distinct
    weights, values up to ``spread`` from the weight."""
    from repro_torch.eval import Candidate, TMStep
    w = ev.mlp.weights[k]
    cells = [(i, j) for i in range(w.shape[0]) for j in range(w.shape[1])]
    rng.shuffle(cells)
    cells = cells[:n]
    near = lambda v: v + int(rng.integers(-spread, spread + 1))  # noqa: E731
    cands = [Candidate(k, j, i, near(int(w[i, j])),
                       dbias=int(rng.integers(-3, 4))) for i, j in cells]
    steps = [TMStep(k, j, i, tuple(near(int(w[i, j]))
                                   for _ in range(1 + (t % 3 > 0))),
                    tuple(d for d in range(-4, 5) if d))
             for t, (i, j) in enumerate(cells)]
    return cands, steps


def _chain_bytes(args, n_steps, n_ok, out_cols):
    """Bytes a chain call must move: its inputs read once (the caches of
    layers k and k+1, the packed weights, the labels), per step the three
    int32 columns a step reads (layer k's inputs, accumulators and
    outputs), per accepted step the two it writes, and its outputs."""
    a, acc, w, bsh, lab, lab_safe, _acts, _q, k = args[:9]
    last = k == len(w) - 1
    ins = [a[k], acc[k], a[k + 1], lab, lab_safe] + ([] if last else (
        [acc[k + 1], w[k + 1]] + [t for l in range(k + 2, len(w))
                                  for t in (w[l], bsh[l])]))
    M = a[k].shape[0]
    return (sum(t.numel() * t.element_size() for t in ins)
            + 4 * M * (3 * n_steps + 2 * n_ok) + 4 * out_cols * n_steps)


def zero_chain_routes():
    from repro_torch.kernels.chain_scan import (chain_scan_kernel,
                                                tm_chain_kernel)
    for kern in (chain_scan_kernel, tm_chain_kernel):
        kern.route_launches.update(cluster=0, block=0)
        kern.size_launches.update(dict.fromkeys(kern.size_launches, 0))


def check_chain_routes(label, launches):
    """Print the chain kernels' launches by route since
    ``zero_chain_routes`` and check that every one ran on the cluster
    route (the paper's shapes)."""
    from repro_torch.kernels.chain_scan import (chain_scan_kernel,
                                                tm_chain_kernel)
    routes = {"chain_scan": dict(chain_scan_kernel.route_launches),
              "tm_chain": dict(tm_chain_kernel.route_launches)}
    sizes = {"chain_scan": dict(chain_scan_kernel.size_launches),
             "tm_chain": dict(tm_chain_kernel.size_launches)}
    print(f"{label} chain launches by route: {routes}; cluster launches by "
          f"size: {sizes}")
    for name, r in routes.items():
        check(r == {"cluster": launches[name], "block": 0},
              f"{label}: {name} launches {launches[name]} off the cluster "
              f"route: {r}")


def _no_move(args_steps, tm):
    """The same run with every move zeroed (dw = db = 0, the nudges 0):
    no row's layer-k output moves, so no row runs a tail."""
    if tm:
        dbsh, wi, wj, dw0, dw1, *rest = args_steps
        return ((0,) * len(dbsh), wi, wj, 0 * dw0, 0 * dw1, *rest)
    wi, wj, dw, db = args_steps
    return wi, wj, 0 * dw, 0 * db


def chains_phase(torch, run, tm_np):
    """Phase 6c: the device decision chains and measured dispatch at the
    paper's full size (phase 6's 16-16-10-10 and validation split)."""
    import tempfile
    from repro_torch import tune
    from repro_torch.core import (find_min_q, tune_parallel,
                                  tune_time_multiplexed)
    from repro_torch.core.intmlp import IntMLP
    from repro_torch.eval import BatchedHWEvaluator, QSweepEvaluator
    from repro_torch.kernels.chain_scan import (ROUTES, chain_scan_kernel,
                                                chain_scan_plain,
                                                tm_chain_kernel,
                                                tm_chain_plain)
    from repro_torch.kernels.csd_matvec import (csd_matvec_kernel,
                                                csd_qsweep_kernel)
    from repro_torch.launch import quickstart
    from repro_torch.tune.cache import DispatchCache
    qr, xval, yval = run.qr, run.x_val, run.y_val
    rng = np.random.default_rng(0)

    # (1) each kernel against its plain version, bit for bit
    deep_ws = [rng.integers(-64, 64, (a, b)).astype(np.int64)
               for a, b in zip((16, 16, 14, 12, 10), (16, 14, 12, 10, 10))]
    deep = IntMLP(deep_ws, [rng.integers(-32, 32, (w.shape[1],))
                            .astype(np.int64) for w in deep_ws],
                  ["htanh", "relu", "satlin", "htanh", "hsig"], 5)
    nets = (("paper", qr.mlp), ("deep 5-layer", deep))
    kinds = collections.Counter()
    timed = {}
    n_checked = 0
    for label, mlp in nets:
        ev = BatchedHWEvaluator(mlp, xval, yval)
        check(ev.backend == "csd", f"{label}: backend {ev.backend}")
        dev = ev._device_state()
        for k in range(len(mlp.weights)):
            runs = [("first sweep",) + _first_sweep_runs(ev, k),
                    ("random",) + _random_runs(rng, ev, k, 64, 40)]
            for kind, cands, steps in runs:
                args = dev._chain_args(k, ev._count)
                _, wi, wj, dw, db = ev._pack(cands)
                want = chain_scan_plain(*args, wi, wj, dw, db)
                for how in ROUTES:
                    got = on_route(torch, chain_scan_kernel, how,
                                   (*args, wi, wj, dw, db))
                    check(torch.equal(got.cpu(), want.cpu()),
                          f"chain_scan kernel ({how}) != plain ({label}, "
                          f"k={k}, {kind})")
                host = ev._chain_np(k, wi, wj, dw, db)
                check(np.array_equal(got[:, 0].cpu().numpy(), host[0])
                      and np.array_equal(got[:, 1].cpu().numpy() != 0,
                                         host[1]),
                      f"chain_scan != the host chain ({label}, k={k})")
                packed = ev._tm_pack(k, steps) if steps else None
                if packed is not None:
                    want_tm = tm_chain_plain(*args, *packed)
                    for how in ROUTES:
                        got_tm = on_route(torch, tm_chain_kernel, how,
                                          (*args, *packed))
                        check(torch.equal(got_tm.cpu(), want_tm.cpu()),
                              f"tm_chain kernel ({how}) != plain ({label}, "
                              f"k={k}, {kind})")
                    out = got_tm.cpu().numpy()
                    kinds.update("pair" if ok and pair else "nudge" if ok
                                 else "miss" for ok, pair in out[:, [0, 2]])
                n_checked += 1
                if (label, k, kind) != ("paper", 0, "first sweep"):
                    continue
                # the timed runs: layer 0 of the paper's net, first sweep
                check(packed is not None, "no TM run at layer 0")
                timed["chain_scan"] = time_chain(
                    torch, chain_scan_kernel, chain_scan_plain, args,
                    (wi, wj, dw, db), got,
                    lambda: ev._chain_np(k, wi, wj, dw, db))
                timed["tm_chain"] = time_chain(
                    torch, tm_chain_kernel, tm_chain_plain, args, packed,
                    got_tm, lambda: ev._tm_chain_np(k, steps))
    check(set(kinds) == {"pair", "nudge", "miss"},
          f"the TM runs missed a kind of step: {dict(kinds)}")
    print(f"chains: both kernels bit-exact against their plain versions "
          f"on both routes ({' and '.join(ROUTES)}; the serial chain "
          f"also against the host chain) on {n_checked} runs, every layer "
          f"of 16-16-10-10 and of a 5-layer net, 2248 rows; TM steps: "
          f"{dict(kinds)}")
    rows = []
    for name, t in timed.items():
        bound_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        main = t["routes"][t["route"]]
        for how, r in t["routes"].items():
            print(f"{name} on {how}: {r['ms']*1e3:.2f} us a launch on the "
                  f"card, {r['ms']*1e3/t['steps']:.3f} us a step "
                  f"({r['eager_ms']*1e3:.2f} us an eager call; "
                  f"{t['steps']} steps, {t['accepted']} accepted, layer 0); "
                  f"the no-move run {r['floor_ms']*1e3:.2f} us, "
                  f"{r['floor_ms']*1e3/t['steps']:.3f} us a step "
                  f"(the route's synchronisation floor) [{CARD}]")
        print(f"{name}: the rule's route {t['route']}; the host chain "
              f"{t['host_ms']*1e3:.2f} us, the plain version "
              f"{t['plain_ms']*1e3:.2f} us, bound {bound_ms*1e3:.3f} us "
              f"(bytes), {bound_ms*1e3/t['steps']:.4f} us a step [{CARD}]")
        rows.append({
            "name": name, "route": "cuda",
            "kernel_route": t["route"],
            "source": "src/repro_torch/kernels/csrc/chain_scan.cu",
            "replaces": "src/repro/eval/jaxtail.py:" + (
                "346" if name == "chain_scan" else "267"),
            "max_abs_err": 0.0, "ms": main["ms"],
            "eager_ms": main["eager_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "host_chain_ms": t["host_ms"],
            "routes_ms": {how: r["ms"] for how, r in t["routes"].items()},
            "no_move_ms": {how: r["floor_ms"]
                           for how, r in t["routes"].items()},
            "shape": f"16-16-10-10, 2248 rows, layer 0, {t['steps']} steps "
                     f"of the first sweep"})

    # (2) the TM tuner on device chains: identical to phase 6's and, the
    # device engine's candidate count aside, to numpy's host chains; (3)
    # tune_parallel on the card, its serial chain on chain_scan
    counters = (("chain_scan", chain_scan_kernel),
                ("tm_chain", tm_chain_kernel),
                ("csd_matvec", csd_matvec_kernel),
                ("csd_qsweep", csd_qsweep_kernel))
    for _, kern in counters:
        kern.launches = 0
    zero_chain_routes()
    t0 = time.perf_counter()
    tm_dev = tune_time_multiplexed(qr.mlp, xval, yval, scope="neuron",
                                   max_sweeps=quickstart.TM_SWEEPS,
                                   chain_engine="device")
    t_tm = time.perf_counter() - t0
    n_tm = tm_chain_kernel.launches
    t0 = time.perf_counter()
    tm_host = tune_time_multiplexed(qr.mlp, xval, yval, scope="neuron",
                                    max_sweeps=quickstart.TM_SWEEPS,
                                    chain_engine="host")
    t_tm_host = time.perf_counter() - t0
    check(tm_chain_kernel.launches == n_tm,
          "chain_engine=host launched tm_chain")
    t0 = time.perf_counter()
    tp_dev = tune_parallel(qr.mlp, xval, yval, cost="adders",
                           max_sweeps=quickstart.MAX_SWEEPS)
    t_tp = time.perf_counter() - t0
    chain_launches = {name: kern.launches for name, kern in counters}
    check_chain_routes("chains (the two tuners)", chain_launches)
    n_tp = chain_launches["chain_scan"]
    check(tm_dev.stats["backend"] == "csd", "TM tuner left csd")
    check(_tune_summary(tm_dev) == _tune_summary(run.tm)
          and _tune_summary(tm_host) == _tune_summary(tm_np)
          and _tune_summary(tm_dev, candidates=False)
          == _tune_summary(tm_host, candidates=False),
          "tune_time_multiplexed on device chains differs from phase 6's "
          "or from the host chains' (csd and numpy)")
    check(n_tm == tm_dev.stats["eval_calls"] > 0,
          f"tm_chain launches {n_tm}, chain calls "
          f"{tm_dev.stats['eval_calls']}")
    print(f"chains: tune_time_multiplexed(scope=neuron, max_sweeps="
          f"{quickstart.TM_SWEEPS}) on csd: chain_engine=device {t_tm:.3f} s, "
          f"chain_engine=host {t_tm_host:.3f} s [{CARD}]; "
          f"{tm_dev.replacements} replacements, bha {tm_dev.bha!r}, identical "
          f"to phase 6's, the host chains' and numpy's; {n_tm} tm_chain "
          f"launches, one a chain call; candidates "
          f"{tm_dev.stats['candidates']} (host chains "
          f"{tm_host.stats['candidates']})")
    check(_tune_summary(tp_dev) == _tune_summary(run.tp),
          "tune_parallel on the device chain differs from phase 6's")
    check(n_tp > 0, "chain_scan was not launched")
    print(f"chains: tune_parallel(cost=adders, max_sweeps="
          f"{quickstart.MAX_SWEEPS}) on the serial device chain {t_tp:.3f} s "
          f"(phase 6: {run.seconds['tune']:.3f} s) [{CARD}]; TuneResult "
          f"identical to phase 6's; launches of the two tuners "
          f"{chain_launches}")

    # (4) measured dispatch: races into a cache file, hits, reload, reruns
    path = os.path.join(tempfile.mkdtemp(), "tune_cache.json")
    saved = {v: os.environ.get(v) for v in (tune.ENV_ENABLED, tune.ENV_CACHE)}
    os.environ[tune.ENV_ENABLED] = "1"
    os.environ[tune.ENV_CACHE] = path
    tune.set_cache(None)
    tune.set_enabled(None)
    try:
        cache = tune.get_cache()
        # the backend races run between the host backends of CPU
        # evaluators; on the card csd is the one candidate
        QSweepEvaluator(xval, yval, device="cpu")   # races qsweep_backend
        BatchedHWEvaluator(qr.mlp, xval, yval, device="cpu")  # bhw_backend
        ev = BatchedHWEvaluator(qr.mlp, xval, yval, backend="csd")
        _, steps = _first_sweep_runs(ev, 0)
        ev.evaluate_tm_chain(steps, ev.accuracy())   # races tm_chain
        for key, rec in sorted(cache.entries.items()):
            times = ", ".join(f"{n} " + ("left out" if t is None else
                                         f"{t*1e3:.3f} ms")
                              for n, t in rec["timings"].items())
            print(f"race {key}: {times} -> {rec['winner']} [{CARD}]")
        raced = {tuple(key.split("|")[:2]) for key in cache.entries}
        check(raced == {("cpu", "qsweep_backend"), ("cpu", "bhw_backend"),
                        ("cuda", "tm_chain")},
              f"races filled {sorted(cache.entries)}")
        check(QSweepEvaluator(xval, yval).backend
              == BatchedHWEvaluator(qr.mlp, xval, yval).backend == "csd",
              "a CUDA evaluator's auto left csd")
        check(len(cache.entries) == 3, "a CUDA evaluator's auto raced")
        # a second decide of each is a hit, and measures nothing
        tune.set_enabled(False)
        hits0 = tune.stats["hits"]
        again = {"qsweep_backend": QSweepEvaluator(xval, yval,
                                                   device="cpu").backend,
                 "bhw_backend": BatchedHWEvaluator(qr.mlp, xval, yval,
                                                   device="cpu").backend}
        for key, rec in cache.entries.items():
            plat, op, _bucket, dtype = key.split("|")
            if op in again:
                check(again[op] == rec["winner"], f"{op} did not hit")
        n_direct = 0
        for key, rec in cache.entries.items():
            plat, op, bucket, dtype = key.split("|")
            if op in again:
                continue
            shape = tuple(int(d) for d in bucket.split("x"))
            check(tune.decide(op, shape=shape, dtype=dtype,
                              candidates=(rec["winner"],), heuristic="none",
                              plat=plat) == rec["winner"], f"{key} missed")
            n_direct += 1
        check(tune.stats["hits"] - hits0 == 2 + n_direct,
              "a second decide was not a hit")
        back = DispatchCache.load(path, config=tune.default_config())
        check(back.entries == cache.entries and len(back.entries) == 3,
              "the reloaded cache file lost winners")
        print(f"measured dispatch: {len(cache.entries)} races filled "
              f"{os.path.basename(path)}; every second decide hit; the "
              f"reloaded file keeps every winner; config "
              f"{tune.default_config()}")
        # the tuners and the search under the filled cache
        qr2 = find_min_q(run.train.weights, run.train.biases, run.acts, xval,
                         yval)
        check((qr2.q, qr2.ha, qr2.history) == (qr.q, qr.ha, qr.history),
              "find_min_q under the filled cache differs")
        tp2 = tune_parallel(qr.mlp, xval, yval, cost="adders",
                            max_sweeps=quickstart.MAX_SWEEPS)
        check(_tune_summary(tp2) == _tune_summary(run.tp),
              "tune_parallel under the filled cache differs")
        tm2 = tune_time_multiplexed(qr.mlp, xval, yval, scope="neuron",
                                    max_sweeps=quickstart.TM_SWEEPS)
        check(_tune_summary(tm2, candidates=False)
              == _tune_summary(run.tm, candidates=False),
              "tune_time_multiplexed under the filled cache differs")
        print(f"under the filled cache: find_min_q, tune_parallel and "
              f"tune_time_multiplexed identical to the heuristic's "
              f"(backends {again}; tune_parallel on {tp2.stats['backend']})")
        decode_auto_check(torch, tune, DispatchCache)
    finally:
        for var, val in saved.items():
            if val is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = val
        tune.set_cache(None)
        tune.set_enabled(None)
        if os.path.exists(path):
            os.unlink(path)
        os.rmdir(os.path.dirname(path))
    return rows, chain_launches


def decode_auto_check(torch, tune, DispatchCache):
    """``ServeEngine(decode_kernel="auto")`` on a tiny f32 model: "dense" on
    a miss, a forced cache pick ("fused") when one exists, the same greedy
    tokens either way."""
    import dataclasses
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import Request, ServeEngine
    cfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(), n_layers=2,
                              vocab=64, dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    forced = DispatchCache(tune.default_config())
    forced.put(tune.make_key("cuda", "decode_kernel",
                             tune.shape_bucket((2, 32, 8)), "float32"),
               "fused")
    picks, toks = [], []
    for cache in (DispatchCache(tune.default_config()), forced):
        with tune.use_cache(cache, measure=False):
            eng = ServeEngine(cfg, params, eos_id=-1, max_batch=2,
                              max_context=32, prefill_chunk=8,
                              kv_block_size=8, decode_kernel="auto")
        req = Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32),
                      max_new_tokens=6)
        eng.run([req])
        picks.append(eng.decode_kernel)
        toks.append(list(req.out_tokens))
    check(picks == ["dense", "fused"] and toks[0] == toks[1],
          f"decode_kernel=auto: {picks}, tokens {toks}")
    print(f"ServeEngine(decode_kernel=auto), tiny f32 model: a miss -> "
          f"dense, a forced pick -> fused; greedy tokens equal ({toks[0]})")


def explore_phase(torch):
    """The design-space explorer at the reference walkthrough's size
    (16-16-10, 25 epochs, seed 3, full pendigits split, q_span 2,
    max_sweeps 3) with the TM tuner too, through ``launch/explore.py``:
    once with the sweep evaluator on ``auto`` (csd on the card), once on
    ``numpy``; every DesignPoint and front must be equal."""
    from repro_torch.core.planner import SynthesisPlanner
    from repro_torch.eval import QSweepEvaluator
    from repro_torch.kernels.csd_matvec import (csd_matvec_kernel,
                                                csd_qsweep_kernel)
    from repro_torch.kernels.chain_scan import (chain_scan_kernel,
                                                tm_chain_kernel)
    from repro_torch.launch import explore as lx
    t0 = time.perf_counter()
    res, x_val, y_val = lx.train_float("cuda")
    t_train = time.perf_counter() - t0
    tuners = lx.DEFAULT_TUNERS + ("tm-neuron", "mixedbw")
    ev = QSweepEvaluator(x_val, y_val, device="cuda")
    check(ev.backend == "csd", f"auto resolved to {ev.backend}, not csd")
    csd_qsweep_kernel.launches = 0
    csd_matvec_kernel.launches = 0
    chain_scan_kernel.launches = 0
    tm_chain_kernel.launches = 0
    csd_qsweep_kernel.route_launches.update(resident=0, chunked=0)
    csd_matvec_kernel.route_launches.update(streaming=0, planes=0)
    zero_chain_routes()
    with qsweep_shapes() as seen:
        r = lx.run_explore(res, x_val, y_val, "cuda", tuners=tuners,
                           planner=SynthesisPlanner(), evaluator=ev)
        torch.cuda.synchronize()
    launches = {"csd_qsweep": csd_qsweep_kernel.launches,
                "csd_matvec": csd_matvec_kernel.launches,
                "chain_scan": chain_scan_kernel.launches,
                "tm_chain": tm_chain_kernel.launches}
    routes = dict(csd_qsweep_kernel.route_launches)
    check_chain_routes("explore", launches)
    check(launches["csd_qsweep"] > 0,
          f"csd_qsweep was not launched on the explore path: {launches}")
    check(sum(seen.values()) == launches["csd_qsweep"] == routes["resident"],
          f"csd_qsweep launches {launches}, routes {routes}, shapes {seen}")
    print(f"explore csd_qsweep launches by route: {routes}")
    _print_shapes("explore", seen)
    # the same csd run under the profiler: device busy share
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r_prof = lx.run_explore(res, x_val, y_val, "cuda", tuners=tuners,
                                planner=SynthesisPlanner())
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(r_prof.points == r.points, "profiled explore rerun differs")
    report_profile(prof, wall_us, "explore call, csd", 6, digits=3)
    r_np = lx.run_explore(res, x_val, y_val, "cpu", tuners=tuners,
                          backend="numpy", planner=SynthesisPlanner())
    check(r.points == r_np.points and r.qs == r_np.qs,
          "explore DesignPoints differ between csd and numpy")
    for metric in ("area_um2", "energy_pj", "latency_ns"):
        check(r.front(metric) == r_np.front(metric),
              f"the {metric} front differs between csd and numpy")
    timing = ("tune_s", "wall_s")
    check({k: v for k, v in r.stats.items() if k not in timing} ==
          {k: v for k, v in r_np.stats.items() if k not in timing},
          f"explore stats differ: {r.stats} {r_np.stats}")
    print(f"explore: trained 16-16-10 on the card in {t_train:.3f} s, val "
          f"{res.val_acc:.2f} %; q ladder {r.qs} x {r.tuners}")
    for name, x in (("csd", r), ("numpy", r_np)):
        s = x.stats
        print(f"explore ({name}): {s['n_networks']} networks, "
              f"{s['n_points']} points, {s['eval_calls']} evaluator calls, "
              f"planner {s['planner_hits']} hits / {s['planner_misses']} "
              f"misses, tune_s {s['tune_s']:.3f}, wall_s {s['wall_s']:.3f} "
              f"[{CARD}]")
    print(f"explore: every DesignPoint ({len(r.points)}), the three fronts "
          f"and the stats identical on csd and numpy; launches on the "
          f"explore path: {launches}")
    lx.report(res, r)
    return launches


def ptq_phase(torch):
    """The LM-scale search, rescale and ReferenceEngine serving at full
    width, through the launcher's pipeline, with the flash-attention
    counter zeroed just before and read just after."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.launch import serve_quantized as sq
    flash_attention_kernel.launches = 0
    run = sq.run_pipeline("cuda")
    launches = {"flash_attention": flash_attention_kernel.launches}
    L = run.cfg.n_layers
    sec, calls, fl = run.seconds, run.loss_calls, run.launches
    print(f"ptq search (batched): bits={run.bits} history={run.history}; "
          f"{sec['search']:.3f} s, {calls['search']} Model.loss calls, "
          f"{fl['search']} flash launches")
    print(f"ptq search (serial): bits={run.serial[0]} history="
          f"{run.serial[1]}; {sec['serial']:.3f} s, {calls['serial']} "
          f"Model.loss calls, {fl['serial']} flash launches")
    print(f"ptq sls_rescale: {run.raised} exponents raised; "
          f"{sec['rescale']:.3f} s, {calls['rescale']} Model.loss calls, "
          f"{fl['rescale']} flash launches; bytes float {run.float_bytes} -> "
          f"quant {run.quant_bytes}")
    check(run.serial == (run.bits, run.history),
          "batched and serial min_bitwidth_search differ")
    check(all(np.isfinite(loss) for _, loss in run.history),
          f"a loss is not finite: {run.history}")
    for step in ("search", "serial", "rescale"):
        check(fl[step] == L * calls[step],
              f"{step}: {fl[step]} flash launches for {calls[step]} "
              f"Model.loss calls")
    reqs = run.requests
    n_batches = -(-len(reqs) // sq.MAX_BATCH)
    check(all(r.status == "done" and len(r.out_tokens) == sq.MAX_NEW
              for r in reqs), "a request did not finish with its tokens")
    toks = np.array([r.out_tokens for r in reqs])
    check(toks.min() >= 0 and toks.max() < run.cfg.vocab,
          "token out of range")
    check(fl["serve"] == L * n_batches,
          f"serve: {fl['serve']} flash launches for {n_batches} prefills")
    s = run.engine.stats
    first = [run.token_s[r.rid][0] for r in reqs]
    total = [run.token_s[r.rid][1] for r in reqs]
    from repro_torch.runtime.serve import percentile as pct
    print(f"reference serving (int8-PoT, bits={run.bits}): {len(reqs)} "
          f"requests in {sec['serve']:.3f} s, {n_batches} batches; prefill "
          f"{s['prefill_tokens']} tok in {s['prefill_s']:.3f} s "
          f"({s['prefill_tokens']/s['prefill_s']:.1f} tok/s); decode "
          f"{s['decode_tokens']} tok in {s['decode_s']:.3f} s "
          f"({s['decode_tokens']/s['decode_s']:.1f} tok/s); "
          f"{fl['serve']} flash launches")
    print(f"reference latency: first token p50 {pct(first, 50)*1e3:.1f} ms "
          f"p99 {pct(first, 99)*1e3:.1f} ms; total p50 "
          f"{pct(total, 50)*1e3:.1f} ms p99 {pct(total, 99)*1e3:.1f} ms; "
          f"peak memory {run.peak_bytes/2**30:.3f} GiB")
    print(f"serving ledger totals: {run.ledger.to_dict()['totals']}")
    print(f"launches on the ptq path: {launches}")
    return launches, run


def reference_profile_phase(torch, run):
    """Device busy share and top kernels over one more ReferenceEngine
    batch (prefill and 31 decode steps)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve_quantized as sq
    from repro_torch.runtime.serve import Request
    eng = run.engine
    reqs = [Request(rid=100 + i, prompt=p, max_new_tokens=sq.MAX_NEW)
            for i, p in enumerate(sq.prompts(run.cfg.vocab)[:sq.MAX_BATCH])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(all(r.status == "done" for r in reqs), "a profiled request failed")
    report_profile(prof, wall_us, "one ReferenceEngine batch", 12)


def mixed_phase(torch):
    """Mixed bit widths at full width through ``launch/mixed_bitwidth.py``'s
    ``run_pipeline``, with every counter of its kernels zeroed just before
    and read just after; then the pendigits search again on ``numpy``."""
    from repro_torch.kernels.csd_matvec import csd_qsweep_kernel
    from repro_torch.launch import explore as lx
    from repro_torch.launch import mixed_bitwidth as mb
    from repro_torch.quant import mixed_minq_search
    for k in mb.KERNELS.values():
        k.launches = 0
    csd_qsweep_kernel.route_launches.update(resident=0, chunked=0)
    with qsweep_shapes() as seen:
        run = mb.run_pipeline("cuda")
    torch.cuda.synchronize()
    n = {name: k.launches for name, k in mb.KERNELS.items()}
    launches = {"flash_attention": n["flash_attention"],
                "paged_gather": n["paged_gather_pair"] + n["paged_gather"],
                "paged_attention": n["paged_attention"],
                "csd_qsweep": n["csd_qsweep"]}
    res, L = run.result, run.cfg.n_layers
    sec, calls, fl = run.seconds, run.loss_calls, run.launches
    for name, r in (("batched", res), ("serial", run.serial)):
        step = "search" if name == "batched" else "serial"
        demoted = sorted(p for p, b in r.bits.items() if b < r.start_bits)
        print(f"mixed search ({name}): start {r.start_bits} bits, "
              f"{len(r.history)} rounds, demoted {demoted}; base "
              f"{r.base:.6f}, loss {r.loss:.6f}; {sec[step]:.3f} s, "
              f"{calls[step]} Model.loss calls, "
              f"{fl[step]['flash_attention']} flash launches [{CARD}]")
    for rnd, cands, picked, ok in res.history:
        print(f"  round {rnd}: picked {picked} ({ok}); " + ", ".join(
            f"{p}@{b} {loss:.6f}" for p, b, loss in cands))
    check(mb.same_search(res, run.serial),
          "batched and serial mixed_bitwidth_search differ")
    check(res.start_bits > mb.BIT_LADDER[-1] and res.history,
          f"the search started at {res.start_bits} and scored no round")
    check(all(np.isfinite(loss) for _, c, _, _ in res.history
              for _, _, loss in c), "a candidate's loss is not finite")
    for step in ("search", "serial"):
        check(fl[step]["flash_attention"] == L * calls[step],
              f"{step}: {fl[step]['flash_attention']} flash launches for "
              f"{calls[step]} Model.loss calls")
    wb = {"mixed": res.sheet.weight_bytes(),
          f"global ({res.start_bits} bits)": run.global_ledger.weight_bytes(),
          "uniform 8 bits": run.uniform8_ledger.weight_bytes()}
    print(f"mixed weight bytes: {wb}")
    check(wb["mixed"] <= run.global_ledger.weight_bytes(),
          "the mixed ledger is costlier than the global rung's")
    served = run.served
    toks = {k: [r.out_tokens for r in s.requests] for k, s in served.items()}
    for name, s in served.items():
        check(all(r.status == "done" and len(r.out_tokens) == mb.MAX_NEW
                  for r in s.requests), f"{name}: a request did not finish")
    check(toks["mixed"] == toks["dequant"]
          and torch.equal(served["mixed"].first_logits,
                          served["dequant"].first_logits),
          "the mixed tree's tokens or first logits differ from its "
          "dequantized tree's")
    check(fl["serve"]["paged_gather_pair"] > 0
          and fl["serve"]["paged_attention"] > 0
          and fl["serve"]["paged_gather"] == 0,
          f"serving the mixed tree launched {fl['serve']}")
    check(run.engine.serving_sheet.bits_by_layer() == res.bits,
          "the engine's ledger does not carry the searched bits")
    same = np.mean([a == b for x, y in zip(toks["reference"], toks["mixed"])
                    for a, b in zip(x, y)])
    for name, step in (("mixed", "serve"), ("dequant", "serve_dequant"),
                       ("reference", "serve_reference")):
        st, sm = served[name].stats, served[name].summary
        ttft = (f"; first token p50 {sm['p50_first_token_s']*1e3:.1f} ms "
                f"p99 {sm['p99_first_token_s']*1e3:.1f} ms"
                if name != "reference" else "")
        print(f"mixed serving ({name}): {sec[step]:.3f} s; prefill "
              f"{st['prefill_tokens']} tok in {st['prefill_s']:.3f} s, "
              f"decode {st['decode_tokens']} tok in {st['decode_s']:.3f} s "
              f"({st['decode_tokens']/st['decode_s']:.1f} tok/s){ttft}; "
              f"launches {fl[step]} [{CARD}]")
    print(f"mixed serving: ServeEngine tokens and first logits identical on "
          f"the mixed and the dequantized tree; ReferenceEngine's greedy "
          f"tokens equal to ServeEngine's: {same*100:.2f} % (not "
          f"required: it left-pads each batch to its longest prompt "
          f"unmasked, as the reference does, and attends through bf16 "
          f"flash, not paged attention)")
    print(f"mixed engine ledger: {run.engine.serving_sheet.to_dict()['totals']}")
    pd, (x_val, y_val) = run.pd, run.pd_val
    check(fl["pd_search"]["csd_qsweep"] > 0,
          f"the pendigits search launched no csd_qsweep: {fl['pd_search']}")
    t0 = time.perf_counter()
    pd_np = mixed_minq_search(run.pd_train.weights, run.pd_train.biases,
                              lx.ACTIVATIONS, x_val, y_val, backend="numpy",
                              device="cpu")
    t_np = time.perf_counter() - t0
    check((pd.qs, pd.ha, pd.base_ha, pd.q_star, pd.history) ==
          (pd_np.qs, pd_np.ha, pd_np.base_ha, pd_np.q_star, pd_np.history)
          and all(np.array_equal(a, b) for a, b in zip(
              pd.mlp.weights + pd.mlp.biases,
              pd_np.mlp.weights + pd_np.mlp.biases))
          and pd.sheet.to_dict() == pd_np.sheet.to_dict(),
          "mixed_minq_search differs between csd and numpy")
    print(f"mixed pendigits: q*={pd.q_star} ha {pd.base_ha:.3f} % -> qs "
          f"{pd.qs} ha {pd.ha:.3f} %, {len(pd.history)} rounds, weight "
          f"bytes {pd.sheet.weight_bytes()}; csd {sec['pd_search']:.3f} s "
          f"({fl['pd_search']['csd_qsweep']} csd_qsweep launches, routes "
          f"{dict(csd_qsweep_kernel.route_launches)}), numpy {t_np:.3f} s, "
          f"identical [{CARD}]")
    _print_shapes("mixed", seen)
    print(f"launches on the mixed path: {launches}")
    profile_phase(torch, run.engine, mb.requests_spec(run.cfg.vocab))
    return launches, run


def hybrid_prompts(vocab):
    """The hybrid serving phase's prompts: ``HYB_REQUESTS`` seeded token
    arrays of lengths in ``HYB_PROMPT_LENS``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(HYB_PROMPT_LENS[0], HYB_PROMPT_LENS[1] + 1,
                        HYB_REQUESTS)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def hybrid_prefill_len():
    """The first ReferenceEngine batch's padded prompt length."""
    return max(len(p) for p in hybrid_prompts(256000)[:HYB_BATCH])


def linear_scan_kernel_phase(torch):
    """The linear-scan kernel against its plain version on the card, bit
    for bit (int32 views: -0.0 is not +0.0), at the reference test's
    shapes on the route the rule picks and at the hybrid path's (the loss,
    the first prefill batch, a decode step) on every route; every route's
    time at those three shapes beside the bytes bound and the plain
    version's, the rule's route timed first and last."""
    from repro_torch.kernels.linear_scan import (ROUTES, linear_scan_kernel,
                                                 linear_scan_plain, route)
    W = 4096
    H_pre = hybrid_prefill_len()
    shapes = {"reference test": [(2, 64, 128), (1, 100, 70), (2, 256, 256)],
              "Model.loss": [(1, HYB_LOSS_SEQ, W)],
              "prefill, first batch": [(HYB_BATCH, H_pre, W)],
              "decode step": [(HYB_BATCH, 1, W)]}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(shape):
        a = torch.rand(shape, generator=gen, device="cuda") * 0.3 + 0.7
        x = torch.randn(shape, generator=gen, device="cuda") * 0.1
        return a, x

    def bits_equal(got, want):
        return torch.equal(got.view(torch.int32), want.view(torch.int32))

    rows = {}
    for label, group in shapes.items():
        for shape in group:
            a, x = inputs(shape)
            want = linear_scan_plain(a, x)
            rule = route(shape[1], shape[2], a.data_ptr(), x.data_ptr(),
                         a.data_ptr())
            hows = [rule] if label == "reference test" else \
                [rule] + [r for r in ROUTES if r != rule]
            for how in hows:
                got = linear_scan_kernel(a, x, how=how)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                check(bits_equal(got, want), f"linear_scan kernel ({how}) != "
                      f"plain version at {shape}: max abs err {err}")
            print(f"linear_scan {shape} ({label}): bit-exact against the "
                  f"plain version on {', '.join(hows)} (the rule's: {rule})")
            if label == "reference test":
                continue
            # distinct inputs per call, together at least twice the L2
            nbytes = 3 * 4 * int(np.prod(shape))
            sets = [inputs(shape)
                    for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
            times = {h: [] for h in hows}
            for how in hows + [rule]:
                ms, eager_ms = time_calls(
                    torch, lambda a, x, how=how: linear_scan_kernel(
                        a, x, how=how), sets, 5)
                times[how].append(ms)
                if how == rule:
                    rule_eager = eager_ms
            plain_ms, _ = time_calls(torch, linear_scan_plain, sets, 1)
            rows[label] = {"ms": times[rule][0], "eager_ms": rule_eager,
                           "plain_ms": plain_ms, "route": rule,
                           "routes_ms": times,
                           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                           "shape": shape, "sets": len(sets)}
            del sets
    for label, r in rows.items():
        print(f"linear_scan ({label}, {r['shape']}) [{CARD}]: {r['route']} "
              f"{' / '.join(f'{v*1e3:.2f}' for v in r['routes_ms'][r['route']])}"
              f" us on the card ({r['eager_ms']*1e3:.2f} us per eager call); "
              + ", ".join(f"{h} {v[0]*1e3:.2f} us" for h, v in
                          r["routes_ms"].items() if h != r["route"]) +
              f"; plain {r['plain_ms']*1e3:.2f} us, bound "
              f"{r['bound_ms']*1e3:.3f} us (bytes, "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of it); "
              f"{r['sets']} input sets")
    row = rows["Model.loss"]
    return {
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan.py:47",
        "max_abs_err": 0.0, "ms": row["ms"], "eager_ms": row["eager_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "library": "none: no single PyTorch call computes a first-order "
                   "linear recurrence",
        "shape": f"a, x (1, {HYB_LOSS_SEQ}, {W}) f32: one Model.loss RG-LRU "
                 f"layer, route {row['route']}; timed over {row['sets']} "
                 f"input sets",
        "routes_ms": {label: r["routes_ms"] for label, r in rows.items()},
        "prefill": {k: rows["prefill, first batch"][k]
                    for k in ("ms", "plain_ms", "bound_ms", "route")},
        "decode": {k: rows["decode step"][k]
                   for k in ("ms", "plain_ms", "bound_ms", "route")},
    }


def _qleaves(tree, path=""):
    """(path, qleaf) of a quantized tree, in its dict order."""
    if isinstance(tree, dict) and "q" in tree and "exp" in tree:
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qleaves(v, f"{path}/{k}" if path else k)


def qwen_weight_widths(torch):
    """qwen2-0.5b's int8-PoT tree at full width (random weights, seed 0,
    ``quantize_tree(bits=8)``): one layer's (K, N) int8 weights and (N,)
    exponents for each distinct (K, N), as {(K, N): (paths, w, exp)}."""
    from repro_torch.nn import Model, get_config
    from repro_torch.quant.ptq import quantize_tree
    params = Model(get_config("qwen2-0.5b"), device="cuda").init(0)
    qtree = quantize_tree(params, bits=8)
    del params
    widths = {}
    for path, leaf in _qleaves(qtree):
        check(leaf["bits"] == 8 and not leaf.get("packed"),
              f"{path}: not an int8 leaf")
        w = leaf["q"][0] if leaf["q"].ndim == 3 else leaf["q"]   # layer 0
        kn = tuple(w.shape)
        if kn in widths:
            widths[kn][0].append(path)
        else:
            widths[kn] = ([path], w.clone(), leaf["exp"].clone())
    return widths


def qmatmul_phase(torch):
    """The int8 power-of-two matmul: (a) the main path, the port's public
    op ``repro_torch.kernels.qmatmul`` at qwen2-0.5b's full widths, one
    call per distinct (K, N) of its int8-PoT tree at M = 8 (a decode step
    of 8 slots) and M = 512 (a 128 x 4 prefill chunk), its counters
    zeroed just before and read just after (every call on the TMA
    route), each result equal to its plain version and to x @ dequant(w)
    in float64 rounded once; (b) ptxas's registers and spills of the TMA
    route's instantiations (a spill fails the run) and their shared
    memory; (c) the kernel bit for bit against its plain version, f32 and
    bf16, on both routes where the shape allows the TMA route (the rule's
    route printed), at the reference tests' shapes, the kernel lane's,
    M = 1 and every qwen width, e across [-20, 20]; (d) its times at the
    projection and head widths (a step gathers rows of the embedding,
    never multiplies by it, so its width is checked, not timed) beside the
    bound, the plain version, the mma route at (512, 896, 4864) and
    (8, 4864, 896), and a library yardstick held equal to the plain
    version: ``torch._int_mm`` + the scale multiply, with w stored
    column-major once outside the timed calls (cuBLASLt's int8 GEMM wants
    B so); at M = 8, which ``_int_mm`` refuses (M <= 16), on x zero-padded
    to 32 rows outside the timed calls, its first 8 rows checked."""
    from repro_torch.kernels import build, qmatmul
    from repro_torch.kernels.ops import exp2_int
    from repro_torch.kernels.qmatmul import (qmatmul_kernel, qmatmul_plain,
                                             route, tiling, tma_smem_bytes)
    from repro_torch.quant.ptq import dequant
    qm = sys.modules["repro_torch.kernels.qmatmul"]
    t0 = time.perf_counter()
    widths = qwen_weight_widths(torch)
    torch.cuda.synchronize()
    print(f"qmatmul: qwen2-0.5b int8-PoT tree in "
          f"{time.perf_counter()-t0:.2f} s; widths (K, N): "
          + "; ".join(f"{kn} {paths}" for kn, (paths, _, _)
                      in widths.items()))
    rng = np.random.default_rng(0)

    def i8(shape):
        return torch.from_numpy(
            rng.integers(-128, 128, shape).astype(np.int8)).cuda()

    xs = {(M, K): i8((M, K)) for M in QM_M for K, _ in widths}

    # (a) the main path
    qmatmul_kernel.launches = 0
    qmatmul_kernel.route_launches = dict.fromkeys(qm.ROUTES, 0)
    outs = {(M, kn): qmatmul(xs[M, kn[0]], w, e)
            for M in QM_M for kn, (_, w, e) in widths.items()}
    torch.cuda.synchronize()
    launches = qmatmul_kernel.launches
    by_route = dict(qmatmul_kernel.route_launches)
    check(launches == len(outs), f"qmatmul: {launches} launches for "
          f"{len(outs)} calls of the op")
    check(by_route["tma"] == len(outs), f"qmatmul: routes {by_route} for "
          f"{len(outs)} calls, every qwen width on the TMA route")
    for (M, kn), y in outs.items():
        _, w, e = widths[kn]
        x = xs[M, kn[0]]
        check(y.shape == (M, kn[1]) and y.dtype == torch.float32
              and bool(torch.isfinite(y).all()),
              f"qmatmul op at M={M}, (K, N)={kn}: misshapen or not finite")
        check(torch.equal(y, qmatmul_plain(x, w, e)),
              f"qmatmul op != plain version at M={M}, (K, N)={kn}")
        deq = dequant({"q": w, "exp": e, "bits": 8}, dtype=torch.float64)
        check(torch.equal(y, (x.double() @ deq).float()),
              f"qmatmul op != x @ dequant(w) at M={M}, (K, N)={kn}")
    print(f"qmatmul op at qwen2-0.5b's widths, M = {QM_M}: {launches} "
          f"launches ({by_route}), each equal to the plain version and to "
          f"x @ dequant(w) in float64 rounded once; tilings (bm, split, "
          f"kt_per): " + "; ".join(
              f"{(M, *kn)} {tuple(tiling(M, *kn))}"
              for M in QM_M for kn in widths))
    del outs

    # (b) ptxas's report of the TMA route
    ptxas = {}
    for fn, line in ptxas_lines(build.build_log("qmatmul")):
        if fn.startswith("qmatmul_tma_kernel"):
            ptxas.setdefault(fn, []).append(line)
    check(len(ptxas) == 14, f"qmatmul: ptxas reports {sorted(ptxas)}")
    for fn, lines in sorted(ptxas.items()):
        spills = [int(n) for line in lines for n in re.findall(
            r"(\d+) bytes spill", line)]
        check(len(spills) == 2 and not any(spills),
              f"qmatmul {fn}: ptxas spills: {lines}")
        print(f"qmatmul {fn}: ptxas {'; '.join(lines)}")
    smem = {bm: tma_smem_bytes(bm) for bm in (8, 16, 32, 64)}
    print(f"qmatmul TMA route, dynamic shared memory a block by M tile: "
          f"{smem}")

    # (c) the kernel, bit for bit, on both routes
    cases = [(label, s) for label, group in QM_SHAPES.items() for s in group]
    cases += [("qwen width", (M, K, N)) for M in QM_M for K, N in widths]
    routes_seen = {}
    for label, (M, K, N) in cases:
        if label == "qwen width":
            x, (_, w, e) = xs[M, K], widths[K, N]
        else:
            x, w = i8((M, K)), i8((K, N))
            e = torch.from_numpy(
                rng.integers(-20, 21, N).astype(np.int32)).cuda()
        rule = route(K, N, x.data_ptr(), w.data_ptr())
        check(label != "qwen width" or rule == "tma",
              f"qmatmul {(M, K, N)}: a qwen width on the {rule} route")
        routes_seen[rule] = routes_seen.get(rule, 0) + 1
        for dt in (torch.float32, torch.bfloat16):
            got = qmatmul_kernel(x, w, e, out_dtype=dt)
            want = qmatmul_plain(x, w, e, dt)
            other = qm.launch(x, w, e, dt, "mma") if rule == "tma" else got
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"qmatmul kernel ({rule}) != "
                  f"plain version at {(M, K, N)} {dt} ({label})")
            check(torch.equal(other, want), f"qmatmul kernel (mma) != "
                  f"plain version at {(M, K, N)} {dt} ({label})")
        print(f"qmatmul {(M, K, N)} ({label}): route {rule}"
              f"{' ' + str(tuple(tiling(M, K, N))) if rule == 'tma' else ''}"
              f", bit-exact against the plain version, f32 and bf16"
              f"{', and so is the mma route' if rule == 'tma' else ''}")

    def int_mm_route(x, w, s):
        return torch._int_mm(x, w) * s

    def mma_route(x, w, e):
        return qm.launch(x, w, e, torch.float32, "mma")

    # (d) times at the projection and head widths, on distinct inputs over
    # twice the L2
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for M in QM_M:
        for (K, N), (paths, _, e0) in widths.items():
            if paths == ["embed"]:
                continue
            nbytes = M * K + K * N + 4 * N + 4 * M * N
            sets = [(torch.randint(-128, 128, (M, K), generator=gen,
                                   device="cuda", dtype=torch.int8),
                     torch.randint(-128, 128, (K, N), generator=gen,
                                   device="cuda", dtype=torch.int8),
                     e0) for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
            ms, eager_ms = time_calls(torch, qmatmul_kernel, sets, 5)
            plain_ms, _ = time_calls(torch, qmatmul_plain, sets, 1)
            mma_ms = None
            if (M, K, N) in QM_MMA_TIMED:
                mma_ms, _ = time_calls(torch, mma_route, sets, 5)
            # static weights, stored once the way the library wants; x
            # zero-padded to the 17 rows _int_mm takes at least, to 32
            pad = 32 - M if M <= 16 else 0
            lib_sets = [(torch.nn.functional.pad(x, (0, 0, 0, pad)),
                         w.t().contiguous().t(), exp2_int(-e))
                        for x, w, e in sets]
            lib_ms, _ = time_calls(torch, int_mm_route, lib_sets, 5)
            x, w, e = sets[0]
            check(torch.equal(int_mm_route(*lib_sets[0])[:M],
                              qmatmul_plain(x, w, e)),
                  f"_int_mm + scale != plain version at {(M, K, N)}")
            del lib_sets
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = 2 * M * K * N / INT8_OPS
            rows.append({
                "M": M, "K": K, "N": N, "leaves": paths, "ms": ms,
                "eager_ms": eager_ms, "plain_ms": plain_ms,
                "mma_ms": mma_ms, "library_ms": lib_ms,
                "library": (f"torch._int_mm on x zero-padded to 32 rows + "
                            f"scale" if pad else "torch._int_mm + scale"),
                "tiling": tuple(tiling(M, K, N)),
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "sets": len(sets)})
            del sets
    for r in rows:
        mma = (f", the mma route {r['mma_ms']*1e3:.2f} us"
               if r["mma_ms"] is not None else "")
        print(f"qmatmul ({r['M']}, {r['K']}, {r['N']}) {r['leaves']} "
              f"(bm, split, kt_per) {r['tiling']}: {r['ms']*1e3:.2f} us on "
              f"the card ({r['eager_ms']*1e3:.2f} us per eager call), "
              f"{100*r['bound_ms']/r['ms']:.1f} % of the bound "
              f"{r['bound_ms']*1e3:.2f} us ({r['bound_by']}){mma}, plain "
              f"{r['plain_ms']*1e3:.2f} us, {r['library']} "
              f"{r['library_ms']*1e3:.2f} us; {r['sets']} input sets "
              f"[{CARD}]")
    head = next(r for r in rows                 # (512, 896, 4864)
                if r["M"] == 512 and "layers/mlp/wg" in r["leaves"])
    row = {
        "name": "qmatmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qmatmul.cu",
        "replaces": "src/repro/kernels/qmatmul.py:48",
        "max_abs_err": 0.0,
        **{k: head[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "mma_ms")},
        "library": "torch._int_mm on w stored column-major, then the "
                   "scale multiply (two calls); at M = 8 on x zero-padded "
                   "to 32 rows",
        "shape": f"x ({head['M']}, {head['K']}) int8, w ({head['K']}, "
                 f"{head['N']}) int8, f32 out: a prefill chunk through "
                 f"layer 0's gate projection; timed over {head['sets']} "
                 f"input sets",
        "routes": by_route, "routes_in_checks": routes_seen,
        "ptxas": ptxas, "tma_smem_bytes": smem,
        "widths": [{k: r[k] for k in ("M", "K", "N", "tiling", "ms",
                                      "plain_ms", "mma_ms", "bound_ms",
                                      "bound_by", "library_ms")}
                   for r in rows]}
    return row, launches


def _numel(tree):
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def hybrid_phase(torch):
    """recurrentgemma-9b at full width and ``HYB_LAYERS`` of its 38 layers
    on the card, random weights from seed 0: (a) the f32 decode of token
    2101 against prefill(2101), past the window; (b) a 4096-token bf16
    ``Model.loss``; (c) ReferenceEngine
    serving 8 requests in bf16, then one more batch under the profiler.
    The kernel counters are zeroed just before (b) and read just after
    (c): the path's launches."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.linear_scan import linear_scan_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import ReferenceEngine, Request
    cfg = dataclasses.replace(get_config(HYB_ARCH), n_layers=HYB_LAYERS)
    n_units, rem = divmod(cfg.n_layers, 3)
    n_scan, n_flash = 2 * n_units + rem, n_units      # per forward
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = _numel(params)
    print(f"{HYB_ARCH} cut to {HYB_LAYERS} of 38 layers to keep the run "
          f"within its time budget: params {n:,} (f32 masters, "
          f"{n * 4 / 2**30:.2f} GiB), init {time.perf_counter()-t0:.2f} s")
    check(n == HYB_PARAMS, f"{n} parameters, the reference has {HYB_PARAMS} "
                           f"at {HYB_LAYERS} layers")

    def counts():
        return {"linear_scan": linear_scan_kernel.launches,
                "flash_attention": flash_attention_kernel.launches}

    def zero():
        linear_scan_kernel.launches = flash_attention_kernel.launches = 0
        linear_scan_kernel.route_launches = dict.fromkeys(
            linear_scan_kernel.route_launches, 0)

    def scan_routes():
        return {k: v for k, v in linear_scan_kernel.route_launches.items()
                if v}

    # (a) f32 decode vs prefill, past the window
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    S = HYB_DECODE_PROMPT
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, S + 1)) \
        .astype(np.int32)
    zero()
    t0 = time.perf_counter()
    want, _ = m32.prefill(params, {"tokens": toks})
    _, cache = m32.prefill(params, {"tokens": toks[:, :S]})
    check(cache["k"].shape[2] == cfg.local_window, "the ring is not W wide")
    got, _ = m32.decode_step(params, cache, toks[:, S:], S)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    launched = counts()
    print(f"hybrid f32: decode of token {S + 1} after prefill({S}) against "
          f"prefill({S + 1}): max abs diff {diff:.4e}, max |logit| "
          f"{scale:.4e} (tolerance {HYB_DECODE_REL} x max = "
          f"{HYB_DECODE_REL * scale:.4e}); {sec:.3f} s; launches {launched}, "
          f"linear_scan routes {scan_routes()}")
    check(bool(torch.isfinite(got).all()) and diff <= HYB_DECODE_REL * scale,
          "hybrid f32 decode disagrees with prefill")
    check(launched == {"linear_scan": 3 * n_scan,
                       "flash_attention": 2 * n_flash},
          f"hybrid f32 check launches {launched}")
    del m32, cache, want, got

    # (b) Model.loss, bf16, one 4096-token sequence
    m = Model(cfg, device="cuda")
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=HYB_LOSS_SEQ,
                          global_batch=1, seed=0).batch(0)
    m.loss(params, {k: v[:, :64] for k, v in batch.items()})   # warm-up
    torch.cuda.synchronize()
    zero()
    t0 = time.perf_counter()
    loss = float(m.loss(params, batch)[0])
    loss_s = time.perf_counter() - t0
    loss_launches = counts()
    # lm_head ~ N(0, 0.02^2) on unit-rms rows: logits ~ N(0, s2) and the
    # expected cross-entropy is ln V + s2 / 2
    s2 = 0.02 ** 2 * cfg.d_model
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"hybrid bf16 Model.loss (1 x {HYB_LOSS_SEQ}): {loss!r} (expected "
          f"ln V + s2/2 = {expect:.4f}, ln V = {np.log(cfg.vocab):.4f}); "
          f"{loss_s:.3f} s; launches {loss_launches}, linear_scan routes "
          f"{scan_routes()}")
    check(np.isfinite(loss) and abs(loss - expect) <= 0.2,
          f"hybrid loss {loss} far from {expect}")
    check(loss_launches == {"linear_scan": n_scan, "flash_attention": n_flash},
          f"hybrid loss launches {loss_launches}")
    loss_routes = scan_routes()
    check(loss_routes == {"ring": n_scan},
          f"hybrid loss linear_scan routes {loss_routes}")

    # (c) ReferenceEngine, bf16
    prompts = hybrid_prompts(cfg.vocab)
    eng = ReferenceEngine(cfg, params, max_batch=HYB_BATCH,
                          max_context=HYB_CONTEXT, eos_id=-1, device="cuda")
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=HYB_NEW)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()                          # the loss's and the serving's
    served = {k: v - loss_launches[k] for k, v in launches.items()}
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-len(reqs) // HYB_BATCH)
    check(all(r.status == "done" and len(r.out_tokens) == HYB_NEW
              for r in reqs), "a hybrid request did not finish its tokens")
    out = np.array([r.out_tokens for r in reqs])
    check(out.min() >= 0 and out.max() < cfg.vocab, "token out of range")
    check(served == {"linear_scan": n_batches * HYB_NEW * n_scan,
                     "flash_attention": n_batches * n_flash},
          f"hybrid serving launches {served}")
    served_routes = {k: v - loss_routes.get(k, 0)
                     for k, v in scan_routes().items()}
    check(set(served_routes) == {"ring", "step"},
          f"hybrid serving linear_scan routes {served_routes}: prefill "
          f"takes the ring, decode the step route")
    s = eng.stats
    print(f"hybrid ReferenceEngine (bf16, {HYB_BATCH} rows x {HYB_CONTEXT}): "
          f"{len(reqs)} requests in {wall:.3f} s, {n_batches} batches; "
          f"prefill {s['prefill_tokens']} tok in {s['prefill_s']:.3f} s "
          f"({s['prefill_tokens']/s['prefill_s']:.1f} tok/s); decode "
          f"{s['decode_tokens']} tok in {s['decode_s']:.3f} s "
          f"({s['decode_tokens']/s['decode_s']:.1f} tok/s); peak memory "
          f"{peak/2**30:.3f} GiB; launches {served}, linear_scan routes "
          f"{served_routes}")
    print(f"  first tokens {out[:, 0].tolist()}")

    # one more batch under the profiler
    more = [Request(rid=100 + i, prompt=p.copy(), max_new_tokens=HYB_NEW)
            for i, p in enumerate(prompts[:HYB_BATCH])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(more)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(all(r.status == "done" for r in more), "a profiled request failed")
    report_profile(prof, wall_us, "one hybrid ReferenceEngine batch", 12)
    print(f"launches on the hybrid path: {launches}")
    return launches


def paged_readings(torch, layouts):
    """The K+V pair gather and the split paged attention at each
    ``(label, Hq, Hkv)`` of ``layouts``, heads of 128, on the serving
    cell's 8 slots of mixed lengths in 32-token blocks with sentinel
    entries: the gather bit for bit against its plain version (its route
    printed), the attention in bf16 (atol ``ATTN_ATOL`` + rtol
    ``ATTN_RTOL``) and f32 (``FLASH_F32_TOL``), its split count and
    workspace printed; each timed in bf16 over 24 layers' pools beside the
    bound, the plain version and the library call (``index_select`` x 2
    for the gather).  Returns {"paged_gather": {label: reading},
    "paged_attention": {label: reading}}."""
    from repro_torch.kernels.paged_attention import (paged_attention_kernel,
                                                     paged_attention_plain,
                                                     splits,
                                                     workspace_bytes)
    from repro_torch.kernels.paged_gather import (paged_gather_pair_kernel,
                                                  paged_gather_plain)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    L, B, D, bs, C, P = 24, 8, 128, 32, 1024, 4
    nb = C // bs
    NB = B * nb
    lens = np.array([1, 33, 100, 257, 511, 640, 900, 1024], np.int32)
    tbl = rng.permutation(NB).reshape(B, nb).astype(np.int32)
    for b in range(B):
        tbl[b, -(-lens[b] // bs):] = NB                 # not granted: sentinel
    table = torch.from_numpy(tbl).cuda()
    clen = torch.from_numpy(lens).cuda()
    tbl_c = torch.clamp(table, max=NB - 1)
    g_tbl, g_cl = table[:P].long(), tbl_c[:P].long()
    flat = g_cl.reshape(-1)
    uniq = int(torch.unique(g_cl).numel())
    tokens = int(lens.sum())
    out = {"paged_gather": {}, "paged_attention": {}}
    for label, Hq, Hkv in layouts:
        kpool = torch.randn((L, NB, bs, Hkv, D), generator=gen,
                            device="cuda", dtype=dt)
        vpool = torch.randn((L, NB, bs, Hkv, D), generator=gen,
                            device="cuda", dtype=dt)
        q = torch.randn((B, 1, Hq, D), generator=gen, device="cuda",
                        dtype=dt)
        gk, gv = paged_gather_pair_kernel(kpool[0], vpool[0], g_tbl)
        check(torch.equal(gk, paged_gather_plain(kpool[0], g_cl))
              and torch.equal(gv, paged_gather_plain(vpool[0], g_cl)),
              f"paged_gather pair kernel != plain version at {label}'s heads")
        block_bytes = bs * Hkv * D * 2
        route = "bulk" if block_bytes % 16 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (kpool[0], vpool[0], gk, gv)) \
            else "vector"
        pair_sets = [(kpool[i], vpool[i], g_tbl) for i in range(L)]
        ms, eager_ms = time_calls(torch, paged_gather_pair_kernel, pair_sets,
                                  10)
        plain_ms, _ = time_calls(torch, lambda k, v, t: (
            paged_gather_plain(k, g_cl), paged_gather_plain(v, g_cl)),
            pair_sets, 5)
        lib_ms, _ = time_calls(torch, lambda k, v, t: (
            k.index_select(0, flat), v.index_select(0, flat)), pair_sets, 10)
        pair_bytes = 2 * (uniq + P * nb) * block_bytes + P * nb * 8
        out["paged_gather"][label] = {
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": pair_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": lib_ms, "max_abs_err": 0.0,
            "route": route,
            "shape": f"pools ({NB},{bs},{Hkv},{D}) bf16, K and V, table "
                     f"({P},{nb}) int64 with sentinels; route {route}, a "
                     f"block pair {2 * block_bytes:,} bytes"}

        S, c = splits(B, Hkv, nb)
        errs = {}
        for adt, atol, rtol in ((dt, ATTN_ATOL, ATTN_RTOL),
                                (torch.float32, FLASH_F32_TOL, 0.0)):
            qa, ka, va = (t.to(adt) for t in (q, kpool[0], vpool[0]))
            got = paged_attention_kernel(qa, ka, va, tbl_c, clen)
            want = paged_attention_plain(qa, ka, va, table, clen)
            torch.cuda.synchronize()
            errs[adt] = err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all())
                  and torch.allclose(got.float(), want.float(), atol=atol,
                                     rtol=rtol),
                  f"paged_attention kernel vs plain at {label}'s heads, "
                  f"{adt}: max abs err {err}")
            del qa, ka, va, got, want
        sets = [(q, kpool[i], vpool[i], tbl_c, clen) for i in range(L)]
        ms, eager_ms = time_calls(torch, paged_attention_kernel, sets, 10)
        plain_ms, _ = time_calls(torch, paged_attention_plain, sets, 1)
        a_bytes = (tokens * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                   + table.numel() * 4 + clen.numel() * 4)
        a_flops = 4 * Hq * D * tokens
        t_b, t_o = a_bytes / HBM_BYTES_PER_S, a_flops / BF16_FLOPS
        ws = workspace_bytes(B, Hq, D, S) if S > 1 else 0
        out["paged_attention"][label] = {
            "ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o) * 1e3,
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None, "max_abs_err": errs[dt],
            "f32_max_abs_err": errs[torch.float32], "splits": [S, c],
            "workspace_bytes": ws,
            "shape": f"q ({B},1,{Hq},{D}) bf16 (G = {Hq // Hkv}), pools "
                     f"({NB},{bs},{Hkv},{D}), lengths {lens.tolist()}; "
                     f"{S} splits of {c} blocks, workspace {ws:,} bytes"}
        del kpool, vpool, pair_sets, sets, q, gk, gv
        gc.collect()
        torch.cuda.empty_cache()
    for kname, rows in out.items():
        for label, r in rows.items():
            lib = "none" if r["library_ms"] is None \
                else f"{r['library_ms']*1e3:.2f} us"
            f32 = f", f32 {r['f32_max_abs_err']:.3e}" \
                if "f32_max_abs_err" in r else ""
            print(f"{kname} at {label} ({r['shape']}): {r['ms']*1e3:.2f} us "
                  f"on the card ({r['eager_ms']*1e3:.2f} us per eager call), "
                  f"plain {r['plain_ms']*1e3:.2f} us, bound "
                  f"{r['bound_ms']*1e3:.3f} us ({r['bound_by']}), library "
                  f"{lib}; max abs err {r['max_abs_err']:.3e}{f32} [{CARD}]")
    return out


def moe_kernel_readings(torch):
    """The attention path's kernels at the MoE cells' shapes, new to the
    card: the K+V pair gather and the split paged attention at qwen2-moe's
    16 / 16 heads of 128 and arctic's 56 / 8 (G = 7) (``paged_readings``),
    and flash at qwen2-moe's loss shape and first ReferenceEngine prefill
    batch, 16 / 16 heads of 128 (``flash_readings``)."""
    out = paged_readings(torch, ((MOE_ARCH, 16, 16), (ARCTIC_ARCH, 56, 8)))
    S_pre = hybrid_prefill_len()
    out["flash_attention"] = flash_readings(torch, MOE_ARCH, [
        ("loss", (MOE_LOSS_BATCH, MOE_LOSS_SEQ, MOE_LOSS_SEQ, 16, 16, 128),
         True, (torch.bfloat16,)),
        (f"prefill S={S_pre}", (HYB_BATCH, S_pre, S_pre, 16, 16, 128), True,
         (torch.bfloat16,))])
    return out


def cast_tree(tree, dtype):
    """Cast every tensor leaf of a dict tree to ``dtype`` in place of the
    old one, so each f32 leaf is freed as its copy lands."""
    for key, val in tree.items():
        if isinstance(val, dict):
            cast_tree(val, dtype)
        else:
            tree[key] = val.to(dtype)


def step_to_decode(eng):
    """Step ``eng`` until every submitted request is admitted and past its
    prefill, so that the steps after it are decode steps only."""
    while eng.queue or any(st.phase == "prefill"
                           for st in eng.slots.values()):
        eng.step()


def paged_counters():
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_gather import (paged_gather_kernel,
                                                  paged_gather_pair_kernel)
    return {"pairs": paged_gather_pair_kernel.launches,
            "one_leaf": paged_gather_kernel.launches,
            "attention": paged_attention_kernel.launches,
            "combine": paged_attention_kernel.combine_launches}


def zero_paged_counters():
    from repro_torch.kernels.paged_attention import paged_attention_kernel
    from repro_torch.kernels.paged_gather import (paged_gather_kernel,
                                                  paged_gather_pair_kernel)
    paged_gather_kernel.launches = paged_gather_pair_kernel.launches = 0
    paged_attention_kernel.launches = 0
    paged_attention_kernel.combine_launches = 0


class RouteProbe:
    """Stands in for ``blocks.moe_route`` during one engine run.  Without
    ``pinned`` it keeps the run's first call (the first prefill dispatch's
    layer 0: probabilities, K, C and the outputs) and every call's outputs
    in the first decode dispatch.  With ``pinned`` (a recording run's
    decode calls) each call of the first decode dispatch keeps the pinned
    experts, keep mask and slots, takes its gates from its own
    probabilities at those experts, and counts the experts its own
    probabilities pick that the pinned choice does not hold.  In bf16 the router's
    logits carry 8 mantissa bits and ties among the probabilities are
    real, so a rounding difference upstream flips a choice now and then,
    and one flip moves a row's output by the full size of an expert's."""

    def __init__(self, blocks, pinned=None):
        self.blocks, self.route, self.pinned = blocks, blocks.moe_route, pinned
        self.first, self.decode, self.flips = None, [], []
        self.in_decode = False          # set around the dispatch to probe

    def attach(self, eng):
        dispatch, seen = eng._decode, []

        def first_decode(toks, pos):
            self.in_decode = not seen
            seen.append(1)
            out = dispatch(toks, pos)
            self.in_decode = False
            return out
        eng._decode = first_decode
        self.blocks.moe_route = self

    def detach(self):
        self.blocks.moe_route = self.route

    def __call__(self, probs, K, C):
        import torch
        out = self.route(probs, K, C)
        if self.first is None:
            self.first = (probs.cpu().numpy(), K, C,
                          [t.cpu().numpy() for t in out])
        if not self.in_decode:
            return out
        if self.pinned is None:
            self.decode.append(out)
            return out
        _, idx, keep, slot = self.pinned[len(self.flips)]
        moved = ~(out[1][..., :, None] == idx[..., None, :]).any(-1)
        self.flips.append((int(moved.sum()), idx.numel()))
        gate = torch.gather(probs, -1, idx)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return gate, idx, keep, slot


MOE_SERVE = dict(max_batch=8, max_context=1024, kv_block_size=32,
                 prefill_chunk=128, prefill_batch=4, quant_bits=8)


def moe_routes_f32(torch, cfg, params, spec, label, *, quantized=False):
    """The fused and the take/dense route of ``ServeEngine`` in f32 on
    the f32 masters (dequantized to f32 with ``quantized``), on ``spec``'s
    first 8 requests cut to 2 new tokens: their first decode logits within
    ``LOGIT_REL_TOL`` x max |logit| and their greedy tokens equal.  In f32 the two routes' attention outputs differ by
    ~1e-7 and no expert choice flips; in bf16 the routes' one-ulp
    differences at layer 0 grow through the layers
    (``experiments/moe_route_divergence.py``), so this is the check that
    the routes compute the same function at full width."""
    import dataclasses
    from repro_torch.runtime.serve import ServeEngine
    c32 = dataclasses.replace(cfg, dtype="float32")
    short = [(p, 2) for p, _ in spec[:8]]
    out = {}
    for name, r in (("fused", dict(kv_gather="cuda", decode_kernel="fused")),
                    ("take/dense", dict(kv_gather="take",
                                        decode_kernel="dense"))):
        eng = ServeEngine(c32, params, eos_id=-1, device="cuda",
                          quantized=quantized, **MOE_SERVE, **r)
        reqs, _, wall, lg = run_engine(torch, eng, short, True)
        check(lg is not None and bool(torch.isfinite(lg).all()),
              f"{label} f32 {name}: first decode logits missing or not "
              f"finite")
        out[name] = ([r.out_tokens for r in reqs], lg, wall)
        del eng, reqs
        gc.collect()
        torch.cuda.empty_cache()
    (t_f, lg_f, w_f), (t_d, lg_d, w_d) = out["fused"], out["take/dense"]
    diff = (lg_f - lg_d).abs().max().item()
    scale = lg_d.abs().max().item()
    print(f"{label} f32, 8 requests, 2 new tokens: fused {w_f:.3f} s, "
          f"take/dense {w_d:.3f} s; first decode logits max abs diff "
          f"{diff:.4e} (max |logit| {scale:.4e}, tolerance {LOGIT_REL_TOL} x "
          f"max); greedy tokens {'identical' if t_f == t_d else 'differ'}")
    check(diff <= LOGIT_REL_TOL * scale,
          f"{label} f32: fused and dense first-decode logits disagree")
    check(t_f == t_d, f"{label} f32: fused and dense greedy tokens differ")


def moe_routes(torch, cfg, params, spec, label, *, quantized=False,
               warm=0, cuda_dense=False):
    """Serve ``spec`` on ``ServeEngine`` at the serving cell's settings:
    the fused route (``kv_gather="cuda"``, ``decode_kernel="fused"``)
    with its counters zeroed just before and read just after, then
    take/dense and, with ``cuda_dense``, cuda/dense (tokens and logits
    identical to take/dense).  The dense routes' first decode dispatch
    keeps the fused run's expert choices (``RouteProbe``): their own
    routers' flips and the first decode logits' distance from the fused
    route's are printed; ``moe_routes_f32`` holds the routes together.
    ``quantized``: each route's engine is built first from the f32
    masters, which are then dropped (``params`` is emptied).  Returns
    (the fused run's launches, its first ``moe_route`` call)."""
    from repro_torch.nn import blocks
    from repro_torch.runtime.serve import ServeEngine
    kw = dict(MOE_SERVE, quantized=quantized)
    routes = [("fused", dict(kv_gather="cuda", decode_kernel="fused")),
              ("take/dense", dict(kv_gather="take", decode_kernel="dense"))]
    if cuda_dense:
        routes.append(("cuda/dense", dict(kv_gather="cuda",
                                          decode_kernel="dense")))
    def build(name):
        return ServeEngine(cfg, params, eos_id=-1, device="cuda", **kw,
                           **dict(routes)[name])

    built = {}
    if quantized:
        t0 = time.perf_counter()
        built = {name: build(name) for name, _ in routes}
        torch.cuda.synchronize()
        eng = built["fused"]
        sheet = eng.serving_sheet
        print(f"{label}: quantized {len(routes)} engines in "
              f"{time.perf_counter()-t0:.2f} s; resident weights "
              f"(quant_bytes) "
              f"{eng.quant_bytes:,} B ({eng.quant_bytes/2**30:.3f} GiB); "
              f"serving ledger: {len(sheet)} quantized leaves, weight bytes "
              f"{sheet.weight_bytes():,.0f}, unquantized "
              f"{sheet.extra_bytes:,.0f}, total {sheet.total_bytes():,.0f} B,"
              f" ops per token {sheet.ops_per_token():,.0f}, arithmetic "
              f"intensity {sheet.arithmetic_intensity():.4f}")
        for row in sheet.row_strs():
            print(f"  {row}")
        params.clear()                          # the f32 masters go
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    elif warm:
        run_engine(torch, build("fused"), spec[:warm], False)
    runs, pinned = {}, None
    for name, _ in routes:
        eng = built.pop(name) if quantized else build(name)
        probe = RouteProbe(blocks, pinned)
        probe.attach(eng)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if name == "fused":
            zero_paged_counters()
        reqs, summ, wall, lg = run_engine(torch, eng, spec, True)
        probe.detach()
        if name == "fused":
            launches = check_fused_run(torch, label, cfg, eng, reqs, lg)
            first, pinned = probe.first, probe.decode
            check(len(pinned) == cfg.n_layers,
                  f"{label}: {len(pinned)} routing calls in the first decode "
                  f"dispatch")
        peak = torch.cuda.max_memory_allocated()
        s = eng.stats
        runs[name] = (reqs, lg)
        print(f"{label} {name}: {len(reqs)} requests in {wall:.3f} s; "
              f"prefill {s['prefill_tokens']} tok in {s['prefill_s']:.3f} s "
              f"({s['prefill_dispatches']} dispatches); decode "
              f"{s['decode_tokens']} tok in {s['decode_s']:.3f} s "
              f"({s['decode_steps']} steps, {summ['decode_tok_s']:.1f} tok/s, "
              f"{1e3*s['decode_s']/max(1, s['decode_steps']):.3f} ms a step); "
              f"first token p50 {summ['p50_first_token_s']*1e3:.1f} ms p99 "
              f"{summ['p99_first_token_s']*1e3:.1f} ms; total p50 "
              f"{summ['p50_total_s']*1e3:.1f} ms p99 "
              f"{summ['p99_total_s']*1e3:.1f} ms; peak memory "
              f"{peak/2**30:.3f} GiB [{CARD}]")
        if name == "fused":
            print(f"{label} launches on the fused run: {launches}; combine "
                  f"{paged_counters()['combine']}")
        else:
            flips = [f for f, _ in probe.flips]
            print(f"{label} {name}: its own router would have picked "
                  f"{sum(flips)} other experts of "
                  f"{sum(n for _, n in probe.flips)} choices in the first "
                  f"decode dispatch (by layer {flips}); pinned to the fused "
                  f"run's experts there")
        del eng
    (f_reqs, lg_f), (d_reqs, lg_d) = runs["fused"], runs["take/dense"]
    same = np.mean([a == b for r, q in zip(f_reqs, d_reqs)
                    for a, b in zip(r.out_tokens, q.out_tokens)])
    diff = (lg_f - lg_d).abs().max().item()
    scale = lg_d.abs().max().item()
    print(f"{label}: take/dense against fused: identical greedy tokens "
          f"{same*100:.2f} %; first decode logits (experts pinned) max abs "
          f"diff {diff:.4e}, {diff / scale:.4f} x max |logit| ({scale:.4e})")
    if cuda_dense:
        c_reqs, lg_c = runs["cuda/dense"]
        check(all(r.out_tokens == q.out_tokens
                  for r, q in zip(c_reqs, d_reqs))
              and torch.equal(lg_c, lg_d),
              f"{label}: the cuda gather changed the dense route's tokens "
              f"or logits")
        print(f"{label}: cuda/dense tokens and first decode logits identical "
              f"to take/dense")
    return launches, first


def check_fused_run(torch, label, cfg, eng, reqs, lg):
    """The fused / cuda-gather run's checks: every request done with its
    tokens, the K+V gathers all pairs, one a layer and prefill dispatch,
    one attention and one combine launch a layer and decode step, finite
    first decode logits.  Returns the run's paged-kernel launches."""
    n = paged_counters()
    s, L = eng.stats, cfg.n_layers
    check(all(r.status == "done" and len(r.out_tokens) == r.max_new_tokens
              for r in reqs), f"{label}: a request did not finish with its "
          f"tokens")
    check(n["one_leaf"] == 0 and n["pairs"] == s["prefill_dispatches"] * L,
          f"{label}: {n['pairs']} K+V pair and {n['one_leaf']} one-leaf "
          f"gathers for {s['prefill_dispatches']} prefill dispatches x {L} "
          f"layers")
    check(n["attention"] == s["decode_steps"] * L
          and n["combine"] == n["attention"],
          f"{label}: {n['attention']} attention and {n['combine']} combine "
          f"launches for {s['decode_steps']} decode steps x {L} layers")
    check(lg is not None and lg.shape == (eng.max_batch, 1, cfg.vocab)
          and bool(torch.isfinite(lg).all()),
          f"{label}: first decode logits missing, misshapen or not finite")
    toks = np.array([t for r in reqs for t in r.out_tokens])
    check(toks.min() >= 0 and toks.max() < cfg.vocab,
          f"{label}: token out of range")
    return {"paged_gather": n["pairs"], "paged_attention": n["attention"]}


def numpy_route(probs, K, C):
    """The routing recomputed in numpy: a stable argsort of -probs for the
    top K (the lower index first among equals), then each (token, k)
    pair's running count in its expert over the token-major flattening,
    the keep mask and the slot (drop slot E * C)."""
    B, S, E = probs.shape
    idx = np.argsort(-probs, axis=-1, kind="stable")[..., :K]
    flat = idx.reshape(B, S * K)
    onehot = flat[..., None] == np.arange(E)
    pos = (np.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    keep = pos < C
    return idx, keep, np.where(keep, flat * C + pos, E * C)


def moe_phase(torch):
    """The MoE family on the card: the kernels at its new shapes, then
    qwen2-moe-a2.7b at full width and ``MOE_SERVE_LAYERS`` of its 24
    layers, random weights from seed 0
    ((a) init and counts; (b) ServeEngine on three routes; (c) the
    routing of the first prefill dispatch's layer 0 against numpy; (d)
    ReferenceEngine; (e) one Model.loss), (f) the int8-PoT engine at 8 of
    24 layers and (g) arctic-480b's full-width layer on ServeEngine.
    Returns (the path's launches, the kernel readings)."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import ReferenceEngine, Request, ServeEngine
    readings = moe_kernel_readings(torch)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {"paged_gather": 0, "paged_attention": 0,
                "flash_attention": 0}

    def add(n):
        for k, v in n.items():
            launches[k] += v

    # (a) init at full width and MOE_SERVE_LAYERS in f32, then bf16 once
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = _numel(params)
    print(f"{MOE_ARCH} cut to {cfg.n_layers} of {full.n_layers} layers to "
          f"keep the run within its time budget: params {n:,} (f32 masters "
          f"{n * 4 / 2**30:.2f} GiB, init {time.perf_counter() - t0:.2f} "
          f"s); params_count() {cfg.params_count():,}, "
          f"active_params_count() {cfg.active_params_count():,} [{CARD}]")
    check(n == moe_leaves(cfg) and moe_leaves(full) == MOE_PARAMS,
          f"{n} parameters, by the reference's shapes {moe_leaves(cfg)}; "
          f"full depth {moe_leaves(full)}, the reference has {MOE_PARAMS}")
    spec = serving_spec(cfg.vocab)
    moe_routes_f32(torch, cfg, params, spec, MOE_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cast_tree(params, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"{MOE_ARCH}: bf16 {n * 2 / 2**30:.2f} GiB after one cast, "
          f"{time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB")

    # (b) ServeEngine on bf16 weights, the serving cell's requests
    t0 = time.perf_counter()
    n, rec = moe_routes(torch, cfg, params, spec, f"{MOE_ARCH} bf16",
                        warm=2, cuda_dense=True)
    add(n)
    print(f"{MOE_ARCH} ServeEngine routes: {time.perf_counter()-t0:.2f} s")
    eng = ServeEngine(cfg, params, eos_id=-1, device="cuda", max_batch=8,
                      max_context=1024, kv_block_size=32, prefill_chunk=128,
                      prefill_batch=4, kv_gather="cuda",
                      decode_kernel="fused")
    profile_phase(torch, eng, spec)
    for i, (p, _) in enumerate(spec[:8]):       # the host's share of a step
        eng.submit(Request(rid=200 + i, prompt=p.copy(), max_new_tokens=16))
    step_to_decode(eng)
    host_top(torch, lambda: [eng.step() for _ in range(4)], 15)
    while eng.queue or eng.slots:
        eng.step()
    del eng

    # (c) the fused run's first routing call (the first prefill dispatch's
    # layer 0) against numpy on the same probabilities
    probs, K, C, (_, idx, keep, slot) = rec
    w_idx, w_keep, w_slot = numpy_route(probs, K, C)
    srt = -np.sort(-probs, axis=-1)
    straddle = int((srt[..., K - 1] == srt[..., K]).sum())
    tied = int((srt[..., :-1] == srt[..., 1:]).any(-1).sum())
    print(f"{MOE_ARCH} routing (first prefill dispatch, layer 0): probs "
          f"{probs.shape}, K {K}, C {C}; {straddle} positions with a tie "
          f"straddling the top-{K} boundary, {tied} with any tie; kept "
          f"{int(keep.sum())} of {keep.size} pairs")
    check(np.array_equal(idx, w_idx) and np.array_equal(keep, w_keep)
          and np.array_equal(slot, w_slot),
          f"{MOE_ARCH}: moe_route on the card differs from numpy's "
          f"(ids {int((idx != w_idx).sum())}, keep "
          f"{int((keep != w_keep).sum())}, slots "
          f"{int((slot != w_slot).sum())} differ)")

    # (d) ReferenceEngine, the hybrid cell's batch and prompts
    prompts = hybrid_prompts(cfg.vocab)
    eng = ReferenceEngine(cfg, params, max_batch=HYB_BATCH,
                          max_context=HYB_CONTEXT, eos_id=-1, device="cuda")
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=HYB_NEW)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_flash = flash_attention_kernel.launches
    n_batches = -(-len(reqs) // HYB_BATCH)
    peak = torch.cuda.max_memory_allocated()
    check(all(r.status == "done" and len(r.out_tokens) == HYB_NEW
              for r in reqs), f"{MOE_ARCH}: a ReferenceEngine request did "
          f"not finish its tokens")
    out = np.array([r.out_tokens for r in reqs])
    check(out.min() >= 0 and out.max() < cfg.vocab, "token out of range")
    check(n_flash == n_batches * cfg.n_layers,
          f"{MOE_ARCH} ReferenceEngine: {n_flash} flash launches for "
          f"{n_batches} prefill calls x {cfg.n_layers} layers")
    s = eng.stats
    print(f"{MOE_ARCH} ReferenceEngine (bf16, {HYB_BATCH} rows x "
          f"{HYB_CONTEXT}): {len(reqs)} requests in {wall:.3f} s, "
          f"{n_batches} batches; prefill {s['prefill_tokens']} tok in "
          f"{s['prefill_s']:.3f} s ({s['prefill_tokens']/s['prefill_s']:.1f} "
          f"tok/s); decode {s['decode_tokens']} tok in {s['decode_s']:.3f} s "
          f"({s['decode_tokens']/s['decode_s']:.1f} tok/s); peak memory "
          f"{peak/2**30:.3f} GiB; flash launches {n_flash}; first tokens "
          f"{out[:, 0].tolist()} [{CARD}]")
    launches["flash_attention"] += n_flash
    del eng, reqs

    # (e) one Model.loss on an 8 x 1024 TokenPipeline batch
    m = Model(cfg, device="cuda")
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=MOE_LOSS_SEQ,
                          global_batch=MOE_LOSS_BATCH, seed=0).batch(0)
    m.loss(params, {k: v[:, :64] for k, v in batch.items()})   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    loss, mets = m.loss(params, batch)
    torch.cuda.synchronize()
    loss_s = time.perf_counter() - t0
    xent, aux = float(mets["xent"]), float(mets["aux"])
    n_flash = flash_attention_kernel.launches
    # lm_head ~ N(0, 0.02^2) on unit-rms rows: logits ~ N(0, s2) and the
    # expected cross-entropy is ln V + s2 / 2
    s2 = 0.02 ** 2 * cfg.d_model
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"{MOE_ARCH} bf16 Model.loss ({MOE_LOSS_BATCH} x {MOE_LOSS_SEQ}): "
          f"loss {float(loss)!r}, xent {xent!r} (expected ln V + s2/2 = "
          f"{expect:.4f}), aux {aux!r}; {loss_s:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB; flash "
          f"launches {n_flash} [{CARD}]")
    check(np.isfinite(float(loss)) and np.isfinite(aux) and aux > 0
          and abs(xent - expect) <= 0.2,
          f"{MOE_ARCH} loss: xent {xent} far from {expect} or aux {aux}")
    check(n_flash == cfg.n_layers,
          f"{MOE_ARCH} loss: {n_flash} flash launches, not one a layer")
    launches["flash_attention"] += n_flash
    del m, batch, params
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the int8-PoT engine at 8 of the 24 layers
    qcfg = dataclasses.replace(cfg, n_layers=MOE_QUANT_LAYERS)
    t0 = time.perf_counter()
    params = Model(qcfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = _numel(params)
    print(f"{MOE_ARCH} cut to {MOE_QUANT_LAYERS} of {full.n_layers} layers "
          f"for int8-PoT: {n:,} params ({n * 4 / 2**30:.2f} GiB f32), init "
          f"{time.perf_counter()-t0:.2f} s")
    check(n == MOE_QUANT_PARAMS,
          f"{n} parameters at {MOE_QUANT_LAYERS} layers, the reference has "
          f"{MOE_QUANT_PARAMS}")
    label = f"{MOE_ARCH} int8-PoT {MOE_QUANT_LAYERS} layers"
    moe_routes_f32(torch, qcfg, params, spec, label, quantized=True)
    add(moe_routes(torch, qcfg, params, spec, label, quantized=True)[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (g) arctic-480b, one layer at full width, bf16
    acfg = dataclasses.replace(get_config(ARCTIC_ARCH),
                               n_layers=ARCTIC_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(acfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = _numel(params)
    print(f"{ARCTIC_ARCH} cut to {ARCTIC_LAYERS} of 35 layers: {n:,} params "
          f"({n * 4 / 2**30:.2f} GiB f32), init "
          f"{time.perf_counter()-t0:.2f} s [{CARD}]")
    check(n == ARCTIC_PARAMS,
          f"{n} parameters, the reference's layer has {ARCTIC_PARAMS}")
    a_spec = serving_spec(acfg.vocab)[:ARCTIC_REQUESTS]
    moe_routes_f32(torch, acfg, params, a_spec, ARCTIC_ARCH)
    torch.cuda.reset_peak_memory_stats()
    cast_tree(params, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"{ARCTIC_ARCH}: bf16 {n * 2 / 2**30:.2f} GiB after one cast, peak "
          f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB")
    add(moe_routes(torch, acfg, params, a_spec,
                   f"{ARCTIC_ARCH} bf16 {ARCTIC_LAYERS} layer", warm=1)[0])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the MoE path was not launched: {launches}")
    print(f"launches on the MoE path: {launches}")
    return launches, readings


def wkv_bytes(B, S, H, hd, es=4):
    """Bytes a wkv6 call must move: r, k, v read once at ``es`` bytes an
    element (the dtype the call takes them in), w read and y written once
    (f32), u read, the state read and written once."""
    n = B * S * H * hd
    return 3 * es * n + 4 * (2 * n + H * hd + 2 * B * H * hd * hd)


def wkv_slots(B, S, H, hd):
    """FP32 issue slots the bit-exact recurrence needs: 4 a state entry a
    step (the update's two products and its add, unfused to match the
    plain version bit for bit, each a slot, and the output's FFMA), plus
    the step's scalar a_t = sum_i r_i u_i k_i (2 a key) and its term
    v_j a_t (1 a column)."""
    return B * S * H * (4 * hd * hd + 3 * hd)


def wkv6_kernel_readings(torch):
    """(a) The wkv6 kernel against its plain version on the card: ptxas's
    lines and the library's tiling for every hd (a spill fails); the
    final state bit for bit (int32 views), y within ``WKV_Y_TOL`` of its
    (b, t, h) row's max |y|, from a nonzero state, at ten shapes in f32
    and at the path's three with bf16 r, k, v as the bf16 path gives
    them; timed at those three, bf16 and f32, beside both bounds (FP32
    issue slots, bytes) and the plain version.  Returns the kernel's row
    of the ``kernels`` line (bf16 at the loss shape)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv6 import wkv6_kernel, wkv6_plain
    wkv6_mod = importlib.import_module("repro_torch.kernels.wkv6")
    H, hd = 40, 64
    build.build(["wkv6"])
    report, key = {}, None   # (route, hd, bf16) -> ptxas's lines
    for line in build.build_log("wkv6").splitlines():
        m = re.search(r"entry function '[^']*wkv6_(step_)?kernelILi(\d+)ELb"
                      r"([01])E", line)
        if m:
            key = ("step" if m.group(1) else "ring", int(m.group(2)),
                   int(m.group(3)))
        elif key and ("registers" in line or "spill" in line):
            report.setdefault(key, []).append(line.strip())
    for d in wkv6_mod.HEAD_DIMS:
        t = wkv6_mod.tiling(d)
        check(wkv6_mod.library_tiling(d) == t,
              f"wkv6 hd {d}: the library's tiling differs from tiling()")
        print(f"wkv6 hd {d}: {t}")
        for route in wkv6_mod.ROUTES:
            for bf16 in (0, 1):
                name = f"wkv6 {route} hd {d} {'bf16' if bf16 else 'f32'}"
                check((route, d, bf16) in report,
                      f"ptxas printed nothing for {name}")
                smem = (t.smem_bf16 if bf16 else t.smem_f32) \
                    if route == "ring" else 0
                for line in report[route, d, bf16]:
                    print(f"  ptxas {name} (dynamic shared {smem} B): "
                          f"{line}")
                    check(not any(int(n) for n in re.findall(
                        r"(\d+) bytes spill", line)),
                        f"{name} spills: {line}")
    paths = {"Model.loss": (RWKV_LOSS_BATCH, RWKV_LOSS_SEQ, H, hd),
             "prefill, first batch": (HYB_BATCH, hybrid_prefill_len(), H, hd),
             "decode step": (HYB_BATCH, 1, H, hd)}
    others = [(2, 63, 4, 16), (3, 1000, 40, 16), (1, 1, 20, 128),
              (2, 1000, 20, 128), (3, 63, 40, 64), (1, 1000, 40, 64),
              (2, 1, 7, 32)]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, hd, dtype=torch.float32):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
        w = torch.exp(-torch.exp(randn(B, S, H, hd) - 1.5))
        return r, k, v, w, randn(H, hd) * 0.5, randn(B, H, hd, hd)

    worst_abs, worst_rel = 0.0, 0.0
    cases = [(shape, torch.float32) for shape in
             list(paths.values()) + others]
    cases += [(shape, torch.bfloat16) for shape in paths.values()]
    for shape, dtype in cases:
        args = inputs(*shape, dtype)
        y, sS = wkv6_kernel(*args)
        torch.cuda.synchronize()
        wy, ws = wkv6_plain(*args)
        name = f"wkv6 {shape} {str(dtype)[6:]}"
        check(torch.equal(sS.view(torch.int32), ws.view(torch.int32)),
              f"{name}: final state differs from the plain version's "
              f"(max abs {(sS - ws).abs().max().item():.3e})")
        err = (y - wy).abs()
        rel = (err / wy.abs().amax(dim=-1, keepdim=True)).max().item()
        worst_abs = max(worst_abs, err.max().item())
        worst_rel = max(worst_rel, rel)
        check(bool(torch.isfinite(y).all()) and rel <= WKV_Y_TOL,
              f"{name}: y off the plain version's by {rel:.3e} of its "
              f"row's max |y| (tolerance {WKV_Y_TOL})")
        print(f"{name}: state bit-exact, y max abs err "
              f"{err.max().item():.3e}, {rel:.3e} of the row's max |y|")
        del args, y, sS, wy, ws
    rows = {}
    for label, shape in paths.items():
        for dtype in (torch.bfloat16, torch.float32):
            nbytes = wkv_bytes(*shape, torch.finfo(dtype).bits // 8)
            sets = [inputs(*shape, dtype)
                    for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
            ms, eager_ms = time_calls(torch, wkv6_kernel, sets, 5)
            # the plain loop eagerly (a graph of it would hold every
            # step's temporaries), six launches a token
            plain_ms = event_ms(torch, lambda: wkv6_plain(*sets[0]), 2)
            ms2, _ = time_calls(torch, wkv6_kernel, sets, 5)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            s_ms = wkv_slots(*shape) / F32_SLOTS_PER_S * 1e3
            rows[label, dtype] = {
                "ms": ms, "ms_again": ms2, "eager_ms": eager_ms,
                "plain_ms": plain_ms, "bound_ms": max(b_ms, s_ms),
                "bound_by": "bytes" if b_ms >= s_ms else "operations",
                "bytes_ms": b_ms, "slots_ms": s_ms, "shape": shape,
                "sets": len(sets)}
            del sets
    for (label, dtype), r in rows.items():
        print(f"wkv6 ({label}, {r['shape']}, r, k, v {str(dtype)[6:]}) "
              f"[{CARD}]: {r['ms']*1e3:.2f} / {r['ms_again']*1e3:.2f} us "
              f"on the card ({r['eager_ms']*1e3:.2f} us per eager call, "
              f"{r['ms']*1e3/r['shape'][1]:.4f} us a step); plain (eager) "
              f"{r['plain_ms']*1e3:.2f} us; bounds: FP32 issue slots "
              f"{r['slots_ms']*1e3:.2f} us, bytes {r['bytes_ms']*1e3:.2f} "
              f"us; the larger ({r['bound_by']}) "
              f"{100 * r['bound_ms'] / r['ms']:.1f} % of the time; "
              f"{r['sets']} input sets")
    row = rows["Model.loss", torch.bfloat16]
    return {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
        "replaces": "src/repro/nn/blocks.py:395",
        "replaces_note": "no Pallas kernel: the lax.scan of "
                         "rwkv_time_mix_seq",
        "max_abs_err": worst_abs, "max_rel_row_err": worst_rel,
        "ms": row["ms"], "eager_ms": row["eager_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes the WKV "
                   "recurrence",
        "shape": f"r, k, v bf16, w f32 ({RWKV_LOSS_BATCH}, "
                 f"{RWKV_LOSS_SEQ}, {H}, {hd}): one bf16 Model.loss time "
                 f"mix; timed over {row['sets']} input sets",
        "f32": {k: rows["Model.loss", torch.float32][k]
                for k in ("ms", "plain_ms", "bound_ms")},
        "prefill": {k: rows["prefill, first batch", torch.bfloat16][k]
                    for k in ("ms", "plain_ms", "bound_ms", "shape")},
        "decode": {k: rows["decode step", torch.bfloat16][k]
                   for k in ("ms", "plain_ms", "bound_ms", "shape")},
    }


def rwkv_phase(torch):
    """rwkv6-3b at full width and ``RWKV_LAYERS`` of its 32 layers on the
    card, random weights from seed 0: (b) the f32 decode of token 2101
    against prefill(2101); the int8-PoT engine built from the f32 masters,
    then one cast to bf16; (c)
    a bf16 8 x 1024 ``Model.loss``; (d) ReferenceEngine serving the hybrid
    phase's 8 prompts; (e) the int8-PoT engine on them; (f) one more bf16
    batch under the profiler.  The wkv6 counter is zeroed just before (c)
    and read just after (e): the path's launches."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.wkv6 import wkv6_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import ReferenceEngine, Request
    cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=RWKV_LAYERS)
    L = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = _numel(params)
    print(f"{RWKV_ARCH} cut to {L} of 32 layers to keep the run within its "
          f"time budget: params {n:,} (f32 masters {n * 4 / 2**30:.2f} GiB, "
          f"init {time.perf_counter() - t0:.2f} s); params_count() "
          f"{cfg.params_count():,} [{CARD}]")
    check(n == RWKV_PARAMS, f"{n} parameters, the reference has "
                            f"{RWKV_PARAMS} at {L} layers")

    # (b) f32 decode vs prefill
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    S = RWKV_DECODE_PROMPT
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, S + 1)) \
        .astype(np.int32)
    n0 = wkv6_kernel.launches
    t0 = time.perf_counter()
    want, _ = m32.prefill(params, {"tokens": toks})
    _, cache = m32.prefill(params, {"tokens": toks[:, :S]})
    check(set(cache) == {"state", "tm_prev", "cm_prev"} and
          cache["state"].dtype == torch.float32, "rwkv cache layout")
    got, _ = m32.decode_step(params, cache, toks[:, S:], S)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launched = wkv6_kernel.launches - n0
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"rwkv f32: decode of token {S + 1} after prefill({S}) against "
          f"prefill({S + 1}): max abs diff {diff:.4e}, max |logit| "
          f"{scale:.4e} ({diff / scale:.3e} of it; tolerance "
          f"{RWKV_DECODE_REL} x max); {sec:.3f} s; {launched} wkv6 launches")
    check(bool(torch.isfinite(got).all()) and diff <= RWKV_DECODE_REL * scale,
          "rwkv f32 decode disagrees with prefill")
    check(launched == 3 * L, f"rwkv f32 check: {launched} wkv6 launches")
    del m32, cache, want, got

    # the int8-PoT engine from the f32 masters, then bf16 once
    prompts = hybrid_prompts(cfg.vocab)
    kw = dict(max_batch=HYB_BATCH, max_context=HYB_CONTEXT, eos_id=-1,
              device="cuda")
    t0 = time.perf_counter()
    qeng = ReferenceEngine(cfg, params, quantized=True, **kw)
    torch.cuda.synchronize()
    sheet = qeng.serving_sheet
    print(f"{RWKV_ARCH} int8-PoT ReferenceEngine built in "
          f"{time.perf_counter() - t0:.2f} s; serving ledger: {len(sheet)} "
          f"quantized leaves, weight bytes {sheet.weight_bytes():,.0f}, "
          f"unquantized {sheet.extra_bytes:,.0f}, total "
          f"{sheet.total_bytes():,.0f} B, ops per token "
          f"{sheet.ops_per_token():,.0f}, arithmetic intensity "
          f"{sheet.arithmetic_intensity():.4f}")
    for row in sheet.row_strs():
        print(f"  {row}")
    floats = sorted(k for k, v in qeng.params["layers"].items()
                    if not isinstance(v, dict))
    check(floats == ["cm_mu", "ln_x", "mu", "u", "w0"],
          f"rwkv int8-PoT float leaves {floats}")
    t0 = time.perf_counter()
    cast_tree(params, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"{RWKV_ARCH}: bf16 {n * 2 / 2**30:.2f} GiB after one cast, "
          f"{time.perf_counter() - t0:.2f} s, peak so far "
          f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB")

    # (c) Model.loss, bf16, one 8 x 1024 batch
    m = Model(cfg, device="cuda")
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=RWKV_LOSS_SEQ,
                          global_batch=RWKV_LOSS_BATCH, seed=0).batch(0)
    m.loss(params, {k: v[:, :64] for k, v in batch.items()})   # warm-up
    torch.cuda.synchronize()
    wkv6_kernel.launches = 0
    wkv6_kernel.route_launches = dict.fromkeys(wkv6_kernel.route_launches, 0)
    t0 = time.perf_counter()
    loss, mets = m.loss(params, batch)
    xent = float(mets["xent"])
    loss_s = time.perf_counter() - t0
    loss_launches = wkv6_kernel.launches
    s2 = 0.02 ** 2 * cfg.d_model      # logits ~ N(0, s2) on unit-rms rows
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"rwkv bf16 Model.loss ({RWKV_LOSS_BATCH} x {RWKV_LOSS_SEQ}): xent "
          f"{xent!r} (ln V = {np.log(cfg.vocab):.4f}, ln V + s2/2 = "
          f"{expect:.4f}); {loss_s:.3f} s; {loss_launches} wkv6 launches")
    check(np.isfinite(xent) and abs(xent - expect) <= 0.2,
          f"rwkv loss {xent} far from {expect}")
    check(loss_launches == L, f"rwkv loss: {loss_launches} wkv6 launches")

    # (d) ReferenceEngine, bf16
    eng = ReferenceEngine(cfg, params, **kw)
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=HYB_NEW)
            for i, p in enumerate(prompts)]
    n_batches = -(-len(reqs) // HYB_BATCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    served = wkv6_kernel.launches - loss_launches
    peak = torch.cuda.max_memory_allocated()
    check(all(r.status == "done" and len(r.out_tokens) == HYB_NEW
              for r in reqs), "an rwkv request did not finish its tokens")
    out = np.array([r.out_tokens for r in reqs])
    check(out.min() >= 0 and out.max() < cfg.vocab, "token out of range")
    check(served == n_batches * HYB_NEW * L,
          f"rwkv serving: {served} wkv6 launches")
    st = eng.stats
    print(f"rwkv ReferenceEngine (bf16, {HYB_BATCH} rows x {HYB_CONTEXT}): "
          f"{len(reqs)} requests in {wall:.3f} s, {n_batches} batches; "
          f"prefill {st['prefill_tokens']} tok in {st['prefill_s']:.3f} s "
          f"({st['prefill_tokens']/st['prefill_s']:.1f} tok/s); decode "
          f"{st['decode_tokens']} tok in {st['decode_s']:.3f} s "
          f"({st['decode_tokens']/st['decode_s']:.1f} tok/s, "
          f"{1e3 * st['decode_s'] / (n_batches * (HYB_NEW - 1)):.3f} ms a "
          f"step); peak memory {peak/2**30:.3f} GiB; {served} wkv6 launches")
    print(f"  first tokens {out[:, 0].tolist()}")

    # (e) the int8-PoT engine on the same prompts
    qreqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=HYB_NEW)
             for i, p in enumerate(prompts)]
    n1 = wkv6_kernel.launches
    t0 = time.perf_counter()
    qeng.run(qreqs)
    torch.cuda.synchronize()
    qwall = time.perf_counter() - t0
    qserved = wkv6_kernel.launches - n1
    launches = wkv6_kernel.launches              # (c) + (d) + (e)
    routes = dict(wkv6_kernel.route_launches)
    check(routes["step"] == 2 * n_batches * (HYB_NEW - 1) * L and
          routes["ring"] == launches - routes["step"],
          f"rwkv path routes {routes}: a decode step on the step route, "
          f"every longer call on the ring")
    check(all(r.status == "done" and len(r.out_tokens) == HYB_NEW
              for r in qreqs), "an int8 rwkv request did not finish")
    check(qserved == n_batches * HYB_NEW * L,
          f"rwkv int8 serving: {qserved} wkv6 launches")
    qout = np.array([r.out_tokens for r in qreqs])
    same = float((qout == out).mean())
    qst = qeng.stats
    print(f"rwkv int8-PoT ReferenceEngine: {len(qreqs)} requests in "
          f"{qwall:.3f} s; prefill {qst['prefill_s']:.3f} s, decode "
          f"{qst['decode_tokens']} tok in {qst['decode_s']:.3f} s "
          f"({qst['decode_tokens']/qst['decode_s']:.1f} tok/s); "
          f"{100 * same:.2f} % of greedy tokens equal to bf16's (first "
          f"{float((qout[:, 0] == out[:, 0]).mean()) * 100:.1f} %); "
          f"{qserved} wkv6 launches")
    del qeng

    # (f) one more bf16 batch under the profiler
    more = [Request(rid=100 + i, prompt=p.copy(), max_new_tokens=HYB_NEW)
            for i, p in enumerate(prompts[:HYB_BATCH])]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(more)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    check(all(r.status == "done" for r in more), "a profiled request failed")
    busy, by_name = report_profile(prof, wall_us,
                                   "one rwkv ReferenceEngine batch", 12)
    wkv_us = sum(t for name, (t, _) in by_name.items() if "wkv6" in name)
    copy_us, copies = (sum(v) for v in zip(*(
        tn for name, tn in by_name.items() if "direct_copy" in name)))
    print(f"  wkv6: {wkv_us/1e3:.3f} ms, {100 * wkv_us / busy:.2f} % of the "
          f"device's busy time; direct copies (casts): {copy_us/1e3:.3f} ms "
          f"in {copies} calls")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launches on the rwkv path: wkv6 {launches} by route {routes} "
          f"(loss {loss_launches},"
          f" bf16 serving {served}, int8 serving {qserved})")
    return {"wkv6": launches, "wkv6 routes": routes}


def flash_readings(torch, arch, cases):
    """Flash at a path's shapes: each case ``(name, (B, Sq, Skv, Hq, Hkv,
    D), causal, dtypes)`` against its plain version in each dtype (f32
    within ``FLASH_F32_TOL`` with ``chunked_attention``'s key tile, bf16
    under ``bf16_disagreement`` at ``KEY_TILE``), offset 0 as
    ``chunked_attention`` passes it; then timed in the last dtype, in bf16
    beside the bound, the plain version and
    ``scaled_dot_product_attention``.  Returns {"arch name": reading}."""
    from repro_torch.kernels.flash_attention import (
        BF16_SHARE, KEY_TILE, bf16_disagreement, flash_attention_kernel,
        flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(shape, dtype):
        B_, Sq, Skv, Hq, Hkv, D_ = shape
        return [torch.randn(s, generator=gen, device="cuda", dtype=dtype)
                for s in ((B_, Sq, Hq, D_), (B_, Skv, Hkv, D_),
                          (B_, Skv, Hkv, D_))]

    out = {}
    for name, shape, causal, dtypes in cases:
        errs, extra = {}, {}
        for dt in dtypes:
            q, k, v = qkv(shape, dt)
            kw = dict(causal=causal, offset=0,
                      bk=min(512, shape[2]) if dt == torch.float32
                      else KEY_TILE)
            got = flash_attention_kernel(q, k, v, **kw)
            want = flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            errs[dt] = err = (got.float() - want.float()).abs().max().item()
            if dt == torch.float32:
                ok = torch.allclose(got, want, atol=FLASH_F32_TOL,
                                    rtol=FLASH_F32_TOL)
                tol = f"atol = rtol = {FLASH_F32_TOL}"
            else:
                ratio, share = bf16_disagreement(got, want)
                ok = ratio <= 1 and share <= BF16_SHARE
                tol = (f"largest err / limit {ratio:.3f}, share "
                       f"{share:.3e}")
                extra.update(bf16_ratio=ratio, bf16_share=share)
            check(ok and bool(torch.isfinite(got).all()),
                  f"flash_attention vs plain at {arch}'s {name} shape "
                  f"{shape} {dt}: max abs err {err}, {tol}")
            print(f"flash_attention {arch} {name} {shape} {dt}: max abs err "
                  f"{err:.3e} ({tol})")
            del q, k, v, got, want
        dt = dtypes[-1]
        if dt != torch.float32 and torch.float32 in errs:
            extra["f32_max_abs_err"] = errs[torch.float32]
        r = flash_timing(torch, qkv, shape, kw, 2, dt)
        B, Sq, Skv, Hq, Hkv, D = shape
        r.update(max_abs_err=errs[dt], **extra,
                 shape=f"q ({B},{Sq},{Hq},{D}), k/v ({B},{Skv},{Hkv},{D}) "
                       f"{str(dt).replace('torch.', '')} "
                       f"{'causal' if causal else 'non-causal'}")
        out[f"{arch} {name}"] = r
    for shape_name, r in out.items():
        if "plain_ms" not in r:
            print(f"flash_attention at {shape_name} ({r['shape']}, the f32 "
                  f"route on the CUDA cores): {r['ms']*1e3:.2f} us on the "
                  f"card ({r['eager_ms']*1e3:.2f} us per eager call) "
                  f"[{CARD}]")
            continue
        print(f"flash_attention at {shape_name} ({r['shape']}): "
              f"{r['ms']*1e3:.2f} us on the card ({r['eager_ms']*1e3:.2f} us "
              f"per eager call), plain {r['plain_ms']*1e3:.2f} us, bound "
              f"{r['bound_ms']*1e3:.3f} us ({r['bound_by']}, "
              f"{r['visible_pairs']} visible pairs a head), "
              f"scaled_dot_product_attention {r['library_ms']*1e3:.2f} us "
              f"[{CARD}]")
    return out


def audio_kernel_readings(torch):
    """Flash at whisper-base's shapes, new to the card: the encoder's
    non-causal MHA (16, 1500, 8 / 8 heads of 64: 1500 = 23 x 64 + 28, so
    every row ends on a partial key tile, and 11 x 128 + 92, so the last
    query block is partial), cross-attention of the decoder's 448 tokens
    against 1500 frames (Sq != Skv) and the decoder's causal 448, each in
    f32 and bf16 and timed in bf16 (``flash_readings``)."""
    B, H, D, F_, T = AUD_LOSS_BATCH, 8, 64, 1500, AUD_CONTEXT
    both = (torch.float32, torch.bfloat16)
    return flash_readings(torch, AUD_ARCH, [
        ("encoder", (B, F_, F_, H, H, D), False, both),
        ("cross", (B, T, F_, H, H, D), False, both),
        ("decoder", (B, T, T, H, H, D), True, both)])


def greedy_loop(torch, m, tree_fn, inputs, start, context, new, per_forward,
                label):
    """A greedy loop through ``Model.prefill`` / ``decode_step``, driven
    here, not by an engine: ``prefill`` of ``inputs`` (the prompts and the
    family's own entry) on ``tree_fn()``, k and v padded to ``context``,
    then ``new`` - 1 decode steps at positions ``start + t``, each token to
    the host.  Requires ``per_forward`` flash launches in the prefill and
    none in decode; prints the prefill's time, decode tok/s, a step's time
    and the peak memory.  Returns the (rows, new) tokens."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    rows = inputs["tokens"].shape[0]
    torch.cuda.reset_peak_memory_stats()
    n0 = flash_attention_kernel.launches
    t0 = time.perf_counter()
    logits, cache = m.prefill(tree_fn(), inputs)
    tok = logits[:, -1].argmax(-1)
    out = [tok.cpu()]
    prefill_s = time.perf_counter() - t0
    n1 = flash_attention_kernel.launches
    pad_kv(torch, cache, context)
    t0 = time.perf_counter()
    for t in range(new - 1):
        lg, cache = m.decode_step(tree_fn(), cache, tok[:, None], start + t)
        tok = lg[:, 0].argmax(-1)
        out.append(tok.cpu())                  # each token to the host
    decode_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(n1 - n0 == per_forward, f"{label} prefill: {n1 - n0} flash "
                                  f"launches, not {per_forward}")
    check(flash_attention_kernel.launches == n1, f"{label} decode launched "
                                                 f"flash")
    toks = torch.stack(out, 1).numpy()
    check(toks.shape == (rows, new) and toks.min() >= 0
          and toks.max() < m.cfg.vocab, f"{label} tokens")
    steps = new - 1
    print(f"{label} greedy loop ({rows} rows, prompts of "
          f"{inputs['tokens'].shape[1]} tokens decoded from position "
          f"{start}, {new} new, context {context}): prefill "
          f"{prefill_s * 1e3:.3f} ms; decode {rows * steps} tok in "
          f"{decode_s:.4f} s ({rows * steps / decode_s:.1f} tok/s, "
          f"{1e3 * decode_s / steps:.3f} ms a step); peak memory "
          f"{peak / 2**30:.3f} GiB")
    return toks


def pad_kv(torch, cache, context):
    """A prefill cache's k and v grown to ``context`` positions, as
    ``ReferenceEngine._pad_kv`` grows them; the cross leaves keep their
    frames."""
    for key in ("k", "v"):
        leaf = cache[key]
        cache[key] = torch.nn.functional.pad(
            leaf, (0, 0, 0, 0, 0, context - leaf.shape[2]))
    return cache


def audio_phase(torch):
    """whisper-base at full width and depth on the card, random weights
    from seed 0 and seeded frames: (b) the f32 decode of token 65 against
    prefill(65); the int8-PoT tree from the f32 masters, then one cast to
    bf16; (c) a bf16 16 x 448 ``Model.loss``; (d) a greedy serving loop
    through ``prefill`` / ``decode_step``, bf16 and int8-PoT; (e) one
    profiled window of bf16 decode steps.  The flash counter is zeroed
    just before (c) and read just after (d): the path's launches."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.quant.ptq import serving_ledger, serving_quant
    cfg = get_config(AUD_ARCH)
    per_forward = cfg.n_enc_layers + 2 * cfg.n_layers
    rng = np.random.default_rng(0)

    def frames(n):
        return torch.from_numpy(rng.normal(
            0.0, 1.0, (n, cfg.n_frames, cfg.d_model)).astype(np.float32)) \
            .cuda()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = _numel(params)
    print(f"{AUD_ARCH} params: {n:,} (f32 masters {n * 4 / 2**30:.3f} GiB, "
          f"init {time.perf_counter() - t0:.2f} s); params_count() "
          f"{cfg.params_count():,} [{CARD}]")
    check(n == AUD_PARAMS, f"{n} parameters, the reference has "
                           f"{AUD_PARAMS}")

    # (b) f32 decode against a longer prefill
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    S = AUD_DECODE_PROMPT
    toks = rng.integers(0, cfg.vocab, (2, S + 1)).astype(np.int32)
    fr = frames(2)
    t0 = time.perf_counter()
    want, _ = m32.prefill(params, {"tokens": toks, "frames": fr})
    _, cache = m32.prefill(params, {"tokens": toks[:, :S], "frames": fr})
    xshape = (cfg.n_layers, 2, cfg.n_frames, cfg.n_kv_heads, cfg.head_dim_)
    check(set(cache) == {"k", "v", "cross_k", "cross_v"}
          and tuple(cache["cross_k"].shape) == xshape
          and cache["k"].dtype == torch.float32, "audio cache layout")
    cross_k = cache["cross_k"].clone()
    got, cache = m32.decode_step(params, pad_kv(torch, cache, AUD_CONTEXT),
                                 toks[:, S:], S)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"audio f32: decode of token {S + 1} after prefill({S}) (k, v "
          f"padded to {AUD_CONTEXT}) against prefill({S + 1}): max abs diff "
          f"{diff:.4e}, max |logit| {scale:.4e} ({diff / scale:.3e} of it; "
          f"tolerance {AUD_DECODE_REL} x max); {sec:.3f} s")
    check(bool(torch.isfinite(got).all()) and diff <= AUD_DECODE_REL * scale,
          "audio f32 decode disagrees with prefill")
    check(torch.equal(cache["cross_k"], cross_k)
          and cache["k"].shape[2] == AUD_CONTEXT,
          "audio decode moved a cross leaf or resized k")
    del m32, cache, want, got, cross_k

    # the int8-PoT tree from the f32 masters, then bf16 once
    qtree, deq, resident = serving_quant(params, bits=8,
                                         dtype=torch.bfloat16)
    sheet = serving_ledger(params, bits=8, act_itemsize=2.0)
    print(f"{AUD_ARCH} int8-PoT: resident {resident:,} B; serving ledger "
          f"{len(sheet)} quantized leaves, weight bytes "
          f"{sheet.weight_bytes():,.0f}, unquantized "
          f"{sheet.extra_bytes:,.0f}, ops per token "
          f"{sheet.ops_per_token():,.0f}")
    cast_tree(params, torch.bfloat16)
    torch.cuda.synchronize()

    m = Model(cfg, device="cuda")
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=AUD_CONTEXT,
                          global_batch=AUD_LOSS_BATCH, seed=0).batch(0)
    batch["frames"] = frames(AUD_LOSS_BATCH)
    prompts = rng.integers(0, cfg.vocab, (AUD_SERVE_BATCH, AUD_PROMPT)) \
        .astype(np.int32)
    sfr = frames(AUD_SERVE_BATCH)
    # warm-up at the timed shapes: cuBLAS's picks, the allocator
    float(m.loss(params, batch)[0])
    for tree in (params, deq(qtree)):
        _, c = m.prefill(tree, {"tokens": prompts, "frames": sfr})
        m.decode_step(tree, pad_kv(torch, c, AUD_CONTEXT), prompts[:, :1],
                      AUD_PROMPT)
    del c
    torch.cuda.synchronize()

    # (c) Model.loss, bf16, 16 x 448 tokens and 1500 frames a row
    flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    loss, mets = m.loss(params, batch)
    xent = float(mets["xent"])
    loss_s = time.perf_counter() - t0
    loss_launches = flash_attention_kernel.launches
    s2 = 0.02 ** 2 * cfg.d_model      # logits ~ N(0, s2) on unit-rms rows
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"audio bf16 Model.loss ({AUD_LOSS_BATCH} x {AUD_CONTEXT}, "
          f"{cfg.n_frames} frames a row): xent {xent!r} (ln V = "
          f"{np.log(cfg.vocab):.4f}, ln V + s2/2 = {expect:.4f}), aux "
          f"{float(mets['aux'])}; {loss_s:.4f} s; {loss_launches} flash "
          f"launches")
    check(np.isfinite(xent) and abs(xent - expect) <= 0.2,
          f"audio loss {xent} far from {expect}")
    check(loss_launches == per_forward,
          f"audio loss: {loss_launches} flash launches, not {per_forward}")

    # (d) the greedy serving loop, bf16 then int8-PoT
    inputs = {"tokens": prompts, "frames": sfr}
    loop = (inputs, AUD_PROMPT, AUD_CONTEXT, AUD_NEW, per_forward)
    out = greedy_loop(torch, m, lambda: params, *loop, "audio bf16")
    qout = greedy_loop(torch, m, lambda: deq(qtree), *loop, "audio int8-PoT")
    launches = flash_attention_kernel.launches           # (c) + (d)
    check(launches == 3 * per_forward,
          f"audio path: {launches} flash launches, not {3 * per_forward}")
    same = float((qout == out).mean())
    print(f"  first tokens {out[:, 0].tolist()}; int8-PoT greedy tokens "
          f"equal to bf16's: {100 * same:.2f} % (first "
          f"{100 * float((qout[:, 0] == out[:, 0]).mean()):.1f} %)")

    # (e) profiled windows: one loss call, then bf16 decode steps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(m.loss(params, batch)[0])
        wall_us = (time.perf_counter() - t0) * 1e6
    busy, by_name = report_profile(prof, wall_us, f"one whisper-base bf16 "
                                   f"Model.loss, {AUD_LOSS_BATCH} x "
                                   f"{AUD_CONTEXT}", 10)
    fl_us = sum(t for name, (t, _) in by_name.items() if "flash" in name)
    print(f"  flash_attention: {fl_us / 1e3:.3f} ms, {100 * fl_us / busy:.2f}"
          f" % of the device's busy time")
    logits, cache = m.prefill(params, {"tokens": prompts, "frames": sfr})
    tok = logits[:, -1].argmax(-1)
    pad_kv(torch, cache, AUD_CONTEXT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(AUD_PROFILE_STEPS):
            lg, cache = m.decode_step(params, cache, tok[:, None],
                                      AUD_PROMPT + t)
            tok = lg[:, 0].argmax(-1)
            tok.cpu()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, f"{AUD_PROFILE_STEPS} whisper-base bf16 "
                                  f"decode steps, {AUD_SERVE_BATCH} rows", 10)
    del params, qtree, cache, m
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launches on the audio path: flash_attention {launches} (loss "
          f"{loss_launches}, bf16 prefill {per_forward}, int8-PoT prefill "
          f"{per_forward}, decode 0)")
    return {"flash_attention": launches}


def flash_ptxas(fn):
    """ptxas's lines for one flash instantiation (``fn``: the mangled name
    cut to its template arguments, as ``ptxas_lines`` gives it); a spill
    fails the run."""
    from repro_torch.kernels import build
    lines = [line for f, line in ptxas_lines(build.build_log(
        "flash_attention")) if f == fn]
    spills = [int(n) for line in lines
              for n in re.findall(r"(\d+) bytes spill", line)]
    check(len(spills) == 2 and not any(spills),
          f"flash_attention {fn}: ptxas spills: {lines}")
    return lines


def vlm_kernel_readings(torch):
    """Flash at llava-next-34b's shapes, new to the card: GQA 7:1 (56 / 8
    heads) at D = 128, causal.  The loss (2, 3904: 2880 patches and 1024
    tokens, 30 x 128 + 64, so the last query block is half full) and the
    greedy prefill (4, 2896) in bf16, each timed; the f32 check's prefill
    (1, 2945: 23 x 128 + 1, the last block one row) in f32, timed on its
    own (``flash_readings``).  ptxas's registers and spills of both D =
    128 instantiations; a spill fails the run."""
    ptxas = {}
    for route, fn in (("bfloat16", "flash_attention_wgmma_kernelILi128EE"),
                      ("float32", "flash_attention_kernelILi128EE")):
        ptxas[route] = flash_ptxas(fn)
        print(f"flash_attention {route} D = 128: ptxas "
              f"{' / '.join(ptxas[route])}")
    P, Hq, Hkv, D = 2880, 56, 8, 128
    out = flash_readings(torch, VLM_ARCH, [
        (name, (B, S, S, Hq, Hkv, D), True, (dt,)) for name, B, S, dt in (
            ("loss", VLM_LOSS_BATCH, P + VLM_LOSS_SEQ, torch.bfloat16),
            ("prefill", VLM_SERVE_BATCH, P + VLM_PROMPT, torch.bfloat16),
            ("f32 check prefill", 1, P + VLM_DECODE_PROMPT + 1,
             torch.float32))])
    out["ptxas D = 128"] = ptxas
    return out


def vlm_phase(torch):
    """llava-next-34b at full width and ``VLM_LAYERS`` of its 60 layers on
    the card, random weights from seed 0 and seeded patch embeddings: (b)
    the f32 decode of token 65 after a prefill of the patches and 64
    tokens (k and v padded to the context) against a prefill of the
    patches and 65;
    the int8-PoT tree from the f32 masters, then one cast to bf16; (c) a
    bf16 2 x 1024 ``Model.loss`` after the 2880 patches of each row; (d) a
    greedy loop through ``prefill`` / ``decode_step``, bf16 and int8-PoT;
    (e) one profiled window of 16 bf16 decode steps.  The flash counter
    is zeroed just before (c) and read just after (d): the path's
    launches."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.quant.ptq import serving_ledger, serving_quant
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    P = cfg.n_patches
    rng = np.random.default_rng(0)

    def patches(n):
        return torch.from_numpy(rng.normal(
            0.0, 1.0, (n, P, 1024)).astype(np.float32)).cuda()

    t0 = time.perf_counter()
    params = Model(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = _numel(params)
    print(f"{VLM_ARCH} params at {VLM_LAYERS} of {full.n_layers} layers: "
          f"{n:,} (f32 masters {n * 4 / 2**30:.3f} GiB, init "
          f"{time.perf_counter() - t0:.2f} s); params_count() at full depth "
          f"{full.params_count():,} [{CARD}]")
    check(n == VLM_PARAMS, f"{n} parameters, the reference has "
                           f"{VLM_PARAMS} at {VLM_LAYERS} layers")
    check(tuple(params["vision_proj"].shape) == (1024, cfg.d_model),
          "vision_proj layout")

    # (b) f32 decode against a longer prefill
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device="cuda")
    S = VLM_DECODE_PROMPT
    toks = rng.integers(0, cfg.vocab, (1, S + 1)).astype(np.int32)
    pe = patches(1)
    t0 = time.perf_counter()
    want, _ = m32.prefill(params, {"tokens": toks, "patch_embeds": pe})
    _, cache = m32.prefill(params, {"tokens": toks[:, :S],
                                    "patch_embeds": pe})
    check(set(cache) == {"k", "v"} and tuple(cache["k"].shape) == (
        VLM_LAYERS, 1, P + S, cfg.n_kv_heads, cfg.head_dim_)
        and cache["k"].dtype == torch.float32, "vlm cache layout")
    got, cache = m32.decode_step(params, pad_kv(torch, cache, VLM_CONTEXT),
                                 toks[:, S:], P + S)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"vlm f32: decode of token {S + 1} after prefill of {P} patches "
          f"and {S} tokens (k, v padded to {VLM_CONTEXT}) against prefill "
          f"of {P} + {S + 1}: max abs diff {diff:.4e}, max |logit| "
          f"{scale:.4e} ({diff / scale:.3e} of it; tolerance "
          f"{VLM_DECODE_REL} x max); {sec:.3f} s")
    check(bool(torch.isfinite(got).all()) and diff <= VLM_DECODE_REL * scale,
          "vlm f32 decode disagrees with prefill")
    check(cache["k"].shape[2] == VLM_CONTEXT, "vlm decode resized k")
    del m32, cache, want, got

    # the int8-PoT tree from the f32 masters, then bf16 once
    qtree, deq, resident = serving_quant(params, bits=8,
                                         dtype=torch.bfloat16)
    check(isinstance(qtree["vision_proj"], dict),
          "vision_proj left unquantized")
    sheet = serving_ledger(params, bits=8, act_itemsize=2.0)
    print(f"{VLM_ARCH} int8-PoT: resident {resident:,} B; serving ledger "
          f"{len(sheet)} quantized leaves, weight bytes "
          f"{sheet.weight_bytes():,.0f}, unquantized "
          f"{sheet.extra_bytes:,.0f}, ops per token "
          f"{sheet.ops_per_token():,.0f}; peak memory so far "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    cast_tree(params, torch.bfloat16)
    torch.cuda.synchronize()

    m = Model(cfg, device="cuda")
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=VLM_LOSS_SEQ,
                          global_batch=VLM_LOSS_BATCH, seed=0).batch(0)
    batch["patch_embeds"] = patches(VLM_LOSS_BATCH)
    prompts = rng.integers(0, cfg.vocab, (VLM_SERVE_BATCH, VLM_PROMPT)) \
        .astype(np.int32)
    spe = patches(VLM_SERVE_BATCH)
    _, labels, mask = m._embed_inputs(params, batch)
    check(labels.shape == mask.shape == (VLM_LOSS_BATCH, P + VLM_LOSS_SEQ)
          and float(mask[:, :P].sum()) == 0.0 and not labels[:, :P].any()
          and float(mask.sum()) == VLM_LOSS_BATCH * VLM_LOSS_SEQ,
          "vlm loss mask counts a patch position")
    del labels, mask
    # warm-up at the timed shapes: cuBLAS's picks, the allocator
    float(m.loss(params, batch)[0])
    for tree in (params, deq(qtree)):
        _, c = m.prefill(tree, {"tokens": prompts, "patch_embeds": spe})
        m.decode_step(tree, pad_kv(torch, c, VLM_CONTEXT), prompts[:, :1],
                      P + VLM_PROMPT)
    del c, tree
    torch.cuda.synchronize()

    # (c) Model.loss, bf16, 2 x 1024 tokens after 2880 patches a row
    flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    loss, mets = m.loss(params, batch)
    xent = float(mets["xent"])
    loss_s = time.perf_counter() - t0
    loss_launches = flash_attention_kernel.launches
    s2 = 0.02 ** 2 * cfg.d_model      # logits ~ N(0, s2) on unit-rms rows
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"vlm bf16 Model.loss ({VLM_LOSS_BATCH} x {VLM_LOSS_SEQ} tokens "
          f"after {P} patches a row): xent {xent!r} over the text "
          f"positions (ln V = {np.log(cfg.vocab):.4f}, ln V + s2/2 = "
          f"{expect:.4f}), aux {float(mets['aux'])}; {loss_s:.4f} s; "
          f"{loss_launches} flash launches")
    check(np.isfinite(xent) and abs(xent - expect) <= 0.2,
          f"vlm loss {xent} far from {expect}")
    check(loss_launches == VLM_LAYERS,
          f"vlm loss: {loss_launches} flash launches, not {VLM_LAYERS}")

    # (d) the greedy loop, bf16 then int8-PoT
    inputs = {"tokens": prompts, "patch_embeds": spe}
    loop = (inputs, P + VLM_PROMPT, VLM_CONTEXT, VLM_NEW, VLM_LAYERS)
    out = greedy_loop(torch, m, lambda: params, *loop, "vlm bf16")
    qout = greedy_loop(torch, m, lambda: deq(qtree), *loop, "vlm int8-PoT")
    launches = flash_attention_kernel.launches           # (c) + (d)
    check(launches == 3 * VLM_LAYERS,
          f"vlm path: {launches} flash launches, not {3 * VLM_LAYERS}")
    same = float((qout == out).mean())
    print(f"  first tokens {out[:, 0].tolist()}; int8-PoT greedy tokens "
          f"equal to bf16's: {100 * same:.2f} % (first "
          f"{100 * float((qout[:, 0] == out[:, 0]).mean()):.1f} %)")
    del qtree

    # (e) a profiled window of bf16 decode steps
    logits, cache = m.prefill(params, {"tokens": prompts,
                                       "patch_embeds": spe})
    tok = logits[:, -1].argmax(-1)
    pad_kv(torch, cache, VLM_CONTEXT)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(VLM_PROFILE_STEPS):
            lg, cache = m.decode_step(params, cache, tok[:, None],
                                      P + VLM_PROMPT + t)
            tok = lg[:, 0].argmax(-1)
            tok.cpu()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, f"{VLM_PROFILE_STEPS} llava-next-34b bf16 "
                                  f"decode steps, {VLM_SERVE_BATCH} rows, "
                                  f"{VLM_LAYERS} layers", 10)
    del params, cache, m
    gc.collect()
    torch.cuda.empty_cache()
    print(f"launches on the vlm path: flash_attention {launches} (loss "
          f"{loss_launches}, bf16 prefill {VLM_LAYERS}, int8-PoT prefill "
          f"{VLM_LAYERS}, decode 0)")
    return {"flash_attention": launches}


def dense_kernel_readings(torch):
    """The attention path's kernels at the dense configs' head layouts,
    new to the card at D = 128: the K+V pair gather at 2, 8 and 20 KV
    heads and the split paged attention at G = 8, 2 and 1 (16 / 2, 16 /
    8, 20 / 20; ``paged_readings``), and flash at each config's (8, 1024)
    loss shape, causal (``flash_readings``)."""
    from repro_torch.nn import get_config
    cfgs = [get_config(arch) for arch in DENSE_ARCHS]
    for cfg in cfgs:
        check(cfg.head_dim_ == 128, f"{cfg.name}: head_dim {cfg.head_dim_}")
    out = paged_readings(torch, [(c.name, c.n_heads, c.n_kv_heads)
                                 for c in cfgs])
    out["flash_attention"] = {}
    for c in cfgs:
        out["flash_attention"].update(flash_readings(torch, c.name, [
            ("loss", (DENSE_LOSS_BATCH, DENSE_LOSS_SEQ, DENSE_LOSS_SEQ,
                      c.n_heads, c.n_kv_heads, 128), True,
             (torch.bfloat16,))]))
    return out


def dense_routes(torch, cfg, params, spec, label, *, compare=True,
                 profile_steps=0):
    """The serving cell's ``ServeEngine`` on bf16 weights: the fused route
    (``kv_gather="cuda"``, ``decode_kernel="fused"``) with the paged
    counters zeroed just before and read just after (``check_fused_run``),
    with ``profile_steps`` a ``torch.profiler`` window over that many
    decode steps of a fresh batch on its engine; then, with ``compare``,
    take/dense (first decode logits within ``LOGIT_REL_TOL`` x max |logit|
    of the fused route's) and cuda/dense (tokens and logits identical to
    take/dense's).  Returns the fused run's launches."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import Request, ServeEngine
    routes = {"fused": dict(kv_gather="cuda", decode_kernel="fused"),
              "take/dense": dict(kv_gather="take", decode_kernel="dense"),
              "cuda/dense": dict(kv_gather="cuda", decode_kernel="dense")}
    if not compare:
        del routes["take/dense"], routes["cuda/dense"]

    def build(name):
        return ServeEngine(cfg, params, eos_id=-1, device="cuda",
                           **MOE_SERVE, **routes[name])

    run_engine(torch, build("fused"), [(p, 2) for p, _ in spec[:2]], False)
    weight_bytes = 2 * _numel(params)
    runs = {}
    for name in routes:
        eng = build(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if name == "fused":
            zero_paged_counters()
        reqs, summ, wall, lg = run_engine(torch, eng, spec, True)
        if name == "fused":
            launches = check_fused_run(torch, label, cfg, eng, reqs, lg)
        peak = torch.cuda.max_memory_allocated()
        s = eng.stats
        step_ms = 1e3 * s["decode_s"] / max(1, s["decode_steps"])
        runs[name] = (reqs, lg)
        print(f"{label} {name}: {len(reqs)} requests in {wall:.3f} s; "
              f"prefill {s['prefill_tokens']} tok in {s['prefill_s']:.3f} s "
              f"({s['prefill_dispatches']} dispatches); decode "
              f"{s['decode_tokens']} tok in {s['decode_s']:.3f} s "
              f"({s['decode_steps']} steps, {summ['decode_tok_s']:.1f} tok/s, "
              f"{step_ms:.3f} ms a step against {weight_bytes / 1e9:.2f} GB "
              f"of bf16 weights, "
              f"{weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at the memory "
              f"rate); first token p50 {summ['p50_first_token_s']*1e3:.1f} "
              f"ms p99 {summ['p99_first_token_s']*1e3:.1f} ms; total p50 "
              f"{summ['p50_total_s']*1e3:.1f} ms p99 "
              f"{summ['p99_total_s']*1e3:.1f} ms; peak memory "
              f"{peak/2**30:.3f} GiB [{CARD}]")
        if name == "fused":
            print(f"{label} launches on the fused run: {launches}; combine "
                  f"{paged_counters()['combine']}")
        if name == "fused" and profile_steps:
            for i, (p, _) in enumerate(spec[:8]):
                eng.submit(Request(rid=200 + i, prompt=p.copy(),
                                   max_new_tokens=profile_steps + 4))
            step_to_decode(eng)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(profile_steps):
                    eng.step()
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            busy, by_name = report_profile(
                prof, wall_us, f"{label}: {profile_steps} fused decode steps "
                               f"of 8 slots", 10)
            t = sum(v[0] for k, v in by_name.items()
                    if "paged_attention" in k)
            step_us = wall_us / profile_steps
            print(f"  paged_attention: {t/1e3:.3f} ms of {busy/1e3:.3f} ms "
                  f"busy ({100*t/busy:.2f} %); a step {step_us/1e3:.3f} ms "
                  f"under the profiler, {busy/1e3/profile_steps:.3f} ms busy "
                  f"[{CARD}]")
            while eng.queue or eng.slots:
                eng.step()
        del eng
    if not compare:
        return launches
    (f_reqs, lg_f), (d_reqs, lg_d) = runs["fused"], runs["take/dense"]
    same = np.mean([a == b for r, q in zip(f_reqs, d_reqs)
                    for a, b in zip(r.out_tokens, q.out_tokens)])
    diff = (lg_f - lg_d).abs().max().item()
    scale = lg_d.abs().max().item()
    print(f"{label}: take/dense against fused: identical greedy tokens "
          f"{same*100:.2f} %; first decode logits max abs diff {diff:.4e}, "
          f"{diff / scale:.4f} x max |logit| ({scale:.4e}; tolerance "
          f"{LOGIT_REL_TOL})")
    check(diff <= LOGIT_REL_TOL * scale,
          f"{label}: fused and dense first-decode logits disagree")
    c_reqs, lg_c = runs["cuda/dense"]
    check(all(r.out_tokens == q.out_tokens for r, q in zip(c_reqs, d_reqs))
          and torch.equal(lg_c, lg_d),
          f"{label}: the cuda gather changed the dense route's tokens or "
          f"logits")
    print(f"{label}: cuda/dense tokens and first decode logits identical to "
          f"take/dense")
    return launches


def dense_reference(torch, cfg, params, qeng, label):
    """``ReferenceEngine`` (4 rows x 2048, the hybrid cell's 8 prompts, 32
    new tokens) on the bf16 weights, then the int8-PoT engine ``qeng``
    (unless None) on the same prompts; one flash launch a layer and
    prefill batch each.  Returns the flash launches."""
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.runtime.serve import ReferenceEngine, Request
    prompts = hybrid_prompts(cfg.vocab)
    n_batches = -(-len(prompts) // HYB_BATCH)
    eng = ReferenceEngine(cfg, params, max_batch=HYB_BATCH,
                          max_context=HYB_CONTEXT, eos_id=-1, device="cuda")
    outs, total = {}, 0
    for name, e in (("bf16", eng), ("int8-PoT", qeng)):
        if e is None:
            continue
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=HYB_NEW)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_kernel.launches = 0
        t0 = time.perf_counter()
        e.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_flash = flash_attention_kernel.launches
        total += n_flash
        check(all(r.status == "done" and len(r.out_tokens) == HYB_NEW
                  for r in reqs), f"{label} {name} ReferenceEngine: a "
              f"request did not finish its tokens")
        out = outs[name] = np.array([r.out_tokens for r in reqs])
        check(out.min() >= 0 and out.max() < cfg.vocab, "token out of range")
        check(n_flash == n_batches * cfg.n_layers,
              f"{label} {name} ReferenceEngine: {n_flash} flash launches for "
              f"{n_batches} prefill calls x {cfg.n_layers} layers")
        s = e.stats
        same = "" if name == "bf16" else (
            f"; {100 * float((out == outs['bf16']).mean()):.2f} % of greedy "
            f"tokens equal to bf16's")
        print(f"{label} {name} ReferenceEngine ({HYB_BATCH} rows x "
              f"{HYB_CONTEXT}): {len(reqs)} requests in {wall:.3f} s, "
              f"{n_batches} batches; prefill {s['prefill_tokens']} tok in "
              f"{s['prefill_s']:.3f} s; decode {s['decode_tokens']} tok in "
              f"{s['decode_s']:.3f} s ({s['decode_tokens']/s['decode_s']:.1f}"
              f" tok/s); peak memory "
              f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB; flash "
              f"launches {n_flash}{same} [{CARD}]")
    return total


def dense_loss(torch, cfg, params, label):
    """One bf16 ``Model.loss`` on an 8 x 1024 ``TokenPipeline`` batch:
    xent within 0.2 of ln V + s2/2 and one flash launch a layer.  Returns
    the flash launches."""
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.nn import Model
    m = Model(cfg, device="cuda")
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=DENSE_LOSS_SEQ,
                          global_batch=DENSE_LOSS_BATCH, seed=0).batch(0)
    m.loss(params, {k: v[:, :64] for k, v in batch.items()})   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    loss, mets = m.loss(params, batch)
    xent = float(mets["xent"])
    loss_s = time.perf_counter() - t0
    n_flash = flash_attention_kernel.launches
    # lm_head ~ N(0, 0.02^2) on unit-rms rows: logits ~ N(0, s2) and the
    # expected cross-entropy is ln V + s2 / 2
    s2 = 0.02 ** 2 * cfg.d_model
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"{label} bf16 Model.loss ({DENSE_LOSS_BATCH} x {DENSE_LOSS_SEQ}): "
          f"xent {xent!r} (expected ln V + s2/2 = {expect:.4f}); "
          f"{loss_s:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB; flash "
          f"launches {n_flash} [{CARD}]")
    check(np.isfinite(float(loss)) and abs(xent - expect) <= 0.2,
          f"{label} loss: xent {xent} far from {expect}")
    check(n_flash == cfg.n_layers,
          f"{label} loss: {n_flash} flash launches, not one a layer")
    return n_flash


def dense_launcher(torch, arch):
    """``repro_torch.launch.serve.main`` at ``--arch <arch>`` with the
    serving cell's settings, int8-PoT, fused decode and the cuda gather:
    its summary lines printed, every request done, both paged kernels
    launched.  Returns their launches."""
    from repro_torch.launch import serve as launch_serve
    zero_paged_counters()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", arch] + DENSE_LAUNCHER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    n = paged_counters()
    for line in text.splitlines():
        print(f"  launcher {arch}: {line}")
    print(f"  launcher {arch}: {wall:.2f} s with init and quantization; "
          f"launches {n} [{CARD}]")
    check("served 16 requests" in text and "done=16 rejected=0 expired=0"
          in text, f"the launcher did not serve every {arch} request")
    check(n["pairs"] > 0 and n["one_leaf"] == 0 and n["attention"] > 0
          and n["combine"] == n["attention"],
          f"the {arch} launcher's paged launches: {n}")
    return {"paged_gather": n["pairs"], "paged_attention": n["attention"]}


def dense_leaves(cfg):
    """The leaves of ``Model(cfg).init`` for a dense config, by its shapes:
    per layer the attention (with the QKV bias where the config has it),
    the gated MLP and two norms; the embedding, the head and the final
    norm once."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    if cfg.qkv_bias:
        attn += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return cfg.n_layers * (attn + 3 * d * f + 2 * d) + 2 * cfg.vocab * d + d


def dense_phase(torch):
    """The dense configs on the card, each at full width and
    ``DENSE_SERVE_LAYERS`` (half its depth) with random weights from seed
    0, alone and freed before the next: (b) init (the reference's leaf
    count by its shapes), ``ServeEngine`` in f32 on the fused and
    take/dense routes (equal greedy tokens), the int8-PoT
    ``ReferenceEngine`` from the f32 masters, one cast to bf16; (c)
    ``ServeEngine`` in bf16 on three routes (``dense_routes``); (d)
    ``ReferenceEngine`` bf16 and int8-PoT and one ``Model.loss``; (e) the
    serve launcher.  The bf16 route comparisons, the profiled window and
    the int8-PoT ``ReferenceEngine`` run on qwen2.5-3b alone (G = 8, the
    layout new to the tensor-core route), to keep the run's time; the
    other two run the fused route with its counts, ``ReferenceEngine``,
    the loss and the launcher (at full depth).  Returns the path's
    launches."""
    import dataclasses
    from repro_torch.nn import Model, get_config
    from repro_torch.runtime.serve import ReferenceEngine
    launches = {"paged_gather": 0, "paged_attention": 0,
                "flash_attention": 0}

    def add(n):
        for k, v in n.items():
            launches[k] += v

    for i, arch in enumerate(DENSE_ARCHS):
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=DENSE_SERVE_LAYERS[arch])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = Model(cfg, device="cuda").init(0)
        torch.cuda.synchronize()
        n = _numel(params)
        print(f"{arch} params: {n:,} (f32 masters {n * 4 / 2**30:.2f} GiB, "
              f"init {time.perf_counter() - t0:.2f} s); params_count() "
              f"{cfg.params_count():,}; cut to {cfg.n_layers} of "
              f"{full.n_layers} layers to keep the run within its time "
              f"budget, heads {cfg.n_heads} / {cfg.n_kv_heads} of "
              f"{cfg.head_dim_}, rope theta {cfg.rope_theta:g}, QKV bias "
              f"{cfg.qkv_bias} [{CARD}]")
        check(n == dense_leaves(cfg)
              and dense_leaves(full) == DENSE_PARAMS[arch],
              f"{arch}: {n} parameters, by the reference's shapes "
              f"{dense_leaves(cfg)}; full depth {dense_leaves(full)}, the "
              f"reference has {DENSE_PARAMS[arch]}")
        spec = serving_spec(cfg.vocab)
        moe_routes_f32(torch, cfg, params, spec, arch)
        qeng = None
        if i == 0:
            t0 = time.perf_counter()
            qeng = ReferenceEngine(cfg, params, quantized=True,
                                   max_batch=HYB_BATCH,
                                   max_context=HYB_CONTEXT, eos_id=-1,
                                   device="cuda")
            torch.cuda.synchronize()
            sheet = qeng.serving_sheet
            print(f"{arch} int8-PoT ReferenceEngine built from the f32 "
                  f"masters in {time.perf_counter() - t0:.2f} s; serving "
                  f"ledger: {len(sheet)} quantized leaves, weight bytes "
                  f"{sheet.weight_bytes():,.0f}, unquantized "
                  f"{sheet.extra_bytes:,.0f}, total "
                  f"{sheet.total_bytes():,.0f} B")
        t0 = time.perf_counter()
        cast_tree(params, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"{arch}: bf16 {n * 2 / 2**30:.2f} GiB after one cast, "
              f"{time.perf_counter() - t0:.2f} s, peak so far "
              f"{torch.cuda.max_memory_allocated()/2**30:.3f} GiB")
        add(dense_routes(torch, cfg, params, spec, f"{arch} bf16",
                         compare=i == 0,
                         profile_steps=DENSE_PROFILE_STEPS if i == 0 else 0))
        launches["flash_attention"] += dense_reference(torch, cfg, params,
                                                       qeng, arch)
        launches["flash_attention"] += dense_loss(torch, cfg, params, arch)
        del qeng, params
        gc.collect()
        torch.cuda.empty_cache()
        add(dense_launcher(torch, arch))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{arch}: {time.perf_counter() - t_arch:.2f} s")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the dense path was not launched: {launches}")
    print(f"launches on the dense path: {launches}")
    return launches


def flash_bwd_bound_ms(B, Sq, Skv, Hq, Hkv, D, causal, window, offset,
                       es):
    """The backward's bound: five products of 2 * D flops a visible pair
    and head (S, dO V^T, dV, dK, dQ) at the bf16 peak, against reading q,
    k, v, out, dout and lse and writing dq, dk, dv once.  Returns (ms,
    "operations" or "bytes")."""
    pairs = visible_pairs(Sq, Skv, causal, window, offset)
    t_ops = 10 * D * pairs * Hq * B / BF16_FLOPS
    t_bytes = (es * (4 * B * Sq * Hq * D + 4 * B * Skv * Hkv * D)
               + 4 * B * Hq * Sq) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bwd_shape(shape):
    """A backward reading's ``shape`` as (B, Sq, Skv, Hq, Hkv, D): (B, S,
    Hq, Hkv, D) is self-attention, Sq = Skv = S."""
    if len(shape) == 5:
        B, S, Hq, Hkv, D = shape
        return B, S, S, Hq, Hkv, D
    return tuple(shape)


def bwd_inputs(torch, seed):
    """``inputs(shape, dt)``: q, k, v and dout at ``shape`` (``bwd_shape``)
    in ``dt`` from a card generator seeded with ``seed``, as
    ``bwd_agreement`` and ``flash_bwd_timing`` take them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def inputs(shape, dt):
        B, Sq, Skv, Hq, Hkv, D = bwd_shape(shape)
        return [torch.randn(s, generator=gen, device="cuda", dtype=dt)
                for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D),
                          (B, Sq, Hq, D))]
    return inputs


def bwd_agreement(torch, name, shape, dt, inputs, window=0, causal=True):
    """The flash backward through ``FlashAttention`` (``ops.flash_attention``
    under grad, ``causal``, ``window``, query row 0 at key position Skv -
    Sq as the model's attention places it) at ``shape`` (``bwd_shape``) in
    ``dt`` against autograd through the plain version: f32 within
    ``BWD_F32_TOL`` of each gradient's largest magnitude, bf16 under
    ``bf16_grad_disagreement``; two calls bit-identical.  Returns the
    reading's entries."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        BWD_BF16_MAX, BWD_BF16_MEAN, BWD_F32_TOL, KEY_TILE,
        bf16_grad_disagreement, flash_attention_plain)
    reading = {}
    _, Sq, Skv = bwd_shape(shape)[:3]
    kw = dict(causal=causal, window=window, offset=Skv - Sq)

    def kernel_grads(q, k, v, dout):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = ops.flash_attention(q, k, v, bk=512, **kw)
        return torch.autograd.grad(out, (q, k, v), dout)

    q, k, v, dout = inputs(shape, dt)
    got = kernel_grads(q, k, v, dout)
    again = kernel_grads(q, k, v, dout)
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = flash_attention_plain(
        qq, kk, vv, bk=512 if dt == torch.float32 else KEY_TILE, **kw)
    want = torch.autograd.grad(out, (qq, kk, vv), dout)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    errs = [(g.float() - w.float()).abs().max().item()
            for g, w in zip(got, want)]
    if dt == torch.float32:
        rel = [e / w.abs().max().item() for e, w in zip(errs, want)]
        ok = max(rel) <= BWD_F32_TOL
        tol = (f"largest err / largest |grad| {max(rel):.3e} (<= "
               f"{BWD_F32_TOL})")
    else:
        dis = [bf16_grad_disagreement(g, w) for g, w in zip(got, want)]
        mx, mean = max(d[0] for d in dis), max(d[1] for d in dis)
        ok = mx <= BWD_BF16_MAX and mean <= BWD_BF16_MEAN
        tol = (f"largest / mean err over largest / mean |grad| "
               f"{mx:.3e} / {mean:.3e} (<= {BWD_BF16_MAX} / "
               f"{BWD_BF16_MEAN})")
        reading.update(bf16_max_ratio=mx, bf16_mean_ratio=mean)
    key = str(dt).replace("torch.", "")
    reading[f"{key}_max_abs_err"] = max(errs)
    reading[f"{key}_deterministic"] = same
    print(f"flash_attention_bwd {name} {shape}"
          f"{f' window {window}' if window else ''}"
          f"{'' if causal else ' non-causal'} {key}: max abs err "
          f"dq / dk / dv {errs[0]:.3e} / {errs[1]:.3e} / {errs[2]:.3e} "
          f"against autograd through the plain version ({tol}); two runs "
          f"bit-identical: {same}")
    check(ok and finite and same,
          f"flash_attention_bwd {name} {key}: {tol}, finite {finite}, "
          f"deterministic {same}")
    return reading


def train_kernel_readings(torch):
    """Phase 15 (a): the flash backward kernels at qwen2-0.5b's loss shape
    (8, 1024, 14 / 2 heads of 64) and at D = 128 GQA 8:1 (qwen2.5-3b's 16
    / 2), causal: ptxas's registers and spills of every backward
    instantiation (a spill fails the run); through ``FlashAttention``
    against autograd through the plain version, f32 within
    ``BWD_F32_TOL`` of each gradient's largest magnitude and bf16 under
    ``bf16_grad_disagreement``; two backward calls bit-identical in each
    dtype; in bf16 the backward timed (CUDA-graph replays over input sets
    twice the L2) beside its bound, autograd's backward through the plain
    version and ``scaled_dot_product_attention``'s backward, each
    kernel's share from ``torch.profiler``; the forward at the loss shape
    timed with and without its lse.  Returns the ``flash_attention_bwd``
    row (without launches) and the forward's lse reading."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    ptxas = {}
    for fn, line in ptxas_lines(build.build_log("flash_attention_bwd")):
        ptxas.setdefault(fn, []).append(line)
    for fn, lines in ptxas.items():
        spills = [int(n) for line in lines
                  for n in re.findall(r"(\d+) bytes spill", line)]
        print(f"flash_attention_bwd {fn}: ptxas {' / '.join(lines)}")
        check(not any(spills), f"flash_attention_bwd {fn} spills: {lines}")
    check(len(ptxas) == 25, f"flash_attention_bwd: {len(ptxas)} "
                            f"instantiations in ptxas's log, not 25")
    inputs = bwd_inputs(torch, 0)

    shapes = {"qwen2-0.5b loss": (8, 1024, 14, 2, 64),
              "D = 128 GQA 8:1 loss": (8, 1024, 16, 2, 128)}
    row = {"shapes": {}}
    for name, shape in shapes.items():
        reading = {}
        for dt in (torch.float32, torch.bfloat16):
            reading.update(bwd_agreement(torch, name, shape, dt, inputs))
        reading.update(flash_bwd_timing(torch, inputs, shape))
        row["shapes"][name] = reading
    # the forward at the loss shape with and without its lse
    B, S, Hq, Hkv, D = shapes["qwen2-0.5b loss"]
    one = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    sets = [inputs(shapes["qwen2-0.5b loss"], torch.bfloat16)[:3]
            for _ in range(max(2, -(-2 * L2_BYTES // one)))]
    fwd = {}
    for lse in (False, True, True, False):
        ms, _ = time_calls(torch, lambda q, k, v: flash_attention_kernel(
            q, k, v, offset=0, bk=512, lse=lse), sets, 3)
        fwd.setdefault("with_lse_ms" if lse else "no_lse_ms", []).append(ms)
    print(f"flash_attention forward at the loss shape, bf16: "
          f"{' / '.join(f'{t*1e3:.2f}' for t in fwd['no_lse_ms'])} us "
          f"without lse, {' / '.join(f'{t*1e3:.2f}' for t in fwd['with_lse_ms'])}"
          f" us with it (order: without, with, with, without) [{CARD}]")
    loss = row["shapes"]["qwen2-0.5b loss"]
    row.update({
        "name": "flash_attention_bwd", "route": "cuda",
        "routes": {"bfloat16": "tensor cores: wgmma, a producer warp's "
                               "TMA ring of 3 stages, warp-specialised "
                               "consumers (setmaxnreg); dK/dV a block per "
                               "(key tile, query head, batch row), GQA's "
                               "head sum over a thread-block cluster",
                   "float32": "CUDA cores"},
        "kernels": {"bfloat16": ["dq (and delta)", "dk/dv"],
                    "float32": ["delta", "dk/dv", "dq"]},
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "none: src/repro/nn/layers.py:67 (chunked_attention, "
                    "differentiated by XLA's autodiff; no Pallas backward)",
        "max_abs_err": loss["bfloat16_max_abs_err"],
        "ms": loss["ms"], "plain_ms": loss["plain_ms"],
        "bound_ms": loss["bound_ms"], "bound_by": loss["bound_by"],
        "library_ms": loss["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention "
                   "(is_causal, enable_gqa), backward only: the device "
                   "time of every kernel it launches (torch.profiler)",
        "library_eager_ms": loss["library_eager_ms"],
        "library_backend": loss["library_backend"],
        "shape": "q (8,1024,14,64), k/v (8,1024,2,64) bf16 causal: one "
                 "Model.loss layer's gradient",
        "forward_lse": fwd,
    })
    return row


# the backward's bf16 kernels, by the names torch.profiler records (the dq
# kernel also writes delta)
FLASH_BWD_KERNELS = {"dq": "flash_bwd_dq_wgmma_kernel",
                     "dkdv": "flash_bwd_dkdv_wgmma_kernel"}


def sdpa_bwd_device_ms(torch, sets, reps, mask=None, causal=True):
    """``scaled_dot_product_attention``'s backward (``is_causal=causal``,
    or ``mask`` as its boolean ``attn_mask``; enable_gqa) as device time:
    ``reps`` rounds of ``torch.autograd.grad`` over the
    input sets (q, k, v, out, dout, lse), every kernel it launches (GQA's
    expand and sum included) timed by ``device_time_ms``; also the same
    calls timed eagerly with CUDA events (autograd's host time inside),
    the backend the dispatcher picks, and the kernels a profiled round
    shows.  Returns (device ms, eager ms, backend, kernel names)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend
    from torch.profiler import ProfilerActivity, profile
    calls = []
    sdpa = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    for q, k, v, _, dout, _ in sets:
        lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        lout = F.scaled_dot_product_attention(lq, lk, lv, enable_gqa=True,
                                              **sdpa)
        ldo = dout.transpose(1, 2).contiguous()
        calls.append(lambda lout=lout, xs=(lq, lk, lv), ldo=ldo:
                     torch.autograd.grad(lout, xs, ldo, retain_graph=True))
    backend = SDPBackend(torch._fused_sdp_choice(
        lq, lk, lv, enable_gqa=True, **sdpa)).name

    def round_():
        for c in calls:
            c()

    device_ms = device_time_ms(torch, round_, reps) / len(calls)
    eager_ms = event_ms(torch, round_, reps) / len(calls)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        round_()
        torch.cuda.synchronize()
    names = sorted({e.name for e in device_events(prof)})
    return device_ms, eager_ms, backend, names


def flash_bwd_timing(torch, inputs, shape, window=0, causal=True):
    """The backward's time in bf16 at ``shape`` (``bwd_shape``), ``causal``
    under ``window`` (SDPA takes it as a mask; query row 0 at key position
    Skv - Sq):
    the kernels over input sets together twice the L2, each kernel's
    device time (``device_time_ms`` of its launches through the C entry
    point on the first set), autograd's backward through the plain version
    and ``scaled_dot_product_attention``'s backward (device time of its
    kernels over the same sets, and eager)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        _bwd_entry, bwd_cluster, flash_attention_bwd_kernel,
        flash_attention_kernel, flash_attention_plain)
    B, Sq, S, Hq, Hkv, D = bwd_shape(shape)
    kw = dict(causal=causal, window=window, kv_len=S, offset=S - Sq)
    one = 2 * (4 * B * Sq * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * Sq
    sets = []
    for _ in range(max(2, -(-2 * L2_BYTES // one))):
        q, k, v, dout = inputs(shape, torch.bfloat16)
        out, lse = flash_attention_kernel(q, k, v, lse=True, **kw)
        sets.append((q, k, v, out, dout, lse))

    def bwd(q, k, v, out, dout, lse):
        return flash_attention_bwd_kernel(q, k, v, out, dout, lse, **kw)

    ms, eager_ms = time_calls(torch, bwd, sets, 3)
    cluster = bwd_cluster(
        B, Sq, S, Hq, Hkv, D, sms=torch.cuda.get_device_properties(0)
        .multi_processor_count, **kw)
    # each kernel alone, launched as the wrapper launches it: dq (which
    # writes delta) first, then dk/dv
    lib, _, fn = _bwd_entry()
    q, k, v, out, dout, lse = sets[0]
    delta = torch.empty_like(lse)
    grads = [torch.empty_like(t) for t in (q, k, v)]
    stream = torch.cuda.current_stream().cuda_stream

    def launch(which):
        build.check(lib, "flash_attention_bwd", fn(
            which, *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta)),
            *(g.data_ptr() for g in grads), B, Sq, S, Hq, Hkv, D, S,
            S - Sq, int(causal), window, D ** -0.5, 1, cluster, stream))

    parts = {"dq": device_time_ms(torch, lambda: launch(2), 10),
             "dkdv": device_time_ms(torch, lambda: launch(1), 10)}
    del delta, grads
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = flash_attention_plain(qq, kk, vv, bk=64, causal=causal,
                                window=window, offset=S - Sq)
    plain_ms = event_ms(torch, lambda: torch.autograd.grad(
        out, (qq, kk, vv), dout, retain_graph=True), 1)
    del out, qq, kk, vv
    mask = None
    if window:
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)
    lib_ms, lib_eager_ms, backend, lib_names = sdpa_bwd_device_ms(
        torch, sets, 3, mask, causal)
    del mask
    bound_ms, bound_by = flash_bwd_bound_ms(B, Sq, S, Hq, Hkv, D, causal,
                                            window, S - Sq, 2)
    print(f"flash_attention_bwd {shape}"
          f"{f' window {window}' if window else ''}"
          f"{'' if causal else ' non-causal'} bf16: {ms*1e3:.2f} us "
          f"on the card "
          f"({eager_ms*1e3:.2f} us per eager call; dq with delta / dk,dv "
          f"{parts['dq']*1e3:.2f} / {parts['dkdv']*1e3:.2f} us, clusters of "
          f"{cluster}), bound {bound_ms*1e3:.2f} us "
          f"({bound_by}, {100 * bound_ms / ms:.1f} %), plain autograd "
          f"{plain_ms*1e3:.2f} us; scaled_dot_product_attention backward "
          f"({backend}) {lib_ms*1e3:.2f} us of device time a call "
          f"({lib_eager_ms*1e3:.2f} us per eager call; kernels "
          f"{', '.join(n[:60] for n in lib_names)}) over {len(sets)} input "
          f"sets [{CARD}]")
    return {"ms": ms, "eager_ms": eager_ms, "kernel_ms": parts,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_eager_ms": lib_eager_ms, "library_backend": backend,
            "cluster": cluster,
            "bound_ms": bound_ms, "bound_by": bound_by, "sets": len(sets)}


def grads_card_vs_cpu(label, params, cpu_grads, card_grads):
    """Each leaf's largest difference between its gradient on the card
    and on the CPU, over the CPU's largest magnitude, computed on the card
    a leaf at a time; fails where one passes ``TRAIN_GRAD_TOL``.  Returns
    (the worst ratio, its leaf's path, every leaf's path)."""
    from repro_torch.tree import flatten_with_path
    worst, worst_path, names = 0.0, None, []
    for (path, _), c, g in zip(flatten_with_path(params), cpu_grads,
                               card_grads):
        name = "/".join(map(str, path))
        names.append(name)
        c = c.to(g.device)
        rel = (g - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_path = rel, name
        check(rel <= TRAIN_GRAD_TOL, f"{label} gradient {name}: card vs CPU "
              f"{rel:.3e} of its largest")
    check(len(names) == len(cpu_grads) == len(card_grads),
          f"{label}: {len(names)} leaves, {len(cpu_grads)} CPU gradients, "
          f"{len(card_grads)} card gradients")
    return worst, worst_path, names


def train_grad_check(torch):
    """Phase 15 (b): the f32 ``Model.loss`` gradient of qwen2-0.5b at full
    width and 2 layers (norms and biases seeded), B = 2, S = 256: the
    card's route (the flash kernels, forward and backward) against the
    same call on the CPU (the plain version under autograd), each leaf
    within ``TRAIN_GRAD_TOL`` of its largest magnitude."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.nn import Model, get_config
    from repro_torch.tree import flatten_with_path, leaves, tree_map
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2,
                              dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    rng = np.random.default_rng(0)
    for path, leaf in flatten_with_path(params):
        if path[-1].startswith("ln") or path[-1].endswith("norm") \
                or path[-1] in ("bq", "bk", "bv"):
            leaf.copy_(torch.from_numpy(
                rng.normal(0, 0.3, tuple(leaf.shape)).astype(np.float32)))
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=256, global_batch=2,
                          seed=0).batch(0)
    grads, losses, secs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        live = tree_map(lambda p: p.detach().to(dev).requires_grad_(),
                        params)
        f0 = flash_attention_kernel.launches
        b0 = flash_attention_bwd_kernel.launches
        t0 = time.perf_counter()
        loss, _ = Model(cfg, device=dev).loss(live, batch)
        grads[dev] = torch.autograd.grad(loss, leaves(live))
        if dev == "cuda":
            torch.cuda.synchronize()
            n = (flash_attention_kernel.launches - f0,
                 flash_attention_bwd_kernel.launches - b0)
        secs[dev] = time.perf_counter() - t0
        losses[dev] = float(loss.detach())
    worst, _, _ = grads_card_vs_cpu("train (b)", params, grads["cpu"],
                                    grads["cuda"])
    rel_loss = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"train (b): f32 Model.loss gradient, {TRAIN_ARCH} full width, 2 "
          f"layers, 2 x 256: loss card {losses['cuda']!r} CPU "
          f"{losses['cpu']!r} (rel {rel_loss:.3e}); every leaf within "
          f"{worst:.3e} of its largest magnitude (<= {TRAIN_GRAD_TOL}); "
          f"flash launches forward / backward {n[0]} / {n[1]} (remat: 2 a "
          f"layer forward); {secs['cpu']:.2f} s CPU, {secs['cuda']:.2f} s "
          f"card [{CARD}]")
    check(rel_loss <= 1e-5 and n == (2 * cfg.n_layers, cfg.n_layers),
          f"train (b): loss rel {rel_loss}, flash launches {n}")
    return {"worst_leaf_rel": worst, "loss_rel": rel_loss}


def train_launcher_run(torch):
    """Phase 15 (c): ``repro_torch.launch.train.main`` at qwen2-0.5b's full
    width and depth, 8 x 1024 bf16 batches, ``TRAIN_STEPS`` steps, the
    checkpoint into a temporary directory, removed after.  The flash
    counters zeroed just before and read just after: 48 forward launches
    a step (24 and 24 for remat) and 24 backward calls (each of its two
    bf16 kernels once); the first loss near ln V + s2/2; every loss and grad
    norm finite; the step's time (its median past the first), tokens/s,
    the 6 N D share of the bf16 peak and the peak memory.  Returns the
    launches."""
    import shutil
    import tempfile
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.launch import train as launch_train
    from repro_torch.nn import get_config
    cfg = get_config(TRAIN_ARCH)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            loop = launch_train.main([
                "--arch", TRAIN_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--ckpt-dir",
                ckpt, "--ckpt-every", "100", "--log-every", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_fwd = flash_attention_kernel.launches
        n_bwd = flash_attention_bwd_kernel.launches
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ckpt) for f in fs)
        saved = os.listdir(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = [r for r in loop.metrics_log if "loss" in r]
    for r in recs:
        print(f"  train {r}")
    steady = sorted(r["dt"] for r in recs[1:])
    step_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * cfg.params_count() * tokens / step_s / BF16_FLOPS
    s2 = 0.02 ** 2 * cfg.d_model
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"train (c): {TRAIN_ARCH} full width and depth through the "
          f"launcher, {TRAIN_BATCH} x {TRAIN_SEQ} bf16, {TRAIN_STEPS} "
          f"steps: step {step_s*1e3:.2f} ms (median of steps 1-"
          f"{TRAIN_STEPS - 1}; step 0 {recs[0]['dt']*1e3:.2f} ms), "
          f"{tokens / step_s:,.0f} tokens/s, 6 N D {100 * mfu:.2f} % of "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s (N = {cfg.params_count():,}); "
          f"loss {recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f} (step 0 "
          f"expected ln V + s2/2 = {expect:.4f}); peak memory {peak:.3f} "
          f"GiB; flash launches forward {n_fwd}, backward {n_bwd}; "
          f"checkpoint {saved} {ckpt_bytes / 2**30:.3f} GiB, removed; "
          f"{wall:.2f} s with init and the checkpoint [{CARD}]")
    check(len(recs) == TRAIN_STEPS and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in recs), f"train (c): records {recs}")
    check(abs(recs[0]["loss"] - expect) <= 0.2,
          f"train (c): first loss {recs[0]['loss']} far from {expect}")
    check(n_fwd == 2 * cfg.n_layers * TRAIN_STEPS
          and n_bwd == cfg.n_layers * TRAIN_STEPS,
          f"train (c): flash launches forward {n_fwd}, backward {n_bwd}")
    check(saved == [f"step_{TRAIN_STEPS - 1}"],
          f"train (c): checkpoint directory held {saved}")
    return {"flash_attention": n_fwd, "flash_attention_bwd": n_bwd}, {
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu_6nd": mfu, "peak_gib": peak}


def train_profile(torch):
    """Phase 15 (c'): one more full-width train step (qwen2-0.5b, 8 x 1024
    bf16, the launcher's optimizer) under ``torch.profiler``, after one
    untimed step: the device's busy share of the step and its top kernels,
    and the host's time in the step's parts (forward, backward, optimizer)
    from synchronized host clocks."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.nn import Model, get_config
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.step import make_train_step
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(TRAIN_ARCH)
    m = Model(cfg, device="cuda")
    params = m.init(0)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(3e-4, 20, 100))
    state = opt.init(params)
    step = make_train_step(m, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in pipe.batch(0).items()}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    # the step's parts on synchronized host clocks
    parts = {}
    t0 = time.perf_counter()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = m.loss(live, batch)
    torch.cuda.synchronize()
    parts["forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    parts["backward (remat's forward in it)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = iter(grads)
    opt.apply(params, state, tree_map(lambda _: next(it), params))
    torch.cuda.synchronize()
    parts["AdamW"] = time.perf_counter() - t0
    del live, loss, grads
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = report_profile(prof, wall * 1e6, "one train step", 14)
    bwd = {part: tuple(map(sum, zip((0.0, 0), *(
        v for n, v in by_name.items() if name in n))))
        for part, name in FLASH_BWD_KERNELS.items()}
    bwd_us = sum(t for t, _ in bwd.values())
    print(f"train (c'): the step's parts on synchronized host clocks: "
          + ", ".join(f"{k} {v*1e3:.1f} ms" for k, v in parts.items())
          + f"; profiled step {wall*1e3:.1f} ms, device busy "
            f"{busy/1e3:.1f} ms; the flash backward's kernels "
            f"{bwd_us/1e3:.3f} ms ({100 * bwd_us / busy:.2f} % of busy: "
          + ", ".join(f"{p} {t/1e3:.3f} ms in {n}" for p, (t, n)
                      in bwd.items()) + f") [{CARD}]")
    check(all(n == cfg.n_layers for _, n in bwd.values()),
          f"train (c'): flash backward kernels in the step {bwd}")
    return {"parts_ms": {k: v * 1e3 for k, v in parts.items()},
            "profiled_step_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "flash_bwd_ms": bwd_us / 1e3}


def train_restart_check(torch, arch=TRAIN_ARCH, label="train (d)",
                        exact=False, layers=2, cfg=None, pipe=None):
    """Phase 15 (d) (and 18 (f), ``arch`` qwen2-moe-a2.7b): ``TrainLoop``
    restart at ``arch``'s full width, ``layers`` layers, vocab 4096 (bf16
    on f32 masters), on 4 x 256 ``TokenPipeline`` batches -- or at
    ``cfg`` on ``pipe`` where given (phase 20 (d)) --, with
    ``torch.use_deterministic_algorithms`` on
    (``CUBLAS_WORKSPACE_CONFIG`` was set before the first cuBLAS call):
    ``RESTART_STEPS`` steps, a checkpoint every 4, a failure injected at
    step ``RESTART_FAIL``; every final leaf, params and optimizer state,
    and the loss of every step the restored run took, ``torch.equal`` to
    an uninterrupted run's.  Where an op refuses deterministic algorithms
    the runs go again without them, held to rtol 1e-6, or still exactly
    when ``exact``."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.nn import Model, get_config
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.step import make_train_step
    from repro_torch.runtime.train import TrainConfig, TrainLoop
    from repro_torch.tree import leaves, tree_map
    if cfg is None:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                  vocab=RESTART_VOCAB)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=256, global_batch=4)
    m = Model(cfg, device="cuda")
    params = m.init(0)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    step = make_train_step(m, opt)
    boom = {"armed": True}

    def failure_hook(s):
        if s == RESTART_FAIL and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    def runs():
        """Each run's final leaves, then a tensor of each step's loss (the
        restored run's last record of a step, which it took after the
        restore), and the second run's restarts."""
        out, restarts = [], None
        for hook in (None, failure_hook):
            d = tempfile.mkdtemp(prefix="chip_smoke_restart_")
            try:
                loop = TrainLoop(TrainConfig(
                    total_steps=RESTART_STEPS, ckpt_every=4, ckpt_dir=d,
                    log_every=1), step, pipe, failure_hook=hook)
                p, o = loop.run(tree_map(torch.clone, params),
                                tree_map(torch.clone, state))
                losses = {r["step"]: r["loss"] for r in loop.metrics_log
                          if "loss" in r}
                out.append(leaves({"p": p, "o": o}) + [torch.tensor(
                    [losses.get(i, float("nan"))
                     for i in range(RESTART_STEPS)], dtype=torch.float64)])
                restarts = loop.restarts
            finally:
                shutil.rmtree(d, ignore_errors=True)
            boom["armed"] = True
        return out, restarts

    torch.use_deterministic_algorithms(True)
    try:
        ends, restarts = runs()
        mode = "deterministic algorithms on"
    except RuntimeError as e:      # an op with no deterministic CUDA route
        if "deterministic" not in str(e):
            raise
        mode = f"deterministic algorithms refused: {str(e)[:300]}"
        ends = None
    finally:
        torch.use_deterministic_algorithms(False)
    if ends is None:
        print(f"{label}: {mode}; again without them, leaves held "
              f"{'bit for bit' if exact else 'to rtol 1e-6'}")
        ends, restarts = runs()
        equal = [torch.equal(a, b) if exact else
                 torch.allclose(a.float(), b.float(), rtol=1e-6, atol=0)
                 for a, b in zip(*ends)]
    else:
        equal = [torch.equal(a, b) for a, b in zip(*ends)]
    print(f"{label}: TrainLoop restart, {cfg.name} full width, "
          f"{cfg.n_layers} layers, vocab {cfg.vocab}, "
          f"{getattr(pipe, 'text', pipe).local_batch} rows a "
          f"step, {RESTART_STEPS} steps, failure at step {RESTART_FAIL}, "
          f"{mode}: {restarts} restart, {sum(equal[:-1])} of "
          f"{len(equal) - 1} final leaves and the losses of steps "
          f"0-{RESTART_STEPS - 1} (last {ends[1][-1][-1].item()!r}) "
          f"{'equal' if equal[-1] else 'NOT equal'} to the uninterrupted "
          f"run's [{CARD}]")
    check(restarts == 1 and all(equal),
          f"{label}: restarts {restarts}, leaves equal {equal}")


def train_tiny_check(torch):
    """Phase 15 (e): the tiny-train mirror on the card: 60 AdamW (3e-3)
    steps of the reduced qwen2-0.5b, vocab 64, on 8 x 32 batches (flash
    forward and backward at D = 16): the loss drops by more than 0.5."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.nn import Model, get_config
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.step import make_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(), vocab=64)
    m = Model(cfg, device="cuda")
    params = m.init(0)
    opt = AdamW(lr=3e-3)
    state = opt.init(params)
    step = make_train_step(m, opt)
    pipe = TokenPipeline(vocab=64, seq_len=32, global_batch=8)
    losses = []
    for i in range(60):
        params, state, mets = step(params, state, pipe.batch(i))
        losses.append(float(mets["loss"]))
    print(f"train (e): tiny train on the card, 60 steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (every 10th: "
          f"{[round(x, 4) for x in losses[::10]]})")
    check(losses[-1] < losses[0] - 0.5, f"train (e): losses {losses[::10]}")


def train_phase(torch):
    """Phase 15, training: (b)-(e) above, (c') after (c).  Returns the
    launches of (c), the main path, and (c)'s figures."""
    t0 = time.perf_counter()
    train_grad_check(torch)
    print(f"train (b): {time.perf_counter() - t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    launches, figures = train_launcher_run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    figures["profile"] = train_profile(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_restart_check(torch)
    train_tiny_check(torch)
    print(f"train (d), (e): {time.perf_counter() - t0:.2f} s")
    return launches, figures


def wkv_bwd_slots(B, S, H, hd):
    """FP32 issue slots the backward needs at least: 7 a state entry a step
    (forward in time the state's update fmaf(w, s, k v), 2, and dr', 1;
    backward G's update fmaf(w, g, r dy), 2, dv and dk', 1 each) and the
    steps' scalars and bonus terms (a_t, c_t, the u terms of dr, dk, dv
    and du), 10 a key."""
    return B * S * H * (7 * hd * hd + 10 * hd)


def wkv_bwd_bytes(B, S, H, hd, es=2):
    """Bytes the backward must move: r, k, v read at ``es`` bytes an
    element, w and dy read and dr, dk, dv, dlw written in f32, u read and
    du written, s0 and the final state's gradient read and ds0 written."""
    n = B * S * H * hd
    return 3 * es * n + 4 * (6 * n + 2 * H * hd + 3 * B * H * hd * hd)


def wkv_bwd_pass_floors(B, S, H, hd, es=2):
    """The two-pass design's own floor, seconds: (pass A's FP32 issue
    slots, its bytes, pass B's slots, its bytes).  Pass A: 3 slots a state
    entry a step, c_t and dr's bonus 3 a key; reads k, v at ``es`` bytes,
    w and dy, s0 and dsT, writes dr.  Pass B: 4 a state entry a step; a_t,
    the bonus terms of dk and dv, du and the walk of log w's gradient 11 a
    key; reads r, k, v, w, dy and dr again, dsT, writes dk, dv, dlw and
    ds0."""
    n, st = B * S * H * hd, B * H * hd * hd
    return (B * S * H * (3 * hd * hd + 3 * hd) / F32_SLOTS_PER_S,
            (2 * es * n + 4 * (3 * n + 2 * st)) / HBM_BYTES_PER_S,
            B * S * H * (4 * hd * hd + 11 * hd) / F32_SLOTS_PER_S,
            (3 * es * n + 4 * (6 * n + 2 * st)) / HBM_BYTES_PER_S)


def wkv_bwd_passes(torch):
    """The backward's passes alone, for timing each: ``passes(bufs, n)``
    is a function of (i, r, k, v, w, u, s0, dy, dsT) that runs them
    through the library's ``wkv6_bwd_passes`` (n = 1 pass A, 2 pass B and
    the sum, 3 both) into ``bufs[i]`` (``wkv6._bwd_buffers``), uncounted."""
    from repro_torch.kernels import build
    wk = importlib.import_module("repro_torch.kernels.wkv6")
    lib, _ = wk._bwd_entry()

    def passes(bufs, n):
        def call(i, r, k, v, w, u, s0, dy, dsT):
            B, S, H, hd = r.shape
            build.check(lib, "wkv6_bwd", lib.wkv6_bwd_passes(
                *wk._bwd_pointers((r, k, v, w, u, s0, dy), dsT, bufs[i]), B,
                S, H, hd, int(r.dtype == torch.bfloat16), n,
                torch.cuda.current_stream().cuda_stream))
        return call
    return passes


def wkv6_bwd_readings(torch):
    """Phase 16 (a): the wkv6 backward against its plain version on the
    card.  ptxas's registers and spills of every kernel (a spill in pass A
    or B at hd = 64, the path's width, fails) and the library's tiling
    against ``wkv6.bwd_tiling``; every gradient within ``WKV_BWD_TOL`` of
    its largest magnitude, the gradient of log w against w dw, from a
    nonzero state, at every hd and S in {1, 16, 37, 1024} (the loss shape
    (8, 1024, 40, 64) at hd 64), f32 and bf16 r, k, v, with and without
    the final state's gradient, two calls bit-identical; w underflowing to
    0 on every other key; through ``Wkv6`` on log w at the loss shape in
    bf16, dr, dk, dv within one bf16 ulp of the plain version's f32
    values, rounded, plus ``WKV_BWD_TOL``; bf16 and f32 timed at the loss
    shape, the whole call and each pass alone, beside the bound, the
    two-pass floor and autograd through ``wkv6_plain``, and hd 128 (a
    cluster a chain) once in bf16 at the same width.  Returns the kernel's
    row of the ``kernels`` line."""
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv6 import (Wkv6, wkv6_bwd_kernel,
                                          wkv6_bwd_plain, wkv6_plain)
    wkv6_mod = importlib.import_module("repro_torch.kernels.wkv6")
    H, hd = 40, 64
    report, key = {}, None   # (kernel, hd, bf16) -> ptxas's lines
    for line in build.build_log("wkv6_bwd").splitlines():
        m = re.search(r"entry function '[^']*wkv6_bwd_(a|b|sum)_kernel"
                      r"(?:ILi(\d+)E)?(?:Lb([01])E)?", line)
        if m:
            key = (m.group(1), m.group(2) and int(m.group(2)),
                   m.group(3) and int(m.group(3)))
        elif key and ("registers" in line or "spill" in line):
            report.setdefault(key, []).append(line.strip())
    for d in wkv6_mod.HEAD_DIMS:
        t = wkv6_mod.bwd_tiling(d)
        check(wkv6_mod.library_bwd_tiling(d) == t,
              f"wkv6_bwd hd {d}: the library's tiling differs")
        print(f"wkv6_bwd hd {d}: {t}")
        for part in ("a", "b"):
            for bf16 in (0, 1):
                name = (f"wkv6_bwd_{part}_kernel hd {d} "
                        f"{'bf16' if bf16 else 'f32'}")
                check((part, d, bf16) in report,
                      f"ptxas printed nothing for {name}")
                smem = t.a_smem if part == "a" else t.b_smem
                for line in report[part, d, bf16]:
                    spills = [int(n) for n in re.findall(
                        r"(\d+) bytes spill", line)]
                    print(f"  ptxas {name} (dynamic shared {smem} B): {line}"
                          + (" [spills]" if any(spills) else ""))
                    check(d != hd or not any(spills),
                          f"{name} spills: {line}")
    for k in sorted((k for k in report if k[0] == "sum"), key=str):
        for line in report[k]:
            print(f"  ptxas wkv6_bwd_{k[0]}_kernel"
                  f"{'' if k[2] is None else ' bf16' if k[2] else ' f32'}: "
                  f"{line}")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(B, S, H, hd, dtype, underflow=False):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        r, k, v = (randn(B, S, H, hd).to(dtype) for _ in range(3))
        dd = randn(B, S, H, hd) - 1.5
        if underflow:        # w = exp(-exp(dd)) is 0 in f32 for dd >= 5
            dd[..., ::2] = 5.0 + dd[..., ::2].abs()
        lw = -torch.exp(dd)
        return (r, k, v, torch.exp(lw), randn(H, hd) * 0.5,
                randn(B, H, hd, hd), randn(B, S, H, hd),
                randn(B, H, hd, hd) * 0.1, lw)

    loss_shape = (RWKV_LOSS_BATCH, RWKV_LOSS_SEQ, H, hd)
    cases = [(shape, False) for d in wkv6_mod.HEAD_DIMS for shape in
             [(2, S, 3, d) for S in (1, 16, 37)]
             + [loss_shape if d == hd else (1, 1024, 2, d)]]
    cases += [(loss_shape, True)] + [((2, 37, 3, d), True) for d in (16, 128)]
    worst_abs, worst_rel = 0.0, 0.0
    for shape, underflow in cases:
        for dtype in (torch.float32, torch.bfloat16):
            if underflow and dtype == torch.float32:
                continue
            args = inputs(*shape, dtype, underflow)
            if underflow:
                check(bool((args[3][..., ::2] == 0).all()),
                      "wkv6_bwd: the underflow case has no w = 0")
            line = []
            for final in (True, False):
                dsT = args[7] if final else None
                got = wkv6_bwd_kernel(*args[:7], dsT)
                again = wkv6_bwd_kernel(*args[:7], dsT)
                torch.cuda.synchronize()
                want = wkv6_bwd_plain(*args[:7], dsT, log_w=True)
                name = (f"wkv6_bwd {shape} {str(dtype)[6:]}"
                        f"{' w = 0 on every other key' if underflow else ''}"
                        f" dsT {'given' if final else 'None'}")
                rels = []
                for g, a, w in zip(got, again, want):
                    check(torch.equal(g, a), f"{name}: two calls differ")
                    err = (g - w).abs().max().item()
                    worst_abs = max(worst_abs, err)
                    rels.append(err / max(w.abs().max().item(), 1e-30))
                    check(bool(torch.isfinite(g).all()),
                          f"{name}: not finite")
                worst_rel = max(worst_rel, max(rels))
                check(max(rels) <= WKV_BWD_TOL,
                      f"{name}: {rels} (tolerance {WKV_BWD_TOL})")
                line.append(f"dsT {'given' if final else 'None'} "
                            + ", ".join(f"{x:.2e}" for x in rels))
                del got, again, want
            print(f"wkv6_bwd {shape} {str(dtype)[6:]}"
                  f"{' w = 0 on every other key' if underflow else ''}: dr, "
                  f"dk, dv, dlw (against w dw), du, ds0 within "
                  f"{'; '.join(line)} of their largest magnitudes; repeats "
                  f"bit-identical")
            del args
    # through the autograd Function on log w at the loss shape: bf16 dr,
    # dk, dv
    r, k, v, w, u, s0, dy, dsT, lw = inputs(*loss_shape, torch.bfloat16)
    want = wkv6_bwd_plain(r, k, v, w, u, s0, dy, dsT, log_w=True)
    ins = [x.clone().requires_grad_() for x in (r, k, v, lw, u, s0)]
    y, sT = Wkv6.apply(*ins)
    got = torch.autograd.grad((y, sT), ins, (dy, dsT))
    check([g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
          * 3, f"Wkv6 gradient dtypes {[g.dtype for g in got]}")
    ulps = []
    for g, x in zip(got[:3], want[:3]):
        x = x.to(torch.bfloat16).float()
        ulp = torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8)
        off = (g.float() - x).abs() - WKV_BWD_TOL * x.abs().max()
        ulps.append((off / ulp).max().item())
    rest = [(g - x).abs().max().item() / x.abs().max().item()
            for g, x in zip(got[3:], want[3:])]
    print(f"Wkv6 {loss_shape} bf16 on log w: dr, dk, dv against the plain "
          f"f32 gradients rounded to bf16: at most {max(ulps):.3f} ulp "
          f"beyond {WKV_BWD_TOL} of the largest magnitude; dlw, du, ds0 "
          f"within {', '.join(f'{x:.2e}' for x in rest)}")
    check(max(ulps) <= 1.0 and max(rest) <= WKV_BWD_TOL,
          f"Wkv6 bf16 gradients: {ulps} ulps, {rest}")
    del r, k, v, w, u, s0, dy, dsT, lw, want, ins, y, sT, got
    rows = {}
    passes = wkv_bwd_passes(torch)
    # the rwkv6-3b loss shape in bf16 and f32; hd 128 (a chain a cluster of
    # four column blocks) once, at the same width in heads of 128
    wide = (RWKV_LOSS_BATCH, RWKV_LOSS_SEQ, H * hd // 128, 128)
    for shape, dtype in ((loss_shape, torch.bfloat16),
                         (loss_shape, torch.float32), (wide, torch.bfloat16)):
        es = torch.finfo(dtype).bits // 8
        nbytes = wkv_bwd_bytes(*shape, es)
        sets = [inputs(*shape, dtype)[:8]
                for _ in range(max(2, -(-2 * L2_BYTES // nbytes)))]
        ms, eager_ms = time_calls(torch, wkv6_bwd_kernel, sets, 3)
        bufs = [wkv6_mod._bwd_buffers(a[0]) for a in sets]
        idx = [(i,) + a for i, a in enumerate(sets)]
        for a in idx:                  # a whole call's dr, for pass B alone
            passes(bufs, 3)(*a)
        a_ms, _ = time_calls(torch, passes(bufs, 1), idx, 3)
        b_ms_, _ = time_calls(torch, passes(bufs, 2), idx, 3)
        plain_ms = None
        if shape == loss_shape:
            a = sets[0]
            ins = [x.clone().requires_grad_() for x in a[:6]]
            yp, sp = wkv6_plain(*ins)
            plain_ms = event_ms(torch, lambda: torch.autograd.grad(
                (yp, sp), ins, (a[6], a[7]), retain_graph=True), 1)
            del ins, yp, sp
        ms2, _ = time_calls(torch, wkv6_bwd_kernel, sets, 3)
        by_ms = nbytes / HBM_BYTES_PER_S * 1e3
        s_ms = wkv_bwd_slots(*shape) / F32_SLOTS_PER_S * 1e3
        rows[shape, dtype] = {
            "ms": ms, "ms_again": ms2, "eager_ms": eager_ms, "a_ms": a_ms,
            "b_ms": b_ms_, "plain_ms": plain_ms,
            "bound_ms": max(by_ms, s_ms),
            "bound_by": "bytes" if by_ms >= s_ms else "operations",
            "bytes_ms": by_ms, "slots_ms": s_ms, "sets": len(sets)}
        del sets, bufs, idx
    for (shape, dtype), x in rows.items():
        fa, ba, fb, bb = wkv_bwd_pass_floors(*shape)
        floor_ms = (max(fa, ba) + max(fb, bb)) * 1e3
        plain = ("" if x["plain_ms"] is None else
                 f"autograd through wkv6_plain {x['plain_ms']:.2f} ms; ")
        print(f"wkv6_bwd ({shape}, r, k, v {str(dtype)[6:]}) [{CARD}]: "
              f"{x['ms']*1e3:.2f} / {x['ms_again']*1e3:.2f} us on the card "
              f"({x['eager_ms']*1e3:.2f} us per eager call); pass A alone "
              f"{x['a_ms']*1e3:.2f} us (floor {max(fa, ba)*1e6:.2f}: slots "
              f"{fa*1e6:.2f}, bytes {ba*1e6:.2f}), pass B with the sum alone "
              f"{x['b_ms']*1e3:.2f} us (floor {max(fb, bb)*1e6:.2f}: slots "
              f"{fb*1e6:.2f}, bytes {bb*1e6:.2f}); {plain}bound: FP32 issue "
              f"slots {x['slots_ms']*1e3:.2f} us (7 a state entry a step), "
              f"bytes "
              f"{x['bytes_ms']*1e3:.2f} us; the larger ({x['bound_by']}) "
              f"{100 * x['bound_ms'] / x['ms']:.1f} % of the time; the "
              f"two passes' floor {floor_ms*1e3:.2f} us, "
              f"{100 * floor_ms / x['ms']:.1f} % of the time; {x['sets']} "
              f"input sets")
    row = rows[loss_shape, torch.bfloat16]
    return {
        "name": "wkv6_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/nn/blocks.py:395",
        "replaces_note": "no Pallas kernel: the gradient of the lax.scan of "
                         "rwkv_time_mix_seq, which XLA's autodiff derives",
        "max_abs_err": worst_abs, "max_rel_err": worst_rel,
        "ms": row["ms"], "eager_ms": row["eager_ms"],
        "pass_a_ms": row["a_ms"], "pass_b_ms": row["b_ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "library": "none: no PyTorch call computes the WKV recurrence's "
                   "gradient",
        "shape": f"r, k, v bf16, w, dy f32 {loss_shape}: one bf16 train "
                 f"step's time mix; timed over {row['sets']} input sets",
        "f32": {k: rows[loss_shape, torch.float32][k]
                for k in ("ms", "a_ms", "b_ms", "plain_ms", "bound_ms")},
        "hd128": {"shape": f"r, k, v bf16 {wide}", **{
            k: rows[wide, torch.bfloat16][k]
            for k in ("ms", "a_ms", "b_ms", "bound_ms")}},
    }


def _seed_rwkv_leaves(torch, params):
    """Overwrite ``u``, ``mu``, ``cm_mu``, ``ln_x`` and ``w0`` (the
    reference's constants, which hide a wrong axis) with seeded values."""
    from repro_torch.tree import flatten_with_path
    rng = np.random.default_rng(0)
    draw = {"u": (0.0, 0.5), "mu": (0.5, 0.3), "cm_mu": (0.5, 0.3),
            "ln_x": (0.0, 0.3), "w0": (-1.5, 1.0)}
    for path, leaf in flatten_with_path(params):
        if path[-1] in draw:
            mean, sd = draw[path[-1]]
            leaf.copy_(torch.from_numpy(rng.normal(
                mean, sd, tuple(leaf.shape)).astype(np.float32)))


def rwkv_train_grad_check(torch):
    """Phase 16 (b): the f32 ``Model.loss`` gradient of rwkv6-3b at full
    width and 2 layers (remat on, ``u``, ``mu``, ``cm_mu``, ``ln_x``,
    ``w0`` seeded), B = 2, S = 256: the card (both wkv6 kernels) against
    the same call on the CPU (autograd through the plain version), each
    leaf within ``TRAIN_GRAD_TOL`` of its largest magnitude."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.wkv6 import wkv6_bwd_kernel, wkv6_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(get_config(RWKV_ARCH), n_layers=2,
                              dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    _seed_rwkv_leaves(torch, params)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=256, global_batch=2,
                          seed=0).batch(0)
    grads, losses, secs = {}, {}, {}
    for dev in ("cpu", "cuda"):
        live = tree_map(lambda p: p.detach().to(dev).requires_grad_(),
                        params)
        f0, b0 = wkv6_kernel.launches, wkv6_bwd_kernel.launches
        t0 = time.perf_counter()
        loss, _ = Model(cfg, device=dev).loss(live, batch)
        grads[dev] = torch.autograd.grad(loss, leaves(live))
        if dev == "cuda":
            torch.cuda.synchronize()
            n = (wkv6_kernel.launches - f0, wkv6_bwd_kernel.launches - b0)
        secs[dev] = time.perf_counter() - t0
        losses[dev] = float(loss.detach())
    worst, worst_path, _ = grads_card_vs_cpu(
        "train_rwkv (b)", params, grads["cpu"], grads["cuda"])
    rel_loss = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"train_rwkv (b): f32 Model.loss gradient, {RWKV_ARCH} full width, "
          f"2 layers, 2 x 256, seeded u / mu / cm_mu / ln_x / w0: loss card "
          f"{losses['cuda']!r} CPU {losses['cpu']!r} (rel {rel_loss:.3e}); "
          f"every leaf within {worst:.3e} of its largest magnitude "
          f"({worst_path}; <= {TRAIN_GRAD_TOL}); wkv6 launches forward / "
          f"backward {n[0]} / {n[1]} (remat: 2 a layer forward); "
          f"{secs['cpu']:.2f} s CPU, "
          f"{secs['cuda']:.2f} s card [{CARD}]")
    check(rel_loss <= 1e-5 and n == (2 * cfg.n_layers, cfg.n_layers),
          f"train_rwkv (b): loss rel {rel_loss}, wkv6 launches {n}")
    return {"worst_leaf_rel": worst, "loss_rel": rel_loss}


def rwkv_train_launcher_run(torch):
    """Phase 16 (c): ``repro_torch.launch.train.main`` at rwkv6-3b's full
    width and depth, 8 x 1024 bf16 batches, ``TRAIN_STEPS`` steps, the
    checkpoint into a temporary directory, removed after.  The wkv6
    counters zeroed just before and read just after: 64 forward launches a
    step (32 and 32 for remat) and 32 backward calls; the first loss near
    ln V + s2/2; every loss and grad norm finite; the step's time (its
    median past the first), tokens/s, the 6 N D share of the bf16 peak and
    the peak memory.  Returns the launches and the figures."""
    import shutil
    import tempfile
    from repro_torch.kernels.wkv6 import wkv6_bwd_kernel, wkv6_kernel
    from repro_torch.launch import train as launch_train
    from repro_torch.nn import get_config
    cfg = get_config(RWKV_ARCH)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.reset_peak_memory_stats()
    wkv6_kernel.launches = 0
    wkv6_bwd_kernel.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            loop = launch_train.main([
                "--arch", RWKV_ARCH, "--batch", str(TRAIN_BATCH), "--seq",
                str(TRAIN_SEQ), "--steps", str(TRAIN_STEPS), "--ckpt-dir",
                ckpt, "--ckpt-every", "100", "--log-every", "1"])
        torch.cuda.synchronize()
        n_fwd, n_bwd = wkv6_kernel.launches, wkv6_bwd_kernel.launches
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ckpt) for f in fs)
        saved = os.listdir(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = [r for r in loop.metrics_log if "loss" in r]
    for r in recs:
        print(f"  train_rwkv {r}")
    steady = sorted(r["dt"] for r in recs[1:])
    step_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * cfg.params_count() * tokens / step_s / BF16_FLOPS
    s2 = 0.02 ** 2 * cfg.d_model
    expect = float(np.log(cfg.vocab)) + s2 / 2
    print(f"train_rwkv (c): {RWKV_ARCH} full width and depth through the "
          f"launcher, {TRAIN_BATCH} x {TRAIN_SEQ} bf16, {TRAIN_STEPS} steps: "
          f"step {step_s*1e3:.2f} ms (median of steps 1-{TRAIN_STEPS - 1}; "
          f"step 0 {recs[0]['dt']*1e3:.2f} ms), {tokens / step_s:,.0f} "
          f"tokens/s, 6 N D {100 * mfu:.2f} % of {BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s (N = {cfg.params_count():,}); loss {recs[0]['loss']:.4f} "
          f"-> {recs[-1]['loss']:.4f} (step 0 expected ln V + s2/2 = "
          f"{expect:.4f}; the schedule warms up over 20 steps, so these 6 "
          f"steps take lr <= 7.5e-5, each on a new batch: a fall is not "
          f"required); peak memory {peak:.3f} GiB; wkv6 launches forward "
          f"{n_fwd}, backward {n_bwd}; {loop.restarts} restarts; checkpoint "
          f"{saved} {ckpt_bytes / 2**30:.3f} GiB, removed; {wall:.2f} s with "
          f"init and the checkpoint [{CARD}]")
    check(len(recs) == TRAIN_STEPS and loop.restarts == 0 and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in recs), f"train_rwkv (c): records {recs}")
    check(abs(recs[0]["loss"] - expect) <= 0.2,
          f"train_rwkv (c): first loss {recs[0]['loss']} far from {expect}")
    check(n_fwd == 2 * cfg.n_layers * TRAIN_STEPS
          and n_bwd == cfg.n_layers * TRAIN_STEPS,
          f"train_rwkv (c): wkv6 launches forward {n_fwd}, backward {n_bwd}")
    check(saved == [f"step_{TRAIN_STEPS - 1}"],
          f"train_rwkv (c): checkpoint directory held {saved}")
    return {"wkv6": n_fwd, "wkv6_bwd": n_bwd}, {
        "step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "mfu_6nd": mfu, "peak_gib": peak,
        "losses": [r["loss"] for r in recs]}


def rwkv_train_profile(torch):
    """Phase 16 (c'): one more full-width rwkv6-3b train step (8 x 1024
    bf16, the launcher's optimizer) under ``torch.profiler``, after one
    untimed step: the device's busy share, its top kernels and the wkv6
    kernels' shares."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.wkv6 import wkv6_bwd_kernel, wkv6_kernel
    from repro_torch.nn import Model, get_config
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.step import make_train_step
    cfg = get_config(RWKV_ARCH)
    m = Model(cfg, device="cuda")
    params = m.init(0)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(3e-4, 20, 100))
    state = opt.init(params)
    step = make_train_step(m, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in pipe.batch(0).items()}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    n0 = (wkv6_kernel.launches, wkv6_bwd_kernel.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = (wkv6_kernel.launches - n0[0], wkv6_bwd_kernel.launches - n0[1])
    busy, by_name = report_profile(prof, wall * 1e6, "one rwkv6-3b train "
                                   "step", 14)
    parts = {part: tuple(map(sum, zip((0.0, 0), *(
        v for n, v in by_name.items() if name in n))))
        for part, name in (("wkv6 forward", "wkv6_kernel"),
                           ("wkv6 backward pass A", "wkv6_bwd_a_kernel"),
                           ("pass B", "wkv6_bwd_b_kernel"),
                           ("its sum", "wkv6_bwd_sum_kernel"))}
    print(f"train_rwkv (c'): profiled step {wall*1e3:.1f} ms, device busy "
          f"{busy/1e3:.1f} ms ({100 * busy / (wall * 1e6):.2f} %); "
          + ", ".join(f"{p} {t/1e3:.3f} ms in {k} events "
                      f"({100 * t / busy:.2f} % of busy)"
                      for p, (t, k) in parts.items())
          + f"; the counters: {n[0]} forward and {n[1]} backward launches "
            f"[{CARD}]")
    # the launches are counted exactly by the wrappers; the profiler has
    # dropped an event of a window now and then (63 of 64 forward kernels
    # once), so its events only have to show both kernels ran
    check(n == (2 * cfg.n_layers, cfg.n_layers)
          and all(k > 0 for _, k in parts.values()),
          f"train_rwkv (c'): wkv6 launches {n}, profiled kernels {parts}")
    return {"profiled_step_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "wkv6_bwd_ms": sum(parts[p][0] for p in (
                "wkv6 backward pass A", "pass B", "its sum")) / 1e3,
            "wkv6_fwd_ms": parts["wkv6 forward"][0] / 1e3}


def rwkv_train_phase(torch):
    """Phase 16, RWKV6 training: (b), (c) and (c') above.  Returns the
    launches of (c), the main path, and (c)'s figures."""
    t0 = time.perf_counter()
    rwkv_train_grad_check(torch)
    print(f"train_rwkv (b): {time.perf_counter() - t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    launches, figures = rwkv_train_launcher_run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    figures["profile"] = rwkv_train_profile(torch)
    return launches, figures


def hybrid_bwd_readings(torch):
    """Phase 17 (a): the flash backward at D = 256, the hybrid's local
    attention (16 / 1 heads of 256, causal, window 2048): ptxas's
    registers and spills of its five instantiations (a spill fails the
    run); through ``FlashAttention`` against autograd through the plain
    version, f32 and bf16 (``bwd_agreement``), at the train cell's (2,
    4096), at (1, 4096) and at small shapes with and without a window; in
    bf16 timed at both 4096-row shapes beside the bound, autograd through
    the plain version and ``scaled_dot_product_attention``'s backward with
    the window as a mask.  Returns the readings by shape."""
    from repro_torch.kernels import build
    lines = [(fn, line) for fn, line in ptxas_lines(
        build.build_log("flash_attention_bwd")) if "Li256E" in fn]
    for fn, line in lines:
        print(f"flash_attention_bwd D = 256 {fn}: ptxas {line}")
        check(not any(int(n) for n in re.findall(r"(\d+) bytes spill",
                                                 line)),
              f"flash_attention_bwd {fn} spills: {line}")
    check(len({fn for fn, _ in lines}) == 5,
          f"flash_attention_bwd: {len(lines)} ptxas lines at D = 256")
    serial = build.build_log("flash_attention_bwd").count("C7515")
    print(f"flash_attention_bwd: ptxas reports {serial} kernels whose wgmma "
          f"are serialized (C7515)")
    inputs = bwd_inputs(torch, 17)

    W = 2048                                   # the config's local_window
    cases = [("train cell", (HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, 16, 1, 256), W),
             ("one row", (1, HYB_TRAIN_SEQ, 16, 1, 256), W),
             ("small, window 128", (1, 300, 16, 1, 256), 128),
             ("small, no window", (2, 333, 16, 1, 256), 0)]
    readings = {}
    for name, shape, window in cases:
        reading = {"window": window}
        for dt in (torch.float32, torch.bfloat16):
            reading.update(bwd_agreement(torch, name, shape, dt, inputs,
                                         window))
        gc.collect()
        torch.cuda.empty_cache()
        if shape[1] == HYB_TRAIN_SEQ:
            reading.update(flash_bwd_timing(torch, inputs, shape, window))
        readings[f"{name} {shape}"] = reading
    return readings


def scan_bwd_readings(torch):
    """Phase 17 (b): the linear scan's backward (``linear_scan_bwd`` on the
    kernel: the forward kernel over the time-reversed, shifted a and dh)
    at the hybrid's (2, 4096, 4096): bit-identical to the plain reversed
    scan and on repeat, each gradient within ``SCAN_BWD_TOL`` of its
    largest magnitude of autograd through ``linear_scan_plain``; timed
    (CUDA-graph replays over two input sets, each past the L2), the
    reversed scan alone too, beside the bytes bound (a, h, dh read and da,
    dx written once; the scan alone three arrays) and the plain reversed
    scan.  Returns the reading."""
    from repro_torch.kernels.linear_scan import (linear_scan_bwd,
                                                 linear_scan_kernel,
                                                 linear_scan_plain)
    B, S, W = HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, 4096
    gen = torch.Generator(device="cuda").manual_seed(17)

    def inputs():
        a = torch.rand((B, S, W), generator=gen, device="cuda") * 0.5 + 0.5
        x, dh = (torch.randn((B, S, W), generator=gen, device="cuda")
                 for _ in range(2))
        return a, linear_scan_kernel(a, x), dh, x

    a, h, dh, x = inputs()
    got = linear_scan_bwd(linear_scan_kernel, a, h, dh)
    again = linear_scan_bwd(linear_scan_kernel, a, h, dh)
    plain = linear_scan_bwd(linear_scan_plain, a, h, dh)
    aa, xx = a.clone().requires_grad_(), x.clone().requires_grad_()
    want = torch.autograd.grad(linear_scan_plain(aa, xx), (aa, xx), dh)
    torch.cuda.synchronize()
    same = all(torch.equal(g, p) for g, p in zip(got, plain))
    repeat = all(torch.equal(g, r) for g, r in zip(got, again))
    rel = max(((g - w).abs().max() / w.abs().max()).item()
              for g, w in zip(got, want))
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    del got, again, plain, aa, xx, want, x
    sets = [(a, h, dh)] + [inputs()[:3]]
    ms, eager_ms = time_calls(
        torch, lambda a, h, dh: linear_scan_bwd(linear_scan_kernel, a, h, dh),
        sets, 3)
    rev = [(torch.cat([a[:, :1] * 0, a[:, 1:].flip(1)], 1).contiguous(),
            dh.flip(1).contiguous()) for a, _, dh in sets]
    scan_ms, _ = time_calls(torch, linear_scan_kernel, rev, 3)
    plain_ms = event_ms(torch, lambda: linear_scan_bwd(
        linear_scan_plain, a, h, dh), 1)
    one = 4 * B * S * W
    bound_ms = 5 * one / HBM_BYTES_PER_S * 1e3
    scan_bound_ms = 3 * one / HBM_BYTES_PER_S * 1e3
    print(f"linear_scan backward ({B}, {S}, {W}) f32: bit-identical to the "
          f"plain reversed scan {same}, on repeat {repeat}; against autograd "
          f"through linear_scan_plain max abs err {err:.3e}, {rel:.3e} of "
          f"the largest (<= {SCAN_BWD_TOL}); {ms*1e3:.2f} us a call "
          f"({eager_ms*1e3:.2f} eager), the reversed scan alone "
          f"{scan_ms*1e3:.2f} us; bound {bound_ms*1e3:.2f} us (bytes: a, h, "
          f"dh, da, dx; {100 * bound_ms / ms:.1f} %), the scan's "
          f"{scan_bound_ms*1e3:.2f} us ({100 * scan_bound_ms / scan_ms:.1f} "
          f"%); plain reversed scan {plain_ms:.2f} ms [{CARD}]")
    check(same and repeat and rel <= SCAN_BWD_TOL,
          f"linear_scan backward: plain {same}, repeat {repeat}, rel {rel}")
    return {"shape": [B, S, W], "max_abs_err": err, "rel_err": rel,
            "ms": ms, "eager_ms": eager_ms, "scan_ms": scan_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "scan_bound_ms": scan_bound_ms, "library_ms": None}


def hybrid_counters():
    """The hybrid training path's launch counters: flash forward and
    backward, the linear scan's launches (forward and backward) and its
    backward calls."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.kernels.linear_scan import LinearScan, linear_scan_kernel
    return (flash_attention_kernel.launches,
            flash_attention_bwd_kernel.launches, linear_scan_kernel.launches,
            LinearScan.backward_launches)


def zero_hybrid_counters():
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.kernels.linear_scan import LinearScan, linear_scan_kernel
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.launches = 0
    linear_scan_kernel.launches = 0
    LinearScan.backward_launches = 0


def hybrid_step_launches(cfg, steps):
    """A step's launches at ``cfg``'s depth, as the counters count them:
    (flash forward, flash backward, linear scan launches, linear scan
    backward calls).  Remat recomputes each scanned unit's forward (its
    two RG-LRU layers and its attention) in the backward; the tail layers
    are not under it."""
    units, tail = cfg.n_layers // 3, cfg.n_layers % 3
    fwd_scans = 2 * 2 * units + tail
    bwd_scans = 2 * units + tail
    return (2 * units * steps, units * steps,
            (fwd_scans + bwd_scans) * steps, bwd_scans * steps)


def _seed_hybrid_leaves(torch, params):
    """Overwrite the ``HYB_SEEDED`` leaves with seeded values: norms around
    0, lam around 3, the gates and the conv around their init's scale."""
    from repro_torch.tree import flatten_with_path
    rng = np.random.default_rng(0)
    draw = {"lam": (3.0, 1.0), "conv_k": (0.0, 0.3)}
    for path, leaf in flatten_with_path(params):
        if path[-1] in HYB_SEEDED:
            mean, sd = draw.get(path[-1], (0.0, 0.5))
            leaf.copy_(torch.from_numpy(rng.normal(
                mean, sd, tuple(leaf.shape)).astype(np.float32)))


def hybrid_grad_inputs(torch):
    """(c)'s config, parameters (on the CPU, from seed 0, the
    ``HYB_SEEDED`` leaves seeded) and batch, the same in both processes."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.nn import Model, get_config
    cfg = dataclasses.replace(get_config(HYB_ARCH), n_layers=HYB_GRAD_LAYERS,
                              vocab=HYB_GRAD_VOCAB, dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    _seed_hybrid_leaves(torch, params)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=HYB_GRAD_SEQ,
                          global_batch=1, seed=0).batch(0)
    return cfg, params, batch


def hybrid_cpu_reference():
    """(c)'s CPU side, run in the child process (``cpu_references``)
    while the card works on the earlier phases: the f32 loss and its
    gradient through the plain versions, without remat (the same
    arithmetic, a fifth less work)."""
    import dataclasses
    import torch
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    t0 = time.perf_counter()
    cfg, params, batch = hybrid_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = Model(dataclasses.replace(cfg, remat=False),
                    device="cpu").loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    return {"loss": float(loss.detach()), "grads": list(grads),
            "secs": time.perf_counter() - t0}


def _as_arrays(obj):
    """``obj`` (dicts and lists walked) with every tensor as numpy."""
    if isinstance(obj, dict):
        return {k: _as_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_as_arrays(v) for v in obj]
    return obj.numpy() if hasattr(obj, "numpy") else obj


def _as_tensors(torch, obj):
    """``obj`` (dicts and lists walked) with every numpy array as a
    tensor."""
    if isinstance(obj, dict):
        return {k: _as_tensors(torch, v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_as_tensors(torch, v) for v in obj]
    return torch.from_numpy(obj) if isinstance(obj, np.ndarray) else obj


def cpu_references(names):
    """The child process's work: each named CPU reference in turn (each
    tree freed before the next is built), its result held in memory; a
    thread answers each name read from stdin with that result pickled to
    stdout as soon as it is computed, so a later reference delays no
    earlier one.  Nothing goes to the disk, whose writes the machine caps,
    and which the training phases' checkpoints need; the child's prints go
    to stderr.  A reference that raises ends the child, and the parent
    reads the end of its stdout."""
    import pickle
    import threading
    import torch
    out, sys.stdout = sys.stdout.buffer, sys.stderr
    torch.set_num_threads(HYB_CPU_THREADS)
    results, ready = {}, threading.Condition()

    def answer():
        for line in sys.stdin:
            name = line.strip()
            with ready:
                ready.wait_for(lambda: name in results)
                result = results.pop(name)
            pickle.dump(result, out, protocol=5)
            out.flush()

    server = threading.Thread(target=answer, daemon=True)
    server.start()
    for name in names:
        result = _as_arrays(CPU_REFERENCES[name]())
        with ready:
            results[name] = result
            ready.notify_all()
        del result
        gc.collect()
    server.join()
    return 0


def start_cpu_references(names=("hybrid", "moe", "vlm", "audio")):
    """Start ``cpu_references`` for ``names`` in a child process (no card,
    its own threads), stopped when this process exits.  Returns the
    process."""
    import atexit
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS=str(HYB_CPU_THREADS))
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             CPU_REFERENCE_FLAG, *names], env=env,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)
    return proc


def wait_cpu_reference(proc, name):
    """The child's ``name`` reference (``start_cpu_references``), asked for
    on its stdin and read from its stdout, with the seconds it took under
    ``"waited"`` (the child answers once it has computed it); fails if the
    child exits without it."""
    import pickle
    import torch
    t0 = time.perf_counter()
    try:
        proc.stdin.write(f"{name}\n".encode())
        proc.stdin.flush()
        out = pickle.load(proc.stdout)
    except (BrokenPipeError, EOFError, pickle.UnpicklingError) as e:
        check(False, f"the CPU reference {name}: the child exited with "
                     f"{proc.poll()} without it ({type(e).__name__})")
    return dict(_as_tensors(torch, out), waited=time.perf_counter() - t0)


def hybrid_train_grad_check(torch, reference):
    """Phase 17 (c): the f32 ``Model.loss`` gradient of recurrentgemma-9b at
    full width, ``HYB_GRAD_LAYERS`` layers (one unit and one tail layer),
    vocab ``HYB_GRAD_VOCAB``, one row of ``HYB_GRAD_SEQ`` positions (past
    the window), remat on, the ``HYB_SEEDED`` leaves seeded: the card
    (flash at D = 256 and the linear scan, forward and backward) against
    the CPU's (autograd through the plain versions, computed by
    ``hybrid_cpu_reference`` in the child process started with the run),
    each leaf within ``TRAIN_GRAD_TOL`` of its largest magnitude."""
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    cpu = wait_cpu_reference(reference, "hybrid")
    waited = cpu["waited"]
    cfg, params, batch = hybrid_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().to("cuda").requires_grad_(), params)
    n0 = hybrid_counters()
    t0 = time.perf_counter()
    loss, _ = Model(cfg, device="cuda").loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    n = tuple(b - a for a, b in zip(n0, hybrid_counters()))
    worst, worst_path, _ = grads_card_vs_cpu(
        "train_hybrid (c)", params, cpu["grads"], grads)
    card_loss = float(loss.detach())
    rel_loss = abs(card_loss - cpu["loss"]) / abs(cpu["loss"])
    want = hybrid_step_launches(cfg, 1)
    print(f"train_hybrid (c): f32 Model.loss gradient, {HYB_ARCH} full "
          f"width, {HYB_GRAD_LAYERS} layers, vocab {HYB_GRAD_VOCAB}, 1 x "
          f"{HYB_GRAD_SEQ}, seeded {'/'.join(HYB_SEEDED)}: loss card "
          f"{card_loss!r} CPU {cpu['loss']!r} (rel {rel_loss:.3e}); every "
          f"leaf within {worst:.3e} of its largest magnitude ({worst_path}; "
          f"<= {TRAIN_GRAD_TOL}); launches flash forward / backward {n[0]} "
          f"/ {n[1]}, linear scan {n[2]} ({n[3]} of them backward); CPU "
          f"{cpu['secs']:.2f} s in its own process ({HYB_CPU_THREADS} "
          f"threads, waited {waited:.2f} s for it here), card {card_s:.2f} "
          f"s [{CARD}]")
    check(rel_loss <= 1e-5 and n == want,
          f"train_hybrid (c): loss rel {rel_loss}, launches {n}, not {want}")
    return {"worst_leaf_rel": worst, "loss_rel": rel_loss,
            "cpu_s": cpu["secs"], "waited_s": waited}


def hybrid_train_launcher_run(torch):
    """Phase 17 (d): the train launcher's code (``launch.train.train``) at
    recurrentgemma-9b's full width and ``HYB_TRAIN_LAYERS`` of its 38
    layers, ``HYB_TRAIN_BATCH`` x ``HYB_TRAIN_SEQ`` bf16 batches on f32
    masters and f32 AdamW moments, remat a unit, ``TRAIN_STEPS`` steps,
    the checkpoint into a temporary directory, removed after.  The
    counters zeroed just before and read just after
    (``hybrid_step_launches``);
    the first loss near ln V + s2/2; every loss and grad norm finite, no
    restart; the step's time (its median past the first), tokens/s, the 6
    N D share of the bf16 peak and the peak memory.  Returns the launches
    and the figures."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.launch import train as launch_train
    from repro_torch.nn import get_config
    full = get_config(HYB_ARCH)
    cfg = dataclasses.replace(full, n_layers=HYB_TRAIN_LAYERS)
    print(f"train_hybrid (d): {HYB_ARCH} cut to {cfg.n_layers} of "
          f"{full.n_layers} layers ({cfg.n_layers // 3} scanned units and "
          f"{cfg.n_layers % 3} tail layers; full depth's f32 masters, "
          f"gradients and AdamW moments are 142.6 GiB), full width")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.reset_peak_memory_stats()
    zero_hybrid_counters()
    t0 = time.perf_counter()
    try:
        loop = launch_train.train(
            cfg, steps=TRAIN_STEPS, batch=HYB_TRAIN_BATCH, seq=HYB_TRAIN_SEQ,
            ckpt_dir=ckpt, ckpt_every=100, log_every=1)
        torch.cuda.synchronize()
        n = hybrid_counters()
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ckpt) for f in fs)
        saved = os.listdir(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = [r for r in loop.metrics_log if "loss" in r]
    for r in loop.metrics_log:
        print(f"  train_hybrid {r}")
    steady = sorted(r["dt"] for r in recs[1:])
    step_s = steady[len(steady) // 2]
    tokens = HYB_TRAIN_BATCH * HYB_TRAIN_SEQ
    mfu = 6 * cfg.params_count() * tokens / step_s / BF16_FLOPS
    s2 = 0.02 ** 2 * cfg.d_model
    expect = float(np.log(cfg.vocab)) + s2 / 2
    want = hybrid_step_launches(cfg, TRAIN_STEPS)
    print(f"train_hybrid (d): {HYB_ARCH} full width, {cfg.n_layers} layers, "
          f"through the launcher's train(), {HYB_TRAIN_BATCH} x "
          f"{HYB_TRAIN_SEQ} bf16, {TRAIN_STEPS} steps: step "
          f"{step_s*1e3:.2f} ms (median of steps 1-{TRAIN_STEPS - 1}; step 0 "
          f"{recs[0]['dt']*1e3:.2f} ms), {tokens / step_s:,.0f} tokens/s, 6 "
          f"N D {100 * mfu:.2f} % of {BF16_FLOPS / 1e12:.0f} TFLOP/s (N = "
          f"{cfg.params_count():,}); loss {recs[0]['loss']:.4f} -> "
          f"{recs[-1]['loss']:.4f} (step 0 expected ln V + s2/2 = "
          f"{expect:.4f}); peak memory {peak:.3f} GiB; launches flash "
          f"forward {n[0]}, backward {n[1]}, linear scan {n[2]} ({n[3]} "
          f"backward calls); {loop.restarts} restarts; checkpoint {saved} "
          f"{ckpt_bytes / 2**30:.3f} GiB, removed; {wall:.2f} s with init "
          f"and the checkpoint [{CARD}]")
    check(len(recs) == TRAIN_STEPS and loop.restarts == 0 and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in recs), f"train_hybrid (d): records {loop.metrics_log}")
    check(abs(recs[0]["loss"] - expect) <= 0.2,
          f"train_hybrid (d): first loss {recs[0]['loss']} far from {expect}")
    check(n == want, f"train_hybrid (d): launches {n}, not {want}")
    check(saved == [f"step_{TRAIN_STEPS - 1}"],
          f"train_hybrid (d): checkpoint directory held {saved}")
    launches = {"flash_attention": n[0], "flash_attention_bwd": n[1],
                "linear_scan": n[2], "linear_scan backward calls": n[3]}
    return launches, {
        "layers": cfg.n_layers, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "mfu_6nd": mfu, "peak_gib": peak,
        "losses": [r["loss"] for r in recs],
        "checkpoint_gib": ckpt_bytes / 2**30}


def hybrid_train_profile(torch):
    """Phase 17 (e): one more step at (d)'s configuration (the launcher's
    optimizer) under ``torch.profiler``, after one untimed step: the
    device's busy share and the shares of the flash backward's kernels and
    of the linear scan (forward and backward launches alike)."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.nn import Model, get_config
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.step import make_train_step
    cfg = dataclasses.replace(get_config(HYB_ARCH), n_layers=HYB_TRAIN_LAYERS)
    m = Model(cfg, device="cuda")
    params = m.init(0)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(3e-4, 20, 100))
    state = opt.init(params)
    step = make_train_step(m, opt)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=HYB_TRAIN_SEQ,
                         global_batch=HYB_TRAIN_BATCH)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in pipe.batch(0).items()}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    n0 = hybrid_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = tuple(b - a for a, b in zip(n0, hybrid_counters()))
    busy, by_name = report_profile(prof, wall * 1e6, "one recurrentgemma-9b "
                                   f"train step, {cfg.n_layers} layers", 14)
    parts = {part: tuple(map(sum, zip((0.0, 0), *(
        v for k, v in by_name.items() if name in k))))
        for part, name in (("flash forward", "flash_attention_wgmma_kernel"),
                           ("flash backward dq", FLASH_BWD_KERNELS["dq"]),
                           ("flash backward dk/dv",
                            FLASH_BWD_KERNELS["dkdv"]),
                           ("linear scan", "linear_scan_ring_kernel"))}
    print(f"train_hybrid (e): profiled step {wall*1e3:.1f} ms, device busy "
          f"{busy/1e3:.1f} ms ({100 * busy / (wall * 1e6):.2f} %); "
          + ", ".join(f"{p} {t/1e3:.3f} ms in {k} events "
                      f"({100 * t / busy:.2f} % of busy)"
                      for p, (t, k) in parts.items())
          + f"; the counters: {n} [{CARD}]")
    check(n == hybrid_step_launches(cfg, 1)
          and all(k > 0 for _, k in parts.values()),
          f"train_hybrid (e): launches {n}, profiled kernels {parts}")
    return {"profiled_step_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (wall * 1e6),
            "shares": {p: t / busy for p, (t, _) in parts.items()}}


def hybrid_train_phase(torch, reference):
    """Phase 17, the hybrid's training: (a), (b), (d), (e), then (c), whose
    CPU side (``reference``, from ``start_cpu_references``) has had
    the run to finish.  Returns the flash backward's D = 256 readings, the
    scan backward's reading, the launches of (d), the main path, and (d)'s
    figures."""
    t0 = time.perf_counter()
    bwd = hybrid_bwd_readings(torch)
    gc.collect()
    torch.cuda.empty_cache()
    scan = scan_bwd_readings(torch)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_hybrid (a), (b): {time.perf_counter() - t0:.2f} s")
    launches, figures = hybrid_train_launcher_run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    figures["profile"] = hybrid_train_profile(torch)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    figures["grad_check"] = hybrid_train_grad_check(torch, reference)
    print(f"train_hybrid (c): {time.perf_counter() - t0:.2f} s")
    return bwd, scan, launches, figures


def moe_leaves(cfg):
    """The leaves of ``Model(cfg).init`` for a MoE config, by its shapes:
    per layer the attention (with the QKV bias), two norms, the router,
    the E routed experts and the shared ones; the embedding, the head and
    the final norm once."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    if cfg.qkv_bias:
        attn += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    layer = (attn + 2 * d + d * cfg.n_experts
             + 3 * d * f * (cfg.n_experts + cfg.n_shared_experts))
    return cfg.n_layers * layer + 2 * cfg.vocab * d + d


def moe_bwd_readings(torch):
    """Phase 18 (a): the flash backward at qwen2-moe's MHA layout (16 / 16
    heads of 128, G = 1, causal) at the train cell's (8, 1024): through
    ``FlashAttention`` against autograd through the plain version, f32 and
    bf16 (``bwd_agreement``), two calls bit-identical; in bf16 timed beside
    its bound, autograd through the plain version and
    ``scaled_dot_product_attention``'s backward.  Returns the reading."""
    inputs = bwd_inputs(torch, 18)

    shape = (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 128)
    reading = {"shape": list(shape)}
    for dt in (torch.float32, torch.bfloat16):
        reading.update(bwd_agreement(torch, "MHA train cell", shape, dt,
                                     inputs))
    gc.collect()
    torch.cuda.empty_cache()
    reading.update(flash_bwd_timing(torch, inputs, shape))
    return reading


def _dispatch_inputs(torch, gen, dt):
    """The train cell's dispatch at qwen2-moe's widths: routing of seeded
    probabilities (8 x 1024 tokens, 60 experts, top 4, C = 86), x (8,
    1024, 2048) and a cotangent (8, 60 x 86, 2048) in ``dt``."""
    from repro_torch.nn import blocks, get_config
    cfg = get_config(MOE_ARCH)
    B, S, E, K = TRAIN_BATCH, TRAIN_SEQ, cfg.n_experts, cfg.top_k
    C = blocks.moe_capacity(cfg, S)
    probs = torch.softmax(torch.randn((B, S, E), generator=gen,
                                      device="cuda"), dim=-1)
    _, _, keep, slot = blocks.moe_route(probs, K, C)
    idx, filled = blocks.moe_slot_table(slot, S, E * C)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda",
                    dtype=dt)
    dxe = torch.randn((B, E * C, cfg.d_model), generator=gen, device="cuda",
                      dtype=dt)
    return x, dxe, idx, filled, slot, keep


def moe_dispatch_readings(torch):
    """Phase 18 (b): the expert dispatch's backward (``MoeDispatch``: each
    token's K slot gradients gathered and added in k order) on the card at
    the train cell's dispatch, with deterministic algorithms off: two calls
    bit-identical in f32 and bf16; in f32 within ``MOE_DISPATCH_TOL`` of
    the largest of autograd through ``torch.gather`` (its backward
    scatter-adds); both timed in bf16 beside the bytes bound (dxe's K rows
    a token read, dx written).  Then one full-width MoE layer's gradient
    in bf16 (x and every leaf of the router, the experts and the shared
    ones), twice: bit-identical.  Returns the figures."""
    from repro_torch.nn import blocks, get_config
    from repro_torch.tree import leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(18)
    out = {}

    def grad_fn(x, dxe, idx, filled, slot, keep, dispatch):
        xx = x.detach().requires_grad_()
        if dispatch:
            xe = blocks.MoeDispatch.apply(xx, idx, filled, slot, keep)
        else:
            xe = torch.where(filled[..., None], torch.gather(
                xx, 1, idx[..., None].expand(*idx.shape, x.shape[-1])), 0)
        return lambda: torch.autograd.grad(xe, xx, dxe, retain_graph=True)[0]

    for dt in (torch.float32, torch.bfloat16):
        args = _dispatch_inputs(torch, gen, dt)
        run = grad_fn(*args, True)
        got, again = run(), run()
        plain = grad_fn(*args, False)
        want = plain()
        torch.cuda.synchronize()
        same = torch.equal(got, again)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        key = str(dt).replace("torch.", "")
        out[key] = {"repeat_equal": same, "max_abs_err": err,
                    "rel_err": rel}
        if dt == torch.float32:
            check(same and rel <= MOE_DISPATCH_TOL,
                  f"train_moe (b): dispatch backward f32 repeat {same}, "
                  f"{rel:.3e} of the largest against autograd")
        else:
            check(same, "train_moe (b): dispatch backward bf16 repeat "
                        "differs")
            x, slot = args[0], args[4]
            # dxe's K rows a token read, dx written, slot and keep read
            bound_ms = ((slot.numel() * x.shape[-1] + x.numel())
                        * x.element_size() + slot.numel() * 9) \
                / HBM_BYTES_PER_S * 1e3
            out[key].update(ms=event_ms(torch, run, 10),
                            scatter_ms=event_ms(torch, plain, 10),
                            bound_ms=bound_ms)
        del args, run, plain, got, again, want
    b = out["bfloat16"]
    print(f"train_moe (b): the dispatch backward at ({TRAIN_BATCH}, "
          f"{TRAIN_SEQ}, 60 experts, top 4, C = 86, d 2048), deterministic "
          f"algorithms off: two calls bit-identical f32 "
          f"{out['float32']['repeat_equal']}, bf16 {b['repeat_equal']}; f32 "
          f"against autograd through torch.gather max abs err "
          f"{out['float32']['max_abs_err']:.3e} ({out['float32']['rel_err']:.3e}"
          f" of the largest; <= {MOE_DISPATCH_TOL}); bf16 {b['ms']*1e3:.2f} "
          f"us a call, the gather's scatter-add backward "
          f"{b['scatter_ms']*1e3:.2f} us, bytes bound {b['bound_ms']*1e3:.2f}"
          f" us (CUDA events, eager) [{CARD}]")
    # one full-width layer's gradient, twice
    cfg = get_config(MOE_ARCH)
    p = blocks.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg)
    x = torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                    device="cuda", dtype=torch.bfloat16)
    dy = torch.randn(x.shape, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    runs = []
    for _ in range(2):
        live = tree_map(lambda t: t.detach().requires_grad_(), p)
        xx = x.detach().requires_grad_()
        y, aux = blocks.moe_apply(live, xx, cfg)
        runs.append(torch.autograd.grad((y.float() * dy).sum() + aux,
                                        [xx] + leaves(live)))
    torch.cuda.synchronize()
    layer_same = all(torch.equal(a, c) for a, c in zip(*runs))
    print(f"train_moe (b): one full-width MoE layer's bf16 gradient (x, the "
          f"router, the 60 experts and the shared ones) twice: "
          f"bit-identical {layer_same}")
    check(layer_same, "train_moe (b): the MoE layer's gradient differs on "
                      "repeat")
    out["layer_repeat_equal"] = layer_same
    return out


@contextlib.contextmanager
def recorded_routes(keep_on_device=False):
    """``blocks.moe_route`` recording every call's (expert ids, keep mask,
    slots, gates) in the list it yields, on the CPU unless
    ``keep_on_device``."""
    from repro_torch.nn import blocks
    route, calls = blocks.moe_route, []

    def recording(probs, K, C):
        out = route(probs, K, C)
        calls.append([t.detach() if keep_on_device else t.detach().cpu()
                      for t in (out[1], out[2], out[3], out[0])])
        return out
    blocks.moe_route = recording
    try:
        yield calls
    finally:
        blocks.moe_route = route


def _seed_leaves(torch, params, names):
    """Overwrite the leaves named in ``names`` (zeros in the reference's
    init) with seeded values."""
    from repro_torch.tree import flatten_with_path
    rng = np.random.default_rng(0)
    for path, leaf in flatten_with_path(params):
        if path[-1] in names:
            leaf.copy_(torch.from_numpy(rng.normal(
                0.0, 0.3, tuple(leaf.shape)).astype(np.float32)))


def moe_grad_inputs(torch):
    """(c)'s config, parameters (on the CPU, from seed 0, the
    ``MOE_SEEDED`` leaves seeded) and batch, the same in both processes."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.nn import Model, get_config
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_GRAD_LAYERS,
                              dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    _seed_leaves(torch, params, MOE_SEEDED)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=MOE_GRAD_SEQ,
                          global_batch=MOE_GRAD_BATCH, seed=0).batch(0)
    return cfg, params, batch


def moe_cpu_reference():
    """(c)'s CPU side, in the child process after the hybrid's: the f32
    loss, its gradient through the plain versions without remat, and each
    layer's expert ids and keep mask."""
    import dataclasses
    import torch
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    t0 = time.perf_counter()
    cfg, params, batch = moe_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with recorded_routes() as routes:
        loss, _ = Model(dataclasses.replace(cfg, remat=False),
                        device="cpu").loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    return {"loss": float(loss.detach()), "grads": list(grads),
            "routes": [r[:2] for r in routes],
            "secs": time.perf_counter() - t0}


def moe_train_grad_check(torch, reference):
    """Phase 18 (c): the f32 ``Model.loss`` gradient of qwen2-moe-a2.7b at
    full width, ``MOE_GRAD_LAYERS`` layers, ``MOE_GRAD_BATCH`` x
    ``MOE_GRAD_SEQ``, remat on, the ``MOE_SEEDED`` leaves seeded: first
    every layer's expert ids and keep mask, card against CPU (the CPU side
    computed by ``moe_cpu_reference`` in the child process), which must be
    equal (a flip means the two computed other functions), and the
    backward's recomputed routing equal to the forward's on the card; then
    each leaf within ``TRAIN_GRAD_TOL`` of its largest magnitude."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    cpu = wait_cpu_reference(reference, "moe")
    waited = cpu["waited"]
    cfg, params, batch = moe_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().to("cuda").requires_grad_(), params)
    n0 = (flash_attention_kernel.launches,
          flash_attention_bwd_kernel.launches)
    t0 = time.perf_counter()
    with recorded_routes(keep_on_device=True) as routes:
        loss, _ = Model(cfg, device="cuda").loss(live, batch)
        grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    n = (flash_attention_kernel.launches - n0[0],
         flash_attention_bwd_kernel.launches - n0[1])
    L = cfg.n_layers
    check(len(routes) == 2 * L and len(cpu["routes"]) == L,
          f"train_moe (c): {len(routes)} routing calls on the card, "
          f"{len(cpu['routes'])} on the CPU")
    flips = [int((a[0].cpu() != b[0]).sum()) + int((a[1].cpu() != b[1]).sum())
             for a, b in zip(routes[:L], cpu["routes"])]
    recompute = all(torch.equal(a, b) for i in range(L)
                    for a, b in zip(routes[i], routes[2 * L - 1 - i]))
    print(f"train_moe (c): expert ids and keep masks, card against CPU, "
          f"differing entries by layer {flips}; the backward's recomputed "
          f"routing equal to the forward's on the card: {recompute}")
    check(not any(flips), f"train_moe (c): routing differs between card and "
                          f"CPU by layer {flips}: they computed different "
                          f"functions")
    check(recompute, "train_moe (c): remat's recompute routed otherwise")
    worst, worst_path, _ = grads_card_vs_cpu(
        "train_moe (c)", params, cpu["grads"], grads)
    card_loss = float(loss.detach())
    rel_loss = abs(card_loss - cpu["loss"]) / abs(cpu["loss"])
    print(f"train_moe (c): f32 Model.loss gradient, {MOE_ARCH} full width, "
          f"{L} layers, {MOE_GRAD_BATCH} x {MOE_GRAD_SEQ}, seeded "
          f"{'/'.join(MOE_SEEDED)}: loss card {card_loss!r} CPU "
          f"{cpu['loss']!r} (rel {rel_loss:.3e}); every leaf within "
          f"{worst:.3e} of its largest magnitude ({worst_path}; <= "
          f"{TRAIN_GRAD_TOL}); flash launches forward / backward {n[0]} / "
          f"{n[1]}; CPU {cpu['secs']:.2f} s in the child process (waited "
          f"{waited:.2f} s for it here), card {card_s:.2f} s [{CARD}]")
    check(rel_loss <= 1e-5 and n == (2 * L, L),
          f"train_moe (c): loss rel {rel_loss}, flash launches {n}")
    return {"worst_leaf_rel": worst, "loss_rel": rel_loss,
            "route_flips": flips, "recompute_equal": recompute,
            "cpu_s": cpu["secs"], "waited_s": waited}


def moe_train_launcher_run(torch):
    """Phase 18 (d): the train launcher's code (``launch.train.train``) at
    qwen2-moe-a2.7b's full width and ``MOE_TRAIN_LAYERS`` of its 24 layers
    (the cut printed beside full depth's state), ``TRAIN_BATCH`` x
    ``TRAIN_SEQ`` bf16 batches on f32 masters and f32 AdamW moments, remat
    a layer, ``TRAIN_STEPS`` steps, the checkpoint into a temporary
    directory, removed after.  The flash counters zeroed just before and
    read just after (2 forward launches a layer and step, remat's
    recompute among them, and 1 backward call); the first loss near ln V +
    s2/2 + 0.01 aux, aux near 1 a layer; every loss and grad norm finite,
    no restart; the step's time (its median past the first), tokens/s, the
    6 N D share of the bf16 peak with N = ``active_params_count()`` (the
    reference's ``model_flops_for``) and with N = ``params_count()``, and
    the peak memory.  Returns the launches and the figures."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.launch import train as launch_train
    from repro_torch.nn import get_config
    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    leaves_n = moe_leaves(cfg)
    check(moe_leaves(full) == MOE_PARAMS,
          f"train_moe (d): {moe_leaves(full)} leaves at full depth")
    deeper = moe_leaves(dataclasses.replace(cfg, n_layers=cfg.n_layers + 1))
    print(f"train_moe (d): {MOE_ARCH} cut to {cfg.n_layers} of "
          f"{full.n_layers} layers, full width: {leaves_n:,} f32 leaves, "
          f"{16 * leaves_n / 2**30:.2f} GiB of masters, gradients and AdamW "
          f"moments, a {12 * leaves_n / 2**30:.2f} GiB checkpoint (full "
          f"depth's {MOE_PARAMS:,} leaves: {16 * MOE_PARAMS / 2**30:.2f} "
          f"GiB, more than the card; {cfg.n_layers + 1} layers' checkpoint, "
          f"{12 * deeper / 2**30:.2f} GiB, is more than the {RUN_DISK_GIB} "
          f"GiB a run may keep on disk)")
    check(12 * leaves_n / 2**30 < RUN_DISK_GIB < 12 * deeper / 2**30,
          f"train_moe (d): {cfg.n_layers} layers is not the deepest cut "
          f"whose checkpoint fits {RUN_DISK_GIB} GiB")
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        loop = launch_train.train(
            cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
            ckpt_dir=ckpt, ckpt_every=100, log_every=1)
        torch.cuda.synchronize()
        n = (flash_attention_kernel.launches,
             flash_attention_bwd_kernel.launches)
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ckpt) for f in fs)
        saved = os.listdir(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = [r for r in loop.metrics_log if "loss" in r]
    for r in loop.metrics_log:
        print(f"  train_moe {r}")
    steady = sorted(r["dt"] for r in recs[1:])
    step_s = steady[len(steady) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_active, n_all = cfg.active_params_count(), cfg.params_count()
    mfu = 6 * n_active * tokens / step_s / BF16_FLOPS
    mfu_all = 6 * n_all * tokens / step_s / BF16_FLOPS
    s2 = 0.02 ** 2 * cfg.d_model
    aux0 = recs[0]["aux"]
    expect = float(np.log(cfg.vocab)) + s2 / 2 + 0.01 * aux0
    want = (2 * cfg.n_layers * TRAIN_STEPS, cfg.n_layers * TRAIN_STEPS)
    print(f"train_moe (d): {MOE_ARCH} full width, {cfg.n_layers} layers, "
          f"through the launcher's train(), {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"bf16, {TRAIN_STEPS} steps: step {step_s*1e3:.2f} ms (median of "
          f"steps 1-{TRAIN_STEPS - 1}; step 0 {recs[0]['dt']*1e3:.2f} ms), "
          f"{tokens / step_s:,.0f} tokens/s, 6 N D {100 * mfu:.2f} % of "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s with N = active_params_count() "
          f"= {n_active:,} ({100 * mfu_all:.2f} % with N = params_count() = "
          f"{n_all:,}); loss {recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f}"
          f" (step 0 expected ln V + s2/2 + 0.01 aux = {expect:.4f}, aux "
          f"{aux0:.4f} over {cfg.n_layers} layers); peak memory {peak:.3f} "
          f"GiB; launches flash forward {n[0]}, backward {n[1]}; "
          f"{loop.restarts} restarts; checkpoint {saved} "
          f"{ckpt_bytes / 2**30:.3f} GiB, removed; {wall:.2f} s with init "
          f"and the checkpoint [{CARD}]")
    check(len(recs) == TRAIN_STEPS and loop.restarts == 0 and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in recs), f"train_moe (d): records {loop.metrics_log}")
    check(abs(recs[0]["loss"] - expect) <= 0.2
          and 0.5 <= aux0 / cfg.n_layers <= 2.0,
          f"train_moe (d): first loss {recs[0]['loss']} far from {expect}, "
          f"or aux {aux0} far from {cfg.n_layers}")
    check(n == want, f"train_moe (d): launches {n}, not {want}")
    check(saved == [f"step_{TRAIN_STEPS - 1}"],
          f"train_moe (d): checkpoint directory held {saved}")
    return {"flash_attention": n[0], "flash_attention_bwd": n[1]}, {
        "layers": cfg.n_layers, "leaves": leaves_n, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "mfu_6nd_active": mfu,
        "mfu_6nd_all": mfu_all, "peak_gib": peak,
        "losses": [r["loss"] for r in recs], "aux0": aux0,
        "checkpoint_gib": ckpt_bytes / 2**30}


def train_step_profile(torch, cfg, batch, label, extra=(), want=None):
    """At ``cfg`` on the card with the launcher's optimizer, after one
    untimed step on ``batch``: the step's parts on synchronized host clocks
    (forward, backward with remat's forward, AdamW), then one more step
    under ``torch.profiler``: the device's busy share, its top kernels, and
    the shares of the flash kernels and of ``extra``'s ((part, a substring
    of its kernels' names) pairs).  A step launches the flash forward twice
    a layer (remat's recompute) and its backward once, or ``want`` (forward,
    backward) times."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.nn import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.step import make_train_step
    from repro_torch.tree import leaves, tree_map
    m = Model(cfg, device="cuda")
    params = m.init(0)
    opt = AdamW(lr=3e-4, schedule=cosine_schedule(3e-4, 20, 100))
    state = opt.init(params)
    step = make_train_step(m, opt)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    parts = {}
    t0 = time.perf_counter()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = m.loss(live, batch)
    torch.cuda.synchronize()
    parts["forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    parts["backward (remat's forward in it)"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    it = iter(grads)
    opt.apply(params, state, tree_map(lambda _: next(it), params))
    torch.cuda.synchronize()
    parts["AdamW"] = time.perf_counter() - t0
    del live, loss, grads, it
    n0 = (flash_attention_kernel.launches,
          flash_attention_bwd_kernel.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = (flash_attention_kernel.launches - n0[0],
         flash_attention_bwd_kernel.launches - n0[1])
    busy, by_name = report_profile(prof, wall * 1e6, f"one {cfg.name} "
                                   f"train step, {cfg.n_layers} layers", 14)
    shares = {part: tuple(map(sum, zip((0.0, 0), *(
        v for k, v in by_name.items() if name in k))))
        for part, name in (("flash forward", "flash_attention_wgmma_kernel"),
                           ("flash backward dq", FLASH_BWD_KERNELS["dq"]),
                           ("flash backward dk/dv",
                            FLASH_BWD_KERNELS["dkdv"]), *extra)}
    total = sum(parts.values())
    print(f"{label}: the step's parts on synchronized host clocks: "
          + ", ".join(f"{k} {v*1e3:.1f} ms ({100 * v / total:.1f} %)"
                      for k, v in parts.items())
          + f"; profiled step {wall*1e3:.1f} ms, device busy "
            f"{busy/1e3:.1f} ms ({100 * busy / (wall * 1e6):.2f} %); "
          + ", ".join(f"{p} {t/1e3:.3f} ms in {k} events "
                      f"({100 * t / busy:.2f} % of busy)"
                      for p, (t, k) in shares.items())
          + f"; flash launches {n} [{CARD}]")
    check(n == (want or (2 * cfg.n_layers, cfg.n_layers))
          and all(k > 0 for _, k in shares.values()),
          f"{label}: launches {n}, profiled kernels {shares}")
    return {"parts_ms": {k: v * 1e3 for k, v in parts.items()},
            "profiled_step_ms": wall * 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / (wall * 1e6),
            "shares": {p: t / busy for p, (t, _) in shares.items()}}


def moe_train_profile(torch):
    """Phase 18 (e): ``train_step_profile`` at (d)'s configuration and
    batch, with the share of the gather and scatter kernels (the
    dispatch's forward and backward gathers, the combine's gather and its
    backward's scatter-add, the slot table)."""
    import dataclasses
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.nn import get_config
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_TRAIN_LAYERS)
    batch = TokenPipeline(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH).batch(0)
    return train_step_profile(torch, cfg, batch, "train_moe (e)",
                              (("gather and scatter", "scatter_gather"),))


def moe_train_phase(torch, reference):
    """Phase 18, the MoE's training: (a), (b), (d), (e), (f), then (c),
    whose CPU side (``reference``, from ``start_cpu_references``) has had
    the run to finish.  Returns the flash backward's MHA reading, the
    launches of (d), the main path, and the figures of (b)-(e)."""
    t0 = time.perf_counter()
    bwd = moe_bwd_readings(torch)
    gc.collect()
    torch.cuda.empty_cache()
    figures = {"dispatch": moe_dispatch_readings(torch)}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_moe (a), (b): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches, run = moe_train_launcher_run(torch)
    figures.update(run)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_moe (d): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    figures["profile"] = moe_train_profile(torch)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_moe (e): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    print(f"train_moe (f): the restart cut to {MOE_RESTART_LAYERS} layer "
          f"to keep the run within its time budget")
    train_restart_check(torch, MOE_ARCH, "train_moe (f)", exact=True,
                        layers=MOE_RESTART_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_moe (f): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    figures["grad_check"] = moe_train_grad_check(torch, reference)
    print(f"train_moe (c): {time.perf_counter() - t0:.2f} s")
    return bwd, launches, figures


def vlm_leaves(cfg):
    """The leaves of ``Model(cfg).init`` for a VLM config, by its shapes:
    the dense decoder's (``dense_leaves``) and ``vision_proj`` (1024, d)."""
    return dense_leaves(cfg) + 1024 * cfg.d_model


class SpecBatches:
    """Batches of ``cfg`` laid out as the port's ``launch/specs.py::
    input_specs`` of the train cell ``shape`` at ``batch`` rows (the
    reference's layout): ``TokenPipeline``'s tokens and labels at the
    specs' token length (a VLM's ``seq_len - n_patches``), then each
    modality stub the specs hold (``patch_embeds`` (B, P, 1024), audio's
    ``frames`` (B, n_frames, d_model)) drawn in f32 from a numpy generator
    seeded by (seed, step).  Deterministic in the step, so a restarted
    loop replays the stream; the model casts the stubs to its dtype."""
    STUBS = ("patch_embeds", "frames")

    def __init__(self, cfg, shape, batch, seed=0):
        import dataclasses
        from repro_torch.data.tokens import TokenPipeline
        from repro_torch.launch.specs import input_specs
        self.specs = input_specs(
            cfg, dataclasses.replace(shape, global_batch=batch),
            with_labels=True)
        self.text = TokenPipeline(vocab=cfg.vocab,
                                  seq_len=self.specs["tokens"].shape[1],
                                  global_batch=batch, seed=seed)
        self.seed = seed

    def batch(self, step):
        out = self.text.batch(step)
        rng = np.random.default_rng((self.seed, step))
        for name in self.STUBS:
            if name in self.specs:
                out[name] = rng.standard_normal(
                    tuple(self.specs[name].shape), dtype=np.float32)
        return out


def spec_train_loop(cfg, pipe, *, steps, ckpt_dir, lr=3e-4, log_every=1,
                    failure_hook=None, device="cuda"):
    """The training loop of a VLM or audio config built as
    ``launch.train.train`` builds one,
    with ``pipe`` (a ``SpecBatches``) in place of its ``TokenPipeline``:
    ``cfg`` from seed 0, AdamW on a cosine schedule (20 warm-up steps) with
    ``cfg.opt_state_dtype`` moments, ``make_train_step``, ``TrainLoop``;
    run to ``steps`` and returned."""
    from repro_torch.nn import Model
    from repro_torch.optim.adamw import AdamW, cosine_schedule
    from repro_torch.runtime.step import make_train_step
    from repro_torch.runtime.train import TrainConfig, TrainLoop
    model = Model(cfg, device=device)
    params = model.init(0)
    opt = AdamW(lr=lr, state_dtype=cfg.opt_state_dtype,
                schedule=cosine_schedule(lr, 20, steps))
    state = opt.init(params)
    loop = TrainLoop(TrainConfig(total_steps=steps, ckpt_every=100,
                                 ckpt_dir=ckpt_dir, log_every=log_every),
                     make_train_step(model, opt), pipe,
                     failure_hook=failure_hook)
    del model
    loop.run(params, state)
    return loop


def vlm_bwd_readings(torch):
    """Phase 19 (a): row 4b at llava-next-34b's train cell, (2, 4096, 56 /
    8 heads of 128), GQA 7:1, causal, before the model's state is on the
    card (autograd through the plain version holds several (2, 56, 4096,
    4096) f32 tensors): through ``FlashAttention`` against autograd
    through the plain version, f32 and bf16 (``bwd_agreement``), two calls
    bit-identical, the peak memory printed; in bf16 timed beside its bound,
    autograd through the plain version and SDPA's backward
    (``flash_bwd_timing``); the forward with lse and without it timed
    beside its bound, the plain version and SDPA (``flash_timing``).
    Returns the reading, the forward's under ``"forward"``."""
    from repro_torch.kernels.flash_attention import (KEY_TILE,
                                                     flash_attention_kernel)
    inputs = bwd_inputs(torch, 19)
    shape = (VLM_TRAIN_BATCH, VLM_TRAIN_SEQ, 56, 8, 128)
    reading = {"shape": list(shape)}
    for dt in (torch.float32, torch.bfloat16):
        torch.cuda.reset_peak_memory_stats()
        reading.update(bwd_agreement(torch, "VLM train cell", shape, dt,
                                     inputs))
        key = str(dt).replace("torch.", "")
        reading[f"{key}_check_peak_gib"] = peak = \
            torch.cuda.max_memory_allocated() / 2**30
        print(f"train_vlm (a): {key} check's peak memory {peak:.2f} GiB")
        gc.collect()
        torch.cuda.empty_cache()
    reading.update(flash_bwd_timing(torch, inputs, shape))
    B, S, Hq, Hkv, D = shape
    kw = dict(causal=True, offset=0, bk=KEY_TILE)
    fwd = flash_timing(torch, lambda s, dt: inputs(shape, dt)[:3],
                       (B, S, S, Hq, Hkv, D), kw, 2, torch.bfloat16)
    sets = [inputs(shape, torch.bfloat16)[:3] for _ in range(fwd["sets"])]
    fwd["with_lse_ms"], _ = time_calls(
        torch, lambda q, k, v: flash_attention_kernel(q, k, v, lse=True,
                                                      **kw), sets, 2)
    del sets
    print(f"train_vlm (a): flash forward {shape} bf16: "
          f"{fwd['with_lse_ms']*1e3:.2f} us with lse, {fwd['ms']*1e3:.2f} "
          f"us without, bound {fwd['bound_ms']*1e3:.2f} us "
          f"({fwd['bound_by']}), plain {fwd['plain_ms']*1e3:.2f} us, "
          f"scaled_dot_product_attention {fwd['library_ms']*1e3:.2f} us "
          f"[{CARD}]")
    reading["forward"] = fwd
    return reading


def vlm_grad_inputs(torch):
    """(c)'s config, parameters (on the CPU, from seed 0, the
    ``VLM_SEEDED`` leaves seeded) and batch, the same in both processes."""
    import dataclasses
    from repro_torch.nn import Model, get_config
    from repro_torch.nn.types import ShapeSpec
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_GRAD_LAYERS,
                              vocab=VLM_GRAD_VOCAB, dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    _seed_leaves(torch, params, VLM_SEEDED)
    batch = SpecBatches(cfg, ShapeSpec("vlm grad", cfg.n_patches
                                       + VLM_GRAD_TOKENS, 1, "train"),
                        1).batch(0)
    return cfg, params, batch


def vlm_cpu_reference():
    """(c)'s CPU side, in the child process after the MoE's: the f32 loss
    and its gradient through the plain versions without remat."""
    import dataclasses
    import torch
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    t0 = time.perf_counter()
    cfg, params, batch = vlm_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = Model(dataclasses.replace(cfg, remat=False),
                    device="cpu").loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    return {"loss": float(loss.detach()), "grads": list(grads),
            "secs": time.perf_counter() - t0}


def vlm_train_grad_check(torch, reference):
    """Phase 19 (c): the f32 ``Model.loss`` gradient of llava-next-34b at
    full width, ``VLM_GRAD_LAYERS`` layers, vocab ``VLM_GRAD_VOCAB``, one
    row of the 2880 patches and ``VLM_GRAD_TOKENS`` tokens, remat on, the
    ``VLM_SEEDED`` leaves seeded: the card (flash forward and backward on
    their f32 routes) against the CPU (``vlm_cpu_reference`` in the child
    process), each leaf, ``vision_proj`` among them, within
    ``TRAIN_GRAD_TOL`` of its largest magnitude."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    cpu = wait_cpu_reference(reference, "vlm")
    cfg, params, batch = vlm_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().to("cuda").requires_grad_(), params)
    n0 = (flash_attention_kernel.launches,
          flash_attention_bwd_kernel.launches)
    t0 = time.perf_counter()
    loss, _ = Model(cfg, device="cuda").loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    n = (flash_attention_kernel.launches - n0[0],
         flash_attention_bwd_kernel.launches - n0[1])
    worst, worst_path, names = grads_card_vs_cpu(
        "train_vlm (c)", params, cpu["grads"], grads)
    card_loss = float(loss.detach())
    rel_loss = abs(card_loss - cpu["loss"]) / abs(cpu["loss"])
    L = cfg.n_layers
    print(f"train_vlm (c): f32 Model.loss gradient, {VLM_ARCH} full width, "
          f"{L} layers, vocab {VLM_GRAD_VOCAB}, 1 x ({cfg.n_patches} patches "
          f"+ {VLM_GRAD_TOKENS} tokens), seeded {'/'.join(VLM_SEEDED)}: loss "
          f"card {card_loss!r} CPU {cpu['loss']!r} (rel {rel_loss:.3e}); "
          f"every leaf of {len(names)} within {worst:.3e} of its largest "
          f"magnitude ({worst_path}; <= {TRAIN_GRAD_TOL}); flash launches "
          f"forward / backward {n[0]} / {n[1]}; CPU {cpu['secs']:.2f} s in "
          f"the child process (waited {cpu['waited']:.2f} s for it here), "
          f"card {card_s:.2f} s [{CARD}]")
    check("vision_proj" in names, f"train_vlm (c): leaves {names}")
    check(rel_loss <= 1e-5 and n == (2 * L, L),
          f"train_vlm (c): loss rel {rel_loss}, flash launches {n}")
    return {"worst_leaf_rel": worst, "loss_rel": rel_loss,
            "cpu_s": cpu["secs"], "waited_s": cpu["waited"]}


def vlm_train_run(torch):
    """Phase 19 (d): llava-next-34b at full width and ``VLM_TRAIN_LAYERS``
    of its 60 layers (the cut printed beside full depth's state) through
    ``spec_train_loop``: ``VLM_TRAIN_BATCH`` rows of 2880 patches and 1216
    tokens a step, bf16 on f32 masters and f32 AdamW moments, remat a
    layer, ``TRAIN_STEPS`` steps, the checkpoint into a temporary
    directory, removed after.  The flash counters zeroed just before and
    read just after (2 forward launches a layer and step, remat's
    recompute among them, and 1 backward call); the first loss near ln V +
    s2/2; every loss and grad norm finite, no restart; the step's time (its
    median past the first), positions/s and text tokens/s, the 6 N D share
    of the bf16 peak with N = ``params_count()`` and D the positions (the
    reference's ``model_flops_for``), the peak memory and the checkpoint's
    size.  Returns the launches and the figures."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.nn import get_config
    from repro_torch.nn.types import SHAPES
    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS)
    leaves_n = vlm_leaves(cfg)
    check(vlm_leaves(full) == VLM_FULL_LEAVES,
          f"train_vlm (d): {vlm_leaves(full)} leaves at full depth")
    deeper = vlm_leaves(dataclasses.replace(cfg, n_layers=cfg.n_layers + 1))
    print(f"train_vlm (d): {VLM_ARCH} cut to {cfg.n_layers} of "
          f"{full.n_layers} layers, full width: {leaves_n:,} f32 leaves, "
          f"{16 * leaves_n / 2**30:.2f} GiB of masters, gradients and AdamW "
          f"moments, a {12 * leaves_n / 2**30:.2f} GiB checkpoint (full "
          f"depth's {VLM_FULL_LEAVES:,} leaves: "
          f"{16 * VLM_FULL_LEAVES / 2**30:.1f} GiB, more than the card; "
          f"{cfg.n_layers + 1} layers' checkpoint, "
          f"{12 * deeper / 2**30:.2f} GiB, is more than the {RUN_DISK_GIB} "
          f"GiB a run may keep on disk)")
    check(12 * leaves_n / 2**30 < RUN_DISK_GIB < 12 * deeper / 2**30,
          f"train_vlm (d): {cfg.n_layers} layers is not the deepest cut "
          f"whose checkpoint fits {RUN_DISK_GIB} GiB")
    P = cfg.n_patches
    pipe = SpecBatches(cfg, SHAPES["train_4k"], VLM_TRAIN_BATCH)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        loop = spec_train_loop(cfg, pipe, steps=TRAIN_STEPS, ckpt_dir=ckpt)
        torch.cuda.synchronize()
        n = (flash_attention_kernel.launches,
             flash_attention_bwd_kernel.launches)
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ckpt) for f in fs)
        saved = os.listdir(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = [r for r in loop.metrics_log if "loss" in r]
    for r in loop.metrics_log:
        print(f"  train_vlm {r}")
    steady = sorted(r["dt"] for r in recs[1:])
    step_s = steady[len(steady) // 2]
    positions = VLM_TRAIN_BATCH * VLM_TRAIN_SEQ
    text = VLM_TRAIN_BATCH * (VLM_TRAIN_SEQ - P)
    n_all = cfg.params_count()
    mfu = 6 * n_all * positions / step_s / BF16_FLOPS
    s2 = 0.02 ** 2 * cfg.d_model
    expect = float(np.log(cfg.vocab)) + s2 / 2
    want = (2 * cfg.n_layers * TRAIN_STEPS, cfg.n_layers * TRAIN_STEPS)
    print(f"train_vlm (d): {VLM_ARCH} full width, {cfg.n_layers} layers, "
          f"through make_train_step and TrainLoop, {VLM_TRAIN_BATCH} x "
          f"({P} patches + {VLM_TRAIN_SEQ - P} tokens) bf16, {TRAIN_STEPS} "
          f"steps: step {step_s*1e3:.2f} ms (median of steps "
          f"1-{TRAIN_STEPS - 1}; step 0 {recs[0]['dt']*1e3:.2f} ms), "
          f"{positions / step_s:,.0f} positions/s, {text / step_s:,.0f} text "
          f"tokens/s, 6 N D {100 * mfu:.2f} % of {BF16_FLOPS / 1e12:.0f} "
          f"TFLOP/s (N = params_count() = {n_all:,}, D = {positions} "
          f"positions); loss {recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f} "
          f"(step 0 expected ln V + s2/2 = {expect:.4f}); peak memory "
          f"{peak:.3f} GiB; launches flash forward {n[0]}, backward {n[1]}; "
          f"{loop.restarts} restarts; checkpoint {saved} "
          f"{ckpt_bytes / 2**30:.3f} GiB, removed; {wall:.2f} s with init "
          f"and the checkpoint [{CARD}]")
    check(len(recs) == TRAIN_STEPS and loop.restarts == 0 and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in recs), f"train_vlm (d): records {loop.metrics_log}")
    check(abs(recs[0]["loss"] - expect) <= 0.2,
          f"train_vlm (d): first loss {recs[0]['loss']} far from {expect}")
    check(n == want, f"train_vlm (d): launches {n}, not {want}")
    check(saved == [f"step_{TRAIN_STEPS - 1}"],
          f"train_vlm (d): checkpoint directory held {saved}")
    return {"flash_attention": n[0], "flash_attention_bwd": n[1]}, {
        "layers": cfg.n_layers, "leaves": leaves_n, "step_ms": step_s * 1e3,
        "positions_per_s": positions / step_s,
        "text_tokens_per_s": text / step_s, "mfu_6nd": mfu,
        "peak_gib": peak, "losses": [r["loss"] for r in recs],
        "checkpoint_gib": ckpt_bytes / 2**30}


def vlm_train_profile(torch):
    """Phase 19 (e): ``train_step_profile`` at (d)'s configuration and
    first batch."""
    import dataclasses
    from repro_torch.nn import get_config
    from repro_torch.nn.types import SHAPES
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_TRAIN_LAYERS)
    batch = SpecBatches(cfg, SHAPES["train_4k"], VLM_TRAIN_BATCH).batch(0)
    return train_step_profile(torch, cfg, batch, "train_vlm (e)")


def vlm_train_phase(torch, reference):
    """Phase 19, the VLM's training: (a), (d), (e), then (c), whose CPU
    side (``reference``, from ``start_cpu_references``) has had the run to
    finish.  Returns the flash reading at the train cell, the launches of
    (d), the main path, and the figures of (c)-(e)."""
    t0 = time.perf_counter()
    bwd = vlm_bwd_readings(torch)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_vlm (a): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    launches, figures = vlm_train_run(torch)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_vlm (d): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    figures["profile"] = vlm_train_profile(torch)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_vlm (e): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    figures["grad_check"] = vlm_train_grad_check(torch, reference)
    print(f"train_vlm (c): {time.perf_counter() - t0:.2f} s")
    return bwd, launches, figures


def audio_leaves(cfg):
    """The leaves of ``Model(cfg).init`` for an audio config, by its
    shapes: per encoder layer the attention (with the QKV bias where the
    config has it), the gated MLP and two norms; per decoder layer two
    attentions (self and cross), the MLP and three norms; the embedding,
    the head, the encoder's and the final norm once."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    attn = 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
    if cfg.qkv_bias:
        attn += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return (cfg.n_enc_layers * (attn + 3 * d * f + 2 * d)
            + cfg.n_layers * (2 * attn + 3 * d * f + 3 * d)
            + 2 * cfg.vocab * d + 2 * d)


def audio_bwd_readings(torch):
    """Phase 20 (a): row 4b at whisper-base's three training layouts,
    ``AUD_TRAIN_BATCH`` rows, 8 / 8 heads of 64 -- the encoder's
    self-attention (1500 x 1500, non-causal), the decoder's (4096, causal)
    and the cross-attention (4096 queries against 1500 frames, non-causal,
    query row 0 at key position 1500 - 4096 as the model places it; 1500 =
    23 x 64 + 28 ends in a ragged key tile) -- before the model's state is
    on the card: through ``FlashAttention`` against autograd through the
    plain version, f32 and bf16 (``bwd_agreement``), two calls
    bit-identical; in bf16 timed beside its bound, autograd through the
    plain version and SDPA's backward (``flash_bwd_timing``); the forward
    timed beside its bound, the plain version and SDPA (``flash_timing``).
    Returns {layout: reading}, each with its forward's under
    ``"forward"``."""
    from repro_torch.kernels.flash_attention import KEY_TILE
    from repro_torch.nn import get_config
    from repro_torch.nn.types import SHAPES
    cfg = get_config(AUD_ARCH)
    S, F_ = SHAPES["train_4k"].seq_len, cfg.n_frames
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_)
    layouts = {"encoder": ((AUD_TRAIN_BATCH, F_, F_, *heads), False),
               "decoder": ((AUD_TRAIN_BATCH, S, S, *heads), True),
               "cross": ((AUD_TRAIN_BATCH, S, F_, *heads), False)}
    inputs = bwd_inputs(torch, 20)
    out = {}
    for name, (shape, causal) in layouts.items():
        label = f"whisper-base train {name}"
        reading = {"shape": list(shape), "causal": causal}
        for dt in (torch.float32, torch.bfloat16):
            torch.cuda.reset_peak_memory_stats()
            reading.update(bwd_agreement(torch, label, shape, dt, inputs,
                                         causal=causal))
            key = str(dt).replace("torch.", "")
            reading[f"{key}_check_peak_gib"] = peak = \
                torch.cuda.max_memory_allocated() / 2**30
            print(f"train_audio (a): {name} {key} check's peak memory "
                  f"{peak:.2f} GiB")
            gc.collect()
            torch.cuda.empty_cache()
        reading.update(flash_bwd_timing(torch, inputs, shape, causal=causal))
        B, Sq, Skv = shape[:3]
        fwd = flash_timing(torch, lambda s, dt: inputs(s, dt)[:3], shape,
                           dict(causal=causal, offset=Skv - Sq, bk=KEY_TILE),
                           2, torch.bfloat16)
        print(f"train_audio (a): flash forward {name} {shape} bf16"
              f"{'' if causal else ' non-causal'}: {fwd['ms']*1e3:.2f} us, "
              f"bound {fwd['bound_ms']*1e3:.2f} us ({fwd['bound_by']}), plain "
              f"{fwd['plain_ms']*1e3:.2f} us, scaled_dot_product_attention "
              f"{fwd['library_ms']*1e3:.2f} us [{CARD}]")
        reading["forward"] = fwd
        out[name] = reading
        gc.collect()
        torch.cuda.empty_cache()
    return out


def audio_flash_calls(cfg):
    """(forward, backward) flash calls of one ``Model.loss`` gradient with
    remat: the encoder's, the decoder's self- and cross-attention a layer,
    each forward run twice (remat's recompute) and differentiated once."""
    n = cfg.n_enc_layers + 2 * cfg.n_layers
    return 2 * n, n


def audio_grad_inputs(torch):
    """(b)'s config (full width, depth and vocabulary, f32), parameters
    (on the CPU, from seed 0, the ``AUD_SEEDED`` leaves seeded) and batch
    (one row of ``AUD_GRAD_TOKENS`` tokens and the frames), the same in
    both processes."""
    import dataclasses
    from repro_torch.nn import Model, get_config
    from repro_torch.nn.types import ShapeSpec
    cfg = dataclasses.replace(get_config(AUD_ARCH), dtype="float32")
    params = Model(cfg, device="cpu").init(0)
    _seed_leaves(torch, params, AUD_SEEDED)
    batch = SpecBatches(cfg, ShapeSpec("audio grad", AUD_GRAD_TOKENS, 1,
                                       "train"), 1).batch(0)
    return cfg, params, batch


def audio_cpu_reference():
    """(b)'s CPU side, in the child process after the VLM's: the f32 loss
    and its gradient through the plain versions without remat."""
    import dataclasses
    import torch
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    t0 = time.perf_counter()
    cfg, params, batch = audio_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = Model(dataclasses.replace(cfg, remat=False),
                    device="cpu").loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    return {"loss": float(loss.detach()), "grads": list(grads),
            "secs": time.perf_counter() - t0}


def audio_train_grad_check(torch, reference):
    """Phase 20 (b): the f32 ``Model.loss`` gradient of whisper-base at
    full width, depth and vocabulary, one row of ``AUD_GRAD_TOKENS`` tokens
    and 1500 frames, remat on, the ``AUD_SEEDED`` norms seeded: the card
    (flash forward and backward on their f32 routes) against the CPU
    (``audio_cpu_reference`` in the child process), each leaf -- the
    encoder's and the cross-attention's among them -- within
    ``TRAIN_GRAD_TOL`` of its largest magnitude; the flash calls those of
    ``audio_flash_calls``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.nn import Model
    from repro_torch.tree import leaves, tree_map
    cpu = wait_cpu_reference(reference, "audio")
    cfg, params, batch = audio_grad_inputs(torch)
    live = tree_map(lambda p: p.detach().to("cuda").requires_grad_(), params)
    n0 = (flash_attention_kernel.launches,
          flash_attention_bwd_kernel.launches)
    t0 = time.perf_counter()
    loss, _ = Model(cfg, device="cuda").loss(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    n = (flash_attention_kernel.launches - n0[0],
         flash_attention_bwd_kernel.launches - n0[1])
    worst, worst_path, names = grads_card_vs_cpu(
        "train_audio (b)", params, cpu["grads"], grads)
    card_loss = float(loss.detach())
    rel_loss = abs(card_loss - cpu["loss"]) / abs(cpu["loss"])
    print(f"train_audio (b): f32 Model.loss gradient, {AUD_ARCH} full width "
          f"and depth ({cfg.n_enc_layers} + {cfg.n_layers} layers), vocab "
          f"{cfg.vocab}, 1 x ({cfg.n_frames} frames, {AUD_GRAD_TOKENS} "
          f"tokens), seeded {'/'.join(AUD_SEEDED)}: loss card {card_loss!r} "
          f"CPU {cpu['loss']!r} (rel {rel_loss:.3e}); every leaf of "
          f"{len(names)} within {worst:.3e} of its largest magnitude "
          f"({worst_path}; <= {TRAIN_GRAD_TOL}); flash launches forward / "
          f"backward {n[0]} / {n[1]}; CPU {cpu['secs']:.2f} s in the child "
          f"process (waited {cpu['waited']:.2f} s for it here), card "
          f"{card_s:.2f} s [{CARD}]")
    check({"enc_layers/attn/wq", "layers/xattn/wk", "enc_norm"}
          <= set(names), f"train_audio (b): leaves {names}")
    check(rel_loss <= 1e-5 and n == audio_flash_calls(cfg),
          f"train_audio (b): loss rel {rel_loss}, flash launches {n}")
    return {"worst_leaf_rel": worst, "worst_leaf": worst_path,
            "loss_rel": rel_loss, "cpu_s": cpu["secs"],
            "waited_s": cpu["waited"]}


def audio_train_rows(torch, cfg):
    """(c)'s rows a step: ``AUD_TRAIN_BATCH_MAX`` where the peak memory of
    one ``make_train_step`` step at ``AUD_TRAIN_BATCH`` rows of the train
    cell's layout (from the state's allocation on: the model, AdamW as the
    launcher builds it, the step) stays under ``AUD_TRAIN_PEAK_GIB``, else
    ``AUD_TRAIN_BATCH``; printed with why.  Returns (rows, the peak)."""
    from repro_torch.nn import Model
    from repro_torch.nn.types import SHAPES
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.step import make_train_step
    torch.cuda.reset_peak_memory_stats()
    m = Model(cfg, device="cuda")
    params = m.init(0)
    opt = AdamW(lr=3e-4, state_dtype=cfg.opt_state_dtype)
    state = opt.init(params)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in SpecBatches(
        cfg, SHAPES["train_4k"], AUD_TRAIN_BATCH).batch(0).items()}
    make_train_step(m, opt)(params, state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del m, params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    rows = (AUD_TRAIN_BATCH_MAX if peak < AUD_TRAIN_PEAK_GIB
            else AUD_TRAIN_BATCH)
    print(f"train_audio (c): one step at {AUD_TRAIN_BATCH} rows peaked at "
          f"{peak:.3f} GiB, {'under' if rows > AUD_TRAIN_BATCH else 'not under'}"
          f" {AUD_TRAIN_PEAK_GIB} GiB, so the run takes {rows} rows a step "
          f"[{CARD}]")
    return rows, peak


def audio_train_run(torch, rows):
    """Phase 20 (c): whisper-base at full width and depth through
    ``spec_train_loop`` on ``SpecBatches`` at the train cell's layout,
    ``rows`` rows of 4096 tokens and 1500 frames a step, bf16 on f32
    masters and f32 AdamW moments, remat a layer, ``AUD_TRAIN_STEPS``
    steps, the checkpoint into a temporary directory, removed after.  The
    flash counters zeroed just before and read just after (each step
    ``audio_flash_calls``); the first loss near ln V + s2/2, every loss and
    grad norm finite, the last loss below the first, no restart; the
    step's time (its median past the first), tokens/s and frames/s, the 6 N
    D share of the bf16 peak with the reference's ``model_flops_for`` (N =
    ``active_params_count()``, D the decoder's tokens; the frames are not
    counted), the peak memory and the checkpoint's size.  Returns the
    launches and the figures."""
    import shutil
    import tempfile
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_kernel, flash_attention_kernel)
    from repro_torch.nn import get_config
    from repro_torch.nn.types import SHAPES
    cfg = get_config(AUD_ARCH)
    leaves_n = audio_leaves(cfg)
    print(f"train_audio (c): {AUD_ARCH} at full width and depth "
          f"({cfg.n_enc_layers} encoder and {cfg.n_layers} decoder layers): "
          f"{leaves_n:,} f32 leaves, {16 * leaves_n / 2**30:.2f} GiB of "
          f"masters, gradients and AdamW moments, a "
          f"{12 * leaves_n / 2**30:.2f} GiB checkpoint; nothing cut")
    check(leaves_n == AUD_PARAMS, f"train_audio (c): {leaves_n} leaves")
    pipe = SpecBatches(cfg, SHAPES["train_4k"], rows)
    S, F_ = pipe.specs["tokens"].shape[1], pipe.specs["frames"].shape[1]
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    torch.cuda.reset_peak_memory_stats()
    flash_attention_kernel.launches = 0
    flash_attention_bwd_kernel.launches = 0
    t0 = time.perf_counter()
    try:
        loop = spec_train_loop(cfg, pipe, steps=AUD_TRAIN_STEPS,
                               ckpt_dir=ckpt)
        torch.cuda.synchronize()
        n = (flash_attention_kernel.launches,
             flash_attention_bwd_kernel.launches)
        wall = time.perf_counter() - t0
        ckpt_bytes = sum(os.path.getsize(os.path.join(r, f))
                         for r, _, fs in os.walk(ckpt) for f in fs)
        saved = os.listdir(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = [r for r in loop.metrics_log if "loss" in r]
    for r in loop.metrics_log:
        print(f"  train_audio {r}")
    steady = sorted(r["dt"] for r in recs[1:])
    step_s = steady[len(steady) // 2]
    tokens, frames = rows * S, rows * F_
    n_act = cfg.active_params_count()
    mfu = 6 * n_act * tokens / step_s / BF16_FLOPS
    expect = float(np.log(cfg.vocab)) + 0.02 ** 2 * cfg.d_model / 2
    fwd, bwd = audio_flash_calls(cfg)
    want = (fwd * AUD_TRAIN_STEPS, bwd * AUD_TRAIN_STEPS)
    print(f"train_audio (c): {AUD_ARCH} full width and depth, through "
          f"make_train_step and TrainLoop, {rows} x ({F_} frames, {S} "
          f"tokens) bf16, {AUD_TRAIN_STEPS} steps: step {step_s*1e3:.2f} ms "
          f"(median of steps 1-{AUD_TRAIN_STEPS - 1}; step 0 "
          f"{recs[0]['dt']*1e3:.2f} ms), {tokens / step_s:,.0f} tokens/s "
          f"and {frames / step_s:,.0f} frames/s, 6 N D {100 * mfu:.2f} % of "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s (the reference's "
          f"model_flops_for: N = active_params_count() = {n_act:,}, D = "
          f"{tokens} tokens; the frames are not counted); loss "
          f"{recs[0]['loss']:.4f} -> {recs[-1]['loss']:.4f} (step 0 expected "
          f"ln V + s2/2 = {expect:.4f}); peak memory {peak:.3f} GiB; "
          f"launches flash forward {n[0]}, backward {n[1]} (predicted "
          f"{want[0]}, {want[1]}); {loop.restarts} restarts; checkpoint "
          f"{saved} {ckpt_bytes / 2**30:.3f} GiB, removed; {wall:.2f} s with "
          f"init and the checkpoint [{CARD}]")
    check(len(recs) == AUD_TRAIN_STEPS and loop.restarts == 0 and all(
        np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        for r in recs), f"train_audio (c): records {loop.metrics_log}")
    check(abs(recs[0]["loss"] - expect) <= 0.2,
          f"train_audio (c): first loss {recs[0]['loss']} far from {expect}")
    check(recs[-1]["loss"] < recs[0]["loss"],
          f"train_audio (c): the loss did not fall: {recs}")
    check(n == want, f"train_audio (c): launches {n}, not {want}")
    check(saved == [f"step_{AUD_TRAIN_STEPS - 1}"],
          f"train_audio (c): checkpoint directory held {saved}")
    return {"flash_attention": n[0], "flash_attention_bwd": n[1]}, {
        "rows": rows, "leaves": leaves_n, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s, "frames_per_s": frames / step_s,
        "mfu_6nd": mfu, "peak_gib": peak,
        "losses": [r["loss"] for r in recs],
        "checkpoint_gib": ckpt_bytes / 2**30}


def audio_train_phase(torch, reference):
    """Phase 20, the audio family's training: (a); (c) with its rows
    chosen by one step's peak; (e) ``train_step_profile`` at (c)'s rows and
    first batch; (d) the restart (``train_restart_check`` at full width and
    depth on ``SpecBatches``); then (b), whose CPU side (``reference``,
    from ``start_cpu_references``) has had the run to finish.  Returns the
    flash readings at the three layouts, the launches of (c), the main
    path, and the figures of (b)-(e)."""
    from repro_torch.nn import get_config
    from repro_torch.nn.types import SHAPES
    cfg = get_config(AUD_ARCH)
    t0 = time.perf_counter()
    bwd = audio_bwd_readings(torch)
    print(f"train_audio (a): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rows, probe_peak = audio_train_rows(torch, cfg)
    launches, figures = audio_train_run(torch, rows)
    figures["probe_peak_gib"] = probe_peak
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_audio (c): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    figures["profile"] = train_step_profile(
        torch, cfg, SpecBatches(cfg, SHAPES["train_4k"], rows).batch(0),
        "train_audio (e)", want=audio_flash_calls(cfg))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_audio (e): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    train_restart_check(torch, AUD_ARCH, "train_audio (d)", cfg=cfg,
                        pipe=SpecBatches(cfg, SHAPES["train_4k"],
                                         AUD_RESTART_BATCH))
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train_audio (d): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    figures["grad_check"] = audio_train_grad_check(torch, reference)
    print(f"train_audio (b): {time.perf_counter() - t0:.2f} s")
    return bwd, launches, figures


CPU_REFERENCES = {"hybrid": hybrid_cpu_reference, "moe": moe_cpu_reference,
                  "vlm": vlm_cpu_reference, "audio": audio_cpu_reference}


def main() -> int:
    global CARD
    # phase 15 (d) runs with deterministic algorithms, which for cuBLAS
    # needs this set before its first call in the process
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CARD = card_line()
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    sources = ("paged_gather", "paged_attention", "csd_matvec",
               "flash_attention", "flash_attention_bwd", "linear_scan",
               "qmatmul", "chain_scan", "wkv6", "wkv6_bwd")
    t0 = time.perf_counter()
    build.build(sources)
    print(f"build: {time.perf_counter()-t0:.2f} s "
          f"({', '.join(n + '.cu' for n in sources)}, in parallel)")
    # phases 17-19 (c)'s and 20 (b)'s CPU sides run beside the card's
    # phases
    cpu_reference = start_cpu_references()
    for name in sources:
        for fn, line in ptxas_lines(build.build_log(name)):
            print(f"  ptxas {name} {fn}: {line}")
            if name in ("chain_scan", "wkv6", "flash_attention_bwd"):
                check(not any(int(n) for n in re.findall(
                    r"(\d+) bytes spill", line)),
                    f"{name} {fn}: ptxas spills: {line}")
    t0 = time.perf_counter()
    kernels = kernel_phase(torch)
    kernels += csd_kernel_phase(torch)
    kernels.append(flash_kernel_phase(torch))
    kernels.append(linear_scan_kernel_phase(torch))
    print(f"kernel phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    qm_row, qm_launches = qmatmul_phase(torch)
    kernels.append(qm_row)
    print(f"qmatmul phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    tiny_reference_phase(torch)
    tiny_lm_phase(torch)
    tiny_rwkv_phase(torch)
    print(f"tiny reference phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    launches, combines, eng, spec, cfg = serving_phase(torch)
    print(f"serving phase: {time.perf_counter()-t0:.2f} s")
    profile_phase(torch, eng, spec)
    t0 = time.perf_counter()
    paper_launches, paper_run, tm_np = paper_phase(torch)
    launches.update(paper_launches)
    print(f"paper phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    chain_rows, chain_launches = chains_phase(torch, paper_run, tm_np)
    kernels += chain_rows
    for name, n in chain_launches.items():
        launches[name] += n
    del paper_run, tm_np
    print(f"chains phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    explore_launches = explore_phase(torch)
    print(f"explore phase: {time.perf_counter()-t0:.2f} s")
    t0 = time.perf_counter()
    ptq_launches, run = ptq_phase(torch)
    launches.update(ptq_launches)
    print(f"ptq phase: {time.perf_counter()-t0:.2f} s")
    reference_profile_phase(torch, run)
    del run
    t0 = time.perf_counter()
    mixed_launches, mixed_run = mixed_phase(torch)
    print(f"mixed phase: {time.perf_counter()-t0:.2f} s")
    del eng, spec, mixed_run            # the hybrid's 22.49 GiB need room
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hybrid_launches = hybrid_phase(torch)
    print(f"hybrid phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()                        # the MoE's 53.33 GiB need the room
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_launches, moe_readings = moe_phase(torch)
    print(f"moe phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kernels.append(wkv6_kernel_readings(torch))
    rwkv_launches = rwkv_phase(torch)
    print(f"rwkv phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    audio_readings = audio_kernel_readings(torch)
    audio_launches = audio_phase(torch)
    print(f"audio phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vlm_readings = vlm_kernel_readings(torch)
    vlm_launches = vlm_phase(torch)
    print(f"vlm phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dense_readings = dense_kernel_readings(torch)
    dense_launches = dense_phase(torch)
    print(f"dense phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bwd_row = train_kernel_readings(torch)
    kernels.append(bwd_row)
    train_launches, train_figures = train_phase(torch)
    print(f"train phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wkv_bwd_row = wkv6_bwd_readings(torch)
    kernels.append(wkv_bwd_row)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_train_launches, rwkv_train_figures = rwkv_train_phase(torch)
    print(f"train_rwkv phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hyb_bwd, scan_bwd, hyb_train_launches, hyb_train_figures = \
        hybrid_train_phase(torch, cpu_reference)
    print(f"train_hybrid phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_bwd, moe_train_launches, moe_train_figures = moe_train_phase(
        torch, cpu_reference)
    print(f"train_moe phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vlm_bwd, vlm_train_launches, vlm_train_figures = vlm_train_phase(
        torch, cpu_reference)
    print(f"train_vlm phase: {time.perf_counter()-t0:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    aud_bwd, aud_train_launches, aud_train_figures = audio_train_phase(
        torch, cpu_reference)
    print(f"train_audio phase: {time.perf_counter()-t0:.2f} s")
    by_path = {"serving": {k: launches[k]
                           for k in ("paged_gather", "paged_attention")},
               "paper": paper_launches, "chains": chain_launches,
               "explore": explore_launches,
               "ptq": {"flash_attention": launches["flash_attention"]},
               "mixed": mixed_launches, "hybrid": hybrid_launches,
               "moe": moe_launches, "rwkv": rwkv_launches,
               "audio": audio_launches, "vlm": vlm_launches,
               "dense": dense_launches, "train": train_launches,
               "train_rwkv": rwkv_train_launches,
               "train_hybrid": hyb_train_launches,
               "train_moe": moe_train_launches,
               "train_vlm": vlm_train_launches,
               "train_audio": aud_train_launches,
               "op": {"qmatmul": qm_launches}}
    for name, n in hybrid_launches.items():
        launches[name] = launches.get(name, 0) + n
    for name, n in explore_launches.items():
        launches[name] += n
    for name, n in mixed_launches.items():
        launches[name] += n
    for name, n in moe_launches.items():
        launches[name] += n
    for name, n in audio_launches.items():
        launches[name] += n
    for name, n in vlm_launches.items():
        launches[name] += n
    for name, n in dense_launches.items():
        launches[name] += n
    for name, n in train_launches.items():
        launches[name] = launches.get(name, 0) + n
    for name, n in hyb_train_launches.items():
        launches[name] = launches.get(name, 0) + n
    for name, n in moe_train_launches.items():
        launches[name] += n
    for name, n in vlm_train_launches.items():
        launches[name] += n
    for name, n in aud_train_launches.items():
        launches[name] += n
    launches["qmatmul"] = qm_launches
    vlm_fwd = vlm_bwd.pop("forward")
    aud_fwd = {name: r.pop("forward") for name, r in aud_bwd.items()}
    launches["wkv6"] = rwkv_launches["wkv6"] + rwkv_train_launches["wkv6"]
    launches["wkv6_bwd"] = rwkv_train_launches["wkv6_bwd"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["name"] == "paged_attention":
            k["combine_launches"] = combines
        if k["name"] == "paged_gather":
            k["launch_unit"] = "one K+V pair (paged_gather_pair_kernel)"
        if k["name"] == "wkv6":
            k["route_launches"] = rwkv_launches["wkv6 routes"]
        k["launches_by_path"] = {p: v[k["name"]] for p, v in by_path.items()
                                 if k["name"] in v}
        if k["name"] in moe_readings:
            k["moe_shapes"] = moe_readings[k["name"]]
        if k["name"] in dense_readings:
            k["dense_shapes"] = dense_readings[k["name"]]
        if k["name"] == "flash_attention":
            k["audio_shapes"] = audio_readings
            k["vlm_shapes"] = vlm_readings
            k["forward_lse"] = bwd_row.pop("forward_lse")
            k["vlm_train_cell"] = vlm_fwd
            k["audio_train_cell"] = aud_fwd
        if k["name"] == "flash_attention_bwd":
            k["train_step"] = train_figures
            k["hybrid_shapes"] = hyb_bwd
            k["train_hybrid_step"] = hyb_train_figures
            k["mha_shapes"] = {"moe train cell": moe_bwd}
            k["train_moe_step"] = moe_train_figures
            k["vlm_train_cell"] = vlm_bwd
            k["train_vlm_step"] = vlm_train_figures
            k["audio_train_cell"] = aud_bwd
            k["train_audio_step"] = aud_train_figures
        if k["name"] == "linear_scan":
            k["backward"] = scan_bwd
            k["backward_calls"] = hyb_train_launches[
                "linear_scan backward calls"]
        if k["name"] == "wkv6_bwd":
            k["train_step"] = rwkv_train_figures
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [CPU_REFERENCE_FLAG]:
        sys.path.insert(0, os.path.join(HERE, "src"))
        sys.exit(cpu_references(sys.argv[2:]))
    sys.exit(main())
