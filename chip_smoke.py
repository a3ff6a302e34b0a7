#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--phases 1,2,...,17] [--src DIR]

``--src`` drives the ``repro_torch`` under another checkout's ``src`` (to
time two versions with one script, in turns, on one card).

Phases, each of which fails the run (nonzero exit, no result line):

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel from ``src/repro_torch/kernels/csrc`` (``nvcc``, in
   parallel);
2. each kernel against its plain PyTorch version on the card: at the main
   paths' shapes, at ragged shapes, and on inputs with ``-inf`` rows,
   columns and constants; the LSE kernels on float32 and bf16 factors, the
   one-launch log contract also at B = 1, 3 and 8, n = 1, 7, 2048 and
   16384, with an all -inf column, run twice (bit-identical reruns); the
   log half-step on every branch of its plan (t in registers, on fewer
   lanes than a warp where a row has fewer than 32 vectors, and in shared
   memory, one round and several; B = 3 on the scalar path; unaligned
   rows; m = 1003, 16 and 1; m = 16383 and 3001, where groups take 2 to 8
   rows a batch), with an all -inf row (exactly -inf out), a
   row half -inf and a -inf entry of t, run twice (bit-identical); the
   log megakernel (one thread block cluster) in bf16 and float32, at
   momentum 1.0 and 1.3, with dead atoms and a dead anchor, with every row
   of one rank's slices dead, at n < C and m < C, at the largest admitted
   bf16 and float32 shapes, its plan's shared memory equal to the
   library's, and its refusal of shapes the plan does not admit (at the
   admission edge too); the scaling contract, half-step (with a zero-weight atom and an
   all-zero row) and matvec on float32 and bf16 factors, the contract run
   twice a shape (bit-identical reruns) on its 16-byte path with row groups
   and forced onto its scalar path, also at float32 r = 4, 12, 128, 256 and
   bf16 r = 8, 128, 256 (n = 1001 and 16384); the feature map also at the
   trainer's shape, at d = 64 and 130, r = 70 and 1001, a ragged row tile
   and n = 2,200,000; the scaling megakernel (the log one's cluster) as
   the log one, its plan's shared memory equal to the library's; the row
   kernel (half-step and matvec) also at r = 40, 256, 512, 1024 and 4096,
   B = 1 and 3, n = 1003 and 16 (n not a multiple of the rows a warp
   reduces at once), and n = 2 and 7;
   the paged contract, half-step and matvec in float32 and bf16, B = 1, 3
   and 11, page sizes 8, 64 and 128, packed, mixed, scattered (a packed
   store after random evictions) and five-live-page (fewer live pages
   than contract CTAs) tables and an all-dead buffer, garbage on dead
   pages (1e6 in u, NaN in the factor) and dead slots on live pages, the
   flat contract run twice on the same buffer with its dead pages zeroed,
   and a table of 8320 pages over 8 slabs (two sweeps, two list windows);
   log_matvec with -inf entries and an all -inf row; and the four
   kernels with a problem axis (flat contract, row kernel as half-step
   and matvec, log contract, log half-step) on P = 1, 3 and 32 stacked
   problems (n = 1024 and ragged n = 1001 and 1003, r = 256, 1024, 40,
   1000 with B = 3, and 37) in float32 and bf16, and in float32 at every
   shape phase 10's service sends them (P = 1, 2, 4, 8, 16 on sides of
   512, 1024 and 2048, r = 256), against their plain
   batched twins, each rerun bit-identical, each problem within the same
   tolerance of the 2-D kernel on it alone, and a problem with a NaN row
   leaving every other problem's bits unchanged; both megakernels with
   their problem axis (one thread block cluster a problem) at P = 1, 3,
   32 and 264 in bf16 at n = m = 256, r = 128, in float32 at n = m = 128,
   r = 128 and ragged 250 x 256 in bf16, momentum 1.0 and 1.3, dead atoms
   and a dead lane (all-zero weights), against their plain batched twins,
   each problem bit-identical to the 2-D launch on it alone at the same
   forced C, reruns bit-identical and a NaN problem isolated. Tolerances: the
   feature map and the scaling kernels within 1e-5 of max
   |value|; the LSE kernels and the log megakernel's potentials atol 1e-4
   + rtol 1e-5 (summation order differs); the scaling megakernel's
   carries within 1e-5 of max |value|; both megakernels' block-end errors
   1e-4 relative + 1e-6, and a second launch bit-identical; the paged
   kernels within 1e-5 of max |value|, dead pages exactly 0, a second
   contract launch bit-identical; log_matvec as the LSE kernels;
3. the device kernels one call of the feature map, of the flat and
   paged contracts and of the log contract launches (profiler), then times (CUDA events, median of 21 batches of
   10 launches, queued behind a device spin so that host overhead is not
   timed) of each kernel, its plain
   version and one PyTorch library call computing the same function where
   there is one, beside the least time the card could take (bytes over
   3.35 TB/s or float32 operations over 67 TFLOP/s, whichever is larger):
   at the solve path's shape, the feature map in both epilogues there and
   at the trainer's shapes (beside ``fill_`` of its output, evict-first
   stores on and off), the LSE kernels at batch 2048, r = 128 in
   bf16 and float32 (the log contract also with its 16-byte and scalar
   paths forced and slabs of 8 and 32 KiB), and the log megakernel at the
   OT-GAN shape (its cluster size, inner_steps = 1, the same 8 iterations
   through the per-iteration log kernels as its yardstick, and other
   cluster sizes, row groups and lanes forced); the scaling kernels
   at n = 16384, r = 1024 and 256, float32 and bf16 (the contract also
   its slabs alone and its scalar path; the row kernel also with
   evict-first loads, and with t in shared memory where the planner
   keeps it in registers), each shape
   beside a read floor (``xi.sum()``, the card's own full read of the
   same bytes), one iteration of the scaling plan in its order on two
   factors (evict-first row loads on, off and as planned), a digest of
   the flat
   contract's output at fixed seeds (equal between two checkouts whose
   flat contract sums in the same order), and the scaling megakernel at the
   OT-GAN shape (its cluster size, inner_steps = 1, and the same 8
   iterations through the per-iteration scaling kernels as its
   yardstick); the log half-step also at the row kernel's four cold
   shapes (n = 16384, r = 1024 and 256, float32 and bf16), and one log
   iteration in the plan's order at the solve shape; the paged kernels at
   C = 32768, r = 1024 and 256, float32 and bf16, 100%, 50% and 25% of
   pages live, each beside the flat kernel on the same buffer and a read floor of the live pages (the
   contract also its slabs alone and evict-first loads on and off, and
   one iteration of the paged plan in its order on two buffers at 50%
   live, evict-first loads on, off and as planned);
   log_matvec at (16384, 1024); the four kernels with a problem axis at
   the batched engine's shape (P = 32, n = 1024, r = 256, float32 and
   bf16, cold and warm) beside their batched twins, ``torch.bmm`` /
   ``torch.logsumexp`` and 32 launches of the 2-D kernel; both
   megakernels with their problem axis at the OT-GAN shape (bf16, 8
   iterations) at P = 1, 8, 32 and 132: the autotuner's C (its key holds
   P), C forced to 1, 2, 4 and 8 with the clusters placed at once and the
   waves, the plain twin, the same 8 iterations through the stacked
   per-iteration kernels and P launches of the 2-D megakernel (both
   replayed from a CUDA graph), beside P times the 2-D bound;
4. the solve path: three annealed ``solve()`` requests on Gaussian point
   clouds (N(1, I) against N(0, 0.1 I), n = m = 16384, d = 8, r = 1024,
   eps = 0.1, seeds 0, 1, 2, tol = 1e-4, well above the float32 noise floor
   of the marginal error at this n) and one ``sinkhorn_divergence_geometry``,
   with the launch counters set to 0 before and read after; each request
   is then rerun with ``use_pallas=False`` (the plain torch operators) and
   must agree: cost within 1e-4 relative, iterations within 1 per stage;
5. the training path, with the counters set to 0 before and read after:
   the OT-GAN trainer's own ``--strict`` run at its default configuration
   (batch 256, r = 128, 40 iterations, 60 steps; 15 megakernel launches a
   step) and bench_gan's batch-2048 gradient (streaming bf16 plan). Then
   the same with ``use_pallas=False``: W̄ within 1e-4 relative and every
   gradient within 1e-3 of its max |grad|, from the same weights (the
   strict run's step-0 weights and data, whose W̄ is also held against the
   run's own, and its trained weights); a profile of one adversary and one
   generator step; and ms per step of the megakernel plan against the
   streaming plan on the same data;
6. the scaling path (Algorithm 1 in scaling space), with the counters set
   to 0 before and read after: ``solve(method="auto")`` on explicit
   features U(0, 1) + 0.05 (n = m = 16384, r = 1024 and 256, eps 0.5, 20
   iterations, float32 and bf16; the JAX package's hot-loop benchmark),
   ``solve(method="factored")`` on phase 4's clouds at eps 1.0, tol 1e-4,
   ``OTObjective.solve`` at the OT-GAN batch (256, r = 128, bf16, 40
   iterations: the scaling megakernel) and the scaling divergence with its
   envelope gradient (n = m = 4096, r = 256, 20 iterations). Then each is
   held against ``use_pallas=False`` (cost 1e-4 relative, u and v within
   1e-4 of max |value|, |d n_iter| <= 1), the clouds also against
   ``method="log_factored"``, the divergence against the same call on the
   CPU (value 1e-4 relative, gradients within 1e-3 of max |grad|); plus a
   profile of one feature solve and ms per objective solve of the
   megakernel against the streaming plan;
7. the streaming path, with the counters set to 0 before and read after:
   two ``StreamingDistribution.from_points`` stores of 16384 live points
   (bench_stream's clouds, 0.5 N(0, I_2) and 0.5 N(0, I_2) + 0.3, through
   r = 1024 Lemma-1 Gaussian features at eps 0.5; capacity 32768, so half
   the pages are dead) behind a ``StreamingOTService`` (max_batch 4), tol
   1e-4: warmup, a cold solve, 8 submitted mutations (each evicts 256
   random ids and inserts 256 new points a side) drained as 2 coalesced
   warm re-solves, then 2 direct ``StreamingSolver.update`` calls; in
   scaling f32, scaling bf16 (bf16 device buffers) and log f32. Then each
   solve is held against the same solve with ``use_pallas=False`` from
   the same state (cost 1e-4 relative, |d n_iter| <= 1, f and g on live
   slots within 1e-4 of max |value|) and against a cold
   ``solve(method="factored")`` on the compact live support (cost 1e-4
   relative), and the warm re-solves must take fewer iterations in all
   than those cold solves; in scaling mode the plan must be ``paged``,
   the paged kernels launched and the flat trio not; plus a split and a
   profile of one more update;
8. the families path, with the counters set to 0 before and read after:
   Lemma-3 arc-cosine solves on phase 4's clouds (anchors 1.5 N(0, I), r
   = 1024, so 1025 features with zero entries, eps 0.1, tol 1e-4) through
   the log plan in float32 and bf16 and through ``method="factored"`` at
   eps 0.5 (the scaling kernels), at n = 256, r + 1 = 128 with a dead
   anchor column (the log megakernel in bf16; refused in float32, which
   takes the per-iteration kernels), at n = 2048 through ``method=
   "arccos"`` with ``rank=`` / ``key=``, and the divergence with its
   gradient in x; Nystrom (rank 1024, the clouds scaled into the unit
   ball) at eps 0.5 and 0.02; a 128 x 128 and a 64 x 64 grid at eps 0.1;
   the accelerated solver and ``log_factored`` on Gaussian features at
   eps 0.5 (n = 16384, r = 1024); the sphere barycenter example and a
   barycenter of 3 histograms on n = 4096 Gaussian-feature points. Then
   each arc-cosine solve is held against ``use_pallas=False`` (cost 1e-4
   relative, |d n_iter| <= 1, potentials within 1e-4 of max |value|),
   the n = 2048 one against the dense ``log_quadratic`` oracle at tol 1e-5
   (1e-4 relative), the divergence's gradient within 1e-3 of max |grad|;
   Nystrom's cost (eps 0.5, converged, 1e-4 relative) and ``diverged``
   flag (eps 0.02) against the CPU on the same landmarks; the 128 grid
   against the CPU and the 64 grid against the dense oracle (1e-5
   relative); the accelerated cost within 2e-3 of ``log_factored``'s; the
   example's peak under 25 degrees and the barycenter's weights >= 0
   summing to 1 within 1e-5. It prints one line a family: ms an
   iteration and a solve, one log plan iteration at r + 1 = 1025 beside
   the Gaussian one at r = 1024 (CUDA events), and the arc-cosine solve's
   busy share;
9. the batched path, with the counters set to 0 before and read after:
   ``BatchedSinkhorn.solve_stacked`` on P = 32 problems of n = m = 1024,
   r = 256 (bench_batch's accelerator shape: features U(0.05, 1), eps
   0.5, tol 1e-4) for ``factored`` and ``log_factored`` in float32 and
   bf16, ``solve_point_clouds`` on 32 ``gaussian_clouds`` pairs (1024
   points, d = 2) with r = 256 shared anchors annealed to eps 0.1 by
   ``EpsSchedule(0.8, 0.4)``, ``solve_many`` over supports 300, 700, 1024,
   1500 and 2048 (three buckets) and the quickstart, each solve twice
   (the second captures nothing). Then each lane against its own single
   solve and against the ``use_pallas=False`` engine (cost 1e-4 relative,
   |d n_iter| <= 1, a stage each for the clouds), the launches a replay
   at P = 1 and P = 32 (equal), and bench_batch's fixed 50 iterations:
   one ``solve_stacked`` against a loop of 32 single solves, and one
   iteration's device time stacked against 32 single steps. Then the GAN
   minibatch, with the counters set to 0 before and read after (its own
   ``launches_by_path`` column): ``solve_point_clouds`` on 32
   OT-GAN-shaped cloud pairs (n = m = 256 in the embedding's R^8, r = 128
   anchors, eps 0.5, bf16, ``log_factored``) and ``solve_stacked`` on
   their Gaussian features (``factored``), auto cadence, each twice, and
   ``sinkhorn_divergence_gaussian_batched`` at P = 32, n = m = 128,
   float32 with its gradient in x, y and the anchors, twice: one
   megakernel launch per 8 iterations for all 32 problems (the launches
   a replay), zero captures after warmup, each solve's lanes against the
   per-iteration step at ``check_every=8`` and ``use_pallas=False`` with
   ``inner_steps=8`` (cost 1e-4 relative, ``n_iter`` within a block), the
   divergence against the CPU (value 1e-4 relative, gradients 1e-3 of
   max |grad|), and ms a solve and a divergence call against the
   per-iteration path on the same data, with the busy share;
10. the serving path, with the counters set to 0 before and read after:
   one trace of the reference's traffic generator at the card's width
   (``TrafficSpec(n_requests=400, eps=0.5, r=256, size_classes=((1024,
   1024), (2048, 1536), (512, 700)), pool_size=32, repeat_frac=0.6,
   near_frac=0.3, seed=0)``: bench_batch's r = 256 and three bucket cells,
   (1024, 1024), (2048, 2048) and (512, 1024), features U(0.05, 1.05),
   Dirichlet weights) through ``OTService(method=..., tol=1e-6,
   max_batch=16, max_wait=0.004)`` in float32, for ``log_factored`` (the
   log contract and half-step with their problem axis) and then
   ``factored`` (the flat contract and the row kernel). For each method:
   ``warmup(traffic_cells(...))``; a closed loop (a client keeping 64
   requests in flight, ``solve_many`` a window); the same closed loop
   with ``warm_starts=False`` and again under ``torch.profiler``, both
   through the same runners; the open loop (``run_open_loop``) at half
   the closed loop's rate; and bench_serve's sequential cold baseline,
   ``engine.solve_many([p])`` a request after an untimed pass. It prints
   each loop's rps, p50 / p99 and mean batch, the warm-start hits (exact
   / near / miss) and mean iterations warm and cold, the serve speedup
   (closed loop over sequential), kernel launches, loop replays and host
   reads a dispatch, the closed loop's device busy share, and the host's
   ms a request in ``kernel_data``, fingerprint, pad and upload,
   dispatch, pull and unpad, and ``classify``. Gates: every ticket
   served; every cost within 1e-4 relative of its sequential cold solve,
   exact repeats within 1e-5; without warm starts each lane's f and g
   within 1e-4 of max |value| of its sequential solve's, the same dead
   atoms, and |d n_iter| <= 1 (with warm starts the potentials are printed
   up to the constant (f + c, g - c)); exact and near hits, and mean warm
   iterations below cold for ``log_factored`` and not above cold for
   ``factored`` (a warm lane's padded atoms start at 0 as in the JAX
   package, u = 1 in scaling space, which spoils the first ``K^T u``, so
   a warm scaling start on a padded lane saves nothing there either); no capture after warmup in the service's
   runners, the engine's ``RunnerCache`` or ``RUNNERS``. Then the
   ``ot_service`` driver in-process, as the reference's CI runs it:
   ``--strict --rank 256``, ``--stream --strict`` and ``--chaos --strict
   --rank 256`` (NaN / inf feature rows, NaN weights, Gaussian features
   underflowing at eps 1e-4, injected runner faults, a poisoned warm
   entry, a skewed clock, quarantine and shedding; its gates include
   ``runner_faults`` equal to the injector's count and parity within
   1e-3 of the log-domain truth), each returning 0. A kernel build,
   launch or capture failure is never absorbed by the service, its
   ladder or the driver: it raises and fails the run.
11. (a) the autotuner (``repro_torch.kernels.autotune``) with tuning on
   and a fresh cache at ``build/tuning/tuning.json``: six keys (the flat
   contract at P = 32, n = 1024, r = 256 and at n = 16384, r = 1024, the
   row kernel, the log contract and the log half-step at n = 16384,
   r = 1024, float32, and the log megakernel at the OT-GAN shape, bf16),
   each candidate pinned and held against the plain version at its
   phase-2 tolerance on real inputs, rerun bit-identical; each key's
   static plan, winner, both times (phase 3's method) and trials; the
   memory cache dropped and every key resolved again from the file (zero
   trials, all disk hits); tuning off again: every plan static and the
   flat contract's digest the one from before. (b) the sharded solves:
   phase 4's annealed request (``solve_annealed(..., mesh=)``, auto ->
   ``sharded_log``), phase 6's feature problem (r = 1024, eps 0.5, 20
   iterations, auto -> ``sharded``) and the divergence with its
   gradients in x, y and the anchors (the first 4096 points of phase 4's
   clouds, eps 0.5), first on one process (the yardstick), then in an
   NCCL world of 1 and a gloo world of 2 ranks on card 0 (spawned; the
   kernels are built by phase 1, the ranks only load them; gloo is first
   checked to take CUDA tensors for MAX and all-gather, and where it does
   not its lane says so and stops). Gates: cost 1e-4 relative, |d
   iterations| <= 1 a stage, the feature solve's iterations equal,
   gradients 1e-3 of max |grad|, every rank's results bit-identical, each
   rank's counters showing the contract, half-step and feature-map
   kernels launched, no plain operator built in the solves and no
   megakernel launch. Per world: ms an iteration, the collectives' ms an
   iteration (the same all-reduces and host read, timed alone) and their
   share, and the world's seconds.
12. the LM surfaces (``repro_torch.models``, ``optim``, ``checkpoint``,
   ``launch.train`` / ``serve``, ``examples.train_lm``) at smollm-135m's
   full width and depth (30 layers, d_model 576, 9 heads over 3 KV heads,
   d_ff 1536, vocab 49152, float32): (a) the OT prototype loss on batch-8
   x seq-256 hidden states (512 tokens against 512 prototypes, r = 257,
   eps 2.0, 30 iterations, bf16 factors) on the fused plan against the
   plain operators on the card (loss 1e-4 relative, gradients 1e-3 of max
   |grad|), its launches forward and backward, its ms, and its loop's stop
   at exactly 30 iterations, bit-identical to the eager host loop; (b) one
   full step at batch 2 x 256 on the card against the port on the CPU
   (``ce`` 1e-5, ``ot`` 1e-4 relative, gradients 1e-3 of each leaf's max
   |grad|); (c) the counted run: 40 ``make_train_step`` steps at 8 x 256,
   saved after step 19, restored bit-identical, steps 20-39 resumed within
   1e-4 relative of the uninterrupted losses; ce falls, all metrics
   finite, 0 captures after the first step; ms a step, tokens/s, the OT
   loss's share, the busy share of 5 steps under the profiler and the
   peak memory; (d) ``launch.serve`` at its defaults (batch 4, prompt 32,
   16 generated) and at batch 32, each decode step's logits within 1e-4 of
   max |logit| of ``prefill`` of the same prefix; (e) ``launch.train
   --steps 10 --ckpt-dir``, its ``--resume`` and ``examples.train_lm
   --strict --steps 20`` as subprocesses, each rc 0.
13. the MoE family (``core.routing``, ``models.moe``, MLA, the MTP head)
   at deepseek-v3-671b's full width (d_model 7168, 128 heads, kv_lora
   512, q_lora 1536, 256 experts of d_ff 2048, top-8, one shared expert,
   dense d_ff 18432, vocab 129280, bf16) cut to 2 layers (one dense MLA
   layer, one MLA + MoE layer) plus the MTP block, its ~14.5 G parameters
   drawn on the card from a seeded CUDA generator: (a) ``sinkhorn_route``
   on seeded float32 logits of 1024 tokens at v3's width (E = 256, k = 8)
   and v2's (d 5120, E = 160, k = 6), eps 0.05, 8 iterations, bf16 and
   f32 policies, card against CPU: dispatch equal except on tokens whose
   CPU plan ties its k-th and (k+1)-th values within 1e-6 relative (NaN
   included; no untied row may differ), combine within 1e-6 on the equal
   rows, the balance loss 1e-6 relative where the dispatch is equal; the
   non-finite shares of u, v and the plan's rows, the load's max / mean
   against softmax top-k's, the ms and host reads of one call; (b)
   ``launch.steps.make_serve_step``'s prefill at batch 4 x 64, the prompt
   fed into the MLA caches and 32 greedy decode steps, logits finite, ms
   a token step, tok/s, host reads a decode step and peak memory (decode
   is not held to prefill: the router balances over a call's tokens); and
   one full-width MLA layer in float32, ``mla_attend_step`` and
   ``mla_decode`` token by token against ``mla_train`` (atol 3e-4 + rtol
   3e-3, the reference's bars); (c) ``train_loss`` forward and backward
   at 2 x 256 with the OT loss on the kernels (their launches counted
   from (b) to here), then with ``use_pallas=False`` (the first
   gradients parked on the host): ``ce``, ``aux``, ``mtp``, ``ot`` and
   every gradient finite, the router's gradient not zero, the loss 1e-4
   relative, gradients 1e-3 of each leaf's max; ms and peak memory; (d)
   one MoE layer of deepseek-v2-236b in float32 (160 experts of d_ff 1536
   over d 5120, 14 GiB) on 256 tokens: ``moe_dense`` against an oracle
   that runs each expert on its dispatched tokens alone, within 1e-5 of
   max |out|; (e) ``launch.train --arch deepseek_v3_671b --tiny``,
   ``launch.serve --arch deepseek_v2_236b --tiny`` and ``examples.train_lm
   --arch deepseek_v3_671b --tiny --strict`` side by side, each rc 0.
14. the SSM and hybrid families (``models.ssm``: the chunked SSD and the
   O(1) decode; the hybrid's shared attention block) at full width and
   full depth, float32, seeded weights drawn on the card: mamba2-1.3b (48
   Mamba2 layers, d_model 2048, 64 heads of 64, N 128, 1.34 G
   parameters) and zamba2-1.2b (32 Mamba2 layers, N 64, and 6 uses of one
   attention + MLP block, 1.02 G). (a) One mamba2 mixer on 2 x 300 tokens
   (three chunks of 128, a padded tail): ``mamba2_decode`` token by token
   against ``mamba2_train`` and the decode state against
   ``ssd_chunked``'s final state, within 1e-4 of max |value| and the
   reference's rtol 3e-3 + atol 3e-4; (b) ``train_loss`` forward and
   backward at 2 x 256 on the card against the port's CPU path, the same
   weights, at full width cut to 4 (mamba2) and 12 (zamba2, two uses of
   the shared block at its cadence of 6) layers: ``ce`` 1e-5, ``ot`` 1e-4 relative,
   gradients 1e-3 of each leaf's max; (c) ``train_loss`` at full depth
   and 8 x 256 with the OT loss on the kernels (rows 6-7, their launches
   a call) against ``use_pallas=False``: the loss 1e-4 relative, every
   gradient 1e-3 of its leaf's max; (d) ``launch.train`` in-process, 6
   steps at 8 x 256 with AdamW, the final state on through the driver's
   own step for steps 6-11: ms a step, tokens/s, peak memory, the busy
   share of 2 profiled steps and the OT loss's share (steps with it on
   against off); for zamba2 (whose tree holds the shared block's empty
   groups) the first 6 steps end in a checkpoint and ``--resume`` runs
   6 more, each resumed loss within 1e-4 relative of the uninterrupted
   run; (e) ``launch.serve`` at batch 4 after a 64-token prompt, 16
   generated, each decode step's logits within 1e-4 of max |logit| of
   the forward at that position; (f) the ``long_500k`` caches (S =
   524288, batch 1) of both configs on ``meta`` and their bytes, zamba2's
   six shared-attention caches the 4096-slot rolling buffer; zamba2 with
   a 64-slot window over 96 decode steps against the windowed forward
   (1e-4 of max |logit|); one decode step on real ``long_500k`` caches
   with every length at 64 and at 524287 (a timing only: the buffers hold
   zeros, not a history); (g) ``examples.train_lm --tiny --strict`` on
   both configs, ``launch.train --tiny`` on zamba2's and ``launch.serve
   --tiny`` on mamba2's, side by side, each rc 0.
15. the encoder-decoder family at full width and depth, float32, seeded
   weights drawn on the card: whisper-base (6 bidirectional encoder
   layers and 6 decoder layers with cross-attention, d_model 512, 8
   heads of 64, learned positions, 130.9 M parameters). (a) layer 0's
   cross-attention over the encoder's output on 4 x 1500 frames:
   ``cross_attend_step`` (the decode form, on K/V built from ``xattn``'s
   wk / wv) token by token for 64 tokens against ``cross_attention``,
   within 1e-4 of max |out|; (b) ``train_loss`` at 2 x 128 on the card
   against the CPU, phase 14's bars; (c) ``train_loss`` at 8 x 256 (T =
   S) with the OT loss on the kernels (rows 6-7, their launches a call)
   against ``use_pallas=False``; (d) phase 14's (d) with a checkpoint
   and a resume; (e) the encoder's K/V of every layer on 4 x 1500
   frames, 64 tokens teacher-forced through ``decode_step`` against
   ``forward``, within 1e-4 of max |logit|, then ``launch.serve`` (batch
   4, prompt 32, 16 generated, the reference's random ``enc_kv``); (f)
   the ``decode_32k`` shape at batch 4: 3.22 GB of self-attention caches
   at length 32767 and 3.22 GB of ``enc_kv``, one step's ms, and the
   step reads row 32767 of the position table; (g) ``examples.train_lm
   --tiny --strict``, ``launch.train --tiny`` and ``launch.serve --tiny``
   on whisper-base's tiny config side by side, each rc 0.
16. multi-card LM training and serving, in a gloo world of 2 ranks
   spawned on card 0 (NCCL refuses two ranks on one device), then an
   NCCL world of 1: (a) which collectives gloo takes on CUDA tensors
   (all-reduce SUM and MAX in float32, SUM in int32, all-gather,
   all-to-all, reduce-scatter), each against its exact answer; a refused
   one stops the part that needs it, with a line that says so; (b)
   smollm-135m at full width and depth in float32 on a 2 x 1 mesh: each
   rank's parameter and moment bytes against one card's tree, one step at
   8 x 256 (ZeRO shards gathered, the OT loss on the sharded log plan,
   rows 6-7) against the one-card step from the same weights and batch
   (``ce`` 1e-5 and ``ot`` 1e-4 relative, the gradients (the first
   moments) 1e-3 and the parameters after AdamW at eps 1 1e-5 of a
   leaf's max), then 3 timed steps (median), each rank's peak memory and
   its launches a step; (c) ``compressed_psum`` and ``ef_compress_tree``
   of each rank's gradients of (b)'s step, within 0.05 of the exact
   sum's max plus 1e-3 (the reference's bar), the residual exact; (d)
   deepseek-v2-236b's MoE layer at full width in bf16 (d 5120, 160
   experts, 80 a rank, top-6, moe_d_ff 1536, the Sinkhorn router) on 2 x
   512 tokens through ``moe_ep_local`` on 1 x 2, forward and backward at
   capacity factor 8 against ``moe_dense`` in float32 on the same
   weights, every rank's tokens routed on their own, EP in float32
   within 1e-4 and EP in bf16 within 3e-2 of max |out| and of each
   gradient's max, then at the config's 1.25 the kept (token, expert)
   set against a recount of the capacity rule, and its share; (e) mamba2-1.3b's SSD (64
   heads of 64, d_state 128, chunk 128) at 2 x 4096 context parallel on
   1 x 2 against ``ssd_chunked`` on one rank (1e-4 of max |y|), both
   timed; (f) ``launch.train --arch smollm-135m --mesh 2x1`` in process
   on both ranks: 3 steps at 4 x 128 ending in a checkpoint (one
   ``shard_<rank>.npz`` a rank), 3 more uninterrupted, then ``--resume``
   (1e-4 relative), and 8 decode steps at batch 4 on the mesh against one
   card (1e-4 of max |logit|); (g) (b)'s step on a 1 x 2 mesh, each rank
   on its segment of the sequence (128 of 256 positions, K / V gathered
   over "model", the parameters a layer at a time), against the one-card
   step at (b)'s bars, then one step counted (dot FLOPs, peak memory,
   launches) for phase 17 and one timed; the NCCL world of 1 runs (d) on
   1 x 1. Every mesh step takes its rank's block of the batch
   (``step.block``).
17. the dry run against the card (``repro_torch.launch.dryrun``): phase
   12's smollm-135m step at 8 x 256 on a 1 x 1 mesh, (a) traced on fake
   tensors in a fake world of one rank under ``launch.analysis.
   StepCounter``, (b) run for real in an NCCL world of one rank on the
   card under the same counter (after a warm-up step), with the launch
   counters set to 0 before and read after: dot FLOPs equal to 1e-6
   relative (or the ops that differ named), the estimated peak within 10%
   of ``max_memory_allocated`` less what the card held before the step
   outside its arguments (a larger gap fails the phase); the roofline on
   the H100's data-sheet numbers beside the median of 3 real steps (no
   bar: the step is host-bound); (d) phase 16 (g)'s 1 x 2 step traced on
   a fake world of 2, rank 0's dot FLOPs (1e-6) and peak (10%) against
   (g)'s counted step on rank 0 (a gloo world of 2 runs (g) here when
   phase 16 did not run); (c) ``run_cell`` of smollm-135m x
   decode_32k x 16 x 16 on a fake world of 256, its report under
   ``build/dryrun_torch/``; and the ``nvidia-smi`` name and power
   line.

Phases 2 and 4-7 also drive the solve loop as the port runs it on the
card: every fused-plan solve replays its cell's captured CUDA graph
(``repro_torch.core.runners``). Phase 2 captures each kernel wrapper in a
graph (the contracts' cooperative launches, the megakernels' cluster
launches) and holds two replays bit-identical to the eager launch. Phases
4-7 print each solve's captures, replays and host reads, require the
captures to equal the distinct cells and not to grow after warmup (phase
5: the trainer's ``--strict`` zero post-warmup captures; phase 7:
``StreamingSolver.traces`` flat), and hold each solve against the same
solve through the eager host loop (one block and one host read at a time)
on the same kernels: ``n_iter`` equal and the potentials bit-identical.
Each prints the wall per iteration, solve, step or update and the busy
share through both loops; phase 4 also times K, the blocks a replay runs,
at 2, 4, 8 and 16.

The line before the last is a JSON object listing the kernels; the last is
``{"ok": true, "device": {...}}``. TF32 is off throughout.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

N = M = 16384
D = 8
R_ANCHORS = 1024
EPS = 0.1
SEEDS = (0, 1, 2)
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
PEAK_F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
SLEEP_CYCLES = 20_000_000      # a ~10 ms device spin ahead of each batch
SLEEP_MS = [0.0]                # measured by calibrate_sleep
TOL = 1e-4                      # marginal L1 tolerance of the main path
FEATURE_REL_TOL = 1e-5
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
COST_RTOL = 1e-4
GRAD_REL_TOL = 1e-3             # of max |grad|
GAN_BATCH = 256                 # the OT-GAN example's default batch
GAN_BIG_BATCH = 2048            # bench_gan's largest batch
GAN_STEPS = 60                  # the reference CI's train-smoke length
SCALING_REL_TOL = 1e-5          # scaling kernels: of max |value|
SCALING_EPS = 0.5               # the JAX hot-loop benchmark's eps
SCALING_ITERS = 20              # and its iteration count
STREAM_CAPACITY = 32768         # bucket_capacity(N, 64): half the pages dead
STREAM_PAGE = 64                # the stores' default page
STREAM_DELTA = 256              # ids evicted and rows inserted a mutation
STREAM_MUTATIONS = 8            # submitted a run, coalesced 4 to a flush
STREAM_RUNS = (("scaling", "highest"), ("scaling", "bf16"),
               ("log", "highest"))
STREAM_D = 2                    # bench_stream's clouds: 0.5 N(0, I_2) and
STREAM_SHIFT = 0.3              # 0.5 N(0, I_2) + 0.3
STREAM_EPS = 0.5                # the smallest eps whose Gaussian features
                                # do not underflow to 0 at this size

KERNEL_INFO = {
    "gaussian_feature_map": {
        "source": "src/repro_torch/kernels/csrc/feature_map.cu",
        "replaces": "src/repro/kernels/feature_map.py:114",
    },
    "log_feature_contract": {
        "source": "src/repro_torch/kernels/csrc/logmatvec.cu",
        "replaces": "src/repro/kernels/logmatvec.py:202",
    },
    "log_halfstep": {
        "source": "src/repro_torch/kernels/csrc/logmatvec.cu",
        "replaces": "src/repro/kernels/logmatvec.py:279",
    },
    "log_sinkhorn_block": {
        "source": "src/repro_torch/kernels/csrc/fused_loop.cu",
        "replaces": "src/repro/kernels/fused_loop.py:383",
    },
    "feature_contract": {
        "source": "src/repro_torch/kernels/csrc/kermatvec.cu",
        "replaces": "src/repro/kernels/kermatvec.py:130",
    },
    "sinkhorn_halfstep": {
        "source": "src/repro_torch/kernels/csrc/kermatvec.cu",
        "replaces": "src/repro/kernels/kermatvec.py:218",
    },
    "feature_matvec": {
        "source": "src/repro_torch/kernels/csrc/kermatvec.cu",
        "replaces": "src/repro/kernels/kermatvec.py:225",
    },
    "sinkhorn_block": {
        "source": "src/repro_torch/kernels/csrc/fused_loop.cu",
        "replaces": "src/repro/kernels/fused_loop.py:254",
    },
    "log_matvec": {
        "source": "src/repro_torch/kernels/csrc/logmatvec.cu",
        "replaces": "src/repro/kernels/logmatvec.py:90",
    },
    "paged_feature_contract": {
        "source": "src/repro_torch/kernels/csrc/paged.cu",
        "replaces": "src/repro/kernels/paged.py:128",
    },
    "paged_halfstep": {
        "source": "src/repro_torch/kernels/csrc/paged.cu",
        "replaces": "src/repro/kernels/paged.py:221",
    },
    "paged_feature_matvec": {
        "source": "src/repro_torch/kernels/csrc/paged.cu",
        "replaces": "src/repro/kernels/paged.py:221",
    },
}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def demangle(symbol: str) -> str:
    """A kernel's name as ``c++filt`` prints it, without the anonymous
    namespace and the parameter list (the mangled name where there is no
    ``c++filt``)."""
    symbol = symbol.strip()
    try:
        out = subprocess.run(["c++filt", symbol], capture_output=True,
                             text=True, timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return symbol
    out = out.replace("(anonymous namespace)::", "")
    return out.split("(", 1)[0] or symbol


# ---------------------------------------------------------------------------
# Comparison helpers
# ---------------------------------------------------------------------------


def compare(torch, got, want, *, rel_to_max=None, atol=0.0, rtol=0.0):
    """Max abs error of ``got`` against ``want`` and whether it is within
    tolerance. Non-finite entries must match exactly and NaN fails."""
    if torch.isnan(got).any() or torch.isnan(want).any():
        return float("nan"), False
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or \
            not torch.equal(got[~fin], want[~fin]):
        return float("inf"), False
    if not fin.any():
        return 0.0, True
    diff = (got[fin] - want[fin]).abs()
    max_abs = float(diff.max())
    if rel_to_max is not None:
        scale = float(want[fin].abs().max())
        return max_abs, max_abs <= rel_to_max * scale
    ok = bool((diff <= atol + rtol * want[fin].abs()).all())
    return max_abs, ok


def anchors_for(torch, np, n_anchors: int, d: int, eps: float, R: float,
                seed: int, device):
    from repro_torch.core import GaussianFeatureMap
    fm = GaussianFeatureMap(r=n_anchors, d=d, eps=eps, R=R)
    rng = np.random.default_rng(10_000 + seed)
    u = math.sqrt(fm.sigma2) * rng.standard_normal((n_anchors, d))
    return torch.as_tensor(u, dtype=torch.float32, device=device), fm.q


def feature_inputs(torch, np, n, r, d, eps, seed, device):
    """x ~ N(1, I), Lemma-1 anchors and their log-constants (incl. -log r/2)."""
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((n, d)) + 1.0,
                        dtype=torch.float32, device=device)
    R = float(torch.linalg.norm(x, dim=1).max())
    u, q = anchors_for(torch, np, r, d, eps, R, seed, device)
    log_const = (0.25 * d * math.log(2.0 * q) + (u * u).sum(1) / (q * eps)
                 - 0.5 * math.log(r)).contiguous()
    return x, u, log_const


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(torch, np, device, shapes, lse_shapes, bf16_shapes,
                  block_shapes, scaling_shapes, scaling_block_shapes):
    from repro_torch.kernels import ref
    from repro_torch.kernels.feature_map import gaussian_feature_map
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    errs = {k: 0.0 for k in KERNEL_INFO}
    failures = []

    def record(name, case, err, ok):
        errs[name] = max(errs[name], err) if math.isfinite(err) else err
        log(f"  {name:22s} {case:48s} max_abs_err={err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {case}")

    for (n, r, d, eps, neg_inf) in shapes:
        x, u, c = feature_inputs(torch, np, n, r, d, eps, n + r, device)
        if neg_inf:
            c[r // 2] = -math.inf
        for log_space in (True, False):
            got = gaussian_feature_map(x, u, c, inv_eps=1 / eps,
                                       log_space=log_space)
            want = ref.gaussian_feature_map_ref(x, u, c, inv_eps=1 / eps,
                                                log_space=log_space)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, rel_to_max=FEATURE_REL_TOL)
            record("gaussian_feature_map",
                   f"n={n} r={r} d={d} log={log_space} -inf={neg_inf}",
                   err, ok)

    for (n, m, r, B, neg_inf) in lse_shapes:
        g = torch.Generator(device=device).manual_seed(n * 31 + r * 7 + B)
        lw_n = 30.0 * torch.randn((n, r), generator=g, device=device) - 50.0
        lw_m = 30.0 * torch.randn((m, r), generator=g, device=device) - 50.0
        s = 10.0 * torch.randn((n, B), generator=g, device=device)
        t = 10.0 * torch.randn((r, B), generator=g, device=device)
        lmarg = torch.full((m, B), -math.log(m), device=device)
        if neg_inf:
            lw_n[n // 3, :] = -math.inf         # dead feature row
            lw_n[:, r // 2] = -math.inf         # dead anchor column
            lw_m[m // 4, :] = -math.inf
            s[n // 5, :] = -math.inf            # dead atoms (f = -inf)
            if B > 1:
                s[:, B - 1] = -math.inf         # an all -inf column
            t[r // 3, 0] = -math.inf
        got = log_feature_contract(lw_n, s)
        want = ref.log_feature_contract_ref(lw_n, s)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
        record("log_feature_contract", f"n={n} r={r} B={B} -inf={neg_inf}",
               err, ok)
        for scale, lm in ((EPS, lmarg), (-1.0, torch.zeros_like(lmarg))):
            got = log_halfstep(lw_m, t, lm, scale=scale)
            want = ref.log_halfstep_ref(lw_m, t, lm, scale=scale)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            record("log_halfstep",
                   f"m={m} r={r} B={B} scale={scale} -inf={neg_inf}", err, ok)
    check_bf16_lse(torch, np, device, bf16_shapes, record)
    check_log_contract(torch, device, record)
    check_halfstep(torch, device, record)
    check_block(torch, np, device, block_shapes, record)
    check_scaling(torch, np, device, scaling_shapes, record)
    check_scaling_block(torch, device, scaling_block_shapes, record)
    check_paged(torch, np, device, record)
    check_log_matvec(torch, device, record)
    check_batched(torch, device, record)
    check_batched_blocks(torch, device, record)
    check_capture(torch, np, device, record)
    return errs, failures


def check_bf16_lse(torch, np, device, shapes, record):
    """The two LSE kernels on bfloat16 factors against their plain versions
    (which widen the same bf16 values to float32)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    for (n, m, r, B, neg_inf) in shapes:
        g = torch.Generator(device=device).manual_seed(n * 13 + r + B)
        lw_n = (30.0 * torch.randn((n, r), generator=g, device=device)
                - 50.0).to(torch.bfloat16)
        lw_m = (30.0 * torch.randn((m, r), generator=g, device=device)
                - 50.0).to(torch.bfloat16)
        s = 10.0 * torch.randn((n, B), generator=g, device=device)
        t = 10.0 * torch.randn((r, B), generator=g, device=device)
        lmarg = torch.full((m, B), -math.log(m), device=device)
        if neg_inf:
            lw_n[n // 3, :] = -math.inf
            lw_n[:, r // 2] = -math.inf
            lw_m[m // 4, :] = -math.inf
            s[n // 5, :] = -math.inf
            t[r // 3, 0] = -math.inf
        got = log_feature_contract(lw_n, s)
        want = ref.log_feature_contract_ref(lw_n, s)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
        record("log_feature_contract", f"bf16 n={n} r={r} B={B} -inf={neg_inf}",
               err, ok)
        for scale, lm in ((EPS, lmarg), (-1.0, torch.zeros_like(lmarg))):
            got = log_halfstep(lw_m, t, lm, scale=scale)
            want = ref.log_halfstep_ref(lw_m, t, lm, scale=scale)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            record("log_halfstep",
                   f"bf16 m={m} r={r} B={B} scale={scale} -inf={neg_inf}",
                   err, ok)


def block_inputs(torch, np, n, m, r, d, eps, dtype, dead, seed, device):
    """A megakernel block's inputs as the log plan builds them: Gaussian
    log-features of two clouds stored at ``dtype``, uniform weights with
    ``dead`` zero-weight atoms on each side (potentials -inf; a pair of
    row ranges kills those rows of each side), the carry (f0 = g0 = 0, t0
    = LSE_i(log_xi + f0/eps)) and, with ``dead``, one anchor whose
    constant is -inf (an all -inf factor column)."""
    from repro_torch.kernels import ref
    x, u, c = feature_inputs(torch, np, n, r, d, eps, seed, device)
    rng = np.random.default_rng(seed + 1)
    y = torch.as_tensor(0.5 * rng.standard_normal((m, d)), dtype=torch.float32,
                        device=device)
    if dead:
        c[r // 2] = -math.inf
    lxi = ref.gaussian_feature_map_ref(x, u, c, inv_eps=1 / eps,
                                       log_space=True).to(dtype)
    lzt = ref.gaussian_feature_map_ref(y, u, c, inv_eps=1 / eps,
                                       log_space=True).to(dtype)
    a = torch.ones(n, device=device)
    b = torch.ones(m, device=device)
    if isinstance(dead, tuple):         # whole row ranges of each side
        (i0, i1), (j0, j1) = dead
        a[i0:i1] = 0.0
        b[j0:j1] = 0.0
    elif dead:
        a[n // 3::max(n // dead, 1)][:dead] = 0.0
        b[m // 4::max(m // dead, 1)][:dead] = 0.0
    a, b = a / a.sum(), b / b.sum()

    def masked_log(w):
        return torch.where(w > 0, torch.log(torch.where(w > 0, w, 1.0)),
                           -math.inf)[:, None].contiguous()

    loga, logb = masked_log(a), masked_log(b)
    f0 = torch.where(loga > -math.inf, 0.0, -math.inf).contiguous()
    g0 = torch.where(logb > -math.inf, 0.0, -math.inf).contiguous()
    t0 = ref.log_feature_contract_ref(lxi, f0 / eps)
    return lxi, lzt, loga, logb, b[:, None].contiguous(), f0, g0, t0


def check_block(torch, np, device, shapes, record):
    """The megakernel against log_sinkhorn_block_ref on the same inputs:
    f, g, t within atol 1e-4 + rtol 1e-5 (as the LSE kernels), the
    block-end error within 1e-4 relative + 1e-6; a second launch must be
    bit-identical (no atomics). Shapes the plan does not admit are refused
    by block_plan_fits and by the kernel's wrapper (ValueError)."""
    from repro_torch.kernels import fused_loop, ref
    from repro_torch.kernels.fused_loop import (
        block_plan_fits,
        log_sinkhorn_block,
    )

    for (n, m, r, dtype, mom, dead, steps) in shapes:
        eps = 0.5
        plan = (fused_loop._block_plan(n, m, r, dtype)
                if hasattr(fused_loop, "_block_plan") else None)
        if dead == "rank":     # every row of rank 1's slices dead
            dead = ((plan.slice(1, n), plan.slice(1, m)) if plan else
                    ((n // 8, n // 4), (m // 8, m // 4)))
        args = block_inputs(torch, np, n, m, r, D, eps, dtype, dead,
                            n + m + r, device)
        case = (f"n={n} m={m} r={r} {str(dtype)[6:]} momentum={mom} "
                f"dead={dead} steps={steps}")
        if plan is not None:
            lib_smem = fused_loop._lib().log_sinkhorn_block_smem_bytes(
                n, m, r, int(dtype == torch.bfloat16), plan.cluster,
                plan.threads, plan.groups, plan.lanes, plan.ldw)
            case += (f" C={plan.cluster} threads={plan.threads} "
                     f"G={plan.groups} L={plan.lanes} smem={plan.smem}")
            if lib_smem != plan.smem:
                record("log_sinkhorn_block", case + f" (library smem "
                       f"{lib_smem} != plan)", float("inf"), False)
                continue
        if not block_plan_fits(n, m, r, 1, dtype):
            try:
                log_sinkhorn_block(*args, inner_steps=steps, eps=eps,
                                   momentum=mom)
                refused = False
            except ValueError:
                refused = True
            record("log_sinkhorn_block", case + " (not admitted: refused)",
                   0.0, refused)
            continue
        got = log_sinkhorn_block(*args, inner_steps=steps, eps=eps,
                                 momentum=mom)
        again = log_sinkhorn_block(*args, inner_steps=steps, eps=eps,
                                   momentum=mom)
        want = ref.log_sinkhorn_block_ref(*args, inner_steps=steps, eps=eps,
                                          momentum=mom)
        torch.cuda.synchronize()
        worst, all_ok = 0.0, True
        for gv, wv in zip(got[:3], want[:3]):
            err, ok = compare(torch, gv, wv, atol=LSE_ATOL, rtol=LSE_RTOL)
            worst, all_ok = max(worst, err), all_ok and ok
        e_got, e_want = float(got[3]), float(want[3])
        e_ok = abs(e_got - e_want) <= 1e-4 * abs(e_want) + 1e-6
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        record("log_sinkhorn_block",
               f"{case} err={e_got:.4e}/{e_want:.4e} repeat_identical={same}",
               worst, all_ok and e_ok and same)


def check_log_contract(torch, device, record):
    """The one-launch log contract against its plain version at B = 1, 3
    and 8, n = 1, 7, 2048 and 16384 (r = 128, and r = 1024 at n = 16384),
    float32 and bf16 factors with -inf rows, a dead anchor column (an all
    -inf output column) and, at B > 1, an all -inf column of s: atol
    LSE_ATOL + rtol LSE_RTOL, and a second launch bit-identical."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_feature_contract

    cases = [(n, 128, B) for n in (1, 7, GAN_BIG_BATCH, N) for B in (1, 3, 8)]
    cases += [(N, R_ANCHORS, B) for B in (1, 3)]
    for n, r, B in cases:
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device=device).manual_seed(n * 17 + r + B)
            lw = (30.0 * torch.randn((n, r), generator=g, device=device)
                  - 50.0).to(dtype)
            s = 10.0 * torch.randn((n, B), generator=g, device=device)
            lw[:, r // 2] = -math.inf           # an all -inf output column
            lw[n // 3, :] = -math.inf
            s[n // 5, :] = -math.inf
            if B > 1:
                s[:, B - 1] = -math.inf         # an all -inf column of s
            got = log_feature_contract(lw, s)
            again = log_feature_contract(lw, s)
            want = ref.log_feature_contract_ref(lw, s)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            same = torch.equal(got, again)
            record("log_feature_contract",
                   f"{str(dtype)[6:]} n={n} r={r} B={B} -inf column "
                   f"repeat_identical={same}", err, ok and same)


def check_halfstep(torch, device, record):
    """The log half-step against its plain version on every branch of its
    plan: t in registers (float32 r = 4, 40, 128, 256, 512; bf16 r = 8,
    128, 256, 1024: a row of fewer than 32 vectors on fewer lanes) and in
    shared memory (float32 r = 1024, 4096; bf16 r = 2048, 4096: rows of
    more than 8 vectors a lane, taken in rounds), B = 3 on the scalar path,
    unaligned rows (float32 r = 1001, bf16 r = 1028), m = 1003, 16 and 1
    (not a multiple of the rows a warp reduces at once), m = 16383 and
    3001 (groups taking 2, 4 and 8 rows a batch: every kernel of the
    register path), the trainer's batch 2048 at r = 128 and the solve's
    16384 at r = 1024; each with an all -inf row (which must give -inf
    exactly), a row half -inf, and a -inf entry of t, at both scales: atol
    LSE_ATOL + rtol LSE_RTOL, and a second launch bit-identical."""
    from repro_torch.kernels import logmatvec, ref
    from repro_torch.kernels.backend import sm_count
    from repro_torch.kernels.logmatvec import log_halfstep

    f32, bf = torch.float32, torch.bfloat16
    cases = [(m, r, 1, dtype) for dtype, rs in (
        (f32, (4, 40, 128, 256, 512, 1024, 4096)),
        (bf, (8, 128, 256, 1024, 2048, 4096))) for r in rs
        for m in (1003, 16)]
    cases += [(16383, r, 1, dtype) for dtype, rs in (
        (f32, (40, 128, 256, 512)), (bf, (128, 256, 1024))) for r in rs]
    cases += [(m, 512, 1, bf) for m in (16383, 3001, 1003)]
    cases += [(3001, r, 1, dtype) for dtype in (f32, bf) for r in (128, 256)]
    cases += [(1003, r, 3, dtype) for dtype in (f32, bf) for r in (128, 1000)]
    cases += [(1003, 1001, 1, f32), (1003, 1028, 1, bf), (1, 128, 1, bf),
              (1, 1024, 1, f32), (GAN_BIG_BATCH, 128, 1, bf),
              (GAN_BIG_BATCH, 128, 1, f32), (N, R_ANCHORS, 1, f32)]
    planner = getattr(logmatvec, "_halfstep_kernel", None)
    for m, r, B, dtype in cases:
        g = torch.Generator(device=device).manual_seed(m * 5 + r + B)
        lw = (30.0 * torch.randn((m, r), generator=g, device=device)
              - 50.0).to(dtype)
        t = 10.0 * torch.randn((r, B), generator=g, device=device)
        lmarg = torch.full((m, B), -math.log(m), device=device)
        lw[m // 3] = -math.inf                  # an all -inf row
        lw[m // 2, ::2] = -math.inf             # a row half -inf
        t[r // 3] = -math.inf
        tag = f"{str(dtype)[6:]} m={m} r={r} B={B}"
        if planner is not None:
            vec = logmatvec._vectorized(lw, B)
            es, sms = lw.element_size(), sm_count(lw.device)
            nv, _, q, smem = planner(m, r, B, vec, es, sms)
            p = logmatvec._halfstep_plan(
                m, r, B, vec, es, sms, logmatvec._halfstep_blocks_per_sm(
                    lw.device.index, dtype == bf, nv, q, smem))
            tag += (f" (t in registers, {p.nv} vectors, {p.lanes} lanes a "
                    f"row, {p.rows} rows a batch, grid {p.grid})" if p.nv
                    else f" (t in shared memory, grid {p.grid})")
        for scale, lm in ((EPS, lmarg), (-1.0, torch.zeros_like(lmarg))):
            got = log_halfstep(lw, t, lm, scale=scale)
            again = log_halfstep(lw, t, lm, scale=scale)
            want = ref.log_halfstep_ref(lw, t, lm, scale=scale)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            same = torch.equal(got, again)
            dead = bool(torch.isinf(got[m // 3]).all())
            record("log_halfstep",
                   f"{tag} scale={scale} -inf row {'inf' if dead else 'FINITE'}"
                   f" rerun {'bit-identical' if same else 'DIFFERS'}", err,
                   ok and same and dead)


def explicit_features(np, n, r, seed):
    """Features U(0, 1) + 0.05 from a numpy seed (benchmarks/run.py's
    bench_solver_iteration draws them so)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, r)) + 0.05).astype(np.float32)


def check_scaling(torch, np, device, shapes, record):
    """The scaling contract, half-step and matvec against their plain
    versions on the same inputs, within 1e-5 of max |value|. The half-step
    has a zero-weight atom on a positive row (exactly 0) and an all-zero
    factor row (marg / 0 = inf, in both). The contract runs twice on each
    shape (the reruns must be bit-identical), on its 16-byte path with row
    groups and forced onto its scalar path where the 16-byte path applies
    (B = 1, rows of 16 bytes); a shape tagged "contract" checks only it, a
    shape tagged "rows" only the row kernels (matvec and half-step)."""
    from repro_torch.kernels import kermatvec, ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )

    for (n, r, B, dtype, *only) in shapes:
        tag = f"{str(dtype)[6:]} n={n} r={r} B={B}"
        xi = torch.as_tensor(explicit_features(np, n, r, n + 7 * r + B),
                             device=device).to(dtype)
        g = torch.Generator(device=device).manual_seed(n * 3 + r + B)
        u = torch.rand((n, B), generator=g, device=device)
        t = torch.rand((r, B), generator=g, device=device)
        marg = torch.full((n, B), 1.0 / n, device=device)
        marg[n // 2] = 0.0
        if only != ["rows"]:
            want = ref.feature_contract_ref(xi, u)
            paths = [("chosen", kermatvec._flat_vectorized)]
            if kermatvec._flat_vectorized(xi, B):
                paths.append(("scalar", lambda *_: False))
            chosen = kermatvec._flat_vectorized
            for label, rule in paths:
                kermatvec._flat_vectorized = rule
                try:
                    path = "vector" if rule(xi, B) else "scalar"
                    got = feature_contract(xi, u)
                    again = feature_contract(xi, u)
                finally:
                    kermatvec._flat_vectorized = chosen
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want,
                                  rel_to_max=SCALING_REL_TOL)
                same = torch.equal(got, again)
                record("feature_contract",
                       f"{tag} {label} ({path}) path, rerun "
                       f"{'bit-identical' if same else 'DIFFERS'}", err,
                       ok and same)
        if only == ["contract"]:
            continue
        nv, rows, _ = kermatvec._rows_kernel(
            r, B, kermatvec._vectorized(xi, B), xi.element_size())
        rows_tag = tag + (f" (t in registers, {nv} vectors a lane, {rows} "
                          "rows a batch)" if nv else " (t in shared memory)")
        got = feature_matvec(xi, t)
        want = ref.feature_matvec_ref(xi, t)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, rel_to_max=SCALING_REL_TOL)
        record("feature_matvec", rows_tag, err, ok)
        xz = xi.clone()
        xz[n // 5] = 0.0
        got = sinkhorn_halfstep(xz, t, marg)
        want = ref.sinkhorn_halfstep_ref(xz, t, marg)
        torch.cuda.synchronize()
        err, ok = compare(torch, got, want, rel_to_max=SCALING_REL_TOL)
        ok = ok and bool((got[n // 2] == 0).all())
        if n > 1 and n // 5 != n // 2:
            ok = ok and bool(torch.isinf(got[n // 5]).all())
        record("sinkhorn_halfstep", f"{rows_tag} zero row/weight", err, ok)


def scaling_block_inputs(torch, n, m, r, dtype, dead, seed, device):
    """A scaling megakernel block's inputs as the plan builds them:
    features exp(N(0, 1)) (a range wide enough that 8 iterations do not
    converge), scaled by (r max(n, m))^-1/2 so that K's row sums, and with
    them u, v and s, are of order 1, at ``dtype``; uniform weights with
    ``dead`` zero-weight atoms a side, and the carry at u = v = 1,
    s = Zeta (Xi^T u)."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=device).manual_seed(seed)
    c = (r * max(n, m)) ** -0.5
    xi = (c * torch.exp(torch.randn((n, r), generator=g,
                                    device=device))).to(dtype)
    zeta = (c * torch.exp(torch.randn((m, r), generator=g,
                                      device=device))).to(dtype)
    a = torch.ones((n, 1), device=device)
    b = torch.ones((m, 1), device=device)
    if isinstance(dead, tuple):         # whole row ranges of each side
        (i0, i1), (j0, j1) = dead
        a[i0:i1] = 0.0
        b[j0:j1] = 0.0
    elif dead:
        a[n // 3::max(n // dead, 1)][:dead] = 0.0
        b[m // 4::max(m // dead, 1)][:dead] = 0.0
    a, b = a / a.sum(), b / b.sum()
    u0 = torch.ones((n, 1), device=device)
    v0 = torch.ones((m, 1), device=device)
    s0 = ref.feature_matvec_ref(zeta, ref.feature_contract_ref(xi, u0))
    return (xi.contiguous(), zeta.contiguous(), a, b, u0, v0,
            s0.contiguous())


def check_scaling_block(torch, device, shapes, record):
    """The scaling megakernel against sinkhorn_block_ref on the same
    inputs: u, v, s within 1e-5 of max |value|, the block-end error within
    1e-4 relative + 1e-6, a second launch bit-identical; shapes the plan
    does not admit are refused by block_plan_fits and by the wrapper."""
    from repro_torch.kernels import fused_loop, ref
    from repro_torch.kernels.fused_loop import block_plan_fits, sinkhorn_block

    for (n, m, r, dtype, mom, dead, steps) in shapes:
        plan = (fused_loop._block_plan(n, m, r, dtype, "scaling")
                if hasattr(fused_loop, "_scaling_block_plan") else None)
        if dead == "rank":     # every row of rank 1's slices dead
            dead = ((plan.slice(1, n), plan.slice(1, m)) if plan else
                    ((n // 8, n // 4), (m // 8, m // 4)))
        args = scaling_block_inputs(torch, n, m, r, dtype, dead, n + m + r,
                                    device)
        case = (f"n={n} m={m} r={r} {str(dtype)[6:]} momentum={mom} "
                f"dead={dead} steps={steps}")
        if plan is not None:
            lib_smem = fused_loop._lib().sinkhorn_block_smem_bytes(
                n, m, r, int(dtype == torch.bfloat16), plan.cluster,
                plan.threads, plan.groups, plan.lanes, plan.ldw)
            case += (f" C={plan.cluster} threads={plan.threads} "
                     f"G={plan.groups} L={plan.lanes} smem={plan.smem}")
            if lib_smem != plan.smem:
                record("sinkhorn_block", case + f" (library smem "
                       f"{lib_smem} != plan)", float("inf"), False)
                continue
        if not block_plan_fits(n, m, r, 1, dtype):
            try:
                sinkhorn_block(*args, inner_steps=steps, momentum=mom)
                refused = False
            except ValueError:
                refused = True
            record("sinkhorn_block", case + " (not admitted: refused)", 0.0,
                   refused)
            continue
        got = sinkhorn_block(*args, inner_steps=steps, momentum=mom)
        again = sinkhorn_block(*args, inner_steps=steps, momentum=mom)
        want = ref.sinkhorn_block_ref(*args, inner_steps=steps, momentum=mom)
        torch.cuda.synchronize()
        worst, all_ok = 0.0, True
        for gv, wv in zip(got[:3], want[:3]):
            err, ok = compare(torch, gv, wv, rel_to_max=SCALING_REL_TOL)
            worst, all_ok = max(worst, err), all_ok and ok
        e_got, e_want = float(got[3]), float(want[3])
        e_ok = abs(e_got - e_want) <= 1e-4 * abs(e_want) + 1e-6
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        dead_ok = bool((got[0][args[2] == 0] == 0).all())
        record("sinkhorn_block",
               f"{case} err={e_got:.4e}/{e_want:.4e} repeat_identical={same}",
               worst, all_ok and e_ok and same and dead_ok)


def page_table(np, n_pages, page_size, pattern, seed):
    """int32 live counts: ``"front"`` fills the first half of the pages, as
    a store packs its rows; ``"mixed"`` draws dead, partly live and full
    pages; ``"scattered"`` is a packed store after random evictions (the
    first three quarters of the pages, each emptied with probability 0.3,
    the rest holding 1 to page_size live slots); ``"few"`` has five live
    pages at random places (fewer than the contract's CTAs); ``"dead"`` is
    an all-dead buffer."""
    rng = np.random.default_rng(seed)
    if pattern == "front":
        return np.array([page_size] * (n_pages // 2)
                        + [0] * (n_pages - n_pages // 2), np.int32)
    if pattern == "dead":
        return np.zeros(n_pages, np.int32)
    if pattern == "scattered":
        used = np.arange(n_pages) < (3 * n_pages) // 4
        kept = rng.uniform(size=n_pages) >= 0.3
        return np.where(used & kept, rng.integers(1, page_size + 1, n_pages),
                        0).astype(np.int32)
    if pattern == "few":
        live = np.zeros(n_pages, np.int32)
        live[rng.choice(n_pages, size=min(5, n_pages), replace=False)] = \
            page_size
        return live
    kind = rng.integers(0, 3, n_pages)
    partial = rng.integers(1, page_size, n_pages)
    return np.where(kind == 0, 0, np.where(kind == 1, partial, page_size)
                    ).astype(np.int32)


def check_paged(torch, np, device, record):
    """The paged contract, half-step and matvec against their plain
    versions, within 1e-5 of max |value|, in float32 and bf16, B = 1 and 3
    (and 11: two column chunks), page sizes 8, 64 and 128, the page
    patterns of ``page_table`` (packed, mixed, scattered, five live pages,
    all dead); dead pages hold garbage (1e6 in u, NaN in the factor rows),
    so a kernel that read them would disagree; live pages hold dead slots
    (marg 0, so the half-step gives exactly 0 there). Dead pages' outputs
    are exactly 0 and a second contract launch is bit-identical; the
    contract runs on both of its paths where the vector path applies. The
    flat contract on the same buffer with the dead pages zeroed runs twice
    too (bit-identical) and agrees with the paged one."""
    from repro_torch.kernels import paged, ref
    from repro_torch.kernels.kermatvec import feature_contract
    from repro_torch.kernels.paged import (
        paged_feature_contract,
        paged_feature_matvec,
        paged_halfstep,
    )

    cases = [(STREAM_CAPACITY, R_ANCHORS, 1, STREAM_PAGE, "front"),
             (STREAM_CAPACITY, R_ANCHORS, 1, STREAM_PAGE, "scattered"),
             (STREAM_CAPACITY, 256, 1, STREAM_PAGE, "few"),
             (4096, 256, 3, 64, "mixed"), (4096, 1024, 1, 8, "mixed"),
             (4096, 256, 3, 64, "scattered"), (4096, 1024, 1, 8, "few"),
             (4096, 1001, 1, 128, "mixed"), (1024, 64, 3, 128, "dead"),
             (2048, 40, 11, 8, "mixed"), (4096, 1032, 1, 64, "mixed"),
             # 8320 pages (two sweeps of the page table) over 8 slabs of
             # about 690 live pages each (two list windows)
             (66560, 4096, 11, 8, "mixed")]
    for dtype in (torch.float32, torch.bfloat16):
        for (C, r, B, ps, pattern) in cases:
            tag = f"{str(dtype)[6:]} C={C} r={r} B={B} page={ps} {pattern}"
            live_np = page_table(np, C // ps, ps, pattern, C + r + ps)
            live = torch.as_tensor(live_np, device=device)
            page_mask = torch.as_tensor(np.repeat(live_np > 0, ps),
                                        device=device)
            slot_live = torch.zeros(C, dtype=torch.bool, device=device)
            for p in np.nonzero(live_np)[0]:      # the first live[p] slots
                slot_live[p * ps:p * ps + live_np[p]] = True
            g = torch.Generator(device=device).manual_seed(C + B + ps)
            xi = (torch.rand((C, r), generator=g, device=device)
                  + 0.05).to(dtype)          # explicit_features, on the card
            xi_flat = torch.where(page_mask[:, None], xi, 0).contiguous()
            xi[~page_mask] = math.nan
            u = torch.rand((C, B), generator=g, device=device)
            u_flat = torch.where(page_mask[:, None], u, 0).contiguous()
            u[~page_mask] = 1e6
            t = torch.rand((r, B), generator=g, device=device)
            marg = torch.where(slot_live[:, None],
                               torch.full((C, B), 1.0 / C, device=device),
                               torch.zeros((C, B), device=device))
            want = ref.paged_contract_ref(xi, u, live, page_size=ps)
            paths = [("chosen", paged._flat_vectorized)]
            if paged._flat_vectorized(xi, B):
                paths.append(("scalar", lambda *_: False))
            chosen = paged._flat_vectorized
            for label, rule in paths:
                paged._flat_vectorized = rule
                try:
                    got = paged_feature_contract(xi, u, live, page_size=ps)
                    again = paged_feature_contract(xi, u, live, page_size=ps)
                finally:
                    paged._flat_vectorized = chosen
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want,
                                  rel_to_max=SCALING_REL_TOL)
                same = torch.equal(got, again)
                record("paged_feature_contract",
                       f"{tag} {label} path, rerun "
                       f"{'bit-identical' if same else 'DIFFERS'}", err,
                       ok and same)
            flat = feature_contract(xi_flat, u_flat)
            flat_again = feature_contract(xi_flat, u_flat)
            torch.cuda.synchronize()
            err, ok = compare(torch, flat, want, rel_to_max=SCALING_REL_TOL)
            same = torch.equal(flat, flat_again)
            record("feature_contract",
                   f"{tag} flat on the zeroed buffer, rerun "
                   f"{'bit-identical' if same else 'DIFFERS'}", err,
                   ok and same)
            for name, got, want in (
                    ("paged_halfstep",
                     paged_halfstep(xi, t, marg, live, page_size=ps),
                     ref.paged_halfstep_ref(xi, t, marg, live,
                                            page_size=ps)),
                    ("paged_feature_matvec",
                     paged_feature_matvec(xi, t, live, page_size=ps),
                     ref.paged_matvec_ref(xi, t, live, page_size=ps))):
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want,
                                  rel_to_max=SCALING_REL_TOL)
                ok = ok and bool((got[~page_mask] == 0).all())
                if name == "paged_halfstep":
                    ok = ok and bool((got[~slot_live] == 0).all())
                record(name, tag, err, ok)


def check_log_matvec(torch, device, record):
    """log_matvec against its plain version (atol 1e-4 + rtol 1e-5, the LSE
    kernels' tolerance) in float32 and bf16, on both load paths, with
    -inf entries, an all -inf row (gives -inf) and -inf in t."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_matvec

    for dtype in (torch.float32, torch.bfloat16):
        for (m, r, neg_inf) in ((N, R_ANCHORS, False), (1023, 300, True),
                                (777, 1001, True), (5, 129, True),
                                (4096, 1032, True)):
            g = torch.Generator(device=device).manual_seed(m + r)
            log_m = (30.0 * torch.randn((m, r), generator=g, device=device)
                     - 50.0)
            t = 10.0 * torch.randn((r,), generator=g, device=device)
            if neg_inf:
                log_m[m // 2] = -math.inf
                log_m[:, r // 3] = -math.inf
                t[r - 1] = -math.inf
            log_m = log_m.to(dtype)
            got = log_matvec(log_m, t)
            want = ref.log_matvec_ref(log_m, t)
            torch.cuda.synchronize()
            err, ok = compare(torch, got, want, atol=LSE_ATOL, rtol=LSE_RTOL)
            if neg_inf:
                ok = ok and float(got[m // 2]) == -math.inf
            record("log_matvec", f"{str(dtype)[6:]} m={m} r={r} "
                   f"-inf={neg_inf}", err, ok)


BATCH_P = 32                    # bench_batch's accelerator shape: P
BATCH_N = 1024                  # problems of n = m = 1024 supports,
BATCH_R = 256                   # r = 256 features, eps 0.5
BATCH_EPS = 0.5


def check_batched(torch, device, record):
    """The four kernels with a problem axis (the flat contract, the row
    kernel as half-step and matvec, the log contract and the log
    half-step) on P = 1, 3 and 32 stacked problems against their plain
    batched twins (``kernels.ref``, ``@`` / LSE over each problem's axes),
    in float32 and bf16: at the engine's shape (n = 1024, r = 256), with a
    ragged last tile (n = 1001 and 1003: no slab or batch of rows divides
    it), t in shared memory (float32 r = 1024), the scalar paths (B = 3,
    r = 1000) and unaligned rows (r = 37); and in float32 at every shape
    phase 10's service sends them: P = 1, 2, 4, 8 and 16 (its batch
    buckets) on sides of 512, 1024 and 2048 (its padded supports), r =
    256. Each case also holds a second
    launch bit-identical, each problem within the same tolerance of the 2-D
    kernel on that problem alone, and, with P > 1, a problem whose factor
    holds a NaN row leaving every other problem's bits unchanged.
    Tolerances are phase 2's: the scaling kernels within 1e-5 of max
    |value|, the LSE kernels atol 1e-4 + rtol 1e-5."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    f32, bf = torch.float32, torch.bfloat16
    cases = [(P, BATCH_N, BATCH_R, 1) for P in (1, 3, BATCH_P)]
    cases += [(P, 1001, BATCH_R, 1) for P in (3, BATCH_P)]
    cases += [(3, 1003, 1024, 1), (BATCH_P, 1003, 40, 1), (3, 777, 1000, 3),
              (5, 301, 37, 1)]
    cases = [c + ((f32, bf),) for c in cases]
    # phase 10's megabatches: every batch bucket on every padded side
    cases += [(P, n, SERVE_TRACE["r"], 1, (f32,))
              for P in SERVE_BUCKETS for n in SERVE_SIDES
              if (P, n) != (1, BATCH_N)]
    for (P, n, r, B, dtypes) in cases:
        for dtype in dtypes:
            g = torch.Generator(device=device).manual_seed(P * 101 + n + r + B)
            xi = (torch.rand((P, n, r), generator=g, device=device)
                  + 0.05).to(dtype)
            lw = (30.0 * torch.randn((P, n, r), generator=g, device=device)
                  - 50.0).to(dtype)
            u = torch.rand((P, n, B), generator=g, device=device)
            t = torch.rand((P, r, B), generator=g, device=device)
            s = 10.0 * torch.randn((P, n, B), generator=g, device=device)
            lt = 10.0 * torch.randn((P, r, B), generator=g, device=device)
            marg = torch.full((P, n, B), 1.0 / n, device=device)
            lmarg = torch.log(marg)
            lw[:, n // 3] = -math.inf               # an all -inf row
            s[:, n // 5] = -math.inf                # dead atoms
            tag = f"{str(dtype)[6:]} P={P} n={n} r={r} B={B}"
            runs = (
                ("feature_contract", lambda x: feature_contract(x, u),
                 lambda x: ref.feature_contract_ref(x, u), xi, "scaling"),
                ("feature_matvec", lambda x: feature_matvec(x, t),
                 lambda x: ref.feature_matvec_ref(x, t), xi, "scaling"),
                ("sinkhorn_halfstep", lambda x: sinkhorn_halfstep(x, t, marg),
                 lambda x: ref.sinkhorn_halfstep_ref(x, t, marg), xi,
                 "scaling"),
                ("log_feature_contract", lambda x: log_feature_contract(x, s),
                 lambda x: ref.log_feature_contract_ref(x, s), lw, "lse"),
                ("log_halfstep",
                 lambda x: log_halfstep(x, lt, lmarg, scale=BATCH_EPS),
                 lambda x: ref.log_halfstep_ref(x, lt, lmarg,
                                                scale=BATCH_EPS), lw, "lse"),
            )
            one = {  # the 2-D kernel on problem i alone
                "feature_contract": lambda x, i: feature_contract(
                    x[i].contiguous(), u[i].contiguous()),
                "feature_matvec": lambda x, i: feature_matvec(
                    x[i].contiguous(), t[i].contiguous()),
                "sinkhorn_halfstep": lambda x, i: sinkhorn_halfstep(
                    x[i].contiguous(), t[i].contiguous(),
                    marg[i].contiguous()),
                "log_feature_contract": lambda x, i: log_feature_contract(
                    x[i].contiguous(), s[i].contiguous()),
                "log_halfstep": lambda x, i: log_halfstep(
                    x[i].contiguous(), lt[i].contiguous(),
                    lmarg[i].contiguous(), scale=BATCH_EPS),
            }
            for name, kernel, plain, x, kind in runs:
                kw = (dict(rel_to_max=SCALING_REL_TOL) if kind == "scaling"
                      else dict(atol=LSE_ATOL, rtol=LSE_RTOL))
                got = kernel(x)
                again = kernel(x)
                want = plain(x)
                torch.cuda.synchronize()
                err, ok = compare(torch, got, want, **kw)
                same = torch.equal(got, again)
                lanes_ok = True
                for i in sorted({0, P // 2, P - 1}):
                    e_i, ok_i = compare(torch, got[i], one[name](x, i), **kw)
                    lanes_ok = lanes_ok and ok_i
                    err = max(err, e_i)
                iso = "n/a"
                if P > 1:
                    bad = x.clone()
                    bad[1, n // 2] = math.nan
                    poisoned = kernel(bad)
                    torch.cuda.synchronize()
                    others = [i for i in range(P) if i != 1]
                    iso = torch.equal(poisoned[others], got[others]) and \
                        bool(torch.isnan(poisoned[1]).any())
                record(name, f"batched {tag} rerun "
                       f"{'bit-identical' if same else 'DIFFERS'}, lanes vs "
                       f"2-D {'ok' if lanes_ok else 'OFF'}, NaN lane "
                       f"isolated {iso}", err,
                       ok and same and lanes_ok and iso is not False)


BLOCK_PS = (1, 3, 32, 264)      # phase 2: problems of a batched megakernel
                                # launch (an H100 places 30 clusters of 8 at
                                # the OT-GAN shape: 264 runs in 9 waves)


def stacked_block_inputs(torch, mode, P, n, m, r, dtype, seed, device,
                         eps=0.5, dead_lane=True):
    """P problems of a megakernel block stacked on a leading axis, as the
    stacked plans build them: factors (log U(0.05, 1) - U(0, 6) in log
    mode, (r max(n, m))^-1/2 exp(N(0, 1)) in scaling mode) at ``dtype``,
    uniform weights with three dead atoms a side on every odd problem,
    problem P // 2 a dead lane (all-zero weights, for P >= 3, where
    ``dead_lane``), and the
    carry from the cold start (f = 0, g = 0, t = LSE_i(log_xi + f / eps);
    u = v = 1, s = Zeta (Xi^T u)). Returns the wrapper's arguments."""
    from repro_torch.kernels import ref
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.ones((P, n, 1), device=device)
    b = torch.ones((P, m, 1), device=device)
    a[1::2, n // 3:n // 3 + 3] = 0.0
    b[1::2, m // 4:m // 4 + 3] = 0.0
    a, b = a / a.sum(1, keepdim=True), b / b.sum(1, keepdim=True)
    if dead_lane and P >= 3:
        a[P // 2] = 0.0
        b[P // 2] = 0.0
    if mode == "log":
        def factor(rows):
            return (torch.log(torch.rand((P, rows, r), generator=g,
                                         device=device) + 0.05)
                    - 6.0 * torch.rand((P, rows, r), generator=g,
                                       device=device)).to(dtype)
        lxi, lzt = factor(n), factor(m)

        def masked_log(w):
            return torch.where(w > 0, torch.log(torch.where(w > 0, w, 1.0)),
                               -math.inf).contiguous()

        loga, logb = masked_log(a), masked_log(b)
        f0 = torch.where(loga > -math.inf, 0.0, -math.inf).contiguous()
        g0 = torch.where(logb > -math.inf, 0.0, -math.inf).contiguous()
        t0 = ref.log_feature_contract_ref(lxi, f0 / eps).contiguous()
        return lxi, lzt, loga, logb, b.contiguous(), f0, g0, t0
    c = (r * max(n, m)) ** -0.5
    xi = (c * torch.exp(torch.randn((P, n, r), generator=g, device=device))
          ).to(dtype).contiguous()
    zeta = (c * torch.exp(torch.randn((P, m, r), generator=g, device=device))
            ).to(dtype).contiguous()
    u0 = torch.ones((P, n, 1), device=device)
    v0 = torch.ones((P, m, 1), device=device)
    s0 = ref.feature_matvec_ref(zeta, ref.feature_contract_ref(xi, u0))
    return xi, zeta, a.contiguous(), b.contiguous(), u0, v0, s0.contiguous()


def block_call(mode, args, steps, mom, eps=0.5):
    """The batched megakernel wrapper of ``mode`` on ``args`` and its plain
    batched twin: ``(kernel(), plain())`` callables."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_loop import (log_sinkhorn_block,
                                                sinkhorn_block)
    if mode == "log":
        kw = dict(inner_steps=steps, eps=eps, momentum=mom)
        return (lambda x=args: log_sinkhorn_block(*x, **kw),
                lambda x=args: ref.log_sinkhorn_block_ref(*x, **kw))
    kw = dict(inner_steps=steps, momentum=mom)
    return (lambda x=args: sinkhorn_block(*x, **kw),
            lambda x=args: ref.sinkhorn_block_ref(*x, **kw))


def lane_bits(torch, x, i):
    """Problem ``i`` of a stacked output as raw bits (NaN payloads
    included), for bit-identity."""
    return x[i].contiguous().view(torch.int32)


def check_batched_blocks(torch, device, record):
    """Both megakernels with their problem axis (P clusters, one a problem)
    against their plain batched twins at P = 1, 3, 32 and 264: bf16 at the
    OT-GAN shape (n = m = 256, r = 128), float32 at n = m = 128, r = 128
    (the largest float32 n = m the budget admits at r = 128 is 176), and
    ragged 250 x 256 in bf16; momentum 1.0 and 1.3; three dead atoms a side
    on every odd problem and, at P >= 3, a dead lane (all-zero weights).
    Bars are phase 2's: log potentials atol 1e-4 + rtol 1e-5, scaling
    carries 1e-5 of max |value|, errors 1e-4 relative + 1e-6; the dead
    lane non-finite where the twin is (the kernel's LSE max drops a NaN
    that the twin's keeps, so its t reads -inf where the twin's is NaN)
    and its error NaN in both, which stops the lane at its first check.
    Each problem's bits equal the
    2-D launch on it alone at the same forced C (the static one, and C = 2
    at one case), a rerun is bit-identical, and a NaN row in problem 1
    leaves every other problem's bits unchanged."""
    from repro_torch.kernels import autotune, fused_loop

    bf, f32 = torch.bfloat16, torch.float32
    cases = [(P, GAN_BATCH, GAN_BATCH, 128, bf, 1.0) for P in BLOCK_PS]
    cases += [(32, GAN_BATCH, GAN_BATCH, 128, bf, 1.3),
              (3, 128, 128, 128, f32, 1.3)]
    cases += [(P, 128, 128, 128, f32, 1.0) for P in BLOCK_PS]
    cases += [(P, 250, GAN_BATCH, 128, bf, 1.3) for P in (3, 32)]
    for mode, name in (("log", "log_sinkhorn_block"),
                       ("scaling", "sinkhorn_block")):
        tol = (dict(atol=LSE_ATOL, rtol=LSE_RTOL) if mode == "log"
               else dict(rel_to_max=SCALING_REL_TOL))
        for k, (P, n, m, r, dtype, mom) in enumerate(cases):
            args = stacked_block_inputs(torch, mode, P, n, m, r, dtype,
                                        1000 + k, device)
            static = fused_loop._block_plan(n, m, r, dtype, mode).cluster
            forced = (static, 2) if (P, dtype, mom) == (32, bf, 1.0) \
                else (static,)
            dead = P // 2 if P >= 3 else None
            live = [i for i in range(P) if i != dead]
            for C in forced:
                with autotune.pinned(name, cluster=C):
                    kernel, plain = block_call(mode, args, 8, mom)
                    got, again = kernel(), kernel()
                    want = plain()
                    torch.cuda.synchronize()
                    worst, ok = 0.0, True
                    for gv, wv in zip(got[:3], want[:3]):
                        err, good = compare(torch, gv[live], wv[live], **tol)
                        worst, ok = max(worst, err), ok and good
                    e_got, e_want = got[3][live], want[3][live]
                    ok = ok and bool(((e_got - e_want).abs()
                                      <= 1e-4 * e_want.abs() + 1e-6).all())
                    if dead is not None:   # non-finite where the twin is
                        ok = ok and all(
                            torch.equal(torch.isfinite(gv[dead]),
                                        torch.isfinite(wv[dead]))
                            for gv, wv in zip(got, want)) and bool(
                            torch.isnan(got[3][dead])
                            and torch.isnan(want[3][dead]))
                    rerun = all(torch.equal(lane_bits(torch, x, i),
                                            lane_bits(torch, y, i))
                                for x, y in zip(got, again)
                                for i in range(P))
                    lanes2d = True     # each problem alone, same C
                    for i in range(P):
                        one = block_call(mode, tuple(
                            x[i].contiguous() for x in args), 8, mom)[0]()
                        lanes2d = lanes2d and all(
                            torch.equal(lane_bits(torch, x, i),
                                        y.contiguous().view(torch.int32))
                            for x, y in zip(got, one))
                    iso = "n/a"
                    if P > 1:
                        bad = args[0].clone()
                        bad[1, n // 2] = math.nan
                        poisoned = block_call(mode, (bad,) + args[1:], 8,
                                              mom)[0]()
                        torch.cuda.synchronize()
                        iso = all(torch.equal(lane_bits(torch, x, i),
                                              lane_bits(torch, y, i))
                                  for x, y in zip(got, poisoned)
                                  for i in range(P) if i != 1) and \
                            bool(torch.isnan(poisoned[3][1]))
                active = fused_loop._clusters(
                    device.index, mode, n, m, r, dtype == bf,
                    fused_loop._block_plan(n, m, r, dtype, mode, cluster=C))
                record(name, f"batched P={P} n={n} m={m} r={r} "
                       f"{str(dtype)[6:]} momentum={mom} C={C} ({active} "
                       f"clusters placed, {-(-P // active)} waves) dead "
                       f"lane {dead}: rerun "
                       f"{'bit-identical' if rerun else 'DIFFERS'}, lanes = "
                       f"2-D launches {'bit for bit' if lanes2d else 'NO'}, "
                       f"NaN lane isolated {iso}", worst,
                       ok and rerun and lanes2d and iso is not False)


def check_capture(torch, np, device, record):
    """Every kernel wrapper captured into a CUDA graph (as the solve
    runners capture them; the contracts are cooperative launches, the
    megakernels cluster launches) and replayed twice: each replay's output
    bit-identical to the eager launch on the same inputs."""
    from repro_torch import kernels as K

    g = torch.Generator(device=device).manual_seed(19)

    def rnd(*shape, dtype=torch.float32):
        return (torch.rand(shape, generator=g, device=device) + 0.05
                ).to(dtype).contiguous()

    xi, u, t = rnd(N, R_ANCHORS), rnd(N, 1), rnd(R_ANCHORS, 1)
    lxi = torch.log(xi)
    live = torch.full((N // STREAM_PAGE,), STREAM_PAGE, dtype=torch.int32,
                      device=device)
    live[1::2] = 0
    lx, lz = (torch.log(rnd(GAN_BATCH, 128)).to(torch.bfloat16)
              for _ in range(2))
    sx, sz = (rnd(GAN_BATCH, 128, dtype=torch.bfloat16) for _ in range(2))
    w = torch.full((GAN_BATCH, 1), 1.0 / GAN_BATCH, device=device)
    lw = torch.log(w)
    f0 = torch.zeros((GAN_BATCH, 1), device=device)
    t0 = K.log_feature_contract(lx, f0)
    x, anchors = rnd(N, D), rnd(R_ANCHORS, D)
    const = rnd(R_ANCHORS)
    kw = dict(page_size=STREAM_PAGE)
    cases = {
        "gaussian_feature_map": lambda: K.gaussian_feature_map(
            x, anchors, const, inv_eps=1 / EPS, log_space=True),
        "feature_contract": lambda: K.feature_contract(xi, u),
        "sinkhorn_halfstep": lambda: K.sinkhorn_halfstep(xi, t, u),
        "feature_matvec": lambda: K.feature_matvec(xi, t),
        "sinkhorn_block": lambda: K.sinkhorn_block(
            sx, sz, w, w, w, w, w, inner_steps=8)[0],
        "log_feature_contract": lambda: K.log_feature_contract(lxi, u),
        "log_halfstep": lambda: K.log_halfstep(lxi, t, u, scale=EPS),
        "log_sinkhorn_block": lambda: K.log_sinkhorn_block(
            lx, lz, lw, lw, w, f0, f0, t0, inner_steps=8, eps=0.5)[0],
        "log_matvec": lambda: K.log_matvec(lxi, t[:, 0].contiguous()),
        "paged_feature_contract": lambda: K.paged_feature_contract(
            xi, u, live, **kw),
        "paged_halfstep": lambda: K.paged_halfstep(xi, t, u, live, **kw),
        "paged_feature_matvec": lambda: K.paged_feature_matvec(
            xi, t, live, **kw),
    }
    for name, fn in cases.items():
        want = fn().clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = fn()
        same = []
        for _ in range(2):
            got.zero_()
            graph.replay()
            torch.cuda.synchronize()
            same.append(torch.equal(got, want))
        record(name, "captured in a CUDA graph, 2 replays bit-identical",
               0.0, all(same))


# ---------------------------------------------------------------------------
# Phase 3: times
# ---------------------------------------------------------------------------


def time_ms(torch, fn, batches=21, per_batch=10, warmup=3):
    """Device time of one call of ``fn``: the median over ``batches`` of the
    mean of ``per_batch`` back-to-back calls between two CUDA events. Each
    batch is queued behind a ``torch.cuda._sleep`` spin, so the host has
    enqueued the whole batch before the device reaches it and the events
    see device time, not the Python wrapper's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means, host_bound = [], 0
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        host_bound += enqueue_ms > SLEEP_MS[0]
        means.append(start.elapsed_time(end) / per_batch)
    if host_bound:
        log(f"  (warning: {host_bound} of {batches} batches took longer to "
            "enqueue than the spin; their times include host time)")
    return statistics.median(means)


def cycling(fn, args):
    """A call of ``fn`` on the next of ``args`` each time (round robin)."""
    state = [0]

    def call():
        state[0] = (state[0] + 1) % len(args)
        return fn(args[state[0]])

    return call


def calibrate_sleep(torch):
    """Device milliseconds of one ``torch.cuda._sleep(SLEEP_CYCLES)``."""
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    end.synchronize()
    SLEEP_MS[0] = start.elapsed_time(end)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernels_per_call(torch, fn):
    """Device kernels one call of ``fn`` launches, as the profiler sees
    them: (count, names)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = kernel_rows(torch, prof)
    return sum(e.count for e in rows), sorted({e.key[:40] for e in rows})


def forced(module, key, value):
    """A context setting ``module._FORCE[key]`` (a launch option the
    planner otherwise picks) for its body; a no-op where the module has no
    such option (a checkout from before the option)."""

    @contextlib.contextmanager
    def ctx():
        opts = getattr(module, "_FORCE", None)
        if opts is None or key not in opts:
            yield False
            return
        old = opts[key]
        opts[key] = value
        try:
            yield True
        finally:
            opts[key] = old

    return ctx()


def launches_per_call(torch, np, device):
    """The device kernels one call of each redesigned wrapper launches
    (the profiler's kernel rows), at the solve shape: the feature map,
    the scaling contract in float32 and bf16, and the paged contract
    (float32, every other page live)."""
    from repro_torch.kernels.feature_map import gaussian_feature_map
    from repro_torch.kernels.kermatvec import feature_contract
    from repro_torch.kernels.logmatvec import log_feature_contract
    from repro_torch.kernels.paged import paged_feature_contract

    x, u, c = feature_inputs(torch, np, N, R_ANCHORS, D, EPS, 0, device)
    xi = torch.rand((N, R_ANCHORS), device=device)
    xi16 = xi.to(torch.bfloat16)
    w = torch.rand((N, 1), device=device)
    # the trainer's batch-2048 factor and weights, built outside the
    # profiled call so that only the wrapper's launches are counted
    xi16_gan = xi16[:GAN_BIG_BATCH, :128].contiguous()
    w_gan = w[:GAN_BIG_BATCH]
    live = torch.full((N // STREAM_PAGE,), STREAM_PAGE, dtype=torch.int32,
                      device=device)
    live[::2] = 0
    for label, fn in (
            ("gaussian_feature_map", lambda: gaussian_feature_map(
                x, u, c, inv_eps=1 / EPS, log_space=True)),
            ("feature_contract f32", lambda: feature_contract(xi, w)),
            ("feature_contract bf16", lambda: feature_contract(xi16, w)),
            ("log_feature_contract f32",
             lambda: log_feature_contract(xi, w)),
            ("log_feature_contract bf16 2048x128",
             lambda: log_feature_contract(xi16_gan, w_gan)),
            ("paged_feature_contract", lambda: paged_feature_contract(
                xi, w, live, page_size=STREAM_PAGE))):
        count, names = kernels_per_call(torch, fn)
        log(f"  {label:22s} device kernels a call: {count} {names}")


def time_feature_map(torch, np, device):
    """Phase 3 for the feature map beyond its JSON row: both epilogues at
    the solve shape (n = 16384, r = 1024, d = 8, eps 0.1) and at the
    trainer's shapes (n = 2048 and 256, r = 128, d = 8, eps 0.5), each
    beside ``x @ anchors.T`` and a ``fill_`` of the same output (the
    card's own store rate), and the evict-first store hint forced on and
    off where the planner leaves the choice."""
    from repro_torch.kernels import feature_map as fm_mod
    from repro_torch.kernels.feature_map import gaussian_feature_map

    for n, r, eps in ((N, R_ANCHORS, EPS), (GAN_BIG_BATCH, 128, 0.5),
                      (GAN_BATCH, 128, 0.5)):
        x, u, c = feature_inputs(torch, np, n, r, D, eps, 1, device)
        b_ms, b_by = bound(4.0 * (n * D + r * D + r + n * r),
                           2.0 * n * r * D + 4.0 * n * r)
        lib_ms = time_ms(torch, lambda: x @ u.T)
        fill = torch.empty((n, r), device=device)
        fill_ms = time_ms(torch, lambda: fill.fill_(1.0))
        log(f"  (n, r) = ({n}, {r}) float32 fill_: {fill_ms:.4f} ms "
            f"({4e-9 * n * r / fill_ms:.3f} TB/s written)")
        for log_space in (True, False):
            def call():
                return gaussian_feature_map(x, u, c, inv_eps=1 / eps,
                                            log_space=log_space)
            ms = time_ms(torch, call)
            extra = []
            for hint in (True, False):
                with forced(fm_mod, "stream", hint) as ok:
                    if ok:
                        extra.append(f"evict-first {'on' if hint else 'off'}"
                                     f" {time_ms(torch, call):.4f} ms")
            log(f"  gaussian_feature_map   n={n} r={r} d={D} "
                f"{'log' if log_space else 'exp'}: kernel {ms:.4f} ms  "
                f"library {lib_ms:.4f} ms (x @ anchors.T)  bound {b_ms:.5f} ms"
                f" ({b_by})  kernel/bound {ms / b_ms:.2f}  {'; '.join(extra)}")


def time_kernels(torch, np, device):
    from repro_torch.kernels import ref
    from repro_torch.kernels.feature_map import gaussian_feature_map
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    x, u, c = feature_inputs(torch, np, N, R_ANCHORS, D, EPS, 0, device)
    inv = 1.0 / EPS
    log_w = gaussian_feature_map(x, u, c, inv_eps=inv, log_space=True)
    g = torch.Generator(device=device).manual_seed(0)
    s = 10.0 * torch.randn((N, 1), generator=g, device=device)
    t = log_feature_contract(log_w, s)
    lmarg = torch.full((M, 1), -math.log(M), device=device)
    n, r, d, B = N, R_ANCHORS, D, 1
    rows = {}

    def row(name, kernel, plain, library, nbytes, flops):
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch, plain)
        library_ms = time_ms(torch, library)
        b_ms, b_by = bound(nbytes, flops)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=b_ms, bound_by=b_by)
        log(f"  {name:22s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {library_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
            f"kernel/bound {ms / b_ms:.2f}")

    def library_dot():
        return x @ u.T

    row("gaussian_feature_map",
        lambda: gaussian_feature_map(x, u, c, inv_eps=inv, log_space=True),
        lambda: ref.gaussian_feature_map_ref(x, u, c, inv_eps=inv,
                                             log_space=True),
        library_dot,
        4.0 * (n * d + r * d + r + n * r), 2.0 * n * r * d + 4.0 * n * r)
    row("log_feature_contract",
        lambda: log_feature_contract(log_w, s),
        lambda: ref.log_feature_contract_ref(log_w, s),
        lambda: torch.logsumexp(log_w[:, :, None] + s[:, None, :], dim=0),
        4.0 * (n * r + n * B + r * B), 3.0 * n * r * B)
    row("log_halfstep",
        lambda: log_halfstep(log_w, t, lmarg, scale=EPS),
        lambda: ref.log_halfstep_ref(log_w, t, lmarg, scale=EPS),
        lambda: torch.logsumexp(log_w[:, :, None] + t[None, :, :], dim=1),
        4.0 * (M * r + r * B + 2 * M * B), 3.0 * M * r * B)
    # one log iteration in the plan's order on two factors of 64 MiB
    y = 0.3 * torch.randn((M, d), generator=g, device=device)
    log_z = gaussian_feature_map(y, u, c, inv_eps=inv, log_space=True)
    lmarg_n = torch.full((n, 1), -math.log(n), device=device)
    zero = torch.zeros_like(lmarg)

    def iteration():
        gz = log_halfstep(log_z, t, lmarg, scale=EPS)
        t2 = log_feature_contract(log_z, gz)
        f = log_halfstep(log_w, t2, lmarg_n, scale=EPS)
        t3 = log_feature_contract(log_w, f)
        log_halfstep(log_z, t3, zero, scale=-1.0)

    time_plan_iteration(torch, iteration, f"log f32 n={n} r={r}, two "
                        "factors of 64 MiB", order="half-step, contract, "
                        "half-step, contract, raw LSE")
    return rows


def time_halfstep_cold(torch, np, device):
    """The log half-step at the row kernel's four cold shapes (n = 16384,
    r = 1024 and 256, float32 and bf16, B = 1), on log-features log(U(0, 1)
    + 0.05), cycling through copies past 100 MB (the bound counts
    device-memory bytes), and warm on one copy; beside its plain version
    and ``torch.logsumexp`` on the same copies."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.logmatvec import log_halfstep

    n, B = N, 1
    g = torch.Generator(device=device).manual_seed(13)
    lmarg = torch.full((n, B), -math.log(n), device=device)
    for r in (R_ANCHORS, 256):
        lw32 = torch.log(torch.as_tensor(explicit_features(np, n, r, r + 1),
                                         device=device))
        t = torch.randn((r, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            fb = torch.finfo(dtype).bits // 8
            copies = [lw32.to(dtype, copy=True) for _ in
                      range(max(1, math.ceil(100e6 / (fb * n * r))))]
            cold = [time_ms(torch, cycling(fn, copies)) for fn in (
                lambda w: log_halfstep(w, t, lmarg, scale=EPS),
                lambda w: ref.log_halfstep_ref(w, t, lmarg, scale=EPS),
                lambda w: torch.logsumexp(w.float()[:, :, None]
                                          + t[None, :, :], dim=1))]
            warm = time_ms(torch, lambda: log_halfstep(copies[0], t, lmarg,
                                                       scale=EPS))
            b_ms, b_by = bound(fb * n * r + 4.0 * (r * B + 2 * n * B),
                               3.0 * n * r * B)
            tag = "f32" if dtype == torch.float32 else "bf16"
            log(f"  log_halfstep           {tag} n={n} r={r} cold: kernel "
                f"{cold[0]:.4f} ms (L2-warm {warm:.4f})  plain {cold[1]:.4f} "
                f"ms  library {cold[2]:.4f} ms  bound {b_ms:.5f} ms ({b_by})"
                f"  kernel/bound {cold[0] / b_ms:.2f}")
            del copies


def time_training_kernels(torch, np, device):
    """Phase 3 at the training path's shapes: the bf16 contract and
    half-step at the streaming plan's batch 2048, r = 128 (float32 beside
    them), and the megakernel at the OT-GAN shape n = m = 256, r = 128,
    bf16, inner_steps = 8. No PyTorch call computes eight Sinkhorn
    iterations, so the megakernel has no library time."""
    from repro_torch.kernels import fused_loop, logmatvec, ref
    from repro_torch.kernels.fused_loop import log_sinkhorn_block
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    rows = {}
    n, r, B = GAN_BIG_BATCH, 128, 1
    x, u, c = feature_inputs(torch, np, n, r, D, 2.0, 3, device)
    log_w32 = ref.gaussian_feature_map_ref(x, u, c, inv_eps=0.5,
                                           log_space=True)
    g = torch.Generator(device=device).manual_seed(3)
    s = torch.randn((n, 1), generator=g, device=device)
    lmarg = torch.full((n, 1), -math.log(n), device=device)
    for dtype in (torch.bfloat16, torch.float32):
        log_w = log_w32.to(dtype)
        t = log_feature_contract(log_w, s)
        fb = log_w.element_size()
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        for name, kernel, plain, library, nbytes, flops in (
            ("log_feature_contract",
             lambda: log_feature_contract(log_w, s),
             lambda: ref.log_feature_contract_ref(log_w, s),
             lambda: torch.logsumexp(log_w.float()[:, :, None]
                                     + s[:, None, :], dim=0),
             fb * n * r + 4.0 * (n * B + r * B), 3.0 * n * r * B),
            ("log_halfstep",
             lambda: log_halfstep(log_w, t, lmarg, scale=2.0),
             lambda: ref.log_halfstep_ref(log_w, t, lmarg, scale=2.0),
             lambda: torch.logsumexp(log_w.float()[:, :, None]
                                     + t[None, :, :], dim=1),
             fb * n * r + 4.0 * (r * B + 2 * n * B), 3.0 * n * r * B)):
            ms = time_ms(torch, kernel)
            plain_ms = time_ms(torch, plain)
            library_ms = time_ms(torch, library)
            b_ms, b_by = bound(nbytes, flops)
            rows[f"{name}/{tag}"] = dict(ms=ms, plain_ms=plain_ms,
                                         library_ms=library_ms, bound_ms=b_ms,
                                         bound_by=b_by)
            log(f"  {name:22s} {tag} n={n} r={r}: kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  library {library_ms:.4f} ms  bound "
                f"{b_ms:.5f} ms ({b_by})  kernel/bound {ms / b_ms:.2f}")
        # The contract's two paths forced, beside the one the wrapper takes
        # (a checkout from before the one-launch contract took the scalar
        # path at r = 128; the one-launch contract takes 16-byte vectors
        # in row groups).
        parts = []
        for vec in (True, False):
            with log_contract_path(logmatvec, vec):
                parts.append(f"{'16-byte vector' if vec else 'scalar'} path "
                             f"forced {time_ms(torch, lambda: log_feature_contract(log_w, s)):.4f} ms")
        log(f"  log_feature_contract   {tag} n={n} r={r}: {'; '.join(parts)}")

    n = m = GAN_BATCH
    steps = 8
    args = block_inputs(torch, np, n, m, 128, D, 0.5, torch.bfloat16, 0, 7,
                        device)
    nbytes = 2.0 * (n + m) * 128 + 4.0 * (3 * n + 4 * m + 2 * 128 + 1)
    flops = 3.0 * 128 * (steps * 2 * (n + m) + m)

    def block(inner=steps):
        return log_sinkhorn_block(*args, inner_steps=inner, eps=0.5)

    ms = time_ms(torch, block)
    plain_ms = time_ms(torch, lambda: ref.log_sinkhorn_block_ref(
        *args, inner_steps=steps, eps=0.5))
    b_ms, b_by = bound(nbytes, flops)
    rows["log_sinkhorn_block"] = dict(ms=ms, plain_ms=plain_ms,
                                      library_ms=None, bound_ms=b_ms,
                                      bound_by=b_by)
    plan_of = getattr(fused_loop, "_block_plan", None)
    shape = (f"cluster of {plan_of(n, m, 128, torch.bfloat16).cluster} CTAs"
             if plan_of else "one CTA")
    log(f"  log_sinkhorn_block     bf16 n=m={n} r=128 inner_steps={steps} "
        f"({shape}): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
        f"none  bound {b_ms:.5f} ms ({b_by})  kernel/bound {ms / b_ms:.1f}")
    # a launch of one iteration splits the fixed cost (the launch, staging
    # the factors, the block-end error) from the cost of an iteration
    one_ms = time_ms(torch, lambda: block(1))
    log(f"  log_sinkhorn_block     inner_steps=1: kernel {one_ms:.4f} ms; "
        f"each further iteration {(ms - one_ms) / (steps - 1):.4f} ms")
    # the yardstick: the same iterations through the per-iteration kernels
    unfused = unfused_log_block(torch, args, steps, 0.5)
    unfused_ms = time_ms(torch, unfused, per_batch=4)
    got, want = block(), unfused()
    diff = max(float((x - y).abs().nan_to_num(0.0).max())
               for x, y in zip(got[:3], want[:3]))
    log(f"  log_sinkhorn_block     the same {steps} iterations unfused (2 "
        f"log contracts, 2 log half-steps an iteration, then the check): "
        f"{unfused_ms:.4f} ms; megakernel/unfused {ms / unfused_ms:.2f}; "
        f"max |d f, g, t| {diff:.2e}, err {float(got[3]):.4e} / "
        f"{float(want[3]):.4e}")
    return rows


def unfused_log_block(torch, args, steps, eps):
    """``steps`` log-domain iterations at momentum 1 through the
    per-iteration kernels, in the log plan's order (``ops._log_plan``:
    half-step zeta, contract zeta, half-step xi, contract xi), then the
    block-end check: the megakernel's yardstick (P problems at once where
    ``args`` are stacked)."""
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    lxi, lzt, loga, logb, b, _, _, t0 = args
    zero = torch.zeros_like(logb)

    def run():
        t = t0
        for _ in range(steps):
            g = log_halfstep(lzt, t, logb, scale=eps)
            t = log_feature_contract(lzt, g / eps)
            f = log_halfstep(lxi, t, loga, scale=eps)
            t = log_feature_contract(lxi, f / eps)
        lse = log_halfstep(lzt, t, zero, scale=-1.0)
        return f, g, t, torch.sum(torch.abs(torch.exp(lse + g / eps) - b),
                                  dim=(-2, -1))

    return run


def log_contract_path(logmatvec, vec):
    """A context forcing the log contract's 16-byte path on (``vec``,
    where the rows allow it) or off: through ``_contract_vectorized`` in a
    checkout whose wrapper has that rule, else through ``_vectorized``."""
    name = ("_contract_vectorized" if hasattr(logmatvec,
                                              "_contract_vectorized")
            else "_vectorized")
    base = logmatvec._vectorized

    @contextlib.contextmanager
    def ctx():
        old = getattr(logmatvec, name)
        setattr(logmatvec, name, lambda w, B: vec and base(w, B))
        try:
            yield
        finally:
            setattr(logmatvec, name, old)

    return ctx()


def time_scaling_kernels(torch, np, device):
    """Phase 3 for the scaling path: the contract, half-step and matvec at
    n = 16384, r = 1024 and 256, float32 and bf16 (B = 1), each beside its
    plain version and the one PyTorch call computing the same function
    (``xi.T @ u``, ``marg / (xi @ t)``, ``xi @ t``; bf16 factors widened
    first, as the kernels widen them), and the scaling megakernel at the
    OT-GAN shape n = m = 256, r = 128, bf16, 8 iterations (no PyTorch call
    runs Sinkhorn iterations). A factor of 8 to 32 MiB fits the 50 MB L2,
    so each call is timed cold, cycling through copies of the factor that
    together exceed 100 MB (the bound counts device-memory bytes), and warm,
    on one copy (what a solve whose two factors fit the L2 finds). The
    JSON line takes the cold float32 r = 1024 rows, the shape of the
    scaling path's first request."""
    from repro_torch.kernels import fused_loop, kermatvec, ref
    from repro_torch.kernels.fused_loop import sinkhorn_block
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )

    rows = {}
    n, B = N, 1
    g = torch.Generator(device=device).manual_seed(11)
    u = torch.rand((n, B), generator=g, device=device)
    marg = torch.full((n, B), 1.0 / n, device=device)
    for r in (R_ANCHORS, 256):
        xi32 = torch.as_tensor(explicit_features(np, n, r, r), device=device)
        t = torch.rand((r, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            fb = torch.finfo(dtype).bits // 8
            copies = [xi32.to(dtype, copy=True) for _ in
                      range(max(1, math.ceil(100e6 / (fb * n * r))))]
            tag = "f32" if dtype == torch.float32 else "bf16"
            for name, kernel, plain, library, nbytes, flops in (
                ("feature_contract",
                 lambda xi: feature_contract(xi, u),
                 lambda xi: ref.feature_contract_ref(xi, u),
                 lambda xi: xi.float().T @ u,
                 fb * n * r + 4.0 * (n * B + r * B), 2.0 * n * r * B),
                ("sinkhorn_halfstep",
                 lambda xi: sinkhorn_halfstep(xi, t, marg),
                 lambda xi: ref.sinkhorn_halfstep_ref(xi, t, marg),
                 lambda xi: marg / (xi.float() @ t),
                 fb * n * r + 4.0 * (r * B + 2 * n * B),
                 2.0 * n * r * B + n * B),
                ("feature_matvec",
                 lambda xi: feature_matvec(xi, t),
                 lambda xi: ref.feature_matvec_ref(xi, t),
                 lambda xi: xi.float() @ t,
                 fb * n * r + 4.0 * (r * B + n * B), 2.0 * n * r * B)):
                cold = [time_ms(torch, cycling(fn, copies))
                        for fn in (kernel, plain, library)]
                warm = time_ms(torch, lambda: kernel(copies[0]))
                b_ms, b_by = bound(nbytes, flops)
                row = dict(ms=cold[0], plain_ms=cold[1], library_ms=cold[2],
                           bound_ms=b_ms, bound_by=b_by)
                rows[f"{name}/{tag}/r={r}"] = row
                if tag == "f32" and r == R_ANCHORS:
                    rows[name] = row
                log(f"  {name:22s} {tag} n={n} r={r}: kernel {cold[0]:.4f} ms"
                    f" (L2-warm {warm:.4f})  plain {cold[1]:.4f} ms  library "
                    f"{cold[2]:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                    f"kernel/bound {cold[0] / b_ms:.2f}")
            floor_ms = time_ms(torch, cycling(lambda xi: xi.sum(), copies))
            log(f"  read floor             {tag} n={n} r={r}: xi.sum() "
                f"{floor_ms:.4f} ms ({fb * n * r / floor_ms * 1e-9:.3f} TB/s;"
                " the card's own full read of the factor, no yardstick)")
            xi, zeta = copies[0], copies[1]

            def iteration():
                s = feature_contract(zeta, u)
                sinkhorn_halfstep(xi, s, marg)
                feature_contract(xi, u)
                feature_matvec(zeta, t)

            time_plan_iteration(
                torch, iteration, f"{tag} n={n} r={r}, two factors of "
                f"{fb * n * r / 2**20:.0f} MiB", kermatvec)
            with forced(kermatvec, "stream", True) as ok:
                if ok:
                    ef_ms = [time_ms(torch, cycling(fn, copies)) for fn in (
                        lambda xi: sinkhorn_halfstep(xi, t, marg),
                        lambda xi: feature_matvec(xi, t))]
                    log(f"  row kernels            {tag} n={n} r={r}: "
                        f"evict-first loads forced: half-step "
                        f"{ef_ms[0]:.4f} ms, matvec {ef_ms[1]:.4f} ms")
            if getattr(kermatvec, "_rows_kernel", None) and \
                    kermatvec._rows_kernel(r, B, True, fb)[0]:
                # t in shared memory, which the planner leaves at this shape
                chosen = kermatvec._rows_kernel
                kermatvec._rows_kernel = lambda r, B, *_: (0, 1, 4 * r * B)
                try:
                    smem_ms = [time_ms(torch, cycling(fn, copies)) for fn in (
                        lambda xi: sinkhorn_halfstep(xi, t, marg),
                        lambda xi: feature_matvec(xi, t))]
                finally:
                    kermatvec._rows_kernel = chosen
                log(f"  row kernels            {tag} n={n} r={r}: t in "
                    f"shared memory forced: half-step {smem_ms[0]:.4f} ms, "
                    f"matvec {smem_ms[1]:.4f} ms (the wrapper keeps t in "
                    "registers)")
            with forced(kermatvec, "combine", False) as ok:
                if ok:
                    slabs_ms = time_ms(torch, cycling(
                        lambda xi: feature_contract(xi, u), copies))
                    log(f"  feature_contract       {tag} n={n} r={r}: slabs "
                        f"only {slabs_ms:.4f} ms (no grid barrier or "
                        "combine; t not formed)")
            if getattr(kermatvec, "_flat_vectorized", None) and \
                    kermatvec._flat_vectorized(copies[0], B):
                # the scalar path, which the wrapper leaves at this shape
                chosen = kermatvec._flat_vectorized
                kermatvec._flat_vectorized = lambda *_: False
                try:
                    scalar_ms = time_ms(torch, cycling(
                        lambda xi: feature_contract(xi, u), copies))
                finally:
                    kermatvec._flat_vectorized = chosen
                log(f"  feature_contract       {tag} n={n} r={r}: scalar "
                    f"path forced {scalar_ms:.4f} ms (the wrapper takes the "
                    "16-byte path with row groups)")
            del copies, xi, zeta

    n = m = GAN_BATCH
    r, steps = 128, 8
    args = scaling_block_inputs(torch, n, m, r, torch.bfloat16, 0, 7, device)
    nbytes = 2.0 * (n + m) * r + 4.0 * (3 * n + 5 * m + 1)
    flops = steps * (4.0 * r * (n + m) + 4.0 * (n + m)) + 3.0 * m
    ms = time_ms(torch, lambda: sinkhorn_block(*args, inner_steps=steps))
    plain_ms = time_ms(torch, lambda: ref.sinkhorn_block_ref(
        *args, inner_steps=steps))
    b_ms, b_by = bound(nbytes, flops)
    rows["sinkhorn_block"] = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                                  bound_ms=b_ms, bound_by=b_by)
    plan_of = getattr(fused_loop, "_scaling_block_plan", None)
    shape = (f"cluster of {plan_of(n, m, r, torch.bfloat16).cluster} CTAs"
             if plan_of else "one CTA")
    log(f"  sinkhorn_block         bf16 n=m={n} r={r} inner_steps={steps} "
        f"({shape}): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library "
        f"none  bound {b_ms:.6f} ms ({b_by})  kernel/bound {ms / b_ms:.1f}")
    # a launch of one iteration splits the fixed cost (staging the factors,
    # the block-end error) from the cost of an iteration
    one_ms = time_ms(torch, lambda: sinkhorn_block(*args, inner_steps=1))
    log(f"  sinkhorn_block         inner_steps=1: kernel {one_ms:.4f} ms; "
        f"each further iteration {(ms - one_ms) / (steps - 1):.4f} ms")
    # the yardstick: the same iterations through the per-iteration kernels
    unfused = unfused_scaling_block(torch, args, steps)
    unfused_ms = time_ms(torch, unfused, per_batch=4)
    got, want = sinkhorn_block(*args, inner_steps=steps), unfused()
    diff = max(float((x - y).abs().max()) for x, y in zip(got[:3], want[:3]))
    log(f"  sinkhorn_block         the same {steps} iterations unfused (2 "
        f"contracts, a half-step and a matvec an iteration, then the "
        f"check): {unfused_ms:.4f} ms; megakernel/unfused "
        f"{ms / unfused_ms:.2f}; max |d u, v, s| {diff:.2e}, err "
        f"{float(got[3]):.4e} / {float(want[3]):.4e}")
    return rows


def unfused_scaling_block(torch, args, steps):
    """``steps`` scaling-space iterations at momentum 1 through the
    per-iteration kernels, in the scaling plan's order
    (``ops._scaling_plan``: v = b / s, contract zeta, half-step xi,
    contract xi, matvec zeta), then the block-end error: the scaling
    megakernel's yardstick (P problems at once where ``args`` are
    stacked)."""
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )

    xi, zeta, a, b, u0, v0, s0 = args

    def run():
        u, v, s = u0, v0, s0
        for _ in range(steps):
            v = b / s
            t = feature_contract(zeta, v)
            u = sinkhorn_halfstep(xi, t, a)
            s = feature_matvec(zeta, feature_contract(xi, u))
        return u, v, s, torch.sum(torch.abs(v * s - b), dim=(-2, -1))

    return run


def time_plan_iteration(torch, iteration, what, module=None,
                        order="contract, half-step, contract, matvec"):
    """One Sinkhorn iteration in the plan's order (``ops._scaling_plan``'s
    and ``_paged_scaling_plan``'s step: contract zeta, half-step xi,
    contract xi, matvec zeta; ``ops._log_plan``'s: half-step zeta,
    contract zeta, half-step xi, contract xi, raw LSE of zeta), run back
    to back on two factors as a solve runs it: each row kernel is followed
    by the contract of its own factor, which finds it in the L2 where the
    row kernel left it there, and each contract by a row kernel of the
    other factor. With ``module``, also with its evict-first loads forced
    on and off."""
    parts = []
    for label, value in (("evict-first on", True),
                         ("evict-first off", False)):
        with forced(module, "stream", value) as ok:
            if ok:
                parts.append(f"{label} {time_ms(torch, iteration):.4f} ms")
    parts.append(f"as planned {time_ms(torch, iteration):.4f} ms")
    log(f"  plan iteration         {what} ({order}): {'; '.join(parts)}")


def flat_contract_digest(torch, device):
    """A digest of the flat contract's outputs at fixed seeds, over the
    16-byte and scalar paths, one and several splits, float32 and bf16:
    two checkouts (``--src``) print the same digest where their flat
    contracts are bit-identical."""
    import hashlib

    from repro_torch.kernels.kermatvec import feature_contract

    h = hashlib.sha256()
    g = torch.Generator(device=device).manual_seed(23)
    for n, r, B in ((N, R_ANCHORS, 1), (N, 256, 1), (1001, 40, 3),
                    (N, R_ANCHORS, 3), (1001, 1032, 1), (7, 12, 1)):
        xi32 = torch.rand((n, r), generator=g, device=device) + 0.05
        u = torch.rand((n, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            t = feature_contract(xi32.to(dtype), u)
            h.update(t.cpu().numpy().tobytes())
    log(f"  feature_contract       output digest at fixed seeds "
        f"(12 shapes): {h.hexdigest()[:32]}")
    return h.hexdigest()


def time_paged_kernels(torch, np, device):
    """Phase 3 for the streaming path: the paged contract, half-step and
    matvec at C = 32768, r = 1024 and 256, float32 and bf16, B = 1, with
    100%, 50% and 25% of the pages live (the first pages, as a store packs
    them), each beside the flat kernel on the same buffer, its plain
    version and the PyTorch calls ``xi.T @ (u * mask)``, ``marg / (xi @ t)
    * mask`` and ``(xi @ t) * mask``. The bound counts the bytes of the
    live pages (each read once), the page table and the outputs. Each call
    is timed cold, cycling through copies of the buffer whose live pages
    together exceed 100 MB, and warm on one copy. Then log_matvec at
    (16384, 1024), float32 and bf16, against ``torch.logsumexp(log_m + t,
    1)``. The JSON line takes the cold float32 r = 1024 rows at 50% live
    (the streaming path's buffers) and log_matvec in float32."""
    from repro_torch.kernels import paged as paged_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )
    from repro_torch.kernels.logmatvec import log_matvec
    from repro_torch.kernels.paged import (
        paged_feature_contract,
        paged_feature_matvec,
        paged_halfstep,
    )

    rows = {}
    C, B, ps = STREAM_CAPACITY, 1, STREAM_PAGE
    n_pages = C // ps
    g = torch.Generator(device=device).manual_seed(13)
    u = torch.rand((C, B), generator=g, device=device)
    marg = torch.full((C, B), 1.0 / C, device=device)
    for r in (R_ANCHORS, 256):
        xi32 = torch.as_tensor(explicit_features(np, C, r, 3 * r),
                               device=device)
        t = torch.rand((r, B), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            fb = torch.finfo(dtype).bits // 8
            tag = "f32" if dtype == torch.float32 else "bf16"
            for share in (1.0, 0.5, 0.25):
                n_live = int(n_pages * share)
                live = torch.as_tensor(
                    [ps] * n_live + [0] * (n_pages - n_live),
                    dtype=torch.int32, device=device)
                mask = ref.page_mask(live, ps)[:, None].float()
                rows_live = n_live * ps
                copies = [xi32.to(dtype, copy=True) for _ in range(max(
                    1, math.ceil(100e6 / (fb * rows_live * r))))]
                table = 4.0 * n_pages
                for name, kernel, flat, plain, library, nbytes, flops in (
                    ("paged_feature_contract",
                     lambda xi: paged_feature_contract(xi, u, live,
                                                       page_size=ps),
                     lambda xi: feature_contract(xi, u),
                     lambda xi: ref.paged_contract_ref(xi, u, live,
                                                       page_size=ps),
                     lambda xi: xi.float().T @ (u * mask),
                     fb * rows_live * r + 4.0 * (rows_live * B + r * B)
                     + table, 2.0 * rows_live * r * B),
                    ("paged_halfstep",
                     lambda xi: paged_halfstep(xi, t, marg, live,
                                               page_size=ps),
                     lambda xi: sinkhorn_halfstep(xi, t, marg),
                     lambda xi: ref.paged_halfstep_ref(xi, t, marg, live,
                                                       page_size=ps),
                     lambda xi: marg / (xi.float() @ t) * mask,
                     fb * rows_live * r + 4.0 * (r * B + rows_live * B
                                                 + C * B) + table,
                     2.0 * rows_live * r * B + rows_live * B),
                    ("paged_feature_matvec",
                     lambda xi: paged_feature_matvec(xi, t, live,
                                                     page_size=ps),
                     lambda xi: feature_matvec(xi, t),
                     lambda xi: ref.paged_matvec_ref(xi, t, live,
                                                     page_size=ps),
                     lambda xi: (xi.float() @ t) * mask,
                     fb * rows_live * r + 4.0 * (r * B + C * B) + table,
                     2.0 * rows_live * r * B)):
                    cold = [time_ms(torch, cycling(fn, copies))
                            for fn in (kernel, flat, plain, library)]
                    warm = time_ms(torch, lambda: kernel(copies[0]))
                    b_ms, b_by = bound(nbytes, flops)
                    row = dict(ms=cold[0], plain_ms=cold[2],
                               library_ms=cold[3], bound_ms=b_ms,
                               bound_by=b_by)
                    rows[f"{name}/{tag}/r={r}/{share:.2f}"] = row
                    if tag == "f32" and r == R_ANCHORS and share == 0.5:
                        rows[name] = row
                    log(f"  {name:22s} {tag} C={C} r={r} live={share:.0%}: "
                        f"kernel {cold[0]:.4f} ms (L2-warm {warm:.4f})  flat "
                        f"{cold[1]:.4f} ms  plain {cold[2]:.4f} ms  library "
                        f"{cold[3]:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                        f"kernel/bound {cold[0] / b_ms:.2f}")
                floor_ms = time_ms(torch, cycling(
                    lambda xi: xi[:rows_live].sum(), copies))
                log(f"  read floor             {tag} C={C} r={r} "
                    f"live={share:.0%}: xi[live rows].sum() {floor_ms:.4f} ms "
                    "(the card's own read of the live pages, no yardstick)")
                variants = []
                for label, key, value in (
                        ("slabs only (no grid barrier or combine; t not "
                         "formed)", "combine", False),
                        ("evict-first on", "stream", True),
                        ("evict-first off", "stream", False)):
                    with forced(paged_mod, key, value) as ok:
                        if ok:
                            ms = time_ms(torch, cycling(
                                lambda xi: paged_feature_contract(
                                    xi, u, live, page_size=ps), copies))
                            variants.append(f"{label} {ms:.4f} ms")
                if variants:
                    log(f"  paged_feature_contract {tag} C={C} r={r} "
                        f"live={share:.0%}: {'; '.join(variants)}")
                if share == 0.5:
                    xi, zeta = copies[0], copies[1]

                    def iteration():
                        s = paged_feature_contract(zeta, u, live,
                                                   page_size=ps)
                        paged_halfstep(xi, s, marg, live, page_size=ps)
                        paged_feature_contract(xi, u, live, page_size=ps)
                        paged_feature_matvec(zeta, t, live, page_size=ps)

                    time_plan_iteration(
                        torch, iteration, f"{tag} C={C} r={r} live=50%, two "
                        f"buffers of {fb * C * r / 2**20:.0f} MiB", paged_mod)
                    del xi, zeta
                del copies

    m, r = N, R_ANCHORS
    t = torch.randn((r,), generator=g, device=device)
    log_m32 = torch.randn((m, r), generator=g, device=device)
    for dtype in (torch.float32, torch.bfloat16):
        fb = torch.finfo(dtype).bits // 8
        copies = [log_m32.to(dtype, copy=True) for _ in range(max(1, math.ceil(
            100e6 / (fb * m * r))))]
        cold = [time_ms(torch, cycling(fn, copies)) for fn in (
            lambda lm: log_matvec(lm, t),
            lambda lm: ref.log_matvec_ref(lm, t),
            lambda lm: torch.logsumexp(lm.float() + t[None, :], dim=1))]
        warm = time_ms(torch, lambda: log_matvec(copies[0], t))
        b_ms, b_by = bound(fb * m * r + 4.0 * (r + m), 3.0 * m * r)
        tag = "f32" if dtype == torch.float32 else "bf16"
        row = dict(ms=cold[0], plain_ms=cold[1], library_ms=cold[2],
                   bound_ms=b_ms, bound_by=b_by)
        rows[f"log_matvec/{tag}"] = row
        if tag == "f32":
            rows["log_matvec"] = row
        log(f"  log_matvec             {tag} m={m} r={r}: kernel "
            f"{cold[0]:.4f} ms (L2-warm {warm:.4f})  plain {cold[1]:.4f} ms  "
            f"library {cold[2]:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
            f"kernel/bound {cold[0] / b_ms:.2f}")
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def clouds(np, seed: int):
    """repro.data.synthetic.gaussian_clouds' distribution, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)) + 1.0
    y = math.sqrt(0.1) * rng.standard_normal((M, D))
    return x.astype(np.float32), y.astype(np.float32)


def build_problem(torch, np, seed, device, eps=EPS):
    """A user's request: numpy clouds and anchors, the default device."""
    from repro_torch.core import OTProblem
    x, y = clouds(np, seed)
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    u, _ = anchors_for(torch, np, R_ANCHORS, D, eps, R, seed, "cpu")
    prob = OTProblem.from_point_clouds(x, y, u.numpy(), eps=eps, R=R)
    if prob.a.device != device:
        raise RuntimeError(f"the default device put the request on "
                           f"{prob.a.device}, not {device}")
    return prob


def runners_module():
    """``repro_torch.core.runners``, or None in a checkout from before the
    captured loops (``--src``)."""
    try:
        from repro_torch.core import runners
    except ImportError:
        return None
    return runners


def loop_stats(cache=None):
    """Captures, replays, hits and host reads of a runner cache (default
    the solves' ``RUNNERS``); zeros where the checkout has none."""
    mod = runners_module()
    if cache is None:
        cache = None if mod is None else mod.RUNNERS
    if cache is None:
        return {"runners": 0, "captures": 0, "replays": 0, "hits": 0,
                "reads": 0}
    return cache.stats()


def loop_delta(before, after):
    return {k: after[k] - before[k] for k in ("captures", "replays",
                                               "reads")}


def clear_runners():
    """Drop the solves' runners, so a phase counts its own captures."""
    mod = runners_module()
    if mod is not None:
        mod.RUNNERS.clear()


def eager_loop():
    """A context running every fused-plan solve through the eager host
    loop (one check block, one host read at a time), the graph path's
    yardstick on the same kernels; a checkout from before the captured
    loops runs that loop anyway. Raises where the checkout has runners but
    no such option: the graph path would be held against itself."""
    from repro_torch.core import sinkhorn
    if runners_module() is not None and \
            "graphs" not in getattr(sinkhorn, "_FORCE", {}):
        raise RuntimeError("core.sinkhorn has runners but no "
                           "_FORCE['graphs']: no eager loop to compare with")
    return forced(sinkhorn, "graphs", False)


def run_main_path(torch, np, device):
    """The counted run: three solve() requests and one divergence. Every
    solve's loop replays its cell's captured graph: the first request
    captures one runner a stage eps, the rest (the divergence's three
    terms share the last stage's cell) must capture nothing."""
    from repro_torch.core import EpsSchedule, sinkhorn_divergence_geometry, solve
    from repro_torch.kernels import launch_counts, reset_launch_counts

    schedule = EpsSchedule(eps_init=1.0, decay=0.5)
    problems = [build_problem(torch, np, s, device) for s in SEEDS]
    clear_runners()
    phase0 = loop_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    results, failures, later_captures = [], [], 0
    reset_launch_counts()
    for seed, prob in zip(SEEDS, problems):
        before, loop0 = launch_counts(), loop_stats()
        t0 = time.perf_counter()
        res = solve(prob, schedule=schedule, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after, loop = launch_counts(), loop_delta(loop0, loop_stats())
        delta = {k: after[k] - before[k] for k in after}
        results.append(res)
        if seed != SEEDS[0]:
            later_captures += loop["captures"]
        log(f"  solve seed={seed}: cost={float(res.cost):.7f} "
            f"n_iter={res.n_iter} marginal_err={float(res.marginal_err):.3e} "
            f"wall={wall:.4f} s ({wall / res.n_iter * 1e3:.4f} ms/iteration)"
            f"  loop {loop}  launches={delta}")
    before, loop0 = launch_counts(), loop_stats()
    t0 = time.perf_counter()
    div = sinkhorn_divergence_geometry(problems[0].geometry, tol=TOL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after, loop = launch_counts(), loop_delta(loop0, loop_stats())
    later_captures += loop["captures"]
    delta = {k: after[k] - before[k] for k in after}
    log(f"  divergence seed=0: value={float(div):.7f} wall={wall:.3f} s  "
        f"loop {loop}  launches={delta}")
    counts = launch_counts()
    stats = loop_stats()
    cells = stats["runners"]
    mib = 1 << 20
    log(f"  device memory past the problems: peak "
        f"{(torch.cuda.max_memory_allocated() - base) / mib:.1f} MiB, held "
        f"after {(torch.cuda.memory_allocated() - base) / mib:.1f} MiB "
        f"(runner buffers {stats.get('bytes', 0) / mib:.1f} MiB)")
    stats = loop_delta(phase0, stats)
    ok = (runners_module() is None or
          (later_captures == 0 and stats["captures"] == cells
           == len(EpsSchedule(eps_init=1.0, decay=0.5).stages(EPS))))
    log(f"  solve loops: {stats['captures']} captures for {cells} cells (one "
        f"a stage eps), {later_captures} after the first request; "
        f"{stats['replays']} replays, {stats['reads']} host reads "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("captures after warmup")
    return problems, results, div, counts, failures


KernelRow = collections.namedtuple("KernelRow",
                                   "key count self_device_time_total")


def kernel_rows(torch, prof):
    """The profiler's device rows (kernels, copies, sets) by name, summed
    from its raw events. A CPU-side row (an aten op, the autograd Function
    around a solve) also reports the device time of the kernels it
    launched, so summing every row would count them twice; and building
    the rows of every op (``key_averages``) takes ~40 s for 5 LM steps."""
    cuda = torch.autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            n, us = by_name.get(e.name(), (0, 0.0))
            by_name[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return [KernelRow(k, n, us) for k, (n, us) in by_name.items()]


def profile_solve(torch, problem, schedule):
    """Device busy share of one annealed solve request, through the graph
    loop and through the eager host loop."""
    from repro_torch.core import solve
    profile_call(torch, "solve seed=0 (graph loop)",
                 lambda: solve(problem, schedule=schedule, tol=TOL))
    with eager_loop():
        profile_call(torch, "solve seed=0 (eager host loop)",
                     lambda: solve(problem, schedule=schedule, tol=TOL))


def time_static_copies(torch, device):
    """Device time of what a runner adds to each solve of the main path's
    cell before its replays: the copy of the plan's two (n, r) float32
    factors into the runner's static buffers, beside the copy's bound
    (each byte read once and written once at 3.35 TB/s)."""
    if SLEEP_MS[0] == 0.0:
        calibrate_sleep(torch)
    src = [torch.rand((N, R_ANCHORS), device=device) for _ in range(2)]
    dst = [torch.empty_like(t) for t in src]

    def copy():
        for d, t in zip(dst, src):
            d.copy_(t)

    ms = time_ms(torch, copy)
    nbytes = 2 * 2 * N * R_ANCHORS * 4
    log(f"  static copies of a solve stage (two {N} x {R_ANCHORS} float32 "
        f"factors): {ms:.4f} ms, bound {nbytes / PEAK_BYTES_PER_S * 1e3:.4f}"
        " ms")


def time_replay_blocks(torch, problem, schedule, solves=3):
    """Wall of one annealed request (median of ``solves``) with K, the
    check blocks a replay runs, set to 2, 4, 8 and 16 in place of
    ``sinkhorn._replay_blocks``'s: host reads against the iterations run
    past each stage's stop (the log half-step's launches over 3, less
    n_iter). Each K is a cell of its own, captured by a first solve that
    is not timed."""
    from repro_torch.core import sinkhorn, solve
    from repro_torch.kernels import launch_counts

    if runners_module() is None:
        return
    real = sinkhorn._replay_blocks
    for blocks in (2, 4, 8, 16):
        sinkhorn._replay_blocks = \
            lambda cadence, max_iter, dev, k=blocks: min(
                k, -(-max_iter // cadence))
        try:
            solve(problem, schedule=schedule, tol=TOL)
            walls = []
            for _ in range(solves):
                before, loop0 = launch_counts(), loop_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = solve(problem, schedule=schedule, tol=TOL)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                loop = loop_delta(loop0, loop_stats())
                run = (launch_counts()["log_halfstep"]
                       - before["log_halfstep"]) // 3
        finally:
            sinkhorn._replay_blocks = real
        wall = statistics.median(walls)
        log(f"  K={blocks:2d} blocks a replay: {wall * 1e3:.3f} ms a solve "
            f"({wall / res.n_iter * 1e3:.4f} ms/iteration), n_iter "
            f"{res.n_iter}, iterations run {run} ({run - res.n_iter} past "
            f"the stops), {loop['reads']} host reads, {loop['replays']} "
            "replays")


def time_cache_pressure(torch, np, device, problem, repeats=3, one_off=4):
    """Requests that test the solves' runner cache, on this checkout's
    loop (the parent's through ``--src``): a 9-stage annealed request
    (``EpsSchedule(1.0, 0.75)`` down to eps 0.1, 9 cells), ``repeats``
    times from an empty cache; then ``one_off`` one-stage requests, each
    at an eps no request used before (cells never repeated; the problem's
    set-up not timed); the device memory each part adds at its peak and
    holds after, and what the runners' buffers hold."""
    from repro_torch.core import EpsSchedule, solve

    nine = EpsSchedule(eps_init=1.0, decay=0.75)
    mod = runners_module()
    clear_runners()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in range(repeats):
        loop0 = loop_stats()
        t0 = time.perf_counter()
        res = solve(problem, schedule=nine, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  9-stage request {k}: {wall * 1e3:.3f} ms, n_iter "
            f"{res.n_iter} ({wall / res.n_iter * 1e3:.4f} ms/iteration), "
            f"loop {loop_delta(loop0, loop_stats())}")
    mib = 1 << 20
    held = 0 if mod is None else mod.RUNNERS.nbytes
    log(f"  9-stage requests, device memory past the start: peak "
        f"{(torch.cuda.max_memory_allocated() - base) / mib:.1f} MiB, held "
        f"after {(torch.cuda.memory_allocated() - base) / mib:.1f} MiB "
        f"(runner buffers {held / mib:.1f} MiB, "
        f"{loop_stats()['runners']} runners)")
    for k in range(one_off):
        prob = build_problem(torch, np, 0, device, eps=EPS + 0.01 * (k + 1))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        loop0 = loop_stats()
        t0 = time.perf_counter()
        res = solve(prob, tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"  one-off request eps={prob.eps:.2f}: {wall * 1e3:.3f} ms, "
            f"n_iter {res.n_iter} ({wall / res.n_iter * 1e3:.4f} "
            f"ms/iteration), peak +"
            f"{(torch.cuda.max_memory_allocated() - start) / mib:.1f} MiB, "
            f"loop {loop_delta(loop0, loop_stats())}")
        del prob, res
    clear_runners()


def profile_call(torch, label, fn):
    """Device busy share of one call of ``fn`` (a solve): the device time
    of every kernel the profiler saw over the call's wall time (both under
    the profiler, which slows the host side). Returns the share, or None
    where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(torch, prof)
    device_us = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)
    log(f"  profiled {label}: wall={wall:.4f} s n_iter={res.n_iter} "
        f"device kernel time={device_us / 1e3:.3f} ms")
    if device_us <= 0:
        log("  device busy share: not measured (the profiler saw no device "
            "time)")
        return None
    log(f"  device busy share {device_us / 1e6 / wall:.3f} "
        f"(idle {1 - device_us / 1e6 / wall:.3f}) under the profiler")
    for e in top[:6]:
        log(f"    {e.key[:60]:60s} {e.count:6d} calls "
            f"{e.self_device_time_total / 1e3:9.3f} ms")
    return device_us / 1e6 / wall


def compare_main_path(torch, problems, results, div, schedule_cls):
    """Rerun each request on the kernels and with use_pallas=False; both
    must agree (cost rel <= 1e-4, |d n_iter| <= 1 per stage)."""
    from repro_torch.core import sinkhorn_log_geometry, solve_annealed

    failures = []
    schedule = schedule_cls(eps_init=1.0, decay=0.5)
    for seed, prob, res in zip(SEEDS, problems, results):
        loop0 = loop_stats()
        t0 = time.perf_counter()
        k = solve_annealed(prob, schedule=schedule, tol=TOL)
        torch.cuda.synchronize()
        wall_k = time.perf_counter() - t0
        loop = loop_delta(loop0, loop_stats())
        with eager_loop():
            t0 = time.perf_counter()
            e = solve_annealed(prob, schedule=schedule, tol=TOL)
            torch.cuda.synchronize()
            wall_e = time.perf_counter() - t0
        # the same kernels in the same order on the same inputs: the graph
        # replays give the eager loop's iterations and its potentials bit
        # for bit
        same_e = (k.stage_iters == e.stage_iters
                  and torch.equal(k.result.f, e.result.f)
                  and torch.equal(k.result.g, e.result.g))
        it = k.result.n_iter
        log(f"  seed={seed}: graph loop {wall_k * 1e3:.3f} ms "
            f"({wall_k / it * 1e3:.4f} ms/iteration, loop {loop}), eager "
            f"host loop {wall_e * 1e3:.3f} ms ({wall_e / it * 1e3:.4f} "
            f"ms/iteration); stage_iters {k.stage_iters} / "
            f"{e.stage_iters}, potentials bit-identical {same_e} "
            f"{'ok' if same_e and loop['captures'] == 0 else 'FAIL'}")
        if not same_e or loop["captures"] != 0:
            failures.append(f"graph loop against the eager loop seed={seed}")
        p = solve_annealed(prob, schedule=schedule, tol=TOL,
                           use_pallas=False)
        rel = abs(float(k.result.cost) - float(p.result.cost)) / \
            abs(float(p.result.cost))
        d_iter = [a - b for a, b in zip(k.stage_iters, p.stage_iters)]
        same = float(k.result.cost) == float(res.cost)
        finite = bool(torch.isfinite(k.result.f).any()) and \
            math.isfinite(float(k.result.cost))
        ok = rel <= COST_RTOL and all(abs(v) <= 1 for v in d_iter) \
            and same and finite
        log(f"  seed={seed}: plain cost={float(p.result.cost):.7f} "
            f"rel_diff={rel:.3e} stage_iters kernel={k.stage_iters} "
            f"plain={p.stage_iters} repeat_identical={same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"solve seed={seed}")
    geom = problems[0].geometry
    n, m = geom.shape
    a = torch.full((n,), 1.0 / n, device=geom.device)
    b = torch.full((m,), 1.0 / m, device=geom.device)
    terms = {}
    for label, g_, w1, w2 in (("xy", geom, a, b), ("xx", geom.xx(), a, a),
                              ("yy", geom.yy(), b, b)):
        k = sinkhorn_log_geometry(g_, w1, w2, tol=TOL)
        p = sinkhorn_log_geometry(g_, w1, w2, tol=TOL, use_pallas=False)
        rel = abs(float(k.cost) - float(p.cost)) / abs(float(p.cost))
        ok = rel <= COST_RTOL and abs(k.n_iter - p.n_iter) <= 1
        terms[label] = (float(k.cost), float(p.cost))
        log(f"  divergence term {label}: kernel cost={float(k.cost):.7f} "
            f"n_iter={k.n_iter}  plain cost={float(p.cost):.7f} "
            f"n_iter={p.n_iter}  rel_diff={rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"divergence term {label}")
    w_k = terms["xy"][0] - 0.5 * (terms["xx"][0] + terms["yy"][0])
    w_p = terms["xy"][1] - 0.5 * (terms["xx"][1] + terms["yy"][1])
    scale = max(abs(v) for pair in terms.values() for v in pair)
    ok = abs(float(div) - w_k) <= 1e-6 * scale and \
        abs(w_k - w_p) <= COST_RTOL * scale
    log(f"  divergence: entry point {float(div):.7f}, kernel terms {w_k:.7f},"
        f" plain terms {w_p:.7f} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("divergence")
    return failures


# ---------------------------------------------------------------------------
# Phase 5: the training path
# ---------------------------------------------------------------------------


def counts_delta(before, after):
    return {k: after[k] - before[k] for k in after}


def run_trainer(torch, device="cuda"):
    """The OT-GAN trainer's own entry point at its default configuration
    (8-mode ring, batch 256, r = 128, eps 0.5, 40 iterations, n_c = 3),
    ``--strict``."""
    from repro_torch.examples import ot_gan
    return ot_gan.main(["--steps", str(GAN_STEPS), "--device", str(device),
                        "--strict"])


def trainer_step0(torch, device):
    """The strict run's first step: its initial weights and its first data
    and z, drawn as ``ot_gan.main`` draws them (weights from a CPU generator
    seeded 0, data then z from a device generator seeded 1)."""
    from repro_torch.examples import ot_gan
    model = ot_gan.OTGAN.init(2, 128, torch.Generator().manual_seed(0),
                              device)
    gen = torch.Generator(device=device).manual_seed(1)
    data = ot_gan.make_data(gen, GAN_BATCH)
    z = torch.randn((GAN_BATCH, ot_gan.LATENT_Z), generator=gen, device=device)
    return model, z, data


def step_summary(out):
    """Median ms of adversary and generator steps after the first cycle."""
    adv = [t for t, a in zip(out["step_ms"][4:], out["adv"][4:]) if a]
    gen = [t for t, a in zip(out["step_ms"][4:], out["adv"][4:]) if not a]
    return statistics.median(adv), statistics.median(gen)


def profile_train_steps(torch, device):
    """Busy share of one adversary step and one generator step at the
    default configuration under torch.profiler, with the kernel device time
    by name: through the graph loop, then through the eager host loop."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ExecutionPolicy, OTObjective
    from repro_torch.examples import ot_gan

    model = ot_gan.OTGAN.init(2, 128, torch.Generator().manual_seed(0),
                              device)
    gen = torch.Generator(device=device).manual_seed(1)
    obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40,
                      policy=ExecutionPolicy.training())
    batches = [(ot_gan.make_data(gen, GAN_BATCH),
                torch.randn((GAN_BATCH, ot_gan.LATENT_Z), generator=gen,
                            device=device)) for _ in range(3)]
    ot_gan.train_step(model, batches[0][1], batches[0][0], obj, adv=True)
    torch.cuda.synchronize()
    for ((data, z), adv), graphs in zip(
            [(b, a) for b, a in zip(batches[1:], (True, False))] * 2,
            (True, True, False, False)):
        with (contextlib.nullcontext() if graphs else eager_loop()), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            d, _ = ot_gan.train_step(model, z, data, obj, adv=adv)
            float(d)
            wall = time.perf_counter() - t0
        rows = kernel_rows(torch, prof)
        dev_us = sum(e.self_device_time_total for e in rows)
        kind = ("adversary" if adv else "generator") + \
            (" (graph loop)" if graphs else " (eager host loop)")
        if dev_us <= 0:
            log(f"  profiled {kind} step: wall {wall * 1e3:.3f} ms; busy share"
                " not measured (the profiler saw no device time)")
            continue
        log(f"  profiled {kind} step: wall {wall * 1e3:.3f} ms, device "
            f"kernel time {dev_us / 1e3:.3f} ms, busy share "
            f"{dev_us / 1e3 / (wall * 1e3):.3f} under the profiler")
        top = sorted(rows, key=lambda e: -e.self_device_time_total)
        log(f"    {len(rows)} kernels by name, {sum(e.count for e in rows)} "
            "launches")
        for e in top[:6]:
            log(f"    {e.key[:60]:60s} {e.count:6d} calls "
                f"{e.self_device_time_total / 1e3:9.3f} ms")


def compare_step_plans(torch, device, steps=24):
    """ms per trainer step at the default configuration with the auto
    cadence (the megakernel, 8 iterations a launch) through the graph loop
    and through the eager host loop, and the streaming per-iteration plan
    (inner_steps=1) through the graph loop, on the same data, in the order
    graph, eager, streaming, streaming, eager, graph, each from fresh
    weights."""
    from repro_torch.core import ExecutionPolicy, OTObjective
    from repro_torch.examples import ot_gan

    gen = torch.Generator(device=device).manual_seed(2)
    batches = [(ot_gan.make_data(gen, GAN_BATCH),
                torch.randn((GAN_BATCH, ot_gan.LATENT_Z), generator=gen,
                            device=device)) for _ in range(steps)]
    out = {}
    for label in ("megakernel", "megakernel eager", "streaming", "streaming",
                  "megakernel eager", "megakernel"):
        policy = ExecutionPolicy.training(
            inner_steps=1 if label == "streaming" else None)
        obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40, policy=policy)
        model = ot_gan.OTGAN.init(2, 128, torch.Generator().manual_seed(0),
                                  device)
        loop = eager_loop() if "eager" in label else contextlib.nullcontext()
        with loop:
            ot_gan.train_step(model, batches[0][1], batches[0][0], obj,
                              adv=True)
            torch.cuda.synchronize()
            times = []
            for k, (data, z) in enumerate(batches):
                t0 = time.perf_counter()
                d, _ = ot_gan.train_step(model, z, data, obj, adv=k % 4 != 3)
                float(d)                # as the trainer reads each step's
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
        out.setdefault(label, []).append(ms)
        log(f"  {label:16s} plan: {ms:.3f} ms per trainer step (median of "
            f"{steps}, 3 adversary : 1 generator; mean "
            f"{statistics.mean(times):.3f})")
    return out


def gan_gradient(torch, device, *, batch, r, eps, iters, use_pallas, seed=0):
    """bench_gan's training-step gradient: Wbar of the Gaussian geometry of
    a generator output against data (d = 8, N(0, 1)/2 against
    (N(0, 1) + 0.5)/2, R = 3) and learnable anchors, under the training
    policy, with its gradients in the generator output and the anchors."""
    from repro_torch.core import (
        ExecutionPolicy,
        GaussianFeatureMap,
        OTObjective,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    gen = (0.5 * torch.randn((batch, D), generator=g, device=device))
    dat = 0.5 * (torch.randn((batch, D), generator=g, device=device) + 0.5)
    anchors = GaussianFeatureMap(r=r, d=D, eps=eps, R=3.0).init(g)
    gen.requires_grad_(True)
    anchors.requires_grad_(True)
    obj = OTObjective(eps=eps, tol=0.0, max_iter=iters,
                      policy=ExecutionPolicy.training(use_pallas=use_pallas))

    def once():
        geom = obj.gaussian(gen, dat, anchors, R=3.0)
        w = obj.divergence(geom)
        gg, ga = torch.autograd.grad(w, [gen, anchors])
        return w.detach(), gg, ga

    return once


def grads_agree(pairs, rel=GRAD_REL_TOL):
    """Max abs difference of each gradient pair over its max |grad|."""
    worst = 0.0
    for got, want in pairs:
        scale = float(want.abs().max())
        worst = max(worst, float((got - want).abs().max()) / scale)
    return worst, worst <= rel


def run_training_path(torch, np, device):
    """Phase 5: the trainer's --strict run, its profile, the batch-2048
    gradient, and the comparison of both with use_pallas=False. Returns
    (launch counts of the counted runs, failures)."""
    from repro_torch.core import ExecutionPolicy, OTObjective
    from repro_torch.examples import ot_gan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    failures = []
    clear_runners()
    reset_launch_counts()
    loop0 = loop_stats()
    t0 = time.perf_counter()
    out_k = run_trainer(torch, device=device)
    wall = time.perf_counter() - t0
    loop = loop_delta(loop0, loop_stats())
    counts_train = launch_counts()
    adv_ms, gen_ms = step_summary(out_k)
    per_step = 3 * math.ceil(40 / 8)
    warm = out_k.get("warmup_launches", 0)
    log(f"  trainer --strict: {GAN_STEPS} steps in {wall:.3f} s; median "
        f"{adv_ms:.3f} ms per adversary step, {gen_ms:.3f} ms per generator "
        f"step; Wbar {out_k['divergences'][0]:.5f} -> "
        f"{out_k['divergences'][-1]:.5f}; launches {counts_train} "
        f"({sum(out_k['block_launches']) / GAN_STEPS:.1f} megakernel "
        f"launches a step, expected {per_step}; {warm} in the warm-up)")
    if counts_train["log_sinkhorn_block"] != per_step * GAN_STEPS + warm:
        failures.append("trainer megakernel launches")
    # the warm-up's 3 solves: one capture and one read each
    log(f"  trainer solve loops: {loop['captures']} captures (the warm-up), "
        f"{out_k.get('captures', 0)} after it; {loop['replays']} replays and "
        f"{loop['reads']} host reads, {(loop['reads'] - 3) / GAN_STEPS:.2f} a "
        f"step after the warm-up (the eager host loop: "
        f"{3 * math.ceil(40 / 8)} a step)")
    if runners_module() is not None and (out_k["captures"] != 0
                                         or loop["captures"] != 1):
        failures.append("trainer captures after warmup")
    first, z, data = trainer_step0(torch, device)
    obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40,
                      policy=ExecutionPolicy.training())
    with torch.no_grad():
        d_graph, _ = ot_gan.gan_losses(first, z, data, obj)
        with eager_loop():
            d_eager, _ = ot_gan.gan_losses(first, z, data, obj)
    same = float(d_graph) == float(d_eager)
    log(f"  trainer step-0 Wbar through the graph loop {float(d_graph):.9f}, "
        f"the eager host loop {float(d_eager):.9f}: bit-identical {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        failures.append("trainer graph loop against the eager loop")

    once = gan_gradient(torch, device, batch=GAN_BIG_BATCH, r=128, eps=2.0,
                        iters=30, use_pallas=None)
    before = launch_counts()
    w_k, gg_k, ga_k = once()
    torch.cuda.synchronize()
    delta = counts_delta(before, launch_counts())
    counts = launch_counts()
    log(f"  batch {GAN_BIG_BATCH} gradient (d={D}, r=128, eps=2, 30 "
        f"iterations): Wbar {float(w_k):.7f}, launches {delta}")
    if delta["log_sinkhorn_block"] != 0 or delta["log_halfstep"] <= 0 \
            or delta["log_feature_contract"] <= 0:
        failures.append("batch-2048 gradient did not take the streaming plan")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"  batch {GAN_BIG_BATCH} gradient: median {statistics.median(times):.3f}"
        f" ms over 5 (value and both gradients)")

    log("  -- the same with use_pallas=False (the plain torch operators), "
        "from the same weights: a second trainer run would update its own "
        "weights, and 60 adversarial steps amplify last-bit differences")
    first, z, data = trainer_step0(torch, device)
    for label, model in (("step-0", first),
                         (f"trained {GAN_STEPS} steps", out_k["model"])):
        res = {}
        for plain in (False, True):
            obj = OTObjective(eps=ot_gan.EPS, tol=0.0, max_iter=40,
                              policy=ExecutionPolicy.training(
                                  use_pallas=False if plain else None))
            d, _ = ot_gan.gan_losses(model, z, data, obj)
            res[plain] = (d.detach(),
                          torch.autograd.grad(d, list(model.parameters())))
        w_rel = abs(float(res[False][0]) - float(res[True][0])) / \
            abs(float(res[True][0]))
        g_rel, g_ok = grads_agree(zip(res[False][1], res[True][1]))
        ok = w_rel <= COST_RTOL and g_ok
        if model is first:
            # the strict run's own step-0 Wbar against the plain operators
            w0 = out_k["divergences"][0]
            run_rel = abs(w0 - float(res[True][0])) / abs(float(res[True][0]))
            ok = ok and run_rel <= COST_RTOL
            log(f"  trainer --strict step-0 Wbar {w0:.7f}, plain rel diff "
                f"{run_rel:.3e}")
        log(f"  trainer gradient, {label} weights (all parameters): Wbar "
            f"{float(res[False][0]):.7f} rel diff {w_rel:.3e}, gradients max "
            f"diff / max |grad| {g_rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"trainer gradient ({label}) against "
                            "use_pallas=False")

    once_p = gan_gradient(torch, device, batch=GAN_BIG_BATCH, r=128, eps=2.0,
                          iters=30, use_pallas=False)
    w_p, gg_p, ga_p = once_p()
    w_rel = abs(float(w_k) - float(w_p)) / abs(float(w_p))
    g_rel, g_ok = grads_agree([(gg_k, gg_p), (ga_k, ga_p)])
    ok = w_rel <= COST_RTOL and g_ok
    log(f"  batch {GAN_BIG_BATCH} gradient plain: Wbar {float(w_p):.7f} rel "
        f"diff {w_rel:.3e}, gradients max diff / max |grad| {g_rel:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("batch-2048 gradient against use_pallas=False")
    profile_train_steps(torch, device)
    compare_step_plans(torch, device)
    return counts, failures


# ---------------------------------------------------------------------------
# Phase 6: the scaling path
# ---------------------------------------------------------------------------


def scaling_inputs(torch, np, device):
    """Phase 6's requests, built before the counted run: the explicit
    feature problems (r = 1024 and 256), the clouds of phase 4 at eps 1.0,
    the OT-GAN-batch geometry and the divergence's leaves."""
    from repro_torch.core import FactoredPositive, OTProblem
    feats = {r: OTProblem.from_features(explicit_features(np, N, r, 2 * r),
                                        explicit_features(np, M, r, 2 * r + 1),
                                        eps=SCALING_EPS)
             for r in (R_ANCHORS, 256)}
    clouds_ = []
    for seed in SEEDS:
        prob = build_problem(torch, np, seed, device)
        clouds_.append(OTProblem(prob.geometry.rebuild_at(1.0), prob.a,
                                 prob.b))
    gan = FactoredPositive(
        xi=torch.as_tensor(explicit_features(np, GAN_BATCH, 128, 5),
                           device=device),
        zeta=torch.as_tensor(explicit_features(np, GAN_BATCH, 128, 6),
                             device=device),
        eps=SCALING_EPS)
    n_div, r_div = 4096, 256
    leaves = [torch.as_tensor(explicit_features(np, n_div, r_div, s),
                              device=device) for s in (8, 9)]
    leaves += [torch.full((n_div,), 1.0 / n_div, device=device)
               for _ in range(2)]
    return feats, clouds_, gan, leaves


def scaling_objective(policy_kw=None):
    from repro_torch.core import ExecutionPolicy, OTObjective
    return OTObjective(eps=SCALING_EPS, tol=0.0, max_iter=40,
                       policy=ExecutionPolicy.training(**(policy_kw or {})))


def scaling_divergence(torch, leaves):
    """The scaling divergence and its gradients in all four tensors."""
    from repro_torch.core import sinkhorn_divergence_features
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    w = sinkhorn_divergence_features(*leaves, eps=SCALING_EPS, tol=0.0,
                                     max_iter=SCALING_ITERS)
    return w.detach(), torch.autograd.grad(w, leaves)


def run_scaling_path(torch, np, device):
    """The counted run of phase 6: four feature solves, three cloud solves,
    one objective solve and one divergence with its gradient, with the
    launch counters set to 0 just before and read just after."""
    from repro_torch.core import solve
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import observe_plan_selection

    feats, clouds_, gan, leaves = scaling_inputs(torch, np, device)
    clear_runners()
    phase0 = loop_stats()
    torch.cuda.synchronize()
    out = {"feats": {}, "clouds": []}
    failures = []
    reset_launch_counts()
    for r, prob in feats.items():
        for precision in ("highest", "bf16"):
            before, loop0 = launch_counts(), loop_stats()
            with observe_plan_selection() as events:
                t0 = time.perf_counter()
                res = solve(prob, tol=0.0, max_iter=SCALING_ITERS,
                            precision=precision)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            modes = [(e["mode"], e["kind"]) for e in events]
            if modes != [("scaling", "factored")]:
                failures.append(f"auto method on features r={r}: {modes}")
            out["feats"][(r, precision)] = res
            log(f"  features n=m={N} r={r} {precision}: cost="
                f"{float(res.cost):.7f} n_iter={res.n_iter} wall={wall:.4f} s"
                f" ({wall / res.n_iter * 1e3:.4f} ms/iteration) plan={modes}"
                f" loop {loop_delta(loop0, loop_stats())}"
                f" launches={counts_delta(before, launch_counts())}")
    for seed, prob in zip(SEEDS, clouds_):
        before, loop0 = launch_counts(), loop_stats()
        t0 = time.perf_counter()
        res = solve(prob, method="factored", tol=TOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["clouds"].append(res)
        dead_rows = sum(int((w.sum(1) == 0).sum()) for w in
                        prob.geometry.features())
        log(f"  clouds seed={seed} eps=1.0 method=factored: cost="
            f"{float(res.cost):.7f} n_iter={res.n_iter} marginal_err="
            f"{float(res.marginal_err):.3e} wall={wall:.4f} s "
            f"({wall / res.n_iter * 1e3:.4f} ms/iteration); feature rows "
            f"that underflow to 0: {dead_rows}; loop "
            f"{loop_delta(loop0, loop_stats())} launches="
            f"{counts_delta(before, launch_counts())}")
    before, loop0 = launch_counts(), loop_stats()
    obj = scaling_objective()
    t0 = time.perf_counter()
    out["gan"] = obj.solve(gan, *obj.uniform_weights(gan))
    torch.cuda.synchronize()
    delta = counts_delta(before, launch_counts())
    loop = loop_delta(loop0, loop_stats())
    log(f"  OTObjective.solve n=m={GAN_BATCH} r=128 bf16 40 iterations: cost="
        f"{float(out['gan'].cost):.7f} wall={time.perf_counter() - t0:.4f} s "
        f"loop {loop} launches={delta}")
    # the first solve of the cell: its warm-up block, then 5 a replay
    if delta["sinkhorn_block"] != 40 // 8 + min(loop["captures"], 1):
        failures.append("objective solve did not take the megakernel 5 times")
    before, loop0 = launch_counts(), loop_stats()
    t0 = time.perf_counter()
    out["div"] = scaling_divergence(torch, leaves)
    torch.cuda.synchronize()
    log(f"  scaling divergence n=m=4096 r=256: value "
        f"{float(out['div'][0]):.7f} wall={time.perf_counter() - t0:.4f} s "
        f"(value and 4 gradients) loop {loop_delta(loop0, loop_stats())} "
        f"launches={counts_delta(before, launch_counts())}")
    counts = launch_counts()
    missing = [k for k in SCALING_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    stats = loop_stats()
    cells = stats["runners"]
    stats = loop_delta(phase0, stats)
    # four feature cells, the clouds', the objective's, the divergence's
    # (its three terms share one)
    ok = runners_module() is None or stats["captures"] == cells == 7
    log(f"  solve loops: {stats['captures']} captures for {cells} cells, "
        f"{stats['replays']} replays, {stats['reads']} host reads "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("captures against cells")
    return (feats, clouds_, gan, leaves), out, counts, failures


def compare_scaling_path(torch, inputs, out):
    """Each request of the counted run against use_pallas=False (and the
    clouds against method="log_factored", the divergence against the CPU);
    a profile of one feature solve; the objective's megakernel plan against
    its streaming plan."""
    from repro_torch.core import rot_factored, solve

    feats, clouds_, gan, leaves = inputs
    failures = []

    def check(label, ok):
        log(f"  {label} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(label.split(":")[0])

    for (r, precision), res in out["feats"].items():
        loop0 = loop_stats()
        t0 = time.perf_counter()
        g = solve(feats[r], tol=0.0, max_iter=SCALING_ITERS,
                  precision=precision)
        torch.cuda.synchronize()
        wall_g = time.perf_counter() - t0
        loop = loop_delta(loop0, loop_stats())
        with eager_loop():
            t0 = time.perf_counter()
            e = solve(feats[r], tol=0.0, max_iter=SCALING_ITERS,
                      precision=precision)
            torch.cuda.synchronize()
            wall_e = time.perf_counter() - t0
        check(f"features r={r} {precision}: graph loop again "
              f"{wall_g / g.n_iter * 1e3:.4f} ms/iteration (loop {loop}), "
              f"eager host loop {wall_e / e.n_iter * 1e3:.4f} ms/iteration; "
              f"n_iter {g.n_iter}/{e.n_iter}, u and v bit-identical to the "
              "eager loop's and the counted run's",
              loop["captures"] == 0 and g.n_iter == e.n_iter == res.n_iter
              and all(torch.equal(x, y) for x, y in
                      ((g.u, e.u), (g.v, e.v), (res.u, e.u), (res.v, e.v))))
        p = solve(feats[r], tol=0.0, max_iter=SCALING_ITERS,
                  precision=precision, use_pallas=False)
        rel = abs(float(res.cost) - float(p.cost)) / abs(float(p.cost))
        eu, oku = compare(torch, res.u, p.u, rel_to_max=COST_RTOL)
        ev, okv = compare(torch, res.v, p.v, rel_to_max=COST_RTOL)
        check(f"features r={r} {precision}: plain cost={float(p.cost):.7f} "
              f"rel_diff={rel:.3e} u err={eu:.3e} v err={ev:.3e} n_iter "
              f"{res.n_iter}/{p.n_iter}",
              rel <= COST_RTOL and oku and okv and res.n_iter == p.n_iter)
    prob = feats[R_ANCHORS]
    profile_call(torch, f"feature solve r={R_ANCHORS} f32 (graph loop)",
                 lambda: solve(prob, tol=0.0, max_iter=SCALING_ITERS))
    with eager_loop():
        profile_call(torch, f"feature solve r={R_ANCHORS} f32 (eager host "
                     "loop)",
                     lambda: solve(prob, tol=0.0, max_iter=SCALING_ITERS))
    for seed, prob, res in zip(SEEDS, clouds_, out["clouds"]):
        with eager_loop():
            e = solve(prob, method="factored", tol=TOL)
        check(f"clouds seed={seed}: eager host loop n_iter {e.n_iter}, u "
              "and v bit-identical to the graph loop's",
              e.n_iter == res.n_iter and torch.equal(e.u, res.u)
              and torch.equal(e.v, res.v))
        p = solve(prob, method="factored", tol=TOL, use_pallas=False)
        lg = solve(prob, method="log_factored", tol=TOL)
        rel = abs(float(res.cost) - float(p.cost)) / abs(float(p.cost))
        rel_log = abs(float(res.cost) - float(lg.cost)) / abs(float(lg.cost))
        check(f"clouds seed={seed}: plain cost={float(p.cost):.7f} n_iter="
              f"{p.n_iter} rel_diff={rel:.3e}; log_factored cost="
              f"{float(lg.cost):.7f} n_iter={lg.n_iter} rel_diff="
              f"{rel_log:.3e}",
              rel <= COST_RTOL and abs(res.n_iter - p.n_iter) <= 1
              and rel_log <= COST_RTOL)
    obj = scaling_objective()
    with eager_loop():
        e = obj.solve(gan, *obj.uniform_weights(gan))
    check(f"objective solve: eager host loop n_iter {e.n_iter}, u and v "
          "bit-identical to the graph loop's",
          e.n_iter == out["gan"].n_iter and torch.equal(e.u, out["gan"].u)
          and torch.equal(e.v, out["gan"].v))
    obj = scaling_objective({"use_pallas": False})
    p = obj.solve(gan, *obj.uniform_weights(gan))
    rel = abs(float(out["gan"].cost) - float(p.cost)) / abs(float(p.cost))
    check(f"objective solve: plain cost={float(p.cost):.7f} rel_diff="
          f"{rel:.3e}", rel <= COST_RTOL)
    cpu = [x.cpu() for x in leaves]
    w_c, g_c = scaling_divergence(torch, cpu)
    w_k, g_k = out["div"]
    # W̄ of two samples of one distribution is far smaller than its three
    # terms, so it is held, as phase 4 holds its divergence, relative to
    # the largest term
    xs, zs, a_, b_ = cpu
    terms = [float(rot_factored(p_, q_, w1, w2, SCALING_EPS, 0.0,
                                SCALING_ITERS))
             for p_, q_, w1, w2 in ((xs, zs, a_, b_), (xs, xs, a_, a_),
                                    (zs, zs, b_, b_))]
    scale = max(abs(v) for v in terms)
    w_rel = abs(float(w_k) - float(w_c)) / scale
    g_rel, g_ok = grads_agree(zip((g.cpu() for g in g_k), g_c))
    check(f"scaling divergence: CPU value {float(w_c):.9f} (terms "
          f"{terms[0]:.7f}, {terms[1]:.7f}, {terms[2]:.7f}), diff / largest "
          f"term {w_rel:.3e}, gradients max diff / max |grad| {g_rel:.3e}",
          w_rel <= COST_RTOL and g_ok)
    compare_objective_plans(torch, gan)
    return failures


def compare_objective_plans(torch, gan, solves=10):
    """ms per OTObjective.solve at the OT-GAN batch with the auto cadence
    (the scaling megakernel, 8 iterations a launch) through the graph loop
    and the eager host loop, against the streaming plan (inner_steps=1),
    in the order graph, eager, streaming, streaming, eager, graph."""
    for label in ("megakernel", "megakernel eager", "streaming",
                  "streaming", "megakernel eager", "megakernel"):
        obj = scaling_objective(
            {"inner_steps": 1 if label == "streaming" else None})
        a, b = obj.uniform_weights(gan)
        loop = eager_loop() if "eager" in label else contextlib.nullcontext()
        with loop:
            obj.solve(gan, a, b)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(solves):
                res = obj.solve(gan, a, b)
            float(res.cost)
            ms = (time.perf_counter() - t0) * 1e3 / solves
        log(f"  {label:16s} plan: {ms:.4f} ms per objective solve (mean of "
            f"{solves})")


# ---------------------------------------------------------------------------
# Phase 7: the streaming path
# ---------------------------------------------------------------------------


def stream_points(np, rng, k, side):
    """k points of one side's cloud: bench_stream's 0.5 N(0, I_2), shifted
    by 0.3 on the y side."""
    pts = 0.5 * rng.standard_normal((k, STREAM_D))
    return (pts + (STREAM_SHIFT if side == "y" else 0.0)).astype(np.float32)


def stream_mutation(np, rng, live_ids, side, tag):
    """Evict STREAM_DELTA random ids of ``live_ids`` (one side) and insert
    as many new points of that side's cloud. The evicted ids leave
    ``live_ids``; the new ones are returned for the caller to add once
    they are in the store (a flush applies every eviction of its batch
    before any insertion)."""
    drop = rng.choice(len(live_ids), STREAM_DELTA, replace=False)
    gone = [live_ids[i] for i in drop]
    keep = np.ones(len(live_ids), bool)
    keep[drop] = False
    live_ids[:] = [i for i, k in zip(live_ids, keep) if k]
    new = [(side, tag, i) for i in range(STREAM_DELTA)]
    return gone, dict(ids=new, points=stream_points(np, rng, STREAM_DELTA,
                                                    side),
                      weights=np.ones(STREAM_DELTA, np.float32))


def stream_state(np, pair, saved):
    """What a solve started from, on the host: each side's feature buffer,
    weights, live mask and page table, and the start potentials as
    ``StreamingSolver._solve`` prepares them (no bucket is crossed here;
    ``saved`` is None for a cold solve)."""
    from repro_torch.streaming.solver import _prep_init
    state = {}
    for side, pot in zip(("x", "y"), saved):
        st = getattr(pair, side).store
        live = st.live_mask()
        state[side] = dict(feats=st._feats.copy(), weights=st.weights_host(),
                           live=live, page_live=st.page_live,
                           f0=_prep_init(pot, live, None, st.capacity)[0])
    return state


def drive_stream(torch, np, device, method, precision, seed):
    """One run of phase 7's traffic through the entry points a user calls:
    two ``from_points`` stores of N live points (capacity 32768: half the
    pages dead; the bf16 run reads bf16 device buffers) behind a
    StreamingOTService (max_batch 4), warmup, a cold solve, 8 submitted
    mutations drained as 2 coalesced warm re-solves, then 2 direct
    StreamingSolver.update calls. Each solve's result, wall (mutation,
    flush and re-solve, ending in a synchronise) and start state are kept
    for the comparisons, which run after the counted traffic."""
    from repro_torch.core import GaussianFeatureMap
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ops import observe_plan_selection
    from repro_torch.serving import StreamingOTService
    from repro_torch.streaming import StreamingDistribution, StreamingSolver

    rng = np.random.default_rng(seed)
    live_ids = {side: [(side, i) for i in range(N)] for side in "xy"}
    pts = {side: stream_points(np, rng, N, side) for side in "xy"}
    R = float(np.max(np.linalg.norm(np.concatenate(list(pts.values())),
                                    axis=1)))
    fm = GaussianFeatureMap(r=R_ANCHORS, d=STREAM_D, eps=STREAM_EPS, R=R)
    anchors = (math.sqrt(fm.sigma2) * rng.standard_normal(
        (R_ANCHORS, STREAM_D))).astype(np.float32)
    sides = [StreamingDistribution.from_points(
        live_ids[side], pts[side], np.ones(N, np.float32), anchors,
        eps=STREAM_EPS, q=fm.q, page_size=STREAM_PAGE) for side in "xy"]
    solver = StreamingSolver(method=method, tol=TOL, precision=precision)
    svc = StreamingOTService(solver=solver, max_batch=4, max_wait=1.0,
                             clock=lambda: 0.0)
    records, mark, label = [], [0.0], ["coalesced flush"]
    real_re_solve = solver.re_solve

    def recorded(pair_):
        saved = (pair_.f, pair_.g)
        res = real_re_solve(pair_)
        torch.cuda.synchronize()
        wall = time.perf_counter() - mark[0]
        records.append(dict(label=label[0], res=res, wall=wall,
                            state=stream_state(np, pair_, saved)))
        mark[0] = time.perf_counter()
        return res

    before = launch_counts()
    with observe_plan_selection() as events:
        t0 = time.perf_counter()
        pair = svc.register("stream", *sides)
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        traces_warm = getattr(solver, "traces", 0)
        loop0 = loop_stats(getattr(solver, "_runners", None))
        state = stream_state(np, pair, (None, None))
        t0 = time.perf_counter()
        res = solver.cold_solve(pair)
        torch.cuda.synchronize()
        records.append(dict(label="cold solve", res=res, state=state,
                            wall=time.perf_counter() - t0))
        solver.re_solve = recorded
        batch = []
        for k in range(STREAM_MUTATIONS):
            if k % svc.queue.max_batch == 0:    # the previous flush's inserts
                for _, add in batch:
                    live_ids[add["ids"][0][0]] += add["ids"]
                batch = []
            gx, ax = stream_mutation(np, rng, live_ids["x"], "x", k)
            gy, ay = stream_mutation(np, rng, live_ids["y"], "y", k)
            batch += [(gx, ax), (gy, ay)]
            svc.submit_update("stream", remove_x=gx, add_x=ax, remove_y=gy,
                              add_y=ay)
        for _, add in batch:
            live_ids[add["ids"][0][0]] += add["ids"]
        mark[0] = time.perf_counter()
        resolved = svc.pump() + svc.drain()
        label[0] = "direct update"
        for k in range(2):
            gx, ax = stream_mutation(np, rng, live_ids["x"], "x", f"u{k}")
            gy, ay = stream_mutation(np, rng, live_ids["y"], "y", f"u{k}")
            live_ids["x"] += ax["ids"]
            live_ids["y"] += ay["ids"]
            mark[0] = time.perf_counter()
            solver.update(pair, remove_x=gx, add_x=ax, remove_y=gy,
                          add_y=ay)
    solver.re_solve = real_re_solve
    delta = counts_delta(before, launch_counts())
    loop = loop_delta(loop0, loop_stats(getattr(solver, "_runners", None)))
    stats = svc.stats()
    log(f"  {method} {precision}: warmup {warmup_s:.3f} s; {resolved} "
        f"mutations in {stats['solves']} flushes (coalesce ratio "
        f"{stats['coalesce_ratio']:.1f}); pages live "
        f"{pair.x.store.stats()['live_pages']}/{pair.x.store.n_pages}; "
        f"launches {delta}")
    log(f"  {method} {precision} solve loops: traces {traces_warm} after the "
        f"warmup, {getattr(solver, 'traces', 0)} after "
        f"{len(records)} solves; {loop['replays']} replays and "
        f"{loop['reads']} host reads over them "
        f"({loop['reads'] / len(records):.1f} a solve)")
    return dict(method=method, precision=precision, solver=solver,
                pair=pair, records=records, delta=delta,
                events=[(e["mode"], e["kind"]) for e in events],
                resolved=resolved, solves=stats["solves"],
                traces=(traces_warm, getattr(solver, "traces", 0)),
                loop=loop)


def compare_stream(torch, np, device, run):
    """Each solve of a run against the same solver with use_pallas=False
    from the same start state (cost 1e-4 relative, |d n_iter| <= 1, f and g
    on live slots within 1e-4 of max |f| or |g|) and against a cold
    ``solve(method="factored")`` on the compact live support, built from
    host arrays as a caller without the streaming layer would (cost 1e-4
    relative; its wall is the cold pipeline's). Then the path checks and
    a profile of one more update."""
    from repro_torch.core import OTProblem, solve
    from repro_torch.streaming.solver import run_paged

    method, precision = run["method"], run["precision"]
    failures = []
    solver, pair = run["solver"], run["pair"]
    warm_iters = cold_iters = 0
    graph_ms, eager_ms, eager_ok = [], [], True
    runners = ({"runners": solver._runners} if hasattr(solver, "_runners")
               else {})
    for rec in run["records"]:
        st, res = rec["state"], rec["res"]
        args = ([torch.as_tensor(st[s]["feats"], device=device)
                 for s in "xy"]
                + [st[s][k] for k in ("page_live", "weights", "f0")
                   for s in "xy"])
        kw = dict(page_size=STREAM_PAGE, eps=STREAM_EPS, method=method,
                  tol=TOL, max_iter=solver.max_iter,
                  momentum=solver.momentum, precision=precision)
        # the solve alone from the same state, through the solver's runner
        # and through the eager host loop, on the stores' storage dtype:
        # the same kernels in the same order, so bit for bit the same
        stored = [args[0].to(solver.storage_dtype),
                  args[1].to(solver.storage_dtype)] + args[2:]
        for loop, walls in ((contextlib.nullcontext(), graph_ms),
                            (eager_loop(), eager_ms)):
            with loop:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = run_paged(*stored, **kw, **runners,
                                  use_pallas=solver.use_pallas)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            eager_ok = eager_ok and again.n_iter == res.n_iter and \
                torch.equal(again.f, res.f) and torch.equal(again.g, res.g)
        # the plain operators on the same host state; a bf16 run's float32
        # rows round to the bf16 values its stores hold
        p = run_paged(*args, **kw, use_pallas=False)
        rel = abs(float(res.cost) - float(p.cost)) / abs(float(p.cost))
        pot_ok, pot_err = True, 0.0
        for side, got, want in (("x", res.f, p.f), ("y", res.g, p.g)):
            live = torch.as_tensor(st[side]["live"], device=device)
            err, ok = compare(torch, got[live], want[live],
                              rel_to_max=COST_RTOL)
            pot_ok, pot_err = pot_ok and ok, max(pot_err, err)
        xi_c, zeta_c = (st[s]["feats"][st[s]["live"]] for s in "xy")
        a_c, b_c = (st[s]["weights"][st[s]["live"]] for s in "xy")
        t0 = time.perf_counter()
        prob = OTProblem.from_features(xi_c, zeta_c, a_c / a_c.sum(),
                                       b_c / b_c.sum(), eps=STREAM_EPS)
        cold = solve(prob, method="factored", tol=TOL, precision=precision)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        rel_cold = abs(float(res.cost) - float(cold.cost)) / \
            abs(float(cold.cost))
        ok = (rel <= COST_RTOL and abs(res.n_iter - p.n_iter) <= 1
              and pot_ok and rel_cold <= COST_RTOL
              and math.isfinite(float(res.cost)))
        if rec["label"] != "cold solve":
            warm_iters += res.n_iter
            cold_iters += cold.n_iter
        log(f"  {method} {precision} {rec['label']:15s}: n_iter {res.n_iter}"
            f" (plain {p.n_iter}, cold compact {cold.n_iter}) cost "
            f"{float(res.cost):.7f} rel diff plain {rel:.3e} cold "
            f"{rel_cold:.3e}, potentials err {pot_err:.3e}; wall "
            f"{rec['wall'] * 1e3:.3f} ms ({rec['wall'] * 1e3 / res.n_iter:.4f}"
            f" ms/iteration), cold pipeline {cold_s * 1e3:.3f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{method} {precision} {rec['label']}")
    traces = run["traces"] + (getattr(solver, "traces", 0),)
    ok = eager_ok and (not hasattr(solver, "traces") or traces == (1, 1, 1))
    log(f"  {method} {precision} re-solves alone from the same states: graph "
        f"loop {' '.join(f'{t:.3f}' for t in graph_ms)} ms, eager host loop "
        f"{' '.join(f'{t:.3f}' for t in eager_ms)} ms; n_iter and "
        f"potentials bit-identical {eager_ok}; traces after warmup, traffic "
        f"and these re-solves {traces} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{method} {precision} graph loop")
    d = run["delta"]
    paged = ("paged_feature_contract", "paged_halfstep",
             "paged_feature_matvec")
    flat = ("feature_contract", "sinkhorn_halfstep", "feature_matvec",
            "sinkhorn_block")
    if method == "scaling":
        path_ok = all(d[k] > 0 for k in paged) and all(d[k] == 0
                                                       for k in flat)
    else:
        path_ok = d["log_feature_contract"] > 0 and d["log_halfstep"] > 0
    path_ok = (path_ok and set(run["events"]) == {(method, "paged")}
               and run["resolved"] == STREAM_MUTATIONS and run["solves"] == 2)
    log(f"  {method} {precision} path: plan events {set(run['events'])} "
        f"{'ok' if path_ok else 'FAIL'}")
    if not path_ok:
        failures.append(f"{method} {precision} path")
    # the warm start must save iterations over the run: a re-solve that
    # lost its saved potentials would take the cold solve's count
    warm_ok = warm_iters < cold_iters
    log(f"  {method} {precision} warm start: {warm_iters} iterations over "
        f"the {len(run['records']) - 1} warm re-solves against {cold_iters} "
        f"for cold compact solves of the same states "
        f"{'ok' if warm_ok else 'FAIL'}")
    if not warm_ok:
        failures.append(f"{method} {precision} warm start")
    rng = np.random.default_rng(99)
    live_ids = {s: list(getattr(pair, s).store.ids()) for s in "xy"}
    # one more update, step by step: where the wall of an update goes
    muts = [stream_mutation(np, rng, live_ids[s], s, "split") for s in "xy"]
    t0 = time.perf_counter()
    for side, (gone, add) in zip("xy", muts):
        getattr(pair, side).remove(gone)
        getattr(pair, side).add(**add)
    t1 = time.perf_counter()
    dirty = len(pair.x.store._dirty) + len(pair.y.store._dirty)
    pair.x.device_features(solver.storage_dtype)
    pair.y.device_features(solver.storage_dtype)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    res = solver.re_solve(pair)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    log(f"  {method} {precision} update split: evictions and inserts "
        f"(host bookkeeping) {(t1 - t0) * 1e3:.3f} ms, flush of {dirty} "
        f"dirty pages {(t2 - t1) * 1e3:.3f} ms, re-solve ({res.n_iter} "
        f"iterations) {(t3 - t2) * 1e3:.3f} ms")
    for label, loop in (("graph loop", contextlib.nullcontext()),
                        ("eager host loop", eager_loop())):
        gx, ax = stream_mutation(np, rng, live_ids["x"], "x", label)
        gy, ay = stream_mutation(np, rng, live_ids["y"], "y", label)
        with loop:
            profile_call(torch, f"streaming update {method} {precision} "
                         f"({label})",
                         lambda: solver.update(pair, remove_x=gx, add_x=ax,
                                               remove_y=gy, add_y=ay))
    return failures


def run_streaming_path(torch, np, device):
    """The counted run of phase 7: three runs of the streaming traffic
    (scaling f32, scaling bf16, log f32) with the launch counters set to 0
    just before and read just after; the comparisons follow."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    runs = [drive_stream(torch, np, device, method, precision, 70 + k)
            for k, (method, precision) in enumerate(STREAM_RUNS)]
    counts = launch_counts()
    failures = []
    for run in runs:
        failures += compare_stream(torch, np, device, run)
    return counts, failures


# ---------------------------------------------------------------------------
# Phase 8: the families path
# ---------------------------------------------------------------------------

FAM_SIGMA = 1.5                 # arc-cosine anchors 1.5 N(0, I): r = 1024 ->
                                # r + 1 = 1025 features, off the 16-byte paths
FAM_SMALL, FAM_SMALL_R = 256, 127   # r + 1 = 128 at the trainer's batch: the
                                # log megakernel admits it in bf16 only
FAM_ORACLE_N = 2048             # the dense log_quadratic oracle's n = m
FAM_ORACLE_TOL = 1e-5
FAM_SCALING_EPS = 0.5           # method="factored" on the arc-cosine kernel
NYS_RANK = 1024
NYS_EPS = (0.5, 0.02)           # converges; the reference's failure regime
NYS_COST_RTOL = 1e-4            # card against the CPU on the same landmarks:
                                # cuSOLVER's eigh against LAPACK's, both f32;
                                # 3.85e-06 read on the H100, so ~25x margin
GRID_SIDE, GRID_ORACLE_SIDE, GRID_EPS = 128, 64, 0.1
GRID_COST_RTOL = 1e-5
ACC_EPS = 0.5
ACC_MAX_ITER, ACC_CHECK = 20000, 10
ACC_RTOL, ACC_ATOL = 2e-3, 1e-4     # tests/test_extensions.py:26-34
BARY_N, BARY_K, BARY_EPS = 4096, 3, 0.5
FAMILY_PATH_KERNELS = ("log_feature_contract", "log_halfstep",
                       "log_sinkhorn_block")


def family_inputs(np):
    """The families path's data, numpy from seeds: phase 4's clouds (seed
    0) with arc-cosine anchors; positive-orthant clouds at n = 256 with one
    anchor in the negative orthant (a feature column 0 on both sides); the
    clouds scaled into the unit ball (benchmarks/bench_tradeoff.py's
    Nystrom problem); blob weights on the grids; three blob histograms on
    n = 4096 points of the clouds."""
    rng = np.random.default_rng(80)
    x, y = clouds(np, 0)
    anchors = (FAM_SIGMA * rng.standard_normal((R_ANCHORS, D))).astype(
        np.float32)
    xs = np.abs(rng.standard_normal((FAM_SMALL, D)) + 1.0).astype(np.float32)
    ys = (np.abs(math.sqrt(0.1) * rng.standard_normal((FAM_SMALL, D)))
          + 0.05).astype(np.float32)
    us = (FAM_SIGMA * rng.standard_normal((FAM_SMALL_R, D))).astype(
        np.float32)
    us[0] = -FAM_SIGMA
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))

    def blobs(side, c1, c2):
        g = np.stack(np.meshgrid(*[np.linspace(0, 1, side)] * 2,
                                 indexing="ij"), -1)
        out = []
        for c, w in ((c1, 0.02), (c2, 0.05)):
            h = np.exp(-np.sum((g - np.asarray(c)) ** 2, -1) / w) + 1e-3
            out.append((h / h.sum()).reshape(-1).astype(np.float32))
        return out

    pts = x[:BARY_N]
    centers = (np.full(D, 1.0), np.full(D, 0.0), np.r_[np.full(D // 2, 2.0),
                                                       np.zeros(D - D // 2)])
    hists = []
    for c in centers:
        z = -np.sum((pts - c) ** 2, 1) / 2.0
        h = np.exp(z - z.max())
        hists.append(h / h.sum())
    return dict(x=x, y=y, anchors=anchors, xs=xs, ys=ys, us=us, R=R,
                grid=blobs(GRID_SIDE, (0.3, 0.3), (0.7, 0.6)),
                grid_small=blobs(GRID_ORACLE_SIDE, (0.3, 0.3), (0.7, 0.6)),
                hists=np.stack(hists).astype(np.float32))


def arccos_problem(torch, x, y, anchors, eps, device):
    """A user's arc-cosine request: the clouds and anchors as tensors."""
    from repro_torch.core import ArcCosinePointCloud, OTProblem

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return OTProblem.from_geometry(ArcCosinePointCloud(
        t(x), t(y), t(anchors), eps=eps, sigma=FAM_SIGMA), device=device)


def log_step_ms(torch, geom, precision="highest"):
    """Device time of one iteration of the log plan on ``geom`` in its
    order (three log half-steps, two log contracts), and of one log
    contract and one log half-step on its x factor alone, CUDA events."""
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep
    from repro_torch.kernels.ops import geometry_ops

    plan = geometry_ops(geom, mode="log", precision=precision)
    n, m = geom.shape
    a = torch.full((n,), 1.0 / n, device=geom.device)
    b = torch.full((m,), 1.0 / m, device=geom.device)
    step, init = plan.make_step(a, b)
    carry = init(torch.zeros_like(a), torch.zeros_like(b))
    lxi = plan.features[0]
    s = torch.zeros((n, 1), device=geom.device)
    t = log_feature_contract(lxi, s)
    loga = torch.log(a)[:, None].contiguous()
    return (time_ms(torch, lambda: step(carry)),
            time_ms(torch, lambda: log_feature_contract(lxi, s)),
            time_ms(torch, lambda: log_halfstep(lxi, t, loga,
                                                scale=geom.eps)))


def solve_line(res, wall):
    it = res.n_iter
    return (f"cost={float(res.cost):.7f} n_iter={it} "
            f"converged={bool(res.converged)} diverged={bool(res.diverged)} "
            f"err={float(res.marginal_err):.3e} wall={wall * 1e3:.3f} ms "
            f"({wall / max(it, 1) * 1e3:.4f} ms/iteration)")


def run_families_path(torch, np, device):
    """The counted run of phase 8: every family's requests through the
    entry points, with the launch counters set to 0 just before and read
    just after. Each arc-cosine solve must launch its plan's kernels (the
    log megakernel at n = 256 in bf16, and not in float32)."""
    from repro_torch.core import (
        OTProblem,
        barycenter_log_factored,
        gaussian_log_features,
        sinkhorn_divergence_geometry,
        solve,
    )
    from repro_torch.examples import sphere_barycenter
    from repro_torch.kernels import launch_counts, reset_launch_counts

    inp = family_inputs(np)
    x, y, u = inp["x"], inp["y"], inp["anchors"]
    probs = {
        "arc": arccos_problem(torch, x, y, u, EPS, device),
        "arc_scaling": arccos_problem(torch, x, y, u, FAM_SCALING_EPS,
                                      device),
        "arc_small": arccos_problem(torch, inp["xs"], inp["ys"], inp["us"],
                                    EPS, device),
    }
    ga, _ = anchors_for(torch, np, R_ANCHORS, D, EPS, inp["R"], 81, "cpu")
    probs["gauss_2k"] = OTProblem.from_point_clouds(
        x[:FAM_ORACLE_N], y[:FAM_ORACLE_N], ga.numpy(), eps=EPS)
    R = inp["R"]
    gu, _ = anchors_for(torch, np, R_ANCHORS, D, EPS, 1.0, 82, "cpu")
    probs["unit"] = {e: OTProblem.from_point_clouds(x / R, y / R, gu.numpy(),
                                                    eps=e) for e in NYS_EPS}
    axes = {side: [np.linspace(0, 1, side).astype(np.float32)] * 2
            for side in (GRID_SIDE, GRID_ORACLE_SIDE)}
    probs["grid"] = OTProblem.from_grid(axes[GRID_SIDE], a=inp["grid"][0],
                                        b=inp["grid"][1], eps=GRID_EPS)
    probs["grid_small"] = OTProblem.from_grid(
        axes[GRID_ORACLE_SIDE], a=inp["grid_small"][0],
        b=inp["grid_small"][1], eps=GRID_EPS)
    ua, qa = anchors_for(torch, np, R_ANCHORS, D, ACC_EPS, R, 83, "cpu")
    probs["gauss_acc"] = OTProblem.from_point_clouds(x, y, ua.numpy(),
                                                     eps=ACC_EPS, R=R)
    torch.cuda.synchronize()

    clear_runners()
    out, failures = {}, []
    reset_launch_counts()

    def timed(label, fn, need=(), refuse=()):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = counts_delta(before, launch_counts())
        shown = {k: v for k, v in delta.items() if v}
        line = solve_line(res, wall) if hasattr(res, "cost") else \
            f"wall={wall * 1e3:.3f} ms"
        log(f"  {label}: {line}  launches={shown}")
        missing = [k for k in need if delta[k] <= 0]
        extra = [k for k in refuse if delta[k] != 0]
        if missing or extra:
            failures.append(f"{label}: never launched {missing}, launched "
                            f"{extra}")
        out[label] = (res, wall, delta)
        return res

    logk = ("log_feature_contract", "log_halfstep")
    timed("arccos f32", lambda: solve(probs["arc"], tol=TOL), need=logk)
    timed("arccos bf16", lambda: solve(probs["arc"], tol=TOL,
                                       precision="bf16"), need=logk)
    timed(f"arccos factored eps={FAM_SCALING_EPS}",
          lambda: solve(probs["arc_scaling"], method="factored", tol=TOL),
          need=("feature_contract", "sinkhorn_halfstep", "feature_matvec"))
    timed(f"arccos n={FAM_SMALL} bf16",
          lambda: solve(probs["arc_small"], tol=TOL, precision="bf16"),
          need=("log_sinkhorn_block",))
    timed(f"arccos n={FAM_SMALL} f32",
          lambda: solve(probs["arc_small"], tol=TOL), need=logk,
          refuse=("log_sinkhorn_block",))
    timed(f"arccos n={FAM_ORACLE_N} (rank=, key=)",
          lambda: solve(probs["gauss_2k"], method="arccos", rank=R_ANCHORS,
                        key=torch.Generator().manual_seed(81),
                        tol=FAM_ORACLE_TOL), need=logk)
    xg = probs["arc"].geometry.x.clone().requires_grad_(True)

    def divergence():
        geom = dataclasses.replace(probs["arc"].geometry, x=xg)
        val = sinkhorn_divergence_geometry(geom, tol=TOL)
        (grad,) = torch.autograd.grad(val, [xg])
        return val.detach(), grad

    timed("arccos divergence + grad", divergence, need=logk)
    for e in NYS_EPS:
        timed(f"nystrom eps={e} (rank=, key=)",
              lambda e=e: solve(probs["unit"][e], method="nystrom",
                                rank=NYS_RANK,
                                key=torch.Generator().manual_seed(90),
                                tol=TOL))
    timed(f"grid {GRID_SIDE}x{GRID_SIDE}",
          lambda: solve(probs["grid"], tol=TOL))
    timed(f"grid {GRID_ORACLE_SIDE}x{GRID_ORACLE_SIDE}",
          lambda: solve(probs["grid_small"], tol=TOL))
    timed("accelerated", lambda: solve(
        probs["gauss_acc"], method="accelerated", tol=TOL,
        max_iter=ACC_MAX_ITER, check_every=ACC_CHECK))
    timed("gaussian log_factored eps=0.5",
          lambda: solve(probs["gauss_acc"], tol=TOL),
          need=("gaussian_feature_map",) + logk)
    timed("sphere barycenter",
          lambda: sphere_barycenter.main(["--device", str(device)]))
    pts = torch.as_tensor(x[:BARY_N], device=device)
    lxi = gaussian_log_features(pts, ua.to(device), eps=BARY_EPS, q=qa)
    hists = torch.as_tensor(inp["hists"], device=device)
    timed(f"barycenter n={BARY_N} k={BARY_K}",
          lambda: barycenter_log_factored(lxi, hists, eps=BARY_EPS,
                                          tol=1e-6, max_iter=500))
    counts = launch_counts()
    missing = [k for k in FAMILY_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    return inp, probs, out, counts, failures


def held(label, ok, detail):
    log(f"  {label}: {detail} {'ok' if ok else 'FAIL'}")
    return [] if ok else [label]


def hold_solve(torch, label, k, p):
    """A fused solve against the plain operators: cost 1e-4 relative,
    |d n_iter| <= 1, both potentials within 1e-4 of max |value|."""
    rel = abs(float(k.cost) - float(p.cost)) / abs(float(p.cost))
    ef, okf = compare(torch, k.f, p.f, rel_to_max=COST_RTOL)
    eg, okg = compare(torch, k.g, p.g, rel_to_max=COST_RTOL)
    ok = (rel <= COST_RTOL and abs(k.n_iter - p.n_iter) <= 1 and okf and okg
          and math.isfinite(float(k.cost)))
    return held(label, ok, f"kernel cost={float(k.cost):.7f} n_iter="
                f"{k.n_iter}, plain cost={float(p.cost):.7f} n_iter="
                f"{p.n_iter}, rel_diff={rel:.3e}, f err {ef:.3e}, g err "
                f"{eg:.3e}")


def compare_families(torch, np, device, inp, probs, out):
    """Phase 8's checks, after the counted run."""
    from repro_torch.core import (
        ArcCosineFeatureMap,
        ArcCosinePointCloud,
        NystromLowRank,
        OTProblem,
        sinkhorn_divergence_geometry,
        solve,
    )

    failures = []
    res = {k: v[0] for k, v in out.items()}
    for label, kw in (("arccos f32", {}),
                      ("arccos bf16", {"precision": "bf16"})):
        p = solve(probs["arc"], tol=TOL, use_pallas=False, **kw)
        failures += hold_solve(torch, f"{label} against the plain operators",
                               res[label], p)
    label = f"arccos factored eps={FAM_SCALING_EPS}"
    p = solve(probs["arc_scaling"], method="factored", tol=TOL,
              use_pallas=False)
    failures += hold_solve(torch, f"{label} against the plain operators",
                           res[label], p)
    for label, kw in ((f"arccos n={FAM_SMALL} bf16",
                       {"precision": "bf16", "inner_steps": 8}),
                      (f"arccos n={FAM_SMALL} f32", {})):
        # the plain operators at the megakernel's cadence (8 iterations a
        # check) where it ran
        p = solve(probs["arc_small"], tol=TOL, use_pallas=False, **kw)
        failures += hold_solve(torch, f"{label} against the plain operators",
                               res[label], p)
    xi = probs["arc_small"].geometry.features()[0][:, :-1]
    dead = int(torch.all(xi == 0, dim=0).sum())
    failures += held(f"arccos n={FAM_SMALL} dead anchor columns", dead >= 1,
                     f"{dead} all-zero feature columns (log -inf)")
    big = probs["arc"].geometry.features()[0][:, :-1]
    log(f"  arccos n={N}: {float((big == 0).float().mean()):.3f} of the "
        f"rectified features are 0, {int(torch.all(big == 0, 0).sum())} "
        "columns all 0")
    g2 = probs["gauss_2k"].geometry
    anchors = ArcCosineFeatureMap(r=R_ANCHORS, d=D).init(
        torch.Generator().manual_seed(81), device=device)
    arc2k = ArcCosinePointCloud(g2.x, g2.y, anchors, eps=EPS)
    oracle = solve(OTProblem.from_cost(arc2k.cost_matrix(), eps=EPS),
                   method="log_quadratic", tol=FAM_ORACLE_TOL, max_iter=5000)
    k = res[f"arccos n={FAM_ORACLE_N} (rank=, key=)"]
    rel = abs(float(k.cost) - float(oracle.cost)) / abs(float(oracle.cost))
    failures += held(f"arccos n={FAM_ORACLE_N} against the dense oracle",
                     rel <= COST_RTOL and bool(k.converged)
                     and bool(oracle.converged),
                     f"cost={float(k.cost):.7f} n_iter={k.n_iter}, "
                     f"log_quadratic cost={float(oracle.cost):.7f} n_iter="
                     f"{oracle.n_iter}, rel_diff={rel:.3e}")
    val, grad = res["arccos divergence + grad"]
    xg = probs["arc"].geometry.x.clone().requires_grad_(True)
    pval = sinkhorn_divergence_geometry(
        dataclasses.replace(probs["arc"].geometry, x=xg), tol=TOL,
        use_pallas=False)
    (pgrad,) = torch.autograd.grad(pval, [xg])
    pval = pval.detach()
    gerr, gok = compare(torch, grad, pgrad, rel_to_max=GRAD_REL_TOL)
    dv = abs(float(val) - float(pval))
    scale = abs(float(res["arccos f32"].cost))
    failures += held("arccos divergence against the plain operators",
                     gok and dv <= COST_RTOL * scale
                     and bool(torch.isfinite(grad).all()),
                     f"value {float(val):.7f} / {float(pval):.7f}, grad err "
                     f"{gerr:.3e} (max |grad| {float(pgrad.abs().max()):.3e})")
    x, y, R = inp["x"], inp["y"], inp["R"]
    for e in NYS_EPS:
        k = res[f"nystrom eps={e} (rank=, key=)"]
        cpu_geom = NystromLowRank.from_point_clouds(
            torch.as_tensor(x / R), torch.as_tensor(y / R), eps=e,
            rank=NYS_RANK, generator=torch.Generator().manual_seed(90))
        c = solve(OTProblem.from_geometry(cpu_geom, device="cpu"), tol=TOL)
        if e == NYS_EPS[0]:
            rel = abs(float(k.cost) - float(c.cost)) / abs(float(c.cost))
            ok = (bool(k.converged) and not bool(k.diverged)
                  and rel <= NYS_COST_RTOL)
            detail = (f"card cost={float(k.cost):.7f} n_iter={k.n_iter}, "
                      f"CPU cost={float(c.cost):.7f} n_iter={c.n_iter}, "
                      f"rel_diff={rel:.3e}")
        else:
            ok = bool(k.diverged) == bool(c.diverged) \
                and not bool(k.converged)
            detail = (f"card diverged={bool(k.diverged)} converged="
                      f"{bool(k.converged)} n_iter={k.n_iter}, CPU "
                      f"diverged={bool(c.diverged)} n_iter={c.n_iter} (the "
                      "flag reports it, no exception)")
        failures += held(f"nystrom eps={e} against the CPU, same landmarks",
                         ok, detail)
    a, b = inp["grid"]
    k = res[f"grid {GRID_SIDE}x{GRID_SIDE}"]
    axes = [np.linspace(0, 1, GRID_SIDE).astype(np.float32)] * 2
    c = solve(OTProblem.from_grid(axes, a=a, b=b, eps=GRID_EPS,
                                  device="cpu"), tol=TOL)
    rel = abs(float(k.cost) - float(c.cost)) / abs(float(c.cost))
    failures += held(f"grid {GRID_SIDE}x{GRID_SIDE} against the CPU",
                     rel <= GRID_COST_RTOL and abs(k.n_iter - c.n_iter) <= 1,
                     f"card cost={float(k.cost):.7f} n_iter={k.n_iter}, CPU "
                     f"cost={float(c.cost):.7f} n_iter={c.n_iter}, "
                     f"rel_diff={rel:.3e}")
    gs = probs["grid_small"]
    k = res[f"grid {GRID_ORACLE_SIDE}x{GRID_ORACLE_SIDE}"]
    oracle = solve(OTProblem.from_cost(gs.geometry.cost_matrix(), gs.a, gs.b,
                                       eps=GRID_EPS),
                   method="log_quadratic", tol=TOL)
    rel = abs(float(k.cost) - float(oracle.cost)) / abs(float(oracle.cost))
    failures += held(f"grid {GRID_ORACLE_SIDE}x{GRID_ORACLE_SIDE} against "
                     "the dense oracle", rel <= GRID_COST_RTOL,
                     f"cost={float(k.cost):.7f} n_iter={k.n_iter}, "
                     f"log_quadratic cost={float(oracle.cost):.7f} n_iter="
                     f"{oracle.n_iter}, rel_diff={rel:.3e}")
    acc, lf = res["accelerated"], res["gaussian log_factored eps=0.5"]
    diff = abs(float(acc.cost) - float(lf.cost))
    failures += held("accelerated against log_factored",
                     bool(acc.converged)
                     and diff <= ACC_RTOL * abs(float(lf.cost)) + ACC_ATOL,
                     f"accelerated cost={float(acc.cost):.7f} n_iter="
                     f"{acc.n_iter} (converged={bool(acc.converged)}), "
                     f"log_factored cost={float(lf.cost):.7f} n_iter="
                     f"{lf.n_iter}, |diff|={diff:.3e}")
    sph = res["sphere barycenter"]
    failures += held("sphere barycenter", sph["angle"] < 25.0,
                     f"peak {sph['angle']:.2f} deg from the octant centre")
    bary = res[f"barycenter n={BARY_N} k={BARY_K}"]
    w = bary.weights
    ok = bool(torch.isfinite(w).all()) and bool((w >= 0).all()) and \
        abs(float(w.sum()) - 1.0) <= 1e-5
    failures += held(f"barycenter n={BARY_N} k={BARY_K}", ok,
                     f"n_iter={bary.n_iter} err={float(bary.err):.3e} "
                     f"converged={bool(bary.converged)} sum={float(w.sum()):.7f}"
                     f" min={float(w.min()):.3e}")
    return failures


def time_families(torch, probs, out):
    """One line a family: ms an iteration and ms a solve (from the counted
    run), the arc-cosine log solve's busy share (profiler), and one log
    iteration of the arc-cosine plan (r + 1 = 1025) beside the Gaussian
    one (r = 1024) on the same clouds (CUDA events)."""
    from repro_torch.core import solve

    if SLEEP_MS[0] == 0.0:
        calibrate_sleep(torch)
    gauss = probs["gauss_acc"].geometry
    arc = probs["arc"].geometry
    steps = {(name, prec): log_step_ms(torch, g, prec)
             for name, g in (("arccos", arc), ("gaussian", gauss))
             for prec in ("highest", "bf16")}
    share = profile_call(torch, f"arccos log solve n={N} r+1={R_ANCHORS + 1}",
                         lambda: solve(probs["arc"], tol=TOL))

    def warm(fn):
        """Wall of a second call of a solve (its runner captured)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    warm_runs = {
        "arccos f32": warm(lambda: solve(probs["arc"], tol=TOL)),
        "arccos bf16": warm(lambda: solve(probs["arc"], tol=TOL,
                                          precision="bf16")),
        "gaussian": warm(lambda: solve(probs["gauss_acc"], tol=TOL)),
    }
    gres, gwall = warm_runs["gaussian"]
    gline = (f"Gaussian r={R_ANCHORS} log_factored (eps 0.5, warm) "
             f"{gwall / gres.n_iter * 1e3:.4f} ms/iteration, "
             f"{gwall * 1e3:.3f} ms a solve ({gres.n_iter} iterations)")

    def per(label):
        r, wall = warm_runs[label] if label in warm_runs else out[label][:2]
        it = getattr(r, "n_iter", 0) or 1
        return (f"{wall / it * 1e3:.4f} ms/iteration, {wall * 1e3:.3f} ms a "
                f"solve ({it} iterations{', warm' * (label in warm_runs)})")

    for prec in ("highest", "bf16"):
        (a, ac, ah), (g, gc, gh) = steps[("arccos", prec)], \
            steps[("gaussian", prec)]
        label = "arccos f32" if prec == "highest" else "arccos bf16"
        log(f"  family {label}: {per(label)}; one log plan iteration "
            f"r+1={R_ANCHORS + 1} {a:.4f} ms against Gaussian r={R_ANCHORS}"
            f" {g:.4f} ms ({a / g:.3f}x; log contract {ac:.4f} / {gc:.4f}, "
            f"log half-step {ah:.4f} / {gh:.4f}); {gline}; busy share "
            f"{'not measured' if share is None else f'{share:.3f}'}")
    for label in (f"arccos factored eps={FAM_SCALING_EPS}",
                  f"arccos n={FAM_SMALL} bf16", f"arccos n={FAM_SMALL} f32",
                  f"nystrom eps={NYS_EPS[0]} (rank=, key=)",
                  f"grid {GRID_SIDE}x{GRID_SIDE}", "accelerated",
                  f"barycenter n={BARY_N} k={BARY_K}"):
        log(f"  family {label}: {per(label)}; {gline}")
    wall = out["sphere barycenter"][1]
    log(f"  family sphere barycenter (200 IBP steps, r=3): "
        f"{wall * 1e3:.3f} ms a solve, {wall / 200 * 1e3:.4f} ms/iteration;"
        f" {gline}")


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phases 3 and 9: the batched engine (P problems on a leading axis)
# ---------------------------------------------------------------------------


def batch_features(torch, np, P, n, r, seed, device):
    """bench_batch's stacked features: U(0.05, 1) from a numpy seed, (P,
    n, r) float32 on the card."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(0.05, 1.0, (P, n, r)).astype(
        np.float32), device=device)


def time_batched_kernels(torch, np, device):
    """Phase 3 for the four kernels with a problem axis at the batched
    engine's shape (P = 32, n = 1024, r = 256, B = 1), float32 and bf16:
    each wrapper on the stacked (P, n, r) factor beside its plain batched
    twin, the one PyTorch call computing the same function
    (``torch.bmm``, ``marg / torch.bmm``, ``torch.logsumexp``), and the
    same work as P launches of the 2-D kernel, one a problem. A stacked
    factor is 32 MiB in float32, inside the 50 MB L2, so each call is
    timed cold (cycling through copies past 100 MB; the bound counts
    device-memory bytes) and warm. Returns the float32 rows by kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.kermatvec import (
        feature_contract,
        feature_matvec,
        sinkhorn_halfstep,
    )
    from repro_torch.kernels.logmatvec import log_feature_contract, log_halfstep

    P, n, r, B = BATCH_P, BATCH_N, BATCH_R, 1
    rows = {}
    g = torch.Generator(device=device).manual_seed(23)
    u = torch.rand((P, n, B), generator=g, device=device)
    t = torch.rand((P, r, B), generator=g, device=device)
    s = torch.randn((P, n, B), generator=g, device=device)
    lt = torch.randn((P, r, B), generator=g, device=device)
    marg = torch.full((P, n, B), 1.0 / n, device=device)
    lmarg = torch.log(marg)
    xi32 = batch_features(torch, np, P, n, r, 5, device)
    for dtype in (torch.float32, torch.bfloat16):
        fb = torch.finfo(dtype).bits // 8
        ncopy = max(2, math.ceil(100e6 / (fb * P * n * r)))
        copies = [xi32.to(dtype, copy=True) for _ in range(ncopy)]
        logs = [torch.log(c.float()).to(dtype) for c in copies]
        tag = "f32" if dtype == torch.float32 else "bf16"
        fac = fb * P * n * r
        vec_in, vec_out = 4.0 * P * n * B, 4.0 * P * r * B
        cases = (
            ("feature_contract", copies,
             lambda x: feature_contract(x, u),
             lambda x: ref.feature_contract_ref(x, u),
             lambda x: torch.bmm(x.float().mT, u),
             lambda x, i: feature_contract(x[i], u[i]),
             fac + vec_in + vec_out, 2.0 * P * n * r * B),
            ("sinkhorn_halfstep", copies,
             lambda x: sinkhorn_halfstep(x, t, marg),
             lambda x: ref.sinkhorn_halfstep_ref(x, t, marg),
             lambda x: marg / torch.bmm(x.float(), t),
             lambda x, i: sinkhorn_halfstep(x[i], t[i], marg[i]),
             fac + vec_out + 2 * vec_in, 2.0 * P * n * r * B + P * n * B),
            ("feature_matvec", copies,
             lambda x: feature_matvec(x, t),
             lambda x: ref.feature_matvec_ref(x, t),
             lambda x: torch.bmm(x.float(), t),
             lambda x, i: feature_matvec(x[i], t[i]),
             fac + vec_out + vec_in, 2.0 * P * n * r * B),
            ("log_feature_contract", logs,
             lambda x: log_feature_contract(x, s),
             lambda x: ref.log_feature_contract_ref(x, s),
             lambda x: torch.logsumexp(x.float() + s, dim=1),
             lambda x, i: log_feature_contract(x[i], s[i]),
             fac + vec_in + vec_out, 2.0 * P * n * r * B),
            ("log_halfstep", logs,
             lambda x: log_halfstep(x, lt, lmarg, scale=BATCH_EPS),
             lambda x: ref.log_halfstep_ref(x, lt, lmarg, scale=BATCH_EPS),
             lambda x: BATCH_EPS * (lmarg[..., 0] - torch.logsumexp(
                 x.float() + lt.mT, dim=2)),
             lambda x, i: log_halfstep(x[i], lt[i], lmarg[i],
                                       scale=BATCH_EPS),
             fac + vec_out + 2 * vec_in, 2.0 * P * n * r * B),
        )
        for name, xs, kernel, plain, library, one, nbytes, flops in cases:
            cold = [time_ms(torch, cycling(fn, xs))
                    for fn in (kernel, plain, library)]
            warm = time_ms(torch, lambda: kernel(xs[0]))

            def looped(x):
                for i in range(P):
                    one(x, i)

            loop_ms = time_ms(torch, cycling(looped, xs), per_batch=2)
            b_ms, b_by = bound(nbytes, flops)
            row = dict(ms=cold[0], plain_ms=cold[1], library_ms=cold[2],
                       bound_ms=b_ms, bound_by=b_by, warm_ms=warm,
                       looped_ms=loop_ms, shape=f"P={P} n={n} r={r} {tag}")
            if tag == "f32":
                rows[name] = row
            log(f"  {name:22s} batched {tag} P={P} n={n} r={r}: kernel "
                f"{cold[0]:.4f} ms (L2-warm {warm:.4f})  plain "
                f"{cold[1]:.4f} ms  library {cold[2]:.4f} ms  bound "
                f"{b_ms:.5f} ms ({b_by})  kernel/bound {cold[0] / b_ms:.2f}"
                f"  {P} 2-D launches {loop_ms:.4f} ms")
        del copies, logs
    return rows


BLOCK_TIME_PS = (1, 8, 32, 132)  # phase 3: problems a batched megakernel launch


def time_batched_blocks(torch, device):
    """Phase 3 for both megakernels with their problem axis at the OT-GAN
    shape (n = m = 256, r = 128, bf16, 8 iterations, momentum 1) at P = 1,
    8, 32 and 132: the autotuner's C (tuning on, a fresh cache
    ``build/tuning/phase3.json``, its key holding P), each C of 1, 2, 4 and
    8 forced with the clusters the card places at once and the waves
    ceil(P / placed), the plain batched twin, and as yardsticks the same 8
    iterations through the per-iteration kernels on the stacked factors
    (today's stacked step: 4 or 5 launches an iteration) and P launches of
    the 2-D megakernel, one a problem; both yardsticks replay a captured
    CUDA graph, so they time the device and not the host's launches. The
    bound is P times the 2-D bytes over 3.35 TB/s. No PyTorch call runs
    Sinkhorn iterations: no library time. Returns the P = 32 rows."""
    from repro_torch.kernels import autotune, fused_loop

    n = m = GAN_BATCH
    r, steps, bf = 128, 8, torch.bfloat16
    cache = TUNE_CACHE.parent / "phase3.json"
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.unlink(missing_ok=True)
    one = {"log": (2.0 * (n + m) * r + 4.0 * (3 * n + 4 * m + 2 * r + 1),
                   3.0 * r * (steps * 2 * (n + m) + m)),
           "scaling": (2.0 * (n + m) * r + 4.0 * (3 * n + 5 * m + 1),
                       steps * (4.0 * r * (n + m) + 4.0 * (n + m))
                       + 3.0 * m)}
    rows = {}
    for mode, name in (("log", "log_sinkhorn_block"),
                       ("scaling", "sinkhorn_block")):
        for P in BLOCK_TIME_PS:
            args = stacked_block_inputs(torch, mode, P, n, m, r, bf, 300 + P,
                                        device, dead_lane=False)
            kernel, plain = block_call(mode, args, steps, 1.0)
            ext = dict(P=P, n=n, m=m, r=r, esize=2)
            with autotune.tuning(cache_path=str(cache)):
                tuned = autotune.resolve(name, ext, bf, device)["cluster"]
            forced = {}
            for C in (1, 2, 4, 8):
                plan = fused_loop._block_plan(n, m, r, bf, mode, cluster=C)
                if not fused_loop._runs(plan):
                    continue
                placed = fused_loop._clusters(device.index, mode, n, m, r,
                                              True, plan)
                with autotune.pinned(name, cluster=C):
                    forced[C] = (time_ms(torch, kernel, batches=11,
                                         per_batch=5),
                                 placed, -(-P // placed))
            ms, placed, waves = forced[tuned]
            plain_ms = time_ms(torch, plain, batches=5, per_batch=2)
            unfused = (unfused_log_block(torch, args, steps, 0.5)
                       if mode == "log" else
                       unfused_scaling_block(torch, args, steps))
            unfused_ms = time_ms(torch, graph_replay(torch, unfused),
                                 batches=11, per_batch=2)
            lanes = [block_call(mode, tuple(x[i].contiguous() for x in args),
                                steps, 1.0)[0] for i in range(P)]

            def looped():
                for call in lanes:
                    call()

            loop_ms = time_ms(torch, graph_replay(torch, looped), batches=5,
                              per_batch=1)
            b_ms, b_by = bound(P * one[mode][0], P * one[mode][1])
            static = fused_loop._block_plan(n, m, r, bf, mode).cluster
            log(f"  {name:22s} batched bf16 P={P} n=m={n} r={r} "
                f"inner_steps={steps}: tuned C={tuned} (static {static}) "
                f"{ms:.4f} ms, {placed} clusters placed, {waves} waves; "
                + "; ".join(f"C={C} {t:.4f} ms ({w} waves)"
                            for C, (t, _, w) in forced.items())
                + f"; plain {plain_ms:.4f} ms; per-iteration stacked step "
                f"x{steps} {unfused_ms:.4f} ms ({unfused_ms / ms:.2f}x); {P} "
                f"2-D launches {loop_ms:.4f} ms ({loop_ms / ms:.2f}x); bound "
                f"{b_ms:.6f} ms ({b_by}); kernel/bound {ms / b_ms:.1f}")
            if P == GAN_MB_P:
                rows[name] = dict(
                    ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                    bound_by=b_by, cluster=tuned, placed=placed, waves=waves,
                    forced_ms={str(C): t for C, (t, _, _) in forced.items()},
                    per_iteration_ms=unfused_ms, looped_ms=loop_ms,
                    shape=f"P={P} n=m={n} r={r} bf16 inner_steps={steps}")
            del args, lanes
    return rows


BATCH_SUPPORTS = (300, 700, 1024, 1500, 2048)   # the ragged solve_many list
BATCH_CLOUD_EPS = 0.1
BATCH_ITERS = 50                # bench_batch's fixed iteration count
BATCH_PATH_KERNELS = ("gaussian_feature_map", "feature_contract",
                      "sinkhorn_halfstep", "feature_matvec",
                      "log_feature_contract", "log_halfstep")
BATCH_RUNS = (("factored", "highest"), ("factored", "bf16"),
              ("log_factored", "highest"), ("log_factored", "bf16"))


def batch_inputs(torch, np, device):
    """Phase 9's inputs: the stacked features (P = 32, n = m = 1024, r =
    256) and their logs, uniform weights; 32 pairs of ``gaussian_clouds``
    (1024 points, d = 2, seeds 0-31) and r = 256 shared Lemma-1 anchors at
    eps 0.1; the ragged list's features (U(0.05, 1), n = m = each of
    ``BATCH_SUPPORTS``, r = 256)."""
    from repro_torch.core import GaussianFeatureMap, data_radius
    from repro_torch.data import gaussian_clouds

    P, n, r = BATCH_P, BATCH_N, BATCH_R
    xi = batch_features(torch, np, P, n, r, 0, device)
    zeta = batch_features(torch, np, P, n, r, 1, device)
    w = torch.full((P, n), 1.0 / n, device=device)
    pairs = [gaussian_clouds(i, n, 2, device=device) for i in range(P)]
    x = torch.stack([p[0] for p in pairs])
    y = torch.stack([p[1] for p in pairs])
    R = math.ceil(float(data_radius(x, y)) * 2.0) / 2.0
    fm = GaussianFeatureMap(r=r, d=2, eps=BATCH_CLOUD_EPS, R=R)
    anchors = fm.init(torch.Generator().manual_seed(0)).to(device)
    rng = np.random.default_rng(2)
    ragged = [tuple(torch.as_tensor(rng.uniform(0.05, 1.0, (k, r)).astype(
        np.float32), device=device) for _ in range(2))
        for k in BATCH_SUPPORTS]
    return dict(xi=xi, zeta=zeta, lxi=torch.log(xi), lzeta=torch.log(zeta),
                w=w, x=x, y=y, R=R, anchors=anchors, ragged=ragged)


def batch_engine(method, precision, **kw):
    from repro_torch.core import BatchedSinkhorn
    args = dict(eps=BATCH_EPS, method=method, tol=TOL, max_iter=2000,
                precision=precision)
    args.update(kw)
    return BatchedSinkhorn(**args)


def stacked_args(inp, method):
    ka, kb = ((inp["xi"], inp["zeta"]) if method == "factored"
              else (inp["lxi"], inp["lzeta"]))
    return ka, kb, inp["w"], inp["w"]


def run_batched_path(torch, np, device):
    """The counted run of phase 9, with the launch counters set to 0 just
    before and read just after: ``solve_stacked`` at P = 32, n = m = 1024,
    r = 256, eps 0.5 for ``factored`` and ``log_factored`` in float32 and
    bf16 (each twice: the second solve must capture nothing), 32 cloud
    pairs through ``solve_point_clouds`` annealed to eps 0.1 (twice), the
    ragged ``solve_many`` (twice) and the quickstart."""
    from repro_torch.core import EpsSchedule, solve_many
    from repro_torch.core.api import OTProblem
    from repro_torch.examples import quickstart
    from repro_torch.kernels import launch_counts, reset_launch_counts

    inp = batch_inputs(torch, np, device)
    ragged = [OTProblem.from_features(a_, b_, eps=BATCH_EPS, device=device)
              for a_, b_ in inp["ragged"]]
    engines = {run: batch_engine(*run) for run in BATCH_RUNS}
    cloud_engine = batch_engine(
        "log_factored", "highest", eps=BATCH_CLOUD_EPS,
        schedule=EpsSchedule(eps_init=0.8, decay=0.4))
    out, failures = {}, []
    torch.cuda.synchronize()
    reset_launch_counts()
    for run, eng in engines.items():
        args = stacked_args(inp, run[0])
        for k in range(2):
            c0 = eng.runners.captures
            t0 = time.perf_counter()
            res = eng.solve_stacked(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            new = eng.runners.captures - c0
            if k and new:
                failures.append(f"{run} captured {new} after warmup")
        out[run] = res
        log(f"  solve_stacked {run[0]} {run[1]} P={BATCH_P} n=m={BATCH_N} "
            f"r={BATCH_R}: n_iter {res.n_iter.min().item()}-"
            f"{res.n_iter.max().item()}, cost {float(res.cost.min()):.6f}-"
            f"{float(res.cost.max()):.6f}, second solve {wall * 1e3:.2f} ms "
            f"({wall * 1e3 / int(res.n_iter.max()):.4f} ms an iteration), "
            f"runners {eng.runners.stats()}")
    for k in range(2):
        c0 = cloud_engine.runners.captures
        t0 = time.perf_counter()
        res = cloud_engine.solve_point_clouds(inp["x"], inp["y"],
                                              inp["anchors"], R=inp["R"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if k and cloud_engine.runners.captures != c0:
            failures.append("point clouds captured after warmup")
    out["clouds"] = res
    log(f"  solve_point_clouds P={BATCH_P} n=m={BATCH_N} d=2 r={BATCH_R} "
        f"EpsSchedule(0.8, 0.4) -> eps {BATCH_CLOUD_EPS}: n_iter "
        f"{res.n_iter.min().item()}-{res.n_iter.max().item()}, second "
        f"solve {wall * 1e3:.2f} ms, runners {cloud_engine.runners.stats()}")
    for k in range(2):
        t0 = time.perf_counter()
        res = solve_many(ragged, method="factored", tol=TOL, max_iter=2000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["ragged"] = res
    log(f"  solve_many supports {BATCH_SUPPORTS}: n_iter "
        f"{[r_.n_iter for r_ in res]}, second call {wall * 1e3:.2f} ms")
    t0 = time.perf_counter()
    out["quickstart"] = quickstart.main([])
    torch.cuda.synchronize()
    log(f"  quickstart (n=4000, r=500, its five steps): "
        f"{time.perf_counter() - t0:.2f} s")
    counts = launch_counts()
    missing = [k for k in BATCH_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    return inp, ragged, engines, cloud_engine, out, counts, failures


def lane_check(label, got, want, i, failures, n_tol=1):
    """One lane against its yardstick: cost COST_RTOL relative, |d n_iter|
    <= ``n_tol``."""
    rel = abs(float(got.cost[i]) - float(want.cost)) / abs(float(want.cost))
    dn = abs(int(got.n_iter[i]) - int(want.n_iter))
    if not (rel <= COST_RTOL and dn <= n_tol):
        failures.append(f"{label} lane {i}: rel {rel:.2e}, d n_iter {dn}")
    return rel, dn


def compare_batched_path(torch, np, device, inp, ragged, engines,
                         cloud_engine, out):
    """Each lane of phase 9's counted run against its own single solve
    (``solve(SolveSpec)``, the same method and policy) and against the
    ``use_pallas=False`` engine: cost 1e-4 relative, |d n_iter| <= 1, the
    check cadence of both (every iteration: the megakernels refuse these
    shapes). Then the launches a replay of the P = 1 and the P = 32 cell
    (equal), and times at bench_batch's fixed 50 iterations."""
    from repro_torch.core import EpsSchedule, ExecutionPolicy, SolveSpec, solve
    from repro_torch.core.api import OTProblem

    failures = []
    for run, eng in engines.items():
        method, precision = run
        ka, kb, a, b = stacked_args(inp, method)
        res = out[run]
        worst = [0.0, 0]
        pol = ExecutionPolicy(precision=precision)
        t0 = time.perf_counter()
        singles = []
        for i in range(BATCH_P):
            maker = (OTProblem.from_features if method == "factored"
                     else OTProblem.from_log_features)
            prob = maker(ka[i], kb[i], eps=BATCH_EPS, device=device)
            singles.append(solve(SolveSpec.from_problem(
                prob, method=method, tol=TOL, max_iter=2000, policy=pol)))
        torch.cuda.synchronize()
        loop_wall = time.perf_counter() - t0
        plain = batch_engine(method, precision,
                             use_pallas=False).solve_stacked(ka, kb, a, b)
        for i in range(BATCH_P):
            for label, want in (("single", singles[i]),
                                ("plain", unpad_lane(plain, i))):
                rel, dn = lane_check(f"{run} {label}", res, want, i,
                                     failures)
                worst = [max(worst[0], rel), max(worst[1], dn)]
        log(f"  {run[0]} {run[1]}: {BATCH_P} lanes against their single "
            f"solves and use_pallas=False: worst cost rel {worst[0]:.2e}, "
            f"worst |d n_iter| {worst[1]} (32 single solves {loop_wall:.3f}"
            " s)")
    res = out["clouds"]
    worst = [0.0, 0]
    sched = EpsSchedule(eps_init=0.8, decay=0.4)
    stages = len(sched.stages(BATCH_CLOUD_EPS))
    plain = batch_engine("log_factored", "highest", eps=BATCH_CLOUD_EPS,
                         schedule=sched, use_pallas=False).solve_point_clouds(
        inp["x"], inp["y"], inp["anchors"], R=inp["R"])
    for i in range(BATCH_P):
        prob = OTProblem.from_point_clouds(inp["x"][i], inp["y"][i],
                                           inp["anchors"],
                                           eps=BATCH_CLOUD_EPS, R=inp["R"],
                                           device=device)
        single = solve(SolveSpec.from_problem(
            prob, method="log_factored", tol=TOL, max_iter=2000,
            schedule=sched))
        for label, want in (("single", single), ("plain",
                                                 unpad_lane(plain, i))):
            rel, dn = lane_check(f"clouds {label}", res, want, i, failures,
                                 n_tol=stages)
            worst = [max(worst[0], rel), max(worst[1], dn)]
    log(f"  point clouds: {BATCH_P} lanes against their single annealed "
        f"solves and use_pallas=False: worst cost rel {worst[0]:.2e}, "
        f"worst |d n_iter| {worst[1]} (within 1 a stage, {stages} stages)")
    for k, (p, got) in enumerate(zip(ragged, out["ragged"])):
        want = solve(SolveSpec.from_problem(p, method="factored", tol=TOL,
                                            max_iter=2000))
        rel = abs(float(got.cost) - float(want.cost)) / abs(float(want.cost))
        dn = abs(got.n_iter - want.n_iter)
        ok = rel <= COST_RTOL and dn <= 1 and got.f.shape == p.a.shape
        log(f"  solve_many n=m={BATCH_SUPPORTS[k]}: cost rel {rel:.2e}, "
            f"d n_iter {dn} against its single solve {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"ragged n={BATCH_SUPPORTS[k]}")
    qs = out["quickstart"]
    ok = (abs(qs["factored"] - qs["exact"]) < 0.05 * abs(qs["exact"])
          and qs["after_step"] < qs["divergence"]
          and bool(torch.isfinite(qs["batch_costs"]).all()))
    log(f"  quickstart: exact {qs['exact']:.5f}, factored "
        f"{qs['factored']:.5f}, cold {qs['cold_iters']} / annealed "
        f"{qs['annealed_iters']} iterations, divergence "
        f"{qs['divergence']:.5f} -> {qs['after_step']:.5f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("quickstart")
    failures += launches_per_replay(torch, inp, engines)
    failures += time_batched_engine(torch, device, inp)
    return failures


def unpad_lane(res, i):
    from repro_torch.core.api import unpad_result
    return unpad_result(res, i, res.f.shape[1], res.g.shape[1])


def launches_per_replay(torch, inp, engines):
    """The launches a replay of the P = 1 cell and of the P = 32 cell make
    (K = 8 iterations a replay, one per-iteration step each): equal for
    each method, the problems riding on the kernels' leading axis."""
    failures = []
    for run, eng in engines.items():
        if run[1] != "highest":
            continue
        ka, kb, a, b = stacked_args(inp, run[0])
        eng.solve_stacked(ka[:1], kb[:1], a[:1], b[:1])
        per = {key.P: r_.per_replay for key, r_ in
               ((k, eng.runners._runners[k]) for k in eng.runners.keys())}
        same = per.get(1) == per.get(BATCH_P) and per.get(1)
        log(f"  {run[0]}: launches a replay (8 iterations) at P=1 "
            f"{per.get(1)} and at P={BATCH_P} {per.get(BATCH_P)} "
            f"{'equal' if same else 'DIFFER'}")
        if not same:
            failures.append(f"{run[0]} launches a replay differ")
    return failures


def graph_replay(torch, fn):
    """``fn`` captured in a CUDA graph after one eager call: its replay,
    so that CUDA events time the device work and not the host's
    launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph.replay


def time_batched_engine(torch, device, inp):
    """bench_batch's comparison on the card: P = 32 problems at a fixed 50
    iterations (tol 0), through one ``solve_stacked`` against a loop of 32
    single solves (each its own replays and reads), host clock ending in a
    sync, best of 3 after a warm-up, each lane's cost held against its
    single solve's (1e-4 relative); and one iteration's device time (CUDA
    events over a captured graph) of the stacked plan's step against 32
    steps of the single-problem plan. Returns the failures."""
    from repro_torch.core import ExecutionPolicy, SolveSpec, solve
    from repro_torch.core.api import OTProblem
    from repro_torch.kernels import ops

    failures = []
    calibrate_sleep(torch)
    for method in ("factored", "log_factored"):
        ka, kb, a, b = stacked_args(inp, method)
        eng = batch_engine(method, "highest", tol=0.0, max_iter=BATCH_ITERS)
        maker = (OTProblem.from_features if method == "factored"
                 else OTProblem.from_log_features)
        probs = [maker(ka[i], kb[i], eps=BATCH_EPS, device=device)
                 for i in range(BATCH_P)]
        specs = [SolveSpec.from_problem(p, method=method, tol=0.0,
                                        max_iter=BATCH_ITERS,
                                        policy=ExecutionPolicy())
                 for p in probs]

        got, singles_res = {}, {}

        def batched():
            got["res"] = eng.solve_stacked(ka, kb, a, b)
            torch.cuda.synchronize()

        def looped():
            singles_res["res"] = [solve(s_) for s_ in specs]
            torch.cuda.synchronize()

        walls = {}
        for name, fn in (("batched", batched), ("loop", looped)):
            fn()
            best = math.inf
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                best = min(best, time.perf_counter() - t0)
            walls[name] = best
        mode = "scaling" if method == "factored" else "log"
        kind = method
        spec = ({"kind": kind, "xi": ka, "zeta": kb} if mode == "scaling"
                else {"kind": kind, "log_xi": ka, "log_zeta": kb})
        plan = ops.stacked_ops(spec, problems=BATCH_P, eps=BATCH_EPS,
                               mode=mode)
        res = got["res"]
        worst = 0.0
        for i, one in enumerate(singles_res["res"]):
            rel = abs(float(res.cost[i]) - float(one.cost)) / abs(
                float(one.cost))
            worst = max(worst, rel)
            if rel > COST_RTOL or int(res.n_iter[i]) != one.n_iter:
                failures.append(f"{method} {BATCH_ITERS} iterations lane {i}"
                                f": rel {rel:.2e}")
        step, init = plan.make_step(a, b)
        c0 = init(torch.ones_like(a) if mode == "scaling"
                  else torch.zeros_like(a), torch.ones_like(b))
        step_ms = time_ms(torch, graph_replay(torch, lambda: step(c0)))
        singles = []
        for i in range(BATCH_P):
            p1 = ops.geometry_ops(probs[i].geometry, mode=mode)
            s1, i1 = p1.make_step(a[i], b[i])
            singles.append((s1, i1(*(t_[i] for t_ in c0[:2]))))

        def loop_steps():
            for s1, c1 in singles:
                s1(c1)

        loop_ms = time_ms(torch, graph_replay(torch, loop_steps),
                          per_batch=4)
        log(f"  batched {method} P={BATCH_P} n=m={BATCH_N} r={BATCH_R} "
            f"{BATCH_ITERS} iterations: one solve_stacked "
            f"{walls['batched'] * 1e3:.2f} ms, a loop of {BATCH_P} single "
            f"solves {walls['loop'] * 1e3:.2f} ms, loop/batched "
            f"{walls['loop'] / walls['batched']:.2f} (lanes against their "
            f"single solves: worst cost rel {worst:.2e}, n_iter equal); one "
            f"iteration (device, CUDA events on a captured graph) "
            f"{step_ms:.4f} ms stacked, {loop_ms:.4f} ms as {BATCH_P} "
            f"single steps ({loop_ms / step_ms:.2f}x)")
    return failures


GAN_MB_P = 32                   # phase 9's GAN minibatch: problems,
GAN_MB_D = 8                    # the OT-GAN embedding's dimension,
GAN_MB_BALL = 3.0               # its ball's radius (the feature map's R),
GAN_MB_R = 128                  # anchors, the trainer's default r
GAN_MB_EPS = 0.5                # the trainer's eps
GAN_MB_DIV_N = 128              # the divergence's n = m in float32 (176 is
                                # the largest the budget admits at r = 128)
GAN_MB_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                  "log_sinkhorn_block", "sinkhorn_block")


def gan_clouds(torch, np, P, n, seed, device):
    """P OT-GAN-shaped cloud pairs (n points each in the embedding's R^8,
    inside its ball of radius 3): 0.7 N(0, I) against 0.7 N(0, I) + 0.4,
    each point pulled radially into the ball; numpy seeds, float32."""
    rng = np.random.default_rng(seed)

    def ball(z):
        norm = np.linalg.norm(z, axis=-1, keepdims=True)
        return z * np.minimum(1.0, 0.95 * GAN_MB_BALL / norm)

    x = ball(0.7 * rng.standard_normal((P, n, GAN_MB_D)))
    y = ball(0.7 * rng.standard_normal((P, n, GAN_MB_D)) + 0.4)
    return (torch.as_tensor(x.astype(np.float32), device=device),
            torch.as_tensor(y.astype(np.float32), device=device))


def gan_lane_check(label, got, want, failures, block=8):
    """Every lane of ``got`` against ``want`` (both stacked): cost 1e-4
    relative, |d n_iter| within one block. Returns the worst of both."""
    rel = ((got.cost - want.cost).abs() / want.cost.abs()).max().item()
    dn = (got.n_iter - want.n_iter).abs().max().item()
    if not (rel <= COST_RTOL and dn <= block):
        failures.append(f"{label}: cost rel {rel:.2e}, |d n_iter| {dn}")
    return rel, dn


def per_iteration_blocks():
    """A context in which no stacked plan admits its megakernel
    (``GeometryOps.block_admits`` false), so the auto cadence takes the
    per-iteration step at every check: the path these solves took before
    the megakernels had a problem axis, timed as the yardstick."""
    from repro_torch.kernels import ops

    @contextlib.contextmanager
    def ctx():
        admits = ops.GeometryOps.block_admits
        ops.GeometryOps.block_admits = lambda self, n, m, P=1: False
        try:
            yield
        finally:
            ops.GeometryOps.block_admits = admits

    return ctx()


def best_wall(torch, fn, repeats=3):
    """The best host wall of ``fn`` ending in a device sync, after one
    untimed call."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def run_gan_minibatch(torch, np, device):
    """Phase 9's GAN-minibatch part, with the launch counters set to 0
    just before and read just after: ``solve_point_clouds`` on 32
    OT-GAN-shaped cloud pairs (n = m = 256 in R^8, r = 128 shared anchors,
    eps 0.5, ``precision="bf16"``, ``log_factored``, auto cadence) and
    ``solve_stacked`` on the same clouds' Gaussian features
    (``factored``), each twice; then ``sinkhorn_divergence_gaussian_batched``
    at P = 32, n = m = 128 in float32 with its gradient in x, y and the
    anchors, twice. At these shapes each problem fits the megakernel, so
    every solve runs 8 iterations of all 32 problems a launch. Returns
    ``(inputs, results, counts, failures)``."""
    from repro_torch.core import (BatchedSinkhorn, GaussianFeatureMap,
                                  sinkhorn_divergence_gaussian_batched)
    from repro_torch.core.features import gaussian_log_features
    from repro_torch.kernels import launch_counts, reset_launch_counts

    P, n = GAN_MB_P, GAN_BATCH
    fm = GaussianFeatureMap(r=GAN_MB_R, d=GAN_MB_D, eps=GAN_MB_EPS,
                            R=GAN_MB_BALL)
    anchors = fm.init(torch.Generator().manual_seed(0)).to(device)
    x, y = gan_clouds(torch, np, P, n, 29, device)
    lxi = gaussian_log_features(x, anchors, eps=GAN_MB_EPS, q=fm.q)
    lzt = gaussian_log_features(y, anchors, eps=GAN_MB_EPS, q=fm.q)
    w = torch.full((P, n), 1.0 / n, device=device)
    dx, dy = gan_clouds(torch, np, P, GAN_MB_DIV_N, 31, device)
    inp = dict(x=x, y=y, anchors=anchors, q=fm.q, xi=torch.exp(lxi),
               zeta=torch.exp(lzt), w=w, dx=dx, dy=dy)
    kw = dict(eps=GAN_MB_EPS, tol=TOL, max_iter=2000, precision="bf16")
    engines = {"log_factored": BatchedSinkhorn(method="log_factored", **kw),
               "factored": BatchedSinkhorn(method="factored", **kw)}
    calls = {"log_factored": lambda eng: eng.solve_point_clouds(
                 x, y, anchors, R=GAN_MB_BALL),
             "factored": lambda eng: eng.solve_stacked(
                 inp["xi"], inp["zeta"], w, w)}
    out, failures = {}, []
    torch.cuda.synchronize()
    reset_launch_counts()
    for method, eng in engines.items():
        for k in range(2):
            c0 = eng.runners.captures
            res = calls[method](eng)
            torch.cuda.synchronize()
            if k and eng.runners.captures != c0:
                failures.append(f"GAN minibatch {method} captured "
                                f"{eng.runners.captures - c0} after warmup")
        out[method] = res
        per = [r_.per_replay for r_ in eng.runners._runners.values()]
        mega = "log_sinkhorn_block" if method == "log_factored" \
            else "sinkhorn_block"
        blocks = [key.blocks for key in eng.runners.keys()]
        ok = (len(per) == 1 and set(per[0]) == {mega}
              and per[0][mega] == blocks[0])
        log(f"  GAN minibatch {method} bf16 P={P} n=m={n} d={GAN_MB_D} "
            f"r={GAN_MB_R}: n_iter {res.n_iter.min().item()}-"
            f"{res.n_iter.max().item()}, cost "
            f"{float(res.cost.min()):.6f}-{float(res.cost.max()):.6f}; "
            f"launches a replay {per} ({blocks[0]} blocks of 8 iterations "
            f"for all {P} problems) {'ok' if ok else 'FAIL'}; runners "
            f"{eng.runners.stats()}")
        if not ok:
            failures.append(f"GAN minibatch {method}: launches a replay "
                            f"{per}, blocks {blocks}")
    leaves = [t.clone().requires_grad_(True) for t in (dx, dy, anchors)]
    for k in range(2):
        before = loop_stats()
        val = sinkhorn_divergence_gaussian_batched(
            *leaves, eps=GAN_MB_EPS, q=fm.q)
        grads = torch.autograd.grad(val.sum(), leaves)
        torch.cuda.synchronize()
        new = loop_delta(before, loop_stats())["captures"]
        if k and new:
            failures.append(f"GAN minibatch divergence captured {new} "
                            "after warmup")
    out["divergence"] = (val.detach(), [g_.detach() for g_ in grads])
    counts = launch_counts()
    log(f"  GAN minibatch divergence f32 P={P} n=m={GAN_MB_DIV_N} "
        f"r={GAN_MB_R}: value {float(val.detach().min()):.6f}-"
        f"{float(val.detach().max()):.6f},"
        f" second call captured {new}")
    missing = [k_ for k_ in GAN_MB_KERNELS if counts[k_] <= 0]
    if missing:
        failures.append(f"GAN minibatch: kernels never launched: {missing}")
    return inp, engines, calls, out, counts, failures


def compare_gan_minibatch(torch, device, inp, engines, calls, out):
    """Phase 9's GAN-minibatch yardsticks: each solve's lanes against the
    per-iteration stacked step at ``check_every=8`` and against
    ``use_pallas=False`` with ``inner_steps=8`` (the same check points):
    cost 1e-4 relative, |d n_iter| within one block (8); the divergence
    against the same call on the CPU (value 1e-4 relative, gradients 1e-3
    of max |grad|). Then ms a solve and a divergence call (value and
    gradients) on the megakernels against the per-iteration path on the
    same data, and last the busy share of a solve (every cell captured
    by then)."""
    from repro_torch.core import (BatchedSinkhorn,
                                  sinkhorn_divergence_gaussian_batched)

    failures = []
    kw = dict(eps=GAN_MB_EPS, tol=TOL, max_iter=2000, precision="bf16")
    worst = {}
    for method in engines:
        for label, extra in (("per-iteration check_every=8",
                              dict(check_every=8)),
                             ("use_pallas=False inner_steps=8",
                              dict(use_pallas=False, inner_steps=8))):
            other = calls[method](BatchedSinkhorn(method=method, **kw,
                                                  **extra))
            worst.setdefault(method, []).append(gan_lane_check(
                f"GAN minibatch {method} vs {label}", out[method], other,
                failures))
    val, grads = out["divergence"]
    leaves_cpu = [t.detach().cpu().requires_grad_(True)
                  for t in (inp["dx"], inp["dy"], inp["anchors"])]
    want = sinkhorn_divergence_gaussian_batched(*leaves_cpu, eps=GAN_MB_EPS,
                                                q=inp["q"])
    want_g = torch.autograd.grad(want.sum(), leaves_cpu)
    rel = ((val.cpu() - want.detach()).abs()
           / want.detach().abs()).max().item()
    g_err = [((g_.cpu() - w_).abs().max() / w_.abs().max()).item()
             for g_, w_ in zip(grads, want_g)]
    ok = rel <= COST_RTOL and max(g_err) <= GRAD_REL_TOL
    if not ok:
        failures.append(f"GAN minibatch divergence vs CPU: value rel "
                        f"{rel:.2e}, grads {g_err}")
    walls, fresh = {}, {}
    for method, eng in engines.items():
        fresh[method] = BatchedSinkhorn(method=method, **kw)
        with per_iteration_blocks():
            per_it = best_wall(torch, lambda: calls[method](fresh[method]))
        walls[method] = (best_wall(torch, lambda: calls[method](eng)),
                         per_it)
    leaves = [t.clone().requires_grad_(True)
              for t in (inp["dx"], inp["dy"], inp["anchors"])]

    def div_call():
        v = sinkhorn_divergence_gaussian_batched(*leaves, eps=GAN_MB_EPS,
                                                 q=inp["q"])
        torch.autograd.grad(v.sum(), leaves)

    div_mega = best_wall(torch, div_call)
    with per_iteration_blocks():
        div_per_it = best_wall(torch, div_call)
    for method, eng in engines.items():
        with per_iteration_blocks():
            share_it, _, _ = busy_share(
                torch, lambda: calls[method](fresh[method]))
        share, _, top = busy_share(torch, lambda: calls[method](eng))
        (w0, w1), (mega, per_it) = worst[method], walls[method]
        log(f"  GAN minibatch {method}: {GAN_MB_P} lanes vs per-iteration "
            f"(check_every=8) worst cost rel {w0[0]:.2e} |d n_iter| "
            f"{w0[1]}, vs use_pallas=False (inner_steps=8) {w1[0]:.2e} / "
            f"{w1[1]}; a solve {mega * 1e3:.3f} ms on the megakernel, "
            f"{per_it * 1e3:.3f} ms per-iteration ({per_it / mega:.2f}x); "
            f"busy share {'n/a' if share is None else f'{share:.3f}'} "
            f"(per-iteration "
            f"{'n/a' if share_it is None else f'{share_it:.3f}'}); top "
            f"{[(e.key[:28], round(e.self_device_time_total)) for e in top[:3]]}")
    log(f"  GAN minibatch divergence vs the CPU: value rel {rel:.2e}, "
        f"gradients (x, y, anchors) {[f'{e:.2e}' for e in g_err]} of max "
        f"|grad| {'ok' if ok else 'FAIL'}; a call with its gradient "
        f"{div_mega * 1e3:.3f} ms on the megakernel, "
        f"{div_per_it * 1e3:.3f} ms per-iteration "
        f"({div_per_it / div_mega:.2f}x)")
    return failures


# ---------------------------------------------------------------------------
# Phase 10: the serving front end
# ---------------------------------------------------------------------------

SERVE_TRACE = dict(n_requests=400, eps=0.5, r=256,
                   size_classes=((1024, 1024), (2048, 1536), (512, 700)),
                   pool_size=32, repeat_frac=0.6, near_frac=0.3, seed=0)
SERVE_TOL = 1e-6                # the reference's serving tol
SERVE_MAX_BATCH = 16
SERVE_BUCKETS = (1, 2, 4, 8, 16)    # ot_batch_bucket up to SERVE_MAX_BATCH
SERVE_SIDES = (512, 1024, 2048)     # the cells' padded supports
SERVE_MAX_WAIT = 0.004
SERVE_WINDOW = 64               # requests a closed-loop client keeps in flight
SERVE_METHODS = ("log_factored", "factored")
SERVE_EXACT_RTOL = 1e-5         # an exact repeat against its cold solve
SERVE_POT_TOL = 1e-4            # a cold lane's f, g: of max |value|
SERVE_WARM_SAVES = ("log_factored",)   # warm iterations below cold
SERVE_LANES = (("--strict", "--rank", "256"), ("--stream", "--strict"),
               ("--chaos", "--strict", "--rank", "256"))
SERVE_PATH_KERNELS = ("feature_contract", "sinkhorn_halfstep",
                      "feature_matvec", "log_feature_contract",
                      "log_halfstep")


def closed_loop(svc, problems, window=SERVE_WINDOW):
    """A client that keeps ``window`` requests in flight: submit them,
    drain, repeat (``OTService.solve_many`` a window at a time). Returns the
    tickets and the wall (host clock; every drain ends in its loops' last
    host read and the results' read)."""
    tickets = []
    t0 = time.perf_counter()
    for k in range(0, len(problems), window):
        part = [svc.submit(p) for p in problems[k:k + window]]
        svc.drain()
        tickets += part
    return tickets, time.perf_counter() - t0


def busy_share(torch, fn):
    """Device busy share of ``fn()`` under torch.profiler (the kernel rows'
    device time over the wall, both under the profiler); None where the
    profiler saw no device time. Returns ``(share, wall, top rows)``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = kernel_rows(torch, prof)
    device_us = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    share = device_us / 1e6 / wall if device_us > 0 else None
    return share, wall, top


def potentials_err(torch, got, want, shift=False):
    """Worst of f and g of ``got`` against ``want`` (both unpadded CPU
    results), over max |value| of ``want``; inf where their dead (-inf)
    atoms differ. ``shift`` first takes out the constant (f + c, g - c)
    that leaves a solution's cost and plan unchanged (a warm start may
    land on another one)."""
    diffs = []
    pairs = [(x.cpu(), w.cpu()) for x, w in ((got.f, want.f),
                                              (got.g, want.g))]
    for x, w in pairs:
        live = torch.isfinite(w)
        if not torch.equal(live, torch.isfinite(x)):
            return math.inf
        diffs.append(x[live].double() - w[live].double())
    if shift:
        c = float(diffs[0].median())
        diffs = [diffs[0] - c, diffs[1] + c]
    scale = max(float(w[torch.isfinite(w)].abs().max()) for _, w in pairs)
    return max(float(d.abs().max()) for d in diffs) / max(scale, 1.0)


def percentiles_ms(np, latencies):
    lat = np.asarray(latencies, np.float64) * 1e3
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def serve_method(torch, np, method, trace, device):
    """One method's serving run (see the module doc, phase 10): warmup,
    the closed loop with warm starts, again without (same runners), again
    under the profiler (a fresh warm cache, same runners), the open loop
    at half the closed loop's rate, and bench_serve's sequential cold
    baseline; then its gates. Returns the failures."""
    from repro_torch.core import runners as core_runners
    from repro_torch.kernels import launch_counts
    from repro_torch.serving import OTService, run_open_loop, traffic_cells
    from repro_torch.serving.service import HOST_SPLIT
    from repro_torch.serving.traffic import Request, TrafficSpec

    failures = []
    problems = [req.problem for req in trace]
    n_req = len(problems)

    def service(**kw):
        return OTService(eps=SERVE_TRACE["eps"], method=method,
                         tol=SERVE_TOL, max_batch=SERVE_MAX_BATCH,
                         max_wait=SERVE_MAX_WAIT, device=device, **kw)

    svc = service()
    engine = svc.engine
    cells = traffic_cells(trace, engine)
    t0 = time.perf_counter()
    built = svc.warmup(cells)
    torch.cuda.synchronize()
    log(f"  serve {method}: warmup {built} runners over {len(cells)} cells "
        f"{[(c.n_pad, c.m_pad, c.r) for c in cells]} in "
        f"{time.perf_counter() - t0:.2f} s")
    loops0 = svc.runners.loop_stats()
    engine0 = engine.runners.captures
    global0 = core_runners.RUNNERS.captures

    # -- closed loop, warm starts on --------------------------------------
    s0, c0 = svc.stats(), launch_counts()
    warm_t, wall = closed_loop(svc, problems)
    s1, c1, loops1 = svc.stats(), launch_counts(), svc.runners.loop_stats()
    batches = s1["batches"] - s0["batches"]
    launches = {k: c1[k] - c0[k] for k in c1 if c1[k] != c0[k]}
    rps = n_req / wall
    p50, p99 = percentiles_ms(np, [t.latency for t in warm_t])
    w = s1["warm"]
    converged = sum(bool(t.result.converged) for t in warm_t if t.result)
    log(f"  serve {method} closed loop ({SERVE_WINDOW} in flight, warm "
        f"starts on): {n_req} requests in {wall:.3f} s = {rps:.1f} rps, "
        f"p50 {p50:.2f} ms p99 {p99:.2f} ms, {batches} dispatches, mean "
        f"batch {n_req / batches:.2f}; warm hits exact {w['exact_hits']} "
        f"near {w['near_hits']} miss {w['misses']} (hit rate "
        f"{w['hit_rate']:.3f}); mean iterations warm "
        f"{s1['mean_iters_warm']:.2f} cold {s1['mean_iters_cold']:.2f}; "
        f"converged {converged}/{n_req} at tol {SERVE_TOL}")
    log(f"  serve {method} per dispatch: kernel launches "
        f"{sum(launches.values()) / batches:.2f} ({launches}), loop "
        f"replays {(loops1['replays'] - loops0['replays']) / batches:.2f}, "
        f"loop host reads {(loops1['reads'] - loops0['reads']) / batches:.2f}"
        f" (+1 read of the results a dispatch, +2 reads a request: its "
        f"weights and its fingerprint)")
    split = {k: (s1["host_s"][k] - s0["host_s"][k]) / n_req * 1e3
             for k in HOST_SPLIT}
    log(f"  serve {method} host ms a request: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items())
        + f"; sum {sum(split.values()):.3f} of {wall / n_req * 1e3:.3f}")

    # -- closed loop, warm starts off, the same runners --------------------
    cold = service(warm_starts=False)
    cold.runners = svc.runners
    cold_t, cold_wall = closed_loop(cold, problems)
    cs = cold.stats()
    cp50, cp99 = percentiles_ms(np, [t.latency for t in cold_t])
    csplit = sum(cs["host_s"].values()) / n_req * 1e3
    log(f"  serve {method} closed loop, warm starts off: "
        f"{n_req / cold_wall:.1f} rps, p50 {cp50:.2f} ms p99 {cp99:.2f} ms, "
        f"mean batch "
        f"{cs['mean_batch']:.2f}, mean iterations {cs['mean_iters_cold']:.2f}"
        f", host {csplit:.3f} ms a request (fingerprint "
        f"{cs['host_s']['fingerprint'] / n_req * 1e3:.3f})")

    # -- the closed loop under the profiler --------------------------------
    prof = service()
    prof.runners = svc.runners
    share, pwall, top = busy_share(torch, lambda: closed_loop(prof, problems))
    if share is None:
        log(f"  serve {method} closed loop busy share: not measured (the "
            "profiler saw no device time)")
    else:
        log(f"  serve {method} closed loop under the profiler: wall "
            f"{pwall:.3f} s, device busy share {share:.3f} (idle "
            f"{1 - share:.3f})")
        for e in top:
            log(f"    {e.key[:60]:60s} {e.count:6d} calls "
                f"{e.self_device_time_total / 1e3:9.3f} ms")

    # -- open loop at half the closed loop's rate --------------------------
    rate = rps / 2
    stretch = TrafficSpec(**SERVE_TRACE).rate_hz / rate
    open_trace = [Request(r.t_offset * stretch, r.problem, r.kind)
                  for r in trace]
    o0 = svc.stats()
    report = run_open_loop(svc, open_trace)
    o1 = svc.stats()
    ob = o1["batches"] - o0["batches"]
    log(f"  serve {method} open loop at {rate:.1f} rps offered: "
        f"{report.completed}/{n_req} served in {report.duration_s:.3f} s = "
        f"{report.rps:.1f} rps, p50 {report.p50_ms:.2f} ms p99 "
        f"{report.p99_ms:.2f} ms (from the scheduled arrival), mean batch "
        f"{(o1['served'] - o0['served']) / max(ob, 1):.2f}")

    # -- sequential cold baseline: engine.solve_many([p]) a request --------
    engine_served = engine.runners.captures
    firsts = {}
    for p, c in zip(problems, (engine.batch_shape(*engine.kernel_data(p))
                               for p in problems)):
        firsts.setdefault(c, p)
    for p in firsts.values():                   # the untimed pass
        engine.solve_many([p])
    torch.cuda.synchronize()
    e1 = engine.runners.captures
    seq, seq_lat = [], []
    t0 = time.perf_counter()
    for p in problems:
        t1 = time.perf_counter()
        seq.append(engine.solve_many([p])[0])
        seq_lat.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    e2 = engine.runners.captures
    seq_rps = n_req / seq_wall
    sp50, sp99 = percentiles_ms(np, seq_lat)
    log(f"  serve {method} sequential cold (engine.solve_many([p]) a "
        f"request): {seq_rps:.1f} rps, p50 {sp50:.2f} ms p99 {sp99:.2f} "
        f"ms (a request's own solve, ending in its loop's host read); "
        f"serve speedup (closed loop over "
        f"sequential) {rps / seq_rps:.3f}, without warm starts "
        f"{n_req / cold_wall / seq_rps:.3f}")

    # -- gates --------------------------------------------------------------
    for label, tickets in (("closed", warm_t), ("no-warm", cold_t)):
        undone = sum(not t.done or t.result is None for t in tickets)
        if undone:
            failures.append(f"{method} {label}: {undone} tickets not served")
            continue
        worst = worst_exact = pot = 0.0
        d_iter = 0
        for t, s_ in zip(tickets, seq):
            rel = abs(float(t.result.cost) - float(s_.cost)) / abs(
                float(s_.cost))
            worst = max(worst, rel)
            if t.warm_exact:
                worst_exact = max(worst_exact, rel)
            # a cold lane starts where its sequential solve starts; a
            # warm one is compared up to the constant (f + c, g - c)
            pot = max(pot, potentials_err(torch, t.result, s_,
                                          shift=t.warm_hit))
            if not t.warm_hit:
                d_iter = max(d_iter, abs(int(t.result.n_iter)
                                         - int(s_.n_iter)))
        log(f"  serve {method} {label}: worst cost rel to the sequential "
            f"cold solve {worst:.2e}, exact repeats {worst_exact:.2e}; "
            f"f, g {pot:.2e} of max |value| (warm lanes up to a "
            f"constant); cold lanes' max |d n_iter| {d_iter}")
        if worst > COST_RTOL or worst_exact > SERVE_EXACT_RTOL:
            failures.append(f"{method} {label}: cost rel {worst:.2e} "
                            f"(exact {worst_exact:.2e})")
        if label == "no-warm" and (pot > SERVE_POT_TOL or d_iter > 1):
            failures.append(f"{method} {label}: f, g {pot:.2e}, "
                            f"|d n_iter| {d_iter}")
    if report.completed != n_req:
        failures.append(f"{method} open loop served {report.completed}")
    # a warm lane's padded atoms start at 0, as the JAX package pads them:
    # in scaling space that is u = 1 there, which spoils the first K^T u,
    # so a warm `factored` start saves no iteration on a padded lane (the
    # reference's too) and only must not cost one
    saves = method in SERVE_WARM_SAVES
    if not (w["exact_hits"] and w["near_hits"]
            and (s1["mean_iters_warm"] < s1["mean_iters_cold"] if saves
                 else s1["mean_iters_warm"] <= s1["mean_iters_cold"])):
        failures.append(f"{method}: warm hits {w} and iterations "
                        f"{s1['mean_iters_warm']:.2f} warm, "
                        f"{s1['mean_iters_cold']:.2f} cold")
    snap = svc.runners.snapshot()
    captured = {
        "service runners": svc.runners.loop_stats()["captures"]
        - loops0["captures"],
        "service builds": snap["misses"] - built,
        "service extra_traces": snap["extra_traces"],
        "engine (service loops)": engine_served - engine0,
        "engine (timed sequential)": e2 - e1,
        "RUNNERS": core_runners.RUNNERS.captures - global0,
    }
    log(f"  serve {method} captures after warmup: {captured}")
    if any(captured.values()):
        failures.append(f"{method}: captures after warmup {captured}")
    return failures


def run_serving_path(torch, np, device):
    """Phase 10's counted run, with the launch counters set to 0 just
    before and read just after: both methods' serving runs over one trace
    at the card's width, then the ot_service driver's three lanes
    in-process."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import ot_service
    from repro_torch.serving import TrafficSpec, make_traffic

    t0 = time.perf_counter()
    trace = make_traffic(TrafficSpec(**SERVE_TRACE), device=device)
    torch.cuda.synchronize()
    kinds = {k: sum(r.kind == k for r in trace)
             for k in ("fresh", "repeat", "near")}
    log(f"  trace: {len(trace)} requests {kinds} over "
        f"{SERVE_TRACE['pool_size']} pairs, made in "
        f"{time.perf_counter() - t0:.2f} s")
    failures = []
    reset_launch_counts()
    for method in SERVE_METHODS:
        failures += serve_method(torch, np, method, trace, device)
    for lane in SERVE_LANES:
        t0 = time.perf_counter()
        rc = ot_service.main(list(lane))
        log(f"  ot_service {' '.join(lane)}: rc {rc} in "
            f"{time.perf_counter() - t0:.2f} s")
        if rc != 0:
            failures.append(f"ot_service {' '.join(lane)} returned {rc}")
    counts = launch_counts()
    missing = [k for k in SERVE_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    return counts, failures


# ---------------------------------------------------------------------------
# Phase 11: the autotuner and the sharded solves
# ---------------------------------------------------------------------------

TUNE_CACHE = Path(__file__).resolve().parent / "build" / "tuning" / \
    "tuning.json"
SHARD_DIV_N = 4096              # the divergence's supports (phase 6's n)
SHARD_TIMEOUT_S = 240           # a world's spawn, run and join
SHARD_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep", "feature_contract",
                      "sinkhorn_halfstep", "feature_matvec")


def tuner_keys(torch, np, device):
    """Phase 11(a)'s keys on real inputs: (label, kernel, extents, dtype,
    the wrapper's call, its plain version, the phase-2 tolerance)."""
    from repro_torch.kernels import kermatvec, logmatvec, ref
    from repro_torch.kernels.fused_loop import log_sinkhorn_block
    from repro_torch.kernels.kermatvec import (feature_contract,
                                               sinkhorn_halfstep)
    from repro_torch.kernels.logmatvec import (log_feature_contract,
                                               log_halfstep)

    g = torch.Generator(device=device).manual_seed(11)

    def rand(*shape, lo=0.0):
        return torch.rand(shape, generator=g, device=device) + lo

    keys = []
    for P, n, r in ((32, 1024, 256), (1, N, R_ANCHORS)):
        xi = rand(P, n, r, lo=0.05) if P > 1 else rand(n, r, lo=0.05)
        u = rand(*xi.shape[:-1], 1)
        keys.append((f"flat contract P={P} n={n} r={r} f32",
                     "feature_contract",
                     kermatvec._contract_extents(
                         xi, 1, kermatvec._flat_vectorized(xi, 1)),
                     xi.dtype, lambda xi=xi, u=u: feature_contract(xi, u),
                     lambda xi=xi, u=u: ref.feature_contract_ref(xi, u),
                     dict(rel_to_max=SCALING_REL_TOL)))
    xi = rand(N, R_ANCHORS, lo=0.05)
    t = rand(R_ANCHORS, 1) / R_ANCHORS
    marg = rand(N, 1, lo=0.5) / N
    keys.append((f"row kernel (half-step) n={N} r={R_ANCHORS} f32",
                 "feature_rows",
                 kermatvec._rows_extents(xi, 1, kermatvec._vectorized(xi, 1),
                                         True),
                 xi.dtype, lambda: sinkhorn_halfstep(xi, t, marg),
                 lambda: ref.sinkhorn_halfstep_ref(xi, t, marg),
                 dict(rel_to_max=SCALING_REL_TOL)))
    lw = -4.0 * rand(N, R_ANCHORS)
    s = -rand(N, 1)
    keys.append((f"log contract n={N} r={R_ANCHORS} f32", "log_contract",
                 logmatvec._contract_extents(lw, 1,
                                             logmatvec._vectorized(lw, 1)),
                 lw.dtype, lambda: log_feature_contract(lw, s),
                 lambda: ref.log_feature_contract_ref(lw, s),
                 dict(atol=LSE_ATOL, rtol=LSE_RTOL)))
    lt = -rand(R_ANCHORS, 1)
    lm = -rand(N, 1)
    keys.append((f"log half-step n={N} r={R_ANCHORS} f32", "log_halfstep",
                 logmatvec._halfstep_extents(lw, 1,
                                             logmatvec._vectorized(lw, 1)),
                 lw.dtype, lambda: log_halfstep(lw, lt, lm, scale=0.1),
                 lambda: ref.log_halfstep_ref(lw, lt, lm, scale=0.1),
                 dict(atol=LSE_ATOL, rtol=LSE_RTOL)))
    args = block_inputs(torch, np, GAN_BATCH, GAN_BATCH, 128, D, 0.5,
                        torch.bfloat16, 0, 7, device)
    keys.append((f"log megakernel n=m={GAN_BATCH} r=128 bf16 8 iterations",
                 "log_sinkhorn_block",
                 dict(P=1, n=GAN_BATCH, m=GAN_BATCH, r=128, esize=2),
                 torch.bfloat16,
                 lambda: log_sinkhorn_block(*args, inner_steps=8, eps=0.5),
                 lambda: ref.log_sinkhorn_block_ref(*args, inner_steps=8,
                                                    eps=0.5),
                 dict(atol=LSE_ATOL, rtol=LSE_RTOL)))
    return keys


def held_within(torch, got, want, tol):
    """``got`` against ``want`` (a tensor, or the megakernel's (f, g, t,
    err)) at ``tol``: (max abs error, ok)."""
    if isinstance(got, tuple):
        worst, ok = 0.0, True
        for x, y in zip(got[:3], want[:3]):
            err, good = compare(torch, x, y, **tol)
            worst, ok = max(worst, err), ok and good
        e, w = float(got[3]), float(want[3])
        return worst, ok and abs(e - w) <= 1e-4 * abs(w) + 1e-6
    return compare(torch, got, want, **tol)


def same_bits(torch, x, y):
    if isinstance(x, tuple):
        return all(torch.equal(a, b) for a, b in zip(x, y))
    return torch.equal(x, y)


def run_tuner(torch, np, device):
    """Phase 11(a): tune the keys into a fresh cache with tuning on; hold
    every candidate against the plain version (reruns bit-identical); time
    the static plan and the winner; resolve again from the file alone
    (zero trials); with tuning off every plan is static and the flat
    contract's digest is unchanged."""
    from repro_torch.kernels import autotune

    failures = []
    if SLEEP_MS[0] == 0.0:
        calibrate_sleep(torch)
    digest0 = flat_contract_digest(torch, device)
    keys = tuner_keys(torch, np, device)
    TUNE_CACHE.parent.mkdir(parents=True, exist_ok=True)
    TUNE_CACHE.unlink(missing_ok=True)
    autotune.clear_cache()
    winners = {}
    with autotune.tuning(cache_path=str(TUNE_CACHE)):
        for label, kernel, ext, dtype, call, plain, tol in keys:
            static = autotune.static_plan(kernel, ext)
            cands = autotune.candidates(kernel, ext)
            want = plain()
            for cand in cands:
                with autotune.pinned(kernel, **cand):
                    got, again = call(), call()
                torch.cuda.synchronize()
                err, ok = held_within(torch, got, want, tol)
                same = same_bits(torch, got, again)
                if not (ok and same):
                    failures.append(f"{label} {cand}: err {err:.3e} "
                                    f"repeat identical {same}")
            autotune.reset_stats()
            t0 = time.perf_counter()
            win = autotune.resolve(kernel, ext, dtype, device)
            tune_s = time.perf_counter() - t0
            trials = autotune.stats()["trials"]
            winners[label] = win
            times = {}
            for name, knobs in (("static", static), ("winner", win)):
                with autotune.pinned(kernel, **knobs):
                    times[name] = time_ms(torch, call)
            log(f"  tune {label}: candidates {list(cands)}; static {static}"
                f" {times['static']:.4f} ms, winner {win} "
                f"{times['winner']:.4f} ms (winner/static "
                f"{times['winner'] / times['static']:.3f}); {trials} trials "
                f"in {tune_s:.2f} s; every candidate within its phase-2 "
                f"tolerance, reruns bit-identical")
            if len(cands) > 1 and trials != len(cands):
                failures.append(f"{label}: {trials} trials for "
                                f"{len(cands)} candidates")
        autotune.clear_cache()
        autotune.reset_stats()
        again = {label: autotune.resolve(kernel, ext, dtype, device)
                 for label, kernel, ext, dtype, *_ in keys}
        warm = autotune.stats()
    log(f"  warm cache ({TUNE_CACHE.name}, {len(keys)} keys): {warm}")
    if warm["trials"] or warm["disk_hits"] != len(keys) or again != winners:
        failures.append(f"warm cache: {warm}, plans equal "
                        f"{again == winners}")
    autotune.reset_stats()
    static_ok = all(autotune.resolve(kernel, ext, dtype, device)
                    == autotune.static_plan(kernel, ext)
                    for _, kernel, ext, dtype, *_ in keys)
    digest1 = flat_contract_digest(torch, device)
    log(f"  tuning off: every plan static {static_ok}, trials "
        f"{autotune.stats()['trials']}; flat contract digest unchanged "
        f"{digest1 == digest0}")
    if not static_ok or digest1 != digest0 or autotune.stats()["trials"]:
        failures.append("tuning off: plans or digest changed")
    return failures


def shard_inputs(torch, np, device):
    """Phase 11(b)'s requests, built alike in every process: phase 4's
    annealed request, phase 6's feature problem (r = 1024, eps 0.5) and
    the divergence's clouds (the first 4096 points of phase 4's, r = 1024
    anchors, eps 0.5)."""
    from repro_torch.core import GaussianPointCloud, OTProblem
    main = build_problem(torch, np, 0, device)
    feats = OTProblem.from_features(
        explicit_features(np, N, R_ANCHORS, 2 * R_ANCHORS),
        explicit_features(np, M, R_ANCHORS, 2 * R_ANCHORS + 1),
        eps=SCALING_EPS)
    x, y = clouds(np, 0)
    x, y = x[:SHARD_DIV_N], y[:SHARD_DIV_N]
    R = float(np.max(np.linalg.norm(np.concatenate([x, y]), axis=1)))
    u, _ = anchors_for(torch, np, R_ANCHORS, D, SCALING_EPS, R, 0, "cpu")
    leaves = [torch.as_tensor(v, device=device) for v in (x, y, u.numpy())]
    return main, feats, leaves, R, GaussianPointCloud


def shard_requests(torch, np, device, mesh=None):
    """The three requests, on ``mesh`` or on one device: the annealed
    solve's result and stage iterations, the feature solve's, and the
    divergence with its gradients in x, y and the anchors. Returns
    (results, {name: (wall s, iterations)})."""
    from repro_torch.core import (EpsSchedule, sinkhorn_divergence_geometry,
                                  solve, solve_annealed)
    main, feats, leaves, R, cls = shard_inputs(torch, np, device)
    out, walls = {}, {}
    sync(torch)
    t0 = time.perf_counter()
    ann = solve_annealed(main, schedule=EpsSchedule(eps_init=1.0, decay=0.5),
                         tol=TOL, mesh=mesh)
    sync(torch)
    walls["main"] = (time.perf_counter() - t0, ann.result.n_iter)
    out["main"] = (ann.result, [int(k) for k in ann.stage_iters])
    t0 = time.perf_counter()
    res = solve(feats, tol=0.0, max_iter=SCALING_ITERS, mesh=mesh)
    sync(torch)
    walls["feats"] = (time.perf_counter() - t0, res.n_iter)
    out["feats"] = res
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    t0 = time.perf_counter()
    val = sinkhorn_divergence_geometry(
        cls.build(*leaves, eps=SCALING_EPS, R=R), tol=TOL, mesh=mesh)
    grads = torch.autograd.grad(val, leaves)
    sync(torch)
    walls["div"] = (time.perf_counter() - t0, 0)
    out["div"] = (val.detach(), grads)
    return out, walls


def sync(torch):
    """Wait for the card (a no-op in a CPU rehearsal)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _shard_rank(rank, world, backend, port, src, queue, device="cuda"):
    """One rank of a phase-11 world (a spawned process): join the world,
    run the three requests through the sharded front door with the launch
    counters set to 0 just before and read just after, time the
    collectives of an iteration, and send back what the parent holds."""
    import hashlib
    import traceback
    from datetime import timedelta

    try:
        sys.path.insert(0, src)
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.kernels import backend as kbackend
        if device == "cuda":
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
        else:
            device = torch.device(device)
        kbackend.DEFAULT_DEVICE = str(device)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        if backend == "gloo":
            # gloo must take CUDA tensors for MAX and for all-gather; where
            # it does not, the lane reports it and stops (the run is never
            # staged onto the host)
            try:
                t = torch.full((4,), float(rank), device=device)
                dist.all_reduce(t, op=dist.ReduceOp.MAX)
                parts = [torch.empty(2, device=device) for _ in range(world)]
                dist.all_gather(parts, torch.full((2,), float(rank),
                                                  device=device))
                got = (float(t[0]), [float(p[0]) for p in parts])
            except RuntimeError as exc:
                got = f"{type(exc).__name__}: {exc}"
            if got != (world - 1.0, [float(r) for r in range(world)]):
                queue.put(dict(rank=rank, refused=str(got)))
                return
        from repro_torch.core import sharded
        from repro_torch.distributed import MeshAxis
        from repro_torch.kernels import launch_counts, reset_launch_counts
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(world, device=device)
        plain = {"operators": 0, "log_operators": 0}
        for name in plain:
            orig = getattr(sharded._PsumOps, name)

            def counted(self, *a, _orig=orig, _name=name, **kw):
                plain[_name] += 1
                return _orig(self, *a, **kw)
            setattr(sharded._PsumOps, name, counted)
        shard_requests(torch, np, device, mesh)          # warm: builds, plans
        reset_launch_counts()
        plain.update(operators=0, log_operators=0)
        out, walls = shard_requests(torch, np, device, mesh)
        counts = launch_counts()
        # the envelope VJP's backward applies the log operator, three terms
        solve_plain = dict(plain, log_operators=plain["log_operators"] - 3)
        # the collectives of one iteration: log 2 (MAX, SUM) per combine x 2
        # and the error's SUM; scaling 2 r-vector SUMs and the error's
        axis = MeshAxis(mesh, "data")
        vec = torch.zeros((R_ANCHORS, 1), device=device)
        one = torch.zeros((), device=device)
        coll = {}
        for mode, ops in (("log", (axis.max_, axis.sum_, axis.max_,
                                   axis.sum_)),
                          ("scaling", (axis.sum_, axis.sum_))):
            reps = 200
            sync(torch)
            t0 = time.perf_counter()
            for _ in range(reps):
                for op in ops:
                    op(vec)
                axis.sum_(one)
                float(one)          # the check block's host read
            sync(torch)
            coll[mode] = (time.perf_counter() - t0) / reps * 1e3
        (res, stages), fres = out["main"], out["feats"]
        val, grads = out["div"]
        arrays = [res.f, res.g, fres.f, fres.g, val, *grads]
        h = hashlib.sha256()
        for a in arrays:
            h.update(a.detach().cpu().numpy().tobytes())
        queue.put(dict(
            rank=rank, counts=counts, plain=solve_plain,
            walls=walls, coll=coll, digest=h.hexdigest(),
            main=(float(res.cost), stages, res.f.cpu().numpy()),
            feats=(float(fres.cost), fres.n_iter),
            div=(float(val), [g_.cpu().numpy() for g_ in grads])))
        dist.barrier(**({"device_ids": [0]} if backend == "nccl" else {}))
        dist.destroy_process_group()
    except Exception:
        queue.put(dict(rank=rank, error=traceback.format_exc()))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(world, backend, src, device="cuda"):
    """Spawn a world of ``world`` ranks on card 0 and collect each rank's
    report, or the failure; every process is joined or killed."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, world, backend, port, str(src), q,
                               device))
             for r in range(world)]
    for p in procs:
        p.start()
    reports, deadline = [], time.monotonic() + SHARD_TIMEOUT_S
    try:
        while len(reports) < world:
            try:
                rep = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    return None, f"{backend} world of {world} timed out"
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    return None, f"{backend} world: a rank exited {dead}"
                continue
            if "error" in rep:
                return None, (f"{backend} world rank {rep['rank']}:\n"
                              f"{rep['error']}")
            if "refused" in rep:
                return None, rep
            reports.append(rep)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return sorted(reports, key=lambda r: r["rank"]), None


def run_sharded_path(torch, np, device, src):
    """Phase 11(b): the single-process requests on the card (after a warm
    run, as each rank does), then an NCCL world of 1 and a gloo world of 2
    ranks on the same card, each held against them. Returns (rank 0's
    launch counts of the NCCL world, failures)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    failures = []
    shard_requests(torch, np, device)           # warm: captures, plans
    reset_launch_counts()
    want, walls = shard_requests(torch, np, device)
    single = launch_counts()
    (wres, wstages), wfeats = want["main"], want["feats"]
    wval, wgrads = want["div"]
    log(f"  one process: annealed cost={float(wres.cost):.7f} stages "
        f"{wstages} ({walls['main'][0] / wres.n_iter * 1e3:.4f} ms/iteration"
        f"); features cost={float(wfeats.cost):.7f} "
        f"({walls['feats'][0] / wfeats.n_iter * 1e3:.4f} ms/iteration); "
        f"divergence {float(wval):.7f} ({walls['div'][0]:.3f} s) "
        f"launches={single}")
    nccl_counts = None
    for backend, world in (("nccl", 1), ("gloo", 2)):
        t0 = time.perf_counter()
        reports, err = run_world(world, backend, src, device.type)
        secs = time.perf_counter() - t0
        if isinstance(err, dict):
            log(f"  gloo refuses CUDA tensors for MAX or all-gather "
                f"({err['refused']}): the gloo lane stops here, the NCCL "
                "lane stands")
            continue
        if err:
            failures.append(err)
            log(f"  {backend} world of {world}: FAILED\n{err}")
            continue
        r0 = reports[0]
        (cost, stages, f) = r0["main"]
        fcost, fiters = r0["feats"]
        val, grads = r0["div"]
        same = len({r["digest"] for r in reports}) == 1
        gerr = max(float(np.abs(g - w.cpu().numpy()).max()
                         / max(float(w.abs().max()), 1e-30))
                   for g, w in zip(grads, wgrads))
        fdiff = float(np.abs(f - wres.f.cpu().numpy()).max())
        ok = (abs(cost - float(wres.cost)) <= COST_RTOL * abs(float(wres.cost))
              and len(stages) == len(wstages)
              and all(abs(a - b) <= 1 for a, b in zip(stages, wstages))
              and abs(fcost - float(wfeats.cost))
              <= COST_RTOL * abs(float(wfeats.cost))
              and fiters == wfeats.n_iter
              and abs(val - float(wval)) <= COST_RTOL * abs(float(wval))
              and gerr <= GRAD_REL_TOL and same)
        for r in reports:
            c = r["counts"]
            missing = [k for k in SHARD_PATH_KERNELS if c[k] <= 0]
            mega = c["sinkhorn_block"] + c["log_sinkhorn_block"]
            plain_ops = sum(r["plain"].values())
            log(f"  {backend} rank {r['rank']}/{world}: launches {c}; plain "
                f"operators built in the solves {r['plain']}; megakernel "
                f"launches {mega}")
            if missing or mega or plain_ops:
                failures.append(f"{backend} rank {r['rank']}: kernels "
                                f"missing {missing}, megakernels {mega}, "
                                f"plain operators {r['plain']}")
        wm, wf = r0["walls"]["main"], r0["walls"]["feats"]
        ms_log = wm[0] / wm[1] * 1e3
        ms_sc = wf[0] / wf[1] * 1e3
        log(f"  {backend} world of {world} (card 0): annealed cost={cost:.7f} "
            f"(one process {float(wres.cost):.7f}) stages {stages} (one "
            f"process {wstages}) max |d f| {fdiff:.2e}; features "
            f"cost={fcost:.7f} n_iter {fiters}; divergence {val:.7f} "
            f"(one process {float(wval):.7f}), gradients within "
            f"{gerr:.2e} of max |grad|; every rank equal {same}; "
            f"{'ok' if ok else 'FAIL'}")
        log(f"  {backend} world of {world}: log {ms_log:.4f} ms/iteration, "
            f"its collectives {r0['coll']['log']:.4f} ms (share "
            f"{r0['coll']['log'] / ms_log:.3f}); scaling {ms_sc:.4f} "
            f"ms/iteration, collectives {r0['coll']['scaling']:.4f} ms "
            f"(share {r0['coll']['scaling'] / ms_sc:.3f}); divergence "
            f"{r0['walls']['div'][0]:.3f} s; the world {secs:.1f} s")
        if not ok:
            failures.append(f"{backend} world of {world} disagrees with the "
                            "single-process solves")
        if backend == "nccl":
            nccl_counts = r0["counts"]
    return nccl_counts, failures


LM_ARCH = "smollm-135m"         # the repo's LM example: 30 layers, d 576
LM_BATCH, LM_SEQ = 8, 256       # the drivers' defaults: 2048 tokens a step
LM_STEPS, LM_SAVE_AT = 40, 20   # steps of (c), and the step it saves after
LM_CHECK_BATCH = 2              # (b): 2 x 256 = 512 tokens, the OT loss's n
LM_CE_RTOL = 1e-5
LM_OT_RTOL = 1e-4
LM_GRAD_TOL = 1e-3              # of each leaf's max |grad|
LM_RESUME_RTOL = 1e-4           # resumed losses against the uninterrupted run
LM_PROFILED = 5                 # the last resumed steps, under the profiler
LM_SHARE_PAIRS = 9              # steps with the OT loss on, then off
LM_SERVE_BATCHES = (4, 32)      # launch.serve's default batch, then 32
LM_DECODE_TOL = 1e-4            # decode against prefill, of max |logit|
LM_PATH_KERNELS = ("log_feature_contract", "log_halfstep")


def lm_config():
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def lm_grads(torch, params, cfg, batch, policy):
    """(loss metrics as floats, gradients) of one train_loss."""
    from repro_torch.launch.steps import loss_and_grads
    grads, metrics = loss_and_grads(params, cfg, batch, policy)
    return {k: float(v) for k, v in metrics.items()}, grads


def leaves_within(torch, got, want, tol, label):
    """Names of leaves of ``got`` off ``want`` by more than ``tol`` of the
    leaf's max |value| (``want`` on any device), with the worst ratio."""
    from repro_torch.tree import named_leaves
    want = dict(named_leaves(want))
    bad, worst = [], 0.0
    for name, g in named_leaves(got):
        w = want[name].to(g.device).double()
        err = float((g.double() - w).abs().max()) / max(
            float(w.abs().max()), 1e-30)
        worst = max(worst, err)
        if not err <= tol:
            bad.append(f"{label} {name}: {err:.3g}")
    return bad, worst


def lm_ot_inputs(torch, cfg, device):
    """Phase 12 (a)'s inputs: the OT loss's parameters and batch-8 x
    seq-256 hidden states of width d_model, from seeds."""
    from repro_torch.models.ot_loss import init_ot_loss
    gen = torch.Generator().manual_seed(12)
    p_ot = init_ot_loss(gen, cfg.d_model, ot_dim=cfg.ot_dim,
                        n_protos=cfg.ot_protos, n_features=cfg.ot_features,
                        eps=cfg.ot_eps, device=device)
    h = torch.randn((LM_BATCH, LM_SEQ, cfg.d_model), generator=gen)
    return p_ot, h.to(device)


def lm_ot_loss(torch, cfg, p_ot, h, policy, between=None):
    """(loss, gradients in h and the three OT leaves) of the OT loss;
    ``between()`` runs after the forward, before the backward."""
    from repro_torch.models.ot_loss import ot_prototype_loss
    leaves = {k: v.detach().requires_grad_(True) for k, v in p_ot.items()}
    hh = h.detach().requires_grad_(True)
    loss = ot_prototype_loss(leaves, hh, eps=cfg.ot_eps,
                             n_tokens=cfg.ot_tokens, n_iter=cfg.ot_iters,
                             policy=policy)
    if between is not None:
        between()
    grads = torch.autograd.grad(loss, [hh] + list(leaves.values()))
    return loss.detach(), dict(zip(["h"] + list(leaves), grads))


def check_lm_ot_loss(torch, np, device, cfg):
    """Phase 12 (a): the OT loss at full width on the fused plan (graphs
    on) against the plain operators on the card; launches of rows 6 and 7
    per loss, forward and backward; the loss's ms; the loop's exact stop
    at ``ot_iters``. Returns (failures, ms of one forward + backward)."""
    from repro_torch.core.geometry import FactoredPositive
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.core.sinkhorn import sinkhorn_log_geometry
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.ot_loss import prototype_log_features

    failures = []
    p_ot, h = lm_ot_inputs(torch, cfg, device)
    fused = ExecutionPolicy.from_config(cfg, device=device)
    plain = dataclasses.replace(fused, use_pallas=False)
    with torch.no_grad():
        lx, lz = prototype_log_features(p_ot, h, eps=cfg.ot_eps,
                                        n_tokens=cfg.ot_tokens)
    geom = FactoredPositive(log_xi=lx, log_zeta=lz, eps=cfg.ot_eps)
    n, m = geom.shape
    log(f"  (a) OT loss: {n} tokens of {LM_BATCH} x {LM_SEQ} against "
        f"{m} prototypes, r = {geom.log_xi.shape[1]} (ot_features + the "
        f"kappa column), eps {cfg.ot_eps}, {cfg.ot_iters} iterations, "
        f"tol 0, precision {fused.precision}; policy {fused.describe()}")
    lm_ot_loss(torch, cfg, p_ot, h, fused)          # captures the runner
    torch.cuda.synchronize()
    loop0 = loop_stats()
    fwd = {}

    def read_forward():
        torch.cuda.synchronize()
        fwd.update({k: v for k, v in launch_counts().items() if v})
        reset_launch_counts()

    reset_launch_counts()
    loss_k, grads_k = lm_ot_loss(torch, cfg, p_ot, h, fused, read_forward)
    torch.cuda.synchronize()
    bwd = {k: v for k, v in launch_counts().items() if v}
    loop = loop_delta(loop0, loop_stats())
    log(f"  (a) launches per loss: forward {fwd}, backward {bwd or 0} (the "
        "envelope VJP differentiates the log operator once, in plain "
        f"torch); loop {loop}")
    for k in LM_PATH_KERNELS:
        if fwd.get(k, 0) <= 0:
            failures.append(f"(a) {k} not launched by the OT loss")
    if loop["captures"] != 0:
        failures.append(f"(a) OT loss captured {loop['captures']} loops "
                        "after its first call")
    loss_p, grads_p = lm_ot_loss(torch, cfg, p_ot, h, plain)
    rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    bad, worst = leaves_within(torch, grads_k, grads_p, LM_GRAD_TOL, "(a)")
    log(f"  (a) loss: kernels {float(loss_k):.7f}, plain operators "
        f"{float(loss_p):.7f} (rel {rel:.3g}, bar {LM_OT_RTOL}); gradients "
        f"worst {worst:.3g} of max |grad| (bar {LM_GRAD_TOL})")
    if not rel <= LM_OT_RTOL:
        failures.append(f"(a) OT loss kernels vs plain rel {rel:.3g}")
    failures += bad
    # the loop stops at exactly ot_iters, the graph path bit for bit the
    # eager host loop's
    a = torch.full((n,), 1.0 / n, device=device)
    b = torch.full((m,), 1.0 / m, device=device)
    kw = dict(tol=0.0, max_iter=cfg.ot_iters, precision=fused.precision)
    res_g = sinkhorn_log_geometry(geom, a, b, **kw)
    with eager_loop():
        res_e = sinkhorn_log_geometry(geom, a, b, **kw)
    same = torch.equal(res_g.f, res_e.f) and torch.equal(res_g.g, res_e.g)
    log(f"  (a) solve: n_iter {int(res_g.n_iter)} graphs, "
        f"{int(res_e.n_iter)} eager; potentials bit-identical: {same}")
    if int(res_g.n_iter) != cfg.ot_iters or int(res_e.n_iter) != \
            cfg.ot_iters or not same:
        failures.append("(a) the loop's stop at ot_iters")

    def fwd_bwd():
        lm_ot_loss(torch, cfg, p_ot, h, fused)

    ms = time_ms(torch, fwd_bwd, batches=7, per_batch=3, warmup=1)
    ms_plain = time_ms(torch, lambda: lm_ot_loss(torch, cfg, p_ot, h, plain),
                       batches=7, per_batch=3, warmup=1)
    log(f"  (a) OT loss forward + backward: {ms:.4f} ms on the kernels, "
        f"{ms_plain:.4f} ms on the plain operators")
    return failures, ms


def check_lm_step_card_vs_cpu(torch, np, device, cfg):
    """Phase 12 (b): one full smollm-135m step's loss and gradients on the
    card against the port on the CPU, from one set of weights and one
    batch of 2 x 256."""
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    failures = []
    cpu = torch.device("cpu")
    params_cpu = init_params(cfg, seed=0, device=cpu)
    params = tree_map(lambda t: t.to(device), params_cpu)
    batch_cpu = DataPipeline(DataConfig(0, LM_CHECK_BATCH, LM_SEQ,
                                        cfg.vocab), device=cpu).batch_at(0)
    batch = {k: v.to(device) for k, v in batch_cpu.items()}
    t0 = time.perf_counter()
    m_card, g_card = lm_grads(torch, params, cfg, batch,
                              ExecutionPolicy.from_config(cfg))
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu, g_cpu = lm_grads(torch, params_cpu, cfg, batch_cpu,
                            ExecutionPolicy.from_config(cfg))
    t_cpu = time.perf_counter() - t0
    ce = abs(m_card["ce"] - m_cpu["ce"]) / abs(m_cpu["ce"])
    ot = abs(m_card["ot"] - m_cpu["ot"]) / abs(m_cpu["ot"])
    bad, worst = leaves_within(torch, g_card, g_cpu, LM_GRAD_TOL, "(b)")
    log(f"  (b) one step, {cfg.n_layers} layers, batch {LM_CHECK_BATCH} x "
        f"{LM_SEQ}: ce {m_card['ce']:.7f} card / {m_cpu['ce']:.7f} cpu "
        f"(rel {ce:.3g}, bar {LM_CE_RTOL}); ot {m_card['ot']:.7f} / "
        f"{m_cpu['ot']:.7f} (rel {ot:.3g}, bar {LM_OT_RTOL}); gradients "
        f"worst {worst:.3g} of a leaf's max |grad| (bar {LM_GRAD_TOL}); "
        f"{t_card:.2f} s card (first call), {t_cpu:.2f} s cpu")
    if not ce <= LM_CE_RTOL:
        failures.append(f"(b) ce card vs cpu rel {ce:.3g}")
    if not ot <= LM_OT_RTOL:
        failures.append(f"(b) ot card vs cpu rel {ot:.3g}")
    return failures + bad


def run_lm_training(torch, np, device, cfg, ckpt_dir):
    """Phase 12 (c), the counted run: LM_STEPS steps of smollm-135m at
    LM_BATCH x LM_SEQ through ``make_train_step``, saving (params, AdamW
    state) after step LM_SAVE_AT - 1; then the restore (bit-identical) and
    the resumed steps, the last LM_PROFILED of them under the profiler;
    then LM_SHARE_PAIRS pairs of steps with the OT loss on and off, one
    after the other, for the OT loss's share of a step. Returns (counts,
    failures, summary)."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params, param_count
    from repro_torch.optim import AdamWConfig, init_adamw
    from repro_torch.tree import named_leaves

    failures, parts, mark = [], {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - mark[0]
        mark[0] = now

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    shape = ShapeSpec("phase12", LM_SEQ, LM_BATCH, "train")
    step_fn, _ = make_train_step(cfg, None, shape, AdamWConfig(),
                                 total_steps=LM_STEPS)
    params = init_params(cfg, seed=0, device=device)
    state = (params, init_adamw(params, step_fn.opt))
    data = DataPipeline(DataConfig(0, LM_BATCH, LM_SEQ, cfg.vocab),
                        device=device)
    mgr = CheckpointManager(str(ckpt_dir), keep=2)

    def one(state, step, fn=step_fn):
        p, o, m = fn(state[0], state[1], data.batch_at(step))
        return (p, o), {k: float(v) for k, v in m.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    clear_runners()
    loop0 = loop_stats()
    reset_launch_counts()
    lap("set-up")
    hist, walls, saved = [], [], None
    for step in range(LM_STEPS):
        t0 = time.perf_counter()
        state, m = one(state, step)            # the floats wait for the card
        walls.append((time.perf_counter() - t0) * 1e3)
        hist.append(m)
        if step == 0:
            loop1 = loop_stats()
            lap("step 0")
        if step == LM_SAVE_AT - 1:
            lap("steps 1-39")
            mgr.save(step, state)
            saved = state
            lap("save")
    lap("steps 1-39")
    counts = launch_counts()
    loop = loop_delta(loop1, loop_stats())
    first = loop_delta(loop0, loop1)
    peak = torch.cuda.max_memory_allocated(device)
    ms = statistics.median(walls[-20:])
    tok_s = LM_BATCH * LM_SEQ / (ms / 1e3)
    log(f"  (c) {LM_STEPS} steps of {cfg.name} ({param_count(params)} "
        f"parameters, {cfg.n_layers} layers) at {LM_BATCH} x {LM_SEQ}: "
        f"{ms:.3f} ms a step (median of the last 20), {tok_s:.1f} tokens/s, "
        f"peak memory {peak / 2**30:.3f} GiB; first step "
        f"{walls[0]:.1f} ms")
    log(f"  (c) ce {hist[0]['ce']:.4f} -> {hist[-1]['ce']:.4f}, ot "
        f"{hist[0]['ot']:.4f} -> {hist[-1]['ot']:.4f}, grad norm "
        f"{hist[0]['grad_norm']:.3f} -> {hist[-1]['grad_norm']:.3f}; loops: "
        f"{first} in step 0, {loop} after it; launches {counts}")
    if loop["captures"] != 0:
        failures.append(f"(c) {loop['captures']} captures after step 0")
    if not all(math.isfinite(v) for m in hist for v in m.values()):
        failures.append("(c) non-finite metrics")
    head = statistics.mean(m["ce"] for m in hist[:5])
    tail = statistics.mean(m["ce"] for m in hist[-5:])
    if not tail < head:
        failures.append(f"(c) ce did not fall: {head:.4f} -> {tail:.4f}")
    # the restore is bit-identical to what was saved, and the resumed
    # steps give the uninterrupted run's losses
    restored, man = mgr.restore(None, saved)
    diff = [name for (name, a), (_, b) in zip(named_leaves(saved),
                                              named_leaves(restored))
            if not torch.equal(a, b)]
    log(f"  (c) restore of step {man['step']}: "
        f"{len(named_leaves(saved))} tensors, "
        f"{'bit-identical' if not diff else f'{len(diff)} differ'}")
    if diff or man["step"] != LM_SAVE_AT - 1:
        failures.append(f"(c) restore differs: {diff[:4]}")
    del saved
    lap("restore")
    loop2 = loop_stats()
    state, resumed_m = restored, {}
    for step in range(LM_SAVE_AT, LM_STEPS - LM_PROFILED):
        state, resumed_m[step] = one(state, step)
    lap("resumed steps")

    def profiled():
        nonlocal state
        for step in range(LM_STEPS - LM_PROFILED, LM_STEPS):
            state, resumed_m[step] = one(state, step)

    share, wall, top = busy_share(torch, profiled)
    lap("profiled steps")
    worst = max(abs(m[k] - hist[step][k]) / abs(hist[step][k])
                for step, m in resumed_m.items() for k in ("loss", "ce", "ot"))
    resumed = loop_delta(loop2, loop_stats())
    log(f"  (c) resumed steps {LM_SAVE_AT}-{LM_STEPS - 1}: worst loss / ce "
        f"/ ot rel {worst:.3g} against the uninterrupted run (bar "
        f"{LM_RESUME_RTOL}); loops {resumed}")
    if not worst <= LM_RESUME_RTOL:
        failures.append(f"(c) resumed losses rel {worst:.3g}")
    if resumed["captures"] != 0:
        failures.append("(c) the resumed run captured")
    log(f"  (c) profiled steps {LM_STEPS - LM_PROFILED}-{LM_STEPS - 1}: "
        f"{wall * 1e3:.1f} ms, device busy share "
        f"{'not measured' if share is None else f'{share:.4f}'}; top "
        + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.2f} ms"
                    for e in top[:4]))
    # the OT loss's share of a step: steps with the loss on and off, in
    # turn, from the same state (so under the same load of the host), the
    # side that runs first alternating pair by pair
    off_fn, _ = make_train_step(dataclasses.replace(cfg, ot_loss_weight=0.0),
                                None, shape, AdamWConfig(),
                                total_steps=LM_STEPS)
    loop3 = loop_stats()
    on_ms, off_ms = [], []
    for pair in range(LM_SHARE_PAIRS):
        sides = ((step_fn, on_ms), (off_fn, off_ms))
        for fn, out in sides[::1 if pair % 2 else -1]:   # alternate the lead
            t0 = time.perf_counter()
            one(state, pair, fn)
            out.append((time.perf_counter() - t0) * 1e3)
    paired = loop_delta(loop3, loop_stats())
    if paired["captures"] != 0:
        failures.append("(c) the paired steps captured")
    ms_on = statistics.median(on_ms[1:])
    ms_off = statistics.median(off_ms[1:])
    diffs = [a - b for a, b in zip(on_ms[1:], off_ms[1:])]
    ot_share = statistics.median(diffs) / ms_on
    log(f"  (c) OT loss on / off, {LM_SHARE_PAIRS - 1} pairs of steps after "
        f"one discarded: {ms_on:.3f} / {ms_off:.3f} ms a step (medians); "
        f"on - off by pair {[round(d, 1) for d in diffs]} ms; the OT loss's "
        f"share of a step {ot_share:.4f} (the median difference over the "
        f"median step); loops {paired}")
    lap("paired steps")
    log("  (c) parts (s): " + ", ".join(f"{k} {v:.2f}"
                                        for k, v in parts.items()))
    return counts, failures, dict(ms=ms, tok_s=tok_s, peak=peak,
                                  share=share, ot_share=ot_share)


def check_lm_serving(torch, np, device, cfg):
    """Phase 12 (d): ``launch.serve`` at its defaults (batch 4, prompt 32,
    generate 16) and at batch 32; each decode step's logits against
    ``prefill`` of the same prefix."""
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_caches, prefill
    from repro_torch.models.model import effective_window

    failures = []
    params = None
    for batch in LM_SERVE_BATCHES:
        out = serve.main(["--arch", LM_ARCH, "--batch", str(batch)],
                         params=params)
        params = out["params"]
        seq = torch.cat([out["prompt"], out["generated"]], dim=1)
        T = seq.shape[1]
        caches = init_caches(cfg, batch, T, device=device)
        win = effective_window(cfg, T)
        worst = 0.0
        with torch.no_grad():
            for i in range(T):
                logits, caches = decode_step(params, cfg,
                                             {"tokens": seq[:, i:i + 1]},
                                             caches, window=win)
                ref = prefill(params, cfg, {"tokens": seq[:, :i + 1]})
                err = float((logits - ref).abs().max()) / float(
                    ref.abs().max())
                worst = max(worst, err)
        log(f"  (d) serve batch {batch}: prefill {out['prefill_ms']:.3f} ms "
            f"a token step, decode {out['decode_tok_s']:.1f} tok/s; decode "
            f"vs prefill over {T} prefixes: worst {worst:.3g} of max |logit|"
            f" (bar {LM_DECODE_TOL})")
        if not worst <= LM_DECODE_TOL:
            failures.append(f"(d) batch {batch} decode vs prefill "
                            f"{worst:.3g}")
    return failures


def start_lane(env, args, timeout=300):
    """Start ``python args`` with ``env``; a thread waits for it (at most
    ``timeout`` s, then kills it) and takes the time at which it exited."""
    import threading
    run = dict(args=args, t0=time.perf_counter())
    proc = run["proc"] = subprocess.Popen(
        [sys.executable] + args, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def wait():
        try:
            run["out"], run["err"] = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            run["out"], run["err"] = proc.communicate()
        run["secs"] = time.perf_counter() - run["t0"]

    run["thread"] = threading.Thread(target=wait)
    run["thread"].start()
    return run


def finish_lane(run, part):
    """Join a process of ``start_lane`` and log its output; returns the
    failures (its nonzero exit)."""
    run["thread"].join()
    args, proc = run["args"], run["proc"]
    lines = [ln for ln in run["out"].splitlines() if ln.strip()]
    name = " ".join(args[1:2] + args[-1:] if "--resume" in args
                    else args[1:2])
    log(f"  ({part}) {name}: rc {proc.returncode} in {run['secs']:.1f} s "
        "(start to exit); its output:")
    for line in lines:
        log(f"      {line[:300]}")
    if proc.returncode != 0:
        log("      " + run["err"].strip().replace("\n", "\n      ")[-2000:])
        return [f"({part}) {' '.join(args)} rc {proc.returncode}"]
    return []


def run_lm_drivers(src, build_dir):
    """Phase 12 (e): the train driver then its resume, and beside them the
    example's --strict run, as subprocesses (each host-bound, so the two
    lanes share the card); each must exit 0."""
    import os
    import shutil
    ckpt = build_dir / "lm_driver_ckpt"
    example = build_dir / "lm_example_ckpt"
    for d in (ckpt, example):
        shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(src))
    train = ["-m", "repro_torch.launch.train", "--arch", LM_ARCH, "--steps",
             "10", "--ckpt-dir", str(ckpt)]
    strict = ["-m", "repro_torch.examples.train_lm", "--strict", "--steps",
              "20", "--ckpt-dir", str(example)]
    side = start_lane(env, strict)
    failures = []
    try:
        failures += finish_lane(start_lane(env, train), "e")
        failures += finish_lane(start_lane(env, train + ["--resume"]),
                                  "e")
    finally:
        failures += finish_lane(side, "e")
    return failures


def run_lm_path(torch, np, device, src):
    """Phase 12: the LM surfaces on the card. Returns (the counted run's
    launches, failures)."""
    cfg = lm_config()
    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    failures, ot_ms = timed("a", check_lm_ot_loss, torch, np, device, cfg)
    failures += timed("b", check_lm_step_card_vs_cpu, torch, np, device,
                      cfg)
    build_dir = Path(__file__).resolve().parent / "build"
    counts, more, summary = timed("c", run_lm_training, torch, np, device,
                                  cfg, build_dir / "lm_ckpt")
    failures += more
    missing = [k for k in LM_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    log(f"  (c) the OT loss's share of a step, an estimate from (a)'s loss "
        f"alone: {ot_ms:.4f} / {summary['ms']:.3f} ms = "
        f"{ot_ms / summary['ms']:.4f} (in the step, on / off: "
        f"{summary['ot_share']:.4f})")
    failures += timed("d", check_lm_serving, torch, np, device, cfg)
    failures += timed("e", run_lm_drivers, src, build_dir)
    log("  phase 12 parts (s): " + ", ".join(f"({k}) {v:.1f}"
                                            for k, v in walls.items()))
    return counts, failures


MOE_ARCH = "deepseek_v3_671b"   # full width: d 7168, 128 heads, 256 experts
MOE_DEPTH = dict(n_layers=2, first_k_dense=1)  # one dense MLA layer + one MoE
ROUTE_T = 1024                  # (a): tokens of one router call
ROUTE_CELLS = (("deepseek_v3_671b", 7168, 256, 8),
               ("deepseek_v2_236b", 5120, 160, 6))
ROUTE_TIE_RTOL = 1e-6           # k-th and (k+1)-th plan values this close
ROUTE_COMBINE_TOL = 1e-6
ROUTE_BALANCE_RTOL = 1e-6
MOE_SERVE = (4, 64, 32)         # (b): batch, prompt, generated tokens
MLA_CHECK = (2, 32)             # (b): the f32 MLA layer's batch and sequence
MOE_TRAIN = (2, 256)            # (c): batch x seq of train_loss
MOE_LOSS_RTOL = 1e-4            # (c): use_pallas off against on
MOE_GRAD_TOL = 1e-3             # of each leaf's max |grad| (the OT leaves)
MOE_YARDSTICK = 2.0             # model leaves: x the gap of a 1e-6 OT nudge
MOE_ORACLE = ("deepseek_v2_236b", 256)   # (d): the layer's config, tokens
MOE_ORACLE_TOL = 1e-5           # of max |out|
MOE_PATH_KERNELS = ("log_feature_contract", "log_halfstep")


def host_reads(torch, fn):
    """``(fn(), the host reads it made)``: the synchronizing CUDA calls
    torch's sync debug mode reports (``.item()``, ``float()``, copies to
    the host)."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in seen)


def sliced_rel_err(torch, got, want, slice_=1 << 27):
    """max |got - want| / max |want| in float32, ``got`` (on any device)
    taken to ``want``'s a slice of ``slice_`` elements at a time, so that
    a leaf of billions of elements never has a float32 copy."""
    got, want = got.reshape(-1), want.reshape(-1)
    diff = peak = 0.0
    for lo in range(0, want.numel(), slice_):
        w = want[lo:lo + slice_].float()
        g = got[lo:lo + slice_].to(want.device).float()
        diff = max(diff, float((g - w).abs().max()))
        peak = max(peak, float(w.abs().max()))
    return diff / max(peak, 1e-30)


def moe_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), **MOE_DEPTH)


def check_router(torch, np, device):
    """Phase 13 (a): ``sinkhorn_route`` on seeded float32 logits at v3's
    and v2's width (T = ROUTE_T), the config's bf16 policy and f32, the
    card against the CPU; the non-finite shares of u, v and the plan, the
    load's max / mean against softmax top-k's, the ms and host reads of
    one call."""
    from repro_torch.core import ExecutionPolicy, balanced_plan, \
        sinkhorn_route, stable_top_k
    from repro_torch.models.layers import trunc_normal
    from repro_torch.models.moe import router_probs

    failures = []
    cpu = torch.device("cpu")
    for arch, d, E, k in ROUTE_CELLS:
        gen = torch.Generator().manual_seed(13)
        x = torch.randn((ROUTE_T, d), generator=gen)
        p = {"router": trunc_normal((d, E), 0.02, generator=gen,
                                    device=cpu)}
        logits = x @ p["router"]
        soft, _ = router_probs({"router": p["router"].to(device)},
                               x.to(device), top_k=k)
        soft_load = (soft > 0).float().mean(0)
        for precision in ("bf16", "highest"):
            pol = ExecutionPolicy(precision=precision)
            tag = f"(a) {arch} d {d} E {E} k {k} {precision}"
            card = sinkhorn_route(logits.to(device), top_k=k, policy=pol)
            host = sinkhorn_route(logits, top_k=k, policy=pol)
            res_h, plan_h = balanced_plan(logits, policy=pol)
            res_c, plan_c = balanced_plan(logits.to(device), policy=pol)
            vals, _ = stable_top_k(plan_h, k + 1)
            # a NaN k-th or (k+1)-th value ties too: no order separates them
            near = ~((vals[:, k - 1] - vals[:, k]).abs()
                     > ROUTE_TIE_RTOL * vals[:, k - 1].abs())
            differ = (card.dispatch.cpu() != host.dispatch).any(1)
            off = int((differ & ~near).sum())
            same = ~differ
            comb = float((card.combine.cpu()[same] - host.combine[same]
                          ).abs().max()) if same.any() else 0.0
            bal_c, bal_h = float(card.balance_loss), float(host.balance_loss)
            bal = abs(bal_c - bal_h) / max(abs(bal_h), 1e-30)

            def shares(res, plan):
                return (float((~torch.isfinite(res.u)).float().mean()),
                        float((~torch.isfinite(res.v)).float().mean()),
                        float((~torch.isfinite(plan)).any(1).float().mean()))

            load = card.dispatch.mean(0)
            log(f"  {tag}: dispatch differs from the CPU on "
                f"{int(differ.sum())} of {ROUTE_T} tokens, {int(near.sum())} "
                f"CPU rows tied within {ROUTE_TIE_RTOL} (NaN included), "
                f"{off} differing rows not tied; combine worst {comb:.3g} "
                f"(bar {ROUTE_COMBINE_TOL}); balance {bal_c:.6g} card / "
                f"{bal_h:.6g} cpu (rel {bal:.3g}, bar {ROUTE_BALANCE_RTOL})")
            log(f"  {tag}: non-finite shares u / v / plan rows: card "
                f"{shares(res_c, plan_c)}, cpu {shares(res_h, plan_h)}; load "
                f"max/mean {float(load.max() / load.mean()):.4f} against "
                f"softmax top-k's {float(soft_load.max() / soft_load.mean()):.4f}")
            if off:
                failures.append(f"{tag}: {off} untied rows dispatch "
                                "differently")
            if not comb <= ROUTE_COMBINE_TOL:
                failures.append(f"{tag}: combine {comb:.3g}")
            if not differ.any() and not bal <= ROUTE_BALANCE_RTOL:
                failures.append(f"{tag}: balance rel {bal:.3g}")
        lg = logits.to(device)
        pol = ExecutionPolicy(precision="bf16")
        _, reads = host_reads(torch, lambda: [
            sinkhorn_route(lg, top_k=k, policy=pol) for _ in range(4)])
        ms = time_ms(torch, lambda: sinkhorn_route(lg, top_k=k, policy=pol),
                     batches=7, per_batch=5, warmup=2)
        log(f"  (a) {arch}: one router call (8 iterations, bf16) "
            f"{ms:.4f} ms, {reads / 4:g} host reads (4 calls)")
    return failures


def card_params(torch, cfg, device, seed=0):
    """The config's parameters drawn on the card (a seeded CUDA generator,
    the large leaves in slices), and the seconds it took."""
    from repro_torch.models import init_params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, generator=gen, device=device)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def check_mla_layer(torch, device, cfg):
    """Phase 13 (b), beside serving: one full-width MLA layer in float32,
    ``mla_attend_step`` (the caller writing each slot) and ``mla_decode``
    token by token against ``mla_train`` on the same sequence, at the
    reference's bars (rtol 3e-3, atol 3e-4)."""
    from repro_torch.models.attention import init_mla, init_mla_cache, \
        mla_attend_step, mla_decode, mla_train
    B, S = MLA_CHECK
    kw = dict(n_heads=cfg.n_heads, kv_lora=cfg.kv_lora, qk_nope=cfg.qk_nope,
              qk_rope=cfg.qk_rope, v_head=cfg.v_head,
              rope_theta=cfg.rope_theta)
    gen = torch.Generator(device=device).manual_seed(5)
    p = init_mla(gen, cfg.d_model, cfg.n_heads, kv_lora=cfg.kv_lora,
                 q_lora=cfg.q_lora, qk_nope=cfg.qk_nope, qk_rope=cfg.qk_rope,
                 v_head=cfg.v_head, device=device)
    x = 0.5 * torch.randn((B, S, cfg.d_model), generator=gen, device=device)
    worst = {}
    with torch.no_grad():
        full = mla_train(p, x, **kw)
        cache = init_mla_cache(B, S, kv_lora=cfg.kv_lora,
                               qk_rope=cfg.qk_rope, device=device)
        c_ro, r_ro = cache.c_kv.clone(), cache.k_rope.clone()
        steps, decs = [], []
        for t in range(S):
            o, c_new, r_new = mla_attend_step(
                p, x[:, t:t + 1], c_ro, r_ro,
                torch.tensor(t, device=device), **kw)
            c_ro[:, t], r_ro[:, t] = c_new, r_new
            steps.append(o)
            o, cache = mla_decode(p, x[:, t:t + 1], cache, **kw)
            decs.append(o)
    failures = []
    for name, outs in (("mla_attend_step", steps), ("mla_decode", decs)):
        got = torch.cat(outs, 1)
        excess = float(((got - full).abs()
                        - (3e-4 + 3e-3 * full.abs())).max())
        worst[name] = float((got - full).abs().max())
        if not excess <= 0:
            failures.append(f"(b) {name} against mla_train: {excess:.3g} "
                            "past atol 3e-4 + rtol 3e-3")
    log(f"  (b) one MLA layer at full width (d {cfg.d_model}, {cfg.n_heads} "
        f"heads, kv_lora {cfg.kv_lora}, q_lora {cfg.q_lora}), float32, "
        f"{B} x {S} tokens: max |decode - train| {worst} (max |train| "
        f"{float(full.abs().max()):.4g}; bar atol 3e-4 + rtol 3e-3)")
    return failures


def serve_moe(torch, device, cfg, params):
    """Phase 13 (b): ``launch.steps.make_serve_step``'s prefill step at
    MOE_SERVE's batch x prompt, then its decode step: the prompt fed token
    by token into the MLA caches and greedy tokens generated; logits
    finite."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import init_caches

    B, P, G = MOE_SERVE
    prefill, _ = make_serve_step(cfg, None, ShapeSpec("p", P, B, "prefill"))
    decode, _ = make_serve_step(cfg, None, ShapeSpec("d", P + G, B,
                                                     "decode"))
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab, (B, P), generator=gen).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    finite = torch.ones((), dtype=torch.bool, device=device)
    t0 = time.perf_counter()
    logits = prefill(params, {"tokens": prompt})
    finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    caches = init_caches(cfg, B, P + G, device=device)
    t0 = time.perf_counter()
    for i in range(P):
        logits, caches = decode(params, {"tokens": prompt[:, i:i + 1]},
                                caches)
    torch.cuda.synchronize()
    ingest_ms = (time.perf_counter() - t0) * 1e3 / P
    cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
    (logits, caches), reads = host_reads(
        torch, lambda: decode(params, {"tokens": cur}, caches))
    walls = []
    for _ in range(G - 1):
        finite &= torch.isfinite(logits).all()
        cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
        t0 = time.perf_counter()
        logits, caches = decode(params, {"tokens": cur}, caches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    finite &= torch.isfinite(logits).all()
    peak = torch.cuda.max_memory_allocated(device)
    ms = statistics.median(walls)
    log(f"  (b) serving {cfg.name} ({cfg.n_layers} layers) through "
        f"make_serve_step: prefill {B} x {P} in {prefill_ms:.1f} ms; the "
        f"prompt into the caches {ingest_ms:.3f} ms a token step; decode "
        f"{ms:.3f} ms a token step (median of {G - 1}), "
        f"{B / (ms / 1e3):.1f} tok/s, {reads} host reads a decode step; "
        f"cache length {int(caches[0].length[0])}; peak memory "
        f"{peak / 2**30:.3f} GiB")
    return [] if bool(finite) else ["(b) non-finite serving logits"]


def train_moe(torch, device, cfg, params):
    """Phase 13 (c): ``train_loss`` forward and backward at MOE_TRAIN with
    the OT loss on the kernels (the gradients parked on the host), then:
    the same call again (bit-identical), with ``use_pallas=False`` (the
    plain operators), and on the kernels with ``ot_loss_weight`` scaled by
    1 + 2^-20 (the yardstick: how far a relative change of 1e-6 in the OT
    loss's gradient moves the bf16 gradients); and the OT loss alone on
    the model's hidden states in float32, kernels against plain operators.
    Returns the failures."""
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward
    from repro_torch.tree import named_leaves

    failures = []
    B, S = MOE_TRAIN
    batch = DataPipeline(DataConfig(0, B, S, cfg.vocab),
                         device=device).batch_at(0)
    fused = ExecutionPolicy.from_config(cfg)
    plain = dataclasses.replace(fused, use_pallas=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    m_k, g_k = lm_grads(torch, params, cfg, batch, fused)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    finite = [k for k in ("ce", "aux", "mtp", "ot")
              if not math.isfinite(m_k[k])]
    bad = [n for n, g in named_leaves(g_k)
           if not bool(torch.isfinite(g).all())]
    router = float(g_k["groups"][1]["moe"]["router"].abs().max())
    parked = {n: g.cpu() for n, g in named_leaves(g_k)}
    del g_k

    def gaps(cfg_, policy):
        """(metrics, {leaf: gap to the parked gradients}, ms of the call)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        m, grads = lm_grads(torch, params, cfg_, batch, policy)
        ms = (time.perf_counter() - t) * 1e3
        return m, {n: sliced_rel_err(torch, parked[n], g)
                   for n, g in named_leaves(grads)}, ms

    _, rerun, ms = gaps(cfg, fused)
    m_p, gap, _ = gaps(cfg, plain)
    nudged = dataclasses.replace(
        cfg, ot_loss_weight=cfg.ot_loss_weight * (1 + 2 ** -20))
    _, yard, _ = gaps(nudged, fused)
    del parked
    rel = abs(m_k["loss"] - m_p["loss"]) / abs(m_p["loss"])
    # the OT leaves' gradients are float32 end to end; every other leaf's
    # (the float32 router's too) comes through the bf16 backward
    f32 = [n for n in gap if n.startswith("ot/")]
    bf16 = [n for n in gap if n not in f32]

    def worst(d, names):
        name = max(names, key=lambda n: d[n])
        return f"{d[name]:.3g} ({name})"

    # the OT loss alone on the model's final hidden states, in float32
    with torch.no_grad():
        h, _ = forward(params, cfg, batch)
    loss_k, ot_k = lm_ot_loss(torch, cfg, params["ot"], h.float(), fused)
    loss_p, ot_p = lm_ot_loss(torch, cfg, params["ot"], h.float(), plain)
    ot_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    ot_off, ot_worst = leaves_within(torch, ot_k, ot_p, MOE_GRAD_TOL, "(c)")
    path = {k: v for k, v in counts.items() if v}
    log(f"  (c) train_loss forward + backward of {cfg.name} at {B} x {S}: "
        f"ce {m_k['ce']:.6f}, aux {m_k['aux']:.6f}, mtp {m_k['mtp']:.6f}, "
        f"ot {m_k['ot']:.6f}, loss {m_k['loss']:.6f}; {ms:.1f} ms (first "
        f"call {first_ms:.1f} ms), peak memory {peak / 2**30:.3f} GiB; "
        f"launches {path}; router max |grad| {router:.4g}; non-finite "
        f"gradient leaves {bad}")
    log(f"  (c) use_pallas=False: loss {m_p['loss']:.6f} (rel {rel:.3g}, bar "
        f"{MOE_LOSS_RTOL}); gradients, of each leaf's max |grad|: the OT "
        f"leaves (float32 end to end) worst {worst(gap, f32)} (bar "
        f"{MOE_GRAD_TOL}); the model's leaves (the bf16 backward) worst "
        f"{worst(gap, bf16)}, against the yardstick's {worst(yard, bf16)} "
        f"(ot_loss_weight x (1 + 2^-20) on the kernels; its OT leaves "
        f"{worst(yard, f32)}) and a rerun's {worst(rerun, list(rerun))}")
    log(f"  (c) the OT loss alone on the model's hidden states (float32, "
        f"d {cfg.d_model}): loss {float(loss_k):.7f} kernels / "
        f"{float(loss_p):.7f} plain (rel {ot_rel:.3g}, bar "
        f"{MOE_LOSS_RTOL}); gradients in h and the OT leaves worst "
        f"{ot_worst:.3g} of max |grad| (bar {MOE_GRAD_TOL})")
    if finite:
        failures.append(f"(c) non-finite metrics {finite}")
    if bad:
        failures.append(f"(c) non-finite gradients {bad[:4]}")
    if not router > 0:
        failures.append("(c) the router's gradient is zero")
    if not rel <= MOE_LOSS_RTOL or not ot_rel <= MOE_LOSS_RTOL:
        failures.append(f"(c) loss on / off the kernels rel {rel:.3g}, "
                        f"the OT loss alone {ot_rel:.3g}")
    failures += [f"(c) {n}: {gap[n]:.3g}" for n in f32
                 if not gap[n] <= MOE_GRAD_TOL] + ot_off
    if max(rerun.values()) != 0:
        failures.append(f"(c) a rerun's gradients differ: "
                        f"{worst(rerun, list(rerun))}")
    if not max(gap[n] for n in bf16) <= max(
            MOE_GRAD_TOL, MOE_YARDSTICK * max(yard[n] for n in bf16)):
        failures.append(f"(c) model gradients {worst(gap, bf16)} past "
                        f"{MOE_YARDSTICK} x the yardstick's "
                        f"{worst(yard, bf16)}")
    return failures


def check_moe_oracle(torch, device):
    """Phase 13 (d): one full-width MoE layer of MOE_ORACLE's config in
    float32 (``moe_dense``, the Sinkhorn router) against an oracle that
    loops over the experts and runs each on the tokens dispatched to it
    alone."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.models.moe import init_moe, moe_dense, router_probs

    arch, T = MOE_ORACLE
    cfg = get_config(arch)
    gen = torch.Generator(device=device).manual_seed(3)
    p = init_moe(gen, cfg.d_model, cfg.moe_d_ff, cfg.n_experts,
                 device=device)
    x = torch.randn((T, cfg.d_model), generator=gen, device=device)
    pol = ExecutionPolicy.from_config(cfg)
    with torch.no_grad():
        out, aux = moe_dense(p, x, top_k=cfg.top_k, router=cfg.router,
                             policy=pol)
        combine, _ = router_probs(p, x, top_k=cfg.top_k, router=cfg.router,
                                  policy=pol)
        want = torch.zeros_like(x)
        for e in range(cfg.n_experts):
            tok = torch.nonzero(combine[:, e] > 0)[:, 0]
            if tok.numel():
                xe = x[tok]
                ye = (F.silu(xe @ p["gate"][e]) * (xe @ p["up"][e])
                      ) @ p["down"][e]
                want.index_add_(0, tok, ye * combine[tok, e, None])
    err = float((out - want).abs().max()) / float(want.abs().max())
    log(f"  (d) one MoE layer of {arch} (d {cfg.d_model}, {cfg.n_experts} "
        f"experts of d_ff {cfg.moe_d_ff}, top-{cfg.top_k}, "
        f"{p['up'].numel() * 3 * 4 / 2**30:.2f} GiB of float32 experts), "
        f"{T} tokens: moe_dense against the expert-loop oracle "
        f"{err:.3g} of max |out| (bar {MOE_ORACLE_TOL}); aux {float(aux):.6f}")
    return [] if err <= MOE_ORACLE_TOL else [f"(d) oracle {err:.3g}"]


def run_moe_lanes(src, build_dir):
    """Phase 13 (e): ``launch.train``, ``launch.serve`` and
    ``examples.train_lm`` on the tiny MoE configs, side by side as
    subprocesses; each must exit 0."""
    import os
    import shutil
    example = build_dir / "moe_example_ckpt"
    shutil.rmtree(example, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(src))
    lanes = [
        ["-m", "repro_torch.launch.train", "--arch", "deepseek_v3_671b",
         "--tiny", "--steps", "4", "--batch", "2", "--seq", "64",
         "--log-every", "1"],
        ["-m", "repro_torch.launch.serve", "--arch", "deepseek_v2_236b",
         "--tiny"],
        ["-m", "repro_torch.examples.train_lm", "--arch", "deepseek_v3_671b",
         "--tiny", "--strict", "--steps", "20", "--ckpt-dir", str(example)],
    ]
    runs = [start_lane(env, args) for args in lanes]
    failures = []
    for run in runs:
        failures += finish_lane(run, "e")
    return failures


def run_moe_path(torch, np, device, src):
    """Phase 13: the MoE family at deepseek-v3's full width. Returns (the
    launches of (b) and (c), failures)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import param_count

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    failures = timed("a", check_router, torch, np, device)
    cfg = moe_config()
    params, init_s = timed("init", card_params, torch, cfg, device)
    log(f"  {cfg.name} at {cfg.n_layers} layers ({cfg.layer_plan()} + the "
        f"MTP block): {param_count(params) / 1e9:.3f} G parameters, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB on the card,"
        f" drawn on the card in {init_s:.2f} s")
    reset_launch_counts()
    failures += timed("b", serve_moe, torch, device, cfg, params)
    failures += timed("b mla", check_mla_layer, torch, device, cfg)
    failures += timed("c", train_moe, torch, device, cfg, params)
    counts = launch_counts()
    missing = [k for k in MOE_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    del params
    torch.cuda.empty_cache()
    failures += timed("d", check_moe_oracle, torch, device)
    torch.cuda.empty_cache()
    build_dir = Path(__file__).resolve().parent / "build"
    failures += timed("e", run_moe_lanes, src, build_dir)
    log("  phase 13 parts (s): " + ", ".join(f"({k}) {v:.1f}"
                                            for k, v in walls.items()))
    return counts, failures


SSM_ARCHS = ("mamba2_1p3b", "zamba2_1p2b")   # full width and full depth
SSM_MIXER = (2, 300)            # (a): batch, tokens (3 chunks, a padded tail)
SSM_MIXER_TOL = 1e-4            # (a): of max |out|; also rtol 3e-3 + atol 3e-4
SSM_CHECK = (2, 256)            # (b): batch x seq, card against the CPU
SSM_CHECK_DEPTH = {"mamba2_1p3b": 4, "zamba2_1p2b": 12}  # 12: two shared uses
SSM_TRAIN = (8, 256)            # (c), (d): batch x seq
SSM_STEPS = 12                  # (d): the driver's two halves of 6 steps
SSM_PROFILED = 2                # (d): the uninterrupted run's last steps, profiled
SSM_SHARE_PAIRS = 3             # (d): steps with the OT loss on, then off
SSM_SERVE = (4, 64, 16)         # (e): batch, prompt, generated tokens
SSM_WRAP = (64, 96)             # (f): zamba2's window, decode steps
SSM_LONG_REPEATS = 5            # (f): timed decode steps a position
SSM_PATH_KERNELS = ("log_feature_contract", "log_halfstep")


def f32_config(arch, **over):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), param_dtype="float32",
                               compute_dtype="float32", **over)


def rel_to_max(torch, got, want):
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def check_ssd_forms(torch, device, cfg):
    """Phase 14 (a): one full-width Mamba2 mixer of ``cfg`` on SSM_MIXER's
    batch x tokens: ``mamba2_train`` (the chunked SSD) against
    ``mamba2_decode`` stepped token by token, and ``ssd_chunked``'s final
    state against the decode state after the last token."""
    from repro_torch.models.ssm import init_mamba2, init_mamba2_cache, \
        mamba2_decode, mamba2_train, ssd_chunked, ssd_inputs

    B, S = SSM_MIXER
    kw = dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim,
              expand=cfg.ssm_expand)
    gen = torch.Generator(device=device).manual_seed(14)
    p = init_mamba2(gen, cfg.d_model, conv_kernel=cfg.conv_kernel,
                    device=device, **kw)
    x = 0.5 * torch.randn((B, S, cfg.d_model), generator=gen, device=device)
    with torch.no_grad():
        full = mamba2_train(p, x, chunk=cfg.ssm_chunk, **kw)
        _, final = ssd_chunked(*ssd_inputs(p, x, **kw)[1:],
                               chunk=cfg.ssm_chunk)
        cache = init_mamba2_cache(B, cfg.d_model, conv_kernel=cfg.conv_kernel,
                                  device=device, **kw)
        outs = []
        for t in range(S):
            out, cache = mamba2_decode(p, x[:, t:t + 1], cache, **kw)
            outs.append(out)
        dec = torch.cat(outs, dim=1)
    err = rel_to_max(torch, dec, full)
    state_err = rel_to_max(torch, cache.state, final)
    ref_bar = bool(torch.allclose(dec, full, rtol=3e-3, atol=3e-4)) and \
        bool(torch.allclose(cache.state, final, rtol=3e-3, atol=3e-4))
    log(f"  (a) one {cfg.name} mixer (d {cfg.d_model}, {cfg.ssm_heads} heads "
        f"of {cfg.ssm_head_dim}, N {cfg.ssm_state}, chunk {cfg.ssm_chunk}) "
        f"on {B} x {S} tokens: {S} decode steps against mamba2_train "
        f"{err:.3g} of max |out| ({float(full.abs().max()):.4g}); the decode "
        f"state against ssd_chunked's final {state_err:.3g} of max |state|"
        f" (bar {SSM_MIXER_TOL}; the reference's rtol 3e-3 + atol 3e-4: "
        f"{'held' if ref_bar else 'MISSED'})")
    if not (err <= SSM_MIXER_TOL and state_err <= SSM_MIXER_TOL and ref_bar):
        return [f"(a) decode vs train {err:.3g}, state {state_err:.3g}"]
    return []


def check_card_vs_cpu(torch, device, cfg, B, S):
    """Phases 14 and 15 (b): one ``train_loss`` forward and backward at B x
    S on the card against the port's CPU path, the same weights (the
    CPU's seeded draw, copied to the card) and the pipeline's batch at
    step 0; phase 12's bars on ``ce``, ``ot`` and every gradient leaf."""
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map

    arch = cfg.name
    cpu = torch.device("cpu")
    params_cpu = init_params(cfg, seed=0, device=cpu)
    params = tree_map(lambda t: t.to(device), params_cpu)
    batch_cpu = ssm_batch(torch, cfg, cpu, B, S)
    batch = {k: v.to(device) for k, v in batch_cpu.items()}
    policy = ExecutionPolicy.from_config(cfg)
    t0 = time.perf_counter()
    m_card, g_card = lm_grads(torch, params, cfg, batch, policy)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_cpu, g_cpu = lm_grads(torch, params_cpu, cfg, batch_cpu, policy)
    t_cpu = time.perf_counter() - t0
    ce = abs(m_card["ce"] - m_cpu["ce"]) / abs(m_cpu["ce"])
    ot = abs(m_card["ot"] - m_cpu["ot"]) / abs(m_cpu["ot"])
    bad, worst = leaves_within(torch, g_card, g_cpu, LM_GRAD_TOL, "(b)")
    enc = f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else ""
    log(f"  (b) {arch} at {cfg.n_layers} layers{enc} ({cfg.layer_plan()}), "
        f"{B} x {S}: ce {m_card['ce']:.7f} card / {m_cpu['ce']:.7f} cpu "
        f"(rel {ce:.3g}, bar {LM_CE_RTOL}); ot {m_card['ot']:.7f} / "
        f"{m_cpu['ot']:.7f} (rel {ot:.3g}, bar {LM_OT_RTOL}); gradients "
        f"worst {worst:.3g} of a leaf's max |grad| (bar {LM_GRAD_TOL}); "
        f"{t_card:.2f} s card, {t_cpu:.2f} s cpu")
    failures = bad
    if not ce <= LM_CE_RTOL:
        failures.append(f"(b) {arch} ce card vs cpu rel {ce:.3g}")
    if not ot <= LM_OT_RTOL:
        failures.append(f"(b) {arch} ot card vs cpu rel {ot:.3g}")
    return failures


def ssm_batch(torch, cfg, device, B, S, step=0):
    from repro_torch.data import DataConfig, DataPipeline
    return DataPipeline(DataConfig(seed=0, global_batch=B, seq_len=S,
                                   vocab=cfg.vocab, input_kind=cfg.input_kind,
                                   d_model=cfg.d_model),
                        device=device).batch_at(step)


def check_ssm_ot_kernels(torch, device, cfg, params,
                         kernels=SSM_PATH_KERNELS):
    """Phases 14 and 15 (c): ``train_loss`` forward and backward at full
    depth and SSM_TRAIN with the OT loss on the kernels, its launches of
    ``kernels`` (rows 6-7), then with ``use_pallas=False``: the loss 1e-4
    relative, every gradient 1e-3 of its leaf's max."""
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.kernels import launch_counts

    B, S = SSM_TRAIN
    enc = f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else ""
    batch = ssm_batch(torch, cfg, device, B, S)
    fused = ExecutionPolicy.from_config(cfg)
    plain = dataclasses.replace(fused, use_pallas=False)
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    m_k, g_k = lm_grads(torch, params, cfg, batch, fused)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    per_call = {k: v for k, v in counts_delta(before, launch_counts()).items()
                if v}
    t0 = time.perf_counter()
    m_k, g_k = lm_grads(torch, params, cfg, batch, fused)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    m_p, g_p = lm_grads(torch, params, cfg, batch, plain)
    rel = abs(m_k["loss"] - m_p["loss"]) / abs(m_p["loss"])
    ot_rel = abs(m_k["ot"] - m_p["ot"]) / abs(m_p["ot"])
    bad, worst = leaves_within(torch, g_k, g_p, MOE_GRAD_TOL, "(c)")
    _, ot_worst = leaves_within(torch, g_k["ot"], g_p["ot"], MOE_GRAD_TOL,
                                "(c) ot")
    log(f"  (c) {cfg.name} train_loss forward + backward at {B} x {S}, "
        f"{cfg.n_layers} layers{enc}: ce {m_k['ce']:.6f}, ot {m_k['ot']:.6f}, "
        f"loss {m_k['loss']:.6f}; {ms:.1f} ms (first call {first_ms:.1f} "
        f"ms); launches a call {per_call}; use_pallas=False: loss rel "
        f"{rel:.3g}, ot rel {ot_rel:.3g} (bar {MOE_LOSS_RTOL}); gradients "
        f"worst {worst:.3g} of a leaf's max (the OT leaves {ot_worst:.3g}; "
        f"bar {MOE_GRAD_TOL})")
    failures = bad
    for k in kernels:
        if per_call.get(k, 0) <= 0:
            failures.append(f"(c) {k} not launched by train_loss")
    if not rel <= MOE_LOSS_RTOL:
        failures.append(f"(c) loss kernels vs plain rel {rel:.3g}")
    return failures


def train_ssm(torch, device, cfg, build_dir, resume):
    """Phases 14 and 15 (d): the ``launch.train`` driver in-process at
    SSM_TRAIN with AdamW for the first half of SSM_STEPS; its final state
    goes on uninterrupted through the driver's own step
    (``make_train_step``, the same horizon and data) for the second half,
    timed, its last SSM_PROFILED
    steps under the profiler; then SSM_SHARE_PAIRS pairs of steps with the
    OT loss on and off. With ``resume`` (zamba2: its tree, with the shared
    block's empty groups; whisper-base: its encoder, learned positions and
    cross-attention; trees phase 12's checkpoint has not carried) the
    first half ends in a checkpoint and ``--resume`` from it runs the
    second half again, its losses within 1e-4 relative of the uninterrupted
    ones; without it no checkpoint is written (each full-size transfer
    costs ~20 s)."""
    import shutil
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig

    B, S = SSM_TRAIN
    half = SSM_STEPS // 2
    ck = build_dir / f"ssm_ckpt_{cfg.name}"
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", cfg.name, "--batch", str(B), "--seq", str(S),
            "--steps", str(half), "--log-every", "1"]
    if resume:
        base += ["--save-every", str(10 ** 6), "--ckpt-dir", str(ck)]
    t0 = time.perf_counter()
    first = train.main(base)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    state = first.pop("state")

    shape = ShapeSpec("phase14", S, B, "train")
    step_fn, _ = make_train_step(cfg, None, shape, AdamWConfig(),
                                 total_steps=half)

    def one(state, step, fn=step_fn):
        p, o, m = fn(state[0], state[1], ssm_batch(torch, cfg, device, B, S,
                                                   step))
        return (p, o), {k: float(v) for k, v in m.items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    hist, ms = [], []
    for step in range(half, SSM_STEPS - SSM_PROFILED):
        t0 = time.perf_counter()
        state, m = one(state, step)
        ms.append((time.perf_counter() - t0) * 1e3)
        hist.append(m)

    def profiled():
        nonlocal state
        for step in range(SSM_STEPS - SSM_PROFILED, SSM_STEPS):
            state, m = one(state, step)
            hist.append(m)

    share, wall, top = busy_share(torch, profiled)
    peak = torch.cuda.max_memory_allocated(device)
    step_ms = statistics.median(ms[1:])
    log(f"  (d) {cfg.name}, {B} x {S}: steps {half}-{SSM_STEPS - 1} "
        f"uninterrupted: {step_ms:.1f} ms a step (median of steps "
        f"{half + 1}-{SSM_STEPS - SSM_PROFILED - 1}), "
        f"{B * S / (step_ms / 1e3):.1f} tokens/s, peak memory "
        f"{peak / 2**30:.3f} GiB; ce {first['losses'][0]['ce']:.4f} -> "
        f"{hist[-1]['ce']:.4f}, ot {first['losses'][0]['ot']:.4f} -> "
        f"{hist[-1]['ot']:.4f}; {SSM_PROFILED} profiled steps "
        f"{wall * 1e3:.1f} ms, busy share "
        f"{'not measured' if share is None else f'{share:.4f}'}; top "
        + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
                    for e in top[:4]))
    off_fn, _ = make_train_step(dataclasses.replace(cfg, ot_loss_weight=0.0),
                                None, shape, AdamWConfig(), total_steps=half)
    on_ms, off_ms = [], []
    for pair in range(SSM_SHARE_PAIRS):
        sides = ((step_fn, on_ms), (off_fn, off_ms))
        for fn, out in sides[::1 if pair % 2 else -1]:   # alternate the lead
            t0 = time.perf_counter()
            one(state, pair, fn)
            out.append((time.perf_counter() - t0) * 1e3)
    diffs = [a - b for a, b in zip(on_ms[1:], off_ms[1:])]
    log(f"  (d) {cfg.name} OT loss on / off, {SSM_SHARE_PAIRS - 1} pairs "
        f"after one discarded: {[round(v, 1) for v in on_ms[1:]]} / "
        f"{[round(v, 1) for v in off_ms[1:]]} ms; the OT loss's share of a "
        f"step {statistics.median(diffs) / statistics.median(on_ms[1:]):.4f}")
    del state
    torch.cuda.empty_cache()
    failures = []
    if not all(math.isfinite(v) for m in hist + first["losses"]
               for v in m.values()):
        failures.append("(d) non-finite metrics")
    if not resume:
        log(f"  (d) {cfg.name} launch.train: steps 0-{half - 1} in "
            f"{t_first:.1f} s (no checkpoint)")
        if [d["step"] for d in first["losses"]] != list(range(half)):
            failures.append("(d) the driver's logged steps")
        return failures

    ck_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    again = train.main(base + ["--resume"])
    torch.cuda.synchronize()
    t_again = time.perf_counter() - t0
    del again["state"]
    shutil.rmtree(ck, ignore_errors=True)
    resumed = again["losses"]
    worst = max(abs(d[k] - h[k]) / abs(h[k]) for d, h in zip(resumed, hist)
                for k in ("loss", "ce", "ot"))
    log(f"  (d) {cfg.name} launch.train: steps 0-{half - 1} and a "
        f"checkpoint ({ck_bytes / 2**30:.2f} GiB) in {t_first:.1f} s; "
        f"--resume from step {again['start'] - 1}: steps "
        f"{resumed[0]['step']}-{resumed[-1]['step']} and a checkpoint in "
        f"{t_again:.1f} s; its losses against the uninterrupted steps: "
        f"worst loss / ce / ot rel {worst:.3g} (bar {LM_RESUME_RTOL})")
    if [d["step"] for d in first["losses"] + resumed] != list(
            range(SSM_STEPS)):
        failures.append("(d) the driver's logged steps")
    if not worst <= LM_RESUME_RTOL:
        failures.append(f"(d) resumed vs uninterrupted losses {worst:.3g}")
    if not all(math.isfinite(v) for m in resumed for v in m.values()):
        failures.append("(d) non-finite metrics after --resume")
    return failures


def serve_ssm(torch, device, cfg, params):
    """Phase 14 (e): ``launch.serve`` at SSM_SERVE on the phase's weights;
    then the prompt and the generated tokens decoded again from fresh
    caches, each step's logits against the forward over the whole
    sequence at that position (a causal model: ``prefill`` of each
    prefix), within LM_DECODE_TOL of max |logit|."""
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, forward, init_caches
    from repro_torch.models.model import _logits, effective_window

    B, P, G = SSM_SERVE
    out = serve.main(["--arch", cfg.name, "--batch", str(B), "--prompt-len",
                      str(P), "--gen", str(G)], params=params)
    seq = torch.cat([out["prompt"], out["generated"]], dim=1)
    T = seq.shape[1]
    caches = init_caches(cfg, B, T, device=device)
    win = effective_window(cfg, T)
    worst = 0.0
    with torch.no_grad():
        h, _ = forward(params, cfg, {"tokens": seq})
        ref = _logits(params, cfg, h)
        for i in range(T):
            logits, caches = decode_step(params, cfg,
                                         {"tokens": seq[:, i:i + 1]}, caches,
                                         window=win)
            worst = max(worst, rel_to_max(torch, logits[:, 0], ref[:, i]))
    ms = out["decode_s"] * 1e3 / G
    log(f"  (e) {cfg.name} launch.serve batch {B}, prompt {P}: prefill "
        f"{out['prefill_ms']:.3f} ms a token step, decode {ms:.3f} ms a "
        f"token step, {out['decode_tok_s']:.1f} tok/s; decode vs prefill "
        f"over {T} positions: worst {worst:.3g} of max |logit| (bar "
        f"{LM_DECODE_TOL})")
    return [] if worst <= LM_DECODE_TOL else [
        f"(e) {cfg.name} decode vs prefill {worst:.3g}"]


def ssm_long_caches(torch, device):
    """Phase 14 (f), first part: the ``long_500k`` caches of both configs
    on ``meta`` (``launch.specs.cache_specs``): their bytes, and zamba2's
    shared-attention caches the 4096-slot rolling buffer."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.specs import cache_specs
    from repro_torch.models.attention import GQACache
    from repro_torch.models.model import effective_window

    shape = SHAPES["long_500k"]
    failures = []
    for arch in SSM_ARCHS:
        cfg = f32_config(arch)
        caches = cache_specs(cfg, shape)
        kinds = collections.Counter(type(c).__name__ for c in caches)
        nbytes = collections.Counter()
        for c in caches:
            nbytes[type(c).__name__] += sum(t.numel() * t.element_size()
                                            for t in c)
        gqa = [c for c in caches if isinstance(c, GQACache)]
        slots = sorted({c.k.shape[1] for c in gqa})
        win = effective_window(cfg, shape.seq_len)
        log(f"  (f) {arch} long_500k (S = {shape.seq_len}, batch "
            f"{shape.global_batch}) caches: {dict(kinds)}, "
            + ", ".join(f"{k} {v / 1e6:.1f} MB" for k, v in nbytes.items())
            + f"; shared-attention slots {slots}, window {win}")
        if arch.startswith("zamba2") and (
                len(gqa) != 6 or slots != [cfg.long_context_window] or
                win != 4096):
            failures.append(f"(f) zamba2's long_500k shared caches: "
                            f"{len(gqa)} of slots {slots}, window {win}")
    return failures


def check_ssm_wrap(torch, device, cfg, params):
    """Phase 14 (f): zamba2 at full width and depth with a window of
    SSM_WRAP[0] slots: SSM_WRAP[1] decode steps, each step's logits against
    the forward with the same window at that position (1e-4 of max
    |logit|), the rolling buffer wrapping after SSM_WRAP[0] tokens."""
    from repro_torch.models import decode_step, forward, init_caches
    from repro_torch.models.attention import GQACache
    from repro_torch.models.model import _logits, effective_window

    window, T = SSM_WRAP
    cfg = dataclasses.replace(cfg, window=window)
    tok = torch.randint(0, cfg.vocab, (2, T),
                        generator=torch.Generator().manual_seed(14))
    tok = tok.to(device)
    caches = init_caches(cfg, 2, 524288, device=device)
    win = effective_window(cfg, 524288)
    slots = {c.k.shape[1] for c in caches if isinstance(c, GQACache)}
    worst = 0.0
    with torch.no_grad():
        ref = _logits(params, cfg, forward(params, cfg, {"tokens": tok})[0])
        for i in range(T):
            logits, caches = decode_step(params, cfg,
                                         {"tokens": tok[:, i:i + 1]}, caches,
                                         window=win)
            worst = max(worst, rel_to_max(torch, logits[:, 0], ref[:, i]))
    log(f"  (f) {cfg.name} window {win} (cache slots {sorted(slots)}), {T} "
        f"decode steps against the windowed forward: worst {worst:.3g} of "
        f"max |logit| (bar {LM_DECODE_TOL})")
    return [] if worst <= LM_DECODE_TOL and slots == {window} else [
        f"(f) wrap {worst:.3g}, slots {slots}"]


def time_long_decode(torch, device, cfg, params):
    """Phase 14 (f): one decode step on real ``long_500k`` caches (batch
    1) with every ``length`` set to 64, then to 524287: a timing only (the
    buffers hold zeros, not a 524k-token history). Median host ms of
    SSM_LONG_REPEATS steps, each to a sync."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import decode_step, init_caches
    from repro_torch.models.model import effective_window

    shape = SHAPES["long_500k"]
    caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                         device=device)
    held = sum(t.numel() * t.element_size() for c in caches for t in c)
    win = effective_window(cfg, shape.seq_len)
    tok = torch.zeros((shape.global_batch, 1), dtype=torch.long,
                      device=device)
    out = {}
    with torch.no_grad():
        for pos in (64, shape.seq_len - 1):
            walls = []
            for _ in range(SSM_LONG_REPEATS + 1):
                for c in caches:
                    c.length.fill_(pos)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                decode_step(params, cfg, {"tokens": tok}, caches, window=win)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            out[pos] = statistics.median(walls[1:])
    log(f"  (f) {cfg.name} long_500k decode step (timing only: seeded "
        f"buffers, no real history), {held / 1e6:.1f} MB of caches on the "
        f"card, window {win}: "
        + ", ".join(f"length {k}: {v:.3f} ms" for k, v in out.items()))
    return []


def run_ssm_lanes(src, build_dir):
    """Phase 14 (g): the drivers on the tiny ssm and hybrid configs on the
    card, side by side as subprocesses: ``examples.train_lm --strict`` for
    each, ``launch.train`` on zamba2's and ``launch.serve`` on mamba2's;
    each must exit 0."""
    import os
    import shutil
    env = dict(os.environ, PYTHONPATH=str(src))
    lanes = []
    for arch in SSM_ARCHS:
        example = build_dir / f"ssm_example_ckpt_{arch}"
        shutil.rmtree(example, ignore_errors=True)
        lanes.append(["-m", "repro_torch.examples.train_lm", "--arch", arch,
                      "--tiny", "--strict", "--steps", "20", "--ckpt-dir",
                      str(example)])
    lanes += [["-m", "repro_torch.launch.train", "--arch", SSM_ARCHS[1],
               "--tiny", "--steps", "4", "--batch", "2", "--seq", "64",
               "--log-every", "1"],
              ["-m", "repro_torch.launch.serve", "--arch", SSM_ARCHS[0],
               "--tiny"]]
    runs = [start_lane(env, args) for args in lanes]
    failures = []
    for run in runs:
        failures += finish_lane(run, "g")
    return failures


def run_ssm_path(torch, np, device, src):
    """Phase 14: the SSM and hybrid families at full width and depth.
    Returns (the launches of (c)-(f), failures)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import param_count

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    build_dir = Path(__file__).resolve().parent / "build"
    failures = timed("a", check_ssd_forms, torch, device,
                     f32_config(SSM_ARCHS[0]))
    for arch in SSM_ARCHS:
        failures += timed("b", check_card_vs_cpu, torch, device,
                          f32_config(arch, n_layers=SSM_CHECK_DEPTH[arch]),
                          *SSM_CHECK)
    reset_launch_counts()       # the main path: (c)-(f) at full depth
    for arch in SSM_ARCHS:
        cfg = f32_config(arch)
        params, init_s = timed("init", card_params, torch, cfg, device)
        log(f"  {arch}: {cfg.n_layers} layers "
            f"({collections.Counter(cfg.layer_plan())}), "
            f"{param_count(params) / 1e9:.4f} G parameters, "
            f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB on the "
            f"card, drawn on the card in {init_s:.2f} s")
        failures += timed("c", check_ssm_ot_kernels, torch, device, cfg,
                          params)
        torch.cuda.empty_cache()
        failures += timed("d", train_ssm, torch, device, cfg, build_dir,
                          arch.startswith("zamba2"))
        torch.cuda.empty_cache()
        failures += timed("e", serve_ssm, torch, device, cfg, params)
        if arch.startswith("zamba2"):
            failures += timed("f", check_ssm_wrap, torch, device, cfg,
                              params)
        failures += timed("f", time_long_decode, torch, device, cfg, params)
        del params
        torch.cuda.empty_cache()
    failures += timed("f", ssm_long_caches, torch, device)
    counts = launch_counts()
    failures += timed("g", run_ssm_lanes, src, build_dir)
    missing = [k for k in SSM_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    log("  phase 14 parts (s): " + ", ".join(f"({k}) {v:.1f}"
                                            for k, v in walls.items()))
    return counts, failures


ENCDEC_ARCH = "whisper_base"    # full width and depth: 6 + 6 layers, d 512
ENCDEC_FRAMES = 1500            # (a), (e): Whisper's 30-second window
ENCDEC_XATTN = (4, 64)          # (a), (e): batch, decoded tokens
ENCDEC_TOL = 1e-4               # (a): of max |out|; (e): of max |logit|
ENCDEC_CHECK = (2, 128)         # (b): batch x seq, card against the CPU
ENCDEC_SERVE = (4, 32, 16)      # (e): launch.serve's batch, prompt, generated
ENCDEC_LONG_BATCH = 4           # (f): decode_32k at batch 4 (128 needs 103 GB)
ENCDEC_LONG_REPEATS = 5         # (f): timed decode steps
ENCDEC_PATH_KERNELS = ("log_feature_contract", "log_halfstep")


def encoder_kv(torch, params, cfg, enc):
    """Every decoder layer's cross-attention keys and values of the
    encoder's output ``enc`` (B, T, d): ``{"k", "v"}``, each (n_layers, B,
    T, H, D), as ``decode_step`` reads them."""
    from repro_torch.models.layers import linear
    from repro_torch.models.model import _unstack

    B, T, _ = enc.shape
    layers = _unstack(params["groups"][0], cfg.n_layers)
    return {w: torch.stack([
        linear(p_l["xattn"][f"w{w}"], enc).reshape(B, T, cfg.n_heads,
                                                    cfg.head_dim)
        for p_l in layers]) for w in ("k", "v")}


def encdec_inputs(torch, cfg, device, B, T, S, seed):
    """Seeded encoder frames (B, T, d), 0.02 N(0, 1) as the pipeline draws
    them, and decoder tokens (B, S)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    frames = 0.02 * torch.randn((B, T, cfg.d_model), generator=gen,
                                device=device)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    return frames, tokens


def check_xattn_forms(torch, device, cfg, params):
    """Phase 15 (a): the first ``dec_attn`` layer's cross-attention in its
    two forms, on the encoder's output over ENCDEC_FRAMES frames:
    ``cross_attention`` (the training form, chunked) over ENCDEC_XATTN's
    decoder states against ``cross_attend_step`` (the decode form,
    unchunked) on K/V built from ``xattn.wk`` / ``wv``, token by token."""
    from repro_torch.models.attention import cross_attend_step, \
        cross_attention
    from repro_torch.models.model import _encode, _unstack

    B, S = ENCDEC_XATTN
    T = ENCDEC_FRAMES
    frames, _ = encdec_inputs(torch, cfg, device, B, T, S, seed=15)
    x = torch.randn((B, S, cfg.d_model), device=device,
                    generator=torch.Generator(device=device).manual_seed(16))
    p = _unstack(params["groups"][0], cfg.n_layers)[0]["xattn"]
    kw = dict(n_heads=cfg.n_heads, head_dim=cfg.head_dim)
    with torch.no_grad():
        enc = _encode(params, cfg, {"enc_embeds": frames})
        full = cross_attention(p, x, enc, **kw)
        kv = encoder_kv(torch, params, cfg, enc)
        dec = torch.cat([cross_attend_step(p, x[:, t:t + 1], kv["k"][0],
                                           kv["v"][0], **kw)
                         for t in range(S)], dim=1)
    err = rel_to_max(torch, dec, full)
    log(f"  (a) {cfg.name} layer 0 cross-attention, {B} x {S} decoder "
        f"states over {T} encoder frames: {S} decode-form steps against the "
        f"training form {err:.3g} of max |out| ({float(full.abs().max()):.4g}"
        f"; bar {ENCDEC_TOL})")
    return [] if err <= ENCDEC_TOL else [f"(a) decode vs train {err:.3g}"]


def check_encdec_serving(torch, device, cfg, params):
    """Phase 15 (e): encoder K/V built from the encoder's output over
    ENCDEC_FRAMES frames (every layer's ``xattn.wk`` / ``wv``), then
    ENCDEC_XATTN's tokens teacher-forced through ``decode_step``, each
    step's logits against ``forward``'s at that position; then
    ``launch.serve`` at ENCDEC_SERVE with the reference's random
    ``enc_kv``."""
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, forward, init_caches
    from repro_torch.models.model import _encode, _logits

    B, S = ENCDEC_XATTN
    frames, tokens = encdec_inputs(torch, cfg, device, B, ENCDEC_FRAMES, S,
                                   seed=17)
    batch = {"enc_embeds": frames, "tokens": tokens}
    caches = init_caches(cfg, B, S, device=device)
    worst = 0.0
    with torch.no_grad():
        ref = _logits(params, cfg, forward(params, cfg, batch)[0])
        kv = encoder_kv(torch, params, cfg, _encode(params, cfg, batch))
        for i in range(S):
            logits, caches = decode_step(
                params, cfg, {"tokens": tokens[:, i:i + 1], "enc_kv": kv},
                caches)
            worst = max(worst, rel_to_max(torch, logits[:, 0], ref[:, i]))
    failures = [] if worst <= ENCDEC_TOL else [
        f"(e) decode vs forward {worst:.3g}"]
    Bs, P, G = ENCDEC_SERVE
    out = serve.main(["--arch", cfg.name, "--batch", str(Bs), "--prompt-len",
                      str(P), "--gen", str(G)], params=params)
    ms = out["decode_s"] * 1e3 / G
    log(f"  (e) {cfg.name}: {S} tokens decoded over the encoder's K/V of "
        f"{ENCDEC_FRAMES} frames against forward: worst {worst:.3g} of max "
        f"|logit| (bar {ENCDEC_TOL}); launch.serve batch {Bs}, prompt {P}, "
        f"random enc_kv: prefill {out['prefill_ms']:.3f} ms a token step, "
        f"decode {ms:.3f} ms a token step, {out['decode_tok_s']:.1f} tok/s")
    return failures


def check_decode_32k(torch, device, cfg, params):
    """Phase 15 (f): the ``decode_32k`` shape at batch ENCDEC_LONG_BATCH:
    self-attention caches of 32768 slots at length 32767 and seeded
    encoder K/V of 32768 frames; the median ms of ENCDEC_LONG_REPEATS
    decode steps (each to a sync; zero caches, a timing only) and the
    bytes held. The step reads row 32767 of the learned positions: its
    logits move when that row moves (by N(0, 1) draws) and stay within
    1e-6 of max |logit| when rows 32766 and 32768 move."""
    from repro_torch.configs import SHAPES
    from repro_torch.models import decode_step, init_caches

    s = SHAPES["decode_32k"].seq_len
    B = ENCDEC_LONG_BATCH
    caches = init_caches(cfg, B, s, device=device)
    gen = torch.Generator(device=device).manual_seed(18)
    kv_shape = (cfg.n_layers, B, s, cfg.n_heads, cfg.head_dim)
    kv = {w: torch.randn(kv_shape, generator=gen, device=device)
          for w in ("k", "v")}
    cache_bytes = sum(t.numel() * t.element_size() for c in caches
                      for t in c[:2])
    kv_bytes = sum(t.numel() * t.element_size() for t in kv.values())
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=device)

    def step(p):
        for c in caches:
            c.length.fill_(s - 1)
        return decode_step(p, cfg, {"tokens": tok, "enc_kv": kv}, caches)[0]

    walls = []
    with torch.no_grad():
        for _ in range(ENCDEC_LONG_REPEATS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            base = step(params)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        moved = {}
        for rows in ((s - 1,), (s - 2, s)):
            # a random move: the norms take out a constant shift of a row
            pos = params["pos"].clone()
            pos[list(rows)] += torch.randn((len(rows), cfg.d_model),
                                           generator=gen, device=device)
            moved[rows] = rel_to_max(torch, step(dict(params, pos=pos)),
                                     base)
            del pos
    ms = statistics.median(walls[1:])
    log(f"  (f) {cfg.name} decode_32k at batch {B}: self-attention caches "
        f"{cache_bytes / 1e9:.4f} GB ({tuple(caches[0].k.shape)} k and v), "
        f"enc_kv {kv_bytes / 1e9:.4f} GB; one decode step at length "
        f"{s - 1}: {ms:.3f} ms (median of {ENCDEC_LONG_REPEATS}; zero "
        f"caches, a timing only); logits moved by pos row {s - 1}: "
        f"{moved[(s - 1,)]:.3g}, by rows {s - 2} and {s}: "
        f"{moved[(s - 2, s)]:.3g} of max |logit|")
    del kv, caches
    torch.cuda.empty_cache()
    failures = []
    if not (moved[(s - 1,)] > 1e-3 and moved[(s - 2, s)] <= 1e-6):
        failures.append(f"(f) the position row read: {moved}")
    want = cfg.n_layers * 2 * B * s * cfg.n_kv_heads * cfg.head_dim * 4
    if not cache_bytes == kv_bytes == want:
        failures.append(f"(f) bytes {cache_bytes}, {kv_bytes}, not {want}")
    return failures


def run_encdec_lanes(src, build_dir):
    """Phase 15 (g): the drivers on whisper-base's tiny config on the
    card, side by side as subprocesses: ``examples.train_lm --strict``,
    ``launch.train`` and ``launch.serve``; each must exit 0."""
    import os
    import shutil
    env = dict(os.environ, PYTHONPATH=str(src))
    example = build_dir / "encdec_example_ckpt"
    shutil.rmtree(example, ignore_errors=True)
    lanes = [["-m", "repro_torch.examples.train_lm", "--arch", ENCDEC_ARCH,
              "--tiny", "--strict", "--steps", "20", "--ckpt-dir",
              str(example)],
             ["-m", "repro_torch.launch.train", "--arch", ENCDEC_ARCH,
              "--tiny", "--steps", "4", "--batch", "2", "--seq", "64",
              "--log-every", "1"],
             ["-m", "repro_torch.launch.serve", "--arch", ENCDEC_ARCH,
              "--tiny"]]
    runs = [start_lane(env, args) for args in lanes]
    failures = []
    for run in runs:
        failures += finish_lane(run, "g")
    return failures


def run_encdec_path(torch, np, device, src):
    """Phase 15: the encoder-decoder family, whisper-base at full width and
    depth in float32. Returns (the launches of (a) and (c)-(f),
    failures)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import param_count

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    build_dir = Path(__file__).resolve().parent / "build"
    cfg = f32_config(ENCDEC_ARCH)
    failures = timed("b", check_card_vs_cpu, torch, device, cfg,
                     *ENCDEC_CHECK)
    reset_launch_counts()       # the main path: (a), (c)-(f)
    params, init_s = timed("init", card_params, torch, cfg, device)
    log(f"  {cfg.name}: {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder "
        f"layers, {param_count(params):,} parameters, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB on the card, "
        f"drawn on the card in {init_s:.2f} s")
    failures += timed("a", check_xattn_forms, torch, device, cfg, params)
    failures += timed("c", check_ssm_ot_kernels, torch, device, cfg, params,
                      ENCDEC_PATH_KERNELS)
    torch.cuda.empty_cache()
    failures += timed("d", train_ssm, torch, device, cfg, build_dir, True)
    torch.cuda.empty_cache()
    failures += timed("e", check_encdec_serving, torch, device, cfg, params)
    failures += timed("f", check_decode_32k, torch, device, cfg, params)
    del params
    torch.cuda.empty_cache()
    counts = launch_counts()
    failures += timed("g", run_encdec_lanes, src, build_dir)
    missing = [k for k in ENCDEC_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    log("  phase 15 parts (s): " + ", ".join(f"({k}) {v:.1f}"
                                            for k, v in walls.items()))
    return counts, failures


MC_ARCH = "smollm-135m"          # (b), (c), (f): full width and depth
MC_MESH = (2, 1)                 # (b), (f): data x model, a gloo world of 2
MC_TRAIN = (8, 256)              # (b): batch x seq of the checked step
MC_TIMED = 3                     # (b): timed steps after the checked one
MC_DRIVER = (4, 128, 3)          # (f): batch, seq, steps a half
MC_DECODE = (4, 64, 8)           # (f): batch, cache length, decoded tokens
MC_COMPRESS_TOL = (0.05, 1e-3)   # (c): of the exact sum's max, plus
MC_MOE = ("deepseek_v2_236b", 2, 512)   # (d): config, batch x seq tokens
MC_MOE_TOL = {"float32": 1e-4,   # (d): EP against the float32 oracle, of
              "bfloat16": 3e-2}  # max |out| and of each gradient's max
MC_MOE_FACTORS = (8.0, 1.25)     # (d): no drops, then the config's drops
MC_SSD = (2, 4096, 64, 64, 128, 128)    # (e): B, S, H, P, N, chunk
MC_SSD_TOL = 1e-4                # (e): of max |y|
MC_TIMEOUT_S = 600               # a world's spawn, run and join
MC_COLLECTIVES = ("all_reduce SUM", "all_reduce MAX", "all_reduce SUM int32",
                  "all_gather", "all_to_all", "reduce_scatter")


def probe_collectives(torch, dist, device, rank, world):
    """Phase 16 (a): which collectives the world's backend takes on CUDA
    tensors, each against its exact answer ({name: "ok" or the error})."""
    out = {}

    def one(name, fn, want):
        try:
            got = fn()
            sync(torch)
            out[name] = "ok" if got == want else f"wrong: {got} != {want}"
        except (RuntimeError, ValueError) as exc:
            out[name] = f"{type(exc).__name__}: {str(exc)[:120]}"

    def reduce(op, dtype):
        t = torch.full((4,), rank + 1, dtype=dtype, device=device)
        dist.all_reduce(t, op=op)
        return t.tolist()

    def gather():
        parts = [torch.empty(2, device=device) for _ in range(world)]
        dist.all_gather(parts, torch.full((2,), float(rank), device=device))
        return [p.tolist() for p in parts]

    def to_all():
        x = torch.arange(world, dtype=torch.float32, device=device) + \
            10 * rank
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y.tolist()

    def scatter():
        x = torch.arange(2 * world, dtype=torch.float32, device=device)
        y = torch.empty(2, device=device)
        dist.reduce_scatter_tensor(y, x)
        return y.tolist()

    total = world * (world + 1) // 2
    one("all_reduce SUM", lambda: reduce(dist.ReduceOp.SUM, torch.float32),
        [float(total)] * 4)
    one("all_reduce MAX", lambda: reduce(dist.ReduceOp.MAX, torch.float32),
        [float(world)] * 4)
    one("all_reduce SUM int32", lambda: reduce(dist.ReduceOp.SUM,
                                               torch.int32), [total] * 4)
    one("all_gather", gather, [[float(r)] * 2 for r in range(world)])
    one("all_to_all", to_all, [float(rank + 10 * r) for r in range(world)])
    one("reduce_scatter", scatter,
        [float(world * (2 * rank + j)) for j in range(2)])
    return out


def mc_config():
    """(b)'s smollm-135m in float32, its OT solves in float32 too: the
    sharded divergence solves in float32 whatever the storage policy, and
    the one-card step it is held against must solve as it does."""
    return dataclasses.replace(lm_config(), ot_precision="highest")


def tree_bytes(tree) -> int:
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def mc_train_step(torch, dist, device, rank, lines):
    """Phase 16 (b): one smollm-135m step at MC_TRAIN on a 2 x 1 mesh
    (ZeRO shards, the sharded OT loss on rows 6-7) against the one-card
    step from the same weights and batch (rank 0), then MC_TIMED timed
    steps with the launch counters set to 0 before and read after.
    Returns (failures, counts of the timed steps, the step's pieces for
    (c))."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_adamw

    failures = []
    cfg = mc_config()
    B, S = MC_TRAIN
    shape = ShapeSpec("phase16", S, B, "train")
    # eps 1: the first update is close to linear in the gradient, so the
    # parameters hold the gradients' agreement (the CPU tests' choice)
    opt = AdamWConfig(eps=1.0)
    mesh = make_local_mesh(*MC_MESH, device=device)
    step, _ = make_train_step(cfg, mesh, shape, opt, total_steps=10)
    specs, ctx = step.shardings[0], step.context
    params = init_params(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0))
    shards = shard_tree(params, specs, ctx)
    state = init_adamw(shards, step.opt)
    whole = tree_bytes(params)
    lines.append(
        f"  (b) rank {rank}: parameters {tree_bytes(shards) / 2**20:.1f} "
        f"MiB, AdamW moments {tree_bytes((state.m, state.v)) / 2**20:.1f} "
        f"MiB; one card's tree {whole / 2**20:.1f} MiB and "
        f"{2 * whole / 2**20:.1f} MiB")
    batch = DataPipeline(DataConfig(0, B, S, cfg.vocab),
                         device=device).batch_at(0)
    block = step.block(batch)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    new, st, met = step(shards, state, block)
    sync(torch)
    first_s = time.perf_counter() - t0
    got_p, got_m = gather_tree(new, specs, ctx), gather_tree(st.m, specs,
                                                             ctx)
    if rank == 0:
        one, _ = make_train_step(cfg, None, shape, opt, total_steps=10)
        want_p, want_s, want = one(params, init_adamw(params, one.opt),
                                   batch)
        ce = abs(float(met["ce"]) - float(want["ce"])) / abs(float(want["ce"]))
        ot = abs(float(met["ot"]) - float(want["ot"])) / abs(float(want["ot"]))
        gn = abs(float(met["grad_norm"]) - float(want["grad_norm"])) / abs(
            float(want["grad_norm"]))
        # m = (1 - b1) g: the first moments are the clipped gradients
        bad_g, worst_g = leaves_within(torch, got_m, want_s.m, LM_GRAD_TOL,
                                       "(b) gradient")
        bad_p, worst_p = leaves_within(torch, got_p, want_p, 1e-5,
                                       "(b) parameter")
        lines.append(
            f"  (b) {cfg.name} {B} x {S} on {MC_MESH[0]} x {MC_MESH[1]} "
            f"against one card: ce {float(met['ce']):.7f} / "
            f"{float(want['ce']):.7f} (rel {ce:.3g}, bar {LM_CE_RTOL}); ot "
            f"{float(met['ot']):.7f} / {float(want['ot']):.7f} (rel "
            f"{ot:.3g}, bar {LM_OT_RTOL}); grad norm rel {gn:.3g}; "
            f"gradients worst {worst_g:.3g} of a leaf's max (bar "
            f"{LM_GRAD_TOL}); parameters after AdamW worst {worst_p:.3g} "
            f"(bar 1e-05)")
        if not ce <= LM_CE_RTOL:
            failures.append(f"(b) ce rel {ce:.3g}")
        if not ot <= LM_OT_RTOL:
            failures.append(f"(b) ot rel {ot:.3g}")
        failures += bad_g + bad_p
        del want_p, want_s, one
    del got_p, got_m, params
    torch.cuda.empty_cache()
    dist.barrier()
    ms = []
    reset_launch_counts()
    for _ in range(MC_TIMED):
        sync(torch)
        t0 = time.perf_counter()
        step(shards, state, block)
        sync(torch)
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    per = {k: v / MC_TIMED for k, v in counts.items() if v}
    lines.append(
        f"  (b) rank {rank}: first step {first_s:.2f} s; "
        f"{statistics.median(ms):.1f} ms a step (median of {MC_TIMED}: "
        f"{[round(v, 1) for v in ms]}); peak memory {peak / 2**30:.3f} GiB; "
        f"launches a step {per}")
    missing = [k for k in LM_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"(b) rank {rank}: kernels never launched {missing}")
    return failures, counts, (cfg, mesh, step, shards, batch)


def mc_compress(torch, dist, device, rank, pieces, lines):
    """Phase 16 (c): each rank's gradients of (b)'s step on its rows,
    summed over the ranks by ``compressed_psum`` and exactly; and
    ``ef_compress_tree`` of them, its residual exact."""
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.distributed import MeshAxis, use_mesh_context
    from repro_torch.launch.specs import gather_tree
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.optim import compressed_psum, ef_compress_tree, \
        init_error_buffers
    from repro_torch.tree import named_leaves

    cfg, mesh, step, shards, batch = pieces
    ctx = step.context
    full = gather_tree(shards, step.shardings[0], ctx)
    n = MC_TRAIN[0] // MC_MESH[0]
    rows = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    with use_mesh_context(ctx):
        grads, _ = loss_and_grads(full, cfg, rows,
                                  ExecutionPolicy.from_config(cfg, mesh=mesh))
    del full
    axis = MeshAxis(mesh, "data")
    rel, t0 = 0.0, time.perf_counter()
    failures = []
    for name, g in named_leaves(grads):
        exact = g.clone()
        dist.all_reduce(exact)
        err = float((compressed_psum(g, axis) - exact).abs().max())
        scale = float(exact.abs().max())
        rel = max(rel, err / max(scale, 1e-30))
        if not err < MC_COMPRESS_TOL[0] * scale + MC_COMPRESS_TOL[1]:
            failures.append(f"(c) compressed_psum {name}: {err:.3g} of "
                            f"{scale:.3g}")
    sync(torch)
    psum_s = time.perf_counter() - t0
    deq, resid = ef_compress_tree(grads, init_error_buffers(grads))
    ef_rel, exact_resid = 0.0, True
    for (name, g), d_, e_ in zip(named_leaves(grads), named_leaves(deq),
                                 named_leaves(resid)):
        err = float((d_[1] - g).abs().max())
        scale = float(g.abs().max())
        ef_rel = max(ef_rel, err / max(scale, 1e-30))
        exact_resid &= bool(torch.equal(d_[1].float() + e_[1], g.float()))
        if not err < MC_COMPRESS_TOL[0] * scale + MC_COMPRESS_TOL[1]:
            failures.append(f"(c) ef_compress_tree {name}: {err:.3g}")
    if not exact_resid:
        failures.append("(c) ef_compress_tree: deq + residual != g")
    lines.append(
        f"  (c) rank {rank}: compressed_psum of {len(named_leaves(grads))} "
        f"gradient leaves worst {rel:.3g} of the exact sum's max (bar "
        f"{MC_COMPRESS_TOL[0]} of max + {MC_COMPRESS_TOL[1]}) in "
        f"{psum_s:.2f} s with the exact sums; ef_compress_tree worst "
        f"{ef_rel:.3g}, residual exact {exact_resid}")
    return failures


def capacity_of(rows, buckets, factor):
    c = int(-(-rows // max(buckets, 1)) * factor)
    return max(8, ((c + 7) // 8) * 8)


def recount_kept(np, idx, n_experts, factor):
    """The (token, expert) assignments the capacity rule keeps, recounted
    from every rank's dispatch (R, T, k) in numpy: a send bucket a
    destination rank in (token, k) order, then each expert's rows in
    received order (by source rank, then slot)."""
    R, T, k = idx.shape
    e_loc = n_experts // R
    c_send = capacity_of(T * k, R, factor)
    c_exp = capacity_of(R * c_send, e_loc, factor)
    kept = np.zeros((R, T * k), bool)
    received = [[] for _ in range(R)]
    for src in range(R):
        sent = np.zeros(R, int)
        for a, e in enumerate(idx[src].reshape(-1)):
            dest = e // e_loc
            if sent[dest] < c_send:
                received[dest].append((src, sent[dest], e % e_loc, a))
            sent[dest] += 1
    for dest in range(R):
        taken = np.zeros(e_loc, int)
        for src, _, e, a in sorted(received[dest]):
            kept[src, a] = taken[e] < c_exp
            taken[e] += 1
    return kept.reshape(R, T, k)


def mc_moe(torch, np, dist, device, rank, world, lines):
    """Phase 16 (d): deepseek-v2-236b's MoE layer at full width in bf16
    (its Sinkhorn router) through ``moe_ep_local`` on a 1 x ``world``
    mesh, forward and backward at capacity factor 8 in float32 on the
    bf16 weights, against ``moe_dense`` in float32 on the same weights,
    on every rank's tokens (each routed on its own, as EP routes them)
    with all the experts; the same in bf16, whose own rounding puts it
    ~1e-2 of max off the float32 oracle (each at its bar of
    ``MC_MOE_TOL``); then at the
    config's factor the bf16 layer's kept (token, expert) set against a
    recount of the capacity rule."""
    from repro_torch.configs import get_config
    from repro_torch.core.objective import ExecutionPolicy
    from repro_torch.core.routing import stable_top_k
    from repro_torch.distributed import MeshAxis
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import init_moe, moe_dense, moe_ep_local, \
        router_probs

    arch, B, S = MC_MOE
    cfg = get_config(arch)
    d, E, k, f = cfg.d_model, cfg.n_experts, cfg.top_k, cfg.moe_d_ff
    policy = ExecutionPolicy.from_config(cfg)
    axis = MeshAxis(make_local_mesh(1, world, device=device), "model")
    gen = torch.Generator(device=device).manual_seed(16)
    p = init_moe(gen, d, f, E, dtype=torch.bfloat16, device=device)
    x = torch.randn((B, S, d), generator=gen, device=device).to(
        torch.bfloat16)
    cot = torch.randn((B, S, d), generator=gen, device=device)
    seg, e_loc = S // world, E // world
    # rank r's tokens: the r-th segment of each batch row, in (b, s) order
    segs = [x[:, r * seg:(r + 1) * seg].reshape(-1, d) for r in range(world)]
    cots = [cot[:, r * seg:(r + 1) * seg].reshape(-1, d)
            for r in range(world)]
    failures = []
    # the oracle first, one rank at a time (~50 GB at its peak: the
    # weights in float32 and their gradients): moe_dense in float32 on
    # the bf16 weights' values, each rank's tokens routed on their own as
    # EP routes them. A rank then keeps only its own experts and the
    # oracle's answers for them.
    want, dense_s = {}, 0.0
    for turn in range(world):
        dist.barrier()
        if turn != rank:
            continue
        full = {n: t.float().requires_grad_(True) for n, t in p.items()}
        p = {n: t[rank * e_loc:(rank + 1) * e_loc].clone() if n != "router"
             else t for n, t in p.items()}
        torch.cuda.empty_cache()
        xs = [s_.float().requires_grad_(True) for s_ in segs]
        t0 = time.perf_counter()
        outs = [moe_dense(full, xs_, top_k=k, router=cfg.router,
                          policy=policy)[0] for xs_ in xs]
        g = torch.autograd.grad(
            sum(torch.sum(o * c) for o, c in zip(outs, cots)),
            list(full.values()) + [xs[rank]])
        sync(torch)
        dense_s = time.perf_counter() - t0
        want = {"out": outs[rank], "x": g[-1], "router": g[0]}
        want.update({n: g[i][rank * e_loc:(rank + 1) * e_loc]
                     for i, n in enumerate(("up", "gate", "down"), start=1)})
        want = {n: t.detach().clone() for n, t in want.items()}
        del full, xs, outs, g
        torch.cuda.empty_cache()
    dist.barrier()

    def ep(dtype):
        """moe_ep_local forward and backward on this rank's tokens and
        experts in ``dtype`` (the bf16 weights' values): its errors against
        the oracle and its seconds."""
        p_loc = {"router": p["router"].clone()}
        p_loc.update({n: p[n].to(dtype, copy=True)
                      for n in ("up", "gate", "down")})
        leaves = [t.requires_grad_(True) for t in p_loc.values()]
        x_loc = segs[rank].to(dtype).requires_grad_(True)
        sync(torch)
        t0 = time.perf_counter()
        out, _ = moe_ep_local(p_loc, x_loc, top_k=k, n_experts=E, axis=axis,
                              router=cfg.router,
                              capacity_factor=MC_MOE_FACTORS[0],
                              policy=policy)
        got = torch.autograd.grad(torch.sum(out.float() * cots[rank]),
                                  leaves + [x_loc])
        sync(torch)
        secs = time.perf_counter() - t0
        router = got[0].clone()
        dist.all_reduce(router, group=axis.group)
        errs = {"out": sliced_rel_err(torch, out.detach(), want["out"]),
                "x": sliced_rel_err(torch, got[-1], want["x"]),
                "router": sliced_rel_err(torch, router, want["router"])}
        for i, n in enumerate(("up", "gate", "down"), start=1):
            errs[n] = sliced_rel_err(torch, got[i], want[n])
        return errs, secs

    errs, ep_s = ep(torch.float32)
    noise, ep16_s = ep(torch.bfloat16)
    for dtype, got in (("float32", errs), ("bfloat16", noise)):
        for n, e in got.items():
            if not e <= MC_MOE_TOL[dtype]:
                failures.append(f"(d) rank {rank} EP in {dtype} vs dense "
                                f"{n}: {e:.3g} (bar {MC_MOE_TOL[dtype]})")
    lines.append(
        f"  (d) rank {rank}/{world}: {arch} MoE layer (d {d}, {E} experts, "
        f"{e_loc} a rank, top-{k}, moe_d_ff {f}, {cfg.router} router, bf16 "
        f"weights), {B} x {S} tokens, capacity factor {MC_MOE_FACTORS[0]}: "
        f"EP in float32 against moe_dense in float32, of max: " + ", ".join(
            f"{n} {e:.3g}" for n, e in errs.items())
        + f" (bar {MC_MOE_TOL['float32']}); EP in bf16 against it: "
        + ", ".join(
            f"{n} {e:.3g}" for n, e in noise.items())
        + f" (bar {MC_MOE_TOL['bfloat16']}); EP forward + backward "
        f"{ep_s:.2f} s float32, {ep16_s:.2f} s bf16, dense {dense_s:.2f} s (first calls)")
    del want
    torch.cuda.empty_cache()
    p_loc = p
    # the config's capacity factor: the kept set against a recount
    stats = {}
    with torch.no_grad():
        moe_ep_local(p_loc, segs[rank], top_k=k, n_experts=E, axis=axis,
                     router=cfg.router, capacity_factor=cfg.capacity_factor,
                     policy=policy, stats=stats)
        combine, _ = router_probs(p_loc, segs[rank], top_k=k,
                                  router=cfg.router, policy=policy)
        idx = stable_top_k(combine, k)[1]
    kept = axis.gather_rows(stats["kept"][None].to(torch.int32)).cpu()
    idx = axis.gather_rows(idx[None]).cpu().numpy()
    want = recount_kept(np, idx, E, cfg.capacity_factor)
    same = bool(np.array_equal(kept.numpy() > 0, want))
    lines.append(
        f"  (d) rank {rank}/{world}: capacity factor {cfg.capacity_factor}: "
        f"kept share {float(kept.float().mean()):.4f} of "
        f"{kept.numel()} (token, expert) assignments; equal to the "
        f"recount: {same}")
    if not same:
        failures.append(f"(d) rank {rank}: kept set != the recount")
    return failures


def mc_ssd(torch, dist, device, rank, world, lines):
    """Phase 16 (e): mamba2-1.3b's SSD at full width (64 heads of 64,
    d_state 128, chunk 128), B x S = MC_SSD, context parallel over a 1 x
    ``world`` mesh (each rank its segment of the sequence, the outputs
    gathered back) against ``ssd_chunked`` on one rank; both timed."""
    from repro_torch.distributed import MeshContext, all_gather, \
        use_mesh_context
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.ssm import ssd_chunked, ssd_context_parallel

    B, S, H, P, N, Q = MC_SSD
    gen = torch.Generator(device=device).manual_seed(18)
    x = torch.randn((B, S, H, P), generator=gen, device=device)
    dt = 0.01 * torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=gen, device=device))
    A = -torch.exp(0.3 * torch.randn((H,), generator=gen, device=device))
    Bm = 0.5 * torch.randn((B, S, N), generator=gen, device=device)
    Cm = 0.5 * torch.randn((B, S, N), generator=gen, device=device)
    ctx = MeshContext(make_local_mesh(1, world, device=device))
    tp = ctx.axis("model")
    seg = S // world
    x_l, dt_l, B_l, C_l = (t[:, tp.rank * seg:(tp.rank + 1) * seg]
                           for t in (x, dt, Bm, Cm))

    def cp():
        # the rank's segment in and out; its output gathered back whole
        with use_mesh_context(ctx):
            return all_gather(ssd_context_parallel(x_l, dt_l, A, B_l, C_l,
                                                   chunk=Q), tp, dim=1)

    def timed(fn, reps=3):
        fn()
        ms = []
        for _ in range(reps):
            sync(torch)
            t0 = time.perf_counter()
            out = fn()
            sync(torch)
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(ms)

    with torch.no_grad():
        y_cp, cp_ms = timed(cp)
        if rank == 0:
            y_one, one_ms = timed(lambda: ssd_chunked(x, dt, A, Bm, Cm,
                                                      chunk=Q)[0])
            err = rel_to_max(torch, y_cp, y_one)
    dist.barrier()
    if rank != 0:
        return []
    lines.append(
        f"  (e) SSD (H {H}, P {P}, N {N}, chunk {Q}), {B} x {S}: context "
        f"parallel over {world} ranks {cp_ms:.2f} ms (median of 3, its "
        f"gather included), ssd_chunked on one rank {one_ms:.2f} ms; "
        f"within {err:.3g} of max |y| (bar {MC_SSD_TOL})")
    return [] if err <= MC_SSD_TOL else [f"(e) CP vs chunked {err:.3g}"]


def mc_driver(torch, dist, device, rank, build_dir, lines):
    """Phase 16 (f): ``launch.train --arch smollm-135m --mesh 2x1`` in
    process on every rank: MC_DRIVER's steps ending in a checkpoint, then
    as many more uninterrupted through ``make_train_step`` (the driver's
    schedule and data), then ``--resume`` from the checkpoint, its losses
    against the uninterrupted ones; then decode on the mesh at MC_DECODE
    against one card."""
    import shutil
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import gather_tree, shard_tree
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models import init_caches, shard_caches
    from repro_torch.optim import AdamWConfig

    B, S, half = MC_DRIVER
    ck = build_dir / "multicard_ckpt"
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)
    dist.barrier()
    base = ["--arch", MC_ARCH, "--mesh", f"{MC_MESH[0]}x{MC_MESH[1]}",
            "--batch", str(B), "--seq", str(S), "--steps", str(half),
            "--log-every", "1", "--save-every", str(10 ** 6), "--ckpt-dir",
            str(ck)]
    t0 = time.perf_counter()
    first = train.main(base)
    first_s = time.perf_counter() - t0
    cfg = lm_config()
    mesh = make_local_mesh(*MC_MESH, device=device)
    step, _ = make_train_step(cfg, mesh, ShapeSpec("p16", S, B, "train"),
                              AdamWConfig(), total_steps=half)
    data = DataPipeline(DataConfig(seed=0, global_batch=B, seq_len=S,
                                   vocab=cfg.vocab), device=device)
    params, opt_state = first.pop("state")
    hist = []
    for s_ in range(half, 2 * half):
        params, opt_state, m = step(params, opt_state,
                                    step.block(data.batch_at(s_)))
        hist.append({k: float(v) for k, v in m.items()})
    t0 = time.perf_counter()
    again = train.main(base + ["--resume"])
    again_s = time.perf_counter() - t0
    del again["state"]
    worst = max(abs(d_[k] - h[k]) / abs(h[k]) for d_, h in
                zip(again["losses"], hist) for k in ("loss", "ce", "ot"))
    failures = []
    steps = [d_["step"] for d_ in first["losses"] + again["losses"]]
    if steps != list(range(2 * half)):
        failures.append(f"(f) the driver's logged steps {steps}")
    if not worst <= LM_RESUME_RTOL:
        failures.append(f"(f) resumed vs uninterrupted {worst:.3g}")
    files = sorted(p.name for p in (ck / f"step_{half - 1:09d}").iterdir())
    # decode on the mesh against one card, from the trained weights
    Bd, Sd, n_tok = MC_DECODE
    shape = ShapeSpec("p16d", Sd, Bd, "decode")
    dec, _ = make_serve_step(cfg, mesh, shape)
    one, _ = make_serve_step(cfg, None, shape)
    full = gather_tree(params, step.shardings[0], step.context)
    shards = shard_tree(full, dec.shardings[0], dec.context)
    c_mesh = shard_caches(cfg, init_caches(cfg, Bd, Sd, device=device),
                          dec.context)
    c_one = init_caches(cfg, Bd, Sd, device=device)
    tok = torch.randint(0, cfg.vocab, (Bd, n_tok), device=device,
                        generator=torch.Generator(device=device).manual_seed(
                            19))
    err = 0.0
    for t in range(n_tok):
        lg, c_mesh = dec(shards, dec.block({"tokens": tok[:, t:t + 1]}),
                         c_mesh)
        lw, c_one = one(full, {"tokens": tok[:, t:t + 1]}, c_one)
        err = max(err, rel_to_max(torch, lg, lw))
    if not err <= LM_DECODE_TOL:
        failures.append(f"(f) rank {rank}: decode on the mesh vs one card "
                        f"{err:.3g}")
    if rank == 0:
        shutil.rmtree(ck, ignore_errors=True)
        lines.append(
            f"  (f) launch.train --mesh {MC_MESH[0]}x{MC_MESH[1]}, {B} x {S}:"
            f" steps 0-{half - 1} and a checkpoint ({files}) in "
            f"{first_s:.1f} s; --resume from step {again['start'] - 1}: "
            f"steps {half}-{2 * half - 1} in {again_s:.1f} s, against the "
            f"uninterrupted steps worst loss / ce / ot rel {worst:.3g} (bar "
            f"{LM_RESUME_RTOL})")
    lines.append(
        f"  (f) rank {rank}: decode at batch {Bd}, {n_tok} tokens, on the "
        f"mesh (caches of {int(c_mesh[0][0].shape[1])} rows) against one "
        f"card: within {err:.3g} of max |logit| (bar {LM_DECODE_TOL})")
    return failures


MC_SEQ_MESH = (1, 2)             # (g): data x model, the sequence split


def mc_train_seq(torch, dist, device, rank, lines):
    """Phase 16 (g): (b)'s smollm-135m step at MC_TRAIN on a 1 x 2 mesh,
    each rank on its segment of the sequence (K / V gathered over
    "model", the parameters gathered a layer at a time), against the
    one-card step (rank 0, at (b)'s bars); then one step under a
    ``StepCounter`` with the launch counters set to 0 before and read
    after: its dot FLOPs and its peak (``max_memory_allocated`` less the
    bytes held outside the step's arguments), which phase 17 holds
    against the dry run on 1 x 2; then one timed step. Returns (failures,
    the counted step's numbers)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.analysis import StepCounter
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import gather_tree, shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_adamw

    failures = []
    cfg = mc_config()
    B, S = MC_TRAIN
    shape = ShapeSpec("phase16g", S, B, "train")
    opt = AdamWConfig(eps=1.0)
    mesh = make_local_mesh(*MC_SEQ_MESH, device=device)
    step, _ = make_train_step(cfg, mesh, shape, opt, total_steps=10)
    specs, ctx = step.shardings[0], step.context
    params = init_params(cfg, device=device, generator=torch.Generator(
        device=device).manual_seed(0))
    shards = shard_tree(params, specs, ctx)
    state = init_adamw(shards, step.opt)
    batch = DataPipeline(DataConfig(0, B, S, cfg.vocab),
                         device=device).batch_at(0)
    block = step.block(batch)
    t0 = time.perf_counter()
    new, st, met = step(shards, state, block)
    sync(torch)
    first_s = time.perf_counter() - t0
    got_p, got_m = gather_tree(new, specs, ctx), gather_tree(st.m, specs,
                                                             ctx)
    del new, st
    if rank == 0:
        one, _ = make_train_step(cfg, None, shape, opt, total_steps=10)
        want_p, want_s, want = one(params, init_adamw(params, one.opt),
                                   batch)
        ce = abs(float(met["ce"]) - float(want["ce"])) / abs(float(want["ce"]))
        ot = abs(float(met["ot"]) - float(want["ot"])) / abs(float(want["ot"]))
        bad_g, worst_g = leaves_within(torch, got_m, want_s.m, LM_GRAD_TOL,
                                       "(g) gradient")
        bad_p, worst_p = leaves_within(torch, got_p, want_p, 1e-5,
                                       "(g) parameter")
        lines.append(
            f"  (g) {cfg.name} {B} x {S} on {MC_SEQ_MESH[0]} x "
            f"{MC_SEQ_MESH[1]} (a rank's block {tuple(block['tokens'].shape)})"
            f" against one card: ce {float(met['ce']):.7f} / "
            f"{float(want['ce']):.7f} (rel {ce:.3g}, bar {LM_CE_RTOL}); ot "
            f"{float(met['ot']):.7f} / {float(want['ot']):.7f} (rel "
            f"{ot:.3g}, bar {LM_OT_RTOL}); gradients worst {worst_g:.3g} of "
            f"a leaf's max (bar {LM_GRAD_TOL}); parameters after AdamW "
            f"worst {worst_p:.3g} (bar 1e-05)")
        if not ce <= LM_CE_RTOL:
            failures.append(f"(g) ce rel {ce:.3g}")
        if not ot <= LM_OT_RTOL:
            failures.append(f"(g) ot rel {ot:.3g}")
        failures += bad_g + bad_p
        del want_p, want_s, one
    del got_p, got_m, params
    torch.cuda.empty_cache()
    dist.barrier()
    args = (shards, state, block)
    real = StepCounter()
    other = torch.cuda.memory_allocated(device) - real.track(args)
    torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    with real:
        out = step(*args)
    sync(torch)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    del out
    sync(torch)
    t0 = time.perf_counter()
    step(*args)
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3
    lines.append(
        f"  (g) rank {rank}: first step {first_s:.2f} s; a step "
        f"{ms:.1f} ms; peak memory {peak / 2**30:.4f} GiB less "
        f"{other / 2**30:.4f} held outside the step's arguments "
        f"({real.tracked_bytes / 2**30:.4f} GiB); dot FLOPs "
        f"{real.dot_flops:.6e}; collectives {real.counts}; launches a "
        f"step {({k: v for k, v in counts.items() if v})}")
    missing = [k for k in LM_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"(g) rank {rank}: kernels never launched {missing}")
    return failures, dict(dot_flops=real.dot_flops,
                          dot_by_op=dict(real.dot_by_op), peak=peak,
                          other=other, tracked=real.tracked_bytes, ms=ms,
                          counts=dict(counts))


def _multicard_rank(rank, world, backend, port, src, queue, build_dir,
                    device="cuda", only=None):
    """One rank of a phase-16 world (a spawned process on card 0). A world
    of 2 runs (a)-(g) (``only="g"``: (g) alone); a world of 1 runs (d) on
    a 1 x 1 mesh. Sends back its lines, failures, (b)'s launch counts and
    (g)'s counted step."""
    import traceback
    from datetime import timedelta

    lines, failures, counts, seq = [], [], None, None
    try:
        sys.path.insert(0, src)
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        from repro_torch.kernels import backend as kbackend
        if device == "cuda":
            torch.cuda.set_device(0)
            device = torch.device("cuda", 0)
        else:
            device = torch.device(device)
        kbackend.DEFAULT_DEVICE = str(device)
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        build_dir = Path(build_dir)
        parts = {}

        def part(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            parts[name] = time.perf_counter() - t0
            return out

        if world == 1:
            failures += part("d", mc_moe, torch, np, dist, device, rank,
                             world, lines)
        elif only == "g":
            more, seq = part("g", mc_train_seq, torch, dist, device, rank,
                             lines)
            failures += more
        else:
            took = part("a", probe_collectives, torch, dist, device, rank,
                        world)
            if rank == 0:
                lines.append(f"  (a) gloo on CUDA tensors: {took}")
            refused = [k for k, v in took.items() if v != "ok"]
            more, counts, pieces = part("b", mc_train_step, torch, dist,
                                        device, rank, lines)
            failures += more
            if "all_reduce SUM int32" in refused:
                lines.append("  (c) gloo refuses int32 sums of CUDA tensors:"
                             " compressed_psum stops here")
            else:
                failures += part("c", mc_compress, torch, dist, device, rank,
                                 pieces, lines)
            del pieces
            torch.cuda.empty_cache()
            if "all_to_all" in refused:
                lines.append("  (d) gloo refuses all-to-all on CUDA tensors: "
                             "the 1 x 2 expert parallelism stops here, the "
                             "NCCL world of 1 stands")
            else:
                failures += part("d", mc_moe, torch, np, dist, device, rank,
                                 world, lines)
            torch.cuda.empty_cache()
            failures += part("e", mc_ssd, torch, dist, device, rank, world,
                             lines)
            failures += part("f", mc_driver, torch, dist, device, rank,
                             build_dir, lines)
            torch.cuda.empty_cache()
            more, seq = part("g", mc_train_seq, torch, dist, device, rank,
                             lines)
            failures += more
        lines.append(f"  {backend} rank {rank}/{world} parts (s): " + ", ".join(
            f"({k}) {v:.1f}" for k, v in parts.items()))
        dist.barrier(**({"device_ids": [0]} if backend == "nccl" else {}))
        dist.destroy_process_group()
        queue.put(dict(rank=rank, lines=lines, failures=failures,
                       counts=counts, seq=seq))
    except Exception:
        queue.put(dict(rank=rank, error=traceback.format_exc(),
                       lines=lines))


def run_multicard_world(world, backend, src, build_dir, device="cuda",
                        only=None):
    """Spawn a phase-16 world of ``world`` ranks on card 0; returns (the
    ranks' reports sorted, or None, and the failure text)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_multicard_rank,
                         args=(r, world, backend, port, str(src), q,
                               str(build_dir), device, only))
             for r in range(world)]
    for p in procs:
        p.start()
    reports, deadline = [], time.monotonic() + MC_TIMEOUT_S
    try:
        while len(reports) < world:
            try:
                rep = q.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    return None, f"{backend} world of {world} timed out"
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    return None, f"{backend} world: a rank exited {dead}"
                continue
            if "error" in rep:
                for line in rep["lines"]:
                    log(line)
                for other in reports:
                    for line in other["lines"]:
                        log(line)
                return None, (f"{backend} world rank {rep['rank']}:\n"
                              f"{rep['error']}")
            reports.append(rep)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return sorted(reports, key=lambda r: r["rank"]), None


# (g)'s counted step on rank 0, for phase 17's dry run on 1 x 2
MC_SEQ_COUNTED = {}


def run_multicard_path(torch, src):
    """Phase 16: the multi-card LM path in a gloo world of 2 ranks on the
    one card ((a)-(g)), then an NCCL world of 1 ((d) on a 1 x 1 mesh).
    Returns (rank 0's launch counts of (b)'s timed steps, failures)."""
    import gc
    build_dir = Path(__file__).resolve().parent / "build"
    clear_runners()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  this process holds {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB ({torch.cuda.memory_reserved() / 2**30:.2f} reserved) as the "
        "ranks start")
    failures, counts = [], None
    for backend, world in (("gloo", 2), ("nccl", 1)):
        t0 = time.perf_counter()
        reports, err = run_multicard_world(world, backend, src, build_dir)
        if err:
            failures.append(err)
            log(f"  {backend} world of {world}: FAILED\n{err}")
            continue
        for rep in reports:
            for line in rep["lines"]:
                log(line)
            failures += rep["failures"]
        if backend == "gloo":
            counts = reports[0]["counts"]
            MC_SEQ_COUNTED.update(reports[0]["seq"] or {})
        log(f"  {backend} world of {world}: {time.perf_counter() - t0:.1f} s")
    return counts, failures


DRY_TRAIN = (8, 256)            # phase 17: phase 12's step, batch x seq
DRY_MESH = (1, 1)               # data x model
DRY_PEAK_RTOL = 0.10            # the estimated peak against the card's
DRY_FLOP_RTOL = 1e-6            # dot FLOPs, dry against the real step
DRY_TIMED = 3                   # timed real steps (median)
DRY_CELL = ("smollm_135m", "decode_32k")   # the production cell printed


def dot_flop_gaps(dry, real):
    """The ops whose dot FLOPs differ between two counters (name: dry,
    real)."""
    ops = sorted(set(dry.dot_by_op) | set(real.dot_by_op))
    return {op: (dry.dot_by_op.get(op, 0.0), real.dot_by_op.get(op, 0.0))
            for op in ops
            if dry.dot_by_op.get(op, 0.0) != real.dot_by_op.get(op, 0.0)}


def dry_seq_mesh(torch, src):
    """Phase 17 (d): phase 16 (g)'s step (smollm-135m at MC_TRAIN on 1 x
    2, the sequence split over "model") traced on fake tensors in a fake
    world of 2, rank 0's dot FLOPs and peak against (g)'s counted step on
    rank 0 (run here in a gloo world of 2 if phase 16 did not run)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh

    if not MC_SEQ_COUNTED:
        reports, err = run_multicard_world(
            2, "gloo", src, Path(__file__).resolve().parent / "build",
            only="g")
        if err:
            return [f"(d) the 1 x 2 world: {err}"]
        for rep in reports:
            for line in rep["lines"]:
                log(line)
        if any(rep["failures"] for rep in reports):
            return [f for rep in reports for f in rep["failures"]]
        MC_SEQ_COUNTED.update(reports[0]["seq"])
    real = MC_SEQ_COUNTED
    cfg = mc_config()
    B, S = MC_TRAIN
    t0 = time.perf_counter()
    with dryrun.fake_world(math.prod(MC_SEQ_MESH)):
        dry, mem = dryrun.dry_step(
            cfg, ShapeSpec("phase16g", S, B, "train"),
            make_local_mesh(*MC_SEQ_MESH, device="cpu"))
    rel = abs(dry.dot_flops - real["dot_flops"]) / real["dot_flops"]
    gaps = dot_flop_gaps(dry, types.SimpleNamespace(
        dot_by_op=real["dot_by_op"]))
    want = real["peak"] - real["other"]
    prel = abs(mem["peak_bytes"] - want) / want
    log(f"  (d) {cfg.name} {B} x {S} on {MC_SEQ_MESH[0]} x {MC_SEQ_MESH[1]}, "
        f"rank 0: dry {time.perf_counter() - t0:.1f} s, {dry.ops} ops, "
        f"collectives {dry.counts}; dot FLOPs dry {dry.dot_flops:.6e} / "
        f"real step {real['dot_flops']:.6e}: rel {rel:.3g} (bar "
        f"{DRY_FLOP_RTOL}); ops that differ: {gaps or 'none'}; peak "
        f"estimated {mem['peak_bytes'] / 2**30:.4f} GiB, card "
        f"{real['peak'] / 2**30:.4f} less {real['other'] / 2**30:.4f} = "
        f"{want / 2**30:.4f} GiB: rel {prel:.4f} (bar {DRY_PEAK_RTOL}); "
        f"arguments {real['tracked'] / 2**30:.4f} GiB (dry "
        f"{mem['argument_size_in_bytes'] / 2**30:.4f}); the roofline's "
        f"terms {dry.roofline()} against a real step of {real['ms']:.1f} ms")
    failures = []
    if not rel <= DRY_FLOP_RTOL:
        failures.append(f"(d) dot FLOPs on 1 x 2 differ in {sorted(gaps)}")
    if not prel <= DRY_PEAK_RTOL:
        failures.append(f"(d) estimated peak on 1 x 2 off by {prel:.4f}")
    return failures


def run_dryrun_path(torch, device, src):
    """Phase 17: the dry run against the card. (a) phase 12's smollm-135m
    step at DRY_TRAIN on a DRY_MESH mesh traced on fake tensors in a fake
    world of one rank (``launch.dryrun.dry_step``); (b) the same step for
    real in an NCCL world of one rank on the card: a warm-up step, then
    one under the same ``StepCounter`` with the launch counters set to 0
    before and read after, then DRY_TIMED timed steps. Holds the dot
    FLOPs (DRY_FLOP_RTOL, or the ops that differ named) and the estimated
    peak against ``max_memory_allocated`` less the bytes the card held
    before the step that are not its arguments (the runners' buffers,
    cuBLAS' workspace) within DRY_PEAK_RTOL; prints the roofline against
    the measured step and (c) one production cell's dry run on a fake
    world of 256. Returns (the counted step's launches, failures)."""
    import torch.distributed as dist

    from repro_torch.configs import ShapeSpec
    from repro_torch.data import DataConfig, DataPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import dryrun
    from repro_torch.launch.analysis import StepCounter
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.specs import shard_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_adamw

    failures = []
    cfg = lm_config()
    B, S = DRY_TRAIN
    shape = ShapeSpec("phase17", S, B, "train")
    t0 = time.perf_counter()
    with dryrun.fake_world(math.prod(DRY_MESH)):
        dry, mem = dryrun.dry_step(cfg, shape,
                                   make_local_mesh(*DRY_MESH, device="cpu"))
    log(f"  (a) dry: {time.perf_counter() - t0:.1f} s, {dry.ops} ops; dot "
        f"FLOPs {dry.dot_flops:.6e} (raw {dry.raw_flops:.6e}), HBM bytes "
        f"{dry.hbm_bytes:.6e}, collectives {dry.counts}; memory {mem}")

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh(*DRY_MESH, device=device)
        step, _ = make_train_step(cfg, mesh, shape)
        params = init_params(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(0))
        shards = shard_tree(params, step.shardings[0], step.context)
        del params
        state = init_adamw(shards, step.opt)
        batch = DataPipeline(DataConfig(0, B, S, cfg.vocab),
                             device=device).batch_at(0)
        args = (shards, state, step.block(batch))
        step(*args)                     # warm-up: the OT loss's captures
        sync(torch)
        torch.cuda.empty_cache()
        real = StepCounter()
        other = torch.cuda.memory_allocated(device) - real.track(args)
        torch.cuda.reset_peak_memory_stats(device)
        reset_launch_counts()
        with real:
            out = step(*args)
        sync(torch)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated(device)
        del out
        ms = []
        for _ in range(DRY_TIMED):
            sync(torch)
            t1 = time.perf_counter()
            step(*args)
            sync(torch)
            ms.append((time.perf_counter() - t1) * 1e3)
    finally:
        dist.destroy_process_group()

    rel = abs(dry.dot_flops - real.dot_flops) / real.dot_flops
    gaps = dot_flop_gaps(dry, real)
    log(f"  (b) dot FLOPs dry {dry.dot_flops:.6e} / real step "
        f"{real.dot_flops:.6e}: rel {rel:.3g} (bar {DRY_FLOP_RTOL}); ops "
        f"that differ: {gaps or 'none'}; raw {dry.raw_flops:.6e} / "
        f"{real.raw_flops:.6e}")
    if not rel <= DRY_FLOP_RTOL:
        log(f"  (b) dot FLOPs differ in {sorted(gaps)}")
    want = peak - other
    prel = abs(mem["peak_bytes"] - want) / want
    log(f"  (b) peak: estimated {mem['peak_bytes'] / 2**30:.4f} GiB, card "
        f"{peak / 2**30:.4f} GiB max_memory_allocated less "
        f"{other / 2**30:.4f} GiB held outside the step's arguments = "
        f"{want / 2**30:.4f} GiB: rel {prel:.4f} (bar {DRY_PEAK_RTOL}); "
        f"arguments {real.tracked_bytes / 2**30:.4f} GiB (dry "
        f"{mem['argument_size_in_bytes'] / 2**30:.4f}); the counter's peak "
        f"over the real step {real.peak_bytes / 2**30:.4f} GiB")
    if not prel <= DRY_PEAK_RTOL:
        failures.append(f"(b) estimated peak off the card's by {prel:.4f}")
    terms = dry.roofline()
    step_ms = statistics.median(ms)
    bound_ms = 1e3 * max(terms["compute_s"], terms["memory_s"],
                         terms["collective_s"])
    log(f"  (b) roofline (H100 data sheet): compute "
        f"{terms['compute_s'] * 1e3:.4f} ms, memory "
        f"{terms['memory_s'] * 1e3:.4f} ms, collective "
        f"{terms['collective_s'] * 1e3:.4f} ms -> {terms['dominant']}; a "
        f"real step {step_ms:.1f} ms (median of {DRY_TIMED}: "
        f"{[round(v, 1) for v in ms]}) = {step_ms / bound_ms:.2f}x the "
        f"roofline; launches a step {({k: v for k, v in counts.items() if v})}")
    missing = [k for k in LM_PATH_KERNELS if counts[k] <= 0]
    if missing:
        failures.append(f"(b) kernels never launched: {missing}")
    failures += dry_seq_mesh(torch, src)

    arch, shape_name = DRY_CELL
    out_dir = Path(__file__).resolve().parent / "build" / "dryrun_torch"
    t0 = time.perf_counter()
    cell = dryrun.run_cell(arch, shape_name, multi_pod=False,
                           artifact_dir=str(out_dir))
    log(f"  (c) {arch} x {shape_name} x {cell['mesh']}: "
        f"{time.perf_counter() - t0:.1f} s; peak a rank "
        f"{cell['memory']['peak_bytes'] / 2**30:.3f} GiB, fits "
        f"{cell['memory']['fits']}, dot FLOPs {cell['flops_per_device']:.4e}"
        f", wire {cell['wire_bytes_per_device']:.4e} B, "
        f"{cell['roofline']['dominant']}-bound")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"  {smi.stdout.strip()}")
    return counts, failures


SCALING_PATH_KERNELS = ("feature_contract", "sinkhorn_halfstep",
                        "feature_matvec", "sinkhorn_block")
TRAIN_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep", "log_sinkhorn_block")
SOLVE_PATH_KERNELS = ("gaussian_feature_map", "log_feature_contract",
                      "log_halfstep")
STREAM_PATH_KERNELS = ("paged_feature_contract", "paged_halfstep",
                       "paged_feature_matvec", "log_feature_contract",
                       "log_halfstep")


ALL_PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated phases to run (default: all; the "
                    "result lines need all seventeen)")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the src directory whose repro_torch to drive "
                    "(default: this checkout's; another checkout's, to time "
                    "two versions with one script)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    src = args.src.resolve()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on the card only",
              file=sys.stderr)
        return 2
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}/repro_torch;"
              " run this script from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np

    from repro_torch.core import EpsSchedule
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    log("== phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip() if smi.returncode == 0 else
        f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}; repro_torch from {src}")
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s")
    for name, path in libs.items():
        report = Path(str(path) + ".log")
        if report.is_file():
            for line in report.read_text().splitlines():
                if "Function properties for" in line:
                    log(f"  {name}: {demangle(line.split('for', 1)[1])}")
                elif "registers" in line or "spill" in line:
                    log(f"  {name}:   {line.strip()}")

    errs = {}
    if 2 in phases:
        log("== phase 2: kernels against their plain versions")
        shapes = [(N, R_ANCHORS, D, EPS, False), (1001, 3, 5, 0.5, True),
                  (777, 1000, 3, 0.1, True), (33, 70, 20, 1.0, False),
                  (GAN_BIG_BATCH, 128, D, 0.5, False),
                  (1001, 1001, 64, 0.5, True),      # wide kernel, r % 4 = 1
                  (3001, 70, 130, 2.0, False),      # d past every budget
                  (4097, 70, 16, 1.0, True),        # ragged row tile
                  (2_200_000, 3, 5, 0.5, False)]    # past the old n limit
        lse_shapes = [(N, M, R_ANCHORS, 1, False), (1001, 777, 3, 1, True),
                      (1001, 777, 1000, 3, True), (777, 1001, 1000, 1, False),
                      (1001, 777, 1000, 1, True), (5, 3, 129, 3, True),
                      (5, 3, 128, 1, True)]
        bf16_shapes = [(GAN_BIG_BATCH, GAN_BIG_BATCH, 128, 1, False),
                       (GAN_BIG_BATCH, 1001, 128, 1, True),
                       (1001, 777, 100, 1, True), (1001, 777, 1000, 3, True),
                       (1001, 777, 1032, 1, True),        # contract vectors
                       (5, 3, 129, 1, True)]
        bf, f32 = torch.bfloat16, torch.float32
        block_shapes = [
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.0, 0, 8),
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.3, 5, 8),
            (GAN_BATCH, GAN_BATCH, 128, f32, 1.0, 0, 8),   # not admitted
            (176, 176, 128, f32, 1.0, 3, 8),
            (176, 160, 128, f32, 1.3, 0, 3),
            (200, 120, 100, bf, 1.3, 4, 8),
            (37, 53, 13, f32, 1.0, 2, 8),
            (37, 53, 13, bf, 1.3, 2, 5),
            (20, 24, 1100, bf, 1.0, 1, 8),                  # r wider than the CTA
            (GAN_BIG_BATCH, GAN_BIG_BATCH, 128, bf, 1.0, 0, 8),  # not admitted
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.0, "rank", 8),  # a rank all dead
            (GAN_BATCH, 200, 128, bf, 1.3, "rank", 8),
            (3, 200, 24, f32, 1.0, 0, 8),                   # n < C
            (200, 3, 13, bf, 1.3, 0, 8),                    # m < C, odd r
            (1, 688, 128, bf, 1.0, 0, 8),                   # one xi row
            (352, 352, 128, bf, 1.0, 2, 8),                 # largest bf16
            (352, 352, 128, bf, 1.3, 0, 1),
            (353, 353, 128, bf, 1.0, 0, 8),                 # not admitted
            (176, 176, 128, f32, 1.3, 0, 8),                # largest f32
            (177, 177, 128, f32, 1.0, 0, 8),                # not admitted
        ]
        scaling_shapes = [
            (shape + (dtype,)) for dtype in (f32, bf) for shape in (
                (N, R_ANCHORS, 1), (N, 256, 1), (GAN_BIG_BATCH, 128, 1),
                (1001, 3, 1), (777, 1000, 3), (5, 129, 1), (1001, 1032, 1),
                (300, 40, 11))]                  # B > 8: two column chunks
        scaling_shapes += [                      # row groups: contract only
            (n, r, 1, dtype, "contract") for n in (1001, N)
            for dtype, rs in ((f32, (4, 12, 128, 256)), (bf, (8, 128, 256)))
            for r in rs if (n, r) != (N, 256)]
        scaling_shapes += [                      # the row kernel: rows only
            (n, r, B, dtype, "rows") for dtype in (f32, bf)
            for r in (40, 256, 512, 1024, 4096) for B in (1, 3)
            for n in (1003, 16) if (n, B) != (16, 3)]   # 1003: R does not divide n
        scaling_shapes += [(n, 1024, 1, dtype, "rows") for dtype in (f32, bf)
                           for n in (2, 7)]
        scaling_block_shapes = [
            (GAN_BATCH, GAN_BATCH, 128, bf, mom, dead, 8)
            for mom in (1.0, 1.3) for dead in (0, 5)] + [
            (176, 176, 128, f32, mom, dead, 8)
            for mom in (1.0, 1.3) for dead in (0, 3)] + [
            (37, 53, 13, f32, mom, dead, 8)
            for mom in (1.0, 1.3) for dead in (0, 2)] + [
            (20, 24, 1100, bf, 1.3, 1, 8),                  # r > 512 threads
            (GAN_BATCH, GAN_BATCH, 128, f32, 1.0, 0, 8),    # not admitted
            (GAN_BIG_BATCH, GAN_BIG_BATCH, 128, bf, 1.0, 0, 8),  # not admitted
            (GAN_BATCH, 200, 128, bf, 1.3, 5, 8),           # n != m
            (GAN_BATCH, GAN_BATCH, 128, bf, 1.0, "rank", 8),  # a rank all dead
            (GAN_BATCH, 200, 128, bf, 1.3, "rank", 8),
            (3, 200, 24, f32, 1.0, 0, 8),                   # n < C
            (200, 3, 13, bf, 1.3, 2, 8),                    # m < C, odd r
            (1, 688, 128, bf, 1.0, 0, 8),                   # one xi row
            (37, 53, 13, bf, 1.3, 2, 5),
            (352, 352, 128, bf, 1.3, 2, 8),                 # largest bf16
            (352, 352, 128, bf, 1.0, 0, 1),
            (353, 353, 128, bf, 1.0, 0, 8),                 # not admitted
            (176, 176, 128, f32, 1.3, 3, 1),                # largest f32
            (177, 177, 128, f32, 1.0, 0, 8),                # not admitted
        ]
        errs, failures = check_kernels(torch, np, device, shapes, lse_shapes,
                                       bf16_shapes, block_shapes,
                                       scaling_shapes, scaling_block_shapes)
        if failures:
            log(f"phase 2 FAILED: {failures}")
            return 1

    times = {}
    if 3 in phases:
        log("== phase 3: times at the main path's shape "
            f"(n={N}, r={R_ANCHORS}, d={D}, B=1) and the training path's")
        calibrate_sleep(torch)
        log(f"  device spin ahead of each batch: {SLEEP_MS[0]:.3f} ms")
        launches_per_call(torch, np, device)
        times = time_kernels(torch, np, device)
        time_feature_map(torch, np, device)
        times.update(time_training_kernels(torch, np, device))
        times.update(time_scaling_kernels(torch, np, device))
        time_halfstep_cold(torch, np, device)
        flat_contract_digest(torch, device)
        times.update(time_paged_kernels(torch, np, device))
        batched_rows = time_batched_kernels(torch, np, device)
        batched_rows.update(time_batched_blocks(torch, device))
        for name, row in batched_rows.items():
            times[name] = dict(times[name], batched=row)

    counts = {}
    if 4 in phases:
        log(f"== phase 4: main path (n=m={N}, d={D}, r={R_ANCHORS}, "
            f"eps={EPS}, tol={TOL}, EpsSchedule(eps_init=1.0, decay=0.5))")
        problems, results, div, c4, failures = run_main_path(torch, np,
                                                             device)
        log(f"  launches on the main path: {c4}")
        if failures:
            log(f"phase 4 FAILED: {failures}")
            return 1
        counts["solve"] = c4
        missing = [k for k in SOLVE_PATH_KERNELS if c4[k] <= 0]
        if missing:
            log(f"phase 4 FAILED: kernels never launched: {missing}")
            return 1
        profile_solve(torch, problems[0],
                      EpsSchedule(eps_init=1.0, decay=0.5))
        time_replay_blocks(torch, problems[0],
                           EpsSchedule(eps_init=1.0, decay=0.5))
        time_static_copies(torch, device)
        failures = compare_main_path(torch, problems, results, div,
                                     EpsSchedule)
        if failures:
            log(f"phase 4 FAILED: {failures}")
            return 1
        time_cache_pressure(torch, np, device, problems[0])

    if 5 in phases:
        log(f"== phase 5: training path (OT-GAN trainer, batch {GAN_BATCH}, "
            f"r=128, eps=0.5, 40 iterations, {GAN_STEPS} steps; bench_gan "
            f"gradient at batch {GAN_BIG_BATCH})")
        c5, failures = run_training_path(torch, np, device)
        log(f"  launches on the training path: {c5}")
        counts["train"] = c5
        missing = [k for k in TRAIN_PATH_KERNELS if c5[k] <= 0]
        if missing:
            failures.append(f"kernels never launched: {missing}")
        if failures:
            log(f"phase 5 FAILED: {failures}")
            return 1
    if 6 in phases:
        log(f"== phase 6: scaling path (features n=m={N}, r={R_ANCHORS} and "
            f"256, eps={SCALING_EPS}, {SCALING_ITERS} iterations; clouds at "
            f"eps=1.0, tol={TOL}; objective at batch {GAN_BATCH}; divergence "
            "at n=m=4096, r=256)")
        t6 = time.perf_counter()
        inputs, out, c6, failures = run_scaling_path(torch, np, device)
        log(f"  launches on the scaling path: {c6}")
        counts["scaling"] = c6
        failures += compare_scaling_path(torch, inputs, out)
        log(f"  phase 6: {time.perf_counter() - t6:.1f} s")
        if failures:
            log(f"phase 6 FAILED: {failures}")
            return 1
    if 7 in phases:
        log(f"== phase 7: streaming path (two stores of {N} live points, "
            f"d={STREAM_D}, capacity {STREAM_CAPACITY}, page {STREAM_PAGE}, "
            f"r={R_ANCHORS}, eps={STREAM_EPS}, tol={TOL}; "
            f"{STREAM_MUTATIONS} mutations of "
            f"{STREAM_DELTA} evictions and insertions a side, coalesced 4 to "
            "a flush, then 2 direct updates; scaling f32, scaling bf16, log "
            "f32)")
        t7 = time.perf_counter()
        c7, failures = run_streaming_path(torch, np, device)
        log(f"  launches on the streaming path: {c7}")
        counts["stream"] = c7
        missing = [k for k in STREAM_PATH_KERNELS if c7[k] <= 0]
        if missing:
            failures.append(f"kernels never launched: {missing}")
        log(f"  phase 7: {time.perf_counter() - t7:.1f} s")
        if failures:
            log(f"phase 7 FAILED: {failures}")
            return 1
    if 8 in phases:
        log(f"== phase 8: families path (arc-cosine n=m={N}, r={R_ANCHORS} "
            f"-> {R_ANCHORS + 1} features, eps={EPS}, f32 and bf16, and at "
            f"n={FAM_SMALL}, r+1={FAM_SMALL_R + 1}; Nystrom rank {NYS_RANK} "
            f"at eps {NYS_EPS}; grid {GRID_SIDE}x{GRID_SIDE} eps={GRID_EPS};"
            f" accelerated at eps={ACC_EPS}; barycenters; tol={TOL})")
        t8 = time.perf_counter()
        inp, probs, out, c8, failures = run_families_path(torch, np, device)
        log(f"  launches on the families path: {c8}")
        counts["families"] = c8
        failures += compare_families(torch, np, device, inp, probs, out)
        time_families(torch, probs, out)
        log(f"  phase 8: {time.perf_counter() - t8:.1f} s")
        if failures:
            log(f"phase 8 FAILED: {failures}")
            return 1
    if 9 in phases:
        log(f"== phase 9: batched path (P={BATCH_P} problems of n=m="
            f"{BATCH_N}, r={BATCH_R}, eps={BATCH_EPS}, factored and "
            f"log_factored in f32 and bf16; {BATCH_P} cloud pairs annealed "
            f"to eps {BATCH_CLOUD_EPS}; solve_many over {BATCH_SUPPORTS}; "
            f"the quickstart; tol={TOL})")
        t9 = time.perf_counter()
        (inp, ragged, engines, cloud_engine, out, c9,
         failures) = run_batched_path(torch, np, device)
        log(f"  launches on the batched path: {c9}")
        counts["batched"] = c9
        failures += compare_batched_path(torch, np, device, inp, ragged,
                                         engines, cloud_engine, out)
        t9b = time.perf_counter()
        log(f"  GAN minibatch: {GAN_MB_P} OT-GAN-shaped cloud pairs "
            f"(n=m={GAN_BATCH}, d={GAN_MB_D}, r={GAN_MB_R}, eps="
            f"{GAN_MB_EPS}, bf16) through solve_point_clouds and "
            f"solve_stacked, the batched divergence at n=m={GAN_MB_DIV_N} "
            "f32 with its gradient")
        (gan_inp, gan_engines, gan_calls, gan_out, c9b,
         more) = run_gan_minibatch(torch, np, device)
        log(f"  launches on the GAN-minibatch path: {c9b}")
        counts["gan_minibatch"] = c9b
        failures += more
        failures += compare_gan_minibatch(torch, device, gan_inp,
                                          gan_engines, gan_calls, gan_out)
        log(f"  GAN minibatch part: {time.perf_counter() - t9b:.1f} s")
        log(f"  phase 9: {time.perf_counter() - t9:.1f} s")
        if failures:
            log(f"phase 9 FAILED: {failures}")
            return 1
    if 10 in phases:
        log(f"== phase 10: serving path (trace of "
            f"{SERVE_TRACE['n_requests']} requests over "
            f"{SERVE_TRACE['pool_size']} pairs, r={SERVE_TRACE['r']}, "
            f"eps={SERVE_TRACE['eps']}, size classes "
            f"{SERVE_TRACE['size_classes']}; OTService {SERVE_METHODS}, "
            f"tol={SERVE_TOL}, max_batch={SERVE_MAX_BATCH}, max_wait="
            f"{SERVE_MAX_WAIT}; the ot_service lanes)")
        t10 = time.perf_counter()
        c10, failures = run_serving_path(torch, np, device)
        log(f"  launches on the serving path: {c10}")
        counts["serving"] = c10
        log(f"  phase 10: {time.perf_counter() - t10:.1f} s")
        if failures:
            log(f"phase 10 FAILED: {failures}")
            return 1
    if 11 in phases:
        log("== phase 11: the autotuner (a fresh cache under build/, tuning "
            "on: the flat contract, the row kernel, the log contract, the "
            "log half-step and the log megakernel) and the sharded solves "
            f"(an NCCL world of 1 and a gloo world of 2 on card 0: phase 4's"
            f" annealed request, phase 6's feature solve, the divergence "
            f"with gradients at n=m={SHARD_DIV_N})")
        t11 = time.perf_counter()
        failures = run_tuner(torch, np, device)
        c11, more = run_sharded_path(torch, np, device, src)
        failures += more
        if c11 is not None:
            counts["sharded"] = c11
        log(f"  phase 11: {time.perf_counter() - t11:.1f} s")
        if failures:
            log(f"phase 11 FAILED: {failures}")
            return 1
    if 12 in phases:
        log(f"== phase 12: the LM surfaces ({LM_ARCH} at full width and "
            f"depth: (a) the OT loss at {LM_BATCH} x {LM_SEQ}, kernels vs "
            f"plain operators; (b) one step at {LM_CHECK_BATCH} x {LM_SEQ}, "
            f"card vs CPU; (c) {LM_STEPS} steps at {LM_BATCH} x {LM_SEQ} "
            f"with a checkpoint after step {LM_SAVE_AT - 1} and a resume; "
            f"(d) launch.serve at batch {LM_SERVE_BATCHES}; (e) the drivers "
            "as subprocesses)")
        t12 = time.perf_counter()
        c12, failures = run_lm_path(torch, np, device, src)
        log(f"  launches on the LM path: {c12}")
        counts["lm"] = c12
        log(f"  phase 12: {time.perf_counter() - t12:.1f} s")
        if failures:
            log(f"phase 12 FAILED: {failures}")
            return 1
    if 13 in phases:
        log(f"== phase 13: the MoE family ({MOE_ARCH} at full width, "
            f"{MOE_DEPTH}: (a) the Sinkhorn router at T={ROUTE_T} for "
            f"{[c[0] for c in ROUTE_CELLS]}, card vs CPU; (b) serving at "
            f"{MOE_SERVE} and one MLA layer in float32; (c) train_loss at "
            f"{MOE_TRAIN}, kernels vs plain; (d) one MoE layer of "
            f"{MOE_ORACLE[0]} vs an expert-loop oracle; (e) train, serve "
            "and train_lm on the tiny MoE configs)")
        t13 = time.perf_counter()
        c13, failures = run_moe_path(torch, np, device, src)
        log(f"  launches on the MoE path: {c13}")
        counts["moe"] = c13
        log(f"  phase 13: {time.perf_counter() - t13:.1f} s")
        if failures:
            log(f"phase 13 FAILED: {failures}")
            return 1
    if 14 in phases:
        log(f"== phase 14: the SSM and hybrid families ({SSM_ARCHS} at full "
            f"width and depth, float32: (a) one mixer's two SSD forms on "
            f"{SSM_MIXER[0]} x {SSM_MIXER[1]} tokens; (b) train_loss at "
            f"{SSM_CHECK[0]} x {SSM_CHECK[1]}, card vs CPU, at "
            f"{SSM_CHECK_DEPTH} layers; (c) train_loss at {SSM_TRAIN[0]} x "
            f"{SSM_TRAIN[1]}, kernels vs plain; (d) launch.train, "
            f"{SSM_STEPS} steps, zamba2's with a checkpoint and a resume; "
            f"(e) "
            f"launch.serve at {SSM_SERVE}; (f) long_500k caches, a "
            f"{SSM_WRAP[0]}-slot window wrapped over {SSM_WRAP[1]} steps, "
            "decode steps at length 64 and 524287; (g) the drivers on the "
            "tiny configs)")
        t14 = time.perf_counter()
        c14, failures = run_ssm_path(torch, np, device, src)
        log(f"  launches on the SSM path: {c14}")
        counts["ssm"] = c14
        log(f"  phase 14: {time.perf_counter() - t14:.1f} s")
        if failures:
            log(f"phase 14 FAILED: {failures}")
            return 1
    if 15 in phases:
        log(f"== phase 15: the encoder-decoder family ({ENCDEC_ARCH} at full "
            f"width and depth, float32: (a) one layer's cross-attention in "
            f"its two forms over {ENCDEC_FRAMES} frames, {ENCDEC_XATTN[0]} x "
            f"{ENCDEC_XATTN[1]} tokens; (b) train_loss at {ENCDEC_CHECK[0]} x"
            f" {ENCDEC_CHECK[1]}, card vs CPU; (c) train_loss at "
            f"{SSM_TRAIN[0]} x {SSM_TRAIN[1]}, kernels vs plain; (d) "
            f"launch.train, {SSM_STEPS} steps with a checkpoint and a "
            f"resume; (e) decode over the encoder's K/V vs forward, "
            f"launch.serve at {ENCDEC_SERVE}; (f) decode_32k at batch "
            f"{ENCDEC_LONG_BATCH}; (g) the drivers on the tiny config)")
        t15 = time.perf_counter()
        c15, failures = run_encdec_path(torch, np, device, src)
        log(f"  launches on the encoder-decoder path: {c15}")
        counts["encdec"] = c15
        log(f"  phase 15: {time.perf_counter() - t15:.1f} s")
        if failures:
            log(f"phase 15 FAILED: {failures}")
            return 1
    if 16 in phases:
        log(f"== phase 16: multi-card LM training and serving (a gloo world "
            f"of 2 on card 0: (a) the collectives gloo takes on CUDA "
            f"tensors; (b) {MC_ARCH} at full width and depth, one step at "
            f"{MC_TRAIN[0]} x {MC_TRAIN[1]} on {MC_MESH[0]} x {MC_MESH[1]} "
            f"against one card, then {MC_TIMED} timed; (c) compressed_psum "
            f"and ef_compress_tree on its gradients; (d) {MC_MOE[0]}'s MoE "
            f"layer through expert parallelism on 1 x 2 at {MC_MOE[1]} x "
            f"{MC_MOE[2]} tokens; (e) mamba2-1.3b's SSD context parallel on "
            f"1 x 2 at {MC_SSD[0]} x {MC_SSD[1]}; (f) launch.train --mesh "
            f"2x1 with a checkpoint and a resume, decode on the mesh; (g) "
            f"(b)'s step on {MC_SEQ_MESH[0]} x {MC_SEQ_MESH[1]}, the "
            f"sequence split, against one card, one step counted; then "
            f"an NCCL world of 1: (d) on 1 x 1)")
        t16 = time.perf_counter()
        c16, failures = run_multicard_path(torch, src)
        log(f"  launches on the multi-card path (rank 0, {MC_TIMED} steps): "
            f"{c16}")
        if c16 is not None:
            counts["multicard"] = c16
        log(f"  phase 16: {time.perf_counter() - t16:.1f} s")
        if failures:
            log(f"phase 16 FAILED: {failures}")
            return 1
    if 17 in phases:
        log(f"== phase 17: the dry run against the card ({LM_ARCH} at full "
            f"width and depth, float32: (a) one step at {DRY_TRAIN[0]} x "
            f"{DRY_TRAIN[1]} on {DRY_MESH[0]} x {DRY_MESH[1]} traced on fake "
            f"tensors; (b) the same step on the card, dot FLOPs and peak "
            f"memory against (a), the roofline against its time; (d) phase "
            f"16 (g)'s step on {MC_SEQ_MESH[0]} x {MC_SEQ_MESH[1]} dry "
            f"against its counted step; (c) "
            f"{DRY_CELL[0]} x {DRY_CELL[1]} dry on a fake world of 256)")
        t17 = time.perf_counter()
        c17, failures = run_dryrun_path(torch, device, src)
        log(f"  launches on the dry run's real step: {c17}")
        counts["dryrun"] = c17
        log(f"  phase 17: {time.perf_counter() - t17:.1f} s")
        if failures:
            log(f"phase 17 FAILED: {failures}")
            return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if phases != set(ALL_PHASES):
        log(f"phases {sorted(phases)} passed; no result line without all "
            "seventeen")
        return 0

    kernels = []
    for name, info in KERNEL_INFO.items():
        by_path = {path: c[name] for path, c in counts.items()}
        kernels.append(dict(name=name, route="cuda", source=info["source"],
                            replaces=info["replaces"],
                            launches=sum(by_path.values()),
                            launches_by_path=by_path,
                            max_abs_err=errs[name], **times[name]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
