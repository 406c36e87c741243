"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):

1. device  — a CUDA device of compute capability 9.0 is required; prints
             the card's name and power limit (nvidia-smi), torch and CUDA
             versions.
2. build   — compiles the CUDA sources of src/repro_torch/csrc (one nvcc
             per source, all started together).
3. parity  — each kernel against its plain PyTorch version, bit for bit.
             Single-row kernels: code_bits {2, 4, 8, 16} x the six
             predicates x constants {0, 1, vmax//2, vmax-1, vmax} x n_words
             {1, 127, 32771, 2^22+17}, a 16-bit all-selected column whose
             sum passes 2^31, and a numpy oracle on the small sizes.
             Batched kernels: every width x n_chunks {1, 7, 4096} x n_words
             {1, 131, 2052} and a full 16-bit chunk, ragged validity with an
             empty chunk, the six predicates at a random constant per chunk;
             the RLE kernels over the six predicates at n_chunks {1, 7, 8,
             9, 4096} x n_runs {1, 3, 31-33, 127-129, 1001, 1535-1537,
             4096} (both routes and their edges), zero-length runs
             included, and on planes one int32 off a 16-byte boundary;
             the cases each route took are printed, and a route that took
             none fails.
4. main    — the query engine's flat path at full size: a 2^30-row table
             {"a": 8, "b": 8, "w": 16, "x": 4} built on the card from a
             seeded torch.Generator, the eleven plan shapes of the engine
             tests answered by QueryEngine(mode="auto") and compared with
             QueryEngine(mode="torch_ref") on the same table; the flat
             path's kernels' launch counters must have moved.
5. times   — each flat-path kernel at the main path's shapes: the median
             of 20 CUDA-event samples after 3 warm-ups, a sample being one
             call with its host work (ms) or 20 launches back to back
             (ms_back_to_back, per launch); its plain version's time; and
             the bound: the larger
             of bytes over the card's memory rate and operations over its
             CUDA-core rate.
6. profile — the eleven queries again, warm, then under torch.profiler:
             the device's busy share and device time by kernel name.
7. store   — the compressed store at full size: the store tests' column
             mix at 2^28 rows, built on the card and encoded there in
             65536-row chunks (4096 a column); the sixteen store plan
             shapes cold and warm through QueryEngine(encoded, "auto"),
             against QueryEngine(plain table, "auto") and
             QueryEngine(encoded, "torch_ref"), and one per-chunk pass
             (batched=False); the store path's kernels' launch counters
             must have moved.
8. store times / store profile — the batched and RLE kernels at the store
             path's shapes (and the RLE kernels at the largest legal plane
             and its run count), timed as in 5, the RLE kernels also split
             into device ms a launch (torch.profiler) and the host's µs a
             call (HOST_CALLS calls enqueued with no synchronise); the
             store queries under torch.profiler.

The grouped slice (GroupBy / HashJoin) adds to these phases:

3. parity  — the grouped kernels (dense group_sum_count, RLE
             rle_group_accumulate) against their plain versions, bit for
             bit: G {1, 8, 100, 1024} x n_chunks {1, 7, 4096} with ragged
             rows and select, keys outside the domain, contiguous and join
             (non-contiguous) domains, a 65536-row chunk of 65535s and one
             (1, 2^23, 128) chunk; the RLE kernel over no predicate, ge and
             eq, each plain and inverted, x n_runs {1, 3, 1001, 4096},
             zero-length runs, and the one-run chunk whose int32 sum wraps
             as the reference's does.
4b. grouped main — after the main profile, six GroupBy/HashJoin shapes on
             the 2^30-row table through QueryEngine(mode="auto"), against
             QueryEngine(mode="torch_ref"), the port's oracle on the card,
             and (GroupBy) the flat engine's totals; kernel 8 timed at the
             main path's shape (a over w, G = 128).
7b. grouped store — the seven grouped shapes of tests/test_relational.py
             on the 2^28-row store, cold then warm, against the torch_ref
             engine, the oracle and the plain table's engine; kernels 8
             and 9 timed at the store's shapes (r over u, G = 8; r's run
             planes) and kernel 9 at 4096 x 4096 runs.

The tier slice (placement, prefetch, the energy meter, the power cap)
adds, after 7b, while the store's tables live:

7c. tiered main — the fast tier's rate measured in this run: a fresh
             tune cache filled by tune.autotune over kernel 3 at 2^28
             words, read by measured_fast_gbps (the run fails without
             it), the capacity tier at that rate over Table 1's 2.5. Then
             benchmarks/tier_bench.py's table (sixteen 8-bit columns) at
             2^28 rows on the card, 1 MiB placement chunks, the fast tier
             a quarter of it: replay_trace of 150 queries at skews 0.6,
             1.1 and 1.5 under STATIC, CACHE and MEMCACHE, deadlines at
             twice the mean query's all-fast time; at 1.1 under MEMCACHE
             also with prefetch (an eighth of the fast tier), with the
             die-stacked chip's 96 W compute term uncapped and capped at
             half its demand (window 20 deadlines), with GroupBy/HashJoin
             in the mix, and through torch_ref. Every answer equals a
             torch_ref engine's; the torch_ref replay's placement stats,
             ledger, tier dicts and attainment equal the kernel replay's;
             prefetch is never slower; no window exceeds the cap; the fast
             tier never holds more than its capacity (placement's budget
             raises first); kernels 1-3 and 8 must have launched. Prints, per replay, hit rate, blended
             GB/s, attainment, joules by tier and compute, modeled
             service and the host's ms a query with the tier layer's
             share (placement, prefetch plan, chunk accounting, governor).
7d. tiered store — the store's plain table and its encoded copy through
             one 60-query skew-1.1 trace under CACHE (the fast tier a
             quarter of the plain bytes), three RLE queries after it;
             answers equal across both and torch_ref; kernels 4, 5, 7 and
             9 must have launched. Prints both hit rates and byte totals.
             The launches of both phases stand in the {"kernels": ...}
             line as each kernel's "launches_tiered".

The paper model slice (core/, energy/tco.py, no kernel of its own) adds:

6b. paper model — after the main profile, on the 2^30-row table: the
             eleven plans through a fresh QueryEngine(mode="auto"), then
             again through another (the warm pass), then the five fused
             plans alone; answers against torch_ref; kernels 1-3 must have
             launched (their counts stand in the {"kernels": ...} line as
             "launches_paper_model"). model_check() on the H100 row (the
             warm pass's attained fraction of Eq. 4 must lie in (0, 1.05])
             and on DIE_STACKED, for each engine; provision() at 10 and
             100 ms on the H100 row and Table 1's three systems, each
             within its SLA and equal to advisor.advise_scan_sla called by
             hand with the engine's counters; the paper's 16 TiB at 20% at
             the measured rate.
7e. paper model (tier split, cost, sweep) — after the tiered phases:
             advise_tier_split at the tiered main phase's fast and capacity
             rates and its skew-1.1 MEMCACHE hit rate at 25% (the H100 row
             as fast system must hold the measured rate within its Eq. 4
             roofline; the default, the paper's 192 GB/s node, is printed
             beside it); cheapest_architecture over Table 1 and the H100
             row at 10 ms and 1 s, 1 MW, the store's measured ratio, and
             evaluate_tiered at the measured fast rate over the H100 row
             (which must price a node); sweep_performance over 64 SLAs on
             the card against the same call on the CPU (SWEEP_RTOL; the
             gradients GRAD_RTOL) and against the scalar model (2%).
             One JSON line {"paper_model": {...}} holds the records.

The LM serving slice (internlm2-1.8b) adds:

3. parity  — the attention kernels (decode_attention, flash_attention)
             against their plain versions on the card, fp32 and bf16,
             within ATTN_TOL: the shapes of tests/test_kernels.py, the
             serving path's (decode q (8, 8, 2, 128) over an (8, 8, 8192,
             128) ring; prefill (1, 8, 2, 4096, 128)), wrapped rings,
             windows {64, 512}, empty slots, rows whose every slot is
             masked, ragged Sq / Skv (100, 1000) and G {1, 2, 8}; for the
             redesigned kernels, flash at Sq = Skv = 1000 (D 64, 128), Sq
             130 over Skv 4100, windows {100, 129} and G {1, 4, 8}, and
             decode rings whose valid slots lie only in the last tile, one
             in each of five scattered tiles, in a window band across the
             wrap, or inside one split's run; then controls (a 2% wrong
             softmax scale, a dropped tail of 64 slots) that the limit must
             reject.
3b. graph replay — each attention kernel's call captured once in a CUDA
             graph at the serving path's shapes and replayed twice over
             new inputs; each replay equal to an eager call bit for bit,
             and kernel 10's split tickets back at zero.
9. serve   — after the query phases, with their tables freed: the model
             at its published widths and depth in bf16, random weights
             from a seeded generator on the card, attn_impl="flash";
             ServeEngine(batch_slots=8, max_len=8192) answers 16 requests
             (prompts of 1024..4096 tokens drawn from seed 0, 64 new
             tokens each), then SLAScheduler the same prompts at the decode
             rate the first run measured. Prints prefill ms by request,
             decode-step p50/p95/p99, tokens/s, the bytes each step had
             to move (weights, pos planes, K/V of the valid ring slots)
             over step time, peak memory, the scheduler's summary and a
             profiled window's device busy share (SERVE_PROFILE: 2
             prompts of 2048, 8 new tokens); kernels 10 and 11 must
             have launched.
10. serve parity — teacher-forced: one 4096-token prefill and 16 decode
             steps under attn_impl="flash" and "auto", same weights; the
             logits within TF_MAX_ABS / TF_MEAN_ABS and the greedy tokens
             equal wherever "auto"'s top-2 margin exceeds TF_MAX_ABS.
11. attention times — kernels 10 and 11 at the serving path's shapes,
             with scaled_dot_product_attention as the library yardstick
             (one call and back to back), and the bytes kernel 10's plan
             reads there.

The Mamba-2 serving slice (mamba2-1.3b) adds:

3. parity  — the SSD chunk-scan kernel (kernel 12) against its plain
             version on the card, y and the final state, fp32 and bf16,
             within SSD_TOL, on both its routes (kernel.route: the tensor
             cores for bf16 at P <= 64, the CUDA cores otherwise): the
             shapes of tests/test_kernels_ssd.py, the serving path's (one
             4096-token row, 64 heads of 64, state 128, chunks of 256), a
             short prompt's one chunk at those widths (Q 64, 100, 192),
             ragged chunks (100, 255, a one-step chunk), inbound states,
             P {16 .. 128}, N {7 .. 128}; then controls (the decay rate A
             2% off, the state dropped at one chunk boundary) that the
             limit must reject.
12. serve mamba2 — the model at its published widths and depth in bf16,
             random weights from a seeded generator on the card;
             ServeEngine(batch_slots=8) answers 16 requests (prompts of
             1024..4096 tokens in multiples of the 256-step chunk, drawn
             from seed 0; 64 new tokens each). Prints prefill ms by
             request, decode-step p50/p95/p99, tokens/s, the bytes a step
             must move (weights, SSM and conv states read and written) over
             step time, peak memory and a profiled window's busy share
             (SERVE_PROFILE); kernel 12 must have launched 48 times a
             prefill.
13. serve mamba2 parity — teacher-forced: one 4096-token prefill through
             the kernel, through the plain scan (ssm.apply's mode=) and
             through the plain scan at chunk 128 (the same function's own
             spread), then 16 decode steps from each; every block's output
             and the logits within SSD_FLOOR_X times the spread, greedy
             tokens equal where the margin is clear.
14. ssd times — kernel 12 at the serving path's shape on its tensor-core
             route, the bound at the bf16 tensor-core rate (the fp32 CUDA-
             core bound beside it), device time by kernel from a profiled
             window, and the CUDA-core route at the same shape in the same
             call; no library call.

The Griffin and MoE serving slice (recurrentgemma-2b, moonshot-v1-16b-a3b,
mixtral-8x22b; the RG-LRU and MoE blocks are plain tensor work, their
attention runs kernels 10 and 11) adds:

3. parity  — kernels 10 and 11 also at the three paths' shapes, fp32 and
             bf16: KVH 1, G 10, D 256, window 2048 (recurrentgemma); KVH
             16, G 1, D 128 (moonshot); KVH 8, G 6, D 128, window 4096
             (mixtral); ragged fills, an empty slot, rings wrapped past
             the window, ragged prefills; kernel 11's D 256 tile (64 keys,
             two stages) at ragged tiles, windows ending inside a tile and
             G 1, 3 and 10; the controls again at recurrentgemma's D 256
             shapes.
15. parity (rglru and moe blocks) — at each model's full width, fp32
             weights from a seed, TF32 off, the same port code on the card
             and on the CPU: one RG-LRU block's apply over 1024 steps and
             16 decode steps (outputs and states), one MoE block in each
             routing mode (moonshot's sigmoid scores with a nonzero
             selection bias, mixtral's softmax) at capacity factor 0.5, so
             choices drop: expert ids and dispatch planes equal exactly,
             outputs within BLOCK_TOL; then the doubling RG-LRU scan
             against the sequential recurrence at (1, 4096, 2560) within
             SCAN_TOL, and a control (the inbound state dropped) that the
             limit must reject.
16. serve recurrentgemma / moonshot / mixtral — each model at its
             published widths in bf16, random weights from a seeded
             generator on the card, attn_impl="flash" (recurrentgemma-2b
             at its 26 layers through ServeEngine(8, 8192); moonshot at
             its 48 through ServeEngine(8, 4224), which holds its 4096 +
             64 tokens beside 52.3 GiB of weights; mixtral-8x22b at 8 of
             its 56 layers, printed as reduced, through ServeEngine(8,
             8192)): the 16 requests of the serve phase. Prints
             prefill ms by request, decode-step p50/p95/p99, tokens/s, the bytes a
             step must move (the weights it reads, of the experts only
             those its routing chose, the rings' valid K/V, recurrent
             states read and written) and their bound at 3.35 TB/s, peak
             memory and a profiled window (GRIFFIN_PROFILE: 1 prompt, 4
             new tokens); the
             parameter count must equal cfg.param_count() and kernels 10
             and 11 must have launched. Then the teacher-forced check of
             serve parity (4096 + 16, "flash" against "auto"); for the MoE
             models each layer's expert ids are recorded in both runs and
             printed as flips; the bound is held at every position whose
             routing agrees in every layer and at every other position
             within it; a position whose routing differs and whose logits
             leave the bound is excused, and excusing more than a quarter
             of the positions fails.
17. recurrentgemma times — kernel 10 at recurrentgemma's decode shape
             and kernel 11 at its prefill shape (bf16, D 256, G 10, window
             2048, S 4096) on the route kernel.route gives (the tensor
             cores), with SDPA beside each, and kernel 11's CUDA-core route
             (way="cuda_core") at the same shape in the same call;
             recorded in the {"kernels": ...} entries of 10 and 11 with
             each path's launches ("launches_<arch>").

The sharded slice (virtual shards on the card, degraded re-execution,
chaos) adds:

4c. sharded main — after grouped times (main), the 2^30-row table
             sharded 8 ways (no padding: the table's own words) and 7 ways
             (padded): the eleven plans through QueryEngine(sharded,
             "auto"), each answer against the unsharded engine's, a
             torch_ref sharded engine's and the merged execute_partials;
             kernels 1, 4 and 5 must have launched. Prints ms and GB/s a
             plan beside the unsharded ones, rows_per_shard, padding bytes,
             and model_check (chips = the virtual shards, as the reference
             counts them) with the rate against one card's Eq. 4.
4d. sharded grouped (main) — the main table's delta view built
             (EncodedTable at 65536-row chunks, ShardedEncodedTable over 8
             shards); the six grouped main shapes on the 8-shard plain and
             delta views against the grouped main phase's answers; kernel 8
             must have launched on each.
4e. degraded — on both 8-shard views: execute_degraded (three flat
             queries) and
             execute_grouped_degraded (three grouped shapes) with shards
             [0], [3, 5] and seven of eight lost, each answer equal to the
             fault-free one with recovered bytes > 0; all eight lost must
             raise DegradedResultError. Prints ms a call.
7f. sharded store / sharded grouped (store) — after grouped times
             (store): ShardedEncodedTable over the 2^28-row store, 8 shards,
             the sixteen store plans against the unsharded store's answers
             and torch_ref (nbytes printed against the plain and encoded
             footprints); the seven grouped store shapes on its 8-shard
             plain and delta views against the grouped store phase's
             answers.
7g. chaos — after the paper model phases: examples/chaos_replay.py's
             replay scaled to 8 x 2^24 rows in 16384-row chunks (1024 a
             column), FaultSpec(seed=42, stall_rate=0.1, corrupt_rate=0.05),
             CACHE, skew 1.2, 120 queries: twice with recovery (attainment,
             fault counts, recovery joules, answers and ledger equal), once
             without (attainment lower, every answer it gives exact), once
             through torch_ref (equal to the first); prints host wall and
             the guard's verification share of it. Then seeded shard losses
             over the 8-shard view of the tiered main table (kernel and
             torch_ref replays with equal ledgers, every answer exact).
             One JSON line {"sharded": {...}} holds the slice's records;
             each kernel's launches there stand in the {"kernels": ...}
             line as "launches_sharded".

The observability slice (audit, critical path, exports, the SLO
monitor; no kernel of its own) adds:

7g. chaos   — the second recovery replay (auto) and the torch_ref one
             are traced and monitored (SLOMonitor(target 0.9, cadence
             half the SLA), burn windows flushed after the last
             completion); the first and the no-recovery replays are not,
             so the first-vs-second check shows tracing moves no number.
             Their Chrome trace JSON, alerts JSON, digest and the
             waterfall of the most fault-afflicted query must be equal;
             check and verify must pass. Prints the alert count (a
             missing fast_burn alert is reported, not failed), the head
             of that waterfall and whatif_fast_fraction over the
             attribution. The shard-loss kernel replay is traced; check
             and verify must pass and it must hold shard_failover spans.
7h. observability (tiered) — the tiered main table at full size through
             the grouped mix at skew 1.1 under CACHE with prefetch and the
             96 W compute term under the tiered main phase's cap: traced
             and monitored in auto and in torch_ref, then untraced in
             auto. The traced accounting (attainment, rejected, ledger,
             placement stats, tier dicts, summary without trace/slo) must
             equal the untraced one and torch_ref's; both traced runs'
             exports must be equal; check and verify must pass; kernels
             1-3 and 8 must have launched. Then the tiered store's
             encoded replay, traced and monitored in both modes, against
             the tiered store phase's untraced record (kernels 4, 5, 7
             and 9). Prints the attribution's fractions (also of SLA-miss
             time), the alert count, each export's length and sha256, and
             the host wall traced against untraced.
7i. observability (card and CPU) — tests/test_obs_analysis.py's
             monitored chaos replay (8 x 8192 rows, 512-row chunks, 40
             queries) on the card (auto) and on the CPU (torch_ref) in
             this process: every export must be byte-identical.
             One JSON line {"obs": {...}} right after the {"sharded": ...}
             line holds the slice's records; each kernel's launches in
             the traced replays stand in the {"kernels": ...} line as
             "launches_obs".

The launchers (repro_torch.launch.train and .serve, with the data
pipeline, the checkpoint store and the supervisor) run after the Griffin
/ MoE phases, before the training slice, at mamba2-1.3b's published
widths, bf16 (the launchers' attn_impl="auto" reaches no attention
kernel; every SSD layer's forward is kernel 12); the train launcher and
the phases that reuse its run (18d-18f) at LAUNCH_LAYERS = 24 of its 48
layers since PR 32, launch.serve at 48:

18a. train launcher mamba2 — launch.train.main with --seq-len 2048
             --global-batch 1 --steps 5 --checkpoint-every 3 and a
             checkpoint, heartbeat and metrics directory under
             build/launch; the built step's 4th call raises once after
             the real step updated the state, so the supervisor restores
             step 3 in place and finishes at 5 after one restart. Then an
             uninterrupted 5-step run without checkpoints, the first
             run's state dropped before it: every leaf of its final state
             must equal the supervised run's final checkpoint bit for
             bit, read leaf by leaf. Kernel 12 must launch 48 x 6 and 48
             x 5 times (remat "block": twice a layer a step). Prints the losses, the median step, each save's
             snapshot and write ms, the restore's wait, read and load
             ms, the checkpoint's bytes and write GB/s, peak device GiB
             and peak host RSS, the heartbeat and the straggler flags;
             deletes build/launch afterwards.
18b. serve launcher mamba2 — launch.serve.main(["--arch", "mamba2-1.3b",
             "--no-reduced"]) at the reference's defaults (8 requests, 16
             new tokens, 4 slots): every request answered with 16 tokens
             in the vocabulary; kernel 12 launches once a layer a
             prefill. Prints p50 / p95 / p99 and tok/s.
             One JSON line {"launch": {...}} before the {"train": ...}
             line holds both records; their launches stand in the
             {"kernels": ...} line as "launches_launch".

The distribution slice (logical-axis sharding over virtual positions of
the card, repro_torch.dist and repro_torch.launch.specs): every position
of a mesh lives on the one device, so a sharded step must give the same
bits as the one-position step.

18c. sharded serve mixtral — after mixtral's serve phase, on its weights
             (8 of 56 layers, attn_impl="flash"): specs.build_prefill and
             build_serve on a (2, 4) mesh, a 2048-token prompt and 8
             greedy steps, logits and tokens equal to
             engine.make_prefill_step / make_serve_step's bit for bit;
             kernels 11 and 10 launch once a layer a prefill and a step.
18d. sharded train mamba2 — between the train launcher phases and the
             serve launcher: launch.train.main with --mesh 2,4 on the
             uninterrupted run's batches; every leaf of its final state
             equal to that run's (still held) bit for bit; 25
             logical_constraint calls a step (the recompute counts
             none); kernel 12 48 x 5. Prints
             the median step beside the one-position run's and MFU
             against the card and a position.
18e. pipeline and compression: compressed psum — compressed_psum_pod on
             a (4, 2) ("pod", "data") mesh over the sharded run's full
             gradient tree from one step, each leaf within 2e-2 of 4x
             the leaf; error_feedback_compress over 50 steps of one leaf
             within 1e-2. Prints int8 against fp32 bytes.
18f. elastic resume mamba2 — a second process (python -c over
             launch.train.main) resumes the supervised run's step-3
             checkpoint with --mesh 8,1 and runs to step 5; its step-5
             checkpoint equal to the uninterrupted run's state bit for
             bit; kernel 12 48 x 2. build/launch is deleted after it.
18g. pipeline and compression: gpipe — after the serve launcher: 4
             virtual stages x 8 microbatches of (1, 4096, 2048) bf16,
             stage tanh(x @ w), against the sequential composition and
             an fp32 oracle (PIPE_X, PIPE_FLOOR); bubble_fraction(8, 4)
             = 3/11; pipelined and sequential ms.
18h. production-mesh bytes — per-position bytes of the train state
             under megatron on make_production_mesh() and the multi-pod
             mesh for internlm2-1.8b, mamba2-1.3b and llama3-405b, equal
             to PROD_BYTES (tests/test_torch_specs.py computes the same).
             One JSON line {"dist": {...}} before the {"launch": ...}
             line; kernel 12's launches stand in the {"kernels": ...}
             line as "launches_dist", kernels 10 and 11's too.
18i. dry run — repro_torch.launch.dryrun, its record under
             dist["dryrun"]. (a) The grid on the host: DRYRUN_GRID,
             internlm2-1.8b and mamba2-1.3b at train_4k with probes and
             at decode_32k without, on the single production mesh (256
             positions; tests/test_torch_dryrun.py holds every arch at
             both shapes against XLA's on the CPU), in spawned processes
             with no card visible, each running
             repro_torch.launch.dryrun.main a cell, beside (b) (the
             phase "dry run (grid)" is the wait after it); each
             cell's status, memory and seconds, the probed cells' flops
             a position and roofline step; a cell in error fails. (b)
             The card check: the train phases' full-width cells
             (internlm2 1 x 4096, mamba2 1 x 2048, attn_impl="flash") and
             REMAT_LONG (mamba2 4 x 4096), under the config's remat
             ("block"), on a
             one-position mesh, the dry run on meta (with probes) beside the same
             step through specs.build_train on the card: argument bytes
             equal to the bytes the real state and batch request of the
             caching allocator, and torch.cuda.memory_allocated() within
             its rounding (512-byte blocks; a block past 1 MiB may keep
             an unsplit tail of at most 1 MiB), the temp peak beside
             max_memory_allocated() over one step, flops beside
             torch.profiler's with_flops count of a step, the H100
             roofline step beside the median step and MetricsLogger's
             roofline_step_s. No kernel launch counter moves during the
             meta runs; kernel 12 launches launches_a_step() times a
             step in the mamba2 runs (twice a layer: the forward and the
             recompute). Prints the phase's seconds.

The training slice (repro_torch.train: losses, AdamW, the train and eval
steps; kernels 11 and 12 run forward under autograd, their backward
differentiates the plain versions; under remat "block", the configs'
default, every block's forward runs again in the backward, so a train
step launches the kernel twice a layer; every launch check of a train
path is launches_a_step(cfg) x steps) runs after the launchers:

18. parity (train step) — internlm2, mamba2, recurrentgemma, mixtral and
             moonshot (aux-free, its router_bias made nonzero) reduced,
             head_dim 64 (256 for recurrentgemma), in bf16 and fp32, B x
             S = 2 x 256: the kernel path (attn_impl="flash", the SSD
             under auto) against the plain path (attn_impl="naive", the
             SSD under torch_ref) on the same weights and batch. The
             loss, ce and aux within LOSS_TOL; every gradient leaf by its
             relative norm error (fp32: within GRAD_TOL of the plain
             path; bf16: at most BF16_X times as far from an fp32 oracle
             as the plain path, plus BF16_FLOOR); a trainable leaf with
             no gradient on the kernel path (other than an aux-free
             router_bias, which enters only the top-k) fails; one
             apply_updates from identical gradients on two copies must
             give equal parameters; two microbatches against their
             halves' mean loss (and, without experts, one batch's global
             norm).
19. train internlm2 / train mamba2 — each model at its published widths
             and depth, bf16, random weights: five steps of
             make_train_step on one fixed 1 x 4096 (mamba2: 1 x 2048)
             batch at TRAIN_FULL_OPT, the losses finite and the last
             below the first; kernel 11 (12) must launch twice a layer
             a step (remat "block"). Prints each step, the median step of steps 2-5,
             tokens/s, MetricsLogger's mfu, roofline step and gap on the
             H100 row, peak device memory, an eval step's loss and one
             profiled step's busy share with the device time by kernel.
19a. train remat internlm2 / train remat mamba2 — on the phase's state
             and batch, REMAT_STEPS steps: each of REMAT_MODES ("none",
             "block", "dots") computes the loss and gradients from the
             same state, then one AdamW update; every loss, part and
             gradient leaf must be bit-identical across the modes, and
             the kernel must launch layers times a step under "none",
             twice that under the others. Prints each mode's peak over
             what was allocated before it, median forward + backward ms
             and launches a step.
19b. train remat mamba2 4x4096 — REMAT_LONG on the mamba2 phase's
             state under "block": the dry run's temp peak under "none"
             and "block" for the cell, "none" (not run) beyond the card's
             memory and "block" within it, then REMAT_LONG_STEPS steps
             of make_train_step; losses finite, kernel 12 launches 2 x 48
             x REMAT_LONG_STEPS, the peak beside the dry run's.
             One JSON line {"train": {...}} before the {"serve": ...}
             line holds the slice's records; the train phases' launches
             stand in the {"kernels": ...} line as "launches_train".

The world (repro_torch.dist.world, meshes of ranks), after the
query phases, once the parent has dropped its query tables:

W1. world (gloo, 8 ranks on one card) — WORLD_RANKS processes spawned
             by world.spawn over gloo, all on the one card, beside W2.
             Each builds the WORLD_ROWS-row (2^28) table of MAIN_SPEC's
             columns from SEED and shards it over a mesh of the 8 ranks
             (2^25 rows a shard): the shard's words copied to the card,
             the table moved to the host (the capacity-tier copy
             degraded execution re-reads) and its card copy dropped;
             then it loads the store from WORLD_STORE onto the host and
             builds the delta view (the frames from the chunks' bounds,
             its own chunks decoded and packed on the card). Meanwhile
             this process takes the unsharded engine's answers on the
             same table and saves its encoding to WORLD_STORE. Then,
             counters at 0: the eleven plans and the six grouped main
             shapes through QueryEngine on both views on every rank (the
             wide key's fallback grouping each shard on its rank, the
             groups merged over the ranks), execute_degraded /
             execute_grouped_degraded for DEGRADED_LOST on both views
             (all eight lost must raise; a flat query's lost shards
             re-executed on every rank, a grouped query's dealt out over
             the ranks), compressed_psum_pod on a (4, 2) rank mesh.
             Every answer equal on every rank and to the unsharded
             engine's; recovered bytes equal on every rank; the psum's
             bits equal to the virtual (4, 2) mesh's, within 2e-2 of 4x
             the leaf; every kernel the virtual sharded main, grouped
             main and degraded phases launched must launch here. Prints
             per rank launches, dispatch counts, ms a query, the shard's
             bytes, the card bytes a rank holds after set-up, peaks and
             seconds. Eight ranks share one card: no time here is a
             multi-card rate.
W2. world (nccl, one rank a card) — torch.cuda.device_count() ranks
             (1 here) over nccl, started with W1: the eleven plans on the
             plain view, equal to the unsharded engine's.
W3. world train (one position, checkpoints) — train state split over
             the ranks. After its query path (its tables dropped) each
             gloo rank runs mamba2-1.3b at its published widths, 12 of
             its 48 layers (eight ranks each gather the whole bf16
             parameters), bf16, remat "block", SyntheticLM batches of
             2 x 2048: run A on a (2, 4) rank mesh, 3 steps of
             build_train's rank step (each rank holds its blocks of
             params, m, v and master; "data" splits the rows, the fp32
             gradients all-reduce over it), checkpoints after steps 2
             and 3 (gathered on every rank, written by rank 0 in the
             background); run B on (8, 1) restores step 2 a block a rank
             and runs step 3 (two rows do not divide 8: every rank
             computes both), saved; GPipe on a (4, 2) rank mesh, a stage
             a "pod" rank, send/recv a tick. The nccl rank runs the same
             3 steps on a (1, 1) rank mesh. Then this process runs the
             same steps on one position, each batch as two one-row
             microbatches (the ranks' reduction order), and holds: a
             rank's requested bytes after placement equal to
             position_bytes, kernel 12's launches 2 x 12 a forward pass
             on every rank, the digests of the gathered leaves and the
             losses equal across a run's ranks, A's step-3 file and the
             nccl run equal to the one-position run bit for bit, B's
             step-3 file within UPDATE_X x lr, BF16_ULP and MOMENT_REL
             of A's, GPipe within PIPE_X of its fp32 oracle on every
             rank. Prints per rank bytes, launches, losses, step seconds
             with their gathers and all-reduces, save, write and
             restore seconds. One JSON line {"world": {...}} follows;
             the kernels line carries "launches_world" (summed over
             ranks and per rank) and, on kernel 12's record,
             "launches_world_train".

Every phase prints its seconds and the smoke's running total as it ends
("-- name: s").

After the tiered phases one JSON line {"tier": {...}} holds their
records. The third-to-last line is one JSON object {"serve": {...}} (the
mamba2, recurrentgemma, moonshot and mixtral records under their names,
the block parity under "block_parity"), the second-to-last {"kernels": [...]}
(twelve entries); the last is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# The smoke drives one card: expose only the first visible one, so
# torch.cuda.device_count() is 1 whatever the host holds.
os.environ["CUDA_VISIBLE_DEVICES"] = \
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

SRC = Path(__file__).resolve().parent / "src"
SEED = 0
MAIN_ROWS = 1 << 30
MAIN_SPEC = {"a": 8, "b": 8, "w": 16, "x": 4}
PARITY_WORDS = (1, 127, 32771, (1 << 22) + 17)
ORACLE_MAX_WORDS = 127
WARMUP, TIMED = 3, 20
KERNEL_REPS = 20        # back-to-back launches per timed sample of a kernel

# The H100 SXM (torch names it "H100 80GB HBM3") datasheet rates: memory
# 3.35 TB/s; CUDA cores 67 TFLOP/s float32 outside the tensor cores, an
# upper bound on its int32 rate.
CARD = "H100 80GB HBM3"
MEM_BPS = 3.35e12
CORE_OPS = 67e12


def release() -> None:
    """Free what the last phase dropped: collect reference cycles (an
    SLAScheduler's queue holds a bound method of it, and so the engine,
    its rings and its model, until the cycle collector runs), then return
    the cached blocks to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


_PHASE = {"name": None, "t0": 0.0, "start": time.perf_counter()}


def phase(name: str | None) -> None:
    """Print the seconds of the phase that ends here, then `== name`
    (None: end the last phase)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"-- {_PHASE['name']}: {now - _PHASE['t0']:.1f} s (smoke at "
              f"{now - _PHASE['start']:.1f} s)", flush=True)
    _PHASE.update(name=name, t0=now)
    if name is not None:
        print(f"== {name}", flush=True)


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def device_phase() -> dict:
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}; the kernels are built for sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {name}")
    if CARD not in name:
        fail(f"the bounds use the {CARD} datasheet; {name!r} needs its own "
             "MEM_BPS")
    return {"name": name, "smi": smi}


# --------------------------------------------------------------------------
# 3. parity
# --------------------------------------------------------------------------

def random_words(n: int, mask_u32: int, g: torch.Generator) -> torch.Tensor:
    """n int32 words of random bits restricted to mask_u32 (random_ draws
    [0, 2^31), and bit 31 is a delimiter bit at every width)."""
    from repro_torch.kernels.scan_filter.ref import as_int32
    w = torch.empty(n, dtype=torch.int32, device="cuda")
    w.random_(generator=g)
    return w & as_int32(mask_u32)


def np_fields(words: torch.Tensor, bits: int) -> np.ndarray:
    w = words.cpu().numpy().view(np.uint32).astype(np.int64)
    c = 32 // bits
    return np.stack([(w >> (i * bits)) & ((1 << bits) - 1)
                     for i in range(c)], axis=1)


def np_scan(words, constant, op, bits) -> np.ndarray:
    vals = np_fields(words, bits)
    hit = {"lt": np.less, "le": np.less_equal, "gt": np.greater,
           "ge": np.greater_equal, "eq": np.equal,
           "ne": np.not_equal}[op](vals, constant)
    pos = np.arange(32 // bits) * bits + bits - 1
    return (hit.astype(np.int64) << pos).sum(axis=1).astype(np.uint32) \
        .view(np.int32)


def np_aggregate(words, mask, bits) -> dict:
    vals = np_fields(words, bits).reshape(-1)
    sel = (np_fields(mask, bits) >> (bits - 1)).astype(bool).reshape(-1)
    v = vals[sel]
    vmax = (1 << (bits - 1)) - 1
    return {"sum": int(v.sum()), "count": int(sel.sum()),
            "min": int(v.min()) if v.size else vmax,
            "max": int(v.max()) if v.size else 0}


def agg_err(a: dict, b: dict) -> int:
    return max(abs(a[k] - b[k]) for k in ("sum", "count", "min", "max"))


def parity_phase() -> dict:
    phase("parity")
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.scan_aggregate import ops as fused_ops
    from repro_torch.kernels.scan_filter import ops as scan_ops
    from repro_torch.kernels.scan_filter.ref import OPS, as_int32, field_masks

    g = torch.Generator(device="cuda").manual_seed(SEED)
    err = {"scan_filter": 0, "aggregate": 0, "scan_aggregate": 0}
    cases = {"scan_filter": 0, "aggregate": 0, "scan_aggregate": 0}
    bad = []
    t0 = time.perf_counter()
    for bits in (2, 4, 8, 16):
        delim, _, value = field_masks(bits)
        vmax = int(value)
        payload = ~int(delim) & 0xFFFFFFFF
        consts = sorted({0, 1, vmax // 2, vmax - 1, vmax})
        for n in PARITY_WORDS:
            pred = random_words(n, payload, g)
            agg = random_words(n, payload, g)
            mask = random_words(n, int(delim), g)
            masks = {"random": mask,
                     "all": torch.full_like(mask, as_int32(delim)),
                     "none": torch.zeros_like(mask)}
            small = n <= ORACLE_MAX_WORDS
            for mname, m in masks.items():
                k = agg_ops.finalize(agg_ops.aggregate(agg, m, bits,
                                                       mode="cuda"))
                r = agg_ops.finalize(agg_ops.aggregate(agg, m, bits,
                                                       mode="torch_ref"))
                e = agg_err(k, r)
                if small:
                    e = max(e, agg_err(k, np_aggregate(agg, m, bits)))
                err["aggregate"] = max(err["aggregate"], e)
                cases["aggregate"] += 1
                if e:
                    bad.append(("aggregate", bits, n, mname, k, r))
            for op in OPS:
                for c in consts:
                    k = scan_ops.scan_filter(pred, c, op, bits, mode="cuda")
                    r = scan_ops.scan_filter(pred, c, op, bits,
                                             mode="torch_ref")
                    e = int((k.long() - r.long()).abs().max())
                    if small:
                        o = torch.from_numpy(np_scan(pred, c, op, bits))
                        e = max(e, int((k.cpu().long() - o.long()).abs()
                                       .max()))
                    err["scan_filter"] = max(err["scan_filter"], e)
                    cases["scan_filter"] += 1
                    if e:
                        bad.append(("scan_filter", bits, n, op, c))
                    k = agg_ops.finalize(fused_ops.scan_aggregate(
                        pred, agg, mask, c, op, bits, mode="cuda"))
                    r = agg_ops.finalize(fused_ops.scan_aggregate(
                        pred, agg, mask, c, op, bits, mode="torch_ref"))
                    e = agg_err(k, r)
                    if small:
                        sel = torch.from_numpy(np_scan(pred, c, op, bits)) \
                            .cuda() & mask
                        e = max(e, agg_err(k, np_aggregate(agg, sel, bits)))
                    err["scan_aggregate"] = max(err["scan_aggregate"], e)
                    cases["scan_aggregate"] += 1
                    if e:
                        bad.append(("scan_aggregate", bits, n, op, c, k, r))
    # a 16-bit column, every row selected, whose sum passes 2^31
    n = PARITY_WORDS[-1]
    delim, _, _ = field_masks(16)
    agg = random_words(n, ~int(delim) & 0xFFFFFFFF, g)
    allm = torch.full_like(agg, as_int32(delim))
    k = agg_ops.finalize(agg_ops.aggregate(agg, allm, 16, mode="cuda"))
    r = agg_ops.finalize(agg_ops.aggregate(agg, allm, 16, mode="torch_ref"))
    big = int(np_fields(agg, 16).sum())
    if k != r or k["sum"] != big or big <= 2**31 or k["count"] != 2 * n:
        bad.append(("aggregate_past_2^31", k, r, big))
    k = agg_ops.finalize(fused_ops.scan_aggregate(agg, agg, allm, 0, "ge",
                                                  16, mode="cuda"))
    if k["sum"] != big:
        bad.append(("scan_aggregate_past_2^31", k, big))
    cases["aggregate"] += 1
    cases["scan_aggregate"] += 1
    print(f"16-bit all-selected sum {k['sum']} (> 2^31: {big > 2**31})")
    torch.cuda.synchronize()
    print(f"parity cases {cases} max_abs_err {err} "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    if bad:
        for b in bad[:20]:
            print("MISMATCH", b, file=sys.stderr)
        fail(f"{len(bad)} kernel/plain mismatches")
    return err


BATCHED_SHAPES = ((1, 1), (7, 131), (4096, 2052))
# run counts at the RLE routes' edges (kernel.warp_limit: 128 runs at
# 1-9 chunks, 1536 at 4096) and a lane's stride (31-33)
RLE_CHUNKS = (1, 7, 8, 9, 4096)
RLE_RUNS = (1, 3, 31, 32, 33, 127, 128, 129, 1001, 1535, 1536, 1537, 4096)
# (n_chunks, n_runs) of the unaligned case: planes one int32 past a 16-byte
# boundary, run counts that would take 16-byte loads if aligned
RLE_UNALIGNED = ((1, 128), (1, 4096), (9, 32), (4096, 4), (4096, 1536),
                 (7, 4096))


def ragged_valid(n_chunks: int, n_words: int, bits: int,
                 g: torch.Generator) -> torch.Tensor:
    """(n_chunks, n_words) validity with a random row count per chunk;
    chunk 0 holds no row (an empty chunk)."""
    from repro_torch.kernels.scan_filter.ref import pack_bits
    cpw = 32 // bits
    rows = torch.randint(0, n_words * cpw + 1, (n_chunks,), device="cuda",
                         generator=g)
    rows[0] = 0
    sel = torch.arange(n_words * cpw, device="cuda")[None, :] < rows[:, None]
    return pack_bits(sel.reshape(-1), bits).reshape(n_chunks, n_words)


def batched_parity_phase() -> dict:
    """Kernels 4-7 against their plain versions, bit for bit."""
    phase("parity (batched and RLE kernels)")
    from repro_torch.kernels.aggregate import ops as agg_ops
    from repro_torch.kernels.scan_aggregate import ops as fused_ops
    from repro_torch.kernels.scan_compressed import kernel as rle_k
    from repro_torch.kernels.scan_compressed import ops as rle_ops
    from repro_torch.kernels.scan_filter.ops import canonical_pred
    from repro_torch.kernels.scan_filter.ref import OPS, field_masks

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    names = ("aggregate_batched", "scan_aggregate_batched",
             "rle_scan_aggregate", "rle_scan_aggregate_batched")
    err = dict.fromkeys(names, 0)
    cases = dict.fromkeys(names, 0)
    routes = {name: dict.fromkeys(rle_k.ROUTES, 0) for name in names[2:]}
    bad = []

    def check(name, k, r, *what, shape=None):
        e = int((k.long() - r.long()).abs().max()) if k.numel() else 0
        if k.shape != r.shape:
            e = max(e, 1)
        err[name] = max(err[name], e)
        cases[name] += 1
        if shape is not None:          # an RLE case: the route it took
            routes[name][rle_k.route(*shape)] += 1
        if e:
            bad.append((name, *what))

    t0 = time.perf_counter()
    for bits in (2, 4, 8, 16):
        delim, _, value = field_masks(bits)
        vmax = int(value)
        payload = ~int(delim) & 0xFFFFFFFF
        shapes = BATCHED_SHAPES + ((3, 65536 * bits // 32),)  # full chunks
        for n_chunks, n_words in shapes:
            pred = random_words(n_chunks * n_words, payload, g).reshape(
                n_chunks, n_words)
            agg = random_words(n_chunks * n_words, payload, g).reshape(
                n_chunks, n_words)
            valid = ragged_valid(n_chunks, n_words, bits, g)
            mask = random_words(n_chunks * n_words, int(delim), g).reshape(
                n_chunks, n_words) & valid
            check("aggregate_batched",
                  agg_ops.aggregate_batched(agg, mask, bits, mode="cuda"),
                  agg_ops.aggregate_batched(agg, mask, bits,
                                            mode="torch_ref"),
                  bits, n_chunks, n_words)
            consts = torch.randint(-1, vmax + 2, (n_chunks,),
                                   generator=torch.Generator().manual_seed(
                                       n_chunks * bits)).tolist()
            for op in OPS:
                triples = [canonical_pred(op, c, bits) for c in consts]
                check("scan_aggregate_batched",
                      fused_ops.scan_aggregate_batched(
                          pred, agg, valid, triples, bits, mode="cuda"),
                      fused_ops.scan_aggregate_batched(
                          pred, agg, valid, triples, bits,
                          mode="torch_ref"), bits, n_chunks, n_words, op)
    for n_chunks in RLE_CHUNKS:
        for n_runs in RLE_RUNS:
            for bits in (4, 16):
                vmax = (1 << (bits - 1)) - 1
                values = torch.randint(0, vmax + 1, (n_chunks, n_runs),
                                       device="cuda", dtype=torch.int32,
                                       generator=g)
                lengths = torch.randint(0, 17, (n_chunks, n_runs),
                                        device="cuda", dtype=torch.int32,
                                        generator=g)
                # ragged run counts: chunk k keeps its first runs only
                planes = [(values[k, :n_runs - k % 3 * (n_runs // 3)],
                           lengths[k, :n_runs - k % 3 * (n_runs // 3)])
                          for k in range(n_chunks)]
                for op in OPS:
                    c = vmax // 2
                    check("rle_scan_aggregate_batched",
                          rle_ops.rle_scan_aggregate_batched(
                              planes, c, op, bits, mode="cuda"),
                          rle_ops.rle_scan_aggregate_batched(
                              planes, c, op, bits, mode="torch_ref"),
                          n_chunks, n_runs, bits, op,
                          shape=(n_chunks, n_runs))
                    if n_chunks == 1:
                        v, n = planes[0]
                        check("rle_scan_aggregate",
                              rle_ops.rle_scan_aggregate(
                                  v, n, c, op, bits, mode="cuda").row,
                              rle_ops.rle_scan_aggregate(
                                  v, n, c, op, bits, mode="torch_ref").row,
                              n_runs, bits, op, shape=(1, n_runs))
    # planes one int32 past a 16-byte boundary: no 16-byte loads, the
    # scalar tail reads every run
    for n_chunks, n_runs in RLE_UNALIGNED:
        v, n = (torch.randint(0, hi, (n_chunks * n_runs + 1,),
                              device="cuda", dtype=torch.int32,
                              generator=g)[1:].view(n_chunks, n_runs)
                for hi in (128, 17))
        if v.data_ptr() % 16 != 4 or n.data_ptr() % 16 != 4:
            bad.append(("unaligned view is aligned", n_chunks, n_runs))
        for op in OPS:
            check("rle_scan_aggregate_batched",
                  rle_ops.rle_scan_aggregate_stacked(v, n, 60, op, 8,
                                                     mode="cuda"),
                  rle_ops.rle_scan_aggregate_stacked(v, n, 60, op, 8,
                                                     mode="torch_ref"),
                  "unaligned", n_chunks, n_runs, op,
                  shape=(n_chunks, n_runs))
            if n_chunks == 1:
                check("rle_scan_aggregate",
                      rle_ops.rle_scan_aggregate(v[0], n[0], 60, op, 8,
                                                 mode="cuda").row,
                      rle_ops.rle_scan_aggregate(v[0], n[0], 60, op, 8,
                                                 mode="torch_ref").row,
                      "unaligned", n_runs, op, shape=(1, n_runs))
    # a full chunk of the 16-bit payload max as one run: the sum grazes 2^31
    v = torch.full((2, 1), 32767, dtype=torch.int32, device="cuda")
    n = torch.full((2, 1), 65536, dtype=torch.int32, device="cuda")
    row = rle_ops.rle_scan_aggregate_batched([(v[0], n[0]), (v[1], n[1])],
                                             0, "ge", 16, mode="cuda")
    one = rle_ops.rle_scan_aggregate(v[0], n[0], 0, "ge", 16, mode="cuda")
    got = [(int(r[1]) << 16) + int(r[0]) for r in (*row.tolist(),
                                                   one.row.tolist())]
    if got != [32767 * 65536] * 3:
        bad.append(("rle sum at the chunk bound", got))
    torch.cuda.synchronize()
    print(f"batched parity cases {cases} max_abs_err {err} "
          f"in {time.perf_counter() - t0:.3f} s", flush=True)
    print(f"RLE cases by route (kernel.route): {routes}", flush=True)
    for name, by_route in routes.items():
        if not all(by_route.values()):
            bad.append((name, "a route took no case", by_route))
    if bad:
        for b in bad[:20]:
            print("MISMATCH", b, file=sys.stderr)
        fail(f"{len(bad)} batched kernel/plain mismatches")
    return err


# --------------------------------------------------------------------------
# 4. main path
# --------------------------------------------------------------------------

def plan_shapes():
    """The eleven plan shapes of tests/test_query_engine.py::PLAN_SHAPES."""
    from repro_torch.query import And, Or, Pred
    return [
        ("single_pred_fused", Pred("a", "lt", 50), ("b",)),
        ("fused_ge", Pred("a", "ge", 100), ("b",)),
        ("fused_gt", Pred("a", "gt", 100), ("b",)),
        ("fused_eq", Pred("a", "eq", 64), ("b",)),
        ("fused_ne", Pred("a", "ne", 64), ("b",)),
        ("and_same_width", Pred("a", "lt", 50) & Pred("b", "ge", 100),
         ("b",)),
        ("and_mixed_width", Pred("a", "lt", 50) & Pred("w", "ge", 9000),
         ("w",)),
        ("or_mixed_width", Pred("x", "eq", 3) | Pred("w", "lt", 500),
         ("a",)),
        ("nested_and_or",
         And.of(Or.of(Pred("a", "le", 20), Pred("b", "gt", 120)),
                Pred("x", "ne", 0)), ("b",)),
        ("multi_agg_mixed", Pred("a", "ge", 64), ("b", "w", "x")),
        ("empty_selection", Pred("x", "gt", 7), ("a",)),
    ]


def build_table(rows: int = MAIN_ROWS, valid: bool = True):
    """2^30 rows (or `rows`) built on the card (host numpy would need GBs
    a column): random payload bits from a seeded generator, delimiters
    cleared; with `valid`, the validity masks built up front."""
    from repro_torch.db import BitPackedColumn, Table
    from repro_torch.kernels.scan_filter.ref import field_masks
    g = torch.Generator(device="cuda").manual_seed(SEED)
    t = Table("main")
    for name, bits in MAIN_SPEC.items():
        delim, _, _ = field_masks(bits)
        words = random_words(rows * bits // 32,
                             ~int(delim) & 0xFFFFFFFF, g)
        t.add(BitPackedColumn(name, bits, rows, words))
    for col in t.columns.values() if valid else ():
        col.valid_words       # build the cached validity masks up front
    torch.cuda.synchronize()
    return t


def kernel_modules():
    from repro_torch.kernels.aggregate import kernel as agg_k
    from repro_torch.kernels.scan_aggregate import kernel as fused_k
    from repro_torch.kernels.scan_filter import kernel as scan_k
    return {"scan_filter": scan_k, "aggregate": agg_k,
            "scan_aggregate": fused_k}


def main_phase(table) -> dict:
    phase("main")
    from repro_torch.query import Query, QueryEngine
    gib = table.nbytes / 2**30
    print(f"table {table.num_rows} rows, {gib:.3f} GiB packed "
          f"+ {gib:.3f} GiB validity masks on {table.device}")
    shapes = plan_shapes()
    mods = kernel_modules()
    eng = QueryEngine(table, mode="auto")
    for m in mods.values():
        m.LAUNCHES = 0
    got = []
    for name, plan, aggs in shapes:
        eng.submit(Query(plan, aggregates=aggs))
        got.append(eng.run()[0])
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    print(f"kernel launches on the main path: {launches}; "
          f"dispatch counts {eng.metrics.launch_counts()}")
    ref = QueryEngine(table, mode="torch_ref")
    bad = []
    for (name, plan, aggs), res in zip(shapes, got):
        ref.submit(Query(plan, aggregates=aggs))
        want = ref.run()[0]
        same = res.aggregates == want.aggregates
        print(f"{name:18s} auto {res.latency_s * 1e3:9.3f} ms "
              f"{res.bytes_scanned / res.latency_s / 1e9:8.1f} GB/s | "
              f"torch_ref {want.latency_s * 1e3:9.3f} ms | "
              f"count {res.count} equal={same}")
        ok = same and all(
            0 <= d["count"] <= table.num_rows and d["min"] >= 0
            and d["max"] <= (1 << (MAIN_SPEC[c] - 1)) - 1
            for c, d in res.aggregates.items())
        if not ok:
            bad.append((name, res.aggregates, want.aggregates))
    if got[-1].count != 0:
        bad.append(("empty_selection count", got[-1].count))
    print("summary auto", json.dumps(eng.summary()))
    print("summary torch_ref", json.dumps(ref.summary()))
    if bad:
        for b in bad:
            print("MISMATCH", b, file=sys.stderr)
        fail(f"{len(bad)} main-path results differ from torch_ref")
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        fail(f"kernels never launched on the main path: {zero}")
    return launches


# device kernels of the two-route RLE wrappers, by the names nvcc gave them
RLE_SCAN_KERNELS = ("rle_scan_aggregate_kernel",)
RLE_GROUP_KERNELS = ("rle_group_accumulate_kernel",
                     "rle_group_accumulate_warp_kernel")


# device kernels of the port, by the names nvcc gave them
PORT_KERNELS = ("scan_kernel", "aggregate_kernel", "aggregate_batched_kernel",
                "rle_scan_aggregate_kernel", "group_sum_count_kernel",
                "group_finalize_kernel", *RLE_GROUP_KERNELS)


def profile_phase(table, shapes, label: str) -> None:
    """Where a warm query's time goes: each plan shape again (the caching
    allocator, and for a store table the bind cache, now hold their
    blocks), then once more under torch.profiler for the device's busy
    share and the device time by kernel name."""
    phase(f"profile {label}")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.query import Query, QueryEngine
    # (name, plan, aggregates) plan shapes, or (name, query) pairs
    queries = [(sh[0], Query(sh[1], aggregates=sh[2]) if len(sh) == 3
                else sh[1]) for sh in shapes]
    eng = QueryEngine(table, mode="auto")
    for name, q in queries:
        eng.submit(q)
        res = eng.run()[0]
        print(f"warm {name:24s} {res.latency_s * 1e3:9.3f} ms "
              f"{res.bytes_scanned / res.latency_s / 1e9:8.1f} GB/s")
    print(f"summary warm {label}", json.dumps(eng.summary()))
    eng = QueryEngine(table, mode="auto")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, q in queries:
            eng.submit(q)
            eng.run()
    wall_us = eng.seconds_total * 1e6
    # device-side rows only (kernels, memcpy, memset: no host time of their
    # own); the aten:: rows carry the same device time a second time
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    ours_us = sum(r[0] for r in rows
                  if any(k in r[2] for k in PORT_KERNELS))
    print(f"profiled {len(shapes)} {label} queries: wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"busy share {busy_us / wall_us:.4f}; the port's CUDA kernels "
          f"{ours_us / 1e3:.3f} ms, other device work "
          f"{(busy_us - ours_us) / 1e3:.3f} ms")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  device {us / 1e3:10.3f} ms  x{count:5d}  {key[:100]}")


# --------------------------------------------------------------------------
# 5. times
# --------------------------------------------------------------------------

def time_ms(fn, reps: int = 1) -> float:
    """Median over TIMED samples (CUDA events, after WARMUP calls) of the
    time per call of `reps` calls back to back. With reps > 1 the host's
    launch work overlaps the previous launch, so a short kernel is timed
    without its wrapper's host time in front of it; with reps = 1 a
    sample is one call as a query makes it, host time included."""
    for _ in range(WARMUP):
        fn()
    ts = []
    for _ in range(TIMED):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def times_phase(table, dev: dict, launches: dict, parity_err: dict) -> list:
    phase("times")
    mods = kernel_modules()
    from repro_torch.kernels.aggregate import ref as agg_ref
    from repro_torch.kernels.scan_aggregate import ref as fused_ref
    from repro_torch.kernels.scan_filter import ref as scan_ref

    a, b = table.columns["a"], table.columns["b"]
    n, bits, cpw = a.words.shape[0], a.code_bits, 32 // a.code_bits
    # the main path's shapes: a lt 50 scanned (and_same_width), b
    # aggregated under that validity-masked mask, a lt 50 fused over b
    mask = mods["scan_filter"].scan_packed(a.words, 50, op="ge",
                                           code_bits=bits, invert=True) \
        & a.valid_words

    runs = {
        "scan_filter": (
            lambda: mods["scan_filter"].scan_packed(
                a.words, 50, op="ge", code_bits=bits, invert=True),
            lambda: scan_ref.scan_ref(a.words, 50, "lt", bits),
            8 * n, 4 * n),
        "aggregate": (
            lambda: mods["aggregate"].aggregate_packed(
                b.words, mask, code_bits=bits)[0],
            lambda: agg_ref.aggregate_ref(b.words, mask, bits).row,
            8 * n + 20, 6 * n * cpw + 2 * n),
        "scan_aggregate": (
            lambda: mods["scan_aggregate"].scan_aggregate_packed(
                a.words, b.words, a.valid_words, constant=50, op="ge",
                invert=True, code_bits=bits)[0],
            lambda: fused_ref.scan_aggregate_ref(
                a.words, b.words, a.valid_words, 50, "lt", bits).row,
            12 * n + 20, 6 * n * cpw + 7 * n),
    }
    replaces = {"scan_filter": "src/repro/kernels/scan_filter/kernel.py:68",
                "aggregate": "src/repro/kernels/aggregate/kernel.py:182",
                "scan_aggregate":
                    "src/repro/kernels/scan_aggregate/kernel.py:233"}
    out = []
    for name, (kern, plain, nbytes, ops) in runs.items():
        rec = time_kernel(name, kern, plain, nbytes, ops, dev)
        rec.update({"source": f"src/repro_torch/csrc/{name}.cu",
                    "replaces": replaces[name], "launches": launches[name],
                    "max_abs_err": max(rec["max_abs_err"],
                                       parity_err[name]),
                    "n_words": n, "code_bits": bits})
        out.append(rec)
    return out


def time_kernel(name, kern, plain, nbytes: int, ops: int, dev: dict) -> dict:
    """Check the kernel against its plain version once, then time both
    (time_ms) and compute the bound; fails on a difference. `ms` is one
    call with its wrapper's host work; `ms_back_to_back` is the time a
    launch over KERNEL_REPS launches back to back."""
    e = int((kern().long() - plain().long()).abs().max())
    ms = time_ms(kern)
    b2b_ms = time_ms(kern, KERNEL_REPS)
    plain_ms = time_ms(plain)
    bytes_ms = nbytes / MEM_BPS * 1e3
    ops_ms = ops / CORE_OPS * 1e3
    rec = {"name": name, "route": "cuda", "launches": 0,
           "max_abs_err": e, "ms": ms, "ms_back_to_back": b2b_ms,
           "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": None, "library_ms_back_to_back": None,
           "bytes": nbytes, "ops": ops}
    print(f"{name:26s} kernel {ms:.4f} ms one call ({b2b_ms:.4f} ms back "
          f"to back)  plain {plain_ms:.4f} ms  "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})  "
          f"{nbytes / ms / 1e6:.1f} GB/s  [{dev['smi']}]", flush=True)
    if e:
        fail(f"{name} differs from its plain version at the path's shape "
             f"(max abs err {e})")
    return rec


# --------------------------------------------------------------------------
# 7. the compressed store
# --------------------------------------------------------------------------

STORE_ROWS = 1 << 28
STORE_CHUNK_ROWS = 65536          # MAX_CHUNK_ROWS: 4096 chunks a column


def store_plan_shapes():
    """The sixteen plan shapes of tests/test_store.py::PLAN_SHAPES."""
    from repro_torch.query import And, Or, Pred
    return [
        ("rle_fused_self_agg", Pred("r", "lt", 4), ("r",)),
        ("rle_fused_eq", Pred("r", "eq", 3), ("r",)),
        ("rle_fused_ne", Pred("r", "ne", 3), ("r",)),
        ("rle_pred_other_agg", Pred("r", "ge", 6), ("f",)),
        ("for_fused_same_width", Pred("f", "ge", 44), ("f",)),
        ("for_cross_column", Pred("f", "lt", 44), ("w",)),
        ("for16_pred", Pred("w", "ge", 9050), ("u",)),
        ("plain_pred_for_agg", Pred("u", "lt", 64), ("w",)),
        ("and_mixed_encodings", Pred("f", "ge", 42) & Pred("w", "lt", 9080),
         ("w", "x")),
        ("or_mixed_widths", Pred("x", "eq", 3) | Pred("w", "lt", 9010),
         ("u",)),
        ("nested_and_or",
         And.of(Or.of(Pred("r", "le", 2), Pred("u", "gt", 120)),
                Pred("x", "ne", 0)), ("f",)),
        ("multi_agg_all_encodings", Pred("f", "ge", 43),
         ("r", "f", "w", "u", "x")),
        ("empty_selection_rle", Pred("r", "gt", 7), ("r",)),
        ("empty_selection_for", Pred("f", "lt", 40), ("w",)),
        ("all_match_for", Pred("w", "ge", 0), ("w",)),
        ("below_frame_constant", Pred("w", "lt", 5), ("w",)),
    ]


def build_store_table():
    """tests/test_store.py's column mix at 2^28 rows, built on the card
    from a seeded generator: r sorted over 8 values (RLE), f 40 + [0, 8)
    and w 9000 + [0, 100) (FOR), u [0, 128) (plain), x [0, 8) at 4 bits."""
    from repro_torch.db import BitPackedColumn, Table
    from repro_torch.store.exec import pack_codes
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n = STORE_ROWS

    def rnd(lo, hi):
        return torch.randint(lo, hi, (n,), device="cuda", dtype=torch.int32,
                             generator=g)

    spec = {"r": (lambda: rnd(0, 8).sort().values, 8),
            "f": (lambda: rnd(40, 48), 8),
            "w": (lambda: rnd(9000, 9100), 16),
            "u": (lambda: rnd(0, 128), 8),
            "x": (lambda: rnd(0, 8), 4)}
    t = Table("store")
    for name, (make, bits) in spec.items():
        t.add(BitPackedColumn(name, bits, n, pack_codes(make(), bits)))
    for col in t.columns.values():
        col.valid_words       # build the cached validity masks up front
    torch.cuda.synchronize()
    return t


def store_kernel_modules():
    """Kernel name -> (wrapper module, name of its launch counter)."""
    from repro_torch.kernels.aggregate import kernel as agg_k
    from repro_torch.kernels.scan_aggregate import kernel as fused_k
    from repro_torch.kernels.scan_compressed import kernel as rle_k
    return {"aggregate_batched": (agg_k, "BATCHED_LAUNCHES"),
            "scan_aggregate_batched": (fused_k, "BATCHED_LAUNCHES"),
            "rle_scan_aggregate": (rle_k, "LAUNCHES"),
            "rle_scan_aggregate_batched": (rle_k, "BATCHED_LAUNCHES")}


def store_phase(table, encoded, encode_s: float) -> dict:
    phase("store")
    from repro_torch.query import Pred, Query, QueryEngine
    from repro_torch.store import execute_encoded
    st = encoded.stats()
    print(f"store {encoded.num_rows} rows, chunk_rows {encoded.chunk_rows}, "
          f"{encoded.n_chunks} chunks a column; physical "
          f"{st['physical_bytes'] / 2**30:.4f} GiB, logical "
          f"{st['logical_bytes'] / 2**30:.4f} GiB, ratio {st['ratio']}; "
          f"encodings {json.dumps(st['encodings'])}")
    print(f"encode {encode_s:.3f} s (all five columns, on the card, "
          f"checksums included)", flush=True)
    shapes = store_plan_shapes()
    mods = store_kernel_modules()
    for m, attr in mods.values():
        setattr(m, attr, 0)
    eng = QueryEngine(encoded, mode="auto")
    cold, warm = [], []
    for runs in (cold, warm):
        for name, plan, aggs in shapes:
            eng.submit(Query(plan, aggregates=aggs))
            runs.append(eng.run()[0])
    t0 = time.perf_counter()
    loop = execute_encoded(Pred("r", "lt", 4), ("r",), encoded, mode="auto",
                           batched=False)
    loop_s = time.perf_counter() - t0
    launches = {k: getattr(m, attr) for k, (m, attr) in mods.items()}
    print(f"kernel launches on the store path: {launches}; dispatch counts "
          f"{eng.metrics.launch_counts()}")
    print(f"batched=False pass (rle_fused_self_agg, one launch and one host "
          f"copy per chunk): {loop_s * 1e3:.3f} ms")
    plain = QueryEngine(table, mode="auto")
    ref = QueryEngine(encoded, mode="torch_ref")
    bad = []
    if loop != warm[0].aggregates:
        bad.append(("batched=False", loop, warm[0].aggregates))
    for (name, plan, aggs), c, w in zip(shapes, cold, warm):
        plain.submit(Query(plan, aggregates=aggs))
        p = plain.run()[0]
        ref.submit(Query(plan, aggregates=aggs))
        r = ref.run()[0]
        same = c.aggregates == w.aggregates == p.aggregates == r.aggregates
        print(f"{name:24s} cold {c.latency_s * 1e3:9.3f} ms  warm "
              f"{w.latency_s * 1e3:8.3f} ms  bind "
              f"{(c.latency_s - w.latency_s) * 1e3:9.3f} ms  phys "
              f"{w.bytes_scanned / w.latency_s / 1e9:7.1f} GB/s  eff "
              f"{w.logical_bytes / w.latency_s / 1e9:7.1f} GB/s | plain "
              f"{p.latency_s * 1e3:8.3f} ms | torch_ref "
              f"{r.latency_s * 1e3:9.3f} ms | count {w.count} equal={same}")
        ok = same and all(
            0 <= d["count"] <= STORE_ROWS and 0 <= d["min"]
            and d["max"] <= (1 << (encoded.columns[col].code_bits - 1)) - 1
            for col, d in w.aggregates.items())
        if not ok:
            bad.append((name, c.aggregates, w.aggregates, p.aggregates,
                        r.aggregates))
    by_name = {name: w for (name, _, _), w in zip(shapes, warm)}
    for name in ("empty_selection_rle", "empty_selection_for"):
        if by_name[name].count != 0:
            bad.append((name, "count", by_name[name].count))
    if by_name["all_match_for"].count != STORE_ROWS:
        bad.append(("all_match_for", "count", by_name["all_match_for"].count))
    s = eng.summary()
    print("summary store auto (cold + warm)", json.dumps(s))
    if not s["effective_gbps"] > s["measured_gbps"] > 0:
        bad.append(("effective_gbps <= measured_gbps", s))
    if bad:
        for b in bad:
            print("MISMATCH", b, file=sys.stderr)
        fail(f"{len(bad)} store results differ across the three engines")
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        fail(f"kernels never launched on the store path: {zero}")
    return launches


def store_times_phase(encoded, dev: dict, launches: dict,
                      parity_err: dict) -> list:
    """Kernels 4-7 at the store path's shapes, the batched RLE kernel at
    its largest legal plane (4096 chunks x 4096 runs) and the single-chunk
    one at its run count; the RLE kernels split into device and host time
    (route_split), and their other route timed at each shape."""
    phase("store times")
    from repro_torch.kernels.aggregate import ref as agg_ref
    from repro_torch.kernels.scan_aggregate import ref as fused_ref
    from repro_torch.kernels.scan_compressed import ops as rle_ops
    from repro_torch.kernels.scan_compressed import ref as rle_ref
    from repro_torch.kernels.scan_filter.ops import (canonical_pred,
                                                     mask_batched,
                                                     packed_triples)
    from repro_torch.store.exec import _bind_group_cached
    mods = store_kernel_modules()
    agg_k = mods["aggregate_batched"][0]
    fused_k = mods["scan_aggregate_batched"][0]
    rle_k = mods["rle_scan_aggregate"][0]
    n = encoded.n_chunks
    cids = list(range(n))
    # for_cross_column (f lt 44 over w): f repacked to W=8 beside w, three
    # distinct planes (for_fused_same_width reads one plane twice)
    f = _bind_group_cached(encoded.columns["f"], cids, 8)
    consts, flags = (torch.from_numpy(x).cuda() for x in packed_triples(
        [canonical_pred("lt", 44 - int(b), 8)
         for b in encoded.columns["f"].chunk_arrays().base], 8))
    # and_mixed_encodings: w aggregated at W=8 under w lt 9080
    w = _bind_group_cached(encoded.columns["w"], cids, 8)
    wmask = mask_batched(w.words, [
        canonical_pred("lt", 9080 - int(b), 8)
        for b in encoded.columns["w"].chunk_arrays().base], 8) & w.valid
    # rle_fused_self_agg (r lt 4): r's run planes, and its first chunk
    r = encoded.columns["r"]
    rv, rl = rle_ops.stack_runs([(ch.values, ch.lengths)
                                 for ch in r.chunks])
    v0, l0 = r.chunks[0].values, r.chunks[0].lengths
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bv = torch.randint(0, 128, (n, 4096), device="cuda", dtype=torch.int32,
                       generator=g)
    bl = torch.randint(0, 17, (n, 4096), device="cuda", dtype=torch.int32,
                       generator=g)
    ww = w.words.shape[1]
    # name: (kernel, plain, bytes, ops, shape, what, replaced kernel, file)
    runs = {
        "aggregate_batched": (
            lambda: agg_k.aggregate_batched_packed(w.words, wmask,
                                                   code_bits=8),
            lambda: agg_ref.aggregate_batched_ref(w.words, wmask, 8),
            8 * n * ww + 20 * n, 6 * n * ww * 4 + 2 * n * ww, (n, ww),
            "w at W=8 (and_mixed_encodings)",
            "src/repro/kernels/aggregate/kernel.py:152", "aggregate.cu"),
        "scan_aggregate_batched": (
            lambda: fused_k.scan_aggregate_batched_packed(
                consts, flags, f.words, w.words, f.valid, code_bits=8),
            lambda: fused_ref.scan_aggregate_batched_ref(
                consts, flags, f.words, w.words, f.valid, 8),
            12 * n * ww + 8 * n + 20 * n, 6 * n * ww * 4 + 7 * n * ww,
            (n, ww), "f over w at W=8 (for_cross_column)",
            "src/repro/kernels/scan_aggregate/kernel.py:192",
            "scan_aggregate.cu"),
        "rle_scan_aggregate": (
            lambda way=None: rle_k.rle_scan_aggregate_packed(
                v0, l0, constant=4, op="lt", code_bits=8, way=way),
            lambda: rle_ref.rle_scan_aggregate_ref(v0, l0, 4, "lt", 8).row,
            8 * v0.numel() + 20, 7 * v0.numel(), (1, v0.numel()),
            "r chunk 0 (rle_fused_self_agg, batched=False)",
            "src/repro/kernels/scan_compressed/kernel.py:165",
            "scan_compressed.cu"),
        "rle_scan_aggregate_batched": (
            lambda way=None: rle_k.rle_scan_aggregate_batched_packed(
                rv, rl, constant=4, op="lt", code_bits=8, way=way),
            lambda: rle_ref.rle_scan_aggregate_batched_ref(rv, rl, 4, "lt",
                                                           8),
            8 * rv.numel() + 20 * n, 7 * rv.numel(), tuple(rv.shape),
            "r (rle_fused_self_agg)",
            "src/repro/kernels/scan_compressed/kernel.py:131",
            "scan_compressed.cu"),
    }
    out = []
    for name, (kern, plain, nbytes, ops, shape, what, replaces,
               src) in runs.items():
        print(f"  {name} at {list(shape)}: {what}")
        rec = time_kernel(name, kern, plain, nbytes, ops, dev)
        rec.update({"source": f"src/repro_torch/csrc/{src}",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": max(rec["max_abs_err"],
                                       parity_err[name]),
                    "shape": list(shape)})
        if src == "scan_compressed.cu":
            rec.update(route_split(kern, shape, rle_k, RLE_SCAN_KERNELS,
                                   dev))
        out.append(rec)
    keys = ("ms", "ms_back_to_back", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")
    # kernel 6 at the run count of the largest legal plane: row 0 of it
    v1, l1 = bv[0], bl[0]
    print(f"  rle_scan_aggregate at [1, {v1.numel()}]: row 0 of the largest "
          f"legal plane")

    def single(way=None):
        return rle_k.rle_scan_aggregate_packed(v1, l1, constant=60, op="lt",
                                               code_bits=8, way=way)
    one = time_kernel(
        "rle_scan_aggregate", single,
        lambda: rle_ref.rle_scan_aggregate_ref(v1, l1, 60, "lt", 8).row,
        8 * v1.numel() + 20, 7 * v1.numel(), dev)
    out[-2]["largest_run_count"] = {
        "shape": [1, v1.numel()], **{k: one[k] for k in keys},
        **route_split(single, (1, v1.numel()), rle_k, RLE_SCAN_KERNELS,
                      dev)}
    print(f"  rle_scan_aggregate_batched at [{n}, 4096]: the largest legal "
          f"plane")

    def batched(way=None):
        return rle_k.rle_scan_aggregate_batched_packed(
            bv, bl, constant=60, op="lt", code_bits=8, way=way)
    big = time_kernel(
        "rle_scan_aggregate_batched", batched,
        lambda: rle_ref.rle_scan_aggregate_batched_ref(bv, bl, 60, "lt", 8),
        8 * bv.numel() + 20 * n, 7 * bv.numel(), dev)
    out[-1]["largest_plane"] = {k: big[k] for k in keys}
    out[-1]["largest_plane"].update(route_split(
        batched, tuple(bv.shape), rle_k, RLE_SCAN_KERNELS, dev))
    return out


HOST_CALLS = 1000     # wrapper calls a host-time sample enqueues


def host_us(fn) -> float:
    """The host's enqueue cost of `fn` in µs a call: a perf_counter
    interval over HOST_CALLS calls made back to back with no synchronise
    (inputs drawn once, after warm-up), over HOST_CALLS; one
    torch.cuda.synchronize() ends the run, outside the interval. Where the
    card takes longer a launch than the host does, the launch queue fills
    and the reading approaches the card's time instead."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / HOST_CALLS * 1e6


def route_split(call, shape, kernel, names, dev: dict) -> dict:
    """A two-route kernel (6-7 or 9) at `shape`, the arguments of its
    wrapper module `kernel`'s route() ((n_chunks, n_runs), and G for
    kernel 9), `call(way)` one wrapper call on route `way` (None:
    kernel.route's), `names` its device kernels: the route the path
    takes, its device ms a launch (launch_split) and host µs a call
    (host_us); then the other route of kernel.ROUTES at the same shape,
    its output equal to the path's, back to back and device ms a
    launch."""
    way = kernel.route(*shape)
    other = next(r for r in kernel.ROUTES if r != way)
    split = launch_split(call, names, dev)
    us = host_us(call)
    print(f"    route {way}: host {us:.3f} us a call ({HOST_CALLS} calls "
          f"enqueued, no synchronise) [{dev['smi']}]", flush=True)
    if not torch.equal(call(other), call()):
        fail(f"routes {way} and {other} differ at {list(shape)}")
    alt = {"route": other,
           "ms_back_to_back": time_ms(lambda: call(other), KERNEL_REPS),
           "split_ms": launch_split(lambda: call(other), names, dev)}
    print(f"    the {other} route at the same shape: "
          f"{alt['ms_back_to_back']:.4f} ms back to back [{dev['smi']}]",
          flush=True)
    return {"path_route": way, "split_ms": split, "host_us_per_call": us,
            "other_route": alt}


# --------------------------------------------------------------------------
# the grouped slice: GroupBy / HashJoin on kernels 8 and 9
# --------------------------------------------------------------------------

GROUP_SHAPES = ((1, 1), (7, 131), (4096, 512))   # (n_chunks, rows of 128)
GROUP_SIZES = (1, 8, 100, 1024)
GROUP_RUN_CHUNKS, GROUP_RUNS = (1, 7, 4096), (1, 3, 1001, 4096)
# kernel 9's route edges: run counts around kernel.warp_limit at these
# chunk counts and G; and run planes one int32 off a 16-byte boundary
GROUP_EDGE_CHUNKS, GROUP_EDGE_SIZES = (7, 1056, 1057, 4096), (1, 8, 128, 1024)
GROUP_UNALIGNED = ((1, 4), (7, 1000), (4096, 4), (9, 4096))
RUN_PREDS = (None, ("ge", 60, False), ("ge", 60, True), ("eq", 7, False),
             ("eq", 7, True))
GROUP_REPLACES = "src/repro/kernels/group_aggregate/kernel.py:124"


def group_keys(n_groups: int, join: bool, g: torch.Generator):
    """Sorted int32 group keys on the card, and a key bound past them: an
    arange 3 .. 3 + G - 1 (a GROUP BY's domain), or G distinct keys drawn
    from [0, 8G + 64) (a join's build keys)."""
    if join:
        gk = torch.randperm(8 * n_groups + 64, device="cuda",
                            generator=g)[:n_groups].sort().values
    else:
        gk = torch.arange(3, 3 + n_groups, device="cuda")
    return gk.to(torch.int32), int(gk.max()) + 10


def group_planes(n_chunks: int, rows: int, kmax: int, g: torch.Generator):
    """(n_chunks, rows, 128) int32 key/value/select planes: keys in
    [0, kmax) (some outside the domain), values below 2^16, and a ragged
    select (chunk c selects a random subset of its first n_c rows; chunk
    0 all of its rows)."""
    shape = (n_chunks, rows, 128)
    k = torch.randint(0, kmax, shape, device="cuda", dtype=torch.int32,
                      generator=g)
    v = torch.randint(0, 1 << 16, shape, device="cuda", dtype=torch.int32,
                      generator=g)
    s = torch.randint(0, 2, shape, device="cuda", dtype=torch.int32,
                      generator=g)
    n_c = torch.randint(0, rows * 128 + 1, (n_chunks,), device="cuda",
                        generator=g)
    n_c[0] = rows * 128
    live = torch.arange(rows * 128, device="cuda")[None, :] < n_c[:, None]
    return k, v, s * live.reshape(shape)


def group_parity_phase() -> dict:
    """Kernels 8-9 against their plain versions, bit for bit; each kernel
    9 case on the route the op takes and again on the other route."""
    phase("parity (grouped kernels)")
    from repro_torch.kernels.group_aggregate import kernel as gkern
    from repro_torch.kernels.group_aggregate import ops as gops
    from repro_torch.kernels.scan_compressed.ops import stack_runs

    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    names = ("group_sum_count_batched", "rle_group_accumulate_batched")
    err = dict.fromkeys(names, 0)
    cases = dict.fromkeys(names, 0)
    bad = []

    routes = dict.fromkeys(gkern.ROUTES, 0)

    def check(name, k, r, *what, count=True):
        e = int((k.long() - r.long()).abs().max()) if k.numel() else 0
        if k.shape != r.shape:
            e = max(e, 1)
        err[name] = max(err[name], e)
        cases[name] += count
        if e:
            bad.append((name, *what))

    def rle(v2, l2, keys, pred, *what):
        """One run-plane case through the op (on kernel.route's route)
        and through the wrapper on the other route."""
        want = gops.rle_group_accumulate_stacked(v2, l2, keys, pred=pred,
                                                 mode="torch_ref")
        check("rle_group_accumulate_batched",
              gops.rle_group_accumulate_stacked(v2, l2, keys, pred=pred,
                                                mode="cuda"),
              want, *what)
        way = gkern.route(*v2.shape, len(keys))
        routes[way] += 1
        other = next(r for r in gkern.ROUTES if r != way)
        check("rle_group_accumulate_batched",
              gkern.rle_group_accumulate_batched_planes(
                  v2, l2, keys.to(torch.int32), pred=pred, way=other),
              want, *what, other, count=False)

    def runs(n_chunks, n_runs, vmax, offset=0):
        """Random (n_chunks, n_runs) run planes, values below vmax and
        lengths in [0, 16]; with offset 1, views one int32 into their
        buffers."""
        return [torch.randint(0, hi, (n_chunks * n_runs + offset,),
                              device="cuda", dtype=torch.int32,
                              generator=g)[offset:].view(n_chunks, n_runs)
                for hi in (vmax, 17)]

    def dense(k, v, s, gk, *what):
        out = gops.group_sum_count_batched(k, v, s, gk, mode="cuda")
        check("group_sum_count_batched", out,
              gops.group_sum_count_batched(k, v, s, gk, mode="torch_ref"),
              *what)
        return out

    t0 = time.perf_counter()
    for n_chunks, rows in GROUP_SHAPES:
        for n_groups in GROUP_SIZES:
            for join in (False, True):
                gk, kmax = group_keys(n_groups, join, g)
                k, v, s = group_planes(n_chunks, rows, kmax, g)
                dense(k, v, s, gk, n_chunks, rows, n_groups, join)
    # a full 65536-row chunk of 65535s: its sum passes 2^31
    ones = torch.ones((1, 512, 128), dtype=torch.int32, device="cuda")
    out = dense(ones * 0, ones * 65535, ones,
                torch.zeros(1, dtype=torch.int32, device="cuda"), "65535s")
    big = (int(out[0, 0, 1]) << 16) + int(out[0, 0, 0])
    if big != 65535 * 65536 or int(out[0, 0, 2]) != 65536:
        bad.append(("dense sum past 2^31", out.tolist()))
    del ones
    # one (1, 2^23, 128) chunk: the plain table's whole column
    for n_groups, join in ((128, False), (1024, True)):
        gk, kmax = group_keys(n_groups, join, g)
        k, v, s = group_planes(1, MAIN_ROWS // 128, kmax, g)
        dense(k, v, s, gk, 1, MAIN_ROWS // 128, n_groups, join)
        del k, v, s
    torch.cuda.empty_cache()
    for n_chunks in GROUP_RUN_CHUNKS:
        for n_runs in GROUP_RUNS:
            values = torch.randint(0, 1100, (n_chunks, n_runs),
                                   device="cuda", dtype=torch.int32,
                                   generator=g)
            lengths = torch.randint(0, 17, (n_chunks, n_runs), device="cuda",
                                    dtype=torch.int32, generator=g)
            # ragged run counts: chunk c keeps its first runs only
            v2, l2 = stack_runs([(values[c, :n_runs - c % 3 * (n_runs // 3)],
                                  lengths[c, :n_runs - c % 3 * (n_runs // 3)])
                                 for c in range(n_chunks)])
            for gk in (torch.arange(128, device="cuda"),
                       torch.randperm(1100, device="cuda",
                                      generator=g)[:100].sort().values,
                       torch.arange(1024, device="cuda")):
                for pred in RUN_PREDS:
                    rle(v2, l2, gk, pred, n_chunks, n_runs, len(gk))
    # run counts at the route threshold - 1, at it and past it
    for n_chunks in GROUP_EDGE_CHUNKS:
        for n_groups in GROUP_EDGE_SIZES:
            limit = gkern.warp_limit(n_chunks, n_groups)
            for i, n_runs in enumerate((limit - 1, limit, limit + 1)):
                if n_runs < 1:      # no warp route at this G: runs 1 only
                    continue
                gk, kmax = group_keys(n_groups, i == 1, g)
                rle(*runs(n_chunks, n_runs, kmax), gk, RUN_PREDS[i],
                    "edge", n_chunks, n_runs, n_groups)
    for n_chunks, n_runs in GROUP_UNALIGNED:
        for n_groups, join in ((8, False), (100, True)):
            gk, kmax = group_keys(n_groups, join, g)
            rle(*runs(n_chunks, n_runs, kmax, offset=1), gk, RUN_PREDS[3],
                "unaligned", n_chunks, n_runs, n_groups)
    # one run of 65536 rows of 65535: the reference's int32 sum wraps
    v = torch.full((1, 1), 65535, dtype=torch.int32, device="cuda")
    n = torch.full((1, 1), 65536, dtype=torch.int32, device="cuda")
    key = torch.full((1,), 65535, dtype=torch.int32, device="cuda")
    for mode in ("cuda", "torch_ref", *gkern.ROUTES):
        got = (gops.rle_group_accumulate_stacked(v, n, key, mode=mode)
               if mode in ("cuda", "torch_ref") else
               gkern.rle_group_accumulate_batched_planes(v, n, key, way=mode))
        if got.tolist() != [[[0, -1, 65536]]]:
            bad.append(("rle wrap", mode, got.tolist()))
    cases["rle_group_accumulate_batched"] += 1
    torch.cuda.synchronize()
    print(f"grouped parity cases {cases} max_abs_err {err} "
          f"in {time.perf_counter() - t0:.3f} s; kernel 9 cases by the "
          f"route the op took {routes}, each also on the other route",
          flush=True)
    if bad:
        for b in bad[:20]:
            print("MISMATCH", b, file=sys.stderr)
        fail(f"{len(bad)} grouped kernel/plain mismatches")
    idle = [r for r, c in routes.items() if not c]
    if idle:
        fail(f"kernel 9's routes {idle} took no parity case")
    return err


def build_dim(spec: dict):
    """A small build side on the card: {column: codes}, all 8-bit."""
    from repro_torch.db import BitPackedColumn, Table
    t = Table("dim")
    for name, codes in spec.items():
        t.add(BitPackedColumn.from_values(name, np.array(codes), 8,
                                          device="cuda"))
    return t


def grouped_main_shapes(dim):
    """Six grouped shapes on the main table: dense (G = 128 and 8),
    count-only, a join on a non-contiguous domain, the fallback (w spans
    32768 keys) and an empty selection."""
    from repro_torch.query import GroupBy, HashJoin, Pred
    return [
        ("groupby_dense", GroupBy("a", ("w",))),
        ("groupby_where", GroupBy("x", ("a", "b"),
                                  where=Pred("w", "lt", 16384))),
        ("count_only", GroupBy("x")),
        ("hash_join", HashJoin(dim, "a", "a", aggs=("b",))),
        ("fallback_wide_key", GroupBy("w", ("x",))),
        ("empty_selection", GroupBy("a", ("b",), where=Pred("x", "gt", 7))),
    ]


def grouped_store_shapes(dim):
    """The seven grouped shapes of tests/test_relational.py:175-262."""
    from repro_torch.query import GroupBy, HashJoin, Pred
    return [
        ("groupby_two_aggs", GroupBy("r", ("u", "f"))),
        ("for_key_where", GroupBy("f", ("w",), where=Pred("u", "lt", 64))),
        ("rle_count_only", GroupBy("r")),
        ("rle_key_pred", GroupBy("r", where=Pred("r", "le", 4))),
        ("for16_key", GroupBy("w", ("u",))),
        ("join_plain_key", HashJoin(dim, "u", "u", aggs=("f",),
                                    where=Pred("r", "lt", 7))),
        ("join_rle_key", HashJoin(dim, "r", "r", aggs=("u",))),
    ]


def flat_totals(q):
    """The flat query whose count and sums are a grouped query's totals:
    its plan, restricted for a join to the build keys (an Or of eq
    leaves), aggregating its value columns (or the key, count-only)."""
    from repro_torch.query import And, HashJoin, Or, Pred, Query, relational
    plan = q.plan()
    if isinstance(q, HashJoin):
        leaves = [Pred(q.key, "eq", k)
                  for k in relational.build_keys(q).tolist()]
        member = Or.of(*leaves) if len(leaves) > 1 else leaves[0]
        plan = And.of(q.where, member) if q.where is not None else member
    return Query(plan, aggregates=q.aggs or (q.key,))


def grouped_phase(table, shapes, label: str, rows: int, plain=None,
                  rounds: int = 1) -> dict:
    """The grouped shapes through QueryEngine(table, "auto") `rounds`
    times (cold, then warm), each result against QueryEngine(table,
    "torch_ref"), the port's oracle on the card (over `plain`, the plain
    table, for a store table), `plain`'s own engine, and the flat engine's
    count and sums; kernels 8-9 must have launched."""
    phase(f"grouped {label}")
    from repro_torch.kernels.group_aggregate import kernel as gk
    from repro_torch.query import QueryEngine, relational
    flat = plain if plain is not None else table
    gk.LAUNCHES = gk.RLE_LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    eng = QueryEngine(table, mode="auto")
    runs = [[] for _ in range(rounds)]
    for out in runs:
        for name, q in shapes:
            eng.submit(q)
            out.append(eng.run()[0])
    launches = {"group_sum_count_batched": gk.LAUNCHES,
                "rle_group_accumulate_batched": gk.RLE_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    print(f"kernel launches on the grouped {label} path: {launches}; "
          f"dispatch counts {eng.metrics.launch_counts()}")
    print(f"device memory: tables {base_mem / 2**30:.3f} GiB, peak "
          f"{peak / 2**30:.3f} GiB during the grouped queries")
    ref = QueryEngine(table, mode="torch_ref")
    other = QueryEngine(plain, mode="auto") if plain is not None else None
    totals = QueryEngine(table, mode="auto")
    bad = []
    for i, (name, q) in enumerate(shapes):
        ref.submit(q)
        want = ref.run()[0]
        t0 = time.perf_counter()
        oracle = relational.execute_grouped_oracle(q, flat)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        got = [out[i] for out in runs]
        same = all(r.aggregates == want.aggregates == oracle for r in got)
        line = " ".join(f"{r.latency_s * 1e3:9.3f} ms" for r in got)
        w = got[-1]
        msg = (f"{name:18s} {line}  phys "
               f"{w.bytes_scanned / w.latency_s / 1e9:7.1f} GB/s  eff "
               f"{w.logical_bytes / w.latency_s / 1e9:7.1f} GB/s | "
               f"torch_ref {want.latency_s * 1e3:9.3f} ms | oracle "
               f"{oracle_s * 1e3:9.3f} ms")
        if other is not None:
            other.submit(q)
            p = other.run()[0]
            same = same and p.aggregates == oracle
            msg += f" | plain {p.latency_s * 1e3:8.3f} ms"
        totals.submit(flat_totals(q))
        f = totals.run()[0].aggregates
        groups = w.aggregates["groups"]
        agree = f[next(iter(f))]["count"] == w.count and all(
            f[a]["sum"] == sum(gr["sums"][a] for gr in groups.values())
            for a in q.aggs)
        print(f"{msg} | {len(groups)} groups, count {w.count} "
              f"equal={same} totals={agree}")
        ok = same and agree and 0 <= w.count <= rows and all(
            gr["count"] > 0 for gr in groups.values())
        if not ok:
            bad.append((name, [r.aggregates for r in got], want.aggregates,
                        oracle))
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} grouped {label} results differ")
    return {"launches": launches, "results": runs[-1], "peak": peak}


def group_times_main(table, dev: dict) -> dict:
    """Kernel 8 at the main path's shape: groupby_dense, a over w, G = 128,
    one (1, 2^23, 128) chunk; its select plane as the engine builds it."""
    phase("grouped times (main)")
    from repro_torch.kernels.group_aggregate import kernel as gk
    from repro_torch.kernels.group_aggregate import ref as gref
    from repro_torch.kernels.scan_filter.ref import unpack
    a, w = table.columns["a"], table.columns["w"]
    n = table.num_rows
    keys = unpack(a.words, a.code_bits)[:n].reshape(1, -1, 128)
    vals = unpack(w.words, w.code_bits)[:n].reshape(1, -1, 128)
    sel = (keys >= 0).to(torch.int32)
    dom = torch.arange(128, dtype=torch.int32, device="cuda")
    print(f"  group_sum_count_batched at {list(keys.shape)}, G = 128: "
          f"a over w (groupby_dense)")
    rec = time_kernel(
        "group_sum_count_batched",
        lambda: gk.group_sum_count_batched_planes(keys, vals, sel, dom),
        lambda: gref.group_sum_count_batched_ref(keys, vals, sel, dom),
        12 * n + 12 * 128, 5 * n, dev)
    rec["shape"] = list(keys.shape) + [128]
    del keys, vals, sel
    torch.cuda.empty_cache()
    return rec


def group_times_store(encoded, dev: dict) -> tuple[dict, dict]:
    """Kernel 8 at the store's shape (r over u, 4096 x 512 x 128, G = 8),
    kernel 9 at r's run planes (G = 8) and at 4096 x 4096 random runs
    (G = 128), each of kernel 9's split into device and host time on its
    route, and its other route timed at each shape (route_split)."""
    phase("grouped times (store)")
    from repro_torch.kernels.group_aggregate import kernel as gk
    from repro_torch.kernels.group_aggregate import ref as gref
    from repro_torch.query import GroupBy
    from repro_torch.store.exec import _grouped_planes, _run_planes_cached
    n = encoded.n_chunks
    cids = np.arange(n)
    logical, payload, sel, _ = _grouped_planes(GroupBy("r", ("u",)),
                                               encoded, ["r", "u"], cids)
    keys3 = logical["r"].reshape(n, -1, 128)
    vals3 = payload["u"].reshape(n, -1, 128)
    sel3 = sel.to(torch.int32).reshape(n, -1, 128)
    d8 = torch.arange(8, dtype=torch.int32, device="cuda")
    rows = keys3.numel()
    print(f"  group_sum_count_batched at {list(keys3.shape)}, G = 8: r over "
          f"u (groupby_two_aggs)")
    dense = time_kernel(
        "group_sum_count_batched",
        lambda: gk.group_sum_count_batched_planes(keys3, vals3, sel3, d8),
        lambda: gref.group_sum_count_batched_ref(keys3, vals3, sel3, d8),
        12 * rows + 12 * 8 * n, 5 * rows, dev)
    dense["shape"] = list(keys3.shape) + [8]
    del logical, payload, sel, keys3, vals3, sel3
    rv, rl = _run_planes_cached(encoded.columns["r"], cids)
    print(f"  rle_group_accumulate_batched at {list(rv.shape)}, G = 8: r's "
          f"run planes (rle_count_only)")

    def small(way=None):
        return gk.rle_group_accumulate_batched_planes(rv, rl, d8, way=way)
    rle = time_kernel(
        "rle_group_accumulate_batched", small,
        lambda: gref.rle_group_accumulate_batched_ref(rv, rl, d8),
        8 * rv.numel() + 12 * 8 * n, 6 * rv.numel(), dev)
    rle["shape"] = list(rv.shape) + [8]
    rle.update(route_split(small, (*rv.shape, 8), gk, RLE_GROUP_KERNELS,
                           dev))
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    bv = torch.randint(0, 128, (n, 4096), device="cuda", dtype=torch.int32,
                       generator=g)
    bl = torch.randint(0, 17, (n, 4096), device="cuda", dtype=torch.int32,
                       generator=g)
    d128 = torch.arange(128, dtype=torch.int32, device="cuda")
    print(f"  rle_group_accumulate_batched at [{n}, 4096], G = 128: random "
          f"runs")

    def large(way=None):
        return gk.rle_group_accumulate_batched_planes(bv, bl, d128, way=way)
    big = time_kernel(
        "rle_group_accumulate_batched", large,
        lambda: gref.rle_group_accumulate_batched_ref(bv, bl, d128),
        8 * bv.numel() + 12 * 128 * n, 6 * bv.numel(), dev)
    rle["largest_plane"] = {k: big[k] for k in (
        "ms", "ms_back_to_back", "plain_ms", "bound_ms", "bound_by",
        "max_abs_err")}
    rle["largest_plane"].update(route_split(
        large, (*bv.shape, 128), gk, RLE_GROUP_KERNELS, dev))
    return dense, rle


def group_records(main_rec: dict, store_dense: dict, store_rle: dict,
                  launches: dict, parity_err: dict) -> list:
    """The {"kernels": ...} entries of kernels 8 and 9: kernel 8 at the
    main shape (with its store-shape time beside it), kernel 9 at r's run
    planes (with its largest plane); launches over both grouped phases."""
    dense = dict(main_rec)
    dense["store_shape"] = {k: store_dense[k] for k in (
        "ms", "ms_back_to_back", "plain_ms", "bound_ms", "bound_by",
        "max_abs_err", "shape")}
    out = []
    for rec, name in ((dense, "group_sum_count_batched"),
                      (dict(store_rle), "rle_group_accumulate_batched")):
        rec.update({"source": "src/repro_torch/csrc/group_aggregate.cu",
                    "replaces": GROUP_REPLACES,
                    "launches": sum(l[name] for l in launches.values()),
                    "launches_by_path": {p: l[name]
                                         for p, l in launches.items()},
                    "max_abs_err": max(rec["max_abs_err"],
                                       parity_err[name])})
        out.append(rec)
    return out


# --------------------------------------------------------------------------
# the tier slice: placement, prefetch, the energy meter and the power cap
# --------------------------------------------------------------------------

# benchmarks/tier_bench.py's table and traffic at a size the card holds:
# sixteen 8-bit columns (:41-45, 67-70) at 2^28 rows (4 GiB packed), in
# 1 MiB placement chunks (256 a column, 4096 in all), the fast tier at a
# quarter of the table, three skews of 150 queries from seed 7, deadlines
# at twice the all-fast service time of the mean query (:78-86).
TIER_ROWS = 1 << 28
TIER_SPEC = {f"c{i:02d}": 8 for i in range(16)}
TIER_CHUNK_ROWS = 1 << 20
TIER_FAST_FRACTION = 0.25
TIER_SKEWS = (0.6, 1.1, 1.5)
TIER_QUERIES = 150
TIER_SEED = 7
TIER_SLA_SLACK = 2.0
TIER_TUNE_WORDS = 1 << 28     # kernel 3 at the main path's shape
STORE_TIER_QUERIES = 60
CAP_TOL = 1e-9                # tests/test_energy.py's slack on the budget


def build_tier_table():
    """TIER_SPEC at TIER_ROWS, built on the card from a seeded generator
    as build_table does (Table.synthetic's host numpy would need tens of
    GB here): random payload bits, delimiters cleared."""
    from repro_torch.db import BitPackedColumn, Table
    from repro_torch.kernels.scan_filter.ref import field_masks
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    t = Table("tier")
    for name, bits in TIER_SPEC.items():
        delim, _, _ = field_masks(bits)
        t.add(BitPackedColumn(name, bits, TIER_ROWS, random_words(
            TIER_ROWS * bits // 32, ~int(delim) & 0xFFFFFFFF, g)))
    for col in t.columns.values():
        col.valid_words
    torch.cuda.synchronize()
    return t


def measure_fast_tier(dev: dict) -> float:
    """The fast tier's rate from this run: a fresh tune cache, filled by
    tune.autotune over kernel 3 at TIER_TUNE_WORDS words (three planes
    streamed, each call synchronised), read back by measured_fast_gbps.
    Fails if the cache gives no rate."""
    from repro_torch.kernels import tune
    from repro_torch.kernels.scan_aggregate import kernel as fused_k
    from repro_torch.kernels.scan_filter.ref import as_int32, field_masks
    from repro_torch.tier import measured_fast_gbps
    path = SRC.parent / "build" / "chip_smoke" / "tune_cache.json"
    path.unlink(missing_ok=True)
    tune.set_cache_path(path)
    if measured_fast_gbps() is not None:
        fail(f"the fresh tune cache {path} already prices the fast tier")
    delim, _, _ = field_masks(8)
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    n = TIER_TUNE_WORDS
    pred = random_words(n, ~int(delim) & 0xFFFFFFFF, g)
    agg = random_words(n, ~int(delim) & 0xFFFFFFFF, g)
    valid = torch.full((n,), as_int32(delim), dtype=torch.int32,
                       device="cuda")

    def bench(params):
        fused_k.scan_aggregate_packed(pred, agg, valid, constant=50,
                                      op="ge", invert=True, code_bits=8)
        torch.cuda.synchronize()

    entry = tune.autotune("scan_aggregate",
                          tune.shape_key(rows=n // 128, bits=8), {}, bench)
    gbps = measured_fast_gbps()
    if gbps is None:
        fail("measured_fast_gbps() gave no rate after the sweep")
    print(f"kernel 3 at {n} words, 3 planes: {entry['us']} us a "
          f"synchronised call -> fast tier {gbps:.2f} GB/s "
          f"(tune cache {path.relative_to(SRC.parent)}) [{dev['smi']}]")
    del pred, agg, valid
    torch.cuda.empty_cache()
    return gbps


class HostClock:
    """Host seconds spent in the tier layer's Python (placement's per-chunk
    loops, the prefetch plan, the chunk accounting, the power governor),
    by wrapping those methods for the duration of a `with`. (The fast
    tier never holds more than its capacity: `TieredBudget.alloc`
    raises first, and the replay with it.)"""

    def __init__(self):
        from repro_torch.energy.caps import PowerCap
        from repro_torch.query.engine import QueryEngine
        from repro_torch.tier.placement import PlacementEngine
        from repro_torch.tier.prefetch import PrefetchPipeline
        self.targets = [(PlacementEngine, "on_access"),
                        (PrefetchPipeline, "plan"),
                        (QueryEngine, "chunk_accesses"),
                        (PowerCap, "throttled_service_s")]
        self.seconds = {name: 0.0 for _, name in self.targets}

    def __enter__(self):
        self.saved = [(cls, name, getattr(cls, name))
                      for cls, name in self.targets]
        for cls, name, fn in self.saved:
            setattr(cls, name, self.wrap(name, fn))
        return self

    def wrap(self, name, fn):
        def timed(obj, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(obj, *a, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


def torch_ref_answers(table, trace) -> list:
    """Each traced query through QueryEngine(table, "torch_ref"), no
    deadlines: the plain versions' answers, by query id - 1."""
    from repro_torch.query import QueryEngine
    eng = QueryEngine(table, mode="torch_ref")
    out = []
    for tq in trace:
        eng.submit(tq.query)
        out.append(eng.run()[0].aggregates)
    return out


def sla_of(table, trace, tiers) -> float:
    """tier_bench's deadline: TIER_SLA_SLACK x the mean query's bytes at
    the fast tier's rate."""
    from repro_torch.query import physical
    mean = sum(physical.referenced_bytes(q.query.plan(), q.query.aggregates,
                                         table.columns)
               for q in trace) / len(trace)
    return TIER_SLA_SLACK * mean / tiers.fast.bandwidth


def tier_replay(label: str, table, trace, tiers, policy, want, bad: list,
                **kw) -> dict:
    """One replay_trace on the card, timed on the host with its tier-layer
    share; each answer against `want` (torch_ref's); prints and returns
    the record."""
    from repro_torch.tier import replay_trace
    with HostClock() as hc:
        t0 = time.perf_counter()
        pe, eng, att = replay_trace(table, trace, tiers, policy,
                                    chunk_rows=TIER_CHUNK_ROWS, **kw)
        wall = time.perf_counter() - t0
    wrong = [r.qid for r in eng.results if r.aggregates != want[r.qid - 1]]
    if wrong:
        bad.append((label, policy, "answers differ from torch_ref", wrong))
    s = eng.summary()
    m = s["energy"]
    served = max(s["served"], 1)
    rec = {"policy": policy, "hit_rate": pe.hit_rate,
           "blended_gbps": s["tier"]["blended_gbps"],
           "attainment": att, "served": s["served"],
           "rejected": s["rejected"], "fast_j": m["fast_j"],
           "capacity_j": m["capacity_j"], "compute_j": m["compute_j"],
           "total_j": m["total_j"], "seconds_total": eng.seconds_total,
           "service_ms_a_query": eng.seconds_total / served * 1e3,
           "host_ms_a_query": wall / len(trace) * 1e3,
           "tier_host_ms_a_query": {k: v / len(trace) * 1e3
                                    for k, v in hc.seconds.items()},
           "fast_bytes": pe.fast_bytes_total,
           "capacity_bytes": pe.capacity_bytes_total}
    host = rec["tier_host_ms_a_query"]
    print(f"{label:22s} {policy:8s} hit {pe.hit_rate:.4f}  blended "
          f"{rec['blended_gbps']:9.2f} GB/s  attainment "
          f"{'-' if att is None else f'{att:.4f}'}  served "
          f"{s['served']:3d} rejected {s['rejected']:3d}  J fast "
          f"{m['fast_j']:.4f} capacity {m['capacity_j']:.4f} compute "
          f"{m['compute_j']:.4f}  service {rec['service_ms_a_query']:.4f} "
          f"ms/q  host {rec['host_ms_a_query']:.3f} ms/q (on_access "
          f"{host['on_access']:.3f}, plan {host['plan']:.3f}, chunks "
          f"{host['chunk_accesses']:.3f}, governor "
          f"{host['throttled_service_s']:.3f})", flush=True)
    return {"rec": rec, "pe": pe, "eng": eng, "att": att}


def tier_kernel_counters():
    """Launch counters of kernels 1-3 and 8 (the flat tiered path) and
    4, 5, 7 and 9 (the store's): name -> (module, attribute)."""
    from repro_torch.kernels.aggregate import kernel as agg_k
    from repro_torch.kernels.group_aggregate import kernel as gk
    from repro_torch.kernels.scan_aggregate import kernel as fused_k
    from repro_torch.kernels.scan_compressed import kernel as rle_k
    from repro_torch.kernels.scan_filter import kernel as scan_k
    return {"scan_filter": (scan_k, "LAUNCHES"),
            "aggregate": (agg_k, "LAUNCHES"),
            "scan_aggregate": (fused_k, "LAUNCHES"),
            "group_sum_count_batched": (gk, "LAUNCHES"),
            "aggregate_batched": (agg_k, "BATCHED_LAUNCHES"),
            "scan_aggregate_batched": (fused_k, "BATCHED_LAUNCHES"),
            "rle_scan_aggregate_batched": (rle_k, "BATCHED_LAUNCHES"),
            "rle_group_accumulate_batched": (gk, "RLE_LAUNCHES")}


def reset_counters() -> dict:
    counters = tier_kernel_counters()
    for m, attr in counters.values():
        setattr(m, attr, 0)
    return counters


def tiered_main_phase(dev: dict) -> dict:
    """The tiered engine on the card at the tier bench's shape: every skew
    under the three policies, then at skew 1.1 under MEMCACHE with
    prefetch, with the die-stacked chip's compute power uncapped and
    capped at half its demand, and with GroupBy/HashJoin in the mix; a
    torch_ref replay beside the kernel one; answers against torch_ref."""
    phase("tiered main")
    from repro_torch.core import DIE_STACKED
    from repro_torch.energy import PowerCap, chip_compute_watts
    from repro_torch.tier import TraceSpec, make_trace, paper_tiers
    fast_gbps = measure_fast_tier(dev)
    table = build_tier_table()
    tiers = paper_tiers(TIER_FAST_FRACTION * table.nbytes,
                        fast_gbps=fast_gbps)
    print(f"table {table.num_rows} rows x {len(table.columns)} columns, "
          f"{table.nbytes / 2**30:.3f} GiB packed; chunks of "
          f"{TIER_CHUNK_ROWS} rows; fast tier {tiers.fast.gbps:.2f} GB/s "
          f"over {tiers.fast.capacity / 2**30:.3f} GiB, capacity tier "
          f"{tiers.capacity.gbps:.2f} GB/s [{dev['smi']}]", flush=True)
    traces = {s: make_trace(table, TraceSpec(n_queries=TIER_QUERIES,
                                             skew=s, seed=TIER_SEED))
              for s in TIER_SKEWS}
    grouped = make_trace(table, TraceSpec(n_queries=TIER_QUERIES, skew=1.1,
                                          seed=TIER_SEED, p_grouped=0.1,
                                          p_join=0.05))
    t0 = time.perf_counter()
    want = {s: torch_ref_answers(table, tr) for s, tr in traces.items()}
    want["grouped"] = torch_ref_answers(table, grouped)
    print(f"torch_ref answers for {len(want)} traces: "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    bad: list = []
    out = {"fast_gbps": tiers.fast.gbps,
           "capacity_gbps": tiers.capacity.gbps, "replays": {}}
    counters = reset_counters()
    runs = {}
    for s, trace in traces.items():
        sla_s = sla_of(table, trace, tiers)
        print(f"skew {s}: sla {sla_s * 1e3:.4f} ms", flush=True)
        for policy in ("static", "cache", "memcache"):
            runs[s, policy] = tier_replay(f"skew {s}", table, trace, tiers,
                                          policy, want[s], bad, sla_s=sla_s)
    trace, sla_s = traces[1.1], sla_of(table, traces[1.1], tiers)
    sync = runs[1.1, "memcache"]
    pf = tier_replay("skew 1.1 prefetch", table, trace, tiers, "memcache",
                     want[1.1], bad, sla_s=sla_s,
                     prefetch_bytes=int(tiers.fast.capacity // 8))
    compute_w = chip_compute_watts(DIE_STACKED)
    unc = tier_replay("skew 1.1 compute", table, trace, tiers, "memcache",
                      want[1.1], bad, sla_s=sla_s, compute_w=compute_w)
    demand_w = unc["rec"]["total_j"] / unc["rec"]["seconds_total"]
    cap = PowerCap(0.5 * demand_w, window_s=20 * sla_s)
    capped = tier_replay("skew 1.1 capped", table, trace, tiers,
                         "memcache", want[1.1], bad, sla_s=sla_s,
                         compute_w=compute_w, power_cap=cap)
    grp = tier_replay("skew 1.1 grouped", table, grouped, tiers,
                      "memcache", want["grouped"], bad,
                      sla_s=sla_of(table, grouped, tiers))
    launches = {k: getattr(m, attr) for k, (m, attr) in counters.items()}
    print(f"kernel launches on the tiered main path: {launches}")
    ref = tier_replay("skew 1.1 torch_ref", table, trace, tiers,
                      "memcache", want[1.1], bad, sla_s=sla_s,
                      mode="torch_ref")
    # the accounting does not depend on the mode
    for what, a, b in (
            ("stats", sync["pe"].stats(), ref["pe"].stats()),
            ("meter", sync["pe"].meter.summary(),
             ref["pe"].meter.summary()),
            ("tier dicts", [r.tier for r in sync["eng"].results],
             [r.tier for r in ref["eng"].results]),
            ("attainment", sync["att"], ref["att"]),
            ("rejected", sync["eng"].rejected, ref["eng"].rejected)):
        if a != b:
            bad.append(("torch_ref replay", what, a, b))
    for (s, policy), r in runs.items():
        other = runs[s, "static"]["eng"].results
        common = {x.qid: x.aggregates for x in other}
        if any(x.aggregates != common[x.qid] for x in r["eng"].results
               if x.qid in common):
            bad.append(("policies disagree", s, policy))
    if not pf["eng"].seconds_total <= sync["eng"].seconds_total:
        bad.append(("prefetch slower than sync",
                    pf["eng"].seconds_total, sync["eng"].seconds_total))
    if [r.aggregates for r in pf["eng"].results] != \
            [want[1.1][r.qid - 1] for r in pf["eng"].results]:
        bad.append(("prefetch answers",))
    rep = cap.report(now=capped["eng"].clock())
    print(f"power cap: budget {cap.budget_w:.4f} W (demand "
          f"{demand_w:.4f} W), window {cap.window_s * 1e3:.4f} ms, max "
          f"window {rep['max_window_w']:.4f} W, throttled "
          f"{rep['throttled_queries']} queries by "
          f"{rep['throttle_s_total'] * 1e3:.4f} ms; attainment "
          f"{capped['att']} capped vs {unc['att']} uncapped")
    print(f"prefetch: {json.dumps(pf['eng'].prefetch.stats())}; modeled "
          f"{pf['eng'].seconds_total * 1e3:.4f} ms vs sync "
          f"{sync['eng'].seconds_total * 1e3:.4f} ms")
    if not rep["max_window_w"] <= cap.budget_w * (1 + CAP_TOL):
        bad.append(("power cap exceeded", rep))
    if not capped["att"] <= unc["att"]:
        bad.append(("capped attainment above uncapped", capped["att"],
                    unc["att"]))
    if not sum(1 for r in grp["eng"].results if "groups" in r.aggregates):
        bad.append(("no grouped query served in the grouped replay",))
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} tiered main checks failed")
    zero = [k for k in ("scan_filter", "aggregate", "scan_aggregate",
                        "group_sum_count_batched") if launches[k] == 0]
    if zero:
        fail(f"kernels never launched on the tiered main path: {zero}")
    for key, r in (("prefetch", pf), ("compute", unc), ("capped", capped),
                   ("grouped", grp), ("torch_ref", ref)):
        out["replays"][key] = r["rec"]
    out["replays"].update({f"{p} skew {s}": r["rec"]
                           for (s, p), r in runs.items()})
    out["power_cap"] = rep
    out["launches"] = launches
    del table, runs, pf, unc, capped, grp, ref, sync
    release()
    return out


def store_tier_trace(table, fast_gbps: float) -> tuple:
    """The tiered store cell's tiers (a quarter of the plain bytes fast)
    and trace: STORE_TIER_QUERIES at skew 1.1, then three queries that
    reach the RLE kernels."""
    from repro_torch.query import GroupBy, Pred, Query
    from repro_torch.tier import TracedQuery, TraceSpec, make_trace, \
        paper_tiers
    tiers = paper_tiers(TIER_FAST_FRACTION * table.nbytes,
                        fast_gbps=fast_gbps)
    trace = make_trace(table, TraceSpec(n_queries=STORE_TIER_QUERIES,
                                        skew=1.1, seed=TIER_SEED,
                                        p_grouped=0.1))
    trace += [TracedQuery(0, Query(Pred("r", "lt", 4), aggregates=("r",))),
              TracedQuery(1, GroupBy("r")),
              TracedQuery(2, GroupBy("r", where=Pred("r", "le", 4)))]
    return tiers, trace


def tiered_store_phase(table, encoded, fast_gbps: float, dev: dict) -> dict:
    """One skew-1.1 trace under CACHE over the store phase's plain table
    and its encoded copy, the fast tier at a quarter of the plain bytes:
    the encoded replay streams its physical bytes. The trace's queries
    never aggregate their predicate's column and its count-only rollups
    are on other keys, so three store queries follow it that reach the
    RLE kernels (a fused scan of r over r, r's count-only rollups)."""
    phase("tiered store")
    tiers, trace = store_tier_trace(table, fast_gbps)
    want = torch_ref_answers(encoded, trace)
    bad: list = []
    counters = reset_counters()
    plain = tier_replay("store plain", table, trace, tiers, "cache", want,
                        bad)
    enc = tier_replay("store encoded", encoded, trace, tiers, "cache", want,
                      bad)
    launches = {k: getattr(m, attr) for k, (m, attr) in counters.items()}
    print(f"kernel launches on the tiered store path: {launches}")
    print(f"bytes streamed: plain {plain['rec']['fast_bytes']} fast + "
          f"{plain['rec']['capacity_bytes']} capacity, encoded "
          f"{enc['rec']['fast_bytes']} + {enc['rec']['capacity_bytes']}; "
          f"hit rate plain {plain['rec']['hit_rate']:.4f}, encoded "
          f"{enc['rec']['hit_rate']:.4f}")
    if [r.aggregates for r in plain["eng"].results] != \
            [r.aggregates for r in enc["eng"].results]:
        bad.append(("plain and encoded replays disagree",))
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} tiered store checks failed")
    zero = [k for k in ("aggregate_batched", "scan_aggregate_batched",
                        "rle_scan_aggregate_batched",
                        "rle_group_accumulate_batched")
            if launches[k] == 0]
    if zero:
        fail(f"kernels never launched on the tiered store path: {zero}")
    return {"plain": plain["rec"], "encoded": enc["rec"],
            "launches": launches}


# --------------------------------------------------------------------------
# the paper model: Eq. 4 calibrated by the engine's scans on the card
# --------------------------------------------------------------------------

FUSED_PLANS = ("single_pred_fused", "fused_ge", "fused_gt", "fused_eq",
               "fused_ne")
MODEL_SLAS = (0.010, 0.100)
MODEL_MAX_FRACTION = 1.05     # a scan above the datasheet mis-counts bytes
SWEEP_POINTS = 64
SWEEP_RTOL = 1e-5             # tests/test_torch_paper_model.py's SOFT_RTOL
GRAD_RTOL = 1e-4              # ... and GRAD_RTOL
SCALAR_RTOL = 0.02            # tests/test_core_engines.py's hard-sweep 2%
PAPER_DB = 16 * 2**40         # the paper's 16 TiB at 20% accessed
PAPER_ACCESS = 0.20
COST_BUDGET_W = 1e6
COST_SLAS = (0.010, 1.0)


def paper_engine_phase(table, dev: dict) -> dict:
    """The engine's measured scans against the paper model on the main
    table: the eleven plans twice through fresh QueryEngine(mode="auto")s
    (the first pass, then the warm one that model_check and provision
    read), the fused plans alone, answers against torch_ref;
    model_check on the H100 row and DIE_STACKED, provision at
    MODEL_SLAS on the H100 row and the paper's three systems, each against
    advisor.advise_scan_sla called by hand with the engine's counters."""
    phase("paper model")
    from repro_torch.core import (BIG_MEMORY, DIE_STACKED, H100_SXM,
                                  TRADITIONAL, advisor, as_paper_system)
    from repro_torch.query import Query, QueryEngine
    shapes = plan_shapes()
    mods = kernel_modules()
    for m in mods.values():
        m.LAUNCHES = 0

    def run(names=None) -> tuple:
        eng = QueryEngine(table, mode="auto")
        out = []
        for name, plan, aggs in shapes:
            if names is None or name in names:
                eng.submit(Query(plan, aggregates=aggs))
                out.append((name, eng.run()[0]))
        return eng, out

    first, got_first = run()
    warm, got_warm = run()
    fused, _ = run(FUSED_PLANS)
    launches = {k: m.LAUNCHES for k, m in mods.items()}
    print(f"kernel launches on the paper model's path: {launches}")
    ref = QueryEngine(table, mode="torch_ref")
    bad = []
    for (name, plan, aggs), (_, a), (_, b) in zip(shapes, got_first,
                                                  got_warm):
        ref.submit(Query(plan, aggregates=aggs))
        want = ref.run()[0].aggregates
        if a.aggregates != want or b.aggregates != want:
            bad.append((name, a.aggregates, b.aggregates, want))
    h100 = as_paper_system(H100_SXM)
    rec = {"queries": len(warm.reports), "bytes_total": warm.bytes_total,
           "seconds_total": warm.seconds_total, "db_bytes": table.nbytes,
           "launches": launches}
    for label, eng in (("first pass", first), ("warm", warm),
                       ("fused warm", fused)):
        for sys_ in (None, DIE_STACKED):
            mc = eng.model_check(sys_)
            rec[f"model_check {label} {mc['system']}"] = mc
            print(f"model_check {label:10s} {mc['system']:18s} measured "
                  f"{mc['measured_gbps']:9.2f} GB/s  model "
                  f"{mc['model_gbps']:8.2f} GB/s  attained "
                  f"{mc['attained_fraction']:.4f}  [{dev['smi']}]")
    frac = warm.model_check()["attained_fraction"]
    if not 0 < frac <= MODEL_MAX_FRACTION:
        bad.append(("warm H100 attained fraction", frac))
    measured = warm.bytes_total / warm.seconds_total / warm.n_shards
    bpq = warm.bytes_total / len(warm.reports)
    rec["provision"] = {}
    for sla in MODEL_SLAS:
        for sys_ in (h100, TRADITIONAL, BIG_MEMORY, DIE_STACKED):
            adv = warm.provision(sla, system=sys_)
            by_hand = advisor.advise_scan_sla(
                db_bytes=table.nbytes, bytes_per_query=bpq, sla_s=sla,
                system=sys_, measured_chip_bps=measured)
            d = adv.design
            rec["provision"][f"{sys_.name} {sla}"] = adv.summary()
            print(f"provision {sla * 1e3:6.1f} ms {sys_.name:18s} chips "
                  f"{d.compute_chips:4d} cores {d.cores_per_chip:2d} "
                  f"response {d.response_time * 1e3:8.4f} ms power "
                  f"{d.power / 1e3:8.3f} kW")
            if adv.summary() != by_hand.summary():
                bad.append(("provision vs advise_scan_sla", sys_.name, sla))
            if not d.response_time <= sla * (1 + 1e-9):
                bad.append(("design misses its SLA", sys_.name, sla,
                            d.response_time))
    # the paper's question at its own scale, at this engine's rate
    for sys_ in (h100, DIE_STACKED):
        adv = advisor.advise_scan_sla(PAPER_DB, PAPER_ACCESS * PAPER_DB,
                                      MODEL_SLAS[0], sys_,
                                      measured_chip_bps=measured)
        rec["provision"][f"paper 16 TiB {sys_.name}"] = adv.summary()
        print(f"paper 16 TiB at 20%, {MODEL_SLAS[0] * 1e3:.0f} ms, "
              f"{sys_.name} at the measured rate: "
              f"{adv.design.compute_chips} chips, "
              f"{adv.design.power / 1e3:.3f} kW")
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} paper model (engine) checks failed")
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        fail(f"kernels never launched on the paper model's path: {zero}")
    return rec


def paper_model_phase(engine_rec: dict, tier: dict, ratio: float,
                      dev: dict) -> dict:
    """The rest of the paper model from this run's measurements: the tier
    split at the tiered phase's fast rate and skew-1.1 MEMCACHE hit rate,
    the cost surface at the store's ratio, the SLA sweep on the card."""
    phase("paper model (tier split, cost, sweep)")
    from repro_torch.core import (BIG_MEMORY, DIE_STACKED, H100_SXM,
                                  TRADITIONAL, Workload, advisor,
                                  as_paper_system, provision_performance,
                                  sweep)
    from repro_torch.energy import tco
    h100 = as_paper_system(H100_SXM)
    main = tier["main"]
    fast, cap = main["fast_gbps"], main["capacity_gbps"]
    mem = main["replays"]["memcache skew 1.1"]
    db = TIER_ROWS * sum(TIER_SPEC.values()) / 8
    bpq = (mem["fast_bytes"] + mem["capacity_bytes"]) / mem["served"]
    sla = TIER_SLA_SLACK * bpq / (fast * 1e9)
    bad = []
    out = {"engine": engine_rec}
    for label, fs in (("h100", h100), ("default", None)):
        adv = advisor.advise_tier_split(
            db, bpq, sla, hit_curve={TIER_FAST_FRACTION: mem["hit_rate"]},
            fast_gbps=fast, capacity_gbps=cap, fast_system=fs)
        row = next(r for r in adv["rows"]
                   if r["fast_fraction"] == TIER_FAST_FRACTION)
        out[f"tier split {label}"] = {k: adv[k] for k in (
            "roofline_gbps", "fast_within_roofline", "best")} | {"row": row}
        print(f"tier split ({label} fast system): roofline "
              f"{adv['roofline_gbps']:.2f} GB/s, fast {fast:.2f} GB/s "
              f"within {adv['fast_within_roofline']}; at "
              f"{TIER_FAST_FRACTION}: hit {row['hit_rate']:.4f} blended "
              f"{row['blended_gbps']:.2f} GB/s response "
              f"{row['response_time_s'] * 1e3:.4f} ms (sla "
              f"{sla * 1e3:.4f} ms) within {row['within_roofline']}; best "
              f"{adv['best'] and adv['best']['fast_fraction']}")
        if fs is not None and not (adv["fast_within_roofline"]
                                   and row["within_roofline"]):
            bad.append(("H100-row tier split outside its roofline", adv))
    bpq_paper = PAPER_ACCESS * PAPER_DB
    systems = (TRADITIONAL, BIG_MEMORY, DIE_STACKED, h100)
    for s_ in COST_SLAS:
        cell = tco.cheapest_architecture(PAPER_DB, bpq_paper, s_,
                                         COST_BUDGET_W, systems=systems,
                                         compression_ratio=ratio)
        t = tco.evaluate_tiered(PAPER_DB, bpq_paper, s_, 1.1,
                                fast_gbps=fast, fast_system=h100)
        out[f"cost {s_}"] = {"winner": cell["winner"],
                             "usd_per_query": cell["usd_per_query"],
                             "candidates": cell["candidates"],
                             "tiered_h100": t}
        cands = ", ".join(
            f"{c['name']} {c['chips']} chips {c['power_w'] / 1e3:.1f} kW "
            f"${c['usd_per_query']:.3e}{'' if c['feasible'] else ' (x)'}"
            for c in cell["candidates"])
        print(f"cost at {s_ * 1e3:.0f} ms, 1 MW, store ratio {ratio:.4f}: "
              f"winner {cell['winner']} ${cell['usd_per_query']}/query; "
              f"{cands}")
        if t is None:
            bad.append(("no tiered H100 candidate", s_))
        else:
            print(f"  tiered over the H100 row at {fast:.2f} GB/s: fast "
                  f"fraction {t['fast_fraction']}, {t['chips']} chips, "
                  f"{t['power_w'] / 1e3:.1f} kW, "
                  f"${t['usd_per_query']:.3e}/query")
    slas = np.geomspace(1e-3, 10.0, SWEEP_POINTS)
    wl = Workload(PAPER_DB, PAPER_ACCESS)
    worst = {"hard": 0.0, "soft": 0.0, "grad": 0.0, "scalar": 0.0}
    for sys_ in systems:
        on_card = torch.tensor(slas, dtype=torch.float32, device="cuda")
        got = sweep.sweep_performance(sys_, wl, on_card)
        soft = sweep.soft_performance_power(sys_, wl, on_card)
        torch.cuda.synchronize()
        if got.device.type != "cuda" or soft.device.type != "cuda":
            bad.append(("sweep left the card", sys_.name))
        host = sweep.sweep_performance(sys_, wl, slas, device="cpu")
        host_soft = sweep.soft_performance_power(sys_, wl, slas,
                                                 device="cpu")
        worst["hard"] = max(worst["hard"], float(
            ((got.cpu() - host).abs() / host.abs()).max()))
        worst["soft"] = max(worst["soft"], float(
            ((soft.cpu() - host_soft).abs() / host_soft.abs()).max()))
        for i, s_ in enumerate(slas):
            p = provision_performance(sys_, wl, float(s_)).power
            worst["scalar"] = max(worst["scalar"],
                                  abs(float(got[i]) - p) / p)
        for s_ in (0.01, 0.1):
            g = sweep.power_sensitivity(sys_, wl, s_)
            h = sweep.power_sensitivity(sys_, wl, s_, device="cpu")
            worst["grad"] = max(worst["grad"], *(
                abs(g[k] - h[k]) / max(abs(h[k]), 1e-30) for k in h))
    out["sweep"] = worst
    print(f"sweep of {SWEEP_POINTS} SLAs x {len(systems)} systems on the "
          f"card: hard vs CPU {worst['hard']:.3e} (limit {SWEEP_RTOL}), "
          f"soft vs CPU {worst['soft']:.3e} (limit {SWEEP_RTOL}), "
          f"gradients vs CPU {worst['grad']:.3e} (limit {GRAD_RTOL}), "
          f"hard vs the scalar model {worst['scalar']:.3e} (limit "
          f"{SCALAR_RTOL})")
    if not (worst["hard"] <= SWEEP_RTOL and worst["soft"] <= SWEEP_RTOL
            and worst["grad"] <= GRAD_RTOL
            and worst["scalar"] < SCALAR_RTOL):
        bad.append(("sweep outside its tolerances", worst))
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} paper model checks failed")
    return out


# --------------------------------------------------------------------------
# the LM serving slice: attention kernels 10 and 11
# --------------------------------------------------------------------------

# Kernel vs plain version on the card, compared in float32 element by
# element as |kernel - plain| <= rel * |plain| + row * rms, where rms is the
# root mean square of the plain output's row (one query head's D values):
# the scale that an error of the softmax or of the PV sums is measured in,
# where 1 + |plain| would be some 40 times that scale at the path's shapes.
# - rel: each version rounds its output once to the output's dtype; two
#   roundings on either side of a tie differ by one unit in the last place,
#   at most 2^-7 |x| in bf16 and 2^-23 |x| in fp32. The limit is two such
#   units in bf16 (2^-6) and eight in fp32 (2^-20).
# - row: what the float32 computations themselves may differ by. In fp32
#   the order of the sums: a score near 10 sums D products, each rounded
#   by 2^-24, so each weight moves by about 1e-5 relatively and in random
#   directions, and an element by about 1e-5 of its row at the largest;
#   the limit is 5e-5 of the row. In bf16 the tensor-core flash
#   path (flash_mma_kernel) rounds P to bf16 before PV, a relative 2^-9 on
#   each weight in random directions, which moves an element by about
#   2^-9 * 0.6 of its row at one standard deviation, so about 0.006 of it
#   at the largest of the 8.4M elements of the path's prefill: 2^-6 of the
#   row leaves 2.5 times that. The plain versions keep P in fp32.
# attention_controls holds known-wrong outputs to the same limit, each of
# which must fail it: a softmax scale 2% off, and a dropped tail of slots.
ATTN_TOL = {torch.float32: (2.0 ** -20, 5e-5),
            torch.bfloat16: (2.0 ** -6, 2.0 ** -6)}
DECODE_REPLACES = "src/repro/kernels/decode_attention/kernel.py:90"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:105"
FLASH_KERNELS = {"wgmma": "flash_wgmma_kernel",     # kernel 11's routes
                 "cuda_core": "flash_fwd_kernel"}
BF16_OPS = 989e12       # H100 SXM dense bf16 tensor-core rate (datasheet)


def float_err(got: torch.Tensor, want: torch.Tensor, dtype,
             tol=ATTN_TOL) -> tuple:
    """(max abs err, largest err / limit over the elements): within
    `tol` (ATTN_TOL; SSD_TOL for kernel 12) when the second is at most 1
    and every output is finite."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rel, row = tol[dtype]
    rms = w.square().mean(dim=-1, keepdim=True).sqrt()
    ratio = float((diff / (rel * w.abs() + row * rms).clamp_min(1e-30))
                  .max())
    if not bool(torch.isfinite(g).all()):
        ratio = float("inf")
    return float(diff.max()), ratio


def ring_positions(b: int, s: int, fills, wrap_to=None):
    """(B, S) int32 stored positions and (B,) query positions: row i holds
    positions 0 .. fills[i] - 1 at their slots (the rest INF_POS) and
    queries at fills[i]; with wrap_to[i], the ring holds the S positions
    ending at wrap_to[i] - 1 (wrapped) and queries at wrap_to[i]."""
    from repro_torch.models.attention import INF_POS
    kv = torch.full((b, s), INF_POS, dtype=torch.int32)
    qp = torch.zeros(b, dtype=torch.int32)
    for i in range(b):
        if wrap_to is not None and wrap_to[i] is not None:
            pos = torch.arange(wrap_to[i] - s, wrap_to[i])
            kv[i, pos % s] = pos.to(torch.int32)
            qp[i] = wrap_to[i]
        else:
            kv[i, :fills[i]] = torch.arange(fills[i], dtype=torch.int32)
            qp[i] = fills[i]
    return kv.cuda(), qp.cuda()


def decode_cases():
    """(label, b, kvh, g, s, d, dtype, fills, wrap_to, window)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dt in (f32, bf16):                    # tests/test_kernels.py:176-181
        for b, kvh, g, s, d in ((2, 2, 2, 512, 128), (1, 1, 8, 1024, 64),
                                (4, 2, 1, 2048, 128)):
            cases.append(("fill 0.75", b, kvh, g, s, d, dt,
                          [int(0.75 * s)] * b, None, 0))
    for w in (64, 512):                       # :199-216, wrapped ring
        cases.append((f"wrapped ring, window {w}", 1, 1, 2, 256, 64, f32,
                       [0], [556], w))
    cases.append(("full ring", 1, 2, 2, 1024, 128, f32, [1024], None, 0))
    for dt in (f32, bf16):
        # the path's shape: 8 slots over an 8192-slot ring, one slot empty
        # (q_pos 0 over INF_POS: every slot masked), the others filled to
        # various lengths, one wrapped past the ring
        cases.append(("serve path, ragged fills, empty slot", 8, 8, 2, 8192,
                      128, dt, [0, 1, 100, 1000, 4096, 8000, 8192, 0],
                      [None] * 7 + [9000], 0))
        cases.append(("serve path, window 512", 8, 8, 2, 8192, 128, dt,
                      [1, 512, 513, 3000, 4096, 6000, 8191, 0],
                      [None] * 7 + [12000], 512))
    for g in (1, 2, 8):                       # G, a ragged S, an all-masked
        cases.append((f"G {g}, S 1000", 3, 2, g, 1000, 128, torch.bfloat16,
                      [0, 999, 1000], None, 0))
        cases.append((f"G {g}, S 1000, window 64", 3, 2, g, 1000, 64, f32,
                      [0, 37, 1000], None, 64))
    cases.append(("all rows masked", 2, 2, 2, 300, 128, f32, [0, 0], None,
                  0))
    for d in (32, 256):
        cases.append((f"head dim {d}", 2, 2, 4, 700, d, bf16, [0, 500], None,
                      0))
    for dt in (f32, bf16):
        # the Griffin / MoE paths' shapes over their rings (8 slots): an
        # empty slot, ragged fills, rings wrapped past the window
        cases.append(("recurrentgemma path, window 2048", 8, 1, 10, 2048,
                      256, dt, [0, 1, 100, 1000, 2047, 2048, 0, 0],
                      [None] * 6 + [4160, 3001], 2048))
        cases.append(("moonshot path", 8, 16, 1, MOON_MAX_LEN, 128, dt,
                      [0, 1, 100, 1000, 4096, 4160, MOON_MAX_LEN, 0],
                      [None] * 7 + [5000], 0))
        cases.append(("mixtral path, window 4096", 8, 8, 6, 4096, 128, dt,
                      [0, 1, 100, 1000, 4095, 4096, 0, 0],
                      [None] * 6 + [4160, 6001], 4096))
    return cases


def flash_cases():
    """(label, b, kvh, g, sq, skv, d, dtype, window)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dt in (f32, bf16):                    # tests/test_kernels.py:104-109
        for b, kvh, g, sq, skv, d in ((1, 1, 1, 128, 128, 128),
                                      (2, 2, 4, 128, 256, 128),
                                      (1, 2, 1, 256, 256, 64),
                                      (2, 1, 2, 384, 384, 128)):
            cases.append(("tests", b, kvh, g, sq, skv, d, dt, 0))
    for w in (32, 128, 1024):                 # :122-133
        cases.append((f"window {w}", 1, 2, 2, 256, 256, 64, f32, w))
    for w in (0, 64, 512):                    # ragged Sq / Skv
        for g in (1, 2, 8):
            cases.append((f"ragged, G {g}, window {w}", 1, 2, g, 100, 1000,
                          128, torch.bfloat16, w))
        cases.append((f"ragged 1000, window {w}", 2, 1, 2, 1000, 1000, 64,
                      f32, w))
    for d in (32, 256):                       # bf16: the wgmma route
        cases.append((f"head dim {d}", 1, 2, 2, 200, 333, d, bf16, 0))
        cases.append((f"head dim {d}, fp32", 1, 1, 2, 130, 130, d, f32, 50))
    for dt in (f32, bf16):                    # the path's prefill shape
        cases.append(("serve path", 1, 8, 2, 4096, 4096, 128, dt, 0))
    cases.append(("serve path, window 512", 1, 8, 2, 4096, 4096, 128, bf16,
                  512))
    # the wgmma kernel's edges: ragged 128-row query and key tiles, Sq < Skv
    # by a tile's fraction, window edges inside a tile, G 1 / 4 / 8 (units
    # of two heads, or of two query tiles of one head)
    for d in (64, 128):
        cases.append((f"wgmma, Sq = Skv = 1000, D {d}", 1, 2, 2, 1000, 1000,
                      d, bf16, 0))
    cases.append(("wgmma, Sq 130 over Skv 4100", 1, 2, 2, 130, 4100, 128,
                  bf16, 0))
    for w in (100, 129):
        cases.append((f"wgmma, window {w}", 1, 2, 2, 1000, 1000, 128, bf16,
                      w))
    for g in (1, 4, 8):
        cases.append((f"wgmma, G {g}", 2, 1, g, 333, 777, 128, bf16, 0))
    # the same edges for the D 256 tile (64 keys, two stages): windows 65
    # and 100 end inside a 64-key tile; G 3 pairs units across query tiles
    cases.append(("wgmma D 256, Sq = Skv = 1000", 1, 2, 2, 1000, 1000, 256,
                  bf16, 0))
    cases.append(("wgmma D 256, Sq 130 over Skv 4100", 1, 2, 2, 130, 4100,
                  256, bf16, 0))
    for w in (65, 100):
        cases.append((f"wgmma D 256, window {w}", 1, 2, 2, 1000, 1000, 256,
                      bf16, w))
    for g in (1, 3, 10):
        cases.append((f"wgmma D 256, G {g}", 2, 1, g, 333, 777, 256, bf16,
                      0))
    for dt in (f32, bf16):
        # the Griffin / MoE paths' prefill shapes
        cases.append(("recurrentgemma path, window 2048", 1, 1, 10, 4096,
                      4096, 256, dt, 2048))
        cases.append(("moonshot path", 1, 16, 1, 4096, 4096, 128, dt, 0))
        cases.append(("mixtral path, window 4096", 1, 8, 6, 4096, 4096, 128,
                      dt, 4096))
    # ragged prompts at those shapes, the window inside the keys
    cases.append(("recurrentgemma, ragged", 1, 1, 10, 1037, 3001, 256, bf16,
                  2048))
    cases.append(("mixtral, ragged", 1, 8, 6, 777, 4500, 128, bf16, 4096))
    cases.append(("moonshot, ragged", 1, 16, 1, 1111, 1111, 128, bf16, 0))
    return cases


def decode_plane_cases():
    """Rings the split plan must read selectively: (label, b, kvh, g, s, d,
    dtype, kv_pos, q_pos, window), the planes as numpy int32."""
    from repro_torch.models.attention import INF_POS
    bf16 = torch.bfloat16
    s = SERVE_MAX_LEN
    cases = []
    # valid slots only in the ring's last tile (and a row with one there)
    kv = np.full((2, s), INF_POS, np.int32)
    kv[0, s - 5:] = np.arange(5)
    kv[1, s - 1] = 0
    cases.append(("valid slots only in the last tile", 2, 8, 2, s, 128,
                  bf16, kv, np.array([5, 0], np.int32), 0))
    # one valid slot in each of five scattered tiles; then window 3, which
    # keeps the newest two
    kv = np.full((2, s), INF_POS, np.int32)
    kv[:, [17, 1000, 4099, 6000, 8190]] = np.arange(5)
    cases.append(("one valid slot in each of five scattered tiles", 2, 8, 2,
                  s, 128, bf16, kv, np.array([5, 5], np.int32), 0))
    cases.append(("scattered slots, window 3", 2, 8, 2, s, 128, bf16, kv,
                  np.array([5, 5], np.int32), 3))
    # a window band across the ring's wrap: positions 808 .. 8999 stored
    # at slot pos % s, the band 7000 .. 8999 straddles slot 0
    pos = np.arange(9000 - s, 9000)
    kv = np.full((2, s), INF_POS, np.int32)
    kv[:, pos % s] = pos
    for dt in (torch.float32, bf16):
        cases.append(("window band across the wrap", 2, 8, 2, s, 128, dt,
                      kv, np.array([9000, 9000], np.int32), 2000))
    # each row's valid slots within one split's run of tiles, at different
    # places in the ring; the last row empty
    kv = np.full((8, s), INF_POS, np.int32)
    for i in range(7):
        a = 1000 * i + 37
        kv[i, a:a + 20] = np.arange(20)
    q = np.array([20] * 7 + [0], np.int32)
    cases.append(("each row's slots inside one split", 8, 8, 2, s, 128,
                  bf16, kv, q, 0))
    # an odd ring length: plane rows not 16-byte aligned (the scan's scalar
    # path) and a last tile of a few slots; empty, part-filled, wrapped
    s = 1001
    kv = np.full((3, s), INF_POS, np.int32)
    kv[1, :700] = np.arange(700)
    pos = np.arange(1500 - s, 1500)
    kv[2, pos % s] = pos
    for dt, window in ((bf16, 0), (torch.float32, 64)):
        cases.append((f"odd ring length 1001, window {window}", 3, 2, 2, s,
                      128, dt, kv, np.array([0, 700, 1500], np.int32),
                      window))
    return cases


def decode_copies(q, k, v, q_pos, kv_pos, window: int) -> tuple:
    """(the K/V bytes one kernel call's copies moved, counted on the card
    by the kernel; the bytes its plan copies; splits; tile slots). The
    plan: kernel.tile_plan with the library's splits and tile size, whole
    tiles (the ring's last one ragged), K and V for a batch row with a
    valid slot and V alone for one without, for every (kv head, group of
    query heads) of the row."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import kernel as dk
    counter = torch.zeros(1, dtype=torch.int64, device=q.device)
    dk.decode_attention_fwd(q, k, v, q_pos, kv_pos, window=window,
                            copied_bytes=counter)
    b, kvh, gq, d = q.shape
    s = k.shape[2]
    key = (q.get_device(), _build.FLOAT_DTYPES[q.dtype], b, kvh, gq, s, d)
    splits, tile, rows, _ = dk.plan(_build.load("decode_attention"), key)
    reads, any_ = dk.tile_plan(kv_pos, q_pos, window, tile, splits)
    starts = torch.arange(reads.shape[2], device=reads.device) * tile
    slots = (s - starts).clamp(max=tile)
    per_row = (reads.sum(dim=1) * slots).sum(dim=1) * (1 + any_.long())
    planned = int(per_row.sum()) * (rows // b) * d * q.element_size()
    return int(counter), planned, splits, tile


def attention_parity_phase() -> dict:
    """Kernels 10 and 11 (mode="cuda") against their plain versions
    (mode="torch_ref") on the card, fp32 and bf16, at the kernel tests'
    shapes and the serving path's; then the controls, which must fail."""
    phase("parity (attention kernels)")
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(SEED + 10)
    err = {"decode_attention": 0.0, "flash_attention": 0.0}
    worst = {}                      # (kernel, dtype) -> largest err / limit
    cases = {"decode_attention": 0, "flash_attention": 0}
    bad = []
    copies = {"cases": 0, "equal_to_plan": 0, "copied_bytes": 0,
              "planned_bytes": 0}

    def count_copies(label, q, k, v, q_pos, kv_pos, window):
        copied, planned, _, _ = decode_copies(q, k, v, q_pos, kv_pos,
                                              window)
        copies["cases"] += 1
        copies["equal_to_plan"] += copied == planned
        copies["copied_bytes"] += copied
        copies["planned_bytes"] += planned
        if copied != planned:
            bad.append(("decode_attention copies", label, copied, planned))

    def check(name, label, shape, dt, got, want):
        e, ratio = float_err(got, want, dt)
        err[name] = max(err[name], e)
        key = f"{name} {str(dt).split('.')[-1]}"
        worst[key] = max(worst.get(key, 0.0), ratio)
        cases[name] += 1
        if not ratio <= 1.0:
            bad.append((name, label, shape, str(dt), e, ratio))

    t0 = time.perf_counter()
    for label, b, kvh, gq, s, d, dt, fills, wrap, window in decode_cases():
        q = torch.randn((b, kvh, gq, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dt)
        kv_pos, q_pos = ring_positions(b, s, fills, wrap)
        got = dec_ops.decode_attention(q, k, v, q_pos, kv_pos,
                                       window=window, mode="cuda")
        want = dec_ops.decode_attention(q, k, v, q_pos, kv_pos,
                                        window=window, mode="torch_ref")
        check("decode_attention", label, (b, kvh, gq, s, d), dt, got, want)
        count_copies(label, q, k, v, q_pos, kv_pos, window)
    for label, b, kvh, gq, s, d, dt, kv, qp, window in decode_plane_cases():
        q = torch.randn((b, kvh, gq, d), generator=g, device="cuda").to(dt)
        k = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(dt)
        kv_pos = torch.from_numpy(kv).cuda()
        q_pos = torch.from_numpy(qp).cuda()
        got = dec_ops.decode_attention(q, k, v, q_pos, kv_pos,
                                       window=window, mode="cuda")
        want = dec_ops.decode_attention(q, k, v, q_pos, kv_pos,
                                        window=window, mode="torch_ref")
        check("decode_attention", label, (b, kvh, gq, s, d), dt, got, want)
        count_copies(label, q, k, v, q_pos, kv_pos, window)
    for label, b, kvh, gq, sq, skv, d, dt, window in flash_cases():
        q = torch.randn((b, kvh, gq, sq, d), generator=g,
                        device="cuda").to(dt)
        k = torch.randn((b, kvh, skv, d), generator=g, device="cuda").to(dt)
        v = torch.randn((b, kvh, skv, d), generator=g, device="cuda").to(dt)
        got = flash_ops.flash5(q, k, v, window, "cuda")
        want = flash_ops.flash5(q, k, v, window, "torch_ref")
        check("flash_attention", label, (b, kvh, gq, sq, skv, d), dt, got,
              want)
    torch.cuda.synchronize()
    print(f"attention parity cases {cases} max_abs_err {err}; largest "
          f"error / limit {json.dumps(worst)} (limit rel * |plain| + row * "
          f"row rms, (rel, row) {ATTN_TOL[torch.float32]} fp32, "
          f"{ATTN_TOL[torch.bfloat16]} bf16) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    print(f"decode K/V copies counted on the card by the kernel against "
          f"its plan (tiles holding a valid slot; V alone for a row with "
          f"none): {json.dumps(copies)}", flush=True)
    if bad:
        for b_ in bad:
            print("MISMATCH", b_, file=sys.stderr)
        fail(f"{len(bad)} attention parity cases out of tolerance, or "
             f"decode copies off the plan")
    controls = attention_controls(g)
    return err, {"largest_err_over_limit": worst, "controls": controls,
                 "decode_copies": copies}


def attention_graph_phase() -> dict:
    """Each attention kernel's call captured once in a torch.cuda.CUDAGraph
    on a side stream at the serving path's bf16 shapes (decode over the
    8192-slot ring, prefill of 4096), then replayed twice on the current
    stream over new inputs copied into the captured tensors (other values,
    other fills, an empty row); each replay must equal an eager call on the
    same inputs bit for bit. Beside each replay, with no synchronisation
    between them, an eager call of the same shape runs on the capture
    stream over another input set, and must equal the same call made
    alone. The decode call is captured without a call before it on that
    stream (its scratch is made under capture), the flash call after one;
    the eager decode scratches' tickets must be zero at the end."""
    phase("graph replay (attention kernels)")
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    b, kvh, gq, s, d = SERVE_SLOTS, 8, 2, SERVE_MAX_LEN, 128

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf16)

    def decode_inputs(fills, wrap):
        kv_pos, q_pos = ring_positions(b, s, fills, wrap)
        return (randn(b, kvh, gq, d), randn(b, kvh, s, d),
                randn(b, kvh, s, d), q_pos, kv_pos)

    def prefill_inputs():
        return (randn(1, kvh, gq, TF_PROMPT, d), randn(1, kvh, TF_PROMPT, d),
                randn(1, kvh, TF_PROMPT, d))

    runs = {
        "decode_attention": (
            lambda *a: dk.decode_attention_fwd(*a), False,
            [decode_inputs([4159] * b, None),
             decode_inputs([0, 1, 100, 1000, 4096, 8000, 8192, 0],
                           [None] * 7 + [9000]),
             decode_inputs([7, 0, 3000, 5000, 33, 8192, 64, 2],
                           [12000] + [None] * 7)]),
        "flash_attention": (
            lambda *a: fk.flash_attention_fwd(*a), True,
            [prefill_inputs() for _ in range(3)]),
    }
    out = {}
    for name, (fn, warm, inputs) in runs.items():
        side = torch.cuda.Stream()
        static = inputs[0]
        side.wait_stream(torch.cuda.current_stream())
        if warm:
            with torch.cuda.stream(side):
                fn(*static)
            torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = fn(*static)
        equal, beside_equal = [], []
        for i, new in enumerate(inputs[1:]):
            other = inputs[2 - i]
            for t, n in zip(static, new):
                t.copy_(n)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                beside = fn(*other)        # on the capture stream ...
            graph.replay()                 # ... while this replays
            torch.cuda.synchronize()
            eager = fn(*new)
            alone = fn(*other)
            torch.cuda.synchronize()
            equal.append(bool(torch.equal(captured, eager)))
            beside_equal.append(bool(torch.equal(beside, alone)))
        out[name] = equal
        out[f"{name} beside a replay"] = beside_equal
        del graph, captured, static, inputs, beside, eager, alone
    # every eager scratch the decode kernel was given: its tickets (the
    # last `rows` words) are back at zero
    tickets = 0
    for (_, _, key), buf in dk._SCRATCH.items():
        rows = dk._PLANS[key][2]
        tickets += int(buf[-rows:].view(torch.int32).ne(0).sum())
    out["tickets_left_set"] = tickets
    torch.cuda.empty_cache()
    print(f"graph replay equal to eager, bit for bit (two replays each, "
          f"an eager call of the same shape on the capture stream beside "
          f"each): {json.dumps(out)}", flush=True)
    if not all(x for k, v in out.items() if k != "tickets_left_set"
               for x in v) or tickets:
        fail("a graph replay, or an eager call beside one, differs from "
             "the eager call alone, or a decode ticket was left set")
    return out


def attention_controls(g) -> dict:
    """What the limit reads on outputs known to be wrong, at the serving
    path's bf16 shapes and at recurrentgemma's (D 256, G 10, window 2048;
    suffix "_d256"): the plain version with its softmax scale 2% off (q
    scaled by 1.02 in fp32) for both kernels, and in decode the plain
    version over a ring whose last 64 valid slots are dropped. Each must
    exceed the limit (err / limit > 1), or the parity check could not see
    it."""
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.models.attention import INF_POS
    bf16 = torch.bfloat16
    last = SERVE_PROMPTS[1] + SERVE_NEW - 1
    out = {}
    # (suffix, kvh, G, ring slots, D, window, the ring's fill or wrap)
    for suffix, kvh, gq, s, d, w, (fills, wrap) in (
            ("", 8, 2, SERVE_MAX_LEN, 128, 0, ([last] * SERVE_SLOTS, None)),
            ("_d256", 1, 10, 2048, 256, 2048, (None, [last] * SERVE_SLOTS))):
        b = SERVE_SLOTS
        q = torch.randn((b, kvh, gq, d), generator=g, device="cuda").to(bf16)
        k = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(bf16)
        v = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(bf16)
        kv_pos, q_pos = ring_positions(b, s, fills, wrap)
        want = dref.decode_ref(q, k, v, q_pos, kv_pos, window=w)
        out[f"decode_scale_2pct{suffix}"] = float_err(
            dref.decode_ref(q.float() * 1.02, k, v, q_pos, kv_pos,
                            window=w), want, bf16)[1]
        dropped = kv_pos.clone()
        dropped[:, torch.arange(last - 64, last, device="cuda") % s] = \
            INF_POS
        out[f"decode_drop_64{suffix}"] = float_err(
            dref.decode_ref(q, k, v, q_pos, dropped, window=w), want,
            bf16)[1]
        del q, k, v, kv_pos, dropped
        q5 = torch.randn((1, kvh, gq, TF_PROMPT, d), generator=g,
                         device="cuda").to(bf16)
        k4 = torch.randn((1, kvh, TF_PROMPT, d), generator=g,
                         device="cuda").to(bf16)
        v4 = torch.randn((1, kvh, TF_PROMPT, d), generator=g,
                         device="cuda").to(bf16)
        want = fref.attention_ref(q5, k4, v4, window=w)
        out[f"flash_scale_2pct{suffix}"] = float_err(
            fref.attention_ref(q5.float() * 1.02, k4, v4, window=w), want,
            bf16)[1]
        del q5, k4, v4, want
        torch.cuda.empty_cache()
    print(f"attention controls (err / limit, each must exceed 1): "
          f"{json.dumps(out)}", flush=True)
    caught = [n for n, r in out.items() if not r > 1.0]
    if caught:
        fail(f"the attention limit does not see the controls {caught}")
    return out


# --------------------------------------------------------------------------
# the LM serving slice: internlm2-1.8b at full width through ServeEngine
# --------------------------------------------------------------------------

SERVE_ARCH = "internlm2-1.8b"     # 24 layers, d_model 2048, 16 / 8 heads
SERVE_SLOTS, SERVE_MAX_LEN = 8, 8192
SERVE_REQUESTS, SERVE_NEW = 16, 64
SERVE_PROMPTS = (1024, 4096)      # prompt lengths, inclusive
TF_PROMPT, TF_STEPS = 4096, 16    # teacher-forced flash vs auto
# Teacher-forced logits of attn_impl="flash" against "auto" (same bf16
# weights): the paths round differently — "auto" (blockwise at 4096, naive
# in decode) casts the probabilities to bf16 and rounds each block's PV
# product to bf16, the kernels keep both in fp32 and round the output
# once — and the difference is carried through 24 residual layers. Logits
# have a standard deviation near 1 here (random weights, RMS-normed final
# state), so the bound is a quarter of that at any element and 0.05 on
# average: 16 bf16 steps at |logit| in [2, 4).
TF_MAX_ABS, TF_MEAN_ABS = 0.25, 0.05


def serve_config():
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(SERVE_ARCH), attn_impl="flash")


def serve_requests(vocab: int, multiple: int = 1) -> list:
    """SERVE_REQUESTS requests, prompt lengths and tokens drawn with numpy
    from SEED; lengths in SERVE_PROMPTS (so buckets are 2048 or 4096), and
    multiples of `multiple`."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SEED)
    lens = rng.integers(SERVE_PROMPTS[0] // multiple,
                        SERVE_PROMPTS[1] // multiple + 1,
                        SERVE_REQUESTS) * multiple
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32),
                    max_new_tokens=SERVE_NEW) for i, n in enumerate(lens)]


def drive(engine, requests, bytes_of) -> dict:
    """ServeEngine.run's loop (submit while a slot is free, then step) with
    each submit (one prefill; it ends in the host read of the first token)
    and each decode step (it ends in the host read of the tokens) timed on
    the host clock; bytes_of(q_pos) counts, after each decode step and
    outside its time, the bytes that step had to move."""
    from collections import deque
    queue, done, prefill, steps, moved = deque(requests), [], [], [], []
    t0 = time.perf_counter()
    while queue or any(s is not None for s in engine.slots):
        while queue:
            t = time.perf_counter()
            if not engine.submit(queue[0]):
                break
            prefill.append((len(queue[0].prompt),
                            (time.perf_counter() - t) * 1e3))
            queue.popleft()
        before = engine.cache_len.copy()     # the step's query positions
        t = time.perf_counter()
        done.extend(engine.step())
        if (engine.cache_len != before).any():
            steps.append((time.perf_counter() - t) * 1e3)
            moved.append(bytes_of(before))
    return {"done": done, "prefill": prefill, "steps": steps,
            "step_bytes": moved, "wall_s": time.perf_counter() - t0}


def ring_bytes(pos, q_pos, kvh: int, d: int, elt: int,
               window: int = 0) -> int:
    """Bytes decode attention must read from one layer's ring for queries
    at q_pos (B,): q_pos and the whole pos plane (B, S), then K and V of
    the slots the plane leaves valid. Once a row holds a valid slot, a
    masked slot's weight exp(-1e30 - m) is exactly 0, so its K and V are
    not needed; a row with no valid slot averages V over the whole ring,
    which needs V but not K."""
    dp = q_pos.to(pos.device)[:, None] - pos
    ok = dp >= 0
    if window:
        ok &= dp < window
    valid = ok.sum(dim=1)
    rows = int(torch.where(valid > 0, 2 * valid, pos.shape[1]).sum())
    return rows * kvh * d * elt + pos.numel() * 4 + q_pos.numel() * 4


class RouteLog:
    """While active, records the expert ids of every moe._route call (one
    a MoE layer and forward pass, in layer order), by wrapping the module's
    function; restored on exit."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._moe, self._route = moe, moe._route

        def route(params, x, cfg):
            out = self._route(params, x, cfg)
            self.calls.append(out[0])
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route

    def take(self, n: int) -> list:
        """The last n calls (a forward pass's), and forget every call."""
        out, self.calls = self.calls[len(self.calls) - n:], []
        return out


def lm_step_counter(model, engine, cfg, routes=None):
    """bytes_of(q_pos) for drive: the bytes one decode step of a token LM
    had to move. Every weight but the embedding table and the experts
    (tied head: the whole table, which also serves the slots' token rows;
    untied: one row a slot); in each MoE layer the experts that the step's
    routing chose over all slots (`routes`, a RouteLog), their three
    matrices; in each attention layer its ring as ring_bytes counts it
    (the layers of one kind write the same positions, so the first one's
    pos plane stands for its kind) and the new token's K, V and position
    written; in each recurrent layer its state read and written.
    Activations are not counted. Also returns the per-step record list of
    the experts chosen a MoE layer."""
    from repro_torch.models.common import dtype_of
    elt = torch.empty((), dtype=dtype_of(cfg.dtype)).element_size()
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    kinds = [cfg.pattern_at(i) for i in range(cfg.num_layers)]
    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters()
                  if ".moe.w_" not in n
                  and (n != "embed" or cfg.tie_embeddings))
    if not cfg.tie_embeddings:
        weights += engine.B * cfg.d_model * elt
    states = sum(2 * t.numel() * t.element_size()
                 for k, c in zip(kinds, engine.caches)
                 if k not in ("attn", "swa") for t in c.values())
    writes = engine.B * (2 * kvh * hd * elt + 4)
    expert = 3 * cfg.d_model * cfg.d_ff * elt
    moe_layers = cfg.num_layers if cfg.num_experts else 0
    chosen = []

    def bytes_of(q_pos) -> int:
        total = weights + states
        for kind in ("attn", "swa"):
            if kind in kinds:
                window = cfg.window if kind == "swa" else 0
                ring = ring_bytes(engine.caches[kinds.index(kind)]["pos"],
                                  torch.from_numpy(q_pos), kvh, hd, elt,
                                  window)
                total += kinds.count(kind) * (ring + writes)
        if moe_layers:
            n = [int(torch.unique(i).numel()) for i in routes.take(
                moe_layers)]
            chosen.append(float(np.mean(n)))
            total += sum(n) * expert
        return total
    return bytes_of, weights, states, chosen


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def report_serve(label: str, got: dict, vocab: int, dev: dict,
                 what: str = "weights + valid ring slots",
                 bucketed: bool = True) -> dict:
    done = got["done"]
    if sorted(r.rid for r in done) != list(range(SERVE_REQUESTS)):
        fail(f"serve {label}: finished {sorted(r.rid for r in done)}")
    for r in done:
        if len(r.generated) != SERVE_NEW or not all(
                0 <= t < vocab for t in r.generated):
            fail(f"serve {label}: request {r.rid} generated "
                 f"{len(r.generated)} tokens, range "
                 f"[{min(r.generated)}, {max(r.generated)}]")
    steps, pre, moved = got["steps"], got["prefill"], got["step_bytes"]
    tokens = sum(len(r.generated) for r in done)
    rec = {"requests": len(done), "tokens": tokens,
           "wall_s": got["wall_s"], "tokens_per_s": tokens / got["wall_s"],
           "prefill_ms": {"n": len(pre),
                          "mean": float(np.mean([p[1] for p in pre])),
                          "by_len": [[n, ms] for n, ms in pre]},
           "decode_steps": len(steps),
           "step_ms": {"p50": pct(steps, 50), "p95": pct(steps, 95),
                       "p99": pct(steps, 99), "mean": float(np.mean(steps))},
           "step_bytes": {"mean": float(np.mean(moved)), "min": min(moved),
                          "max": max(moved)},
           # bytes over time across all steps, and the mean step's bytes
           # over the median step's time; the bound is those bytes at
           # MEM_BPS
           "step_gbps": sum(moved) / sum(steps) / 1e6,
           "step_gbps_p50": float(np.mean(moved)) / pct(steps, 50) / 1e6,
           "step_bound_ms_mean": float(np.mean(moved)) / MEM_BPS * 1e3}
    print(f"serve {label}: {len(done)} requests, {tokens} tokens in "
          f"{got['wall_s']:.3f} s ({rec['tokens_per_s']:.1f} tokens/s); "
          f"{len(pre)} prefills, mean {rec['prefill_ms']['mean']:.2f} ms; "
          f"{len(steps)} decode steps p50 {rec['step_ms']['p50']:.3f} ms "
          f"p95 {rec['step_ms']['p95']:.3f} p99 {rec['step_ms']['p99']:.3f}; "
          f"{what} {rec['step_bytes']['mean'] / 1e9:.4f} "
          f"GB a step on average ({min(moved) / 1e9:.4f}.."
          f"{max(moved) / 1e9:.4f}; bound "
          f"{rec['step_bound_ms_mean']:.4f} ms): {rec['step_gbps']:.1f} GB/s "
          f"over all steps, {rec['step_gbps_p50']:.1f} GB/s at p50  "
          f"[{dev['smi']}]", flush=True)
    for n, ms in pre:
        bucket = (min(1 << (n - 1).bit_length(), SERVE_MAX_LEN) if bucketed
                  else "none")
        print(f"  prefill {n:5d} tokens (bucket {bucket}) {ms:9.3f} ms")
    return rec


def serve_phase(dev: dict) -> tuple:
    """internlm2-1.8b at its published widths and depth, bf16, random
    weights from a seeded generator on the card, attn_impl="flash":
    SERVE_REQUESTS requests through ServeEngine, then the same prompts
    through SLAScheduler at the decode rate the first run measured. The
    kernels' launch counters are read over both runs."""
    phase("serve")
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import SLAScheduler
    cfg = serve_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv, head_dim "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}; {n_params} parameters "
          f"(analytic {cfg.param_count()}) drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if n_params != cfg.param_count():
        fail("parameter count differs from the config's analytic count")
    engine = ServeEngine(cfg, model, batch_slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, seed=SEED)
    bytes_of = lm_step_counter(model, engine, cfg)[0]
    dk.LAUNCHES = fk.LAUNCHES = 0
    first = drive(engine, serve_requests(cfg.vocab_size), bytes_of)
    torch.cuda.synchronize()
    rec = {"engine": report_serve("engine", first, cfg.vocab_size, dev)}
    rate = 1e3 / rec["engine"]["step_ms"]["p50"]   # tokens/s a slot
    clock = time.monotonic
    sched = SLAScheduler(engine, decode_rate_tps=rate, clock=clock)
    reqs = serve_requests(cfg.vocab_size)
    t0 = clock()
    for i, r in enumerate(reqs):
        # EDF over staggered deadlines, each loose enough to be admitted
        sched.submit(r, deadline=t0 + 120.0 + i)
    t1 = time.perf_counter()
    reports = sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {"decode_attention": dk.LAUNCHES,
                "flash_attention": fk.LAUNCHES}
    summary = sched.summary()
    print(f"serve scheduler: decode_rate_tps {rate:.2f} (1 / p50 step), "
          f"{len(reports)} reports in {wall:.3f} s; summary "
          f"{json.dumps(summary)}", flush=True)
    same = sum(a.generated == b.generated for a, b in zip(
        sorted(first["done"], key=lambda r: r.rid),
        sorted(reqs, key=lambda r: r.rid)))
    print(f"serve scheduler: {same} of {SERVE_REQUESTS} requests generated "
          f"the same tokens as the engine run (another slot order)")
    if summary["served"] != SERVE_REQUESTS or summary["rejected"]:
        fail(f"scheduler served {summary['served']}, rejected "
             f"{summary['rejected']}")
    rec["scheduler"] = {"summary": summary, "wall_s": wall,
                        "decode_rate_tps": rate, "same_tokens": same}
    peak = torch.cuda.max_memory_allocated()
    rec["peak_gib"] = peak / 2**30
    rec["launches"] = launches
    print(f"kernel launches on the serve path (engine + scheduler): "
          f"{launches}; peak device memory {peak / 2**30:.3f} GiB",
          flush=True)
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        fail(f"kernels never launched on the serve path: {zero}")
    rec["profile"] = serve_profile(engine, cfg)
    return model, engine, rec


SERVE_KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel",
                 "decode_attention_kernel")
# the serve and serve mamba2 phases' profiled window (prompts of 2048
# tokens, new tokens each; at 4 x 16 the profiler's processing of ~250k
# host operator calls took ~45 s of host a window on the H100)
SERVE_PROFILE = (2, 8)


def serve_profile(engine, cfg, kernels=SERVE_KERNELS,
                  what: str = "attention kernels", n: int = SERVE_PROFILE[0],
                  new: int = SERVE_PROFILE[1]) -> dict:
    """n requests (prompts of 2048 tokens, `new` new tokens each) through
    the warm engine under torch.profiler: the device's busy share and the
    device time by kernel name (`kernels`: the port's, by name)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(SEED + 1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 2048)
                    .astype(np.int32), max_new_tokens=new) for i in range(n)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run(reqs)
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    ours_us = sum(r[0] for r in rows
                  if any(k in r[2] for k in kernels))
    print(f"profiled serve ({n} prompts of 2048, {new} new tokens each): "
          f"wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, "
          f"busy share {busy_us / wall_us:.4f}; {what} "
          f"{ours_us / 1e3:.3f} ms, other device work "
          f"{(busy_us - ours_us) / 1e3:.3f} ms")
    for us, count, key in sorted(rows, reverse=True)[:12]:
        print(f"  device {us / 1e3:10.3f} ms  x{count:5d}  {key[:100]}")
    # where the host's time goes: operators by their own (self) CPU time
    host = sorted(((e.self_cpu_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), reverse=True)
    host_us = sum(h[0] for h in host)
    print(f"host operators: {host_us / 1e3:.3f} ms of self CPU time in "
          f"{sum(h[1] for h in host)} calls")
    for us, count, key in host[:12]:
        print(f"  host   {us / 1e3:10.3f} ms  x{count:5d}  {key[:100]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy_us / 1e3,
            "busy_share": busy_us / wall_us, "kernels_ms": ours_us / 1e3,
            "host_ms": host_us / 1e3}


def tf_parity(model, cfg, max_len: int, label: str, seed: int) -> dict:
    """Teacher-forced: one prefill of TF_PROMPT tokens and TF_STEPS decode
    steps on one token stream under attn_impl="flash" (the kernels) and
    "auto" (blockwise prefill, naive decode: plain torch), same weights;
    the logits within TF_MAX_ABS / TF_MEAN_ABS and greedy tokens equal
    where "auto"'s top-2 margin exceeds TF_MAX_ABS. With MoE blocks each
    layer's expert ids are recorded in both runs: a bf16 rounding can flip
    a top-k choice and move that token's logits, so a position is excused
    from the bounds when its token routed otherwise in some layer and its
    logits are outside TF_MAX_ABS. Every position whose routing agrees is
    held, and excusing more than a quarter of the positions fails."""
    phase(label)
    from repro_torch.models import lm
    rng = np.random.default_rng(seed)
    stream = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, TF_PROMPT + TF_STEPS).astype(np.int32)).cuda()
    n_moe = cfg.num_layers if cfg.num_experts else 0
    out, ids = {}, {}
    with torch.no_grad(), RouteLog() as routes:
        for impl in ("flash", "auto"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            caches = lm.init_caches(c, 1, max_len)
            hidden, caches, _ = lm.prefill(model, c, stream[None, :TF_PROMPT],
                                           caches, return_hidden=True)
            logits = [lm.head_logits(model, c, hidden[:, -1:])[:, 0].float()]
            steps = [routes.take(n_moe)] if n_moe else []
            for t in range(TF_PROMPT, TF_PROMPT + TF_STEPS):
                lg, caches, _ = lm.decode_step(
                    model, c, stream[None, t:t + 1],
                    torch.tensor([t], device="cuda"), caches)
                logits.append(lg[:, 0].float())
                if n_moe:
                    steps.append(routes.take(n_moe))
            out[impl] = torch.cat(logits)             # (1 + steps, vocab)
            if n_moe:
                # (layers, tokens, k): the prefill's tokens, then each step's
                ids[impl] = torch.stack([torch.cat(
                    [steps[0][i][0]] + [s[i][0] for s in steps[1:]])
                    for i in range(n_moe)])
            del caches, hidden
    torch.cuda.empty_cache()
    pos = out["flash"].shape[0]
    if n_moe:
        # a token's routing agrees when every layer chose the same experts
        # (in any order: the combine adds them in ascending id)
        same = (ids["flash"].sort(dim=2).values
                == ids["auto"].sort(dim=2).values).all(dim=2).all(dim=0)
        prefill_flips = int((~same[:TF_PROMPT]).sum())
        agree = same[TF_PROMPT - 1:]                  # the logits' tokens
    else:
        prefill_flips = 0
        agree = torch.ones(pos, dtype=torch.bool, device="cuda")
    d = (out["flash"] - out["auto"]).abs()
    excused = ~agree & (d.amax(dim=-1) > TF_MAX_ABS)
    held = ~excused
    top2 = out["auto"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TF_MAX_ABS
    argmax_eq = out["flash"].argmax(-1) == out["auto"].argmax(-1)
    rec = {"max_abs": float(d[held].max()), "mean_abs": float(d[held].mean()),
           "max_abs_all": float(d.max()), "mean_abs_all": float(d.mean()),
           "max_abs_routing_agrees": (float(d[agree].max())
                                      if bool(agree.any()) else None),
           "logit_std": float(out["auto"].std()), "positions": pos,
           "routing_differs": int((~agree).sum()),
           "excused": int(excused.sum()),
           "prefill_tokens_routing_differs": prefill_flips,
           "clear": int((clear & held).sum()),
           "argmax_equal": int(argmax_eq.sum()),
           "finite": bool(torch.isfinite(out["flash"]).all())}
    print(f"teacher-forced {TF_PROMPT} + {TF_STEPS}: routing differs at "
          f"{rec['routing_differs']} of {pos} positions (and at "
          f"{prefill_flips} of the {TF_PROMPT} prefill tokens), "
          f"{rec['excused']} of them outside TF_MAX_ABS and excused; held "
          f"at {int(held.sum())}: |flash - auto| max {rec['max_abs']:.5f} "
          f"(tol {TF_MAX_ABS}), mean {rec['mean_abs']:.5f} (tol "
          f"{TF_MEAN_ABS}); where routing agrees max "
          f"{rec['max_abs_routing_agrees']}; over all positions max "
          f"{rec['max_abs_all']:.5f}, mean {rec['mean_abs_all']:.5f}; logit "
          f"std {rec['logit_std']:.4f}; argmax equal at "
          f"{rec['argmax_equal']} of {pos}, {rec['clear']} held with a "
          f"top-2 margin above the tolerance", flush=True)
    if 4 * rec["excused"] > pos:
        fail(f"{label}: more than a quarter of the positions routed "
             f"otherwise and left the bound")
    if not rec["finite"] or rec["max_abs"] > TF_MAX_ABS or \
            rec["mean_abs"] > TF_MEAN_ABS or \
            not bool(argmax_eq[clear & held].all()):
        fail(f"{label}: teacher-forced flash logits differ from the auto "
             f"path's")
    return rec


def attention_times(dev: dict, launches: dict, parity_err: dict) -> list:
    """Kernels 10 and 11 at the serving path's shapes, bf16: decode q
    (8, 8, 2, 128) over an (8, 8, 8192, 128) ring filled as after the serve
    run's longest request (4096 + 63 slots; the rest INF_POS) and one
    causal 4096-token prefill (1, 8, 2, 4096, 128). The bound counts each
    input that the function needs read once (for decode, K and V of the
    valid slots only, as ring_bytes counts them) and the output written
    once, and the flops these inputs need (4 * D a (query, reachable key)
    pair) at the bf16 rate; the
    library yardstick is one scaled_dot_product_attention call (an explicit
    boolean mask for decode, is_causal for prefill)."""
    phase("attention times")
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    b, kvh, gq, s, d = 8, 8, 2, SERVE_MAX_LEN, 128
    q = torch.randn((b, kvh, gq, d), generator=g, device="cuda").to(bf16)
    k = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(bf16)
    v = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(bf16)
    fill = SERVE_PROMPTS[1] + SERVE_NEW - 1
    kv_pos, q_pos = ring_positions(b, s, [fill] * b)
    mask = ((q_pos[:, None] - kv_pos) >= 0)[:, None, None, :]
    valid = int(mask.sum())
    out = []
    dec = time_float_kernel(
        "decode_attention",
        lambda: dk.decode_attention_fwd(q, k, v, q_pos, kv_pos),
        lambda: dref.decode_ref(q, k, v, q_pos, kv_pos),
        lambda: F.scaled_dot_product_attention(
            q.reshape(b, kvh * gq, 1, d), k, v, attn_mask=mask,
            enable_gqa=True),
        nbytes=ring_bytes(kv_pos, q_pos, kvh, d, 2) + 2 * q.numel() * 2,
        flops=4 * d * gq * kvh * valid, dtype=bf16, dev=dev)
    # the K/V bytes one call copies, counted on the card by the kernel
    copied, planned, splits, tile = decode_copies(q, k, v, q_pos, kv_pos, 0)
    print(f"decode_attention: {splits} splits of tiles of {tile} slots; "
          f"one call's K/V copies moved {copied} bytes, counted on the card "
          f"(its plan: {planned}; the bound counts {dec['bytes']} bytes in "
          f"all, K/V of the valid slots and the position planes)",
          flush=True)
    if copied != planned:
        fail(f"decode_attention copied {copied} K/V bytes, its plan "
             f"{planned}")
    dec.update({"shape": [b, kvh, gq, s, d], "filled_slots": fill,
                "copied_bytes": copied,
                "source": "src/repro_torch/csrc/decode_attention.cu",
                "replaces": DECODE_REPLACES})
    out.append(dec)
    del q, k, v, kv_pos, q_pos, mask
    sq = TF_PROMPT
    q5 = torch.randn((1, kvh, gq, sq, d), generator=g,
                     device="cuda").to(bf16)
    k4 = torch.randn((1, kvh, sq, d), generator=g, device="cuda").to(bf16)
    v4 = torch.randn((1, kvh, sq, d), generator=g, device="cuda").to(bf16)
    pairs = kvh * gq * sq * (sq + 1) // 2
    fl = time_float_kernel(
        "flash_attention",
        lambda: fk.flash_attention_fwd(q5, k4, v4),
        lambda: fref.attention_ref(q5, k4, v4),
        lambda: F.scaled_dot_product_attention(
            q5.reshape(1, kvh * gq, sq, d), k4, v4, is_causal=True,
            enable_gqa=True),
        nbytes=2 * q5.numel() * 2 + 2 * k4.numel() * 2,
        flops=4 * d * pairs, dtype=bf16, dev=dev)
    fl.update({"shape": [1, kvh, gq, sq, sq, d],
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": FLASH_REPLACES})
    out.append(fl)
    del q5, k4, v4
    torch.cuda.empty_cache()
    for rec in out:
        rec["launches"] = launches[rec["name"]]
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 parity_err[rec["name"]])
    return out


def time_float_kernel(name, kern, plain, library, *, nbytes: int,
                      flops: int, dtype, dev: dict, rate: float = BF16_OPS,
                      tol=ATTN_TOL) -> dict:
    """Check a float kernel against its plain version once (`tol`), then
    time it (one call; back to back), the plain version and the library
    call (one call; back to back; None: PyTorch has no call for the
    function), as time_kernel does; the bound counts `flops` at `rate`."""
    e, ratio = float_err(kern(), plain(), dtype, tol)
    if not ratio <= 1.0:
        fail(f"{name} differs from its plain version at the path's shape "
             f"(max abs err {e}, {ratio} of the limit)")
    ms = time_ms(kern)
    b2b_ms = time_ms(kern, KERNEL_REPS)
    plain_ms = time_ms(plain)
    lib_ms = time_ms(library) if library is not None else None
    lib_b2b = (time_ms(library, KERNEL_REPS) if library is not None
               else None)
    bytes_ms = nbytes / MEM_BPS * 1e3
    ops_ms = flops / rate * 1e3
    rec = {"name": name, "route": "cuda", "launches": 0, "max_abs_err": e,
           "ms": ms, "ms_back_to_back": b2b_ms, "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": lib_ms, "library_ms_back_to_back": lib_b2b,
           "bytes": nbytes, "ops": flops}
    lib = (f"{lib_ms:.4f} ms ({lib_b2b:.4f} ms back to back)"
           if lib_ms is not None else "none")
    print(f"{name:26s} kernel {ms:.4f} ms one call ({b2b_ms:.4f} ms back "
          f"to back)  plain {plain_ms:.4f} ms  library {lib}  "
          f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)  "
          f"{rec['bound_ms'] / b2b_ms:.3f} of the bound back to back  "
          f"[{dev['smi']}]", flush=True)
    return rec

# --------------------------------------------------------------------------
# the Mamba-2 serving slice: kernel 12 (SSD chunk scan)
# --------------------------------------------------------------------------

# Kernel 12 vs its plain version on the card, in float32 element by element
# as float_err measures: |kernel - plain| <= rel * |plain| + row * rms, rms
# the plain output's row (one (step, head)'s P values; for the final state
# one (head, state) row of P).
# - rel: each version rounds y once to x's dtype, as in ATTN_TOL: two
#   units in the last place in bf16 (2^-6), eight in fp32 (2^-20).
# - row: what the float32 computations may differ by. A weight is
#   exp(cum_i - cum_j), cum a running sum of up to 256 log-decays dt * A
#   (|A| up to 16 at the path's heads), so |cum| reaches a few thousand
#   and one ulp of it is up to 2.4e-4; the kernel sums the chunk in
#   another order (8 steps a lane, then a warp scan) than torch.cumsum, so
#   the exponents differ by a few such ulps and a weight by up to ~1e-3
#   relatively, in random directions over the row. 2^-8 of the row leaves
#   about 4 times that.
# ssd_controls holds known-wrong outputs to the same limit, each of which
# must fail it: the decay rate A 2% off (a_log + ln 1.02), and the state
# carried into one chunk boundary dropped.
SSD_TOL = {torch.float32: (2.0 ** -20, 2.0 ** -8),
           torch.bfloat16: (2.0 ** -6, 2.0 ** -8)}
SSD_REPLACES = "src/repro/kernels/ssd_chunk/kernel.py:81"
SSD_ARCH = "mamba2-1.3b"         # 48 SSD layers, d_model 2048, 64 heads
# (B, S, H, P, N, Q) of one prefill row of 4096 tokens at mamba2-1.3b's
# widths: what every layer of the serve phase's longest prefill hands the
# kernel
SSD_PATH = (1, 4096, 64, 64, 128, 256)
# An SSD stack prefills the raw prompt (no buckets: a recurrent state
# would carry the pad tokens), and the chunked scan takes a prompt longer
# than a chunk only as a whole number of chunks (src/repro/models/ssm.py:71
# asserts it; the port matches). The serve phase therefore draws its
# prompt lengths in SERVE_PROMPTS as multiples of the 256-step chunk.
SSD_PROMPT_MULTIPLE = 256
# kernel 12's kernels by name: the tensor-core route's one, then the CUDA-
# core route's four
SSD_KERNELS = ("ssd_wgmma_kernel", "ssd_cb_kernel", "ssd_state_kernel",
               "ssd_pass_kernel", "ssd_scan_kernel")


def ssd_inputs(g, b: int, s: int, h: int, p: int, n: int, dtype,
               init: bool) -> tuple:
    """(x, dt, a_log, b, c), h_in on the card: x and B / C in `dtype`
    (B / C scaled by N^-1/2 as tests/test_kernels_ssd.py scales them), dt
    = softplus(normal), a_log the model's init log(linspace(1, 16, H)),
    h_in normal or None."""
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device="cuda"))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    bm = (torch.randn((b, s, n), generator=g, device="cuda")
          / n ** 0.5).to(dtype)
    cm = (torch.randn((b, s, n), generator=g, device="cuda")
          / n ** 0.5).to(dtype)
    h_in = (torch.randn((b, h, n, p), generator=g, device="cuda")
            if init else None)
    return (x, dt, a_log, bm, cm), h_in


def ssd_cases():
    """(label, b, s, h, p, n, q, dtype, init)."""
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for dt in (f32, bf16):                    # tests/test_kernels_ssd.py:22
        for b, s, h, p, n, q in ((1, 64, 2, 64, 32, 32),
                                 (2, 128, 4, 64, 128, 64),
                                 (1, 256, 2, 128, 64, 128)):
            cases.append(("tests", b, s, h, p, n, q, dt, False))
    cases.append(("serve path", *SSD_PATH, bf16, False))
    cases.append(("serve path, fp32, inbound state", *SSD_PATH, f32, True))
    cases.append(("ragged: a 100-token prompt, one chunk", 1, 100, 64, 64,
                  128, 100, bf16, True))
    cases.append(("ragged: three chunks of 100, inbound state", 2, 300, 4,
                  32, 16, 100, f32, True))
    cases.append(("reduced mamba2 (P 16, N 16, Q 32)", 2, 128, 8, 16, 16,
                  32, f32, True))
    cases.append(("registry example (N 8)", 2, 64, 2, 16, 8, 16, f32,
                  False))
    cases.append(("P 128, N 128, Q 256, inbound state", 1, 512, 2, 128, 128,
                  256, bf16, True))
    cases.append(("P 48, a one-step chunk", 1, 16, 3, 48, 64, 1, f32, True))
    cases.append(("P 100, N 7, Q 45", 1, 90, 2, 100, 7, 45, f32, True))
    cases.append(("Q 255", 1, 510, 2, 64, 128, 255, bf16, False))
    # a short prompt's one chunk at the path's widths, tensor-core route
    cases.append(("path widths, Q 64: one chunk", 1, 64, 64, 64, 128, 64,
                  bf16, False))
    cases.append(("path widths, Q 192: one chunk, inbound state", 1, 192,
                  64, 64, 128, 192, bf16, True))
    # the launchers' shapes: a train step's 1 x 2048 and the serve
    # launcher's prompts of 4 to 16 tokens, each one chunk
    cases.append(("train launcher: 1 x 2048, Q 256", 1, 2048, 64, 64, 128,
                  256, bf16, False))
    # the train remat phase's 4 x 4096 mamba2 batch
    cases.append(("train remat: 4 x 4096, Q 256", 4, 4096, 64, 64, 128, 256,
                  bf16, False))
    for q in (4, 11, 16):
        cases.append((f"serve launcher: a {q}-token prompt, one chunk", 1,
                      q, 64, 64, 128, q, bf16, False))
    return cases


def ssd_parity_phase() -> tuple:
    """Kernel 12 (mode="cuda") against its plain version (mode="torch_ref")
    on the card, fp32 and bf16, y and the final state, at the kernel
    tests' shapes, the serving path's, ragged chunks and inbound states;
    then the controls, which must fail."""
    phase("parity (ssd kernel)")
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    err, worst, bad, n_cases = 0.0, {}, [], 0
    routes = {}
    t0 = time.perf_counter()
    for label, b, s, h, p, n, q, dt, init in ssd_cases():
        way = sk.route(dt, p, n)
        routes[way] = routes.get(way, 0) + 1
        args, h_in = ssd_inputs(g, b, s, h, p, n, dt, init)
        got = ssd_ops.ssd(*args, q, init_state=h_in, mode="cuda")
        want = ssd_ops.ssd(*args, q, init_state=h_in, mode="torch_ref")
        for what, gt, wt, d in (("y", got[0], want[0], dt),
                                ("state", got[1], want[1], torch.float32)):
            e, ratio = float_err(gt, wt, d, SSD_TOL)
            err = max(err, e)
            key = f"{what} {str(dt).split('.')[-1]}"
            worst[key] = max(worst.get(key, 0.0), ratio)
            if not ratio <= 1.0:
                bad.append((label, way, what, (b, s, h, p, n, q), str(dt),
                            e, ratio))
        n_cases += 1
        del args, h_in, got, want
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"ssd parity cases {n_cases} (routes {json.dumps(routes)}) "
          f"max_abs_err {err}; largest error / "
          f"limit {json.dumps(worst)} (limit rel * |plain| + row * row "
          f"rms, (rel, row) {SSD_TOL[torch.float32]} fp32, "
          f"{SSD_TOL[torch.bfloat16]} bf16) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if bad:
        for b_ in bad:
            print("MISMATCH", b_, file=sys.stderr)
        fail(f"{len(bad)} ssd parity cases out of tolerance")
    controls = ssd_controls(g)
    return {"ssd_chunk": err}, {"cases": n_cases, "routes": routes,
                                "largest_err_over_limit": worst,
                                "controls": controls}


def ssd_controls(g) -> dict:
    """What the limit reads on outputs known to be wrong, at the path's
    bf16 shape: the plain version with the decay rate A 2% off, and with
    the state carried into the middle chunk boundary dropped (the two
    halves scanned apart). Each must exceed the limit."""
    import math

    from repro_torch.kernels.ssd_chunk import ref
    bf16 = torch.bfloat16
    b, s, h, p, n, q = SSD_PATH
    (x, dt, a_log, bm, cm), _ = ssd_inputs(g, b, s, h, p, n, bf16, False)
    want, _ = ref.ssd_chunked_ref(x, dt, a_log, bm, cm, q)
    out = {"a_2pct": float_err(ref.ssd_chunked_ref(
        x, dt, a_log + math.log(1.02), bm, cm, q)[0], want, bf16,
        SSD_TOL)[1]}
    k = s // q // 2 * q
    halves = [ref.ssd_chunked_ref(x[:, sl], dt[:, sl], a_log, bm[:, sl],
                                  cm[:, sl], q)[0]
              for sl in (slice(0, k), slice(k, s))]
    out["state_dropped_at_one_boundary"] = float_err(
        torch.cat(halves, dim=1), want, bf16, SSD_TOL)[1]
    del x, dt, bm, cm, want, halves
    torch.cuda.empty_cache()
    print(f"ssd controls (err / limit, each must exceed 1): "
          f"{json.dumps(out)}", flush=True)
    caught = [c for c, r in out.items() if not r > 1.0]
    if caught:
        fail(f"the ssd limit does not see the controls {caught}")
    return out


def ssd_config():
    from repro_torch.configs import get_config
    return get_config(SSD_ARCH)


def ssd_serve_phase(dev: dict) -> tuple:
    """mamba2-1.3b at its published widths and depth, bf16, random weights
    from a seeded generator on the card: SERVE_REQUESTS requests (prompts
    of 1024..4096 tokens in multiples of 256, SERVE_NEW new tokens each)
    through ServeEngine(SERVE_SLOTS slots). Every prefill layer runs
    kernel 12: its LAUNCHES must equal 48 x the prefills."""
    phase("serve mamba2")
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = ssd_config()
    way = sk.route(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state)
    if cfg.dtype != "bfloat16" or way != "wgmma":
        fail(f"{cfg.name} ({cfg.dtype}, P {cfg.ssm_head_dim}, N "
             f"{cfg.ssm_state}) would take kernel 12's {way} route, not "
             f"the tensor-core route")
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers {cfg.block_pattern}, "
          f"d_model {cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} "
          f"SSM heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, conv {cfg.ssm_conv}, vocab {cfg.vocab_size}, "
          f"tied {cfg.tie_embeddings}, {cfg.dtype}; {n_params} parameters "
          f"(analytic {cfg.param_count()}) drawn in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if n_params != cfg.param_count():
        fail("parameter count differs from the config's analytic count")
    engine = ServeEngine(cfg, model, batch_slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, seed=SEED)
    bytes_of, weights, states, _ = lm_step_counter(model, engine, cfg)
    print(f"a decode step must move {weights / 1e9:.4f} GB of weights and "
          f"{states / 1e9:.4f} GB of SSM and conv states (read and written, "
          f"{SERVE_SLOTS} slots)", flush=True)
    requests = serve_requests(cfg.vocab_size, SSD_PROMPT_MULTIPLE)
    sk.LAUNCHES = 0
    got = drive(engine, requests, bytes_of)
    torch.cuda.synchronize()
    launches = sk.LAUNCHES
    rec = {"engine": report_serve("mamba2", got, cfg.vocab_size, dev,
                                  what="weights + SSM and conv states",
                                  bucketed=False)}
    rec["weights_bytes"], rec["state_bytes"] = weights, states
    n_prefill = len(got["prefill"])
    peak = torch.cuda.max_memory_allocated()
    rec["peak_gib"] = peak / 2**30
    rec["allocated_before_gib"] = before / 2**30
    rec["launches"] = {"ssd_chunk": launches}
    print(f"kernel 12 launches on the serve path: {launches} for "
          f"{n_prefill} prefills x {cfg.num_layers} layers; peak device "
          f"memory {peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB held "
          f"before the phase)", flush=True)
    if launches == 0 or launches != cfg.num_layers * n_prefill:
        fail(f"ssd_chunk launched {launches} times on the serve path, not "
             f"{cfg.num_layers} x {n_prefill} prefills")
    rec["profile"] = serve_profile(engine, cfg, SSD_KERNELS, "kernel 12")
    return model, rec


# Teacher-forced logits of the mamba2 serve path against the plain scan
# cannot be held to TF_MAX_ABS: with random bf16 weights the 48-layer stack
# carries any float32 rounding of the scan, ~3e-4 of a layer's output,
# into bf16 rounding flips of the residual stream that grow layer by layer
# to logit differences near 1 (measured on the card: the plain scan with
# its log-decays summed in float64 instead of float32 moves the logits as
# far as the kernel does). The bound is therefore the same function's own
# spread, measured in the same run: the plain scan at chunk 128 instead of
# 256, which sums every exponent and state in another order. The kernel
# may differ from the plain scan by at most SSD_FLOOR_X times that, layer
# by layer (each block's output on the plain path's own input, relative
# Frobenius norm) and in the end-to-end logits (max and mean), and its
# greedy tokens must equal the plain scan's where the top-2 margin exceeds
# SSD_FLOOR_X times the spread's largest logit difference.
SSD_FLOOR_X = 2.0
SSD_FLOOR_CHUNK = 128


def ssd_prefill_with(model, cfg, tokens, caches, mode, probe=None):
    """lm.prefill's hidden state for an all-SSD stack, the scan dispatched
    by `mode` (ssm.apply's mode=): embedding, each block's norm -> mixer
    -> residual, final norm. With `probe` (a list of (cfg, mode)), every
    block also runs each probe on the same normed input, and the relative
    Frobenius difference of each probe's output from this path's is
    recorded. Returns (hidden, new caches, [per-layer differences])."""
    from repro_torch.models import ssm
    from repro_torch.models.common import rms_norm
    x = model.embed[tokens.long()]
    new, diffs = [], []
    for blk, c in zip(model.blocks, caches):
        h = rms_norm(x, blk.norm1, cfg.norm_eps)
        out, state = ssm.apply(blk.mixer, h, cfg, c, mode=mode)
        if probe:
            want = out.float()
            diffs.append([float((ssm.apply(blk.mixer, h, pc, c, mode=pm)[0]
                                 .float() - want).norm() / want.norm())
                          for pc, pm in probe])
        x = x + out
        new.append(state)
    return rms_norm(x, model.final_norm, cfg.norm_eps), new, diffs


def ssd_serve_parity_phase(model) -> dict:
    """Teacher-forced: one prefill of TF_PROMPT tokens and TF_STEPS decode
    steps on one token stream, the prefill through lm.prefill (kernel 12
    in every layer), through the same stack with the scan's plain version
    (mode="torch_ref"), and through the plain version at chunk
    SSD_FLOOR_CHUNK (the spread); the decode steps (plain tensor work in
    all three) continue from each prefill's states. Layer by layer, on the
    plain path's input, the kernel's and the spread's block outputs
    against the plain one's. Bounds: SSD_FLOOR_X times the spread."""
    phase("serve mamba2 parity")
    import dataclasses

    from repro_torch.models import lm
    cfg = ssd_config()
    floor_cfg = dataclasses.replace(cfg, ssm_chunk=SSD_FLOOR_CHUNK)
    rng = np.random.default_rng(SEED + 3)
    stream = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, TF_PROMPT + TF_STEPS).astype(np.int32)).cuda()
    out, layers = {}, []
    with torch.no_grad():
        for path, c in (("kernel", cfg), ("plain", cfg),
                        ("spread", floor_cfg)):
            caches = lm.init_caches(c, 1, SERVE_MAX_LEN)
            if path == "kernel":
                hidden, caches, _ = lm.prefill(
                    model, c, stream[None, :TF_PROMPT], caches,
                    return_hidden=True)
            else:
                probe = ([(cfg, "cuda"), (floor_cfg, "torch_ref")]
                         if path == "plain" else None)
                hidden, caches, d = ssd_prefill_with(
                    model, c, stream[None, :TF_PROMPT], caches, "torch_ref",
                    probe)
                layers = layers or d
            logits = [lm.head_logits(model, c,
                                     hidden[:, -1:])[:, 0].float()]
            for t in range(TF_PROMPT, TF_PROMPT + TF_STEPS):
                lg, caches, _ = lm.decode_step(
                    model, c, stream[None, t:t + 1],
                    torch.tensor([t], device="cuda"), caches)
                logits.append(lg[:, 0].float())
            out[path] = torch.cat(logits)             # (1 + steps, vocab)
            del caches, hidden
    torch.cuda.empty_cache()
    d = (out["kernel"] - out["plain"]).abs()
    spread = (out["spread"] - out["plain"]).abs()
    top2 = out["plain"].topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > SSD_FLOOR_X * float(spread.max())
    agree = out["kernel"].argmax(-1) == out["plain"].argmax(-1)
    layer_k = [k for k, _ in layers]
    layer_s = [f for _, f in layers]
    worst_layer = max(k / max(f, 1e-30) for k, f in layers)
    rec = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
           "spread_max_abs": float(spread.max()),
           "spread_mean_abs": float(spread.mean()),
           "logit_std": float(out["plain"].std()),
           "positions": int(d.shape[0]), "clear": int(clear.sum()),
           "argmax_equal": int(agree.sum()),
           "layer_rel_diff": {"kernel_max": max(layer_k),
                              "kernel_first": layer_k[0],
                              "spread_max": max(layer_s),
                              "spread_first": layer_s[0],
                              "largest_ratio": worst_layer},
           "finite": bool(torch.isfinite(out["kernel"]).all())}
    print(f"layer by layer (block output on the plain path's input, "
          f"relative): kernel vs plain {layer_k[0]:.3e} at layer 0, at most "
          f"{max(layer_k):.3e}; spread (chunk {SSD_FLOOR_CHUNK}) "
          f"{layer_s[0]:.3e}, at most {max(layer_s):.3e}; largest kernel / "
          f"spread {worst_layer:.3f} (bound {SSD_FLOOR_X})", flush=True)
    print(f"teacher-forced {TF_PROMPT} + {TF_STEPS}: |kernel - plain| max "
          f"{rec['max_abs']:.5f}, mean {rec['mean_abs']:.5f}; spread max "
          f"{rec['spread_max_abs']:.5f}, mean {rec['spread_mean_abs']:.5f} "
          f"(bound {SSD_FLOOR_X} x the spread); logit std "
          f"{rec['logit_std']:.4f}; argmax equal at {rec['argmax_equal']} "
          f"of {rec['positions']}, {rec['clear']} with a top-2 margin above "
          f"{SSD_FLOOR_X} x the spread's max", flush=True)
    if not rec["finite"] or worst_layer > SSD_FLOOR_X or \
            rec["max_abs"] > SSD_FLOOR_X * rec["spread_max_abs"] or \
            rec["mean_abs"] > SSD_FLOOR_X * rec["spread_mean_abs"] or \
            not bool(agree[clear].all()):
        fail("teacher-forced kernel-12 logits differ from the plain scan's "
             "by more than the plain scan's own spread allows")
    return rec


def ssd_times(dev: dict, launches: dict, parity_err: dict) -> list:
    """Kernel 12 at the serving path's shape SSD_PATH in bf16, with the
    zero inbound state the model hands it at a fresh prefill, on the route
    the path takes (the tensor cores), then the CUDA-core route at the same
    shape (the kernel's first design) in the same call. The bound counts
    each input read once and each output written once (x, dt, a_log, B, C,
    h_in; y, h_out) and the flops the function needs on the causal pairs
    j <= i: C . B^T once a chunk for every head (2 N a pair), and a head
    and chunk the decayed products with x (2 P a pair) and the two state
    products (2 Q N P each), at the bf16 tensor-core rate the route uses;
    the same flops at the CUDA cores' float32 rate are printed beside it.
    Device time by kernel comes from a profiled window of back-to-back
    calls. PyTorch has no call for this function: library none."""
    phase("ssd times")
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.kernels.ssd_chunk import ref
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    b, s, h, p, n, q = SSD_PATH
    (x, dt, a_log, bm, cm), _ = ssd_inputs(g, b, s, h, p, n, bf16, False)
    h_in = torch.zeros((b, h, n, p), dtype=torch.float32, device="cuda")
    nc = s // q
    pairs = q * (q + 1) // 2
    flops = b * nc * (2 * n * pairs + h * (2 * p * pairs + 4 * q * n * p))
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
              + a_log.numel() * 4 + 2 * bm.numel() * bm.element_size()
              + 2 * h_in.numel() * 4)
    way = sk.route(bf16, p, n)
    rec = time_float_kernel(
        "ssd_chunk", lambda: sk.ssd_scan(x, dt, a_log, bm, cm, q, h_in)[0],
        lambda: ref.ssd_chunked_ref(x, dt, a_log, bm, cm, q, h_in)[0], None,
        nbytes=nbytes, flops=flops, dtype=bf16, dev=dev, rate=BF16_OPS,
        tol=SSD_TOL)
    core_bound = max(nbytes / MEM_BPS, flops / CORE_OPS) * 1e3
    rec.update({"shape": list(SSD_PATH), "path_route": way,
                "ops_rate": "bf16 tensor cores (wgmma), 989 TFLOP/s",
                "bound_fp32_cuda_cores_ms": core_bound,
                "source": "src/repro_torch/csrc/ssd_chunk.cu",
                "replaces": SSD_REPLACES,
                "launches": launches["ssd_chunk"],
                "max_abs_err": max(rec["max_abs_err"],
                                   parity_err["ssd_chunk"]),
                "split_ms": launch_split(
                    lambda: sk.ssd_scan(x, dt, a_log, bm, cm, q, h_in),
                    SSD_KERNELS, dev)})
    share = rec["bound_ms"] / rec["ms_back_to_back"]
    print(f"ssd_chunk route {way}: {share:.3f} of its "
          f"{rec['bound_ms']:.4f} ms bound (bf16 tensor cores: bytes "
          f"{nbytes / MEM_BPS * 1e3:.4f} ms, operations "
          f"{flops / BF16_OPS * 1e3:.4f} ms); "
          f"{core_bound / rec['ms_back_to_back']:.3f} of the fp32 CUDA-core "
          f"bound {core_bound:.4f} ms", flush=True)

    def core():
        return sk.ssd_scan(x, dt, a_log, bm, cm, q, h_in, "cuda_core")
    rec["cuda_core_route"] = {
        "ms": time_ms(core), "ms_back_to_back": time_ms(core, KERNEL_REPS),
        "split_ms": launch_split(core, SSD_KERNELS, dev)}
    print(f"the CUDA-core route at the same shape: "
          f"{rec['cuda_core_route']['ms']:.4f} ms one call "
          f"({rec['cuda_core_route']['ms_back_to_back']:.4f} ms back to "
          f"back) [{dev['smi']}]", flush=True)
    del x, dt, bm, cm, h_in
    torch.cuda.empty_cache()
    return [rec]


def launch_split(fn, names, dev: dict) -> dict:
    """Device time of `fn`'s launches by kernel, over KERNEL_REPS calls back
    to back under torch.profiler: {kernel name: [ms a launch, launches
    seen]} (a profiled name is shortened to the first of `names` it
    holds). The profiler may miss launches, so a launch's time is the
    mean over those it saw; `fn` launches each kernel once."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(KERNEL_REPS):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.self_cpu_time_total == 0 and e.self_device_time_total > 0:
            key = next((k for k in names if k in e.key), e.key[:60])
            us, count = split.get(key, (0.0, 0))
            split[key] = (us + e.self_device_time_total, count + e.count)
    split = {k: [us / 1e3 / count, count] for k, (us, count) in split.items()}
    print(f"per launch (torch.profiler, {KERNEL_REPS} calls back to back), "
          f"device [ms a launch, launches seen]: {json.dumps(split)}; a "
          f"call {sum(ms for ms, _ in split.values()):.4f} ms "
          f"[{dev['smi']}]", flush=True)
    return split


# --------------------------------------------------------------------------
# the Griffin and MoE serving slice: recurrentgemma-2b, moonshot-v1-16b-a3b
# and mixtral-8x22b through kernels 10 and 11
# --------------------------------------------------------------------------

RG_ARCH = "recurrentgemma-2b"      # 26 layers (R, R, A), d_model 2560
MOON_ARCH = "moonshot-v1-16b-a3b"  # 48 "attn" layers, 64 experts, top 6
MIX_ARCH = "mixtral-8x22b"         # 56 "swa" layers, 8 experts, top 2
# 4096-token prompts and 64 new tokens: an 8192-slot ring would hold 25.8
# GB of K/V (48 layers x 16 KV heads x 128 x 2 x 2 B a slot-token x 8
# slots), which does not fit beside moonshot's 52.3 GiB of weights
MOON_MAX_LEN = 4224
# mixtral-8x22b is 140.6 B parameters, 262 GiB in bf16: 8 of its 56 layers
# (20.4 B, 38.1 GiB) at full width
MIX_LAYERS = 8
# the profiled window of this slice's serve phases (prompts of 2048
# tokens, new tokens each), smaller than the serve phase's: the
# profiler's processing of moonshot's 2 x 8 window (343k host operator
# calls) took 52.8-77.7 s of host on the H100
GRIFFIN_PROFILE = (1, 4)
MOE_DROP_FACTOR = 0.5    # block parity's capacity factor: choices drop
MOE_BIAS_RATE = 0.02     # block parity's bias_update rate (3 updates)
BLOCK_S, BLOCK_STEPS = 1024, 16   # RG-LRU block parity: prefill, decode
MOE_B, MOE_S = 2, 128             # MoE block parity's batch
SCAN_SHAPE = (1, 4096, 2560)      # the recurrentgemma prefill's scan
# Card against CPU, the same port code in float32 with TF32 off, element by
# element as float_err measures: |card - cpu| <= rel * |cpu| + row * rms of
# the CPU output's row (D values). rel: two units in the last place. row:
# the products' sums run in other orders on the two devices; a sum of K
# terms (K = 2560 .. 16384 here) differs by about sqrt(K) * 2^-24 of the
# row's scale, 2e-6 .. 8e-6, and a block stacks up to five such products
# (gate, x and output projections, two of the MLP's or experts') with the
# scan and the gelu between them: 1e-4 of the row leaves ~3x that.
BLOCK_TOL = {torch.float32: (2.0 ** -22, 1e-4)}
# The doubling scan against the sequential recurrence, on the card: both
# float32. A step's weight exp(sum of log_a) is formed from a sum that the
# doubling scan adds in another order; at the check's log_a in [-0.1, 0)
# the weights that matter (sums above -20) carry up to ~2 ulp of 20, 4e-6
# relative, and the value sums ~40 of them: 2^-16 (1.5e-5) of the row.
SCAN_TOL = {torch.float32: (2.0 ** -20, 2.0 ** -16)}


def block_parity_phase() -> dict:
    """The RG-LRU and MoE blocks on the card against the same port code on
    the CPU, at each model's full width in float32 (weights from a seeded
    generator on the card, copied to the CPU), TF32 off; then the doubling
    scan against the sequential recurrence on the card."""
    phase("parity (rglru and moe blocks)")
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, moe, rglru
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    g = torch.Generator(device="cuda").manual_seed(SEED + 30)
    rec, bad = {}, []

    def held(label, got, want, tol=BLOCK_TOL):
        e, ratio = float_err(got.cpu(), want, f32, tol)
        rec[label] = {"max_abs_err": e, "err_over_limit": ratio}
        if not ratio <= 1.0:
            bad.append((label, e, ratio))
        return ratio

    t0 = time.perf_counter()
    with torch.no_grad():
        cfg = dataclasses.replace(get_config(RG_ARCH), dtype="float32")
        blk = blocks.block_init(cfg, "rglru", f32, g)
        cpu = copy.deepcopy(blk).cpu()
        x = torch.randn((1, BLOCK_S + BLOCK_STEPS, cfg.d_model), generator=g,
                        device="cuda")
        out, st, _ = blocks.block_apply(blk, x[:, :BLOCK_S], None, cfg,
                                        "rglru")
        out_c, st_c, _ = blocks.block_apply(cpu, x[:, :BLOCK_S].cpu(), None,
                                            cfg, "rglru")
        held("rglru apply", out, out_c)
        worst = 0.0
        for t in range(BLOCK_S, BLOCK_S + BLOCK_STEPS):
            out, st, _ = blocks.block_apply(blk, x[:, t:t + 1], None, cfg,
                                            "rglru", cache=st, decode=True)
            out_c, st_c, _ = blocks.block_apply(
                cpu, x[:, t:t + 1].cpu(), None, cfg, "rglru", cache=st_c,
                decode=True)
            worst = max(worst, held(f"rglru decode {t - BLOCK_S}", out,
                                    out_c))
        held("rglru state h", st["h"], st_c["h"])
        held("rglru state conv", st["conv"], st_c["conv"])
        print(f"rglru block at {cfg.name}'s width ({cfg.d_model}, lru "
              f"{cfg.resolved_lru_width}, d_ff {cfg.d_ff}), card against "
              f"CPU: apply over {BLOCK_S} steps err / limit "
              f"{rec['rglru apply']['err_over_limit']:.4f}, {BLOCK_STEPS} "
              f"decode steps at most {worst:.4f}, state h "
              f"{rec['rglru state h']['err_over_limit']:.4f}", flush=True)
        del blk, cpu, x, out, out_c, st, st_c
        for arch in (MOON_ARCH, MIX_ARCH):
            cfg = dataclasses.replace(get_config(arch), dtype="float32",
                                      moe_capacity_factor=MOE_DROP_FACTOR)
            mode = "sigmoid + bias" if cfg.aux_free_bias else "softmax"
            m = moe.init(cfg, f32, g)
            if cfg.aux_free_bias:
                # a nonzero selection bias, so selection and weights differ
                for _ in range(3):
                    xb = torch.randn((MOE_B, MOE_S, cfg.d_model),
                                     generator=g, device="cuda")
                    _, aux = moe.apply(m, xb, cfg)
                    m.router_bias.copy_(moe.bias_update(
                        m.router_bias, aux["load"], MOE_BIAS_RATE))
            mc = copy.deepcopy(m).cpu()
            x = torch.randn((MOE_B, MOE_S, cfg.d_model), generator=g,
                            device="cuda")
            e, cap = cfg.num_experts, moe.capacity(cfg, MOE_S)
            idx, w, _ = moe._route(m, x, cfg)
            idx_c, w_c, _ = moe._route(mc, x.cpu(), cfg)
            tf, wf = moe._dispatch_indices(idx, w, e, cap)
            tf_c, _ = moe._dispatch_indices(idx_c, w_c, e, cap)
            tf_s, wf_s = moe._dispatch_indices(idx.cpu(), w.cpu(), e, cap)
            out, _ = moe.apply(m, x, cfg)
            out_c, _ = moe.apply(mc, x.cpu(), cfg)
            label = f"moe {mode}"
            r = {"arch": arch, "capacity": cap,
                 "ids_equal": bool(torch.equal(idx.cpu(), idx_c)),
                 "token_for_equal": bool(torch.equal(tf.cpu(), tf_c)),
                 "planes_equal_on_equal_inputs": bool(
                     torch.equal(tf.cpu(), tf_s)
                     and torch.equal(wf.cpu(), wf_s)),
                 "dropped": MOE_B * MOE_S * cfg.experts_per_token
                 - int((wf > 0).sum()),
                 "bias_nonzero": bool(cfg.aux_free_bias
                                      and m.router_bias.any())}
            held(label, out, out_c)
            rec[label].update(r)
            print(f"{label} at {cfg.name}'s width ({cfg.d_model}, {e} "
                  f"experts of {cfg.d_ff}, top {cfg.experts_per_token}), "
                  f"({MOE_B}, {MOE_S}) tokens, capacity {cap} (factor "
                  f"{MOE_DROP_FACTOR}): {json.dumps(rec[label])}",
                  flush=True)
            if not (r["ids_equal"] and r["token_for_equal"]
                    and r["planes_equal_on_equal_inputs"]
                    and r["dropped"] > 0) or (
                        cfg.aux_free_bias and not r["bias_nonzero"]):
                bad.append((label, r))
            del m, mc, x, out, out_c
        torch.cuda.empty_cache()
        # the doubling scan against the sequential recurrence
        b, s, wd = SCAN_SHAPE
        la = -0.1 * torch.rand(SCAN_SHAPE, generator=g, device="cuda")
        bb = torch.randn(SCAN_SHAPE, generator=g, device="cuda")
        h0 = torch.randn((b, wd), generator=g, device="cuda")
        torch.cuda.synchronize()
        ts = time.perf_counter()
        h = rglru._scan(la, bb, h0)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - ts
        ts = time.perf_counter()
        plain = rglru._scan_ref(la, bb, h0)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - ts
        held("scan doubling vs sequential", h, plain.cpu(), SCAN_TOL)
        control = float_err(rglru._scan_ref(la, bb).cpu(), plain.cpu(), f32,
                            SCAN_TOL)[1]
        rec["scan doubling vs sequential"].update(
            {"shape": list(SCAN_SHAPE), "doubling_ms": scan_s * 1e3,
             "sequential_ms": plain_s * 1e3,
             "control_h0_dropped_err_over_limit": control})
        print(f"rglru scan at {SCAN_SHAPE}, log_a in [-0.1, 0): doubling "
              f"({(s - 1).bit_length()} passes) against sequential, err / "
              f"limit {rec['scan doubling vs sequential']['err_over_limit']:.4f}"
              f" (SCAN_TOL {SCAN_TOL[f32]}); host wall {scan_s * 1e3:.3f} ms "
              f"against {plain_s * 1e3:.3f} ms; control (inbound state "
              f"dropped) {control:.1f}, must exceed 1", flush=True)
        if not control > 1.0:
            bad.append(("scan control", control))
        del la, bb, h0, h, plain
    torch.cuda.empty_cache()
    print(f"block parity in {time.perf_counter() - t0:.2f} s", flush=True)
    if bad:
        for b_ in bad:
            print("MISMATCH", b_, file=sys.stderr)
        fail(f"{len(bad)} rglru / moe block checks failed on the card")
    return rec


def griffin_moe_config(arch: str):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    if arch == MIX_ARCH:
        cfg = dataclasses.replace(cfg, num_layers=MIX_LAYERS)
    return cfg


def lm_serve_phase(arch: str, max_len: int, dev: dict) -> tuple:
    """One model of the Griffin / MoE slice at its published widths in
    bf16, random weights from a seeded generator on the card,
    attn_impl="flash": SERVE_REQUESTS requests through
    ServeEngine(SERVE_SLOTS, max_len); kernels 10 and 11 must launch."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.configs import get_config
    cfg = griffin_moe_config(arch)
    label = arch.split("-")[0]
    phase(f"serve {label}")
    full = get_config(arch).num_layers
    reduced = ({"num_layers": [full, cfg.num_layers]}
               if cfg.num_layers != full else {})
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t_phase = t0 = time.perf_counter()
    model = lm.init(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers {cfg.block_pattern}, "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads / "
          f"{cfg.num_kv_heads} kv of {cfg.resolved_head_dim}, window "
          f"{cfg.window}, d_ff {cfg.d_ff}, lru {cfg.lru_width}, experts "
          f"{cfg.num_experts} top {cfg.experts_per_token} (aux-free "
          f"{cfg.aux_free_bias}, capacity factor {cfg.moe_capacity_factor}),"
          f" vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}, "
          f"{cfg.dtype}; {n_params} parameters (analytic "
          f"{cfg.param_count()}) drawn in {time.perf_counter() - t0:.2f} s; "
          f"reduced: {json.dumps(reduced)}", flush=True)
    if n_params != cfg.param_count():
        fail("parameter count differs from the config's analytic count")
    engine = ServeEngine(cfg, model, batch_slots=SERVE_SLOTS,
                         max_len=max_len, seed=SEED)
    with RouteLog() as routes:
        bytes_of, weights, states, chosen = lm_step_counter(
            model, engine, cfg, routes)
        dk.LAUNCHES = fk.LAUNCHES = 0
        got = drive(engine, serve_requests(cfg.vocab_size), bytes_of)
        torch.cuda.synchronize()
        launches = {"decode_attention": dk.LAUNCHES,
                    "flash_attention": fk.LAUNCHES}
    what = ("weights read (experts: those the step chose) + valid ring "
            "slots" + (" + recurrent states" if states else ""))
    rec = {"engine": report_serve(label, got, cfg.vocab_size, dev,
                                  what=what, bucketed=engine._bucket),
           "reduced": reduced, "max_len": max_len,
           "parameters": n_params, "weights_bytes_a_step": weights,
           "state_bytes": states, "source": {
               RG_ARCH: "arXiv:2402.19427", MOON_ARCH:
               "hf:moonshotai/Moonlight-16B-A3B",
               MIX_ARCH: "arXiv:2401.04088"}[arch]}
    if chosen:
        rec["experts_chosen_a_layer"] = {
            "mean": float(np.mean(chosen)), "min": min(chosen),
            "max": max(chosen), "of": cfg.num_experts}
        print(f"experts a MoE layer chose over the {SERVE_SLOTS} slots of a "
              f"step: mean {np.mean(chosen):.2f} of {cfg.num_experts} "
              f"({min(chosen):.2f}..{max(chosen):.2f}); the step computes "
              f"all {cfg.num_experts} experts' capacity slots", flush=True)
    peak = torch.cuda.max_memory_allocated()
    rec["peak_gib"] = peak / 2**30
    rec["allocated_before_gib"] = before / 2**30
    rec["launches"] = launches
    print(f"kernel launches on the {label} serve path: {launches}; peak "
          f"device memory {peak / 2**30:.3f} GiB ({before / 2**30:.3f} GiB "
          f"held before the phase)", flush=True)
    zero = [k for k, n in launches.items() if n == 0]
    if zero:
        fail(f"kernels never launched on the {label} serve path: {zero}")
    n, new = GRIFFIN_PROFILE
    t = time.perf_counter()
    rec["profile"] = serve_profile(engine, cfg, n=n, new=new)
    print(f"serve {label}: {t - t_phase:.2f} s to here, the profiled "
          f"window {time.perf_counter() - t:.2f} s", flush=True)
    del engine
    release()
    t = time.perf_counter()
    rec["parity"] = tf_parity(model, cfg, max_len, f"serve {label} parity",
                              SEED + 2)
    print(f"serve {label} parity in {time.perf_counter() - t:.2f} s",
          flush=True)
    return model, rec


def recurrentgemma_times(dev: dict) -> dict:
    """Kernels 10 and 11 at recurrentgemma-2b's shapes in bf16: decode q
    (8, 1, 10, 256) over its (8, 1, 2048, 256) window ring wrapped as after
    the longest request (positions up to 4158 stored, queries at 4159,
    window 2048), and a 4096-token prefill (1, 1, 10, 4096, 256) at window
    2048 on the route kernel.route gives it (the tensor cores), then on
    kernel 11's CUDA-core route (way="cuda_core", the kernel the D 256
    prefill took before it had a tensor-core route) in the same call.
    Bounds as attention_times counts them (the window's reachable pairs);
    the prefill's bound at the fp32 CUDA-core rate is printed beside the
    CUDA-core route's time. SDPA with an explicit mask is the library
    call."""
    phase("recurrentgemma times")
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ref as dref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fref
    cfg = griffin_moe_config(RG_ARCH)
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(SEED + 31)
    b, kvh, gq, d = SERVE_SLOTS, cfg.num_kv_heads, cfg.num_heads \
        // cfg.num_kv_heads, cfg.resolved_head_dim
    w = s = cfg.window
    q = torch.randn((b, kvh, gq, d), generator=g, device="cuda").to(bf16)
    k = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(bf16)
    v = torch.randn((b, kvh, s, d), generator=g, device="cuda").to(bf16)
    last = SERVE_PROMPTS[1] + SERVE_NEW - 1
    kv_pos, q_pos = ring_positions(b, s, None, [last] * b)
    dp = q_pos[:, None] - kv_pos
    mask = ((dp >= 0) & (dp < w))[:, None, None, :]
    valid = int(mask.sum())
    out = {}
    dec = time_float_kernel(
        "decode_attention",
        lambda: dk.decode_attention_fwd(q, k, v, q_pos, kv_pos, window=w),
        lambda: dref.decode_ref(q, k, v, q_pos, kv_pos, window=w),
        lambda: F.scaled_dot_product_attention(
            q.reshape(b, kvh * gq, 1, d), k, v, attn_mask=mask,
            enable_gqa=True),
        nbytes=ring_bytes(kv_pos, q_pos, kvh, d, 2, w) + 2 * q.numel() * 2,
        flops=4 * d * gq * kvh * valid, dtype=bf16, dev=dev)
    dec.update({"shape": [b, kvh, gq, s, d], "window": w,
                "valid_slots": valid // b})
    out["decode_attention"] = dec
    del q, k, v, kv_pos, q_pos, mask
    sq = TF_PROMPT
    q5 = torch.randn((1, kvh, gq, sq, d), generator=g,
                     device="cuda").to(bf16)
    k4 = torch.randn((1, kvh, sq, d), generator=g, device="cuda").to(bf16)
    v4 = torch.randn((1, kvh, sq, d), generator=g, device="cuda").to(bf16)
    i = torch.arange(sq, device="cuda")
    band = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)
    pairs = kvh * gq * int(band.sum())
    flops = 4 * d * pairs
    fl = time_float_kernel(
        "flash_attention",
        lambda: fk.flash_attention_fwd(q5, k4, v4, window=w),
        lambda: fref.attention_ref(q5, k4, v4, window=w),
        lambda: F.scaled_dot_product_attention(
            q5.reshape(1, kvh * gq, sq, d), k4, v4, attn_mask=band,
            enable_gqa=True),
        nbytes=2 * q5.numel() * 2 + 2 * k4.numel() * 2,
        flops=flops, dtype=bf16, dev=dev)
    way = fk.route(bf16, d)
    share = fl["bound_ms"] / fl["ms_back_to_back"]
    over = fl["ms_back_to_back"] / fl["library_ms_back_to_back"]
    print(f"flash_attention at D 256 takes route {way!r} "
          f"({FLASH_KERNELS[way]}): {share:.3f} of its "
          f"{fl['bound_ms']:.4f} ms bound back to back, {over:.3f}x SDPA's "
          f"time ({'under' if over < 1 else 'over'} it) [{dev['smi']}]",
          flush=True)

    def core():
        return fk.flash_attention_fwd(q5, k4, v4, window=w, way="cuda_core")
    e, ratio = float_err(core(), fref.attention_ref(q5, k4, v4, window=w),
                         bf16)
    if not ratio <= 1.0:
        fail(f"flash_attention's CUDA-core route differs from its plain "
             f"version at D 256 (max abs err {e}, {ratio} of the limit)")
    bound_core = max(fl["bytes"] / MEM_BPS, flops / CORE_OPS) * 1e3
    cuda_core = {"ms": time_ms(core),
                 "ms_back_to_back": time_ms(core, KERNEL_REPS),
                 "max_abs_err": e, "bound_fp32_cuda_cores_ms": bound_core}
    fl.update({"shape": [1, kvh, gq, sq, sq, d], "window": w,
               "path_route": way, "path_kernel": FLASH_KERNELS[way],
               "bound_share_back_to_back": share,
               "over_library_back_to_back": over,
               "cuda_core_route": cuda_core,
               "split_ms": launch_split(
                   lambda: fk.flash_attention_fwd(q5, k4, v4, window=w),
                   tuple(FLASH_KERNELS.values()), dev)})
    print(f"the CUDA-core route at the same shape: {cuda_core['ms']:.4f} ms "
          f"one call ({cuda_core['ms_back_to_back']:.4f} ms back to back), "
          f"{bound_core / cuda_core['ms_back_to_back']:.3f} of the fp32 "
          f"CUDA-core bound {bound_core:.4f} ms; the route taken is "
          f"{cuda_core['ms_back_to_back'] / fl['ms_back_to_back']:.2f}x as "
          f"fast back to back [{dev['smi']}]", flush=True)
    out["flash_attention"] = fl
    del q5, k4, v4, band
    torch.cuda.empty_cache()
    return out


def griffin_moe_phases(dev: dict, kernels: list, serve: dict,
                       dist: dict) -> None:
    """The Griffin and MoE slice after the mamba2 phases: block parity,
    then each model's serve phase and teacher-forced check (recurrentgemma
    followed by kernels 10 and 11 at its shapes), each model dropped before
    the next; records into `serve` and the kernel 10 / 11 entries. The
    mixtral weights also serve the distribution slice's sharded serve
    phase (into `dist`) before they are dropped."""
    serve["block_parity"] = block_parity_phase()
    times = None
    for arch, max_len in ((RG_ARCH, SERVE_MAX_LEN),
                          (MOON_ARCH, MOON_MAX_LEN),
                          (MIX_ARCH, SERVE_MAX_LEN)):
        model, rec = lm_serve_phase(arch, max_len, dev)
        if arch == MIX_ARCH:
            dist["serve_mixtral"] = sharded_serve_phase(
                dev, model, griffin_moe_config(arch))
            for k in kernels:
                if k["name"] in dist["serve_mixtral"]["launches"]:
                    k["launches_dist"] = {"serve_mixtral_sharded": dist[
                        "serve_mixtral"]["launches"][k["name"]]}
        del model
        release()
        label = arch.split("-")[0]
        serve[label] = rec
        for k in kernels:
            if k["name"] in rec["launches"]:
                k[f"launches_{label}"] = rec["launches"][k["name"]]
        if arch == RG_ARCH:
            times = recurrentgemma_times(dev)
    for k in kernels:
        if k["name"] in times:
            k["recurrentgemma_shape"] = times[k["name"]]


# --------------------------------------------------------------------------
# the sharded slice: virtual shards, degraded re-execution, chaos
# --------------------------------------------------------------------------

SHARDS = (8, 7)                  # 8 splits 2^30 rows evenly; 7 pads
DEGRADED_LOST = ([0], [3, 5], list(range(7)))
CHAOS_COLS = 8
CHAOS_ROWS = 1 << 24
CHAOS_CHUNK_ROWS = 16384           # 1024 chunks a column (see chaos_phase)
CHAOS_QUERIES = 120
CHAOS_SPEC = dict(seed=42, stall_rate=0.1, corrupt_rate=0.05)
CHAOS_SLA_SLACK = 2.5            # examples/chaos_replay.py's SLA_SLACK
CHAOS_FAST_GBPS = 0.016          # ... and its modeled fast tier
SHARD_LOSS_SPEC = dict(seed=5, shard_loss_rate=0.3)


def read_counters(counters: dict) -> dict:
    """Launches since `reset_counters()` returned `counters`."""
    return {k: getattr(m, attr) for k, (m, attr) in counters.items()}


def unsharded_answers(table, shapes) -> list:
    """The unsharded engine's results for `shapes` ((name, plan, aggs)),
    warm: the kernels ran on this table in an earlier phase."""
    from repro_torch.query import Query, QueryEngine
    eng = QueryEngine(table, mode="auto")
    out = []
    for _, plan, aggs in shapes:
        eng.submit(Query(plan, aggregates=aggs))
        out.append(eng.run()[0])
    return out


def sharded_run(st, shapes, flat, label: str, dev: dict, bad: list) -> dict:
    """`shapes` through QueryEngine(st, "auto"), against `flat` (the
    unsharded engine's results), QueryEngine(st, "torch_ref") and the
    merged execute_partials; prints ms and GB/s a plan and model_check."""
    from repro_torch.core.systems import H100_SXM, as_paper_system
    from repro_torch.query import Query, QueryEngine
    counters = reset_counters()
    eng = QueryEngine(st, mode="auto")
    got = []
    for _, plan, aggs in shapes:
        eng.submit(Query(plan, aggregates=aggs))
        got.append(eng.run()[0])
    launches = read_counters(counters)
    ref = QueryEngine(st, mode="torch_ref")
    inner = getattr(st, "inner", st)
    rows = []
    for (name, plan, aggs), res, f in zip(shapes, got, flat):
        ref.submit(Query(plan, aggregates=aggs))
        want = ref.run()[0]
        same = res.aggregates == f.aggregates == want.aggregates
        if inner is st:        # the merged partials equal execute's
            parts = st.execute_partials(plan, aggs)
            for a in aggs:
                d, hit = res.aggregates[a], [p[a] for p in parts
                                             if p[a]["count"]]
                same = same and d["count"] == sum(p["count"] for p in hit) \
                    and d["sum"] == sum(p["sum"] for p in hit) \
                    and (not hit or (d["min"], d["max"]) == (
                        min(p["min"] for p in hit),
                        max(p["max"] for p in hit)))
        gbps = res.bytes_scanned / res.latency_s / 1e9
        print(f"{label} {name:24s} {res.latency_s * 1e3:9.3f} ms "
              f"{gbps:8.1f} GB/s | unsharded {f.latency_s * 1e3:9.3f} ms "
              f"{f.bytes_scanned / f.latency_s / 1e9:8.1f} GB/s | "
              f"torch_ref {want.latency_s * 1e3:9.3f} ms | count "
              f"{res.count} equal={same}", flush=True)
        rows.append({"plan": name, "ms": res.latency_s * 1e3,
                     "gbps": gbps, "unsharded_ms": f.latency_s * 1e3,
                     "unsharded_gbps": f.bytes_scanned / f.latency_s / 1e9,
                     "torch_ref_ms": want.latency_s * 1e3})
        if not same:
            bad.append((label, name, res.aggregates, f.aggregates,
                        want.aggregates))
    card = as_paper_system(H100_SXM)
    mc = eng.model_check(card)
    one_card = eng.bytes_total / eng.seconds_total / card.chip_peak_perf
    print(f"{label} model_check (chips = {mc['chips']} virtual shards): "
          f"{json.dumps(mc)}; against one card's Eq. 4 "
          f"({card.chip_peak_perf / 1e9:.0f} GB/s): {one_card:.4f}")
    print(f"{label} kernel launches {launches}; dispatch counts "
          f"{eng.metrics.launch_counts()}", flush=True)
    return {"plans": rows, "launches": launches, "model_check": mc,
            "one_card_fraction": one_card,
            "rows_per_shard": inner.rows_per_shard,
            "padding_bytes": st.nbytes - sum(
                4 * int(c.words.numel())
                for c in inner.table.columns.values()),
            "nbytes": st.nbytes}


def sharded_main_phase(table, dev: dict) -> dict:
    """The main table sharded 8 ways (no padding) and 7 ways (padded):
    the eleven plans against the unsharded engine and torch_ref; kernels
    1, 4 and 5 must have launched."""
    phase("sharded main")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.query import ShardedTable
    shapes = plan_shapes()
    flat = unsharded_answers(table, shapes)
    out, bad = {}, []
    for n in SHARDS:
        t0 = time.perf_counter()
        st = ShardedTable.shard(table, make_mesh((n,), ("data",)))
        torch.cuda.synchronize()
        shard_s = time.perf_counter() - t0
        print(f"{n} shards: rows_per_shard {st.rows_per_shard}, "
              f"{st.nbytes} device bytes ({st.nbytes - table.nbytes} of "
              f"padding), shard() {shard_s * 1e3:.3f} ms", flush=True)
        rec = out[n] = sharded_run(st, shapes, flat, f"[{n}]", dev, bad)
        rec["shard_ms"] = shard_s * 1e3
        del st
        release()
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} sharded main results differ")
    for n, rec in out.items():
        zero = [k for k in ("scan_filter", "aggregate_batched",
                            "scan_aggregate_batched")
                if rec["launches"][k] == 0]
        if zero:
            fail(f"kernels never launched on the {n}-shard path: {zero}")
    return out


def sharded_grouped_phase(label: str, views: dict, shapes,
                          want: list) -> dict:
    """Grouped `shapes` through QueryEngine(view, "auto") for each 8-shard
    view, against `want` (the unsharded grouped phase's results); kernel 8
    must have launched on each."""
    phase(f"sharded grouped ({label})")
    from repro_torch.query import QueryEngine
    out, bad = {}, []
    for vname, st in views.items():
        counters = reset_counters()
        eng = QueryEngine(st, mode="auto")
        rows = []
        for (name, q), w in zip(shapes, want):
            eng.submit(q)
            r = eng.run()[0]
            same = r.aggregates == w.aggregates
            print(f"{label} {vname:6s} {name:18s} {r.latency_s * 1e3:9.3f} "
                  f"ms | unsharded {w.latency_s * 1e3:9.3f} ms | "
                  f"{len(r.aggregates['groups'])} groups, count {r.count} "
                  f"equal={same}", flush=True)
            rows.append({"shape": name, "ms": r.latency_s * 1e3,
                         "unsharded_ms": w.latency_s * 1e3})
            if not same:
                bad.append((vname, name))
        launches = read_counters(counters)
        print(f"{label} {vname} kernel launches {launches}; dispatch counts "
              f"{eng.metrics.launch_counts()}")
        if launches["group_sum_count_batched"] == 0:
            fail(f"kernel 8 never launched on the sharded grouped {label} "
                 f"{vname} path")
        out[vname] = {"shapes": rows, "launches": launches}
    if bad:
        fail(f"sharded grouped {label} results differ: {bad}")
    return out


def delta_view(encoded, n: int):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.store import ShardedEncodedTable
    t0 = time.perf_counter()
    se = ShardedEncodedTable.shard(encoded, make_mesh((n,), ("data",)))
    torch.cuda.synchronize()
    return se, time.perf_counter() - t0


def main_views(table, mesh) -> tuple:
    """The 8-shard plain view of the main table and its delta view (the
    table encoded in STORE_CHUNK_ROWS chunks, then ShardedEncodedTable);
    returns them and the delta view's set-up record."""
    from repro_torch.query import ShardedTable
    from repro_torch.store import EncodedTable
    t0 = time.perf_counter()
    encoded = EncodedTable.from_table(table, chunk_rows=STORE_CHUNK_ROWS)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    se, shard_s = delta_view(encoded, mesh.shape["data"])
    print(f"delta view of the main table: encode {enc_s:.3f} s, shard "
          f"{shard_s:.3f} s, {se.nbytes} device bytes, frames "
          f"{se.frames}", flush=True)
    return ({"plain": ShardedTable.shard(table, mesh), "delta": se},
            {"encode_s": enc_s, "shard_s": shard_s, "nbytes": se.nbytes})


def degraded_phase(views: dict, dim) -> dict:
    """execute_degraded and execute_grouped_degraded on the 8-shard main
    table and its delta view: lost shards [0], [3, 5] and seven of eight,
    each answer against the fault-free one with recovered bytes > 0; all
    eight lost must raise DegradedResultError."""
    phase("degraded")
    from repro_torch.query import GroupBy, HashJoin, Pred
    from repro_torch.resilience import (DegradedResultError,
                                        execute_degraded,
                                        execute_grouped_degraded)
    flat = [("fused", Pred("a", "lt", 64), ("b",)),
            ("and_mixed", Pred("a", "lt", 50) & Pred("w", "ge", 9000),
             ("w", "b")),
            ("empty", Pred("a", "gt", 127), ("b",))]
    grouped = [("groupby_dense", GroupBy("a", ("w",))),
               ("count_only", GroupBy("x")),
               ("hash_join", HashJoin(dim, "a", "a", aggs=("b",)))]
    counters = reset_counters()
    rec, bad = [], []
    for vname, st in views.items():
        for name, plan, aggs in flat:
            want = st.execute(plan, aggs)
            for lost in DEGRADED_LOST:
                t0 = time.perf_counter()
                got, rb = execute_degraded(st, plan, aggs, lost)
                ms = (time.perf_counter() - t0) * 1e3
                ok = got == want and rb > 0
                rec.append({"view": vname, "query": name, "lost": lost,
                            "ms": ms, "recovered_bytes": rb})
                print(f"{vname:6s} {name:14s} lost {len(lost)} "
                      f"{str(lost):22s} {ms:9.3f} ms  recovered {rb} B  "
                      f"equal={ok}", flush=True)
                if not ok:
                    bad.append((vname, name, lost, got, want))
            try:
                execute_degraded(st, plan, aggs, range(8))
                bad.append((vname, name, "all eight lost did not raise"))
            except DegradedResultError:
                pass
        for name, q in grouped:
            want = st.execute_grouped(q)
            for lost in DEGRADED_LOST:
                t0 = time.perf_counter()
                got, rb = execute_grouped_degraded(st, q, lost)
                ms = (time.perf_counter() - t0) * 1e3
                ok = got == want and rb > 0
                rec.append({"view": vname, "query": name, "lost": lost,
                            "ms": ms, "recovered_bytes": rb})
                print(f"{vname:6s} {name:14s} lost {len(lost)} "
                      f"{str(lost):22s} {ms:9.3f} ms  recovered {rb} B  "
                      f"equal={ok}", flush=True)
                if not ok:
                    bad.append((vname, name, lost))
            try:
                execute_grouped_degraded(st, q, range(8))
                bad.append((vname, name, "all eight lost did not raise"))
            except DegradedResultError:
                pass
    launches = read_counters(counters)
    print(f"kernel launches on the degraded path: {launches}")
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} degraded results differ or did not raise")
    return {"calls": rec, "launches": launches}


def sharded_store_phase(table, encoded, dev: dict) -> dict:
    """ShardedEncodedTable over the 2^28-row store, 8 shards: the sixteen
    store plans against the unsharded store's answers and torch_ref."""
    phase("sharded store")
    shapes = store_plan_shapes()
    flat = unsharded_answers(encoded, shapes)
    se, shard_s = delta_view(encoded, 8)
    print(f"delta view: {se.nbytes} device bytes against the plain "
          f"footprint {table.nbytes} and the encoded store's "
          f"{encoded.nbytes}; rows_per_shard {se.inner.rows_per_shard}; "
          f"shard {shard_s:.3f} s; frames {se.frames}", flush=True)
    bad = []
    rec = sharded_run(se, shapes, flat, "[8 delta]", dev, bad)
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} sharded store results differ")
    rec.update(shard_s=shard_s, plain_nbytes=table.nbytes,
               encoded_nbytes=encoded.nbytes)
    return rec, se


def sharded_launches(sharded: dict, name: str) -> dict:
    """Kernel `name`'s launches in each sharded-slice run, for the
    {"kernels": ...} line's "launches_sharded"."""
    runs = {f"main {n} shards": r["launches"]
            for n, r in sharded["main"].items()}
    runs["store 8 shards"] = sharded["store"]["launches"]
    for label in ("grouped_main", "grouped_store"):
        for view, r in sharded[label].items():
            runs[f"{label} {view}"] = r["launches"]
    runs["degraded"] = sharded["degraded"]["launches"]
    runs["chaos"] = sharded["chaos"]["launches"]
    runs["shard loss"] = sharded["chaos"]["shard_loss_launches"]
    return {k: v[name] for k, v in runs.items() if v.get(name)}


class GuardClock(HostClock):
    """Host seconds in ChunkGuard.check (crc32 over host copies of every
    chunk a guarded query reads), a check that raises included."""

    def __init__(self):
        from repro_torch.resilience import ChunkGuard
        self.targets = [(ChunkGuard, "check")]
        self.seconds = {"check": 0.0}


def build_chaos_table():
    """examples/chaos_replay.py's table (eight 8-bit columns) at
    CHAOS_ROWS rows, built on the card from a seeded generator."""
    from repro_torch.db import BitPackedColumn, Table
    from repro_torch.kernels.scan_filter.ref import field_masks
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    t = Table("events")
    delim, _, _ = field_masks(8)
    for i in range(CHAOS_COLS):
        t.add(BitPackedColumn(f"c{i:02d}", 8, CHAOS_ROWS, random_words(
            CHAOS_ROWS // 4, ~int(delim) & 0xFFFFFFFF, g)))
    torch.cuda.synchronize()
    return t


def chaos_run(table, trace, recover: bool, mode: str = "auto",
              traced: bool = False) -> dict:
    """examples/chaos_replay.py::chaos_run at this size: a fresh store,
    corruption injected, the trace replayed under CACHE with stalls and
    retries; host wall and the guard's share of it. `traced` attaches a
    Tracer and an SLOMonitor(OBS_TARGET, cadence half the SLA), as
    tests/test_obs_analysis.py's monitored_chaos_run does, flushes the
    burn windows past the last completion and adds the analysis under
    "obs" and the exports under "exports"."""
    from repro_torch.obs import SLOMonitor, Tracer, waterfall_query
    from repro_torch.query import physical
    from repro_torch.resilience import (ChaosHarness, ChunkGuard, FaultSpec,
                                        RetryPolicy)
    from repro_torch.store import EncodedTable
    from repro_torch.tier import Policy, paper_tiers, replay_trace
    encoded = EncodedTable.from_table(table, chunk_rows=CHAOS_CHUNK_ROWS)
    tiers = paper_tiers(table.nbytes * 0.25, fast_gbps=CHAOS_FAST_GBPS)
    clean_s = (encoded.nbytes
               / sum(len(c.chunks) for c in encoded.columns.values())
               / tiers.fast.bandwidth)
    chaos = ChaosHarness(FaultSpec(**CHAOS_SPEC),
                         guard=ChunkGuard(encoded), recover=recover,
                         retry=RetryPolicy(timeout_s=2.0 * clean_s,
                                           backoff_s=0.5 * clean_s,
                                           max_retries=2))
    corrupted = chaos.inject_corruption()
    bytes_typ = sum(physical.referenced_bytes(tq.query.plan(),
                                              tq.query.aggregates,
                                              encoded.columns)
                    for tq in trace) / len(trace)
    sla_s = CHAOS_SLA_SLACK * bytes_typ / tiers.fast.bandwidth
    tracer = Tracer() if traced else None
    monitor = (SLOMonitor(target=OBS_TARGET, cadence_s=sla_s / 2)
               if traced else None)
    with GuardClock() as gc, ObsClock() as oc:
        t0 = time.perf_counter()
        pe, eng, att = replay_trace(encoded, trace, tiers, Policy.CACHE,
                                    sla_s=sla_s,
                                    chunk_rows=CHAOS_CHUNK_ROWS,
                                    chaos=chaos, mode=mode, tracer=tracer,
                                    monitor=monitor)
        wall = time.perf_counter() - t0
    s = chaos.summary()
    answers = [(r.qid, r.degraded, r.aggregates) for r in eng.results]
    rec = {"attainment": att, "summary": s,
           "recovery_j": pe.meter.recovery_j, "answers": answers,
           "corrupted": len(corrupted),
           "ledger": [c.as_dict() for c in pe.meter.charges],
           "wall_s": wall, "verify_s": gc.seconds["check"]}
    print(f"recover={recover!s:5s} {mode:9s} attainment {att:.4f}  stalls "
          f"{s['stalls']} retries {s['retries']} failovers "
          f"{s['failovers']} repairs {s['repairs']} degraded "
          f"{s['degraded_queries']}  recovery {rec['recovery_j'] * 1e6:.4f} "
          f"uJ  mttr {s['mttr_s']}  corrupted {len(corrupted)}  host "
          f"{wall:.3f} s, verify {rec['verify_s']:.3f} s "
          f"({rec['verify_s'] / wall:.4f} of it)", flush=True)
    if traced:
        monitor.tick(eng.clock() + monitor.max_window_s)
        rec["obs"], rec["exports"], attr = obs_analysis(
            f"chaos {mode}", tracer, monitor, pe, eng, wall)
        rec["obs"]["host"] = obs_costs(oc, len(eng.results),
                                       rec["obs"]["spans"])
        print(f"chaos {mode}: tracer and monitor host "
              f"{json.dumps(rec['obs']['host'])}", flush=True)
        noisy = max(tracer.queries, key=lambda qt: sum(
            n for k, n in qt.span_kinds().items() if k in FAULT_SPANS))
        rec["exports"]["waterfall"] = waterfall_query(noisy, width=56)
        rec["whatif"] = obs_whatif(attr, table, bytes_typ, sla_s, pe)
        rec["noisy_qid"] = noisy.qid
    del encoded, chaos, pe, eng
    return rec


def chaos_phase(dev: dict, fast_gbps: float) -> tuple:
    """examples/chaos_replay.py scaled up: two same-seed replays must
    agree to the bit, the no-recovery replay must attain less and answer
    exactly wherever it answers, the torch_ref replay's ledger must equal
    the kernels'; then shard losses over the 8-shard tiered main table.
    The second replay and the torch_ref one are traced and monitored
    (the first and the no-recovery one are not, so the first-vs-second
    check shows tracing moves no number): their exports must be equal,
    check and verify must pass. The shard-loss kernel replay is traced
    too. Returns the sharded slice's record and the observability
    phase's."""
    phase("chaos")
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.obs import Tracer
    from repro_torch.query import ShardedTable
    from repro_torch.resilience import ChaosHarness, FaultSpec
    from repro_torch.tier import (Policy, TraceSpec, make_trace, paper_tiers,
                                  replay_trace)
    table = build_chaos_table()
    trace = make_trace(table, TraceSpec(n_queries=CHAOS_QUERIES, skew=1.2,
                                        seed=11))
    print(f"chaos store: {CHAOS_COLS} x {CHAOS_ROWS} rows, chunk_rows "
          f"{CHAOS_CHUNK_ROWS}, {CHAOS_QUERIES} queries, {CHAOS_SPEC}",
          flush=True)
    counters = reset_counters()
    first = chaos_run(table, trace, True)
    before = read_counters(counters)
    second = chaos_run(table, trace, True, traced=True)
    traced_launches = {k: n - before[k]
                       for k, n in read_counters(counters).items()}
    off = chaos_run(table, trace, False)
    plain = chaos_run(table, trace, True, mode="torch_ref", traced=True)
    launches = read_counters(counters)
    bad = []
    keys = ("attainment", "summary", "recovery_j", "answers", "ledger")
    for other, label in ((second, "second replay"), (plain, "torch_ref")):
        diff = [k for k in keys if first[k] != other[k]]
        if diff:
            bad.append((label, diff))
    if not off["attainment"] < first["attainment"]:
        bad.append(("recover=False attains", off["attainment"],
                    first["attainment"]))
    exact = {qid: a for qid, _, a in first["answers"]}
    wrong = [qid for qid, d, a in off["answers"] if not d and a != exact[qid]]
    if wrong:
        bad.append(("recover=False answers differ", wrong))
    if first["summary"]["degraded_queries"] or \
            not first["summary"]["repairs"] or \
            not off["summary"]["degraded_queries"]:
        bad.append(("fault counts", first["summary"], off["summary"]))
    diff = [k for k in second["exports"]
            if second["exports"][k] != plain["exports"][k]]
    if diff:
        bad.append(("chaos exports differ between auto and torch_ref", diff))
    print(f"kernel launches in the chaos replays: {launches}; in the "
          f"traced auto replay: {traced_launches}")
    fires = second["obs"]["fires"]
    print(f"alerts: {second['obs']['alerts']} ({fires}) at attainment "
          f"{second['attainment']:.4f} against target {OBS_TARGET}")
    if not fires.get("fast_burn"):
        print(f"FINDING: no fast_burn alert fired at attainment "
              f"{second['attainment']:.4f} against {OBS_TARGET} (the rule "
              f"is left as it is)")
    lines = second["exports"]["waterfall"].splitlines()
    print(f"most fault-afflicted query q{second['noisy_qid']} "
          f"({len(lines) - 1} spans; the first {WATERFALL_LINES} lines):")
    print("\n".join(lines[:WATERFALL_LINES + 1]))
    print_whatif(second["whatif"])
    obs = {"chaos": {"auto": second["obs"], "torch_ref": plain["obs"],
                     "whatif": {k: second["whatif"][k]
                                for k in ("current", "best")},
                     "noisy_qid": second["noisy_qid"],
                     "launches": traced_launches}}
    del table, trace
    release()

    tier_table = build_tier_table()
    st = ShardedTable.shard(tier_table, make_mesh((8,), ("data",)))
    trace = make_trace(tier_table, TraceSpec(n_queries=CHAOS_QUERIES,
                                             skew=1.1, seed=TIER_SEED))
    tiers = paper_tiers(tier_table.nbytes * TIER_FAST_FRACTION,
                        fast_gbps=fast_gbps)
    want = torch_ref_answers(tier_table, trace)
    counters = reset_counters()
    loss = {}
    for mode in ("auto", "torch_ref"):
        chaos = ChaosHarness(FaultSpec(**SHARD_LOSS_SPEC))
        tracer = Tracer() if mode == "auto" else None
        t0 = time.perf_counter()
        pe, eng, att = replay_trace(st, trace, tiers, Policy.CACHE,
                                    sla_s=sla_of(tier_table, trace, tiers),
                                    chunk_rows=TIER_CHUNK_ROWS, chaos=chaos,
                                    mode=mode, tracer=tracer)
        wall = time.perf_counter() - t0
        s = chaos.summary()
        wrong = [r.qid for r in eng.results
                 if r.degraded or r.aggregates != want[r.qid - 1]]
        if wrong:
            bad.append(("shard loss answers", mode, wrong))
        loss[mode] = {"attainment": att, "summary": s, "wall_s": wall,
                      "recovery_j": pe.meter.recovery_j,
                      "recovery_bytes": pe.recovery_bytes_total,
                      "ledger": [c.as_dict() for c in pe.meter.charges]}
        print(f"shard loss {mode:9s} 8 shards: attainment {att:.4f}  "
              f"losses {s['shard_losses']} recoveries "
              f"{s['shard_recoveries']}  recovery bytes "
              f"{pe.recovery_bytes_total}  recovery "
              f"{pe.meter.recovery_j * 1e3:.4f} mJ  host {wall:.3f} s",
              flush=True)
        if mode == "auto":
            loss_launches = read_counters(counters)
            obs["shard_loss"], _, _ = obs_analysis(
                "shard loss auto", tracer, None, pe, eng, wall)
            obs["shard_loss"]["launches"] = loss_launches
            if not obs["shard_loss"]["span_kinds"].get("shard_failover"):
                bad.append(("no shard_failover span in the traced "
                            "shard-loss replay",))
    a, b = loss["auto"], loss["torch_ref"]
    if [a[k] for k in ("attainment", "summary", "recovery_j", "ledger")] \
            != [b[k] for k in ("attainment", "summary", "recovery_j",
                               "ledger")]:
        bad.append(("shard loss: torch_ref ledger differs",))
    s = a["summary"]
    if not s["shard_losses"] or s["shard_recoveries"] != s["shard_losses"]:
        bad.append(("shard loss counts", s))
    print(f"kernel launches in the shard-loss replay: {loss_launches}")
    if bad:
        for x in bad:
            print("MISMATCH", str(x)[:2000], file=sys.stderr)
        fail(f"{len(bad)} chaos checks failed")
    del st, tier_table
    release()
    strip = ("answers", "ledger", "obs", "exports", "whatif", "noisy_qid")
    return {"store": {k: {f: v for f, v in r.items() if f not in strip}
                      for k, r in (("recover", first), ("again", second),
                                   ("no_recovery", off),
                                   ("torch_ref", plain))},
            "launches": launches,
            "shard_loss": {k: {f: v for f, v in r.items() if f != "ledger"}
                           for k, r in loss.items()},
            "shard_loss_launches": loss_launches}, obs


# --------------------------------------------------------------------------
# observability: the tracer's audit, critical path, exports, the SLO monitor
# --------------------------------------------------------------------------

OBS_TARGET = 0.9           # tests/test_obs_analysis.py's SLO target
FAULT_SPANS = ("retry", "failover", "repair", "stall", "prefetch_stall")
WATERFALL_LINES = 24       # lines of the fault-afflicted query printed
OBS_SMALL_ROWS = 8192      # monitored_chaos_run's scenario (8 columns,
OBS_SMALL_CHUNK_ROWS = 512  # 512-row chunks, 40 queries), card and CPU
OBS_SMALL_QUERIES = 40


class ObsClock(HostClock):
    """Host seconds in the tracer (QueryTrace's emission, begin_query,
    the engine's span layout and launch spans) and in the SLO monitor
    (its intake and ticks), each call counted once at its outermost
    frame (QueryTrace.read calls add; layout_pipeline calls add)."""

    def __init__(self):
        from repro_torch.obs.slo import SLOMonitor
        from repro_torch.obs.trace import QueryTrace, Tracer
        from repro_torch.query import engine
        self.group, self.targets = {}, []
        for owner, names, group in (
                (QueryTrace, ("begin_run", "add", "read", "compute",
                              "close"), "tracer"),
                (Tracer, ("begin_query",), "tracer"),
                (engine, ("layout_sync", "layout_pipeline"), "tracer"),
                (engine.QueryEngine, ("_emit_launches",), "tracer"),
                (SLOMonitor, ("tick", "observe", "observe_rejected"),
                 "monitor")):
            for name in names:
                self.targets.append((owner, name))
                self.group[name] = group
        self.seconds = {"tracer": 0.0, "monitor": 0.0}
        self.depth = 0

    def wrap(self, name, fn):
        group = self.group[name]

        def timed(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[group] += time.perf_counter() - t0
                self.depth -= 1
        return timed


def obs_costs(oc: ObsClock, served: int, spans: int) -> dict:
    """ObsClock's seconds as host ms a served query and µs a span."""
    n = max(served, 1)
    return {"tracer_ms_a_query": oc.seconds["tracer"] / n * 1e3,
            "monitor_ms_a_query": oc.seconds["monitor"] / n * 1e3,
            "tracer_us_a_span": oc.seconds["tracer"] / max(spans, 1) * 1e6,
            "tracer_s": oc.seconds["tracer"],
            "monitor_s": oc.seconds["monitor"]}


def sha256(text: str) -> str:
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()


def obs_analysis(label: str, tracer, monitor, pe, eng,
                 wall: float) -> tuple:
    """check and verify over a traced replay (each raises
    ConservationError at the first mismatch), the critical-path
    attribution, the alert stream, and the exports (Chrome trace JSON,
    alerts JSON, digest) with the host seconds each step took. Returns
    (record, exports, attribution)."""
    from repro_torch.obs import check, chrome_trace_json, digest, verify
    t0 = time.perf_counter()
    check(tracer, pe.meter)
    attr = verify(tracer, pe.meter)
    analysis_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exports = {"chrome_trace_json": chrome_trace_json(tracer),
               "digest": json.dumps(digest(eng, tracer), sort_keys=True,
                                    separators=(",", ":"))}
    if monitor is not None:
        exports["alerts_json"] = monitor.alerts_json()
    export_s = time.perf_counter() - t0
    summary = tracer.summary()
    rec = {"queries": attr.queries, "missed": attr.missed,
           "spans": summary["spans"], "span_kinds": summary["span_kinds"],
           "seconds": attr.seconds, "fractions": attr.fractions(),
           "miss_fractions": attr.fractions(missed_only=True),
           "replay_wall_s": wall, "analysis_s": analysis_s,
           "export_s": export_s,
           "exports": {k: {"bytes": len(v), "sha256": sha256(v)}
                       for k, v in exports.items()}}
    if monitor is not None:
        fires: dict = {}
        for a in monitor.alerts:
            if a.kind == "fire":
                fires[a.rule] = fires.get(a.rule, 0) + 1
        rec.update(alerts=len(monitor.alerts), fires=fires,
                   ticks=monitor.summary()["ticks"],
                   budgets={t: monitor.error_budget(t)
                            for t in sorted(monitor.tenants)})
    fr = " ".join(f"{k} {v:.4f}" for k, v in rec["fractions"].items())
    mf = " ".join(f"{k} {v:.4f}" for k, v in rec["miss_fractions"].items())
    print(f"{label}: check + verify OK over {attr.queries} queries, "
          f"{summary['spans']} spans ({analysis_s:.3f} s); path fractions "
          f"{fr}; of SLA-miss time ({attr.missed} missed) {mf or '-'}; "
          f"alerts {rec.get('alerts', '-')} {rec.get('fires', '')}; "
          f"exports {export_s:.3f} s: "
          + ", ".join(f"{k} {v['bytes']} B sha256 {v['sha256'][:16]}"
                      for k, v in rec["exports"].items()), flush=True)
    return rec, exports, attr


def obs_whatif(attr, table, bytes_per_query: float, sla_s: float,
               pe) -> dict:
    """examples/slo_monitor.py's step 4: the attribution turned into the
    estimated gain from a bigger fast tier (raises if the what-if model
    drifts from advise_tier_split)."""
    from repro_torch.core.advisor import whatif_fast_fraction
    from repro_torch.tier import zipf_hit_curve
    return whatif_fast_fraction(
        attr, db_bytes=table.nbytes, bytes_per_query=bytes_per_query,
        sla_s=sla_s, current_fraction=0.25,
        hit_curve=zipf_hit_curve(CHAOS_COLS, 1.2),
        fast_gbps=pe.tiers.fast.gbps, capacity_gbps=pe.tiers.capacity.gbps)


def print_whatif(wi: dict) -> None:
    cur, best = wi["current"], wi["best"]
    print(f"what-if: current fraction {cur['fast_fraction']:.2f} -> "
          f"response {cur['response_s'] * 1e3:.3f} ms (read "
          f"{cur['read_s'] * 1e3:.3f}, other {cur['other_s'] * 1e3:.3f})")
    if best is not None:
        print(f"  first SLA-meeting fraction {best['fast_fraction']:.2f} "
              f"(est response {best['est_response_s'] * 1e3:.3f} ms, gain "
              f"{best['est_gain_s'] * 1e3:+.3f} ms/query)")
    else:
        top = wi["rows"][-1]
        print(f"  no fraction meets the SLA; f={top['fast_fraction']:.2f} "
              f"estimates {top['est_response_s'] * 1e3:.3f} ms")


def accounting(pe, eng, att) -> dict:
    """What tracing and monitoring must not move: attainment, rejected
    qids, the ledger, placement stats, tier dicts and the summary
    without its trace and slo sections."""
    return {"attainment": att, "rejected": eng.rejected,
            "ledger": [c.as_dict() for c in pe.meter.charges],
            "stats": pe.stats(),
            "tier": [r.tier for r in eng.results],
            "summary": {k: v for k, v in eng.summary().items()
                        if k not in ("trace", "slo")}}


def obs_replay(label: str, table, trace, tiers, policy, *, traced: bool,
               mode: str, cadence_s: float, **kw) -> dict:
    """One replay_trace, traced and monitored (SLOMonitor(OBS_TARGET,
    cadence_s), windows flushed after the last completion) or not; host
    wall, kernel launches, accounting, and, traced, the analysis and the
    exports."""
    from repro_torch.obs import SLOMonitor, Tracer
    from repro_torch.tier import replay_trace
    tracer = Tracer() if traced else None
    monitor = (SLOMonitor(target=OBS_TARGET, cadence_s=cadence_s)
               if traced else None)
    counters = reset_counters()
    with ObsClock() as oc:
        t0 = time.perf_counter()
        pe, eng, att = replay_trace(table, trace, tiers, policy,
                                    chunk_rows=TIER_CHUNK_ROWS, mode=mode,
                                    tracer=tracer, monitor=monitor, **kw)
        wall = time.perf_counter() - t0
    out = {"wall_s": wall, "launches": read_counters(counters),
           "accounting": accounting(pe, eng, att),
           "answers": [(r.qid, r.aggregates) for r in eng.results]}
    print(f"{label} {mode:9s} traced={traced!s:5s} attainment "
          f"{'-' if att is None else f'{att:.4f}'} served "
          f"{eng.summary()['served']} host {wall:.3f} s "
          f"({wall / len(trace) * 1e3:.3f} ms a query); launches "
          f"{ {k: n for k, n in out['launches'].items() if n} }",
          flush=True)
    if traced:
        monitor.tick(eng.clock() + monitor.max_window_s)
        out["obs"], out["exports"], _ = obs_analysis(
            f"{label} {mode}", tracer, monitor, pe, eng, wall)
        out["obs"]["host"] = obs_costs(oc, len(eng.results),
                                       out["obs"]["spans"])
        print(f"{label} {mode}: tracer and monitor host "
              f"{json.dumps(out['obs']['host'])}", flush=True)
    return out


def obs_compare(label: str, kernel: dict, ref: dict, untraced: dict,
                bad: list) -> dict:
    """The traced kernel replay against the traced torch_ref one
    (exports byte for byte, answers) and against the untraced kernel
    replay (accounting); the record of the pair."""
    diff = [k for k in kernel["exports"]
            if kernel["exports"][k] != ref["exports"][k]]
    if diff:
        bad.append((label, "exports differ between auto and torch_ref",
                    diff))
    if kernel["answers"] != ref["answers"]:
        bad.append((label, "answers differ between auto and torch_ref"))
    for other, what in ((ref, "torch_ref"), (untraced, "untraced")):
        diff = [k for k in kernel["accounting"]
                if kernel["accounting"][k] != other["accounting"][k]]
        if diff:
            bad.append((label, f"traced accounting differs from {what}",
                        diff))
    extra = kernel["wall_s"] - untraced["wall_s"]
    n = len(kernel["answers"]) or 1
    rec = {"auto": kernel["obs"], "torch_ref": ref["obs"],
           "wall_s": {"traced": kernel["wall_s"],
                      "untraced": untraced["wall_s"],
                      "torch_ref_traced": ref["wall_s"]},
           "tracing_host_ms_a_query": extra / n * 1e3,
           "tracing_host_us_a_span": extra / kernel["obs"]["spans"] * 1e6,
           "launches": kernel["launches"],
           "attainment": kernel["accounting"]["attainment"]}
    print(f"{label}: traced {kernel['wall_s']:.3f} s against untraced "
          f"{untraced['wall_s']:.3f} s host: "
          f"{rec['tracing_host_ms_a_query']:.3f} ms a served query, "
          f"{rec['tracing_host_us_a_span']:.3f} us a span "
          f"({kernel['obs']['spans']} spans, "
          f"{kernel['obs']['span_kinds'].get('read', 0)} of them chunk "
          f"reads)", flush=True)
    return rec


def obs_tiered_phase(tier: dict, store_table, encoded, dev: dict) -> dict:
    """(a) The tiered main cell at full size through the replay that
    fills the most categories: the grouped mix at skew 1.1 under CACHE,
    prefetch on, the die-stacked chip's 96 W compute term under the
    tiered main phase's cap (half the uncapped demand, window 20 SLAs):
    traced and monitored in auto and in torch_ref, then untraced in
    auto. Then the tiered store cell's encoded replay, traced and
    monitored in both modes, against its untraced record."""
    phase("observability (tiered)")
    from repro_torch.core import DIE_STACKED
    from repro_torch.energy import PowerCap, chip_compute_watts
    from repro_torch.tier import TraceSpec, make_trace, paper_tiers
    print(f"[{dev['smi']}]")
    table = build_tier_table()
    tiers = paper_tiers(TIER_FAST_FRACTION * table.nbytes,
                        fast_gbps=tier["main"]["fast_gbps"])
    trace = make_trace(table, TraceSpec(n_queries=TIER_QUERIES, skew=1.1,
                                        seed=TIER_SEED, p_grouped=0.1,
                                        p_join=0.05))
    sla_s = sla_of(table, trace, tiers)
    unc = tier["main"]["replays"]["compute"]
    budget_w = 0.5 * unc["total_j"] / unc["seconds_total"]
    kw = dict(sla_s=sla_s, prefetch_bytes=int(tiers.fast.capacity // 8),
              compute_w=chip_compute_watts(DIE_STACKED))
    print(f"grouped mix, skew 1.1, cache, prefetch, cap {budget_w:.4f} W "
          f"over {20 * sla_s * 1e3:.4f} ms; sla {sla_s * 1e3:.4f} ms",
          flush=True)
    runs = {}
    for key, mode, traced in (("kernel", "auto", True),
                              ("torch_ref", "torch_ref", True),
                              ("untraced", "auto", False)):
        runs[key] = obs_replay(
            "tiered main", table, trace, tiers, "cache", traced=traced,
            mode=mode, cadence_s=sla_s / 2,
            power_cap=PowerCap(budget_w, window_s=20 * sla_s), **kw)
    bad: list = []
    out = {"main": obs_compare("tiered main", runs["kernel"],
                               runs["torch_ref"], runs["untraced"], bad)}
    out["main"]["cap_w"] = budget_w
    zero = [k for k in ("scan_filter", "aggregate", "scan_aggregate",
                        "group_sum_count_batched")
            if not runs["kernel"]["launches"][k]]
    if zero:
        bad.append(("kernels never launched in the traced tiered main "
                    "replay", zero))
    del table, runs
    release()

    # no deadlines, as the tiered store phase replays it; the monitor
    # ticks at half the mean query's all-fast time
    tiers, trace = store_tier_trace(store_table, tier["main"]["fast_gbps"])
    cadence_s = sla_of(store_table, trace, tiers) / TIER_SLA_SLACK / 2
    runs = {mode: obs_replay("tiered store", encoded, trace, tiers,
                             "cache", traced=True, mode=mode,
                             cadence_s=cadence_s)
            for mode in ("auto", "torch_ref")}
    enc = tier["store"]["encoded"]
    acc = runs["auto"]["accounting"]
    # the untraced record of the tiered store phase
    got = (acc["attainment"], acc["stats"]["fast_bytes"],
           acc["stats"]["capacity_bytes"], acc["summary"]["energy"]
           ["total_j"])
    want = (enc["attainment"], enc["fast_bytes"], enc["capacity_bytes"],
            enc["total_j"])
    if got != want:
        bad.append(("tiered store: traced accounting differs from the "
                    "untraced replay", got, want))
    diff = [k for k in runs["auto"]["exports"]
            if runs["auto"]["exports"][k] != runs["torch_ref"]["exports"][k]]
    if diff or runs["auto"]["answers"] != runs["torch_ref"]["answers"]:
        bad.append(("tiered store: auto and torch_ref differ", diff))
    zero = [k for k in ("aggregate_batched", "scan_aggregate_batched",
                        "rle_scan_aggregate_batched",
                        "rle_group_accumulate_batched")
            if not runs["auto"]["launches"][k]]
    if zero:
        bad.append(("kernels never launched in the traced tiered store "
                    "replay", zero))
    out["store"] = {"auto": runs["auto"]["obs"],
                    "torch_ref": runs["torch_ref"]["obs"],
                    "launches": runs["auto"]["launches"]}
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} observability (tiered) checks failed")
    return out


def obs_small_run(device: str, mode: str) -> dict:
    """tests/test_obs_analysis.py's monitored_chaos_run on `device`: a
    seeded fault replay (8 columns x OBS_SMALL_ROWS rows, 512-row chunks)
    with a Tracer and an SLOMonitor; the exports and the waterfall."""
    from repro_torch.db import Table
    from repro_torch.obs import SLOMonitor, Tracer, waterfall
    from repro_torch.query import physical
    from repro_torch.resilience import (ChaosHarness, ChunkGuard, FaultSpec,
                                        RetryPolicy)
    from repro_torch.store import EncodedTable
    from repro_torch.tier import (Policy, TraceSpec, make_trace, paper_tiers,
                                  replay_trace)
    table = Table.synthetic("events", OBS_SMALL_ROWS,
                            {f"c{i:02d}": 8 for i in range(CHAOS_COLS)},
                            seed=0, device=device)
    enc = EncodedTable.from_table(table, chunk_rows=OBS_SMALL_CHUNK_ROWS)
    tiers = paper_tiers(table.nbytes * 0.25, fast_gbps=CHAOS_FAST_GBPS)
    qtrace = make_trace(table, TraceSpec(n_queries=OBS_SMALL_QUERIES,
                                         skew=1.2, seed=11))
    clean_s = (enc.nbytes
               / sum(len(c.chunks) for c in enc.columns.values())
               / tiers.fast.bandwidth)
    chaos = ChaosHarness(FaultSpec(**CHAOS_SPEC), guard=ChunkGuard(enc),
                         retry=RetryPolicy(timeout_s=2.0 * clean_s,
                                           backoff_s=0.5 * clean_s,
                                           max_retries=2))
    chaos.inject_corruption()
    bytes_typ = sum(physical.referenced_bytes(tq.query.plan(),
                                              tq.query.aggregates,
                                              enc.columns)
                    for tq in qtrace) / len(qtrace)
    sla_s = CHAOS_SLA_SLACK * bytes_typ / tiers.fast.bandwidth
    tracer = Tracer()
    monitor = SLOMonitor(target=OBS_TARGET, cadence_s=sla_s / 2)
    t0 = time.perf_counter()
    pe, eng, att = replay_trace(
        enc, qtrace, tiers, Policy.CACHE, sla_s=sla_s,
        chunk_rows=OBS_SMALL_CHUNK_ROWS, chaos=chaos,
        prefetch_bytes=table.nbytes // 16, tracer=tracer, monitor=monitor,
        mode=mode)
    wall = time.perf_counter() - t0
    monitor.tick(eng.clock() + monitor.max_window_s)
    rec, exports, _ = obs_analysis(f"small chaos on {device} ({mode})",
                                   tracer, monitor, pe, eng, wall)
    exports["waterfall"] = waterfall(tracer)
    rec["exports"]["waterfall"] = {"bytes": len(exports["waterfall"]),
                                   "sha256": sha256(exports["waterfall"])}
    rec["attainment"] = att
    return {"rec": rec, "exports": exports}


def obs_devices_phase() -> dict:
    """(d) The same monitored chaos replay once on the card (auto) and
    once on the CPU (torch_ref) in this process: every export must be
    byte-identical."""
    phase("observability (card and CPU)")
    counters = reset_counters()
    card = obs_small_run("cuda", "auto")
    launches = read_counters(counters)
    cpu = obs_small_run("cpu", "torch_ref")
    diff = [k for k in card["exports"]
            if card["exports"][k] != cpu["exports"][k]]
    if diff:
        fail(f"the card's exports differ from the CPU's: {diff}")
    if not sum(launches.values()):
        fail("no kernel launched in the card's small chaos replay")
    print(f"card and CPU exports byte-identical: "
          + ", ".join(f"{k} {len(v)} B" for k, v in card["exports"].items())
          + f"; kernel launches on the card {launches}", flush=True)
    return {"cuda": card["rec"], "cpu": cpu["rec"], "launches": launches}


def obs_launches(obs: dict, name: str) -> dict:
    """Kernel `name`'s launches in each traced replay, for the
    {"kernels": ...} line's "launches_obs"."""
    runs = {"tiered main": obs["tiered"]["main"]["launches"],
            "tiered store": obs["tiered"]["store"]["launches"],
            "chaos": obs["chaos"]["launches"],
            "shard loss": obs["shard_loss"]["launches"],
            "small chaos": obs["devices"]["launches"]}
    return {k: v[name] for k, v in runs.items() if v.get(name)}


# --------------------------------------------------------------------------
# the training slice: losses, AdamW, the train and eval steps; kernels 11
# and 12 run forward under autograd, their backward differentiates the
# plain versions
# --------------------------------------------------------------------------

TRAIN_OPT = dict(lr=5e-3, warmup_steps=1, decay_steps=100)   # as in
                                     # tests/test_models_smoke.py
# At full width Adam's first steps move every weight by about lr (its
# update is a sign), and 5e-3 is a quarter of a fan-in-2048 weight's
# standard deviation: on an H100 (bf16, 1 x 2048) mamba2-1.3b's loss
# rose again after step 3 (11.13, 10.24, 8.05, 9.20, 12.43) and
# internlm2-1.8b's swung.
# The full-width phases take AdamWConfig's own peak rate instead.
TRAIN_FULL_OPT = dict(lr=3e-4, warmup_steps=1, decay_steps=100)
TRAIN_STEPS = 5
TRAIN_PARITY = (("internlm2-1.8b", 64), ("mamba2-1.3b", 0),
                ("recurrentgemma-2b", 256), ("mixtral-8x22b", 64),
                ("moonshot-v1-16b-a3b", 64))   # (arch, head_dim: 0 = none)
TRAIN_PARITY_BS = (2, 256)
# Kernel path against plain path on the card, same weights and batch.
# The loss, ce and aux: |kernel - plain| <= LOSS_TOL * max(1, |plain|).
# Each gradient leaf, by its relative norm error err(g, o) = ||g - o|| /
# ||o||:
# - float32: err(kernel, plain) <= GRAD_TOL. Kernel 11's CUDA-core route
#   and the naive path both compute in fp32 and differ by summation order
#   (~1e-6); kernel 12's fp32 route sums its log-decays in another order
#   than torch.cumsum, ~1e-4 of a weight at the reduced chunk of 32 (see
#   SSD_TOL). 2e-3 leaves ten times that; a missing or wrong gradient
#   term is of order 1.
# - bfloat16: the two paths round differently by design (the kernels
#   round their outputs to bf16; the naive path also rounds its
#   probabilities and runs its backward products in bf16, where _Flash5
#   and _SSD differentiate the fp32 plain versions), and a router's
#   gradient, a difference of near-equal terms, keeps few of bf16's bits
#   (its error reaches 0.2 of its norm on the plain path alone). So each
#   bf16 path is held against an fp32 oracle, the plain path on the same
#   weights cast to fp32: err(kernel, oracle) <= BF16_X * err(plain,
#   oracle) + BF16_FLOOR. The kernel path may be at most twice as far
#   from the oracle as bf16's plain arithmetic, plus a few bf16 units.
LOSS_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
GRAD_TOL = 2e-3
BF16_X, BF16_FLOOR = 2.0, 2.0 ** -6
TRAIN_FULL = (("internlm2-1.8b", 4096), ("mamba2-1.3b", 2048))  # (arch, S)
# The reference's remat modes, each run on a train phase's state and batch
# (`train remat`): the forward and backward of every mode from the same
# state, bit for bit alike, then one update; REMAT_STEPS such steps.
REMAT_MODES = ("none", "block", "dots")
REMAT_STEPS = 3
# mamba2-1.3b at the reference's train_4k sequence length under "block":
# a batch that keeping every activation ("none") cannot hold on the card
REMAT_LONG = ("mamba2-1.3b", 4, 4096)       # (arch, B, S)
REMAT_LONG_STEPS = 3


def launches_a_step(cfg) -> int:
    """Kernel 11 or 12 launches of one train step: once a layer in the
    forward, and once more in the recompute of a rematerialised block
    (every remat mode but "none"; repro_torch.models.remat)."""
    return cfg.num_layers * (1 if cfg.remat == "none" else 2)


class plain_ssd:
    """Every SSD op under mode="torch_ref" inside the block (ssm.apply's
    mode= reaches one block; the step runs the whole stack)."""

    def __enter__(self):
        from repro_torch.kernels.ssd_chunk import ops
        self.ops, self.real = ops, ops.ssd
        ops.ssd = lambda *a, mode=None, **k: self.real(*a, mode="torch_ref",
                                                      **k)

    def __exit__(self, *exc):
        self.ops.ssd = self.real


def train_config(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), attn_impl="flash")


def train_batch(cfg, b: int, s: int, seed: int) -> dict:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab_size, (b, s), generator=g,
                             device="cuda", dtype=torch.int32)
            for k in ("inputs", "labels")}


def clone_state(state: dict) -> dict:
    return {"params": copy.deepcopy(state["params"]),
            "opt": {k: (v.clone() if torch.is_tensor(v) else
                        {n: t.clone() for n, t in v.items()})
                    for k, v in state["opt"].items()},
            "step": state["step"].clone()}


def train_parity_case(arch: str, head_dim: int, dtype) -> dict:
    """One reduced family in one dtype: kernel path (attn_impl="flash",
    the SSD under auto) against plain path (attn_impl="naive", the SSD
    under torch_ref) on the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.train import optim, step
    over = {"dtype": "bfloat16" if dtype == torch.bfloat16 else "float32"}
    if head_dim:
        over["head_dim"] = head_dim
    cfg = dataclasses.replace(get_config(arch).reduced(**over),
                              attn_impl="flash")
    opt_cfg = optim.AdamWConfig(**TRAIN_OPT)
    state, _ = step.init_state(SEED, cfg, opt_cfg, device="cuda")
    model = state["params"]
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith("router_bias"):     # selection != weights
                p.normal_(0.0, 0.05, generator=torch.Generator(
                    device="cuda").manual_seed(SEED + 3))
    b, s = TRAIN_PARITY_BS
    batch = train_batch(cfg, b, s, SEED + 30)
    fk.LAUNCHES = sk.LAUNCHES = 0
    loss_k, parts_k, grads_k = step.value_and_grad(model, cfg, batch)
    torch.cuda.synchronize()
    launched = {"flash_attention": fk.LAUNCHES, "ssd_chunk": sk.LAUNCHES}
    want = {"flash_attention": any(k in ("attn", "swa")
                                   for k in cfg.block_pattern),
            "ssd_chunk": "ssd" in cfg.block_pattern}
    label = f"{arch} {over['dtype']}"
    for name, needed in want.items():
        if needed and not launched[name]:
            fail(f"train parity {label}: {name} never launched on the "
                 f"kernel path")
    unused = sorted(n for n, g in grads_k.items() if g is None)
    if any(not n.endswith("router_bias") for n in unused):
        fail(f"train parity {label}: trainable leaves with no gradient on "
             f"the kernel path: {unused}")
    with plain_ssd():
        loss_p, parts_p, grads_p = step.value_and_grad(
            model, dataclasses.replace(cfg, attn_impl="naive"), batch)
    rec = {"launches": launched, "no_grad": unused}
    for k, got, ref in (("loss", loss_k, loss_p),
                        ("ce", parts_k["ce"], parts_p["ce"]),
                        ("aux", parts_k["aux"], parts_p["aux"])):
        got, ref = float(got), float(ref)
        rec[k] = [got, ref]
        if not (math.isfinite(got) and abs(got - ref)
                <= LOSS_TOL[dtype] * max(1.0, abs(ref))):
            fail(f"train parity {label}: {k} {got} on the kernel path, "
                 f"{ref} on the plain path")
    def err(a, o):
        return float((a.float() - o.float()).norm()
                     / o.float().norm().clamp_min(1e-30))

    if dtype == torch.float32:
        errs = {n: err(g, grads_p[n]) for n, g in grads_k.items()
                if g is not None}
        limits = dict.fromkeys(errs, GRAD_TOL)
    else:
        with plain_ssd():
            _, _, grads_o = step.value_and_grad(
                copy.deepcopy(model).float(),
                dataclasses.replace(cfg, dtype="float32",
                                    attn_impl="naive"), batch)
        errs = {n: err(g, grads_o[n]) for n, g in grads_k.items()
                if g is not None}
        limits = {n: BF16_X * err(grads_p[n], grads_o[n]) + BF16_FLOOR
                  for n in errs}
        del grads_o
    worst = max(errs, key=lambda n: errs[n] / limits[n])
    rec["grad_rel_err"] = {n: [errs[n], limits[n]] for n in errs}
    rec["grad_worst_leaf"] = worst
    if not errs[worst] <= limits[worst]:
        fail(f"train parity {label}: gradient of {worst} differs by "
             f"{errs[worst]} of its norm (limit {limits[worst]})")
    # one AdamW step from identical gradients on two copies: equal
    zeros = {n: torch.zeros_like(p) if grads_p[n] is None else grads_p[n]
             for n, p in model.named_parameters()}
    twin = clone_state(state)
    optim.apply_updates(model, zeros, state["opt"], opt_cfg)
    optim.apply_updates(twin["params"], zeros, twin["opt"], opt_cfg)
    if not all(torch.equal(p, q) for p, q in zip(
            model.parameters(), twin["params"].parameters())):
        fail(f"train parity {label}: apply_updates from identical "
             f"gradients gave different parameters")
    # two microbatches against their halves (and, without experts, one
    # whole batch: an MoE aux loss is a product of batch means)
    del twin
    two = clone_state(state)
    _, m2 = step.make_train_step(cfg, opt_cfg, 2)(two, batch)
    halves = [step.value_and_grad(model, cfg, {k: v[i:i + 1] for k, v in
                                               batch.items()})[0]
              for i in range(b)]
    mean = float(sum(halves)) / b
    rec["microbatch_loss"] = [float(m2["loss"]), mean]
    if abs(float(m2["loss"]) - mean) > LOSS_TOL[dtype] * max(1.0, mean):
        fail(f"train parity {label}: two microbatches' loss "
             f"{float(m2['loss'])}, their halves' mean {mean}")
    if not cfg.num_experts:
        _, m1 = step.make_train_step(cfg, opt_cfg, 1)(state, batch)
        rec["microbatch_grad_norm"] = [float(m2["grad_norm"]),
                                       float(m1["grad_norm"])]
        if abs(float(m2["grad_norm"]) - float(m1["grad_norm"])) > \
                LOSS_TOL[dtype] * float(m1["grad_norm"]):
            fail(f"train parity {label}: global norm over two "
                 f"microbatches {float(m2['grad_norm'])}, one batch "
                 f"{float(m1['grad_norm'])}")
    print(f"{label:34s} loss {rec['loss'][0]:.6f} / {rec['loss'][1]:.6f} "
          f"aux {rec['aux'][0]:.6f} / {rec['aux'][1]:.6f}  worst grad "
          f"{worst} {errs[worst]:.3e} (limit {limits[worst]:.3e})  "
          f"microbatches {rec['microbatch_loss'][0]:.6f} / "
          f"{rec['microbatch_loss'][1]:.6f}  launches {launched}  no "
          f"gradient: {unused}", flush=True)
    return rec


def train_parity_phase() -> dict:
    phase("parity (train step)")
    out = {}
    for arch, head_dim in TRAIN_PARITY:
        for dtype in (torch.bfloat16, torch.float32):
            out[f"{arch} {dtype}"] = train_parity_case(arch, head_dim, dtype)
            release()
    return out


def train_phase(arch: str, s: int, dev: dict) -> dict:
    """`arch` at its published widths and depth, bf16, attn_impl="flash",
    random weights from a seeded generator on the card: TRAIN_STEPS steps
    of make_train_step (TRAIN_FULL_OPT) on one fixed batch of 1 x s
    seeded random tokens,
    then one eval step and one profiled step, under the config's remat
    (the reference's default, "block"). The losses must be finite and
    fall; kernel 11 (attention) or 12 (SSD) must launch twice a layer a
    step (the forward and the recompute). Returns (the record, the state,
    the batch) for the remat phases."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.train import metrics, optim, step
    label = arch.split("-")[0]
    phase(f"train {label}")
    cfg = train_config(arch)
    opt_cfg = optim.AdamWConfig(**TRAIN_FULL_OPT)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = step.init_state(SEED, cfg, opt_cfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers {cfg.block_pattern}, "
          f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, "
          f"{n_params} trainable parameters with fp32 m, v and master "
          f"made in {time.perf_counter() - t0:.2f} s; batch 1 x {s}; "
          f"remat {cfg.remat}", flush=True)
    if n_params != cfg.param_count():
        fail("parameter count differs from the config's analytic count")
    batch = train_batch(cfg, 1, s, SEED + 40)
    fn = step.make_train_step(cfg, opt_cfg)
    shape = ShapeSpec(f"train_smoke_{s}", "train", s, 1)
    log_path = Path(__file__).resolve().parent / "build" / \
        f"train_metrics_{label}.jsonl"
    log_path.unlink(missing_ok=True)
    logger = metrics.MetricsLogger(log_path, cfg, shape, chips=1)
    kernel = "ssd_chunk" if "ssd" in cfg.block_pattern else \
        "flash_attention"
    mod = sk if kernel == "ssd_chunk" else fk
    losses, recs = [], []
    mod.LAUNCHES = 0
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        recs.append(logger.log(i + 1, sec, m))
        losses.append(recs[-1]["loss"])
        print(f"step {i + 1}: loss {recs[-1]['loss']:.6f} ce "
              f"{recs[-1]['ce']:.6f} grad_norm {recs[-1]['grad_norm']:.4f} "
              f"lr {recs[-1]['lr']:.3e} {sec * 1e3:.3f} ms", flush=True)
    launches = mod.LAUNCHES
    logger.close()
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"train {label}: losses {losses} are not finite and falling")
    want = launches_a_step(cfg) * TRAIN_STEPS
    if launches != want:
        fail(f"train {label}: {kernel} launched {launches} times in "
             f"{TRAIN_STEPS} steps, not {want} ({launches_a_step(cfg)} a "
             f"step under remat {cfg.remat!r})")
    peak = torch.cuda.max_memory_allocated()
    steady = recs[1:]
    step_s = statistics.median(r["step_s"] for r in steady)
    ev = step.make_eval_step(cfg)(state["params"], batch)
    if not math.isfinite(float(ev["loss"])):
        fail(f"train {label}: eval loss {float(ev['loss'])}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the wall excludes the profiler's start and stop
        t0 = time.perf_counter()
        state, _ = fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    names = SSD_KERNELS if kernel == "ssd_chunk" else \
        tuple(FLASH_KERNELS.values())
    ours_us = sum(r[0] for r in rows if any(k in r[2] for k in names))
    rec = {"arch": cfg.name, "batch": [1, s], "remat": cfg.remat,
           "losses": losses,
           "eval_loss": float(ev["loss"]),
           "step_s": [r["step_s"] for r in recs],
           "step_s_median_2_5": step_s, "tokens_per_s": s / step_s,
           "mfu": statistics.median(r["mfu"] for r in steady),
           "roofline_step_s": logger.roofline_step_s,
           "roofline_gap": step_s / logger.roofline_step_s,
           "peak_gib": peak / 2**30, "launches": {kernel: launches},
           "profiled_step_ms": wall_us / 1e3, "busy_share": busy_us / wall_us,
           "kernel_ms": ours_us / 1e3, "card": dev["smi"]}
    print(f"train {label} [{dev['smi']}]: step {step_s * 1e3:.3f} ms "
          f"(median of steps 2-{TRAIN_STEPS}), {rec['tokens_per_s']:.1f} "
          f"tokens/s, mfu {rec['mfu']:.4f}, roofline step "
          f"{logger.roofline_step_s * 1e3:.3f} ms (H100 row), roofline gap "
          f"{rec['roofline_gap']:.2f}; eval loss {rec['eval_loss']:.6f}; "
          f"peak device memory {rec['peak_gib']:.3f} GiB; {kernel} launches "
          f"{launches}", flush=True)
    print(f"profiled step: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms, busy share {rec['busy_share']:.4f}; "
          f"{kernel} {ours_us / 1e3:.3f} ms", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"  device {us / 1e3:10.3f} ms  x{count:5d}  {key[:100]}")
    return rec, state, batch


def bits_of(t):
    t = t.detach()
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def train_remat_phase(cfg, state, batch, dev: dict) -> dict:
    """The train phase's model, state and batch under each of REMAT_MODES
    for REMAT_STEPS steps: at each step every mode's loss and gradients
    from the same state (the first mode's kept to compare), then one
    AdamW update with them. Every loss, part and gradient leaf must be
    bit-identical across the modes (the recompute runs the same kernels
    on the same inputs), and kernel 11 or 12 must launch
    launches_a_step() times a step in each mode. Per mode: the peak of
    the forward and backward over what was allocated before it, and the
    median time of the forward and backward (the update, the same for
    every mode, is outside it)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.train import optim, step
    label = cfg.name.split("-")[0]
    phase(f"train remat {label}")
    mod, kernel = ((sk, "ssd_chunk") if "ssd" in cfg.block_pattern
                   else (fk, "flash_attention"))
    opt_cfg = optim.AdamWConfig(**TRAIN_FULL_OPT)
    named = dict(state["params"].named_parameters())
    per = {m: {"ms": [], "peak_bytes": [], "launches": []}
           for m in REMAT_MODES}
    losses, differ = [], {}
    for i in range(REMAT_STEPS):
        first = None
        for mode in REMAT_MODES:
            c = dataclasses.replace(cfg, remat=mode)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            n0 = mod.LAUNCHES
            t0 = time.perf_counter()
            loss, parts, grads = step.value_and_grad(state["params"], c,
                                                     batch)
            torch.cuda.synchronize()
            per[mode]["ms"].append((time.perf_counter() - t0) * 1e3)
            per[mode]["peak_bytes"].append(
                torch.cuda.max_memory_allocated() - before)
            per[mode]["launches"].append(mod.LAUNCHES - n0)
            if first is None:
                first = (loss, parts, grads)
                losses.append(float(loss))
                continue
            pairs = [("loss", loss, first[0])] + [
                (k, parts[k], first[1][k]) for k in parts] + [
                (n, g, first[2][n]) for n, g in grads.items()]
            for name, a, b in pairs:
                if (a is None) != (b is None) or (a is not None and not
                                                  torch.equal(bits_of(a),
                                                              bits_of(b))):
                    differ.setdefault(mode, []).append(name)
            del loss, parts, grads, pairs
        grads = {n: torch.zeros_like(named[n]) if g is None else g
                 for n, g in first[2].items()}
        optim.apply_updates(state["params"], grads, state["opt"], opt_cfg)
        state["step"] = state["step"] + 1
        del first, grads
    rec = {"arch": cfg.name, "batch": list(batch["labels"].shape),
           "steps": REMAT_STEPS, "losses": losses, "kernel": kernel,
           "differ": differ, "card": dev["smi"], "modes": {}}
    print(f"train remat {label} [{dev['smi']}]: batch "
          f"{rec['batch'][0]} x {rec['batch'][1]}, {REMAT_STEPS} steps, "
          f"losses {losses}; forward and backward by mode:", flush=True)
    for mode in REMAT_MODES:
        r = per[mode]
        m = {"fwd_bwd_ms": r["ms"],
             "fwd_bwd_ms_median": statistics.median(r["ms"]),
             "peak_bytes": max(r["peak_bytes"]),
             "launches_a_step": r["launches"]}
        rec["modes"][mode] = m
        print(f"  {mode:5s}: median {m['fwd_bwd_ms_median']:10.3f} ms "
              f"(steps {[round(x, 3) for x in r['ms']]}), peak over the "
              f"arguments {m['peak_bytes']} B "
              f"({m['peak_bytes'] / 2**30:.3f} GiB), {kernel} launches a "
              f"step {r['launches']}", flush=True)
    for mode in REMAT_MODES:
        want = launches_a_step(dataclasses.replace(cfg, remat=mode))
        if per[mode]["launches"] != [want] * REMAT_STEPS:
            fail(f"train remat {label}: {kernel} launched "
                 f"{per[mode]['launches']} times a step under {mode!r}, "
                 f"not {want}")
    if differ:
        fail(f"train remat {label}: not bit-identical to "
             f"{REMAT_MODES[0]!r}: {json.dumps(differ)[:2000]}")
    if not all(map(math.isfinite, losses)):
        fail(f"train remat {label}: losses {losses}")
    return rec


def dryrun_temp(cfg, b: int, s: int) -> dict:
    """The dry run of `cfg`'s train step at b x s on a one-position meta
    mesh (no probes): its memory record."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import strategies
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    shape = ShapeSpec(f"train_smoke_{b}x{s}", "train", s, b)
    extra, cfg, strat = strategies.strategy_for(cfg, shape)
    rec = dryrun.estimate({"arch": cfg.name}, cfg, shape, make_mesh(
        (1, 1), ("data", "model"), device="meta"), extra, strat,
        probes=False)
    return rec["memory"]


def train_remat_long_phase(state, dev: dict, block=None) -> dict:
    """REMAT_LONG under "block" on the train phase's mamba2 state:
    REMAT_LONG_STEPS steps of make_train_step on one seeded batch. First
    the dry run's reckoning of the same step keeping every activation
    ("none", which is not run: it would not fit) and under "block"
    (`block`: the dry run phase's memory record of the cell, when it
    ran)."""
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.train import optim, step
    arch, b, s = REMAT_LONG
    label = arch.split("-")[0]
    phase(f"train remat {label} {b}x{s}")
    cfg = train_config(arch)
    args = sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves(
                   {"p": list(state["params"].parameters()),
                    "o": state["opt"]}) if torch.is_tensor(t))
    t0 = time.perf_counter()
    meta = {"none": dryrun_temp(dataclasses.replace(cfg, remat="none"), b,
                                s),
            "block": block or dryrun_temp(cfg, b, s)}
    meta_s = time.perf_counter() - t0
    need = {m: meta[m]["argument_size_in_bytes"] + meta[m][
        "temp_size_in_bytes"] for m in meta}
    card = torch.cuda.get_device_properties(0).total_memory
    print(f"{cfg.name} {b} x {s} [{dev['smi']}]: the dry run's temp peak "
          f"keeping every activation ('none') "
          f"{meta['none']['temp_size_in_bytes']} B, under 'block' "
          f"{meta['block']['temp_size_in_bytes']} B, beside "
          f"{meta['none']['argument_size_in_bytes']} B of arguments: "
          f"{need['none']} and {need['block']} B against the card's "
          f"{card} B (meta runs {meta_s:.2f} s); 'none' is not run",
          flush=True)
    if not need["none"] > card >= need["block"]:
        fail(f"train remat {label} {b} x {s}: the dry run puts 'none' at "
             f"{need['none']} B and 'block' at {need['block']} B beside "
             f"the card's {card} B")
    opt_cfg = optim.AdamWConfig(**TRAIN_FULL_OPT)
    fn = step.make_train_step(cfg, opt_cfg)
    batch = train_batch(cfg, b, s, SEED + 41)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sk.LAUNCHES = 0
    losses, times = [], []
    for i in range(REMAT_LONG_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print(f"step {i + 1}: loss {losses[-1]:.6f} {times[-1] * 1e3:.3f} "
              f"ms", flush=True)
    launches = sk.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    rec = {"arch": cfg.name, "batch": [b, s], "remat": cfg.remat,
           "losses": losses, "step_s": times,
           "step_s_median": statistics.median(times),
           "tokens_per_s": b * s / statistics.median(times),
           "peak_bytes": peak, "peak_over_arguments": peak - before,
           "state_bytes": args, "card_bytes": card,
           "dryrun": {m: meta[m] for m in meta}, "dryrun_s": meta_s,
           "launches": {"ssd_chunk": launches}, "card": dev["smi"]}
    print(f"train remat {label} {b} x {s} [{dev['smi']}]: median step "
          f"{rec['step_s_median'] * 1e3:.3f} ms, {rec['tokens_per_s']:.1f} "
          f"tokens/s; peak device memory {peak} B ({peak / 2**30:.3f} GiB),"
          f" {peak - before} B over what the state and batch held (dry "
          f"run under 'block': {meta['block']['temp_size_in_bytes']} B); "
          f"ssd_chunk launches {launches}", flush=True)
    want = launches_a_step(cfg) * REMAT_LONG_STEPS
    if launches != want:
        fail(f"train remat {label} {b} x {s}: ssd_chunk launched "
             f"{launches} times, not {want}")
    if not all(map(math.isfinite, losses)):
        fail(f"train remat {label} {b} x {s}: losses {losses}")
    return rec


def train_phases(dev: dict, kernels: list, dryrun=None) -> dict:
    """The training slice after the serving phases: the reduced families'
    parity, then each full-width model's steps, its remat modes on the
    same state and batch, and (mamba2) REMAT_LONG on that state, each
    model dropped before the next; the main path's launches go into the
    kernels' records. `dryrun`: the dry run phase's record, whose
    REMAT_LONG cell the last phase reads."""
    out = {"parity": train_parity_phase()}
    for arch, s in TRAIN_FULL:
        label = arch.split("-")[0]
        out[label], state, batch = train_phase(arch, s, dev)
        out[label]["remat"] = train_remat_phase(state["params"].cfg, state,
                                                batch, dev)
        del batch
        if arch == REMAT_LONG[0]:
            release()
            arch, b, s = REMAT_LONG
            cell = (dryrun or {}).get(f"{label}_{b}x{s}")
            out[label]["remat_long"] = train_remat_long_phase(
                state, dev, cell and cell["memory"])
        del state
        release()
        for k in kernels:
            if k["name"] in out[label]["launches"]:
                k.setdefault("launches_train", {})[label] = \
                    out[label]["launches"][k["name"]]
            if k["name"] == out[label]["remat"]["kernel"]:
                k.setdefault("launches_train_remat", {})[label] = {
                    m: r["launches_a_step"] for m, r in
                    out[label]["remat"]["modes"].items()}
            if "remat_long" in out[label] and k["name"] == "ssd_chunk":
                k["launches_train_remat_long"] = \
                    out[label]["remat_long"]["launches"]["ssd_chunk"]
    return out


# --------------------------------------------------------------------------
# the launchers: data pipeline, checkpoints and the supervisor under
# python -m repro_torch.launch.train, and launch.serve, at mamba2-1.3b's
# published widths
# --------------------------------------------------------------------------

LAUNCH_ARCH = "mamba2-1.3b"        # 48 SSD layers: kernel 12 a layer
# The train launcher's chain (18a, 18d-18f) runs LAUNCH_LAYERS of them
# since PR 32 (its checkpoints 9.4 GB, were 18.8), to pay for the world's
# train slice (W3) within the smoke's time limit; launch.serve keeps 48.
LAUNCH_LAYERS = 24
LAUNCH_TRAIN = ["--seq-len", "2048", "--global-batch", "1", "--steps", "5"]
LAUNCH_STEPS = 5
LAUNCH_EVERY = 3                   # checkpoints at steps 3 and 5
LAUNCH_CRASH_CALL = 4              # the step call that raises, once
LAUNCH_DIR = Path(__file__).resolve().parent / "build" / "launch"
LAUNCH_SERVE = ["--arch", LAUNCH_ARCH, "--no-reduced"]
LAUNCH_REQUESTS, LAUNCH_NEW = 8, 16     # launch.serve's defaults
RSS_PERIOD_S = 0.05


class RssPeak:
    """The process's resident set, sampled every RSS_PERIOD_S on a thread
    while the block runs: its peak in bytes."""

    def __enter__(self):
        import threading
        self.peak, self._stop = self._rss(), threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()
        return self

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _loop(self):
        while not self._stop.wait(RSS_PERIOD_S):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(5.0)
        self.peak = max(self.peak, self._rss())


class CheckpointClock:
    """Times the checkpoint store inside the launcher: each save() (the
    snapshot to host memory; the launcher hands it the state in the
    reference's layout, stacked on the card), each background write, each
    wait, each read of a checkpoint and each load into the state."""

    def __enter__(self):
        from repro_torch.checkpoint import store
        from repro_torch.models import convert
        self.rec = {"snapshot_ms": [], "write_ms": [], "wait_ms": [],
                    "read_ms": [], "load_ms": [], "bytes": []}
        self.patched = [(store.CheckpointManager, n) for n in
                        ("save", "_write", "wait", "restore")]
        self.patched.append((convert, "load_reference_state"))
        self.real = {n: getattr(o, n) for o, n in self.patched}
        keys = {"save": "snapshot_ms", "_write": "write_ms",
                "wait": "wait_ms", "restore": "read_ms",
                "load_reference_state": "load_ms"}
        for owner, name in self.patched:
            setattr(owner, name, self._timed(self.real[name], keys[name]))
        return self

    def _timed(self, fn, key):
        # the writer thread's time is host work alone: it does not wait
        # for the card
        sync = torch.cuda.synchronize if key != "write_ms" else (
            lambda: None)

        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            if key == "write_ms":
                self.rec["bytes"].append(sum(
                    x[0].nbytes for x in a[-2].values()))
            if key != "wait_ms" or ms > 1.0:
                self.rec[key].append(ms)
            return out
        return timed

    def __exit__(self, *exc):
        for owner, name in self.patched:
            setattr(owner, name, self.real[name])


class CrashOnce:
    """Wraps the launcher's built step: call number `at` runs the real
    step, which updates the state in place, and then raises, once."""

    def __init__(self, at: int):
        self.at, self.calls = at, 0

    def __call__(self, fn):
        def step(state, batch):
            self.calls += 1
            out = fn(state, batch)
            if self.calls == self.at:
                torch.cuda.synchronize()
                del out
                raise RuntimeError("injected host failure after the step")
            return out
        return step


class Tee:
    """Standard output that is also kept."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def launch_config():
    """LAUNCH_ARCH at its published widths, LAUNCH_LAYERS deep."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(LAUNCH_ARCH),
                               num_layers=LAUNCH_LAYERS)


# launch_depth for the elastic resume's second process, as code
LAUNCH_DEPTH_CODE = (
    "import dataclasses\n"
    "from repro_torch.launch import train as _train\n"
    "_by_name = _train.get_config\n"
    "_train.get_config = lambda name: dataclasses.replace(\n"
    f"    _by_name(name), num_layers={LAUNCH_LAYERS}) if name == "
    f"{LAUNCH_ARCH!r} else _by_name(name)\n")


class launch_depth:
    """Inside the block launch.train.main, which reads its config by name
    (--arch), builds LAUNCH_ARCH LAUNCH_LAYERS deep."""

    def __enter__(self):
        from repro_torch.launch import train
        self.mod, self.real = train, train.get_config
        train.get_config = lambda name: (launch_config() if name ==
                                         LAUNCH_ARCH else self.real(name))
        return self

    def __exit__(self, *exc):
        self.mod.get_config = self.real


def run_launcher(fn, argv, **kw) -> tuple:
    """(fn(argv, **kw), the lines it printed as it printed them)."""
    import contextlib
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        out = fn(argv, **kw)
    sys.stdout.flush()
    return out, "".join(tee.parts).splitlines()


def checkpoint_diff(state, ck: Path, step: int) -> dict:
    """Every leaf of the port state `state`, in the reference's layout,
    against checkpoint `step` in `ck`, bit for bit, one leaf at a time:
    each stored array is read into host memory by the store's own
    restore and compared on the card with the state's slices of it.
    Returns the leaf count and {leaf: max |difference|} of the leaves
    that differ."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models import convert
    named = dict(state["params"].named_parameters())
    parts: dict = {}                  # leaf -> [(group or None, tensor)]
    for name, (path, g) in convert.leaf_map(state["params"]).items():
        tail = ".".join(map(str, path))
        parts.setdefault(f"params.{tail}", []).append((g, named[name]))
        for k in ("m", "v", "master"):
            if k in state["opt"]:
                parts.setdefault(f"opt.{k}.{tail}", []).append(
                    (g, state["opt"][k][name]))
    parts["opt.count"] = [(None, state["opt"]["count"])]
    parts["step"] = [(None, state["step"])]
    mgr = CheckpointManager(ck)
    leaves = mgr.metadata(step)["leaves"]
    if sorted(leaves) != sorted(parts):
        fail(f"checkpoint {step} holds {len(leaves)} leaves, the state "
             f"{len(parts)}: {sorted(set(leaves) ^ set(parts))[:8]}")

    differ = {}
    for key, info in leaves.items():
        dtype = next(iter(parts[key]))[1].dtype
        host = torch.empty(info["shape"], dtype=dtype)
        skeleton: dict = {}
        node = skeleton
        *heads, last = key.split(".")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = host
        mgr.restore(skeleton, step=step)
        stored = host.to(state["step"].device)
        pairs = [(t.detach(), stored if g is None else stored[g])
                 for g, t in parts[key]]
        bad = [(t, w) for t, w in pairs
               if not torch.equal(bits_of(t), bits_of(w))]
        if bad:
            differ[key] = max(float((t.float() - w.float()).abs().max())
                              for t, w in bad)
        del host, stored, skeleton, pairs, bad
    return {"leaves": len(leaves), "differ": differ}


def launch_train_phase(dev: dict) -> tuple:
    """The train launcher at mamba2-1.3b's published widths, LAUNCH_LAYERS
    deep, supervised, crashing once after the step-3 checkpoint; then one
    uninterrupted run, compared leaf by leaf with the first run's final
    checkpoint. Returns (the record, the uninterrupted run's state); the
    checkpoints stay under LAUNCH_DIR for the distribution phases."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.launch import train as launcher
    from repro_torch.models import convert
    phase("train launcher mamba2")
    cfg = launch_config()
    shutil.rmtree(LAUNCH_DIR, ignore_errors=True)
    LAUNCH_DIR.mkdir(parents=True)
    n = cfg.param_count()
    # about: bf16 parameters (a few small fp32 ones) and fp32 m, v and
    # master
    about = n * (2 + 3 * 4)
    free = shutil.disk_usage(LAUNCH_DIR).free
    print(f"{cfg.name}: {n} parameters, a checkpoint about {about} bytes; "
          f"{free} bytes free under build/", flush=True)
    if free < 2 * about + (1 << 30):
        fail(f"two checkpoints of about {about} bytes do not fit in the "
             f"{free} bytes free under build/")
    ck, hb = LAUNCH_DIR / "ck", LAUNCH_DIR / "hb"
    metrics = LAUNCH_DIR / "metrics.jsonl"
    argv = ["--arch", LAUNCH_ARCH, *LAUNCH_TRAIN, "--device", "cuda"]
    crash = CrashOnce(LAUNCH_CRASH_CALL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.LAUNCHES = 0
    t0 = time.perf_counter()
    with CheckpointClock() as clock, RssPeak() as rss, launch_depth():
        state, lines = run_launcher(
            launcher.main, argv + [
                "--checkpoint-dir", str(ck), "--checkpoint-every",
                str(LAUNCH_EVERY), "--heartbeat-dir", str(hb),
                "--metrics-file", str(metrics)], wrap_step=crash)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = sk.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    losses = [r["loss"] for r in recs]
    restarts = [ln for ln in lines if ln.startswith("done at step")]
    beat = json.loads((hb / "host-0.heartbeat").read_text())
    stragglers = [ln for ln in lines if ln.startswith("[straggler]")]
    cr = clock.rec
    rec = {"arch": cfg.name, "batch": [1, 2048], "steps": LAUNCH_STEPS,
           "losses": losses, "step_ms": [r["step_s"] * 1e3 for r in recs],
           "step_ms_median": statistics.median(r["step_s"] for r in recs)
           * 1e3, "done": restarts, "calls": crash.calls,
           "checkpoint_steps": sorted(int(p.name.split("_")[1]) for p in
                                      ck.glob("step_*")),
           "snapshot_ms": cr["snapshot_ms"], "write_ms": cr["write_ms"],
           "wait_ms": cr["wait_ms"], "read_ms": cr["read_ms"],
           "load_ms": cr["load_ms"], "checkpoint_bytes": cr["bytes"],
           "write_gbps": [b / (ms * 1e-3) / 1e9 for b, ms in
                          zip(cr["bytes"], cr["write_ms"])],
           "peak_gib": peak / 2**30, "peak_host_rss_gib": rss.peak / 2**30,
           "heartbeat": beat, "stragglers": stragglers,
           "wall_s": wall_s, "launches": {"ssd_chunk_supervised": launches},
           "card": dev["smi"]}
    print(f"train launcher [{dev['smi']}]: losses {losses}; median step "
          f"{rec['step_ms_median']:.3f} ms; {restarts}; snapshot ms "
          f"{cr['snapshot_ms']}, write ms {cr['write_ms']} "
          f"({rec['write_gbps']} GB/s of {cr['bytes']} bytes), wait ms "
          f"{cr['wait_ms']}, read ms {cr['read_ms']}, load ms "
          f"{cr['load_ms']}; peak device {rec['peak_gib']:.3f} GiB, peak "
          f"host RSS {rec['peak_host_rss_gib']:.3f} GiB; heartbeat {beat}; "
          f"stragglers {stragglers}; wall {wall_s:.3f} s", flush=True)
    want = launches_a_step(cfg) * (LAUNCH_STEPS + 1)
    if restarts != [f"done at step {LAUNCH_STEPS} (restarts: 1)"] or \
            crash.calls != LAUNCH_STEPS + 1:
        fail(f"train launcher: {restarts}, {crash.calls} step calls; one "
             f"restart and {LAUNCH_STEPS + 1} calls expected")
    if not any(ln == f"[restore] resumed from step {LAUNCH_EVERY}"
               for ln in lines):
        fail(f"train launcher: no restore from step {LAUNCH_EVERY}")
    if rec["checkpoint_steps"] != [LAUNCH_EVERY, LAUNCH_STEPS]:
        fail(f"train launcher: checkpoints {rec['checkpoint_steps']}")
    if beat["host"] != "host-0" or beat["step"] != LAUNCH_STEPS:
        fail(f"train launcher: heartbeat {beat}")
    if len(losses) != LAUNCH_STEPS or not all(map(math.isfinite, losses)):
        fail(f"train launcher: losses {losses}")
    if launches != want:
        fail(f"train launcher: ssd_chunk launched {launches} times, not "
             f"{want} ({launches_a_step(cfg)} a step under remat "
             f"{cfg.remat!r} x {LAUNCH_STEPS + 1} step calls)")
    ck_bytes = sum(t.numel() * t.element_size() for t in
                   torch.utils._pytree.tree_leaves(
                       convert.state_to_reference(state, device="meta")))
    if cr["bytes"] != [ck_bytes, ck_bytes]:
        fail(f"train launcher: checkpoints of {cr['bytes']} bytes; the "
             f"state holds {ck_bytes}")
    del state
    release()

    phase("train launcher mamba2 (uninterrupted)")
    sk.LAUNCHES = 0
    plain_metrics = LAUNCH_DIR / "uninterrupted.jsonl"
    t0 = time.perf_counter()
    with launch_depth():
        state, _ = run_launcher(launcher.main, argv + [
            "--metrics-file", str(plain_metrics)])
    torch.cuda.synchronize()
    launches = sk.LAUNCHES
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    diff = checkpoint_diff(state, ck, LAUNCH_STEPS)
    cmp_s = time.perf_counter() - t0
    plain_recs = [json.loads(line) for line in
                  plain_metrics.read_text().splitlines()]
    rec["uninterrupted"] = {"wall_s": plain_s, "compare_s": cmp_s,
                            "leaves": diff["leaves"],
                            "differ": diff["differ"],
                            "step_ms": [r["step_s"] * 1e3
                                        for r in plain_recs],
                            "step_ms_median": statistics.median(
                                r["step_s"] for r in plain_recs) * 1e3}
    rec["launches"]["ssd_chunk_uninterrupted"] = launches
    print(f"uninterrupted run {plain_s:.3f} s; its final state against the "
          f"supervised run's step-{LAUNCH_STEPS} checkpoint: "
          f"{diff['leaves']} leaves, {len(diff['differ'])} differ "
          f"{json.dumps(diff['differ'])} (compared in {cmp_s:.3f} s)",
          flush=True)
    if launches != launches_a_step(cfg) * LAUNCH_STEPS:
        fail(f"train launcher (uninterrupted): ssd_chunk launched "
             f"{launches} times, not {launches_a_step(cfg) * LAUNCH_STEPS}")
    if diff["differ"]:
        fail(f"the resumed run differs from the uninterrupted run in "
             f"{len(diff['differ'])} leaves, max |difference| by leaf "
             f"{json.dumps(diff['differ'])}")
    return rec, state


def launch_serve_phase(dev: dict) -> dict:
    """launch.serve at mamba2-1.3b's published widths, the reference's
    defaults otherwise."""
    import re

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.launch import serve as launcher
    phase("serve launcher mamba2")
    cfg = get_config(LAUNCH_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sk.LAUNCHES = 0
    t0 = time.perf_counter()
    done, lines = run_launcher(launcher.main, LAUNCH_SERVE)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = sk.LAUNCHES
    text = "\n".join(lines)
    pcts = {k: float(v) for k, v in re.findall(r"(p\d\d)=([\d.]+)", text)}
    tok_s = float(re.search(r"throughput: ([\d.]+) tok/s", text).group(1))
    rec = {"arch": cfg.name, "requests": len(done),
           "tokens": sum(len(r.generated) for r in done),
           "step_ms": pcts, "tokens_per_s": tok_s, "wall_s": wall_s,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": {"ssd_chunk": launches}, "card": dev["smi"]}
    print(f"serve launcher [{dev['smi']}]: {rec['requests']} requests, "
          f"{rec['tokens']} tokens; step ms {pcts}; {tok_s} tok/s; peak "
          f"device {rec['peak_gib']:.3f} GiB; ssd_chunk launches "
          f"{launches}; wall {wall_s:.3f} s", flush=True)
    bad = [r.rid for r in done if len(r.generated) != LAUNCH_NEW
           or not all(0 <= t < cfg.vocab_size for t in r.generated)]
    if sorted(r.rid for r in done) != list(range(LAUNCH_REQUESTS)) or bad:
        fail(f"serve launcher: requests {sorted(r.rid for r in done)}, "
             f"wrong answers {bad}")
    if launches != cfg.num_layers * LAUNCH_REQUESTS:
        fail(f"serve launcher: ssd_chunk launched {launches} times, not "
             f"{cfg.num_layers * LAUNCH_REQUESTS} (once a layer a "
             f"prefill)")
    return rec


def launch_phases(dev: dict, kernels: list, dist: dict) -> dict:
    """The launchers, with the distribution slice's train phases between
    them: they hold the uninterrupted run's state and read the supervised
    run's step-3 checkpoint before both are dropped."""
    import shutil
    out = {}
    out["train"], state = launch_train_phase(dev)
    dist_train_phases(dev, state, out["train"], dist, kernels)
    del state
    release()
    shutil.rmtree(LAUNCH_DIR)
    out["serve"] = launch_serve_phase(dev)
    release()
    runs = {"train_supervised":
            out["train"]["launches"]["ssd_chunk_supervised"],
            "train_uninterrupted":
            out["train"]["launches"]["ssd_chunk_uninterrupted"],
            "serve": out["serve"]["launches"]["ssd_chunk"]}
    for k in kernels:
        if k["name"] == "ssd_chunk":
            k["launches_launch"] = runs
    return out


# --------------------------------------------------------------------------
# the distribution slice: logical-axis sharding over virtual positions of
# the card, the launchers' sharded step, the elastic resume, the compressed
# psum and GPipe over virtual positions, and the production meshes' bytes
# --------------------------------------------------------------------------

DIST_MESH = "2,4"                  # the sharded train run's (data, model)
ELASTIC_MESH = "8,1"               # the second process's mesh
ELASTIC_TIMEOUT_S = 600
PIPE_STAGES, PIPE_MICRO = 4, 8
PIPE_MB = (1, 4096, 2048)          # a microbatch at internlm2-1.8b's d_model
# GPipe in bf16 against the sequential composition: each stage's product
# and tanh round to bf16, and the pipelined ticks batch the four stages'
# products into one call, whose summation order may differ from four
# calls'. Both are held to an fp32 oracle of the same composition: the
# pipelined run may sit at most PIPE_X times as far from it as the
# sequential run, plus PIPE_FLOOR (one bf16 unit at 1.0, 2^-7).
PIPE_X, PIPE_FLOOR = 2.0, 2.0 ** -7
COMPRESS_MESH = ((4, 2), ("pod", "data"))
COMPRESS_BOUND = 2e-2              # tests/multidevice_child.py's int8 bound
EF_STEPS, EF_BOUND = 50, 1e-2      # ... and its error-feedback bound
PROD_ARCHS = ("internlm2-1.8b", "mamba2-1.3b", "llama3-405b")
# Bytes one position of make_production_mesh() (16 x 16) and of the
# multi-pod mesh (2 x 16 x 16) holds of the train state (AdamW with fp32
# master), megatron rules at train_4k: arithmetic over the meta state that
# tests/test_torch_specs.py recomputes from both packages' specs.
PROD_BYTES = {
    "internlm2-1.8b": {"single": 185980936, "multi": 92990472},
    "mamba2-1.3b": {"single": 1189683208, "multi": 602337288},
    "llama3-405b": {"single": 25667190792, "multi": 12833595400},
}
MIX_SHARDED_PROMPT, MIX_SHARDED_NEW = 2048, 8
# the grid's cells on the card machine's host, single mesh: (arch, shape,
# probes). tests/test_torch_dryrun.py holds every arch at train_4k and
# decode_32k against XLA's on the CPU; the card machine runs the two
# archs the card check trains, at both shapes.
DRYRUN_GRID = (("internlm2-1.8b", "train_4k", True),
               ("mamba2-1.3b", "train_4k", True),
               ("internlm2-1.8b", "decode_32k", False),
               ("mamba2-1.3b", "decode_32k", False))
DRYRUN_WORKERS = 4                 # grid worker processes (8 host cores)
DRYRUN_GRID_TIMEOUT_S = 600
DRYRUN_STEPS = 3                   # card-check steps before the profiled one
ALLOC_BLOCK = 512                  # the caching allocator's rounding
ALLOC_SMALL = 1 << 20              # past this a block keeps a tail <= it


def state_diff(a: dict, b: dict) -> dict:
    """Two port train states, every leaf bit for bit on the card: the leaf
    count and {leaf: max |difference|} of the leaves that differ."""
    pairs = [(f"params.{n}", p, dict(b["params"].named_parameters())[n])
             for n, p in a["params"].named_parameters()]
    for k in ("m", "v", "master"):
        pairs += [(f"opt.{k}.{n}", t, b["opt"][k][n])
                  for n, t in a["opt"][k].items()]
    pairs += [("opt.count", a["opt"]["count"], b["opt"]["count"]),
              ("step", a["step"], b["step"])]
    differ = {}
    for name, x, y in pairs:
        if x.dtype != y.dtype or x.shape != y.shape or \
                not torch.equal(bits_of(x), bits_of(y)):
            differ[name] = float((x.detach().float()
                                  - y.detach().float()).abs().max())
    return {"leaves": len(pairs), "differ": differ}


def sharded_train_phase(dev: dict, ref_state: dict, base: dict) -> tuple:
    """launch.train.main at mamba2-1.3b's published widths (LAUNCH_LAYERS
    deep) with --mesh 2,4
    on the same SyntheticLM batches as the one-position uninterrupted run:
    its final state must equal that run's bit for bit. Returns (the
    record, its state)."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.launch import train as launcher
    phase("sharded train mamba2")
    cfg = launch_config()
    metrics = LAUNCH_DIR / "sharded.jsonl"
    argv = ["--arch", LAUNCH_ARCH, *LAUNCH_TRAIN, "--device", "cuda",
            "--mesh", DIST_MESH, "--metrics-file", str(metrics)]
    torch.cuda.synchronize()
    sk.LAUNCHES = 0
    sharding.CONSTRAINT_CALLS = 0
    t0 = time.perf_counter()
    with launch_depth():
        state, lines = run_launcher(launcher.main, argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, calls = sk.LAUNCHES, sharding.CONSTRAINT_CALLS
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    chips = math.prod(int(d) for d in DIST_MESH.split(","))
    t0 = time.perf_counter()
    diff = state_diff(state, ref_state)
    cmp_s = time.perf_counter() - t0
    rec = {"arch": cfg.name, "mesh": DIST_MESH, "batch": [1, 2048],
           "losses": [r["loss"] for r in recs],
           "step_ms": [r["step_s"] * 1e3 for r in recs],
           "step_ms_median": statistics.median(r["step_s"] for r in recs)
           * 1e3,
           "one_position_step_ms_median":
           base["uninterrupted"]["step_ms_median"],
           "constraint_calls_a_step": calls / LAUNCH_STEPS,
           "mfu_per_position": statistics.median(r["mfu"] for r in recs),
           "mfu_one_card": statistics.median(r["mfu"] for r in recs) * chips,
           "positions": chips, "wall_s": wall_s, "compare_s": cmp_s,
           "leaves": diff["leaves"], "differ": diff["differ"],
           "launches": {"ssd_chunk": launches}, "card": dev["smi"]}
    print(f"sharded train [{dev['smi']}]: mesh {DIST_MESH} ({chips} "
          f"positions on one card); losses {rec['losses']}; median step "
          f"{rec['step_ms_median']:.3f} ms against the one-position run's "
          f"{rec['one_position_step_ms_median']:.3f} ms; "
          f"{rec['constraint_calls_a_step']} logical_constraint calls a "
          f"step; mfu {rec['mfu_one_card']:.5f} of the card "
          f"({rec['mfu_per_position']:.6f} a position, chips = positions); "
          f"ssd_chunk launches {launches}; against the one-position state: "
          f"{diff['leaves']} leaves, {len(diff['differ'])} differ "
          f"{json.dumps(diff['differ'])} (compared in {cmp_s:.3f} s); wall "
          f"{wall_s:.3f} s", flush=True)
    if launches != launches_a_step(cfg) * LAUNCH_STEPS:
        fail(f"sharded train: ssd_chunk launched {launches} times, not "
             f"{launches_a_step(cfg) * LAUNCH_STEPS}")
    if calls != (cfg.num_layers + 1) * LAUNCH_STEPS:
        fail(f"sharded train: {calls} logical_constraint calls, not "
             f"{(cfg.num_layers + 1) * LAUNCH_STEPS} (the embedding and one "
             f"residual a layer, a step)")
    if not any(ln.startswith(f"step {LAUNCH_STEPS:5d}") for ln in lines):
        fail("sharded train: the run did not reach its last step")
    if diff["differ"]:
        fail(f"the (2, 4) run differs from the one-position run in "
             f"{len(diff['differ'])} leaves: {json.dumps(diff['differ'])}")
    return rec, state


def compression_phase(dev: dict, state: dict) -> dict:
    """compressed_psum_pod on a (4, 2) ("pod", "data") mesh over mamba2's
    full gradient tree from one step, each leaf within the int8 bound of
    4x the leaf; error_feedback_compress over EF_STEPS steps of one
    leaf."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist import compression
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import step as step_lib
    phase("pipeline and compression: compressed psum")
    cfg = launch_config()
    ds = SyntheticLM(DataConfig(seed=1234, vocab_size=cfg.vocab_size,
                                seq_len=2048, global_batch=1))
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for k, v in ds.batch(0).items()}
    _, _, grads = step_lib.value_and_grad(state["params"], cfg, batch)
    grads = {n: g for n, g in grads.items() if g is not None}
    torch.cuda.synchronize()
    shape, axes = COMPRESS_MESH
    mesh = make_mesh(shape, axes)
    ms = time_ms(lambda: compression.compressed_psum_pod(grads, mesh,
                                                         axis="pod"))
    out = compression.compressed_psum_pod(grads, mesh, axis="pod")
    pods = mesh.shape["pod"]
    worst, worst_leaf = 0.0, None
    for n, g in grads.items():
        want = pods * g.float()
        rel = float((out[n] - want).abs().max()
                    / (want.abs().max() + 1e-9))
        if rel > worst:
            worst, worst_leaf = rel, n
    del out
    numel = sum(g.numel() for g in grads.values())
    grad_bytes = sum(g.numel() * g.element_size() for g in grads.values())
    # error feedback on one leaf, fp32 as the reference's check
    leaf = next(n for n in grads if n.endswith("mixer.in_proj"))
    g = {"w": grads[leaf].float()}
    res, acc_sent = None, torch.zeros_like(g["w"])
    for _ in range(EF_STEPS):
        sent, res = compression.error_feedback_compress(g, res)
        acc_sent += sent["w"]
    acc_true = EF_STEPS * g["w"]
    ef = float((acc_sent - acc_true).abs().max() / acc_true.abs().max())
    rec = {"mesh": list(shape), "axes": list(axes), "leaves": len(grads),
           "elements": numel, "grad_bytes": grad_bytes,
           "int8_bytes_a_position": numel, "fp32_bytes_a_position": 4 * numel,
           "ms": ms, "max_rel_err": worst, "worst_leaf": worst_leaf,
           "bound": COMPRESS_BOUND, "ef_leaf": leaf,
           "ef_shape": list(g["w"].shape), "ef_steps": EF_STEPS,
           "ef_rel_err": ef, "ef_bound": EF_BOUND, "card": dev["smi"]}
    print(f"compressed psum [{dev['smi']}]: {len(grads)} gradient leaves, "
          f"{numel} elements ({grad_bytes} bytes as the step made them) "
          f"over {pods} virtual pods of a {shape} mesh in {ms:.3f} ms; int8 "
          f"{numel} bytes a position against fp32 {4 * numel}; worst "
          f"|out - {pods} g| / max|{pods} g| {worst:.6f} ({worst_leaf}), "
          f"bound {COMPRESS_BOUND}; error feedback over {EF_STEPS} steps "
          f"of {leaf} {tuple(g['w'].shape)}: {ef:.3e}, bound {EF_BOUND}",
          flush=True)
    if not worst < COMPRESS_BOUND:
        fail(f"compressed psum: {worst} of the leaf's scale at "
             f"{worst_leaf}, over {COMPRESS_BOUND}")
    if not ef < EF_BOUND:
        fail(f"error feedback: {ef} after {EF_STEPS} steps, over "
             f"{EF_BOUND}")
    del grads, g, res, acc_sent, acc_true
    release()
    return rec


def elastic_phase(dev: dict, ref_state: dict) -> dict:
    """A second process resumes the supervised run's step-3 checkpoint
    with --mesh 8,1 and runs to step 5; its final checkpoint must equal
    the uninterrupted run's state bit for bit."""
    import shutil
    from repro_torch.configs import get_config
    phase("elastic resume mamba2")
    cfg = launch_config()
    ck = LAUNCH_DIR / "ck"
    # the supervised run's step-5 file has been compared; the resumed run
    # writes its own step 5 there, so the disk holds two checkpoints
    shutil.rmtree(ck / f"step_{LAUNCH_STEPS:010d}")
    argv = ["--arch", LAUNCH_ARCH, *LAUNCH_TRAIN, "--device", "cuda",
            "--mesh", ELASTIC_MESH, "--checkpoint-dir", str(ck),
            "--checkpoint-every", str(LAUNCH_EVERY)]
    code = (LAUNCH_DEPTH_CODE + "import json\n"
            "from repro_torch.kernels.ssd_chunk import kernel as sk\n"
            "from repro_torch.launch import train\n"
            f"state = train.main({argv!r})\n"
            "print('ELASTIC ' + json.dumps({'step': int(state['step']), "
            "'launches': sk.LAUNCHES}))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True,
                         timeout=ELASTIC_TIMEOUT_S,
                         cwd=str(SRC.parent))
    wall_s = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    print("\n".join(lines[-12:]), flush=True)
    if run.returncode != 0:
        fail(f"elastic resume: the second process exited "
             f"{run.returncode}: {run.stderr[-3000:]}")
    child = json.loads(next(ln for ln in lines if ln.startswith(
        "ELASTIC "))[len("ELASTIC "):])
    t0 = time.perf_counter()
    diff = checkpoint_diff(ref_state, ck, LAUNCH_STEPS)
    cmp_s = time.perf_counter() - t0
    rec = {"arch": cfg.name, "mesh": ELASTIC_MESH, "from_step": LAUNCH_EVERY,
           "to_step": child["step"], "process_wall_s": wall_s,
           "compare_s": cmp_s, "leaves": diff["leaves"],
           "differ": diff["differ"],
           "launches": {"ssd_chunk": child["launches"]},
           "card": dev["smi"]}
    print(f"elastic resume [{dev['smi']}]: a second process on a "
          f"{ELASTIC_MESH} mesh resumed step {LAUNCH_EVERY} and ended at "
          f"{child['step']} in {wall_s:.3f} s (start-up, restore, "
          f"{LAUNCH_STEPS - LAUNCH_EVERY} steps, the final save); "
          f"ssd_chunk launches {child['launches']}; its step-"
          f"{LAUNCH_STEPS} checkpoint against the uninterrupted run: "
          f"{diff['leaves']} leaves, {len(diff['differ'])} differ "
          f"{json.dumps(diff['differ'])} (compared in {cmp_s:.3f} s)",
          flush=True)
    if f"[restore] resumed from step {LAUNCH_EVERY}" not in lines:
        fail(f"elastic resume: no restore from step {LAUNCH_EVERY}")
    want = launches_a_step(cfg) * (LAUNCH_STEPS - LAUNCH_EVERY)
    if child["step"] != LAUNCH_STEPS or child["launches"] != want:
        fail(f"elastic resume: step {child['step']}, ssd_chunk launched "
             f"{child['launches']} times, not {want}")
    if diff["differ"]:
        fail(f"the elastic resume differs from the uninterrupted run in "
             f"{len(diff['differ'])} leaves: {json.dumps(diff['differ'])}")
    return rec


def dist_train_phases(dev: dict, ref_state: dict, base: dict, dist: dict,
                      kernels: list) -> None:
    """Between the train and serve launchers: the sharded run, the
    compressed psum over its gradients, then the elastic resume."""
    dist["sharded_train"], state = sharded_train_phase(dev, ref_state, base)
    dist["compression"] = compression_phase(dev, state)
    del state
    release()
    dist["elastic"] = elastic_phase(dev, ref_state)
    for k in kernels:
        if k["name"] == "ssd_chunk":
            k["launches_dist"] = {
                "sharded_train":
                dist["sharded_train"]["launches"]["ssd_chunk"],
                "elastic": dist["elastic"]["launches"]["ssd_chunk"]}


def pipe_inputs() -> tuple:
    """GPipe's (PIPE_STAGES, d, d) weights and (PIPE_MICRO, *PIPE_MB)
    microbatches in bf16, from a seeded generator on the card."""
    g = torch.Generator("cuda").manual_seed(SEED + 28)
    d = PIPE_MB[-1]
    xs = torch.randn((PIPE_MICRO,) + PIPE_MB, generator=g, device="cuda",
                     dtype=torch.float32).to(torch.bfloat16)
    ws = (torch.randn((PIPE_STAGES, d, d), generator=g, device="cuda",
                      dtype=torch.float32) / math.sqrt(d)).to(torch.bfloat16)
    return ws, xs


def pipe_stage(w, x):
    return torch.tanh(x @ w)


def pipe_sequential(ws, xs, dtype) -> torch.Tensor:
    """The stages composed in sequence, microbatch by microbatch, in
    `dtype`."""
    out = []
    for m in range(PIPE_MICRO):
        x = xs[m].to(dtype)
        for s in range(PIPE_STAGES):
            x = pipe_stage(ws[s].to(dtype), x)
        out.append(x)
    return torch.stack(out)


def pipeline_phase(dev: dict) -> dict:
    """gpipe with PIPE_STAGES virtual stages on a ("pod",) mesh over
    PIPE_MICRO microbatches, stage tanh(x @ w) in bf16, against the
    sequential composition and an fp32 oracle."""
    from repro_torch.dist import pipeline_parallel as pp
    from repro_torch.launch.mesh import make_mesh
    phase("pipeline and compression: gpipe")
    ws, xs = pipe_inputs()
    d = PIPE_MB[-1]
    mesh = make_mesh((PIPE_STAGES,), ("pod",))

    def pipelined():
        return pp.gpipe(pipe_stage, ws, xs, mesh=mesh, axis="pod")

    def sequential(dtype=torch.bfloat16):
        return pipe_sequential(ws, xs, dtype)

    got, want = pipelined(), sequential()
    oracle = sequential(torch.float32)
    err_pipe = float((got.float() - oracle).abs().max())
    err_seq = float((want.float() - oracle).abs().max())
    gap = float((got.float() - want.float()).abs().max())
    limit = PIPE_X * err_seq + PIPE_FLOOR
    pipe_ms, seq_ms = time_ms(pipelined), time_ms(sequential)
    bubble = pp.bubble_fraction(PIPE_MICRO, PIPE_STAGES)
    rec = {"stages": PIPE_STAGES, "microbatches": PIPE_MICRO,
           "microbatch": list(PIPE_MB), "dtype": "bfloat16",
           "ticks": PIPE_MICRO + PIPE_STAGES - 1, "bubble_fraction": bubble,
           "pipelined_ms": pipe_ms, "sequential_ms": seq_ms,
           "max_err_pipelined": err_pipe, "max_err_sequential": err_seq,
           "max_pipelined_vs_sequential": gap, "limit": limit,
           "card": dev["smi"]}
    print(f"gpipe [{dev['smi']}]: {PIPE_STAGES} virtual stages x "
          f"{PIPE_MICRO} microbatches of {PIPE_MB} bf16, stage tanh(x @ w) "
          f"with w ({d}, {d}); bubble_fraction({PIPE_MICRO}, {PIPE_STAGES})"
          f" = {bubble:.6f} (3/11 = {3 / 11:.6f}); pipelined "
          f"{pipe_ms:.3f} ms ({PIPE_MICRO + PIPE_STAGES - 1} ticks, one "
          f"batched call a tick), sequential {seq_ms:.3f} ms; max |error| "
          f"against the fp32 oracle: pipelined {err_pipe:.6f}, sequential "
          f"{err_seq:.6f} (limit {limit:.6f}); pipelined against "
          f"sequential {gap:.6f}", flush=True)
    if abs(bubble - 3 / 11) > 1e-12 and (PIPE_MICRO, PIPE_STAGES) == (8, 4):
        fail(f"bubble_fraction(8, 4) = {bubble}, not 3/11")
    if not (math.isfinite(err_pipe) and err_pipe <= limit):
        fail(f"gpipe: {err_pipe} from the fp32 oracle, over {limit}")
    del xs, ws, got, want, oracle
    release()
    return rec


def sharded_serve_phase(dev: dict, model, cfg) -> dict:
    """mixtral at PR 24's cut through specs.build_prefill / build_serve on
    a (2, 4) virtual mesh: one prompt, MIX_SHARDED_NEW greedy decode
    steps; logits and tokens must equal engine.make_prefill_step /
    make_serve_step's with the same weights bit for bit, and kernels 10
    and 11 must launch on the sharded path."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.serve import engine
    phase("sharded serve mixtral")
    mesh = make_mesh((2, 4), ("data", "model"))
    p, new = MIX_SHARDED_PROMPT, MIX_SHARDED_NEW
    max_len = p + new
    prefill, _ = specs.build_prefill(
        cfg, ShapeSpec("sharded_prefill", "prefill", p, 1), mesh)
    serve, _ = specs.build_serve(
        cfg, ShapeSpec("sharded_decode", "decode", max_len, 1), mesh)
    g = torch.Generator("cuda").manual_seed(SEED + 29)
    prompt = torch.randint(0, cfg.vocab_size, (1, p), generator=g,
                           device="cuda", dtype=torch.int32)
    key = torch.zeros(2, dtype=torch.uint32, device="cuda")

    def run(sharded: bool):
        caches = lm.init_caches(cfg, 1, max_len)
        with torch.no_grad():
            if sharded:
                logits, caches = prefill(model, prompt, caches)
            else:
                logits, caches = engine.make_prefill_step(cfg)(
                    model, prompt, caches)
            out = [logits.float()]
            nxt = torch.argmax(logits.float(), dim=-1).to(torch.int32)
            toks = [nxt]
            cache_len = torch.full((1,), p, dtype=torch.int32,
                                   device="cuda")
            for _ in range(new):
                if sharded:
                    nxt, logits, caches = serve(model, nxt[:, None],
                                                cache_len, caches, key)
                else:
                    nxt, logits, caches = engine.make_serve_step(cfg)(
                        model, nxt[:, None], cache_len, caches, None)
                out.append(logits)
                toks.append(nxt)
                cache_len = cache_len + 1
        torch.cuda.synchronize()
        return out, toks

    from repro_torch.dist import sharding
    run(False)                      # first calls: warm both paths' caches
    t0 = time.perf_counter()
    o_logits, o_toks = run(False)
    o_wall = time.perf_counter() - t0
    dk.LAUNCHES = fk.LAUNCHES = 0
    sharding.CONSTRAINT_CALLS = 0
    t0 = time.perf_counter()
    s_logits, s_toks = run(True)
    s_wall = time.perf_counter() - t0
    launches = {"decode_attention": dk.LAUNCHES,
                "flash_attention": fk.LAUNCHES}
    calls = sharding.CONSTRAINT_CALLS
    same_logits = all(torch.equal(a, b) for a, b in zip(s_logits, o_logits))
    same_toks = all(torch.equal(a, b) for a, b in zip(s_toks, o_toks))
    gap = max(float((a - b).abs().max()) for a, b in zip(s_logits,
                                                         o_logits))
    rec = {"arch": cfg.name, "layers": cfg.num_layers, "window": cfg.window,
           "mesh": [2, 4], "prompt": p, "new": new,
           "tokens": [int(t) for t in torch.cat(s_toks).tolist()],
           "logits_equal": same_logits, "tokens_equal": same_toks,
           "max_logit_gap": gap, "constraint_calls": calls,
           "sharded_wall_s": s_wall, "one_position_wall_s": o_wall,
           "launches": launches, "card": dev["smi"]}
    print(f"sharded serve [{dev['smi']}]: {cfg.name} at {cfg.num_layers} "
          f"layers, window {cfg.window}, on a (2, 4) virtual mesh: a "
          f"{p}-token prefill and {new} greedy steps, tokens "
          f"{rec['tokens']}; logits equal to the one-position steps "
          f"{same_logits} (max |gap| {gap}), tokens equal {same_toks}; "
          f"{calls} logical_constraint calls; kernel launches {launches}; "
          f"{s_wall:.3f} s sharded, {o_wall:.3f} s one position",
          flush=True)
    n_attn = cfg.num_layers
    if launches != {"decode_attention": n_attn * new,
                    "flash_attention": n_attn}:
        fail(f"sharded serve: launches {launches}, not {n_attn * new} "
             f"decode and {n_attn} prefill")
    if not (same_logits and same_toks):
        fail(f"sharded serve differs from the one-position steps: max "
             f"|logit gap| {gap}")
    return rec


def production_bytes_phase() -> dict:
    """Per-position bytes of the train state under megatron on
    make_production_mesh() and the multi-pod mesh, from shard_shape over
    the meta state; must equal PROD_BYTES."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.dist import sharding, strategies
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import optim
    phase("production-mesh bytes")
    out = {}
    meshes = {"single": make_production_mesh(),
              "multi": make_production_mesh(multi_pod=True)}
    shape = SHAPES["train_4k"]
    for arch in PROD_ARCHS:
        cfg = get_config(arch)
        state, axes = specs.state_specs(cfg, optim.AdamWConfig())
        extra, _, _ = strategies.strategy_for(cfg, shape, "megatron")
        rules = specs.rules_for(cfg, shape, extra)
        out[arch] = {k: sharding.position_bytes(
            state, sharding.sharding_tree(state, axes, m, rules))
            for k, m in meshes.items()}
        del state
    print(f"train-state bytes a position under megatron at train_4k "
          f"(16 x 16; 2 x 16 x 16): {json.dumps(out)}", flush=True)
    if out != PROD_BYTES:
        fail(f"production-mesh bytes {out}, the CPU test's {PROD_BYTES}")
    return out


def launch_counters() -> dict:
    """Every kernel's launch counters: (family, attribute) -> count."""
    import importlib

    from repro_torch.kernels import dispatch
    out = {}
    for fam in dispatch._OP_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{fam}.kernel")
        for attr in dir(mod):
            if attr.endswith("LAUNCHES"):
                out[(fam, attr)] = getattr(mod, attr)
    return out


def dryrun_grid_start():
    """(a) The dry run's grid on the host, started: DRYRUN_GRID's cells in
    up to DRYRUN_WORKERS worker processes (spawned, with no card visible;
    each imports the port once and runs `repro_torch.launch.dryrun.main`
    a cell) on the single mesh. They run beside the card check (b);
    `dryrun_grid_collect` waits for them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch import dryrun
    saved = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES",
                                            "PYTHONPATH")}
    os.environ["CUDA_VISIBLE_DEVICES"] = ""       # the workers see no card
    os.environ["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), saved["PYTHONPATH"] or ""])
    try:
        # a spawned worker takes the environment when it starts: at submit
        pool = ProcessPoolExecutor(
            min(DRYRUN_WORKERS, len(DRYRUN_GRID)),
            mp_context=multiprocessing.get_context("spawn"))
        jobs = {pool.submit(dryrun.main, [
            "--arch", arch, "--shape", shape, "--mesh", "single",
            "--force"] + ([] if probed else ["--no-probes"])):
                (arch, shape, probed) for arch, shape, probed in DRYRUN_GRID}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return pool, jobs, time.perf_counter()


def dryrun_grid_collect(started) -> dict:
    """The grid's cells, as they end (the phase's seconds are the wait
    after the card check; `seconds` counts from the start)."""
    from concurrent.futures import as_completed

    from repro_torch.launch import dryrun
    pool, jobs, t0 = started
    phase("dry run (grid)")
    cells = {}
    try:
        for job in as_completed(jobs, timeout=DRYRUN_GRID_TIMEOUT_S):
            arch, shape, probed = jobs[job]
            try:
                job.result()
            except SystemExit:         # the cell's file records the error
                pass
            path = dryrun.cell_path(arch, shape, "single")
            rec = json.loads(path.read_text())
            rec["done_s"] = time.perf_counter() - t0
            cells[f"{arch}/{shape}"] = rec
            mem = rec.get("memory", {})
            sched = {k: v["count"] for k, v in
                     rec.get("collective_schedule", {}).items()}
            print(f"{arch:22s} {shape:11s} {rec['status']:17s} "
                  f"{'probes' if probed else '      '} "
                  f"build {rec.get('lower_s', 0):6.2f} s meta run "
                  f"{rec.get('compile_s', 0):6.2f} s, done at "
                  f"{rec['done_s']:6.1f} s; a position: arguments "
                  f"{mem.get('argument_size_in_bytes')} alias "
                  f"{mem.get('alias_size_in_bytes')} temp peak "
                  f"{mem.get('temp_size_in_bytes')} B; collectives "
                  f"{sched} unruled {rec.get('unruled_ops', {})}",
                  flush=True)
            if rec["status"] == "error":
                print(rec.get("traceback", rec.get("error", "")))
    finally:
        pool.shutdown(cancel_futures=True)
    seconds = time.perf_counter() - t0
    bad = sorted(k for k, r in cells.items() if r["status"] == "error")
    unruled: dict = {}
    for r in cells.values():
        for k, n in r.get("unruled_ops", {}).items():
            unruled[k] = unruled.get(k, 0) + n
    print(f"dry run grid: {len(cells)} cells in {seconds:.1f} s from their "
          f"start, beside the card check ({len(jobs)} worker processes); "
          f"unruled ops over the grid {unruled}", flush=True)
    if bad:
        fail(f"dry run cells in error: {bad}")
    for arch, shape, probed in DRYRUN_GRID:
        if not probed:
            continue
        r = cells[f"{arch}/{shape}"]
        print(f"{arch} {shape} (256 positions): flops a position "
              f"{r['probe_costs']['est_full']['flops']:.6e} (model "
              f"{r['utilization']['model_flops_per_device']:.6e}), roofline "
              f"step {r['roofline']['step_time_s'] * 1e3:.3f} ms "
              f"({r['roofline']['dominant']}) on the H100 row", flush=True)
    return {"seconds": seconds, "unruled_ops": unruled, "cells": {
        k: {key: r.get(key) for key in (
            "status", "memory", "collective_schedule", "unruled_ops",
            "lower_s", "compile_s", "done_s", "roofline", "utilization")}
        for k, r in cells.items()}}


def dryrun_card_check(arch: str, s: int, dev: dict, b: int = 1) -> dict:
    """(b) One train cell (b x s) under the config's remat ("block"): the
    dry run on a one-position meta mesh beside the same step on the card
    through specs.build_train. Both count the recompute: the meta run's
    tracer sees its ops, the profiler its products."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist import strategies
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch._trace import tensors_of
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import metrics, optim, step
    label = arch.split("-")[0]
    cfg = train_config(arch)
    shape = ShapeSpec(f"train_smoke_{s}" if b == 1 else
                      f"train_smoke_{b}x{s}", "train", s, b)
    extra, cfg, strat = strategies.strategy_for(cfg, shape)
    counters = launch_counters()
    t0 = time.perf_counter()
    est = dryrun.estimate({"arch": arch}, cfg, shape, make_mesh(
        (1, 1), ("data", "model"), device="meta"), extra, strat)
    meta_s = time.perf_counter() - t0
    if launch_counters() != counters:
        fail(f"dry run {label}: kernel launch counters moved during the "
             f"meta runs")
    opt_cfg = optim.AdamWConfig(**TRAIN_FULL_OPT)
    fn, abstract = specs.build_train(cfg, shape, make_mesh(
        (1, 1), ("data", "model")), opt_cfg=opt_cfg, rules_extra=extra)
    rounded = sum(-(-t.numel() * t.element_size() // ALLOC_BLOCK)
                  * ALLOC_BLOCK for t in tensors_of(abstract))
    del abstract
    release()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    base_req = requested_bytes()
    state, _ = step.init_state(SEED, cfg, opt_cfg, device="cuda")
    batch = train_batch(cfg, b, s, SEED + 40)
    torch.cuda.synchronize()
    args_bytes = torch.cuda.memory_allocated() - base
    args_req = requested_bytes() - base_req
    n_large = sum(t.numel() * t.element_size() > ALLOC_SMALL
                  for t in tensors_of((state, batch)))
    logger = metrics.MetricsLogger(
        Path(__file__).resolve().parent / "build" /
        f"dryrun_metrics_{label}.jsonl", cfg, shape, chips=1)
    logger.close()
    sk.LAUNCHES = 0
    times, peak = [], 0
    for i in range(DRYRUN_STEPS):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        state, m = fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        peak = max(peak, torch.cuda.max_memory_allocated() - before)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        state, m = fn(state, batch)
        torch.cuda.synchronize()
    flops = sum(e.flops for e in prof.key_averages() if e.flops)
    launches = sk.LAUNCHES
    if "ssd" in cfg.block_pattern and \
            launches != launches_a_step(cfg) * (DRYRUN_STEPS + 1):
        fail(f"dry run {label}: ssd_chunk launched {launches} times in "
             f"{DRYRUN_STEPS + 1} steps, not {launches_a_step(cfg)} a step "
             f"(remat {cfg.remat!r})")
    if not math.isfinite(float(m["loss"])):
        fail(f"dry run {label}: loss {float(m['loss'])}")
    del state, batch, fn
    release()
    mem = est["memory"]
    step_s = statistics.median(times[1:])
    roof = est["roofline"]["step_time_s"]
    rec = {"arch": arch, "batch": [b, s], "remat": cfg.remat,
           "meta_s": meta_s, "memory": mem,
           "predicted": {"argument_bytes": mem["argument_size_in_bytes"],
                         "argument_bytes_rounded": rounded,
                         "temp_peak_bytes": mem["temp_size_in_bytes"],
                         "flops": est["costs"]["flops"],
                         "flops_probes": est["probe_costs"]["est_full"][
                             "flops"],
                         "roofline_step_s": roof,
                         "roofline_dominant": est["roofline"]["dominant"]},
           "measured": {"argument_bytes_requested": args_req,
                        "argument_bytes": args_bytes,
                        "step_peak_bytes": peak,
                        "profiler_flops": flops, "step_s": times,
                        "step_s_median": step_s,
                        "metrics_roofline_step_s": logger.roofline_step_s,
                        "ssd_chunk_launches": launches},
           "unruled_ops": est["unruled_ops"], "card": dev["smi"]}
    print(f"dry run card check {label} {b} x {s} [{dev['smi']}]: remat "
          f"{cfg.remat}; meta run with probes {meta_s:.2f} s", flush=True)
    print(f"  argument bytes: predicted {mem['argument_size_in_bytes']}, "
          f"requested of the allocator {args_req}; in {ALLOC_BLOCK}-byte "
          f"blocks {rounded}, memory_allocated {args_bytes} (+"
          f"{args_bytes - rounded}: blocks past {ALLOC_SMALL} B keep a "
          f"segment's unsplit tail, at most {ALLOC_SMALL} B each of "
          f"{n_large})", flush=True)
    print(f"  temp peak: predicted {mem['temp_size_in_bytes']} B, "
          f"max_memory_allocated over a step {peak} B (ratio "
          f"{peak / max(mem['temp_size_in_bytes'], 1):.4f})", flush=True)
    print(f"  flops a step: predicted {est['costs']['flops']:.6e} (probes "
          f"{rec['predicted']['flops_probes']:.6e}), profiler with_flops "
          f"{flops:.6e} (ratio {flops / est['costs']['flops']:.4f})",
          flush=True)
    print(f"  step: H100 roofline {roof * 1e3:.3f} ms "
          f"({est['roofline']['dominant']}), MetricsLogger roofline "
          f"{logger.roofline_step_s * 1e3:.3f} ms, measured median "
          f"{step_s * 1e3:.3f} ms (steps 2-{DRYRUN_STEPS}; "
          f"{step_s / roof:.2f}x the dry run's roofline); ssd_chunk "
          f"launches {launches}", flush=True)
    if args_req != mem["argument_size_in_bytes"] or not \
            rounded <= args_bytes <= rounded + ALLOC_SMALL * n_large:
        fail(f"dry run {label}: the real state and batch request "
             f"{args_req} bytes and take {args_bytes}, the dry run's "
             f"arguments {mem['argument_size_in_bytes']} ({rounded} in "
             f"{ALLOC_BLOCK}-byte blocks)")
    return rec


def requested_bytes() -> int:
    """Bytes the live tensors asked the caching allocator for, before its
    rounding."""
    return torch.cuda.memory_stats().get("requested_bytes.all.current", 0)


def dryrun_phase(dev: dict) -> dict:
    t0 = time.perf_counter()
    grid = dryrun_grid_start()
    phase("dry run (card check, the grid beside it)")
    out = {}
    for arch, s in TRAIN_FULL:
        out[arch.split("-")[0]] = dryrun_card_check(arch, s, dev)
    arch, b, s = REMAT_LONG
    out[f"{arch.split('-')[0]}_{b}x{s}"] = dryrun_card_check(arch, s, dev,
                                                             b=b)
    out["grid"] = dryrun_grid_collect(grid)
    out["seconds"] = time.perf_counter() - t0
    print(f"dry run phase {out['seconds']:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# the world: a shard a rank over torch.distributed
# --------------------------------------------------------------------------

WORLD_RANKS = 8                    # gloo ranks sharing the one card
WORLD_ROWS = 1 << 28               # 2^25 rows a shard; 1.125 GiB of words
WORLD_DEADLINE_S = 600             # the whole world, start to end
WORLD_COLLECTIVE_S = 300           # one collective waits at most this
WORLD_PSUM_SHAPES = ((2048, 4096), (4096,), (64, 64), ())
WORLD_PSUM_SEED = 31
WORLD_STORE = Path(__file__).resolve().parent / "build" / "world_store.pt"
WORLD_STORE_WAIT_S = 300           # a rank waits this long for the store


def psum_tree():
    """A seeded fp32 tree for the compressed psum, on the card."""
    g = torch.Generator(device="cuda").manual_seed(WORLD_PSUM_SEED)
    return {f"leaf{i}": torch.randn(shape, generator=g, device="cuda")
            for i, shape in enumerate(WORLD_PSUM_SHAPES)}


def tree_digest(tree) -> dict:
    import hashlib
    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()
            for k, v in tree.items()}


def world_queries(dim) -> tuple:
    """The world's flat plans (the eleven), grouped main shapes (six) and
    degraded queries (those of degraded_phase)."""
    from repro_torch.query import GroupBy, HashJoin, Pred
    flat_lost = [("fused", Pred("a", "lt", 64), ("b",)),
                 ("and_mixed", Pred("a", "lt", 50) & Pred("w", "ge", 9000),
                  ("w", "b")),
                 ("empty", Pred("a", "gt", 127), ("b",))]
    grouped_lost = [("groupby_dense", GroupBy("a", ("w",))),
                    ("count_only", GroupBy("x")),
                    ("hash_join", HashJoin(dim, "a", "a", aggs=("b",)))]
    return plan_shapes(), grouped_main_shapes(dim), flat_lost, grouped_lost


def world_prepare() -> dict:
    """The parent's part, before the worlds: the WORLD_ROWS-row table from
    SEED on the card, the unsharded engine's answers to every query of
    the worlds, and the table's encoding saved to WORLD_STORE (the store's
    capacity-tier copy, which each rank loads onto its host), written
    under another name and renamed, so a rank that sees the file sees it
    whole. The worlds start before it: their ranks build their tables
    meanwhile."""
    from repro_torch.query import Query, QueryEngine
    from repro_torch.store import EncodedTable
    t0 = time.perf_counter()
    table = build_table(WORLD_ROWS)
    dim = build_dim({"a": [1, 3, 5, 99, 127]})
    flat, gshapes, flat_lost, grouped_lost = world_queries(dim)
    eng = QueryEngine(table, mode="auto")
    want = {}
    for tag, queries in (("", flat), ("lost ", flat_lost)):
        for name, plan, aggs in queries:
            eng.submit(Query(plan, aggregates=aggs))
            want[tag + name] = eng.run()[0].aggregates
    for tag, queries in (("grouped ", gshapes), ("lost ", grouped_lost)):
        for name, q in queries:
            eng.submit(q)
            want[tag + name] = eng.run()[0].aggregates
    answers_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = EncodedTable.from_table(table, chunk_rows=STORE_CHUNK_ROWS)
    del eng, table
    part = WORLD_STORE.with_suffix(".part")
    torch.save(store, part)
    part.rename(WORLD_STORE)
    del store
    release()
    rec = {"want": want, "answers_s": answers_s,
           "store_s": time.perf_counter() - t0,
           "store_file_bytes": WORLD_STORE.stat().st_size}
    print(f"world set-up in this process: the unsharded engine's "
          f"{len(want)} answers {answers_s:.3f} s; the store encoded and "
          f"saved ({rec['store_file_bytes']} B) {rec['store_s']:.3f} s",
          flush=True)
    return rec


def world_rank(rows: int, full: bool) -> list:
    """One rank's part of a world phase (every rank runs it alike): the
    query path (world_query_rank), then, its tables dropped, the train
    slice (world_train_rank). Returns every rank's record, gathered."""
    import torch.distributed as dist
    rec = world_query_rank(rows, full)
    release()
    rec["train"] = world_train_rank(full)
    rec["left_at"] = time.time()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, rec)
    return every


def world_query_rank(rows: int, full: bool) -> dict:
    """One rank's query path (every rank runs it alike): the
    table built from SEED on this rank's device and sharded over a mesh
    of the world's ranks (the shard copied to the device, the table moved
    to the host and the device copy dropped); with `full`, the store
    loaded from WORLD_STORE onto the host and its delta view (each rank
    decoding its own chunks). Then, counters at 0: the eleven plans
    through QueryEngine on the plain view; with `full`, also on the delta
    view, the six grouped shapes on both views, execute_degraded /
    execute_grouped_degraded for DEGRADED_LOST on both (all shards lost
    must raise) and the compressed psum on a (4, 2) rank mesh. Returns
    this rank's record."""
    import torch.distributed as dist

    from repro_torch.dist import compression
    from repro_torch.kernels import dispatch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.query import Query, QueryEngine, ShardedTable
    from repro_torch.resilience import (DegradedResultError,
                                        execute_degraded,
                                        execute_grouped_degraded)
    from repro_torch.store import ShardedEncodedTable
    entered = time.time()
    secs = {}
    t0 = time.perf_counter()
    mesh = make_mesh((dist.get_world_size(),), ("data",),
                     group=dist.group.WORLD)
    dim = build_dim({"a": [1, 3, 5, 99, 127]})
    flat, gshapes, flat_lost, grouped_lost = world_queries(dim)
    table = build_table(rows, valid=False)
    views = {"plain": ShardedTable.shard(table, mesh)}
    del table
    secs["build and shard"] = time.perf_counter() - t0
    if full:
        t0 = time.perf_counter()
        while not WORLD_STORE.exists():
            if time.perf_counter() - t0 > WORLD_STORE_WAIT_S:
                raise TimeoutError(f"no {WORLD_STORE} after "
                                   f"{WORLD_STORE_WAIT_S} s")
            time.sleep(0.05)
        secs["wait for the store"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        store = torch.load(WORLD_STORE, map_location="cpu",
                           weights_only=False)
        secs["load store"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        views["delta"] = ShardedEncodedTable.shard(store, mesh)
        del store
        secs["delta shard"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    release()
    resident = torch.cuda.memory_allocated()
    setup_peak = torch.cuda.max_memory_allocated()
    dist.barrier()
    counters = reset_counters()
    dispatch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    rec = {"rank": mesh.rank, "device": str(mesh.device), "answers": {},
           "degraded": [], "bytes": {}, "ms": {},
           "resident_bytes": resident, "entered_at": entered}
    for vname, st in views.items():
        inner = getattr(st, "inner", st)
        rec["bytes"][vname] = {
            "rank": sum(4 * int(s.words.numel()) + 4 * int(s.valid.numel())
                        for s in inner.slices.values()),
            "words_rank": sum(4 * int(s.words.numel())
                              for s in inner.slices.values()),
            "global": st.nbytes}
        t0 = time.perf_counter()
        eng = QueryEngine(st, mode="auto")
        got = {}
        for name, plan, aggs in flat:
            eng.submit(Query(plan, aggregates=aggs))
            got[name] = eng.run()[0]
        for name, q in gshapes if full else ():
            eng.submit(q)
            got[f"grouped {name}"] = eng.run()[0]
        rec["answers"][vname] = {k: r.aggregates for k, r in got.items()}
        rec["ms"][vname] = {k: r.latency_s * 1e3 for k, r in got.items()}
        rec[f"dispatch {vname}"] = eng.metrics.launch_counts()
        secs[f"queries {vname}"] = time.perf_counter() - t0
        if not full:
            continue
        t0 = time.perf_counter()
        for name, plan, aggs in flat_lost:
            for lost in DEGRADED_LOST:
                got, rb = execute_degraded(st, plan, aggs, lost)
                rec["degraded"].append((vname, f"lost {name}", str(lost),
                                        got, rb))
            try:
                execute_degraded(st, plan, aggs, range(mesh.size))
                rec["degraded"].append((vname, name, "all", None, 0))
            except DegradedResultError:
                rec["degraded"].append((vname, name, "all", "raised", 0))
        secs[f"degraded flat {vname}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name, q in grouped_lost:
            for lost in DEGRADED_LOST:
                got, rb = execute_grouped_degraded(st, q, lost)
                rec["degraded"].append((vname, f"lost {name}", str(lost),
                                        got, rb))
            try:
                execute_grouped_degraded(st, q, range(mesh.size))
                rec["degraded"].append((vname, name, "all", None, 0))
            except DegradedResultError:
                rec["degraded"].append((vname, name, "all", "raised", 0))
        secs[f"degraded grouped {vname}"] = time.perf_counter() - t0
    if full:
        t0 = time.perf_counter()
        mesh42 = make_mesh(*COMPRESS_MESH, group=dist.group.WORLD)
        tree = psum_tree()
        out = compression.compressed_psum_pod(tree, mesh42, axis="pod")
        pods = mesh42.shape["pod"]
        rec["psum"] = {"digest": tree_digest(out), "max_rel_err": max(
            float((out[k] - pods * v).abs().max()
                  / ((pods * v).abs().max() + 1e-9)) for k, v in tree.items())}
        secs["psum"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    rec["path_s"] = time.perf_counter() - t_path
    rec["launches"] = read_counters(counters)
    rec["secs"] = secs
    rec["peak_gib"] = {"set-up": setup_peak / 2**30,
                       "path": torch.cuda.max_memory_allocated() / 2**30}
    return rec


# --------------------------------------------------------------------------
# the world's train slice: train state split over the ranks
# --------------------------------------------------------------------------

WORLD_TRAIN_LAYERS = 12            # of mamba2-1.3b's 48, its one cut
WORLD_TRAIN_BS = (2, 2048)         # the global batch: rows x tokens
WORLD_TRAIN_STEPS = 3              # run A's steps
WORLD_TRAIN_SAVES = (2, 3)         # A's checkpoints; B resumes from the first
WORLD_TRAIN_A = (2, 4)             # ("data", "model"): "data" splits the rows
WORLD_TRAIN_B = (8, 1)             # 2 rows do not divide 8: no rank splits them
WORLD_PIPE_MESH = ((4, 2), ("pod", "data"))
WORLD_TRAIN_DIR = Path(__file__).resolve().parent / "build" / "world_train"
DIGEST_CHUNK = 1 << 24             # words a digest sums at once
# The one-position run takes each batch as WORLD_TRAIN_MICRO microbatches
# of one row (make_train_step's fp32 accumulation), which is run A's
# reduction order: a rank's row, its bf16 gradients summed in fp32 over
# "data" and halved. So A's step-3 file must equal the one-position state
# bit for bit, and so must the nccl rank's (1, 1) run of the same step.
# Run B resumes A's step-2 file on (8, 1), where the two rows stay whole on
# every rank (one backward over both), so its step 3 differs from A's in
# reduction order; its bounds were written into PERF.md (PR 32) before the
# first run. Adam moves a weight by at most ~lr a step: for t <= 3 at b1
# 0.9 and b2 0.95, |m_hat / sqrt(v_hat)| <= 1.001 whatever the gradients,
# so two fp32 masters part by at most 2.002 x lr in a step whose gradients
# differ (UPDATE_X), and their bf16 casts by that plus one bf16 unit at the
# leaf's largest magnitude (BF16_ULP of it). That holds for any gradients;
# the moments carry their scale, so m and v are held to a relative norm
# error per leaf (MOMENT_REL).
WORLD_TRAIN_MICRO = 2
UPDATE_X = 2.01
BF16_ULP = 2.0 ** -7
MOMENT_REL = 5e-2


def world_train_setup(mesh, micro: int = 1) -> tuple:
    """(config, shape, AdamW config, build_train's step, data) of the
    world's train slice on `mesh`: mamba2-1.3b at its published widths,
    WORLD_TRAIN_LAYERS deep, bf16, remat "block", SyntheticLM rows;
    `micro` microbatches a step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import specs
    from repro_torch.train import optim
    cfg = dataclasses.replace(get_config("mamba2-1.3b"),
                              num_layers=WORLD_TRAIN_LAYERS)
    b, s = WORLD_TRAIN_BS
    shape = ShapeSpec("world_train", "train", s, b)
    opt_cfg = optim.AdamWConfig(**TRAIN_FULL_OPT)
    fn, _ = specs.build_train(cfg, shape, mesh, opt_cfg=opt_cfg,
                              num_microbatches=micro)
    ds = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                global_batch=b))
    return cfg, shape, opt_cfg, fn, ds


def leaf_digest(t: torch.Tensor) -> list:
    """[sum, position-weighted sum] of a tensor's raw words, each word
    widened to int64, on its device: equal tensors give equal digests,
    and a changed bit changes them."""
    w = t.detach().contiguous().view(-1)
    w = w.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[w.element_size()])
    total = weighted = 0
    for lo in range(0, w.numel(), DIGEST_CHUNK):
        c = w[lo:lo + DIGEST_CHUNK].to(torch.int64)
        i = torch.arange(lo + 1, lo + 1 + c.numel(), device=c.device,
                         dtype=torch.int64)
        total += int(c.sum())
        weighted += int((c * i).sum())
    return [total, weighted]


def state_digest(state: dict, shardings=None) -> dict:
    """leaf_digest of every leaf of a train state, each gathered whole
    from the ranks' blocks where `shardings` (the state's) lie on a rank
    mesh (every rank calls it alike)."""
    from repro_torch.dist.sharding import gather
    trees = [("params", dict(state["params"].named_parameters()),
              "params")] + [(k, state["opt"][k], k)
                            for k in ("m", "v", "master")]
    out = {}
    for tree, leaves, key in trees:
        shs = None if shardings is None else (
            shardings["params"] if key == "params" else
            shardings["opt"][key])
        for name, t in leaves.items():
            whole = t if shs is None else gather(t.detach(), shs[name])
            out[f"{tree}.{name}"] = leaf_digest(whole)
            del whole
    out["count"] = leaf_digest(state["opt"]["count"])
    out["step"] = leaf_digest(state["step"])
    return out


class CommClock:
    """Seconds spent in repro_torch.dist.sharding.gather and
    torch.distributed.all_reduce while open (the card synchronised
    before and after each call)."""

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.dist import sharding
        self.mods = (sharding, dist)
        self.real = (sharding.gather, dist.all_reduce)
        self.secs = {"gather": 0.0, "all_reduce": 0.0}

        def timed(name, fn):
            def call(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    self.secs[name] += time.perf_counter() - t0
            return call

        sharding.gather = timed("gather", self.real[0])
        dist.all_reduce = timed("all_reduce", self.real[1])
        return self

    def __exit__(self, *exc):
        self.mods[0].gather, self.mods[1].all_reduce = self.real


class DigestGathers:
    """While open and `on`, the leaf_digest of every tensor that
    repro_torch.dist.sharding.gather returns, in call order (a save over
    ranks gathers each split leaf whole on every rank)."""

    def __init__(self, on: bool):
        self.on, self.out = on, []

    def __enter__(self):
        from repro_torch.dist import sharding
        self.mod, self.real = sharding, sharding.gather
        if self.on:
            def call(*a, **k):
                whole = self.real(*a, **k)
                self.out.append(leaf_digest(whole))
                return whole
            sharding.gather = call
        return self

    def __exit__(self, *exc):
        self.mod.gather = self.real


def world_train_run(label: str, dims: tuple, lo: int, hi: int,
                    saves: tuple, restore_from=None, micro: int = 1,
                    pending=None) -> dict:
    """One rank's train run on a (data, model) rank mesh of `dims`: the
    state drawn from SEED on the card and cut to this rank's blocks (the
    bytes it then holds against position_bytes), with `restore_from`
    (a run's label, a step) that run's checkpoint read a block a rank;
    then, kernel 12's count at 0, steps lo..hi-1 of build_train's step
    on SyntheticLM's batches (`micro` microbatches a step), a checkpoint
    (gathered, rank 0 writes in the background) after each step in
    `saves`; the digest of every gathered leaf (those the last save
    gathers, and the unsplit leaves, whole on every rank), or without a
    save of every leaf. With `pending` (a list) the last write is left
    running and its manager appended there, for the caller to wait on."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import make_global_batch
    from repro_torch.dist import sharding as shlib
    from repro_torch.dist import world
    from repro_torch.kernels.ssd_chunk import kernel as sk
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    from repro_torch.train import step as step_lib
    from torch.utils import _pytree as pytree
    mesh = make_mesh(dims, ("data", "model"), group=dist.group.WORLD)
    cfg, shape, opt_cfg, fn, ds = world_train_setup(mesh, micro)
    state_sh, batch_sh = fn.in_shardings
    secs = {}
    release()
    base, base_alloc = requested_bytes(), torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, _ = step_lib.init_state(SEED, cfg, opt_cfg, device=mesh.device,
                                   mesh=mesh,
                                   rules=specs.rules_for(cfg, shape))
    torch.cuda.synchronize()
    secs["init"] = time.perf_counter() - t0
    release()
    whole = sum(math.prod(sh.global_shape) * t.element_size()
                for t, sh in zip(state_leaves(state),
                                 state_leaves(state_sh)))
    rec = {"mesh": list(dims), "rank": mesh.rank, "coords": mesh.coords,
           "resident_requested": requested_bytes() - base,
           "resident_allocated": torch.cuda.memory_allocated() - base_alloc,
           "position_bytes": shlib.position_bytes(state, state_sh),
           "whole_bytes": whole}
    ref_sh = convert.shardings_to_reference(state, state_sh)
    if restore_from is not None:
        t0 = time.perf_counter()
        skeleton = convert.state_to_reference(state)
        tree, meta = CheckpointManager(WORLD_TRAIN_DIR / restore_from[0]) \
            .restore(skeleton, step=restore_from[1], shardings=ref_sh)
        convert.load_reference_state(state, tree)
        del tree, skeleton
        torch.cuda.synchronize()
        secs["restore"] = time.perf_counter() - t0
        rec["restored_step"] = meta["step"]
        release()
    mgr = (CheckpointManager(WORLD_TRAIN_DIR / label, async_save=True)
           if saves else None)
    specs_ = {k: sh.spec for k, sh in batch_sh.items()}
    torch.cuda.reset_peak_memory_stats()
    world.barrier()
    sk.LAUNCHES = 0
    losses, steps, comm = [], [], []
    for s in range(lo, hi):
        batch = make_global_batch(ds.batch(s), mesh, specs_)
        with CommClock() as clock:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, metrics = fn(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        comm.append(dict(clock.secs))
        del batch, metrics
        if s + 1 in saves:
            # the step's cached blocks back to the card: eight ranks and
            # this process's neighbours share it (a save holds the
            # reference-layout copy of the blocks and one whole leaf)
            release()
            # the last save's gathers give the digests of the split leaves
            t0 = time.perf_counter()
            with DigestGathers(s + 1 == hi) as digests:
                tree = convert.state_to_reference(state)
                mgr.save(s + 1, tree, metadata={"run": label},
                         shardings=ref_sh)
            secs[f"save {s + 1} (gather, snapshot)"] = \
                time.perf_counter() - t0
            if digests.on:
                rec["digest"] = {"gathered": digests.out, "whole": [
                    leaf_digest(t) for t, sh in zip(
                        pytree.tree_leaves(tree), pytree.tree_leaves(ref_sh))
                    if not sh.splits()]}
            del tree
    rec["launches"] = sk.LAUNCHES
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if mgr is not None and pending is not None:
        pending.append(mgr)
    elif mgr is not None:
        t0 = time.perf_counter()
        mgr.wait()                  # rank 0's background write, a barrier
        secs["write wait"] = time.perf_counter() - t0
    if "digest" not in rec:
        t0 = time.perf_counter()
        rec["digest"] = state_digest(state, state_sh)
        secs["digest"] = time.perf_counter() - t0
    rec.update(losses=losses, step_s=steps, comm_s=comm, secs=secs)
    del state
    release()
    return rec


def state_leaves(tree) -> list:
    """A train state's (or its shardings') leaves in a fixed order:
    parameters, m, v and master by name, the count and the step."""
    params = tree["params"]
    named = (dict(params.named_parameters())
             if isinstance(params, torch.nn.Module) else params)
    out = list(named.values())
    for k in ("m", "v", "master"):
        out += [tree["opt"][k][n] for n in named]
    return out + [tree["opt"]["count"], tree["step"]]


def world_pipe_rank() -> dict:
    """gpipe on a WORLD_PIPE_MESH rank mesh, a stage a "pod" rank, on
    pipeline_phase's inputs, against the sequential composition and its
    fp32 oracle."""
    import torch.distributed as dist

    from repro_torch.dist import pipeline_parallel as pp
    from repro_torch.dist.sharding import (NamedSharding, PartitionSpec,
                                           local_block)
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(*WORLD_PIPE_MESH, group=dist.group.WORLD)
    ws, xs = pipe_inputs()
    block = local_block(ws, NamedSharding(mesh, PartitionSpec("pod")))
    with CommClock() as clock:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pp.gpipe(pipe_stage, block, xs, mesh=mesh, axis="pod")
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    want = pipe_sequential(ws, xs, torch.bfloat16)
    oracle = pipe_sequential(ws, xs, torch.float32)
    err = float((got.float() - oracle).abs().max())
    err_seq = float((want.float() - oracle).abs().max())
    return {"rank": mesh.rank, "coords": mesh.coords, "s": sec,
            "all_reduce_s": clock.secs["all_reduce"], "max_err": err,
            "max_err_sequential": err_seq,
            "limit": PIPE_X * err_seq + PIPE_FLOOR,
            "equal_to_sequential": bool(torch.equal(got, want)),
            "digest": leaf_digest(got)}


def world_train_rank(full: bool) -> dict:
    """The train slice of a world's rank, after its query path: in the
    gloo world (`full`) run A on WORLD_TRAIN_A for WORLD_TRAIN_STEPS
    steps with checkpoints after WORLD_TRAIN_SAVES, run B on
    WORLD_TRAIN_B restored from A's first checkpoint for the steps left,
    and GPipe; in the nccl world one rank's (1, 1) mesh for the same
    steps, as WORLD_TRAIN_MICRO microbatches (nothing split, nothing
    reduced)."""
    t0 = time.perf_counter()
    if not full:
        out = {"one": world_train_run("one", (1, 1), 0, WORLD_TRAIN_STEPS,
                                      (), micro=WORLD_TRAIN_MICRO)}
    else:
        # A's last file is written while B runs: B reads A's step 2
        pending = []
        out = {"A": world_train_run("A", WORLD_TRAIN_A, 0,
                                    WORLD_TRAIN_STEPS, WORLD_TRAIN_SAVES,
                                    pending=pending)}
        out["B"] = world_train_run(
            "B", WORLD_TRAIN_B, WORLD_TRAIN_SAVES[0], WORLD_TRAIN_STEPS,
            (WORLD_TRAIN_STEPS,), restore_from=("A", WORLD_TRAIN_SAVES[0]))
        t0 = time.perf_counter()
        for mgr in pending:
            mgr.wait()
        out["A"]["secs"]["write wait (after B)"] = time.perf_counter() - t0
        out["pipe"] = world_pipe_rank()
    out["s"] = time.perf_counter() - t0
    return out


def compare_trees(got, want, update_bound=None) -> dict:
    """Two train states in the reference's layout, leaf by leaf: params
    and master within `update_bound` (bf16 params one BF16_ULP of the
    leaf's largest magnitude more), m and v within MOMENT_REL relative
    norm, count and step equal; with no `update_bound`, every leaf equal
    bit for bit. Returns the worst share of its bound by kind, the worst
    leaf, and the leaves over their bound."""
    from torch.utils import _pytree as pytree
    worst, over = {}, []
    flat_w = dict(pytree.tree_flatten_with_path(want)[0])
    for path, a in pytree.tree_flatten_with_path(got)[0]:
        b = flat_w[path]
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        kind = ("m" if ".m." in f".{key}." else "v" if ".v." in f".{key}."
                else "int" if not a.is_floating_point() else "weights")
        if kind == "int" or update_bound is None:
            share = 0.0 if torch.equal(a, b) else math.inf
        elif kind == "weights":
            err = float((a.float() - b.float()).abs().max())
            limit = update_bound
            if a.dtype == torch.bfloat16:
                limit += BF16_ULP * float(torch.maximum(
                    a.float().abs().max(), b.float().abs().max()))
            share = err / limit
        else:
            norm = float(b.float().norm())
            share = (float((a.float() - b.float()).norm()) / norm
                     / MOMENT_REL) if norm else (
                0.0 if torch.equal(a, b) else math.inf)
        if not share <= worst.get(kind, (-1.0, ""))[0]:
            worst[kind] = (share, key)
        if not share <= 1.0:
            over.append((key, share))
    return {"worst": worst, "over": over}


def read_checkpoint(label: str, step: int, like, parts: int = 4):
    """The step-`step` file of run `label` restored into tensors like
    `like` (a reference-layout state in host memory), its leaves read by
    `parts` threads (the file reads and CRC-32s release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.checkpoint import CheckpointManager
    from torch.utils import _pytree as pytree
    skeleton = pytree.tree_map(torch.empty_like, like)
    leaves, spec = pytree.tree_flatten(skeleton)
    mgr = CheckpointManager(WORLD_TRAIN_DIR / label)

    def part(k):
        sub = pytree.tree_unflatten(
            [t if i % parts == k else None for i, t in enumerate(leaves)],
            spec)
        return mgr.restore(sub, step=step)[1]["step"]

    with ThreadPoolExecutor(parts) as pool:
        steps = list(pool.map(part, range(parts)))
    if steps != [step] * parts:
        fail(f"run {label}'s checkpoint reads steps {steps}, not {step}")
    return skeleton


def world_train_parent() -> dict:
    """This process's part of the train slice, run beside the worlds: the
    one-position run (each batch as WORLD_TRAIN_MICRO one-row
    microbatches, the ranks' reduction order), its final state kept in
    host memory (the ranks need the card), and, once run A has published
    its step-WORLD_TRAIN_STEPS file, that file read into host memory and
    held against it bit for bit."""
    from repro_torch.data import make_global_batch
    from repro_torch.dist.sharding import PartitionSpec as P
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import convert
    from repro_torch.train import optim
    from repro_torch.train import step as step_lib
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg, _, opt_cfg, fn, ds = world_train_setup(mesh, WORLD_TRAIN_MICRO)
    t0 = time.perf_counter()
    state, _ = step_lib.init_state(SEED, cfg, opt_cfg, device="cuda")
    losses, step_s = [], []
    for s in range(WORLD_TRAIN_STEPS):
        batch = make_global_batch(ds.batch(s), mesh, {"inputs": P("data"),
                                                      "labels": P("data")})
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = fn(state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    out = {"cfg": cfg, "losses": losses, "step_s": step_s,
           "digest": state_digest(state),
           "lrs": [float(optim.schedule(opt_cfg, torch.tensor(c)))
                   for c in range(1, WORLD_TRAIN_STEPS + 1)]}
    out["s"] = time.perf_counter() - t0
    one_ref = convert.state_to_reference(state, device="cpu")
    del state, batch, m
    release()
    published = WORLD_TRAIN_DIR / "A" / f"step_{WORLD_TRAIN_STEPS:010d}"
    t0 = time.perf_counter()
    while not published.exists():
        if time.perf_counter() - t0 > WORLD_DEADLINE_S:
            raise TimeoutError(f"no {published} after {WORLD_DEADLINE_S} s")
        time.sleep(0.1)
    out["wait_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["A"] = read_checkpoint("A", WORLD_TRAIN_STEPS, one_ref)
    out["read_s"] = time.perf_counter() - t0
    out["a_vs_one"] = compare_trees(out["A"], one_ref)
    del one_ref
    release()
    return out


def world_train_check(dev: dict, gloo: list, nccl: list,
                      parent: dict) -> dict:
    """The train slice's checks, after both worlds and world_train_parent
    (`parent`): every rank's resident bytes equal to position_bytes (the
    allocator's requested bytes), kernel 12 launched launches_a_step a
    forward pass, the gathered leaves' digests and the losses equal
    across the ranks of a run; A's losses and step-3 file equal to the
    one-position run's bit for bit, and the nccl rank's (1, 1) run too;
    B's step-3 file within UPDATE_X x lr_3, BF16_ULP and MOMENT_REL of
    A's; GPipe within its limit on every rank, equal across ranks."""
    import shutil
    phase("world train (one position, checkpoints)")
    bad = []
    cfg, losses = parent["cfg"], parent["losses"]
    # forward passes a run makes: steps x microbatches
    passes_of = {"A": WORLD_TRAIN_STEPS,
                 "B": WORLD_TRAIN_STEPS - WORLD_TRAIN_SAVES[0],
                 "one": WORLD_TRAIN_STEPS * WORLD_TRAIN_MICRO}
    runs = {k: [r["train"][k] for r in gloo] for k in ("A", "B")}
    runs["one"] = [r["train"]["one"] for r in nccl]
    for label, recs in runs.items():
        for r in recs:
            want_launches = launches_a_step(cfg) * passes_of[label]
            if r["resident_requested"] != r["position_bytes"]:
                bad.append((label, r["rank"], "resident bytes",
                            r["resident_requested"], r["position_bytes"]))
            if r["launches"] != want_launches:
                bad.append((label, r["rank"], "kernel 12 launches",
                            r["launches"], want_launches))
            if r["digest"] != recs[0]["digest"]:
                bad.append((label, r["rank"], "gathered leaves differ from "
                                              "rank 0's"))
            if r["losses"] != recs[0]["losses"]:
                bad.append((label, r["rank"], "losses differ from rank 0's"))
            comm = [{k: round(v, 3) for k, v in c.items()}
                    for c in r["comm_s"]]
            print(f"[world train {label}] rank {r['rank']} {r['coords']}: "
                  f"holds {r['resident_requested']} B requested "
                  f"({r['resident_allocated']} allocated) of "
                  f"{r['whole_bytes']} B whole, position_bytes "
                  f"{r['position_bytes']}; kernel 12 launches "
                  f"{r['launches']} (want {want_launches}); losses "
                  f"{r['losses']}; step s "
                  f"{[round(x, 3) for x in r['step_s']]}, of them "
                  f"{comm}; "
                  f"{ {k: round(v, 3) for k, v in r['secs'].items()} }; "
                  f"peak {r['peak_gib']:.3f} GiB", flush=True)
    if runs["B"][0].get("restored_step") != WORLD_TRAIN_SAVES[0]:
        bad.append(("B", "restored step", runs["B"][0].get("restored_step")))
    if runs["A"][0]["losses"] != losses:
        bad.append(("A", "losses differ from the one-position run's",
                    runs["A"][0]["losses"], losses))
    one = runs["one"][0]
    nccl_equal = one["digest"] == parent["digest"] and one["losses"] == losses
    if not nccl_equal:
        bad.append(("one (nccl)", "differs from the one-position run"))
    pipe = [r["train"]["pipe"] for r in gloo]
    for r in pipe:
        if not r["max_err"] <= r["limit"]:
            bad.append(("gpipe", r["rank"], r["max_err"], r["limit"]))
        if r["digest"] != pipe[0]["digest"]:
            bad.append(("gpipe", r["rank"], "output differs from rank 0's"))
    t0 = time.perf_counter()
    file_b = read_checkpoint("B", WORLD_TRAIN_STEPS, parent["A"])
    read_s = time.perf_counter() - t0
    a_vs_one = parent["a_vs_one"]
    b_vs_a = compare_trees(file_b, parent["A"],
                           UPDATE_X * parent["lrs"][-1])
    for label, cmp in (("A against one position", a_vs_one),
                       ("B against A", b_vs_a)):
        bad += [(label, key, share) for key, share in cmp["over"]]
    del file_b, parent["A"]
    shutil.rmtree(WORLD_TRAIN_DIR, ignore_errors=True)
    release()
    p0 = pipe[0]
    print(f"[world train] [{dev['smi']}] {cfg.name} at {cfg.num_layers} of "
          f"48 layers, bf16, remat {cfg.remat}, batch {WORLD_TRAIN_BS}: "
          f"one position in this process {parent['s']:.3f} s (steps "
          f"{[round(x, 3) for x in parent['step_s']]}, {WORLD_TRAIN_MICRO} "
          f"microbatches, beside the worlds), losses {losses}; run A "
          f"{WORLD_TRAIN_A}'s losses equal: "
          f"{runs['A'][0]['losses'] == losses}; lr by step "
          f"{parent['lrs']}; A's step-{WORLD_TRAIN_STEPS} file (waited "
          f"{parent['wait_s']:.3f} s, read {parent['read_s']:.3f} s) "
          f"against the one-position state, bit for bit (share 0 equal, "
          f"inf not) by kind {a_vs_one['worst']}; B's {WORLD_TRAIN_B} "
          f"file (read {read_s:.3f} s) against A's {b_vs_a['worst']}; "
          f"the nccl rank's (1, 1) run equal bit for bit: {nccl_equal}; "
          f"gpipe on {WORLD_PIPE_MESH} ranks: {p0['s']:.3f} s a rank "
          f"(all-reduce {p0['all_reduce_s']:.3f}), worst "
          f"{max(r['max_err'] for r in pipe):.6f} against the fp32 oracle "
          f"(limit {p0['limit']:.6f}), equal to the sequential "
          f"composition on every rank "
          f"{all(r['equal_to_sequential'] for r in pipe)}", flush=True)
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} world train checks failed")
    keep = ("rank", "coords", "resident_requested", "resident_allocated",
            "position_bytes", "launches", "losses", "step_s", "comm_s",
            "secs", "peak_gib")
    return {"config": {"arch": cfg.name, "layers": cfg.num_layers,
                       "batch": list(WORLD_TRAIN_BS), "remat": cfg.remat},
            "one_position": {k: parent[k] for k in (
                "losses", "step_s", "s", "wait_s", "read_s")},
            "runs": {k: [{f: r[f] for f in keep} for r in v]
                     for k, v in runs.items()},
            "launches": {k: [r["launches"] for r in v]
                         for k, v in runs.items()},
            "a_vs_one": a_vs_one["worst"], "b_vs_a": b_vs_a["worst"],
            "b_read_s": read_s, "nccl_equal": nccl_equal,
            "pipe": [{k: r[k] for k in ("rank", "s", "all_reduce_s",
                                        "max_err", "limit",
                                        "equal_to_sequential")}
                     for r in pipe],
            "bounds": {"UPDATE_X": UPDATE_X, "BF16_ULP": BF16_ULP,
                       "MOMENT_REL": MOMENT_REL},
            "card": dev["smi"]}


def world_check(every: list, want: dict, label: str) -> list:
    """Every rank's answers against the unsharded engine's (`want`),
    degraded ones included (all shards lost must have raised); prints per
    rank launches, dispatch counts, ms a query, bytes and seconds.
    Returns the mismatches."""
    bad = []
    for rec in every:
        r = rec["rank"]
        for vname, got in rec["answers"].items():
            for name, a in got.items():
                if a != want[name]:
                    bad.append((label, r, vname, name, a, want[name]))
        for vname, name, lost, got, rb in rec["degraded"]:
            ok = got == "raised" if lost == "all" else \
                got == want[name] and rb > 0
            if not ok:
                bad.append((label, r, "degraded", vname, name, lost))
        if [d[4] for d in rec["degraded"]] != \
                [d[4] for d in every[0]["degraded"]]:
            bad.append((label, r, "recovered bytes differ from rank 0's"))
        print(f"{label} rank {r} on {rec['device']}: launches "
              f"{rec['launches']}; dispatch counts "
              f"{ {k: v for k, v in rec.items() if k.startswith('dispatch')} }"
              f"; shard bytes {rec['bytes']}; device bytes after set-up "
              f"{rec['resident_bytes']}; seconds "
              f"{ {k: round(v, 3) for k, v in rec['secs'].items()} }, path "
              f"{rec['path_s']:.3f} s; peak GiB "
              f"{ {k: round(v, 3) for k, v in rec['peak_gib'].items()} }; "
              f"{len(rec['degraded'])} degraded calls", flush=True)
        for vname, ms in rec["ms"].items():
            print(f"{label} rank {r} {vname:6s} ms a query "
                  f"{ {k: round(x, 3) for k, x in ms.items()} }", flush=True)
    return bad


def world_spawn(backend: str, n: int, full: bool) -> tuple:
    """world_rank on a fresh world of n ranks: (every rank's record, the
    seconds from spawn to end)."""
    from repro_torch.dist import world
    t0, at = time.perf_counter(), time.time()
    every = world.spawn(world_rank, n, backend=backend,
                        device="cuda:0" if backend == "gloo" else None,
                        args=(WORLD_ROWS, full),
                        deadline_s=WORLD_DEADLINE_S,
                        timeout_s=WORLD_COLLECTIVE_S)
    end = time.time()
    for rec in every:   # a rank's start (spawn to its function) and end
        rec["secs"]["start"] = rec["entered_at"] - at
        rec["secs"]["end"] = end - rec["left_at"]
    return every, time.perf_counter() - t0


def world_gloo_check(dev: dict, virtual: dict, want: dict, every: list,
                     wall: float) -> dict:
    """The gloo world's records: every answer equal on every rank and to
    the unsharded engine; every kernel that `virtual` (the virtual sharded
    main, grouped main and degraded phases' launches) launched must launch
    here; the compressed psum's bits equal the virtual (4, 2) mesh's."""
    from repro_torch.dist import compression
    from repro_torch.launch.mesh import make_mesh
    label = "[gloo]"
    bad = world_check(every, want, label)
    tree = psum_tree()
    digest = tree_digest(compression.compressed_psum_pod(
        tree, make_mesh(*COMPRESS_MESH), axis="pod"))
    for rec in every:
        if rec["psum"]["digest"] != digest:
            bad.append((label, rec["rank"], "psum bits differ"))
        if not rec["psum"]["max_rel_err"] < COMPRESS_BOUND:
            bad.append((label, rec["rank"], "psum bound",
                        rec["psum"]["max_rel_err"]))
    del tree
    launches = {k: sum(r["launches"][k] for r in every)
                for k in every[0]["launches"]}
    needed = sorted({k for runs in virtual.values() for k, v in runs.items()
                     if v})
    zero = [k for k in needed if not launches[k]]
    print(f"{label} [{dev['smi']}] {WORLD_RANKS} ranks, {WORLD_ROWS} rows "
          f"(2^{WORLD_ROWS.bit_length() - 1}): spawn to end {wall:.3f} s; "
          f"launches summed over ranks {launches}; kernels of the virtual "
          f"phases {needed}; psum worst "
          f"{max(r['psum']['max_rel_err'] for r in every):.6f} (bound "
          f"{COMPRESS_BOUND}), bits equal to the virtual mesh "
          f"{all(r['psum']['digest'] == digest for r in every)}",
          flush=True)
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} world (gloo) results differ")
    if zero:
        fail(f"kernels of the virtual sharded phases never launched in the "
             f"gloo world: {zero}")
    return {"ranks": WORLD_RANKS, "rows": WORLD_ROWS, "wall_s": wall,
            "launches": launches, "card": dev["smi"],
            "per_rank": [{k: r[k] for k in ("rank", "launches", "bytes",
                                            "resident_bytes", "ms", "secs",
                                            "path_s", "peak_gib", "psum")}
                         for r in every],
            "dispatch": {k: v for k, v in every[0].items()
                         if k.startswith("dispatch")}}


def world_nccl_check(dev: dict, want: dict, every: list, wall: float) -> dict:
    """The nccl world's records (device_count() ranks, one a card): the
    eleven plans on the plain view, equal to the unsharded engine's."""
    label = "[nccl]"
    bad = world_check(every, want, label)
    launches = {k: sum(r["launches"][k] for r in every)
                for k in every[0]["launches"]}
    print(f"{label} [{dev['smi']}] {len(every)} rank(s): spawn to end "
          f"{wall:.3f} s (beside the gloo world); launches {launches}",
          flush=True)
    if bad:
        for b in bad:
            print("MISMATCH", str(b)[:2000], file=sys.stderr)
        fail(f"{len(bad)} world (nccl) results differ")
    if not (launches["scan_filter"] and launches["aggregate_batched"]
            and launches["scan_aggregate_batched"]):
        fail(f"the nccl world's flat path launched no kernel: {launches}")
    return {"ranks": len(every), "rows": WORLD_ROWS, "wall_s": wall,
            "launches": launches, "card": dev["smi"],
            "per_rank": [{k: r[k] for k in ("rank", "launches", "bytes",
                                            "resident_bytes", "ms", "secs",
                                            "path_s", "peak_gib")}
                         for r in every]}


def world_phases(dev: dict, sharded: dict, kernels: list) -> dict:
    """Both world phases, the nccl world (device_count() ranks) started
    beside the gloo world (WORLD_RANKS ranks sharing the card); their
    launches join the kernels line as "launches_world" (summed over ranks,
    and per rank)."""
    from concurrent.futures import ThreadPoolExecutor
    virtual = {f"main {n}": r["launches"]
               for n, r in sharded["main"].items()}
    virtual.update({f"grouped_main {v}": r["launches"]
                    for v, r in sharded["grouped_main"].items()})
    virtual["degraded"] = sharded["degraded"]["launches"]
    # the ranks need the card: what the query phases left must go first
    release()
    held = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.memory_reserved() / 2**30}
    print(f"before the worlds this process holds {held}", flush=True)
    phase(f"world (gloo, {WORLD_RANKS} ranks on one card)")
    import shutil
    WORLD_STORE.parent.mkdir(parents=True, exist_ok=True)
    WORLD_STORE.unlink(missing_ok=True)
    shutil.rmtree(WORLD_TRAIN_DIR, ignore_errors=True)
    try:
        with ThreadPoolExecutor(3) as pool:
            gloo = pool.submit(world_spawn, "gloo", WORLD_RANKS, True)
            nccl = pool.submit(world_spawn, "nccl",
                               torch.cuda.device_count(), False)
            prep = world_prepare()
            # this process's train run and its read of A's file, beside them
            parent = pool.submit(world_train_parent)
            gloo_every, gloo_wall = gloo.result()
            out = {"gloo": world_gloo_check(dev, virtual, prep["want"],
                                            gloo_every, gloo_wall),
                   "parent": held,
                   "setup": {k: v for k, v in prep.items() if k != "want"}}
            phase(f"world (nccl, one rank a card: "
                  f"{torch.cuda.device_count()})")
            nccl_every, nccl_wall = nccl.result()
            out["nccl"] = world_nccl_check(dev, prep["want"], nccl_every,
                                           nccl_wall)
            parent = parent.result()
        del prep
        release()
        out["train"] = world_train_check(dev, gloo_every, nccl_every,
                                         parent)
    finally:
        WORLD_STORE.unlink(missing_ok=True)
        shutil.rmtree(WORLD_TRAIN_DIR, ignore_errors=True)
    release()
    for rec in kernels:
        runs = {}
        for backend, w in ((b, out[b]) for b in ("gloo", "nccl")):
            if w["launches"].get(rec["name"]):
                runs[backend] = {
                    "ranks": w["ranks"], "sum": w["launches"][rec["name"]],
                    "per_rank": [r["launches"][rec["name"]]
                                 for r in w["per_rank"]]}
        if runs:
            rec["launches_world"] = runs
    return out


def main() -> None:
    dev = device_phase()
    sys.path.insert(0, str(SRC))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        fail(f"cannot import the port from {SRC}: {e}")
    phase("build")
    t0 = time.perf_counter()
    for name, rep in _build.build().items():
        print(f"built {name} in {rep['seconds']:.3f} s")
        print(rep["log"].strip())
    print(f"build total {time.perf_counter() - t0:.3f} s", flush=True)
    parity_err = parity_phase()
    parity_err.update(batched_parity_phase())
    parity_err.update(group_parity_phase())
    attn_errs, attn_check = attention_parity_phase()
    parity_err.update(attn_errs)
    attn_check["graph_replay"] = attention_graph_phase()
    ssd_errs, ssd_check = ssd_parity_phase()
    parity_err.update(ssd_errs)
    table = build_table()
    launches = main_phase(table)
    kernels = times_phase(table, dev, launches, parity_err)
    profile_phase(table, plan_shapes(), "main")
    paper_engine = paper_engine_phase(table, dev)
    shapes = grouped_main_shapes(build_dim({"a": [1, 3, 5, 99, 127]}))
    grouped = {"main": grouped_phase(table, shapes, "main", MAIN_ROWS)}
    profile_phase(table, shapes, "grouped main")
    group_main = group_times_main(table, dev)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.query import ShardedTable
    mesh8 = make_mesh((8,), ("data",))
    sharded = {"main": sharded_main_phase(table, dev)}
    views, sharded["main_delta"] = main_views(table, mesh8)
    sharded["grouped_main"] = sharded_grouped_phase(
        "main", views, shapes, grouped["main"]["results"])
    sharded["degraded"] = degraded_phase(
        views, build_dim({"a": [1, 3, 5, 99, 127]}))
    del table, shapes, views
    release()

    from repro_torch.store import EncodedTable
    table = build_store_table()
    t0 = time.perf_counter()
    encoded = EncodedTable.from_table(table, chunk_rows=STORE_CHUNK_ROWS)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    launches = store_phase(table, encoded, encode_s)
    kernels += store_times_phase(encoded, dev, launches, parity_err)
    profile_phase(encoded, store_plan_shapes(), "store")
    shapes = grouped_store_shapes(build_dim({"r": [1, 3, 5, 99],
                                             "u": [2, 7, 50, 90]}))
    grouped["store"] = grouped_phase(encoded, shapes, "store", STORE_ROWS,
                                     plain=table, rounds=2)
    profile_phase(encoded, shapes, "grouped store")
    store_dense, store_rle = group_times_store(encoded, dev)
    launches = {p: g["launches"] for p, g in grouped.items()}
    zero = [k for k in ("group_sum_count_batched",
                        "rle_group_accumulate_batched")
            if not sum(l[k] for l in launches.values())]
    if zero:
        fail(f"kernels never launched on the grouped paths: {zero}")
    kernels += group_records(group_main, store_dense, store_rle, launches,
                             parity_err)
    sharded["store"], se = sharded_store_phase(table, encoded, dev)
    sharded["grouped_store"] = sharded_grouped_phase(
        "store", {"plain": ShardedTable.shard(table, mesh8), "delta": se},
        shapes, grouped["store"]["results"])
    del se
    release()
    tier = {"main": tiered_main_phase(dev)}
    tier["store"] = tiered_store_phase(table, encoded,
                                       tier["main"]["fast_gbps"], dev)
    print(json.dumps({"tier": tier}, default=str), flush=True)
    for rec in kernels:
        if rec["name"] in tier["main"]["launches"]:
            rec["launches_tiered"] = {p: t["launches"][rec["name"]]
                                      for p, t in tier.items()}
        if rec["name"] in paper_engine["launches"]:
            rec["launches_paper_model"] = \
                paper_engine["launches"][rec["name"]]
    paper = paper_model_phase(paper_engine, tier, encoded.ratio, dev)
    print(json.dumps({"paper_model": paper}, default=str), flush=True)
    sharded["chaos"], obs = chaos_phase(dev, tier["main"]["fast_gbps"])
    obs["tiered"] = obs_tiered_phase(tier, table, encoded, dev)
    obs["devices"] = obs_devices_phase()
    print(json.dumps({"sharded": sharded}, default=str), flush=True)
    print(json.dumps({"obs": obs}), flush=True)
    for rec in kernels:
        runs = sharded_launches(sharded, rec["name"])
        if runs:
            rec["launches_sharded"] = runs
        runs = obs_launches(obs, rec["name"])
        if runs:
            rec["launches_obs"] = runs
    # the LM slice needs the card's memory: drop the query tables first
    del table, encoded, shapes
    torch.cuda.empty_cache()
    world = world_phases(dev, sharded, kernels)
    print(json.dumps({"world": world}, default=str), flush=True)
    model, engine, serve = serve_phase(dev)
    del engine
    release()
    serve["parity"] = tf_parity(model, serve_config(), SERVE_MAX_LEN,
                                "serve parity", SEED + 2)
    del model
    release()
    kernels += attention_times(dev, serve["launches"], parity_err)
    serve["attention_parity"] = attn_check
    model, mamba = ssd_serve_phase(dev)
    mamba["parity"] = ssd_serve_parity_phase(model)
    del model
    release()
    kernels += ssd_times(dev, mamba["launches"], parity_err)
    for rec in kernels:
        if rec["name"] == "ssd_chunk":      # the world's train slice
            rec["launches_world_train"] = world["train"]["launches"]
    mamba["ssd_parity"] = ssd_check
    serve["mamba2"] = mamba
    dist: dict = {}
    griffin_moe_phases(dev, kernels, serve, dist)
    launch = launch_phases(dev, kernels, dist)
    dist["pipeline"] = pipeline_phase(dev)
    dist["production_bytes"] = production_bytes_phase()
    dist["dryrun"] = dryrun_phase(dev)
    train = train_phases(dev, kernels, dist["dryrun"])
    print(json.dumps({"dist": dist}, default=str))
    print(json.dumps({"launch": launch}, default=str))
    print(json.dumps({"train": train}, default=str))
    print(json.dumps({"serve": serve}, default=str))
    torch.cuda.synchronize()
    phase(None)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"],
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
