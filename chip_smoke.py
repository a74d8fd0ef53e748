"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card
and the CUDA toolkit.  It imports nothing of JAX.  Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. the card: its name and power limit (``nvidia-smi``);
2. build: every kernel under ``src/repro_torch/csrc`` with ``nvcc`` (one
   process per source, all at once) into ``build/torch_kernels``;
3. kernels against their plain PyTorch versions on the card, bitwise:
   ``fused_agg_opt`` over five optimizers x K in {1, 2, 3, 8} x four
   (grad, param) dtype pairs x N in {8192, 3*8192+77} x average on and off
   (off: the async path), step 5, lr_scale 0.7; and its row interface
   (rows in their own allocations, null rows, ``grad_scale``, a chunk-id
   table over whole pushes, each pointer and then all of them one element
   off 16-byte alignment; K up to 256, two 4M-element slabs, and K = 257
   refused);
   ``quantize_chunks``/``dequantize_chunks`` over N in {8192,
   37*8192} x chunk in {128, 8192}, and N = 5*65536 at chunk 65536, with
   zero, NaN and inf chunks, each slab also one element off alignment;
   ``wire_fused`` over none/bf16/int8 x five optimizers x K in {1, 2, 3,
   8} x average on and off, against its plain version and against the
   unfused kernel pipeline (dequantize, then ``fused_agg_opt``);
   ``embedding_bag`` over B in {1,
   7, 4096} x L in {1, 3, 33} x D in {16, 128, 130} x {sum, mean} with
   zero-weight padding, all-padding bags, NaN and inf rows, int32 and int64
   indices, and ``segment_sum`` with duplicate-heavy, strided and special
   rows;
4. the f32 main path at full width: gemma3-1b (26 layers, d=1152, vocab
   262144, bf16) trained for 3 rounds by 2 workers through a 4-shard
   PBoxFabric with AdamW over the raw f32 wire.  Every kernel launch count
   is set to 0 just before and read just after; shard 0's first update is
   captured and replayed through the plain version, bitwise;
5. the int8 main path: the same loop with the int8 wire codec (error
   feedback on, fused wire path on).  The counts are set to 0 just before
   and read just after: 6 quantize, 6 dequantize, 12 wire_fused and no
   fused_agg_opt launches, 3 fused wire rounds.  Shard 0's first
   ``apply_wire`` is replayed through ``wire_fused_torch`` and through the
   unfused kernel pipeline, and worker 0's round-2 quantize (of its
   error-corrected gradients) and dequantize through their plain versions,
   all bitwise;
6. the DLRM sparse main path at full width: dlrm-mlperf (26 Criteo tables
   capped at 10M rows a table, 52,487,036 rows x 128 f32, each padded to a
   multiple of 4 rows; the published MLPs) trained for 3 rounds by 2 workers x 32,768 samples, the dense MLPs
   through a 4-shard PBoxFabric and the tables through a fabric-attached
   SparseTier (hash placement, codec none, SGD 0.1 on both).  The counts
   are set to 0 just before and read just after: 156 embedding_bag, 156
   segment_sum, 12 fused_agg_opt and no codec launches.  Worker 0's
   round-2 lookup of t0 and its coalescing of t0 and t5 (3 rows) are
   replayed through the plain versions, bitwise;
7. sharding independence on the card: the DLRM SMOKE loop at batch 4,096
   with heavily repeated ids, codecs none and int8 (error feedback on), 1
   shard against 4: tables, row versions and dense params bitwise equal;
8. the backup quorum at full width (gemma3-1b, AdamW, 4 shards; phases
   8-10 run with torch's deterministic algorithms, since they compare
   recomputed gradients): 3 workers, ``min_push_fraction`` 0.5, 3 rounds
   in which all pull, workers 0 and 1 push (K = 2) and worker 2's
   superseded push is dropped.  Counts set to 0 just before and read just
   after: 12 fused_agg_opt launches, 3 steps, 3 partial aggregations, 3
   late pushes dropped; the params bitwise equal to a 2-worker sync
   fabric fed workers 0 and 1's batches;
9. async at full width on the int8 wire (error feedback, fused wire
   path): 2 workers at speeds [1, 2], 9 pushes, each applied at once.
   Counts: 9 quantize, 9 dequantize, 36 wire_fused (K = 1, no averaging),
   no fused_agg_opt; shard 0's first apply_wire replayed through
   ``wire_fused_torch`` and the unfused kernel pipeline, bitwise;
10. snapshot, rebalance and restore at full width (f32 wire, 2 workers):
   run A takes a mid-round snapshot in round 3 (15.6 GB to host), drains
   shard 3 through a ShardRebalancer and trains to round 5; run B restores
   the snapshot onto a fresh 2-shard fabric and replays rounds 3-5.  A
   and B end bitwise equal, the snapshot is unchanged by A (SHA-1), and a
   second restore gives its bits back;
11. every mode (quorum, SSP with staleness 1, async) x codec (none, int8)
   at the SMOKE config, the fabric on the card against the fabric on the
   CPU, bitwise, each with a mid-round ``Checkpointer.save_fabric`` /
   ``restore_fabric`` round trip;
12. the f32 rack chain at full width (gemma3-1b, AdamW, 4 shards; phases
   12 and 13 under deterministic algorithms too): 4 workers over a
   ``NetworkTopology`` of 2 racks with a 1:4 core, codec none, 3 rounds.
   Counts: 12 fused_agg_opt, no codec launches; 6 rack streams; the core
   link carries 2 f32 streams a round.  The params bitwise equal to a
   4-worker flat fabric fed the same batches, whose core carries 4;
13. the switch pools at full width on the int8 wire (error feedback, fused
   wire path): 2 workers, one a rack, with ToR and core pools of one slot
   per chunk (158,912): every round offloaded to both pools; counts 12
   wire_fused, no quantize / dequantize.  Then pools one slot short
   (starved, never engaged): counts 12 quantize, 12 dequantize, 12
   wire_fused, and params bitwise equal to the same topology fabric with
   no switch tier;
14. every codec (none, bf16, int8) x mode (sync, quorum, SSP, async), the
   int8 wire also x switch (off, on, starved, a ToR pool or the core pool
   failed at round 2 and restored at round 3 by a ``FaultPlan``; the pools
   engage only there) at the SMOKE config over
   2 racks, the fabric on the card against the fabric on the CPU, bitwise
   in params, state, residuals, every stats field and ``fault_trace``;
15. failover and reshard at full width (gemma3-1b, AdamW, 4 shards, under
   deterministic algorithms): 2 workers, one in each of 2 racks (1:4
   core), codec none, 4 rounds.  Run A, replication 1, fault-free: 16
   fused_agg_opt launches and no chain.  Run B, replication 2 (the chain
   a device copy of p, m and v, 15,621,685,248 bytes, every hop across
   the core): rack 1's link degraded 3x after round 1, shard 1 crashed
   after round 2 (promote, re-silver), the link restored after round 3,
   then ``reshard(2)``; 12 + 2 fused_agg_opt launches.  B's params and
   both AdamW slots equal A's bitwise, its losses A's, its exported fault
   trace the CPU rehearsal's (the same schedule at the SMOKE config), and
   its replication, re-silver and core-link bytes the arithmetic; each
   chain pass, the failover and the reshard are timed with the peaks;
16. the fault tier at the SMOKE config, card == CPU bitwise (params,
   state, residuals, every stats field, the fault traces): codec (none,
   bf16, int8) x replication (1, raising ShardLost; 2; 3, the same shard
   crashing twice in consecutive rounds) x racks (1, 2) x a crash after
   round 1 or 2; a worker crash and re-entry through
   ``elastic.worker_reentry``; a SparseTier on a replicated fabric with a
   shard crash, its lookups included.  Each failover also equals the
   card's fault-free run;
17. the tenancy tier at full width (under deterministic algorithms): two
   gemma3-1b tenants on one ``MultiJobFabric`` (4 shards, 2 racks, 1:4
   core), each 2 workers (one a rack), AdamW, codec none, R = 1: ``a``
   (init seed 0, priority 2) and ``b`` (init seed 1, priority 1, its own
   batch seeds), their workers interleaved tick by tick.  Rounds 1-2 with
   both attached, ``detach("b")`` (a 15.6 GB host snapshot), ``a``'s round
   3 alone, ``b`` re-attached from its snapshot (namespace [2c, 3c), c =
   158,912 chunks) for its round 3.  Counts: 24 box fused_agg_opt, no codec
   launch.  Each tenant's params, m and v equal its ``dedicated_fabric``
   twin's (12 launches, the same batches) bitwise, compared on the card
   while only that tenant's final slabs are kept; losses and pushed /
   pulled bytes equal; a round adds 1.5x ``a``'s dedicated
   ``sim_wire_us`` and 3.0x ``b``'s, 1.0x for ``a`` alone (to 1e-12
   relative), and ``a``'s simulated step time stays under ``b``'s;
   ``utilization()`` holds both tenants on every link with contention > 1,
   ``shard_occupancy()`` both on every shard (39,728 chunks each), and
   ``route()`` sends global ids of each namespace to the owning shard.
   Each round (shared and dedicated), the detach and the re-attach are
   timed, with the peaks;
18. the tenancy tier at the SMOKE config, card == CPU bitwise in every
   tenant's params, state and residuals, every stats field, the fault
   traces and the box's utilization, shard occupancy, routes and
   describe: 1 and 3 tenants x shards (1, 4) x racks (1, 2) x codec
   (none, bf16, int8); a sync / quorum / SSP mix; switch-slot grants (one
   granted, one refused, the grant returned at detach and handed on); a
   box-wide ``crash_shard`` (R = 1 raising ``ShardLost`` after the R = 2
   tenant's failover); an elastic re-attach onto 3 shards; tenant shares
   in mid-run.  Each tenant also equals its dedicated twin on the card,
   and each case's launches equal the CPU run's plain-version calls;
19. every kernel and its plain version timed at its main path's shape with
   CUDA events, beside its byte bound and, where one PyTorch call computes
   the same function, that call's time (embedding_bag also at one
   multi-hot shape, B = 32,768 x L = 20; fused_agg_opt and wire_fused also
   at K = 1 without averaging, as the async path runs them, fused_agg_opt
   there beside ``torch._fused_adamw_`` or its refusal); and the
   switch pool's plain-torch integer math (shared scale, int8 encode,
   residual, int32 slot sum, dequantize) at full width;
20. the serving path at full width (run after phase 18): gemma3-1b served
   through ``launch/serve.py``'s body, ``serve(arch.config, args)`` (its
   gradients drawn block by block: the one-shot draw's bits), with
   the CLI's arguments (``--source fabric --train-rounds 1``, 4 shards, 2
   racks at 1:4, R = 2, 2 workers, batch 4, a 1024-token prompt, 32
   tokens, ``--max-staleness 1``).  Counts set to 0 just before the call
   and read just after: 4 fused_agg_opt, no codec launch.  The read (from
   the chain tails) equals ``fabric.params`` bitwise at version 1; after a
   round of card-drawn gradients the cached read still holds version 1's
   bits (SHA-1 and a kept copy) and a ``max_staleness=0`` read version
   2's.  The scan decode's logits against a forward of the 1,055-token
   sequence and the unrolled decode's (rolling 512-slot caches) against
   the scan decode's, within 5 % of the largest logit; ``assemble``, a
   miss, a hit, the prefill and a decode step timed, with the peak.  Then
   ``--source checkpoint`` (saved at round 0, restored, served back
   bitwise);
21. sparse serving at full width: dlrm-mlperf (as phase 6) under a 2-rack
   ``NetworkTopology``, R = 1: one training round (52 embedding_bag, 52
   segment_sum, 4 fused_agg_opt), then a ``SparseReadPlane`` of 2
   frontends serving a Zipf(1.05) trace of 12 x 4,096 rows over the two
   largest tables, a second round between reads; every served row equals
   ``tier.table(name)[ids]`` bitwise; hit rate, rack and core bytes and
   ms per ``read_rows`` batch reported;
22. the serving path at the SMOKE config, card == CPU bitwise in every
   read, stats field, clock float, served request and ``describe``:
   ReadPlane and HierarchicalReadPlane over 1 and 2 racks x R = 1, 2, 3
   with a shard crash between reads; a FrontDoor over ``generate_trace``
   traces (open, closed loop, diurnal, flash crowd, a mixed trace through
   a hierarchical plane); serve tenants on a MultiJobFabric over codecs
   none, bf16, int8; a SparseReadPlane at R = 2 over 2 racks with a shard
   failover and a fabric ``restore`` between reads; each case's launches
   equal to the CPU run's plain-version calls.  Then prefill and the scan
   and unrolled decodes in f32, card against CPU: ids equal, logits
   within 1e-4 of the largest.

23. the closed loop at full width (under deterministic algorithms, after
   phase 15): gemma3-1b, 2 workers (one a rack, 1:4 core), AdamW, codec
   none, R = 2, a ReadPlane of 2 frontends, an Autoscaler (``min_shards``
   4, ``max_shards`` 8, ``scale_up_busy_us`` 0.0, cooldown 10 rounds,
   ``solve_placement``).  Round 1; ``auto.step()`` doubles the shards to 8
   through ``reshard`` and ``resolve_placement`` applies the solver's
   deltas; rounds 2-3; ``auto.apply_plan`` of a 4-shard plan from
   ``PlacementProblem.standard(...).solve(seed=0)`` (one ``shard_count``
   delta: ``reshard(4, plan=...)``); round 4.  Counts set to 0 just before
   and read just after: 24 fused_agg_opt, no codec launch;
   ``rescales == 2``; the live plan equals the host re-solve after
   ``step()`` (chain and frontend racks) and the applied plan's chain
   racks after ``apply_plan``, the events equal ``diff_plans``; params
   and both AdamW slots hash (SHA-1) to phase 15's fixed-layout R = 1 run
   A and the losses equal its; a read after round 4 equals
   ``fab.params``, a read taken before the second reshard keeps its bits.
   Rounds, ``step`` / ``apply_plan`` with the solve split out, reshards,
   allocator retries and the peak are reported;
24. the closed loop at the SMOKE config, card == CPU bitwise in params,
   slots, residuals, every stats field, fault traces, ``auto.events``,
   ``describe()``, ``telemetry()``, reads and sparse tables: codec none /
   int8 x racks 1 / 2 / 4 x shards 1 -> 2, 2 -> 8, 8 -> 2; scale-up and
   scale-down from busy telemetry; straggler proposals on the delta path;
   ``resolve_placement``; two sparse autoscaled runs whose 8-shard plan
   carries a solved row map from a Zipf row load; a sparse reshard and
   failover; ``tenant_shares`` through ``shared=`` on a MultiJobFabric;
   each autoscaled run equal to its fixed-layout twin on the card, each
   case's launches equal to the CPU run's plain-version calls;
25. the SPMD path at full width (under deterministic algorithms, a
   world-1 NCCL process group, ``launch/steps.build_lm_train``):
   gemma3-1b trained by the PS train step with AdamW, a batch of 2 x 1024
   tokens, 3 steps each under pbox and allreduce on a 1 x 1 (data, model)
   mesh and pbox_hier with the int8 codec and error feedback on a 1 x 1 x
   1 (pod, data, model) mesh.  Counts set to 0 just before each and read
   just after: 3 fused_agg_opt (and 3 quantize, 6 dequantize under
   pbox_hier); pbox == allreduce bitwise in params, m and v; the step-1
   losses equal; ``attach_telemetry``'s bytes the exchange's model; step
   2's ``device_update`` booked over three windows of 64 chunks and
   replayed through the same function on the CPU (the plain versions),
   bitwise.  Steps (host clock), ``device_update`` (CUDA events) and the
   peak are reported;
26. the SPMD step at gemma3-1b's SMOKE config, world 1, card == CPU
   bitwise: strategy x codec (none; bf16 and int8 under pbox_hier) x
   optimizer, each once with 1 microbatch and an f32 pull and once with
   3 microbatches and a bf16 pull, each
   microbatch's gradient booked on the card and fed to the same step on
   the CPU through a loss whose gradient it is; launches equal to the CPU
   run's plain-version calls; the zero-compute step of each strategy
   moving every parameter to -0.1;
27. ``launch/train.main`` on the card at the SMOKE config: 6 steps with
   checkpoints at 3 and 6, then a run stopped after step 3 and resumed to
   6, bitwise equal to it (the CLI's ``--full`` trains ``train_4k``'s
   256 x 4096 batch, which one card does not hold: phase 25 is the full
   width);
28. two ranks in two processes on cuda:0 over gloo (NCCL takes one rank a
   card): pbox, allreduce and pbox_hier int8 over 2 pods at the SMOKE
   config, each rank equal to the same exchange done by hand, bitwise;
29. remat and q-chunked attention at full width (world 1, deterministic
   algorithms): one 1 x 4096 ``lm_loss_and_grad`` with remat off, then on,
   each twice (host clock, peak above the weights), bitwise equal in the
   loss and every gradient; then ``train_4k`` at its published 4096
   tokens, the global batch cut from 256 to 8 sequences, through
   ``build_lm_train`` in as many microbatches as the remat peak allows
   and the SPMD step (pbox, AdamW), 3 steps; counts set to 0 just before
   and read just after: 3 fused_agg_opt;
30. the LM serving cells at tp = 1 through ``build_cell``'s plans:
   ``prefill_32k`` at 1 x 32768 (batch cut from 32) twice, its greedy ids
   equal, beside the computed bytes of one unchunked layer's f32 scores;
   ``decode_32k`` at 16 x 32768 (batch cut from 128) from a seeded cache,
   8 steps ending at position 32767; ``long_500k``'s unrolled decode from
   seeded caches, 8 steps ending at position 524287 (a 524,288-token
   prefill is O(S^2) and not run); no kernel launch;
31. tensor parallelism on the one card: 2 gloo ranks on cuda:0, mesh
   (1, 2), gemma3-1b at full width (4 heads over 2 ranks, R = 1, kv
   replicated): 2 train steps of 1 x 1024 (pbox, AdamW), a 1 x 1024
   prefill and 8 decode steps, against the same seeded model at tp = 1
   on the card: the step-1 loss within 1e-2 relative, the gathered
   parameters within 2 x (2.5 lr + one bf16 ulp of the largest), the
   share of greedy ids that agree printed, the model-axis collectives'
   host ms a step; then the SMOKE config on 4 gloo ranks at tp = 4 (R =
   1, kv replicated) and tp = 2, loss at rtol 2e-5 / atol 1e-5 and greedy
   ids equal to tp = 1 on the card.  The 2 ranks then run phase 36's
   recsys tp = 2 pass and phase 45's ``serve_lm`` and tp = 1
   ``train_distributed_ps``, and the 4 ranks phase 43's GNN channel TP
   and edge parallelism and phase 45's ``train_distributed_ps`` (one
   spawn each serves them all);
32. the recsys family on the SPMD path (phases 32-36 inside a world-1
   NCCL group and deterministic algorithms): dlrm-mlperf ``train_batch``
   by ``pbox_sparse`` (``launch/steps.build_recsys_train_sparse``) at its
   published widths, tables capped at 10M rows (25.03 GiB), 65,536 rows,
   4 steps: the MLPs through the exchange (counts: 1 fused_agg_opt a
   step), the tables through ``runtime/sparse_push.sparse_table_update``;
   step 2's table update booked on the card (ids, cotangents, lr, every
   touched row before and after) and replayed on the CPU, bitwise; the
   sparse wire bytes (B x F x (2D + 4)) and ``attach_telemetry``'s dense
   bytes reported;
33. tests/scripts/sparse_push_equivalence.py on the card: one dlrm-mlperf
   ``train_batch`` step by pbox with the tables in the flat (rows capped
   at RS_DENSE_CAP = 4M) and one by pbox_sparse from the same params and
   batch: losses within 1e-6, MLPs at rtol 1e-5 / atol 1e-6, tables
   within 5e-3 (the bf16 wire); a second step of each timed;
34. dlrm-mlperf's ``serve_p99`` (512), ``serve_bulk`` (262,144) and
   ``retrieval_cand`` (1,048,576 candidates) plans on phase 32's trained
   params, each bitwise equal to a direct ``dlrm_score`` /
   ``bulk_retrieval`` call; no kernel launch;
35. AutoInt, DIEN and xDeepFM at their published configs: ``train_batch``
   by pbox for 2 steps (the published 65,536 rows or the largest
   power-of-two fraction a probe step's peak allows), ``serve_p99`` and
   ``retrieval_cand`` bitwise equal to the direct calls;
36. the 17 recsys SMOKE cases (4 archs x 4 cells, DLRM's pbox_sparse step)
   card == CPU within rtol 1e-5 / atol 1e-6, launches equal to the CPU's
   plain-version calls; then dlrm-mlperf SMOKE at tp = 2 over 2 gloo ranks
   on cuda:0 (one dense and one sparse step: the lookup's psum_scatter,
   the cotangents' all-gather; run by phase 31's 2 ranks) against tp = 1
   on the card at the same bound.  Phase 19 also times ``fused_agg_opt`` as the recsys steps run
   it (SGD, K = 1, f32, the MLP flat) by CUDA-graph replay, beside
   ``Tensor.add_(g, alpha=-lr)``, the one PyTorch call for that update.
   The line before the kernel table gives the seconds of each group of
   phases;
37. first the fused norm (``kernels/group_norm``) in all three modes at
   every norm shape of ResNet-50 at 32 x 224^2 against its plain version
   on the card (output, dr and repeat bits bitwise, dx / ds / db within
   GN_RTOL / GN_DX_ATOL / GN_DS_ATOL, which a backward that forgets the
   group statistics' terms must fail), and the channels-last copy
   (``kernels/layout``) at each operand of the channels-last weight
   gradients, bitwise (``resnet_norm_check``); then ResNet-50 through the
   PHub fabric, the paper's setting (the model runs
   its convolutions with cuDNN's TF32 off, ``resnet._conv2d``): the
   published config (25,557,032 parameters), 2 workers x 32 images at
   224^2, 4 shards,
   momentum(0.1, 0.9), the f32 wire, 3 rounds; counts set to 0 just before
   and read just after: 12 fused_agg_opt (K = 2), and per worker step 49
   fused-norm forward passes, 53 backwards and 19 channels-last copies
   (``_rn_launches``, here and in phases 38 and 41); round 2 by host clock,
   round 3 profiled (device busy, idle share, fused_agg_opt's device ms);
   shard 0's first update replayed through the plain version, bitwise;
   finite losses; the peak;
38. ResNet-50's ``imagenet_train`` through ``launch/steps`` (world 1,
   NCCL, deterministic algorithms), pbox, momentum, 3 steps at 224^2: the
   published global batch of 256 if a 16-image probe step's peak allows
   it, else the largest power-of-two fraction; 1 fused_agg_opt (K = 1) a
   step; step 2's ``device_update`` booked and replayed on the CPU,
   bitwise; step ms and the peak;
39. granite-moe-1b-a400m at its published widths: ``train_4k`` at 4096
   tokens with remat, the batch cut to 8 sequences in as many
   microbatches as a 1 x 4096 step's peak allows (as phase 29), pbox
   AdamW with bf16 operands, 3 steps (3 fused_agg_opt), each step's aux
   loss and the share of assignments the capacity dropped; then
   ``prefill_32k`` at 1 x 32768 twice (greedy ids equal) and
   ``decode_32k`` at 16 sequences, 8 steps;
40. qwen2-moe-a2.7b served at its published widths (14.3B parameters):
   ``prefill_32k`` at 1 x 32768 once and ``decode_32k`` at the largest
   batch whose cache fits beside the weights, 8 steps (no training: its
   AdamW slots alone exceed the card);
41. the SMOKE configs of resnet50 (2 fabric rounds on gradients booked
   on the card, params bitwise; one SPMD step), granite, qwen2-moe,
   internlm2 and qwen2-72b (one train step by SGD, a prefill, 4 decode
   steps), card == CPU (resnet within RN_CARD_RTOL / RN_CARD_ATOL, which a
   control run with cuDNN's TF32 convolutions must fail; the LM train
   steps within rtol 1e-5 / atol 1e-6, their caches within 1e-5 of the
   largest entry), launches equal to the CPU run's plain-version calls;
   the MoE routing (``route_topk``'s
   experts, ``dispatch_indices``' ``buf_pos`` / ``keep``) bitwise card ==
   CPU on the same f32 logits.  Phase 19 also times fused_agg_opt at the
   three new shapes (momentum K = 2 over a shard's slab and K = 1 over
   the flat, the latter beside ``torch._fused_sgd_``; AdamW bf16 K = 1
   over granite's flat);
42. EquiformerV2 at its published widths (12 layers, C = 128, l_max 6,
   m_max 2, 8 heads; world 1, NCCL, deterministic algorithms), pbox
   AdamW(1e-3), 3 steps each of ``molecule`` (128 molecules x 30 atoms,
   64 edges each, graph regression; through ``launch/train.main
   --full``, flat 35,086,336) and ``full_graph_sm`` (cora's 2,708 nodes,
   10,556 edges, 1,433 features; through ``build_cell``'s plan on one
   seeded graph, flat 35,274,752): counts set to 0 just before and read
   just after, 1 fused_agg_opt (K = 1, f32) a step; step 1's
   ``device_update`` booked and replayed on the CPU through the plain
   version, bitwise; finite losses; step 2's ms, the peak, step 3
   profiled (device busy, idle share, the top device ops);
43. the four graph cells at SMOKE (molecule also edge-parallel), one
   SGD(0.1) step card == CPU (f32 within rtol 1e-5 / atol 1e-6, the bf16
   ``ogb_products`` within GNN_BF16_RTOL of the largest entry), launches
   equal to the CPU run's plain-version calls; channel TP and edge
   parallelism run on phase 31's 4 gloo ranks (``full_graph_sm`` at
   SMOKE on a (2, 2) mesh against tp = 1 on the card).  Phase 19 also
   times fused_agg_opt at the GNN's shape (AdamW, K = 1, f32, N =
   35,086,336) beside ``torch._fused_adamw_``;
45. the example programs (``repro_torch.examples``): ``train_100m_e2e`` at
   its published CFG (12 layers, d 512, vocab 32768, f32) for its 200
   steps (counts set to 0 just before and read just after: 200
   fused_agg_opt, K = 1 AdamW without averaging; the first update
   replayed through the plain version bitwise and held to
   ``fused_aggregate_update_ref`` within E2E_REF_ATOL; the loss falls; the
   last checkpoint equals the final state bitwise; the steady step, each
   launch's ms in the run, the peak), then the quickstart (40 rounds, 160
   fused_agg_opt at K = 2, every one booked and replayed through the
   plain version bitwise), gnn_molecules (15 steps; the curve within
   GNN_EX_RTOL of the CPU's, its control with TF32 products outside it)
   and recsys_serving, each from CPU-drawn weights and held against the
   same program on the CPU; ``serve_lm`` at ``--mesh 1x2`` on phase 31's
   2 ranks (ids == the program at ``--mesh 1x1``) and
   ``train_distributed_ps`` on a (2, 2) mesh on its 4 ranks and at tp = 1,
   (2, 1), on its 2 (the ranks agree; the (2, 2) curve within EX_PS_RTOL
   of tp = 1's; each restores its step-20 state bitwise).  Phase 19 also
   times fused_agg_opt at the e2e shape (AdamW, K = 1, f32, the flat)
   beside ``torch._fused_adamw_``.

The line before the last is the kernel table as JSON (each row with its
launches on every path); the last line is ``{"ok": true, "device":
{...}}``.

``python3 chip_smoke.py --compare OTHER`` runs none of this: it times
fused_agg_opt at the main path's shapes (and the kernels sharing its
header) with this checkout's kernels and with another checkout's, in
turns on one card (``compare``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published device-memory rates (NVIDIA data sheets), keyed by a part of
# torch.cuda.get_device_name(); the H100 SXM's 3.35 TB/s is the default.
MEM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H200", 4.8e12), ("H100", 3.35e12))
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
ROUNDS, WORKERS, SHARDS, SEQ = 3, 2, 4, 1024
# the DLRM sparse path: the MLPerf global batch split over the workers, and
# the Criteo tables capped at 10M rows so tables and dense view fit the card
DLRM_BATCH, DLRM_ROW_CAP, DLRM_LR = 32768, 10_000_000, 0.1


def adamw_ops(k: int) -> int:
    """f32 operations per element of one AdamW update from K gradients:
    K-1 adds and the 1/K scale, then m (3), v (4), the bias corrections
    (2), sqrt, +eps, the divide, weight decay (2) and the lr step (2)."""
    return (k - 1) + 1 + 3 + 4 + 2 + 1 + 1 + 1 + 2 + 2


def log(*a) -> None:
    print(*a, flush=True)


def card_rate(name: str) -> float:
    for key, rate in MEM_BYTES_PER_S:
        if key in name:
            return rate
    return MEM_BYTES_PER_S[-1][1]


def bound(name: str, nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the f32 operations over the f32 peak."""
    byte_ms = nbytes / card_rate(name) * 1e3
    op_ms = ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(byte_ms, op_ms), "byte_ms": byte_ms,
            "op_ms": op_ms, "bytes": nbytes,
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def ptxas_summary(text: str) -> str:
    """One line from ``-Xptxas -v``'s report of a source with many kernel
    instantiations: their count, registers a thread, spill bytes and
    static shared memory (the dynamic ring is sized at launch)."""
    import re

    regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
    spills = [int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)]
    smem = [int(x) for x in re.findall(r"(\d+) bytes smem", text)]
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers a "
            f"thread, spill bytes {max(spills, default=0)} at most, static "
            f"shared memory {max(smem, default=0)} bytes at most")


def cuda_ms(fn, reps: int) -> float:
    """Median ms of ``fn()`` over ``reps`` runs, each between CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _on_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not e.is_user_annotation


def graph_ms(calls: list, replays: int = 5) -> float:
    """Device ms of one call: ``calls`` captured back to back in one CUDA
    graph, the graph replayed ``replays`` times between CUDA events, the
    median replay divided by the number of calls.  Around a launch of tens
    of microseconds, events around each call mostly measure the host's
    launch overhead (the card idles while Python prepares it); a replay
    launches the same kernels with none."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as torch asks
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    del graph
    return statistics.median(times)


def kernel_device_ms(prof, key: str) -> tuple:
    """(total device ms, launches) of the kernels whose name holds ``key``
    in a profiled window."""
    hits = [e for e in prof.key_averages() if _on_device(e) and key in e.key]
    return (sum(e.self_device_time_total for e in hits) / 1e3,
            sum(e.count for e in hits))


def max_abs_err(a, b) -> float:
    if not a.numel():
        return 0.0
    d = (a.float() - b.float()).abs()
    # NaN/inf in the same places on both sides agree; elsewhere they count
    same = (a.float() == b.float()) | (a.float().isnan() & b.float().isnan())
    return d.masked_fill(same, 0.0).max().item()


def same_bits(a, b) -> bool:
    """Bitwise equality, NaN payloads included."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))
    return torch.equal(a, b)


# -- phase 3 ---------------------------------------------------------------
def _specs():
    from repro_torch.optim import optimizers as O

    return [O.sgd(1e-2, weight_decay=0.01), O.momentum(1e-2, 0.9),
            O.momentum(1e-2, 0.9, nesterov=True), O.adam(1e-3),
            O.adamw(1e-3, weight_decay=0.1)]


def _state(rng, spec, n, dev):
    import numpy as np
    import torch

    st = [torch.from_numpy(rng.standard_normal(n, np.float32) * 0.1)
          for _ in range(spec.num_state_slots)]
    if len(st) == 2:
        st[1] = st[1].abs()
    return tuple(s.to(dev) for s in st)


def kernel_sweep(dev) -> float:
    import numpy as np
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet

    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
    worst, cases = 0.0, 0
    # average off: the async path's K = 1 pushes
    for average, spec, k, (gdt, pdt), n in itertools.product(
            (True, False), _specs(), (1, 2, 3, 8), dtypes,
            (8192, 3 * 8192 + 77)):
        rng = np.random.default_rng(cases)
        g = torch.from_numpy(rng.standard_normal((k, n), np.float32))
        p = torch.from_numpy(rng.standard_normal(n, np.float32))
        st = _state(rng, spec, n, dev)
        g, p = g.to(dev, gdt), p.to(dev, pdt)
        packet = scalar_packet(spec, 5, 0.7, device=dev)
        want_p, want_s = K.fused_agg_opt_torch(g, p, st, packet, spec,
                                               average=average)
        got_p, got_s = K.fused_agg_opt_cuda(
            g, p.clone(), tuple(s.clone() for s in st), packet, spec,
            average=average)
        torch.cuda.synchronize()
        pairs = [(got_p, want_p), *zip(got_s, want_s)]
        worst = max([worst] + [max_abs_err(a, b) for a, b in pairs])
        if not all(torch.equal(a, b) for a, b in pairs):
            raise AssertionError(
                f"fused_agg_opt differs from its plain version: {spec.name} "
                f"nesterov={spec.nesterov} k={k} n={n} {gdt}/{pdt} "
                f"average={average}, max |err| {worst}")
        cases += 1
    log(f"kernel sweep: fused_agg_opt == fused_agg_opt_torch bitwise in "
        f"{cases} cases (average on and off)")
    return worst


ROWS_NULL = {1: (), 2: (1,), 3: (1,), 8: (1, 5), 65: (2, 64), 256: (0, 9)}


def _rows_case(got_want, label: str) -> float:
    """Bitwise check of one rows-form case: ``got_want`` is ((param,
    state), (param, state)) of the kernel and the plain version."""
    import torch

    (got_p, got_s), (want_p, want_s) = got_want
    torch.cuda.synchronize()
    pairs = [(got_p, want_p), *zip(got_s, want_s)]
    err = max(max_abs_err(a, b) for a, b in pairs)
    if not all(same_bits(a, b) for a, b in pairs):
        raise AssertionError(f"fused_agg_opt differs from its plain version "
                             f"({label}), max |err| {err}")
    return err


def kernel_rows_sweep(dev) -> float:
    """The row interface against the plain version, bitwise: rows in their
    own allocations, null (zero) rows, ``grad_scale``, a chunk-id table
    over whole pushes, and each pointer in turn (then all of them) one
    element off 16-byte alignment, for 5 optimizers x K in {1, 2, 3, 8} x
    the 4 dtype pairs; K = 65 and 256 (the larger row capacities); and
    AdamW at 4M elements, where each block walks its ring many times."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet

    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
              (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)]
    chunk, push_chunks = 1024, 40
    worst, cases = 0.0, 0

    def run(rows, p, st, spec, packet, label, **kw):
        nonlocal worst, cases
        want = K.fused_agg_opt_torch(rows, p, st, packet, spec, **kw)
        got = K.fused_agg_opt_cuda(rows, p.clone(),
                                   tuple(s.clone() for s in st), packet,
                                   spec, **kw)
        worst = max(worst, _rows_case((got, want), label))
        cases += 1

    def case(spec, k, gdt, pdt, n, seed, big=False):
        rng = np.random.default_rng(seed)
        rows = [torch.from_numpy(rng.standard_normal(n, np.float32)).to(
            dev, gdt) for _ in range(k)]
        p = torch.from_numpy(rng.standard_normal(n, np.float32)).to(dev, pdt)
        st = _state(rng, spec, n, dev)
        packet = scalar_packet(spec, 5, 0.7, device=dev)
        null = ROWS_NULL[k]
        label = f"{spec.name} nesterov={spec.nesterov} k={k} n={n} {gdt}/{pdt}"
        run(rows, p, st, spec, packet, f"rows, {label}")
        nulled = [None if i in null else r for i, r in enumerate(rows)]
        run(nulled, p, st, spec, packet, f"null rows {null}, grad_scale 1/3,"
            f" {label}", grad_scale=1.0 / 3)
        # whole pushes read at a shard's chunk ids (no run, both ways)
        c = -(-n // chunk) if big else 24
        ids = torch.from_numpy(rng.permutation(max(push_chunks, c))[:c]).to(dev)
        pushes = [None if i in null else torch.from_numpy(rng.standard_normal(
            (max(push_chunks, c), chunk), np.float32)).to(dev, gdt)
            for i in range(k)]
        pc = torch.from_numpy(rng.standard_normal(c * chunk, np.float32)).to(
            dev, pdt)
        stc = _state(rng, spec, c * chunk, dev)
        run(pushes, pc, stc, spec, packet, f"chunk ids, {label}",
            chunk_ids=ids, average=False)
        # one pointer off alignment (the whole slab goes element by
        # element), then all of them (a head, then the ring)
        targets = ["row0", "param"] + [f"slot{i}" for i in range(len(st))]
        first = next(i for i, r in enumerate(nulled) if r is not None)
        for t in targets + ["all"]:
            r2 = [r if r is None or not (t == "all" or t == "row0"
                                         and i == first) else _shifted(r, 1)
                  for i, r in enumerate(nulled)]
            p2 = _shifted(p, 1) if t in ("param", "all") else p
            s2 = tuple(_shifted(x, 1) if t in (f"slot{i}", "all") else x
                       for i, x in enumerate(st))
            run(r2, p2, s2, spec, packet, f"{t} off alignment, {label}")

    for spec, k, (gdt, pdt) in itertools.product(_specs(), (1, 2, 3, 8),
                                                 dtypes):
        case(spec, k, gdt, pdt, 3 * 8192 + 77, seed=cases)
    adamw = _specs()[-1]
    for k in (65, 256):
        case(adamw, k, torch.float32, torch.float32, 8192 + 77, seed=k)
    case(adamw, 2, torch.float32, torch.float32, (1 << 22) + 77, seed=3,
         big=True)
    case(adamw, 1, torch.bfloat16, torch.bfloat16, (1 << 22) + 77, seed=4,
         big=True)
    try:
        K.fused_agg_opt_cuda([torch.zeros(8, device=dev)] * (K.MAX_ROWS + 1),
                             torch.zeros(8, device=dev), (),
                             scalar_packet(_specs()[0], 1, device=dev),
                             _specs()[0])
    except ValueError:
        pass
    else:
        raise AssertionError(f"fused_agg_opt took {K.MAX_ROWS + 1} rows")
    log(f"kernel rows sweep: fused_agg_opt == fused_agg_opt_torch bitwise in "
        f"{cases} cases (rows, null rows, grad_scale, chunk ids, pointers "
        f"off alignment; K up to {K.MAX_ROWS}); {K.MAX_ROWS + 1} rows refused")
    return worst


# phase 3's two-stream check: STREAM_LAUNCHES chained AdamW (K = 2, f32)
# launches of STREAM_N elements on each of two streams, issued in turns
STREAM_N, STREAM_LAUNCHES = 1 << 24, 4


def stream_check(dev) -> float:
    """fused_agg_opt on two streams at once against the same launches run
    one after the other, bitwise: two independent runs of STREAM_LAUNCHES
    launches (each reads the state the last one wrote), issued in turns
    on two side streams so they overlap, which the streams' CUDA events
    show.  Then a launch on the current stream after one on a side stream,
    against the plain version.  Each stream claims tiles from its own
    counter (``kernel.claim_counter``); with one counter a device, the
    overlapping launches would share claims.  Returns the worst |err|
    against the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.optim.optimizers import adamw

    spec = adamw(1e-3, weight_decay=0.1)
    packets = [scalar_packet(spec, t + 1, device=dev)
               for t in range(STREAM_LAUNCHES)]

    def inputs(seed):
        rng = np.random.default_rng(seed)
        g = torch.from_numpy(rng.standard_normal((2, STREAM_N), np.float32))
        p = torch.from_numpy(rng.standard_normal(STREAM_N, np.float32))
        return g.to(dev), p.to(dev), _state(rng, spec, STREAM_N, dev)

    def copy(run):
        g, p, st = run
        return g, p.clone(), tuple(s.clone() for s in st)

    runs = [inputs(101), inputs(202)]
    serial, both = [copy(r) for r in runs], [copy(r) for r in runs]
    for g, p, st in serial:
        for t in range(STREAM_LAUNCHES):
            K.fused_agg_opt_cuda(g, p, st, packets[t], spec)
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    torch.cuda.synchronize()
    origin = torch.cuda.Event(enable_timing=True)
    origin.record()
    marks = []
    for s in streams:
        s.wait_event(origin)
        marks.append([torch.cuda.Event(enable_timing=True) for _ in (0, 1)])
        marks[-1][0].record(s)
    for t in range(STREAM_LAUNCHES):
        for (g, p, st), s in zip(both, streams):
            with torch.cuda.stream(s):
                K.fused_agg_opt_cuda(g, p, st, packets[t], spec)
    for s, m in zip(streams, marks):
        m[1].record(s)
    torch.cuda.synchronize()
    spans = [(origin.elapsed_time(a), origin.elapsed_time(b))
             for a, b in marks]
    overlap = min(spans[0][1], spans[1][1]) - max(spans[0][0], spans[1][0])
    for (_, p1, s1), (_, p2, s2) in zip(both, serial):
        if not all(same_bits(a, b) for a, b in zip((p1, *s1), (p2, *s2))):
            raise AssertionError("fused_agg_opt on two streams at once "
                                 "differs from the same launches in turn")
    if overlap <= 0:
        raise AssertionError(f"the two streams did not overlap: {spans} ms")
    # a launch on the current stream right after one on a side stream
    g, p, st = inputs(303)
    want = K.fused_agg_opt_torch(g, p, st, packets[0], spec)
    with torch.cuda.stream(streams[0]):
        K.fused_agg_opt_cuda(*copy(runs[0]), packets[0], spec)
    torch.cuda.current_stream(dev).wait_stream(streams[0])
    got = K.fused_agg_opt_cuda(g, p.clone(), tuple(s.clone() for s in st),
                               packets[0], spec)
    err = _rows_case((got, want), "after a launch on another stream")
    log(f"stream check: {STREAM_LAUNCHES} chained launches of {STREAM_N} "
        f"elements on each of 2 streams at once == in turn, bitwise (the "
        f"streams' spans {[tuple(round(x, 3) for x in sp) for sp in spans]}"
        f" ms overlap by {overlap:.3f} ms); the next launch on another "
        f"stream == fused_agg_opt_torch bitwise")
    return err


def _shifted(t, offset: int):
    """A copy of flat ``t`` that starts ``offset`` elements into a fresh
    buffer (offset 1 is off every vector alignment)."""
    import torch

    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:]
    view.copy_(t)
    return view


def _special_slab(rng, n: int, chunk: int):
    """A seeded normal slab whose first chunks are all zero, hold a NaN,
    hold +inf and -inf, and hold NaN beside inf."""
    import numpy as np

    x = (rng.standard_normal(n) * rng.uniform(0.01, 100)).astype(np.float32)
    c = n // chunk
    if c >= 4:
        x[:chunk] = 0.0
        x[chunk + 3] = np.nan
        x[2 * chunk + 5], x[2 * chunk + 9] = np.inf, -np.inf
        x[3 * chunk + 1], x[3 * chunk + 2] = np.nan, np.inf
    return x


def quant_sweep(dev) -> dict:
    """Both quant kernels against their plain versions, bitwise."""
    import numpy as np
    import torch

    from repro_torch.kernels.quant import kernel as Q

    worst = {"quantize_chunks": 0.0, "dequantize_chunks": 0.0}
    cases = 0
    # chunk 65536 is too large for a block's registers and takes the
    # kernel's two-pass route; offset 1 takes the one-element loads
    shapes = [(n, chunk) for n in (8192, 37 * 8192) for chunk in (128, 8192)]
    for n, chunk in shapes + [(5 * 65536, 65536)]:
        for offset in (0, 1):
            rng = np.random.default_rng(1000 + cases)
            x = torch.from_numpy(_special_slab(rng, n, chunk)).to(dev)
            want_q, want_s = Q.quantize_chunks_torch(x, chunk)
            got_q, got_s = Q.quantize_chunks_cuda(_shifted(x, offset), chunk)
            want_d = Q.dequantize_chunks_torch(want_q, want_s, chunk)
            got_d = Q.dequantize_chunks_cuda(_shifted(want_q, offset), want_s,
                                             chunk)
            torch.cuda.synchronize()
            worst["quantize_chunks"] = max(
                worst["quantize_chunks"], max_abs_err(got_q, want_q),
                max_abs_err(got_s, want_s))
            worst["dequantize_chunks"] = max(
                worst["dequantize_chunks"], max_abs_err(got_d, want_d))
            if not (same_bits(got_q, want_q) and same_bits(got_s, want_s)):
                raise AssertionError(
                    f"quantize_chunks differs from its plain version: n={n} "
                    f"chunk={chunk} offset={offset}, max |err| "
                    f"{worst['quantize_chunks']}")
            if not same_bits(got_d, want_d):
                raise AssertionError(
                    f"dequantize_chunks differs from its plain version: n={n} "
                    f"chunk={chunk} offset={offset}, max |err| "
                    f"{worst['dequantize_chunks']}")
            cases += 1
    log(f"kernel sweep: quantize_chunks and dequantize_chunks == their plain "
        f"versions bitwise in {cases} cases (zero, NaN and inf chunks "
        f"included)")
    return worst


def _wire_streams(rng, codec: str, k: int, n: int, chunk: int, dev):
    """K encoded streams as the fabric makes them: the plain quantize of
    seeded normal slabs (int8), their bf16 rounding, or the raw f32."""
    import numpy as np
    import torch

    from repro_torch.kernels.quant import kernel as Q

    g = torch.from_numpy(rng.standard_normal((k, n), np.float32)).to(dev)
    if codec == "none":
        return g, None
    if codec == "bf16":
        return g.to(torch.bfloat16), None
    pairs = [Q.quantize_chunks_torch(g[i], chunk) for i in range(k)]
    return (torch.stack([q for q, _ in pairs]),
            torch.stack([s for _, s in pairs]))


def wire_sweep(dev) -> float:
    """wire_fused against its plain version and against the unfused kernel
    pipeline (dequantize kernel per stream, then fused_agg_opt), bitwise.
    The K=2 cases also run with the param and state slabs one element off
    16-byte alignment, which takes the kernel's one-element path."""
    import numpy as np
    import torch

    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.kernels.wire_path.ops import unfused_wire_update

    chunk, n = 4096, 3 * 4096
    worst, cases = 0.0, 0
    # average off: the async path's K = 1 pushes
    for average, codec, spec, k in itertools.product(
            (True, False), ("none", "bf16", "int8"), _specs(), (1, 2, 3, 8)):
        for offset in ((0, 1) if k == 2 else (0,)):
            rng = np.random.default_rng(2000 + cases)
            pay, sc = _wire_streams(rng, codec, k, n, chunk, dev)
            p = torch.from_numpy(rng.standard_normal(n, np.float32)).to(dev)
            st = _state(rng, spec, n, dev)
            packet = scalar_packet(spec, 4, 0.7, device=dev)
            want_p, want_s = W.wire_fused_torch(
                pay, sc, p, st, packet, spec, codec=codec, chunk_elems=chunk,
                average=average)
            got_p, got_s = W.wire_fused_cuda(
                pay, sc, _shifted(p, offset),
                tuple(_shifted(x, offset) for x in st), packet, spec,
                codec=codec, chunk_elems=chunk, average=average)
            un_p, un_s = unfused_wire_update(
                pay, sc, p.clone(), tuple(s.clone() for s in st), spec, 4, 0.7,
                codec=codec, chunk_elems=chunk, average=average)
            torch.cuda.synchronize()
            pairs = [(got_p, want_p), *zip(got_s, want_s),
                     (got_p, un_p), *zip(got_s, un_s)]
            worst = max([worst] + [max_abs_err(a, b) for a, b in pairs])
            if not all(torch.equal(a, b) for a, b in pairs):
                raise AssertionError(
                    f"wire_fused differs from its plain version or the "
                    f"unfused kernel pipeline: {codec} {spec.name} "
                    f"nesterov={spec.nesterov} k={k} offset={offset} "
                    f"average={average}, max |err| {worst}")
            cases += 1
    log(f"kernel sweep: wire_fused == wire_fused_torch == dequantize + "
        f"fused_agg_opt kernels bitwise in {cases} cases (average on and off)")
    return worst


def _bag_case(rng, b: int, length: int, d: int, dev, idx_dtype):
    """A (1000, d) table with NaN and +-inf rows, and (b, length) bags
    whose upper slots are zero-weight padding (index 0) and whose bag 0 is
    all padding."""
    import numpy as np
    import torch

    v = 1000
    table = (rng.standard_normal((v, d)) * rng.uniform(0.01, 100)).astype(np.float32)
    table[7, 0], table[11, d - 1], table[13, d // 2] = np.nan, np.inf, -np.inf
    idx = rng.integers(0, v, (b, length))
    w = rng.standard_normal((b, length)).astype(np.float32)
    if length > 1:
        w[:, length // 2 + 1:], idx[:, length // 2 + 1:] = 0.0, 0
    if b > 1:
        w[0], idx[0] = 0.0, 0
    idx[:, 0] = np.where(np.arange(b) % 5 == 1, 7 + 2 * (np.arange(b) % 3),
                         idx[:, 0])  # some live slots read the special rows
    return (torch.from_numpy(table).to(dev),
            torch.from_numpy(idx).to(dev, idx_dtype),
            torch.from_numpy(w).to(dev))


def bag_sweep(dev) -> dict:
    """embedding_bag and segment_sum against their plain versions on the
    card, bitwise.  Odd cases read the table one element off 16-byte
    alignment, which takes the kernel's one-float path."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag import kernel as E

    worst = {"embedding_bag": 0.0, "segment_sum": 0.0}
    cases = 0
    for b in (1, 7, 4096):
        for length in (1, 3, 33):
            for d in (16, 128, 130):
                for mode in ("sum", "mean"):
                    rng = np.random.default_rng(3000 + cases)
                    idx_dtype = (torch.int32, torch.int64)[cases % 2]
                    table, idx, w = _bag_case(rng, b, length, d, dev, idx_dtype)
                    want = E.embedding_bag_torch(table, idx, w, mode)
                    src = _shifted(table.reshape(-1), cases % 2).view(table.shape)
                    got = E.embedding_bag_cuda(src, idx, w, mode)
                    torch.cuda.synchronize()
                    worst["embedding_bag"] = max(worst["embedding_bag"],
                                                 max_abs_err(got, want))
                    if not same_bits(got, want):
                        raise AssertionError(
                            f"embedding_bag differs from its plain version: "
                            f"B={b} L={length} D={d} {mode} {idx_dtype}, max "
                            f"|err| {worst['embedding_bag']}")
                    cases += 1
    seg_cases = 0
    for n in (1, 37, 4096):
        for pattern in ("unique", "three", "zipf"):
            for d in (16, 128, 130):
                rng = np.random.default_rng(4000 + seg_cases)
                ids = {"unique": rng.permutation(n), "three": rng.integers(0, 3, n),
                       "zipf": rng.zipf(1.2, n) % 97}[pattern]
                uniq, inv = np.unique(ids, return_inverse=True)
                block = (rng.standard_normal((n, 3, d)) * 10).astype(np.float32)
                block[0, 1, :2] = -0.0
                if n > 5:
                    block[3, 1, 1], block[5, 1, 0] = np.nan, np.inf
                rows = torch.from_numpy(block).to(dev)[:, 1]  # strided rows
                order = torch.from_numpy(np.argsort(inv, kind="stable")).to(dev)
                seg = torch.from_numpy(np.concatenate(
                    [[0], np.cumsum(np.bincount(inv))]).astype(np.int64)).to(dev)
                want = E.segment_sum_torch(rows, order, seg)
                got = E.segment_sum_cuda(rows, order, seg)
                torch.cuda.synchronize()
                worst["segment_sum"] = max(worst["segment_sum"],
                                           max_abs_err(got, want))
                if not same_bits(got, want) or got.shape[0] != uniq.size:
                    raise AssertionError(
                        f"segment_sum differs from its plain version: n={n} "
                        f"{pattern} D={d}, max |err| {worst['segment_sum']}")
                seg_cases += 1
    log(f"kernel sweep: embedding_bag == embedding_bag_torch bitwise in "
        f"{cases} cases (padding, all-padding bags, NaN and inf rows, int32 "
        f"and int64 indices); segment_sum == segment_sum_torch bitwise in "
        f"{seg_cases} cases (duplicates, strided, -0, NaN and inf rows)")
    return worst


# -- phases 4 and 5 ----------------------------------------------------------
class LaunchTimer:
    """CUDA events and the host clock around every call of a kernel wrapper
    on the main path (a module's function or an object's method, swapped
    in and restored).  ``hook``, if given, is called as ``hook(args,
    kwargs)`` before every call and may return a function, which is then
    called with the call's result (a capture: ``first_apply_hook``,
    ``book_updates``)."""

    def __init__(self, obj, attr: str, hook=None):
        self.obj, self.attr, self.hook = obj, attr, hook
        self.events: list = []
        self.stamps: list = []

    def __enter__(self):
        import torch

        # wrap what is there now, so wrappers of one attribute nest
        self.launch = getattr(self.obj, self.attr)
        self.own = self.attr in vars(self.obj)  # else a class's method

        def timed(*args, **kwargs):
            self.stamps.append(time.perf_counter())
            after = self.hook(args, kwargs) if self.hook else None
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.launch(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            if after is not None:
                after(out)
            return out

        setattr(self.obj, self.attr, timed)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.obj, self.attr, self.launch)
        else:
            delattr(self.obj, self.attr)

    def ms(self) -> list:
        return [s.elapsed_time(e) for s, e in self.events]


class CaptureCall(LaunchTimer):
    """Device copies of the tensor arguments and outputs of call number
    ``index`` (from 0) of a kernel wrapper on the main path (a module
    attribute, swapped in and restored).  The copies queue on the stream
    without a host wait, so a timed round is not held up; ``memory`` is
    told their bytes before they are made."""

    def __init__(self, module, attr: str, index: int, memory):
        super().__init__(module, attr, self.capture)
        self.index, self.memory = index, memory
        self.args = self.out = None

    def capture(self, args, kwargs):
        import torch

        if len(self.stamps) - 1 != self.index:
            return None

        def after(out):
            outs = out if isinstance(out, tuple) else (out,)
            self.memory.hold(sum(
                t.numel() * t.element_size()
                for t in (*args, *outs) if torch.is_tensor(t)))
            self.args = tuple(a.clone() if torch.is_tensor(a) else a
                              for a in args)
            self.out = tuple(t.clone() for t in outs)
        return after


class FabricStacks:
    """Counts ``torch.stack`` calls made by ``core/fabric.py`` (its module's
    ``torch`` swapped for a counting proxy, and restored): the inbox stacks
    that the f32 path no longer makes."""

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        import torch

        from repro_torch.core import fabric

        outer = self

        class Proxy:
            def __getattr__(self, name):
                if name == "stack":
                    outer.calls += 1
                return getattr(torch, name)

        self.fabric, self.torch = fabric, fabric.torch
        fabric.torch = Proxy()
        return self

    def __exit__(self, *exc):
        self.fabric.torch = self.torch


class PathMemory:
    """The main path's device memory, allocated and peak, without the
    bytes its captures hold (kept apart with a peak reset at each one)
    and without ``held`` bytes that an earlier run left allocated for a
    comparison."""

    def __init__(self, dev, held: int = 0):
        import torch

        self.dev, self.held, self.peak = dev, held, 0
        torch.cuda.reset_peak_memory_stats(dev)

    def hold(self, nbytes: int) -> None:
        import torch

        self.peak = self.now()[1]
        self.held += nbytes
        torch.cuda.reset_peak_memory_stats(self.dev)

    def now(self) -> tuple:
        """(allocated, peak so far) in bytes."""
        import torch

        return (torch.cuda.memory_allocated(self.dev) - self.held,
                max(self.peak,
                    torch.cuda.max_memory_allocated(self.dev) - self.held))


def _host(x):
    return x.to("cpu", copy=True)


def first_apply_hook(shard, captured: dict):
    """A ``LaunchTimer`` hook on ``shard.apply`` or ``shard.apply_wire``:
    its step-1 call's tensor arguments, ``average`` and the shard's params
    and state before it (``captured["in"]``) and after it
    (``captured["out"]``) land in host memory, for a replay through the
    plain version."""
    import torch

    def host_arg(a):
        if torch.is_tensor(a):
            return _host(a)
        if isinstance(a, list):  # ``apply``'s whole pushes: the shard's rows
            return [None if g is None else _host(
                g.reshape(-1, shard.space.chunk_elems)[shard.rows])
                for g in a]
        return a

    def hook(args, kwargs):
        if args[-1] != 1:  # the step
            return None
        captured["in"] = (tuple(map(host_arg, args)), _host(shard.params),
                          tuple(map(_host, shard.state)))
        captured["average"] = kwargs.get("average", True)

        def after(out):
            captured["out"] = (_host(shard.params),
                               tuple(map(_host, shard.state)))
        return after

    return hook


def main_path(dev, codec: str) -> dict:
    """Train gemma3-1b at full width for ROUNDS rounds through the fabric
    with ``codec`` on the wire.  Returns the path's launch counts, timings
    and shard 0's captured first update."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import FabricConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").config
    memory = PathMemory(dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    space = ParamSpace.build(params)
    log(space.describe())
    spec = adamw(3e-3)
    init = space.flatten(params)
    del params
    fab = PBoxFabric(
        space, spec, init, device=dev,
        config=FabricConfig(num_shards=SHARDS, num_workers=WORKERS,
                            wire=WireConfig(compression=CompressionConfig(
                                codec=codec))))
    del init
    streams = [lm_batches(cfg.vocab, 1, SEQ, seed=w) for w in range(WORKERS)]
    losses: list = []
    mem: list = [("fabric built", *memory.now())]

    def grad_fn(p, wstep):
        b = next(streams[wstep[0]])
        with record_function("worker.fwd_bwd"):
            loss, g = lm_loss_and_grad(
                p, torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
        losses.append(loss)
        mem.append((f"w{wstep[0]} step {wstep[1]} grads", *memory.now()))
        return g

    # shard 0's first update captured to host memory (inputs before,
    # outputs after) for a replay through the plain version
    captured: dict = {}
    shard0 = fab.shards[0]
    fused = fab._fused_wire
    apply_name = "apply_wire" if fused else "apply"

    def labelled(name, fn):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    fab.pull = labelled("fabric.pull", fab.pull)
    fab.push = labelled("fabric.push+aggregate", fab.push)
    capture = LaunchTimer(shard0, apply_name,
                          first_apply_hook(shard0, captured))
    kernel_name = "wire_fused" if fused else "fused_agg_opt"
    timer = LaunchTimer(W, "wire_fused_cuda") if fused else LaunchTimer(
        K, "fused_agg_opt_cuda")
    h = WorkerHarness(fab, grad_fn, lambda w, s: (w, s))
    round_ms = []
    # the last round runs under torch.profiler: device time by kernel and
    # host time by phase (the profiler slows the host, so the unprofiled
    # round before it is the steady wall time)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    # worker 0's round-2 encode (the quantize of its gradients plus the
    # round-1 residual, then the dequantize for the new residual), captured
    # for a replay: each worker encodes once a round
    codec_calls = ([CaptureCall(Q, "quantize_chunks_cuda", WORKERS, memory),
                    CaptureCall(Q, "dequantize_chunks_cuda", WORKERS, memory)]
                   if codec == "int8" else [])
    stacks = FabricStacks()
    try:
        with timer, capture, stacks, contextlib.ExitStack() as stack:
            for call in codec_calls:
                stack.enter_context(call)
            _zero_counts()  # every count of the port's kernels to 0 just before
            for r in range(1, ROUNDS + 1):
                if r == ROUNDS:
                    prof.start()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                h.run(r)
                torch.cuda.synchronize()
                round_ms.append((time.perf_counter() - t0) * 1e3)
                mem.append((f"round {r} done", *memory.now()))
            prof.stop()
            launches = _counts()  # ...and read just after
    finally:
        del fab.pull, fab.push
    peak = memory.now()[1]
    loss_vals = [x.item() for x in losses]
    kernel_ms = timer.ms()
    log(fab.describe())
    log(f"main path ({codec} wire): {cfg.name}, {ROUNDS} rounds x {WORKERS} "
        f"workers, batch 1 x {SEQ} tokens, {SHARDS} shards, AdamW")
    log(f"  losses {loss_vals}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (round 1 "
        f"includes cuBLAS warm-up and the shard-0 capture to host memory)")
    log(f"  launches {launches}; fused wire rounds {fab.stats.fused_wire_rounds}")
    log(f"  {kernel_name} ms per launch (CUDA events, median of "
        f"{len(kernel_ms)}) {statistics.median(kernel_ms):.4f}; all "
        f"{[round(x, 4) for x in kernel_ms]}")
    log(f"  bytes pushed {fab.stats.bytes_pushed}, pulled "
        f"{fab.stats.bytes_pulled}")
    log(f"  peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)"
        + (f", not counting the {memory.held} bytes of device copies the "
           f"replay check holds" if memory.held else ""))
    log("  device memory GiB (allocated, peak so far): " + "; ".join(
        f"{name} {a / 2**30:.2f}/{m / 2**30:.2f}" for name, a, m in mem))
    breakdown = profile_summary(prof, round_ms[-2], timer.events[-SHARDS:],
                                kernel_name)
    cat_ms, cat_n = kernel_device_ms(prof, "CatArrayBatchedCopy")
    log(f"  torch.stack calls in core/fabric.py over {ROUNDS} rounds: "
        f"{stacks.calls}; stack/cat copy kernels in the profiled round (the "
        f"workers' included): {cat_n} launches, {cat_ms:.2f} ms")
    if codec == "none" and stacks.calls:
        raise AssertionError(f"the f32 path stacked gradient rows "
                             f"{stacks.calls} times")
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"non-finite loss: {loss_vals}")
    if fab.stats.steps != ROUNDS:
        raise AssertionError(f"fabric ran {fab.stats.steps} rounds, not {ROUNDS}")
    want = ({"fused_agg_opt": 0, "quantize_chunks": WORKERS * ROUNDS,
             "dequantize_chunks": WORKERS * ROUNDS,
             "wire_fused": SHARDS * ROUNDS} if codec == "int8" else
            {"fused_agg_opt": SHARDS * ROUNDS, "quantize_chunks": 0,
             "dequantize_chunks": 0, "wire_fused": 0})
    want = {k: 0 for k in launches} | want
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if fab.stats.fused_wire_rounds != (ROUNDS if codec != "none" else 0):
        raise AssertionError(
            f"fused_wire_rounds {fab.stats.fused_wire_rounds} after {ROUNDS} "
            f"rounds of the {codec} wire")
    flat = fab.params
    if tuple(flat.shape) != (space.flat_elems,) or not torch.isfinite(flat).all():
        raise AssertionError("fabric params are not finite or misshapen")
    for call in codec_calls:
        captured[call.attr.removesuffix("_cuda")] = (call.args, call.out)
    n0 = shard0.num_elems
    del fab, h, flat, shard0, losses
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel": kernel_name,
            "main_path_ms": statistics.median(kernel_ms), "n": n0,
            "flat": space.flat_elems, "chunk": space.chunk_elems,
            "peak_bytes": peak, "round_ms": round_ms, "losses": loss_vals,
            "captured": captured, "spec": spec, "fabric_stacks": stacks.calls,
            "cat_ms": cat_ms, **breakdown}


def replay_f32(dev, run: dict) -> float:
    """Shard 0's first f32 update through fused_agg_opt's plain version, in
    slices (the update is elementwise, so a slice's plain result is the
    same bits as the whole's)."""
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet

    (rows, step), p, st = run["captured"]["in"]
    got_p, got_s = run["captured"]["out"]
    n0 = run["n"]
    k = len(rows)
    rows = [r.reshape(n0) for r in rows]
    p, st = p.reshape(n0), tuple(s.reshape(n0) for s in st)
    got_p, got_s = got_p.reshape(n0), tuple(s.reshape(n0) for s in got_s)
    packet = scalar_packet(run["spec"], step, device=dev)
    average = run["captured"]["average"]
    worst, piece = 0.0, 1 << 25
    for a in range(0, n0, piece):
        sl = slice(a, min(a + piece, n0))
        want_p, want_s = K.fused_agg_opt_torch(
            [r[sl].to(dev) for r in rows], p[sl].to(dev),
            tuple(s[sl].to(dev) for s in st), packet, run["spec"],
            average=average)
        pairs = [(got_p[sl], want_p.cpu()),
                 *[(g[sl], w.cpu()) for g, w in zip(got_s, want_s)]]
        worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
        if not all(same_bits(x, y) for x, y in pairs):
            raise AssertionError(
                f"main-path launch differs from the plain version, max |err| {worst}")
    log(f"  shard 0 round 1 (K={k}, N={n0}): fused_agg_opt == plain version "
        f"bitwise")
    return worst


def replay_wire(dev, run: dict) -> float:
    """Shard 0's first apply_wire through wire_fused_torch (in slices of
    whole chunks) and through the unfused kernel pipeline (the dequantize
    kernel per stream, then fused_agg_opt), both bitwise."""
    import torch

    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.kernels.wire_path.ops import unfused_wire_update

    (pay, scales, codec, step), p, st = run["captured"]["in"]
    got_p, got_s = run["captured"]["out"]
    average = run["captured"]["average"]
    n0, chunk, spec = run["n"], run["chunk"], run["spec"]
    k = pay.shape[0]
    pay, scales = pay.reshape(k, n0), scales.reshape(k, n0 // chunk)
    p, st = p.reshape(n0), tuple(s.reshape(n0) for s in st)
    got_p, got_s = got_p.reshape(n0), tuple(s.reshape(n0) for s in got_s)
    packet = scalar_packet(spec, step, device=dev)
    worst, piece = 0.0, (1 << 25) // chunk * chunk
    for a in range(0, n0, piece):
        sl = slice(a, min(a + piece, n0))
        csl = slice(sl.start // chunk, sl.stop // chunk)
        want_p, want_s = W.wire_fused_torch(
            pay[:, sl].to(dev), scales[:, csl].to(dev), p[sl].to(dev),
            tuple(s[sl].to(dev) for s in st), packet, spec, codec=codec,
            chunk_elems=chunk, average=average)
        pairs = [(got_p[sl], want_p.cpu()),
                 *[(g[sl], w.cpu()) for g, w in zip(got_s, want_s)]]
        worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
        if not all(same_bits(x, y) for x, y in pairs):
            raise AssertionError(
                f"main-path wire_fused differs from wire_fused_torch, max "
                f"|err| {worst}")
    un_p, un_s = unfused_wire_update(
        pay.to(dev), scales.to(dev), p.to(dev), tuple(s.to(dev) for s in st),
        spec, step, codec=codec, chunk_elems=chunk, average=average)
    torch.cuda.synchronize()
    pairs = [(got_p, un_p.cpu()), *zip(got_s, (s.cpu() for s in un_s))]
    worst = max([worst] + [max_abs_err(x, y) for x, y in pairs])
    if not all(same_bits(x, y) for x, y in pairs):
        raise AssertionError(
            f"main-path wire_fused differs from the unfused kernel pipeline, "
            f"max |err| {worst}")
    del un_p, un_s
    torch.cuda.empty_cache()
    log(f"  shard 0 step 1 (K={k}, N={n0}, {codec}, average={average}): "
        f"wire_fused == wire_fused_torch == dequantize + fused_agg_opt "
        f"kernels bitwise")
    return worst


def replay_codec(run: dict) -> dict:
    """Worker 0's round-2 quantize and dequantize on the int8 main path
    (the error-feedback-corrected gradients and their residual) through
    their plain versions, in slices of whole chunks (each chunk is
    coded on its own, so a slice's plain result is the same bits as the
    whole's), bitwise.  The captures are device copies."""
    from repro_torch.kernels.quant import kernel as Q

    (x, chunk), (got_q, got_s) = run["captured"]["quantize_chunks"]
    (dq, ds, dchunk), (got_d,) = run["captured"]["dequantize_chunks"]
    if not (dchunk == chunk and same_bits(dq, got_q) and same_bits(ds, got_s)):
        raise AssertionError("the captured dequantize did not decode the "
                             "captured quantize's payload (encode_wire's "
                             "residual)")
    n = x.shape[0]
    worst = {"quantize_chunks": 0.0, "dequantize_chunks": 0.0}
    piece = (1 << 25) // chunk * chunk
    for a in range(0, n, piece):
        sl = slice(a, min(a + piece, n))
        csl = slice(sl.start // chunk, sl.stop // chunk)
        want_q, want_s = Q.quantize_chunks_torch(x[sl], chunk)
        want_d = Q.dequantize_chunks_torch(dq[sl], ds[csl], chunk)
        worst["quantize_chunks"] = max(worst["quantize_chunks"],
                                       max_abs_err(got_q[sl], want_q),
                                       max_abs_err(got_s[csl], want_s))
        worst["dequantize_chunks"] = max(worst["dequantize_chunks"],
                                         max_abs_err(got_d[sl], want_d))
        if not (same_bits(got_q[sl], want_q) and same_bits(got_s[csl], want_s)):
            raise AssertionError(
                f"main-path quantize differs from its plain version, max "
                f"|err| {worst['quantize_chunks']}")
        if not same_bits(got_d[sl], want_d):
            raise AssertionError(
                f"main-path dequantize differs from its plain version, max "
                f"|err| {worst['dequantize_chunks']}")
    log(f"  worker 0 round 2 encode (N={n}, chunk {chunk}): quantize and "
        f"dequantize == their plain versions bitwise")
    return worst


# -- phases 6 and 7: the DLRM sparse path ------------------------------------
def dlrm_capped_config(cap: int = DLRM_ROW_CAP):
    """dlrm-mlperf at its published widths with every table capped at
    ``cap`` rows (the only cut: 163,079,093 rows at the 40M cap need
    77.8 GiB in f32, twice that with the tier's dense view)."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch("dlrm-mlperf").config
    return dataclasses.replace(cfg, vocabs=tuple(
        min(v, cap) for v in cfg.vocabs))


def dlrm_setup(cfg, dev, num_shards: int, codec: str = "none",
               topology=None):
    """The dense MLPs in a ``num_shards`` fabric and the tables in a
    fabric-attached SparseTier, built one table at a time from seeded
    generators (tables, bottom MLP, top MLP: seeds 0, 1, 2, in
    ``dlrm_init``'s order); each initial table is dropped once the tier
    holds its slabs.  Each table is padded to a multiple of the shard
    count (``padded_vocab``, the JAX package's ``init_tables(tp)``
    convention): a row placement needs a row for every shard, and
    Criteo's 3-row table has fewer than 4.  Ids never reach the pad rows.
    A ``topology`` goes to the fabric, and the tier inherits it."""
    import torch

    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.config import FabricConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.sparse import SparseTier
    from repro_torch.models.common import embed_init
    from repro_torch.models.recsys.embedding import init_mlp, padded_vocab
    from repro_torch.optim.optimizers import sgd

    g_tables, g_bot, g_top = (torch.Generator(device=dev).manual_seed(s)
                              for s in range(3))
    dense = {"bot": init_mlp(g_bot, (cfg.n_dense,) + cfg.bot_mlp, cfg.dtype),
             "top": init_mlp(g_top, (cfg.top_in,) + cfg.top_mlp, cfg.dtype)}
    space = ParamSpace.build(dense)
    fab = PBoxFabric(space, sgd(DLRM_LR), space.flatten(dense), device=dev,
                     config=FabricConfig(num_shards=num_shards,
                                         num_workers=WORKERS,
                                         wire=WireConfig(topology=topology)))
    tier = SparseTier(fabric=fab, lr=DLRM_LR, codec=codec, placement="hash")
    for i, v in enumerate(cfg.vocabs):
        init = embed_init(g_tables, (padded_vocab(v, num_shards), cfg.embed_dim),
                          cfg.dtype, std=0.01)
        tier.add_table(f"t{i}", init)
        del init
    return space, fab, tier


def dlrm_round(space, fab, tier, cfg, streams, dev, losses: list) -> None:
    """One synchronous round, every worker in turn: pull the dense params,
    one SparseTier.lookup per table (one-hot bags), autograd of
    dlrm_loss_from_emb with respect to the dense params and a leaf ``e``,
    the dense gradient pushed into the fabric and (ids, cot_e) into the
    tier.  Each phase is a profiler range."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from repro_torch.models.recsys.models import dlrm_loss_from_emb

    for w in range(WORKERS):
        b = next(streams[w])
        bags = np.arange(b["sparse"].shape[0] + 1)
        with record_function("fabric.pull"):
            p = space.unflatten(fab.pull(w))
        p = {g: {k: v.detach().requires_grad_() for k, v in p[g].items()}
             for g in p}
        with record_function("lookup"):
            e = torch.stack([tier.lookup(w, f"t{i}", b["sparse"][:, i], bags)
                             for i in range(cfg.n_sparse)], dim=1)
        e.requires_grad_()
        with record_function("fwd_bwd"):
            batch = {"dense": torch.from_numpy(b["dense"]).to(dev),
                     "labels": torch.from_numpy(b["labels"]).to(dev)}
            loss, _ = dlrm_loss_from_emb(p, e, batch, cfg)
            leaves = [p[g][k] for g in sorted(p) for k in sorted(p[g])]
            *g_dense, cot_e = torch.autograd.grad(loss, leaves + [e])
        it = iter(g_dense)
        grads = {g: {k: next(it) for k in sorted(p[g])} for g in sorted(p)}
        with record_function("fabric.push"):
            fab.push(w, space.flatten(grads))
        with record_function("sparse.push"):
            tier.push(w, {f"t{i}": (b["sparse"][:, i], cot_e[:, i])
                          for i in range(cfg.n_sparse)})
        losses.append(loss.detach())


def _counts() -> dict:
    from repro_torch.kernels.embedding_bag import kernel as E
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.group_norm import kernel as G
    from repro_torch.kernels.layout import kernel as L
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W

    return {"embedding_bag": E.launches, "segment_sum": E.segment_launches,
            "fused_agg_opt": K.launches, "quantize_chunks": Q.quantize_launches,
            "dequantize_chunks": Q.dequantize_launches, "wire_fused": W.launches,
            "group_norm_fwd": G.forward_launches,
            "group_norm_bwd": G.backward_launches,
            "channels_last": L.launches}


def _zero_counts() -> None:
    from repro_torch.kernels.embedding_bag import kernel as E
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.group_norm import kernel as G
    from repro_torch.kernels.layout import kernel as L
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W

    E.launches = E.segment_launches = K.launches = 0
    Q.quantize_launches = Q.dequantize_launches = W.launches = 0
    G.forward_launches = G.backward_launches = L.launches = 0


def dlrm_path(dev) -> dict:
    """Train dlrm-mlperf (tables capped at DLRM_ROW_CAP rows) at full width
    for ROUNDS rounds: 2 workers x DLRM_BATCH samples, 4 shards.  Returns
    the launch counts, timings, stats and the captured kernel calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import recsys_batches
    from repro_torch.kernels.embedding_bag import kernel as E

    cfg = dlrm_capped_config()
    memory = PathMemory(dev)
    t0 = time.perf_counter()
    space, fab, tier = dlrm_setup(cfg, dev, SHARDS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mem = [("tier built", *memory.now())]
    rows = sum(t.num_rows for t in tier.tables.values())
    log(f"dlrm path: {cfg.name}, {cfg.n_sparse} tables capped at "
        f"{DLRM_ROW_CAP} rows ({sum(cfg.vocabs)} rows; {rows} padded to a "
        f"multiple of {SHARDS}) x {cfg.embed_dim} f32 "
        f"({rows * cfg.embed_dim * 4 / 2**30:.2f} GiB), bot {cfg.bot_mlp}, "
        f"top {cfg.top_mlp}; dense params {space.payload_elems}; built in "
        f"{setup_s:.1f} s")
    streams = [recsys_batches("dlrm-mlperf", cfg, DLRM_BATCH, seed=w)
               for w in range(WORKERS)]
    losses: list = []
    round_ms = []
    n = cfg.n_sparse
    # worker 0's round-2 lookup of t0 and its round-2 coalescing of t0 and
    # t5 (3 rows: every id a duplicate), replayed through the plain versions
    captures = [CaptureCall(E, "embedding_bag_cuda", WORKERS * n, memory),
                CaptureCall(E, "segment_sum_cuda", WORKERS * n, memory),
                CaptureCall(E, "segment_sum_cuda", WORKERS * n + 5, memory)]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with contextlib.ExitStack() as stack:
        for call in captures:
            stack.enter_context(call)
        _zero_counts()  # every count to 0 just before the path...
        for r in range(1, ROUNDS + 1):
            if r == ROUNDS:
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dlrm_round(space, fab, tier, cfg, streams, dev, losses)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
            mem.append((f"round {r} done", *memory.now()))
        prof.stop()
        launches = _counts()  # ...and read just after
    peak = memory.now()[1]
    loss_vals = [x.item() for x in losses]
    st = tier.stats
    log(tier.describe())
    log(f"  losses {loss_vals}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (round 1 "
        f"includes cuBLAS warm-up)")
    log(f"  launches {launches}")
    log(f"  SparseStats: rows pushed {st.rows_pushed}, coalesced "
        f"{st.rows_coalesced}, pulled {st.rows_pulled}; bytes pushed "
        f"{st.bytes_pushed}, pulled {st.bytes_pulled}; rounds {st.rounds}, "
        f"lookups {st.lookups}, pushes {st.pushes}")
    log(f"  fabric: bytes pushed {fab.stats.bytes_pushed}, pulled "
        f"{fab.stats.bytes_pulled}, steps {fab.stats.steps}")
    log(f"  peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)"
        + (f", not counting the {memory.held} bytes of device copies the "
           f"replay check holds" if memory.held else ""))
    log("  device memory GiB (allocated, peak so far): " + "; ".join(
        f"{name} {a / 2**30:.2f}/{m / 2**30:.2f}" for name, a, m in mem))
    breakdown = profile_summary(prof, round_ms[-2], None, "embedding_bag",
                                "bag_kernel")
    in_path = {}
    for name, key in (("embedding_bag", "bag_kernel"),
                      ("segment_sum", "segment_kernel"),
                      ("fused_agg_opt", "fused_agg_opt_kernel"),
                      ("dense view rebuild (index_copy_)", "index_copy_kernel")):
        total, count = kernel_device_ms(prof, key)
        in_path[name] = total / count if count else None
        log(f"  profiled round, device: {name} {total:.4f} ms in {count} "
            f"launches" + (f" ({total / count:.4f} ms each)" if count else ""))
    want = {k: 0 for k in launches} | {
        "embedding_bag": n * WORKERS * ROUNDS,
        "segment_sum": n * WORKERS * ROUNDS,
        "fused_agg_opt": SHARDS * ROUNDS}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not all(math.isfinite(x) for x in loss_vals):
        raise AssertionError(f"non-finite loss: {loss_vals}")
    if (fab.stats.steps, tier.round) != (ROUNDS, ROUNDS):
        raise AssertionError(f"fabric ran {fab.stats.steps} rounds and the "
                             f"tier {tier.round}, not {ROUNDS}")
    pushed = WORKERS * ROUNDS * n * DLRM_BATCH
    if (st.rows_pushed + st.rows_coalesced != pushed
            or st.lookups != WORKERS * ROUNDS * n
            or st.bytes_pushed != st.rows_pushed * (4 * cfg.embed_dim + 4)):
        raise AssertionError(f"SparseStats do not add up: {st}")
    for name, table in tier.tables.items():
        if not all(torch.isfinite(slab).all() for slab in table.slabs):
            raise AssertionError(f"table {name} holds non-finite values")
    if not torch.isfinite(fab.params).all():
        raise AssertionError("dense params are not finite")
    largest = max(range(n), key=lambda i: cfg.vocabs[i])
    u_largest = int(torch.unique(torch.from_numpy(
        next(recsys_batches("dlrm-mlperf", cfg, DLRM_BATCH, seed=0))["sparse"][:, largest])).numel())
    captured = {"lookup": (captures[0].args, captures[0].out),
                "coalesce_t0": (captures[1].args, captures[1].out),
                "coalesce_t5": (captures[2].args, captures[2].out)}
    del fab, tier, space, losses
    torch.cuda.empty_cache()
    return {"launches": launches, "kernel": "embedding_bag",
            "main_path_ms": in_path["embedding_bag"],
            "segment_main_path_ms": in_path["segment_sum"], "peak_bytes": peak,
            "round_ms": round_ms, "losses": loss_vals, "setup_s": setup_s,
            "stats": dataclasses.asdict(st), "captured": captured,
            "u_largest": u_largest, "rows": rows, **breakdown}


def replay_dlrm(run: dict) -> dict:
    """The captured lookup and coalescing calls through the plain versions
    on the card, bitwise."""
    from repro_torch.kernels.embedding_bag import kernel as E

    (table, idx, w, mode), (got,) = run["captured"]["lookup"]
    want = E.embedding_bag_torch(table, idx, w, mode)
    worst = {"embedding_bag": max_abs_err(got, want), "segment_sum": 0.0}
    if not same_bits(got, want):
        raise AssertionError(f"main-path embedding_bag differs from its plain "
                             f"version, max |err| {worst['embedding_bag']}")
    log(f"  worker 0 round 2 lookup of t0 (U={table.shape[0]}, B={idx.shape[0]}, "
        f"L={idx.shape[1]}): embedding_bag == plain version bitwise")
    for key in ("coalesce_t0", "coalesce_t5"):
        (rows, order, seg), (got,) = run["captured"][key]
        want = E.segment_sum_torch(rows, order, seg)
        worst["segment_sum"] = max(worst["segment_sum"], max_abs_err(got, want))
        if not same_bits(got, want):
            raise AssertionError(f"main-path segment_sum ({key}) differs from "
                                 f"its plain version, max |err| "
                                 f"{worst['segment_sum']}")
        log(f"  worker 0 round 2 {key.replace('_', ' of ')} (n={rows.shape[0]}, "
            f"U={seg.numel() - 1}): segment_sum == plain version bitwise")
    return worst


def dlrm_sharding_check(dev) -> None:
    """The DLRM SMOKE loop on the card with heavily repeated ids (every id
    taken modulo 17), 1 shard against 4, codecs none and int8 with error
    feedback: tables, row versions and dense params bitwise equal.  An
    atomic in the coalescing or the round's fold would break it."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import recsys_batches

    cfg = get_arch("dlrm-mlperf").smoke_config

    def repeated(seed):
        for b in recsys_batches("dlrm-mlperf", cfg, 4096, seed=seed):
            b["sparse"] = (b["sparse"] % 17).astype(np.int32)
            yield b

    for codec in ("none", "int8"):
        runs = []
        for shards in (1, 4):
            space, fab, tier = dlrm_setup(cfg, dev, shards, codec)
            streams = [repeated(w) for w in range(WORKERS)]
            losses: list = []
            for _ in range(ROUNDS):
                dlrm_round(space, fab, tier, cfg, streams, dev, losses)
            runs.append((fab, tier, [x.item() for x in losses]))
        (fa, ta, la), (fb, tb, lb) = runs
        same = la == lb and same_bits(fa.params, fb.params) and all(
            same_bits(ta.table(k), tb.table(k))
            and np.array_equal(ta.row_versions(k), tb.row_versions(k))
            for k in ta.tables)
        if not same:
            raise AssertionError(f"DLRM SMOKE on the card: 1 and 4 shards "
                                 f"differ with codec {codec}")
        log(f"dlrm sharding check ({codec}, batch 4096, ids mod 17, "
            f"coalesced {ta.stats.rows_coalesced} of "
            f"{ta.stats.rows_coalesced + ta.stats.rows_pushed} rows): 1 shard "
            f"== 4 shards bitwise (tables, versions, dense params)")
        del runs, fa, fb, ta, tb
    torch.cuda.empty_cache()


# -- phases 8 to 11: straggler modes, snapshots and rebalancing ---------------
@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms while the block runs.  The runs
    these phases compare recompute the same gradients, and the model's
    backward accumulates with atomics (``index_add_`` under the GQA head
    gather, ``index_put_`` under the embedding gather) unless torch takes
    its deterministic paths.  An op without one only warns; the bitwise
    comparisons would then fail."""
    import torch

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])


def timed(fn) -> float:
    """Host ms of ``fn()``, the work it queues on the card included."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _check_counts(label: str, got: dict, want: dict) -> None:
    want = {k: 0 for k in got} | want
    if got != want:
        raise AssertionError(f"{label}: launch counts {got}, expected {want}")


def finite_losses(losses: list) -> list:
    """The losses recorded since the last call, as floats (emptying the
    list); raises on a non-finite one.  Read once a phase: ``item()``
    waits for the card."""
    vals = [x.item() for x in losses]
    losses.clear()
    if not all(math.isfinite(x) for x in vals):
        raise AssertionError(f"non-finite loss: {vals}")
    return vals


class GemmaWorkers:
    """gemma3-1b at full width for phases 8-13: seeded weights (seed 0),
    the flat space, fabrics built from them, and a worker gradient that is
    a function of the pulled params and (worker, step) alone, so a
    replayed step sees the same tokens."""

    def __init__(self, dev):
        import torch

        from repro_torch.configs.registry import get_arch
        from repro_torch.core.chunking import ParamSpace
        from repro_torch.models.transformer import init_params

        self.dev = dev
        self.cfg = get_arch("gemma3-1b").config
        params = init_params(self.cfg,
                             torch.Generator(device=dev).manual_seed(0))
        self.space = ParamSpace.build(params)
        self.init = self.space.flatten(params)
        del params
        torch.cuda.empty_cache()
        self.losses: list = []

    def finite_losses(self) -> list:
        return finite_losses(self.losses)

    def grad_tree(self, params: dict, w: int, s: int) -> dict:
        """Worker ``w``'s gradient tree at its step ``s``."""
        import torch

        from repro_torch.data.synthetic import lm_batches
        from repro_torch.models.transformer import lm_loss_and_grad

        b = next(lm_batches(self.cfg.vocab, 1, SEQ, seed=1000 * (w + 1) + s))
        loss, g = lm_loss_and_grad(
            params, torch.from_numpy(b["tokens"]).to(self.dev),
            torch.from_numpy(b["labels"]).to(self.dev), self.cfg)
        self.losses.append(loss)
        return g

    def grad(self, flat, w: int, s: int):
        """The flat gradient against the pulled flat params."""
        return self.space.flatten(
            self.grad_tree(self.space.unflatten(flat), w, s))

    def fabric(self, num_workers: int, num_shards: int = SHARDS,
               codec: str = "none", topology=None, switch=None, **fields):
        from repro_torch.core.compression import CompressionConfig
        from repro_torch.core.config import (
            FabricConfig,
            SwitchConfig,
            WireConfig,
        )
        from repro_torch.core.fabric import PBoxFabric
        from repro_torch.optim.optimizers import adamw

        return PBoxFabric(
            self.space, adamw(3e-3), self.init, device=self.dev,
            config=FabricConfig(num_shards=num_shards,
                                num_workers=num_workers,
                                wire=WireConfig(
                                    topology=topology,
                                    compression=CompressionConfig(
                                        codec=codec),
                                    switch=switch or SwitchConfig()),
                                **fields))

    def round(self, fab, s: int, workers=(0, 1)) -> None:
        """Each worker in turn pulls, computes its step-``s`` gradient and
        pushes."""
        for w in workers:
            fab.push(w, self.grad(fab.pull(w), w, s))


def quorum_path(dev, gw: GemmaWorkers) -> dict:
    """Backup quorum at full width: 3 workers, ``min_push_fraction`` 0.5,
    so the quorum is ceil(1.5) = 2.  Each round all three pull, workers 0
    and 1 push (the round fires with K = 2), and worker 2 pushes the
    gradient it computed against the superseded params, which the fabric
    drops.  The params must equal a 2-worker sync fabric fed workers 0 and
    1's batches, bitwise."""
    import torch

    memory = PathMemory(dev)
    fab = gw.fabric(3, min_push_fraction=0.5)
    if fab.min_pushes != 2:
        raise AssertionError(f"min_pushes {fab.min_pushes}, not 2")

    def one_round(s):
        flats = [fab.pull(w) for w in range(3)]
        for w in (0, 1):
            fab.push(w, gw.grad(flats[w], w, s))
        late = gw.grad(flats[2], 2, s)  # against the superseded params
        del flats
        fab.push(2, late)

    _zero_counts()  # the counts to 0 just before the path...
    round_ms = [timed(lambda s=s: one_round(s)) for s in range(ROUNDS)]
    launches = _counts()  # ...and read just after
    peak = memory.now()[1]
    st = fab.stats
    log(f"quorum path: {gw.cfg.name}, 3 workers, min_push_fraction 0.5 "
        f"(min_pushes {fab.min_pushes}), {SHARDS} shards, AdamW, {ROUNDS} "
        f"rounds")
    log(f"  losses {gw.finite_losses()}")
    log(f"  launches {launches}; steps {st.steps}, partial aggregations "
        f"{st.partial_aggregations}, late pushes dropped "
        f"{st.late_pushes_dropped}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (3 gradients a "
        f"round, the third dropped); peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    _check_counts("quorum path", launches, {"fused_agg_opt": SHARDS * ROUNDS})
    if (st.steps, st.partial_aggregations, st.late_pushes_dropped) != (
            ROUNDS, ROUNDS, ROUNDS):
        raise AssertionError(f"quorum stats {st}")
    final = fab.params
    del fab
    ref = gw.fabric(2)
    for s in range(ROUNDS):
        gw.round(ref, s)
    gw.finite_losses()
    if not same_bits(final, ref.params):
        raise AssertionError(
            f"quorum fabric differs from the 2-worker sync fabric, max |err| "
            f"{max_abs_err(final, ref.params)}")
    log(f"  quorum (K = 2 of 3, the late push dropped) == 2-worker sync "
        f"fabric, bitwise after {ROUNDS} rounds")
    del ref, final
    torch.cuda.empty_cache()
    return {"launches": launches, "round_ms": round_ms, "peak_bytes": peak}


def async_path(dev, gw: GemmaWorkers) -> dict:
    """Async (Hogwild-PS) at full width on the int8 wire, error feedback
    and the fused wire path on: ``WorkerHarness(speed=[1, 2]).run(3)``
    makes 9 pushes, each applied at once with K = 1 and no averaging.
    Shard 0's first apply_wire is captured for a replay."""
    import torch

    from repro_torch.core.fabric import WorkerHarness
    from repro_torch.kernels.wire_path import kernel as W

    memory = PathMemory(dev)
    fab = gw.fabric(2, codec="int8", mode="async")
    captured: dict = {}
    shard0 = fab.shards[0]
    capture = LaunchTimer(shard0, "apply_wire",
                          first_apply_hook(shard0, captured))
    timer = LaunchTimer(W, "wire_fused_cuda")
    h = WorkerHarness(fab, lambda p, ws: gw.grad_tree(p, *ws),
                      lambda w, s: (w, s), speed=[1, 2])
    marks = []  # the host clock as each push has been applied
    push = fab.push

    def marked_push(w, g):
        push(w, g)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    fab.push = marked_push
    try:
        with timer, capture:
            _zero_counts()  # the counts to 0 just before the path...
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            h.run(ROUNDS)
            launches = _counts()  # ...and read just after
    finally:
        del fab.push
    push_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    ms = sum(push_ms)
    peak = memory.now()[1]
    st = fab.stats
    pushes = 3 * ROUNDS
    kernel_ms = timer.ms()
    log(f"async path: {gw.cfg.name}, 2 workers at speeds [1, 2], int8 wire "
        f"(error feedback, fused wire path), {SHARDS} shards, AdamW")
    log(f"  losses {gw.finite_losses()}")
    log(f"  launches {launches}; steps {st.steps}, fused wire rounds "
        f"{st.fused_wire_rounds}, pushes {st.pushes}; wall ms {ms:.1f} for "
        f"{pushes} pushes, each (pull, gradient, encode, 4 updates) "
        f"{[round(x, 1) for x in push_ms]} (the first includes the shard-0 "
        f"capture to host memory)")
    log(f"  wire_fused (K=1, average=False) ms per launch (CUDA events, "
        f"median of {len(kernel_ms)}) {statistics.median(kernel_ms):.4f}; "
        f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    _check_counts("async path", launches, {
        "quantize_chunks": pushes, "dequantize_chunks": pushes,
        "wire_fused": SHARDS * pushes})
    if (st.steps, st.fused_wire_rounds, st.pushes) != (pushes,) * 3:
        raise AssertionError(f"async stats {st}")
    if captured["average"] or captured["in"][0][0].shape[0] != 1:
        raise AssertionError("the async apply_wire was not K = 1 without "
                             "averaging")
    if not torch.isfinite(fab.params).all():
        raise AssertionError("async params are not finite")
    n0, spec = shard0.num_elems, fab.spec
    del fab, h, shard0
    torch.cuda.empty_cache()
    return {"launches": launches, "push_ms": push_ms, "peak_bytes": peak,
            "main_path_ms": statistics.median(kernel_ms), "n": n0,
            "chunk": gw.space.chunk_elems, "spec": spec, "captured": captured}


def host_available_bytes() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def snapshot_digest(snap: dict) -> str:
    """SHA-1 of a snapshot's arrays (pieces hashed on 8 threads; hashlib
    releases the GIL), clocks and step."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    piece = 1 << 28
    views = []
    for a in (snap["params"], *snap["state"]):
        b = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        views += [b[i:i + piece] for i in range(0, b.size, piece)]
    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(lambda v: hashlib.sha1(v).digest(), views))
    h = hashlib.sha1(b"".join(parts))
    h.update(np.asarray(snap["worker_clock"], np.int64).tobytes())
    h.update(str(int(snap["step"])).encode())
    return h.hexdigest()


def snapshot_path(dev, gw: GemmaWorkers) -> dict:
    """Snapshot, rebalance and restore at full width (f32 wire, 2 workers).

    Run A: rounds 1-2; in round 3 worker 0 pushes, the snapshot is taken
    (worker 0's clock rolls back in it), worker 1 pushes; a
    ShardRebalancer fed latencies that flag shard 3 drains it; rounds 4-5.
    Run B: a fresh 2-shard fabric restores the snapshot and replays round
    3, then rounds 4-5.  A's and B's final params must be bitwise equal
    (only A's are kept while B runs), the snapshot must be unchanged by
    A's later rounds, and restoring it a second time must give its bits
    back."""
    import torch

    from repro_torch.runtime.straggler import ShardRebalancer

    free = host_available_bytes()
    log(f"snapshot path: {gw.cfg.name}, 2 workers, f32 wire, AdamW; host "
        f"memory available before it {free} bytes ({free / 2**30:.1f} GiB)")
    memory = PathMemory(dev)
    fab = gw.fabric(2)
    _zero_counts()  # run A's counts to 0 just before it...
    round_ms = [timed(lambda s=s: gw.round(fab, s)) for s in (0, 1)]
    gw.round(fab, 2, workers=(0,))
    snap: dict = {}
    d2h_ms = timed(lambda: snap.update(fab.snapshot()))
    nbytes = sum(a.nbytes for a in (snap["params"], *snap["state"]))
    if list(snap["worker_clock"]) != [2, 2] or list(fab.worker_clock) != [3, 2]:
        raise AssertionError(
            f"mid-round snapshot clocks {snap['worker_clock']} (fabric "
            f"{fab.worker_clock}), expected [2, 2] ([3, 2])")
    t0 = time.perf_counter()
    digest = snapshot_digest(snap)
    hash_s = time.perf_counter() - t0
    gw.round(fab, 2, workers=(1,))
    reb = ShardRebalancer(fab, cooldown=0)
    for _ in range(10):
        for shard, lat_ms in enumerate((1.0, 1.0, 1.0, 5.0)):
            reb.record(shard, lat_ms)
    drained: list = []
    rebalance_ms = timed(lambda: drained.extend(reb.maybe_rebalance()))
    if drained != [3] or fab.shards[3].num_chunks != 0:
        raise AssertionError(f"the rebalancer drained {drained}; shard 3 "
                             f"holds {fab.shards[3].num_chunks} chunks")
    moved = fab.stats.chunks_moved
    round_ms += [timed(lambda s=s: gw.round(fab, s)) for s in (3, 4)]
    launches_a = _counts()  # ...read just after
    peak_a = memory.now()[1]
    losses_a = gw.finite_losses()
    final_a = fab.params
    sim = (fab.stats.sim_pipelined_us, fab.stats.sim_serialized_us)
    del fab, reb
    torch.cuda.empty_cache()
    if snapshot_digest(snap) != digest:
        raise AssertionError("run A's later rounds changed the snapshot")
    log(f"  run A (4 shards): launches {launches_a}; round wall ms "
        f"{[round(x, 1) for x in round_ms]} (rounds 1, 2, 4, 5); mid-round 3 "
        f"snapshot of {nbytes} bytes to host in {d2h_ms:.1f} ms "
        f"({nbytes / d2h_ms / 1e6:.2f} GB/s), SHA-1 in {hash_s:.1f} s; the "
        f"rebalancer drained shard {drained} ({moved} chunks moved) in "
        f"{rebalance_ms:.1f} ms; event clock pipelined/serialized "
        f"{sim[0]:.0f}/{sim[1]:.0f} us; peak device memory {peak_a} bytes "
        f"({peak_a / 2**30:.2f} GiB)")
    _check_counts("snapshot run A", launches_a,
                  {"fused_agg_opt": 3 * SHARDS + 2 * (SHARDS - 1)})
    memory = PathMemory(dev)
    fab = gw.fabric(2, num_shards=2)
    _zero_counts()  # run B's counts to 0 just before it...
    h2d_ms = timed(lambda: fab.restore(snap))
    if fab.step != 2 or list(fab.worker_clock) != [2, 2]:
        raise AssertionError(f"restored step {fab.step}, clocks "
                             f"{fab.worker_clock}")
    round_b = [timed(lambda s=s: gw.round(fab, s)) for s in (2, 3, 4)]
    launches_b = _counts()  # ...read just after
    peak_b = memory.now()[1]
    losses_b = gw.finite_losses()
    if not same_bits(final_a, fab.params):
        raise AssertionError(
            f"run B (restored onto 2 shards) differs from run A, max |err| "
            f"{max_abs_err(final_a, fab.params)}")
    log(f"  run B (2 shards): restore of {nbytes} bytes in {h2d_ms:.1f} ms "
        f"({nbytes / h2d_ms / 1e6:.2f} GB/s); launches {launches_b}; round "
        f"wall ms {[round(x, 1) for x in round_b]} (rounds 3-5); peak device "
        f"memory {peak_b} bytes ({peak_b / 2**30:.2f} GiB)")
    if losses_b != losses_a[-len(losses_b):]:
        raise AssertionError(f"run B's losses {losses_b} are not run A's "
                             f"last {losses_a[-len(losses_b):]}")
    log(f"  run A (mid-round snapshot, rebalance) == run B (restored onto 2 "
        f"shards), bitwise; losses A {losses_a}, B {losses_b}")
    _check_counts("snapshot run B", launches_b, {"fused_agg_opt": 3 * 2})
    del final_a
    fab.restore(snap)
    again: dict = {}
    again_ms = timed(lambda: again.update(fab.snapshot()))
    if snapshot_digest(again) != digest:
        raise AssertionError("restoring the snapshot a second time gave "
                             "other bits")
    log(f"  restored a second time: the snapshot's bits (re-snapshot in "
        f"{again_ms:.1f} ms); the snapshot unchanged by run A's later rounds")
    del fab, snap, again
    torch.cuda.empty_cache()
    return {"launches_a": launches_a, "launches_b": launches_b,
            "round_ms": round_ms + round_b, "d2h_ms": d2h_ms,
            "h2d_ms": h2d_ms, "snapshot_bytes": nbytes,
            "rebalance_ms": rebalance_ms, "chunks_moved": moved,
            "peak_bytes": max(peak_a, peak_b), "host_available": free}


# mode -> (workers, FabricConfig fields, harness speeds; None: by hand)
SMOKE_MODES = {
    "quorum": (3, dict(min_push_fraction=0.5), None),
    "ssp": (2, dict(mode="stale", staleness=1), [1, 2]),
    "async": (2, dict(mode="async"), [1, 2]),
}


def smoke_modes_check(dev) -> dict:
    """Every mode x codec (none, int8) at gemma3-1b's SMOKE config: the
    fabric on ``dev`` against the fabric on the CPU, bitwise in params,
    state, error-feedback residuals and every ServerStats field.  The
    workers' gradients come from the CPU model for both fabrics (the
    card's matmuls sum in another order), so two fabrics that agree pull
    the same params and get the same gradients.  Each run then takes a
    mid-round ``Checkpointer.save_fabric`` into a temporary directory,
    restores it into a fresh fabric with ``restore_fabric`` and trains 2
    more rounds.  Returns each case's kernel launches on ``dev``."""
    import tempfile

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import FabricConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    init = space.flatten(params)
    cpu = torch.device("cpu")

    memo: dict = {}  # (worker, step, params digest) -> the CPU gradient

    def grad(flat, w, s):
        # the card's run pulls the CPU run's params when the two agree, so
        # each gradient is computed once and served to both
        host = flat.cpu()
        key = (w, s, hashlib.sha1(host.numpy().tobytes()).hexdigest())
        if key not in memo:
            b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(space.unflatten(host),
                                    torch.from_numpy(b["tokens"]),
                                    torch.from_numpy(b["labels"]), cfg)
            memo[key] = space.flatten(g)
        return memo[key].to(flat.device, copy=True)

    def drive(fab, speeds, rounds):
        if speeds is not None:
            WorkerHarness(fab, lambda p, ws: space.unflatten(
                grad(space.flatten(p), *ws)), lambda w, s: (w, s),
                speed=speeds).run(rounds)
            return
        for s in range(rounds):  # all pull, then all push: the last drops
            flats = [fab.pull(w) for w in range(fab.num_workers)]
            for w in range(fab.num_workers):
                fab.push(w, grad(flats[w], w, s))

    def state_of(fab):
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).cpu()
                   for k in range(fab.spec.num_state_slots)]
                + [fab._worker_ef[w].cpu() for w in sorted(fab._worker_ef)])

    def run(d, config, speeds, mode, tmp):
        fab = PBoxFabric(space, adamw(3e-3), init.to(d), config=config,
                         device=d)
        drive(fab, speeds, ROUNDS)
        first = (state_of(fab), dataclasses.asdict(fab.stats))
        fab.push(0, grad(fab.pull(0), 0, 9))  # mid-round
        ck = Checkpointer(Path(tmp) / d.type)
        ck.save_fabric(fab.step, fab, meta={"mode": mode})
        fab2 = PBoxFabric(space, adamw(3e-3), torch.zeros_like(init, device=d),
                          config=config, device=d)
        meta = ck.restore_fabric(fab2)
        if meta["mode"] != mode or fab2.step != fab.step:
            raise AssertionError(f"checkpoint meta {meta}, step {fab2.step}")
        drive(fab2, speeds, 2)
        return first, state_of(fab2), dataclasses.asdict(fab2.stats)

    launches = {}
    for mode, (workers, fields, speeds) in SMOKE_MODES.items():
        for codec in ("none", "int8"):
            config = FabricConfig(
                num_shards=SHARDS, num_workers=workers, **fields,
                wire=WireConfig(compression=CompressionConfig(codec=codec)))
            with tempfile.TemporaryDirectory() as tmp:
                ref = run(cpu, config, speeds, mode, tmp)
                _zero_counts()
                got = run(dev, config, speeds, mode, tmp)
                launches[f"{mode}/{codec}"] = _counts()
            memo.clear()
            same = (all(same_bits(a, b) for a, b in zip(ref[0][0], got[0][0]))
                    and ref[0][1] == got[0][1] and ref[2] == got[2]
                    and all(same_bits(a, b) for a, b in zip(ref[1], got[1])))
            if not same:
                raise AssertionError(f"SMOKE {mode}/{codec}: the fabric on "
                                     f"{dev} differs from the CPU's")
            st = ref[0][1]
            log(f"smoke modes: {mode}/{codec} ({workers} workers, "
                + (f"speeds {speeds}" if speeds else "all pull, then all push")
                + f"): steps {st['steps']}, partial "
                f"{st['partial_aggregations']}, dropped "
                f"{st['late_pushes_dropped']}, fused wire rounds "
                f"{st['fused_wire_rounds']}; then a mid-round save_fabric / "
                f"restore_fabric and 2 more rounds; {dev} == cpu bitwise; "
                f"launches on {dev.type} {launches[f'{mode}/{codec}']}")
    return launches


# -- phases 12 to 14: the rack topology tier ---------------------------------
RACKS, OVERSUB = 2, 4.0  # NetworkTopology(workers, 2 racks, 1:4 core)


def topology(workers: int):
    from repro_torch.core.topology import NetworkTopology

    return NetworkTopology(workers, RACKS, oversubscription=OVERSUB)


def rack_chain_path(dev, gw: GemmaWorkers) -> dict:
    """Phase 12: the f32 rack chain at full width.  4 workers over 2 racks
    (1:4 core), codec none, 3 rounds: each ToR folds its members onto the
    prefix from the rack before and relays it, so the shards see one
    stream and three zero rows a round.  The params must equal a 4-worker
    flat fabric fed the same batches, bitwise; the core link carries 2
    streams a round where the flat fabric's carries 4."""
    import torch

    from repro_torch.core.compression import CompressionConfig, wire_bytes

    workers = range(4)
    n = gw.space.flat_elems
    memory = PathMemory(dev)
    fab = gw.fabric(4, topology=topology(4))
    _zero_counts()  # the counts to 0 just before the path...
    round_ms = [timed(lambda s=s: gw.round(fab, s, workers))
                for s in range(ROUNDS)]
    launches = _counts()  # ...and read just after
    peak = memory.now()[1]
    st = fab.stats
    stream = wire_bytes(CompressionConfig(), n)
    log(f"rack chain path: {gw.cfg.name}, 4 workers over {RACKS} racks "
        f"(core 1:{OVERSUB:g}), codec none, {SHARDS} shards, AdamW, {ROUNDS} "
        f"rounds")
    log(f"  losses {gw.finite_losses()}")
    log(f"  launches {launches}; rack streams {st.rack_streams}, bytes core "
        f"link {st.bytes_core_link}, rack links {st.bytes_rack_link}; event "
        f"clock core {st.sim_core_wire_us:.0f} us, pipelined "
        f"{st.sim_pipelined_us:.0f} us")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (4 gradients a "
        f"round); peak device memory {peak} bytes ({peak / 2**30:.2f} GiB)")
    _check_counts("rack chain path", launches,
                  {"fused_agg_opt": SHARDS * ROUNDS})
    want = (ROUNDS * RACKS, ROUNDS * RACKS * stream, ROUNDS * 4 * stream)
    if (st.rack_streams, st.bytes_core_link, st.bytes_rack_link) != want:
        raise AssertionError(f"rack chain stats {st}, expected (rack "
                             f"streams, core, rack bytes) {want}")
    final = fab.params
    del fab
    torch.cuda.empty_cache()
    # the rack chain's params, kept for the comparison, are not the flat
    # run's memory
    flat_memory = PathMemory(dev, held=final.numel() * final.element_size())
    ref = gw.fabric(4)
    _zero_counts()
    flat_ms = [timed(lambda s=s: gw.round(ref, s, workers))
               for s in range(ROUNDS)]
    flat_launches = _counts()
    flat_peak = flat_memory.now()[1]
    gw.finite_losses()
    _check_counts("flat 4-worker fabric", flat_launches,
                  {"fused_agg_opt": SHARDS * ROUNDS})
    if ref.stats.bytes_core_link != ROUNDS * 4 * stream:
        raise AssertionError(f"flat core bytes {ref.stats.bytes_core_link}")
    if not same_bits(final, ref.params):
        raise AssertionError(
            f"rack chain differs from the flat fabric, max |err| "
            f"{max_abs_err(final, ref.params)}")
    log(f"  rack chain == 4-worker flat fabric, bitwise after {ROUNDS} rounds; "
        f"core link {st.bytes_core_link} bytes against the flat fabric's "
        f"{ref.stats.bytes_core_link} ({st.bytes_core_link / ref.stats.bytes_core_link:.2f}x); "
        f"flat round wall ms {[round(x, 1) for x in flat_ms]}, peak "
        f"{flat_peak} bytes ({flat_peak / 2**30:.2f} GiB)")
    out = {"launches": launches, "flat_launches": flat_launches,
           "round_ms": round_ms, "flat_round_ms": flat_ms,
           "peak_bytes": peak, "flat_peak_bytes": flat_peak,
           "bytes_core_link": st.bytes_core_link,
           "flat_bytes_core_link": ref.stats.bytes_core_link}
    del ref, final
    torch.cuda.empty_cache()
    return out


def switch_path(dev, gw: GemmaWorkers) -> dict:
    """Phase 13: the switch pools at full width on the int8 wire (error
    feedback, fused wire path).  2 workers, one in each of 2 racks, AdamW,
    3 rounds, three runs:
      offloaded  ToR and core pools of one slot per chunk: every round
                 the ToR pools sum their rack's int8 payload under a shared
                 scale and the core pool sums the two rack streams, one
                 re-encoded stream reaching the shards;
      starved    pools one slot short: no push is ever parked, so the run
                 is the software path;
      no switch  the same topology fabric without the tier; the starved
                 run must equal it, bitwise."""
    import torch

    from repro_torch.core.compression import CompressionConfig, wire_bytes
    from repro_torch.core.config import SwitchConfig

    c = gw.space.num_chunks
    runs: dict = {}
    finals: dict = {}
    for label, slots in (("offloaded", c), ("starved", c - 1),
                         ("no switch", None)):
        switch = (SwitchConfig() if slots is None else
                  SwitchConfig(enabled=True, tor_slots=slots,
                               core_slots=slots))
        # the starved run's params, kept for the comparison, are not this
        # run's memory
        memory = PathMemory(dev, held=sum(t.numel() * t.element_size()
                                          for t in finals.values()))
        fab = gw.fabric(WORKERS, codec="int8", topology=topology(WORKERS),
                        switch=switch)
        _zero_counts()  # the counts to 0 just before the run...
        round_ms = [timed(lambda s=s: gw.round(fab, s))
                    for s in range(ROUNDS)]
        launches = _counts()  # ...and read just after
        peak = memory.now()[1]
        st = fab.stats
        runs[label] = {"launches": launches, "round_ms": round_ms,
                       "peak_bytes": peak,
                       "stats": dataclasses.asdict(st),
                       "switches": [dataclasses.asdict(r.switch.stats)
                                    for r in fab.rack_aggs if r.switch]
                       + ([dataclasses.asdict(fab.core_switch.stats)]
                          if fab.core_switch else [])}
        log(f"switch path ({label}): {gw.cfg.name}, 2 workers over {RACKS} "
            f"racks, int8 wire, "
            + (f"tor_slots = core_slots = {slots} ({c} chunks)" if slots
               else "no switch tier") + f", AdamW, {ROUNDS} rounds")
        log(f"  losses {gw.finite_losses()}")
        log(f"  launches {launches}; switch rounds {st.switch_rounds}, core "
            f"switch rounds {st.core_switch_rounds}, fallback rounds "
            f"{st.switch_fallback_rounds}, bytes absorbed "
            f"{st.bytes_switch_agg}, PS ingress saved {st.bytes_switch_saved}; "
            f"bytes core link {st.bytes_core_link}")
        log(f"  round wall ms {[round(x, 1) for x in round_ms]}; peak device "
            f"memory {peak} bytes ({peak / 2**30:.2f} GiB)")
        if not torch.isfinite(fab.params).all():
            raise AssertionError(f"switch path ({label}): params not finite")
        if label == "offloaded":
            _check_counts("offloaded switch run", launches,
                          {"wire_fused": SHARDS * ROUNDS})
            if (st.switch_rounds, st.core_switch_rounds,
                    st.switch_fallback_rounds) != (ROUNDS, ROUNDS, 0):
                raise AssertionError(f"offloaded switch stats {st}")
        else:
            _check_counts(f"{label} run", launches, {
                "quantize_chunks": 2 * WORKERS * ROUNDS,
                "dequantize_chunks": 2 * WORKERS * ROUNDS,
                "wire_fused": SHARDS * ROUNDS})
            if st.switch_rounds or st.core_switch_rounds:
                raise AssertionError(f"{label} run offloaded: {st}")
            finals[label] = fab.params
        del fab
        torch.cuda.empty_cache()
    if not same_bits(finals["starved"], finals["no switch"]):
        raise AssertionError(
            f"starved pools differ from no switch tier, max |err| "
            f"{max_abs_err(finals['starved'], finals['no switch'])}")
    del finals
    torch.cuda.empty_cache()
    flat = ROUNDS * WORKERS * wire_bytes(CompressionConfig(codec="int8"),
                                         gw.space.flat_elems)
    log(f"  starved pools == no switch tier, bitwise after {ROUNDS} rounds; "
        f"core link {runs['offloaded']['stats']['bytes_core_link']} bytes, "
        f"a flat int8 fabric's {flat} (2 pushes a round); the core pool "
        f"saved {runs['offloaded']['stats']['bytes_switch_saved']} bytes of "
        f"PS ingress")
    return runs


def switch_math_ms(dev, n: int, chunk: int) -> dict:
    """Device time (CUDA events, median of 5) of the switch pool's plain
    torch integer math at full width, on two seeded f32 slabs of ``n``
    elements (2 racks): the shared scale, one sender's int8 encode and its
    residual, the int32 slot sum of two payloads and its dequantize.  Each
    beside its byte bound (inputs read once, outputs written once)."""
    import torch

    from repro_torch.core.topology import (
        SwitchCompute,
        group_scale,
        integer_quantize,
        quant_residual,
        scale_chunks,
    )

    name = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn(n, generator=gen, device=dev) * 1e-3
    b = torch.randn(n, generator=gen, device=dev) * 1e-3
    c = n // chunk
    sw = SwitchCompute("t", c)
    s = group_scale([a, b], chunk)
    qa = integer_quantize(a, s, chunk)
    qb = integer_quantize(b, s, chunk)
    acc = sw.accumulate([qa, qb], chunk)
    # (label, call, bytes read and written once)
    ops = {
        "group_scale (2 slabs)": (lambda: group_scale([a, b], chunk),
                                  8 * n + 4 * c),
        "integer_quantize": (lambda: integer_quantize(a, s, chunk),
                             4 * n + 4 * c + n),
        "residual": (lambda: quant_residual(a, qa, s),
                     4 * n + n + 4 * c + 4 * n),
        "accumulate (2 payloads)": (lambda: sw.accumulate([qa, qb], chunk),
                                    2 * n + 4 * n),
        "dequantize the sum": (lambda: scale_chunks(acc, s),
                               4 * n + 4 * c + 4 * n),
    }
    out = {}
    for label, (fn, nbytes) in ops.items():
        ms = cuda_ms(fn, reps=5)
        out[label] = {"ms": ms, **bound(name, nbytes, 0)}
    del a, b, qa, qb, acc, s
    torch.cuda.empty_cache()
    total = sum(v["ms"] for v in out.values())
    log(f"switch integer math (plain torch ops, n = {n}, chunk {chunk}; CUDA "
        f"events, median of 5): " + "; ".join(
            f"{k} {v['ms']:.3f} ms (bound {v['bound_ms']:.3f})"
            for k, v in out.items()) + f"; sum {total:.3f} ms")
    return out


# the SMOKE topology sweep: mode -> (FabricConfig fields, harness speeds;
# None: every worker pulls, then every worker pushes)
TOPO_MODES = {
    "sync": (dict(), [1, 1, 1, 1]),
    "quorum": (dict(min_push_fraction=0.75), None),
    "ssp": (dict(mode="stale", staleness=1), [1, 1, 1, 2]),
    "async": (dict(mode="async"), [1, 1, 1, 2]),
}
SWITCH_VARIANTS = ("off", "on", "starved", "tor_fail", "core_fail")


def smoke_topology_check(dev) -> dict:
    """Phase 14: the topology tier at gemma3-1b's SMOKE config, every codec
    (none, bf16, int8 with error feedback) x mode (sync, a 3-of-4 quorum,
    SSP, async), the int8 wire also x switch (off; pools of one slot per
    chunk; starved one slot short; a ToR pool, or the core pool, failed at
    round 2 by a FaultPlan and restored at round 3): 4 workers over 2
    racks, 4 shards,
    3 rounds.  The fabric on ``dev`` against the fabric on the CPU,
    bitwise in params, state, every ServerStats / ShardStats / RackStats /
    SwitchStats field, the ToRs' and core pool's residuals and
    fault_trace.  The card run goes first and computes each gradient on
    the card, keyed by (worker, step, digest of the pulled params); the
    CPU run then takes the gradient of the same key, so both fabrics get
    the same bits, and a CPU pull the card never made fails the case.
    Returns each case's kernel launches on ``dev``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import (
        FabricConfig,
        FaultConfig,
        SwitchConfig,
        WireConfig,
    )
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.core.replication import FaultEvent, FaultPlan
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    init = space.flatten(params)
    cpu = torch.device("cpu")
    book: dict = {}
    filling = [True]  # the card run fills the book, the CPU run reads it

    def grad(flat, w, s):
        key = (w, s, hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest())
        if key not in book:
            if not filling[0]:
                raise AssertionError(
                    f"the CPU fabric pulled params for worker {w} step {s} "
                    "that the card fabric never pulled")
            b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                space.unflatten(flat), torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
            book[key] = space.flatten(g).cpu()
        return book[key].to(flat.device)

    def run(d, config, speeds):
        fab = PBoxFabric(space, adamw(3e-3), init.to(d), config=config,
                         device=d)
        if speeds is not None:
            WorkerHarness(fab, lambda p, ws: space.unflatten(
                grad(space.flatten(p), *ws)), lambda w, s: (w, s),
                speed=speeds).run(ROUNDS)
        else:
            for s in range(ROUNDS):
                flats = [fab.pull(w) for w in range(4)]
                for w in range(4):
                    fab.push(w, grad(flats[w], w, s))
        return fab

    def bits_of(fab):
        efs = [r._uplink_ef for r in fab.rack_aggs] + [fab._core_ef] + [
            r._worker_ef[w] for r in fab.rack_aggs for w in r.members]
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).cpu()
                   for k in range(fab.spec.num_state_slots)]
                + [None if e is None else e.cpu() for e in efs])

    def stats_of(fab):
        return (dataclasses.asdict(fab.stats),
                [dataclasses.asdict(sh.stats) for sh in fab.shards],
                [dataclasses.asdict(r.stats) for r in fab.rack_aggs],
                [dataclasses.asdict(r.switch.stats) if r.switch else None
                 for r in fab.rack_aggs],
                dataclasses.asdict(fab.core_switch.stats)
                if fab.core_switch else None,
                fab.fault_trace)

    launches = {}
    offloads = {}
    c = space.num_chunks
    for codec in ("none", "bf16", "int8"):
        for mode, (fields, speeds) in TOPO_MODES.items():
            # the pools engage only on the int8 wire; the other codecs run
            # without a switch (their switch variants were cut for time)
            for variant in SWITCH_VARIANTS if codec == "int8" else ("off",):
                slots = c - (variant == "starved")
                switch = (SwitchConfig() if variant == "off" else
                          SwitchConfig(enabled=True, tor_slots=slots,
                                       core_slots=slots))
                target = {"tor_fail": 0, "core_fail": RACKS}.get(variant)
                plan = (None if target is None else FaultPlan([
                    FaultEvent(2, "switch_fail", target),
                    FaultEvent(3, "switch_restore", target)]))
                config = FabricConfig(
                    num_shards=SHARDS, num_workers=4, **fields,
                    wire=WireConfig(topology=topology(4), switch=switch,
                                    compression=CompressionConfig(
                                        codec=codec)),
                    faults=FaultConfig(fault_plan=plan))
                book.clear()
                case = f"{codec}/{mode}/{variant}"
                filling[0] = True
                _zero_counts()
                got = run(dev, config, speeds)
                launches[case] = _counts()
                filling[0] = False
                ref = run(cpu, config, speeds)
                same = (stats_of(ref) == stats_of(got) and all(
                    (a is None and b is None) or same_bits(a, b)
                    for a, b in zip(bits_of(ref), bits_of(got))))
                if not same:
                    raise AssertionError(f"SMOKE topology {case}: the fabric "
                                         f"on {dev} differs from the CPU's")
                st = ref.stats
                offloads[case] = (st.switch_rounds, st.core_switch_rounds,
                                  st.switch_fallback_rounds)
                del got, ref
    book.clear()
    engaged = {k: v for k, v in offloads.items() if any(v)}
    if not engaged or not all(k.startswith("int8/") for k in engaged):
        raise AssertionError(f"switch offloads by case {offloads}")
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    log(f"smoke topology: {len(launches)} cases (codec x mode, int8 x switch, 4 "
        f"workers over {RACKS} racks, {SHARDS} shards, {ROUNDS} rounds), "
        f"{dev} == cpu bitwise in params, state, residuals, every stats "
        f"field and fault_trace; launches on {dev.type} {total}; (ToR, core, "
        f"fallback) switch rounds where a pool engaged {engaged}")
    return launches


# -- phases 15 and 16: the fault tier ----------------------------------------
FAULT_ROUNDS = 4
# the full-width run B's plan, (round, kind, target, factor): rack 1's link
# slows 3x after round 1, shard 1 crashes after round 2, the link is
# restored after round 3; the fabric reshards 4 -> 2 after round 3
FAULT_EVENTS = ((1, "link_degrade", 1, 3.0), (2, "shard_crash", 1, 1.0),
                (3, "link_restore", 1, 1.0))
RESHARD_AFTER, RESHARD_TO = 3, 2


def fault_plan(events):
    from repro_torch.core.replication import FaultEvent, FaultPlan

    return FaultPlan(FaultEvent(*e) for e in events)


def host_state(fab) -> list:
    """``fab``'s params and optimizer slots, assembled one at a time on its
    device, as host numpy copies."""
    out = [fab.params.to("cpu", copy=True).numpy()]
    fab._flat_cache = None
    for k in range(fab.spec.num_state_slots):
        out.append(fab._assemble_rows(lambda sh, k=k: sh.state[k]).to(
            "cpu", copy=True).numpy())
    return out


def state_digest(arrays: list) -> str:
    """SHA-1 over host arrays' bytes, in order (no copy)."""
    h = hashlib.sha1()
    for x in arrays:
        h.update(memoryview(x).cast("B"))
    return h.hexdigest()


def same_host_bits(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        x.shape == y.shape and np.array_equal(x.view(np.uint32),
                                              y.view(np.uint32))
        for x, y in zip(a, b))


def fault_rehearsal() -> dict:
    """Phase 15's schedule on the CPU at gemma3-1b's SMOKE config (the
    same workers, racks, shards, replication, plan and reshard): the fault
    trace the full-width run on the card must export."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.config import FabricConfig, FaultConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    fab = PBoxFabric(space, adamw(3e-3), space.flatten(params), device="cpu",
                     config=FabricConfig(
                         num_shards=SHARDS, num_workers=2,
                         wire=WireConfig(topology=topology(2)),
                         faults=FaultConfig(replication=2, fault_plan=fault_plan(
                             FAULT_EVENTS))))

    for s in range(FAULT_ROUNDS):
        for w in range(2):
            b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                space.unflatten(fab.pull(w)), torch.from_numpy(b["tokens"]),
                torch.from_numpy(b["labels"]), cfg)
            fab.push(w, space.flatten(g))
        if s + 1 == RESHARD_AFTER:
            fab.reshard(RESHARD_TO)
    return fab.export_fault_trace()


def failover_path(dev, gw: GemmaWorkers, rehearsal: dict) -> dict:
    """Phase 15: failover and reshard at full width.  2 workers, one in
    each of 2 racks (1:4 core), codec none, AdamW, 4 shards, 4 rounds.

    Run A: replication 1, fault-free; it must build no chain.  Run B:
    replication 2 (every chain hop crosses the core) under FAULT_EVENTS,
    and ``reshard(2)`` at the edge after round 3.  After round 4 B's
    params and both AdamW slots must equal A's bitwise (both kept on the
    host), B's losses A's, and B's exported fault trace the CPU
    rehearsal's.  The byte counters must equal the arithmetic: one chain
    hop of the whole state (params + 2 slots, raw f32) a round, one
    re-silver of shard 1's slab, and both on the core link on top of A's
    training streams.  Times each round, each chain pass (CUDA events
    around ``_replicate_round``), the failover (host clock and events
    around ``crash_shard``) and the reshard (host clock), and the peaks."""
    import time as _time

    import numpy as np
    import torch

    from repro_torch.core.config import FaultConfig

    space = gw.space
    state_bytes = 4 * space.flat_elems * 3  # params + AdamW's 2 slots
    shard1 = len(np.array_split(np.arange(space.num_chunks), SHARDS)[1])
    resilver_bytes = 4 * 3 * shard1 * space.chunk_elems
    name = torch.cuda.get_device_name(dev)
    topo = topology(2)

    def retries():
        """The caching allocator's retries so far (each frees its cached
        blocks and waits for the card)."""
        return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)

    memory = PathMemory(dev)
    fab = gw.fabric(2, topology=topo)
    retries_a = retries()
    _zero_counts()  # run A's counts to 0 just before it...
    round_a = [timed(lambda s=s: gw.round(fab, s))
               for s in range(FAULT_ROUNDS)]
    launches_a = _counts()  # ...and read just after
    peak_a = memory.now()[1]
    retries_a = retries() - retries_a
    losses_a = gw.finite_losses()
    if fab.replicas or fab.stats.bytes_replication:
        raise AssertionError("a replication-1 fabric built a chain")
    core_a = fab.stats.bytes_core_link
    want = host_state(fab)
    digest_a = state_digest(want)  # phase 23's fixed-layout reference
    del fab
    torch.cuda.empty_cache()
    _check_counts("failover run A", launches_a,
                  {"fused_agg_opt": SHARDS * FAULT_ROUNDS})

    memory = PathMemory(dev)
    fab = gw.fabric(2, topology=topo, faults=FaultConfig(
        replication=2, fault_plan=fault_plan(FAULT_EVENTS)))
    provisioned = memory.now()[0]
    chain_events: list = []
    replicate = fab._replicate_round

    def timed_replicate():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        replicate()
        end.record()
        chain_events.append((start, end))

    failover: dict = {}
    crash = fab.crash_shard

    def timed_crash(shard_id):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        start.record()
        action = crash(shard_id)
        end.record()
        torch.cuda.synchronize()
        failover.update(host_ms=(_time.perf_counter() - t0) * 1e3,
                        device_ms=start.elapsed_time(end),
                        allocated=torch.cuda.memory_allocated(dev) - before)
        return action

    fab._replicate_round = timed_replicate
    fab.crash_shard = timed_crash
    retries_b = [retries()]
    _zero_counts()  # run B's counts to 0 just before it...
    round_b = []
    for s in range(FAULT_ROUNDS):
        round_b.append(timed(lambda s=s: gw.round(fab, s)))
        retries_b.append(retries())
        if s + 1 == RESHARD_AFTER:
            launches_edge = _counts()
            memory.hold(0)  # the reshard's own peak from here
            reshard_ms = timed(lambda: fab.reshard(RESHARD_TO))
            reshard_peak = torch.cuda.max_memory_allocated(dev)
    launches_b = _counts()  # ...and read just after
    peak_b = memory.now()[1]
    losses_b = gw.finite_losses()
    chain_ms = [a.elapsed_time(b) for a, b in chain_events]
    st = fab.stats
    trace = fab.export_fault_trace()
    got = host_state(fab)
    # the timing wrappers close over fab's bound methods: a reference
    # cycle that would keep run B's state and chain on the card
    del fab._replicate_round, fab.crash_shard, fab
    torch.cuda.empty_cache()
    if not same_host_bits(want, got):
        raise AssertionError(
            "failover run B differs from the fault-free run A, max |err| "
            + str([float(np.max(np.abs(a - b))) for a, b in zip(want, got)]))
    del want, got
    if losses_b != losses_a:
        raise AssertionError(f"run B's losses {losses_b}, run A's {losses_a}")
    if trace != rehearsal:
        raise AssertionError(f"run B's fault trace {trace}, the CPU "
                             f"rehearsal's {rehearsal}")
    want_stats = dict(failovers=1, resilvers=1, rescales=1,
                      shards_crashed=1, link_degrades=1,
                      replication_rounds=FAULT_ROUNDS,
                      bytes_replication=FAULT_ROUNDS * state_bytes,
                      bytes_resilver=resilver_bytes,
                      bytes_core_link=core_a + FAULT_ROUNDS * state_bytes
                      + resilver_bytes)
    got_stats = {k: getattr(st, k) for k in want_stats}
    if got_stats != want_stats:
        raise AssertionError(f"failover run B stats {got_stats}, expected "
                             f"{want_stats}")
    _check_counts("failover run B to the reshard", launches_edge,
                  {"fused_agg_opt": SHARDS * RESHARD_AFTER})
    _check_counts("failover run B", launches_b, {
        "fused_agg_opt": SHARDS * RESHARD_AFTER
        + RESHARD_TO * (FAULT_ROUNDS - RESHARD_AFTER)})
    chain_bound = bound(name, 2 * state_bytes, 0)["bound_ms"]
    resilver_bound = bound(name, 2 * resilver_bytes, 0)["bound_ms"]
    log(f"failover path: {gw.cfg.name}, 2 workers over {RACKS} racks (core "
        f"1:{OVERSUB:g}), codec none, AdamW, {SHARDS} shards, "
        f"{FAULT_ROUNDS} rounds; run B replication 2 under "
        f"{list(FAULT_EVENTS)}, reshard {SHARDS} -> {RESHARD_TO} after round "
        f"{RESHARD_AFTER}")
    log(f"  run A (R = 1): round wall ms {[round(x, 1) for x in round_a]}; "
        f"launches {launches_a}; no chain; peak device memory {peak_a} "
        f"bytes ({peak_a / 2**30:.2f} GiB); allocator retries {retries_a}")
    log(f"  run B (R = 2): round wall ms {[round(x, 1) for x in round_b]}; "
        f"launches {launches_b}; chain provisioned at construction, "
        f"{provisioned} bytes allocated ({provisioned / 2**30:.2f} GiB); "
        f"peak device memory {peak_b} bytes ({peak_b / 2**30:.2f} GiB); "
        f"allocator retries by round "
        f"{[b - a for a, b in zip(retries_b, retries_b[1:])]}")
    log(f"  chain pass (_replicate_round, CUDA events) ms "
        f"{[round(x, 3) for x in chain_ms]} for {state_bytes} bytes a round "
        f"(bound {chain_bound:.3f} ms, {name})")
    log(f"  failover of shard 1 (promote, re-silver {resilver_bytes} bytes): "
        f"host {failover['host_ms']:.3f} ms, device {failover['device_ms']:.3f}"
        f" ms (re-silver bound {resilver_bound:.3f} ms), {failover['allocated']}"
        f" bytes allocated")
    log(f"  reshard {SHARDS} -> {RESHARD_TO}: {reshard_ms:.1f} ms host, peak "
        f"device memory during it {reshard_peak} bytes "
        f"({reshard_peak / 2**30:.2f} GiB)")
    log(f"  run B == run A bitwise (params, both AdamW slots); losses "
        f"{losses_b}; fault trace == the CPU rehearsal's "
        f"{[t['action'] for t in trace['trace']]}; bytes replication "
        f"{st.bytes_replication}, resilver {st.bytes_resilver}, core link "
        f"{st.bytes_core_link} (run A {core_a})")
    if failover["allocated"] > 0:
        raise AssertionError(f"the failover allocated {failover['allocated']} "
                             "bytes")
    return {"launches_a": launches_a, "launches_b": launches_b,
            "round_ms_a": round_a, "round_ms_b": round_b,
            "chain_ms": chain_ms, "chain_bound_ms": chain_bound,
            "failover": failover, "resilver_bound_ms": resilver_bound,
            "reshard_ms": reshard_ms, "reshard_peak_bytes": reshard_peak,
            "peak_a": peak_a, "peak_b": peak_b, "digest_a": digest_a,
            "losses_a": losses_a}


def smoke_fault_check(dev) -> dict:
    """Phase 16: the fault tier at gemma3-1b's SMOKE config, 4 workers, 4
    shards, 3 rounds, the fabric on ``dev`` against the fabric on the CPU,
    bitwise in params, state, residuals, every stats field, ``fault_trace``
    and ``export_fault_trace()``: codec (none, bf16, int8) x replication
    (1: ``ShardLost`` on both; 2; 3, with the same shard crashing again the
    next round) x racks (1; 2 with a 1:4 core) x a shard crash after round
    1 or round 2; a worker crash after round 1 with its re-entry through
    ``runtime/elastic.worker_reentry`` before round 3 (2 racks, R = 2);
    and a SparseTier attached to an R = 2 fabric without topology (int8
    rows, a table of 4096 x 32), shard 1 crashing after round 2, its
    lookups through ``embedding_bag`` compared too.  Each shard-crash case
    on the card also equals the card's fault-free run.  Gradients are
    booked on the card by (worker, step, digest of the pulled params) and
    replayed on the CPU, as in phase 14.  Returns each case's launches on
    ``dev``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.config import FabricConfig, FaultConfig, WireConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.replication import ShardLost
    from repro_torch.core.sparse import SparseTier
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw
    from repro_torch.runtime.elastic import worker_reentry

    cfg = get_arch("gemma3-1b").smoke_config
    params = init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, chunk_elems=4096)
    init = space.flatten(params)
    cpu = torch.device("cpu")
    book: dict = {}
    filling = [True]  # the card runs fill the book, the CPU runs read it

    def grad(flat, w, s):
        key = (w, s, hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest())
        if key not in book:
            if not filling[0]:
                raise AssertionError(
                    f"the CPU fabric pulled params for worker {w} step {s} "
                    "that the card fabric never pulled")
            b = next(lm_batches(cfg.vocab, 4, 32, seed=1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                space.unflatten(flat), torch.from_numpy(b["tokens"]).to(dev),
                torch.from_numpy(b["labels"]).to(dev), cfg)
            book[key] = space.flatten(g).cpu()
        return book[key].to(flat.device)

    def build(d, codec, racks, replication=1, events=()):
        return PBoxFabric(space, adamw(3e-3), init.to(d), device=d,
                          config=FabricConfig(
                              num_shards=SHARDS, num_workers=4,
                              wire=WireConfig(
                                  topology=topology(4) if racks > 1 else None,
                                  compression=CompressionConfig(codec=codec)),
                              faults=FaultConfig(
                                  replication=replication,
                                  fault_plan=fault_plan(events)
                                  if events else None)))

    def drive(fab, reentry=None, tier=None, lookups=None):
        """ROUNDS rounds: the alive workers pull, then push; ``reentry``
        (round, worker) re-admits a crashed worker at that round's start;
        with a ``tier`` each worker first pushes sparse rows and looks a
        jagged batch up.  Returns the ShardLost a crash raised, as text."""
        try:
            for s in range(ROUNDS):
                if reentry is not None and s == reentry[0]:
                    worker_reentry(fab, reentry[1])
                alive = [w for w in range(4) if fab.alive(w)]
                if tier is not None:
                    for w in alive:
                        rng = np.random.default_rng((s, w))
                        ids = rng.integers(0, 4096, size=64)
                        rows = rng.standard_normal((64, 32)).astype(
                            np.float32)
                        tier.push(w, {"t0": (ids, torch.from_numpy(rows).to(
                            fab.device))})
                        offsets = np.arange(0, 65, 4)
                        lookups.append(tier.lookup(w, "t0", ids, offsets).cpu())
                flats = {w: fab.pull(w) for w in alive}
                for w in alive:
                    fab.push(w, grad(flats[w], w, s))
        except ShardLost as e:
            return f"{type(e).__name__}: {e}"
        return None

    def bits_of(fab):
        efs = ([r._uplink_ef for r in fab.rack_aggs]
               + [r._worker_ef[w] for r in fab.rack_aggs for w in r.members]
               + [fab._worker_ef[w] for w in sorted(fab._worker_ef)])
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).cpu()
                   for k in range(fab.spec.num_state_slots)]
                + [None if e is None else e.cpu() for e in efs])

    def stats_of(fab):
        return (dataclasses.asdict(fab.stats),
                [dataclasses.asdict(sh.stats) for sh in fab.shards],
                [dataclasses.asdict(r.stats) for r in fab.rack_aggs],
                fab.fault_trace, fab.export_fault_trace(),
                sorted(fab.dead_workers), fab.worker_clock.tolist())

    def same(a, b):
        return all((x is None and y is None) or same_bits(x, y)
                   for x, y in zip(a, b))

    cases = []
    for codec in ("none", "bf16", "int8"):
        for racks in (1, 2):
            for r in (1, 2, 3):
                for at in (1, 2):
                    events = [(at, "shard_crash", at)]
                    if r == 3:  # the same shard again, the next round
                        events.append((at + 1, "shard_crash", at))
                    cases.append((f"{codec}/racks{racks}/R{r}/crash{at}",
                                  codec, racks, r, events, None))
        cases.append((f"{codec}/racks2/R2/worker_reentry", codec, 2, 2,
                      [(1, "worker_crash", 3)], (2, 3)))
    launches: dict = {}
    bases: dict = {}
    lost = 0
    for case, codec, racks, r, events, reentry in cases:
        if (codec, racks) not in bases:
            filling[0] = True
            base = build(dev, codec, racks)
            drive(base)
            bases[(codec, racks)] = bits_of(base)[:3]
            del base
        filling[0] = True
        _zero_counts()
        got = build(dev, codec, racks, r, events)
        err = drive(got, reentry)
        launches[case] = _counts()
        filling[0] = False
        ref = build(cpu, codec, racks, r, events)
        ref_err = drive(ref, reentry)
        if (err, stats_of(got)) != (ref_err, stats_of(ref)) or not same(
                bits_of(ref), bits_of(got)):
            raise AssertionError(f"SMOKE fault {case}: the fabric on {dev} "
                                 f"differs from the CPU's ({err} / {ref_err})")
        if (r == 1) != (err is not None):
            raise AssertionError(f"SMOKE fault {case}: raised {err}")
        lost += err is not None
        if reentry is None and err is None:
            if not same(bases[(codec, racks)], bits_of(got)[:3]):
                raise AssertionError(f"SMOKE fault {case}: the failover "
                                     "differs from the fault-free run")
            if got.stats.failovers != len(events):
                raise AssertionError(f"SMOKE fault {case}: "
                                     f"{got.stats.failovers} failovers")
        del got, ref
    # the sparse tier attached to a replicated fabric, fault-free and not
    table = np.random.default_rng(7).standard_normal((4096, 32)).astype(
        np.float32)
    runs = {}
    for label, d, events in (("base", dev, ()),
                             ("card", dev, [(2, "shard_crash", 1)]),
                             ("cpu", cpu, [(2, "shard_crash", 1)])):
        filling[0] = d != cpu
        _zero_counts()
        fab = build(d, "none", 1, 2, events)
        tier = SparseTier(fabric=fab, codec="int8", lr=0.05)
        tier.add_table("t0", table)
        outs: list = []
        if drive(fab, tier=tier, lookups=outs) is not None:
            raise AssertionError("SMOKE sparse failover raised")
        if label == "card":
            launches["none/racks1/R2/sparse_tier"] = _counts()
        runs[label] = (bits_of(fab)[:3], tier.table("t0").cpu(),
                       tier.row_versions("t0"),
                       dataclasses.asdict(tier.stats), outs,
                       tier.replication, stats_of(fab))
        del fab, tier
    (bb, bt, bv, _, bo, _, _), card, ref = (runs["base"], runs["card"],
                                            runs["cpu"])
    if not (same(card[0], ref[0]) and same_bits(card[1], ref[1])
            and np.array_equal(card[2], ref[2]) and card[3] == ref[3]
            and same(card[4], ref[4]) and card[6] == ref[6]):
        raise AssertionError(f"SMOKE sparse failover: {dev} differs from "
                             "the CPU")
    if not (same(card[0], bb) and same_bits(card[1], bt)
            and np.array_equal(card[2], bv) and same(card[4], bo)):
        raise AssertionError("SMOKE sparse failover differs from its "
                             "fault-free run")
    if card[5] != 2 or card[3]["failovers"] != 1:
        raise AssertionError(f"SMOKE sparse tier stats {card[3]}")
    book.clear()
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    log(f"smoke faults: {len(launches)} cases (codec x R x racks x crash "
        f"round, worker re-entry, a SparseTier failover; 4 workers, "
        f"{SHARDS} shards, {ROUNDS} rounds), {dev} == cpu bitwise in params, "
        f"state, residuals, every stats field and the fault traces; each "
        f"failover == its fault-free run; {lost} ShardLost at R = 1 on both; "
        f"launches on {dev.type} {total}")
    return launches


# -- phases 17 and 18: the tenancy tier ---------------------------------------
TENANT_ROUNDS = 3
# the full-width tenants: name -> (init seed, fair-share priority, the base
# of its batch seeds)
FULL_TENANTS = {"a": (0, 2.0, 0), "b": (1, 1.0, 500_000)}


class Tenant:
    """One gemma3-1b tenant of phase 17: its JobSpec (seeded weights on the
    card, AdamW 3e-3, 2 workers, codec none, R = 1) and a worker gradient
    that is a function of the pulled params and (worker, step) alone, with
    the tenant's own batch seeds."""

    def __init__(self, dev, cfg, name: str):
        import torch

        from repro_torch.core.tenancy import JobSpec
        from repro_torch.models.transformer import init_params
        from repro_torch.optim.optimizers import adamw

        seed, priority, self.batch_base = FULL_TENANTS[name]
        self.dev, self.cfg = dev, cfg
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        self.spec = JobSpec(name=name, params=params, optimizer=adamw(3e-3),
                            num_workers=WORKERS, priority=priority)
        self.losses: list = []

    def grad(self, params: dict, ws: tuple) -> dict:
        import torch

        from repro_torch.data.synthetic import lm_batches
        from repro_torch.models.transformer import lm_loss_and_grad

        w, s = ws
        b = next(lm_batches(self.cfg.vocab, 1, SEQ,
                            seed=self.batch_base + 1000 * (w + 1) + s))
        loss, g = lm_loss_and_grad(
            params, torch.from_numpy(b["tokens"]).to(self.dev),
            torch.from_numpy(b["labels"]).to(self.dev), self.cfg)
        self.losses.append(loss)
        return g

    def harness(self, server, steps_done: int = 0):
        """A WorkerHarness over ``server`` whose workers have done
        ``steps_done`` steps (a re-attached job resumes its batches)."""
        from repro_torch.core.fabric import WorkerHarness

        h = WorkerHarness(server, self.grad, lambda w, s: (w, s))
        h.steps_done = [steps_done] * WORKERS
        return h

    def finite_losses(self) -> list:
        return finite_losses(self.losses)


def tick(harness) -> tuple:
    """One tenant round (each worker pulls, computes and pushes; the last
    push fires the round): (host ms, the round's ``sim_wire_us``)."""
    st = harness.server.stats
    before = st.sim_wire_us
    ms = timed(harness.tick)
    return ms, st.sim_wire_us - before


def slabs(fab) -> list:
    """Each shard's (chunk ids, params, optimizer slots): references to the
    tensors the kernels write, for a comparison on the card."""
    return [(sh.chunk_ids, sh.params, *sh.state) for sh in fab.shards]


def same_slabs(a: list, b: list) -> bool:
    import numpy as np

    return len(a) == len(b) and all(
        np.array_equal(x[0], y[0]) and len(x) == len(y)
        and all(same_bits(p, q) for p, q in zip(x[1:], y[1:]))
        for x, y in zip(a, b))


def tenancy_path(dev) -> dict:
    """Phase 17: two gemma3-1b tenants at full width on one shared box
    (``MultiJobFabric``: 4 shards, 2 racks, 1:4 core), each 2 workers (one
    a rack), AdamW, codec none, R = 1: ``a`` (init seed 0, priority 2) and
    ``b`` (init seed 1, priority 1, its own batch seeds).  Their workers
    interleave tick by tick.  Rounds 1-2 with both attached; ``detach("b")``
    (a host snapshot); ``a``'s round 3 alone; ``a``'s dedicated twin
    (``dedicated_fabric``, 3 rounds, the same batches) is compared with
    ``a``'s slabs on the card; ``b`` re-attaches from its snapshot (its
    namespace [2c, 3c)) and runs its round 3; then the box is released and
    ``b``'s twin compared with ``b``'s slabs.  Checks: 24 box
    ``fused_agg_opt`` launches and no codec launch, 12 each twin; params,
    m, v, losses and pushed / pulled bytes of each tenant equal its twin's;
    a round adds 1.5x ``a``'s dedicated ``sim_wire_us`` and 3.0x ``b``'s
    while both are attached, 1.0x for ``a`` alone (to 1e-12 relative);
    ``a``'s simulated step time under ``b``'s; both tenants on every link
    and every shard; ``route`` of global ids in each namespace.  Times each
    round (host clock around synchronized work), the detach and the
    re-attach, with the peaks."""
    import gc

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import fabric as fabric_mod
    from repro_torch.core.tenancy import MultiJobFabric, dedicated_fabric

    cfg = get_arch("gemma3-1b").config
    name = torch.cuda.get_device_name(dev)
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(dev)  # what earlier phases left
    ta, tb = Tenant(dev, cfg, "a"), Tenant(dev, cfg, "b")
    torch.cuda.empty_cache()
    layout = dict(num_shards=SHARDS, num_racks=RACKS,
                  oversubscription=OVERSUB, device=dev)
    box = MultiJobFabric(**layout)
    memory = PathMemory(dev)
    ha, hb = box.attach(ta.spec), box.attach(tb.spec)
    c = ha.space.num_chunks
    harnesses = {"a": ta.harness(ha), "b": tb.harness(hb)}
    shared_ms = {"a": [], "b": []}
    wire = {"a": [], "b": []}
    _zero_counts()  # the box's counts to 0 just before its rounds...
    for _ in range(2):
        for label in ("a", "b"):
            ms, us = tick(harnesses[label])
            shared_ms[label].append(ms)
            wire[label].append(us)
    space_b, steps_b = hb.space, harnesses["b"].steps_done[0]
    stats_b = dataclasses.replace(hb.stats)
    snap_b: dict = {}
    detach_ms = timed(lambda: snap_b.update(box.detach("b")))
    snap_bytes = snap_b["params"].nbytes + sum(s.nbytes
                                               for s in snap_b["state"])
    # nothing may keep b's detached fabric: its slabs leave the card here
    del hb, harnesses["b"]
    gc.collect()
    torch.cuda.empty_cache()
    wa = harnesses.pop("a")
    ms, us = tick(wa)
    shared_ms["a"].append(ms)
    wire["a"].append(us)
    launches = _counts()  # ...read before a's twin...
    peak_shared = memory.now()[1]
    scales_alone = box.wire_scales(ha.fabric)

    def twin(t, steps):
        """``t``'s dedicated fabric (the box's layout, no co-tenant), run
        ``steps`` rounds: the fabric, its launches, round times, wire
        increments and peak."""
        mem = PathMemory(dev)
        ded = dedicated_fabric(t.spec, MultiJobFabric(**layout))
        h = t.harness(ded)
        _zero_counts()
        rounds = [tick(h) for _ in range(steps)]
        return (ded, _counts(), [r[0] for r in rounds],
                [r[1] for r in rounds], mem.now()[1])

    ded_a, twin_a_launches, ded_ms_a, ded_wire_a, peak_twin_a = twin(
        ta, TENANT_ROUNDS)
    losses_a = ta.finite_losses()
    same_a = same_slabs(slabs(ha.fabric), slabs(ded_a))
    bytes_a = [(f.stats.bytes_pushed, f.stats.bytes_pulled)
               for f in (ha.fabric, ded_a)]
    del ded_a
    torch.cuda.empty_cache()

    restore_ms: list = []
    restore = fabric_mod.PBoxFabric.restore

    def timed_restore(fab, snap):
        restore_ms.append(timed(lambda: restore(fab, snap)))

    memory = PathMemory(dev)
    fabric_mod.PBoxFabric.restore = timed_restore
    try:
        attach_ms = timed(lambda: box.attach(tb.spec, snapshot=snap_b,
                                             snapshot_space=space_b))
    finally:
        fabric_mod.PBoxFabric.restore = restore
    hb = box.jobs["b"]
    wb = tb.harness(hb, steps_b)
    _zero_counts()  # ...and to 0 again for b's round 3, read just after
    ms, us = tick(wb)
    launches = {k: v + _counts()[k] for k, v in launches.items()}
    shared_ms["b"].append(ms)
    wire["b"].append(us)
    peak_shared = max(peak_shared, memory.now()[1])
    util, occupancy = box.utilization(), box.shard_occupancy()
    per_shard = c // SHARDS
    routes = {g: box.route(g) for g in (0, c // 2, c - 1, 2 * c,
                                        2 * c + c // 2 + 1, 3 * c - 1)}
    want_routes = {g: (("a" if g < c else "b"),
                       (g - (0 if g < c else 2 * c)) // per_shard)
                   for g in routes}
    stale_route = None
    try:
        box.route(c)  # b's first range: never reused, now unrouted
    except KeyError as e:
        stale_route = str(e)
    step_us = (ha.sim_step_time_us(), hb.sim_step_time_us())
    chunk_base_b = hb.chunk_base
    describe = box.describe()
    final_b = slabs(hb.fabric)
    bytes_b = (stats_b.bytes_pushed + hb.stats.bytes_pushed,
               stats_b.bytes_pulled + hb.stats.bytes_pulled)
    # release the box (and a's slabs and weights with it): only b's final
    # slabs stay
    del ha, hb, wa, wb, box, ta
    gc.collect()
    torch.cuda.empty_cache()
    ded_b, twin_b_launches, ded_ms_b, ded_wire_b, peak_twin_b = twin(
        tb, TENANT_ROUNDS)
    losses_b = tb.finite_losses()
    same_b = same_slabs(final_b, slabs(ded_b))
    bytes_b = [bytes_b, (ded_b.stats.bytes_pushed, ded_b.stats.bytes_pulled)]
    del ded_b, final_b, tb, snap_b
    gc.collect()
    torch.cuda.empty_cache()

    log(f"tenancy path: {cfg.name} x 2 tenants on one MultiJobFabric "
        f"({SHARDS} shards, {RACKS} racks, core 1:{OVERSUB:g}), each "
        f"{WORKERS} workers (one a rack), AdamW, codec none, R = 1; a "
        f"(seed 0, priority 2), b (seed 1, priority 1); c = {c} chunks a "
        f"tenant; {resident} bytes allocated before the phase")
    log(f"  round wall ms, shared box: a {[round(x, 1) for x in shared_ms['a']]}"
        f" (round 3 alone), b {[round(x, 1) for x in shared_ms['b']]} (round "
        f"3 re-attached); dedicated: a {[round(x, 1) for x in ded_ms_a]}, b "
        f"{[round(x, 1) for x in ded_ms_b]} ({name})")
    log(f"  detach b (D2H snapshot of {snap_bytes} bytes) {detach_ms:.1f} ms;"
        f" re-attach b {attach_ms:.1f} ms, of which the restore (H2D) "
        f"{restore_ms[0]:.1f} ms; b's namespace [{chunk_base_b}, "
        f"{chunk_base_b + c})")
    log(f"  peak device memory: shared run {peak_shared} bytes "
        f"({peak_shared / 2**30:.2f} GiB), a's twin {peak_twin_a} "
        f"({peak_twin_a / 2**30:.2f} GiB, a's shared slabs resident), b's "
        f"twin {peak_twin_b} ({peak_twin_b / 2**30:.2f} GiB, b's final slabs "
        f"resident)")
    log(f"  launches: box {launches}, twins {twin_a_launches} / "
        f"{twin_b_launches}; losses a {losses_a[-WORKERS:]}, b "
        f"{losses_b[-WORKERS:]} (last round)")
    log(f"  sim_wire_us a round, shared / dedicated: a "
        f"{[x / y for x, y in zip(wire['a'], ded_wire_a)]}, b "
        f"{[x / y for x, y in zip(wire['b'], ded_wire_b)]}; sim step us a "
        f"{step_us[0]:.1f} < b {step_us[1]:.1f}; contention "
        + ", ".join(f"{k} x{v['contention_factor']:.3f}"
                    for k, v in util.items()))

    _check_counts("tenancy box", launches,
                  {"fused_agg_opt": 2 * SHARDS * TENANT_ROUNDS})
    _check_counts("tenancy twin a", twin_a_launches,
                  {"fused_agg_opt": SHARDS * TENANT_ROUNDS})
    _check_counts("tenancy twin b", twin_b_launches,
                  {"fused_agg_opt": SHARDS * TENANT_ROUNDS})
    if not (same_a and same_b):
        raise AssertionError(f"tenancy: a shared tenant differs from its "
                             f"dedicated twin (a {same_a}, b {same_b})")
    for label, losses in (("a", losses_a), ("b", losses_b)):
        half = WORKERS * TENANT_ROUNDS
        if len(losses) != 2 * half or losses[:half] != losses[half:]:
            raise AssertionError(f"tenant {label}: shared losses "
                                 f"{losses[:half]}, twin's {losses[half:]}")
    if bytes_a[0] != bytes_a[1] or bytes_b[0] != bytes_b[1]:
        raise AssertionError(f"tenancy bytes (pushed, pulled) a {bytes_a}, "
                             f"b {bytes_b}")
    want = {"a": [1.5, 1.5, 1.0], "b": [3.0, 3.0, 3.0]}
    for label, ded in (("a", ded_wire_a), ("b", ded_wire_b)):
        for got, base, k in zip(wire[label], ded, want[label]):
            if abs(got - k * base) > 1e-12 * k * base:
                raise AssertionError(
                    f"tenant {label}: sim_wire_us {wire[label]} against the "
                    f"twin's {ded}, expected x{want[label]}")
    if scales_alone != (1.0, 1.0) or not step_us[0] < step_us[1]:
        raise AssertionError(f"fair share: a alone {scales_alone}, sim step "
                             f"us {step_us}")
    for link in [f"rack{r}" for r in range(RACKS)] + ["core"]:
        u = util[link]
        if set(u["by_job"]) != {"a", "b"} or not u["contention_factor"] > 1:
            raise AssertionError(f"tenancy link {link}: {u}")
    if occupancy != [{"a": per_shard, "b": per_shard}] * SHARDS:
        raise AssertionError(f"tenancy shard occupancy {occupancy}")
    if routes != want_routes or stale_route is None or chunk_base_b != 2 * c:
        raise AssertionError(f"tenancy routes {routes} (want {want_routes}), "
                             f"stale {stale_route}, b at {chunk_base_b}")
    log(f"  a == its dedicated twin and b == its twin bitwise (params, m, v)"
        f" across b's detach and re-attach; losses and bytes equal; "
        f"fair-share x1.5 / x3.0 / x1.0 exact; both tenants on "
        f"{sorted(util)} and on every shard ({per_shard} chunks each); "
        f"routes {routes}")
    log("  " + describe.replace("\n", "\n  "))
    return {"launches": launches, "shared_ms": shared_ms, "dedicated_ms": {"a": ded_ms_a,
                                                     "b": ded_ms_b},
            "detach_ms": detach_ms, "attach_ms": attach_ms,
            "snapshot_bytes": snap_bytes,
            "restore_ms": restore_ms[0], "peak_shared": peak_shared,
            "peak_twin_a": peak_twin_a, "peak_twin_b": peak_twin_b,
            "twin_launches": {k: twin_a_launches[k] + twin_b_launches[k]
                              for k in twin_a_launches}}


def _residuals(fab) -> list:
    """Every codec error-feedback residual of ``fab`` (None where a stage
    keeps none), in a fixed order: rack uplinks, the core, the rack-side
    worker NICs, the fabric's worker NICs."""
    return ([r._uplink_ef for r in fab.rack_aggs] + [fab._core_ef]
            + [r._worker_ef[w] for r in fab.rack_aggs for w in r.members]
            + [fab._worker_ef[w] for w in sorted(fab._worker_ef)])


class PlainCalls:
    """Counts the calls of each kernel's plain version while the block
    runs (module attributes, swapped in and restored): what a CPU run
    does in place of the card's launches."""

    NAMES = {"fused_agg_opt": ("fused_agg_opt", "fused_agg_opt_torch"),
             "quantize_chunks": ("quant", "quantize_chunks_torch"),
             "dequantize_chunks": ("quant", "dequantize_chunks_torch"),
             "wire_fused": ("wire_path", "wire_fused_torch"),
             "embedding_bag": ("embedding_bag", "embedding_bag_torch"),
             "segment_sum": ("embedding_bag", "segment_sum_torch")}

    def __enter__(self):
        import importlib

        self.counts = {k: 0 for k in _counts()}
        self.saved = []
        for key, (pkg, attr) in self.NAMES.items():
            mod = importlib.import_module(f"repro_torch.kernels.{pkg}.kernel")
            fn = getattr(mod, attr)

            def counted(*a, fn=fn, key=key, **kw):
                self.counts[key] += 1
                return fn(*a, **kw)

            self.saved.append((mod, attr, fn))
            setattr(mod, attr, counted)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def smoke_tenancy_check(dev) -> dict:
    """Phase 18: the tenancy tier at gemma3-1b's SMOKE config, each box on
    ``dev`` against the same box on the CPU, bitwise in every tenant's
    params, state and residuals, every ServerStats / ShardStats /
    RackStats / SwitchStats field, the fault traces, and the box's
    ``utilization()``, ``shard_occupancy()``, routes, telemetry and
    ``describe()``.  Cases: 1 and 3 tenants (2 workers each; seeds,
    optimizers and priorities differ) x shards (1, 4) x racks (1, 2) x
    codec (none, bf16, int8); a sync, a 3-of-4 quorum and an SSP tenant
    (4 workers each, 4 shards, 2 racks); int8 tenants under switch pools
    of one tenant's chunk count (the first granted, the second refused,
    the grant returned at detach and handed to the next attach); a
    box-wide ``crash_shard`` with an R = 1 tenant attached before an R = 2
    one (``ShardLost`` raised after the R = 2 tenant's failover); a detach
    from a 4-shard box re-attached onto a 3-shard one through
    ``elastic_restore``; ``apply_tenant_shares`` and a ``tenant_shares``
    plan delta in mid-run.  Each tenant also equals its
    ``dedicated_fabric`` twin on the card.  Gradients are booked on the
    card by (tenant, worker, step, digest of the pulled params) and
    replayed on the CPU, as in phases 14 and 16; the card's launches of
    each case must equal the CPU run's calls of the plain versions.
    Returns each case's launches on ``dev``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.fabric import WorkerHarness
    from repro_torch.core.placement import PlanDelta
    from repro_torch.core.replication import ShardLost
    from repro_torch.core.tenancy import (
        JobSpec,
        MultiJobFabric,
        dedicated_fabric,
    )
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models.transformer import init_params, lm_loss_and_grad
    from repro_torch.optim.optimizers import adamw, momentum, sgd

    cfg = get_arch("gemma3-1b").smoke_config
    trees = [init_params(cfg, torch.Generator().manual_seed(seed))
             for seed in range(3)]
    flat_space = ParamSpace.build(trees[0], chunk_elems=4096)
    optimizers = (adamw(3e-3), momentum(0.05, 0.9), sgd(0.01))
    cpu = torch.device("cpu")
    book: dict = {}
    filling = [True]  # the card runs fill the book, the CPU runs read it

    def grad(tenant, seed, params, ws):
        w, s = ws
        flat = flat_space.flatten(params)
        key = (tenant, w, s,
               hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest())
        if key not in book:
            if not filling[0]:
                raise AssertionError(
                    f"the CPU box pulled params for tenant {tenant} worker "
                    f"{w} step {s} that the card box never pulled")
            b = next(lm_batches(cfg.vocab, 4, 32,
                                seed=100_000 * seed + 1000 * (w + 1) + s))
            _, g = lm_loss_and_grad(
                params, torch.from_numpy(b["tokens"]).to(flat.device),
                torch.from_numpy(b["labels"]).to(flat.device), cfg)
            book[key] = flat_space.flatten(g).cpu()
        return flat_space.unflatten(book[key].to(flat.device))

    def spec(name, seed, *, workers=2, opt=0, **kw):
        return JobSpec(name=name, params=trees[seed],
                       optimizer=optimizers[opt], num_workers=workers,
                       chunk_elems=4096, **kw)

    def harness(h, seed, steps_done=0, name=None):
        """A harness over tenant handle ``h`` (or a twin fabric of tenant
        ``name``) whose workers have done ``steps_done`` steps."""
        name = name or h.namespace
        wh = WorkerHarness(h, lambda p, ws: grad(name, seed, p, ws),
                           lambda w, s: (w, s))
        wh.steps_done = [steps_done] * h.num_workers
        return wh

    def drive(pairs, steps):
        """Interleave the tenants' harnesses tick by tick (as
        tests/test_tenancy.py's ``drive``); returns the harnesses."""
        hs = [harness(h, seed) for h, seed in pairs]
        for _ in range(steps * 100):
            if all(min(w.steps_done) >= steps for w in hs):
                return hs
            for w in hs:
                if min(w.steps_done) < steps:
                    w.tick()
        raise AssertionError("tenant scheduler livelock")

    def fab_bits(fab):
        efs = _residuals(fab)
        return ([fab.params.cpu()]
                + [fab._assemble_rows(lambda sh, k=k: sh.state[k]).reshape(
                    -1).cpu() for k in range(fab.spec.num_state_slots)]
                + [None if e is None else e.cpu() for e in efs])

    def fab_stats(fab):
        return (dataclasses.asdict(fab.stats),
                [dataclasses.asdict(sh.stats) for sh in fab.shards],
                [dataclasses.asdict(r.stats) for r in fab.rack_aggs],
                [dataclasses.asdict(r.switch.stats) if r.switch else None
                 for r in fab.rack_aggs],
                dataclasses.asdict(fab.core_switch.stats)
                if fab.core_switch else None,
                fab.fault_trace, fab.export_fault_trace(),
                sorted(fab.dead_workers), fab.worker_clock.tolist(),
                fab.chunk_owner.tolist(), fab.step)

    def twin_same(fab, ded):
        """A tenant against its twin: every bit, or, across an elastic
        re-target (the flat spaces pad differently), params and state over
        the payload."""
        a, b = fab_bits(fab), fab_bits(ded)
        if fab.space.flat_elems != ded.space.flat_elems:
            n, k = fab.space.payload_elems, 1 + fab.spec.num_state_slots
            a, b = [x[:n] for x in a[:k]], [y[:n] for y in b[:k]]
        return len(a) == len(b) and all(
            (x is None and y is None) or (
                x is not None and y is not None and same_bits(x, y))
            for x, y in zip(a, b))

    def box_state(b):
        """(every comparable view and counter, every tenant's bits)."""
        views, bits = [], []
        for h in b.jobs.values():
            g = h.global_chunks()
            views.append((h.name, h.chunk_base, h.telemetry(),
                          fab_stats(h.fabric),
                          [b.route(int(x)) for x in g[::7]]))
            bits += fab_bits(h.fabric)
        views.append((b.utilization(), b.shard_occupancy(), b.describe(),
                      dataclasses.asdict(b.aggregate_stats()),
                      {n: dataclasses.astuple(s)
                       for n, s in b.switch_grants.items()},
                      b._tor_slots_left, b._core_slots_left, b.rounds,
                      b._next_chunk_base))
        return views, bits

    def sweep_case(n, shards, racks, codec):
        def run(d):
            box = MultiJobFabric(num_shards=shards, num_racks=racks,
                                 device=d)
            handles = [box.attach(spec(f"t{i}", i, opt=i, codec=codec,
                                       priority=float(i + 1)))
                       for i in range(n)]
            twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS)
                     for i, h in enumerate(handles)]
            drive([(h, i) for i, h in enumerate(handles)], ROUNDS)
            return [box], twins, []
        return run

    def mix_case(d):
        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        specs = [spec("sync", 0, workers=4),
                 spec("quorum", 1, workers=4, opt=2, min_push_fraction=0.75),
                 spec("ssp", 2, workers=4, opt=1, mode="stale",
                      staleness=2)]
        handles = [box.attach(s) for s in specs]
        twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS + 1)
                 for i, h in enumerate(handles)]
        drive([(h, i) for i, h in enumerate(handles)], ROUNDS + 1)
        return [box], twins, []

    def grant_case(d):
        chunks = ParamSpace.build(trees[0], chunk_elems=4096,
                                  num_owners=SHARDS).num_chunks
        from repro_torch.core.config import SwitchConfig

        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d,
                             switch=SwitchConfig(enabled=True,
                                                 tor_slots=chunks,
                                                 core_slots=chunks))
        h1 = box.attach(spec("g1", 0, codec="int8"))
        h2 = box.attach(spec("g2", 1, codec="int8", opt=1))
        events = [sorted(box.switch_grants)]
        twins = [(h1, dedicated_fabric(h1.spec, box), 0, ROUNDS),
                 (h2, dedicated_fabric(h2.spec, box), 1, ROUNDS)]
        drive([(h1, 0), (h2, 1)], ROUNDS)
        box.detach("g1")
        events.append((box._tor_slots_left, box._core_slots_left))
        h3 = box.attach(spec("g3", 2, codec="int8", opt=2))
        events.append(sorted(box.switch_grants))
        twins.append((h3, dedicated_fabric(h3.spec, box), 2, ROUNDS))
        drive([(h3, 2)], ROUNDS)
        events.append([h.stats.switch_rounds for h in (h1, h2, h3)])
        return [box], twins, events

    def crash_case(d):
        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        h1 = box.attach(spec("r1", 0, codec="int8"))
        h2 = box.attach(spec("r2", 1, replication=2, opt=1))
        twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS)
                 for i, h in enumerate((h1, h2))]
        hs = drive([(h1, 0), (h2, 1)], ROUNDS - 1)
        err = None
        try:
            box.crash_shard(1)
        except ShardLost as e:
            err = f"{type(e).__name__}: {e}"
        events = [err, h1.stats.shards_crashed, h2.stats.failovers]
        for w in hs:  # every tenant trains on after the crash
            w.run(ROUNDS)
        return [box], twins, events

    def elastic_case(d):
        box4 = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        # codec none: a snapshot carries no error-feedback residual, so
        # only the raw wire resumes exactly as the uninterrupted twin
        h4 = box4.attach(spec("mig", 0))
        ded = dedicated_fabric(h4.spec, box4)
        drive([(h4, 0)], ROUNDS - 1)
        space4 = h4.space
        snap = box4.detach("mig")
        box3 = MultiJobFabric(num_shards=3, num_racks=RACKS, device=d)
        h3 = box3.attach(h4.spec, snapshot=snap, snapshot_space=space4)
        events = [space4.flat_elems, h3.space.flat_elems, h3.step]
        harness(h3, 0, ROUNDS - 1).run(ROUNDS)
        return [box4, box3], [(h3, ded, 0, ROUNDS)], events

    def shares_case(d):
        box = MultiJobFabric(num_shards=SHARDS, num_racks=RACKS, device=d)
        handles = [box.attach(spec("s0", 0, priority=2.0)),
                   box.attach(spec("s1", 1, opt=1, bandwidth_cap=0.5))]
        twins = [(h, dedicated_fabric(h.spec, box), i, ROUNDS + 1)
                 for i, h in enumerate(handles)]
        hs = drive([(h, i) for i, h in enumerate(handles)], 1)
        events = [box.apply_tenant_shares({"s0": 1.0, "s1": 4.0, "gone": 2})]
        for w in hs:
            w.run(2)
        events.append(box.apply_plan_delta(
            PlanDelta(kind="tenant_shares", shares=(("s0", 8.0),))))
        for w in hs:
            w.run(ROUNDS + 1)
        events.append([box.wire_scales(h.fabric) for h in handles])
        return [box], twins, events

    # 1 and 3 tenants (2 was cut for the script's time)
    cases = [(f"{n}t/shards{s}/racks{r}/{codec}", sweep_case(n, s, r, codec))
             for n in (1, 3) for s in (1, SHARDS) for r in (1, RACKS)
             for codec in ("none", "bf16", "int8")]
    cases += [("mix/sync+quorum+ssp", mix_case),
              ("switch/grant+refuse+return", grant_case),
              ("box_crash/R1+R2", crash_case),
              ("elastic/4->3_shards", elastic_case),
              ("tenant_shares/mid_run", shares_case)]
    launches: dict = {}
    special: dict = {}
    for case, run in cases:
        book.clear()
        filling[0] = True
        _zero_counts()
        boxes, twins, events = run(dev)
        launches[case] = _counts()
        got = [box_state(b) for b in boxes]
        for h, ded, seed, steps in twins:
            harness(ded, seed, name=h.name).run(steps)
            if not twin_same(h.fabric, ded):
                raise AssertionError(f"SMOKE tenancy {case}: tenant "
                                     f"{h.name} differs from its dedicated "
                                     "twin on the card")
        del boxes, twins
        filling[0] = False
        with PlainCalls() as plain:
            ref_boxes, _, ref_events = run(cpu)
        ref = [box_state(b) for b in ref_boxes]
        del ref_boxes
        if plain.counts != launches[case]:
            raise AssertionError(f"SMOKE tenancy {case}: launches "
                                 f"{launches[case]}, the CPU run's plain "
                                 f"calls {plain.counts}")
        if events != ref_events or [v for v, _ in got] != [v for v, _ in ref]:
            raise AssertionError(f"SMOKE tenancy {case}: the box on {dev} "
                                 f"differs from the CPU's ({events} / "
                                 f"{ref_events})")
        for (_, a), (_, b) in zip(got, ref):
            if len(a) != len(b) or not all(
                    (x is None and y is None) or (
                        x is not None and y is not None and same_bits(x, y))
                    for x, y in zip(a, b)):
                raise AssertionError(f"SMOKE tenancy {case}: tenant bits on "
                                     f"{dev} differ from the CPU's")
        if events:
            special[case] = events
    book.clear()
    grants, crash, elastic, shares = (special[k] for k in (
        "switch/grant+refuse+return", "box_crash/R1+R2",
        "elastic/4->3_shards", "tenant_shares/mid_run"))
    chunks = ParamSpace.build(trees[0], chunk_elems=4096,
                              num_owners=SHARDS).num_chunks
    if grants != [["g1"], (chunks, chunks), ["g3"], [ROUNDS, 0, ROUNDS]]:
        raise AssertionError(f"SMOKE tenancy switch grants {grants}")
    if not (crash[0] and crash[0].startswith("ShardLost")
            and crash[1:] == [1, 1]):
        raise AssertionError(f"SMOKE tenancy box crash {crash}")
    if elastic[0] == elastic[1] or elastic[2] != ROUNDS - 1:
        raise AssertionError(f"SMOKE tenancy elastic re-target {elastic}")
    if shares != [2, 1, [(1.5, 1.5), (3.0, 3.0)]]:
        raise AssertionError(f"SMOKE tenancy shares {shares}")
    total = {k: sum(c[k] for c in launches.values())
             for k in next(iter(launches.values()))}
    log(f"smoke tenancy: {len(launches)} cases (1 and 3 tenants x shards x "
        f"racks x codec; sync + quorum + SSP; switch grants; a box-wide "
        f"crash; an elastic re-attach; tenant shares), {dev} == cpu bitwise "
        f"in every tenant's bits, every stats field, the fault traces and "
        f"the box's views; each tenant == its dedicated twin on {dev.type}; "
        f"launches == the CPU run's plain calls, on {dev.type} {total}; "
        f"grants {grants}; crash {crash}; elastic {elastic}; shares {shares}")
    return launches


def profile_summary(prof, steady_round_ms: float, last_launches,
                    kernel_name: str, kernel_key: str = "") -> dict:
    """Print where the profiled round's time went: host time per labelled
    phase, device busy time (the union of kernel, copy and fill intervals)
    against the unprofiled round's wall time, and the top kernels.  The
    named kernel's time is its CUDA events (``last_launches``), or, with
    ``last_launches`` None, the profiler's records of kernels whose name
    holds ``kernel_key``."""
    from torch.autograd import DeviceType

    averages = prof.key_averages()  # builds the event tree: once
    for e in averages:
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            log(f"    host   {e.cpu_time_total / 1e3:9.2f} ms  x{e.count:<5d} "
                f"{e.key} (wall time inside the range, profiler on)")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if _on_device(e))
    busy_us, reach = 0.0, float("-inf")
    for start, end in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    if busy_us <= 0:
        log("  profiler: no device time recorded (not measured)")
        return {"device_busy_ms": None, "top_ops": []}
    kernel_us = (sum(e.self_device_time_total for e in averages
                     if _on_device(e) and kernel_key in e.key)
                 if last_launches is None else
                 sum(s.elapsed_time(e) for s, e in last_launches) * 1e3)
    log(f"  profiled round: device busy {busy_us / 1e3:.1f} ms = "
        f"{busy_us / 1e3 / steady_round_ms:.1%} of the unprofiled round "
        f"({steady_round_ms:.1f} ms), idle "
        f"{1 - busy_us / 1e3 / steady_round_ms:.1%}; {kernel_name} "
        f"{kernel_us / 1e3:.1f} ms = {kernel_us / busy_us:.1%} of device time")
    kernels = sorted((e for e in averages if _on_device(e)),
                     key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:20]:
        log(f"    device {e.self_device_time_total / 1e3:9.2f} ms  "
            f"x{e.count:<5d} {e.key[:100]}")
    return {"device_busy_ms": busy_us / 1e3,
            "top_ops": [(e.key[:80], round(e.self_device_time_total / 1e3, 3),
                         e.count) for e in kernels[:5]]}


# -- phases 20 to 22: the serving path -----------------------------------------
# the full-width serve run: the CLI's arguments (launch/serve.py), gemma3-1b
# at its published config through a 4-shard, 2-rack (1:4 core), R = 2 fabric
SERVE_ARGV = ["--arch", "gemma3-1b", "--source", "fabric", "--train-rounds",
              "1", "--serve-shards", str(SHARDS), "--serve-racks", "2",
              "--serve-replication", "2", "--serve-workers", str(WORKERS),
              "--batch", "4", "--prompt-len", str(SEQ), "--tokens", "32",
              "--max-staleness", "1", "--seed", "0"]
# decode against a forward of the longer sequence, and the unrolled
# (rolling window) decode against the scan decode, in bf16: the largest
# logit difference over the largest |logit|.  At the SMOKE config in bf16
# (4 layers, d=64, window 8, prompts of 24 tokens, 8 steps, 3 seeds) both
# differences stay within 1.64 % of the largest logit (0.0088-0.0107 of
# 0.64-0.66: 2-3 bf16 ulps), from bf16 rounding in matmuls of other shapes;
# full width stacks 6.5x the layers, so the bound is 3x that, 5 %.
SERVE_LOGIT_TOL = 0.05
# the same checks card against CPU at the SMOKE config in f32: cuBLAS and
# the CPU BLAS sum in other orders (f32 logits of order 1)
SMOKE_LOGIT_TOL = 1e-4


def rel_logit_err(a, b) -> float:
    """Largest |a - b| over the largest |b| (f32 logits, any shape)."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _digest(t) -> str:
    return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()


def serve_path(dev) -> dict:
    """Phase 20: gemma3-1b served at full width through ``launch/serve.py``'s
    body (``serve(arch.config, args)``): one round of the CLI's synthetic
    training (each gradient drawn on the card from the CLI's seeded
    stream, in place of its host float64 numpy draw), a ``max_staleness=1``
    read from the R = 2 chain tails, a prefill of 4 x 1024 tokens and 31
    greedy decode steps (32 tokens).  Counts set to 0 just before the call
    and read just after: 4 fused_agg_opt, no codec launch.  Then a round of
    gradients drawn on the card, the cached read served again (still version
    1's bits) and a ``max_staleness=0`` read (version 2's).  The scan decode
    is held against a forward of the 1,055-token sequence and the unrolled
    decode (rolling 512-slot caches seeded from the prefill's) against the
    scan decode, at SERVE_LOGIT_TOL; ``assemble``, a miss, a hit, the prefill and a decode
    step are timed.  Then ``--source checkpoint`` (no training round:
    saved at round 0 and served back through a SnapshotSource)."""
    import shutil
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.config import ServeConfig
    from repro_torch.core.serving import FabricSource, ReadPlane
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T

    cfg = get_arch("gemma3-1b").config
    args = S.build_argparser().parse_args(SERVE_ARGV)
    memory = PathMemory(dev)

    def card_draw(rng, n: int, device):
        # the CLI round's gradient drawn on the card from the CLI's seeded
        # stream (its host float64 draws took ~60 s of the phase)
        gen = torch.Generator(device=device).manual_seed(
            int(rng.integers(2**62)))
        return 1e-3 * torch.randn(n, generator=gen, device=device)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _zero_counts()  # every count to 0 just before the path...
    with mock.patch.object(S, "_draw_grad", card_draw):
        out = S.serve(cfg, args, device=dev)
    torch.cuda.synchronize()
    launches = _counts()  # ...and read just after
    cli_s = time.perf_counter() - t0
    _check_counts("serve path", launches, {"fused_agg_opt": SHARDS})
    fabric, plane, params = out["fabric"], out["plane"], out["params"]
    info = out["read"]
    if (info["version"], info["staleness"], info["replication"],
            info["shards"]) != (1, 0, 2, SHARDS):
        raise AssertionError(f"serve read provenance {info}")
    v1 = plane.frontends[0].flat
    if not same_bits(v1, fabric.params):
        raise AssertionError("the served read is not fabric.params' bits")
    v1_copy = v1.clone()
    v1_sha = _digest(v1)
    gen = out["generated"]
    if gen.shape != (args.batch, args.tokens) or not ((gen >= 0) & (gen < cfg.vocab)).all():
        raise AssertionError(f"generated ids {gen.shape} out of range")
    topo = fabric.topology
    if topo is None or topo.num_racks != 2:
        raise AssertionError(f"the serve fabric's topology is {topo}, not "
                             "the CLI's 2 racks")
    n = fabric.space.flat_elems
    log(f"serve path: {cfg.name} full width, flat {n} (N params "
        f"{cfg.param_count()}), {SHARDS} shards over {topo.num_racks} racks "
        f"(1:{topo.oversubscription:g} core), "
        f"R = 2, 1 CLI round in {cli_s:.1f} s ({fabric.num_workers} x {n}"
        " normals drawn on the card); launches "
        f"{launches}; "
        f"CLI prefill {out['prefill_ms']:.1f} ms, decode "
        f"{out['decode_ms']:.1f} ms for {args.tokens - 1} steps (host "
        "clock)")
    log("  " + plane.describe())

    # round 2 with card-drawn gradients; the cached read must not move
    g = torch.Generator(device=dev).manual_seed(7)
    _zero_counts()
    for w in range(fabric.num_workers):
        fabric.pull(w)
    for w in range(fabric.num_workers):
        fabric.push(w, 1e-3 * torch.randn(n, generator=g, device=dev))
    torch.cuda.synchronize()
    _check_counts("serve round 2", _counts(), {"fused_agg_opt": SHARDS})
    hit = plane.read(0)
    if not (hit.cache_hit and hit.version == 1 and hit.staleness == 1):
        raise AssertionError(f"max_staleness=1 read after round 2: {hit}")
    if not same_bits(hit.flat, v1_copy) or _digest(hit.flat) != v1_sha:
        raise AssertionError("the cached read lost version 1's bits")
    if same_bits(hit.flat, fabric.params):
        raise AssertionError("round 2 did not change the params")
    fresh_plane = ReadPlane(fabric, config=ServeConfig(max_staleness=0))
    fresh = fresh_plane.read(0)
    if fresh.cache_hit or fresh.version != 2 or not same_bits(
            fresh.flat, fabric.params):
        raise AssertionError(f"max_staleness=0 read: {fresh}")
    del v1_copy, hit, fresh, fresh_plane
    # read-side times: the tails assembled (CUDA events), a miss and a
    # batch of 4 hits (host clock around synchronized work)
    source = FabricSource(fabric)
    assemble_ms = [cuda_ms(source.assemble, 1) for _ in range(3)]

    def miss():
        ReadPlane(fabric, config=ServeConfig(max_staleness=1)).read_batch(
            0, 4)

    miss_ms = [timed(miss) for _ in range(3)]
    hit_ms = [timed(lambda: plane.read_batch(0, 4)) for _ in range(5)]
    sim_us = plane.stats.sim_serve_us
    # decode checks and times on the served params
    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)).to(dev)
    ids = torch.from_numpy(gen.astype(np.int32)).to(dev)
    max_seq = args.prompt_len + args.tokens
    with torch.no_grad():
        nxt, cache = T.prefill(params, prompts, cfg, max_seq)
        if not torch.equal(nxt, ids[:, 0]):
            raise AssertionError("prefill disagrees with the CLI's prefill")
        scan = []
        for i in range(args.tokens - 1):
            x = T.decode_hidden(params, ids[:, i], cache, SEQ + i, cfg)
            scan.append(T.head_logits(params, x, cfg))
            if not torch.equal(scan[-1].argmax(-1).int(), ids[:, i + 1]):
                raise AssertionError(f"decode step {i} disagrees with the "
                                     "CLI's")
        seq = torch.cat([prompts, ids[:, :-1]], dim=1)  # 1,055 tokens
        hidden, _ = T.forward(params, seq, cfg)
        fwd = [T.head_logits(params, hidden[:, SEQ + i], cfg)
               for i in range(args.tokens - 1)]
        del hidden
        decode_err = max(rel_logit_err(a, b) for a, b in zip(scan, fwd))
        decode_ids = sum(int(torch.equal(a.argmax(-1), b.argmax(-1)))
                         for a, b in zip(scan, fwd))
        # the unrolled decode over the same history: its caches seeded from
        # the prefill's (global layers: positions 0..1023; local layers:
        # the last 512, position p in slot p % 512), then the 31 generated
        # tokens decoded through it (a replay of all 1,055 steps through
        # the eager unrolled path takes ~40 s; phase 22 and the CPU tests
        # replay from position 0)
        caches = T.init_cache_unrolled(cfg, args.batch, max_seq, device=dev)
        for li, layer in enumerate(caches):
            w = layer["k"].shape[1]
            pos = torch.arange(max(0, SEQ - w), SEQ, device=dev)
            slots = pos if cfg.is_global_layer(li) else pos % w
            for key in ("k", "v"):
                layer[key][:, slots] = cache[key][li][:, pos]
        t0 = time.perf_counter()
        unrolled = []
        for i in range(args.tokens - 1):
            x = T.decode_hidden_unrolled(params, ids[:, i], caches, SEQ + i,
                                         cfg)
            unrolled.append(T.head_logits(params, x, cfg))
        torch.cuda.synchronize()
        unrolled_s = time.perf_counter() - t0
        unrolled_err = max(rel_logit_err(a, b)
                           for a, b in zip(unrolled, scan))
        for name, err in (("decode vs forward", decode_err),
                          ("unrolled vs scan decode", unrolled_err)):
            if not err <= SERVE_LOGIT_TOL:
                raise AssertionError(f"{name}: logits differ by {err:.4f} of"
                                     f" the largest, over {SERVE_LOGIT_TOL}")
        prefill_ms = [cuda_ms(lambda: T.prefill(params, prompts, cfg,
                                                max_seq), 1)
                      for _ in range(3)]
        step_ms = [cuda_ms(lambda: T.decode_step(params, ids[:, 5], cache,
                                                 SEQ + 5, cfg), 1)
                   for _ in range(10)]
        del cache, caches, scan, fwd, unrolled
    peak = memory.now()[1]
    log(f"  round-2 checks: cached read (staleness 1) == version 1 (SHA-1 "
        f"{v1_sha[:12]}), fresh read == version 2; assemble "
        f"{[round(x, 3) for x in assemble_ms]} ms (CUDA events), miss "
        f"{[round(x, 2) for x in miss_ms]} ms, hit (batch of 4) "
        f"{[round(x, 3) for x in hit_ms]} ms (host clock), sim_serve_us "
        f"{sim_us}")
    steps = args.tokens - 1
    log(f"  decode: {args.batch} x {SEQ} prompt, {steps} steps; vs a forward"
        f" of {seq.shape[1]} tokens {decode_err:.5f} of the largest logit "
        f"({decode_ids}/{steps} steps with every greedy id equal), unrolled "
        f"vs scan {unrolled_err:.5f} (tolerance {SERVE_LOGIT_TOL}); "
        f"{steps} unrolled steps "
        f"{unrolled_s:.1f} s; prefill {[round(x, 2) for x in prefill_ms]} ms,"
        f" decode step {statistics.median(step_ms):.3f} ms (median of 10; "
        f"CUDA events); peak {peak / 2**30:.2f} GiB")
    stats = dataclasses.asdict(plane.stats)
    stats.pop("latency")
    del out, fabric, plane, params, source, prompts, ids, seq, v1
    torch.cuda.empty_cache()

    # --source checkpoint: saved at round 0, restored, served back
    ckpt_dir = ROOT / "build" / "serve_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cargs = S.build_argparser().parse_args(
        SERVE_ARGV[:SERVE_ARGV.index("--train-rounds")]
        + ["--source", "checkpoint", "--train-rounds", "0", "--checkpoint",
           str(ckpt_dir), "--serve-shards", str(SHARDS), "--serve-racks", "2",
           "--serve-replication", "2", "--batch", "1", "--prompt-len", "16",
           "--tokens", "2"])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cout = S.serve(cfg, cargs, device=dev)
        torch.cuda.synchronize()
        ckpt_s = time.perf_counter() - t0
        cread = cout["plane"].frontends[0].flat
        if (cout["read"]["version"] != 0
                or not same_bits(cread, cout["fabric"].params)):
            raise AssertionError("the checkpoint-served read is not the "
                                 "fabric's bits")
        del cout, cread
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"  checkpoint source: saved at round 0 ({n * 4} B of params), "
        f"restored and served back bitwise in {ckpt_s:.1f} s (fabric build, "
        f"save, restore, a 1 x 16 prefill and one decode step)")
    return {"launches": launches, "peak_bytes": peak, "cli_s": cli_s,
            "assemble_ms": assemble_ms, "miss_ms": miss_ms, "hit_ms": hit_ms,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "decode_err": decode_err, "unrolled_err": unrolled_err,
            "sim_serve_us": sim_us, "stats": stats, "ckpt_s": ckpt_s,
            "flat_elems": n}


def sparse_serve_path(dev) -> dict:
    """Phase 21: dlrm-mlperf (tables capped at DLRM_ROW_CAP rows, as phase
    6) under a 2-rack NetworkTopology (1:4 core), R = 1: one training round
    of 2 workers (counts set to 0 just before and read just after: 52
    embedding_bag, 52 segment_sum, 4 fused_agg_opt), then a SparseReadPlane
    of 2 frontends (one a rack, 65,536 hot rows each) serving a Zipfian
    trace (skew 1.05) of 4,096-row batches over the two largest tables,
    interleaved with a second round.  Every served row equals a direct
    ``tier.table(name)[ids]`` bitwise; the hit rate, the rack and core
    bytes and the ms per ``read_rows`` batch are reported."""
    import numpy as np
    import torch

    from repro_torch.core.config import ServeConfig
    from repro_torch.core.serving import SparseReadPlane, zipfian_trace
    from repro_torch.core.topology import NetworkTopology
    from repro_torch.data.synthetic import recsys_batches

    cfg = dlrm_capped_config()
    memory = PathMemory(dev)
    topo = NetworkTopology(num_workers=WORKERS, num_racks=2)
    space, fab, tier = dlrm_setup(cfg, dev, SHARDS, topology=topo)
    if tier.topology is not topo or tier.replication != 1:
        raise AssertionError("the tier did not inherit the topology")
    streams = [recsys_batches("dlrm-mlperf", cfg, DLRM_BATCH, seed=w)
               for w in range(WORKERS)]
    losses: list = []
    n = cfg.n_sparse
    torch.cuda.synchronize()
    _zero_counts()  # every count to 0 just before the round...
    t0 = time.perf_counter()
    dlrm_round(space, fab, tier, cfg, streams, dev, losses)
    torch.cuda.synchronize()
    round_ms = [(time.perf_counter() - t0) * 1e3]
    launches = _counts()  # ...and read just after
    _check_counts("sparse serve round 1", launches,
                  {"embedding_bag": n * WORKERS, "segment_sum": n * WORKERS,
                   "fused_agg_opt": sum(1 for s in fab.shards
                                        if s.num_chunks)})
    order = sorted(range(n), key=lambda i: -cfg.vocabs[i])[:2]
    names = [f"t{i}" for i in order]
    plane = SparseReadPlane(tier, config=ServeConfig(
        num_frontends=2, cache_rows=65536, name="rows",
        serve_us_per_read=0.01))
    batch, batches = 4096, 12
    traces = {name: zipfian_trace(tier.tables[name].num_rows,
                                  batch * batches, 1.05, seed=i)
              for i, name in enumerate(names)}
    read_ms, served = [], 0
    for b in range(batches):
        if b == batches // 2:  # the second round lands between reads
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dlrm_round(space, fab, tier, cfg, streams, dev, losses)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
        name = names[b % 2]
        ids = traces[name][b * batch:(b + 1) * batch]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = plane.read_rows(b % 2, name, ids)
        torch.cuda.synchronize()
        read_ms.append((time.perf_counter() - t0) * 1e3)
        direct = tier.table(name)[torch.from_numpy(ids).to(dev)]
        if not same_bits(res.rows, direct):
            raise AssertionError(f"batch {b}: served rows of {name} differ "
                                 "from the direct table read")
        if not np.array_equal(res.versions, tier.row_versions(name)[ids]):
            raise AssertionError(f"batch {b}: stamped versions differ")
        served += len(ids)
        del direct, res
    finite_losses(losses)
    st, ts = plane.stats, tier.stats
    if st.row_reads != served or st.row_hits + st.row_misses != served:
        raise AssertionError(f"SparseServeStats do not add up: {st}")
    if not (st.bytes_rack_link > 0 and st.bytes_core_link > 0
            and st.bytes_refreshed == st.bytes_rack_link
            + st.bytes_core_link):
        raise AssertionError(f"serve bytes not split by rack: {st}")
    peak = memory.now()[1]
    log(f"sparse serve path: {cfg.name} (tables capped at {DLRM_ROW_CAP} "
        f"rows) over 2 racks (1:4 core), R = 1; round 1 launches {launches};"
        f" rounds {[round(x, 1) for x in round_ms]} ms; tier rack / core "
        f"bytes {ts.bytes_rack_link} / {ts.bytes_core_link}, sim push / "
        f"lookup us {ts.sim_push_us:.1f} / {ts.sim_lookup_us:.1f}")
    log(f"  {plane.describe()}; served {served} rows of {names} in "
        f"{batches} batches of {batch}, every row == the direct table read; "
        f"hit rate {st.hit_rate:.4f} ({st.stale_rows} version-stale, "
        f"{st.evictions} evictions); serve rack / core bytes "
        f"{st.bytes_rack_link} / {st.bytes_core_link}; read_rows ms "
        f"{[round(x, 1) for x in read_ms]} (host clock); sim_serve_us "
        f"{st.sim_serve_us:.1f}; peak {peak / 2**30:.2f} GiB")
    stats = dataclasses.asdict(st)
    del space, fab, tier, plane, streams
    torch.cuda.empty_cache()
    return {"launches": launches, "peak_bytes": peak, "round_ms": round_ms,
            "read_ms": read_ms, "stats": stats, "served": served,
            "tables": names}


def _record(x):
    """A comparable record of a serving result: tensors to the host,
    dataclasses and trackers to plain fields (floats kept exact)."""
    import torch

    from repro_torch.core.serving import LatencyTracker

    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, LatencyTracker):
        return ("tracker", x.counts.tolist(), x.count, x.total_us, x.min_us,
                x.max_us, [x.quantile(q) for q in (0.5, 0.99, 0.999)])
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _record(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _record(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_record(v) for v in x]
    if hasattr(x, "dtype") and hasattr(x, "tolist"):  # numpy
        return ("array", str(x.dtype), x.tolist())
    return x


def _same_record(a, b, where: str) -> None:
    import torch

    if torch.is_tensor(a) or torch.is_tensor(b):
        if not (torch.is_tensor(a) and torch.is_tensor(b)
                and same_bits(a, b)):
            raise AssertionError(f"{where}: tensors differ")
    elif isinstance(a, dict) and isinstance(b, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{where}: keys {a.keys()} != {b.keys()}")
        for k in a:
            _same_record(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: {len(a)} != {len(b)} items")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_record(x, y, f"{where}[{i}]")
    elif a != b and not (isinstance(a, float) and math.isnan(a)
                         and isinstance(b, float) and math.isnan(b)):
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def smoke_serve_check(dev) -> dict:
    """Phase 22: the serving path at gemma3-1b's SMOKE config (its flat
    space, 4 shards, chunks of 4096), every case on ``dev`` against the
    same case on the CPU: every ReadResult (bits, version, staleness, hit,
    frontend, ``sim_us``), every ServeStats / SparseServeStats field (the
    latency bins and ``sim_serve_us`` included), every ServedRequest,
    ``describe()``, and the fabric's params bitwise.  Cases: ReadPlane and
    HierarchicalReadPlane over 1 and 2 racks x R = 1, 2, 3 with a shard
    crash between reads (failed over at R >= 2, twice at R = 3; ShardLost
    at R = 1); a FrontDoor running ``generate_trace`` traces (open, closed
    loop, diurnal, flash crowd; and a mixed trace through a hierarchical
    plane); serve tenants (a flat and a hierarchical plane) beside a
    training job on a 2-rack MultiJobFabric over codecs none, bf16, int8;
    a SparseReadPlane at R = 2 over 2 racks with a shard failover and a
    fabric ``restore`` between reads.  Gradients are numpy draws, the same
    bits on both devices.  Each case's launches on the card equal the CPU
    run's calls of the plain versions.  Then prefill, the scan decode and
    the unrolled decode in f32, card against CPU: greedy ids equal, logits
    within SMOKE_LOGIT_TOL.  Returns each case's launches on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import config as C
    from repro_torch.core import serving as S
    from repro_torch.core import workload as WL
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.replication import ShardLost
    from repro_torch.core.sparse import SparseTier
    from repro_torch.core.tenancy import JobSpec, MultiJobFabric
    from repro_torch.core.topology import NetworkTopology
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, momentum, sgd

    mcfg = get_arch("gemma3-1b").smoke_config
    tree = T.init_params(mcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    space = ParamSpace.build(tree, chunk_elems=4096)
    init = space.flatten(tree)
    grads: dict = {}  # (flat length, seed) -> a numpy-drawn gradient
    cpu = torch.device("cpu")

    def fabric(device, racks, R, codec="none", opt=None):
        topo = (NetworkTopology(num_workers=WORKERS, num_racks=racks)
                if racks > 1 else None)
        return PBoxFabric(space, opt or momentum(0.05, 0.9), init,
                          device=device, config=C.FabricConfig(
                              num_shards=SHARDS, num_workers=WORKERS,
                              wire=C.WireConfig(
                                  topology=topo,
                                  compression=CompressionConfig(codec=codec)),
                              faults=C.FaultConfig(replication=R)))

    def train(fab, r):
        n = fab.space.flat_elems
        for w in range(fab.num_workers):
            fab.pull(w)
        for w in range(fab.num_workers):
            key = (n, (w + r) % 4)
            if key not in grads:
                grads[key] = torch.from_numpy((1e-2 * np.random.default_rng(
                    key[1]).standard_normal(n)).astype(np.float32))
            fab.push(w, grads[key].to(fab.device))

    def crash(fab, shard):
        try:
            return fab.crash_shard(shard)
        except ShardLost as e:
            return f"ShardLost: {e}"

    def hier_config(**kw):
        return C.ServeConfig(
            slos=(("rt", C.SLOConfig(latency_budget_us=400.0, priority=2.0)),
                  ("bulk", C.SLOConfig(latency_budget_us=400.0,
                                       staleness_bound=3))),
            hierarchy=C.HierarchyConfig(enabled=True,
                                        staleness_ladder=(0, 1, 3),
                                        frontends_per_tier=(1, 1, 2)), **kw)

    def planes_case(racks, R):
        def run(device):
            fab = fabric(device, racks, R)
            flat = S.ReadPlane(fab, config=C.ServeConfig(
                num_frontends=2, max_staleness=1, serve_us_per_read=0.3))
            hier = S.HierarchicalReadPlane(fab, config=hier_config())
            reads, fates = [], []
            for r in range(4):
                train(fab, r)
                if r == 1 or (r == 2 and R == 3):
                    fates.append(crash(fab, 1))
                reads += [flat.read(0), *flat.read_batch(1, 3)]
                reads += [hier.read(f) for f in range(len(hier.frontends))]
            return {"reads": reads, "fates": fates, "flat": flat.stats,
                    "hier": hier.stats, "describe": [flat.describe(),
                                                     hier.describe()],
                    "params": fab.params}
        return run

    def traces():
        c = C
        open_t = c.TenantLoadConfig(name="o", n_requests=30, batch_max=2,
                                    arrival=c.ArrivalConfig(
                                        interarrival_us=7.0))
        return {
            "open": (open_t, c.TenantLoadConfig(
                name="p", n_requests=20, arrival=c.ArrivalConfig(
                    process="poisson", interarrival_us=9.0))),
            "closed": (c.TenantLoadConfig(name="c", clients=3, think_us=12.0,
                                          requests_per_client=5,
                                          staleness_req=1),),
            "diurnal": (dataclasses.replace(open_t, diurnal=c.DiurnalConfig(
                enabled=True, amplitude=0.6, period_us=300.0, phase=0.1)),),
            "flash": (dataclasses.replace(open_t, flash=c.FlashCrowdConfig(
                enabled=True, at_us=50.0, duration_us=80.0, magnitude=6.0)),),
            "mixed": (c.TenantLoadConfig(
                name="rt", n_requests=15, arrival=c.ArrivalConfig(
                    process="poisson", interarrival_us=20.0)),
                      c.TenantLoadConfig(
                name="bulk", n_requests=25, staleness_req=3,
                arrival=c.ArrivalConfig(process="mmpp", interarrival_us=10.0,
                                        burst_factor=5.0,
                                        burst_dwell_us=60.0)),
                      c.TenantLoadConfig(name="cl", clients=2, think_us=15.0,
                                         requests_per_client=6,
                                         staleness_req=3)),
        }

    def door_case(shape):
        trace = WL.generate_trace(C.WorkloadConfig(tenants=traces()[shape]),
                                  3)

        def run(device):
            fab = fabric(device, 2, 2)
            admission = C.AdmissionConfig(enabled=True, rate_per_us=0.2,
                                          burst=3, shed_slack=0.7)
            if shape == "mixed":
                plane = S.HierarchicalReadPlane(fab, config=hier_config(
                    admission=admission))
            else:
                plane = S.ReadPlane(fab, config=C.ServeConfig(
                    num_frontends=2, max_staleness=1, serve_us_per_read=2.0,
                    slos=(("o", C.SLOConfig(latency_budget_us=40.0,
                                            priority=2.0)),
                          ("c", C.SLOConfig(latency_budget_us=60.0,
                                            staleness_bound=1))),
                    admission=admission))
            fired = [0]

            def on_time(now):
                while fired[0] < 4 and now >= (fired[0] + 1) * 50.0:
                    train(fab, fired[0])
                    fired[0] += 1

            door = S.FrontDoor(plane)
            outs = door.run(trace, on_time=on_time)
            if not any(o.admitted for o in outs):
                raise AssertionError(f"door/{shape}: nothing admitted")
            return {"outs": outs, "stats": plane.stats,
                    "door": door.describe(), "plane": plane.describe(),
                    "params": fab.params}
        return run

    def tenants_case(codec):
        def run(device):
            box = MultiJobFabric(num_shards=SHARDS, num_racks=2,
                                 device=device)
            h = box.attach(JobSpec(name="train", params=tree,
                                   optimizer=adamw(3e-3),
                                   num_workers=WORKERS, codec=codec,
                                   chunk_elems=4096, replication=2))
            flat = box.attach_serving(
                JobSpec(name="serve", params=None, optimizer=None,
                        num_workers=2, priority=1.0, bandwidth_cap=0.5),
                "train", max_staleness=1)
            hier = box.attach_serving(
                JobSpec(name="geo", params=None, optimizer=None,
                        num_workers=1, priority=2.0), "train",
                config=hier_config())
            reads = []
            for r in range(3):
                train(h, r)
                if r == 1:
                    box.apply_tenant_shares({"serve": 3.0})
                reads += [flat.read(r % 2), *flat.read_batch(1, 2)]
                reads += [hier.read(f) for f in range(len(hier.frontends))]
            util, desc = box.utilization(), box.describe()
            box.detach_serving("geo")
            return {"reads": reads, "flat": flat.stats, "hier": hier.stats,
                    "util": util, "describe": desc,
                    "links": {k: dict(q.stats.by_job)
                              for k, q in box.links.items()},
                    "params": h.fabric.params,
                    "stats": h.fabric.stats}
        return run

    def sparse_case(device):
        topo = NetworkTopology(num_workers=WORKERS, num_racks=2)
        dense = {"w": torch.zeros(2 * 4096)}
        dspace = ParamSpace.build(dense, chunk_elems=4096)
        fab = PBoxFabric(dspace, sgd(0.1), dspace.flatten(dense),
                         device=device, config=C.FabricConfig(
                             num_shards=SHARDS, num_workers=WORKERS,
                             wire=C.WireConfig(topology=topo),
                             faults=C.FaultConfig(replication=2)))
        tier = SparseTier(fabric=fab, codec="int8", lr=0.05)
        v, d = 4096, 32
        tier.add_table("t0", np.random.default_rng(5).standard_normal(
            (v, d)).astype(np.float32))
        plane = S.SparseReadPlane(tier, config=C.ServeConfig(
            num_frontends=2, cache_rows=256, name="rows"))
        trace = S.zipfian_trace(v, 1200, 1.1, seed=2)
        rng = np.random.default_rng(9)

        out, snap = [], None

        def sparse_round():
            for w in range(WORKERS):
                ids = rng.integers(0, v, size=200)
                out.append(tier.lookup(w, "t0", ids[:50],
                                       np.arange(0, 51, 5)))
                rows = rng.standard_normal((200, d)).astype(np.float32)
                tier.push(w, {"t0": (ids, torch.from_numpy(rows).to(
                    device))})

        for step in range(8):
            if step in (1, 2, 5):
                sparse_round()
            if step == 2:
                snap = fab.snapshot()
            if step == 3:
                out.append(fab.crash_shard(1))
            if step == 6:
                fab.restore(snap)
            ids = trace[step * 150:(step + 1) * 150]
            res = plane.read_rows(step % 2, "t0", ids)
            if not same_bits(res.rows, tier.table("t0")[
                    torch.from_numpy(ids).to(device)]):
                raise AssertionError(f"sparse step {step}: served rows "
                                     "differ from the direct table read")
            out.append(res)
        return {"reads": out, "stats": plane.stats, "tier": tier.stats,
                "table": tier.table("t0"), "versions": tier.row_versions(
                    "t0"), "describe": [plane.describe(), tier.describe()]}

    cases = {f"plane/racks{racks}/R{R}": planes_case(racks, R)
             for racks in (1, 2) for R in (1, 2, 3)}
    cases |= {f"door/{shape}": door_case(shape)
              for shape in ("open", "closed", "diurnal", "flash", "mixed")}
    cases |= {f"tenants/{codec}": tenants_case(codec)
              for codec in ("none", "bf16", "int8")}
    cases["sparse/R2/racks2"] = sparse_case
    launches = {}
    for label, run in cases.items():
        _zero_counts()
        card = _record(run(dev))
        torch.cuda.synchronize()
        launches[label] = _counts()
        with PlainCalls() as plain:
            host = _record(run(cpu))
        _same_record(card, host, label)
        if launches[label] != plain.counts:
            raise AssertionError(f"{label}: card launches {launches[label]},"
                                 f" CPU plain-version calls {plain.counts}")
        if not any(launches[label].values()):
            raise AssertionError(f"{label}: no kernel launched")

    # prefill, the scan decode and the unrolled decode, card against CPU
    def decode(device):
        params = _tree_to(tree, device)
        toks = torch.from_numpy(np.random.default_rng(4).integers(
            0, mcfg.vocab, (3, 20)).astype(np.int32)).to(device)
        nxt, cache = T.prefill(params, toks, mcfg, 28)
        caches = T.init_cache_unrolled(mcfg, 3, 28, device=device)
        for pos in range(20):
            T.decode_hidden_unrolled(params, toks[:, pos], caches, pos, mcfg)
        ids, scan, unrolled = [nxt], [], []
        for i in range(7):
            x = T.decode_hidden(params, ids[-1], cache, 20 + i, mcfg)
            u = T.decode_hidden_unrolled(params, ids[-1], caches, 20 + i,
                                         mcfg)
            scan.append(T.head_logits(params, x, mcfg))
            unrolled.append(T.head_logits(params, u, mcfg))
            ids.append(T._greedy_logits(params, x, mcfg))
        return (torch.stack(ids).cpu(), torch.stack(scan).cpu(),
                torch.stack(unrolled).cpu())

    with torch.no_grad():
        card_ids, card_scan, card_unrolled = decode(dev)
        cpu_ids, cpu_scan, cpu_unrolled = decode(cpu)
    errs = (rel_logit_err(card_scan, cpu_scan),
            rel_logit_err(card_unrolled, cpu_unrolled),
            rel_logit_err(card_unrolled, card_scan))
    if not torch.equal(card_ids, cpu_ids) or max(errs) > SMOKE_LOGIT_TOL:
        raise AssertionError(f"SMOKE decode card vs CPU: ids equal "
                             f"{torch.equal(card_ids, cpu_ids)}, logit "
                             f"errors {errs} (tolerance {SMOKE_LOGIT_TOL})")
    total = {k: sum(c[k] for c in launches.values()) for k in _counts()}
    log(f"SMOKE serve sweep: {len(cases)} cases card == CPU bitwise (reads, "
        f"every stats field and clock float, served requests, describe, "
        f"params); launches {total}, each case's equal to the CPU run's "
        f"plain-version calls; decode card vs CPU: ids equal, logits "
        f"{errs[0]:.2e} (scan) / {errs[1]:.2e} (unrolled) of the largest, "
        f"unrolled vs scan on the card {errs[2]:.2e}")
    return launches


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- phases 23 and 24: the placement solver and the closed-loop autoscaler ----
AUTO_ROUNDS = FAULT_ROUNDS  # phase 15's run A is the fixed-layout twin
AUTO_POLICY = dict(min_shards=SHARDS, max_shards=2 * SHARDS,
                   scale_up_busy_us=0.0, cooldown_rounds=10,
                   solve_placement=True)


def contiguous_owner(num_chunks: int, num_shards: int):
    """The contiguous policy's chunk -> shard map (``_partition``)."""
    import numpy as np

    sizes = [len(a) for a in np.array_split(np.arange(num_chunks),
                                            num_shards)]
    return np.repeat(np.arange(num_shards, dtype=np.int64), sizes)


def autoscale_path(dev, gw: GemmaWorkers, ref: dict) -> dict:
    """Phase 23: the closed loop at full width.  gemma3-1b, 2 workers (one
    in each of 2 racks, 1:4 core), AdamW, codec none, R = 2, 4 shards, a
    ReadPlane of 2 frontends, and an Autoscaler under AUTO_POLICY.  Round
    1; ``auto.step()`` (any busy time is above the 0.0 threshold: the
    shard count doubles to 8 through ``reshard``, then
    ``resolve_placement`` applies the solver's deltas); rounds 2 and 3; a
    read; ``auto.apply_plan`` of the 4-shard plan that
    ``PlacementProblem.standard(...).solve(seed=0)`` builds from the live
    shapes (one ``shard_count`` delta: ``reshard(4, plan=plan)``); round
    4; a read.

    Checks: the counts set to 0 just before the sequence and read just
    after give 4 + 8 + 8 + 4 fused_agg_opt launches and no codec launch;
    ``rescales == 2``; after ``step()`` the live plan equals the solved
    plan (the same problem solved again on the host) in chain and frontend
    racks, and the events equal ``diff_plans(base, solved)`` after the
    reshard; after ``apply_plan`` the live chain racks equal the applied
    plan's and the frontends stay; params and both AdamW slots hash to
    phase 15's fixed-layout R = 1 run (SHA-1 of the host state) and the
    losses equal its; the read after round 4 equals ``fab.params``, and
    the read taken before the second reshard keeps its bits (SHA-1 and a
    host copy).  Times each round, each ``step`` / ``apply_plan`` with
    the solve split out, each reshard, and the allocator retries and the
    peak."""
    import numpy as np
    import torch

    from repro_torch.core.config import FaultConfig, ServeConfig
    from repro_torch.core.placement import (
        PlacementPlan,
        PlacementProblem,
        current_plan,
        diff_plans,
    )
    from repro_torch.core.serving import ReadPlane
    from repro_torch.runtime.autoscaler import Autoscaler, AutoscalerPolicy

    t_phase = time.perf_counter()
    space = gw.space
    n_hi = AUTO_POLICY["max_shards"]
    owner = {n: contiguous_owner(space.num_chunks, n) for n in (SHARDS, n_hi)}

    def problem(n):
        # what Autoscaler._problem reads off the fabric, rebuilt on the host
        return PlacementProblem.standard(
            num_shards=n, num_racks=RACKS, replication=2, num_frontends=2,
            oversubscription=OVERSUB, codec="none",
            chunk_elems=space.chunk_elems,
            chunks_per_shard=np.bincount(owner[n], minlength=n))

    def retries():
        return torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)

    memory = PathMemory(dev)
    fab = gw.fabric(2, topology=topology(2),
                    faults=FaultConfig(replication=2))
    plane = ReadPlane(fab, config=ServeConfig(num_frontends=2))
    auto = Autoscaler(fab, policy=AutoscalerPolicy(**AUTO_POLICY),
                      planes=[plane])
    reshard_ms: list = []
    solve_ms: list = []
    reshard = fab.reshard
    solve = PlacementProblem.solve

    def timed_reshard(n, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reshard(n, **kw)
        torch.cuda.synchronize()
        reshard_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_solve(self, **kw):
        t0 = time.perf_counter()
        out = solve(self, **kw)
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    fab.reshard = timed_reshard
    PlacementProblem.solve = timed_solve
    try:
        retries_by = [retries()]
        round_ms = []

        def train(s):
            round_ms.append(timed(lambda: gw.round(fab, s)))
            retries_by.append(retries())

        _zero_counts()  # every count to 0 just before the sequence...
        train(0)
        step_events, step_ms = host_ms(auto.step)
        step_solve = list(solve_ms)
        live_step = current_plan(fab, planes=[plane])
        train(1)
        train(2)
        r3 = plane.read(0)
        if r3.version != 3 or not same_bits(r3.flat, fab.params):
            raise AssertionError(f"autoscale read after round 3: version "
                                 f"{r3.version}, not fab.params' bits")
        r3_host = r3.flat.to("cpu", copy=True)
        r3_sha = _digest(r3_host)
        fab._flat_cache = None
        solve_ms.clear()
        plan4 = problem(SHARDS).solve(seed=0)
        plan_solve = list(solve_ms)
        apply_events, apply_ms = host_ms(lambda: auto.apply_plan(plan4))
        live_apply = current_plan(fab, planes=[plane])
        train(3)
        launches = _counts()  # ...and read just after
    finally:
        PlacementProblem.solve = solve
        del fab.reshard
    peak = memory.now()[1]
    losses = gw.finite_losses()
    _check_counts("autoscale path", launches, {
        "fused_agg_opt": SHARDS + n_hi + n_hi + SHARDS})

    # the solver again on the host, from the shapes after the reshard
    base = PlacementPlan.default(
        n_hi, num_racks=RACKS, replication=2, num_frontends=2).replace(
        chunk_owner=owner[n_hi], origin="live")
    solved = problem(n_hi).solve(start=base, sweeps=auto.policy.solver_sweeps,
                                 local_moves=auto.policy.solver_moves,
                                 seed=auto.seed)
    deltas = diff_plans(base, solved)
    moved = int(np.sum(owner[n_hi] != owner[SHARDS]))
    kinds = [e.kind for e in step_events]
    if (kinds != ["reshard"] + [d.kind for d in deltas]
            or not step_events[0].detail.startswith(
                f"-> {n_hi} shards ({moved} chunks moved, ")
            or any(not e.detail.startswith(d.describe())
                   for e, d in zip(step_events[1:], deltas))):
        raise AssertionError(f"autoscale step events {step_events}, expected "
                             f"a reshard to {n_hi} then {deltas}")
    # auto.events as the JAX loop keeps it: resolve_placement's apply_plan
    # records the re-placement deltas, and step() records them again after
    # its reshard
    again = [d.kind for d in deltas]
    if [e.kind for e in auto.events] != again + kinds + ["reshard"]:
        raise AssertionError(f"auto.events {auto.events}")
    if (not np.array_equal(live_step.replica_racks, solved.replica_racks)
            or live_step.frontend_racks != solved.frontend_racks):
        raise AssertionError(f"after step() the live plan "
                             f"{live_step.describe()} is not the solved "
                             f"{solved.describe()}")
    if [(e.kind, e.detail) for e in apply_events] != [
            ("reshard", f"-> {SHARDS} shards ({moved} chunks moved)")]:
        raise AssertionError(f"autoscale apply_plan events {apply_events}")
    if (not np.array_equal(live_apply.replica_racks, plan4.replica_racks)
            or live_apply.frontend_racks != live_step.frontend_racks):
        raise AssertionError(f"after apply_plan the live plan "
                             f"{live_apply.describe()}, applied "
                             f"{plan4.describe()}")
    if fab.stats.rescales != 2 or fab.num_shards != SHARDS:
        raise AssertionError(f"rescales {fab.stats.rescales}, shards "
                             f"{fab.num_shards}")
    r4 = plane.read(0)
    if r4.version != AUTO_ROUNDS or not same_bits(r4.flat, fab.params):
        raise AssertionError(f"autoscale read after round 4: version "
                             f"{r4.version}, not fab.params' bits")
    fab._flat_cache = None
    del r4
    kept = r3.flat.to("cpu", copy=True)
    if not same_bits(kept, r3_host) or _digest(kept) != r3_sha:
        raise AssertionError("the read taken before the second reshard "
                             "lost its bits")
    del kept, r3_host, r3
    digest = state_digest(host_state(fab))
    if digest != ref["digest_a"]:
        raise AssertionError("the autoscaled run's params and AdamW slots "
                             "differ from phase 15's fixed-layout run")
    if losses != ref["losses_a"]:
        raise AssertionError(f"autoscaled losses {losses}, the fixed-layout "
                             f"run's {ref['losses_a']}")
    describe = auto.describe()
    events = [(e.round, e.kind, e.detail) for e in auto.events]
    stats = {k: getattr(fab.stats, k) for k in (
        "rescales", "chunks_moved", "replica_moves", "bytes_replication",
        "bytes_core_link")}
    retries_by = [b - a for a, b in zip(retries_by, retries_by[1:])]
    del plane, auto, fab
    torch.cuda.empty_cache()
    log(f"autoscale path: {gw.cfg.name} full width, 2 workers over {RACKS} "
        f"racks (core 1:{OVERSUB:g}), AdamW, codec none, R = 2, "
        f"{SHARDS} -> {n_hi} -> {SHARDS} shards over {AUTO_ROUNDS} rounds, a "
        f"ReadPlane of 2 frontends; launches {launches}")
    log(f"  events {events}; {describe}; stats {stats}")
    log(f"  the re-solve at {n_hi} shards gave {len(deltas)} deltas "
        f"({solved.describe()}); the {SHARDS}-shard plan "
        f"{plan4.describe()}")
    log(f"  round wall ms {[round(x, 1) for x in round_ms]} (rounds 2 and "
        f"4 first after a reshard); step() {step_ms:.1f} ms host (solve "
        f"{[round(x, 2) for x in step_solve]} ms), apply_plan "
        f"{apply_ms:.1f} ms host (its plan's solve "
        f"{[round(x, 2) for x in plan_solve]} ms); reshards "
        f"{[round(x, 1) for x in reshard_ms]} ms host; allocator retries by "
        f"round {retries_by}; peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")
    log(f"  params and both AdamW slots == phase 15's fixed-layout R = 1 run "
        f"(SHA-1 {digest}); losses {losses}; the read before the second "
        f"reshard kept its bits; the read after round {AUTO_ROUNDS} == "
        f"fab.params; phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "round_ms": round_ms, "step_ms": step_ms,
            "apply_ms": apply_ms, "solve_ms": step_solve + plan_solve,
            "reshard_ms": reshard_ms, "retries": retries_by,
            "peak_bytes": peak, "events": events}


def _fabric_record(fab) -> dict:
    """A comparable record of a fabric: params, optimizer slots and codec
    residuals (host copies), every stats field, the fault traces, chunk
    ownership and chain racks."""
    fab._flat_cache = None
    return _record({
        "params": fab.params,
        "state": [fab._assemble_rows(lambda sh, k=k: sh.state[k]).reshape(-1)
                  for k in range(fab.spec.num_state_slots)],
        "ef": _residuals(fab), "stats": fab.stats,
        "shards": [sh.stats for sh in fab.shards],
        "racks": [r.stats for r in fab.rack_aggs],
        "trace": fab.fault_trace, "export": fab.export_fault_trace(),
        "owner": fab.chunk_owner, "plan": fab.plan.replica_racks,
        "chains": [g.racks for g in fab.replicas], "step": fab.step})


def _telemetry(auto):
    """``telemetry()``, or the error it raises (a SparseReadPlane's stats
    carry no SLO fields, in either package)."""
    try:
        return auto.telemetry()
    except AttributeError as e:
        return f"AttributeError: {e}"


def smoke_autoscale_check(dev, only=None) -> dict:
    """Phase 24: the closed loop at gemma3-1b's SMOKE config (its flat
    space, chunks of 4096, 4 workers, momentum), every case on ``dev``
    against the same case on the CPU, bitwise in params, optimizer slots,
    residuals, every stats field, the fault traces, ``auto.events``,
    ``describe()``, the ``telemetry()`` dict (key for key, float for
    float), the read planes' stats and reads, and the sparse tiers'
    tables, versions and stats.  Cases (tests/test_autoscaler.py's, on
    R = 2 fabrics under a ``NetworkTopology``): codec none / int8 x racks
    1 / 2 / 4 x shards 1 -> 2, 2 -> 8, 8 -> 2 (a chain re-home and a
    frontend move, then a ``shard_count`` delta; each run equals its
    fixed-layout twin on the card); scale-up and scale-down from busy
    telemetry; straggler proposals through ``ShardRebalancer``;
    ``resolve_placement`` (twice the same events); two sparse autoscaled
    runs (codec none / int8) whose 8-shard plan carries a solved row map
    from a Zipf row load (lookups, pushes and reads between the levers);
    a sparse reshard refused mid-round, then done and failed over; a
    ``tenant_shares`` plan through ``shared=`` on a MultiJobFabric.
    Gradients are numpy draws, the same bits on both devices.  Each case's
    launches on the card equal the CPU run's calls of the plain versions.
    ``only`` names a subset of the cases.  Returns each case's launches on
    ``dev``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import config as C
    from repro_torch.core import serving as S
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.fabric import PBoxFabric
    from repro_torch.core.placement import (
        PlacementProblem,
        PlanDelta,
        current_plan,
        diff_plans,
    )
    from repro_torch.core.sparse import SparseTier
    from repro_torch.core.tenancy import JobSpec, MultiJobFabric
    from repro_torch.core.topology import NetworkTopology
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import adamw, momentum
    from repro_torch.runtime.autoscaler import Autoscaler, AutoscalerPolicy
    from repro_torch.runtime.straggler import ShardRebalancer

    t_phase = time.perf_counter()
    k = 4  # workers, as tests/test_autoscaler.py's K
    v, d = 256, 16  # sparse table rows and width
    mcfg = get_arch("gemma3-1b").smoke_config
    tree = T.init_params(mcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    space = ParamSpace.build(tree, chunk_elems=4096)
    init = space.flatten(tree)
    table = np.random.default_rng(7).standard_normal((v, d)).astype(
        np.float32)
    zipf = 1.0 / (np.arange(v) + 1.0) ** 1.05
    grads: dict = {}
    cpu = torch.device("cpu")

    def fabric(device, shards, racks, codec="none", R=2):
        return PBoxFabric(space, momentum(0.05, 0.9), init, device=device,
                          config=C.FabricConfig(
                              num_shards=shards, num_workers=k,
                              wire=C.WireConfig(
                                  topology=NetworkTopology(num_workers=k,
                                                           num_racks=racks),
                                  compression=CompressionConfig(codec=codec)),
                              faults=C.FaultConfig(replication=R)))

    def train(fab, r):
        n = fab.space.flat_elems
        for w in range(fab.num_workers):
            fab.pull(w)
        for w in range(fab.num_workers):
            key = (n, (w + r) % 4)
            if key not in grads:
                grads[key] = torch.from_numpy((1e-2 * np.random.default_rng(
                    key[1]).standard_normal(n)).astype(np.float32))
            fab.push(w, grads[key].to(fab.device))

    def perturb(base, racks):
        rr = np.asarray(base.replica_racks).copy()
        rr[0] = (rr[0] + 1) % racks
        fe = list(base.frontend_racks)
        if fe:
            fe[0] = (fe[0] + 1) % racks
        return base.replace(replica_racks=rr, frontend_racks=tuple(fe),
                            origin="solved")

    def outcome(auto, **extra):
        return {"events": auto.events, "describe": auto.describe(),
                "telemetry": _telemetry(auto),
                "fab": _fabric_record(auto.fabric),
                "planes": [p.stats for p in auto.planes],
                "frontends": [[fe.rack for fe in p.frontends]
                              for p in auto.planes], **extra}

    def dense_case(codec, racks, shards, target):
        def run(device):
            fa = fabric(device, shards, racks, codec)
            fb = fabric(device, shards, racks, codec)
            plane = S.ReadPlane(fb, config=C.ServeConfig(num_frontends=2))
            auto = Autoscaler(fb, planes=[plane], policy=AutoscalerPolicy(
                min_shards=1, max_shards=8, cooldown_rounds=0,
                solve_placement=False))
            for r in range(2):
                train(fa, r)
                train(fb, r)
            moved = auto.apply_plan(perturb(current_plan(fb, planes=[plane]),
                                            racks))
            for r in range(2, 4):
                train(fa, r)
                train(fb, r)
            auto.apply_delta(PlanDelta(kind="shard_count",
                                       new_shards=target))
            for r in range(4, 6):
                train(fa, r)
                train(fb, r)
            read = plane.read(0)
            checks = [same_bits(fa.params, fb.params),
                      same_bits(read.flat, fb.params),
                      fb.num_shards == target, fb.stats.rescales == 1,
                      racks == 1 or {"replica_racks", "frontend_move"}
                      <= {e.kind for e in moved}]
            return outcome(auto, read=read, checks=checks)
        return run

    def scale_up(device):
        fa, fb = fabric(device, 1, 2), fabric(device, 1, 2)
        auto = Autoscaler(fb, policy=AutoscalerPolicy(
            min_shards=1, max_shards=4, scale_up_busy_us=0.0,
            scale_down_busy_us=0.0, cooldown_rounds=1,
            solve_placement=False))
        ticks = []
        for r in range(4):
            train(fa, r)
            train(fb, r)
            ticks.append(_telemetry(auto))
            auto.step()
        checks = [fb.num_shards == 4, fb.stats.rescales == 2,
                  same_bits(fa.params, fb.params)]
        return outcome(auto, ticks=ticks, checks=checks)

    def scale_down(device):
        fab = fabric(device, 8, 2)
        auto = Autoscaler(fab, policy=AutoscalerPolicy(
            min_shards=2, max_shards=8, scale_up_busy_us=1e12,
            scale_down_busy_us=1e12, cooldown_rounds=0,
            solve_placement=False))
        train(fab, 0)
        shards = []
        for _ in range(3):
            auto.step()
            shards.append(fab.num_shards)
        train(fab, 1)
        return outcome(auto, checks=[shards == [4, 2, 2]])

    def straggler(device):
        fa, fb = fabric(device, 4, 2), fabric(device, 4, 2)
        reb_a = ShardRebalancer(fa, cooldown=0)
        reb_b = ShardRebalancer(fb, cooldown=0)
        auto = Autoscaler(fb, rebalancer=reb_b,
                          policy=AutoscalerPolicy(solve_placement=False))
        for r in range(2):
            train(fa, r)
            train(fb, r)
        for _ in range(25):
            for reb in (reb_a, reb_b):
                reb.record(0, 10.0)
                for sh in range(1, 4):
                    reb.record(sh, 0.1)
        legacy = reb_a.maybe_rebalance()
        events = auto.step()
        for r in range(2, 4):
            train(fa, r)
            train(fb, r)
        checks = [legacy == [0], [e.kind for e in events] == ["chunk_moves"],
                  fb.shards[0].num_chunks == 0,
                  np.array_equal(fa.chunk_owner, fb.chunk_owner),
                  same_bits(fa.params, fb.params)]
        return outcome(auto, checks=checks)

    def resolve(device):
        runs = []
        for _ in range(2):
            fab = fabric(device, 4, 2)
            plane = S.ReadPlane(fab, config=C.ServeConfig(num_frontends=2))
            auto = Autoscaler(fab, planes=[plane], seed=3)
            for r in range(2):
                train(fab, r)
            events = auto.resolve_placement()
            for r in range(2, 4):
                train(fab, r)
            runs.append((auto, [(e.kind, e.detail) for e in events]))
        plain = fabric(device, 4, 2)
        for r in range(4):
            train(plain, r)
        (auto, ev_a), (twin, ev_b) = runs
        checks = [ev_a == ev_b,
                  same_bits(auto.fabric.params, twin.fabric.params),
                  same_bits(plain.params, auto.fabric.params)]
        return outcome(auto, checks=checks)

    def sparse_stack(device, codec):
        fab = fabric(device, 2, 2)
        plane = S.ReadPlane(fab, config=C.ServeConfig(num_frontends=2))
        tier = SparseTier(fabric=fab, codec=codec, lr=0.1)
        tier.add_table("t0", table)
        splane = S.SparseReadPlane(tier, config=C.ServeConfig(
            num_frontends=2, cache_rows=64))
        return fab, plane, tier, splane

    def sparse_round(tier, rng, out):
        for w in range(tier.num_workers):
            ids = rng.integers(0, v, size=24)
            out.append(tier.lookup(w, "t0", ids[:12], np.arange(0, 13, 3)))
            rows = rng.standard_normal((24, d)).astype(np.float32)
            tier.push(w, {"t0": (ids, torch.from_numpy(rows).to(
                tier.device))})

    def sparse_case(codec):
        def run(device):
            fa, _, ta, _ = sparse_stack(device, codec)
            fb, plane, tb, splane = sparse_stack(device, codec)
            auto = Autoscaler(fb, planes=[plane, splane],
                              policy=AutoscalerPolicy(cooldown_rounds=0))
            looked: list = []
            for run_id, (fab, tier) in enumerate(((fa, ta), (fb, tb))):
                rng = np.random.default_rng(11)
                for r in range(2):
                    train(fab, r)
                    sparse_round(tier, rng, looked if run_id else [])
            moved = auto.apply_plan(perturb(
                current_plan(fb, planes=[plane, splane]), 2))
            plan = PlacementProblem.standard(
                num_shards=8, num_racks=2, replication=2, num_frontends=4,
                chunk_elems=space.chunk_elems,
                row_load={"t0": zipf}).solve(seed=0)
            rescale = auto.apply_plan(plan)
            for run_id, (fab, tier) in enumerate(((fa, ta), (fb, tb))):
                rng = np.random.default_rng(13)
                for r in range(2, 4):
                    train(fab, r)
                    sparse_round(tier, rng, looked if run_id else [])
            res = splane.read_rows(1, "t0", np.arange(v))
            checks = [any(e.kind == "frontend_move" for e in moved),
                      [e.kind for e in rescale] == ["reshard"],
                      tb.num_shards == 8 and tb.stats.rescales == 1,
                      tb.tables["t0"].placement.policy == "plan",
                      np.array_equal(tb.tables["t0"].placement.owner,
                                     plan.row_owner["t0"]),
                      same_bits(fa.params, fb.params),
                      same_bits(ta.table("t0"), tb.table("t0")),
                      np.array_equal(ta.row_versions("t0"),
                                     tb.row_versions("t0")),
                      same_bits(res.rows, tb.table("t0"))]
            return outcome(auto, checks=checks, looked=looked, rows=res,
                           table=tb.table("t0"),
                           versions=tb.row_versions("t0"),
                           tier=tb.stats, owner=plan.row_owner["t0"],
                           describe_tier=tb.describe())
        return run

    def sparse_failover(device):
        fab = fabric(device, 2, 2)
        tier = SparseTier(fabric=fab, replication=2)
        tier.add_table("t0", table)
        out: list = []
        sparse_round(tier, np.random.default_rng(5), out)
        ones = torch.ones((4, d), device=tier.device)
        tier.push(0, {"t0": (np.arange(4), ones)})
        try:
            tier.reshard(4)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        for w in range(1, tier.num_workers):
            tier.push(w, {"t0": (np.arange(4), ones)})
        before = tier.table("t0").clone()
        tier.reshard(4)
        kept = same_bits(tier.table("t0"), before)
        action = tier.failover(1)
        checks = [refused is not None, kept, len(tier._chains) == 4,
                  same_bits(tier.table("t0"), before)]
        return {"refused": refused, "action": action, "checks": checks,
                "looked": out, "table": tier.table("t0"),
                "versions": tier.row_versions("t0"), "tier": tier.stats,
                "describe": tier.describe()}

    def shares(device):
        def attach_two(box):
            return [box.attach(JobSpec(name=name, params=tree,
                                       optimizer=adamw(3e-3), num_workers=2,
                                       chunk_elems=4096, priority=pri))
                    for name, pri in (("a", 2.0), ("b", 1.0))]

        box = MultiJobFabric(num_shards=2, num_racks=2, device=device)
        handles = attach_two(box)
        for h in handles:
            train(h, 0)
        auto = Autoscaler(handles[0].fabric, shared=box)
        base = current_plan(handles[0].fabric)
        first = auto.apply_plan(base.replace(
            tenant_shares={"a": 1.0, "b": 3.0}))
        again = auto.apply_plan(base.replace(
            tenant_shares={"a": 1.0, "b": 3.0}))
        solved = PlacementProblem.standard(
            num_shards=2, num_racks=2,
            tenant_demand={"a": 2.0, "b": 5.0}).solve(seed=0)
        auto.apply_delta(diff_plans(base, solved)[-1])
        for h in handles:
            train(h, 1)
        plain = MultiJobFabric(num_shards=2, num_racks=2, device=device)
        for h in attach_two(plain):
            train(h, 0)
            train(h, 1)
        checks = [[e.kind for e in first] == ["tenant_shares"], again == [],
                  box._share_override == {"a": 1.0, "b": 2.5},
                  all(same_bits(h.fabric.params, p.fabric.params)
                      for h, p in zip(handles, plain.jobs.values()))]
        return outcome(auto, checks=checks,
                       tenants=[_fabric_record(h.fabric) for h in handles],
                       util=box.utilization(), box=box.describe(),
                       links={n: dict(q.stats.by_job)
                              for n, q in box.links.items()})

    cases = {f"dense/{codec}/racks{racks}/{s}->{t}": dense_case(
        codec, racks, s, t) for codec in ("none", "int8")
        for racks in (1, 2, 4) for s, t in ((1, 2), (2, 8), (8, 2))}
    cases |= {"scale_up/busy": scale_up, "scale_down/idle": scale_down,
              "straggler/delta_path": straggler, "resolve/seed3": resolve}
    cases |= {f"sparse/{codec}/solved_rows": sparse_case(codec)
              for codec in ("none", "int8")}
    cases |= {"sparse/reshard+failover": sparse_failover,
              "tenant_shares/shared": shares}
    if only is not None:
        cases = {label: cases[label] for label in only}
    launches = {}
    for label, run in cases.items():
        _zero_counts()
        card = _record(run(dev))
        torch.cuda.synchronize()
        launches[label] = _counts()
        with PlainCalls() as plain:
            host = _record(run(cpu))
        if not all(card["checks"]):
            raise AssertionError(f"{label}: checks on {dev} {card['checks']}")
        _same_record(card, host, label)
        if launches[label] != plain.counts:
            raise AssertionError(f"{label}: card launches {launches[label]},"
                                 f" CPU plain-version calls {plain.counts}")
        if not any(launches[label].values()):
            raise AssertionError(f"{label}: no kernel launched")
    grads.clear()
    total = {key: sum(c[key] for c in launches.values()) for key in _counts()}
    log(f"SMOKE autoscale sweep: {len(cases)} cases card == CPU bitwise "
        f"(params, slots, residuals, every stats field, fault traces, "
        f"events, describe, telemetry, reads, sparse tables); each "
        f"autoscaled run == its fixed-layout twin on {dev.type}; launches "
        f"{total}, each case's equal to the CPU run's plain-version calls; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phases 25 to 27: the SPMD path over torch.distributed --------------------
# phase 25's batch: SPMD_BATCH sequences of SEQ tokens (train_4k's 256 x 4096
# cut to fit the phase's time), SPMD_STEPS steps a strategy; the card's step
# 2 is replayed on the CPU over windows of SPMD_WINDOW chunks
SPMD_BATCH, SPMD_STEPS, SPMD_WINDOW, SPMD_BOOK = 2, 3, 64, 1
# phase 26: gemma3-1b SMOKE, a global batch of 6 x 16 tokens, 2 steps a case
SMOKE_SPMD_BATCH, SMOKE_SPMD_SEQ, SMOKE_SPMD_STEPS = 6, 16, 2


class LocalMesh:
    """A world-1 mesh whose collectives are the identity, for replaying the
    exchange on the CPU: at world 1 every collective of the card's NCCL
    group is a copy."""

    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.shape = {a: 1 for a in axes}
        self.size = 1

    def axis_size(self, axes) -> int:
        return 1

    def axis_index(self, axes) -> int:
        return 0

    def psum(self, x, axes):
        return x

    pmean = psum_scatter = psum

    def all_gather(self, x, axes, axis: int = 0, tiled: bool = True):
        return x if tiled else x.unsqueeze(axis)


@contextlib.contextmanager
def world_one(dev):
    """A world-1 NCCL process group on the card for the block."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group

    tmp = tempfile.mkdtemp(prefix="chip_smoke_spmd_")
    init_process_group(dev, init_method=f"file://{tmp}/rendezvous")
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _windows(n: int, chunk: int) -> list:
    """Chunk-aligned windows of SPMD_WINDOW chunks at the start, the middle
    and the end (the padding) of an n-element slab."""
    w = SPMD_WINDOW * chunk
    mid = (n // chunk // 2) * chunk
    return [(0, w), (mid, mid + w), (n - w, n)]


def book_update(ex, book: dict, events: list, book_call: int, chunk: int):
    """Wrap ``ex.device_update``: CUDA events around every call, and at
    call ``book_call`` host copies of every input's and output's windows
    (inputs before the call: the kernel updates them in place)."""
    import torch

    real = ex.device_update

    def booked(gflat, pflat, state, lr_scale=1.0, *, mesh):
        call = len(events)
        wins = _windows(pflat.shape[0], chunk) if call == book_call else []

        def cut(x):
            return [x[a:b].cpu() for a, b in wins] if x is not None else None

        if wins:
            book["in"] = {"g": cut(gflat), "p": cut(pflat),
                          "slots": [cut(s) for s in state["slots"]],
                          "ef": cut(state["ef"]), "step": state["step"].cpu(),
                          "lr_scale": lr_scale}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        new_p, new_state = real(gflat, pflat, state, lr_scale, mesh=mesh)
        end.record()
        events.append((start, end))
        if wins:
            book["out"] = {"p": cut(new_p),
                           "slots": [cut(s) for s in new_state["slots"]],
                           "ef": cut(new_state["ef"])}
        return new_p, new_state

    ex.device_update = booked
    return real


def replay_book(real, book: dict, axes) -> float:
    """Each booked window through ``device_update`` on the CPU (the
    kernels' plain versions), against the card's outputs, bitwise."""
    i = book["in"]
    err = 0.0
    for w in range(len(i["g"])):
        state = {"slots": tuple(s[w] for s in i["slots"]),
                 "ef": i["ef"][w] if i["ef"] is not None else None,
                 "step": i["step"]}
        new_p, new_state = real(i["g"][w], i["p"][w], state, i["lr_scale"],
                                mesh=LocalMesh(axes))
        pairs = [(new_p, book["out"]["p"][w])]
        pairs += [(a, b[w]) for a, b in zip(new_state["slots"],
                                            book["out"]["slots"])]
        if new_state["ef"] is not None:
            pairs.append((new_state["ef"], book["out"]["ef"][w]))
        for a, b in pairs:
            err = max(err, max_abs_err(a, b))
            if not same_bits(a, b):
                raise AssertionError(
                    f"CPU replay of the booked update differs in window {w}, "
                    f"max |err| {max_abs_err(a, b)}")
    return err


def spmd_path(dev) -> dict:
    """gemma3-1b at full width trained by the SPMD PS step (world 1 over
    NCCL) with AdamW, SPMD_STEPS steps a strategy: pbox and allreduce on a
    1 x 1 (data, model) mesh, pbox_hier with the int8 codec and error
    feedback on a 1 x 1 x 1 (pod, data, model) mesh.  Call inside
    ``world_one`` and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.core.fabric import ServerStats
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_lm_train, make_exchange
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import (
        attach_telemetry,
        init_train_state,
        local_state,
    )

    arch = get_arch("gemma3-1b")
    cfg = arch.config
    cell = ShapeCell("train_2x1k", "train",
                     {"seq_len": SEQ, "global_batch": SPMD_BATCH})
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in itertools.islice(
                   lm_batches(cfg.vocab, SPMD_BATCH, SEQ, 0), SPMD_STEPS)]
    dp = make_mesh((1, 1), ("data", "model"))
    pod = make_mesh((1, 1, 1), ("pod", "data", "model"))
    int8 = CompressionConfig(codec="int8")
    runs, init, kept = {}, None, None
    for label, mesh, xcfg, want in (
            ("pbox", dp, ExchangeConfig("pbox"), {"fused_agg_opt": 1}),
            ("allreduce", dp, ExchangeConfig("allreduce"),
             {"fused_agg_opt": 1}),
            ("pbox_hier_int8", pod, ExchangeConfig("pbox_hier",
                                                   compression=int8),
             {"fused_agg_opt": 1, "quantize_chunks": 1,
              "dequantize_chunks": 2})):
        ex = make_exchange(mesh, "lm", exchange_cfg=xcfg)
        plan = build_lm_train(arch, cell, mesh, ex)
        space = plan.meta["space"]
        if init is None:
            gen = torch.Generator(device=dev).manual_seed(0)
            fn = lambda g: T.init_params(cfg, g)  # noqa: E731
        else:
            gen, fn = None, lambda _: space.unflatten(init)  # noqa: E731
        state = init_train_state(mesh, init_params_fn=fn, exchange=ex,
                                 space=space, n_groups=1, key=gen,
                                 ps_dtype=cfg.param_dtype, device=dev)
        if init is None:
            init = state.pflat[0].clone()
        stats = ServerStats()
        step = attach_telemetry(plan.fn, ex, space, mesh, stats)
        book, events = {}, []
        real = book_update(ex, book, events, SPMD_BOOK,
                           xcfg.compression.chunk_elems)
        pflat, slots, ef, stc = local_state(state, mesh, ex)
        del state
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        losses, step_ms = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pflat, slots, ef, stc, met = step(pflat, slots, ef, stc, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(met["loss"])
        launches = _counts()
        _check_counts(f"spmd {label}", launches,
                      {k: v * SPMD_STEPS for k, v in want.items()})
        peak = torch.cuda.max_memory_allocated(dev)
        losses = finite_losses(losses)
        update_ms = [s.elapsed_time(e) for s, e in events]
        mb = ex.modeled_bytes(space.flat_elems, 1, 1)
        if (stats.steps, stats.pushes, stats.bytes_pushed,
                stats.bytes_pulled) != (
                SPMD_STEPS, SPMD_STEPS, SPMD_STEPS * int(
                    mb["push"] + (mb["xpod"] or 0.0)),
                SPMD_STEPS * int(mb["pull"])):
            raise AssertionError(f"spmd {label}: telemetry {stats} against "
                                 f"modeled bytes {mb}")
        err = replay_book(real, book, mesh.axis_names)
        runs[label] = {"launches": launches, "losses": losses,
                       "step_ms": step_ms, "update_ms": update_ms,
                       "peak_bytes": peak, "replay_err": err,
                       "flat": space.flat_elems}
        log(f"spmd {label}: losses {losses}, steps {[round(x, 1) for x in step_ms]}"
            f" ms, device_update {[round(x, 2) for x in update_ms]} ms, peak "
            f"{peak / 2**30:.2f} GiB, launches {launches}; step {SPMD_BOOK + 1}"
            " replayed on the CPU over 3 windows bitwise")
        if label == "pbox":
            kept = (pflat, slots)
        elif label == "allreduce":
            if not (same_bits(pflat, kept[0]) and all(
                    same_bits(a, b) for a, b in zip(slots, kept[1]))):
                raise AssertionError("spmd: pbox and allreduce differ at "
                                     "world 1")
            kept = None
        del pflat, slots, ef
        torch.cuda.empty_cache()
    first = {label: r["losses"][0] for label, r in runs.items()}
    if len(set(first.values())) != 1:
        raise AssertionError(f"spmd: step-1 losses differ: {first}")
    log("spmd: pbox == allreduce bitwise (params, m, v) after "
        f"{SPMD_STEPS} steps; step-1 losses equal across strategies")
    return runs


def smoke_spmd_cases(only=None):
    """(name, strategy, codec, optimizer, microbatches, pull dtype) of
    phase 26: every strategy x codec x optimizer once, in turns with one
    microbatch and an f32 pull or three and a bf16 pull (the other
    pairings were cut for the script's time; the CPU tests hold them
    against JAX).
    ``only``: these names instead (any "strategy/codec/opt/mbN/pull_X";
    names that are not a step case are skipped)."""
    if only is not None:
        for name in only:
            parts = name.split("/")
            if len(parts) == 5 and parts[3].startswith("mb"):
                pull = parts[4].removeprefix("pull_")
                yield (name, parts[0], parts[1], parts[2], int(parts[3][2:]),
                       None if pull == "None" else pull)
        return
    for i, (strategy, codec) in enumerate((
            ("allreduce", "none"), ("pbox", "none"), ("pbox_hier", "none"),
            ("pbox_hier", "bf16"), ("pbox_hier", "int8"))):
        for j, opt in enumerate(("sgd", "momentum", "adam", "adamw")):
            mb, pull = ((1, None), (3, "bf16"))[(i + j) % 2]
            yield (f"{strategy}/{codec}/{opt}/mb{mb}/pull_{pull}",
                   strategy, codec, opt, mb, pull)


def _smoke_spmd_step(cfg, mesh, strategy, codec, opt, mb, pull, loss_fn):
    import torch

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.exchange import ExchangeConfig, PSExchange
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.optim import optimizers as O
    from repro_torch.optim.schedules import linear_warmup
    from repro_torch.runtime.trainer import make_ps_train_step

    spec = {"sgd": O.sgd(0.05), "momentum": O.momentum(0.05, 0.9),
            "adam": O.adam(1e-3), "adamw": O.adamw(1e-3)}[opt]
    ex = PSExchange(spec, ExchangeConfig(
        strategy, compression=CompressionConfig(codec=codec),
        pull_dtype=torch.bfloat16 if pull else None),
        meshlib.worker_axes(mesh), meshlib.pod_axis(mesh)
        if strategy == "pbox_hier" else None)
    step, space, _, _ = make_ps_train_step(
        mesh, loss_fn=loss_fn, global_param_template=T.abstract_params(cfg),
        exchange=ex, dist=Dist(), ps_dtype=cfg.param_dtype,
        microbatches=mb, lr_schedule=linear_warmup(3))
    return step, space, ex


def smoke_spmd_check(dev, only=None) -> dict:
    """Phase 26: every ``smoke_spmd_cases`` case at gemma3-1b's SMOKE config
    and world 1, the step on the card against a CPU replay: each
    microbatch's gradient booked on the card (recomputed before the step,
    under deterministic algorithms: the same bits the step computes) and
    fed to the same step on the CPU through a loss whose gradient is
    exactly the booked one.  Params, slots and residuals bitwise; the
    card's launches equal to the CPU's plain-version calls.  Then the
    zero-compute step for each strategy on the card: every param at -0.1.
    Call inside ``world_one`` and ``deterministic``."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.exchange import ExchangeConfig, PSExchange
    from repro_torch.core.zero_compute import (
        init_zero_compute_state,
        make_zero_compute_step,
    )
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import momentum
    from repro_torch.runtime.trainer import tracked_params

    cfg = get_arch("gemma3-1b").smoke_config
    meshes = {"dp": make_mesh((1, 1), ("data", "model")),
              "pod": make_mesh((1, 1, 1), ("pod", "data", "model"))}
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    batches = [{k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (SMOKE_SPMD_BATCH, SMOKE_SPMD_SEQ)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(SMOKE_SPMD_STEPS)]

    def model_loss(p, b, dist):
        return T.lm_loss(p, b["tokens"], b["labels"], cfg)

    def pairs_of(p, g):
        if isinstance(p, dict):
            return [x for k in p for x in pairs_of(p[k], g[k])]
        return [(p, g)]

    def replay_loss(p, b, dist):
        # d/dp of sum(p * g) is g exactly: the booked gradient, leaf by leaf
        g = tracked_params(space_of[0], b["g"].reshape(-1))
        loss = sum((a * w).sum() for a, w in pairs_of(p, g))
        return loss, {"ce": loss.detach(), "aux": loss.detach() * 0}

    out, space_of = {}, [None]
    for name, strategy, codec, opt, mb, pull in smoke_spmd_cases(only):
        mesh = meshes["pod" if strategy == "pbox_hier" else "dp"]
        step, space, ex = _smoke_spmd_step(cfg, mesh, strategy, codec, opt,
                                           mb, pull, model_loss)
        space_of[0] = space
        cstep, _, cex = _smoke_spmd_step(cfg, LocalMesh(mesh.axis_names),
                                         strategy, codec, opt, mb, pull,
                                         replay_loss)
        flat = space.flatten(params)
        n = ex.slab_elems(space)
        st = ex.init_slab_state(space, device=dev)
        card = [flat.to(dev).reshape(1, -1), tuple(
            s.reshape(1, -1) for s in st["slots"]),
            st["ef"].reshape(1, -1) if st["ef"] is not None else None,
            st["step"]]
        cst = cex.init_slab_state(space, device="cpu")
        cpu = [flat.clone().reshape(1, -1), tuple(
            s.reshape(1, -1) for s in cst["slots"]),
            cst["ef"].reshape(1, -1) if cst["ef"] is not None else None,
            cst["step"]]
        _zero_counts()
        booked = []
        for b in batches:
            rows = SMOKE_SPMD_BATCH // mb
            gs = []
            for i in range(mb):
                leaf = card[0].reshape(-1).detach().requires_grad_(True)
                mbatch = {k: v[i * rows:(i + 1) * rows].to(dev)
                          for k, v in b.items()}
                loss, _ = model_loss(tracked_params(space, leaf), mbatch, None)
                gs.append(torch.autograd.grad(loss, leaf)[0].cpu())
            booked.append(torch.stack(gs))
            card[:4] = step(*card, {k: v.to(dev) for k, v in b.items()})[:4]
        launches = _counts()
        with PlainCalls() as plain:
            for g in booked:
                cpu[:4] = cstep(*cpu, {"g": g})[:4]
        if launches != plain.counts:
            raise AssertionError(f"smoke spmd {name}: card launches "
                                 f"{launches}, CPU plain calls {plain.counts}")
        pairs = [(card[0], cpu[0])] + list(zip(card[1], cpu[1]))
        if card[2] is not None:
            pairs.append((card[2], cpu[2]))
        for a, b in pairs:
            if not same_bits(a.cpu(), b):
                raise AssertionError(
                    f"smoke spmd {name}: card != CPU, max |err| "
                    f"{max_abs_err(a.cpu(), b)}")
        if int(card[3]) != SMOKE_SPMD_STEPS or any(
                s.shape[-1] != n for s in card[1]):
            raise AssertionError(f"smoke spmd {name}: step or slab size")
        out[name] = launches
    for strategy, pod in (("pbox", None), ("pbox_hier", "pod"),
                          ("allreduce", None)):
        if only is not None and f"zero/{strategy}" not in only:
            continue
        ex = PSExchange(momentum(0.1, 0.9), ExchangeConfig(strategy),
                        ("pod", "data", "model"), pod)
        flat = 8192 * 8
        zstep = make_zero_compute_step(meshes["pod"], ex, flat)
        state = init_zero_compute_state(meshes["pod"], ex, flat, device=dev)
        p0, g0 = torch.zeros(flat, device=dev), torch.ones(flat, device=dev)
        _zero_counts()
        p2, _ = zstep(p0, g0, state)
        launches = _counts()
        if not torch.equal(p2, torch.full_like(p2, -0.1)):
            raise AssertionError(f"zero-compute {strategy}: params "
                                 f"{p2[:4].tolist()}, expected -0.1")
        want = {k: int(k == "fused_agg_opt") for k in launches}
        if launches != want:
            raise AssertionError(f"zero-compute {strategy}: launches "
                                 f"{launches}, expected {want}")
        out[f"zero/{strategy}"] = launches
    zero = [k[5:] for k in out if k.startswith("zero/")]
    log(f"smoke spmd: {len(out) - len(zero)} cases card == CPU bitwise "
        "(strategy x codec x optimizer, 1 microbatch with an f32 pull and "
        f"3 with a bf16 pull); zero-compute -0.1 under {', '.join(zero)}")
    return out


def cli_check(dev) -> dict:
    """Phase 27: ``launch/train.main`` on the card at gemma3-1b's SMOKE
    config, world 1: six steps with checkpoints at 3 and 6, then a run
    stopped after step 3 and resumed to 6, bitwise equal to the first.
    Call inside ``world_one`` and ``deterministic``."""
    import shutil
    import tempfile

    from repro_torch.launch.train import main

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    base = ["--arch", "gemma3-1b", "--mesh", "1x1", "--log-every", "3"]
    try:
        t0 = time.perf_counter()
        full = main(base + ["--steps", "6", "--ckpt-dir", str(tmp / "full"),
                            "--ckpt-every", "3"], device=dev)
        full_s = time.perf_counter() - t0
        main(base + ["--steps", "3", "--ckpt-dir", str(tmp / "crash"),
                     "--ckpt-every", "3"], device=dev)
        res = main(base + ["--steps", "6", "--ckpt-dir", str(tmp / "crash"),
                           "--resume"], device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if res["start"] != 3 or res["losses"] != full["losses"][3:]:
        raise AssertionError(f"cli: resumed losses {res['losses']} against "
                             f"{full['losses']}")
    if not (same_bits(res["pflat"], full["pflat"]) and all(
            same_bits(a, b) for a, b in zip(res["slots"], full["slots"]))):
        raise AssertionError("cli: the resumed run differs from the "
                             "uninterrupted one")
    if not full["losses"][-1] < full["losses"][0]:
        raise AssertionError(f"cli: loss did not fall: {full['losses']}")
    log(f"cli: main() 6 steps in {full_s:.1f} s, losses "
        f"{[round(x, 4) for x in full['losses']]}; stopped at 3 and resumed:"
        " bitwise equal (params, m, v)")
    return {"losses": full["losses"], "seconds": full_s}


# phase 28: two ranks on the one card over gloo (torch's gloo takes CUDA
# tensors in its reduce-scatter and all-gather; NCCL takes one rank a card)
GLOO_CASES = (("pbox", "none"), ("allreduce", "none"), ("pbox_hier", "int8"))
GLOO_BATCH, GLOO_STEPS = 4, 2


def _gloo_batches(cfg):
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    return [{k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (GLOO_BATCH, SMOKE_SPMD_SEQ)).astype(np.int32))
        for k in ("tokens", "labels")} for _ in range(GLOO_STEPS)]


def _gloo_rank(rank, world, path, out_dir, device):
    """One rank of phase 28: gemma3-1b SMOKE, this rank's rows of each
    batch, GLOO_STEPS AdamW steps per ``GLOO_CASES`` case on ``device``
    (cuda:0); saves its final params, slots and residual."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import shard_batch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world)
    try:
        cfg = get_arch("gemma3-1b").smoke_config
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        meshes = {"dp": Mesh((2, 1), ("data", "model")),
                  "pod": Mesh((2, 1, 1), ("pod", "data", "model"))}
        out = {}
        for strategy, codec in GLOO_CASES:
            mesh = meshes["pod" if strategy == "pbox_hier" else "dp"]
            step, space, ex = _smoke_spmd_step(
                cfg, mesh, strategy, codec, "adamw", 1, None,
                lambda p, b, d: T.lm_loss(p, b["tokens"], b["labels"], cfg))
            st = ex.init_slab_state(space, device=dev)
            state = [space.flatten(params).to(dev).reshape(1, -1),
                     tuple(s.reshape(1, -1) for s in st["slots"]),
                     st["ef"].reshape(1, -1) if st["ef"] is not None
                     else None, st["step"]]
            for b in _gloo_batches(cfg):
                mine = {k: v.to(dev) for k, v in
                        shard_batch(b, mesh, ex).items()}
                state[:4] = step(*state, mine)[:4]
            out[strategy] = {"pflat": state[0].cpu(),
                             "slots": [s.cpu() for s in state[1]],
                             "ef": state[2].cpu() if state[2] is not None
                             else None}
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def gloo_cuda_check(dev) -> dict:
    """Phase 28: 2 ranks in 2 processes on cuda:0 over gloo, each case
    against the same exchange done by hand in this process (each rank's
    gradient computed here under deterministic algorithms, the sums,
    codec and update in the exchange's order), bitwise."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import compression as comp
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.models import transformer as T
    from repro_torch.optim import optimizers as O
    from repro_torch.optim.schedules import linear_warmup

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    t0 = time.perf_counter()
    try:
        ctx = mp.start_processes(_gloo_rank, args=(2, f"{tmp}/rendezvous",
                                                   tmp, str(dev)),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError("gloo ranks on cuda:0 timed out")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    cfg = get_arch("gemma3-1b").smoke_config
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    space = ParamSpace.build(params, num_owners=2)
    spec = O.adamw(1e-3)
    codec = comp.CompressionConfig(codec="int8")
    with deterministic():
        want = {strategy: _gloo_by_hand(dev, cfg, params, space, spec, codec,
                                        strategy, linear_warmup(3))
                for strategy, _ in GLOO_CASES}
    for strategy, _ in GLOO_CASES:
        p, m, v, efs = want[strategy]
        n = p.shape[0] // 2
        for r, got in enumerate(ranks):
            out = got[strategy]
            lo, hi = (r * n, (r + 1) * n) if strategy == "pbox" else (0, 2 * n)
            pairs = [(out["pflat"][0], p)] + list(zip(
                [s[0] for s in out["slots"]], [m[lo:hi], v[lo:hi]]))
            if strategy == "pbox_hier":
                pairs.append((out["ef"][0], efs[r]))
            for a, b in pairs:
                if not same_bits(a, b):
                    raise AssertionError(
                        f"gloo on cuda:0, {strategy}: rank {r} differs from "
                        f"the exchange by hand, max |err| {max_abs_err(a, b)}")
    log(f"gloo on cuda:0: 2 ranks x {len(GLOO_CASES)} cases (pbox, allreduce,"
        f" pbox_hier int8 over 2 pods) == the exchange by hand, bitwise, in "
        f"{seconds:.1f} s")
    return {"seconds": seconds}


def _gloo_by_hand(dev, cfg, params, space, spec, codec, strategy, sched):
    """Phase 28's reference: both ranks' gradients here, then the
    exchange's arithmetic in its order; returns host (p, m, v, residuals)."""
    import torch

    from repro_torch.core import compression as comp
    from repro_torch.kernels.fused_agg_opt.ops import fused_aggregate_update
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import tracked_params

    p = space.flatten(params).to(dev)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    efs = [torch.zeros_like(p), torch.zeros_like(p)]
    for i, b in enumerate(_gloo_batches(cfg)):
        gs = []
        for r in range(2):
            leaf = p.detach().requires_grad_(True)
            rows = {k: val[r * 2:(r + 1) * 2].to(dev)
                    for k, val in b.items()}
            loss, _ = T.lm_loss(tracked_params(space, leaf),
                                rows["tokens"], rows["labels"], cfg)
            gs.append(torch.autograd.grad(loss, leaf)[0])
        if strategy == "pbox_hier":
            parts = []
            for r in range(2):
                payload, efs[r] = comp.encode(codec, gs[r] * 0.5, efs[r])
                parts.append(payload)
            g = comp.decode(codec, parts[0]) + comp.decode(codec, parts[1])
        else:
            g = (gs[0] + gs[1]) * 0.5
        step = torch.full((), i + 1, dtype=torch.int32, device=dev)
        p, (m, v) = fused_aggregate_update(g[None], p, (m, v), spec, step,
                                           sched(step), average=False)
    return p.cpu(), m.cpu(), v.cpu(), [e.cpu() for e in efs]


# -- phases 29 to 31: remat and chunking, the LM serving cells, tensor
# parallelism ---------------------------------------------------------------
REMAT_SEQ = 4096  # train_4k's published sequence length
TRAIN4K_BATCH, TRAIN4K_STEPS = 8, 3  # train_4k's 256 x 4096 cut to 8 x 4096
PREFILL_BATCH, DECODE_BATCH, DECODE_STEPS = 1, 16, 8  # from 32 and 128
TP_SEQ, TP_STEPS, TP_DECODE = 1024, 2, 8
# bf16 bounds of phase 31's tp = 2 run against tp = 1 on the card: the
# partial block outputs are rounded to bf16 before the sum over the model
# axis, which tp = 1 accumulates in f32 inside one product.  Every step
# trains on the same batch, so the step-2 loss reads the step-1 update.
# TP_LOSS_RTOL holds both steps' losses; TP_UPDATE_RTOL the worst leaf's
# ||d_tp2 - d_tp1|| / ||d_tp1||, d = params after the steps - params
# before.  A control run (tp = 2 with grad_sync off) must fail both
# bounds, a no-op step the update bound (it reads 1), and the step-1
# update must move the loss by more than the loss bound.  Set from the
# card's readings (H100, 700 W): losses 2.0e-5 / 1.5e-6 relative and the
# update 0.171 (wq) against the control's 4.6e-3 step-2 loss and 0.952
# (wk); a step's loss moves 0.131.
TP_LOSS_RTOL = 1e-4
TP_UPDATE_RTOL = 0.35


def _leaves(tree) -> list:
    """The leaves in key order (trees built in other orders line up)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def remat_path(dev, smoke: bool = False) -> dict:
    """Phase 29: gemma3-1b at full width, one 1 x 4096 ``lm_loss_and_grad``
    with remat off, then on (each twice, timed; peaks), their losses and
    gradients bitwise equal; then ``train_4k`` at 8 x 4096 through
    ``build_lm_train`` and the SPMD step (pbox, AdamW), in as many
    microbatches as the measured remat peak allows, TRAIN4K_STEPS steps.
    ``smoke``: the SMOKE config, 1 x 64 and the SMOKE train cell (the
    ``gpu`` test).  Call inside ``world_one`` and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_lm_train, make_exchange
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import init_train_state, local_state

    arch = get_arch("gemma3-1b")
    cfg = arch.smoke_config if smoke else arch.config
    if not (cfg.remat and cfg.attn_chunk == (8 if smoke else 1024)):
        raise AssertionError(f"gemma3-1b's config: remat {cfg.remat}, chunk "
                             f"{cfg.attn_chunk}")
    seq = 64 if smoke else REMAT_SEQ
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    b = next(lm_batches(cfg.vocab, 1, seq, 0))
    toks, labs = (torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels"))
    out = {}
    kept = None
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = []
        for _ in range(2):
            res = {}
            ms.append(timed(lambda: res.update(zip(
                ("loss", "grads"),
                T.lm_loss_and_grad(params, toks, labs, c)))))
        peak = torch.cuda.max_memory_allocated(dev) - base
        loss = res["loss"].item()
        if not math.isfinite(loss):
            raise AssertionError(f"remat {remat}: loss {loss}")
        if kept is None:
            kept = res
        else:
            if not same_bits(res["loss"], kept["loss"]) or not all(
                    same_bits(a, b) for a, b in zip(_leaves(res["grads"]),
                                                    _leaves(kept["grads"]))):
                raise AssertionError("remat on and off differ")
            kept = None
        out[f"remat_{'on' if remat else 'off'}"] = {
            "ms": ms, "peak_bytes": peak, "loss": loss}
        log(f"phase 29: 1 x {seq} lm_loss_and_grad remat={remat}: "
            f"{[round(x, 1) for x in ms]} ms, peak {peak / 2**30:.2f} GiB "
            f"above the weights, loss {loss:.4f}")
        del res
    log("phase 29: remat on == off bitwise (loss and every gradient)")
    del params, kept
    torch.cuda.empty_cache()

    # train_4k: microbatches from the remat peak (a row's activations),
    # beside the step's state: p, the accumulated gradient (bf16) and m, v
    n = cfg.param_count()
    state_bytes = n * (2 + 2 + 2 + 8) + 2 * n
    free = 0.85 * torch.cuda.get_device_properties(dev).total_memory
    rows = max(1, int((free - state_bytes) // out["remat_on"]["peak_bytes"]))
    rows = max(r for r in (1, 2, 4, 8) if r <= rows)
    mb = TRAIN4K_BATCH // rows
    mesh = make_mesh((1, 1), ("data", "model"))
    cell = ShapeCell("train_4k", "train", {"seq_len": REMAT_SEQ,
                                           "global_batch": TRAIN4K_BATCH})
    ex = make_exchange(mesh, "lm")
    plan = build_lm_train(
        dataclasses.replace(arch, microbatches={"train_4k": mb}), cell, mesh,
        ex, smoke=smoke)
    if smoke:
        mb = rows = plan.meta["microbatches"]
    if plan.meta["microbatches"] != mb:
        raise AssertionError(plan.meta)
    state = init_train_state(
        mesh, init_params_fn=lambda g: T.init_params(cfg, g),
        param_specs=T.make_param_specs(cfg, 1), exchange=ex,
        space=plan.meta["space"], n_groups=1,
        key=torch.Generator(device=dev).manual_seed(0),
        ps_dtype=cfg.param_dtype, device=dev)
    pflat, slots, ef, stc = local_state(state, mesh, ex)
    del state
    gb, s = plan.abstract_args[4]["tokens"].shape
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in bb.items()}
               for bb in itertools.islice(lm_batches(
                   cfg.vocab, gb, s, 0), TRAIN4K_STEPS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    losses, step_ms = [], []
    for bb in batches:
        res = {}
        step_ms.append(timed(lambda: res.update(
            zip(("p", "s", "e", "c", "m"), plan.fn(pflat, slots, ef, stc,
                                                    bb)))))
        pflat, slots, ef, stc = res["p"], res["s"], res["e"], res["c"]
        losses.append(res["m"]["loss"])
    launches = _counts()
    _check_counts("train_4k", launches, {"fused_agg_opt": TRAIN4K_STEPS})
    peak = torch.cuda.max_memory_allocated(dev)
    losses = finite_losses(losses)
    log(f"phase 29: train_4k {gb} x {s} in {mb} "
        f"microbatches of {rows}: steps {[round(x, 1) for x in step_ms]} ms, "
        f"losses {losses}, peak {peak / 2**30:.2f} GiB, launches {launches}")
    del pflat, slots, ef, batches
    torch.cuda.empty_cache()
    out["train_4k"] = {"step_ms": step_ms, "losses": losses,
                       "peak_bytes": peak, "launches": launches,
                       "microbatches": mb, "rows": rows}
    return out


def _random_cache(shapes: list, dev, seed: int, dtype) -> list:
    """Seeded caches of the given shapes, drawn layer by layer."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev, dtype=dtype)
            for s in shapes]


def serve_cells_path(dev, smoke: bool = False) -> dict:
    """Phase 30: the LM serving cells at tp = 1, world 1, through
    ``build_cell``'s plans: ``prefill_32k`` at 1 x 32768 (twice: the
    greedy ids equal), ``decode_32k`` at 16 x 32768 from a seeded cache,
    ``long_500k``'s unrolled decode from a seeded cache ending at
    position 524287.  ``smoke``: the SMOKE config and the plans' SMOKE
    shapes.  Call inside ``world_one``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T

    arch = get_arch("gemma3-1b")
    cfg = arch.smoke_config if smoke else arch.config
    mesh = make_mesh((1, 1), ("data", "model"))
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    out = _lm_serve("gemma3-1b", params, cfg, mesh, dev, smoke, DECODE_BATCH,
                    "phase 30: gemma3-1b")
    s = out["prefill_32k"]["seq"]
    unchunked = PREFILL_BATCH * cfg.n_heads * s * s * 4
    out["prefill_32k"]["unchunked_scores_bytes"] = unchunked
    log(f"phase 30: an unchunked layer's f32 scores alone at {s} tokens: "
        f"{unchunked / 2**30:.2f} GiB")
    gen = torch.Generator(device=dev).manual_seed(7)
    _zero_counts()

    plan = build_cell("gemma3-1b", "long_500k", mesh, smoke=smoke)
    s = plan.abstract_args[2][cfg.global_every - 1]["k"].shape[1]
    shapes = [c["k"].shape for c in plan.abstract_args[2]]
    caches = [{"k": k, "v": v} for k, v in zip(
        _random_cache(shapes, dev, 7, cfg.dtype),
        _random_cache(shapes, dev, 8, cfg.dtype))]
    tok = torch.randint(0, cfg.vocab, (1,), generator=gen, device=dev,
                        dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for i in range(DECODE_STEPS):
        res = {}
        pos = s - DECODE_STEPS + i
        ms.append(timed(lambda: res.update(zip(("ids", "caches"), plan.fn(
            params, tok, caches, pos)))))
        tok = res["ids"]
    if not ((tok >= 0) & (tok < cfg.vocab)).all():
        raise AssertionError(f"long_500k: ids {tok}")
    peak = torch.cuda.max_memory_allocated(dev)
    cache_bytes = sum(2 * c["k"].numel() * c["k"].element_size()
                      for c in caches)
    out["long_500k"] = {"ms": ms, "peak_bytes": peak, "seq": s,
                        "cache_bytes": cache_bytes,
                        "last_pos": s - 1}
    log(f"phase 30: long_500k 1 x {s} unrolled ({cache_bytes / 2**30:.2f} GiB "
        f"of caches), positions {s - DECODE_STEPS}..{s - 1}: steps "
        f"{[round(x, 2) for x in ms]} ms, peak {peak / 2**30:.2f} GiB")
    _check_counts("serving cells", _counts(), {})
    del caches, params
    torch.cuda.empty_cache()
    return out


class _CollectiveClock:
    """Host ms and calls of a mesh's collectives over the model axis (gloo
    on CUDA tensors stages through the host, so each call has ended when
    it returns)."""

    def __init__(self, mesh):
        self.ms, self.calls = 0.0, 0
        for name in ("psum", "psum_scatter", "all_gather"):
            real = getattr(mesh, name)
            setattr(mesh, name, self._wrap(real))

    def _wrap(self, real):
        def call(x, axes, *a, **kw):
            if axes != "model":
                return real(x, axes, *a, **kw)
            t0 = time.perf_counter()
            y = real(x, axes, *a, **kw)
            self.ms += (time.perf_counter() - t0) * 1e3
            self.calls += 1
            return y
        return call


def _tp_batches(cfg, batch: int, seq: int, steps: int, seed: int):
    import torch

    from repro_torch.data.synthetic import lm_batches

    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in itertools.islice(lm_batches(cfg.vocab, batch, seq, seed),
                                      steps)]


def _tp_train_and_serve(cfg, mesh, dev, clock=None,
                        grad_sync: bool = True,
                        variant: str | None = None) -> dict:
    """TP_STEPS pbox AdamW steps of one 1 x TP_SEQ batch through
    ``build_lm_train`` on ``mesh``, then a 1 x TP_SEQ prefill and
    TP_DECODE greedy steps with the trained local params; the rank's
    losses, step ms, peak, local params (on the host) and ids.
    ``grad_sync=False`` is the control: every sync tag "none" and no
    serving.  ``variant="sp"``: sequence parallelism, no serving (prefill
    and decode ignore it)."""
    from unittest import mock

    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch.steps import build_lm_train, make_exchange
    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.runtime.trainer import (
        _tree_map,
        init_train_state,
        local_state,
    )

    arch = get_arch("gemma3-1b")
    tp = mesh.shape["model"]
    cell = ShapeCell("train_1k", "train", {"seq_len": TP_SEQ,
                                           "global_batch": 1})
    ex = make_exchange(mesh, "lm")
    tags = T.grad_sync(cfg, tp)
    with (contextlib.nullcontext() if grad_sync else mock.patch.object(
            T, "grad_sync", lambda *_: _tree_map(lambda _: "none", tags))):
        plan = build_lm_train(dataclasses.replace(arch, config=cfg), cell,
                              mesh, ex, variant=variant)
    state = init_train_state(
        mesh, init_params_fn=lambda g: T.init_params(cfg, g, tp=tp),
        param_specs=T.make_param_specs(cfg, tp), exchange=ex,
        space=plan.meta["space"], n_groups=tp,
        key=torch.Generator(device=dev).manual_seed(0),
        ps_dtype=cfg.param_dtype, device=dev)
    pflat, slots, ef, stc = local_state(state, mesh, ex)
    # copies: the views would keep every group's state alive
    pflat, slots = pflat.clone(), tuple(s.clone() for s in slots)
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms, coll_ms, coll_calls = [], [], [], []
    _zero_counts()
    for b in _tp_batches(cfg, 1, TP_SEQ, 1, 0) * TP_STEPS:
        res = {}
        before = (clock.ms, clock.calls) if clock else (0.0, 0)
        step_ms.append(timed(lambda: res.update(zip(
            ("p", "s", "e", "c", "m"),
            plan.fn(pflat, slots, ef, stc, {k: v.to(dev)
                                           for k, v in b.items()})))))
        coll_ms.append((clock.ms - before[0]) if clock else 0.0)
        coll_calls.append((clock.calls - before[1]) if clock else 0)
        pflat, slots, ef, stc = res["p"], res["s"], res["e"], res["c"]
        losses.append(res["m"]["loss"].item())
    launches = _counts()
    _check_counts(f"tp = {tp}", launches, {"fused_agg_opt": TP_STEPS})
    peak = torch.cuda.max_memory_allocated(dev)
    params = plan.meta["space"].unflatten(pflat[0])
    if not grad_sync or variant is not None:
        return {"losses": losses, "params": _tree_to(params, "cpu"),
                "step_ms": step_ms, "coll_ms": coll_ms,
                "coll_calls": coll_calls, "peak_bytes": peak,
                "launches": launches}
    dist = Dist("model", ("data",), tp, mesh) if tp > 1 else None
    prompt = _tp_batches(cfg, 1, TP_SEQ, 1, 9)[0]["tokens"].to(dev)
    max_seq = TP_SEQ + TP_DECODE
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = T.prefill(params, prompt, cfg, max_seq, dist=dist)
        ids = [nxt]
        for i in range(TP_DECODE):
            nxt, cache = T.decode_step(params, nxt, cache, TP_SEQ + i, cfg,
                                       dist)
            ids.append(nxt)
        torch.cuda.synchronize()
        serve_ms = (time.perf_counter() - t0) * 1e3
    return {"losses": losses, "step_ms": step_ms, "coll_ms": coll_ms,
            "coll_calls": coll_calls, "peak_bytes": peak,
            "params": _tree_to(params, "cpu"),
            "ids": torch.stack(ids, 1).cpu(),
            "serve_ms": serve_ms, "launches": launches}


def _smoke_tp_run(cfg, mesh, dev) -> dict:
    """gemma3-1b SMOKE at ``mesh``'s model axis: the loss of a seeded
    4 x 16 batch, then greedy prefill (max_seq 32) and 6 decode steps."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.models.common import Dist
    from repro_torch.runtime.trainer import local_params

    tp = mesh.shape["model"] if mesh is not None else 1
    dist = Dist("model", ("data",), tp, mesh) if tp > 1 else None
    params = T.init_params(cfg, torch.Generator().manual_seed(0), tp=tp)
    if tp > 1:
        params = local_params(params, T.make_param_specs(cfg, tp), mesh)
    params = _tree_to(params, dev)
    b = _tp_batches(cfg, 4, 16, 1, 3)[0]
    toks, labs = b["tokens"].to(dev), b["labels"].to(dev)
    with torch.no_grad():
        loss = T.lm_loss(params, toks, labs, cfg, dist)[1]["ce"]
        nxt, cache = T.prefill(params, toks, cfg, 32, dist=dist)
        ids = [nxt]
        for i in range(6):
            nxt, cache = T.decode_step(params, nxt, cache, 16 + i, cfg, dist)
            ids.append(nxt)
    return {"loss": loss.item(), "ids": torch.stack(ids, 1).cpu()}


def _tp_rank(rank, world, path, out_dir, device, smoke):
    """One rank of phase 31 on ``device`` (cuda:0) over gloo: at world 2,
    gemma3-1b at full width on a (1, 2) mesh (``_tp_train_and_serve``:
    without and with sequence parallelism, each beside its control); at
    world 4, the SMOKE config on (1, 4) and (2, 2) meshes
    (``_smoke_tp_run``) and EquiformerV2's SMOKE ``full_graph_sm`` on a
    (2, 2) mesh (``_gnn_tp_steps``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import Mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world)
    try:
        arch = get_arch("gemma3-1b")
        if world == 2:
            mesh = Mesh((1, 2), ("data", "model"))
            clock = _CollectiveClock(mesh)
            cfg = arch.smoke_config if smoke else arch.config
            out = _tp_train_and_serve(cfg, mesh, dev, clock)
            torch.cuda.empty_cache()
            out["control"] = _tp_train_and_serve(cfg, mesh, dev,
                                                 grad_sync=False)
            # the same steps with sequence parallelism, and their control
            for key, sync in (("sp", True), ("sp_control", False)):
                torch.cuda.empty_cache()
                out[key] = _tp_train_and_serve(cfg, mesh, dev, clock, sync,
                                               variant="sp")
            # phase 36's tp = 2 pass on the same 2 ranks (saves a spawn)
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            out["rs"] = _rs_gloo_steps(mesh, dev, world)
            out["rs"].update(model=mesh.coords["model"],
                             seconds=time.perf_counter() - t0)
            # phase 45's serve_lm at its --mesh 1x2 on the same 2 ranks,
            # and train_distributed_ps at tp = 1 (its (2, 2) run's control)
            out["ex_serve_lm"] = _ex_rank(dev, "serve_lm", out_dir)
            out["ex_train_ps_tp1"] = _ex_rank(
                dev, "train_distributed_ps", out_dir, EX_PS_TP1_MESH)
        else:
            out = {f"tp{m}": _smoke_tp_run(arch.smoke_config, Mesh(
                (world // m, m), ("data", "model")), dev) for m in (4, 2)}
            # and the GNN's channel TP and edge parallelism (phase 43)
            mesh = Mesh((2, 2), ("data", "model"))
            out["gnn"] = _gnn_tp_steps(mesh, dev)
            out["model"] = mesh.coords["model"]
            # phase 45's train_distributed_ps on a (2, 2) mesh
            out["ex_train_ps"] = _ex_rank(dev, "train_distributed_ps",
                                          out_dir)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _ex_rank(dev, name: str, out_dir, mesh: tuple | None = None) -> dict:
    """One rank's run of a multi-rank example program inside phase 31's
    gloo group on ``dev``: ``serve_lm`` at its ``--mesh 1x2``, or
    ``train_distributed_ps`` on ``mesh`` (EX_PS_MESH unless given; its
    (2, 4) needs 8 ranks), checkpointing under ``out_dir``; this rank's
    counts set to 0 just before and read just after."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.examples import serve_lm, train_distributed_ps

    t0 = time.perf_counter()
    with redirect_stdout(io.StringIO()):
        _zero_counts()
        if name == "serve_lm":
            res = serve_lm.main(device=dev)
            out = {"generated": res["generated"].tolist(),
                   "version": res["read"]["version"]}
        else:
            mesh = mesh or EX_PS_MESH
            res = train_distributed_ps.main(
                device=dev, mesh_shape=mesh,
                ckpt_dir=str(Path(out_dir) / "ex_ckpt_{}x{}".format(*mesh)))
            out = {k: res[k] for k in ("losses", "loss_after_restart",
                                       "restart_step", "step")}
            out["restored_is_saved"] = res["saved"].keys() == \
                res["restored"].keys() and all(
                    same_bits(res["saved"][k], res["restored"][k])
                    for k in res["saved"])
        out["launches"] = _counts()
    out["seconds"] = time.perf_counter() - t0
    return out


def ex_ranks_check(dev, serve_ranks: list, ps_ranks: list,
                   tp1_ranks: list) -> dict:
    """Phase 45's multi-rank examples, read from phase 31's ranks:
    ``serve_lm``'s 2 ranks generate the ids (and read the version) of the
    same program at ``--mesh 1x1`` on the card; ``train_distributed_ps``'s
    4 ranks (EX_PS_MESH) and its 2 ranks at tp = 1 (EX_PS_TP1_MESH: the
    same workers, so the same global batch) each agree among themselves,
    every loss of the curve (the 4 printed and the one after the restart)
    at tp = 2 within EX_PS_RTOL of tp = 1's, each rank restored the state
    it saved at step 20 bitwise, and each launched fused_agg_opt once a
    step (K = 1, the owned slab)."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.examples import serve_lm

    with redirect_stdout(io.StringIO()), deterministic():
        one = serve_lm.main(["--mesh", "1x1"], device=dev)
    for r, got in enumerate(serve_ranks):
        if got["generated"] != one["generated"].tolist() or \
                got["version"] != one["read"]["version"]:
            raise AssertionError(
                f"serve_lm rank {r} at 1 x 2: ids {got['generated']} version"
                f" {got['version']} against 1 x 1 "
                f"{one['generated'].tolist()} {one['read']['version']}")
    for mesh, group in ((EX_PS_MESH, ps_ranks), (EX_PS_TP1_MESH, tp1_ranks)):
        for r, got in enumerate(group):
            if got["losses"] != group[0]["losses"] or \
                    got["loss_after_restart"] != group[0]["loss_after_restart"]:
                raise AssertionError(
                    f"train_distributed_ps ranks on {mesh} disagree: "
                    f"{[g['losses'] for g in group]}")
            if not got["restored_is_saved"] or got["restart_step"] != 20:
                raise AssertionError(f"train_distributed_ps rank {r} on "
                                     f"{mesh}: the restored state is not "
                                     "the saved one")
            _check_counts(f"train_distributed_ps rank {r} on {mesh}",
                          got["launches"], {"fused_agg_opt": got["step"]})
    curve, tp1 = ([g["losses"][i] for i in range(len(g["losses"]))]
                  + [g["loss_after_restart"]]
                  for g in (ps_ranks[0], tp1_ranks[0]))
    if not all(math.isfinite(x) for x in curve + tp1):
        raise AssertionError(f"train_distributed_ps: {curve} {tp1}")
    rel = [abs(a - b) / abs(b) for a, b in zip(curve, tp1)]
    if max(rel) > EX_PS_RTOL:
        raise AssertionError(f"train_distributed_ps on {EX_PS_MESH}: losses "
                             f"{curve} against tp = 1's {tp1} (rel {rel}, "
                             f"bound {EX_PS_RTOL})")
    moved = abs(tp1[1] - tp1[0]) / abs(tp1[0])  # five updates' worth
    if not moved > EX_PS_RTOL:
        raise AssertionError(f"the check cannot tell a faulty update: five "
                             f"steps move the loss by rel {moved} (bound "
                             f"{EX_PS_RTOL})")
    ps0 = ps_ranks[0]
    every = serve_ranks + ps_ranks + tp1_ranks
    launches = {k: sum(g["launches"][k] for g in every)
                for k in ps0["launches"]}
    log(f"phase 45 (in phase 31's ranks): serve_lm at --mesh 1x2 over 2 gloo"
        f" ranks on cuda:0 == --mesh 1x1 (ids {one['generated'].shape}, "
        f"version {one['read']['version']}; {serve_ranks[0]['seconds']:.1f}"
        f" s); train_distributed_ps on a {EX_PS_MESH} mesh over 4 ranks: "
        f"losses {curve} (the last after the restart) against tp = 1 "
        f"({EX_PS_TP1_MESH} over 2 ranks) {tp1}: rel {rel} (bound "
        f"{EX_PS_RTOL}; steps 6-10 move tp = 1's loss by rel {moved:.3g}); "
        f"restarted from step 20 with the saved state bitwise on every "
        f"rank; fused_agg_opt {ps0['step']} launches a rank "
        f"({ps0['seconds']:.1f} s; tp = 1 {tp1_ranks[0]['seconds']:.1f} s)")
    return {"serve_ids_shape": list(one["generated"].shape),
            "ps_losses": ps0["losses"],
            "ps_loss_after_restart": ps0["loss_after_restart"],
            "ps_tp1_curve": tp1, "ps_rel": rel,
            "launches": launches,
            "launches_serve": {k: sum(g["launches"][k] for g in serve_ranks)
                               for k in launches},
            "launches_train_ps": {k: sum(g["launches"][k]
                                         for g in ps_ranks + tp1_ranks)
                                  for k in launches}}


def _spawn_tp(world: int, dev, smoke: bool = False) -> tuple:
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    if dev.type == "cuda" and dev.index is None:  # the ranks need an index
        dev = torch.device("cuda", torch.cuda.current_device())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    t0 = time.perf_counter()
    try:
        ctx = mp.start_processes(_tp_rank, args=(world, f"{tmp}/rendezvous",
                                                 tmp, str(dev), smoke),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + 400
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError(f"{world} tp ranks on cuda:0 timed out")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ranks, time.perf_counter() - t0


def _tp_global(cfg, tp: int, trees: list) -> dict:
    """The global tree of tp model groups' local trees: each leaf's group
    pieces joined along the dimension its spec shards."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import _tree_map

    def join(spec, *xs):
        for i, s in enumerate(spec):
            if s == "model":
                return torch.cat(xs, dim=i)
        return xs[0]

    return _tree_map(join, T.make_param_specs(cfg, tp), *trees)


def _named_leaves(tree, prefix: str = "") -> list:
    """(name, leaf) pairs in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _update_err(p0, ref, got, dev) -> tuple[float, str]:
    """The worst leaf's ||d_got - d_ref|| / ||d_ref||, d = the leaf after
    the steps - the leaf before (``p0``), in f32 on the card; and its name.
    A leaf that did not move in ``ref`` reads inf."""
    import torch

    worst = (0.0, "")
    for (name, a0), (_, a1), (_, a2) in zip(
            *(_named_leaves(t) for t in (p0, ref, got))):
        x0 = a0.to(dev, torch.float32)
        d1 = a1.to(dev, torch.float32) - x0
        d2 = a2.to(dev, torch.float32) - x0
        rel = (torch.linalg.vector_norm(d2 - d1)
               / torch.linalg.vector_norm(d1)).item()
        worst = max(worst, (rel if math.isfinite(rel) else math.inf, name))
    return worst


def tp_path(dev, smoke: bool = False) -> dict:
    """Phase 31: tensor parallelism on the one card.  2 gloo ranks on
    cuda:0, mesh (1, 2), gemma3-1b at full width: TP_STEPS train steps on
    one 1 x TP_SEQ batch, a prefill and TP_DECODE decode steps, against
    the same seeded model at tp = 1 (world-1 NCCL) on the card: each
    step's loss within TP_LOSS_RTOL, the update of every leaf within
    TP_UPDATE_RTOL, which the control run (grad_sync off, whose step-2
    loss must also miss) and a no-op step (reading 1) must exceed, the
    share of greedy ids that agree.  The same train steps with sequence
    parallelism (``variant="sp"``) hold to tp = 1 at the same bounds,
    which their own control must miss, and are set beside the tp = 2
    run without it (the worst leaf; bitwise or not).  Then
    the SMOKE config on 4 gloo ranks at tp = 4 and tp = 2, against tp = 1
    on the card at rtol 2e-5 / atol 1e-5, ids equal.  ``smoke``: the
    2-rank runs at the SMOKE config too (the ``gpu`` test)."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T

    arch = get_arch("gemma3-1b")
    cfg = arch.smoke_config if smoke else arch.config
    torch.cuda.empty_cache()
    ranks, seconds = _spawn_tp(2, dev, smoke)
    with world_one(dev), deterministic():
        ref = _tp_train_and_serve(cfg, make_mesh((1, 1), ("data", "model")),
                                  dev)
    for r, got in enumerate(ranks):
        if got["losses"] != ranks[0]["losses"] or not torch.equal(
                got["ids"], ranks[0]["ids"]):
            raise AssertionError(f"tp ranks disagree: {got['losses']}")
    l2, l1 = ranks[0]["losses"], ref["losses"]
    lc = ranks[0]["control"]["losses"]
    # the seeded model both runs start from (init_train_state's draw)
    p0 = _tree_to(T.init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(0)), "cpu")
    g1 = ref["params"]
    g2 = _tp_global(cfg, 2, [r["params"] for r in ranks])
    upd, upd_leaf = _update_err(p0, g1, g2, dev)
    # sequence parallelism: against tp = 1 (the same bounds), and against
    # tp = 2 without it (the worst leaf, and whether every leaf is bitwise)
    gs = _tp_global(cfg, 2, [r["sp"]["params"] for r in ranks])
    sp_upd, sp_leaf = _update_err(p0, g1, gs, dev)
    sp_vs, sp_vs_leaf = _update_err(p0, g2, gs, dev)
    sp_abs, sp_bitwise = 0.0, True
    for (_, a), (_, b) in zip(_named_leaves(g2), _named_leaves(gs)):
        sp_abs = max(sp_abs, max_abs_err(a.to(dev), b.to(dev)))
        sp_bitwise = sp_bitwise and same_bits(a, b)
    del g2, gs
    gc = _tp_global(cfg, 2, [r["control"]["params"] for r in ranks])
    ctl, ctl_leaf = _update_err(p0, g1, gc, dev)
    del gc
    gsc = _tp_global(cfg, 2, [r["sp_control"]["params"] for r in ranks])
    sp_ctl, sp_ctl_leaf = _update_err(p0, g1, gsc, dev)
    del gsc, p0
    ls, lsc = ranks[0]["sp"]["losses"], ranks[0]["sp_control"]["losses"]
    if any(r["sp"]["losses"] != ls for r in ranks):
        raise AssertionError(f"sp ranks disagree: {[r['sp']['losses'] for r in ranks]}")
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(l2, l1)]
    ctl_loss_rel = [abs(a - b) / abs(b) for a, b in zip(lc, l1)]
    sp_loss_rel = [abs(a - b) / abs(b) for a, b in zip(ls, l1)]
    sp_ctl_loss_rel = [abs(a - b) / abs(b) for a, b in zip(lsc, l1)]
    runs = {"tp = 2": ranks[0], "tp = 2 control": ranks[0]["control"],
            "tp = 2 sp": ranks[0]["sp"],
            "tp = 2 sp control": ranks[0]["sp_control"], "tp = 1": ref}
    log(f"phase 31 runs (rank 0; gemma3-1b {'SMOKE' if smoke else 'full'}"
        f" width, 1 x {TP_SEQ}, {TP_STEPS} steps): " + "; ".join(
            f"{label} steps {[round(x, 1) for x in run['step_ms']]} ms, "
            f"peak {run['peak_bytes'] / 2**30:.2f} GiB"
            for label, run in runs.items()))
    moved = abs(l1[1] - l1[0]) / abs(l1[0])  # what a no-op step leaves out
    agree = (ranks[0]["ids"] == ref["ids"]).float().mean().item()
    log(f"phase 31: gemma3-1b tp = 2 over 2 gloo ranks on cuda:0: losses {l2}"
        f" against tp = 1 {l1}: rel {loss_rel} (bound {TP_LOSS_RTOL}; the "
        f"step-1 update moves tp = 1's loss by rel {moved:.3g}); update after "
        f"{TP_STEPS} steps: worst leaf {upd_leaf} at {upd:.4g} (bound "
        f"{TP_UPDATE_RTOL}); control (grad_sync off): losses {lc} rel "
        f"{ctl_loss_rel}, worst leaf {ctl_leaf} at {ctl:.4g}; greedy "
        f"ids agree {agree:.3f}; steps {[round(x, 1) for x in ranks[0]['step_ms']]}"
        f" ms (model-axis collectives {[round(x, 1) for x in ranks[0]['coll_ms']]}"
        f" ms in {ranks[0]['coll_calls']} calls), tp = 1 steps "
        f"{[round(x, 1) for x in ref['step_ms']]} ms; prefill + {TP_DECODE}"
        f" decode steps {ranks[0]['serve_ms']:.1f} ms (tp = 1 "
        f"{ref['serve_ms']:.1f}); {seconds:.1f} s")
    if not all(math.isfinite(x) for x in l2 + l1) or \
            max(loss_rel) > TP_LOSS_RTOL:
        raise AssertionError(f"tp = 2 losses {l2} against tp = 1 {l1}")
    if upd > TP_UPDATE_RTOL:
        raise AssertionError(f"tp = 2 update differs from tp = 1's: {upd_leaf}"
                             f" at {upd} (bound {TP_UPDATE_RTOL})")
    log(f"phase 31: tp = 2 with sequence parallelism (variant sp): losses "
        f"{ls} against tp = 1: rel {sp_loss_rel} (bound {TP_LOSS_RTOL}); "
        f"update: worst leaf {sp_leaf} at {sp_upd:.4g} (bound "
        f"{TP_UPDATE_RTOL}); against tp = 2 without sp: worst leaf "
        f"{sp_vs_leaf} at {sp_vs:.4g}, max |diff| {sp_abs:.4g}, "
        f"{'bitwise' if sp_bitwise else 'not bitwise'}; its control "
        f"(grad_sync off): losses {lsc} rel {sp_ctl_loss_rel}, worst leaf "
        f"{sp_ctl_leaf} at {sp_ctl:.4g}")
    if not all(math.isfinite(x) for x in ls) or \
            max(sp_loss_rel) > TP_LOSS_RTOL:
        raise AssertionError(f"tp = 2 sp losses {ls} against tp = 1 {l1}")
    if sp_upd > TP_UPDATE_RTOL:
        raise AssertionError(f"tp = 2 sp update differs from tp = 1's: "
                             f"{sp_leaf} at {sp_upd} (bound {TP_UPDATE_RTOL})")
    if not sp_ctl > TP_UPDATE_RTOL or not max(sp_ctl_loss_rel) > TP_LOSS_RTOL:
        raise AssertionError(
            f"the checks cannot tell a faulty sp step: control update "
            f"{sp_ctl}, control loss rel {sp_ctl_loss_rel}")
    if not ctl > TP_UPDATE_RTOL or not 1.0 > TP_UPDATE_RTOL or \
            not max(ctl_loss_rel) > TP_LOSS_RTOL or not moved > TP_LOSS_RTOL:
        raise AssertionError(
            f"the checks cannot tell a faulty step: control update {ctl}, "
            f"no-op update 1.0 (bound {TP_UPDATE_RTOL}); control loss rel "
            f"{ctl_loss_rel}, a no-op step's {moved} (bound {TP_LOSS_RTOL})")
    full = {"losses_tp2": l2, "losses_tp1": l1, "losses_control": lc,
            "loss_rel": loss_rel, "control_loss_rel": ctl_loss_rel,
            "loss_moved": moved, "loss_bound": TP_LOSS_RTOL,
            "update_err": upd, "update_leaf": upd_leaf,
            "control_update_err": ctl, "control_update_leaf": ctl_leaf,
            "update_bound": TP_UPDATE_RTOL, "ids_agree": agree,
            "step_ms_tp2": ranks[0]["step_ms"], "step_ms_tp1": ref["step_ms"],
            "coll_ms": ranks[0]["coll_ms"], "coll_calls": ranks[0]["coll_calls"],
            "serve_ms_tp2": ranks[0]["serve_ms"], "serve_ms_tp1": ref["serve_ms"],
            "seconds": seconds, "launches_tp1": ref["launches"],
            "launches_tp2": {k: sum(r["launches"][k] for r in ranks)
                             for k in ref["launches"]},
            "launches_tp2_sp": {k: sum(r["sp"]["launches"][k] for r in ranks)
                                for k in ref["launches"]},
            "losses_sp": ls, "sp_loss_rel": sp_loss_rel,
            "sp_update_err": sp_upd, "sp_update_leaf": sp_leaf,
            "sp_vs_tp2_err": sp_vs, "sp_vs_tp2_leaf": sp_vs_leaf,
            "sp_vs_tp2_max_abs": sp_abs, "sp_vs_tp2_bitwise": sp_bitwise,
            "sp_control_update_err": sp_ctl,
            "sp_control_loss_rel": sp_ctl_loss_rel,
            "step_ms_sp": ranks[0]["sp"]["step_ms"],
            "peak_bytes": {label: run["peak_bytes"]
                           for label, run in runs.items()},
            "rs_ranks": [r["rs"] for r in ranks]}
    serve_ranks = [r["ex_serve_lm"] for r in ranks]
    ps_tp1_ranks = [r["ex_train_ps_tp1"] for r in ranks]
    del g1, ranks, ref
    torch.cuda.empty_cache()

    ranks, seconds = _spawn_tp(4, dev)
    one = _smoke_tp_run(arch.smoke_config, None, dev)
    for r, got in enumerate(ranks):
        for key, run in got.items():
            if not key.startswith("tp"):
                continue
            if not math.isclose(run["loss"], one["loss"], rel_tol=2e-5,
                                abs_tol=1e-5) or not torch.equal(
                                    run["ids"], one["ids"]):
                raise AssertionError(
                    f"SMOKE {key} rank {r}: loss {run['loss']} ids "
                    f"{run['ids'].tolist()} against tp = 1 {one['loss']} "
                    f"{one['ids'].tolist()}")
    log(f"phase 31: SMOKE tp = 4 and tp = 2 over 4 gloo ranks on cuda:0 == "
        f"tp = 1 (loss {one['loss']:.6f} at rtol 2e-5 / atol 1e-5, prefill "
        f"and 6 decode ids equal) in {seconds:.1f} s")
    full["smoke_seconds"] = seconds
    full["gnn"] = gnn_tp_check(ranks, dev)
    full["examples"] = ex_ranks_check(
        dev, serve_ranks, [r["ex_train_ps"] for r in ranks],
        ps_tp1_ranks)
    return full


# -- phases 32 to 36: the recsys family on the SPMD path ---------------------
# phase 32: dlrm-mlperf train_batch by pbox_sparse, RS_STEPS steps, the
# table update of step RS_BOOK + 1 booked on the card and replayed on the
# CPU (the steps after it are the steady ones)
RS_STEPS, RS_BOOK = 4, 1
# phase 33: the dense (pbox) step's row cap.  Its flat holds the tables, and
# the step peaks at ~5.0x the flat (the params, the gradient, the scattered
# slab and its x 1/nw product, the pulled flat): 35.86 GiB at a 2.5M cap
# (a 7.15 GiB flat) on an H100 80GB HBM3, so a 4M cap (10.72 GiB) is
# predicted at ~53.7 GiB and 5M (13.11 GiB) at ~65.7, too near the card
RS_DENSE_CAP = 4_000_000
# tests/scripts/sparse_push_equivalence.py's bounds: dense against sparse
RS_LOSS_ATOL, RS_MLP_RTOL, RS_MLP_ATOL, RS_TABLE_ATOL = 1e-6, 1e-5, 1e-6, 5e-3
# phase 36: card against the CPU, and tp = 2 against tp = 1 (the CPU tests'
# bound: f32 matmuls and reductions sum in other orders)
RS_CARD_RTOL, RS_CARD_ATOL = 1e-5, 1e-6
# phase 35: the rows of the probe step whose peak sizes each train batch,
# and the share of the card's memory a batch may take
RS_PROBE, RS_MEM_SHARE = 2048, 0.75
RS_ARCHS = ("dlrm-mlperf", "autoint", "dien", "xdeepfm")
RS_CELLS = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


def _rs_batches(arch_id: str, cfg, b: int, n: int, seed: int, dev,
                labels: bool = True) -> list:
    """``n`` batches of ``b`` rows of ``recsys_batches`` on ``dev``."""
    import torch

    from repro_torch.data.synthetic import recsys_batches

    return [{k: torch.from_numpy(v).to(dev) for k, v in bb.items()
             if labels or k != "labels"}
            for bb in itertools.islice(recsys_batches(arch_id, cfg, b, seed),
                                       n)]


def _rs_retrieval_batch(arch_id: str, cfg, plan, dev, seed: int) -> dict:
    """The plan's user rows and its candidates over table t0's rows."""
    import torch

    bt = plan.abstract_args[1]
    batch = _rs_batches(arch_id, cfg, bt["sparse"].shape[0], 1, seed, dev,
                        labels=False)[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch["cand_ids"] = torch.randint(
        0, cfg.vocabs[0], tuple(bt["cand_ids"].shape), generator=gen,
        device=dev, dtype=torch.int32)
    return batch


def _dlrm_arch(cfg):
    from repro_torch.configs.registry import get_arch

    return dataclasses.replace(get_arch("dlrm-mlperf"), config=cfg)


def _sparse_bytes(batch: dict, cfg) -> int:
    """The sparse push's wire bytes a step: every id (int32) and its bf16
    cotangent row, global batch x F x (2D + 4)."""
    b, f = batch["sparse"].shape
    return b * f * (2 * cfg.embed_dim + 4)


def _rs_step_times(step, state: list, batches: list) -> tuple:
    """Run ``step`` over the batches, threading ``state`` (its first
    outputs); (host ms a step, losses, the final state)."""
    ms, losses = [], []
    n = len(state)
    for b in batches:
        res = {}
        ms.append(timed(lambda: res.update(out=step(*state, b))))
        state = list(res["out"][:n])
        losses.append(res["out"][-1]["loss"])
    return ms, finite_losses(losses), state


def rs_sparse_path(dev, smoke: bool = False) -> dict:
    """Phase 32: dlrm-mlperf ``train_batch`` by ``pbox_sparse`` at full
    width (tables capped at DLRM_ROW_CAP rows), batch 65,536, world 1 over
    NCCL, RS_STEPS steps.  The dense MLPs go through the exchange (one
    fused_agg_opt a step), the tables through ``sparse_table_update``;
    the update of step RS_BOOK + 1 is booked on the card (ids, cotangents,
    lr, and every touched row before and after) and replayed on the CPU
    through the same function, bitwise.  Returns the trained params for
    phase 34.  ``smoke``: the SMOKE config and cell.  Call inside
    ``world_one`` and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.fabric import ServerStats
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_recsys_train_sparse
    from repro_torch.models.common import Dist
    from repro_torch.models.recsys import models as RS
    from repro_torch.runtime import sparse_push as SP
    from repro_torch.runtime.trainer import attach_telemetry

    cfg = get_arch("dlrm-mlperf").smoke_config if smoke else \
        dlrm_capped_config()
    arch = _dlrm_arch(cfg)
    mesh = make_mesh((1, 1), ("data", "model"))
    plan = build_recsys_train_sparse(arch, arch.cell("train_batch"), mesh,
                                     smoke=smoke)
    space, ex = plan.meta["space"], plan.meta["exchange"]
    b = plan.abstract_args[5]["sparse"].shape[0]
    params = RS.dlrm_init(cfg, torch.Generator(device=dev).manual_seed(0))
    tables = params.pop("tables")
    table_bytes = sum(t.numel() * t.element_size() for t in tables.values())
    pflat = space.flatten(params).reshape(1, -1)
    del params
    batches = _rs_batches("dlrm-mlperf", cfg, b, RS_STEPS, 0, dev)
    stats = ServerStats()
    step = attach_telemetry(plan.fn, ex, space, mesh, stats)
    book = {"calls": 0}
    real = SP.sparse_table_update

    def booked(tabs, ids, cot_e, dist, wa, lr, wire_dtype=torch.bfloat16, *,
               mesh=None):
        call = book["calls"]
        book["calls"] += 1
        if call != RS_BOOK:
            return real(tabs, ids, cot_e, dist, wa, lr, wire_dtype, mesh=mesh)
        uniq = [torch.unique(ids[:, i].long()) for i in range(ids.shape[1])]
        book["in"] = {"ids": ids.cpu(), "cot": cot_e.cpu(), "lr": lr,
                      "uniq": [u.cpu() for u in uniq],
                      "before": [tabs[f"t{i}"][u].cpu()
                                 for i, u in enumerate(uniq)]}
        out = real(tabs, ids, cot_e, dist, wa, lr, wire_dtype, mesh=mesh)
        book["after"] = [out[f"t{i}"][u].cpu() for i, u in enumerate(uniq)]
        return out

    SP.sparse_table_update = booked
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        step_ms, losses, state = _rs_step_times(
            step, [pflat, (), None, torch.zeros((), dtype=torch.int32,
                                                device=dev), tables], batches)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        SP.sparse_table_update = real
    _check_counts("rs sparse", launches, {"fused_agg_opt": RS_STEPS})
    pflat, tables = state[0], state[4]
    # the CPU replay: the touched rows as compact tables, the ids remapped
    i = book["in"]
    compact = {f"t{k}": r.clone() for k, r in enumerate(i["before"])}
    ids_c = torch.stack([torch.searchsorted(u, i["ids"][:, k].long())
                         for k, u in enumerate(i["uniq"])], 1)
    replay = real(compact, ids_c, i["cot"], Dist(), (), i["lr"])
    rows, err = 0, 0.0
    for k, after in enumerate(book["after"]):
        got = replay[f"t{k}"]
        rows += got.shape[0]
        err = max(err, max_abs_err(got, after))
        if not same_bits(got, after):
            raise AssertionError(
                f"rs sparse: table t{k}'s update on the card differs from "
                f"its CPU replay, max |err| {max_abs_err(got, after)}")
    moved = max(max_abs_err(a, bb) for a, bb in zip(book["after"],
                                                    i["before"]))
    if not moved > 0:
        raise AssertionError("rs sparse: the booked step moved no row")
    sparse_bytes = _sparse_bytes(batches[0], cfg)
    out = {"step_ms": step_ms, "losses": losses, "peak_bytes": peak,
           "launches": launches, "table_bytes": table_bytes,
           "flat": space.flat_elems, "batch": b, "replay_rows": rows,
           "replay_err": err, "sparse_bytes": sparse_bytes,
           "dense_bytes_pushed": stats.bytes_pushed // RS_STEPS,
           "dense_bytes_pulled": stats.bytes_pulled // RS_STEPS,
           "dense_stream_bytes": 4 * space.flat_elems}
    log(f"phase 32: dlrm-mlperf train_batch by pbox_sparse, {b} rows, "
        f"tables {table_bytes / 2**30:.2f} GiB, dense flat {space.flat_elems}"
        f": steps {[round(x, 1) for x in step_ms]} ms, losses {losses}, peak "
        f"{peak / 2**30:.2f} GiB, launches {launches}; wire a step: sparse "
        f"{sparse_bytes} bytes (ids + bf16 rows), dense telemetry push "
        f"{out['dense_bytes_pushed']} / pull {out['dense_bytes_pulled']} at "
        f"world 1 ({out['dense_stream_bytes']} bytes a worker stream); step "
        f"{RS_BOOK + 1}'s update of {rows} touched rows == its CPU replay, "
        "bitwise")
    dense = space.unflatten(pflat[0])
    out["params"] = {"tables": tables, "bot": dense["bot"],
                     "top": dense["top"]}
    out["cfg"] = cfg
    return out


def rs_serve_path(dev, params: dict, cfg, smoke: bool = False) -> dict:
    """Phase 34: dlrm-mlperf's ``serve_p99`` (512), ``serve_bulk``
    (262,144) and ``retrieval_cand`` (1,048,576 candidates) plans from
    ``build_recsys_cell`` at full width on phase 32's trained params (world
    1): each timed three times (host clock), its peak, and its output
    bitwise equal to a direct ``dlrm_score`` / ``bulk_retrieval`` call on
    the same tensors.  No kernel runs.  Call inside ``world_one``."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_recsys_cell
    from repro_torch.models.recsys import models as RS

    arch = _dlrm_arch(cfg)
    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    _zero_counts()
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        plan = build_recsys_cell(arch, arch.cell(shape), mesh, None, smoke)
        if plan.kind == "serve":
            n = plan.abstract_args[1]["sparse"].shape[0]
            batch = _rs_batches("dlrm-mlperf", cfg, n, 1, 3, dev,
                                labels=False)[0]
            with torch.no_grad():
                want = RS.dlrm_score(params, batch, cfg)
        else:
            batch = _rs_retrieval_batch("dlrm-mlperf", cfg, plan, dev, 4)
            n = batch["cand_ids"].shape[0]
            with torch.no_grad():
                want = RS.bulk_retrieval(params, batch, RS.dlrm_user_tower,
                                         "t0", cfg.embed_dim, cfg)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ms, res = [], {}
        for _ in range(3):
            ms.append(timed(lambda: res.update(y=plan.fn(params, batch))))
        peak = torch.cuda.max_memory_allocated(dev) - base
        y = res["y"]
        if tuple(y.shape) != (n,) or not torch.isfinite(y).all():
            raise AssertionError(f"rs {shape}: scores {tuple(y.shape)}, "
                                 "finite?")
        if not same_bits(y, want):
            raise AssertionError(f"rs {shape}: the plan's scores differ from "
                                 f"the direct call, max |err| "
                                 f"{max_abs_err(y, want)}")
        out[shape] = {"ms": ms, "peak_bytes": peak, "rows": n}
        log(f"phase 34: dlrm-mlperf {shape} ({n} {'rows' if plan.kind == 'serve' else 'candidates'}): "
            f"{[round(x, 2) for x in ms]} ms, peak {peak / 2**30:.2f} GiB "
            "above the params; == the direct call, bitwise")
        del batch, want, res, y
    _check_counts("rs serve cells", _counts(), {})
    return out


def rs_dense_sparse_path(dev, smoke: bool = False) -> dict:
    """Phase 33: tests/scripts/sparse_push_equivalence.py on the card.
    dlrm-mlperf ``train_batch`` (65,536 rows) by pbox with the tables in
    the flat (rows capped at RS_DENSE_CAP), then by pbox_sparse from the
    same params and batch: losses within RS_LOSS_ATOL, the MLPs at
    RS_MLP_RTOL / RS_MLP_ATOL, the tables within RS_TABLE_ATOL (the bf16
    wire).  Then a second step of each, timed.  Call inside ``world_one``
    and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.fabric import ServerStats
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        build_recsys_cell,
        build_recsys_train_sparse,
        make_exchange,
    )
    from repro_torch.models.recsys import models as RS
    from repro_torch.runtime.trainer import (
        attach_telemetry,
        init_train_state,
        local_state,
    )

    cfg = get_arch("dlrm-mlperf").smoke_config if smoke else \
        dlrm_capped_config(RS_DENSE_CAP)
    arch = _dlrm_arch(cfg)
    cell = arch.cell("train_batch")
    mesh = make_mesh((1, 1), ("data", "model"))
    ex = make_exchange(mesh, "recsys")
    plan_d = build_recsys_cell(arch, cell, mesh, ex, smoke)
    space_d = plan_d.meta["space"]
    state = init_train_state(
        mesh, init_params_fn=lambda g: RS.dlrm_init(cfg, g),
        param_specs=RS.dlrm_specs(cfg, 1), exchange=ex, space=space_d,
        n_groups=1, key=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    pflat, slots, ef, stc = local_state(state, mesh, ex)
    del state
    p0 = space_d.unflatten(pflat[0])
    tables = {k: v.clone() for k, v in p0["tables"].items()}
    dense0 = {k: {kk: v.clone() for kk, v in p0[k].items()}
              for k in ("bot", "top")}
    del p0
    b = plan_d.abstract_args[4]["sparse"].shape[0]
    batches = _rs_batches("dlrm-mlperf", cfg, b, 2, 1, dev)
    out = {"flat": space_d.flat_elems, "batch": b}

    def run(label, step, state, batch):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        ms, losses, state = _rs_step_times(step, state, [batch])
        launches = _counts()
        _check_counts(f"rs {label}", launches, {"fused_agg_opt": 1})
        rec = out.setdefault(label, {"ms": [], "peak_bytes": [], "losses": [],
                                     "launches": dict.fromkeys(launches, 0)})
        rec["ms"] += ms
        rec["losses"] += losses
        rec["peak_bytes"].append(torch.cuda.max_memory_allocated(dev))
        rec["launches"] = {k: rec["launches"][k] + v
                           for k, v in launches.items()}
        return state

    stats_d = ServerStats()
    step_d = attach_telemetry(plan_d.fn, ex, space_d, mesh, stats_d)
    sd = run("dense", step_d, [pflat, slots, ef, stc], batches[0])
    del pflat
    plan_s = build_recsys_train_sparse(arch, cell, mesh, smoke)
    space_s = plan_s.meta["space"]
    stats_s = ServerStats()
    step_s = attach_telemetry(plan_s.fn, plan_s.meta["exchange"], space_s,
                              mesh, stats_s)
    pf0 = space_s.flatten(dense0).reshape(1, -1)
    ss = run("sparse", step_s, [pf0, (), None, torch.zeros(
        (), dtype=torch.int32, device=dev), tables], batches[0])
    # the comparison, on the card
    out_d = space_d.unflatten(sd[0][0])
    out_s = space_s.unflatten(ss[0][0])
    loss_err = abs(out["dense"]["losses"][0] - out["sparse"]["losses"][0])
    mlp_err = 0.0
    for k in ("bot", "top"):
        for kk in out_d[k]:
            a, w = out_s[k][kk], out_d[k][kk]
            mlp_err = max(mlp_err, max_abs_err(a, w))
            if not torch.allclose(a, w, rtol=RS_MLP_RTOL, atol=RS_MLP_ATOL):
                raise AssertionError(f"rs dense vs sparse: {k}/{kk} differ, "
                                     f"max |err| {max_abs_err(a, w)}")
    table_err = max(max_abs_err(ss[4][name], out_d["tables"][name])
                    for name in ss[4])
    if loss_err > RS_LOSS_ATOL or table_err > RS_TABLE_ATOL:
        raise AssertionError(f"rs dense vs sparse: loss |err| {loss_err} "
                             f"(bound {RS_LOSS_ATOL}), tables {table_err} "
                             f"(bound {RS_TABLE_ATOL})")
    del out_d, out_s
    # a second step of each, for the steady times
    run("dense", step_d, sd, batches[1])
    del sd
    run("sparse", step_s, ss, batches[1])
    del ss, tables
    torch.cuda.empty_cache()
    out.update(loss_err=loss_err, mlp_err=mlp_err, table_err=table_err,
               dense_bytes=(stats_d.bytes_pushed + stats_d.bytes_pulled) // 2,
               dense_stream_bytes=4 * space_d.flat_elems,
               sparse_bytes=_sparse_bytes(batches[0], cfg),
               sparse_dense_stream_bytes=4 * space_s.flat_elems)
    log(f"phase 33: dlrm-mlperf train_batch {b} rows, rows capped at "
        f"{max(cfg.vocabs)}: dense (pbox, flat {space_d.flat_elems}) steps "
        f"{[round(x, 1) for x in out['dense']['ms']]} ms, peaks "
        f"{[round(x / 2**30, 2) for x in out['dense']['peak_bytes']]} GiB, a "
        f"worker stream {4 * space_d.flat_elems} bytes; sparse steps "
        f"{[round(x, 1) for x in out['sparse']['ms']]} ms, peaks "
        f"{[round(x / 2**30, 2) for x in out['sparse']['peak_bytes']]} GiB, "
        f"{out['sparse_bytes']} sparse + {4 * space_s.flat_elems} dense bytes;"
        f" losses {out['dense']['losses'][0]} / {out['sparse']['losses'][0]} "
        f"(|err| {loss_err}), MLP max |err| {mlp_err}, tables {table_err} "
        f"(bounds {RS_LOSS_ATOL}, {RS_MLP_RTOL} / {RS_MLP_ATOL}, "
        f"{RS_TABLE_ATOL})")
    return out


def _rs_probe_batch(arch_id: str, cfg, params: dict, published: int,
                    dev) -> tuple:
    """The train batch that fits: the peak of one fwd+bwd at RS_PROBE
    rows (above what is allocated), scaled linearly; the published batch,
    or the largest power-of-two fraction of it whose scaled peak stays
    under RS_MEM_SHARE of the card.  Returns (batch, probe peak bytes)."""
    import torch

    from repro_torch.launch.steps import _RS_FNS

    loss_f = _RS_FNS[arch_id][3]
    batch = _rs_batches(arch_id, cfg, RS_PROBE, 1, 7, dev)[0]
    leaves = [x.requires_grad_(True) for x in _leaves(params)]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    loss, _ = loss_f(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    probe = torch.cuda.max_memory_allocated(dev) - base
    del loss, grads, batch
    for x in leaves:
        x.requires_grad_(False)
    torch.cuda.empty_cache()
    budget = (RS_MEM_SHARE * torch.cuda.get_device_properties(dev).total_memory
              - torch.cuda.memory_allocated(dev))
    b = published
    while b > RS_PROBE and probe * b / RS_PROBE > budget:
        b //= 2
    return b, probe


def rs_archs_path(dev, smoke: bool = False) -> dict:
    """Phase 35: AutoInt, DIEN and xDeepFM at their published configs,
    world 1: ``train_batch`` by pbox (SGD 0.01) for 2 steps at the
    published 65,536 rows or the largest power-of-two fraction that fits
    (``_rs_probe_batch``: xDeepFM's CIN keeps (B, 200, 39, 10) per
    layer), then ``serve_p99`` and ``retrieval_cand`` on the trained
    params, each bitwise equal to the direct call.  Counts: 2
    fused_agg_opt for each arch's train cell, none for the serving cells.
    Call inside ``world_one`` and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        _RS_FNS,
        build_recsys_cell,
        make_exchange,
    )
    from repro_torch.models.recsys import models as RS
    from repro_torch.runtime.trainer import init_train_state, local_state

    mesh = make_mesh((1, 1), ("data", "model"))
    out = {}
    for arch_id in RS_ARCHS[1:]:
        arch = get_arch(arch_id)
        cfg = arch.smoke_config if smoke else arch.config
        init_f, specs_f, _, _, score_f, tower_f, _ = _RS_FNS[arch_id]
        published = arch.cell("train_batch").params["batch"]
        if smoke:
            b, probe = 4, 0
        else:
            b, probe = _rs_probe_batch(arch_id, cfg, init_f(
                cfg, torch.Generator(device=dev).manual_seed(0)), published,
                dev)
        cell = ShapeCell("train_batch", "train", {"batch": b})
        ex = make_exchange(mesh, "recsys")
        plan = build_recsys_cell(dataclasses.replace(arch, config=cfg), cell,
                                 mesh, ex)
        space = plan.meta["space"]
        state = init_train_state(
            mesh, init_params_fn=lambda g: init_f(cfg, g),
            param_specs=specs_f(cfg, 1), exchange=ex, space=space,
            n_groups=1, key=torch.Generator(device=dev).manual_seed(0),
            device=dev)
        st = list(local_state(state, mesh, ex))
        del state
        batches = _rs_batches(arch_id, cfg, b, 2, 0, dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        step_ms, losses, st = _rs_step_times(plan.fn, st, batches)
        launches = _counts()
        _check_counts(f"rs {arch_id} train", launches, {"fused_agg_opt": 2})
        peak = torch.cuda.max_memory_allocated(dev)
        del batches
        params = space.unflatten(st[0][0])
        res = {"train": {"batch": b, "published": published,
                         "probe_peak_bytes": probe, "step_ms": step_ms,
                         "losses": losses, "peak_bytes": peak,
                         "launches": launches}}
        _zero_counts()
        for shape in ("serve_p99", "retrieval_cand"):
            sp = build_recsys_cell(arch, arch.cell(shape), mesh, None, smoke)
            if sp.kind == "serve":
                n = sp.abstract_args[1]["sparse"].shape[0]
                batch = _rs_batches(arch_id, cfg, n, 1, 3, dev,
                                    labels=False)[0]
                with torch.no_grad():
                    want = score_f(params, batch, cfg)
            else:
                batch = _rs_retrieval_batch(arch_id, cfg, sp, dev, 4)
                with torch.no_grad():
                    want = RS.bulk_retrieval(params, batch, tower_f, "t0",
                                             cfg.embed_dim, cfg)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            ms, got = [], {}
            for _ in range(3):
                ms.append(timed(lambda: got.update(y=sp.fn(params, batch))))
            if not torch.isfinite(got["y"]).all() or not same_bits(got["y"],
                                                                  want):
                raise AssertionError(
                    f"rs {arch_id} {shape}: the plan's scores differ from the"
                    f" direct call, max |err| {max_abs_err(got['y'], want)}")
            res[shape] = {"ms": ms, "rows": int(got["y"].shape[0]),
                          "peak_bytes": torch.cuda.max_memory_allocated(dev)}
            del batch, want, got
        _check_counts(f"rs {arch_id} serving", _counts(), {})
        out[arch_id] = res
        log(f"phase 35: {arch_id} train_batch {b} rows (published "
            f"{published}; probe peak {probe / 2**30:.2f} GiB at {RS_PROBE}):"
            f" steps {[round(x, 1) for x in step_ms]} ms, losses {losses}, "
            f"peak {peak / 2**30:.2f} GiB; serve_p99 "
            f"{[round(x, 2) for x in res['serve_p99']['ms']]} ms, "
            f"retrieval_cand {[round(x, 2) for x in res['retrieval_cand']['ms']]}"
            f" ms ({res['retrieval_cand']['rows']} candidates), == the direct"
            " calls bitwise")
        del st, params, plan
        torch.cuda.empty_cache()
    return out


def _rs_close(label: str, a, b, rtol: float = RS_CARD_RTOL,
              atol: float = RS_CARD_ATOL) -> float:
    """max |a - b| after checking a against b at ``rtol`` / ``atol``
    (RS_CARD_RTOL / RS_CARD_ATOL unless given; on the host)."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    if a.shape != b.shape or not torch.allclose(a, b, rtol=rtol, atol=atol):
        raise AssertionError(f"{label}: shapes {tuple(a.shape)} / "
                             f"{tuple(b.shape)}, max |err| "
                             f"{max_abs_err(a, b) if a.shape == b.shape else None}")
    return max_abs_err(a, b)


def _rs_smoke_cases():
    for arch_id in RS_ARCHS:
        for shape in RS_CELLS:
            yield f"{arch_id}/{shape}", arch_id, shape, "pbox"
    yield "dlrm-mlperf/train_batch/pbox_sparse", "dlrm-mlperf", \
        "train_batch", "pbox_sparse"


def _rs_smoke_run(arch_id, shape, strategy, mesh, params, dev) -> dict:
    """One SMOKE case on ``mesh`` (the card's world-1 mesh, or a
    ``LocalMesh`` for the CPU) from ``params`` (copied to ``dev``): a train
    cell's 2 steps, or a serving cell's output."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell

    cfg = get_arch(arch_id).smoke_config
    plan = build_cell(arch_id, shape, mesh, strategy=strategy, smoke=True)
    p = _tree_to(params, dev)
    if plan.kind == "train":
        space = plan.meta["space"]
        b = plan.abstract_args[-1]["sparse"].shape[0]
        batches = _rs_batches(arch_id, cfg, b, 2, 0, dev)
        stc = torch.zeros((), dtype=torch.int32, device=dev)
        if strategy == "pbox_sparse":  # updated in place: copies
            tables = {k: v.clone() for k, v in p.pop("tables").items()}
            st = [space.flatten(p).reshape(1, -1), (), None, stc, tables]
        else:
            st = [space.flatten(p).reshape(1, -1), (), None, stc]
        losses = []
        for bb in batches:
            res = plan.fn(*st, bb)
            st = list(res[:len(st)])
            losses.append(res[-1]["loss"])
        out = {"pflat": st[0], "losses": torch.stack(losses)}
        if strategy == "pbox_sparse":
            out["tables"] = st[4]
        return out
    if plan.kind == "serve":
        n = plan.abstract_args[1]["sparse"].shape[0]
        batch = _rs_batches(arch_id, cfg, n, 1, 3, dev, labels=False)[0]
    else:
        batch = _rs_retrieval_batch(arch_id, cfg, plan, torch.device("cpu"),
                                    4)
        batch = {k: v.to(dev) for k, v in batch.items()}
    return {"y": plan.fn(p, batch)}


def rs_smoke_check(dev, only=None) -> dict:
    """Phase 36: every recsys arch x cell at its SMOKE config and DLRM's
    pbox_sparse step, world 1, the card against the CPU (a ``LocalMesh``,
    the kernels' plain versions) from the same seeded params: params,
    tables, losses and scores within RS_CARD_RTOL / RS_CARD_ATOL (the
    card's f32 matmuls sum in other orders than the CPU's); the card's
    launches equal to the CPU run's plain-version calls.  Call inside
    ``world_one`` and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import _RS_FNS

    mesh = make_mesh((1, 1), ("data", "model"))
    cpu_mesh = LocalMesh(("data", "model"))
    out = {}
    for name, arch_id, shape, strategy in _rs_smoke_cases():
        if only is not None and name not in only:
            continue
        cfg = get_arch(arch_id).smoke_config
        params = _RS_FNS[arch_id][0](cfg, torch.Generator().manual_seed(0))
        _zero_counts()
        card = _rs_smoke_run(arch_id, shape, strategy, mesh, params, dev)
        launches = _counts()
        with PlainCalls() as plain:
            cpu = _rs_smoke_run(arch_id, shape, strategy, cpu_mesh, params,
                                torch.device("cpu"))
        if launches != plain.counts:
            raise AssertionError(f"rs smoke {name}: card launches {launches},"
                                 f" CPU plain calls {plain.counts}")
        err = 0.0
        for key in card:
            if key == "tables":
                for t in card[key]:
                    err = max(err, _rs_close(f"rs smoke {name} {t}",
                                             card[key][t], cpu[key][t]))
            else:
                err = max(err, _rs_close(f"rs smoke {name} {key}", card[key],
                                         cpu[key]))
        out[name] = {"launches": launches, "max_abs_err": err}
    log(f"phase 36: {len(out)} recsys SMOKE cases (4 archs x 4 cells, DLRM "
        f"pbox_sparse) card == CPU within rtol {RS_CARD_RTOL} / atol "
        f"{RS_CARD_ATOL}, max |err| {max(c['max_abs_err'] for c in out.values())}")
    return out


# phase 36's two ranks: dlrm-mlperf SMOKE on a (1, 2) mesh, gloo on cuda:0
RS_GLOO_BATCH = 4


def _rs_gloo_steps(mesh, dev, tp: int) -> dict:
    """dlrm-mlperf SMOKE at ``tp`` (the mesh's model axis) on a
    RS_GLOO_BATCH-row batch: one pbox step (tables in the flat) and one
    pbox_sparse step from the same global draw; this rank's local
    results on the host."""
    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch.steps import (
        build_recsys_cell,
        build_recsys_train_sparse,
        make_exchange,
    )
    from repro_torch.models.recsys import models as RS
    from repro_torch.runtime.trainer import local_params, shard_batch

    arch = get_arch("dlrm-mlperf")
    cfg = arch.smoke_config
    arch = dataclasses.replace(arch, config=cfg)
    cell = ShapeCell("train_batch", "train", {"batch": RS_GLOO_BATCH})
    params = RS.dlrm_init(cfg, torch.Generator().manual_seed(0), 2)
    local = _tree_to(local_params(params, RS.dlrm_specs(cfg, tp), mesh), dev)
    batch = _rs_batches("dlrm-mlperf", cfg, RS_GLOO_BATCH, 1, 0, "cpu")[0]
    ex = make_exchange(mesh, "recsys")
    mine = {k: v.to(dev) for k, v in shard_batch(batch, mesh, ex).items()}
    stc = torch.zeros((), dtype=torch.int32, device=dev)
    dense = build_recsys_cell(arch, cell, mesh, ex)
    pf = dense.meta["space"].flatten(local).reshape(1, -1)
    res = dense.fn(pf, (), None, stc, mine)
    out = {"dense": _tree_to(dense.meta["space"].unflatten(res[0][0]), "cpu"),
           "dense_loss": res[-1]["loss"].item()}
    sparse = build_recsys_train_sparse(arch, cell, mesh)
    tables = {k: v.clone() for k, v in local["tables"].items()}
    d0 = {k: v for k, v in local.items() if k != "tables"}
    res = sparse.fn(sparse.meta["space"].flatten(d0).reshape(1, -1), (), None,
                    stc, tables, mine)
    out["sparse"] = _tree_to(sparse.meta["space"].unflatten(res[0][0]), "cpu")
    out["sparse"]["tables"] = _tree_to(res[4], "cpu")
    out["sparse_loss"] = res[-1]["loss"].item()
    return out


def _rs_gloo_rank(rank, world, path, out_dir, device):
    """One rank of phase 36's (1, 2) pass on ``device`` (cuda:0) over gloo."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=rank,
                            world_size=world)
    try:
        mesh = Mesh((1, world), ("data", "model"))
        out = _rs_gloo_steps(mesh, dev, world)
        out["model"] = mesh.coords["model"]
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def rs_gloo_check(dev, ranks: list | None = None) -> dict:
    """Phase 36's tp = 2 pass: 2 gloo ranks on cuda:0, mesh (1, 2),
    dlrm-mlperf SMOKE, one dense and one sparse step each (the lookup's
    psum_scatter, the cotangents' all-gather, the MLPs' psum_model), held
    to tp = 1 on the card (a ``LocalMesh``) at RS_CARD_RTOL / RS_CARD_ATOL:
    each rank's MLPs, its rows of every table, and the losses (the tp = 2
    metric is the loss over tp).  ``ranks``: the ranks' results when they
    ran already (phase 31's 2 ranks run ``_rs_gloo_steps`` after their own
    work, which saves a spawn); else 2 ranks are spawned here."""
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if ranks is not None:
        return _rs_gloo_compare(dev, ranks,
                                max(r["seconds"] for r in ranks))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rs_gloo_")
    t0 = time.perf_counter()
    try:
        ctx = mp.start_processes(_rs_gloo_rank, args=(2, f"{tmp}/rendezvous",
                                                      tmp, str(dev)),
                                 nprocs=2, join=False, start_method="spawn")
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError("recsys gloo ranks on cuda:0 timed out")
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt") for r in range(2)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return _rs_gloo_compare(dev, ranks, time.perf_counter() - t0)


def _rs_gloo_compare(dev, ranks: list, seconds: float) -> dict:
    with deterministic():
        ref = _rs_gloo_steps(LocalMesh(("data", "model")), dev, 1)
    err = 0.0
    for r, got in enumerate(ranks):
        g = got["model"]
        for kind in ("dense", "sparse"):
            if not math.isclose(got[f"{kind}_loss"] * 2, ref[f"{kind}_loss"],
                                rel_tol=RS_CARD_RTOL, abs_tol=RS_CARD_ATOL):
                raise AssertionError(
                    f"rs gloo rank {r} {kind}: loss x tp "
                    f"{got[f'{kind}_loss'] * 2} against tp = 1 "
                    f"{ref[f'{kind}_loss']}")
            for (name, a), (_, w) in zip(_named_leaves(got[kind]),
                                         _named_leaves(ref[kind])):
                if name.startswith("tables/"):
                    n = a.shape[0]
                    w = w[g * n:(g + 1) * n]
                err = max(err, _rs_close(f"rs gloo rank {r} {kind} {name}",
                                         a, w))
    log(f"phase 36: dlrm-mlperf SMOKE at tp = 2 over 2 gloo ranks on cuda:0,"
        f" one dense and one sparse step == tp = 1 on the card within rtol "
        f"{RS_CARD_RTOL} / atol {RS_CARD_ATOL} (max |err| {err}) in "
        f"{seconds:.1f} s")
    return {"seconds": seconds, "max_abs_err": err}


# -- phases 37 to 41: ResNet-50 and the MoE transformer ------------------------
# phase 37: the paper's setting, K = 2 workers x 32 images at 224^2 through a
# 4-shard fabric; phase 38: imagenet_train's published global batch of 256,
# or the largest power-of-two fraction a probe step's peak allows
RN_WORKERS, RN_BATCH, RN_IMG, RN_ROUNDS = 2, 32, 224, 3
RN_SPMD_STEPS, RN_PROBE, RN_MEM_SHARE = 3, 16, 0.75
# phase 40: the decode batch is the largest that fits beside the weights,
# leaving this much for the step's working memory
QWEN_DECODE_MARGIN = 6 * 2**30
# phase 41: the LM SMOKE prompts, decode steps, and the MoE routing sweep
SMOKE_NEW_LM = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b", "internlm2-1.8b",
                "qwen2-72b")
SMOKE_PROMPT, SMOKE_DECODE_STEPS = 16, 4
# ResNet's SMOKE gradients card against CPU: 50 convolutions and their
# GroupNorms deep, cuDNN and the CPU's convolutions sum in other orders;
# the first card run (NVIDIA H100 80GB HBM3, 700.00 W) read 5.6e-6 on a
# head gradient, past RS_CARD_RTOL / RS_CARD_ATOL.  This is
# tests/test_torch_resnet.py's bound (the port against JAX on the CPU).
RN_CARD_RTOL, RN_CARD_ATOL = 1e-4, 1e-5
# phase 37's fused norm against its plain version on the card, both f32:
# dx and dr sum a group's terms in another order (rtol, and atol of the
# largest entry), ds and db also over the batch (up to 32 x 112^2 terms
# a channel); a backward that forgets the group statistics' terms reads
# ~1e-2 of dx (one over the root of a group's ~6,000 elements)
GN_RTOL, GN_DX_ATOL, GN_DS_ATOL = 1e-4, 1e-5, 1e-4
# the LM SMOKE caches (each layer's k / v after the layers below it, on
# the card and on the CPU) within RS_CARD_RTOL of their largest entry:
# elementwise, atol 1e-6 failed a near-zero entry of granite's by 2.0e-6
# (values up to ~4; NVIDIA H100 80GB HBM3, 700.00 W), as phase 22 holds
# logits to their largest
LM_CACHE_KEYS = ("prefill_k", "cache_k", "cache_v")


def _scaled_close(label: str, a, b, rtol: float = RS_CARD_RTOL) -> float:
    """max |a - b| after checking it against ``rtol`` times max |b| (plus
    RS_CARD_ATOL), on the host."""
    a, b = a.detach().cpu(), b.detach().cpu()
    err = max_abs_err(a, b) if a.shape == b.shape else float("inf")
    scale = b.abs().max().item() if b.numel() else 0.0
    if not err <= rtol * scale + RS_CARD_ATOL:
        raise AssertionError(f"{label}: max |err| {err} against "
                             f"{rtol} x {scale} + {RS_CARD_ATOL}")
    return err
ROUTING_CASES = ((4096, 32, 8), (4096, 60, 4), (257, 8, 2))  # T, E, k


def _sorted_map(fn, tree):
    """``fn`` of each leaf, the keys in ``_leaves``' (sorted) order."""
    if isinstance(tree, dict):
        return {k: _sorted_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _rn_loss_and_grad(params, batch, cfg):
    """(loss, gradient tree) of ResNet's ``loss_fn`` at ``params``."""
    import torch

    from repro_torch.models import resnet as RN

    tracked = _sorted_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = RN.loss_fn(tracked, batch, cfg)
    grads = iter(torch.autograd.grad(loss, _leaves(tracked)))
    return loss.detach(), _sorted_map(lambda _: next(grads), tracked)


def _rn_batches(cfg, batch: int, img: int, n: int, seed: int, dev) -> list:
    """``n`` batches of ``image_batches`` on ``dev``, made before any timed
    work."""
    import torch

    from repro_torch.data.synthetic import image_batches

    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in itertools.islice(
                image_batches(batch, img, cfg.n_classes, seed), n)]


def _rn_trace(cfg, img: int) -> tuple[list, list]:
    """ResNet's norms and convolutions at ``img``^2, traced on meta tensors
    through the model's own ``forward``: ``(norms, convs)``, a norm as
    ``((C, H, W), relu, residual)``, a convolution as ``(input, output
    shape, whether resnet._wgrad_channels_last picks it)``."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.group_norm import kernel as G
    from repro_torch.models import resnet as RN

    norms, convs = [], []

    def conv(x, w, stride, padding):
        y = F.conv2d(x, w, stride=stride, padding=padding)
        convs.append((x, tuple(y.shape), RN._wgrad_channels_last(x, w)))
        return y

    def norm(x, s, b, groups, *, relu, residual=None):
        norms.append((tuple(x.shape[1:]), relu, residual is not None))
        return G.group_norm_act_torch(x, s, b, groups, relu, residual)

    params = RN.init_params(cfg, None, device="meta")
    images = torch.empty((2, img, img, 3), device="meta")
    with mock.patch.object(RN, "_conv2d", conv), \
            mock.patch.object(RN, "group_norm_act", norm):
        RN.forward(params, images, cfg)
    return norms, convs


def _rn_launches(cfg, img: int, passes: int) -> dict:
    """The launches ``passes`` forwards and backwards of ResNet ``cfg`` at
    ``img``^2 make on the card in f32 (``_rn_trace``): each norm's backward,
    its forward pass where a ReLU or an add follows it; for each
    channels-last weight gradient a copy of its input unless channels-last
    already, and of its incoming gradient (NCHW-contiguous, as the norm's
    backward writes it) unless its pixels or channels are one."""
    import torch

    norms, convs = _rn_trace(cfg, img)
    cl = torch.channels_last
    copies = sum(
        int(not x.is_contiguous(memory_format=cl))
        + int(not torch.empty(y, device="meta").is_contiguous(memory_format=cl))
        for x, y, pick in convs if pick)
    return {"group_norm_fwd": passes * sum(r or a for _, r, a in norms),
            "group_norm_bwd": passes * len(norms),
            "channels_last": passes * copies}


def _gn_const_stats(x, s, b, groups: int, relu: bool, r):
    """The norm with its group statistics held constant: the gradient of a
    backward that forgets their terms (the control of resnet_norm_check)."""
    import torch

    n, c, h, w = x.shape
    xg = x.reshape(n, groups, -1)
    mean = xg.mean(-1, keepdim=True).detach()
    var = xg.var(-1, unbiased=False, keepdim=True).detach()
    y = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(n, c, h, w)
    y = y * s[:, None, None] + b[:, None, None]
    if r is not None:
        y = y + r
    return torch.relu(y) if relu else y


def resnet_norm_check(dev) -> dict:
    """Phase 37's first part: the fused norm (``kernels/group_norm``) in all
    three modes at every norm shape of ResNet-50 at RN_BATCH x RN_IMG^2
    (``_rn_trace``), against its plain version on the same card tensors:
    the output bit for bit, dx within GN_RTOL / GN_DX_ATOL (of the largest
    entry), ds and db within GN_RTOL / GN_DS_ATOL, dr bitwise (dy where the
    output is positive); two backward calls give the same bits; a control
    (dx with the group statistics held constant, ``_gn_const_stats``) must
    fail the dx bound at every shape.  Then the channels-last copy
    (``kernels/layout``) at both operands of each channels-last weight
    gradient, bit for bit against ``contiguous``.  Launches: one forward
    pass per call with a ReLU or an add, one backward per call, one copy
    per operand not channels-last already."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.group_norm import group_norm_act
    from repro_torch.kernels.group_norm import kernel as G
    from repro_torch.kernels.layout import kernel as L
    from repro_torch.kernels.layout import to_channels_last

    cfg = get_arch("resnet50").config
    norms, convs = _rn_trace(cfg, RN_IMG)
    gen = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def close(got, want, atol_of_max: float) -> float:
        atol = atol_of_max * want.abs().max().item()
        err = (got - want).abs()
        return (err - GN_RTOL * want.abs()).max().item() / atol

    def grads(fn, x, s, b, r, dy):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, s, b) + (() if r is None else (r,))]
        y = fn(*leaves[:3], leaves[3] if r is not None else None)
        return [y.detach(), *torch.autograd.grad(y, leaves, dy)]

    worst = {"dx": 0.0, "ds_db": 0.0, "control": math.inf}
    cases = 0
    for chw in sorted({n[0] for n in norms}):
        x = randn(RN_BATCH, *chw)
        s, b = 1 + 0.1 * randn(chw[0]), 0.1 * randn(chw[0])
        r, dy = randn(RN_BATCH, *chw), randn(RN_BATCH, *chw)
        for relu, res in ((False, False), (True, False), (True, True)):
            rr = r if res else None
            f0, b0 = G.forward_launches, G.backward_launches
            got = grads(lambda *a: group_norm_act(*a[:3], cfg.groups,
                                                  relu=relu, residual=a[3]),
                        x, s, b, rr, dy)
            again = grads(lambda *a: group_norm_act(*a[:3], cfg.groups,
                                                    relu=relu, residual=a[3]),
                          x, s, b, rr, dy)
            launched = (G.forward_launches - f0, G.backward_launches - b0)
            if launched != (2 * int(relu or res), 2):
                raise AssertionError(f"group_norm_act {chw} relu={relu} "
                                     f"residual={res}: launches {launched}")
            want = grads(lambda *a: G.group_norm_act_torch(
                *a[:3], cfg.groups, relu, a[3]), x, s, b, rr, dy)
            wrong = grads(lambda *a: _gn_const_stats(
                *a[:3], cfg.groups, relu, a[3]), x, s, b, rr, dy)
            label = f"group_norm_act {RN_BATCH}x{chw} relu={relu} res={res}"
            if not all(torch.equal(g, a) for g, a in zip(got, again)):
                raise AssertionError(f"{label}: two backward calls differ")
            if not torch.equal(got[0], want[0]):
                raise AssertionError(f"{label}: output differs from the "
                                     f"plain version")
            if res and not torch.equal(got[4], torch.where(
                    want[0] > 0, dy, torch.zeros_like(dy))):
                raise AssertionError(f"{label}: dr is not dy on the mask")
            dx = close(got[1], want[1], GN_DX_ATOL)
            dsb = max(close(got[i], want[i], GN_DS_ATOL) for i in (2, 3))
            ctl = close(wrong[1], want[1], GN_DX_ATOL)
            if not (dx <= 1 and dsb <= 1 < ctl):
                raise AssertionError(
                    f"{label}: dx reads {dx:.3g}, ds/db {dsb:.3g} of their "
                    f"bounds (<= 1), the control {ctl:.3g} (> 1)")
            worst = {"dx": max(worst["dx"], dx),
                     "ds_db": max(worst["ds_db"], dsb),
                     "control": min(worst["control"], ctl)}
            cases += 1
    copies = 0
    for x, y, pick in convs:
        if not pick:
            continue
        for shape, cl in ((tuple(x.shape), x.is_contiguous(
                memory_format=torch.channels_last)), (y, False)):
            t = randn(RN_BATCH, *shape[1:])
            if cl:
                t = t.contiguous(memory_format=torch.channels_last)
            n0 = L.launches
            got = to_channels_last(t)
            if not (got.is_contiguous(memory_format=torch.channels_last)
                    and torch.equal(got, t)
                    and L.launches - n0 == int(not cl)):
                raise AssertionError(f"to_channels_last {tuple(t.shape)}: "
                                     f"not the channels-last copy")
            copies += 1
    log(f"phase 37: group_norm_act at {cases} (shape, mode) cases of "
        f"resnet50 at {RN_BATCH} x {RN_IMG}^2: outputs and dr bitwise, "
        f"repeat bits; worst share of the bound dx {worst['dx']:.3g}, ds/db "
        f"{worst['ds_db']:.3g}, the control's least {worst['control']:.3g}; "
        f"to_channels_last bitwise at {copies} operands of the "
        f"channels-last weight gradients")
    return {"cases": cases, "copies": copies, **worst}


def resnet_fabric_path(dev, smoke: bool = False) -> dict:
    """Phase 37: ResNet-50 at its published config through the PHub
    fabric, the paper's setting: RN_WORKERS workers x RN_BATCH images at
    RN_IMG^2, 4 shards, momentum(0.1, 0.9), the f32 wire, RN_ROUNDS
    rounds.  Counts set to 0 just before the rounds and read just after;
    the last round profiled; shard 0's first update captured for a replay
    through the plain version (``replay_f32``).  ``smoke``: the SMOKE
    config, 2 images at 32^2, 2 rounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.config import FabricConfig
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.models import resnet as RN
    from repro_torch.optim.optimizers import momentum

    arch = get_arch("resnet50")
    cfg = arch.smoke_config if smoke else arch.config
    batch, img = (2, 32) if smoke else (RN_BATCH, RN_IMG)
    rounds = 2 if smoke else RN_ROUNDS
    memory = PathMemory(dev)
    params = RN.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    space = ParamSpace.build(params)
    spec = momentum(0.1, 0.9)
    fab = PBoxFabric(space, spec, space.flatten(params), device=dev,
                     config=FabricConfig(num_shards=SHARDS,
                                         num_workers=RN_WORKERS))
    del params
    streams = [iter(_rn_batches(cfg, batch, img, rounds, w, dev))
               for w in range(RN_WORKERS)]
    losses: list = []

    def grad_fn(p, wstep):
        with record_function("worker.fwd_bwd"):
            loss, g = _rn_loss_and_grad(p, next(streams[wstep[0]]), cfg)
        losses.append(loss)
        return g

    captured: dict = {}
    shard0 = fab.shards[0]
    capture = LaunchTimer(shard0, "apply", first_apply_hook(shard0, captured))
    timer = LaunchTimer(K, "fused_agg_opt_cuda")
    h = WorkerHarness(fab, grad_fn, lambda w, s: (w, s))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    round_ms = []
    with timer, capture:
        _zero_counts()
        for r in range(1, rounds + 1):
            if r == rounds:
                prof.start()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h.run(r)
            torch.cuda.synchronize()
            round_ms.append((time.perf_counter() - t0) * 1e3)
        prof.stop()
        launches = _counts()
    _check_counts("resnet fabric", launches, {
        "fused_agg_opt": SHARDS * rounds,
        **_rn_launches(cfg, img, RN_WORKERS * rounds)})
    peak = memory.now()[1]
    loss_vals = finite_losses(losses)
    kernel_ms = timer.ms()
    flat = fab.params
    if tuple(flat.shape) != (space.flat_elems,) or not torch.isfinite(
            flat).all():
        raise AssertionError("resnet fabric: params not finite or misshapen")
    log(f"phase 37: resnet50 ({space.payload_elems} params, flat "
        f"{space.flat_elems}) through the fabric: {RN_WORKERS} workers x "
        f"{batch} x {img}^2, {SHARDS} shards, momentum(0.1, 0.9), {rounds} "
        f"rounds; losses {loss_vals}; round wall ms "
        f"{[round(x, 1) for x in round_ms]}; launches {launches}; "
        f"fused_agg_opt ms per launch {statistics.median(kernel_ms):.4f} "
        f"(median of {len(kernel_ms)}); peak {peak / 2**30:.2f} GiB")
    breakdown = profile_summary(prof, round_ms[-2] if rounds > 1 else
                                round_ms[-1], timer.events[-SHARDS:],
                                "fused_agg_opt")
    n0 = shard0.num_elems
    del fab, h, flat, shard0, streams
    torch.cuda.empty_cache()
    return {"launches": launches, "n": n0, "flat": space.flat_elems,
            "captured": captured, "spec": spec, "round_ms": round_ms,
            "losses": loss_vals, "peak_bytes": peak,
            "main_path_ms": statistics.median(kernel_ms), **breakdown}


def _rn_probe_batch(cfg, params: dict, published: int, img: int,
                    dev) -> tuple:
    """The train batch that fits: the peak of one fwd+bwd at RN_PROBE
    images (above what is allocated), scaled linearly; the published
    batch, or the largest power-of-two fraction of it whose scaled peak
    stays under RN_MEM_SHARE of the card.  Returns (batch, probe peak)."""
    import torch

    batch = _rn_batches(cfg, RN_PROBE, img, 1, 7, dev)[0]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    loss, grads = _rn_loss_and_grad(params, batch, cfg)
    torch.cuda.synchronize()
    probe = torch.cuda.max_memory_allocated(dev) - base
    del loss, grads, batch
    torch.cuda.empty_cache()
    budget = (RN_MEM_SHARE * torch.cuda.get_device_properties(dev).total_memory
              - torch.cuda.memory_allocated(dev))
    b = published
    while b > RN_PROBE and probe * b / RN_PROBE > budget:
        b //= 2
    return b, probe


def resnet_spmd_path(dev, smoke: bool = False) -> dict:
    """Phase 38: ResNet-50's ``imagenet_train`` through
    ``launch/steps.build_vision_train`` and the SPMD PS step, world 1,
    pbox, momentum(0.1, 0.9), RN_SPMD_STEPS steps at 224^2, the published
    global batch of 256 if a probe step's peak allows it (else the
    largest power-of-two fraction).  Counts: 1 fused_agg_opt a step;
    step 2's ``device_update`` booked over three windows and replayed on
    the CPU, bitwise.  ``smoke``: the SMOKE cell (2 x 32^2).  Call inside
    ``world_one`` and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_vision_train, make_exchange
    from repro_torch.models import resnet as RN
    from repro_torch.runtime.trainer import init_train_state, local_state

    arch = get_arch("resnet50")
    cfg = arch.smoke_config if smoke else arch.config
    published = arch.cell("imagenet_train").params
    mesh = make_mesh((1, 1), ("data", "model"))
    params = RN.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    probe = None
    if smoke:
        gb = published["global_batch"]
    else:
        gb, probe = _rn_probe_batch(cfg, params, published["global_batch"],
                                    published["img"], dev)
    cell = ShapeCell("imagenet_train", "train",
                     {"global_batch": gb, "img": published["img"]})
    ex = make_exchange(mesh, "vision")
    plan = build_vision_train(arch, cell, mesh, ex, smoke=smoke)
    space = plan.meta["space"]
    state = init_train_state(mesh, init_params_fn=lambda _: params,
                             exchange=ex, space=space, n_groups=1, key=None,
                             device=dev)
    del params
    bt = plan.abstract_args[4]["images"].shape
    gb, img = bt[0], bt[1]
    batches = _rn_batches(cfg, gb, img, RN_SPMD_STEPS, 0, dev)
    book, events = {}, []
    real = book_update(ex, book, events, SPMD_BOOK,
                       ex.cfg.compression.chunk_elems)
    pflat, slots, ef, stc = local_state(state, mesh, ex)
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    losses, step_ms = [], []
    for b in batches:
        res = {}
        step_ms.append(timed(lambda: res.update(zip(
            ("p", "s", "e", "c", "m"), plan.fn(pflat, slots, ef, stc, b)))))
        pflat, slots, ef, stc = res["p"], res["s"], res["e"], res["c"]
        losses.append(res["m"]["loss"])
    launches = _counts()
    _check_counts("resnet spmd", launches, {
        "fused_agg_opt": RN_SPMD_STEPS,
        **_rn_launches(cfg, img, RN_SPMD_STEPS)})
    peak = torch.cuda.max_memory_allocated(dev)
    losses = finite_losses(losses)
    update_ms = [s.elapsed_time(e) for s, e in events]
    err = replay_book(real, book, mesh.axis_names)
    ex.device_update = real
    reduced = gb != published["global_batch"] and not smoke
    log(f"phase 38: resnet50 imagenet_train {gb} x {img}^2"
        + (f" (cut from {published['global_batch']}: a {RN_PROBE}-image "
           f"probe step peaked at {probe / 2**30:.2f} GiB)" if reduced else
           (f" (the published batch; a {RN_PROBE}-image probe step peaked "
            f"at {probe / 2**30:.2f} GiB)" if probe else ""))
        + f": losses {losses}, steps {[round(x, 1) for x in step_ms]} ms, "
        f"device_update {[round(x, 3) for x in update_ms]} ms, peak "
        f"{peak / 2**30:.2f} GiB, launches {launches}; step {SPMD_BOOK + 1}'s"
        f" update replayed on the CPU over 3 windows bitwise")
    del pflat, slots, ef, batches
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_ms": step_ms,
            "update_ms": update_ms, "peak_bytes": peak, "replay_err": err,
            "flat": space.flat_elems, "batch": gb, "img": img,
            "reduced": reduced, "probe_bytes": probe}


class MoEDrops:
    """Counts the MoE assignments dispatch keeps while the block runs
    (``models/moe._dispatch`` swapped for a counting wrapper, and
    restored), on the card without a host wait.  A remat recompute
    dispatches the same tokens again, so the share is unchanged."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real = moe, moe._dispatch
        self.kept, self.total, self.capacity = [], 0, set()

        def counted(experts, cfg, capacity):
            out = self.real(experts, cfg, capacity)
            self.kept.append(out[1].sum())
            self.total += out[1].numel()
            self.capacity.add(capacity)
            return out

        moe._dispatch = counted
        return self

    def share_dropped(self) -> float:
        kept = sum(int(k.item()) for k in self.kept)
        return 1.0 - kept / self.total if self.total else 0.0

    def __exit__(self, *exc):
        self.moe._dispatch = self.real


def _lm_serve(arch_id: str, params, cfg, mesh, dev, smoke: bool,
              decode_batch: int, label: str, prefills: int = 2) -> dict:
    """``prefill_32k`` (``prefills`` times, the greedy ids equal) and
    ``decode_32k`` (``decode_batch`` sequences from a seeded cache,
    DECODE_STEPS steps ending at the last position) through
    ``build_cell``'s plans; no kernel launch."""
    import torch

    from repro_torch.launch.steps import build_cell

    out = {}
    _zero_counts()
    plan = build_cell(arch_id, "prefill_32k", mesh, smoke=smoke)
    s = plan.abstract_args[1].shape[1]
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (PREFILL_BATCH, s), generator=gen,
                         device=dev, dtype=torch.int32)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ids, ms = [], []
    for _ in range(prefills):
        res = {}
        ms.append(timed(lambda: res.update(zip(("ids", "cache"),
                                               plan.fn(params, toks)))))
        ids.append(res["ids"].cpu())
        del res
    peak = torch.cuda.max_memory_allocated(dev) - base
    if not all(torch.equal(ids[0], x) for x in ids[1:]):
        raise AssertionError(f"{label} prefill_32k: re-run ids {ids}")
    if not ((ids[0] >= 0) & (ids[0] < cfg.vocab)).all():
        raise AssertionError(f"{label} prefill_32k: ids {ids[0]}")
    out["prefill_32k"] = {"ms": ms, "peak_bytes": peak, "seq": s,
                          "batch": PREFILL_BATCH}
    log(f"{label}: prefill_32k {PREFILL_BATCH} x {s}: "
        f"{[round(x, 1) for x in ms]} ms, peak {peak / 2**30:.2f} GiB above "
        f"the weights; greedy ids {ids[0].tolist()}"
        + (" equal on the re-run" if prefills > 1 else ""))
    torch.cuda.empty_cache()

    plan = build_cell(arch_id, "decode_32k", mesh, smoke=smoke)
    L, _, s, hkv, hd = plan.abstract_args[2]["k"].shape
    shape = (L, decode_batch, s, hkv, hd)
    k, v = _random_cache([shape, shape], dev, 6, cfg.dtype)
    cache = {"k": k.mul_(0.5), "v": v}
    tok = torch.randint(0, cfg.vocab, (decode_batch,), generator=gen,
                        device=dev, dtype=torch.int32)
    torch.cuda.reset_peak_memory_stats(dev)
    ms = []
    for i in range(DECODE_STEPS):
        res = {}
        pos = s - DECODE_STEPS + i
        ms.append(timed(lambda: res.update(zip(("ids", "cache"), plan.fn(
            params, tok, cache, pos)))))
        tok = res["ids"]
        if res["cache"] is not cache:
            raise AssertionError(f"{label} decode_32k: the cache was not "
                                 "updated in place")
    if not ((tok >= 0) & (tok < cfg.vocab)).all():
        raise AssertionError(f"{label} decode_32k: ids {tok}")
    peak = torch.cuda.max_memory_allocated(dev)
    cache_bytes = 2 * k.numel() * k.element_size()
    out["decode_32k"] = {"ms": ms, "peak_bytes": peak, "batch": decode_batch,
                         "seq": s, "cache_bytes": cache_bytes}
    log(f"{label}: decode_32k {decode_batch} x {s} "
        f"({cache_bytes / 2**30:.2f} GiB cache): steps "
        f"{[round(x, 2) for x in ms]} ms, peak {peak / 2**30:.2f} GiB")
    _check_counts(f"{label} serving cells", _counts(), {})
    del cache, k, v
    torch.cuda.empty_cache()
    return out


def granite_path(dev, smoke: bool = False) -> dict:
    """Phase 39: granite-moe-1b-a400m at its published widths (24 layers,
    d 1024, 32 experts top-8 of width 512, vocab 49155, bf16), world 1.
    ``train_4k`` at its 4096 tokens with remat, the global batch cut from
    256 to TRAIN4K_BATCH sequences in as many microbatches as a 1 x 4096
    remat step's peak allows (as phase 29 cuts gemma's), pbox AdamW,
    TRAIN4K_STEPS steps (1 fused_agg_opt each, bf16 operands), each
    step's aux loss and the share of assignments the capacity dropped;
    then ``prefill_32k`` at 1 x 32768 twice and ``decode_32k`` at
    DECODE_BATCH sequences, DECODE_STEPS steps.  ``smoke``: the SMOKE
    config and cells.  Call inside ``world_one`` and ``deterministic``."""
    import torch

    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_lm_train, make_exchange
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import init_train_state, local_state

    arch = get_arch("granite-moe-1b-a400m")
    cfg = arch.smoke_config if smoke else arch.config
    seq = 64 if smoke else REMAT_SEQ
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    b = next(lm_batches(cfg.vocab, 1, seq, 0))
    toks, labs = (torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels"))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    res = {}
    probe_ms = timed(lambda: res.update(zip(
        ("loss", "grads"), T.lm_loss_and_grad(params, toks, labs, cfg))))
    probe = torch.cuda.max_memory_allocated(dev) - base
    if not math.isfinite(res["loss"].item()):
        raise AssertionError(f"granite: probe loss {res['loss']}")
    del res, params
    torch.cuda.empty_cache()

    n = cfg.param_count()
    state_bytes = n * (2 + 2 + 2 + 8) + 2 * n
    free = 0.85 * torch.cuda.get_device_properties(dev).total_memory
    rows = max(1, int((free - state_bytes) // probe))
    rows = max(r for r in (1, 2, 4, 8) if r <= rows)
    mb = TRAIN4K_BATCH // rows
    mesh = make_mesh((1, 1), ("data", "model"))
    cell = ShapeCell("train_4k", "train", {"seq_len": REMAT_SEQ,
                                           "global_batch": TRAIN4K_BATCH})
    ex = make_exchange(mesh, "lm")
    plan = build_lm_train(
        dataclasses.replace(arch, microbatches={"train_4k": mb}), cell, mesh,
        ex, smoke=smoke)
    if smoke:
        mb = rows = plan.meta["microbatches"]
    state = init_train_state(
        mesh, init_params_fn=lambda g: T.init_params(cfg, g),
        param_specs=T.make_param_specs(cfg, 1), exchange=ex,
        space=plan.meta["space"], n_groups=1,
        key=torch.Generator(device=dev).manual_seed(0),
        ps_dtype=cfg.param_dtype, device=dev)
    pflat, slots, ef, stc = local_state(state, mesh, ex)
    del state
    gb, s = plan.abstract_args[4]["tokens"].shape
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in bb.items()}
               for bb in itertools.islice(lm_batches(
                   cfg.vocab, gb, s, 0), TRAIN4K_STEPS)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    losses, auxes, dropped, step_ms, capacity = [], [], [], [], set()
    for bb in batches:
        res = {}
        with MoEDrops() as drops:
            step_ms.append(timed(lambda: res.update(
                zip(("p", "s", "e", "c", "m"), plan.fn(pflat, slots, ef, stc,
                                                        bb)))))
        pflat, slots, ef, stc = res["p"], res["s"], res["e"], res["c"]
        losses.append(res["m"]["loss"])
        auxes.append(res["m"]["aux"].item())
        dropped.append(drops.share_dropped())
        capacity |= drops.capacity
    launches = _counts()
    _check_counts("granite train_4k", launches,
                  {"fused_agg_opt": TRAIN4K_STEPS})
    peak = torch.cuda.max_memory_allocated(dev)
    losses = finite_losses(losses)
    if not all(math.isfinite(a) and a > 0 for a in auxes):
        raise AssertionError(f"granite: aux losses {auxes}")
    log(f"phase 39: granite train_4k {gb} x {s} in {mb} microbatches of "
        f"{rows} (a 1 x {seq} remat step: {probe_ms:.1f} ms, peak "
        f"{probe / 2**30:.2f} GiB above the weights): steps "
        f"{[round(x, 1) for x in step_ms]} ms, losses {losses}, aux "
        f"{auxes}, assignments dropped by the capacity "
        f"{[round(x, 5) for x in dropped]} (capacity {sorted(capacity)} "
        f"slots an expert), peak {peak / 2**30:.2f} GiB, launches {launches}")
    del pflat, slots, ef, batches
    torch.cuda.empty_cache()
    out = {"train_4k": {"step_ms": step_ms, "losses": losses, "aux": auxes,
                        "dropped": dropped, "capacity": sorted(capacity),
                        "peak_bytes": peak, "launches": launches,
                        "microbatches": mb, "rows": rows,
                        "probe_bytes": probe, "probe_ms": probe_ms},
           "flat": plan.meta["space"].flat_elems}
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    out.update(_lm_serve("granite-moe-1b-a400m", params, cfg, mesh, dev,
                         smoke, DECODE_BATCH, "phase 39: granite"))
    del params
    torch.cuda.empty_cache()
    return out


def qwen2_moe_serve_path(dev, smoke: bool = False) -> dict:
    """Phase 40: qwen2-moe-a2.7b served at its published widths (24
    layers, d 2048, 60 experts top-4 of width 1408 and a shared expert of
    5632, vocab 151936; 14.3B parameters, 28.6 GB in bf16), world 1:
    ``prefill_32k`` at 1 x 32768 once and ``decode_32k`` at the largest
    batch whose cache fits beside the weights (QWEN_DECODE_MARGIN left
    over), DECODE_STEPS steps.  No training: AdamW's f32 slots alone (~115
    GB) exceed the card.  ``smoke``: the SMOKE config and cells.  Call
    inside ``world_one``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T

    arch = get_arch("qwen2-moe-a2.7b")
    cfg = arch.smoke_config if smoke else arch.config
    mesh = make_mesh((1, 1), ("data", "model"))
    torch.cuda.empty_cache()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.empty_cache()
    weights = torch.cuda.memory_allocated(dev)
    cache_shape = build_cell("qwen2-moe-a2.7b", "decode_32k", mesh,
                             smoke=smoke).abstract_args[2]["k"].shape
    per_seq = 2 * math.prod(cache_shape) // cache_shape[1] * (
        2 if cfg.dtype == torch.bfloat16 else 4)
    total = torch.cuda.get_device_properties(dev).total_memory
    batch = int((total - weights - QWEN_DECODE_MARGIN) // per_seq)
    batch = max(1, min(batch, cache_shape[1], DECODE_BATCH))
    log(f"phase 40: qwen2-moe-a2.7b, {cfg.param_count()} parameters, "
        f"{weights / 2**30:.2f} GiB of weights on the card; a sequence's "
        f"decode_32k cache {per_seq / 2**30:.2f} GiB: batch {batch} (from "
        f"{arch.cell('decode_32k').params['global_batch']})")
    out = _lm_serve("qwen2-moe-a2.7b", params, cfg, mesh, dev, smoke, batch,
                    "phase 40: qwen2-moe", prefills=1)
    out["weights_bytes"] = weights
    del params
    torch.cuda.empty_cache()
    return out


def moe_routing_check(dev) -> dict:
    """Phase 41's routing: ``route_topk``'s experts and
    ``dispatch_indices``' ``buf_pos`` / ``keep`` on the card bitwise equal
    to the CPU's on the same f32 logits (seeded normal rows, a row of
    all-equal logits and rows with three-way ties at the top), for
    granite's and qwen2-moe's expert counts and a small case; capacity at
    the configs' factor 1.25 and at 0.25 (most assignments dropped)."""
    import numpy as np
    import torch

    from repro_torch.models.moe import MoEConfig, dispatch_indices, route_topk

    out = {}
    for t, e, k in ROUTING_CASES:
        rng = np.random.default_rng(t + e + k)
        logits = rng.standard_normal((t, e)).astype(np.float32)
        logits[0] = 0.0
        logits[1:4, :3] = 4.0
        for cf in (1.25, 0.25):
            cfg = MoEConfig(n_experts=e, top_k=k, d_ff_expert=8,
                            capacity_factor=cf)
            got, want = [], []
            for device, sink in ((dev, got), (torch.device("cpu"), want)):
                x = torch.from_numpy(logits).to(device)
                w, idx, aux = route_topk(x, cfg)
                pos, keep = dispatch_indices(idx, cfg, cfg.capacity(t))
                sink.extend(z.cpu() for z in (idx, pos, keep, w, aux))
            for name, a, b in zip(("experts", "buf_pos", "keep"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(f"routing T={t} E={e} k={k} cf={cf}:"
                                         f" {name} differs card vs CPU")
            err = max(_rs_close(f"routing T={t} E={e} {n}", a, b)
                      for n, a, b in zip(("weights", "aux"), got[3:], want[3:]))
            out[f"{t}x{e}/k{k}/cf{cf}"] = {
                "dropped": 1.0 - want[2].float().mean().item(), "err": err}
    log(f"phase 41: MoE routing card == CPU bitwise (experts, buf_pos, keep) "
        f"over {len(out)} cases; " + ", ".join(
            f"{name} dropped {c['dropped']:.4f}" for name, c in out.items()))
    return out


def _rn_smoke_fabric(dev, cfg, params, rounds: int, booked: dict | None):
    """Phase 41's ResNet SMOKE fabric (2 workers x 2 images at 32^2, 4
    shards, momentum) on ``dev``.  ``booked`` None: record every gradient
    (on the host) by (worker, step); else compare each gradient computed
    here against the booked one and feed the fabric the booked one.
    Returns (fabric params after each round, the gradients, max |err|)."""
    import torch

    from repro_torch.core.chunking import ParamSpace
    from repro_torch.core.config import FabricConfig
    from repro_torch.core.fabric import PBoxFabric, WorkerHarness
    from repro_torch.optim.optimizers import momentum

    p = _tree_to(params, dev)
    space = ParamSpace.build(p)
    fab = PBoxFabric(space, momentum(0.1, 0.9), space.flatten(p), device=dev,
                     config=FabricConfig(num_shards=SHARDS,
                                         num_workers=RN_WORKERS))
    streams = [iter(_rn_batches(cfg, 2, 32, rounds, w, dev))
               for w in range(RN_WORKERS)]
    grads, err = {}, [0.0]

    def grad_fn(pulled, wstep):
        _, g = _rn_loss_and_grad(pulled, next(streams[wstep[0]]), cfg)
        if booked is None:
            grads[wstep] = _tree_to(g, "cpu")
            return g
        want = booked[wstep]
        for a, b in zip(_leaves(g), _leaves(want)):
            err[0] = max(err[0], _rs_close(f"resnet SMOKE gradient {wstep}",
                                           a, b, RN_CARD_RTOL, RN_CARD_ATOL))
        return _tree_to(want, dev)

    h = WorkerHarness(fab, grad_fn, lambda w, s: (w, s))
    flats = []
    for r in range(1, rounds + 1):
        h.run(r)
        flats.append(fab.params.cpu())
    return flats, grads, err[0]


def _atol_reading(a, b, rtol: float) -> float:
    """The least atol under which ``torch.allclose(a, b, rtol, atol)``
    holds: max(|a - b| - rtol |b|), in f64 on the host."""
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    return ((a - b).abs() - rtol * b.abs()).max().item()


def _rn_tf32_control(dev, cfg, params) -> dict:
    """Phase 41's control for RN_CARD_RTOL / RN_CARD_ATOL: ResNet's SMOKE
    loss and gradients (2 images at 32^2) on the card against the CPU's,
    once through the model (``resnet._conv2d``: cuDNN's TF32 off) and once
    with its convolutions as plain ``F.conv2d`` under cuDNN's TF32
    (torch's default).  Each reading is the least atol under which every
    leaf passes at RN_CARD_RTOL (``_atol_reading``); the model's must lie
    under RN_CARD_ATOL and the control's above it."""
    from unittest import mock

    import torch
    import torch.nn.functional as F

    from repro_torch.models import resnet as RN

    batch = _rn_batches(cfg, 2, 32, 1, 9, dev)[0]
    want = _rn_loss_and_grad(params, {k: v.cpu() for k, v in batch.items()},
                             cfg)
    p = _tree_to(params, dev)

    def reading():
        loss, g = _rn_loss_and_grad(p, batch, cfg)
        return max(_atol_reading(a, b, RN_CARD_RTOL) for a, b in zip(
            [loss, *_leaves(g)], [want[0], *_leaves(want[1])]))

    sound = reading()
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with mock.patch.object(RN, "_conv2d", lambda x, w, stride, padding:
                               F.conv2d(x, w, stride=stride, padding=padding)):
            tf32 = reading()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    log(f"phase 41: resnet SMOKE loss and gradients card vs CPU at rtol "
        f"{RN_CARD_RTOL}: the least passing atol is {sound:.3g} through the "
        f"model (TF32 off), {tf32:.3g} with cuDNN's TF32 convolutions "
        f"(control); RN_CARD_ATOL {RN_CARD_ATOL}")
    if not sound <= RN_CARD_ATOL < tf32:
        raise AssertionError(
            f"resnet SMOKE: RN_CARD_ATOL {RN_CARD_ATOL} does not separate the "
            f"model's reading {sound} from the TF32 control's {tf32}")
    return {"sound": sound, "tf32": tf32}


def _rn_smoke_spmd(mesh, params, dev) -> dict:
    """One ``imagenet_train`` SMOKE step (momentum) on ``mesh`` from
    ``params`` copied to ``dev``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import build_cell

    cfg = get_arch("resnet50").smoke_config
    plan = build_cell("resnet50", "imagenet_train", mesh, smoke=True)
    space = plan.meta["space"]
    p = _tree_to(params, dev)
    bt = plan.abstract_args[4]["images"].shape
    b = _rn_batches(cfg, bt[0], bt[1], 1, 0, dev)[0]
    slots = tuple(torch.zeros((1, space.flat_elems), device=dev)
                  for _ in plan.meta["sspecs"]["slots"])
    stc = torch.zeros((), dtype=torch.int32, device=dev)
    pf, sl, _, _, met = plan.fn(space.flatten(p).reshape(1, -1), slots, None,
                                stc, b)
    return {"pflat": pf, "momentum": sl[0], "loss": met["loss"]}


def _lm_smoke_run(arch_id: str, mesh, params, dev) -> dict:
    """One ``train_4k`` SMOKE step by pbox with SGD(0.1) on ``mesh``, then
    a prefill of 2 x SMOKE_PROMPT tokens and SMOKE_DECODE_STEPS greedy
    decode steps, from ``params`` copied to ``dev``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as T
    from repro_torch.optim.optimizers import sgd

    cfg = get_arch(arch_id).smoke_config
    plan = build_cell(arch_id, "train_4k", mesh, smoke=True, opt=sgd(0.1))
    space = plan.meta["space"]
    p = _tree_to(params, dev)
    gb, s = plan.abstract_args[4]["tokens"].shape
    b = {k: torch.from_numpy(v).to(dev)
         for k, v in next(lm_batches(cfg.vocab, gb, s, 0)).items()}
    stc = torch.zeros((), dtype=torch.int32, device=dev)
    pf, _, _, _, met = plan.fn(space.flatten(p, cfg.param_dtype).reshape(1, -1),
                               (), None, stc, b)
    out = {"pflat": pf, "loss": met["loss"], "aux": met["aux"]}
    toks = b["tokens"][:, :SMOKE_PROMPT]
    with torch.no_grad():
        ids, cache = T.prefill(p, toks, cfg, SMOKE_PROMPT + SMOKE_DECODE_STEPS)
        out["prefill_ids"] = ids
        out["prefill_k"] = cache["k"].clone()
        seq = []
        for i in range(SMOKE_DECODE_STEPS):
            ids, cache = T.decode_step(p, ids, cache, SMOKE_PROMPT + i, cfg)
            seq.append(ids)
    out["decode_ids"] = torch.stack(seq)
    out["cache_k"], out["cache_v"] = cache["k"], cache["v"]
    return out


def new_archs_smoke_check(dev) -> dict:
    """Phase 41: the new archs at their SMOKE configs, the card against
    the CPU (a ``LocalMesh``, the kernels' plain versions) from the same
    seeded params: resnet50's 2 fabric rounds (each gradient booked on the
    card and fed to the CPU fabric after it is compared with the CPU's
    own, so the fabrics' params stay bitwise equal) and one SPMD step
    (loss, params, momentum), within RN_CARD_RTOL / RN_CARD_ATOL; within
    RS_CARD_RTOL / RS_CARD_ATOL, granite,
    qwen2-moe, internlm2 and qwen2-72b each one ``train_4k`` step (SGD:
    AdamW's first step is lr times the gradient's sign, which a gradient
    within rounding of 0 flips), a prefill and SMOKE_DECODE_STEPS decode
    steps (greedy ids equal; the train step within RS_CARD_RTOL /
    RS_CARD_ATOL, the caches within RS_CARD_RTOL of their largest entry,
    ``_scaled_close``); the MoE routing
    bitwise (``moe_routing_check``); resnet's bound against a TF32 control
    (``_rn_tf32_control``).  Each case's launches equal the CPU
    run's plain-version calls.  Call inside ``world_one``,
    ``deterministic``."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import resnet as RN
    from repro_torch.models import transformer as T

    cpu = torch.device("cpu")
    mesh = make_mesh((1, 1), ("data", "model"))
    cpu_mesh = LocalMesh(("data", "model"))
    out = {}

    cfg = get_arch("resnet50").smoke_config
    params = RN.init_params(cfg, torch.Generator().manual_seed(0))
    _zero_counts()
    card_flats, booked, _ = _rn_smoke_fabric(dev, cfg, params, 2, None)
    launches = _counts()
    with PlainCalls() as plain:
        cpu_flats, _, gerr = _rn_smoke_fabric(cpu, cfg, params, 2, booked)
    want = plain.counts | _rn_launches(cfg, 32, RN_WORKERS * 2)
    if launches != want:
        raise AssertionError(f"resnet SMOKE fabric: card launches {launches},"
                             f" CPU plain calls and the fused norms' and "
                             f"copies' count {want}")
    if not all(same_bits(a, b) for a, b in zip(card_flats, cpu_flats)):
        raise AssertionError("resnet SMOKE fabric: params differ card vs CPU "
                             "on the same gradients")
    out["resnet50/fabric"] = {"launches": launches, "max_abs_err": gerr}
    _zero_counts()
    card = _rn_smoke_spmd(mesh, params, dev)
    launches = _counts()
    with PlainCalls() as plain:
        ref = _rn_smoke_spmd(cpu_mesh, params, cpu)
    want = plain.counts | _rn_launches(cfg, 32, 1)
    if launches != want:
        raise AssertionError(f"resnet SMOKE spmd: card launches {launches},"
                             f" CPU plain calls and the fused norms' and "
                             f"copies' count {want}")
    out["resnet50/spmd"] = {"launches": launches, "max_abs_err": max(
        _rs_close(f"resnet SMOKE spmd {k}", card[k], ref[k], RN_CARD_RTOL,
                  RN_CARD_ATOL) for k in card)}
    out["resnet50/tf32_control"] = _rn_tf32_control(dev, cfg, params)

    for arch_id in SMOKE_NEW_LM:
        cfg = get_arch(arch_id).smoke_config
        params = T.init_params(cfg, torch.Generator().manual_seed(0))
        _zero_counts()
        card = _lm_smoke_run(arch_id, mesh, params, dev)
        launches = _counts()
        with PlainCalls() as plain:
            ref = _lm_smoke_run(arch_id, cpu_mesh, params, cpu)
        if launches != plain.counts:
            raise AssertionError(f"{arch_id} SMOKE: card launches {launches},"
                                 f" CPU plain calls {plain.counts}")
        for key in ("prefill_ids", "decode_ids"):
            if not torch.equal(card[key].cpu(), ref[key]):
                raise AssertionError(f"{arch_id} SMOKE {key}: card "
                                     f"{card[key].tolist()} CPU "
                                     f"{ref[key].tolist()}")
        errs, bad = {}, []
        for k in card:
            if k.endswith("_ids"):
                continue
            check = _scaled_close if k in LM_CACHE_KEYS else _rs_close
            try:
                errs[k] = check(f"{arch_id} SMOKE {k}", card[k], ref[k])
            except AssertionError as e:
                bad.append(str(e))
        if bad:
            raise AssertionError("; ".join(bad))
        out[arch_id] = {"launches": launches,
                        "max_abs_err": max(errs.values()), "errs": errs}
    out["routing"] = moe_routing_check(dev)
    log(f"phase 41: resnet50 (2 fabric rounds on booked gradients, params "
        f"bitwise; one SPMD step) and {', '.join(SMOKE_NEW_LM)} (a train "
        f"step, a prefill, {SMOKE_DECODE_STEPS} decode steps) at SMOKE, card "
        f"== CPU within rtol {RN_CARD_RTOL} / atol {RN_CARD_ATOL} (resnet) and"
        f" rtol {RS_CARD_RTOL} / atol {RS_CARD_ATOL} (the LMs' train steps; "
        f"their caches within {RS_CARD_RTOL} of the largest entry): "
        + ", ".join(
            f"{name} max |err| {c['max_abs_err']:.3g}" + (
                f" ({', '.join(f'{k} {v:.3g}' for k, v in c['errs'].items())})"
                if "errs" in c else "")
            for name, c in out.items() if "max_abs_err" in c))
    return out


# -- phases 42 and 43: EquiformerV2 ------------------------------------------
# phase 42: the two graph cells one card holds at full width (molecule
# through launch/train.main, full_graph_sm through build_cell's plan),
# GNN_STEPS AdamW steps each; step GNN_BOOK + 1's update booked and
# replayed on the CPU, the last step profiled
GNN_STEPS, GNN_BOOK = 3, 0
GNN_FULL = ("molecule", "full_graph_sm")
# phase 43: every graph cell at SMOKE (molecule also under variant "ep"),
# one SGD(0.1) step card against CPU (AdamW's first step is lr times the
# gradient's sign, which a gradient within rounding of 0 flips).  The f32
# cells within RS_CARD_RTOL / RS_CARD_ATOL; ogb_products carries its nodes
# in bf16 (as JAX's graph_full_large does), where the card's and the
# CPU's f32 sums round to different bf16 values here and there: its loss
# and params within GNN_BF16_RTOL of the largest entry.  The first card
# run (NVIDIA H100 80GB HBM3, 700.00 W) read 1.88e-5 on the params and
# 2.05e-5 on a loss of 2.32 (the f32 cells at most 3.1e-6); the bound is
# 50x that, far under one bf16 ulp at 1 (7.8e-3)
GNN_SMOKE_CASES = (("full_graph_sm", None), ("minibatch_lg", None),
                   ("ogb_products", None), ("molecule", None),
                   ("molecule", "ep"))
GNN_BF16_RTOL = 1e-3
# phase 31's 4 gloo ranks also run full_graph_sm at SMOKE on a (2, 2)
# mesh, channel TP and variant "ep" (one SGD(0.1) step each), against
# tp = 1 on the card at rtol 2e-5 / atol 1e-5 (the LM SMOKE bound there)
GNN_TP_RTOL, GNN_TP_ATOL = 2e-5, 1e-5


def _gnn_batch(plan, seed: int, workers: int = 1) -> dict:
    """``data/graphs.cell_batch`` for a GNN plan (numpy)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.graphs import cell_batch

    cfg = plan.meta["config"]
    kind = get_arch(plan.arch_id).cell(plan.shape).kind
    return cell_batch(kind, plan.abstract_args[4], cfg.l_max, cfg.n_rbf,
                      seed=seed, workers=workers)


def gnn_path(dev, smoke: bool = False) -> dict:
    """Phase 42: EquiformerV2 at its published widths (12 layers, C = 128,
    l_max 6, m_max 2, 8 heads), world 1, pbox AdamW(1e-3), GNN_STEPS steps
    of each GNN_FULL cell: ``molecule`` (128 molecules of 30 atoms and 64
    edges, graph regression) through ``launch/train.main --full``, and
    ``full_graph_sm`` (cora's 2,708 nodes, 10,556 edges, 1,433 features,
    7 classes) through ``build_cell``'s plan on one seeded graph.  Counts
    set to 0 just before and read just after: 1 fused_agg_opt a step (K =
    1, f32); step 1's ``device_update`` booked over three windows and
    replayed on the CPU through the plain version, bitwise; finite losses;
    step 2's ms (host clock), the peak, and the last step profiled (device
    busy, idle share, the top device ops).  ``smoke``: the SMOKE cells.
    Call inside ``world_one`` and ``deterministic``."""
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import main
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.runtime.trainer import init_train_state, local_state

    out = {}
    for shape in GNN_FULL:
        t_shape = time.perf_counter()
        book, events, step_ms, keep = {}, [], [], {}
        # device activity only: the step's ~10,000 host ops would make
        # the event tree ~20 s to build, and no host range is read here
        prof = profile(activities=[ProfilerActivity.CUDA])

        def instrument(plan):
            ex = plan.meta["exchange"]
            keep.update(plan=plan, ex=ex, real=book_update(
                ex, book, events, GNN_BOOK, ex.cfg.compression.chunk_elems))
            fn = plan.fn

            def step(*args):
                res = {}
                last = len(step_ms) == GNN_STEPS - 1
                if last:
                    prof.start()
                step_ms.append(timed(lambda: res.update(out=fn(*args))))
                if last:
                    prof.stop()
                return res["out"]

            plan.fn = step
            return plan

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        if shape == "molecule":
            build = ST.build_cell
            argv = ["--arch", "equiformer-v2", "--steps", str(GNN_STEPS),
                    "--log-every", str(GNN_STEPS)] + ([] if smoke else
                                                      ["--full"])
            with mock.patch.object(ST, "build_cell",
                                   lambda *a, **k: instrument(build(*a, **k))):
                _zero_counts()  # every count to 0 just before the path...
                res = main(argv, device=dev)
                launches = _counts()  # ...and read just after
            losses = [float(x) for x in res["losses"]]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"gnn molecule: losses {losses}")
            pflat = res["pflat"]
            del res
        else:
            mesh = make_mesh((1, 1), ("data", "model"))
            plan = instrument(ST.build_cell("equiformer-v2", shape, mesh,
                                            smoke=smoke))
            cfg, ex = plan.meta["config"], plan.meta["exchange"]
            state = init_train_state(
                mesh, init_params_fn=lambda g: EQ.init_params(cfg, g),
                param_specs=EQ.make_param_specs(cfg, 1), exchange=ex,
                space=plan.meta["space"], n_groups=1,
                key=torch.Generator(device=dev).manual_seed(0), device=dev)
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in _gnn_batch(plan, 0).items()}
            pflat, slots, ef, stc = local_state(state, mesh, ex)
            del state
            loss_t = []
            _zero_counts()
            for _ in range(GNN_STEPS):
                pflat, slots, ef, stc, met = plan.fn(pflat, slots, ef, stc,
                                                     batch)
                loss_t.append(met["loss"])
            launches = _counts()
            losses = finite_losses(loss_t)
            del slots, ef, batch
        _check_counts(f"gnn {shape}", launches, {"fused_agg_opt": GNN_STEPS})
        peak = torch.cuda.max_memory_allocated(dev)
        plan, ex = keep["plan"], keep["ex"]
        if not torch.isfinite(pflat).all():
            raise AssertionError(f"gnn {shape}: params not finite")
        update_ms = [a.elapsed_time(b) for a, b in events]
        run_s = time.perf_counter() - t_shape
        err = replay_book(keep["real"], book, ("data", "model"))
        ex.device_update = keep["real"]
        cfg = plan.meta["config"]
        log(f"phase 42: equiformer-v2 {shape} ({plan.meta['nodes']} nodes, "
            f"{plan.meta['edges']} edges, d_in {cfg.d_in}, {cfg.task}, flat "
            f"{plan.meta['space'].flat_elems}, {plan.meta['model_flops']:.4g}"
            f" model FLOPs a step): losses {losses}, steps "
            f"{[round(x, 1) for x in step_ms]} ms (host clock; the last "
            f"profiled), device_update {[round(x, 3) for x in update_ms]} "
            f"ms, peak {peak / 2**30:.2f} GiB, launches {launches}; step "
            f"{GNN_BOOK + 1}'s update replayed on the CPU over 3 windows "
            f"bitwise; {run_s:.1f} s to the last step (set-up, host graph "
            f"featurization and the steps), "
            f"{time.perf_counter() - t_shape - run_s:.1f} s replaying")
        t_prof = time.perf_counter()
        breakdown = profile_summary(prof, step_ms[1], None, "fused_agg_opt",
                                    "fused_agg_opt_kernel")
        out[shape] = {
            "launches": launches, "losses": losses, "step_ms": step_ms,
            "update_ms": update_ms, "peak_bytes": peak, "replay_err": err,
            "flat": plan.meta["space"].flat_elems,
            "nodes": plan.meta["nodes"], "edges": plan.meta["edges"],
            "model_flops": plan.meta["model_flops"], **breakdown,
            "seconds": time.perf_counter() - t_shape,
            "profile_s": time.perf_counter() - t_prof}
        del pflat, plan, ex, keep, prof, book
        torch.cuda.empty_cache()
    return out


def _gnn_smoke_step(plan, params, batch: dict, dev) -> dict:
    """One step of a SMOKE GNN plan on ``dev`` from ``params``: the new
    flat and the loss."""
    import torch

    space = plan.meta["space"]
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    stc = torch.zeros((), dtype=torch.int32, device=dev)
    pf, _, _, _, met = plan.fn(space.flatten(_tree_to(params, dev))
                               .reshape(1, -1), (), None, stc, b)
    return {"pflat": pf, "loss": met["loss"]}


def gnn_smoke_check(dev) -> dict:
    """Phase 43: every GNN_SMOKE_CASES case, one SGD(0.1) step of its
    SMOKE plan on the card (world 1) and on the CPU (a ``LocalMesh``, the
    kernels' plain versions) from the same seeded params and batch: the
    loss and the new flat within RS_CARD_RTOL / RS_CARD_ATOL (the bf16
    cell within GNN_BF16_RTOL of the largest entry); each case's launches
    equal the CPU run's plain-version calls.  Call inside ``world_one``
    and ``deterministic``."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.optim.optimizers import sgd

    cpu = torch.device("cpu")
    mesh = make_mesh((1, 1), ("data", "model"))
    cpu_mesh = LocalMesh(("data", "model"))
    out = {}
    for shape, variant in GNN_SMOKE_CASES:
        name = shape + (f"/{variant}" if variant else "")
        plans = [build_cell("equiformer-v2", shape, m, smoke=True,
                            variant=variant, opt=sgd(0.1))
                 for m in (mesh, cpu_mesh)]
        cfg = plans[0].meta["config"]
        params = EQ.init_params(cfg, torch.Generator().manual_seed(0))
        batch = _gnn_batch(plans[0], 1)
        _zero_counts()
        card = _gnn_smoke_step(plans[0], params, batch, dev)
        launches = _counts()
        with PlainCalls() as plain:
            ref = _gnn_smoke_step(plans[1], params, batch, cpu)
        if launches != plain.counts or launches["fused_agg_opt"] != 1:
            raise AssertionError(f"gnn SMOKE {name}: card launches "
                                 f"{launches}, CPU plain calls {plain.counts}")
        if cfg.dtype == torch.bfloat16:
            errs = {k: _scaled_close(f"gnn SMOKE {name} {k}",
                                     card[k].reshape(-1), ref[k].reshape(-1),
                                     GNN_BF16_RTOL) for k in card}
        else:
            errs = {k: _rs_close(f"gnn SMOKE {name} {k}", card[k], ref[k])
                    for k in card}
        out[name] = {"launches": launches, "errs": errs,
                     "loss": card["loss"].item()}
    log(f"phase 43: equiformer-v2 SMOKE, one SGD step card == CPU (f32 "
        f"within rtol {RS_CARD_RTOL} / atol {RS_CARD_ATOL}, bf16 within "
        f"{GNN_BF16_RTOL} of the largest entry): "
        + ", ".join(f"{n} loss {c['loss']:.6f} max |err| "
                    f"{', '.join(f'{k} {v:.3g}' for k, v in c['errs'].items())}"
                    for n, c in out.items()))
    return out


def _gnn_tp_steps(mesh, dev) -> dict:
    """full_graph_sm at SMOKE on ``mesh``: one SGD(0.1) step under channel
    TP and one under variant "ep", each from the seeded tp = 1 params cut
    to this rank's pieces; the loss (the step's metric, loss / tp) and
    this rank's params after the step, on the host."""
    import torch

    from repro_torch.launch.steps import build_cell
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.optim.optimizers import sgd
    from repro_torch.runtime.trainer import local_params, shard_batch

    tp = mesh.shape["model"]
    nw = mesh.shape["data"]
    out = {}
    for variant in (None, "ep"):
        plan = build_cell("equiformer-v2", "full_graph_sm", mesh, smoke=True,
                          variant=variant, opt=sgd(0.1))
        cfg, space = plan.meta["config"], plan.meta["space"]
        params = EQ.init_params(cfg, torch.Generator().manual_seed(0))
        local = local_params(params, EQ.make_param_specs(cfg, tp), mesh)
        batch = _gnn_batch(plan, 2, nw)
        mine = {k: torch.from_numpy(v).to(dev) for k, v in shard_batch(
            batch, mesh, plan.meta["exchange"],
            plan.meta["batch_spec"]).items()}
        stc = torch.zeros((), dtype=torch.int32, device=dev)
        pf, _, _, _, met = plan.fn(space.flatten(_tree_to(local, dev))
                                   .reshape(1, -1), (), None, stc, mine)
        out[variant or "channel_tp"] = {
            "params": _tree_to(space.unflatten(pf[0]), "cpu"),
            "loss": met["loss"].item()}
    return out


def gnn_tp_check(ranks: list, dev) -> dict:
    """Phase 31's 4 ranks' ``_gnn_tp_steps`` on a (2, 2) mesh against tp = 1
    on the card (a ``LocalMesh``): each rank's loss x tp and its pieces of
    every parameter within GNN_TP_RTOL / GNN_TP_ATOL (channel TP: the
    rank's slice of tp = 1's; ep: the whole)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.runtime.trainer import take_local

    with deterministic():
        ref = _gnn_tp_steps(LocalMesh(("data", "model")), dev)
    specs = EQ.make_param_specs(get_arch("equiformer-v2").smoke_config, 2)
    err = 0.0
    for r, got in enumerate(ranks):
        j = got["model"]
        for variant, run in got["gnn"].items():
            want = ref[variant]
            if not math.isclose(run["loss"] * 2, want["loss"],
                                rel_tol=GNN_TP_RTOL, abs_tol=GNN_TP_ATOL):
                raise AssertionError(
                    f"gnn {variant} rank {r}: loss x tp {run['loss'] * 2} "
                    f"against tp = 1 {want['loss']}")
            flat_specs = dict(_named_leaves(specs))
            for (name, a), (_, w) in zip(_named_leaves(run["params"]),
                                         _named_leaves(want["params"])):
                if variant == "channel_tp":
                    w = take_local(w, flat_specs[name], j, 2)
                err = max(err, _rs_close(f"gnn {variant} rank {r} {name}", a,
                                         w, GNN_TP_RTOL, GNN_TP_ATOL))
    log(f"phase 31: equiformer-v2 SMOKE full_graph_sm on a (2, 2) mesh over "
        f"the 4 gloo ranks, channel TP and edge-parallel, one SGD step each"
        f" == tp = 1 on the card within rtol {GNN_TP_RTOL} / atol "
        f"{GNN_TP_ATOL} (max |err| {err})")
    return {"max_abs_err": err}


# -- phase 45: the example programs (repro_torch.examples) on the card --------
# train_100m_e2e at its published CFG for its 200 steps; the quickstart,
# gnn_molecules and recsys_serving at the JAX examples' own sizes, each
# from weights drawn on the CPU and held against the same program on the
# CPU; serve_lm and train_distributed_ps run inside phase 31's spawn
E2E_STEPS = 200
# train_distributed_ps inside phase 31's 4 ranks: its (2, 4) mesh needs 8;
# and at tp = 1 on its 2 ranks (the same 2 workers: the same global batch)
EX_PS_MESH, EX_PS_TP1_MESH = (2, 2), (2, 1)
# its loss curve at tp = 2 against tp = 1 (phase 31's SMOKE tp bound):
# on an H100 80GB HBM3 the curves differ by 7.7e-8, and 5 steps move the
# loss by 4.5e-3
EX_PS_RTOL = 2e-5
# the oracle's bounds (tests/test_torch_fused_agg_opt.py, f32 params and
# the state slots): fused_aggregate_update_ref follows apply_update's op
# order, not the kernel's, so it is held at a tolerance, and the kernel
# bitwise against its plain version
E2E_REF_ATOL = (1e-6, 1e-5)
# the gnn_molecules curve card against CPU, between two readings on an
# H100 80GB HBM3: 1.7e-6 at most in sound runs, 4.4e-3 for the control
# (TF32 products on the card)
GNN_EX_RTOL = 1e-4


def book_updates(book: list, calls: int | None = None):
    """A ``LaunchTimer`` hook on the ``fused_aggregate_update`` a module
    calls (its bound name): host copies of each of the first ``calls``
    calls' operands (all calls for None), from before the call (the kernel
    updates in place), and of its results, appended to ``book``."""
    import torch

    def host(x):
        if isinstance(x, (list, tuple)):
            return [None if t is None else _host(t) for t in x]
        return _host(x) if torch.is_tensor(x) else x

    def hook(args, kwargs):
        if calls is not None and len(book) >= calls:
            return None
        grads, param, state, spec, step, *lr = args
        kw = dict(kwargs)
        lr = lr[0] if lr else kw.pop("lr_scale", 1.0)
        entry = {"in": (host(grads), _host(param), host(state), spec,
                        int(step), host(lr),
                        {k: host(v) for k, v in kw.items()})}
        book.append(entry)

        def after(out):
            entry["out"] = (_host(out[0]), host(out[1]))
        return after

    return hook


def replay_updates(dev, book: list, label: str) -> float:
    """Each booked update through fused_agg_opt's plain version on the
    card, on the same operands: the kernel's results bitwise required.
    Returns the largest |err|."""
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet

    def card(x):
        if isinstance(x, list):
            return [None if t is None else t.to(dev) for t in x]
        return x.to(dev) if torch.is_tensor(x) else x

    err = 0.0
    for i, entry in enumerate(book):
        grads, p, st, spec, step, lr, kw = map(card, entry["in"])
        want_p, want_s = K.fused_agg_opt_torch(
            grads, p, tuple(st), scalar_packet(spec, step, lr, device=dev),
            spec, **{k: card(v) for k, v in kw.items()})
        got_p, got_s = entry["out"]
        pairs = [(got_p, want_p.cpu()),
                 *zip(got_s, (w.cpu() for w in want_s))]
        err = max([err] + [max_abs_err(a, b) for a, b in pairs])
        if not all(same_bits(a, b) for a, b in pairs):
            raise AssertionError(f"{label}: update {i + 1} (step {step}) "
                                 f"differs from the plain version, max "
                                 f"|err| {err}")
    return err


def replay_first_update(dev, entry: dict) -> dict:
    """train_100m_e2e's booked first update through the oracle
    ``fused_aggregate_update_ref`` (within E2E_REF_ATOL); ``replay_updates``
    holds it bitwise against the plain version."""
    from repro_torch.kernels.fused_agg_opt.ref import (
        fused_aggregate_update_ref,
    )

    grads, p, st, spec, step, lr, kw = entry["in"]
    lr = lr.to(dev) if hasattr(lr, "to") else lr
    got_p, got_s = entry["out"]
    ref_p, ref_s = fused_aggregate_update_ref(
        grads.to(dev), p.to(dev), tuple(s.to(dev) for s in st), spec, step,
        lr, **kw)
    ref_pairs = [(got_p, ref_p.cpu()), *zip(got_s, (w.cpu() for w in ref_s))]
    ref_err = [max_abs_err(a, b) for a, b in ref_pairs]
    ref_bits = [same_bits(a, b) for a, b in ref_pairs]
    if ref_err[0] > E2E_REF_ATOL[0] or max(ref_err[1:]) > E2E_REF_ATOL[1]:
        raise AssertionError(f"train_100m_e2e's first update against "
                             f"fused_aggregate_update_ref: max |err| "
                             f"{ref_err} (bounds {E2E_REF_ATOL})")
    return {"ref_max_abs_err": ref_err, "ref_bitwise": ref_bits,
            "step": step, "lr_scale": float(lr), "n": int(got_p.numel())}


def e2e_path(dev, smoke: bool = False) -> dict:
    """``repro_torch.examples.train_100m_e2e`` at its published CFG (12
    layers, d 512, ff 2048, vocab 32768, f32) for E2E_STEPS steps of 4 x
    128 tokens, checkpoints every 100 into a temporary directory.  Counts
    set to 0 just before and read just after: one fused_agg_opt a step (K
    = 1, f32 AdamW, no averaging) and nothing else; the first update
    booked and replayed (``replay_updates``, ``replay_first_update``); the
    loss falls (the example's own
    check) and stays finite; the last checkpoint equals the final state
    bitwise.  Reads the steady step (host clock between consecutive
    updates, each step ending in the loss's ``item()``), each launch's
    CUDA-event ms inside the run, and the peak.  ``smoke``: 2 layers, d
    64, vocab 512, 24 steps."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.examples import train_100m_e2e as E

    cfg, steps = E.CFG, E2E_STEPS
    if smoke:
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=64, head_dim=8,
                                  d_ff=256, vocab=512)
        steps = 24
    tmp = tempfile.mkdtemp(prefix="chip_smoke_e2e_")
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        book: list = []
        with LaunchTimer(E, "fused_aggregate_update",
                         book_updates(book, 1)) as lt:
            _zero_counts()  # every count to 0 just before the path...
            res = E.main(["--steps", str(steps), "--ckpt-dir", tmp],
                         device=dev, cfg=cfg,
                         ckpt_every=steps // 2 if smoke else 100)
            launches = _counts()  # ...and read just after
        peak = torch.cuda.max_memory_allocated(dev)
        _check_counts("train_100m_e2e", launches, {"fused_agg_opt": steps})
        losses = res["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train_100m_e2e: non-finite loss {losses}")
        host, _ = Checkpointer(tmp).restore()
        if int(host["step"]) != steps or not all(
                same_bits(torch.from_numpy(host[k][0]), v.cpu()) for k, v in
                (("pflat", res["pflat"]), ("slot0", res["slots"][0]),
                 ("slot1", res["slots"][1]))):
            raise AssertionError("train_100m_e2e: the last checkpoint is "
                                 "not the final state")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    err = replay_updates(dev, book, "train_100m_e2e")
    replay = dict(replay_first_update(dev, book[0]), max_abs_err=err)
    step_s = [b - a for a, b in zip(lt.stamps, lt.stamps[1:])]
    steady = statistics.median(step_s[len(step_s) // 10:])
    ms = lt.ms()
    out = {"losses": [losses[0], losses[-1]], "steps": steps,
           "params": res["params"], "flat": res["flat"],
           "s_per_step": res["s_per_step"], "steady_s_per_step": steady,
           "launch_ms_in_run": statistics.median(ms[1:]),
           "peak_bytes": peak, "launches": launches, "replay": replay}
    log(f"phase 45: train_100m_e2e ({'SMOKE-cut' if smoke else 'published'}"
        f" CFG, {res['params']} params, flat {res['flat']}) {steps} steps "
        f"on the card: loss {losses[0]:.4f} -> {losses[-1]:.4f}, steady "
        f"step {steady * 1e3:.2f} ms (host clock between updates; mean "
        f"{res['s_per_step'] * 1e3:.2f} ms with the first steps and the "
        f"checkpoints), fused_agg_opt {launches['fused_agg_opt']} launches, "
        f"{out['launch_ms_in_run']:.4f} ms a launch in the run (CUDA events "
        f"around the wrapper, median), peak "
        f"{peak / 2**30:.2f} GiB; first update (step {replay['step']}, "
        f"lr_scale {replay['lr_scale']:.6g}) == the plain version bitwise, "
        f"against fused_aggregate_update_ref max |err| "
        f"{replay['ref_max_abs_err']} (bitwise {replay['ref_bitwise']}); "
        f"the step-{steps} checkpoint == the final state bitwise")
    return out


def _ex_quickstart(dev, params_cpu) -> dict:
    """The quickstart on the card (its 40 rounds, counts read around the
    run) and its first round on the CPU from the same weights: round 1's
    two losses (both workers read the initial weights) card == CPU within
    RS_CARD_RTOL / RS_CARD_ATOL; every one of the run's updates (each
    shard's, every round) booked and replayed through the plain version
    on the card, bitwise."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.core import fabric
    from repro_torch.examples import quickstart as Q

    book: list = []
    with redirect_stdout(io.StringIO()), LaunchTimer(
            fabric, "fused_aggregate_update", book_updates(book)):
        _zero_counts()
        res = Q.main(device=dev, params=_tree_to(params_cpu, dev))
        launches = _counts()
    _check_counts("quickstart", launches,
                  {"fused_agg_opt": Q.ROUNDS * Q.SHARDS})
    err = replay_updates(dev, book, "quickstart")
    cpu = Q.build(device="cpu", params=params_cpu)
    cpu["harness"].run(1)
    for a, b in zip(res["losses"][:Q.WORKERS], cpu["losses"]):
        if not math.isclose(a, b, rel_tol=RS_CARD_RTOL, abs_tol=RS_CARD_ATOL):
            raise AssertionError(f"quickstart round 1 losses "
                                 f"{res['losses'][:2]} against the CPU's "
                                 f"{cpu['losses']}")
    if not all(math.isfinite(x) for x in res["losses"]):
        raise AssertionError(f"quickstart: non-finite loss {res['losses']}")
    return {"losses": [res["losses"][0], res["losses"][-1]],
            "cpu_round1": cpu["losses"], "pushes": res["pushes"],
            "pipeline_speedup": res["pipeline_speedup"],
            "launches": launches, "replayed": len(book),
            "replay_max_abs_err": err}


def _ex_gnn(dev, params_cpu, steps: int) -> dict:
    """gnn_molecules on the card and on the CPU from the same weights:
    step 0's MSE (before any update) within RS_CARD_RTOL / RS_CARD_ATOL,
    every step's within GNN_EX_RTOL, all finite.  Its control: the same
    run on the card with TF32 allowed in the f32 products, whose curve
    must part from the CPU's by more than GNN_EX_RTOL."""
    import io
    from contextlib import redirect_stdout

    import torch

    from repro_torch.examples import gnn_molecules as G

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    with redirect_stdout(io.StringIO()):
        card = G.main(device=dev, steps=steps,
                      params=_tree_to(params_cpu, dev))["losses"]
        cpu = G.main(device="cpu", steps=steps, params=params_cpu)["losses"]
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            control = G.main(device=dev, steps=steps,
                             params=_tree_to(params_cpu, dev))["losses"]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    if not all(math.isfinite(x) for x in card) or not math.isclose(
            card[0], cpu[0], rel_tol=RS_CARD_RTOL, abs_tol=RS_CARD_ATOL) or \
            not rel(card, cpu) <= GNN_EX_RTOL:
        raise AssertionError(f"gnn_molecules card {card} against CPU {cpu}")
    if not rel(control, cpu) > GNN_EX_RTOL:
        raise AssertionError(f"the check cannot tell TF32 products: the "
                             f"control's curve {control} is within rel "
                             f"{rel(control, cpu)} of the CPU's")
    return {"losses": card, "cpu_losses": cpu, "max_rel": rel(card, cpu),
            "control_max_rel": rel(control, cpu)}


def _ex_recsys(dev, params_cpu) -> dict:
    """recsys_serving on the card and on the CPU from the same weights:
    logits and retrieval scores within RS_CARD_RTOL / RS_CARD_ATOL, the
    top ids where neighbouring scores stand further apart."""
    import io
    from contextlib import redirect_stdout

    import numpy as np

    from repro_torch.examples import recsys_serving as R

    with redirect_stdout(io.StringIO()):
        card = R.main(device=dev, params=_tree_to(params_cpu, dev))
        cpu = R.main(device="cpu", params=params_cpu)
    for key in ("logits", "scores"):
        if not np.allclose(card[key], cpu[key], rtol=RS_CARD_RTOL,
                           atol=RS_CARD_ATOL):
            err = np.abs(card[key] - cpu[key]).max()
            raise AssertionError(f"recsys_serving {key}: card against CPU "
                                 f"max |err| {err}")
    ranked = np.sort(cpu["scores"])[::-1][:R.TOP + 1]
    tol = RS_CARD_ATOL + RS_CARD_RTOL * np.abs(ranked)
    apart = [ranked[i] - ranked[i + 1] > tol[i]
             and (i == 0 or ranked[i - 1] - ranked[i] > tol[i])
             for i in range(R.TOP)]
    if any(a and x != y for a, x, y in zip(apart, card["top_ids"],
                                          cpu["top_ids"])):
        raise AssertionError(f"recsys_serving top ids {card['top_ids']} "
                             f"against the CPU's {cpu['top_ids']}")
    return {"top_ids": card["top_ids"].tolist(),
            "max_abs_err": float(max(np.abs(card[k] - cpu[k]).max()
                                     for k in ("logits", "scores")))}


def examples_path(dev, smoke: bool = False) -> dict:
    """Phase 45: the single-rank example programs on the card
    (``e2e_path``; the quickstart, gnn_molecules and recsys_serving, each
    from weights drawn on the CPU and held against the same program on the
    CPU).  ``smoke``: the e2e run cut (``e2e_path``)."""
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.models.recsys import models as RS

    t0 = time.perf_counter()
    out = {"train_100m_e2e": e2e_path(dev, smoke)}
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    out["quickstart"] = _ex_quickstart(dev, T.init_params(
        get_arch("gemma3-1b").smoke_config, torch.Generator().manual_seed(0)))
    gcfg = dataclasses.replace(get_arch("equiformer-v2").smoke_config,
                               task="graph_reg", n_out=1)
    out["gnn_molecules"] = _ex_gnn(dev, EQ.init_params(gcfg, gen), 15)
    out["recsys_serving"] = _ex_recsys(dev, RS.dlrm_init(
        get_arch("dlrm-mlperf").smoke_config,
        torch.Generator().manual_seed(0)))
    q, g, r = (out[k] for k in ("quickstart", "gnn_molecules",
                                "recsys_serving"))
    log(f"phase 45: quickstart 40 rounds on the card: loss "
        f"{q['losses'][0]:.4f} -> {q['losses'][1]:.4f}, {q['pushes']} "
        "pushes, fused_agg_opt "
        f"{q['launches']['fused_agg_opt']} launches (K = 2), each of the "
        f"{q['replayed']} updates == the plain version bitwise, round 1 == "
        f"CPU within rtol {RS_CARD_RTOL}; gnn_molecules {len(g['losses'])} steps:"
        f" mse {g['losses'][0]:.4f} -> {g['losses'][-1]:.4f}, CPU "
        f"{g['cpu_losses'][-1]:.4f} (max rel {g['max_rel']:.3g}, bound "
        f"{GNN_EX_RTOL}; control with TF32 products {g['control_max_rel']:.3g}"
        f"); recsys_serving: logits and 4096 scores == CPU "
        f"within rtol {RS_CARD_RTOL} / atol {RS_CARD_ATOL} (max |err| "
        f"{r['max_abs_err']:.3g}), top-5 ids {r['top_ids']}; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# -- phase 19: kernel timings ------------------------------------------------
# fused_agg_opt's optimizers as the paths run them: the spec, its state
# slots, the step the packet carries, the seed of the inputs, and the f32
# operations an element of the update takes from K rows (K - 1 adds, the
# 1/K scale where averaging, then the update itself)
# -- phase 44: the roofline of the timed full-width steps ----------------------
# No step may beat its roofline bound (the larger of the compute, memory and
# collective terms of launch/roofline.py, from the dry run's counts at the
# script's own mesh and batch): bound / measured at most ROOF_SLACK.
ROOF_SLACK = 1.05


def _roof_plan(label: str, mesh, remat: dict, rn_spmd: dict):
    """The plan of a timed full-width step on ``mesh``, built as its phase
    built it: phase 25's gemma3-1b pbox step (SPMD_BATCH x SEQ), phase
    29's ``train_4k`` (TRAIN4K_BATCH x REMAT_SEQ in its microbatches),
    phase 38's ResNet-50 SPMD step and phase 42's ``molecule``."""
    from repro_torch.configs.registry import ShapeCell, get_arch
    from repro_torch.core.exchange import ExchangeConfig
    from repro_torch.launch.steps import (
        build_cell,
        build_lm_train,
        build_vision_train,
        make_exchange,
    )

    gemma = get_arch("gemma3-1b")
    if label == "gemma3-1b pbox":
        return build_lm_train(
            gemma, ShapeCell("train_2x1k", "train", {
                "seq_len": SEQ, "global_batch": SPMD_BATCH}), mesh,
            make_exchange(mesh, "lm", exchange_cfg=ExchangeConfig("pbox")))
    if label == "train_4k":
        mb = remat["train_4k"]["microbatches"]
        return build_lm_train(
            dataclasses.replace(gemma, microbatches={"train_4k": mb}),
            ShapeCell("train_4k", "train", {
                "seq_len": REMAT_SEQ, "global_batch": TRAIN4K_BATCH}),
            mesh, make_exchange(mesh, "lm"))
    if label == "resnet50 spmd":
        return build_vision_train(
            get_arch("resnet50"), ShapeCell("imagenet_train", "train", {
                "global_batch": rn_spmd["batch"], "img": rn_spmd["img"]}),
            mesh, make_exchange(mesh, "vision"))
    return build_cell("equiformer-v2", "molecule", mesh)


def _card_step_costs(dev, label: str, plan, mesh) -> dict:
    """The cost mode over one real step of ``plan``, built on the world-1
    ``mesh``, on the card, from seeded params and batch."""
    import torch

    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.cost_analysis import step_costs
    from repro_torch.models import transformer as T
    from repro_torch.models.gnn import equiformer_v2 as EQ
    from repro_torch.runtime.trainer import init_train_state, local_state

    ex, space = plan.meta["exchange"], plan.meta["space"]
    if label == "molecule":
        cfg = plan.meta["config"]
        init, specs = (lambda g: EQ.init_params(cfg, g)), \
            EQ.make_param_specs(cfg, 1)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in _gnn_batch(plan, 0).items()}
        dtype = torch.float32
    else:
        from repro_torch.configs.registry import get_arch

        cfg = get_arch("gemma3-1b").config
        init, specs = (lambda g: T.init_params(cfg, g)), \
            T.make_param_specs(cfg, 1)
        gb, sl = plan.abstract_args[4]["tokens"].shape
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
            lm_batches(cfg.vocab, gb, sl, 0)).items()}
        dtype = cfg.param_dtype
    state = init_train_state(
        mesh, init_params_fn=init, param_specs=specs,
        exchange=ex, space=space, n_groups=1,
        key=torch.Generator(device=dev).manual_seed(0), ps_dtype=dtype,
        device=dev)
    args = local_state(state, mesh, ex)
    del state
    _, costs = step_costs(plan.fn, *args, batch)
    del args, batch
    torch.cuda.empty_cache()
    return costs


def roofline_path(dev, spmd: dict, remat: dict, rn_spmd: dict,
                  gnn: dict) -> dict:
    """Phase 44: the port's dry run (``launch/dryrun.dry_run``, meta
    tensors on a ``RecordingMesh``) of the four timed full-width steps at
    the script's own 1 x 1 mesh and batch, and their rooflines
    (``launch/roofline.analyze``, NVIDIA H100 SXM data-sheet peaks): FLOPs
    by dtype, bytes, ``bytes_min``, the peak estimate against the phase's
    ``max_memory_allocated``, the three terms, and the bound over the
    measured steady step, which may not exceed ROOF_SLACK.  For the
    gemma3-1b pbox step and ``molecule`` the same cost mode also counts one
    real step on the card (a world-1 NCCL mesh), whose FLOPs must equal
    the meta count exactly.  Then gemma3-1b ``train_4k`` on the 16 x 16
    production mesh, with and without ``variant="sp"``.  Call inside
    ``world_one``."""
    import tempfile

    import torch

    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import dry_run, plan_config, run_cell
    from repro_torch.launch.mesh import RecordingMesh, make_mesh

    axes = ("data", "model")
    measured = {
        "gemma3-1b pbox": (spmd["pbox"]["step_ms"][1:],
                           spmd["pbox"]["peak_bytes"]),
        "train_4k": (remat["train_4k"]["step_ms"][1:],
                     remat["train_4k"]["peak_bytes"]),
        "resnet50 spmd": (rn_spmd["step_ms"][1:], rn_spmd["peak_bytes"]),
        # the last molecule step ran under the profiler
        "molecule": (gnn["molecule"]["step_ms"][1:-1],
                     gnn["molecule"]["peak_bytes"]),
    }
    out = {}
    for label, (steps, peak) in measured.items():
        mesh = RecordingMesh((1, 1), axes)
        plan = _roof_plan(label, mesh, remat, rn_spmd)
        rec = {"status": "ok", **dry_run(plan, mesh, plan_config(plan, False)),
               "meta": {k: v for k, v in plan.meta.items()
                        if isinstance(v, (int, float, str))}}
        a = roofline.analyze(rec)
        step_ms = statistics.median(steps)
        ratio = a["bound_s"] * 1e3 / step_ms
        out[label] = {**{k: rec[k] for k in (
            "flops_per_device", "flops_by_dtype", "bytes_per_device",
            "bytes_min_per_device", "collective_bytes_per_device", "kernels",
            "ops", "seconds")}, "peak_estimate": rec["memory"][
                "peak_estimate"], "peak_bytes": peak, **a,
            "step_ms": step_ms, "bound_over_measured": ratio}
        log(f"phase 44: {label}: dry run {rec['seconds']} s over "
            f"{rec['ops']} ops; FLOPs "
            + ", ".join(f"{dt} {f:.6g}" for dt, f in
                        rec["flops_by_dtype"].items())
            + f"; bytes {rec['bytes_per_device']:.6g}, bytes_min "
            f"{rec['bytes_min_per_device']:.6g}; peak estimate "
            f"{rec['memory']['peak_estimate'] / 2**30:.2f} GiB against "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; roofline terms "
            f"compute {a['compute_s'] * 1e3:.2f} ms, memory "
            f"{a['memory_s'] * 1e3:.2f} ms ({a['memory_lo_s'] * 1e3:.2f} ~ "
            f"{a['memory_hi_s'] * 1e3:.2f}), collective "
            f"{a['collective_s'] * 1e3:.2f} ms ({a['dominant']}); measured "
            f"step {step_ms:.1f} ms: bound / measured {ratio:.4f} (at most "
            f"{ROOF_SLACK}), model FLOPs / counted "
            f"{a['model_flops_ratio'] or 0:.4f}")
        if not ratio <= ROOF_SLACK:
            raise AssertionError(f"{label} ran faster than its roofline "
                                 f"bound: {step_ms} ms against "
                                 f"{a['bound_s'] * 1e3} ms")
    real = make_mesh((1, 1), axes)
    for label in ("gemma3-1b pbox", "molecule"):
        card = _card_step_costs(dev, label, _roof_plan(label, real, remat,
                                                       rn_spmd), real)
        got, want = card["flops_by_dtype"], out[label]["flops_by_dtype"]
        out[label]["card_flops_by_dtype"] = got
        log(f"phase 44: {label}: one real step on the card counts FLOPs "
            f"{got} (meta {want}): "
            f"{'equal' if got == want else 'DIFFERENT'}; peak estimate "
            f"{card['peak_estimate'] / 2**30:.2f} GiB")
        if got != want:
            raise AssertionError(f"{label}: the card's FLOPs {got} against "
                                 f"the meta count {want}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as tmp:
        for variant in (None, "sp"):
            rec = run_cell("gemma3-1b", "train_4k", False, "pbox", tmp,
                           variant=variant)
            if rec["status"] != "ok":
                raise AssertionError(f"production dry run: {rec}")
            a = roofline.analyze(rec)
            c = rec["collective_bytes_per_device"]
            out[f"production train_4k {variant or 'base'}"] = {
                "flops_by_dtype": rec["flops_by_dtype"],
                "peak_estimate": rec["memory"]["peak_estimate"],
                "collective": c, **a}
            log(f"phase 44: gemma3-1b train_4k on the 16 x 16 production "
                f"mesh, variant {variant}: FLOPs a rank "
                f"{rec['flops_per_device']:.6g} "
                f"({rec['meta']['microbatches']} microbatches), peak "
                f"estimate {rec['memory']['peak_estimate'] / 2**30:.2f} GiB,"
                " collectives " + ", ".join(
                    f"{k} {v / 2**20:.1f} MiB" for k, v in c.items()
                    if k.startswith("raw_"))
                + f"; roofline compute {a['compute_s'] * 1e3:.2f} ms, "
                f"memory {a['memory_s'] * 1e3:.2f} ms, collective "
                f"{a['collective_s'] * 1e3:.2f} ms ({a['dominant']})")
    return out


AGG_OPTS = {
    "adamw": (lambda O: O.adamw(3e-3), 2, 1, 1,
              lambda k, average: adamw_ops(k)),
    "momentum": (lambda O: O.momentum(0.1, 0.9), 1, 2, 4,
                 lambda k, average: (k - 1) + int(average) + 4),
    "sgd": (lambda O: O.sgd(1e-2), 0, 1, 3,
            lambda k, average: (k - 1) + int(average) + 2),
}
# the library call's bits are compared on this many leading elements (the
# update is elementwise), so a full-width check needs no second copy
LIBRARY_BITS_ELEMS = 1 << 24


def _agg_opt_library(opt: str, spec, dev):
    """(name, fn(grads, param, slots)): the one PyTorch call that computes
    a K = 1 update without averaging in place, which the port never
    calls: what ``torch.optim.AdamW(fused=True)`` and ``SGD(fused=True)``
    call, and ``Tensor.add_`` for plain SGD."""
    import torch

    if opt == "adamw":
        step = [torch.ones((), device=dev)]
        return "torch._fused_adamw_", lambda g, p, s: torch._fused_adamw_(
            [p], [g[0]], [s[0]], [s[1]], [], step, lr=spec.lr,
            beta1=spec.beta1, beta2=spec.beta2,
            weight_decay=spec.weight_decay, eps=spec.eps, amsgrad=False,
            maximize=False)
    if opt == "momentum":
        return "torch._fused_sgd_", lambda g, p, s: torch._fused_sgd_(
            [p], [g[0]], [s[0]], weight_decay=0.0, momentum=spec.momentum,
            lr=spec.lr, dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False)
    return "Tensor.add_(g, alpha=-lr)", lambda g, p, s: p.add_(
        g[0], alpha=-spec.lr)


def time_fused_agg_opt(dev, n: int, k: int, average: bool = True,
                       dtype=None, opt: str = "adamw", sets: int = 1) -> dict:
    """fused_agg_opt with ``opt`` (AGG_OPTS: AdamW on the LM paths,
    momentum on ResNet's, SGD on the recsys steps) over K gradient rows of
    N elements, grads and param in ``dtype`` (f32 unless given; the SPMD
    path's are bf16), state slots in f32.  Checked bitwise against its
    plain version, then timed: one input set by CUDA events around each
    call (median of 20); ``sets`` > 1 sets cycled (beyond the 50 MB L2)
    by CUDA-graph replay, for launches near or under 50 us.  At K = 1
    without averaging, beside the library call (``_agg_opt_library``; not
    the same bits)."""
    import torch

    from repro_torch.kernels.fused_agg_opt import kernel as K
    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.optim import optimizers as O

    dtype = dtype or torch.float32
    make_spec, n_slots, step, seed, ops = AGG_OPTS[opt]
    spec = make_spec(O)
    packet = scalar_packet(spec, step, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = []
    for _ in range(sets):
        g = torch.randn((k, n), generator=gen, device=dev).to(dtype)
        p = torch.randn(n, generator=gen, device=dev).to(dtype)
        slots = [torch.randn(n, generator=gen, device=dev) * 0.1
                 for _ in range(n_slots)]
        if n_slots == 2:  # AdamW's second moment
            slots[1] = slots[1].abs()
        inputs.append((g, p, slots))
    g, p, slots = inputs[0]
    head = min(n, LIBRARY_BITS_ELEMS)
    head_in = (g[:, :head], p[:head].clone(), [s[:head].clone()
                                               for s in slots])

    def kernel(x):
        K.fused_agg_opt_cuda(x[0], x[1], tuple(x[2]), packet, spec,
                             average=average)  # in place

    def plain(x):
        return K.fused_agg_opt_torch(x[0], x[1], tuple(x[2]), packet, spec,
                                     average=average)

    want_p, want_s = plain(inputs[0])
    kernel(inputs[0])
    torch.cuda.synchronize()
    err = max([max_abs_err(p, want_p),
               *[max_abs_err(a, b) for a, b in zip(slots, want_s)]])
    if not (same_bits(p, want_p)
            and all(same_bits(a, b) for a, b in zip(slots, want_s))):
        raise AssertionError(f"fused_agg_opt ({opt}, K = {k}, {dtype}) "
                             f"differs at N = {n}, max |err| {err}")
    del want_p, want_s

    def timed(fn, label):
        if sets == 1:
            return cuda_ms(lambda: fn(inputs[0]), reps=20), "events"
        return _graph_or_events([lambda x=x: fn(x) for x in inputs] * 4,
                                label)

    kernel_ms, how = timed(kernel, f"fused_agg_opt {opt} K={k}")
    events_ms = (kernel_ms if sets == 1 else
                 cuda_ms(lambda: kernel(inputs[0]), reps=20))
    plain_ms = cuda_ms(lambda: plain(inputs[0]), reps=5)
    library_ms = library = lib_same = None
    if k == 1 and not average:
        lib_name, lib = _agg_opt_library(opt, spec, dev)
        try:
            want_p, want_s = plain(head_in)
            lib(*head_in)
            lib_same = (same_bits(head_in[1], want_p) and all(
                same_bits(a, b) for a, b in zip(head_in[2], want_s)))
            del want_p, want_s
            library_ms, lib_how = timed(lambda x: lib(*x), lib_name)
            library = (f"{lib_name} {library_ms:.4f} ms ({lib_how}), same "
                       f"bits: {lib_same}")
        except RuntimeError as e:
            library = f"{lib_name} refuses: {str(e).splitlines()[0]}"
    del head_in
    w = p.element_size()
    # K gradient rows read; param and each f32 slot read and written
    b = bound(torch.cuda.get_device_name(dev),
              (k * w + 2 * w + 2 * 4 * n_slots) * n, ops(k, average) * n)
    log(f"timing fused_agg_opt ({opt}, K={k}, average={average}, N={n}, "
        f"{dtype}): kernel {kernel_ms:.4f} ms ({how}"
        + (f", {sets} input sets; CUDA events around one call, host launch "
           f"included: {events_ms:.4f}" if sets > 1 else ", median of 20")
        + f"), plain version {plain_ms:.4f} ms (median of 5); bound "
        f"{b['bound_ms']:.4f} ms = {b['bytes']} bytes (operations: "
        f"{b['op_ms']:.4f} ms); kernel reaches "
        f"{b['bound_ms'] / kernel_ms:.1%} of the bound; library: "
        f"{library or 'none'}")
    return {"ms": kernel_ms, "ms_events": events_ms, "plain_ms": plain_ms,
            "max_abs_err": err, "library_ms": library_ms, "library": library,
            "library_same_bits": lib_same, "timed_by": how,
            "share": b["bound_ms"] / kernel_ms, **b}


def time_quant(dev, flat: int, chunk: int) -> dict:
    """Both quant kernels at the main path's shape (the whole flat space,
    one worker's push), beside their plain versions and, for dequantize,
    torch's per-channel quantized dequantize()."""
    import torch

    from repro_torch.kernels.quant import kernel as Q

    name = torch.cuda.get_device_name(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(flat, generator=gen, device=dev) * 1e-3
    c = flat // chunk
    q, s = Q.quantize_chunks_cuda(x, chunk)
    want_q, want_s = Q.quantize_chunks_torch(x, chunk)
    torch.cuda.synchronize()
    q_err = max(max_abs_err(q, want_q), max_abs_err(s, want_s))
    if not (same_bits(q, want_q) and same_bits(s, want_s)):
        raise AssertionError(f"quantize differs at the main shape, max |err| {q_err}")
    del want_q, want_s
    quant_ms = cuda_ms(lambda: Q.quantize_chunks_cuda(x, chunk), reps=20)
    quant_plain = cuda_ms(lambda: Q.quantize_chunks_torch(x, chunk), reps=3)
    del x
    d = Q.dequantize_chunks_cuda(q, s, chunk)
    want_d = Q.dequantize_chunks_torch(q, s, chunk)
    torch.cuda.synchronize()
    d_err = max_abs_err(d, want_d)
    if not same_bits(d, want_d):
        raise AssertionError(f"dequantize differs at the main shape, max |err| {d_err}")
    del d
    deq_ms = cuda_ms(lambda: Q.dequantize_chunks_cuda(q, s, chunk), reps=20)
    deq_plain = cuda_ms(lambda: Q.dequantize_chunks_torch(q, s, chunk), reps=3)
    # torch's own per-channel dequantize of the same bits (channel = chunk),
    # the yardstick only: the port never calls it
    try:
        qt = torch._make_per_channel_quantized_tensor(
            q.view(c, chunk), s.double(),
            torch.zeros(c, dtype=torch.long, device=dev), 0)
        lib = qt.dequantize().reshape(flat)
        torch.cuda.synchronize()
        lib_same = same_bits(lib, want_d)
        lib_err = max_abs_err(lib, want_d)
        del lib
        lib_ms = cuda_ms(lambda: qt.dequantize(), reps=20)
        del qt
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch per-channel dequantize() not timed: {exc}"[:300])
        lib_ms, lib_same, lib_err = None, None, None
    del want_d
    nbytes = 5 * flat + 4 * c
    bq = bound(name, nbytes, 5 * flat)  # |x|, max, divide, round, clamp
    bd = bound(name, nbytes, flat)  # one multiply
    log(f"timing quantize_chunks (N={flat}, chunk {chunk}): kernel "
        f"{quant_ms:.4f} ms (median of 20), plain version {quant_plain:.4f} "
        f"ms (median of 3); bound {bq['bound_ms']:.4f} ms = {nbytes} bytes; "
        f"kernel reaches {bq['bound_ms'] / quant_ms:.1%} of the bound; "
        f"library: none (no one call finds the chunk scales and encodes)")
    log(f"timing dequantize_chunks (N={flat}, chunk {chunk}): kernel "
        f"{deq_ms:.4f} ms (median of 20), plain version {deq_plain:.4f} ms "
        f"(median of 3); bound {bd['bound_ms']:.4f} ms; kernel reaches "
        f"{bd['bound_ms'] / deq_ms:.1%} of the bound; torch per-channel "
        f"dequantize() {lib_ms} ms (median of 20), same bits: {lib_same}"
        f" (max |err| {lib_err})")
    return {
        "quantize_chunks": {"ms": quant_ms, "plain_ms": quant_plain,
                            "max_abs_err": q_err, "library_ms": None, **bq},
        "dequantize_chunks": {"ms": deq_ms, "plain_ms": deq_plain,
                              "max_abs_err": d_err, "library_ms": lib_ms,
                              "library_same_bits": lib_same, **bd},
    }


def time_wire(dev, n: int, k: int, chunk: int, average: bool = True) -> dict:
    """wire_fused at the main path's shard shape (AdamW, K int8 streams),
    beside its plain version and the unfused kernel pipeline it replaces."""
    import torch

    from repro_torch.kernels.fused_agg_opt.ops import scalar_packet
    from repro_torch.kernels.quant import kernel as Q
    from repro_torch.kernels.wire_path import kernel as W
    from repro_torch.kernels.wire_path.ops import unfused_wire_update
    from repro_torch.optim.optimizers import adamw

    spec = adamw(3e-3)
    c = n // chunk
    gen = torch.Generator(device=dev).manual_seed(3)
    pairs = [Q.quantize_chunks_cuda(
        torch.randn(n, generator=gen, device=dev) * 1e-3, chunk)
        for _ in range(k)]
    pay = torch.stack([q for q, _ in pairs])
    sc = torch.stack([s for _, s in pairs])
    del pairs
    p = torch.randn(n, generator=gen, device=dev)
    m = torch.randn(n, generator=gen, device=dev) * 1e-3
    v = (torch.randn(n, generator=gen, device=dev) * 1e-3).abs()
    packet = scalar_packet(spec, 1, device=dev)
    want_p, want_s = W.wire_fused_torch(pay, sc, p, (m, v), packet, spec,
                                        codec="int8", chunk_elems=chunk,
                                        average=average)
    W.wire_fused_cuda(pay, sc, p, (m, v), packet, spec, codec="int8",
                      chunk_elems=chunk, average=average)  # in place
    torch.cuda.synchronize()
    err = max(max_abs_err(p, want_p), *[max_abs_err(a, b) for a, b in
                                        zip((m, v), want_s)])
    if not (same_bits(p, want_p) and same_bits(m, want_s[0])
            and same_bits(v, want_s[1])):
        raise AssertionError(f"wire_fused differs at the main shape, max |err| {err}")
    del want_p, want_s
    kernel_ms = cuda_ms(lambda: W.wire_fused_cuda(
        pay, sc, p, (m, v), packet, spec, codec="int8", chunk_elems=chunk,
        average=average), reps=20)
    plain_ms = cuda_ms(lambda: W.wire_fused_torch(
        pay, sc, p, (m, v), packet, spec, codec="int8", chunk_elems=chunk,
        average=average), reps=3)
    unfused_ms = cuda_ms(lambda: unfused_wire_update(
        pay, sc, p, (m, v), spec, 1, codec="int8", chunk_elems=chunk,
        average=average), reps=10)
    b = bound(torch.cuda.get_device_name(dev),
              (k * 1 + 2 * 4 + 2 * 2 * 4) * n + 4 * k * c,
              (k + adamw_ops(k)) * n)
    log(f"timing wire_fused (AdamW, K={k} int8 streams, average={average}, "
        f"N={n}, chunk "
        f"{chunk}): kernel {kernel_ms:.4f} ms (median of 20), plain version "
        f"{plain_ms:.4f} ms (median of 3), unfused kernel pipeline "
        f"(dequantize x{k} + fused_agg_opt) {unfused_ms:.4f} ms (median of "
        f"10); bound {b['bound_ms']:.4f} ms = {b['bytes']} bytes (operations: "
        f"{b['op_ms']:.4f} ms); kernel reaches "
        f"{b['bound_ms'] / kernel_ms:.1%} of the bound; library: none")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "unfused_ms": unfused_ms,
            "max_abs_err": err, "library_ms": None, **b}


def _graph_or_events(calls: list, label: str) -> tuple:
    """(ms, how): ``graph_ms`` of the calls, or, where a call cannot be
    captured in a CUDA graph, the median of CUDA events around each."""
    import torch

    try:
        return graph_ms(calls), "graph"
    except RuntimeError as exc:
        torch.cuda.synchronize()
        log(f"  {label}: not capturable in a CUDA graph ({str(exc)[:120]}); "
            f"timed with CUDA events around each call")
        return cuda_ms(calls[0], reps=20), "events"


def time_embedding_bag(dev, b: int, length: int, d: int, vocab: int,
                       label: str, sets: int) -> dict:
    """embedding_bag as the sparse tier calls it: ``b`` bags of ``length``
    ids drawn from ``vocab`` rows, the (U, d) block of unique rows and the
    block-local indices.  ``sets`` such inputs are cycled through, so the
    calls' working set exceeds the 50 MB L2 as a cold lookup's would.
    Beside its plain version and ``torch.nn.functional.embedding_bag`` with
    per-sample weights (sum), which the port never calls."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import kernel as E

    inputs = []
    for i in range(sets):
        rng = np.random.default_rng(50 + i)
        uniq, inv = np.unique(rng.integers(0, vocab, b * length),
                              return_inverse=True)
        gen = torch.Generator(device=dev).manual_seed(50 + i)
        block = torch.randn((uniq.size, d), generator=gen, device=dev) * 0.01
        idx = torch.from_numpy(inv.reshape(b, length).astype(np.int32)).to(dev)
        w = (torch.ones((b, length), device=dev) if length == 1 else
             torch.rand((b, length), generator=gen, device=dev))
        inputs.append((block, idx, w, idx.long()))
    block, idx, w, idx64 = inputs[0]
    u = block.shape[0]
    got = E.embedding_bag_cuda(block, idx, w)
    want = E.embedding_bag_torch(block, idx, w)
    lib = F.embedding_bag(idx64, block, per_sample_weights=w, mode="sum")
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not same_bits(got, want):
        raise AssertionError(f"embedding_bag differs at the {label} shape, "
                             f"max |err| {err}")
    lib_same, lib_err = same_bits(lib, want), max_abs_err(lib, want)
    del got, want, lib
    reps = max(1, 20 // sets)
    kernel_ms, _ = _graph_or_events(
        [lambda x=x: E.embedding_bag_cuda(x[0], x[1], x[2])
         for x in inputs] * reps, "embedding_bag")
    lib_ms, lib_how = _graph_or_events(
        [lambda x=x: F.embedding_bag(x[3], x[0], per_sample_weights=x[2],
                                     mode="sum") for x in inputs] * reps,
        "F.embedding_bag")
    events_ms = cuda_ms(lambda: E.embedding_bag_cuda(block, idx, w), reps=20)
    plain_ms = cuda_ms(lambda: E.embedding_bag_torch(block, idx, w), reps=5)
    # each touched row read once, the (B, L) int32 ids and f32 weights, the
    # (B, D) output written once; an FMA (2 ops) an element a slot
    bnd = bound(torch.cuda.get_device_name(dev), u * d * 4 + b * length * 8
                + b * d * 4, 2 * b * length * d)
    log(f"timing embedding_bag ({label}: B={b}, L={length}, D={d}, U={u} "
        f"unique rows of {vocab}; {sets} input sets cycled): kernel "
        f"{kernel_ms:.4f} ms a call (CUDA graph of {sets * reps} calls, "
        f"median of 5 replays; CUDA events around one call, host launch "
        f"included: {events_ms:.4f}), plain version {plain_ms:.4f} ms "
        f"(events, median of 5); bound {bnd['bound_ms']:.4f} ms = "
        f"{bnd['bytes']} bytes; kernel reaches "
        f"{bnd['bound_ms'] / kernel_ms:.1%} of the bound; "
        f"F.embedding_bag(per_sample_weights, sum) {lib_ms:.4f} ms "
        f"({lib_how}), same bits: {lib_same} (max |err| {lib_err})")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "library_ms": lib_ms, "library_same_bits": lib_same, "u": u,
            "ms_events": events_ms,
            "shape": {"b": b, "l": length, "d": d, "u": u, "vocab": vocab},
            **bnd}


def time_segment_sum(dev, n: int, d: int, vocab: int) -> dict:
    """segment_sum as a push coalesces the largest table: ``n`` ids drawn
    from ``vocab`` rows, the (n, d) rows a strided column of the (n, 26, d)
    cotangent; four columns are cycled through (past the 50 MB L2).
    Beside its plain version and ``index_add_`` into zeros, which the port
    never calls (its atomics fold duplicates in no fixed order)."""
    import numpy as np
    import torch

    from repro_torch.kernels.embedding_bag import kernel as E

    rng = np.random.default_rng(6)
    uniq, inv = np.unique(rng.integers(0, vocab, n), return_inverse=True)
    u = uniq.size
    gen = torch.Generator(device=dev).manual_seed(6)
    cot = torch.randn((n, 26, d), generator=gen, device=dev)
    cols = [cot[:, i] for i in range(4)]
    order = torch.from_numpy(np.argsort(inv, kind="stable")).to(dev)
    seg = torch.from_numpy(np.concatenate(
        [[0], np.cumsum(np.bincount(inv))]).astype(np.int64)).to(dev)
    inv_t = torch.from_numpy(inv.astype(np.int64)).to(dev)
    rows = cols[0]
    got = E.segment_sum_cuda(rows, order, seg)
    want = E.segment_sum_torch(rows, order, seg)
    lib = torch.zeros((u, d), device=dev).index_add_(0, inv_t, rows)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if not same_bits(got, want):
        raise AssertionError(f"segment_sum differs at the main shape, max |err| {err}")
    lib_same = same_bits(lib, want)
    del got, want, lib
    kernel_ms, _ = _graph_or_events(
        [lambda r=r: E.segment_sum_cuda(r, order, seg) for r in cols] * 5,
        "segment_sum")
    lib_ms, lib_how = _graph_or_events(
        [lambda r=r: torch.zeros((u, d), device=dev).index_add_(0, inv_t, r)
         for r in cols] * 5, "index_add_")
    events_ms = cuda_ms(lambda: E.segment_sum_cuda(rows, order, seg), reps=20)
    plain_ms = cuda_ms(lambda: E.segment_sum_torch(rows, order, seg), reps=5)
    # rows read once, order and offsets, the (U, D) sums written once
    bnd = bound(torch.cuda.get_device_name(dev),
                n * d * 4 + n * 8 + (u + 1) * 8 + u * d * 4, n * d)
    log(f"timing segment_sum (n={n}, D={d}, U={u} of {vocab}, strided rows, "
        f"4 columns cycled): kernel {kernel_ms:.4f} ms a call (CUDA graph of "
        f"20 calls, median of 5 replays; CUDA events around one call: "
        f"{events_ms:.4f}), plain version {plain_ms:.4f} ms (events, median "
        f"of 5); bound {bnd['bound_ms']:.4f} ms = {bnd['bytes']} bytes; "
        f"kernel reaches {bnd['bound_ms'] / kernel_ms:.1%} of the bound; "
        f"zeros + index_add_ {lib_ms:.4f} ms ({lib_how}), same bits: "
        f"{lib_same}")
    del cot, cols
    return {"ms": kernel_ms, "plain_ms": plain_ms, "max_abs_err": err,
            "library_ms": lib_ms, "library_same_bits": lib_same,
            "ms_events": events_ms,
            "shape": {"n": n, "d": d, "u": u, "vocab": vocab}, **bnd}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi.stdout.strip().splitlines()[0])
    laps, t_lap = {}, [t_start]

    def lap(label: str) -> None:
        """Seconds since the previous lap, by group of phases."""
        now = time.perf_counter()
        laps[label] = round(now - t_lap[0], 1)
        t_lap[0] = now

    secs = _build.build_all()
    log(f"build: {_build.sources()} in {secs:.1f} s")
    for src in _build.sources():
        if src == "fused_agg_opt":
            log(f"  ptxas {src}: {ptxas_summary(_build.build_log(src))}")
            continue
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    lap("1-2 build")
    sweep = {"fused_agg_opt": max(kernel_sweep(dev), kernel_rows_sweep(dev),
                                  stream_check(dev)),
             **quant_sweep(dev),
             "wire_fused": wire_sweep(dev), **bag_sweep(dev)}
    lap("3 sweeps")
    f32 = main_path(dev, "none")
    f32_err = replay_f32(dev, f32)
    f32.pop("captured")
    lap("4 f32")
    int8 = main_path(dev, "int8")
    int8_err = replay_wire(dev, int8)
    codec_err = replay_codec(int8)
    int8.pop("captured")
    lap("5 int8")
    dlrm = dlrm_path(dev)
    dlrm_err = replay_dlrm(dlrm)
    dlrm.pop("captured")
    dlrm_sharding_check(dev)
    lap("6-7 dlrm")
    rehearsal = fault_rehearsal()
    with deterministic():
        gw = GemmaWorkers(dev)
        quorum = quorum_path(dev, gw)
        lap("8 quorum")
        asyn = async_path(dev, gw)
        lap("9 async")
        snap = snapshot_path(dev, gw)
        lap("10 snapshot")
        rack = rack_chain_path(dev, gw)
        lap("12 rack chain")
        switch = switch_path(dev, gw)
        lap("13 switch")
        fault = failover_path(dev, gw, rehearsal)
        lap("15 failover")
        auto = autoscale_path(dev, gw, fault)
        lap("23 autoscale")
        del gw
        torch.cuda.empty_cache()
        tenancy = tenancy_path(dev)
    async_err = replay_wire(dev, asyn)
    asyn.pop("captured")
    lap("17 tenancy")
    smoke = smoke_modes_check(dev)
    lap("11 SMOKE modes")
    smoke_topo = smoke_topology_check(dev)
    lap("14 SMOKE topology")
    smoke_fault = smoke_fault_check(dev)
    lap("16 SMOKE faults")
    smoke_tenancy = smoke_tenancy_check(dev)
    lap("18 SMOKE tenancy")
    torch.cuda.empty_cache()
    serve = serve_path(dev)
    lap("20 serve")
    sparse_serve = sparse_serve_path(dev)
    lap("21 sparse serve")
    smoke_serve = smoke_serve_check(dev)
    smoke_auto = smoke_autoscale_check(dev)
    lap("22, 24 SMOKE")
    torch.cuda.empty_cache()
    with world_one(dev), deterministic():
        spmd = spmd_path(dev)
        lap("25 SPMD")
        smoke_spmd = smoke_spmd_check(dev)
        lap("26 SMOKE SPMD")
        cli = cli_check(dev)
        lap("27 CLI")
        remat = remat_path(dev)
        lap("29 remat")
        cells = serve_cells_path(dev)
    lap("30 serve cells")
    gloo = gloo_cuda_check(dev)
    lap("28 gloo")
    tp = tp_path(dev)
    lap("31 tp")
    torch.cuda.empty_cache()
    with world_one(dev), deterministic():
        rs_sparse = rs_sparse_path(dev)
        rs_serve = rs_serve_path(dev, rs_sparse.pop("params"),
                                 rs_sparse.pop("cfg"))
        torch.cuda.empty_cache()
        rs_dense = rs_dense_sparse_path(dev)
        rs_archs = rs_archs_path(dev)
        rs_smoke = rs_smoke_check(dev)
    lap("32-36 recsys")
    rs_gloo = rs_gloo_check(dev, tp.pop("rs_ranks"))
    lap("36 recsys gloo")
    torch.cuda.empty_cache()
    rn_norms = resnet_norm_check(dev)
    rn_fabric = resnet_fabric_path(dev)
    rn_fabric_err = replay_f32(dev, rn_fabric)
    rn_fabric.pop("captured")
    lap("37 resnet fabric")
    with world_one(dev), deterministic():
        rn_spmd = resnet_spmd_path(dev)
        lap("38 resnet spmd")
        granite = granite_path(dev)
        lap("39 granite")
        qwen = qwen2_moe_serve_path(dev)
        lap("40 qwen2-moe")
        smoke_new = new_archs_smoke_check(dev)
        lap("41 SMOKE new archs")
        gnn = gnn_path(dev)
        lap("42 gnn")
        smoke_gnn = gnn_smoke_check(dev)
        lap("43 SMOKE gnn")
        torch.cuda.empty_cache()
        roof = roofline_path(dev, spmd, remat, rn_spmd, gnn)
        lap("44 roofline")
    torch.cuda.empty_cache()
    examples = examples_path(dev)
    lap("45 examples")
    torch.cuda.empty_cache()
    switch_math = switch_math_ms(dev, int8["flat"], int8["chunk"])
    d = dlrm_capped_config().embed_dim
    timing = {"fused_agg_opt": time_fused_agg_opt(dev, f32["n"], WORKERS),
              **time_quant(dev, int8["flat"], int8["chunk"]),
              "wire_fused": time_wire(dev, int8["n"], WORKERS, int8["chunk"]),
              # the async path's K = 1 pushes, without averaging
              "fused_agg_opt_k1": time_fused_agg_opt(dev, f32["n"], 1,
                                                     average=False),
              # the SPMD step's update: K = 1, bf16, the whole flat
              "fused_agg_opt_spmd": time_fused_agg_opt(
                  dev, spmd["pbox"]["flat"], 1, average=False,
                  dtype=torch.bfloat16),
              "wire_fused_k1": time_wire(dev, asyn["n"], 1, asyn["chunk"],
                                         average=False),
              # the recsys steps' update: SGD, K = 1, f32, the dense MLPs
              "fused_agg_opt_sgd": time_fused_agg_opt(
                  dev, rs_sparse["flat"], 1, average=False, opt="sgd",
                  sets=3),
              # the ResNet paths' momentum updates (f32): the fabric's K = 2
              # over a shard's slab, the SPMD step's K = 1 over the flat
              "fused_agg_opt_rn_fabric": time_fused_agg_opt(
                  dev, rn_fabric["n"], RN_WORKERS, opt="momentum", sets=2),
              "fused_agg_opt_rn_spmd": time_fused_agg_opt(
                  dev, rn_spmd["flat"], 1, average=False, opt="momentum",
                  sets=2),
              # granite's SPMD AdamW: K = 1, bf16 param and gradient
              "fused_agg_opt_granite": time_fused_agg_opt(
                  dev, granite["flat"], 1, average=False,
                  dtype=torch.bfloat16),
              # EquiformerV2's SPMD AdamW: K = 1, f32, the molecule flat
              "fused_agg_opt_gnn": time_fused_agg_opt(
                  dev, gnn["molecule"]["flat"], 1, average=False, sets=2),
              # train_100m_e2e's update: AdamW, K = 1, f32, the whole flat
              "fused_agg_opt_e2e": time_fused_agg_opt(
                  dev, examples["train_100m_e2e"]["flat"], 1, average=False),
              "embedding_bag": time_embedding_bag(
                  dev, DLRM_BATCH, 1, d, DLRM_ROW_CAP, "one-hot main path", 4),
              "segment_sum": time_segment_sum(dev, DLRM_BATCH, d, DLRM_ROW_CAP)}
    multi_hot = time_embedding_bag(dev, DLRM_BATCH, 20, d, DLRM_ROW_CAP,
                                   "multi-hot", 2)
    replayed = {"fused_agg_opt": max(f32_err, rn_fabric_err,
                                     rn_spmd["replay_err"],
                                     *(run["replay_err"]
                                       for run in gnn.values()),
                                     *(run["replay_err"]
                                       for run in spmd.values()),
                                     examples["train_100m_e2e"]["replay"][
                                         "max_abs_err"]),
                "wire_fused": max(int8_err, async_err), **codec_err,
                **dlrm_err}
    # every path's launches, by kernel; the SMOKE cases summed
    paths = {"f32": f32["launches"], "int8": int8["launches"],
             "dlrm": dlrm["launches"], "quorum": quorum["launches"],
             "async_int8": asyn["launches"],
             "snapshot_run_a": snap["launches_a"],
             "snapshot_run_b": snap["launches_b"],
             "smoke_modes": {k: sum(c[k] for c in smoke.values())
                             for k in f32["launches"]},
             "rack_chain": rack["launches"],
             "rack_flat_reference": rack["flat_launches"],
             **{f"switch_{label.replace(' ', '_')}": run["launches"]
                for label, run in switch.items()},
             "smoke_topology": {k: sum(c[k] for c in smoke_topo.values())
                                for k in f32["launches"]},
             "failover_run_a": fault["launches_a"],
             "failover_run_b": fault["launches_b"],
             "smoke_faults": {k: sum(c[k] for c in smoke_fault.values())
                              for k in f32["launches"]},
             "tenancy_box": tenancy["launches"],
             "tenancy_twins": tenancy["twin_launches"],
             "smoke_tenancy": {k: sum(c[k] for c in smoke_tenancy.values())
                               for k in f32["launches"]},
             "serve_gemma": serve["launches"],
             "serve_sparse": sparse_serve["launches"],
             "smoke_serve": {k: sum(c[k] for c in smoke_serve.values())
                             for k in f32["launches"]},
             "autoscale_gemma": auto["launches"],
             "smoke_autoscale": {k: sum(c[k] for c in smoke_auto.values())
                                 for k in f32["launches"]},
             **{f"spmd_{label}": run["launches"]
                for label, run in spmd.items()},
             "smoke_spmd": {k: sum(c.get(k, 0) for c in smoke_spmd.values())
                            for k in f32["launches"]},
             "train_4k": remat["train_4k"]["launches"],
             "tp2_ranks": tp["launches_tp2"],
             "tp2_sp_ranks": tp["launches_tp2_sp"],
             "tp1_reference": tp["launches_tp1"],
             "recsys_sparse": rs_sparse["launches"],
             "recsys_dense_vs_sparse": {
                 k: rs_dense["dense"]["launches"][k]
                 + rs_dense["sparse"]["launches"][k] for k in f32["launches"]},
             **{f"recsys_{a}": r["train"]["launches"]
                for a, r in rs_archs.items()},
             "smoke_recsys": {k: sum(c["launches"][k] for c in
                                     rs_smoke.values())
                              for k in f32["launches"]},
             "resnet_fabric": rn_fabric["launches"],
             "resnet_spmd": rn_spmd["launches"],
             "granite_train_4k": granite["train_4k"]["launches"],
             "smoke_new_archs": {k: sum(c["launches"][k] for n, c in
                                        smoke_new.items() if "launches" in c)
                                 for k in f32["launches"]},
             **{f"gnn_{shape}": run["launches"] for shape, run in
                gnn.items()},
             "smoke_gnn": {k: sum(c["launches"][k] for c in
                                  smoke_gnn.values())
                           for k in f32["launches"]},
             "examples_train_100m_e2e":
                 examples["train_100m_e2e"]["launches"],
             "examples_quickstart": examples["quickstart"]["launches"],
             "examples_serve_lm_ranks":
                 tp["examples"]["launches_serve"],
             "examples_train_distributed_ps_ranks":
                 tp["examples"]["launches_train_ps"]}
    recsys_paths = [p for p in paths if p.startswith(("recsys_",
                                                      "smoke_recsys"))]
    # K = 1 without averaging: the async pushes (f32 ones only at SMOKE)
    k1_launches = {"fused_agg_opt": smoke["async/none"]["fused_agg_opt"],
                   "wire_fused": asyn["launches"]["wire_fused"]
                   + smoke["async/int8"]["wire_fused"]}
    rows = [
        ("fused_agg_opt", "fused_agg_opt.cu", "fused_agg_opt/kernel.py:162",
         f32, {"k": WORKERS, "n": f32["n"], "optimizer": "adamw",
               "dtype": "f32"}),
        ("quantize_chunks", "quant.cu", "quant/kernel.py:31", int8,
         {"n": int8["flat"], "chunk": int8["chunk"], "dtype": "f32->int8"}),
        ("dequantize_chunks", "quant.cu", "quant/kernel.py:62", int8,
         {"n": int8["flat"], "chunk": int8["chunk"], "dtype": "int8->f32"}),
        ("wire_fused", "wire_path.cu", "wire_path/kernel.py:149", int8,
         {"k": WORKERS, "n": int8["n"], "chunk": int8["chunk"],
          "optimizer": "adamw", "dtype": "int8"}),
        ("embedding_bag", "embedding_bag.cu", "embedding_bag/kernel.py:32",
         dlrm, {**timing["embedding_bag"]["shape"], "dtype": "f32",
                "multi_hot_l20": {k: multi_hot[k] for k in (
                    "ms", "plain_ms", "bound_ms", "library_ms", "u")}}),
        ("segment_sum", "embedding_bag.cu",
         "src/repro/runtime/sparse_push.py:59", dlrm, {**timing["segment_sum"]["shape"],
                              "dtype": "f32"}),
    ]
    kernels = []
    for kname, src, tpu, run, shape in rows:
        t = timing[kname]
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            # segment_sum replaces jax.ops.segment_sum, an XLA op (no TPU
            # kernel): the sparse push's in-order duplicate fold
            "replaces": tpu if tpu.startswith("src/")
                        else f"src/repro/kernels/{tpu}",
            "held_against": f"{kname}_torch" if kname != "wire_fused"
                            else "wire_fused_torch and dequantize+fused_agg_opt",
            **({"library_same_bits": t["library_same_bits"]}
               if "library_same_bits" in t else {}),
            "match": "bitwise",
            "launches": run["launches"][kname],
            "max_abs_err": max(sweep[kname], replayed.get(kname, 0.0),
                               t["max_abs_err"]),
            "ms": t["ms"],
            "main_path_ms": run["main_path_ms"] if run["kernel"] == kname
                            else run.get("segment_main_path_ms")
                            if kname == "segment_sum" else None,
            **({"ms_events": t["ms_events"]} if "ms_events" in t else {}),
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            **({"share": t["share"]} if "share" in t else {}),
            "library_ms": t["library_ms"],
            "shape": shape,
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            **({"k1_no_average": {
                "launches": k1_launches[kname],
                **{key: timing[f"{kname}_k1"].get(key) for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "share",
                    "max_abs_err", "library_ms", "library")}}}
               if kname in k1_launches else {}),
            **({"spmd_k1_bf16": {
                "launches": sum(run["launches"][kname]
                                for run in spmd.values()),
                "device_update_ms": {label: statistics.median(
                    run["update_ms"][1:]) for label, run in spmd.items()},
                "replay_max_abs_err": max(run["replay_err"]
                                          for run in spmd.values()),
                **{key: timing["fused_agg_opt_spmd"][key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "share",
                    "max_abs_err", "library_ms", "library")}}}
               if kname == "fused_agg_opt" else {}),
            **({label: {
                "launches": paths[path][kname], **extra,
                **{key: timing[tkey].get(key) for key in (
                    "ms", "ms_events", "plain_ms", "bound_ms", "bound_by",
                    "share", "max_abs_err", "library_ms", "library",
                    "library_same_bits", "timed_by")}}
                for label, path, tkey, extra in (
                    ("resnet_fabric_k2_momentum_f32", "resnet_fabric",
                     "fused_agg_opt_rn_fabric",
                     {"n": rn_fabric["n"], "replay_max_abs_err":
                      rn_fabric_err,
                      "main_path_ms": rn_fabric["main_path_ms"]}),
                    ("resnet_spmd_k1_momentum_f32", "resnet_spmd",
                     "fused_agg_opt_rn_spmd",
                     {"n": rn_spmd["flat"], "replay_max_abs_err":
                      rn_spmd["replay_err"], "device_update_ms":
                      statistics.median(rn_spmd["update_ms"][1:])}),
                    ("granite_spmd_k1_adamw_bf16", "granite_train_4k",
                     "fused_agg_opt_granite", {"n": granite["flat"]}),
                    ("gnn_spmd_k1_adamw_f32", "gnn_molecule",
                     "fused_agg_opt_gnn",
                     {"n": gnn["molecule"]["flat"],
                      "launches_full_graph_sm":
                      paths["gnn_full_graph_sm"][kname],
                      "replay_max_abs_err": max(
                          run["replay_err"] for run in gnn.values()),
                      "device_update_ms": {
                          shape: statistics.median(run["update_ms"][1:])
                          for shape, run in gnn.items()}}))}
               if kname == "fused_agg_opt" else {}),
            **({"train_100m_e2e_k1_adamw_f32": {
                "launches": paths["examples_train_100m_e2e"][kname],
                "n": examples["train_100m_e2e"]["flat"],
                "replay_max_abs_err":
                    examples["train_100m_e2e"]["replay"]["max_abs_err"],
                "ref_max_abs_err":
                    examples["train_100m_e2e"]["replay"]["ref_max_abs_err"],
                "main_path_ms":
                    examples["train_100m_e2e"]["launch_ms_in_run"],
                **{key: timing["fused_agg_opt_e2e"].get(key) for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "share",
                    "max_abs_err", "library_ms", "library",
                    "library_same_bits", "timed_by")}}}
               if kname == "fused_agg_opt" else {}),
            **({"recsys_sgd_k1_f32": {
                "launches": sum(paths[p][kname] for p in recsys_paths),
                **{key: timing["fused_agg_opt_sgd"][key] for key in (
                    "ms", "ms_events", "plain_ms", "bound_ms", "bound_by",
                    "share", "max_abs_err", "library_ms", "library_same_bits",
                    "timed_by")}}}
               if kname == "fused_agg_opt" else {}),
        })
    log(f"main path peaks: f32 {f32['peak_bytes'] / 2**30:.2f} GiB, int8 "
        f"{int8['peak_bytes'] / 2**30:.2f} GiB, dlrm "
        f"{dlrm['peak_bytes'] / 2**30:.2f} GiB, quorum "
        f"{quorum['peak_bytes'] / 2**30:.2f} GiB, async int8 "
        f"{asyn['peak_bytes'] / 2**30:.2f} GiB, snapshot "
        f"{snap['peak_bytes'] / 2**30:.2f} GiB, rack chain "
        f"{rack['peak_bytes'] / 2**30:.2f} GiB (its flat reference "
        f"{rack['flat_peak_bytes'] / 2**30:.2f}), switch "
        + ", ".join(f"{label} {run['peak_bytes'] / 2**30:.2f} GiB"
                    for label, run in switch.items())
        + "; steady rounds (round 2): rack chain "
        f"{rack['round_ms'][1]:.1f} ms (flat {rack['flat_round_ms'][1]:.1f}), "
        + ", ".join(f"switch {label} {run['round_ms'][1]:.1f} ms"
                    for label, run in switch.items())
        + f"; failover run A {fault['peak_a'] / 2**30:.2f} GiB, run B "
        f"{fault['peak_b'] / 2**30:.2f} GiB (its reshard "
        f"{fault['reshard_peak_bytes'] / 2**30:.2f}), steady rounds (round "
        f"2) A {fault['round_ms_a'][1]:.1f} ms, B {fault['round_ms_b'][1]:.1f}"
        f" ms, chain pass {statistics.median(fault['chain_ms']):.3f} ms"
        f"; tenancy shared run {tenancy['peak_shared'] / 2**30:.2f} GiB, "
        f"twins {tenancy['peak_twin_a'] / 2**30:.2f} / "
        f"{tenancy['peak_twin_b'] / 2**30:.2f} GiB, steady rounds (round 2)"
        f" shared a {tenancy['shared_ms']['a'][1]:.1f} / b "
        f"{tenancy['shared_ms']['b'][1]:.1f} ms, dedicated a "
        f"{tenancy['dedicated_ms']['a'][1]:.1f} / b "
        f"{tenancy['dedicated_ms']['b'][1]:.1f} ms, detach "
        f"{tenancy['detach_ms']:.1f} ms, re-attach {tenancy['attach_ms']:.1f}"
        f" ms; serve gemma {serve['peak_bytes'] / 2**30:.2f} GiB (assemble "
        f"{statistics.median(serve['assemble_ms']):.3f} ms, miss "
        f"{statistics.median(serve['miss_ms']):.2f} ms, hit "
        f"{statistics.median(serve['hit_ms']):.3f} ms, prefill 4 x {SEQ} "
        f"{statistics.median(serve['prefill_ms']):.2f} ms, decode step "
        f"{statistics.median(serve['decode_step_ms']):.3f} ms), sparse serve "
        f"{sparse_serve['peak_bytes'] / 2**30:.2f} GiB (read_rows "
        f"{statistics.median(sparse_serve['read_ms']):.1f} ms a batch, hit "
        f"rate {sparse_serve['stats']['row_hits'] / sparse_serve['served']:.4f})"
        + f"; autoscale {auto['peak_bytes'] / 2**30:.2f} GiB (rounds "
        f"{[round(x, 1) for x in auto['round_ms']]} ms, reshards "
        f"{[round(x, 1) for x in auto['reshard_ms']]} ms, solves "
        f"{[round(x, 2) for x in auto['solve_ms']]} ms, retries "
        f"{auto['retries']})"
        + "; spmd " + ", ".join(
            f"{label} steady step {statistics.median(run['step_ms'][1:]):.1f}"
            f" ms (device_update {statistics.median(run['update_ms'][1:]):.2f}"
            f" ms), peak {run['peak_bytes'] / 2**30:.2f} GiB"
            for label, run in spmd.items())
        + f"; cli 6 SMOKE steps {cli['seconds']:.1f} s; gloo on cuda:0 "
        f"{gloo['seconds']:.1f} s"
        + f"; 1 x {REMAT_SEQ} fwd+bwd remat off "
        f"{remat['remat_off']['ms'][1]:.1f} ms / "
        f"{remat['remat_off']['peak_bytes'] / 2**30:.2f} GiB, on "
        f"{remat['remat_on']['ms'][1]:.1f} ms / "
        f"{remat['remat_on']['peak_bytes'] / 2**30:.2f} GiB; train_4k "
        f"{TRAIN4K_BATCH} x {REMAT_SEQ} steady step "
        f"{statistics.median(remat['train_4k']['step_ms'][1:]):.1f} ms, peak "
        f"{remat['train_4k']['peak_bytes'] / 2**30:.2f} GiB; prefill_32k "
        f"{cells['prefill_32k']['ms'][1]:.1f} ms, decode_32k "
        f"{statistics.median(cells['decode_32k']['ms'][1:]):.2f} ms a step, "
        f"long_500k {statistics.median(cells['long_500k']['ms'][1:]):.2f} ms"
        f" a step; tp = 2 steady step {tp['step_ms_tp2'][-1]:.1f} ms "
        f"(collectives {tp['coll_ms'][-1]:.1f} ms) against tp = 1 "
        f"{tp['step_ms_tp1'][-1]:.1f} ms"
        + f"; recsys: dlrm sparse steady step "
        f"{statistics.median(rs_sparse['step_ms'][1:]):.1f} ms, peak "
        f"{rs_sparse['peak_bytes'] / 2**30:.2f} GiB; dense step "
        f"{rs_dense['dense']['ms'][-1]:.1f} ms / sparse "
        f"{rs_dense['sparse']['ms'][-1]:.1f} ms at the "
        f"{RS_DENSE_CAP}-row cap; serve_p99 "
        f"{rs_serve['serve_p99']['ms'][-1]:.2f} ms, serve_bulk "
        f"{rs_serve['serve_bulk']['ms'][-1]:.1f} ms, retrieval_cand "
        f"{rs_serve['retrieval_cand']['ms'][-1]:.2f} ms; "
        + ", ".join(f"{a} step {r['train']['step_ms'][-1]:.1f} ms at "
                    f"{r['train']['batch']} rows"
                    for a, r in rs_archs.items())
        + f"; recsys gloo tp = 2 {rs_gloo['seconds']:.1f} s"
        + f"; resnet50 fabric steady round "
        f"{rn_fabric['round_ms'][-2]:.1f} ms (device busy "
        f"{rn_fabric['device_busy_ms'] or 0:.1f} ms profiled), peak "
        f"{rn_fabric['peak_bytes'] / 2**30:.2f} GiB; resnet50 SPMD "
        f"{rn_spmd['batch']} x {rn_spmd['img']}^2 steady step "
        f"{statistics.median(rn_spmd['step_ms'][1:]):.1f} ms, peak "
        f"{rn_spmd['peak_bytes'] / 2**30:.2f} GiB; granite train_4k "
        f"{TRAIN4K_BATCH} x {REMAT_SEQ} steady step "
        f"{statistics.median(granite['train_4k']['step_ms'][1:]):.1f} ms, "
        f"peak {granite['train_4k']['peak_bytes'] / 2**30:.2f} GiB, "
        f"prefill_32k {granite['prefill_32k']['ms'][1]:.1f} ms, decode_32k "
        f"{statistics.median(granite['decode_32k']['ms'][1:]):.2f} ms a "
        f"step; qwen2-moe prefill_32k {qwen['prefill_32k']['ms'][0]:.1f} ms, "
        f"decode_32k at {qwen['decode_32k']['batch']} "
        f"{statistics.median(qwen['decode_32k']['ms'][1:]):.2f} ms a step"
        + "; equiformer-v2 " + ", ".join(
            f"{shape} steady step {run['step_ms'][1]:.1f} ms, peak "
            f"{run['peak_bytes'] / 2**30:.2f} GiB, device busy "
            f"{run['device_busy_ms'] or 0:.1f} ms profiled, "
            f"{run['seconds']:.1f} s (profile {run['profile_s']:.1f} s)"
            for shape, run in gnn.items())
        + "; train_100m_e2e steady step "
        f"{examples['train_100m_e2e']['steady_s_per_step'] * 1e3:.2f} ms, "
        f"peak {examples['train_100m_e2e']['peak_bytes'] / 2**30:.2f} GiB"
        + f"; switch integer math "
        f"{sum(v['ms'] for v in switch_math.values()):.3f} ms; whole run "
        f"{time.perf_counter() - t_start:.1f} s")
    lap("19 timings")
    log("roofline: " + json.dumps(roof))
    log(f"phase seconds: {laps}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


# The timing calls of ``--compare``: run with the chip_smoke.py of the
# checkout whose kernels are timed, at the main path's shapes
# (``time_fused_agg_opt``, ``time_wire`` and ``time_quant``, which earlier
# versions of this file have too; there, SGD had its own
# ``time_fused_agg_opt_sgd``).
_COMPARE_CODE = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
from repro_torch.kernels import _build
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.build_all()
keys = ("ms", "plain_ms", "bound_ms", "library_ms")
out = {
    "adamw_k2_f32": cs.time_fused_agg_opt(dev, 325451776, 2),
    "adamw_k1_f32": cs.time_fused_agg_opt(dev, 325451776, 1, average=False),
    "adamw_k1_bf16": cs.time_fused_agg_opt(dev, 1301807104, 1, average=False,
                                           dtype=torch.bfloat16),
    "sgd_k1_f32": (cs.time_fused_agg_opt_sgd(dev, 2375680)
                   if hasattr(cs, "time_fused_agg_opt_sgd") else
                   cs.time_fused_agg_opt(dev, 2375680, 1, average=False,
                                         opt="sgd", sets=3)),
    "adamw_k1_f32_gnn": cs.time_fused_agg_opt(dev, 35086336, 1,
                                              average=False, sets=2),
    "adamw_k1_f32_e2e": cs.time_fused_agg_opt(dev, 83902464, 1,
                                              average=False),
    "wire_fused": cs.time_wire(dev, 325451776, 2, 8192),
    **cs.time_quant(dev, 1301807104, 8192)}
print("COMPARE " + json.dumps({"root": sys.argv[1], **{
    name: {k: r.get(k) for k in keys} for name, r in out.items()}}))
"""


def compare(other: str) -> int:
    """``python3 chip_smoke.py --compare OTHER``: fused_agg_opt at the four
    main-path shapes, the GNN's (AdamW f32 K = 1 over 35,086,336) and
    train_100m_e2e's (AdamW f32 K = 1 over its flat, 83,902,464), each
    beside its library call where one exists, and the kernels that share
    ``pbox_opt.cuh``, timed
    with this checkout's kernels and with those of the checkout at OTHER
    (e.g. the parent commit unpacked by ``git archive``), each side in its
    own process with its own build, in turns on one card: OTHER, this,
    this, OTHER.  Prints each side's phase-19 lines and a ``COMPARE`` JSON
    line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    other = str(Path(other).resolve())
    for root in (other, str(ROOT), str(ROOT), other):
        subprocess.run([sys.executable, "-c", _COMPARE_CODE, root], cwd=root,
                       check=True, timeout=900)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2]))
    sys.exit(main())
