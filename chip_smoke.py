#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on any failure:

1. device — print the card's name and power limit (``nvidia-smi``), build
   the nine CUDA kernels (the eight Pallas kernels' counterparts and B3's
   fused ``forest_sample``) from the seven sources of
   ``src/repro_torch/kernels/*/csrc`` (B1 and B4 share one, B2 and B5
   another) with ``nvcc`` (started together) and print the build seconds;
2. kernels — ``spmm_dedup_chunks`` against its plain PyTorch version on the
   card (≤1e-5) and against itself run to run (bitwise) at the bucket-16
   serving plan (D = 16 and 7), the Cora-scale full graph (D = 16 and
   1433), the n=4096/e=16384 graph (D = 64) and the sampled block of the
   ``minibatch_lg`` shape (``build_bucket_structure(1024, (15, 10))``,
   169,984 nodes, seeded weights, D = 602: x is 409 MB, eight times the
   L2), timed beside ``torch.sparse.mm`` on the same CSR matrix, with
   ``bound_share`` (bound ÷ kernel), ``vs_library`` (kernel ÷ library) and,
   as a reading, ``gather_ms`` (``index_select`` of the live lanes' x rows:
   what gathering them alone costs a library call);
   ``hash_draws`` against its plain version and numpy's ``_mix64 % deg``,
   exactly equal; ``forest_sample`` (B3's fused route: a bucket's whole
   device forest sample in one launch) against its plain version (the
   eager per-hop loop around ``hash_draws``) on the card, exactly equal and
   run to run, at bucket 1 and 16 at fanouts (5, 3) on the Cora-scale
   graph, a bucket of 16 with 11 padding trees, a graph with empty rows
   (every fifth and the last), three hops (2, 2, 2) and ``minibatch_lg``
   (1024 trees at (15, 10) on a 232,965-node, 114,615,892-edge power-law
   graph drawn on the card, 0.92 GB, copied once to the host for the
   check), each also equal to the host sampler's bucket and timed
   graph-replayed beside the eager plain path and its traced device
   operations, with the bound (bytes once, each distinct ``indices`` slot
   once, and 32-byte sectors as a reading);
2b. B1 in bf16 — ``spmm_dedup_chunks`` on bf16 x (its bf16 instantiation:
   f32 tiles rounded to bf16, each chunk's f32 sum rounded to bf16, the
   block rounded once a chunk) at the bucket-16 plan (D = 16 and 7), the
   Cora-scale graph (D = 16 and 1433) and minibatch_lg's block (D = 602),
   against its bf16 plain version (within 2 bf16 ulps; it repeats the
   kernel's order, so 0 is expected) and itself run to run (bitwise), timed
   beside the f32 kernel at the same shape and ``torch.sparse.mm`` on a
   bf16 CSR (or the reason it is absent), with its bound in bytes at 2-byte
   x and y; then gcn-cora at full width through ``cuda`` in bf16 (bf16 out,
   two launches of the bf16 instantiation) against ``dense`` in f32 within
   the reference's 5e-2;
3. full-graph forward — gcn-cora at full width on the Cora-scale graph,
   ``backend="cuda"`` against ``backend="dense"`` (≤1e-4), and the dense GPU
   run against the CPU (≤1e-4);
4. serving, host sampler — ``GNNServer`` with the ``cuda`` backend: warm up,
   serve 256 single-seed requests, drain; every request settles once, no
   step is rebuilt after warm-up, the SpMM kernel ran, and results equal
   offline one-at-a-time replay (≤1e-5); then one warm bucket-16 step is
   timed and traced with ``torch.profiler`` (device time per step);
5. serving, device sampler — the same with ``sampler="device"``:
   ``forest_sample`` launched once a step and ``hash_draws`` never, parity
   holds against the host-sampled replay, and one warm bucket-16 fused step
   (sampling and GCN body) is traced beside the sampler alone;
6. SpGEMM kernel — ``spgemm_hashpad`` on B's compact cells against its
   compact plain version and the dense-slab oracle gathered through
   ``out_row``/``out_bucket`` (≤1e-5), and against itself run to run
   (bitwise), at three A·A plans: gcn-cora's Â² (Cora-scale, sym-normed
   with self loops), the n=4096/e=16384 power-law graph and a Pubmed-scale
   stand-in (n=19717, e=88648); each timed graph-replayed and eager beside
   eager ``torch.sparse.mm(A, A)`` (cuSPARSE SpGEMM, structure included),
   the whole ``cuda`` executor, and the port's whole A·A from the host's
   arrays (symbolic, pack and numeric: what cuSPARSE's one call does),
   with its bound (the function's own bytes and operations; the count of
   the earlier dense-slab kernels as ``slab_bound_bytes``) and the plan's
   device bytes beside those of the dense-slab layout;
7. SpGEMM executor and the two-hop path — the ``cuda`` executor against
   ``reference`` at the three plans and against ``dense`` at the first two
   (≤1e-4); then, counted, ``two_hop_graph`` and ``coarsen_graph`` with
   ``backend="cuda"`` and gcn-cora at full width over the Â² plan, each held
   against ``reference`` / ``dense`` / the CPU, with the Â² build's wall
   time by phase;
8. int8 aggregation and serving — ``spmm_dedup_chunks_q8`` against its
   plain version (exactly equal) at phase 2's six shapes (D = 1433 in
   three scale tiles), each timed beside ``spmm_dedup_chunks`` at the same
   shape and ``torch.sparse.mm`` on the dequantized matrix (the nearest
   library call: there is no int8 one), with ``bound_share``,
   ``vs_library`` and ``gather_ms`` of the int8 rows; the ``cuda_q8``
   executor
   against ``dense`` under ``q8_gate`` of its scale-derived bound;
   gcn-cora at full width with ``cuda_q8`` against ``dense`` (within
   ``Q8_E2E_TOL``) and its int8 aggregations replayed on the CPU from the
   same inputs (≤1e-5); then, counted, ``GNNServer(backend="cuda_q8",
   sampler="device")`` serving 256 requests as in phase 5, held to offline
   replay within ``Q8_E2E_TOL``, with one warm bucket-16 host-input step
   traced and held against the same step on the CPU, and the fused
   device-sampled step traced as in phase 5;
9. int8 SpGEMM and the two-hop path — ``spgemm_hashpad_q8`` on the baked
   int8 cells against its compact plain version and the dense int8 oracle
   (≤1e-5) and run to run (bitwise) at phase 6's three plans, timed as in
   phase 6 beside phase 6's ``spgemm_hashpad`` and cuSPARSE; the baked
   ``cuda_q8`` executor against ``reference`` under ``q8_gate``, timed
   beside the ``cuda`` executor;
   then, counted, ``two_hop_graph``, ``coarsen_graph`` and gcn-cora over
   the Â² plan, all with ``cuda_q8``, held against ``reference`` / ``dense``
   and against the same int8 calls on the CPU;
10. embedding_bag and dlrm-rm2 serving — dlrm-rm2 at full width with its
    whole fused table (49,127,424 × 64 f32, 12.6 GB) drawn on the card;
    ``embedding_bag`` against its plain version (exactly equal at M = 1,
    ≤1e-5) at the serve_p99 (B = 512) and serve_bulk (B = 262,144) batches
    and a multi-hot batch (M = 4), with row·D past 2³¹, timed beside
    ``F.embedding_bag``; then, counted (one launch per forward),
    ``build_recsys_step`` for serve_p99, serve_bulk and retrieval_cand
    (1 query, 1,000,000 candidates), each held against the same step
    through the plain lookup (≤1e-5) and traced with ``torch.profiler``;
11. sddmm — ``edge_scores`` at the Cora-scale graph (d = 64), the
    ogb_products shape (2,449,029 nodes, 61,859,140 edges, d = 100) and
    that shape with skewed sources drawn on the card (``src = floor(N·u²)``,
    ~40K edges on row 0), counted, against the plain version (≤1e-5
    relative and absolute) and against itself run to run (bitwise), timed
    with ``grouped_floor_ms`` (each distinct x row once, one y row per
    edge, indices and scores) beside the bound and, at ogb_products scale,
    each kernel of one call traced (``kernels_ms``); the first two also on
    src-sorted edges (``src_sorted_ms``) and beside
    ``torch.sparse.sampled_addmm`` on a CSR pattern built beforehand and,
    as ``library_with_pattern_ms``, with the argsort, bincount, cumsum and
    ``sparse_csr_tensor`` that build that pattern from the unsorted
    (src, dst) and the scatter of the scores back to the caller's edge
    order inside the timed call; then the scores of a permuted
    ogb_products edge list, permuted back, must equal the unpermuted ones;
12. flash attention — ``mha_causal`` at qwen3-0.6b's attention width (16
    heads, 8 kv heads, head_dim 128), S = 4096, batch 1, in f32 and bf16,
    counted, against the f32 plain version (≤2e-5 f32, ≤2e-2 bf16), timed
    beside ``scaled_dot_product_attention(is_causal=True)``, with B8's
    achieved TFLOP/s and share of its bound per dtype; B8 over head dims
    (``FLASH_SWEEP``: 5 and every width class to 256, and
    ``FLASH_WIDE_DIMS``: 264, 320, 333, 512, 1000 on the wide kernels;
    BH = 4, S = 1,024) in f32, bf16 and f16, then q f32 with k bf16 and
    v f16, and f64, at d = 128 (each one f32 launch), one counted launch
    a case, against the f32 plain version (``B8_TOL``: ≤2e-5 f32, mixed
    and f64, ≤2e-2 bf16, ≤5e-3 f16), each timed from a replayed graph
    beside its bound (``flash_bound``: at the true d, where the wrapper
    pads d also of the padded work, and the kernel's ``executed_flops``,
    past 256 with q·k recomputed a chunk of v's columns); readings at BH
    16, S 4,096 (``FLASH_READINGS``: f16 at d = 128 and 256, bf16 and f32
    at d = 512), each against its f32 plain version and beside SDPA in
    its dtype; then, as readings and not gates, each B8 instantiation's
    ``HGMMA`` / ``HMMA`` count in its SASS (``cuobjdump -sass``) and its
    registers, stack, local (spill)
    and static shared memory (``cuobjdump --dump-resource-usage``), and
    where each dtype's error comes from (``flash_numerics``: bf16 against
    the rounded f32 plain version and P's rounding alone, f32 against an
    f64 plain version beside emulations of its 3xTF32 sums);
13. GCN training — gcn-cora at full width (seed 0) through
    ``launch/train``'s setup and ``train.loop.run`` (a checkpoint every 25
    steps into a temporary directory), counted: 50 steps each with
    ``dense``, ``chunked``, ``cuda`` and ``cuda_q8``, 20 with ``dense``
    and ``cuda`` over Â²; ``cuda`` against ``dense`` (each step's loss and
    the last parameters ≤1e-4, step 1's gradients within rtol 1e-3, atol
    1e-4) and against the same run on the CPU (≤1e-4 a step), ``cuda_q8``'s
    first loss within ``Q8_E2E_TOL`` of ``dense``'s, each of its 100
    aggregations replayed on the CPU from the card's inputs (≤1e-5) and
    the whole run against the same run on the CPU (within ``Q8_E2E_TOL`` a
    step: an int8 the CPU's ``h @ W`` rounds the other way moves the
    trajectory by ~1e-4), every loss falling,
    Â² ``cuda`` against ``dense`` (≤1e-4 a step); 4 B1 launches a ``cuda``
    step (2 forward, 2 backward on the transpose layout), 2 B4 and 2 B1 a
    ``cuda_q8`` step; the ``cuda`` run resumed from its 25-step commit
    reproduces its last 25 losses and parameters bitwise; each backend's
    warm step traced (wall, device time and operations, busy share, B1
    and B4 ms, no ``index_add`` in the ``cuda``/``cuda_q8`` steps); then B1
    as the backward, dX = Aᵀ·dY on the training plan's transpose at D = 16
    and 7, timed as in phase 2 beside ``torch.sparse.mm(Aᵀ, dY)``, and B1
    and B4 as the forward on the training plans at D = 16 and 7 against
    their plain versions, as in phases 2 and 8;
14. GAT, GIN and SAGE — first the traced-value tile scatter at gat-cora's
    plan (the Cora-scale edges as they are, pairs repeated up to 3 times):
    the plan's layered scatter equal to the CPU's bit for bit, timed
    (eagerly) beside one ``index_put_(accumulate=True)`` and one
    ``index_add_``;
    then serving as phases 4, 5 and 8 do (host sampler, device sampler,
    int8; 256 requests each, replay ≤1e-5 or ``Q8_E2E_TOL`` (for GIN
    relative to its largest output past 1), B1/B4 counted
    at one launch an aggregation — 9 a gat step, 3 gin, 2 sage — and B3 at
    one a device-sampled step, each warm bucket-16 step traced): gat-cora
    at full width and GIN at ``GINConfig()`` (on seeded N(0, 1) features)
    on the Cora-scale graph, SAGE at ``SAGEConfig()`` (602 → 64 →
    41) on a graph of minibatch_lg's size drawn as phase 2 draws it, at
    fanouts (15, 10); then training, 30 steps each on ``dense``, ``cuda``
    and ``cuda_q8``: gat-cora through ``launch/train``'s setup, GIN on one
    batch of the ``molecule`` shape (128 × 30 nodes, 64 edges, one-hot
    species, the quartile of the mean species as the label) through
    ``build_gnn_step``, also over Â² (built in f32 on B2 under ``cuda``
    and ``cuda_q8``), each counted (B1 18 a gat ``cuda`` step, 9 + 9 B4 a
    ``cuda_q8`` step; gin 5, and 2 + 3 B4), each bitwise equal to a
    second run and to a run resumed from its 25-step commit, each step's
    loss and gradient norm (relative, past the first step's norm) within
    1e-4 of the same
    parameters' on ``dense`` and on the CPU (int8: ``Q8_E2E_TOL``, against
    ``dense`` the loss alone, relative past 1 over Â²), the int8 runs' aggregations replayed on
    the CPU (≤1e-5); gat's whole runs against ``dense`` and the CPU ≤1e-4
    a step (GIN's recorded: its trajectory amplifies one rounding
    difference past 1e-4 within a few tens of steps, on the CPU alone);
    one warm
    step of each traced;
15. DLRM training — dlrm-rm2's widths with each vocabulary capped at
    1,000,000 rows (6 of 26 fields; 6.85 M rows, 1.75 GB of table) at
    ``RECSYS_SHAPES["train_batch"]`` (65,536), 20 steps through
    ``build_recsys_step("train")`` and ``train.loop.run``, counted (one B6
    a step), bitwise equal to a second run and to a run resumed from its
    10-step commit, with peak device memory and one warm step traced; the
    first 5 steps at batch 4,096 against the same steps on the CPU
    (≤1e-4);
16. SchNet and DimeNet — both at FULL (``schnet.FULL``: 3 interactions,
    64 wide, 300 RBF; ``dimenet.FULL``: 6 blocks, 128 wide), served on the
    Cora-scale graph with species and positions drawn as
    ``gnn_serve.build_world`` draws them, at fanouts (5, 3), max batch 16,
    256 single-seed requests, on ``cuda`` and ``cuda_q8`` (both accumulate
    in f32 on the chunked schedule: no B1 or B4 launch) with the host and
    the device sampler (one ``forest_sample`` a step), held to offline
    replay within 1e-5 relative to the outputs past 1 (DimeNet's energies
    reach ~700) with no rebuild, each warm bucket-16 step traced; then
    trained on one batch of the ``molecule`` shape (3,840 atoms, 8,192
    edges, 65,536 triplet slots), AdamW (lr 1e-3, DimeNet 1e-4), 8 steps
    each: SchNet and DimeNet on ``dense``, ``cuda`` and ``cuda_q8``,
    DimeNet also with its Â² output stage on ``cuda`` and ``cuda_q8`` (Â²
    built once in f32 by B2, then 2 B1 a ``cuda`` step, B4 + B1 a
    ``cuda_q8`` step; the one-hop runs launch no kernel), each counted,
    bitwise equal to a second run and to a run resumed from its 4-step
    commit, each step's loss
    (relative past 1) and gradient norm (relative past the first step's)
    within 1e-4 of the same parameters' on ``dense`` and, at the last step,
    on the CPU (int8 over Â²: ``Q8_E2E_TOL`` against the CPU, its
    aggregations replayed there ≤1e-5, against ``dense`` a reading), one
    warm step of each traced;
17. the serving plane — gcn-cora at full width under ``cuda`` on the
    Cora-scale graph, 256 requests as one burst a server: with tracing and
    the metrics server on an ephemeral port (device sampler), every request
    has one well-formed span tree (``sample, queue_wait, bucket_pack,
    dispatch, settle``, none open), ``/metrics`` scraped over HTTP during
    the traffic and after the drain parses and counts ``n_served`` served
    requests and histogram observations, one ``forest_sample`` and two B1
    a step, results equal to replay (≤1e-5), with the median span times
    and the device window (dispatch end to settle); with
    ``ChaosInjector(p_step_fault=0.2)`` and one retry, every request
    settles once, the served equal replay, the failed are
    ``RetriesExhausted``, every retried request has a ``retry`` span and
    the launches match the dispatched steps; with ``p_step_fault=1.0``
    every request fails ``RetriesExhausted`` and nothing launches; on the
    host sampler with ``p_sampler_fault=0.1`` exactly the faulted requests
    fail as ``SamplerError`` and the rest equal replay; then the tracing
    cost as a reading: req/s with tracing off and on, in turns, the median
    of 5 bursts each;
18. the cluster tier — first B1 on the lane-stacked plan of 4 lanes
    (``serve.compute.bucket_plan`` with ``n_lanes=4``: the bucket's plan
    four times, block-diagonal, each lane aligned to whole 8-row blocks)
    and B4 with a
    row of feature scales a lane, at buckets 1 and 16 at fanouts (5, 3)
    and D = 16 and 1433, each lane with its own weights, validity and x
    (the lanes 4× apart in magnitude): bitwise equal to the four
    single-lane calls lane by lane and run to run, against the plain
    version (B4 bitwise, B1 ≤1e-5 relative), timed beside the four
    single-lane calls, the plain version and ``torch.sparse.mm`` on the
    stacked CSR, with the bound; then ``ClusterServer(n_lanes=4,
    placement="stacked")`` on the Cora-scale graph (fanouts (5, 3), max
    batch 16, host sampler) serving 1,024 single-seed requests (phase 4's
    draw, longer) as one ``submit_many`` burst, counted: gcn-cora under
    ``cuda`` and ``cuda_q8`` and gat-cora under ``cuda``, every request
    settled once with a result, no step or lane plan built after warm-up,
    one B1 (B4, all lane-scaled) launch an aggregation a round — a
    single-lane step's count, whatever the lanes — and no sampler kernel,
    64 requests held to offline replay (≤1e-5, ``Q8_E2E_TOL`` for int8),
    the per-lane served spread recorded; the control plane on the same
    world: 512 seeds that all route to lane 0 under γ₀ make the router
    reseed, lane 1 killed at round 3 (``gnn_serve --chaos-kill-lane 1
    --chaos-round 3``) loses nothing, re-routes its backlog once (equal to
    replay) and is restored after ``restart_after``, and with every lane
    stalled after the first round under ``slo=True`` the default SLOs shed
    ``best_effort`` (a typed ``Overloaded`` carrying its class) while
    ``interactive`` is still admitted; then readings: req/s, p50 and p99
    of the 4-lane cluster, of one ``GNNServer`` at max batch 16 and of one
    at max batch 64 (the seeds of a 4-lane round in one step) on the same
    1,024 requests (host sampler) in turns, 3 bursts each, and one warm
    bucket-16 round (fetch and stacked step) traced beside one
    single-lane step;
19. live mutation — first ``sparse.delta.DeltaGraphState`` over Cora's
    graph (sym-normed, self loops), the reference's ``delta_repack``
    world (4,096 nodes, 60,000 edges, seed 0) and phase 6's Pubmed-scale
    graph: 6 epochs of 48 inserts and 16 deletes, after each flush both
    layouts bitwise the cold pack's and the incremental plan on the card
    equal to the cold ``plan_from_graph`` on every field (the port's
    ``*_block_ptr``, tile-scatter layers and int8 bake included); then B1
    and B4 on the last incremental plan (Cora D = 16 and 1433, D = 64,
    Pubmed D = 500) bitwise the cold plan's call and against their plain
    versions (B1 ≤1e-5, B4 bitwise), timed beside the cold plan's call, the
    plain version and ``torch.sparse.mm`` on the mutated CSR, with the
    bound; the incremental and cold re-pack's host seconds
    (``delta_repack_speedup``, the reference's bench gates ≥3× at
    4,096/60,000); gcn-cora at full width through the incremental Cora
    plan on ``cuda`` and ``cuda_q8``, bitwise the cold plan's forward;
    then the mutation drill on ``cuda`` and ``cuda_q8``: a 4-lane
    ``ClusterServer`` (phase 18's) traced, with ``/metrics`` on an
    ephemeral port and the flight recorder in a temporary directory, 3
    cycles of 256 requests, ``hot_swap`` onto checkpoint k (the weights ×
    (1 + 0.01k), the port's store) while they are in flight, 96 inserts
    and 24 deletes of original edges through a ``GraphStream``
    (``parity_every=1``) and its flush, 256 more requests; counted: every
    request settled once on one version in [0, 3], old versions drained,
    every flush parity-proven, ≥2 graph epochs served, no step or plan
    built, 2 B1 (B4) launches a round and a shadow warm-up, every
    blackout finite, 3 ``params_swap`` and 3 ``graph_flush`` events
    recorded, 64 requests on the last version and epoch equal to offline
    replay (≤1e-5, ``Q8_E2E_TOL`` for int8) and up to 16 of each version
    replayed on their own trees with that version's weights; on ``cuda``
    the abort paths (a torn checkpoint, a tree of the wrong shape, an
    absent edge's delete), each leaving the version and graph as they
    were with a following burst of 64 equal to replay, and 64 feature
    rows re-homed, then 64 requests replayed on the patched store;
    NeuraScope's check and summary on each recorder and its HTML report
    (byte size printed); readings: validate, warm and blackout a swap,
    repack and staleness a flush (and a restore and a flush on the idle
    server), how long the engine left ready requests waiting inside the
    swaps and the mutation windows, req/s and p50/p99 under mutation;
20. the LM family — qwen3-0.6b at FULL (28 layers, d_model 1024, 16 heads
    and 8 kv heads of 128, vocab 151,936, tied embeddings, bf16) with its
    parameters drawn on the card: the prefill at B = 1, S = 4096 with B8
    (``attention="flash"``), counted (28 launches), against the blocked
    attention on the same inputs (last-token logits within ``LM_BF16_REL``
    of their largest magnitude; a flash and a blocked forward's logits
    within ``LM_BF16_REL`` at every one of the 4,096 positions and their
    top-1 tokens agreeing at ≥ ``LM_BF16_TOP1`` of them), and in f32 at
    FULL widths with the depth cut to 4 (≤ ``LM_F32_REL``);
    ``launch/serve.build_engine``'s ``ContinuousBatcher`` serving 16
    requests (prompts 64–512, 32–64 new tokens) on 8 slots, every one
    finished, 28 B8 a prefill, each served prefill's logits and cache
    within ``LM_BF16_REL`` of a blocked prefill of the same prompt, each
    served token's logit in a teacher-forced blocked forward within
    ``LM_SERVE_SLACK`` of its position's maximum (equality with offline
    decode a reading, beside where one request's tokens part at batch 1
    and 8), and the reduced qwen3 in f32 token for token equal to offline
    decode, its served prefills within ``LM_F32_REL`` of blocked ones;
    8 training steps
    at B = 2, S = 2048 through ``build_lm_step`` and ``train.loop.run``
    (AdamW, f32 moments, lr 1e-3, one repeated batch), the loss falling
    from within 0.5 of ln V, the run resumed from its step-4 commit (~6 GB
    of bf16 parameters and f32 moments) bitwise the unbroken run; step 1
    at FULL widths, depth 2, f32, B = 1, S = 256 on the card against the
    CPU (loss ≤1e-4 relative, gradients rtol 1e-3, atol 1e-4); readings:
    prefill wall and device ms, tokens/s, B8's share and ms a call against
    its bound, an 8-slot decode step, the training step traced and its
    peak memory;
21. A8c and A8d — NeuraSim's workload statistics of the 20 Table-1
    graphs (``neurasim.datasets.synth`` at the published node and edge
    counts, up to cit-Patents' 3.77 M nodes and 7.4e7 partial products)
    computed on the card (``stats_from_coo``, ``mapping_loads`` for the
    four mappings) with ``pp_interim`` equal to the host's
    ``deg[cols].sum()`` everywhere and the statistics, row tags and loads
    equal to the CPU's on the fast set and cit-Patents, then the model's
    GOP/s per config and its MKL and Gamma ratios (the model's numbers,
    not the card's speed); A·A of facebook and wiki-Vote through the
    ``cuda`` SpGEMM executor, counted (B2), C against B2's plain version
    (≤1e-5) and the plan's ``pp_interim`` and C's entries equal to
    NeuraSim's; three ``error_feedback_compress`` steps over one
    backward's bf16 gradients of qwen3-0.6b FULL at B = 2, S = 2048, timed,
    the embedding, an attention and an MLP leaf and every leaf under a
    million elements bitwise equal to the same steps on the CPU, with the
    wire bytes against bf16 and f32; one training step each of
    qwen3-0.6b FULL (phase 20's shape), gcn-cora FULL on ``dense`` (phase
    13's) and dlrm-rm2 at ``train_batch`` (phase 15's vocabularies)
    counted under ``launch/op_costs`` on the card, flops equal to the same
    step counted under ``FakeTensorMode`` on the host, with
    ``flops.model_flops``, the useful ratio and the FLOP share of the
    step's device time from its own phase against the bf16 and f32
    peaks; and ``launch.dryrun``'s qwen3-0.6b × train_4k, dlrm-rm2 ×
    train_batch, the batch-1 decodes qwen3-0.6b, gemma-7b, grok-1-314b
    and llama4-maverick × long_500k and grok-1-314b × decode_32k (the
    MoE decodes torch 2.11 could not trace before: the slot buffer's
    flatten, the cache write on a split sequence) on a fake 16×16 world,
    each ``ok`` and counting per
    device between its unsharded count ÷ 256 and that count, with the
    operations that ran replicated (host work started in the background
    with phase 20's training, niced, one thread a process), the cells now
    traced with the reference's sharding constraints (``dp_axes``,
    ``tp_axis``, ``moe_mlp_sharded``), and the count of them that trace;
22. A7, the distributed executor (``tools/a7_phase.py``) — the
    ``distributed`` backend on one NCCL rank (gcn-cora at full width on
    the Cora-scale graph: aggregate, accumulate, the gradient in x and
    the forward against ``dense``, timed beside it); the same at 4 gloo
    ranks sharing the card (NCCL refuses two ranks on one device; their
    collectives go through pinned host buffers), with the all-gather and
    ring SpMMs at phase 6's Pubmed-scale stand-in (D = 602) against the
    single-device product, each other and run to run, and
    ``build_gcn_drhm_step`` (all-gather and ring) against the local GCN
    loss, three steps; each world's transport printed; then, counted, the
    4-lane cluster with every lane on the card (``devices=[cuda:0] * 4``)
    serving gcn-cora at full width on ``cuda`` and ``cuda_q8``: sharded
    residency bitwise replicated, mesh placement bitwise stacked, offline
    replay, B1 (B4) launched, the halo gather timed beside the replicated
    fetch, a hot-swap and a graph flush on sharded residency with no
    request lost; and ``spmm_blocked_ell`` against its plain version at
    phase 2's bucket-16 and Cora-scale shapes (one B1 a call);
23. gemma-7b at FULL (28 layers, d_model 3072, 16 heads and 16 kv heads
    of head_dim 256, d_ff 24,576, GeGLU, vocab 256,000, tied, bf16,
    ~8.54e9 parameters, 17.1 GB) drawn on the card from seed 0, after
    phase 20 has freed qwen3's: phase 20's prefill checks (B8 at d = 256,
    28 launches, against the blocked attention at ``LM_BF16_REL`` and
    ``LM_BF16_TOP1``; f32 at depth 4 at ``LM_F32_REL``), its serving (16
    requests on 8 slots, 28 B8 a prefill, every request finished with
    tokens inside the vocab, each served prefill and served token held as
    there, then the reduced gemma in f32 token for token equal to offline
    decode; equality of the FULL model's tokens with offline decode is
    not taken here, to keep the phase short) and its readings (prefill and
    decode traced, B8's share of the prefill's device time); then B8 at
    gemma's attention shape (BH = 16, S = 4,096, d = 256) in bf16 and
    f32 against its f32 plain version on the same values (≤2e-5 f32,
    ≤2e-2 bf16), timed from a replayed graph beside its plain version,
    ``scaled_dot_product_attention`` and its bound.

Launch counters are set to 0 just before each main-path run (the
serving runs, phases 7 and 9's paths, each DLRM step, phases 11 and
12's wrapper calls, each training run of phases 13–16, phase 2b's bf16
forward, phases 17 and 18's servers, phase 19's forwards and drills,
phase 20's and 23's prefills, forwards and servers, phase 22's sharded
and mesh-placed clusters and ``spmm_blocked_ell`` calls) and read just
after it; launches made to compare or
time a kernel are not counted.  The
line before last is a JSON object with each kernel's launches, error and
times; the last line is ``{"ok": true, "device": {...}}``.  Times come from
CUDA events: the kernels, ``torch.sparse.mm`` SpMM, ``F.embedding_bag``
and ``scaled_dot_product_attention`` replayed from a captured CUDA graph
(device time per call); the plain versions, the SpGEMM executor, cuSPARSE
SpGEMM (which syncs on the host to size its output, so it cannot be
captured) and ``sampled_addmm`` run eagerly.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import pathlib
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM tf32 tensor cores, dense
# an f32-accurate product on the tensor cores as 3xTF32: three TF32 products
# for each f32 one
F32_3XTF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
INT8_OPS_PER_S = 1979e12         # H100 SXM int8 tensor cores, dense
KERNEL_TOL = 1e-5
EXECUTOR_TOL = 1e-4
SERVE_TOL = 1e-5
N_REQUESTS = 256
# phases 10-12 sizes: B6 batches (name, B, M); ogb_products (nodes, edges,
# d), repro configs/shapes.py:70; qwen3-0.6b attention (B, S, H, KV, hd),
# repro configs/qwen3_0_6b.py at the train_4k length, batch cut to 1
B6_CASES = (("serve_p99", 512, 1), ("serve_bulk", 262144, 1),
            ("multi_hot", 4096, 4))
OGB_PRODUCTS = (2_449_029, 61_859_140, 100)
# minibatch_lg's graph (nodes, edges), repro configs/shapes.py:66-69
MINIBATCH_LG_GRAPH = (232_965, 114_615_892)
QWEN3_ATTENTION = (1, 4096, 16, 8, 128)
# phase 12's head-dim sweep: (BH, S, head dims): each instantiation's
# widths and widths below and between them, which the wrapper pads on the
# card to the next width
FLASH_SWEEP = (4, 1024, (5, 8, 16, 24, 32, 64, 80, 96, 112, 128, 160, 256))
# past 256: the wide kernels, at multiples of 64 (320, 512) and between
# them (264, 333, 1000), which the wrapper pads on the card
FLASH_WIDE_DIMS = (264, 320, 333, 512, 1000)
# B8's bars against its f32 plain version: f16 keeps 3 more mantissa bits
# of q, k, v, P and o than bf16
B8_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 5e-3}
# phase 12's readings at full size (BH, S): f16 at d = 128 and 256, and
# d = 512 in bf16 and f32, each beside SDPA
FLASH_READINGS = (16, 4096, ((torch.float16, 128), (torch.float16, 256),
                             (torch.bfloat16, 512), (torch.float32, 512)))
GEOM_ARCHS = ("schnet", "dimenet")


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _median_event_ms(run, per_run: int, reps: int = 5) -> float:
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_run)
    return statistics.median(samples)


def graph_ms(fn, calls: int = 50, replays: int = 10) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between two events (no host overhead)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()

    def run():
        for _ in range(replays):
            graph.replay()
    return _median_event_ms(run, calls * replays)


def eager_ms(fn, iters: int = 50) -> float:
    """Time per call issued eagerly from Python (host overhead included)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
    return _median_event_ms(run, iters)


# ---------------------------------------------------------------------------
# phase 2 — kernels
# ---------------------------------------------------------------------------

def spmm_bound(plan, d, y_numel, q8=False, x_scales=0):
    """The least time of one B1 call (B4 with ``q8``) on ``plan``'s forward
    layout at width ``d``: the larger of the bytes it must move over the
    memory rate and its operations over the peak of their type.

    Least bytes: only the live lanes u < remaining[k] of a chunk carry
    data, so count those u_cols entries and those tile columns (f32: 4
    bytes a row, int8: 1), not the padded (BR, W) tiles; each x row a live
    lane names once (f32 or int8); remaining, block_ptr, the ``x_scales``
    feature scales and (int8) the chunk scales, and y (f32) written once.
    Least operations: 2 a nonzero coefficient a column.  Returns the
    record's ``bound_ms``/``bound_by``/``bound_bytes``, the live-lane mask
    and the live lane count."""
    br = plan.block_rows
    rem = plan.ell_remaining.cpu().numpy().astype(np.int64)
    u_cols = plan.ell_u_cols.cpu().numpy()
    live = np.arange(u_cols.shape[1]) < rem[:, None]
    live_lanes = int(rem.sum())
    x_rows = np.unique(u_cols[live]).size
    if q8:
        n_bytes = (live_lanes * (4 + br) + x_rows * d
                   + 4 * (2 * rem.size + x_scales
                          + plan.ell_block_ptr.numel() + y_numel))
        tiles, peak = plan.ell_a_q8, INT8_OPS_PER_S
    else:
        n_bytes = 4 * (live_lanes * (1 + br) + rem.size
                       + plan.ell_block_ptr.numel() + x_rows * d + y_numel)
        tiles, peak = plan.ell_a, F32_FLOPS_PER_S
    n_ops = 2 * int((tiles != 0).sum()) * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return (dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 bound_bytes=n_bytes), live, live_lanes)


def spmm_case(name, plan, d, rng):
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_plain)
    dev = plan.device
    x = torch.from_numpy(rng.normal(size=(plan.n_rows, d)).astype(
        np.float32)).to(dev)
    args = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_a, x)
    br = plan.block_rows
    y = spmm_dedup_chunks(*args, block_rows=br)
    y_plain = spmm_dedup_chunks_plain(*args, block_rows=br)
    torch.cuda.synchronize()
    err = float((y - y_plain).abs().max())
    del y_plain
    check(bool(torch.isfinite(y).all()), f"B1 {name}: non-finite output")
    check(err <= KERNEL_TOL, f"B1 {name} d={d}: max|kernel-plain| {err:.3e}"
                             f" > {KERNEL_TOL}")
    check(torch.equal(spmm_dedup_chunks(*args, block_rows=br), y),
          f"B1 {name} d={d}: not bitwise equal run to run")
    a_csr = torch.sparse_coo_tensor(
        torch.stack([plan.rows, plan.cols]), plan.base_vals,
        (plan.n_rows, plan.n_rows),
        check_invariants=True).coalesce().to_sparse_csr()
    lib_err = float((torch.sparse.mm(a_csr, x)
                     - y[: plan.n_rows]).abs().max())
    check(lib_err <= EXECUTOR_TOL,
          f"B1 {name}: kernel vs torch.sparse.mm {lib_err:.3e}")
    calls = 50 if y.numel() < 2 ** 26 else 5       # 50 × 409 MB is too much
    ms = graph_ms(lambda: spmm_dedup_chunks(*args, block_rows=br), calls)
    rec = dict(
        shape=f"{name} D={d}", max_abs_err=err, run_to_run="bitwise",
        ms=ms,
        eager_ms=eager_ms(lambda: spmm_dedup_chunks(*args, block_rows=br)),
        plain_ms=eager_ms(lambda: spmm_dedup_chunks_plain(*args,
                                                          block_rows=br),
                          iters=50 if calls == 50 else 5),
        library_ms=graph_ms(lambda: torch.sparse.mm(a_csr, x), calls))
    bound, live, live_lanes = spmm_bound(plan, d, y.numel())
    rec.update(bound, padded_bytes=4 * (sum(t.numel() for t in args)
                                        + y.numel()),
               gathered_mb=4 * d * live_lanes / 1e6)
    # a reading, not a gate: one library gather of the same live x rows
    # (read and written once each), the floor of a gather-then-fold design
    live_cols = plan.ell_u_cols[torch.from_numpy(live).to(dev)].long()
    rec.update(bound_share=rec["bound_ms"] / ms,
               vs_library=ms / rec["library_ms"],
               gather_ms=graph_ms(lambda: x.index_select(0, live_cols),
                                  calls))
    say(f"B1 {json.dumps(rec)}")
    return rec


def minibatch_lg_plan(dev, rng):
    """The sampled block of the repo's ``minibatch_lg`` shape (batch 1024,
    fanouts (15, 10), ``repro`` configs/shapes.py:65) as the serving path
    builds a bucket, with seeded weights: 169,984 nodes, 21,248 blocks.
    At D = 602 its x (409 MB) is eight times the L2."""
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse.plan import make_plan
    st = build_bucket_structure(1024, (15, 10), with_loops=True)
    w = rng.uniform(0.1, 1.0, st.n_edges).astype(np.float32)
    return make_plan(st.senders, st.receivers, st.n_nodes, edge_weight=w,
                     backends=("dense", "cuda", "cuda_q8"), device=dev)


def phase_kernels(dev):
    from repro_torch.data.synthetic import cora_like, powerlaw_graph
    from repro_torch.kernels.forest_sampler import (hash_draws,
                                                    hash_draws_plain)
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse.graph import sym_norm_weights
    from repro_torch.sparse.plan import make_plan
    from repro_torch.sparse.sampler import _mix64
    rng = np.random.default_rng(0)
    backends = ("dense", "chunked", "cuda", "cuda_q8")

    st = build_bucket_structure(16, (5, 3), with_loops=True)
    w = rng.uniform(0.1, 1.0, st.n_edges).astype(np.float32)
    bucket = make_plan(st.senders, st.receivers, st.n_nodes, edge_weight=w,
                       backends=backends, device=dev)
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, wn = sym_norm_weights(s, r, 2708)
    cora = make_plan(s2, r2, 2709, edge_weight=wn, backends=backends,
                     device=dev)
    s, r = powerlaw_graph(4096, 16384 + 256, seed=4096)
    flag = make_plan(s[:16384], r[:16384], 4097,
                     edge_weight=rng.normal(size=16384).astype(np.float32),
                     backends=backends, device=dev)
    minibatch = minibatch_lg_plan(dev, rng)
    b1 = [spmm_case("bucket16", bucket, 16, rng),
          spmm_case("bucket16", bucket, 7, rng),
          spmm_case("cora_full", cora, 16, rng),
          spmm_case("n4096_e16384", flag, 64, rng),
          spmm_case("cora_full", cora, 1433, rng),
          spmm_case("minibatch_lg", minibatch, 602, rng)]

    # B3: the serving shape (16 trees × 15 second-hop lanes) plus edge values
    z = rng.integers(0, 2 ** 63, (16, 15), dtype=np.int64).view(np.uint64)
    z[0, :5] = [0, 2 ** 64 - 1, 2 ** 63, 2 ** 63 - 1, 0x9E3779B97F4A7C15]
    z[1:4] |= np.uint64(1 << 63)                 # top bit set
    deg = rng.integers(1, 2 ** 31 - 1, (16, 15)).astype(np.int32)
    deg[0, :3] = 1
    deg[0, 3:6] = 2 ** 31 - 1
    deg[4] = 2
    want = (_mix64(z) % deg.astype(np.uint64)).astype(np.int32)
    zt = torch.from_numpy(z.view(np.int64).copy()).to(dev)
    dt = torch.from_numpy(deg).to(dev)
    got = hash_draws(zt, dt).cpu().numpy()
    plain = hash_draws_plain(zt, dt).cpu().numpy()
    check(np.array_equal(got, want), "B3 kernel != numpy _mix64 % deg")
    check(np.array_equal(plain, want), "B3 plain != numpy _mix64 % deg")
    n = z.size
    b3 = dict(shape="16x15", max_abs_err=0.0,
              ms=graph_ms(lambda: hash_draws(zt, dt)),
              eager_ms=eager_ms(lambda: hash_draws(zt, dt)),
              plain_ms=eager_ms(lambda: hash_draws_plain(zt, dt)),
              library_ms=None,
              # integer hashing has no peak in the card's table; 8 B of z
              # and 4 B of deg in, 4 B out per draw
              bound_ms=(8 + 4 + 4) * n / HBM_BYTES_PER_S * 1e3,
              bound_by="bytes")
    say(f"B3 {json.dumps(b3)}")
    return b1, b3, {"bucket16": bucket, "cora_full": cora,
                    "n4096_e16384": flag, "minibatch_lg": minibatch}


def minibatch_lg_graph(dev, gen):
    """A graph at the ``minibatch_lg`` shape's size (``repro`` configs/
    shapes.py:66–69: 232,965 nodes, 114,615,892 edges) drawn on the card:
    ``indptr`` from a seeded power-law (Pareto, shape 2) degree sequence
    that sums to E, ``indices`` uniform, both int64 (0.92 GB)."""
    n, e = MINIBATCH_LG_GRAPH
    w = (1 - torch.rand(n, generator=gen, device=dev,
                        dtype=torch.float64)) ** -0.5
    deg = (w * (e / float(w.sum()))).floor().to(torch.int64)
    short = e - int(deg.sum())
    deg[torch.randperm(n, generator=gen, device=dev)[:short]] += 1
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = deg.cumsum(0)
    indices = torch.randint(0, n, (e,), generator=gen, device=dev,
                            dtype=torch.int64)
    check(int(indptr[-1]) == e, "minibatch_lg graph: degrees do not sum "
                                "to E")
    return indptr, indices


def forest_bound(trees, node_ids, hop_valid, fanouts, n_nodes):
    """Least bytes of one forest sample, from this run's outputs: each
    live tree's seed, key term and live flag (24 B) and each padding
    tree's live flag alone (8 B), each distinct valid parent's ``indptr``
    pair (16 B) and each distinct ``indices`` slot that a valid child reads
    (8 B) read once, and ``node_ids`` (8 B) and ``hop_valid`` (1 B) written
    once.  The slots are not an output, so they are counted as the distinct
    (parent, child) pairs among valid children: two draws that land on one
    slot give one pair, and a pair can stand for no fewer slots, so the
    count is never more than the slots read.  As a reading,
    ``sector_bytes`` counts each parent's pair and each slot as one
    32-byte sector, the least a random read moves."""
    t = trees.shape[1]
    n_live = int((trees[2] != 0).sum())
    sizes = [math.prod(fanouts[:h]) for h in range(len(fanouts) + 1)]
    n_parents = t * sum(sizes[:-1])
    parents = node_ids[:n_parents]
    distinct = int(torch.unique(parents[parents >= 0]).numel())
    pairs, off, voff = [], t, 0
    for h, f in enumerate(fanouts):
        level = node_ids[off - t * sizes[h]:off].reshape(t, sizes[h], 1)
        child = node_ids[off:off + t * sizes[h + 1]].reshape(t, sizes[h], f)
        valid = hop_valid[voff:voff + t * sizes[h + 1]].reshape(t, sizes[h],
                                                                f)
        pairs.append((level.expand(t, sizes[h], f) * n_nodes + child)[valid])
        off += t * sizes[h + 1]
        voff += t * sizes[h + 1]
    slots = int(torch.unique(torch.cat(pairs)).numel())
    tree_bytes = 24 * n_live + 8 * (t - n_live)
    n_bytes = (tree_bytes + 16 * distinct + 8 * slots + 8 * node_ids.numel()
               + hop_valid.numel())
    sector_bytes = (tree_bytes + 32 * (distinct + slots)
                    + 8 * node_ids.numel() + hop_valid.numel())
    return dict(bound_ms=n_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bound_bytes=n_bytes,
                sector_bound_ms=sector_bytes / HBM_BYTES_PER_S * 1e3,
                valid_parents=int((parents >= 0).sum()),
                distinct_parents=distinct,
                valid_children=int(hop_valid.sum()), distinct_slots=slots)


def forest_case(name, indptr, indices, trees, fanouts, key, host=None):
    """``forest_sample`` against its plain version on the card (exactly
    equal) and, with ``host`` (the CSR as numpy arrays and the trees' keys),
    against the host sampler's bucket; timed graph-replayed beside the
    eager plain path (the per-hop loop of torch operations around one
    ``hash_draws`` launch a hop), whose device operations are traced."""
    from repro_torch.kernels.forest_sampler import (forest_sample,
                                                    forest_sample_plain)
    from repro_torch.sparse.sampler import _mix64
    key_c = int(_mix64(np.uint64(key)))
    args = (indptr, indices, trees, fanouts, key_c)
    node_ids, hop_valid = forest_sample(*args)
    plain_ids, plain_valid = forest_sample_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(node_ids, plain_ids)
          and torch.equal(hop_valid, plain_valid),
          f"forest_sample {name}: kernel != plain version")
    again = forest_sample(*args)
    check(torch.equal(again[0], node_ids) and torch.equal(again[1],
                                                          hop_valid),
          f"forest_sample {name}: not equal run to run")
    if host is not None:
        from repro_torch.serve.buckets import stack_trees
        from repro_torch.sparse.sampler import sample_forest
        host_indptr, host_indices, tree_keys = host
        live = trees[2].cpu().numpy() != 0
        seeds = trees[0].cpu().numpy()[live]
        forest = sample_forest(host_indptr, host_indices, seeds, fanouts,
                               key=key, tree_keys=tree_keys[live])
        want_ids, want_valid = stack_trees(forest, trees.shape[1], fanouts)
        check(np.array_equal(node_ids.cpu().numpy(), want_ids)
              and np.array_equal(hop_valid.cpu().numpy(), want_valid),
              f"forest_sample {name}: != the host sampler's bucket")
    plain_trace = trace_steps(lambda: forest_sample_plain(*args), 5,
                              "hash_draws")
    rec = dict(shape=f"{name} T={trees.shape[1]} fanouts={fanouts}",
               nodes=node_ids.numel(), max_abs_err=0.0,
               host_sampler_equal=host is not None,
               ms=graph_ms(lambda: forest_sample(*args)),
               eager_ms=eager_ms(lambda: forest_sample(*args)),
               plain_ms=eager_ms(lambda: forest_sample_plain(*args)),
               plain_device_ms=plain_trace["device_ms_per_step"],
               plain_device_ops=plain_trace["device_ops_per_step"],
               library_ms=None,
               **forest_bound(trees, node_ids, hop_valid, fanouts,
                              indptr.numel() - 1))
    rec.update(bound_share=rec["bound_ms"] / rec["ms"],
               plain_over_kernel=rec["plain_ms"] / rec["ms"])
    say(f"B3 forest_sample {json.dumps(rec)}")
    return rec


def phase_forest(dev):
    """``forest_sample`` (B3's fused route) against its plain version at
    the serving shape and its corners, and at ``minibatch_lg``."""
    from repro_torch.data.synthetic import cora_like
    from repro_torch.serve.device_sampler import pack_trees, tree_key_mix
    from repro_torch.sparse.graph import coo_to_csr
    rng = np.random.default_rng(19)
    s, r, _, _, _ = cora_like(seed=0)
    n = 2708
    indptr, indices, _ = coo_to_csr(s, r, n)
    # isolated rows: every fifth node and the last (the end-of-CSR corner)
    iso = (np.arange(n) % 5 == 0) | (np.arange(n) == n - 1)
    keep = ~iso[r]
    iso_indptr, iso_indices, _ = coo_to_csr(s[keep], r[keep], n)

    def on_card(ip, ix):
        return (torch.from_numpy(np.asarray(ip, np.int64)).to(dev),
                torch.from_numpy(np.asarray(ix, np.int64)).to(dev))

    def batch(n_trees, n_live, seeds=None):
        keys = rng.integers(0, 2 ** 63, n_trees).astype(np.uint64)
        if seeds is None:
            seeds = rng.integers(0, n, n_trees)
        live = np.arange(n_trees) < n_live
        trees = pack_trees(np.where(live, seeds, 0), tree_key_mix(keys),
                           live)
        return torch.from_numpy(trees).to(dev), keys

    cora = on_card(indptr, indices)
    iso_graph = on_card(iso_indptr, iso_indices)
    iso_seeds = np.concatenate([[n - 1, 0, 5], rng.integers(0, n, 13)])
    cases = [("cora_bucket1", cora, (indptr, indices), batch(1, 1), (5, 3)),
             ("cora_bucket16", cora, (indptr, indices), batch(16, 16),
              (5, 3)),
             ("cora_bucket16_5_live", cora, (indptr, indices), batch(16, 5),
              (5, 3)),
             ("isolated_bucket16", iso_graph, (iso_indptr, iso_indices),
              batch(16, 16, iso_seeds), (5, 3)),
             ("cora_three_hops", cora, (indptr, indices), batch(16, 16),
              (2, 2, 2))]
    recs = [forest_case(name, *graph, trees, fanouts, key=19,
                        host=(*host_csr, keys))
            for name, graph, host_csr, (trees, keys), fanouts in cases]
    n = MINIBATCH_LG_GRAPH[0]
    big = minibatch_lg_graph(dev, torch.Generator(device=dev).manual_seed(19))
    trees, keys = batch(1024, 1024, rng.integers(0, n, 1024))
    host_big = (big[0].cpu().numpy(), big[1].cpu().numpy(), keys)
    recs.append(forest_case("minibatch_lg", *big, trees, (15, 10), key=19,
                            host=host_big))
    del host_big
    del big
    torch.cuda.empty_cache()
    return recs


# ---------------------------------------------------------------------------
# phases 3-5 — model and serving
# ---------------------------------------------------------------------------

def phase_forward(dev, cora_plan, params, x_table):
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse.plan import make_plan
    x = torch.from_numpy(x_table).to(dev)
    y_cuda = gcn.forward(params, FULL, x, backend="cuda", plan=cora_plan)
    y_dense = gcn.forward(params, FULL, x, backend="dense", plan=cora_plan)
    check(tuple(y_cuda.shape) == (2709, FULL.n_classes),
          f"forward shape {tuple(y_cuda.shape)}")
    check(bool(torch.isfinite(y_cuda).all()), "forward: non-finite logits")
    err = float((y_cuda - y_dense).abs().max())
    check(err <= EXECUTOR_TOL, f"forward cuda vs dense {err:.3e}")
    # the dense executor on the GPU against the same forward on the CPU
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    cpu_plan = make_plan(cora_plan.cols.cpu().numpy(),
                         cora_plan.rows.cpu().numpy(), cora_plan.n_rows,
                         edge_weight=cora_plan.base_vals.cpu().numpy(),
                         device="cpu")
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="dense", plan=cpu_plan)
    err_cpu = float((y_dense.cpu() - y_cpu).abs().max())
    check(err_cpu <= EXECUTOR_TOL, f"forward GPU vs CPU {err_cpu:.3e}")
    say(f"forward gcn-cora on the Cora-scale graph: cuda vs dense "
        f"{err:.3e}, GPU dense vs CPU dense {err_cpu:.3e}")


# ---------------------------------------------------------------------------
# phase 2b — B1 in bf16
# ---------------------------------------------------------------------------

BF16_ULPS = 2            # bf16 kernel vs its plain version (0 expected)
BF16_MODEL_TOL = 5e-2    # a bf16 forward vs f32 dense, the reference's bar


def bf16_ulps(got, want) -> float:
    """Largest |got − want| in bf16 ulps at the larger magnitude."""
    g, w = got.double(), want.double()
    mag = torch.maximum(torch.maximum(g.abs(), w.abs()),
                        torch.full_like(g, 2.0 ** -126))
    return float(((g - w).abs() / torch.exp2(torch.floor(torch.log2(mag))
                                             - 7)).max())


def spmm_bf16_case(name, plan, d, rng):
    """B1's bf16 instantiation at one shape: against its plain version
    (which repeats the kernel's order and rounding, so 0 is expected; the
    bar is ``BF16_ULPS``) and itself run to run, timed beside the f32
    kernel on the same values in f32 and ``torch.sparse.mm`` on a bf16
    CSR, with its bound in bytes at 2-byte x and y."""
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_plain)
    dev = plan.device
    x = torch.from_numpy(rng.normal(size=(plan.n_rows, d)).astype(
        np.float32)).to(dev)
    x16 = x.to(torch.bfloat16)
    br = plan.block_rows
    meta = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_a)
    y = spmm_dedup_chunks(*meta, x16, block_rows=br)
    y_plain = spmm_dedup_chunks_plain(*meta, x16, block_rows=br)
    torch.cuda.synchronize()
    check(y.dtype == torch.bfloat16, f"B1 bf16 {name}: output {y.dtype}")
    check(bool(torch.isfinite(y).all()), f"B1 bf16 {name}: non-finite")
    ulps = bf16_ulps(y, y_plain)
    err = float((y.float() - y_plain.float()).abs().max())
    check(ulps <= BF16_ULPS, f"B1 bf16 {name} d={d}: {ulps} ulps from its "
                             f"plain version > {BF16_ULPS}")
    equal_plain = bool(torch.equal(y, y_plain))
    del y_plain
    check(torch.equal(spmm_dedup_chunks(*meta, x16, block_rows=br), y),
          f"B1 bf16 {name} d={d}: not bitwise equal run to run")
    calls = 50 if y.numel() < 2 ** 26 else 5
    rec = dict(
        shape=f"{name} D={d} bf16", max_abs_err=err, max_ulps=ulps,
        equal_plain=equal_plain, run_to_run="bitwise",
        ms=graph_ms(lambda: spmm_dedup_chunks(*meta, x16, block_rows=br),
                    calls),
        f32_ms=graph_ms(lambda: spmm_dedup_chunks(*meta, x, block_rows=br),
                        calls),
        plain_ms=eager_ms(lambda: spmm_dedup_chunks_plain(
            *meta, x16, block_rows=br), iters=50 if calls == 50 else 3))
    a_csr = torch.sparse_coo_tensor(
        torch.stack([plan.rows, plan.cols]), plan.base_vals,
        (plan.n_rows, plan.n_rows),
        check_invariants=True).coalesce().to_sparse_csr()
    a16 = torch.sparse_csr_tensor(a_csr.crow_indices(), a_csr.col_indices(),
                                  a_csr.values().to(torch.bfloat16),
                                  a_csr.shape)
    try:
        torch.sparse.mm(a16, x16)
    except RuntimeError as exc:       # a yardstick only: say why it is absent
        rec.update(library_ms=None, library_note=str(exc).splitlines()[0])
    else:
        rec["library_ms"] = graph_ms(lambda: torch.sparse.mm(a16, x16),
                                     calls)
    # least bytes as phase 2 counts them, x and y at 2 bytes; operations at
    # the f32 CUDA-core rate (the kernel widens bf16 to f32)
    rem = plan.ell_remaining.cpu().numpy().astype(np.int64)
    u_cols = plan.ell_u_cols.cpu().numpy()
    live = np.arange(u_cols.shape[1]) < rem[:, None]
    live_lanes = int(rem.sum())
    x_rows = np.unique(u_cols[live]).size
    n_bytes = (4 * (live_lanes * (1 + br) + rem.size
                    + plan.ell_block_ptr.numel())
               + 2 * (x_rows * d + y.numel()))
    n_flops = 2 * int((plan.ell_a != 0).sum()) * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes)
    rec.update(bound_share=rec["bound_ms"] / rec["ms"],
               vs_f32=rec["ms"] / rec["f32_ms"])
    say(f"B1 bf16 {json.dumps(rec)}")
    return rec


def phase_bf16(dev, agg_plans, params, x_table):
    """Phase 2b: B1's bf16 instantiation at phase 2's serving and Cora
    shapes and minibatch_lg's block, then gcn-cora at full width through
    ``cuda`` in bf16 against ``dense`` in f32, counted."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks
    from repro_torch.models.gnn import gcn
    rng = np.random.default_rng(16)
    cases = [spmm_bf16_case("bucket16", agg_plans["bucket16"], 16, rng),
             spmm_bf16_case("bucket16", agg_plans["bucket16"], 7, rng),
             spmm_bf16_case("cora_full", agg_plans["cora_full"], 16, rng),
             spmm_bf16_case("cora_full", agg_plans["cora_full"], 1433, rng),
             spmm_bf16_case("minibatch_lg", agg_plans["minibatch_lg"], 602,
                            rng)]
    plan = agg_plans["cora_full"]
    x = torch.from_numpy(x_table).to(dev)
    spmm_dedup_chunks.launches = spmm_dedup_chunks.launches_bf16 = 0
    y16 = gcn.forward(params, FULL, x.to(torch.bfloat16), backend="cuda",
                      plan=plan)
    torch.cuda.synchronize()
    launches = {"spmm_dedup_chunks": spmm_dedup_chunks.launches,
                "bf16": spmm_dedup_chunks.launches_bf16}
    y32 = gcn.forward(params, FULL, x, backend="dense", plan=plan)
    check(y16.dtype == torch.bfloat16 and tuple(y16.shape) == (2709, 7),
          f"bf16 forward: {y16.dtype} {tuple(y16.shape)}")
    check(bool(torch.isfinite(y16).all()), "bf16 forward: non-finite")
    err = float((y16.float() - y32).abs().max())
    check(err <= BF16_MODEL_TOL, f"bf16 cuda forward vs f32 dense {err:.3e}"
                                 f" > {BF16_MODEL_TOL}")
    check(launches == {"spmm_dedup_chunks": FULL.n_layers,
                       "bf16": FULL.n_layers},
          f"bf16 forward launches {launches}, expected {FULL.n_layers} of "
          "the bf16 instantiation")
    rec = dict(forward_err_vs_f32_dense=err, forward_tol=BF16_MODEL_TOL,
               launches=launches)
    say(f"bf16 forward {json.dumps(rec)}")
    return cases, rec


def tree_to(params, device):
    """A copy of a parameter tree on ``device``."""
    from repro_torch import tree
    leaves, structure = tree.flatten(params)
    return tree.unflatten(structure, [t.to(device) for t in leaves])


def host_input_step(server, seeds):
    """The server's bucket-16 step body on host-sampled node tables (the
    step a host-sampler server runs; a device-sampler server fuses sampling
    in front of the same body), with its inputs."""
    from repro_torch.serve.buckets import stack_trees
    from repro_torch.serve.compute import build_infer_step
    trees = server.sample_for(seeds[:16], rid=0)
    node_ids, hop_valid = stack_trees(trees, 16, server.fanouts)
    step = build_infer_step(server.arch_id, server.cfg, server.store,
                            server._struct(16), backend=server.backend)
    return step, node_ids, hop_valid


def trace_steps(step, n_steps: int, kernel: str, top: int = 0,
                split=None) -> dict:
    """Wall time per call of ``step`` (host clock around ``n_steps`` calls
    and a sync), and from a ``torch.profiler`` trace of another
    ``n_steps`` the device time of all its kernels, of ``kernel`` alone
    and, with ``top``, of the ``top`` costliest device operations.
    ``split`` maps names to predicates on a kernel's key: each gives
    ``<name>_ms_per_step``, and the record then lists every traced key,
    host operations included, as ``op_keys``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    kernel_us = sum(e.self_device_time_total for e in kernels
                    if kernel in e.key)
    rec = dict(step_wall_ms=wall_ms,
               device_ms_per_step=dev_us / 1e3 / n_steps,
               kernel_ms_per_step=kernel_us / 1e3 / n_steps,
               device_ops_per_step=sum(e.count for e in kernels) / n_steps,
               device_busy_share=dev_us / 1e3 / n_steps / wall_ms)
    for name, pred in (split or {}).items():
        rec[f"{name}_ms_per_step"] = sum(
            e.self_device_time_total for e in kernels
            if pred(e.key)) / 1e3 / n_steps
    if split:
        rec["op_keys"] = sorted({e.key for e in prof.key_averages()})
    if top:
        costliest = sorted(kernels, key=lambda e: -e.self_device_time_total)
        rec["top_ms_per_step"] = {
            e.key[:60]: e.self_device_time_total / 1e3 / n_steps
            for e in costliest[:top]}
    return rec


def step_breakdown(server, seeds, n_steps: int = 20) -> dict:
    """Where one warm bucket-16 host-input step spends its time: wall per
    step, and from a ``torch.profiler`` trace the device time of all its
    kernels and of the SpMM kernel (f32 or int8) alone."""
    step, node_ids, hop_valid = host_input_step(server, seeds)
    rec = trace_steps(lambda: step(server.params, node_ids, hop_valid),
                      n_steps, "spmm_dedup_chunks")
    rec["spmm_ms_per_step"] = rec.pop("kernel_ms_per_step")
    return rec


def device_step_breakdown(server, reqs, n_steps: int = 20) -> dict:
    """Where one warm bucket-16 device-sampled step spends its time: the
    server's fused step (sampling, feature gather and GCN body) on 16
    served single-seed requests packed as the engine packs them, traced as
    ``step_breakdown`` traces the host-input body; then the device sampler
    alone on the same trees, and its share of the step's device time and
    operations."""
    batch = reqs[:16]
    step = server.steps.get((16,))
    trees = server._device_batch(batch, 16)
    rec = trace_steps(lambda: step(server.params, trees), n_steps,
                      "spmm_dedup_chunks")
    rec["spmm_ms_per_step"] = rec.pop("kernel_ms_per_step")
    seeds = np.concatenate([r.seeds for r in batch])
    tkm = np.concatenate([r.tkm for r in batch])
    plane = server._plane
    live = np.ones(16, bool)
    alone = trace_steps(lambda: plane.sample_bucket(seeds, tkm, live),
                        n_steps, "forest_sample")
    rec.update(
        sampler_wall_ms=alone["step_wall_ms"],
        sampler_device_ms=alone["device_ms_per_step"],
        sampler_kernel_ms=alone["kernel_ms_per_step"],
        sampler_device_ops=alone["device_ops_per_step"],
        sampler_device_share=(alone["device_ms_per_step"]
                              / rec["device_ms_per_step"]),
        sampler_ops_share=(alone["device_ops_per_step"]
                           / rec["device_ops_per_step"]))
    return rec


def q8_tol(ref, relative: bool) -> float:
    """The int8 end-to-end bar: ``Q8_E2E_TOL``, or with ``relative`` that
    bar relative to the largest output of ``ref`` past 1 (an int8 step
    rounds each layer's values to its scale, so its error grows with them:
    GIN's sum aggregations reach outputs near 15)."""
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    if not relative:
        return Q8_E2E_TOL
    return Q8_E2E_TOL * max(1.0, float(np.abs(np.asarray(ref)).max()))


def serve_tol(arch, backend, ref, q8_relative=False) -> float:
    """The served-vs-replay bar: ``SERVE_TOL``, under int8 ``q8_tol``; for
    the geometric family (f32 on every executor) ``SERVE_TOL`` relative to
    the largest output past 1: DimeNet's per-atom energies at FULL with
    random weights reach ~700, where one f32 ulp is 6e-5, and a bucket-16
    step rounds its products otherwise than its bucket-1 replay."""
    if arch in GEOM_ARCHS:
        return SERVE_TOL * max(1.0, float(np.abs(np.asarray(ref)).max()))
    if backend == "cuda_q8":
        return q8_tol(ref, q8_relative)
    return SERVE_TOL


def aggregations_per_step(arch: str, cfg) -> int:
    """``sparse.backend.aggregate`` calls in one forward: one per layer,
    and one per head on GAT's hidden layers; none for schnet and dimenet,
    whose vector messages go through ``accumulate`` (the chunked schedule
    on every executor)."""
    if arch in GEOM_ARCHS:
        return 0
    if arch.startswith("gat"):
        return cfg.n_heads * (cfg.n_layers - 1) + 1
    return cfg.n_layers


def phase_serve(dev, mode, params, indptr, indices, store, seeds,
                backend="cuda", arch="gcn", cfg=None, fanouts=(5, 3),
                q8_relative=False):
    """One server (``arch`` at ``cfg``, gcn-cora's FULL by default) serving
    ``seeds`` as single-seed requests, counted and held to offline replay
    (``q8_tol`` under ``cuda_q8``), with its warm bucket-16 step
    traced."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.kernels.forest_sampler import forest_sample, hash_draws
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.serve import GNNServer, offline_replay
    spmm = {"cuda": spmm_dedup_chunks,
            "cuda_q8": spmm_dedup_chunks_q8}[backend]
    kernels = (spmm_dedup_chunks, spmm_dedup_chunks_q8, forest_sample,
               hash_draws)
    cfg = FULL if cfg is None else cfg
    per_step = aggregations_per_step(arch, cfg)
    with GNNServer(arch, cfg, params, indptr, indices, store,
                   fanouts=fanouts, backend=backend, sampler=mode,
                   max_batch_seeds=16, device=dev) as server:
        server.warmup()
        builds = server.steps.builds
        server.reset_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        reqs = [server.submit([int(s)]) for s in seeds]
        server.drain()
        dt = time.perf_counter() - t0
        launches = {k.__name__: k.launches for k in kernels}
        st = server.stats()
        check(all(r.n_settles == 1 and r.error is None for r in reqs),
              f"{backend}/{mode}: a request did not settle exactly once "
              "with a result")
        check(server.steps.builds == builds,
              f"{backend}/{mode}: {server.steps.builds - builds} step "
              "rebuild(s) after warm-up")
        check(launches[spmm.__name__] == per_step * st["n_batches"],
              f"{arch} {backend}/{mode}: {launches[spmm.__name__]} "
              f"{spmm.__name__} launches for {st['n_batches']} steps of "
              f"{per_step} aggregations")
        if mode == "device":
            # the sampler is one fused launch a step; the standalone draw
            # kernel is not on this path
            check(launches["forest_sample"] == st["n_batches"],
                  f"{backend}/device: {launches['forest_sample']} "
                  f"forest_sample launches for {st['n_batches']} steps")
            check(launches["hash_draws"] == 0,
                  f"{backend}/device: hash_draws launched "
                  f"{launches['hash_draws']} times on the serving path")
        ref = np.concatenate([offline_replay(server, r) for r in reqs])
        breakdown = {}
        if mode == "host" or backend == "cuda_q8":
            breakdown = step_breakdown(server, seeds)
        if backend == "cuda_q8":
            breakdown.update(q8_step_vs_cpu(server, seeds, q8_relative))
        if mode == "device":
            breakdown["device_step"] = device_step_breakdown(server, reqs)
    got = np.concatenate([r.result for r in reqs])
    width = 1 if arch in GEOM_ARCHS else cfg.n_classes   # energies
    check(got.shape == (len(seeds), width) and np.isfinite(got).all(),
          f"{arch} {backend}/{mode}: served results malformed")
    err = float(np.abs(got - ref).max())
    tol = serve_tol(arch, backend, ref, q8_relative)
    check(err <= tol, f"{arch} {backend}/{mode}: served vs offline replay "
                      f"{err:.3e} > {tol}")
    rec = dict(arch=arch, backend=backend, sampler=mode,
               requests=len(seeds), launches_per_step=per_step,
               req_per_s=len(seeds) / dt, p50_ms=st["p50_ms"],
               p99_ms=st["p99_ms"], batches=st["n_batches"],
               buckets=st["bucket_counts"], launches=launches,
               parity_max_abs=err, parity_tol=tol,
               max_abs_output=float(np.abs(ref).max()), **breakdown)
    say(f"serve {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phases 6-7 — SpGEMM kernel, executors and the two-hop path
# ---------------------------------------------------------------------------

def spgemm_plans(dev):
    """The three A·A plans: (name, plan, dense oracle allowed)."""
    from repro_torch.data.synthetic import cora_like, powerlaw_graph
    from repro_torch.sparse.graph import sym_norm_weights
    from repro_torch.sparse.spgemm import make_spgemm_plan
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, w = sym_norm_weights(s, r, 2708)
    cases = [("cora_a2", r2, s2, 2708, w, True)]
    s, r = powerlaw_graph(4096, 16384 + 256, seed=4096)   # spgemm_sweep
    cases.append(("n4096_e16384", r[:16384], s[:16384], 4096,
                  np.random.default_rng(1).normal(size=16384).astype(
                      np.float32), True))
    s, r = powerlaw_graph(19717, 88648 + 2000, alpha=1.6, seed=0)
    cases.append(("pubmed_scale", r[:88648], s[:88648], 19717,
                  np.random.default_rng(2).normal(size=88648).astype(
                      np.float32), False))
    plans = []
    for name, r, s, n, w, dense_ok in cases:
        t0 = time.perf_counter()
        plan = make_spgemm_plan(r, s, n, r, s, n, a_vals=w, b_vals=w,
                                executors=("dense", "reference", "cuda",
                                           "cuda_q8"),
                                device=dev)
        torch.cuda.synchronize()
        say(f"spgemm plan {name}: nnz(A) {plan.nnz_a}, pp {plan.pp_interim},"
            f" nnz(C) {plan.nnz_out}, pad_width {plan.pad_width}, "
            f"{plan.n_chunks} chunks x {plan.width}, host plan "
            f"{time.perf_counter() - t0:.3f}s")
        plans.append((name, plan, dense_ok))
    return plans


CELL_FIELDS = ("cell_ptr", "cell_lane", "cell_bucket", "cell_val", "cell_src",
               "cell_src_ptr", "cell_q8")


def plan_bytes(plan) -> dict:
    """Device bytes of an ``SpgemmPlan``: its tensors now, and the same
    plan in the layout before B's compact cells (no ``cell_*`` fields, and
    with ``cuda_q8`` a dense ``(n_chunks·width, pad_width)`` int8 slab)."""
    import dataclasses

    def nbytes(names):
        return sum(t.numel() * t.element_size() for t in
                   (getattr(plan, n) for n in names)
                   if isinstance(t, torch.Tensor))
    now = nbytes([f.name for f in dataclasses.fields(plan)])
    before = now - nbytes(CELL_FIELDS)
    if plan.cell_q8 is not None:
        before += plan.n_chunks * plan.width * plan.pad_width
    return dict(plan_bytes=now, plan_bytes_dense_slab_layout=before)


def spgemm_bound(plan, tiles, value_bytes: int,
                 peak_ops_per_s: float) -> dict:
    """The least time for the hash-pad function on this plan's data.
    Bytes: A's live coefficient columns, each compact cell once (lane,
    bucket, value), the cell pointers, C's buckets read and values written,
    remaining, block_ptr, c_indptr (and the two per-chunk scales of the
    int8 kernel).  Operations: 2 per product of a nonzero coefficient with
    a cell of its lane.  ``slab_bound_bytes`` is the count of the earlier
    dense-slab kernels (each live slab row once, the pad written once),
    kept so their readings stay comparable."""
    k, w, h, br = plan.n_chunks, plan.width, plan.pad_width, plan.block_rows
    live = int(plan.ell_remaining.sum())
    scale_bytes = 8 * k if value_bytes == 1 else 0
    n_bytes = (live * br * value_bytes + plan.n_cells * (8 + value_bytes)
               + 4 * ((k + 1) + 2 * plan.nnz_out + k
                      + plan.ell_block_ptr.numel() + plan.c_indptr.numel())
               + scale_bytes)
    a_nz = (tiles.reshape(k, br, w) != 0).sum(1)                # (k, w)
    chunk = torch.repeat_interleave(
        torch.arange(k, device=plan.device),
        (plan.cell_ptr[1:] - plan.cell_ptr[:-1]).long())
    n_ops = 2 * int(a_nz[chunk, plan.cell_lane.long()].sum())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak_ops_per_s
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=n_bytes, bound_ops=n_ops, live_lanes=live,
                n_cells=plan.n_cells,
                slab_bound_bytes=value_bytes * live * (h + br) + scale_bytes
                + 4 * (k + plan.ell_block_ptr.numel() + plan.n_blocks * br * h))


def whole_build_ms(plan, backend: str) -> float:
    """Wall ms of the port's whole A·B from the host's COO arrays, best of
    two: the host symbolic phase and pack (``make_spgemm_plan`` with
    ``backend``'s layout only) and the numeric phase, synchronized.  That
    is the work ``torch.sparse.mm`` does in one call (C's structure and
    values); the kernel's ms is the numeric phase alone."""
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.spgemm import make_spgemm_plan
    a_rows, a_cols, b_rows, b_cols, a_vals, b_vals = (
        t.cpu().numpy() for t in (plan.a_rows, plan.a_cols, plan.b_rows,
                                  plan.b_cols, plan.a_base, plan.b_base))
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = make_spgemm_plan(a_rows, a_cols, plan.n_rows, b_rows, b_cols,
                             plan.n_inner, plan.n_cols, a_vals=a_vals,
                             b_vals=b_vals, executors=(backend,),
                             device=plan.device)
        sb.spgemm(p, backend=backend)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def spgemm_case(name, plan):
    from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                                spgemm_hashpad_compact_plain,
                                                spgemm_hashpad_plain)
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.spgemm.numeric import hashed_slab
    args = (plan.ell_remaining, plan.ell_block_ptr, plan.ell_a, plan.cell_ptr,
            plan.cell_lane, plan.cell_bucket, plan.cell_val, plan.c_indptr,
            plan.out_bucket)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    c_vals = spgemm_hashpad(*args, **kw)
    again = spgemm_hashpad(*args, **kw)
    plain = spgemm_hashpad_compact_plain(*args, **kw)
    oracle = spgemm_hashpad_plain(
        plan.ell_remaining, plan.ell_block_ptr, plan.ell_a,
        hashed_slab(plan), **kw)[plan.out_row.long(), plan.out_bucket.long()]
    torch.cuda.synchronize()
    check(c_vals.shape == (plan.nnz_out,) and bool(
        torch.isfinite(c_vals).all()), f"B2 {name}: malformed C values")
    err = float((c_vals - plain).abs().max())
    check(err <= KERNEL_TOL, f"B2 {name}: max|kernel-plain| {err:.3e} > "
                             f"{KERNEL_TOL}")
    err_oracle = float((c_vals - oracle).abs().max())
    check(err_oracle <= KERNEL_TOL, f"B2 {name}: max|kernel-dense oracle| "
                                    f"{err_oracle:.3e} > {KERNEL_TOL}")
    check(torch.equal(again, c_vals), f"B2 {name}: two calls differ")
    del plain, oracle, again
    big = plan.nnz_out > 200_000
    a_csr = torch.sparse_coo_tensor(
        torch.stack([plan.a_rows.long(), plan.a_cols.long()]), plan.a_base,
        (plan.n_rows, plan.n_inner),
        check_invariants=True).coalesce().to_sparse_csr()
    rec = dict(
        shape=f"{name} H={plan.pad_width}", max_abs_err=err,
        dense_oracle_err=err_oracle, run_to_run_equal=True,
        ms=graph_ms(lambda: spgemm_hashpad(*args, **kw)),
        eager_ms=eager_ms(lambda: spgemm_hashpad(*args, **kw)),
        plain_ms=eager_ms(lambda: spgemm_hashpad_compact_plain(*args, **kw),
                          iters=3 if big else 10),
        library_ms=eager_ms(lambda: torch.sparse.mm(a_csr, a_csr),
                            iters=10),
        executor_ms=eager_ms(lambda: sb.spgemm(plan, backend="cuda")),
        whole_build_ms=whole_build_ms(plan, "cuda"),
        library_note="torch.sparse.mm(A_csr, A_csr): cuSPARSE SpGEMM, "
                     "structure included, eager; set it beside "
                     "whole_build_ms (symbolic + pack + numeric), not "
                     "beside the kernel's numeric phase alone",
        **spgemm_bound(plan, plan.ell_a, 4, F32_FLOPS_PER_S),
        **plan_bytes(plan))
    say(f"B2 {json.dumps(rec)}")
    return rec


def phase_spgemm_executors(plans):
    from repro_torch.sparse import backend as sb
    for name, plan, dense_ok in plans:
        got = sb.spgemm(plan, backend="cuda")
        check(got.shape == (plan.nnz_out,) and bool(torch.isfinite(
            got).all()), f"spgemm cuda {name}: malformed result")
        err_ref = float((got - sb.spgemm(plan, backend="reference")
                         ).abs().max())
        check(err_ref <= EXECUTOR_TOL,
              f"spgemm {name}: cuda vs reference {err_ref:.3e}")
        msg = f"spgemm executor {name}: cuda vs reference {err_ref:.3e}"
        if dense_ok:
            err_dense = float((got - sb.spgemm(plan, backend="dense")
                               ).abs().max())
            check(err_dense <= EXECUTOR_TOL,
                  f"spgemm {name}: cuda vs dense {err_dense:.3e}")
            msg += f", vs dense {err_dense:.3e}"
        say(msg)


def phase_two_hop(dev, params, x_table):
    """The counted path: Â² and a coarsened graph through the ``cuda``
    SpGEMM executor, then gcn-cora at full width over the Â² plan."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks
    from repro_torch.kernels.spgemm_pad import spgemm_hashpad
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse.graph import (coarsen_graph, graph_coo,
                                          make_graph, sym_norm_weights)
    from repro_torch.sparse.plan import plan_from_graph
    from repro_torch.sparse.spgemm import two_hop_graph
    from repro_torch.sparse.stats import kernel_stats
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, w = sym_norm_weights(s, r, 2708)
    g = make_graph(s2, r2, 2708, edge_weight=w, device=dev)
    clusters = np.random.default_rng(3).integers(0, 128, 2708)
    x = torch.from_numpy(x_table).to(dev)
    kernel_stats().reset()

    spgemm_hashpad.launches = 0
    spmm_dedup_chunks.launches = 0
    t0 = time.perf_counter()
    g2 = two_hop_graph(g, backend="cuda")
    t1 = time.perf_counter()
    plan2 = plan_from_graph(g2, backends=("cuda",))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    gc = coarsen_graph(g, clusters, 128, backend="cuda")
    y = gcn.forward(params, FULL, x, backend="cuda", plan=plan2)
    torch.cuda.synchronize()
    launches = {"spgemm_hashpad": spgemm_hashpad.launches,
                "spmm_dedup_chunks": spmm_dedup_chunks.launches}
    check(launches == {"spgemm_hashpad": 3, "spmm_dedup_chunks": 2},
          f"two-hop path launches {launches}, expected 3 spgemm_hashpad "
          "(two_hop_graph 1 + coarsen_graph 2) and 2 spmm_dedup_chunks")
    series = kernel_stats().snapshot()["series"]
    build = {k: series[f"two_hop.{k}_s"]["sum"]
             for k in ("symbolic", "numeric", "repack")}
    build.update(b1_plan_pack=t2 - t1, two_hop_graph_total=t1 - t0)

    # Â² through cuda has the reference's edges and weights
    g2_ref = two_hop_graph(g, backend="reference")
    s_c, r_c, w_c = graph_coo(g2)
    s_r, r_r, w_r = graph_coo(g2_ref)
    check(np.array_equal(s_c, s_r) and np.array_equal(r_c, r_r),
          "two-hop: cuda and reference Â² have different edges")
    err_w = float(np.abs(w_c - w_r).max())
    check(err_w <= KERNEL_TOL, f"two-hop weights cuda vs reference "
                               f"{err_w:.3e}")
    gc_ref = coarsen_graph(g, clusters, 128, backend="reference")
    s_c, r_c, w_c = graph_coo(gc)
    s_r, r_r, w_r = graph_coo(gc_ref)
    check(np.array_equal(s_c, s_r) and np.array_equal(r_c, r_r),
          "coarsen: cuda and reference graphs have different edges")
    err_c = float(np.abs(w_c - w_r).max())
    check(err_c <= EXECUTOR_TOL, f"coarsen cuda vs reference {err_c:.3e}")

    # gcn-cora at full width over Â²: cuda vs dense, GPU vs CPU
    check(tuple(y.shape) == (2709, FULL.n_classes) and bool(
        torch.isfinite(y).all()), "two-hop forward malformed")
    y_dense = gcn.forward(params, FULL, x, backend="dense", plan=plan2)
    err_y = float((y - y_dense).abs().max())
    check(err_y <= EXECUTOR_TOL, f"two-hop forward cuda vs dense "
                                 f"{err_y:.3e}")
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    s2_c, r2_c, w2_c = graph_coo(g2)
    g2_cpu = make_graph(s2_c, r2_c, 2708, edge_weight=w2_c, device="cpu")
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="dense",
                        plan=plan_from_graph(g2_cpu, backends=("dense",)))
    err_cpu = float((y.cpu() - y_cpu).abs().max())
    check(err_cpu <= EXECUTOR_TOL, f"two-hop forward GPU vs CPU "
                                   f"{err_cpu:.3e}")
    rec = dict(a2_edges=int(g2.edge_valid.sum()),
               coarse_edges=int(gc.edge_valid.sum()), launches=launches,
               a2_weight_err=err_w, coarsen_err=err_c,
               forward_cuda_vs_dense=err_y, forward_gpu_vs_cpu=err_cpu,
               build_s=build)
    say(f"two-hop {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phases 8-9 — the int8 path
# ---------------------------------------------------------------------------

def on_cpu(plan):
    """The same plan with every tensor copied to the CPU."""
    import dataclasses
    return dataclasses.replace(plan, **{
        f.name: getattr(plan, f.name).cpu()
        for f in dataclasses.fields(plan)
        if isinstance(getattr(plan, f.name), torch.Tensor)})


def replay_aggregates_on_cpu(run):
    """Run ``run()`` with every ``sparse.backend.aggregate`` call recorded,
    then replay each call on the CPU (plain kernel versions) from the very
    inputs the card saw.  Returns (run's result, calls, max |card − CPU|).

    A whole int8 forward on the CPU can round differently from the card's:
    the f32 combination ``h @ W`` sums in another order, and a value that
    moves by one ulp across a rounding boundary changes an int8 by one.
    Replaying each aggregation from the same ``h`` holds the kernels and the
    quantization to the plain path without that.  Calls made with gradients
    on (training) are recorded detached and replayed without them."""
    from repro_torch.sparse import backend as sb
    calls = []
    aggregate = sb.aggregate

    def detached(t):
        return t.detach() if isinstance(t, torch.Tensor) else t

    def recorded(plan, vals, x, backend="dense"):
        y = aggregate(plan, vals, x, backend=backend)
        calls.append((plan, detached(vals), detached(x), backend,
                      y.detach()))
        return y
    sb.aggregate = recorded
    try:
        out = run()
    finally:
        sb.aggregate = aggregate
    err, cpu_plans = 0.0, {}
    with torch.no_grad():
        for plan, vals, x, backend, y in calls:
            if id(plan) not in cpu_plans:
                cpu_plans[id(plan)] = (plan, on_cpu(plan))
            y_cpu = aggregate(cpu_plans[id(plan)][1],
                              None if vals is None else vals.cpu(), x.cpu(),
                              backend=backend)
            err = max(err, float((y.cpu() - y_cpu).abs().max()))
    return out, len(calls), err


def dequantized_csr(plan, a_q8, a_scale):
    """The f32 matrix the int8 tiles stand for, as CSR: the operand of the
    nearest library call (``torch.sparse.mm`` has no int8 SpMM)."""
    k, w = plan.ell_u_cols.shape
    br = plan.block_rows
    ptr = plan.ell_block_ptr.long()
    n_blocks = ptr.numel() - 1
    block = torch.repeat_interleave(torch.arange(n_blocks, device=ptr.device),
                                    ptr[1:] - ptr[:-1])
    tiles = a_q8.reshape(k, br, w).float() * a_scale[:, None, None]
    live = torch.arange(w, device=ptr.device)[None, :] < \
        plan.ell_remaining[:, None]
    kk, rr, uu = torch.nonzero(live[:, None, :] & (tiles != 0),
                               as_tuple=True)
    idx = torch.stack([block[kk] * br + rr, plan.ell_u_cols[kk, uu].long()])
    return torch.sparse_coo_tensor(
        idx, tiles[kk, rr, uu], (n_blocks * br, plan.n_rows),
        check_invariants=True).coalesce().to_sparse_csr()


def spmm_q8_case(name, plan, d, rng):
    from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                    spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8,
                                                    spmm_dedup_chunks_q8_plain)
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse import quantize as qz
    dev = plan.device
    x = torch.from_numpy(rng.normal(size=(plan.n_rows, d)).astype(
        np.float32)).to(dev)
    qt = auto_d_tile(d)
    x_q8, x_scale = qz.quantize_feature_tiles(x, qt)
    args = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
            plan.ell_a_q8, plan.ell_a_scale, x_q8, x_scale)
    br = plan.block_rows
    y = spmm_dedup_chunks_q8(*args, block_rows=br, q_tile=qt)
    y_plain = spmm_dedup_chunks_q8_plain(*args, block_rows=br, q_tile=qt)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), f"B4 {name}: non-finite output")
    err = float((y - y_plain).abs().max())
    del y_plain
    check(err == 0, f"B4 {name} d={d}: max|kernel-plain| {err:.3e} != 0")
    # the executor against dense, under the scale-derived bound
    y_exec = sb.aggregate(plan, None, x, backend="cuda_q8")
    dev_dense = float((y_exec - sb.aggregate(plan, None, x, backend="dense")
                       ).abs().max())
    bound = qz.aggregate_q8_bound(plan.ell_remaining, plan.ell_out_block,
                                  plan.n_blocks, plan.ell_a_scale, x_scale)
    check(qz.q8_gate(dev_dense, bound),
          f"B4 {name} d={d}: cuda_q8 vs dense {dev_dense:.3e} over the "
          f"bound {bound:.3e}")
    a_csr = dequantized_csr(plan, plan.ell_a_q8, plan.ell_a_scale)
    x_deq = x_q8.float() * torch.repeat_interleave(x_scale, qt)[:d]
    lib_err = float((torch.sparse.mm(a_csr, x_deq) - y).abs().max())
    check(lib_err <= EXECUTOR_TOL,
          f"B4 {name}: kernel vs torch.sparse.mm(dequantized) {lib_err:.3e}")
    f32_args = (plan.ell_u_cols, plan.ell_remaining, plan.ell_block_ptr,
                plan.ell_a, x)
    calls = 50 if y.numel() < 2 ** 26 else 5
    rec = dict(
        shape=f"{name} D={d}", max_abs_err=err,
        ms=graph_ms(lambda: spmm_dedup_chunks_q8(*args, block_rows=br,
                                                 q_tile=qt), calls),
        f32_kernel_ms=graph_ms(lambda: spmm_dedup_chunks(*f32_args,
                                                         block_rows=br),
                               calls),
        plain_ms=eager_ms(lambda: spmm_dedup_chunks_q8_plain(
            *args, block_rows=br, q_tile=qt), iters=10 if calls == 50 else 3),
        library_ms=graph_ms(lambda: torch.sparse.mm(a_csr, x_deq), calls),
        library_note="torch.sparse.mm on the dequantized f32 matrix and "
                     "features (nearest library call: no int8 SpMM)",
        q8_executor_vs_dense=dev_dense, q8_bound=bound,
        library_err=lib_err)
    bound, live, _ = spmm_bound(plan, d, y.numel(), q8=True,
                                x_scales=x_scale.numel())
    rec.update(bound, padded_bytes=(sum(t.numel() * t.element_size()
                                        for t in args) + 4 * y.numel()))
    live_cols = plan.ell_u_cols[torch.from_numpy(live).to(dev)].long()
    rec.update(bound_share=rec["bound_ms"] / rec["ms"],
               vs_library=rec["ms"] / rec["library_ms"],
               gather_ms=graph_ms(lambda: x_q8.index_select(0, live_cols),
                                  calls))
    say(f"B4 {json.dumps(rec)}")
    return rec


def phase_q8_kernels(agg_plans):
    rng = np.random.default_rng(8)
    return [spmm_q8_case("bucket16", agg_plans["bucket16"], 16, rng),
            spmm_q8_case("bucket16", agg_plans["bucket16"], 7, rng),
            spmm_q8_case("cora_full", agg_plans["cora_full"], 16, rng),
            spmm_q8_case("n4096_e16384", agg_plans["n4096_e16384"], 64, rng),
            spmm_q8_case("cora_full", agg_plans["cora_full"], 1433, rng),
            spmm_q8_case("minibatch_lg", agg_plans["minibatch_lg"], 602,
                         rng)]


def phase_q8_forward(dev, cora_plan, params, x_table):
    """gcn-cora at full width through ``cuda_q8`` on the Cora-scale graph."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    x = torch.from_numpy(x_table).to(dev)
    y_q8, n_calls, replay_err = replay_aggregates_on_cpu(
        lambda: gcn.forward(params, FULL, x, backend="cuda_q8",
                            plan=cora_plan))
    check(tuple(y_q8.shape) == (2709, FULL.n_classes) and bool(
        torch.isfinite(y_q8).all()), "q8 forward malformed")
    check(n_calls == FULL.n_layers and replay_err <= KERNEL_TOL,
          f"q8 forward: {n_calls} aggregations, card vs CPU replay "
          f"{replay_err:.3e}")
    y_dense = gcn.forward(params, FULL, x, backend="dense", plan=cora_plan)
    err = float((y_q8 - y_dense).abs().max())
    check(err <= Q8_E2E_TOL, f"q8 forward vs dense {err:.3e}")
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="cuda_q8", plan=on_cpu(cora_plan))
    err_cpu = float((y_q8.cpu() - y_cpu).abs().max())
    check(err_cpu <= Q8_E2E_TOL, f"q8 forward GPU vs CPU {err_cpu:.3e}")
    rec = dict(q8_vs_dense=err, aggregations_vs_cpu_replay=replay_err,
               forward_gpu_vs_cpu=err_cpu)
    say(f"q8 forward gcn-cora {json.dumps(rec)}")
    return rec


def q8_step_vs_cpu(server, seeds, relative=False) -> dict:
    """One warm bucket-16 ``cuda_q8`` step on the card against the same
    step on the CPU: each int8 aggregation replayed on the CPU from the
    card's inputs (≤1e-5), and the whole step's output (within
    ``q8_tol``: the CPU's own ``h @ W`` may round an int8 the other
    way)."""
    from repro_torch.serve.compute import build_infer_step
    step, node_ids, hop_valid = host_input_step(server, seeds)
    y, n_calls, replay_err = replay_aggregates_on_cpu(
        lambda: step(server.params, node_ids, hop_valid))
    check(n_calls == aggregations_per_step(server.arch_id, server.cfg)
          and replay_err <= KERNEL_TOL,
          f"q8 step: {n_calls} aggregations, card vs CPU replay "
          f"{replay_err:.3e}")
    cpu_step = build_infer_step(server.arch_id, server.cfg,
                                server.store.to("cpu"), server._struct(16),
                                backend="cuda_q8")
    y_cpu = cpu_step(tree_to(server.params, "cpu"), node_ids, hop_valid)
    err = float((y.cpu() - y_cpu).abs().max())
    # the geometric family runs no int8 aggregation: an f32 step, held
    # relative to its outputs past 1 (as ``serve_tol``)
    tol = (EXECUTOR_TOL * max(1.0, float(y_cpu.abs().max()))
           if server.arch_id in GEOM_ARCHS else q8_tol(y_cpu, relative))
    check(err <= tol, f"q8 step GPU vs CPU {err:.3e} > {tol}")
    return dict(step_aggregations_vs_cpu_replay=replay_err,
                step_gpu_vs_cpu=err)


def spgemm_q8_case(name, plan, b2):
    from repro_torch.kernels.spgemm_pad import (spgemm_hashpad_q8,
                                                spgemm_hashpad_q8_compact_plain,
                                                spgemm_hashpad_q8_plain)
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse import quantize as qz
    from repro_torch.sparse.spgemm.numeric import hashed_slab_q8
    args = (plan.ell_remaining, plan.ell_block_ptr, plan.ell_a_q8,
            plan.ell_a_scale, plan.cell_ptr, plan.cell_lane, plan.cell_bucket,
            plan.cell_q8, plan.slab_scale, plan.c_indptr, plan.out_bucket)
    kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
    c_vals = spgemm_hashpad_q8(*args, **kw)
    again = spgemm_hashpad_q8(*args, **kw)
    plain = spgemm_hashpad_q8_compact_plain(*args, **kw)
    oracle = spgemm_hashpad_q8_plain(
        plan.ell_remaining, plan.ell_block_ptr, plan.ell_a_q8,
        plan.ell_a_scale, hashed_slab_q8(plan), plan.slab_scale,
        **kw)[plan.out_row.long(), plan.out_bucket.long()]
    torch.cuda.synchronize()
    check(c_vals.shape == (plan.nnz_out,) and bool(
        torch.isfinite(c_vals).all()), f"B5 {name}: malformed C values")
    err = float((c_vals - plain).abs().max())
    check(err <= KERNEL_TOL, f"B5 {name}: max|kernel-plain| {err:.3e} > "
                             f"{KERNEL_TOL}")
    err_oracle = float((c_vals - oracle).abs().max())
    check(err_oracle <= KERNEL_TOL, f"B5 {name}: max|kernel-dense oracle| "
                                    f"{err_oracle:.3e} > {KERNEL_TOL}")
    check(torch.equal(again, c_vals), f"B5 {name}: two calls differ")
    del plain, oracle, again
    got = sb.spgemm(plan, backend="cuda_q8")
    check(got.shape == (plan.nnz_out,) and bool(torch.isfinite(got).all()),
          f"spgemm cuda_q8 {name}: malformed result")
    dev_ref = float((got - sb.spgemm(plan, backend="reference")).abs().max())
    bound = qz.spgemm_q8_bound(plan.width, plan.ell_out_block, plan.n_blocks,
                               plan.ell_a_scale, plan.slab_scale)
    check(qz.q8_gate(dev_ref, bound),
          f"spgemm {name}: cuda_q8 vs reference {dev_ref:.3e} over the "
          f"bound {bound:.3e}")
    big = plan.nnz_out > 200_000
    rec = dict(
        shape=f"{name} H={plan.pad_width}", max_abs_err=err,
        dense_oracle_err=err_oracle, run_to_run_equal=True,
        ms=graph_ms(lambda: spgemm_hashpad_q8(*args, **kw)),
        eager_ms=eager_ms(lambda: spgemm_hashpad_q8(*args, **kw)),
        f32_kernel_ms=b2["ms"],
        plain_ms=eager_ms(lambda: spgemm_hashpad_q8_compact_plain(*args,
                                                                  **kw),
                          iters=3 if big else 10),
        library_ms=b2["library_ms"],
        library_note="torch.sparse.mm(A_csr, A_csr) on the f32 operands, "
                     "timed in phase 6 of this run: cuSPARSE SpGEMM, the "
                     "nearest library call (no int8 SpGEMM), eager",
        q8_executor_ms=eager_ms(lambda: sb.spgemm(plan, backend="cuda_q8")),
        f32_executor_ms=eager_ms(lambda: sb.spgemm(plan, backend="cuda")),
        whole_build_ms=whole_build_ms(plan, "cuda_q8"),
        q8_executor_vs_reference=dev_ref, q8_bound=bound,
        **spgemm_bound(plan, plan.ell_a_q8, 1, INT8_OPS_PER_S))
    say(f"B5 {json.dumps(rec)}")
    return rec


def phase_q8_two_hop(dev, params, x_table):
    """The counted int8 path: Â² and a coarsened graph through the
    ``cuda_q8`` SpGEMM executor, then gcn-cora at full width over the Â²
    plan through ``cuda_q8`` aggregation."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks_q8
    from repro_torch.kernels.spgemm_pad import spgemm_hashpad_q8
    from repro_torch.models.gnn import gcn
    from repro_torch.sparse import quantize as qz
    from repro_torch.sparse.graph import (coarsen_graph, graph_coo,
                                          make_graph, sym_norm_weights)
    from repro_torch.sparse.plan import plan_from_graph
    from repro_torch.sparse.spgemm import make_spgemm_plan, two_hop_graph
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, w = sym_norm_weights(s, r, 2708)
    g = make_graph(s2, r2, 2708, edge_weight=w, device=dev)
    clusters = np.random.default_rng(3).integers(0, 128, 2708)
    x = torch.from_numpy(x_table).to(dev)

    spgemm_hashpad_q8.launches = 0
    spmm_dedup_chunks_q8.launches = 0
    t0 = time.perf_counter()
    g2 = two_hop_graph(g, backend="cuda_q8")
    plan2 = plan_from_graph(g2, backends=("cuda_q8",))
    gc = coarsen_graph(g, clusters, 128, backend="cuda_q8")
    y, n_calls, replay_err = replay_aggregates_on_cpu(
        lambda: gcn.forward(params, FULL, x, backend="cuda_q8", plan=plan2))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = {"spgemm_hashpad_q8": spgemm_hashpad_q8.launches,
                "spmm_dedup_chunks_q8": spmm_dedup_chunks_q8.launches}
    check(launches == {"spgemm_hashpad_q8": 3, "spmm_dedup_chunks_q8": 2},
          f"q8 two-hop path launches {launches}, expected 3 "
          "spgemm_hashpad_q8 (two_hop_graph 1 + coarsen_graph 2) and 2 "
          "spmm_dedup_chunks_q8")

    # Â² through cuda_q8: the reference's edges, weights within the bound
    g2_ref = two_hop_graph(g, backend="reference")
    s_q, r_q, w_q = graph_coo(g2)
    s_r, r_r, w_r = graph_coo(g2_ref)
    check(np.array_equal(s_q, s_r) and np.array_equal(r_q, r_r),
          "q8 two-hop: cuda_q8 and reference Â² have different edges")
    err_w = float(np.abs(w_q - w_r).max())
    sp = make_spgemm_plan(r2, s2, 2708, r2, s2, 2708, a_vals=w, b_vals=w,
                          executors=("cuda_q8",), device=dev)
    bound_w = qz.spgemm_q8_bound(sp.width, sp.ell_out_block, sp.n_blocks,
                                 sp.ell_a_scale, sp.slab_scale)
    check(qz.q8_gate(err_w, bound_w), f"q8 two-hop weights vs reference "
                                      f"{err_w:.3e} over {bound_w:.3e}")
    gc_ref = coarsen_graph(g, clusters, 128, backend="reference")
    s_q, r_q, w_c = graph_coo(gc)
    s_r, r_r, w_cr = graph_coo(gc_ref)
    check(np.array_equal(s_q, s_r) and np.array_equal(r_q, r_r),
          "q8 coarsen: cuda_q8 and reference graphs have different edges")
    err_c_ref = float(np.abs(w_c - w_cr).max())

    # the same int8 calls on the CPU (plain versions)
    g_cpu = make_graph(s2, r2, 2708, edge_weight=w, device="cpu")
    g2_cpu = two_hop_graph(g_cpu, backend="cuda_q8")
    _, _, w2_cpu = graph_coo(g2_cpu)
    err_w_cpu = float(np.abs(w_q - w2_cpu).max())
    check(err_w_cpu <= KERNEL_TOL, f"q8 two-hop GPU vs CPU {err_w_cpu:.3e}")
    _, _, wc_cpu = graph_coo(coarsen_graph(g_cpu, clusters, 128,
                                           backend="cuda_q8"))
    err_c_cpu = float(np.abs(w_c - wc_cpu).max())
    check(err_c_cpu <= KERNEL_TOL, f"q8 coarsen GPU vs CPU {err_c_cpu:.3e}")

    # gcn-cora over Â²: aggregations replayed on the CPU, then end to end
    check(tuple(y.shape) == (2709, FULL.n_classes) and bool(
        torch.isfinite(y).all()), "q8 two-hop forward malformed")
    check(n_calls == FULL.n_layers and replay_err <= KERNEL_TOL,
          f"q8 two-hop forward: card vs CPU replay {replay_err:.3e}")
    err_y = float((y - gcn.forward(params, FULL, x, backend="dense",
                                   plan=plan2)).abs().max())
    check(err_y <= qz.Q8_E2E_TOL, f"q8 two-hop forward vs dense {err_y:.3e}")
    cpu_params = {k: {n: t.cpu() for n, t in p.items()}
                  for k, p in params.items()}
    y_cpu = gcn.forward(cpu_params, FULL, torch.from_numpy(x_table),
                        backend="cuda_q8",
                        plan=plan_from_graph(g2_cpu, backends=("cuda_q8",)))
    err_cpu = float((y.cpu() - y_cpu).abs().max())
    check(err_cpu <= qz.Q8_E2E_TOL, f"q8 two-hop forward GPU vs CPU "
                                    f"{err_cpu:.3e}")
    rec = dict(a2_edges=int(g2.edge_valid.sum()),
               coarse_edges=int(gc.edge_valid.sum()), launches=launches,
               a2_weight_err_vs_reference=err_w, a2_q8_bound=bound_w,
               coarsen_err_vs_reference=err_c_ref,
               a2_gpu_vs_cpu=err_w_cpu, coarsen_gpu_vs_cpu=err_c_cpu,
               forward_aggregations_vs_cpu_replay=replay_err,
               forward_q8_vs_dense=err_y, forward_gpu_vs_cpu=err_cpu,
               path_wall_s=path_s)
    say(f"q8 two-hop {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phases 10-12 — embedding_bag and DLRM-RM2 serving, sddmm, flash_attention
# ---------------------------------------------------------------------------

def embedding_bag_case(name, ids, table):
    """B6 against its plain version over ``table`` at global ids ``ids``
    (B, F, M), timed beside ``F.embedding_bag(mode="sum")``."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_plain)
    b, f, m = ids.shape
    d = table.shape[1]
    out = embedding_bag(ids, table)
    plain = embedding_bag_plain(ids, table)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"B6 {name}: non-finite output")
    err = float((out - plain).abs().max())
    del plain
    check(err <= KERNEL_TOL, f"B6 {name}: max|kernel-plain| {err:.3e} > "
                             f"{KERNEL_TOL}")
    check(m > 1 or err == 0, f"B6 {name}: a one-row bag differs from its "
                             f"row by {err:.3e}")
    bags = ids.reshape(b * f, m)
    library = lambda: F.embedding_bag(bags, table, mode="sum")  # noqa: E731
    lib_err = float((library() - out.reshape(b * f, d)).abs().max())
    check(lib_err <= KERNEL_TOL, f"B6 {name}: kernel vs F.embedding_bag "
                                 f"{lib_err:.3e}")
    big = out.numel() > 1 << 26
    graph_kw = dict(calls=5, replays=4) if big else {}
    rec = dict(
        shape=f"{name} B={b} F={f} M={m} D={d}", max_abs_err=err,
        max_row_offset=int(ids.max()) * d,
        ms=graph_ms(lambda: embedding_bag(ids, table), **graph_kw),
        plain_ms=eager_ms(lambda: embedding_bag_plain(ids, table),
                          iters=3 if big else 20),
        library_ms=graph_ms(library, **graph_kw), library_err=lib_err,
        library_note="F.embedding_bag(mode='sum') on the (B*F, M) bags")
    # least bytes: the ids once, each distinct table row they name once,
    # the bags written once.  Least operations: M - 1 adds per element.
    n_rows = torch.unique(ids).numel()
    n_bytes = 4 * (ids.numel() + n_rows * d + out.numel())
    n_flops = b * f * max(m - 1, 0) * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes, distinct_rows=n_rows)
    say(f"B6 {json.dumps(rec)}")
    return rec


def phase_dlrm(dev):
    """dlrm-rm2 at full width with its whole 12.6 GB table on the card: B6
    at the two serving batches and a multi-hot case, then the counted
    serving and retrieval steps against the plain lookup."""
    from repro_torch.configs.dlrm_rm2 import FULL
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.models.recsys import dlrm
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = dlrm.init_params(FULL, gen, device=dev)
    torch.cuda.synchronize()
    table = params["table"]
    check(tuple(table.shape) == (FULL.padded_vocab, FULL.embed_dim)
          and table.numel() > 2 ** 31, f"dlrm table {tuple(table.shape)}")
    say(f"dlrm-rm2 table {tuple(table.shape)}, "
        f"{table.numel() * 4 / 1e9:.2f} GB, drawn on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    offs = torch.from_numpy(FULL.field_offsets).to(dev)

    b6 = []
    for name, batch, multi_hot in B6_CASES:
        _, ids, _ = dlrm_batch(batch, FULL.n_dense, FULL.vocab_sizes,
                               multi_hot=multi_hot, seed=10)
        gids = torch.from_numpy(ids).to(dev) + offs[None, :, None]
        b6.append(embedding_bag_case(name, gids, table))
    top = max(c["max_row_offset"] for c in b6)
    check(top >= 2 ** 31, f"B6: largest row*D {top} < 2**31")
    say(f"B6: largest row*D reached {top} (2**31 = {2 ** 31})")

    steps, launches = [], 0
    for shape_name, n_steps in (("serve_p99", 20), ("serve_bulk", 5),
                                ("retrieval_cand", 20)):
        shape = RECSYS_SHAPES[shape_name]
        dense, ids, _ = dlrm_batch(shape.batch, FULL.n_dense,
                                   FULL.vocab_sizes, seed=20)
        batch = {"dense": torch.from_numpy(dense).to(dev),
                 "sparse_ids": torch.from_numpy(ids).to(dev)}
        if shape.kind == "retrieval":
            batch["candidates"] = torch.randn(
                (shape.n_candidates, FULL.embed_dim), generator=gen,
                device=dev)
        step = build_recsys_step(FULL, shape)
        embedding_bag.launches = 0
        got = step(params, batch)
        torch.cuda.synchronize()
        n = embedding_bag.launches
        check(n == 1, f"dlrm {shape_name}: {n} embedding_bag launches, "
                      "expected 1 per forward")
        launches += n
        if shape.kind == "retrieval":
            want_shape = (shape.batch, shape.n_candidates)
            want = dlrm.retrieval_step(params, FULL, batch["dense"],
                                       batch["sparse_ids"],
                                       batch["candidates"], use_kernel=False)
        else:
            want_shape = (shape.batch,)
            want = dlrm.forward(params, FULL, batch["dense"],
                                batch["sparse_ids"], use_kernel=False)
        check(tuple(got.shape) == want_shape and bool(
            torch.isfinite(got).all()), f"dlrm {shape_name}: output "
                                        f"{tuple(got.shape)} malformed")
        err = float((got - want).abs().max())
        check(err <= SERVE_TOL, f"dlrm {shape_name}: kernel path vs plain "
                                f"lookup {err:.3e}")
        rec = dict(shape=shape_name, batch=shape.batch, launches=n,
                   vs_plain_lookup=err,
                   **trace_steps(lambda: step(params, batch), n_steps,
                                 "embedding_bag", top=5))
        say(f"dlrm step {json.dumps(rec)}")
        steps.append(rec)
    return b6, steps, launches


B7_GROUPED, B7_DIRECT = 0, 2 ** 63 - 1   # thresholds that force a path


def on_b7_path(threshold, fn):
    """``fn()`` with B7's grouping threshold set to ``threshold`` bytes."""
    import importlib
    mod = importlib.import_module("repro_torch.kernels.sddmm.sddmm")
    old, mod.GROUP_ABOVE_X_BYTES = mod.GROUP_ABOVE_X_BYTES, threshold
    try:
        return fn()
    finally:
        mod.GROUP_ABOVE_X_BYTES = old


def sddmm_case(name, src, dst, x, y, library=True):
    """B7 through ``edge_scores`` against its plain version (≤1e-5
    relative and absolute) and against itself run to run (bitwise), timed
    on the path the wrapper takes (``ms``) and on each path forced
    (``grouped_ms``, ``direct_ms``), beside ``torch.sparse.sampled_addmm``
    unless ``library`` is False."""
    import torch.nn.functional as F
    from repro_torch.kernels.sddmm import edge_scores, sddmm, sddmm_plain
    e, d = src.shape[0], x.shape[1]
    got = edge_scores(src, dst, x, y)
    want = sddmm_plain(src, dst, x, y)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (e,) and bool(torch.isfinite(got).all()),
          f"B7 {name}: malformed scores")
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - KERNEL_TOL * want.abs()).max())
    check(excess <= KERNEL_TOL, f"B7 {name}: kernel vs plain {err:.3e} "
                                "beyond 1e-5 + 1e-5*|plain|")
    del want
    check(torch.equal(edge_scores(src, dst, x, y), got),
          f"B7 {name}: scores differ from run to run")
    pad = (-e) % 256
    src_p, dst_p = F.pad(src, (0, pad)), F.pad(dst, (0, pad))
    big = e > 1 << 24
    graph_kw = dict(calls=5, replays=4) if big else {}
    rec = dict(shape=f"{name} E={e} D={d}", max_abs_err=err,
               run_to_run_equal=True,
               ms=graph_ms(lambda: sddmm(src_p, dst_p, x, y), **graph_kw))
    for path, threshold in (("grouped", B7_GROUPED), ("direct", B7_DIRECT)):
        rec[f"{path}_ms"] = on_b7_path(threshold, lambda: graph_ms(
            lambda: sddmm(src_p, dst_p, x, y), **graph_kw))
    if big:        # device ms of each kernel of one call, from a trace
        rec["kernels_ms"] = trace_steps(lambda: sddmm(src_p, dst_p, x, y),
                                        3, "sddmm", top=8)["top_ms_per_step"]
    del src_p, dst_p
    # least bytes: the indices once, each distinct x and y row they name
    # once, the scores once.  Least operations: 2 per element of each pair.
    # The grouped design's floor: each distinct x row once, one y row per
    # edge (no reuse of y in L2), the indices and the scores.
    rows = [int(torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
                .index_fill_(0, i.long(), True).sum())
            for t, i in ((x, src), (y, dst))]
    n_bytes = 4 * (3 * e + d * sum(rows))
    n_flops = 2 * e * d
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOPS_PER_S
    floor_bytes = 4 * (3 * e + d * (rows[0] + e))
    rec.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=n_bytes, bound_flops=n_flops,
               grouped_floor_ms=floor_bytes / HBM_BYTES_PER_S * 1e3,
               grouped_floor_bytes=floor_bytes)
    if not library:
        rec.update(plain_ms=None, library_ms=None)
        say(f"B7 {json.dumps(rec)}")
        return rec
    rec["plain_ms"] = eager_ms(lambda: sddmm_plain(src, dst, x, y),
                               iters=3 if big else 20)
    # torch.sparse.sampled_addmm on the CSR pattern of (src, dst), edges in
    # (src, dst) order; the pattern repeats edges, which CSR may refuse

    def csr_pattern():
        order = torch.argsort(src.long() * y.shape[0] + dst.long())
        crow = torch.zeros(x.shape[0] + 1, dtype=torch.int64,
                           device=x.device)
        crow[1:] = torch.cumsum(
            torch.bincount(src.long(), minlength=x.shape[0]), 0)
        return order, torch.sparse_csr_tensor(
            crow, dst.long()[order], torch.zeros(e, device=x.device),
            (x.shape[0], y.shape[0]))
    order, pattern = csr_pattern()
    # the kernel on the same edges in that (src, dst) order: the caller has
    # grouped them already
    src_s = F.pad(src[order], (0, pad))
    dst_s = F.pad(dst[order], (0, pad))
    rec["src_sorted_ms"] = graph_ms(lambda: sddmm(src_s, dst_s, x, y),
                                    **graph_kw)
    for path, threshold in (("grouped", B7_GROUPED), ("direct", B7_DIRECT)):
        rec[f"src_sorted_{path}_ms"] = on_b7_path(threshold, lambda: graph_ms(
            lambda: sddmm(src_s, dst_s, x, y), **graph_kw))
    del src_s, dst_s
    y_t = y.T
    try:
        lib = torch.sparse.sampled_addmm(pattern, x, y_t, beta=0.0)
    except RuntimeError as exc:          # the library refuses the pattern
        rec.update(library_ms=None, library_note=f"— sampled_addmm: "
                                                 f"{str(exc)[:160]}")
    else:
        lib_err = float((lib.values() - got[order]).abs().max())
        check(lib_err <= EXECUTOR_TOL, f"B7 {name}: kernel vs sampled_addmm "
                                       f"{lib_err:.3e}")
        del lib
        rec.update(library_ms=eager_ms(
            lambda: torch.sparse.sampled_addmm(pattern, x, y_t, beta=0.0),
            iters=3 if big else 20), library_err=lib_err,
            library_note="torch.sparse.sampled_addmm on the CSR pattern of "
                         "(src, dst), eager")
        # the like-for-like yardstick: the kernel takes (src, dst) as they
        # come and returns scores in that order, so the library call pays
        # for its pattern and for the scatter back to the caller's order

        def library_with_pattern():
            order, pattern = csr_pattern()
            vals = torch.sparse.sampled_addmm(pattern, x, y_t,
                                              beta=0.0).values()
            return torch.empty_like(vals).index_copy_(0, order, vals)
        order_err = float((library_with_pattern() - got).abs().max())
        check(order_err <= EXECUTOR_TOL, f"B7 {name}: kernel vs "
                                         f"sampled_addmm in edge order "
                                         f"{order_err:.3e}")
        rec["library_with_pattern_ms"] = eager_ms(library_with_pattern,
                                                  iters=3 if big else 20)
    del pattern, order
    say(f"B7 {json.dumps(rec)}")
    return rec


def phase_sddmm(dev):
    """B7 through ``edge_scores`` at the Cora-scale graph (d = 64), at the
    ogb_products shape (2,449,029 nodes, 61,859,140 edges, d = 100, indices
    and features drawn on the card) and at that shape with skewed sources
    (``src = floor(N·u²)``, ~40K edges on row 0); then the permutation
    check at ogb_products."""
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.sddmm import edge_scores, sddmm
    rng = np.random.default_rng(11)
    s, r, _, _, _ = cora_like(seed=0)
    cora = [torch.from_numpy(a).to(dev) for a in (
        s.astype(np.int32), r.astype(np.int32),
        rng.normal(size=(2708, 64)).astype(np.float32),
        rng.normal(size=(2708, 64)).astype(np.float32))]
    gen = torch.Generator(device=dev).manual_seed(11)
    n, e, d = OGB_PRODUCTS
    products = [torch.randint(0, n, (e,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2)]
    products += [torch.randn((n, d), generator=gen, device=dev)
                 for _ in range(2)]
    u = torch.rand(e, generator=gen, device=dev, dtype=torch.float64)
    skewed = [(n * u * u).floor().clamp_max(n - 1).to(torch.int32),
              products[1], products[2], products[3]]
    del u
    hub = int((skewed[0] == 0).sum())
    sddmm.launches = 0
    edge_scores(*cora)
    edge_scores(*products)
    edge_scores(*skewed)
    torch.cuda.synchronize()
    launches = sddmm.launches
    check(launches == 3, f"B7: {launches} launches on the edge_scores path, "
                         "expected 3")
    recs = [sddmm_case("cora_like", *cora),
            sddmm_case("ogb_products", *products),
            sddmm_case("ogb_products_skewed", *skewed, library=False)]
    recs[2]["hub_edges"] = hub
    del skewed
    # scores of a permuted edge list, permuted back, equal the unpermuted
    perm = torch.randperm(e, generator=gen, device=dev)
    want = edge_scores(*products)
    permuted = edge_scores(products[0][perm], products[1][perm],
                           *products[2:])
    back = torch.empty_like(permuted)
    back[perm] = permuted
    torch.cuda.synchronize()
    check(torch.equal(back, want), "B7 ogb_products: permuted edges give "
                                   "other scores")
    recs[1]["permutation_equal"] = True
    say(f"B7 permutation check at ogb_products: equal; hub row 0 of the "
        f"skewed case holds {hub} edges")
    del perm, want, permuted, back
    recs[1]["path_sweep"] = b7_path_sweep(dev, products[2], products[3], gen)
    return recs, launches


def b7_path_sweep(dev, x_full, y_full, gen):
    """Both B7 paths on uniform random edges at ogb_products' width and
    mean degree (E / N = 25.26), x (and y) from ¼ to 8× the card's L2:
    where grouping by source starts to pay.  The two paths must give the
    same bits."""
    from repro_torch.kernels.sddmm import sddmm
    n_all, e_all, d = OGB_PRODUCTS
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    sweep = []
    for share in (0.25, 0.5, 1, 2, 4, 8):
        n = int(share * l2) // (4 * d)
        e = round(n * e_all / n_all) // 256 * 256
        src, dst = (torch.randint(0, n, (e,), generator=gen, device=dev,
                                  dtype=torch.int32) for _ in range(2))
        x, y = x_full[:n], y_full[:n]
        rec = dict(x_over_l2=share, nx=n, e=e)
        got = {}
        for path, threshold in (("grouped", B7_GROUPED),
                                ("direct", B7_DIRECT)):
            got[path] = on_b7_path(threshold,
                                   lambda: sddmm(src, dst, x, y))
            rec[f"{path}_ms"] = on_b7_path(threshold, lambda: graph_ms(
                lambda: sddmm(src, dst, x, y), calls=10, replays=5))
        check(torch.equal(got["grouped"], got["direct"]),
              f"B7 path sweep at {share}x L2: the paths' scores differ")
        sweep.append(rec)
    say(f"B7 path sweep (L2 {l2} B) {json.dumps(sweep)}")
    return sweep


def flash_bound(dtype, bh: int, s: int, d: int, io=None) -> dict:
    """B8's bound on (BH, S, d) run in ``dtype`` (the kernel's: f32 for a
    mix of input types).  Least bytes: q, k, v read once and o written
    once (the repeated heads, as the kernel takes them), each at its own
    type (``io``: q, k, v and o's dtypes, all ``dtype`` by default).
    Least operations: q.k and p.v over the S(S+1)/2 causal pairs, 2 flops
    a multiply-add, at the tensor cores' peak for the kernel's type: bf16
    and f16 the same, or for f32 the 3xTF32 rate (the TF32 peak over the
    three products each f32 one takes).  Where the wrapper pads d to a
    wider width dp, ``padded_bound_ms`` is the same bound for the work it
    does: q, k, v read at d and written at dp, the kernel's reads and
    write and its operations at dp, and o read and written at d to cut it
    back.  ``executed_flops`` counts what the kernel computes over the
    causal pairs: q.k at dp once a chunk of v's columns (past 256 each
    chunk recomputes it), p.v over every chunk's columns."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        WIDE_CHUNK, padded_head_dim, value_chunks)
    io = io or (dtype,) * 4
    size = [torch.empty((), dtype=t).element_size() for t in io]
    elem = torch.empty((), dtype=dtype).element_size()
    peak = (F32_3XTF32_FLOPS_PER_S if dtype == torch.float32
            else BF16_FLOPS_PER_S)

    def bound(n_bytes, n_flops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")
    n_bytes, n_flops = bh * s * d * sum(size), 2 * bh * d * s * (s + 1)
    bound_ms, bound_by = bound(n_bytes, n_flops)
    dp, chunks = padded_head_dim(d, dtype), value_chunks(d, dtype)
    pv_cols = dp if chunks == 1 else chunks * WIDE_CHUNK[dtype]
    rec = dict(bound_ms=bound_ms, bound_by=bound_by, bound_bytes=n_bytes,
               bound_flops=n_flops,
               executed_flops=bh * s * (s + 1) * (dp * chunks + pv_cols))
    if dp != d:
        pad_bytes = bh * s * elem * (5 * d + 7 * dp)
        rec.update(padded_to=dp, padded_bytes=pad_bytes,
                   padded_bound_ms=bound(pad_bytes,
                                         2 * bh * dp * s * (s + 1))[0])
    return rec


def flash_case(dtype, flat, model="qwen3-0.6b"):
    """B8 at one dtype on the (BH, S, d) layout ``flat`` = (qf, kf, vf),
    ``model``'s attention: held against its f32 plain version on the same
    values (``B8_TOL``: ≤2e-5 f32, ≤2e-2 bf16, ≤5e-3 f16), timed beside
    its plain version and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                     flash_attention)
    qf, kf, vf = flat
    bh, s, d = qf.shape
    out = flash_attention(qf, kf, vf)
    tol = B8_TOL[dtype]
    err = float((out.float() - causal_attention_plain(
        qf.float(), kf.float(), vf.float())).abs().max())
    check(err <= tol, f"B8 {model} {dtype}: kernel vs f32 plain {err:.3e} "
                      f"> {tol}")
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qf[None], kf[None], vf[None], is_causal=True)[0]
    lib_err = float((library().float() - out.float()).abs().max())
    check(lib_err <= (1e-4 if dtype == torch.float32 else 2e-2),
          f"B8 {dtype}: kernel vs scaled_dot_product_attention {lib_err:.3e}")
    rec = dict(shape=f"{model} attention BH={bh} S={s} d={d} "
                     f"{str(dtype).split('.')[-1]}",
               max_abs_err=err, tolerance=tol,
               ms=graph_ms(lambda: flash_attention(qf, kf, vf), calls=5,
                           replays=4),
               plain_ms=eager_ms(lambda: causal_attention_plain(qf, kf, vf),
                                 iters=3),
               library_ms=graph_ms(library, calls=5, replays=4),
               library_err=lib_err,
               library_note="F.scaled_dot_product_attention(is_causal=True)"
                            " on the repeated (1, BH, S, d) heads",
               **flash_bound(dtype, bh, s, d))
    rec.update(tflop_s=rec["bound_flops"] / rec["ms"] / 1e9,
               bound_share=rec["bound_ms"] / rec["ms"])
    return rec


def sass_readings(library: pathlib.Path) -> dict:
    """Per kernel instantiation in ``library``: its ``HGMMA`` and ``HMMA``
    instructions (``cuobjdump -sass``) and its resource usage
    (``cuobjdump --dump-resource-usage``: registers, stack, local memory,
    which holds spills, and static shared memory; the dynamic shared memory
    is set by the launch function)."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, str(library)], capture_output=True,
                              text=True, check=True, timeout=300).stdout

    def readable(mangled):  # _Z18flash_wgmma_kernelI6__halfLi128EEv...
        m = re.match(r"_Z\d+(\w+?_kernel)", mangled)   # → <f16, 128>
        if m is None:
            return mangled
        args = re.findall(r"(13__nv_bfloat16|6__half)|Li(\d+)E", mangled)
        args = [{"13__nv_bfloat16": "bf16", "6__half": "f16"}.get(t, n)
                for t, n in args]
        return f"{m.group(1)}<{', '.join(args)}>" if args else m.group(1)

    out, name = {}, None
    for line in dump("-sass").splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            name = readable(head.group(1))
            out[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                out[name][op] += bool(re.search(rf"\b{op}\.", line))
    for line in dump("--dump-resource-usage").splitlines():
        head = re.search(r"Function (\S+):", line)
        if head:
            name = readable(head.group(1))
        elif name in out:
            out[name].update({k.lower(): int(v) for k, v in re.findall(
                r"(REG|STACK|SHARED|LOCAL):(\d+)", line)})
    return out


def _tf32(x):
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` (to nearest, ties away
    from zero): half of the 13 dropped bits added, then masked off."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(
        torch.float32)


def _mm_3xtf32(a, b):
    """``a @ b`` from the f32 kernel's 3xTF32 terms (hi = tf32(x), lo =
    tf32(x - hi); the cross terms first).  Every operand is exact in TF32,
    so torch's TF32 flag changes only where the sums are taken: on the
    CUDA cores (off) or in the tensor cores (on)."""
    ah, bh = _tf32(a), _tf32(b)
    return (_tf32(a - ah) @ bh + ah @ _tf32(b - bh)) + ah @ bh


def _causal(q, k, v, mm=torch.matmul, exp2=torch.exp2,
            round_p=lambda p: p):
    """Causal attention on (BH, S, d) in q's dtype with the kernels'
    arithmetic route (scores scaled after the product, exponentials in base
    2), the max over the whole row, and P passed through ``round_p`` for
    P·v only (the row sums add P as it was)."""
    s, d = q.shape[1:]
    x = mm(q, k.transpose(1, 2)) * (math.log2(math.e) / math.sqrt(d))
    x.masked_fill_(torch.ones((s, s), dtype=torch.bool, device=q.device)
                   .triu_(1), -1e30)
    p = exp2(x - x.amax(-1, keepdim=True))
    del x
    return mm(round_p(p), v) / p.sum(-1, keepdim=True)


def _bf16_steps(a, ref):
    """|a - ref| in bf16 steps at ref's magnitude (8 significant bits: a
    step is 2^(e - 8) for |ref| in [2^(e-1), 2^e))."""
    _, e = torch.frexp(ref.float())
    return (a.float() - ref.float()).abs() / torch.ldexp(
        torch.ones_like(ref, dtype=torch.float32), e - 8)


def flash_numerics(dtype, flat) -> dict:
    """Where B8's error comes from, on the (BH, S, d) inputs ``flat``.

    bf16: the share of the kernel's outputs within 0, 1 and 2 bf16 steps
    of the f32 plain version rounded once to bf16, and max and mean |error|
    of the kernel against the f32 plain version, of the output's rounding
    alone, and of P's rounding to bf16 before P·v alone (the plain route
    with it against the same route without; also the share of outputs
    whose bf16 value it changes).  f32: the kernel, the plain version and
    emulations of the kernel's 3xTF32 products (sums on the CUDA cores,
    sums in the tensor cores, and with a random relative error of up to
    2^-22 on each exponential, about 2 ulp, as a stand-in for
    ``ex2.approx``) against an f64 plain version: max and mean |error|, the
    max per eighth of the rows (row i sums over i + 1 keys), and
    ``toward_zero``, the mean of (x - f64)·sign(f64) over the mean
    |x - f64| (-1 when every error shrinks the value's magnitude)."""
    from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                     flash_attention)
    got = flash_attention(*flat)
    q, k, v = (t.float() for t in flat)
    if dtype == torch.bfloat16:
        want = causal_attention_plain(q, k, v)
        steps = _bf16_steps(got, want.bfloat16())
        route = _causal(q, k, v)
        p16 = _causal(q, k, v, round_p=lambda p: p.bfloat16().float())
        readings = dict(
            kernel_within_steps_of_rounded_plain={
                n: float((steps <= n).float().mean()) for n in (0, 1, 2)},
            p_rounding_changes_rounded_output=float(
                (p16.bfloat16() != route.bfloat16()).float().mean()))
        for name, x, ref in (("kernel", got.float(), want),
                             ("output_rounding", want.bfloat16().float(),
                              want),
                             ("p_rounding", p16, route)):
            readings.update({f"{name}_max_abs": float((x - ref).abs().max()),
                             f"{name}_mean_abs": float(
                                 (x - ref).abs().mean())})
        return readings
    ref = _causal(q.double(), k.double(), v.double())
    gen = torch.Generator(device=q.device).manual_seed(15)

    def noisy_exp2(x):
        return torch.exp2(x) * (1 + (2 * torch.rand(
            x.shape, generator=gen, device=x.device) - 1) * 2.0 ** -22)

    def tensor_core_sums():
        allow = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return _causal(q, k, v, mm=_mm_3xtf32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
    out = {}
    for name, fn in (
            ("kernel", lambda: got),
            ("plain", lambda: causal_attention_plain(q, k, v)),
            ("emulated_3xtf32", lambda: _causal(q, k, v, mm=_mm_3xtf32)),
            ("emulated_3xtf32_tensor_core_sums", tensor_core_sums),
            ("emulated_3xtf32_ex2_error",
             lambda: _causal(q, k, v, mm=_mm_3xtf32, exp2=noisy_exp2))):
        diff = fn().double() - ref
        mag = diff.abs()
        out[name] = dict(
            max_abs=float(mag.max()), mean_abs=float(mag.mean()),
            toward_zero=float((diff * ref.sign()).mean() / mag.mean()),
            max_abs_by_eighth=[float(e) for e in mag.amax(dim=(0, 2))
                               .view(8, -1).amax(1)])
        del diff, mag
    return out


def flash_sweep(dev) -> list:
    """B8 on seeded (BH, S, d) q, k, v at each head dim of ``FLASH_SWEEP``
    and ``FLASH_WIDE_DIMS`` in f32, bf16 and f16 on the same values, then
    a mix (q f32, k bf16, v f16) and f64 at d = 128, which run as one f32
    launch: one counted launch a case, shaped and finite, against its f32
    plain version (``B8_TOL``; the mix and f64 2e-5), and its time from a
    replayed graph beside its bound (``flash_bound``)."""
    from repro_torch.kernels.flash_attention import (causal_attention_plain,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.flash_attention import \
        kernel_dtype
    bh, s, dims = FLASH_SWEEP
    gen = torch.Generator(device=dev).manual_seed(121)
    cases = []
    for d in dims + FLASH_WIDE_DIMS:
        flat32 = [torch.randn((bh, s, d), generator=gen, device=dev)
                  for _ in range(3)]
        cases += [(str(dtype).split(".")[-1], [t.to(dtype) for t in flat32])
                  for dtype in B8_TOL]
    flat32 = [torch.randn((bh, s, 128), generator=gen, device=dev)
              for _ in range(3)]
    cases += [("mixed f32/bf16/f16", [flat32[0], flat32[1].bfloat16(),
                                      flat32[2].half()]),
              ("float64", [t.double() for t in flat32])]
    recs = []
    for label, (q, k, v) in cases:
        d, dtype = q.shape[-1], kernel_dtype(q, k, v)
        tol = B8_TOL[dtype]
        flash_attention.launches = 0
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        name = f"B8 sweep d={d} {label}"
        check(launches == 1 and out.dtype == q.dtype
              and out.shape == q.shape
              and bool(torch.isfinite(out).all()),
              f"{name}: {launches} launches, malformed output")
        err = float((out.float() - causal_attention_plain(
            q.float(), k.float(), v.float())).abs().max())
        check(err <= tol, f"{name}: kernel vs f32 plain {err:.3e} > {tol}")
        recs.append(dict(d=d, dtype=label, launches=launches,
                         max_abs_err=err, tolerance=tol, ms=graph_ms(
                             lambda: flash_attention(q, k, v), calls=5,
                             replays=4),
                         **flash_bound(dtype, bh, s, d, io=(
                             q.dtype, k.dtype, v.dtype, q.dtype))))
    return recs


def flash_readings(dev) -> list:
    """``FLASH_READINGS`` at full size (BH 16, S 4096): f16 at d = 128 and
    256 and d = 512 in bf16 and f32, each through ``flash_case`` (held
    against its f32 plain version, timed beside it and SDPA in the same
    dtype), with its bound and ``executed_flops``; one counted launch a
    case before ``flash_case`` times it."""
    from repro_torch.kernels.flash_attention import flash_attention
    bh, s, cases = FLASH_READINGS
    gen = torch.Generator(device=dev).manual_seed(122)
    recs = []
    for dtype, d in cases:
        flat = [torch.randn((bh, s, d), generator=gen, device=dev).to(dtype)
                for _ in range(3)]
        flash_attention.launches = 0
        out = flash_attention(*flat)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        check(launches == 1 and out.shape == flat[0].shape
              and bool(torch.isfinite(out).all()),
              f"B8 reading d={d} {dtype}: {launches} launches, malformed")
        del out
        rec = flash_case(dtype, flat, model=f"d={d} reading")
        rec.update(launches=launches,
                   executed_tflop_s=rec["executed_flops"] / rec["ms"] / 1e9)
        recs.append(rec)
        del flat
        torch.cuda.empty_cache()
    return recs


def phase_flash(dev):
    """B8 through ``mha_causal`` at qwen3-0.6b's attention width (16 heads,
    8 kv heads, head_dim 128: repro configs/qwen3_0_6b.py) and the
    train_4k length (S = 4096), batch cut to 1, in f32 and bf16."""
    from repro_torch.kernels.flash_attention import (LIBRARY,
                                                     flash_attention,
                                                     mha_causal)
    b, s, h, kv, hd = QWEN3_ATTENTION
    gen = torch.Generator(device=dev).manual_seed(12)
    q, k, v = (torch.randn((b, s, n, hd), generator=gen, device=dev)
               for n in (h, kv, kv))
    q16, k16, v16 = (t.bfloat16() for t in (q, k, v))
    flash_attention.launches = 0
    out32 = mha_causal(q, k, v)
    out16 = mha_causal(q16, k16, v16)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    check(launches == 2, f"B8: {launches} launches on the mha_causal path, "
                         "expected 2")
    want32 = mha_causal(q, k, v, use_kernel=False)
    want16 = mha_causal(q16.float(), k16.float(), v16.float(),
                        use_kernel=False)
    torch.cuda.synchronize()
    recs = []
    for dtype, out, want, tol, args in (
            (torch.float32, out32, want32, 2e-5, (q, k, v)),
            (torch.bfloat16, out16, want16, 2e-2, (q16, k16, v16))):
        check(out.dtype == dtype and tuple(out.shape) == (b, s, h, hd)
              and bool(torch.isfinite(out).all()), f"B8 {dtype}: malformed")
        err = float((out.float() - want).abs().max())
        check(err <= tol, f"B8 {dtype}: kernel vs f32 plain {err:.3e} > "
                          f"{tol}")
        qt, kt, vt = args
        flat = tuple(t.repeat_interleave(h // t.shape[2], dim=2)
                     .transpose(1, 2).reshape(b * h, s, hd).contiguous()
                     for t in (qt, kt, vt))
        rec = dict(mha_causal_err=err, **flash_case(dtype, flat))
        say(f"B8 {json.dumps(rec)}")
        sdpa_tflop_s = rec["bound_flops"] / rec["library_ms"] / 1e9
        say(f"B8 {dtype}: {rec['tflop_s']} TFLOP/s, "
            f"{100 * rec['bound_share']}% of its {rec['bound_by']} bound; "
            f"SDPA {sdpa_tflop_s} TFLOP/s")
        say(f"B8 {dtype} numerics "
            f"{json.dumps(flash_numerics(dtype, flat))}")
        recs.append(rec)
    sweep = flash_sweep(dev)
    say(f"B8 head-dim sweep BH={FLASH_SWEEP[0]} S={FLASH_SWEEP[1]} "
        f"{json.dumps(sweep)}")
    launches += sum(r["launches"] for r in sweep)
    readings = flash_readings(dev)
    say(f"B8 readings BH={FLASH_READINGS[0]} S={FLASH_READINGS[1]} "
        f"{json.dumps(readings)}")
    launches += sum(r["launches"] for r in readings)
    say(f"B8 SASS and resources {json.dumps(sass_readings(LIBRARY.path))}")
    return recs, launches, sweep, readings


# ---------------------------------------------------------------------------
# phase 13 — GCN training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 50
TWO_HOP_STEPS = 20
CKPT_EVERY = 25
# (run name, backend, steps, two_hop)
TRAIN_RUNS = (("dense", "dense", TRAIN_STEPS, False),
              ("chunked", "chunked", TRAIN_STEPS, False),
              ("cuda", "cuda", TRAIN_STEPS, False),
              ("cuda_q8", "cuda_q8", TRAIN_STEPS, False),
              ("dense_two_hop", "dense", TWO_HOP_STEPS, True),
              ("cuda_two_hop", "cuda", TWO_HOP_STEPS, True))


def is_b1(key: str) -> bool:
    """A profiler key of B1 (``spmm_dedup_chunks_kernel<float, ...>``,
    demangled or not), not of B4 (its ``int8_t`` instantiation)."""
    return "spmm_dedup_chunks_kernel" in key and (
        "<float" in key or "kernelIf" in key)


def is_b4(key: str) -> bool:
    return "spmm_dedup_chunks_kernel" in key and not is_b1(key)


def train_setup(device, backend, two_hop=False):
    """``launch/train``'s gcn-cora setup at full width (seed 0):
    (params, step, batches)."""
    from repro_torch.configs import registry
    from repro_torch.launch.train import _gnn_setup
    return _gnn_setup("gcn-cora", registry.get_config("gcn-cora"), 0,
                      backend=backend, two_hop=two_hop, device=device)


def train_job(device, backend, n_steps, ckpt_dir, two_hop=False):
    """The setup run through ``train.loop.run`` with a checkpoint every
    ``CKPT_EVERY`` steps into ``ckpt_dir``: (state, history)."""
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    params, step, batches = train_setup(device, backend, two_hop)
    state = loop.TrainState(params=params, opt_state=adamw.init_state(params))
    cfg = loop.TrainLoopConfig(n_steps=n_steps, ckpt_every=CKPT_EVERY,
                               ckpt_dir=str(ckpt_dir), log_every=10 ** 9)
    return loop.run(state, step, batches, cfg, log=lambda *_: None)


def first_step_grads(device, backend):
    """The gradients the first training step hands to AdamW."""
    from repro_torch.optim import adamw
    params, step, batches = train_setup(device, backend)
    seen = []
    apply = adamw.apply_updates

    def spy(p, grads, state, cfg):
        seen.append(grads)
        return apply(p, grads, state, cfg)
    adamw.apply_updates = spy
    try:
        step(params, adamw.init_state(params), next(batches))
    finally:
        adamw.apply_updates = apply
    return seen[0]


def max_tree_err(a, b) -> float:
    from repro_torch import tree
    return max(float((x.float().cpu() - y.float().cpu()).abs().max())
               for x, y in zip(tree.leaves(a), tree.leaves(b)))


def loss_err(h1, h2) -> float:
    return max(abs(a - b) for a, b in zip(h1["loss"], h2["loss"]))


def train_step_breakdown(dev, backend, n_steps: int = 20) -> dict:
    """One warm training step as the loop runs it (the step and its loss
    read back), traced: wall, device time and operations, busy share, and
    B1's and B4's device time per step."""
    from repro_torch.optim import adamw
    params, step, batches = train_setup(dev, backend)
    opt, batch = adamw.init_state(params), next(batches)
    rec = trace_steps(lambda: float(step(params, opt, batch)[2]["loss"]),
                      n_steps, "spmm_dedup_chunks",
                      split={"b1": is_b1, "b4": is_b4})
    rec.pop("kernel_ms_per_step")
    keys = rec.pop("op_keys")
    rec["index_add_ops"] = [k for k in keys
                            if "index_add" in k or "indexFunc" in k]
    rec["b1_share"] = rec["b1_ms_per_step"] / rec["device_ms_per_step"]
    return rec


def phase_train(dev):
    """gcn-cora training at full width through ``launch/train``'s setup and
    ``train.loop.run``, counted, against ``dense``, the CPU and itself
    after a resume; the training step's readings; B1 as the backward
    (dX = Aᵀ·dY on the transpose plan) timed at its two widths."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch import tree
    from repro_torch.data.synthetic import cora_like
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.launch.steps import resolve_gnn_plan
    from repro_torch.sparse.graph import make_graph, sym_norm_weights
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for name, backend, n_steps, two_hop in TRAIN_RUNS:
            spmm_dedup_chunks.launches = 0
            spmm_dedup_chunks_q8.launches = 0
            job = functools.partial(train_job, dev, backend, n_steps,
                                    tmp / name, two_hop)
            if backend == "cuda_q8":
                # every int8 aggregation of the run, replayed on the CPU
                # from the card's own inputs
                runs[name], q8_calls, q8_replay = \
                    replay_aggregates_on_cpu(job)
            else:
                runs[name] = job()
            torch.cuda.synchronize()
            launches[name] = {
                "spmm_dedup_chunks": spmm_dedup_chunks.launches,
                "spmm_dedup_chunks_q8": spmm_dedup_chunks_q8.launches}
        # resume the cuda run from its 25-step commit and run to 50
        resume = tmp / "cuda_resume"
        resume.mkdir()
        shutil.copytree(tmp / "cuda" / f"step_{CKPT_EVERY:06d}",
                        resume / f"step_{CKPT_EVERY:06d}")
        spmm_dedup_chunks.launches = 0
        spmm_dedup_chunks_q8.launches = 0
        resumed = train_job(dev, "cuda", TRAIN_STEPS, resume)
        torch.cuda.synchronize()
        launches["cuda_resume"] = {
            "spmm_dedup_chunks": spmm_dedup_chunks.launches,
            "spmm_dedup_chunks_q8": spmm_dedup_chunks_q8.launches}
        on_cpu_run = train_job("cpu", "cuda", TRAIN_STEPS, tmp / "cpu")
        on_cpu_q8 = train_job("cpu", "cuda_q8", TRAIN_STEPS, tmp / "cpu_q8")

    steps = {name: n for name, _, n, _ in TRAIN_RUNS}
    for name, (state, hist) in runs.items():
        n = steps[name]
        check(state.step == n and len(hist["loss"]) == n
              and all(math.isfinite(v) for v in hist["loss"]),
              f"train {name}: {state.step} steps, losses {hist['loss'][:3]}")
        check(hist["loss"][-1] < hist["loss"][0],
              f"train {name}: loss did not fall ({hist['loss'][0]:.4f} → "
              f"{hist['loss'][-1]:.4f})")
        check(hist["retries"] == 0, f"train {name}: retries")
    want = {"dense": (0, 0), "chunked": (0, 0), "dense_two_hop": (0, 0),
            "cuda": (4 * TRAIN_STEPS, 0), "cuda_resume": (4 * 25, 0),
            "cuda_two_hop": (4 * TWO_HOP_STEPS, 0),
            "cuda_q8": (2 * TRAIN_STEPS, 2 * TRAIN_STEPS)}
    for name, (b1, b4) in want.items():
        got = launches[name]
        check((got["spmm_dedup_chunks"], got["spmm_dedup_chunks_q8"])
              == (b1, b4), f"train {name}: launches {got}, expected B1 {b1}"
                           f" and B4 {b4}")
    d_state, d_hist = runs["dense"]
    c_state, c_hist = runs["cuda"]
    errs = dict(
        cuda_vs_dense_loss=loss_err(c_hist, d_hist),
        cuda_vs_dense_params=max_tree_err(c_state.params, d_state.params),
        chunked_vs_dense_loss=loss_err(runs["chunked"][1], d_hist),
        cuda_vs_cpu_loss=loss_err(c_hist, on_cpu_run[1]),
        cuda_vs_cpu_params=max_tree_err(c_state.params,
                                        on_cpu_run[0].params),
        two_hop_cuda_vs_dense_loss=loss_err(runs["cuda_two_hop"][1],
                                            runs["dense_two_hop"][1]),
        q8_first_loss_vs_dense=abs(runs["cuda_q8"][1]["loss"][0]
                                   - d_hist["loss"][0]),
        q8_aggregations_vs_cpu_replay=q8_replay,
        q8_vs_cpu_loss=loss_err(runs["cuda_q8"][1], on_cpu_q8[1]),
        q8_vs_cpu_params=max_tree_err(runs["cuda_q8"][0].params,
                                      on_cpu_q8[0].params))
    for k in ("cuda_vs_dense_loss", "cuda_vs_dense_params",
              "chunked_vs_dense_loss", "cuda_vs_cpu_loss",
              "cuda_vs_cpu_params", "two_hop_cuda_vs_dense_loss"):
        check(errs[k] <= EXECUTOR_TOL, f"train {k} {errs[k]:.3e}")
    check(errs["q8_first_loss_vs_dense"] <= Q8_E2E_TOL,
          f"train cuda_q8 first loss vs dense "
          f"{errs['q8_first_loss_vs_dense']:.3e} > {Q8_E2E_TOL}")
    # int8 on the card against the CPU: each aggregation replayed from the
    # card's inputs (exact up to KERNEL_TOL), and the whole run step by
    # step within Q8_E2E_TOL (the CPU's own h @ W may round an int8 the
    # other way, and the runs then drift apart by ~1e-4 in the loss)
    check(q8_calls == 2 * TRAIN_STEPS and q8_replay <= KERNEL_TOL,
          f"train cuda_q8: {q8_calls} aggregations, card vs CPU replay "
          f"{q8_replay:.3e}")
    check(errs["q8_vs_cpu_loss"] <= Q8_E2E_TOL,
          f"train cuda_q8 card vs CPU loss {errs['q8_vs_cpu_loss']:.3e}")
    g_c, g_d = first_step_grads(dev, "cuda"), first_step_grads(dev, "dense")
    for a, b in zip(tree.leaves(g_c), tree.leaves(g_d)):
        check(bool(torch.allclose(a, b, rtol=1e-3, atol=1e-4)),
              "train: step-1 gradients cuda vs dense beyond rtol 1e-3, "
              f"atol 1e-4 ({float((a - b).abs().max()):.3e})")
    errs["step1_grads_cuda_vs_dense"] = max_tree_err(g_c, g_d)
    r_state, r_hist = resumed
    check(len(r_hist["loss"]) == TRAIN_STEPS - CKPT_EVERY
          and r_hist["loss"] == c_hist["loss"][CKPT_EVERY:]
          and max_tree_err(r_state.params, c_state.params) == 0.0,
          "train: the run resumed at step 25 does not reproduce the cuda "
          f"run bitwise ({r_hist['loss'][-1]!r} vs {c_hist['loss'][-1]!r})")

    readings = {}
    for backend in ("dense", "chunked", "cuda", "cuda_q8"):
        rec = train_step_breakdown(dev, backend)
        readings[backend] = rec
        say(f"train step {backend} {json.dumps(rec)}")
    for backend in ("cuda", "cuda_q8"):
        check(not readings[backend]["index_add_ops"],
              f"train {backend}: index_add in the traced step: "
              f"{readings[backend]['index_add_ops']}")

    # B1 as the backward: dX = Aᵀ·dY on the training plan's transpose
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, w = sym_norm_weights(s, r, 2708)
    plan = resolve_gnn_plan(make_graph(s2, r2, 2708, w, device=dev), "cuda")
    t_plan = dataclasses.replace(
        plan, rows=plan.cols, cols=plan.rows, n_blocks=plan.n_t_blocks,
        ell_u_cols=plan.ell_t_u_cols, ell_remaining=plan.ell_t_remaining,
        ell_block_ptr=plan.ell_t_block_ptr, ell_a=plan.ell_t_a)
    rng = np.random.default_rng(13)
    backward = [spmm_case("cora_full_T (backward dX)", t_plan, d, rng)
                for d in (16, 7)]
    # B1 and B4 forward on the training plans, at both layers' widths
    q8_plan = resolve_gnn_plan(make_graph(s2, r2, 2708, w, device=dev),
                               "cuda_q8")
    forward = [spmm_case("cora_train", plan, d, rng) for d in (16, 7)]
    forward_q8 = [spmm_q8_case("cora_train", q8_plan, d, rng)
                  for d in (16, 7)]
    rec = dict(losses={k: [h["loss"][0], h["loss"][-1]]
                       for k, (_, h) in runs.items()},
               resumed_last_loss=r_hist["loss"][-1], launches=launches,
               errors=errs)
    say(f"train {json.dumps(rec)}")
    total = {k: sum(v[k] for v in launches.values())
             for k in ("spmm_dedup_chunks", "spmm_dedup_chunks_q8")}
    return dict(launches=total, per_run=launches, backward=backward,
                forward=forward, forward_q8=forward_q8, readings=readings)


# ---------------------------------------------------------------------------
# phase 14 — GAT, GIN and SAGE: serving and training
# ---------------------------------------------------------------------------

CONV_STEPS = 30
# (arch, backend, two_hop): GAT through launch/train's setup, GIN through
# build_gnn_step, also over Â²
CONV_RUNS = tuple((arch, backend, two_hop)
                  for arch, two_hop in (("gat", False), ("gin", False),
                                        ("gin", True))
                  for backend in ("dense", "cuda", "cuda_q8"))
# repro configs/shapes.py "molecule": 128 molecules of 30 nodes and 64
# edges, d_feat 64, 4 classes — GINConfig()'s own widths
GIN_MOLECULES = (128, 30, 64)
SAGE_FANOUTS = (15, 10)           # minibatch_lg's, repro configs/shapes.py
CONV_KERNELS = ("spmm_dedup_chunks", "spmm_dedup_chunks_q8",
                "spgemm_hashpad", "spgemm_hashpad_q8")


def conv_kernels():
    from repro_torch.kernels.gustavson_spmm import (spmm_dedup_chunks,
                                                    spmm_dedup_chunks_q8)
    from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                                spgemm_hashpad_q8)
    return (spmm_dedup_chunks, spmm_dedup_chunks_q8, spgemm_hashpad,
            spgemm_hashpad_q8)


def zero_counts(kernels):
    for k in kernels:
        k.launches = 0


def read_counts(kernels) -> dict:
    torch.cuda.synchronize()
    return {k.__name__: k.launches for k in kernels}


def gin_setup(device, backend, two_hop=False):
    """GIN at ``GINConfig()`` (3 layers, 64 wide, 4 classes) on one batch
    of the ``molecule`` shape (``molecule_batch``'s edges, seeded N(0, 1)
    features, seeded graph labels) through ``build_gnn_step`` with AdamW
    at lr 1e-3: (params, step, batches)."""
    import itertools
    from repro_torch.data.synthetic import molecule_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import build_gnn_step
    from repro_torch.models.gnn import gin
    from repro_torch.optim import adamw
    from repro_torch.sparse.graph import make_graph
    dev = resolve_device(device)
    b, n_nodes, n_edges = GIN_MOLECULES
    species, _, snd, rcv, _, _ = molecule_batch(b, n_nodes, n_edges,
                                                seed=0)
    offs = (np.arange(b) * n_nodes)[:, None]
    n = b * n_nodes
    x = np.zeros((n + 1, 64), np.float32)
    x[np.arange(n), species.ravel()] = 1.0
    gid = np.append(np.repeat(np.arange(b), n_nodes), b).astype(np.int32)
    # a graph property GIN's sum readout can count: the quartile of the
    # molecule's mean species
    mean = species.mean(axis=1)
    labels = np.searchsorted(np.quantile(mean, [0.25, 0.5, 0.75]),
                             mean).astype(np.int32)
    g = make_graph((snd + offs).ravel(), (rcv + offs).ravel(), n, device=dev)
    cfg = gin.GINConfig()
    params = gin.init_params(cfg, torch.Generator().manual_seed(0), dev)
    step = build_gnn_step("gin", cfg, adamw.AdamWConfig(lr=1e-3),
                          backend=backend, graph=g, two_hop=two_hop,
                          n_graphs=b)
    batch = {"x": torch.from_numpy(x).to(dev), "senders": g.senders,
             "receivers": g.receivers, "edge_valid": g.edge_valid,
             "graph_ids": torch.from_numpy(gid).to(dev),
             "labels": torch.from_numpy(labels).to(dev)}
    return params, step, itertools.repeat(batch)


def conv_setup(arch, device, backend, two_hop=False):
    if arch == "gin":
        return gin_setup(device, backend, two_hop)
    from repro_torch.configs import registry
    from repro_torch.launch.train import _gnn_setup
    return _gnn_setup("gat-cora", registry.get_config("gat-cora"), 0,
                      backend=backend, device=device)


def conv_job(arch, device, backend, two_hop, n_steps, ckpt_dir, seen=None):
    """``conv_setup`` run through ``train.loop.run`` with a commit every
    ``CKPT_EVERY`` steps into ``ckpt_dir``: (state, history).  ``seen``,
    a list, receives (parameters, gradient norm) of each step: the
    parameters it starts from and the norm of its gradient there."""
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    params, step, batches = conv_setup(arch, device, backend, two_hop)
    if seen is not None:
        inner = step

        def step(p, opt, batch):
            out = inner(p, opt, batch)
            seen.append((p, float(out[2]["grad_norm"])))
            return out
    state = loop.TrainState(params=params, opt_state=adamw.init_state(params))
    cfg = loop.TrainLoopConfig(n_steps=n_steps, ckpt_every=CKPT_EVERY,
                               ckpt_dir=str(ckpt_dir), log_every=10 ** 9)
    return loop.run(state, step, batches, cfg, log=lambda *_: None)


def conv_losses_at(arch, device, backend, two_hop, seen) -> list:
    """(loss, gradient norm) of each step of ``seen`` (a run's parameters
    step by step, ``conv_job``) recomputed on ``backend`` on ``device``:
    the run held to another executor or device at the very same points of
    its trajectory, in its forward and in its gradient."""
    from repro_torch.optim import adamw
    _, step, batches = conv_setup(arch, device, backend, two_hop)
    batch = next(batches)
    out = []
    for p, _ in seen:
        p = tree_to(p, device)
        m = step(p, adamw.init_state(p), batch)[2]
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def same_run(a, b) -> bool:
    """Two (state, history) pairs bitwise equal: every loss, every
    parameter leaf and the optimizer's moments."""
    from repro_torch import tree
    (sa, ha), (sb_, hb) = a, b
    return ha["loss"] == hb["loss"][-len(ha["loss"]):] and all(
        torch.equal(x, y) for x, y in zip(
            tree.leaves((sa.params, sa.opt_state)),
            tree.leaves((sb_.params, sb_.opt_state))))


def conv_launches_per_step(arch, backend):
    """(B1, B4) launches a training step: every aggregation forward, and
    B1 on the transpose layout for each aggregation whose input needs a
    gradient (GIN's first layer aggregates the raw features: none)."""
    from repro_torch.configs import registry
    from repro_torch.models.gnn import gin
    cfg = (registry.get_config("gat-cora") if arch == "gat"
           else gin.GINConfig())
    fwd = aggregations_per_step(arch, cfg)
    bwd = fwd if arch == "gat" else fwd - 1
    if backend == "cuda":
        return fwd + bwd, 0
    if backend == "cuda_q8":
        return bwd, fwd
    return 0, 0


def phase_conv_train(dev):
    """GAT (gat-cora, launch/train's setup) and GIN (the molecule batch,
    build_gnn_step, also over Â²) on dense, cuda and cuda_q8: each run
    counted; bitwise against a second run and a run resumed from its
    25-step commit; each step's loss against the same parameters' loss on
    ``dense`` and on the CPU, in the loss and the gradient's norm; the
    whole run against the same run on
    ``dense`` and on the CPU (held for GAT, a reading for GIN, whose
    trajectory amplifies a rounding difference past 1e-4 within a few tens
    of steps on the CPU alone)."""
    import shutil
    import tempfile
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    kernels = conv_kernels()
    runs, launches, errs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for arch, backend, two_hop in CONV_RUNS:
            name = f"{arch}{'_two_hop' if two_hop else ''}_{backend}"
            job = functools.partial(conv_job, arch, dev, backend, two_hop,
                                    CONV_STEPS)
            seen = []
            zero_counts(kernels)
            if backend == "cuda_q8":
                # every int8 aggregation replayed on the CPU from the
                # card's own inputs
                run, n_calls, replay = replay_aggregates_on_cpu(
                    functools.partial(job, tmp / name, seen))
                errs[f"{name}_aggregations_vs_cpu_replay"] = replay
                want_calls = CONV_STEPS * (9 if arch == "gat" else 3)
                check(n_calls == want_calls and replay <= KERNEL_TOL,
                      f"train {name}: {n_calls} aggregations (want "
                      f"{want_calls}), card vs CPU replay {replay:.3e}")
            else:
                run = job(tmp / name, seen)
            launches[name] = read_counts(kernels)
            runs[name] = run
            state, hist = run
            check(state.step == CONV_STEPS
                  and all(math.isfinite(v) for v in hist["loss"])
                  and hist["loss"][-1] < hist["loss"][0]
                  and hist["retries"] == 0,
                  f"train {name}: {state.step} steps, losses "
                  f"{hist['loss'][0]} → {hist['loss'][-1]}")
            b1, b4 = conv_launches_per_step(arch, backend)
            want = {"spmm_dedup_chunks": b1 * CONV_STEPS,
                    "spmm_dedup_chunks_q8": b4 * CONV_STEPS,
                    # Â² is built once, in f32 by B2, under both kernel
                    # executors
                    "spgemm_hashpad": int(two_hop and backend != "dense"),
                    "spgemm_hashpad_q8": 0}
            check(launches[name] == want,
                  f"train {name}: launches {launches[name]}, expected {want}")
            check(same_run(run, job(tmp / f"{name}_again")),
                  f"train {name}: two runs on the card differ")
            resume = tmp / f"{name}_resume"
            resume.mkdir()
            shutil.copytree(tmp / name / f"step_{CKPT_EVERY:06d}",
                            resume / f"step_{CKPT_EVERY:06d}")
            resumed = job(resume)
            check(len(resumed[1]["loss"]) == CONV_STEPS - CKPT_EVERY
                  and same_run(resumed, run),
                  f"train {name}: the run resumed at step {CKPT_EVERY} "
                  "does not reproduce the unbroken run bitwise")
            # the same points of the trajectory on dense and on the CPU
            tol = Q8_E2E_TOL if backend == "cuda_q8" else EXECUTOR_TOL
            for other, device in (("dense", dev), (backend, "cpu")):
                key = f"{name}_vs_{'cpu' if device == 'cpu' else other}"
                if key.endswith("_vs_dense") and backend == "dense":
                    continue
                at = conv_losses_at(arch, device, other, two_hop, seen)
                q8_vs_dense = backend == "cuda_q8" and other == "dense"
                # int8 over Â² against dense: relative to the loss past 1,
                # as int8 serving is held (Â²'s two-path counts take GIN's
                # loss to 16)
                scaled = q8_vs_dense and two_hop
                errs[key + "_same_params"] = max(
                    abs(a[0] - b) / (max(1.0, abs(b)) if scaled else 1.0)
                    for a, b in zip(at, hist["loss"]))
                # the gradient's norm relative to the run's own, or to its
                # first step's where the run has converged below it (GAT's
                # falls 100-fold: f32 sums differ by 2e-4 of such a norm
                # between the card and the CPU); held where both sides run
                # the same forward, a reading for int8 against dense (int8
                # moves ReLU boundaries: GIN over Â² reads ~36% on the CPU
                # alone)
                g0 = abs(seen[0][1])
                errs[key + "_same_params_grad_norm"] = max(
                    abs(a[1] - g) / max(abs(g), g0, 1e-30)
                    for a, (_, g) in zip(at, seen))
                check(errs[key + "_same_params"] <= tol and (
                    q8_vs_dense
                    or errs[key + "_same_params_grad_norm"] <= tol),
                      f"train {key}: a step from the same parameters: loss "
                      f"{errs[key + '_same_params']:.3e}, gradient norm "
                      f"(relative) "
                      f"{errs[key + '_same_params_grad_norm']:.3e}; bar "
                      f"{tol}")
            cpu = conv_job(arch, "cpu", backend, two_hop, CONV_STEPS,
                           tmp / f"{name}_cpu")
            errs[f"{name}_vs_cpu_loss"] = loss_err(hist, cpu[1])
            errs[f"{name}_vs_cpu_params"] = max_tree_err(state.params,
                                                         cpu[0].params)
            if arch == "gat":
                check(errs[f"{name}_vs_cpu_loss"] <= tol,
                      f"train {name} card vs CPU loss "
                      f"{errs[f'{name}_vs_cpu_loss']:.3e} > {tol}")
            shutil.rmtree(resume)
    for arch, two_hop in (("gat", False), ("gin", False), ("gin", True)):
        pre = f"{arch}{'_two_hop' if two_hop else ''}_"
        dense = runs[pre + "dense"][1]
        errs[pre + "cuda_vs_dense_loss"] = loss_err(runs[pre + "cuda"][1],
                                                    dense)
        errs[pre + "cuda_vs_dense_params"] = max_tree_err(
            runs[pre + "cuda"][0].params, runs[pre + "dense"][0].params)
        errs[pre + "q8_first_loss_vs_dense"] = abs(
            runs[pre + "cuda_q8"][1]["loss"][0] - dense["loss"][0])
        if arch == "gat":
            check(errs[pre + "cuda_vs_dense_loss"] <= EXECUTOR_TOL,
                  f"train {pre}cuda vs dense "
                  f"{errs[pre + 'cuda_vs_dense_loss']:.3e}")
            check(errs[pre + "q8_first_loss_vs_dense"] <= Q8_E2E_TOL,
                  f"train {pre}cuda_q8 first loss vs dense "
                  f"{errs[pre + 'q8_first_loss_vs_dense']:.3e}")
    readings = {}
    for arch in ("gat", "gin"):
        for backend in ("dense", "cuda", "cuda_q8"):
            readings[f"{arch}_{backend}"] = conv_step_breakdown(
                dev, arch, backend)
    rec = dict(losses={k: [h["loss"][0], h["loss"][-1]]
                       for k, (_, h) in runs.items()},
               launches=launches, errors=errs)
    say(f"conv train {json.dumps(rec)}")
    for k, r in readings.items():
        say(f"conv train step {k} {json.dumps(r)}")
    total = {k: sum(v[k] for v in launches.values()) for k in CONV_KERNELS}
    return dict(launches=total, per_run=launches, readings=readings,
                errors=errs)


def conv_step_breakdown(dev, arch, backend, n_steps: int = 20) -> dict:
    """One warm training step of ``arch`` as the loop runs it, traced as
    ``train_step_breakdown`` traces gcn's."""
    from repro_torch.optim import adamw
    params, step, batches = conv_setup(arch, dev, backend)
    opt, batch = adamw.init_state(params), next(batches)
    rec = trace_steps(lambda: float(step(params, opt, batch)[2]["loss"]),
                      n_steps, "spmm_dedup_chunks",
                      split={"b1": is_b1, "b4": is_b4})
    rec.pop("kernel_ms_per_step")
    rec.pop("op_keys")
    return rec


def sage_world(dev):
    """SAGE at ``SAGEConfig()`` (602 → 64 → 41) on a graph of
    ``minibatch_lg``'s size drawn as phase 2 draws it: (params, indptr,
    indices, store), the CSR copied once to the host for the host sampler
    and the offline replay."""
    from repro_torch.models.gnn import sage
    from repro_torch.serve import FeatureStore
    gen = torch.Generator(device=dev).manual_seed(14)
    indptr, indices = minibatch_lg_graph(dev, gen)
    indptr, indices = indptr.cpu().numpy(), indices.cpu().numpy()
    n = indptr.shape[0] - 1
    x = np.random.default_rng(15).standard_normal(
        (n, 602), dtype=np.float32)
    params = sage.init_params(sage.SAGEConfig(),
                              torch.Generator().manual_seed(0), dev)
    return params, indptr, indices, FeatureStore.build(n, x, device=dev)


def phase_conv_serve(dev, indptr, indices, cora_store, seeds):
    """GAT (gat-cora) and GIN (``GINConfig()`` on seeded N(0, 1) features)
    on the Cora-scale graph, and SAGE on minibatch_lg's graph at fanouts
    (15, 10): each served with the host sampler, the device sampler and
    int8, counted and held to offline replay, as phases 4, 5 and 8."""
    from repro_torch.configs.gat_cora import FULL as GAT
    from repro_torch.models.gnn import gat, gin
    from repro_torch.serve import FeatureStore
    # GIN's 64 dense input features
    x64 = np.random.default_rng(16).standard_normal((2708, 64),
                                                    dtype=np.float32)
    # GIN's sum aggregations take its outputs near 15: its int8 bar is
    # relative to them past 1 (``q8_tol``)
    worlds = [
        ("gat", GAT, gat.init_params(GAT, torch.Generator().manual_seed(0),
                                     dev), indptr, indices, cora_store,
         False),
        ("gin", gin.GINConfig(), gin.init_params(
            gin.GINConfig(), torch.Generator().manual_seed(0), dev), indptr,
         indices, FeatureStore.build(2708, x64, device=dev), True)]
    serves = []
    for arch, cfg, params, ip, ix, store, relative in worlds:
        serves += [phase_serve(dev, mode, params, ip, ix, store, seeds,
                               backend=backend, arch=arch, cfg=cfg,
                               q8_relative=relative)
                   for mode, backend in (("host", "cuda"),
                                         ("device", "cuda"),
                                         ("device", "cuda_q8"))]
    del worlds
    from repro_torch.models.gnn import sage
    params, ip, ix, store = sage_world(dev)
    n = ip.shape[0] - 1
    sage_seeds = np.random.default_rng(17).integers(0, n, len(seeds))
    serves += [phase_serve(dev, mode, params, ip, ix, store, sage_seeds,
                           backend=backend, arch="sage",
                           cfg=sage.SAGEConfig(), fanouts=SAGE_FANOUTS)
               for mode, backend in (("host", "cuda"), ("device", "cuda"),
                                     ("device", "cuda_q8"))]
    return serves


def tile_scatter_costs(dev) -> dict:
    """The traced-value tile scatter at gat-cora's plan (the Cora-scale
    graph as it is: 10,556 edges, 99 repeated pairs): the plan's layered
    scatter (``forward_tiles``) against one ``index_put_(accumulate=True)``
    of the same values and one ``index_add_`` (atomics), ms a call issued
    eagerly, the layered one equal to the CPU's sequential scatter."""
    from repro_torch.data.synthetic import cora_like
    from repro_torch.sparse.plan import forward_tiles, make_plan
    s, r, _, _, _ = cora_like(seed=0)
    plan = make_plan(s, r, 2709, backends=("cuda",), device=dev)
    cpu = make_plan(s, r, 2709, backends=("cuda",), device="cpu")
    v = torch.from_numpy(np.random.default_rng(18).normal(
        size=s.shape[0]).astype(np.float32))
    vd = v.to(dev)
    n = plan.ell_a.numel()
    slots = plan.ell_slots.clamp(0, n)

    def put():
        flat = vd.new_zeros(n + 1)
        flat.index_put_((slots,), vd, accumulate=True)
        return flat[:n].reshape(plan.ell_a.shape)
    want = forward_tiles(cpu, v)
    layered = forward_tiles(plan, vd)
    check(torch.equal(layered.cpu(), want),
          "tile scatter: the layered scatter differs from the CPU's")
    rec = dict(layers=len(plan.ell_dup_bounds) + 1,
               layered_ms=eager_ms(lambda: forward_tiles(plan, vd)),
               index_put_ms=eager_ms(put),
               index_put_vs_cpu=float((put().cpu() - want).abs().max()),
               index_add_ms=eager_ms(lambda: vd.new_zeros(n + 1).index_add_(
                   0, slots, vd)))
    say(f"tile scatter {json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# phase 15 — DLRM training
# ---------------------------------------------------------------------------

DLRM_TRAIN_STEPS = 20
DLRM_CKPT_EVERY = 10
# each field's vocabulary capped: the whole 12.58 GB table with its
# gradient, AdamW's moments and the functional update's temporaries passes
# the card's 80 GB
DLRM_VOCAB_CAP = 1_000_000
DLRM_CPU_STEPS, DLRM_CPU_BATCH = 5, 4096


def dlrm_train_cfg():
    import dataclasses
    from repro_torch.configs.dlrm_rm2 import FULL
    return dataclasses.replace(FULL, vocab_sizes=tuple(
        min(v, DLRM_VOCAB_CAP) for v in FULL.vocab_sizes))


def dlrm_train_job(params, device, batch, n_steps, ckpt_dir, ckpt_every):
    """dlrm-rm2 (capped vocabularies) through ``build_recsys_step("train")``
    and ``train.loop.run``, AdamW at lr 1e-3, step i on ``dlrm_batch(batch,
    seed=i)`` (a run resumed from a commit at step k starts at seed k):
    (state, history)."""
    from repro_torch.checkpoint import store
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    cfg = dlrm_train_cfg()
    step = build_recsys_step(cfg, RECSYS_SHAPES["train_batch"],
                             adamw.AdamWConfig(lr=1e-3))
    state = loop.TrainState(params=params, opt_state=adamw.init_state(params))

    def batches():
        i = store.latest_step(ckpt_dir) or 0
        while True:
            d, ids, y = dlrm_batch(batch, cfg.n_dense, cfg.vocab_sizes,
                                   seed=i)
            yield {"dense": torch.from_numpy(d).to(device),
                   "sparse_ids": torch.from_numpy(ids).to(device),
                   "labels": torch.from_numpy(y).to(device)}
            i += 1
    return loop.run(state, step, batches(), loop.TrainLoopConfig(
        n_steps=n_steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
        log_every=10 ** 9, keep_ckpts=2), log=lambda *_: None)


def phase_dlrm_train(dev):
    """dlrm-rm2's widths, each vocabulary capped at ``DLRM_VOCAB_CAP``, at
    ``RECSYS_SHAPES["train_batch"]``: 20 steps counted (one B6 a step), a
    second run and a run resumed from the 10-step commit bitwise equal,
    peak memory, one warm step traced; the first 5 steps at batch 4,096
    against the same steps on the CPU."""
    import shutil
    import tempfile
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.models.recsys import dlrm
    cfg = dlrm_train_cfg()
    batch = RECSYS_SHAPES["train_batch"].batch

    def fresh():
        return dlrm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), dev)
    from repro_torch.configs.dlrm_rm2 import FULL
    capped = sum(v > DLRM_VOCAB_CAP for v in FULL.vocab_sizes)
    rec = dict(batch=batch, vocab_rows=cfg.total_vocab,
               table_bytes=cfg.padded_vocab * cfg.embed_dim * 4,
               reduced=f"each field's vocabulary capped at "
                       f"{DLRM_VOCAB_CAP:,} rows ({capped} of "
                       f"{len(FULL.vocab_sizes)} fields): the whole table "
                       "with its gradient, AdamW's moments and the "
                       "functional update's temporaries passes 80 GB")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        embedding_bag.launches = 0
        t0 = time.perf_counter()
        run = dlrm_train_job(fresh(), dev, batch, DLRM_TRAIN_STEPS,
                             tmp / "run", DLRM_CKPT_EVERY)
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t0
        rec["launches"] = embedding_bag.launches
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        state, hist = run
        check(rec["launches"] == DLRM_TRAIN_STEPS,
              f"dlrm train: {rec['launches']} embedding_bag launches for "
              f"{DLRM_TRAIN_STEPS} steps")
        check(all(math.isfinite(v) for v in hist["loss"])
              and hist["retries"] == 0,
              f"dlrm train: losses {hist['loss']}")
        rec["losses"] = [hist["loss"][0], hist["loss"][-1]]
        rec["step_wall_ms_loop"] = statistics.median(hist["step_s"]) * 1e3
        again = dlrm_train_job(fresh(), dev, batch, DLRM_TRAIN_STEPS,
                               tmp / "again", DLRM_TRAIN_STEPS)
        check(same_run(run, again), "dlrm train: two runs on the card "
                                    "differ")
        del again
        shutil.rmtree(tmp / "again")
        resume = tmp / "resume"
        resume.mkdir()
        shutil.copytree(tmp / "run" / f"step_{DLRM_CKPT_EVERY:06d}",
                        resume / f"step_{DLRM_CKPT_EVERY:06d}")
        shutil.rmtree(tmp / "run")
        resumed = dlrm_train_job(fresh(), dev, batch, DLRM_TRAIN_STEPS,
                                 resume, DLRM_TRAIN_STEPS)
        check(len(resumed[1]["loss"]) == DLRM_TRAIN_STEPS - DLRM_CKPT_EVERY
              and same_run(resumed, run),
              f"dlrm train: the run resumed at step {DLRM_CKPT_EVERY} does "
              "not reproduce the unbroken run bitwise")
        del resumed, run, state
    torch.cuda.empty_cache()
    rec.update(dlrm_step_breakdown(dev, fresh(), batch))
    # the first steps at a batch the CPU takes in seconds, card vs CPU
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        params = fresh()
        cpu_params = tree_to(params, "cpu")
        card = dlrm_train_job(params, dev, DLRM_CPU_BATCH, DLRM_CPU_STEPS,
                              tmp / "card", 10 ** 9)[1]
        del params
        on_cpu = dlrm_train_job(cpu_params, torch.device("cpu"),
                                DLRM_CPU_BATCH, DLRM_CPU_STEPS, tmp / "cpu",
                                10 ** 9)[1]
    rec["card_vs_cpu_loss"] = loss_err(card, on_cpu)
    check(rec["card_vs_cpu_loss"] <= EXECUTOR_TOL,
          f"dlrm train: card vs CPU loss {rec['card_vs_cpu_loss']:.3e}")
    say(f"dlrm train {json.dumps(rec)}")
    return rec


def dlrm_step_breakdown(dev, params, batch, n_steps: int = 5) -> dict:
    """One warm training step at ``batch`` (the step and its loss read
    back), traced: wall, device time and operations, B6's time."""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.launch.steps import build_recsys_step
    from repro_torch.optim import adamw
    cfg = dlrm_train_cfg()
    step = build_recsys_step(cfg, RECSYS_SHAPES["train_batch"],
                             adamw.AdamWConfig(lr=1e-3))
    opt = adamw.init_state(params)
    d, ids, y = dlrm_batch(batch, cfg.n_dense, cfg.vocab_sizes, seed=0)
    b = {"dense": torch.from_numpy(d).to(dev),
         "sparse_ids": torch.from_numpy(ids).to(dev),
         "labels": torch.from_numpy(y).to(dev)}
    rec = trace_steps(lambda: float(step(params, opt, b)[2]["loss"]),
                      n_steps, "embedding_bag", top=5)
    rec["b6_ms_per_step"] = rec.pop("kernel_ms_per_step")
    return rec


# ---------------------------------------------------------------------------
# phase 16 — SchNet and DimeNet: serving and training
# ---------------------------------------------------------------------------

GEOM_STEPS = 8
GEOM_CKPT_EVERY = 4
# the steps (0-based) of each run recomputed on the CPU from the card's
# parameters: the last (a DimeNet step at FULL takes ~7 s on 8 cores)
GEOM_CPU_AT = (GEOM_STEPS - 1,)
# AdamW's rate: DimeNet's random-weight energies (~6,000 a molecule
# against N(0, 1) targets) overshoot at 1e-3 within 8 steps
GEOM_LR = {"schnet": 1e-3, "dimenet": 1e-4}
# (arch, backend, two_hop): each through build_gnn_step on one batch of
# the molecule shape; DimeNet also with its Â² output stage
GEOM_RUNS = tuple((arch, backend, False) for arch in GEOM_ARCHS
                  for backend in ("dense", "cuda", "cuda_q8")) + tuple(
    ("dimenet", backend, True) for backend in ("cuda", "cuda_q8"))


def geom_world(dev):
    """The Cora-scale graph's CSR with species and positions drawn as
    ``gnn_serve.build_world`` draws them (after 32 feature columns, from
    ``default_rng(1)``), and schnet's and dimenet's FULL parameters (seed
    0): (indptr, indices, store, {arch: (cfg, params)})."""
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import cora_like
    from repro_torch.launch.gnn_serve import MODELS, geometry
    from repro_torch.serve import FeatureStore
    from repro_torch.sparse.graph import coo_to_csr
    s, r, _, _, _ = cora_like(seed=0)
    indptr, indices, _ = coo_to_csr(s, r, 2708)
    rng = np.random.default_rng(1)
    rng.normal(size=(2708, 32))
    species, pos = geometry(rng, 2708)
    store = FeatureStore.build(2708, device=dev, species=species, pos=pos)
    models = {}
    for arch in GEOM_ARCHS:
        cfg = registry.get_config(arch)
        models[arch] = (cfg, MODELS[arch][0].init_params(
            cfg, torch.Generator().manual_seed(0), dev))
    return indptr, indices, store, models


def phase_geom_serve(dev, seeds):
    """schnet and dimenet at FULL served on the Cora-scale graph as phases
    4, 5 and 8 serve gcn: ``cuda`` and ``cuda_q8`` (both accumulate in f32
    on the chunked schedule: no B1 or B4 launch), each with the host and
    the device sampler (one ``forest_sample`` a step), held to offline
    replay ≤1e-5 with no rebuild, each warm bucket-16 step traced."""
    indptr, indices, store, models = geom_world(dev)
    return [phase_serve(dev, mode, params, indptr, indices, store, seeds,
                        backend=backend, arch=arch, cfg=cfg)
            for arch, (cfg, params) in models.items()
            for backend in ("cuda", "cuda_q8")
            for mode in ("host", "device")]


def geom_setup(arch, device, backend, two_hop=False):
    """schnet or dimenet at FULL on one batch of the ``molecule`` shape
    (``molecule_batch(128, 30, 64, seed=0)``: 3,840 atoms and 8,192
    edges, flattened with a ghost row; dimenet's 65,536 triplet slots)
    through ``build_gnn_step`` with AdamW at ``GEOM_LR``: the edge plan
    from the plan cache, the triplet plan built once: (params, step,
    batches)."""
    import itertools
    from repro_torch.configs import registry
    from repro_torch.data.synthetic import molecule_batch
    from repro_torch.device import resolve_device
    from repro_torch.launch.gnn_serve import MODELS
    from repro_torch.launch.steps import build_gnn_step
    from repro_torch.optim import adamw
    from repro_torch.sparse.graph import make_graph
    from repro_torch.models.gnn.dimenet import build_triplet_plan
    from repro_torch.sparse.triplets import build_triplets
    dev = resolve_device(device)
    cfg = registry.get_config(arch)
    b, n_nodes, n_edges = GIN_MOLECULES
    species, pos, snd, rcv, _, targets = molecule_batch(b, n_nodes, n_edges,
                                                        seed=0)
    offs = (np.arange(b) * n_nodes)[:, None]
    n = b * n_nodes
    g = make_graph((snd + offs).ravel(), (rcv + offs).ravel(), n,
                   device=dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    batch = {"species": t(np.append(species.ravel(), 0).astype(np.int64)),
             "pos": t(np.vstack([pos.reshape(-1, 3),
                                 np.zeros((1, 3), np.float32)])),
             "senders": g.senders, "receivers": g.receivers,
             "edge_valid": g.edge_valid,
             "graph_ids": t(np.append(np.repeat(np.arange(b), n_nodes), b)),
             "targets": t(targets)}
    pt = None
    if arch == "dimenet":
        t_in, t_out, t_valid = build_triplets(
            g.senders.cpu().numpy(), g.receivers.cpu().numpy(),
            cfg.max_triplets_per_edge)
        batch.update(t_in=t(t_in), t_out=t(t_out), t_valid=t(t_valid))
        pt = build_triplet_plan(batch["t_in"], batch["t_out"],
                                batch["t_valid"], g.senders.shape[0])
    params = MODELS[arch][0].init_params(
        cfg, torch.Generator().manual_seed(0), dev)
    step = build_gnn_step(arch, cfg, adamw.AdamWConfig(lr=GEOM_LR[arch]),
                          backend=backend, graph=g, two_hop=two_hop,
                          n_graphs=b, triplet_plan=pt)
    return params, step, itertools.repeat(batch)


def geom_job(arch, device, backend, two_hop, ckpt_dir, seen=None):
    """``geom_setup`` run ``GEOM_STEPS`` steps through ``train.loop.run``
    with a commit every ``GEOM_CKPT_EVERY`` steps; ``seen`` as in
    ``conv_job``."""
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    params, step, batches = geom_setup(arch, device, backend, two_hop)
    if seen is not None:
        inner = step

        def step(p, opt, batch):
            out = inner(p, opt, batch)
            seen.append((p, float(out[2]["grad_norm"])))
            return out
    state = loop.TrainState(params=params, opt_state=adamw.init_state(params))
    cfg = loop.TrainLoopConfig(n_steps=GEOM_STEPS, ckpt_every=GEOM_CKPT_EVERY,
                               ckpt_dir=str(ckpt_dir), log_every=10 ** 9)
    return loop.run(state, step, batches, cfg, log=lambda *_: None)


def geom_losses_at(arch, device, backend, two_hop, seen) -> list:
    """(loss, gradient norm) of the steps of ``seen`` recomputed on
    ``backend`` on ``device``, as ``conv_losses_at``."""
    from repro_torch.optim import adamw
    _, step, batches = geom_setup(arch, device, backend, two_hop)
    batch = next(batches)
    out = []
    for p, _ in seen:
        p = tree_to(p, device)
        m = step(p, adamw.init_state(p), batch)[2]
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def geom_launches(backend, two_hop) -> dict:
    """Kernel launches of a whole run: none one-hop (every aggregation is
    an accumulate on the chunked schedule); over Â² one B2 for the build
    (f32 under ``cuda`` and ``cuda_q8``), then a step's one aggregation:
    B1 forward and B1 on the transpose as its backward under ``cuda``, B4
    forward and the f32 B1 backward under ``cuda_q8``."""
    b1 = b4 = 0
    if two_hop:
        b1 = (2 if backend == "cuda" else 1) * GEOM_STEPS
        b4 = GEOM_STEPS if backend == "cuda_q8" else 0
    return {"spmm_dedup_chunks": b1, "spmm_dedup_chunks_q8": b4,
            "spgemm_hashpad": int(two_hop), "spgemm_hashpad_q8": 0}


def geom_step_breakdown(dev, arch, backend, two_hop, n_steps=6) -> dict:
    """One warm training step of ``arch`` as the loop runs it, traced as
    ``conv_step_breakdown`` traces GAT's and GIN's."""
    from repro_torch.optim import adamw
    params, step, batches = geom_setup(arch, dev, backend, two_hop)
    opt, batch = adamw.init_state(params), next(batches)
    rec = trace_steps(lambda: float(step(params, opt, batch)[2]["loss"]),
                      n_steps, "spmm_dedup_chunks", top=4,
                      split={"b1": is_b1, "b4": is_b4})
    rec.pop("kernel_ms_per_step")
    rec.pop("op_keys")
    return rec


def phase_geom_train(dev):
    """schnet (dense, cuda, cuda_q8) and dimenet (the same, and over Â² on
    cuda and cuda_q8) at FULL on the molecule batch, each run counted;
    bitwise against a second run and a run resumed from its
    ``GEOM_CKPT_EVERY``-step commit; each step's loss and gradient norm
    against the same parameters' on ``dense``, and at ``GEOM_CPU_AT`` on
    the CPU (≤1e-4; the loss relative to itself past 1: DimeNet's energies
    with random weights put it near 4·10⁷, 3·10⁹ over Â²; the norm relative
    to the larger of its own and the run's first; int8 ≤ ``Q8_E2E_TOL``
    against the CPU, its aggregations replayed there ≤1e-5, and against
    ``dense`` a reading); one warm step of each traced."""
    import shutil
    import tempfile
    from repro_torch.sparse.quantize import Q8_E2E_TOL
    kernels = conv_kernels()
    runs, launches, errs, readings, cpu_s, run_s = {}, {}, {}, {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for arch, backend, two_hop in GEOM_RUNS:
            t_run = time.perf_counter()
            name = f"{arch}{'_two_hop' if two_hop else ''}_{backend}"
            job = functools.partial(geom_job, arch, dev, backend, two_hop)
            int8 = backend == "cuda_q8" and two_hop
            seen = []
            zero_counts(kernels)
            if int8:
                run, n_calls, replay = replay_aggregates_on_cpu(
                    functools.partial(job, tmp / name, seen))
                errs[f"{name}_aggregations_vs_cpu_replay"] = replay
                check(n_calls == GEOM_STEPS and replay <= KERNEL_TOL,
                      f"train {name}: {n_calls} aggregations (want "
                      f"{GEOM_STEPS}), card vs CPU replay {replay:.3e}")
            else:
                run = job(tmp / name, seen)
            launches[name] = read_counts(kernels)
            runs[name] = run
            state, hist = run
            check(state.step == GEOM_STEPS
                  and all(math.isfinite(v) for v in hist["loss"])
                  and hist["loss"][-1] < hist["loss"][0]
                  and hist["retries"] == 0,
                  f"train {name}: {state.step} steps, losses "
                  f"{hist['loss'][0]} → {hist['loss'][-1]}")
            want = geom_launches(backend, two_hop)
            check(launches[name] == want,
                  f"train {name}: launches {launches[name]}, expected {want}")
            check(same_run(run, job(tmp / f"{name}_again")),
                  f"train {name}: two runs on the card differ")
            resume = tmp / f"{name}_resume"
            resume.mkdir()
            commit = f"step_{GEOM_CKPT_EVERY:06d}"
            shutil.copytree(tmp / name / commit, resume / commit)
            resumed = job(resume)
            check(len(resumed[1]["loss"]) == GEOM_STEPS - GEOM_CKPT_EVERY
                  and same_run(resumed, run),
                  f"train {name}: the run resumed at step {GEOM_CKPT_EVERY}"
                  " does not reproduce the unbroken run bitwise")
            shutil.rmtree(resume)
            tol = Q8_E2E_TOL if int8 else EXECUTOR_TOL
            g0 = abs(seen[0][1])
            for other, device in (("dense", dev), (backend, "cpu")):
                on_cpu = device == "cpu"
                key = f"{name}_vs_{'cpu' if on_cpu else other}"
                if not on_cpu and backend == "dense":
                    continue
                points = ([seen[i] for i in GEOM_CPU_AT] if on_cpu
                          else seen)
                losses = ([hist["loss"][i] for i in GEOM_CPU_AT] if on_cpu
                          else hist["loss"])
                t0 = time.perf_counter()
                at = geom_losses_at(arch, device, other, two_hop, points)
                if on_cpu:
                    cpu_s[name] = (time.perf_counter() - t0) / len(points)
                errs[key + "_same_params"] = max(
                    abs(a[0] - b) / max(1.0, abs(b))
                    for a, b in zip(at, losses))
                errs[key + "_same_params_grad_norm"] = max(
                    abs(a[1] - g) / max(abs(g), g0, 1e-30)
                    for a, (_, g) in zip(at, points))
                if int8 and not on_cpu:
                    # a reading: int8 against f32 on DimeNet's Â² stage
                    # (the random-weight model's node features quantized
                    # per feature tile); the int8 run is held to the CPU
                    # and to its replays
                    continue
                check(errs[key + "_same_params"] <= tol
                      and errs[key + "_same_params_grad_norm"] <= tol,
                      f"train {key}: a step from the same parameters: loss "
                      f"{errs[key + '_same_params']:.3e} (relative past 1),"
                      f" gradient norm (relative) "
                      f"{errs[key + '_same_params_grad_norm']:.3e}; bar "
                      f"{tol}")
            readings[name] = geom_step_breakdown(dev, arch, backend,
                                                 two_hop)
            run_s[name] = time.perf_counter() - t_run
    rec = dict(losses={k: h["loss"] for k, (_, h) in runs.items()},
               launches=launches, errors=errs, cpu_s_per_step=cpu_s,
               seconds=run_s)
    say(f"geom train {json.dumps(rec)}")
    for k, r in readings.items():
        say(f"geom train step {k} {json.dumps(r)}")
    total = {k: sum(v[k] for v in launches.values()) for k in CONV_KERNELS}
    return dict(launches=total, per_run=launches, readings=readings,
                errors=errs)


# ---------------------------------------------------------------------------
# phase 17 — the serving plane: tracing, metrics, chaos and retries
# ---------------------------------------------------------------------------

HAPPY_SPANS = ["sample", "queue_wait", "bucket_pack", "dispatch", "settle"]
TRACING_COST_RUNS = 5


def ops_server(dev, params, indptr, indices, store, sampler="device",
               max_batch_seeds=16, **kw):
    """gcn-cora at full width under ``cuda`` on the Cora-scale graph, as
    phases 4-5 serve it, with the operations-plane options ``kw``."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.serve import GNNServer
    return GNNServer("gcn", FULL, params, indptr, indices, store,
                     fanouts=(5, 3), backend="cuda", sampler=sampler,
                     max_batch_seeds=max_batch_seeds, device=dev, **kw)


def ops_kernels():
    from repro_torch.kernels.forest_sampler import forest_sample, hash_draws
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks
    return (spmm_dedup_chunks, forest_sample, hash_draws)


def served_burst(server, seeds, scrape=None):
    """Counts zeroed, ``seeds`` submitted as one burst of single-seed
    requests and drained, with ``scrape`` called from another thread from
    the first submit until the drain ends; the requests, the launch
    counts, the wall s and the scrapes that started before the drain
    ended."""
    import threading
    kernels = ops_kernels()
    for k in kernels:
        k.launches = 0
    go, stop = threading.Event(), threading.Event()
    scrapes = []

    def scraper():
        go.wait()
        while True:
            t = time.perf_counter()
            scrapes.append((t, scrape()))
            if stop.wait(0.002):
                return
    thread = threading.Thread(target=scraper) if scrape else None
    if thread:
        thread.start()
    t0 = time.perf_counter()
    go.set()
    reqs = [server.submit([int(s)]) for s in seeds]
    server.drain()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    dt = t1 - t0
    stop.set()
    if thread:
        thread.join()
    during = [fams for t, fams in scrapes if t < t1]
    return reqs, {k.__name__: k.launches for k in kernels}, dt, during


def replay_err(server, reqs) -> float:
    from repro_torch.serve import offline_replay
    served = [r for r in reqs if r.error is None]
    if not served:
        return 0.0
    got = np.concatenate([r.result for r in served])
    ref = np.concatenate([offline_replay(server, r) for r in served])
    check(got.shape == ref.shape and np.isfinite(got).all(),
          "phase 17: served results malformed")
    return float(np.abs(got - ref).max())


def check_launches(name, launches, n_steps, device_sampler=True):
    """Two B1 a dispatched step, one ``forest_sample`` under the device
    sampler (none under the host's), no ``hash_draws``."""
    want = {"spmm_dedup_chunks": 2 * n_steps,
            "forest_sample": n_steps if device_sampler else 0,
            "hash_draws": 0}
    check(launches == want, f"{name}: launches {launches} for {n_steps} "
                            f"dispatched steps, expected {want}")


def span_ms(recs, name):
    return [1e3 * (s["t1"] - s["t0"]) for r in recs for s in r["spans"]
            if s["name"] == name]


def device_window_ms(recs):
    """Per request, the gap from the end of its ``dispatch`` span to its
    ``settle`` span: the device's time, and its wait behind the batch in
    flight before it."""
    out = []
    for r in recs:
        by = {s["name"]: s for s in r["spans"]}
        if "dispatch" in by and "settle" in by:
            out.append(1e3 * (by["settle"]["t0"] - by["dispatch"]["t1"]))
    return out


def med(xs):
    return float(statistics.median(xs)) if xs else None


def phase_ops(dev, params, indptr, indices, store, seeds):
    """Phase 17: the single-lane serving plane around gcn-cora serving."""
    import urllib.request
    from repro_torch.serve import ChaosInjector, verify_traces
    from repro_torch.serve.chaos import _hash_p
    from repro_torch.serve.errors import RetriesExhausted, SamplerError
    from repro_torch.serve.metrics import (histogram_counts_from_samples,
                                           parse_exposition)
    out = {}

    # 1. tracing on, metrics on an ephemeral port, the device sampler
    with ops_server(dev, params, indptr, indices, store, tracing=True,
                    metrics_port=0) as srv:
        srv.warmup()
        srv.reset_stats()
        url = srv.stats()["metrics_url"]

        def scrape():
            with urllib.request.urlopen(url, timeout=10) as resp:
                return parse_exposition(resp.read().decode())
        reqs, launches, dt, scrapes = served_burst(srv, seeds, scrape)
        st = srv.stats()
        check(all(r.n_settles == 1 and r.error is None for r in reqs),
              "traced server: a request did not settle once with a result")
        recs = srv.tracer.traces()
        check(verify_traces(recs) == [],
              f"traced server: {verify_traces(recs)[:3]}")
        by_id = {r["trace"]: r for r in recs}
        check(sorted(by_id) == sorted(r.rid for r in reqs)
              and len(recs) == len(reqs),
              f"traced server: {len(recs)} trees for {len(reqs)} requests")
        orders = {tuple(s["name"] for s in r["spans"]) for r in recs}
        check(orders == {tuple(HAPPY_SPANS)}, f"span orders {orders}")
        check(st["tracing"]["open"] == 0 and st["tracing"]["dropped"] == 0,
              f"tracing stats {st['tracing']}")
        fams = scrape()
        check(len(scrapes) >= 1, "no scrape landed during the traffic")
        served = [v for _, lab, v, _ in
                  fams["neurachip_requests_total"]["samples"]
                  if lab == {"outcome": "served"}]
        samples = fams["neurachip_request_latency_seconds"]["samples"]
        hist_n = sum(histogram_counts_from_samples(samples, {}))
        check(served == [st["n_served"]] == [len(reqs)]
              and hist_n == st["n_served"],
              f"exposition served {served}, histogram {hist_n}, "
              f"n_served {st['n_served']}")
        check_launches("traced server", launches, st["n_batches"])
        err = replay_err(srv, reqs)
        check(err <= SERVE_TOL, f"traced server vs replay {err:.3e}")
        out["traced"] = dict(
            requests=len(reqs), req_per_s=len(reqs) / dt,
            batches=st["n_batches"], launches=launches, parity_max_abs=err,
            scrapes_during_traffic=len(scrapes), tracing=st["tracing"],
            bucket_hits=st["bucket_hits"],
            **{f"{n}_median_ms": med(span_ms(recs, n))
               for n in ("sample", "queue_wait", "bucket_pack",
                         "dispatch")},
            device_window_median_ms=med(device_window_ms(recs)),
            dispatch_p90_ms=float(np.percentile(span_ms(recs, "dispatch"),
                                                90)))
    say(f"ops traced {json.dumps(out['traced'])}")

    # 2. transient step faults at p = 0.2, one retry each
    chaos = ChaosInjector(17, p_step_fault=0.2)
    with ops_server(dev, params, indptr, indices, store, tracing=True,
                    chaos=chaos, max_retries=1) as srv:
        srv.warmup()
        srv.reset_stats()
        reqs, launches, dt, _ = served_burst(srv, seeds)
        st = srv.stats()
        check(all(r.n_settles == 1 for r in reqs),
              "chaos 0.2: a request settled other than once")
        failed = [r for r in reqs if r.error is not None]
        check(all(isinstance(r.error, RetriesExhausted) and r.attempts == 2
                  for r in failed),
              f"chaos 0.2: failures {[repr(r.error) for r in failed[:3]]}")
        recs = srv.tracer.traces()
        check(verify_traces(recs) == [], "chaos 0.2: malformed traces")
        by_id = {r["trace"]: r for r in recs}
        retried = [r for r in reqs if r.attempts]
        check(all(("retry" in [s["name"] for s in by_id[r.rid]["spans"]])
                  == bool(r.attempts) for r in reqs),
              "chaos 0.2: a retried request without a retry span")
        check(chaos.injected["step"] >= 1 and len(retried) >= 1,
              f"chaos 0.2: {chaos.injected['step']} faulted rounds")
        check_launches("chaos 0.2", launches, st["n_batches"])
        err = replay_err(srv, reqs)
        check(err <= SERVE_TOL, f"chaos 0.2 served vs replay {err:.3e}")
        out["chaos_0.2"] = dict(
            faulted_rounds=chaos.injected["step"],
            dispatched_steps=st["n_batches"], retried=len(retried),
            served_after_retry=sum(r.error is None for r in retried),
            retries_exhausted=len(failed), served=st["n_served"],
            launches=launches, parity_max_abs=err)
    say(f"ops chaos 0.2 {json.dumps(out['chaos_0.2'])}")

    # 3. every step faults: every request exhausts its retry, nothing runs
    chaos = ChaosInjector(17, p_step_fault=1.0)
    with ops_server(dev, params, indptr, indices, store, chaos=chaos,
                    max_retries=1) as srv:
        reqs, launches, _, _ = served_burst(srv, seeds)
        check(all(r.n_settles == 1 and isinstance(r.error, RetriesExhausted)
                  for r in reqs), "chaos 1.0: a request did not fail "
                                  "RetriesExhausted once")
        check_launches("chaos 1.0", launches, 0)
        out["chaos_1.0"] = dict(failed=len(reqs), launches=launches,
                                faulted_rounds=chaos.injected["step"])
    say(f"ops chaos 1.0 {json.dumps(out['chaos_1.0'])}")

    # 4. sampler faults on the host sampler: only those requests fail
    chaos = ChaosInjector(17, p_sampler_fault=0.1)
    with ops_server(dev, params, indptr, indices, store, sampler="host",
                    chaos=chaos) as srv:
        srv.warmup()
        reqs, launches, _, _ = served_burst(srv, seeds)
        want = {r.rid for r in reqs if _hash_p(17, 2, r.rid, 0.1)}
        got = {r.rid for r in reqs if r.error is not None}
        check(got == want and all(isinstance(r.error, SamplerError)
                                  for r in reqs if r.rid in got)
              and all(r.n_settles == 1 for r in reqs),
              f"sampler faults: failed {sorted(got)[:5]}, expected "
              f"{sorted(want)[:5]}")
        check_launches("sampler faults", launches, srv.stats()["n_batches"],
                       device_sampler=False)
        err = replay_err(srv, reqs)
        check(err <= SERVE_TOL, f"sampler faults: served vs replay {err:.3e}")
        out["sampler_faults"] = dict(failed=len(got),
                                     injected=chaos.injected["sampler"],
                                     parity_max_abs=err, launches=launches)
    say(f"ops sampler faults {json.dumps(out['sampler_faults'])}")

    # 5. the tracing cost, a reading: req/s off and on, in turns
    rates = {False: [], True: []}
    servers = {on: ops_server(dev, params, indptr, indices, store,
                              tracing=on) for on in (False, True)}
    try:
        for srv in servers.values():
            srv.warmup()
        for turn in range(TRACING_COST_RUNS):
            for on in ((False, True) if turn % 2 == 0 else (True, False)):
                _, _, dt, _ = served_burst(servers[on], seeds)
                rates[on].append(len(seeds) / dt)
    finally:
        for srv in servers.values():
            srv.close()
    off, on = med(rates[False]), med(rates[True])
    out["tracing_cost"] = dict(req_per_s_off=rates[False],
                               req_per_s_on=rates[True], median_off=off,
                               median_on=on, cost=1.0 - on / off)
    say(f"ops tracing cost {json.dumps(out['tracing_cost'])}")
    out["launches"] = {
        k: sum(out[n]["launches"][k] for n in ("traced", "chaos_0.2",
                                               "chaos_1.0",
                                               "sampler_faults"))
        for k in ("spmm_dedup_chunks", "forest_sample", "hash_draws")}
    return out


# ---------------------------------------------------------------------------
# phase 18 — the cluster tier
# ---------------------------------------------------------------------------

CLUSTER_LANES = 4
CLUSTER_REQUESTS = 1024
CLUSTER_REPLAYED = 64             # requests replayed offline a server
CLUSTER_AB_TURNS = 3              # cluster and single lanes, in turns
CLUSTER_AB = ("cluster", "single", "single64")


def lane_stacked_case(dev, backend, bucket, d, rng):
    """B1 (``cuda``) or B4 (``cuda_q8``) on the lane-stacked plan of
    ``CLUSTER_LANES`` lanes of a bucket at fanouts (5, 3), each lane
    re-valued with its own seeded weights and validity and its own x (the
    lanes 4× apart in magnitude, so one shared int8 scale would show):
    against the lanes' single-lane calls (bitwise, lane by lane), its plain
    version (B1 ≤1e-5 relative to x's largest value, B4 bitwise) and
    itself run to run (bitwise), timed beside the single-lane calls, the
    plain version and ``torch.sparse.mm`` on the stacked CSR (dequantized
    for B4)."""
    from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                    spmm_dedup_chunks,
                                                    spmm_dedup_chunks_plain,
                                                    spmm_dedup_chunks_q8,
                                                    spmm_dedup_chunks_q8_plain)
    from repro_torch.serve import compute
    from repro_torch.serve.buckets import build_bucket_structure
    from repro_torch.sparse import quantize as qz
    from repro_torch.sparse.plan import plan_with_values
    name = f"{'B4' if backend == 'cuda_q8' else 'B1'} stacked{bucket}x" \
           f"{CLUSTER_LANES} D={d}"
    L = CLUSTER_LANES
    struct = build_bucket_structure(bucket, (5, 3), with_loops=True)
    pl = compute.bucket_plan(struct, backend, True, dev, L)
    p1 = compute.bucket_plan(struct, backend, True, dev)
    n, rows = struct.n_nodes, pl.lane_rows
    x = torch.zeros(L * rows, d, device=dev)
    lanes, ws, vs = [], [], []
    for lane in range(L):
        w = torch.from_numpy(rng.uniform(0.1, 1, struct.n_edges).astype(
            np.float32)).to(dev)
        v = torch.from_numpy(rng.random(struct.n_edges) < 0.8).to(dev)
        xl = torch.from_numpy((rng.normal(size=(n, d)) * 4.0 ** lane)
                              .astype(np.float32)).to(dev)
        x[lane * rows:lane * rows + n] = xl
        ws.append(w)
        vs.append(v)
        lanes.append((plan_with_values(p1, edge_weight=w, edge_valid=v), xl))
    pl = plan_with_values(pl, edge_weight=torch.cat(ws),
                          edge_valid=torch.cat(vs))
    if backend == "cuda":
        args = (pl.ell_u_cols, pl.ell_remaining, pl.ell_block_ptr, pl.ell_a,
                x)

        def call():
            return spmm_dedup_chunks(*args, block_rows=8)

        def plain():
            return spmm_dedup_chunks_plain(*args, block_rows=8)

        def single(p, xl):
            return spmm_dedup_chunks(p.ell_u_cols, p.ell_remaining,
                                     p.ell_block_ptr, p.ell_a, xl,
                                     block_rows=8)
        a_csr, x_lib = csr_of(pl, pl.base_vals), x
    else:
        qt = auto_d_tile(d)
        x_q8, x_scale = qz.quantize_feature_tiles(x, qt, L, rows, n)
        args = (pl.ell_u_cols, pl.ell_remaining, pl.ell_block_ptr,
                pl.ell_a_q8, pl.ell_a_scale, x_q8, x_scale)
        kw = dict(block_rows=8, q_tile=qt)

        def call():
            return spmm_dedup_chunks_q8(*args, **kw)

        def plain():
            return spmm_dedup_chunks_q8_plain(*args, **kw)

        lane_q8 = {id(xl): qz.quantize_feature_tiles(xl, qt)
                   for _, xl in lanes}

        def single(p, xl):
            q, sc = lane_q8[id(xl)]
            return spmm_dedup_chunks_q8(p.ell_u_cols, p.ell_remaining,
                                        p.ell_block_ptr, p.ell_a_q8,
                                        p.ell_a_scale, q, sc, block_rows=8,
                                        q_tile=qt)
        a_csr = dequantized_csr(pl, pl.ell_a_q8, pl.ell_a_scale)
        x_lib = x_q8.float() * torch.repeat_interleave(
            x_scale, qt, dim=1)[:, :d].repeat_interleave(rows, dim=0)
    y = call()
    y_plain = plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    err = float((y - y_plain).abs().max())
    tol = 0.0 if backend == "cuda_q8" else \
        KERNEL_TOL * max(1.0, float(x.abs().max()))
    check(err <= tol, f"{name}: max|kernel-plain| {err:.3e} > {tol}")
    check(torch.equal(call(), y), f"{name}: not bitwise equal run to run")
    for lane, (p, xl) in enumerate(lanes):
        check(torch.equal(y[lane * rows:lane * rows + n], single(p, xl)[:n]),
              f"{name}: lane {lane} differs from its single-lane call")
    lib_err = float((torch.sparse.mm(a_csr, x_lib) - y[:pl.n_rows]).abs()
                    .max())
    check(lib_err <= EXECUTOR_TOL * max(1.0, float(x_lib.abs().max())),
          f"{name}: kernel vs torch.sparse.mm {lib_err:.3e}")
    rec = dict(
        shape=name, max_abs_err=err, run_to_run="bitwise",
        per_lane="bitwise", ms=graph_ms(call),
        single_lane_calls_ms=graph_ms(lambda: [single(p, xl)
                                               for p, xl in lanes]),
        plain_ms=eager_ms(plain, iters=10),
        library_ms=graph_ms(lambda: torch.sparse.mm(a_csr, x_lib)))
    bound, _, _ = spmm_bound(pl, d, y.numel(), q8=backend == "cuda_q8",
                             x_scales=(x_scale.numel()
                                       if backend == "cuda_q8" else 0))
    rec.update(bound, bound_share=bound["bound_ms"] / rec["ms"],
               vs_library=rec["ms"] / rec["library_ms"])
    say(f"{name.split()[0]} {json.dumps(rec)}")
    return rec


def csr_of(plan, vals):
    """``plan``'s matrix with edge values ``vals`` as a CSR tensor."""
    return torch.sparse_coo_tensor(
        torch.stack([plan.rows, plan.cols]), vals,
        (plan.n_rows, plan.n_rows)).coalesce().to_sparse_csr()


def cluster_server(dev, arch, cfg, params, indptr, indices, store,
                   backend="cuda", **kw):
    """``arch`` at ``cfg`` as a ``CLUSTER_LANES``-lane replicated cluster,
    stacked placement, fanouts (5, 3), max batch 16, host sampler."""
    from repro_torch.serve import ClusterServer
    return ClusterServer(arch, cfg, params, indptr, indices, store,
                         n_lanes=CLUSTER_LANES, mode="replicated",
                         placement="stacked", fanouts=(5, 3),
                         backend=backend, max_batch_seeds=16, seed=0,
                         device=dev, **kw)


def cluster_burst(server, seeds):
    """Counts zeroed, ``seeds`` submitted as one burst of single-seed
    requests (``submit_many``) and drained; the requests, the counts and
    the wall s."""
    kernels = ops_kernels() + (spmm_q8_kernel(),)
    zero_counts(kernels)
    q8 = spmm_q8_kernel()
    q8.launches_lanes = 0
    t0 = time.perf_counter()
    reqs = server.submit_many([[int(s)] for s in seeds])
    server.drain(timeout=300)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts(kernels)
    counts["spmm_dedup_chunks_q8_lanes"] = q8.launches_lanes
    return reqs, counts, dt


def spmm_q8_kernel():
    from repro_torch.kernels.gustavson_spmm import spmm_dedup_chunks_q8
    return spmm_dedup_chunks_q8


def served_once(reqs) -> bool:
    return all(r.n_settles == 1 and r.error is None for r in reqs)


def cluster_serve(dev, arch, cfg, params, indptr, indices, store, seeds,
                  backend):
    """One cluster serving ``seeds``, counted: every request settles once,
    no step or plan is built after warm-up, one B1 (B4) launch an
    aggregation a round whatever the lanes, no sampler kernel (the host
    samples), ``CLUSTER_REPLAYED`` requests equal to offline replay; the
    burst's garbage-collection pauses and lane deaths recorded."""
    from repro_torch.serve import compute
    spmm = {"cuda": "spmm_dedup_chunks",
            "cuda_q8": "spmm_dedup_chunks_q8"}[backend]
    per_step = aggregations_per_step(arch, cfg)
    with cluster_server(dev, arch, cfg, params, indptr, indices, store,
                        backend) as srv:
        srv.warmup()
        builds = srv.steps.builds
        plan_builds = compute.bucket_plan_cache_info()["builds"]
        srv.reset_stats()
        # no collection first: a pause the burst meets is recorded as it is
        with GcPauses() as gcp:
            reqs, launches, dt = cluster_burst(srv, seeds)
        st = srv.stats()
        ls = srv.lane_stats()
        check(served_once(reqs), f"cluster {arch} {backend}: a request did "
                                 "not settle exactly once with a result")
        check(srv.steps.builds == builds
              and compute.bucket_plan_cache_info()["builds"] == plan_builds,
              f"cluster {arch} {backend}: a step or plan built after "
              "warm-up")
        rounds = st["n_rounds"]
        want = {spmm: per_step * rounds, "forest_sample": 0,
                "hash_draws": 0}
        if backend == "cuda_q8":
            want["spmm_dedup_chunks"] = 0
            want["spmm_dedup_chunks_q8_lanes"] = per_step * rounds
        got = {k: launches[k] for k in want}
        check(got == want, f"cluster {arch} {backend}: launches {got} for "
                           f"{rounds} rounds, expected {want}")
        sub = reqs[:CLUSTER_REPLAYED]
        ref = np.concatenate([srv.offline_replay(r) for r in sub])
    got_out = np.concatenate([r.result for r in reqs])
    check(got_out.shape == (len(seeds), cfg.n_classes)
          and np.isfinite(got_out).all(),
          f"cluster {arch} {backend}: served results malformed")
    err = float(np.abs(np.concatenate([r.result for r in sub]) - ref).max())
    tol = serve_tol(arch, backend, ref)
    check(err <= tol, f"cluster {arch} {backend}: served vs offline replay "
                      f"{err:.3e} > {tol}")
    rec = dict(arch=arch, backend=backend, lanes=CLUSTER_LANES,
               requests=len(seeds), req_per_s=len(seeds) / dt,
               p50_ms=st["p50_ms"], p99_ms=st["p99_ms"], rounds=rounds,
               buckets=st["bucket_counts"], launches=launches,
               launches_per_round=per_step, parity_max_abs=err,
               parity_tol=tol, replayed=len(sub),
               served_per_lane=ls["served"],
               served_spread=ls["served_spread"], reseeds=st["reseeds"],
               lane_deaths=st["lane_deaths"],
               gc_pauses_n_ms=(gcp.n, gcp.ms))
    say(f"cluster {json.dumps(rec)}")
    return rec


class GcPauses:
    """The interpreter's garbage-collection pauses while in the block:
    ``ms`` their sum and ``n`` their count (a stop-the-world pause stalls
    every serving thread alike)."""

    def __enter__(self):
        self.ms, self.n, self._t0 = 0.0, 0, None
        gc.callbacks.append(self._note)
        return self

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self.n += 1

    def __exit__(self, *exc):
        gc.callbacks.remove(self._note)


def round_breakdown(srv, seeds, n_steps: int = 20) -> dict:
    """One warm bucket-16 round of the cluster as its engine runs it (the
    feature fetch and the lane-stacked step, 16 host-sampled trees a
    lane), traced as ``step_breakdown`` traces a single-lane step."""
    from repro_torch.serve.buckets import stack_trees
    node_ids, hop_valid = [], []
    for lane in range(CLUSTER_LANES):
        trees = srv._sampler.sample_for(seeds[16 * lane:16 * (lane + 1)],
                                        rid=lane)
        ni, hv = stack_trees(trees, 16, srv.fanouts)
        node_ids.append(ni)
        hop_valid.append(hv)
    node_ids, hop_valid = np.stack(node_ids), np.stack(hop_valid)
    step = srv.steps.get((16,))
    rec = trace_steps(lambda: step(srv.params, srv._gather(node_ids),
                                   node_ids, hop_valid), n_steps,
                      "spmm_dedup_chunks")
    rec["spmm_ms_per_step"] = rec.pop("kernel_ms_per_step")
    return rec


def phase_cluster(dev, params, indptr, indices, store):
    """Phase 18: the replicated cluster tier around gcn-cora and gat-cora
    serving, then its control plane, then the readings."""
    from repro_torch.configs import gat_cora
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.models.gnn import gat
    from repro_torch.serve import (ChaosInjector, DRHMRouter, LaneFault,
                                   Overloaded, utilization_spread)
    out = {}
    rng = np.random.default_rng(18)

    # 1. kernels on the lane-stacked plans
    out["kernels"] = [lane_stacked_case(dev, backend, bucket, d, rng)
                      for backend in ("cuda", "cuda_q8")
                      for bucket in (1, 16) for d in (16, 1433)]

    # 2. the server: gcn-cora cuda and cuda_q8, gat-cora cuda
    seeds = np.random.default_rng(2).integers(0, 2708, CLUSTER_REQUESTS)
    gat_cfg = gat_cora.FULL
    gat_params = gat.init_params(gat_cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    out["serve"] = [
        cluster_serve(dev, "gcn", FULL, params, indptr, indices, store,
                      seeds, "cuda"),
        cluster_serve(dev, "gcn", FULL, params, indptr, indices, store,
                      seeds, "cuda_q8"),
        cluster_serve(dev, "gat", gat_cfg, gat_params, indptr, indices,
                      store, seeds, "cuda")]

    # 3. control plane: a skewed stream reseeds
    probe = DRHMRouter(CLUSTER_LANES, seed=0)
    hot = np.array([i for i in range(2708) if probe.lane_of([i]) == 0])
    hot_seeds = hot[np.random.default_rng(3).integers(0, hot.size, 512)]
    with cluster_server(dev, "gcn", FULL, params, indptr, indices,
                        store) as srv:
        srv.warmup()
        reqs, _, dt = cluster_burst(srv, hot_seeds)
        info = srv.router.info()
        check(served_once(reqs), "reseed drill: a request did not settle "
                                 "once with a result")
        check(info["reseeds"] >= 1, "reseed drill: a stream on one lane "
                                    "did not reseed")
        post = np.sum([np.asarray(c, float)
                       for c in info["routed_per_epoch"][1:]], axis=0)
        out["reseed"] = dict(
            requests=len(reqs), reseeds=info["reseeds"],
            routed_per_epoch=info["routed_per_epoch"],
            spread_before=utilization_spread(info["routed_per_epoch"][0]),
            spread_after=utilization_spread(post) if post.sum() else None,
            served_per_lane=srv.lane_stats()["served"], req_per_s=len(reqs)
            / dt)
    say(f"cluster reseed {json.dumps(out['reseed'])}")

    # 4. control plane: kill lane 1 at round 3, as gnn_serve
    # --chaos-kill-lane 1 --chaos-round 3 does; it restarts after 0.5 s
    chaos = ChaosInjector(seed=0, lane_faults=[LaneFault(lane=1,
                                                         at_round=3)])
    with cluster_server(dev, "gcn", FULL, params, indptr, indices, store,
                        chaos=chaos, stall_timeout=0.15,
                        restart_after=0.5) as srv:
        srv.warmup()
        t0 = time.perf_counter()
        reqs, _, _ = cluster_burst(srv, seeds)
        st = srv.stats()
        check(served_once(reqs), "kill drill: a request was lost")
        check(chaos.injected["kill"] == 1 and st["lane_deaths"] == 1
              and st["reroutes"] > 0,
              f"kill drill: kills {chaos.injected['kill']}, deaths "
              f"{st['lane_deaths']}, reroutes {st['reroutes']}")
        check(all(r.reroutes <= 1 for r in reqs),
              "kill drill: a request re-routed twice")
        deadline = time.monotonic() + 30
        while srv.router.n_active < CLUSTER_LANES and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        restored_s = time.perf_counter() - t0
        st = srv.stats()
        check(srv.lane_states() == ["active"] * CLUSTER_LANES
              and st["lane_restores"] == 1,
              f"kill drill: lane states {srv.lane_states()}, restores "
              f"{st['lane_restores']}")
        rerouted = [r for r in reqs if r.reroutes][:16]
        err = float(max(np.abs(r.result - srv.offline_replay(r)).max()
                        for r in rerouted))
        check(err <= SERVE_TOL, f"kill drill: re-routed vs replay {err:.3e}")
        out["kill"] = dict(
            requests=len(reqs), reroutes=st["reroutes"],
            lane_deaths=st["lane_deaths"], lane_restores=st["lane_restores"],
            restored_after_s=restored_s, parity_max_abs=err,
            served_per_lane=srv.lane_stats()["served"])
    say(f"cluster kill {json.dumps(out['kill'])}")

    # 5. control plane: every lane wedged, interactive latencies blow the
    # default 50 ms target, the SLO engine sheds best_effort first
    stall = ChaosInjector(seed=0, lane_faults=[
        LaneFault(lane=i, at_round=1, kind="stall", duration=0.4)
        for i in range(CLUSTER_LANES)])
    with cluster_server(dev, "gcn", FULL, params, indptr, indices, store,
                        chaos=stall, stall_timeout=60, slo=True,
                        slo_sustain_ticks=1) as srv:
        srv.warmup()
        accepted = srv.submit_many([[int(s)] for s in seeds[:256]])
        deadline = time.monotonic() + 30
        while not srv.slo.should_shed("best_effort") and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        refused = None
        try:
            srv.submit([1], cls="best_effort")
        except Overloaded as exc:
            refused = exc.cls
        accepted.append(srv.submit([2], cls="interactive"))
        srv.drain(timeout=120)
        events = [e for e in srv.telemetry.events
                  if e.get("event") == "shed_class" and e.get("on")]
        check(refused == "best_effort" and served_once(accepted)
              and events and events[0]["cls"] == "best_effort"
              and not srv.slo.should_shed("interactive"),
              f"SLO drill: refused {refused}, shed events {events[:2]}")
        classes = srv.stats()["classes"]
        out["slo"] = dict(
            accepted=len(accepted), refused_class=refused,
            shed_events=[e["cls"] for e in events],
            interactive_p99_ms=classes["interactive"]["p99_ms"],
            interactive_burn_fast=classes["interactive"]["burn_fast"])
    say(f"cluster slo {json.dumps(out['slo'])}")

    # 6. readings: the 4-lane cluster against one GNNServer at max batch
    # 16 and one at 64 (a 4-lane round's seeds in one step: the batch
    # alone, without the lanes) on the same requests, host sampler, in
    # turns; then one round against one step (each burst after a full
    # collection, its own collections' pauses recorded: the script's heap
    # is large by now)
    rates = {k: [] for k in CLUSTER_AB}
    lat = {k: [] for k in CLUSTER_AB}
    pauses = {k: [] for k in CLUSTER_AB}
    events = []
    servers = {
        "single": ops_server(dev, params, indptr, indices, store,
                             sampler="host"),
        "single64": ops_server(dev, params, indptr, indices, store,
                               sampler="host", max_batch_seeds=64),
        "cluster": cluster_server(dev, "gcn", FULL, params, indptr, indices,
                                  store)}
    cluster, single = servers["cluster"], servers["single"]
    try:
        for srv in servers.values():
            srv.warmup()
        for turn in range(CLUSTER_AB_TURNS):
            for name in CLUSTER_AB[turn:] + CLUSTER_AB[:turn]:
                srv = servers[name]
                srv.reset_stats()
                gc.collect()
                with GcPauses() as gcp:
                    if name == "cluster":
                        reqs, _, dt = cluster_burst(cluster, seeds)
                    else:
                        reqs, _, dt, _ = served_burst(srv, seeds)
                st = srv.stats()
                check(served_once(reqs) and st.get("lane_deaths", 0) == 0,
                      f"{name} burst {turn}: a request was not served once "
                      f"or a lane died ({st.get('lane_deaths')})")
                rates[name].append(len(seeds) / dt)
                lat[name].append((st["p50_ms"], st["p99_ms"]))
                pauses[name].append((gcp.n, gcp.ms))
                if name == "cluster":
                    events.append(cluster.telemetry.event_counts())
        out["vs_single_lane"] = dict(
            req_per_s=rates, p50_p99_ms=lat, gc_pauses_n_ms=pauses,
            cluster_events=events,
            median_req_per_s={k: med(v) for k, v in rates.items()},
            speedup=med(rates["cluster"]) / med(rates["single"]),
            speedup_vs_batch64=med(rates["cluster"])
            / med(rates["single64"]))
        out["round"] = round_breakdown(cluster, seeds)
        out["single_step"] = step_breakdown(single, seeds)
    finally:
        for srv in servers.values():
            srv.close()
    say(f"cluster readings {json.dumps({k: out[k] for k in ('vs_single_lane', 'round', 'single_step')})}")
    out["launches"] = {k: sum(sv["launches"][k] for sv in out["serve"])
                       for k in ("spmm_dedup_chunks", "spmm_dedup_chunks_q8",
                                 "spmm_dedup_chunks_q8_lanes")}
    return out


# ---------------------------------------------------------------------------
# phase 19 — live mutation
# ---------------------------------------------------------------------------

DELTA_EPOCHS = 6                  # cluster_bench.bench_delta_repack's batch
DELTA_INSERTS, DELTA_DELETES = 48, 16
LIVE_SWAPS = 3
LIVE_BURST = 256                  # requests before and after each flip
LIVE_STREAM = (96, 24)            # inserts, deletes of original edges a cycle
LIVE_ABORT_BURST = 64


def delta_worlds():
    """(name, senders, receivers, nodes, weights, widths, mutation rng) of
    phase 19's graphs: Cora's graph as phase 2's cora_full plan holds it
    (sym-normed, self loops), the reference's ``delta_repack`` world
    (``benchmarks/cluster_bench.py:756``: 4,096 nodes, 60,000 unit edges,
    its mutations drawn from the same generator) and phase 6's
    Pubmed-scale graph with seeded weights."""
    from repro_torch.data.synthetic import cora_like, powerlaw_graph
    from repro_torch.sparse.graph import sym_norm_weights
    s, r, _, _, _ = cora_like(seed=0)
    s2, r2, wn = sym_norm_weights(s, r, 2708)
    rng = np.random.default_rng(0)
    s4 = rng.integers(0, 4096, 60_000)
    r4 = rng.integers(0, 4096, 60_000)
    sp, rp = powerlaw_graph(19717, 88648 + 2000, alpha=1.6, seed=0)
    return [("cora", s2, r2, 2708, wn, (16, 1433),
             np.random.default_rng(19)),
            ("n4096_e60000", s4, r4, 4096, None, (64,), rng),
            ("pubmed_scale", sp[:88648], rp[:88648], 19717,
             np.random.default_rng(2).uniform(0.1, 1.0, 88648).astype(
                 np.float32), (500,), np.random.default_rng(20))]


def delta_kernel_case(name, inc, cold, d, rng, q8):
    """B1 (B4 with ``q8``) on the incremental plan at width ``d``: bitwise
    the cold plan's call, against its plain version (B1 ≤1e-5, B4
    bitwise), timed beside the cold plan's call, the plain version and
    ``torch.sparse.mm`` on the mutated CSR (dequantized for B4)."""
    from repro_torch.kernels.gustavson_spmm import (auto_d_tile,
                                                    spmm_dedup_chunks,
                                                    spmm_dedup_chunks_plain,
                                                    spmm_dedup_chunks_q8,
                                                    spmm_dedup_chunks_q8_plain)
    from repro_torch.sparse import quantize as qz
    n = inc.n_rows
    x = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(
        inc.device)
    label = f"{'B4' if q8 else 'B1'} delta {name} D={d}"
    if q8:
        qt = auto_d_tile(d)
        x_q8, x_scale = qz.quantize_feature_tiles(x, qt)

        def call(p, kernel=spmm_dedup_chunks_q8):
            return kernel(p.ell_u_cols, p.ell_remaining, p.ell_block_ptr,
                          p.ell_a_q8, p.ell_a_scale, x_q8, x_scale,
                          block_rows=8, q_tile=qt)
        a_csr = dequantized_csr(inc, inc.ell_a_q8, inc.ell_a_scale)
        x_lib = x_q8.float() * torch.repeat_interleave(x_scale, qt)[:d]
        tol = 0.0
    else:
        def call(p, kernel=spmm_dedup_chunks):
            return kernel(p.ell_u_cols, p.ell_remaining, p.ell_block_ptr,
                          p.ell_a, x, block_rows=8)
        a_csr, x_lib, tol = csr_of(inc, inc.base_vals), x, KERNEL_TOL
    plain = functools.partial(call, kernel=(spmm_dedup_chunks_q8_plain if q8
                                            else spmm_dedup_chunks_plain))
    y = call(inc)
    y_cold = call(cold)
    y_plain = plain(inc)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
    check(torch.equal(y, y_cold), f"{label}: the incremental plan's output "
                                  "is not the cold plan's bitwise")
    err = float((y - y_plain).abs().max())
    check(err <= tol, f"{label}: max|kernel-plain| {err:.3e} > {tol}")
    del y_plain
    lib_err = float((torch.sparse.mm(a_csr, x_lib)[:n] - y[:n]).abs().max())
    check(lib_err <= EXECUTOR_TOL * max(1.0, float(x_lib.abs().max())),
          f"{label}: kernel vs torch.sparse.mm {lib_err:.3e}")
    rec = dict(shape=label, max_abs_err=err, vs_cold="bitwise",
               ms=graph_ms(lambda: call(inc)),
               cold_ms=graph_ms(lambda: call(cold)),
               plain_ms=eager_ms(lambda: plain(inc), iters=10),
               library_ms=graph_ms(lambda: torch.sparse.mm(a_csr, x_lib)))
    bound, _, _ = spmm_bound(inc, d, y.numel(), q8=q8,
                             x_scales=x_scale.numel() if q8 else 0)
    rec.update(bound, bound_share=bound["bound_ms"] / rec["ms"])
    say(f"{label.split()[0]} {json.dumps(rec)}")
    return rec


def delta_case(dev, name, s, r, n, w, dims, rng):
    """``DeltaGraphState`` over one graph: ``DELTA_EPOCHS`` epochs of
    ``DELTA_INSERTS`` inserts and ``DELTA_DELETES`` deletes, each flush's
    two layouts bitwise the cold pack's and the whole plan on the card
    (every field, the port's own included) equal to the cold plan's; then
    B1 and B4 on the last incremental plan, and the host seconds of the
    incremental re-pack against the cold one (``delta_repack_speedup``,
    timed as the reference's bench times them)."""
    from repro_torch.sparse.delta import (DeltaGraphError, DeltaGraphState,
                                          chunks_match, plans_match)
    backends = ("dense", "cuda", "cuda_q8")
    d = DeltaGraphState(s, r, n, weights=w)
    inc_s = cold_s = flush_s = 0.0
    dirty = clean = 0
    for _ in range(DELTA_EPOCHS):
        for _ in range(DELTA_INSERTS):
            d.insert_edge(int(rng.integers(0, n)), int(rng.integers(0, n)))
        for _ in range(DELTA_DELETES):
            k = int(rng.integers(0, d.n_edges))
            try:
                d.delete_edge(int(d._s[k]), int(d._r[k]))
            except DeltaGraphError:
                pass               # every copy of that edge already booked
        t0 = time.perf_counter()
        res = d.flush()
        flush_s += time.perf_counter() - t0
        dirty += res.dirty_blocks
        clean += res.clean_blocks
        t0 = time.perf_counter()
        inc = d.repack()
        inc_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        cold = d.cold_repack()
        cold_s += time.perf_counter() - t0
        check(all(np.array_equal(a, b) for a, b in zip(d.csr(), cold[2])),
              f"delta {name} epoch {res.epoch}: the CSR differs from the "
              f"cold sort")
        for side, a, b in zip(("forward", "transpose"), inc, cold[:2]):
            ok, detail = chunks_match(a, b, tol=0.0)
            check(ok, f"delta {name} epoch {res.epoch}: the {side} layout "
                      f"differs from the cold pack ({detail})")
        ok, detail = plans_match(d.plan(backends=backends, device=dev),
                                 d.cold_plan(backends=backends, device=dev),
                                 tol=0.0)
        check(ok, f"delta {name} epoch {res.epoch}: the plan differs from "
                  f"the cold plan ({detail})")
    t0 = time.perf_counter()
    p_inc = d.plan(backends=backends, device=dev)
    torch.cuda.synchronize()
    inc_plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_cold = d.cold_plan(backends=backends, device=dev)
    torch.cuda.synchronize()
    cold_plan_s = time.perf_counter() - t0
    kernels = [delta_kernel_case(name, p_inc, p_cold, dd, rng, q8)
               for q8 in (False, True) for dd in dims]
    rec = dict(graph=name, n_nodes=n, n_edges=d.n_edges,
               epochs=DELTA_EPOCHS, dirty_blocks=dirty, clean_blocks=clean,
               plan_fields_held=len(detail), flush_s=flush_s,
               incremental_repack_s=inc_s, cold_repack_s=cold_s,
               delta_repack_speedup=cold_s / inc_s,
               incremental_plan_s=inc_plan_s, cold_plan_s=cold_plan_s)
    say(f"delta {json.dumps(rec)}")
    return rec, kernels, p_inc, p_cold


def replay_on_version(srv, reqs, params, tol) -> float:
    """Largest |result − replay| of ``reqs`` through the single-lane
    offline step with ``params``, each on the trees it was served on (no
    re-sampling, so requests of an old epoch replay too)."""
    from repro_torch.serve.buckets import stack_trees
    step = srv._offline_steps.get((1,))
    err = 0.0
    for r in reqs:
        out = np.concatenate([
            step(params, *stack_trees([t], 1, srv.fanouts)).cpu().numpy()
            for t in r.trees])
        err = max(err, float(np.abs(out - r.result).max()))
    check(err <= tol, f"replay on the request's own version {err:.3e} > "
                      f"{tol}")
    return err


def pending_gaps_ms(srv, windows):
    """How long the engine left ready work waiting, from the span records:
    for each round, its dispatch minus the later of the previous round's
    dispatch and the earliest ``queue_wait`` start among its requests (the
    batcher's own ``max_wait_ms`` included).  Returns the median over the
    rounds and, for each server-clock window (lo, hi), the largest such
    wait that overlaps it (0 where no request waited inside it)."""
    t0 = srv.tracer.t0
    rounds = {}
    for rec in srv.tracer.traces():
        spans = {s["name"]: s for s in rec["spans"]}
        if "dispatch" in spans and "queue_wait" in spans:
            d = spans["dispatch"]
            ready, end = rounds.get(d["round"], (float("inf"), d["t1"]))
            rounds[d["round"]] = (min(ready, spans["queue_wait"]["t0"]), end)
    waits, prev = [], None
    for _, (ready, end) in sorted(rounds.items()):
        lo = ready if prev is None else max(ready, prev)
        waits.append((lo + t0, end + t0))
        prev = end
    inside = [max([b - a for a, b in waits if b >= lo and a <= hi],
                  default=0.0) * 1e3 for lo, hi in windows]
    return med([b - a for a, b in waits]) * 1e3, inside


def live_drill(dev, params, indptr, indices, store, backend, tmp, seeds,
               aborts):
    """The mutation drill at full width on ``backend``: 3 hot-swaps from
    perturbed checkpoints, each under a burst in flight, and an edge
    stream flushed (parity-proven) after each, with the flight recorder
    and /metrics on; then (``aborts``) the abort paths and feature rows on
    the same server; then NeuraScope on the recorder."""
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.launch import neurascope
    from repro_torch.launch.gnn_serve import (live_replayable, parity_tol,
                                              perturbed)
    from repro_torch.serve import GraphStream, compute, hot_swap
    from repro_torch.serve.live import _csr_to_coo
    name = f"live drill {backend}"
    spmm = {"cuda": "spmm_dedup_chunks",
            "cuda_q8": "spmm_dedup_chunks_q8"}[backend]
    tol = parity_tol(backend)
    ckpt = os.path.join(tmp, f"ckpt_{backend}")
    versions = [params] + [perturbed(params, k)
                           for k in range(1, LIVE_SWAPS + 1)]
    for k in range(1, LIVE_SWAPS + 1):
        ckpt_store.save(ckpt, k, versions[k], {"cycle": k})
    flight = os.path.join(tmp, f"flight_{backend}.jsonl")
    rng = np.random.default_rng(25)
    s0, r0 = _csr_to_coo(indptr, indices)
    dels = rng.choice(s0.size, LIVE_SWAPS * LIVE_STREAM[1], replace=False)
    seeds = iter(np.resize(seeds, 2 * LIVE_SWAPS * LIVE_BURST))
    with cluster_server(dev, "gcn", FULL, params, indptr, indices, store,
                        backend, tracing=True, metrics_port=0,
                        telemetry_jsonl=flight) as srv:
        srv.warmup()
        builds = srv.steps.builds
        plan_builds = compute.bucket_plan_cache_info()["builds"]
        srv.reset_stats()
        stream = GraphStream(srv, parity_every=1, max_pending=384)
        kernels = ops_kernels() + (spmm_q8_kernel(),)
        zero_counts(kernels)
        reqs, swaps, windows, scrape = [], [], [], None
        t0 = time.perf_counter()
        for k in range(1, LIVE_SWAPS + 1):
            reqs += srv.submit_many([[int(next(seeds))]
                                     for _ in range(LIVE_BURST)])
            swaps.append(hot_swap(srv, ckpt, step=k))
            # the lane gauges come from the telemetry monitor's ticks, whose
            # first may not have run this soon after warm-up: scrape again
            # in a later cycle until one shows the lanes
            if scrape is None or not scrape["lanes"]:
                scrape = neurascope.scrape_panels(srv._metrics_server.url)
            t_mut = srv.clock()
            for _ in range(LIVE_STREAM[0]):
                stream.insert(int(rng.integers(0, 2708)),
                              int(rng.integers(0, 2708)))
            for j in dels[(k - 1) * LIVE_STREAM[1]:k * LIVE_STREAM[1]]:
                stream.delete(int(s0[j]), int(r0[j]))
            stream.flush()
            windows.append((t_mut, srv.clock()))
            reqs += srv.submit_many([[int(next(seeds))]
                                     for _ in range(LIVE_BURST)])
        srv.drain(timeout=300)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts(kernels)
        st = srv.stats()
        flushes = stream.flushes
        rounds = st["n_rounds"]
        check(served_once(reqs), f"{name}: a request did not settle exactly "
                                 "once with a result")
        check(all(r.params_version in range(LIVE_SWAPS + 1) for r in reqs),
              f"{name}: a request without one version in [0, 3]")
        check(srv.retired_versions() == [] and srv.params_version
              == LIVE_SWAPS and all(w.drained_old for w in swaps),
              f"{name}: retired {srv.retired_versions()}, version "
              f"{srv.params_version}")
        check(len(flushes) == LIVE_SWAPS
              and all(f.parity_ok is True for f in flushes),
              f"{name}: flush parity {[f.parity_ok for f in flushes]}")
        epochs = sorted({r.graph_epoch for r in reqs})
        check(len(epochs) >= 2, f"{name}: graph epochs served {epochs}")
        check(srv.steps.builds == builds
              and compute.bucket_plan_cache_info()["builds"] == plan_builds,
              f"{name}: a step or plan built during the swaps and flushes")
        # 2 a round; each swap's shadow warm-up is one dummy round too
        want = {spmm: 2 * (rounds + LIVE_SWAPS), "forest_sample": 0,
                "hash_draws": 0}
        if backend == "cuda_q8":
            want["spmm_dedup_chunks"] = 0
        got = {k: launches[k] for k in want}
        check(got == want, f"{name}: launches {got} for {rounds} rounds "
                           f"and {LIVE_SWAPS} warm-ups, expected {want}")
        check(all(math.isfinite(w.blackout_ms) for w in swaps),
              f"{name}: a flip saw no traffic "
              f"({[w.blackout_ms for w in swaps]})")
        live = live_replayable(reqs, srv, flushes)[:CLUSTER_REPLAYED]
        check(bool(live), f"{name}: no request on the live version and "
                          "epoch")
        err = float(max(np.abs(r.result - srv.offline_replay(r)).max()
                        for r in live))
        check(err <= tol, f"{name}: replay {err:.3e} > {tol}")
        own = {v: replay_on_version(
            srv, [r for r in reqs if r.params_version == v][:16],
            versions[v], tol) for v in sorted({r.params_version
                                               for r in reqs})}
        check(scrape is not None and len(scrape["lanes"]) == CLUSTER_LANES,
              f"{name}: the /metrics scrape shows lanes "
              f"{sorted(scrape['lanes']) if scrape else None}")
        wait, warm_wait = pending_gaps_ms(
            srv, [(w.t_flip - w.validate_s - w.warm_s, w.t_flip)
                  for w in swaps])
        mutation_wait = pending_gaps_ms(srv, windows)[1]
        bl = [w.blackout_ms for w in swaps]
        out = dict(
            backend=backend, requests=len(reqs), req_per_s=len(reqs) / dt,
            p50_ms=st["p50_ms"], p99_ms=st["p99_ms"], rounds=rounds,
            launches={spmm: launches[spmm], "warmup_rounds": LIVE_SWAPS},
            versions_served=sorted({r.params_version for r in reqs}),
            epochs_served=epochs, replayed=len(live), replay_max_abs=err,
            own_version_replay=own,
            validate_s=[w.validate_s for w in swaps],
            warm_s=[w.warm_s for w in swaps], blackout_ms=bl,
            blackout_ms_median=med(bl), blackout_ms_max=max(bl),
            repack_s=[f.repack_s for f in flushes],
            staleness_s=[f.staleness_s for f in flushes],
            flushes=[dict(epoch=f.epoch, inserted=f.inserted,
                          deleted=f.deleted, dirty=f.dirty_blocks,
                          clean=f.clean_blocks, n_edges=f.n_edges)
                     for f in flushes],
            pending_wait_ms_median=wait, swap_pending_wait_ms=warm_wait,
            mutation_pending_wait_ms=mutation_wait,
            scraped_lanes=len(scrape["lanes"]))
        if aborts:
            out["aborts"] = live_aborts(srv, stream, ckpt, params, tol)
        n_flushes = len(stream.flushes)        # the aborts' idle one too
    recs, meta = neurascope.load_flight(flight)
    events = [e.get("event") for e in recs["event"]]
    check(events.count("params_swap") == LIVE_SWAPS
          and events.count("graph_flush") == n_flushes,
          f"{name}: flight recorder events params_swap "
          f"{events.count('params_swap')}, graph_flush "
          f"{events.count('graph_flush')} for {n_flushes} flushes")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        n_bad = neurascope.check(recs, meta)
        neurascope.summarize(recs, meta)
    check(n_bad == 0, f"{name}: neurascope check: {buf.getvalue()[:2000]}")
    report = os.path.join(tmp, f"neurascope_{backend}.html")
    with open(report, "w") as f:
        f.write(neurascope.render_html(recs, meta, []))
    out["neurascope"] = dict(records=sum(len(v) for v in recs.values()),
                             traces=len(recs["trace"]),
                             html_bytes=os.path.getsize(report),
                             summary=buf.getvalue().splitlines()[1:4])
    say(f"live {json.dumps(out)}")
    return out


def live_aborts(srv, stream, ckpt, params, tol):
    """The abort paths on a live server — a torn checkpoint, a tree of the
    wrong shape, deleting an absent edge — each leaving the version and
    the graph as they were, with a following burst served and equal to
    replay; then 64 feature rows re-homed and 64 requests replayed against
    the patched store."""
    from repro_torch.checkpoint import store as ckpt_store
    from repro_torch.serve import GraphMutationError, HotSwapError, hot_swap
    rng = np.random.default_rng(26)
    out = {}

    def state():
        return dict(version=srv.params_version, indptr=srv.indptr.copy(),
                    indices=srv.indices.copy(), epoch=stream.delta.epoch,
                    pending=stream.pending, retired=srv.retired_versions())

    def after(what, before):
        now = state()
        changed = [k for k, v in before.items()
                   if not (np.array_equal(v, now[k])
                           if isinstance(v, np.ndarray) else v == now[k])]
        check(not changed, f"abort {what}: the server changed ({changed})")
        reqs = srv.submit_many([[int(s)] for s in
                                rng.integers(0, 2708, LIVE_ABORT_BURST)])
        srv.drain(timeout=120)
        err = float(max(np.abs(r.result - srv.offline_replay(r)).max()
                        for r in reqs))
        check(served_once(reqs) and err <= tol,
              f"abort {what}: replay {err:.3e} > {tol}")
        out[what] = err

    before = state()
    torn = os.path.join(ckpt, "step_000004")
    shutil.copytree(os.path.join(ckpt, "step_000003"), torn)
    os.remove(os.path.join(torn, "COMMIT"))
    stage = None
    try:
        hot_swap(srv, ckpt, step=4)
    except HotSwapError as exc:
        stage = exc.stage
    check(stage == "validate", f"torn checkpoint: HotSwapError stage {stage}")
    after("torn_checkpoint", before)
    before = state()
    ckpt_store.save(ckpt, 5, {k: {n: torch.zeros(3, 3) for n in v}
                              for k, v in params.items()})
    stage = None
    try:
        hot_swap(srv, ckpt, step=5)
    except HotSwapError as exc:
        stage = exc.stage
    check(stage == "validate", f"wrong-shape tree: HotSwapError stage "
                               f"{stage}")
    after("wrong_shape", before)
    before = state()
    row = int(np.argmax(np.diff(srv.indptr)))
    have = set(srv.indices[srv.indptr[row]:srv.indptr[row + 1]].tolist())
    absent = next(s for s in range(2708) if s not in have)
    raised = False
    try:
        stream.delete(absent, row)
    except GraphMutationError:
        raised = True
    check(raised, "deleting an absent edge did not raise "
                  "GraphMutationError")
    after("absent_edge", before)
    rows = np.sort(rng.choice(2708, 64, replace=False))
    new = rng.normal(size=(64, srv.store.x.shape[1])).astype(np.float32)
    stream.update_features(rows, new)
    check(torch.equal(srv.store.x[torch.from_numpy(rows).to(srv.device)]
                      .cpu(), torch.from_numpy(new)),
          "feature rows not re-homed")
    reqs = srv.submit_many([[int(s)] for s in rows])
    srv.drain(timeout=120)
    err = float(max(np.abs(r.result - srv.offline_replay(r)).max()
                    for r in reqs))
    check(served_once(reqs) and err <= tol,
          f"feature rows: replay {err:.3e} > {tol}")
    out["feature_rows"] = err
    # the same work on the idle server: a checkpoint's restore and a flush
    # of one cycle's mutations, against their times under traffic
    t0 = time.perf_counter()
    ckpt_store.restore(ckpt, 3, like_tree=srv.params)
    out["idle_validate_s"] = time.perf_counter() - t0
    for _ in range(sum(LIVE_STREAM)):
        stream.insert(int(rng.integers(0, 2708)), int(rng.integers(0, 2708)))
    out["idle_repack_s"] = stream.flush().repack_s
    return out


def phase_live(dev, params, indptr, indices, store, x_table):
    """Phase 19: incremental plans and B1/B4 on them, a full-width gcn-cora
    forward on the mutated graph, the mutation drill on ``cuda`` and
    ``cuda_q8`` (abort paths and feature rows on ``cuda``) and NeuraScope
    on each drill's recorder."""
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.models.gnn import gcn
    out = {"delta": [], "kernels": []}
    for name, s, r, n, w, dims, rng in delta_worlds():
        rec, kernels, p_inc, p_cold = delta_case(dev, name, s, r, n, w, dims,
                                                 rng)
        out["delta"].append(rec)
        out["kernels"] += kernels
        if name == "cora":
            plans = (p_inc, p_cold)
    x = torch.from_numpy(x_table).to(dev)
    kernels = conv_kernels()
    zero_counts(kernels)
    for backend in ("cuda", "cuda_q8"):
        with torch.no_grad():
            y_inc, y_cold = (gcn.forward(params, FULL, x, backend=backend,
                                         plan=p) for p in plans)
        check(tuple(y_inc.shape) == (2709, FULL.n_classes)
              and bool(torch.isfinite(y_inc).all()),
              f"mutated forward {backend}: malformed")
        check(torch.equal(y_inc, y_cold), f"mutated forward {backend}: the "
              "incremental plan's forward is not the cold plan's bitwise")
    fwd = read_counts(kernels)
    # two forwards a backend, two aggregations each; cuda_q8 runs B4 alone
    check(fwd["spmm_dedup_chunks"] == 4 and fwd["spmm_dedup_chunks_q8"] == 4,
          f"mutated forward launches {fwd}")
    out["forward"] = dict(cuda="bitwise", cuda_q8="bitwise", launches=fwd)
    say(f"live forward {json.dumps(out['forward'])}")
    seeds = np.random.default_rng(2).integers(0, 2708, CLUSTER_REQUESTS)
    with tempfile.TemporaryDirectory() as tmp:
        out["drill"] = [live_drill(dev, params, indptr, indices, store,
                                   backend, tmp, seeds, backend == "cuda")
                        for backend in ("cuda", "cuda_q8")]
    out["launches"] = {
        k: fwd[k] + sum(dr["launches"].get(k, 0) for dr in out["drill"])
        for k in ("spmm_dedup_chunks", "spmm_dedup_chunks_q8")}
    return out


# ---------------------------------------------------------------------------
# phase 20 — the LM family: qwen3-0.6b at full width
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_PREFILL = (1, 4096)             # train_4k's length, batch cut from 256
LM_F32_LAYERS = 4                  # the f32 flash-vs-blocked depth
LM_SERVE = dict(requests=16, slots=8, prompt=(64, 512), gen=(32, 64))
LM_REDUCED_SERVE = dict(requests=16, slots=8, prompt=(8, 40), gen=(5, 20))
LM_TRAIN = dict(batch=2, seq=2048, steps=8, ckpt_every=4, lr=1e-3)
LM_CPU_CHECK = dict(layers=2, batch=1, seq=256)
# bars.  bf16 flash vs blocked: the two round P to bf16 after other
# running maxima (B8's 128-key tiles, the blocked attention's 1024-key
# chunks), one bf16 ulp (2⁻⁷) in some outputs a layer, carried through 28
# layers: logits within 5% of their largest magnitude, at the last token
# and at every position of a forward, and the same top-1 token at 85% of
# a forward's positions (an H100 reads 2.6% and 95.3%).  f32 at depth 4:
# B8's own bar is 2e-5 a call.
LM_BF16_REL = 5e-2
LM_BF16_TOP1 = 0.85
LM_F32_REL = 1e-4
# a served token's logit in a teacher-forced forward lies within twice the
# flash-vs-blocked bar of that position's maximum
LM_SERVE_SLACK = 2 * LM_BF16_REL
LM_LOSS_RTOL = 1e-4
LM_FIRST_LOSS_TOL = 0.5            # ln V ± this at random initialization


def lm_config(arch=LM_ARCH, **changes):
    """``arch``'s FULL config (qwen3-0.6b's: repro configs/qwen3_0_6b.py)
    with ``changes``."""
    import dataclasses
    from repro_torch.configs import registry
    return dataclasses.replace(registry.get_config(arch), **changes)


def lm_params(cfg, dev, seed=0):
    from repro_torch.models.lm import transformer as T
    return T.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)


def lm_tokens(dev, b, s, vocab, seed):
    from repro_torch.data.synthetic import token_batch
    return torch.from_numpy(token_batch(b, s, vocab, seed=seed)).to(dev)


def lm_b8_bound_ms(cfg, b, s) -> float:
    """B8's least time for one layer's causal attention at (b, s): q·k and
    p·v over the causal pairs, 2·BH·d·S(S+1) flops at the bf16 peak (its
    bytes take less: 4·BH·S·d·2 B at 3.35 TB/s)."""
    bh, d = b * cfg.n_heads, cfg.head_dim
    n_flops = 2 * bh * d * s * (s + 1)
    n_bytes = 4 * bh * s * d * 2
    return max(n_flops / BF16_FLOPS_PER_S, n_bytes / HBM_BYTES_PER_S) * 1e3


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def lm_prefill_checks(dev, cfg, params) -> dict:
    """FULL bf16 prefill at S = 4096 with B8 (counted: n_layers launches)
    against the blocked attention on the same inputs; the top-1 token at
    every position of a flash and a blocked forward; then the f32 check at
    FULL widths with the depth cut to ``LM_F32_LAYERS``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.lm import transformer as T
    b, s = LM_PREFILL
    toks = lm_tokens(dev, b, s, cfg.vocab, seed=20)
    rec = dict(shape=f"{cfg.name} prefill B={b} S={s} bf16")
    with torch.no_grad():
        flash_attention.launches = 0
        logits, cache = T.prefill(params, cfg, toks, attention="flash")
        torch.cuda.synchronize()
        rec["launches"] = flash_attention.launches
        check(rec["launches"] == cfg.n_layers,
              f"lm prefill: {rec['launches']} B8 launches, expected "
              f"{cfg.n_layers}")
        kv = cache["sub0"]["k"]
        check(tuple(logits.shape) == (b, cfg.vocab)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all())
              and tuple(kv.shape) == (cfg.n_super, b, s, cfg.n_kv_heads,
                                      cfg.head_dim)
              and kv.dtype == cfg.adt, "lm prefill: malformed output")
        want, want_cache = T.prefill(params, cfg, toks, attention="blocked")
        rec["last_logits_rel"] = rel_err(logits, want)
        rec["cache_rel"] = max(rel_err(cache["sub0"][n],
                                       want_cache["sub0"][n])
                               for n in ("k", "v"))
        check(rec["last_logits_rel"] <= LM_BF16_REL,
              f"lm prefill bf16: flash vs blocked "
              f"{rec['last_logits_rel']:.3e} of max|logits| > "
              f"{LM_BF16_REL}")
        del cache, want_cache
        flash_attention.launches = 0
        h = T.forward(params, cfg, toks, attention="flash")
        torch.cuda.synchronize()
        rec["forward_launches"] = flash_attention.launches
        check(rec["forward_launches"] == cfg.n_layers,
              f"lm forward: {rec['forward_launches']} B8 launches")
        hb = T.forward(params, cfg, toks, attention="blocked")
        w = T.unembed_matrix(params, cfg)
        lf, lb = (h[0] @ w).float(), (hb[0] @ w).float()
        del h, hb
        rec["top1_agreement"] = float(
            (lf.argmax(-1) == lb.argmax(-1)).float().mean())
        rec["all_positions_rel"] = float(
            ((lf - lb).abs().amax(-1) / lb.abs().amax(-1)).max())
        del lf, lb
        check(rec["top1_agreement"] >= LM_BF16_TOP1
              and rec["all_positions_rel"] <= LM_BF16_REL,
              f"lm forward bf16: top-1 agreement {rec['top1_agreement']} "
              f"(bar {LM_BF16_TOP1}), logits at every position within "
              f"{rec['all_positions_rel']:.3e} of max|logits| (bar "
              f"{LM_BF16_REL})")
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=LM_F32_LAYERS,
                                param_dtype="float32", act_dtype="float32")
    p32 = lm_params(cfg32, dev, seed=1)
    with torch.no_grad():
        flash_attention.launches = 0
        got, _ = T.prefill(p32, cfg32, toks, attention="flash")
        torch.cuda.synchronize()
        rec["f32_launches"] = flash_attention.launches
        want, _ = T.prefill(p32, cfg32, toks, attention="blocked")
    scale = max(1.0, float(want.abs().max()))
    rec["f32_rel"] = float((got - want).abs().max()) / scale
    check(rec["f32_launches"] == LM_F32_LAYERS
          and rec["f32_rel"] <= LM_F32_REL,
          f"lm prefill f32 depth {LM_F32_LAYERS}: {rec['f32_launches']} "
          f"launches, flash vs blocked {rec['f32_rel']:.3e}")
    del p32
    torch.cuda.empty_cache()
    return rec


def lm_requests(cfg, spec, seed):
    """``spec["requests"]`` requests with prompt and generation lengths
    drawn from ``spec``'s ranges, prompts from ``token_batch``."""
    from repro_torch.data.synthetic import token_batch
    from repro_torch.train.serving import Request
    rng = np.random.default_rng(seed)
    plen = rng.integers(spec["prompt"][0], spec["prompt"][1] + 1,
                        spec["requests"])
    glen = rng.integers(spec["gen"][0], spec["gen"][1] + 1, spec["requests"])
    return [Request(rid=i, prompt=token_batch(1, int(p), cfg.vocab,
                                              seed=seed + i)[0],
                    max_new=int(g)) for i, (p, g) in enumerate(zip(plen,
                                                                   glen))]


def lm_offline(params, cfg, req, s_max, dev, served=None):
    """One request decoded alone: prefill, its KV at the front of a fresh
    one-row cache, then ``decode_step`` a token at a time; with ``served``
    (the tokens a batcher gave it) it stops at the first token that
    differs, as the rest can no longer be equal."""
    from repro_torch import tree
    from repro_torch.models.lm import transformer as T
    with torch.no_grad():
        logits, kv = T.prefill(params, cfg, torch.from_numpy(
            req.prompt[None]).to(dev))
        cache = T.init_cache(cfg, 1, s_max, device=dev)
        p = req.prompt.shape[0]
        for dst, src in zip(tree.leaves(cache), tree.leaves(kv)):
            dst[:, :, :p] = src
        toks = [int(torch.argmax(logits[0]))]
        for pos in range(p, p + req.max_new - 1):
            if served is not None and toks[-1] != served[len(toks) - 1]:
                break
            logits, cache = T.decode_step(
                params, cfg, torch.tensor([[toks[-1]]], dtype=torch.int32,
                                          device=dev), cache, pos)
            toks.append(int(torch.argmax(logits[0])))
    return toks


def lm_serve(dev, cfg, params, spec, seed):
    """``ContinuousBatcher`` through ``launch/serve.build_engine`` (B8
    prefill, ragged decode): every request served, counted (n_layers B8 a
    request), and each served prefill (its prompt, logits and KV) kept for
    ``lm_served_prefills``."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import build_engine
    reqs = lm_requests(cfg, spec, seed)
    s_max = spec["prompt"][1] + spec["gen"][1] + 1
    eng = build_engine(params, cfg, spec["slots"], s_max)
    served, prefill = [], eng.prefill_fn

    def kept_prefill(tokens):
        out = prefill(tokens)
        served.append((tokens, *out))
        return out
    eng.prefill_fn = kept_prefill
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.active or eng.queue:
        eng.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    n_tok = sum(len(r.out) for r in reqs)
    check(all(r.done and len(r.out) == r.max_new for r in reqs)
          and all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          f"lm serve {cfg.name}: a request did not finish whole")
    check(launches == cfg.n_layers * len(reqs),
          f"lm serve {cfg.name}: {launches} B8 launches for {len(reqs)} "
          f"prefills of {cfg.n_layers} layers")
    return reqs, s_max, served, dict(
        requests=len(reqs), slots=spec["slots"], engine_steps=steps,
        tokens=n_tok, wall_s=wall, tok_s=n_tok / wall, launches=launches)


def lm_served_prefills(cfg, params, served, bar) -> dict:
    """Each served (B8) prefill against a blocked prefill of the same
    prompt: last-token logits and every cache leaf, relative to their
    largest magnitude, within ``bar``; and, a reading, how many equal a
    second B8 prefill of the prompt bit for bit."""
    from repro_torch import tree
    from repro_torch.models.lm import transformer as T
    logits_rel = cache_rel = 0.0
    rerun_bitwise = 0
    with torch.no_grad():
        for tokens, logits, kv in served:
            want, want_kv = T.prefill(params, cfg, tokens,
                                      attention="blocked")
            logits_rel = max(logits_rel, rel_err(logits, want))
            cache_rel = max(cache_rel, max(
                rel_err(a, b) for a, b in zip(tree.leaves(kv),
                                              tree.leaves(want_kv))))
            again, again_kv = T.prefill(params, cfg, tokens)
            rerun_bitwise += bool(torch.equal(again, logits) and all(
                torch.equal(a, b) for a, b in zip(tree.leaves(kv),
                                                  tree.leaves(again_kv))))
    check(logits_rel <= bar and cache_rel <= bar,
          f"lm serve {cfg.name}: a served prefill's logits {logits_rel:.3e}"
          f", cache {cache_rel:.3e} of their largest magnitude from a "
          f"blocked prefill (bar {bar})")
    return dict(prefill_logits_rel=logits_rel, prefill_cache_rel=cache_rel,
                prefill_rerun_bitwise=rerun_bitwise,
                prefill_lengths=sorted(int(t.shape[1]) for t, *_ in served))


def lm_teacher_forced(dev, cfg, params, reqs) -> float:
    """The largest, over every served token, of (the position's maximum
    logit − the served token's) ÷ the position's largest |logit|, in a
    blocked forward over prompt + output: the served tokens, from B8
    prefills, held against the plain attention."""
    from repro_torch.models.lm import transformer as T
    worst = 0.0
    w = T.unembed_matrix(params, cfg)
    with torch.no_grad():
        for r in reqs:
            seq = np.concatenate([r.prompt, np.asarray(r.out[:-1],
                                                       np.int32)])
            h = T.forward(params, cfg, torch.from_numpy(seq[None]).to(dev),
                          attention="blocked")
            p = r.prompt.shape[0]
            rows = (h[0, p - 1:] @ w).float()
            served = torch.tensor(r.out, device=dev)[:, None]
            gap = rows.amax(-1) - rows.gather(1, served)[:, 0]
            worst = max(worst, float((gap / rows.abs().amax(-1)).max()))
    return worst


def lm_batch_rounding(dev, cfg, params, reqs, s_max, steps=32) -> dict:
    """Where served and offline bf16 decode part (a reading): ``reqs[0]``
    greedily decoded from its prefill through ``decode_step`` at batch 1
    (offline), ``decode_step_ragged`` at batch 1, as row 0 of 8 copies of
    itself, and as row 0 of a batch with ``reqs[1:8]`` in the other rows,
    each at its own position (a served batch).  For each variant against
    ``decode_step_ragged`` at batch 1: the largest logit gap at the first
    decode step and the first step whose token differs (None: none in
    ``steps``); and the unembedding GEMM's row 0 at 8 rows against the
    same row alone."""
    from repro_torch import tree
    from repro_torch.models.lm import transformer as T
    pre = []
    with torch.no_grad():
        for r in reqs[:8]:
            logits, kv = T.prefill(params, cfg, torch.from_numpy(
                r.prompt[None]).to(dev))
            pre.append((r.prompt.shape[0], kv, int(torch.argmax(logits[0]))))
        # every write inside the cache
        steps = min(steps, s_max - 1 - max(p for p, _, _ in pre))

        def greedy(rows, ragged):
            cache = T.init_cache(cfg, len(rows), s_max, device=dev)
            for j, k in enumerate(rows):
                p, kv, _ = pre[k]
                for dst, src in zip(tree.leaves(cache), tree.leaves(kv)):
                    dst[:, j:j + 1, :p] = src
            start = torch.tensor([pre[k][0] for k in rows], dtype=torch.int32,
                                 device=dev)
            toks = torch.tensor([[pre[k][2]] for k in rows],
                                dtype=torch.int32, device=dev)
            out, first_logits = [], None
            for i in range(steps):
                if ragged:
                    lg, cache = T.decode_step_ragged(params, cfg, toks, cache,
                                                     start + i)
                else:
                    lg, cache = T.decode_step(params, cfg, toks, cache,
                                              pre[0][0] + i)
                if first_logits is None:
                    first_logits = lg[0].float().clone()
                toks = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
                out.append(int(toks[0, 0]))
            return out, first_logits

        def parting(a, b):
            differ = [i for i, (x, y) in enumerate(zip(a[0], b[0])) if x != y]
            return dict(first_step_logits_max_abs=float(
                (a[1] - b[1]).abs().max()),
                first_differing_step=differ[0] if differ else None)
        solo = greedy([0], True)
        rec = dict(request=reqs[0].rid, prompt=pre[0][0], steps=steps,
                   fixed1=parting(greedy([0], False), solo),
                   copies8=parting(greedy([0] * 8, True), solo),
                   mixed8=parting(greedy(list(range(len(pre))), True), solo))
        x = torch.randn(8, cfg.d_model, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(25)
                        ).to(cfg.adt)
        w = T.unembed_matrix(params, cfg)
        row8, row1 = (x @ w)[0], (x[:1] @ w)[0]
    rec.update(gemm_row_equal=bool(torch.equal(row8, row1)),
               gemm_row_max_abs=float((row8.float() - row1.float())
                                      .abs().max()))
    return rec


def lm_serving(dev, cfg, params, arch=LM_ARCH, offline=True) -> dict:
    """FULL bf16 serving on 8 slots (every request finished, each served
    prefill held against a blocked one, the served tokens held
    teacher-forced, with ``offline`` equality with offline decode a
    reading beside where batch 1 and batch 8 part), then the arch's
    reduced config (``arch``'s) in f32 held token for token against
    offline decode."""
    from repro_torch.configs import registry
    reqs, s_max, served, rec = lm_serve(dev, cfg, params, LM_SERVE,
                                        seed=200)
    rec.update(lm_served_prefills(cfg, params, served, LM_BF16_REL))
    del served
    rec["teacher_forced_gap"] = lm_teacher_forced(dev, cfg, params, reqs)
    check(rec["teacher_forced_gap"] <= LM_SERVE_SLACK,
          f"lm serve: a served token's logit {rec['teacher_forced_gap']:.3e}"
          f" of the row's max|logit| below the maximum > {LM_SERVE_SLACK}")
    if offline:
        rec.update(lm_offline_readings(dev, cfg, params, reqs, s_max))
    small = registry.get_config(arch, reduced=True)
    sp = lm_params(small, dev, seed=3)
    sreqs, s_smax, served, srec = lm_serve(dev, small, sp, LM_REDUCED_SERVE,
                                           seed=300)
    srec.update(lm_served_prefills(small, sp, served, LM_F32_REL))
    del served
    srec["equal_offline"] = sum(
        r.out == lm_offline(sp, small, r, s_smax, dev) for r in sreqs)
    check(srec["equal_offline"] == len(sreqs),
          f"lm serve reduced f32: {srec['equal_offline']} of {len(sreqs)} "
          "requests equal offline decode")
    rec["reduced_f32"] = srec
    return rec


def lm_offline_readings(dev, cfg, params, reqs, s_max) -> dict:
    """Served tokens against offline decode (a reading): how many requests
    equal it, each one's agreeing prefix, and where one request's tokens
    part at batch 1 and 8."""
    rec = {}
    t0 = time.perf_counter()
    agree = [lm_offline(params, cfg, r, s_max, dev, served=r.out)
             for r in reqs]
    rec["equal_offline"] = sum(a == r.out for a, r in zip(agree, reqs))
    # tokens served before the first that offline decode does not give
    rec["offline_agreeing_prefix"] = [
        len(a) - (a != r.out[:len(a)]) for a, r in zip(agree, reqs)]
    rec["offline_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the request whose tokens part from offline decode first, in row 0
    first = int(np.argmin(rec["offline_agreeing_prefix"]))
    rec["batch_rounding"] = lm_batch_rounding(
        dev, cfg, params, [reqs[first]] + reqs[:first] + reqs[first + 1:],
        s_max)
    rec["batch_rounding_s"] = time.perf_counter() - t0
    return rec


def lm_train_job(dev, cfg, ckpt_dir, seed=0):
    """qwen3 FULL through ``build_lm_step`` and ``train.loop.run``: AdamW
    (f32 moments) at ``LM_TRAIN``'s lr on one repeated token batch,
    committing every ``ckpt_every`` steps."""
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    params = lm_params(cfg, dev, seed)
    step = build_lm_step(cfg, LMShape("train", "train", s, b),
                         adamw.AdamWConfig(lr=LM_TRAIN["lr"]))
    batch = {"tokens": lm_tokens(dev, b, s, cfg.vocab, seed=21)}

    def batches():
        while True:
            yield batch
    state = loop.TrainState(params=params, opt_state=adamw.init_state(params))
    return loop.run(state, step, batches(), loop.TrainLoopConfig(
        n_steps=LM_TRAIN["steps"], ckpt_every=LM_TRAIN["ckpt_every"],
        ckpt_dir=str(ckpt_dir), keep_ckpts=2, log_every=10 ** 9),
        log=lambda *_: None)


def lm_loss_and_grads(params, cfg, tokens):
    from repro_torch import tree
    from repro_torch.models.lm import transformer as T
    leaves, structure = tree.flatten(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = T.loss_fn(tree.unflatten(structure, live), cfg, tokens)
    return float(loss.detach()), torch.autograd.grad(loss, live)


def lm_training(dev, cfg) -> dict:
    """FULL bf16 training, 8 steps: the loss falls from near ln V, a run
    resumed from its step-4 commit is bitwise the unbroken run; then step
    1 on the card against the CPU at FULL widths, depth 2, f32."""
    from repro_torch.checkpoint import store
    rec = dict(batch=LM_TRAIN["batch"], seq=LM_TRAIN["seq"],
               steps=LM_TRAIN["steps"])
    k = LM_TRAIN["ckpt_every"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = lm_train_job(dev, cfg, tmp / "run")
        rec["run_s"] = time.perf_counter() - t0
        rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        state, hist = run
        losses = hist["loss"]
        rec["losses"] = losses
        rec["ln_vocab"] = math.log(cfg.vocab)
        check(all(math.isfinite(v) for v in losses) and hist["retries"] == 0
              and losses[-1] < losses[0]
              and abs(losses[0] - rec["ln_vocab"]) <= LM_FIRST_LOSS_TOL,
              f"lm train: losses {losses} (ln V {rec['ln_vocab']:.4f})")
        check(store.committed_steps(tmp / "run") == [k, LM_TRAIN["steps"]],
              f"lm train: commits {store.committed_steps(tmp / 'run')}")
        rec["commit_bytes"] = sum(
            f.stat().st_size for f in (tmp / "run" / f"step_{k:06d}")
            .iterdir())
        rec["step_wall_ms_loop"] = statistics.median(hist["step_s"]) * 1e3
        shutil.rmtree(tmp / "run" / f"step_{LM_TRAIN['steps']:06d}")
        t0 = time.perf_counter()
        resumed = lm_train_job(dev, cfg, tmp / "run")
        rec["resumed_s"] = time.perf_counter() - t0
        check(len(resumed[1]["loss"]) == LM_TRAIN["steps"] - k
              and same_run(resumed, run),
              f"lm train: the run resumed at step {k} does not reproduce "
              "the unbroken run bitwise")
        del resumed, run, state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rec.update(lm_train_breakdown(dev, cfg))
    rec["breakdown_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # step 1 on the card against the CPU: FULL widths, depth cut, f32
    c = LM_CPU_CHECK
    cfg32 = lm_config(n_layers=c["layers"], param_dtype="float32",
                      act_dtype="float32")
    params = lm_params(cfg32, dev, seed=2)
    toks = lm_tokens(dev, c["batch"], c["seq"], cfg32.vocab, seed=22)
    loss, grads = lm_loss_and_grads(params, cfg32, toks)
    cpu = torch.device("cpu")
    cpu_loss, cpu_grads = lm_loss_and_grads(tree_to(params, cpu), cfg32,
                                            toks.cpu())
    rec["cpu_loss_rel"] = abs(loss - cpu_loss) / abs(cpu_loss)
    worst = 0.0
    for g, gc_ in zip(grads, cpu_grads):
        excess = ((g.cpu() - gc_).abs() - 1e-3 * gc_.abs()).max()
        worst = max(worst, float(excess))
    rec["cpu_grad_excess"] = worst      # ≤ atol 1e-4 passes
    rec["cpu_check_s"] = time.perf_counter() - t0
    check(rec["cpu_loss_rel"] <= LM_LOSS_RTOL and worst <= 1e-4,
          f"lm train card vs CPU: loss {rec['cpu_loss_rel']:.3e} relative, "
          f"gradients {worst:.3e} past rtol 1e-3")
    return rec


def lm_train_breakdown(dev, cfg, n_steps: int = 1) -> dict:
    """One warm FULL bf16 training step (the step and its loss read back),
    traced: wall, device ms and operations, busy share, and its 8
    costliest device operations."""
    from repro_torch.configs.shapes import LMShape
    from repro_torch.launch.steps import build_lm_step
    from repro_torch.optim import adamw
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    params = lm_params(cfg, dev)
    opt = adamw.init_state(params)
    step = build_lm_step(cfg, LMShape("train", "train", s, b),
                         adamw.AdamWConfig(lr=LM_TRAIN["lr"]))
    batch = {"tokens": lm_tokens(dev, b, s, cfg.vocab, seed=21)}
    rec = trace_steps(lambda: float(step(params, opt, batch)[2]["loss"]),
                      n_steps, "flash_wgmma_kernel", top=8)
    rec.pop("kernel_ms_per_step")
    return {f"train_{k}": v for k, v in rec.items()}


def lm_readings(dev, cfg, params) -> dict:
    """Prefill at S = 4096 and an 8-slot decode step, traced: wall, device
    ms, B8's share and ms a call against its bound."""
    from repro_torch import tree
    from repro_torch.models.lm import transformer as T
    b, s = LM_PREFILL
    toks = lm_tokens(dev, b, s, cfg.vocab, seed=20)

    def prefill():
        with torch.no_grad():
            T.prefill(params, cfg, toks)
    pre = trace_steps(prefill, 2, "flash_wgmma_kernel")
    rec = dict(prefill_wall_ms=pre["step_wall_ms"],
               prefill_device_ms=pre["device_ms_per_step"],
               prefill_busy=pre["device_busy_share"],
               prefill_tok_s=b * s / pre["step_wall_ms"] * 1e3,
               b8_share=pre["kernel_ms_per_step"] / pre["device_ms_per_step"],
               b8_ms=pre["kernel_ms_per_step"] / cfg.n_layers,
               b8_bound_ms=lm_b8_bound_ms(cfg, b, s))
    rec["b8_bound_share"] = rec["b8_bound_ms"] / rec["b8_ms"]
    slots = LM_SERVE["slots"]
    s_max = LM_SERVE["prompt"][1] + LM_SERVE["gen"][1] + 1
    cache = T.init_cache(cfg, slots, s_max, device=dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    for leaf in tree.leaves(cache):
        leaf.normal_(generator=gen)
    positions = torch.arange(300, 300 + slots, device=dev)
    last = lm_tokens(dev, slots, 1, cfg.vocab, seed=24)

    def decode():
        with torch.no_grad():
            T.decode_step_ragged(params, cfg, last, cache, positions)
    dec = trace_steps(decode, 3, "flash_wgmma_kernel")
    rec.update(decode_wall_ms=dec["step_wall_ms"],
               decode_device_ms=dec["device_ms_per_step"],
               decode_ops=dec["device_ops_per_step"],
               decode_busy=dec["device_busy_share"],
               decode_tok_s=slots / dec["step_wall_ms"] * 1e3)
    return rec


def phase_lm(dev, before_training=None) -> dict:
    """Phase 20: qwen3-0.6b at FULL (28 layers, d 1024, 16 heads / 8 kv,
    head_dim 128, vocab 151,936, tied, bf16) with parameters drawn on the
    card: the prefill on B8 against the blocked attention, serving through
    the continuous batcher, training through ``build_lm_step`` and
    ``train.loop.run``, and the readings.  ``before_training`` (if given)
    is called once the serving readings are taken, before training."""
    from repro_torch.models.common import count_params
    cfg = lm_config()
    params = lm_params(cfg, dev)
    out = dict(arch=LM_ARCH, params=count_params(params))
    t = time.perf_counter()
    out["prefill"] = lm_prefill_checks(dev, cfg, params)
    say(f"lm prefill {json.dumps(out['prefill'])} "
        f"({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    out["serve"] = lm_serving(dev, cfg, params)
    say(f"lm serve {json.dumps(out['serve'])} "
        f"({time.perf_counter() - t:.1f} s)")
    t = time.perf_counter()
    out["readings"] = lm_readings(dev, cfg, params)
    say(f"lm readings {json.dumps(out['readings'])} "
        f"({time.perf_counter() - t:.1f} s)")
    del params
    torch.cuda.empty_cache()
    if before_training is not None:
        before_training()
    t = time.perf_counter()
    out["train"] = lm_training(dev, cfg)
    say(f"lm train {json.dumps(out['train'])} "
        f"({time.perf_counter() - t:.1f} s)")
    pre, srv = out["prefill"], out["serve"]
    out["launches"] = (pre["launches"] + pre["forward_launches"]
                       + pre["f32_launches"] + srv["launches"]
                       + srv["reduced_f32"]["launches"])
    return out


# ---------------------------------------------------------------------------
# phase 23 — gemma-7b at full width: B8 at head_dim 256
# ---------------------------------------------------------------------------

GEMMA_ARCH = "gemma-7b"


def gemma_attention(dev, cfg) -> list:
    """B8 at ``cfg``'s attention shape (B = 1, S = ``LM_PREFILL``'s, its
    heads and head_dim; MHA, so no repeat) in bf16 and f32, timed from a
    replayed graph beside its plain version, SDPA and its bound, and held
    against its f32 plain version (``flash_case``)."""
    b, s = LM_PREFILL
    gen = torch.Generator(device=dev).manual_seed(230)
    flat = [torch.randn((b * cfg.n_heads, s, cfg.head_dim), generator=gen,
                        device=dev) for _ in range(3)]
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        recs.append(flash_case(dtype, [t.to(dtype) for t in flat],
                               model=cfg.name))
        torch.cuda.empty_cache()
    return recs


def phase_gemma(dev) -> dict:
    """Phase 23: gemma-7b at FULL (28 layers, d 3072, 16 heads / 16 kv of
    head_dim 256, d_ff 24,576, GeGLU, vocab 256,000, tied, bf16) with
    parameters drawn on the card from seed 0: phase 20's prefill checks,
    serving (without the FULL model's offline-decode readings) and
    readings, then B8 at its attention shape in bf16 and f32."""
    from repro_torch.models.common import count_params
    cfg = lm_config(GEMMA_ARCH)
    params = lm_params(cfg, dev)
    out = dict(arch=GEMMA_ARCH, params=count_params(params))
    for name, fn in (
            ("prefill", lambda: lm_prefill_checks(dev, cfg, params)),
            ("serve", lambda: lm_serving(dev, cfg, params, arch=GEMMA_ARCH,
                                         offline=False)),
            ("readings", lambda: lm_readings(dev, cfg, params))):
        t = time.perf_counter()
        out[name] = fn()
        say(f"gemma {name} {json.dumps(out[name])} "
            f"({time.perf_counter() - t:.1f} s)")
    del params
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["b8"] = gemma_attention(dev, cfg)
    for rec in out["b8"]:
        say(f"gemma B8 {json.dumps(rec)}")
    say(f"gemma B8 at d = {cfg.head_dim} ({time.perf_counter() - t:.1f} s)")
    pre, srv = out["prefill"], out["serve"]
    out["launches"] = (pre["launches"] + pre["forward_launches"]
                       + pre["f32_launches"] + srv["launches"]
                       + srv["reduced_f32"]["launches"])
    return out


# ---------------------------------------------------------------------------
# phase 21 — A8c and A8d: NeuraSim, gradient compression, counted flops,
# the dry run
# ---------------------------------------------------------------------------

A8_CPU_GRAPHS = ("ca-CondMat", "email-Enron", "p2p-Gnutella31", "poisson3Da",
                 "facebook", "wiki-Vote", "scircuit", "m133-b3",
                 "cit-Patents")        # datasets.FAST_SET and the largest
A8_B2_GRAPHS = ("facebook", "wiki-Vote")
A8_UNITS = 32                          # Tile-16's NeuraMems
A8_HEADLINE = ("poisson3Da", "facebook", "wiki-Vote", "scircuit")
A8_COMPRESS_STEPS = 3
# leaves held bitwise against the CPU: the embedding, a stacked attention
# and an MLP leaf, and every leaf under a million elements
A8_COMPRESS_LEAVES = ("embed", "sub0.attn.wk", "sub0.mlp.wd")
# the long_500k cells: batch 1, the KV cache's sequence over all 256 ranks
# (the sequence-sharded decode), the MoE ones with the slot buffer split
# over dp; decode_32k: the batch over dp, the cache's sequence over model
A8_DRYRUN = (("qwen3-0.6b", "train_4k"), ("dlrm-rm2", "train_batch"),
             ("qwen3-0.6b", "long_500k"), ("gemma-7b", "long_500k"),
             ("grok-1-314b", "long_500k"),
             ("llama4-maverick-400b-a17b", "long_500k"),
             ("grok-1-314b", "decode_32k"))


def start_dryrun(out_dir: pathlib.Path):
    """Phase 21 (e)'s dry-run cells on the 16x16 fake world, and their
    unsharded counts, as host work in the background: ``launch.dryrun``'s
    own runner (``--jobs 8 --bound``: a process a cell and an (arch,
    shape), niced, one thread each; ~2.5 min for qwen3-0.6b × train_4k),
    itself at the lowest priority and in a process group of its own.  The
    script starts it with phase 20's training, which is device-bound, so
    that no serving reading of phases 17–20 runs beside it (the
    training's wall readings do)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    log = open(out_dir / "runner.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells",
         ",".join(f"{a}:{s}:pod" for a, s in A8_DRYRUN), "--jobs", "8",
         "--bound", "--out", str(out_dir)], stdout=log,
        stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        preexec_fn=lambda: os.nice(19), start_new_session=True)

    def stop():                         # the runner and every cell's job
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
    atexit.register(stop)               # a failing phase leaves none behind
    return proc, log, stop, out_dir, time.perf_counter()


def finish_dryrun(dryrun, timeout_s: float) -> dict:
    """Wait for the dry run's runner (stopping it and its jobs at the
    deadline) → each cell's readings from its ``sweep.json`` and records.
    Each cell must be ``ok`` and count per device between its unsharded
    count ÷ 256 (every operation split) and that count (every operation
    replicated); ``replication`` places it there: 1 when split perfectly,
    256 when replicated."""
    proc, log, stop, out_dir, t0 = dryrun
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        stop()
        proc.wait()
    log.close()
    sweep = out_dir / "sweep.json"
    check(sweep.exists(), f"dryrun: no sweep.json (exit {proc.returncode}), "
          f"log {(out_dir / 'runner.log').read_text()[-2000:]}")
    rows = {(r["arch"], r["shape"]): r
            for r in json.loads(sweep.read_text())["rows"]}
    out = dict(background_s=time.perf_counter() - t0)
    for arch, shape in A8_DRYRUN:
        key = f"{arch}×{shape}"
        r = rows.get((arch, shape), {})
        check(r.get("ok"), f"dryrun {key}: {r.get('status')} "
              f"{r.get('op')} at {r.get('where')}: {r.get('error')}")
        check(r.get("held"),
              f"dryrun {key}: {r['flops']:.4g} flops a device outside "
              f"[unsharded ÷ {r['n_devices']}, unsharded] (unsharded "
              f"{r.get('unsharded')})")
        rec = json.loads((out_dir / f"{arch}__{shape}__16x16.json")
                         .read_text())
        roof = rec["roofline"]
        out[key] = dict(
            trace_s=rec["trace_s"], n_ops=rec["n_ops"],
            **{k: roof[k] for k in ("flops", "bytes", "coll_bytes",
                                    "model_flops", "useful_ratio",
                                    "bottleneck")},
            unsharded_flops=r["unsharded"], replication=r["replication"],
            flops_by_op=rec["flops_by_op"],
            temp_bytes=rec["memory_analysis"]["temp_size_in_bytes"],
            argument_bytes=rec["memory_analysis"]["argument_size_in_bytes"],
            notes=rec["notes"])
    check(proc.returncode == 0, f"dryrun: runner exit {proc.returncode}")
    return out


def a8_neurasim(dev) -> dict:
    """(a) NeuraSim's statistics of the 20 Table-1 graphs on the card, held
    against the host's ``deg[cols].sum()`` and, for ``A8_CPU_GRAPHS``,
    against the same functions on the CPU; the model's GOP/s a config."""
    from repro_torch.neurasim import datasets, machine, model
    maps = ("ring", "modular", "random", "drhm")
    rec = dict(graphs={}, card_s=0.0, cpu_s=0.0, synth_s=0.0)
    gops = {c: {} for c in machine.CONFIGS}
    for name in datasets.TABLE1:
        t = time.perf_counter()
        s, r, n = datasets.synth(name)
        rec["synth_s"] += time.perf_counter() - t
        t = time.perf_counter()
        w = model.stats_from_coo(s, r, n, device=dev)
        loads = {m: model.mapping_loads(w.row_tags, A8_UNITS, m, device=dev)
                 for m in maps}
        sims = {c: model.simulate_spgemm(w, cfg)
                for c, cfg in machine.CONFIGS.items()}
        torch.cuda.synchronize()
        rec["card_s"] += time.perf_counter() - t
        pp = int(np.bincount(s, minlength=n)[r].sum())
        check(w.pp_interim == pp, f"neurasim {name}: pp_interim "
                                  f"{w.pp_interim} != deg[cols].sum() {pp}")
        g = dict(pp_interim=w.pp_interim, nnz_out=w.nnz_out,
                 **{f"{c}_gops": sims[c].gops for c in sims})
        if name in A8_CPU_GRAPHS:
            t = time.perf_counter()
            wc = model.stats_from_coo(s, r, n, device="cpu")
            same = (wc.nnz_out == w.nnz_out and torch.equal(
                wc.row_tags, w.row_tags.cpu()) and all(
                torch.equal(model.mapping_loads(wc.row_tags, A8_UNITS, m,
                                                device="cpu"),
                            loads[m].cpu()) for m in maps))
            rec["cpu_s"] += time.perf_counter() - t
            check(same, f"neurasim {name}: the card's stats differ from "
                        "the CPU's")
            g["cpu_equal"] = True
        for c in sims:
            gops[c][name] = sims[c].gops
        rec["graphs"][name] = g
    rec["mean_gops"] = {c: statistics.fmean(v.values())
                        for c, v in gops.items()}
    t16 = statistics.fmean(gops["tile16"][n] for n in A8_HEADLINE)
    rec["headline_tile16_gops"] = t16
    rec["vs_mkl"] = t16 / machine.PUBLISHED_GOPS["Xeon E5 (MKL)"]
    rec["vs_gamma"] = t16 / machine.PUBLISHED_GOPS["Gamma"]
    rec["paper"] = dict(vs_mkl=22.1, vs_gamma=1.5,
                        gops=machine.PAPER_NEURACHIP_GOPS)
    return rec


def a8_spgemm(dev) -> dict:
    """(b) A·A of ``A8_B2_GRAPHS`` through the ``cuda`` SpGEMM executor
    (B2), counted; C against B2's plain version, and the plan's counts
    against NeuraSim's."""
    from repro_torch.kernels.spgemm_pad import (spgemm_hashpad,
                                                spgemm_hashpad_compact_plain)
    from repro_torch.neurasim import datasets, model
    from repro_torch.sparse import backend as sb
    from repro_torch.sparse.spgemm import make_spgemm_plan
    rec = {}
    for name in A8_B2_GRAPHS:
        s, r, n = datasets.synth(name)
        w = np.random.default_rng(0).normal(size=s.size).astype(np.float32)
        t = time.perf_counter()
        zero_counts([spgemm_hashpad])
        plan = make_spgemm_plan(s, r, n, s, r, n, a_vals=w, b_vals=w,
                                executors=("cuda",), device=dev)
        c_vals = sb.spgemm(plan, backend="cuda")
        launches = read_counts([spgemm_hashpad])["spgemm_hashpad"]
        wall_s = time.perf_counter() - t
        args = (plan.ell_remaining, plan.ell_block_ptr, plan.ell_a,
                plan.cell_ptr, plan.cell_lane, plan.cell_bucket,
                plan.cell_val, plan.c_indptr, plan.out_bucket)
        kw = dict(block_rows=plan.block_rows, pad_width=plan.pad_width)
        plain = spgemm_hashpad_compact_plain(*args, **kw)
        err = float((c_vals - plain).abs().max())
        ws = model.stats_from_coo(s, r, n, device=dev)
        check(launches >= 1, f"B2 {name}: not launched on the path")
        check(err <= KERNEL_TOL, f"B2 {name}: max|kernel-plain| {err:.3e}")
        check(plan.pp_interim == ws.pp_interim
              and plan.nnz_out == ws.nnz_out == c_vals.numel(),
              f"B2 {name}: plan pp {plan.pp_interim} nnz {plan.nnz_out} "
              f"(C {c_vals.numel()}) vs NeuraSim {ws.pp_interim} "
              f"{ws.nnz_out}")
        rec[name] = dict(launches=launches, max_abs_err=err,
                         pp_interim=plan.pp_interim, nnz_out=plan.nnz_out,
                         build_and_numeric_s=wall_s)
    return rec


def a8_compression(dev) -> dict:
    """(c) ``error_feedback_compress`` over one backward's bf16 gradients of
    qwen3-0.6b FULL at ``LM_TRAIN``'s shape, ``A8_COMPRESS_STEPS`` steps on
    the card, timed, and the same steps on a CPU copy of the chosen
    leaves: decoded leaves and residuals bitwise equal."""
    from repro_torch import tree
    from repro_torch.optim import compression as C
    cfg = lm_config()
    params = lm_params(cfg, dev)
    names = tree_paths(params)
    toks = lm_tokens(dev, LM_TRAIN["batch"], LM_TRAIN["seq"], cfg.vocab,
                     seed=21)
    _, grads = lm_loss_and_grads(params, cfg, toks)
    del params
    grads = list(grads)
    keep = [i for i, (nm, g) in enumerate(zip(names, grads))
            if nm in A8_COMPRESS_LEAVES or g.numel() < 1_000_000]
    check(all(nm in [names[i] for i in keep] for nm in A8_COMPRESS_LEAVES),
          f"compression: leaves {A8_COMPRESS_LEAVES} not in {names}")
    cpu_g = [grads[i].cpu() for i in keep]
    res = C.init_residual(grads)
    ms = []
    card = []
    for _ in range(A8_COMPRESS_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dec, res = C.error_feedback_compress(grads, res)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        card.append([(dec[i].cpu(), res[i].cpu()) for i in keep])
    cpu_res = C.init_residual(cpu_g)
    t = time.perf_counter()
    for step in range(A8_COMPRESS_STEPS):
        dec_c, cpu_res = C.error_feedback_compress(cpu_g, cpu_res)
        for j, (d, r) in enumerate(card[step]):
            check(torch.equal(d, dec_c[j]) and torch.equal(r, cpu_res[j]),
                  f"compression step {step}: {names[keep[j]]} differs "
                  "from the CPU's")
    n = sum(g.numel() for g in grads)
    wire = C.wire_bytes(grads)
    return dict(leaves=len(grads), elements=n,
                checked_leaves=[names[i] for i in keep],
                checked_elements=sum(g.numel() for g in cpu_g),
                ms_per_call=ms, cpu_check_s=time.perf_counter() - t,
                wire_bytes=wire, vs_bf16=wire / (2 * n), vs_f32=wire / (4 * n))


def tree_paths(params) -> list:
    """Dotted key paths of a parameter tree's leaves, in leaf order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out.append(".".join(path))
    walk(params, ())
    return out


def flop_reading(name, step, args, host_step, host_args, model_flops,
                 device_ms, card) -> dict:
    """(d) one step counted under ``op_costs`` on the card, and the same
    step built on the host counted under ``FakeTensorMode`` (``host_args``
    gives its arguments; real host tensors it holds, such as a plan, are
    taken in as fake): flops equal; the useful ratio and the FLOP share
    of ``device_ms`` (the step's device time, traced by its own phase in
    this run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch import tree
    from repro_torch.launch.analysis import PEAK_FLOPS_BF16, PEAK_FLOPS_F32
    from repro_torch.launch.op_costs import OpCosts
    with OpCosts() as on_card:
        step(*args)
    torch.cuda.synchronize()
    metas = [tree.map_leaves(tree.meta_like, x) for x in host_args]
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = [tree.map_leaves(
            lambda t: torch.empty(t.shape, dtype=t.dtype), x) for x in metas]
        with OpCosts() as on_host:
            host_step(*fake)
    check(on_card.flops == on_host.flops,
          f"flops {name}: card {on_card.flops:.6e} != fake "
          f"{on_host.flops:.6e}")
    s = device_ms / 1e3
    return dict(counted_flops=on_card.flops, fake_flops=on_host.flops,
                counted_bytes=on_card.bytes, fake_bytes=on_host.bytes,
                model_flops=model_flops,
                useful_ratio=model_flops / on_card.flops,
                device_ms=device_ms,
                tflops_per_s=model_flops / s / 1e12,
                share_bf16_peak=model_flops / (s * PEAK_FLOPS_BF16),
                share_f32_peak=model_flops / (s * PEAK_FLOPS_F32),
                card=card)


def a8_flops(dev, device_ms: dict, card: str) -> dict:
    """(d) counted flops of three training steps: qwen3-0.6b FULL at
    ``LM_TRAIN``'s shape (phase 20), gcn-cora FULL on ``dense`` (phase
    13) and dlrm-rm2 at ``train_batch`` with phase 15's capped
    vocabularies."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import GNNShape, LMShape, RECSYS_SHAPES
    from repro_torch.data.synthetic import dlrm_batch
    from repro_torch.launch import flops
    from repro_torch.launch.steps import build_lm_step, build_recsys_step
    from repro_torch.models.recsys import dlrm
    from repro_torch.optim import adamw
    out = {}
    cfg = lm_config()
    b, s = LM_TRAIN["batch"], LM_TRAIN["seq"]
    shape = LMShape("train", "train", s, b)
    params = lm_params(cfg, dev)
    step = build_lm_step(cfg, shape, adamw.AdamWConfig(lr=LM_TRAIN["lr"]))
    args = (params, adamw.init_state(params),
            {"tokens": lm_tokens(dev, b, s, cfg.vocab, seed=21)})
    out["qwen3-0.6b"] = flop_reading(
        "qwen3-0.6b", step, args, step, args,
        flops.model_flops("qwen3-0.6b", shape, cfg=cfg),
        device_ms["qwen3-0.6b"], card)
    del params, args
    torch.cuda.empty_cache()
    p, step, batches = train_setup(dev, "dense")
    batch = next(batches)
    p_cpu, step_cpu, batches_cpu = train_setup(torch.device("cpu"), "dense")
    n, e = batch["x"].shape[0], batch["senders"].shape[0]
    gshape = GNNShape("cora_train", "fullgraph", n_nodes=n - 1, n_edges=e,
                      d_feat=batch["x"].shape[1], n_classes=7)
    out["gcn-cora"] = flop_reading(
        "gcn-cora", step, (p, adamw.init_state(p), batch), step_cpu,
        (p_cpu, adamw.init_state(p_cpu), next(batches_cpu)),
        flops.model_flops("gcn-cora", gshape,
                          {"n_nodes_pad": n, "n_edges_pad": e},
                          cfg=registry.get_config("gcn-cora", shape=gshape)),
        device_ms["gcn-cora"], card)
    dcfg = dlrm_train_cfg()
    rshape = RECSYS_SHAPES["train_batch"]
    dp = dlrm.init_params(dcfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    dstep = build_recsys_step(dcfg, rshape, adamw.AdamWConfig(lr=1e-3))
    d, ids, y = dlrm_batch(rshape.batch, dcfg.n_dense, dcfg.vocab_sizes,
                           seed=0)
    db = {"dense": torch.from_numpy(d).to(dev),
          "sparse_ids": torch.from_numpy(ids).to(dev),
          "labels": torch.from_numpy(y).to(dev)}
    args = (dp, adamw.init_state(dp), db)
    out["dlrm-rm2"] = flop_reading(
        "dlrm-rm2", dstep, args, dstep, args,
        flops.model_flops("dlrm-rm2", rshape, cfg=dcfg),
        device_ms["dlrm-rm2"], card)
    return out


def phase_a8(dev, card: str, device_ms: dict, dryrun) -> dict:
    """Phase 21: (a) NeuraSim at Table-1 size, (b) against B2, (c)
    gradient compression at full width, (d) counted flops and FLOP shares,
    (e) the dry run's cells (``start_dryrun``'s runner, started with
    phase 20's training)."""
    out = {}
    for key, fn in (("neurasim", lambda: a8_neurasim(dev)),
                    ("spgemm", lambda: a8_spgemm(dev)),
                    ("compression", lambda: a8_compression(dev)),
                    ("flops", lambda: a8_flops(dev, device_ms, card))):
        t = time.perf_counter()
        out[key] = fn()
        out[f"{key}_s"] = time.perf_counter() - t
        say(f"a8 {key} {json.dumps(out[key])} ({out[f'{key}_s']:.1f} s)")
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out["dryrun"] = finish_dryrun(dryrun, A8_DRYRUN_WAIT_S)
    out["dryrun_wait_s"] = time.perf_counter() - t
    say(f"a8 dryrun {json.dumps(out['dryrun'])} (waited "
        f"{out['dryrun_wait_s']:.1f} s)")
    return out


A8_DRYRUN_WAIT_S = 600


def main() -> int:
    if not torch.cuda.is_available():
        print("[chip-smoke] torch.cuda.is_available() is false: this script "
              "needs a GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    warnings.filterwarnings("ignore", message="Sparse")   # beta CSR notes
    from repro_torch.configs.gcn_cora import FULL
    from repro_torch.data.synthetic import cora_like
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels import (embedding_bag, flash_attention,
                                     forest_sampler, gustavson_spmm, sddmm,
                                     spgemm_pad)
    from repro_torch.models.gnn import gcn
    from repro_torch.serve import FeatureStore
    from repro_torch.sparse.graph import coo_to_csr

    # phase 1 — device and build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = resolve_device("cuda")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    libraries = [gustavson_spmm.LIBRARY, forest_sampler.LIBRARY,
                 forest_sampler.FOREST_LIBRARY, spgemm_pad.LIBRARY,
                 embedding_bag.LIBRARY, sddmm.LIBRARY,
                 flash_attention.LIBRARY]
    secs = build.build(libraries)
    say(f"built {' + '.join(lib.name for lib in libraries)} with nvcc in "
        f"{secs:.2f}s")

    # phase 2 — kernels against their plain versions
    b1, b3, agg_plans = phase_kernels(dev)
    b3_fused = phase_forest(dev)
    cora_plan = agg_plans["cora_full"]

    # phase 2b — B1 in bf16, then a bf16 gcn-cora forward
    s, r, x, _, _ = cora_like(seed=0)
    params = gcn.init_params(FULL, torch.Generator().manual_seed(0),
                             device=dev)
    x_table = np.concatenate([x, np.zeros((1, x.shape[1]), np.float32)])
    t2b = time.perf_counter()
    b1_bf16, bf16_forward = phase_bf16(dev, agg_plans, params, x_table)
    say(f"phase 2b took {time.perf_counter() - t2b:.1f} s")

    # phase 3 — gcn-cora at full width on the Cora-scale graph
    phase_forward(dev, cora_plan, params, x_table)

    # phases 4-5 — serving from the resident Cora-scale graph
    indptr, indices, _ = coo_to_csr(s, r, 2708)
    store = FeatureStore.build(2708, x, device=dev)
    seeds = np.random.default_rng(2).integers(0, 2708, N_REQUESTS)
    serves = [phase_serve(dev, mode, params, indptr, indices, store, seeds)
              for mode in ("host", "device")]

    # phase 6 — the SpGEMM kernel against its plain version
    plans = spgemm_plans(dev)
    b2 = [spgemm_case(name, plan) for name, plan, _ in plans]

    # phase 7 — SpGEMM executors, then the counted two-hop path
    phase_spgemm_executors(plans)
    two_hop = phase_two_hop(dev, params, x_table)

    # phase 8 — int8 aggregation, the int8 forward, then int8 serving
    b4 = phase_q8_kernels(agg_plans)
    phase_q8_forward(dev, cora_plan, params, x_table)
    serves.append(phase_serve(dev, "device", params, indptr, indices, store,
                              seeds, backend="cuda_q8"))

    # phase 9 — int8 SpGEMM at phase 6's plans, then the counted path
    b5 = [spgemm_q8_case(name, plan, rec)
          for (name, plan, _), rec in zip(plans, b2)]
    del plans
    two_hop_q8 = phase_q8_two_hop(dev, params, x_table)
    del agg_plans, cora_plan
    torch.cuda.empty_cache()

    # phase 10 — B6 and dlrm-rm2 serving at full width (12.6 GB table)
    b6, dlrm_steps, b6_launches = phase_dlrm(dev)
    torch.cuda.empty_cache()

    # phase 11 — B7 through edge_scores, Cora-scale and ogb_products
    b7, b7_launches = phase_sddmm(dev)
    torch.cuda.empty_cache()

    # phase 12 — B8 through mha_causal at qwen3-0.6b width, S = 4096
    b8, b8_launches, b8_sweep, b8_readings = phase_flash(dev)
    torch.cuda.empty_cache()

    # phase 13 — gcn-cora training on B1 (forward and backward) and B4
    train = phase_train(dev)
    torch.cuda.empty_cache()

    # phase 14 — GAT, GIN and SAGE: the order-fixed tile scatter, serving
    # (B1, B3, B4), training (B1, B4; B2 and B5 on GIN's Â²)
    tile_scatter_costs(dev)
    conv_serves = phase_conv_serve(dev, indptr, indices, store, seeds)
    conv = phase_conv_train(dev)
    torch.cuda.empty_cache()

    # phase 15 — dlrm-rm2 training: B6 forward, order-fixed table gradient
    dlrm_train = phase_dlrm_train(dev)
    torch.cuda.empty_cache()

    # phase 16 — SchNet and DimeNet: serving (B3), training (B1, B4 and B2
    # on DimeNet's Â² stage)
    t16 = time.perf_counter()
    say(f"phases 1-15 took {t16 - t_start:.1f} s")
    geom_serves = phase_geom_serve(dev, seeds)
    geom = phase_geom_train(dev)
    say(f"phase 16 took {time.perf_counter() - t16:.1f} s")

    # phase 17 — the serving plane around gcn-cora serving: tracing,
    # metrics over HTTP, transient step faults and retries, sampler faults
    t17 = time.perf_counter()
    ops = phase_ops(dev, params, indptr, indices, store, seeds)
    say(f"phase 17 took {time.perf_counter() - t17:.1f} s")

    # phase 18 — the replicated cluster tier: B1 and the lane-scaled B4 on
    # lane-stacked plans, 4-lane clusters serving gcn-cora and gat-cora, the
    # reseed, kill and SLO drills, and the readings against one lane
    t18 = time.perf_counter()
    cluster = phase_cluster(dev, params, indptr, indices, store)
    say(f"phase 18 took {time.perf_counter() - t18:.1f} s")

    # phase 19 — live mutation: incremental plans under B1 and B4, the
    # mutated graph's forward, hot swaps and a graph stream under traffic
    t19 = time.perf_counter()
    live = phase_live(dev, params, indptr, indices, store, x_table)
    say(f"phase 19 took {time.perf_counter() - t19:.1f} s")
    torch.cuda.empty_cache()

    # phase 20 — the LM family: qwen3-0.6b at full width, its prefill on
    # B8, served by the continuous batcher, trained
    t20 = time.perf_counter()
    dryrun_dir = pathlib.Path(tempfile.mkdtemp(prefix="dryrun-"))
    dryrun = []                     # phase 21 (e), started with training
    lm = phase_lm(dev, lambda: dryrun.append(start_dryrun(dryrun_dir)))
    say(f"phase 20 took {time.perf_counter() - t20:.1f} s")
    torch.cuda.empty_cache()

    # phase 21 — A8c and A8d: NeuraSim at Table-1 size and against B2,
    # gradient compression, counted flops and FLOP shares, the dry run
    t21 = time.perf_counter()
    a8 = phase_a8(dev, card, {
        "qwen3-0.6b": lm["train"]["train_device_ms_per_step"],
        "gcn-cora": train["readings"]["dense"]["device_ms_per_step"],
        "dlrm-rm2": dlrm_train["device_ms_per_step"]}, dryrun[0])
    shutil.rmtree(dryrun_dir, ignore_errors=True)
    traced = sum(1 for k in A8_DRYRUN if f"{k[0]}×{k[1]}" in a8["dryrun"])
    say(f"dryrun: {traced} of {len(A8_DRYRUN)} cells trace with the "
        f"reference's sharding constraints on torch {torch.__version__}")
    say(f"phase 21 took {time.perf_counter() - t21:.1f} s")
    torch.cuda.empty_cache()

    # phase 22 — A7: the distributed backend on NCCL and on 4 gloo ranks
    # sharing the card, the ring and all-gather SpMMs, the DRHM-sharded
    # GCN step, the sharded and mesh-placed cluster (B1, B4), and
    # spmm_blocked_ell (B1)
    sys.path.insert(0, str(ROOT / "tools"))
    import a7_phase
    a7 = a7_phase.phase_a7(dev, params, indptr, indices, store)
    say(f"a7 {json.dumps(a7, default=float)}")
    say(f"phase 22 took {a7['phase_s']:.1f} s")
    torch.cuda.empty_cache()

    # phase 23 — gemma-7b at full width: its prefill on B8 at head_dim 256,
    # served by the continuous batcher, and B8 at its attention shape
    t23 = time.perf_counter()
    gemma = phase_gemma(dev)
    say(f"phase 23 took {time.perf_counter() - t23:.1f} s; the script "
        f"{time.perf_counter() - t_start:.1f} s")

    launches = {k: sum(sv["launches"][k] for sv in serves)
                for k in ("spmm_dedup_chunks", "spmm_dedup_chunks_q8",
                          "forest_sample", "hash_draws")}
    conv_serving = {k: sum(sv["launches"][k] for sv in conv_serves)
                    for k in launches}
    geom_serving = {k: sum(sv["launches"][k] for sv in geom_serves)
                    for k in launches}
    launches["spmm_dedup_chunks"] += two_hop["launches"]["spmm_dedup_chunks"]
    launches["spmm_dedup_chunks_q8"] += \
        two_hop_q8["launches"]["spmm_dedup_chunks_q8"]
    serving = dict(launches)
    for k in ("spmm_dedup_chunks", "spmm_dedup_chunks_q8"):
        launches[k] += (train["launches"][k] + conv["launches"][k]
                        + geom["launches"][k])
    for k in conv_serving:
        launches[k] += (conv_serving[k] + geom_serving[k]
                        + ops["launches"].get(k, 0)
                        + cluster["launches"].get(k, 0)
                        + live["launches"].get(k, 0))
    launches["spmm_dedup_chunks"] += \
        bf16_forward["launches"]["spmm_dedup_chunks"]
    for k in ("spmm_dedup_chunks", "spmm_dedup_chunks_q8"):
        launches[k] += a7["launches"][k]
    runs = train["per_run"]
    train_note = ", ".join(
        f"{name} {runs[name]['spmm_dedup_chunks']} + "
        f"{runs[name]['spmm_dedup_chunks_q8']}" for name in runs
        if sum(runs[name].values()))
    main_b1 = b1[0]                      # bucket 16, D = 16: the main shape
    main_b3 = b3_fused[1]                # bucket 16 at (5, 3): serving's
    main_b2 = b2[0]                      # gcn-cora Â²: the two-hop path's
    main_b4 = b4[0]                      # bucket 16, D = 16: q8 serving
    main_b5 = b5[0]                      # gcn-cora Â²: the q8 two-hop path
    # B6 at serve_bulk, B7 at ogb_products, B8 in bf16 (b*[1] below; B8 in
    # f32 beside it)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [
        dict(name="spmm_dedup_chunks", route="cuda",
             source="src/repro_torch/kernels/gustavson_spmm/csrc/"
                    "spmm_dedup_chunks.cu",
             replaces="src/repro/kernels/gustavson_spmm/gustavson_spmm.py"
                      ":139",
             launches=launches["spmm_dedup_chunks"],
             launches_note=(
                 f"serving and GCN over Â² "
                 f"{serving['spmm_dedup_chunks']}; phase 13's training "
                 f"runs (B1 + B4 per run: {train_note}): 4 a cuda step, "
                 "2 forward and 2 backward (dX on the transpose layout), "
                 "and 2 a cuda_q8 step, its f32 backward; phase 14's "
                 f"serving of gat, gin and sage "
                 f"{conv_serving['spmm_dedup_chunks']} (one an "
                 "aggregation: 9 a gat step, 3 gin, 2 sage) and training "
                 f"{conv['launches']['spmm_dedup_chunks']} (gat 18 a cuda "
                 "step, 9 a cuda_q8 step; gin 5 and 2); phase 16's DimeNet "
                 f"over Â² {geom['launches']['spmm_dedup_chunks']} (2 a "
                 "cuda step, 1 a cuda_q8 step: the Â² stage and its "
                 "backward; schnet, dimenet one-hop and their serving 0); "
                 "phase 2b's bf16 forward "
                 f"{bf16_forward['launches']['spmm_dedup_chunks']}; "
                 "phase 17's serving plane "
                 f"{ops['launches']['spmm_dedup_chunks']} (2 a dispatched "
                 "step); phase 18's 4-lane clusters "
                 f"{cluster['launches']['spmm_dedup_chunks']} (one an "
                 "aggregation a round for all lanes: 2 a gcn round, 9 a "
                 "gat round); phase 19's mutated-graph forwards and live "
                 f"drill {live['launches']['spmm_dedup_chunks']} (2 a "
                 "round, each swap's shadow warm-up a round); phase 22's "
                 "sharded and mesh-placed 4-lane clusters on one card "
                 f"{a7['cluster']['launches']['spmm_dedup_chunks']} (2 a "
                 "stacked round, 2 a lane a mesh round) and "
                 f"spmm_blocked_ell {a7['blocked_ell']['launches']} (one "
                 "a call)"),
             max_abs_err=max(c["max_abs_err"] for c in b1 + train["forward"]
                             + train["backward"]),
             stacked=[{k: c[k] for k in ("shape", "single_lane_calls_ms")
                       + keys} for c in cluster["kernels"]
                      if c["shape"].startswith("B1")],
             incremental=[{k: c[k] for k in ("shape", "max_abs_err",
                                             "cold_ms") + keys}
                          for c in live["kernels"]
                          if c["shape"].startswith("B1")],
             backward=[{k: c[k] for k in ("shape",) + keys}
                       for c in train["backward"]],
             bf16=dict(
                 instantiation="spmm_dedup_chunks_kernel<__nv_bfloat16, "
                               "VEC, RPT> (spmm_dedup_chunks_bf16_launch)",
                 launches=bf16_forward["launches"]["bf16"],
                 launches_note="phase 2b's gcn-cora forward in bf16",
                 max_abs_err=max(c["max_abs_err"] for c in b1_bf16),
                 shape=b1_bf16[0]["shape"],
                 **{k: b1_bf16[0][k] for k in keys},
                 cases=[{k: c[k] for k in ("shape", "f32_ms") + keys}
                        for c in b1_bf16]),
             shape=main_b1["shape"], **{k: main_b1[k] for k in keys}),
        dict(name="hash_draws", route="cuda",
             source="src/repro_torch/kernels/forest_sampler/csrc/"
                    "hash_draws.cu",
             replaces="src/repro/kernels/forest_sampler/forest_sampler.py"
                      ":127",
             launches=launches["hash_draws"],
             launches_note="the standalone counterpart of the Pallas "
                           "hash_draws, held against numpy in phase 2; "
                           "the serving path runs forest_sample instead",
             max_abs_err=b3["max_abs_err"],
             shape=b3["shape"], **{k: b3[k] for k in keys}),
        dict(name="forest_sample", route="cuda",
             source="src/repro_torch/kernels/forest_sampler/csrc/"
                    "forest_sample.cu",
             replaces="src/repro/kernels/forest_sampler/forest_sampler.py"
                      ":127",
             replaces_note="hash_draws fused with the gathers of "
                           "src/repro/serve/device_sampler.py:84",
             launches=launches["forest_sample"],
             launches_note=f"one a device-sampled step: gcn "
                           f"{serving['forest_sample']}, phase 14's gat, "
                           f"gin and sage {conv_serving['forest_sample']}, "
                           f"phase 16's schnet and dimenet "
                           f"{geom_serving['forest_sample']}, phase 17's "
                           f"serving plane {ops['launches']['forest_sample']}",
             max_abs_err=max(c["max_abs_err"] for c in b3_fused),
             shape=main_b3["shape"], **{k: main_b3[k] for k in keys}),
        dict(name="spgemm_hashpad", route="cuda",
             source="src/repro_torch/kernels/spgemm_pad/csrc/"
                    "spgemm_hashpad.cu",
             replaces="src/repro/kernels/spgemm_pad/spgemm_pad.py:83",
             launches=(two_hop["launches"]["spgemm_hashpad"]
                       + conv["launches"]["spgemm_hashpad"]
                       + geom["launches"]["spgemm_hashpad"]
                       + sum(g["launches"] for g in a8["spgemm"].values())),
             launches_note="two_hop_graph and coarsen_graph (phase 7); "
                           "GIN's Â² under cuda and cuda_q8 (phase 14); "
                           "DimeNet's Â² under cuda and cuda_q8 (phase "
                           "16); A·A of Table-1's facebook and wiki-Vote "
                           "(phase 21)",
             max_abs_err=max(c["max_abs_err"] for c in b2),
             shape=main_b2["shape"], **{k: main_b2[k] for k in keys}),
        dict(name="spmm_dedup_chunks_q8", route="cuda",
             source="src/repro_torch/kernels/gustavson_spmm/csrc/"
                    "spmm_dedup_chunks.cu",
             replaces="src/repro/kernels/gustavson_spmm/gustavson_spmm.py"
                      ":299",
             launches=launches["spmm_dedup_chunks_q8"],
             launches_note=(
                 f"int8 serving and GCN over the int8 Â² "
                 f"{serving['spmm_dedup_chunks_q8']}; phase 13's cuda_q8 "
                 f"training run {runs['cuda_q8']['spmm_dedup_chunks_q8']} "
                 "(2 a step, the forward); phase 14's int8 serving "
                 f"{conv_serving['spmm_dedup_chunks_q8']} and training "
                 f"{conv['launches']['spmm_dedup_chunks_q8']} (gat 9 a "
                 "step, gin 3); phase 16's DimeNet over Â² "
                 f"{geom['launches']['spmm_dedup_chunks_q8']} (1 a cuda_q8 "
                 "step, the Â² stage's forward); phase 18's 4-lane int8 "
                 f"cluster {cluster['launches']['spmm_dedup_chunks_q8']} "
                 "(2 a round for all lanes, lane-scaled); phase 19's "
                 "mutated-graph forwards and int8 live drill "
                 f"{live['launches']['spmm_dedup_chunks_q8']}; phase 22's "
                 "sharded and mesh-placed int8 clusters "
                 f"{a7['cluster']['launches']['spmm_dedup_chunks_q8']}"),
             max_abs_err=max(c["max_abs_err"]
                             for c in b4 + train["forward_q8"]),
             lane_scaled=dict(
                 launches=cluster["launches"]["spmm_dedup_chunks_q8_lanes"],
                 launches_note="phase 18's 4-lane cuda_q8 cluster: x "
                               "quantized lane by lane, a row of feature "
                               "scales a lane",
                 cases=[{k: c[k] for k in ("shape", "max_abs_err",
                                           "single_lane_calls_ms") + keys}
                        for c in cluster["kernels"]
                        if c["shape"].startswith("B4")]),
             incremental=[{k: c[k] for k in ("shape", "max_abs_err",
                                             "cold_ms") + keys}
                          for c in live["kernels"]
                          if c["shape"].startswith("B4")],
             shape=main_b4["shape"], **{k: main_b4[k] for k in keys}),
        dict(name="spgemm_hashpad_q8", route="cuda",
             source="src/repro_torch/kernels/spgemm_pad/csrc/"
                    "spgemm_hashpad.cu",
             replaces="src/repro/kernels/spgemm_pad/spgemm_pad.py:168",
             launches=(two_hop_q8["launches"]["spgemm_hashpad_q8"]
                       + conv["launches"]["spgemm_hashpad_q8"]
                       + geom["launches"]["spgemm_hashpad_q8"]),
             launches_note="the int8 two-hop path (phase 9); phases 14 "
                           "and 16 build GIN's and DimeNet's Â² in f32 (B2) "
                           "and count B5 at 0",
             max_abs_err=max(c["max_abs_err"] for c in b5),
             shape=main_b5["shape"], **{k: main_b5[k] for k in keys}),
        dict(name="embedding_bag", route="cuda",
             source="src/repro_torch/kernels/embedding_bag/csrc/"
                    "embedding_bag.cu",
             replaces="src/repro/kernels/embedding_bag/embedding_bag.py:76",
             launches=b6_launches + dlrm_train["launches"],
             launches_note=f"one a DLRM forward: serving {b6_launches}, "
                           f"phase 15's training {dlrm_train['launches']}",
             max_abs_err=max(c["max_abs_err"] for c in b6),
             shape=b6[1]["shape"], **{k: b6[1][k] for k in keys}),
        dict(name="sddmm", route="cuda",
             source="src/repro_torch/kernels/sddmm/csrc/sddmm.cu",
             replaces="src/repro/kernels/sddmm/sddmm.py:54",
             launches=b7_launches,
             launches_note="edge_scores calls: one kernel each on the "
                           "direct path, 8 kernels and 2 memsets on the "
                           "grouped path (ogb_products)",
             max_abs_err=max(c["max_abs_err"] for c in b7),
             shape=b7[1]["shape"], **{k: b7[1][k] for k in keys}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py"
                      ":68",
             launches=b8_launches + lm["launches"] + gemma["launches"],
             launches_note=(
                 f"phase 12's mha_causal in f32 and in bf16, its "
                 f"head-dim sweep and its readings {b8_launches} (one a "
                 f"call: 2 + {len(b8_sweep)} sweep cases, 3 dtypes a d "
                 f"and the mixed and f64 cases as one f32 launch each, + "
                 f"{len(b8_readings)} readings); phase 20's qwen3-0.6b "
                 f"{lm['launches']}: 28 a FULL bf16 prefill at S = 4096 "
                 f"({lm['prefill']['launches']}) and its eval forward "
                 f"({lm['prefill']['forward_launches']}), 4 the f32 "
                 f"prefill at depth 4 ({lm['prefill']['f32_launches']}), "
                 f"28 a served request's prefill "
                 f"({lm['serve']['launches']} for "
                 f"{lm['serve']['requests']}), 3 a reduced f32 request's "
                 f"({lm['serve']['reduced_f32']['launches']}); phase 23's "
                 f"gemma-7b {gemma['launches']} at d = 256 and the reduced "
                 f"gemma's 24: 28 the FULL bf16 prefill "
                 f"({gemma['prefill']['launches']}) and forward "
                 f"({gemma['prefill']['forward_launches']}), 4 the f32 "
                 f"prefill ({gemma['prefill']['f32_launches']}), 28 a "
                 f"served request's ({gemma['serve']['launches']} for "
                 f"{gemma['serve']['requests']}), 3 a reduced f32 "
                 f"request's ({gemma['serve']['reduced_f32']['launches']})"),
             max_abs_err=max(c["max_abs_err"] for c in b8),
             f32={k: b8[0][k]
                  for k in ("shape", "max_abs_err", "tolerance") + keys},
             in_model=dict(
                 shape="qwen3-0.6b prefill B=1 S=4096 bf16, 28 layers",
                 ms=lm["readings"]["b8_ms"],
                 bound_ms=lm["readings"]["b8_bound_ms"],
                 share_of_prefill=lm["readings"]["b8_share"],
                 last_logits_rel_vs_blocked=lm["prefill"]
                 ["last_logits_rel"]),
             head_dim_256=dict(
                 launches=gemma["launches"],
                 cases=[{k: c[k] for k in ("shape", "max_abs_err",
                                           "tolerance") + keys}
                        for c in gemma["b8"]],
                 in_model=dict(
                     shape="gemma-7b prefill B=1 S=4096 bf16, 28 layers",
                     ms=gemma["readings"]["b8_ms"],
                     bound_ms=gemma["readings"]["b8_bound_ms"],
                     share_of_prefill=gemma["readings"]["b8_share"],
                     last_logits_rel_vs_blocked=gemma["prefill"]
                     ["last_logits_rel"])),
             sweep=[{k: c[k] for k in ("d", "dtype", "launches",
                                       "max_abs_err", "tolerance", "ms",
                                       "bound_ms", "bound_by",
                                       "executed_flops")}
                    for c in b8_sweep],
             readings=[{k: c[k] for k in ("shape", "launches", "max_abs_err",
                                          "tolerance", "executed_flops",
                                          "executed_tflop_s") + keys}
                       for c in b8_readings],
             shape=b8[1]["shape"], **{k: b8[1][k] for k in keys}),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
