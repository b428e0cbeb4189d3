#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:

1. device  — the card's name and count, and nvidia-smi's name/power limit;
2. build   — every CUDA kernel of the port compiled with nvcc (sm_90a), one
             process per source, all started together, timed as set-up;
             no ptxas spill in K1, K4 (forward and backward), the 8
             instantiations of K2's ``attn_rows_kernel``, the 6 of its
             tensor-core backward (``attn_bwd_tc_*``) and the 8 of K3's
             ``gmm_kernel_tc`` (two tile shapes x four layouts);
3. kernel  — the WCOJ probe held against its plain PyTorch version on the
             card (exact equality), on its ``fence`` route (a walk down the
             CSR's search index) and its ``search`` route (a binary
             search), each timed over batches of 10 calls queued behind a
             device sleep, with the index's build time, the plain
             version's time, a one-call PyTorch yardstick
             (``searchsorted``) and the least time the card could take
             (``bound_ms``): first on a seeded synthetic CSR drawn with the
             store generator's own Zipf sampler;
4. main    — the graph path at full size: an LDBC-like store at sf=100
             (about 1.7M vertices, 13.4M edges), ``GOpt(store)`` on cuda
             (GLogue's triangle counts probe through the kernel), then the
             25 benchmark queries twice: the first run of each fused expand
             chain measures it on the per-hop loop, the second dispatches
             it as one fused program whose probes launch the kernel; every
             launch of the probe on its ``fence`` route;
5. kernel  — the probe again on two membership probes GLogue made in
             phase 4, captured on the card: the one with the most probes
             and the one with the most binary-search steps;
6. gremlin — two Gremlin traversals through phase 4's ``GOpt`` on cuda: the
             Gremlin module docstring's 2-hop group count on the LDBC
             schema and ic3 with ``$pid`` bound through ``.param`` (prepared
             once, run with two bindings); each with the canonical GIR of
             its Cypher twin, sharing its cached plan, with identical rows;
7. sharded — the sharded backend on phase 4's store over a one-rank NCCL
             group on cuda:0 (one card is a world of one; NCCL across
             ranks is not exercised): ``GOpt(store, backend="sharded",
             devices=1)`` (GLogue probing through K1 on the shard
             blocks), then each of the 25 queries optimised on the sharded
             spec and its plan run twice on ``sharded`` and twice on
             ``torch``: identical rows (or both at the blow-up guard), no
             mid-plan copy, the frontier and emit collectives recorded, no
             gather at one shard, one K1 launch per sharded probe, all on
             ``fence``;
8. kernel  — the sharded probe: phase 5's ``glogue_most_rows`` CSR
             partitioned four ways, the rank-local probe function run on
             each block in turn; the blocks' hit and position sums equal
             the whole-CSR K1 result and the plain version bit for bit;
             each block timed as in phase 3, beside its bytes bound;
9. check   — at sf=1, GLogue frequencies, plans and all 25 results equal on
             ``device="cuda"`` and ``device="cpu"`` (the plain versions),
             and the fused chains on cuda, the per-hop loop on cuda and the
             fused chains on the cpu give identical rows;
9b. residency — the host-staging baseline on phase 9's sf=1 store (at
             sf=100 the staged runs take over 120 s): the reference's
             ``--residency`` sets (the 8 ``cbo`` and 6 ``ic`` queries)
             each run warm on the resident cuda set and through
             ``HostStagingOperators`` over it (host columns; every expand
             and probe uploads its padded block and downloads the padded
             result); identical rows, no mid-plan download on the
             resident set and some on the staged one, every staged K1
             launch on ``fence``, one a probed slab; both sets' ms and
             transfers a query;
10. check  — at sf=1 again, a mutable store after one update script (the
             stream of phase 11, scaled down): the 25 queries and the
             stream's reads give the same plans and rows on cuda and cpu,
             over the delta overlay and after compaction;
11. mutate — graph serving under writes: phase 4's sf=100 store wrapped in
             ``MutableGraphStore``, ``GOpt`` on cuda and
             ``gopt.serve(overlap=True)`` answering 16 rounds of an
             interleaved stream through ``submit_update`` / ``submit``:
             32,768 edge inserts a round (40% KNOWS, 30% LIKES, 20%
             HASMEMBER, 10% the edges of new COMMENTs), 1,024 deletes of
             base KNOWS edges, 256 PERSON inserts (1,024 PERSON deletes in
             the last round), and 512 reads over ``MUTATE_QUERIES`` with
             Zipf ``$pid``s; a sample of each round's reads equals the
             port's ``numpy`` spec on a deep copy of the store taken at
             their admission; then ``srv.compact()`` and one more read
             round, equal to the rows before compaction and to the numpy
             spec.  Gates: every request done, no retry, no degradation,
             no host rung on the server, no wave on rung 1 or 2, no
             mid-plan device->host copy, K1
             launched (all on ``fence``) on the insert and tombstone
             views, chains declining on the delta and fused on untouched
             triples, device memory back after compaction;
12. kernel — the probe on the insert-view and the tombstone-view probes
             with the most probes captured in phase 11 (``DeltaAdj`` views,
             indices zero-padded to a power of two), as in phase 3;
13. chaos  — the compacted store served through four fault-injecting
             wrappers of the cuda spec: transient K1 faults, a poison
             binding and a latency spike over a fresh write burst; three
             fused-chain faults that walk the breaker to the per-hop loop
             and back; a permanent K1 fault on one plan, which serves from
             rung 2 (the ``numpy`` spec, asked for with ``fallback_spec``)
             — every successful read equal to a fault-free run, the
             counters and fault ledgers equal to the injected schedule;
             and the same permanent fault on a server left at its
             default, which has no host rung on the card and fails the
             request;
14. serve  — the serving path: OLMoE-1B-7B at full width and depth in bf16
             (random weights from a seeded generator on the card),
             ``ServeEngine`` with 8 slots of 4096 positions answering 16
             requests (prompts of 128-2048 tokens, 64 new tokens each);
             every prefill attention goes through the FlashAttention
             kernel's tensor-core route (``tc``), every decode attention
             through its split route (``split``), and every expert product
             through the grouped-matmul kernel's tensor-core route;
15. kernel — each of those two kernels on calls captured in phase 14 (the
             longest prompt's prefill and one decode tick for attention;
             that prefill's and that tick's w1 and w2 products for the
             grouped matmul), against its plain version within the
             reference's tolerance, with the same timings and bounds as
             phase 3 (``library_ms``: one ``scaled_dot_product_attention``
             with an explicit mask, one ``torch.bmm``; for the causal
             prefill also ``library_causal_ms``, SDPA with
             ``is_causal=True`` over the filled cache rows), the route
             each must take (attention: ``tc`` for the prefill, ``split``
             for the tick; the grouped matmul: ``tc``) and its share of
             the bound, attention also with a cold L2; then the scalar
             routes on fp32 casts: attention's ``rows`` on the prefill
             (at most 0.93 ms), the grouped matmul's ``simt`` on the
             decode w1 product;
16. check  — OLMoE at full width but 2 layers, in float32 with TF32 off:
             a 256-token prefill and 4 teacher-forced decode steps give the
             same logits on ``device="cuda"`` and ``device="cpu"``;
17. archs  — the ten architectures through ``get_bundle(arch,
             smoke=True)`` on cuda, every shape that runs:
             ``make_concrete(device="cuda")`` then ``make_step``; every
             floating output finite; K2 launched on every LM shape (its
             backward too in a train step: the bf16 ``train_4k`` trains
             fp32 masters), K3 on the MoE ones, K4 on Wide & Deep's
             (counted per shape); the same step on a CPU copy of the
             inputs held to the card's at the model tolerances (each LM
             bundle again in float32: in bf16 a router near-tie may send
             a token to another expert on either device);
18. long_context — OLMoE-1B-7B at ``CONFIG`` (random bf16 weights from a
             seeded generator) through ``get_bundle`` and ``make_step``:
             ``prefill_32k`` at batch 1 (cut from 32) and 32,768 prompt
             tokens, one warm-up and 2 timed prefills, then
             ``prefill(32,767)`` and one tick with token 32,767 against
             ``prefill(32,768)`` (the same argmax up to a tie at the
             logits' bf16 step, the max abs difference at most
             ``LONG_TICK_BOUND``, which the CPU twin measured), then
             ``decode_32k`` at batch 8 (cut from 128) over seeded random
             caches of 32,768 positions at t = 32,767, one warm-up and 5
             timed ticks; exactly 16 K2 (``tc`` in a prefill, ``split``
             in a tick) and 48 K3 (``tc``) launches a step, finite logits,
             peak memory at most 60e9 bytes;
19. kernel — K2 on layer 0's call captured in the warm-up prefill (``tc``,
             32,768 queries and keys: the last 1,024 query rows held to
             the plain version over every key at 2e-2, one call timed
             beside SDPA ``is_causal`` and the operations bound) and in
             the warm-up tick (``split``, 8 slots over 32,768 keys, as
             phase 15);
20. dryrun — ``launch/dryrun.py``'s ``run_cell`` for every architecture x
             shape x the 16x16 and 2x16x16 meshes: every cell OK or
             SKIPPED, the skipped ones exactly the reference's four
             ``long_500k`` (the five bf16 ``train_4k`` run on fp32
             masters); then the two
             long-context cells at their cut batch on a (1, 1) mesh: the
             predicted argument bytes equal to the bytes of the tensors
             phase 18 passed, the predicted temporaries beside the step's
             measured peak less what was allocated before it, the
             measured ms beside max(t_compute, t_memory);
21. lm_train_bf16 — mixed-precision training: OLMoE-1B-7B's ``train_4k``
             through ``get_bundle`` at the published widths (d_model 2,048,
             16 heads of 128, 64 experts top-8, d_ff 1,024, vocab 50,304),
             cut to 6 layers (from 16) and batch 2 (from 256) at the cell's
             4,096 tokens: fp32 masters (random, from a seeded generator)
             cast to bf16 at each use, the bundle's ``adam_cfg()``, tokens
             from ``train/data.py``; one warm-up step, 5 steps timed with
             CUDA events, one profiled step.  Gates: every loss and
             gradient norm finite; every master fp32 and moved by a step;
             peak memory at most 60e9 bytes; exactly 2L K2 launches a step
             on ``tc`` (the forward and the checkpointed layer's
             recompute), L K2 backward launches on ``tc`` and 12L K3
             launches on ``tc``; the cut cell's dry run on a (1, 1) mesh
             predicting exactly the bytes the step was passed (once its
             one residual scalar a port tensor is counted, as the dry run
             counts it, one a reference leaf);
22. kernel — on layer 0's calls captured in the warm-up step: K2's ``tc``
             forward (``[2, 4096, 16, 1, 128]``) against its plain version
             (2e-2), as ``kernel`` above, then its bf16 backward on its
             ``tc`` route (the output gradient at unit RMS) against
             autograd through the plain version over all 4,096 rows
             (2e-2), bit-equal over two calls, at most 3.0 ms queued, as
             ``attention_bwd`` below, beside SDPA's bf16 backward and its
             operations bound, the statistics pass timed apart from the dq
             and dk/dv kernels; then for the w1 and w2 products K3's
             ``tc`` forward (3e-2) and its backward on ``tc`` (3e-2, dw
             bit-equal), each product timed beside ``torch.bmm``, dx and dw
             (the transposed operand read in place through the layout
             flags) queued, at most 0.80 ms each, and profiled over 10
             calls: the product's kernel and no other;
23. recsys — Wide & Deep at its full ``CONFIG`` (3.7e9 parameters, a
             13.7 GB embedding table; random fp32 weights from a seeded
             generator on the card) serving the reference's three shapes:
             ``serve_p99`` (batch 512) 50 times, ``serve_bulk`` (batch
             262,144) 3 times, ``retrieval_cand`` (1 query, 1M candidates)
             20 times; every forward's bag lookups go through one
             embedding-bag kernel launch on its ``vec`` route, which writes
             the bag sums straight into the MLP's input buffer.  The
             batches are the reference's seeded synthetic click log, built
             on the host and copied to the card outside the timed window
             (``recsys_copy``); then one more forward of each shape under
             ``torch.profiler`` (no ``torch.cat`` kernel may appear);
24. kernel — the embedding-bag kernel on the captured ``serve_p99`` and
             ``serve_bulk`` lookups, and on ``serve_bulk`` written through
             ``out`` into a buffer of the deep tower's padded shape (the
             padding columns untouched), against its plain version (1e-4,
             the reference's tolerance), on the ``vec`` route, timed over
             batches of 10 calls queued behind a device sleep and as one
             call, with one ``torch.nn.functional.embedding_bag`` call as
             the yardstick; then ``serve_p99`` on the ``warp`` route,
             through a view of the same table one element past its base;
25. check  — Wide & Deep ``SMOKE`` in float32: serve and retrieval give the
             same outputs on ``device="cuda"`` and ``device="cpu"``;
26. recsys_train — Wide & Deep at its full ``CONFIG`` trained on the card
             (the serving model freed first; random fp32 weights from a
             seeded generator, the reference's ``adam_cfg()``) at
             ``train_batch`` (65,536 examples from two seeded host
             batches, alternating): one warm-up step, 5 steps timed with
             CUDA events, one profiled step.  Gates: every loss and
             gradient norm finite; exactly one K4 forward (on ``vec``) and
             one K4 backward (``embedding_bag_bwd``) launch a step; peak
             memory over the timed steps at most 64e9 bytes (the table's
             gradient is dense, so the AdamW update walks 59 GB of
             weights, gradients and moments in pieces); the first MLP
             layer and every table row the batches name move; ``items``,
             ``user_proj`` and the table rows no batch names keep their
             bits (digests);
27. kernel — K4's backward on the call captured in the warm-up step (the
             deep tower's input gradient, 40 bags a row of row stride
             1,293, scaled to unit RMS) against its plain version (1e-4),
             bit-equal over two calls, timed beside one ``index_add_``
             into a zeroed table gradient and its bytes bound, with the
             split into the zero fill, the sort and the two kernels;
28. check  — Wide & Deep ``SMOKE`` training step 0 on cuda and on cpu from
             the same weights: loss, gradient norm and the table's
             gradient at the recsys tolerance; the AdamW update in pieces
             and of whole tensors on the card, bit-equal;
29. gnn    — the GNN family training on the card in float32 with TF32
             off, each architecture through its full-size bundle (the
             published widths; random weights from a seeded generator on
             the card) and the reference's AdamW: GAT, SchNet, NequIP and
             EquiformerV2 on ``full_graph_sm`` (Cora's sizes) and
             ``molecule`` (128 graphs of 30 atoms), the first three also
             on ``minibatch_lg`` (GAT's batches sampled afresh each step
             by the port's fanout sampler, 1,024 seeds at 15-10, over a
             232,965-node power-law graph; the others' from the bundle's
             concrete batch); one warm-up and 5 timed steps each (CUDA
             events), every loss and gradient norm finite, every step
             moving the weights, the molecule losses equal to the port's
             on the CPU, one profiled molecule step each; then EquiformerV2
             on ``minibatch_lg`` through ``node_chunks = 16``: the bundle's
             batch binned into 16 destination ranges of 10,624 nodes
             (every real edge kept), one step at 1 and at 2 layers for the
             bytes a layer adds at peak, then the deepest L of 12 whose
             peak stays under 72e9 bytes, one warm-up and 3 timed steps
             (the same gates, the peak under the cap, TFLOP/s of the
             bundle's count at depth L, one profiled step); then a summary
             with the runs the card does not take (``reduced``);
29b. check — EquiformerV2 at full widths and 12 layers on
             ``full_graph_sm`` binned into 4 ranges of 768 nodes: the
             loss and global gradient norm of ``edge_chunk = E' / 4`` and
             of ``node_chunks = 4`` within 1e-3 / 1e-4 of the default
             path's on the same weights;
30. lm_train — LM training through ``repro_torch.launch.train.train`` in
             float32 with TF32 off, into a temporary checkpoint directory:
             ``lm100m`` (12 layers, d_model 768, vocab 32,768) at batch 8 x
             seq 1,024 for 20 steps (checkpoints at 10 and 20), then
             ``train(steps=30)`` on the same directory, which must resume
             at step 20 with a first loss equal to the card's loss of step
             20's batch on the weights restored (since PR 25) through
             ``train/elastic.py::elastic_restart`` onto
             ``make_host_mesh()``, a (1, 1) mesh over a one-rank NCCL
             group (the state kept in place), then a run with
             ``should_preempt`` set; ``lm-moe`` at batch 16 x seq 1,024 for
             10 steps.  Gates: every loss and gradient norm finite, the
             mean of the last 5 losses below that of the first 5, no
             retry, step 0's loss and global gradient norm at batch 1 x
             seq 256 equal to the port's on the CPU on the same weights
             (rtol 2e-3 / atol 2e-4), and exact launch counts a step: K2's
             forward L x 2 (the layer's recompute under
             ``torch.utils.checkpoint`` launches it again), all on
             ``rows``; K2's backward (``flash_attention_bwd``) L, all on
             its ``saved`` route (the forward's output and log-sum-exp);
             K3 (MoE) L x 3 x 2 + L x 6 (forward, recompute, dx and dw),
             all on ``simt``.  Then 5 steps timed with CUDA events, peak
             memory, TFLOP/s of ``train_flops``, one profiled step, and the
             checkpoint's save and restore seconds;
31. kernel — K2's forward on its ``rows`` route at the training shape
             (``lm100m`` layer 0, fp32), beside SDPA with an explicit mask
             and with ``is_causal``, at most 0.55 ms (every ``rows``
             phase also holds its log-sum-exp to the plain version's at
             1e-4, and its output and log-sum-exp equal bit for bit over
             two calls); then the attention backward
             (``attention_bwd``) on layer 0's operands captured in a timed
             ``lm100m`` step, its output gradient scaled to unit RMS (the
             backward is linear in it; each gradient's largest value must
             reach 10x the tolerance), against autograd through the plain
             version on the card (2e-3): through the Function (the
             ``saved`` route) and on the ``recompute`` route, bit-equal
             over two calls, timed as the training path calls it (with the
             forward's output and log-sum-exp; at most 1.6 ms) and on the
             other route, beside its operations bound and the backward of
             SDPA (``is_causal``) on the same inputs; then the same
             operands cast to bf16 (the forward and the backward on
             ``tc``), held at 2e-2; then K2's ``rows`` forward at
             ``lm-moe``'s layer 0 (head_dim 32);
32. kernel — K3's backward (``gmm_bwd``) on ``lm-moe``'s layer-0 w1 and
             w2 products captured the same way (``dy`` at unit RMS): both
             gradients against autograd through the plain version (1e-4),
             dw bit-equal over two calls, and the three products as the
             Function makes them (forward; dx = dy w^T and dw = x^T dy
             reading w and x in place through the layout flags) each timed
             beside ``torch.bmm`` on the same operands and its bound, at
             most 0.33 ms each, with the simt kernel's output tile rows.

Then a ``{"kernels": [...]}`` line, nvidia-smi's line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without that
last line, as does a run with no CUDA device or without the repository's
``src/`` beside this file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32 rate
# outside the tensor cores — the closest listed rate for the probe's int32
# compares — and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
SEED = 0            # of the synthetic kernel input, the model and traffic
REPS = 20           # timed repetitions per kernel measurement
SF = 100.0          # scale factor of the main path's store
CHECK_SF = 1.0      # scale factor of the cuda-vs-cpu cross-check
# serving: 16 requests over 8 slots of 4096 positions
N_SLOTS, MAX_LEN = 8, 4096
N_REQUESTS, PROMPT_LENS, NEW_TOKENS = 16, (128, 2048), 64
CAPTURE_TICK = 32   # the decode tick whose kernel calls are captured
# the reference's bf16 tolerances (tests/test_kernels.py)
ATTENTION_TOL, GMM_TOL = 2e-2, 3e-2
# the scalar routes in fp32 (the reference's fp32 tolerances)
GMM_FP32_TOL, ATTENTION_FP32_TOL = 1e-4, 2e-3
# the rows route's log-sum-exp (natural log), as the card's tests hold it
ATTENTION_LSE_TOL = 1e-4
# K2's rows route, queued ms: lm100m's layer 0 in training, and serving's
# prefill cast to fp32 (no worse than the 4x4 scalar tiles it replaced,
# 0.9309 ms on an H100 80GB HBM3); its kernels, fp32 and bf16 at
# head_dim 16, 32, 64 and 128, must not spill
ATTN_ROWS_TRAIN_LIMIT_MS, ATTN_ROWS_PREFILL_LIMIT_MS = 0.55, 0.93
ROWS_INSTANTIATIONS = 8
# the tensor-core kernels that must not spill either: K2's tc backward
# (three kernels at head_dim 64 and 128), K3's tc kernel (two tile shapes
# x the four layouts of x and w)
BWD_TC_INSTANTIATIONS, GMM_TC_INSTANTIATIONS = 6, 8
GMM_BATCH = 10      # grouped-matmul calls per timed run
ATTN_BATCH = 10     # attention calls per timed run, queued behind a sleep
BAG_BATCH = 10      # embedding-bag calls per timed run, queued behind a sleep
PROBE_BATCH = 10    # WCOJ probe calls per timed run, queued behind a sleep
QUEUE_CYCLES = 4_000_000  # ~2 ms at the H100's clocks: covers the batch
FLUSH_BYTES = 100 << 20   # written before a cold-L2 run
PROFILE_ATTEMPTS = 3  # traces of a step before an empty one fails
# the float32 model check: layers, prompt, decode steps, tolerances
CHECK_LAYERS, CHECK_PROMPT, CHECK_STEPS = 2, 256, 4
CHECK_RTOL, CHECK_ATOL = 2e-3, 2e-4
# Wide & Deep: timed runs per shape, the reference's embedding-bag
# tolerance, and the float32 cuda-vs-cpu tolerances of the SMOKE check
RECSYS_RUNS = {"serve_p99": 50, "serve_bulk": 3, "retrieval_cand": 20}
BAG_TOL = 1e-4
# Wide & Deep training at CONFIG: timed steps after one warm-up, the
# host batches they cycle through (building one of 65,536 takes seconds),
# the peak device memory allowed over the steps (59.1 GB of weights,
# gradients and moments, activations, the update's pieces), and the piece
# of the bounded-versus-whole update check on SMOKE
RECSYS_TRAIN_STEPS = 5
RECSYS_TRAIN_BATCHES = 2
RECSYS_TRAIN_PEAK_BYTES = 64e9
RECSYS_CHECK_PIECE = 4096
# K1's gates: ms queued on the fence route, and the captured calls against
# the search route in the same run (the walk is bound by issue where the
# CSR sits in L2; see PERF.md section 6)
PROBE_LIMIT_MS = {"synthetic_zipf": 1.1}
PROBE_SEARCH_RATIO = {"glogue_most_rows": 1.05, "glogue_most_steps": 1.0}
RECSYS_RTOL, RECSYS_ATOL = 1e-4, 1e-5
# the GNN family: each architecture's full-size runs (the bundle's
# published widths), train steps after one warm-up, the molecule loss
# check's tolerance (card against the port on the CPU), and GAT's
# sampled minibatch_lg: a Reddit-sized power-law graph, features, classes,
# seeds and fanouts (the bundle's shape: 1024 seeds, fanout 15-10)
GNN_RUNS = {"gat-cora": ("full_graph_sm", "molecule", "minibatch_lg"),
            "schnet": ("full_graph_sm", "molecule", "minibatch_lg"),
            "nequip": ("full_graph_sm", "molecule", "minibatch_lg"),
            "equiformer-v2": ("full_graph_sm", "molecule")}
GNN_STEPS = 5
GNN_RTOL, GNN_ATOL = 1e-3, 1e-4
SAMPLED = {"n_nodes": 232_965, "avg_degree": 50, "d_feat": 602,
           "n_classes": 41, "seeds": 1024, "fanouts": [15, 10]}
GNN_REDUCED = {
    "ogb_products": "ogb_products is not run: no path of the reference "
    "fits it on one card (2,449,029 nodes, 61,859,140 edges): GAT's second "
    "layer makes ~93 GB of [61.9M, 8, 47] fp32 messages, SchNet's RBF "
    "[61.9M, 300] fp32 is 74 GB, NequIP's per-edge [E, 32, 9] fp32 "
    "tensors are 71 GB each, EquiformerV2 keeps one [2.45M, 128, 49] fp32 "
    "input a layer, 61.4 GB each",
    "sampled_degree": "GAT's sampled graph has average degree 50, not "
    "Reddit's ~492 (past a degree of 15 the sampled shape depends only on "
    "the fanout)"}
# EquiformerV2 on minibatch_lg (published widths) through node_chunks: the
# bundle's batch binned into this many destination ranges; the deepest L
# of 12 layers whose peak (predicted from one- and two-layer probe steps)
# stays under the cap, then timed steps after one warm-up
EQ_LG_CHUNKS = 16
EQ_LG_PEAK_BYTES = 72e9
EQ_LG_STEPS = 3
# the card's path-parity check: full_graph_sm binned into this many ranges
EQ_CHECK_CHUNKS = 4
# LM training: each preset's (batch, seq, steps) and, for lm100m, the
# resumed run's total steps; the CPU parity shape (batch, seq); steps timed
# with CUDA events after one warm-up
LM_RUNS = {"lm100m": (8, 1024, 20), "lm-moe": (16, 1024, 10)}
LM_RESUME_STEPS = {"lm100m": 30}
LM_CHECK_SHAPE = (1, 256)
LM_TIMED_STEPS = 5
# the backward kernels' gates (ISSUE-set, H100): K2's fp32 backward on
# lm100m's layer 0 as the training path calls it, and each of K3's six
# simt products of lm-moe's layer 0 (forward, dx, dw of w1 and w2); K2's
# bf16 backward on its tc route (OLMoE's layer 0 in lm_train_bf16, queued),
# and K3 tc's dx and dw of w1 and w2 there, read in place through the
# layout flags (queued)
ATTN_BWD_LIMIT_MS = 1.6
ATTN_BWD_BF16_LIMIT_MS = 3.0
GMM_SIMT_LIMIT_MS = 0.33
GMM_TC_BWD_LIMIT_MS = 0.80
# long context: OLMoE at CONFIG through get_bundle, the reference's
# prefill_32k and decode_32k cut in batch (32 -> 1, 128 -> 8); prefills
# and ticks timed after one warm-up; the query rows of the captured 32k
# prefill held to the plain version (over all keys); the bound on the max
# abs difference between prefill(S) and prefill(S - 1) + one tick, which
# the CPU twin measured (tests/test_torch_registry.py, OLMoE SMOKE in bf16:
# capacity drops of the last token move logits by up to ~1)
LONG_SEQ = 32_768
LONG_BATCH = {"prefill_32k": 1, "decode_32k": 8}
LONG_PREFILLS, LONG_TICKS = 2, 5
LONG_CHECK_ROWS = 1_024
LONG_TICK_BOUND = 2.0
LONG_PEAK_BYTES = 60e9
# every dry-run cell OK or SKIPPED, these skipped and no other: the
# reference's four long_500k
DRYRUN_SKIPS = {("olmoe-1b-7b", "long_500k"),
                ("moonshot-v1-16b-a3b", "long_500k"),
                ("qwen2.5-32b", "long_500k"),
                ("phi3-medium-14b", "long_500k")}
# mixed-precision LM training: OLMoE at its published widths through
# get_bundle's train_4k (bf16 compute on fp32 masters), cut in depth and
# batch; timed steps after one warm-up; the peak device memory allowed
# (6 layers hold 2.72e9 weights: 43.6 GB of masters, gradients and
# moments, ~8 GB of activations, logits, MoE buffers and the update's
# pieces)
BF16_TRAIN_LAYERS = 6
BF16_TRAIN_BATCH = 2
BF16_TRAIN_STEPS = 5
BF16_TRAIN_PEAK_BYTES = 60e9
# the host-staging baseline: the reference's --residency sets (cbo, ic),
# run warm on phase 9's sf=1 store (at sf=100 the staged runs took 163.1 s
# on an NVIDIA H100 80GB HBM3, 700.00 W: over a 120 s budget)
RESIDENCY_SETS = ("Qc", "ic")
RESIDENCY_REDUCED = (
    "residency runs on phase 9's sf=1 store, not phase 4's sf=100: there "
    "the staged set's two runs of the 14 queries take over 120 s (Qc3b "
    "alone downloads 1.0e10 padded elements a run) and 5 of the 14 stop "
    "at the blow-up guard on both sets")
# the update stream at sf=100: a round's writes (edge inserts, deletes of
# base KNOWS edges, PERSON inserts; base PERSON deletes in the last round
# only), its reads, the chunks they interleave in, the reads a round held
# to the host spec, and the slack on device memory after compaction
MUTATE_ROUNDS = 16
MUTATE_SIZES = {"edge_inserts": 32_768, "edge_deletes": 1_024,
                "persons": 256, "vertex_deletes": 1_024, "reads": 512}
MUTATE_CHUNKS = 8
MUTATE_SAMPLE = 32
MUTATE_MEMORY_SLACK = 0.10
# the same script, scaled down, for the cuda-vs-cpu check at sf=1
CHECK_MUTATE_SIZES = {"edge_inserts": 2_048, "edge_deletes": 128,
                      "persons": 32, "vertex_deletes": 64, "reads": 0}
# chaos: KNOWS inserts before the faulted reads, and the latency spike
CHAOS_WRITES = 64
CHAOS_LATENCY_S = 0.2

# The 25 benchmark queries (the paper's Appendix A on the LDBC schema
# subset, plus LDBC interactive-complex-like queries): name, text, params.
QUERIES = [
    ("Qt1", "Match (p)<-[:HASCREATOR]-(m)<-[:CONTAINEROF]-(f) "
            "Return count(p)", None),
    ("Qt2", "Match (p)-[]->(o:ORGANISATION)-[]->(c:COUNTRY) Return count(p)",
     None),
    ("Qt3", "Match (p)<-[:ISLOCATEDIN]-(x)-[]->(t:TAG) Return count(p)",
     None),
    ("Qt4", "Match (p1)<-[]-(p2:POST), (p1)<-[:HASMODERATOR]-(f)-[]->(p2) "
            "Return count(p1)", None),
    ("Qt5", "Match (p1:POST)-[]->(p2), (p2)-[]->(c:CITY) Return count(p2)",
     None),
    ("Qr1", "Match (message:COMMENT|POST)-[:HASCREATOR]->(person:PERSON), "
            "(message)-[:HASTAG]->(tag:TAG), "
            "(person)-[:HASINTEREST]->(tag) Return count(person)", None),
    ("Qr2", "Match (p:COMMENT)-[]->(p2:PERSON)-[]->(c:CITY), "
            "(p)<-[]-(message), (message)-[]->(tag:TAG) Return count(c)",
     None),
    ("Qr3", "Match (author:PERSON)<-[:HASCREATOR]-(msg1:POST|COMMENT) "
            "Return count(author)", None),
    ("Qr4", "Match (author:PERSON)<-[:HASCREATOR]-(msg1:POST|COMMENT) "
            "Where msg1.length > $len Return count(author)", {"len": 128}),
    ("Qr5", "Match (p1:PERSON)-[:KNOWS]->(p2:PERSON) "
            "Where p1.id = $id1 and p2.id = $id2 Return count(p1)",
     {"id1": 3, "id2": 7}),
    ("Qr6", "Match (p1:PERSON)-[:KNOWS]->(p2:PERSON)-[:LIKES]->"
            "(comment:COMMENT) Where p1.id = $id1 and p2.id = $id2 and "
            "comment.length > $len Return count(p1)",
     {"id1": 3, "id2": 7, "len": 64}),
    ("Qc1a", "Match (message:POST|COMMENT)-[:HASCREATOR]->(person:PERSON), "
             "(message)-[:HASTAG]->(tag:TAG), "
             "(person)-[:HASINTEREST]->(tag) Return count(person)", None),
    ("Qc1b", "Match (message:PERSON|FORUM)-[:KNOWS|HASMODERATOR]->"
             "(person:PERSON), (message)-[]->(tag:TAG), "
             "(person)-[]->(tag) Return count(person)", None),
    ("Qc2a", "Match (person1:PERSON)-[:LIKES]->(message:POST|COMMENT), "
             "(message)-[:HASCREATOR]->(person2:PERSON), "
             "(person1)<-[:HASMODERATOR]-(place:FORUM), "
             "(person2)<-[:HASMODERATOR]-(place) Return count(person1)",
     None),
    ("Qc2b", "Match (person1:PERSON)-[:LIKES]->(message:POST), "
             "(message)<-[:CONTAINEROF]-(person2:FORUM), "
             "(person1)-[:KNOWS|HASINTEREST]->(place:PERSON|TAG), "
             "(person2)-[:HASMODERATOR|HASTAG]->(place) "
             "Return count(person1)", None),
    ("Qc3a", "Match (person1:PERSON)<-[:HASCREATOR]-(comment:COMMENT), "
             "(comment)-[:REPLYOF]->(post:POST), "
             "(post)<-[:CONTAINEROF]-(forum:FORUM), "
             "(forum)-[:HASMEMBER]->(person2:PERSON) Return count(person1)",
     None),
    ("Qc3b", "Match (p:COMMENT)-[]->(pp:PERSON)-[]->(ct:CITY), "
             "(p)<-[]-(message), (message)-[]->(tag:TAG) Return count(p)",
     None),
    ("Qc4a", "Match (forum:FORUM)-[:CONTAINEROF]->(post:POST), "
             "(forum)-[:HASMEMBER]->(person1:PERSON), "
             "(forum)-[:HASMEMBER]->(person2:PERSON), "
             "(person1)-[:KNOWS]->(person2), "
             "(person1)-[:LIKES]->(post), "
             "(person2)-[:LIKES]->(post) Return count(person1)", None),
    ("Qc4b", "Match (forum:FORUM)-[:HASTAG]->(post:TAG), "
             "(forum)-[:HASMODERATOR]->(person1:PERSON), "
             "(forum)-[:HASMODERATOR|CONTAINEROF]->(person2:PERSON|POST), "
             "(person1)-[:KNOWS|LIKES]->(person2), "
             "(person1)-[:HASINTEREST]->(post), "
             "(person2)-[:HASINTEREST|HASTAG]->(post) "
             "Return count(person1)", None),
    ("ic1", "MATCH (p:PERSON)-[:KNOWS*2]-(friend:PERSON) "
            "WHERE p.id = $pid RETURN friend, count(p) AS c "
            "ORDER BY c DESC LIMIT 20", {"pid": 5}),
    ("ic3", "MATCH (p:PERSON)-[:KNOWS]-(friend:PERSON), "
            "(friend)<-[:HASCREATOR]-(m:POST|COMMENT), "
            "(m)-[:HASTAG]->(t:TAG) WHERE p.id = $pid "
            "RETURN friend, count(m) AS cnt ORDER BY cnt DESC LIMIT 20",
     {"pid": 5}),
    ("ic5", "MATCH (p:PERSON)-[:KNOWS]-(friend:PERSON), "
            "(friend)<-[:HASMEMBER]-(f:FORUM), "
            "(f)-[:CONTAINEROF]->(post:POST), "
            "(post)-[:HASCREATOR]->(friend) WHERE p.id = $pid "
            "RETURN f, count(post) AS posts ORDER BY posts DESC LIMIT 20",
     {"pid": 5}),
    ("ic6", "MATCH (p:PERSON)-[:KNOWS*2]-(friend:PERSON), "
            "(friend)<-[:HASCREATOR]-(post:POST), "
            "(post)-[:HASTAG]->(t:TAG) WHERE p.id = $pid "
            "RETURN t, count(post) AS cnt ORDER BY cnt DESC LIMIT 10",
     {"pid": 5}),
    ("ic11", "MATCH (p:PERSON)-[:KNOWS]-(friend:PERSON), "
             "(friend)-[:WORKAT]->(org:ORGANISATION), "
             "(org)-[:ISLOCATEDIN]->(c:COUNTRY) WHERE p.id = $pid "
             "RETURN friend, org, count(c) AS n ORDER BY n LIMIT 10",
     {"pid": 5}),
    ("ic12", "MATCH (p:PERSON)-[:KNOWS]-(friend:PERSON), "
             "(friend)<-[:HASCREATOR]-(comment:COMMENT), "
             "(comment)-[:REPLYOF]->(post:POST), (post)-[:HASTAG]->(t:TAG), "
             "(t)-[:HASTYPE]->(tc:TAGCLASS) WHERE p.id = $pid "
             "RETURN friend, count(comment) AS cnt "
             "ORDER BY cnt DESC LIMIT 20", {"pid": 5}),
]


# The update stream's reads, each with ``$pid`` (a ``PERSON.id``).  ic3p
# and ic11p are ic3 and ic11 of QUERIES returning ``friend.id`` (and
# ``org.id``) with a full ORDER BY, so rows compare across compaction,
# which renumbers vertices; QUERIES (the benchmark set) has no $pid query
# cyclic over KNOWS, whose probes hit the insert and tombstone views, nor
# a $pid chain off the written triples, which stays fused while the
# overlay grows.
MUTATE_QUERIES = [
    ("ic11p", "MATCH (p:PERSON)-[:KNOWS]-(friend:PERSON), "
              "(friend)-[:WORKAT]->(org:ORGANISATION), "
              "(org)-[:ISLOCATEDIN]->(c:COUNTRY) WHERE p.id = $pid "
              "RETURN friend.id AS fid, org.id AS oid, count(c) AS n "
              "ORDER BY n, fid, oid LIMIT 10"),
    ("ic3p", "MATCH (p:PERSON)-[:KNOWS]-(friend:PERSON), "
             "(friend)<-[:HASCREATOR]-(m:POST|COMMENT), "
             "(m)-[:HASTAG]->(t:TAG) WHERE p.id = $pid "
             "RETURN friend.id AS fid, count(m) AS cnt "
             "ORDER BY cnt DESC, fid LIMIT 20"),
    ("knows_triangle", "MATCH (p:PERSON)-[:KNOWS]->(a:PERSON), "
                       "(p)-[:KNOWS]->(b:PERSON), (a)-[:KNOWS]->(b) "
                       "WHERE p.id = $pid RETURN count(a) AS n"),
    ("creator_tags", "MATCH (p:PERSON)<-[:HASCREATOR]-(m:POST), "
                     "(m)-[:HASTAG]->(t:TAG), (t)-[:HASTYPE]->(c:TAGCLASS) "
                     "WHERE p.id = $pid RETURN c.id AS cid, count(m) AS n "
                     "ORDER BY cid"),
]


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, batch: int = 1,
            queued: bool = False, cold: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each bracketed by
    CUDA events on the current stream.  With ``batch`` > 1 a run is that
    many calls back to back, divided by their count: the device's time per
    call once the host's launch overhead hides behind the queued work.
    With ``queued`` the device first sleeps ``QUEUE_CYCLES`` clock cycles,
    so the host has queued the whole batch before the first event fires
    even where one call's host time exceeds its device time.  With ``cold``
    the device also writes ``FLUSH_BYTES`` (twice the 50 MB L2) before
    each run, so the run reads its inputs from device memory, as a
    serving step that has touched every layer since finds them."""
    import torch
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if queued or cold:
            torch.cuda._sleep(QUEUE_CYCLES)
        if cold:
            flush.zero_()
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


# ------------------------------------------------------------------ kernel

def search_steps(indptr, rows):
    """Binary-search steps the probes of ``rows`` take:
    sum of ceil(log2(degree + 1)) over the probed rows."""
    import torch
    r = rows.to(torch.int64)
    deg = (indptr[r + 1] - indptr[r]).to(torch.float64)
    return int(torch.ceil(torch.log2(deg + 1)).sum())


def synthetic_probe(seed: int, device):
    """The in-adjacency of an edge set drawn as ``graphdb/ldbc.py`` draws a
    many-edge triple, plus 2^24 probes into it.  2^24 edges run from
    uniform sources over 180,000 vertices (PERSON at sf=100) to targets over
    2^20 vertices drawn by the generator's own Zipf(a=1.3) sampler
    (``_zipf_targets``), deduplicated as ``build_store`` does; rows are the
    targets, so in-degrees follow the generator's skew, capped near the
    source count.  Probe rows are drawn per edge (degree-weighted, as a
    WCOJ step probes), half the targets aim at a real neighbour, and one
    probe in sixteen goes to a uniformly random row, possibly empty.
    Returns the probe's arguments and the CSR's search index."""
    import numpy as np
    import torch
    from repro_torch.graphdb.ldbc import _zipf_targets
    from repro_torch.kernels.wcoj_intersect.ops import build_search_index
    rng = np.random.default_rng(seed)
    n_rows, n_src, n_edges, n_probe = 1 << 20, 180_000, 1 << 24, 1 << 24
    src = rng.integers(0, n_src, size=n_edges, dtype=np.int64)
    dst = _zipf_targets(rng, n_edges, n_rows)
    key = torch.unique((torch.from_numpy(dst).to(device) << 32)
                       | torch.from_numpy(src).to(device))  # sorted, dedup
    row, nbr = key >> 32, key & 0xFFFFFFFF
    counts = torch.bincount(row, minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(counts, 0)
    nnz = nbr.shape[0]
    g = torch.Generator(device=device).manual_seed(seed)
    pick = torch.randint(0, nnz, (n_probe,), generator=g, device=device)
    prow = row[pick]
    tgt = torch.randint(0, n_src, (n_probe,), generator=g, device=device)
    # half the probes aim at a random slot of their own row (a hit)
    aim = torch.rand(n_probe, generator=g, device=device) < 0.5
    slot = indptr[prow] + (torch.rand(n_probe, generator=g, device=device)
                           * counts[prow]).to(torch.int64)
    tgt = torch.where(aim, nbr[slot.clamp(max=nnz - 1)], tgt)
    anyrow = torch.rand(n_probe, generator=g, device=device) < 1 / 16
    prow = torch.where(anyrow, torch.randint(0, n_rows, (n_probe,),
                                             generator=g, device=device),
                       prow)
    pos_map = torch.randperm(nnz, generator=g, device=device)
    i32 = torch.int32
    indices = nbr.to(i32)
    return (indptr.to(i32), indices, prow.to(i32).contiguous(),
            tgt.to(i32).contiguous(), pos_map.to(i32),
            build_search_index(indices))


def probe_phase(label: str, indptr, indices, rows, targets, pos_map, index,
                reps: int = REPS) -> dict:
    """The probe on its ``fence`` route (the main path's) and its
    ``search`` route against the plain version on one probe set: exact
    equality on both, their times over batches of ``PROBE_BATCH`` calls
    queued behind a device sleep (and the fence route's one-call time),
    the index's build time, the one-call yardstick and the bound."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.wcoj_intersect.ops import (build_search_index,
                                                        route,
                                                        wcoj_intersect)
    from repro_torch.kernels.wcoj_intersect.ref import (fence_reads,
                                                        wcoj_intersect_ref)
    args = (indptr, indices, rows, targets, pos_map)
    which = route(indices, index)
    require(which == "fence", f"{label}: route {which}, expected fence")
    counted = dict(kernels.LAUNCHES)
    got = {"fence": wcoj_intersect(*args, index),
           "search": wcoj_intersect(*args)}
    want = wcoj_intersect_ref(*args)
    torch.cuda.synchronize()
    for r in got:
        key = f"wcoj_intersect.{r}"
        require(kernels.LAUNCHES.get(key, 0) == counted.get(key, 0) + 1,
                f"{label}: no {key} launch")
    names = ("found", "epos")
    err = 0
    for r, out in got.items():
        for n, a, b in zip(names, out, want):
            require(a.dtype == b.dtype and a.shape == b.shape,
                    f"{label}: {r} {n} dtype/shape differ from the plain "
                    f"version")
        e = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                if a.numel() else 0 for a, b in zip(out, want))
        require(all(torch.equal(a, b) for a, b in zip(out, want)),
                f"{label}: the {r} kernel differs from the plain version "
                f"(max abs err {e})")
        err = max(err, e)
    R = rows.shape[0]
    hits = int(want[0].sum())
    deg = (indptr[1:] - indptr[:-1]).to(torch.int64)
    pdeg = deg[rows.to(torch.int64)]
    steps = search_steps(indptr, rows)
    # a delta view's indices run past its last row's end (zeros to a
    # power of two): count the keys the rows hold
    nnz = int(indptr[-1])
    # compulsory traffic, each input read at most once: rows and targets;
    # two indptr words and one indices word per probe, but no more than
    # those arrays hold; one pos_map word per hit, likewise capped; found
    # (1 B) and epos (4 B) written once
    nbytes = (R * (4 + 4 + 1 + 4) + min(4 * indptr.shape[0], 8 * R)
              + min(4 * nnz, 4 * R))
    if pos_map is not None:
        nbytes += min(4 * nnz, 4 * hits)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = steps / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)

    def fence():
        return wcoj_intersect(*args, index)

    # one call per event pair would add the wrapper's host time (kept as
    # kernel_ms_single): batches queued behind a device sleep
    kernel_ms = cuda_ms(fence, reps, batch=PROBE_BATCH, queued=True)
    search_ms = cuda_ms(lambda: wcoj_intersect(*args), reps,
                        batch=PROBE_BATCH, queued=True)
    index_build_ms = cuda_ms(lambda: build_search_index(indices), reps)
    plain_ms = cuda_ms(lambda: wcoj_intersect_ref(*args), max(3, reps // 4),
                       warmup=1)
    # yardstick: one torch.searchsorted over packed (row << 32 | nbr) keys,
    # precomputed per CSR (not part of the port)
    edge_row = torch.repeat_interleave(
        torch.arange(deg.shape[0], device=deg.device), deg)
    keys = (edge_row << 32) | indices[:nnz].to(torch.int64)
    q = (rows.to(torch.int64) << 32) + targets.to(torch.int64)
    library_ms = cuda_ms(lambda: torch.searchsorted(keys, q), reps,
                         batch=PROBE_BATCH, queued=True)
    return {"phase": "kernel", "name": "wcoj_intersect", "input": label,
            "route": which, "rows": R, "nnz": nnz,
            "nnz_cap": int(indices.shape[0]),
            "csr_rows": int(deg.shape[0]), "max_degree": int(deg.max()),
            "mean_probe_degree": float(pdeg.to(torch.float64).mean()),
            "hits": hits, "equal": True, "max_abs_err": err,
            "kernel_ms": kernel_ms, "kernel_ms_single": cuda_ms(fence, reps),
            "search_ms": search_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "pct_of_bound": 100 * bound_ms / kernel_ms,
            "kernel_over_library": kernel_ms / library_ms,
            "index_bytes": index.numel() * index.element_size(),
            "index_build_ms": index_build_ms,
            "bytes": nbytes, "search_steps": steps,
            "sector_reads": fence_reads(indptr, rows)}


def probe_gates(rec: dict) -> None:
    """K1's limits on one kernel phase: its ms queued, its ms against the
    search route's, and faster than the ``searchsorted`` yardstick."""
    label, ms = rec["input"], rec["kernel_ms"]
    if label in PROBE_LIMIT_MS:
        require(ms <= PROBE_LIMIT_MS[label],
                f"{label}: fence {ms:.4g} ms > {PROBE_LIMIT_MS[label]} ms")
    if label in PROBE_SEARCH_RATIO:
        limit = PROBE_SEARCH_RATIO[label] * rec["search_ms"]
        require(ms <= limit, f"{label}: fence {ms:.4g} ms > "
                             f"{PROBE_SEARCH_RATIO[label]} x search "
                             f"{rec['search_ms']:.4g} ms")
    require(ms < rec["library_ms"], f"{label}: fence {ms:.4g} ms not "
                                    f"faster than searchsorted "
                                    f"{rec['library_ms']:.4g} ms")


# --------------------------------------------------------------- main path

def run_queries(gopt, reps: int = 2) -> list[dict]:
    """Every benchmark query ``reps`` times; the blow-up cap
    (``max_rows``) refusing a query is an outcome, any other error a
    failure."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.physical_spec import TransferStats
    out = []
    for name, text, params in QUERIES:
        rec = {"name": name, "probe_launches": []}
        prev = None
        for rep in range(reps):
            launched = kernels.LAUNCHES.get("wcoj_intersect", 0)
            t0 = time.perf_counter()
            try:
                tbl, st = gopt.run(text, params)
                torch.cuda.synchronize()
            except RuntimeError as exc:
                if "intermediate blow-up" not in str(exc):
                    raise
                torch.cuda.synchronize()
                rec.update(outcome="blowup", error=str(exc)[:160])
                rec["ms" if rep else "first_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                rec["probe_launches"].append(
                    kernels.LAUNCHES.get("wcoj_intersect", 0) - launched)
                continue
            rec["probe_launches"].append(
                kernels.LAUNCHES.get("wcoj_intersect", 0) - launched)
            ms = (time.perf_counter() - t0) * 1e3
            rec["ms" if rep else "first_ms"] = ms
            cols = {k: np.asarray(v) for k, v in tbl.cols.items()}
            for k, v in cols.items():
                require(v.shape == (tbl.nrows,),
                        f"{name}: column {k} has shape {v.shape}")
                if v.dtype.kind == "f":
                    require(bool(np.isfinite(v).all()),
                            f"{name}: non-finite values in {k}")
            if prev is not None:
                require(set(prev) == set(cols) and all(
                    np.array_equal(prev[k], cols[k]) for k in cols),
                    f"{name}: repeated run gave another result")
            prev = cols
            d2h = TransferStats.mid_plan_d2h(st.transfers)
            require(d2h == 0, f"{name}: {d2h} mid-plan device->host copies")
            k = st.kernels or {}
            rec.update(outcome="ok", rows=tbl.nrows,
                       rows_produced=st.rows_produced, mid_plan_d2h=d2h)
            # per run: the first measures each chain on the loop, the
            # second dispatches it fused
            for key, label in (("intersect_dispatches", "dispatch:intersect"),
                               ("fused_dispatches", "dispatch:fused_chain"),
                               ("fused_compiles", "compile:fused_chain"),
                               ("chain_probes", "probe:fused_chain")):
                rec.setdefault(key, []).append(k.get(label, 0))
            rec["fallbacks"] = st.fallbacks
            # every probe of the run is one kernel launch: inside a fused
            # chain, or one intersect operator call
            require(rec["probe_launches"][-1]
                    == rec["chain_probes"][-1]
                    + rec["intersect_dispatches"][-1],
                    f"{name}: {rec['probe_launches'][-1]} wcoj_intersect "
                    f"launches, {rec['chain_probes'][-1]} chain probes and "
                    f"{rec['intersect_dispatches'][-1]} intersects")
        out.append(rec)
    return out


def capture_glogue(ops) -> dict:
    """Wraps ``ops.intersect`` so each call is counted and the heaviest two
    kept (inputs stay on the card): the one with the most probes and the
    one with the most binary-search steps.  ``del ops.intersect`` ends it;
    ``glogue_probes`` turns the record into kernel inputs."""
    calls = {"n": 0, "rows": 0, "steps": 0, "most_rows": None,
             "most_steps": None}
    real_intersect = ops.intersect

    def capture(csr, rows_local, targets):
        # the step count costs one reduction and one sync per call
        n = int(rows_local.shape[0])
        if n:                           # an empty probe launches nothing
            steps = search_steps(ops._csr_dev(csr)[0],
                                 ops._col(rows_local))
            calls["n"] += 1
            calls["rows"] += n
            calls["steps"] += steps
            call = (n, steps, csr, rows_local, targets)
            if calls["most_rows"] is None or n > calls["most_rows"][0]:
                calls["most_rows"] = call
            if calls["most_steps"] is None or steps > calls["most_steps"][1]:
                calls["most_steps"] = call
        return real_intersect(csr, rows_local, targets)

    ops.intersect = capture
    return calls


def glogue_probes(ops, calls: dict) -> dict:
    """``{"glogue_most_rows" | "glogue_most_steps": (indptr, indices,
    rows, targets, pos_map, index)}`` of the captured calls."""
    import torch
    probes = {}
    for label in ("most_rows", "most_steps"):
        _, _, csr, rows, targets = calls[label]
        indptr, indices, pos, index = ops._csr_dev(csr, probe=True)
        probes[f"glogue_{label}"] = (
            indptr, indices, ops._col(rows).to(torch.int32).contiguous(),
            ops._col(targets).to(torch.int32).contiguous(), pos, index)
    return probes


def main_path(sf: float) -> tuple[dict, dict, object, object, object]:
    """Store -> GOpt on cuda -> the 25 queries twice.  Returns the phase
    record, the inputs of two GLogue intersect calls (with their CSR's
    search index): the one with the most probes and the one with the most
    search steps, the store (the update stream writes to it), the GOpt
    (phase ``gremlin`` runs through it) and the host CSR of the call with
    the most probes (phase ``sharded_probe`` partitions it)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.gopt import GOpt
    from repro_torch.graphdb.ldbc import generate_ldbc
    from repro_torch.graphdb.torch_backend import torch_spec
    t0 = time.perf_counter()
    store = generate_ldbc(sf=sf, seed=7)
    gen_s = time.perf_counter() - t0
    ops = torch_spec("cuda").operators(store)
    calls = capture_glogue(ops)
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gopt = GOpt(store)
    torch.cuda.synchronize()
    gopt_s = time.perf_counter() - t0
    glogue_launches = kernels.LAUNCHES.get("wcoj_intersect", 0)
    del ops.intersect                   # the queries run unwrapped
    require(gopt.spec.name == "torch", "GOpt did not resolve the cuda spec")
    queries = run_queries(gopt)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(launches.get("wcoj_intersect", 0) > 0,
            "main path launched no wcoj_intersect kernel")
    require(glogue_launches == calls["n"] > 0,
            "GLogue intersect calls and kernel launches disagree")
    ok = [q for q in queries if q["outcome"] == "ok"]
    chains = {key: sum(sum(q.get(key, [])) for q in ok)
              for key in ("intersect_dispatches", "fused_dispatches",
                          "fused_compiles", "chain_probes")}
    require(chains["fused_dispatches"] > 0,
            "main path dispatched no fused chain")
    require(chains["chain_probes"] > 0,
            "no wcoj_intersect launch from inside a fused chain")
    require(launches["wcoj_intersect"] - glogue_launches == sum(
        sum(q["probe_launches"]) for q in queries),
        "query runs and wcoj_intersect launches disagree")
    require(launches.get("wcoj_intersect.fence", 0)
            == launches["wcoj_intersect"],
            f"{launches.get('wcoj_intersect.fence', 0)} of "
            f"{launches['wcoj_intersect']} wcoj_intersect launches on the "
            f"fence route")
    rec = {"phase": "main", "sf": sf, "vertices": store.n_vertices,
           "edges": store.n_edges, "generate_s": gen_s, "gopt_s": gopt_s,
           "glogue_freqs": len(gopt.glogue.freq),
           "glogue_intersect_calls": calls["n"],
           "glogue_intersect_launches": glogue_launches,
           "glogue_probed_rows": calls["rows"],
           "glogue_search_steps": calls["steps"],
           "launches": launches,
           "query_intersect_launches": chains["intersect_dispatches"],
           "chain_probe_launches": chains["chain_probes"],
           "fused_chain_dispatches": chains["fused_dispatches"],
           "fused_chain_compiles": chains["fused_compiles"],
           "queries_ok": len(ok),
           "queries_blowup": len(queries) - len(ok),
           "warm_ms_total_ok": sum(q["ms"] for q in ok),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "queries": queries}
    return (rec, glogue_probes(ops, calls), store, gopt,
            calls["most_rows"][2])


def residency_path(gopt, sf: float) -> dict:
    """The residency sets' 14 queries (``cbo``, ``ic``) on ``gopt``'s store
    (phase 9's, at scale factor ``sf``), each run warm on the resident cuda set (``gopt.execute``) and through
    ``HostStagingOperators`` over the same set (host columns, padded
    blocks sent to the card and back on every expand and probe): one
    warm-up run each, then one timed run.  Identical rows (or both at the
    blow-up guard), no mid-plan download on the resident set and some on
    the staged one, and every K1 launch of the staged runs on ``fence``,
    one a probed slab (the staged set's ``dispatch:intersect``)."""
    import torch
    from repro_torch import kernels
    from repro_torch.core.physical_spec import TransferStats
    from repro_torch.graphdb.engine import Engine
    from repro_torch.graphdb.host_staging import HostStagingOperators
    t_phase = time.perf_counter()
    staged = HostStagingOperators(gopt.spec.operators(gopt.store))

    def timed(run):
        out, t_all = None, time.perf_counter()
        for _ in range(2):                      # a warm-up, then the timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                tbl, st = run()
                torch.cuda.synchronize()
                out = (tbl, st, None)
            except RuntimeError as exc:
                if "intermediate blow-up" not in str(exc):
                    raise
                torch.cuda.synchronize()
                out = (None, None, str(exc)[:160])
        now = time.perf_counter()
        return out + ((now - t0) * 1e3, (now - t_all) * 1e3)

    kernels.reset_launches()
    recs, slabs, staged_ms = [], 0, 0.0
    for name, text, params in QUERIES:
        if not name.startswith(RESIDENCY_SETS):
            continue
        opt = gopt.optimize(text, params)
        res, rst, rerr, res_ms, _ = timed(
            lambda: gopt.execute(opt, params=params))
        before = dict(kernels.LAUNCHES)
        eng = Engine(gopt.store, backend=staged)
        stg, sst, serr, stg_ms, both_ms = timed(
            lambda: eng.run(opt.logical, opt.physical, params=params))
        launched = {k: kernels.LAUNCHES.get(k, 0) - before.get(k, 0)
                    for k in ("wcoj_intersect", "wcoj_intersect.fence")}
        staged_ms += both_ms
        rec = {"name": name, "resident_ms": res_ms, "staged_ms": stg_ms}
        require((rerr is None) == (serr is None),
                f"residency {name}: resident {rerr}, staged {serr}")
        if rerr is not None:
            rec["outcome"] = "blowup"
            recs.append(rec)
            continue
        _rows_equal(name, "staged vs resident", stg, res)
        n = sst.kernels.get("dispatch:intersect", 0)
        # two runs of the plan: the warm-up's slabs and the timed run's
        require(launched["wcoj_intersect"] == 2 * n
                and launched["wcoj_intersect.fence"] == 2 * n,
                f"residency {name}: {launched} K1 launches over two runs, "
                f"{n} probed slabs a run")
        slabs += n
        rec.update(outcome="ok", rows=res.nrows,
                   resident_mid_plan_d2h=TransferStats.mid_plan_d2h(
                       rst.transfers),
                   staged_mid_plan_d2h=TransferStats.mid_plan_d2h(
                       sst.transfers),
                   staged_slabs_probed=n,
                   resident_transfers=rst.transfers,
                   staged_transfers=sst.transfers,
                   speedup=stg_ms / res_ms if res_ms else None)
        require(rec["resident_mid_plan_d2h"] == 0,
                f"residency {name}: the resident set downloaded mid-plan")
        require(rec["staged_mid_plan_d2h"] > 0,
                f"residency {name}: the staged set downloaded nothing")
        recs.append(rec)
    launches = dict(kernels.LAUNCHES)
    require(len(recs) == 14, f"residency: {len(recs)} queries, expected 14")
    require(slabs > 0 and launches.get("wcoj_intersect", 0) > 0,
            "residency: the staged set launched no K1")
    require(launches.get("wcoj_intersect.fence", 0)
            == launches["wcoj_intersect"],
            f"residency: K1 launches {launches}, not all on fence")
    ok = [r for r in recs if r["outcome"] == "ok"]
    return {"phase": "residency", "sf": sf, "queries": len(recs),
            "queries_ok": len(ok), "staged_slabs_probed": slabs,
            "launches": launches,
            "resident_ms_total_ok": sum(r["resident_ms"] for r in ok),
            "staged_ms_total_ok": sum(r["staged_ms"] for r in ok),
            "staged_ms_both_runs": staged_ms,
            "results": recs, "reduced": [RESIDENCY_REDUCED],
            "seconds": time.perf_counter() - t_phase}


def _rows_equal(name: str, what: str, a, b) -> None:
    import numpy as np
    require(a.nrows == b.nrows and set(a.cols) == set(b.cols),
            f"{name}: result shapes differ ({what})")
    for k in a.cols:
        x, y = np.asarray(a.cols[k]), np.asarray(b.cols[k])
        require(x.dtype == y.dtype and np.array_equal(x, y),
                f"{name}: column {k} differs ({what})")


def cross_check(sf: float) -> tuple[dict, object]:
    """GLogue, plans and results on cuda equal those on cpu; once each
    chain is measured, the fused chains on cuda, the per-hop loop on cuda
    and the fused chains on cpu give identical rows.  Returns the record
    and the cuda ``GOpt`` (the ``residency`` phase runs on its store)."""
    from repro_torch.core.gopt import GOpt
    from repro_torch.core.physical import plan_signature
    from repro_torch.graphdb.ldbc import generate_ldbc
    store = generate_ldbc(sf=sf, seed=7)
    t0 = time.perf_counter()
    gc = GOpt(store)
    gh = GOpt(store, device="cpu")
    require(gc.spec.name == "torch" and gh.spec.name == "torch[cpu]",
            "device specs not pinned")
    require(gc.glogue.freq == gh.glogue.freq,
            "GLogue frequencies differ between cuda and cpu")
    rows, fused = 0, {"cuda": 0, "cpu": 0}
    for name, text, params in QUERIES:
        oc, oh = gc.optimize(text, params), gh.optimize(text, params)
        require(plan_signature(oc.physical) == plan_signature(oh.physical),
                f"{name}: plans differ between cuda and cpu")
        tc, _ = gc.execute(oc, params=params)          # measuring runs
        th, _ = gh.execute(oh, params=params)
        _rows_equal(name, "cuda vs cpu, first run", tc, th)
        fc, sc = gc.execute(oc, params=params)
        lc, _ = gc.execute(oc, params=params, chain_dispatch=False)
        fh, shh = gh.execute(oh, params=params)
        _rows_equal(name, "fused cuda vs loop cuda", fc, lc)
        _rows_equal(name, "fused cuda vs fused cpu", fc, fh)
        _rows_equal(name, "fused cuda vs first run", fc, tc)
        fused["cuda"] += (sc.kernels or {}).get("dispatch:fused_chain", 0)
        fused["cpu"] += (shh.kernels or {}).get("dispatch:fused_chain", 0)
        rows += tc.nrows
    require(fused["cuda"] > 0 and fused["cuda"] == fused["cpu"],
            f"fused chain dispatches: {fused}")
    return {"phase": "check", "sf": sf, "queries": len(QUERIES),
            "result_rows": rows, "glogue_freqs": len(gc.glogue.freq),
            "fused_chain_dispatches": fused, "identical": True,
            "seconds": time.perf_counter() - t0}, gc


# ---------------------------------------- Gremlin and the sharded backend

GREMLIN_TWO_HOP = ("MATCH (v1:PERSON)-[:WORKAT]->(v2:ORGANISATION)"
                   "-[:ISLOCATEDIN]->(v3:COUNTRY) WHERE v3.name = 'China' "
                   "RETURN v1, count(*) AS n")
GREMLIN_BINDINGS = [{"pid": 5}, {"pid": 1234}]
SHARDED_PROBE_SHARDS = 4


def gremlin_traversals(schema) -> list[tuple]:
    """Phase ``gremlin``'s traversals beside their Cypher twins: ``(name,
    traversal factory, cypher text, bindings)``.  The first is the Gremlin
    module docstring's 2-hop group count on the LDBC schema
    (PERSON-WORKAT->ORGANISATION-ISLOCATEDIN->COUNTRY 'China'), the second
    ic3 with ``$pid`` bound late through ``.param``."""
    from repro_torch.core import ir
    from repro_torch.core.gremlin import g

    def two_hop():
        return (g(schema).V("PERSON").as_("v1").out("WORKAT")
                .as_("v2", types=["ORGANISATION"]).out("ISLOCATEDIN")
                .as_("v3", types=["COUNTRY"])
                .where(ir.Cmp("=", ir.Prop("v3", "name"), ir.Lit("China")))
                .group_count("v1", as_="n"))

    def ic3():
        t = g(schema)
        (t.V("PERSON").as_("p").both("KNOWS")
         .as_("friend", types=["PERSON"])
         .in_("HASCREATOR").as_("m", types=["POST", "COMMENT"])
         .out("HASTAG").as_("t", types=["TAG"])
         .where(ir.Cmp("=", ir.Prop("p", "id"), t.param("pid"))))
        return (t.group_by([(ir.Var("friend"), "friend")],
                           [(ir.Agg("COUNT", ir.Var("m")), "cnt")])
                .order_by((ir.Var("cnt"), False)).limit(20).plan())

    ic3_text = next(text for name, text, _ in QUERIES if name == "ic3")
    return [("two_hop_group_count", two_hop, GREMLIN_TWO_HOP, [None]),
            ("ic3_param", ic3, ic3_text, GREMLIN_BINDINGS)]


def gremlin_path(gopt) -> dict:
    """Two Gremlin traversals through the main path's ``GOpt`` on cuda:
    each with the canonical GIR of its Cypher twin, prepared once (the
    twin's cached plan), run per binding with rows identical to the
    twin's."""
    import torch
    from repro_torch.core import ir
    from repro_torch.core.parser import parse_cypher
    from repro_torch.core.physical_spec import TransferStats
    out = []
    for name, make, text, bindings in gremlin_traversals(gopt.schema):
        plan = make()
        require(ir.canonical_form(plan)
                == ir.canonical_form(parse_cypher(text, gopt.schema)),
                f"gremlin {name}: GIR differs from its Cypher twin")
        t0 = time.perf_counter()
        pq = gopt.prepare(plan)
        prepare_ms = (time.perf_counter() - t0) * 1e3
        require(pq is gopt.prepare(text),
                f"gremlin {name}: not the Cypher twin's cached plan")
        runs = []
        for params in bindings:
            t0 = time.perf_counter()
            tbl, st = pq.execute(params)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want, _ = gopt.run(text, params)
            _rows_equal(name, "gremlin vs cypher", tbl, want)
            d2h = TransferStats.mid_plan_d2h(st.transfers)
            require(d2h == 0, f"gremlin {name}: {d2h} mid-plan copies")
            runs.append({"params": params, "rows": tbl.nrows, "ms": ms})
        out.append({"name": name, "prepare_ms": prepare_ms, "runs": runs})
    require(any(r["rows"] for t in out for r in t["runs"]),
            "gremlin: every traversal came back empty")
    return {"phase": "gremlin", "sf": SF, "gir_equal": True,
            "rows_equal": True, "traversals": out}


def sharded_path(store) -> dict:
    """``GOpt(store, backend="sharded", devices=1)`` on cuda over a one-rank
    NCCL group (one H100 is a world of one: NCCL with more ranks is not
    exercised here), then each of the 25 queries optimised on the sharded
    spec and its plan run twice on ``sharded`` and twice on ``torch``: rows
    identical, no mid-plan copy, the expand collectives recorded, no
    gather at one shard, K1 launched by every sharded probe, on
    ``fence``."""
    import torch
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core.gopt import GOpt
    from repro_torch.core.physical_spec import TransferStats
    from repro_torch.graphdb.torch_backend import torch_spec
    kernels.reset_launches()
    t0 = time.perf_counter()
    gs = GOpt(store, backend="sharded", devices=1)
    torch.cuda.synchronize()
    gopt_s = time.perf_counter() - t0
    ops = gs.spec.operators(store)
    backend = dist.get_backend(ops.group)
    require(backend == "nccl" and ops.n_shards == 1
            and ops.device.type == "cuda",
            f"sharded: group {backend}, {ops.n_shards} shards on "
            f"{ops.device}")
    glogue_launches = kernels.LAUNCHES.get("wcoj_intersect", 0)
    glogue_probes = ops.kernel_stats.count("dispatch", "sharded_probe")
    require(glogue_launches == glogue_probes > 0,
            f"sharded GLogue: {glogue_launches} K1 launches, "
            f"{glogue_probes} probes")
    specs = {"sharded": gs.spec, "torch": torch_spec("cuda")}
    queries, sharded_launches, sharded_probes = [], 0, 0
    for name, text, params in QUERIES:
        rec = {"name": name}
        opt = gs.optimize(text, params)
        result = {}
        for label, spec in specs.items():
            for rep in range(2):
                launched = kernels.LAUNCHES.get("wcoj_intersect", 0)
                km = ops.kernel_stats.mark()
                em = ops.exchange_stats.mark()
                t0 = time.perf_counter()
                try:
                    tbl, st = gs.execute(opt, backend=spec, params=params)
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    if "intermediate blow-up" not in str(exc):
                        raise
                    torch.cuda.synchronize()
                    tbl = st = None
                rec[f"{label}_ms" if rep else f"{label}_first_ms"] = \
                    (time.perf_counter() - t0) * 1e3
                if label == "sharded":
                    sharded_launches += kernels.LAUNCHES.get(
                        "wcoj_intersect", 0) - launched
                    sharded_probes += ops.kernel_stats.count(
                        "dispatch", "sharded_probe", since=km)
                    rec["exchanges"] = ops.exchange_stats.summary(em)
                    expanded = ops.kernel_stats.count(
                        "dispatch", "sharded_deg", since=km)
                    emitted = ops.kernel_stats.count(
                        "dispatch", "sharded_expand", since=km)
            result[label] = (tbl, st)
        (ts, ss), (tt, _) = result["sharded"], result["torch"]
        require((ts is None) == (tt is None),
                f"sharded {name}: only one spec stopped at the blow-up "
                f"guard")
        ex = rec["exchanges"]
        require(expanded > 0 and "psum:expand_frontier" in ex,
                f"sharded {name}: no frontier exchange")
        require(emitted == 0 or "psum_scatter:expand_emit" in ex,
                f"sharded {name}: an expand emitted with no reduce-scatter")
        require(not any(k.startswith("all_gather") for k in ex),
                f"sharded {name}: a gather at one shard: {sorted(ex)}")
        if ts is None:
            rec["outcome"] = "blowup"
        else:
            _rows_equal(name, "sharded vs torch", ts, tt)
            d2h = TransferStats.mid_plan_d2h(ss.transfers)
            require(d2h == 0, f"sharded {name}: {d2h} mid-plan copies")
            rec.update(outcome="ok", rows=ts.nrows, mid_plan_d2h=d2h)
        queries.append(rec)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(sharded_launches == sharded_probes > 0,
            f"sharded queries: {sharded_launches} K1 launches, "
            f"{sharded_probes} sharded probes")
    require(launches.get("wcoj_intersect.fence", 0)
            == launches.get("wcoj_intersect", 0),
            f"sharded: {launches.get('wcoj_intersect.fence', 0)} of "
            f"{launches.get('wcoj_intersect', 0)} K1 launches on fence")
    ok = [q for q in queries if q["outcome"] == "ok"]
    rec = {"phase": "sharded", "sf": SF, "shards": ops.n_shards,
           "group": backend, "gopt_s": gopt_s, "spec": gs.spec.name,
           "glogue_launches": glogue_launches,
           "query_launches": sharded_launches, "launches": launches,
           "queries_ok": len(ok), "queries_blowup": len(queries) - len(ok),
           "warm_ms_total_ok": {label: sum(q[f"{label}_ms"] for q in ok)
                                for label in specs},
           "block_bytes": sum(blk.nbytes()
                              for _, blk in ops._blocks.values()),
           "rows_equal": True, "queries": queries}
    # the blocks and the group the set created go with the phase
    gs.spec.release(store)
    require(not dist.is_initialized(), "sharded: the one-rank NCCL group "
                                       "outlived its operator set")
    del gs, ops
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def sharded_probe_phase(label: str, csr, indptr, indices, rows, targets,
                        pos_map, index, reps: int = REPS) -> dict:
    """The sharded backend's rank-local probe on a partition of a captured
    CSR into ``SHARDED_PROBE_SHARDS`` blocks, one after another in one
    process: the blocks' hits and positions summed on the card must
    equal the whole-CSR K1 result and the plain version bit for bit.  Each
    block's K1 call (non-owned rows clamped, probing -2) is a
    ``probe_phase`` of its own; beside it, the probe function
    (``block_probe``: masks, one K1 launch, the position map) is timed
    over queued batches."""
    import torch
    from repro_torch import kernels
    from repro_torch.graphdb.partition import partition_csr
    from repro_torch.graphdb.sharded_backend import (_owned, block_probe,
                                                     upload_block)
    from repro_torch.kernels.wcoj_intersect.ops import (build_search_index,
                                                        wcoj_intersect)
    from repro_torch.kernels.wcoj_intersect.ref import wcoj_intersect_ref
    i32 = torch.int32
    n_shards = SHARDED_PROBE_SHARDS
    t0 = time.perf_counter()
    sh = partition_csr(csr, n_shards)
    blocks = [upload_block(sh, r, lambda a: torch.as_tensor(
        a, dtype=i32).to(rows.device)) for r in range(n_shards)]
    for blk in blocks:
        blk.index = build_search_index(blk.indices)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    whole = wcoj_intersect(indptr, indices, rows, targets, pos_map, index)
    plain = wcoj_intersect_ref(indptr, indices, rows, targets, pos_map)
    fence = kernels.LAUNCHES.get("wcoj_intersect.fence", 0)
    hits = torch.zeros(rows.shape[0], dtype=i32, device=rows.device)
    epos = torch.zeros_like(hits)
    for blk in blocks:
        hit, ep = block_probe(blk, rows, targets)
        hits += hit.to(i32)
        epos += ep
    torch.cuda.synchronize()
    require(kernels.LAUNCHES.get("wcoj_intersect.fence", 0)
            == fence + n_shards, f"{label}: a block probe left fence")
    require(int(hits.max()) <= 1, f"{label}: a probe hit on two blocks")
    found = hits > 0
    err = 0
    for what, (f, e) in (("the whole-CSR kernel", whole),
                         ("the plain version", plain)):
        e = int((epos - e).abs().max())
        require(torch.equal(found, f) and e == 0,
                f"{label}: the block sums differ from {what} (found "
                f"{int((found != f).sum())}, max abs err {e})")
        err = max(err, e)
    recs = []
    for blk in blocks:
        mine, lrc = _owned(blk, rows)
        rec = probe_phase(f"{label}_block{blk.rank}", blk.indptr,
                          blk.indices, lrc.to(i32).contiguous(),
                          torch.where(mine, targets, -2).contiguous(),
                          blk.pos, blk.index, reps)
        rec.update(rank=blk.rank, rows_per_shard=blk.rows_per_shard,
                   owned_probes=int(mine.sum()),
                   probe_ms=cuda_ms(lambda: block_probe(blk, rows, targets),
                                    reps, batch=PROBE_BATCH, queued=True))
        recs.append(rec)
    return {"phase": "kernel", "name": "wcoj_intersect", "input": label,
            "shards": n_shards, "rows": rows.shape[0], "setup_s": setup_s,
            "equal": True,
            "max_abs_err": max([err] + [r["max_abs_err"] for r in recs]),
            "whole_ms": cuda_ms(lambda: wcoj_intersect(
                indptr, indices, rows, targets, pos_map, index), reps,
                batch=PROBE_BATCH, queued=True),
            "blocks_probe_ms": sum(r["probe_ms"] for r in recs),
            "blocks_k1_ms": sum(r["kernel_ms"] for r in recs),
            "blocks": recs}


# ------------------------------------------------ graph serving under writes

def mutate_writes(ms, rng, state: dict, sizes: dict,
                  last: bool) -> list[tuple]:
    """One round of the update stream, in queue order: ``PERSON`` inserts,
    new ``COMMENT``s, then the edge inserts and the deletes of base
    ``KNOWS`` edges shuffled together, then (the last round only) deletes
    of base ``PERSON``s.  The edge inserts are 40% ``KNOWS``, 30%
    ``LIKES`` (to a ``POST``), 20% ``HASMEMBER`` and 10% the two edges of
    each new comment (``REPLYOF`` a post, ``HASCREATOR`` a person);
    targets of KNOWS, LIKES and REPLYOF are drawn by the store generator's
    Zipf sampler.  ``state`` carries the stream across rounds: the live
    person ids (``"persons"``, grown by the round's inserts) and the
    deleted KNOWS pairs (``"deleted"``), which no insert with properties
    may aim at (that would resurrect the base edge).  Ids of new vertices
    follow from ``ms.id_space``: the queue applies the inserts in
    order."""
    import numpy as np
    from repro_torch.graphdb.ldbc import _zipf_targets
    base = ms.base
    plo, phi = base.type_range("PERSON")
    olo, ohi = base.type_range("POST")
    flo, fhi = base.type_range("FORUM")
    n_ins = sizes["edge_inserts"]
    n_com = n_ins // 20
    n_like = n_ins * 3 // 10
    n_mem = n_ins // 5
    n_knows = n_ins - n_like - n_mem - 2 * n_com
    gid = ms.id_space
    stamp = 1_400_000_000 + 1_000_000 * len(ms.compactions)
    writes = []
    new_p = list(range(gid, gid + sizes["persons"]))
    for i, g in enumerate(new_p):
        writes.append(("insert_vertex", ("PERSON", {
            "id": 10_000_000 + g, "creationDate": stamp + i})))
    comments = list(range(gid + len(new_p), gid + len(new_p) + n_com))
    for i, g in enumerate(comments):
        writes.append(("insert_vertex", ("COMMENT", {
            "id": 20_000_000 + g, "length": int(rng.integers(1, 2000)),
            "creationDate": stamp + i})))
    state["persons"].extend(new_p)
    pa = np.asarray(state["persons"], dtype=np.int64)
    knows = ("PERSON", "KNOWS", "PERSON")
    csr = next(c for t, c in base.out_csr.items()
               if (t.src, t.label, t.dst) == knows)
    pos = rng.integers(0, csr.nnz, sizes["edge_deletes"])
    rows = np.searchsorted(csr.indptr, pos, side="right") - 1
    deletes = [(plo + r, int(csr.indices[p]))
               for r, p in zip(rows.tolist(), pos.tolist())]
    state["deleted"].update(deletes)
    edges = [("delete_edge", (knows, s, d)) for s, d in deletes]
    src = pa[rng.integers(0, pa.shape[0], n_knows)]
    dst = plo + _zipf_targets(rng, n_knows, phi - plo)
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        while (s, d) in state["deleted"]:
            s = int(pa[rng.integers(0, pa.shape[0])])
        edges.append(("insert_edge", (knows, s, d,
                                      {"creationDate": stamp + i})))
    src = pa[rng.integers(0, pa.shape[0], n_like)]
    dst = olo + _zipf_targets(rng, n_like, ohi - olo)
    for s, d in zip(src.tolist(), dst.tolist()):
        edges.append(("insert_edge", (("PERSON", "LIKES", "POST"), s, d,
                                      None)))
    src = rng.integers(flo, fhi, n_mem)
    dst = pa[rng.integers(0, pa.shape[0], n_mem)]
    for s, d in zip(src.tolist(), dst.tolist()):
        edges.append(("insert_edge", (("FORUM", "HASMEMBER", "PERSON"), s, d,
                                      None)))
    posts = olo + _zipf_targets(rng, n_com, ohi - olo)
    authors = pa[rng.integers(0, pa.shape[0], n_com)]
    for c, p, a in zip(comments, posts.tolist(), authors.tolist()):
        edges.append(("insert_edge", (("COMMENT", "REPLYOF", "POST"), c, p,
                                      None)))
        edges.append(("insert_edge", (("COMMENT", "HASCREATOR", "PERSON"), c,
                                      a, None)))
    order = rng.permutation(len(edges))
    writes.extend(edges[i] for i in order.tolist())
    if last:
        dead = plo + rng.choice(phi - plo, sizes["vertex_deletes"],
                                replace=False)
        writes.extend(("delete_vertex", (g,)) for g in dead.tolist())
    return writes


def _cache_bytes(ops) -> int:
    """Device bytes the operator set caches: CSR twins with their K1
    indices, overlay columns, property columns."""
    import torch
    seen, total = set(), 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            if x.data_ptr() not in seen:
                seen.add(x.data_ptr())
                total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            for y in x:
                add(y)

    for cache in (ops._dev, ops._cols):
        for ent in list(cache.values()):
            add(ent[1])
    for ent in list(ops._props.values()):
        add(ent)
    return total


def capture_views(ops, base_ids: set) -> dict:
    """Wraps ``ops.intersect`` for the update stream: counts the probes of
    delta views (any CSR outside ``base_ids``), K1's launches on them (the
    difference in ``kernels.LAUNCHES`` across each view probe) and the
    search indexes built for them at their first probe, and keeps the
    probe with the most probes of an insert view (one with edge positions)
    and of a tombstone view (inputs stay on the card).
    ``del ops.intersect`` ends it."""
    from repro_torch import kernels
    rec = {"launches": 0, "probes": 0, "index_builds": 0, "insert": None,
           "tombstone": None}
    real_intersect = ops.intersect

    def capture(csr, rows_local, targets):
        n = int(rows_local.shape[0])
        if not n or id(csr) in base_ids:
            return real_intersect(csr, rows_local, targets)
        rec["probes"] += n
        ent = ops._cached(ops._dev, csr)
        if ent is None or ent[3] is None:
            rec["index_builds"] += 1
        kind = "insert" if csr.pos is not None else "tombstone"
        if rec[kind] is None or n > rec[kind][0]:
            rec[kind] = (n, csr, rows_local, targets)
        before = kernels.LAUNCHES.get("wcoj_intersect", 0)
        out = real_intersect(csr, rows_local, targets)
        rec["launches"] += kernels.LAUNCHES.get("wcoj_intersect", 0) - before
        return out

    ops.intersect = capture
    return rec


def host_rows(oracle, req, cache: dict):
    """The port's ``numpy`` spec on ``oracle`` (a deep copy of the store),
    over the physical plan the request ran, with its binding; memoized
    per (plan, binding)."""
    from repro_torch.graphdb.engine import Engine
    opt = req.prepared.opt
    key = (req.prepared.cache_key, tuple(sorted(req.params.items())))
    if key not in cache:
        eng = Engine(oracle, backend="numpy",
                     fuse_expand=opt.logical.hints.get("fuse_expand", True))
        cache[key] = eng.run(opt.logical, opt.physical,
                             params=req.params)[0]
    return cache[key]


def _read_stats(reqs: list, stats: dict) -> None:
    """Folds the requests' own execution ledgers into ``stats`` (requests
    deduplicated in a wave share one ``ExecStats``)."""
    from repro_torch.core.physical_spec import TransferStats
    seen = set()
    for r in reqs:
        st = r.stats
        if id(st) in seen:
            continue
        seen.add(id(st))
        stats["mid_plan_d2h"] += TransferStats.mid_plan_d2h(st.transfers)
        for k, v in (st.fallbacks or {}).items():
            stats["fallbacks"][k] = stats["fallbacks"].get(k, 0) + v
        stats["fused"] += (st.kernels or {}).get("dispatch:fused_chain", 0)


def mutate_path(store, device, sizes: dict, rounds: int, sf: float,
                seed: int = SEED) -> tuple[dict, object, dict]:
    """The graph-serving path under writes (module docstring, phase
    ``mutate``).  Returns the phase record, the GOpt over the compacted
    store (the chaos phase serves it) and the kernel inputs of the
    captured insert-view and tombstone-view probes."""
    import copy
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core.gopt import GOpt
    from repro_torch.graphdb.delta import MutableGraphStore
    from repro_torch.graphdb.ldbc import _zipf_targets
    from repro_torch.graphdb.serve import _WRITE_KEY
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    rng = np.random.default_rng(seed)
    ms = MutableGraphStore(store)
    del store
    n_person = ms.base.v_count["PERSON"]
    t0 = time.perf_counter()
    gopt = GOpt(ms, device=None if cuda else device.type)
    gopt_s = time.perf_counter() - t0
    ops = gopt.spec.operators(ms)
    per_round = (sizes["persons"] + sizes["edge_inserts"]
                 + sizes["edge_inserts"] // 20 + sizes["edge_deletes"]
                 + sizes["vertex_deletes"] + sizes["reads"])
    srv = gopt.serve(overlap=True, max_pending=per_round)
    if cuda:
        require(srv.fallback_spec is None,
                f"a server on the card has a host rung: "
                f"{srv.fallback_spec!r}")
    state = {"persons": list(range(*ms.base.type_range("PERSON"))),
             "deleted": set()}
    reads = {"latency_s": [], "mid_plan_d2h": 0, "fallbacks": {},
             "fused": 0, "done": 0, "checked": 0, "failed": 0}
    writes_total = writes_done = 0
    view_ms, copy_s, oracle_s, stream_s = [], 0.0, 0.0, 0.0
    fused_rounds = []
    sync()
    mem_before = torch.cuda.memory_allocated() if cuda else 0
    cache_before = _cache_bytes(ops)
    base_ids = {id(c) for c in list(ms.base.out_csr.values())
                + list(ms.base.in_csr.values())}
    views = capture_views(ops, base_ids)
    kernels.reset_launches()

    def read_round(bindings):
        return [srv.submit(MUTATE_QUERIES[q][1], {"pid": int(p)})
                for q, p in bindings]

    for rnd in range(rounds):
        last = rnd == rounds - 1
        t0 = time.perf_counter()
        gopt.snapshot()                     # builds the touched views
        view_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        oracle = copy.deepcopy(ms)
        copy_s += time.perf_counter() - t0
        writes = mutate_writes(ms, rng, state, sizes, last)
        qs = rng.integers(0, len(MUTATE_QUERIES), sizes["reads"])
        pids = _zipf_targets(rng, sizes["reads"], n_person)
        wchunks = np.array_split(np.arange(len(writes)), MUTATE_CHUNKS)
        rchunks = np.array_split(np.arange(sizes["reads"]), MUTATE_CHUNKS)
        t0 = time.perf_counter()
        wreqs, rreqs = [], []
        for wc, rc in zip(wchunks, rchunks):
            for i in wc.tolist():
                name, args = writes[i]
                wreqs.append(srv.submit_update(name, *args))
            rreqs.extend(read_round(zip(qs[rc].tolist(), pids[rc].tolist())))
        srv.drain()
        sync()
        stream_s += time.perf_counter() - t0
        writes_total += len(wreqs)
        writes_done += sum(r.status == "done" for r in wreqs)
        bad = [r.error for r in wreqs if r.status != "done"]
        require(not bad, f"mutate round {rnd}: {len(bad)} writes did not "
                         f"finish, the first: {bad[:1]}")
        require(all(r.status == "done" for r in rreqs),
                f"mutate round {rnd}: a read did not finish")
        require(all(r.snap_version == oracle.version for r in rreqs),
                f"mutate round {rnd}: a read pinned another version than "
                f"its admission's")
        before = reads["fused"]
        _read_stats(rreqs, reads)
        fused_rounds.append(reads["fused"] - before)
        reads["latency_s"].extend(r.latency_s for r in rreqs)
        reads["done"] += len(rreqs)
        t0 = time.perf_counter()
        cache = {}
        for i in rng.choice(len(rreqs), MUTATE_SAMPLE, replace=False):
            r = rreqs[int(i)]
            _rows_equal(r.prepared.source[:40], f"round {rnd} vs the "
                        f"numpy spec on its admission's copy", r.table,
                        host_rows(oracle, r, cache))
            reads["checked"] += 1
        oracle_s += time.perf_counter() - t0
        del oracle, cache, wreqs, rreqs, writes
    sync()
    launches = dict(kernels.LAUNCHES)
    del ops.intersect
    k1 = launches.get("wcoj_intersect", 0)
    if cuda:                # the plain version on the CPU counts nothing
        require(k1 > 0, "the update stream launched no wcoj_intersect "
                        "kernel")
        require(launches.get("wcoj_intersect.fence", 0) == k1,
                f"{launches.get('wcoj_intersect.fence', 0)} of {k1} "
                f"wcoj_intersect launches on the fence route")
        require(views["launches"] > 0, "no wcoj_intersect launch on a "
                                       "delta view")
    require(views["insert"] is not None and views["tombstone"] is not None,
            "no probe of an insert view or of a tombstone view")
    require(reads["mid_plan_d2h"] == 0,
            f"{reads['mid_plan_d2h']} mid-plan device->host copies")
    require(reads["fallbacks"].get("chain_delta", 0) > 0,
            "no fused chain declined on a delta")
    require(sum(fused_rounds[:-1]) >= 1,
            f"no fused chain dispatched in rounds 1-{rounds - 1}")
    s = srv.stats.summary()
    # each read wave's own execution time, without the queueing behind the
    # round's writes that the submit-then-drain loop adds to latency
    wave_ms = sorted(1e3 * t for k, v in srv.stats.per_plan.items()
                     if k != _WRITE_KEY for t in v["exec_s"])
    require(s["failed"] == 0 and s["retries"] == 0
            and s["breaker_trips"] == 0 and s["rung_waves"][1:] == [0, 0],
            f"the fault-free stream degraded: failed={s['failed']} "
            f"retries={s['retries']} trips={s['breaker_trips']} "
            f"waves by rung={s['rung_waves']}")
    require(s["completed"] == s["submitted"],
            f"{s['completed']} of {s['submitted']} requests done")
    n_vertices_live = ms.n_vertices
    info = ms.delta_info()
    # the same bindings before and after compaction
    qs = rng.integers(0, len(MUTATE_QUERIES), sizes["reads"])
    pids = _zipf_targets(rng, sizes["reads"], n_person)
    bindings = list(zip(qs.tolist(), pids.tolist()))
    pre = read_round(bindings)
    srv.drain()
    sync()
    require(all(r.status == "done" for r in pre), "a pre-compaction read "
                                                  "did not finish")
    pre_rows = [(r.prepared.source, r.params, r.table) for r in pre]
    del pre
    epoch0 = gopt.plan_cache_info()["epoch"]
    t0 = time.perf_counter()
    event = srv.compact()
    sync()
    compact_s = time.perf_counter() - t0
    require(gopt.plan_cache_info()["epoch"] > epoch0,
            "compaction left the stats epoch")
    require(event["repinned_plans"] == len(MUTATE_QUERIES),
            f"{event['repinned_plans']} hot plans re-pinned")
    # (edges of deleted vertices leave at compaction; ``n_edges`` counted
    # them until then)
    require(ms.n_vertices == n_vertices_live,
            "compaction changed the live vertex count")
    post = read_round(bindings)
    srv.drain()
    sync()
    require(all(r.status == "done" for r in post), "a post-compaction read "
                                                   "did not finish")
    t0 = time.perf_counter()
    oracle, cache = copy.deepcopy(ms), {}
    for r, (src, params, table) in zip(post, pre_rows):
        require(r.prepared.source == src and r.params == params,
                "post-compaction bindings differ")
        _rows_equal(src[:40], "after compaction vs before", r.table, table)
        _rows_equal(src[:40], "after compaction vs the numpy spec",
                    r.table, host_rows(oracle, r, cache))
        reads["checked"] += 1
    oracle_s += time.perf_counter() - t0
    _read_stats(post, reads)
    post_rungs = srv.stats.summary()["rung_waves"]
    require(post_rungs[1:] == [0, 0], f"waves by rung {post_rungs}")
    require(reads["mid_plan_d2h"] == 0,
            f"{reads['mid_plan_d2h']} mid-plan device->host copies")
    del post, pre_rows, oracle, cache
    srv.close()
    probes = {}
    for kind in ("insert", "tombstone"):
        _, csr, rows, targets = views.pop(kind)
        indptr, indices, pos, index = ops._csr_dev(csr, probe=True)
        probes[f"mutate_{kind}_view"] = (
            indptr, indices, ops._col(rows).to(torch.int32).contiguous(),
            ops._col(targets).to(torch.int32).contiguous(), pos, index)
    del csr, rows, targets, indptr, indices, pos, index, srv
    gc.collect()
    sync()
    mem_after = torch.cuda.memory_allocated() if cuda else 0
    cache_after = _cache_bytes(ops)
    growth = max(0, cache_after - cache_before)
    if cuda:
        require(mem_after <= mem_before * (1 + MUTATE_MEMORY_SLACK) + growth,
                f"device memory after compaction {mem_after} B > "
                f"{1 + MUTATE_MEMORY_SLACK} x {mem_before} B + the base's "
                f"growth {growth} B")
    lat = sorted(reads["latency_s"])
    rec = {"phase": "mutate", "sf": sf, "vertices": int(ms.n_vertices),
           "edges": int(ms.n_edges),
           "rounds": rounds, "gopt_s": gopt_s,
           "writes": writes_total, "writes_done": writes_done,
           "edge_inserts": sizes["edge_inserts"] * rounds,
           "reads": reads["done"], "reads_checked": reads["checked"],
           "stream_s": stream_s, "mutations_per_s": writes_total / stream_s,
           "read_p50_ms": 1e3 * lat[len(lat) // 2],
           "read_p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "read_wave_exec_ms": {
               "p50": wave_ms[len(wave_ms) // 2],
               "p99": wave_ms[min(len(wave_ms) - 1,
                                  int(0.99 * len(wave_ms)))],
               "waves": len(wave_ms)},
           "snapshot_view_ms": {"mean": statistics.mean(view_ms),
                                "max": max(view_ms)},
           "oracle_copy_s": copy_s, "oracle_s": oracle_s,
           "overlay_before_compaction": info,
           "compaction": event, "compact_s": compact_s,
           "serve": {k: s[k] for k in (
               "submitted", "completed", "waves", "mean_wave_size",
               "deduped", "writes", "failed", "retries", "breaker_trips",
               "rung_waves", "fallbacks")},
           "fused_chain_dispatches_by_round": fused_rounds,
           "read_fallbacks": reads["fallbacks"],
           "mid_plan_d2h": reads["mid_plan_d2h"],
           "launches": launches,
           "view_probe_launches": views["launches"],
           "view_probes": views["probes"],
           "view_index_builds": views["index_builds"],
           "memory_allocated_before": mem_before,
           "memory_allocated_after": mem_after,
           "cache_bytes_before": cache_before,
           "cache_bytes_after": cache_after}
    return rec, gopt, probes


def chaos_path(gopt, device, seed: int = SEED) -> dict:
    """Fault injection on the card over the compacted store (module
    docstring, phase ``chaos``): four servers over one GOpt, each with
    its own ``faulty_spec(torch_spec(), FaultPlan(...))``."""
    import numpy as np
    import torch
    from repro_torch.graphdb.faults import FaultPlan, FaultRule, faulty_spec
    from repro_torch.graphdb.ldbc import _zipf_targets
    from repro_torch.graphdb.serve import ServeQuarantined
    from repro_torch.graphdb.torch_backend import torch_spec
    cuda = device.type == "cuda"
    spec = torch_spec(None if cuda else device.type)
    ms = gopt.store
    rng = np.random.default_rng(seed + 1)
    n_person = ms.base.v_count["PERSON"]
    poison, slow = n_person - 2, n_person - 3
    tri = next(i for i, q in enumerate(MUTATE_QUERIES)
               if q[0] == "knows_triangle")
    chain = next(i for i, q in enumerate(MUTATE_QUERIES)
                 if q[0] == "creator_tags")

    def pids(n):
        p = _zipf_targets(rng, 4 * n, n_person)
        p = p[(p != poison) & (p != slow)]
        return [int(x) for x in p[:n]]

    clean = {}

    def fault_free(q, pid):
        if (q, pid) not in clean:
            clean[(q, pid)] = gopt.run(MUTATE_QUERIES[q][1],
                                       {"pid": pid})[0]
        return clean[(q, pid)]

    def check_rows(reqs, what):
        for q, r in reqs:
            if r.status == "done":
                _rows_equal(MUTATE_QUERIES[q][0], what, r.table,
                            fault_free(q, r.params["pid"]))

    t_start = time.perf_counter()
    # S1: writes, then reads under transient K1 faults, a poison binding
    # and a latency spike.  The writes touch KNOWS, so chains over it
    # decline and its probes cross the intersect boundary.
    bind_poison = FaultRule(op="bind", kind="permanent", value=poison,
                            count=None)
    plan1 = FaultPlan([FaultRule(op="intersect", kind="transient", count=1),
                       FaultRule(op="intersect", kind="transient", after=1,
                                 count=1),
                       bind_poison,
                       FaultRule(op="bind", kind="latency", value=slow,
                                 latency_s=CHAOS_LATENCY_S, count=1)],
                      seed=seed)
    fallback = FaultPlan([bind_poison], seed=seed)
    s1 = gopt.serve(backend=faulty_spec(spec, plan1), overlap=True,
                    fallback_spec=faulty_spec("numpy", fallback),
                    quarantine_after=2, breaker_threshold=99)
    plo, phi = ms.base.type_range("PERSON")
    knows = ("PERSON", "KNOWS", "PERSON")
    writes = [s1.submit_update("insert_edge", knows,
                               int(rng.integers(plo, phi)),
                               int(rng.integers(plo, phi)))
              for _ in range(CHAOS_WRITES)]
    s1.drain()
    require(all(w.status == "done" for w in writes), "chaos: a write failed")
    reqs = [(q, s1.submit(MUTATE_QUERIES[q][1], {"pid": p}))
            for q in range(len(MUTATE_QUERIES)) for p in pids(16)]
    s1.drain()
    wave = pids(7) + [poison]
    reqs += [(tri, s1.submit(MUTATE_QUERIES[tri][1], {"pid": p}))
             for p in wave]
    s1.drain()
    first = reqs[-1][1]
    again = s1.submit(MUTATE_QUERIES[tri][1], {"pid": poison})
    s1.drain()
    try:
        s1.submit(MUTATE_QUERIES[tri][1], {"pid": poison})
        quarantined = False
    except ServeQuarantined:
        quarantined = True
    late = s1.submit(MUTATE_QUERIES[tri][1], {"pid": slow},
                     deadline_s=time.perf_counter() + CHAOS_LATENCY_S / 4)
    s1.drain()
    reqs += [(q, s1.submit(MUTATE_QUERIES[q][1], {"pid": p}))
             for q in range(len(MUTATE_QUERIES)) for p in pids(16)]
    s1.drain()
    s1.close()
    terminal = {"done", "failed", "dropped", "cancelled"}
    every = [r for _, r in reqs] + [again, late] + writes
    require(all(r.status in terminal for r in every),
            "chaos: a request without a terminal status")
    require(first.status == "failed" and again.status == "failed"
            and quarantined, "chaos: the poison binding was not failed and "
                             "quarantined")
    require(all(r.status == "done" for _, r in reqs if r is not first),
            "chaos: a healthy request failed beside the poison")
    require(late.status == "dropped", f"chaos: the slow request ended "
                                      f"{late.status}")
    check_rows(reqs, "chaos vs a fault-free run")
    st1 = s1.stats.summary()
    fired1 = dict(plan1._fired)
    want1 = {"retries": 2, "failed": 2, "quarantined": 1, "bisections": 3,
             "deadline_aborts": 1, "dropped": 1, "breaker_trips": 0}
    require(all(st1[k] == v for k, v in want1.items()),
            f"chaos: serve counters {({k: st1[k] for k in want1})}, "
            f"expected {want1}")
    # the poison fires at rungs 0 and 1 of each execution holding it: the
    # wave of 8, its halves of 4 and 2, itself, then alone twice
    want_fired = {0: 1, 1: 1, 2: 7, 3: 1}
    require(fired1 == want_fired and fallback._fired == {0: 2},
            f"chaos: fault ledger {fired1} / {fallback._fired}, expected "
            f"{want_fired} / {{0: 2}}")
    # S2: three fused-chain faults on single-request waves: the breaker
    # steps down to the per-hop loop, probes back and recovers
    plan2 = FaultPlan([FaultRule(op="chain", kind="permanent", count=3)],
                      seed=seed)
    s2 = gopt.serve(backend=faulty_spec(spec, plan2), overlap=True,
                    probe_after=2)
    reqs2 = []
    for p in pids(14):
        reqs2.append((chain, s2.submit(MUTATE_QUERIES[chain][1],
                                       {"pid": p})))
        s2.drain()
    s2.close()
    require(all(r.status == "done" for _, r in reqs2),
            "chaos: a chain request failed")
    check_rows(reqs2, "chaos breaker vs a fault-free run")
    (b2,) = s2._breakers.values()
    st2 = s2.stats.summary()
    require(b2["trips"] == 1 and b2["probes"] == 3 and b2["recoveries"] == 1
            and b2["level"] == 0 and plan2.fired == 3
            and st2["rung_waves"][1] > 0 and st2["rung_waves"][2] == 0,
            f"chaos: breaker {b2}, waves by rung {st2['rung_waves']}, "
            f"{plan2.fired} chain faults")
    # S3: every K1 probe of one plan fails for good: with the host rung
    # asked for, it walks to rung 2, the host numpy spec, and stays there
    plan3 = FaultPlan([FaultRule(op="intersect", kind="permanent",
                                 count=None)], seed=seed)
    s3 = gopt.serve(backend=faulty_spec(spec, plan3), overlap=True,
                    fallback_spec="numpy")
    reqs3 = []
    for p in pids(6):
        reqs3.append((tri, s3.submit(MUTATE_QUERIES[tri][1], {"pid": p})))
        s3.drain()
    s3.close()
    require(all(r.status == "done" for _, r in reqs3),
            "chaos: a request of the faulted plan failed")
    check_rows(reqs3, "chaos numpy rung vs a fault-free run")
    require(sum(r.table.nrows for _, r in reqs3) > 0,
            "chaos: the faulted plan returned no row")
    (b3,) = s3._breakers.values()
    st3 = s3.stats.summary()
    require(b3["level"] == 2 and b3["trips"] == 1
            and st3["rung_waves"] == [0, 0, len(reqs3)],
            f"chaos: breaker {b3}, waves by rung {st3['rung_waves']}")
    # S4: the same fault on a server left at its default: on the card it
    # has no host rung, so the request fails after the per-hop rung
    plan4 = FaultPlan([FaultRule(op="intersect", kind="permanent",
                                 count=None)], seed=seed)
    s4 = gopt.serve(backend=faulty_spec(spec, plan4), overlap=True,
                    chain_dispatch=False)
    busiest = max(reqs3, key=lambda qr: qr[1].table.nrows)[1]
    r4 = s4.submit(MUTATE_QUERIES[tri][1], dict(busiest.params))
    s4.drain()
    s4.close()
    st4 = s4.stats.summary()
    if cuda:
        require(s4.fallback_spec is None and r4.status == "failed"
                and st4["rung_waves"] == [1, 0, 0] and plan4.fired == 2,
                f"chaos: the default server on the card ended "
                f"{r4.status} with waves by rung {st4['rung_waves']} and "
                f"{plan4.fired} faults")
    if cuda:
        torch.cuda.synchronize()
    return {"phase": "chaos", "seconds": time.perf_counter() - t_start,
            "reads": len(reqs) + len(reqs2) + len(reqs3) + 2,
            "writes": len(writes),
            "mixed": {"serve": {k: st1[k] for k in (
                "submitted", "completed", "failed", "retries", "bisections",
                "quarantined", "dropped", "deadline_aborts", "rung_waves")},
                "fired": fired1, "fallback_fired": dict(fallback._fired)},
            "breaker": {"state": b2, "rung_waves": st2["rung_waves"],
                        "fired": plan2.fired},
            "permanent_k1": {"state": b3, "rung_waves": st3["rung_waves"],
                             "fired": plan3.fired},
            "no_host_rung": {"status": r4.status,
                             "rung_waves": st4["rung_waves"],
                             "fired": plan4.fired},
            "rows_identical": True}


def delta_check(sf: float) -> dict:
    """At sf=1, one update script on a mutable store: each plan ``GOpt``
    makes on cuda gives the same rows on ``device="cuda"`` and on
    ``device="cpu"`` (the plain versions), for the benchmark queries and
    the update stream's reads, over the delta overlay and after
    compaction (the fused chains on cuda, once measured, too)."""
    import numpy as np
    from repro_torch.core.gopt import GOpt
    from repro_torch.graphdb.delta import MutableGraphStore
    from repro_torch.graphdb.ldbc import _zipf_targets, generate_ldbc
    from repro_torch.graphdb.torch_backend import torch_spec
    t0 = time.perf_counter()
    ms = MutableGraphStore(generate_ldbc(sf=sf, seed=7))
    rng = np.random.default_rng(SEED + 2)
    state = {"persons": list(range(*ms.base.type_range("PERSON"))),
             "deleted": set()}
    writes = mutate_writes(ms, rng, state, CHECK_MUTATE_SIZES, last=True)
    for name, args in writes:
        getattr(ms, name)(*args)
    gopt, cpu = GOpt(ms), torch_spec("cpu")
    pids = _zipf_targets(rng, 4, ms.base.v_count["PERSON"]).tolist()
    cases = [(n, t, p) for n, t, p in QUERIES] + [
        (n, t, {"pid": int(p)}) for n, t in MUTATE_QUERIES for p in pids]
    rows = {}

    def compare(what):
        n_rows = 0
        for name, text, params in cases:
            opt = gopt.optimize(text, params)
            th, _ = gopt.execute(opt, params=params, backend=cpu)
            for _ in range(2):          # the first run measures the chains
                tc, _ = gopt.execute(opt, params=params)
                _rows_equal(name, f"cuda vs cpu, {what}", tc, th)
            n_rows += tc.nrows
        rows[what] = n_rows

    compare("overlay")
    gopt.compact()
    compare("compacted")
    return {"phase": "check", "what": "delta", "sf": sf,
            "writes": len(writes), "queries": len(cases),
            "result_rows": rows, "identical": True,
            "seconds": time.perf_counter() - t0}


# ----------------------------------------------------------------- serving

def serve_path() -> tuple[dict, object, dict]:
    """OLMoE-1B-7B served by ``ServeEngine`` on the card.  Returns the
    phase record, the model (its weights feed the kernel phases) and the
    kernel calls captured on the way: the longest prompt's prefill and
    decode tick ``CAPTURE_TICK`` (layer 0 of each)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs.olmoe_1b_7b import CONFIG as cfg
    from repro_torch.kernels.flash_attention.ref import per_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Request, ServeEngine
    t0 = time.perf_counter()
    model = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    engine = ServeEngine(cfg, model, n_slots=N_SLOTS, max_len=MAX_LEN,
                         eos_id=-1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_tokens=NEW_TOKENS)
            for i, n in enumerate(lens)]
    longest = int(lens.max())

    # capture layer 0's kernel inputs in two steps (cloned: the cache is
    # rewritten later), time every step to its end, and keep one device
    # flag per step for "every logit is finite" (read once, at the end)
    captured, step = {}, {"kind": None, "tick": -1}
    mlp0 = model.layers[0].mlp
    real_fa, real_gmm = tfm.flash_attention, tfm.grouped_matmul

    def capture_key(kernel):
        if step["kind"] == "prefill" and step["len"] == longest:
            return f"{kernel}_prefill"
        if step["kind"] == "decode" and step["tick"] == CAPTURE_TICK:
            return f"{kernel}_decode"
        return None

    def fa(q, k, v, q_start, kv_len, **kw):
        key = capture_key("flash_attention")
        if key and key not in captured:
            B = q.shape[0]
            captured[key] = (q.clone(), k.clone(), v.clone(),
                             per_batch(q_start, B, q.device).clone(),
                             per_batch(kv_len, B, q.device).clone(), kw)
        return real_fa(q, k, v, q_start, kv_len, **kw)

    def gmm(x, w):
        key = capture_key("grouped_matmul")
        names = {mlp0.w1.data_ptr(): "w1", mlp0.w2.data_ptr(): "w2"}
        which = names.get(w.data_ptr())
        if key and which:
            key = f"{key}_{which}"
            if key not in captured:
                captured[key] = (x.clone(), w)
        return real_gmm(x, w)

    prefill_ms, decode_ms, finite = [], [], []
    real_prefill, real_decode = engine._prefill, engine._decode

    def timed(kind, fn, *args):
        t = time.perf_counter()
        logits = fn(*args)
        finite.append(torch.isfinite(logits).all())
        torch.cuda.synchronize()
        (prefill_ms if kind == "prefill" else decode_ms).append(
            (time.perf_counter() - t) * 1e3)
        return logits

    def prefill(tokens, slot):
        step.update(kind="prefill", len=int(tokens.shape[1]))
        return timed("prefill", real_prefill, tokens, slot)

    def decode(tokens, pos):
        step.update(kind="decode", tick=len(decode_ms))
        return timed("decode", real_decode, tokens, pos)

    engine._prefill, engine._decode = prefill, decode
    tfm.flash_attention, tfm.grouped_matmul = fa, gmm
    try:
        for r in reqs:
            engine.submit(r)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        done = engine.run(max_ticks=10_000)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        tfm.flash_attention, tfm.grouped_matmul = real_fa, real_gmm
    peak = torch.cuda.max_memory_allocated()

    n_pre, n_tick = len(prefill_ms), len(decode_ms)
    generated = sum(len(r.out_tokens) for r in done)
    require(len(done) == N_REQUESTS and all(
        r.done and len(r.out_tokens) == NEW_TOKENS for r in done),
        f"serve: {len(done)} of {N_REQUESTS} requests finished with "
        f"{NEW_TOKENS} tokens")
    require(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
            "serve: a token outside the vocabulary")
    require(bool(torch.stack(finite).all()), "serve: non-finite logits")
    require(n_pre == N_REQUESTS, f"serve: {n_pre} prefills")
    steps = n_pre + n_tick
    for name, per_step in (("flash_attention", cfg.n_layers),
                           ("grouped_matmul", 3 * cfg.n_layers)):
        require(launches.get(name, 0) == per_step * steps,
                f"serve: {launches.get(name, 0)} {name} launches, expected "
                f"{per_step} x {steps} steps")
    # every prefill attention takes the tensor-core route, every decode
    # attention the split route
    for route_name, n in (("tc", n_pre), ("split", n_tick)):
        got = launches.get(f"flash_attention.{route_name}", 0)
        require(got == cfg.n_layers * n,
                f"serve: {got} flash_attention.{route_name} launches, "
                f"expected {cfg.n_layers} x {n} steps")
    # every expert product of the serving path takes the tensor-core route
    tc = launches.get("grouped_matmul.tc", 0)
    require(tc == 3 * cfg.n_layers * steps,
            f"serve: {tc} grouped_matmul.tc launches, expected "
            f"{3 * cfg.n_layers} x {steps} steps")
    require(set(captured) == {
        "flash_attention_prefill", "flash_attention_decode",
        "grouped_matmul_prefill_w1", "grouped_matmul_prefill_w2",
        "grouped_matmul_decode_w1", "grouped_matmul_decode_w2"},
        f"serve: captured {sorted(captured)}")
    longest_prompt = next(r.prompt for r in reqs if len(r.prompt) == longest)
    profiled = {
        "decode": profile_step(real_decode, torch.zeros(
            (N_SLOTS, 1), dtype=torch.int64, device="cuda"),
            torch.tensor(engine.slot_pos, device="cuda")),
        "prefill": profile_step(real_prefill, torch.as_tensor(
            longest_prompt[None].astype(np.int64), device="cuda"), 0)}
    del engine
    rec = {"phase": "serve", "model": cfg.name, "dtype": str(cfg.dtype),
           "layers": cfg.n_layers, "params": cfg.param_count(),
           "slots": N_SLOTS, "max_len": MAX_LEN, "requests": len(done),
           "prompt_tokens": int(lens.sum()), "longest_prompt": longest,
           "generated_tokens": generated, "prefills": n_pre, "ticks": n_tick,
           "init_s": init_s, "wall_s": wall_s,
           "prefill_ms_median": statistics.median(prefill_ms),
           "prefill_ms_total": sum(prefill_ms),
           "decode_ms_median": statistics.median(decode_ms),
           "decode_ms_total": sum(decode_ms),
           "host_ms_total": wall_s * 1e3 - sum(prefill_ms) - sum(decode_ms),
           "generated_tokens_per_s": generated / wall_s,
           "launches": launches, "max_memory_allocated": peak,
           "profiled": profiled}
    return rec, model, captured


def profile_step(step, *args) -> dict:
    """One more step (warmed up once) under ``torch.profiler``:
    its host-clock ms, the device's kernel ms by kind, and the device's
    idle share of the step.  A trace that holds no device activity (CUPTI
    dropped it) is taken again, up to ``PROFILE_ATTEMPTS`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step(*args)
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(*args)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kinds = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
                 "grouped_matmul": 0.0, "embedding_bag": 0.0,
                 "embedding_bag_bwd": 0.0, "matmul": 0.0, "optimizer": 0.0,
                 "other": 0.0}
        kernels, other, copies = 0, [], []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            kernels += ev.count
            name, ms = ev.key.lower(), ev.self_device_time_total / 1e3
            kind = ("flash_attention_bwd" if "attn_bwd" in name
                    else "flash_attention" if "attn_" in name
                    else "grouped_matmul" if "gmm_kernel" in name
                    else "embedding_bag_bwd" if "bag_bwd_" in name
                    else "embedding_bag" if "embedding_bag_kernel" in name
                    else "matmul" if any(s in name for s in (
                        "gemm", "gemv", "nvjet", "cutlass", "xmma",
                        "cublas"))
                    # the AdamW update's torch._foreach_* launches
                    else "optimizer" if "multi_tensor_apply" in name
                    or "foreach" in name
                    else "other")
            kinds[kind] += ms
            if kind == "other":
                other.append((ms, ev.count, ev.key[:60]))
                if "copy" in name or "catarray" in name:
                    copies.append((ms, ev.count, ev.key[:80]))
        device_ms = sum(kinds.values())
        if device_ms > 0:
            break
    require(device_ms > 0, f"profiler recorded no device time in "
                           f"{PROFILE_ATTEMPTS} traces")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": max(0.0, 1 - device_ms / wall_ms),
            "device_kernels": kernels, "device_ms_by_kind": kinds,
            "top_other": sorted(other, reverse=True)[:5],
            "copy_kernels": sorted(copies, reverse=True),
            "attempts": attempt}


def _verdict(label: str, got, want, tol: float) -> dict:
    """The reference's allclose (|a - b| <= tol + tol*|b|), the max abs
    error and the largest plain value (which the tolerance is read
    against)."""
    import torch
    diff = (got.float() - want.float()).abs()
    limit = tol + tol * want.float().abs()
    err = float(diff.max()) if diff.numel() else 0.0
    worst = float((diff / limit).max()) if diff.numel() else 0.0
    require(worst <= 1.0 and bool(torch.isfinite(got).all()),
            f"{label}: kernel differs from the plain version (max abs err "
            f"{err}, {worst:.3f} of the tolerance)")
    return {"max_abs_err": err, "tol": tol, "worst_of_tol": worst,
            "want_max_abs": float(want.float().abs().max())
            if want.numel() else 0.0}


def _unit_rms(t):
    """``t`` scaled to unit RMS (in fp32 arithmetic, kept in its dtype)."""
    t32 = t.float()
    return (t32 / t32.square().mean().sqrt()).to(t.dtype)


def _grad_verdicts(label: str, names: str, got, want, tol: float) -> list:
    """One verdict a gradient, each required to hold values of at least 10x
    the tolerance: a kernel that returned zeros, or gradients off by a
    large factor, fails."""
    verdicts = [_verdict(f"{label} d{n}", a, b, tol)
                for n, a, b in zip(names, got, want)]
    for n, r in zip(names, verdicts):
        require(r["want_max_abs"] >= 10 * tol,
                f"{label} d{n}: the largest plain gradient "
                f"{r['want_max_abs']} is below 10x the tolerance {tol}")
    return verdicts


def attention_phase(label: str, q, k, v, q_start, kv_len, kw: dict,
                    want_route: str, tol: float = ATTENTION_TOL,
                    reps: int = REPS, limit_ms: float | None = None) -> dict:
    """The FlashAttention kernel against its plain version on one captured
    call: the route it must take (its launch counted there), the SDPA
    yardsticks, the bound and the share of it reached; on the rows route
    also its log-sum-exp, and the output and log-sum-exp equal bit for bit
    over two calls; with ``limit_ms`` its queued time at most that."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_lse, route)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    args = (q, k, v, q_start, kv_len)
    which = route(q, k, v)
    require(which == want_route,
            f"{label}: route {which}, expected {want_route}")
    counted = kernels.LAUNCHES.get(f"flash_attention.{which}", 0)
    got = flash_attention(*args, **kw)
    want = flash_attention_ref(*args, **kw, return_lse=which == "rows")
    torch.cuda.synchronize()
    require(kernels.LAUNCHES.get(f"flash_attention.{which}", 0)
            == counted + 1, f"{label}: no flash_attention.{which} launch")
    if which == "rows":
        want, want_lse = want
        again = [flash_attention_lse(*args, **kw) for _ in range(2)]
        torch.cuda.synchronize()
        require(all(torch.equal(got, out) and torch.equal(again[0][1], lse)
                    for out, lse in again),
                f"{label}: the rows route's output or log-sum-exp differs "
                f"between calls")
    rec = _verdict(label, got, want, tol)
    if which == "rows":
        rec["lse"] = _verdict(f"{label} lse", again[0][1], want_lse,
                              ATTENTION_LSE_TOL)
        rec["bit_equal_two_calls"] = True
        del again
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    # admissible (query, key) positions, as the kernel's mask defines them
    q_pos = q_start[:, None] + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = (kv_pos[None, None] <= q_pos[:, :, None]) & (
        kv_pos[None, None] < kv_len[:, None, None])
    if kw.get("window") is not None:
        mask &= kv_pos[None, None] > q_pos[:, :, None] - kw["window"]
    pairs = int(mask.sum()) * Kh * G
    esize = q.element_size()
    nbytes = esize * (2 * q.numel() + 2 * int(kv_len.sum()) * Kh * hd)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # bf16 products on the tensor cores; fp32 ones outside them
    rate = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else SCALAR_OPS_PER_S
    bound_ops_ms = 4 * hd * pairs / rate * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    # kernel and yardsticks timed ATTN_BATCH calls at a time, queued behind
    # a device sleep: a decode call (~0.03 ms) is shorter than the
    # wrapper's host time, which one call per event pair would add to it
    # (kept as kernel_ms_single)
    kernel_ms = cuda_ms(lambda: flash_attention(*args, **kw), reps,
                        batch=ATTN_BATCH, queued=True)
    plain_ms = cuda_ms(lambda: flash_attention_ref(*args, **kw),
                       max(3, reps // 4), warmup=1)
    # yardstick: one SDPA call on the same cache with an explicit mask
    qs = q.permute(0, 2, 3, 1, 4).reshape(B, Kh * G, Sq, hd)
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    amask = mask[:, None]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=amask, enable_gqa=G > 1), reps,
        batch=ATTN_BATCH, queued=True)
    # and, for a plain causal call (every slot from position 0 over Sq
    # keys: serving's prefill, a training step), SDPA's causal path over
    # the kv_len filled rows only: the same work as the kernel's
    library_causal_ms = None
    n = int(kv_len[0])
    if (int(q_start.abs().max()) == 0 and n == Sq
            and bool((kv_len == n).all())
            and kw.get("window") is None and kw.get("softcap") is None):
        kc, vc = ks[:, :, :n], vs[:, :, :n]
        library_causal_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, kc, vc, is_causal=True, enable_gqa=G > 1), reps,
            batch=ATTN_BATCH, queued=True)
    rec.update({"phase": "kernel", "name": "flash_attention", "input": label,
                "route": which,
                "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Kh": Kh, "G": G,
                          "hd": hd},
                "dtype": str(q.dtype), "kv_len": kv_len.tolist(),
                "admissible_pairs": pairs, "bytes": nbytes,
                "kernel_ms": kernel_ms,
                "kernel_ms_single": cuda_ms(
                    lambda: flash_attention(*args, **kw), reps),
                "kernel_ms_cold": cuda_ms(
                    lambda: flash_attention(*args, **kw), reps, cold=True),
                "plain_ms": plain_ms,
                "library_ms": library_ms,
                "library_causal_ms": library_causal_ms,
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                             else "operations"),
                "pct_of_bound": 100 * bound_ms / kernel_ms,
                "kernel_over_library": kernel_ms / library_ms})
    rec["pct_of_bound_cold"] = 100 * bound_ms / rec["kernel_ms_cold"]
    if limit_ms is not None:
        rec["limit_ms"] = limit_ms
        require(kernel_ms <= limit_ms,
                f"{label}: {kernel_ms:.4g} ms > {limit_ms} ms")
    return rec


def gmm_phase(label: str, x, w, want_route: str, tol: float = GMM_TOL,
              reps: int = REPS) -> dict:
    """The grouped-matmul kernel against its plain version on one captured
    product: the route it must take (its launch counted there), the
    ``torch.bmm`` yardstick, the bound and the share of it reached."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.grouped_matmul.ops import grouped_matmul, route
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    which = route(x, w)
    require(which == want_route,
            f"{label}: route {which}, expected {want_route}")
    counted = kernels.LAUNCHES.get(f"grouped_matmul.{which}", 0)
    got = grouped_matmul(x, w)
    want = grouped_matmul_ref(x, w)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES.get(f"grouped_matmul.{which}", 0)
            == counted + 1, f"{label}: no grouped_matmul.{which} launch")
    rec = _verdict(label, got, want, tol)
    G, M, K = x.shape
    N = w.shape[2]
    nbytes = x.element_size() * (x.numel() + w.numel() + G * M * N)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # bf16 products on the tensor cores; fp32 ones outside them
    rate = BF16_OPS_PER_S if x.dtype == torch.bfloat16 else SCALAR_OPS_PER_S
    bound_ops_ms = 2 * G * M * K * N / rate * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    # kernel and yardstick timed GMM_BATCH calls at a time: a decode
    # product (~0.1 ms) is near the wrapper's host time, which one call per
    # event pair would add to it (kept as kernel_ms_single)
    kernel_ms = cuda_ms(lambda: grouped_matmul(x, w), reps, batch=GMM_BATCH)
    library_ms = cuda_ms(lambda: torch.bmm(x, w), reps, batch=GMM_BATCH)
    rec.update({"phase": "kernel", "name": "grouped_matmul", "input": label,
                "route": which,
                "shape": {"G": G, "M": M, "K": K, "N": N},
                "dtype": str(x.dtype), "bytes": nbytes,
                "kernel_ms": kernel_ms,
                "kernel_ms_single": cuda_ms(lambda: grouped_matmul(x, w),
                                            reps),
                "plain_ms": cuda_ms(lambda: grouped_matmul_ref(x, w),
                                    max(3, reps // 4), warmup=1),
                "library_ms": library_ms,
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                             else "operations"),
                "pct_of_bound": 100 * bound_ms / kernel_ms,
                "kernel_over_library": kernel_ms / library_ms})
    return rec


def model_check() -> dict:
    """OLMoE at full width and 2 layers in float32 (TF32 off): prefill and
    teacher-forced decode give the same logits on cuda and on cpu."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.olmoe_1b_7b import CONFIG
    from repro_torch.models import transformer as tfm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(CONFIG, n_layers=CHECK_LAYERS,
                              dtype=torch.float32)
    t0 = time.perf_counter()
    on_card = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    on_host = tfm.Transformer(cfg, "cpu")
    on_host.load_state_dict(on_card.state_dict())
    rng = np.random.default_rng(SEED)
    prompt = rng.integers(0, cfg.vocab_size, (1, CHECK_PROMPT))
    forced = rng.integers(0, cfg.vocab_size, (CHECK_STEPS, 1, 1))
    logits = {}
    for dev, model in (("cuda", on_card), ("cpu", on_host)):
        caches = tfm.init_kv_cache(cfg, 1, CHECK_PROMPT + CHECK_STEPS,
                                   device=dev)
        out, caches = tfm.prefill(model, torch.as_tensor(prompt, device=dev),
                                  cfg, caches)
        steps = [out]
        for i in range(CHECK_STEPS):
            out, caches = tfm.decode_step(
                model, torch.as_tensor(forced[i], device=dev), cfg, caches,
                CHECK_PROMPT + i)
            steps.append(out)
        logits[dev] = torch.stack(steps).cpu().numpy()
    a, b = logits["cuda"], logits["cpu"]
    err = float(np.abs(a - b).max())
    require(np.isfinite(a).all(), "model check: non-finite logits on cuda")
    require(np.allclose(a, b, rtol=CHECK_RTOL, atol=CHECK_ATOL),
            f"model check: cuda and cpu logits differ (max abs err {err})")
    require((a.argmax(-1) == b.argmax(-1)).all(),
            "model check: argmax tokens differ between cuda and cpu")
    return {"phase": "check", "model": cfg.name, "layers": cfg.n_layers,
            "dtype": str(cfg.dtype), "prompt": CHECK_PROMPT,
            "decode_steps": CHECK_STEPS, "max_abs_err": err,
            "rtol": CHECK_RTOL, "atol": CHECK_ATOL, "argmax_equal": True,
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------- registry

def _to_cpu(obj):
    """A copy of a step argument on the CPU: a model, an optimizer state,
    dicts, tuples and tensors (ints pass)."""
    import copy
    import torch
    from repro_torch.train.optimizer import AdamState
    if isinstance(obj, torch.nn.Module):
        return copy.deepcopy(obj).to("cpu")
    if isinstance(obj, AdamState):
        return AdamState(*(_to_cpu(f) for f in obj))
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    return obj


def _float_tensors(obj) -> list:
    """Every floating tensor of a step's output (a model's parameters
    too)."""
    import torch
    if isinstance(obj, torch.nn.Module):
        return [p for p in obj.parameters() if p.is_floating_point()]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _float_tensors(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _float_tensors(v)]
    if isinstance(obj, torch.Tensor) and obj.is_floating_point():
        return [obj]
    return []


def _compared(out, kind: str) -> dict:
    """The outputs a step is held to the CPU by: a train step's loss and
    gradient norm, else its first output (logits or scores)."""
    if kind == "train":
        return {k: out[2][k].detach().float().cpu()
                for k in ("loss", "grad_norm")}
    first = out[0] if isinstance(out, tuple) else out
    return {"out": first.detach().float().cpu()}


def archs_path() -> dict:
    """The ten architectures through ``get_bundle(arch, smoke=True)`` on
    cuda: every shape that runs, from ``make_concrete(device="cuda")``
    through ``make_step``; every floating output finite; K2 launched on
    every LM shape, K3 on the MoE ones, K4 on Wide & Deep's.  The same
    step on a CPU copy of the same inputs is held to the card's at the
    model tolerances (LM rtol 2e-3 / atol 2e-4 in float32, GNN 1e-3 /
    1e-4, Wide & Deep 1e-4 / 1e-5).  An LM smoke config computes in bf16,
    where a near-tie in the router may send a token to another expert on
    either device (a jump no tolerance bounds): it runs as it is for the
    gates (its ``train_4k`` on fp32 masters, K2's backward launched too),
    and again in float32 for the cuda-vs-cpu check."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_bundle, list_archs
    from repro_torch.configs.lm_common import LMBundle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tols = {"lm": (CHECK_RTOL, CHECK_ATOL), "gnn": (GNN_RTOL, GNN_ATOL),
            "recsys": (RECSYS_RTOL, RECSYS_ATOL)}
    t0 = time.perf_counter()
    runs, launches = [], {}
    for arch in list_archs():
        bundle = get_bundle(arch, smoke=True)
        variants = [(bundle, bundle.family != "lm")]
        if bundle.family == "lm":
            variants.append((LMBundle(dataclasses.replace(
                bundle.cfg, dtype=torch.float32), smoke=True), True))
        for b, check in variants:
            for shape in b.shape_names():
                spec = b.shapes[shape]
                if spec.skip:
                    continue
                args = b.make_concrete(shape, seed=SEED, device="cuda")
                host = _to_cpu(args) if check else None
                step = b.make_step(shape)
                kernels.reset_launches()
                out = step(*args)
                torch.cuda.synchronize()
                n = dict(kernels.LAUNCHES)
                label = f"archs {arch} {shape}"
                dtype = str(getattr(getattr(b, "cfg", None), "dtype",
                                    torch.float32))
                require(all(bool(torch.isfinite(t).all())
                            for t in _float_tensors(out)),
                        f"{label} ({dtype}): a non-finite output")
                if b.family == "lm":
                    require(n.get("flash_attention", 0) >= 1,
                            f"{label}: no flash_attention launch")
                    if spec.kind == "train":
                        require(n.get("flash_attention_bwd", 0) >= 1,
                                f"{label}: no flash_attention_bwd launch")
                    if b.cfg.moe:
                        require(n.get("grouped_matmul", 0) >= 1,
                                f"{label}: no grouped_matmul launch")
                if b.family == "recsys":
                    require(n.get("embedding_bag", 0) >= 1,
                            f"{label}: no embedding_bag launch")
                for k, v in n.items():
                    launches[k] = launches.get(k, 0) + v
                run = {"arch": arch, "shape": shape, "kind": spec.kind,
                       "dtype": dtype, "launches": n}
                if check:
                    got = _compared(out, spec.kind)
                    del out, args
                    want = _compared(step(*host), spec.kind)
                    rtol, atol = tols[b.family]
                    err = max(float((got[k] - want[k]).abs().max())
                              for k in got)
                    require(all(torch.allclose(got[k], want[k], rtol=rtol,
                                               atol=atol) for k in got),
                            f"{label} ({dtype}): cuda and cpu differ (max "
                            f"abs err {err})")
                    run.update(cpu_max_abs_err=err, rtol=rtol, atol=atol)
                runs.append(run)
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "archs", "runs": runs, "launches": launches,
            "seconds": time.perf_counter() - t0}


def _long_bundle():
    """OLMoE's full bundle with ``prefill_32k`` and ``decode_32k`` cut in
    batch (``LONG_BATCH``)."""
    import dataclasses
    from repro_torch.configs import get_bundle
    bundle = get_bundle("olmoe-1b-7b")
    for shape, batch in LONG_BATCH.items():
        spec = bundle.shapes[shape]
        require(spec.dims["seq_len"] == LONG_SEQ, f"{shape}: seq_len "
                f"{spec.dims['seq_len']}")
        bundle.shapes[shape] = dataclasses.replace(
            spec, dims={**spec.dims, "global_batch": batch})
    return bundle


def _arg_bytes(args) -> int:
    """The bytes of every tensor a step is passed (a model's parameters,
    dict values, tensors)."""
    import torch
    total = 0
    for a in args:
        if isinstance(a, torch.nn.Module):
            total += sum(p.numel() * p.element_size()
                         for p in a.parameters())
        elif isinstance(a, dict):
            total += sum(t.numel() * t.element_size() for t in a.values())
        elif isinstance(a, torch.Tensor):
            total += a.numel() * a.element_size()
    return total


def _tie_argmax(a, b) -> bool:
    """Each vector's argmax is a maximum of the other's, up to one bf16
    step of the logits (ties at the logits' resolution)."""
    import torch
    ulp = max(float(a.abs().max()), float(b.abs().max())) * 2.0 ** -7
    ia, ib = int(a.argmax()), int(b.argmax())
    return (ia == ib or (float(b[ia]) >= float(b.max()) - ulp
                         and float(a[ib]) >= float(a.max()) - ulp))


def long_context_path() -> tuple[dict, dict]:
    """OLMoE-1B-7B at ``CONFIG`` (random bf16 weights from a seeded
    generator) through ``get_bundle`` and ``make_step``: ``prefill_32k``
    at batch 1 (32,768 prompt tokens) and ``decode_32k`` at batch 8 over
    caches of 32,768 positions at t = 32,767 (seeded random contents).
    Returns the record and the calls and arguments captured for the kernel
    and dry-run checks."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.models import transformer as tfm
    bundle = _long_bundle()
    cfg = bundle.cfg
    S, L = LONG_SEQ, cfg.n_layers
    rec = {"phase": "long_context", "model": cfg.name,
           "params": cfg.param_count(), "dtype": str(cfg.dtype),
           "seq_len": S,
           "reduced": {s: {"global_batch": [32 if s == "prefill_32k"
                                            else 128, b]}
                       for s, b in LONG_BATCH.items()}}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S))
                             .astype(np.int32), device="cuda")
    caches = tfm.init_kv_cache(cfg, 1, S, device="cuda")
    prefill = bundle.make_step("prefill_32k")
    peaks = []

    def reset_peak():
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    # layer 0's attention call of each warm-up step, captured
    captured = {}
    real_fa = tfm.flash_attention

    def capture(key, positions):
        def fa(q, k, v, q_start, kv_len, **kw):
            out = real_fa(q, k, v, q_start, kv_len, **kw)
            if key not in captured:
                captured[key] = (q.clone(), k.clone(), v.clone(),
                                 *positions(q.shape[0], q_start, kv_len),
                                 kw)
            return out
        return fa

    launches = {}

    def gated(label: str, run, want: dict):
        """One step timed with CUDA events; its launches exactly
        ``want``."""
        kernels.reset_launches()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        out = run()
        b.record()
        b.synchronize()
        got = {k: kernels.LAUNCHES.get(k, 0) for k in want}
        require(got == want, f"long_context {label}: launches {got}, "
                             f"expected {want}")
        for k, n in kernels.LAUNCHES.items():
            launches[k] = launches.get(k, 0) + n
        return out, a.elapsed_time(b)

    per_prefill = {"flash_attention": L, "flash_attention.tc": L,
                   "grouped_matmul": 3 * L, "grouped_matmul.tc": 3 * L}
    tfm.flash_attention = capture("prefill", lambda B, a, b: (a, b))
    try:
        with torch.no_grad():
            (logits, _), warm_ms = gated(
                "prefill", lambda: prefill(model, tokens, caches),
                per_prefill)
    finally:
        tfm.flash_attention = real_fa
    del logits
    before = reset_peak()
    times = []
    with torch.no_grad():
        for _ in range(LONG_PREFILLS):
            (logits, _), ms = gated(
                "prefill", lambda: prefill(model, tokens, caches),
                per_prefill)
            times.append(ms)
    step_peak = torch.cuda.max_memory_allocated() - before
    require(bool(torch.isfinite(logits).all()),
            "long_context prefill: non-finite logits")
    last = logits.float().clone()
    del logits
    prefill_ms = statistics.median(times)
    rec["prefill"] = {"batch": 1, "tokens": S, "warmup_ms": warm_ms,
                      "ms": times, "median_ms": prefill_ms,
                      "tokens_per_s": S / (prefill_ms / 1e3),
                      "launches_per_prefill": per_prefill,
                      "step_peak_bytes": step_peak}
    prefill_args = (model, tokens, caches)
    arg_bytes = {"prefill_32k": _arg_bytes(prefill_args)}

    # prefill(S - 1) and one tick with token S - 1 against prefill(S)
    per_tick = {"flash_attention": L, "flash_attention.split": L,
                "grouped_matmul": 3 * L, "grouped_matmul.tc": 3 * L}
    with torch.no_grad():
        gated(f"prefill of {S - 1}",
              lambda: prefill(model, tokens[:, :S - 1], caches),
              per_prefill)
        (tick, _), _ = gated(
            "tick after prefill", lambda: bundle.make_step("decode_32k")(
                model, tokens[:, S - 1:], caches, S - 1), per_tick)
    tick = tick.float()
    diff = float((tick - last).abs().max())
    require(_tie_argmax(last[0], tick[0]),
            f"long_context: prefill({S - 1}) + one tick gives argmax "
            f"{int(tick.argmax())}, prefill({S}) {int(last.argmax())}")
    require(diff <= LONG_TICK_BOUND,
            f"long_context: prefill({S - 1}) + one tick is {diff} from "
            f"prefill({S}) (bound {LONG_TICK_BOUND})")
    rec["tick_vs_prefill"] = {"max_abs_diff": diff,
                              "bound": LONG_TICK_BOUND,
                              "argmax": [int(last.argmax()),
                                         int(tick.argmax())],
                              "logit_max_abs": float(last.abs().max())}
    del caches, tick, last, prefill_args
    gc.collect()
    torch.cuda.empty_cache()

    # decode_32k at batch 8 over seeded random caches of S positions
    B = LONG_BATCH["decode_32k"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shape = (L, B, S, cfg.n_kv_heads, cfg.hd)
    caches = {kv: torch.randn(shape, generator=gen, device="cuda",
                              dtype=cfg.dtype) for kv in ("k", "v")}
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 1))
                           .astype(np.int32), device="cuda")
    t = torch.tensor(S - 1, dtype=torch.int32, device="cuda")
    decode = bundle.make_step("decode_32k")
    decode_args = (model, toks, caches, t)
    # the split route's phase takes per-batch positions
    tfm.flash_attention = capture("decode", lambda B, a, b: tuple(
        torch.full((B,), int(x), dtype=torch.int32, device="cuda")
        for x in (a, b)))
    try:
        with torch.no_grad():
            (out, _), warm_ms = gated("tick", lambda: decode(*decode_args),
                                      per_tick)
    finally:
        tfm.flash_attention = real_fa
    before = reset_peak()
    times = []
    with torch.no_grad():
        for _ in range(LONG_TICKS):
            (out, _), ms = gated("tick", lambda: decode(*decode_args),
                                 per_tick)
            times.append(ms)
    require(bool(torch.isfinite(out).all()),
            "long_context tick: non-finite logits")
    tick_ms = statistics.median(times)
    rec["decode"] = {"batch": B, "cached_keys": S, "t": S - 1,
                     "warmup_ms": warm_ms, "ms": times,
                     "median_ms": tick_ms,
                     "tokens_per_s": B / (tick_ms / 1e3),
                     "launches_per_tick": per_tick,
                     "step_peak_bytes": torch.cuda.max_memory_allocated()
                     - before}
    arg_bytes["decode_32k"] = _arg_bytes(decode_args)
    reset_peak()
    peak_all = max(peaks)
    rec["max_memory_allocated"] = peak_all
    rec["launches"] = launches
    require(peak_all <= LONG_PEAK_BYTES,
            f"long_context: peak {peak_all} bytes > {LONG_PEAK_BYTES}")
    measured = {"prefill_32k": {"ms": prefill_ms,
                                "step_peak_bytes":
                                rec["prefill"]["step_peak_bytes"]},
                "decode_32k": {"ms": tick_ms,
                               "step_peak_bytes":
                               rec["decode"]["step_peak_bytes"]}}
    del model, caches, decode_args, out, toks, t
    gc.collect()
    torch.cuda.empty_cache()
    return rec, {"calls": captured, "arg_bytes": arg_bytes,
                 "measured": measured}


def long_attention_phase(label: str, q, k, v, q_start, kv_len, kw: dict,
                         want_route: str, rows: int = LONG_CHECK_ROWS,
                         reps: int = 5) -> dict:
    """K2 on a captured causal prefill too long for its plain version's
    score matrix: the route it must take (its launch counted), the last
    ``rows`` query rows held to the plain version over every key, the
    time of one call, SDPA ``is_causal`` on the same inputs, the plain
    version's time on those rows and the bound of the whole call."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         route)
    from repro_torch.kernels.flash_attention.ref import (admissible_pairs,
                                                         flash_attention_ref)
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    which = route(q, k, v)
    require(which == want_route,
            f"{label}: route {which}, expected {want_route}")
    require(int(q_start) == 0 and int(kv_len) == Sq == Skv,
            f"{label}: not a causal prefill from position 0")
    counted = kernels.LAUNCHES.get(f"flash_attention.{which}", 0)
    got = flash_attention(q, k, v, q_start, kv_len, **kw)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES.get(f"flash_attention.{which}", 0)
            == counted + 1, f"{label}: no flash_attention.{which} launch")
    tail = q[:, Sq - rows:]
    want = flash_attention_ref(tail, k, v, Sq - rows, kv_len, **kw)
    rec = _verdict(label, got[:, Sq - rows:], want, ATTENTION_TOL)
    rec["checked_rows"] = rows
    del want
    pairs = admissible_pairs(B, Sq, Skv, q_start, kv_len,
                             kw.get("window")) * Kh * G
    esize = q.element_size()
    nbytes = esize * (2 * q.numel() + 2 * B * Skv * Kh * hd)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = 4 * hd * pairs / BF16_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    kernel_ms = cuda_ms(lambda: flash_attention(q, k, v, q_start, kv_len,
                                                **kw), reps)
    qs = q.permute(0, 2, 3, 1, 4).reshape(B, Kh * G, Sq, hd)
    ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=G > 1), reps)
    plain_ms = cuda_ms(lambda: flash_attention_ref(
        tail, k, v, Sq - rows, kv_len, **kw), 3, warmup=1)
    rec.update({"phase": "kernel", "name": "flash_attention", "input": label,
                "route": which,
                "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Kh": Kh, "G": G,
                          "hd": hd},
                "dtype": str(q.dtype), "admissible_pairs": pairs,
                "bytes": nbytes, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "plain_rows": rows,
                "library_ms": library_ms, "library": "SDPA is_causal",
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                             else "operations"),
                "pct_of_bound": 100 * bound_ms / kernel_ms,
                "kernel_over_library": kernel_ms / library_ms})
    return rec


def dryrun_path(long: dict) -> dict:
    """``launch/dryrun.py``'s ``run_cell`` for every arch x shape x both
    production meshes (every cell OK or SKIPPED, the skipped ones exactly
    ``DRYRUN_SKIPS``), then the two long-context cells at their cut batch
    on a (1, 1) mesh beside what the card measured: the predicted
    arguments equal to the bytes of the tensors passed, the predicted
    temporaries beside the step's peak less what was allocated before it,
    and the measured ms beside max(t_compute, t_memory)."""
    from repro_torch.configs import get_bundle, list_archs
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import AbstractMesh
    t0 = time.perf_counter()
    cells, skipped, status = 0, set(), {}
    for arch in list_archs():
        for shape in get_bundle(arch).shape_names():
            for multi in (False, True):
                r = run_cell(arch, shape, multi)
                cells += 1
                status[r["status"]] = status.get(r["status"], 0) + 1
                require(r["status"] in ("OK", "SKIPPED"),
                        f"dryrun {arch} {shape} {r['mesh']}: "
                        f"{r.get('error')}")
                if r["status"] == "SKIPPED":
                    skipped.add((arch, shape))
    require(skipped == DRYRUN_SKIPS,
            f"dryrun: skipped {sorted(skipped)}, expected "
            f"{sorted(DRYRUN_SKIPS)}")
    rec = {"phase": "dryrun", "cells": cells, "status": status,
           "skipped": sorted(f"{a} {s}" for a, s in skipped),
           "all_cells_s": time.perf_counter() - t0, "long_context": {}}
    bundle = _long_bundle()
    mesh = AbstractMesh((1, 1), ("data", "model"))
    for shape, got in long["measured"].items():
        r = run_cell("olmoe-1b-7b", shape, bundle=bundle, mesh=mesh)
        require(r["status"] == "OK", f"dryrun {shape} at the cut batch: "
                                     f"{r.get('error')}")
        b = r["bytes_per_device"]
        passed = long["arg_bytes"][shape]
        require(b["arguments"] == passed,
                f"dryrun {shape}: predicted arguments {b['arguments']}, "
                f"the tensors passed hold {passed} bytes")
        roof = r["roofline"]
        bound_ms = 1e3 * max(roof["t_compute_s"], roof["t_memory_s"])
        rec["long_context"][shape] = {
            "batch": LONG_BATCH[shape], "arguments": b["arguments"],
            "arguments_passed": passed, "outputs": b["outputs"],
            "temps_predicted": b["temps"],
            "temps_measured": got["step_peak_bytes"],
            "temps_method": b["temps_method"],
            "measured_ms": got["ms"], "roofline_ms": bound_ms,
            "t_compute_ms": 1e3 * roof["t_compute_s"],
            "t_memory_ms": 1e3 * roof["t_memory_s"],
            "dominant": roof["dominant"],
            "measured_over_roofline": got["ms"] / bound_ms,
            "flops": roof["flops"], "bytes": roof["bytes"],
            "run_s": r["run_s"]}
    return rec


# --------------------------------------------------- mixed-precision LM

@contextlib.contextmanager
def layer0_captured(captured: dict):
    """Within it, the first K2 call and the first w1 and w2 expert products
    that take part in autograd (layer 0's forward: ``moe_mlp`` calls w1,
    w3 and w2 in this order, and a checkpointed layer's recompute comes
    later) are copied into ``captured`` under ``attention`` (q, k, v,
    q_start, kv_len, options), ``w1`` and ``w2`` (x, w), and a hook
    appends each call's output gradient when the backward reaches it."""
    import torch
    from repro_torch.models import transformer as tfm
    real_fa, real_gmm = tfm.flash_attention, tfm.grouped_matmul
    order = ["w1", "w3", "w2"]

    def keep_grad(key, out):
        out.register_hook(lambda g: captured[key].append(
            g.detach().clone(memory_format=torch.contiguous_format)))

    def fa(q, k, v, q_start, kv_len, **kw):
        out = real_fa(q, k, v, q_start, kv_len, **kw)
        if "attention" not in captured and out.requires_grad:
            captured["attention"] = [t.detach().clone() for t in (q, k, v)] \
                + [q_start, kv_len, kw]
            keep_grad("attention", out)
        return out

    def gmm(x, w):
        out = real_gmm(x, w)
        if order and out.requires_grad:
            which = order.pop(0)
            if which != "w3":
                captured[which] = [x.detach().clone(), w.detach().clone()]
                keep_grad(which, out)
        return out

    tfm.flash_attention, tfm.grouped_matmul = fa, gmm
    try:
        yield captured
    finally:
        tfm.flash_attention, tfm.grouped_matmul = real_fa, real_gmm


def _train_arg_bytes(model, ost, batch) -> dict:
    """The bytes a train step is passed (every parameter, both moments, the
    step counter, the compression residuals and the batch), and the two
    terms by which the dry run's count differs by convention: it counts
    one compression residual scalar a leaf of the reference's tree, where
    the port keeps one a tensor (zeros while compression is off)."""
    from repro_torch.configs.base import reference_specs, tree_leaves
    require(all(e.dim() == 0 for e in ost.ef_error),
            "a train step with compression on")
    leaves = len(tree_leaves(reference_specs((model,))[0]))
    esize = ost.ef_error[0].element_size()
    tensors = [*model.parameters(), *ost.mu, *ost.nu, ost.step,
               *ost.ef_error, *batch.values()]
    return {"passed": sum(t.numel() * t.element_size() for t in tensors),
            "port_residual_bytes": len(ost.ef_error) * esize,
            "reference_residual_bytes": leaves * esize}


def _sample(t, n: int = 1 << 16):
    """A strided sample of ``t``'s elements (a copy), to tell whether a
    step moved it without copying the whole tensor."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // n)].clone()


def lm_train_bf16_path() -> tuple[dict, dict]:
    """OLMoE-1B-7B's ``train_4k`` through ``get_bundle``: bf16 compute on
    fp32 masters at the published widths, cut to ``BF16_TRAIN_LAYERS``
    layers and ``BF16_TRAIN_BATCH`` sequences of the cell's 4,096 tokens.
    Random masters from a seeded generator, the bundle's ``adam_cfg()``,
    tokens from ``train/data.py``.  One warm-up step that captures layer
    0's K2 call and K3's w1 and w2 products with their output gradients,
    ``BF16_TRAIN_STEPS`` steps timed with CUDA events, one profiled step,
    and the cut cell's dry run on a (1, 1) mesh.  Returns the record and
    the captured calls."""
    import dataclasses
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_bundle
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, batch_at
    bundle = get_bundle("olmoe-1b-7b")
    full, spec = bundle.cfg, bundle.shapes["train_4k"]
    require(full.dtype == torch.bfloat16 and spec.skip is None,
            f"olmoe-1b-7b train_4k: {full.dtype}, skip {spec.skip}")
    S, B, L = spec.dims["seq_len"], BF16_TRAIN_BATCH, BF16_TRAIN_LAYERS
    bundle.cfg = cfg = dataclasses.replace(full, n_layers=L)
    bundle.shapes["train_4k"] = dataclasses.replace(
        spec, dims={**spec.dims, "global_batch": B})
    per_step = lm_launches_per_step(cfg)
    rec = {"phase": "lm_train_bf16", "model": cfg.name,
           "dtype": str(cfg.dtype), "layers": L, "d_model": cfg.d_model,
           "heads": cfg.n_heads, "head_dim": cfg.hd,
           "experts": cfg.n_experts, "top_k": cfg.top_k, "d_ff": cfg.d_ff,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "batch": B, "seq": S, "tokens_per_step": B * S,
           "reduced": [f"n_layers {full.n_layers} -> {L}",
                       f"global_batch {spec.dims['global_batch']} -> {B}"],
           "launches_per_step": per_step}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", master=True)
    acfg = bundle.adam_cfg()
    ost = opt.init(acfg, model.parameters())
    torch.cuda.synchronize()
    rec["init_s"] = time.perf_counter() - t0
    masters = {n: str(p.dtype) for n, p in model.named_parameters()
               if p.dtype != torch.float32}
    require(not masters, f"lm_train_bf16: non-fp32 masters {masters}")
    step = bundle.make_step("train_4k")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)

    def on_card(i):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in batch_at(dcfg, i).items()}

    state = {"ost": ost}
    del ost

    def timed(batch):
        """One step timed with CUDA events; its launches exactly
        ``per_step``."""
        was = dict(kernels.LAUNCHES)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        _, state["ost"], m = step(model, state["ost"], batch)
        e.record()
        e.synchronize()
        got = {k: n - was.get(k, 0) for k, n in kernels.LAUNCHES.items()
               if n != was.get(k, 0)}
        require(got == {k: n for k, n in per_step.items() if n},
                f"lm_train_bf16: launches {got}, expected {per_step}")
        require(bool(torch.isfinite(m["loss"]))
                and bool(torch.isfinite(m["grad_norm"])),
                f"lm_train_bf16: loss {float(m['loss'])}, grad norm "
                f"{float(m['grad_norm'])}")
        return a.elapsed_time(e), float(m["loss"]), float(m["grad_norm"])

    kernels.reset_launches()
    before = {n: _sample(p) for n, p in model.named_parameters()}
    with layer0_captured({}) as captured:
        warm_ms, loss0, norm0 = timed(on_card(0))
    still = [n for n, p in model.named_parameters()
             if torch.equal(_sample(p), before[n])]
    require(not still, f"lm_train_bf16: masters unmoved by a step: {still}")
    del before
    require(sorted(captured) == ["attention", "w1", "w2"]
            and len(captured["attention"]) == 7
            and all(len(captured[w]) == 3 for w in ("w1", "w2")),
            f"lm_train_bf16: captured {sorted(captured)}")
    runs = [timed(on_card(i)) for i in range(1, 1 + BF16_TRAIN_STEPS)]
    times = [r[0] for r in runs]
    med = statistics.median(times)
    flops = cfg.train_flops(B, S)
    rec.update({
        "warmup_ms": warm_ms, "step_ms": times, "step_ms_median": med,
        "tokens_per_s": B * S / (med / 1e3), "train_flops": flops,
        "tflops_per_s": flops / (med * 1e-3) / 1e12,
        "loss": [loss0] + [r[1] for r in runs],
        "grad_norm": [norm0] + [r[2] for r in runs],
        "masters": "every parameter fp32, every one moved by step 0"})
    rec["profiled"] = profile_step(step, model, state["ost"], on_card(99))
    rec["launches"] = dict(kernels.LAUNCHES)
    rec["max_memory_allocated"] = peak = torch.cuda.max_memory_allocated()
    require(peak <= BF16_TRAIN_PEAK_BYTES,
            f"lm_train_bf16: peak {peak} bytes > {BF16_TRAIN_PEAK_BYTES}")

    # the cut cell's dry run beside the card
    args = _train_arg_bytes(model, state["ost"], on_card(0))
    r = run_cell("olmoe-1b-7b", "train_4k", bundle=bundle,
                 mesh=AbstractMesh((1, 1), ("data", "model")))
    require(r["status"] == "OK", f"dryrun train_4k at the cut size: "
                                 f"{r.get('error')}")
    b = r["bytes_per_device"]
    # the residual scalars counted a reference leaf, not a port tensor
    adjusted = (args["passed"] - args["port_residual_bytes"]
                + args["reference_residual_bytes"])
    require(b["arguments"] == adjusted,
            f"dryrun train_4k: predicted arguments {b['arguments']}, the "
            f"tensors passed hold {args['passed']} bytes ({adjusted} with "
            f"the reference's residual scalars)")
    roof = r["roofline"]
    bound_ms = 1e3 * max(roof["t_compute_s"], roof["t_memory_s"])
    rec["dryrun"] = {
        "arguments": b["arguments"], "arguments_passed": args["passed"],
        "port_residual_scalar_bytes": args["port_residual_bytes"],
        "reference_residual_scalar_bytes": args["reference_residual_bytes"],
        "arguments_passed_adjusted": adjusted, "outputs": b["outputs"],
        "temps_predicted": b["temps"], "temps_method": b["temps_method"],
        "peak_measured": peak, "measured_ms": med, "roofline_ms": bound_ms,
        "t_compute_ms": 1e3 * roof["t_compute_s"],
        "t_memory_ms": 1e3 * roof["t_memory_s"],
        "dominant": roof["dominant"],
        "measured_over_roofline": med / bound_ms,
        "flops": roof["flops"], "bytes": roof["bytes"],
        "run_s": r["run_s"]}
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return rec, captured


def lm_train_bf16_kernels(calls: dict) -> tuple[dict, dict, list, list]:
    """K2 and K3 held against their plain versions on the calls
    ``lm_train_bf16_path``'s warm-up step captured, each record emitted:
    K2's ``tc`` forward and its bf16 backward on layer 0's attention, then
    for w1 and w2 K3's ``tc`` forward and its dx and dw.  Empties
    ``calls``."""
    import torch
    q, k, v, q_start, kv_len, kw, dout = calls.pop("attention")
    starts, lens = (torch.full((q.shape[0],), n, dtype=torch.int32,
                               device="cuda") for n in (q_start, kv_len))
    fa = attention_phase("olmoe_layer0_bf16", q, k, v, starts, lens, kw,
                         "tc", reps=10)
    emit(fa)
    del starts, lens
    fa_bwd = attention_bwd_phase("olmoe_layer0_bf16", q, k, v, q_start,
                                 kv_len, kw, dout, ATTENTION_TOL, reps=10)
    emit(fa_bwd)
    del q, k, v, dout
    gc.collect()
    torch.cuda.empty_cache()
    gmm, gmm_bwd = [], []
    for w in ("w1", "w2"):
        x, wt, dy = calls.pop(w)
        gmm.append(gmm_phase(f"olmoe_layer0_{w}_bf16", x, wt, "tc", reps=10))
        emit(gmm[-1])
        gmm_bwd.append(gmm_bwd_phase(f"olmoe_layer0_{w}_bf16", x, wt, dy,
                                     tol=GMM_TOL, reps=10))
        emit(gmm_bwd[-1])
        del x, wt, dy
    gc.collect()
    torch.cuda.empty_cache()
    return fa, fa_bwd, gmm, gmm_bwd


# ------------------------------------------------------------------ recsys

def recsys_path() -> tuple[dict, dict, dict]:
    """Wide & Deep ``CONFIG`` serving its three shapes on the card.
    Returns the phase record, the host-to-card copy record and the kernel
    calls captured on the way (the first ``serve_p99`` and ``serve_bulk``
    lookups: their ids and the table)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import wide_deep as wd
    from repro_torch.models import recsys
    require(not torch.backends.cuda.matmul.allow_tf32,
            "recsys: TF32 matmuls are on")
    cfg = wd.CONFIG
    t0 = time.perf_counter()
    model = recsys.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    require(n_params == cfg.param_count() + 1,     # + the wide bias
            f"recsys: {n_params} parameters, config {cfg.param_count()}")
    # batches: built on the host, then copied, both outside the timing
    host, batches, build_s, copy_ms = {}, {}, {}, {}
    for shape in RECSYS_RUNS:
        t0 = time.perf_counter()
        host[shape] = wd.host_batch(cfg, wd.SHAPES[shape], seed=SEED)
        build_s[shape] = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches[shape] = {k: torch.as_tensor(v, device="cuda")
                          for k, v in host[shape].items()}
        torch.cuda.synchronize()
        copy_ms[shape] = (time.perf_counter() - t0) * 1e3
    copy_rec = {"phase": "recsys_copy", "host_build_s": build_s,
                "copy_ms": copy_ms,
                "bytes": {sh: sum(int(v.nbytes) for v in b.values())
                          for sh, b in host.items()}}

    captured, current = {}, {"shape": None}
    real_bag = recsys.bag_sum

    def bag(ids, table, out=None):
        key = current["shape"]
        if key in ("serve_p99", "serve_bulk") and key not in captured:
            # the ids, the table and the geometry of the deep tower's
            # buffer that ``out`` views: rows, row stride, bag columns
            captured[key] = (ids.clone(), table,
                             (out.shape[0], out.stride(0), out.shape[1]))
        return real_bag(ids, table, out=out)

    dims = {shape: wd.SHAPES[shape].dims for shape in RECSYS_RUNS}
    out_shape = {shape: (d.get("n_candidates", d["batch"]),)
                 for shape, d in dims.items()}
    ms, finite, forwards = {}, [], 0
    recsys.bag_sum = bag
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t_all = time.perf_counter()
        for shape, runs in RECSYS_RUNS.items():
            current["shape"] = shape
            step = wd.make_step(cfg, wd.SHAPES[shape].kind)
            b = batches[shape]
            times = []
            for i in range(1 + runs):               # one warm-up run
                t = time.perf_counter()
                out = step(model, b)
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t) * 1e3)
                forwards += 1
                require(tuple(out.shape) == out_shape[shape],
                        f"recsys {shape}: output shape {tuple(out.shape)}")
                finite.append(torch.isfinite(out).all())
            ms[shape] = times
        wall_s = time.perf_counter() - t_all
        launches = dict(kernels.LAUNCHES)
    finally:
        recsys.bag_sum = real_bag
    peak = torch.cuda.max_memory_allocated()
    profiled = {shape: profile_step(wd.make_step(cfg, wd.SHAPES[shape].kind),
                                    model, batches[shape])
                for shape in RECSYS_RUNS}
    require(bool(torch.stack(finite).all()), "recsys: non-finite outputs")
    require(launches.get("embedding_bag", 0) == forwards,
            f"recsys: {launches.get('embedding_bag', 0)} embedding_bag "
            f"launches for {forwards} forwards")
    require(launches.get("embedding_bag.vec", 0) == forwards,
            f"recsys: {launches.get('embedding_bag.vec', 0)} of "
            f"{forwards} embedding_bag launches on the vec route")
    for shape, prof in profiled.items():
        cats = [k for k in prof["copy_kernels"]
                if "catarraybatchedcopy" in k[2].lower()]
        require(not cats, f"recsys {shape}: the profiled forward still "
                          f"runs a concat kernel {cats}")
    require(set(captured) == {"serve_p99", "serve_bulk"},
            f"recsys: captured {sorted(captured)}")
    p99 = np.asarray(ms["serve_p99"])
    bulk_s = np.asarray(ms["serve_bulk"]) / 1e3
    rec = {"phase": "recsys", "model": cfg.name, "dtype": str(cfg.dtype),
           "params": n_params - 1,
           "table_bytes": model.table.numel() * model.table.element_size(),
           "items_bytes": model.items.numel() * model.items.element_size(),
           "init_s": init_s, "wall_s": wall_s, "forwards": forwards,
           "serve_p99": {"batch": dims["serve_p99"]["batch"],
                         "runs": len(p99),
                         "p50_ms": float(np.percentile(p99, 50)),
                         "p99_ms": float(np.percentile(p99, 99)),
                         "max_ms": float(p99.max())},
           "serve_bulk": {"batch": dims["serve_bulk"]["batch"],
                          "runs": len(bulk_s),
                          "ms": [float(x) for x in ms["serve_bulk"]],
                          "examples_per_s": float(
                              dims["serve_bulk"]["batch"]
                              / np.median(bulk_s))},
           "retrieval_cand": {"candidates": out_shape["retrieval_cand"][0],
                              "runs": len(ms["retrieval_cand"]),
                              "median_ms": statistics.median(
                                  ms["retrieval_cand"])},
           "launches": launches, "max_memory_allocated": peak,
           "profiled": profiled}
    del model, batches
    return rec, copy_rec, captured


def bag_phase(label: str, ids, table, out_geom=None, want_route="vec",
              reps: int = REPS) -> dict:
    """The embedding-bag kernel against its plain version on one captured
    lookup, on the route it must take (``want_route``), with the
    ``F.embedding_bag`` yardstick and the bound.  With ``out_geom`` (rows,
    row stride, bag columns of the deep tower's buffer) both write through
    ``out`` into such a buffer, whose other columns must keep their bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag.ops import embedding_bag, route
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    B, L = ids.shape
    V, D = table.shape
    if out_geom is None:
        out, want_out = None, None
    else:
        rows, stride, cols = out_geom
        # NaN where the bags go, a pattern past them: every bag column must
        # be written, and no other column touched
        bufs = [torch.full((rows, stride), float("nan"), dtype=table.dtype,
                           device=table.device) for _ in range(2)]
        for buf in bufs:
            buf[:, cols:] = torch.arange(stride - cols, dtype=table.dtype,
                                         device=table.device)
        rest = bufs[0][:, cols:].clone()
        out, want_out = bufs[0][:, :cols], bufs[1][:, :cols]
    which = route(ids, table, out)
    require(which == want_route,
            f"{label}: route {which}, expected {want_route}")
    counted = kernels.LAUNCHES.get(f"embedding_bag.{which}", 0)
    got = embedding_bag(ids, table, out=out)
    want = embedding_bag_ref(ids, table, out=want_out)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES.get(f"embedding_bag.{which}", 0)
            == counted + 1, f"{label}: no embedding_bag.{which} launch")
    rec = _verdict(label, got, want, BAG_TOL)
    if out is not None:
        require(got.data_ptr() == out.data_ptr(),
                f"{label}: the result is not the given out")
        require(torch.equal(bufs[0][:, cols:], rest),
                f"{label}: the kernel wrote past the bag columns")
        rec["padding_untouched"] = True
    del want
    esize = table.element_size()
    valid = (ids >= 0) & (ids < V)
    slots = int(valid.sum())
    distinct = int(torch.unique(ids[valid]).numel())
    # compulsory traffic: the ids and the output once, and each row the
    # bags name once (distinct rows); the figure counting every slot's row
    bytes_distinct = 4 * ids.numel() + (distinct + B) * D * esize
    bytes_slots = 4 * ids.numel() + (slots + B) * D * esize
    bound_bytes_ms = bytes_distinct / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = slots * D / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_every_slot_ms = bytes_slots / HBM_BYTES_PER_S * 1e3

    def kernel():
        return embedding_bag(ids, table, out=out)

    # kernel and yardstick timed BAG_BATCH calls at a time, queued behind a
    # device sleep: a serve_p99 lookup (~0.01 ms) is shorter than the
    # wrapper's host time, which one call per event pair would add to it
    # (kept as kernel_ms_single)
    kernel_ms = cuda_ms(kernel, reps, batch=BAG_BATCH, queued=True)
    plain_ms = cuda_ms(lambda: embedding_bag_ref(ids, table, out=want_out),
                       max(3, reps // 4), warmup=1)
    # yardstick: one F.embedding_bag call into a fresh [B, D] (it has no
    # strided output), its clamped ids and per-slot weights (0 for padding
    # and ids past the table) made before the timing (not part of the port)
    library_ms = None
    if out is None:
        lib_ids = ids.clamp(0, V - 1)
        weights = valid.to(table.dtype)
        library_ms = cuda_ms(lambda: F.embedding_bag(
            lib_ids, table, mode="sum", per_sample_weights=weights), reps,
            batch=BAG_BATCH, queued=True)
    rec.update({"phase": "kernel", "name": "embedding_bag", "input": label,
                "route": which,
                "shape": {"B": B, "L": L, "V": V, "D": D},
                "out": (None if out is None else
                        {"shape": list(out.shape), "stride": out.stride()}),
                "dtype": str(table.dtype), "valid_slots": slots,
                "distinct_rows": distinct,
                "rows_at_or_above_2_26": int((ids[valid] >= 1 << 26).sum()),
                "bytes": bytes_distinct, "bytes_every_slot": bytes_slots,
                "bound_every_slot_ms": bound_every_slot_ms,
                "kernel_ms": kernel_ms,
                "kernel_ms_single": cuda_ms(kernel, reps),
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                             else "operations"),
                "pct_of_bound": 100 * bound_ms / kernel_ms,
                "pct_of_bound_every_slot": (100 * bound_every_slot_ms
                                            / kernel_ms),
                "kernel_over_library": (None if library_ms is None
                                        else kernel_ms / library_ms)})
    return rec


def recsys_check() -> dict:
    """Wide & Deep SMOKE in float32 (TF32 off): the serve and retrieval
    outputs on cuda equal those on cpu."""
    import torch
    from repro_torch.configs import wide_deep as wd
    from repro_torch.models import recsys
    require(not torch.backends.cuda.matmul.allow_tf32,
            "recsys check: TF32 matmuls are on")
    cfg = wd.SMOKE
    t0 = time.perf_counter()
    on_card = recsys.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    on_host = recsys.WideDeep(cfg, "cpu")
    on_host.load_state_dict(on_card.state_dict())
    errs = {}
    for shape in ("serve_p99", "retrieval_cand"):
        spec = wd.SMOKE_SHAPES[shape]
        step = wd.make_step(cfg, spec.kind)
        a = step(on_card, wd.make_batch(cfg, spec, SEED, "cuda")).cpu()
        b = step(on_host, wd.make_batch(cfg, spec, SEED, "cpu"))
        errs[shape] = float((a - b).abs().max())
        require(bool(torch.isfinite(a).all()),
                f"recsys check {shape}: non-finite outputs on cuda")
        require(torch.allclose(a, b, rtol=RECSYS_RTOL, atol=RECSYS_ATOL),
                f"recsys check {shape}: cuda and cpu differ (max abs err "
                f"{errs[shape]})")
    return {"phase": "check", "model": cfg.name, "dtype": str(cfg.dtype),
            "max_abs_err": errs, "rtol": RECSYS_RTOL, "atol": RECSYS_ATOL,
            "seconds": time.perf_counter() - t0}


# ------------------------------------------------------------ recsys_train

def bits_digest(t, keep=None, rows_per: int = 1 << 19) -> int:
    """A 64-bit digest of the bit patterns of ``t``'s rows (``keep``: a
    bool mask of the rows it covers, else all): each value's bits times an
    odd weight of its column, each row's sum mixed with its index, summed
    with int64 wrap-around, ``rows_per`` rows at a time (a few hundred MB
    of temporaries).  A value whose bits change changes the digest, but for
    a collision."""
    import torch
    rows = t.detach().reshape(t.shape[0], -1) if t.dim() > 1 \
        else t.detach().reshape(-1, 1)
    dev = t.device
    w = torch.arange(1, 2 * rows.shape[1], 2, dtype=torch.int64, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    for a in range(0, rows.shape[0], rows_per):
        blk = rows[a:a + rows_per].view(torch.int32).to(torch.int64)
        idx = torch.arange(a, a + blk.shape[0], dtype=torch.int64,
                           device=dev)
        h = (blk * w).sum(1) ^ (idx * 0x2545F491)
        if keep is not None:
            h = h * keep[a:a + blk.shape[0]]
        total += h.sum()
    return int(total)


def recsys_train_path() -> tuple[dict, dict]:
    """Wide & Deep ``CONFIG`` trained on the card at ``train_batch``
    (65,536 examples) through ``make_step(cfg, "train")`` with the
    reference's ``adam_cfg()``: one warm-up step, which captures the K4
    backward's call, ``RECSYS_TRAIN_STEPS`` steps timed with CUDA events
    (their peak memory gated), one profiled step; the batches cycle
    through ``RECSYS_TRAIN_BATCHES`` seeded host batches.  Returns the
    phase record and the captured call (ids, the deep tower's input
    gradient on the host, the table's rows)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import wide_deep as wd
    from repro_torch.models import recsys
    from repro_torch.train import optimizer as opt
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    cfg, spec = wd.CONFIG, wd.SHAPES["train_batch"]
    B = spec.dims["batch"]
    t0 = time.perf_counter()
    model = recsys.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    ost = opt.init(wd.adam_cfg(), model.parameters())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = wd.make_step(cfg, "train")
    build_s, batches = [], []
    for i in range(RECSYS_TRAIN_BATCHES):
        t = time.perf_counter()
        host = wd.host_batch(cfg, spec, seed=SEED + i)
        build_s.append(time.perf_counter() - t)
        batches.append({k: torch.as_tensor(v, device="cuda")
                        for k, v in host.items()})
    del host
    # what must move and what must keep its bits: the table rows the
    # batches name (a copy on the host), the rest of the table, the items
    # and the user projection (digests), the first MLP layer
    touched = torch.zeros(cfg.total_rows, dtype=torch.bool, device="cuda")
    for b in batches:
        gidx = recsys.table_ids(b["sparse_ids"], model.offsets)
        touched[gidx[gidx >= 0].long()] = True
    del gidx
    rows = touched.nonzero().squeeze(1)
    rows_before = model.table[rows].cpu()
    digests = {"items": bits_digest(model.items),
               "user_proj": bits_digest(model.user_proj),
               "untouched_table_rows": bits_digest(model.table, ~touched)}
    mlp0 = model.mlp[0].w.detach().clone()

    captured = {}
    real_grad = recsys.bag_grad

    def bag_grad(ids, grad, V):
        if not captured:
            # the ids, and the deep tower's input gradient with its row
            # stride (the bag columns are a view of it), on the host
            full = torch.empty((grad.shape[0], grad.stride(0)),
                               dtype=grad.dtype)
            full[:, :grad.shape[1]] = grad.cpu()
            captured.update(ids=ids.cpu(), grad=full, cols=grad.shape[1],
                            V=V)
        return real_grad(ids, grad, V)

    kernels.reset_launches()
    recsys.bag_grad = bag_grad
    try:
        t = time.perf_counter()
        model, ost, m = step(model, ost, batches[0])
        torch.cuda.synchronize()
        warmup_ms = (time.perf_counter() - t) * 1e3
    finally:
        recsys.bag_grad = real_grad
    require(set(captured) == {"ids", "grad", "cols", "V"},
            "recsys_train: the warm-up step made no K4 backward call")
    metrics = [m]
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(1, 1 + RECSYS_TRAIN_STEPS):
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        model, ost, m = step(model, ost, batches[i % len(batches)])
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.LAUNCHES)
    steps = 1 + RECSYS_TRAIN_STEPS
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"recsys_train: non-finite loss {losses} or grad norm {norms}")
    want = {"embedding_bag": steps, "embedding_bag.vec": steps,
            "embedding_bag_bwd": steps}
    require(launches == want, f"recsys_train: launches {launches}, "
                              f"expected {want} ({steps} steps)")
    require(peak <= RECSYS_TRAIN_PEAK_BYTES,
            f"recsys_train: peak memory {peak} > {RECSYS_TRAIN_PEAK_BYTES}")
    profiled = profile_step(step, model, ost, batches[0])
    moved = (model.table.detach()[rows].cpu() != rows_before).any(dim=1)
    require(bool(moved.all()), f"recsys_train: {int((~moved).sum())} of "
                               f"{len(rows)} touched table rows kept their "
                               f"bits")
    require(not torch.equal(model.mlp[0].w.detach(), mlp0),
            "recsys_train: the first MLP layer did not move")
    after = {"items": bits_digest(model.items),
             "user_proj": bits_digest(model.user_proj),
             "untouched_table_rows": bits_digest(model.table, ~touched)}
    require(after == digests, f"recsys_train: weights no batch reaches "
                              f"moved: digests {digests} -> {after}")
    med = statistics.median(times)
    flops = wd.model_flops(cfg, spec)
    n_params = sum(p.numel() for p in model.parameters())
    rec = {"phase": "recsys_train", "model": cfg.name,
           "dtype": str(cfg.dtype), "params": n_params - 1, "batch": B,
           "adam": dataclasses.asdict(wd.adam_cfg()),
           "update_piece": opt.PIECE, "init_s": init_s,
           "host_build_s": build_s, "warmup_ms": warmup_ms,
           "step_ms": times, "step_ms_median": med,
           "step_ms_p90": float(np.percentile(times, 90)),
           "examples_per_s": B / (med * 1e-3), "model_flops": flops,
           "tflops_per_s": flops / (med * 1e-3) / 1e12,
           "loss": losses, "grad_norm": norms,
           "launches": launches, "launches_per_step": {
               k: v // steps for k, v in want.items()},
           "max_memory_allocated": peak,
           "peak_limit": RECSYS_TRAIN_PEAK_BYTES,
           "touched_rows": len(rows), "touched_rows_moved": True,
           "untouched_bits_kept": list(digests), "profiled": profiled}
    del model, ost, batches, touched, rows, rows_before
    gc.collect()
    torch.cuda.empty_cache()
    return rec, captured


def bag_bwd_phase(label: str, ids, grad, V: int, reps: int = 10) -> dict:
    """K4's backward on the call captured in a training step: the bag
    gradient scaled to unit RMS (the backward is linear in it; a loss
    averaged over 65,536 examples leaves it ~1e-5), against its plain
    version run on the fp64 gradient (1e-4, compared a block of rows at a
    time: the fp32 plain version's atomic sums of up to ~53k slots stray
    by most of the tolerance by themselves where a row's terms cancel, so
    its distance is only recorded), one launch a call and bit-equal over
    two calls; timed one call at a time (``kernel_ms_single``) and in batches
    of 3 (``kernel_ms``), split into the wrapper's zero fill, its sort and
    the two kernels, beside one ``index_add_`` into a zeroed ``[V, D]`` from
    slot gradients gathered before the timing (the yardstick) and the
    bytes bound: the dense gradient written once, the ids and the bag
    gradients read once."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.embedding_bag import ops
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_backward_ref
    N, L = ids.shape
    D = grad.shape[1] * grad.shape[0] // N
    grad.div_(grad.square().mean().sqrt())          # unit RMS, in place
    before = kernels.LAUNCHES.get("embedding_bag_bwd", 0)
    got = ops.embedding_bag_backward(ids, grad, V)
    again = ops.embedding_bag_backward(ids, grad, V)
    torch.cuda.synchronize()
    require(kernels.LAUNCHES.get("embedding_bag_bwd", 0) == before + 2,
            f"{label}: {kernels.LAUNCHES.get('embedding_bag_bwd', 0) - before}"
            f" launches for two calls")
    require(torch.equal(got, again),
            f"{label}: the gradients differ between two calls")
    del again
    block = 1 << 21

    def distance(want) -> dict:
        """max |got - want|, its largest share of the tolerance (|a - b|
        <= tol + tol*|b|) and max |want|, a block of rows at a time."""
        out = {"max_abs_err": 0.0, "worst_of_tol": 0.0, "want_max_abs": 0.0}
        for a in range(0, V, block):
            g, w = got[a:a + block].double(), want[a:a + block].double()
            d = (g - w).abs()
            for k, x in (("max_abs_err", d),
                         ("worst_of_tol", d / (BAG_TOL + BAG_TOL * w.abs())),
                         ("want_max_abs", w.abs())):
                out[k] = max(out[k], float(x.max()))
        return out

    rec = {**distance(embedding_bag_backward_ref(ids, grad.double(), V)),
           "tol": BAG_TOL}
    require(rec["worst_of_tol"] <= 1.0 and bool(torch.isfinite(got).all()),
            f"{label}: kernel differs from the plain version on the fp64 "
            f"gradient (max abs err {rec['max_abs_err']}, "
            f"{rec['worst_of_tol']:.3f} of the tolerance)")
    require(rec["want_max_abs"] >= 10 * BAG_TOL,
            f"{label}: the largest plain gradient {rec['want_max_abs']} is "
            f"below 10x the tolerance")
    # the fp32 plain version's distance, recorded (no gate: see above)
    rec["plain_fp32"] = distance(embedding_bag_backward_ref(ids, grad, V))
    del got
    flat = ids.reshape(-1)
    valid = (flat >= 0) & (flat < V)
    _, counts = torch.unique(flat[valid], return_counts=True)
    slots = int(valid.sum())
    nbytes = V * D * 4 + 4 * ids.numel() + 4 * N * D
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = slots * D / SCALAR_OPS_PER_S * 1e3

    def kernel():
        return ops.embedding_bag_backward(ids, grad, V)

    kernel_ms = cuda_ms(kernel, reps, batch=3)
    single_ms = cuda_ms(kernel, reps)
    # the split: the zero fill, the sort, the two kernels alone
    keys = torch.where(valid, flat, V)
    zero_ms = cuda_ms(lambda: torch.zeros((V, D), device=ids.device), reps)
    sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), reps)
    skeys, order = torch.sort(keys, stable=True)
    out = torch.zeros((V, D), device=ids.device)
    partial = torch.empty((2 * (-(-ids.numel() // ops.BWD_CHUNK)), D),
                          device=ids.device)
    fn = ops._bwd_fn()
    stream = torch.cuda.current_stream().cuda_stream
    args = (skeys.data_ptr(), order.data_ptr(), grad.data_ptr(),
            out.data_ptr(), partial.data_ptr(), ids.numel(), L, V, D,
            N // grad.shape[0], grad.stride(0), ops.BWD_CHUNK, stream)
    kernels_ms = cuda_ms(lambda: require(fn(*args) == 0,
                                         f"{label}: launch failed"), reps)
    del out, partial, skeys, order, keys
    plain_ms = cuda_ms(lambda: embedding_bag_backward_ref(ids, grad, V),
                       max(3, reps // 4), warmup=1)
    # yardstick: one index_add_ into a zeroed [V, D], the slot rows and
    # their bags' gradients gathered before the timing (not in the port)
    lib_slots = valid.nonzero().squeeze(1)
    lib_rows = flat[lib_slots].long()
    lib_src = grad.reshape(N, D).index_select(0, lib_slots // L)
    library_ms = cuda_ms(lambda: torch.zeros(
        (V, D), device=ids.device).index_add_(0, lib_rows, lib_src), reps)
    del lib_slots, lib_rows, lib_src
    rec.update({"phase": "kernel", "name": "embedding_bag_bwd",
                "input": label, "route": "cuda",
                "shape": {"N": N, "L": L, "V": V, "D": D,
                          "G": N // grad.shape[0],
                          "row_stride": grad.stride(0)},
                "valid_slots": slots, "distinct_rows": int(counts.numel()),
                "hottest_row_slots": int(counts.max()),
                "chunk": ops.BWD_CHUNK, "bit_equal_two_calls": True,
                "bytes": nbytes, "kernel_ms": kernel_ms,
                "kernel_ms_single": single_ms,
                "split_ms": {"zero_fill": zero_ms, "sort": sort_ms,
                             "kernels": kernels_ms},
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(bound_ms, bound_ops_ms),
                "bound_by": ("bytes" if bound_ms >= bound_ops_ms
                             else "operations"),
                "pct_of_bound": 100 * max(bound_ms, bound_ops_ms)
                / kernel_ms,
                "kernel_over_library": kernel_ms / library_ms})
    return rec


def recsys_train_check() -> dict:
    """Wide & Deep ``SMOKE`` in float32 (TF32 off), step 0 from the same
    weights on cuda and cpu: the loss, the global gradient norm and the
    table's gradient agree (``RECSYS_RTOL`` / ``RECSYS_ATOL``), with one K4
    forward and one K4 backward launch on the card; then two AdamW steps
    on those gradients on the card, in pieces of ``RECSYS_CHECK_PIECE``
    elements and on whole tensors: the same bits."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import wide_deep as wd
    from repro_torch.models import recsys
    from repro_torch.train import optimizer as opt
    require(not torch.backends.cuda.matmul.allow_tf32,
            "recsys_train check: TF32 matmuls are on")
    cfg, spec = wd.SMOKE, wd.SMOKE_SHAPES["train_batch"]
    t0 = time.perf_counter()
    on_card = recsys.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    on_host = recsys.WideDeep(cfg, "cpu")
    on_host.load_state_dict(on_card.state_dict())
    got = {}
    for dev, m in (("cuda", on_card), ("cpu", on_host)):
        kernels.reset_launches()
        params = [p.requires_grad_() for p in m.parameters()]
        loss, _ = recsys.loss_fn(m, wd.make_batch(cfg, spec, SEED, dev), cfg)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        got[dev] = (float(loss.detach()), float(opt.global_norm(grads)),
                    grads, dict(kernels.LAUNCHES))
        for p in params:
            p.requires_grad_(False)
    want = {"embedding_bag": 1, "embedding_bag.vec": 1,
            "embedding_bag_bwd": 1}
    require(got["cuda"][3] == want and got["cpu"][3] == {},
            f"recsys_train check: launches {got['cuda'][3]} on cuda, "
            f"{got['cpu'][3]} on cpu")
    errs = {}
    for i, what in enumerate(("loss", "grad_norm")):
        a, b = got["cuda"][i], got["cpu"][i]
        errs[what] = abs(a - b)
        require(abs(a - b) <= RECSYS_ATOL + RECSYS_RTOL * abs(b),
                f"recsys_train check: step 0 {what} {a} on cuda, {b} on cpu")
    table_grad = got["cuda"][2][0].cpu()
    errs["table_grad"] = float((table_grad - got["cpu"][2][0]).abs().max())
    require(torch.allclose(table_grad, got["cpu"][2][0], rtol=RECSYS_RTOL,
                           atol=RECSYS_ATOL),
            f"recsys_train check: the table's gradient differs (max abs err "
            f"{errs['table_grad']})")
    # the bounded update against whole tensors, on the card
    acfg = opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    runs = []
    for piece in (RECSYS_CHECK_PIECE, None):
        ps = [p.detach().clone() for p in on_card.parameters()]
        st = opt.init(acfg, ps)
        for _ in range(2):
            opt.update(acfg, got["cuda"][2], st, ps, piece=piece)
        runs.append(ps + st.mu + st.nu)
    require(all(torch.equal(a, b) for a, b in zip(*runs)),
            "recsys_train check: the update in pieces differs from the "
            "update of whole tensors")
    return {"phase": "check", "model": cfg.name, "what": "recsys_train",
            "dtype": str(cfg.dtype), "loss_cuda": got["cuda"][0],
            "loss_cpu": got["cpu"][0], "abs_err": errs,
            "rtol": RECSYS_RTOL, "atol": RECSYS_ATOL,
            "update_piece": RECSYS_CHECK_PIECE,
            "bounded_update_bit_equal": True, "launches": got["cuda"][3],
            "seconds": time.perf_counter() - t0}


# --------------------------------------------------------------------- gnn

def sampled_graph():
    """GAT's ``minibatch_lg`` source, as ``examples/gnn_sampling.py``
    builds it at the bundle's size: a power-law graph of 232,965 nodes,
    seeded float32 features, and labels that carry a signal (the argmax of
    the first 41 features)."""
    import numpy as np
    from repro_torch.graphdb.sampler import random_power_law_graph
    t0 = time.perf_counter()
    csr = random_power_law_graph(SAMPLED["n_nodes"],
                                 avg_degree=SAMPLED["avg_degree"], seed=SEED)
    rng = np.random.default_rng(SEED)
    feats = rng.standard_normal((SAMPLED["n_nodes"], SAMPLED["d_feat"]),
                                dtype=np.float32)
    labels = feats[:, :SAMPLED["n_classes"]].argmax(axis=1).astype(np.int32)
    return {"csr": csr, "feats": feats, "labels": labels, "rng": rng,
            "build_s": time.perf_counter() - t0,
            "csr_edges": int(csr.indptr[-1])}


def sample_batch(src: dict, max_nodes: int, max_edges: int) -> tuple:
    """One fresh fanout sample as a host batch: the sampler's padded
    arrays, self-loops in the free edge slots, the sampled nodes' features
    and labels (zeros and -1 past them).  Returns (batch, n_nodes,
    n_edges, self_loops)."""
    import numpy as np
    from repro_torch.graphdb.sampler import sample_fanout
    seeds = src["rng"].choice(SAMPLED["n_nodes"], size=SAMPLED["seeds"],
                              replace=False)
    nodes, edges, n_n, n_e = sample_fanout(
        src["csr"], seeds, fanouts=SAMPLED["fanouts"], rng=src["rng"],
        max_nodes=max_nodes, max_edges=max_edges)
    self_n = min(n_n, max_edges - n_e)
    edges[0, n_e:n_e + self_n] = np.arange(self_n)
    edges[1, n_e:n_e + self_n] = np.arange(self_n)
    feat = np.zeros((max_nodes, SAMPLED["d_feat"]), np.float32)
    labels = np.full(max_nodes, -1, np.int32)
    feat[:n_n] = src["feats"][nodes[:n_n]]
    labels[:n_n] = src["labels"][nodes[:n_n]]
    return ({"node_feat": feat, "edges": edges, "labels": labels}, n_n, n_e,
            self_n)


def to_card(batch: dict) -> tuple[dict, float]:
    """A host batch on the card, and the copy's host-clock ms."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {k: torch.as_tensor(v).to("cuda") for k, v in batch.items()}
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def gnn_run(arch: str, shape: str, sampled: dict | None) -> dict:
    """One architecture on one shape through its full-size bundle: weights
    from a seeded generator on the card, the reference's AdamW, one
    warm-up and ``GNN_STEPS`` timed train steps (CUDA events).  On
    ``molecule`` the first forward loss is held against the port on the
    CPU (the weights copied there before the first step)."""
    import importlib
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.train import optimizer as opt
    bundle = importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_")).bundle()
    cfg, mod = bundle.model_cfg(shape), bundle.module
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = mod.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED), device="cuda")
    ost = opt.init(bundle.adam_cfg(), model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    on_host = None
    if shape == "molecule":
        on_host = type(model)(cfg, "cpu")
        on_host.load_state_dict(model.state_dict())
    dims = bundle.shapes[shape].dims
    sample_ms, copy_ms, counts = [], [], []
    if sampled is None:
        host = bundle.host_batch(shape, SEED)
        batch, ms = to_card(host)
        copy_ms.append(ms)
    init_s = time.perf_counter() - t0
    step = bundle.make_step(shape)
    kernels.reset_launches()
    times, losses, norms, moved = [], [], [], []
    for i in range(1 + GNN_STEPS):
        if sampled is not None:
            t = time.perf_counter()
            host, n_n, n_e, loops = sample_batch(
                sampled, bundle._pad512(dims["n_nodes"]),
                bundle._pad512(dims["n_edges"]))
            sample_ms.append((time.perf_counter() - t) * 1e3)
            require(n_n <= dims["n_nodes"] and n_e <= dims["n_edges"],
                    f"gnn {arch} {shape}: a sample of {n_n} nodes and "
                    f"{n_e} edges exceeds the shape")
            counts.append({"n_nodes": n_n, "n_edges": n_e,
                           "self_loops": loops})
            batch, ms = to_card(host)
            copy_ms.append(ms)
        before = [p.detach().clone() for p in model.parameters()]
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        model, ost, m = step(model, ost, batch)
        b.record()
        b.synchronize()
        if i:
            times.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        moved.append(sum(not torch.equal(p.detach(), q)
                         for p, q in zip(model.parameters(), before)))
        del before
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"gnn {arch} {shape}: non-finite loss {losses} or grad norm "
            f"{norms}")
    require(all(n > 0 for n in moved),
            f"gnn {arch} {shape}: a step left every parameter as it was "
            f"({moved} tensors moved)")
    flops = bundle.model_flops(shape)
    med = statistics.median(times)
    rec = {"phase": "gnn", "arch": arch, "shape": shape,
           "dtype": str(cfg.dtype), "params": n_params,
           "n_nodes": int(batch["labels" if "labels" in batch
                                else "graph_ids"].shape[0]),
           "n_edges": int(batch["edges"].shape[1]),
           "steps": GNN_STEPS, "step_ms": times, "step_ms_median": med,
           "step_ms_p90": float(np.percentile(times, 90)),
           "loss": losses, "grad_norm": norms, "tensors_moved": moved,
           "max_memory_allocated": peak,
           "reference_model_flops": flops,
           "tflops_per_s": flops / (med * 1e-3) / 1e12,
           "init_s": init_s, "launches": launches,
           "reduced": ([GNN_REDUCED["sampled_degree"]]
                       if sampled is not None else [])}
    if sampled is not None:
        rec.update(sampled=counts, host_sample_ms=sample_ms,
                   host_to_device_ms=copy_ms)
    else:
        rec["host_to_device_ms"] = copy_ms[0]
    if on_host is not None:
        t = time.perf_counter()
        with torch.no_grad():
            want = float(mod.loss_fn(on_host, {
                k: torch.as_tensor(v) for k, v in host.items()}, cfg)[0])
        err = abs(losses[0] - want)
        require(err <= GNN_ATOL + GNN_RTOL * abs(want),
                f"gnn {arch} {shape}: first loss {losses[0]} on cuda, "
                f"{want} on cpu")
        rec["cpu_check"] = {"loss_cuda": losses[0], "loss_cpu": want,
                            "abs_err": err, "rtol": GNN_RTOL,
                            "atol": GNN_ATOL,
                            "cpu_s": time.perf_counter() - t}
        rec["profiled"] = profile_step(step, model, ost, batch)
    del model, ost, batch, on_host
    return rec


def gnn_path() -> dict:
    """Every run of ``GNN_RUNS`` (TF32 off), each emitted as it ends;
    returns a summary record with the cuts."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    src = sampled_graph()
    graph = {"n_nodes": SAMPLED["n_nodes"], "csr_edges": src["csr_edges"],
             "avg_degree": SAMPLED["avg_degree"], "build_s": src["build_s"]}
    recs = []
    for arch, shapes in GNN_RUNS.items():
        for shape in shapes:
            use = src if (arch, shape) == ("gat-cora", "minibatch_lg") \
                else None
            recs.append(gnn_run(arch, shape, use))
            emit(recs[-1])
    del src
    recs.append(equiformer_lg_path())
    emit(recs[-1])
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "phase": "gnn", "runs": len(recs),
        "reduced": list(GNN_REDUCED.values()) + recs[-1]["reduced"],
        "sampled_graph": graph,
        "summary": {f"{r['arch']}/{r['shape']}": {
            "step_ms_median": r["step_ms_median"],
            "max_memory_allocated": r["max_memory_allocated"],
            "tflops_per_s": r["tflops_per_s"]} for r in recs},
        "seconds": time.perf_counter() - t0}


def equiformer_lg_path() -> dict:
    """EquiformerV2 on ``minibatch_lg`` at published widths through
    ``node_chunks``: the bundle's batch with its edges binned into
    ``EQ_LG_CHUNKS`` destination ranges (``bin_edges``; every real edge
    kept), one train step at 1 and at 2 layers for the bytes a layer adds
    at peak, then the deepest L of 12 whose predicted peak stays under
    ``EQ_LG_PEAK_BYTES``: one warm-up and ``EQ_LG_STEPS`` timed steps (CUDA
    events), every loss and gradient norm finite, every step moving the
    weights, the peak under the cap, one profiled step."""
    import numpy as np
    import torch
    from repro_torch.configs import equiformer_v2 as eq2_cfg
    from repro_torch.models.gnn import equiformer_v2 as eq2
    from repro_torch.train import optimizer as opt
    t_phase = time.perf_counter()
    bundle, shape = eq2_cfg.bundle(), "minibatch_lg"
    host = bundle.host_batch(shape, SEED)
    N = host["labels"].shape[0]
    t0 = time.perf_counter()
    edges = eq2.bin_edges(host["edges"], N, EQ_LG_CHUNKS)
    bin_ms = (time.perf_counter() - t0) * 1e3
    real = host["edges"][:, (host["edges"] >= 0).all(0)]
    kept = edges[:, (edges >= 0).all(0)]
    require(kept.shape == real.shape and np.array_equal(
        kept[:, np.lexsort(kept)], real[:, np.lexsort(real)]),
        f"gnn equiformer-v2 {shape}: binning kept {kept.shape[1]} of "
        f"{real.shape[1]} edges")
    batch, copy_ms = to_card(dict(host, edges=edges))
    E = edges.shape[1]
    base = dataclasses.replace(bundle.model_cfg(shape),
                               node_chunks=EQ_LG_CHUNKS)
    require(eq2._path(base, N, E) == ("node", EQ_LG_CHUNKS),
            f"gnn equiformer-v2 {shape}: node_chunks not taken")

    def train(L: int, steps: int, profile: bool = False) -> dict:
        cfg = dataclasses.replace(base, n_layers=L)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = eq2.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        ost = opt.init(bundle.adam_cfg(), model.parameters())
        step = eq2.make_train_step(cfg, bundle.adam_cfg())
        out = {"ms": [], "loss": [], "grad_norm": [], "moved": []}
        for _ in range(steps):
            before = [p.detach().clone() for p in model.parameters()]
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model, ost, m = step(model, ost, batch)
            b.record()
            b.synchronize()
            out["ms"].append(a.elapsed_time(b))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["moved"].append(sum(not torch.equal(p.detach(), q) for p, q
                                    in zip(model.parameters(), before)))
            del before
        out["peak"] = torch.cuda.max_memory_allocated()
        if profile:
            out["profiled"] = profile_step(step, model, ost, batch)
        del model, ost, step
        return out

    probe = {L: train(L, 1)["peak"] for L in (1, 2)}
    layer_bytes = probe[2] - probe[1]
    require(layer_bytes > 0, f"gnn equiformer-v2 {shape}: probe peaks "
                             f"{probe}")
    L = min(12, int((EQ_LG_PEAK_BYTES - (probe[1] - layer_bytes))
                    // layer_bytes))
    require(L >= 1, f"gnn equiformer-v2 {shape}: one layer needs "
                    f"{probe[1]} bytes")
    run = train(L, 1 + EQ_LG_STEPS, profile=True)
    times = run["ms"][1:]
    require(all(np.isfinite(run["loss"])) and all(np.isfinite(
        run["grad_norm"])), f"gnn equiformer-v2 {shape}: non-finite loss "
        f"{run['loss']} or grad norm {run['grad_norm']}")
    require(all(n > 0 for n in run["moved"]),
            f"gnn equiformer-v2 {shape}: a step left every parameter as it "
            f"was ({run['moved']} tensors moved)")
    require(run["peak"] <= EQ_LG_PEAK_BYTES,
            f"gnn equiformer-v2 {shape}: peak {run['peak']} bytes at {L} "
            f"layers")
    cfg = dataclasses.replace(base, n_layers=L)
    flops = bundle._flops_fn(cfg, bundle.shapes[shape])
    med = statistics.median(times)
    reduced = [] if L == 12 else [
        f"equiformer-v2 on minibatch_lg: {L} of 12 layers (a layer adds "
        f"{layer_bytes} bytes at peak; {probe[1]} at one layer; the cap is "
        f"{EQ_LG_PEAK_BYTES:.0f})"]
    return {"phase": "gnn", "arch": "equiformer-v2", "shape": shape,
            "path": "node_chunks", "node_chunks": EQ_LG_CHUNKS,
            "dtype": str(cfg.dtype), "layers": L, "n_nodes": N,
            "n_edges": E, "real_edges": int(real.shape[1]),
            "bin_capacity": E // EQ_LG_CHUNKS, "host_bin_ms": bin_ms,
            "host_to_device_ms": copy_ms, "probe_peaks": probe,
            "layer_bytes": layer_bytes, "steps": EQ_LG_STEPS,
            "step_ms": times, "step_ms_median": med,
            "warmup_ms": run["ms"][0], "loss": run["loss"],
            "grad_norm": run["grad_norm"], "tensors_moved": run["moved"],
            "max_memory_allocated": run["peak"],
            "reference_model_flops": flops,
            "tflops_per_s": flops / (med * 1e-3) / 1e12,
            "profiled": run["profiled"], "reduced": reduced,
            "seconds": time.perf_counter() - t_phase}


def equiformer_paths_check() -> dict:
    """EquiformerV2 at full widths and 12 layers (float32, TF32 off) on the
    bundle's ``full_graph_sm`` batch binned into ``EQ_CHECK_CHUNKS``
    destination ranges: the loss and the global gradient norm of
    ``edge_chunk = E' / 4`` and of ``node_chunks = 4`` within the GNN
    tolerance of the default path's, on the same weights."""
    import torch
    from repro_torch.configs import equiformer_v2 as eq2_cfg
    from repro_torch.models.gnn import equiformer_v2 as eq2
    from repro_torch.train import optimizer as opt
    t_phase = time.perf_counter()
    bundle, shape = eq2_cfg.bundle(), "full_graph_sm"
    host = bundle.host_batch(shape, SEED)
    N = host["labels"].shape[0]
    host["edges"] = eq2.bin_edges(host["edges"], N, EQ_CHECK_CHUNKS)
    E = host["edges"].shape[1]
    batch, _ = to_card(host)
    cfg0 = bundle.model_cfg(shape)
    model = eq2.init_params(
        cfg0, torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda")
    params = list(model.parameters())
    paths = {}
    for path, kw in (("default", {}),
                     ("edge_chunk", {"edge_chunk": E // EQ_CHECK_CHUNKS}),
                     ("node_chunks", {"node_chunks": EQ_CHECK_CHUNKS})):
        cfg = dataclasses.replace(cfg0, **kw)
        require(eq2._path(cfg, N, E)[0] == path.split("_")[0],
                f"equiformer check: {kw} does not take {path}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, _ = eq2.loss_fn(model, batch, cfg)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        norm = opt.global_norm([g for g in grads if g is not None])
        paths[path] = {"loss": loss.item(), "grad_norm": norm.item(),
                       "ms": (time.perf_counter() - t0) * 1e3,
                       "max_memory_allocated":
                       torch.cuda.max_memory_allocated()}
        del loss, grads
    want = paths["default"]
    for path in ("edge_chunk", "node_chunks"):
        for key in ("loss", "grad_norm"):
            err = abs(paths[path][key] - want[key])
            paths[path][f"{key}_abs_err"] = err
            require(err <= GNN_ATOL + GNN_RTOL * abs(want[key]),
                    f"equiformer check: {path} {key} {paths[path][key]}, "
                    f"default {want[key]}")
    del model, batch
    return {"phase": "check", "what": "equiformer-v2 paths", "shape": shape,
            "layers": cfg0.n_layers, "n_nodes": N, "n_edges": E,
            "chunks": EQ_CHECK_CHUNKS, "rtol": GNN_RTOL, "atol": GNN_ATOL,
            "paths": paths, "seconds": time.perf_counter() - t_phase}


# ---------------------------------------------------------------- lm train

def lm_launches_per_step(cfg) -> dict:
    """Kernel launches one train step makes, from the code: K2's forward
    once a layer and once more in the layer's recompute (remat), its
    backward once a layer; K3's three expert products in the forward and
    the recompute, and two more launches (dx, dw) for each in the
    backward.  The routes follow the compute dtype: float32 runs K2's
    forward on ``rows``, which keeps the log-sum-exp for the backward's
    ``saved`` route, and K3 on ``simt``; bf16 (at head_dim 64 or 128 and
    K3's widths in multiples of 8, as every full LM config) runs K2's
    forward and backward on ``tc`` and K3 on ``tc`` (its backward reading
    the transposed operands in place through the layout flags)."""
    import torch
    fp32 = cfg.dtype == torch.float32
    fa, bwd, gm = (("rows", "saved", "simt") if fp32
                   else ("tc", "tc", "tc"))
    fwd = 1 + int(cfg.remat)
    gmm = (3 * fwd + 6) * cfg.n_layers if cfg.moe else 0
    return {"flash_attention": fwd * cfg.n_layers,
            f"flash_attention.{fa}": fwd * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers,
            f"flash_attention_bwd.{bwd}": cfg.n_layers,
            "grouped_matmul": gmm, f"grouped_matmul.{gm}": gmm}


def lm_launch_gate(label: str, launches: dict, cfg, steps: int) -> None:
    want = {k: v * steps for k, v in lm_launches_per_step(cfg).items() if v}
    require(launches == want,
            f"lm_train {label}: launches {launches}, expected {want} "
            f"({steps} steps)")


def lm_losses(label: str, result, steps: int) -> tuple[list, list]:
    require(result.retries == 0 and not result.preempted,
            f"lm_train {label}: {result.retries} retries, preempted "
            f"{result.preempted}")
    require([s for s, _ in result.metrics_history]
            == list(range(result.final_step - steps + 1,
                          result.final_step + 1)),
            f"lm_train {label}: history steps "
            f"{[s for s, _ in result.metrics_history]}")
    losses = [m["loss"] for _, m in result.metrics_history]
    norms = [m["grad_norm"] for _, m in result.metrics_history]
    import numpy as np
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"lm_train {label}: non-finite loss {losses} or grad norm "
            f"{norms}")
    return losses, norms


def lm_cpu_parity(cfg, model) -> dict:
    """Step 0's loss and global gradient norm at ``LM_CHECK_SHAPE`` on the
    card and on the CPU, on the same weights."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, batch_at
    t0 = time.perf_counter()
    b, s = LM_CHECK_SHAPE
    toks = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=s,
                               global_batch=b), 0)["tokens"]
    host = tfm.Transformer(cfg, "cpu")
    host.load_state_dict(model.state_dict())
    got = {}
    for dev, m in (("cuda", model), ("cpu", host)):
        params = [p.requires_grad_() for p in m.parameters()]
        loss, _ = tfm.loss_fn(m, {"tokens": torch.as_tensor(
            toks, device=dev)}, cfg)
        grads = torch.autograd.grad(loss, params)
        got[dev] = (float(loss.detach()), float(opt.global_norm(grads)))
        for p in params:
            p.requires_grad_(False)
        del grads, loss
    del host
    for i, what in enumerate(("loss", "grad_norm")):
        a, want = got["cuda"][i], got["cpu"][i]
        require(np.isfinite(a) and abs(a - want) <= CHECK_ATOL
                + CHECK_RTOL * abs(want),
                f"lm_train {cfg.name}: step 0 {what} {a} on cuda, {want} "
                f"on cpu")
    return {"loss_cuda": got["cuda"][0], "loss_cpu": got["cpu"][0],
            "grad_norm_cuda": got["cuda"][1], "grad_norm_cpu": got["cpu"][1],
            "shape": list(LM_CHECK_SHAPE), "rtol": CHECK_RTOL,
            "atol": CHECK_ATOL, "seconds": time.perf_counter() - t0}


def lm_timed_steps(cfg, model, batch: int, seq: int) -> tuple[dict, dict]:
    """One warm-up train step that captures layer 0's kernel operands
    (attention: q, k, v and its output gradient; MoE: the w1 and w2
    products with theirs, through gradient hooks), ``LM_TIMED_STEPS``
    steps timed with CUDA events, and one profiled step."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.data import DataConfig, batch_at
    acfg = opt.AdamWConfig(total_steps=LM_TIMED_STEPS + 3)
    ost = opt.init(acfg, model.parameters())
    step = tfm.make_train_step(cfg, acfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch)

    def on_card(i):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in batch_at(dcfg, i).items()}

    with layer0_captured({}) as captured:
        model, ost, _ = step(model, ost, on_card(0))
        torch.cuda.synchronize()
    times = []
    for i in range(1, 1 + LM_TIMED_STEPS):
        b = on_card(i)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        model, ost, m = step(model, ost, b)
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
        require(bool(torch.isfinite(m["loss"])), "lm_train: timed loss")
    med = statistics.median(times)
    flops = cfg.train_flops(batch, seq)
    rec = {"step_ms": times, "step_ms_median": med,
           "step_ms_p90": float(np.percentile(times, 90)),
           "train_flops": flops,
           "tflops_per_s": flops / (med * 1e-3) / 1e12,
           "profiled": profile_step(step, model, ost, on_card(99))}
    return rec, captured


def lm_run(preset: str, batch: int, seq: int, steps: int,
           resume: int | None) -> tuple[dict, dict]:
    """One preset through ``train`` (and, with ``resume``, the resumed and
    the preempted runs); returns its record and the captured operands."""
    import shutil
    import tempfile
    import torch
    from repro_torch import kernels
    from repro_torch.launch.train import PRESETS, train
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import DataConfig, batch_at
    cfg = PRESETS[preset]
    gc.collect()
    torch.cuda.empty_cache()
    root = Path(tempfile.mkdtemp(prefix=f"lm_train_{preset}_"))
    kw = dict(batch=batch, seq=seq, ckpt_dir=str(root / "ckpt"),
              log_fn=lambda *a: None, log_every=1)
    rec = {"phase": "lm_train", "preset": preset, "dtype": str(cfg.dtype),
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "params": cfg.param_count(),
           "batch": batch, "seq": seq, "tokens_per_step": batch * seq,
           "launches_per_step": lm_launches_per_step(cfg)}
    try:
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = train(preset, steps, **kw)
        torch.cuda.synchronize()
        rec["train_s"] = time.perf_counter() - t0
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        rec["launches"] = dict(kernels.LAUNCHES)
        require(first.final_step == steps,
                f"lm_train {preset}: stopped at {first.final_step}")
        losses, norms = lm_losses(preset, first, steps)
        lm_launch_gate(preset, rec["launches"], cfg, steps)
        head, tail = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
        require(tail < head, f"lm_train {preset}: the last 5 losses average "
                             f"{tail}, the first 5 {head}")
        rec.update(loss=losses, grad_norm=norms, loss_first5=head,
                   loss_last5=tail)
        gc.collect()
        torch.cuda.empty_cache()
        model = tfm.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        if resume:
            # the card's loss of batch `steps` on the restored weights
            fresh = tfm.init_params(
                cfg, torch.Generator(device="cuda").manual_seed(SEED + 1),
                device="cuda")
            ost = opt.init(opt.AdamWConfig(), fresh.parameters())
            ck = CheckpointManager(kw["ckpt_dir"], keep=2, async_write=False)
            t = time.perf_counter()
            at, rec["elastic"] = elastic_resume(cfg, ck, (fresh, ost))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t
            require(at == steps, f"lm_train {preset}: latest checkpoint "
                                 f"{at}, expected {steps}")
            dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch)
            with torch.no_grad():
                want = float(tfm.loss_fn(fresh, {
                    k: torch.as_tensor(v, device="cuda")
                    for k, v in batch_at(dcfg, steps).items()}, cfg)[0])
            t = time.perf_counter()
            CheckpointManager(str(root / "timed"), keep=1,
                              async_write=False).save(steps, (fresh, ost))
            save_s = time.perf_counter() - t
            del fresh, ost
            gc.collect()
            torch.cuda.empty_cache()
            kernels.reset_launches()
            again = train(preset, resume, **kw)
            launches = dict(kernels.LAUNCHES)
            require(again.final_step == resume,
                    f"lm_train {preset}: the resumed run stopped at "
                    f"{again.final_step}")
            r_losses, _ = lm_losses(f"{preset} resumed", again,
                                    resume - steps)
            require(again.metrics_history[0][0] == steps + 1
                    and r_losses[0] == want,
                    f"lm_train {preset}: resumed at "
                    f"{again.metrics_history[0][0] - 1} with loss "
                    f"{r_losses[0]}; step {steps}'s batch on the restored "
                    f"weights gives {want}")
            lm_launch_gate(f"{preset} resumed", launches, cfg,
                           resume - steps)
            rec["resumed_launches"] = launches
            kernels.reset_launches()
            stop = train(preset, resume + 10, should_preempt=lambda: True,
                         **kw)
            require(stop.preempted and stop.final_step == resume
                    and not kernels.LAUNCHES,
                    f"lm_train {preset}: preempted {stop.preempted} at "
                    f"{stop.final_step}")
            rec.update(resumed={"from": steps, "final_step":
                                again.final_step, "loss": r_losses,
                                "first_loss": r_losses[0],
                                "restored_loss": want},
                       preempted_at=stop.final_step,
                       checkpoint={"restore_s": restore_s,
                                   "save_s": save_s,
                                   "bytes": sum(
                                       f.stat().st_size for f in
                                       (root / "timed").rglob("*.npz"))})
        rec["cpu_check"] = lm_cpu_parity(cfg, model)
        timed, captured = lm_timed_steps(cfg, model, batch, seq)
        rec.update(timed)
        del model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec, captured


def elastic_resume(cfg, ckpt, like) -> tuple[int, dict]:
    """``like`` restored from ``ckpt``'s newest checkpoint through
    ``train/elastic.py::elastic_restart`` onto ``make_host_mesh()`` (a
    (1, 1) ``DeviceMesh`` over a one-rank NCCL group, made here and
    destroyed after where none exists) with the LM bundle's training
    shardings: on one device the state keeps its objects, in place.
    Returns the step and a record."""
    import torch.distributed as dist
    from repro_torch.configs.base import mesh_axes
    from repro_torch.configs.lm_common import LMBundle
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.elastic import elastic_restart
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        mesh = make_host_mesh()
        bundle = LMBundle(cfg)
        step, placed = elastic_restart(
            ckpt, like, mesh,
            lambda m: bundle.shardings(m, "train_4k")[0][:2])
        require(placed is like, "elastic: a one-device mesh must keep the "
                                "state's objects")
        return step, {"mesh": mesh_axes(mesh),
                      "device_type": mesh.device_type, "step": step}
    finally:
        if made:
            dist.destroy_process_group()


def lm_train_path() -> tuple[list[dict], dict]:
    """Both presets' runs (TF32 off), each emitted as it ends; returns the
    records and the operands captured for the backward kernel phases."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs, captured = [], {}
    for preset, (batch, seq, steps) in LM_RUNS.items():
        rec, calls = lm_run(preset, batch, seq, steps,
                            LM_RESUME_STEPS.get(preset))
        emit(rec)
        recs.append(rec)
        captured.update({f"{preset}_{k}": v for k, v in calls.items()})
    return recs, captured


def _bwd_bound(nbytes: int, ops: float, bf16: bool) -> tuple[float, str]:
    rate = BF16_OPS_PER_S if bf16 else SCALAR_OPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _device_ms_by_kernel(fn, calls: int, keys: tuple) -> dict:
    """Device ms a launch of each kernel whose name holds one of ``keys``,
    from ``torch.profiler`` over ``calls`` calls of ``fn`` (after one
    warm-up): each kernel's device time over the launches the trace
    recorded (a trace may drop some), with those counts and the names of
    every other device kernel the calls ran.  A trace missing one of the
    kernels is taken again, as in ``profile_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = {key: 0.0 for key in keys}
        count = {key: 0 for key in keys}
        other = []
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            key = next((k for k in keys if k in ev.key), None)
            if key is None:
                other.append(ev.key[:80])
            else:
                total[key] += ev.self_device_time_total / 1e3
                count[key] += ev.count
        if all(count.values()):
            return {"ms": {k: total[k] / count[k] for k in keys},
                    "launches_traced": count, "calls": calls,
                    "other_kernels": other}
    raise SmokeFailure(f"profiler recorded no launch of one of {keys} in "
                       f"{PROFILE_ATTEMPTS} traces")


def attention_bwd_phase(label: str, q, k, v, q_start, kv_len, kw: dict,
                        dout, tol: float, reps: int = REPS) -> dict:
    """K2's backward kernels against autograd through the plain version on
    one captured call: the Function's gradients (forward on its route,
    backward counted once, on the route ``bwd_route`` names, as the
    training path takes it: ``tc`` for bf16 the tensor cores take,
    ``saved`` for fp32 on ``rows``, whose forward keeps its log-sum-exp),
    on ``saved`` also the ``recompute`` route's gradients, the bound (10 hd
    flops an admissible pair: the five products), the plain backward and
    SDPA's causal backward; the route timed as the training path calls it
    (``saved`` with the forward's output and log-sum-exp; then
    ``recompute`` too), its gradients equal bit for bit over two calls,
    and on ``tc`` the device time of its statistics pass apart from its dq
    and dk/dv kernels (``torch.profiler``).  The fp32 route is gated at
    ``ATTN_BWD_LIMIT_MS``, ``tc`` at ``ATTN_BWD_BF16_LIMIT_MS``.  The
    backward is linear in ``dout``; the captured one (of a loss averaged
    over every token) is scaled to unit RMS, so the gradients are O(1) and
    the tolerance is far below them."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import (
        bwd_route, flash_attention, flash_attention_bwd, flash_attention_lse,
        route, saves_lse)
    from repro_torch.kernels.flash_attention.ref import (flash_attention_ref,
                                                         per_batch)
    B, Sq, Kh, G, hd = q.shape
    Skv = k.shape[1]
    dout = _unit_rms(dout)
    starts = per_batch(q_start, B, q.device)
    lens = per_batch(kv_len, B, q.device)
    saved = {}
    if saves_lse(q, k, v):
        out, lse = flash_attention_lse(q, k, v, starts, lens, **kw)
        saved = {"out": out, "lse": lse}
    which = bwd_route(q, k, v)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = {n: kernels.LAUNCHES.get(n, 0) for n in (
        "flash_attention_bwd", "flash_attention_bwd.tc",
        "flash_attention_bwd.saved", "flash_attention_bwd.recompute")}
    out_fn = flash_attention(*leaves, starts, lens, **kw)
    got = torch.autograd.grad(out_fn, leaves, dout)
    torch.cuda.synchronize()
    for n, c in before.items():
        want_n = c + (1 if n == "flash_attention_bwd"
                      or n == f"flash_attention_bwd.{which}" else 0)
        require(kernels.LAUNCHES.get(n, 0) == want_n,
                f"{label}: {n} launched {kernels.LAUNCHES.get(n, 0) - c} "
                f"times, expected {want_n - c}")
    plain = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out_ref = flash_attention_ref(*plain, starts, lens, **kw)
    want = torch.autograd.grad(out_ref, plain, dout, retain_graph=True)
    verdicts = _grad_verdicts(label, "qkv", got, want, tol)
    rec = dict(max(verdicts, key=lambda r: r["worst_of_tol"]))
    call = (q, k, v, dout, starts, lens)
    if saved:
        other = flash_attention_bwd(*call, **kw)
        verdicts += _grad_verdicts(f"{label} recompute", "qkv", other, want,
                                   tol)
    again = [flash_attention_bwd(*call, **kw, **saved) for _ in range(2)]
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(*again)),
            f"{label}: the {which} route's gradients differ between two "
            f"calls")
    del again
    q_pos = starts[:, None] + torch.arange(Sq, device=q.device)
    kv_pos = torch.arange(Skv, device=q.device)
    mask = (kv_pos[None, None] <= q_pos[:, :, None]) & (
        kv_pos[None, None] < lens[:, None, None])
    if kw.get("window") is not None:
        mask &= kv_pos[None, None] > q_pos[:, :, None] - kw["window"]
    pairs = int(mask.sum()) * Kh * G
    esize = q.element_size()
    # q, dout and dq; k, v, dk and dv over the keys in use
    nbytes = esize * (3 * q.numel() + 4 * int(lens.sum()) * Kh * hd)
    bound_ms, bound_by = _bwd_bound(nbytes, 10 * hd * pairs,
                                    q.dtype == torch.bfloat16)
    kernel_ms = cuda_ms(lambda: flash_attention_bwd(*call, **kw, **saved),
                        reps, batch=ATTN_BATCH, queued=True)
    recompute_ms = (cuda_ms(lambda: flash_attention_bwd(*call, **kw), reps,
                            batch=ATTN_BATCH, queued=True)
                    if saved else None)
    stages = None
    if which == "tc":
        split = _device_ms_by_kernel(
            lambda: flash_attention_bwd(*call, **kw), ATTN_BATCH,
            ("attn_bwd_tc_stats", "attn_bwd_tc_dq", "attn_bwd_tc_dkv"))
        ms = split["ms"]
        stages = {"stats_ms": ms["attn_bwd_tc_stats"],
                  "dq_ms": ms["attn_bwd_tc_dq"],
                  "dkv_ms": ms["attn_bwd_tc_dkv"],
                  "grads_ms": ms["attn_bwd_tc_dq"] + ms["attn_bwd_tc_dkv"],
                  "launches_traced": split["launches_traced"],
                  "calls": split["calls"],
                  "other_kernels": split["other_kernels"]}
    plain_ms = cuda_ms(lambda: torch.autograd.grad(
        out_ref, plain, dout, retain_graph=True), max(3, reps // 4),
        warmup=1)
    # yardstick: SDPA's causal backward on the same inputs ([B, H, S, hd])
    library_ms = None
    if (int(starts.min()) == int(starts.max()) == 0 and Sq == Skv
            and int(lens.min()) == Skv and kw.get("window") is None
            and kw.get("softcap") is None):
        heads = [t.detach().permute(0, 2, 3, 1, 4).reshape(B, Kh * G, Sq, hd)
                 .requires_grad_() for t in (q,)] + [
            t.detach().permute(0, 2, 1, 3).contiguous().requires_grad_()
            for t in (k, v)]
        d_heads = dout.permute(0, 2, 3, 1, 4).reshape(B, Kh * G, Sq, hd)
        out_lib = F.scaled_dot_product_attention(*heads, is_causal=True,
                                                 enable_gqa=G > 1)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out_lib, heads, d_heads, retain_graph=True), reps,
            batch=ATTN_BATCH, queued=True)
    limit_ms = {"saved": ATTN_BWD_LIMIT_MS,
                "tc": ATTN_BWD_BF16_LIMIT_MS}.get(which)
    if limit_ms is not None:
        require(kernel_ms <= limit_ms,
                f"{label}: {which} backward {kernel_ms:.4g} ms > "
                f"{limit_ms} ms")
    rec.update({"phase": "kernel", "name": "flash_attention_bwd",
                "input": label, "forward_route": route(q, k, v),
                "route": which,
                "shape": {"B": B, "Sq": Sq, "Skv": Skv, "Kh": Kh, "G": G,
                          "hd": hd},
                "dtype": str(q.dtype), "admissible_pairs": pairs,
                "bytes": nbytes, "verdicts": verdicts,
                "bit_equal_two_calls": True,
                "kernel_ms": kernel_ms,
                "kernel_ms_single": cuda_ms(
                    lambda: flash_attention_bwd(*call, **kw, **saved), reps),
                "kernel_ms_recompute": recompute_ms,
                "stages": stages, "limit_ms": limit_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "pct_of_bound": 100 * bound_ms / kernel_ms,
                "kernel_over_library": (kernel_ms / library_ms
                                        if library_ms else None)})
    return rec


def gmm_bwd_phase(label: str, x, w, dy, tol: float = GMM_FP32_TOL,
                  reps: int = REPS) -> dict:
    """K3's backward on one captured expert product: the Function's dx and
    dw (three launches, all on the route of the operands' dtype, as
    ``lm_launches_per_step`` has it) against autograd through the
    plain version, dw equal bit for bit over two calls, and each of the
    three products as the Function calls it (forward; dx = dy w^T and dw =
    x^T dy reading w and x in place through the layout flags) timed beside
    ``torch.bmm`` on the same operands (transposed views) and its bound.
    On ``simt`` (fp32) each product is gated at ``GMM_SIMT_LIMIT_MS`` and
    the output tile rows are recorded; on ``tc`` (bf16) the flagged dx and
    dw are timed queued and gated at ``GMM_TC_BWD_LIMIT_MS``, and
    ``GMM_BATCH`` calls of each, profiled, run the tensor-core kernel and no
    other kernel (no copy of a transposed operand).  ``dy`` is scaled to unit RMS, as
    ``dout`` in ``attention_bwd_phase``."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels.grouped_matmul.ops import (grouped_matmul,
                                                        route, simt_tile)
    from repro_torch.kernels.grouped_matmul.ref import grouped_matmul_ref
    simt = x.dtype == torch.float32
    want_route = "simt" if simt else "tc"
    dy = _unit_rms(dy)
    before = {n: kernels.LAUNCHES.get(n, 0)
              for n in ("grouped_matmul", f"grouped_matmul.{want_route}")}
    xg, wg = (t.detach().clone().requires_grad_() for t in (x, w))
    got = torch.autograd.grad(grouped_matmul(xg, wg), (xg, wg), dy)
    torch.cuda.synchronize()
    for n, c in before.items():
        require(kernels.LAUNCHES.get(n, 0) == c + 3,
                f"{label}: {kernels.LAUNCHES.get(n, 0) - c} {n} launches, "
                f"expected 3")
    xr, wr = (t.detach().clone().requires_grad_() for t in (x, w))
    want = torch.autograd.grad(grouped_matmul_ref(xr, wr), (xr, wr), dy)
    verdicts = _grad_verdicts(label, "xw", got, want, tol)
    rec = dict(max(verdicts, key=lambda r: r["worst_of_tol"]))
    del xg, wg, xr, wr, want
    dw_again = grouped_matmul(x, dy, trans_x=True)
    torch.cuda.synchronize()
    require(torch.equal(dw_again, got[1]),
            f"{label}: dw differs between two calls")
    del dw_again, got
    products = {}
    for name, (a, b, flags) in (
            ("fwd", (x, w, {})), ("dx", (dy, w, {"trans_w": True})),
            ("dw", (x, dy, {"trans_x": True}))):
        require(route(a, b, **flags) == want_route,
                f"{label} {name}: route {route(a, b, **flags)}, expected "
                f"{want_route}")
        al = a.transpose(1, 2) if flags.get("trans_x") else a
        bl = b.transpose(1, 2) if flags.get("trans_w") else b
        G, M, K = al.shape
        N = bl.shape[2]
        bound_ms, bound_by = _bwd_bound(
            a.element_size() * (a.numel() + b.numel() + G * M * N),
            2 * G * M * K * N, not simt)
        gated = simt or bool(flags)
        limit_ms = GMM_SIMT_LIMIT_MS if simt else GMM_TC_BWD_LIMIT_MS
        kernel_ms = cuda_ms(lambda: grouped_matmul(a, b, **flags), reps,
                            batch=GMM_BATCH, queued=not simt)
        library_ms = cuda_ms(lambda: torch.bmm(al, bl), reps,
                             batch=GMM_BATCH, queued=not simt)
        if gated:
            require(kernel_ms <= limit_ms,
                    f"{label} {name}: {want_route} {kernel_ms:.4g} ms > "
                    f"{limit_ms} ms")
        products[name] = {
            "shape": {"G": G, "M": M, "K": K, "N": N},
            "layout": {"trans_x": bool(flags.get("trans_x")),
                       "trans_w": bool(flags.get("trans_w"))},
            "kernel_ms": kernel_ms,
            "kernel_ms_single": cuda_ms(
                lambda: grouped_matmul(a, b, **flags), reps),
            "plain_ms": cuda_ms(lambda: grouped_matmul_ref(a, b, **flags),
                                max(3, reps // 4), warmup=1),
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "pct_of_bound": 100 * bound_ms / kernel_ms,
            "kernel_over_library": kernel_ms / library_ms,
            "limit_ms": limit_ms if gated else None}
        if simt:
            products[name]["tile_rows"] = simt_tile(G, M, N)
        elif flags:
            # the flagged calls' device kernels: the product alone
            split = _device_ms_by_kernel(
                lambda: grouped_matmul(a, b, **flags), GMM_BATCH,
                ("gmm_kernel_tc",))
            require(not split["other_kernels"],
                    f"{label} {name}: the flagged call ran "
                    f"{split['other_kernels']} beside its product")
            products[name].update(
                profiled_kernel_ms=split["ms"]["gmm_kernel_tc"],
                profiled_launches=split["launches_traced"]["gmm_kernel_tc"])
    rec.update({"phase": "kernel", "name": "grouped_matmul_bwd",
                "input": label, "dtype": str(x.dtype), "route": want_route,
                "verdicts": verdicts, "dw_bit_equal_two_calls": True,
                "products": products})
    return rec


# ------------------------------------------------------------------ report

def kernel_entry(name: str, source: str, replaces: str, heaviest: dict,
                 phases: list[dict], launches: int,
                 routes: dict | None = None) -> dict:
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches,
             "max_abs_err": max(p["max_abs_err"] for p in phases),
             "ms": heaviest["kernel_ms"], "plain_ms": heaviest["plain_ms"],
             "bound_ms": heaviest["bound_ms"],
             "bound_by": heaviest["bound_by"],
             "library_ms": heaviest["library_ms"]}
    if routes is not None:
        entry["routes"] = routes
    return entry


def route_launches(name: str, routes: tuple, *counts: dict) -> dict:
    """Launches of ``name`` on each of ``routes`` (the ``name.route``
    counts), summed over the paths' launch counts."""
    return {r: sum(c.get(f"{name}.{r}", 0) for c in counts) for r in routes}


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit({"phase": "device", "kind": kind, "count": count,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = _build.build_all()
    require(len(built) == 7, f"expected 7 kernel sources, found "
                             f"{sorted(s.name for s in built)}")
    # no ptxas spill in K1, K4 (forward and backward), K2's rows kernel,
    # K2's tc backward (stats, dq and dk/dv at head_dim 64 and 128) and K3's
    # tc kernel (two tile shapes x four layouts), the instantiations
    # picked out by name, so the other kernels' reports decide nothing
    for stem, name, want in (("embedding_bag", "", None),
                             ("embedding_bag_bwd", "", None),
                             ("wcoj_intersect", "", None),
                             ("flash_attention", "attn_rows_kernel",
                              ROWS_INSTANTIATIONS),
                             ("flash_attention_bwd_tc", "attn_bwd_tc_",
                              BWD_TC_INSTANTIATIONS),
                             ("grouped_matmul", "gmm_kernel_tc",
                              GMM_TC_INSTANTIATIONS)):
        b = next(b for src, b in built.items() if src.stem == stem)
        n, spills = _build.spills(b["log"], name)
        require(not spills, f"{stem} {name}: ptxas spills {spills}")
        require(want is None or b["cached"] or n == want,
                f"{stem}: ptxas reported {n} {name} functions, expected "
                f"{want}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {src.stem: {
              "seconds": b["seconds"], "cached": b["cached"],
              "ptxas": [ln for ln in b["log"].splitlines()
                        if "registers" in ln or "spill" in ln
                        or "entry function" in ln]}
              for src, b in built.items()}})

    dev = torch.device("cuda")
    synth = probe_phase("synthetic_zipf", *synthetic_probe(SEED, dev))
    emit(synth)
    probe_gates(synth)

    main_rec, probes, store, gopt, most_rows_csr = main_path(SF)
    emit(main_rec)
    captured = {}
    for label, inputs in probes.items():
        captured[label] = probe_phase(label, *inputs)
        emit(captured[label])
        probe_gates(captured[label])
    emit(gremlin_path(gopt))
    del gopt
    sharded_rec = sharded_path(store)
    emit(sharded_rec)
    shard_probe = sharded_probe_phase("sharded_probe_glogue_most_rows",
                                      most_rows_csr,
                                      *probes["glogue_most_rows"])
    emit(shard_probe)
    del probes, inputs, most_rows_csr

    check_rec, check_gopt = cross_check(CHECK_SF)
    emit(check_rec)
    residency_rec = residency_path(check_gopt, CHECK_SF)
    emit(residency_rec)
    del check_gopt
    emit(delta_check(CHECK_SF))

    # the update stream takes the sf=100 store over: nothing else may hold
    # it, so the base it replaces at compaction can go
    held = [store]
    del store
    mutate_rec, gopt, probes = mutate_path(held.pop(), dev, MUTATE_SIZES,
                                           MUTATE_ROUNDS, SF)
    emit(mutate_rec)
    view_recs = []
    for label, inputs in probes.items():
        view_recs.append(probe_phase(label, *inputs))
        emit(view_recs[-1])
    del probes, inputs
    emit(chaos_path(gopt, dev))
    del gopt
    gc.collect()
    torch.cuda.empty_cache()

    serve_rec, model, calls = serve_path()
    emit(serve_rec)
    fa_phases = [attention_phase(label, *calls[f"flash_attention_{label}"],
                                 want_route)
                 for label, want_route in (("prefill", "tc"),
                                           ("decode", "split"))]
    gmm_phases = [gmm_phase(label, *calls[f"grouped_matmul_{label}"], "tc")
                  for label in ("prefill_w1", "prefill_w2", "decode_w1",
                                "decode_w2")]
    for rec in fa_phases + gmm_phases:
        emit(rec)
    # the scalar attention route, on the captured prefill cast to fp32
    q, k, v, q_start, kv_len, kw = calls["flash_attention_prefill"]
    emit(attention_phase("prefill_fp32", q.float(), k.float(), v.float(),
                         q_start, kv_len, kw, "rows",
                         tol=ATTENTION_FP32_TOL,
                         limit_ms=ATTN_ROWS_PREFILL_LIMIT_MS))
    del q, k, v
    # the scalar route, on decode_w1's operands cast to fp32 (TF32 off)
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = calls["grouped_matmul_decode_w1"]
    emit(gmm_phase("decode_w1_fp32", x.float(), w.float(), "simt",
                   tol=GMM_FP32_TOL))
    del x, w
    del model, calls
    gc.collect()        # the engine's step hooks form a reference cycle
    torch.cuda.empty_cache()
    emit(model_check())

    archs_rec = archs_path()
    emit(archs_rec)
    long_rec, long = long_context_path()
    emit(long_rec)
    q, k, v, q_start, kv_len, kw = long["calls"].pop("prefill")
    long_phases = [long_attention_phase("prefill_32k", q, k, v, q_start,
                                        kv_len, kw, "tc")]
    del q, k, v
    long_phases.append(attention_phase(
        "decode_32k", *long["calls"].pop("decode"), "split"))
    for rec in long_phases:
        emit(rec)
    gc.collect()
    torch.cuda.empty_cache()
    emit(dryrun_path(long))
    del long

    # mixed-precision training at OLMoE's widths, then K2 and K3, forward
    # and backward, on the calls its warm-up step captured (the model and
    # its optimizer state gone first)
    bf16_rec, bf16_calls = lm_train_bf16_path()
    emit(bf16_rec)
    fa_bf16, fa_bwd_bf16, gmm_bf16, gmm_bwd_bf16 = lm_train_bf16_kernels(
        bf16_calls)

    recsys_rec, copy_rec, bags = recsys_path()
    emit(copy_rec)
    emit(recsys_rec)
    bag_phases = [bag_phase(f"embedding_bag_{label}", *bags[label][:2])
                  for label in ("serve_p99", "serve_bulk")]
    # the third form: serve_bulk written into the deep tower's buffer
    bag_phases.append(bag_phase("embedding_bag_serve_bulk_into_mlp_input",
                                *bags["serve_bulk"]))
    # the warp route: serve_p99 through a view of the same table storage
    # one element past its base (no copy), so its rows are not 16-byte
    # aligned; ids of the last row fall past the view and add nothing
    ids, table = bags["serve_p99"][:2]
    V, D = table.shape
    shifted = table.view(-1)[1:1 + (V - 1) * D].view(V - 1, D)
    bag_phases.append(bag_phase("embedding_bag_serve_p99_warp", ids,
                                shifted, want_route="warp"))
    del ids, table, shifted
    for rec in bag_phases:
        emit(rec)
    del bags
    torch.cuda.empty_cache()
    emit(recsys_check())

    # Wide & Deep training at CONFIG: the serving model is gone (one
    # CONFIG model and its optimizer state fill most of the card)
    train_rec, bwd_call = recsys_train_path()
    emit(train_rec)
    full = bwd_call.pop("grad").cuda()
    bag_bwd = bag_bwd_phase("embedding_bag_bwd_train_batch",
                            bwd_call.pop("ids").cuda(),
                            full[:, :bwd_call["cols"]], bwd_call["V"])
    emit(bag_bwd)
    del full, bwd_call
    torch.cuda.empty_cache()
    emit(recsys_train_check())

    emit(gnn_path())
    emit(equiformer_paths_check())

    lm_recs, lm_calls = lm_train_path()
    q, k, v, q_start, kv_len, kw, dout = lm_calls["lm100m_attention"]
    B = q.shape[0]
    starts, lens = (torch.full((B,), n, dtype=torch.int32, device="cuda")
                    for n in (q_start, kv_len))
    # K2's forward on its rows route at the training shape
    fa_train = attention_phase("lm100m_layer0_fp32", q, k, v, starts, lens,
                               kw, "rows", tol=ATTENTION_FP32_TOL,
                               limit_ms=ATTN_ROWS_TRAIN_LIMIT_MS)
    emit(fa_train)
    bwd_phases = [
        attention_bwd_phase("lm100m_layer0", q, k, v, q_start, kv_len, kw,
                            dout, ATTENTION_FP32_TOL),
        attention_bwd_phase("lm100m_layer0_bf16", q.bfloat16(), k.bfloat16(),
                            v.bfloat16(), q_start, kv_len, kw,
                            dout.bfloat16(), ATTENTION_TOL)]
    for rec in bwd_phases:
        emit(rec)
    del q, k, v, dout, starts, lens
    # and at lm-moe's head_dim 32
    q, k, v, q_start, kv_len, kw, _ = lm_calls["lm-moe_attention"]
    starts, lens = (torch.full((q.shape[0],), n, dtype=torch.int32,
                               device="cuda") for n in (q_start, kv_len))
    fa_moe = attention_phase("lm-moe_layer0_fp32", q, k, v, starts, lens,
                             kw, "rows", tol=ATTENTION_FP32_TOL)
    emit(fa_moe)
    del q, k, v, starts, lens
    gmm_bwd = [gmm_bwd_phase(f"lm-moe_layer0_{w}", *lm_calls[f"lm-moe_{w}"])
               for w in ("w1", "w2")]
    for rec in gmm_bwd:
        emit(rec)
    del lm_calls
    lm_launches = {}
    for rec in lm_recs:
        for part in (rec["launches"], rec.get("resumed_launches", {})):
            for name, n in part.items():
                lm_launches[name] = lm_launches.get(name, 0) + n
    lm_paths = (serve_rec["launches"], archs_rec["launches"],
                long_rec["launches"], bf16_rec["launches"], lm_launches)
    bwd_routes = route_launches("flash_attention_bwd",
                                ("tc", "saved", "recompute"), *lm_paths)
    # K3 tc's dx and dw with layout flags: the heaviest captured product
    flagged = max((p for r in gmm_bwd_bf16
                   for n, p in r["products"].items() if n != "fwd"),
                  key=lambda p: p["kernel_ms"])

    # the kernels line reports the heaviest captured call of each kernel
    emit({"kernels": [
        kernel_entry(
            "wcoj_intersect",
            "src/repro_torch/kernels/wcoj_intersect/csrc/wcoj_intersect.cu",
            "src/repro/kernels/wcoj_intersect/wcoj_intersect.py:39",
            captured["glogue_most_steps"],
            [synth, *captured.values(), shard_probe, *view_recs],
            main_rec["launches"].get("wcoj_intersect", 0)
            + residency_rec["launches"].get("wcoj_intersect", 0)
            + sharded_rec["launches"].get("wcoj_intersect", 0)
            + mutate_rec["launches"].get("wcoj_intersect", 0)),
        kernel_entry(
            "flash_attention",
            "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:69",
            fa_phases[0],
            fa_phases + [fa_train, fa_moe, fa_bf16] + long_phases,
            serve_rec["launches"].get("flash_attention", 0)
            + archs_rec["launches"].get("flash_attention", 0)
            + long_rec["launches"].get("flash_attention", 0)
            + bf16_rec["launches"].get("flash_attention", 0)
            + lm_launches.get("flash_attention", 0)),
        kernel_entry(
            "grouped_matmul",
            "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu",
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:38",
            gmm_phases[0], gmm_phases + gmm_bwd + gmm_bf16 + gmm_bwd_bf16,
            serve_rec["launches"].get("grouped_matmul", 0)
            + archs_rec["launches"].get("grouped_matmul", 0)
            + long_rec["launches"].get("grouped_matmul", 0)
            + bf16_rec["launches"].get("grouped_matmul", 0)
            + lm_launches.get("grouped_matmul", 0),
            route_launches("grouped_matmul", ("tc", "simt"), *lm_paths)),
        kernel_entry(
            "grouped_matmul (tc, layout flags: the bf16 backward's dx, dw)",
            "src/repro_torch/kernels/grouped_matmul/csrc/grouped_matmul.cu",
            "src/repro/kernels/grouped_matmul/grouped_matmul.py:38",
            flagged, gmm_bwd_bf16,
            # dx and dw are 6 of the 12 K3 launches a layer in a step
            bf16_rec["launches"].get("grouped_matmul.tc", 0) // 2),
        kernel_entry(
            "flash_attention_bwd",
            "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_bwd.cu",
            "none (backward of K2; the reference differentiates its jnp "
            "path)", bwd_phases[0], bwd_phases[:1],
            bwd_routes["saved"] + bwd_routes["recompute"],
            {r: bwd_routes[r] for r in ("saved", "recompute")}),
        kernel_entry(
            "flash_attention_bwd_tc",
            "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_bwd_tc.cu",
            "none (backward of K2 in bf16; the reference differentiates its "
            "jnp path)", fa_bwd_bf16, [bwd_phases[1], fa_bwd_bf16],
            bwd_routes["tc"], {"tc": bwd_routes["tc"]}),
        kernel_entry(
            "embedding_bag",
            "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
            "src/repro/kernels/embedding_bag/embedding_bag.py:50",
            bag_phases[1], bag_phases,
            recsys_rec["launches"].get("embedding_bag", 0)
            + archs_rec["launches"].get("embedding_bag", 0)
            + train_rec["launches"].get("embedding_bag", 0)),
        kernel_entry(
            "embedding_bag_bwd",
            "src/repro_torch/kernels/embedding_bag/csrc/"
            "embedding_bag_bwd.cu",
            "none (backward of K4; the reference differentiates its "
            "jnp.take lookup)", bag_bwd, [bag_bwd],
            train_rec["launches"].get("embedding_bag_bwd", 0))]})
    print(smi, flush=True)
    require(time.perf_counter() - t_start < 1200, "smoke run over 1200 s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


def main() -> int:
    try:
        return run()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
