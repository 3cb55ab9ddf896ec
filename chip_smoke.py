"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; it exits non-zero without them.  Phases, in order (a failure exits
non-zero before the result lines; a failed check of phase 5's "graphs",
"migrate", "prefix", "evict", "cluster", "sharded", "plans",
"orchestrated", "evaluation" or "train" runs
is reported, and exits non-zero, after phase 6 has run and printed its
table):

  1. the card's name and power limit, the CUDA version; TF32 off;
  2. build every kernel from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a)
     and print registers and spills (the prefill backward's instantiations
     and the SSD chunk backward's three kernels too); count the tensor-core
     instructions (``HMMA`` of ``mma.sync`` and ``HGMMA`` of ``wgmma``,
     apart, from ``cuobjdump -sass``) of each prefill, prefill backward and
     SSD chunk instantiation and fail if the bf16 prefill ones (HMMA), the
     bf16 backward's dK/dV and dQ kernels at any head dim (HGMMA) or the
     SSD chunk kernel and its backward's tile kernel at the served models'
     P = 64 (HMMA) have none;
  3. hold each kernel against its plain PyTorch version on the card, fp32
     (absolute 1e-4; the SSD chunk kernel 1e-4 of each output row's
     largest value) and bf16 (1e-2 of each output row's largest value), at
     smoke and serving shapes (yi-9b, gemma2-2b, hymba-1.5b, mamba2-370m,
     and the model families' heads: opt-30b's 56/56 and olmoe-1b-7b's
     16/16 heads of 128, a group of 1, granite-moe's 24/8 of 64, a
     group of 3, and the "sharded" job's shard-local heads: yi-9b's 16/2
     at tp 2 and 4/1 at tp 8, olmoe's 8/8 of 128 and granite-moe's 12/4
     of 64 at tp 2, mamba2's 16 SSD heads of 64 at tp 2), the prefill
     kernel also at a chunk's query offset (and its device-offset form,
     the chunk graph's: the offset as an int32 scalar, one per row and
     distinct per row, each bit-equal to the by-value form), both
     decode kernels also split over many CTAs and, at fixed split counts,
     against the plain split-and-combine, the dense decode kernel's lse
     form (the decode plan's sequence shards: out bit-equal to the form
     without, the lse within 1e-4, zeros and -inf on rows that attend
     nothing, by the wrapper's split and at 1, 3 and 40), the SSD chunk
     kernel also at
     ragged state widths, long chunks and unaligned inputs, and causal to
     the bit (a row's output is the same whatever rows follow it); the
     prefill kernel's backward (dq, dk, dv from q, k, v, out, lse and dO)
     against its plain version at every head dim, groups of 1, 3 and 8,
     ragged S, gemma2-2b's heads past its 4096 window with softcap 50, and
     the train job's shapes (yi-100m's 12/4 heads of 64 at S = 256, yi-9b's
     32/4 of 128 at S = 2048), the forward's lse against logsumexp of the
     plain scores within 1e-4, and each gradient twice, bit-equal; the SSD
     chunk kernel's backward (dx, ddt, dA, dB, dC from x, dt, A, B, C, dy
     and dS) against its plain version in float64 on the forward's cases,
     dx, dB and dC within 1e-4 of each row's largest value and ddt, dA of
     the tensor's, each twice, bit-equal, once through ``ops.ssd_chunk``'s
     autograd.Function with a strided dy and the chunk states unused, and
     rows >= n of dx, ddt, dB and dC bit-equal when dy changes before n;
  4. greedy decoding: the smoke configs (yi-9b, gemma2-2b, mamba2-370m,
     hymba-1.5b, and the families ported since: olmoe-1b-7b and
     granite-moe-3b-a800m (MoE), opt-30b (sinusoidal positions, biases,
     GELU), starcoder2-3b, qwen1.5-110b, chameleon-34b and musicgen-medium)
     give the same tokens on the card and the CPU in every engine mode
     (paged at decode_horizon 1 and 8, the dense mode, chunked prefill,
     the prefix cache); one olmoe-1b-7b MoE layer at its published widths
     on 4096 tokens takes the capacity path (one group, capacity factor
     1.25) and drops the same (token, slot) pairs on the card as on the
     CPU (their count printed), with outputs within 1e-4, and at a
     drop-free factor equals ``moe_ref``; 2-layer full-width
     yi-9b, hymba-1.5b and mamba2-370m (fp32) give the same tokens in every
     mode (chunked prefill in 64-token chunks; chunks and the cache are
     ignored by the SSM models) and agree with a teacher-forced forward; on
     both, a shared-template job (a template, unique tails and a retry of
     the first prompt) gives the same tokens with the prefix cache on and
     off, and hits on every request after the first where the model has
     no SSM layers; on both, requests served two steps, exported
     and migrated (page handoff in one shared pool, a copy into another
     pool, a relayout into a pool of half-size pages, re-prefill; mamba2
     has no pages to re-lay out) finish with the same tokens as the same
     engine's uninterrupted run, the smoke configs on the card and on the
     CPU; the cluster (``serving/cluster.py``, fp32, a virtual tick
     clock): the twins of the three cluster benches (``bench_rebalance``,
     ``bench_disagg``, ``bench_recovery``) on yi-9b give the same tokens
     per rid on the card and the CPU and the counts committed in their
     ``BENCH_*.json`` files (read from them), and a switch with requests
     in flight followed by a replica crash gives the same tokens on both
     and those of one uninterrupted engine: yi-9b in the dense decode
     mode with the crashed replica's pages lost, hymba-1.5b with its
     pages and SSM rows handed off; the control loop's
     ``serving.validation.run_real_spans`` (llama2-70b smoke, planned
     with the full profile on 6 virtual chips over 3 spans, a deployment
     switch every span with requests in flight), and again on the
     default model's, opt-30b (one switch, a drained replica), gives the
     same plans, switch and span reports and tokens per rid on the card
     and the CPU; and the evaluation's ``bench_e2e.real_validation``
     (opt-30b smoke, 6 chips, 2 spans, telemetry on) gives the same rows
     on the card and the CPU but for the wall-clock fields (each span's
     seconds, the latency histograms' millisecond quantiles), completes
     every request and launches the paged decode and prefill kernels
     (counted from a reset just before the card's run); the train smoke:
     every smoke config without SSD layers (yi-9b, gemma2-2b, olmoe-1b-7b,
     granite-moe-3b-a800m, starcoder2-3b, opt-30b, qwen1.5-110b,
     chameleon-34b, musicgen-medium through ``embeds_batches``) takes 3
     fp32 ``make_train_step`` steps (remat, 2 microbatches) on the card and
     on the CPU from one set of weights, losses within 1e-5 relative and
     parameters within 1e-5, B2's forward launched layers x 2 x 2 and its
     backward layers x 2 times a step; mamba2-370m and hymba-1.5b likewise
     (seq 96 over their chunk of 64: a padded last chunk), B4's forward and
     backward counted as B2's (B2's for hymba's attention, none for
     mamba2); the decode kernel B1 still raises its grad guard under grad;
     ``python -m repro_torch.quickstart`` runs on the card and finishes its
     6 requests with 12 tokens each;
  5. the served models at full width, one after another: yi-9b (48
     layers) three times on the same weights (paged decode, the dense
     decode mode, chunked prefill in 256-token budgets), hymba-1.5b (32)
     and mamba2-370m (48), then opt-30b (all 48 layers, 60 GB of weights,
     on a pool of 512 pages in place of 2048) and olmoe-1b-7b (16), each
     paged and chunked (the chunks put sinusoidal positions at a query
     offset), then granite-moe-3b-a800m (32) paged, bf16, random weights
     from a seeded generator,
     each run serving 8 requests through ``ServingEngine`` (graphed: the
     unsharded engine's one-shot prefills, paged decode horizons and
     chunk forwards replay one CUDA graph per shape key,
     ``serving/graphs.py``; every engine of phases 4 and 5 runs so unless
     its configuration keeps it eager: the dense decode, sharded engines);
     the launch counters are set to 0 just before each run and read just after it,
     every kernel on that run's path must have launched (and the dense run
     no paged decode, the chunked run the prefill kernel more than once per
     layer and request); at least 90 % of the generated tokens must equal a
     teacher-forced forward's argmax; then, on the same weights, the
     "graphs" job (``GRAPHS_RUNS``: yi-9b paged, chunked and sampled (the
     paged run with ``greedy=False``: the counter-based sampler inside the
     decode graphs), hymba-1.5b and olmoe-1b-7b paged): the run's job
     served by an eager engine (``graphs=False``) and by a graphed one
     three times: cold (each decode and chunk key captured at its first
     use, each prefill key run eagerly), second (the same prompts, the
     sampler restarted: each prefill key captured at its second call)
     and warm (a third pass, replays only), each pass's wall, TTFT,
     decode rate, decode_syncs, B1 (and combine)/B2 (and offset)/B4
     launches (every kernel counts its own launches on the card, so a
     replay's count as eager ones), the prefill groups run eagerly,
     captured and replayed apart from decode and chunk captures and
     replays, capture seconds and reserved memory printed, and the four
     TTFTs side by side; the graphed streams, decode_syncs and launches
     must equal the eager engine's, the second pass capture only prefill
     keys, the warm pass capture nothing and replay every prefill the
     cold pass ran, and dropping the graphed engine give its memory back;
     then the "migrate" runs: yi-9b by
     handoff, copy, relayout and re-prefill, hymba-1.5b by handoff, copy
     and re-prefill.  The paged job's source
     serves until every request has 8 tokens, ``migrate_batch`` moves all
     8 requests and the destination finishes the 32 tokens.  Each run must
     meet the report's exact counts (all 8 by the path, the pages held,
     no recompute, or recompute = prompt + generated = the destination's
     prefill tokens), the launches from the import on (no prefill or SSD
     chunk kernel after a page move; the paged decode kernel after it; the
     prefill kernel, and for hymba the SSD chunk kernel, on re-prefill),
     bit-equal K/V right after a copy or relayout, no page or reservation
     left after ``release_all``, and the 90 % agreement; that run warms
     the path up, and the stall (export until the pages are resident, and
     until every request's next token) is the median of 3 rounds on one
     more serve of the job, each a move to the destination, a step there
     and a move back; then, on the same yi-9b weights, the "prefix" runs:
     a 768-token template, 7 requests of it and a unique 64-token tail and
     a retry of request 0, 32 new tokens each, request 0 alone to its
     first token and then the rest, served with the cache off and on; the
     prefill tokens, hits, misses, hit tokens and prefill-kernel launches
     must equal the counts derived from the prompts (on: some at a query
     offset), request 0's published pages must be unchanged by the hits,
     every block free or held by the index alone after retirement, and
     the 90 % agreement must hold; last the "evict" run: two 768-token
     templates served A, B, A, B through one slot and a 60-page pool, each
     revisit prefilling 1 token, each restored page bit-equal to its
     gather before eviction, whole pages moved, no block lost, and the
     host tier's time a page for an eviction and a restore beside a plain
     pinned copy of the same bytes; last, on the same weights, the
     "cluster" runs: 16 prompts of 128-1024 tokens over 4 virtual chips
     (512 pages and 8 slots each) — a switch from [2, 1, 1] to [2, 2]
     chips at 8 tokens (the moved requests by page handoff, nothing
     recomputed, no rollback), two crashes under [2, 1, 1] (pages kept at
     8 tokens: handoff; lost at 16: re-prefill of exactly prompt +
     emitted, every earlier stream a prefix of the final one, blocks
     conserved), and [2 prefill, 2 decode] against [2, 2] mixed (16
     handoffs, nothing recomputed); each run must launch the paged
     decode and prefill kernels, finish 16 x 32 tokens, leave the pool
     whole and meet the 90 % agreement, and prints its switch or
     recovery stalls, TTFT and decode rate beside the card's line (the
     migrate and cluster jobs also print how many of their prefill groups
     ran eagerly, were captured or replayed); last,
     on each model's weights after its other runs, its "sharded" job: the
     paged job on replica meshes of virtual chips, every entry this card
     (``SHARDED_RUNS``): (tp 1, pp 1) gives the paged run's tokens to the
     bit; yi-9b at (tp 2, pp 2) (all 48 layers) and tp 8 (4 query heads
     a shard over one replicated KV head, a 512-page pool), hymba-1.5b at
     tp 2 (attention and its 25 SSM heads on shard 0, the MLP split),
     mamba2-370m at (tp 2, pp 2) (16 SSM heads a shard; fp32 weights and
     pool, scored against an fp32 forward: ``SHARDED_FP32``), olmoe-1b-7b at
     (tp 2, pp 2) (32 experts a shard) and granite-moe-3b-a800m at tp 2
     (each expert's ff split) meet the 90 % agreement; each run launches
     B1 and B2 (with attention) and B4 (with SSD layers) at exactly its
     shards' head counts, and no B3; for yi-9b and mamba2-370m the
     "cluster" job sharded over 8 virtual chips, a switch from (tp 2) +
     (tp 1) to (tp 1) + (tp 2, pp 2) with every request in flight moved
     by ``reshard_blocks`` (mamba2's by its SSM rows, in fp32; nothing
     re-prefilled or recomputed), and for yi-9b a crash of the tp-2
     replica (its requests moved by reshard) and its repair onto the same
     chips, each finishing 16 x 32 tokens with every pool whole and the
     90 % agreement; and ``psum_compressed`` in a world of one under NCCL
     equal to ``compress_roundtrip`` to the bit; each run prints its
     wall, TTFT and decode rate beside the card's line, and each model's
     job its total (co-located shards run the sharded path, not tensor
     parallelism's speed); then, on yi-9b's weights, the "plans" job's
     serving runs (the JAX package's prefill and decode plans on a (data,
     model) mesh of virtual chips, ``PLANS_SERVE``/``PLANS_LONG``): 8
     prompts of 512 prefilled on (data 2, model 2), the cache resharded
     to the decode plan's layout and 32 greedy tokens decoded over two
     4-sequence data groups x two sequence shards (B3 with its
     log-sum-exp, the partials combined), and one prompt of 8192 decoded
     over (data 2, model 2) sequence shards of a 12288-position cache
     (the last one past every position): each launches exactly B2 at the
     shards' heads and B3's lse form at the shards' S, no B1, and meets
     the 90 % agreement; and the mesh of ones at 4 layers, its logits
     bit-equal to the unsharded prefill and dense ``decode_step``; last
     the "orchestrated" job, OServe's control
     loop (predict -> plan ->
     switch): ``serve_orchestrated``'s analytic loop with its LSTM on the
     card (12 spans of a synthetic trace typed by k-means, llama2-70b
     planned on 16 chips), the card's predictions within a relative 1e-4
     of the CPU's, one LSTM fit at the paper's defaults timed on the card
     and the host; then llama2-70b at its published widths cut to 20 of
     80 layers (bf16, seeded weights, ~35 GB), planned by
     ``Orchestrator.plan_span`` with the full 80-layer profile on 6
     virtual chips (512 pages and 4 slots each, drain window 0, prefix
     cache on) over 3 spans of alternating mixes, 12 requests a span of
     a per-type 128-token template and a unique tail (1275, 139, 1181 or
     282 tokens), 32 new tokens each, two runtime steps after each
     submit, each plan applied by ``ClusterRuntime.apply_plan`` with the
     requests in flight: all 36 finish, the deployment changes and
     requests migrate, each ``SwitchReport`` accounts for every request
     on a torn-down replica (drained or migrated once, queued ones
     requeued, none dropped, nothing copied, recompute = the re-prefilled
     contexts), the paged decode and prefill kernels launch (the prefill
     kernel also at a query offset, on prefix hits) and the dense decode
     kernel does not, the 90 % agreement holds; each span prints its
     plan, switch stall, TTFT, rate, predicted and achieved replica
     shares and the decision audit's error, and the cost model's prefill
     and decode-step times for the 20-layer profile stand beside the
     card's; last the "evaluation" job, the paper's comparison
     (``repro_torch.benchmarks``): ``bench_e2e``'s six policies simulated
     at opt-30b's full profile on 16 virtual H100s over 12 spans of trace
     2 (the cost model and the discrete-event simulator on the host,
     printed as such, not a measurement of the card), every request
     completed or dropped; ``OServePolicy`` with an LSTM in the loop
     (window 6, hidden 8) on the card and the CPU, each span's prediction
     within a relative 1e-4 and whether the deployment logs are equal;
     ``bench_predictor`` at its defaults (300 spans, window 50, hidden 32,
     250 epochs) on the card and the CPU, each rrmse within 1e-3, with the
     fit's seconds and the milliseconds a prediction (the ordering row is
     printed, not checked); last the "train" job (bf16 compute over fp32
     master weights): (a) ``train_100m --full-100m``'s yi-100m (12 layers,
     d_model 768, 12/4 heads of 64, 125 M parameters) at its settings,
     120 steps with a checkpoint every 60, then a fresh ``Trainer``
     resumed from step 60: its losses for steps 61-120 and final
     parameters equal to the uninterrupted run's to the bit, the last 10
     steps' mean nll below the first 10's less 0.05; (b) yi-9b at its
     published widths reduced to 8 of 48 layers (1.91 B parameters), seq
     2048, batch 2, 2 microbatches, remat, 10 steps: finite losses, the
     last below the first; (c) yi-9b at 2 layers, fp32, one ``loss_fn``
     gradient on the card and the CPU: loss within 1e-5 relative, every
     gradient leaf within 1e-3 of its largest value; (d) mamba2-370m at
     its published widths, all 48 layers (368 M parameters), seq 2048,
     batch 2, 2 microbatches, remat, lr 3e-4, 12 steps with a checkpoint
     at 6 and a fresh ``Trainer`` resumed from it: steps 7-12 and the
     final parameters equal to the uninterrupted run's to the bit, the
     last 3 steps' mean nll below the first 3's less 0.05; (e) hymba-1.5b,
     lr 3e-5, all 32
     layers (1.34 B parameters), the same batch, 10 steps: finite losses,
     the last below the first; (f) mamba2-370m and hymba-1.5b at 2 layers,
     fp32, seq 320 (a padded chunk), one gradient on the card and the CPU
     as (c); (g) gemma2-2b at its published widths reduced to 2 of 26
     layers (B2's backward at D = 256 under softcap 50), lr 3e-6, 4
     steps of (b)'s batch: finite losses, the last below the first; each
     run prints its median step time, tokens/s, model-FLOPs
     share, peak memory and B2's and B4's forward and backward launches
     (each exactly what the steps imply) beside the card's line; last the
     "plans" job's train runs (``PLANS_TRAIN``): ``Trainer(plan=, mesh=)``
     on the train plan over (data 2, model 2), fsdp and the
     sequence-parallel residual, yi-9b at 4 layers and mamba2-370m at 48,
     batch 2 x 2048, 3 steps: the loss falls, B2/B4 and their backwards
     launch exactly as the shards and groups imply at the shards' heads,
     the sharded bf16 first-step loss stands within twice the unsharded
     port's bf16-to-fp32 distance of the unsharded bf16 loss, a 2-layer
     fp32 gradient within 1e-4 of the unsharded port's, and a bf16 step
     on the mesh of ones equal to the unsharded step to the bit;
  6. time each kernel at each run's serving shapes with CUDA events
     (median of 20 groups of 10 back-to-back calls) beside its bound, its
     plain version and, where one exists, one PyTorch library call
     computing the same function, and again as the same 10 calls replayed
     from a CUDA graph (``device_ms``: no host work between the kernels,
     so a kernel faster than its wrapper's host code shows its own time);
     the chunk rows also time B2's device-offset form, both ways;
     each timed kernel's output is checked again; the decode rows also
     give their split counts and CTAs, as the wrappers launched them; B2's
     backward at the train runs' shapes (gemma2-2b's with its softcap and
     window), twice bit-equal, each of its launches' device time from the
     profiler, beside autograd of ``scaled_dot_product_attention`` with
     K/V expanded (of compiled ``flex_attention`` under a softcap), its
     launches a step; B4's backward at (d)'s and (e)'s microbatch shapes (no library
     call computes it), its launches a step.

Phase 6 also times the kernels at the sharded runs' shard shapes
(``SHARDED_TIMED``): B1 and B2 at yi-9b's 16/2 heads of 128, olmoe's 8/8
of 128 and granite-moe's 12/4 of 64, B4 at mamba2's 16 heads; and B3's
lse form at one sequence shard of each plans serving run.

The last three lines are the card line, one JSON object with the kernel
table (one row per kernel and timed run) and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
FP32_FLOPS_PER_S = 67e12           # H100 SXM fp32 rate outside tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM dense TF32 tensor-core rate
# fp32: kernel and plain version sum in different orders, so they agree to
# an absolute 1e-4.  bf16: both compute in fp32 and round the result to 8
# significant bits, so an element may differ by one bf16 step, at most
# 2^-7 of the largest |value| in its output row; the limit is 1e-2 of that
# row maximum.  Attention over 2048 tokens spreads its weight thin, so the
# long rows' values are small: a row-relative limit keeps the check as
# tight on them as on the short rows (a kernel that kept its running sum
# in bf16 fails it on the long rows, where an absolute limit would not).
ATOL_FP32 = 1e-4
ROW_RTOL_BF16 = 1e-2
# the SSD chunk kernel is fp32 only; each output is a sum of up to 256
# exp-weighted products whose size grows with the chunk and the state
# width, so its limit is relative to the output row's largest |value| (a
# row is y[t, :] or S[p, :]): fp32 sums of 256 terms in another order
# differ by ~1e-6 of it, a wrong or missing term by far more than 1e-4
ROW_RTOL_SSD = 1e-4
# a bf16 48-layer random-weight model rounds differently on the prefill
# and decode paths, so near-tied argmaxes may flip (1 of 32 tokens in the
# first measurement); a broken decode path agrees on almost none
MIN_TEACHER_FORCED = 0.9
# one phase-5 run of a model: its engine options, the kernels the run
# must launch and must not launch, and the phase-6 timings taken at its
# shapes
Variant = collections.namedtuple(
    "Variant", "name options launch no_launch timed")
PAGED = dict(decode_horizon=8)
# opt-30b's pool: the 8 prompts of 320-963 tokens and 32 new tokens each
# reserve 379 pages of 16 tokens
OPT_POOL_BLOCKS = 512
# the phase-5 models whose cost-model step times stand beside the card's
COST_MODEL_MODELS = ("opt-30b",)
# the served models at full width, in order, and their runs
FULL_WIDTH = (
    ("yi-9b", (
        Variant("paged", PAGED, ("paged_decode", "flash_attention"), (),
                ("paged_decode", "flash_attention")),
        Variant("dense", dict(decode_mode="dense"),
                ("flash_decode", "flash_attention"), ("paged_decode",),
                ("flash_decode",)),
        Variant("chunked", dict(PAGED, prefill_chunk_tokens=256),
                ("paged_decode", "flash_attention"), (),
                ("flash_attention_chunk",)),
    )),
    ("hymba-1.5b", (
        Variant("paged", PAGED,
                ("paged_decode", "flash_attention", "ssd_chunk"), (),
                ("paged_decode", "flash_attention", "ssd_chunk")),
    )),
    ("mamba2-370m", (
        Variant("paged", PAGED, ("ssd_chunk",), (), ("ssd_chunk",)),
    )),
    # 60 GB of weights: a pool of OPT_POOL_BLOCKS pages (11.3 GB) in place
    # of the 2048 (45 GB) that would not fit beside them
    ("opt-30b", (
        Variant("paged", dict(PAGED, num_blocks=OPT_POOL_BLOCKS),
                ("paged_decode", "flash_attention"), (),
                ("paged_decode", "flash_attention")),
        Variant("chunked", dict(PAGED, prefill_chunk_tokens=256,
                                num_blocks=OPT_POOL_BLOCKS),
                ("paged_decode", "flash_attention"), (),
                ("flash_attention_chunk",)),
    )),
    ("olmoe-1b-7b", (
        Variant("paged", PAGED, ("paged_decode", "flash_attention"), (),
                ("paged_decode", "flash_attention")),
        Variant("chunked", dict(PAGED, prefill_chunk_tokens=256),
                ("paged_decode", "flash_attention"), (),
                ("flash_attention_chunk",)),
    )),
    # the reference streams of its sharded runs ("tp" experts)
    ("granite-moe-3b-a800m", (
        Variant("paged", PAGED, ("paged_decode", "flash_attention"), (),
                ("paged_decode", "flash_attention")),
    )),
)
# phase 5's "graphs" job: the runs (by variant name) served by one eager
# and one graphed engine on the same prompts, the graphed one twice;
# GRAPHS_SAMPLED's runs are a variant's options with sampled decoding
GRAPHS_RUNS = {"yi-9b": ("paged", "chunked", "sampled"),
               "hymba-1.5b": ("paged",), "olmoe-1b-7b": ("paged",)}
GRAPHS_SAMPLED = {"sampled": "paged"}
# the launch counts (``ops.launch_counts``) the graphed runs must match the
# eager ones on: B1 and its split combine, B2 and its offset launches, B4
GRAPHS_COUNTED = ("paged_decode", "paged_decode_combine", "flash_attention",
                  "flash_attention_offset", "ssd_chunk")
# the device memory (GiB) a dropped graphed engine may leave reserved beyond
# the reading before its job: the caches that outlive an engine (cuBLAS
# workspaces of the capture and side streams, the RoPE frequencies, the
# launch counters) and nothing of its graphs' pool
GRAPHS_MEM_SLACK_GIB = 0.25
# phase 6's chunk shape: 256 queries after 512 resident tokens
CHUNK, CHUNK_OFFSET = 256, 512
# phase 5's migrate runs: the restore paths each model takes, after its
# variants, on the same weights
MIGRATE = {"yi-9b": ("handoff", "copy", "relayout", "reprefill"),
           "hymba-1.5b": ("handoff", "copy", "reprefill")}
# the migrate run's source serves until every request has this many
# tokens; the stall is the median of STALL_ROUNDS rounds after the checked
# run, which warms the path up
MIGRATE_AFTER, STALL_ROUNDS = 8, 3
# phase 5's prefix-cache runs, after the migrate runs on the same weights:
# the "prefix" job (a 768-token template, 7 requests of it and a unique
# 64-token tail, then a retry of request 0; 32 new tokens each) and the
# "evict" job (two 768-token templates served A, B, A, B through one slot
# and a pool of EVICT_BLOCKS pages, so each visit evicts the other
# template's cold pages to the host tier and the next restores them)
PREFIX_MODELS = ("yi-9b",)
PREFIX_JOB = dict(template=768, tail=64, n=8, new_tokens=32)
EVICT_JOB = dict(template=768, visits=4, new_tokens=8)
EVICT_BLOCKS = 60
# the host tier's rates: HOST_ROUNDS rounds of HOST_PAGES evictions, then
# as many restores, beside a plain pinned copy of the same bytes
HOST_PAGES, HOST_ROUNDS = 32, 3
# phase 3's cases for B2's backward: every head dim, groups of 1, 3 and 8,
# ragged S, gemma2-2b's heads past its window with its softcap, and the
# train job's shapes (yi-100m's microbatch, yi-9b at 2048 tokens)
BWD_CASES = [
    # name, B, S, Hq, Hkv, D, softcap, window
    ("d32-group1", 2, 77, 4, 4, 32, 0.0, 0),
    ("d64-group3", 2, 100, 12, 4, 64, 0.0, 0),
    ("d128-group8-cap", 2, 130, 32, 4, 128, 30.0, 0),
    ("d256-window", 1, 99, 8, 4, 256, 50.0, 40),
    ("gemma2-2b", 1, 4160, 8, 4, 256, 50.0, 4096),
    ("yi-100m", 4, 256, 12, 4, 64, 0.0, 0),
    ("yi-9b-2048", 1, 2048, 32, 4, 128, 0.0, 0),
]
# the forward's log-sum-exp against logsumexp of the plain scores: values
# of ~5-10 summed in another order in fp32 differ by ~1e-6
LSE_ATOL = 1e-4
# B2's backward is held as B2 is (fp32 within ATOL_FP32, bf16 rows within
# ROW_RTOL_BF16 of their largest |value|), but a bf16 row's largest value
# is floored at GRAD_ROW_FLOOR of the tensor's: the first query's dq is
# zero in exact arithmetic (one key, so dP = delta and dS = 0), and both
# versions return rounding noise there, which no row-relative limit holds
GRAD_ROW_FLOOR = 1e-3
# phase 3's cases for B4 and its backward: name, B, Nc, Q, H, P, N, G
SSD_CASES = [
    ("smoke", 2, 2, 64, 4, 16, 16, 1),
    ("ragged-q100", 1, 1, 100, 4, 32, 16, 1),
    ("groups2", 1, 2, 64, 8, 32, 16, 2),
    ("mamba2", 1, 4, 256, 32, 64, 128, 1),
    ("mamba2-q195", 2, 1, 195, 32, 64, 128, 1),
    # mamba2's shard-local heads at tp 2 (the "sharded" job)
    ("mamba2-tp2", 1, 4, 256, 16, 64, 128, 1),
    ("hymba", 1, 4, 256, 25, 64, 16, 1),
    ("hymba-batch", 3, 2, 256, 25, 64, 16, 1),
    # chunks longer than 256 and P = 128
    ("q300", 1, 2, 300, 6, 64, 128, 2),
    ("q1024", 1, 1, 1024, 4, 128, 64, 1),
    # B/C rows off 16 bytes: 4-byte staging (N % 4 != 0); every input 4
    # bytes past a 16-byte boundary
    ("ragged-n13", 1, 2, 130, 8, 32, 13, 2),
    ("n200-p128", 1, 1, 256, 4, 128, 200, 1),
    ("p16-n256", 1, 2, 77, 4, 16, 256, 1),
]
# phase 3's independence checks (B4 causal to the bit; its backward's rows
# >= n do not move with dy in the rows before n): name, H, P, N, n at Q 256
SSD_CUT_CASES = (("hymba", 25, 64, 16, 203), ("mamba2", 32, 64, 128, 77))
# phase 4's train smoke: every smoke config takes TRAIN_SMOKE["steps"]
# fp32 steps on the card and on the CPU from one set of weights (remat, 2
# microbatches, AdamW's defaults); losses within a relative TRAIN_RTOL,
# parameters within TRAIN_ATOL.  seq 96 over the SSM smoke configs' chunk
# of 64 gives a padded last chunk
TRAIN_SMOKE_ARCHS = ("yi-9b", "gemma2-2b", "olmoe-1b-7b",
                     "granite-moe-3b-a800m", "starcoder2-3b", "opt-30b",
                     "qwen1.5-110b", "chameleon-34b", "musicgen-medium",
                     "mamba2-370m", "hymba-1.5b")
TRAIN_SMOKE = dict(steps=3, batch=4, seq=96, microbatches=2)
TRAIN_RTOL = TRAIN_ATOL = 1e-5
# phase 5's "train" job (bf16 compute over fp32 master weights): (a)
# ``train_100m --full-100m``'s yi-100m and settings, TRAIN_A["steps"] steps
# with a checkpoint every TRAIN_A["every"], then a fresh Trainer resumed
# from that checkpoint to the end; (b) yi-9b at its published widths cut
# to TRAIN_B["layers"] of 48 layers (fp32 master, two moments and the
# gradients take 16 bytes a parameter: 141 GB at 48 layers, 31 GB at 8);
# (c) yi-9b at 2 layers, one fp32 gradient on the card and on the CPU,
# each leaf within GRAD_LEAF_RTOL of the leaf's largest |value|
TRAIN_A = dict(steps=120, every=60, batch=8, seq=256)
# (b)'s learning rate: Adam moves every weight by ~lr a step whatever its
# gradient, and at d_model 4096 the example's schedule (2e-4 by step 7)
# threw the loss from 11.9 to 24.2; a constant 3e-5 lowered it at first,
# then overshot, in fp32 as in bf16 (grad norm 13 -> 79-176, loss 13.1 by
# step 10); 1e-5 still kicked once (grad norm 66); 3e-6 falls smoothly
TRAIN_B = dict(layers=8, steps=10, batch=2, seq=2048, microbatches=2,
               lr=3e-6)
TRAIN_C = dict(layers=2, batch=1, seq=128)
GRAD_LEAF_RTOL = 1e-3
# (d) mamba2-370m at its published widths, all 48 layers (368 M
# parameters, 5.9 GB of master weights, moments and gradients): TRAIN_D
# ["steps"] steps with a checkpoint at TRAIN_D["every"], then a fresh
# Trainer resumed from it to the end, bit-equal to the uninterrupted run
# (B4's backward is deterministic); (e) hymba-1.5b, all 32 layers (1.34 B
# parameters, 21.5 GB); (f) each at 2 layers, one fp32 gradient on the
# card and on the CPU (seq 320: a chunk of 256 and a padded one).  All bf16
# compute over fp32 master weights, a constant learning rate after one
# warmup step.  The rates are the largest that fell without a spike in
# tools/train_lr_sweep.py (bf16; 20 steps of (d), before it was cut to
# 12, and 10 of (e)): mamba2 at 1e-3 jumped to nll 11.97 at step 4 (grad
# norm 20) and diverged at 3e-3, while 3e-4 fell 11.03 -> 10.62; hymba at
# 1e-4 jumped to 12.19 at step 3 (grad norm 55), while 3e-5 fell 10.71 ->
# 10.36.  A step takes ~1.3-1.5 s (host-bound), so (d) runs 12 steps,
# resumed at 6
TRAIN_D = dict(arch="mamba2-370m", steps=12, every=6, batch=2, seq=2048,
               microbatches=2, lr=3e-4)
TRAIN_E = dict(arch="hymba-1.5b", steps=10, batch=2, seq=2048,
               microbatches=2, lr=3e-5)
TRAIN_F = dict(layers=2, batch=1, seq=320)
# (g) gemma2-2b at its published widths cut to 2 layers (a local and a
# global one; 730 M parameters, 11.7 GB of master weights, moments and
# gradients, the 256 000-word embedding most of it): B2's backward at
# D = 256 under its softcap of 50 in bf16, at (b)'s learning rate
TRAIN_G = dict(arch="gemma2-2b", layers=2, steps=4, batch=2, seq=2048,
               microbatches=2, lr=3e-6)
# test_training_reduces_loss's margin: the last 10 steps' mean nll below
# the first 10's by this much
LOSS_MARGIN = 0.05


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout
    return out.strip().splitlines()[0]


def rand(gen, *shape, dtype=torch.float32, scale=0.5):
    x = torch.randn(shape, generator=gen, device="cuda") * scale
    return x.to(dtype)


def agreement(got: torch.Tensor, want: torch.Tensor, dtype):
    """(max absolute error, max row-relative error, within tolerance).
    A row is one output vector over the head dimension."""
    abs_err, rel_err, finite = row_rel(got, want)
    within = (abs_err <= ATOL_FP32 if dtype == torch.float32
              else rel_err <= ROW_RTOL_BF16)
    return abs_err, rel_err, within and finite


def row_rel(got: torch.Tensor, want: torch.Tensor):
    """(max absolute error, max row-relative error, all finite)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    d = got.shape[-1]
    row_max = want.abs().reshape(-1, d).amax(-1).clamp_min(1e-30)
    rel = (diff.reshape(-1, d).amax(-1) / row_max).max().item()
    return diff.max().item(), rel, bool(torch.isfinite(got).all())


def grad_agreement(got: torch.Tensor, want: torch.Tensor, dtype):
    """``agreement`` for a gradient: (max absolute error, max row-relative
    error with each row's largest |value| floored at GRAD_ROW_FLOOR of the
    tensor's, within tolerance)."""
    got, want = got.float(), want.float()
    d = got.shape[-1]
    diff = (got - want).abs().reshape(-1, d).amax(-1)
    floor = GRAD_ROW_FLOOR * want.abs().max().clamp_min(1e-30)
    row_max = torch.maximum(want.abs().reshape(-1, d).amax(-1), floor)
    rel = (diff / row_max).max().item()
    err = diff.max().item()
    within = (err <= ATOL_FP32 if dtype == torch.float32
              else rel <= ROW_RTOL_BF16)
    return err, rel, within and bool(torch.isfinite(got).all())


def tol_text(dtype) -> str:
    return (f"atol={ATOL_FP32:.0e}" if dtype == torch.float32
            else f"row_rtol={ROW_RTOL_BF16:.0e}")


def time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, from CUDA events around each group (one untimed call first).
    ``fn(i)`` gets the call's index within its group."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(inner):
            fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def graph_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """The device time of one call: ``inner`` calls captured in a CUDA
    graph, the median over ``reps`` replays (CUDA events) divided by
    ``inner``.  A replay launches the calls' kernels with no host code
    between them, so a kernel faster than its wrapper's host work reads
    its own time here, where ``time_ms`` reads the host's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)                       # warm up off the capture stream
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(inner):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def hmma_counts(build, lib: str) -> dict[str, dict[str, int]]:
    """{kernel function: {"HMMA": n, "HGMMA": m}}: the tensor-core
    instructions in its SASS for the library built from
    ``csrc/<lib>.cu``, from ``cuobjdump -sass``; HMMA is ``mma.sync``'s,
    HGMMA ``wgmma``'s."""
    text = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass", str(build.lib_path(lib))],
        check=True, capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn is not None:
            for kind in ("HGMMA", "HMMA"):
                if kind in line:
                    counts[fn][kind] += 1
    return counts


def tensor_core_text(n: dict) -> str:
    return f"{n['HMMA']:5d} HMMA {n['HGMMA']:5d} HGMMA"


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# --------------------------------------------------------------------------


def paged_inputs(gen, B, Hq, Hkv, D, page, lens, dtype, *, window=0,
                 trash_rows=(), n_pages=None, n_pool=None):
    """Random pools and a block table of distinct pages per sequence."""
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    need = max(1, (int(lens.max()) + page - 1) // page)
    n_pages = n_pages or need
    n_pool = n_pool or B * n_pages + 1
    trash = n_pool - 1
    q = rand(gen, B, Hq, D, dtype=dtype)
    kp = rand(gen, n_pool, Hkv, page, D, dtype=dtype)
    vp = rand(gen, n_pool, Hkv, page, D, dtype=dtype)
    perm = torch.randperm(n_pool - 1, generator=gen, device="cuda")
    table = perm[:B * n_pages].reshape(B, n_pages).to(torch.int32)
    for r in trash_rows:
        table[r] = trash
    if window:
        start = torch.clamp(lens - window, min=0)
    else:
        start = torch.zeros_like(lens)
    return q, kp, vp, table.contiguous(), lens, start.to(torch.int32)


def check_paged(gen, fd, ref) -> None:
    cases = [
        # name, B, Hq, Hkv, D, page, lens, softcap, window, trash rows
        ("smoke", 4, 4, 2, 32, 8, [0, 1, 13, 40], 0.0, 0, ()),
        ("smoke-trash", 4, 4, 2, 32, 8, [5, 1, 9, 2], 0.0, 0, (1, 3)),
        ("group1", 3, 4, 4, 64, 16, [7, 33, 100], 0.0, 0, ()),
        ("yi-9b", 8, 32, 4, 128, 16,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 0.0, 0, (3,)),
        ("yi-9b-softcap", 8, 32, 4, 128, 16,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 50.0, 0, ()),
        ("yi-9b-window", 8, 32, 4, 128, 16,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 0.0, 100, ()),
        ("gemma2", 4, 8, 4, 256, 16, [3, 64, 517, 1024], 50.0, 61, ()),
        ("hymba", 8, 25, 5, 64, 16,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 0.0, 0, (3,)),
        # the model families' served heads: opt-30b's and olmoe's MHA
        # (group 1, D = 128) and granite-moe's 24/8 of 64 (group 3)
        ("opt-30b", 8, 56, 56, 128, 16,
         [1, 15, 16, 17, 336, 512, 979, 2048], 0.0, 0, (3,)),
        ("olmoe-1b-7b", 8, 16, 16, 128, 16,
         [1, 15, 16, 17, 336, 512, 979, 2048], 0.0, 0, ()),
        ("granite-moe", 8, 24, 8, 64, 16,
         [1, 15, 16, 17, 336, 512, 979, 2048], 0.0, 0, (5,)),
        # yi-9b's shard-local heads (the "sharded" job): tp 2 (16 over 2,
        # a group of 8) and tp 8 (4 over one replicated KV head)
        ("yi-9b-tp2", 8, 16, 2, 128, 16,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 0.0, 0, (3,)),
        ("yi-9b-tp8", 8, 4, 1, 128, 16,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 0.0, 0, (3,)),
        # the MoE families' shard-local heads at tp 2: olmoe's 8/8 of
        # 128 and granite-moe's 12/4 of 64
        ("olmoe-tp2", 8, 8, 8, 128, 16,
         [1, 15, 16, 17, 336, 512, 979, 2048], 0.0, 0, ()),
        ("granite-moe-tp2", 8, 12, 4, 64, 16,
         [1, 15, 16, 17, 336, 512, 979, 2048], 0.0, 0, (5,)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, Hq, Hkv, D, page, lens, cap, win, trash in cases:
            q, kp, vp, tb, ln, st = paged_inputs(
                gen, B, Hq, Hkv, D, page, lens, dtype, window=win,
                trash_rows=trash)
            scale = 1.0 / D ** 0.5
            got = fd.paged_decode(q, kp, vp, tb, ln, st, cap, scale)
            torch.cuda.synchronize()
            want = ref.paged_decode_plain(q, kp, vp, tb, ln, st, cap, scale)
            err, rel, ok = agreement(got, want, dtype)
            log(f"  paged_decode {name:14s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
                f"{tol_text(dtype)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"paged_decode {name} {dtype} disagrees")


def check_paged_split(gen, fd, ref) -> None:
    """The paged decode kernel at fixed split counts (70 is more than any
    row's live pages: empty splits) against the plain split-and-combine,
    through the wrapper's private entry that takes ``n_split``: a window,
    a trash-page row, rows of 1, 15, 16 and 17 tokens and ``len == 0``
    (whose row must be zero)."""
    cases = [
        # name, B, Hq, Hkv, D, lens, softcap, window, trash rows
        ("yi-9b", 6, 32, 4, 128, [1000, 517, 0, 17, 16, 1], 30.0, 300,
         (1,)),
        ("hymba", 5, 25, 5, 64, [15, 0, 700, 16, 1], 0.0, 0, (2,)),
        ("opt-30b", 4, 56, 56, 128, [979, 0, 17, 336], 0.0, 0, (2,)),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, Hq, Hkv, D, lens, cap, win, trash in cases:
            q, kp, vp, tb, ln, st = paged_inputs(
                gen, B, Hq, Hkv, D, 16, lens, dtype, window=win,
                trash_rows=trash)
            scale = 1.0 / D ** 0.5
            zero = [i for i, n in enumerate(lens) if n == 0]
            for n_split in (1, 2, 5, 70):
                got = fd._launch_paged(q, kp, vp, tb, ln, st, cap, scale,
                                       n_split)
                torch.cuda.synchronize()
                want = ref.paged_decode_split_plain(q, kp, vp, tb, ln, st,
                                                    cap, scale, n_split)
                err, rel, ok = agreement(got, want, dtype)
                ok = (ok and fd.paged_decode.last_n_split == n_split
                      and not got[zero].float().any())
                log(f"  paged_decode {name} n_split={n_split:<3d} "
                    f"{str(dtype):14s} max_abs_err={err:.3e} "
                    f"max_row_rel_err={rel:.3e} {tol_text(dtype)} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"paged_decode {name} n_split={n_split} "
                                     f"{dtype} disagrees with the plain "
                                     "split")


def check_prefill(gen, fa, ref) -> None:
    cases = [
        # name, B, Sq, Sk, Hq, Hkv, D, causal, softcap, window
        ("smoke", 2, 24, 24, 4, 2, 32, True, 0.0, 0),
        ("yi-9b-128", 1, 128, 128, 32, 4, 128, True, 0.0, 0),
        ("yi-9b-200", 4, 200, 200, 32, 4, 128, True, 0.0, 0),
        ("yi-9b-1024", 4, 1024, 1024, 32, 4, 128, True, 0.0, 0),
        ("d64-window", 2, 256, 256, 4, 4, 64, True, 0.0, 64),
        ("gemma2-256", 1, 200, 200, 8, 4, 256, True, 50.0, 64),
        ("noncausal", 2, 100, 200, 4, 2, 64, False, 0.0, 0),
        ("hymba-200", 4, 200, 200, 25, 5, 64, True, 0.0, 0),
        ("hymba-1024", 2, 1024, 1024, 25, 5, 64, True, 0.0, 0),
        ("d32-group8", 2, 77, 77, 8, 1, 32, True, 0.0, 0),
        ("d128-ragged", 2, 65, 129, 16, 2, 128, False, 30.0, 0),
        ("d256-ragged", 1, 99, 99, 8, 4, 256, True, 50.0, 40),
        ("opt-30b-963", 1, 963, 963, 56, 56, 128, True, 0.0, 0),
        ("olmoe-1024", 2, 1024, 1024, 16, 16, 128, True, 0.0, 0),
        ("granite-200", 4, 200, 200, 24, 8, 64, True, 0.0, 0),
        ("yi-9b-tp2-1024", 2, 1024, 1024, 16, 2, 128, True, 0.0, 0),
        ("yi-9b-tp8-1024", 2, 1024, 1024, 4, 1, 128, True, 0.0, 0),
        ("olmoe-tp2-1024", 2, 1024, 1024, 8, 8, 128, True, 0.0, 0),
        ("granite-tp2-1024", 2, 1024, 1024, 12, 4, 64, True, 0.0, 0),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, Sq, Sk, Hq, Hkv, D, causal, cap, win in cases:
            q = rand(gen, B, Sq, Hq, D, dtype=dtype)
            k = rand(gen, B, Sk, Hkv, D, dtype=dtype)
            v = rand(gen, B, Sk, Hkv, D, dtype=dtype)
            got = fa.flash_attention(q, k, v, causal=causal, softcap=cap,
                                     window=win)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, causal=causal,
                                           softcap=cap, window=win)
            err, rel, ok = agreement(got, want, dtype)
            log(f"  flash_attention {name:12s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
                f"{tol_text(dtype)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"flash_attention {name} {dtype} disagrees")


def check_chunk(gen, fa, ref) -> None:
    """The prefill kernel on a chunk: C queries at positions off + [0, C)
    over the off + C keys before and in it."""
    cases = [
        # name, B, C, offset, Hq, Hkv, D, softcap, window
        ("smoke", 1, 24, 40, 4, 2, 32, 0.0, 0),
        ("yi-9b", 1, CHUNK, CHUNK_OFFSET, 32, 4, 128, 0.0, 0),
        ("yi-9b-window", 1, CHUNK, CHUNK_OFFSET, 32, 4, 128, 0.0, 100),
        ("gemma2-window", 1, CHUNK, CHUNK_OFFSET, 8, 4, 256, 50.0, 300),
        ("hymba-ragged", 2, 100, 77, 25, 5, 64, 0.0, 0),
        ("opt-30b", 1, CHUNK, CHUNK_OFFSET, 56, 56, 128, 0.0, 0),
        ("olmoe-1b-7b", 1, CHUNK, CHUNK_OFFSET, 16, 16, 128, 0.0, 0),
        ("granite-ragged", 2, 100, 77, 24, 8, 64, 0.0, 0),
        ("yi-9b-tp2", 1, CHUNK, CHUNK_OFFSET, 16, 2, 128, 0.0, 0),
        ("yi-9b-tp8", 1, CHUNK, CHUNK_OFFSET, 4, 1, 128, 0.0, 0),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, C, off, Hq, Hkv, D, cap, win in cases:
            q = rand(gen, B, C, Hq, D, dtype=dtype)
            k = rand(gen, B, off + C, Hkv, D, dtype=dtype)
            v = rand(gen, B, off + C, Hkv, D, dtype=dtype)
            got = fa.flash_attention(q, k, v, softcap=cap, window=win,
                                     q_offset=off)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v, softcap=cap, window=win,
                                           q_offset=off)
            err, rel, ok = agreement(got, want, dtype)
            # the device-offset form (the chunk graph's): one int32 scalar,
            # one per row, and per-row offsets that differ, each bit-equal
            # to the by-value form
            offs = [off - 7 * b for b in range(B)]
            dev = {"scalar": torch.tensor(off, dtype=torch.int32,
                                          device="cuda"),
                   "rows": torch.full((B,), off, dtype=torch.int32,
                                      device="cuda")}
            same = {f: torch.equal(fa.flash_attention(
                q, k, v, softcap=cap, window=win, q_offset=t), got)
                for f, t in dev.items()}
            rows = fa.flash_attention(q, k, v, softcap=cap, window=win,
                                      q_offset=torch.tensor(
                                          offs, dtype=torch.int32,
                                          device="cuda"))
            same["distinct rows"] = all(torch.equal(
                rows[b:b + 1], fa.flash_attention(
                    q[b:b + 1], k[b:b + 1], v[b:b + 1], softcap=cap,
                    window=win, q_offset=offs[b])) for b in range(B))
            log(f"  flash_attention q_offset {name:14s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
                f"{tol_text(dtype)} {'ok' if ok else 'FAIL'}; device "
                f"offset bit-equal {same}")
            if not ok:
                raise SystemExit(f"flash_attention q_offset {name} {dtype} "
                                 "disagrees")
            if not all(same.values()):
                raise SystemExit(f"flash_attention q_offset {name} {dtype}: "
                                 f"the device-offset form differs from the "
                                 f"by-value form: {same}")


def check_prefill_bwd(gen, fa, fab, ref) -> None:
    """B2's backward against its plain version on the same inputs (q, k,
    v, the kernel's out and lse, a random dO); the forward's lse against
    logsumexp of the plain scores; the backward twice, bit-equal."""
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, Hq, Hkv, D, cap, win in BWD_CASES:
            q = rand(gen, B, S, Hq, D, dtype=dtype)
            k = rand(gen, B, S, Hkv, D, dtype=dtype)
            v = rand(gen, B, S, Hkv, D, dtype=dtype)
            dout = rand(gen, B, S, Hq, D, dtype=dtype)
            out, lse = fa.flash_attention(q, k, v, softcap=cap, window=win,
                                          with_lse=True)
            got = fab.flash_attention_bwd(q, k, v, out, dout, lse,
                                          softcap=cap, window=win)
            again = fab.flash_attention_bwd(q, k, v, out, dout, lse,
                                            softcap=cap, window=win)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            lse_want = ref.flash_attention_lse_ref(q, k, softcap=cap,
                                                   window=win)
            lse_err = (lse - lse_want).abs().max().item()
            ok = same and bool(torch.isfinite(lse).all()) \
                and lse_err <= LSE_ATOL
            want = ref.flash_attention_bwd_plain(q, k, v, out, dout, lse,
                                                 True, cap, win)
            parts = []
            for label, g, w in zip(("dq", "dk", "dv"), got, want):
                err, rel, good = grad_agreement(g, w, dtype)
                ok = ok and good
                parts.append(f"{label} {err:.3e}/{rel:.3e}")
            log(f"  flash_attention_bwd {name:16s} {str(dtype):14s} "
                f"max_abs/row_rel {', '.join(parts)} {tol_text(dtype)}; lse "
                f"{lse_err:.3e} (atol {LSE_ATOL:.0e}); twice bit-equal "
                f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"flash_attention_bwd {name} {dtype} "
                                 "disagrees")
            del q, k, v, dout, out, lse, got, again, want


# phase 3's cases for B3's lse form: the decode plan's sequence shards
# (the prefill->decode run's 4-sequence data group over 272 of 544
# positions, the long-context run's 3072 of 12288, one past the position),
# rows that attend nothing once shifted and clipped into a shard (len <=
# start, with start in the last live tile or past it), gemma2-2b's heads
# with its softcap and a local window
LSE_CASES = [
    # name, B, S, Hq, Hkv, D, lens, starts, softcap
    ("plans-shard", 4, 272, 32, 4, 128, [272, 256, 1, 0], [0, 0, 0, 0], 0.0),
    ("long-shard", 1, 3072, 32, 4, 128, [2065], [0], 0.0),
    ("long-past-pos", 1, 3072, 32, 4, 128, [0], [0], 0.0),
    ("empty-rows", 4, 300, 32, 4, 128, [100, 300, 45, 40], [200, 299, 40, 45],
     0.0),
    ("gemma2-window", 4, 1030, 8, 4, 256, [3, 64, 517, 1030],
     [0, 3, 456, 969], 50.0),
]


def check_dense_lse(gen, fd, ref) -> None:
    """B3 with ``with_lse`` against its plain version on LSE_CASES, fp32
    and bf16, by the wrapper's split count and at fixed ones (1, 3 and 40
    splits: the loop writes the lse, then the combine does): the output
    within B3's limits and bit-equal to the kernel's without the lse, the
    lse within LSE_ATOL of the plain version's where a row attends
    something, and zeros and -inf where it attends nothing."""
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, Hq, Hkv, D, lens, starts, cap in LSE_CASES:
            q, k, v, ln, _ = dense_inputs(gen, B, S, Hq, Hkv, D, lens, dtype)
            st = torch.tensor(starts, dtype=torch.int32, device="cuda")
            scale = 1.0 / D ** 0.5
            want, want_lse = ref.flash_decode_plain(q, k[0], v[0], ln, st,
                                                    cap, scale, with_lse=True)
            live = want_lse > -torch.inf
            plain = fd.flash_decode(q, k[0], v[0], ln, st, cap, scale)
            for n_split in (None, 1, 3, 40):
                if n_split is None:
                    got, lse = fd.flash_decode(q, k[0], v[0], ln, st, cap,
                                               scale, with_lse=True)
                else:
                    got, lse = fd._launch(q, k[0], v[0], ln, st, cap, scale,
                                          n_split, with_lse=True)
                torch.cuda.synchronize()
                err, rel, ok = agreement(got, want, dtype)
                lse_err = float((lse - want_lse)[live].abs().max()) \
                    if live.any() else 0.0
                same = torch.equal(got, plain if n_split is None else
                                   fd._launch(q, k[0], v[0], ln, st, cap,
                                              scale, n_split))
                empty = (bool((lse[~live] == -torch.inf).all())
                         and not got[~live[..., None].expand_as(got)].any())
                ok = ok and same and empty and lse_err <= LSE_ATOL
                log(f"  flash_decode lse {name:14s} n_split="
                    f"{'auto' if n_split is None else n_split:<4} "
                    f"{str(dtype):14s} max_abs_err={err:.3e} "
                    f"max_row_rel_err={rel:.3e} lse_err={lse_err:.3e} "
                    f"(atol {LSE_ATOL:.0e}) empty rows "
                    f"{int((~live).sum())} zero/-inf {empty} out == no-lse "
                    f"out {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"flash_decode lse {name} {dtype} "
                                     f"n_split {n_split} disagrees")


def dense_inputs(gen, B, S, Hq, Hkv, D, lens, dtype, *, window=0, rot=1):
    """q, ``rot`` dense caches [rot, B, S, Hkv, D] each of K and V, lens
    and start (the last ``window`` positions when ``window`` > 0)."""
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    q = rand(gen, B, Hq, D, dtype=dtype)
    k = rand(gen, rot, B, S, Hkv, D, dtype=dtype)
    v = rand(gen, rot, B, S, Hkv, D, dtype=dtype)
    start = (torch.clamp(lens - window, min=0) if window
             else torch.zeros_like(lens))
    return q, k, v, lens, start.to(torch.int32)


def check_dense(gen, fd, ref) -> None:
    cases = [
        # name, B, S, Hq, Hkv, D, lens, softcap, window
        ("smoke-len0", 4, 40, 4, 2, 32, [0, 1, 13, 40], 0.0, 0),
        ("ragged-s", 3, 1000, 8, 2, 64, [1, 999, 1000], 0.0, 0),
        ("yi-9b", 8, 2048, 32, 4, 128,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 0.0, 0),
        ("yi-9b-window", 8, 2048, 32, 4, 128,
         [1, 15, 16, 17, 300, 1000, 1500, 2048], 0.0, 100),
        ("gemma2", 4, 1030, 8, 4, 256, [3, 64, 517, 1030], 50.0, 61),
        ("hymba", 8, 979, 25, 5, 64,
         [1, 15, 16, 17, 300, 600, 900, 979], 0.0, 0),
        # one sequence: many splits, a window that starts deep in the cache
        ("batch1-long", 1, 4000, 32, 4, 128, [4000], 0.0, 0),
        ("batch1-len1", 1, 4000, 32, 4, 128, [1], 0.0, 0),
        ("batch1-window", 1, 4000, 32, 4, 128, [3001], 0.0, 1000),
        ("batch2-gemma2", 2, 2048, 8, 4, 256, [2048, 1030], 50.0, 61),
    ]
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, S, Hq, Hkv, D, lens, cap, win in cases:
            q, k, v, ln, st = dense_inputs(gen, B, S, Hq, Hkv, D, lens,
                                           dtype, window=win)
            scale = 1.0 / D ** 0.5
            got = fd.flash_decode(q, k[0], v[0], ln, st, cap, scale)
            torch.cuda.synchronize()
            want = ref.flash_decode_plain(q, k[0], v[0], ln, st, cap, scale)
            err, rel, ok = agreement(got, want, dtype)
            log(f"  flash_decode {name:14s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
                f"{tol_text(dtype)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"flash_decode {name} {dtype} disagrees")


def check_split(gen, fd, ref) -> None:
    """The dense decode kernel at fixed split counts (40 is more than any
    row's live tiles: empty splits) against the plain split-and-combine,
    through the wrapper's private entry that takes ``n_split``."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, ln, st = dense_inputs(gen, 3, 1000, 32, 4, 128,
                                       [1000, 517, 0], dtype, window=300)
        scale = 1.0 / 128 ** 0.5
        for n_split in (1, 2, 5, 40):
            got = fd._launch(q, k[0], v[0], ln, st, 30.0, scale, n_split)
            torch.cuda.synchronize()
            want = ref.flash_decode_split_plain(q, k[0], v[0], ln, st, 30.0,
                                                scale, n_split)
            err, rel, ok = agreement(got, want, dtype)
            ok = ok and not got[2].float().any()
            log(f"  flash_decode n_split={n_split:<3d} {str(dtype):14s} "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
                f"{tol_text(dtype)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"flash_decode n_split={n_split} {dtype} "
                                 "disagrees with the plain split")


def ssd_inputs(gen, B, Nc, Q, H, P, N, G):
    """x, dt (in softplus's range at init), A < 0 and per-group B/C."""
    x = rand(gen, B, Nc, Q, H, P, scale=0.3)
    dt = rand(gen, B, Nc, Q, H, scale=0.05).abs() + 0.01
    A = -rand(gen, H, scale=1.0).abs()
    Bm = rand(gen, B, Nc, Q, G, N, scale=0.3)
    Cm = rand(gen, B, Nc, Q, G, N, scale=0.3)
    return x, dt, A, Bm, Cm


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_ssd(gen, ssd, ref) -> None:
    for name, B, Nc, Q, H, P, N, G in SSD_CASES:
        x, dt, A, Bm, Cm = ssd_inputs(gen, B, Nc, Q, H, P, N, G)
        if name == "ragged-n13":
            x, dt, A, Bm, Cm = (unaligned(t) for t in (x, dt, A, Bm, Cm))
        y, S = ssd.ssd_chunk(x, dt, A, Bm, Cm)
        torch.cuda.synchronize()
        y_want, S_want = ref.ssd_chunk_plain(x, dt, A, Bm, Cm)
        for out, got, want in (("y", y, y_want), ("S", S, S_want)):
            err, rel, finite = row_rel(got, want)
            ok = finite and rel <= ROW_RTOL_SSD
            log(f"  ssd_chunk {name:12s} {out} max_abs_err={err:.3e} "
                f"max_row_rel_err={rel:.3e} row_rtol={ROW_RTOL_SSD:.0e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"ssd_chunk {name} {out} disagrees")
    # causal to the bit: a row's y does not move with the rows after it,
    # zeros (a prefill's padded last chunk) or the tokens that follow
    for name, H, P, N, n in SSD_CUT_CASES:
        x, dt, A, Bm, Cm = ssd_inputs(gen, 1, 1, 256, H, P, N, 1)
        cut = [t.clone() for t in (x, dt, Bm, Cm)]
        for t in cut:
            t[:, :, n:] = 0
        y, _ = ssd.ssd_chunk(x, dt, A, Bm, Cm)
        y_cut, _ = ssd.ssd_chunk(cut[0], cut[1], A, cut[2], cut[3])
        same = torch.equal(y[:, :, :n], y_cut[:, :, :n])
        log(f"  ssd_chunk {name:12s} rows < {n} bit-equal with zeros or "
            f"tokens after them: {same}")
        if not same:
            raise SystemExit(f"ssd_chunk {name}: a row's y moves with the "
                             "rows after it")


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")


def ssd_bwd_agreement(got, want):
    """(max absolute error, max relative error, within ROW_RTOL_SSD) of
    B4's backward (dx, ddt, dA, dB, dC) against its plain version: dx rows
    [P] and dB, dC rows [N] against their own row's largest |value|; ddt
    and dA against their tensor's largest |value| (dcs is a difference of
    two sums and cancels within a row)."""
    err = rel = 0.0
    ok = True
    for name, g, w in zip(SSD_GRADS, got, want):
        if name in ("ddt", "dA"):
            e = (g.double() - w.double()).abs().max().item()
            r = e / max(w.abs().max().item(), 1e-30)
            finite = bool(torch.isfinite(g).all())
        else:
            e, r, finite = row_rel(g, w)
        err, rel = max(err, e), max(rel, r)
        ok = ok and finite and r <= ROW_RTOL_SSD
    return err, rel, ok


def ssd_bwd_plain(ref, inputs, dy, dS):
    """The plain backward in float64 on the same inputs: its own fp32
    rounding in the suffix sums of dcs would be a large part of the 1e-4
    limit at Q = 1024."""
    return ref.ssd_chunk_bwd_plain(*(t.double() for t in (*inputs, dy, dS)))


def check_ssd_bwd(gen, ops, ssb, ref) -> None:
    """B4's backward against its plain version on SSD_CASES (random dy and
    dS; ragged-n13 with every input off a 16-byte boundary), each twice,
    bit-equal; through ``ops.ssd_chunk``'s autograd.Function with a
    strided dy and the chunk states unused (dS arrives as zeros); and the
    independence check: dy changed in rows < n leaves rows >= n of dx,
    ddt, dB and dC bit-equal."""
    for name, B, Nc, Q, H, P, N, G in SSD_CASES:
        inputs = ssd_inputs(gen, B, Nc, Q, H, P, N, G)
        dy = rand(gen, B, Nc, Q, H, P, scale=1.0)
        dS = rand(gen, B, Nc, H, P, N, scale=1.0)
        if name == "ragged-n13":
            inputs = [unaligned(t) for t in inputs]
            dy, dS = unaligned(dy), unaligned(dS)
        got = ssb.ssd_chunk_bwd(*inputs, dy, dS)
        again = ssb.ssd_chunk_bwd(*inputs, dy, dS)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        err, rel, ok = ssd_bwd_agreement(got, ssd_bwd_plain(ref, inputs, dy,
                                                            dS))
        ok = ok and same
        log(f"  ssd_chunk_bwd {name:12s} max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e} (dx/dB/dC rows, ddt/dA tensors) "
            f"rtol={ROW_RTOL_SSD:.0e}; twice bit-equal {same} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"ssd_chunk_bwd {name} disagrees")
        del inputs, got, again
    # the Function: y's gradient a strided view, S unused
    inputs = ssd_inputs(gen, 1, 2, 256, 32, 64, 128, 1)
    live = [t.clone().requires_grad_(True) for t in inputs]
    y, _ = ops.ssd_chunk(*live)
    dy = rand(gen, 1, 2, 256, 64, 32, scale=1.0).transpose(-1, -2)
    before = ssb.ssd_chunk_bwd.counter["launches"]
    y.backward(dy)
    launched = ssb.ssd_chunk_bwd.counter["launches"] - before
    dS = torch.zeros((1, 2, 32, 64, 128), device="cuda")
    err, rel, ok = ssd_bwd_agreement(
        [t.grad for t in live], ssd_bwd_plain(ref, inputs, dy.contiguous(),
                                              dS))
    ok = ok and launched == 1 and not dy.is_contiguous()
    log(f"  ssd_chunk_bwd via ops.ssd_chunk (strided dy, dS zeros) "
        f"max_abs_err={err:.3e} max_rel_err={rel:.3e}; launches {launched} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("ssd_chunk_bwd through ops.ssd_chunk disagrees")
    for name, H, P, N, n in SSD_CUT_CASES:
        inputs = ssd_inputs(gen, 1, 1, 256, H, P, N, 1)
        dy = rand(gen, 1, 1, 256, H, P, scale=1.0)
        dS = rand(gen, 1, 1, H, P, N, scale=1.0)
        dy2 = dy.clone()
        dy2[:, :, :n] = rand(gen, 1, 1, n, H, P, scale=1.0)
        got = ssb.ssd_chunk_bwd(*inputs, dy, dS)
        moved = ssb.ssd_chunk_bwd(*inputs, dy2, dS)
        same = all(torch.equal(a[:, :, n:], b[:, :, n:])
                   for i, (a, b) in enumerate(zip(got, moved)) if i != 2)
        log(f"  ssd_chunk_bwd {name:12s} rows >= {n} of dx, ddt, dB, dC "
            f"bit-equal with dy changed in the rows before: {same}")
        if not same:
            raise SystemExit(f"ssd_chunk_bwd {name}: a row's gradient moves "
                             "with dy in the rows before it")


# --------------------------------------------------------------------------
# Phases 4 and 5: the engine.
# --------------------------------------------------------------------------


def serve(cfg, params, prompts, new_tokens, device, **engine_kw):
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, device=device, **engine_kw)
    fin, wall = serve_on(eng, prompts, new_tokens)
    return fin, eng, wall


def serve_on(eng, prompts, new_tokens, rid0: int = 0):
    """Serve ``prompts`` on an existing engine as rids ``rid0 + i``:
    ({i: finished request}, wall seconds)."""
    for i, p in enumerate(prompts):
        eng.submit(rid0 + i, p, new_tokens)
    t0 = time.monotonic()
    fin = eng.run_to_completion()
    if eng.device.type != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {r.rid - rid0: r for r in fin}, wall


def serving_times(fin: dict, wall: float):
    """(each request's TTFT in s, decode tokens/s after the last first
    token) of a ``serve`` run."""
    ttft = [fin[r].t_first - fin[r].t_submit for r in fin]
    t_last_first = max(fin[r].t_first for r in fin)
    t_end = min(fin[r].t_submit for r in fin) + wall
    dec_tokens = sum(len(fin[r].generated) - 1 for r in fin)
    return ttft, dec_tokens / max(t_end - t_last_first, 1e-9)


def teacher_forced_agreement(cfg, params, prompt, generated) -> float:
    """Share of generated tokens that equal the argmax of one full forward
    over prompt + generated (greedy consistency of decode vs prefill)."""
    from repro_torch.models import forward
    from repro_torch.models.sampling import mask_padded_vocab
    seq = np.concatenate([prompt, np.asarray(generated[:-1], np.int32)])
    toks = torch.from_numpy(seq[None]).cuda()
    logits = forward(params, cfg, toks)[0, len(prompt) - 1:]
    assert torch.isfinite(logits).all(), "non-finite logits"
    pred = mask_padded_vocab(logits, cfg).argmax(-1).cpu().numpy()
    return float(np.mean(pred == np.asarray(generated)))


# the restore paths of ``migration.migrate_batch``: handoff within one
# shared pool, a copy into another pool, a relayout into a pool of half
# the page size, and re-prefill from token state
MIGRATION_PATHS = ("handoff", "copy", "relayout", "reprefill")


def migration_engines(cfg, params, device, path, **engine_kw):
    """(source, destination) engines for one restore path: one shared pool
    (handoff), two pools of the same geometry (copy, re-prefill), or a
    destination pool of half-size pages, twice as many (relayout)."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kvcache import BlockPool
    kw = dict(engine_kw)
    n, bs = kw.pop("num_blocks"), kw.pop("block_size")
    mbps = kw.pop("max_blocks_per_seq", cfg.max_seq_len // bs)
    dtype = kw.get("dtype", torch.float32)
    src_pool = BlockPool(cfg, n, bs, dtype, device)
    if path == "handoff":
        dst_pool, dst_mbps = src_pool, mbps
    elif path == "relayout":
        dst_pool = BlockPool(cfg, 2 * n, bs // 2, dtype, device)
        dst_mbps = 2 * mbps
    else:
        dst_pool, dst_mbps = BlockPool(cfg, n, bs, dtype, device), mbps
    src = ServingEngine(cfg, params, block_size=bs, pool=src_pool,
                        max_blocks_per_seq=mbps, device=device, **kw)
    dst = ServingEngine(cfg, params, block_size=dst_pool.block_size,
                        pool=dst_pool, max_blocks_per_seq=dst_mbps,
                        device=device, **kw)
    return src, dst


def serve_part_way(eng, jobs: dict, *, steps=None, after=None) -> dict:
    """Submit ``jobs`` ({rid: (prompt, new tokens)}) to ``eng`` and step it
    ``steps`` times, or until nothing waits and every request in flight
    has ``after`` tokens.  Returns the streams that finished meanwhile, by
    rid."""
    for rid, (prompt, n) in jobs.items():
        eng.submit(rid, prompt, n)
    fin, k = {}, 0
    while (k < steps if steps is not None else
           eng.waiting or any(len(r.generated) < after
                              for r in eng.active.values())):
        fin.update({r.rid: r.generated for r in eng.step()})
        k += 1
    return fin


# one ``move_inflight``: the report, the pages the snapshots held, the
# tokens a re-prefill of all of them recomputes, the perf_counter at the
# export and the stall in s
Moved = collections.namedtuple("Moved", "report pages recompute t0 stall")


def move_inflight(src, dst, path) -> Moved:
    """Export what ``src`` has in flight (with its pages, or as token state
    for re-prefill), release the source and restore the snapshots on
    ``dst`` with ``migrate_batch``.  The stall runs from the export until
    the pages are resident on the card."""
    from repro_torch.serving.migration import migrate_batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snaps = src.export_inflight(release=(path == "reprefill"))
    src.release_all()
    pages = sum(len(s.blocks) for s in snaps if s.blocks is not None)
    recompute = sum(len(s.prompt) + len(s.generated) for s in snaps)
    report = migrate_batch(dst, snaps)
    torch.cuda.synchronize()
    return Moved(report, pages, recompute, t0, time.perf_counter() - t0)


def kv_in_flight(eng) -> dict:
    """Each in-flight request's K/V gathered from ``eng``'s pages, by rid
    ({} for an attention-free pool)."""
    from repro_torch.serving.kvcache import gather_tokens
    c = eng.cache
    if c.pool.k is None:
        return {}
    return {r.rid: gather_tokens(c.pool, c.seq_blocks[s], int(c.seq_lens[s]))
            for s, r in eng.active.items()}


def serve_migrated(cfg, params, prompts, new_tokens, device, path,
                   **engine_kw):
    """The prompts served two steps on a source engine, moved by
    ``move_inflight`` and finished on a destination engine: (streams by
    rid, the migration report)."""
    src, dst = migration_engines(cfg, params, device, path, **engine_kw)
    fin = serve_part_way(src, {rid: (p, new_tokens)
                               for rid, p in enumerate(prompts)}, steps=2)
    report = move_inflight(src, dst, path).report
    fin.update({r.rid: r.generated for r in dst.run_to_completion()})
    return fin, report


def check_migrated_streams(name, cfg, params, prompts, new_tokens, device,
                           want, **engine_kw) -> None:
    """Each restore path's migrated streams equal ``want``, the same
    engine's uninterrupted streams (an attention-free model has no pages
    to re-lay out)."""
    for path in MIGRATION_PATHS:
        if path == "relayout" and not cfg.has_attn:
            continue
        got, rep = serve_migrated(cfg, params, prompts, new_tokens, device,
                                  path, **engine_kw)
        ok = got == want
        log(f"  {name} migrate {path:9s} on {device}: handoff "
            f"{rep.handoff} copied {rep.copied} reprefilled "
            f"{rep.reprefilled} requeued {rep.requeued} pages "
            f"{rep.pages_handoff + rep.pages_copied} recompute "
            f"{rep.recompute_tokens}; equal to the uninterrupted stream "
            f"{ok}")
        if not ok:
            raise SystemExit(f"{name}: the stream migrated by {path} on "
                             f"{device} differs from the uninterrupted one")


# --------------------------------------------------------------------------
# The cluster (``serving/cluster.py``): the twins of the JAX package's three
# cluster benches and a switch-and-crash scenario, written against a
# package namespace so that the parity tests run the same scenarios on the
# JAX package's cluster (``cluster_package``'s twin there), and phase 4 on
# the port's on the card and on the CPU.  Time is virtual: one unit a
# cluster tick, so every count and every TTFT/TPOT tick is exact.
# --------------------------------------------------------------------------


class TickClock:
    """Virtual time: the caller advances one unit a cluster tick."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def cluster_package(device: str):
    """The port's cluster entry points, and the options that put its
    runtime on ``device`` in fp32."""
    import types
    from repro_torch.core.types import Deployment, ReplicaConfig
    from repro_torch.serving.cluster import ClusterRuntime, RebalanceConfig
    from repro_torch.serving.faults import FaultPlan, FaultSpec
    from repro_torch.serving.router import FlowRouter
    from repro_torch.serving.telemetry import Telemetry
    return types.SimpleNamespace(
        ClusterRuntime=ClusterRuntime, RebalanceConfig=RebalanceConfig,
        FaultPlan=FaultPlan, FaultSpec=FaultSpec, FlowRouter=FlowRouter,
        Telemetry=Telemetry, ReplicaConfig=ReplicaConfig,
        Deployment=Deployment,
        kw=dict(dtype=torch.float32, device=device))


def span_plan(pkg, rcs, fractions):
    """A stand-in for a planner's span plan: a deployment and fractions."""
    import types
    return types.SimpleNamespace(deployment=pkg.Deployment(tuple(rcs)),
                                 fractions=fractions)


def cluster_tokens(rt) -> dict:
    return {r: [int(t) for t in rt.results[r].generated]
            for r in sorted(rt.results)}


def bench_rebalance_twin(pkg, cfg, params, on: bool, n_requests: int = 16,
                         seed: int = 9) -> dict:
    """``benchmarks/bench_rebalance.py``'s run: a hot spot piles the first
    half of the requests onto replica 0, which then stalls 6 ticks; every
    request has a 3-tick TPOT budget and a seeded quarter priority 1; the
    rest trickle in one a tick.  Rebalancer ``on`` or off."""
    faults = pkg.FaultPlan([pkg.FaultSpec("hotspot", 0, replica=0, steps=2),
                            pkg.FaultSpec("stall", 2, replica=0, steps=6)])
    clock = TickClock()
    tm = pkg.Telemetry(clock=clock)
    rt = pkg.ClusterRuntime(
        cfg, params, total_chips=4, blocks_per_chip=32, seqs_per_chip=8,
        block_size=8, drain_steps=1, router=pkg.FlowRouter([[0.5], [0.5]]),
        faults=faults, telemetry=tm,
        rebalance=pkg.RebalanceConfig(max_moves_per_tick=4) if on else None,
        **pkg.kw)
    rt.apply_plan(span_plan(pkg, [pkg.ReplicaConfig(1, 1)] * 2,
                            [[0.5], [0.5]]))
    rng = np.random.RandomState(seed)
    jobs = [(rng.randint(0, cfg.vocab_size, 6 + (i % 4) * 2)
             .astype(np.int32), 6 + (i % 4)) for i in range(n_requests)]
    pri = (np.random.RandomState(seed + 1).rand(n_requests)
           < 0.25).astype(int).tolist()
    upfront = n_requests // 2
    for rid in range(upfront):
        rt.submit(rid, *jobs[rid], tpot_deadline=3.0, priority=pri[rid])
    ticks, next_rid = 0, upfront
    while (rt.pending or next_rid < n_requests) and ticks < 200:
        if next_rid < n_requests:
            rt.submit(next_rid, *jobs[next_rid], tpot_deadline=3.0,
                      priority=pri[next_rid])
            next_rid += 1
        rt.step()
        clock.t += 1.0
        ticks += 1
    rep = rt.finish_span()
    hist = tm.metrics.histograms
    return {"mode": "on" if on else "off", "n_requests": n_requests,
            "total_shed": len(rt.all_shed_rids),
            "completed": len(rt.results), "ticks": ticks,
            "ttft_p95_ticks": hist["ttft_s"].summary()["p95"],
            "tpot_p95_ticks": hist["tpot_s"].summary()["p95"],
            "rebalanced": rep.rebalanced, "preempted": rep.preempted,
            "handoff": rep.rebalance.handoff,
            "requeued": rep.rebalance.requeued,
            "recompute_tokens": rep.rebalance.recompute_tokens,
            "tokens": cluster_tokens(rt)}


def bench_disagg_twin(pkg, cfg, params, disagg: bool, n_requests: int = 12,
                      seed: int = 11) -> dict:
    """``benchmarks/bench_disagg.py``'s run: one burst of long-prompt
    requests on a prefill replica handing off to a decode replica, or on
    two mixed replicas."""
    rc = pkg.ReplicaConfig
    if disagg:
        rcs, fractions = [rc(2, role="prefill"), rc(2, role="decode")], \
            [[1.0], [0.0]]
    else:
        rcs, fractions = [rc(2), rc(2)], [[0.5], [0.5]]
    clock = TickClock()
    tm = pkg.Telemetry(clock=clock)
    rt = pkg.ClusterRuntime(
        cfg, params, total_chips=4, blocks_per_chip=32, seqs_per_chip=2,
        block_size=8, drain_steps=1, router=pkg.FlowRouter(fractions),
        telemetry=tm, **pkg.kw)
    rt.apply_plan(span_plan(pkg, rcs, fractions))
    rng = np.random.RandomState(seed)
    jobs = [(rng.randint(0, cfg.vocab_size, 24 + (i % 4) * 6)
             .astype(np.int32), 6 + (i % 4)) for i in range(n_requests)]
    for rid, (p, n) in enumerate(jobs):
        rt.submit(rid, p, n)
    ticks = 0
    while rt.pending and ticks < 300:
        rt.step()
        clock.t += 1.0
        ticks += 1
    rep = rt.finish_span()
    hist = tm.metrics.histograms
    return {"mode": "disagg" if disagg else "mixed",
            "n_requests": n_requests, "completed": len(rt.results),
            "shed": len(rt.all_shed_rids), "ticks": ticks,
            "ttft_p95_ticks": hist["ttft_s"].summary()["p95"],
            "tpot_p95_ticks": hist["tpot_s"].summary()["p95"],
            "handoffs": rep.handoffs, "handoff_path": rep.handoff.handoff,
            "handoff_pages": rep.handoff.pages_handoff,
            "recompute_tokens": rep.handoff.recompute_tokens,
            "prefill_tokens": rt.total_prefill_tokens,
            "prompt_tokens": sum(len(p) for p, _ in jobs),
            "role_util": rep.role_util, "tokens": cluster_tokens(rt)}


def bench_recovery_twin(pkg, cfg, params, mode: str, ctx_len: int = 448,
                        batch: int = 2, new_tokens: int = 16) -> dict:
    """One round of ``benchmarks/bench_recovery.py``: 2 x ``batch``
    requests of ``ctx_len`` tokens over two replicas, a prefill and one
    decode step, then replica 0 dies with its pages kept (``handoff``) or
    lost (``reprefill``); the report's counts and the finished streams."""
    block = 8
    per_seq = (ctx_len + new_tokens) // block + 2
    rt = pkg.ClusterRuntime(
        cfg, params, total_chips=2, blocks_per_chip=2 * batch * per_seq,
        seqs_per_chip=2 * batch, block_size=block, drain_steps=0,
        router=pkg.FlowRouter([[0.5], [0.5]]), **pkg.kw)
    rt.apply_plan(span_plan(pkg, [pkg.ReplicaConfig(1, 1)] * 2,
                            [[0.5], [0.5]]))
    rng = np.random.RandomState(0)
    victims = []
    for rid in range(2 * batch):
        prompt = rng.randint(0, cfg.vocab_size, ctx_len).astype(np.int32)
        if rt.submit(rid, prompt, new_tokens) == 0:
            victims.append(rid)
    rt.step()
    rt.step()
    report = rt.fail_replica(0, lose_pages=(mode == "reprefill"))
    rt.run_until_idle()
    return {"mode": mode, "recovered": len(victims),
            "handoff": report.handoff, "reprefilled": report.reprefilled,
            "pages_handoff": report.pages_handoff,
            "recompute_tokens": report.recompute_tokens,
            "dropped": report.dropped, "tokens": cluster_tokens(rt)}


def switch_crash_twin(pkg, cfg, params, lose_pages: bool = True,
                      **cluster_kw) -> dict:
    """The smoke twin of phase 5's cluster job: 8 requests of two types on
    [2, 1, 1] chips; after 3 ticks a switch to [2, 2] (replica 1 rebuilt,
    replica 2 dropped: their requests move), 2 ticks later replica 1 dies
    (pages kept or lost), and the cluster runs to idle.  Returns the
    streams and everything the runtime reports."""
    rc = pkg.ReplicaConfig
    rt = pkg.ClusterRuntime(
        cfg, params, total_chips=4, blocks_per_chip=32, seqs_per_chip=4,
        block_size=8, drain_steps=0,
        router=pkg.FlowRouter([[0.5, 0.5], [0.25, 0.25], [0.25, 0.25]]),
        **pkg.kw, **cluster_kw)
    rt.apply_plan(span_plan(pkg, [rc(2), rc(1), rc(1)],
                            [[0.5, 0.5], [0.25, 0.25], [0.25, 0.25]]))
    rng = np.random.RandomState(3)
    for rid in range(8):
        prompt = rng.randint(0, cfg.vocab_size, 6 + 3 * rid).astype(np.int32)
        rt.submit(rid, prompt, 20 + rid % 3, type_id=rid % 2)
    for _ in range(3):
        rt.step()
    switch = rt.apply_plan(span_plan(pkg, [rc(2), rc(2)],
                                     [[0.5, 0.5], [0.5, 0.5]]))
    spans = [rt.finish_span()]
    rt.step()
    rt.step()
    prefill_before = rt.total_prefill_tokens
    recovery = rt.fail_replica(1, lose_pages=lose_pages)
    rt.run_until_idle()
    spans.append(rt.finish_span())
    return {"tokens": cluster_tokens(rt),
            "switch": dataclasses.asdict(switch),
            "recovery": dataclasses.asdict(recovery),
            "spans": [span_fields(s) for s in spans],
            "prefill_before_crash": prefill_before,
            "prefill_tokens": rt.total_prefill_tokens,
            "shed": list(rt.all_shed_rids),
            "pool": (rt.pool.allocator.n_free, rt.pool.reserved)}


def span_fields(rep) -> dict:
    """A ``SpanReport`` as plain values (numpy arrays as lists)."""
    out = {}
    for f in dataclasses.fields(rep):
        v = getattr(rep, f.name)
        if dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif isinstance(v, np.ndarray):
            v = v.tolist()
        out[f.name] = v
    return out


# phase 4's smoke configs: the dense and SSM families, then the families
# ported since (MoE, biases and GELU, sinusoidal positions, qk-norm, the
# audio stub served from codebook ids); and the models whose 2-layer full
# width runs every mode on the card in fp32
SMOKE_ARCHS = ("yi-9b", "gemma2-2b", "mamba2-370m", "hymba-1.5b",
               "olmoe-1b-7b", "granite-moe-3b-a800m", "opt-30b",
               "starcoder2-3b", "qwen1.5-110b", "chameleon-34b",
               "musicgen-medium")
TWO_LAYER_ARCHS = ("yi-9b", "hymba-1.5b", "mamba2-370m")
# phase 4's engine modes: paged decode at horizons 1 and 8, the dense
# decode mode, chunked prefill (8-token chunks on the smoke configs) and
# the prefix cache (the SSM models ignore the last two: they prefill
# one-shot and cache nothing)
SMOKE_MODES = {
    "H=1": dict(decode_horizon=1),
    "H=8": dict(decode_horizon=8),
    "dense": dict(decode_mode="dense"),
    "chunked": dict(decode_horizon=8, prefill_chunk_tokens=8),
    "prefix": dict(decode_horizon=8, prefix_cache=True),
}


def prefix_prompts(cfg, seed: int, template: int, tail: int, n: int
                   ) -> list:
    """A shared-template job: ``n - 1`` prompts of one ``template``-token
    template and a unique ``tail``-token tail, then request 0's prompt
    again (a retry: the cache covers it whole, so it diverges inside its
    last page by copy-on-write)."""
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, cfg.vocab_size, template).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(0, cfg.vocab_size, tail)
                               .astype(np.int32)]) for _ in range(n - 1)]
    return prompts + [prompts[0].copy()]


def prefix_counts(cfg, prompts, block_size: int) -> dict:
    """What the prefix cache must count on a ``prefix_prompts`` job served
    as ``serve_prefix_job`` serves it, from the prompts: request 0 misses
    and prefills whole; each tail request attaches the template's full
    pages and prefills the rest; the retry attaches all but its last token.
    ``b2_forwards`` is the prefill forwards with the cache off (request 0,
    then the rest in one group) and on (one a request)."""
    n, total = len(prompts), len(prompts[0])
    shared = 0
    while (shared < total and prompts[0][shared] == prompts[1][shared]):
        shared += 1
    page_hit = shared // block_size * block_size
    tails = n - 2
    return dict(prefill_off=n * total,
                prefill_on=total + tails * (total - page_hit) + 1,
                hits=n - 1, misses=1,
                hit_tokens=tails * page_hit + total - 1,
                b2_forwards_off=2, b2_forwards_on=n)


def serve_prefix_job(cfg, params, prompts, new_tokens, device,
                     after_first=None, **engine_kw):
    """Serve a shared-template job: request 0 alone until its first token
    (its pages are then in the index), then the others together;
    ``after_first(engine)`` is called in between.  Returns the finished
    requests by rid, the engine and the wall in s."""
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, device=device, **engine_kw)
    t0 = time.monotonic()
    eng.submit(0, prompts[0], new_tokens)
    fin = {r.rid: r for r in eng.step()}
    if after_first is not None:
        after_first(eng)
    for rid, p in enumerate(prompts[1:], 1):
        eng.submit(rid, p, new_tokens)
    fin.update({r.rid: r for r in eng.run_to_completion()})
    if device != "cpu":
        torch.cuda.synchronize()
    return fin, eng, time.monotonic() - t0


def check_prefix_streams(name, cfg, params, device, prompts, new_tokens,
                         **engine_kw) -> dict:
    """A shared-template job gives the same streams with the prefix cache
    on and off; for an attention-only model the cache must hit every
    request after the first.  Returns the streams."""
    t0 = time.monotonic()
    out = {}
    for cache in (False, True):
        fin, eng, _ = serve_prefix_job(cfg, params, prompts, new_tokens,
                                       device, prefix_cache=cache,
                                       **engine_kw)
        out[cache] = ({r: fin[r].generated for r in fin},
                      eng.load_stats())
    stats = out[True][1]
    cached = cfg.has_attn and not cfg.has_ssm
    hits_ok = (stats["prefix_hits"] == len(prompts) - 1
               and stats["prefill_tokens"] < out[False][1]["prefill_tokens"]
               if cached else stats["prefix_hits"] == 0)
    log(f"  {name} shared-template job on {device}: cache on == off "
        f"{out[True][0] == out[False][0]}; prefill_tokens "
        f"{out[False][1]['prefill_tokens']} -> {stats['prefill_tokens']}, "
        f"hits {stats['prefix_hits']} misses {stats['prefix_misses']} "
        f"hit_tokens {stats['prefix_hit_tokens']} "
        f"({time.monotonic() - t0:.1f} s)")
    if out[True][0] != out[False][0] or not hits_ok:
        raise SystemExit(f"{name}: the shared-template job on {device} "
                         "differs with the prefix cache on, or it did not "
                         "hit as it must")
    return out[True][0]


def phase_greedy() -> None:
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import init_params
    smoke_engine = dict(dtype=torch.float32, num_blocks=128, block_size=8,
                        max_seqs=4)
    for arch in SMOKE_ARCHS:
        cfg = get_smoke_config(arch)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, rng.randint(8, 24))
                   .astype(np.int32) for _ in range(6)]
        p_cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        p_gpu = _to(p_cpu, "cuda")
        runs = {}
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            for mode, kw in SMOKE_MODES.items():
                fin, eng, _ = serve(cfg, params, prompts, 12, dev,
                                    **smoke_engine, **kw)
                runs[dev, mode] = ({r: fin[r].generated for r in fin},
                                   eng.decode_syncs)
        shared = {dev: check_prefix_streams(
            cfg.name, cfg, params, dev, prefix_prompts(cfg, 4, 24, 8, 6),
            12, **smoke_engine, **SMOKE_MODES["H=8"])
            for dev, params in (("cpu", p_cpu), ("cuda", p_gpu))}
        if shared["cuda"] != shared["cpu"]:
            raise SystemExit(f"{cfg.name}: the shared-template job's tokens "
                             "differ between the card and the CPU")
        same = {m: runs["cuda", m][0] == runs["cpu", m][0]
                for m in SMOKE_MODES}
        across = all(v[0] == runs["cpu", "H=1"][0] for v in runs.values())
        log(f"  {cfg.name}: cuda == cpu tokens {same}; all modes alike "
            f"{across}; decode_syncs H=1 {runs['cuda', 'H=1'][1]} H=8 "
            f"{runs['cuda', 'H=8'][1]} chunked "
            f"{runs['cuda', 'chunked'][1]} dense {runs['cuda', 'dense'][1]}")
        if not all(same.values()) or not across:
            raise SystemExit(f"{cfg.name}: greedy tokens differ between "
                             "the card and the CPU or between modes")
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            check_migrated_streams(cfg.name, cfg, params, prompts, 12, dev,
                                   runs[dev, "H=8"][0], **smoke_engine,
                                   **SMOKE_MODES["H=8"])

    full_modes = dict(SMOKE_MODES, chunked=dict(decode_horizon=8,
                                                 prefill_chunk_tokens=64))
    for arch in TWO_LAYER_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        params = init_params(cfg, seed=1, dtype=torch.float32, device="cuda")
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (17, 40, 64, 100)]
        out = {}
        engine_kw = dict(dtype=torch.float32, num_blocks=256, block_size=16,
                         max_seqs=4, max_blocks_per_seq=16)
        for mode, kw in full_modes.items():
            fin, eng, _ = serve(cfg, params, prompts, 16, "cuda",
                                **engine_kw, **kw)
            out[mode] = {r: fin[r].generated for r in fin}
        same = {m: out[m] == out["H=1"] for m in full_modes}
        agree = min(teacher_forced_agreement(cfg, params, prompts[r],
                                             out["H=1"][r])
                    for r in out["H=1"])
        log(f"  {arch} 2-layer full width fp32: tokens equal to H=1 "
            f"{same}; teacher-forced agreement (min over requests) "
            f"{agree:.3f}")
        if not all(same.values()) or agree < 1.0:
            raise SystemExit(f"{arch}: full-width 2-layer greedy check "
                             "failed")
        job = prefix_prompts(cfg, 5, 48, 16, 4)
        shared = check_prefix_streams(f"{arch} 2-layer", cfg, params, "cuda",
                                      job, 16, **engine_kw,
                                      **full_modes["H=8"])
        agree = min(teacher_forced_agreement(cfg, params, job[r], shared[r])
                    for r in shared)
        if agree < 1.0:
            raise SystemExit(f"{arch}: the 2-layer shared-template job "
                             f"disagrees with the teacher-forced forward "
                             f"({agree:.3f})")
        check_migrated_streams(f"{arch} 2-layer", cfg, params, prompts, 16,
                               "cuda", out["H=1"], **engine_kw,
                               **full_modes["H=8"])
        del params
        torch.cuda.empty_cache()


def phase_cluster_smoke() -> None:
    """Phase 4's cluster checks on smoke configs (fp32): the twins of the
    three cluster benches on yi-9b, on the card and on the CPU, must give
    the same tokens per rid on both and the counts committed in
    ``BENCH_rebalance.json``, ``BENCH_disagg.json`` and
    ``BENCH_recovery.json`` (ticks of a virtual clock: counts, not times);
    the switch-and-crash twin on yi-9b in the dense decode mode (its pages
    lost: re-prefill) and on hymba-1.5b (its pages and SSM rows kept: a
    handoff) must give the same tokens on both and, on hymba, the tokens of
    one uninterrupted engine."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServingEngine
    t0 = time.monotonic()

    def committed(name):
        with open(os.path.join(HERE, f"BENCH_{name}.json")) as f:
            bench = json.load(f)
        return bench, {r["mode"]: r for r in bench["results"]}

    pkgs = {dev: cluster_package(dev) for dev in ("cpu", "cuda")}
    cfg = get_smoke_config("yi-9b")
    p_cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    params = {"cpu": p_cpu, "cuda": _to(p_cpu, "cuda")}
    rebalance, disagg = committed("rebalance")[1], committed("disagg")[1]
    recovery_bench, recovery = committed("recovery")
    twins = (
        [("rebalance", m, rebalance[m], lambda pk, p, m=m:
          bench_rebalance_twin(pk, cfg, p, m == "on",
                               rebalance[m]["n_requests"]))
         for m in ("off", "on")]
        + [("disagg", m, disagg[m], lambda pk, p, m=m:
            bench_disagg_twin(pk, cfg, p, m == "disagg",
                              disagg[m]["n_requests"]))
           for m in ("mixed", "disagg")]
        + [("recovery", m, recovery[m], lambda pk, p, m=m:
            bench_recovery_twin(pk, cfg, p, m, recovery_bench["ctx_len"],
                                recovery_bench["batch"],
                                recovery_bench["new_tokens"]))
           for m in ("handoff", "reprefill")])
    for bench, mode, want, run in twins:
        got = {dev: run(pkgs[dev], params[dev]) for dev in pkgs}
        keys = [k for k in want if k in got["cuda"] and k != "mode"]
        counts = {k: got["cuda"][k] for k in keys}
        same = got["cuda"]["tokens"] == got["cpu"]["tokens"]
        exact = counts == {k: want[k] for k in keys} and all(
            got["cpu"][k] == got["cuda"][k] for k in keys)
        log(f"  cluster bench_{bench} {mode}: {counts}; equal to "
            f"BENCH_{bench}.json {exact}; card tokens == CPU tokens {same}")
        if not (exact and same):
            raise SystemExit(f"bench_{bench} {mode} twin: the card's counts "
                             f"or tokens differ from the committed counts "
                             f"or the CPU's")
    for arch, lose, kw in (("yi-9b", True, dict(decode_mode="dense")),
                           ("hymba-1.5b", False, dict(decode_horizon=4))):
        cfg = get_smoke_config(arch)
        p_cpu = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
        params = {"cpu": p_cpu, "cuda": _to(p_cpu, "cuda")}
        got = {dev: switch_crash_twin(pkgs[dev], cfg, params[dev],
                                      lose_pages=lose, **kw)
               for dev in pkgs}
        g = got["cuda"]
        same = {k: g[k] == got["cpu"][k] for k in g}
        # one engine serving the same jobs without interruption
        ref = ServingEngine(cfg, params["cuda"], num_blocks=256,
                            block_size=8, max_seqs=8, device="cuda", **kw)
        rng = np.random.RandomState(3)
        for rid in range(8):
            ref.submit(rid, rng.randint(0, cfg.vocab_size, 6 + 3 * rid)
                       .astype(np.int32), 20 + rid % 3)
        want = {r.rid: [int(t) for t in r.generated]
                for r in ref.run_to_completion()}
        sw, rec = g["switch"], g["recovery"]
        path = "reprefilled" if lose else "handoff"
        ok = (all(same.values()) and g["tokens"] == want
              and not sw["rolled_back"] and sw["handoff"] == sw["migrated"]
              and rec[path] >= 1 and g["pool"] == (128, 0))
        log(f"  cluster switch+crash {arch} {kw}: switch changed "
            f"{sw['changed']} handoff {sw['handoff']} ({sw['pages_handoff']} "
            f"pages); crash with pages {'lost' if lose else 'kept'}: "
            f"handoff {rec['handoff']} reprefilled {rec['reprefilled']} "
            f"recompute {rec['recompute_tokens']}; card == CPU "
            f"{all(same.values())}; equal to one uninterrupted engine "
            f"{g['tokens'] == want}; pool free/reserved {g['pool']}")
        if not ok:
            raise SystemExit(f"{arch}: the smoke switch-and-crash cluster "
                             f"run failed its checks ({same})")
    log(f"  cluster checks took {time.monotonic() - t0:.1f} s")


# phase 5's "cluster" job (yi-9b, after the prefix runs, on the same
# weights): 16 prompts of 128-1024 tokens, two request types, 32 new tokens
# each, over 4 virtual chips of 512 pages (the 2048 16-token pages the
# phase's other runs use) and 8 slots each.  Plan A is [2, 1, 1] chips,
# plan B [2, 2]; the switch and the first crash come when every request
# has CLUSTER_AFTER[0] tokens, the second crash at CLUSTER_AFTER[1].
CLUSTER_MODELS = ("yi-9b",)
CLUSTER_JOB = dict(n=16, new_tokens=32)
CLUSTER_AFTER = (8, 16)
CLUSTER_RUNTIME = dict(total_chips=4, blocks_per_chip=512, seqs_per_chip=8,
                       block_size=16, decode_horizon=8, drain_steps=1,
                       dtype=torch.bfloat16, device="cuda")
PLAN_A = ((2, 1, 1), [[0.5, 0.5], [0.25, 0.25], [0.25, 0.25]])
PLAN_B = ((2, 2), [[0.5, 0.5], [0.5, 0.5]])


def cluster_prompts(cfg) -> list:
    rng = np.random.RandomState(1)
    lens = rng.randint(128, 1025, CLUSTER_JOB["n"])
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def _cluster(pkg, cfg, params, chips, fractions, roles=None):
    """A phase-5 runtime with telemetry on the host clock, its plan
    applied."""
    roles = roles or ["mixed"] * len(chips)
    tm = pkg.Telemetry()
    rt = pkg.ClusterRuntime(cfg, params, router=pkg.FlowRouter(fractions),
                            telemetry=tm, **CLUSTER_RUNTIME)
    report = rt.apply_plan(span_plan(
        pkg, [pkg.ReplicaConfig(c, role=r) for c, r in zip(chips, roles)],
        fractions))
    return rt, tm, report


def _serve_until(rt, rids, k) -> None:
    """Step until every request has ``k`` tokens or has finished."""
    while any(len(rt.request_log[r].emitted) < k and r not in rt.results
              for r in rids):
        rt.step()


def _held(rt, rids) -> dict:
    """{rid: tokens} of the requests each replica holds, by replica."""
    return {h.index: {r.rid: len(r.generated)
                      for r in list(h.engine.active.values())
                      + h.engine.waiting if r.rid in rids}
            for h in rt.replicas if not h.dead}


def _next_token_ms(rt, had: dict, t0: float) -> float:
    """Step until each rid of ``had`` ({rid: tokens}) has one more token;
    ms since ``t0``."""
    while any(len(rt.request_log[r].emitted) <= n and r not in rt.results
              for r, n in had.items()):
        rt.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _cluster_numbers(rt, tm, wall, t_end, prompts, counts) -> tuple:
    """(the run's log line of times and launches, its streams by rid,
    whether every request finished with all its tokens)."""
    streams = {r: rt.results[r].generated for r in sorted(rt.results)}
    full = (sorted(streams) == list(range(len(prompts)))
            and all(len(t) == CLUSTER_JOB["new_tokens"]
                    for t in streams.values()))
    ttft = tm.metrics.histograms["ttft_s"]
    firsts = [e.ts for e in tm.tracer.events if e.kind == "first_token"]
    dec = sum(len(t) - 1 for t in streams.values())
    rate = dec / max(t_end - max(firsts), 1e-9) if firsts else 0.0
    return (f"wall {wall:.3f} s  TTFT mean {ttft.mean * 1e3:.1f} ms max "
            f"{ttft.max * 1e3:.1f} ms  decode {rate:.1f} tok/s (after the "
            f"last first token)  launches {counts}"), streams, full


def phase_cluster(ops, cfg, params) -> list[str]:
    """The "cluster" job at full width, three runs on one set of weights:
    a switch from plan A to plan B mid-flight, two crashes under plan A
    (pages kept, then lost), and disaggregated prefill/decode against two
    mixed replicas.  Each run resets the launch counters first and must
    launch the paged decode and prefill kernels, finish every request with
    32 tokens, meet the teacher-forced agreement and leave the pool whole;
    each has its exact counts.  Returns the checks that failed."""
    t_start = time.monotonic()
    pkg = cluster_package("cuda")
    prompts = cluster_prompts(cfg)
    rids = list(range(len(prompts)))
    total_prompt = sum(len(p) for p in prompts)
    new = CLUSTER_JOB["new_tokens"]
    card = card_line()
    failed = []

    def submit_all(rt):
        for rid, p in enumerate(prompts):
            rt.submit(rid, p, new, type_id=rid % 2)

    def finish(name, rt, tm, t0, exact):
        rt.run_until_idle()
        torch.cuda.synchronize()
        t_end = time.monotonic()
        counts = ops.launch_counts()
        line, streams, full = _cluster_numbers(rt, tm, t_end - t0, t_end,
                                               prompts, counts)
        per_req = [teacher_forced_agreement(cfg, params, prompts[r],
                                            streams[r])
                   for r in sorted(streams)] if full else [0.0]
        agree = float(np.mean(per_req))
        pool = rt.pool
        whole = (pool.allocator.n_free == pool.num_blocks
                 and pool.reserved == 0)
        launched = counts["paged_decode"] > 0 and counts["flash_attention"] > 0
        log(f"  [cluster {name}] {line}")
        log(f"  [cluster {name}] 16 requests x 32 tokens {full}; pool "
            f"{pool.allocator.n_free}/{pool.num_blocks} free, reserved "
            f"{pool.reserved}; B1 and B2 launched {launched}; exact counts "
            f"{exact}; teacher-forced agreement (bf16) {agree:.4f}, min "
            f"{min(per_req):.4f}; limit {MIN_TEACHER_FORCED}; {card}")
        if not (full and whole and launched and exact):
            failed.append(f"{cfg.name} cluster {name}: a check failed (32 "
                          f"tokens each {full}, pool whole {whole}, B1/B2 "
                          f"launched {launched}, exact counts {exact})")
        if agree < MIN_TEACHER_FORCED:
            failed.append(f"{cfg.name} cluster {name}: decode agrees with "
                          f"the teacher-forced forward on {agree:.4f} of "
                          f"the tokens, under {MIN_TEACHER_FORCED}")
        return streams, tm.metrics.histograms["ttft_s"]

    # switch: plan A until every request has 8 tokens, then plan B
    ops.reset_launch_counts()
    t0 = time.monotonic()
    rt, tm, _ = _cluster(pkg, cfg, params, *PLAN_A)
    submit_all(rt)
    _serve_until(rt, rids, CLUSTER_AFTER[0])
    held = _held(rt, rids)
    moving = {r: n for k in (1, 2) for r, n in held[k].items()}
    torch.cuda.synchronize()
    t_switch = time.perf_counter()
    report = rt.apply_plan(span_plan(
        pkg, [pkg.ReplicaConfig(c) for c in PLAN_B[0]], PLAN_B[1]))
    torch.cuda.synchronize()
    stall = (time.perf_counter() - t_switch) * 1e3
    if report.rolled_back:
        failed.append(f"{cfg.name} cluster switch rolled back: "
                      f"{report.failure}")
        log(f"  [cluster switch] rolled back: {report.failure}")
    exact = (not report.rolled_back
             and report.handoff == report.migrated
             == len(moving) - report.drained
             and report.requeued == report.reprefilled == 0
             and report.recompute_tokens == 0)
    log(f"  [cluster switch] plan A {PLAN_A[0]} -> B {PLAN_B[0]} chips at "
        f">= {CLUSTER_AFTER[0]} tokens: {len(moving)} requests on replicas "
        f"1-2, drained {report.drained}, handoff {report.handoff} "
        f"({report.pages_handoff} pages), reprefilled {report.reprefilled}, "
        f"recompute {report.recompute_tokens}, rolled back "
        f"{report.rolled_back}; switch stall {stall:.3f} ms "
        f"(apply_plan, synchronized); {card}")
    finish("switch", rt, tm, t0, exact
           and rt.total_prefill_tokens == total_prompt)

    # crash: replica 1 dies with its pages kept at 8 tokens, replica 2
    # with its pages lost at 16
    ops.reset_launch_counts()
    t0 = time.monotonic()
    rt, tm, _ = _cluster(pkg, cfg, params, *PLAN_A)
    submit_all(rt)
    before, exact = {}, True
    for k, lose, after in ((1, False, CLUSTER_AFTER[0]),
                           (2, True, CLUSTER_AFTER[1])):
        _serve_until(rt, rids, after)
        held = _held(rt, rids)[k]
        before.update({r: list(rt.request_log[r].emitted) for r in rids})
        recompute = sum(len(prompts[r]) + n for r, n in held.items())
        prefill0 = rt.total_prefill_tokens
        torch.cuda.synchronize()
        t_fail = time.perf_counter()
        rep = rt.fail_replica(k, lose_pages=lose)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t_fail) * 1e3
        next_ms = _next_token_ms(rt, held, t_fail)
        conserved = (int((rt.pool.allocator.refs > 0).sum())
                     + rt.pool.allocator.n_free == rt.pool.num_blocks)
        if lose:
            ok = (rep.reprefilled == len(held) and rep.handoff == 0
                  and rep.recompute_tokens == recompute)
            rt.run_until_idle()
            ok = ok and rt.total_prefill_tokens - prefill0 == recompute
        else:
            ok = (rep.handoff == rep.migrated == len(held)
                  and rep.recompute_tokens == 0)
        exact = exact and ok and conserved and rep.dropped == 0
        path = "re-prefill" if lose else "handoff"
        log(f"  [cluster crash] replica {k} dies at >= {after} tokens with "
            f"its pages {'lost' if lose else 'kept'}: {len(held)} requests, "
            f"handoff {rep.handoff} ({rep.pages_handoff} pages), "
            f"reprefilled {rep.reprefilled}, recompute "
            f"{rep.recompute_tokens} (want {recompute if lose else 0}), "
            f"blocks conserved {conserved}; exact {ok}; recovery stall "
            f"({path}) {ms:.3f} ms in fail_replica, {next_ms:.3f} ms until "
            f"each of its requests emitted its next token; {card}")
    streams, _ = finish("crash", rt, tm, t0, exact)
    prefix = all(streams.get(r, [])[:len(t)] == t
                 for r, t in before.items())
    log(f"  [cluster crash] every stream emitted before a crash is a "
        f"prefix of the final one {prefix}")
    if not prefix:
        failed.append(f"{cfg.name} cluster crash: a stream changed across "
                      "a recovery")

    # disagg: a prefill replica hands every context to a decode replica,
    # against two mixed replicas
    ttfts = {}
    for name, roles, fractions in (
            ("mixed", None, PLAN_B[1]),
            ("disagg", ("prefill", "decode"), [[1.0, 1.0], [0.0, 0.0]])):
        ops.reset_launch_counts()
        t0 = time.monotonic()
        rt, tm, _ = _cluster(pkg, cfg, params, PLAN_B[0], fractions, roles)
        submit_all(rt)
        rt.run_until_idle()
        span = rt.finish_span()
        stats = rt.load_stats()
        if roles:
            exact = (span.handoffs == span.handoff.handoff == len(prompts)
                     and span.handoff.recompute_tokens == 0
                     and stats[0]["handoff_out"] == len(prompts)
                     and stats[1]["handoff_in"] == len(prompts))
            log(f"  [cluster disagg] handoffs {span.handoffs} (by page "
                f"handoff {span.handoff.handoff}, {span.handoff.pages_handoff}"
                f" pages), recompute {span.handoff.recompute_tokens}, "
                f"handoff_out/in {stats[0]['handoff_out']}/"
                f"{stats[1]['handoff_in']}, role_util {span.role_util}")
        else:
            exact = span.handoffs == 0
        exact = exact and rt.total_prefill_tokens == total_prompt
        _, ttfts[name] = finish(name, rt, tm, t0, exact)
    log(f"  [cluster] TTFT mixed mean {ttfts['mixed'].mean * 1e3:.1f} ms max "
        f"{ttfts['mixed'].max * 1e3:.1f} ms, disagg mean "
        f"{ttfts['disagg'].mean * 1e3:.1f} ms max "
        f"{ttfts['disagg'].max * 1e3:.1f} ms; the cluster runs took "
        f"{time.monotonic() - t_start:.1f} s; {card}")
    return failed


# --------------------------------------------------------------------------
# The "sharded" job: replica meshes of virtual chips on the one card.
# --------------------------------------------------------------------------


# phase 5's "sharded" job, on each model's weights after its other runs:
# the paged job (PAGED, FULL_WIDTH_ENGINE) on replica meshes whose entries
# are all this card, at (tp, pp, pool pages or None for the job's); (1, 1)
# must give the model's paged run's tokens to the bit.  yi-9b: (2, 2) runs
# all 48 layers as two stages of two head shards; tp 8 puts 4 query heads
# on each shard over one of the 4 KV heads, which do not divide 8, so the
# spec replicates them (each shard keeps the KV head its query heads read)
# on a 512-page pool.  hymba-1.5b: (2, 1) keeps attention ("replicate")
# and its 25 SSM heads (tp does not divide them) on shard 0 and splits the
# MLP's 5504 in two.  mamba2-370m: (2, 2), 16 SSM heads a shard, 24 layers
# a stage, in fp32 (SHARDED_FP32).  olmoe-1b-7b: (2, 2), 32 experts a
# shard ("ep") and 8/8 heads.
# granite-moe-3b-a800m: (2, 1), every expert's ff 512 split in two ("tp")
# and 12/4 heads; its (1, 1) run is left out (the CPU tests hold tp = pp =
# 1 bit-equal for every family).  No depth is cut: co-located shards are
# views of the one weight copy.  Then the "cluster" job sharded over 8
# virtual chips (SHARDED_CLUSTER_MODELS): a switch from (tp 2) + (tp 1)
# to (tp 1) + (tp 2, pp 2) with drain window 0, so every request in
# flight moves by reshard_blocks (mamba2's by its SSM rows alone), and on
# yi-9b a crash of the tp-2 replica (pages kept, moved to the tp-1 one)
# and its repair.  The replicas share the one weight copy, so nothing is
# cut there either; a tp-1 replica's 1024 pages and 16 slots hold all 16
# requests when the other dies
SHARDED_RUNS = {
    "yi-9b": ((1, 1, None), (2, 2, None), (8, 1, 512)),
    "hymba-1.5b": ((1, 1, None), (2, 1, None)),
    "mamba2-370m": ((1, 1, None), (2, 2, None)),
    "olmoe-1b-7b": ((1, 1, None), (2, 2, None)),
    "granite-moe-3b-a800m": ((2, 1, None),),
}
# the models whose sharded runs past (tp 1, pp 1), and whose sharded
# cluster job, serve fp32 weights (the bf16 ones widened) on an fp32 pool
# and are scored against an fp32 teacher-forced forward.  mamba2-370m's
# random bf16 weights leave its logits 5.0 % from an fp32 forward of the
# same weights and 12 % of its argmaxes unlike fp32's, so a second bf16
# rounding path, however right, falls under the 90 % agreement with the
# first (tp 2 read 0.84-0.89 over five seeds where the unsharded decode
# read 0.89-0.93), while its own logits stand as far from fp32 (5.2 %)
# and in fp32 within 8e-6 of it (tools/shard_precision.py)
SHARDED_FP32 = ("mamba2-370m",)
# the runs whose shard-local shapes phase 6 times
SHARDED_TIMED = {("yi-9b", 2, 2), ("mamba2-370m", 2, 2),
                 ("olmoe-1b-7b", 2, 2), ("granite-moe-3b-a800m", 2, 1)}
# the sharded cluster job's models; the crash round and psum_compressed
# run with the first only
SHARDED_CLUSTER_MODELS = ("yi-9b", "mamba2-370m")
SHARDED_CLUSTER = dict(CLUSTER_RUNTIME, total_chips=8, blocks_per_chip=1024,
                       seqs_per_chip=16, drain_steps=0)
SHARDED_PLAN_A = (((2, 1), (1, 1)), [[0.5, 0.5], [0.5, 0.5]])
SHARDED_PLAN_B = (((1, 1), (2, 2)), [[0.25, 0.25], [0.75, 0.75]])
# psum_compressed in a world of one under NCCL: gradient leaves of odd
# sizes (a padded last block, one under a block)
PSUM_SHAPES = {"a": (3, 300), "b": (17,), "c": (4096, 1024)}


@contextlib.contextmanager
def kernel_heads(ops):
    """Record (query heads, KV heads) of every ``ops.paged_decode`` and
    ``ops.flash_attention`` call made inside, the heads H of every
    ``ops.ssd_chunk`` call, and (query heads, KV heads, cache positions S,
    lse form) of every ``ops.flash_decode`` call: the shapes the model's
    mixers hand B1, B2, B4 and B3."""
    seen = {"paged_decode": set(), "flash_attention": set(),
            "ssd_chunk": set(), "flash_decode": set()}
    pd, fa, sc = ops.paged_decode, ops.flash_attention, ops.ssd_chunk
    fdec = ops.flash_decode

    def paged(q, k_pages, *a, **kw):
        seen["paged_decode"].add((q.shape[1], k_pages.shape[1]))
        return pd(q, k_pages, *a, **kw)

    def dense(q, k, *a, **kw):
        seen["flash_decode"].add((q.shape[1], k.shape[2], k.shape[1],
                                  bool(kw.get("with_lse", False))))
        return fdec(q, k, *a, **kw)

    def prefill(q, k, *a, **kw):
        seen["flash_attention"].add((q.shape[2], k.shape[2]))
        return fa(q, k, *a, **kw)

    def ssd(x, *a, **kw):
        seen["ssd_chunk"].add(x.shape[3])      # x [B, Nc, Q, H, P]
        return sc(x, *a, **kw)

    ops.paged_decode, ops.flash_attention, ops.ssd_chunk = paged, prefill, ssd
    ops.flash_decode = dense
    try:
        yield seen
    finally:
        ops.paged_decode, ops.flash_attention, ops.ssd_chunk = pd, fa, sc
        ops.flash_decode = fdec


def mixer_kernels(cfg) -> dict:
    """Whether each serving kernel must launch on ``cfg``'s paged path (B1
    and B2 with attention, B4 with SSD layers, B3 never)."""
    return {"paged_decode": cfg.has_attn, "flash_attention": cfg.has_attn,
            "ssd_chunk": cfg.has_ssm, "flash_decode": False}


def phase_sharded(ops, cfg, params, prompts, paged_streams
                  ) -> tuple[list[str], list[dict]]:
    """The "sharded" job (see SHARDED_RUNS) on one model: the engine runs,
    then, for SHARDED_CLUSTER_MODELS, the sharded cluster and (first
    model) ``psum_compressed``.  Returns the checks that failed and the
    SHARDED_TIMED runs for phase 6's rows at their shard shapes."""
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.launch.sharding import (local_config, make_plan,
                                             pad_attention_params)
    t_start = time.monotonic()
    card = card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    failed, runs = [], []
    lens = [len(p) for p in prompts]
    need = mixer_kernels(cfg)
    wide = _to(params, torch.float32) if cfg.name in SHARDED_FP32 else None
    for tp, pp, blocks in SHARDED_RUNS[cfg.name]:
        fp32 = wide is not None and (tp, pp) != (1, 1)
        name = f"tp {tp} pp {pp}" + (" fp32" if fp32 else "")
        base = wide if fp32 else params
        plan, run_cfg = make_plan(cfg, "serve", False, 1, tp=tp, pp=pp)
        run_params = (base if run_cfg is cfg
                      else pad_attention_params(base, cfg, run_cfg))
        kw = dict(FULL_WIDTH_ENGINE, **PAGED)
        if fp32:
            kw["dtype"] = torch.float32
        if blocks:
            kw["num_blocks"] = blocks
        kw.update(mesh=make_replica_mesh([dev] * (tp * pp), tp, pp),
                  shard_plan=plan)
        serve(run_cfg, run_params, [np.arange(64, dtype=np.int32)], 4,
              "cuda", **kw)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with kernel_heads(ops) as heads:
            fin, eng, wall = serve(run_cfg, run_params, prompts, 32, "cuda",
                                   **kw)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ttft, rate = serving_times(fin, wall)
        streams = {r: fin[r].generated for r in fin}
        sm = eng.params
        local = {(c.n_q_heads, c.n_kv_heads) for c in sm.local_cfgs
                 if c.n_q_heads}
        ssm_local = {c.ssm_heads for c in sm.local_cfgs if c.ssm_heads}
        pool = (sorted({tuple(k.shape) for _, _, k in eng.cache.k})
                if cfg.has_attn else [])
        rows = (sorted({tuple(t.shape) for _, _, t in eng.cache.ssm
                        if t is not None}) if cfg.has_ssm else [])
        same = float(np.mean([a == b for r in sorted(streams)
                              for a, b in zip(streams[r],
                                              paged_streams[r])]))
        per_req = [teacher_forced_agreement(cfg, base, prompts[r],
                                            streams[r])
                   for r in sorted(streams)]
        agree = float(np.mean(per_req))
        full = (sorted(streams) == list(range(len(prompts)))
                and all(len(t) == 32 for t in streams.values()))
        launched = all((counts[k] > 0) == on for k, on in need.items())
        shapes = (heads["paged_decode"] == local
                  and heads["flash_attention"] == local
                  and heads["ssd_chunk"] == ssm_local)
        r = plan.rules
        log(f"  [sharded {cfg.name} {name}] attn {plan.attn_mode}, kv_heads "
            f"{r['kv_heads']}, experts {r['experts']}, expert_ff "
            f"{r['expert_ff']}, ssm_heads {r['ssm_heads']}, layers "
            f"{r['layers']}: shard heads {sorted(local)}, SSM heads a shard "
            f"{[h1 - h0 for h0, h1 in sm.ssm_heads]}, pool shards {pool}, "
            f"SSM row shards {rows}, {kw['num_blocks']} pages; wall "
            f"{wall:.3f} s  TTFT mean {np.mean(ttft) * 1e3:.1f} ms max "
            f"{np.max(ttft) * 1e3:.1f} ms  decode {rate:.1f} tok/s (after "
            f"the last first token)  peak mem {peak:.2f} GB; {card}")
        log(f"  [sharded {cfg.name} {name}] launches {counts}; B1 saw (Hq, "
            f"Hkv) {sorted(heads['paged_decode'])}, B2 "
            f"{sorted(heads['flash_attention'])}, B4 H "
            f"{sorted(heads['ssd_chunk'])}; tokens equal to the paged "
            f"run's {same:.4f}; teacher-forced agreement "
            f"({'fp32' if fp32 else 'bf16'}) {agree:.4f}, min "
            f"{min(per_req):.4f}; limit {MIN_TEACHER_FORCED}")
        if not (full and launched and shapes):
            failed.append(f"{cfg.name} sharded {name}: a check failed (32 "
                          f"tokens each {full}, kernels {need} launched "
                          f"{launched}, shard shapes {shapes})")
        if (tp, pp) == (1, 1) and streams != paged_streams:
            failed.append(f"{cfg.name} sharded {name}: tokens differ from "
                          f"the unsharded paged run's ({same:.4f} equal)")
        if agree < MIN_TEACHER_FORCED:
            failed.append(f"{cfg.name} sharded {name}: decode agrees with "
                          f"the teacher-forced forward on {agree:.4f} of "
                          f"the tokens, under {MIN_TEACHER_FORCED}")
        if (cfg.name, tp, pp) in SHARDED_TIMED:
            timed = tuple(k for k in ("paged_decode", "flash_attention",
                                      "ssd_chunk") if need[k])
            runs.append({"arch": cfg.name, "cfg": local_config(
                             run_cfg, sm.heads[0], sm.ssm_heads[0]),
                         "variant": Variant(
                             f"sharded {name}", dict(PAGED), (), (), timed),
                         "counts": counts, "n_req": len(fin), "lens": lens,
                         "streams": streams})
        del fin, eng, sm, run_params, base
        torch.cuda.empty_cache()
    if cfg.name in SHARDED_CLUSTER_MODELS:
        first = cfg.name == SHARDED_CLUSTER_MODELS[0]
        failed += phase_sharded_cluster(
            ops, cfg, params if wide is None else wide, crash=first)
        if first:
            failed += phase_psum(card)
    del wide
    log(f"  [sharded {cfg.name}] the job took "
        f"{time.monotonic() - t_start:.1f} s; {card}")
    return failed, runs


def phase_sharded_cluster(ops, cfg, params, crash: bool = True
                          ) -> list[str]:
    """The "cluster" job on per-replica sharded pools (SHARDED_CLUSTER):
    a switch whose moves all ride ``reshard_blocks`` (an SSM model's with
    its SSM rows), then, with ``crash``, a crash of the tp-2 replica and
    its repair.  Returns the checks that failed."""
    pkg = cluster_package("cuda")
    prompts = cluster_prompts(cfg)
    rids = list(range(len(prompts)))
    total_prompt = sum(len(p) for p in prompts)
    new = CLUSTER_JOB["new_tokens"]
    need = mixer_kernels(cfg)
    card = card_line()
    failed = []
    dtype = params["embed"].dtype
    word = {torch.bfloat16: "bf16", torch.float32: "fp32"}[dtype]
    tag = f"{cfg.name} sharded cluster" + (" fp32" if word == "fp32" else "")

    def start(plan):
        (rcs, fractions) = plan
        tm = pkg.Telemetry()
        rt = pkg.ClusterRuntime(cfg, params,
                                router=pkg.FlowRouter(fractions),
                                telemetry=tm, shard=True,
                                **dict(SHARDED_CLUSTER, dtype=dtype))
        rt.apply_plan(span_plan(pkg, [pkg.ReplicaConfig(*rc) for rc in rcs],
                                fractions))
        for rid, p in enumerate(prompts):
            rt.submit(rid, p, new, type_id=rid % 2)
        return rt, tm

    def finish(name, rt, tm, t0, exact):
        rt.run_until_idle()
        torch.cuda.synchronize()
        t_end = time.monotonic()
        counts = ops.launch_counts()
        line, streams, full = _cluster_numbers(rt, tm, t_end - t0, t_end,
                                               prompts, counts)
        per_req = [teacher_forced_agreement(cfg, params, prompts[r],
                                            streams[r])
                   for r in sorted(streams)] if full else [0.0]
        agree = float(np.mean(per_req))
        pools = [h.engine.cache.pool for h in rt.replicas if not h.dead]
        whole = all(p.allocator.n_free == p.num_blocks and p.reserved == 0
                    for p in pools)
        launched = all((counts[k] > 0) == on for k, on in need.items())
        log(f"  [{tag} {name}] {line}")
        log(f"  [{tag} {name}] 16 requests x 32 tokens {full}; pools whole "
            f"{whole}; kernels {need} launched {launched}; exact counts "
            f"{exact}; teacher-forced agreement ({word}) "
            f"{agree:.4f}, min {min(per_req):.4f}; limit "
            f"{MIN_TEACHER_FORCED}; {card}")
        if not (full and whole and launched and exact):
            failed.append(f"{tag} {name}: a check failed (32 tokens each "
                          f"{full}, pools whole {whole}, kernels launched "
                          f"{launched}, exact counts {exact})")
        if agree < MIN_TEACHER_FORCED:
            failed.append(f"{tag} {name}: decode agrees with the "
                          f"teacher-forced forward on {agree:.4f} of the "
                          f"tokens, under {MIN_TEACHER_FORCED}")
        return streams

    # switch: plan A until every request has 8 tokens, then plan B; both
    # replicas change, so every request moves between unlike meshes
    ops.reset_launch_counts()
    t0 = time.monotonic()
    rt, tm = start(SHARDED_PLAN_A)
    _serve_until(rt, rids, CLUSTER_AFTER[0])
    held = _held(rt, rids)
    moving = sum(len(v) for v in held.values())
    torch.cuda.synchronize()
    t_switch = time.perf_counter()
    rcs, fractions = SHARDED_PLAN_B
    report = rt.apply_plan(span_plan(
        pkg, [pkg.ReplicaConfig(*rc) for rc in rcs], fractions))
    torch.cuda.synchronize()
    stall = (time.perf_counter() - t_switch) * 1e3
    if report.rolled_back:
        failed.append(f"{tag} switch rolled back: {report.failure}")
    exact = (not report.rolled_back and report.changed == [0, 1]
             and report.copied == report.migrated == moving
             and report.handoff == report.reprefilled == 0
             and report.requeued == 0 and report.recompute_tokens == 0
             and report.pages_copied > 0)
    meshes = [h.engine._mesh for h in rt.replicas]
    log(f"  [{tag} switch] {SHARDED_PLAN_A[0]} -> {SHARDED_PLAN_B[0]} "
        f"(tp, pp) on 8 virtual chips at >= {CLUSTER_AFTER[0]} tokens: "
        f"chips {[m.chips for m in meshes]}; {moving} requests in flight, "
        f"copied by reshard {report.copied} ({report.pages_copied} pages), "
        f"handoff {report.handoff}, reprefilled {report.reprefilled}, "
        f"recompute {report.recompute_tokens}, rolled back "
        f"{report.rolled_back}; switch stall {stall:.3f} ms (apply_plan, "
        f"synchronized); {card}")
    finish("switch", rt, tm, t0,
           exact and rt.total_prefill_tokens == total_prompt)
    if not crash:
        return failed

    # crash: the tp-2 replica dies at 8 tokens with its pages kept; its
    # requests move to the tp-1 replica by reshard; then it is repaired
    ops.reset_launch_counts()
    t0 = time.monotonic()
    rt, tm = start(SHARDED_PLAN_A)
    _serve_until(rt, rids, CLUSTER_AFTER[0])
    held = _held(rt, rids)[0]
    before = {r: list(rt.request_log[r].emitted) for r in rids}
    chips = rt._replica_devices[0]
    torch.cuda.synchronize()
    t_fail = time.perf_counter()
    rep = rt.fail_replica(0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t_fail) * 1e3
    n_dead = len(rt.devices)
    next_ms = _next_token_ms(rt, held, t_fail)
    rt.repair_replica(0)
    repaired = (len(rt.devices) == 8 and n_dead == 8 - len(chips)
                and rt.replicas[0].engine._mesh.chips == chips)
    exact = (rep.copied == rep.migrated == len(held)
             and rep.handoff == rep.reprefilled == rep.dropped == 0
             and rep.recompute_tokens == 0 and repaired)
    log(f"  [{tag} crash] replica 0 (tp 2, chips {chips}) dies at >= "
        f"{CLUSTER_AFTER[0]} tokens with its pages kept: {len(held)} "
        f"requests, copied by reshard {rep.copied} ({rep.pages_copied} "
        f"pages), reprefilled {rep.reprefilled}, recompute "
        f"{rep.recompute_tokens}; devices {n_dead} after, repaired "
        f"{repaired}; recovery stall {ms:.3f} ms in fail_replica, "
        f"{next_ms:.3f} ms until each of its requests emitted its next "
        f"token; {card}")
    streams = finish("crash", rt, tm, t0,
                     exact and rt.total_prefill_tokens == total_prompt)
    if not all(streams.get(r, [])[:len(t)] == t for r, t in before.items()):
        failed.append(f"{tag} crash: a stream changed across the recovery")
    return failed


def phase_psum(card: str) -> list[str]:
    """``train.optimizer.psum_compressed`` in a world of one under NCCL
    (a ``FileStore`` in a fresh temporary directory) against
    ``compress_roundtrip``, to the bit."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from repro_torch.train.optimizer import (compress_roundtrip,
                                             psum_compressed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    grads = {k: rand(gen, *s, scale=1.0) for k, s in PSUM_SHAPES.items()}
    tmp = tempfile.mkdtemp()
    try:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            got = psum_compressed(grads)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            psum_compressed(grads)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = compress_roundtrip(grads)
    equal = all(torch.equal(got[k], want[k]) for k in grads)
    n = sum(g.numel() for g in grads.values())
    log(f"  [sharded psum] psum_compressed, world of 1 (NCCL), {n:,} fp32 "
        f"gradients in {len(grads)} leaves: equal to compress_roundtrip to "
        f"the bit {equal}; {ms:.3f} ms a call (host clock, one call); "
        f"{card}")
    return [] if equal else ["psum_compressed differs from "
                             "compress_roundtrip in a world of one"]


# --------------------------------------------------------------------------
# The orchestrated path: the workload predictor, ``Orchestrator.plan_span``
# and ``ClusterRuntime.apply_plan`` (phase 4's twin of ``run_real_spans`` on
# the card and the CPU, phase 5's "orchestrated" job at full width).
# --------------------------------------------------------------------------


def real_spans_twin(device: str, model: str = "llama2-70b") -> dict:
    """``serving.validation.run_real_spans`` on ``model``'s smoke config
    over 6 chips and 3 spans (fp32, seeded weights drawn on the CPU): the
    plans, the switch and span reports and the tokens per request id."""
    from repro_torch.serving.validation import run_real_spans
    outcomes, rt = run_real_spans(model=model, chips=6, n_spans=3,
                                  device=device)

    def nan_safe(x):      # the prefix hit rate of an unseen type is NaN
        if isinstance(x, dict):
            return {k: nan_safe(v) for k, v in x.items()}
        if isinstance(x, list):
            return [nan_safe(v) for v in x]
        return "nan" if isinstance(x, float) and x != x else x

    return {"plans": [(str(o.plan.deployment), o.plan.fractions,
                       o.plan.changed_replicas) for o in outcomes],
            "switches": [dataclasses.asdict(o.switch) for o in outcomes],
            "spans": [nan_safe(span_fields(o.report)) for o in outcomes],
            "tokens": cluster_tokens(rt)}


def phase_orchestrated_smoke() -> None:
    """Phase 4's orchestrated check: ``run_real_spans`` (6 chips, 3 spans)
    on llama2-70b's smoke config (a switch every span with requests in
    flight) and on the default model's, opt-30b (sinusoidal positions; one
    switch, a drained replica) gives the same plans, reports and tokens
    per rid on the card and the CPU."""
    for model in ("llama2-70b", "opt-30b"):
        t0 = time.monotonic()
        got = {dev: real_spans_twin(dev, model) for dev in ("cpu", "cuda")}
        card = got["cuda"]
        same = {k: card[k] == got["cpu"][k] for k in card}
        moved = sum(s["migrated"] for s in card["switches"])
        drained = sum(s["drained"] for s in card["switches"])
        log(f"  orchestrated run_real_spans {model} smoke: plans "
            f"{[p[0] for p in card['plans']]}; migrated {moved}, drained "
            f"{drained}; {len(card['tokens'])} requests; card == CPU "
            f"{same} ({time.monotonic() - t0:.1f} s)")
        if not all(same.values()) or len(card["tokens"]) != 18:
            raise SystemExit(f"run_real_spans {model}: the card's plans, "
                             "reports or tokens differ from the CPU's "
                             f"({same})")


# --------------------------------------------------------------------------
# The paper's evaluation (``repro_torch.benchmarks``): phase 4's
# ``bench_e2e.real_validation`` on the card and the CPU, and phase 5's
# "evaluation" job (the simulator at H100 rates, the LSTM in the loop on
# the card, ``bench_predictor`` on the card).
# --------------------------------------------------------------------------


def timeless_rows(rows: list[str]) -> list[tuple]:
    """``real_validation``'s rows without their wall-clock fields: each
    span's seconds and the latency histograms' millisecond quantiles
    (their counts stay)."""
    return [(r.split(",")[0],
             re.sub(r";p(50|95|99)=[0-9.]+ms", "", r.split(",", 2)[2]))
            for r in rows]


def real_validation_rows(device: str) -> tuple[list[str], list[tuple]]:
    """``bench_e2e.real_validation(n_spans=2)`` (opt-30b smoke, 6 chips)
    on ``device``: its rows, and the rows without their wall-clock
    fields."""
    from repro_torch.benchmarks.bench_e2e import real_validation
    rows = real_validation(n_spans=2, device=device)
    return rows, timeless_rows(rows)


def phase_evaluation_smoke(ops) -> None:
    """Phase 4's evaluation check: ``real_validation``'s rows on the card
    equal the CPU's but for the wall-clock fields, every request
    completes, and the card run launches B1 and B2 (counted from a reset
    just before it)."""
    t0 = time.monotonic()
    cpu = real_validation_rows("cpu")[1]
    ops.reset_launch_counts()
    rows, card = real_validation_rows("cuda")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    offset = counts["flash_attention_offset"]
    for r in rows:
        log(f"  [evaluation smoke] {r}")
    done = any(r.startswith("e2e-real/opt-30b/6c/total,0,completed=12/12")
               for r in rows)
    ok = (card == cpu and done and counts["paged_decode"] > 0
          and counts["flash_attention"] > 0)
    log(f"  bench_e2e.real_validation opt-30b smoke (6 chips, 2 spans): "
        f"{len(rows)} rows, card == CPU without the wall-clock fields "
        f"{card == cpu}; 12/12 completed {done}; launches B1 "
        f"{counts['paged_decode']}, B2 {counts['flash_attention']} "
        f"({offset} at a query offset), B3 {counts['flash_decode']}, B4 "
        f"{counts['ssd_chunk']} {'ok' if ok else 'FAIL'} "
        f"({time.monotonic() - t0:.1f} s)")
    if not ok:
        diff = [(c, p) for c, p in zip(card, cpu) if c != p]
        raise SystemExit(f"real_validation on the card: rows differ from the "
                         f"CPU's {diff}, or not all completed, or B1/B2 "
                         f"did not launch ({counts})")


# phase 4's MoE capacity check: one olmoe-1b-7b MoE layer at its published
# widths (d_model 2048, 64 experts of d_ff 1024, top 8) on MOE_TOKENS
# tokens in one group, fp32, at capacity factor MOE_CF (tokens drop) and
# at E / K (C = N: nothing can drop).  The tokens share a component of
# MOE_SHARED times a random direction, so the routing is skewed as a
# trained model's is (isotropic tokens spread over 64 experts so evenly
# that none overflows at 1.25)
MOE_ARCH, MOE_TOKENS, MOE_CF, MOE_SHARED = "olmoe-1b-7b", 4096, 1.25, 0.5


def moe_capacity_twin() -> dict:
    """``models.moe.moe_block``'s capacity path on the card against the
    same call on the CPU (weights and x drawn on the card from a seeded
    generator), and at a drop-free factor against ``moe_ref``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)

    def normal(shape, std, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=dtype) * std

    p = {k: v[0] for k, v in moe.init_moe(cfg, normal).items()}
    x = torch.randn((1, MOE_TOKENS, cfg.d_model), generator=gen,
                    device="cuda")
    x += MOE_SHARED * torch.randn((cfg.d_model,), generator=gen,
                                  device="cuda")
    G, C, _, keep, _ = moe.dispatch(x, p, cfg, MOE_CF)
    got = moe.moe_block(x, p, cfg, MOE_CF)
    p_cpu, x_cpu = _to(p, "cpu"), x.cpu()
    keep_cpu = moe.dispatch(x_cpu, p_cpu, cfg, MOE_CF)[3]
    want = moe.moe_block(x_cpu, p_cpu, cfg, MOE_CF)
    free = moe.moe_block(x, p, cfg, cfg.n_experts / cfg.top_k)
    oracle = moe.moe_ref(x, p, cfg)
    dropped_rows = (~keep).reshape(MOE_TOKENS, -1).any(-1)
    changed_rows = (got - oracle).abs().amax(-1).reshape(-1) > ATOL_FP32
    return {"groups": G, "capacity": C, "slots": keep.numel(),
            "dropped": int((~keep).sum()),
            "dropped_cpu": int((~keep_cpu).sum()),
            "same_drops": torch.equal(keep.cpu(), keep_cpu),
            "max_abs_err": float((got.cpu() - want).abs().max()),
            "drop_free_err": float((free - oracle).abs().max()),
            "changed_rows_are_dropped_rows": torch.equal(changed_rows,
                                                         dropped_rows),
            "finite": bool(torch.isfinite(got).all())}


def phase_moe_capacity() -> None:
    """Phase 4's MoE check: ``moe_capacity_twin``'s drops and outputs
    agree, some tokens drop, and the dropped rows are the changed ones."""
    t0 = time.monotonic()
    r = moe_capacity_twin()
    ok = (r["same_drops"] and r["dropped"] > 0 and r["finite"]
          and r["max_abs_err"] <= ATOL_FP32
          and r["drop_free_err"] <= ATOL_FP32
          and r["changed_rows_are_dropped_rows"])
    log(f"  moe_block capacity path, {MOE_ARCH} widths, {MOE_TOKENS} tokens "
        f"in {r['groups']} group, cf {MOE_CF} (C = {r['capacity']}): "
        f"dropped (token, slot) pairs card {r['dropped']} CPU "
        f"{r['dropped_cpu']} of {r['slots']}, same pattern "
        f"{r['same_drops']}; card vs CPU max_abs_err {r['max_abs_err']:.3e}; "
        f"drop-free factor vs moe_ref {r['drop_free_err']:.3e}; rows off "
        f"the oracle are the dropped rows {r['changed_rows_are_dropped_rows']}"
        f" (limit {ATOL_FP32}) {'ok' if ok else 'FAIL'} "
        f"({time.monotonic() - t0:.1f} s)")
    if not ok:
        raise SystemExit(f"moe_block's capacity path disagrees: {r}")


# phase 5's "orchestrated" job: llama2-70b at its published widths cut to
# ORCH_LAYERS layers (weights ~35 GB, pool ~4 GB on one 80 GB card),
# planned with the full 80-layer profile on ORCH_CHIPS virtual chips; the
# runtime's options; three spans alternating the validation mixes, each
# ORCH_JOB["per_span"] requests of a per-type ORCH_JOB["template"]-token
# template and a unique tail (the archetype's in_len in all), 32 new
# tokens each, two runtime steps after each submit.
ORCH_MODEL, ORCH_LAYERS, ORCH_CHIPS = "llama2-70b", 20, 6
ORCH_RUNTIME = dict(blocks_per_chip=512, seqs_per_chip=4, block_size=16,
                    drain_steps=0, prefix_cache=True,
                    dtype=torch.bfloat16, device="cuda")
ORCH_JOB = dict(spans=3, per_span=12, template=128, new_tokens=32)
# the analytic loop of ``serve_orchestrated`` (LSTM window 3, hidden 8,
# 40 epochs) on the card against the CPU, and one fit at the paper's
# defaults (window 50, hidden 32, 200 epochs) on a 300-span series
LSTM_RTOL = 1e-4
ORCH_VARIANT = Variant("orchestrated", {}, ("paged_decode",
                                            "flash_attention"),
                       ("flash_decode",), ("paged_decode",
                                           "flash_attention"))


def phase_predictor(card: str) -> list[str]:
    """The control loop's forecasting half on the card: the analytic loop
    of ``serve_orchestrated`` (12 spans, llama2-70b planning on 16 chips),
    its LSTM predictions held against the same code on the CPU, and one
    fit at the paper's defaults timed on both.  Returns failed checks."""
    import argparse
    from repro_torch import serve_orchestrated as so
    from repro_torch.core.predictor import (LSTMWorkloadPredictor,
                                            WorkloadClusterer, count_series)
    from repro_torch.serving.request import span_of, synthesize_trace
    failed = []
    t0 = time.monotonic()
    args = argparse.Namespace(model=ORCH_MODEL, chips=16, spans=12,
                              device="cuda")
    out = so.run_analytic(args, out=lambda s: log(f"  [predict] {s}"))
    cpu = so.forecast(args.spans, "cpu")
    w = out["window"]
    card_p = np.asarray(out["preds"][w:], np.float64)
    cpu_p = np.asarray(cpu["preds"][w:], np.float64)
    rel = float(np.abs(card_p - cpu_p).max() / np.abs(cpu_p).max())
    log(f"  [predict] LSTM on the card against the CPU: max relative "
        f"difference {rel:.3e} over {len(card_p)} spans (limit "
        f"{LSTM_RTOL:.0e}); train loss card {out['lstm'].train_loss:.6f} "
        f"CPU {cpu['lstm'].train_loss:.6f}; analytic loop "
        f"{time.monotonic() - t0:.1f} s")
    if not rel <= LSTM_RTOL:
        failed.append(f"LSTM predictions on the card differ from the CPU's "
                      f"by {rel:.3e}")
    reqs = synthesize_trace(300, 100, trace_id=2, seed=0)
    il = np.array([r.in_len for r in reqs])
    ol = np.array([r.out_len for r in reqs])
    _, labels = WorkloadClusterer.fit(il, ol, k=4, seed=0)
    series = count_series(labels, np.array([span_of(r) for r in reqs]), 4,
                          300)
    fits = {}
    for dev in ("cuda", "cpu"):
        lstm = LSTMWorkloadPredictor(4, window=50, hidden=32, seed=0,
                                     device=dev)
        t1 = time.perf_counter()
        loss = lstm.fit(series, epochs=200)
        if dev == "cuda":
            torch.cuda.synchronize()
        fits[dev] = (time.perf_counter() - t1, loss)
    log(f"  [predict] one fit at the paper's defaults (300 spans, window "
        f"50, hidden 32, batch 64, 200 epochs): card {fits['cuda'][0]:.3f} "
        f"s (loss {fits['cuda'][1]:.6f}), host CPU {fits['cpu'][0]:.3f} s "
        f"(loss {fits['cpu'][1]:.6f}); {card}")
    return failed


def orch_prompts(cfg, types: list) -> list:
    """The job's prompts, one per request type: the type's template, then
    a unique tail to the archetype's in_len."""
    from repro_torch.serving.validation import REAL_ARCHETYPES
    t_rng = np.random.RandomState(1)
    templates = [t_rng.randint(0, cfg.vocab_size, ORCH_JOB["template"])
                 .astype(np.int32) for _ in REAL_ARCHETYPES]
    rng = np.random.RandomState(2)
    prompts = [np.concatenate([templates[t], rng.randint(
        0, cfg.vocab_size, REAL_ARCHETYPES[t].in_len - ORCH_JOB["template"])
        .astype(np.int32)]) for t in types]
    return prompts


def _switch_accounting(tm, report, before: dict, n0: int) -> tuple:
    """(the switch's accounting holds, the re-prefilled rids) for
    ``report``: every request admitted on a torn-down replica is drained
    or migrated once, queued ones are requeued, none dropped, nothing
    copied in one pool, and the recompute equals the re-prefilled
    contexts.  ``before``: {rid: context} admitted on the torn-down
    replicas, and the queued rids under key None."""
    moves = [e for e in list(tm.tracer.events)[n0:] if e.kind == "migrate"]
    reprefilled = [e.rid for e in moves if e.data["path"] == "reprefill"]
    admitted = {r: c for r, c in before.items() if r is not None}
    ok = (report.drained + report.migrated == len(admitted)
          and report.requeued == len(before.get(None, ()))
          and report.dropped == 0
          and report.migrated == (report.handoff + report.copied
                                  + report.reprefilled)
          and report.copied == report.pages_copied == 0
          and report.recompute_tokens == sum(admitted[r]
                                             for r in reprefilled)
          and not report.rolled_back)
    return ok, reprefilled


def _torn_down(rt, plan) -> dict:
    """{rid: context} of the requests admitted on the replicas
    ``apply_plan(plan)`` will tear down, and their queued rids under
    None."""
    new = list(plan.deployment.replicas)
    out = {None: []}
    for k, h in enumerate(rt.replicas):
        if h.dead or (k < len(new) and h.rc == new[k]):
            continue
        for r in h.engine.active.values():
            out[r.rid] = len(r.prompt) + len(r.generated)
        out[None] += [r.rid for r in h.engine.waiting]
    return out


def card_step_times(cfg, params, prompt_len: int, batch: int,
                    ctx: int, num_blocks: int) -> tuple[float, float]:
    """(one request's prefill of ``prompt_len`` tokens, one decode step at
    ``batch`` sequences of ``ctx`` tokens) on one engine on the card, in
    ms: the prefill as the median wall of 3 one-token requests, the step
    as the wall after the last first token over the steps taken."""
    kw = dict(dtype=torch.bfloat16, num_blocks=num_blocks, block_size=16,
              max_seqs=batch, max_blocks_per_seq=128, decode_horizon=1)
    rng = np.random.RandomState(3)
    prompt = rng.randint(0, cfg.vocab_size, prompt_len).astype(np.int32)
    serve(cfg, params, [prompt], 2, "cuda", **kw)            # warm-up
    prefill = float(np.median([serve(cfg, params, [prompt], 1, "cuda",
                                     **kw)[2] for _ in range(3)])) * 1e3
    prompts = [rng.randint(0, cfg.vocab_size, ctx).astype(np.int32)
               for _ in range(batch)]
    new = 33
    fin, _, wall = serve(cfg, params, prompts, new, "cuda", **kw)
    _, rate = serving_times(fin, wall)
    return prefill, batch / rate * 1e3


def cost_model_text(cfg, params, prompt_len: int, ctx: int,
                    num_blocks: int) -> str:
    """The cost model's prefill of ``prompt_len`` tokens and decode step at
    B = 8, ``ctx`` tokens (``cfg``'s profile, TP = 1, ``H100_SPEC``) beside
    the card's (``card_step_times`` on an engine of ``num_blocks``
    pages)."""
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.types import H100_SPEC, ReplicaConfig
    cm = CostModel(cfg.profile(), hw=H100_SPEC)
    tp1 = ReplicaConfig(1)
    card_prefill, card_step = card_step_times(cfg, params, prompt_len, 8,
                                              ctx, num_blocks)
    return (f"cost model ({cfg.n_layers}-layer profile, "
            f"{cfg.profile().param_count:,} parameters, TP=1, H100_SPEC) "
            f"against the card: prefill of {prompt_len} tokens "
            f"{cm.measure_prefill(tp1, prompt_len) * 1e3:.2f} ms predicted, "
            f"{card_prefill:.2f} ms measured (one request, wall); decode step "
            f"at B=8, ctx {ctx}: "
            f"{cm.measure_decode_step(tp1, 8, ctx) * 1e3:.2f} ms predicted "
            f"(step_overhead {cm.step_overhead * 1e3:.1f} ms), "
            f"{card_step:.2f} ms measured")


def phase_orchestrated(ops) -> tuple[dict, list[str]]:
    """The "orchestrated" job: OServe's control loop end to end on the
    card.  The predictor (``phase_predictor``), then three spans of the
    validation mixes planned by ``Orchestrator.plan_span`` for llama2-70b
    on 6 virtual chips and switched by ``ClusterRuntime.apply_plan`` with
    requests in flight, served at full width with ORCH_LAYERS layers.  The
    launch counters are set to 0 just before the first span and read after
    the last; returns the run (for phase 6's rows) and the failed
    checks."""
    from repro_torch.configs import get_config
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.orchestrator import (Orchestrator,
                                               OrchestratorConfig)
    from repro_torch.core.types import H100_SPEC, ClusterSpec
    from repro_torch.models import init_params, param_count
    from repro_torch.serving.cluster import ClusterRuntime
    from repro_torch.serving.telemetry import Telemetry
    from repro_torch.serving.validation import (REAL_ARCHETYPES,
                                                REAL_SPAN_RATES)
    t_start = time.monotonic()
    card = card_line()
    failed = phase_predictor(card)
    full = get_config(ORCH_MODEL)
    cfg = dataclasses.replace(full, n_layers=ORCH_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n = param_count(params)
    log(f"  {ORCH_MODEL}: {cfg.n_layers} of {full.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n:,} "
        f"params, {n * 2 / 1e9:.2f} GB bf16 (init "
        f"{time.monotonic() - t0:.1f} s); planned as {full.n_layers} layers "
        f"on {ORCH_CHIPS} virtual chips")
    orch = Orchestrator(CostModel(full.profile(), hw=H100_SPEC),
                        ClusterSpec(ORCH_CHIPS, hw=H100_SPEC),
                        OrchestratorConfig(search_patience=8))
    tm = Telemetry()
    rt = ClusterRuntime(cfg, params, orch, telemetry=tm, **ORCH_RUNTIME)
    rng = np.random.RandomState(0)
    span_types = [rng.choice(4, size=ORCH_JOB["per_span"],
                             p=np.asarray(r, float) / np.sum(r))
                  for r in (REAL_SPAN_RATES[s % 2]
                            for s in range(ORCH_JOB["spans"]))]
    types = [int(t) for ts in span_types for t in ts]
    prompts = orch_prompts(cfg, types)
    new = ORCH_JOB["new_tokens"]
    # warm-up: cuBLAS handles, allocator, kernel modules
    serve(cfg, params, [prompts[0][:64]], 2, "cuda", dtype=torch.bfloat16,
          num_blocks=64, block_size=16, max_seqs=1)
    ops.reset_launch_counts()
    t_run = time.monotonic()
    rid, spans, switched, moved = 0, [], 0, 0
    for s in range(ORCH_JOB["spans"]):
        ts = time.monotonic()
        rates = REAL_SPAN_RATES[s % 2]
        ws = [a.with_rate(float(r)) for a, r in zip(REAL_ARCHETYPES, rates)]
        plan = orch.plan_span(ws)
        before = _torn_down(rt, plan)
        n0 = len(tm.tracer.events)
        torch.cuda.synchronize()
        t_sw = time.perf_counter()
        report = rt.apply_plan(plan)
        torch.cuda.synchronize()
        stall = (time.perf_counter() - t_sw) * 1e3
        ok, repref = _switch_accounting(tm, report, before, n0)
        if s > 0 and report.changed:
            switched += 1
        moved += report.migrated
        first = rid
        for t in span_types[s]:
            rt.submit(rid, prompts[rid], new, type_id=int(t))
            rid += 1
            rt.step()
            rt.step()
        if s == ORCH_JOB["spans"] - 1:
            rt.run_until_idle()
        torch.cuda.synchronize()
        span = rt.finish_span()
        wall = time.monotonic() - ts
        frac = np.array(plan.fractions)
        load = frac @ np.asarray(rates, float)
        predicted = load / max(load.sum(), 1e-9)
        achieved = np.asarray(span.tokens, float) / max(sum(span.tokens), 1)
        rec = tm.audit.records[s]
        spans.append(dict(first=first, last=rid, wall=wall,
                          tokens=sum(span.tokens)))
        log(f"  [orchestrated span {s}] rates {list(rates)}: plan "
            f"{plan.deployment} (changed {plan.changed_replicas}, predicted "
            f"switch {plan.switch_seconds:.3f} s, KV "
            f"{plan.kv_migration_seconds:.3f} s)")
        log(f"  [orchestrated span {s}] switch: rebuilt {report.changed}, "
            f"{len(before) - 1} admitted and {len(before[None])} queued on "
            f"torn-down replicas; drained {report.drained}, migrated "
            f"{report.migrated} (handoff {report.handoff}, "
            f"{report.pages_handoff} pages; copied {report.copied}; "
            f"re-prefilled {report.reprefilled} {repref}, recompute "
            f"{report.recompute_tokens}), requeued {report.requeued}, "
            f"dropped {report.dropped}, rolled back {report.rolled_back}; "
            f"accounting holds {ok}; switch stall {stall:.3f} ms "
            f"(apply_plan, synchronized)")
        log(f"  [orchestrated span {s}] {rid - first} requests, "
            f"{sum(span.tokens)} tokens in {wall:.3f} s "
            f"({sum(span.tokens) / wall:.1f} tok/s over the span), completed "
            f"{span.completed}; predicted replica share "
            f"{np.round(predicted, 3).tolist()}, achieved "
            f"{np.round(achieved, 3).tolist()}, audit L1 "
            f"{rec.share_l1:.3f}; prefix hits {span.prefix_hits} misses "
            f"{span.prefix_misses}")
        if not ok:
            failed.append(f"orchestrated span {s}: the SwitchReport's "
                          f"accounting does not hold ({report})")
    torch.cuda.synchronize()
    t_end = time.monotonic()
    counts = ops.launch_counts()
    offset = counts["flash_attention_offset"]
    line, streams, full_ok = _cluster_numbers(rt, tm, t_end - t_run, t_end,
                                              prompts, counts)
    ttft = {e.rid: e.data["ttft_s"] for e in tm.tracer.events
            if e.kind == "first_token"}
    for s, sp in enumerate(spans):
        tt = [ttft[r] * 1e3 for r in range(sp["first"], sp["last"])
              if r in ttft]
        log(f"  [orchestrated span {s}] TTFT of its requests mean "
            f"{np.mean(tt):.1f} ms max {np.max(tt):.1f} ms")
    per_req = [teacher_forced_agreement(cfg, params, prompts[r], streams[r])
               for r in sorted(streams)] if full_ok else [0.0]
    agree = float(np.mean(per_req))
    launched = (counts["paged_decode"] > 0 and counts["flash_attention"] > 0
                and offset > 0 and counts["flash_decode"] == 0)
    pool = rt.pool
    calib = tm.audit.calibration_error()
    log(f"  [orchestrated] {line}; B2 at a query offset {offset}")
    log(f"  [orchestrated] {len(streams)}/{len(prompts)} requests x {new} "
        f"tokens {full_ok}; deployment changes {switched}, requests migrated "
        f"{moved}; B1 and B2 launched, B2 at an offset, B3 not {launched}; "
        f"decision audit calibration error (mean L1) {calib:.3f} over "
        f"{sum(1 for r in tm.audit.records if r.joined)} spans; pool "
        f"{pool.allocator.n_free}/{pool.num_blocks} free; teacher-forced "
        f"agreement (bf16) {agree:.4f}, min {min(per_req):.4f}, limit "
        f"{MIN_TEACHER_FORCED}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {card}")
    if not (full_ok and switched >= 1 and moved >= 1 and launched):
        failed.append(f"orchestrated: a check failed (36 x 32 tokens "
                      f"{full_ok}, switches {switched}, migrated {moved}, "
                      f"kernels {counts} offset {offset})")
    if agree < MIN_TEACHER_FORCED:
        failed.append(f"orchestrated: decode agrees with the teacher-forced "
                      f"forward on {agree:.4f} of the tokens, under "
                      f"{MIN_TEACHER_FORCED}")
    del rt
    torch.cuda.empty_cache()
    # the cost model's step times for the served depth against the card's
    log("  [orchestrated] " + cost_model_text(
        cfg, params, max(a.in_len for a in REAL_ARCHETYPES),
        REAL_ARCHETYPES[3].in_len + 16, 1024) + f"; {card}")
    lens = sorted((len(p) for p in prompts), reverse=True)[:8]
    run = {"arch": ORCH_MODEL, "variant": ORCH_VARIANT, "cfg": cfg,
           "counts": counts, "n_req": len(prompts), "lens": lens}
    del params
    torch.cuda.empty_cache()
    log(f"  [orchestrated] the job took {time.monotonic() - t_start:.1f} s")
    return run, failed


# phase 5's "evaluation" job: (a) ``bench_e2e.run``'s comparison of the six
# policies at opt-30b's full profile on EVAL_BENCH["chips"] virtual H100s
# over EVAL_BENCH["n_spans"] spans of trace 2 (the cost model and the
# simulator on the host: not a measurement of the card); (b) OServePolicy
# on that trace with an LSTM (EVAL_LSTM, fitted on the first spans' counts
# + 1) on the card and on the CPU, each span's prediction within a
# relative LSTM_RTOL; (c) ``bench_predictor`` at its defaults (300 spans,
# window 50, hidden 32, 250 epochs) on the card and on the CPU, each
# rrmse within RRMSE_ATOL (the ordering row is printed, not gated)
EVAL_BENCH = dict(model="opt-30b", chips=16, n_spans=12, trace_id=2)
EVAL_LSTM = dict(window=6, hidden=8, fit_spans=8, epochs=20)
RRMSE_ATOL = 1e-3


@contextlib.contextmanager
def one_host_thread():
    """One torch intra-op thread for the CPU references of the LSTM: its
    products are [64, 32]-sized, so more threads only add overhead, and
    far more of it on a host busy with other work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def lstm_in_the_loop(bench, device: str) -> dict:
    """``OServePolicy`` with an LSTM in the loop on ``bench``: the
    predictor (EVAL_LSTM, seed 0: the same initial weights on every
    device) trains and predicts on ``device``.  Returns its predictions
    (one a span from span ``window`` on, where the history first exceeds
    the window), the deployment log and the simulator's metrics."""
    from repro_torch.core.predictor import LSTMWorkloadPredictor
    from repro_torch.serving.baselines import OServePolicy
    lstm = LSTMWorkloadPredictor(len(bench.archetypes),
                                 window=EVAL_LSTM["window"],
                                 hidden=EVAL_LSTM["hidden"], seed=0,
                                 device=device)
    lstm.fit(np.maximum(bench.counts[:EVAL_LSTM["fit_spans"]], 0) + 1.0,
             epochs=EVAL_LSTM["epochs"])
    preds, predict = [], lstm.predict

    def recording(history):
        preds.append(predict(history))
        return preds[-1]

    lstm.predict = recording
    res, m = bench.run(OServePolicy(bench.cm, bench.cluster,
                                    bench.archetypes, predictor=lstm))
    return {"preds": np.asarray(preds, np.float64),
            "deployments": res.deployments, "p99": m.get("p99"),
            "completed": m["completed"], "dropped": m["dropped"]}


def phase_evaluation(card: str) -> list[str]:
    """The "evaluation" job (EVAL_BENCH, EVAL_LSTM): the simulated policy
    comparison, the LSTM in the loop on the card against the CPU, and the
    predictor study on both.  Returns the failed checks."""
    from repro_torch.benchmarks import bench_e2e, bench_predictor
    from repro_torch.benchmarks.common import Bench
    failed = []
    t_start = time.monotonic()
    bench = Bench(**EVAL_BENCH)
    t_bench = time.monotonic() - t_start
    t0 = time.monotonic()
    rows, results = bench_e2e.compare(
        bench, EVAL_BENCH["model"], EVAL_BENCH["chips"],
        EVAL_BENCH["trace_id"])
    n = len(bench.requests)
    log(f"  [evaluation] (a) cost model and simulator at H100 rates on the "
        f"host, not measured on the card: {EVAL_BENCH}, {n} requests; "
        f"Bench built in {t_bench:.1f} s, six policies simulated in "
        f"{time.monotonic() - t0:.1f} s")
    for r in rows:
        log(f"  [evaluation sim] {r}")
    unaccounted = {name: (m["completed"], m["dropped"])
                   for name, (_, m) in results.items()
                   if m["completed"] + m["dropped"] != n}
    log(f"  [evaluation] completed + dropped == {n} for every policy "
        f"{not unaccounted}")
    if unaccounted:
        failed.append(f"evaluation: completed + dropped != {n} for "
                      f"{unaccounted}")

    t0 = time.monotonic()
    loop = {"cuda": lstm_in_the_loop(bench, "cuda")}
    with one_host_thread():
        loop["cpu"] = lstm_in_the_loop(bench, "cpu")
    got, want = loop["cuda"]["preds"], loop["cpu"]["preds"]
    w = EVAL_LSTM["window"]
    rel = [float(np.abs(g - c).max() / max(np.abs(c).max(), 1e-12))
           for g, c in zip(got, want)]
    same_log = loop["cuda"]["deployments"] == loop["cpu"]["deployments"]
    log(f"  [evaluation] (b) OServe with the LSTM in the loop (window {w}, "
        f"hidden {EVAL_LSTM['hidden']}, {EVAL_LSTM['epochs']} epochs on "
        f"the first {EVAL_LSTM['fit_spans']} spans' counts + 1), card "
        f"against CPU: {len(got)} predictions (spans {w}-"
        f"{w + len(got) - 1}), max relative difference by span "
        f"{max(rel, default=float('nan')):.3e} (limit {LSTM_RTOL:.0e}); "
        f"deployment logs equal {same_log}; p99 card "
        f"{loop['cuda']['p99']:.1f} s CPU {loop['cpu']['p99']:.1f} s; "
        f"completed {loop['cuda']['completed']} / "
        f"{loop['cpu']['completed']}, dropped {loop['cuda']['dropped']} / "
        f"{loop['cpu']['dropped']} ({time.monotonic() - t0:.1f} s)")
    if not same_log:
        s = next(i for i, (a, b) in enumerate(zip(
            loop["cuda"]["deployments"], loop["cpu"]["deployments"]))
            if a != b)
        i = s - w
        log(f"  [evaluation] (b) the logs part at span {s}: card "
            f"{loop['cuda']['deployments'][s]} CPU "
            f"{loop['cpu']['deployments'][s]}; predictions there card "
            f"{got[i].tolist() if 0 <= i < len(got) else 'none'} CPU "
            f"{want[i].tolist() if 0 <= i < len(want) else 'none'}")
    if not (len(got) == len(want) > 0 and max(rel) <= LSTM_RTOL):
        failed.append(f"evaluation: the LSTM's predictions in the loop "
                      f"differ between card and CPU by {rel}")

    studies = {}
    for dev in ("cuda", "cpu"):
        t0 = time.monotonic()
        with one_host_thread() if dev == "cpu" else contextlib.nullcontext():
            studies[dev] = bench_predictor.study(device=dev)
        studies[dev]["wall_s"] = time.monotonic() - t0
    for r in bench_predictor.rows(studies["cuda"]):
        log(f"  [evaluation predictor] {r}")
    diff = {k: abs(studies["cuda"][k] - studies["cpu"][k])
            for k in ("lstm", "ma", "agg")}
    log(f"  [evaluation] (c) bench_predictor at its defaults (300 spans, "
        f"window 50, hidden 32, 250 epochs): per-type fit card "
        f"{studies['cuda']['fit_s']:.3f} s, {studies['cuda']['pred_ms']:.3f}"
        f" ms a prediction (paper: < 30 ms); host CPU "
        f"{studies['cpu']['fit_s']:.3f} s, {studies['cpu']['pred_ms']:.3f} "
        f"ms (one thread); rrmse card / CPU "
        + ", ".join(f"{k} {studies['cuda'][k]:.6f} / {studies['cpu'][k]:.6f}"
                    for k in diff)
        + f"; max difference {max(diff.values()):.2e} (limit "
        f"{RRMSE_ATOL:.0e}); study wall card {studies['cuda']['wall_s']:.1f}"
        f" s, CPU {studies['cpu']['wall_s']:.1f} s; {card}")
    if not max(diff.values()) <= RRMSE_ATOL:
        failed.append(f"evaluation: bench_predictor's rrmse differs between "
                      f"card and CPU by {diff}")
    log(f"  [evaluation] the job took {time.monotonic() - t_start:.1f} s")
    return failed


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# the phase-5 job's engine: 16-token pages, 8 slots, bf16
FULL_WIDTH_ENGINE = dict(dtype=torch.bfloat16, num_blocks=2048,
                         block_size=16, max_seqs=8, max_blocks_per_seq=128)


def full_width_prompts(cfg) -> list:
    """The phase-5 job's 8 prompts of 128-1024 tokens (32 new tokens
    each are asked for)."""
    rng = np.random.RandomState(0)
    lens = rng.randint(128, 1025, 8)
    return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            for n in lens]


def phase_full_width(ops, arch: str, variants: tuple,
                     failures: list) -> list[dict]:
    """Serve 8 requests with ``arch`` at full width, once per variant, on
    one set of weights; the launch counters are set to 0 just before each
    run and read just after it.  Then the migrate runs on the same
    weights, whose failed checks go to ``failures``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    cfg = get_config(arch)
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n = param_count(params)
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_q_heads}/{cfg.n_kv_heads} heads, head_dim {cfg.head_dim}, "
        f"ssm {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state "
        f"{cfg.ssm_state}, d_ff {cfg.d_ff}, experts {cfg.n_experts} top "
        f"{cfg.top_k}, vocab {cfg.vocab_size}, {cfg.pos_embedding} "
        f"positions: {n:,} params, {n * 2 / 1e9:.2f} GB bf16 (the cost "
        f"model's profile counts {cfg.profile().param_count:,}; init "
        f"{time.monotonic() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated)")
    prompts = full_width_prompts(cfg)
    lens = [len(p) for p in prompts]
    runs = []
    for var in variants:
        kw = dict(FULL_WIDTH_ENGINE, **var.options)
        # warm-up: cuBLAS handles, allocator, kernel modules (eager: the
        # run's own engine captures its steps)
        serve(cfg, params, [np.arange(64, dtype=np.int32)], 4, "cuda",
              **dict(kw, graphs=False))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        fin, eng, wall = serve(cfg, params, prompts, 32, "cuda", **kw)
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        ttft, decode_rate = serving_times(fin, wall)
        ok = (len(fin) == 8
              and all(len(fin[r].generated) == 32 for r in fin)
              and all(0 <= t < cfg.vocab_size for r in fin
                      for t in fin[r].generated))
        log(f"  [{var.name}] prompts {sorted(int(x) for x in lens)}, 32 new "
            f"tokens each, max_seqs {kw['max_seqs']}, pool "
            f"{kw['num_blocks']} x {kw['block_size']}-token pages, "
            f"{var.options}")
        log(f"  [{var.name}] tokens_out {eng.tokens_out}  prefill_tokens "
            f"{eng.prefill_tokens}  steps {eng.steps}  decode_syncs "
            f"{eng.decode_syncs}  horizons {eng.horizon_counts}  distinct "
            f"tokens {len({t for r in fin for t in fin[r].generated})}")
        log(f"  [{var.name}] wall {wall:.3f} s  TTFT mean "
            f"{np.mean(ttft) * 1e3:.1f} ms max {np.max(ttft) * 1e3:.1f} ms  "
            f"decode {decode_rate:.1f} tok/s (after the last first token)  "
            f"end-to-end {eng.tokens_out / wall:.1f} tok/s  peak mem "
            f"{peak:.2f} GB")
        log(f"  [{var.name}] launches: {counts}")
        per_req = [teacher_forced_agreement(cfg, params, prompts[r],
                                            fin[r].generated)
                   for r in sorted(fin)]
        agree = float(np.mean(per_req))
        log(f"  [{var.name}] teacher-forced agreement (bf16, all "
            f"{len(fin)} requests) {agree:.4f}; per request "
            f"{[round(a, 4) for a in per_req]}, min {min(per_req):.4f}; "
            f"limit {MIN_TEACHER_FORCED}")
        if not ok:
            raise SystemExit(f"{arch} {var.name}: full-width run returned "
                             "wrong token counts/ids")
        missing = [k for k in var.launch if counts[k] <= 0]
        stray = [k for k in var.no_launch if counts[k] > 0]
        if missing or stray:
            raise SystemExit(f"{arch} {var.name}: kernels {missing} were not "
                             f"launched and {stray} were launched on its "
                             f"serving path: {counts}")
        if ("prefill_chunk_tokens" in var.options
                and counts["flash_attention"] <= cfg.n_layers * len(fin)):
            raise SystemExit(f"{arch} {var.name}: the prefill kernel ran "
                             "no more than once per layer and request: "
                             "nothing was chunked")
        if agree < MIN_TEACHER_FORCED:
            raise SystemExit(f"{arch} {var.name}: decode disagrees with the "
                             "teacher-forced forward")
        runs.append({"arch": arch, "variant": var, "cfg": cfg,
                     "counts": counts, "n_req": len(fin),
                     "lens": [int(x) for x in lens],
                     "streams": {r: fin[r].generated for r in fin}})
        # the next run's engine must not meet this one's pool
        del fin, eng
    for name in GRAPHS_RUNS.get(arch, ()):
        base = GRAPHS_SAMPLED.get(name, name)
        var, = [v for v in variants if v.name == base]
        if name in GRAPHS_SAMPLED:
            var = var._replace(name=name,
                               options=dict(var.options, greedy=False))
        failures += phase_graphs(ops, cfg, params, prompts, var)
        torch.cuda.empty_cache()
    if arch in COST_MODEL_MODELS:
        log(f"  [{arch}] " + cost_model_text(
            cfg, params, max(lens), 512, runs[0]["variant"].options.get(
                "num_blocks", FULL_WIDTH_ENGINE["num_blocks"]))
            + f"; {card_line()}")
    for path in MIGRATE.get(arch, ()):
        with prefill_tally() as tally:
            failures += phase_migrate(ops, cfg, params, prompts, path,
                                      runs[0]["streams"])
        log(f"  [migrate {path}] {prefill_share(tally)}")
        torch.cuda.empty_cache()
    if arch in PREFIX_MODELS:
        failures += phase_prefix(ops, cfg, params)
        failures += phase_evict(ops, cfg, params)
        torch.cuda.empty_cache()
    if arch in CLUSTER_MODELS:
        with prefill_tally() as tally:
            failures += phase_cluster(ops, cfg, params)
        log(f"  [cluster] {prefill_share(tally)}")
        torch.cuda.empty_cache()
    if arch in SHARDED_RUNS:
        failed, sharded_runs = phase_sharded(ops, cfg, params, prompts,
                                             runs[0]["streams"])
        failures += failed
        runs += sharded_runs
        torch.cuda.empty_cache()
    if arch in PLANS_MODELS:
        failed, plans_runs = phase_plans_serve(ops, cfg, params)
        failures += failed
        runs += plans_runs
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return runs


def graph_counts(ops) -> dict:
    """The launch counts (``GRAPHS_COUNTED``) the compiled step moves, as
    the kernels counted them on the card, a replay's launches included."""
    counts = ops.launch_counts()
    return {k: counts[k] for k in GRAPHS_COUNTED}


def step_counts(eng) -> tuple:
    """(compiled-step calls run eagerly at an ``ON_REUSE`` key's first
    call, entries built and calls replayed, by kind; capture seconds;
    decode_syncs) of ``eng`` so far."""
    st = eng._steps
    return (collections.Counter(st.eager), collections.Counter(st.built),
            collections.Counter(st.replayed), st.capture_s, eng.decode_syncs)


PREFILL_WAYS = ("eager", "built", "replayed")


@contextlib.contextmanager
def prefill_tally():
    """Counts, over every engine that serves inside the block, how the
    one-shot prefill groups ran: eagerly at their key's first call, built
    (captured) at its second, or replayed."""
    from repro_torch.serving import graphs
    tally = collections.Counter()
    run = graphs.StepGraphs.run

    def counting(self, key, inputs, step, reads):
        if key[0] != "prefill":
            return run(self, key, inputs, step, reads)
        before = [getattr(self, w)["prefill"] for w in PREFILL_WAYS]
        out = run(self, key, inputs, step, reads)
        for w, n in zip(PREFILL_WAYS, before):
            tally[w] += getattr(self, w)["prefill"] - n
        return out

    graphs.StepGraphs.run = counting
    try:
        yield tally
    finally:
        graphs.StepGraphs.run = run


def prefill_share(tally) -> str:
    """A ``prefill_tally``'s groups and the share of them replayed."""
    n = sum(tally[w] for w in PREFILL_WAYS)
    share = tally["replayed"] / n if n else 0.0
    return (f"{n} prefill groups: {tally['eager']} eager at their key's "
            f"first call, {tally['built']} captured at its second, "
            f"{tally['replayed']} replayed (replayed share {share:.3f})")


def reserved_gib() -> float:
    """The caching allocator's reserved device memory after a garbage
    collection and ``empty_cache``: what live tensors and graph pools
    hold."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2 ** 30


def phase_graphs(ops, cfg, params, prompts, var) -> list[str]:
    """The "graphs" job of one phase-5 run: the job served by an eager
    engine (``graphs=False``), then by a graphed one (the default) three
    times: a cold pass that captures each decode and chunk key on its
    first use and runs each prefill key eagerly, a second pass of the
    same prompts that captures the prefill keys (``graphs.ON_REUSE``: a
    prefill key is captured at its second call) and a warm third that
    only replays; a sampled run's sampler restarts each pass, so every
    pass draws as the others.  Prints each pass's wall, TTFT, decode
    rate, decode_syncs, launches (as the kernels counted them on the card,
    replays included), the prefill groups run eagerly, captured and
    replayed apart from the decode and chunk steps' captures and replays,
    capture seconds, and the reserved device memory before the job, with
    each engine alive and after each is dropped; returns the failed
    checks: the graphed streams equal the eager ones token for token, and
    so do decode_syncs and the B1 (and combine), B2 (and offset) and B4
    launches; the second pass captures no decode or chunk key and runs no
    prefill eagerly; the warm pass captures nothing and replays each
    prefill the cold pass ran; dropping the graphed engine gives its
    memory back (within ``GRAPHS_MEM_SLACK_GIB`` of the reading before the
    job)."""
    tag = f"[graphs {cfg.name} {var.name}]"
    kw = dict(FULL_WIDTH_ENGINE, **var.options)
    passes, failed = {}, []
    mem = {"before": reserved_gib()}
    eng = None
    labels = ("eager", "cold", "second", "warm")
    for n, label in enumerate(labels):
        ops.reset_launch_counts()
        if label in ("second", "warm"):
            # the cold pass's schedule again: the chunk rotation and the
            # sampler restart
            eng._chunk_rr = 0
            eng._sample_step = 0
            eng._gen.manual_seed(eng.seed)
            before = step_counts(eng)
            fin, wall = serve_on(eng, prompts, 32, rid0=n * len(prompts))
        else:
            fin, eng, wall = serve(cfg, params, prompts, 32, "cuda",
                                   graphs=label == "cold", **kw)
            before = (collections.Counter(), collections.Counter(),
                      collections.Counter(), 0.0, 0)
        ttft, rate = serving_times(fin, wall)
        after = step_counts(eng)
        eager, built, replayed = (after[i] - before[i] for i in range(3))
        p = {"streams": {r: fin[r].generated for r in fin},
             "counts": graph_counts(ops),
             "captures": sum(built.values()),
             "replays": sum(replayed.values()),
             "prefill": (eager["prefill"], built["prefill"],
                         replayed["prefill"]),
             "capture_s": after[3] - before[3],
             "syncs": after[4] - before[4],
             "ttft_ms": float(np.mean(ttft)) * 1e3}
        passes[label] = p
        del fin
        mem[label] = reserved_gib()
        steps = p["captures"] - built["prefill"], p["replays"] - replayed[
            "prefill"]
        log(f"  {tag} {label}: wall {wall:.3f} s  TTFT mean "
            f"{p['ttft_ms']:.1f} ms max {np.max(ttft) * 1e3:.1f} ms  "
            f"decode {rate:.1f} tok/s  decode_syncs {p['syncs']}  "
            f"launches {p['counts']}  prefill eager/captured/replayed "
            f"{'/'.join(map(str, p['prefill']))}  decode/chunk captures "
            f"{steps[0]} replays {steps[1]}  capture_s "
            f"{p['capture_s']:.3f}  reserved {mem[label]:.3f} GiB; "
            f"{card_line()}")
        if label == "eager":
            # the graphed engine must not meet the eager one's pool
            del eng
            mem["eager dropped"] = reserved_gib()
    keys, evicted = len(eng._steps.entries), sum(eng._steps.evicted.values())
    del eng
    mem["graphed dropped"] = reserved_gib()
    log(f"  {tag} reserved GiB {mem}: the graphed engine's {keys} steps "
        f"({evicted} prefill entries evicted) and their pool hold "
        f"{mem['warm'] - mem['eager']:.3f} GiB beyond the eager engine's")
    if mem["graphed dropped"] > mem["before"] + GRAPHS_MEM_SLACK_GIB:
        failed.append(f"{tag}: {mem['graphed dropped']:.3f} GiB reserved "
                      f"after the graphed engine was dropped, "
                      f"{mem['before']:.3f} GiB before the job")
    want = passes["eager"]
    for label in labels[1:]:
        got = passes[label]
        same = sum(got["streams"][r] == want["streams"][r]
                   for r in want["streams"])
        log(f"  {tag} {label} vs eager: streams equal {same}/"
            f"{len(want['streams'])}, decode_syncs equal "
            f"{got['syncs'] == want['syncs']}, launches equal "
            f"{got['counts'] == want['counts']}")
        if same != len(want["streams"]):
            failed.append(f"{tag} {label}: graphed streams differ from the "
                          "eager engine's")
        if got["syncs"] != want["syncs"]:
            failed.append(f"{tag} {label}: decode_syncs {got['syncs']} != "
                          f"eager {want['syncs']}")
        if got["counts"] != want["counts"]:
            failed.append(f"{tag} {label}: launches {got['counts']} != "
                          f"eager {want['counts']}")
    cold, second, warm = passes["cold"], passes["second"], passes["warm"]
    if cold["captures"] < 1 or warm["replays"] < 1:
        failed.append(f"{tag}: the graphed engine captured or replayed "
                      "nothing")
    if second["captures"] != second["prefill"][1] or second["prefill"][0]:
        failed.append(f"{tag} second: {second['captures']} captures, "
                      f"prefill eager/captured/replayed {second['prefill']}:"
                      " only the prefill keys may be captured, none run "
                      "eagerly")
    if warm["captures"]:
        failed.append(f"{tag} warm: {warm['captures']} captures on a third "
                      "pass of the same prompts")
    cold_prefills = sum(cold["prefill"])
    if warm["prefill"][2] != cold_prefills:
        failed.append(f"{tag} warm: {warm['prefill'][2]} prefills replayed, "
                      f"the cold pass ran {cold_prefills}")
    log(f"  {tag} TTFT mean: " + ", ".join(
        f"{label} {passes[label]['ttft_ms']:.1f} ms" for label in labels))
    return failed


def _until_next_token(dst, had: dict) -> None:
    """Step ``dst`` until each rid of ``had`` ({rid: tokens it had}) has
    emitted one more token."""
    done = {}
    while True:
        live = {r.rid: r for r in list(dst.active.values()) + dst.waiting}
        live.update(done)
        if all(len(live[rid].generated) > n for rid, n in had.items()):
            return
        done.update({r.rid: r for r in dst.step()})


def _in_flight(eng) -> dict:
    """{rid: tokens generated} of every request ``eng`` holds."""
    return {r.rid: len(r.generated)
            for r in list(eng.active.values()) + eng.waiting}


def phase_migrate(ops, cfg, params, prompts, path, paged_streams
                  ) -> list[str]:
    """The phase-5 job migrated part-way by one restore path at full width:
    the source serves until every request has MIGRATE_AFTER tokens, then
    ``move_inflight`` moves all 8 to the destination, which finishes the
    32 tokens.  Checks the report's exact counts, the launches on the
    destination from the import on, the bytes of every moved sequence
    right after the move, the teacher-forced agreement and that no page or
    reservation leaks; that run warms the path up.  Then times the stall
    over STALL_ROUNDS rounds on one more serve of the job: each moves the
    requests to the destination, steps it until every request emitted its
    next token, and moves them back untimed.  Returns the checks that
    failed."""
    arch = cfg.name
    t_start = time.monotonic()
    src, dst = migration_engines(cfg, params, "cuda", path,
                                 **FULL_WIDTH_ENGINE, **PAGED)
    pools = list({id(e.cache.pool): e.cache.pool for e in (src, dst)}
                 .values())
    n_req = len(prompts)
    serve_part_way(src, {i: (p, 32) for i, p in enumerate(prompts)},
                   after=MIGRATE_AFTER)
    # the bytes: each sequence's K/V gathered from its source pages before
    # the export equals the same gathered from its destination pages after
    # the move, before any step (re-prefill moves no pages)
    before = {} if path == "reprefill" else kv_in_flight(src)
    ops.reset_launch_counts()
    moved = move_inflight(src, dst, path)
    report = moved.report
    after = kv_in_flight(dst)
    same_bytes = sorted(after) == sorted(before) and all(
        all(torch.equal(a, b) for a, b in zip(before[r], after[r]))
        for r in before)
    del before, after
    fin = {r.rid: r for r in dst.run_to_completion()}
    counts = ops.launch_counts()
    if path == "reprefill":
        exact = (report.reprefilled == report.migrated == n_req
                 and report.recompute_tokens == moved.recompute
                 == dst.prefill_tokens)
        want = {"flash_attention": cfg.has_attn, "ssd_chunk": cfg.has_ssm}
        launched = all(counts[k] > 0 for k, on in want.items() if on)
    else:
        by_path = report.handoff if path == "handoff" else report.copied
        exact = (by_path == report.migrated == n_req
                 and report.recompute_tokens == 0
                 and dst.prefill_tokens == 0
                 and (path != "handoff"
                      or report.pages_handoff == moved.pages))
        launched = (counts["flash_attention"] == counts["ssd_chunk"] == 0
                    and counts["paged_decode"] > 0)
    streams = {r: fin[r].generated for r in fin}
    full = (sorted(streams) == list(range(n_req))
            and all(len(t) == 32 for t in streams.values()))
    per_req = [teacher_forced_agreement(cfg, params, prompts[r], streams[r])
               for r in sorted(streams)] if full else [0.0]
    agree = float(np.mean(per_req))
    log(f"  [migrate {path}] {arch}: handoff {report.handoff} copied "
        f"{report.copied} reprefilled {report.reprefilled} pages_handoff "
        f"{report.pages_handoff} pages_copied {report.pages_copied} "
        f"recompute_tokens {report.recompute_tokens} (pages held "
        f"{moved.pages}, prompt + generated {moved.recompute}); "
        f"destination prefill_tokens {dst.prefill_tokens}; exact counts "
        f"{exact}")
    log(f"  [migrate {path}] launches on the destination from the import: "
        f"{counts}; as required {launched}; bytes equal after the move "
        f"{same_bytes}")
    log(f"  [migrate {path}] teacher-forced agreement (bf16, all {n_req} "
        f"requests) {agree:.4f}, min {min(per_req):.4f}; limit "
        f"{MIN_TEACHER_FORCED}; streams equal to the uninterrupted paged "
        f"run {streams == paged_streams}")
    failed = []
    if not (exact and launched and same_bytes and full):
        failed.append(f"{arch} migrate {path}: a check failed (exact counts "
                      f"{exact}, launches {launched}, bytes {same_bytes}, "
                      f"32 tokens each {full})")
    if agree < MIN_TEACHER_FORCED:
        failed.append(f"{arch} migrate {path}: decode agrees with the "
                      f"teacher-forced forward on {agree:.4f} of the "
                      f"tokens, under {MIN_TEACHER_FORCED}")
    # one horizon more a round, so that every round's destination
    # dispatches a full horizon first, as the checked run's does
    new_tokens = 32 + STALL_ROUNDS * PAGED["decode_horizon"]
    serve_part_way(src, {100 + i: (p, new_tokens)
                         for i, p in enumerate(prompts)},
                   after=MIGRATE_AFTER)
    stalls, nexts, sizes = [], [], []
    for _ in range(STALL_ROUNDS):
        had = _in_flight(src)
        moved = move_inflight(src, dst, path)
        _until_next_token(dst, had)
        torch.cuda.synchronize()
        nexts.append((time.perf_counter() - moved.t0) * 1e3)
        # a re-prefill's pages are resident once it emitted the next token
        stalls.append(nexts[-1] if path == "reprefill"
                      else moved.stall * 1e3)
        sizes.append(moved.pages if path != "reprefill"
                     else moved.recompute)
        move_inflight(dst, src, path)
    log(f"  [migrate {path}] {arch} stall: stall_ms median "
        f"{float(np.median(stalls)):.3f} next_token_ms median "
        f"{float(np.median(nexts)):.3f} over {STALL_ROUNDS} rounds after "
        f"the checked run (stall {[round(x, 3) for x in stalls]}, next "
        f"token {[round(x, 3) for x in nexts]}); {len(had)} requests, "
        + (f"recompute tokens {sizes}" if path == "reprefill"
           else f"pages {sizes}"))
    src.release_all()
    dst.release_all()
    leak_free = all(p.allocator.n_free == p.num_blocks and p.reserved == 0
                    for p in pools)
    log(f"  [migrate {path}] pools full and unreserved after release_all "
        f"{leak_free}; the path's checks and rounds took "
        f"{time.monotonic() - t_start:.1f} s")
    if not leak_free:
        failed.append(f"{arch} migrate {path}: pages or reservations "
                      "leaked")
    return failed


def index_held(pc) -> list:
    """The blocks the prefix index holds on the device."""
    return [e.block for e in pc.index.values() if e.block is not None]


def phase_prefix(ops, cfg, params) -> list[str]:
    """The "prefix" job at full width, served with the cache off and then
    on (``serve_prefix_job``): the exact counts ``prefix_counts`` derives
    from the prompts, the prefill kernel's launches (one per layer and
    forward, some at a query offset on the cache-on run), the teacher-
    forced agreement, the pages request 0 published unchanged by the hits
    that prefilled and decoded over them, and every block free or held by
    the index alone after retirement.  Returns the checks that failed."""
    from repro_torch.serving.kvcache import gather_tokens
    t_start = time.monotonic()
    job = PREFIX_JOB
    prompts = prefix_prompts(cfg, 2, job["template"], job["tail"], job["n"])
    bs = FULL_WIDTH_ENGINE["block_size"]
    want = prefix_counts(cfg, prompts, bs)
    L = cfg.n_layers
    failed, streams, published = [], {}, {}

    def keep_published(eng):
        # request 0's pages as the index holds them after its prefill
        pool = eng.cache.pool
        published.update({k: gather_tokens(pool, [e.block], bs)
                          for k, e in eng.prefix_cache.index.items()})

    for cache in (False, True):
        name = "on" if cache else "off"
        ops.reset_launch_counts()
        fin, eng, wall = serve_prefix_job(
            cfg, params, prompts, job["new_tokens"], "cuda",
            after_first=keep_published if cache else None,
            prefix_cache=cache, **FULL_WIDTH_ENGINE, **PAGED)
        counts = ops.launch_counts()
        offset = counts["flash_attention_offset"]
        stats = eng.load_stats()
        streams[cache] = {r: fin[r].generated for r in fin}
        ttft = [fin[r].t_first - fin[r].t_submit for r in range(1, job["n"])]
        _, decode_rate = serving_times(fin, wall)
        exact = (stats["prefill_tokens"] == want[f"prefill_{name}"]
                 and counts["flash_attention"]
                 == want[f"b2_forwards_{name}"] * L)
        if cache:
            exact = (exact and stats["prefix_hits"] == want["hits"]
                     and stats["prefix_misses"] == want["misses"]
                     and stats["prefix_hit_tokens"] == want["hit_tokens"]
                     and offset > 0)
        log(f"  [prefix {name}] {len(prompts)} requests of "
            f"{len(prompts[0])} tokens (template {job['template']}, the "
            f"last a retry of request 0), {job['new_tokens']} new tokens "
            f"each: prefill_tokens {stats['prefill_tokens']} (want "
            f"{want[f'prefill_{name}']}), hits {stats['prefix_hits']} "
            f"misses {stats['prefix_misses']} hit_tokens "
            f"{stats['prefix_hit_tokens']} (want {want['hits']} / "
            f"{want['misses']} / {want['hit_tokens']}), B2 launches "
            f"{counts['flash_attention']} (want "
            f"{want[f'b2_forwards_{name}'] * L}), at a query offset "
            f"{offset}; exact {exact}")
        log(f"  [prefix {name}] wall {wall:.3f} s  TTFT over requests 1-"
            f"{job['n'] - 1} mean {np.mean(ttft) * 1e3:.1f} ms max "
            f"{np.max(ttft) * 1e3:.1f} ms  decode {decode_rate:.1f} tok/s "
            f"(after the last first token)  launches {counts}")
        if not exact:
            failed.append(f"{cfg.name} prefix {name}: the counts are not "
                          "the exact ones")
        if not cache:
            continue
        pc, pool = eng.prefix_cache, eng.cache.pool
        per_req = [teacher_forced_agreement(cfg, params, prompts[r],
                                            streams[cache][r])
                   for r in sorted(streams[cache])]
        agree = float(np.mean(per_req))
        same = bool(published) and all(
            all(torch.equal(a, b) for a, b in
                zip(gather_tokens(pool, [pc.index[k].block], bs), kv))
            for k, kv in published.items())
        held = index_held(pc)
        clean = (pool.reserved == 0 and pool.allocator.pinned == 0
                 and all(pool.allocator.refs[b] == 1 for b in held)
                 and pool.allocator.n_free + len(held) == pool.num_blocks)
        log(f"  [prefix on] teacher-forced agreement (bf16, all "
            f"{len(per_req)} requests) {agree:.4f}, min {min(per_req):.4f}; "
            f"limit {MIN_TEACHER_FORCED}; streams equal to the cache-off "
            f"run {streams[True] == streams[False]}")
        log(f"  [prefix on] after retirement: {pool.allocator.n_free} free "
            f"+ {len(held)} held by the index (all at count 1 "
            f"{all(pool.allocator.refs[b] == 1 for b in held)}) of "
            f"{pool.num_blocks}; pinned {pool.allocator.pinned}, reserved "
            f"{pool.reserved}; clean {clean}")
        log(f"  [prefix on] the {len(published)} pages request 0 published "
            f"are unchanged after {pc.hits} hits prefilled and decoded over "
            f"them {same}; the prefix runs took "
            f"{time.monotonic() - t_start:.1f} s")
        if not same:
            failed.append(f"{cfg.name} prefix on: a hit wrote into a shared "
                          "page")
        if agree < MIN_TEACHER_FORCED:
            failed.append(f"{cfg.name} prefix on: decode agrees with the "
                          f"teacher-forced forward on {agree:.4f} of the "
                          f"tokens, under {MIN_TEACHER_FORCED}")
        if not clean:
            failed.append(f"{cfg.name} prefix on: blocks or reservations "
                          "left after retirement")
    return failed


def phase_evict(ops, cfg, params) -> list[str]:
    """The "evict" job at full width: two templates served A, B, A, B
    through one slot and a pool of EVICT_BLOCKS pages.  Every visit after
    the first of each template prefills 1 token, every restored page is
    bit-equal to its gather just before its eviction, the evicted and
    restored bytes are whole pages, no block is lost, the prefill kernel
    runs once per layer and visit (at a query offset on a revisit) and the
    paged decode kernel runs, and decode agrees with the teacher-forced
    forward.  Then the host tier's rates: HOST_PAGES evictions and as many
    restores a round, beside a plain pinned copy of the same bytes.
    Returns the checks that failed."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.kvcache import gather_tokens
    t_start = time.monotonic()
    job = EVICT_JOB
    rng = np.random.RandomState(3)
    templates = [rng.randint(0, cfg.vocab_size, job["template"])
                 .astype(np.int32) for _ in range(2)]
    prompts = [templates[i % 2] for i in range(job["visits"])]
    kw = dict(FULL_WIDTH_ENGINE, num_blocks=EVICT_BLOCKS, max_seqs=1)
    eng = ServingEngine(cfg, params, device="cuda", prefix_cache=True,
                        **kw, **PAGED)
    pc, pool = eng.prefix_cache, eng.cache.pool
    bs, page = pool.block_size, pool.page_nbytes
    # every eviction keeps its page's gather; every restore compares
    saved, restored = {}, []
    evict, restore = pc._evict, pc._restore

    def evict_kept(e):
        saved[e.key] = gather_tokens(pool, [e.block], bs)
        evict(e)

    def restore_checked(e):
        restore(e)
        got = gather_tokens(pool, [e.block], bs)
        restored.append(all(torch.equal(a, b)
                            for a, b in zip(got, saved[e.key])))

    pc._evict, pc._restore = evict_kept, restore_checked
    prefills, conserved, streams = [], [], {}
    ops.reset_launch_counts()
    for rid, p in enumerate(prompts):
        mark = eng.prefill_tokens
        eng.submit(rid, p, job["new_tokens"])
        streams.update({r.rid: r.generated for r in eng.run_to_completion()})
        prefills.append(eng.prefill_tokens - mark)
        held = index_held(pc)
        conserved.append(
            pool.allocator.n_free + len(held) == pool.num_blocks
            and all(pool.allocator.refs[b] == 1 for b in held)
            and pool.reserved == pool.allocator.pinned == 0)
    pc._evict, pc._restore = evict, restore
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    offset = counts["flash_attention_offset"]
    L = cfg.n_layers
    launched = (counts["flash_attention"] == job["visits"] * L
                and offset == (job["visits"] - 2) * L
                and counts["paged_decode"] > 0)
    ev, rs = pc.evicted_bytes, pc.restored_bytes
    want_prefills = [job["template"]] * 2 + [1] * (job["visits"] - 2)
    want_page = (2 * cfg.n_layers * cfg.n_kv_heads * bs * cfg.head_dim
                 * torch.finfo(FULL_WIDTH_ENGINE["dtype"]).bits // 8)
    pages_ok = (page == want_page and ev > 0 and rs > 0
                and ev % page == 0 and rs % page == 0)
    per_req = [teacher_forced_agreement(cfg, params, prompts[r], streams[r])
               for r in sorted(streams)]
    agree = float(np.mean(per_req))
    log(f"  [evict] templates of {job['template']} tokens served A, B, A, "
        f"B through 1 slot, {EVICT_BLOCKS} pages of {bs}, "
        f"{job['new_tokens']} new tokens each: prefill tokens a visit "
        f"{prefills} (want {want_prefills}); evicted {ev} B = {ev / page:g} "
        f"pages, restored {rs} B = {rs / page:g} pages of {page} B (want "
        f"{want_page}); hits {pc.hits} misses {pc.misses}; launches "
        f"{counts}, B2 at a query offset {offset} (want B2 "
        f"{job['visits'] * L}, {(job['visits'] - 2) * L} at an offset); "
        f"as required {launched}")
    log(f"  [evict] restored pages bit-equal to their gather before "
        f"eviction {sum(restored)} of {len(restored)}; blocks conserved "
        f"after each visit {conserved}; teacher-forced agreement (bf16, "
        f"{len(per_req)} requests) {agree:.4f}, per request "
        f"{[round(a, 4) for a in per_req]}; limit {MIN_TEACHER_FORCED}")
    failed = []
    if not (prefills == want_prefills and pages_ok and restored
            and all(restored) and all(conserved) and launched):
        failed.append(f"{cfg.name} evict: a check failed (prefills "
                      f"{prefills}, whole pages {pages_ok}, restored pages "
                      f"equal {sum(restored)} of {len(restored)}, blocks "
                      f"conserved {conserved}, launches {launched})")
    if agree < MIN_TEACHER_FORCED:
        failed.append(f"{cfg.name} evict: decode agrees with the teacher-"
                      f"forced forward on {agree:.4f} of the tokens, under "
                      f"{MIN_TEACHER_FORCED}")
    del saved
    # the host tier's rates on this pool's cold pages
    rates = collections.defaultdict(list)
    for _ in range(HOST_ROUNDS):
        cold = [e for e in pc.index.values() if e.block is not None
                and pool.allocator.refs[e.block] == 1][:HOST_PAGES]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in cold:
            pc._evict(e)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for e in cold:
            pc._restore(e)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rates["evict"].append((t1 - t0) / len(cold))
        rates["restore"].append((t2 - t1) / len(cold))
    dev = torch.empty(page // 2, dtype=torch.bfloat16, device="cuda")
    host = torch.empty(page // 2, dtype=torch.bfloat16, pin_memory=True)
    for name, fn in (("d2h copy_", lambda: host.copy_(dev)),
                     ("h2d copy_", lambda: dev.copy_(host,
                                                     non_blocking=True))):
        for _ in range(HOST_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_PAGES):
                fn()
            torch.cuda.synchronize()
            rates[name].append((time.perf_counter() - t0) / HOST_PAGES)
    for name in ("evict", "d2h copy_", "restore", "h2d copy_"):
        t = float(np.median(rates[name]))
        log(f"  [evict] host tier {name:9s}: {t * 1e6:8.1f} us a page, "
            f"{page / t / 1e9:6.2f} GB/s (median of {HOST_ROUNDS} rounds "
            f"of {HOST_PAGES} pages of {page} B)")
    log(f"  [evict] the evict run and rates took "
        f"{time.monotonic() - t_start:.1f} s")
    return failed


# --------------------------------------------------------------------------
# The trainer (``repro_torch.train``): phase 4's train smoke on the card and
# the CPU, phase 5's "train" job at published widths.
# --------------------------------------------------------------------------


def train_batches(cfg, batch: int, seq: int, n: int) -> list:
    """``n`` numpy batches of the synthetic pipeline (seed 0): packed token
    batches, or ``embeds_batches`` for the audio stub."""
    import itertools
    from repro_torch.data.pipeline import (DataConfig, embeds_batches,
                                           packed_batches)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch,
                    seed=0)
    it = (embeds_batches(dc, cfg.d_model) if cfg.modality == "audio_stub"
          else packed_batches(dc))
    return list(itertools.islice(it, n))


def train_steps(cfg, tcfg, state, batches, device) -> tuple[dict, list]:
    """``make_train_step``'s steps over ``batches`` on ``device``; returns
    the state and each step's metrics as floats."""
    from repro_torch.train.trainer import batch_to_device, make_train_step
    step = make_train_step(cfg, tcfg)
    metrics = []
    for b in batches:
        state, m = step(state, batch_to_device(b, device))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def max_leaf_diff(a, b) -> float:
    from repro_torch.train.optimizer import tree_leaves
    return max((x.detach().cpu().float() - y.detach().cpu().float())
               .abs().max().item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def train_launches(cfg, microbatches: int, steps: int, remat=True) -> dict:
    """The kernel launches ``steps`` train steps must make: each attention
    layer B2's forward once a microbatch (twice under remat, which
    recomputes it) and its backward once, each SSD layer B4's likewise."""
    k = microbatches * steps
    fwd = 2 * k if remat else k
    attn = cfg.n_layers if cfg.has_attn else 0
    ssd = cfg.n_layers if cfg.has_ssm else 0
    return {"flash_attention": attn * fwd, "flash_attention_bwd": attn * k,
            "ssd_chunk": ssd * fwd, "ssd_chunk_bwd": ssd * k}


def launches_text(counts: dict, want: dict) -> str:
    return ", ".join(f"{k} {counts[k]} (want {v})" for k, v in want.items())


def phase_train_smoke(ops) -> None:
    """Phase 4's train check: TRAIN_SMOKE["steps"] fp32 steps of every
    smoke config on the card and on the CPU from one set of weights agree
    (losses within a relative TRAIN_RTOL, parameters within TRAIN_ATOL),
    and the card's steps launch B2's and B4's forward and backward as
    ``train_launches`` says; the decode kernel B1 still raises its grad
    guard under grad."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.trainer import TrainConfig, init_train_state
    job = TRAIN_SMOKE
    tcfg = TrainConfig(remat=True, microbatches=job["microbatches"],
                       compute_dtype=torch.float32)
    for arch in TRAIN_SMOKE_ARCHS:
        t0 = time.monotonic()
        cfg = get_smoke_config(arch)
        batches = train_batches(cfg, job["batch"], job["seq"], job["steps"])
        cpu = init_train_state(cfg, 0, tcfg, "cpu")
        card = _to(cpu, "cuda")
        cpu, cpu_m = train_steps(cfg, tcfg, cpu, batches, "cpu")
        ops.reset_launch_counts()
        card, card_m = train_steps(cfg, tcfg, card, batches, "cuda")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        loss_rel = max(abs(c[k] - p[k]) / max(abs(p[k]), 1e-30)
                       for c, p in zip(card_m, cpu_m)
                       for k in ("nll", "aux_loss") if p[k] or c[k])
        param_err = max_leaf_diff(card["params"], cpu["params"])
        want = train_launches(cfg, job["microbatches"], job["steps"])
        launched = all(counts[k] == v for k, v in want.items())
        ok = loss_rel <= TRAIN_RTOL and param_err <= TRAIN_ATOL and launched
        log(f"  [train smoke] {arch:22s} {job['steps']} steps fp32 (B "
            f"{job['batch']}, S {job['seq']}, {job['microbatches']} "
            f"microbatches, remat): nll {[round(m['nll'], 5) for m in card_m]}"
            f" card vs CPU loss rel {loss_rel:.3e} (rtol {TRAIN_RTOL:.0e}), "
            f"params max abs {param_err:.3e} (atol {TRAIN_ATOL:.0e}); "
            f"{launches_text(counts, want)} {'ok' if ok else 'FAIL'} "
            f"({time.monotonic() - t0:.1f} s)")
        if not ok:
            raise SystemExit(f"train smoke {arch}: the card's steps disagree "
                             f"with the CPU's or launched {counts}")
    # the decode kernels have no backward: B1 under grad raises
    q = torch.zeros((1, 4, 32), device="cuda", requires_grad=True)
    pages = torch.zeros((2, 2, 8, 32), device="cuda")
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    try:
        ops.paged_decode(q, pages, pages, one[:, None] * 0, one, one * 0)
        err = ""
    except RuntimeError as e:
        err = str(e)
    ok = err.startswith("paged_decode: the CUDA kernel has no backward")
    log(f"  [train smoke] B1 under grad on the card raises its grad guard: "
        f"{ok} ({err[:60]}...)")
    if not ok:
        raise SystemExit("paged_decode under grad did not raise its guard")


def phase_quickstart() -> None:
    """``python -m repro_torch.quickstart`` on the card (its default
    device): every one of its 6 requests finishes with its 12 tokens."""
    t0 = time.monotonic()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.quickstart"],
                         cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=300)
    lines = out.stdout.splitlines()
    done = {int(m.group(1)): len(m.group(2).split(","))
            for m in map(re.compile(r"  req (\d+): prompt\[\d+\] -> "
                                    r"\[(.*)\]$").match, lines) if m}
    ok = out.returncode == 0 and done == {i: 12 for i in range(6)} \
        and lines[-1].endswith("tok/s on cuda)")
    log(f"  [quickstart] python -m repro_torch.quickstart: exit "
        f"{out.returncode}, requests finished {sorted(done)}, tokens "
        f"{sorted(set(done.values()))}; {lines[-1] if lines else ''} "
        f"{'ok' if ok else 'FAIL'} ({time.monotonic() - t0:.1f} s)")
    if not ok:
        raise SystemExit(f"quickstart on the card failed:\n{out.stdout}\n"
                         f"{out.stderr}")


def train_numbers(cfg, hist: list, tokens_per_step: int) -> dict:
    """Median step time, tokens/s and the model-FLOPs share of a run whose
    history has every step (the first step, which builds the cuBLAS and
    allocator state, left out)."""
    from repro_torch.models.config import flops_per_token_train
    walls = [h["wall"] for h in hist]
    dt = float(np.median(np.diff(walls))) if len(walls) > 2 else walls[-1]
    tps = tokens_per_step / dt
    return {"step_ms": dt * 1e3, "tokens_per_s": tps,
            "mfu": flops_per_token_train(cfg) * tps / BF16_FLOPS_PER_S}


def train_line(tag, cfg, nums, counts, card: str) -> str:
    return (f"  [train {tag}] step {nums['step_ms']:.1f} ms (median), "
            f"{nums['tokens_per_s']:.0f} tokens/s, model-FLOPs share "
            f"{nums['mfu']:.4f} of 989 TFLOP/s bf16 "
            f"({cfg.profile().active_param_count:,} active params x 6); "
            f"peak mem {nums['peak_gb']:.2f} GB; B2 forward "
            f"{counts['flash_attention']}, backward "
            f"{counts['flash_attention_bwd']}; B4 forward "
            f"{counts['ssd_chunk']}, backward {counts['ssd_chunk_bwd']}; "
            f"{card}")


def train_run(ops, cfg, tcfg, batches, every: int = 0) -> dict:
    """One ``Trainer`` run over ``batches`` on the card, the launch
    counters set to 0 just before it and read just after; with ``every``,
    checkpointed every ``every`` steps and followed by a fresh Trainer
    resumed from the checkpoint at ``every`` and run to the end, whose
    losses and final parameters must equal the first run's to the bit."""
    import shutil
    import tempfile
    from repro_torch.models import param_count
    from repro_torch.train.trainer import Trainer
    steps = len(batches)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        tr = Trainer(cfg, tcfg, iter(batches),
                     checkpoint_dir=os.path.join(root, "run") if every
                     else None, checkpoint_every=every, device="cuda")
        hist = tr.run(steps, log_every=1)
        torch.cuda.synchronize()
        out = {"hist": hist, "counts": ops.launch_counts(),
               "wall": time.monotonic() - t0,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "params": param_count(tr.state["params"])}
        if every:
            name = f"step_{every:09d}"
            shutil.copytree(os.path.join(root, "run", name),
                            os.path.join(root, "resume", name))
            tr2 = Trainer(cfg, tcfg, iter(batches[every:]),
                          checkpoint_dir=os.path.join(root, "resume"),
                          device="cuda")
            out["resumed_at"] = tr2.step
            hist2 = tr2.run(steps - tr2.step, log_every=1)
            out["resumed_steps"] = len(hist2)
            out["loss_diff"] = max(abs(a["nll"] - b["nll"])
                                   for a, b in zip(hist[every:], hist2))
            out["param_diff"] = max_leaf_diff(tr.state["params"],
                                              tr2.state["params"])
            del tr2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    return out


def check_resumed(tag, cfg, tcfg, job, run, card) -> tuple[bool, str]:
    """(a)'s and (d)'s checks and lines: the resume bit-equal, the mean nll
    of the last quarter of the steps (at most 10) below the first's by
    LOSS_MARGIN, the launches ``train_launches`` gives."""
    hist, counts = run["hist"], run["counts"]
    nll = [h["nll"] for h in hist]
    win = min(10, job["steps"] // 4)
    first, last = float(np.mean(nll[:win])), float(np.mean(nll[-win:]))
    want = train_launches(cfg, tcfg.microbatches, job["steps"])
    launched = all(counts[k] == v for k, v in want.items())
    ok = (run["resumed_at"] == job["every"]
          and run["resumed_steps"] == job["steps"] - job["every"]
          and run["loss_diff"] == 0.0 and run["param_diff"] == 0.0
          and last < first - LOSS_MARGIN and launched
          and all(np.isfinite(nll)))
    nums = train_numbers(cfg, hist, job["batch"] * job["seq"])
    nums["peak_gb"] = run["peak_gb"]
    log(f"  [train {tag}] nll steps 1-{win} mean {first:.4f}, steps "
        f"{job['steps'] - win + 1}-{job['steps']} mean {last:.4f} (must "
        f"fall by {LOSS_MARGIN}); every {max(1, job['steps'] // 12)}th: "
        f"{[round(x, 3) for x in nll[::max(1, job['steps'] // 12)]]}")
    log(f"  [train {tag}] resumed from step {run['resumed_at']}: steps "
        f"{job['every'] + 1}-{job['steps']} nll max |diff| "
        f"{run['loss_diff']:.3e}, final params max |diff| "
        f"{run['param_diff']:.3e} (bit-equal expected)")
    log(train_line(tag, cfg, nums, counts, card) + f" {'ok' if ok else 'FAIL'}")
    return ok, (f"train {tag}: resume equal {run['loss_diff']} / "
                f"{run['param_diff']}, nll {first:.4f} -> {last:.4f}, "
                f"launches {counts}")


def check_falls(tag, cfg, tcfg, job, run, card) -> tuple[bool, str]:
    """(b)'s and (e)'s checks and lines: finite losses, the last below the
    first, the launches ``train_launches`` gives."""
    hist, counts = run["hist"], run["counts"]
    nll = [h["nll"] for h in hist]
    want = train_launches(cfg, tcfg.microbatches, job["steps"])
    ok = (all(np.isfinite(nll)) and nll[-1] < nll[0]
          and all(counts[k] == v for k, v in want.items()))
    nums = train_numbers(cfg, hist, job["batch"] * job["seq"])
    nums["peak_gb"] = run["peak_gb"]
    log(f"  [train {tag}] {job['steps']} steps in {run['wall']:.1f} s; nll "
        f"{[round(x, 4) for x in nll]}; grad norm "
        f"{[round(h['grad_norm'], 3) for h in hist]}")
    log(train_line(tag, cfg, nums, counts, card) + f" {'ok' if ok else 'FAIL'}")
    return ok, f"train {tag}: nll {nll}, launches {counts}"


def check_gradient(tag, ops, cfg, batch) -> tuple[bool, str]:
    """(c)'s and (f)'s check: one fp32 ``loss_fn`` gradient (no remat) on
    the card and on the CPU from the same seed-0 weights, the loss within
    a relative TRAIN_RTOL, every gradient leaf within GRAD_LEAF_RTOL of
    the leaf's largest |value|, B2's and B4's launches one forward and one
    backward a layer."""
    from repro_torch.models import init_params
    from repro_torch.train.checkpoint import flatten_with_paths
    from repro_torch.train.optimizer import tree_leaves
    from repro_torch.train.trainer import (TrainConfig, batch_to_device,
                                           value_and_grad)
    tcfg = TrainConfig(remat=False, compute_dtype=torch.float32)
    t0 = time.monotonic()
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cuda")
    ops.reset_launch_counts()
    loss, _, grads = value_and_grad(params, cfg, batch_to_device(batch,
                                                                  "cuda"),
                                    tcfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    loss, grads = float(loss), _to(grads, "cpu")
    params = _to(params, "cpu")
    torch.cuda.empty_cache()
    loss_cpu, _, grads_cpu = value_and_grad(
        params, cfg, batch_to_device(batch, "cpu"), tcfg)
    loss_rel = abs(loss - float(loss_cpu)) / abs(float(loss_cpu))
    worst, worst_at = 0.0, ""
    for (path, g), gc in zip(flatten_with_paths(grads),
                             tree_leaves(grads_cpu)):
        rel = ((g - gc).abs().max() / gc.abs().max().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_at = rel, path
    want = train_launches(cfg, 1, 1, remat=False)
    ok = (loss_rel <= TRAIN_RTOL and worst <= GRAD_LEAF_RTOL
          and all(counts[k] == v for k, v in want.items()))
    S = batch["labels"].shape
    log(f"  [train {tag}] {cfg.name} at published widths, {cfg.n_layers} "
        f"layers, fp32, batch {S[0]} x seq {S[1]}: one loss_fn gradient, "
        f"card {loss:.6f} vs CPU {float(loss_cpu):.6f} (rel {loss_rel:.3e}, "
        f"rtol {TRAIN_RTOL:.0e}); worst gradient leaf {worst_at} max |diff| "
        f"/ max |leaf| {worst:.3e} (limit {GRAD_LEAF_RTOL:.0e}); "
        f"{launches_text(counts, want)} {'ok' if ok else 'FAIL'} "
        f"({time.monotonic() - t0:.1f} s)")
    return ok, f"train {tag}: loss rel {loss_rel}, worst leaf {worst_at} {worst}"


def phase_train(ops, card: str) -> tuple[list[dict], list[str]]:
    """Phase 5's "train" job: (a) yi-100m as ``train_100m --full-100m``
    with its resume, (b) yi-9b at 8 layers, (c) a full-width yi-9b
    gradient on the card against the CPU, (d) mamba2-370m at all 48 layers
    with its resume, (e) hymba-1.5b at all 32 layers, (f) 2-layer
    full-width mamba2-370m and hymba-1.5b gradients on the card against
    the CPU, (g) gemma2-2b at 2 layers (B2's backward at D = 256).
    Returns the runs (phase 6 times B2's and B4's backwards at their
    shapes) and the failed checks."""
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig
    from repro_torch.train_100m import build_config, train_config
    failures, runs = [], []

    def record(ok, why):
        if not ok:
            failures.append(why)

    def timed_run(arch, cfg, tcfg, job, run, timed):
        runs.append({"arch": arch, "cfg": cfg, "counts": run["counts"],
                     "n_req": job["steps"],
                     "variant": Variant("train", {}, (), (), timed),
                     "shape": (job["batch"] // tcfg.microbatches,
                               job["seq"])})

    # (a) yi-100m, resumed half-way
    job = TRAIN_A
    cfg = build_config(True)
    tcfg = train_config(job["steps"])
    t0 = time.monotonic()
    batches = train_batches(cfg, job["batch"], job["seq"], job["steps"])
    built = time.monotonic() - t0
    run = train_run(ops, cfg, tcfg, batches, job["every"])
    log(f"  [train a] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{cfg.param_count():,} params; batch {job['batch']} x seq "
        f"{job['seq']}, {tcfg.microbatches} microbatches, remat, lr "
        f"{tcfg.opt.lr}, warmup {tcfg.opt.warmup_steps}, bf16 compute; "
        f"{job['steps']} steps in {run['wall']:.1f} s (batches built on "
        f"the host in {built:.2f} s)")
    record(*check_resumed("a", cfg, tcfg, job, run, card))
    timed_run(cfg.name, cfg, tcfg, job, run, ("flash_attention_bwd",))

    # (b) yi-9b at its published widths, TRAIN_B["layers"] layers
    job = TRAIN_B
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=job["layers"])
    tcfg = TrainConfig(opt=AdamWConfig(lr=job["lr"], warmup_steps=1,
                                       total_steps=1000),
                       remat=True, microbatches=job["microbatches"])
    run = train_run(ops, cfg, tcfg, train_batches(cfg, job["batch"],
                                                  job["seq"], job["steps"]))
    log(f"  [train b] yi-9b at published widths (d_model {cfg.d_model}, "
        f"{cfg.n_q_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}), reduced to {cfg.n_layers} of "
        f"48 layers: {run['params']:,} params; batch {job['batch']} x seq "
        f"{job['seq']}, {tcfg.microbatches} microbatches, remat, lr "
        f"{tcfg.opt.lr}, bf16 compute")
    record(*check_falls("b", cfg, tcfg, job, run, card))
    timed_run("yi-9b-8l", cfg, tcfg, job, run, ("flash_attention_bwd",))

    # (c) one fp32 gradient at full width, card against CPU
    job = TRAIN_C
    cfg = dataclasses.replace(get_config("yi-9b"), n_layers=job["layers"])
    record(*check_gradient("c", ops, cfg, train_batches(
        cfg, job["batch"], job["seq"], 1)[0]))

    # (d) mamba2-370m, all 48 layers, resumed half-way; (e) hymba-1.5b,
    # all 32 layers; the SSM models at their published widths
    ssm_batches = {}
    for tag, job in (("d", TRAIN_D), ("e", TRAIN_E)):
        cfg = get_config(job["arch"])
        tcfg = TrainConfig(opt=AdamWConfig(lr=job["lr"], warmup_steps=1,
                                           total_steps=1000),
                           remat=True, microbatches=job["microbatches"])
        t0 = time.monotonic()
        batches = train_batches(cfg, job["batch"], job["seq"], job["steps"])
        built = time.monotonic() - t0
        ssm_batches[job["arch"]] = batches[0]
        run = train_run(ops, cfg, tcfg, batches, job.get("every", 0))
        log(f"  [train {tag}] {cfg.name} at published widths, all "
            f"{cfg.n_layers} layers (d_model {cfg.d_model}, {cfg.ssm_heads} "
            f"SSM heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}"
            + (f", {cfg.n_q_heads}/{cfg.n_kv_heads} attention heads of "
               f"{cfg.head_dim}, d_ff {cfg.d_ff}" if cfg.has_attn else "")
            + f", vocab {cfg.vocab_size}): {run['params']:,} params; batch "
            f"{job['batch']} x seq {job['seq']}, {tcfg.microbatches} "
            f"microbatches, remat, lr {tcfg.opt.lr}, bf16 compute; batches "
            f"built on the host in {built:.2f} s")
        check = check_resumed if "every" in job else check_falls
        record(*check(tag, cfg, tcfg, job, run, card))
        timed_run(cfg.name, cfg, tcfg, job, run,
                  ("ssd_chunk_bwd", "flash_attention_bwd") if cfg.has_attn
                  else ("ssd_chunk_bwd",))

    # (f) 2 layers of each at their published widths, fp32 gradient
    job = TRAIN_F
    for arch, batch in ssm_batches.items():
        cfg = dataclasses.replace(get_config(arch), n_layers=job["layers"])
        batch = {k: np.ascontiguousarray(v[:job["batch"], :job["seq"]])
                 for k, v in batch.items()}
        record(*check_gradient("f", ops, cfg, batch))

    # (g) gemma2-2b at its published widths, TRAIN_G["layers"] layers
    job = TRAIN_G
    cfg = dataclasses.replace(get_config(job["arch"]),
                              n_layers=job["layers"])
    tcfg = TrainConfig(opt=AdamWConfig(lr=job["lr"], warmup_steps=1,
                                       total_steps=1000),
                       remat=True, microbatches=job["microbatches"])
    run = train_run(ops, cfg, tcfg, train_batches(cfg, job["batch"],
                                                  job["seq"], job["steps"]))
    log(f"  [train g] gemma2-2b at published widths (d_model "
        f"{cfg.d_model}, {cfg.n_q_heads}/{cfg.n_kv_heads} heads of "
        f"{cfg.head_dim}, softcap {cfg.attn_logit_softcap}, window "
        f"{cfg.local_window} on local layers, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), reduced to {cfg.n_layers} of 26 layers: "
        f"{run['params']:,} params; batch {job['batch']} x seq "
        f"{job['seq']}, {tcfg.microbatches} microbatches, remat, lr "
        f"{tcfg.opt.lr}, bf16 compute")
    record(*check_falls("g", cfg, tcfg, job, run, card))
    timed_run("gemma2-2b-2l", cfg, tcfg, job, run, ("flash_attention_bwd",))
    return runs, failures


# --------------------------------------------------------------------------
# Phase 5's "plans" job: the JAX package's prefill, decode and train plans.
# --------------------------------------------------------------------------


# the models whose serving weights the plans job's serving runs reuse
PLANS_MODELS = ("yi-9b",)
# prefill (data 2, model 2) -> decode (data 2, model 2): 8 prompts of 512
# tokens, 32 greedy tokens each (the first from the prefill's logits)
PLANS_SERVE = dict(batch=8, prompt=512, new_tokens=32, mesh=(2, 2))
# one prompt of 8192 tokens: the prefill plan at batch 1 (heads over
# model, the data axis replicating it), the decode plan with the sequence
# over (data 2, model 2) in a cache of 12288 positions, so that the last of
# its 4 ranges, [9216, 12288), lies past every position of the run and
# its shard attends nothing
PLANS_LONG = dict(prompt=8192, new_tokens=32, max_len=12288, mesh=(2, 2))
# the mesh of ones against the unsharded prefill and dense decode_step, at
# yi-9b's published widths cut to 4 layers: 2 prompts of 256, 8 tokens
PLANS_IDENTITY = dict(layers=4, batch=2, prompt=256, new_tokens=8)
# the train runs: (arch, layers, a constant lr after one warmup step) at
# batch 2 x seq 2048 (one sequence a data group), 3 steps, on (data 2,
# model 2) with fsdp and the sequence-parallel residual, bf16 compute
# over fp32 master weights, remat: yi-9b cut to 4 layers at TRAIN_B's rate
# (141 GB of train state at 48; each co-located data group holds a whole
# fp32 gradient before the reduction, 3.8 GB at 4 layers), mamba2-370m at
# all 48 and TRAIN_D's rate
PLANS_TRAIN = (("yi-9b", 4, 3e-6), ("mamba2-370m", 48, 3e-4))
PLANS_TRAIN_JOB = dict(steps=3, batch=2, seq=2048, mesh=(2, 2))
# one fp32 gradient of the sharded step against the unsharded port's on
# the card (2 layers, batch 2 x 256), each leaf within PLANS_GRAD_RTOL of
# its largest |value|, the loss within TRAIN_RTOL; and one bf16 step on the
# mesh of ones bit-equal to the unsharded step
PLANS_GRAD = dict(layers=2, batch=2, seq=256)
PLANS_GRAD_RTOL = 1e-4
# the sharded bf16 loss against the unsharded bf16 loss on the same state
# and batch: both round the same function's products to bf16, in other
# orders, so they stand apart by about as much as either stands from the
# fp32 loss; the limit is PLANS_BF16_FACTOR times the unsharded port's
# |loss_bf16 - loss_fp32|, measured on the run's own state and batch
PLANS_BF16_FACTOR = 2.0


def cut_layers(params: dict, n: int) -> dict:
    """The first ``n`` layers of ``params`` (views)."""
    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else t[:n])
    return {**params, "blocks": walk(params["blocks"])}


def plan_serve(ops, cfg, params, prompts, new_tokens: int, mesh_shape,
               max_len: int, keep_logits: bool = False) -> dict:
    """The prefill plan, ``reshard_cache`` and the decode plan's greedy
    steps on a (data, model) mesh of virtual chips of this card, the launch
    counters set to 0 just before and read just after: streams [B][new
    tokens], the phases' seconds, counts, the shapes the kernels saw, each
    data group's sequence shards, the decode plan (and every step's joined
    logits with ``keep_logits``)."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import sharded
    from repro_torch.models.sampling import mask_padded_vocab
    dp, tp = mesh_shape
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_small_mesh([dev] * (dp * tp), model=tp)
    B = len(prompts)
    pplan, run_cfg = shd.make_plan(cfg, "prefill", False, B, tp=tp)
    dplan, _ = shd.make_plan(cfg, "decode", False, B, tp=tp)
    if run_cfg is not cfg:
        raise SystemExit(f"{cfg.name}: the plans job expects heads that "
                         f"divide tp {tp}")
    pm = sharded.PlanModel.build(params, cfg, pplan, mesh)
    dm = sharded.PlanModel.build(params, cfg, dplan, mesh)
    tokens = torch.from_numpy(np.stack(prompts)).to(dev)
    kept = []

    def greedy(logits):
        logits = torch.cat(logits)
        if keep_logits:
            kept.append(logits)
        return mask_padded_vocab(logits, cfg).argmax(-1).to(torch.int32)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with torch.no_grad(), kernel_heads(ops) as heads:
        t0 = time.monotonic()
        logits, cache = sharded.prefill_plan(pm, [
            p["t"] for p in shd.shard_batch({"t": tokens}, pplan, mesh)])
        tok = greedy(logits)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        cache = shd.reshard_cache(cache, cfg, pplan, dplan, mesh,
                                  max_len=max_len)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        out = [tok]
        for _ in range(new_tokens - 1):
            logits, cache = sharded.decode_step_plan(dm, [
                p["t"] for p in shd.shard_batch({"t": tok}, dplan, mesh)],
                cache)
            tok = greedy(logits)
            out.append(tok)
        torch.cuda.synchronize()
        t3 = time.monotonic()
    counts = ops.launch_counts()
    streams = torch.stack(out, 1).cpu().numpy()
    return {"streams": [[int(x) for x in r] for r in streams],
            "seconds": {"prefill": t1 - t0, "reshard": t2 - t1,
                        "decode": t3 - t2},
            "counts": counts, "heads": heads, "plan": dplan,
            "shards": [sharded.seq_shards(dm, cache, g)
                       for g in range(dm.groups)],
            "logits": kept}


def unsharded_stream(cfg, params, prompts, tokens_out: list) -> list:
    """The unsharded port's prefill and dense ``decode_step`` fed the
    given greedy tokens: every step's logits."""
    from repro_torch.models import model as tmodel
    dev = torch.device("cuda", torch.cuda.current_device())
    tokens = torch.from_numpy(np.stack(prompts)).to(dev)
    B, S = tokens.shape
    with torch.no_grad():
        logits, pc = tmodel.prefill(params, cfg, tokens)
        out = [logits]
        k = torch.zeros((cfg.n_layers, B, S + len(tokens_out[0]),
                         *pc.k.shape[3:]), dtype=pc.k.dtype, device=dev)
        v = torch.zeros_like(k)
        k[:, :, :S], v[:, :, :S] = pc.k, pc.v
        cache = tmodel.DecodeCache(k, v, None, None, torch.full(
            (B,), S, dtype=torch.int32, device=dev))
        for i in range(len(tokens_out[0]) - 1):
            tok = torch.tensor([t[i] for t in tokens_out],
                               dtype=torch.int32, device=dev)
            logits, cache = tmodel.decode_step(params, cfg, tok, cache)
            out.append(logits)
    return out


def phase_plans_serve(ops, cfg, params) -> tuple[list[str], list[dict]]:
    """The "plans" job's serving runs on ``cfg``'s full-width weights:
    prefill -> decode on (data 2, model 2) (PLANS_SERVE), the long context
    (PLANS_LONG) and the mesh of ones at PLANS_IDENTITY's depth.  Returns
    the failed checks and the runs phase 6 times B3's lse form at."""
    failed, runs = [], []
    card = card_line()
    t_start = time.monotonic()
    rng = np.random.RandomState(1)
    L = cfg.n_layers
    for tag, job, B in (("prefill-decode", PLANS_SERVE, PLANS_SERVE["batch"]),
                        ("long", PLANS_LONG, 1)):
        prompts = [rng.randint(0, cfg.vocab_size, job["prompt"])
                   .astype(np.int32) for _ in range(B)]
        new = job["new_tokens"]
        max_len = job.get("max_len", job["prompt"] + new)
        dp, tp = job["mesh"]
        torch.cuda.reset_peak_memory_stats()
        run = plan_serve(ops, cfg, params, prompts, new, job["mesh"],
                         max_len)
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts, heads, streams = run["counts"], run["heads"], run["streams"]
        groups = dp if B > 1 else 1
        n_seq = tp if B > 1 else dp * tp
        S_shard = max_len // n_seq
        want = {"flash_attention": L * groups * tp,
                "flash_decode": L * (new - 1) * groups * n_seq,
                "flash_decode_lse": L * (new - 1) * groups * n_seq,
                "paged_decode": 0, "ssd_chunk": 0}
        launched = all(counts[k] == v for k, v in want.items())
        shapes = (heads["flash_attention"]
                  == {(cfg.n_q_heads // tp, cfg.n_kv_heads // tp)}
                  and heads["flash_decode"]
                  == {(cfg.n_q_heads, cfg.n_kv_heads, S_shard, True)}
                  and not heads["paged_decode"])
        last = job["prompt"] + new - 1
        ranges = [(s0, s1) for sh in run["shards"] for *_, s0, s1 in sh]
        past = [r for r in ranges if r[0] > last]
        per_req = [teacher_forced_agreement(cfg, params, p, s)
                   for p, s in zip(prompts, streams)]
        agree = float(np.mean(per_req))
        full = all(len(s) == new and all(0 <= x < cfg.vocab_size for x in s)
                   for s in streams)
        sec = run["seconds"]
        log(f"  [plans {tag}] {cfg.name}, {L} layers, bf16: {B} prompt(s) "
            f"of {job['prompt']} tokens, {new} greedy tokens each; prefill "
            f"plan on (data {dp}, model {tp}) ({groups} data group(s), "
            f"heads {cfg.n_q_heads // tp}/{cfg.n_kv_heads // tp} a shard), "
            f"reshard_cache, decode plan kv_seq {run['plan'].rules['kv_seq']}"
            f" over a cache of {max_len}: sequence ranges {ranges} "
            f"(past the last position {last}: {past}); prefill "
            f"{sec['prefill']:.3f} s, reshard {sec['reshard']:.3f} s, "
            f"decode {sec['decode']:.3f} s ({B * (new - 1) / sec['decode']:.1f}"
            f" tok/s); peak mem {peak:.2f} GB; {card}")
        log(f"  [plans {tag}] launches {launches_text(counts, want)}; B2 saw "
            f"(Hq, Hkv) {sorted(heads['flash_attention'])}, B3 (Hq, Hkv, S, "
            f"lse) {sorted(heads['flash_decode'])}, B1 "
            f"{sorted(heads['paged_decode'])}; teacher-forced agreement "
            f"(bf16) {agree:.4f}, min {min(per_req):.4f}; limit "
            f"{MIN_TEACHER_FORCED}")
        if not (full and launched and shapes):
            failed.append(f"plans {tag}: a check failed ({new} tokens each "
                          f"{full}, launches {launched}, shard shapes "
                          f"{shapes})")
        if tag == "long" and not past:
            failed.append("plans long: no sequence shard lay past the run's "
                          "positions")
        if agree < MIN_TEACHER_FORCED:
            failed.append(f"plans {tag}: decode agrees with the "
                          f"teacher-forced forward on {agree:.4f} of the "
                          f"tokens, under {MIN_TEACHER_FORCED}")
        # phase 6: B3's lse form at a shard of this run, mid-way through
        # decode (the shard that holds position prompt + new / 2)
        mid = job["prompt"] + new // 2
        s0 = next(a for a, b in ranges if a <= mid < b)
        runs.append({"arch": cfg.name, "cfg": cfg, "counts": counts,
                     "n_req": B, "lens": [len(p) for p in prompts],
                     "variant": Variant(f"plans {tag}", {}, (), (),
                                        ("flash_decode_lse",)),
                     "lse_shape": (B // groups, S_shard, mid + 1 - s0)})
        del run
        torch.cuda.empty_cache()

    # the mesh of ones: bit-equal to the unsharded prefill and dense decode
    job = PLANS_IDENTITY
    cfg_n = dataclasses.replace(cfg, n_layers=job["layers"])
    params_n = cut_layers(params, job["layers"])
    prompts = [rng.randint(0, cfg.vocab_size, job["prompt"]).astype(np.int32)
               for _ in range(job["batch"])]
    run = plan_serve(ops, cfg_n, params_n, prompts, job["new_tokens"], (1, 1),
                     job["prompt"] + job["new_tokens"], keep_logits=True)
    want = unsharded_stream(cfg_n, params_n, prompts, run["streams"])
    same = [bool(torch.equal(a, b)) for a, b in zip(run["logits"], want)]
    log(f"  [plans ones] {cfg.name} at {job['layers']} layers, the mesh of "
        f"ones: prefill and {job['new_tokens'] - 1} decode steps' logits "
        f"bit-equal to the unsharded prefill and dense decode_step: {same}")
    if not all(same):
        failed.append(f"plans ones: logits differ from the unsharded path's "
                      f"({same})")
    log(f"  [plans] the serving runs took {time.monotonic() - t_start:.1f} "
        f"s; {card}")
    return failed, runs


def plans_gradient(ops, arch: str, mesh) -> tuple[list[str], str]:
    """PLANS_GRAD's checks for ``arch``: the sharded fp32 gradient on
    ``mesh`` against the unsharded port's on the card, and the mesh of
    ones's bf16 step against the unsharded step, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import init_params
    from repro_torch.train import trainer as ttr
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    job = PLANS_GRAD
    cfg = dataclasses.replace(get_config(arch), n_layers=job["layers"])
    batch = ttr.batch_to_device(
        train_batches(cfg, job["batch"], job["seq"], 1)[0], "cuda")
    logical = init_params(cfg, 0, torch.float32, "cuda")
    plan, _ = shd.make_plan(cfg, "train", False, job["batch"], tp=mesh.tp)
    tcfg = ttr.TrainConfig(remat=False, compute_dtype=torch.float32)
    loss_u, _, g_u = ttr.value_and_grad(logical, cfg, batch, tcfg)
    grid = shd.shard_params(logical, cfg, plan, mesh, copy=True)
    ops.reset_launch_counts()
    loss_s, _, g_s = ttr.sharded_value_and_grad(grid, cfg, batch, tcfg, plan,
                                                mesh)
    del grid
    loss_rel = abs(float(loss_s) - float(loss_u)) / abs(float(loss_u))
    worst, worst_at = 0.0, ""
    for (path, a), (_, b) in zip(shd.leaves_with_paths(g_s),
                                 shd.leaves_with_paths(g_u)):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        if rel >= worst:
            worst, worst_at = rel, path
    grad_ok = loss_rel <= TRAIN_RTOL and worst <= PLANS_GRAD_RTOL
    del g_u, g_s
    # the mesh of ones: one bf16 step, sharded and unsharded
    ones = make_small_mesh([mesh.at(0, 0)], model=1)
    plan1, _ = shd.make_plan(cfg, "train", False, job["batch"], tp=1)
    tcfg = ttr.TrainConfig(opt=AdamWConfig(lr=1e-4, warmup_steps=1,
                                           total_steps=1000), remat=True)
    state_s = shd.shard_train_state(
        {"params": _clone(logical), "opt": init_opt_state(logical)}, cfg,
        plan1, ones)
    state_u = {"params": logical, "opt": init_opt_state(logical)}
    state_u, m_u = ttr.make_train_step(cfg, tcfg)(state_u, batch)
    state_s, m_s = ttr.make_train_step(cfg, tcfg, plan1, ones)(state_s,
                                                               batch)
    back = shd.gather_train_state(state_s, cfg, plan1, ones)
    ones_ok = (all(torch.equal(m_u[k], m_s[k]) for k in m_u)
               and all(torch.equal(a, b) for (_, a), (_, b) in zip(
                   shd.leaves_with_paths(back),
                   shd.leaves_with_paths(state_u))))
    del state_u, state_s, back, logical
    torch.cuda.empty_cache()
    text = (f"{cfg.name} at {job['layers']} layers, batch {job['batch']} x "
            f"seq {job['seq']}: the fp32 gradient on (data {mesh.n_batch}, "
            f"model {mesh.tp}) against the unsharded port's on the card, "
            f"loss rel {loss_rel:.3e} (rtol {TRAIN_RTOL:.0e}), worst leaf "
            f"{worst_at} max |diff| / max |leaf| {worst:.3e} (limit "
            f"{PLANS_GRAD_RTOL:.0e}); the mesh of ones's bf16 step bit-equal "
            f"to the unsharded step (params, moments, metrics) {ones_ok}")
    failed = [] if grad_ok and ones_ok else [f"plans train {arch}: {text}"]
    return failed, text


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def phase_plans_train(ops, card: str) -> list[str]:
    """The "plans" job's train runs (PLANS_TRAIN): a ``Trainer`` with the
    train plan on (data 2, model 2), fsdp and the sequence-parallel
    residual, the launch counters set to 0 just before and read just
    after; the sharded bf16 first-step loss against the unsharded port's
    on the same state and batch; then PLANS_GRAD's checks."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.models import init_params
    from repro_torch.train import trainer as ttr
    from repro_torch.train.optimizer import AdamWConfig
    failed = []
    job = PLANS_TRAIN_JOB
    dp, tp = job["mesh"]
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_small_mesh([dev] * (dp * tp), model=tp)
    for arch, layers, lr in PLANS_TRAIN:
        t_start = time.monotonic()
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        plan, run_cfg = shd.make_plan(cfg, "train", False, job["batch"],
                                      tp=tp)
        tcfg = ttr.TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=1,
                                               total_steps=1000),
                               remat=True, microbatches=1)
        batches = train_batches(cfg, job["batch"], job["seq"], job["steps"])
        # the unsharded port's loss on the first batch, bf16 and fp32
        logical = init_params(cfg, 0, torch.float32, "cuda")
        b0 = ttr.batch_to_device(batches[0], "cuda")
        with torch.no_grad():
            l_bf16 = float(ttr.loss_fn(logical, cfg, b0, tcfg)[1]["nll"])
            l_fp32 = float(ttr.loss_fn(logical, cfg, b0, dataclasses.replace(
                tcfg, compute_dtype=torch.float32))[1]["nll"])
        del logical, b0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with kernel_heads(ops) as heads:
            t0 = time.monotonic()
            tr = ttr.Trainer(cfg, tcfg, iter(batches), device="cuda",
                             plan=plan, mesh=mesh)
            hist = tr.run(job["steps"], log_every=1)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        del tr
        torch.cuda.empty_cache()
        nll = [h["nll"] for h in hist]
        want = {k: v * dp * tp for k, v in train_launches(
            cfg, 1, job["steps"]).items()}
        want.update(paged_decode=0, flash_decode=0)
        launched = all(counts[k] == v for k, v in want.items())
        shapes = (heads["flash_attention"]
                  == ({(cfg.n_q_heads // tp, cfg.n_kv_heads // tp)}
                      if cfg.has_attn else set())
                  and heads["ssd_chunk"]
                  == ({cfg.ssm_heads // tp} if cfg.has_ssm else set()))
        dist = abs(l_bf16 - l_fp32)
        limit = PLANS_BF16_FACTOR * dist
        close = abs(nll[0] - l_bf16) <= limit
        falls = all(np.isfinite(nll)) and nll[-1] < nll[0]
        ok = launched and shapes and close and falls
        steps_s = [b["wall"] - a["wall"] for a, b in zip(hist, hist[1:])]
        log(f"  [plans train {arch}] {cfg.n_layers} layers at published "
            f"widths ({cfg.param_count():,} params), batch {job['batch']} x "
            f"seq {job['seq']}, train plan on (data {dp}, model {tp}): fsdp "
            f"{plan.fsdp}, act_seq {plan.rules['act_seq']}, lr {lr}, bf16 "
            f"compute; {job['steps']} steps in {wall:.1f} s (steps after the "
            f"first {[round(x, 2) for x in steps_s]} s); nll "
            f"{[round(x, 4) for x in nll]} (falls {falls}); grad norm "
            f"{[round(h['grad_norm'], 3) for h in hist]}; peak mem "
            f"{peak:.2f} GB; {card}")
        log(f"  [plans train {arch}] step-1 loss sharded bf16 {nll[0]:.6f} vs "
            f"unsharded bf16 {l_bf16:.6f} (|diff| "
            f"{abs(nll[0] - l_bf16):.3e}); unsharded bf16 vs fp32 "
            f"{l_fp32:.6f}: |diff| {dist:.3e}, limit {PLANS_BF16_FACTOR} x "
            f"that = {limit:.3e} {close}; launches "
            f"{launches_text(counts, want)}; B2 saw "
            f"{sorted(heads['flash_attention'])}, B4 H "
            f"{sorted(heads['ssd_chunk'])} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"plans train {arch}: launches {launched}, shapes "
                          f"{shapes}, bf16 loss within {limit:.3e} {close}, "
                          f"falls {falls}")
        bad, text = plans_gradient(ops, arch, mesh)
        log(f"  [plans train {arch}] {text} {'FAIL' if bad else 'ok'} "
            f"({time.monotonic() - t_start:.1f} s for {arch})")
        failed += bad
    return failed


# --------------------------------------------------------------------------
# Phase 6: timing.
# --------------------------------------------------------------------------


KERNEL_FILES = {
    "paged_decode": ("src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/flash_decode.py:116"),
    "flash_decode": ("src/repro_torch/kernels/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:32"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:24"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_scan.py:19"),
    # no TPU kernel: the JAX package differentiates its plain attention
    # and its plain chunked SSD with XLA's autodiff
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "none: XLA autodiff of src/repro/models/attention.py:104"),
    "ssd_chunk_bwd": (
        "src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu",
        "none: XLA autodiff of src/repro/models/ssm.py:70"),
}


def _row(name, run, err, rel, ms, plain, t_bytes, t_ops,
         library_ms, shape, **extra):
    counts, n_req = run["counts"], run["n_req"]
    source, replaces = KERNEL_FILES[name]
    return {"name": name, "model": run["arch"],
            "run": run["variant"].name, "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": counts[name],
            "launches_per_request": counts[name] / n_req,
            "max_abs_err": err, "max_row_rel_err": rel,
            "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "shape": shape, **extra}


def time_paged(gen, fd, ref, run):
    """B1 at the model's decode shape (B = 8, each context mid-way through
    decode).  The timed calls rotate over ROTATIONS block tables with
    disjoint pages, so their K/V does not stay in the 50 MB L2 between
    calls: each decode layer reads its own layer's pages cold."""
    cfg = run["cfg"]
    B, Hq, Hkv, D, page = 8, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim, 16
    lens = [n + 16 for n in run["lens"]]
    n_pages = 1 << (max(1, (max(lens) + page - 1) // page) - 1).bit_length()
    rotations = 10
    q, kp, vp, _, ln, st = paged_inputs(
        gen, B, Hq, Hkv, D, page, lens, torch.bfloat16, n_pages=n_pages,
        n_pool=rotations * B * n_pages + 1)
    perm = torch.randperm(kp.shape[0] - 1, generator=gen, device="cuda")
    tables = perm.to(torch.int32).reshape(rotations, B, n_pages)
    scale = 1.0 / D ** 0.5
    got = fd.paged_decode(q, kp, vp, tables[0], ln, st, 0.0, scale)
    want = ref.paged_decode_plain(q, kp, vp, tables[0], ln, st, 0.0, scale)
    err, rel, ok = agreement(got, want, torch.bfloat16)
    if not ok:
        raise SystemExit(f"paged_decode disagrees at the timing shape: "
                         f"max_row_rel_err {rel:.3e}")
    fd.paged_decode.last_n_split = 0
    ms = time_ms(lambda i: fd.paged_decode(q, kp, vp, tables[i], ln, st, 0.0,
                                           scale), inner=rotations)
    # the split count the wrapper handed the kernel in the timed calls
    splits = fd.paged_decode.last_n_split
    device = graph_ms(lambda i: fd.paged_decode(q, kp, vp, tables[i], ln, st,
                                                0.0, scale), inner=rotations)
    plain = time_ms(lambda i: ref.paged_decode_plain(
        q, kp, vp, tables[i], ln, st, 0.0, scale), inner=rotations)
    tokens = sum(lens)
    nbytes = (2 * tokens * Hkv * D * 2          # K and V of live positions
              + 2 * B * Hq * D * 2               # q in, out
              + B * n_pages * 4 + 2 * B * 4)     # table, lens, start
    flops = 4 * tokens * Hq * D
    return _row("paged_decode", run, err, rel, ms, plain,
                nbytes / HBM_BYTES_PER_S * 1e3,
                flops / BF16_FLOPS_PER_S * 1e3, None,
                f"B={B} Hq={Hq} Hkv={Hkv} D={D} page={page} "
                f"n_pages={n_pages} lens={lens} bf16", splits=splits,
                ctas=B * Hkv * splits, device_ms=device)


def time_prefill(gen, fa, ref, run):
    cfg = run["cfg"]
    B, S = 1, max(run["lens"])
    Hq, Hkv, D = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    q = rand(gen, B, S, Hq, D, dtype=torch.bfloat16)
    k = rand(gen, B, S, Hkv, D, dtype=torch.bfloat16)
    v = rand(gen, B, S, Hkv, D, dtype=torch.bfloat16)
    got = fa.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    err, rel, ok = agreement(got, want, torch.bfloat16)
    if not ok:
        raise SystemExit(f"flash_attention disagrees at the timing shape: "
                         f"max_row_rel_err {rel:.3e}")
    ms = time_ms(lambda i: fa.flash_attention(q, k, v))
    device = graph_ms(lambda i: fa.flash_attention(q, k, v))
    plain = time_ms(lambda i: ref.flash_attention_ref(q, k, v))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = B * S * (S + 1) // 2                 # unmasked (q, k) pairs
    flops = 4 * pairs * Hq * D
    nbytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
    return _row("flash_attention", run, err, rel, ms,
                plain, nbytes / HBM_BYTES_PER_S * 1e3,
                flops / BF16_FLOPS_PER_S * 1e3, lib,
                f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal bf16",
                device_ms=device)


def time_dense(gen, fd, ref, run):
    """B3 at the dense run's decode shape: B = 8, each context mid-way
    through decode, a dense cache of S = the longest context.  The timed
    calls rotate over ROTATIONS caches, so their K/V does not stay in the
    50 MB L2 between calls, as each layer's gathered cache would not.
    Library: ``scaled_dot_product_attention`` with a boolean length mask
    and GQA, one PyTorch call computing the same function (softcap 0)."""
    cfg = run["cfg"]
    B, Hq, Hkv, D = 8, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    lens = [n + 16 for n in run["lens"]]
    S = max(lens)
    rotations = 10
    q, k, v, ln, st = dense_inputs(gen, B, S, Hq, Hkv, D, lens,
                                   torch.bfloat16, rot=rotations)
    scale = 1.0 / D ** 0.5
    got = fd.flash_decode(q, k[0], v[0], ln, st, 0.0, scale)
    want = ref.flash_decode_plain(q, k[0], v[0], ln, st, 0.0, scale)
    err, rel, ok = agreement(got, want, torch.bfloat16)
    mask = (torch.arange(S, device="cuda")[None, :] < ln[:, None])
    mask = mask[:, None, None, :]                       # [B, 1, 1, S]
    qt = q[:, :, None, :]                               # [B, Hq, 1, D]
    kt, vt = k.transpose(2, 3), v.transpose(2, 3)       # [rot, B, Hkv, S, D]

    def library(i):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt[i], vt[i], attn_mask=mask, enable_gqa=True)

    if not ok:
        raise SystemExit(f"flash_decode disagrees at the timing shape: "
                         f"max_row_rel_err {rel:.3e}")
    # the library call's own distance from the plain version, for the
    # record (it rounds in bf16 where it likes)
    _, lib_rel, _ = row_rel(library(0)[:, :, 0], want)
    fd.flash_decode.last_n_split = 0
    ms = time_ms(lambda i: fd.flash_decode(q, k[i], v[i], ln, st, 0.0,
                                           scale), inner=rotations)
    # the split count the wrapper handed the kernel in the timed calls
    splits = fd.flash_decode.last_n_split
    device = graph_ms(lambda i: fd.flash_decode(q, k[i], v[i], ln, st, 0.0,
                                                scale), inner=rotations)
    plain = time_ms(lambda i: ref.flash_decode_plain(
        q, k[i], v[i], ln, st, 0.0, scale), inner=rotations)
    lib = time_ms(library, inner=rotations)
    tokens = sum(lens)
    nbytes = (2 * tokens * Hkv * D * 2          # K and V of live positions
              + 2 * B * Hq * D * 2               # q in, out
              + 2 * B * 4)                       # lens, start
    flops = 4 * tokens * Hq * D
    return _row("flash_decode", run, err, rel, ms, plain,
                nbytes / HBM_BYTES_PER_S * 1e3,
                flops / BF16_FLOPS_PER_S * 1e3, lib,
                f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} lens={lens} bf16",
                library_max_row_rel_err=lib_rel, splits=splits,
                ctas=B * Hkv * splits, device_ms=device)


def time_dense_lse(gen, fd, ref, run):
    """B3's lse form at one sequence shard of a plans run's decode cache
    (``run["lse_shape"]``: a data group's B rows over S positions, each
    attending its first ``n`` of them mid-way through decode).  Library:
    ``flex_attention`` (``library_flex_lse``), which returns the attention
    and its log-sum-exp in one call."""
    cfg = run["cfg"]
    B, S, n = run["lse_shape"]
    Hq, Hkv, D = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    rotations = 10
    q, k, v, ln, st = dense_inputs(gen, B, S, Hq, Hkv, D, [n] * B,
                                   torch.bfloat16, rot=rotations)
    scale = 1.0 / D ** 0.5
    got, lse = fd.flash_decode(q, k[0], v[0], ln, st, 0.0, scale,
                               with_lse=True)
    want, want_lse = ref.flash_decode_plain(q, k[0], v[0], ln, st, 0.0,
                                            scale, with_lse=True)
    err, rel, ok = agreement(got, want, torch.bfloat16)
    lse_err = float((lse - want_lse).abs().max())
    if not ok or lse_err > LSE_ATOL:
        raise SystemExit(f"flash_decode lse disagrees at the timing shape: "
                         f"max_row_rel_err {rel:.3e}, lse_err {lse_err:.3e}")
    fd.flash_decode.last_n_split = 0

    def call(i):
        return fd.flash_decode(q, k[i], v[i], ln, st, 0.0, scale,
                               with_lse=True)
    ms = time_ms(call, inner=rotations)
    splits = fd.flash_decode.last_n_split
    device = graph_ms(call, inner=rotations)
    plain = time_ms(lambda i: ref.flash_decode_plain(
        q, k[i], v[i], ln, st, 0.0, scale, with_lse=True), inner=rotations)
    library = library_flex_lse(q, k, v, ln, st, scale)
    # the library call's own distance from the plain version, for the
    # record
    lib_out, lib_lse = library(0)
    _, lib_rel, _ = row_rel(lib_out[:, :, 0], want)
    lib_lse_err = float((lib_lse[:, :, 0].float() - want_lse).abs().max())
    lib = time_ms(library, inner=rotations)
    tokens = B * n
    nbytes = (2 * tokens * Hkv * D * 2          # K and V of live positions
              + 2 * B * Hq * D * 2               # q in, out
              + B * Hq * 4                       # lse out
              + 2 * B * 4)                       # lens, start
    flops = 4 * tokens * Hq * D
    return _row("flash_decode", run, err, rel, ms, plain,
                nbytes / HBM_BYTES_PER_S * 1e3,
                flops / BF16_FLOPS_PER_S * 1e3, lib,
                f"lse form, one sequence shard: B={B} S={S} Hq={Hq} "
                f"Hkv={Hkv} D={D} lens={n} bf16",
                lse_err=lse_err, library_max_row_rel_err=lib_rel,
                library_lse_err=lib_lse_err, splits=splits,
                ctas=B * Hkv * splits, device_ms=device)


def library_flex_lse(q, k, v, lens, start, scale):
    """One PyTorch call computing B3's lse form: ``flex_attention``
    compiled (as it is meant to be called: eager, it runs its plain
    reference), q [B, Hq, 1, D] over the rotated caches [rot, B, Hkv, S,
    D], the window [start, lens) of each row as a block mask, GQA, the
    log-sum-exp returned.  Returns ``call(i)`` -> (out [B, Hq, 1, D], lse
    [B, Hq, 1] fp32, natural log).  Inductor's and Triton's caches go
    under the checkout's ``build/``."""
    build = os.path.join(HERE, "build")
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          os.path.join(build, "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    from torch.nn.attention import flex_attention as fx
    B, Hq, D = q.shape
    S = k.shape[2]

    def window(b, h, q_idx, kv_idx):
        return (kv_idx >= start[b]) & (kv_idx < lens[b])
    mask = fx.create_block_mask(window, B, None, 1, S, device="cuda")
    flex = torch.compile(fx.flex_attention, dynamic=False)
    qt = q[:, :, None, :]
    kt, vt = k.transpose(2, 3), v.transpose(2, 3)
    aux = hasattr(fx, "AuxRequest")
    kw = ({"return_aux": fx.AuxRequest(lse=True)} if aux
          else {"return_lse": True})

    def call(i):
        out, extra = flex(qt, kt[i], vt[i], block_mask=mask, scale=scale,
                          enable_gqa=True, **kw)
        return out, (extra.lse if aux else extra)
    return call


def time_chunk(gen, fa, ref, run):
    """B2 on one prefill chunk: CHUNK queries at positions CHUNK_OFFSET +
    [0, CHUNK) over the CHUNK_OFFSET + CHUNK keys before and in it.
    Library: ``scaled_dot_product_attention`` with the offset causal mask
    as a boolean mask and GQA."""
    cfg = run["cfg"]
    B, C, off = 1, CHUNK, CHUNK_OFFSET
    Hq, Hkv, D = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    q = rand(gen, B, C, Hq, D, dtype=torch.bfloat16)
    k = rand(gen, B, off + C, Hkv, D, dtype=torch.bfloat16)
    v = rand(gen, B, off + C, Hkv, D, dtype=torch.bfloat16)
    got = fa.flash_attention(q, k, v, q_offset=off)
    want = ref.flash_attention_ref(q, k, v, q_offset=off)
    err, rel, ok = agreement(got, want, torch.bfloat16)
    if not ok:
        raise SystemExit(f"flash_attention disagrees at the chunk shape: "
                         f"max_row_rel_err {rel:.3e}")
    ms = time_ms(lambda i: fa.flash_attention(q, k, v, q_offset=off))
    device = graph_ms(lambda i: fa.flash_attention(q, k, v, q_offset=off))
    # the device-offset form, as the chunk graph launches it
    off_t = torch.tensor(off, dtype=torch.int32, device="cuda")
    if not torch.equal(fa.flash_attention(q, k, v, q_offset=off_t), got):
        raise SystemExit("flash_attention's device-offset form differs from "
                         "its by-value form at the chunk shape")
    dev_ms = time_ms(lambda i: fa.flash_attention(q, k, v, q_offset=off_t))
    dev_device = graph_ms(lambda i: fa.flash_attention(q, k, v,
                                                       q_offset=off_t))
    plain = time_ms(lambda i: ref.flash_attention_ref(q, k, v,
                                                      q_offset=off))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (torch.arange(off + C, device="cuda")[None, :]
            <= off + torch.arange(C, device="cuda")[:, None])
    lib = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True))
    pairs = B * (C * off + C * (C + 1) // 2)     # unmasked (q, k) pairs
    flops = 4 * pairs * Hq * D
    nbytes = 2 * (2 * B * C * Hq * D + 2 * B * (off + C) * Hkv * D)
    return _row("flash_attention", run, err, rel, ms, plain,
                nbytes / HBM_BYTES_PER_S * 1e3,
                flops / BF16_FLOPS_PER_S * 1e3, lib,
                f"B={B} C={C} q_offset={off} Sk={off + C} Hq={Hq} Hkv={Hkv} "
                f"D={D} causal bf16", device_ms=device,
                device_offset_ms=dev_ms, device_offset_device_ms=dev_device)


def time_ssd(gen, ssd, ref, run):
    """B4 at the model's longest phase-5 prompt, chunked as ``ssd_chunked``
    chunks it (Q = min(chunk, L), L padded to a multiple of Q), fp32.  The
    inputs are not rotated: in prefill the kernel reads x, dt, B and C
    right after the conv wrote them.  Bound: each input read and each
    output written once; operations C.B once per group and causal pair,
    score @ (dt x) and the state product once per head, at the card's
    tensor-core rate for fp32 inputs (TF32).  Beside it: the same
    operations at the fp32 rate outside the tensor cores, where the kernel
    ran before it moved onto them (``bound_ms_fp32_cuda_cores``), and the
    three TF32 products its 3xTF32 issues for each
    (``bound_ms_3xtf32``)."""
    cfg = run["cfg"]
    L = max(run["lens"])
    Q = min(cfg.ssm_chunk, L)
    B, Nc = 1, -(-L // Q)
    H, P, N, G = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_groups)
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, Nc, Q, H, P, N, G)
    y, S = ssd.ssd_chunk(x, dt, A, Bm, Cm)
    y_want, S_want = ref.ssd_chunk_plain(x, dt, A, Bm, Cm)
    err, rel = 0.0, 0.0
    for got, want in ((y, y_want), (S, S_want)):
        e, r, finite = row_rel(got, want)
        err, rel = max(err, e), max(rel, r)
        if not finite or r > ROW_RTOL_SSD:
            raise SystemExit(f"ssd_chunk disagrees at the timing shape: "
                             f"max_row_rel_err {r:.3e}")
    ms = time_ms(lambda i: ssd.ssd_chunk(x, dt, A, Bm, Cm))
    device = graph_ms(lambda i: ssd.ssd_chunk(x, dt, A, Bm, Cm))
    plain = time_ms(lambda i: ref.ssd_chunk_plain(x, dt, A, Bm, Cm))
    chunks = B * Nc
    pairs = Q * (Q + 1) // 2
    flops = chunks * (pairs * 2 * N * G + pairs * 2 * P * H
                      + 2 * Q * P * N * H)
    nbytes = 4 * (2 * chunks * Q * H * P          # x in, y out
                  + chunks * H * P * N             # S out
                  + 2 * chunks * Q * G * N         # B, C
                  + chunks * Q * H + H)            # dt, A
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return _row("ssd_chunk", run, err, rel, ms, plain, t_bytes,
                flops / TF32_FLOPS_PER_S * 1e3, None,
                f"B={B} Nc={Nc} Q={Q} H={H} P={P} N={N} G={G} (L={L}) fp32",
                device_ms=device,
                bound_ms_fp32_cuda_cores=max(
                    t_bytes, flops / FP32_FLOPS_PER_S * 1e3),
                bound_ms_3xtf32=max(
                    t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3))


def bwd_by_launch(fab, call, kw) -> dict[str, float]:
    """{kernel: device ms a call} of B2's backward, from the profiler over
    10 calls: its launches (delta, then dK/dV, in two passes at D = 256,
    and dQ) by the name after ``attn_bwd_``."""
    from torch.profiler import ProfilerActivity, profile
    fab.flash_attention_bwd(*call, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fab.flash_attention_bwd(*call, **kw)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "attn_bwd_" in e.key:
            name = e.key.split("attn_bwd_", 1)[1].split("(", 1)[0]
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            out[name] = out.get(name, 0.0) + t / 10 / 1e3
    return out


def library_attention_bwd(q, k, v, dout, softcap, window):
    """One PyTorch call computing B2's backward, as ``call(i)`` ->
    (dq, dk, dv) in [B, H, S, D] (``torch.autograd.grad`` through a kept
    graph, K/V expanded to the query heads): of
    ``scaled_dot_product_attention`` (is_causal) without a softcap, which
    SDPA does not take; with one, of ``flex_attention`` compiled, the cap
    as its score_mod and the causal window as a block mask (Inductor's and
    Triton's caches under the checkout's ``build/``)."""
    S, rep = q.shape[1], q.shape[2] // k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v))
    if softcap > 0:
        build = os.path.join(HERE, "build")
        os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                              os.path.join(build, "inductor"))
        os.environ.setdefault("TRITON_CACHE_DIR",
                              os.path.join(build, "triton"))
        from torch.nn.attention import flex_attention as fx

        def causal(b, h, q_idx, kv_idx):
            ok = kv_idx <= q_idx
            return ok & (kv_idx > q_idx - window) if window > 0 else ok

        def cap(score, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(score / softcap)
        mask = fx.create_block_mask(causal, None, None, S, S, device="cuda")
        flex = torch.compile(fx.flex_attention, dynamic=False)
        o = flex(qt, kt, vt, score_mod=cap, block_mask=mask,
                 enable_gqa=True)
    else:
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt.repeat_interleave(rep, 1), vt.repeat_interleave(rep, 1),
            is_causal=True)
    dot = dout.transpose(1, 2)
    return lambda i: torch.autograd.grad(o, (qt, kt, vt), dot,
                                         retain_graph=True)


def bwd_bound_ms(B, S, Hq, Hkv, D, window) -> tuple[float, float]:
    """B2's backward's bound, (bytes ms, operations ms): q, k, v, out, dO
    and lse read and dq, dk, dv written once at the memory rate; five
    products of 2 D FLOPs per unmasked (q, k) pair and head at the bf16
    rate."""
    if 0 < window < S:
        pairs = B * sum(min(i + 1, window) for i in range(S))
    else:
        pairs = B * S * (S + 1) // 2
    nbytes = (2 * (3 * B * S * Hq * D + 2 * B * S * Hkv * D)   # q out dO k v
              + 4 * B * Hq * S                                  # lse
              + 2 * (B * S * Hq * D + 2 * B * S * Hkv * D))     # dq dk dv
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            5 * 2 * pairs * D * Hq / BF16_FLOPS_PER_S * 1e3)


def time_prefill_bwd(gen, fa, fab, ref, run):
    """B2's backward at a train run's shape (B = its microbatch, S = its
    sequence, the model's heads, softcap and local window), bf16, on the
    forward kernel's out and lse and a random dO, twice bit-equal; each
    launch's device time (``bwd_by_launch``).  Library:
    ``library_attention_bwd`` (its distance from the plain version kept
    too).  Bound: ``bwd_bound_ms``."""
    cfg = run["cfg"]
    B, S = run["shape"]
    Hq, Hkv, D = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    cap, win = cfg.attn_logit_softcap, cfg.local_window
    q = rand(gen, B, S, Hq, D, dtype=torch.bfloat16)
    k = rand(gen, B, S, Hkv, D, dtype=torch.bfloat16)
    v = rand(gen, B, S, Hkv, D, dtype=torch.bfloat16)
    dout = rand(gen, B, S, Hq, D, dtype=torch.bfloat16)
    out, lse = fa.flash_attention(q, k, v, softcap=cap, window=win,
                                  with_lse=True)
    call, kw = (q, k, v, out, dout, lse), dict(softcap=cap, window=win)
    got = fab.flash_attention_bwd(*call, **kw)
    again = fab.flash_attention_bwd(*call, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.flash_attention_bwd_plain(*call, True, cap, win)
    err = rel = 0.0
    for g, w in zip(got, want):
        e, r, ok = grad_agreement(g, w, torch.bfloat16)
        err, rel = max(err, e), max(rel, r)
        if not ok or not same:
            raise SystemExit(f"flash_attention_bwd disagrees at the timing "
                             f"shape: max_row_rel_err {r:.3e}, twice "
                             f"bit-equal {same}")
    # 10 groups of 5: the call takes up to ~16 ms at yi-9b's shape
    ms = time_ms(lambda i: fab.flash_attention_bwd(*call, **kw), reps=10,
                 inner=5)
    device = graph_ms(lambda i: fab.flash_attention_bwd(*call, **kw),
                      reps=10, inner=5)
    by_launch = bwd_by_launch(fab, call, kw)
    plain = time_ms(lambda i: ref.flash_attention_bwd_plain(
        *call, True, cap, win), reps=5, inner=2)
    library = library_attention_bwd(q, k, v, dout, cap, win)
    lib_rel = max(grad_agreement(g.transpose(1, 2), w, torch.bfloat16)[1]
                  for g, w in zip(library(0), want))
    lib = time_ms(library)
    row = _row("flash_attention_bwd", run, err, rel, ms, plain,
               *bwd_bound_ms(B, S, Hq, Hkv, D, win), lib,
               f"B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} causal"
               + (f" softcap={cap:g}" if cap > 0 else "")
               + (f" window={win}" if win > 0 else "") + " bf16",
               device_ms=device, by_launch_ms=by_launch,
               twice_bit_equal=same, library_max_row_rel_err=lib_rel)
    row["launches_per_step"] = row.pop("launches_per_request")
    return row


def time_ssd_bwd(gen, ssb, ref, run):
    """B4's backward at a train run's microbatch shape (B = its microbatch,
    L = its sequence, chunked as ``ssd_chunked`` chunks it), fp32, random
    dy and dS.  Bound: x, dt, A, B, C, dy and dS read and dx, ddt, dA, dB
    and dC written once; operations the five Q x Q products over each
    causal pair (C.B^T, dC and dB once per group, their dCB summed over the
    group's heads first; dy.x^T and W^T dy per head) and the state's two
    (dS B and dS^T x per head and position), at the TF32 tensor-core rate
    as B4's forward row counts them; beside it, the three TF32 products
    its 3xTF32 issues for each (``bound_ms_3xtf32``).  The kernel itself
    forms C.B^T once per block of 256 / P heads (4 at P = 64; half that
    where N <= 32), not once a group, and whole 64 x 64 tiles on the
    diagonal: ``gflop_issued`` counts that, ``gflop`` the bound's
    operations.  No single PyTorch call computes it (autograd of
    ``ref.ssd_chunk_plain`` is a chain of calls)."""
    cfg = run["cfg"]
    Bsz, L = run["shape"]
    Q = min(cfg.ssm_chunk, L)
    Nc = -(-L // Q)
    H, P, N, G = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_groups)
    inputs = ssd_inputs(gen, Bsz, Nc, Q, H, P, N, G)
    dy = rand(gen, Bsz, Nc, Q, H, P, scale=1.0)
    dS = rand(gen, Bsz, Nc, H, P, N, scale=1.0)
    got = ssb.ssd_chunk_bwd(*inputs, dy, dS)
    err, rel, ok = ssd_bwd_agreement(got, ssd_bwd_plain(ref, inputs, dy,
                                                        dS))
    if not ok:
        raise SystemExit(f"ssd_chunk_bwd disagrees at the timing shape: "
                         f"max_rel_err {rel:.3e}")
    ms = time_ms(lambda i: ssb.ssd_chunk_bwd(*inputs, dy, dS))
    device = graph_ms(lambda i: ssb.ssd_chunk_bwd(*inputs, dy, dS))
    plain = time_ms(lambda i: ref.ssd_chunk_bwd_plain(*inputs, dy, dS),
                    reps=5, inner=2)
    chunks = Bsz * Nc
    pairs = Q * (Q + 1) // 2
    flops = chunks * (3 * pairs * 2 * N * G + 2 * pairs * 2 * P * H
                      + 2 * 2 * Q * P * N * H)
    nbytes = 4 * (3 * chunks * Q * H * P            # x, dy in; dx out
                  + chunks * H * P * N             # dS in
                  + 2 * 2 * chunks * Q * G * N     # B, C in; dB, dC out
                  + 2 * chunks * Q * H + 2 * H)    # dt in, ddt out; A, dA
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    n_rt = -(-Q // 64)
    tiles = n_rt * (n_rt + 1) // 2 * 64 * 64    # tile pairs' (t, s) entries
    hb = (256 // P if P >= 32 else 8) // (2 if N <= 32 else 1)
    blocks = G * -(-(H // G) // hb)             # head blocks (C.B^T each)
    issued = chunks * (tiles * 2 * N * (blocks + 2 * G)
                       + tiles * 2 * 2 * P * H + 2 * 2 * Q * P * N * H)
    row = _row("ssd_chunk_bwd", run, err, rel, ms, plain, t_bytes,
               flops / TF32_FLOPS_PER_S * 1e3, None,
               f"B={Bsz} Nc={Nc} Q={Q} H={H} P={P} N={N} G={G} (L={L}) fp32",
               device_ms=device,
               bound_ms_3xtf32=max(
                   t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3),
               gflop=flops / 1e9, gflop_issued=issued / 1e9)
    row["launches_per_step"] = row.pop("launches_per_request")
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_chunk_bwd as ssb
    from repro_torch.kernels import ssd_scan as ssd

    t_start = time.monotonic()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.monotonic()
    reports = build.build_all()
    log(f"[2] built {sorted(reports) or 'nothing (cached)'} in "
        f"{time.monotonic() - t0:.1f} s")
    for name, text in reports.items():
        fn, spills = "?", ""
        for line in text.splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for", 1)[1].strip()
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                regs = line.split(":", 1)[1].strip()
                log(f"    {name}: {regs}; {spills} [{fn}]")
    hmma = hmma_counts(build, "flash_attention")
    for fn, n in sorted(hmma.items()):
        log(f"    flash_attention SASS: {tensor_core_text(n)} in {fn}")
    bf16 = {fn: n["HMMA"] for fn, n in hmma.items()
            if "flash_attention_bf16" in fn}
    if len(bf16) != len(build.HEAD_DIMS) or not all(bf16.values()):
        raise SystemExit(f"the bf16 prefill kernels do not all run on the "
                         f"tensor cores: HMMA counts {bf16}")
    hmma = hmma_counts(build, "flash_attention_bwd")
    for fn, n in sorted(hmma.items()):
        log(f"    flash_attention_bwd SASS: {tensor_core_text(n)} in {fn}")
    # the bf16 backward's product kernels (dK/dV, in two passes at D = 256,
    # and dQ) at every head dim run on wgmma
    for kernel in ("attn_bwd_dkdv_wg", "attn_bwd_dq_wg"):
        for d in build.HEAD_DIMS:
            wg = {fn: n["HGMMA"] for fn, n in hmma.items()
                  if f"{kernel}ILi{d}E" in fn}
            if not wg or not all(wg.values()):
                raise SystemExit(f"the bf16 backward's {kernel} at D = {d} "
                                 f"does not run on wgmma: HGMMA counts {wg}")
    hmma = hmma_counts(build, "ssd_chunk")
    for fn, n in sorted(hmma.items()):
        log(f"    ssd_chunk SASS: {tensor_core_text(n)} in {fn}")
    # the instantiations for the served models' SSM head dim (P = 64),
    # one for each head block size
    served = {fn: n["HMMA"] for fn, n in hmma.items()
              if "ssd_chunk_kernelILi64E" in fn}
    if not served or not all(served.values()):
        raise SystemExit(f"the SSD chunk kernel at P = 64 does not run on "
                         f"the tensor cores: HMMA counts {served}")
    hmma = hmma_counts(build, "ssd_chunk_bwd")
    for fn, n in sorted(hmma.items()):
        log(f"    ssd_chunk_bwd SASS: {tensor_core_text(n)} in {fn}")
    # its tile kernel at the served models' P = 64 (3xTF32 mma.sync)
    served = {fn: n["HMMA"] for fn, n in hmma.items()
              if "ssd_bwd_tiles_kernelILi64E" in fn}
    if not served or not all(served.values()):
        raise SystemExit(f"the SSD backward's tile kernel at P = 64 does not "
                         f"run on the tensor cores: HMMA counts {served}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    log("[3] kernels vs plain versions")
    check_paged(gen, fd, ref)
    check_paged_split(gen, fd, ref)
    check_dense(gen, fd, ref)
    check_split(gen, fd, ref)
    check_dense_lse(gen, fd, ref)
    check_prefill(gen, fa, ref)
    check_chunk(gen, fa, ref)
    check_prefill_bwd(gen, fa, fab, ref)
    check_ssd(gen, ssd, ref)
    check_ssd_bwd(gen, ops, ssb, ref)

    log("[4] greedy decoding")
    phase_greedy()
    phase_moe_capacity()
    phase_cluster_smoke()
    phase_orchestrated_smoke()
    phase_evaluation_smoke(ops)
    phase_train_smoke(ops)
    phase_quickstart()

    runs, failures = [], []
    for i, (arch, variants) in enumerate(FULL_WIDTH):
        log(f"[5.{i + 1}] {arch} at full width "
            f"({', '.join(v.name for v in variants)})")
        runs += phase_full_width(ops, arch, variants, failures)
    log(f"[5.{len(FULL_WIDTH) + 1}] the control loop: the predictor, then "
        f"{ORCH_MODEL} ({ORCH_LAYERS} layers) planned and switched over "
        f"{ORCH_JOB['spans']} spans (orchestrated)")
    run, failed = phase_orchestrated(ops)
    runs.append(run)
    failures += failed
    log(f"[5.{len(FULL_WIDTH) + 2}] the paper's evaluation: the simulator "
        f"at H100 rates, the LSTM in the loop and the predictor study "
        f"(evaluation)")
    failures += phase_evaluation(card)
    log(f"[5.{len(FULL_WIDTH) + 3}] the trainer: yi-100m with a resume, "
        f"yi-9b at {TRAIN_B['layers']} layers, a full-width gradient "
        f"against the CPU, mamba2-370m (48 layers) with a resume, "
        f"hymba-1.5b (32 layers), 2-layer SSM gradients against the CPU, "
        f"gemma2-2b at {TRAIN_G['layers']} layers (train)")
    train_runs, failed = phase_train(ops, card)
    runs += train_runs
    failures += failed
    log(f"[5.{len(FULL_WIDTH) + 4}] the train plan: "
        + ", ".join(f"{a} at {n} layers" for a, n, _ in PLANS_TRAIN)
        + " on (data 2, model 2) with fsdp and the sequence-parallel "
        "residual (plans)")
    failures += phase_plans_train(ops, card)

    log("[6] kernel timing (CUDA events: median of 20 groups of 10 calls, "
        "back to back and replayed from a CUDA graph)")
    timers = {"paged_decode": lambda run: time_paged(gen, fd, ref, run),
              "flash_decode": lambda run: time_dense(gen, fd, ref, run),
              "flash_decode_lse": lambda run: time_dense_lse(gen, fd, ref,
                                                             run),
              "flash_attention": lambda run: time_prefill(gen, fa, ref, run),
              "flash_attention_chunk": lambda run: time_chunk(gen, fa, ref,
                                                              run),
              "ssd_chunk": lambda run: time_ssd(gen, ssd, ref, run),
              "flash_attention_bwd": lambda run: time_prefill_bwd(
                  gen, fa, fab, ref, run),
              "ssd_chunk_bwd": lambda run: time_ssd_bwd(gen, ssb, ref, run)}
    rows = [timers[name](run) for run in runs
            for name in run["variant"].timed]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {r['name']} ({r['model']}, {r['run']} run): kernel_ms "
            f"{r['ms']:.4f} (graph replay {r['device_ms']:.4f})  bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']})"
            f"  plain_ms {r['plain_ms']:.4f}  library_ms {lib}  launches "
            f"{r['launches']} ("
            + (f"{r['launches_per_step']:.1f}/step)"
               if "launches_per_step" in r
               else f"{r['launches_per_request']:.1f}/request)")
            + (f"  splits {r['splits']} ({r['ctas']} CTAs)"
               if "splits" in r else "")
            + (f"  device-offset form {r['device_offset_ms']:.4f} (graph "
               f"replay {r['device_offset_device_ms']:.4f})"
               if "device_offset_ms" in r else "")
            + ("  by launch " + ", ".join(
                f"{k} {t:.4f}" for k, t in r["by_launch_ms"].items())
               if "by_launch_ms" in r else "") + f"  [{r['shape']}]")
    log(f"total {time.monotonic() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    if failures:
        for f in failures:
            print(f"chip_smoke: {f}", file=sys.stderr)
        log(f"chip_smoke: {len(failures)} graphs, migrate, prefix, evict, "
            f"cluster, sharded, plans, orchestrated, evaluation or train "
            f"check(s) failed: "
            f"{'; '.join(failures)}")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
