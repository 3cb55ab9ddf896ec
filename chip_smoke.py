"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/`` beside this
file; it exits non-zero without them.  Phases, in order (a failure exits
non-zero before the result lines; a failed check of phase 5's "migrate",
"prefix", "evict", "cluster" or "orchestrated" runs is reported, and exits
non-zero, after phase 6 has run and printed its table):

  1. the card's name and power limit, the CUDA version; TF32 off;
  2. build every kernel from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a)
     and print registers and spills; count the tensor-core instructions
     (``HMMA``, from ``cuobjdump -sass``) of each prefill and SSD chunk
     instantiation and fail if the bf16 prefill ones or the SSD chunk one
     the served models use (P = 64) have none;
  3. hold each kernel against its plain PyTorch version on the card, fp32
     (absolute 1e-4; the SSD chunk kernel 1e-4 of each output row's
     largest value) and bf16 (1e-2 of each output row's largest value), at
     smoke and serving shapes (yi-9b, gemma2-2b, hymba-1.5b, mamba2-370m),
     the prefill kernel also at a chunk's query offset, both decode
     kernels also split over many CTAs and, at fixed split counts, against
     the plain split-and-combine, the SSD chunk kernel also at ragged
     state widths, long chunks and unaligned inputs, and causal to the
     bit (a row's output is the same whatever rows follow it);
  4. greedy decoding: the smoke configs give the same tokens on the card
     and the CPU in every engine mode (paged at decode_horizon 1 and 8,
     the dense mode, chunked prefill, the prefix cache); 2-layer full-width
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
     switch every span with requests in flight) gives the same plans,
     switch and span reports and tokens per rid on the card and the CPU;
  5. the served models at full width, one after another: yi-9b (48
     layers) three times on the same weights (paged decode, the dense
     decode mode, chunked prefill in 256-token budgets), hymba-1.5b (32)
     and mamba2-370m (48), bf16, random weights from a seeded generator,
     each run serving 8 requests through ``ServingEngine``; the launch
     counters are set to 0 just before each run and read just after it,
     every kernel on that run's path must have launched (and the dense run
     no paged decode, the chunked run the prefill kernel more than once per
     layer and request); at least 90 % of the generated tokens must equal a
     teacher-forced forward's argmax; then, on the same weights, the
     "migrate" runs: yi-9b by handoff, copy, relayout and re-prefill,
     hymba-1.5b by handoff, copy and re-prefill.  The paged job's source
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
     recovery stalls, TTFT and decode rate beside the card's line; last
     the "orchestrated" job, OServe's control loop (predict -> plan ->
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
     card's;
  6. time each kernel at each run's serving shapes with CUDA events
     (median of 20 groups of 10 back-to-back calls) beside its bound, its
     plain version and, where one exists, one PyTorch library call
     computing the same function, and again as the same 10 calls replayed
     from a CUDA graph (``device_ms``: no host work between the kernels,
     so a kernel faster than its wrapper's host code shows its own time);
     each timed kernel's output is checked again; the decode rows also
     give their split counts and CTAs, as the wrappers launched them.

The last three lines are the card line, one JSON object with the kernel
table (one row per kernel and timed run) and ``{"ok": true, "device":
{...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
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
)
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


def hmma_counts(build, lib: str) -> dict[str, int]:
    """{kernel function: HMMA instructions in its SASS} for the library
    built from ``csrc/<lib>.cu``, from ``cuobjdump -sass``."""
    text = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass", str(build.lib_path(lib))],
        check=True, capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HMMA" in line:
            counts[fn] += 1
    return counts


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
            log(f"  flash_attention q_offset {name:14s} {str(dtype):14s} "
                f"max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
                f"{tol_text(dtype)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"flash_attention q_offset {name} {dtype} "
                                 "disagrees")


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
    cases = [
        # name, B, Nc, Q, H, P, N, G
        ("smoke", 2, 2, 64, 4, 16, 16, 1),
        ("ragged-q100", 1, 1, 100, 4, 32, 16, 1),
        ("groups2", 1, 2, 64, 8, 32, 16, 2),
        ("mamba2", 1, 4, 256, 32, 64, 128, 1),
        ("mamba2-q195", 2, 1, 195, 32, 64, 128, 1),
        ("hymba", 1, 4, 256, 25, 64, 16, 1),
        ("hymba-batch", 3, 2, 256, 25, 64, 16, 1),
        # chunks longer than 256 and P = 128
        ("q300", 1, 2, 300, 6, 64, 128, 2),
        ("q1024", 1, 1, 1024, 4, 128, 64, 1),
        # B/C rows off 16 bytes: 4-byte staging (N % 4 != 0)
        ("ragged-n13", 1, 2, 130, 8, 32, 13, 2),
        ("n200-p128", 1, 1, 256, 4, 128, 200, 1),
        ("p16-n256", 1, 2, 77, 4, 16, 256, 1),
    ]
    for name, B, Nc, Q, H, P, N, G in cases:
        x, dt, A, Bm, Cm = ssd_inputs(gen, B, Nc, Q, H, P, N, G)
        if name == "ragged-n13":
            # and every input 4 bytes past a 16-byte boundary
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
    for name, H, P, N, n in (("hymba", 25, 64, 16, 203),
                             ("mamba2", 32, 64, 128, 77)):
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


# --------------------------------------------------------------------------
# Phases 4 and 5: the engine.
# --------------------------------------------------------------------------


def serve(cfg, params, prompts, new_tokens, device, **engine_kw):
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(cfg, params, device=device, **engine_kw)
    for rid, p in enumerate(prompts):
        eng.submit(rid, p, new_tokens)
    t0 = time.monotonic()
    fin = eng.run_to_completion()
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    return {r.rid: r for r in fin}, eng, wall


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
    for arch in ("yi-9b", "gemma2-2b", "mamba2-370m", "hymba-1.5b"):
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
    for arch, _ in FULL_WIDTH:
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
# The orchestrated path: the workload predictor, ``Orchestrator.plan_span``
# and ``ClusterRuntime.apply_plan`` (phase 4's twin of ``run_real_spans`` on
# the card and the CPU, phase 5's "orchestrated" job at full width).
# --------------------------------------------------------------------------


def real_spans_twin(device: str) -> dict:
    """``serving.validation.run_real_spans`` on llama2-70b's smoke config
    over 6 chips and 3 spans (fp32, seeded weights drawn on the CPU): the
    plans, the switch and span reports and the tokens per request id."""
    from repro_torch.serving.validation import run_real_spans
    outcomes, rt = run_real_spans(model="llama2-70b", chips=6, n_spans=3,
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
    """Phase 4's orchestrated check: ``run_real_spans`` (llama2-70b smoke,
    6 chips, 3 spans, a switch every span with requests in flight) gives
    the same plans, reports and tokens per rid on the card and the CPU."""
    t0 = time.monotonic()
    got = {dev: real_spans_twin(dev) for dev in ("cpu", "cuda")}
    card = got["cuda"]
    same = {k: card[k] == got["cpu"][k] for k in card}
    moved = sum(s["migrated"] for s in card["switches"])
    log(f"  orchestrated run_real_spans llama2-70b smoke: plans "
        f"{[p[0] for p in card['plans']]}; migrated {moved}; "
        f"{len(card['tokens'])} requests; card == CPU {same} "
        f"({time.monotonic() - t0:.1f} s)")
    if not all(same.values()) or len(card["tokens"]) != 18:
        raise SystemExit("run_real_spans: the card's plans, reports or "
                         f"tokens differ from the CPU's ({same})")


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
                    ctx: int) -> tuple[float, float]:
    """(one request's prefill of ``prompt_len`` tokens, one decode step at
    ``batch`` sequences of ``ctx`` tokens) on one engine on the card, in
    ms: the prefill as the median wall of 3 one-token requests, the step
    as the wall after the last first token over the steps taken."""
    kw = dict(dtype=torch.bfloat16, num_blocks=1024, block_size=16,
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
    from repro_torch.core.types import H100_SPEC, ClusterSpec, ReplicaConfig
    from repro_torch.kernels import flash_attention as fa
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
    offset = fa.flash_attention.offset_launches
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
    cm = CostModel(cfg.profile(), hw=H100_SPEC)
    tp1 = ReplicaConfig(1)
    long_in = max(a.in_len for a in REAL_ARCHETYPES)
    ctx = REAL_ARCHETYPES[3].in_len + 16
    card_prefill, card_step = card_step_times(cfg, params, long_in, 8, ctx)
    log(f"  [orchestrated] cost model ({cfg.n_layers}-layer profile, TP=1, "
        f"H100_SPEC) against the card: prefill of {long_in} tokens "
        f"{cm.measure_prefill(tp1, long_in) * 1e3:.2f} ms predicted, "
        f"{card_prefill:.2f} ms measured (one request, wall); decode step at "
        f"B=8, ctx {ctx}: {cm.measure_decode_step(tp1, 8, ctx) * 1e3:.2f} "
        f"ms predicted (step_overhead {cm.step_overhead * 1e3:.1f} ms), "
        f"{card_step:.2f} ms measured; {card}")
    lens = sorted((len(p) for p in prompts), reverse=True)[:8]
    run = {"arch": ORCH_MODEL, "variant": ORCH_VARIANT, "cfg": cfg,
           "counts": counts, "n_req": len(prompts), "lens": lens}
    del params
    torch.cuda.empty_cache()
    log(f"  [orchestrated] the job took {time.monotonic() - t_start:.1f} s")
    return run, failed


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
        f"{cfg.ssm_state}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{n:,} params, {n * 2 / 1e9:.2f} GB bf16 "
        f"(init {time.monotonic() - t0:.1f} s)")
    prompts = full_width_prompts(cfg)
    lens = [len(p) for p in prompts]
    runs = []
    for var in variants:
        kw = dict(FULL_WIDTH_ENGINE, **var.options)
        # warm-up: cuBLAS handles, allocator, kernel modules
        serve(cfg, params, [np.arange(64, dtype=np.int32)], 4, "cuda", **kw)
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
            f"tokens each, max_seqs 8, pool 2048 x 16-token pages, "
            f"{var.options}")
        log(f"  [{var.name}] tokens_out {eng.tokens_out}  prefill_tokens "
            f"{eng.prefill_tokens}  steps {eng.steps}  decode_syncs "
            f"{eng.decode_syncs}  horizons {eng.horizon_counts}")
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
    for path in MIGRATE.get(arch, ()):
        failures += phase_migrate(ops, cfg, params, prompts, path,
                                  runs[0]["streams"])
        torch.cuda.empty_cache()
    if arch in PREFIX_MODELS:
        failures += phase_prefix(ops, cfg, params)
        failures += phase_evict(ops, cfg, params)
        torch.cuda.empty_cache()
    if arch in CLUSTER_MODELS:
        failures += phase_cluster(ops, cfg, params)
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return runs


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
    from repro_torch.kernels import flash_attention as fa
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
        offset = fa.flash_attention.offset_launches
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
    from repro_torch.kernels import flash_attention as fa
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
    offset = fa.flash_attention.offset_launches
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
                f"D={D} causal bf16", device_ms=device)


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
    from repro_torch.kernels import flash_decode as fd
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
        log(f"    flash_attention SASS: {n:5d} HMMA in {fn}")
    bf16 = {fn: n for fn, n in hmma.items() if "flash_attention_bf16" in fn}
    if len(bf16) != len(build.HEAD_DIMS) or not all(bf16.values()):
        raise SystemExit(f"the bf16 prefill kernels do not all run on the "
                         f"tensor cores: HMMA counts {bf16}")
    hmma = hmma_counts(build, "ssd_chunk")
    for fn, n in sorted(hmma.items()):
        log(f"    ssd_chunk SASS: {n:5d} HMMA in {fn}")
    # the instantiations for the served models' SSM head dim (P = 64),
    # one for each head block size
    served = {fn: n for fn, n in hmma.items()
              if "ssd_chunk_kernelILi64E" in fn}
    if not served or not all(served.values()):
        raise SystemExit(f"the SSD chunk kernel at P = 64 does not run on "
                         f"the tensor cores: HMMA counts {served}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    log("[3] kernels vs plain versions")
    check_paged(gen, fd, ref)
    check_paged_split(gen, fd, ref)
    check_dense(gen, fd, ref)
    check_split(gen, fd, ref)
    check_prefill(gen, fa, ref)
    check_chunk(gen, fa, ref)
    check_ssd(gen, ssd, ref)

    log("[4] greedy decoding")
    phase_greedy()
    phase_cluster_smoke()
    phase_orchestrated_smoke()

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

    log("[6] kernel timing (CUDA events: median of 20 groups of 10 calls, "
        "back to back and replayed from a CUDA graph)")
    timers = {"paged_decode": lambda run: time_paged(gen, fd, ref, run),
              "flash_decode": lambda run: time_dense(gen, fd, ref, run),
              "flash_attention": lambda run: time_prefill(gen, fa, ref, run),
              "flash_attention_chunk": lambda run: time_chunk(gen, fa, ref,
                                                              run),
              "ssd_chunk": lambda run: time_ssd(gen, ssd, ref, run)}
    rows = [timers[name](run) for run in runs
            for name in run["variant"].timed]
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {r['name']} ({r['model']}, {r['run']} run): kernel_ms "
            f"{r['ms']:.4f} (graph replay {r['device_ms']:.4f})  bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']})"
            f"  plain_ms {r['plain_ms']:.4f}  library_ms {lib}  launches "
            f"{r['launches']} ({r['launches_per_request']:.1f}/request)"
            + (f"  splits {r['splits']} ({r['ctas']} CTAs)"
               if "splits" in r else "") + f"  [{r['shape']}]")
    log(f"total {time.monotonic() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": rows}))
    if failures:
        for f in failures:
            print(f"chip_smoke: {f}", file=sys.stderr)
        log(f"chip_smoke: {len(failures)} migrate, prefix, evict, cluster "
            f"or orchestrated check(s) failed: {'; '.join(failures)}")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
