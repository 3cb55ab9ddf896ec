"""Where the device time of the phase-5 job goes, by model and engine mode.

    python3 tools/profile_modes.py [--eager] [--models yi-9b,hymba-1.5b]
                                   [--runs paged,chunked]

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Serves
``chip_smoke.py``'s phase-5 job (8 requests, prompts of 320-963 tokens,
32 new tokens each, random bf16 weights from seed 0) on each full-width
model of ``--models`` (default yi-9b; any of ``chip_smoke.FULL_WIDTH``)
in each engine mode that phase runs it in (``--runs`` keeps some: for
yi-9b paged decode, the dense decode mode, chunked prefill in 256-token
budgets) under ``torch.profiler`` with CUDA activity.  By default each
mode's engine runs its compiled steps (``serving.graphs``: CUDA graphs
for the one-shot prefill, the paged decode and the chunk forward; the
dense mode's decode stays eager): a cold pass captures every decode and
chunk key, a second pass of the same prompts every prefill key (captured
at its second call), a warm third is timed unprofiled, and a fourth,
profiled pass reads the steady state; the idle share is taken against the warm
unprofiled wall, where the profiler's host cost does not stretch it.
``--eager`` profiles eager engines (``graphs=False``) after a one-prompt
warm-up, as before the compiled step, against the profiled wall.  For
each run it prints the wall time, the mean TTFT, the device's busy time
(the sum of every kernel's and copy's device time) and idle share (1 -
busy / wall), the device time by group (the four hand-written kernels
and the decode kernels' split combine, cuBLAS matrix products, indexing
copies, the rest) and the ten kernels that took the most device time.
The last line is one JSON object with the card and every reading.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# device-time groups, by a substring of the kernel's name (first match);
# the split combine serves B1 and B3 alike: in the paged and chunked runs
# it is B1's, in the dense run B3's
GROUPS = (
    ("B1 paged_decode", ("paged_decode_kernel",)),
    ("B3 flash_decode", ("flash_decode_kernel",)),
    ("B1/B3 split combine", ("combine_splits_kernel",)),
    ("B2 flash_attention", ("flash_attention_bf16", "flash_attention_f32")),
    ("B4 ssd_chunk", ("ssd_",)),
    ("matmul (cuBLAS)", ("gemm", "gemv", "nvjet", "xmma", "cutlass")),
    ("indexing and copies", ("index", "gather", "scatter", "Memcpy",
                             "Memset", "copy", "cat")),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def device_times(prof) -> dict[str, float]:
    """{kernel or copy name: device time in ms} of a profiled run."""
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            out[e.key] = out.get(e.key, 0.0) + t / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--models", default="yi-9b")
    ap.add_argument("--runs", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_modes: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    build.build_all()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    eager = args.eager
    readings = []
    full_width = dict(cs.FULL_WIDTH)
    for arch in args.models.split(","):
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
        prompts = cs.full_width_prompts(cfg)
        for var in full_width[arch]:
            if args.runs is None or var.name in args.runs.split(","):
                readings.append(profile_run(cs, cfg, params, prompts, var,
                                            eager, acts))
        del params
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "readings": readings}))
    return 0


def profile_run(cs, cfg, params, prompts, var, eager: bool, acts) -> dict:
    """Serve the job on one model and engine mode, profile one pass and
    print it (see the module docstring); returns the reading."""
    arch = cfg.name
    kw = dict(cs.FULL_WIDTH_ENGINE, **var.options)
    unprofiled = cold = None
    if eager:
        cs.serve(cfg, params, prompts[:1], 4, "cuda", graphs=False,
                 **kw)                                   # warm-up
    else:
        _, eng, cold = cs.serve(cfg, params, prompts, 32, "cuda", **kw)
        for rid0 in (100, 200):
            eng._chunk_rr = 0   # the cold pass's schedule again
            _, unprofiled = cs.serve_on(eng, prompts, 32, rid0=rid0)
        eng._chunk_rr = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with torch.profiler.profile(activities=acts) as prof:
        if eager:
            fin, eng, _ = cs.serve(cfg, params, prompts, 32, "cuda",
                                   graphs=False, **kw)
        else:
            fin, _ = cs.serve_on(eng, prompts, 32, rid0=300)
    wall = time.monotonic() - t0
    times = device_times(prof)
    busy = sum(times.values())
    base = wall if unprofiled is None else unprofiled
    by_group: dict[str, float] = {}
    for name, t in times.items():
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + t
    top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
    ttft = [fin[r].t_first - fin[r].t_submit for r in fin]
    mode = "eager" if eager else "graphed, warm"
    walls = (f"wall {wall:.3f} s (profiled)" if eager else
             f"cold wall {cold:.3f} s, warm wall {unprofiled:.3f} s "
             f"(unprofiled), {wall:.3f} s (profiled)")
    print(f"{arch} {var.name} ({mode}): {walls}, TTFT mean "
          f"{1e3 * np.mean(ttft):.1f} ms, steps {eng.steps}, graph "
          f"captures {eng.graph_captures}, replays {eng.graph_replays}; "
          f"device busy {busy:.1f} ms, idle share "
          f"{1 - busy / (1e3 * base):.3f}", flush=True)
    if busy == 0:
        print("  the profiler saw no device time: time with CUDA events "
              "instead", flush=True)
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:22s} {t:10.1f} ms  {t / max(busy, 1e-9):6.1%}")
    for name, t in top:
        print(f"    {t:10.1f} ms  {name[:100]}")
    return {"arch": arch, "run": var.name, "mode": mode,
            "wall_s": wall, "warm_wall_s": unprofiled,
            "cold_wall_s": cold,
            "ttft_mean_ms": 1e3 * float(np.mean(ttft)),
            "steps": eng.steps, "device_busy_ms": busy,
            "idle_share": 1 - busy / (1e3 * base),
            "by_group_ms": by_group, "top_kernels_ms": dict(top)}


if __name__ == "__main__":
    sys.exit(main())
