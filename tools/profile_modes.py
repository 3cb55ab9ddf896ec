"""Where the device time of the phase-5 yi-9b job goes, by engine mode.

    python3 tools/profile_modes.py

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Serves
``chip_smoke.py``'s phase-5 job (8 requests, prompts of 320-963 tokens,
32 new tokens each, random bf16 weights from seed 0) on full-width yi-9b
once in each engine mode of that phase (paged decode, the dense decode
mode, chunked prefill in 256-token budgets), each after an unprofiled
warm-up, under ``torch.profiler`` with CUDA activity.  For each run it
prints the wall time, the mean TTFT, the device's busy time (the sum of
every kernel's and copy's device time) and idle share (1 - busy / wall),
the device time by group (the four hand-written kernels and the decode
kernels' split combine, cuBLAS matrix products, indexing copies, the
rest) and the ten kernels that took the
most device time.  The last line is one JSON object with the card and
every reading.
"""
from __future__ import annotations

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
    (arch, variants), = [fw for fw in cs.FULL_WIDTH if fw[0] == "yi-9b"]
    cfg = get_config(arch)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    prompts = cs.full_width_prompts(cfg)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    readings = []
    for var in variants:
        kw = dict(cs.FULL_WIDTH_ENGINE, **var.options)
        cs.serve(cfg, params, prompts[:1], 4, "cuda", **kw)      # warm-up
        torch.cuda.synchronize()
        t0 = time.monotonic()
        with torch.profiler.profile(activities=acts) as prof:
            fin, eng, _ = cs.serve(cfg, params, prompts, 32, "cuda", **kw)
        wall = time.monotonic() - t0
        times = device_times(prof)
        busy = sum(times.values())
        by_group: dict[str, float] = {}
        for name, t in times.items():
            g = group_of(name)
            by_group[g] = by_group.get(g, 0.0) + t
        top = sorted(times.items(), key=lambda kv: -kv[1])[:10]
        ttft = [fin[r].t_first - fin[r].t_submit for r in fin]
        print(f"{arch} {var.name}: wall {wall:.3f} s (profiled), TTFT mean "
              f"{1e3 * np.mean(ttft):.1f} ms, steps {eng.steps}; device "
              f"busy {busy:.1f} ms, idle share "
              f"{1 - busy / (1e3 * wall):.3f}", flush=True)
        if busy == 0:
            print("  the profiler saw no device time: time with CUDA events "
                  "instead", flush=True)
        for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
            print(f"  {g:22s} {t:10.1f} ms  {t / max(busy, 1e-9):6.1%}")
        for name, t in top:
            print(f"    {t:10.1f} ms  {name[:100]}")
        readings.append({"arch": arch, "run": var.name, "wall_s": wall,
                         "ttft_mean_ms": 1e3 * float(np.mean(ttft)),
                         "steps": eng.steps, "device_busy_ms": busy,
                         "idle_share": 1 - busy / (1e3 * wall),
                         "by_group_ms": by_group,
                         "top_kernels_ms": dict(top)})
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
