"""Where the SSD chunk kernel's backward (B4 bwd) spends its time.

    python3 tools/b4_bwd_variants.py

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Each variant
is a copy of ``src/repro_torch/kernels/csrc`` with one edit (``VARIANTS``
below), built by ``nvcc`` as the kernels are and loaded in place of the
backward's library.  Some cut work out of the kernel, so their outputs are
wrong and only their device time is read; the rest change how it splits
or groups the work and keep its function, and those are held against the
plain version in float64 as ``chip_smoke.py`` holds the kernel.  Timing:
``chip_smoke.py``'s CUDA-graph replay (median of 20 replays of 10 calls)
and the profiler's device time by launch over 10 calls, at phase 5's
train shapes (B 1, L 2048: 8 chunks of 256): mamba2-370m (32 heads of
64, state 128) and hymba-1.5b (25 heads of 64, state 16).  The variants
run in the order given and then the kernel again, so drift shows.

The last line is one JSON object with the card and every reading.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

BWD = "ssd_chunk_bwd.cu"
MMA = "tf32_mma.cuh"
# variant: ([(file, text, replacement), ...], keeps the function); every
# text must occur in its file
VARIANTS = {
    "kernel": ([], True),
    # one TF32 pass (hi.hi): what the two cross terms and lo's split cost
    "1xTF32": ([(MMA, """  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);""", """  mma_tf32(d, a.hi, h0, h1);""")], False),
    # hi by masking the low 13 bits, lo = a - hi unrounded: what cvt.rna
    # costs beside two integer and float operations
    "truncating split": ([(MMA, """  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(a));
  asm("cvt.rna.tf32.f32 %0, %1;\\n"
      : "=r"(lo)
      : "f"(a - __uint_as_float(hi)));""", """  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));""")], False),
    # no L, W, dCB, R and their sums (W and dCB zero)
    "no elementwise": ([(BWD, "        if (t < Q && s <= t) {\n"
                              "          const float L",
                         "        if (t < 0) {\n          const float L")],
                       False),
    # half the heads a block where N > 32 (C.B^T shared by fewer heads)
    "HB halved": ([(BWD, "  return launch_all<P, HB, false>(a, sh, s);",
                    "  return launch_all<P, HB / 2, false>(a, sh, s);")],
                  True),
    # N <= 32 down the N > 32 path: full head blocks, one CTA an SM, the
    # state's terms in a launch of their own
    "no small-N path": ([(BWD, "  if (sh.N <= kKC) return launch_all<P, HB / "
                               "2, true>(a, sh, s);\n", "")], True),
    # the small-N tile kernel at one CTA an SM (no register cap, no spill)
    "small-N at 1 CTA/SM": ([(BWD, "__launch_bounds__(kThreads, SMALL ? 2 : "
                                   "1)", "__launch_bounds__(kThreads, 1)")],
                            True),
}
SHAPES = {"mamba2-370m": (1, 8, 256, 32, 64, 128, 1),
          "hymba-1.5b": (1, 8, 256, 25, 64, 16, 1)}


def build_variants(build) -> dict[str, str]:
    """{variant: path of its library}, every nvcc started at once."""
    out = os.path.join(ROOT, "build", "b4_bwd_variants")
    os.makedirs(out, exist_ok=True)
    procs = []
    for i, (name, (edits, _)) in enumerate(VARIANTS.items()):
        src = tempfile.mkdtemp(prefix=f"v{i}_", dir=out)
        for f in os.listdir(build.CSRC):
            shutil.copy(os.path.join(build.CSRC, f), src)
        for f, text, new in edits:
            path = os.path.join(src, f)
            code = open(path).read()
            if text not in code:
                raise SystemExit(f"variant {name!r}: text not found in {f}")
            open(path, "w").write(code.replace(text, new))
        lib = os.path.join(src, "ssd_chunk_bwd.so")
        procs.append((name, lib, subprocess.Popen(
            [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-o", lib,
             os.path.join(src, BWD)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name!r} failed to build:\n{text}")
        libs[name] = lib
    return libs


def by_launch(ssb, args) -> dict[str, float]:
    """{kernel name: device ms a call} from the profiler over 10 calls."""
    from torch.profiler import ProfilerActivity, profile
    ssb.ssd_chunk_bwd(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ssb.ssd_chunk_bwd(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "ssd_bwd_" in e.key:
            name = e.key.split("ssd_bwd_")[1].split("_kernel")[0]
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            out[name] = t / 10 / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("b4_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_chunk_bwd as ssb

    card = cs.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {name: ctypes.CDLL(path)
            for name, path in build_variants(build).items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    order = list(VARIANTS) + ["kernel"]
    for shape_name, (B, Nc, Q, H, P, N, G) in SHAPES.items():
        inputs = cs.ssd_inputs(gen, B, Nc, Q, H, P, N, G)
        dy = cs.rand(gen, B, Nc, Q, H, P, scale=1.0)
        dS = cs.rand(gen, B, Nc, H, P, N, scale=1.0)
        args = (*inputs, dy, dS)
        want = cs.ssd_bwd_plain(ref, inputs, dy, dS)
        for name in order:
            build._loaded["ssd_chunk_bwd"] = libs[name]
            got = ssb.ssd_chunk_bwd(*args)
            _, rel, ok = cs.ssd_bwd_agreement(got, want)
            replay = cs.graph_ms(lambda i: ssb.ssd_chunk_bwd(*args))
            launches = by_launch(ssb, args)
            keeps = VARIANTS[name][1]
            row = {"shape": shape_name, "variant": name, "replay_ms": replay,
                   "by_launch_ms": launches,
                   "max_rel_err": rel if keeps else None,
                   "within_1e-4": ok if keeps else None}
            rows.append(row)
            print(f"{shape_name:12s} {name:22s} replay {replay:.4f} ms  "
                  + "  ".join(f"{k} {v:.4f}" for k, v in launches.items())
                  + (f"  max_rel_err {rel:.2e} {'ok' if ok else 'FAIL'}"
                     if keeps else "  (function changed)"), flush=True)
    print(card)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
