"""B2's backward (``csrc/flash_attention_bwd.cu``) at the train shapes,
beside another tree's version of the same kernel.

    python3 tools/b2_bwd_compare.py [--parent DIR] [--variants] [--reps N]

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  ``--parent``
names the root of another checkout (say a ``git archive`` of the parent
commit under ``build/``): its ``flash_attention_bwd.cu`` is built by
``nvcc`` as the kernels are and loaded in place of this tree's library,
so both run in one process on one card.  At each shape (``SHAPES``: the
phase-5 train microbatches of yi-9b, hymba-1.5b and yi-100m, and
gemma2-2b's heads with its softcap and window), bf16, on the forward
kernel's out and lse and a random dO: each version against
``ref.flash_attention_bwd_plain`` (``chip_smoke.grad_agreement``), twice
bit-equal, its CUDA-graph replay (``chip_smoke.graph_ms``) and its
device time by launch (``chip_smoke.bwd_by_launch``); the library call
(``chip_smoke.library_attention_bwd``: SDPA's autograd, flex_attention's
under a softcap) and the bound (``chip_smoke.bwd_bound_ms``) as phase 6
takes them.  The versions run in the order
parent, change, change, parent, so drift shows.

With ``--variants`` each entry of ``VARIANTS`` (a copy of ``csrc/`` with
one edit, built and loaded the same way) runs after the change at the
yi-9b and hymba shapes.  Each cuts a part of the work out of the kernel,
so its outputs are wrong and only its time is read: what that part costs.

The last line is one JSON object with the card and every reading.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# name: B, S, Hq, Hkv, D, softcap, window
SHAPES = {
    "yi-9b": (1, 2048, 32, 4, 128, 0.0, 0),
    "hymba-1.5b": (1, 2048, 25, 5, 64, 0.0, 0),
    "yi-100m": (4, 256, 12, 4, 64, 0.0, 0),
    "gemma2-2b": (1, 2048, 8, 4, 256, 50.0, 4096),
}


BWD = "flash_attention_bwd.cu"
# variant: every (file, text, replacement) applied to every occurrence of
# the text in that file of csrc/; each text must occur
RS_OFF = [(BWD, "wgmma_rs_t<D>(", "if (s < 0) wgmma_rs_t<D>(")]
SS_OFF = [(BWD, "wgmma_ss<B", "if (s < 0) wgmma_ss<B")]
NO_ELEMENTWISE = [
    (BWD, "if (all_visible(q0, BQ, k0, kRows, Sq, Sk, causal, window))",
     "if (q0 < 0)"),
    (BWD, "if (all_visible(q0, kRows, k0, BK, Sq, Sk, causal, window))",
     "if (q0 < 0)"),
    (BWD, "      elementwise(std::true_type{});\n", "      ;\n")]
NO_LOADS = [(BWD, "if (s + 1 < n_steps) load_step(s + 1, stage ^ 1);",
             "if (s < 0) load_step(s + 1, stage ^ 1);")]
VARIANT_SHAPES = ("yi-9b", "hymba-1.5b")
VARIANTS = {
    # P and dS left as the raw scores: what the elementwise pass costs
    "no elementwise": NO_ELEMENTWISE,
    # no tile loaded after the first step: what the loads cost
    "no loads": NO_LOADS,
    # no dV, dK or dQ product: what the register-A products cost
    "no RS products": RS_OFF,
    # no S, dP product: what the shared-memory-A products cost
    "no SS products": SS_OFF,
    # the products alone: no loads after the first step, no elementwise
    "products only": NO_LOADS + NO_ELEMENTWISE,
}


def build_bwd(build, csrc: str, name: str, edits=()) -> subprocess.Popen:
    """Start nvcc on a copy of ``csrc`` with ``edits`` made to it; the
    library lands in build/b2_bwd_compare/<name>/."""
    out = os.path.join(ROOT, "build", "b2_bwd_compare",
                       name.replace(" ", "_"))
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for f, text, new in edits:
        path = os.path.join(out, f)
        code = open(path).read()
        if text not in code:
            raise SystemExit(f"variant {name!r}: text not found in {f}: "
                             f"{text!r}")
        open(path, "w").write(code.replace(text, new))
    proc = subprocess.Popen(
        [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-o",
         os.path.join(out, "lib.so"), os.path.join(out, BWD)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.lib = os.path.join(out, "lib.so")
    return proc


def built(name: str, proc: subprocess.Popen) -> ctypes.CDLL:
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"{name} failed to build:\n{text}")
    return ctypes.CDLL(proc.lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="root of the tree to compare against")
    ap.add_argument("--variants", action="store_true",
                    help="also time VARIANTS at the yi-9b and hymba shapes")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b2_bwd_compare: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    card = cs.card_line()
    print(card, flush=True)
    build.build_all()
    libs = {"change": build.load("flash_attention_bwd")}
    procs = {}
    if args.parent:
        procs["parent"] = build_bwd(build, os.path.join(
            args.parent, "src", "repro_torch", "kernels", "csrc"), "parent")
    if args.variants:
        for name, edits in VARIANTS.items():
            procs[name] = build_bwd(build, str(build.CSRC), name, edits)
    for name, proc in procs.items():
        libs[name] = built(name, proc)
    order = (["parent", "change", "change", "parent"] if args.parent
             else ["change", "change"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for shape, (B, S, Hq, Hkv, D, cap, win) in SHAPES.items():
        q = cs.rand(gen, B, S, Hq, D, dtype=torch.bfloat16)
        k = cs.rand(gen, B, S, Hkv, D, dtype=torch.bfloat16)
        v = cs.rand(gen, B, S, Hkv, D, dtype=torch.bfloat16)
        dout = cs.rand(gen, B, S, Hq, D, dtype=torch.bfloat16)
        out, lse = fa.flash_attention(q, k, v, softcap=cap, window=win,
                                      with_lse=True)
        kw = dict(softcap=cap, window=win)
        call = (q, k, v, out, dout, lse)
        want = ref.flash_attention_bwd_plain(*call, True, cap, win)
        library = cs.library_attention_bwd(q, k, v, dout, cap, win)
        lib = cs.time_ms(library)
        t_bytes, t_ops = cs.bwd_bound_ms(B, S, Hq, Hkv, D, win)
        bound = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        extra = (list(VARIANTS) if args.variants and shape in VARIANT_SHAPES
                 else [])
        for name in order + extra:
            build._loaded["flash_attention_bwd"] = libs[name]
            got = fab.flash_attention_bwd(*call, **kw)
            again = fab.flash_attention_bwd(*call, **kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            rel = max(cs.grad_agreement(g, w, torch.bfloat16)[1]
                      for g, w in zip(got, want))
            replay = cs.graph_ms(lambda i: fab.flash_attention_bwd(
                *call, **kw), reps=args.reps, inner=5)
            launches = cs.bwd_by_launch(fab, call, kw)
            row = {"shape": shape, "version": name, "replay_ms": replay,
                   "by_launch_ms": launches, "max_row_rel_err": rel,
                   "within": rel <= cs.ROW_RTOL_BF16,
                   "twice_bit_equal": same, "bound_ms": bound,
                   "bound_by": bound_by, "library_ms": lib}
            rows.append(row)
            print(f"{shape:11s} {name:7s} replay {replay:.4f} ms  "
                  + "  ".join(f"{k_} {t:.4f}" for k_, t in launches.items())
                  + f"  row_rel {rel:.2e} "
                  f"{'ok' if row['within'] else 'FAIL'}  twice "
                  f"{'equal' if same else 'DIFFER'}  bound {bound:.4f} "
                  f"({bound_by})  library {lib:.4f}", flush=True)
        build._loaded["flash_attention_bwd"] = libs["change"]
        del q, k, v, dout, out, lse, want
    print(card)
    print(json.dumps({"card": card, "rows": rows}))
    bad = [r for r in rows if r["version"] == "change"
           and not (r["within"] and r["twice_bit_equal"])]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
