"""What bounds the paged decode kernel (B1) and the SSD chunk kernel (B4),
and how far B4's roundings move phase 5's bf16 agreement.

    python3 tools/b1_b4_variants.py

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Three parts,
all at ``chip_smoke.py``'s phase-5 and phase-6 shapes:

1. Variants.  Each variant is a copy of ``src/repro_torch/kernels/csrc``
   with one edit (``VARIANTS`` below), built by ``nvcc`` as the kernels
   are and loaded in place of the kernel's library.  Most cut a part out
   of the kernel, so their outputs are wrong and only their device time
   is read: the profiler's time by kernel over 20 calls, B1 at yi-9b's
   and hymba's decode shape (8 sequences, a 64-page table; at the split
   count the wrapper picks and at 16), B4 at mamba2's and hymba's prefill
   shape (four chunks of 256).  The rest change how B4 rounds or stages
   and leave its function as it is.
2. B4's error on the inputs a served model hands it: the inputs of the
   first 64 ``ssd_chunk`` calls of phase 5's hymba and mamba2 jobs,
   through the kernel, its rounding variants and the plain version in
   fp32, each against the plain version in float64 (largest row-relative
   error and RMS error, of y and of S).
3. Phase 5's teacher-forced agreement (which ``chip_smoke.py`` gates at
   0.9) of the hymba and mamba2 jobs with B4 and its rounding variants,
   and of the hymba job with B1 and B4 each swapped for its plain version
   (and B1 at one split).

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

# variant: (source, [(text, replacement), ...]); every text must occur
VARIANTS = {
    "paged_decode": {
        "kernel": [],
        "no pages": [("split_tiles(start, limit, page, split, n_split, "
                      "j_begin, j_end);",
                      "split_tiles(start, limit, page, split, n_split, "
                      "j_begin, j_end);\n  j_end = j_begin;")],
        "no score dot": [("              dot += kx[e] * qv.x + kx[e + 1] * "
                          "qv.y + kx[e + 2] * qv.z +\n                     "
                          "kx[e + 3] * qv.w;", "              dot += qv.x;")],
        "no P V": [("        for (int e = 0; e < VEC; ++e) o[e] += p * "
                    "vx[e];", "        for (int e = 0; e < VEC; ++e) "
                    "o[e] += p;")],
    },
    "ssd_chunk": {
        "kernel": [],
        "1xTF32": [("  mma_tf32(d, a.lo, h0, h1);\n  mma_tf32(d, a.hi, l0, "
                    "l1);\n", "")],
        "no exp": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                    '"f"(x * kLog2e));', "y = x;")],
        "no staging": [("    if (next < n) stage(next, next % kSlots);\n",
                        ""), ("    if (i < n) stage(i, i);\n", "")],
        "no mma": [("        mma_3xtf32(part[j], a, xp[j * 8], "
                    "xp[4 * LDX + j * 8]);", "        ;"),
                   ("        mma_3xtf32(part[j], a, bb[0], bb[4]);", ""),
                   ("          mma_3xtf32(part[i][j], a[i], bp[0], "
                    "bp[4 * kLdS]);", "          ;")],
        "3 slots": [("constexpr int kSlots = 2;", "constexpr int kSlots = 3;")],
        "4 slots": [("constexpr int kSlots = 2;", "constexpr int kSlots = 4;")],
        "1 head a CTA": [("  if (heads_per_cta(sh.N, P) == 1)",
                          "  if (true)")],
        "2 heads a CTA": [("  if (heads_per_cta(sh.N, P) == 1)",
                           "  if (false)")],
        # rounding variants (the function is unchanged)
        "chained": [("mma_3xtf32(part[j], a, xp[j * 8]",
                     "mma_3xtf32(yacc[j], a, xp[j * 8]"),
                    ("mma_3xtf32(part[j], a, bb[0], bb[4])",
                     "mma_3xtf32(cb[j], a, bb[0], bb[4])"),
                    ("mma_3xtf32(part[i][j], a[i], bp[0]",
                     "mma_3xtf32(acc[i][j], a[i], bp[0]")],
        "expf": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                  '"f"(x * kLog2e));', "y = expf(x);")],
    },
}
ROUNDINGS = ("kernel", "chained", "expf")


def build_variants(build) -> dict:
    """{(source, variant): path of its built library}, all built at once."""
    tmp = tempfile.mkdtemp(prefix="variants-", dir=build.BUILD_ROOT)
    procs = []
    for src, variants in VARIANTS.items():
        for name, edits in variants.items():
            d = os.path.join(tmp, f"{src}-{len(procs)}")
            shutil.copytree(build.CSRC, d)
            left = list(edits)
            for fname in (f"{src}.cu", "decode_group.cuh"):
                path = os.path.join(d, fname)
                text = open(path).read()
                for a, b in list(left):
                    if a in text:
                        text = text.replace(a, b)
                        left.remove((a, b))
                open(path, "w").write(text)
            if left:
                raise SystemExit(f"variant {src} {name!r}: text not found: "
                                 f"{left[0][0]!r}")
            so = os.path.join(d, f"{src}.so")
            cmd = [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-o", so,
                   os.path.join(d, f"{src}.cu")]
            procs.append((src, name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    libs = {}
    for src, name, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {src} {name!r} failed to build:\n"
                             f"{out.decode()[-3000:]}")
        libs[src, name] = so
    return libs


def device_ms(fn, n: int = 20) -> dict[str, float]:
    """{kernel: profiler device time per call in ms} over n calls."""
    fn(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            fn(i % 10)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            key = ("combine" if "combine_splits" in e.key
                   else "kernel")
            out[key] = out.get(key, 0.0) + t / 1e3 / n
    return out


def row_errors(got, want):
    """(largest row-relative error, RMS error) of got against want."""
    d = (got.double() - want).abs()
    row_max = want.abs().amax(-1).clamp_min(1e-30)
    rms = (d.pow(2).sum() / want.pow(2).sum()).sqrt().item()
    return (d.amax(-1) / row_max).max().item(), rms


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_b4_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import init_params

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all()
    libs = {k: ctypes.CDLL(so) for k, so in build_variants(build).items()}
    readings = []

    def use(src, name):
        build._loaded[src] = libs[src, name]

    # 1. device time of each variant
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for arch in ("yi-9b", "hymba-1.5b"):
        cfg = get_config(arch)
        lens = [len(p) + 16 for p in cs.full_width_prompts(cfg)]
        B, Hq, Hkv, D, page, n_pages = (8, cfg.n_q_heads, cfg.n_kv_heads,
                                        cfg.head_dim, 16, 64)
        q, kp, vp, _, ln, st = cs.paged_inputs(
            gen, B, Hq, Hkv, D, page, lens, torch.bfloat16,
            n_pages=n_pages, n_pool=10 * B * n_pages + 1)
        perm = torch.randperm(kp.shape[0] - 1, generator=gen, device="cuda")
        tables = perm.to(torch.int32).reshape(10, B, n_pages)
        scale = 1.0 / D ** 0.5
        auto = fd.split_count(B, Hkv, n_pages * page, page,
                              fd.sm_count(q.device))
        for name in VARIANTS["paged_decode"]:
            use("paged_decode", name)
            for n in (auto, 16):
                t = device_ms(lambda i: fd._launch_paged(
                    q, kp, vp, tables[i], ln, st, 0.0, scale, n))
                print(f"B1 {arch} {name}, {n} splits: {t}", flush=True)
                readings.append({"kernel": "paged_decode", "arch": arch,
                                 "variant": name, "splits": n, "ms": t})
        use("paged_decode", "kernel")
    ssd_shapes = {}
    for arch in ("mamba2-370m", "hymba-1.5b"):
        cfg = get_config(arch)
        L = max(len(p) for p in cs.full_width_prompts(cfg))
        Q = min(cfg.ssm_chunk, L)
        ssd_shapes[arch] = cs.ssd_inputs(
            gen, 1, -(-L // Q), Q, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_groups)
        for name in VARIANTS["ssd_chunk"]:
            use("ssd_chunk", name)
            t = device_ms(lambda i: ssd.ssd_chunk(*ssd_shapes[arch]))
            print(f"B4 {arch} {name}: {t}", flush=True)
            readings.append({"kernel": "ssd_chunk", "arch": arch,
                             "variant": name, "ms": t})
    use("ssd_chunk", "kernel")

    # 2. and 3. on the served models
    b1, b4 = ops.paged_decode, ops.ssd_chunk

    def b1_plain(q, kp, vp, tb, ln, st, *, softcap=0.0):
        return ref.paged_decode_plain(q, kp, vp, tb, ln, st, softcap,
                                      1.0 / q.shape[-1] ** 0.5)

    def b1_one_split(q, kp, vp, tb, ln, st, *, softcap=0.0):
        return fd._launch_paged(q, kp, vp, tb, ln, st, softcap,
                                1.0 / q.shape[-1] ** 0.5, 1)

    def agreement(cfg, params, prompts, kw):
        fin, _, _ = cs.serve(cfg, params, prompts, 32, "cuda", **kw)
        per = [cs.teacher_forced_agreement(cfg, params, prompts[r],
                                           fin[r].generated)
               for r in sorted(fin)]
        return sum(per) / len(per)

    for arch in ("hymba-1.5b", "mamba2-370m"):
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
        prompts = cs.full_width_prompts(cfg)
        kw = dict(cs.FULL_WIDTH_ENGINE, **cs.PAGED)
        cs.serve(cfg, params, prompts[:1], 4, "cuda", **kw)   # warm-up
        captured = []

        def capture(*args):
            if len(captured) < 64:
                captured.append([t.clone() for t in args])
            return b4(*args)
        ops.ssd_chunk = capture
        try:
            cs.serve(cfg, params, prompts, 32, "cuda", **kw)
        finally:
            ops.ssd_chunk = b4
        worst: dict[str, list] = {}
        for args in captured:
            y64, S64 = ref.ssd_chunk_plain(*(t.double() for t in args))
            outs = {"plain fp32": ref.ssd_chunk_plain(*args)}
            for name in ROUNDINGS:
                use("ssd_chunk", name)
                outs[name] = ssd.ssd_chunk(*args)
            for name, (y, S) in outs.items():
                e = row_errors(y, y64) + row_errors(S, S64)
                w = worst.setdefault(name, [0.0] * 4)
                worst[name] = [max(a, b) for a, b in zip(w, e)]
        for name, w in worst.items():
            print(f"B4 {arch} {name} vs float64 on {len(captured)} served "
                  f"calls: y max_row_rel {w[0]:.3e} rms {w[1]:.3e}; S "
                  f"max_row_rel {w[2]:.3e} rms {w[3]:.3e}", flush=True)
            readings.append({"arch": arch, "b4": name, "served_calls":
                             len(captured), "y_max_row_rel": w[0],
                             "y_rms": w[1], "S_max_row_rel": w[2],
                             "S_rms": w[3]})
        for name in ROUNDINGS:
            use("ssd_chunk", name)
            a = agreement(cfg, params, prompts, kw)
            print(f"{arch} agreement, B4 {name}: {a:.4f}", flush=True)
            readings.append({"arch": arch, "b4": name, "agreement": a})
        use("ssd_chunk", "kernel")
        if arch == "hymba-1.5b":
            for n1, f1 in (("kernel", b1), ("one split", b1_one_split),
                           ("plain", b1_plain)):
                for n4, f4 in (("kernel", b4), ("plain",
                                                ref.ssd_chunk_plain)):
                    ops.paged_decode, ops.ssd_chunk = f1, f4
                    try:
                        a = agreement(cfg, params, prompts, kw)
                    finally:
                        ops.paged_decode, ops.ssd_chunk = b1, b4
                    print(f"{arch} agreement, B1 {n1}, B4 {n4}: {a:.4f}",
                          flush=True)
                    readings.append({"arch": arch, "b1": n1, "b4": n4,
                                     "agreement": a})
        del params, captured
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
