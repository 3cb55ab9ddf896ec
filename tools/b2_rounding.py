"""Whether the bf16 teacher-forced agreement of the phase-5 jobs moves with
the prefill kernel (B2) or with the rounding of its softmax weights P.

    python3 tools/b2_rounding.py

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Serves
``chip_smoke.py``'s phase-5 job (8 requests, prompts of 128-1024 tokens,
32 new tokens each, random bf16 weights from seed 0) for full-width
yi-9b (paged and chunked runs) and hymba-1.5b (paged) with B2's route in
``kernels.ops`` swapped for each variant, in the order kernel, plain,
plain-bf16p, plain-bf16p, plain, kernel, so that a drift of the machine
over the call shows as a difference between the two runs of one variant.
The swap holds for the serving run and for the teacher-forced forward it
is compared with.  For each run it prints the share of generated tokens
that equal the teacher-forced forward's argmax (the mean over the 8
requests, which ``chip_smoke.py`` gates at 0.9, and each request's own),
the wall time and the B2 launches.  Before those runs, one more serving
run of each job measures B2 on the very inputs the model hands it: the
kernel's output, and the plain version's with only its output rounded to
bf16 and with P rounded too, each against the plain version in fp32
(largest row-relative error, RMS error, and scale bias, which a
systematic fault such as a wrong normaliser would move).

Variants:

  kernel       the port's B2 (``csrc/flash_attention.cu``): on the tensor
               cores in bf16, P rounded to bf16 before P V;
  plain        ``ref.flash_attention_ref``: fp32 scores, softmax and
               P V, P never rounded (as the Pallas kernel and the port's
               B2 before its tensor-core body keep it);
  plain-bf16p  the same with the normalised P rounded to bf16 before P V,
               as the JAX package's ``full_attention`` rounds it.

If the kernel's error on the served inputs is of the size of
plain-bf16p's, with no scale bias beyond it, the kernel adds nothing to
the rounding of P, and the agreement of the three variants shows how far
roundings alone move it.  The last line is one JSON object with the card
and every reading.

    python3 tools/b2_rounding.py --seeds 8

One run's agreement is one draw: it moves 0.01-0.03 with any rounding.
With ``--seeds N`` the tool asks instead whether P's rounding moves it
systematically.  For the weight seeds 0 .. N - 1 of hymba-1.5b (and
0 .. N/2 - 1 of yi-9b) it serves the phase-5 job uninterrupted (paged,
horizon 8) and migrated by re-prefill after ``chip_smoke.py``'s
MIGRATE_AFTER tokens (its migrate run), once with each of kernel and
plain, and prints each run's agreement, each variant's mean and least
over the seeds, and the mean of the paired differences with its
standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def attend(q, k, v, p_dtype, *, causal=True, softcap=0.0, window=0,
           q_offset=0):
    """``ref.flash_attention_ref`` in fp32 with P rounded to ``p_dtype``
    before P V; returns fp32."""
    from repro_torch.kernels.ref import NEG_INF, _expand
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    k, v = _expand(k, Hq), _expand(v, Hq)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (D ** 0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(p_dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


def plain_bf16p(q, k, v, **kw):
    """``ref.flash_attention_ref`` with P rounded to bf16 before P V."""
    return attend(q, k, v, torch.bfloat16, **kw).to(q.dtype)


class ErrorProbe:
    """B2's route for one serving run: returns the kernel's output and,
    on the same inputs, measures it and two roundings of the plain version
    against the plain version in fp32 (P and output unrounded)."""

    NAMES = ("plain, output rounded", "plain-bf16p, output rounded",
             "kernel")

    def __init__(self, kernel):
        self.kernel = kernel
        self.calls = 0
        self.max_row_rel = dict.fromkeys(self.NAMES, 0.0)
        self.sq_err = dict.fromkeys(self.NAMES, 0.0)
        self.dot_err = dict.fromkeys(self.NAMES, 0.0)
        self.sq_ref = 0.0

    def __call__(self, q, k, v, **kw):
        out = self.kernel(q, k, v, **kw)
        want = attend(q, k, v, torch.float32, **kw)
        outs = (want.to(q.dtype), attend(q, k, v, torch.bfloat16,
                                         **kw).to(q.dtype), out)
        row_max = want.abs().amax(-1).clamp_min(1e-30)
        for name, got in zip(self.NAMES, outs):
            d = got.float() - want
            self.max_row_rel[name] = max(
                self.max_row_rel[name],
                (d.abs().amax(-1) / row_max).max().item())
            self.sq_err[name] += d.double().pow(2).sum().item()
            self.dot_err[name] += (d.double() * want).sum().item()
        self.sq_ref += want.double().pow(2).sum().item()
        self.calls += 1
        return out

    def summary(self):
        """Per rounding: the largest row-relative error over every call,
        the RMS error over the RMS output, and the scale bias
        sum(d * want) / sum(want^2) (a systematic over- or under-scaling
        of the output shows here)."""
        return {name: {"max_row_rel_err": self.max_row_rel[name],
                       "rms_rel_err": (self.sq_err[name]
                                       / self.sq_ref) ** 0.5,
                       "scale_bias": self.dot_err[name] / self.sq_ref}
                for name in self.NAMES}


def over_seeds(cs, variants: dict, n_seeds: int) -> list[dict]:
    """The ``--seeds`` readings: for each model and weight seed, the
    phase-5 job's agreement uninterrupted and re-prefilled, with B2's
    route swapped for kernel and for plain."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    kernel = ops.flash_attention
    kw = dict(cs.FULL_WIDTH_ENGINE, **cs.PAGED)
    names = ("kernel", "plain")
    readings = []
    for arch, seeds in (("hymba-1.5b", n_seeds), ("yi-9b", n_seeds // 2)):
        cfg = get_config(arch)
        prompts = cs.full_width_prompts(cfg)
        jobs = {r: (p, 32) for r, p in enumerate(prompts)}
        table = {}
        for seed in range(seeds):
            params = init_params(cfg, seed=seed, dtype=torch.bfloat16,
                                 device="cuda")
            for name in names:
                ops.flash_attention = variants[name]
                try:
                    fin, _, _ = cs.serve(cfg, params, prompts, 32, "cuda",
                                         **kw)
                    streams = {"uninterrupted":
                               {r: fin[r].generated for r in fin}}
                    src, dst = cs.migration_engines(cfg, params, "cuda",
                                                    "reprefill", **kw)
                    cs.serve_part_way(src, jobs, after=cs.MIGRATE_AFTER)
                    cs.move_inflight(src, dst, "reprefill")
                    streams["reprefill"] = {
                        r.rid: r.generated for r in dst.run_to_completion()}
                    del src, dst
                    for run, got in streams.items():
                        agree = float(np.mean([
                            cs.teacher_forced_agreement(
                                cfg, params, prompts[r], got[r])
                            for r in sorted(got)]))
                        table[run, name, seed] = agree
                        readings.append({"arch": arch, "seed": seed,
                                         "run": run, "b2": name,
                                         "agreement": agree})
                        print(f"{arch} seed {seed} {run} B2 {name}: "
                              f"agreement {agree:.4f}", flush=True)
                finally:
                    ops.flash_attention = kernel
            del params
            torch.cuda.empty_cache()
        for run in ("uninterrupted", "reprefill"):
            by = {name: np.array([table[run, name, s] for s in range(seeds)])
                  for name in names}
            diff = by["plain"] - by["kernel"]
            se = float(diff.std(ddof=1) / np.sqrt(seeds)) if seeds > 1 \
                else 0.0
            summary = {"arch": arch, "run": run, "seeds": seeds,
                       "plain_minus_kernel": float(diff.mean()),
                       "stderr": se}
            for name in names:
                summary[f"mean_{name}"] = float(by[name].mean())
                summary[f"min_{name}"] = float(by[name].min())
            readings.append(summary)
            print(f"{arch} {run} over {seeds} seeds: kernel mean "
                  f"{summary['mean_kernel']:.4f} (least "
                  f"{summary['min_kernel']:.4f}), plain mean "
                  f"{summary['mean_plain']:.4f} (least "
                  f"{summary['min_plain']:.4f}), plain - kernel "
                  f"{diff.mean():+.4f} +- {se:.4f}", flush=True)
    return readings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=0,
                    help="the agreement over this many weight seeds instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b2_rounding: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import init_params

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    build.build_all()
    kernel = ops.flash_attention         # the route to B2 on the card
    variants = {"kernel": kernel, "plain": ref.flash_attention_ref,
                "plain-bf16p": plain_bf16p}
    if args.seeds:
        print(json.dumps({"card": card,
                          "readings": over_seeds(cs, variants, args.seeds)}))
        return 0
    order = ("kernel", "plain", "plain-bf16p", "plain-bf16p", "plain",
             "kernel")
    jobs = (("yi-9b", ("paged", "chunked")), ("hymba-1.5b", ("paged",)))
    runs = {(arch, v.name): v.options for arch, vs in cs.FULL_WIDTH
            for v in vs}
    readings = []
    for arch, names in jobs:
        cfg = get_config(arch)
        params = init_params(cfg, seed=0, dtype=torch.bfloat16,
                             device="cuda")
        prompts = cs.full_width_prompts(cfg)
        for run in names:
            kw = dict(cs.FULL_WIDTH_ENGINE, **runs[arch, run])
            cs.serve(cfg, params, prompts[:1], 4, "cuda", **kw)  # warm-up
            probe = ErrorProbe(kernel)
            ops.flash_attention = probe
            try:
                cs.serve(cfg, params, prompts, 32, "cuda", **kw)
            finally:
                ops.flash_attention = kernel
            errors = probe.summary()
            for name, e in errors.items():
                print(f"{arch} {run} B2 error on the served inputs "
                      f"({probe.calls} calls), {name} vs plain fp32: "
                      f"max_row_rel_err {e['max_row_rel_err']:.3e}, "
                      f"rms_rel_err {e['rms_rel_err']:.3e}, scale_bias "
                      f"{e['scale_bias']:+.3e}", flush=True)
            readings.append({"arch": arch, "run": run, "calls": probe.calls,
                             "errors": errors})
            for name in order:
                ops.reset_launch_counts()
                ops.flash_attention = variants[name]
                try:
                    fin, _, wall = cs.serve(cfg, params, prompts, 32,
                                            "cuda", **kw)
                    per_req = [cs.teacher_forced_agreement(
                        cfg, params, prompts[r], fin[r].generated)
                        for r in sorted(fin)]
                finally:
                    ops.flash_attention = kernel
                launches = ops.launch_counts()["flash_attention"]
                mean = sum(per_req) / len(per_req)
                print(f"{arch} {run} B2 {name}: agreement {mean:.4f}, min "
                      f"{min(per_req):.4f}, per request "
                      f"{[round(a, 4) for a in per_req]}; wall {wall:.3f} "
                      f"s; B2 kernel launches {launches}", flush=True)
                readings.append({"arch": arch, "run": run, "b2": name,
                                 "agreement": mean, "per_request": per_req,
                                 "wall_s": wall,
                                 "kernel_launches": launches})
        del params
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
