"""How far bf16 rounding alone moves a sharded replica from the unsharded
model, next to how far it moves the unsharded model from fp32.

    python3 tools/shard_precision.py [--archs mamba2-370m hymba-1.5b]
        [--seeds 2] [--agreement mamba2-370m] [--agreement-seeds 5]

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Two
readings, each at full width on random weights from each seed:

  distance   for each of ``--archs``: the logits of ``chip_smoke.py``'s
             phase-5 prompt 0 from the unsharded bf16 forward, the sharded
             forward at (tp 2, pp 1) and (tp 1, pp 2) in bf16, and the
             sharded forward in fp32, each against an fp32 forward of the
             same weights (the bf16 weights widened): the mean relative
             difference and the share of positions whose argmax equals
             the fp32 forward's;
  agreement  for each of ``--agreement``: phase 5's paged job (8
             requests, 32 new tokens) served unsharded in bf16, at tp 2
             in bf16 and at tp 2 in fp32, each scored as ``chip_smoke.py``
             scores it (the share of generated tokens equal to a
             teacher-forced forward's argmax, the forward in the run's
             own dtype), and the share of its tokens equal to the
             unsharded bf16 run's.

A sharded path that is right in fp32 and whose bf16 logits stand as far
from fp32 as the unsharded model's adds rounding, not error; its bf16
agreement with the unsharded bf16 forward is then two roundings apart.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def widened(tree):
    return ({k: widened(v) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.float())


def replica(cfg, tp: int, pp: int):
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.launch.sharding import make_plan
    plan, run_cfg = make_plan(cfg, "serve", False, 1, tp=tp, pp=pp)
    dev = torch.device("cuda", torch.cuda.current_device())
    return plan, run_cfg, make_replica_mesh([dev] * (tp * pp), tp, pp)


def distance(arch: str, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params, sharded
    cfg = get_config(arch)
    tok = torch.from_numpy(
        cs.full_width_prompts(cfg)[0][None].astype(np.int64)).cuda()
    p16 = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    p32 = widened(p16)
    truth = forward(p32, cfg, tok)
    top = truth.argmax(-1)
    out = {}

    def score(name, logits):
        rel = float((logits - truth).abs().mean() / truth.abs().mean())
        same = float((logits.argmax(-1) == top).float().mean())
        out[name] = (rel, same)
        cs.log(f"  [distance {arch} seed {seed}] {name}: mean relative "
               f"difference to fp32 {rel:.4e}, argmax equal {same:.4f}")

    score("unsharded bf16", forward(p16, cfg, tok))
    for tp, pp, params, dt in ((2, 1, p16, "bf16"), (1, 2, p16, "bf16"),
                               (2, 1, p32, "fp32")):
        plan, run_cfg, mesh = replica(cfg, tp, pp)
        sm = sharded.ShardedModel.build(params, run_cfg, plan, mesh)
        score(f"tp {tp} pp {pp} {dt}", sharded.forward(sm, run_cfg, tok))
        del sm
    del p16, p32
    torch.cuda.empty_cache()
    return out


def agreement(arch: str, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config(arch)
    prompts = cs.full_width_prompts(cfg)
    p16 = init_params(cfg, seed=seed, dtype=torch.bfloat16, device="cuda")
    out, base = {}, None
    for name, tp, dt in (("unsharded bf16", 1, torch.bfloat16),
                         ("tp 2 bf16", 2, torch.bfloat16),
                         ("tp 2 fp32", 2, torch.float32)):
        params = p16 if dt == torch.bfloat16 else widened(p16)
        kw = dict(cs.FULL_WIDTH_ENGINE, **cs.PAGED, dtype=dt)
        run_cfg = cfg
        if tp > 1:
            plan, run_cfg, mesh = replica(cfg, tp, 1)
            kw.update(mesh=mesh, shard_plan=plan)
        t0 = time.monotonic()
        fin, _, _ = cs.serve(run_cfg, params, prompts, 32, "cuda", **kw)
        streams = {r: fin[r].generated for r in sorted(fin)}
        per_req = [cs.teacher_forced_agreement(cfg, params, prompts[r],
                                               streams[r]) for r in streams]
        base = base or streams
        same = float(np.mean([a == b for r in streams
                              for a, b in zip(streams[r], base[r])]))
        out[name] = (float(np.mean(per_req)), min(per_req), same)
        cs.log(f"  [agreement {arch} seed {seed}] {name}: teacher-forced "
               f"{out[name][0]:.4f} (min {out[name][1]:.4f}), tokens equal "
               f"to the unsharded bf16 run's {same:.4f} "
               f"({time.monotonic() - t0:.1f} s)")
        del fin, params
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="*",
                    default=["mamba2-370m", "hymba-1.5b", "olmoe-1b-7b"])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--agreement", nargs="*", default=["mamba2-370m"])
    ap.add_argument("--agreement-seeds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("shard_precision: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    cs.log(f"[shard_precision] {card}")
    result = {"card": card, "distance": {}, "agreement": {}}
    for arch in args.archs:
        result["distance"][arch] = [distance(arch, s)
                                    for s in range(args.seeds)]
    for arch in args.agreement:
        result["agreement"][arch] = [agreement(arch, s)
                                     for s in range(args.agreement_seeds)]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
