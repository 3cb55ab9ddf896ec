"""How phase 5's "train" runs (b), (d) and (e) behave at other learning
rates and in fp32 compute.

    python3 tools/train_lr_sweep.py [--job b] [--runs 3e-5:fp32,1e-5:bf16]
    python3 tools/train_lr_sweep.py --job d --runs 1e-4:bf16,3e-4:bf16

Needs one CUDA card and ``nvcc``, as ``chip_smoke.py`` does.  Trains the
job's model as ``chip_smoke.py`` does (``--job b``: TRAIN_B, yi-9b at its
published widths cut to 8 of 48 layers; ``d``: TRAIN_D, mamba2-370m at all
48 layers; ``e``: TRAIN_E, hymba-1.5b at all 32 layers; seq 2048, batch 2,
2 microbatches, remat, the same seeded batches and seed-0 weights) for the
job's steps once per run, each at a constant learning rate (one warmup
step) and a compute dtype, and prints every step's nll and gradient norm.
A loss that jumps in fp32 as in bf16 comes from the optimizer's step size
at this width, not from bf16 rounding or the backward kernels'; the fp32
kernels are held to 1e-5 against the CPU (``chip_smoke.py`` phases 3 and
4).  The last line is one JSON object with the card and every run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--job", default="b", choices=("b", "d", "e"))
    ap.add_argument("--runs", default="3e-5:fp32,1e-5:bf16,3e-6:bf16",
                    help="comma-separated lr:dtype pairs (dtype fp32|bf16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_lr_sweep: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    if args.job == "b":
        job = cs.TRAIN_B
        cfg = dataclasses.replace(get_config("yi-9b"),
                                  n_layers=job["layers"])
    else:
        job = cs.TRAIN_D if args.job == "d" else cs.TRAIN_E
        cfg = get_config(job["arch"])
    batches = cs.train_batches(cfg, job["batch"], job["seq"], job["steps"])
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    out = []
    for run in args.runs.split(","):
        lr, dtype = run.split(":")
        tcfg = TrainConfig(
            opt=AdamWConfig(lr=float(lr), warmup_steps=1, total_steps=1000),
            remat=True, microbatches=job["microbatches"],
            compute_dtype=dtypes[dtype])
        t0 = time.monotonic()
        tr = Trainer(cfg, tcfg, iter(batches), device="cuda")
        hist = tr.run(job["steps"], log_every=1)
        nll = [h["nll"] for h in hist]
        gnorm = [h["grad_norm"] for h in hist]
        print(f"{cfg.name} lr {lr} {dtype}: nll "
              f"{[round(x, 4) for x in nll]}; grad norm "
              f"{[round(x, 2) for x in gnorm]} "
              f"({time.monotonic() - t0:.1f} s); {card}", flush=True)
        out.append({"lr": float(lr), "dtype": dtype, "nll": nll,
                    "grad_norm": gnorm})
        del tr
        torch.cuda.empty_cache()
    print(card)
    print(json.dumps({"card": card, "job": args.job, "runs": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
