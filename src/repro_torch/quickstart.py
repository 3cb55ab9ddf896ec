"""Quickstart: serve a small model with the continuous-batching engine (the
twin of the JAX package's ``examples/quickstart.py``, same flags and
lines, plus ``--device``).

  1. build a reduced yi-9b-family model,
  2. submit a handful of requests,
  3. watch the engine batch prefills/decodes over the paged KV cache.

    PYTHONPATH=src python -m repro_torch.quickstart [--arch yi-9b]
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu

The device defaults to the card, with no fallback.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_smoke_config
from repro_torch.models import init_params, param_count
from repro_torch.serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b", choices=ASSIGNED_ARCHS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    print(f"arch={args.arch} (reduced: {cfg.n_layers}L d={cfg.d_model})")
    params = init_params(cfg, 0, torch.float32, args.device)
    print(f"params: {param_count(params):,}")

    engine = ServingEngine(cfg, params, num_blocks=128, block_size=8,
                           max_seqs=4, device=args.device)
    rng = np.random.RandomState(0)
    for rid in range(args.requests):
        prompt = rng.randint(0, cfg.vocab_size, rng.randint(8, 24))
        engine.submit(rid, prompt.astype(np.int32), max_new_tokens=12)

    t0 = time.time()
    finished = engine.run_to_completion()
    dt = time.time() - t0
    for r in sorted(finished, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> {r.generated}")
    print(f"{engine.tokens_out} tokens in {dt:.1f}s "
          f"({engine.steps} engine steps, "
          f"{engine.tokens_out / dt:.1f} tok/s on {args.device})")
    return finished


if __name__ == "__main__":
    main()
