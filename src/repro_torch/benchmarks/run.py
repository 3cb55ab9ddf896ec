"""Benchmark registry of the port's evaluation: one module per paper
table/figure, the twins of the top-level ``benchmarks`` package's.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only MOD] [--full] [--device cpu]

Prints ``name,us_per_call,derived`` CSV rows.  ``--full`` runs the slow
variants (all models/cluster sizes); default keeps CI-friendly settings.
``--device`` is where the modules with device work run (the LSTMs of
``bench_predictor``, ``bench_e2e``'s real-engine validation): the card
unless ``cpu`` is asked for.

  bench_e2e        Fig 9-12   end-to-end latency/throughput vs baselines
  bench_switching  Fig 13     ad hoc switching vs naive reload
  bench_predictor  Fig 6/S5.3 per-type LSTM vs MA vs aggregate
  bench_scheduler  Fig 15     heuristic vs exhaustive search
  bench_ablation   Fig 14/AppD heterogeneous deployment + flow assignment

The JAX registry's other modules have no twin here: ``bench_roofline`` is
an XLA compile analysis at TPU rates with no GPU counterpart (ROADMAP item
9); ``bench_engine`` belongs to the port's benchmark (ROADMAP item 6); and
``bench_switch``, ``bench_prefix``, ``bench_rebalance``, ``bench_disagg``
and ``bench_recovery`` have count twins already (``chip_smoke.py`` and
``tests/test_torch_*.py``).
"""
from __future__ import annotations

import argparse
import importlib
import inspect
import sys
import time

MODULES = ["bench_predictor", "bench_scheduler", "bench_ablation",
           "bench_switching", "bench_e2e"]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", choices=MODULES, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    mods = [args.only] if args.only else MODULES
    print("name,us_per_call,derived")
    failures = []
    for name in mods:
        t0 = time.time()
        try:
            mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
            kw = ({"device": args.device}
                  if "device" in inspect.signature(mod.main).parameters
                  else {})
            rows = mod.main(fast=not args.full, **kw)
            for row in rows:
                print(row, flush=True)
            print(f"{name}/_total,{(time.time()-t0)*1e6:.0f},ok", flush=True)
        except Exception as e:  # keep the suite going
            failures.append((name, repr(e)))
            print(f"{name}/_total,{(time.time()-t0)*1e6:.0f},ERROR:{e!r}",
                  flush=True)
    if failures:
        print(f"# {len(failures)} benchmark module(s) failed", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
