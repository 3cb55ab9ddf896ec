"""The twins of the paper's analytic benchmarks (``repro_torch.benchmarks``
and ``repro_torch.trace_simulation``) against the JAX package's
``benchmarks/`` and ``examples/trace_simulation.py``.

Each twin's rows equal the JAX rows once the wall-clock fields are
dropped: the ``us_per_call`` column where it holds a host time
(``sim_seconds``, the searches' seconds) and ``bench_scheduler``'s
``heuristic=`` and ``exhaustive=``.  Everything else is compared with
``==``.  The experiment context is ``Bench("opt-30b", 8, 6, 2)`` (4305
requests), built once per package; the rows' entry points that build
their own ``Bench`` get that one, after checking that they asked for it."""
import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch
from test_torch_simulator import sim_fields
from torch_cluster_twins import plain

import benchmarks.bench_ablation as jablation
import benchmarks.bench_e2e as je2e
import benchmarks.bench_scheduler as jscheduler
import benchmarks.bench_switching as jswitching
import benchmarks.common as jcommon
import repro.serving.baselines as jbase
import repro_torch.benchmarks.bench_ablation as tablation
import repro_torch.benchmarks.bench_e2e as te2e
import repro_torch.benchmarks.bench_scheduler as tscheduler
import repro_torch.benchmarks.bench_switching as tswitching
import repro_torch.benchmarks.common as tcommon
import repro_torch.serving.baselines as tbase
from repro_torch import trace_simulation

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH_ARGS = ("opt-30b", 8, 6, 2)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as every port test file pins."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def benches():
    """``Bench(*BENCH_ARGS)`` in each package, with every ``calibrate_rate``
    call it made (arguments and result)."""
    out = {}
    for pkg, common in (("jax", jcommon), ("torch", tcommon)):
        calls = []
        real = common.calibrate_rate

        def recording(cm, chips, archetypes, mix, _real=real, _calls=calls,
                      **kw):
            rate = _real(cm, chips, archetypes, mix, **kw)
            _calls.append((chips, plain(archetypes), plain(mix), kw, rate))
            return rate

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(common, "calibrate_rate", recording)
            out[pkg] = (common.Bench(*BENCH_ARGS), calls)
    return out


def cached(bench, spans=BENCH_ARGS[2]):
    """A stand-in for ``Bench`` that hands out ``bench`` when asked for
    ``BENCH_ARGS`` with ``spans`` spans (``macro`` asks for 40 and gets
    the 6-span bench)."""
    def make(model, chips, n_spans, trace_id, hw="h100", **kw):
        assert (model, chips, n_spans, trace_id, hw, kw) == (
            BENCH_ARGS[0], BENCH_ARGS[1], spans, BENCH_ARGS[3], "h100", {})
        return bench
    return make


def drop_time(rows):
    """Rows without their ``us_per_call`` column."""
    return [row.split(",", 2)[0::2] for row in rows]


def bench_fields(b) -> dict:
    return {"cfg": dataclasses.asdict(b.cfg), "cm": plain(vars(b.cm)),
            "cluster": plain(b.cluster), "n_spans": b.n_spans,
            "trace_id": b.trace_id,
            "centroids": plain(b.clusterer.centroids),
            "raw_centroids": plain(b.clusterer.raw_centroids),
            "archetypes": plain(b.archetypes), "rate": b.rate,
            "requests": [vars(r) for r in b.requests],
            "tagged": [vars(r) for r in b.tagged_requests()],
            "labels": plain(b.labels), "counts": plain(b.counts),
            "avg_rates": plain(b.avg_rates)}


def test_bench_equals_jax(benches):
    (jb, jcalls), (tb, tcalls) = benches["jax"], benches["torch"]
    # five anchors, each calibrated once, at the same rates
    assert tcalls == jcalls and len(tcalls) == 5
    got, want = bench_fields(tb), bench_fields(jb)
    assert len(got["requests"]) == 4305
    for k in want:
        assert got[k] == want[k], k


def test_bench_has_no_tpu():
    with pytest.raises(ValueError, match="H100 only"):
        tcommon.Bench(*BENCH_ARGS, hw="tpu")
    assert list(tcommon.HW) == ["h100"]


@pytest.mark.parametrize("name", ["oserve", "oserve-naive-reload"])
def test_bench_run_equals_jax_request_by_request(benches, name):
    """``Bench.run`` under OServe (one deployment switch on this trace),
    ad hoc and with naive reload, equal to the bit (``test_torch_simulator``
    holds every policy on a trace where OServe keeps its deployment)."""
    naive = name == "oserve-naive-reload"
    got = {}
    for pkg, base in (("jax", jbase), ("torch", tbase)):
        b = benches[pkg][0]
        pol = base.OServePolicy(b.cm, b.cluster, b.archetypes,
                                naive_reload=naive)
        res, m = b.run(pol)
        got[pkg] = (sim_fields(pol, res),
                    {k: v for k, v in m.items() if k != "sim_seconds"})
    assert got["torch"] == got["jax"]
    assert got["torch"][0]["switch_spans"] == 1


def test_e2e_rows_equal_jax(benches, monkeypatch):
    rows = {}
    for pkg, mod in (("jax", je2e), ("torch", te2e)):
        monkeypatch.setattr(mod, "Bench", cached(benches[pkg][0]))
        rows[pkg] = mod.run("opt-30b", 8, trace_id=2, n_spans=6,
                            spans_detail=True)
    assert drop_time(rows["torch"]) == drop_time(rows["jax"])
    # six policies, two with six span rows, and the gain row
    assert len(rows["torch"]) == 6 + 12 + 1
    assert rows["torch"][-1].startswith("e2e/opt-30b/8c/t2/gain,0,p99_x=")


def test_ablation_rows_equal_jax():
    got = tablation.main()
    assert got == jablation.main()
    assert len(got) == 7 and got[0].startswith("ablation/appendix-d,0,")


def test_switching_micro_rows_equal_jax():
    """``micro``'s time column is the switch plan's estimate, not a wall
    time, so the rows are equal whole; the port has the h100 rows."""
    got = tswitching.micro()
    assert got == [r for r in jswitching.micro() if "/h100/" in r]
    assert len(got) == 3


def test_switching_macro_rows_equal_jax(benches, monkeypatch):
    rows = {}
    for pkg, mod in (("jax", jswitching), ("torch", tswitching)):
        monkeypatch.setattr(mod, "Bench", cached(benches[pkg][0], 40))
        rows[pkg] = mod.macro(chips=8)
    assert drop_time(rows["torch"]) == drop_time(rows["jax"])
    assert len(rows["torch"]) == 2


def scheduler_fields(rows):
    """``bench_scheduler``'s rows without the searches' wall times."""
    return [(row.split(",")[0], re.sub(r"(heuristic|exhaustive)=[0-9.]+s;",
                                       "", row.split(",", 2)[2]))
            for row in rows]


def test_scheduler_rows_equal_jax():
    got = scheduler_fields(tscheduler.main())
    assert got == scheduler_fields(jscheduler.main())
    assert [g[0] for g in got] == ["scheduler/8gpus", "scheduler/16gpus"]
    assert all("thr_gap=" in g[1] and "evals=" in g[1] and "dep=" in g[1]
               for g in got)


def test_trace_simulation_prints_the_jax_table(benches, monkeypatch,
                                               capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_trace_simulation", ROOT / "examples" / "trace_simulation.py")
    jts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jts)
    argv = ["--chips", "8", "--spans", "6", "--trace", "2"]
    monkeypatch.setattr(jts, "Bench", cached(benches["jax"][0]))
    monkeypatch.setattr("sys.argv", ["trace_simulation.py"] + argv)
    jts.main()
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(trace_simulation, "Bench",
                        cached(benches["torch"][0]))
    trace_simulation.main(argv)
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len(got) == 3 + 7 and "4305 requests" in got[1]


def test_trace_simulation_offers_h100_only():
    with pytest.raises(SystemExit):
        trace_simulation.main(["--hw", "tpu"])


def test_gain_rows_are_consistent(benches):
    """The gain row is the ratio of the OServe and vLLM-static rows'
    metrics (the abstract's comparison), and every policy accounts for
    every request."""
    rows, results = te2e.compare(benches["torch"][0], "opt-30b", 8, 2)
    o, v = results["oserve"][1], results["vllm-static"][1]
    gain = dict(kv.split("=") for kv in rows[-1].split(",")[2].split(";"))
    assert float(gain["p99_x"]) == pytest.approx(v["p99"] / o["p99"],
                                                 abs=0.005)
    for res, m in results.values():
        assert m["completed"] + m["dropped"] == len(res.requests) == 4305
    assert np.isfinite(o["p99"])
