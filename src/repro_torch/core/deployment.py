"""Upper-level model deployment search (paper S3.3 + Appendix F, Algorithm 1).

Two searchers:

  * ``exhaustive_search`` — enumerate every multiset partition of the chips
    into replicas x every strategy combination.  The paper's optimality
    baseline (S5.4); tractable only for small clusters.
  * ``flow_guided_search`` — Algorithm 1: start from a uniform deployment,
    iteratively (a) solve the lower-level flow network, (b) classify replicas
    as over-/under-utilized, (c) randomly merge / split / swap chips between
    them, (d) re-optimize parallelism strategies, accepting only improvements,
    until no improvement for ``patience`` rounds.
"""
from __future__ import annotations

import dataclasses
import itertools
import random

from repro_torch.core.assignment import AssignmentResult, assign_workloads
from repro_torch.core.costmodel import CostModel
from repro_torch.core.types import Deployment, WorkloadType, valid_strategies


@dataclasses.dataclass
class SearchResult:
    deployment: Deployment
    assignment: AssignmentResult
    evaluations: int
    iterations: int

    @property
    def throughput(self) -> float:
        return self.assignment.throughput


class _Evaluator:
    """Memoized lower-level evaluation keyed on the canonical deployment.

    ``score`` orders deployments by (served demand, served demand under 2x
    stress, -max utilization): the stress term measures true capacity
    headroom so demand-limited ties never keep junk replicas alive.
    """

    STRESS = 2.0

    def __init__(self, cm: CostModel, workloads: list[WorkloadType]):
        self.cm = cm
        self.workloads = workloads
        self.stressed = [w.with_rate(w.rate * self.STRESS) for w in workloads]
        self.cache: dict[tuple, AssignmentResult] = {}
        self.stress_cache: dict[tuple, float] = {}
        self.evaluations = 0

    @staticmethod
    def _key(dep: Deployment):
        return tuple(sorted((r.tp, r.pp, r.role) for r in dep.replicas))

    def __call__(self, dep: Deployment) -> AssignmentResult:
        key = self._key(dep)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        self.evaluations += 1
        res = assign_workloads(self.cm, dep, self.workloads)
        self.cache[key] = res
        return res

    def stress_throughput(self, dep: Deployment) -> float:
        key = self._key(dep)
        if key not in self.stress_cache:
            self.stress_cache[key] = assign_workloads(
                self.cm, dep, self.stressed, balance=False).throughput
        return self.stress_cache[key]

    def score(self, dep: Deployment) -> tuple:
        res = self(dep)
        # Residence (latency) terms under the optimized assignment: the tail
        # is set by the slowest (replica, type) pair actually carrying flow;
        # deployments that park long-output types on weak replicas lose here
        # even when raw throughput ties.
        max_resp, wsum, wresp = 0.0, 0.0, 0.0
        for k, rc in enumerate(dep.replicas):
            for j, w in enumerate(self.workloads):
                xkj = res.solution.x[k][j]
                if xkj > 1e-6:
                    p = self.cm.replica_perf(rc, w)
                    r = p.prefill_time + w.out_len * p.decode_step_time
                    max_resp = max(max_resp, r)
                    wresp += xkj * r
                    wsum += xkj
        mean_resp = wresp / max(wsum, 1e-9)

        def q(v: float) -> int:
            # 2% geometric buckets: differences below the cost model's
            # fidelity don't justify a more fragile deployment
            import math
            return int(math.log(max(v, 1e-9)) / math.log(1.02))

        return (q(res.throughput),
                q(self.stress_throughput(dep)),
                -round(max_resp, 1),
                -round(mean_resp, 2),
                -dep.dp,                      # Occam: fewer replicas on ties
                -res.latency_proxy())


# --------------------------------------------------------------------------
# Exhaustive enumeration (optimality baseline).
# --------------------------------------------------------------------------

def _partitions(total: int, min_part: int, max_parts: int):
    """Non-increasing partitions of `total` into parts >= min_part."""
    def rec(remaining: int, max_part: int, acc: list[int]):
        if remaining == 0:
            yield tuple(acc)
            return
        if len(acc) >= max_parts:
            return
        for part in range(min(max_part, remaining), min_part - 1, -1):
            acc.append(part)
            yield from rec(remaining - part, part, acc)
            acc.pop()
    yield from rec(total, total, [])


def enumerate_deployments(
    chips: int,
    min_chips: int,
    max_tp: int = 8,
    max_pp: int = 8,
    max_replicas: int = 16,
    limit: int = 200_000,
) -> list[Deployment]:
    out: list[Deployment] = []
    for sizes in _partitions(chips, min_chips, max_replicas):
        per_size_strats = [valid_strategies(s, max_tp=max_tp, max_pp=max_pp)
                           for s in sizes]
        if any(not s for s in per_size_strats):
            continue
        for combo in itertools.product(*per_size_strats):
            out.append(Deployment(tuple(combo)).canonical())
            if len(out) >= limit:
                return _dedup(out)
    return _dedup(out)


def _dedup(deps: list[Deployment]) -> list[Deployment]:
    seen, out = set(), []
    for d in deps:
        key = tuple(sorted((r.tp, r.pp, r.role) for r in d.replicas))
        if key not in seen:
            seen.add(key)
            out.append(d)
    return out


def exhaustive_search(
    cm: CostModel,
    chips: int,
    workloads: list[WorkloadType],
    max_tp: int = 8,
    max_pp: int = 8,
) -> SearchResult:
    ev = _Evaluator(cm, workloads)
    best = None
    deps = enumerate_deployments(chips, cm.min_chips(), max_tp, max_pp)
    for dep in deps:
        score = ev.score(dep)
        if best is None or score > best[0]:
            best = (score, dep)
    assert best is not None, "no feasible deployment (cluster too small?)"
    return SearchResult(best[1], ev(best[1]), ev.evaluations, len(deps))


# --------------------------------------------------------------------------
# Algorithm 1: flow-network-guided generation.
# --------------------------------------------------------------------------

def uniform_initial(cm: CostModel, chips: int, max_tp: int, max_pp: int
                    ) -> Deployment:
    """Paper initialization: identical replicas sized by min memory, pure TP."""
    per = max(cm.min_chips(), 1)
    # Prefer a size that admits a pure-TP strategy.
    while per <= chips and not valid_strategies(per, max_tp=max_tp, max_pp=max_pp):
        per += 1
    per = min(per, chips)
    n_replicas = max(1, chips // per)
    sizes = [per] * n_replicas
    leftover = chips - per * n_replicas
    i = 0
    while leftover > 0:
        sizes[i % n_replicas] += 1
        leftover -= 1
        i += 1
    reps = []
    for s in sizes:
        strats = valid_strategies(s, max_tp=max_tp, max_pp=max_pp)
        if not strats:
            strats = valid_strategies(s, max_tp=s, max_pp=s)
        pure_tp = [r for r in strats if r.pp == 1]
        reps.append(pure_tp[-1] if pure_tp else strats[0])
    return Deployment(tuple(reps))


def _reoptimize_strategies(
    ev: _Evaluator, sizes: list[int], max_tp: int, max_pp: int,
    full_product_limit: int = 256,
) -> tuple[Deployment, AssignmentResult] | None:
    """Pick {s_r} maximizing throughput for fixed chip sizes.

    Full cartesian enumeration when small (paper's description); coordinate
    ascent otherwise (documented heuristic for scalability).
    """
    per_size = [valid_strategies(s, max_tp=max_tp, max_pp=max_pp) for s in sizes]
    if any(not s for s in per_size):
        return None
    n_combos = 1
    for s in per_size:
        n_combos *= len(s)
    if n_combos <= full_product_limit:
        best = None
        for combo in itertools.product(*per_size):
            dep = Deployment(tuple(combo))
            sc = ev.score(dep)
            if best is None or sc > best[0]:
                best = (sc, dep)
        return best[1], ev(best[1])
    # Coordinate ascent.
    current = [opts[0] for opts in per_size]
    best_sc = ev.score(Deployment(tuple(current)))
    for _ in range(2):
        improved = False
        for r, opts in enumerate(per_size):
            for cand in opts:
                trial = current[:]
                trial[r] = cand
                sc = ev.score(Deployment(tuple(trial)))
                if sc > best_sc:
                    current, best_sc, improved = trial, sc, True
        if not improved:
            break
    dep = Deployment(tuple(current))
    return dep, ev(dep)


def flow_guided_search(
    cm: CostModel,
    chips: int,
    workloads: list[WorkloadType],
    max_tp: int = 8,
    max_pp: int = 8,
    patience: int = 20,
    max_iters: int = 200,
    seed: int = 0,
    initial: Deployment | None = None,
) -> SearchResult:
    """Algorithm 1 (Appendix F)."""
    rng = random.Random(seed)
    ev = _Evaluator(cm, workloads)
    min_chips = cm.min_chips()

    dep = initial if initial is not None else uniform_initial(cm, chips, max_tp, max_pp)
    best = ev(dep)
    best_score = ev.score(dep)
    stale = 0
    iters = 0
    for iters in range(1, max_iters + 1):
        sizes = [r.chips for r in dep.replicas]
        sol = ev(dep).solution
        over = [k for k, u in enumerate(sol.utilization) if u >= 0.99]
        under = [k for k, u in enumerate(sol.utilization) if u < 0.7]
        new_sizes = sizes[:]
        mutated = False

        # Over-utilized replicas: merge with a peer, or take chips from an
        # under-utilized one (swap).
        for k in list(over):
            if k >= len(new_sizes):
                continue
            op = rng.choice(["merge", "swap"])
            if op == "merge" and len(over) > 1 and len(new_sizes) > 1:
                others = [o for o in over if o != k and o < len(new_sizes)]
                if not others:
                    continue
                o = rng.choice(others)
                a, b = sorted((k, o))
                new_sizes[a] = new_sizes[a] + new_sizes[b]
                del new_sizes[b]
                over = [i for i in over if i != o]
                mutated = True
                break  # indices shifted; one structural op per round
            elif op == "swap" and under:
                u = rng.choice([u_ for u_ in under if u_ < len(new_sizes)] or [None])
                if u is None:
                    continue
                give = new_sizes[u] - min_chips
                if give <= 0:
                    continue
                delta = rng.randint(1, give)
                new_sizes[u] -= delta
                new_sizes[k] += delta
                mutated = True

        # Under-utilized replicas: split in two, or give chips away (handled
        # above as the receiving side of swap).
        if not mutated:
            for k in under:
                if k >= len(new_sizes):
                    continue
                if rng.random() < 0.5 and new_sizes[k] >= 2 * min_chips:
                    cut = rng.randint(min_chips, new_sizes[k] - min_chips)
                    new_sizes.append(new_sizes[k] - cut)
                    new_sizes[k] = cut
                    mutated = True
                    break
                elif over:
                    o = rng.choice(over)
                    give = new_sizes[k] - min_chips
                    if give <= 0:
                        continue
                    delta = rng.randint(1, give)
                    new_sizes[k] -= delta
                    new_sizes[o % len(new_sizes)] += delta
                    mutated = True
                    break

        if not mutated:
            # Random perturbation keeps the search unbiased (Appendix F).
            if len(new_sizes) >= 2 and rng.random() < 0.5:
                a, b = rng.sample(range(len(new_sizes)), 2)
                if new_sizes[a] > min_chips:
                    new_sizes[a] -= 1
                    new_sizes[b] += 1
                    mutated = True
            elif new_sizes and new_sizes[0] >= 2 * min_chips:
                cut = new_sizes[0] // 2
                new_sizes.append(new_sizes[0] - cut)
                new_sizes[0] = cut
                mutated = True

        if not mutated or sum(new_sizes) != chips:
            stale += 1
            if stale >= patience:
                break
            continue

        reopt = _reoptimize_strategies(ev, new_sizes, max_tp, max_pp)
        if reopt is None:
            stale += 1
            if stale >= patience:
                break
            continue
        cand_dep, cand_res = reopt
        if ev.score(cand_dep) > best_score:
            dep, best = cand_dep, cand_res
            best_score = ev.score(cand_dep)
            stale = 0
        else:
            stale += 1
            if stale >= patience:
                break
    return SearchResult(dep, best, ev.evaluations, iters)


def role_split_search(
    cm: CostModel,
    dep: Deployment,
    workloads: list[WorkloadType],
    ev: _Evaluator | None = None,
) -> Deployment:
    """Pick the best prefill:decode role split for a fixed deployment shape.

    Disaggregation is a *role* axis on top of the chip/strategy search:
    for each split size the ``n_pre`` largest-TP replicas take the
    ``prefill`` role (prefill is compute-bound; TP divides its latency)
    and the rest take ``decode`` (bandwidth-bound, batch-hungry), scored
    by the same evaluator the deployment search uses — coupled admission
    capacity via ``profile_capacities``, then latency residence on ties.
    Because throughput quantizes into 2% buckets, a demand-limited span
    (both shapes serve all arrivals) is decided by the residence terms,
    where prefill-only replicas shine on long-prompt-heavy mixes — the
    planner disaggregates exactly when there is capacity headroom to
    spend on latency.  Returns the all-mixed baseline when no split wins.
    """
    if dep.dp < 2:
        return dep
    if ev is None:
        ev = _Evaluator(cm, workloads)
    mixed = Deployment(tuple(r.with_role("mixed") for r in dep.replicas))
    best, best_sc = mixed, ev.score(mixed)
    order = sorted(range(dep.dp),
                   key=lambda k: (-dep.replicas[k].tp,
                                  -dep.replicas[k].chips))
    for n_pre in range(1, dep.dp):
        pre = set(order[:n_pre])
        cand = Deployment(tuple(
            r.with_role("prefill" if k in pre else "decode")
            for k, r in enumerate(mixed.replicas)))
        sc = ev.score(cand)
        if sc > best_sc:
            best, best_sc = cand, sc
    return best
