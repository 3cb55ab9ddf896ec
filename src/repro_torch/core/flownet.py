"""Flow-network machinery for the lower-level workload assignment (paper S3.2).

Two solvers are provided (see DESIGN.md "Faithfulness note"):

  * ``maxflow_preflow_push`` — the paper's preflow-push algorithm (highest-label
    with gap heuristic) on integer capacities.  Exact for unit-uniform networks
    (each replica consumes the same normalized units per request regardless of
    type), and used as the general graph utility.
  * ``simplex_maximize`` — an exact dense-simplex packing-LP solver for the
    general mixed-unit network (generalized flow), maximizing served requests
    under constraints C1-C3.

``WorkloadFlowNetwork`` builds the paper's network (source, workload nodes,
intermediate nodes, replica in/out nodes with LCM-normalized capacity, sink),
dispatches to the right solver, and exposes the saturation analysis the
upper-level search (S3.3) consumes.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque

EPS = 1e-9


# --------------------------------------------------------------------------
# Preflow-push max-flow (highest-label + gap heuristic), integer capacities.
# --------------------------------------------------------------------------

def maxflow_preflow_push(
    n: int,
    edges: list[tuple[int, int, int]],
    s: int,
    t: int,
) -> tuple[int, list[int]]:
    """Max s-t flow via preflow-push (Cheriyan & Maheshwari style).

    Args:
      n: number of nodes.
      edges: (u, v, capacity) with non-negative integer capacities.
      s, t: source / sink node ids.

    Returns:
      (flow_value, flow_per_input_edge)
    """
    if s == t:
        return 0, [0] * len(edges)
    # Build adjacency with paired residual arcs.
    head: list[int] = []       # arc -> destination
    cap: list[int] = []        # arc -> residual capacity
    adj: list[list[int]] = [[] for _ in range(n)]
    orig: list[int] = []       # input edge -> arc id
    for (u, v, c) in edges:
        orig.append(len(head))
        adj[u].append(len(head)); head.append(v); cap.append(int(c))
        adj[v].append(len(head)); head.append(u); cap.append(0)

    height = [0] * n
    excess = [0] * n
    count = [0] * (2 * n + 1)  # gap heuristic: nodes per height
    height[s] = n
    count[0] = n - 1
    count[n] = 1

    # Saturate source arcs.
    for a in adj[s]:
        if cap[a] > 0:
            v = head[a]
            excess[v] += cap[a]
            excess[s] -= cap[a]
            cap[a ^ 1] += cap[a]
            cap[a] = 0

    # Highest-label bucket queue.
    buckets: list[list[int]] = [[] for _ in range(2 * n + 1)]
    in_bucket = [False] * n
    hi = 0
    for v in range(n):
        if v not in (s, t) and excess[v] > 0:
            buckets[height[v]].append(v)
            in_bucket[v] = True
            hi = max(hi, height[v])

    arc_ptr = [0] * n  # current-arc optimization

    def push(a: int, u: int) -> None:
        nonlocal hi
        v = head[a]
        d = min(excess[u], cap[a])
        cap[a] -= d
        cap[a ^ 1] += d
        excess[u] -= d
        excess[v] += d
        if v not in (s, t) and not in_bucket[v] and excess[v] > 0:
            buckets[height[v]].append(v)
            in_bucket[v] = True
            # The pusher may have been relabeled above the current scan
            # pointer mid-discharge; keep `hi` an upper bound on active heights.
            hi = max(hi, height[v])

    def relabel(u: int) -> None:
        nonlocal hi
        old = height[u]
        mh = 2 * n
        for a in adj[u]:
            if cap[a] > 0:
                mh = min(mh, height[head[a]] + 1)
        count[old] -= 1
        # Gap heuristic: if old height has no nodes, lift everything above it.
        if count[old] == 0 and old < n:
            for v in range(n):
                if v != s and old < height[v] <= n:
                    count[height[v]] -= 1
                    height[v] = n + 1
                    count[height[v]] += 1
        height[u] = mh
        count[mh] += 1
        arc_ptr[u] = 0

    while True:
        while hi >= 0 and not buckets[hi]:
            hi -= 1
        if hi < 0:
            break
        u = buckets[hi].pop()
        in_bucket[u] = False
        if u in (s, t) or excess[u] <= 0:
            continue
        while excess[u] > 0:
            if arc_ptr[u] == len(adj[u]):
                relabel(u)
                if height[u] > 2 * n - 1:
                    break
            else:
                a = adj[u][arc_ptr[u]]
                if cap[a] > 0 and height[u] == height[head[a]] + 1:
                    push(a, u)
                else:
                    arc_ptr[u] += 1
        if excess[u] > 0 and height[u] <= 2 * n - 1:
            buckets[height[u]].append(u)
            in_bucket[u] = True
            hi = max(hi, height[u])
        else:
            hi = max(hi, 0)

    flow_val = excess[t]
    # Each input edge owns its residual pair, so the backward residual
    # capacity equals the net flow pushed through that edge.
    per_edge = [cap[a ^ 1] for a in orig]
    return flow_val, per_edge


def maxflow_edmonds_karp(
    n: int, edges: list[tuple[int, int, int]], s: int, t: int
) -> int:
    """Reference oracle for tests (BFS augmenting paths)."""
    capm = [[0] * n for _ in range(n)]
    for u, v, c in edges:
        capm[u][v] += c
    flow = 0
    while True:
        parent = [-1] * n
        parent[s] = s
        q = deque([s])
        while q and parent[t] == -1:
            u = q.popleft()
            for v in range(n):
                if parent[v] == -1 and capm[u][v] > 0:
                    parent[v] = u
                    q.append(v)
        if parent[t] == -1:
            return flow
        # find bottleneck
        v, aug = t, math.inf
        while v != s:
            u = parent[v]
            aug = min(aug, capm[u][v])
            v = u
        v = t
        while v != s:
            u = parent[v]
            capm[u][v] -= aug
            capm[v][u] += aug
            v = u
        flow += aug


# --------------------------------------------------------------------------
# Dense simplex for packing LPs:  max c.x  s.t.  A x <= b, x >= 0, b >= 0.
# --------------------------------------------------------------------------

def simplex_maximize(
    c: list[float], A: list[list[float]], b: list[float]
) -> tuple[list[float], float]:
    """Exact simplex (Bland's rule; slack-variable initial basis).

    Requires b >= 0 (always true for capacities), so phase-1 is unnecessary.
    """
    m = len(A)
    nvars = len(c)
    assert all(bi >= -EPS for bi in b), "packing LP requires b >= 0"
    # Tableau: rows 0..m-1 constraints, row m objective (maximize -> minimize -c).
    # Columns: nvars original + m slacks + 1 rhs.
    ncols = nvars + m + 1
    T = [[0.0] * ncols for _ in range(m + 1)]
    for i in range(m):
        for j in range(nvars):
            T[i][j] = float(A[i][j])
        T[i][nvars + i] = 1.0
        T[i][-1] = max(0.0, float(b[i]))
    for j in range(nvars):
        T[m][j] = -float(c[j])
    basis = [nvars + i for i in range(m)]

    max_iters = 50 * (m + nvars + 10)
    for _ in range(max_iters):
        # Bland: entering = lowest index with negative reduced cost.
        enter = -1
        for j in range(nvars + m):
            if T[m][j] < -EPS:
                enter = j
                break
        if enter == -1:
            break
        # Ratio test with Bland tie-break on basis index.
        leave, best, best_basis = -1, math.inf, math.inf
        for i in range(m):
            a = T[i][enter]
            if a > EPS:
                ratio = T[i][-1] / a
                if ratio < best - EPS or (abs(ratio - best) <= EPS
                                          and basis[i] < best_basis):
                    leave, best, best_basis = i, ratio, basis[i]
        if leave == -1:
            raise ArithmeticError("LP unbounded (capacities must be finite)")
        # Pivot.
        piv = T[leave][enter]
        T[leave] = [v / piv for v in T[leave]]
        for i in range(m + 1):
            if i != leave and abs(T[i][enter]) > EPS:
                f = T[i][enter]
                T[i] = [vi - f * vl for vi, vl in zip(T[i], T[leave])]
        basis[leave] = enter
    x = [0.0] * nvars
    for i in range(m):
        if basis[i] < nvars:
            x[basis[i]] = max(0.0, T[i][-1])
    value = sum(ci * xi for ci, xi in zip(c, x))
    return x, value


# --------------------------------------------------------------------------
# The paper's workload flow network.
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FlowSolution:
    x: list[list[float]]            # x[k][j] requests of type j -> replica k
    throughput: float               # total served requests per span
    utilization: list[float]        # per-replica normalized load in [0, 1]
    unserved: list[float]           # per-type leftover demand
    solver: str                     # "preflow_push" | "simplex"


class WorkloadFlowNetwork:
    """S -> w_j -> i_{k,j} -> c_k_in -> c_k_out -> T with LCM normalization."""

    def __init__(self, rates: list[float], n_cap: list[list[float]],
                 e_cap: list[list[float]] | None = None):
        """Args:
          rates: lambda_j, requests of type j arriving this span.
          n_cap: n[k][j], replica-k capacity for pure type-j load (per span).
          e_cap: e[k][j] per-type routing caps; defaults to n[k][j].
        """
        self.rates = [max(0.0, r) for r in rates]
        self.n_cap = n_cap
        self.e_cap = e_cap or [row[:] for row in n_cap]
        self.K = len(n_cap)
        self.J = len(rates)
        # LCM normalization (paper S3.2) on integer-rounded capacities.
        # floor: integral flow on floored capacities keeps C3 <= 1 exactly
        self.n_int = [[max(0, int(v)) for v in row] for row in n_cap]
        self.M: list[int] = []
        self.m_units: list[list[int]] = []
        for k in range(self.K):
            pos = [v for v in self.n_int[k] if v > 0]
            Mk = 1
            for v in pos:
                Mk = Mk * v // math.gcd(Mk, v)
            self.M.append(Mk if pos else 0)
            self.m_units.append([
                (self.M[k] // v) if v > 0 else 0 for v in self.n_int[k]
            ])

    # -- structure ---------------------------------------------------------

    def node_ids(self):
        """S=0, w_j=1+j, i_{k,j}, c_k_in, c_k_out, T (for the flow graph)."""
        S = 0
        w = {j: 1 + j for j in range(self.J)}
        base = 1 + self.J
        i = {(k, j): base + k * self.J + j for k in range(self.K) for j in range(self.J)}
        base += self.K * self.J
        cin = {k: base + k for k in range(self.K)}
        cout = {k: base + self.K + k for k in range(self.K)}
        T = base + 2 * self.K
        return S, w, i, cin, cout, T, T + 1

    def unit_uniform(self) -> bool:
        """True iff every replica charges the same units per request across types
        it can serve -> the network is an exact standard max-flow instance."""
        for k in range(self.K):
            units = {self.m_units[k][j] for j in range(self.J)
                     if self.n_int[k][j] > 0}
            if len(units) > 1:
                return False
        return True

    # -- solvers -------------------------------------------------------------

    def solve(self) -> FlowSolution:
        if self.unit_uniform():
            return self._solve_maxflow()
        return self._solve_lp()

    def _solve_maxflow(self) -> FlowSolution:
        S, w, i, cin, cout, T, n_nodes = self.node_ids()
        edges: list[tuple[int, int, int]] = []
        eidx: dict[tuple[int, int], int] = {}
        for j in range(self.J):
            edges.append((S, w[j], int(self.rates[j])))   # floor: integral demand
        for k in range(self.K):
            for j in range(self.J):
                cap_kj = min(self.e_cap[k][j], self.n_int[k][j])
                if self.n_int[k][j] <= 0:
                    continue
                eidx[(k, j)] = len(edges)
                edges.append((w[j], i[(k, j)], int(cap_kj)))
                edges.append((i[(k, j)], cin[k], int(cap_kj)))
            # node capacity in requests (uniform units -> M_k/m = n)
            per_req = next((self.m_units[k][j] for j in range(self.J)
                            if self.n_int[k][j] > 0), 0)
            node_cap = self.M[k] // per_req if per_req else 0
            edges.append((cin[k], cout[k], node_cap))
            edges.append((cout[k], T, 10 ** 12))
        val, per_edge = maxflow_preflow_push(n_nodes, edges, S, T)
        x = [[0.0] * self.J for _ in range(self.K)]
        for (k, j), idx in eidx.items():
            x[k][j] = float(per_edge[idx])
        return self._finish(x, "preflow_push")

    def _solve_lp(self) -> FlowSolution:
        K, J = self.K, self.J
        nvars = K * J
        var = lambda k, j: k * J + j
        c = [1.0] * nvars
        A: list[list[float]] = []
        b: list[float] = []
        # C1: per-type demand.
        for j in range(J):
            row = [0.0] * nvars
            for k in range(K):
                row[var(k, j)] = 1.0
            A.append(row); b.append(self.rates[j])
        # C2: per-edge caps.
        for k in range(K):
            for j in range(J):
                row = [0.0] * nvars
                row[var(k, j)] = 1.0
                A.append(row)
                b.append(min(self.e_cap[k][j], self.n_cap[k][j])
                         if self.n_cap[k][j] > 0 else 0.0)
        # C3: node capacity sharing, sum_j x_kj / n_kj <= 1.
        for k in range(K):
            row = [0.0] * nvars
            any_pos = False
            for j in range(J):
                if self.n_cap[k][j] > 0:
                    row[var(k, j)] = 1.0 / self.n_cap[k][j]
                    any_pos = True
                else:
                    row[var(k, j)] = 0.0  # covered by C2 zero cap
            if any_pos:
                A.append(row); b.append(1.0)
        xs, _ = simplex_maximize(c, A, b)
        x = [[xs[var(k, j)] for j in range(J)] for k in range(K)]
        return self._finish(x, "simplex")

    def _finish(self, x: list[list[float]], solver: str) -> FlowSolution:
        util = []
        for k in range(self.K):
            u = 0.0
            for j in range(self.J):
                if self.n_cap[k][j] > 0:
                    u += x[k][j] / self.n_cap[k][j]
            util.append(u)
        served_per_type = [sum(x[k][j] for k in range(self.K)) for j in range(self.J)]
        unserved = [max(0.0, self.rates[j] - served_per_type[j]) for j in range(self.J)]
        throughput = sum(served_per_type)
        return FlowSolution(x, throughput, util, unserved, solver)

    # -- saturation analysis for the upper level -----------------------------

    def bottlenecks(self, sol: FlowSolution, sat: float = 0.99,
                    under: float = 0.7) -> tuple[list[int], list[int]]:
        """(overutilized replica ids, underutilized replica ids)."""
        over = [k for k, u in enumerate(sol.utilization) if u >= sat]
        low = [k for k, u in enumerate(sol.utilization) if u < under]
        return over, low

    # -- makespan balancing (paper Appendix D) --------------------------------

    def balance(self, sol: FlowSolution, iters: int = 200) -> FlowSolution:
        """Redistribute the optimal flow to minimize the max replica
        utilization (completion time) without changing per-type totals.

        Max-flow/LP solutions sit at simplex corners that may saturate one
        replica while another idles; the paper's Appendix-D examples balance
        fractions to equalize busy time.  Pairwise moves: shift type-j flow
        from the most- to a less-utilized replica, bounded by e_{k,j}.
        """
        K, J = self.K, self.J
        # Seed from the capacity-proportional allocation of the LP's per-type
        # totals (the unique symmetric point on identical replicas; LP corner
        # solutions skew type composition even at equal utilization), clipped
        # to the e_{k,j} routing caps with redistribution; the pairwise mover
        # below then repairs any C3 violations and polishes toward min sum(u^2).
        totals = [sum(sol.x[k][j] for k in range(K)) for j in range(J)]
        x = [[0.0] * J for _ in range(K)]
        for j in range(J):
            remaining = totals[j]
            open_ks = [k for k in range(K) if self.n_cap[k][j] > 0
                       and min(self.e_cap[k][j], self.n_cap[k][j]) > 0]
            for _ in range(4):
                if remaining <= 1e-9 or not open_ks:
                    break
                weights = {k: self.n_cap[k][j] for k in open_ks}
                wsum = sum(weights.values())
                placed = 0.0
                next_open = []
                for k in open_ks:
                    want = remaining * weights[k] / wsum
                    cap = min(self.e_cap[k][j], self.n_cap[k][j]) - x[k][j]
                    give = min(want, max(cap, 0.0))
                    x[k][j] += give
                    placed += give
                    if cap - give > 1e-9:
                        next_open.append(k)
                remaining -= placed
                open_ks = next_open
            if remaining > 1e-9:
                # fall back to the LP allocation for this type
                for k in range(K):
                    x[k][j] = sol.x[k][j]

        def util(k):
            return sum(x[k][j] / self.n_cap[k][j]
                       for j in range(J) if self.n_cap[k][j] > 0)

        us = [util(k) for k in range(K)]
        for _ in range(iters):
            # best pairwise move under the sum-of-squares objective (strictly
            # convex -> converges to the unique most-balanced feasible point,
            # robust to stochastic arrivals, unlike LP corner solutions)
            best = None
            for k1 in range(K):
                for j in range(J):
                    if x[k1][j] <= 1e-9 or self.n_cap[k1][j] <= 0:
                        continue
                    for k2 in range(K):
                        if k2 == k1 or self.n_cap[k2][j] <= 0:
                            continue
                        if us[k2] >= us[k1] - 1e-9:
                            continue
                        cap_e = min(self.e_cap[k2][j], self.n_cap[k2][j])
                        head = cap_e - x[k2][j]
                        if head <= 1e-9:
                            continue
                        delta = (us[k1] - us[k2]) / (
                            1.0 / self.n_cap[k1][j] + 1.0 / self.n_cap[k2][j])
                        delta = min(delta, x[k1][j], head)
                        du1 = delta / self.n_cap[k1][j]
                        du2 = delta / self.n_cap[k2][j]
                        gain = (us[k1] ** 2 + us[k2] ** 2
                                - (us[k1] - du1) ** 2 - (us[k2] + du2) ** 2)
                        # latency-aware preference (paper S5.2: route types
                        # that benefit from model parallelism to the bigger
                        # replicas): among near-equal-util moves, prefer
                        # placing flow where its per-request service is
                        # faster (higher n_{k,j})
                        lat_gain = delta * (1.0 / self.n_cap[k1][j]
                                            - 1.0 / self.n_cap[k2][j])
                        gain = gain + 0.2 * lat_gain
                        if best is None or gain > best[0]:
                            best = (gain, j, k1, k2, delta)
            if best is None or best[0] < 1e-12:
                break
            _, j, k1, k2, delta = best
            x[k1][j] -= delta
            x[k2][j] += delta
            us[k1] = util(k1)
            us[k2] = util(k2)
        out = self._finish(x, sol.solver + "+balance")
        # Guarantee: never worse than the input solution (the proportional
        # seed + mover is a heuristic; fall back when it loses on either
        # served throughput or peak utilization).
        if (out.throughput < sol.throughput - 1e-6
                or max(out.utilization, default=0.0)
                > max(sol.utilization, default=0.0) + 1e-9):
            return self._finish([row[:] for row in sol.x],
                                sol.solver + "+balance")
        return out
