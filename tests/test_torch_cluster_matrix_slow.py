"""``tests/test_faults.py``'s seeded chaos matrix, its degradation cells (a
stall, an injected OOM, a slow replica, a traffic hot spot), at both of its
seeds: the same ``FaultPlan.seeded`` plan goes to the JAX package's
cluster and the port's, which must agree in full
(``torch_cluster_twins.check_matrix_cell``); yi-9b smoke, fp32, the CPU."""
import pytest

from torch_cluster_twins import check_matrix_cell


@pytest.mark.parametrize("case", ["stall", "oom", "slow", "hotspot"])
@pytest.mark.parametrize("seed", [11, 23])
def test_matrix_cell_matches_jax(case, seed):
    check_matrix_cell(case, seed)
