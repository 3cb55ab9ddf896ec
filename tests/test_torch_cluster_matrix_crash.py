"""``tests/test_faults.py``'s seeded chaos matrix, its crash and failed-
switch cells (a crash mid-decode with pages kept and lost, a migration
failure mid-switch, an engine-build failure), at both of its seeds: the
same ``FaultPlan.seeded`` plan goes to the JAX package's cluster and the
port's, which must agree in full (``torch_cluster_twins.check_matrix_cell``);
yi-9b smoke, fp32, the CPU."""
import pytest

from torch_cluster_twins import check_matrix_cell


@pytest.mark.parametrize("case", ["crash-decode", "crash-decode-lose-pages",
                                  "crash-during-switch", "build-failure"])
@pytest.mark.parametrize("seed", [11, 23])
def test_matrix_cell_matches_jax(case, seed):
    check_matrix_cell(case, seed)
