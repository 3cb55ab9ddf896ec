"""KV migration of the SSM and hybrid families (mamba2-370m, hymba-1.5b)
in the port against the JAX package's: the page handoff carries each
sequence's SSM state and conv rows with (or, for mamba2, instead of) its
pages.  The cases and the field-by-field comparison are
``test_torch_migration.py``'s; they run in a file of their own so that
the two files share the work between test workers.
"""
import pytest

from repro_torch.serving import migration as tmig
from test_torch_migration import CASES, _check_case, _jobs, _package


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith("ssm-")])
def test_ssm_migration_matches_jax(name):
    _check_case(name)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
def test_snapshot_owns_its_ssm_rows(arch):
    """After the export a new request takes the source slot, and its
    prefill overwrites the slot's SSM and conv rows in place; the snapshot
    is imported after that and must still resume its own state."""
    pkg = _package("torch", arch)
    jobs = _jobs(pkg.vocab, 8, ((16, 5), (9, 6)))
    ref = pkg.engine(num_blocks=256, block_size=8, max_seqs=8)
    for rid, (p, n) in enumerate(jobs):
        ref.submit(rid, p, n)
    want = {r.rid: list(r.generated) for r in ref.run_to_completion()}

    pool = pkg.pool(32, 8)
    src = pkg.engine(block_size=8, max_seqs=2, pool=pool, kv_quota=32)
    dst = pkg.engine(block_size=8, max_seqs=2, pool=pool, kv_quota=32)
    for rid, (p, n) in enumerate(jobs):
        src.submit(rid, p, n)
    src.step()
    src.step()
    snaps = src.export_inflight(release=False)
    rows = [(s.ssm.clone(), s.conv.clone()) for s in snaps]
    intruder = _jobs(pkg.vocab, 99, ((12, 3),))[0][0]
    src.submit(9, intruder, 3)
    src.step()                               # prefill into slot 0's rows
    assert src.active[0].rid == 9
    for s, (ssm, conv) in zip(snaps, rows):
        assert s.ssm.equal(ssm) and s.conv.equal(conv)
    report = tmig.migrate_batch(dst, snaps)
    assert report.handoff == 2
    got = {r.rid: list(r.generated) for r in dst.run_to_completion()}
    assert got == want
