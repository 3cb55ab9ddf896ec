"""``python -m repro_torch.quickstart`` (the twin of
``examples/quickstart.py``) on the CPU: the smoke config's six requests all
finish with their 12 tokens, and the lines are the example's."""
import pytest
import torch

from repro_torch import quickstart
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params, param_count


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the other test workers hold the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m"])
def test_quickstart_finishes_every_request_on_the_cpu(capsys, arch):
    finished = quickstart.main(["--arch", arch, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert sorted(r.rid for r in finished) == list(range(6))
    assert all(len(r.generated) == 12 for r in finished)
    cfg = get_smoke_config(arch)
    assert out[0] == (f"arch={arch} (reduced: {cfg.n_layers}L "
                      f"d={cfg.d_model})")
    params = init_params(cfg, 0, torch.float32, "cpu")
    assert out[1] == f"params: {param_count(params):,}"
    assert len(out) == 2 + 6 + 1
    assert out[-1].startswith("72 tokens in ")
    assert out[-1].endswith(" tok/s on cpu)")
