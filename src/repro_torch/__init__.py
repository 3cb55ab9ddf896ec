"""PyTorch/CUDA port of the serving system (the JAX package ``repro`` is
the reference and is never imported here)."""
from repro_torch.configs import get_config, get_smoke_config  # noqa: F401
from repro_torch.models.model import init_params  # noqa: F401
from repro_torch.serving.engine import ServingEngine  # noqa: F401
