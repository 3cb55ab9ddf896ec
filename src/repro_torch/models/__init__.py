from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    DecodeCache,
    PagedDecodeState,
    PrefillCache,
    decode_loop_paged,
    decode_step,
    decode_step_paged,
    forward,
    init_params,
    param_count,
    prefill,
    prefill_chunk,
    prefill_paged,
)
