from repro_torch.data.pipeline import DataConfig, packed_batches  # noqa: F401
