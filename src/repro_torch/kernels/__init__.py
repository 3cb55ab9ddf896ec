"""Hand-written Hopper kernels (``csrc/*.cu``), their wrappers, their plain
PyTorch versions (``ref``) and the device dispatcher (``ops``)."""
