"""The paper's evaluation on the port: twins of the analytic benchmarks of
the top-level ``benchmarks`` package, with its file names
(``python -m repro_torch.benchmarks.run``)."""
