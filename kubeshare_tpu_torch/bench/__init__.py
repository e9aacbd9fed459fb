"""Benchmarks of the port on the card: the co-location headline
(``python -m kubeshare_tpu_torch.bench.headline``)."""
