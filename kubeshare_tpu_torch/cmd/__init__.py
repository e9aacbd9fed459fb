"""Command-line entry points (port of ``kubeshare_tpu/cmd``): so far the
training workload, ``python -m kubeshare_tpu_torch.cmd.workload``."""
