"""Command-line entry points (port of ``kubeshare_tpu/cmd``): the training
workload (``python -m kubeshare_tpu_torch.cmd.workload``), the node's
daemons (``nodeconfig``, ``collector``, ``launcher``) and the admission
webhook (``webhook``)."""
