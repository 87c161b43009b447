"""Command-line entry points of the port (``python -m
modaltune_tpu_torch.tools.train``)."""
