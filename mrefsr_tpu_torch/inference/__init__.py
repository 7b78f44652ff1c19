"""Command-line entry points of the port, run as
``python -m mrefsr_tpu_torch.inference.<name>``."""
