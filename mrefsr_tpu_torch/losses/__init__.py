"""Losses of the port (port of ``mrefsr_tpu/losses``). The multi-ref
models fetch theirs by name from :mod:`.legacy_losses`."""
from .losses import L1Loss, MSELoss

__all__ = ['L1Loss', 'MSELoss']
