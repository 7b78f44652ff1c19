"""Converters of published checkpoints into the port's key layout (port of
``scripts/model_conversion``), each runnable as ``python -m
mrefsr_tpu_torch.model_conversion.<name>``."""
