"""Data parallelism over ``torch.distributed`` (the counterpart of
``mrefsr_tpu/parallel``)."""
from .ddp import all_reduce_mean, data_parallel

__all__ = ['all_reduce_mean', 'data_parallel']
