"""Data helpers of the port: the rank-sharded sampler and batch
collation (numpy only; copies of the JAX package's)."""
from .data_sampler import EnlargedSampler
from .loader import default_collate

__all__ = ['EnlargedSampler', 'default_collate']
