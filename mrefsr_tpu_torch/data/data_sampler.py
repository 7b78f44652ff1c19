"""Rank-sharded, epoch-seeded, enlarge-ratio sampler (copy of
``mrefsr_tpu/data/data_sampler.py``; the reference's
``basicsr/data/data_sampler.py:6-48`` shuffles with ``torch.randperm``,
this one with numpy's ``default_rng(epoch)``, so the port draws the same
indices as the JAX package)."""
import math

import numpy as np


class EnlargedSampler:
    """Indices ``rank::num_replicas`` of a shuffle of the dataset made
    ``ratio`` times larger, so iteration-based training does not restart
    its loader every epoch. The shuffle depends on the epoch only
    (:meth:`set_epoch`)."""

    def __init__(self, dataset, num_replicas, rank, ratio=1):
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = math.ceil(len(dataset) * ratio / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def __iter__(self):
        rng = np.random.default_rng(self.epoch)
        indices = rng.permutation(self.total_size).tolist()
        dataset_size = len(self.dataset)
        indices = [v % dataset_size for v in indices]
        return iter(indices[self.rank:self.total_size:self.num_replicas])

    def __len__(self):
        return self.num_samples

    def set_epoch(self, epoch):
        self.epoch = epoch
