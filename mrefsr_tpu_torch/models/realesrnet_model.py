"""RealESRNetModel: ``SRModel`` trained on pairs degraded on the card
(port of ``mrefsr_tpu/models/realesrnet_model.py``, the reference's
basicsr/models/realesrnet_model.py:15-189).

In training with ``high_order_degradation`` (default true) ``feed_data``
takes a batch of ``RealESRGANDataset`` (``gt`` and the kernels ``kernel1``,
``kernel2``, ``sinc_kernel``): it sharpens ``gt`` where ``gt_usm: true``,
degrades that ``gt`` itself (``usm_source`` false) through
:class:`~.degradation_synth.DegradationSynthesizer`, crops ``gt_size``
(:func:`~.degradation_synth.paired_random_crop_device`) and passes the pair
through the pool (:class:`~.degradation_synth.TrainingPairPool`,
``queue_size``). The step is ``SRModel``'s, at ``train.mixed_precision``.
Otherwise, and in validation (which runs without synthesis), it takes
``lq`` / ``gt`` pairs as ``SRModel`` does. The synthesis, the crop and the
pool draw from generators seeded by ``manual_seed`` (plus the rank under
``opt['dist']``), on the model's device.

Under ``opt['dist']`` each rank synthesises its own ``batch_size_per_gpu``
samples and keeps its own pool of ``queue_size`` pairs, as the reference's
DDP run does (the JAX package keeps one pool over the batch of all its
devices); ``net_g`` trains in ``DistributedDataParallel`` as ``SRModel``'s
does, and rank 0 alone saves and validates.
"""
from mrefsr_tpu_torch.utils.dist_util import get_dist_info
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .degradation_synth import (DegradationSynthesizer, TrainingPairPool,
                                paired_random_crop_device)
from .sr_model import SRModel


class SynthesisMixin:
    """The synthesizer and the pool of the Real-ESR models, and validation
    without synthesis."""

    def _init_synthesis(self):
        rank = get_dist_info()[0] if self.opt.get('dist') else 0
        seed = (self.opt.get('manual_seed') or 0) + rank
        self.synth = DegradationSynthesizer(self.opt, self.device, seed)
        self.pool = TrainingPairPool(self.opt.get('queue_size', 180),
                                     self.synth.generator)

    def synthesizes(self):
        """Whether ``feed_data`` degrades its batch on the card."""
        return self.is_train and self.opt.get('high_order_degradation', True)

    def _kernels(self, data):
        return [self._tensor(data[k])
                for k in ('kernel1', 'kernel2', 'sinc_kernel')]

    def _crop_and_pool(self, gts, lq):
        """``gts`` (one batch or a list) and ``lq`` cropped alike, then
        ``(lq, gt)`` through the pool; ``gt`` is the first of ``gts``."""
        gts, lq = paired_random_crop_device(gts, lq, self.opt['gt_size'],
                                            self.opt['scale'],
                                            self.synth.generator)
        gt = gts[0] if isinstance(gts, list) else gts
        return self.pool(lq, gt)

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """``SRModel``'s validation on ``lq`` / ``gt`` pairs, without
        synthesis (reference realesrgan_model.py:188-192)."""
        is_train, self.is_train = self.is_train, False
        try:
            super().nondist_validation(dataloader, current_iter, tb_logger,
                                       save_img)
        finally:
            self.is_train = is_train


@MODEL_REGISTRY.register()
class RealESRNetModel(SynthesisMixin, SRModel):
    """``SRModel`` on pairs synthesised on the card (module docstring)."""

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        self._init_synthesis()

    def feed_data(self, data):
        if not self.synthesizes():
            super().feed_data(data)
            return
        gt = self._tensor(data['gt'])
        if self.opt['gt_usm'] is True:
            gt = self.synth.usm(gt)
        _, lq = self.synth(gt, *self._kernels(data), usm_source=False)
        self.lq, self.gt = self._crop_and_pool(gt, lq)
