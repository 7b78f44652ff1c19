"""RealESRGANModel: ``SRGANModel`` trained on pairs degraded on the card
(port of ``mrefsr_tpu/models/realesrgan_model.py``, the reference's
basicsr/models/realesrgan_model.py:17-283).

In training with ``high_order_degradation`` (default true) ``feed_data``
degrades ``usm(gt)`` (whatever ``gt_usm`` says, as the reference does),
crops ``gt``, ``usm(gt)`` and ``lq`` alike, passes ``(lq, gt)`` through the
pool and sharpens the ``gt`` that comes out again: ``gt_usm``. Each term
takes the sharpened or the plain ``gt`` (:meth:`_train_step_inputs`):
``l1_gt_usm``, ``percep_gt_usm`` and ``gan_gt_usm`` (each default true)
for the pixel, perceptual and GAN terms, the plain one for LDL. The step is
``SRGANModel``'s, in f32. Otherwise, and in validation (without
synthesis), it takes ``lq`` / ``gt`` pairs, ``gt_usm`` sharpened from
``gt`` in training.
"""
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .realesrnet_model import SynthesisMixin
from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class RealESRGANModel(SynthesisMixin, SRGANModel):
    """``SRGANModel`` on pairs synthesised on the card (module
    docstring)."""

    def __init__(self, opt, device=None):
        self.gt_usm = None
        super().__init__(opt, device)
        self._init_synthesis()

    def feed_data(self, data):
        if not self.synthesizes():
            super().feed_data(data)
            self.gt_usm = self.synth.usm(self.gt) \
                if self.is_train and self.gt is not None else None
            return
        gt = self._tensor(data['gt'])
        gt_usm, lq = self.synth(gt, *self._kernels(data))
        self.lq, self.gt = self._crop_and_pool([gt, gt_usm], lq)
        self.gt_usm = self.synth.usm(self.gt)

    def _train_step_inputs(self):
        """The pixel, perceptual and GAN terms take ``gt_usm`` where their
        ``*_gt_usm`` option is true (the default), LDL the plain ``gt``
        (reference realesrgan_model.py:196-204)."""
        gt = self.gt
        usm = self.gt_usm if self.gt_usm is not None else gt
        pick = [usm if self.opt.get(key, True) else gt
                for key in ('l1_gt_usm', 'percep_gt_usm', 'gan_gt_usm')]
        return (self.lq, *pick, gt)
