"""SwinIRModel and SwinIRGANModel (port of
``mrefsr_tpu/models/swinir_model.py``, the reference's
basicsr/models/swinir_model.py:10-39): ``SRModel`` and ``ESRGANModel``
whose ``test`` reflect-pads ``lq`` at the bottom and right to a multiple
of ``network_g.window_size`` and crops the output back by ``scale``. The
eval forward is ``SRModel``'s: the EMA net where ``train.ema_decay`` > 0,
in ``val.mixed_precision``'s dtype. Training is the parents'."""
import torch.nn.functional as F

from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .esrgan_model import ESRGANModel
from .sr_model import SRModel


class SwinIRTestMixin:

    def test(self):
        window_size = self.opt['network_g']['window_size']
        scale = self.opt.get('scale', 1)
        h, w = self.lq.shape[1:3]
        pad_h, pad_w = (-h) % window_size, (-w) % window_size
        lq = self.lq
        if pad_h or pad_w:
            lq = F.pad(lq.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                       mode='reflect').permute(0, 2, 3, 1)
        self.output = self.eval_forward(lq)[:, :h * scale, :w * scale]


@MODEL_REGISTRY.register()
class SwinIRModel(SwinIRTestMixin, SRModel):
    """``SRModel`` with the window-padded test."""


@MODEL_REGISTRY.register()
class SwinIRGANModel(SwinIRTestMixin, ESRGANModel):
    """``ESRGANModel`` with the window-padded test."""
