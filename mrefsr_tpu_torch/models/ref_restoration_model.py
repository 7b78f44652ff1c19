"""Single-reference restoration model (port of
``mrefsr_tpu/models/ref_restoration_model.py``, the reference's
``basicsr/models/ref_restoration_model.py:21-375``).

The multi-ref model with one reference, ``img_ref`` (B, H, W, 3): it rides
as a T=1 stack, and three shape hooks adapt the extractor's call
(``ContrasExtractorSep`` takes one ref) and ``net_g``'s inputs
(``RestorationNet`` takes un-stacked dicts). Everything else is inherited:
the pixel step and its bf16 policy, the f32 GAN phase, save and resume,
sharded validation.
"""
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .multi_ref_restoration_model import MultiRefRestorationModel


@MODEL_REGISTRY.register()
class RefRestorationModel(MultiRefRestorationModel):
    """``MultiRefRestorationModel`` on samples with one ``img_ref``."""

    device_input_keys = ('img_in', 'img_in_lq', 'img_in_up', 'img_ref')

    def feed_data(self, data):
        self.img_in_lq = self._tensor(data['img_in_lq'])
        self.img_ref_list = self._tensor(data['img_ref'])[:, None]
        self.match_img_in = self._tensor(data['img_in_up'])
        self.gt = self._tensor(data['img_in']) if 'img_in' in data else None

    def _extract(self, dtype, match_img_in, refs):
        feats = self._run(self.net_extractor, dtype, True, match_img_in,
                          refs[:, 0])
        return feats['dense_features1'], feats['dense_features2'][:, None]

    def _net_g_ref_inputs(self, pre_offset, img_ref_feat):
        return ({k: v[:, 0] for k, v in pre_offset.items()},
                {k: v[:, 0] for k, v in img_ref_feat.items()})
