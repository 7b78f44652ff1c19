"""Multi-reference restoration model, eval half
(port of ``mrefsr_tpu/models/multi_ref_restoration_model.py``).

Three nets: the contrastive VGG16 extractor (``network_extractor``), the
correspondence generator (``network_map``: patch matching + VGG19 ref
features) and the MRAPA restoration net (``network_g``). A request goes
``feed_data`` -> ``test`` -> ``get_current_visuals`` with the JAX model's
sample dict: NHWC ``img_in_lq``, ``img_in_up``, ``img_in`` and
``img_ref_list`` of shape (B, T, H, W, 3).
"""
import os
from collections import OrderedDict

import torch

from mrefsr_tpu_torch.archs import build_network
from mrefsr_tpu_torch.archs.vgg_arch import vgg_rename
from mrefsr_tpu_torch.convert import (drop_buffer_keys, load_torch_state_dict,
                                      rename_keys, state_dict_from_flax)
from mrefsr_tpu_torch.utils import resolve_device
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class MultiRefRestorationModel:
    """Eval forward of the LMR multi-reference model.

    Weights come from ``path.pretrain_network_g``,
    ``path.pretrain_network_feature_extractor`` and
    ``path.vgg_pretrain_path`` where those files exist, from
    :meth:`load_from_flax`, and otherwise from ``manual_seed`` through a
    ``torch.Generator``. Runs on ``device`` (``cuda`` unless named).
    """

    def __init__(self, opt, device=None):
        self.opt = opt
        self.device = resolve_device(device)
        if opt.get('is_train'):
            raise NotImplementedError(
                'training is not ported yet (ROADMAP A4); build with '
                'is_train false')
        if (opt.get('val') or {}).get('mixed_precision'):
            raise NotImplementedError(
                'val.mixed_precision (bf16 serving) is not ported yet')
        # The eval path is f32, as the JAX package's default is. cuDNN
        # runs f32 convolutions in TF32 (about three decimal digits)
        # unless told otherwise, so both TF32 switches are set off here;
        # they are process-wide.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

        with torch.device('meta'):
            self.net_extractor = build_network(opt['network_extractor'])
            self.net_map = build_network(opt['network_map'])
            self.net_g = build_network(opt['network_g'])
        generator = torch.Generator().manual_seed(opt.get('manual_seed') or 0)
        for net in self._nets():
            net.to_empty(device=self.device)
            net.init_weights(generator)
            net.eval().requires_grad_(False)
        self._load_pretrained()
        self._to_channels_last()
        self.output = None

    def _nets(self):
        return self.net_extractor, self.net_map, self.net_g

    def _to_channels_last(self):
        for net in self._nets():
            net.to(memory_format=torch.channels_last)

    def _load_pretrained(self):
        path = self.opt.get('path') or {}
        strict = path.get('strict_load', True)
        file = path.get('pretrain_network_feature_extractor')
        if file and os.path.isfile(file):
            sd = rename_keys(load_torch_state_dict(file), drop_buffer_keys)
            self.net_extractor.load_state_dict(sd, strict=strict)
        file = path.get('vgg_pretrain_path')
        if file and os.path.isfile(file):
            rename = vgg_rename(self.net_map.vgg_type)

            def map_key(key):
                key = rename(key)
                return key and f'vgg.{key}'

            # torchvision's VGG goes deeper than the taps the map uses
            own = self.net_map.state_dict()
            sd = rename_keys(load_torch_state_dict(file, param_key=None),
                             map_key)
            self.net_map.load_state_dict(
                {k: v for k, v in sd.items() if k in own}, strict=True)
        file = path.get('pretrain_network_g')
        if file and os.path.isfile(file):
            self.net_g.load_state_dict(load_torch_state_dict(file),
                                       strict=strict)

    def load_from_flax(self, vars_ex, vars_map, vars_g):
        """Take the JAX package's flax variables of the three nets."""
        for net, variables in zip(self._nets(), (vars_ex, vars_map, vars_g)):
            net.load_state_dict(state_dict_from_flax(variables['params']),
                                strict=True)
        self._to_channels_last()

    def _tensor(self, value):
        return torch.as_tensor(value, dtype=torch.float32, device=self.device)

    def feed_data(self, data):
        self.img_in_lq = self._tensor(data['img_in_lq'])
        self.img_ref_list = self._tensor(data['img_ref_list'])
        self.match_img_in = self._tensor(data['img_in_up'])
        self.gt = self._tensor(data['img_in']) if 'img_in' in data else None

    def _forward(self, match_img_in, refs, lq):
        """NHWC in, NHWC out; the nets run NCHW in channels-last memory,
        which is what an NHWC tensor permuted to NCHW already is."""
        b, t = refs.shape[:2]
        refs = refs.permute(0, 1, 4, 2, 3)                # (B, T, 3, H, W)
        feats = self.net_extractor(match_img_in.permute(0, 3, 1, 2), refs)
        d1 = feats['dense_features1']
        d1 = d1.unsqueeze(1).expand(-1, t, -1, -1, -1).flatten(0, 1)
        pre_offset, img_ref_feat = self.net_map(
            {'dense_features1': d1,
             'dense_features2': feats['dense_features2'].flatten(0, 1)},
            refs.flatten(0, 1))
        pre_offset = {k: v.unflatten(0, (b, t)) for k, v in pre_offset.items()}
        img_ref_feat = {k: v.unflatten(0, (b, t))
                        for k, v in img_ref_feat.items()}
        out = self.net_g(lq.permute(0, 3, 1, 2), pre_offset, img_ref_feat)
        return out.permute(0, 2, 3, 1)

    def test(self):
        with torch.inference_mode():
            self.output = self._forward(self.match_img_in, self.img_ref_list,
                                        self.img_in_lq)

    def get_current_visuals(self):
        """``{'img_in_lq', 'rlt', 'gt'}`` as NHWC float32 numpy arrays."""
        out = OrderedDict()
        out['img_in_lq'] = self.img_in_lq.cpu().numpy()
        out['rlt'] = self.output.cpu().numpy()
        if self.gt is not None:
            out['gt'] = self.gt.cpu().numpy()
        return out
