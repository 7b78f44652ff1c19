"""LPIPS, the Learned Perceptual Image Patch Similarity, VGG variant (port of
``mrefsr_tpu/metrics/lpips.py``; richzhang/PerceptualSimilarity's
``LPIPS(net='vgg')``): the VGG16 taps relu1_2, relu2_2, relu3_3, relu4_3
and relu5_3 of both images, each unit-normalised over its channels, their
squared difference weighted by the learned 1x1 head ``lin{i}`` and summed
over the channels, averaged over the positions and summed over the taps.
The official scaling layer is the ImageNet normalisation of inputs in
[-1, 1] (``VGGFeatureExtractor(use_input_norm=True, range_norm=True)``).

Weights: the heads from the official ``vgg.pth`` (``lin{i}.model.1
.weight``, which are this module's names), the tower from a torchvision
``vgg16`` state dict, both local files (:func:`load_lpips_variables`).
"""
import numpy as np
import torch
from torch import nn

from mrefsr_tpu_torch.archs.vgg_arch import VGGFeatureExtractor
from mrefsr_tpu_torch.utils import resolve_device
from mrefsr_tpu_torch.utils.registry import METRIC_REGISTRY

LPIPS_VGG_LAYERS = ('relu1_2', 'relu2_2', 'relu3_3', 'relu4_3', 'relu5_3')
LPIPS_VGG_CHNS = (64, 128, 256, 512, 512)
_EPS = 1e-10


class NetLinLayer(nn.Module):
    """A tap's head: the official ``model`` (dropout, a bias-free 1x1 conv
    to one channel); only the conv's weight (1, C, 1, 1) is used."""

    def __init__(self, chn_in):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(chn_in, 1, 1, bias=False))


def _unit_normalize(feat):
    """Unit L2 norm over the channels, ``eps`` added to the norm."""
    return feat / (feat.pow(2).sum(1, keepdim=True).sqrt() + _EPS)


class LPIPSVgg(nn.Module):
    """The LPIPS distance of NCHW RGB images in [-1, 1]: ``(N,)``."""

    def __init__(self):
        super().__init__()
        self.vgg = VGGFeatureExtractor(layer_name_list=LPIPS_VGG_LAYERS,
                                       vgg_type='vgg16', use_input_norm=True,
                                       range_norm=True)
        for i, chns in enumerate(LPIPS_VGG_CHNS):
            setattr(self, f'lin{i}', NetLinLayer(chns))

    @torch.no_grad()
    def init_weights(self, generator):
        """The VGG tower's seeded stand-in (N(0, 1/fan_in)) and the heads
        at 1, the JAX package's initial value."""
        self.vgg.init_weights(generator)
        for i in range(len(LPIPS_VGG_LAYERS)):
            getattr(self, f'lin{i}').model[1].weight.fill_(1)

    def forward(self, x, y):
        fx, fy = self.vgg(x), self.vgg(y)
        total = 0.
        for i, layer in enumerate(LPIPS_VGG_LAYERS):
            diff = (_unit_normalize(fx[layer])
                    - _unit_normalize(fy[layer])) ** 2
            w = getattr(self, f'lin{i}').model[1].weight.view(1, -1, 1, 1)
            total = total + (diff * w).sum(1).mean((1, 2))
        return total


def load_lpips_variables(lpips_path, vgg16_path):
    """The state dict of :class:`LPIPSVgg` from the official LPIPS
    ``vgg.pth`` (the heads) and a torchvision ``vgg16`` state dict (the
    tower), both local paths."""
    from mrefsr_tpu_torch.archs.vgg_arch import vgg_rename
    from mrefsr_tpu_torch.convert import load_torch_state_dict, rename_keys
    trunk = rename_keys(load_torch_state_dict(vgg16_path, param_key=None),
                        vgg_rename('vgg16'))
    with torch.device('meta'):
        own = LPIPSVgg().state_dict()
    state = {f'vgg.{k}': v for k, v in trunk.items() if f'vgg.{k}' in own}
    heads = load_torch_state_dict(lpips_path, param_key=None)
    for i in range(len(LPIPS_VGG_LAYERS)):
        key = f'lin{i}.model.1.weight'
        state[key] = heads[key].float().reshape(1, -1, 1, 1)
    return state


def build_lpips(lpips_path=None, vgg16_path=None, device=None, seed=0):
    """:class:`LPIPSVgg` in eval mode on ``device`` (the card unless
    named): the official weights where both paths are given, else seeded
    stand-in weights from ``seed``."""
    device = resolve_device(device)
    with torch.device('meta'):
        net = LPIPSVgg()
    net.to_empty(device=device)
    net.init_weights(torch.Generator().manual_seed(seed))
    if lpips_path is not None and vgg16_path is not None:
        net.load_state_dict(load_lpips_variables(lpips_path, vgg16_path),
                            strict=True)
    return net.eval().requires_grad_(False)


_NETS = {}


@METRIC_REGISTRY.register()
def calculate_lpips(img, img2, crop_border=0, input_order='HWC',
                    lpips_weights=None, vgg16_weights=None, device=None,
                    **kwargs):
    """LPIPS between two BGR images in [0, 255] (lower is better): RGB,
    ``crop_border`` pixels off each side, mapped to [-1, 1] as the
    reference wrapper does (scripts/metrics/calculate_lpips.py:25-47).
    ``lpips_weights`` (the official ``vgg.pth``) and ``vgg16_weights``
    (torchvision's ``vgg16``) are local paths; the net runs on ``device``
    (the card unless named)."""
    from .metric_util import reorder_image
    if lpips_weights is None or vgg16_weights is None:
        raise ValueError(
            'calculate_lpips needs lpips_weights (official LPIPS vgg.pth) '
            'and vgg16_weights (torchvision vgg16 state dict) paths: the '
            'port downloads nothing.')
    assert img.shape == img2.shape, (
        f'Image shapes are different: {img.shape}, {img2.shape}.')
    imgs = []
    for one in (img, img2):
        one = reorder_image(one, input_order=input_order).astype(
            np.float32)[..., ::-1]
        if crop_border != 0:
            one = one[crop_border:-crop_border, crop_border:-crop_border]
        imgs.append(one)
    device = resolve_device(device)
    key = (lpips_weights, vgg16_weights, str(device))
    if key not in _NETS:
        _NETS[key] = build_lpips(lpips_weights, vgg16_weights, device)
    net = _NETS[key]
    x, y = (torch.from_numpy(np.ascontiguousarray(one / 255. * 2. - 1.))
            .float().permute(2, 0, 1)[None].to(device) for one in imgs)
    with torch.inference_mode():
        return float(net(x, y)[0])
