"""VGG feature extractor with named-layer taps
(port of ``mrefsr_tpu/archs/vgg_arch.py``). NCHW in, dict of NCHW out."""
import math

import torch
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .arch_util import normal_

# standard VGG layer-name rosters (reference vgg_arch.py:10-33)
NAMES = {
    'vgg11': [
        'conv1_1', 'relu1_1', 'pool1', 'conv2_1', 'relu2_1', 'pool2',
        'conv3_1', 'relu3_1', 'conv3_2', 'relu3_2', 'pool3', 'conv4_1',
        'relu4_1', 'conv4_2', 'relu4_2', 'pool4', 'conv5_1', 'relu5_1',
        'conv5_2', 'relu5_2', 'pool5'
    ],
    'vgg13': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'pool3', 'conv4_1', 'relu4_1', 'conv4_2',
        'relu4_2', 'pool4', 'conv5_1', 'relu5_1', 'conv5_2', 'relu5_2',
        'pool5'
    ],
    'vgg16': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'conv3_3', 'relu3_3', 'pool3', 'conv4_1',
        'relu4_1', 'conv4_2', 'relu4_2', 'conv4_3', 'relu4_3', 'pool4',
        'conv5_1', 'relu5_1', 'conv5_2', 'relu5_2', 'conv5_3', 'relu5_3',
        'pool5'
    ],
    'vgg19': [
        'conv1_1', 'relu1_1', 'conv1_2', 'relu1_2', 'pool1', 'conv2_1',
        'relu2_1', 'conv2_2', 'relu2_2', 'pool2', 'conv3_1', 'relu3_1',
        'conv3_2', 'relu3_2', 'conv3_3', 'relu3_3', 'conv3_4', 'relu3_4',
        'pool3', 'conv4_1', 'relu4_1', 'conv4_2', 'relu4_2', 'conv4_3',
        'relu4_3', 'conv4_4', 'relu4_4', 'pool4', 'conv5_1', 'relu5_1',
        'conv5_2', 'relu5_2', 'conv5_3', 'relu5_3', 'conv5_4', 'relu5_4',
        'pool5'
    ]
}

# ImageNet normalization for [0,1] inputs
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_WIDTHS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}


def imagenet_normalize(x):
    """``(x - mean) / std`` over the channels of an NCHW image."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype,
                        device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype,
                       device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


class VGGTower(nn.Module):
    """Sequential VGG body up to ``last_layer``, returning the activations
    at ``tap_layers``. Conv children carry the VGG layer names, so
    reference checkpoints map directly."""

    def __init__(self, vgg_type='vgg19', tap_layers=(), last_layer='pool5',
                 remove_pooling=False, pooling_stride=2):
        super().__init__()
        names = NAMES[vgg_type]
        self.names = names[:names.index(last_layer) + 1]
        self.tap_layers = tuple(tap_layers)
        self.remove_pooling = remove_pooling
        self.pooling_stride = pooling_stride
        in_ch = 3
        for name in self.names:
            if name.startswith('conv'):
                out_ch = _WIDTHS[int(name[4])]
                self.add_module(name, nn.Conv2d(in_ch, out_ch, 3, 1, 1))
                in_ch = out_ch

    def forward(self, x):
        out = {}
        for name in self.names:
            if name.startswith('conv'):
                x = getattr(self, name)(x)
            elif name.startswith('relu'):
                x = torch.relu(x)
            elif not self.remove_pooling:  # pool, floor mode
                x = nn.functional.max_pool2d(x, 2, self.pooling_stride)
            if name in self.tap_layers:
                out[name] = x
        return out

    @torch.no_grad()
    def init_weights(self, generator):
        """N(0, 1/fan_in) convs, zero biases (a seeded stand-in for the
        pretrained VGG)."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight.shape[1] * m.weight.shape[2] \
                    * m.weight.shape[3]
                normal_(m.weight, 1 / math.sqrt(fan_in), generator)
                m.bias.zero_()


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    """Named-tap VGG feature extractor (reference vgg_arch.py:55-161).
    NCHW input in [0, 1] (or [-1, 1] with ``range_norm``); returns
    ``{layer_name: NCHW activation}``."""

    def __init__(self, layer_name_list, vgg_type='vgg19',
                 use_input_norm=True, range_norm=False, requires_grad=False,
                 remove_pooling=False, pooling_stride=2):
        super().__init__()
        self.vgg_type = vgg_type
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = NAMES[vgg_type]
        last = max(layer_name_list, key=names.index)
        self.vgg_net = VGGTower(vgg_type, layer_name_list, last,
                                remove_pooling, pooling_stride)
        self.requires_grad_(requires_grad)

    def forward(self, x):
        if self.range_norm:
            x = (x + 1) / 2
        if self.use_input_norm:
            x = imagenet_normalize(x)
        return self.vgg_net(x)

    def init_weights(self, generator):
        self.vgg_net.init_weights(generator)


def vgg_rename(vgg_type='vgg19'):
    """Rename raw torchvision VGG keys (``features.<idx>.*``) to the
    reference layout (``vgg_net.<layer_name>.*``)."""
    idx_to_name = dict(enumerate(NAMES[vgg_type]))

    def rename(key):
        if key.startswith('classifier.'):
            return None
        if key.startswith('features.'):
            parts = key.split('.')
            name = idx_to_name.get(int(parts[1]))
            if name is None or not name.startswith('conv'):
                return None
            return 'vgg_net.' + name + '.' + parts[2]
        return key

    return rename
