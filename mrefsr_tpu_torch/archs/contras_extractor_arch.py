"""Contrastively trained VGG16-conv3_1 feature extractors, single- and
multi-ref forms (port of ``mrefsr_tpu/archs/contras_extractor_arch.py``)."""
from torch import nn

from mrefsr_tpu_torch.utils.registry import ARCH_REGISTRY

from .vgg_arch import VGGTower, imagenet_normalize


class ContrasExtractorLayer(nn.Module):
    """VGG16 up to conv3_1 inclusive, the pre-relu tap, on an
    ImageNet-normalised NCHW image (reference
    contras_extractor_arch.py:10-43). Child named ``model`` to match the
    reference state dict."""

    def __init__(self):
        super().__init__()
        self.model = VGGTower('vgg16', tap_layers=('conv3_1',),
                              last_layer='conv3_1')

    def forward(self, x):
        return self.model(imagenet_normalize(x))['conv3_1']


@ARCH_REGISTRY.register()
class ContrasExtractorSep(nn.Module):
    """Separate towers for the upsampled input and one ref (reference
    contras_extractor_arch.py:47-62): ``(image1, image2)``, each
    (B, 3, H, W), -> ``{'dense_features1', 'dense_features2'}``, each
    (B, 256, h, w)."""

    def __init__(self):
        super().__init__()
        self.feature_extraction_image1 = ContrasExtractorLayer()
        self.feature_extraction_image2 = ContrasExtractorLayer()

    def forward(self, image1, image2):
        return {'dense_features1': self.feature_extraction_image1(image1),
                'dense_features2': self.feature_extraction_image2(image2)}

    def init_weights(self, generator):
        self.feature_extraction_image1.model.init_weights(generator)
        self.feature_extraction_image2.model.init_weights(generator)


@ARCH_REGISTRY.register()
class ContrasMultiExtractorSep(nn.Module):
    """Separate towers for the upsampled input and the refs, with the T
    refs folded into the batch (reference
    contras_multi_extractor_arch.py:47-64).

    Args:
        image1: (B, 3, H, W) upsampled LR input.
        image_refs: (B, T, 3, H, W) stacked refs.

    Returns:
        ``{'dense_features1': (B, 256, h, w),
        'dense_features2': (B, T, 256, h, w)}``
    """

    def __init__(self):
        super().__init__()
        self.feature_extraction_image1 = ContrasExtractorLayer()
        self.feature_extraction_image2 = ContrasExtractorLayer()

    def forward(self, image1, image_refs):
        b, t = image_refs.shape[:2]
        feats = self.feature_extraction_image2(image_refs.flatten(0, 1))
        return {'dense_features1': self.feature_extraction_image1(image1),
                'dense_features2': feats.unflatten(0, (b, t))}

    def init_weights(self, generator):
        self.feature_extraction_image1.model.init_weights(generator)
        self.feature_extraction_image2.model.init_weights(generator)
