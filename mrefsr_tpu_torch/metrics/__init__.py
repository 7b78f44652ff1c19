"""Image quality metrics of the port (port of ``mrefsr_tpu/metrics``):
PSNR and SSIM on BGR uint8 images (numpy) and their batched versions on
NHWC tensors (``*_pt``), dispatched by a YAML's ``type:`` through
:func:`calculate_metric`. NIQE, FID and LPIPS wait for ROADMAP A12."""
from copy import deepcopy

from mrefsr_tpu_torch.utils.registry import METRIC_REGISTRY

from .psnr_ssim import (calculate_psnr, calculate_psnr_pt, calculate_ssim,
                        calculate_ssim_pt)

__all__ = ['calculate_metric', 'calculate_psnr', 'calculate_psnr_pt',
           'calculate_ssim', 'calculate_ssim_pt']


def calculate_metric(data, opt):
    """The metric ``opt['type']`` names, called on ``data`` (``img``,
    ``img2``) with the rest of ``opt`` as keyword arguments (reference
    metrics/__init__.py:10-20)."""
    opt = deepcopy(opt)
    return METRIC_REGISTRY.get(opt.pop('type'))(**data, **opt)
