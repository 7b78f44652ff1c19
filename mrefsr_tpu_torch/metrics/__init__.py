"""Image quality metrics of the port (port of ``mrefsr_tpu/metrics``):
PSNR and SSIM on BGR uint8 images (numpy) and their batched versions on
NHWC tensors (``*_pt``); NIQE (numpy, the pristine model from the
package's own data file); FID (the Inception features on the device, the
distance in scipy); LPIPS (VGG16 on the device). Each ``calculate_*``
dispatches by a YAML's ``type:`` through :func:`calculate_metric`."""
from copy import deepcopy

from mrefsr_tpu_torch.utils.registry import METRIC_REGISTRY

from .fid import (calculate_fid, extract_inception_features,
                  load_patched_inception_v3)
from .lpips import LPIPSVgg, calculate_lpips, load_lpips_variables
from .niqe import calculate_niqe
from .psnr_ssim import (calculate_psnr, calculate_psnr_pt, calculate_ssim,
                        calculate_ssim_pt)

__all__ = ['LPIPSVgg', 'calculate_fid', 'calculate_lpips', 'calculate_metric',
           'calculate_niqe', 'calculate_psnr', 'calculate_psnr_pt',
           'calculate_ssim', 'calculate_ssim_pt',
           'extract_inception_features', 'load_lpips_variables',
           'load_patched_inception_v3']


def calculate_metric(data, opt):
    """The metric ``opt['type']`` names, called on ``data`` (``img``,
    ``img2``; FID's ``mu1``, ``sigma1``, ``mu2``, ``sigma2``) with the rest
    of ``opt`` as keyword arguments (reference metrics/__init__.py:10-20)."""
    opt = deepcopy(opt)
    return METRIC_REGISTRY.get(opt.pop('type'))(**data, **opt)
