"""Small shared helpers of the port."""
import torch

from .img_util import (imfrombytes, img2tensor, imwrite, read_img_seq,
                       tensor2img)

__all__ = ['imfrombytes', 'img2tensor', 'imwrite', 'read_img_seq',
           'resolve_device', 'tensor2img']


def resolve_device(device=None):
    """The device an entry point runs on: the current CUDA device (the
    rank's, under ``init_dist``) unless the caller names another. With no
    CUDA device and no explicit choice this raises: the port never carries
    on on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" to run '
                'the plain PyTorch path on the CPU')
        device = 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    return device
