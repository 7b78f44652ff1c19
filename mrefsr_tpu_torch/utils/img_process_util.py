"""Per-sample blur and unsharp masking on NHWC tensors (port of
``mrefsr_tpu/utils/img_process_util.py``, the reference's
basicsr/utils/img_process_util.py).

:func:`filter2D` correlates each sample with its own kernel as one grouped
``F.conv2d`` (a group per sample and channel) after reflect padding;
:class:`USMSharp` is the reference's unsharp mask with a 51 x 51 Gaussian,
two such convolutions a call; :func:`usm_sharp` is its host version on a
numpy image (OpenCV)."""
import numpy as np
import torch
import torch.nn.functional as F


def filter2D(img, kernel):
    """Correlate each sample of NHWC ``img`` (B, H, W, C) with its kernel,
    reflect-padded by ``k // 2``; ``kernel`` is (B, k, k) or (1, k, k), k
    odd. Returns (B, H, W, C)."""
    k = kernel.shape[-1]
    if k % 2 != 1:
        raise ValueError('Wrong kernel size')
    b, h, w, c = img.shape
    pad = k // 2
    x = F.pad(img.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode='reflect')
    weight = kernel.to(img.dtype).expand(b, k, k).repeat_interleave(c, 0)
    out = F.conv2d(x.reshape(1, b * c, h + 2 * pad, w + 2 * pad),
                   weight[:, None], groups=b * c)
    return out.view(b, c, h, w).permute(0, 2, 3, 1)


def usm_sharp(img, weight=0.5, radius=50, threshold=10):
    """Unsharp mask of an HWC BGR numpy image in [0, 1] on the host
    (reference img_process_util.py:34-60)."""
    import cv2
    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype('float32')
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


class USMSharp:
    """Unsharp masking of NHWC batches on their device (reference
    img_process_util.py:63-83): blur with a ``radius`` x ``radius``
    Gaussian (OpenCV's kernel for ``sigma``), sharpen by ``weight`` times
    the residual, and blend by the blurred mask of residuals over
    ``threshold`` / 255."""

    def __init__(self, radius=50, sigma=0):
        import cv2
        if radius % 2 == 0:
            radius += 1
        self.radius = radius
        kernel = cv2.getGaussianKernel(radius, sigma)
        self.kernel = torch.from_numpy(
            np.dot(kernel, kernel.transpose()).astype(np.float32))[None]
        self._on = {}

    def _kernel(self, device):
        if device not in self._on:
            self._on[device] = self.kernel.to(device)
        return self._on[device]

    def __call__(self, img, weight=0.5, threshold=10):
        kernel = self._kernel(img.device)
        blur = filter2D(img, kernel)
        residual = img - blur
        mask = (residual.abs() * 255 > threshold).to(img.dtype)
        soft_mask = filter2D(mask, kernel)
        sharp = torch.clamp(img + weight * residual, 0, 1)
        return soft_mask * sharp + (1 - soft_mask) * img
