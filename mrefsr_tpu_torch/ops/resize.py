"""``F.interpolate`` at the JAX package's layout and size rule (port of
``mrefsr_tpu/ops/resize.py::interpolate``), and ``pixel_unshuffle`` (its
``pixel_unshuffle``) on NCHW tensors.

The output size is always ``int(h * scale_factor)`` (as the JAX package
computes it) and passed to ``F.interpolate`` as ``size=``: given a
``scale_factor``, torch maps source coordinates with that factor, the JAX
package with the ratio of the sizes, and the two differ where the size was
rounded. Bicubic is torch's kernel, A = -0.75, which the JAX package
rebuilds by hand. No antialiasing, as in the JAX package.
"""
import torch.nn.functional as F


def interpolate(x, scale_factor=None, size=None, mode='bilinear',
                align_corners=False):
    """Resize NHWC ``x`` (N, H, W, C) to ``size`` or by ``scale_factor``
    with ``mode`` 'nearest', 'bilinear' or 'bicubic'; returns an NHWC view
    of the NCHW result."""
    n, h, w, c = x.shape
    if size is None:
        size = (int(h * scale_factor), int(w * scale_factor))
    kwargs = {} if mode == 'nearest' else {'align_corners': align_corners}
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode=mode,
                        **kwargs)
    return out.permute(0, 2, 3, 1)


def pixel_unshuffle(x, scale):
    """Fold each ``scale`` x ``scale`` block of NCHW ``x`` into channels:
    (N, C, H, W) -> (N, C * scale^2, H / scale, W / scale), output channel
    ``c * scale^2 + i * scale + j`` taking pixel (i, j) of channel ``c``'s
    blocks (reference arch_util.py:272-289, the JAX package's
    ``pixel_unshuffle`` on NHWC)."""
    return F.pixel_unshuffle(x, scale)
