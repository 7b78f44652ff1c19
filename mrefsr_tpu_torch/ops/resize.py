"""``F.interpolate`` at the JAX package's layout and size rule (port of
``mrefsr_tpu/ops/resize.py::interpolate``), and ``pixel_unshuffle`` (its
``pixel_unshuffle``) on NCHW tensors.

The output size is always ``int(h * scale_factor)`` (as the JAX package
computes it) and passed to ``F.interpolate`` as ``size=``: given a
``scale_factor``, torch maps source coordinates with that factor, the JAX
package with the ratio of the sizes, and the two differ where the size was
rounded. Bicubic is torch's kernel, A = -0.75, which the JAX package
rebuilds by hand. No antialiasing, as in the JAX package.

:func:`resize_matrix_np` and :func:`apply_resize_matrices` resize by
products with matrices built on the host (the degradation synthesis of
Real-ESRGAN, ``models/degradation_synth.py``).
"""
import numpy as np
import torch
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


# ------------------------------------------------------------------ #
# Resize as two products with host-built matrices (port of the JAX    #
# package's resize.py:107-168): the degradation synthesis resizes by  #
# a random scale each step onto a fixed canvas, so its shapes stay    #
# the same from step to step.                                         #
# ------------------------------------------------------------------ #

def _cubic_torch(t):
    """Torch's cubic convolution kernel, A = -0.75, on a numpy array."""
    a = -0.75
    at = np.abs(t)
    return np.where(
        at <= 1, ((a + 2) * at - (a + 3)) * at * at + 1,
        np.where(at < 2, (((at - 5) * at + 8) * at - 4) * a, 0.))


def _add_taps(m, src, taps):
    """Add ``_cubic_torch(src - (i0 + tap))`` (bicubic) or the two linear
    weights into ``m`` at the border-clamped columns, one tap after the
    other, so that an entry two clamped taps share sums them in the JAX
    package's order."""
    out_size, in_size = m.shape
    rows = np.arange(out_size)
    i0 = np.floor(src).astype(np.int64)
    for tap in taps:
        if taps == (0, 1):
            w = 1 - (src - i0) if tap == 0 else src - i0
        else:
            w = _cubic_torch(src - (i0 + tap))
        np.add.at(m, (rows, np.clip(i0 + tap, 0, in_size - 1)), w)
    return m


def _resize_matrix_ac_bicubic(in_size, out_size):
    """(out_size, in_size) torch bicubic ``align_corners=True`` matrix:
    ``src = dst * (in - 1) / (out - 1)``, A = -0.75, border clamp."""
    src = np.arange(out_size) * (in_size - 1) / max(out_size - 1, 1)
    return _add_taps(np.zeros((out_size, in_size), np.float32), src,
                     (-1, 0, 1, 2))


def resize_matrix_np(in_size, out_size, mode):
    """(out_size, in_size) float32 numpy matrix of torch's
    ``F.interpolate(mode=...)`` along one axis (``align_corners=False``):
    ``area`` is adaptive average pooling (integer bin edges), ``bilinear``
    and ``bicubic`` take half-pixel centres with border clamping. Equal bit
    for bit to the JAX package's loops."""
    m = np.zeros((out_size, in_size), np.float32)
    if mode == 'area':
        rows = np.arange(out_size)
        start = (rows * in_size) // out_size
        end = -((-(rows + 1) * in_size) // out_size)
        cols = np.arange(in_size)
        inside = (cols >= start[:, None]) & (cols < end[:, None])
        return np.where(inside, (1.0 / (end - start))[:, None], m) \
            .astype(np.float32)
    src = (np.arange(out_size) + 0.5) * in_size / out_size - 0.5
    if mode == 'bilinear':
        return _add_taps(m, src, (0, 1))
    if mode == 'bicubic':
        return _add_taps(m, src, (-1, 0, 1, 2))
    raise ValueError(f'Unknown resize mode {mode}')


def apply_resize_matrices(x, mat_h, mat_w):
    """Resize NHWC ``x`` with per-axis matrices: ``mat_h`` (Oh, H) and
    ``mat_w`` (Ow, W) -> (N, Oh, Ow, C)."""
    x = torch.einsum('oh,bhwc->bowc', mat_h, x)
    return torch.einsum('ow,bhwc->bhoc', mat_w, x)
