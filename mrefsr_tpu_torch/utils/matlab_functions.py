"""MATLAB's ``imresize`` with the cubic kernel and antialiasing, in numpy
(copy of ``mrefsr_tpu/utils/matlab_functions.py:13-120``, the reference's
basicsr/utils/matlab_functions.py:6-178). Each axis is one gather and one
contraction; NIQE is its one user."""
import math

import numpy as np


def cubic(x):
    """Keys' cubic kernel, a = -0.5 (reference matlab_functions.py:6-13)."""
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
            + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
            * ((absx > 1) & (absx <= 2)))


def calculate_weights_indices(in_length, out_length, scale, kernel,
                              kernel_width, antialiasing):
    """Each output pixel's weights and its source indices into the
    symmetrically extended axis (reference matlab_functions.py:16-83):
    MATLAB's half-pixel mapping, the kernel widened by ``1 / scale`` when
    antialiasing a reduction, all-zero first or last columns trimmed.
    Returns ``(weights (out, p) f32, indices (out, p), sym_len_start,
    sym_len_end)``."""
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = math.ceil(kernel_width) + 2
    indices = left[:, None] + np.arange(p)[None, :]
    distance_to_center = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * cubic(distance_to_center * scale)
    else:
        weights = cubic(distance_to_center)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    weights_zero_tmp = np.sum(weights == 0, axis=0)
    if not math.isclose(weights_zero_tmp[0], 0, rel_tol=1e-6):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    if not math.isclose(weights_zero_tmp[-1], 0, rel_tol=1e-6):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]
    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_length)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return weights.astype(np.float32), indices, sym_len_s, sym_len_e


def _resize_axis0(img, weights, indices, sym_len_s, sym_len_e):
    """Axis 0 of ``img`` mirrored at both ends (the reference's
    ``index_select`` flips, matlab_functions.py:131-141), then each output
    row the weighted sum of its source rows."""
    head = img[:sym_len_s][::-1]
    tail = img[img.shape[0] - sym_len_e:][::-1]
    img_aug = np.concatenate([head, img, tail], axis=0)
    return np.einsum('op,opwc->owc', weights, img_aug[indices],
                     optimize=True)


def imresize(img, scale, antialiasing=True):
    """MATLAB's bicubic ``imresize`` of an HWC (or HW) numpy image in [0, 1]
    by ``scale`` on both axes: ``ceil(h * scale)`` x ``ceil(w * scale)``,
    float32, not rounded (the reference's contract, matlab_functions.py:
    86-178)."""
    squeeze = img.ndim == 2
    img = np.asarray(img, dtype=np.float32)
    if squeeze:
        img = img[:, :, None]
    in_h, in_w = img.shape[:2]
    out_h, out_w = math.ceil(in_h * scale), math.ceil(in_w * scale)
    out = img
    for length, out_len in ((in_h, out_h), (in_w, out_w)):
        out = _resize_axis0(out, *calculate_weights_indices(
            length, out_len, scale, 'cubic', 4, antialiasing))
        out = out.transpose(1, 0, 2)
    return (out[:, :, 0] if squeeze else out).astype(np.float32)
