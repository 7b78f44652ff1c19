"""MATLAB-compatible BT.601 conversions between RGB / BGR and YCbCr on
numpy images (copy of ``mrefsr_tpu/utils/color_util.py``, reference
``basicsr/utils/color_util.py``): uint8 in gives rounded uint8 out, float32
in [0, 1] gives float32 in [0, 1]; and :func:`rgb2ycbcr_pt` on (n, 3, h,
w) tensors in [0, 1]."""
import numpy as np
import torch

# the MATLAB matrix on [0, 1] inputs, giving [0, 255]
_RGB2YCBCR_W = np.array([[65.481, -37.797, 112.0],
                         [128.553, -74.203, -93.786],
                         [24.966, 112.0, -18.214]])
_YCBCR_BIAS = np.array([16.0, 128.0, 128.0])


def _convert_input_type_range(img):
    """To float32 in [0, 1] (reference color_util.py:129-152)."""
    img_type = img.dtype
    img = img.astype(np.float32)
    if img_type == np.uint8:
        img /= 255.
    elif img_type != np.float32:
        raise TypeError('The img type should be np.float32 or np.uint8, '
                        f'but got {img_type}')
    return img


def _convert_output_type_range(img, dst_type):
    """From float32 in [0, 255] to ``dst_type`` (reference
    color_util.py:155-183)."""
    if dst_type not in (np.uint8, np.float32):
        raise TypeError('The dst_type should be np.float32 or np.uint8, '
                        f'but got {dst_type}')
    if dst_type == np.uint8:
        img = img.round()
    else:
        img /= 255.
    return img.astype(dst_type)


def _to_ycbcr(img, weights, y_only):
    img_type = img.dtype
    img = _convert_input_type_range(img)
    if y_only:
        out_img = np.dot(img, weights[:, 0]) + 16.0
    else:
        out_img = np.matmul(img, weights) + _YCBCR_BIAS
    return _convert_output_type_range(out_img, img_type)


def rgb2ycbcr(img, y_only=False):
    """RGB -> YCbCr (reference color_util.py:5-36)."""
    return _to_ycbcr(img, _RGB2YCBCR_W, y_only)


def bgr2ycbcr(img, y_only=False):
    """BGR -> YCbCr (reference color_util.py:39-70)."""
    return _to_ycbcr(img, _RGB2YCBCR_W[::-1], y_only)


# the MATLAB inverse on [0, 255] inputs (reference color_util.py:73-126)
_YCBCR2RGB_W = np.array([[0.00456621, 0.00456621, 0.00456621],
                         [0, -0.00153632, 0.00791071],
                         [0.00625893, -0.00318811, 0]])
_YCBCR2RGB_BIAS = np.array([-222.921, 135.576, -276.836])


def ycbcr2rgb(img):
    """YCbCr -> RGB (reference color_util.py:73-99)."""
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    out_img = np.matmul(img, _YCBCR2RGB_W) * 255.0 + _YCBCR2RGB_BIAS
    return _convert_output_type_range(out_img, img_type)


def ycbcr2bgr(img):
    """YCbCr -> BGR (reference color_util.py:102-126)."""
    img_type = img.dtype
    img = _convert_input_type_range(img) * 255
    out_img = np.matmul(img, _YCBCR2RGB_W[:, ::-1]) * 255.0 \
        + _YCBCR2RGB_BIAS[::-1]
    return _convert_output_type_range(out_img, img_type)


def rgb2ycbcr_pt(img, y_only=False):
    """RGB -> YCbCr on an (n, 3, h, w) tensor in [0, 1], giving (n, 3 or 1,
    h, w) in [0, 1] on its device and in its type (reference
    color_util.py:186-208)."""
    weight = torch.as_tensor(_RGB2YCBCR_W, dtype=img.dtype,
                             device=img.device)
    if y_only:
        out = torch.matmul(img.permute(0, 2, 3, 1), weight[:, :1]) + 16.0
    else:
        out = torch.matmul(img.permute(0, 2, 3, 1), weight) \
            + torch.as_tensor(_YCBCR_BIAS, dtype=img.dtype, device=img.device)
    return (out / 255.).permute(0, 3, 1, 2)
