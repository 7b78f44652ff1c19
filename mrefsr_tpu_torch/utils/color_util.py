"""MATLAB-compatible BT.601 RGB/BGR -> YCbCr on numpy images (copy of
``mrefsr_tpu/utils/color_util.py:17-65``, reference
``basicsr/utils/color_util.py``): uint8 in gives rounded uint8 out, float32
in [0, 1] gives float32 in [0, 1]."""
import numpy as np

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
