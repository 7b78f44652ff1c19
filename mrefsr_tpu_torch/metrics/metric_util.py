"""Metric helpers (copy of ``mrefsr_tpu/metrics/metric_util.py``,
reference ``basicsr/metrics/metric_util.py:6-45``)."""
import numpy as np

from mrefsr_tpu_torch.utils.color_util import bgr2ycbcr


def reorder_image(img, input_order='HWC'):
    """``img`` as HWC; a 2-D image gets a channel axis."""
    if input_order not in ('HWC', 'CHW'):
        raise ValueError(f"Wrong input_order {input_order}. Supported "
                         "input_orders are 'HWC' and 'CHW'")
    if img.ndim == 2:
        img = img[..., None]
    if input_order == 'CHW':
        img = img.transpose(1, 2, 0)
    return img


def to_y_channel(img):
    """BGR in [0, 255] -> the Y channel in [0, 255], float32, not
    rounded."""
    img = img.astype(np.float32) / 255.
    if img.ndim == 3 and img.shape[2] == 3:
        img = bgr2ycbcr(img, y_only=True)[..., None]
    return img * 255.
