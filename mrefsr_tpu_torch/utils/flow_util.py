"""Optical-flow files (port of ``mrefsr_tpu/utils/flow_util.py``, the
reference's basicsr/utils/flow_util.py:7-170): the Middlebury ``.flo``
format (a ``PIEH`` header, width and height as int32, then float32 (dx,
dy) pairs) and the quantized form, dx and dy as two uint8 images
concatenated into one. numpy on the host; OpenCV is imported where an
image is read or written."""
import os

import numpy as np


def flowread(flow_path, quantize=False, concat_axis=0, *args, **kwargs):
    """An (h, w, 2) float32 flow from a ``.flo`` file, or with
    ``quantize`` from a quantized image whose halves along ``concat_axis``
    are dx and dy (``*args`` and ``**kwargs`` go to
    :func:`dequantize_flow`)."""
    if quantize:
        import cv2
        if concat_axis not in (0, 1):
            raise ValueError(f'concat_axis is 0 or 1, got {concat_axis}')
        cat_flow = cv2.imread(flow_path, cv2.IMREAD_UNCHANGED)
        if cat_flow.ndim != 2:
            raise IOError(f'{flow_path} is not a valid quantized flow file, '
                          f'its dimension is {cat_flow.ndim}.')
        if cat_flow.shape[concat_axis] % 2:
            raise IOError(f'{flow_path} has an odd extent along axis '
                          f'{concat_axis}')
        dx, dy = np.split(cat_flow, 2, axis=concat_axis)
        flow = dequantize_flow(dx, dy, *args, **kwargs)
    else:
        with open(flow_path, 'rb') as f:
            try:
                header = f.read(4).decode('utf-8')
            except UnicodeDecodeError:
                raise IOError(f'Invalid flow file: {flow_path}')
            if header != 'PIEH':
                raise IOError(f'Invalid flow file: {flow_path}, header does '
                              'not contain PIEH')
            w = int(np.fromfile(f, np.int32, 1).squeeze())
            h = int(np.fromfile(f, np.int32, 1).squeeze())
            flow = np.fromfile(f, np.float32, w * h * 2).reshape((h, w, 2))
    return flow.astype(np.float32)


def flowwrite(flow, filename, quantize=False, concat_axis=0, *args,
              **kwargs):
    """``flow`` (h, w, 2) to ``filename``: a ``.flo`` file, or with
    ``quantize`` the uint8 dx and dy of :func:`quantize_flow` concatenated
    along ``concat_axis`` into one image."""
    if not quantize:
        with open(filename, 'wb') as f:
            f.write('PIEH'.encode('utf-8'))
            np.array([flow.shape[1], flow.shape[0]], np.int32).tofile(f)
            flow.astype(np.float32).tofile(f)
        return
    import cv2
    if concat_axis not in (0, 1):
        raise ValueError(f'concat_axis is 0 or 1, got {concat_axis}')
    dx, dy = quantize_flow(flow, *args, **kwargs)
    os.makedirs(os.path.dirname(filename), exist_ok=True)
    cv2.imwrite(filename, np.concatenate((dx, dy), axis=concat_axis))


def quantize_flow(flow, max_val=0.02, norm=True):
    """dx and dy of ``flow`` as uint8 images over [-max_val, max_val],
    divided by the width and height first where ``norm``; 255 levels, so
    that 0 survives the round trip."""
    h, w, _ = flow.shape
    dx, dy = flow[..., 0], flow[..., 1]
    if norm:
        dx = dx / w
        dy = dy / h
    return tuple(quantize(d, -max_val, max_val, 255, np.uint8)
                 for d in (dx, dy))


def dequantize_flow(dx, dy, max_val=0.02, denorm=True):
    """The (h, w, 2) flow of :func:`quantize_flow`'s ``dx`` and ``dy``,
    times the width and height where ``denorm``."""
    if dx.shape != dy.shape:
        raise ValueError(f'dx {dx.shape} and dy {dy.shape} differ')
    if not (dx.ndim == 2 or (dx.ndim == 3 and dx.shape[-1] == 1)):
        raise ValueError(f'dx is (h, w) or (h, w, 1), got {dx.shape}')
    dx, dy = (dequantize(d, -max_val, max_val, 255) for d in (dx, dy))
    if denorm:
        dx *= dx.shape[1]
        dy *= dx.shape[0]
    return np.dstack((dx, dy))


def _check_levels(min_val, max_val, levels):
    if not (isinstance(levels, int) and levels > 1):
        raise ValueError(f'levels must be a positive integer, but got '
                         f'{levels}')
    if min_val >= max_val:
        raise ValueError(f'min_val ({min_val}) must be smaller than max_val '
                         f'({max_val})')


def quantize(arr, min_val, max_val, levels, dtype=np.int64):
    """``arr`` clipped to [min_val, max_val] as integers in [0, levels - 1]
    of ``dtype``."""
    _check_levels(min_val, max_val, levels)
    arr = np.clip(arr, min_val, max_val) - min_val
    return np.minimum(np.floor(levels * arr / (max_val - min_val))
                      .astype(dtype), levels - 1)


def dequantize(arr, min_val, max_val, levels, dtype=np.float64):
    """The centres of :func:`quantize`'s levels ``arr`` in ``dtype``."""
    _check_levels(min_val, max_val, levels)
    return (arr + 0.5).astype(dtype) * (max_val - min_val) / levels + min_val
