"""Optical-flow warping and flow resizing (port of
``mrefsr_tpu/ops/warp.py::flow_warp`` and ``resize_flow``, the reference's
``arch_util.flow_warp`` and ``resize_flow``).

``flow_warp`` is ``F.grid_sample`` at the grid the reference builds: pixel
positions plus the flow, normalised to [-1, 1] by ``2 p / (size - 1) - 1``.
The JAX package samples at the pixel positions themselves; the round trip
through normalised coordinates moves a position by a few ulps, so the two
agree to about 1e-6 of the map's largest value, not bit for bit. Layouts
are the JAX package's: ``x`` (N, H, W, C), ``flow`` (N, H, W, 2) as
(dx, dy).
"""
import torch
import torch.nn.functional as F

from .resize import interpolate


def flow_warp(x, flow, interp_mode='bilinear', padding_mode='zeros',
              align_corners=True):
    """Sample NHWC ``x`` at ``(x, y) + flow``; ``padding_mode`` 'zeros'
    (outside is 0) or 'border' (outside is the nearest edge), as
    ``F.grid_sample``. Returns an NHWC view of the NCHW result."""
    n, h, w, _ = x.shape
    if flow.shape != (n, h, w, 2):
        raise ValueError(f'flow shape {tuple(flow.shape)} != {(n, h, w, 2)}')
    grid_y, grid_x = torch.meshgrid(
        torch.arange(h, dtype=x.dtype, device=x.device),
        torch.arange(w, dtype=x.dtype, device=x.device), indexing='ij')
    vgrid_x = 2.0 * (grid_x + flow[..., 0]) / max(w - 1, 1) - 1.0
    vgrid_y = 2.0 * (grid_y + flow[..., 1]) / max(h - 1, 1) - 1.0
    out = F.grid_sample(x.permute(0, 3, 1, 2),
                        torch.stack((vgrid_x, vgrid_y), dim=3),
                        mode=interp_mode, padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def resize_flow(flow, size_type, sizes, interp_mode='bilinear',
                align_corners=False):
    """Resize a flow field (N, H, W, 2) to ``sizes`` (``size_type``
    'shape') or by the ratios ``sizes`` ('ratio'), and scale its (dx, dy)
    by the width and height ratios."""
    n, flow_h, flow_w, _ = flow.shape
    if size_type == 'ratio':
        output_h, output_w = int(flow_h * sizes[0]), int(flow_w * sizes[1])
    elif size_type == 'shape':
        output_h, output_w = sizes[0], sizes[1]
    else:
        raise ValueError(f'Size type should be ratio or shape, '
                         f'but got type {size_type}.')
    scale = torch.tensor([output_w / flow_w, output_h / flow_h],
                         dtype=flow.dtype, device=flow.device)
    return interpolate(flow, size=(output_h, output_w), mode=interp_mode,
                       align_corners=align_corners) * scale
