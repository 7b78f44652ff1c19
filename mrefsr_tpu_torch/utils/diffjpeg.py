"""JPEG compression and decompression of NHWC batches (port of
``mrefsr_tpu/utils/diffjpeg.py``, the reference's
basicsr/utils/diffjpeg.py): RGB -> YCbCr, 2 x 2 chroma mean, 8 x 8 DCT as
one product with a (64, 64) basis, quantisation by the luma and chroma
tables scaled by each sample's quality, rounding (``torch.round``, or the
differentiable ``round(x) + (x - round(x)) ** 3``), then the inverse.
Heights and widths are zero-padded to a multiple of 16 and cropped back."""
import itertools

import numpy as np
import torch

# luma / chroma quantisation tables (reference diffjpeg.py:14-24, which
# stores both transposed)
Y_TABLE = np.array(
    [[16, 11, 10, 16, 24, 40, 51, 61], [12, 12, 14, 19, 26, 58, 60, 55],
     [14, 13, 16, 24, 40, 57, 69, 56], [14, 17, 22, 29, 51, 87, 80, 62],
     [18, 22, 37, 56, 68, 109, 103, 77], [24, 35, 55, 64, 81, 104, 113, 92],
     [49, 64, 78, 87, 103, 121, 120, 101],
     [72, 92, 95, 98, 112, 100, 103, 99]], dtype=np.float32).T
C_TABLE = np.full((8, 8), 99, dtype=np.float32)
C_TABLE[:4, :4] = np.array([[17, 18, 24, 47], [18, 21, 26, 66],
                            [24, 26, 56, 99], [47, 66, 99, 99]]).T

_DCT = np.zeros((8, 8, 8, 8), dtype=np.float32)
for _x, _y, _u, _v in itertools.product(range(8), repeat=4):
    _DCT[_x, _y, _u, _v] = (np.cos((2 * _x + 1) * _u * np.pi / 16)
                            * np.cos((2 * _y + 1) * _v * np.pi / 16))
_ALPHA = np.outer(np.array([1. / np.sqrt(2)] + [1] * 7),
                  np.array([1. / np.sqrt(2)] + [1] * 7)).astype(np.float32)
_RGB2YCBCR = np.array([[0.299, 0.587, 0.114], [-0.168736, -0.331264, 0.5],
                       [0.5, -0.418688, -0.081312]], dtype=np.float32).T
_YCBCR2RGB = np.array([[1., 0., 1.402], [1, -0.344136, -0.714136],
                       [1, 1.772, 0]], dtype=np.float32).T
_CONSTANTS = {'y_table': Y_TABLE, 'c_table': C_TABLE,
              'dct': _DCT.reshape(64, 64), 'alpha': _ALPHA,
              'rgb2ycbcr': _RGB2YCBCR, 'ycbcr2rgb': _YCBCR2RGB,
              'ycbcr_shift': np.array([0., 128., 128.], np.float32)}


def diff_round(x):
    """Differentiable rounding (reference diffjpeg.py:26-29)."""
    return torch.round(x) + (x - torch.round(x)) ** 3


def quality_to_factor(quality):
    """JPEG quality in (0, 100] (a tensor) -> the tables' scale
    (reference diffjpeg.py:32-45)."""
    return torch.where(quality < 50, 5000. / quality, 200. - quality * 2) \
        / 100.


def _block_split(plane):
    """(B, H, W) -> (B, H * W / 64, 64), the 8 x 8 blocks in raster
    order."""
    b, h, w = plane.shape
    return plane.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4) \
        .reshape(b, -1, 64)


def _block_merge(blocks, height, width):
    """The inverse of :func:`_block_split`."""
    b = blocks.shape[0]
    return blocks.reshape(b, height // 8, width // 8, 8, 8) \
        .permute(0, 1, 3, 2, 4).reshape(b, height, width)


class DiffJPEG:
    """JPEG round trip of NHWC RGB batches in [0, 1] (reference DiffJPEG,
    diffjpeg.py:449-478); ``quality`` is a (B,) tensor of qualities, one a
    sample, or a number. ``differentiable`` picks the rounding."""

    def __init__(self, differentiable=True):
        self.rounding = diff_round if differentiable else torch.round
        self._on = {}

    def _constants(self, device):
        if device not in self._on:
            self._on[device] = {k: torch.from_numpy(v).to(device)
                                for k, v in _CONSTANTS.items()}
        return self._on[device]

    def __call__(self, x, quality):
        const = self._constants(x.device)
        b, h, w, _ = x.shape
        quality = torch.as_tensor(quality, dtype=torch.float32,
                                  device=x.device).expand(b)
        factor = quality_to_factor(quality).view(b, 1, 1)
        h_pad, w_pad = (16 - h % 16) % 16, (16 - w % 16) % 16
        x = torch.nn.functional.pad(x, (0, 0, 0, w_pad, 0, h_pad))
        hh, ww = h + h_pad, w + w_pad
        ycbcr = torch.tensordot(x * 255., const['rgb2ycbcr'], dims=1) \
            + const['ycbcr_shift']
        planes = [ycbcr[..., 0]]
        for i in (1, 2):
            planes.append(ycbcr[..., i].reshape(
                b, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4)))
        dct, alpha = const['dct'], const['alpha'].reshape(64)
        out = []
        for plane, table in zip(planes, ('y_table', 'c_table',
                                         'c_table')):
            quant = (const[table].reshape(64) * factor)
            blocks = 0.25 * alpha * ((_block_split(plane) - 128) @ dct)
            deq = self.rounding(blocks / quant) * quant
            rec = 0.25 * ((deq * alpha) @ dct.t()) + 128
            out.append(_block_merge(rec, plane.shape[1], plane.shape[2]))
        up = [p.repeat_interleave(2, 1).repeat_interleave(2, 2)
              for p in out[1:]]
        ycbcr = torch.stack([out[0], *up], dim=-1) - const['ycbcr_shift']
        rgb = torch.tensordot(ycbcr, const['ycbcr2rgb'], dims=1)
        return (torch.clamp(rgb, 0., 255.) / 255.)[:, :h, :w, :]
