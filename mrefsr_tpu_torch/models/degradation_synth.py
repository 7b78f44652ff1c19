"""Real-ESRGAN's two-stage degradation on the card (port of
``mrefsr_tpu/models/degradation_synth.py``, the synthesis of the
reference's basicsr/models/realesrgan_model.py:69-186 and
realesrnet_model.py:68-189).

The JAX package's design, kept:

* **Host draws.** Each call draws its decisions on the host, in the JAX
  package's order, from the synthesizer's own ``random.Random`` and
  ``numpy.random.RandomState`` (the JAX package's: python's and numpy's
  global generators): the first resize's direction, scale and mode, the
  first noise's family, the second blur, the second resize, the second
  noise's family, the order of the last resize and JPEG, and the last
  resize's mode (:meth:`DegradationSynthesizer.draw`).
* **A fixed canvas.** Every random resize is two products with matrices
  built on the host (:func:`~mrefsr_tpu_torch.ops.resize.resize_matrix_np`)
  onto a canvas of a fixed size, a multiple of 16 (the largest the
  resize can give); the image fills its top-left ``(h, w)`` and the rest
  is reflected from it (:func:`_reflect_extend`) before each window, zero
  before each JPEG, and left out of the Poisson noise's count of levels
  (:func:`_valid_mask`). So a step's shapes do not depend on its draws,
  and each 8 x 8 JPEG block is the one the reference codes.
* **Branches on the host.** The JAX package's ``lax.cond`` branches are
  python ``if``s on the host's booleans: nothing waits for the card.

The noise and the JPEG qualities come from a ``torch.Generator`` on the
model's device (the JAX package's from ``jax.random`` keys), never from
the global generator. :func:`paired_random_crop_device` and
:class:`TrainingPairPool` draw from such a generator too.
"""
import math
import random

import numpy as np
import torch

from mrefsr_tpu_torch.data.degradations import (
    random_add_gaussian_noise_pt, random_add_poisson_noise_pt)
from mrefsr_tpu_torch.ops.resize import (apply_resize_matrices,
                                         resize_matrix_np)
from mrefsr_tpu_torch.utils.diffjpeg import DiffJPEG
from mrefsr_tpu_torch.utils.img_process_util import USMSharp, filter2D

MODES = ('area', 'bilinear', 'bicubic')


def _round16(x):
    return int(math.ceil(x / 16) * 16)


def _embed(mat, rows, cols):
    out = np.zeros((rows, cols), np.float32)
    out[:mat.shape[0], :mat.shape[1]] = mat
    return out


def _reflect_index(size, valid, device):
    i = torch.arange(size, device=device)
    return torch.where(i < valid, i,
                       torch.clamp(2 * valid - 2 - i, 0, valid - 1))


def _reflect_extend(x, h_valid, w_valid):
    """NHWC ``x`` with its top-left ``(h_valid, w_valid)`` reflected
    (border-101) over the whole canvas, so that a window at the image's
    edge sees what the reference sees there."""
    return x.index_select(1, _reflect_index(x.shape[1], h_valid, x.device)) \
        .index_select(2, _reflect_index(x.shape[2], w_valid, x.device))


def _valid_mask(shape_hw, h_valid, w_valid, device):
    """(1, H, W, 1) float32: 1 on the top-left ``(h_valid, w_valid)``."""
    mh = (torch.arange(shape_hw[0], device=device) < h_valid).float()
    mw = (torch.arange(shape_hw[1], device=device) < w_valid).float()
    return (mh[:, None] * mw[None, :])[None, :, :, None]


class DegradationSynthesizer:
    """``feed_data``'s synthesis (reference realesrgan_model.py:69-186),
    one per model: host draws from ``seed``, device draws from a generator
    on ``device`` seeded with it."""

    def __init__(self, opt, device, seed=0):
        self.opt = opt
        self.scale = opt['scale']
        self.jpeger = DiffJPEG(differentiable=False)
        self.usm = USMSharp()
        self.rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    # ------------------------------------------------------------ host draws
    def _draw_resize(self, prob, rng_range):
        updown_type = self.rng.choices(['up', 'down', 'keep'], prob)[0]
        if updown_type == 'up':
            scale = self.np_rng.uniform(1, rng_range[1])
        elif updown_type == 'down':
            scale = self.np_rng.uniform(rng_range[0], 1)
        else:
            scale = 1
        return scale, self.rng.choice(MODES)

    def draw(self):
        """One call's host decisions, in the JAX package's order
        (its degradation_synth.py:117-126)."""
        opt, u = self.opt, self.np_rng.uniform
        s1, mode1 = self._draw_resize(opt['resize_prob'], opt['resize_range'])
        noise1_gaussian = u() < opt['gaussian_noise_prob']
        second_blur = u() < opt['second_blur_prob']
        s2, mode2 = self._draw_resize(opt['resize_prob2'],
                                      opt['resize_range2'])
        noise2_gaussian = u() < opt['gaussian_noise_prob2']
        resize_first = u() < 0.5
        return {'s1': s1, 'mode1': mode1, 'noise1_gaussian': noise1_gaussian,
                'second_blur': second_blur, 's2': s2, 'mode2': mode2,
                'noise2_gaussian': noise2_gaussian,
                'resize_first': resize_first,
                'mode3': self.rng.choice(MODES)}

    def host_inputs(self, plan, H, W):
        """The valid sizes, the canvases and the six resize matrices
        (numpy, embedded in the canvases) of ``plan`` for a (H, W) gt."""
        opt, scale = self.opt, self.scale
        lqh, lqw = H // scale, W // scale
        h1, w1 = max(int(H * plan['s1']), 1), max(int(W * plan['s1']), 1)
        h2 = max(int(H / scale * plan['s2']), 1)
        w2 = max(int(W / scale * plan['s2']), 1)
        up1, up2 = max(opt['resize_range'][1], 1), \
            max(opt['resize_range2'][1], 1)
        c1 = (_round16(H * up1), _round16(W * up1))
        c2 = (_round16(H / scale * up2), _round16(W / scale * up2))
        m1, m2, m3 = plan['mode1'], plan['mode2'], plan['mode3']
        return {'h1': h1, 'w1': w1, 'h2': h2, 'w2': w2, 'c1': c1, 'c2': c2,
                'a1h': _embed(resize_matrix_np(H, h1, m1), c1[0], H),
                'a1w': _embed(resize_matrix_np(W, w1, m1), c1[1], W),
                'a2h': _embed(resize_matrix_np(h1, h2, m2), c2[0], c1[0]),
                'a2w': _embed(resize_matrix_np(w1, w2, m2), c2[1], c1[1]),
                'a3h': _embed(resize_matrix_np(h2, lqh, m3), lqh, c2[0]),
                'a3w': _embed(resize_matrix_np(w2, lqw, m3), lqw, c2[1])}

    # ---------------------------------------------------------------- device
    def __call__(self, gt, kernel1, kernel2, sinc_kernel, usm_source=True,
                 plan=None):
        """``gt`` (B, H, W, 3) RGB in [0, 1] on the device -> ``(gt_usm,
        lq)``, ``lq`` (B, H / scale, W / scale, 3) on 8-bit levels. The
        caller crops both (after the pool), as the reference does.
        ``usm_source``: degrade from ``usm(gt)`` (RealESRGAN; the
        reference degrades from ``gt_usm`` whatever ``gt_usm`` says), or
        from ``gt`` itself (RealESRNet, whose ``feed_data`` sharpens it
        first where ``gt_usm: true``); ``gt_usm`` is then ``gt``."""
        gt_usm, out = self.degrade(gt, kernel1, kernel2, sinc_kernel,
                                   usm_source, plan)
        return gt_usm, torch.clamp(torch.round(out * 255.0), 0, 255) / 255.

    def degrade(self, gt, kernel1, kernel2, sinc_kernel, usm_source=True,
                plan=None):
        """:meth:`__call__` before the last rounding to 8-bit levels;
        ``plan`` (:meth:`draw`'s) is drawn where it is not given."""
        opt, gen = self.opt, self.generator
        plan = self.draw() if plan is None else plan
        H, W = int(gt.shape[1]), int(gt.shape[2])
        host = self.host_inputs(plan, H, W)
        mats = {k: torch.from_numpy(v).to(gt.device) for k, v in host.items()
                if k[0] == 'a'}
        h1, w1, h2, w2 = host['h1'], host['w1'], host['h2'], host['w2']
        gt_usm = self.usm(gt) if usm_source else gt

        # the first degradation (reference :85-114)
        out = filter2D(gt_usm, kernel1)
        out = _reflect_extend(
            apply_resize_matrices(out, mats['a1h'], mats['a1w']), h1, w1)
        mask1 = _valid_mask(host['c1'], h1, w1, gt.device)
        if plan['noise1_gaussian']:
            out = random_add_gaussian_noise_pt(
                out, sigma_range=opt['noise_range'], clip=True, rounds=False,
                gray_prob=opt['gray_noise_prob'], generator=gen)
        else:
            out = random_add_poisson_noise_pt(
                out, scale_range=opt['poisson_scale_range'],
                gray_prob=opt['gray_noise_prob'], clip=True, rounds=False,
                valid_mask=mask1, generator=gen)
        out = self.jpeger(torch.clamp(out, 0, 1) * mask1,
                          self._quality(opt['jpeg_range'], out))

        # the second degradation (reference :116-141)
        out = _reflect_extend(out, h1, w1)
        if plan['second_blur']:
            out = filter2D(out, kernel2)
        out = _reflect_extend(
            apply_resize_matrices(out, mats['a2h'], mats['a2w']), h2, w2)
        mask2 = _valid_mask(host['c2'], h2, w2, gt.device)
        if plan['noise2_gaussian']:
            out = random_add_gaussian_noise_pt(
                out, sigma_range=opt['noise_range2'], clip=True,
                rounds=False, gray_prob=opt['gray_noise_prob2'],
                generator=gen)
        else:
            out = random_add_poisson_noise_pt(
                out, scale_range=opt['poisson_scale_range2'],
                gray_prob=opt['gray_noise_prob2'], clip=True, rounds=False,
                valid_mask=mask2, generator=gen)

        # the last resize + sinc and JPEG, in either order (reference
        # :143-169)
        quality2 = self._quality(opt['jpeg_range2'], out)
        if plan['resize_first']:
            out = apply_resize_matrices(out, mats['a3h'], mats['a3w'])
            out = torch.clamp(filter2D(out, sinc_kernel), 0, 1)
            out = self.jpeger(out, quality2)
        else:
            out = self.jpeger(torch.clamp(out, 0, 1) * mask2, quality2)
            out = apply_resize_matrices(_reflect_extend(out, h2, w2),
                                        mats['a3h'], mats['a3w'])
            out = filter2D(out, sinc_kernel)
        return gt_usm, out

    def _quality(self, quality_range, like):
        """A JPEG quality for each sample, uniform in ``quality_range``."""
        low, high = quality_range
        return torch.rand(like.shape[0], generator=self.generator,
                          device=like.device) * (high - low) + low


def paired_random_crop_device(gts, lqs, gt_patch_size, scale, generator):
    """One aligned random crop of device batches (reference
    transforms.py:26-91): a ``gt_patch_size // scale`` window of every lq
    batch and the ``gt_patch_size`` window at the same place of every gt
    batch, the same for every sample. The corner is drawn on the device
    from ``generator`` and taken by index, so nothing waits for the card.
    ``gts`` / ``lqs`` are (B, H, W, C) tensors or lists of them."""
    single_gt = not isinstance(gts, (list, tuple))
    single_lq = not isinstance(lqs, (list, tuple))
    gts = [gts] if single_gt else list(gts)
    lqs = [lqs] if single_lq else list(lqs)
    lq_patch = gt_patch_size // scale
    _, lh, lw, _ = lqs[0].shape
    device = lqs[0].device
    top = torch.randint(0, lh - lq_patch + 1, (1,), generator=generator,
                        device=device)
    left = torch.randint(0, lw - lq_patch + 1, (1,), generator=generator,
                         device=device)
    rows, cols = (torch.arange(lq_patch, device=device) + o
                  for o in (top, left))
    lqs = [x.index_select(1, rows).index_select(2, cols) for x in lqs]
    rows, cols = (torch.arange(gt_patch_size, device=device) + o * scale
                  for o in (top, left))
    gts = [x.index_select(1, rows).index_select(2, cols) for x in gts]
    return gts[0] if single_gt else gts, lqs[0] if single_lq else lqs


class TrainingPairPool:
    """The training-pair pool on the device (reference
    realesrgan_model.py:32-66 ``_dequeue_and_enqueue``): the first
    ``queue_size / B`` batches fill it and pass through; from then on each
    call shuffles it (``torch.randperm`` on ``generator``), returns its
    first B pairs and puts the call's pairs in their place. This mixes the
    degradations of many batches in one."""

    def __init__(self, queue_size=180, generator=None):
        self.queue_size = queue_size
        self.generator = generator
        self.queue_lr = self.queue_gt = None
        self.queue_ptr = 0

    def __call__(self, lq, gt):
        b = lq.shape[0]
        if self.queue_lr is None:
            if self.queue_size % b:
                raise ValueError(
                    f'queue size {self.queue_size} should be divisible by '
                    f'the batch size of a rank (batch_size_per_gpu) {b}')
            self.queue_lr = lq.new_zeros((self.queue_size,) + lq.shape[1:])
            self.queue_gt = gt.new_zeros((self.queue_size,) + gt.shape[1:])
            self.queue_ptr = 0
        if self.queue_ptr == self.queue_size:
            idx = torch.randperm(self.queue_size, generator=self.generator,
                                 device=lq.device)
            self.queue_lr = self.queue_lr[idx]
            self.queue_gt = self.queue_gt[idx]
            lq_out = self.queue_lr[0:b].clone()
            gt_out = self.queue_gt[0:b].clone()
            self.queue_lr[0:b] = lq
            self.queue_gt[0:b] = gt
            return lq_out, gt_out
        self.queue_lr[self.queue_ptr:self.queue_ptr + b] = lq
        self.queue_gt[self.queue_ptr:self.queue_ptr + b] = gt
        self.queue_ptr += b
        return lq, gt
