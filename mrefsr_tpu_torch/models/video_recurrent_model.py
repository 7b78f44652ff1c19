"""Recurrent video SR training (port of
``mrefsr_tpu/models/video_recurrent_model.py``, the reference's
basicsr/models/video_recurrent_model.py and
video_recurrent_gan_model.py): BasicVSR-style nets that take a whole clip,
trained on their own or against a discriminator.
"""
import logging
import os.path as osp

import torch

from mrefsr_tpu_torch.metrics import calculate_metric
from mrefsr_tpu_torch.utils import imwrite, tensor2img
from mrefsr_tpu_torch.utils.dist_util import get_dist_info
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .srgan_model import SRGANModel
from .video_base_model import VideoBaseModel

logger = logging.getLogger(__name__)


@MODEL_REGISTRY.register()
class VideoRecurrentModel(VideoBaseModel):
    """BasicVSR-style training (reference video_recurrent_model.py:15-197):
    the ``spynet`` parameters train at ``train.lr_flow``, else
    ``flow_lr_mul`` times the rate; for the first ``fix_flow`` iterations
    neither they nor an ``edvr`` feature extractor's take a step.
    Validation runs each folder whole, the folders sharded over the ranks
    (padded to a multiple of their count, so each rank runs as many),
    optionally with the clip and its reverse averaged (``val.flip_seq``)
    or the centre frame alone (``val.center_frame_only``)."""

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        fix_flow = (opt.get('train') or {}).get('fix_flow') \
            if self.is_train else None
        if fix_flow:
            logger.info(f'Fix flow network and feature extractor for '
                        f'{fix_flow} iters.')
            self.freeze_until = int(fix_flow)
            self.freeze_keep = (lambda name: 'spynet' not in name
                                and 'edvr' not in name)

    def param_groups(self, base_lr):
        train_opt = self.opt['train']
        flow_lr = train_opt.get('lr_flow',
                                base_lr * train_opt.get('flow_lr_mul', 1))
        return self._labelled_groups(base_lr, 'spynet', flow_lr,
                                     'Flow network')

    def test(self):
        """The whole clip ``lq`` (B, T, H, W, 3) through the EMA net where
        there is one (JAX package video_recurrent_model.py:138-164): with
        ``val.flip_seq`` the clip and its reverse in one call, the two
        outputs averaged; with ``val.center_frame_only`` the centre frame
        alone."""
        val_opt = self.opt['val']
        flip_seq = val_opt.get('flip_seq', False)
        center_only = val_opt.get('center_frame_only', False)
        lq, n = self.lq, self.lq.shape[1]
        if flip_seq:
            lq = torch.cat([lq, lq.flip(1)], dim=1)
        out = self.eval_forward(lq)
        if flip_seq:
            out = 0.5 * (out[:, :n] + out[:, n:].flip(1))
        if center_only:
            out = out[:, n // 2]
        self.output = out

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        """Folders ``rank::world`` of the loader's dataset, each whole,
        every frame's metrics into its folder's array (JAX package
        video_recurrent_model.py:59-136); collective where there are
        several ranks."""
        dataset = dataloader.dataset
        dataset_name = dataset.opt['name']
        metrics = self.opt['val']['metrics']
        center_only = self.opt['val'].get('center_frame_only', False)
        if metrics is not None:
            self._reset_metric_results(dataset)
        rank, world = get_dist_info()
        num_folders = len(dataset)
        num_pad = (world - num_folders % world) % world
        for i in range(rank, num_folders + num_pad, world):
            val_data = dataset[min(i, num_folders - 1)]
            folder = val_data['folder']
            val_data['lq'] = val_data['lq'][None]
            val_data['gt'] = val_data['gt'][None]
            self.feed_data(val_data)
            self.test()
            visuals = self.get_current_visuals()
            if center_only:
                visuals['result'] = visuals['result'][:, None]
                if 'gt' in visuals:
                    visuals['gt'] = visuals['gt'][:, None]
            if i >= num_folders:
                continue
            for fidx in range(visuals['result'].shape[1]):
                metric_data = {'img': tensor2img(visuals['result'][0, fidx])}
                if 'gt' in visuals:
                    metric_data['img2'] = tensor2img(visuals['gt'][0, fidx])
                if save_img:
                    if self.opt['is_train']:
                        raise NotImplementedError(
                            'saving image is not supported during training.')
                    if center_only:   # vimeo-90k
                        parts = val_data['lq_path'].split('/')
                        name = f"{parts[-3]}_{parts[-2]}_{self.opt['name']}"
                    else:
                        name = f"{fidx:08d}_{self.opt['name']}"
                    imwrite(metric_data['img'], osp.join(
                        self.opt['path']['visualization'], dataset_name,
                        folder, f'{name}.png'))
                if metrics is not None:
                    for metric_idx, opt_ in enumerate(metrics.values()):
                        self.metric_results[folder][fidx, metric_idx] += \
                            calculate_metric(metric_data, opt_)
        if metrics is not None:
            self._reduce_metric_folders()
            if rank == 0:
                self._log_validation_metric_values(current_iter,
                                                   dataset_name, tb_logger)


@MODEL_REGISTRY.register()
class VideoRecurrentGANModel(SRGANModel, VideoRecurrentModel):
    """``SRGANModel``'s training of a recurrent net (reference
    video_recurrent_gan_model.py:12-180, JAX package
    video_recurrent_model.py:189-210): the clip's frames go through
    ``net_d`` and the VGG as a batch; ``net_g``'s ``spynet`` parameters
    train at ``train.lr_flow``, else ``flow_lr_mul`` times the rate
    (:meth:`VideoRecurrentModel.param_groups`); a ``fix_flow`` that is not
    a bool freezes them and an ``edvr`` extractor's for that many
    iterations; validation is the recurrent one."""

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        if isinstance((opt.get('train') or {}).get('fix_flow'), bool):
            self.freeze_until, self.freeze_keep = 0, None
