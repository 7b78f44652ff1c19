"""Video SR models (port of ``mrefsr_tpu/models/video_base_model.py``, the
reference's basicsr/models/video_base_model.py and edvr_model.py).

``VideoBaseModel`` validates a sliding-window net frame by frame: rank
``r`` of ``w`` takes frames ``r::w`` of the set, each metric lands in its
folder's (frames, metrics) array, and the arrays are summed over the ranks
by one ``all_reduce`` (the JAX package's ``process_allgather`` sum, the
reference's ``dist.reduce``), so every rank ends with the whole set's.
``EDVRModel`` adds the ``dcn`` learning rate and the TSA-only start;
``VideoGANModel`` trains a sliding-window net as ``SRGANModel`` does.
"""
import logging
import os.path as osp
from collections import Counter

import numpy as np
import torch
import torch.distributed as dist

from mrefsr_tpu_torch.metrics import calculate_metric
from mrefsr_tpu_torch.utils import imwrite, tensor2img
from mrefsr_tpu_torch.utils.dist_util import get_dist_info
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .sr_model import SRModel
from .srgan_model import SRGANModel

logger = logging.getLogger(__name__)


@MODEL_REGISTRY.register()
class VideoBaseModel(SRModel):
    """``SRModel`` with frame-sharded validation per folder (reference
    video_base_model.py:15-160)."""

    def _reset_metric_results(self, dataset):
        """Zeroed (frames, metrics) float32 arrays, one per folder of
        ``dataset.data_info``, and the best-metric record."""
        metrics = self.opt['val']['metrics']
        if not hasattr(self, 'metric_results'):
            counts = Counter(dataset.data_info['folder'])
            self.metric_results = {
                folder: np.zeros((n, len(metrics)), np.float32)
                for folder, n in counts.items()}
        self._initialize_best_metric_results(dataset.opt['name'])
        for arr in self.metric_results.values():
            arr[:] = 0

    def dist_validation(self, dataloader, current_iter, tb_logger,
                        save_img):
        """Frames ``rank::world`` of the loader's dataset (the dataset is
        indexed directly, as the JAX package's). Collective where there
        are several ranks: every rank calls it."""
        dataset = dataloader.dataset
        dataset_name = dataset.opt['name']
        metrics = self.opt['val']['metrics']
        if metrics is not None:
            self._reset_metric_results(dataset)
        rank, world = get_dist_info()
        for idx in range(rank, len(dataset), world):
            val_data = dataset[idx]
            val_data['lq'] = val_data['lq'][None]
            val_data['gt'] = val_data['gt'][None]
            folder = val_data['folder']
            frame_idx = int(val_data['idx'].split('/')[0])
            lq_path = val_data['lq_path']
            self.feed_data(val_data)
            self.test()
            visuals = self.get_current_visuals()
            metric_data = {'img': tensor2img(visuals['result'])}
            if 'gt' in visuals:
                metric_data['img2'] = tensor2img(visuals['gt'])
            if save_img:
                if self.opt['is_train']:
                    raise NotImplementedError(
                        'saving image is not supported during training.')
                if 'vimeo' in dataset_name.lower():
                    parts = lq_path.split('/')
                    img_name = (f'{parts[-3]}_{parts[-2]}_'
                                f'{parts[-1].split(".")[0]}')
                else:
                    img_name = osp.splitext(osp.basename(lq_path))[0]
                suffix = self.opt['val'].get('suffix') or self.opt['name']
                imwrite(metric_data['img'], osp.join(
                    self.opt['path']['visualization'], dataset_name,
                    folder, f'{img_name}_{suffix}.png'))
            if metrics is not None:
                for metric_idx, opt_ in enumerate(metrics.values()):
                    self.metric_results[folder][frame_idx, metric_idx] += \
                        calculate_metric(metric_data, opt_)
        if metrics is not None:
            self._reduce_metric_folders()
            if rank == 0:
                self._log_validation_metric_values(current_iter,
                                                   dataset_name, tb_logger)

    def _reduce_metric_folders(self):
        """Sum the folders' arrays over the ranks, in one all-reduce on
        this rank's device (NCCL reduces no CPU tensor); each entry is one
        rank's value plus zeros, so the sum is exact."""
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return
        folders = list(self.metric_results)
        flat = torch.from_numpy(np.concatenate(
            [self.metric_results[f].ravel() for f in folders])).to(
                self.device, torch.float64)
        dist.all_reduce(flat)
        flat = flat.cpu().numpy().astype(np.float32)
        start = 0
        for folder in folders:
            arr = self.metric_results[folder]
            self.metric_results[folder] = flat[start:start + arr.size] \
                .reshape(arr.shape)
            start += arr.size

    def nondist_validation(self, dataloader, current_iter, tb_logger,
                           save_img):
        """:meth:`dist_validation` (one rank in a run of one)."""
        self.dist_validation(dataloader, current_iter, tb_logger, save_img)

    def _log_validation_metric_values(self, current_iter, dataset_name,
                                      tb_logger):
        """Frames averaged per folder, then folders averaged (reference
        video_base_model.py:118-160); the best values updated."""
        per_folder = {folder: arr.mean(axis=0)
                      for folder, arr in self.metric_results.items()}
        totals = {metric: 0 for metric in self.opt['val']['metrics']}
        for arr in per_folder.values():
            for idx, metric in enumerate(totals):
                totals[metric] += arr[idx]
        for metric in totals:
            totals[metric] /= len(per_folder)
            self._update_best_metric_result(dataset_name, metric,
                                            totals[metric], current_iter)
        log_str = f'Validation {dataset_name}\n'
        for metric_idx, (metric, value) in enumerate(totals.items()):
            log_str += f'\t # {metric}: {value:.4f}'
            for folder, arr in per_folder.items():
                log_str += f'\t # {folder}: {arr[metric_idx]:.4f}'
            best = self.best_metric_results[dataset_name][metric]
            log_str += (f'\n\t    Best: {best["val"]:.4f} @ '
                        f'{best["iter"]} iter\n')
        logger.info(log_str)
        if tb_logger:
            for metric_idx, (metric, value) in enumerate(totals.items()):
                tb_logger.add_scalar(f'metrics/{metric}', value,
                                     current_iter)
                for folder, arr in per_folder.items():
                    tb_logger.add_scalar(f'metrics/{metric}/{folder}',
                                         arr[metric_idx], current_iter)


@MODEL_REGISTRY.register()
class EDVRModel(VideoBaseModel):
    """EDVR training (reference edvr_model.py:7-62): the parameters whose
    name holds ``dcn`` (``dcn_pack.*``, ``cas_dcnpack.*``, their offset
    convs included) train at ``dcn_lr_mul`` times the rate, and for the
    first ``tsa_iter`` iterations only the ``fusion`` parameters (the TSA
    module) take a step."""

    def __init__(self, opt, device=None):
        super().__init__(opt, device)
        tsa_iter = (opt.get('train') or {}).get('tsa_iter') \
            if self.is_train else None
        if tsa_iter:
            logger.info(f'Only train TSA module for {tsa_iter} iters.')
            self.freeze_until = int(tsa_iter)
            self.freeze_keep = lambda name: 'fusion' in name

    def param_groups(self, base_lr):
        mul = self.opt['train'].get('dcn_lr_mul', 1)
        logger.info(f'Multiple the learning rate for dcn with {mul}.')
        return self._labelled_groups(base_lr, 'dcn', base_lr * mul, 'DCN')


@MODEL_REGISTRY.register()
class VideoGANModel(SRGANModel, VideoBaseModel):
    """``SRGANModel``'s training with ``VideoBaseModel``'s validation, in
    the JAX package's order of bases (reference video_gan_model.py:7-17):
    the window's output frame against ``net_d``."""
