"""Video test sets (port of ``mrefsr_tpu/data/video_test_dataset.py``, the
reference's basicsr/data/video_test_dataset.py): HWC RGB float32 frames in
[0, 1] from clip folders, read with OpenCV. They draw nothing at random;
``seed`` is accepted as every dataset of the port takes it."""
import glob
from os import path as osp

from mrefsr_tpu_torch.utils import read_img_seq
from mrefsr_tpu_torch.utils.logger import get_root_logger
from mrefsr_tpu_torch.utils.registry import DATASET_REGISTRY

from .data_util import duf_downsample, generate_frame_indices, scandir


def _check_backend(opt):
    if opt['io_backend']['type'] == 'lmdb':
        raise ValueError('No need to use lmdb during validation/test.')


@DATASET_REGISTRY.register()
class VideoTestDataset:
    """Every frame of every clip of Vid4, REDS4 or REDSofficial (by the
    set's ``name``; reference video_test_dataset.py:12-131): ``lq`` the
    ``num_frame`` frames around it (``padding`` past the clip's ends), ``gt``
    the frame, with its ``folder``, ``idx`` (``<i>/<frames>``), ``border``
    (within ``num_frame // 2`` of an end) and ``lq_path``. The clips are
    the folders under ``dataroot_lq`` / ``dataroot_gt``, or those
    ``meta_info_file`` lists. ``cache_data`` reads every clip once, at
    construction."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        self.cache_data = opt['cache_data']
        self.gt_root, self.lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        self.data_info = {'lq_path': [], 'gt_path': [], 'folder': [],
                          'idx': [], 'border': []}
        _check_backend(opt)
        logger = get_root_logger()
        logger.info(f'Generate data info for VideoTestDataset - '
                    f'{opt["name"]}')
        self.imgs_lq, self.imgs_gt = {}, {}
        if opt.get('meta_info_file'):
            with open(opt['meta_info_file']) as fin:
                subfolders = [line.split(' ')[0] for line in fin]
            subfolders_lq = [osp.join(self.lq_root, k) for k in subfolders]
            subfolders_gt = [osp.join(self.gt_root, k) for k in subfolders]
        else:
            subfolders_lq = sorted(glob.glob(osp.join(self.lq_root, '*')))
            subfolders_gt = sorted(glob.glob(osp.join(self.gt_root, '*')))
        if opt['name'].lower() not in ('vid4', 'reds4', 'redsofficial'):
            raise ValueError(f'Non-supported video test dataset: '
                             f'{opt["name"]}')
        for subfolder_lq, subfolder_gt in zip(subfolders_lq, subfolders_gt):
            name = osp.basename(subfolder_lq)
            paths_lq = sorted(osp.join(subfolder_lq, v)
                              for v in scandir(subfolder_lq))
            paths_gt = sorted(osp.join(subfolder_gt, v)
                              for v in scandir(subfolder_gt))
            max_idx = len(paths_lq)
            if max_idx != len(paths_gt):
                raise ValueError(f'Different number of images in lq '
                                 f'({max_idx}) and gt folders '
                                 f'({len(paths_gt)})')
            self.data_info['lq_path'].extend(paths_lq)
            self.data_info['gt_path'].extend(paths_gt)
            self.data_info['folder'].extend([name] * max_idx)
            self.data_info['idx'].extend(f'{i}/{max_idx}'
                                         for i in range(max_idx))
            border = [0] * max_idx
            for i in range(opt['num_frame'] // 2):
                border[i] = 1
                border[max_idx - i - 1] = 1
            self.data_info['border'].extend(border)
            if self.cache_data:
                logger.info(f'Cache {name} for VideoTestDataset...')
                self.imgs_lq[name] = read_img_seq(paths_lq)
                self.imgs_gt[name] = read_img_seq(paths_gt)
            else:
                self.imgs_lq[name] = paths_lq
                self.imgs_gt[name] = paths_gt

    def __getitem__(self, index):
        folder = self.data_info['folder'][index]
        idx, max_idx = (int(v) for v in
                        self.data_info['idx'][index].split('/'))
        select_idx = generate_frame_indices(idx, max_idx,
                                            self.opt['num_frame'],
                                            padding=self.opt['padding'])
        if self.cache_data:
            imgs_lq = self.imgs_lq[folder][select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            imgs_lq = read_img_seq([self.imgs_lq[folder][i]
                                    for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]])[0]
        return {'lq': imgs_lq, 'gt': img_gt, 'folder': folder,
                'idx': self.data_info['idx'][index],
                'border': self.data_info['border'][index],
                'lq_path': self.data_info['lq_path'][index]}

    def __len__(self):
        return len(self.data_info['gt_path'])


@DATASET_REGISTRY.register()
class VideoTestVimeo90KDataset:
    """Vimeo-90K-Test (reference video_test_dataset.py:133-199): the
    ``num_frame`` frames around ``im4`` of each septuplet the meta-info file
    lists, and ``im4``'s gt; no cache."""

    def __init__(self, opt, seed=None):
        self.opt = opt
        if opt['cache_data']:
            raise NotImplementedError(
                'cache_data in Vimeo90K-Test dataset is not implemented.')
        _check_backend(opt)
        gt_root, lq_root = opt['dataroot_gt'], opt['dataroot_lq']
        self.data_info = {'lq_path': [], 'gt_path': [], 'folder': [],
                          'idx': [], 'border': []}
        neighbor_list = [i + (9 - opt['num_frame']) // 2
                         for i in range(opt['num_frame'])]
        get_root_logger().info(
            f'Generate data info for VideoTestDataset - {opt["name"]}')
        with open(opt['meta_info_file']) as fin:
            subfolders = [line.split(' ')[0] for line in fin]
        for idx, subfolder in enumerate(subfolders):
            self.data_info['gt_path'].append(
                osp.join(gt_root, subfolder, 'im4.png'))
            self.data_info['lq_path'].append(
                [osp.join(lq_root, subfolder, f'im{i}.png')
                 for i in neighbor_list])
            self.data_info['folder'].append('vimeo90k')
            self.data_info['idx'].append(f'{idx}/{len(subfolders)}')
            self.data_info['border'].append(0)

    def __getitem__(self, index):
        lq_path = self.data_info['lq_path'][index]
        return {'lq': read_img_seq(lq_path),
                'gt': read_img_seq([self.data_info['gt_path'][index]])[0],
                'folder': self.data_info['folder'][index],
                'idx': self.data_info['idx'][index],
                'border': self.data_info['border'][index],
                'lq_path': lq_path[self.opt['num_frame'] // 2]}

    def __len__(self):
        return len(self.data_info['gt_path'])


@DATASET_REGISTRY.register()
class VideoTestDUFDataset(VideoTestDataset):
    """``VideoTestDataset`` for DUF (reference video_test_dataset.py:
    202-252): with ``use_duf_downsampling`` the ``lq`` frames are made from
    the gt frames (mod-cropped to ``scale`` when read from disk) by
    :func:`~.data_util.duf_downsample`, with or without ``cache_data``;
    ``gt`` is mod-cropped to ``scale`` when read from disk."""

    def __getitem__(self, index):
        folder = self.data_info['folder'][index]
        idx, max_idx = (int(v) for v in
                        self.data_info['idx'][index].split('/'))
        select_idx = generate_frame_indices(idx, max_idx,
                                            self.opt['num_frame'],
                                            padding=self.opt['padding'])
        scale = self.opt['scale']
        duf = self.opt['use_duf_downsampling']
        if self.cache_data:
            imgs_lq = (self.imgs_gt if duf else self.imgs_lq)[folder][
                select_idx]
            img_gt = self.imgs_gt[folder][idx]
        else:
            if duf:
                imgs_lq = read_img_seq([self.imgs_gt[folder][i]
                                        for i in select_idx],
                                       require_mod_crop=True, scale=scale)
            else:
                imgs_lq = read_img_seq([self.imgs_lq[folder][i]
                                        for i in select_idx])
            img_gt = read_img_seq([self.imgs_gt[folder][idx]],
                                  require_mod_crop=True, scale=scale)[0]
        if duf:
            imgs_lq = duf_downsample(imgs_lq, kernel_size=13, scale=scale)
        return {'lq': imgs_lq, 'gt': img_gt, 'folder': folder,
                'idx': self.data_info['idx'][index],
                'border': self.data_info['border'][index],
                'lq_path': self.data_info['lq_path'][index]}


@DATASET_REGISTRY.register()
class VideoRecurrentTestDataset(VideoTestDataset):
    """Whole clips, one a sample, for the recurrent nets (reference
    video_test_dataset.py:255-292): ``lq`` and ``gt`` (T, h, w, 3) and the
    ``folder``. Needs ``cache_data``."""

    def __init__(self, opt, seed=None):
        super().__init__(opt, seed)
        self.folders = sorted(set(self.data_info['folder']))

    def __getitem__(self, index):
        if not self.cache_data:
            raise NotImplementedError('Without cache_data is not '
                                      'implemented.')
        folder = self.folders[index]
        return {'lq': self.imgs_lq[folder], 'gt': self.imgs_gt[folder],
                'folder': folder}

    def __len__(self):
        return len(self.folders)
