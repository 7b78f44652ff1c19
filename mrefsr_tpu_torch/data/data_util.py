"""Crops, paths and frame indices of the datasets (port of
``mrefsr_tpu/data/data_util.py``, the reference's
``basicsr/data/data_util.py``); ``read_img_seq`` is in ``utils/img_util.py``.
The ``pack`` paths read the keys of packed shards (``data/packio.py``)."""
import os
import os.path as osp

import numpy as np

__all__ = ['duf_downsample', 'generate_frame_indices',
           'generate_gaussian_kernel', 'match_point_crop',
           'paired_paths_from_ann_file', 'paired_paths_from_folder',
           'paired_paths_from_lmdb', 'paired_paths_from_meta_info_file',
           'paired_paths_from_pack', 'paths_from_folder', 'paths_from_lmdb',
           'paths_from_pack', 'scandir']

PADDINGS = ('replicate', 'reflection', 'reflection_circle', 'circle')


def generate_frame_indices(crt_idx, max_frame_num, num_frames,
                           padding='reflection'):
    """The indices of the ``num_frames`` frames centred on ``crt_idx`` in a
    clip of ``max_frame_num`` frames, those past either end replaced as
    ``padding`` says (reference data_util.py:43-92)."""
    if num_frames % 2 != 1:
        raise ValueError('num_frames should be an odd number.')
    if padding not in PADDINGS:
        raise ValueError(f'Wrong padding mode: {padding}.')
    max_frame_num = max_frame_num - 1  # start from 0
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            if padding == 'replicate':
                pad_idx = 0
            elif padding == 'reflection':
                pad_idx = -i
            elif padding == 'reflection_circle':
                pad_idx = crt_idx + num_pad - i
            else:
                pad_idx = num_frames + i
        elif i > max_frame_num:
            if padding == 'replicate':
                pad_idx = max_frame_num
            elif padding == 'reflection':
                pad_idx = max_frame_num * 2 - i
            elif padding == 'reflection_circle':
                pad_idx = (crt_idx - num_pad) - (i - max_frame_num)
            else:
                pad_idx = i - num_frames
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def _lmdb_keys(folder):
    """The keys an lmdb folder's ``meta_info.txt`` lists."""
    with open(osp.join(folder, 'meta_info.txt')) as fin:
        return [line.split('.')[0] for line in fin]


def paired_paths_from_lmdb(folders, keys):
    """``[{'<input key>_path', '<gt key>_path'}]``: the keys the two lmdb
    folders' ``meta_info.txt`` list, which must be the same set, sorted
    (reference data_util.py:95-151)."""
    (input_folder, gt_folder), (input_key, gt_key) = folders, keys
    if not (input_folder.endswith('.lmdb') and gt_folder.endswith('.lmdb')):
        raise ValueError(
            f'{input_key} folder and {gt_key} folder should both in lmdb '
            f'formats. But received {input_key}: {input_folder}; '
            f'{gt_key}: {gt_folder}')
    input_keys = _lmdb_keys(input_folder)
    if set(input_keys) != set(_lmdb_keys(gt_folder)):
        raise ValueError(f'Keys in {input_key}_folder and {gt_key}_folder '
                         'are different.')
    return [{f'{input_key}_path': key, f'{gt_key}_path': key}
            for key in sorted(input_keys)]


def _pack_keys(path):
    from .packio import PackReader
    reader = PackReader(str(path))
    try:
        return reader.keys()
    finally:
        reader.close()


def paired_paths_from_pack(pack_paths, keys):
    """``[{'<input key>_path', '<gt key>_path'}]``: the keys of two packed
    shards, which must be the same set, sorted (the JAX package's
    data_util.py:103-119, ``paired_paths_from_lmdb`` over shards)."""
    (input_pack, gt_pack), (input_key, gt_key) = pack_paths, keys
    input_keys = set(_pack_keys(input_pack))
    if input_keys != set(_pack_keys(gt_pack)):
        raise ValueError(f'Keys in the {input_key} and {gt_key} packs are '
                         'different.')
    return [{f'{input_key}_path': key, f'{gt_key}_path': key}
            for key in sorted(input_keys)]


def paths_from_pack(pack_path):
    """The keys of a packed shard, sorted."""
    return sorted(_pack_keys(pack_path))


def paired_paths_from_meta_info_file(folders, keys, meta_info_file,
                                     filename_tmpl):
    """``[{'<input key>_path', '<gt key>_path'}]`` from a meta-info file
    whose lines start with a gt name; the input is
    ``filename_tmpl.format(<basename>)<ext>`` (reference
    data_util.py:154-195)."""
    (input_folder, gt_folder), (input_key, gt_key) = folders, keys
    with open(meta_info_file) as fin:
        gt_names = [line.strip().split(' ')[0] for line in fin]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        paths.append({f'{input_key}_path': osp.join(input_folder,
                                                    input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_name)})
    return paths


def paths_from_folder(folder):
    """The files of ``folder`` (reference data_util.py:275-287)."""
    return [osp.join(folder, name) for name in scandir(folder)]


def paths_from_lmdb(folder):
    """The keys an lmdb folder's ``meta_info.txt`` lists (reference
    data_util.py:290-303)."""
    if not folder.endswith('.lmdb'):
        raise ValueError(f'Folder {folder} should in lmdb format.')
    return _lmdb_keys(folder)


def match_point_crop(img, center_xy, gt_h, gt_w):
    """The ``(gt_h, gt_w)`` window of ``img`` centred on the annotated match
    point ``center_xy`` (x, y), moved inside the image where it would
    cross a border. The reference slices the raw coordinates
    (multi_ref_dataset.py:82-86), which wraps or empties the crop near the
    top or left border; for interior points the two agree. An image
    smaller than the window raises."""
    h, w = img.shape[:2]
    if h < gt_h or w < gt_w:
        raise ValueError(
            f'match_point_crop: image ({h}x{w}) smaller than the crop '
            f'window ({gt_h}x{gt_w})')
    x, y = int(center_xy[0]), int(center_xy[1])
    y0 = min(max(y - gt_h // 2, 0), h - gt_h)
    x0 = min(max(x - gt_w // 2, 0), w - gt_w)
    return img[y0:y0 + gt_h, x0:x0 + gt_w]


def scandir(dir_path):
    """The names of the files in ``dir_path`` that do not start with a
    dot, in ``os.scandir``'s order (reference misc.py:54-93)."""
    return [entry.name for entry in os.scandir(dir_path)
            if not entry.name.startswith('.') and entry.is_file()]


def paired_paths_from_ann_file(folders, keys, ann_file):
    """``[{'<input key>_path', '<gt key>_path'}]`` from an annotation
    file listing gt names, the inputs ``<basename>.png`` (reference
    data_util.py:198-236)."""
    (input_folder, gt_folder), (input_key, gt_key) = folders, keys
    paths = []
    with open(ann_file) as fin:
        for line in fin:
            gt_name = line.strip().split(' ')[0]
            basename = osp.splitext(osp.basename(gt_name))[0]
            paths.append(
                {f'{input_key}_path': osp.join(input_folder,
                                               f'{basename}.png'),
                 f'{gt_key}_path': osp.join(gt_folder, gt_name)})
    return paths


def paired_paths_from_folder(folders, keys, filename_tmpl):
    """``[{'<input key>_path', '<gt key>_path'}]`` of two folders: each
    gt file with the input ``filename_tmpl.format(<basename>)<ext>``
    (reference data_util.py:239-272)."""
    (input_folder, gt_folder), (input_key, gt_key) = folders, keys
    input_names = scandir(input_folder)
    gt_names = scandir(gt_folder)
    if len(input_names) != len(gt_names):
        raise ValueError(f'{input_key} and {gt_key} datasets have different '
                         f'numbers of images: {len(input_names)}, '
                         f'{len(gt_names)}.')
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(gt_name)
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        if input_name not in input_names:
            raise ValueError(f'{input_name} is not in {input_key}_paths.')
        paths.append({f'{input_key}_path': osp.join(input_folder,
                                                    input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_name)})
    return paths


def generate_gaussian_kernel(kernel_size=13, sigma=1.6):
    """The ``kernel_size`` square Gaussian of ``sigma``: scipy's
    ``gaussian_filter`` of a centred impulse (reference
    data_util.py:306-321), float64."""
    from scipy import ndimage
    kernel = np.zeros((kernel_size, kernel_size))
    kernel[kernel_size // 2, kernel_size // 2] = 1
    return ndimage.gaussian_filter(kernel, sigma)


def duf_downsample(x, kernel_size=13, scale=4):
    """DUF's degradation (reference data_util.py:324-352): each channel
    reflect-padded by ``kernel_size // 2``, blurred by the Gaussian of
    sigma ``0.4 * scale`` and sampled every ``scale`` pixels, in float32
    (a depthwise strided ``conv2d`` on the CPU). ``x`` is a numpy ``(T, H,
    W, C)`` or ``(H, W, C)`` array; returns the same layout."""
    import torch
    import torch.nn.functional as F
    if scale not in (2, 3, 4):
        raise ValueError(f'Only support scale (2, 3, 4), but got {scale}.')
    squeeze = x.ndim == 3
    frames = torch.from_numpy(np.ascontiguousarray(
        x[None] if squeeze else x, dtype=np.float32)).permute(0, 3, 1, 2)
    c = frames.shape[1]
    pad = kernel_size // 2
    kernel = torch.from_numpy(generate_gaussian_kernel(
        kernel_size, 0.4 * scale).astype(np.float32))
    out = F.conv2d(F.pad(frames, (pad, pad, pad, pad), mode='reflect'),
                   kernel.expand(c, 1, kernel_size, kernel_size),
                   stride=scale, groups=c).permute(0, 2, 3, 1).numpy()
    return out[0] if squeeze else out
