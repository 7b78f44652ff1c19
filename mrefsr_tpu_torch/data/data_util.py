"""Crops and paired paths of the datasets (port of
``mrefsr_tpu/data/data_util.py:143-184, 267``). The rest of that module
comes with the paired and video datasets (ROADMAP A6, A7)."""
import os
import os.path as osp


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
