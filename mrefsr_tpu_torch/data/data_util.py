"""Crops of the datasets (port of ``mrefsr_tpu/data/data_util.py:267``).
The rest of that module comes with the paired and video datasets
(ROADMAP A6, A7)."""


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
