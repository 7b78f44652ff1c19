"""CelebA / FFHQ TFRecords to PNG images or a packed shard (port of
``scripts/data_preparation/extract_images_from_tfrecords.py``)::

    python -m mrefsr_tpu_torch.scripts.data_preparation.extract_images_from_tfrecords \\
        --tf_file 'datasets/celeba/*.tfrecords' [--log_resolution 8] \\
        [--save_root datasets/celeba] [--save_type img|pack]

Each record's ``shape`` (C, H, W) and ``data`` (RGB bytes) become
``<idx:08d>.png`` (BGR, as OpenCV writes) in ``celeba_<res>_<phase>/``, or
an entry of ``celeba_<res>_<phase>.pack`` (PNG at compression level 1),
with ``phase`` ``validation`` where the pattern says so, else ``train``.
Reading TFRecords needs TensorFlow, imported only here: without it the
script raises an ``ImportError`` that names it.
"""
import argparse
import glob
import os
import os.path as osp

import numpy as np


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError('reading TFRecords needs the tensorflow package '
                          '(pip install tensorflow)') from exc
    return tf


def convert_celeba_tfrecords(tf_file, log_resolution, save_root,
                             save_type='img', compress_level=1):
    """Every record of the files ``tf_file`` matches, in sorted order;
    returns the count."""
    import cv2
    tf = _tensorflow()
    phase = 'validation' if 'validation' in tf_file else 'train'
    resolution = 2**log_resolution
    if save_type == 'pack':
        from mrefsr_tpu_torch.data.packio import PackWriter
        os.makedirs(save_root, exist_ok=True)
        writer = PackWriter(
            osp.join(save_root, f'celeba_{resolution}_{phase}.pack'))
    else:
        save_folder = osp.join(save_root, f'celeba_{resolution}_{phase}')
        os.makedirs(save_folder, exist_ok=True)

    idx = 0
    for record in sorted(glob.glob(tf_file)):
        print('Processing record:', record)
        for raw in tf.data.TFRecordDataset(record):
            example = tf.train.Example()
            example.ParseFromString(raw.numpy())
            shape = example.features.feature['shape'].int64_list.value
            data = example.features.feature['data'].bytes_list.value[0]
            img = np.frombuffer(data, np.uint8).reshape(shape)
            img = img.transpose(1, 2, 0)[:, :, ::-1]  # CHW RGB -> HWC BGR
            if save_type == 'pack':
                _, buf = cv2.imencode(
                    '.png', img,
                    [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
                writer.put(f'{idx:08d}', buf.tobytes(), shape=img.shape,
                           compress_level=compress_level)
            else:
                cv2.imwrite(osp.join(save_folder, f'{idx:08d}.png'), img)
            idx += 1
    if save_type == 'pack':
        writer.close()
    print(f'Extracted {idx} images.')
    return idx


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--tf_file', type=str, required=True)
    parser.add_argument('--log_resolution', type=int, default=8)
    parser.add_argument('--save_root', type=str, default='datasets/celeba')
    parser.add_argument('--save_type', type=str, default='img',
                        choices=['img', 'pack'])
    args = parser.parse_args(argv)
    return convert_celeba_tfrecords(args.tf_file, args.log_resolution,
                                    args.save_root, args.save_type)


if __name__ == '__main__':
    main()
