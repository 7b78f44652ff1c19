"""Tiny image folders and options for the port's data and CLI tests: an
LMR-layout training set (scene folders, the annotation CSV in the
reference's column order) and a CUFED5-layout eval set, written from seeded
numpy with OpenCV (PNG) and Pillow (JPEG), and the options of a run at the
dry run's widths (ngf 8, 1 block, 2 deform groups)."""
import csv
import os

import cv2
import numpy as np
from PIL import Image

# LMR images (h, w); gt 32 crops; the match points stay 16 px inside
LMR_SIZES = ((72, 80), (80, 72), (64, 96), (96, 64))


def write_lmr(root, samples=4, images=8, scene='0001'):
    """``images`` seeded images in ``root/md/<scene>`` (the first half PNG,
    the rest JPEG) and ``samples`` annotated rows in ``root/ann.csv``.
    Returns ``(image folder, annotation file)``."""
    rng = np.random.RandomState(0)
    folder = os.path.join(root, 'md')
    os.makedirs(os.path.join(folder, scene), exist_ok=True)
    names, sizes = [], []
    for i in range(images):
        h, w = LMR_SIZES[i % len(LMR_SIZES)]
        img = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
        if i < images // 2:
            name = f'img_{i:04d}.png'
            cv2.imwrite(os.path.join(folder, scene, name), img)
        else:
            name = f'img_{i:04d}.jpg'
            Image.fromarray(img).save(os.path.join(folder, scene, name),
                                      quality=90)
        names.append(name)
        sizes.append((h, w))
    ann = os.path.join(root, 'ann.csv')
    with open(ann, 'w', newline='') as f:
        out = csv.writer(f)
        out.writerow(['target', 'H', 'M1', 'M2', 'L1', 'L2',
                      'p0', 'p1', 'p2', 'p3', 'p4', 'p5', 'scene'])
        for _ in range(samples):
            idx = rng.choice(images, 6, replace=False)
            points = [str([int(rng.randint(16, sizes[j][1] - 16)),
                           int(rng.randint(16, sizes[j][0] - 16))])
                      for j in idx]
            out.writerow([names[j] for j in idx] + points + [scene])
    return folder, ann


def write_cufed(root, sizes=((44, 60), (60, 44))):
    """A CUFED5-layout set in ``root/cufed``: for each (h, w) of ``sizes``
    an input ``<i>_0.png`` and refs ``<i>_1.png`` to ``<i>_5.png``."""
    rng = np.random.RandomState(1)
    folder = os.path.join(root, 'cufed')
    os.makedirs(folder, exist_ok=True)
    for i, (h, w) in enumerate(sizes):
        for j in range(6):
            cv2.imwrite(os.path.join(folder, f'{i:03d}_{j}.png'),
                        rng.randint(0, 256, (h + 4 * j, w, 3),
                                    dtype=np.uint8))
    return folder


def tiny_options(root, **train_set):
    """The options of a 4-iteration bf16 run (B 2, gt 32, 2 loader threads,
    the device prefetcher, uint8 batches) on :func:`write_lmr` and
    :func:`write_cufed`'s folders under ``root``; ``train_set`` updates
    the training set's options."""
    md, ann = write_lmr(root)
    cufed = write_cufed(root)
    net = {'network_g': {'type': 'MRAPARestorationNet', 'ngf': 8,
                         'n_blocks': 1, 'groups': 2},
           'network_map': {'type': 'CorrespondenceGenerationArch',
                           'patch_size': 3, 'stride': 1,
                           'vgg_layer_list': ['relu1_1', 'relu2_1',
                                              'relu3_1'],
                           'vgg_type': 'vgg19'},
           'network_extractor': {'type': 'ContrasMultiExtractorSep'}}
    return {
        'name': 'tiny', 'model_type': 'MultiRefRestorationModel',
        'scale': 4, 'crop_border': 4, 'num_gpu': 8, 'manual_seed': 10,
        'datasets': {
            'train': {'name': 'tiny_lmr', 'type': 'MultiRefMegaDepthDataset',
                      'dataroot_in': md, 'dataroot_ref': md,
                      'ann_file': ann, 'gt_size': 32, 'use_flip': True,
                      'use_rot': True, 'use_shuffle': True,
                      'num_worker_per_gpu': 2, 'batch_size_per_gpu': 2,
                      'dataset_enlarge_ratio': 1, 'prefetch_mode': 'device',
                      'output_dtype': 'uint8', 'decode_cache_size': 16,
                      **train_set},
            'val': {'name': 'tiny_cufed', 'type': 'MultiRefCUFEDSet',
                    'dataroot_in': cufed, 'dataroot_ref': cufed,
                    'pad_to': 64}},
        **net,
        'path': {'pretrain_network_g': None,
                 'pretrain_network_feature_extractor': None,
                 'strict_load': True, 'resume_state': None,
                 'experiments_root': os.path.join(root, 'experiments')},
        'train': {'lr_g': 1e-4, 'lr_offset': 1e-4, 'lr_relu2_offset': 1e-5,
                  'lr_relu3_offset': 1e-6, 'weight_decay_g': 0,
                  'beta_g': [0.9, 0.999],
                  'scheduler': {'type': 'MultiStepLR',
                                'milestones': [300000], 'gamma': 0.5},
                  'total_iter': 4, 'warmup_iter': -1,
                  'steps_per_dispatch': 16, 'mixed_precision': 'bfloat16',
                  'pixel_criterion': 'L1Loss', 'pixel_weight': 1.0},
        'val': {'val_freq': 2.0, 'save_img': False},
        'logger': {'print_freq': 2, 'use_tb_logger': False,
                   'save_checkpoint_freq': 2.0},
        'dist_params': {'backend': 'gloo', 'port': 29739},
    }


def eval_options(root, train_options):
    """A test YAML's options for the model ``train_options`` trains,
    on its eval set, results under ``root/results``."""
    keys = ('model_type', 'scale', 'crop_border', 'num_gpu', 'manual_seed',
            'network_g', 'network_map', 'network_extractor')
    return {'name': 'tiny_test', **{k: train_options[k] for k in keys},
            'datasets': {'test_1': dict(train_options['datasets']['val'])},
            'path': {'pretrain_network_g': None, 'strict_load': True,
                     'results_root': os.path.join(root, 'results')},
            'val': {'save_img': True, 'suffix': None}}
