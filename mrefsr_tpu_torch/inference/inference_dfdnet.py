"""DFDNet face restoration of a folder of face images (port of
``inference/inference_dfdnet.py``)::

    python -m mrefsr_tpu_torch.inference.inference_dfdnet \\
        --test_path faces/ --landmark_dir landmarks/ \\
        --dict_path DFDNet_dict_512.pth [--model_path DFDNet.pth] \\
        [--save_path results/DFDNet] [--device cpu]

Each image is resized to 512 x 512 (bilinear) and restored with the part
boxes of its 68 landmarks, read from ``<landmark_dir>/<image name>.npy``
((68, 2) x, y in 512-space): neither dlib nor facexlib is a dependency of
the port. The result is written as ``<name>_DFDNet.png``. The dictionary
and the weights are local files; a ``--model_path`` that does not exist
is an error, and ``--model_path ''`` leaves the net with weights drawn
from ``--seed``. Runs on the CUDA device unless ``--device cpu`` is
given.
"""
import argparse
import glob
import logging
import os

import numpy as np
import torch

from mrefsr_tpu_torch.archs.dfdnet_arch import DFDNet, load_dfdnet_dict
from mrefsr_tpu_torch.convert import load_torch_state_dict
from mrefsr_tpu_torch.utils import imwrite, resolve_device, tensor2img

logger = logging.getLogger(__name__)


def get_part_location(landmarks):
    """68-point landmarks -> the xyxy boxes (1, 4) of the left eye, right
    eye, nose and mouth, each a square about the points' mean, half a side
    at least 16 (reference inference_dfdnet.py:20-48)."""
    map_left_eye = list(np.hstack((range(17, 22), range(36, 42))))
    map_right_eye = list(np.hstack((range(22, 27), range(42, 48))))
    map_nose = list(range(29, 36))
    map_mouth = list(range(48, 68))

    def part_box(points):
        mean = np.mean(points, axis=0)
        half_len = np.max((np.max(np.max(points, axis=0)
                                  - np.min(points, axis=0)) / 2, 16))
        return np.hstack((mean - half_len + 1,
                          mean + half_len)).astype(int)[None]

    return [part_box(landmarks[m]) for m in (map_left_eye, map_right_eye,
                                             map_nose, map_mouth)]


def build_model(model_path, device, seed=0, num_feat=64):
    """``DFDNet(num_feat)`` in eval mode on ``device``: seeded weights,
    then ``model_path``'s ``params`` unless the path is empty. A path that
    names no file raises :class:`FileNotFoundError`."""
    with torch.device('meta'):
        net = DFDNet(num_feat=num_feat)
    net.to_empty(device=device)
    net.init_weights(torch.Generator().manual_seed(seed))
    if model_path:
        if not os.path.isfile(model_path):
            raise FileNotFoundError(f'no DFDNet weights at {model_path!r} '
                                    "(--model_path '' keeps the weights "
                                    f'drawn from --seed)')
        net.load_state_dict(load_torch_state_dict(model_path, 'params'),
                            strict=True)
    else:
        logger.warning(f'no --model_path: the net keeps the weights drawn '
                       f'from seed {seed}')
    return net.eval().requires_grad_(False)


def read_face(path):
    """The image at ``path`` resized to 512 x 512 (OpenCV, bilinear), as an
    NCHW RGB float32 tensor in [-1, 1]."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    img = cv2.resize(img, (512, 512), interpolation=cv2.INTER_LINEAR)
    x = img[:, :, ::-1].astype(np.float32) / 255. * 2 - 1
    return torch.from_numpy(np.ascontiguousarray(x)).permute(2, 0, 1)[None]


def restore(net, face_dict, x, landmarks):
    """The restored face of ``x`` (NCHW, batch 1) as a BGR uint8 image."""
    device = next(net.parameters()).device
    with torch.inference_mode():
        out = net(x.to(device), get_part_location(np.asarray(landmarks)),
                  face_dict)
    return tensor2img(out.permute(0, 2, 3, 1), min_max=(-1, 1))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--model_path', type=str,
        default='experiments/pretrained_models/DFDNet/'
                'DFDNet_official-d1fa5650.pth')
    parser.add_argument(
        '--dict_path', type=str,
        default='experiments/pretrained_models/DFDNet/'
                'DFDNet_dict_512-f79685f0.pth')
    parser.add_argument('--test_path', type=str,
                        default='datasets/TestWhole')
    parser.add_argument('--landmark_dir', type=str, required=True,
                        help='folder of one (68, 2) landmark .npy per '
                             'image, named as the image')
    parser.add_argument('--save_path', type=str, default='results/DFDNet')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default=None,
                        help='torch device (default: the CUDA device)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    net = build_model(args.model_path, device, args.seed)
    face_dict = load_dfdnet_dict(args.dict_path, device)
    os.makedirs(args.save_path, exist_ok=True)
    for path in sorted(glob.glob(os.path.join(args.test_path, '*'))):
        img_name = os.path.splitext(os.path.basename(path))[0]
        print('Processing', img_name)
        landmarks = np.load(os.path.join(args.landmark_dir,
                                         f'{img_name}.npy'))
        imwrite(restore(net, face_dict, read_face(path), landmarks),
                os.path.join(args.save_path, f'{img_name}_DFDNet.png'))


if __name__ == '__main__':
    main()
