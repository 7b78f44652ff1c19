"""RIDNet denoising inference (port of ``inference/inference_ridnet.py``,
the reference's inference/inference_ridnet.py): every ``*.jpg`` / ``*.png``
of ``<test_path>/X<noise_g>`` through RIDNet (3, 64, 3), fed in [0, 255]
as the reference feeds it, written to ``results/RIDNet/<test set>`` as
``<name>_x<noise_g>_RIDNet.png``.

    python -m mrefsr_tpu_torch.inference.inference_ridnet \\
        --test_path DIR [--noise_g 25] [--model_path FILE] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without that flag it raises. The checkpoint is a bare state
dict and loads strictly; a ``--model_path`` that does not exist leaves
the net with weights drawn from a fixed seed.
"""
import argparse
import glob
import os

import numpy as np
import torch

from mrefsr_tpu_torch.archs.ridnet_arch import RIDNet
from mrefsr_tpu_torch.utils import resolve_device

from .inference_basicvsr import build_model

NET_KWARGS = dict(in_channels=3, mid_channels=64, out_channels=3)


def inference(img, model):
    """``img`` (H, W, 3) float BGR in [0, 255] -> the output, uint8 BGR."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.ascontiguousarray(img[:, :, ::-1]),
                        dtype=torch.float32, device=device)
    with torch.inference_mode():
        out = model(x.permute(2, 0, 1)[None])[0]
    out = out.clamp(0, 255).permute(1, 2, 0).cpu().numpy()[:, :, ::-1]
    return out.round().astype(np.uint8)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--test_path', type=str,
                        default='datasets/denoise/RNI15')
    parser.add_argument('--noise_g', type=int, default=25)
    parser.add_argument(
        '--model_path', type=str,
        default='experiments/pretrained_models/RIDNet/RIDNet.pth')
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    return parser.parse_args(argv)


def main(argv=None):
    """Denoise every image of the test folder; returns the paths
    written."""
    import cv2
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    test_path = args.test_path.rstrip('/')
    test_root = os.path.join(test_path, f'X{args.noise_g}')
    result_root = f'results/RIDNet/{os.path.basename(test_path)}'
    os.makedirs(result_root, exist_ok=True)
    model = build_model(RIDNet, NET_KWARGS, args.model_path, device,
                        param_key=None)
    written = []
    for idx, img_path in enumerate(sorted(glob.glob(os.path.join(
            test_root, '*.[jp][pn]g')))):
        img_name = os.path.basename(img_path).split('.')[0]
        print(f'{idx}: {img_name}')
        img = cv2.imread(img_path, cv2.IMREAD_COLOR).astype(np.float32)
        out_path = os.path.join(result_root,
                                f'{img_name}_x{args.noise_g}_RIDNet.png')
        cv2.imwrite(out_path, inference(img, model))
        written.append(out_path)
    return written


if __name__ == '__main__':
    main()
