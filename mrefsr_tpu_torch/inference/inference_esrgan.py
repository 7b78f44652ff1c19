"""ESRGAN single-image inference (port of ``inference/inference_esrgan.py``,
the reference's inference/inference_esrgan.py:11-53): every image of a
folder through RRDBNet (64 features, 23 blocks, growth 32, x4), written
as ``<name>_ESRGAN.png``.

    python -m mrefsr_tpu_torch.inference.inference_esrgan \\
        --input DIR --output DIR [--model_path FILE] [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without that flag it raises. The checkpoint's ``params`` load
strictly; a ``--model_path`` that does not exist leaves the net with
weights drawn from a fixed seed. An image that fails raises (the JAX
script prints the error and goes on).
"""
import argparse
import glob
import os

import numpy as np
import torch

from mrefsr_tpu_torch.archs.rrdbnet_arch import RRDBNet
from mrefsr_tpu_torch.utils import resolve_device

from .inference_basicvsr import build_model

NET_KWARGS = dict(num_in_ch=3, num_out_ch=3, num_feat=64, num_block=23,
                  num_grow_ch=32)


def inference(img, model):
    """``img`` (H, W, 3) float BGR in [0, 1] -> the output, uint8 BGR."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.ascontiguousarray(img[:, :, ::-1]),
                        dtype=torch.float32, device=device)
    with torch.inference_mode():
        out = model(x.permute(2, 0, 1)[None])[0]
    out = out.clamp(0, 1).permute(1, 2, 0).cpu().numpy()[:, :, ::-1]
    return (out * 255.0).round().astype(np.uint8)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument(
        '--model_path', type=str,
        default='experiments/pretrained_models/ESRGAN/'
                'ESRGAN_SRx4_DF2KOST_official-ff704c30.pth')
    parser.add_argument('--input', type=str, default='datasets/Set14/LRbicx4',
                        help='input test image folder')
    parser.add_argument('--output', type=str, default='results/ESRGAN',
                        help='output folder')
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    return parser.parse_args(argv)


def main(argv=None):
    """Run every image of ``--input``; returns the paths written."""
    import cv2
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(RRDBNet, NET_KWARGS, args.model_path, device)
    os.makedirs(args.output, exist_ok=True)
    written = []
    for idx, path in enumerate(sorted(glob.glob(os.path.join(args.input,
                                                             '*')))):
        imgname = os.path.splitext(os.path.basename(path))[0]
        print('Testing', idx, imgname)
        img = cv2.imread(path, cv2.IMREAD_COLOR).astype(np.float32) / 255.
        out_path = os.path.join(args.output, f'{imgname}_ESRGAN.png')
        cv2.imwrite(out_path, inference(img, model))
        written.append(out_path)
    return written


if __name__ == '__main__':
    main()
