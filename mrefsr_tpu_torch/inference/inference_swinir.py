"""SwinIR inference for every task (port of ``inference/inference_swinir.py``,
the reference's inference/inference_swinir.py:13-198): each image of a
folder reflect-padded at the bottom and right to a multiple of the
window, through the task's SwinIR, the output cropped back and written as
``<name>_SwinIR.png``. ``gray_dn`` and ``jpeg_car`` read one grey
channel; ``jpeg_car`` runs at window 7.

    python -m mrefsr_tpu_torch.inference.inference_swinir \\
        --input DIR --output DIR [--task classical_sr] [--scale 4] \\
        [--patch_size 64] [--large_model] [--model_path FILE] \\
        [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without that flag it raises. The checkpoint's ``params_ema``
(else ``params``) loads strictly, its ``relative_position_index`` and
``attn_mask`` buffers where it carries them; a ``--model_path`` that does
not exist leaves the net with weights drawn from a fixed seed.
"""
import argparse
import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

from mrefsr_tpu_torch.archs.swinir_arch import SwinIR
from mrefsr_tpu_torch.utils import resolve_device

from .inference_basicvsr import build_model

TASKS = ('classical_sr', 'lightweight_sr', 'real_sr', 'gray_dn', 'color_dn',
         'jpeg_car')


def model_kwargs(args):
    """The task's SwinIR (JAX script's ``define_model``, reference
    inference_swinir.py:79-190)."""
    common = dict(img_range=1., mlp_ratio=2, resi_connection='1conv')
    six = dict(depths=(6,) * 6, embed_dim=180, num_heads=(6,) * 6)
    if args.task == 'classical_sr':
        return dict(upscale=args.scale, in_chans=3, img_size=args.patch_size,
                    window_size=8, upsampler='pixelshuffle', **six, **common)
    if args.task == 'lightweight_sr':
        return dict(upscale=args.scale, in_chans=3, img_size=64,
                    window_size=8, depths=(6,) * 4, embed_dim=60,
                    num_heads=(6,) * 4, upsampler='pixelshuffledirect',
                    **common)
    if args.task == 'real_sr':
        if not args.large_model:
            return dict(upscale=4, in_chans=3, img_size=64, window_size=8,
                        upsampler='nearest+conv', **six, **common)
        return dict(upscale=4, in_chans=3, img_size=64, window_size=8,
                    depths=(6,) * 9, embed_dim=248, num_heads=(8,) * 9,
                    upsampler='nearest+conv', img_range=1., mlp_ratio=2,
                    resi_connection='3conv')
    if args.task in ('gray_dn', 'color_dn'):
        return dict(upscale=1, in_chans=1 if args.task == 'gray_dn' else 3,
                    img_size=128, window_size=8, upsampler='', **six,
                    **common)
    if args.task == 'jpeg_car':
        return dict(upscale=1, in_chans=1, img_size=126, window_size=7,
                    img_range=255., mlp_ratio=2, upsampler='',
                    resi_connection='1conv', **six)
    raise ValueError(f'Unknown task {args.task}')


def inference(img, model, window_size, scale):
    """``img`` (H, W, C) float in [0, 1], BGR where C is 3 -> the output,
    uint8 (BGR where C is 3), (H * scale, W * scale, C)."""
    device = next(model.parameters()).device
    if img.shape[-1] == 3:
        img = img[:, :, ::-1]
    x = torch.as_tensor(np.ascontiguousarray(img), dtype=torch.float32,
                        device=device).permute(2, 0, 1)[None]
    h, w = x.shape[-2:]
    x = F.pad(x, (0, (-w) % window_size, 0, (-h) % window_size),
              mode='reflect')
    with torch.inference_mode():
        out = model(x)[0, :, :h * scale, :w * scale]
    out = out.clamp(0, 1).permute(1, 2, 0).cpu().numpy()
    if out.shape[-1] == 3:
        out = out[:, :, ::-1]
    return (out * 255.0).round().astype(np.uint8)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input', type=str,
                        default='datasets/Set5/LRbicx4')
    parser.add_argument('--output', type=str,
                        default='results/SwinIR/Set5')
    parser.add_argument('--task', type=str, default='classical_sr',
                        help=', '.join(TASKS))
    parser.add_argument('--patch_size', type=int, default=64)
    parser.add_argument('--scale', type=int, default=4)
    parser.add_argument('--noise', type=int, default=15)
    parser.add_argument('--jpeg', type=int, default=40)
    parser.add_argument('--large_model', action='store_true')
    parser.add_argument(
        '--model_path', type=str,
        default='experiments/pretrained_models/SwinIR/'
                '001_classicalSR_DF2K_s64w8_SwinIR-M_x4.pth')
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
    kwargs = model_kwargs(args)
    model = build_model(SwinIR, kwargs, args.model_path, device,
                        param_key='params_ema')
    gray = args.task in ('gray_dn', 'jpeg_car')
    os.makedirs(args.output, exist_ok=True)
    written = []
    for idx, path in enumerate(sorted(glob.glob(os.path.join(args.input,
                                                             '*')))):
        imgname = os.path.splitext(os.path.basename(path))[0]
        print('Testing', idx, imgname)
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray
                         else cv2.IMREAD_COLOR).astype(np.float32) / 255.
        if gray:
            img = img[:, :, None]
        out_path = os.path.join(args.output, f'{imgname}_SwinIR.png')
        cv2.imwrite(out_path, inference(img, model, kwargs['window_size'],
                                        kwargs['upscale']))
        written.append(out_path)
    return written


if __name__ == '__main__':
    main()
