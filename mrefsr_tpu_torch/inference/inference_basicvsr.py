"""BasicVSR video inference (port of ``inference/inference_basicvsr.py``):
the frames of a folder (or of a video, split by ``ffmpeg``), in chunks of
``--interval``, x4, written as PNGs.

    python -m mrefsr_tpu_torch.inference.inference_basicvsr \\
        --input_path DIR --save_path DIR [--model_path FILE] [--interval 15]

Runs on the CUDA device unless ``--device cpu`` is given; without a CUDA
device and without that flag it raises. A ``--model_path`` that does not
exist leaves the net with weights drawn from a fixed seed. Image files are
read and written in :func:`main` only (OpenCV); :func:`inference` takes and
returns arrays.
"""
import argparse
import glob
import os
import shutil
import subprocess

import numpy as np
import torch

from mrefsr_tpu_torch.archs.basicvsr_arch import BasicVSR
from mrefsr_tpu_torch.convert import (load_keeping_buffers,
                                      load_torch_state_dict)
from mrefsr_tpu_torch.utils import (imwrite, read_img_seq, resolve_device,
                                    tensor2img)

SEED = 0


def build_model(model_cls, kwargs, model_path, device, seed=SEED,
                param_key='params'):
    """``model_cls(**kwargs)`` on ``device`` for inference: seeded weights,
    then the checkpoint's ``param_key`` (None: a bare state dict) where
    the file exists, strictly but for buffers the file lacks."""
    with torch.device('meta'):
        net = model_cls(**kwargs)
    net.to_empty(device=device)
    net.init_weights(torch.Generator().manual_seed(seed))
    if model_path and os.path.isfile(model_path):
        load_keeping_buffers(net, load_torch_state_dict(model_path,
                                                        param_key))
    return net.eval().requires_grad_(False)


def inference(imgs, model):
    """``imgs (T, H, W, 3)``, float RGB in [0, 1] -> the T output frames
    as uint8 BGR ``(4H, 4W, 3)`` arrays, in one forward of the clip."""
    device = next(model.parameters()).device
    x = torch.as_tensor(np.ascontiguousarray(imgs), dtype=torch.float32,
                        device=device).permute(0, 3, 1, 2)[None]
    with torch.inference_mode():
        out = model(x)[0]
    return [tensor2img(frame.permute(1, 2, 0)) for frame in out]


def parse_args(argv=None, model_path='experiments/pretrained_models/'
               'BasicVSR_REDS4.pth', save_path='results/BasicVSR'):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model_path', type=str, default=model_path)
    parser.add_argument('--input_path', type=str,
                        default='datasets/REDS4/sharp_bicubic/000')
    parser.add_argument('--save_path', type=str, default=save_path)
    parser.add_argument('--interval', type=int, default=15)
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    return parser.parse_args(argv)


def main(argv=None, model_cls=BasicVSR, default_kwargs=None,
         suffix='BasicVSR', **defaults):
    """Read, run in chunks of ``--interval`` frames, write
    ``<frame>_<suffix>.png``. Returns the paths written."""
    args = parse_args(argv, **defaults)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(model_cls, default_kwargs
                        or dict(num_feat=64, num_block=30),
                        args.model_path, device)

    os.makedirs(args.save_path, exist_ok=True)
    input_path = args.input_path
    use_ffmpeg = not os.path.isdir(input_path)
    if use_ffmpeg:
        video_name = os.path.splitext(os.path.basename(input_path))[0]
        input_path = os.path.join(f'./{suffix}_tmp', video_name)
        os.makedirs(input_path, exist_ok=True)
        subprocess.run(['ffmpeg', '-i', args.input_path, '-qscale:v', '1',
                        '-qmin', '1', '-qmax', '1', '-vsync', '0',
                        f'{input_path}/frame%08d.png'], check=True)

    imgs_list = sorted(glob.glob(os.path.join(input_path, '*')))
    written = []
    for idx in range(0, len(imgs_list), args.interval):
        imgs, imgnames = read_img_seq(imgs_list[idx:idx + args.interval],
                                      return_imgname=True)
        for frame, imgname in zip(inference(imgs, model), imgnames):
            path = os.path.join(args.save_path, f'{imgname}_{suffix}.png')
            imwrite(frame, path)
            written.append(path)
    if use_ffmpeg:
        shutil.rmtree(input_path)
    return written


if __name__ == '__main__':
    main()
