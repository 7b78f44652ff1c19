"""StyleGAN2 sampling: seeded sample grids with optional truncation (port
of ``inference/inference_stylegan2.py``).

    python -m mrefsr_tpu_torch.inference.inference_stylegan2 \\
        --size 1024 --sample 16 --pics 4 --truncation 0.7 [--ckpt FILE]

writes ``samples/000000.png`` ... Runs on the CUDA device unless
``--device cpu`` is given; without a CUDA device and without that flag it
raises. A ``--ckpt`` that does not exist leaves the generator with weights
drawn from ``--seed``.
"""
import argparse
import os

import torch

from mrefsr_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
from mrefsr_tpu_torch.convert import load_torch_state_dict
from mrefsr_tpu_torch.utils import imwrite, resolve_device, tensor2img


def build_generator(args, device):
    """The generator of ``args`` on ``device``: seeded weights, then the
    checkpoint's ``params_ema`` (or ``params``) where the file exists."""
    with torch.device('meta'):
        net = StyleGAN2Generator(
            out_size=args.size, num_style_feat=args.latent, num_mlp=8,
            channel_multiplier=args.channel_multiplier)
    net.to_empty(device=device)
    net.init_weights(torch.Generator().manual_seed(args.seed))
    if args.ckpt and os.path.isfile(args.ckpt):
        net.load_state_dict(load_torch_state_dict(args.ckpt, 'params_ema'),
                            strict=True)
    return net.eval().requires_grad_(False)


def mean_latent(net, args, generator):
    """The truncation anchor: the mean over ``--truncation_mean`` codes
    through the style MLP alone (the reference's
    ``g_ema.mean_latent``), or None without truncation."""
    if not args.truncation < 1:
        return None
    device = next(net.parameters()).device
    latent_in = torch.randn((args.truncation_mean, args.latent),
                            generator=generator, device=device)
    with torch.inference_mode():
        return net.style_mlp(latent_in).mean(0, keepdim=True)


def generate(args, net, truncation_latent, generator, write=True):
    """``args.pics`` grids of ``args.sample`` images each, as uint8 BGR
    arrays; written to ``samples/`` unless ``write`` is false."""
    device = next(net.parameters()).device
    grids = []
    for i in range(args.pics):
        sample_z = torch.randn((args.sample, args.latent),
                               generator=generator, device=device)
        with torch.inference_mode():
            sample, _ = net([sample_z], truncation=args.truncation,
                            randomize_noise=args.randomize_noise,
                            truncation_latent=truncation_latent,
                            generator=generator)
        grid = tensor2img(sample.permute(0, 2, 3, 1), min_max=(-1, 1))
        if write:
            imwrite(grid, os.path.join('samples', f'{str(i).zfill(6)}.png'))
        grids.append(grid)
    return grids


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--size', type=int, default=1024)
    parser.add_argument('--sample', type=int, default=16)
    parser.add_argument('--pics', type=int, default=4)
    parser.add_argument('--truncation', type=float, default=0.7)
    parser.add_argument('--truncation_mean', type=int, default=4096)
    parser.add_argument('--randomize_noise', action='store_true')
    parser.add_argument('--seed', type=int, default=2020)
    parser.add_argument(
        '--ckpt', type=str,
        default='experiments/pretrained_models/'
                'stylegan2_ffhq_config_f_1024_official-b09c3668.pth')
    parser.add_argument('--channel_multiplier', type=int, default=2)
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    args = parser.parse_args(argv)
    args.latent = 512
    return args


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net = build_generator(args, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    return generate(args, net, mean_latent(net, args, generator), generator)


if __name__ == '__main__':
    main()
