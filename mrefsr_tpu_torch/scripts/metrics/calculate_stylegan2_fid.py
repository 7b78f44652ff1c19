"""FID of a StyleGAN2 generator's samples against dataset statistics (port
of ``scripts/metrics/calculate_stylegan2_fid.py``, the reference's)::

    python -m mrefsr_tpu_torch.scripts.metrics.calculate_stylegan2_fid \\
        net_g.pth inception_FFHQ_256.pth [--size 256] \\
        [--channel_multiplier 2] [--batch_size 64] [--num_sample 50000] \\
        [--truncation 0.7 --truncation_mean 4096] \\
        [--inception_path pt_inception.pth] [--seed 0] [--device cpu]

The generator (512-wide style, 8-layer MLP) loads the checkpoint's
``params_ema`` strictly, in the reference's layout. On the card (unless
``--device`` names another) it samples ``--num_sample`` images in batches
of ``--batch_size``, through the hand-written upfirdn2d and fused leaky
ReLU kernels, the codes and the noise drawn from a ``torch.Generator``
seeded with ``--seed``; their raw [-1, 1] images go through the FID
Inception on the same device. With ``--truncation`` below 1 the codes are
pulled towards the mean of ``--truncation_mean`` codes through the style
MLP. Prints ``fid:`` and returns it.
"""
import argparse
import math

import torch

from mrefsr_tpu_torch.archs.stylegan2_arch import StyleGAN2Generator
from mrefsr_tpu_torch.convert import load_torch_state_dict
from mrefsr_tpu_torch.metrics.fid import (extract_inception_features,
                                          load_patched_inception_v3)
from mrefsr_tpu_torch.scripts.metrics.calculate_fid_folder import \
    fid_of_features
from mrefsr_tpu_torch.utils import resolve_device

NUM_STYLE_FEAT = 512


def build_generator(ckpt, size, channel_multiplier, device):
    """The generator of ``ckpt``'s ``params_ema`` on ``device``, in eval
    mode."""
    with torch.device('meta'):
        net = StyleGAN2Generator(out_size=size, num_style_feat=NUM_STYLE_FEAT,
                                 num_mlp=8,
                                 channel_multiplier=channel_multiplier)
    net.to_empty(device=device)
    net.load_state_dict(load_torch_state_dict(ckpt, param_key='params_ema'),
                        strict=True)
    return net.eval().requires_grad_(False)


@torch.inference_mode()
def mean_latent(net, latent_in):
    """The mean of the codes ``latent_in`` (N, 512) through the style MLP
    alone, (1, 512): the truncation's anchor."""
    return net.style_mlp(latent_in).mean(0, keepdim=True)


@torch.inference_mode()
def sample(net, z, truncation=1, truncation_latent=None, noise=None,
           generator=None):
    """The NHWC images in [-1, 1] of the codes ``z``: with ``noise`` (one
    tensor a noise layer) given, or drawn from ``generator``."""
    img, _ = net([z], noise=noise, randomize_noise=True,
                 truncation=truncation, truncation_latent=truncation_latent,
                 generator=generator)
    return img.permute(0, 2, 3, 1)


def sample_batches(net, num_batches, batch_size, truncation,
                   truncation_latent, generator):
    """``num_batches`` batches of samples: each draws its codes, then its
    noise, from ``generator``."""
    device = next(net.parameters()).device
    for _ in range(num_batches):
        z = torch.randn((batch_size, NUM_STYLE_FEAT), generator=generator,
                        device=device)
        yield sample(net, z, truncation, truncation_latent,
                     generator=generator)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('ckpt', type=str)
    parser.add_argument('fid_stats', type=str)
    parser.add_argument('--size', type=int, default=256)
    parser.add_argument('--channel_multiplier', type=int, default=2)
    parser.add_argument('--batch_size', type=int, default=64)
    parser.add_argument('--num_sample', type=int, default=50000)
    parser.add_argument('--truncation', type=float, default=1)
    parser.add_argument('--truncation_mean', type=int, default=4096)
    parser.add_argument('--inception_path', type=str, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', type=str, default=None,
                        help='cuda (default; raises without one) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    net = build_generator(args.ckpt, args.size, args.channel_multiplier,
                          device)
    inception = load_patched_inception_v3(args.inception_path, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    truncation_latent = None
    if args.truncation < 1:
        truncation_latent = mean_latent(net, torch.randn(
            (args.truncation_mean, NUM_STYLE_FEAT), generator=generator,
            device=device))
    num_batches = math.ceil(args.num_sample / args.batch_size)
    features = extract_inception_features(
        sample_batches(net, num_batches, args.batch_size, args.truncation,
                       truncation_latent, generator), inception, num_batches)
    fid = fid_of_features(features[:args.num_sample], args.fid_stats)
    print('fid:', fid)
    return fid


if __name__ == '__main__':
    main()
