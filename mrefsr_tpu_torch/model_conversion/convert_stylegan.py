"""Convert a rosinality stylegan2-pytorch checkpoint into the key layout of
the port's ``StyleGAN2Generator`` / ``StyleGAN2Discriminator`` (port of
``scripts/model_conversion/convert_stylegan.py``)::

    python -m mrefsr_tpu_torch.model_conversion.convert_stylegan \\
        --ori stylegan2-ffhq-config-f.pt --size 1024 --save out.pth

``g_ema`` becomes ``params_ema``, ``d`` (where there is one) ``params``. The
target keys and shapes are those of the port's nets at ``--size`` and
``--channel_multiplier`` (512 style features, 8 MLP layers, rosinality's
published widths).
"""
import argparse

import torch


def convert_net_g(ori_net, crt_keys_and_shapes):
    """rosinality generator -> the port's keys. ``crt_keys_and_shapes`` is
    ``{port_key: shape}``; a tensor of another shape raises."""
    out = {}
    for crt_k, shape in crt_keys_and_shapes.items():
        if 'style_mlp' in crt_k:
            ori_k = crt_k.replace('style_mlp', 'style')
        elif 'constant_input.weight' in crt_k:
            ori_k = crt_k.replace('constant_input.weight', 'input.input')
        elif 'style_conv1.modulated_conv' in crt_k:
            ori_k = crt_k.replace('style_conv1.modulated_conv', 'conv1.conv')
        elif 'style_conv1' in crt_k:
            ori_k = (crt_k.replace('style_conv1', 'conv1.noise')
                     if tuple(shape) == (1,)
                     else crt_k.replace('style_conv1', 'conv1'))
        elif 'style_convs' in crt_k:
            ori_k = crt_k.replace('style_convs', 'convs').replace(
                'modulated_conv', 'conv')
            if tuple(shape) == (1,):
                ori_k = ori_k.replace('.weight', '.noise.weight')
        elif 'to_rgb1.modulated_conv' in crt_k:
            ori_k = crt_k.replace('to_rgb1.modulated_conv', 'to_rgb1.conv')
        elif 'to_rgbs' in crt_k:
            ori_k = crt_k.replace('modulated_conv', 'conv')
        elif 'noises' in crt_k:
            ori_k = crt_k.replace('.noise', '.noise_')
        else:
            ori_k = crt_k
        _check_shape(crt_k, shape, ori_net[ori_k])
        out[crt_k] = ori_net[ori_k]
    return out


def convert_net_d(ori_net, crt_keys_and_shapes):
    """rosinality discriminator -> the port's keys (``conv_body`` is
    rosinality's ``convs``)."""
    out = {}
    for crt_k, shape in crt_keys_and_shapes.items():
        ori_k = crt_k.replace('conv_body', 'convs')
        _check_shape(crt_k, shape, ori_net[ori_k])
        out[crt_k] = ori_net[ori_k]
    return out


def _check_shape(crt_k, shape, tensor):
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f'Wrong tensor size for {crt_k}: {tuple(shape)} vs '
                         f'{tuple(tensor.shape)}')


def port_shapes(size, channel_multiplier=2):
    """``({generator key: shape}, {discriminator key: shape})`` of the
    port's nets at ``size`` (built on ``meta``, nothing allocated)."""
    from mrefsr_tpu_torch.archs.stylegan2_arch import (
        StyleGAN2Discriminator, StyleGAN2Generator)
    with torch.device('meta'):
        nets = (StyleGAN2Generator(size, 512, 8, channel_multiplier),
                StyleGAN2Discriminator(size, channel_multiplier))
    return tuple({k: tuple(v.shape) for k, v in net.state_dict().items()}
                 for net in nets)


def convert(ori, shapes_g, shapes_d):
    """The converted checkpoint of the loaded rosinality ``ori``."""
    out = {}
    if 'g_ema' in ori:
        out['params_ema'] = convert_net_g(ori['g_ema'], shapes_g)
    if 'd' in ori:
        out['params'] = convert_net_d(ori['d'], shapes_d)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ori', required=True,
                        help='rosinality checkpoint (.pt with g_ema / d)')
    parser.add_argument('--size', type=int, default=1024)
    parser.add_argument('--channel_multiplier', type=int, default=2)
    parser.add_argument('--save', required=True)
    args = parser.parse_args(argv)
    # rosinality's files hold their training arguments beside the weights
    with torch.serialization.safe_globals([argparse.Namespace]):
        ori = torch.load(args.ori, map_location='cpu', weights_only=True)
    shapes_g, shapes_d = port_shapes(args.size, args.channel_multiplier)
    torch.save(convert(ori, shapes_g, shapes_d), args.save)
    print('saved', args.save)


if __name__ == '__main__':
    main()
