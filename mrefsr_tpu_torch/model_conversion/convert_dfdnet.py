"""Convert the official DFDNet weights into the port's ``DFDNet`` key
layout (port of ``scripts/model_conversion/convert_dfdnet.py``; the VGG
layer names from the port's ``archs/vgg_arch.py``)::

    python -m mrefsr_tpu_torch.model_conversion.convert_dfdnet \\
        --ori DFDNet_official.pth --save DFDNet.pth

The target keys and shapes are the port's ``DFDNet(num_feat=64)``'s; the
result loads into it with ``load_state_dict(strict=True)`` (``params``).
"""
import argparse

import torch

from mrefsr_tpu_torch.archs.vgg_arch import NAMES

PART_MAP = {'left_eye': 'le', 'right_eye': 're', 'mouth': 'mo',
            'nose': 'no'}


def convert_net(ori_net, crt_keys_and_shapes):
    """Official DFDNet -> the port's keys. ``crt_keys_and_shapes`` is
    ``{port_key: shape}``; a key of no known family is printed and left
    out, a tensor of another shape raises."""
    out = {}
    for crt_k, shape in crt_keys_and_shapes.items():
        if 'vgg_extractor' in crt_k:
            if 'mean' in crt_k:
                ori_k = 'VggExtract.RGB_mean'
            elif 'std' in crt_k:
                ori_k = 'VggExtract.RGB_std'
            else:
                idx = NAMES['vgg19'].index(crt_k.split('.')[2])
                leaf = 'weight' if 'weight' in crt_k else 'bias'
                ori_k = f'VggExtract.model.features.{idx}.{leaf}'
        elif 'attn_blocks' in crt_k:
            ori_k = crt_k
            for part, short in PART_MAP.items():
                if part in crt_k:
                    ori_k = crt_k.replace(f'attn_blocks.{part}', short)
                    break
        elif 'multi_scale_dilation' in crt_k:
            if 'conv_blocks' in crt_k:
                _, _, c, d, e = crt_k.split('.')
                ori_k = f'MSDilate.conv{int(c) + 1}.{d}.{e}'
            else:
                ori_k = crt_k.replace('multi_scale_dilation.conv_fusion',
                                      'MSDilate.convi')
        elif crt_k.startswith('upsample'):
            ori_k = crt_k.replace('upsample', 'up')
            if 'scale_block' in crt_k:
                ori_k = ori_k.replace('scale_block', 'ScaleModel1')
            elif 'shift_block' in crt_k:
                ori_k = ori_k.replace('shift_block', 'ShiftModel1')
            elif 'upsample4' in crt_k and 'body' in crt_k:
                ori_k = ori_k.replace('body', 'Model')
        else:
            print('unprocessed key: ', crt_k)
            continue
        if tuple(ori_net[ori_k].shape) != tuple(shape):
            raise ValueError(f'Wrong tensor size for {crt_k}: {tuple(shape)} '
                             f'vs {tuple(ori_net[ori_k].shape)}')
        out[crt_k] = ori_net[ori_k]
    return out


def port_shapes(num_feat=64):
    """``{key: shape}`` of the port's DFDNet (built on ``meta``)."""
    from mrefsr_tpu_torch.archs.dfdnet_arch import DFDNet
    with torch.device('meta'):
        net = DFDNet(num_feat)
    return {k: tuple(v.shape) for k, v in net.state_dict().items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ori', required=True,
                        help='the official DFDNet checkpoint')
    parser.add_argument('--save', required=True)
    args = parser.parse_args(argv)
    ori = torch.load(args.ori, map_location='cpu', weights_only=True)
    shapes = port_shapes()
    torch.save({'params': convert_net(ori, shapes)}, args.save)
    print('saved', args.save)


if __name__ == '__main__':
    main()
