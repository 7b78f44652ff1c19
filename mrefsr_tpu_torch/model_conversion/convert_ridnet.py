"""Convert the official RIDNet checkpoint into the reference's keys (port
of ``scripts/model_conversion/convert_ridnet.py``, the reference's)::

    python -m mrefsr_tpu_torch.model_conversion.convert_ridnet \\
        [--ori RIDNet_official_original.pt] [--save RIDNet.pth]

The official module graph lists its tensors in the order of the
reference's, so the mapping is positional: the official file's i-th
tensor takes the i-th key of the port's ``RIDNet(3, 64, 3)`` (whose
modules are defined in the reference's order). Writes ``{'params':
state_dict}``.
"""
import argparse
from collections import OrderedDict

import torch

from mrefsr_tpu_torch.archs.ridnet_arch import RIDNet


def ridnet_key_order():
    """The reference-layout keys in the order of the module's
    definition, weight before bias."""
    with torch.device('meta'):
        return list(RIDNet(3, 64, 3).state_dict())


def convert_ridnet(ori_sd, names):
    """The official tensors under ``names``, one for one in order
    (reference convert_ridnet.py:16-19)."""
    if len(ori_sd) != len(names):
        raise ValueError(f'official checkpoint has {len(ori_sd)} tensors, '
                         f'reference layout has {len(names)}')
    return OrderedDict(zip(names, ori_sd.values()))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--ori', type=str, default=(
        'experiments/pretrained_models/RIDNet/RIDNet_official_original.pt'))
    parser.add_argument('--save', type=str, default=(
        'experiments/pretrained_models/RIDNet/RIDNet.pth'))
    args = parser.parse_args(argv)
    ori = torch.load(args.ori, map_location='cpu', weights_only=True)
    new_dict = convert_ridnet(ori, ridnet_key_order())
    torch.save({'params': new_dict}, args.save)
    print(f'converted {len(new_dict)} tensors')


if __name__ == '__main__':
    main()
