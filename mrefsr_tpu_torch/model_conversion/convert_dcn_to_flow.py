"""Warm-start a flow-alignment MRAPA checkpoint from a DCN-alignment one,
reference-trained checkpoints included (port of
``scripts/model_conversion/convert_dcn_to_flow.py``)::

    python -m mrefsr_tpu_torch.model_conversion.convert_dcn_to_flow \\
        --input net_g_dcn.pth --output net_g_flow.pth [--deform-groups 8]

Each of ``params`` and ``params_ema`` (or a bare state dict) goes through
``convert.dcn_to_flow_state_dict``, which says what maps to what and when
the warm start is exact; the file's other top-level entries (iteration
counters, metadata) are kept, so that a converted checkpoint still
resumes.
"""
import argparse

import torch

from mrefsr_tpu_torch.convert import dcn_to_flow_state_dict


def convert_checkpoint(ckpt, deform_groups=8):
    """The converted checkpoint of the loaded ``ckpt``."""
    if not isinstance(ckpt, dict):
        raise ValueError('expected a dict checkpoint')
    keys = [k for k in ('params', 'params_ema') if k in ckpt]
    if not keys:
        return dcn_to_flow_state_dict(ckpt, deform_groups=deform_groups)
    return {k: (dcn_to_flow_state_dict(v, deform_groups=deform_groups)
                if k in keys else v) for k, v in ckpt.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--input', required=True)
    parser.add_argument('--output', required=True)
    parser.add_argument('--deform-groups', type=int, default=8)
    args = parser.parse_args(argv)
    ckpt = torch.load(args.input, map_location='cpu', weights_only=True)
    out = convert_checkpoint(ckpt, args.deform_groups)
    torch.save(out, args.output)
    n = len(out.get('params', out.get('params_ema', out)))
    print(f'converted {n} tensors -> {args.output}')


if __name__ == '__main__':
    main()
