"""BasicVSR++ video inference (port of
``inference/inference_basicvsrpp.py``): the ``main`` of
:mod:`inference_basicvsr` with the REDS configuration of BasicVSR++ (mid
64, 7 blocks, residue 10, low-resolution input).

    python -m mrefsr_tpu_torch.inference.inference_basicvsrpp \\
        --input_path DIR --save_path DIR [--model_path FILE] [--device cpu]
"""
from mrefsr_tpu_torch.archs.basicvsrpp_arch import BasicVSRPlusPlus
from mrefsr_tpu_torch.inference.inference_basicvsr import main as _main

REDS_KWARGS = dict(mid_channels=64, num_blocks=7, max_residue_magnitude=10,
                   is_low_res_input=True)


def main(argv=None):
    return _main(argv, BasicVSRPlusPlus, REDS_KWARGS, 'BasicVSRPP',
                 model_path='experiments/pretrained_models/'
                            'BasicVSRPP_REDS4.pth',
                 save_path='results/BasicVSRPP')


if __name__ == '__main__':
    main()
