"""The CUFED5 accuracy-parity evaluation with its +-0.05 dB gate (port of
``scripts/eval_parity.py``)::

    python -m mrefsr_tpu_torch.scripts.eval_parity \\
        --net_g experiments/pretrained_models/mrapa_restoration.pth \\
        --extractor experiments/pretrained_models/feature_extraction_network.pth \\
        --cufed5 datasets/CUFED/CUFED5 \\
        [--vgg19 experiments/pretrained_models/vgg19-dcbb9e9d.pth] \\
        [--expected-psnr N --expected-psnr-y N --expected-ssim-y N] \\
        [--bf16] [--save-img] [--device cpu]

The reference's released checkpoints (``.pth`` in the reference layout,
loaded as they are) go into ``MultiRefRestorationModel``, and the CUFED5
folder through ``MultiRefCUFEDSet``. The protocol is the reference's
(basicsr/models/multi_ref_restoration_model.py:316-382): zero-pad each
input and its 5 refs to the 500 x 500 canvas, forward, un-pad, then PSNR
(RGB), PSNR_Y and SSIM_Y at ``crop_border`` 4, averaged over the set. On
the card a request runs K1's prologue and match once and K2's forward
three times. The net_map's VGG19 trunk takes torchvision's ``vgg19`` state
dict (``--vgg19``).

Prints one JSON line, ``{"metrics", "gates", "parity_ok"}``: each expected
value given is a gate within ``--tol-db`` (PSNR, PSNR_Y) or ``--tol-ssim``
(SSIM_Y). Exit status 0, or 2 when a gate fails. Runs on the current CUDA
device unless ``--device`` names another.
"""
import argparse
import json
import logging
import os
import os.path as osp
import sys


def build_opt(args):
    """The test options of the evaluation (the JAX script's)."""
    results_root = osp.abspath(args.results_dir)
    opt = {
        'name': 'eval_parity_cufed5',
        'model_type': 'MultiRefRestorationModel',
        'scale': 4, 'crop_border': 4, 'num_gpu': 1, 'manual_seed': 10,
        'is_train': False, 'dist': False, 'rank': 0, 'world_size': 1,
        'datasets': {
            'test_1': {
                'name': 'CUFED5', 'type': 'MultiRefCUFEDSet',
                'dataroot_in': args.cufed5, 'dataroot_ref': args.cufed5,
                'phase': 'test', 'scale': 4, 'pad_to': args.canvas,
            },
        },
        'network_g': {'type': 'MRAPARestorationNet', 'ngf': args.ngf,
                      'n_blocks': args.n_blocks, 'groups': 8},
        'network_map': {'type': 'CorrespondenceGenerationArch',
                        'patch_size': 3, 'stride': 1,
                        'vgg_layer_list': ['relu1_1', 'relu2_1',
                                           'relu3_1'],
                        'vgg_type': 'vgg19'},
        'network_extractor': {'type': 'ContrasMultiExtractorSep'},
        'path': {
            'pretrain_network_g': args.net_g,
            'pretrain_network_feature_extractor': args.extractor,
            'strict_load': True,
            'results_root': results_root,
            'log': results_root,
            'visualization': osp.join(results_root, 'visualization'),
        },
        'val': {'save_img': args.save_img, 'suffix': None},
    }
    if args.vgg19:
        opt['path']['vgg_pretrain_path'] = args.vgg19
    if args.bf16:
        opt['val']['mixed_precision'] = 'bfloat16'
    return opt


def parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--net_g', required=True,
                   help='reference MRAPA restoration .pth')
    p.add_argument('--extractor', required=True,
                   help='reference feature_extraction_network.pth')
    p.add_argument('--cufed5', required=True, help='CUFED5 folder')
    p.add_argument('--vgg19', default=None,
                   help='torchvision vgg19 state dict for net_map')
    p.add_argument('--results-dir', default='results/eval_parity')
    p.add_argument('--save-img', action='store_true')
    p.add_argument('--bf16', action='store_true',
                   help='bfloat16 serving precision (not for the parity '
                        'gate: the reference computes in f32)')
    p.add_argument('--canvas', default='500',
                   help='padded eval canvas (500 = reference protocol); a '
                        'comma list, e.g. 300,400,500, pads to the smallest '
                        'bucket that holds each side (not for the gate)')
    p.add_argument('--ngf', type=int, default=64,
                   help='net_g width (64 = released checkpoints)')
    p.add_argument('--n-blocks', type=int, default=16)
    p.add_argument('--expected-psnr', type=float, default=None)
    p.add_argument('--expected-psnr-y', type=float, default=None)
    p.add_argument('--expected-ssim-y', type=float, default=None)
    p.add_argument('--tol-db', type=float, default=0.05,
                   help='PSNR tolerance in dB (the north-star gate)')
    p.add_argument('--tol-ssim', type=float, default=0.005)
    p.add_argument('--device', default=None,
                   help='torch device (default: the current CUDA device)')
    return p


def gate(metrics, args):
    """``(gates, ok)``: each expected value given against the measured
    one."""
    gates = {}
    ok = True
    for key, expected, tol in (
            ('psnr', args.expected_psnr, args.tol_db),
            ('psnr_y', args.expected_psnr_y, args.tol_db),
            ('ssim_y', args.expected_ssim_y, args.tol_ssim)):
        if expected is None:
            continue
        delta = metrics[key] - expected
        passed = abs(delta) <= tol
        gates[key] = {'expected': expected, 'got': metrics[key],
                      'delta': delta, 'tol': tol, 'pass': passed}
        ok = ok and passed
    return gates, ok


def main(argv=None):
    """Evaluate, print the JSON report and return the exit status: 0, or 2
    when a gate fails."""
    p = parser()
    args = p.parse_args(argv)
    for path in (args.net_g, args.extractor, args.cufed5):
        if not osp.exists(path):
            p.error(f'not found: {path}')
    buckets = [int(v) for v in str(args.canvas).split(',')]
    args.canvas = buckets[0] if len(buckets) == 1 else buckets

    from mrefsr_tpu_torch.data import build_dataloader, build_dataset
    from mrefsr_tpu_torch.models import build_model
    from mrefsr_tpu_torch.utils import resolve_device
    from mrefsr_tpu_torch.utils.logger import get_root_logger

    device = resolve_device(args.device)
    opt = build_opt(args)
    os.makedirs(opt['path']['results_root'], exist_ok=True)
    get_root_logger(log_level=logging.INFO)

    dataset_opt = opt['datasets']['test_1']
    loader = build_dataloader(build_dataset(dataset_opt), dataset_opt)
    model = build_model(opt, device=device)
    model.validation(loader, current_iter=opt['name'], tb_logger=None,
                     save_img=args.save_img)

    metrics = {k: float(v) for k, v in model.metric_results.items()}
    gates, ok = gate(metrics, args)
    print(json.dumps({'metrics': metrics, 'gates': gates,
                      'parity_ok': ok if gates else None}), flush=True)
    return 0 if ok else 2


if __name__ == '__main__':
    sys.exit(main())
