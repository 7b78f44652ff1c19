"""The test CLI (port of ``mrefsr_tpu/test.py``, the reference's
``basicsr/test.py:11-45``)::

    python -m mrefsr_tpu_torch.test -opt options/test/<yml> [--device cpu]

builds every test set of the YAML and one model, and validates the model
on each set in turn, writing the outputs where ``val.save_img`` is set
(default true) under ``path.results_root``. With ``--launcher pytorch``
the images are sharded over the ranks."""
import logging
from os import path as osp

from mrefsr_tpu_torch.data import build_dataloader, build_dataset
from mrefsr_tpu_torch.models import build_model
from mrefsr_tpu_torch.utils import resolve_device
from mrefsr_tpu_torch.utils.logger import get_env_info, get_root_logger
from mrefsr_tpu_torch.utils.misc import get_time_str, make_exp_dirs
from mrefsr_tpu_torch.utils.options import dict2str, parse_options


def test_pipeline(root_path, args=None):
    """Evaluate as the options of the command line ``args``
    (``sys.argv[1:]`` by default) say; returns the model, whose
    ``metric_results`` hold the last set's averages."""
    opt, cli_args = parse_options(root_path, is_train=False, args=args)
    device = resolve_device(cli_args.device)

    make_exp_dirs(opt)
    log_file = osp.join(opt['path']['log'],
                        f"test_{opt['name']}_{get_time_str()}.log")
    logger = get_root_logger(log_level=logging.INFO, log_file=log_file)
    logger.info(get_env_info())
    logger.info(dict2str(opt))

    test_loaders = []
    for _, dataset_opt in sorted(opt['datasets'].items()):
        test_set = build_dataset(dataset_opt)
        test_loaders.append(build_dataloader(test_set, dataset_opt))
        logger.info(f'Number of test images in '
                    f"{dataset_opt['name']}: {len(test_set)}")

    model = build_model(opt, device=device)
    save_img = (opt.get('val') or {}).get('save_img', True)
    for test_loader in test_loaders:
        logger.info(f"Testing {test_loader.dataset.opt['name']}...")
        model.validation(test_loader, current_iter=opt['name'],
                         tb_logger=None, save_img=save_img)
    return model


if __name__ == '__main__':
    test_pipeline(osp.abspath(osp.join(__file__, osp.pardir, osp.pardir)))
