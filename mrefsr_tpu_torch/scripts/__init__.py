"""The port's command-line scripts, each run as ``python -m
mrefsr_tpu_torch.scripts.<name>`` or ``...scripts.<group>.<name>`` with a
``main(argv=None)``: ``eval_parity`` (the CUFED5 gate), the downloads
(``download_gdrive``, ``download_pretrained_models``), ``publish_models``,
``data_preparation`` (containers, crops, meta-info, degraded and resized
copies, REDS's regrouping, TFRecords, dataset downloads),
``matlab_scripts`` (back-projection, Vimeo-90K's LR frames) and
``metrics`` (PSNR / SSIM, NIQE, LPIPS, FID of a folder or of a StyleGAN2
generator, FID statistics). ``dist_train.sh`` and ``dist_test.sh`` start
the training and test CLIs on one GPU or, through ``torchrun``, on
several."""
