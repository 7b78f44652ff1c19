"""The port's command-line scripts, each run as ``python -m
mrefsr_tpu_torch.scripts.<group>.<name>`` with a ``main(argv=None)``:
``data_preparation`` (packed shards, lmdb) and ``metrics`` (PSNR / SSIM,
NIQE, LPIPS, FID of a folder or of a StyleGAN2 generator, FID
statistics)."""
