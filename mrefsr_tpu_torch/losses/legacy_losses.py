"""The loss module the Ref/MultiRef models fetch from by name (port of
``mrefsr_tpu/losses/legacy_losses.py``). Only the pixel losses are ported;
the perceptual, style, texture and GAN losses wait for the GAN phase
(ROADMAP A9)."""
from .losses import L1Loss, MSELoss  # noqa: F401
