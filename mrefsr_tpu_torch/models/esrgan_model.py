"""ESRGANModel: ``SRGANModel`` with the relativistic GAN loss (port of
``mrefsr_tpu/models/esrgan_model.py``, the relativistic branch of the JAX
package's SRGAN step, srgan_model.py:176-189 and :237-245; the
reference's basicsr/models/esrgan_model.py:9-83).

* The generator's term: ``net_d`` judges the output and then ``gt``
  (detached), both under ``frozen_stats``; ``l_g_gan`` is the mean of
  ``gan(real - mean(fake), False)`` and ``gan(fake - mean(real), True)``.
* The discriminator's step keeps the JAX step's two passes, ``gt`` then
  the detached output, both writing the running statistics; each term is
  0.5 ``gan(pred - mean(other pred, detached))``. The reference runs a
  third pass (the output before the real one) whose statistics the JAX
  package and the port leave out (ROADMAP C, "Found in the JAX
  package").
"""
from collections import OrderedDict

from mrefsr_tpu_torch.parallel.batch_norm import frozen_stats
from mrefsr_tpu_torch.utils.registry import MODEL_REGISTRY

from .srgan_model import SRGANModel


@MODEL_REGISTRY.register()
class ESRGANModel(SRGANModel):
    """``SRGANModel`` with the relativistic terms (module docstring)."""

    def g_gan_loss(self, output):
        with frozen_stats(self.net_d):
            fake = self._net_d_forward(output)
            real = self._net_d_forward(self.gt).detach()
        l_g_real = self.cri_gan(real - fake.mean(), False, is_disc=False)
        l_g_fake = self.cri_gan(fake - real.mean(), True, is_disc=False)
        return (l_g_real + l_g_fake) / 2

    def d_losses(self, fake):
        real_pred = self._net_d_forward(self.gt)
        fake_pred = self._net_d_forward(fake)
        return OrderedDict(
            l_d_real=self.cri_gan(real_pred - fake_pred.detach().mean(), True,
                                  is_disc=True) * 0.5,
            l_d_fake=self.cri_gan(fake_pred - real_pred.detach().mean(),
                                  False, is_disc=True) * 0.5,
            out_d_real=real_pred.detach().mean(),
            out_d_fake=fake_pred.detach().mean())
