"""The GAN trajectory checks of test_torch_gan.py on the ``flow``
alignment, with the perceptual and style losses on the seeded VGG19 (a
file of its own, so that its JAX compile runs beside the ``dcn`` one)."""
import pytest
import torch

import test_torch_gan as gan


@pytest.fixture(autouse=True, scope='module')
def _two_torch_threads():
    """The test workers of one run share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope='module')
def trajectory():
    return gan.run_trajectory('flow')


test_gan_logs_match_jax = gan.test_gan_logs_match_jax
test_gan_parameters_match_jax = gan.test_gan_parameters_match_jax
test_gan_running_statistics_match_jax = \
    gan.test_gan_running_statistics_match_jax
test_plain_batch_norm_fails_the_gan_step = \
    gan.test_plain_batch_norm_fails_the_gan_step
test_gan_schedules_count_each_optimizer_s_updates = \
    gan.test_gan_schedules_count_each_optimizer_s_updates
