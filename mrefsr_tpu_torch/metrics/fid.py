"""FID, the Frechet Inception Distance (port of ``mrefsr_tpu/metrics/fid.py``,
the reference's basicsr/metrics/fid.py:10-93): the features of the port's
FID Inception (``archs/inception.py``) on the model's device, the distance
in numpy / scipy on the host."""
import numpy as np
import torch
from scipy import linalg

from mrefsr_tpu_torch.archs.inception import InceptionV3
from mrefsr_tpu_torch.utils import resolve_device
from mrefsr_tpu_torch.utils.registry import METRIC_REGISTRY


def load_patched_inception_v3(weights_path=None, resize_input=True,
                              normalize_input=False, device=None, seed=0):
    """The FID Inception extractor (its 2048-channel pool) in eval mode on
    ``device`` (the card unless named): a ``pt_inception`` ``.pth``'s
    weights (its ``AuxLogits`` and ``fc`` heads left out) where
    ``weights_path`` names one, else seeded stand-in weights from ``seed``
    (reference fid.py:10-16)."""
    from mrefsr_tpu_torch.convert import load_torch_state_dict
    device = resolve_device(device)
    with torch.device('meta'):
        net = InceptionV3(output_blocks=(3,), resize_input=resize_input,
                          normalize_input=normalize_input)
    net.to_empty(device=device)
    net.init_weights(torch.Generator().manual_seed(seed))
    if weights_path is not None:
        state = load_torch_state_dict(weights_path, param_key=None)
        state = {k: v for k, v in state.items()
                 if not k.startswith(('AuxLogits', 'fc'))}
        for key, val in net.state_dict().items():
            if key.endswith('num_batches_tracked'):
                state.setdefault(key, val)
        net.load_state_dict(state, strict=True)
    return net.eval().requires_grad_(False)


@torch.inference_mode()
def extract_inception_features(data_generator, inception,
                               len_generator=None):
    """The (N, 2048) float32 features of every batch of
    ``data_generator`` (NHWC arrays, or tensors on any device, in the
    range ``inception`` takes) through ``inception`` on its device
    (reference fid.py:19-47). A tensor on that device is used in place."""
    device = next(inception.parameters()).device
    features = []
    for data in data_generator:
        if torch.is_tensor(data):
            x = data.to(device=device, dtype=torch.float32)
        else:
            x = torch.as_tensor(np.asarray(data, np.float32), device=device)
        feat = inception(x.permute(0, 3, 1, 2))[0]
        features.append(feat.reshape(feat.shape[0], -1).cpu().numpy())
    return np.concatenate(features, axis=0)


def load_fid_stats(path):
    """``(mean, cov)`` as float64 arrays from a statistics ``.pth`` (a
    dict with ``mean`` and ``cov``), numpy arrays as the reference and
    the stats CLI write them, or tensors. The file is read with
    ``weights_only``, numpy's arrays allowed."""
    core = getattr(np, '_core', None) or np.core
    allowed = [core.multiarray._reconstruct, np.ndarray, np.dtype,
               type(np.dtype(np.float64)), type(np.dtype(np.float32))]
    with torch.serialization.safe_globals(allowed):
        stats = torch.load(path, map_location='cpu', weights_only=True)
    return (np.asarray(stats['mean'], np.float64),
            np.asarray(stats['cov'], np.float64))


@METRIC_REGISTRY.register()
def calculate_fid(mu1, sigma1, mu2, sigma2, eps=1e-6):
    """The Frechet distance between the Gaussians (mu1, sigma1) and (mu2,
    sigma2) (reference fid.py:50-93): where the product of the covariances
    is singular, ``eps`` on both diagonals."""
    assert mu1.shape == mu2.shape, \
        'Two mean vectors have different lengths'
    assert sigma1.shape == sigma2.shape, \
        'Two covariances have different dimensions'
    cov_sqrt = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(cov_sqrt).all():
        print(f'Product of cov matrices is singular. Adding {eps} to '
              'diagonal of cov estimates')
        offset = np.eye(sigma1.shape[0]) * eps
        cov_sqrt = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(cov_sqrt):
        if not np.allclose(np.diagonal(cov_sqrt).imag, 0, atol=1e-3):
            m = np.max(np.abs(cov_sqrt.imag))
            raise ValueError(f'Imaginary component {m}')
        cov_sqrt = cov_sqrt.real
    mean_diff = mu1 - mu2
    mean_norm = mean_diff @ mean_diff
    trace = np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(cov_sqrt)
    return mean_norm + trace
