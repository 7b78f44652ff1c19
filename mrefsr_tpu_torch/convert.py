"""Carry weights into the port's modules.

Two sources, both in the reference's torch key layout, which the port's
modules keep (so ``load_state_dict(strict=True)`` takes them unchanged):

* a reference-format ``.pth`` (:func:`load_torch_state_dict`);
* the flax parameter tree of the JAX package (:func:`state_dict_from_flax`,
  numpy in, torch state dict out): a kernel ``(kh, kw, I, O)`` becomes the
  weight ``(O, I, kh, kw)`` (a 3-D one ``(kd, kh, kw, I, O)`` the weight
  ``(O, I, kd, kh, kw)``), a dense kernel ``(I, O)`` becomes ``(O, I)``,
  a norm scale becomes ``weight``, anything else keeps its leaf name
  (DynAgg's and FlowAgg's parameters included);
  :func:`stylegan2_state_dict_from_flax` adds what the StyleGAN2 nets
  need on top, :func:`state_dict_from_flax_variables` a net's batch-norm
  statistics and spectral-norm vectors (the discriminators'),
  :func:`vgg_style_discriminator_state_dict_from_flax` the permutation of
  ``VGGStyleDiscriminator``'s ``linear1``, and :func:`load_from_flax`
  loads a net whose constant buffers flax does not hold (SpyNet's
  ImageNet mean and std, in the video nets; SwinIR's
  ``relative_position_index`` and ``attn_mask``), through
  :func:`net_state_dict_from_flax` (ECBSR's edge ``scale`` keeps its name,
  :func:`ecbsr_state_dict_from_flax`).

:func:`state_dict_from_flax_with_counts` takes HiFaceGAN's nets and the FID
Inception from their flax variables, :func:`lpips_state_dict_from_flax`
LPIPS's.

:func:`dcn_to_flow_state_dict` warm-starts a flow-alignment net from a
DCN-alignment checkpoint.

A copy of the numpy-only half of ``mrefsr_tpu/convert.py``, so the port
imports nothing of the JAX package.
"""
import numpy as np
import torch


def load_torch_state_dict(path, param_key='params'):
    """Load a reference-format ``.pth``: ``{param_key: state_dict}`` or a
    bare state dict, with ``module.`` prefixes stripped. Asking for
    ``params_ema`` from a file that holds only ``params`` takes ``params``
    (reference base_model.py:294-297); ``param_key=None`` takes the file
    as a bare state dict. Returns ``{key: tensor}`` on the CPU."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if param_key is not None and isinstance(ckpt, dict):
        if param_key not in ckpt and param_key == 'params_ema' \
                and isinstance(ckpt.get('params'), dict):
            param_key = 'params'
        if isinstance(ckpt.get(param_key), dict):
            ckpt = ckpt[param_key]
    out = {}
    for k, v in ckpt.items():
        if isinstance(v, dict):
            raise ValueError(
                f'{path} is a wrapped checkpoint (keys {list(ckpt)}); '
                f'pass param_key to select one (got {param_key!r})')
        out[k[7:] if k.startswith('module.') else k] = torch.as_tensor(v)
    return out


def drop_buffer_keys(key):
    """Rename hook for extractor checkpoints: drop the reference's ImageNet
    mean/std buffers (contras_extractor_arch.py:31-38), which are
    constants here."""
    if key.endswith('.mean') or key.endswith('.std') or key in ('mean',
                                                                'std'):
        return None
    return key


def rename_keys(state_dict, rename):
    """Apply ``rename(key) -> key or None`` (None drops the entry)."""
    out = {}
    for key, val in state_dict.items():
        key = rename(key)
        if key is not None:
            out[key] = val
    return out


def _flatten(tree):
    """Nested dict -> ``{dotted_key: np.ndarray}``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            p = f'{prefix}.{k}' if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat[p] = np.asarray(v)

    walk(tree, '')
    return flat


def flax_to_torch(params):
    """Flax parameter tree -> ``{torch_key: np.ndarray}``."""
    out = {}
    for key, val in _flatten(params).items():
        base, dot, leaf = key.rpartition('.')
        if leaf == 'kernel':
            if val.ndim == 5:  # conv DHWIO -> OIDHW
                val = val.transpose(4, 3, 0, 1, 2)
            elif val.ndim == 4:  # conv HWIO -> OIHW
                val = val.transpose(3, 2, 0, 1)
            elif val.ndim == 2:  # dense (I, O) -> (O, I)
                val = val.transpose(1, 0)
            else:
                raise ValueError(f'{key}: no torch layout for a '
                                 f'{val.ndim}-D kernel')
            out[f'{base}{dot}weight'] = val
        elif leaf == 'scale':
            out[f'{base}{dot}weight'] = val
        else:
            out[key] = val
    return out


def state_dict_from_flax(params):
    """Flax parameter tree (e.g. ``variables['params']``) -> a torch state
    dict of contiguous float tensors, ready for
    ``load_state_dict(strict=True)``."""
    return {k: torch.tensor(v) for k, v in flax_to_torch(params).items()}


def state_dict_from_flax_variables(variables):
    """A flax net's variables, ``params`` and (where it has batch norms)
    ``batch_stats`` and (where it has spectral-norm convs) ``spectral``,
    -> a torch state dict: :func:`state_dict_from_flax` of the parameters
    (a norm's ``scale`` / ``bias`` become ``weight`` / ``bias``), each
    norm's ``mean`` / ``var`` its ``running_mean`` / ``running_var``, and
    each spectral-norm conv's kernel its ``weight_orig``, its ``u`` / ``v``
    its ``weight_u`` / ``weight_v`` (torch's ``spectral_norm`` names,
    which the port's ``SNConv2d`` and a reference ``.pth`` share). flax
    counts no batches: a norm of the port fills its
    ``num_batches_tracked`` with 0."""
    out = state_dict_from_flax(variables['params'])
    names = {'mean': 'running_mean', 'var': 'running_var',
             'u': 'weight_u', 'v': 'weight_v'}
    for collection in ('batch_stats', 'spectral'):
        for key, val in _flatten(variables.get(collection) or {}).items():
            base, _, leaf = key.rpartition('.')
            if leaf not in names or (leaf in ('u', 'v')) != (
                    collection == 'spectral'):
                raise ValueError(f'{collection}.{key}: no torch buffer '
                                 'for it')
            out[f'{base}.{names[leaf]}'] = torch.tensor(val)
            if leaf == 'u':
                out[f'{base}.weight_orig'] = out.pop(f'{base}.weight')
    return out


def nhwc_dense_to_nchw(weight, channels):
    """A torch dense weight ``(O, H * W * C)`` that reads a map flattened
    NHWC -> the weight ``(O, C * H * W)`` that reads torch's NCHW flatten
    of the same map (H = W)."""
    out = weight.shape[0]
    side = round((weight.shape[1] // channels) ** 0.5)
    return weight.reshape(out, side, side, channels).transpose(0, 3, 1, 2) \
        .reshape(out, -1)


def vgg_style_discriminator_state_dict_from_flax(variables):
    """The JAX package's ``VGGStyleDiscriminator`` variables -> the port's
    state dict: :func:`state_dict_from_flax_variables`, and ``linear1``
    permuted from the NHWC flatten the JAX net applies to the NCHW one
    (:func:`nhwc_dense_to_nchw`; the last map has ``num_feat * 8``
    channels)."""
    state = state_dict_from_flax_variables(variables)
    state['linear1.weight'] = torch.from_numpy(np.ascontiguousarray(
        nhwc_dense_to_nchw(state['linear1.weight'].numpy(),
                           state['bn0_1.weight'].shape[0] * 8)))
    return state


def ecbsr_state_dict_from_flax(params):
    """The JAX package's ``ECBSR`` parameters -> the port's state dict:
    :func:`state_dict_from_flax`, but an edge branch's ``scale`` (a
    ``(out, 1, 1, 1)`` parameter of ``conv1x1_sbx`` / ``_sby`` / ``_lpl``)
    keeps its name rather than becoming a norm's ``weight``. The branches'
    ``k0`` / ``b0`` / ``k1`` / ``b1`` and ``mask`` are OIHW on both
    sides."""
    edges = ('.conv1x1_sbx', '.conv1x1_sby', '.conv1x1_lpl')
    return {(key[:-len('weight')] + 'scale'
             if key.endswith('.weight') and key[:-len('.weight')].endswith(
                 edges) else key): val
            for key, val in state_dict_from_flax(params).items()}


def net_state_dict_from_flax(net, params):
    """The state dict of flax ``params`` for the port net ``net``:
    :func:`state_dict_from_flax`, or a net's own conversion where it needs
    one (:func:`ecbsr_state_dict_from_flax`)."""
    if type(net).__name__ == 'ECBSR':
        return ecbsr_state_dict_from_flax(params)
    return state_dict_from_flax(params)


def load_from_flax(net, params):
    """Load flax parameters into a port net strictly: every parameter must
    be there and nothing else. The net's buffers that the tree lacks keep
    their values: a reference ``.pth`` carries SpyNet's ``mean`` and
    ``std``, a flax tree does not."""
    return load_keeping_buffers(net, net_state_dict_from_flax(net, params))


def load_keeping_buffers(net, state):
    """Load ``state`` into ``net`` strictly, but for the net's buffers that
    ``state`` lacks, which keep their values (a SwinIR ``.pth`` without
    its ``relative_position_index`` and ``attn_mask``). Returns ``net``."""
    buffers = dict(net.named_buffers())
    for key, val in net.state_dict().items():
        if key in buffers:
            state.setdefault(key, val)
    net.load_state_dict(state, strict=True)
    return net


def stylegan2_state_dict_from_flax(params):
    """Flax parameters of the JAX package's ``StyleGAN2Generator`` or
    ``StyleGAN2Discriminator`` -> a torch state dict with the reference's
    names and shapes: :func:`flax_to_torch`, then the inverse of the JAX
    package's ``stylegan2_rename`` and of its loader's fix-ups:
    ``modulated_conv.mod_weight`` -> ``modulated_conv.weight`` (already
    (1, out, in, k, k)), ``constant_input.const`` NHWC ->
    ``constant_input.weight`` NCHW, ``noises.noise{i}`` NHWC -> NCHW."""
    out = {}
    for key, val in flax_to_torch(params).items():
        if key.endswith('modulated_conv.mod_weight'):
            key = key[:-len('mod_weight')] + 'weight'
        elif key == 'constant_input.const':
            key, val = 'constant_input.weight', val.transpose(0, 3, 1, 2)
        elif key.startswith('noises.noise'):
            val = val.transpose(0, 3, 1, 2)
        out[key] = torch.tensor(np.ascontiguousarray(val))
    return out


def load_stylegan2_from_flax(net, params):
    """Load the JAX package's flax parameters into the port's StyleGAN2
    generator or discriminator, strictly: every parameter must be there
    and nothing else. Only the generator's ``noises.noise{i}`` buffers may
    be missing (flax holds them only when it was initialised with
    ``randomize_noise=False``); they keep their values."""
    state = stylegan2_state_dict_from_flax(params)
    own = net.state_dict()
    for key in own:
        if key.startswith('noises.noise') and key not in state:
            state[key] = own[key]
    net.load_state_dict(state, strict=True)


def state_dict_from_flax_with_counts(variables):
    """:func:`state_dict_from_flax_variables` with a zero
    ``num_batches_tracked`` beside each ``running_mean``, for nets whose
    norms are torch's own (flax counts no batches): HiFaceGAN's (SPADE's
    ``batch`` norm) and the FID Inception's. DFDNet's variables (the
    spectral-norm convs' ``u`` / ``v``) take
    :func:`state_dict_from_flax_variables` as they are."""
    state = state_dict_from_flax_variables(variables)
    for key in [k for k in state if k.endswith('.running_mean')]:
        state.setdefault(key[:-len('running_mean')] + 'num_batches_tracked',
                         torch.tensor(0, dtype=torch.long))
    return state


def lpips_state_dict_from_flax(variables):
    """The JAX package's ``LPIPSVgg`` variables -> the port's state dict:
    the VGG16 tower under ``vgg.``, each head ``lin{i}`` (C,) as the
    official ``lin{i}.model.1.weight`` (1, C, 1, 1)."""
    params = dict(variables['params'])
    state = {'vgg.' + k: v for k, v in
             state_dict_from_flax(params.pop('vgg')).items()}
    for name, weight in params.items():
        state[f'{name}.model.1.weight'] = torch.tensor(
            np.asarray(weight)).reshape(1, -1, 1, 1)
    return state


def dcn_to_flow_state_dict(sd, deform_groups=8, kernel_size=3):
    """Warm-start a flow-alignment (FlowAgg) state dict from a
    DCN-alignment (DynAgg) one, in the reference's torch key layout
    (copy of ``mrefsr_tpu/convert.py::dcn_to_flow_state_dict``).

    The pre-offsets are tap-shifted copies of one flow field, so a DynAgg
    whose learned offset residual is zero is a 3x3 conv over the
    flow-warped ref, which is FlowAgg's structure. Per ``*_dyn_agg``:

    * ``conv_flow_gate`` flow rows <- the centre-tap offset rows of
      ``conv_offset_mask``, per deform group; gate rows <- zero (gate 0.5);
    * ``conv_after_warp.weight[o, ci, ky, kx]`` <- ``weight * 2 *
      sigmoid(mask_bias[g, t])`` with ``g = ci // cg``, ``t = ky*K + kx``
      (the 2 makes up for the 0.5 gate); ``conv_after_warp.bias`` <- bias;
    * every other tensor passes through.

    Dropped: the other taps' offset residuals and the part of the mask
    that depends on the features. Exact for interior pixels when the
    offset residual is zero and the flow is constant.

    ``sd`` holds torch tensors or numpy arrays; the result holds the same
    kind, with FlowAgg keys.
    """
    k2 = kernel_size * kernel_size
    dg = deform_groups
    center = (kernel_size // 2) * kernel_size + kernel_size // 2

    def as_numpy(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    def like(arr, ref):
        return torch.from_numpy(np.ascontiguousarray(arr)) \
            if isinstance(ref, torch.Tensor) else arr

    suffix = '_dyn_agg.conv_offset_mask.weight'
    bases = sorted({key[:-len('.conv_offset_mask.weight')] for key in sd
                    if key.endswith(suffix)})
    out, converted = {}, set()
    for base in bases:
        w_om = as_numpy(sd[f'{base}.conv_offset_mask.weight'])
        b_om = as_numpy(sd[f'{base}.conv_offset_mask.bias'])
        w_dyn = as_numpy(sd[f'{base}.weight'])
        b_dyn = as_numpy(sd[f'{base}.bias'])
        cin = w_dyn.shape[1]
        if w_om.shape[0] != 3 * dg * k2 or cin % dg:
            raise ValueError(
                f'{base}: conv_offset_mask has {w_om.shape[0]} outputs and '
                f'the conv {cin} inputs; expected 3*dg*K = {3 * dg * k2} '
                f'and a multiple of dg = {dg}')
        cg = cin // dg

        w_fg = np.zeros((dg * 3,) + w_om.shape[1:], w_om.dtype)
        b_fg = np.zeros((dg * 3,), b_om.dtype)
        for g in range(dg):
            for j in range(2):  # (dy, dx)
                src = g * 2 * k2 + 2 * center + j
                w_fg[2 * g + j] = w_om[src]
                b_fg[2 * g + j] = b_om[src]

        mask_bias = b_om[2 * dg * k2:].reshape(dg, k2)
        m_hat = 1.0 / (1.0 + np.exp(-mask_bias))            # (dg, K)
        scale = np.repeat(2.0 * m_hat, cg, axis=0)          # (cin, K)
        scale = scale.reshape(cin, kernel_size, kernel_size)
        w_cv = (w_dyn * scale[None]).astype(w_dyn.dtype)

        flow_base = base.replace('_dyn_agg', '_flow_agg')
        ref = sd[f'{base}.weight']
        out[f'{flow_base}.conv_flow_gate.weight'] = like(w_fg, ref)
        out[f'{flow_base}.conv_flow_gate.bias'] = like(b_fg, ref)
        out[f'{flow_base}.conv_after_warp.weight'] = like(w_cv, ref)
        out[f'{flow_base}.conv_after_warp.bias'] = like(b_dyn.copy(), ref)
        converted.update({f'{base}.conv_offset_mask.weight',
                          f'{base}.conv_offset_mask.bias',
                          f'{base}.weight', f'{base}.bias'})

    for key, val in sd.items():
        if key not in converted:
            if '_dyn_agg' in key:
                raise ValueError(f'unmapped DynAgg key {key}')
            out[key] = val
    return out
