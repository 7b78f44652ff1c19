"""Dense input<->ref patch correlation with top-1 matching.

Port of ``mrefsr_tpu/ops/correlation.py``. Features are ``(..., H, W, C)``
(the JAX package's ``(H, W, C)``, with optional leading batch dims that
are matched pair by pair). A match runs in two steps. The prologue unfolds
both sides into patch matrices, divides each ref patch by its norm plus
1e-5 and takes each input patch's norm: on a CUDA tensor in one kernel,
``csrc/feature_match_prologue.cu``, on a CPU tensor in
:func:`_prologue_ref` (``sample_patches``, ``l2_norm``, ``add_scalar``).
Then the scores and the running max/argmax over ref patches: on a CUDA
tensor in ``csrc/feature_match.cu`` (f32, 3xTF32) or
``csrc/feature_match_bf16.cu`` (bf16), both on wgmma fed by TMA through the
walk of ``csrc/feature_match_wgmma.cuh``, on a CPU tensor in
:func:`_match_patches_ref` (a chunked matmul with a running max, as the JAX
scan does). Only ``val / (norm + 1e-5)`` of ``norm_input`` stays in
PyTorch.

:func:`feature_match_index_sharded` matches against one rank's band of
reference rows behind the same prologue and with the same match kernel,
launched through its own entry point, and fuses the ranks' answers with two
``torch.distributed`` all-reduces.

Features may be float32 or bfloat16, as in the JAX package: at bf16 the
patches stay bf16, the norms are bf16 arithmetic rounded where XLA rounds
them (:func:`l2_norm`), and the scores are f32 sums of the exact f32
products of bf16 values (``preferred_element_type=jnp.float32``): on the
tensor cores in the kernel, through an f32 matmul of the widened patches in
the plain version. Each dtype has its own entry points.
"""
import ctypes

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ._build import Kernel

# pin, pref, pairs, n_in, n_ref, d, ld, idx, val, stream; at f32 a scratch
# pointer before idx (the hi / lo split)
_MATCH_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 3)
_MATCH_F32_ARGTYPES = _MATCH_ARGTYPES[:7] + [ctypes.c_void_p] * 4
_PROLOGUE_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 11
                      + [ctypes.c_float] + [ctypes.c_void_p] * 4)
# K1's prologue: the unfold and the norms, shared by K1 and K6
feature_match_prologue_kernel = Kernel(
    'feature_match_prologue', 'feature_match_prologue_launch',
    _PROLOGUE_ARGTYPES)
feature_match_prologue_bf16_kernel = Kernel(
    'feature_match_prologue', 'feature_match_prologue_bf16_launch',
    _PROLOGUE_ARGTYPES)
# K1 at f32: 3xTF32 on the tensor cores (wgmma fed by TMA)
feature_match_kernel = Kernel('feature_match', 'feature_match_launch',
                              _MATCH_F32_ARGTYPES)
# the same kernel, counted apart: the sharded match's per-rank launches
feature_match_sharded_kernel = Kernel(
    'feature_match', 'feature_match_sharded_launch', _MATCH_F32_ARGTYPES)
# K1 and K6 on bf16 patches: wgmma fed by TMA
feature_match_bf16_kernel = Kernel(
    'feature_match_bf16', 'feature_match_bf16_launch', _MATCH_ARGTYPES)
feature_match_sharded_bf16_kernel = Kernel(
    'feature_match_bf16', 'feature_match_sharded_bf16_launch',
    _MATCH_ARGTYPES)
# (single-device kernel, sharded kernel) by the patches' dtype
_KERNELS = {torch.float32: (feature_match_kernel,
                            feature_match_sharded_kernel),
            torch.bfloat16: (feature_match_bf16_kernel,
                             feature_match_sharded_bf16_kernel)}
_PROLOGUES = {torch.float32: feature_match_prologue_kernel,
              torch.bfloat16: feature_match_prologue_bf16_kernel}
INT32_MAX = torch.iinfo(torch.int32).max


def l2_norm(x, dim, keepdim=False):
    """The L2 norm over ``dim`` as ``jnp.linalg.norm`` gives it in x's
    dtype. For bf16, XLA on the CPU squares and sums in f32, rounds the sum
    to bf16, takes the root in f32 and rounds it to bf16 (read from the
    compiled HLO of a bf16 norm; it gives the JAX norm bit for bit)."""
    if x.dtype == torch.float32:
        return torch.linalg.vector_norm(x, dim=dim, keepdim=keepdim)
    sq = x.float().square().sum(dim, keepdim=keepdim).to(x.dtype)
    return sq.float().sqrt().to(x.dtype)


def add_scalar(x, eps):
    """``x + eps`` with the constant rounded to x's dtype first, as JAX
    takes a Python float into a bf16 expression (the sum is then taken in
    f32 and rounded, by XLA and by PyTorch alike)."""
    return x + float(torch.tensor(eps, dtype=x.dtype))


def sample_patches(feat, patch_size=3, stride=1):
    """Sliding patches, row-major: ``(..., H, W, C)`` ->
    ``(..., n_patches, patch_size * patch_size * C)``, element order
    ``(i, j, c)`` as in the JAX package."""
    h, w, c = feat.shape[-3:]
    ph = (h - patch_size) // stride + 1
    pw = (w - patch_size) // stride + 1
    taps = [feat[..., i:i + (ph - 1) * stride + 1:stride,
                 j:j + (pw - 1) * stride + 1:stride, :]
            for i in range(patch_size) for j in range(patch_size)]
    patches = torch.stack(taps, dim=-2)  # (..., ph, pw, k, c)
    return patches.reshape(feat.shape[:-3]
                           + (ph * pw, patch_size * patch_size * c))


def _patch_count(h, w, patch_size, stride):
    """The patch grid of an ``(h, w)`` map: ``(rows, columns)``."""
    return (h - patch_size) // stride + 1, (w - patch_size) // stride + 1


def _prologue_ref(feat_input, feat_ref, patch_size, input_stride,
                  ref_stride, is_norm):
    """Plain version of the prologue kernel: ``(..., H, W, C)`` features ->
    ``pin (P, n_in, d)`` the input patches, ``pref (P, n_ref, d)`` the ref
    patches over their norm + 1e-5 (raw unless ``is_norm``), and
    ``norm (P, n_in)`` the input patches' norms, all in the features'
    dtype, rounded as the JAX package rounds them at bf16."""
    pin = sample_patches(feat_input, patch_size, input_stride)
    pref = sample_patches(feat_ref, patch_size, ref_stride)
    pin = pin.reshape((-1,) + pin.shape[-2:])
    pref = pref.reshape((-1,) + pref.shape[-2:])
    if is_norm:
        pref = pref / add_scalar(l2_norm(pref, 2, keepdim=True), 1e-5)
    return pin, pref, l2_norm(pin, 2)


def _prologue_cuda(feat_input, feat_ref, patch_size, input_stride,
                   ref_stride, is_norm):
    """The prologue kernel, same contract as :func:`_prologue_ref`. The
    patch matrices are views ``[..., :d]`` of buffers whose rows are padded
    with zeros to a multiple of 8 elements, the layout the match kernels
    load (16-byte rows)."""
    dtype = feat_input.dtype
    if dtype not in _PROLOGUES or feat_ref.dtype != dtype:
        raise TypeError('feature_match takes float32 or bfloat16 features '
                        f'of one dtype, got {dtype} and {feat_ref.dtype}')
    if feat_ref.device != feat_input.device:
        raise ValueError(f'features on {feat_input.device} and '
                         f'{feat_ref.device}')
    fin = feat_input.reshape((-1,) + feat_input.shape[-3:]).contiguous()
    fref = feat_ref.reshape((-1,) + feat_ref.shape[-3:]).contiguous()
    pairs, h_in, w_in, c = fin.shape
    h_ref, w_ref = fref.shape[1:3]
    if fref.shape[0] != pairs or fref.shape[3] != c:
        raise ValueError(f'pairs or channels differ: '
                         f'{tuple(feat_input.shape)} vs '
                         f'{tuple(feat_ref.shape)}')
    grid_in = _patch_count(h_in, w_in, patch_size, input_stride)
    grid_ref = _patch_count(h_ref, w_ref, patch_size, ref_stride)
    if min(*grid_in, *grid_ref, c, pairs) <= 0:
        raise ValueError(f'empty patch matrix: {tuple(feat_input.shape)}, '
                         f'{tuple(feat_ref.shape)}, patch {patch_size}')
    n_in, n_ref = grid_in[0] * grid_in[1], grid_ref[0] * grid_ref[1]
    d = patch_size * patch_size * c
    ld = -(-d // 8) * 8
    pin = torch.empty((pairs, n_in, ld), dtype=dtype, device=fin.device)
    pref = torch.empty((pairs, n_ref, ld), dtype=dtype, device=fin.device)
    norm = torch.empty((pairs, n_in), dtype=dtype, device=fin.device)
    with torch.cuda.device(fin.device):
        _PROLOGUES[dtype](
            fin.data_ptr(), fref.data_ptr(), pairs, h_in, w_in, h_ref, w_ref,
            c, patch_size, input_stride, ref_stride, int(bool(is_norm)), ld,
            float(torch.tensor(1e-5, dtype=dtype)), pin.data_ptr(),
            pref.data_ptr(), norm.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return pin[..., :d], pref[..., :d], norm


def _match_patches_ref(pin, pref, chunk):
    """Plain version of the kernel: ``pin (P, n_in, d)``, ``pref
    (P, n_ref, d)`` -> ``(idx (P, n_in) int32, val (P, n_in) f32)``.
    Ref patches are scored in tiles of ``chunk``; inside a tile the first
    max wins, across tiles a strict ``>``: the lowest index among equal
    maxima. bf16 patches are widened to f32 first: the products of two
    bf16 values are exact in f32, and PyTorch's bf16 matmul would round
    the scores to bf16."""
    if pin.dtype != torch.float32:
        pin, pref = pin.float(), pref.float()
    best_val = torch.full(pin.shape[:2], -torch.inf, dtype=torch.float32,
                          device=pin.device)
    best_idx = torch.zeros(pin.shape[:2], dtype=torch.int32,
                           device=pin.device)
    for base in range(0, pref.shape[1], chunk):
        scores = torch.matmul(pin, pref[:, base:base + chunk].transpose(1, 2))
        val_c, idx_c = scores.max(dim=2)
        take = val_c > best_val
        best_val = torch.where(take, val_c, best_val)
        best_idx = torch.where(take, idx_c.to(torch.int32) + base, best_idx)
    return best_idx, best_val


def _row_stride(x, ld=None):
    """The row stride of ``x (P, n, d)``, checked to be the layout the match
    kernels load, which the prologue writes: unit stride along d, rows
    ``ld`` apart (``ld`` a multiple of 8, 16-byte rows; the given one, if
    any), pairs ``n * ld`` apart, a 16-byte aligned start, and ``P * n *
    ld`` elements of storage from there (the f32 kernel's split reads whole
    rows)."""
    pairs, n, d = x.shape
    stride = x.stride(1)
    room = x.untyped_storage().nbytes() // x.element_size() \
        - x.storage_offset()
    if not (x.stride(2) == 1 and stride % 8 == 0 and stride >= d
            and x.stride(0) == n * stride and x.data_ptr() % 16 == 0
            and room >= pairs * n * stride and ld in (None, stride)):
        raise ValueError(
            f'patch matrix of shape {tuple(x.shape)}, strides {x.stride()}: '
            'the match kernels take rows of unit stride whose stride is a '
            'multiple of 8 elements (16-byte rows), pairs n rows apart and '
            'a 16-byte aligned start'
            + ('' if ld is None else f' and a row stride of {ld}, as the '
               'input patches have')
            + ': the layout the prologue writes')
    return stride


def _match_patches_cuda(pin, pref, chunk=None, sharded=False):
    """The CUDA kernel, same contract as :func:`_match_patches_ref`; the
    kernel tiles the ref patches by itself, so ``chunk`` is unused. f32
    patches go to ``feature_match.cu``, bf16 ones to
    ``feature_match_bf16.cu``; ``sharded`` takes the entry point that counts
    the sharded match's launches. The patches come in the prologue's layout
    (:func:`_row_stride`); any other raises a ValueError."""
    if pin.dtype not in _KERNELS or pref.dtype != pin.dtype:
        raise TypeError('feature_match kernel takes float32 or bfloat16 '
                        f'patches of one dtype, got {pin.dtype} and '
                        f'{pref.dtype}')
    kernel = _KERNELS[pin.dtype][sharded]
    pairs, n_in, d = pin.shape
    n_ref = pref.shape[1]
    if pref.shape != (pairs, n_ref, d) or pref.device != pin.device:
        raise ValueError(f'patch matrices do not pair up: {tuple(pin.shape)} '
                         f'on {pin.device}, {tuple(pref.shape)} on '
                         f'{pref.device}')
    if n_in == 0 or n_ref == 0 or d == 0:
        raise ValueError(f'empty patch matrix: {tuple(pin.shape)}, '
                         f'{tuple(pref.shape)}')
    ld = _row_stride(pin)
    _row_stride(pref, ld)
    idx = torch.empty((pairs, n_in), dtype=torch.int32, device=pin.device)
    val = torch.empty((pairs, n_in), dtype=torch.float32, device=pin.device)
    # f32: the hi and lo planes of both matrices (3xTF32)
    scratch = (torch.empty(2 * pairs * (n_in + n_ref) * ld,
                           dtype=torch.float32, device=pin.device)
               if pin.dtype == torch.float32 else None)
    with torch.cuda.device(pin.device):
        kernel(pin.data_ptr(), pref.data_ptr(), pairs, n_in, n_ref, d, ld,
               *(() if scratch is None else (scratch.data_ptr(),)),
               idx.data_ptr(), val.data_ptr(),
               torch.cuda.current_stream().cuda_stream)
    return idx, val


def _match_patches_sharded_cuda(pin, pref, chunk=None):
    return _match_patches_cuda(pin, pref, sharded=True)


def _feature_match(feat_input, feat_ref, patch_size, input_stride,
                   ref_stride, is_norm, norm_input, chunk, prologue, match):
    if feat_input.shape[:-3] != feat_ref.shape[:-3]:
        raise ValueError(f'batch dims differ: {tuple(feat_input.shape)} vs '
                         f'{tuple(feat_ref.shape)}')
    batch = feat_input.shape[:-3]
    h, w = feat_input.shape[-3:-1]
    pin, pref, norm = prologue(feat_input, feat_ref, patch_size,
                               input_stride, ref_stride, is_norm)
    idx, val = match(pin, pref, chunk)
    if norm_input:
        # the constant in pin's dtype, the sum in f32 and not rounded: XLA
        # drops the bf16 round trip where JAX promotes it for the f32 val
        val = val / (norm.float() + float(torch.tensor(1e-5,
                                                        dtype=norm.dtype)))
    ph, pw = _patch_count(h, w, patch_size, input_stride)
    return idx.reshape(batch + (ph, pw)), val.reshape(batch + (ph, pw))


def _paths(feat, name, sharded=False):
    """``(prologue, match)`` for the features' device: the kernels on a CUDA
    tensor, the plain versions on a CPU one, nothing else."""
    if feat.is_cuda:
        return _prologue_cuda, (_match_patches_sharded_cuda if sharded
                                else _match_patches_cuda)
    if feat.device.type == 'cpu':
        return _prologue_ref, _match_patches_ref
    raise RuntimeError(f'{name} runs on cuda or cpu tensors, got '
                       f'{feat.device}')


def feature_match_index(feat_input, feat_ref, patch_size=3, input_stride=1,
                        ref_stride=1, is_norm=True, norm_input=False,
                        chunk=2048):
    """Top-1 patch matching between input and reference features.

    Args:
        feat_input, feat_ref: ``(..., H, W, C)``, both float32 or both
            bfloat16; equal leading dims are matched pair by pair.
        is_norm: divide each ref patch by its L2 norm + 1e-5.
        norm_input: divide the best score by the input patch norm + 1e-5
            (changes ``val`` only).
        chunk: ref-patch tile of the plain (CPU) version; the CUDA kernel
            tiles by itself, and the result does not depend on it.

    Returns:
        ``max_idx (..., ph, pw)`` int32, row-major into the ref patch grid,
        the lowest index among equal maxima; ``max_val (..., ph, pw)``.
    """
    return _feature_match(feat_input, feat_ref, patch_size, input_stride,
                          ref_stride, is_norm, norm_input, chunk,
                          *_paths(feat_input, 'feature_match_index'))


def feature_match_index_ref(feat_input, feat_ref, patch_size=3,
                            input_stride=1, ref_stride=1, is_norm=True,
                            norm_input=False, chunk=2048):
    """:func:`feature_match_index` through the plain PyTorch versions on any
    device: the yardstick the CUDA kernels are held against."""
    return _feature_match(feat_input, feat_ref, patch_size, input_stride,
                          ref_stride, is_norm, norm_input, chunk,
                          _prologue_ref, _match_patches_ref)


def _fuse_across_ranks(local_idx, local_val, shard_width, row_offset,
                       patch_size, ref_stride, group):
    """The rank's best match in its band -> the best over every rank's band
    (JAX package correlation.py:167-180): the band's patch index becomes an
    index into the whole ref's patch grid, the ranks agree on the largest
    value (MAX), then on the lowest index among the ranks that hold it
    (MIN), which is single-device K1's tie rule."""
    pw = (shard_width - patch_size) // ref_stride + 1
    rows = torch.div(local_idx, pw, rounding_mode='floor')
    global_idx = (rows + row_offset // ref_stride) * pw + local_idx % pw
    global_val = local_val.clone()
    dist.all_reduce(global_val, op=dist.ReduceOp.MAX, group=group)
    cand = torch.where(local_val >= global_val, global_idx,
                       torch.full_like(global_idx, INT32_MAX))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return cand, global_val


def _feature_match_sharded(feat_input, feat_ref_shard, group, patch_size,
                           input_stride, ref_stride, is_norm, norm_input,
                           chunk, prologue, match):
    shard, row_offset = feat_ref_shard
    row_offset = int(row_offset)
    if row_offset < 0 or row_offset % ref_stride:
        raise ValueError(f'row_offset {row_offset} must be a multiple of '
                         f'ref_stride {ref_stride}: the band\'s patch grid '
                         'must lie on the whole ref\'s')
    local_idx, local_val = _feature_match(
        feat_input, shard, patch_size, input_stride, ref_stride, is_norm,
        norm_input, chunk, prologue, match)
    return _fuse_across_ranks(local_idx, local_val, shard.shape[-2],
                              row_offset, patch_size, ref_stride, group)


def feature_match_index_sharded(feat_input, feat_ref_shard, group=None,
                                patch_size=3, input_stride=1, ref_stride=1,
                                is_norm=True, norm_input=False, chunk=2048):
    """Top-1 matching against a reference split by rows over the ranks of
    ``group`` (the default process group if None): each rank matches the
    whole input against its band with K1's kernels, then two all-reduces
    give every rank the answer of :func:`feature_match_index` on the whole
    reference, ties to the lowest global patch index.

    Args:
        feat_input: ``(..., H, W, C)``, the same on every rank.
        feat_ref_shard: ``(shard (..., Hs, W, C), row_offset)``, the band's
            first row in the whole ref. Bands overlap by ``patch_size - 1``
            rows, so every patch lies whole in one band, and ``row_offset``
            is a multiple of ``ref_stride``. Bands may differ in height:
            only the outputs, which are input-shaped, must agree.

    Returns ``(max_idx, max_val)`` as :func:`feature_match_index` does,
    the same on every rank. Collective: every rank of ``group`` calls it.
    """
    return _feature_match_sharded(
        feat_input, feat_ref_shard, group, patch_size, input_stride,
        ref_stride, is_norm, norm_input, chunk,
        *_paths(feat_input, 'feature_match_index_sharded', sharded=True))


def feature_match_index_sharded_ref(feat_input, feat_ref_shard, group=None,
                                    patch_size=3, input_stride=1,
                                    ref_stride=1, is_norm=True,
                                    norm_input=False, chunk=2048):
    """:func:`feature_match_index_sharded` through the plain PyTorch versions
    of the per-rank prologue and match on any device, with the same
    collectives."""
    return _feature_match_sharded(feat_input, feat_ref_shard, group,
                                  patch_size, input_stride, ref_stride,
                                  is_norm, norm_input, chunk,
                                  _prologue_ref, _match_patches_ref)


def index_to_flow(max_idx):
    """Match-index map -> flow: matched position - own position, last dim
    (x, y), zero-padded by 2 at the bottom/right so it covers the feature
    map. ``(..., h, w)`` int -> ``(..., h + 2, w + 2, 2)`` float32."""
    h, w = max_idx.shape[-2:]
    flow_w = (max_idx % w).to(torch.float32)
    flow_h = torch.div(max_idx, w, rounding_mode='floor').to(torch.float32)
    grid_y, grid_x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=max_idx.device),
        torch.arange(w, dtype=torch.float32, device=max_idx.device),
        indexing='ij')
    flow = torch.stack([flow_w - grid_x, flow_h - grid_y], dim=-1)
    return F.pad(flow, (0, 0, 0, 2, 0, 2))


def tensor_shift(x, shift=(2, 2), fill_val=0.):
    """Shift ``(..., h, w, c)`` down/right by ``shift``, filling the vacated
    rows and columns with ``fill_val``."""
    h, w = x.shape[-3:-1]
    sh, sw = shift
    if sh == 0 and sw == 0:
        return x
    x = F.pad(x, (0, 0, sw, 0, sh, 0), value=fill_val)
    return x[..., :h, :w, :]
