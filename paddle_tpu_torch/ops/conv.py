"""Convolution and pooling, NHWC (port of the parts of
`paddle_tpu.ops.conv` the image models use).

Layout is the JAX package's: activations [N, H, W, C], conv kernels
[kh, kw, Cin/groups, Cout]. The products go to
`torch.nn.functional.conv2d` (cuDNN on the card) on an NCHW view of the
NHWC tensor: a contiguous NHWC tensor permuted to NCHW is a
channels_last tensor, which cuDNN takes without a layout copy (CPU
tensors are copied to NCHW first: see `conv2d`). Pools are torch's
pooling ops on the same view.

Padding follows XLA's: SAME pads so that out = ceil(in / stride), the
low side getting the smaller half, so an odd total pads one more at the
bottom and right (ResNet's 7x7/s2 stem at 224 pads (2, 3), every 3x3/s2
conv (0, 1)). torch's convolutions and pools take only symmetric
padding, so `explicit_pad` resolves every padding to ((top, bottom),
(left, right)); equal sides go to the op, unequal ones to `F.pad` first
(zeros for convs and average pools, -inf for max pools).

The rest of the JAX module follows the same rules: `conv2d_transpose`
(lax's `conv_transpose` with transpose_kernel=False: the kernel is not
flipped, so it is flipped here for `F.conv_transpose2d`, and lax's
padding of the dilated input is applied to the output), the 3-D conv
and pools over NDHWC, patches (`im2col`, `block_expand`) as strided
views, `roi_pool` in per-bin masks, `max_pool2d_with_index` /
`max_unpool2d` over flat h*W + w indices, and the resizes as
`jax.image.resize` computes them: bilinear by per-axis weight matrices
(antialiased when downsampling; `F.interpolate` does not antialias that
way) and nearest with half-pixel centres.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import Policy, default_policy
from paddle_tpu_torch.core.mesh import (as_rows, is_replicated, rows_weight,
                                        split_rows)

IntOr2 = Union[int, Tuple[int, int], Sequence[int]]


# -- padding arithmetic (framework-free; a copy of the JAX package's) --------


def _pair(v: IntOr2) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def _padding(padding, kernel: Tuple[int, int]):
    if isinstance(padding, str):
        return padding  # 'SAME' / 'VALID'
    if (
        isinstance(padding, (tuple, list))
        and len(padding) == 2
        and isinstance(padding[0], (tuple, list))
    ):
        return tuple((int(a), int(b)) for a, b in padding)  # ((t,b),(l,r))
    ph, pw = _pair(padding)
    return ((ph, ph), (pw, pw))


def explicit_pad(h: int, w: int, window: IntOr2, stride: IntOr2,
                 padding, dilation: IntOr2 = 1,
                 ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Resolve SAME/VALID/int/((t,b),(l,r)) padding to explicit
    ((top,bot),(left,right)) for the given static input size — XLA's
    SAME formula (pad so that out = ceil(in/stride), low half rounded
    down), using the dilation-effective kernel size."""
    kh, kw = _pair(window)
    dh, dw = _pair(dilation)
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    sh, sw = _pair(stride)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        th = max((oh - 1) * sh + ekh - h, 0)
        tw = max((ow - 1) * sw + ekw - w, 0)
        return ((th // 2, th - th // 2), (tw // 2, tw - tw // 2))
    pad = _padding(padding, (kh, kw))
    return (tuple(pad[0]), tuple(pad[1]))


def out_hw(h: int, w: int, window: IntOr2, stride: IntOr2, padding,
           dilation: IntOr2 = 1) -> Tuple[int, int]:
    """Static output (H, W) of a conv/pool window — built on explicit_pad,
    the ONE place the padding arithmetic lives (shape inference in
    nn.layers and nn.mixed reuses it; keep in sync with what
    lax.conv/reduce_window actually produce)."""
    kh, kw = _pair(window)
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
    (pt, pb), (pl, pr) = explicit_pad(h, w, window, stride, padding, dilation)
    return (h + pt + pb - ekh) // sh + 1, (w + pl + pr - ekw) // sw + 1


# -- layout and padding helpers -----------------------------------------------


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> its [N, C, H, W] view (channels_last memory)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _padded(x, pad2, limit, value):
    """NHWC x and its ((t, b), (l, r)) padding -> (the NCHW view to hand
    the op, the symmetric padding the op applies). `limit` is the largest
    symmetric (h, w) padding the op takes (None: any); other padding is
    applied here by F.pad on the NHWC tensor."""
    (pt, pb), (pl, pr) = pad2
    if pt == pb and pl == pr and (limit is None or (
            pt <= limit[0] and pl <= limit[1])):
        return _nchw(x), (pt, pl)
    return _nchw(F.pad(x, (0, 0, pl, pr, pt, pb), value=value)), (0, 0)


# -- convolution ---------------------------------------------------------------


def conv2d(
    x,
    kernel,
    *,
    stride: IntOr2 = 1,
    padding="SAME",
    dilation: IntOr2 = 1,
    groups: int = 1,
    bias=None,
    policy: Optional[Policy] = None,
):
    """2-D convolution. x: [N,H,W,C], kernel: [kh,kw,Cin/groups,Cout].

    x and the kernel are cast to the policy's compute dtype; the output
    has its accum dtype, then the bias is added (an f32 bias promotes a
    bf16 output to f32, as in the JAX package)."""
    policy = policy or default_policy()
    x = x.to(policy.compute_dtype)
    kh, kw = kernel.shape[0], kernel.shape[1]
    pad2 = explicit_pad(x.shape[1], x.shape[2], (kh, kw), stride, padding,
                        dilation)
    xc, pad = _padded(x, pad2, None, 0.0)
    copy = dict(memory_format=torch.contiguous_format, copy=True)
    if xc.is_cuda:
        # the weight as [Cout, Cin, kh, kw] in channels_last memory, like
        # the input's view: one cast-and-copy of the (small) kernel a call
        w = kernel.permute(3, 0, 1, 2).to(policy.compute_dtype,
                                          **copy).permute(0, 3, 1, 2)
    else:
        # CPU: NCHW-contiguous operands. torch's CPU backward of a 1x1
        # stride-2 convolution over a channels_last input corrupts the
        # heap (torch 2.13.0+cpu), as does one whose 1x1 weight has the
        # channels_last strides
        xc = xc.contiguous()
        w = kernel.permute(3, 2, 0, 1).to(policy.compute_dtype, **copy)
    conv = (_batch_split_conv if split_rows(xc) and is_replicated(w)
            else F.conv2d)
    y = conv(xc, w, stride=_pair(stride), padding=pad,
             dilation=_pair(dilation), groups=groups)
    y = _nhwc(y).to(policy.accum_dtype)
    if bias is not None:
        y = y + bias
    return y


def _by_rows(fn, x, *args, **kw):
    """fn on each rank's own rows of a batch-split DTensor x (a pool
    needs no other row; torch 2.11's DTensor has no sharding strategy
    for max_pool2d_with_indices), else fn(x)."""
    if not split_rows(x):
        return fn(x, *args, **kw)
    return as_rows(fn(x.to_local(), *args, **kw), x)


def _batch_split_conv(x, w, **kw):
    """F.conv2d of a batch-split DTensor on each rank's own rows: a
    convolution needs no other row, and DTensor's convolution handler
    (torch 2.11) exchanges width halos whenever the convolution pads, as
    if the width were split."""
    return as_rows(F.conv2d(x.to_local(), rows_weight(w, x), **kw), x)


def space_to_depth(x, block: IntOr2 = 2):
    """[N,H,W,C] -> [N,H/b1,W/b2,b1*b2*C]; channel order ((di*b2+dj)*C+c)."""
    b1, b2 = _pair(block)
    n, h, w, c = x.shape
    x = x.reshape(n, h // b1, b1, w // b2, b2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b1, w // b2, b1 * b2 * c)


def depth_to_space(x, block: IntOr2 = 2):
    """Inverse of space_to_depth."""
    b1, b2 = _pair(block)
    n, h, w, cc = x.shape
    c = cc // (b1 * b2)
    x = x.reshape(n, h, w, b1, b2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * b1, w * b2, c)


def s2d_kernel(kernel, block: IntOr2):
    """Re-lay a conv kernel [kh,kw,C,O] for a space-to-depth-blocked
    input: zero-pad kh/kw up to multiples of the block, then fold the
    intra-block offsets into the input-channel dim (matching
    space_to_depth's channel order)."""
    b1, b2 = _pair(block)
    kh, kw, c, o = kernel.shape
    bkh, bkw = -(-kh // b1) * b1, -(-kw // b2) * b2
    kp = F.pad(kernel, (0, 0, 0, 0, 0, bkw - kw, 0, bkh - kh))
    kp = kp.reshape(bkh // b1, b1, bkw // b2, b2, c, o)
    kp = kp.permute(0, 2, 1, 3, 4, 5)
    return kp.reshape(bkh // b1, bkw // b2, b1 * b2 * c, o)


def conv2d_space_to_depth(
    x,
    kernel,
    *,
    stride: IntOr2,
    padding="SAME",
    bias=None,
    policy: Optional[Policy] = None,
):
    """conv2d with stride == block, computed on the space-to-depth
    transform of the input: the same output (the kernel is re-laid with
    s2d_kernel; its extra rows are zero) with a stride-1 conv over
    b1*b2 times the input channels. The kernel parameter keeps its
    [kh,kw,C,O] layout. Sizes that do not block evenly take the direct
    conv."""
    b1, b2 = _pair(stride)
    kh, kw = kernel.shape[0], kernel.shape[1]
    n, h, w, _ = x.shape
    (pt, pb), (pl, pr) = explicit_pad(h, w, (kh, kw), (b1, b2), padding)
    if h % b1 or w % b2 or pt % b1 or pl % b2:
        return conv2d(x, kernel, stride=(b1, b2), padding=padding,
                      bias=bias, policy=policy)
    oh, ow = out_hw(h, w, (kh, kw), (b1, b2), padding)
    kb = s2d_kernel(kernel, (b1, b2))
    xb = space_to_depth(x, (b1, b2))
    plb, plwb = pt // b1, pl // b2
    phb = max(0, oh - plb + kb.shape[0] - 1 - h // b1)
    prb = max(0, ow - plwb + kb.shape[1] - 1 - w // b2)
    return conv2d(xb, kb, stride=1,
                  padding=((plb, phb), (plwb, prb)),
                  bias=bias, policy=policy)


# -- pooling --------------------------------------------------------------------


def _lowest(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _max_pool2d_raw(x, window, stride, pad2):
    # torch's max pools take padding up to half the window
    xc, pad = _padded(x, pad2, (window[0] // 2, window[1] // 2),
                      _lowest(x.dtype))
    return _nhwc(_by_rows(F.max_pool2d, xc, window, stride, padding=pad))


class _MaxPool2dTieSplit(torch.autograd.Function):
    """Max pool whose backward splits the cotangent equally among tied
    maxima (the JAX package's `_max_pool2d_ts` custom VJP): for every
    window offset, the window's elements equal to its max get dy / (the
    number of them); a window whose max is NaN (no element equals it)
    passes no gradient."""

    @staticmethod
    def forward(ctx, x, window, stride, pad2):
        y = _max_pool2d_raw(x, window, stride, pad2)
        ctx.save_for_backward(x, y)
        ctx.geometry = (window, stride, pad2)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        (wh, ww), (sh, sw), ((pt, pb), (pl, pr)) = ctx.geometry
        n, h, w, c = x.shape
        oh, ow = y.shape[1], y.shape[2]
        xp = F.pad(x, (0, 0, pl, pr, pt, pb), value=float("-inf"))

        def window_elem(t, i, j):
            # the (i, j)-th element of every window, as a y-shaped view
            return t[:, i:i + (oh - 1) * sh + 1:sh,
                     j:j + (ow - 1) * sw + 1:sw, :]

        offsets = [(i, j) for i in range(wh) for j in range(ww)]
        masks = [(window_elem(xp, i, j) == y).to(dy.dtype)
                 for i, j in offsets]
        cnt = sum(masks)
        g = dy / torch.clamp(cnt, min=1)
        acc = torch.zeros_like(xp, dtype=dy.dtype)
        for (i, j), m in zip(offsets, masks):
            window_elem(acc, i, j).add_(m * g)
        dx = acc[:, pt:pt + h, pl:pl + w, :]
        return dx.to(x.dtype), None, None, None


def max_pool2d(x, window: IntOr2 = 2, *, stride: Optional[IntOr2] = None,
               padding="VALID", tie_split: Optional[bool] = None):
    """Max pooling, NHWC; padded positions are -inf.

    Backward at ties. tie_split False (the default): the whole cotangent
    of a window goes to one maximum, the first in row-major window order
    -- torch's max_pool2d keeps the first maximum it meets (its
    comparison is `>`), and XLA's select-and-scatter (the JAX package's
    default VJP, select `>=`) keeps the same one. tie_split True (floats
    only): the cotangent is split equally among the tied maxima (the
    JAX package's custom VJP). None reads env PADDLE_TPU_POOL_TIE_SPLIT
    ("0" or unset: False), as the JAX package does."""
    if tie_split is None:
        tie_split = os.environ.get("PADDLE_TPU_POOL_TIE_SPLIT", "0") != "0"
    win = _pair(window)
    strd = _pair(stride if stride is not None else window)
    pad2 = explicit_pad(x.shape[1], x.shape[2], win, strd, padding)
    if tie_split and x.is_floating_point():
        return _MaxPool2dTieSplit.apply(x, win, strd, pad2)
    return _max_pool2d_raw(x, win, strd, pad2)


def avg_pool2d(
    x,
    window: IntOr2 = 2,
    *,
    stride: Optional[IntOr2] = None,
    padding="VALID",
    count_include_pad: bool = True,
):
    """Average pooling, NHWC. padding: 'SAME', 'VALID' or an int / (h, w)
    pair (symmetric). Padded positions are zeros, counted in the
    divisor (window area) unless count_include_pad=False."""
    win = _pair(window)
    strd = _pair(stride if stride is not None else window)
    pad2 = explicit_pad(x.shape[1], x.shape[2], win, strd,
                        padding if isinstance(padding, str)
                        else _pair(padding))
    # no padding to the op: torch's CUDA avg_pool2d backward over
    # channels_last memory is wrong whenever padding > 0 (torch 2.11.0,
    # forward right); F.pad's zeros are what it would count
    xc, pad = _padded(x, pad2, (0, 0), 0.0)
    summed = _by_rows(F.avg_pool2d, xc, win, strd, padding=pad,
                      count_include_pad=True, divisor_override=1)
    if count_include_pad or pad2 == ((0, 0), (0, 0)):
        return _nhwc(summed / (win[0] * win[1]))
    # the count of real (unpadded) elements in each window, from a ones
    # plane of the input's size
    ones = x.new_ones((1,) + tuple(x.shape[1:3]) + (1,))
    oc, pad = _padded(ones, pad2, (0, 0), 0.0)
    counts = _by_rows(F.avg_pool2d, oc, win, strd, padding=pad,
                      count_include_pad=True, divisor_override=1)
    return _nhwc(summed / counts)


def global_avg_pool2d(x):
    return torch.mean(x, dim=(1, 2))


def depthwise_conv2d(x, kernel, *, stride: IntOr2 = 1, padding="SAME",
                     bias=None, policy: Optional[Policy] = None):
    """Depthwise conv: kernel [kh, kw, 1, C * multiplier], groups = C."""
    return conv2d(x, kernel, stride=stride, padding=padding,
                  groups=x.shape[-1], bias=bias, policy=policy)


def _conv_transpose_padding(k: int, s: int, padding) -> Tuple[int, int]:
    """lax.conv_transpose's padding of the stride-dilated input for
    'SAME' / 'VALID' (a copy of jax's `_conv_transpose_padding`)."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"Invalid padding mode: {padding}")
    return pad_a, pad_len - pad_a


def conv2d_transpose(x, kernel, *, stride: IntOr2 = 1, padding="SAME",
                     bias=None, policy: Optional[Policy] = None):
    """Transposed conv, x [N, H, W, Cin], kernel [kh, kw, Cin, Cout]: the
    kernel correlated, unflipped, over x dilated by the stride and padded
    (a, b) per axis -- lax's 'SAME'/'VALID' pads, or explicit pairs (or
    ints) applied to the dilated input as given.

    `F.conv_transpose2d` is the gradient form: it correlates the flipped
    kernel over the dilated input padded (k-1, k-1). So the kernel goes
    in flipped, as [Cin, Cout, kh, kw], and the output is then padded by
    (a - (k-1), b - (k-1)) per axis (a negative pad crops)."""
    policy = policy or default_policy()
    dt = policy.compute_dtype
    kh, kw = kernel.shape[0], kernel.shape[1]
    sh, sw = _pair(stride)
    if isinstance(padding, str):
        (ah, bh), (aw, bw) = (_conv_transpose_padding(kh, sh, padding),
                              _conv_transpose_padding(kw, sw, padding))
    else:
        (ah, bh), (aw, bw) = _padding(padding, (kh, kw))
    xc = _nchw(x.to(dt))
    w = kernel.flip(0, 1).permute(2, 3, 0, 1).to(dt)
    if not xc.is_cuda:
        xc, w = xc.contiguous(), w.contiguous()
    y = F.conv_transpose2d(xc, w, stride=(sh, sw))
    y = F.pad(y, (aw - kw + 1, bw - kw + 1, ah - kh + 1, bh - kh + 1))
    y = _nhwc(y).to(policy.accum_dtype)
    if bias is not None:
        y = y + bias
    return y


def spp(x, pyramid_height: int = 3, pool_type: str = "max"):
    """Spatial pyramid pooling: [N, sum_l 4^l * C], level l pooling a
    2^l x 2^l grid of near-equal windows (max, or mean otherwise)."""
    n, h, w, c = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        ys = np.linspace(0, h, bins + 1).astype(np.int32)
        xs = np.linspace(0, w, bins + 1).astype(np.int32)
        for i in range(bins):
            for j in range(bins):
                patch = x[:, ys[i]:max(ys[i + 1], ys[i] + 1),
                          xs[j]:max(xs[j + 1], xs[j] + 1), :]
                outs.append(torch.amax(patch, dim=(1, 2))
                            if pool_type == "max"
                            else torch.mean(patch, dim=(1, 2)))
    return torch.cat(outs, dim=-1)


def pad(x, paddings, value: float = 0.0):
    """Constant padding, `paddings` as numpy's: an int, a (before, after)
    pair, or one pair per dim."""
    pairs = np.broadcast_to(np.asarray(paddings, np.int64), (x.ndim, 2))
    flat = [int(v) for pair in pairs[::-1] for v in pair]
    return F.pad(x, flat, value=value)


def crop(x, offsets, shape):
    """x[offsets : offsets + shape] per dim, each offset clamped so the
    slice fits (lax.dynamic_slice's rule)."""
    out = x
    for d, (o, size) in enumerate(zip(offsets, shape)):
        start = min(max(int(o), 0), x.shape[d] - int(size))
        out = out.narrow(d, start, int(size))
    return out


def _windows(xp, window, stride):
    """Every (kh, kw) window of a padded NHWC tensor, strided, as a view
    [N, Ho, Wo, C, kh * kw] (window cells in row-major order)."""
    (kh, kw), (sh, sw) = window, stride
    v = xp.unfold(1, kh, sh).unfold(2, kw, sw)       # [N, Ho, Wo, C, kh, kw]
    return v.reshape(*v.shape[:4], kh * kw)


def im2col(x, window: IntOr2, *, stride: IntOr2 = 1, padding="VALID"):
    """Patches: [N, H, W, C] -> [N, Ho, Wo, C*kh*kw], the last dim
    channel-major as (C, kh, kw) (lax's conv_general_dilated_patches
    order); padding as conv2d's, zeros."""
    win, strd = _pair(window), _pair(stride)
    (pt, pb), (pl, pr) = explicit_pad(x.shape[1], x.shape[2], win, strd,
                                      padding)
    v = _windows(F.pad(x, (0, 0, pl, pr, pt, pb)), win, strd)
    return v.reshape(*v.shape[:3], -1)


def roi_pool(x, rois, output_size: Tuple[int, int],
             spatial_scale: float = 1.0):
    """ROI max pooling. x [N, H, W, C]; rois [R, 5] = (batch index, x1,
    y1, x2, y2) at input scale -> [R, oh, ow, C]. Bin (i, j) of a roi
    covers rows floor(y1 + i*bin_h) <= y < ceil(y1 + (i+1)*bin_h) (and
    likewise the columns); the max over it is taken as a column mask's
    max, then a row mask's, and an empty bin gives 0."""
    n, h, w, c = x.shape
    oh, ow = output_size
    dev = x.device
    rois = rois.to(device=dev, dtype=torch.float32)
    img = x[rois[:, 0].long()]                                  # [R, H, W, C]
    x1, y1, x2, y2 = (rois[:, k] * spatial_scale for k in range(1, 5))
    bin_h = torch.clamp(y2 - y1 + 1.0, min=1.0) / oh
    bin_w = torch.clamp(x2 - x1 + 1.0, min=1.0) / ow

    def bin_mask(lo, size, n_bins, extent):
        i = torch.arange(n_bins, device=dev, dtype=torch.float32)[None, :]
        start = torch.floor(lo[:, None] + i * size[:, None])
        stop = torch.ceil(lo[:, None] + (i + 1) * size[:, None])
        r = torch.arange(extent, device=dev, dtype=torch.float32)
        return (r >= start[..., None]) & (r < stop[..., None])  # [R, n, E]

    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=dev)
    ym, xm = bin_mask(y1, bin_h, oh, h), bin_mask(x1, bin_w, ow, w)
    cols = torch.amax(torch.where(xm[:, :, None, :, None], img[:, None], neg),
                      dim=3)                                    # [R, ow, H, C]
    val = torch.amax(torch.where(ym[:, :, None, :, None], cols[:, None], neg),
                     dim=3)                                     # [R, oh, ow, C]
    return torch.where(torch.isfinite(val), val, torch.zeros_like(val))


def _triple(v):
    return (v,) * 3 if isinstance(v, int) else tuple(int(a) for a in v)


def _pads3(spatial, window, stride, padding):
    """((lo, hi),) * 3 for a 3-D window: XLA's SAME (out = ceil(in /
    stride), the low side the smaller half), VALID, or symmetric ints."""
    if padding == "VALID":
        return [(0, 0)] * 3
    if padding == "SAME":
        pads = []
        for i, k, st in zip(spatial, window, stride):
            t = max((-(-i // st) - 1) * st + k - i, 0)
            pads.append((t // 2, t - t // 2))
        return pads
    return [(p, p) for p in _triple(padding)]


def _pad3(x, pads, value=0.0):
    """F.pad of an NDHWC tensor by ((d), (h), (w)) pairs."""
    (dl, dr), (hl, hr), (wl, wr) = pads
    return F.pad(x, (0, 0, wl, wr, hl, hr, dl, dr), value=value)


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3).contiguous()


def _ndhwc(y):
    return y.permute(0, 2, 3, 4, 1)


def conv3d(x, kernel, *, stride=1, padding="SAME", bias=None,
           policy: Optional[Policy] = None):
    """3-D convolution. x [N, D, H, W, C], kernel [kd, kh, kw, Cin,
    Cout]; padding 'SAME' (XLA's, uneven sides through F.pad), 'VALID'
    or symmetric ints."""
    policy = policy or default_policy()
    dt = policy.compute_dtype
    s = _triple(stride)
    pads = _pads3(x.shape[1:4], kernel.shape[:3], s, padding)
    w = kernel.permute(4, 3, 0, 1, 2).to(dt).contiguous()
    y = F.conv3d(_ncdhw(_pad3(x.to(dt), pads)), w, stride=s)
    y = _ndhwc(y).to(policy.accum_dtype)
    if bias is not None:
        y = y + bias
    return y


def _pool3d_geometry(x, window, stride, padding):
    w = _triple(window)
    s = w if stride is None else _triple(stride)
    return w, s, _pads3(x.shape[1:4], w, s, padding)


def max_pool3d(x, window=2, *, stride=None, padding="VALID"):
    """3-D max pooling over NDHWC; padded positions are -inf."""
    w, s, pads = _pool3d_geometry(x, window, stride, padding)
    y = F.max_pool3d(_ncdhw(_pad3(x, pads, _lowest(x.dtype))), w, s)
    return _ndhwc(y)


def avg_pool3d(x, window=2, *, stride=None, padding="VALID"):
    """3-D average pooling over NDHWC; the padding is left out of the
    divisor (each window's count of real elements)."""
    w, s, pads = _pool3d_geometry(x, window, stride, padding)
    sums = lambda t: F.avg_pool3d(_ncdhw(_pad3(t, pads)), w, s,
                                  divisor_override=1)
    summed = sums(x)
    no_pad = padding == "VALID" or (
        not isinstance(padding, str) and not any(_triple(padding)))
    if no_pad:
        return _ndhwc(summed / float(np.prod(w)))
    counts = sums(x.new_ones((1,) + tuple(x.shape[1:4]) + (1,)))
    return _ndhwc(summed / counts)


def maxout(x, groups: int):
    """[..., C] -> [..., C / groups]: the max over each group of `groups`
    consecutive channels."""
    c = x.shape[-1]
    if c % groups != 0:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    return torch.amax(x.reshape(*x.shape[:-1], c // groups, groups), dim=-1)


def block_expand(x, block: IntOr2, *, stride: IntOr2 = None,
                 padding="VALID"):
    """Image -> sequence of flattened blocks: [N, Ho*Wo, bh*bw*C], one
    step per window position (im2col's order)."""
    patches = im2col(x, _pair(block),
                     stride=_pair(stride if stride is not None else block),
                     padding=padding)
    n, ho, wo, d = patches.shape
    return patches.reshape(n, ho * wo, d)


def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] float64 weights of jax.image's antialiased triangle
    kernel (`compute_weight_mat`, scale out/in, no translation): the
    kernel widens by in/out when downsampling, each output's weights sum
    to one, and samples outside the input get none."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale \
        - 0.5
    dist = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float64)
                  [:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - np.abs(dist))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(
        np.finfo(np.float32).eps), weights / np.where(total != 0, total, 1),
        0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0)


def bilinear_interp(x, out_hw: Tuple[int, int], *,
                    align_corners: bool = False):
    """Bilinear resize of [N, H, W, C]. align_corners=False is
    `jax.image.resize(method="bilinear")`: per-axis weight matrices
    (`_resize_weights`, antialiased when downsampling) contracted over
    H and W. align_corners=True (both sides > 1) samples a corner-aligned
    grid by an explicit gather."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    dev = x.device
    if align_corners and oh > 1 and ow > 1:
        ys, xs = np.linspace(0.0, h - 1.0, oh), np.linspace(0.0, w - 1.0, ow)
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        wy = torch.as_tensor(ys - y0, device=dev).to(x.dtype)[
            None, :, None, None]
        wx = torch.as_tensor(xs - x0, device=dev).to(x.dtype)[
            None, None, :, None]
        rows = lambda i: x[:, torch.as_tensor(i, device=dev)]
        cols = lambda t, j: t[:, :, torch.as_tensor(j, device=dev)]
        top = cols(rows(y0), x0) * (1 - wx) + cols(rows(y0), x1) * wx
        bot = cols(rows(y1), x0) * (1 - wx) + cols(rows(y1), x1) * wx
        return top * (1 - wy) + bot * wy
    y = x
    if oh != h:
        wh = torch.as_tensor(_resize_weights(h, oh), device=dev).to(x.dtype)
        y = torch.einsum("nhwc,hp->npwc", y, wh)
    if ow != w:
        ww = torch.as_tensor(_resize_weights(w, ow), device=dev).to(x.dtype)
        y = torch.einsum("nhwc,wq->nhqc", y, ww)
    return y


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """jax.image's nearest source index: floor((i + 0.5) * in / out) in
    f32 (half-pixel centres, as torch's 'nearest-exact')."""
    f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(in_size) / np.float32(out_size)
    return np.floor(f.astype(np.float32)).astype(np.int64)


def nearest_interp(x, out_hw: Tuple[int, int]):
    """Nearest-neighbour resize of [N, H, W, C]."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    if oh != h:
        x = x[:, torch.as_tensor(_nearest_index(h, oh), device=x.device)]
    if ow != w:
        x = x[:, :, torch.as_tensor(_nearest_index(w, ow), device=x.device)]
    return x


def rotate90(x, *, reverse: bool = False):
    """Rotate each [H, W] map 90 degrees counter-clockwise ([N, H, W, C]
    -> [N, W, H, C]); reverse=True rotates clockwise."""
    return torch.flip(torch.swapaxes(x, 1, 2), dims=(2 if reverse else 1,))


def max_pool2d_with_index(x, window: IntOr2 = 2, *,
                          stride: Optional[IntOr2] = None, padding="VALID"):
    """Max pooling that also returns each maximum's flat spatial index
    h*W + w (per channel): (pooled [N, OH, OW, C], idx int64 [N, OH, OW,
    C]). Padded cells hold the dtype's lowest value, so they never win
    over a real one; on ties the first maximum in window order wins
    (`torch.argmax`, as `jnp.argmax`)."""
    n, h, w, c = x.shape
    win = _pair(window)
    strd = _pair(stride if stride is not None else window)
    (pt, pb), (pl, pr) = explicit_pad(h, w, win, strd, padding)
    vals = _windows(F.pad(x, (0, 0, pl, pr, pt, pb), value=_lowest(x.dtype)),
                    win, strd)                       # [N, OH, OW, C, K]
    oh, ow = vals.shape[1], vals.shape[2]
    pooled = torch.amax(vals, dim=-1)
    best = torch.argmax(vals, dim=-1)
    ar = lambda k: torch.arange(k, device=x.device)
    abs_h = ar(oh)[:, None, None] * strd[0] - pt + best // win[1]
    abs_w = ar(ow)[:, None] * strd[1] - pl + best % win[1]
    return pooled, abs_h * w + abs_w


def max_unpool2d(pooled, idx, out_hw: Tuple[int, int]):
    """Put pooled values back at their argmax positions, zeros elsewhere:
    pooled/idx [N, OH, OW, C] -> [N, H, W, C]. A cell that several
    overlapping windows selected gets its (equal) max once: set, never
    added."""
    n, oh, ow, c = pooled.shape
    h, w = out_hw
    out = pooled.new_zeros((n, h * w, c)).scatter(
        1, idx.reshape(n, oh * ow, c).long(), pooled.reshape(n, oh * ow, c))
    return out.reshape(n, h, w, c)
