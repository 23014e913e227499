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

Not ported yet: conv2d_transpose, depthwise_conv2d, spp, im2col,
roi_pool, conv3d and the 3-D pools, maxout, block_expand, the
interpolations, rotate90, max_pool2d_with_index and max_unpool2d.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.dtypes import Policy, default_policy

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
    y = F.conv2d(xc, w, stride=_pair(stride), padding=pad,
                 dilation=_pair(dilation), groups=groups)
    y = _nhwc(y).to(policy.accum_dtype)
    if bias is not None:
        y = y + bias
    return y


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
    return _nhwc(F.max_pool2d(xc, window, stride, padding=pad))


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
    summed = F.avg_pool2d(xc, win, strd, padding=pad,
                          count_include_pad=True, divisor_override=1)
    if count_include_pad or pad2 == ((0, 0), (0, 0)):
        return _nhwc(summed / (win[0] * win[1]))
    # the count of real (unpadded) elements in each window, from a ones
    # plane of the input's size
    ones = x.new_ones((1,) + tuple(x.shape[1:3]) + (1,))
    oc, pad = _padded(ones, pad2, (0, 0), 0.0)
    counts = F.avg_pool2d(oc, win, strd, padding=pad,
                          count_include_pad=True, divisor_override=1)
    return _nhwc(summed / counts)


def global_avg_pool2d(x):
    return torch.mean(x, dim=(1, 2))
