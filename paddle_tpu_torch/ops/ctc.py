"""CTC loss and best-path decoding (port of `paddle_tpu.ops.ctc`).

The forward algorithm in log space over the blank-interleaved extended
label sequence, one step per frame in torch ops; autograd gives the
gradient. Impossible paths carry LOG_EPS = -1e30, a finite floor, not
-inf: an alignment that cannot be made (more labels than frames) costs
about 1e30 with finite gradients, where `F.ctc_loss` gives inf (or 0
under zero_infinity), so that library call is not used. Blank is id 0
by default.
"""

from __future__ import annotations

import torch

LOG_EPS = -1e30


def _logaddexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    finite = torch.isfinite(m)
    m_safe = torch.where(finite, m, torch.zeros_like(m))
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe)
                             + torch.exp(c - m_safe))
    return torch.where(finite, out, torch.full_like(out, LOG_EPS))


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with `jnp.logaddexp`'s gradient, g * exp(x -
    out) for each side. It differs from torch's g / (1 + exp(other -
    x)) only where out rounds back to max(a, b): two ends of an
    impossible alignment, both near LOG_EPS, each get the whole
    cotangent there, as in JAX, not half."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(log_probs, input_lengths, labels, label_lengths, *,
             blank: int = 0):
    """Negative log-likelihood per sequence [B].

    log_probs [B, T, C] (log-softmax outputs); input_lengths [B] valid
    frames; labels [B, L] int, padded, without blanks; label_lengths
    [B]. Frames past a row's length carry its alphas through
    unchanged."""
    b, t, _ = log_probs.shape
    dev = log_probs.device
    s = 2 * labels.shape[1] + 1
    input_lengths = input_lengths.to(dev)
    label_lengths = label_lengths.to(dev)
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    prev2 = torch.cat([torch.full((b, 2), -1, dtype=torch.long, device=dev),
                       ext[:, :-2]], dim=1)
    # a skip (from two back) never enters a blank or a repeated label
    is_label = (torch.arange(s, device=dev) % 2 == 1)[None, :]
    allow_skip = is_label & (ext != prev2)

    def emit(log_p_t):                                  # [B, C] -> [B, S]
        return torch.gather(log_p_t, 1, ext)

    first = emit(log_probs[:, 0])
    alpha = torch.full((b, s), LOG_EPS, dtype=log_probs.dtype, device=dev)
    alpha = torch.cat([
        first[:, :1],
        torch.where(label_lengths > 0, first[:, 1],
                    torch.full_like(first[:, 1], LOG_EPS))[:, None],
        alpha[:, 2:]], dim=1)
    eps = lambda k: torch.full((b, k), LOG_EPS, dtype=alpha.dtype,
                               device=dev)
    for step in range(1, t):
        shift1 = torch.cat([eps(1), alpha[:, :-1]], dim=1)
        shift2 = torch.cat([eps(2), alpha[:, :-2]], dim=1)
        shift2 = torch.where(allow_skip, shift2, torch.full_like(shift2,
                                                                 LOG_EPS))
        new = _logaddexp3(alpha, shift1, shift2) + emit(log_probs[:, step])
        alpha = torch.where((step < input_lengths)[:, None], new, alpha)

    last_label = torch.clamp(2 * label_lengths - 1, 0, s - 1).long()
    last_blank = torch.clamp(2 * label_lengths, 0, s - 1).long()
    a_label = torch.gather(alpha, 1, last_label[:, None])[:, 0]
    a_blank = torch.gather(alpha, 1, last_blank[:, None])[:, 0]
    a_label = torch.where(label_lengths > 0, a_label,
                          torch.full_like(a_label, LOG_EPS))
    return -_LogAddExp.apply(a_label, a_blank)


def ctc_greedy_decode(log_probs, input_lengths, *, blank: int = 0):
    """Best path: argmax per frame, repeats collapsed, blanks and frames
    past the length dropped. Returns (decoded [B, T] int64 padded with
    -1, decoded_lengths [B])."""
    b, t, _ = log_probs.shape
    dev = log_probs.device
    best = torch.argmax(log_probs, dim=-1)                       # [B, T]
    frame_valid = torch.arange(t, device=dev)[None, :] < \
        input_lengths.to(dev)[:, None]
    prev = torch.cat([torch.full((b, 1), -1, dtype=best.dtype, device=dev),
                      best[:, :-1]], dim=1)
    keep = (best != blank) & (best != prev) & frame_valid
    # kept ids go to their compacted slot; dropped ones to a spare last
    # column, cut off after the scatter
    slot = torch.where(keep, torch.cumsum(keep, dim=1) - 1,
                       torch.full_like(best, t))
    out = torch.full((b, t + 1), -1, dtype=best.dtype, device=dev)
    out.scatter_(1, slot, best)
    return out[:, :t], keep.sum(dim=1)
