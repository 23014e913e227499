"""Loss functions (port of `paddle_tpu.ops.losses`).

The reference's cost layers and Fluid loss ops, each returning
per-example values (reduce with weights through `reduce_loss`), and
`chunked_lm_head_nll`, the LM head fused with its NLL. Each function is
the JAX package's formula op for op on tensors of any device: a CUDA
tensor computes on the card, a CPU tensor on the CPU. `softplus` is
`activations.softplus`, `logaddexp(x, 0)` as `jax.nn.softplus` (torch's
`F.softplus` switches to x above 20). `lambda_rank_segment` ranks by a
stable sort, so tied scores keep the lower index first, as
`jnp.argsort` does."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch.core.dtypes import at_least_f32
from paddle_tpu_torch.ops import linalg
from paddle_tpu_torch.ops.activations import softplus


def _sum_but_first(x):
    # torch.sum over dim=() sums every axis; jnp.sum over axis=() none
    if x.ndim <= 1:
        return x
    return torch.sum(x, dim=tuple(range(1, x.ndim)))


def reduce_loss(per_example, weights=None, reduction: str = "mean"):
    """"mean" (weighted: sum(w * l) / max(sum(w), 1)), "sum", or anything
    else: the per-example values (times the weights)."""
    if weights is not None:
        per_example = per_example * weights
    if reduction == "mean":
        if weights is not None:
            return torch.sum(per_example) / torch.clamp(torch.sum(weights),
                                                        min=1.0)
        return torch.mean(per_example)
    if reduction == "sum":
        return torch.sum(per_example)
    return per_example


def softmax_cross_entropy(logits, labels, *, label_smoothing: float = 0.0):
    """Integer-label softmax CE. logits [..., C], labels [...] int ->
    per-example loss [...] (at least f32)."""
    num_classes = logits.shape[-1]
    log_p = torch.log_softmax(at_least_f32(logits), dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), num_classes).to(
        log_p.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + \
            label_smoothing / num_classes
    return -torch.sum(onehot * log_p, dim=-1)


def soft_label_cross_entropy(logits, soft_labels):
    """Soft-label CE: -sum(soft_labels * log_softmax(logits))."""
    log_p = torch.log_softmax(at_least_f32(logits), dim=-1)
    return -torch.sum(soft_labels * log_p, dim=-1)


def cross_entropy_with_probs(probs, labels, *, epsilon: float = 1e-8):
    """CE on probabilities already softmaxed: -log(p[label] + eps)."""
    p = torch.gather(probs, -1, labels.long()[..., None])[..., 0]
    return -torch.log(p + epsilon)


def sigmoid_cross_entropy(logits, labels):
    """Element-wise binary CE from logits, in the numerically stable
    form max(x, 0) - x * y + log1p(exp(-|x|)) (at least f32)."""
    logits = at_least_f32(logits)
    labels = at_least_f32(labels)
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def multi_binary_label_cross_entropy(logits, labels):
    """Multi-label binary CE summed over the classes."""
    return torch.sum(sigmoid_cross_entropy(logits, labels), dim=-1)


def squared_error(pred, target):
    """Per-example 0.5 * ||pred - target||^2 over every axis but the
    first."""
    d = at_least_f32(pred - target)
    return 0.5 * _sum_but_first(torch.square(d))


mse = squared_error


def huber_regression(pred, target, delta: float = 1.0):
    """Per-example Huber loss: 0.5 d^2 where |d| <= delta, else
    delta * (|d| - delta / 2), summed over every axis but the first."""
    d = torch.abs(at_least_f32(pred - target))
    per_elem = torch.where(d <= delta, 0.5 * torch.square(d),
                           delta * (d - 0.5 * delta))
    return _sum_but_first(per_elem)


def huber_classification(pred, labels):
    """Huber loss for {0, 1} labels: with a = (2y - 1) * pred, -4a where
    a < -1, else max(1 - a, 0)^2. pred [B, 1] is squeezed to labels'
    shape."""
    y = 2.0 * at_least_f32(labels) - 1.0
    z = at_least_f32(pred)
    if pred.ndim > labels.ndim:
        z = z.squeeze(-1)
    a = y * z
    return torch.where(a < -1.0, -4.0 * a,
                       torch.square(torch.clamp(1.0 - a, min=0.0)))


#: Fluid's name for the same formula (modified_huber_loss_op.cc)
modified_huber_loss = huber_classification


def smooth_l1(pred, target, sigma: float = 1.0):
    """Smooth-L1 summed over every axis but the first: 0.5 sigma^2 d^2
    where |d| < 1 / sigma^2, else |d| - 0.5 / sigma^2."""
    sigma2 = sigma * sigma
    d = at_least_f32(pred - target)
    ad = torch.abs(d)
    per_elem = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * torch.square(d),
                           ad - 0.5 / sigma2)
    return _sum_but_first(per_elem)


def hinge_loss(logits, labels):
    """max(0, 1 - (2y - 1) * logits) for {0, 1} labels."""
    y = 2.0 * at_least_f32(labels) - 1.0
    return torch.clamp(1.0 - y * at_least_f32(logits), min=0.0)


def rank_cost(left, right, label):
    """Pairwise rank cost softplus(o) - label * o, o = left - right;
    label in [0, 1] is P(left ranked above right)."""
    o = at_least_f32(left - right)
    return softplus(o) - label * o


def margin_rank_loss(left, right, label, margin: float = 0.0):
    """max(0, -label * (left - right) + margin), label in {-1, +1}."""
    return torch.clamp(-label * (left - right) + margin, min=0.0)


def lambda_rank_segment(scores, relevance, *, ndcg_num: int = 5):
    """LambdaRank cost of ONE query list: scores, relevance [L] ->
    scalar, the pairwise softplus(-(s_i - s_j)) over pairs with rel_i >
    rel_j, each weighted by |delta NDCG| (ideal DCG over the top
    ndcg_num). Ranks come from a stable descending sort of the scores."""
    scores = at_least_f32(scores)
    rel = at_least_f32(relevance)
    n = scores.shape[0]
    dev = scores.device
    gains = torch.pow(2.0, rel) - 1.0
    sorted_gains = torch.sort(gains, descending=True).values
    ar = torch.arange(n, device=dev)
    discounts = 1.0 / torch.log2(ar.to(gains.dtype) + 2.0)
    topk_mask = (ar < ndcg_num).to(gains.dtype)
    ideal_dcg = torch.sum(sorted_gains * discounts * topk_mask)
    inv_idcg = torch.where(ideal_dcg > 0,
                           1.0 / torch.clamp(ideal_dcg, min=1e-12),
                           torch.zeros_like(ideal_dcg))
    order = torch.sort(-scores, stable=True).indices
    ranks = torch.empty_like(order).scatter_(0, order, ar)
    disc = 1.0 / torch.log2(ranks.to(scores.dtype) + 2.0)
    sij = scores[:, None] - scores[None, :]
    delta_ndcg = torch.abs((gains[:, None] - gains[None, :])
                           * (disc[:, None] - disc[None, :])) * inv_idcg
    higher = (rel[:, None] > rel[None, :]).to(scores.dtype)
    return torch.sum(softplus(-sij) * delta_ndcg * higher)


def cos_sim(a, b, scale: float = 1.0, epsilon: float = 1e-8):
    """scale * <a, b> / max(|a| |b|, eps) over the last axis."""
    a32, b32 = at_least_f32(a), at_least_f32(b)
    dot = torch.sum(a32 * b32, dim=-1)
    na = torch.sqrt(torch.sum(torch.square(a32), dim=-1))
    nb = torch.sqrt(torch.sum(torch.square(b32), dim=-1))
    return scale * dot / torch.clamp(na * nb, min=epsilon)


def squared_l2_distance(x, y):
    """Row-wise squared L2 distance, without squared_error's 1/2."""
    return 2.0 * squared_error(x, y)


def l1_norm(x):
    """sum |x|."""
    return torch.sum(torch.abs(at_least_f32(x)))


def squared_l2_norm(x):
    """sum x^2."""
    return torch.sum(torch.square(at_least_f32(x)))


def chunked_lm_head_nll(hidden, kernel, targets, *, chunk: int = 2048,
                        bias=None):
    """Next-token NLL fused with the LM-head matmul, never holding the
    full [N, V] logits.

    The N = B*T positions (padded to whole chunks) go through the head
    `chunk` rows at a time, each chunk inside `torch.utils.checkpoint`:
    the forward keeps only the per-position nll, and the backward
    recomputes a chunk's logits right before it consumes them.

    hidden [B, T, D] (compute dtype), kernel [D, V], targets [B, T] int,
    bias optional [V]. Returns per-position nll [B, T] f32 (logits in
    at least f32, logsumexp minus the gold logit)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    b, t, d = hidden.shape
    n = b * t
    h = hidden.reshape(n, d)
    y = targets.reshape(n).long()
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    if pad:
        h = torch.cat([h, h.new_zeros((pad, d))])
        y = torch.cat([y, y.new_zeros((pad,))])

    def body(hc, yc):
        logits = at_least_f32(linalg.matmul(hc, kernel))
        if bias is not None:
            logits = logits + at_least_f32(bias)[None, :]
        # the gold logit keeps its last dim until the subtraction (a
        # vocab-sharded DTensor's gather is a masked partial sum whose
        # mask has the gather's shape)
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        gold = torch.gather(logits, 1, yc[:, None])
        return (lse - gold)[:, 0]

    grad = torch.is_grad_enabled()
    nll = []
    for i in range(n_chunks):
        rows = slice(i * chunk, (i + 1) * chunk)
        nll.append(checkpoint(body, h[rows], y[rows], use_reentrant=False)
                   if grad else body(h[rows], y[rows]))
    return torch.cat(nll)[:n].reshape(b, t)
