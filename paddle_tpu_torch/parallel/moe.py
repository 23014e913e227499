"""Mixture-of-experts FFN on one device (port of the single-device part
of `paddle_tpu.parallel.moe`).

GShard/Switch dispatch with a FIXED per-expert capacity C: a top-k
softmax router with the load-balancing aux loss, tokens over capacity
dropped (combine weight 0; the residual stream carries them), and two
dispatches that compute the same numbers -- one-hot einsums over a dense
[T, E, C] tensor for small shapes, an index scatter and gather for large
ones (`_use_scatter`, by the dense tensor's size). Expert-choice routing
(each expert takes its top-C tokens) is the other router.

The routing decides which expert computes a token, so its tie-breaking
follows JAX's exactly: top-k routing takes `torch.argmax` round by round
(the first maximum, as `jnp.argmax`), the gate is `torch.amax` (its
gradient splits among tied maxima, as `jnp.max`'s does), capacity slots
go in token order by a cumsum, and expert choice orders tokens by a
stable descending sort (ties to the lower index, as `lax.top_k`).

Randomness: the router jitter is a [T, E] multiplier drawn uniformly in
[1 - jitter, 1 + jitter) from a `torch.Generator`, or injected
(`jitter_noise=`) so a test can hand over JAX's own draws.

Expert parallelism (`shard_moe_params`, `make_expert_parallel_ffn`):
experts sharded over the mesh `model` axis; per-rank code routes the
rank's tokens and exchanges the dispatched [E, C, D] block with ONE
tiled all-to-all each way (`collectives.all_to_all`), or, with the
tokens replicated, runs the local experts' assignments only and sums
the partial combines.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.core.pytree import tree_map
from paddle_tpu_torch.nn import initializers


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MoEOutput(NamedTuple):
    y: torch.Tensor          # [T, D] combined expert outputs
    aux_loss: torch.Tensor   # scalar load-balancing loss
    dropped: torch.Tensor    # scalar fraction of tokens over capacity


def init_moe_params(rng, n_experts: int, d_model: int, d_ff: int,
                    dtype=torch.float32, *, device=None):
    """Stacked expert FFNs + router, the JAX tree and distributions:
    router normal(0.02) [D, E], w1 [E, D, F] and w2 [E, F, D] smart
    uniform per expert, zero biases. rng: an int seed, a numpy
    RandomState or a CPU torch.Generator, drawn router, then w1 by
    expert, then w2 by expert. device None -> cuda."""
    dev = resolve_device(device)
    rng = initializers.as_rng(rng)
    smart = initializers.smart_uniform()
    router = initializers.normal(0.02)(rng, (d_model, n_experts))
    w1 = torch.stack([smart(rng, (d_model, d_ff)) for _ in range(n_experts)])
    w2 = torch.stack([smart(rng, (d_ff, d_model)) for _ in range(n_experts)])
    params = {"router": {"kernel": router}, "w1": w1,
              "b1": torch.zeros((n_experts, d_ff)), "w2": w2,
              "b2": torch.zeros((n_experts, d_model))}
    return tree_map(lambda a: a.to(dev, dtype), params)


def shard_moe_params(params, mesh, *, axis: str = "model"):
    """Expert-shard the stacked weights over `axis` (router replicated):
    DTensors on the mesh; params are full tensors, the same on every
    rank."""
    from paddle_tpu_torch.core.mesh import NamedSharding, P, distribute

    e = params["w1"].shape[0]
    if e % mesh.shape[axis] != 0:
        raise ValueError(f"{e} experts not divisible by {axis} axis size "
                         f"{mesh.shape[axis]}")

    def put(x, spec):
        return distribute(x, NamedSharding(mesh, spec))

    return {
        "router": {"kernel": put(params["router"]["kernel"], P())},
        "w1": put(params["w1"], P(axis)), "b1": put(params["b1"], P(axis)),
        "w2": put(params["w2"], P(axis)), "b2": put(params["b2"], P(axis)),
    }


def make_expert_parallel_ffn(mesh, *, axis: str = "model",
                             data_axis=None, k: int = 2,
                             capacity_factor: float = 1.25,
                             jitter: float = 0.0, activation=_gelu,
                             dispatch_impl: str = "auto"):
    """Build an expert-parallel MoE FFN over `mesh`, run by every rank.

    Experts are sharded over `axis` (shard_moe_params). With
    `data_axis`, the token axis is split over (data_axis, axis) jointly:
    each rank routes its own tokens, dispatches into [E, C_loc, D], ONE
    tiled all-to-all regroups the block so every rank holds its OWN
    experts' tokens from all ranks of `axis`, the FFN runs over the
    local experts, and the mirrored all-to-all brings the results home
    for the local combine. Without it the tokens are replicated: every
    rank computes the same routing, runs only its local experts'
    assignments and sums the partial combines (no all-to-all, 1/n the
    expert FLOPs).

    Returns fn(params, x [T, D], rng=None, jitter_noise=None) ->
    MoEOutput, y a DTensor placed like the tokens (sharded over
    (data_axis, axis), or replicated), aux_loss and dropped the same on
    every rank. params: shard_moe_params's DTensors or full tensors; x:
    the full [T, D] (a plain tensor, the same on every rank) or a
    DTensor. T must divide by the ranks it is split over. jitter: the
    router jitter, drawn from `rng` per rank, or taken from
    `jitter_noise` [T, E] (split like x: JAX's per-shard draws laid end
    to end). Replicated values the per-rank code uses differently
    (router, replicated tokens) enter through `collectives.pvary`, so
    their gradients come back whole on every rank."""
    from paddle_tpu_torch.parallel import collectives as C

    n_exp_shards = mesh.shape[axis]
    tok_axes = (data_axis, axis) if data_axis else None
    tok_spec = (tok_axes, None) if data_axis else (None, None)

    def fn(params, x, rng=None, jitter_noise=None):
        w_local = {n: C.shard_local(params[n], (axis,) + (None,) * (
            params[n].ndim - 1), mesh=mesh)
            for n in ("w1", "b1", "w2", "b2")}
        router = params["router"]["kernel"]
        if hasattr(router, "full_tensor"):
            router = router.full_tensor()
        x_full_shape = x.shape
        x_loc = C.shard_local(x, tok_spec, mesh=mesh)
        noise = None
        if jitter_noise is not None:
            noise = C.shard_local(jitter_noise, tok_spec, mesh=mesh).detach()
        t_loc, d = x_loc.shape
        e_loc = w_local["w1"].shape[0]
        e = e_loc * n_exp_shards
        cap = capacity_for(t_loc, e, capacity_factor, k)
        if data_axis is None:
            # tokens replicated: identical routing on every rank; only
            # the local experts' assignments run, partial combines summed
            logits = x_loc @ router
            routing = top_k_routing(logits, k, cap, rng=rng, jitter=jitter,
                                    jitter_noise=noise)
            shard = mesh.axis_index(axis)
            local_e = routing.expert - shard * e_loc
            in_range = (local_e >= 0) & (local_e < e_loc) & routing.keep
            gate = C.pvary(routing.gate, axis, mesh=mesh)
            r_loc = routing._replace(
                expert=torch.clamp(local_e, 0, e_loc - 1), keep=in_range,
                gate=gate * in_range.float())
            xv = C.pvary(x_loc, axis, mesh=mesh)
            local_in, dense_c = _dispatch_expert_in(r_loc, xv, e_loc, cap,
                                                    dispatch_impl)
            out = _expert_ffn(w_local, local_in, activation)
            y = _combine_out(r_loc, dense_c, out, cap)
            y = C.all_reduce_sum(y, axis, mesh=mesh).to(x_loc.dtype)
            aux, dropped = routing.aux_loss, routing.dropped
        else:
            # each data replica of an expert sees other tokens
            w_local = {n: C.pvary(w, data_axis, mesh=mesh)
                       for n, w in w_local.items()}
            router_v = C.pvary(router, tok_axes, mesh=mesh)
            logits = x_loc @ router_v
            routing = top_k_routing(logits, k, cap, rng=rng, jitter=jitter,
                                    jitter_noise=noise)
            expert_in, combine = _dispatch_expert_in(routing, x_loc, e, cap,
                                                     dispatch_impl)
            # rank j receives its local experts' buffers from every rank
            recv = C.all_to_all(expert_in, axis, split_axis=0,
                                concat_axis=0, mesh=mesh)
            grouped = recv.reshape(n_exp_shards, e_loc, cap, d) \
                .transpose(0, 1).reshape(e_loc, n_exp_shards * cap, d)
            out = _expert_ffn(w_local, grouped, activation)
            back = out.reshape(e_loc, n_exp_shards, cap, d).transpose(0, 1) \
                .reshape(n_exp_shards * e_loc, cap, d)
            home = C.all_to_all(back, axis, split_axis=0, concat_axis=0,
                                mesh=mesh)
            y = _combine_out(routing, combine, home, cap).to(x_loc.dtype)
            aux = C.all_reduce_mean(routing.aux_loss, tok_axes, mesh=mesh)
            dropped = C.all_reduce_mean(routing.dropped, tok_axes, mesh=mesh)
        y = C.from_local(y, tok_spec, x_full_shape, mesh=mesh)
        return MoEOutput(y, aux, dropped)

    return fn


def capacity_for(n_tokens: int, n_experts: int,
                 capacity_factor: float = 1.25, k: int = 1, *,
                 multiple: int = 4) -> int:
    """Static per-expert capacity: factor * k * tokens / experts, rounded
    up to `multiple`."""
    raw = max(1, int(capacity_factor * k * n_tokens / n_experts))
    return -(-raw // multiple) * multiple


class Routing(NamedTuple):
    """Index-form routing: per round r < k and token t, token t goes to
    `expert[r, t]` slot `slot[r, t]` with weight `gate[r, t]` (0 when
    dropped)."""
    expert: torch.Tensor    # [k, T] int64
    slot: torch.Tensor      # [k, T] int64
    keep: torch.Tensor      # [k, T] bool
    gate: torch.Tensor      # [k, T] f32, kept-renormalized per token
    aux_loss: torch.Tensor  # scalar
    dropped: torch.Tensor   # scalar


def _valid(token_mask, t, device):
    if token_mask is None:
        return torch.ones(t, dtype=torch.float32, device=device)
    return token_mask.to(device=device, dtype=torch.float32)


def top_k_routing(router_logits, k: int, capacity: int, *, rng=None,
                  jitter: float = 0.0, token_mask=None,
                  jitter_noise=None) -> Routing:
    """Top-k expert assignment with fixed capacity, in index form.

    router_logits [T, E]; token_mask [T] bool: False positions (padding)
    claim no capacity, add nothing to the aux loss and do not count as
    dropped. jitter > 0 scales the logits by a uniform draw in [1 -
    jitter, 1 + jitter): `jitter_noise` [T, E] if given, else drawn from
    `rng` (a torch.Generator on the logits' device). aux_loss is E *
    sum_e(token_fraction_e * mean_router_prob_e), 1.0 at balance."""
    t, e = router_logits.shape
    dev = router_logits.device
    if jitter > 0.0 and (rng is not None or jitter_noise is not None):
        if jitter_noise is None:
            jitter_noise = torch.empty_like(router_logits).uniform_(
                1.0 - jitter, 1.0 + jitter, generator=rng)
        router_logits = router_logits * jitter_noise.to(router_logits.dtype)
    probs = torch.softmax(router_logits.float(), dim=-1)
    valid = _valid(token_mask, t, dev)

    claimed = torch.zeros(e, dtype=torch.float32, device=dev)
    masked = probs
    first_mask = None
    kept_any = torch.zeros(t, dtype=torch.bool, device=dev)
    experts, slots, keeps, gates = [], [], [], []
    for _ in range(k):
        gate = torch.amax(masked, dim=-1) * valid               # [T]
        choice = torch.argmax(masked, dim=-1)                   # [T]
        onehot = F.one_hot(choice, e).float() * valid[:, None]  # pads: 0
        if first_mask is None:
            first_mask = onehot
        # each token's position in its chosen expert's buffer
        pos = (torch.cumsum(onehot, dim=0) - onehot) + claimed[None, :]
        pos_tok = torch.sum(pos * onehot, dim=-1).long()        # [T]
        keep = (pos_tok < capacity) & (valid > 0)
        kept_any = kept_any | keep
        experts.append(choice)
        slots.append(torch.clamp(pos_tok, max=capacity - 1))
        keeps.append(keep)
        gates.append(gate * keep.float())
        claimed = claimed + torch.sum(onehot * keep[:, None].float(), dim=0)
        masked = masked * (1.0 - onehot)                        # next choice

    gate_kt = torch.stack(gates)                                # [k, T]
    # renormalized over the KEPT gates of each token
    denom = torch.sum(gate_kt, dim=0, keepdim=True)
    gate_kt = torch.where(denom > 0,
                          gate_kt / torch.clamp(denom, min=1e-9), 0.0)

    n_valid = torch.clamp(torch.sum(valid), min=1.0)
    frac_tokens = torch.sum(first_mask, dim=0) / n_valid        # [E]
    mean_prob = torch.sum(probs * valid[:, None], dim=0) / n_valid
    aux = e * torch.sum(frac_tokens * mean_prob)
    dropped = 1.0 - torch.sum(kept_any.float() * valid) / n_valid
    return Routing(torch.stack(experts), torch.stack(slots),
                   torch.stack(keeps), gate_kt, aux, dropped)


class ECRouting(NamedTuple):
    """Expert-choice routing: token_idx[e, c] fills expert e's slot c
    with combine weight gate[e, c] (0 for masked padding)."""
    token_idx: torch.Tensor  # [E, C] int64
    gate: torch.Tensor       # [E, C] f32
    dropped: torch.Tensor    # scalar: fraction of valid tokens unpicked


def expert_choice_routing(router_logits, capacity: int, *,
                          token_mask=None) -> ECRouting:
    """Each expert takes its top-`capacity` tokens by router probability
    (perfect balance, no aux loss); a token may be picked by several
    experts or none. Ties go to the lower token index (a stable
    descending sort, as `lax.top_k`)."""
    t, e = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    if token_mask is not None:
        probs = probs * token_mask.to(probs.device, torch.float32)[:, None]
    gate, token_idx = torch.sort(probs.t(), dim=-1, descending=True,
                                 stable=True)
    gate, token_idx = gate[:, :capacity], token_idx[:, :capacity]
    picked = torch.zeros(t, dtype=torch.bool, device=probs.device)
    picked[token_idx.reshape(-1)] = True
    valid = (torch.ones(t, dtype=torch.bool, device=probs.device)
             if token_mask is None else token_mask.to(probs.device, torch.bool))
    n_valid = torch.clamp(torch.sum(valid.float()), min=1.0)
    dropped = 1.0 - torch.sum((picked & valid).float()) / n_valid
    return ECRouting(token_idx, gate, dropped)


def expert_choice_ffn(params, x, *, capacity_factor: float = 2.0,
                      token_mask=None, activation=_gelu) -> MoEOutput:
    """MoE FFN under expert-choice routing. x: [T, D]. Capacity per
    expert = capacity_factor * T / E, at most T (decode steps route as
    few tokens as there are rows)."""
    t, d = x.shape
    e = params["w1"].shape[0]
    cap = min(capacity_for(t, e, capacity_factor), t)
    logits = x @ params["router"]["kernel"]
    r = expert_choice_routing(logits, cap, token_mask=token_mask)
    flat = r.token_idx.reshape(-1)
    expert_in = x[flat].reshape(e, cap, d)                   # pure gather
    out = _expert_ffn(params, expert_in, activation)
    weighted = (r.gate[..., None] * out.float()).reshape(e * cap, d)
    y = torch.zeros((t, d), dtype=torch.float32,
                    device=x.device).index_add(0, flat, weighted)
    return MoEOutput(y.to(x.dtype), torch.zeros((), device=x.device),
                     r.dropped)


def top_k_gating(router_logits, k: int, capacity: int, *, rng=None,
                 jitter: float = 0.0, token_mask=None):
    """Dense [T, E, C] (dispatch, combine, aux_loss, dropped_frac) from
    top_k_routing: O(T*E*C) memory, for small shapes and tests."""
    e = router_logits.shape[1]
    r = top_k_routing(router_logits, k, capacity, rng=rng, jitter=jitter,
                      token_mask=token_mask)
    dispatch, combine = _dense_from_routing(r, e, capacity)
    return dispatch, combine, r.aux_loss, r.dropped


def _dense_from_routing(r: Routing, e: int, capacity: int):
    keep = r.keep[..., None].float()
    eo = F.one_hot(r.expert, e).float() * keep                  # [k, T, E]
    so = F.one_hot(r.slot, capacity).float() * keep             # [k, T, C]
    sel = eo[:, :, :, None] * so[:, :, None, :]                 # [k, T, E, C]
    dispatch = torch.sum(sel, dim=0)
    combine = torch.sum(r.gate[:, :, None, None] * sel, dim=0)
    return dispatch, combine


# element-count ceiling for materializing the dense [T, E, C] dispatch
# tensor: at LM shapes C grows with T, so the tensor is quadratic in T
# (2^24 f32 elements = 64 MiB)
_EINSUM_DISPATCH_MAX = 1 << 24


def _use_scatter(impl: str, t: int, e: int, cap: int) -> bool:
    if impl == "auto":
        return t * e * cap > _EINSUM_DISPATCH_MAX
    if impl in ("scatter", "einsum"):
        return impl == "scatter"
    raise ValueError(f"dispatch_impl must be auto|einsum|scatter, got {impl}")


def _dispatch_expert_in(routing: Routing, x, e: int, cap: int, impl: str):
    """[E, C, D] expert inputs by the dispatch _use_scatter picks, and
    the dense combine tensor where the einsum path built one (else
    None)."""
    if _use_scatter(impl, x.shape[0], e, cap):
        return scatter_dispatch(routing, x, e, cap), None
    dispatch, combine = _dense_from_routing(routing, e, cap)
    ein = torch.einsum("tec,td->ecd", dispatch, x.float()).to(x.dtype)
    return ein, combine


def _combine_out(routing: Routing, dense_combine, out_ecd, cap: int):
    """Per-token combine matching _dispatch_expert_in's dispatch."""
    if dense_combine is None:
        return gather_combine(routing, out_ecd, cap)
    return torch.einsum("tec,ecd->td", dense_combine, out_ecd.float())


def scatter_dispatch(routing: Routing, x, n_experts: int, capacity: int):
    """[E, C, D] expert inputs by an index add, O(k*T + E*C*D) memory.
    Each kept (expert, slot) cell receives exactly one token, so the sum
    is a copy and its order cannot change a bit; dropped assignments
    land in a dump row that is cut off."""
    k, t = routing.expert.shape
    d = x.shape[-1]
    flat = routing.expert * capacity + routing.slot             # [k, T]
    flat = torch.where(routing.keep, flat, n_experts * capacity)
    xs = x.expand(k, t, d).reshape(k * t, d)
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=x.dtype,
                      device=x.device).index_add(0, flat.reshape(-1), xs)
    return buf[:-1].reshape(n_experts, capacity, d)


def gather_combine(routing: Routing, expert_out, capacity: int):
    """y[t] = sum_r gate[r, t] * out[expert[r, t], slot[r, t]]: the gate
    is 0 for a dropped assignment, so the row it gathers is discarded."""
    e, c, d = expert_out.shape
    flat_out = expert_out.reshape(e * c, d).float()
    flat = routing.expert * capacity + routing.slot             # [k, T]
    picked = flat_out[flat.reshape(-1)].reshape(*flat.shape, d)
    return torch.sum(routing.gate[..., None] * picked, dim=0)   # [T, D]


def _expert_ffn(params, x, activation):
    """x [E, C, D] -> [E, C, D] through the stacked weights."""
    h = torch.einsum("ecd,edf->ecf", x, params["w1"]) \
        + params["b1"][:, None, :]
    h = activation(h)
    return torch.einsum("ecf,efd->ecd", h, params["w2"]) \
        + params["b2"][:, None, :]


def moe_ffn(params, x, *, k: int = 2, capacity_factor: float = 1.25,
            rng=None, jitter: float = 0.0, token_mask=None,
            activation=_gelu, dispatch_impl: str = "auto") -> MoEOutput:
    """Single-device MoE FFN. x: [T, D] (flatten [B, S, D] first).
    token_mask [T] bool: padding neither claims capacity nor biases the
    aux loss. dispatch_impl: "einsum" (one-hot products over [T, E, C]),
    "scatter" (index add and gather), "auto" by the dense tensor's
    size."""
    t, d = x.shape
    e = params["w1"].shape[0]
    cap = capacity_for(t, e, capacity_factor, k)
    logits = x @ params["router"]["kernel"]
    routing = top_k_routing(logits, k, cap, rng=rng, jitter=jitter,
                            token_mask=token_mask)
    expert_in, dense_combine = _dispatch_expert_in(routing, x, e, cap,
                                                   dispatch_impl)
    expert_out = _expert_ffn(params, expert_in, activation)
    y = _combine_out(routing, dense_combine, expert_out, cap)
    return MoEOutput(y.to(x.dtype), routing.aux_loss, routing.dropped)
