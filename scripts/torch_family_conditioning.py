#!/usr/bin/env python3
"""How well conditioned is a first step's f32 gradient of the
quick_start db_lstm (or bidi_lstm, or SRL) at chip_smoke's widths?

    python3 scripts/torch_family_conditioning.py [--model db_lstm]

The model's weights and first batch are chip_smoke.py's. Each leaf's
gradient is computed five ways and held against a float64 truth on the
CPU (the masked scan, impl="scan", which computes in float64):
  kernels    the card, kernels D and E (f32);
  plain_cuda the card, their plain versions (impl="torch", f32);
  cpu        the CPU, their plain versions (f32);
  cpu_ulp    the same after a one-ulp nudge of the embedding table;
and cpu_ulp against cpu (the CPU's own one-ulp spread, which
chip_smoke's db_lstm gate reads) and kernels against cpu (the gate).
Errors are max abs error over the leaf's max |reference|, floored as
the smoke's (LEAF_FLOOR of the largest gradient). Prints one line per leaf and a JSON summary; needs a
card (the CPU-only rows run without one with --cpu-only).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as S  # noqa: E402
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map  # noqa: E402
from paddle_tpu_torch.core.pytree import tree_map_with_name  # noqa: E402
from paddle_tpu_torch.core import dtypes as TD  # noqa: E402
from paddle_tpu_torch.models import quick_start as TQ  # noqa: E402
from paddle_tpu_torch.models import srl as TSRL  # noqa: E402


def model(name):
    """(loss_fn, params_cpu, first batch) as chip_smoke's phase builds
    them (the same seed and draw order)."""
    rs = np.random.RandomState(13)
    srl_b = S.srl_batches(S.FAMILY_STEPS + 2, seed=0)
    qs_b = S.imdb_batches(S.FAMILY_STEPS + 1, seed=0)
    srl_p = TSRL.init_params(rs, device="cpu", **S.SRL_CFG)
    if name == "srl":
        return TSRL.loss, srl_p, srl_b[0]
    bidi = TQ.init_bidi_lstm(rs, S.QS_VOCAB, embed_dim=S.QS_EMBED,
                             hidden=S.QS_H, device="cpu")
    if name == "bidi_lstm":
        return S.qs_loss(TQ.bidi_lstm), bidi, qs_b[0]
    db = TQ.init_db_lstm(rs, S.QS_VOCAB, embed_dim=S.QS_EMBED,
                         hidden=S.QS_H, depth=S.QS_DEPTH, device="cpu")
    return S.qs_loss(TQ.db_lstm), db, qs_b[0]


def grads(loss_fn, params, batch, device, impl, dtype=torch.float32):
    p = tree_map(lambda t: t.detach().to(device, dtype).clone()
                 .requires_grad_(True), params)
    b = [x.to(device) for x in batch]
    loss = loss_fn(p, *b, impl=impl)
    return [g.detach().cpu().double() for g in
            torch.autograd.grad(loss, tree_leaves(p))], loss.item()


def errs(got, want):
    top = max(w.abs().max().item() for w in want)
    return [(g - w).abs().max().item() / max(w.abs().max().item(),
                                              S.LEAF_FLOOR * top, 1e-300)
            for g, w in zip(got, want)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="db_lstm",
                    choices=("db_lstm", "bidi_lstm", "srl"))
    ap.add_argument("--cpu-only", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    loss_fn, params, batch = model(args.model)
    names = []
    tree_map_with_name(lambda n, _: names.append(n), params)

    prev = TD.default_policy()
    f64 = TD.Policy(torch.float64, torch.float64, torch.float64)
    TD.set_default_policy(f64)
    try:
        truth, t_loss = grads(loss_fn, params, batch, "cpu", "scan",
                              torch.float64)
    finally:
        TD.set_default_policy(prev)
    runs = {}
    runs["cpu"], _ = grads(loss_fn, params, batch, "cpu", None)
    nudged = dict(params)
    key = "embed" if "embed" in params else "word_table"
    nudged[key] = torch.nextafter(params[key], torch.full_like(
        params[key], float("inf")))
    runs["cpu_ulp"], _ = grads(loss_fn, nudged, batch, "cpu", None)
    if not args.cpu_only:
        runs["kernels"], _ = grads(loss_fn, params, batch, "cuda", None)
        runs["plain_cuda"], _ = grads(loss_fn, params, batch, "cuda",
                                      "torch")
    table = {k: errs(v, truth) for k, v in runs.items()}
    table["cpu_ulp_vs_cpu"] = errs(runs["cpu_ulp"], runs["cpu"])
    if "kernels" in runs:
        table["kernels_vs_cpu"] = errs(runs["kernels"], runs["cpu"])
    cols = list(table)
    print(f"{args.model}: f64 loss {t_loss:.9f}; per leaf, max abs error "
          f"over max |reference| (float64 truth unless named)")
    print(f"{'leaf':<16} {'max|truth|':>11} " + " ".join(
        f"{c:>14}" for c in cols))
    for i, n in enumerate(names):
        print(f"{n:<16} {truth[i].abs().max().item():11.3e} " + " ".join(
            f"{table[c][i]:14.2e}" for c in cols))
    summary = {c: max(v) for c, v in table.items()}
    if torch.cuda.is_available():
        summary["card"] = torch.cuda.get_device_name(0)
    print(json.dumps({"model": args.model, "max_rel_err": summary}))


if __name__ == "__main__":
    main()
