"""Sparse CTR model, wide (sparse logistic) + deep (embedding MLP)
(port of `paddle_tpu.models.ctr`).

Both tables are `parallel.sparse.ShardedEmbedding`s row-sharded over
the mesh `model` axis; lookups ride the all-to-all exchange (or the
psum one), updates are row-sparse scatter-adds. Features are multi-hot
ids padded to `slots` with the sentinel id == vocab (an empty slot).

The train step is JAX's: one backward through the GATHERED rows as
autograd leaves (never a dense [V, D] gradient), adam on the MLP, and
row SGD on the tables, so only touched rows move. Per rank, under the
all-to-all exchange, rank i of the model axis looks up and runs the
head on its own block of the batch (the flat ids' block i); the loss
and the MLP gradient are summed over the axis. Under the psum exchange
every rank gathers every row and runs the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from paddle_tpu_torch.core.mesh import Mesh
from paddle_tpu_torch.core.pytree import tree_leaves, tree_map
from paddle_tpu_torch.nn.layers import Dense
from paddle_tpu_torch.nn.module import Sequential, ShapeSpec
from paddle_tpu_torch.ops import losses
from paddle_tpu_torch.parallel import collectives as C
from paddle_tpu_torch.parallel import sparse


@dataclasses.dataclass
class CTRModel:
    """Wide & deep over sharded sparse tables.

    vocab: id space size (the sentinel id == vocab means an empty slot).
    exchange: "alltoall" (owner-routed, K * D exchange), "psum" (every
    shard contributes masked [K, D]), "auto" (alltoall when the flat id
    count divides the model axis)."""

    vocab: int
    embed_dim: int
    mesh: Mesh
    hidden: Tuple[int, ...] = (64, 32)
    exchange: str = "auto"

    def __post_init__(self):
        if self.exchange not in ("auto", "alltoall", "psum"):
            raise ValueError(f"exchange must be auto|alltoall|psum, got "
                             f"{self.exchange!r}")
        self.table = sparse.ShardedEmbedding(self.vocab + 1, self.embed_dim,
                                             self.mesh, name="deep_table")
        self.wide = sparse.ShardedEmbedding(self.vocab + 1, 1, self.mesh,
                                            name="wide_table")
        layers = [Dense(h, activation="relu", name=f"mlp{i}")
                  for i, h in enumerate(self.hidden)]
        layers.append(Dense(1, name="mlp_out"))
        self.mlp = Sequential(layers)

    @property
    def axis(self) -> str:
        return self.table.axis

    def init(self, rng, batch: int, slots: int):
        """(params {"deep", "wide", "mlp"}, mlp_state). rng: a seed; the
        tables and the MLP draw from seeds derived from it."""
        seed = int(rng)
        deep = self.table.init(3 * seed + 1)
        wide = self.wide.init(3 * seed + 2)
        mlp_p, mlp_s = self.mlp.init(3 * seed + 3,
                                     ShapeSpec((batch, self.embed_dim)),
                                     device=self.mesh.device)
        return {"deep": deep, "wide": wide, "mlp": mlp_p}, mlp_s

    def place(self, params):
        """A full parameter tree (the weight bridge's tensors) placed:
        the tables row-sharded, the MLP on the mesh's device."""
        dev = self.mesh.device
        return {"deep": self.table.place(params["deep"]),
                "wide": self.wide.place(params["wide"]),
                "mlp": tree_map(lambda t: t.to(dev), params["mlp"])}

    def _forward_from_rows(self, mlp_params, mlp_state, deep_rows,
                           wide_rows, ids, *, training: bool, rng):
        """The head given already-gathered rows (the point the backward
        differentiates at): ids [B, S] -> logits [B]."""
        b, slots = ids.shape
        valid = (ids < self.vocab)[..., None]                  # [B, S, 1]
        zero = torch.zeros((), dtype=deep_rows.dtype,
                           device=deep_rows.device)
        deep_vecs = deep_rows.reshape(b, slots, self.embed_dim)
        pooled = torch.sum(torch.where(valid, deep_vecs, zero), dim=1)
        denom = torch.clamp(valid.sum(dim=1).to(pooled.dtype), min=1.0)
        pooled = pooled / denom                                # mean pool
        deep_out, _ = self.mlp.apply(mlp_params, mlp_state, pooled,
                                     training=training, rng=rng)
        wide_vals = wide_rows.reshape(b, slots, 1)
        wide_out = torch.sum(torch.where(valid, wide_vals, zero), dim=(1, 2))
        return deep_out[:, 0] + wide_out

    def _use_alltoall(self, flat_size: int) -> bool:
        if self.exchange == "alltoall":
            return True
        if self.exchange == "psum":
            return False
        return flat_size % self.mesh.shape[self.axis] == 0

    def _block(self, ids):
        """This rank's block of the batch under the all-to-all exchange
        (the flat ids' block of the axis)."""
        n = self.mesh.shape[self.axis]
        b = ids.shape[0]
        if b % n:
            raise ValueError(f"the all-to-all CTR step runs each model "
                             f"rank on its block of the batch: batch {b} "
                             f"must divide the {n}-rank model axis")
        i = self.mesh.axis_index(self.axis)
        return ids[i * (b // n):(i + 1) * (b // n)]

    def _rows(self, params, ids):
        """(deep rows, wide rows, the ids they belong to): this rank's
        block under the all-to-all exchange, the whole batch under the
        psum one."""
        flat = ids.reshape(-1)
        if self._use_alltoall(flat.shape[0]):
            mine = self._block(ids)
            f = mine.reshape(-1)
            deep, _ = sparse.alltoall_lookup_local(params["deep"], f,
                                                   self.mesh, axis=self.axis)
            wide, _ = sparse.alltoall_lookup_local(params["wide"], f,
                                                   self.mesh, axis=self.axis)
            return deep, wide, mine
        return (self.table.lookup(params["deep"], flat),
                self.wide.lookup(params["wide"], flat), ids)

    def apply(self, params, mlp_state, ids, *, training: bool = False,
              rng=None):
        """ids [B, slots] ints (sentinel == vocab for empty) -> logits [B]
        (the whole batch, on every rank)."""
        ids = sparse._ids(ids).to(self.mesh.device)
        deep, wide, mine = self._rows(params, ids)
        logits = self._forward_from_rows(params["mlp"], mlp_state, deep,
                                         wide, mine, training=training,
                                         rng=rng)
        if mine is not ids:
            logits = C.all_gather(logits, self.axis, mesh=self.mesh)
        return logits

    def loss(self, params, mlp_state, ids, labels, *, rng=None):
        logits = self.apply(params, mlp_state, ids, training=True, rng=rng)
        return torch.mean(losses.sigmoid_cross_entropy(
            logits, sparse._ids(labels).to(logits.device).float()))

    def make_train_step(self, optimizer, mlp_state):
        """(params, opt_state, ids, labels, lr, step, rng) -> (params,
        opt_state, loss): one backward, jointly w.r.t. the MLP params
        and the gathered table rows; adam (or `optimizer`) on the MLP
        and row SGD at `lr` on the tables, all in place. opt_state:
        `optimizer.init(params["mlp"])`. The loss is the batch mean, the
        same on every rank."""

        def step(params, opt_state, ids, labels, lr, step_i, rng=None):
            dev = self.mesh.device
            ids = sparse._ids(ids).to(dev)
            labels = sparse._ids(labels).to(dev).float()
            b = ids.shape[0]
            alltoall = self._use_alltoall(ids.numel())
            with torch.no_grad():
                deep_rows, wide_rows, mine = self._rows(params, ids)
            if alltoall:
                n = self.mesh.shape[self.axis]
                i = self.mesh.axis_index(self.axis)
                labels = labels[i * (b // n):(i + 1) * (b // n)]
            deep_rows = deep_rows.detach().requires_grad_()
            wide_rows = wide_rows.detach().requires_grad_()
            live = [p.detach().requires_grad_()
                    for p in tree_leaves(params["mlp"])]
            it = iter(live)
            mlp_live = tree_map(lambda _: next(it), params["mlp"])
            logits = self._forward_from_rows(mlp_live, mlp_state, deep_rows,
                                             wide_rows, mine, training=True,
                                             rng=rng)
            # the batch mean: each rank's block sums to its share
            loss = torch.sum(losses.sigmoid_cross_entropy(logits,
                                                          labels)) / b
            grads = torch.autograd.grad(loss, live + [deep_rows, wide_rows])
            mlp_g, deep_g, wide_g = (grads[:len(live)], grads[-2],
                                     grads[-1])
            if alltoall:
                mlp_g = [C._raw_all_reduce(g, self.mesh, (self.axis,))
                         for g in mlp_g]
                loss = C._raw_all_reduce(loss.detach(), self.mesh,
                                         (self.axis,))
            it = iter(mlp_g)
            new_mlp, new_opt = optimizer.update(
                tree_map(lambda _: next(it), params["mlp"]), opt_state,
                params["mlp"], step_i)
            if alltoall:
                f = mine.reshape(-1)
                sparse.alltoall_push_row_grads_local(
                    params["deep"], f, deep_g, lr, self.mesh, axis=self.axis)
                sparse.alltoall_push_row_grads_local(
                    params["wide"], f, wide_g, lr, self.mesh, axis=self.axis)
            else:
                flat = ids.reshape(-1)
                self.table.apply_row_grads(params["deep"], flat, deep_g, lr)
                self.wide.apply_row_grads(params["wide"], flat, wide_g, lr)
            return ({"deep": params["deep"], "wide": params["wide"],
                     "mlp": new_mlp}, new_opt, loss.detach())

        return step
