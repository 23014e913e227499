"""CTR serving: feature ids -> cached gather -> dense tower forward (port
of `paddle_tpu.serve.ctr`).

A request is a batch of examples, each a fixed number of feature-id
slots (-1 pads empty slots); scoring is

    rows   = TieredEmbedCache.lookup(ids)        # the hot-row tier
    pooled = mean over valid slots               # per example
    score  = sigmoid(relu(pooled @ w1 + b1) @ w2 + b2)

The tower goes to the device once and runs as eager torch ops over the
fixed [max_batch, slots] bucket (requests pad up). A request moves its
slot vector (inside the cache's lookup) and its slot mask to the device
and its scores back: one device-to-host copy. `score_request` is the
HTTP front door's entry point, behind the edge's POST /v1/ctr/score
route (`serve/http_edge.py`).

Observability: per-request spans on the shared tracer (gather/forward
events ride the request's trail), a request-latency histogram, and the
request ledger as a read-through registry source; the cache exports
its own hit/miss/stale/invalidation ledger next to it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from paddle_tpu_torch.core.devices import resolve_device

_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 1.0)


def init_tower(rng, dim: int, hidden: int = 16) -> dict:
    """Dense tower params as a numpy dict (host-seeded from a seed or a
    CPU torch.Generator, tiny — the sparse table is the big state and
    it lives behind the cache's backing). The dict crosses unchanged to
    the JAX package's `CtrServer`."""
    gen = rng
    if not isinstance(rng, torch.Generator):
        gen = torch.Generator()
        gen.manual_seed(int(rng))
    return {
        "w1": (torch.randn((dim, hidden), generator=gen) * 0.1).numpy(),
        "b1": np.zeros(hidden, np.float32),
        "w2": (torch.randn((hidden,), generator=gen) * 0.1).numpy(),
        "b2": np.zeros((), np.float32),
    }


class CtrServer:
    """The CTR request path over one `TieredEmbedCache` + dense tower.

    `score(ids)` takes [b, s] int feature ids (-1 pads), b <=
    `max_batch`, s <= `slots`, and returns [b] float32 click
    probabilities (numpy, host-side — the response is JSON anyway).
    `score_request(payload)` is the HTTP-edge entry point. `device`:
    where the tower runs (None means the card, and raises without
    one); it should be the cache's."""

    def __init__(self, cache, tower: dict, *, slots: int = 16,
                 max_batch: int = 8, registry=None, tracer=None,
                 name: str = "ctr",
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        self.device = resolve_device(device)
        self.cache = cache
        self.slots = int(slots)
        self.max_batch = int(max_batch)
        self.name = name
        self.clock = clock
        self.tracer = tracer
        self._tower = {k: torch.as_tensor(np.asarray(v, np.float32)).to(
            self.device) for k, v in tower.items()}
        self._next_rid = 0
        self._stats: Dict[str, int] = {
            "requests": 0, "examples": 0, "rejected": 0,
        }
        self._lat_hist = None
        if registry is not None:
            registry.register_source(name, self.counters)
            self._lat_hist = registry.histogram(
                f"{name}_request_seconds",
                "CTR scoring latency per request (gather + tower)",
                buckets=_LATENCY_BUCKETS)

    def counters(self) -> Dict[str, int]:
        return dict(self._stats)

    def _forward(self, vecs: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
        # vecs: [B*S, D] from the cache gather; padding slots are
        # already zero rows, so the masked mean only needs counts
        tw = self._tower
        v = vecs.reshape(self.max_batch, self.slots, vecs.shape[-1])
        cnt = mask.sum(dim=1, keepdim=True).clamp_min(1.0)
        pooled = v.sum(dim=1) / cnt
        h = torch.relu(pooled @ tw["w1"] + tw["b1"])
        return torch.sigmoid(h @ tw["w2"] + tw["b2"])

    def _mask(self, padded: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy((padded >= 0).astype(np.float32))
        if self.device.type == "cuda":
            # a fresh pinned buffer each request (see the cache's
            # _to_device: never rewritten before its copy lands)
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def score(self, ids) -> np.ndarray:
        """[b, s] feature ids (-1 pads) -> [b] click probabilities."""
        ids = np.asarray(ids, np.int64)
        if ids.ndim != 2:
            raise ValueError(f"ids must be [batch, slots], got shape "
                             f"{ids.shape}")
        b, s = ids.shape
        if b > self.max_batch or s > self.slots:
            self._stats["rejected"] += 1
            raise ValueError(
                f"request [{b}, {s}] exceeds the server's fixed "
                f"[{self.max_batch}, {self.slots}] bucket")
        t0 = self.clock()
        rid = self._next_rid
        self._next_rid += 1
        span = None
        if self.tracer is not None:
            span = self.tracer.start(f"{self.name}{rid}", "ctr.request",
                                     batch=b)
        try:
            padded = np.full((self.max_batch, self.slots), -1, np.int64)
            padded[:b, :s] = ids
            rows = self.cache.lookup(padded.reshape(-1))
            if span is not None:
                span.event("gather",
                           rows=int(np.count_nonzero(padded >= 0)))
            with torch.no_grad():
                scores = self._forward(rows, self._mask(padded))
            out = scores[:b].cpu().numpy()
            if span is not None:
                span.event("forward")
        except BaseException:
            if span is not None:
                self.tracer.end(span, "error")
            raise
        self._stats["requests"] += 1
        self._stats["examples"] += b
        if self._lat_hist is not None:
            self._lat_hist.observe(self.clock() - t0)
        if span is not None:
            self.tracer.end(span, "ok")
        return out

    def score_request(self, payload: dict) -> dict:
        """The HTTP front-door entry: ``{"ids": [[...], ...]}`` ->
        ``{"scores": [...], "batch": b}``. Malformed payloads raise
        ValueError (the edge maps it to 400); oversize batches too."""
        if not isinstance(payload, dict):
            raise ValueError("body must be a JSON object")
        try:
            ids = np.asarray(payload["ids"], np.int64)
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"ids malformed: {e}")
        scores = self.score(ids)
        return {"scores": [float(x) for x in scores],
                "batch": int(ids.shape[0])}
