"""Python side of the C inference ABI (port of
`paddle_tpu.serve.capi_bridge`).

The C host (native/src/capi.cc, ROADMAP queue 1 item 6) embeds CPython
-- as the reference's C++ engine embedded Python for its config parser
(reference: utils/PythonUtil.h:47) -- and calls these functions with raw
byte buffers. Mirrors capi/gradient_machine.h: load-with-merged-
parameters, forward, release. A model is a compiled-model artifact
(`serve.artifact.load_compiled_model`); the device its inputs go to is
`PADDLE_TPU_TORCH_DEVICE` where set (it must be the type the artifact
was exported for), else the artifact's own. Loading imports no model
code.
"""

from __future__ import annotations

import json
import os
import threading
from typing import List, Tuple

import numpy as np

from paddle_tpu_torch.serve.artifact import load_compiled_model

_models = {}
_next_id = [1]
_lock = threading.Lock()


def load(path: str) -> int:
    model = load_compiled_model(
        path, device=os.environ.get("PADDLE_TPU_TORCH_DEVICE") or None)
    with _lock:
        mid = _next_id[0]
        _next_id[0] += 1
        _models[mid] = model
    return mid


def signature(mid: int) -> str:
    return json.dumps(_models[mid].meta)


def forward(mid: int,
            in_bufs: List[bytes]) -> List[Tuple[bytes, str, List[int]]]:
    """in_bufs: one raw buffer per exported input (dtype and shape from
    the signature). Returns [(bytes, dtype_str, shape), ...] per
    output."""
    model = _models[mid]
    sig = model.meta["inputs"]
    if len(in_bufs) != len(sig):
        raise ValueError(f"expected {len(sig)} inputs, got {len(in_bufs)}")
    arrays = [np.frombuffer(buf, dtype=np.dtype(s["dtype"])).reshape(
        s["shape"]) for buf, s in zip(in_bufs, sig)]
    outs = model.predict(*arrays)
    outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
    result = []
    for o in outs:
        o = o.detach().cpu().numpy()
        result.append((o.tobytes(), str(o.dtype), list(o.shape)))
    return result


def release(mid: int) -> None:
    with _lock:
        _models.pop(mid, None)
