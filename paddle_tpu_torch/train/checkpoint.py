"""Checkpoint/resume (port of `paddle_tpu.train.checkpoint`:
`CheckpointManager` and the parameters tar).

- `CheckpointManager`: retention-managed TrainState checkpoints, one
  directory per step holding a `torch.save` file (the JAX package saves
  with orbax, which the port does not use). The same methods and
  semantics: `save` is atomic (written to a temporary directory, then
  renamed), re-saving an existing step deletes and rewrites it,
  `max_to_keep` keeps the newest steps, `restore` with no checkpoint
  raises FileNotFoundError.
- `save_parameters_tar` / `load_parameters_tar`: the JAX package's
  portable tar -- `param_{i}.npy` members and a `manifest.json`, leaves
  in JAX's flatten order (dict keys sorted) and named as
  `jax.tree_util.keystr` names them (`['blocks'][0]['qkv']['kernel']`)
  -- so a tar written by either package loads in the other. For leaves
  that numpy holds (f32, integers) the bytes are JAX's own. bfloat16
  leaves are written as f32 and cast back on load: JAX's tar writes them
  as raw 2-byte `<V2` values, which its own loader cannot cast back; the
  port's loader reads those as bfloat16 bits.
  The tar helpers (`_tar_member`, `_tar_manifest`) are this module's own
  copy, with the same error messages for a torn or mismatched tar.

The elastic (ZeRO) manager and the inference artifact are not ported yet.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tarfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.train.state import TrainState

_STATE_FILE = "state.pt"


# ---- trees in JAX's flatten order, named as jax.tree_util.keystr ----------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_with_keys(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] in JAX's flatten order: dict keys sorted (DictKey
    `['k']`), list and tuple positions (SequenceKey `[i]`), namedtuple
    fields in order (GetAttrKey `.f`); None holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_keys(tree[k], f"{prefix}[{k!r}]")
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += _flatten_with_keys(getattr(tree, f), f"{prefix}.{f}")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_keys(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten_like(template, leaves):
    """template's structure (dicts keep their own key order) with its
    leaves replaced, in _flatten_with_keys order, from `leaves`."""
    it = iter(leaves)

    def go(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: go(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[go(getattr(t, f)) for f in t._fields])
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(template)


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A tensor leaf as numpy; bfloat16 widens to float32 (numpy has no
    bfloat16, and loading casts back to the template's dtype exactly)."""
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---- CheckpointManager ------------------------------------------------------


class CheckpointManager:
    """Periodic, retention-managed train-state checkpoints.

    Each step is a directory `<directory>/<step>` holding one
    `torch.save` file of the state's leaves (moved to the CPU) keyed by
    their keystr names. `save` writes a temporary directory and renames
    it into place, so a step directory is complete or absent; the file
    and the rename are fsynced. async_save is accepted for the JAX
    signature and saves synchronously: `save` returns once the step is
    durable and `wait` has nothing to wait for.
    """

    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 3,
                 async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, state: TrainState, step: Optional[int] = None) -> int:
        """Saving onto an existing step deletes and rewrites it: a caller
        re-saving a step means "make THIS state durable at this step"."""
        step = int(state.step) if step is None else int(step)
        flat = {k: v.detach().cpu()
                for k, v in _flatten_with_keys(state._asdict())}
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
            torch.save(flat, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        fd = os.open(self.directory, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return step

    def wait(self) -> None:
        """Every save is synchronous: nothing is pending."""

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """template supplies the tree, shapes, dtypes and devices (a
        TrainState of tensors built the same way as at first init)."""
        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        path = os.path.join(self._step_dir(step), _STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{self.directory}")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        keys = _flatten_with_keys(template._asdict())
        if sorted(saved) != sorted(k for k, _ in keys):
            raise ValueError(
                f"checkpoint step {step} holds leaves "
                f"{sorted(set(saved) ^ set(k for k, _ in keys))} that the "
                f"template does not (or the reverse)")
        leaves = []
        for name, tmpl in keys:
            t = saved[name]
            if t.shape != tmpl.shape:
                raise ValueError(
                    f"checkpoint step {step}: {name} saved as "
                    f"{tuple(t.shape)}, template {tuple(tmpl.shape)}")
            leaves.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
        return TrainState(**_unflatten_like(template._asdict(), leaves))

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def close(self) -> None:
        """Nothing is held open between calls."""


# ---- v2 Parameters tar parity (reference: v2/parameters.py:328,358) ----


def _tar_member(tar: tarfile.TarFile, name: str, path: str) -> bytes:
    """Fetch one member with a CLEAR error for the corruption cases a
    torn write produces: missing member, truncated archive, unreadable
    data -- a garbage restore must never get past here."""
    try:
        f = tar.extractfile(name)
    except KeyError:
        f = None
    except tarfile.TarError as e:
        raise ValueError(f"{path}: corrupt tar while reading {name!r}: "
                         f"{e}") from e
    if f is None:
        raise ValueError(
            f"{path}: member {name!r} missing — not a paddle_tpu "
            f"checkpoint tar, or a half-written one")
    try:
        return f.read()
    except (tarfile.TarError, EOFError, OSError) as e:
        raise ValueError(f"{path}: member {name!r} unreadable "
                         f"(truncated write?): {e}") from e


def _tar_manifest(tar: tarfile.TarFile, path: str) -> dict:
    raw = _tar_member(tar, "manifest.json", path)
    try:
        return json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: corrupt manifest.json: {e}") from e


def _add_member(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name=name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def save_parameters_tar(params: Any, path: str) -> None:
    """Serialize a parameter tree of tensors to a tar of raw .npy members
    + a JSON manifest -- the portable, mesh-independent format
    (reference: Parameters.to_tar python/paddle/v2/parameters.py:328)."""
    manifest = []
    with tarfile.open(path, "w") as tar:
        for i, (name, leaf) in enumerate(_flatten_with_keys(params)):
            arr = _to_numpy(leaf)
            buf = io.BytesIO()
            np.save(buf, arr)
            _add_member(tar, f"param_{i}.npy", buf.getvalue())
            manifest.append({"index": i, "key": name,
                             "shape": list(arr.shape),
                             "dtype": str(arr.dtype)})
        _add_member(tar, "manifest.json",
                    json.dumps({"params": manifest}).encode())


def load_parameters_tar(template: Any, path: str) -> Any:
    """Load a tar written by save_parameters_tar (of either package) into
    the tree of `template`, each leaf in its template leaf's dtype and
    device (reference: Parameters.from_tar
    python/paddle/v2/parameters.py:358)."""
    flat_kp = _flatten_with_keys(template)
    try:
        tar_ctx = tarfile.open(path, "r")
    except (tarfile.TarError, EOFError) as e:
        raise ValueError(f"{path}: not a readable checkpoint tar "
                         f"(truncated or corrupt): {e}") from e
    with tar_ctx as tar:
        manifest = _tar_manifest(tar, path)
        entries = manifest.get("params")
        if entries is None:
            raise ValueError(f"{path}: manifest.json has no 'params' — "
                             f"not a parameters tar")
        if len(entries) != len(flat_kp):
            raise ValueError(
                f"checkpoint has {len(entries)} params, template has "
                f"{len(flat_kp)}")
        leaves = []
        for i, ((name, tmpl), entry) in enumerate(zip(flat_kp, entries)):
            if entry["key"] != name:
                raise ValueError(
                    f"param {i}: saved key {entry['key']!r} != template key "
                    f"{name!r} — parameter order/naming mismatch")
            raw = _tar_member(tar, f"param_{i}.npy", path)
            try:
                arr = np.load(io.BytesIO(raw))
            except (ValueError, EOFError, OSError) as e:
                raise ValueError(f"{path}: param_{i}.npy is not a valid "
                                 f".npy (torn write?): {e}") from e
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"param {entry['key']}: saved shape {arr.shape} != "
                    f"template shape {tuple(tmpl.shape)}")
            if arr.dtype.kind == "V" and entry.get("dtype") == "bfloat16":
                # JAX's bf16 leaf: raw 2-byte values, the bfloat16 bits
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            leaves.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
    return _unflatten_like(template, leaves)
