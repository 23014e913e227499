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

- `export_inference_artifact` / `load_inference_artifact`: the
  inference-only tar (params + model_state + metadata, no optimizer
  state) in the JAX package's layout -- `tensor_{i}.npy` members in
  JAX's flatten order of {"params", "model_state"} under keystr names
  and a `manifest.json` -- so an artifact written by either package
  loads in the other, as the parameters tar does.
- `ManifestMismatchError` and `param_tree_hash` (the structure hash, the
  same as JAX's for a matching tree).
- `ElasticCheckpointManager`: the CheckpointManager for ZeRO-layout
  states (`TrainState.create_zero`) on a mesh, with a topology manifest
  `zero_topology_{step}.json` beside each step, and reshard-on-restore
  when the data axis' size differs from the one that saved.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import tarfile
from typing import Any, List, Optional

import numpy as np
import torch

from paddle_tpu_torch.core.pytree import flatten_with_keys as _flatten_with_keys
from paddle_tpu_torch.core.pytree import unflatten_like as _unflatten_like
from paddle_tpu_torch.train.state import TrainState

_STATE_FILE = "state.pt"


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


# ---- the structure hash a reshard must agree on -----------------------------


class ManifestMismatchError(ValueError):
    """The checkpoint's manifest does not describe THIS model: the saved
    param-tree hash (or optimizer-state layout) disagrees with the restore
    template. Unlike ordinary corruption this is not walk-back-able:
    every older step of the same run mismatches the same way, so
    `train.resilience.restore_with_fallback` re-raises it."""


def param_tree_hash(params) -> str:
    """Structure hash of a parameter tree: names, shapes, dtypes. The
    item list is the JAX package's -- the `keystr` name, the shape and
    the numpy dtype name of each leaf in JAX's flatten order -- so a port
    tree that matches a JAX tree hashes equal. Values are excluded."""
    items = [(name, tuple(int(n) for n in leaf.shape),
              str(leaf.dtype).replace("torch.", ""))
             for name, leaf in _flatten_with_keys(params)]
    return hashlib.sha256(repr(items).encode()).hexdigest()[:16]


# ---- elastic (ZeRO) checkpoints: topology manifest + reshard-on-restore ----


def _gather(x):
    """A leaf's full value on the CPU (a DTensor is gathered: every rank
    of its mesh takes part, `core.mesh.gather_full`)."""
    from paddle_tpu_torch.core.mesh import gather_full

    x = gather_full(x)
    return x.detach().cpu() if isinstance(x, torch.Tensor) else x


def _place_like(value: torch.Tensor, tmpl):
    """value (a full CPU tensor) placed as the template leaf is: a
    DTensor on its mesh with its placements (each rank keeps its own
    block), a plain tensor on its device."""
    if hasattr(tmpl, "placements"):
        from torch.distributed.tensor import distribute_tensor

        local = tmpl.to_local()
        return distribute_tensor(value.to(device=local.device,
                                          dtype=tmpl.dtype),
                                 tmpl.device_mesh, tmpl.placements,
                                 src_data_rank=None)
    return value.to(device=tmpl.device, dtype=tmpl.dtype)


def _leaves(tree) -> list:
    """Leaves in JAX's flatten order (the manifest's order)."""
    return [leaf for _, leaf in _flatten_with_keys(tree)]


def _mesh_primary(mesh) -> bool:
    """This rank is the mesh's first (index 0 on every axis)."""
    return all(mesh.axis_index(a) == 0 for a in mesh.axis_names)


def _mesh_barrier(mesh) -> None:
    """Every rank of the mesh waits for every other: a barrier on each
    axis' group in turn (rank 0's write then precedes every rank's
    return, through the chain of axes)."""
    import torch.distributed as dist

    for axis in mesh.axis_names:
        if mesh.shape[axis] > 1:
            dist.barrier(group=mesh.get_group(axis))


class ElasticCheckpointManager(CheckpointManager):
    """CheckpointManager for ZeRO-layout TrainStates that records how the
    optimizer state was sharded (a topology manifest beside each step)
    and reshards on restore when the current mesh's data-axis size
    differs from the one that saved: a run checkpointed on N ranks
    resumes on M bit for bit, since the flat layout differs between
    sizes only by trailing zero padding.

    Every rank of the mesh calls `save` (the sharded leaves are gathered
    collectively); the mesh's first rank writes the step, then the
    manifest atomically (tmp + rename), and all its ranks wait for it. A committed step without
    a manifest is a torn save: `restore` raises ValueError for it (and
    for a corrupt manifest), so `restore_with_fallback` walks back past
    it. A manifest whose param-tree hash disagrees with the template
    raises `ManifestMismatchError`. `reshard_restores` counts the
    restores that resharded."""

    MANIFEST_FORMAT = 1

    def __init__(self, directory: str, *, mesh, max_to_keep: int = 3,
                 async_save: bool = False):
        super().__init__(directory, max_to_keep=max_to_keep,
                         async_save=async_save)
        self.mesh = mesh
        self.reshard_restores = 0

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"zero_topology_{step}.json")

    def save(self, state: TrainState, step: Optional[int] = None) -> int:
        from paddle_tpu_torch.core.mesh import DATA_AXIS
        from paddle_tpu_torch.core.pytree import tree_map
        from paddle_tpu_torch.parallel.train_step import zero_true_sizes

        full = TrainState(*(tree_map(_gather, part) for part in state))
        step = int(full.step) if step is None else int(step)
        if _mesh_primary(self.mesh):
            super().save(full, step)
            sizes = _leaves(zero_true_sizes(state.params, state.opt_state))
            manifest = {
                "format": self.MANIFEST_FORMAT,
                "kind": "zero_topology",
                "step": step,
                "data_shards": int(self.mesh.shape[DATA_AXIS]),
                "param_hash": param_tree_hash(state.params),
                "opt_leaves": [
                    {"true_size": int(t), "shape": list(leaf.shape),
                     "dtype": str(leaf.dtype).replace("torch.", "")}
                    for t, leaf in zip(sizes, _leaves(full.opt_state))],
            }
            path = self._manifest_path(step)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self._prune_manifests()
        _mesh_barrier(self.mesh)
        return step

    def _prune_manifests(self) -> None:
        """Drop manifests whose step retention already deleted."""
        live = set(self.all_steps())
        for name in os.listdir(self.directory):
            if not (name.startswith("zero_topology_")
                    and name.endswith(".json")):
                continue
            try:
                s = int(name[len("zero_topology_"):-len(".json")])
            except ValueError:
                continue
            if s not in live:
                try:
                    os.unlink(os.path.join(self.directory, name))
                except OSError:
                    pass

    def _load_manifest(self, step: int) -> dict:
        path = self._manifest_path(step)
        try:
            with open(path) as f:
                manifest = json.load(f)
        except FileNotFoundError:
            raise ValueError(
                f"checkpoint step {step} has no topology manifest "
                f"({path}) — torn save or a non-elastic checkpoint; "
                f"treating as unrestorable") from None
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            raise ValueError(
                f"checkpoint step {step}: corrupt topology manifest: "
                f"{e}") from e
        if manifest.get("kind") != "zero_topology":
            raise ValueError(
                f"checkpoint step {step}: {path} is not a zero topology "
                f"manifest")
        return manifest

    def restore(self, template: TrainState,
                step: Optional[int] = None) -> TrainState:
        """The saved state placed as `template` is (a ZeRO-layout state
        for this mesh); flat optimizer buffers saved at another data-axis
        size are cut to their true size and re-padded for this one
        (`parallel.train_step.reshard_zero_leaf`)."""
        from paddle_tpu_torch.core.mesh import DATA_AXIS
        from paddle_tpu_torch.parallel.train_step import (
            reshard_zero_leaf, zero_leaf_spec, zero_pad)

        step = self.latest_step() if step is None else int(step)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        manifest = self._load_manifest(step)
        want = param_tree_hash(template.params)
        got = manifest.get("param_hash")
        if got != want:
            raise ManifestMismatchError(
                f"checkpoint step {step} was saved for a different "
                f"parameter tree (manifest hash {got}, template hash "
                f"{want}) — refusing to reshard")
        m = int(self.mesh.shape[DATA_AXIS])
        n = int(manifest["data_shards"])
        entries = manifest["opt_leaves"]
        opt_leaves = _leaves(template.opt_state)
        if len(entries) != len(opt_leaves):
            raise ManifestMismatchError(
                f"checkpoint step {step}: manifest records "
                f"{len(entries)} optimizer-state leaves, template has "
                f"{len(opt_leaves)} — optimizer changed since save")
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
        opt_ids = {id(t): i for i, t in enumerate(opt_leaves)}
        leaves = []
        for name, tmpl in keys:
            value = saved[name]
            tshape = tuple(tmpl.shape)
            i = opt_ids.get(id(tmpl))
            if i is None or tuple(value.shape) == tshape and n == m:
                if tuple(value.shape) != tshape:
                    raise ValueError(
                        f"checkpoint step {step}: {name} saved as "
                        f"{tuple(value.shape)}, template {tshape}")
                leaves.append(_place_like(value, tmpl))
                continue
            true = int(entries[i]["true_size"])
            if len(tshape) == 1 and zero_leaf_spec(tmpl, m) == (DATA_AXIS,):
                if tshape[0] != zero_pad(true, m):
                    raise ManifestMismatchError(
                        f"checkpoint step {step}: flat leaf of true size "
                        f"{true} wants padded length {zero_pad(true, m)} "
                        f"on {m} shards, template has {tshape[0]} — "
                        f"layout mismatch")
                leaves.append(reshard_zero_leaf(value.to(tmpl.dtype), true,
                                                self.mesh))
            elif tuple(value.shape) == tshape:
                leaves.append(_place_like(value, tmpl))
            else:
                raise ManifestMismatchError(
                    f"checkpoint step {step}: optimizer leaf saved as "
                    f"{tuple(value.shape)} does not fit template shape "
                    f"{tshape} and is not a flat ZeRO buffer")
        if n != m:
            self.reshard_restores += 1
        return TrainState(**_unflatten_like(template._asdict(), leaves))


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
            leaves.append(_leaf_from(arr, entry, tmpl))
    return _unflatten_like(template, leaves)


def _leaf_from(arr: np.ndarray, entry: dict, tmpl: torch.Tensor):
    """A loaded .npy as a tensor in the template leaf's dtype and
    device; JAX's bf16 leaf (raw 2-byte values) reads as bfloat16
    bits."""
    if arr.dtype.kind == "V" and entry.get("dtype") == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=tmpl.device, dtype=tmpl.dtype)


# ---- the inference artifact (reference: merge_model deploy file) ------------


def export_inference_artifact(params: Any, model_state: Any, path: str,
                              meta: Optional[dict] = None) -> None:
    """Inference-only artifact: params + model_state (BN stats) +
    metadata, no optimizer state (reference: merge_model deploy file,
    python/paddle/utils/merge_model.py + trainer/MergeModel.cpp)."""
    bundle = {"params": params, "model_state": model_state}
    manifest = []
    with tarfile.open(path, "w") as tar:
        for i, (name, leaf) in enumerate(_flatten_with_keys(bundle)):
            arr = _to_numpy(leaf)
            buf = io.BytesIO()
            np.save(buf, arr)
            _add_member(tar, f"tensor_{i}.npy", buf.getvalue())
            manifest.append({"index": i, "key": name,
                             "shape": list(arr.shape),
                             "dtype": str(arr.dtype)})
        _add_member(tar, "manifest.json", json.dumps(
            {"tensors": manifest, "meta": meta or {}}).encode())


def load_inference_artifact(params_template: Any, model_state_template: Any,
                            path: str):
    """Restore (params, model_state, meta) from an inference artifact of
    either package, each leaf in its template leaf's dtype and device."""
    bundle = {"params": params_template, "model_state": model_state_template}
    flat_kp = _flatten_with_keys(bundle)
    try:
        tar_ctx = tarfile.open(path, "r")
    except (tarfile.TarError, EOFError) as e:
        raise ValueError(f"{path}: not a readable inference artifact "
                         f"(truncated or corrupt): {e}") from e
    with tar_ctx as tar:
        manifest = _tar_manifest(tar, path)
        entries = manifest.get("tensors")
        if entries is None:
            raise ValueError(f"{path}: manifest.json has no 'tensors' — "
                             f"not an inference artifact")
        if len(entries) != len(flat_kp):
            raise ValueError(
                f"artifact has {len(entries)} tensors, template has "
                f"{len(flat_kp)}")
        leaves = []
        for i, ((name, tmpl), entry) in enumerate(zip(flat_kp, entries)):
            if entry["key"] != name:
                raise ValueError(
                    f"tensor {i}: saved key {entry['key']!r} != template key "
                    f"{name!r} — architecture mismatch")
            arr = np.load(io.BytesIO(_tar_member(tar, f"tensor_{i}.npy",
                                                 path)))
            if arr.shape != tuple(tmpl.shape):
                raise ValueError(
                    f"tensor {entry['key']}: saved shape {arr.shape} != "
                    f"template shape {tuple(tmpl.shape)}")
            leaves.append(_leaf_from(arr, entry, tmpl))
    restored = _unflatten_like(bundle, leaves)
    return restored["params"], restored["model_state"], manifest["meta"]
