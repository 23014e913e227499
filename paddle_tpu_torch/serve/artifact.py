"""Serving artifacts (port of `paddle_tpu.serve.artifact`).

Two kinds, both written with `torch.export` and read with no model code:

- A compiled model (`export_compiled_model` / `load_compiled_model`):
  one tar holding `meta.json` (the input and output signature, and any
  extra fields) and `program.pt2`, the `torch.export.save` archive of
  the forward with its weights folded in as the program's constants
  (the JAX package holds StableHLO there). `export_decoder` writes the
  transformer's whole decode loop so: the prefill and every step,
  unrolled. The reference's merged-model deploy file (reference:
  python/paddle/utils/merge_model.py) and its C inference API load
  this kind; `merge-model` and `infer` write and read it.
- An engine bundle (`save_engine_artifact` / `load_engine_artifact`):
  the `DecodeEngine`'s serving bodies, each exported once into one
  versioned tar that a `ServingServer` replica binds at boot:

    manifest.json               verified field for field against
                                engine.artifact_manifest() before a
                                single program is trusted
    programs/step               the decode step, all-greedy pool
    programs/step_sampled       the decode step given [S, V] Gumbel draws
    programs/spec               the verify round, all-greedy pool
                                (K = policy.spec_draft_max)
    programs/spec_sampled       the verify round given [S, K] acceptance
                                uniforms and [S, V] Gumbel draws
    programs/chunk_w{W}_z{Z}_f{F}  one per saved (chunk_w, from_zero,
                                final) prefill

  Each member is a `torch.export.save` archive. The programs take FLAT
  tensor arguments: the engine's weight leaves (`flatten_with_keys`
  order), the state's tensors (`serve.engine.state_leaves`), then the
  call's own. Unlike the JAX bundle, whose programs fold the weights in
  as constants (a bundle of O(programs x params) bytes), the port's take
  the loading engine's weights as inputs, so the bundle holds no
  weights; the manifest's `params_hash` still binds it to one weight
  tree. The kernels stay in: A, B and C are registered operators
  (`ops.flash_attention.flash_fwd`, `ops.ragged_paged_attention.
  ragged_walk` / `ragged_walk_int8`), so a program exported on the card
  launches them as the eager engine does. Any mismatch -- PyTorch
  version, device type, weights, pool geometry, buckets -- raises
  ArtifactMismatchError, and ServingServer keeps the eager path with an
  `artifact_fallbacks` counter and a flight event: never a wrong answer.

Loading either kind imports the operators' modules (to register A, B and
C) and nothing of `paddle_tpu_torch.models`.
"""

from __future__ import annotations

import contextlib
import io
import json
import tarfile
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.pytree import flatten_with_keys

_META_NAME = "meta.json"
_PROGRAM_NAME = "program.pt2"

FORMAT_VERSION = 1

ENGINE_FORMAT_VERSION = 1
_MANIFEST_NAME = "manifest.json"
_PROGRAM_DIR = "programs"


def _register_ops() -> None:
    """Import the modules that register kernels A, B and C as operators:
    a saved program names them, and loading it needs them registered."""
    from paddle_tpu_torch.ops import flash_attention  # noqa: F401
    from paddle_tpu_torch.ops import ragged_paged_attention  # noqa: F401


class _Fn(torch.nn.Module):
    """A callable as the module torch.export takes; tensors it closes
    over become the program's constants."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


@contextlib.contextmanager
def _no_stack_traces():
    """Trace without recording each node's Python stack (a tenth of an
    export's time, and dropped from the archive anyway), where this
    PyTorch has the switch."""
    import torch.fx

    cfg = getattr(torch.fx, "config", None)
    if cfg is None or not hasattr(cfg, "do_not_emit_stack_traces"):
        yield
        return
    old = cfg.do_not_emit_stack_traces
    cfg.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        cfg.do_not_emit_stack_traces = old


def _export(fn: Callable, args: Sequence[torch.Tensor]):
    with torch.no_grad(), _no_stack_traces():
        ep = torch.export.export(_Fn(fn), tuple(args))
    # the archive would keep a copy of every example input (an engine
    # program's weights and KV arenas)
    ep.example_inputs = None
    return ep


#: node metadata a saved program does not need: where each node was
#: traced from (source paths and lines) and the module stack
_TRACE_META = ("stack_trace", "nn_module_stack", "torch_fn",
               "source_fn_stack")


def _save_program(ep) -> bytes:
    """The torch.export.save archive of ep, without the tracing
    metadata (a quarter of a graph's bytes, and the exporting machine's
    source paths)."""
    for node in ep.graph.nodes:
        for key in _TRACE_META:
            node.meta.pop(key, None)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


@contextlib.contextmanager
def _cached_type_hints():
    """torch.export.load turns the archive's JSON into its schema's
    dataclasses, asking typing.get_type_hints for every object's class
    again (about 80% of a load in PyTorch 2.13). The hints are a pure
    function of the class: cache them while a program loads. Where the
    serializer does not look them up that way, nothing changes."""
    try:
        from torch._export.serde import serialize as serde
    except ImportError:
        yield
        return
    orig = getattr(serde, "typing", None)
    if orig is None or not hasattr(orig, "get_type_hints"):
        yield
        return
    cache = {}

    class _Typing:
        def __getattr__(self, name):
            return getattr(orig, name)

        @staticmethod
        def get_type_hints(obj, globalns=None, localns=None,
                           include_extras=False):
            key = (obj, id(globalns), id(localns), include_extras)
            if key not in cache:
                cache[key] = orig.get_type_hints(
                    obj, globalns=globalns, localns=localns,
                    include_extras=include_extras)
            return cache[key]

    serde.typing = _Typing()
    try:
        yield
    finally:
        serde.typing = orig


def _load_program(blob: bytes):
    _register_ops()
    with _cached_type_hints():
        return torch.export.load(io.BytesIO(blob))


def _add(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


def _sig(t) -> dict:
    return {"shape": list(t.shape), "dtype": str(t.dtype).replace("torch.",
                                                                  "")}


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.array(x)).to(device)


# ---------------------------------------------------------------------------
# Compiled models (the merged-model deploy file)
# ---------------------------------------------------------------------------


class CompiledModel:
    """A loaded compiled forward: call .predict(*inputs) with numpy
    arrays or tensors; they are moved to the program's device and must
    match the exported signature."""

    def __init__(self, exported, meta: dict):
        self._module = exported.module()
        self.meta = meta
        self.device = torch.device(meta["device"])

    @property
    def input_signature(self):
        return self.meta["inputs"]

    @property
    def output_signature(self):
        return self.meta["outputs"]

    def predict(self, *inputs):
        sig = self.meta["inputs"]
        if len(inputs) != len(sig):
            raise ValueError(
                f"model takes {len(sig)} inputs, got {len(inputs)}")
        arrs = [_as_tensor(x, self.device) for x in inputs]
        for a, s in zip(arrs, sig):
            if list(a.shape) != s["shape"]:
                raise ValueError(
                    f"input shape {list(a.shape)} != exported {s['shape']}")
        noise = self.meta.get("host_noise")
        if noise is not None:
            # a sampled decoder: its last input is the seed of a host
            # generator that draws the Gumbel noise the program takes,
            # one [B, V] draw a step, as generate() draws from its rng
            arrs[-1] = _decoder_noise(int(arrs[-1].reshape(()).item()),
                                      noise["shape"], self.device)
        with torch.no_grad():
            return self._module(*arrs)


def _decoder_noise(seed: int, shape, device) -> torch.Tensor:
    from paddle_tpu_torch.ops.sampling import gumbel_noise

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    steps, b, v = shape
    return torch.stack([gumbel_noise((b, v), generator=gen, device=device)
                        for _ in range(steps)])


def export_compiled_model(
    forward: Callable,
    example_inputs: Sequence[Any],
    path: str,
    *,
    name: str = "model",
    extra_meta: Optional[dict] = None,
) -> dict:
    """Export `forward(*inputs)` (weights closed over, folded into the
    program as its constants) to a single-file artifact at `path`;
    returns its meta. The program runs on the device it was exported on,
    the first example input's (numpy inputs: the CPU)."""
    first = example_inputs[0]
    device = first.device if isinstance(first, torch.Tensor) else \
        torch.device("cpu")
    args = [_as_tensor(x, device) for x in example_inputs]
    ep = _export(forward, args)
    user = set(ep.graph_signature.user_outputs)
    ret = next(n for n in ep.graph.nodes if n.op == "output").args[0]
    outs = [n.meta["val"] for n in ret if getattr(n, "name", None) in user]
    meta = {
        "format_version": FORMAT_VERSION,
        "name": name,
        "torch_version": torch.__version__,
        "device": device.type,
        "inputs": [_sig(a) for a in args],
        "outputs": [_sig(o) for o in outs],
    }
    if extra_meta:
        meta.update(extra_meta)
    with tarfile.open(path, "w") as tar:
        _add(tar, _META_NAME, json.dumps(meta, indent=1).encode())
        _add(tar, _PROGRAM_NAME, _save_program(ep))
    return meta


def export_decoder(
    params,
    cfg,
    path: str,
    *,
    batch: int,
    prompt_len: int,
    steps: int,
    eos_id: Optional[int] = None,
    pad_id: Optional[int] = None,
    variable_lengths: bool = False,
    temperature: Optional[float] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    int8_weights: bool = False,
    name: str = "decoder",
) -> dict:
    """Export the transformer's whole decode -- the prefill and `steps`
    steps of `transformer.generate`, unrolled -- as a compiled-model
    artifact on the params' device; returns its meta (with the export's
    seconds under "export_s").

    The reference's generation-serving surface was a live
    SequenceGenerator object (reference: api/PaddleAPI.h:1025); here
    the loop is one program with the weights folded in, so serving it
    needs no model code. Fixed at export: batch, prompt_len, steps.
    Unlike the JAX artifact, whose portable StableHLO cannot hold the
    flash kernel, the prefill keeps the config's attention: kernel A on
    the card (an operator the program names).

    Greedy by default. temperature (and optional top_k/top_p) bakes a
    sampler in: the program then takes the Gumbel noise [steps, batch,
    V] as its last input, and `CompiledModel.predict` takes an int64 []
    seed there instead, seeding a host torch.Generator on the device
    that draws it as generate() draws from its rng. variable_lengths
    adds a [batch] int64 prompt-lengths input (right-padded prompts).
    int8_weights quantizes every matmul kernel (serve.quant) and folds
    the int8 tree in; each step dequantizes it, as generate() does.

    Signature: prompt [batch, prompt_len] int64 [, prompt_lens [batch]
    int64] [, seed [] int64] -> tokens [batch, prompt_len + steps]."""
    import time

    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serve import quant

    if temperature is None and (top_k is not None or top_p is not None):
        raise ValueError(
            "top_k/top_p require temperature -- without it the export "
            "would be a greedy decoder silently ignoring the filters")
    sampled = temperature is not None
    p = quant.quantize_params(params) if int8_weights else params
    device = next(t for _, t in flatten_with_keys(params)).device

    def decode(prompt, *rest):
        rest = list(rest)
        lens = rest.pop(0) if variable_lengths else None
        select_fn = None
        if sampled:
            draws = iter(rest.pop(0))
            select_fn = T.make_sampler(temperature=temperature, top_k=top_k,
                                       top_p=top_p,
                                       noise=lambda shape: next(draws))
        return T.generate(p, cfg, prompt, steps, select_fn=select_fn,
                          rng=torch.Generator(device=device) if sampled
                          else None,
                          eos_id=eos_id, pad_id=pad_id, prompt_lens=lens)

    example = [torch.zeros((batch, prompt_len), dtype=torch.int64,
                           device=device)]
    if variable_lengths:
        example.append(torch.full((batch,), prompt_len, dtype=torch.int64,
                                  device=device))
    extra = {"kind": "decoder", "steps": steps, "prompt_len": prompt_len,
             "variable_lengths": variable_lengths, "sampled": sampled,
             "temperature": temperature, "top_k": top_k, "top_p": top_p,
             "eos_id": eos_id, "int8_weights": int8_weights,
             # what finished rows are filled with: a consumer stripping
             # padding needs this, not a guess
             "pad_id": eos_id if pad_id is None else pad_id}
    if sampled:
        shape = [steps, batch, cfg.vocab]
        # the caller's signature: the seed in place of the noise
        extra["inputs"] = [_sig(t) for t in example] + [
            {"shape": [], "dtype": "int64", "role": "seed"}]
        extra["host_noise"] = {"shape": shape, "dtype": "float32"}
        example.append(torch.zeros(shape, dtype=torch.float32,
                                   device=device))
    t0 = time.perf_counter()
    meta = export_compiled_model(decode, example, path, name=name,
                                 extra_meta=extra)
    meta["export_s"] = time.perf_counter() - t0
    return meta


def extract_mlir(path: str, out_path: str) -> dict:
    """JAX's artifacts carry StableHLO module text for the Python-free
    PJRT-C server. A PyTorch archive carries a torch.export program and
    no StableHLO, so there is nothing to extract."""
    raise NotImplementedError(
        f"extract_mlir({path!r}): a PyTorch artifact holds a torch.export "
        "program (program.pt2), not StableHLO; the PJRT-C server has no "
        "counterpart on the card")


def load_compiled_model(path: str, *, device=None) -> CompiledModel:
    """Load an artifact written by export_compiled_model or
    export_decoder. A program runs on the device type it was exported
    for: `device`, where given, must be of that type."""
    with tarfile.open(path, "r") as tar:
        meta = json.loads(tar.extractfile(_META_NAME).read().decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported artifact version {meta.get('format_version')}")
        program = tar.extractfile(_PROGRAM_NAME).read()
    if device is not None and torch.device(device).type != meta["device"]:
        raise ValueError(
            f"{path} was exported for {meta['device']}, not "
            f"{torch.device(device).type}: an exported program runs on "
            f"the device it was exported on")
    return CompiledModel(_load_program(program), meta)


# ---------------------------------------------------------------------------
# Engine bundles
# ---------------------------------------------------------------------------


class ArtifactMismatchError(ValueError):
    """The bundle's manifest does not match the loading engine. Callers
    keep the eager path -- never a wrong answer."""


def _leaves(tree) -> list:
    return [t for _, t in flatten_with_keys(tree)]


def _example_state(engine):
    """init_state()'s tensors, allocated on the engine's device (the
    values do not matter: the export traces shapes)."""
    from paddle_tpu_torch.serve.engine import state_leaves

    return [torch.zeros(t.shape, dtype=t.dtype, device=engine.device)
            for t in state_leaves(engine.state_spec())]


def _engine_programs(engine, buckets, sampled=True):
    """{name: (flat_fn, example_args)} for every program the bundle
    carries. Each flat function rebuilds the weight tree and the state
    from its arguments and calls the engine's eager body, so the
    exported computation IS the eager one."""
    from paddle_tpu_torch.core.pytree import unflatten_like
    from paddle_tpu_torch.serve.engine import chunk_key, state_from_leaves

    dev, s, v = engine.device, engine.slots, engine.cfg.vocab
    raw, full = engine._raw_params, engine.params
    n_raw, n_full = len(_leaves(raw)), len(_leaves(full))
    state_ex = _example_state(engine)
    n_state = len(state_ex)
    geom = dict(n_layers=len(engine.params["blocks"]),
                int8=engine.cfg.kv_cache_dtype == "int8", slots=s)

    def split(args, tree, n_p):
        params = unflatten_like(tree, args[:n_p])
        state = state_from_leaves(args[n_p:n_p + n_state], **geom)
        return params, state, args[n_p + n_state:]

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def step(*args):
        params, state, rest = split(args, raw, n_raw)
        return engine._step_impl(params, state, *rest)

    programs = {"step": (step, _leaves(raw) + state_ex)}
    if sampled:
        programs["step_sampled"] = (step, _leaves(raw) + state_ex
                                    + [zeros((s, v), torch.float32)])
    kmax = int(engine.policy.spec_draft_max)
    if kmax >= 1:
        def spec(*args):
            params, state, rest = split(args, raw, n_raw)
            return engine._spec_impl(params, state, *rest)

        drafts = [zeros((s, kmax), torch.int64), zeros((s,), torch.int64)]
        programs["spec"] = (spec, _leaves(raw) + state_ex + drafts)
        if sampled:
            programs["spec_sampled"] = (
                spec, _leaves(raw) + state_ex + drafts
                + [zeros((s, kmax), torch.float32),
                   zeros((s, v), torch.float32)])

    combos = set()
    if engine.prefill_chunk:
        w = int(engine.prefill_chunk)
        combos.update((w, z, f) for z in (True, False)
                      for f in (True, False))
    for b in (buckets or ()):
        # the one-shot prefill of a bucket: the whole prompt, from zero,
        # final (a prefix hit's remainder has any width: those stay on
        # the eager path as expected misses)
        combos.add((int(b), True, True))
    for (w, z, f) in sorted(combos):
        def make_chunk(z=z, f=f):
            def chunk(*args):
                params, state, rest = split(args, full, n_full)
                engine._chunk_impl(params, state, *rest, from_zero=z,
                                   final=f)
            return chunk

        scalars = [zeros((), torch.int64), zeros((w,), torch.int32),
                   zeros((), torch.int64), torch.ones((), dtype=torch.int64,
                                                      device=dev),
                   zeros((), torch.float32), zeros((), torch.int32),
                   torch.ones((), device=dev), zeros((1, v), torch.float32)]
        programs[chunk_key(w, z, f)] = (make_chunk(),
                                        _leaves(full) + state_ex + scalars)
    return programs


def save_engine_artifact(engine, path: str, *, buckets=None,
                         sampled: bool = True) -> dict:
    """Export the engine's serving bodies into a versioned bundle at
    `path` on the engine's device; returns the manifest (with the
    export's seconds per program under "export_s", not written to the
    bundle). `buckets` adds one one-shot prefill program per bucket
    width (pass the serving buckets); engines built with
    `prefill_chunk` get all four chunk combos. sampled=False leaves the
    sampled step and verify programs out (a greedy-only deployment: a
    sampled request's steps then run eagerly)."""
    import time

    manifest = dict(engine.artifact_manifest())  # validates support
    blobs, seconds = {}, {}
    for name, (fn, args) in _engine_programs(engine, buckets,
                                             sampled).items():
        t0 = time.perf_counter()
        blobs[name] = _save_program(_export(fn, args))
        seconds[name] = time.perf_counter() - t0
    manifest.update({
        "engine_format_version": ENGINE_FORMAT_VERSION,
        "buckets": (sorted(int(b) for b in buckets) if buckets else None),
        "prefill_chunk": (None if engine.prefill_chunk is None
                          else int(engine.prefill_chunk)),
        "programs": sorted(blobs),
    })
    with tarfile.open(path, "w") as tar:
        _add(tar, _MANIFEST_NAME, json.dumps(manifest, indent=1).encode())
        for name in sorted(blobs):
            _add(tar, f"{_PROGRAM_DIR}/{name}", blobs[name])
    return dict(manifest, export_s=seconds)


def load_engine_artifact(engine, path: str, *, expect_buckets=None):
    """Load and verify a bundle for `engine`: returns (programs,
    manifest) ready for `engine.bind_artifact`. EVERY field of the
    engine's own `artifact_manifest()` must match exactly (PyTorch
    version, device type, weights hash, config hash, pool geometry,
    seed, spec_draft_max, dtypes, the walk's impl), and
    `expect_buckets` (pass the serving buckets) must equal the saved
    ones: anything else raises ArtifactMismatchError naming the field,
    before any program is read."""
    from paddle_tpu_torch.serve.engine import state_leaves

    with tarfile.open(path, "r") as tar:
        manifest = json.loads(
            tar.extractfile(_MANIFEST_NAME).read().decode())
        if manifest.get("engine_format_version") != ENGINE_FORMAT_VERSION:
            raise ArtifactMismatchError(
                f"engine_format_version "
                f"{manifest.get('engine_format_version')!r} != "
                f"{ENGINE_FORMAT_VERSION}")
        for k, want in engine.artifact_manifest().items():
            got = manifest.get(k, "<missing>")
            if got != want:
                raise ArtifactMismatchError(
                    f"manifest field {k!r}: artifact {got!r} != engine "
                    f"{want!r}")
        if expect_buckets is not None:
            want_b = sorted(int(b) for b in expect_buckets)
            if manifest.get("buckets") != want_b:
                raise ArtifactMismatchError(
                    f"buckets: artifact {manifest.get('buckets')!r} != "
                    f"serving {want_b!r}")
        blobs = {name: tar.extractfile(f"{_PROGRAM_DIR}/{name}").read()
                 for name in manifest.get("programs", [])}

    def bound(module):
        def call(params, state, *extra):
            return module(*_leaves(params), *state_leaves(state), *extra)
        return call

    programs = {}
    for name, blob in blobs.items():
        programs[name] = bound(_load_program(blob).module())
    return programs, manifest
