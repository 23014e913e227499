"""Engine bundles (`paddle_tpu_torch.serve.artifact`, torch.export) on
the CPU, the port of tests/test_artifact_cache.py's bundle cases at the
JAX serving tests' small config (vocab 61, dim 32, 2 layers, dense
attention; `torch_serving.models`' shared weights):

- an engine served THROUGH the bundle gives the eager port engine's
  tokens and the JAX engine's, exactly: greedy and speculative; sampled
  requests (plain and speculative) give the eager port engine's from
  the same seeds;
- a manifest mismatch (buckets, torch_version, params_hash) is refused
  naming its field on a direct load, counted once with a flight event
  through ServingServer, and the eager path then serves correctly;
- int8 KV with int8 weights, and chunked prefills, serve through their
  bundles as eagerly; a bound program that fails is dropped, counted,
  and the eager body serves.

Bundles are exported once per module (each export traces every
program)."""

import io
import json
import tarfile

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.pytree import tree_leaves
from paddle_tpu_torch.obs.flight import FlightRecorder
from paddle_tpu_torch.serve import quant
from paddle_tpu_torch.serve.artifact import (ArtifactMismatchError,
                                             _load_program,
                                             load_engine_artifact,
                                             save_engine_artifact)
from torch_serving import JAX, TORCH, models

GEOM = dict(slots=2, max_len=64, page_size=16, num_pages=8)
BUCKETS = (32,)


def _engine(kv="compute", params=None, **kw):
    _, tcfg, _, tp = models(kv)
    return TORCH.DecodeEngine(tp if params is None else params, tcfg,
                              device="cpu", **GEOM, **kw)


def _prompts(seed, lens):
    r = np.random.RandomState(seed)
    return [r.randint(0, 61, (n,)).astype(np.int32) for n in lens]


def _spec_prompts():
    base = _prompts(2, [6])[0]
    return [np.concatenate([base] * 4)[:n] for n in (20, 24)]


GREEDY = dict(prompts=_prompts(1, [3, 20, 9]), max_new=8)
SAMPLING = [{"temperature": 0.8, "top_k": 10, "seed": i} for i in range(3)]


def _serve(srv, prompts, max_new, sampling=None):
    ids = [srv.submit(p, max_new=max_new,
                      sampling=None if sampling is None else sampling[i])
           for i, p in enumerate(prompts)]
    res = srv.run()
    assert all(res[i].outcome == "completed" for i in ids)
    return [res[i].tokens for i in ids]


def _server(side, eng, **kw):
    return side.ServingServer(eng, max_queue=8, buckets=BUCKETS, **kw)


def _bound(path, **kw):
    eng = _engine(**kw)
    progs, man = load_engine_artifact(eng, path, expect_buckets=BUCKETS)
    eng.bind_artifact(progs, man)
    return eng


class Calls(dict):
    """An engine's bound programs, each call counted."""

    def __init__(self, programs):
        super().__init__()
        self.n = {k: 0 for k in programs}
        for k, fn in programs.items():
            def counted(*a, _k=k, _fn=fn):
                self.n[_k] += 1
                return _fn(*a)
            self[k] = counted


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "engine.tar")
    save_engine_artifact(_engine(), path, buckets=BUCKETS)
    return path


def _no_spec():
    pol = TORCH.SchedulerPolicy()
    pol.spec_draft_max = 0          # no verify programs to export
    return pol


@pytest.fixture(scope="module")
def int8_bundle(tmp_path_factory):
    """int8 KV pools over weight-only int8 params."""
    qp = quant.quantize_params(models()[3])
    path = str(tmp_path_factory.mktemp("art") / "int8.tar")
    save_engine_artifact(_engine("int8", qp, policy=_no_spec()), path,
                         buckets=BUCKETS)
    return path, qp


@pytest.fixture(scope="module")
def chunked_bundle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "chunked.tar")
    man = save_engine_artifact(
        _engine(prefill_chunk=8, policy=_no_spec()), path)
    return path, man


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX engine's greedy and speculative tokens (its compiles are
    the slow part: once per module)."""
    jcfg, _, jp, _ = models()
    mk = lambda **kw: _server(JAX, JAX.DecodeEngine(jp, jcfg, **GEOM), **kw)
    return dict(greedy=_serve(mk(), **GREEDY),
                spec=_serve(mk(speculative=True), _spec_prompts(), 10))


def test_bundle_greedy_serve_matches_eager_and_jax(bundle, jax_tokens):
    eager = _serve(_server(TORCH, _engine()), **GREEDY)
    eng = _engine()
    srv = _server(TORCH, eng, artifact_path=bundle)
    assert (eng.artifact_loads, eng.artifact_fallbacks) == (1, 0)
    eng._artifact = calls = Calls(eng._artifact)
    got = _serve(srv, **GREEDY)
    assert got == eager == jax_tokens["greedy"]
    assert eng.artifact_fallbacks == 0
    # every decode step and every bucket prefill ran through a program
    assert calls.n["step"] > 0 and calls.n["chunk_w32_z1_f1"] == 3
    assert calls.n["step_sampled"] == 0
    c = srv.counters()
    assert (c["artifact_loads"], c["artifact_fallbacks"]) == (1, 0)


def test_bundle_speculative_serve_matches_eager_and_jax(bundle, jax_tokens):
    eager = _serve(_server(TORCH, _engine(), speculative=True),
                   _spec_prompts(), 10)
    eng = _bound(bundle)
    eng._artifact = calls = Calls(eng._artifact)
    srv = _server(TORCH, eng, speculative=True)
    got = _serve(srv, _spec_prompts(), 10)
    assert got == eager == jax_tokens["spec"]
    assert calls.n["spec"] > 0 and eng.artifact_fallbacks == 0
    # the n-gram proposer's drafts landed: the win case, not a no-op
    assert srv.stats.draft_accepted > 0


def test_bundle_sampled_serve_matches_eager(bundle):
    prompts = GREEDY["prompts"]
    eager = _serve(_server(TORCH, _engine()), prompts, 8, SAMPLING)
    eng = _bound(bundle)
    eng._artifact = calls = Calls(eng._artifact)
    got = _serve(_server(TORCH, eng), prompts, 8, SAMPLING)
    assert got == eager
    assert calls.n["step_sampled"] > 0 and calls.n["step"] == 0
    # the draws are the requests' own: other seeds, other tokens
    other = [dict(s, seed=s["seed"] + 10) for s in SAMPLING]
    assert _serve(_server(TORCH, eng), prompts, 8, other) != got
    assert eng.artifact_fallbacks == 0


def test_bundle_sampled_speculative_serve_matches_eager(bundle):
    prompts, samp = _spec_prompts(), SAMPLING[:2]
    eager = _serve(_server(TORCH, _engine(), speculative=True), prompts, 10,
                   samp)
    eng = _bound(bundle)
    eng._artifact = calls = Calls(eng._artifact)
    got = _serve(_server(TORCH, eng, speculative=True), prompts, 10, samp)
    assert got == eager
    assert calls.n["spec_sampled"] > 0 and eng.artifact_fallbacks == 0


def test_bundle_holds_programs_and_a_manifest_no_weights(bundle):
    with tarfile.open(bundle) as tar:
        names = sorted(tar.getnames())
        man = json.loads(tar.extractfile("manifest.json").read())
    assert names == ["manifest.json"] + [f"programs/{p}" for p in
                                         sorted(man["programs"])]
    assert man["programs"] == sorted(["step", "step_sampled", "spec",
                                      "spec_sampled", "chunk_w32_z1_f1"])
    assert man["torch_version"] == torch.__version__
    assert man["device_type"] == "cpu" and "jax_version" not in man
    assert man["buckets"] == [32] and man["spec_draft_max"] >= 1
    # the programs take the engine's weights as inputs: none holds a
    # tensor of its own beyond scalars (the score scale), and each takes
    # every weight leaf first
    n_weights = len(tree_leaves(models()[3]))
    with tarfile.open(bundle) as tar:
        for name in man["programs"]:
            ep = _load_program(tar.extractfile(f"programs/{name}").read())
            assert not ep.state_dict, name
            assert all(t.numel() == 1 for t in ep.constants.values()), name
            assert len(ep.graph_signature.user_inputs) > n_weights


# -- refusals ------------------------------------------------------------


def _tampered(bundle, tmp_path, field, value):
    out = str(tmp_path / f"tampered_{field}.tar")
    with tarfile.open(bundle) as src, tarfile.open(out, "w") as dst:
        for m in src.getmembers():
            data = src.extractfile(m).read()
            if m.name == "manifest.json":
                man = json.loads(data)
                man[field] = value
                data = json.dumps(man).encode()
            info = tarfile.TarInfo(m.name)
            info.size = len(data)
            dst.addfile(info, io.BytesIO(data))
    return out


@pytest.mark.parametrize("field", ["buckets", "torch_version",
                                   "params_hash"])
def test_bundle_mismatch_is_refused_counted_and_served_eagerly(
        bundle, tmp_path, field):
    """A bundle for other buckets, another PyTorch version or another
    weight tree is refused naming the field, counted once with its
    flight event, and the server serves the eager tokens."""
    if field == "buckets":
        path, buckets = bundle, (16, 32)
    else:
        path = _tampered(bundle, tmp_path, field, "0" * 16)
        buckets = BUCKETS
    with pytest.raises(ArtifactMismatchError, match=field.rstrip("s")):
        load_engine_artifact(_engine(), path, expect_buckets=buckets)
    flight = FlightRecorder()
    eng = _engine()
    srv = TORCH.ServingServer(eng, max_queue=8, buckets=buckets,
                              flight=flight, artifact_path=path)
    assert (eng.artifact_loads, eng.artifact_fallbacks) == (0, 1)
    assert eng._artifact is None
    evs = [e for e in flight.events()
           if e["kind"] == "artifact" and e["name"] == "fallback"]
    assert len(evs) == 1 and evs[0]["member"] == "load"
    assert field.rstrip("s") in evs[0]["error"]
    assert srv.counters()["artifact_fallbacks"] == 1
    want = _serve(TORCH.ServingServer(_engine(), max_queue=8,
                                      buckets=buckets), **GREEDY)
    assert _serve(srv, **GREEDY) == want


def test_a_failing_program_is_dropped_counted_and_served_eagerly(bundle):
    eng = _bound(bundle)
    events = []
    eng._artifact_hook = lambda member, err: events.append((member, err))

    def broken(*a):
        raise RuntimeError("lost device")

    eng._artifact["step"] = broken
    got = _serve(_server(TORCH, eng), **GREEDY)
    assert got == _serve(_server(TORCH, _engine()), **GREEDY)
    assert eng.artifact_fallbacks == 1 and "step" not in eng._artifact
    assert events == [("step", "RuntimeError('lost device')")]


# -- int8 KV with int8 weights; chunked prefills ---------------------------


def test_int8_kv_and_int8_weights_bundle_matches_eager(int8_bundle):
    path, qp = int8_bundle
    eng = _engine("int8", qp, policy=_no_spec())
    srv = _server(TORCH, eng, artifact_path=path)
    eng._artifact = calls = Calls(eng._artifact)
    got = _serve(srv, **GREEDY)
    want = _serve(_server(TORCH, _engine("int8", qp, policy=_no_spec())),
                  **GREEDY)
    assert got == want
    assert calls.n["step"] > 0 and eng.artifact_fallbacks == 0
    # the manifest binds the pool's dtype and the int8 tree
    with pytest.raises(ArtifactMismatchError, match="kv_cache_dtype"):
        load_engine_artifact(_engine(params=qp, policy=_no_spec()), path,
                             expect_buckets=BUCKETS)
    with pytest.raises(ArtifactMismatchError, match="params_hash"):
        load_engine_artifact(_engine("int8", policy=_no_spec()), path,
                             expect_buckets=BUCKETS)


def test_chunked_prefill_bundle_matches_eager(chunked_bundle):
    """An engine with prefill_chunk gets all four chunk programs, and a
    serve of chunked prompts runs each of them."""
    path, man = chunked_bundle
    assert man["programs"] == sorted(
        ["step", "step_sampled"] + [f"chunk_w8_z{z}_f{f}" for z in (0, 1)
                                    for f in (0, 1)])
    pre = _prompts(5, [16])[0]
    prompts = [pre[:13], np.concatenate([pre, [3, 4]]), pre[:5]]
    eager = _serve(TORCH.ServingServer(
        _engine(prefill_chunk=8, policy=_no_spec()), max_queue=8),
        prompts, 6)
    eng = _engine(prefill_chunk=8, policy=_no_spec())
    srv = TORCH.ServingServer(eng, max_queue=8, artifact_path=path)
    eng._artifact = calls = Calls(eng._artifact)
    assert _serve(srv, prompts, 6) == eager
    assert eng.artifact_fallbacks == 0
    assert all(calls.n[f"chunk_w8_z{z}_f{f}"] > 0 for z in (0, 1)
               for f in (0, 1))
