"""Package rules of the PyTorch port: it loads neither JAX nor the JAX
package, its entry points refuse to run without the card unless asked
for the CPU, and its kernel build is lazy and keyed by the sources."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import graft_entry
from paddle_tpu_torch.core import dtypes as TD
from paddle_tpu_torch.core.devices import resolve_device
from paddle_tpu_torch.models import resnet, seq2seq_attn, text_lstm
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.models.weights import params_from_numpy
from paddle_tpu_torch.ops import _cuda
from paddle_tpu_torch.nn.module import ShapeSpec
from paddle_tpu_torch.nn.recurrent import GRU, LSTM
from paddle_tpu_torch.optim.optimizers import sgd
from paddle_tpu_torch.serve.engine import DecodeEngine
from paddle_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "paddle_tpu_torch", "paddle_tpu_torch.core.dtypes",
    "paddle_tpu_torch.core.devices", "paddle_tpu_torch.nn.initializers",
    "paddle_tpu_torch.ops.linalg", "paddle_tpu_torch.ops.norm",
    "paddle_tpu_torch.ops.sampling", "paddle_tpu_torch.ops.paged_attention",
    "paddle_tpu_torch.ops.ragged_paged_attention",
    "paddle_tpu_torch.ops.flash_attention",
    "paddle_tpu_torch.models.transformer", "paddle_tpu_torch.models.weights",
    "paddle_tpu_torch.parallel", "paddle_tpu_torch.parallel.moe",
    "paddle_tpu_torch.serve.paged", "paddle_tpu_torch.serve.policy",
    "paddle_tpu_torch.serve.speculative", "paddle_tpu_torch.serve.engine",
    "paddle_tpu_torch.core.pytree", "paddle_tpu_torch.serve.quant",
    "paddle_tpu_torch.ops.fused_lstm", "paddle_tpu_torch.ops.rnn",
    "paddle_tpu_torch.ops.losses", "paddle_tpu_torch.ops.sequence",
    "paddle_tpu_torch.nn.module", "paddle_tpu_torch.nn.layers",
    "paddle_tpu_torch.nn.recurrent", "paddle_tpu_torch.optim.schedules",
    "paddle_tpu_torch.optim.optimizers", "paddle_tpu_torch.train.state",
    "paddle_tpu_torch.train.events", "paddle_tpu_torch.train.trainer",
    "paddle_tpu_torch.models.text_lstm", "paddle_tpu_torch.ops.time_loop",
    "paddle_tpu_torch.ops.fused_gru", "paddle_tpu_torch.ops.fused_rnn",
    "paddle_tpu_torch.ops.beam_search", "paddle_tpu_torch.nn.recurrent_group",
    "paddle_tpu_torch.models.seq2seq_attn", "paddle_tpu_torch.ops.conv",
    "paddle_tpu_torch.ops.activations", "paddle_tpu_torch.nn.composite",
    "paddle_tpu_torch.models.lenet", "paddle_tpu_torch.models.smallnet",
    "paddle_tpu_torch.models.alexnet", "paddle_tpu_torch.models.vgg",
    "paddle_tpu_torch.models.googlenet", "paddle_tpu_torch.models.resnet",
    "paddle_tpu_torch.graft_entry", "paddle_tpu_torch.train.checkpoint",
    "paddle_tpu_torch.optim.average", "paddle_tpu_torch.optim.hooks",
    "paddle_tpu_torch.metrics", "paddle_tpu_torch.metrics.base",
    "paddle_tpu_torch.metrics.chunk", "paddle_tpu_torch.metrics.classify",
    "paddle_tpu_torch.metrics.editdist", "paddle_tpu_torch.metrics.printer",
    "paddle_tpu_torch.data", "paddle_tpu_torch.data.reader",
    "paddle_tpu_torch.data.batch", "paddle_tpu_torch.data.datasets",
    "paddle_tpu_torch.data.feeder", "paddle_tpu_torch.testing",
    "paddle_tpu_torch.testing.faults", "paddle_tpu_torch.train.resilience",
    "paddle_tpu_torch.cli", "paddle_tpu_torch.ops.crf",
    "paddle_tpu_torch.models.srl", "paddle_tpu_torch.models.quick_start",
    "paddle_tpu_torch.models.bilstm_crf",
    "paddle_tpu_torch.data.dataset_zoo", "paddle_tpu_torch.data.image",
    "paddle_tpu_torch.obs", "paddle_tpu_torch.obs.trace",
    "paddle_tpu_torch.obs.flight", "paddle_tpu_torch.obs.registry",
    "paddle_tpu_torch.serve", "paddle_tpu_torch.serve.shm_arena",
    "paddle_tpu_torch.serve.server", "paddle_tpu_torch.serve.router",
    "paddle_tpu_torch.serve.artifact", "paddle_tpu_torch.serve.capi_bridge",
    "paddle_tpu_torch.train",
    "paddle_tpu_torch.core.mesh", "paddle_tpu_torch.parallel.distributed",
    "paddle_tpu_torch.parallel.collectives",
    "paddle_tpu_torch.parallel.sharding",
    "paddle_tpu_torch.parallel.train_step",
    "paddle_tpu_torch.parallel.ring_attention",
    "paddle_tpu_torch.parallel.pipeline",
    "paddle_tpu_torch.parallel.sparse",
    "paddle_tpu_torch.parallel.blocked_matmul",
    "paddle_tpu_torch.parallel.launch", "paddle_tpu_torch.models.ctr",
    "paddle_tpu_torch.ops.embedding", "paddle_tpu_torch.cluster",
    "paddle_tpu_torch.cluster.lease", "paddle_tpu_torch.testing.gang",
    "paddle_tpu_torch.wire", "paddle_tpu_torch.cluster.membership",
    "paddle_tpu_torch.native", "paddle_tpu_torch.native.build",
    "paddle_tpu_torch.native.recordio", "paddle_tpu_torch.native.loader",
    "paddle_tpu_torch.native.taskqueue", "paddle_tpu_torch.native.pserver",
    "paddle_tpu_torch.parallel.pserver_client",
    "paddle_tpu_torch.serve.embed_cache", "paddle_tpu_torch.serve.ctr",
    "paddle_tpu_torch.train.online", "paddle_tpu_torch.testing.traffic",
    "paddle_tpu_torch.serve.transport", "paddle_tpu_torch.serve.http_edge",
    "paddle_tpu_torch.serve.fleet", "paddle_tpu_torch.cluster.agent",
    "paddle_tpu_torch.testing.fleet", "paddle_tpu_torch.ops.metrics",
    "paddle_tpu_torch.ops.misc", "paddle_tpu_torch.ops.ctc",
    "paddle_tpu_torch.ops.detection", "paddle_tpu_torch.metrics.detection",
    "paddle_tpu_torch.models.traffic", "paddle_tpu_torch.models.word2vec",
    "paddle_tpu_torch.models.recommender", "paddle_tpu_torch.models.vae",
    "paddle_tpu_torch.models.gan",
]


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_name_neither_jax_nor_the_jax_package():
    pkg = os.path.join(REPO, "paddle_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "import jax" not in text, f
                assert "from jax" not in text, f
                assert "from paddle_tpu." not in text, f
                assert "import paddle_tpu." not in text, f


def test_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TT.TransformerConfig(vocab=16, dim=16, n_layers=1, n_heads=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    params = TT.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(params, cfg, slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(params, cfg, slots=1, max_len=8, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_need_the_card_unless_asked_for_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layer = LSTM(8)
    spec = ShapeSpec((2, 3, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        layer.init(0, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(layer, lambda out: out.sum(), sgd())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text_lstm.init_params(0, 10, embed_dim=4, hidden=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        seq2seq_attn.init_params(0, 10, 10, embed_dim=4, hidden=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GRU(8).init(0, spec)
    params, _ = layer.init(0, spec, device="cpu")
    assert params["w_hh"].device == torch.device("cpu")
    Trainer(layer, lambda out: out.sum(), sgd(), device="cpu")


def test_image_entry_points_need_the_card_unless_asked_for_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prev = TD.default_policy()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft_entry.entry()
    finally:
        TD.set_default_policy(prev)
    model = resnet.resnet(18, width=4, num_classes=3)
    spec = ShapeSpec((1, 16, 16, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0, spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, lambda out: out.sum(), sgd())
    params, state = model.init(0, spec, device="cpu")
    assert state["stem_bn"]["mean"].device == torch.device("cpu")


def test_kernel_libraries_are_keyed_by_source_hash(tmp_path, monkeypatch):
    assert set(_cuda.SOURCES) == {"flash_attention",
                                  "ragged_paged_attention", "fused_lstm",
                                  "fused_gru", "fused_rnn"}
    for name, src in _cuda.SOURCES.items():
        assert (_cuda.CSRC_DIR / src).exists()
        path = _cuda.library_path(name)
        assert path.parent == _cuda.BUILD_DIR
        assert path.name.startswith(name + "-")
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS
    # an edited source, or an edited shared header, builds under a new
    # name
    before = _cuda.library_path("flash_attention")
    (tmp_path / "flash_attention.cu").write_text("// edited\n")
    monkeypatch.setattr(_cuda, "CSRC_DIR", tmp_path)
    edited = _cuda.library_path("flash_attention")
    assert edited != before
    (tmp_path / "tile_io.cuh").write_text("// edited\n")
    assert _cuda.library_path("flash_attention") != edited


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(os.path, "isfile", lambda p: False)
    monkeypatch.setattr("shutil.which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.nvcc_path()


def test_build_dir_is_ignored_by_git():
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "paddle_tpu_torch/_build/" in ignored


def test_first_operator_call_imports_no_dynamo():
    """Kernels A, B and C are torch.library operators; torch guards each
    registered kernel against dynamo and imports torch._dynamo at a
    process's first call (seconds: a replica process pays it in its
    boot). The port runs its operators eagerly, so the guard is skipped
    (`ops._cuda.skip_dynamo_guard`): the first calls import no dynamo
    and give the plain versions' results."""
    code = """
import sys, torch
from paddle_tpu_torch.ops import flash_attention as FA
from paddle_tpu_torch.ops import ragged_paged_attention as RPA
q = torch.randn(1, 16, 2, 64)
lens = torch.full((1,), 16, dtype=torch.int32)
o = FA.flash_attention(q, q, q, causal=True)
ref, _ = FA.flash_attention_reference(q, q, q, lens, causal=True)
assert torch.equal(o, ref)
qd = torch.randn(1, 1, 2, 8)
k = torch.randn(4, 4, 2, 8)
table = torch.tensor([[0, 1]], dtype=torch.int32)
pos0 = torch.tensor([5], dtype=torch.int32)
active = torch.tensor([True])
w = RPA.ragged_walk(qd, k, k, table, pos0, active, 4, 8)
assert torch.equal(w, RPA.ragged_reference(qd, k, k, table, pos0, active,
                                           page_size=4, max_len=8))
print("torch._dynamo" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
