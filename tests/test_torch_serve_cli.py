"""`python -m paddle_tpu_torch serve` against `paddle_tpu.cli serve`: one
prompts file (padded to one bucket) through both packages' CLIs (bare,
through ServingServer with --max-queue, through ServingRouter with
--replicas 2) must print
the same transcript -- token lines and the `# outcomes` counters
trailer; the obs flags write a metrics file and flight dumps. `--http`
serves the same tokens over the streaming edge as JAX's `--http`, and
`--fleet-procs 2` (replica processes on the CPU, the config run in each
child) the same transcript tokens as JAX's `--replicas 2`. The flags
with no counterpart on the card fail naming their ROADMAP item."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.cli import main as jax_main
from paddle_tpu_torch.cli import SERVE_DEFERRED_FLAGS, build_parser
from paddle_tpu_torch.cli import main as torch_main

CONFIG = '''
from torch_parity import make_models


def get_serve_config():
    jcfg, tcfg, jp, tp = make_models(seed=0, vocab=61, dim=32,
                                     n_layers=2, n_heads=4,
                                     attn_impl="dense")
    return {{"cfg": {cfg}, "params": {params}, "slots": 2,
            "max_len": 24}}
'''


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve_cli")
    (d / "jax_cfg.py").write_text(CONFIG.format(cfg="jcfg", params="jp"))
    (d / "torch_cfg.py").write_text(CONFIG.format(cfg="tcfg", params="tp"))
    (d / "prompts.txt").write_text("1 2 3 4 5\n7 8 9\n1 2 3 4 5\n"
                                   "11 2 40 3\n")
    return d


_JAX_RUNS = {}


def _jax_lines(files, *flags):
    """JAX's transcript of the prompts under `flags`, run once per module
    (its engines compile on every run)."""
    key = (str(files),) + flags
    if key not in _JAX_RUNS:
        path = files / "out_jax.txt"
        assert jax_main(["serve", "--config", str(files / "jax_cfg.py"),
                         "--prompts", str(files / "prompts.txt"),
                         "--max-new", "4", "--buckets", "8", "--output",
                         str(path)] + list(flags)) == 0
        _JAX_RUNS[key] = path.read_text().splitlines()
    return _JAX_RUNS[key]


def _both(files, *flags):
    path = files / "out_torch.txt"
    assert torch_main(["serve", "--config", str(files / "torch_cfg.py"),
                       "--prompts", str(files / "prompts.txt"),
                       "--max-new", "4", "--buckets", "8", "--output",
                       str(path), "--device", "cpu"] + list(flags)) == 0
    lines = path.read_text().splitlines()
    assert lines == _jax_lines(files, *flags)
    return lines


def test_bare_serve_matches_jax(files):
    lines = _both(files)
    assert len(lines) == 4 and all(len(l.split()) == 4 for l in lines)


def test_reliable_serve_matches_jax(files):
    lines = _both(files, "--max-queue", "4")
    assert len(lines) == 5 and lines[-1].startswith("# outcomes ")
    assert "completed=4" in lines[-1]


def test_fleet_serve_matches_jax(files):
    lines = _both(files, "--replicas", "2", "--max-queue", "8")
    assert "completed=4" in lines[-1] and "replicas_alive=2" in lines[-1]


def test_metrics_out_and_flight_dir(files, tmp_path):
    metrics = tmp_path / "m.jsonl"
    flight = tmp_path / "flight"
    assert torch_main([
        "serve", "--config", str(files / "torch_cfg.py"), "--prompts",
        str(files / "prompts.txt"), "--max-new", "3", "--device", "cpu",
        "--replicas", "2", "--metrics-out", str(metrics),
        "--flight-dir", str(flight), "--output",
        str(tmp_path / "o.txt")]) == 0
    rows = [json.loads(l) for l in metrics.read_text().splitlines()]
    names = {r.get("name") for r in rows}
    assert "fleet_completed" in names and flight.is_dir()
    done = [r for r in rows if r.get("name") == "fleet_completed"]
    assert done[0]["value"] == 4


@pytest.fixture(scope="module")
def bundles(files):
    """Each package's bundle of the config's engine (exported once)."""
    from paddle_tpu.serve.artifact import save_engine_artifact as j_save
    from paddle_tpu.serve.engine import DecodeEngine as JEngine
    from paddle_tpu_torch.serve.artifact import save_engine_artifact
    from paddle_tpu_torch.serve.engine import DecodeEngine
    from torch_parity import make_models

    jcfg, tcfg, jp, tp = make_models(seed=0, vocab=61, dim=32, n_layers=2,
                                     n_heads=4, attn_impl="dense")
    geom = dict(slots=2, max_len=24, seed=0)
    j_save(JEngine(jp, jcfg, **geom), str(files / "jax_engine.tar"),
           buckets=(8,))
    save_engine_artifact(DecodeEngine(tp, tcfg, device="cpu", **geom),
                         str(files / "torch_engine.tar"), buckets=(8,))
    return files


def test_engine_artifact_serve_matches_jax(bundles):
    """--engine-artifact: each package's replica boots from its own
    bundle of the config's engine (serve.artifact) and the transcripts,
    counters trailer included, are equal: artifact_loads=1,
    artifact_fallbacks=0 on both."""
    files = bundles
    out = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        path = files / f"out_art_{name}.txt"
        argv = ["serve", "--config", str(files / f"{name}_cfg.py"),
                "--prompts", str(files / "prompts.txt"), "--max-new", "4",
                "--buckets", "8", "--output", str(path),
                "--engine-artifact", str(files / f"{name}_engine.tar")]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        out[name] = path.read_text().splitlines()
    assert out["torch"] == out["jax"]
    assert "artifact_loads=1" in out["torch"][-1]
    assert "artifact_fallbacks=0" in out["torch"][-1]


#: the serve flags that were deferred before the HTTP edge and the process
#: fleet were ported: flag -> (its argparse dest, a value)
PORTED_SERVE_FLAGS = {
    "--http": ("http", "0"), "--http-host": ("http_host", "0.0.0.0"),
    "--http-addr-file": ("http_addr_file", "a.txt"),
    "--http-max-requests": ("http_max_requests", "3"),
    "--fleet-procs": ("fleet_procs", "2"), "--fleet-max": ("fleet_max", "4"),
}


@pytest.mark.parametrize("flag", sorted(SERVE_DEFERRED_FLAGS)
                         + sorted(PORTED_SERVE_FLAGS))
def test_deferred_serve_flags_name_their_roadmap_item(files, flag, capsys):
    """A flag with no counterpart on the card fails naming its item; the
    edge's and the fleet's flags, once deferred, now parse."""
    if flag in PORTED_SERVE_FLAGS:
        dest, value = PORTED_SERVE_FLAGS[flag]
        args = build_parser().parse_args(
            ["serve", "--config", "cfg.py", flag, value])
        assert str(getattr(args, dest)) == value
        return
    takes_value, _ = SERVE_DEFERRED_FLAGS[flag]
    argv = ["serve", "--config", "cfg.py", "--prompts", "p.txt", flag] + (
        ["1"] if takes_value else [])
    with pytest.raises(SystemExit) as e:
        torch_main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet" in err and "ROADMAP queue 1" in err


def _wait_addr(addr_file, alive, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if addr_file.exists():
            host, port = addr_file.read_text().split()
            return host, int(port)
        assert alive(), "serve --http exited before binding"
        time.sleep(0.05)
    raise AssertionError("serve --http never published its address")


def test_http_serve_matches_jax(files, tmp_path):
    """`serve --http 0 --http-addr-file F --http-max-requests 2`: each
    package's verb runs its edge in a thread, a raw-socket client
    streams two completions from each, the tokens are equal, and the
    request limit drains the run to rc 0."""
    from paddle_tpu_torch.testing.traffic import stream_generate

    got = {}
    for name, main in (("jax", jax_main), ("torch", torch_main)):
        addr_file = tmp_path / f"addr_{name}.txt"
        argv = ["serve", "--config", str(files / f"{name}_cfg.py"),
                "--http", "0", "--http-addr-file", str(addr_file),
                "--http-max-requests", "2", "--max-queue", "8",
                "--buckets", "8"]
        if name == "torch":
            argv += ["--device", "cpu"]
        rc = {}
        t = threading.Thread(target=lambda: rc.update(v=main(argv)),
                             daemon=True)
        t.start()
        addr = _wait_addr(addr_file, t.is_alive)
        streams = [stream_generate(addr, p, 5)
                   for p in ([1, 2, 3, 4, 5], [7, 8, 9])]
        t.join(timeout=60.0)
        got[name] = ([(r.status, r.outcome, r.tokens) for r in streams],
                     rc.get("v"))
    assert got["torch"] == got["jax"]
    assert [s[:2] for s in got["torch"][0]] == [(200, "completed")] * 2
    assert got["torch"][1] == 0


FLEET_CONFIG = '''
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.testing.fleet import TINY, tiny_params


def get_serve_config():
    return {{"cfg": T.TransformerConfig(**TINY),
            "params": tiny_params(weights={weights!r}, device="cpu"),
            "slots": 2, "max_len": 24}}
'''


def test_fleet_procs_serve_matches_jax(files, tmp_path):
    """`serve --fleet-procs 2`: two replica processes on the CPU, each
    running a torch-only config (the shared weights from an .npz) in its
    own process; the transcript's token lines equal JAX's `--replicas 2`
    run of the same prompts, and the trailer carries the fleet and
    supervisor counters."""
    import jax

    from paddle_tpu_torch.testing.fleet import TINY, save_tiny_weights
    from torch_parity import make_models

    _, _, jp, _ = make_models(seed=0, **TINY)
    weights = save_tiny_weights(str(tmp_path / "w.npz"), jax.device_get(jp))
    cfg = tmp_path / "fleet_cfg.py"
    cfg.write_text(FLEET_CONFIG.format(weights=weights))
    path = tmp_path / "out_torch.txt"
    assert torch_main(["serve", "--config", str(cfg), "--prompts",
                       str(files / "prompts.txt"), "--max-new", "4",
                       "--buckets", "8", "--max-queue", "8", "--output",
                       str(path), "--fleet-procs", "2", "--device",
                       "cpu"]) == 0
    lines = path.read_text().splitlines()
    assert lines[:-1] == _jax_lines(files, "--replicas", "2",
                                    "--max-queue", "8")[:-1]
    assert len(lines) == 5
    trailer = lines[-1]
    for field in ("completed=4", "fleet_completed=4", "spawned=2",
                  "procs_alive=2", "replicas_lost=0"):
        assert field in trailer.split(), (field, trailer)


def test_serve_device_defaults_to_cuda(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_main(["serve", "--config", str(files / "torch_cfg.py"),
                    "--prompts", str(files / "prompts.txt")])
