"""The port's native runtime (`paddle_tpu_torch.native`) against the JAX
package's: the C++ sources are the originals byte for byte and build
into the port's own `_build/` at first use (never at import), recordio
files cross between the packages both ways, the task queue, its TCP
master and the restartable HAMaster give the originals' statuses, ids,
counts and snapshots under one scripted op sequence, and the `master`
verb serves, snapshots and recovers as a child process.

Every MasterServer and HAMaster a test starts is stopped in a `with`
block or a `finally`."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import types

import pytest

from paddle_tpu.native import build as JB
from paddle_tpu.native import loader as JLD
from paddle_tpu.native import recordio as JRIO
from paddle_tpu.native import taskqueue as JTQ
from paddle_tpu.testing import faults as JF
from paddle_tpu_torch.native import build as TB
from paddle_tpu_torch.native import loader as TLD
from paddle_tpu_torch.native import recordio as TRIO
from paddle_tpu_torch.native import taskqueue as TTQ
from paddle_tpu_torch.testing import faults as TF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = types.SimpleNamespace(name="jax", TQ=JTQ, RIO=JRIO, F=JF)
TORCH = types.SimpleNamespace(name="torch", TQ=TTQ, RIO=TRIO, F=TF)


# -- sources and build ---------------------------------------------------------


@pytest.mark.parametrize("src", ["recordio.cc", "taskqueue.cc",
                                 "loader.cc"])
def test_native_sources_are_the_originals(src):
    with open(os.path.join(REPO, "paddle_tpu", "native", "src", src),
              "rb") as a, open(os.path.join(
                  REPO, "paddle_tpu_torch", "native", "src", src),
                  "rb") as b:
        assert a.read() == b.read()


def test_the_library_builds_into_the_ports_build_dir():
    lib = TB.ensure_built()
    assert lib == TB.lib_path() and os.path.isfile(lib)
    assert os.path.dirname(lib) == os.path.join(REPO, "paddle_tpu_torch",
                                                "_build")
    assert all(s.startswith(os.path.join(REPO, "paddle_tpu_torch",
                                         "native", "src"))
               for s in TB.sources())
    assert os.path.basename(lib) != os.path.basename(JB.lib_path())
    assert "paddle_tpu_torch_native" in os.path.basename(lib)
    assert TTQ.get_lib()._name == lib


def test_importing_builds_nothing():
    """A child process with subprocess.run recording its calls imports
    every module over the native library: nothing is compiled."""
    code = """
import subprocess
calls = []
subprocess.run = lambda *a, **k: calls.append(a)
import paddle_tpu_torch.native
from paddle_tpu_torch.native import loader, pserver, recordio, taskqueue
from paddle_tpu_torch.train import online
from paddle_tpu_torch.serve import ctr, embed_cache
from paddle_tpu_torch.parallel import pserver_client
print(len(calls))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "0"


def test_concurrent_first_builds_publish_one_library(tmp_path):
    """Two processes race the first build into an empty build dir: the
    file lock lets one compile, both load the same published library
    and no temporary file is left behind."""
    code = f"""
import ctypes, importlib.util, subprocess
calls = []
real = subprocess.run
subprocess.run = lambda *a, **k: calls.append(a) or real(*a, **k)
spec = importlib.util.spec_from_file_location(
    "native_build", {TB.__file__!r})
build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(build)
build.BUILD_DIR = {str(tmp_path)!r}
lib = build.ensure_built()
ctypes.CDLL(lib).tq_create
print(lib, len(calls))
"""
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1] for o in outs]
    libs = {o[0].split()[0] for o in outs}
    assert len(libs) == 1 and libs.pop().startswith(str(tmp_path))
    assert sorted(int(o[0].split()[1]) for o in outs) == [0, 1]
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


# -- recordio across the packages ----------------------------------------------


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax_writes", "torch_writes"])
def test_recordio_files_cross_between_packages(tmp_path, writer, reader):
    recs = [json.dumps({"i": i, "pad": "x" * (i % 7)}).encode()
            for i in range(53)]
    path = str(tmp_path / "data.rio")
    writer.RIO.write_records(path, recs, records_per_chunk=10)
    assert reader.RIO.count_chunks(path) == writer.RIO.count_chunks(
        path) == 6
    assert reader.RIO.read_records(path) == recs
    assert reader.RIO.read_records(path, 2, 4) == recs[20:40]
    native = TLD if reader is TORCH else JLD
    got = list(native.native_reader([path], n_threads=1)())
    assert got == recs
    q = reader.TQ.TaskQueue()
    try:
        assert q.add_file_chunks(path, chunks_per_task=4) == 2
    finally:
        q.close()


def test_corrupt_recordio_is_refused_alike(tmp_path):
    path = str(tmp_path / "bad.rio")
    TRIO.write_records(path, [b"a" * 100, b"b" * 100], records_per_chunk=1)
    with open(path, "r+b") as f:
        f.seek(30)
        f.write(b"\xff\xff")
    errs = []
    for rio in (JRIO, TRIO):
        with pytest.raises(OSError) as e:
            rio.read_records(path)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


# -- the task queue, one scripted sequence --------------------------------------


def _queue_script(side, tmp):
    """Leases, a timeout, retries up to discard, PENDING_WAIT,
    next_pass (refused, then granted), the save-model election, a
    stale finish, snapshot and restore. Returns every result."""
    out = []
    TQ = side.TQ
    q = TQ.TaskQueue(timeout_ms=200, max_retries=1)
    try:
        out.append(q.get_task())                    # NOT_STARTED
        ids = [q.add_task(f"t{i}".encode()) for i in range(4)]
        out.append(ids)
        with pytest.raises(ValueError):
            q.add_task(b"x" * ((1 << 20) + 1))
        q.start()
        a = q.get_task()
        b = q.get_task()
        out += [a, b, q.counts()]
        q.finish_task(a[1])
        q.fail_task(b[1])                           # retry 1 of 1
        time.sleep(0.5)                             # no lease outstanding
        c = q.get_task()
        d = q.get_task()
        out += [c, d, q.counts()]
        time.sleep(0.5)                             # c and d time out
        out.append(q.counts())
        q.finish_task(c[1])                         # stale: a no-op
        with pytest.raises(KeyError):
            q.finish_task(12345)
        leased = [q.get_task() for _ in range(3)]
        out += [leased, q.get_task(), q.counts()]   # PENDING_WAIT
        with pytest.raises(RuntimeError):
            q.next_pass()
        for st, tid, _ in leased:
            if st == TQ.TaskStatus.OK:
                q.finish_task(tid)
        out += [q.get_task(), q.counts(), q.pass_num]   # PASS_END
        out.append(q.request_save_model(0, ttl_ms=200))
        out.append(q.request_save_model(1, ttl_ms=200))
        out.append(q.request_save_model(0, ttl_ms=200))
        time.sleep(0.5)
        out.append(q.request_save_model(1, ttl_ms=200))  # 0's grant lapsed
        snap = os.path.join(tmp, f"{side.name}.tq")
        q.snapshot(snap)
        with open(snap, "rb") as f:
            out.append(f.read())
        out.append(q.next_pass())
        q.start()
        out += [q.get_task(), q.counts()]
    finally:
        q.close()
    r = TQ.TaskQueue()
    try:
        r.restore(snap)
        out += [r.counts(), r.pass_num]
    finally:
        r.close()
    return out


def test_taskqueue_scripted_sequence_matches_jax(tmp_path):
    j = _queue_script(JAX, str(tmp_path))
    t = _queue_script(TORCH, str(tmp_path))
    assert t == j
    # the snapshots restore across the packages
    for mod, other in ((TTQ, "jax"), (JTQ, "torch")):
        q = mod.TaskQueue()
        try:
            q.restore(str(tmp_path / f"{other}.tq"))
            assert q.counts() == t[-2]
        finally:
            q.close()


def _master_script(side, tmp):
    out = []
    TQ = side.TQ
    q = TQ.TaskQueue(timeout_ms=60000, max_retries=1)
    with TQ.MasterServer(q) as srv:
        cli = TQ.MasterClient(port=srv.port, backoff_base=0.005, seed=0)
        plan = side.F.FaultPlan(master_drop_at=4)
        plan.wrap_master_client(cli)
        try:
            out.append([cli.add_task(f"net-{i}".encode()) for i in range(3)])
            cli.start()
            got = []
            while True:
                st, tid, payload = cli.get_task()
                out.append((st, tid, payload))
                if st != TQ.TaskStatus.OK:
                    break
                got.append(payload)
                cli.finish_task(tid)
            out += [sorted(got), cli.counts(), cli.pass_num,
                    cli.next_pass(), cli.request_save_model(0),
                    cli.request_save_model(1), list(plan.fired)]
        finally:
            cli.close()
    q.close()
    # HAMaster: crash after a snapshot, a new master recovers
    snap_dir = os.path.join(tmp, f"ha-{side.name}")
    m1 = TQ.HAMaster(snap_dir, interval_s=0)
    try:
        for i in range(3):
            m1.queue.add_task(f"task-{i}".encode())
        m1.queue.start()
        st, tid, _ = m1.queue.get_task()
        m1.queue.finish_task(tid)
        st2, tid2, _ = m1.queue.get_task()
        out.append(os.path.basename(m1.checkpoint()))
    finally:
        m1.stop(final_snapshot=False)
    m2 = TQ.HAMaster(snap_dir, interval_s=0)
    try:
        out += [os.path.basename(m2.recovered_from), m2.queue.counts()]
        m2.queue.finish_task(tid2)                  # superseded: no-op
        out.append(m2.queue.counts())
        reader_cli = TQ.MasterClient(port=m2.port)
        try:
            m2.queue.start()
            out.append(reader_cli.get_task())
        finally:
            reader_cli.close()
    finally:
        m2.stop()
    out.append(sorted(os.listdir(snap_dir)))
    return out


def test_master_server_client_and_ha_master_match_jax(tmp_path):
    assert _master_script(TORCH, str(tmp_path)) == _master_script(
        JAX, str(tmp_path))


@pytest.mark.parametrize("client_side,server_side", [(TORCH, JAX),
                                                     (JAX, TORCH)],
                         ids=["torch_client", "jax_client"])
def test_master_client_talks_to_the_other_packages_server(
        tmp_path, client_side, server_side):
    path = str(tmp_path / "train.rio")
    recs = [json.dumps({"i": i}).encode() for i in range(60)]
    client_side.RIO.write_records(path, recs, records_per_chunk=10)
    q = server_side.TQ.TaskQueue()
    try:
        assert q.add_file_chunks(path, chunks_per_task=2) == 3
        q.start()
        with server_side.TQ.MasterServer(q) as srv:
            cli = client_side.TQ.MasterClient(port=srv.port)
            try:
                got = sorted(json.loads(r)["i"]
                             for r in cli.record_reader()())
                assert got == list(range(60))
                assert cli.counts()["done"] == 3
            finally:
                cli.close()
    finally:
        q.close()


# -- the master verb -----------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_master(args):
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "master", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines = []
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line.strip())
        if line.startswith("master serving on"):
            return proc, lines
    proc.kill()
    raise AssertionError(f"master did not come up: {lines} "
                         f"{proc.communicate()[1][-2000:]}")


def _stop_master(proc):
    proc.send_signal(signal.SIGINT)
    out, err = proc.communicate(timeout=30)
    return proc.returncode, out, err


def test_master_verb_serves_snapshots_and_recovers(tmp_path):
    path = str(tmp_path / "train.rio")
    TRIO.write_records(path, [f"r{i}".encode() for i in range(40)],
                       records_per_chunk=10)
    snap = str(tmp_path / "master.tq")
    port = _free_port()
    proc, lines = _start_master(
        ["--port", str(port), "--dataset", path, "--snapshot", snap,
         "--snapshot-period", "0.1", "--task-timeout-ms", "60000"])
    try:
        assert lines == [f"{path}: 4 tasks",
                         f"master serving on 127.0.0.1:{port}"]
        cli = TTQ.MasterClient(port=port)
        try:
            for _ in range(2):
                st, tid, payload = cli.get_task()
                assert st == TTQ.TaskStatus.OK
                spec = json.loads(payload)
                assert spec["path"] == path
                cli.finish_task(tid)
            st, tid, _ = cli.get_task()             # leased at shutdown
            assert cli.counts() == {"todo": 1, "pending": 1, "done": 2,
                                    "discarded": 0}
        finally:
            cli.close()
    finally:
        rc, _, err = _stop_master(proc)
    assert rc == 0, err[-2000:]
    assert os.path.exists(snap)
    proc, lines = _start_master(["--port", str(port), "--snapshot", snap])
    try:
        assert lines[0] == f"recovered master state from {snap}"
        cli = JTQ.MasterClient(port=port)           # the JAX client
        try:
            assert cli.counts() == {"todo": 2, "pending": 0, "done": 2,
                                    "discarded": 0}
            done = 0
            while True:
                st, tid, _ = cli.get_task()
                if st != JTQ.TaskStatus.OK:
                    break
                cli.finish_task(tid)
                done += 1
            assert (st, done) == (JTQ.TaskStatus.PASS_END, 2)
        finally:
            cli.close()
    finally:
        rc, _, err = _stop_master(proc)
    assert rc == 0, err[-2000:]
