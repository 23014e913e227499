"""The port's socket transport (`serve.transport`) held against the JAX
package's, case by case of tests/test_fleet.py's transport section: each
case runs on both packages' `ReplicaTransportServer` (in a thread, over
real sockets, a `ServingServer` on the shared TINY weights behind it) and
the verdicts, counters and tokens must be equal. The port adds one rule
of its own: no torch tensor ever enters a frame."""

import pickle
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.wire import MAX_FRAME, recv_frame, send_frame
from paddle_tpu_torch import wire as t_wire
from torch_fleet import JAX, SIDES, TINY, TORCH, engine, mk_prompts

pytestmark = [pytest.mark.fleet, pytest.mark.faults]



@pytest.fixture(scope="module", autouse=True)
def warm():
    engine(JAX).serve([np.arange(5, dtype=np.int32)], max_new=2,
                             buckets=(16,))


class Stack:
    """A `ServingServer` behind an in-thread transport, plus a raw
    client, on one side; fresh per use so idempotency ledgers and queue
    state never leak between cases."""

    def __init__(self, side, **server_kw):
        kw = dict(max_queue=8, max_retries=2, buckets=(16,))
        kw.update(server_kw)
        self.side = side
        self.srv = side.ServingServer(engine(side), **kw)
        self.ts = side.ReplicaTransportServer(self.srv).start()
        self.client = side.ReplicaClient(self.ts.addr, connect_timeout=2.0,
                                         io_timeout=30.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.ts.shutdown()


def both(case):
    """Run `case(stack)` on a fresh stack of each package; returns the
    (jax, port) pair of what it returned."""
    out = []
    for side in SIDES:
        with Stack(side) as st:
            out.append(case(st))
    return tuple(out)


def submit_kwargs(prompt, tag="t-a", max_new=2):
    return dict(tag=tag, prompt=np.asarray(prompt, np.int32),
                max_new=max_new, deadline_ms=-1, sampling=None,
                retries_left=None, trace_id=None)


def test_submit_tag_replay_is_idempotent():
    def case(st):
        st1, rid1, _ = st.client.call("submit", submit_kwargs([1, 2, 3]))
        # the retry of a lost reply: same tag, same bytes
        st2, rid2, state = st.client.call("submit",
                                          submit_kwargs([1, 2, 3]))
        return st1, st2, rid1, rid2, state["counters"]["requests"]

    ref, got = both(case)
    assert got == ref
    assert got[:2] == ("ok", "ok") and got[2] == got[3] and got[4] == 1


def test_submit_rejection_replays_the_same_verdict():
    def case(st):
        bad = submit_kwargs(np.arange(40, dtype=np.int32) % TINY["vocab"],
                            tag="t-bad")        # 40 > max_len=32
        st1, err1, _ = st.client.call("submit", bad)
        st2, err2, state = st.client.call("submit", bad)
        return (st1, st2, type(err1).__name__, type(err2).__name__,
                str(err1), str(err2), getattr(err1, "req_id", None),
                getattr(err2, "req_id", None),
                state["counters"]["requests"])

    ref, got = both(case)
    assert got == ref
    assert got[:4] == ("err", "err", "ValueError", "ValueError")
    assert got[4] == got[5] and got[6] == got[7] is not None


def test_results_redelivered_until_acked():
    def case(st):
        _, rid, _ = st.client.call("submit", submit_kwargs([4, 5, 6],
                                                           max_new=4))
        state, steps = None, 0
        for _ in range(64):
            _, _, state = st.client.call("step")
            steps += 1
            if rid in state["results"]:
                break
        res = state["results"][rid]
        # un-ACKed: every later reply redelivers it
        _, _, again = st.client.call("sync")
        # ACKed: gone from the next state block
        _, _, acked = st.client.call("sync", acks=(rid,))
        return (steps, res.outcome, [int(t) for t in res.tokens],
                rid in again["results"], rid in acked["results"],
                acked["counters"]["completed"])

    ref, got = both(case)
    assert got == ref
    assert got[1] == "completed" and got[3] and not got[4]


def test_garbage_bytes_answered_in_band():
    def case(st):
        sock = socket.create_connection(st.ts.addr, timeout=5.0)
        try:
            send_frame(sock, b"\x80\x04 this is not a pickle")
            status, payload, state = pickle.loads(recv_frame(sock))
            # the connection is dropped after a desynced-content frame
            dropped = sock.recv(1) == b""
        finally:
            sock.close()
        # the server survives and serves fresh connections
        return (status, type(payload).__name__,
                "undecodable" in str(payload), state, dropped,
                st.client.call("ping")[0])

    ref, got = both(case)
    assert got == ref == ("err", "ConnectionError", True, None, True, "ok")


def test_truncated_frame_does_not_kill_the_server():
    def case(st):
        sock = socket.create_connection(st.ts.addr, timeout=5.0)
        sock.sendall(struct.pack("<I", 100) + b"only ten b")
        sock.close()                  # peer closes mid-frame
        return st.client.call("ping")[0]

    assert both(case) == ("ok", "ok")


def test_oversized_frame_rejected_without_allocation():
    assert t_wire.MAX_FRAME == MAX_FRAME

    def case(st):
        sock = socket.create_connection(st.ts.addr, timeout=5.0)
        try:
            sock.sendall(struct.pack("<I", MAX_FRAME + 1))
            # the server refuses the header and closes; it never reads
            # (or allocates) the advertised body
            closed = sock.recv(1) == b""
        finally:
            sock.close()
        return closed, st.client.call("ping")[0]

    assert both(case) == ((True, "ok"), (True, "ok"))


@pytest.mark.parametrize("side", SIDES, ids=lambda s: s.name)
def test_connect_loss_vs_midflight_loss(side):
    # CONNECT exhaustion: nothing listening -- the op never ran
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_addr = probe.getsockname()
    probe.close()
    client = side.ReplicaClient(dead_addr, connect_timeout=0.2,
                                retries=2, sleep=lambda s: None)
    with pytest.raises(side.TransportConnectError):
        client.call("ping")

    # MID-FLIGHT loss: the peer accepts, reads, then hangs -- the op may
    # or may not have executed, and the error must say so
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(4)
    hung = []

    def black_hole():
        for _ in range(2):
            try:
                conn, _ = lst.accept()
            except OSError:
                return
            hung.append(conn)         # never reply

    t = threading.Thread(target=black_hole, daemon=True)
    t.start()
    try:
        client = side.ReplicaClient(lst.getsockname(), connect_timeout=2.0,
                                    io_timeout=0.1, retries=2,
                                    sleep=lambda s: None)
        with pytest.raises(side.TransportCallError):
            client.call("ping")
    finally:
        lst.close()
        for c in hung:
            c.close()


def test_double_handoff_complete_releases_once():
    def case(st):
        calls = []
        st.srv.handoff_complete = lambda rid: calls.append(("complete", rid))
        st.srv.cancel_handoff = lambda rid: calls.append(("cancel", rid))
        verdicts = [
            st.client.call("handoff_complete", dict(req_id=7))[0],
            # the ACK replay (reply lost, destination resends): no-op
            st.client.call("handoff_complete", dict(req_id=7))[0],
            # a stale cancel racing the completed handoff: suppressed
            st.client.call("cancel_handoff", dict(req_id=7))[0]]
        return verdicts, calls

    ref, got = both(case)
    assert got == ref == (["ok"] * 3, [("complete", 7)])


def test_process_replica_mirror_ledger():
    """The router-side mirror answers the harvest surfaces without RPC
    and keeps the budgets the redistribution path carries."""
    def case(st):
        rep = st.side.ProcessReplica(st.client)
        prompts = mk_prompts(2, seed=9)
        rids = [rep.submit(p, max_new=3) for p in prompts]
        pending = [(r.req_id, r.retries_left)
                   for r in rep.pending_requests()]
        for _ in range(64):
            if all(r in rep.results for r in rids):
                break
            rep.step()
        out = dict(
            rids=rids, pending=pending, max_retries=rep.max_retries,
            results=[(rep.results[r].outcome,
                      [int(t) for t in rep.results[r].tokens])
                     for r in rids],
            after=rep.pending_requests(),
            completed=rep.counters()["completed"])
        # withdraw pops the mirror: submit-then-withdraw leaves no ghost
        rid = rep.submit(prompts[0], max_new=2)
        req = rep.withdraw_queued(rid)
        out["withdrawn"] = req is not None and req.req_id == rid
        out["ghosts"] = rep.pending_requests()
        return out

    ref, got = both(case)
    assert got == ref
    assert sorted(got["rids"]) == [r for r, _ in got["pending"]]
    assert all(b == got["max_retries"] for _, b in got["pending"])
    assert all(o == "completed" for o, _ in got["results"])
    assert got["after"] == [] and got["completed"] == 2
    assert got["withdrawn"] and got["ghosts"] == []


def _leaves(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v)
    elif hasattr(obj, "__dataclass_fields__"):
        for k in obj.__dataclass_fields__:
            yield from _leaves(getattr(obj, k))
    else:
        yield obj


def test_export_request_frames_carry_host_data_only():
    """A prefill replica's export crosses the socket as numpy and Python
    values (the KV pages, the DecodeSeed with its uint8 generator state):
    no torch tensor enters the frame. A server whose export hands back a
    tensor is answered with the transport's TypeError, never a frame
    that would unpickle a tensor (onto a device) router-side."""
    srv = TORCH.ServingServer(engine(TORCH), max_queue=8, buckets=(16,),
                              role="prefill")
    ts = TORCH.ReplicaTransportServer(srv).start()
    try:
        client = TORCH.ReplicaClient(ts.addr, io_timeout=30.0)
        st, rid, state = client.call("submit", submit_kwargs([1, 2, 3, 4],
                                                             max_new=4))
        assert st == "ok"
        for _ in range(16):
            _, _, state = client.call("step")
            if rid in state["handoffs"]:
                break
        assert state["handoffs"] == [rid]
        st, payload, _ = client.call("export_request", dict(req_id=rid))
        assert st == "ok", payload
        leaves = list(_leaves(payload))
        assert not any(isinstance(x, torch.Tensor) for x in leaves)
        arrays = [x for x in leaves if isinstance(x, np.ndarray)]
        assert payload["kv"] is not None and arrays
        seed = payload["seed"]
        assert isinstance(seed.rng_key_data, np.ndarray)
        assert seed.rng_key_data.dtype == np.uint8
        # the server-side export with a tensor in it is refused in-band
        real = srv.export_request
        srv.export_request = lambda req_id: {**real(req_id),
                                             "prompt": torch.arange(3)}
        st, err, _ = client.call("export_request", dict(req_id=rid))
        assert st == "err" and isinstance(err, TypeError)
        assert "torch tensor" in str(err)
    finally:
        ts.shutdown()
