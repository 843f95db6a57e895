"""The port's network shuffle transport (``shuffle/network.py``).

Mirrors ``tests/test_network_shuffle.py``: the server round trip, sends
windowed through the bounce pool, a query whose map side runs in another
process and pushes its pieces over TCP, retries with backoff and the
clean ``FetchFailedError``, the ``fetch`` fault channel, and partitioned
queries under ``shuffle.transport.class=network`` against the same
queries under ``host`` and against the reference's network transport.
The wire is the reference's: its client fetches from the port's server
and decodes the port's bytes. Every socket and thread the tests start
has a timeout of its own, so a broken peer fails its test instead of
hanging the run.
"""
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from spark_rapids_tpu.shuffle.network import ShuffleClient as JClient
from spark_rapids_tpu.shuffle.serializer import deserialize_batch
from spark_rapids_tpu.sql.session import TpuSession as JSession
from spark_rapids_tpu_torch import faults
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
from spark_rapids_tpu_torch.conf import RapidsConf
from spark_rapids_tpu_torch.exec.exchange import make_transport
from spark_rapids_tpu_torch.shuffle.network import (BounceBuffers,
                                                    FetchFailedError,
                                                    NetworkShuffleTransport,
                                                    ShuffleClient,
                                                    ShuffleServer)
from spark_rapids_tpu_torch.shuffle.serializer import serialize_batch
from spark_rapids_tpu_torch.sql.session import TpuSession as PSession

from test_torch_exchange import PORT, REF, check, left, right

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = {"spark.rapids.tpu.shuffle.mode": "host",
       "spark.rapids.tpu.shuffle.transport.class": "network",
       "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}
HOST = {**NET, "spark.rapids.tpu.shuffle.transport.class": "host"}
JOIN_S = 10  # seconds a test waits for a thread it started


def _batch():
    schema = schema_of(k=T.INT, v=T.LONG, s=T.STRING)
    return ColumnarBatch.from_pydict(
        {"k": [1, 2, None], "v": [10, 20, 30],
         "s": ["a", None, "x" * 500]}, schema, device="cpu")


def test_server_roundtrip_and_reference_client():
    srv = ShuffleServer(window_bytes=256, window_count=2)
    try:
        batch = _batch()
        data = serialize_batch(batch, "none")
        cli = ShuffleClient(srv.address)
        cli.push_serialized(7, 0, 3, data)
        cli.push_serialized(7, 1, 3, data)
        got = cli.fetch_serialized(7, 3)
        assert [m for m, _ in got] == [0, 1]
        assert cli.fetch_serialized(7, 99) == []
        cli.close()
        # the reference's client speaks the same wire and decodes the
        # port's bytes into the same rows
        jcli = JClient(srv.address)
        jgot = jcli.fetch_serialized(7, 3)
        jcli.close()
        assert [d for _, d in jgot] == [d for _, d in got]
        assert deserialize_batch(jgot[0][1]).to_rows() == batch.to_rows()
    finally:
        srv.close()


def test_windowed_send_smaller_than_piece():
    srv = ShuffleServer(window_bytes=128, window_count=2)
    try:
        payload = os.urandom(10_000)
        cli = ShuffleClient(srv.address)
        cli.push_serialized(1, 0, 0, payload)
        [(mid, got)] = cli.fetch_serialized(1, 0)
        assert mid == 0 and got == payload
        cli.close()
    finally:
        srv.close()


def test_bounce_pool_blocks_at_capacity():
    pool = BounceBuffers(count=2, size=64)
    a, b = pool.acquire(), pool.acquire()
    acquired = []
    t = threading.Thread(target=lambda: acquired.append(pool.acquire()),
                         daemon=True)
    t.start()
    t.join(0.2)
    assert t.is_alive() and not acquired  # the window is closed
    with pytest.raises(TimeoutError):
        pool.acquire(timeout=0.05)
    pool.release(a)
    t.join(JOIN_S)
    assert not t.is_alive() and acquired
    pool.release(acquired[0])
    pool.release(b)


_MAPPER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar import ColumnarBatch, schema_of
    from spark_rapids_tpu_torch.conf import RapidsConf
    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.exec.base import vals_of_batch
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col
    from spark_rapids_tpu_torch.shuffle.network import (
        NetworkShuffleTransport)
    from spark_rapids_tpu_torch.shuffle.transport import ShufflePiece

    host, port, nparts = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    rng = np.random.default_rng(99)
    n = 5000
    schema = schema_of(k=T.INT, v=T.LONG)
    batch = ColumnarBatch.from_pydict(
        {{"k": [int(x) for x in rng.integers(0, 37, n)],
          "v": [int(x) for x in rng.integers(-100, 100, n)]}}, schema,
        device="cpu")
    conf = RapidsConf({{}})
    part = TpuHashAggregateExec(
        conf, [col("k")],
        [A.agg(A.Sum(col("v")), "s"), A.agg(A.Count(None), "c")],
        InMemoryScanExec(conf, [[batch]], schema), mode=A.PARTIAL)
    [pbatch] = list(part.execute_columnar())
    pschema = part.output_schema
    tr = NetworkShuffleTransport(push_to=(host, port), codec="lz4")
    rows = pbatch.to_rows()
    for rid in range(nparts):
        sub = [r for r in rows if (r[0] or 0) % nparts == rid]
        if not sub:
            continue
        sb = ColumnarBatch.from_pydict(
            {{f.name: [r[i] for r in sub]
              for i, f in enumerate(pschema.fields)}}, pschema,
            device="cpu")
        tr.write(1, 0, rid, ShufflePiece(vals_of_batch(sb), sb.num_rows),
                 pschema)
    tr.close()
    print("MAPPER_DONE")
""")


def test_query_across_two_processes():
    import numpy as np

    from spark_rapids_tpu_torch.exec import (InMemoryScanExec,
                                             TpuHashAggregateExec)
    from spark_rapids_tpu_torch.exec.base import batch_from_vals
    from spark_rapids_tpu_torch.expr import aggregates as A
    from spark_rapids_tpu_torch.expr.expressions import col

    nparts = 4
    srv = ShuffleServer()
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _MAPPER.format(repo=ROOT),
             srv.address[0], str(srv.address[1]), str(nparts)],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=ROOT))
        assert "MAPPER_DONE" in proc.stdout, proc.stderr[-2000:]
        conf = RapidsConf({})
        tr = NetworkShuffleTransport(server=srv, owns_server=False,
                                     device="cpu")
        pschema = schema_of(k=T.INT, s=T.LONG, c=T.LONG)
        rows = []
        for rid in range(nparts):
            pieces = tr.fetch(1, rid)
            if not pieces:
                continue
            batches = [batch_from_vals(p.vals, pschema, p.n)
                       for p in pieces]
            fin = TpuHashAggregateExec(
                conf, [col("k")],
                [A.agg(A.Sum(col("v")), "s"), A.agg(A.Count(None), "c")],
                InMemoryScanExec(conf, [batches], pschema), mode=A.FINAL)
            for b in fin.execute_columnar():
                rows.extend(b.to_rows())
        rng = np.random.default_rng(99)
        k = rng.integers(0, 37, 5000)
        v = rng.integers(-100, 100, 5000)
        want = {}
        for kk, vv in zip(k, v):
            s, c = want.get(int(kk), (0, 0))
            want[int(kk)] = (s + int(vv), c + 1)
        assert {r[0]: (r[1], r[2]) for r in rows} == want
    finally:
        srv.close()


def _find_transport(node):
    tr = getattr(node, "transport", None)
    if tr is not None:
        return tr
    kids = list(getattr(node, "children", ()))
    if getattr(node, "tpu_child", None) is not None:
        kids.append(node.tpu_child)
    for c in kids:
        found = _find_transport(c)
        if found is not None:
            return found
    return None


def _agg(m, sess):
    A, E = m["A"], m["E"]
    return left(m, sess, parts=4).group_by("s").agg(
        A.agg(A.Sum(E.UnresolvedAttribute("x")), "sx"),
        A.agg(A.Count(None), "n"))


def _join(m, sess):
    return left(m, sess).join(right(m, sess), on=[("k", "rk")])


@pytest.mark.parametrize("q", [_agg, _join], ids=["agg", "join"])
def test_network_transport_against_host_and_reference(q):
    ns = PSession(NET, device="cpu")
    got = q(PORT, ns).collect()
    tr = _find_transport(ns.last_executed_plan)
    assert type(tr).__name__ == "NetworkShuffleTransport"
    assert tr.stats()["bytes_fetched"] > 0
    check(q(PORT, PSession(HOST, device="cpu")).collect(), got)
    if q is _agg:  # the reference's network run (its compiles are slow)
        check(q(REF, JSession(NET)).collect(), got)


def test_fetch_failure_is_clean_and_retries_recover():
    srv = ShuffleServer(window_bytes=128, window_count=2)
    payload = os.urandom(50_000)
    cli = ShuffleClient(srv.address, retries=3, retry_wait_s=0.05)
    cli.push_serialized(5, 0, 0, payload)
    # hard-kill the server shortly after fetching starts: in-flight
    # connections are severed AND the port stops accepting
    killer = threading.Timer(0.01, lambda: srv.close(force=True))
    killer.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(FetchFailedError):
            for _ in range(2000):  # keep fetching until the kill lands
                got = cli.fetch_serialized(5, 0)
                assert got and got[0][1] == payload
        assert time.monotonic() - t0 < 30  # bounded, no hang
        assert cli.failure_count == 1
    finally:
        killer.cancel()
        killer.join(JOIN_S)
        cli.close()
        srv.close(force=True)
    # a transient drop then recovery: the retry path reconnects
    srv2 = ShuffleServer()
    try:
        cli2 = ShuffleClient(srv2.address, retries=3, retry_wait_s=0.05)
        cli2.push_serialized(6, 0, 0, payload)
        cli2._sock.close()
        assert cli2.fetch_serialized(6, 0)[0][1] == payload
        assert cli2.retry_count == 1
        cli2.close()
    finally:
        srv2.close()


def test_silent_peer_times_out():
    """A peer that accepts and never answers fails the fetch within the
    socket timeout instead of hanging it."""
    lsn = socket.socket()
    lsn.settimeout(JOIN_S)
    lsn.bind(("127.0.0.1", 0))
    lsn.listen(4)
    try:
        cli = ShuffleClient(lsn.getsockname(), retries=2, retry_wait_s=0.01,
                            timeout_s=0.2)
        t0 = time.monotonic()
        with pytest.raises(FetchFailedError, match="timed out"):
            cli.fetch_serialized(1, 0)
        assert time.monotonic() - t0 < 5
        cli.close()
    finally:
        lsn.close()


def test_fetch_fault_channel():
    srv = ShuffleServer()
    try:
        data = serialize_batch(_batch(), "none")
        ShuffleClient(srv.address).push_serialized(3, 0, 0, data)
        # one injected failure: the backoff retry recovers it
        faults.install(RapidsConf(
            {"spark.rapids.tpu.test.faults.fetch": "network_fetch@1"}))
        cli = ShuffleClient(srv.address, retries=3, retry_wait_s=0.01)
        assert cli.fetch_serialized(3, 0)[0][1] == data
        assert cli.retry_count == 1
        assert faults.active().fired() == [("fetch", "network_fetch", 1)]
        # every arrival fails: the retries run out cleanly
        faults.install(RapidsConf(
            {"spark.rapids.tpu.test.faults.fetch": "network_fetch"}))
        with pytest.raises(FetchFailedError, match="injected fetch fault"):
            cli.fetch_serialized(3, 0)
        assert cli.failure_count == 1
        cli.close()
    finally:
        faults.uninstall()
        srv.close()


@pytest.mark.parametrize("bad", ["hostonly", "host:", ":9000", "host:port"])
def test_invalid_peer_entry_raises_conf_error(bad):
    conf = RapidsConf({
        "spark.rapids.tpu.shuffle.transport.class": "network",
        "spark.rapids.tpu.shuffle.network.peers": f"ok-host:9000,{bad}",
    })
    with pytest.raises(ValueError) as ei:
        make_transport(conf, "cpu")
    assert "spark.rapids.tpu.shuffle.network.peers" in str(ei.value)
    assert repr(bad) in str(ei.value)
