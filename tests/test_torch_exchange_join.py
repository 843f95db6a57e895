"""The port's partitioned joins (broadcast and co-partitioned), a
two-file parquet directory with dictionary strings, the host transport,
a repeated ``collect()`` that rebuilds its exchanges, and row sets held
to the reference's default (mesh) route; through both packages'
sessions, with ``test_torch_exchange.py``'s helpers and tolerances (the
reference under ``spark.rapids.tpu.shuffle.mode=host``).
"""
import pytest

from test_torch_exchange import (PORT, REF, VFA, JSession, check, left,
                                 plan_text, q_group, q_group_strings,
                                 q_sort_string_limit, right, session, _rows,
                                 both)


# ---------------------------------------------------------------------------
# joins: broadcast and co-partitioned
# ---------------------------------------------------------------------------
JOIN_TYPES = ["inner", "left", "right", "full", "semi", "anti"]
BROADCAST = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 1 << 30}
SHUFFLED = {"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": -1}


def _join(how):
    def q(m, sess):
        return left(m, sess).join(right(m, sess), [("k", "rk")], how)
    return q


_REF_ROWS: dict = {}


@pytest.mark.parametrize("route", ["broadcast", "shuffled"])
@pytest.mark.parametrize("how", JOIN_TYPES)
def test_partitioned_join(how, route):
    """Both routes give the rows of one reference run per join type (its
    co-partitioned route: the rows do not depend on the route)."""
    settings = BROADCAST if route == "broadcast" else SHUFFLED
    if how not in _REF_ROWS:
        _REF_ROWS[how] = _join(how)(REF, session(REF, SHUFFLED)).collect()
    ps = session(PORT, settings)
    check(_REF_ROWS[how], _join(how)(PORT, ps).collect())
    text = plan_text(ps)
    if route == "broadcast" and how != "full":
        assert "TpuBroadcastExchangeExec" in text
        assert "TpuShuffleExchangeExec" not in text
    else:
        assert "TpuShuffleExchangeExec HashPartitioning" in text
        assert ("TpuLazyAQEReadExec" in text) == (how != "full")


def q_join_strings_pallas(m, sess):
    return left(m, sess).join(right(m, sess), [("s", "rs"), ("k", "rk")],
                              "inner")


def q_join_mixed_dtypes(m, sess):
    """int vs long keys: the single-partition fallback (Spark casts
    first; neither package inserts the cast)."""
    return left(m, sess).join(right(m, sess), [("k", "rx")], "left")


@pytest.mark.parametrize("q", [q_join_strings_pallas, q_join_mixed_dtypes])
def test_partitioned_join_keys(q):
    settings = {**SHUFFLED, "spark.rapids.tpu.sql.join.strategy": "PALLAS"}
    ref, got, ps = both(q, settings)
    check(ref, got)
    part = ("SinglePartitioning" if q is q_join_mixed_dtypes
            else "HashPartitioning")
    assert f"TpuShuffleExchangeExec {part}" in plan_text(ps)


# ---------------------------------------------------------------------------
# parquet directories, transports, repeated collects, the mesh route
# ---------------------------------------------------------------------------
def _write_parquet_dir(tmp_path, rows_a, rows_b):
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path / "pq"
    d.mkdir()
    for name, rows in (("a", rows_a), ("b", rows_b)):
        cols = list(zip(*rows))
        pq.write_table(pa.table({
            "k": pa.array(cols[0], pa.int32()),
            "x": pa.array(cols[1], pa.int64()),
            "d": pa.array(cols[2], pa.float64()),
            "s": pa.array(cols[3], pa.string())}), str(d / f"{name}.parquet"))
    return str(d)


def test_two_file_parquet_directory(tmp_path):
    """Two files are two splits: the group-by, the string sort and a
    join each go through exchanges; pyarrow's default dictionary
    encoding keeps the strings dictionary-encoded in the scan, and they
    materialize at the map side."""
    path = _write_parquet_dir(tmp_path, _rows(150, 1), _rows(90, 2))

    def qs(m, sess):
        E, A = m["E"], m["A"]
        df = sess.read.parquet(path)
        return [df.group_by("s").agg(A.agg(A.Count(None), "c"),
                                     A.agg(A.Sum(E.col("x")), "sx"),
                                     A.agg(A.Max(E.col("s")), "ms")),
                df.order_by("s", "x", "d", "k"),
                df.join(right(m, sess), [("s", "rs")], "inner")]

    rs = [q.collect() for q in qs(REF, session(REF, SHUFFLED))]
    ps = session(PORT, SHUFFLED)
    for i, (ref, q) in enumerate(zip(rs, qs(PORT, ps))):
        check(ref, q.collect(), ordered=i == 1)
        assert "TpuShuffleExchangeExec" in plan_text(ps)


@pytest.mark.parametrize("q", [q_group_strings, _join("full"),
                               q_sort_string_limit, _join("left")])
def test_host_transport(q):
    """Pieces through the host wire format give the device transport's
    rows, in the same order (the device route's rows of these queries are
    held to the reference above and in ``test_torch_exchange.py``; the
    random probe holds both transports to it), and the exchanges report
    the wire bytes and codec times."""
    rows = {}
    for kind in ("device", "host"):
        ps = session(PORT, {**BROADCAST, "spark.rapids.tpu.shuffle."
                            "transport.class": kind})
        rows[kind] = q(PORT, ps).collect()
    check(rows["device"], rows["host"], ordered=True)
    text = plan_text(ps)
    assert "shuffleBytesWritten" in text or "dataSize" in text
    if "TpuShuffleExchangeExec" in text:
        assert "codecEncodeTime" in text and "codecDecodeTime" in text


def test_repeated_collect_rebuilds_the_exchange():
    """A second ``collect()`` of the same DataFrame re-runs the map side
    (the first released every piece) and gives the same rows."""
    from spark_rapids_tpu_torch.exec.exchange import TpuShuffleExchangeExec

    settings = {**SHUFFLED, **VFA}
    ps = session(PORT, settings)
    df = q_group(PORT, ps).join(right(PORT, ps), [("k", "rk")], "full")
    first = df.collect()
    plan = ps.last_executed_plan.tpu_child

    def exchanges(node):
        out = [node] if isinstance(node, TpuShuffleExchangeExec) else []
        for c in node.children:
            out.extend(exchanges(c))
        return out

    exs = exchanges(plan)
    assert len(exs) == 3
    assert all(ex.transport.held(ex.shuffle_id) == 0 and not ex._map_done
               for ex in exs)
    second = df.collect()
    check(first, second)
    js = session(REF, settings)
    ref = q_group(REF, js).join(right(REF, js), [("k", "rk")],
                                "full").collect()
    check(ref, first)


@pytest.mark.parametrize("q", [q_group, _join("inner")])
def test_row_sets_equal_the_references_mesh_route(q):
    """The reference's default shuffle mode takes its mesh routes over the
    test's 8 virtual devices; the port's host exchange gives the same
    row set."""
    sess = JSession({})
    ref = q(REF, sess).collect()
    got = q(PORT, session(PORT, {})).collect()
    check(ref, got)


