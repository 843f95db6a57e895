"""CPU physical operators — the 'stock Spark' half of the framework.

Own copy of ``spark_rapids_tpu/cpu/plan.py``: the port session's
fallback engine, with every ``Cpu*Exec`` of the reference.

Dual role mirroring the reference architecture (SURVEY.md §4 tier 3): the
fallback execution path for operators the planner can't place on TPU, and
the independent differential-test oracle. Implementations are deliberately
row-at-a-time pure Python over the cpu/interpreter so a shared bug can't
hide in both engines.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from .. import types as T
from ..conf import RapidsConf
from ..expr import aggregates as A
from ..expr import expressions as E
from ..types import StructField, StructType
from .interpreter import eval_row


class CpuExec:
    """Row-based physical operator (Spark CPU analog)."""

    def __init__(self, conf: RapidsConf, children: Sequence["CpuExec"] = ()):
        self.conf = conf
        self.children: List[CpuExec] = list(children)

    @property
    def output_schema(self) -> StructType:
        raise NotImplementedError(type(self).__name__)

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions if self.children else 1

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        raise NotImplementedError(type(self).__name__)

    def estimated_size_bytes(self):
        """Best-effort plan-size estimate for broadcast-join selection
        (reference: Spark statistics feeding autoBroadcastJoinThreshold).
        None = unknown; row-preserving subclasses override with the child
        pass-through below."""
        return None

    def _child_size_estimate(self):
        return self.children[0].estimated_size_bytes()

    def execute_rows(self) -> Iterator[tuple]:
        for p in range(self.num_partitions):
            yield from self.execute_rows_partition(p)

    def collect(self) -> List[tuple]:
        return list(self.execute_rows())

    @property
    def node_name(self) -> str:
        return type(self).__name__

    def tree_string(self, indent: int = 0) -> str:
        lines = ["  " * indent + self.describe()]
        for c in self.children:
            lines.append(c.tree_string(indent + 1))
        return "\n".join(lines)

    def describe(self) -> str:
        return self.node_name


def _schema_for(exprs: Sequence[E.Expression], child: StructType) -> StructType:
    fields = []
    for i, e in enumerate(exprs):
        name = (
            e.name
            if isinstance(e, (E.Alias, E.UnresolvedAttribute))
            else f"col{i}"
        )
        bound = E.bind_references(e, child)
        fields.append(StructField(name, bound.dtype, bound.nullable))
    return StructType(tuple(fields))


class CpuScanExec(CpuExec):
    def __init__(self, conf: RapidsConf, partitions: Sequence[Sequence[tuple]],
                 schema: StructType):
        super().__init__(conf)
        self._partitions = [list(p) for p in partitions]
        self._schema = schema

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return len(self._partitions)

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        yield from self._partitions[index]

    def estimated_size_bytes(self):
        nrows = sum(len(p) for p in self._partitions)
        ncols = max(1, len(self._schema.fields))
        return nrows * ncols * 16  # rough fixed-width guess


class CpuFileScanExec(CpuExec):
    """Row-based file scan — fallback path AND differential oracle for the
    TPU file scan. Values decode through the SAME numpy conversion as the
    device path (io/arrow_convert) so both engines agree on the value
    model (DATE = int days, TIMESTAMP = int micros, DECIMAL = unscaled)."""

    def __init__(self, conf: RapidsConf, scanner, fmt: str):
        super().__init__(conf)
        self.scanner = scanner
        self.fmt = fmt

    @property
    def output_schema(self):
        return self.scanner.schema

    @property
    def num_partitions(self):
        return max(1, self.scanner.num_splits())

    def describe(self):
        return f"CpuFileScanExec({self.fmt})"

    def estimated_size_bytes(self):
        import os

        try:
            return sum(os.path.getsize(f) for f, _ in self.scanner.files)
        except OSError:
            return None

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        from ..io.arrow_convert import _np_from_arrow_array

        if index >= self.scanner.num_splits():
            return
        table, pvals = self.scanner.read_split_i(index)
        schema = self.output_schema
        # select partition values by the schema's common keys (ragged
        # layouts can report extra per-split keys) — mirrors scan.py
        pkeys = list(getattr(self.scanner, "partition_cols", ()))
        npart = len(pkeys)
        file_fields = schema.fields[: len(schema.fields) - npart]
        n = table.num_rows
        cols: List[List[Any]] = []
        for f, name in zip(file_fields, table.column_names):
            import pyarrow as pa

            arr = table.column(name)
            if isinstance(arr, pa.ChunkedArray):
                if arr.num_chunks == 0:
                    arr = pa.array([], type=table.schema.field(name).type)
                else:
                    arr = arr.combine_chunks()
            parts = _np_from_arrow_array(arr, f.dataType)
            vals: List[Any] = []
            if len(parts) == 3:
                offsets, chars, validity = parts
                raw = chars.tobytes()
                for i in range(n):
                    if validity[i]:
                        b = raw[int(offsets[i]): int(offsets[i + 1])]
                        vals.append(
                            b if isinstance(f.dataType, T.BinaryType)
                            else b.decode("utf-8"))
                    else:
                        vals.append(None)
            else:
                data, validity = parts
                if isinstance(f.dataType, T.DecimalType):
                    import decimal as _d

                    s = f.dataType.scale
                    for i in range(n):
                        vals.append(
                            _d.Decimal(int(data[i])).scaleb(-s)
                            if validity[i] else None)
                else:
                    for i in range(n):
                        vals.append(data[i].item() if validity[i] else None)
            cols.append(vals)
        pmap = dict(pvals)
        for k in pkeys:
            v = pmap.get(k)
            cols.append([None if v is None else str(v)] * n)
        yield from zip(*cols) if cols else iter(())


class CpuRangeExec(CpuExec):
    def __init__(self, conf: RapidsConf, start: int, end: int, step: int = 1,
                 num_slices: int = 1, name: str = "id"):
        super().__init__(conf)
        self.start, self.end, self.step = start, end, step
        self.num_slices = num_slices
        self._schema = StructType((StructField(name, T.LONG, False),))

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return self.num_slices

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        total = max(0, -(-(self.end - self.start) // self.step))
        per = (total + self.num_slices - 1) // self.num_slices if total else 0
        for i in range(index * per, min(total, (index + 1) * per)):
            yield (self.start + i * self.step,)


class CpuProjectExec(CpuExec):
    def __init__(self, conf: RapidsConf, exprs: Sequence[E.Expression], child: CpuExec):
        super().__init__(conf, [child])
        self.exprs = list(exprs)
        self._schema = _schema_for(self.exprs, child.output_schema)
        self._bound = [E.bind_references(e, child.output_schema) for e in self.exprs]

    @property
    def output_schema(self):
        return self._schema

    def describe(self):
        return f"CpuProjectExec [{', '.join(map(str, self.exprs))}]"

    def estimated_size_bytes(self):
        return self._child_size_estimate()

    def _source_file(self, index: int) -> str:
        node: CpuExec = self.children[0]
        while True:
            scanner = getattr(node, "scanner", None)
            if scanner is not None and hasattr(scanner, "splits"):
                splits = scanner.splits()
                return splits[index].path if index < len(splits) else ""
            kids = node.children
            if len(kids) != 1:
                return ""
            node = kids[0]

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        if any(E.has_context_expr(b) for b in self._bound):
            # partition context (pid / row index / file) for the
            # nondeterministic+metadata family — mirrors the TPU project's
            # context columns so differential tests compare exactly
            from .interpreter import ROW_CTX

            fpath = self._source_file(index)
            for i, row in enumerate(
                    self.children[0].execute_rows_partition(index)):
                ROW_CTX.update(pid=index, row=i, file=fpath)
                try:
                    yield tuple(eval_row(b, row) for b in self._bound)
                finally:
                    ROW_CTX.update(pid=0, row=0, file="")
            return
        for row in self.children[0].execute_rows_partition(index):
            yield tuple(eval_row(b, row) for b in self._bound)


class CpuFilterExec(CpuExec):
    def __init__(self, conf: RapidsConf, condition: E.Expression, child: CpuExec):
        super().__init__(conf, [child])
        self.condition = condition
        self._bound = E.bind_references(condition, child.output_schema)

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def describe(self):
        return f"CpuFilterExec [{self.condition}]"

    def estimated_size_bytes(self):
        return self._child_size_estimate()

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        for row in self.children[0].execute_rows_partition(index):
            if eval_row(self._bound, row) is True:
                yield row


class CpuUnionExec(CpuExec):
    def __init__(self, conf: RapidsConf, children: Sequence[CpuExec]):
        super().__init__(conf, children)

    @property
    def output_schema(self):
        return self.children[0].output_schema

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        for c in self.children:
            if index < c.num_partitions:
                yield from c.execute_rows_partition(index)
                return
            index -= c.num_partitions
        raise IndexError(index)


class CpuLocalLimitExec(CpuExec):
    def __init__(self, conf: RapidsConf, limit: int, child: CpuExec):
        super().__init__(conf, [child])
        self.limit = limit

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def estimated_size_bytes(self):
        return self._child_size_estimate()

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        n = 0
        for row in self.children[0].execute_rows_partition(index):
            if n >= self.limit:
                return
            n += 1
            yield row


class CpuCollectLimitExec(CpuExec):
    """Global limit: gather partitions in order until ``limit`` rows
    (reference: CollectLimitExec / GpuCollectLimitMeta limit.scala:126)."""

    def __init__(self, conf: RapidsConf, limit: int, child: CpuExec):
        super().__init__(conf, [child])
        self.limit = limit

    @property
    def output_schema(self):
        return self.children[0].output_schema

    @property
    def num_partitions(self):
        return 1

    def estimated_size_bytes(self):
        return self._child_size_estimate()

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        n = 0
        for p in range(self.children[0].num_partitions):
            for row in self.children[0].execute_rows_partition(p):
                if n >= self.limit:
                    return
                n += 1
                yield row


class CpuExpandExec(CpuExec):
    def __init__(self, conf: RapidsConf, projections: Sequence[Sequence[E.Expression]],
                 output_names: Sequence[str], child: CpuExec):
        super().__init__(conf, [child])
        self.projections = [list(p) for p in projections]
        child_schema = child.output_schema
        first = [E.bind_references(e, child_schema) for e in self.projections[0]]
        self._schema = StructType(tuple(
            StructField(n, e.dtype, True) for n, e in zip(output_names, first)
        ))
        self._bound = [
            [E.bind_references(e, child_schema) for e in p] for p in self.projections
        ]

    @property
    def output_schema(self):
        return self._schema

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        for row in self.children[0].execute_rows_partition(index):
            for bound in self._bound:
                yield tuple(eval_row(b, row) for b in bound)


class CpuGenerateExec(CpuExpandExec):
    """explode(array(e1..eN)) over per-row expression lists — one output
    row per generator element (reference: GpuGenerateExec; with fixed-size
    generators the kernel is exactly the Expand pair-expansion, which is
    how the TPU side lowers it too)."""

    def __init__(self, conf: RapidsConf, generators, col_name: str,
                 with_pos: bool, child: CpuExec):
        self.generators = list(generators)
        self.col_name = col_name
        self.with_pos = with_pos
        child_cols = [E.col(f.name) for f in child.output_schema.fields]
        projections = [
            child_cols
            + ([E.Literal(i, T.INT)] if with_pos else [])
            + [g]
            for i, g in enumerate(self.generators)
        ]
        names = [f.name for f in child.output_schema.fields]
        if with_pos:
            names.append("pos")
        names.append(col_name)
        super().__init__(conf, projections, names, child)


# ---------------------------------------------------------------------------
# Aggregation (independent dict-based implementation)
# ---------------------------------------------------------------------------
_NAN_KEY = ("__nan__",)


def _group_key_part(v: Any) -> Any:
    if isinstance(v, float) and math.isnan(v):
        return _NAN_KEY
    if isinstance(v, float) and v == 0.0:
        return 0.0  # fold -0.0
    return v


class _AggState:
    """One accumulator per (function, group) with Spark null semantics."""

    __slots__ = ("kind", "sum", "count", "value", "seen", "ignore_nulls")

    def __init__(self, kind: str, ignore_nulls: bool = False):
        self.kind = kind
        self.sum = None
        self.count = 0
        self.value = None
        self.seen = False
        self.ignore_nulls = ignore_nulls

    def update(self, v: Any) -> None:
        k = self.kind
        if k == "count_star":
            self.count += 1
            return
        if k == "count":
            if v is not None:
                self.count += 1
            return
        if k in ("sum", "avg"):
            if v is not None:
                self.count += 1
                self.sum = v if self.sum is None else self.sum + v
            return
        if k in ("min", "max"):
            if v is None:
                return
            if self.value is None and not self.seen:
                self.value, self.seen = v, True
                return
            cur = self.value
            if isinstance(v, float):
                vn, cn = math.isnan(v), isinstance(cur, float) and math.isnan(cur)
                if k == "max":
                    take = vn and not cn or (not vn and not cn and v > cur)
                else:
                    take = cn and not vn or (not vn and not cn and v < cur)
            elif isinstance(v, str):
                take = (v.encode() > cur.encode()) if k == "max" else (v.encode() < cur.encode())
            else:
                take = (v > cur) if k == "max" else (v < cur)
            if take:
                self.value = v
            self.seen = True
            return
        if k == "first":
            if self.seen:
                return
            if v is None and self.ignore_nulls:
                return
            self.value, self.seen = v, True
            return
        if k == "last":
            if v is None and self.ignore_nulls:
                return
            self.value, self.seen = v, True
            return
        raise ValueError(k)

    def result(self, out_dtype: T.DataType) -> Any:
        k = self.kind
        if k in ("count", "count_star"):
            return self.count
        if k == "sum":
            if self.count == 0:
                return None
            if isinstance(out_dtype, T.DecimalType):
                from .interpreter import _dec_quantize
                import decimal as _dec

                return _dec_quantize(_dec.Decimal(self.sum), out_dtype)
            return float(self.sum) if out_dtype.is_floating else self.sum
        if k == "avg":
            if self.count == 0:
                return None
            if isinstance(out_dtype, T.DecimalType):
                from .interpreter import _dec_quantize
                import decimal as _dec

                with _dec.localcontext() as ctx:
                    ctx.prec = 50
                    v = _dec.Decimal(self.sum) / _dec.Decimal(self.count)
                return _dec_quantize(v, out_dtype)
            return float(self.sum) / self.count
        return self.value


_KIND_OF = {
    A.Count: "count", A.Sum: "sum", A.Min: "min", A.Max: "max",
    A.Average: "avg", A.First: "first", A.Last: "last",
}


class CpuHashAggregateExec(CpuExec):
    """Whole-input aggregation (single output partition, like a final agg)."""

    def __init__(self, conf: RapidsConf, group_exprs: Sequence[E.Expression],
                 agg_exprs: Sequence[A.AggregateExpression], child: CpuExec):
        super().__init__(conf, [child])
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        child_schema = child.output_schema
        self._bound_keys = [E.bind_references(g, child_schema) for g in self.group_exprs]
        import dataclasses as _dc

        self._bound_funcs = []
        for ae in self.agg_exprs:
            f = ae.func
            if f.input is not None:
                f = _dc.replace(f, child=E.bind_references(f.child, child_schema))
            self._bound_funcs.append(f)
        fields = []
        for i, g in enumerate(self.group_exprs):
            name = g.name if isinstance(g, (E.UnresolvedAttribute, E.Alias)) else f"key{i}"
            b = self._bound_keys[i]
            fields.append(StructField(name, b.dtype, b.nullable))
        for ae, f in zip(self.agg_exprs, self._bound_funcs):
            fields.append(StructField(ae.resolved_name(), f.dtype, True))
        self._schema = StructType(tuple(fields))

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return 1

    def describe(self):
        keys = ", ".join(str(k) for k in self.group_exprs)
        return f"CpuHashAggregateExec(keys=[{keys}])"

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        groups: Dict[tuple, Tuple[tuple, List[_AggState]]] = {}
        grouped = bool(self._bound_keys)

        def new_states() -> List[_AggState]:
            out = []
            for f in self._bound_funcs:
                kind = _KIND_OF[type(f)]
                if kind == "count" and f.input is None:
                    kind = "count_star"
                out.append(_AggState(kind, getattr(f, "ignore_nulls", False)))
            return out

        if not grouped:
            groups[()] = ((), new_states())
        for p in range(self.children[0].num_partitions):
            for row in self.children[0].execute_rows_partition(p):
                kvals = tuple(eval_row(b, row) for b in self._bound_keys)
                gk = tuple(_group_key_part(v) for v in kvals)
                if gk not in groups:
                    groups[gk] = (kvals, new_states())
                states = groups[gk][1]
                for f, st in zip(self._bound_funcs, states):
                    v = eval_row(f.child, row) if f.input is not None else None
                    st.update(v)
        for kvals, states in groups.values():
            res = tuple(
                st.result(f.dtype) for f, st in zip(self._bound_funcs, states)
            )
            yield kvals + res


# ---------------------------------------------------------------------------
# Sort (whole-input, single output partition)
# ---------------------------------------------------------------------------
class _SparkOrderKey:
    """Comparator key implementing Spark ordering for one value."""

    __slots__ = ("v", "asc", "nulls_first")

    def __init__(self, v, asc: bool, nulls_first: bool):
        self.v = v
        self.asc = asc
        self.nulls_first = nulls_first

    def _rank(self):
        if self.v is None:
            return 0 if self.nulls_first else 2
        return 1

    def __lt__(self, other: "_SparkOrderKey"):
        r1, r2 = self._rank(), other._rank()
        if r1 != r2:
            return r1 < r2
        if self.v is None:
            return False
        a, b = self.v, other.v
        if isinstance(a, float):
            an, bn = math.isnan(a), math.isnan(b)
            if an and bn:
                return False
            if an or bn:
                lt = bn  # NaN is largest
            else:
                lt = a < b
        elif isinstance(a, str):
            lt = a.encode() < b.encode()
        else:
            lt = a < b
        return lt if self.asc else (not lt and not _eq(a, b))

    def __eq__(self, other):
        r1, r2 = self._rank(), other._rank()
        if r1 != r2:
            return False
        if self.v is None:
            return True
        return _eq(self.v, other.v)


def _eq(a, b):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) and math.isnan(b):
            return True
        return a == b
    return a == b


class CpuSortExec(CpuExec):
    def __init__(self, conf: RapidsConf, sort_exprs: Sequence[E.Expression],
                 orders: Sequence[tuple], child: CpuExec):
        """``orders[i]`` = (ascending, nulls_first_or_None)."""
        super().__init__(conf, [child])
        self.sort_exprs = list(sort_exprs)
        self.orders = list(orders)
        self._bound = [E.bind_references(e, child.output_schema) for e in self.sort_exprs]

    @property
    def output_schema(self):
        return self.children[0].output_schema

    @property
    def num_partitions(self):
        return 1

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        rows = []
        for p in range(self.children[0].num_partitions):
            rows.extend(self.children[0].execute_rows_partition(p))

        def keyfn(row):
            out = []
            for b, (asc, nf) in zip(self._bound, self.orders):
                v = eval_row(b, row)
                out.append(_SparkOrderKey(v, asc, asc if nf is None else nf))
            return tuple(out)

        yield from sorted(rows, key=keyfn)


# ---------------------------------------------------------------------------
# Joins (nested loop oracle; all join types)
# ---------------------------------------------------------------------------
class CpuJoinExec(CpuExec):
    def __init__(self, conf: RapidsConf, left: CpuExec, right: CpuExec,
                 left_keys: Sequence[E.Expression], right_keys: Sequence[E.Expression],
                 join_type: str = "inner", condition: Optional[E.Expression] = None):
        super().__init__(conf, [left, right])
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.condition = condition
        self._bl = [E.bind_references(k, left.output_schema) for k in self.left_keys]
        self._br = [E.bind_references(k, right.output_schema) for k in self.right_keys]
        lf, rf = left.output_schema.fields, right.output_schema.fields
        if join_type in ("semi", "anti"):
            self._schema = StructType(tuple(lf))
        else:
            nullable_l = join_type in ("right", "full")
            nullable_r = join_type in ("left", "full")
            fields = [
                StructField(f.name, f.dataType, f.nullable or nullable_l) for f in lf
            ] + [
                StructField(f.name, f.dataType, f.nullable or nullable_r) for f in rf
            ]
            self._schema = StructType(tuple(fields))
        if condition is not None:
            comb = StructType(tuple(lf) + tuple(rf))
            self._cond = E.bind_references(condition, comb)
        else:
            self._cond = None

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return 1

    def describe(self):
        return f"CpuJoinExec({self.join_type})"

    def _keys_match(self, lrow, rrow) -> bool:
        for bl, br in zip(self._bl, self._br):
            lv, rv = eval_row(bl, lrow), eval_row(br, rrow)
            if lv is None or rv is None:
                return False  # SQL equi-join: null never matches
            if isinstance(lv, float) and isinstance(rv, float):
                if math.isnan(lv) and math.isnan(rv):
                    continue  # Spark joins NaN = NaN
                if lv != rv:
                    return False
            elif lv != rv:
                return False
        return True

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        left_rows = list(self.children[0].execute_rows())
        right_rows = list(self.children[1].execute_rows())
        nr = len(self.children[1].output_schema.fields)
        nl = len(self.children[0].output_schema.fields)
        jt = self.join_type
        right_matched = [False] * len(right_rows)
        for lrow in left_rows:
            matched = False
            for ri, rrow in enumerate(right_rows):
                if not self._keys_match(lrow, rrow):
                    continue
                if self._cond is not None and eval_row(self._cond, lrow + rrow) is not True:
                    continue
                matched = True
                right_matched[ri] = True
                if jt in ("inner", "left", "right", "full"):
                    yield lrow + rrow
                elif jt == "semi":
                    yield lrow
                    break
            if not matched:
                if jt in ("left", "full"):
                    yield lrow + (None,) * nr
                elif jt == "anti":
                    yield lrow
        if jt in ("right", "full"):
            for ri, rrow in enumerate(right_rows):
                if not right_matched[ri]:
                    yield (None,) * nl + rrow


# ---------------------------------------------------------------------------
# Window (whole-input, python oracle)
# ---------------------------------------------------------------------------
class CpuWindowExec(CpuExec):
    def __init__(self, conf: RapidsConf, window_exprs, child: CpuExec):
        super().__init__(conf, [child])
        from ..expr import windows as W

        self.window_exprs = list(window_exprs)
        self.spec = self.window_exprs[0].spec
        cs = child.output_schema
        self._part = [E.bind_references(k, cs) for k in self.spec.partition_by]
        self._order = [E.bind_references(k, cs) for k in self.spec.order_by]
        self._orders = list(self.spec.orders) or [(True, None)] * len(self._order)
        import dataclasses as _dc

        self._funcs = []
        fields = list(cs.fields)
        for we in self.window_exprs:
            f = we.func
            if getattr(f, "child", None) is not None:
                f = _dc.replace(f, child=E.bind_references(f.child, cs))
            self._funcs.append(f)
            fields.append(StructField(we.resolved_name(), f.dtype, True))
        self._schema = StructType(tuple(fields))

    @property
    def output_schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return 1

    def execute_rows_partition(self, index: int) -> Iterator[tuple]:
        from ..expr import windows as W

        rows = []
        for p in range(self.children[0].num_partitions):
            rows.extend(self.children[0].execute_rows_partition(p))

        def keyfn(row):
            out = [
                _SparkOrderKey(eval_row(b, row), True, True) for b in self._part
            ]
            for b, (asc, nf) in zip(self._order, self._orders):
                out.append(_SparkOrderKey(eval_row(b, row), asc, asc if nf is None else nf))
            return tuple(out)

        rows = sorted(rows, key=keyfn)

        def part_key(row):
            return tuple(_group_key_part(eval_row(b, row)) for b in self._part)

        def order_key(row):
            return tuple(_group_key_part(eval_row(b, row)) for b in self._order)

        frame = self.spec.resolved_frame()
        whole = frame.is_whole_partition or not self._order
        range_frame = frame.frame_type == W.RANGE

        # group into partitions
        partitions: List[List[tuple]] = []
        cur_key = object()
        for row in rows:
            k = part_key(row)
            if not partitions or k != cur_key:
                partitions.append([])
                cur_key = k
            partitions[-1].append(row)

        for part in partitions:
            n = len(part)
            okeys = [order_key(r) for r in part]
            for i, row in enumerate(part):
                extra = []
                for f in self._funcs:
                    extra.append(self._eval_func(
                        f, part, okeys, i, whole, range_frame))
                yield row + tuple(extra)

    def _frame_rows(self, part, okeys, i, whole, range_frame):
        from ..expr import windows as W

        frame = self.spec.resolved_frame()
        if not whole and not frame.is_running and frame.is_bounded_rows:
            lo, hi = frame.row_bounds()
            return range(max(i + lo, 0), min(i + hi, len(part) - 1) + 1)
        if (not whole and not frame.is_running
                and frame.frame_type == W.RANGE and frame.is_bounded_range
                and len(self._order) == 1):
            # literal RANGE frame: rows whose key value falls in
            # [key_i + lo, key_i + hi]; a null key's frame is all nulls
            lo, hi = frame.range_bounds()
            ki = eval_row(self._order[0], part[i])
            out = []
            for j, r in enumerate(part):
                kj = eval_row(self._order[0], r)
                if ki is None:
                    # bounded sides land on the null peer block (nulls are
                    # mutual peers); unbounded sides keep partition edges
                    if kj is None or (
                        (lo is None and j < i) or (hi is None and j > i)
                    ):
                        out.append(j)
                    continue
                if kj is None:
                    # a null row joins a NON-null row's frame only through
                    # an unbounded side reaching past it
                    nf = self._orders[0][1]
                    asc = self._orders[0][0]
                    nulls_first = asc if nf is None else nf
                    if (nulls_first and lo is None) or (
                            not nulls_first and hi is None):
                        out.append(j)
                    continue
                asc = self._orders[0][0]
                d = (kj - ki) if asc else (ki - kj)
                if (lo is None or d >= lo) and (hi is None or d <= hi):
                    out.append(j)
            return out
        if whole:
            return range(len(part))
        if range_frame:
            end = i
            while end + 1 < len(part) and okeys[end + 1] == okeys[i]:
                end += 1
            return range(0, end + 1)
        return range(0, i + 1)

    def _eval_func(self, f, part, okeys, i, whole, range_frame):
        from ..expr import windows as W

        if isinstance(f, W.RowNumber):
            return i + 1
        if isinstance(f, W.Rank):
            j = i
            while j > 0 and okeys[j - 1] == okeys[i]:
                j -= 1
            return j + 1
        if isinstance(f, W.DenseRank):
            seen = 1
            for j in range(1, i + 1):
                if okeys[j] != okeys[j - 1]:
                    seen += 1
            return seen
        if isinstance(f, (W.Lead, W.Lag)):
            off = f.offset if isinstance(f, W.Lead) else -f.offset
            t = i + off
            if 0 <= t < len(part):
                return eval_row(f.child, part[t])
            if f.default is not None:
                return eval_row(f.default, part[i])
            return None
        # aggregate over the frame
        st_kind = _KIND_OF[type(f)]
        if st_kind == "count" and f.input is None:
            st_kind = "count_star"
        st = _AggState(st_kind, getattr(f, "ignore_nulls", False))
        for j in self._frame_rows(part, okeys, i, whole, range_frame):
            v = eval_row(f.child, part[j]) if f.input is not None else None
            st.update(v)
        return st.result(f.dtype)
