"""Public facade of the port — the ``WarpDB`` class.

Counterpart of ``warpdb_tpu/api.py`` for the port's slice: ``query`` /
``query_np`` (fused filter + projection), ``query_sql`` (the first
select item) and ``query_sql_table`` (every select item, by name): SELECT
with JOINs over registered tables, subqueries, derived tables, WHERE,
GROUP BY, aggregates, HAVING, DISTINCT, ORDER BY, LIMIT / OFFSET, plus
the two features that resolve here, ``WITH`` (CTEs) and UNION / EXCEPT /
INTERSECT [ALL].  The device is explicit: ``device=None`` means
``"cuda"``, and a missing CUDA device is an error, never a silent run on
the CPU.  ``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import copy
import re
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from warpdb_tpu.errors import (
    ExecutionError,
    ParseError,
    TokenizeError,
    UnsupportedError,
    ValidationError,
    WarpDBError,
)
from warpdb_tpu.frontend import (
    parse_expression,
    parse_query,
    tokenize,
    validate_expression,
    validate_query,
)
from warpdb_tpu.frontend.ast import Star, unalias
from warpdb_tpu.storage import DataType, HostTable, load_table

from .storage.table import DeviceTable

__all__ = ["WarpDB", "resolve_device", "decode_result_column"]

_WHERE_SPLIT = re.compile(r"\bWHERE\b", re.IGNORECASE)
_DDL = re.compile(r"^\s*(CREATE|DROP)\b", re.IGNORECASE)


def resolve_device(device) -> torch.device:
    """``None`` → ``cuda``; a CUDA device must be present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ExecutionError(
                "warpdb_tpu_torch: CUDA is not available (device="
                f"{device!r}); pass device='cpu' explicitly to run the "
                "plain PyTorch versions on the CPU"
            )
    elif dev.type != "cpu":
        raise UnsupportedError(f"warpdb_tpu_torch: unsupported device {dev}")
    return dev


def _split_where(expr: str) -> tuple[str, Optional[str]]:
    """Split ``"<expr> WHERE <cond>"`` on a word-bounded WHERE."""
    m = _WHERE_SPLIT.search(expr)
    if m is None:
        return expr, None
    return expr[: m.start()], expr[m.end():]


def _column_vocab(node, table, catalog, joins):
    """The vocabulary of a column reference in the joined namespace: a
    qualifier naming a joined relation reads that relation's dictionary;
    otherwise the FROM relation's, then the joined relations' in join
    order (how the join resolves unqualified names).  The reference
    decodes only against the FROM relation's dictionaries, so it returns
    raw codes for an unqualified build-side string column and decodes a
    qualified one through a same-named probe column's vocabulary."""
    # A relation missing from the catalog is the FROM table itself, as
    # in the join (the reference's demo semantics).
    joined = [catalog.get(j.table, table) for j in joins]
    names = [j.table for j in joins]
    if node.qualifier is not None and node.qualifier in names:
        t = joined[names.index(node.qualifier)]
        return t.dicts.get(node.unqualified)
    vocab = table.dicts.get(node.name)
    if vocab is None:
        vocab = table.dicts.get(node.unqualified)
    if vocab is None and node.unqualified not in table.dtypes:
        for t in joined:
            if node.unqualified in t.dtypes:
                return t.dicts.get(node.unqualified)
    return vocab


def decode_result_column(item, values: np.ndarray, table, catalog=None,
                         joins=()) -> list:
    """Decode dictionary codes back to strings (or wide ints) when the
    select item is code-valued: a bare coded column, MIN/MAX of one, or a
    string scalar function; other columns pass through as numbers.
    ``table`` is the FROM relation; ``catalog`` and ``joins`` (the
    statement's JOIN clauses) resolve columns of joined relations."""
    from warpdb_tpu.frontend.ast import (
        Aggregation,
        AggregationType,
        CodeMap,
        FunctionCall,
        Variable,
        unalias,
    )
    from warpdb_tpu.storage.strfuncs import is_string_func
    from warpdb_tpu.storage.strings import decode_codes

    from .engine.executor import bind_strings

    node = unalias(item)
    if isinstance(node, Aggregation) and node.agg in (
        AggregationType.MIN, AggregationType.MAX,
    ):
        node = node.expr
    if isinstance(node, FunctionCall) and is_string_func(node.name):
        try:
            cm = bind_strings(node, table)
        except WarpDBError:
            cm = None
        if isinstance(cm, CodeMap) and cm.out_vocab is not None:
            vals = np.asarray(values, np.float64)
            vals = np.where(np.isfinite(vals), vals, -1.0)
            return decode_codes(vals, cm.out_vocab)
    if isinstance(node, Variable):
        vals = np.asarray(values)
        if vals.dtype.kind == "f" and not np.all(np.isfinite(vals)):
            return vals.tolist()  # empty-aggregate sentinels
        vocab = _column_vocab(node, table, catalog or {}, joins)
        if vocab is not None:
            return decode_codes(vals, vocab)
    return np.asarray(values).tolist()


class Catalog(dict):
    """Relation-name catalog: name -> DeviceTable.  ``strict`` flips on
    when a table is registered: unknown FROM names then raise."""

    strict = False


class WarpDB:
    """A columnar table on a CUDA device (or the CPU, for tests),
    queryable with expressions or SQL.

    Example::

        db = WarpDB("data/test.csv")              # device=None → cuda
        db.query("price * quantity WHERE price > 10")
        db.query_sql("SELECT SUM(price) FROM test GROUP BY quantity")
    """

    def __init__(self, filepath_or_table,
                 schema: Optional[Sequence[DataType]] = None, device=None):
        self._device = resolve_device(device)
        if isinstance(filepath_or_table, HostTable):
            self._host = filepath_or_table
            self._name = "table"
        elif type(filepath_or_table).__module__.startswith("pyarrow"):
            from warpdb_tpu.storage.arrow import host_table_from_arrow

            self._host = host_table_from_arrow(filepath_or_table)
            self._name = "table"
        else:
            self._host = load_table(str(filepath_or_table), schema)
            base = str(filepath_or_table).rsplit("/", 1)[-1]
            self._name = base.rsplit(".", 1)[0] or "table"
        self._table = DeviceTable.from_host(self._host, device=self._device)
        self._catalog = Catalog({self._name: self._table, "t": self._table})

    # -- introspection -----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def num_rows(self) -> int:
        return self._table.num_rows

    @property
    def column_names(self) -> list[str]:
        return list(self._table.dtypes.keys())

    @property
    def table(self) -> DeviceTable:
        return self._table

    @property
    def table_name(self) -> str:
        return self._name

    @property
    def stats(self) -> dict:
        return self._table.stats

    def register_table(self, name: str, source, schema=None) -> None:
        """Register another table under ``name`` for FROM and JOIN."""
        if isinstance(source, DeviceTable):
            self._catalog[name] = source
        else:
            host = source if isinstance(source, HostTable) else load_table(
                str(source), schema
            )
            self._catalog[name] = DeviceTable.from_host(host,
                                                        device=self._device)
        self._catalog.strict = True

    # -- expression path ---------------------------------------------------
    def _parse_expr_query(self, expr: str):
        if not expr or not expr.strip():
            raise WarpDBError("Empty query expression")
        expr_part, where_part = _split_where(expr)
        try:
            expr_ast = parse_expression(tokenize(expr_part))
        except (ParseError, TokenizeError) as e:
            raise ParseError(f"Failed to parse expression: {e}") from None
        cols = set(self._table.dtypes.keys())
        validate_expression(expr_ast, cols, {self._name})
        cond_ast = None
        if where_part is not None and where_part.strip():
            try:
                cond_ast = parse_expression(tokenize(where_part))
            except (ParseError, TokenizeError) as e:
                raise ParseError(f"Failed to parse WHERE clause: {e}") from None
            validate_expression(cond_ast, cols, {self._name})
        return expr_ast, cond_ast

    def query(self, expr: str) -> list:
        """Evaluate ``"<expr> [WHERE <cond>]"`` → length-N list of
        float32 (rows failing the filter give 0.0)."""
        return self.query_np(expr).tolist()

    def query_np(self, expr: str) -> np.ndarray:
        """Like :meth:`query`, returning the NumPy array."""
        from .engine.executor import run_expression

        expr_ast, cond_ast = self._parse_expr_query(expr)
        return run_expression(self._table, expr_ast, cond_ast)

    # -- SQL path ----------------------------------------------------------
    def _base_table(self, ast, catalog):
        """The FROM relation through the catalog; a derived table's
        ``from_table`` is its alias, never a catalog name."""
        from .engine.executor import _is_strict

        if ast.from_subquery is not None:
            return self._table
        name = ast.from_source or ast.from_table
        if name not in catalog and _is_strict(catalog):
            raise ValidationError(f"Unknown table: {name}")
        return catalog.get(name, self._table)

    def _decode_base(self, ast, base, catalog):
        """The relation result decoding reads vocabularies from: the
        derived table when the FROM is a subquery (a memo hit after the
        run), else the FROM relation."""
        from .engine.subquery import decode_table

        return decode_table(ast, base, catalog)

    def _join_columns(self, ast, catalog) -> set:
        """Column names the JOIN relations add, bare and qualified."""
        out: set = set()
        for j in ast.joins:
            t = catalog.get(j.source or j.table)
            if t is None and j.source is not None:
                t = catalog.get(j.table)
            names = (t if t is not None else self._table).dtypes.keys()
            if t is not None:
                out |= set(names)
            out |= {f"{j.table}.{c}" for c in names}
        return out

    def _validate_sql(self, ast, catalog) -> None:
        """Relation and clause validation.  A derived table validates its
        inner query against its own FROM and the outer query against the
        inner's output names; each set-op branch validates against its
        own relations (the chain's trailing ORDER BY names output
        columns and is checked when the chain runs)."""
        from .engine.executor import _validate_relations, result_column_names

        _validate_relations(ast, catalog)
        sub = ast.from_subquery
        if sub is None:
            cols = set(self._base_table(ast, catalog).dtypes)
        else:
            self._validate_sql(sub, catalog)
            if any(isinstance(unalias(x), Star) for x in sub.select_list):
                cols = set(self._base_table(sub, catalog).dtypes)
            else:
                cols = set(result_column_names(sub.select_list))
        table_names = {self._name, ast.from_table, *catalog.keys()}
        table_names |= {j.table for j in ast.joins}
        validate_query(ast, cols | self._join_columns(ast, catalog),
                       table_names)
        for i, (_op, _all, branch) in enumerate(ast.set_ops):
            if i == len(ast.set_ops) - 1 and branch.order_by is not None:
                branch = copy.copy(branch)
                branch.order_by = None
            self._validate_sql(branch, catalog)

    def _resolve_ctes(self, ast, catalog=None):
        """Materialise the statement's ``WITH`` CTEs into an extended
        per-statement catalog, in order (later CTEs and the main query
        see earlier ones as table names; a body may carry its own WITH
        or be a set-operation chain).  Memoised on this facade by name,
        output names and ``query_dep_key``."""
        from .engine.executor import _is_strict, result_column_names
        from .engine.subquery import (
            _memoised,
            materialize_query_table,
            query_dep_key,
        )

        catalog = self._catalog if catalog is None else catalog
        if not ast.ctes:
            return catalog
        strict = _is_strict(catalog)
        catalog = Catalog(catalog)
        catalog.strict = strict
        for name, q in ast.ctes:
            inner = self._resolve_ctes(q, catalog)  # a nested WITH
            if q.ctes:
                q = copy.copy(q)
                q.ctes = []
            self._validate_sql(q, inner)
            base = self._base_table(q, inner)
            # canonical() drops aliases; the CTE's schema is alias-named.
            mkey = (name, tuple(result_column_names(q.select_list))) + \
                query_dep_key(q, base, inner)
            catalog[name] = _memoised(
                self, mkey,
                lambda q=q, base=base, inner=inner: (
                    self._setop_device_table(q, inner) if q.set_ops
                    else materialize_query_table(q, base, inner)),
                attr="_cte_memo", entries=8,
            )
        return catalog

    def _prepare_sql(self, sql: str):
        """Parse, reject what the port does not run, resolve the CTEs and
        validate.  Returns ``(ast without its CTEs, catalog)``."""
        from .engine.executor import reject_unsupported

        if _DDL.match(sql):
            raise UnsupportedError(
                "CREATE/DROP TABLE|VIEW is not supported by "
                "warpdb_tpu_torch yet"
            )
        try:
            ast = parse_query(tokenize(sql))
        except (ParseError, TokenizeError) as e:
            raise ParseError(f"Failed to parse SQL: {e}") from None
        reject_unsupported(ast)
        catalog = self._resolve_ctes(ast)
        self._validate_sql(ast, catalog)
        if ast.ctes:
            ast = copy.copy(ast)
            ast.ctes = []  # resolved into ``catalog``
        return ast, catalog

    def _decoded_columns(self, ast, base, catalog, result: dict) -> dict:
        """``{name: list}`` of a result, strings decoded through the
        statement's namespace."""
        from .engine.executor import _resolve_alias_catalog, expand_stars_query

        dbase = self._decode_base(ast, base, catalog)
        catalog = _resolve_alias_catalog(ast, dbase, catalog)
        items = expand_stars_query(ast, dbase, catalog)
        return {
            name: decode_result_column(item, vals, dbase, catalog, ast.joins)
            for item, (name, vals) in zip(items, result.items())
        }

    def query_sql(self, sql: str) -> list:
        """Run one SELECT statement; returns the first select item's
        values (strings decoded)."""
        from .engine.executor import run_query

        ast, catalog = self._prepare_sql(sql)
        if ast.set_ops:
            return list(next(iter(self._setop_table(ast, catalog).values()),
                             []))
        base = self._base_table(ast, catalog)
        result = run_query(ast, base, catalog)
        first = {"": result}
        return next(iter(self._decoded_columns(ast, base, catalog,
                                               first).values()))

    def query_sql_table(self, sql: str) -> dict:
        """Run one SELECT statement; returns every select item as a named
        column, ``{name: list}`` (strings decoded)."""
        from .engine.executor import run_query_table

        ast, catalog = self._prepare_sql(sql)
        if ast.set_ops:
            return self._setop_table(ast, catalog)
        base = self._base_table(ast, catalog)
        result = run_query_table(ast, base, catalog)
        return self._decoded_columns(ast, base, catalog, result)

    def _setop_table(self, ast, catalog) -> dict:
        """A ``UNION / EXCEPT / INTERSECT [ALL]`` chain: each branch runs
        through the engine against its own relations, and the decoded
        rows merge on the host (O(result)).  INTERSECT binds tighter
        than UNION / EXCEPT, which chain left to right; distinct variants
        deduplicate (first occurrence wins, NaNs equal), ALL variants
        keep multiplicities (EXCEPT ALL subtracts, INTERSECT ALL keeps
        the minimum).  The final branch's ORDER BY / LIMIT / OFFSET apply
        to the whole result; ORDER BY names output columns, NaNs last
        when ascending."""
        from .engine.executor import result_column_name, run_query_table

        branches = [("UNION", False, ast)] + list(ast.set_ops)
        parts: list = []
        names: Optional[list] = None
        order_by = limit = offset = None
        for i, (_op, _flag, q) in enumerate(branches):
            qq = copy.copy(q)
            qq.set_ops = []
            qq.ctes = []
            if i == len(branches) - 1:
                order_by, limit, offset = qq.order_by, qq.limit, qq.offset
                qq.order_by = qq.limit = qq.offset = None
            base = self._base_table(qq, catalog)
            res = run_query_table(qq, base, catalog)
            cols = list(self._decoded_columns(qq, base, catalog,
                                              res).values())
            if names is None:
                names = list(res.keys())
            elif len(cols) != len(names):
                raise ValidationError(
                    "UNION/EXCEPT/INTERSECT branches must select the same "
                    "number of columns"
                )
            parts.append(list(zip(*cols)) if cols else [])

        def key(row):
            return tuple("\0nan" if isinstance(v, float) and v != v else v
                         for v in row)

        def dedup(rows):
            seen: set = set()
            out = []
            for r in rows:
                if key(r) not in seen:
                    seen.add(key(r))
                    out.append(r)
            return out

        def bag(left, right, keep: bool):
            """EXCEPT ALL (``keep`` False) / INTERSECT ALL (True)."""
            budget = Counter(key(r) for r in right)
            out = []
            for r in left:
                hit = budget[key(r)] > 0
                if hit:
                    budget[key(r)] -= 1
                if hit == keep:
                    out.append(r)
            return out

        def combine(op, all_flag, left, right):
            if op == "UNION":
                return left + right if all_flag else dedup(left + right)
            if all_flag:
                return bag(left, right, op == "INTERSECT")
            other = {key(r) for r in right}
            keep = op == "INTERSECT"
            return [r for r in dedup(left) if (key(r) in other) == keep]

        # INTERSECT folds into the segment on its left; the segments then
        # chain left to right.
        segments: list = []
        for (op, all_flag, _q), rows in zip(branches, parts):
            if op == "INTERSECT" and segments:
                prev_op, prev_all, prev_rows = segments[-1]
                segments[-1] = (prev_op, prev_all,
                                combine(op, all_flag, prev_rows, rows))
            else:
                segments.append((op, all_flag, rows))
        acc = segments[0][2]
        for op, all_flag, rows in segments[1:]:
            acc = combine(op, all_flag, acc, rows)

        if order_by is not None:
            keys = []
            for term in order_by.terms:
                name = result_column_name(term.expr, 0, ())
                if name not in names:
                    raise UnsupportedError(
                        "Set-operation ORDER BY must reference an output "
                        f"column (got {name})"
                    )
                keys.append((names.index(name), term.ascending))
            for idx, asc in reversed(keys):
                acc = sorted(
                    acc, reverse=not asc,
                    key=lambda row, i=idx: (1, 0.0) if (
                        isinstance(row[i], float) and row[i] != row[i]
                    ) else (0, row[i]),
                )
        if offset:
            acc = acc[offset:]
        if limit is not None:
            acc = acc[:limit]
        return {nm: [row[i] for row in acc] for i, nm in enumerate(names)}

    def _setop_device_table(self, ast, catalog) -> DeviceTable:
        """A set-operation chain's result as a DeviceTable on this
        facade's device (a CTE body); strings re-encode with a fresh
        vocabulary."""
        arrays: dict = {}
        dtypes: dict = {}
        for name, vals in self._setop_table(ast, catalog).items():
            if any(isinstance(v, str) for v in vals):
                arrays[name] = np.asarray(list(vals), dtype=object)
                dtypes[name] = DataType.STRING
            else:
                arrays[name] = np.asarray(list(vals), np.float32)
        return DeviceTable.from_host(
            HostTable.from_dict(arrays, dtypes=dtypes or None),
            device=self._device,
        )

    # -- entry points outside the slice -------------------------------------
    def query_sharded(self, *args, **kwargs):
        raise UnsupportedError(
            "Multi-device execution (mesh) is not supported by "
            "warpdb_tpu_torch yet"
        )

    @staticmethod
    def query_streaming_csv(*args, **kwargs):
        raise UnsupportedError(
            "Streaming (out-of-core) execution is not supported by "
            "warpdb_tpu_torch yet"
        )

    query_streaming_sql = query_streaming_csv
