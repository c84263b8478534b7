"""Public facade of the port — the ``WarpDB`` class.

Counterpart of ``warpdb_tpu/api.py``: ``query`` / ``query_np`` (fused
filter + projection), ``query_sql`` (the first select item) and
``query_sql_table`` (every select item, by name): SELECT with JOINs over
registered tables, subqueries, derived tables, WHERE, GROUP BY,
aggregates, HAVING, DISTINCT, ORDER BY, LIMIT / OFFSET, plus what
resolves here: ``WITH`` (CTEs), UNION / EXCEPT / INTERSECT [ALL] and
CREATE / DROP TABLE|VIEW.  ``explain`` describes the plan (and with
``analyze`` runs it); ``query_arrow*`` and ``query_record_batch`` export
results through the Arrow C Data Interface; ``query_streaming_csv`` and
``query_streaming_sql`` stream files larger than the card in chunks.
Each query records its metrics (``utils/metrics.py``).  The device is
explicit: ``device=None`` means ``"cuda"``, and a missing CUDA device is
an error, never a silent run on the CPU.  ``device="cpu"`` runs the
kernels' plain PyTorch versions.

With a ``mesh`` (``parallel.mesh.DataMesh``: ``WarpDB(src, mesh=…)``,
``distribute``, ``from_device_table``) every relation of the facade is
row-sharded over it and queries run distributed (``parallel/``);
``query_sharded`` evaluates an expression over a mesh.
"""

from __future__ import annotations

import copy
import re
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from .errors import (
    ExecutionError,
    ParseError,
    TokenizeError,
    UnsupportedError,
    ValidationError,
    WarpDBError,
)
from .frontend import (
    parse_expression,
    parse_query,
    tokenize,
    validate_expression,
    validate_query,
)
from .frontend.ast import Star, unalias
from .storage import DataType, HostTable, load_table
from .storage.table import DeviceTable

__all__ = ["WarpDB", "resolve_device", "decode_result_column"]

_WHERE_SPLIT = re.compile(r"\bWHERE\b", re.IGNORECASE)
_DDL_CREATE = re.compile(
    r"^\s*CREATE\s+(TABLE|VIEW)\s+([A-Za-z_]\w*)\s+AS\s+(.+)$",
    re.IGNORECASE | re.DOTALL,
)
_DDL_DROP = re.compile(
    r"^\s*DROP\s+(TABLE|VIEW)\s+(IF\s+EXISTS\s+)?([A-Za-z_]\w*)\s*;?\s*$",
    re.IGNORECASE,
)


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


def _result_vocab(item, table, catalog, joins):
    """``(node, vocab)``: the select item with a MIN/MAX unwrapped, and
    the vocabulary its codes decode through when it is code-valued — a
    bare coded column, MIN/MAX of one, or a string scalar function — else
    None (a number column)."""
    from .frontend.ast import (
        Aggregation,
        AggregationType,
        CodeMap,
        FunctionCall,
        Variable,
    )
    from .storage.strfuncs import is_string_func
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
            return node, None
        return node, (cm.out_vocab if isinstance(cm, CodeMap) else None)
    if isinstance(node, Variable):
        return node, _column_vocab(node, table, catalog or {}, joins)
    return node, None


def _is_string_item(item, table, catalog, joins) -> bool:
    """Whether a select item's result column holds strings: STRING_AGG,
    or an item that decodes through a string vocabulary."""
    from .frontend.ast import Aggregation, AggregationType

    node = unalias(item)
    if (isinstance(node, Aggregation)
            and node.agg is AggregationType.STRING_AGG):
        return True
    _node, vocab = _result_vocab(item, table, catalog, joins)
    return vocab is not None and vocab.dtype.kind not in "iu"


def decode_result_column(item, values: np.ndarray, table, catalog=None,
                         joins=()) -> list:
    """Decode dictionary codes back to strings (or wide ints) when the
    select item is code-valued: a bare coded column, MIN/MAX of one, or a
    string scalar function; other columns pass through as numbers.
    ``table`` is the FROM relation; ``catalog`` and ``joins`` (the
    statement's JOIN clauses) resolve columns of joined relations."""
    from .frontend.ast import Variable
    from .storage.strings import decode_codes

    node, vocab = _result_vocab(item, table, catalog, joins)
    if vocab is None:
        return np.asarray(values).tolist()
    vals = np.asarray(values)
    if not isinstance(node, Variable):
        vals = np.asarray(values, np.float64)
        vals = np.where(np.isfinite(vals), vals, -1.0)
    elif vals.dtype.kind == "f" and not np.all(np.isfinite(vals)):
        return vals.tolist()  # empty-aggregate sentinels
    return decode_codes(vals, vocab)


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
                 schema: Optional[Sequence[DataType]] = None, device=None,
                 mesh=None):
        if device is None and mesh is not None:
            device = mesh.devices[0]
        self._device = resolve_device(device)
        self._mesh = mesh
        if isinstance(filepath_or_table, HostTable):
            self._host = filepath_or_table
            self._name = "table"
        elif type(filepath_or_table).__module__.startswith("pyarrow"):
            from .storage.arrow import host_table_from_arrow

            self._host = host_table_from_arrow(filepath_or_table)
            self._name = "table"
        else:
            self._host = load_table(str(filepath_or_table), schema)
            base = str(filepath_or_table).rsplit("/", 1)[-1]
            self._name = base.rsplit(".", 1)[0] or "table"
        self._table = self._upload(self._host)
        self._catalog = Catalog({self._name: self._table, "t": self._table})

    def _upload(self, host: HostTable):
        """``host`` on this facade's device, or sharded over its mesh."""
        if self._mesh is not None:
            from .parallel.sharded import shard_table

            return shard_table(host, self._mesh)
        return DeviceTable.from_host(host, device=self._device)

    @classmethod
    def from_device_table(cls, table, mesh=None,
                          name: str = "table") -> "WarpDB":
        """Wrap an assembled table (a DeviceTable, or a ShardedTable such
        as ``parallel.multihost.make_global_table`` builds) under
        ``name``; with ``mesh`` it is re-laid over it where it is not
        sharded there already."""
        if mesh is None:
            mesh = getattr(table, "mesh", None)
        elif getattr(table, "mesh", None) != mesh:
            from .parallel.sharded import _ensure_sharded

            table = _ensure_sharded(table, mesh)
        db = cls.__new__(cls)
        db._host = table.host
        db._name = name
        db._mesh = mesh
        db._device = table.device
        db._table = table
        db._catalog = Catalog({name: table, "t": table})
        return db

    def distribute(self, mesh=None) -> "WarpDB":
        """Re-lay the table row-sharded over ``mesh`` (None: every device
        of the facade's type, all CUDA devices or one CPU shard), and the
        registered tables with it; later queries run distributed."""
        from .parallel.sharded import _ensure_sharded

        self._mesh = mesh if mesh is not None else self._default_mesh()
        old = self._table
        self._table = (self._upload(self._host) if self._host is not None
                       else _ensure_sharded(old, self._mesh))
        for name, t in list(self._catalog.items()):
            self._catalog[name] = (self._table if t is old
                                   else _ensure_sharded(t, self._mesh))
        return self

    def _default_mesh(self):
        from .parallel.mesh import DataMesh, data_mesh

        if self._device.type == "cpu":
            return DataMesh([self._device])
        return data_mesh()

    @property
    def mesh(self):
        return self._mesh

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
        if isinstance(source, HostTable) or not hasattr(source, "dtypes"):
            host = source if isinstance(source, HostTable) else load_table(
                str(source), schema
            )
            self._catalog[name] = self._upload(host)
        elif self._mesh is not None:
            from .parallel.sharded import _ensure_sharded

            self._catalog[name] = _ensure_sharded(source, self._mesh)
        else:
            self._catalog[name] = source
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

    def _bytes_scanned(self, *asts, table=None) -> int:
        """Bytes of the (padded) columns the given ASTs reference."""
        from .frontend import column_refs

        table = self._table if table is None else table
        names = set()
        for ast in asts:
            if ast is not None:
                for ref in column_refs(ast):
                    names.update((ref.name, ref.unqualified))
        parts = getattr(table, "shards", [table])
        return sum(t.element_size() * t.shape[0]
                   for p in parts
                   for name, t in p.columns.items() if name in names)

    def query(self, expr: str) -> list:
        """Evaluate ``"<expr> [WHERE <cond>]"`` → length-N list of
        float32 (rows failing the filter give 0.0)."""
        return self.query_np(expr).tolist()

    def query_np(self, expr: str) -> np.ndarray:
        """Like :meth:`query`, returning the NumPy array."""
        from .engine.executor import run_expression
        from .utils.metrics import timed_query

        expr_ast, cond_ast = self._parse_expr_query(expr)
        with timed_query(expr, "expression", self._table.num_rows,
                         self._bytes_scanned(expr_ast, cond_ast),
                         self.device) as out_rows:
            result = run_expression(self._table, expr_ast, cond_ast)
            out_rows[0] = len(result)
        return result

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
        """Parse, resolve the CTEs and validate.  Returns ``(ast without
        its CTEs, catalog)``."""
        try:
            ast = parse_query(tokenize(sql))
        except (ParseError, TokenizeError) as e:
            raise ParseError(f"Failed to parse SQL: {e}") from None
        catalog = self._resolve_ctes(ast)
        self._validate_sql(ast, catalog)
        if ast.ctes:
            ast = copy.copy(ast)
            ast.ctes = []  # resolved into ``catalog``
        return ast, catalog

    def _decoded_columns(self, ast, base, catalog, result: dict,
                         string_names: Optional[set] = None) -> dict:
        """``{name: list}`` of a result, strings decoded through the
        statement's namespace.  ``string_names``, when given, gains the
        names of the columns that hold strings (an empty one too)."""
        from .engine.executor import _resolve_alias_catalog, expand_stars_query

        dbase = self._decode_base(ast, base, catalog)
        catalog = _resolve_alias_catalog(ast, dbase, catalog)
        items = expand_stars_query(ast, dbase, catalog)
        out = {}
        for item, (name, vals) in zip(items, result.items()):
            out[name] = decode_result_column(item, vals, dbase, catalog,
                                             ast.joins)
            if string_names is not None and _is_string_item(
                    item, dbase, catalog, ast.joins):
                string_names.add(name)
        return out

    def _sql_bytes_scanned(self, ast, base) -> int:
        return self._bytes_scanned(
            *ast.select_list, ast.where, ast.having,
            *(t.expr for t in (ast.order_by.terms if ast.order_by else ())),
            *(ast.group_by.keys if ast.group_by else ()),
            table=base,
        )

    def query_sql(self, sql: str) -> list:
        """Run one SELECT statement; returns the first select item's
        values (strings decoded).  A CREATE / DROP statement returns
        ``[]``."""
        from .engine.executor import run_query
        from .utils.metrics import timed_query

        if self._maybe_ddl(sql) is not None:
            return []
        ast, catalog = self._prepare_sql(sql)
        if ast.set_ops:
            with timed_query(sql, "sql", self._table.num_rows, 0,
                             self.device) as out_rows:
                out = list(next(iter(self._setop_table(ast, catalog)
                                     .values()), []))
                out_rows[0] = len(out)
            return out
        base = self._base_table(ast, catalog)
        with timed_query(sql, "sql", base.num_rows,
                         self._sql_bytes_scanned(ast, base),
                         self.device) as out_rows:
            result = run_query(ast, base, catalog)
            out_rows[0] = len(result)
        first = {"": result}
        return next(iter(self._decoded_columns(ast, base, catalog,
                                               first).values()))

    def query_sql_table(self, sql: str) -> dict:
        """Run one SELECT statement; returns every select item as a named
        column, ``{name: list}`` (strings decoded).  A CREATE / DROP
        statement returns ``{}``."""
        return self._query_sql_table(sql)

    def _query_sql_table(self, sql: str,
                         string_names: Optional[set] = None) -> dict:
        """:meth:`query_sql_table`; ``string_names`` as in
        :meth:`_decoded_columns`."""
        from .engine.executor import run_query_table
        from .utils.metrics import timed_query

        ddl = self._maybe_ddl(sql)
        if ddl is not None:
            return ddl
        ast, catalog = self._prepare_sql(sql)
        if ast.set_ops:
            with timed_query(sql, "sql", self._table.num_rows, 0,
                             self.device) as out_rows:
                out = self._setop_table(ast, catalog)
                out_rows[0] = len(next(iter(out.values()), []))
            return out
        base = self._base_table(ast, catalog)
        with timed_query(sql, "sql", base.num_rows,
                         self._sql_bytes_scanned(ast, base),
                         self.device) as out_rows:
            result = run_query_table(ast, base, catalog)
            out_rows[0] = len(next(iter(result.values()), []))
        return self._decoded_columns(ast, base, catalog, result,
                                     string_names)

    def _maybe_ddl(self, sql: str):
        """``CREATE TABLE|VIEW <name> AS <select>`` and ``DROP TABLE|VIEW
        [IF EXISTS] <name>``.  Tables are immutable, so a VIEW is
        materialised like a TABLE: the body runs through the whole facade
        (CTEs, set operations, windows…) and lands on this facade's
        device under ``name``.  Returns ``{}`` for DDL, else None."""
        m = _DDL_CREATE.match(sql)
        if m is not None:
            name = m.group(2)
            if name == self._name:
                raise ValidationError(
                    f"Cannot CREATE over the base relation: {name}"
                )
            out = self.query_sql_table(m.group(3))
            arrays = {
                col: np.asarray(vals, dtype=object
                                if any(isinstance(x, str) for x in vals)
                                else np.float32)
                for col, vals in out.items()
            }
            self.register_table(name, HostTable.from_dict(arrays))
            return {}
        m = _DDL_DROP.match(sql)
        if m is not None:
            name = m.group(3)
            if name in self._catalog:
                del self._catalog[name]
            elif not m.group(2):
                raise ValidationError(f"Unknown table: {name}")
            return {}
        return None

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
        return self._upload(HostTable.from_dict(arrays, dtypes=dtypes or None))

    # -- EXPLAIN ------------------------------------------------------------
    def explain(self, query: str, analyze: bool = False) -> str:
        """The physical plan of a SQL statement or an ``"<expr> [WHERE
        cond]"`` expression.  ``analyze=True`` also runs the query and
        appends what was measured: wall time, rows, and the operators it
        ran (EXPLAIN ANALYZE)."""
        from .engine.explain import explain_expression, explain_query

        if query.strip().upper().startswith(("SELECT", "WITH")):
            ast, catalog = self._prepare_sql(query)
            full = parse_query(tokenize(query))
            plan = explain_query(ast, self._base_table(ast, catalog), catalog,
                                 title=full)
            if full.ctes:
                names = ", ".join(n for n, _q in full.ctes)
                plan += (f"\n  ctes: {names} (materialised once per "
                         "statement; memoised on immutable inputs)")
            if ast.set_ops:
                ops = " ".join(op for op, _a, _b in ast.set_ops)
                plan += (f"\n  set-ops: {len(ast.set_ops) + 1} branches "
                         f"({ops}; plan above is the first; host-side "
                         "O(result) merge; INTERSECT binds tighter)")
            if analyze:
                # Every select item runs, so the tier is the plan's (the
                # first-item ``query_sql`` may take a cheaper one).
                plan += "\n" + self._analyze(
                    lambda: self.query_sql_table(query))
            return plan
        expr_ast, cond_ast = self._parse_expr_query(query)
        plan = explain_expression(self._table, expr_ast, cond_ast)
        if analyze:
            plan += "\n" + self._analyze(lambda: self.query(query))
        return plan

    def _analyze(self, run) -> str:
        """Run ``run`` and render its recorded metrics as the EXPLAIN
        ANALYZE trailer."""
        from .utils.metrics import last

        result = run()
        m = last()
        lines = ["Execution (measured):"]
        if m is None:
            lines.append(f"  rows returned: {len(result)}")
            return "\n".join(lines)
        lines.append(
            f"  wall: {m.wall_s * 1e3:.2f} ms  "
            f"({m.rows_per_s / 1e6:.1f} M rows/s, {m.gb_per_s:.2f} GB/s)")
        lines.append(f"  rows: {m.rows} scanned -> {m.output_rows} returned")
        if m.operators:
            ops = ", ".join(f"{name}{'' if hit else ' [compiled]'}"
                            for name, hit in m.operators)
            lines.append(f"  operators: {ops}")
        if m.collectives:
            cs = ", ".join(f"{op} {nbytes / 1024:.1f} KiB/device"
                           for op, nbytes in m.collectives)
            lines.append(f"  collectives: {cs}")
        return "\n".join(lines)

    # -- Arrow interchange ----------------------------------------------------
    def query_arrow(self, expr: str, shared_memory: bool = False):
        """:meth:`query_np`'s result through the Arrow C Data Interface:
        ``(array_capsule, schema_capsule)`` for
        ``pyarrow.Array._import_from_c``.  No Python list is built.  With
        ``shared_memory=True`` the buffer lives in a POSIX shared-memory
        segment of its own for another process to map; its file is
        ``arrow_export.shared_memory_path(array_capsule)``."""
        from .interchange.arrow_export import export_to_arrow_capsules

        return export_to_arrow_capsules(self.query_np(expr),
                                        use_shared_memory=shared_memory)

    def query_arrow_table(self, sql: str):
        """:meth:`query_sql_table`'s columns as one Arrow struct array
        (``(array_capsule, schema_capsule)``, for
        ``pa.RecordBatch.from_struct_array``): string columns export as
        utf8, the rest as float32.  A column is a string column when the
        statement decodes it through a string vocabulary (or it is
        STRING_AGG), so an empty one is utf8 too.  (The reference types
        columns by the primary table's dictionaries alone, and fails on a
        string column of any other relation.)"""
        from .interchange.arrow_export import export_table_to_arrow_capsules

        typed: set = set()
        out = self._query_sql_table(sql, typed)
        columns = {}
        for name, vals in out.items():
            if name in typed or any(isinstance(v, str) for v in vals):
                columns[name] = [str(v) for v in vals]
            else:
                columns[name] = np.asarray(vals, dtype=np.float32)
        return export_table_to_arrow_capsules(columns)

    def query_record_batch(self, sql: str):
        """:meth:`query_arrow_table` as a ``pyarrow.RecordBatch`` (imports
        pyarrow when called)."""
        import pyarrow as pa

        arr_c, schema_c = self.query_arrow_table(sql)
        struct = pa.Array._import_from_c(_capsule_address(arr_c),
                                         _capsule_address(schema_c))
        return pa.RecordBatch.from_struct_array(struct)

    def query_arrow_array(self, expr: str):
        """:meth:`query_arrow` as a ``pyarrow.Array`` (imports pyarrow
        when called)."""
        import pyarrow as pa

        arr_c, schema_c = self.query_arrow(expr)
        return pa.Array._import_from_c(_capsule_address(arr_c),
                                       _capsule_address(schema_c))

    def __repr__(self) -> str:
        return f"WarpDB({self._name!r}, {self._table!r})"

    # -- out-of-core streaming ------------------------------------------------
    @staticmethod
    def query_streaming_csv(csv_path: str, expr: str,
                            rows_per_chunk: Optional[int] = None, mesh=None,
                            device=None) -> list:
        """Stream a file in chunks of ``rows_per_chunk`` rows (default
        ``config.rows_per_chunk``), evaluating ``"<expr> [WHERE <cond>]"``
        on each chunk on ``device`` (None: the card), or sharded over
        ``mesh``; one f32 value a row, in row order."""
        from .parallel.streaming import run_streaming_csv

        return run_streaming_csv(csv_path, expr, rows_per_chunk, mesh=mesh,
                                 device=device).tolist()

    # The reference's name (warpdb.cpp:544-590).
    query_multi_gpu_csv = query_streaming_csv

    @staticmethod
    def query_streaming_sql(csv_path: str, sql: str,
                            rows_per_chunk: Optional[int] = None, mesh=None,
                            dims: Optional[dict] = None,
                            schema: Optional[Sequence[DataType]] = None,
                            device=None) -> dict:
        """Out-of-core SQL: per-chunk aggregation on ``device`` (None:
        the card), or sharded over ``mesh``, merged on the host, and
        per-row statements, DISTINCT,
        COUNT(DISTINCT), APPROX_COUNT_DISTINCT and partition-aggregate
        windows, over files larger than device memory.  ``dims`` maps
        table names to in-memory ``HostTable`` dimension tables that the
        streamed chunks JOIN.  Returns ``{column: list}`` like
        :meth:`query_sql_table`."""
        from .parallel.streaming import run_streaming_sql

        return run_streaming_sql(csv_path, sql, rows_per_chunk, mesh=mesh,
                                 schema=schema, dims=dims, device=device)

    # -- multi-device ----------------------------------------------------------
    def query_sharded(self, expr: str, mesh=None) -> list:
        """Evaluate ``"<expr> [WHERE <cond>]"`` over ``mesh`` (None: the
        facade's mesh, else every device of its type); the table is
        re-laid there if it is not sharded over it.  A one-device mesh
        runs the single-device path (reference ``query_multi_gpu``)."""
        from .parallel.sharded import run_expression_sharded
        from .utils.metrics import timed_query

        expr_ast, cond_ast = self._parse_expr_query(expr)
        if mesh is None:
            mesh = self._mesh if self._mesh is not None \
                else self._default_mesh()
        with timed_query(expr, "expression", self._table.num_rows,
                         self._bytes_scanned(expr_ast, cond_ast),
                         mesh.root) as out_rows:
            result = run_expression_sharded(self._table, expr_ast, cond_ast,
                                            mesh=mesh)
            out_rows[0] = len(result)
        return result.tolist()

    # The reference's name (warpdb.cpp:508-542).
    query_multi_gpu = query_sharded


def _capsule_address(capsule) -> int:
    """The pointer a PyCapsule holds."""
    from .interchange.arrow_export import capsule_address

    return capsule_address(capsule)
