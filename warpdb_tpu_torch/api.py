"""Public facade of the port — the ``WarpDB`` class.

Counterpart of ``warpdb_tpu/api.py:120-477`` for the port's slice:
``query`` / ``query_np`` (fused filter + projection) and ``query_sql``
(SELECT with JOINs over registered tables, WHERE, GROUP BY, aggregates,
HAVING, DISTINCT, ORDER BY, LIMIT / OFFSET).  The device is explicit:
``device=None`` means ``"cuda"``, and a missing CUDA device is an error,
never a silent run on the CPU.  ``device="cpu"`` runs the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

import re
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
        name = ast.from_source or ast.from_table
        if name not in catalog and catalog.strict:
            raise ValidationError(f"Unknown table: {name}")
        return catalog.get(name, self._table)

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

    def _validate_sql(self, ast, table, catalog) -> None:
        """Clause validation against the FROM and JOIN relations'
        columns (``run_query`` checks the relations themselves)."""
        table_names = {self._name, ast.from_table, *catalog.keys()}
        table_names |= {j.table for j in ast.joins}
        validate_query(ast, set(table.dtypes.keys())
                       | self._join_columns(ast, catalog), table_names)

    def query_sql(self, sql: str) -> list:
        """Run one SELECT (joins included); returns the first select
        item's values (strings decoded)."""
        from .engine.executor import (
            _resolve_alias_catalog,
            expand_stars_query,
            reject_unsupported,
            run_query,
        )

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
        base = self._base_table(ast, self._catalog)
        catalog = _resolve_alias_catalog(ast, base, self._catalog)
        self._validate_sql(ast, base, catalog)
        result = run_query(ast, base, catalog)
        first = expand_stars_query(ast, base, catalog)[0]
        return decode_result_column(first, result, base, catalog, ast.joins)

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
