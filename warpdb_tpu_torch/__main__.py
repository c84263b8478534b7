"""CLI: ``python -m warpdb_tpu_torch "<expr|SQL>" [data_file]``.

Counterpart of ``warpdb_tpu/__main__.py``: one query argument (an
expression with an optional WHERE, or a SELECT statement), an optional
data file defaulting to ``data/test.csv``, and ``Result[i] = v`` output
lines.  ``--device`` picks the device (the card unless ``--device cpu``);
``--profile DIR`` writes a ``torch.profiler`` Chrome trace.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="warpdb_tpu_torch",
        description="Columnar SQL query engine on a CUDA card (PyTorch)",
    )
    parser.add_argument(
        "query", nargs="?", default=None,
        help='e.g. "price * quantity WHERE price > 10" or a SELECT '
             'statement; omit with --repl',
    )
    parser.add_argument("data_file", nargs="?", default="data/test.csv")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; cpu runs the "
                             "kernels' plain PyTorch versions)")
    parser.add_argument("--limit-print", type=int, default=20,
                        help="max result rows to print")
    parser.add_argument("--sharded", action="store_true",
                        help="execute across all local devices")
    parser.add_argument("--profile", metavar="DIR", default=None,
                        help="write a torch.profiler trace to DIR")
    parser.add_argument("--demo", action="store_true",
                        help="run the demo pipeline before the query")
    parser.add_argument("--explain", action="store_true",
                        help="print the physical plan instead of executing")
    parser.add_argument("--analyze", action="store_true",
                        help="with --explain: also execute and append the "
                             "measured profile (EXPLAIN ANALYZE)")
    parser.add_argument("--repl", action="store_true",
                        help="interactive SQL shell over the data file")
    parser.add_argument("--serve", metavar="PORT", type=int, default=None,
                        help="serve the data file over HTTP/JSON "
                             "(POST /query, GET /healthz, /schema)")
    args = parser.parse_args(argv)
    if ((args.repl or args.serve is not None) and args.query is not None
            and args.data_file == parser.get_default("data_file")):
        # ``--serve 8080 data.csv``: a lone positional is the data file
        # (the reference reads it as the query and serves data/test.csv).
        args.data_file = args.query

    from .api import WarpDB

    if args.repl:
        return _repl(args.data_file, args.device)
    if args.serve is not None:
        from .serve import serve

        serve(WarpDB(args.data_file, device=args.device), port=args.serve)
        return 0
    if args.query is None:
        parser.error("a query is required unless --repl or --serve is given")

    if args.explain:
        db = WarpDB(args.data_file, device=args.device)
        print(db.explain(args.query, analyze=args.analyze))
        return 0

    if args.demo:
        _run_demo(args.data_file, args.device)

    t0 = time.perf_counter()
    db = WarpDB(args.data_file, device=args.device)
    t_load = time.perf_counter() - t0
    print(f"Loaded {db.num_rows} rows from {args.data_file} "
          f"({', '.join(db.column_names)}) in {t_load*1e3:.1f} ms")

    profile_ctx = None
    if args.profile:
        from .utils.metrics import profile_trace

        profile_ctx = profile_trace(args.profile)
        profile_ctx.__enter__()

    t1 = time.perf_counter()
    is_sql = args.query.strip().upper().startswith(("SELECT", "WITH"))
    try:
        if is_sql:
            result = db.query_sql(args.query)
        elif args.sharded:
            result = db.query_sharded(args.query)
        else:
            result = db.query(args.query)
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)
    t_query = time.perf_counter() - t1

    for i, v in enumerate(result[: args.limit_print]):
        print(f"Result[{i}] = {v}")
    if len(result) > args.limit_print:
        print(f"... ({len(result)} rows total)")
    print(f"Query executed in {t_query*1e3:.2f} ms "
          f"({db.num_rows / max(t_query, 1e-9):,.0f} rows/s incl. compile)")
    return 0


def _repl(data_file: str, device=None) -> int:
    """Interactive SQL shell: statements run through the table API and
    print aligned columns; ``.tables`` lists the relations, ``.schema``
    the columns, ``.explain <sql>`` the plan, ``.load name path``
    registers another table for JOINs, ``.quit`` exits."""
    try:
        import readline  # noqa: F401  (line editing + history)
    except ImportError:
        pass

    from .api import WarpDB

    t0 = time.perf_counter()
    db = WarpDB(data_file, device=device)
    print(
        f"warpdb_tpu_torch — {db.num_rows} rows from {data_file} "
        f"({', '.join(db.column_names)}) on {db.device} in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms.  "
        f'Try: SELECT * FROM {db.table_name} LIMIT 5;  (.help for commands)'
    )
    extra_tables: list[str] = []
    while True:
        try:
            line = input("warpdb> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        if line.startswith("."):
            cmd, *rest = line.split()
            if cmd in (".quit", ".exit"):
                return 0
            if cmd == ".help":
                print(".tables  .schema  .explain <sql>  "
                      ".load <name> <path>  .quit")
            elif cmd == ".tables":
                print("  ".join([db.table_name, *extra_tables]))
            elif cmd == ".schema":
                for name in db.column_names:
                    dt = db.table.dtypes.get(name)
                    print(f"  {name}  {getattr(dt, 'name', dt)}")
            elif cmd == ".explain":
                try:
                    print(db.explain(line[len(".explain"):].strip()))
                except Exception as e:  # keep the shell alive
                    print(f"error: {e}")
            elif cmd == ".load" and len(rest) == 2:
                try:
                    db.register_table(rest[0], rest[1])
                    extra_tables.append(rest[0])
                    print(f"registered {rest[0]}")
                except Exception as e:
                    print(f"error: {e}")
            else:
                print(f"unknown command: {line} (.help)")
            continue
        sql = line.rstrip(";")
        t0 = time.perf_counter()
        try:
            out = db.query_sql_table(sql)
        except Exception as e:
            print(f"error: {e}")
            continue
        dt = time.perf_counter() - t0
        names = list(out.keys())
        cols = [list(c) for c in out.values()]
        n = len(cols[0]) if cols else 0
        show = min(n, 40)
        cells = [
            [(f"{x:.6g}" if not isinstance(x, str) else x) for x in c[:show]]
            for c in cols
        ]
        widths = [
            max(len(nm), *(len(x) for x in col)) if col else len(nm)
            for nm, col in zip(names, cells)
        ]
        print("  ".join(nm.ljust(w) for nm, w in zip(names, widths)))
        print("  ".join("-" * w for w in widths))
        for i in range(show):
            print("  ".join(c[i].ljust(w) for c, w in zip(cells, widths)))
        tail = f" … ({n} rows)" if n > show else f"({n} rows)"
        print(f"{tail}  {dt * 1e3:.1f} ms")


def _run_demo(data_file: str, device=None) -> None:
    """The demo pipeline: print rows, a filter count, revenue projections
    (single and dual output), the sharded run over every device of the
    facade's type, and the streamed run on the same device."""
    from .api import WarpDB

    db = WarpDB(data_file, device=device)
    cols = db.column_names
    print(f"=== demo: {db.num_rows} rows, columns {cols} ===")
    table = db._host
    for i in range(min(db.num_rows, 5)):
        fields = ", ".join(f"{c.name}={c.data[i]}" for c in table.columns)
        print(f"Row {i}: {fields}")

    if "price" in cols:
        res = db.query_np("price WHERE price > 25")
        print(f"Filtered rows (price > 25.0): {int((res != 0).sum())}")

    if "price" in cols and "quantity" in cols:
        revenue = db.query("price * quantity")
        adjusted = db.query("price * quantity * 0.9")
        for i in range(min(len(revenue), 5)):
            print(f"Revenue[{i}] = {revenue[i]}  Adjusted[{i}] = {adjusted[i]}")
        sharded = db.query_sharded("price * quantity")
        print(f"Sharded result rows: {len(sharded)}")
        if str(data_file).endswith(".csv"):
            streamed = WarpDB.query_streaming_csv(
                data_file, "price * quantity", rows_per_chunk=1024,
                device=db.device)
            print(f"Streamed result rows: {len(streamed)}")
    print("=== demo done ===")


if __name__ == "__main__":
    sys.exit(main())
