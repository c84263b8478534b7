"""Minimal HTTP query server (serving layer).

Counterpart of ``warpdb_tpu/serve.py``.  ``python -m warpdb_tpu_torch
--serve 8080 data.csv`` exposes one facade over plain HTTP/JSON, with no
dependency beyond the standard library, so the process that holds the
card can back dashboards, notebooks or sidecar services.

Endpoints
---------
* ``GET  /healthz``  → ``{"ok": true, "table": ..., "rows": N}``
* ``GET  /schema``   → ``{"table": ..., "columns": {name: dtype}}``
* ``POST /query``    body ``{"sql": "SELECT ..."}`` →
  ``{"columns": {name: [values]}, "rows": N, "elapsed_ms": T}``
  (NaN serialises as null — valid JSON)
* ``POST /explain``  body ``{"sql": ...}`` → ``{"plan": "..."}``

Queries execute through :meth:`WarpDB.query_sql_table`, so the full SQL
surface (joins, windows, QUALIFY, grouping sets, DDL …) is served.  A
``ThreadingHTTPServer`` runs each request on its own thread over the one
facade: the parser is reentrant, device tables are immutable, the plan
cache and the per-table memos (joins, pushdown filters, eager rewrites,
subqueries, CTEs) are LRUs behind one lock (``engine.compiler.memo_get``
/ ``memo_put``), and torch orders the threads' launches on the card's
stream.  Errors return HTTP 400 with ``{"error": <type>, "message":
...}``; engine failures never take the server down.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .errors import WarpDBError

__all__ = ["QueryServer", "serve"]

_MAX_BODY = 1 << 20  # 1 MiB of SQL is plenty


def _jsonable(values):
    out = []
    for v in values:
        if isinstance(v, str):
            out.append(v)
            continue
        f = float(v)
        out.append(None if math.isnan(f) or math.isinf(f) else f)
    return out


class QueryServer:
    """Threaded HTTP server bound to one :class:`WarpDB` engine."""

    def __init__(self, db, host: str = "127.0.0.1", port: int = 0):
        self.db = db
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # Quiet: no per-request stderr lines.
            def log_message(self, fmt, *args):  # noqa: D401
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload, allow_nan=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _read_sql(self):
                n = int(self.headers.get("Content-Length") or 0)
                if n <= 0 or n > _MAX_BODY:
                    self._send(400, {"error": "BadRequest",
                                     "message": "missing or oversized body"})
                    return None
                try:
                    req = json.loads(self.rfile.read(n))
                    sql = req["sql"]
                except (ValueError, KeyError, TypeError):
                    self._send(400, {"error": "BadRequest",
                                     "message": 'body must be {"sql": ...}'})
                    return None
                if not isinstance(sql, str):
                    self._send(400, {"error": "BadRequest",
                                     "message": "sql must be a string"})
                    return None
                return sql

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {
                        "ok": True,
                        "table": outer.db.table_name,
                        "rows": outer.db.num_rows,
                    })
                elif self.path == "/schema":
                    self._send(200, {
                        "table": outer.db.table_name,
                        "columns": {
                            name: getattr(dt, "name", str(dt))
                            for name, dt in outer.db.table.dtypes.items()
                        },
                    })
                else:
                    self._send(404, {"error": "NotFound",
                                     "message": self.path})

            def do_POST(self):
                sql = self._read_sql()
                if sql is None:
                    return
                if self.path == "/query":
                    t0 = time.perf_counter()
                    try:
                        out = outer.db.query_sql_table(sql)
                    except WarpDBError as e:
                        self._send(400, {"error": type(e).__name__,
                                         "message": str(e)})
                        return
                    except Exception as e:  # engine bug: report, stay up
                        self._send(500, {"error": type(e).__name__,
                                         "message": str(e)})
                        return
                    cols = {k: _jsonable(v) for k, v in out.items()}
                    n = len(next(iter(cols.values()), []))
                    self._send(200, {
                        "columns": cols,
                        "rows": n,
                        "elapsed_ms": round(
                            (time.perf_counter() - t0) * 1e3, 3
                        ),
                    })
                elif self.path == "/explain":
                    try:
                        plan = outer.db.explain(sql)
                    except WarpDBError as e:
                        self._send(400, {"error": type(e).__name__,
                                         "message": str(e)})
                        return
                    self._send(200, {"plan": plan})
                else:
                    self._send(404, {"error": "NotFound",
                                     "message": self.path})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    def start(self) -> "QueryServer":
        """Serve on a daemon thread; returns self (port is bound)."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def serve(db, host: str = "127.0.0.1", port: int = 8080) -> None:
    """Blocking entry point used by the CLI ``--serve``."""
    srv = QueryServer(db, host, port)
    print(
        f"warpdb_tpu_torch serving {db.table_name} ({db.num_rows} rows, "
        f"{db.device}) "
        f"on http://{srv.host}:{srv.port}  "
        "(POST /query {\"sql\": ...}, GET /healthz, /schema)"
    )
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
