"""An n-shard dry run of the distributed path, checked against NumPy.

Counterpart of the reference's ``dryrun_multichip``: the row-sharded
scan, the distributed GROUP BY (all_gather merge), the SQL shuffle join
followed by the distributed GROUP BY, and the distributed window, over
an ``n_shards``-wide mesh of ``device`` (default: the card; ``"cpu"``
for a CPU mesh)::

    python -m warpdb_tpu_torch.parallel.dryrun 8 cpu
"""

from __future__ import annotations

import sys

import numpy as np

__all__ = ["dryrun_multichip"]


def dryrun_multichip(n_shards: int, device=None) -> dict:
    """Run the four steps on ``n_shards`` shards of ``device``; raises
    on a wrong answer, returns what each step produced."""
    from ..api import WarpDB, resolve_device
    from ..frontend import parse_expression, tokenize
    from ..storage import HostTable
    from .mesh import data_mesh
    from .sharded import run_expression_sharded, run_grouped_sharded, \
        shard_table

    mesh = data_mesh(devices=[resolve_device(device)] * n_shards)
    rows = 256 * n_shards
    rng = np.random.default_rng(0)
    price = rng.uniform(0, 100, rows).astype(np.float32)
    quantity = rng.integers(0, 16, rows).astype(np.float32)
    host = HostTable.from_dict({"price": price, "quantity": quantity})
    table = shard_table(host, mesh)

    def expr(text):
        return parse_expression(tokenize(text))

    # 1. The row-sharded fused scan: no collective but the gather of the
    #    result in row order.
    cond = expr("price > 15")
    out = run_expression_sharded(table, expr("price * quantity"), cond,
                                 mesh=mesh)
    keep = price > np.float32(15)
    np.testing.assert_array_equal(out, np.where(keep, price * quantity, 0))

    # 2. The distributed GROUP BY: per-shard partials, all_gather merge.
    gp = run_grouped_sharded([expr("quantity")], [expr("price * quantity")],
                             cond, table, mesh=mesh)
    want_counts = np.bincount(quantity[keep].astype(np.int64), minlength=16)
    np.testing.assert_array_equal(gp.counts.cpu().numpy(),
                                  want_counts[want_counts > 0])

    # 3. The SQL shuffle join, then the distributed GROUP BY.
    db = WarpDB(host, mesh=mesh)
    rate = rng.uniform(0, 1, 16).astype(np.float32)
    db.register_table("rates", HostTable.from_dict({
        "quantity": np.arange(16, dtype=np.float32), "rate": rate}))
    joined = np.asarray(db.query_sql(
        "SELECT SUM(price * rates.rate) FROM t JOIN rates ON quantity = "
        "rates.quantity GROUP BY quantity ORDER BY quantity ASC"))
    qi = quantity.astype(np.int64)
    want = np.bincount(qi, weights=price.astype(np.float64) * rate[qi],
                       minlength=16)
    np.testing.assert_allclose(joined, want[np.bincount(qi, minlength=16)
                                            > 0], rtol=1e-5)

    # 4. The distributed window: per-shard slot tables, one psum.
    win = np.asarray(db.query_sql(
        "SELECT SUM(price) OVER (PARTITION BY quantity) FROM t "
        "WHERE price > 15"))
    sums = np.bincount(qi[keep], weights=price[keep].astype(np.float64),
                       minlength=16)
    np.testing.assert_allclose(win, sums[qi[keep]], rtol=1e-5)
    return {"shards": n_shards, "rows": rows, "groups": gp.num_groups,
            "matching_rows": int(keep.sum()), "joined_groups": len(joined),
            "window_rows": len(win)}


if __name__ == "__main__":
    res = dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                           sys.argv[2] if len(sys.argv) > 2 else None)
    print(f"dryrun_multichip OK: {res}")
