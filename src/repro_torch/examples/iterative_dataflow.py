"""Iterative dataflow quickstart: PageRank, k-means, and TeraSort on the
stateful serverless substrate, through the declarative MarvelClient.

Runs each workload twice where it matters — loop state pinned in the
client's tiered stack fast level (and, for k-means, centroids hot in a
gateway session) versus the stock-serverless cold-reload path through the
modeled S3 device — and prints the per-iteration gap plus byte-identity
of the outputs.

The port of ``examples/iterative_dataflow.py``: host tiers only, as there.

    PYTHONPATH=src python -m repro_torch.examples.iterative_dataflow
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import numpy as np

from repro_torch.api import ClusterConfig, MarvelClient
from repro_torch.core.workloads import kmeans_points, pagerank_graph

__all__ = ["PINNED", "COLD", "per_iter", "main"]

#: pinned stateful stack: write-back DRAM front over the modeled S3 home.
PINNED = dict(tiers=("dram", "s3"))
#: stock serverless: every state op pays the modeled S3 device.
COLD = dict(tiers=("s3",), journal="none")


def per_iter(report):
    rows = [r for r in report.per_iteration if r["iteration"] >= 2]
    return sum(r["wall_s"] + r["modeled_s"] for r in rows) / max(1, len(rows))


def main(argv=None) -> Dict[str, Any]:
    """Run the three workloads; returns what their lines report.  It takes
    no options (``argv`` is parsed only to refuse one)."""
    argparse.ArgumentParser().parse_args(argv)
    # -- PageRank: pinned loop state vs S3 round-trips ------------------------
    src, dst = pagerank_graph(n_nodes=500, n_edges=3000, seed=1)
    with MarvelClient(ClusterConfig(name="ex-pr", **PINNED)) as client:
        hot = client.pagerank("ex-pr", src, dst, 500, tol=1e-6,
                              max_iterations=15)
    with MarvelClient(ClusterConfig(name="ex-prc", **COLD)) as client:
        cold = client.pagerank("ex-pr", src, dst, 500, tol=1e-6,
                               max_iterations=15, pin_state=False)
    identical = hot.result.rank_bytes == cold.result.rank_bytes
    print(f"pagerank: {hot.report.field('last_iteration')} iterations, "
          f"pinned {per_iter(hot.raw) * 1e3:.1f} ms/iter vs "
          f"cold-reload {per_iter(cold.raw) * 1e3:.1f} ms/iter, "
          f"outputs identical: {identical}")

    # -- k-means: centroids hot in a gateway session --------------------------
    pts, _ = kmeans_points(n_points=600, dim=4, k=5, seed=2)
    with MarvelClient(ClusterConfig(name="ex-km", **PINNED)) as client:
        warm = client.kmeans("ex-km", pts, 5, tol=1e-9, max_iterations=20)
    print(f"kmeans: converged={warm.report.converged} in "
          f"{warm.report.field('last_iteration')} iterations, "
          f"{warm.report.field('warm_read_frac'):.0%} of centroid reads "
          f"served from the warm session")

    # -- TeraSort: the 3-stage DAG --------------------------------------------
    rng = np.random.default_rng(3)
    parts = [
        b"\n".join(rng.bytes(10).hex().encode() for _ in range(250))
        for _ in range(4)
    ]
    with MarvelClient(ClusterConfig(name="ex-ts")) as client:
        ts = client.terasort("ex-ts", parts, n_ranges=4)
    ok = ts.result == sorted(r for p in parts for r in p.split(b"\n"))
    print(f"terasort: {ts.report.tasks} tasks over 3 stages in "
          f"{ts.report.wall_seconds * 1e3:.1f} ms, globally sorted: {ok}")
    return {"pagerank_identical": identical,
            "pagerank_iterations": hot.report.field("last_iteration"),
            "rank_bytes": hot.result.rank_bytes,
            "kmeans_converged": warm.report.converged,
            "kmeans_iterations": warm.report.field("last_iteration"),
            "warm_read_frac": warm.report.field("warm_read_frac"),
            "terasort_tasks": ts.report.tasks, "globally_sorted": ok}


if __name__ == "__main__":
    main()
