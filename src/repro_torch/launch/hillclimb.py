"""§Perf hillclimb driver: run (arch, shape, variant) cells through the
dry run and append the roofline records to
``results/perf_iterations_torch.json``.

The port of ``repro/launch/hillclimb.py``, with its own record file, so
the two packages' records never mix.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb [--device cpu] qwen1.5-32b:prefill_32k:pad-heads ...
"""

from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.launch.dryrun import run_cell

__all__ = ["OUT_PATH", "main"]

OUT_PATH = "results/perf_iterations_torch.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("specs", nargs="*", help="arch:shape[:variant]")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    try:
        with open(OUT_PATH) as f:
            records = json.load(f)
    except (OSError, ValueError):
        records = []
    for spec in args.specs:
        arch, shape, *rest = spec.split(":")
        variant = rest[0] if rest else ""
        try:
            rec = run_cell(arch, shape, multi_pod=False, variant=variant,
                           device=args.device)
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "variant": variant,
                   "status": "error", "error": repr(e),
                   "trace": traceback.format_exc()[-1500:]}
            print("ERROR", spec, repr(e)[:200], flush=True)
        records.append(rec)
        os.makedirs(os.path.dirname(OUT_PATH), exist_ok=True)
        with open(OUT_PATH, "w") as f:
            json.dump(records, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
