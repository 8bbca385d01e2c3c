#!/usr/bin/env python3
"""Time the f32 attention routes on one GPU, for one source tree or two.

    python3 chip_flash_f32.py [--src DIR ...] [--check]

Run from the root of a checkout on an H100 (or another sm_90a card).  For
each package source tree given (default: this checkout's ``src``), in a
process of its own, it builds that tree's attention kernels, prints
ptxas's registers and spills for them, and prints ``chip_smoke.py``'s
``flash_f32_path_shape``, ``flash_bwd_f32_shape`` and
``decode_f32_path_shape`` records for it (``chip_smoke.measure_f32_routes``:
B=1, T=1024, H=16, Kv=2, dh 128, causal, f32; decode over a cache of 1088
at length 1025), each line tagged with the tree.  With two trees they run
in turns a, b, b, a, so that another tree (a parent commit unpacked by
``git archive`` into a directory under ``build/``, say) is timed on the
same card in the same call.  The card's name and power limit come first
and last.
With ``--check`` each tree first runs ``chip_smoke.phase_f32_flash`` (the
f32 route against its plain version at every pair of head dims).  Exits
non-zero without a card or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def worker(src: str, check: bool) -> int:
    """Build ``src``'s attention kernels, check them with ``check``, and
    print the three records."""
    sys.path.insert(0, src)
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    _build.build("flash_attention", "flash_attention_bwd", "decode_attention")
    spills = chip_smoke.ptxas_report(_build.build_logs)
    dev = torch.device("cuda", 0)
    if check:
        chip_smoke.phase_f32_flash(dev, 0, chip_smoke.AttnRecord("flash_attention"),
                                   chip_smoke.BwdRecord())
    fwd, bwd, decode = chip_smoke.measure_f32_routes(dev, 0)
    for phase, rec in (("flash_f32_path_shape", fwd), ("flash_bwd_f32_shape", bwd),
                       ("decode_f32_path_shape", decode)):
        print(json.dumps({"phase": phase, "tree": src, **rec}), flush=True)
    print(json.dumps({"phase": "spills", "tree": src,
                      "spilled": {f"{s}:{k[-60:]}": n for (s, k), n in spills.items()
                                  if n}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append",
                    help="a package source tree (default: this checkout's src)")
    ap.add_argument("--check", action="store_true",
                    help="hold the f32 route to its plain version first")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.check)
    import torch

    if not torch.cuda.is_available():
        print("chip_flash_f32: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    trees = [str(Path(s).resolve()) for s in (args.src or [str(ROOT / "src")])]
    order = trees if len(trees) == 1 else [trees[0], trees[1], trees[1], trees[0]]
    for src in order:
        done = subprocess.run([sys.executable, __file__, "--worker", src,
                               *(["--check"] if args.check else [])], cwd=ROOT,
                              timeout=900)
        if done.returncode:
            return done.returncode
    print(card, flush=True)  # again, after the records
    return 0


if __name__ == "__main__":
    sys.exit(main())
