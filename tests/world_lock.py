"""One multi-process test world on the host at a time, held to a budget of
CPU time rather than of wall time.

The subprocess-world test modules (``test_torch_sharded_train``,
``_sharded_mixers``, ``_sharded_serve``, ``_dryrun`` and
``_distributed``) start, from a module fixture, a reference side and a
port side that each run several processes.  Under pytest-xdist the other
workers' tests share the same cores, so a side's wall time says more
about their load than about its own work: a side that takes 50 s alone
has taken 240 s beside them.

:func:`run_sides` takes an exclusive ``fcntl.flock`` on one file in the
system temp directory, starts the sides, and releases the lock when they
have ended: at most one world runs on the host at a time, whichever xdist
worker holds the lock.  Each side is then held to what its own processes
do, read from ``/proc``: the CPU seconds of every process of its session
and of the children they have reaped.  A side fails when

* it has used more than its CPU limit (it loops or does far more work
  than it should);
* its CPU time has not grown by ``STALL_CPU_S`` in ``STALL_S`` seconds
  (it waits on something that will not come: a hang uses no CPU, while a
  side that other processes crowd out still gets its share);
* it has run ``WALL_PER_CPU_S`` times its CPU limit in wall seconds, the
  last guard: a side at its CPU limit that got half a core on average.
  The guard is derived from the CPU limit so that no side that stays
  within that limit can reach it however slowly it is given the cores;
  it is there for a side that waits while polling hard enough to pass
  the stall rule, which the two rules above do not catch;
* it exits non-zero.

A failing side is killed with every process it started, and fails the
fixture with its name, its CPU and wall seconds against the limits and
the last lines of its log.  Every run writes its sides' CPU and wall
seconds to ``out/sides.json``.
"""

from __future__ import annotations

import fcntl
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

LOCK_PATH = Path(tempfile.gettempdir()) / "repro_test_worlds.lock"
#: the longest wait for the lock: about twice what the five worlds took one
#: after another on two loaded cores (576 s)
WAIT_S = 1200.0
#: a side whose CPU time grows by less than STALL_CPU_S in STALL_S seconds hangs
STALL_S = 120.0
STALL_CPU_S = 1.0
#: the longest a side may run, in wall seconds for each CPU second of its limit
WALL_PER_CPU_S = 2.0
TAIL_LINES = 40
_TICK = os.sysconf("SC_CLK_TCK")


class WorldFailed(AssertionError):
    """A side of a test world failed, hung or outgrew its limits."""


def _tail(path: Path) -> str:
    with open(path, errors="replace") as f:
        return "".join(f.readlines()[-TAIL_LINES:])


def _acquire(fd: int, wait: float) -> float:
    """Take the lock on ``fd`` within ``wait`` seconds; returns the wait."""
    t0 = time.monotonic()
    while True:
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return time.monotonic() - t0
        except BlockingIOError:
            if time.monotonic() - t0 > wait:
                raise WorldFailed(
                    f"waited {wait:.0f} s for the world lock {LOCK_PATH} and "
                    "another test's world still held it") from None
            time.sleep(0.2)


def _session_cpu(sids) -> Dict[int, float]:
    """CPU seconds (user and system) of every live process of each session
    in ``sids``, with the children each has reaped.  Parents are read
    before their children (pids ascending), so a child reaped during the
    read is missed once rather than counted twice."""
    cpu = dict.fromkeys(sids, 0)
    for pid in sorted(int(p) for p in os.listdir("/proc") if p.isdigit()):
        try:
            with open(f"/proc/{pid}/stat") as f:
                stat = f.read()
        except OSError:  # ended meanwhile
            continue
        # after "pid (comm) ": state ppid pgrp session ... utime stime cutime cstime
        fields = stat[stat.rindex(")") + 2:].split()
        sid = int(fields[3])
        if sid in cpu:
            cpu[sid] += sum(int(x) for x in fields[11:15])
    return {sid: ticks / _TICK for sid, ticks in cpu.items()}


def run_sides(script: Path, out: Path, sides: Sequence[Tuple[str, dict]],
              cpu_limit: float, wait: float = WAIT_S) -> Dict[str, str]:
    """``python script SIDE out`` for every ``(SIDE, env)`` of ``sides``,
    all at once, each in a fresh session with its output in
    ``out/SIDE.log``, while holding the world lock.  Each side may use
    ``cpu_limit`` CPU seconds over all its processes and run
    ``WALL_PER_CPU_S * cpu_limit`` seconds (see the module's docstring for
    the other limits).  Returns each side's log; raises
    :class:`WorldFailed` naming every side that failed (the others are
    killed once one has failed)."""
    wall_limit = WALL_PER_CPU_S * cpu_limit
    fd = os.open(LOCK_PATH, os.O_RDWR | os.O_CREAT, 0o666)
    procs: Dict[str, subprocess.Popen] = {}
    ended: Dict[str, float] = {}
    failed: Dict[str, str] = {}
    cpu: Dict[str, float] = {}
    try:
        waited = _acquire(fd, wait)
        t0 = time.monotonic()
        for side, env in sides:
            with open(out / f"{side}.log", "w") as log:
                procs[side] = subprocess.Popen(
                    [sys.executable, str(script), side, str(out)],
                    env={**env, "PYTHONUNBUFFERED": "1"},  # a killed side's log is whole
                    stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        cpu = dict.fromkeys(procs, 0.0)
        mark = {side: (t0, 0.0) for side in procs}  # (when, CPU) of the last STALL_CPU_S
        next_read = t0
        while len(ended) < len(procs) and not failed:
            time.sleep(0.1)
            now = time.monotonic()
            running = [side for side in procs if side not in ended]
            if now >= next_read:
                next_read = now + 1.0
                seen = _session_cpu(procs[side].pid for side in running)
                for side in running:
                    cpu[side] = seen[procs[side].pid]
            for side in running:
                proc = procs[side]
                if proc.poll() is not None:
                    ended[side] = now - t0
                    if proc.returncode:
                        failed[side] = f"exited with {proc.returncode}"
                    continue
                if cpu[side] >= mark[side][1] + STALL_CPU_S:
                    mark[side] = (now, cpu[side])
                if cpu[side] > cpu_limit:
                    failed[side] = "used more CPU than its limit"
                elif now - mark[side][0] > STALL_S:
                    failed[side] = (f"hung (its CPU time grew by {cpu[side] - mark[side][1]:.1f}"
                                    f" s in the last {now - mark[side][0]:.0f} s)")
                elif now - t0 > wall_limit:
                    failed[side] = "outlived the wall guard"
                if side in failed:
                    ended[side] = now - t0
    finally:
        for proc in procs.values():  # every session whole, what its side left too
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        os.close(fd)  # releases the lock
    usage = {side: {"cpu_s": round(cpu[side], 1), "wall_s": round(ended[side], 1),
                    "lock_wait_s": round(waited, 1)} for side in ended}
    (out / "sides.json").write_text(json.dumps(usage, indent=1) + "\n")
    if failed:
        raise WorldFailed(f"{script.name}:\n" + "\n".join(
            f"{side} side {how}: {cpu[side]:.1f} CPU s (limit {cpu_limit:.0f}) in "
            f"{ended[side]:.1f} s (wall guard {wall_limit:.0f} s; the world lock took "
            f"{waited:.1f} s to get); last lines of {out / f'{side}.log'}:\n"
            f"{_tail(out / f'{side}.log')}"
            for side, how in failed.items()))
    return {side: (out / f"{side}.log").read_text(errors="replace") for side, _ in sides}
