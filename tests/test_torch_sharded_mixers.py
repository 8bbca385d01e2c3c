"""The port's sharded train step for the SSM, RG-LRU and MLA mixers under
tensor parallelism and for MoE on a mesh, against the reference's sharded
step and against the port's own one-process step.

No process group is made in the test process.  A module fixture draws
each variant's initial parameters, then runs
``tests/sharded_mixers_worlds.py`` twice, at once under the world lock
(``tests/world_lock.py``: one world on the host at a time), each in a
fresh session killed whole if it uses more than CPU_LIMIT CPU seconds or
hangs: the reference side (its jitted
sharded step on 4 forced host devices) and the port side (gloo worlds of
1, 2 and 4 ranks, the one-process runs and the launcher on a mesh).
Every step computes in f32 on both sides, from weights drawn as the
training phases on the card draw theirs (``chip_smoke._draw_train_params``:
the attention projections at their true fan-in, a MoE model's embedding
at unit variance, Mamba-2's published dt and A).  From the shared init
rule alone reduced recurrentgemma-9b amplifies rounding: an input
perturbed by 1e-7 leaves its last block 1.5e-5 apart, and after 2 steps
the reference's own (1, 4) step departs from its own one-device step by
2.1e-4 in the loss and 5.1e-2 in the update, as the port's does.  The
bounds are those of ``tests/test_torch_sharded_train.py``, with their
reasons there:

* against the reference, 2 steps: losses and grad norms within 1e-4
  relative, the update within 2e-3 relative L2;
* against the one-process step, 2 steps: losses and grad norms within
  1e-5 relative, parameters within 1e-4 relative L2;
* both: after the first step, which starts from the same parameters on
  both sides, every leaf's first moment (the clipped gradient times
  ``1 - b1``) within 1e-4 relative L2 of the other side's.  A gradient
  missing its sum over TP, or summed once too often, moves its leaf by a
  factor, however small the leaf.  With int8 compression the moment is
  the dequantized gradient, whose levels rounding flips: there the mean
  quantization error is held instead (1e-3);
* at world size 1 the collectives are copies: bit for bit;
* the launcher's crash replay on a mesh: bit for bit.

The reference's dense MoE path under GSPMD routes the whole microbatch,
and so does the port's on data axes: the deepseek (4, 1) case drops
entries, and a per-rank route would drop others (``route_*``).  The
expert-parallel paths route each shard's rows on their own in both
packages; against the one-process step they run where nothing drops,
with no balance loss.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import sharded_mixers_worlds as mw
from world_lock import run_sides
from repro_torch.configs import get_config
from repro_torch.models import reduced_for_smoke
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
CPU_LIMIT = 900  # CPU s a side may use; the most a side used was 224 (world_lock.py)


def _draw(variant: str) -> list:
    """The initial f32 leaves of ``variant``, in the reference's order,
    drawn as the card's training phases draw them
    (``chip_smoke._draw_train_params``: the model's own init, the attention
    projections at their true fan-in, a MoE model's embedding at unit
    variance, Mamba-2's published dt and A)."""
    cfg = mw.make_cfg(variant, get_config, reduced_for_smoke)
    params = chip_smoke._draw_train_params(cfg, 0, torch.device("cpu"))
    return [x.numpy() for x in tree_leaves(params)]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_mixers")
    for variant in mw.VARIANTS:
        np.savez(out / f"init_{variant}.npz",
                 **{f"p{i}": x for i, x in enumerate(_draw(variant))})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    # the reference compiles one step a case (~45 s of CPU each at XLA's
    # default LLVM optimization, ~30 s at level 0, which moves its leaves
    # by rounding only: 8e-6 relative at most)
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                   "--xla_backend_optimization_level=0 "
                   "--xla_llvm_disable_expensive_passes=true")
    run_sides(ROOT / "tests" / "sharded_mixers_worlds.py", out,
              [("reference", ref_env), ("port", env)], CPU_LIMIT)
    return out


def _load(out, name):
    with np.load(out / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def _leaves(run: dict) -> list:
    return [run[f"p{i}"] for i in range(sum(k.startswith("p") for k in run))]


def _rel_tree(got: list, want: list) -> float:
    a = np.concatenate([np.asarray(x, np.float64).ravel() for x in got])
    b = np.concatenate([np.asarray(x, np.float64).ravel() for x in want])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rel(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.abs(b)


def _moments(run: dict) -> list:
    return [run[f"m{i}"] for i in range(sum(k.startswith("m") for k in run))]


def _worst_leaf(got: list, want: list):
    """(the largest relative L2 gap of a leaf, its index)."""
    gaps = [np.linalg.norm(np.asarray(a, np.float64) - b)
            / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30)
            for a, b in zip(got, want)]
    return max(gaps), int(np.argmax(gaps))


def _held(got: dict, want: dict, tol: float, compress: bool = False) -> None:
    """Losses and grad norms of ``got`` within ``tol`` of ``want``'s, and
    unless ``compress`` every leaf's first moment within 1e-4."""
    assert _rel(got["losses"], want["losses"]).max() <= tol, (got["losses"],
                                                              want["losses"])
    assert _rel(got["grad_norms"], want["grad_norms"]).max() <= tol, (
        got["grad_norms"], want["grad_norms"])
    if not compress:
        gap, leaf = _worst_leaf(_moments(got), _moments(want))
        assert gap <= 1e-4, (gap, leaf)


@pytest.mark.parametrize("case", mw.REF_CASES)
def test_sharded_step_matches_reference(out, case):
    ref, got = _load(out, f"ref_{case}"), _load(out, f"port_{case}")
    _held(got, ref, 1e-4)
    p0 = _leaves(_load(out, f"init_{mw.CASES[case][0]}"))
    upd = _rel_tree([a - b for a, b in zip(_leaves(got), p0)],
                    [a - b for a, b in zip(_leaves(ref), p0)])
    assert upd <= 2e-3, upd


@pytest.mark.parametrize("case", mw.ONE_CASES)
def test_sharded_step_matches_one_process(out, case):
    got, want = _load(out, f"port_{case}"), _load(out, f"one_{mw.one_key(case)}")
    compress = mw.CASES[case][3].get("compress", False)
    _held(got, want, 1e-5, compress)
    params = _rel_tree(_leaves(got), _leaves(want))
    assert params <= 1e-4, params
    if compress:
        assert (got["compression_err"] > 0).all()
        assert _rel(got["compression_err"], want["compression_err"]).max() <= 1e-3


@pytest.mark.parametrize("case", mw.W1_CASES)
def test_world_size_one_is_the_one_process_step_bit_for_bit(out, case):
    got, want = _load(out, f"port_{case}"), _load(out, f"one_{mw.one_key(case)}")
    for key in ("losses", "grad_norms"):
        assert got[key].tobytes() == want[key].tobytes(), key
    for a, b in zip(_leaves(got) + _moments(got), _leaves(want) + _moments(want)):
        assert a.tobytes() == b.tobytes()


def test_global_route_drops_entries_a_per_rank_route_would_not(out):
    """The (4, 1) case's route is the whole microbatch's: its capacity
    drops entries, and routing each rank's rows alone would keep or drop
    others, so the case tells the two apart."""
    got = _load(out, f"route_{mw.ROUTE_CASE}")
    assert int(got["dropped"]) > 0 and int(got["differ"]) > 0, got


def test_launcher_on_a_mesh_replays_a_crash_of_a_reduced_deepseek(out):
    """``--arch deepseek-v2-lite-16b --mesh 2 1``, 6 steps, a checkpoint
    every 3, a crash after step 5: the replay of steps 4-5 and the step
    after it equal the uncrashed run's, loss and grad norm, bit for bit."""
    def history(name):
        return [(h["step"], h["loss"], h["grad_norm"])
                for h in json.loads((out / f"launch_{name}.json").read_text())]

    clean, crash = history("clean"), history("crash")
    assert [s for s, _, _ in crash] == [1, 2, 3, 4, 5, 4, 5, 6]
    assert crash[:5] + crash[7:] == clean
    assert crash[5:7] == clean[3:5]
