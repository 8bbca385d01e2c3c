"""The port's sharded train step across ranks, against the reference's
sharded step and against the port's own one-process step.

No process group is made in the test process.  A module fixture draws
each configuration's initial parameters with the reference and writes a
reference checkpoint, then runs ``tests/sharded_train_worlds.py`` twice,
at once under the world lock (``tests/world_lock.py``: one world on
the host at a time), each in a fresh session killed whole if it uses
more than CPU_LIMIT CPU seconds or hangs: the
reference side (its jitted FSDP×TP step on 4 forced host devices) and the
port side (gloo worlds of 1, 2 and 4 ranks, spawned, meeting through
rendezvous files, ``OMP_NUM_THREADS=1``).  Every step computes in f32 on
both sides (each package's bf16 cast is patched in the subprocess).
Tolerances, each with its reason:

* against the reference, 2 steps: losses within 1e-4 relative, the
  update (every leaf's ``p2 - p0``, relative L2 over the whole tree;
  no update would read 1) within 2e-3: the frameworks sum in other
  orders, and AdamW's first steps, near ``lr·sign(g)``, amplify that in
  leaves whose gradient is all rounding (the bounds of
  ``test_train_lm_example_matches_reference_losses``);
* against the one-process step, 2 steps: losses within 1e-5 relative,
  parameters' relative L2 over the whole tree within 1e-4 (the
  reductions over ranks sum in another order);
* at world size 1 the collectives are copies: losses, grad norms and
  parameters bit for bit;
* the launcher's crash replay on a mesh: bit for bit, as on one process.
"""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_train_worlds as sw
from world_lock import run_sides
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import model_defs as jmodel_defs
from repro.models import reduced_for_smoke as jreduced
from repro.models.param import param_specs as jparam_specs
from repro.optim import adamw as jadamw
from repro.storage import CheckpointManager as JCheckpointManager
from repro.storage import PmemTier as JPmemTier
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import make_decode_step, make_prefill_step, make_step
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import restore_state
from repro_torch.models import ShapeConfig, init_params, model_defs, reduced_for_smoke
from repro_torch.models.attention import tp_partial
from repro_torch.parallel.sharding import (
    mesh_axes, param_pspecs, shard_tree, spec_leaves, unshard_tree)
from repro_torch.storage import CheckpointManager, PmemTier
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
CPU_LIMIT = 600  # CPU s a side may use; the most a side used was 155 (world_lock.py)


def _ref_checkpoint(out: Path) -> list:
    """A reference checkpoint of reduced qwen2.5-3b (moments moved off
    zero, step 7) under ``out/refckpt``; returns its leaves."""
    jcfg = jreduced(jget_config("qwen2.5-3b"))
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(1)))
    jopt = jadamw.adamw_init(jp)
    jopt = jopt._replace(mu=jax.tree_util.tree_map(lambda x: x + 1.5, jopt.mu),
                         step=jnp.int32(7))
    ck = JCheckpointManager(JPmemTier(str(out / "refckpt")), "train/x", keep=2)
    ck.save(7, {"params": jax.tree_util.tree_leaves(jp),
                "opt": jax.tree_util.tree_leaves(jopt)}, block=True)
    ck.close()
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(jp)
            + jax.tree_util.tree_leaves(jopt)]


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_train")
    for variant in sw.VARIANTS:
        jcfg = sw.make_cfg(variant, jget_config, jreduced)
        p = jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(0))
        np.savez(out / f"init_{variant}.npz", **{
            f"p{i}": np.asarray(x.astype(jnp.float32))
            for i, x in enumerate(jax.tree_util.tree_leaves(p))})
    np.savez(out / "refckpt_leaves.npz",
             **{f"p{i}": x for i, x in enumerate(_ref_checkpoint(out))})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run_sides(ROOT / "tests" / "sharded_train_worlds.py", out,
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


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("case", sw.REF_CASES)
def test_sharded_step_matches_reference(out, case):
    """Measured: losses within 1.7e-7 relative, grad norms within 1.6e-5,
    updates within 1.1e-4 (qwen2.5-3b; mamba2-2.7b 9.4e-8, 5.4e-7 and
    6.9e-5)."""
    ref, got = _load(out, f"ref_{case}"), _load(out, f"port_{case}")
    p0 = [np.asarray(x) for x in _leaves(_load(out, f"init_{sw.CASES[case][0]}"))]
    gaps = _rel(got["losses"], ref["losses"])
    assert gaps <= 1e-4, (got["losses"], ref["losses"])
    norms = _rel(got["grad_norms"], ref["grad_norms"])
    assert norms <= 1e-4, (got["grad_norms"], ref["grad_norms"])
    upd = _rel_tree([a - b for a, b in zip(_leaves(got), p0)],
                    [a - b for a, b in zip(_leaves(ref), p0)])
    assert upd <= 2e-3, upd


@pytest.mark.parametrize("case", sw.CASES)
def test_sharded_step_matches_one_process(out, case):
    """Measured: losses within 2.5e-7 relative, the first step's grad norm
    within 4.3e-7, the second's within 2.1e-5, parameters within 6.3e-6
    relative L2, but for gemma2-9b: 2.9e-6, 2.8e-6, 4.8e-5 and 7.9e-5.
    Its f32 gradients move most under TP (3e-5 per leaf at the first step
    against one process, 2e-7 under FSDP alone), and AdamW's near-sign
    first steps carry that into its embedding's update.

    The first step's grad norm, taken from the same parameters on both
    sides, is held to 1e-5: a leaf's gradient scaled by a constant (a
    norm scale summed over TP, a data-parallel sum left unaveraged) moves
    it, where clipping and AdamW would hide it from the losses and the
    parameters.  The later steps' start from parameters up to the 1e-4
    bound apart, so their grad norms are held to 1e-4."""
    got, want = _load(out, f"port_{case}"), _load(out, f"one_{case}")
    assert _rel(got["losses"], want["losses"]) <= 1e-5, (got["losses"], want["losses"])
    norms = np.abs(got["grad_norms"] - want["grad_norms"]) / want["grad_norms"]
    assert norms[0] <= 1e-5 and norms.max() <= 1e-4, (
        got["grad_norms"], want["grad_norms"])
    params = _rel_tree(_leaves(got), _leaves(want))
    assert params <= 1e-4, params
    if sw.CASES[case][3].get("compress"):
        assert (got["compression_err"] > 0).all()
        assert _rel(got["compression_err"], want["compression_err"]) <= 1e-3


@pytest.mark.parametrize("case", sw.W1_CASES)
def test_world_size_one_is_the_one_process_step_bit_for_bit(out, case):
    got, want = _load(out, f"port_{case}"), _load(out, f"one_{case}")
    for key in ("losses", "grad_norms", "compression_err"):
        assert got[key].tobytes() == want[key].tobytes(), key
    for a, b in zip(_leaves(got), _leaves(want)):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_make_step_hands_a_mesh_to_the_serving_step_builders(kind, monkeypatch):
    """``make_step`` hands a prefill or decode shape, the mesh and the
    reference's keywords to the step builder of that kind, and returns
    what it builds (the steps on a mesh: tests/test_torch_sharded_serve.py)."""
    from repro_torch.launch import steps

    cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
    shape = ShapeConfig(name="s", kind=kind, seq_len=16, global_batch=2)
    mesh = (("data", "model"), (2, 2))
    builder = {"prefill": "make_prefill_step", "decode": "make_decode_step"}[kind]
    assert getattr(steps, builder) is {"prefill": make_prefill_step,
                                       "decode": make_decode_step}[kind]
    seen = []
    monkeypatch.setattr(steps, builder, lambda *a, **kw: seen.append((a, kw)) or builder)
    kw = ({"cache_len": 24} if kind == "prefill"
          else {"greedy": True, "quant_cache": True})
    assert make_step(cfg, shape, mesh=mesh, param_fsdp=False, **kw) == builder
    assert seen == [((cfg, shape), dict(mesh=mesh, param_fsdp=False, **kw))]


def _history(out, name):
    return [(h["step"], h["loss"], h["grad_norm"])
            for h in json.loads((out / f"launch_{name}.json").read_text())]


def test_launcher_on_a_mesh_replays_a_crash_bit_for_bit(out):
    """``--mesh 2 1 --compress-grads``, 8 steps, a checkpoint every 4, a
    crash after step 6: the replay of steps 5-6 and the steps after it
    equal the uncrashed run's, loss and grad norm, bit for bit."""
    clean, crash = _history(out, "clean"), _history(out, "crash")
    assert [s for s, _, _ in crash] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    assert crash[:6] + crash[8:] == clean
    assert crash[6:8] == clean[4:6]


def _one_process_restore(path: Path, prefix: str) -> list:
    cfg = reduced_for_smoke(get_config("qwen2.5-3b"))
    ckpt = CheckpointManager(PmemTier(str(path)), prefix)
    try:
        params, opt = restore_state(ckpt, cfg, "cpu")
    finally:
        ckpt.close()
    return [x.numpy() for x in tree_leaves(params) + tree_leaves(opt)]


def test_checkpoints_restore_across_meshes_and_packages(out):
    """The launcher's checkpoint, written on (2, 1), restores on a (1, 2)
    mesh as the one-process launcher restores it; a reference checkpoint
    restores on (2, 1) with the reference's leaves."""
    got = _leaves(_load(out, "port_restored_launch"))
    want = _one_process_restore(out / "launch_crash", "train/qwen2.5-3b")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    got = _leaves(_load(out, "port_restored_ref"))
    want = _leaves(_load(out, "refckpt_leaves"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_sharded_loop_checkpoints_its_own_state(out):
    """``train`` on (2, 1) with compression: the whole parameters at its
    end equal its last checkpoint's, restored in one process, and the
    checkpoint holds the residual under "ef"."""
    got = _load(out, "port_loop")
    assert got["equal"].all() and got["equal"].size > 0
    assert got["keys"].tolist() == ["ef", "opt", "params"]
    assert int(got["n_ef"]) == got["equal"].size


def test_full_mesh_needs_256_ranks(tmp_path):
    with pytest.raises(ValueError, match="needs 256 ranks"):
        train_main(["--full-mesh", "--device", "cpu", "--ckpt-dir", str(tmp_path)])


# -- pure: specs, blocks ----------------------------------------------------------

MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh):
    """Every leaf's spec, FSDP×TP and TP only, as the reference's
    ``_pspec_tree`` resolves it (the reference's ``param_specs`` with the
    same axes and sizes)."""
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)
    shape, axes = MESHES[mesh]
    sizes = dict(zip(axes, shape))
    _, fsdp, tp = mesh_axes((axes, shape))
    for override in (Ellipsis, None):
        got = spec_leaves(param_pspecs(get_config(arch), (axes, shape), override))
        want = jax.tree_util.tree_leaves(
            jparam_specs(jmodel_defs(jget_config(arch)), tp_axis=tp,
                         fsdp_axis=fsdp if override is Ellipsis else None,
                         axis_sizes=sizes),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g) == tuple(w), (g, w)


@pytest.mark.parametrize("mesh", [((1, 1), ("data", "model")),
                                  ((2, 2), ("data", "model")),
                                  ((4, 1), ("data", "model")),
                                  ((1, 4), ("data", "model")),
                                  ((2, 2, 1), ("pod", "data", "model"))],
                         ids=["1x1", "2x2", "4x1", "1x4", "2x2x1"])
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-2.7b", "deepseek-v2-lite-16b"])
def test_shard_tree_round_trip(arch, mesh):
    """Each rank's blocks are the whole leaf's, cut by its spec; the blocks
    of every rank put together are the whole tree again."""
    cfg = reduced_for_smoke(get_config(arch))
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.float32)
    pair = (mesh[1], mesh[0])
    specs = param_pspecs(cfg, pair)
    n = int(np.prod(mesh[0]))
    blocks = [shard_tree(params, specs, pair, rank=r) for r in range(n)]
    sizes = dict(zip(mesh[1], mesh[0]))
    for whole, block, spec in zip(tree_leaves(params), tree_leaves(blocks[-1]),
                                  spec_leaves(specs)):
        want = tuple(d // (sizes[e] if e else 1) for d, e in zip(whole.shape, spec))
        assert tuple(block.shape) == want and block.is_contiguous()
    for a, b in zip(tree_leaves(unshard_tree(blocks, specs, pair)), tree_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        shard_tree(params, specs, pair, rank=n)


def test_tp_partial_names_the_replicated_kv_projections():
    """qwen2.5-3b (16 heads over 2 kv heads) shards heads over TP and keeps
    the kv projections whole, each rank using one kv head of them: their
    gradients sum over TP.  The reduced config shards head_dim instead."""
    cfg = get_config("qwen2.5-3b")
    assert tp_partial(cfg, 4) == ("wk", "wv", "bk", "bv")
    assert tp_partial(cfg, 1) == ()
    assert tp_partial(reduced_for_smoke(cfg), 4) == ()
    specs = param_pspecs(cfg, (("data", "model"), (2, 4)))["body"][0]["mixer"]
    assert tuple(specs["wq"]) == (None, "data", "model", None)
    assert tuple(specs["wk"]) == (None, "data", None, None)
