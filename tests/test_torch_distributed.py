"""The port's sharded paths across ranks, against the reference's on as
many host devices.

No process group is made in the test process.  A module fixture draws the
MoE parameters with the reference, then runs ``tests/dist_worlds.py``
twice, at once under the world lock (``tests/world_lock.py``: one world
on the host at a time), each in a fresh session killed whole if it
uses more than CPU_LIMIT CPU seconds or hangs: the reference
side (``shard_map`` over 4 forced host devices) and the port side (gloo
worlds of 1, 2 and 4 ranks, spawned, meeting through a rendezvous file,
``OMP_NUM_THREADS=1``).  Each writes every result of every case as
``.npz``; the tests compare them.

- ``device_histogram`` with a mesh of 2 and 4 ranks over "data" and on a
  (2, 2) mesh: every field of every rank's ``ShuffleResult`` equals the
  reference's, for uniform and Zipf keys, a length no rank count divides,
  capacity drops, spill to a DRAM tier, int32 and f32 values, and an
  empty input.  On the (2, 2) mesh the reference's ``pmean`` over
  "model" turns int32 counts into f32; the port keeps the accumulator's
  type, so there the values are held equal and the types are not.  The
  1-rank mesh gives the bytes of the one-device call.  With
  ``unit_weights=True`` (each owner counts with ``bucket_histogram``)
  every rank's result is the segment-sum call's, bytes and fields.
- ``moe_apply_a2a`` and ``moe_apply_gather`` on a (2, 2) mesh: reduced
  deepseek-v2-lite-16b (8 experts, top-2) in f32 at capacity factors 16
  and 0.5, ``zero1`` both ways: outputs within 2e-4 of the reference's
  same path, and of the port's dense path where no entry drops; ``aux``
  within 1e-6 relative.  ``moe_apply`` picks the reference's path.  Under
  autograd, on the (1, 2) and (2, 2) meshes, both paths' gradients of
  the input and of each rank's weight slices are the dense path's where
  nothing drops, 2e-4.
- A reduced deepseek-v2-lite-16b ``forward`` and ``decode_step`` with a
  ``ShardCtx`` on the (2, 2) mesh against the port's one-process run,
  2e-4; ``constrain`` on a ``DTensor``; the mesh builders' refusals.
"""

import os
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dist_worlds as dw
from world_lock import run_sides
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models import reduced_for_smoke as jreduced
from repro_torch.configs import get_config
from repro_torch.models import (
    decode_step, forward, init_cache, init_params, logits_fn, model_defs, moe,
    reduced_for_smoke,
)
from repro_torch.models.convert import to_tensor

ROOT = Path(__file__).resolve().parents[1]
CPU_LIMIT = 240  # CPU s a side may use; the most a side used was 54 (world_lock.py)
TOL = 2e-4


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    base = jreduced(jget_config(dw.ARCH))
    for E in (8, 6):
        cfg = replace(base, moe=replace(base.moe, n_experts=E))
        p = jinit_params(jmoe.moe_defs(cfg), jax.random.PRNGKey(0))
        p = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)), p)
        np.savez(out / f"moe_e{E}.npz", **dw.flatten(p))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    run_sides(ROOT / "tests" / "dist_worlds.py", out,
              [("reference", ref_env), ("port", env)], CPU_LIMIT)
    return out


def _load(out, name):
    with np.load(out / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def _ranks(mesh: str) -> range:
    return range(int(np.prod(dw.MESHES[mesh][0])))


FIELDS = ("dropped", "shuffled_bytes", "buffer_bytes", "spilled", "spilled_bytes")


@pytest.mark.parametrize("case", dw.HIST_CASES)
@pytest.mark.parametrize("mesh", dw.HIST_MESHES)
def test_device_histogram_across_ranks_matches_reference(out, mesh, case):
    ref = _load(out, f"ref_hist_{mesh}_{case}")
    keys, vals, kw, spill = dw.hist_case(case)
    for r in _ranks(mesh):
        got = _load(out, f"port_hist_{mesh}_{case}_r{r}")
        np.testing.assert_array_equal(got["counts"], ref["counts"])
        if "model" not in dw.MESHES[mesh][1]:
            assert got["counts"].dtype == ref["counts"].dtype
        for f in FIELDS:
            assert int(got[f]) == int(ref[f]), (f, r)
    if case in ("drop", "spill"):
        assert int(ref["spilled" if spill else "dropped"]) > 0
    if case == "spill":  # spilled, not lost: every pair is counted
        np.testing.assert_allclose(
            got["counts"], np.bincount(keys, vals, minlength=dw.VOCAB), rtol=1e-5)


@pytest.mark.parametrize("case", dw.HIST_CASES)
def test_device_histogram_one_rank_mesh_is_the_one_device_call(out, case):
    mesh = _load(out, f"port_hist_d1_{case}_r0")
    one = _load(out, f"port_hist1_{case}")
    assert mesh["counts"].dtype == one["counts"].dtype
    assert mesh["counts"].tobytes() == one["counts"].tobytes()
    for f in FIELDS:
        assert int(mesh[f]) == int(one[f]), f


@pytest.mark.parametrize("case", dw.UNIT_CASES)
@pytest.mark.parametrize("mesh", dw.HIST_MESHES + ("d1",))
def test_device_histogram_unit_weights_across_ranks_is_the_segment_sum(out, mesh, case):
    """``unit_weights=True``: each owner counts its keys with
    ``bucket_histogram``; every rank's result equals, bytes and fields, the
    segment-sum call that the test above holds to the reference."""
    for r in _ranks(mesh):
        got = _load(out, f"port_hist_unit_{mesh}_{case}_r{r}")
        want = _load(out, f"port_hist_{mesh}_{case}_r{r}")
        assert got["counts"].dtype == want["counts"].dtype
        assert got["counts"].tobytes() == want["counts"].tobytes()
        for f in FIELDS:
            assert int(got[f]) == int(want[f]), (f, r)


def _port_dense(out, cf: float, T: int = 8):
    cfg = reduced_for_smoke(get_config(dw.ARCH))
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
    p = dw.unflatten(dict(np.load(out / "moe_e8.npz")))
    p = {k: to_tensor(v) if not isinstance(v, dict)
         else {kk: to_tensor(vv) for kk, vv in v.items()} for k, v in p.items()}
    y, aux = moe.moe_apply_dense(p, torch.from_numpy(dw.moe_x(T, cfg.d_model)), cfg)
    return y.numpy(), float(aux)


@pytest.mark.parametrize("path,cf,zero1", dw.MOE_CASES,
                         ids=[f"{p}-cf{cf:g}-zero1_{z}" for p, cf, z in dw.MOE_CASES])
def test_moe_expert_parallel_matches_reference(out, path, cf, zero1):
    ref = _load(out, f"ref_moe_{path}_{cf}_{zero1}")
    dense, _ = _port_dense(out, cf)
    for r in _ranks("d2m2"):
        got = _load(out, f"port_moe_{path}_{cf}_{zero1}_r{r}")
        np.testing.assert_allclose(got["out"], ref["out"], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]), rtol=1e-6)
        if cf == 16.0:  # no entry drops: the sharded paths are the dense one
            np.testing.assert_allclose(got["out"], dense, atol=TOL, rtol=TOL)
        # each rank holds 8 / 2 experts, and half of d_model unless zero1
        D = 64 if zero1 else 32
        assert tuple(got["w_gate_shape"]) == (4, D, 32)
        assert tuple(got["router_shape"]) == (D, 8)
    if cf == 0.5:  # capacity drops entries, per shard, unlike the dense path
        assert not np.allclose(ref["out"], dense, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", dw.DISPATCH_CASES)
def test_moe_apply_picks_the_reference_path(out, name):
    ref = _load(out, f"ref_dispatch_{name}")
    mesh = dw.DISPATCH_CASES[name][0]
    for r in _ranks(mesh):
        got = _load(out, f"port_dispatch_{name}_r{r}")
        assert str(got["path"]) == str(ref["path"])
        np.testing.assert_allclose(got["out"], ref["out"], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(float(got["aux"]), float(ref["aux"]), rtol=1e-6)
    assert str(ref["path"]) == {"a2a": "moe_apply_a2a", "gather": "moe_apply_gather",
                                "tp1": "moe_apply_dense",
                                "indivisible": "moe_apply_dense"}[name]


def _block(t: np.ndarray, dim: int, n: int, i: int) -> np.ndarray:
    return np.split(t, n, axis=dim)[i]


@pytest.mark.parametrize("mesh,path,zero1", dw.GRAD_CASES,
                         ids=[f"{m}-{p}-zero1_{z}" for m, p, z in dw.GRAD_CASES])
def test_moe_expert_parallel_gradients_match_dense(out, mesh, path, zero1):
    """The a2a and gather paths under autograd, each rank's gradients of the
    whole input and of its slices of the weights (``shard_params``), for
    the loss ``sum(out * W)``: those of ``moe_apply_dense`` on one process,
    cut to the rank's blocks, where no entry drops."""
    cfg = reduced_for_smoke(get_config(dw.ARCH))
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=16.0))
    p = dw.unflatten(dict(np.load(out / "moe_e8.npz")))
    p = {k: to_tensor(v).requires_grad_() if not isinstance(v, dict)
         else {kk: to_tensor(vv).requires_grad_() for kk, vv in v.items()}
         for k, v in p.items()}
    x = torch.from_numpy(dw.moe_x(8, cfg.d_model)).requires_grad_()
    y, _ = moe.moe_apply_dense(p, x, cfg)
    (y * torch.from_numpy(dw.moe_grad_weights(8, cfg.d_model))).sum().backward()
    want = {"x": x.grad.numpy(), "router": p["router"].grad.numpy(),
            **{n: p[n].grad.numpy() for n in ("w_gate", "w_up", "w_down")},
            **{f"shared/{n}": t.grad.numpy() for n, t in p["shared"].items()}}
    (n_data, tp), _ = dw.MESHES[mesh]
    for r in _ranks(mesh):
        d, col = divmod(r, tp)
        got = _load(out, f"port_moe_grad_{mesh}_{path}_{zero1}_r{r}")
        cut = dict(want)
        fsdp, d = (1, 0) if zero1 else (n_data, d)  # zero1: whole over data
        cut["router"] = _block(want["router"], 0, fsdp, d)
        for n, dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
            cut[n] = _block(_block(want[n], 0, tp, col), dim, fsdp, d)
        assert sorted(got) == sorted(cut)
        for n in cut:
            assert got[n].shape == cut[n].shape, n
            np.testing.assert_allclose(got[n], cut[n], atol=TOL, rtol=TOL, err_msg=n)


def test_sharded_model_forward_and_decode_match_one_process(out):
    base = reduced_for_smoke(get_config(dw.ARCH))
    cfg = replace(base, moe=replace(base.moe, capacity_factor=16.0))
    tp = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu",
                     dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    with torch.no_grad():
        h, _ = forward(tp, cfg, {"tokens": tokens})
        cache = init_cache(cfg, 2, 4, dtype=torch.float32, device="cpu")
        steps = []
        for t in range(4):
            lg, cache = decode_step(tp, cfg, tokens[:, t:t + 1], cache, t)
            steps.append(lg)
    want, want_dec = logits_fn(tp, cfg, h).numpy(), torch.stack(steps, 1).numpy()
    for r in _ranks("d2m2"):
        got = _load(out, f"port_model_r{r}")
        np.testing.assert_allclose(got["logits"], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["decode"], want_dec, atol=TOL, rtol=TOL)


def test_constrain_redistributes_a_dtensor(out):
    x = np.arange(4 * 6 * 5, dtype=np.float32).reshape(4, 6, 5)
    for r in _ranks("d2m2"):
        got = _load(out, f"port_constrain_r{r}")
        # batch over data, the first dim TP divides over model; 5 stays whole
        assert got["placements"].tolist() == got["expect"].tolist()
        assert tuple(got["local_shape"]) == (2, 3, 5)
        np.testing.assert_array_equal(got["full"], x)
        # 3 rows divide over no data axis: replicated there
        assert got["odd_placements"].tolist()[0] == "R"
        assert bool(got["plain_same"])


@pytest.mark.parametrize("world", sorted(dw.WORLDS))
def test_mesh_builders_refuse_another_world_size_and_leave_no_group(out, world):
    for r in range(world):
        got = _load(out, f"port_world{world}_r{r}")
        wrong, production = got["errors"].tolist()
        assert f"needs {world + 1} ranks" in wrong and f"has {world}" in wrong
        assert "needs 256 ranks" in production
        assert not bool(got["left"])
    assert tuple(got["sizes"]) == {1: (1, 1), 2: (2, 1), 4: (1, 4)}[world]
