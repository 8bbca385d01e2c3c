"""The port's layout rules against the reference's, with no ranks.

``parallel/sharding.py`` of both packages reads only a mesh's axis names
and sizes, so each runs here over a description of the mesh: a
``(names, sizes)`` pair for the port, a stand-in carrying ``axis_names``
and ``shape`` for the reference.  For every configuration of the zoo, at
meshes (1, 1), (2, 4), (16, 16) and (2, 16, 16), and every input-shape
cell, the specs must be the reference's ``PartitionSpec`` entries letter
for letter.  Also: the production mesh's shape and names, ``named``'s
placements, ``ShardCtx``'s sizes, ``constrain``'s no-op rules, and
``forward`` with no mesh computing the bytes it computes with no context.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch.steps import make_ctx as jmake_ctx
from repro.models.ctx import ShardCtx as JShardCtx
from repro.parallel import sharding as js
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import make_ctx, production_mesh_shape
from repro_torch.models import ShardCtx, constrain, forward, init_params, model_defs
from repro_torch.models import reduced_for_smoke
from repro_torch.parallel import sharding as ts

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x4": (("data", "model"), (2, 4)),
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}


def _standin(desc):
    names, sizes = desc
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _spec_leaves(tree):
    """The specs of a cache spec tree in the reference's pytree order
    (dict keys sorted), as plain tuples."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return [tuple(tree)]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _spec_leaves(tree[k])]
    return [s for v in tree for s in _spec_leaves(v)]


def test_shape_cells_are_the_reference_cells():
    assert set(SHAPES) == set(JSHAPES)
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.kind, s.seq_len, s.global_batch) == (j.kind, j.seq_len, j.global_batch)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch, mesh):
    desc = MESHES[mesh]
    jm = _standin(desc)
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert ts.mesh_axes(desc) == js.mesh_axes(jm)
    for B in (1, 2, 8, 32, 128, 256, 512):
        assert ts.batch_entry(desc, B) == js.batch_entry(jm, B)
        assert ts._tp_entry(desc, B) == js._tp_entry(jm, B)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        got, want = ts.input_specs(cfg, shape), js.input_specs(jcfg, jshape)
        assert list(got) == list(want)
        for k in want:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        got, want = ts.input_shardings(cfg, shape, desc), js.input_shardings(
            jcfg, jshape, jm)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
        for quant in (False, True):
            got = ts.cache_pspecs(cfg, shape, desc, quant)
            want = js.cache_pspecs(jcfg, jshape, jm, quant)
            assert _spec_leaves(got) == [
                tuple(s) for s in jax.tree_util.tree_leaves(
                    want, is_leaf=lambda x: isinstance(x, js.P))]
            # the same cache types, field for field
            for part in ("prelude", "body", "postlude"):
                assert [type(c).__name__ for c in got[part]] == \
                    [type(c).__name__ for c in want[part]]


def test_production_mesh_shape_is_the_reference_mesh(monkeypatch):
    """The shapes and names the reference's ``make_production_mesh`` asks
    for, read with its mesh builder stubbed: no 256 or 512 devices."""
    from repro.launch import mesh as jmesh
    monkeypatch.setattr(jmesh, "make_mesh_compat",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    for multi_pod in (False, True):
        assert production_mesh_shape(multi_pod) == \
            jmesh.make_production_mesh(multi_pod=multi_pod)
    assert production_mesh_shape(True) == ((2, 16, 16), ("pod", "data", "model"))


def test_named_gives_dtensor_placements():
    desc = MESHES["2x16x16"]
    P = ts.PartitionSpec
    tree = {"x": P(("pod", "data"), None, "model"), "y": [P(None, None)],
            "c": ts.cache_pspecs(get_config("gemma-2b"), SHAPES["decode_32k"], desc)}
    got = ts.named(desc, tree)
    assert got["x"] == (Shard(0), Shard(0), Shard(2))
    assert got["y"] == [(Replicate(),) * 3]
    k = got["c"]["body"][0].k  # P(None, ('pod', 'data'), 'model', None, None)
    assert k == (Shard(1), Shard(1), Shard(2))


@pytest.mark.parametrize("mesh", ["2x4", "2x16x16"])
def test_make_ctx_and_sizes_match_reference(mesh):
    desc = MESHES[mesh]
    standin = _standin(desc)
    fake = SimpleNamespace(mesh_dim_names=desc[0],
                           size=lambda i: desc[1][i])
    ctx = ShardCtx(mesh=fake, dp_axes=js.mesh_axes(standin)[0])
    jctx = JShardCtx(mesh=standin, dp_axes=js.mesh_axes(standin)[0])
    assert (ctx.dp_size(), ctx.tp_size()) == (jctx.dp_size(), jctx.tp_size())
    jfull = jmake_ctx(standin)
    assert (jfull.dp_axes, jfull.tp_axis) == (ctx.dp_axes, ctx.tp_axis)
    assert make_ctx(None) == ShardCtx() and ShardCtx().tp_size() == 1


def test_constrain_is_a_no_op_without_a_mesh_or_for_a_plain_tensor():
    x = torch.randn(4, 6)
    assert constrain(x, None, "b", "tp") is x
    assert constrain(x, ShardCtx(), "b", "tp") is x
    fake = SimpleNamespace(mesh_dim_names=("data", "model"), size=lambda i: 2)
    assert constrain(x, ShardCtx(mesh=fake), "b", "tp") is x


def test_forward_without_a_mesh_is_unchanged():
    """``ctx=None`` and a context with no mesh compute the bytes of a call
    that passes no context (deepseek's MoE layers take the dense path)."""
    cfg = reduced_for_smoke(get_config("deepseek-v2-lite-16b"))
    tp = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu",
                     dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    with torch.no_grad():
        h0, a0 = forward(tp, cfg, {"tokens": tokens})
        for ctx in (None, ShardCtx()):
            h, a = forward(tp, cfg, {"tokens": tokens}, ctx=ctx)
            assert h.numpy().tobytes() == h0.numpy().tobytes()
            assert float(a) == float(a0)
