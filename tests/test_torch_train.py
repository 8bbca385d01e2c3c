"""The port's training path against the reference, on the CPU.

Parameters are drawn by the reference and carried across with
``from_jax_params``; token batches come from each package's own
``make_batch`` (byte-identical).  Tolerances, each with its reason:

* whole-model loss and gradients in f32: loss rtol 1e-5, each gradient
  leaf's relative L2 error <= 1e-4 (f32 sums in another order; 2e-4 for
  gemma2-9b, whose random model amplifies f32 rounding: ``TOL_GRAD``);
* the remat policies: gradients equal to "none"'s (the same ops rerun);
* AdamW, clipping, the cosine schedule in f32: atol 1e-6;
* compression: int8 tensors identical, residuals to 1e-7 (f32 rounding);
* the whole train step with bf16 compute in both packages, 3 steps: loss
  and grad norm within 1e-2 relative (the frameworks round bf16 at other
  places; the measured gap is written beside the check), with the
  attention weights at their true fan-in;
* restart: the resumed run's losses equal the uninterrupted run's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.launch.mesh import make_smoke_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import ShapeConfig as JShapeConfig
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import model_defs as jmodel_defs
from repro.models import reduced_for_smoke as jreduced
from repro.models.layers import chunked_ce_loss as jce
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.storage import CheckpointManager as JCheckpointManager
from repro.storage import PmemTier as JPmemTier
from repro_torch.configs import get_config
from repro_torch.data import PipelineConfig, SyntheticTokens, make_batch
from repro_torch.launch import make_train_step
from repro_torch.launch.train import restore_state, train
from repro_torch.models import ShapeConfig, forward, from_jax_params, reduced_for_smoke
from repro_torch.models.layers import chunked_ce_loss
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_decompress,
    cosine_schedule,
    ef_init,
)
from repro_torch.optim.compression import _quantize
from repro_torch.storage import CheckpointManager, PmemTier
from repro_torch.tree import tree_leaves, tree_map

SEQ, BATCH = 64, 8
SHAPE = ShapeConfig(name="t", kind="train", seq_len=SEQ, global_batch=BATCH,
                    microbatches=2, q_chunk=32, kv_chunk=32, loss_chunk=32,
                    remat="none")
JSHAPE = JShapeConfig(**dataclasses.asdict(SHAPE))


#: per-leaf relative L2 of the f32 gradients.  gemma2-9b's (embedding
#: scaled by sqrt(d), softcaps) amplifies f32 rounding: at this seed the
#: reference's own f32 gradients lie 1.1e-4 from its f64 ones, the port's
#: 0.9e-4, and the two 1.5e-4 apart; qwen2.5-3b's lie within 1e-4.
#: recurrentgemma-9b's first RG-LRU layer does the same: its ``wa`` and
#: ``lam`` gradients lie 1.3e-4 and 1.4e-4 from the reference's f64 ones
#: in both packages, and 1.89e-4 apart (the worst leaf, the same at 1, 3
#: and 8 threads); mamba2-2.7b's lie within 1.4e-6.  deepseek-v2-lite-16b's
#: (MLA, MoE with a shared expert) lie within 1.2e-5, dbrx-132b's (GQA,
#: MoE) within 8.7e-6.
TOL_GRAD = {"qwen2.5-3b": 1e-4, "gemma2-9b": 2e-4, "mamba2-2.7b": 2e-4,
            "recurrentgemma-9b": 2e-4, "deepseek-v2-lite-16b": 1e-4,
            "dbrx-132b": 1e-4}


def _cfgs(arch, window=None):
    """Both packages' reduced config; ``window`` shortens every local
    layer's window so that it masks at the test's length."""
    jcfg, cfg = jreduced(jget_config(arch)), reduced_for_smoke(get_config(arch))
    if window is not None:
        jcfg = dataclasses.replace(jcfg, pattern=tuple(
            dataclasses.replace(b, window=window) if b.mixer == "local" else b
            for b in jcfg.pattern))
        cfg = dataclasses.replace(cfg, pattern=tuple(
            dataclasses.replace(b, window=window) if b.mixer == "local" else b
            for b in cfg.pattern))
    return jcfg, cfg


def _jparams_f32(jcfg, seed=0):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jinit_params(jmodel_defs(jcfg), jax.random.PRNGKey(seed)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# -- whole-model gradients ----------------------------------------------------

@pytest.mark.parametrize("arch,window", [("qwen2.5-3b", None), ("gemma2-9b", 16),
                                         ("mamba2-2.7b", None),
                                         ("recurrentgemma-9b", 16),
                                         ("deepseek-v2-lite-16b", None),
                                         ("dbrx-132b", None)])
def test_model_gradients_match_jax_value_and_grad(arch, window):
    jcfg, cfg = _cfgs(arch, window)
    jp = _jparams_f32(jcfg)
    batch = make_batch(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=2), 3)
    batch["labels"][0, :5] = -100  # ignored positions

    def jloss(p):
        h, aux = jforward(p, jcfg, {"tokens": jnp.asarray(batch["tokens"])}, JSHAPE)
        loss, _ = jce(h, p["unembed"], jnp.asarray(batch["labels"]),
                      t_chunk=JSHAPE.loss_chunk, logit_softcap=jcfg.final_softcap)
        return loss + 0.01 * aux

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    tree_map(lambda t: t.requires_grad_(), tp)
    h, aux = forward(tp, cfg, {"tokens": torch.from_numpy(batch["tokens"])})
    loss, n = chunked_ce_loss(h, tp["unembed"], torch.from_numpy(batch["labels"]),
                              t_chunk=SHAPE.loss_chunk,
                              logit_softcap=cfg.final_softcap)
    total = loss + 0.01 * aux
    total.backward()
    assert int(n) == 2 * SEQ - 5
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-5)
    jleaves = jax.tree_util.tree_leaves(jg)
    tleaves = [t.grad for t in tree_leaves(tp)]
    assert len(jleaves) == len(tleaves)
    worst = max(_rel(t, j) for t, j in zip(tleaves, jleaves))
    assert worst <= TOL_GRAD[arch], worst


def _grads_under(policy, cfg, tp, batch):
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    h, aux = forward(leaves, cfg, {"tokens": torch.from_numpy(batch["tokens"])},
                     remat=policy)
    loss, _ = chunked_ce_loss(h, leaves["unembed"],
                              torch.from_numpy(batch["labels"]), t_chunk=32,
                              logit_softcap=cfg.final_softcap)
    (loss + 0.01 * aux).backward()
    return [t.grad for t in tree_leaves(leaves)]


@pytest.mark.parametrize("policy", ["full", "dots", "save_block_out"])
@pytest.mark.parametrize("arch,window", [
    ("gemma2-9b", 16),  # post-block norms: every branch
    ("mamba2-2.7b", None),  # the SSD chunk's autograd Function under remat
    ("recurrentgemma-9b", 16),  # the RG-LRU scan and local attention
    ("deepseek-v2-lite-16b", None),  # MLA's (192, 128) attention and MoE
    ("dbrx-132b", None),  # MoE beside GQA attention
])
def test_remat_policies_give_the_gradients_of_none(policy, arch, window):
    jcfg, cfg = _cfgs(arch, window)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, _jparams_f32(jcfg)),
                         cfg, "cpu")
    batch = make_batch(PipelineConfig(vocab=cfg.vocab, seq_len=SEQ,
                                      global_batch=2), 0)
    want = _grads_under("none", cfg, tp, batch)
    got = _grads_under(policy, cfg, tp, batch)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_remat_rejects_unknown_policy():
    _, cfg = _cfgs("qwen2.5-3b")
    with pytest.raises(ValueError, match="remat"):
        forward({}, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.int32)},
                remat="everything")


# -- optimizer, compression, pipeline ------------------------------------------

def _grad_tree(rng, scale=1.0):
    return {"a": rng.standard_normal((5, 3)).astype(np.float32) * scale,
            "b": [rng.standard_normal(7).astype(np.float32) * scale],
            "c": {"d": rng.standard_normal((2, 2, 2)).astype(np.float32) * scale}}


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("clip", [None, 1.0, 100.0])
def test_adamw_matches_reference(rng, clip):
    cfg = dict(lr=3e-2, weight_decay=0.1, grad_clip=clip)
    jp = _grad_tree(rng)
    tp = tree_map(torch.from_numpy, jax.tree_util.tree_map(np.copy, jp))
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate, tstate = jadamw.adamw_init(jp), adamw_init(tp)
    sched_j = jadamw.cosine_schedule(3e-2, 2, 6)
    sched_t = cosine_schedule(3e-2, 2, 6)
    for step in range(5):
        g = _grad_tree(rng, scale=10.0)
        jlr = sched_j(jstate.step)
        tlr = sched_t(tstate.step)
        np.testing.assert_allclose(float(tlr), float(jlr), atol=1e-6)
        jp, jstate, jn = jadamw.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), jstate,
            jadamw.AdamWConfig(**cfg), lr=jlr)
        tp, tstate, tn = adamw_update(tp, tree_map(torch.from_numpy, g), tstate,
                                      AdamWConfig(**cfg), lr=tlr)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(tree_leaves(tp), _np_leaves(jp)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
        for a, b in zip(tree_leaves(tstate.mu) + tree_leaves(tstate.nu),
                        _np_leaves(jstate.mu) + _np_leaves(jstate.nu)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 5


def test_clip_and_schedule_match_reference():
    g = {"a": np.full((4,), 10.0, np.float32)}
    tc, tn = clip_by_global_norm(tree_map(torch.from_numpy, g), 1.0)
    jc, jn = jadamw.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    assert float(tn) == pytest.approx(float(jn)) == pytest.approx(20.0)
    np.testing.assert_allclose(tc["a"].numpy(), np.asarray(jc["a"]), atol=1e-6)
    ts, js = cosine_schedule(1.0, 10, 100, 0.1), jadamw.cosine_schedule(1.0, 10, 100, 0.1)
    for s in (0, 3, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(ts(torch.tensor(s, dtype=torch.int32))),
                                   float(js(jnp.int32(s))), atol=1e-6)


def test_adamw_converges_on_quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.3, weight_decay=0.0)
    for _ in range(150):
        params, opt, _ = adamw_update(params, {"x": 2 * params["x"]}, opt, cfg)
    assert float(params["x"].abs().max()) < 1e-2


def test_compression_matches_reference(rng):
    grads = [_grad_tree(rng) for _ in range(4)]
    grads[1]["a"][0, 0] = 0.5 * (np.abs(grads[1]["a"]).max())  # a .5 tie
    jef = jcomp.ef_init(jax.tree_util.tree_map(jnp.asarray, grads[0]))
    tef = ef_init(tree_map(torch.from_numpy, grads[0]))
    for g in grads:
        jg, jef, jerr = jcomp.compress_decompress(
            jax.tree_util.tree_map(jnp.asarray, g), jef)
        tg, tef, terr = compress_decompress(tree_map(torch.from_numpy, g), tef)
        for a, b in zip(tree_leaves(tg), _np_leaves(jg)):
            np.testing.assert_array_equal(a.numpy(), b)
        for a, b in zip(tree_leaves(tef.residual), _np_leaves(jef.residual)):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-7)
        np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-6)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:3] = [0.5, 1.5, -2.5]  # exact halves after scaling by 1
    x[3] = 127.0
    tq, ts = _quantize(torch.from_numpy(x))
    jq, js = jcomp._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=16, global_batch=4),
    dict(vocab=151936, seq_len=33, global_batch=3, seed=7, p_rule=0.5),
    dict(vocab=50, seq_len=8, global_batch=4, process_index=1, process_count=2),
])
def test_make_batch_is_byte_identical(kw):
    for step in (0, 1, 17):
        a = make_batch(PipelineConfig(**kw), step)
        b = jmake_batch(JPipelineConfig(**kw), step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_synthetic_tokens_resume_mid_stream():
    pipe = PipelineConfig(vocab=50, seq_len=8, global_batch=2)
    it = SyntheticTokens(pipe, start_step=3)
    try:
        np.testing.assert_array_equal(next(it)["tokens"], make_batch(pipe, 3)["tokens"])
        np.testing.assert_array_equal(next(it)["tokens"], make_batch(pipe, 4)["tokens"])
    finally:
        it.close()


# -- the train step -------------------------------------------------------------

def _port_state(cfg, jp):
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    return params, adamw_init(params)


def _fan_in_attention(jp, jcfg):
    """The attention projections rescaled to their true fan-in (d_model
    for wq/wk/wv, H * dh for wo).  The shared init rule counts wq's fan-in
    as its head count (4 here), which saturates every softmax of the
    reduced model and makes its bf16 gradients chaotic: from one state the
    port's own bf16 and f32 grad norms then differ by 3-15 %, and so do
    the two packages'.  ``chip_smoke.py`` draws its weights the same way."""
    for blk in jp["body"]:
        m = blk["mixer"]
        for k in ("wq", "wk", "wv"):
            m[k] = m[k] * np.sqrt(m[k].shape[-2] / jcfg.d_model)
        m["wo"] = m["wo"] * np.sqrt(m["wo"].shape[-2]
                                    / (m["wo"].shape[-3] * m["wo"].shape[-2]))
    return jp


def test_train_step_matches_reference():
    """3 steps side by side, bf16 compute in both packages, from the same
    f32 masters (attention at its true fan-in: ``_fan_in_attention``).
    Measured gap: loss <= 3.2e-4 relative, grad norm <= 2.1e-3; held to
    1e-2."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    opt_cfg = dict(lr=3e-3, weight_decay=0.0)
    mesh = make_smoke_mesh()
    jfn = jmake_train_step(jcfg, JSHAPE, mesh,
                           jadamw.AdamWConfig(**opt_cfg)).jitted(mesh)
    jp = _fan_in_attention(_jparams_f32(jcfg), jcfg)
    params, opt = _port_state(cfg, jp)
    jopt = jadamw.adamw_init(jp)
    fn = make_train_step(cfg, SHAPE, AdamWConfig(**opt_cfg), device="cpu")
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH)
    for step in range(3):
        batch = make_batch(pipe, step)
        jp, jopt, jm = jfn(jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, opt, m = fn(params, opt, batch)
        assert int(m["step"]) == int(jm["step"]) == step + 1
        assert int(m["tokens"]) == int(jm["tokens"]) == BATCH * SEQ
        for key in ("loss", "grad_norm"):
            assert _rel(float(m[key]), float(jm[key])) <= 1e-2, (
                step, key, float(m[key]), float(jm[key]))


def _train(steps, shape=SHAPE, lr=3e-3, compress=False, seed=0):
    jcfg, cfg = _cfgs("qwen2.5-3b")
    params, opt = _port_state(cfg, _jparams_f32(jcfg, seed))
    fn = make_train_step(cfg, shape, AdamWConfig(lr=lr, weight_decay=0.0),
                         compress_grads=compress, device="cpu")
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                          global_batch=shape.global_batch)
    ef = ef_init(params) if compress else None
    losses = []
    for step in range(steps):
        out = fn(params, opt, make_batch(pipe, step), *((ef,) if compress else ()))
        params, opt, m = out[:3]
        if compress:
            ef = out[3]
            assert float(m["compression_err"]) > 0
        losses.append(float(m["loss"]))
    return losses


def test_training_reduces_loss():
    losses = _train(15)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.85, losses[::4]


def test_microbatching_equivalence():
    """n_mb = 1 and 2 give (near-)identical gradients: the same loss path."""
    outs = [_train(3, dataclasses.replace(SHAPE, microbatches=n), lr=1e-3)[-1]
            for n in (1, 2)]
    assert abs(outs[0] - outs[1]) < 0.05, outs


def test_compressed_grads_still_learn():
    losses = _train(12, compress=True)
    assert losses[-1] < losses[0] - 0.5, losses[::5]


# -- checkpoints ----------------------------------------------------------------

def test_restart_replays_the_same_losses(tmp_path):
    """A crash after step 6 restores step 4's checkpoint from the PMEM tier
    and replays steps 5-8 with the uninterrupted run's losses."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    opt_cfg = AdamWConfig(lr=3e-3, weight_decay=0.0)
    runs = []
    for name, fail_at in (("clean", None), ("crash", 6)):
        params, _ = _port_state(cfg, _jparams_f32(jcfg))
        ckpt = CheckpointManager(PmemTier(str(tmp_path / name)), "t", keep=2)
        try:
            runs.append(train(cfg, SHAPE, opt_cfg, ckpt, steps=8,
                              checkpoint_every=4, fail_at=fail_at, device="cpu",
                              params=params, log=lambda s: None))
        finally:
            ckpt.close()
    clean, crash = ([(h["step"], h["loss"]) for h in r["history"]] for r in runs)
    assert [s for s, _ in crash] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    assert crash[:6] + crash[8:] == clean
    assert crash[6:8] == clean[4:6]  # the replay equals the first pass
    assert runs[1]["restores"][0]["step"] == 4
    assert [s.step for s in runs[1]["saves"]] == [4, 8]


def _train_run(cfg, jcfg, ckpt_dir, steps, fail_at=None, compress=False):
    params, _ = _port_state(cfg, _jparams_f32(jcfg))
    ckpt = CheckpointManager(PmemTier(str(ckpt_dir)), "t", keep=2)
    try:
        return train(cfg, SHAPE, AdamWConfig(lr=3e-3, weight_decay=0.0), ckpt,
                     steps=steps, checkpoint_every=4, fail_at=fail_at,
                     compress_grads=compress, device="cpu", params=params,
                     log=lambda s: None)
    finally:
        ckpt.close()


def test_compressed_restart_replays_the_same_losses(tmp_path):
    """With int8 gradient compression the error-feedback residual is state:
    it is checkpointed under "ef" and restored at the crash, so the replay
    of steps 5-8 equals the uninterrupted run's losses."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    runs = [_train_run(cfg, jcfg, tmp_path / name, 8, fail_at, compress=True)
            for name, fail_at in (("clean", None), ("crash", 6))]
    clean, crash = ([(h["step"], h["loss"]) for h in r["history"]] for r in runs)
    assert [s for s, _ in crash] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    assert crash[:6] + crash[8:] == clean
    assert crash[6:8] == clean[4:6]
    assert runs[1]["restores"][0]["step"] == 4
    ckpt = CheckpointManager(PmemTier(str(tmp_path / "crash")), "t", keep=2)
    try:
        state = ckpt.restore(8)
    finally:
        ckpt.close()
    assert sorted(state) == ["ef", "opt", "params"]
    assert len(state["ef"]) == len(state["params"])
    assert any(np.abs(np.asarray(r)).max() > 0 for r in state["ef"])


def test_compressed_run_resumes_its_residual_at_start(tmp_path):
    """A compressed run stopped after step 4's checkpoint and started again
    reads the residual from it: steps 5-8 equal an uninterrupted run's."""
    jcfg, cfg = _cfgs("qwen2.5-3b")
    clean = _train_run(cfg, jcfg, tmp_path / "clean", 8, compress=True)
    _train_run(cfg, jcfg, tmp_path / "split", 4, compress=True)
    resumed = _train_run(cfg, jcfg, tmp_path / "split", 8, compress=True)
    want = [(h["step"], h["loss"]) for h in clean["history"]][4:]
    assert [(h["step"], h["loss"]) for h in resumed["history"]] == want


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, cfg = _cfgs("qwen2.5-3b")
    jp = _jparams_f32(jcfg)
    jopt = jadamw.adamw_init(jp)
    jopt = jopt._replace(mu=jax.tree_util.tree_map(lambda x: x + 1.5, jopt.mu),
                         step=jnp.int32(7))
    ck = JCheckpointManager(JPmemTier(str(tmp_path)), "train/x", keep=2)
    ck.save(7, {"params": jax.tree_util.tree_leaves(jp),
                "opt": jax.tree_util.tree_leaves(jopt)}, block=True)
    ck.close()
    port = CheckpointManager(PmemTier(str(tmp_path)), "train/x", keep=2)
    try:
        assert port.latest_step() == 7
        params, opt = restore_state(port, cfg, "cpu")
    finally:
        port.close()
    got = tree_leaves(params) + tree_leaves(opt)
    want = _np_leaves(jp) + _np_leaves(jopt)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    assert int(opt.step) == 7
    # and back: the port's checkpoint restores in the reference
    port = CheckpointManager(PmemTier(str(tmp_path / "back")), "p", keep=1)
    port.save(3, {"params": tree_leaves(params), "opt": tree_leaves(opt)}, block=True)
    port.close()
    back = JCheckpointManager(JPmemTier(str(tmp_path / "back")), "p").restore()
    for a, b in zip(back["params"] + back["opt"], want):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_launcher_trains_a_reduced_mamba2(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch mamba2-2.7b`` on the CPU
    (a reduced model, the SSD chunk's autograd Function on its plain
    versions): 15 steps, the loss logged every 5 falls, and the run
    checkpoints."""
    from repro_torch.launch.train import main

    main(["--arch", "mamba2-2.7b", "--steps", "15", "--batch", "4", "--seq", "32",
          "--device", "cpu", "--checkpoint-every", "15",
          "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    losses = [float(line.split("loss")[1].split()[0])
              for line in out.splitlines() if line.startswith("step")]
    assert len(losses) == 3 and np.isfinite(losses).all(), out
    assert losses[0] > losses[1] > losses[2], losses
    assert "done: 15 steps" in out


def test_launcher_replays_a_crash_of_a_reduced_deepseek(tmp_path):
    """MLA and MoE through the launcher's own loop on the CPU: reduced
    deepseek-v2-lite-16b as ``launch.train``'s ``build`` makes it, 8
    steps of 4 sequences of 32 in 2 microbatches.  A crash after step 6
    restores step 4's checkpoint and replays steps 5-8 with the
    uninterrupted run's losses, bit for bit; the loss falls."""
    import argparse

    from repro_torch.launch.train import build

    cfg, shape = build(argparse.Namespace(arch="deepseek-v2-lite-16b", reduced=True,
                                          seq=32, batch=4, microbatches=2))
    assert cfg.mla is not None and cfg.moe is not None
    runs = []
    for name, fail_at in (("clean", None), ("crash", 6)):
        ckpt = CheckpointManager(PmemTier(str(tmp_path / name)), "t", keep=2)
        try:
            runs.append(train(cfg, shape, AdamWConfig(lr=3e-3, weight_decay=0.0),
                              ckpt, steps=8, checkpoint_every=4, fail_at=fail_at,
                              device="cpu", log=lambda s: None))
        finally:
            ckpt.close()
    clean, crash = ([(h["step"], h["loss"]) for h in r["history"]] for r in runs)
    assert [s for s, _ in crash] == [1, 2, 3, 4, 5, 6, 5, 6, 7, 8]
    assert crash[:6] + crash[8:] == clean
    assert crash[6:8] == clean[4:6]
    assert runs[1]["restores"][0]["step"] == 4
    losses = [x for _, x in clean]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
