#!/usr/bin/env python3
"""Check the port's sharded paths across four GPUs over NCCL.

    python3 chip_dist4.py [--seed N] [--device cpu] [--witness]

Run from the root of a checkout on a host with 4 GPUs (``--device cpu``:
4 gloo processes on the CPU at a reduced width, a rehearsal).  It spawns
4 ranks, one card each, which meet through a rendezvous file in a
temporary directory, and every rank checks:

1. ``device_histogram`` with its own shard of 2^24 Zipf(1.1) keys over
   32000 buckets on a (4,) mesh over "data" and on a (2, 2) mesh over
   ("data", "model") (each "model" pair passing the same shard): at
   capacity factor 8, where nothing drops, the counts byte for byte and
   the accounting of the one-device call over the whole input on the
   rank's own card; at 0.05, dropping and spilling to a DRAM tier, those
   of ``storage_histogram`` over as many shards (the same plan, shard
   after shard in one process; the CPU tests hold it to the reference);
2. ``moe_apply_a2a`` and ``moe_apply_gather`` on the (2, 2) mesh for one
   deepseek-v2-lite-16b MoE layer at full width (64 experts, 32 a rank;
   d_model 2048 sliced over "data" unless ``zero1``), 2 x 256 tokens at
   capacity factor 16 (no entry drops): within 2e-4 of
   ``moe_apply_dense`` on one card in f32 (``zero1`` both ways), and in
   bf16 within relative L2 2e-2 of the dense path in f32; ``moe_apply``
   takes a2a at T 256 and gather at T 1;
3. the sharded train step (``make_train_step(mesh=...)``) on a (2, 2) and
   a (4, 1) mesh against the one-process step on the rank's own card,
   both computing in f32 (``launch.steps.COMPUTE_DTYPE``): qwen2.5-3b at
   full width cut to 2 layers, 2 steps of 8 sequences of 1024 in 2
   microbatches, remat "full", from the same parameters, drawn as
   ``chip_smoke.py``'s training phases draw them (attention at its true
   fan-in): losses and grad norms within 1e-5 relative, the update
   (``p2 - p0`` over the whole tree) within 2e-3 relative L2 (the bound
   ``tests/test_torch_launch.py`` holds the example's update to, for
   AdamW's near-sign first steps), and the flash forward and
   backward launched; the final parameters' relative L2 is printed.  The
   same comparison from the shared init rule's draw is printed, not
   held: with it the (4, 1) mesh, pure data parallelism, departs as far
   as (2, 2) does.

4. the sharded step of the other mixers and of MoE on a mesh, in f32
   from the training phases' draw, 2 steps of TRAIN_SHAPE (recurrentgemma
   at half its batch and sequence) against the one-process step on the
   rank's own card (``MIXER_CASES``): mamba2-2.7b
   cut to 2 layers on (1, 4) and (2, 2) (TP over the SSM heads),
   recurrentgemma-9b at one (R, R, L) period on (2, 2) (TP over the
   RG-LRU width, attention over heads), deepseek-v2-lite-16b at its
   prelude and 1 MoE period on (4, 1) at capacity factor 1.25 (MoE routed
   over the whole microbatch from each rank's rows) and on (2, 2) where
   no entry drops and with no balance loss (the a2a path, MLA over
   heads): losses and grad norms within 1e-5 relative, the update within
   2e-3 relative L2, each path's kernels launched.  On (4, 1) it also
   prints how many routed entries take another expert or another keep
   than the one-process step's route of the same rows.

5. prefill and decode on a mesh (``make_prefill_step`` and
   ``make_decode_step(mesh=...)``), in f32 from the training phases'
   draw, against the one-process steps on the rank's own card
   (``SERVE_CASES``): qwen2.5-3b cut to 2 layers on (1, 4) and (2, 2)
   (the KV cache cut on the sequence over TP, the blocks' partial
   attentions combined through their log-sum-exps), and on (2, 2) from
   its cache quantized to int8; mamba2-2.7b cut to 2 layers on (1, 4)
   (the SSM state by heads, the conv window by channels);
   recurrentgemma-9b at one (R, R, L) period on (2, 2) with prompts of
   2100 tokens, longer than its 2048-slot ring, which wraps across the
   blocks; deepseek-v2-lite-16b at its prelude and 1 MoE period on (4, 1)
   and (2, 2) at capacity factor 8 (the MLA latents cut on the sequence).
   Each case prefills 2 prompts and decodes 8 steps teacher-forced on the
   one-process run's greedy tokens: every step's logits and every leaf of
   the unsharded final cache within 1e-5 relative L2 (the int8 case: the
   logits within 1e-3 and the int8 levels at most one apart on at most
   1e-3 of the entries, since a TP sum that rounds apart moves a value
   at a rounding boundary one level), the same greedy tokens, and the
   prefill's kernel and decode launched.  ``--serve-only`` runs this
   check alone.

``--witness`` runs on one card with no process group: check 3's
one-process step, from both draws, against itself at 4 and 8
microbatches (the rows a forward that a rank of (2, 2) and of (4, 1)
computes), printed, not held.  It tells whether a draw's departure comes
with the shapes and the order of the sums, with no sharded code involved.

It measures no time.  Rank 0 prints one JSON line per check, then the
card's name and power limit, and last ``{"ok": true, ...}``; a rank that
fails makes the script exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
WORLD = 4
TOKENS = 1 << 24
VOCAB = 32000
MOE_MODEL = "deepseek-v2-lite-16b"
MOE_SHAPE = (2, 256)
F32_LIMIT = 2e-4
BF16_LIMIT = 2e-2
TRAIN_MODEL = "qwen2.5-3b"
TRAIN_LAYERS = 2
TRAIN_SHAPE = (8, 1024, 2)  # (batch, seq, microbatches); seq 32 on the CPU
TRAIN_STEPS = 2
LOSS_LIMIT = 1e-5  # losses and grad norms, relative
UPDATE_LIMIT = 2e-3  # the update p2 - p0, relative L2 over the whole tree
WITNESS_MICROBATCHES = (4, 8)  # --witness: 2 and 1 rows a forward
#: check 4: (name, model, body periods, mesh, capacity factor or None,
#: balance loss coefficient, (global batch, sequence length) on the card).
#: recurrentgemma-9b's one-process f32 step holds 52 GB of masters,
#: gradients and moments: at half TRAIN_SHAPE's batch and sequence its
#: activations fit beside them (2 rows of 512 a microbatch)
MIXER_CASES = (
    ("mamba2_1x4", "mamba2-2.7b", 2, (1, 4), None, 0.01, TRAIN_SHAPE[:2]),
    ("mamba2_2x2", "mamba2-2.7b", 2, (2, 2), None, 0.01, TRAIN_SHAPE[:2]),
    ("recurrentgemma_2x2", "recurrentgemma-9b", 1, (2, 2), None, 0.01, (4, 512)),
    ("deepseek_4x1", "deepseek-v2-lite-16b", 1, (4, 1), 1.25, 0.01, TRAIN_SHAPE[:2]),
    ("deepseek_a2a_2x2", "deepseek-v2-lite-16b", 1, (2, 2), 8.0, 0.0, TRAIN_SHAPE[:2]),
)
#: check 5: (name, model, body periods, mesh, capacity factor or None,
#: prompt tokens on the card, int8 cache)
SERVE_CASES = (
    ("qwen_1x4", "qwen2.5-3b", 2, (1, 4), None, 1024, False),
    ("qwen_2x2", "qwen2.5-3b", 2, (2, 2), None, 1024, False),
    ("qwen_2x2_int8", "qwen2.5-3b", 2, (2, 2), None, 1024, True),
    ("mamba2_1x4", "mamba2-2.7b", 2, (1, 4), None, 1024, False),
    ("recurrentgemma_2x2", "recurrentgemma-9b", 1, (2, 2), None, 2100, False),
    ("deepseek_4x1", "deepseek-v2-lite-16b", 1, (4, 1), 8.0, 1024, False),
    ("deepseek_2x2", "deepseek-v2-lite-16b", 1, (2, 2), 8.0, 1024, False),
)
SERVE_PROMPTS = 2
SERVE_STEPS = 8
SERVE_HEADROOM = 16  # cache rows past the prompt
SERVE_LIMIT = 1e-5  # every step's logits and every cache leaf, relative L2
INT8_LOGIT_LIMIT = 1e-3  # the int8 case's logits
INT8_FLIPS = 1e-3  # the int8 case: the share of int8 entries one level apart


#: (shape, device type) -> the (data, model) mesh over it: each new mesh
#: makes new NCCL communicators, whose buffers stay on the card
_MESHES: dict = {}


def _mesh(shape, device_type: str):
    """The ("data", "model") mesh of ``shape``, made once a run."""
    from repro_torch.launch import make_mesh_compat

    key = (tuple(shape), device_type)
    if key not in _MESHES:
        _MESHES[key] = make_mesh_compat(shape, ("data", "model"), device_type)
    return _MESHES[key]


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


def _cast(tree, dtype):
    """Every leaf but the f32 router cast to ``dtype``."""
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v if k == "router" else v.to(dtype) for k, v in tree.items()}


def _rank(rank: int, seed: int, device_type: str, rdzv: str,
          serve_only: bool) -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import device_histogram, storage_histogram
    from repro_torch.launch import make_mesh_compat, process_group
    from repro_torch.models import init_params, moe, reduced_for_smoke
    from repro_torch.storage import DramTier

    def report(check: str, ok: bool, **fields) -> None:
        if rank == 0:
            print(json.dumps({"check": check, "ok": ok, **fields}), flush=True)
        if not ok:
            raise AssertionError(f"rank {rank}: {check} {fields}")

    with process_group(rank, WORLD, rdzv, device_type):
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if device_type == "cuda" else torch.device("cpu")
        if serve_only:
            _sharded_serve(rank, seed, device_type, dev, report)
            return
        meshes = {"4": make_mesh_compat((4,), ("data",), device_type),
                  "2x2": _mesh((2, 2), device_type)}
        n = TOKENS if device_type == "cuda" else 1 << 16
        g = torch.Generator().manual_seed(seed)
        cdf = torch.cumsum(torch.arange(1, VOCAB + 1, dtype=torch.float64) ** -1.1, 0)
        keys = torch.searchsorted((cdf / cdf[-1]).float(), torch.rand(n, generator=g),
                                  out_int32=True).clamp_(max=VOCAB - 1).to(dev)
        values = torch.ones_like(keys)
        keys_h, values_h = keys.cpu().numpy(), values.cpu().numpy()
        fields = ("dropped", "shuffled_bytes", "spilled", "spilled_bytes")
        for cf, spill in ((8.0, False), (0.05, False), (0.05, True)):
            tier = DramTier if spill else (lambda: None)
            for name, mesh in meshes.items():
                ndev = mesh.size(0)
                me = mesh.get_local_rank("data")
                part = -(-n // ndev)
                got = device_histogram(
                    keys[me * part:(me + 1) * part], values[me * part:(me + 1) * part],
                    vocab=VOCAB, capacity_factor=cf, spill_tier=tier(), mesh=mesh)
                if cf == 8.0:  # nothing drops: the one-device call's result
                    want = device_histogram(keys, values, 1, vocab=VOCAB,
                                            capacity_factor=cf, device=dev)
                    against = "one_device"
                else:  # the same plan, one shard after another, in one process
                    want = storage_histogram(keys_h, values_h, ndev, DramTier(),
                                             vocab=VOCAB, capacity_factor=cf,
                                             spill=spill, device=dev)
                    against = "storage_histogram"
                ok = (got.counts.dtype == want.counts.dtype
                      and torch.equal(got.counts, want.counts)
                      and all(int(getattr(got, f)) == int(getattr(want, f))
                              for f in fields))
                report("device_histogram", ok, mesh=name, tokens=n, vocab=VOCAB,
                       capacity_factor=cf, spill=spill, against=against,
                       byte_equal=ok, spilled=int(got.spilled),
                       dropped=int(got.dropped))

        cfg = get_config(MOE_MODEL)
        if device_type != "cuda":
            cfg = reduced_for_smoke(cfg)
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=16.0))
        # the same draw on every rank's card
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        p32 = init_params(moe.moe_defs(cfg), g, dev, dtype=torch.float32)
        B, T = MOE_SHAPE
        x32 = torch.randn((B, T, cfg.d_model), generator=g, device=dev)
        mesh = meshes["2x2"]
        paths = {"a2a": moe.moe_apply_a2a, "gather": moe.moe_apply_gather}
        with torch.no_grad():
            want, _ = moe.moe_apply_dense(p32, x32, cfg)
            for zero1 in (False, True):
                local = moe.shard_params(p32, mesh, zero1=zero1)
                for name, fn in paths.items():
                    got, _ = fn(local, x32, cfg, mesh, ("data",), "model", zero1)
                    err = float((got - want).abs().max())
                    ok = bool(torch.allclose(got, want, atol=F32_LIMIT, rtol=F32_LIMIT))
                    report("moe_f32", ok, path=name, zero1=zero1, max_abs_err=err,
                           w_gate_local=list(local["w_gate"].shape))
            p16 = _cast(p32, torch.bfloat16)
            x16 = x32.to(torch.bfloat16)
            want16, _ = moe.moe_apply_dense(_cast(p16, torch.float32), x16.float(), cfg)
            local = moe.shard_params(p16, mesh)
            for name, fn in paths.items():
                got, _ = fn(local, x16, cfg, mesh, ("data",), "model")
                rel = _rel_l2(got, want16)
                report("moe_bf16", rel <= BF16_LIMIT, path=name, rel_l2=rel)
            local = moe.shard_params(p32, mesh)
            for T_call, path in ((T, "a2a"), (1, "gather")):
                xs = x32[:, :T_call]
                picked, _ = moe.moe_apply(local, xs, cfg, mesh)
                explicit, _ = paths[path](local, xs, cfg, mesh, ("data",), "model")
                dense, _ = moe.moe_apply_dense(p32, xs, cfg)
                err = float((picked - dense).abs().max())
                ok = torch.equal(picked, explicit) and bool(
                    torch.allclose(picked, dense, atol=F32_LIMIT, rtol=F32_LIMIT))
                report("moe_apply", ok, T=T_call, path=path, max_abs_err=err)
        del p32, x32, p16, x16, local, want, want16
        _sharded_train(rank, seed, device_type, dev, report)
        _sharded_mixers(rank, seed, device_type, dev, report)
        _sharded_serve(rank, seed, device_type, dev, report)


def _train_setup(device_type: str):
    """Check 3's model, f32 compute, batches and optimizer; returns
    ``(cfg, shape_of(microbatches), batches, opt_cfg)``."""
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import ShapeConfig, reduced_for_smoke
    from repro_torch.optim import AdamWConfig

    steps.COMPUTE_DTYPE = torch.float32
    cfg = replace(get_config(TRAIN_MODEL), n_periods=TRAIN_LAYERS)
    B, T, _ = TRAIN_SHAPE
    if device_type != "cuda":
        cfg, T = reduced_for_smoke(cfg), 32

    def shape_of(n_mb: int) -> "ShapeConfig":
        return ShapeConfig(name="train_f32", kind="train", seq_len=T, global_batch=B,
                           microbatches=n_mb, q_chunk=512, kv_chunk=1024,
                           loss_chunk=512, remat="full")

    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=T, global_batch=B)
    batches = [make_batch(pipe, s) for s in range(TRAIN_STEPS)]
    return cfg, shape_of, batches, AdamWConfig(lr=3e-4, weight_decay=0.0)


def _draws(cfg, seed: int, dev):
    """The two parameter draws of check 3, each the same on every card:
    the training phases' (attention at its true fan-in) and the shared
    init rule's."""
    import chip_smoke
    from repro_torch.launch.train import init_state

    return (("fan_in", lambda: chip_smoke._draw_train_params(cfg, seed + 2, dev)),
            ("shared_init", lambda: init_state(cfg, dev, seed + 2)[0]))


def _train_run(cfg, shape, opt_cfg, batches, params0, dev, mesh=None,
               aux_coef: float = 0.01):
    """The steps of ``batches`` from a copy of ``params0`` (sharded on
    ``mesh``, or one process); returns (losses, grad norms, the whole final
    parameters, the path's forward and backward kernel launches: the SSD
    chunk's for Mamba-2, flash attention's otherwise)."""
    import chip_smoke
    from repro_torch.launch import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import param_pspecs, shard_tree, unshard_tree
    from repro_torch.tree import tree_map

    params = tree_map(lambda t: t.to(dev, copy=True), params0)
    specs = None if mesh is None else param_pspecs(cfg, mesh)
    if specs is not None:
        params = shard_tree(params, specs, mesh)
    opt = adamw_init(params)
    fn = make_train_step(cfg, shape, opt_cfg, aux_coef=aux_coef, device=dev, mesh=mesh)
    (fa, fb), _ = chip_smoke._kernel_pair(cfg)
    launches = (fa.launches, fb.launches)
    losses, norms = [], []
    for batch in batches:
        params, opt, m = fn(params, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = (fa.launches - launches[0], fb.launches - launches[1])
    del opt
    if specs is not None:
        params = unshard_tree(params, specs, mesh)
    return losses, norms, params, launches


def _compare(got, want, p0) -> dict:
    """How far run ``got`` departs from run ``want`` (each
    :func:`_train_run`'s result) that started from ``p0``."""
    from repro_torch.tree import tree_leaves

    def rel_l2(pairs) -> float:
        """Relative L2 over the whole tree, leaf by leaf (a whole tree of
        differences at once would not fit beside two runs' results)."""
        diff = norm = 0.0
        for a, b in pairs:
            diff += float((a.double() - b.double()).square().sum())
            norm += float(b.double().square().sum())
        return (diff / norm) ** 0.5

    p0 = tree_leaves(p0)  # on the card or on the host
    got_p, want_p = tree_leaves(got[2]), tree_leaves(want[2])
    return dict(
        losses=got[0], want_losses=want[0], grad_norms=got[1], want_grad_norms=want[1],
        loss_rel=max(abs(a - b) / abs(b) for a, b in zip(got[0], want[0])),
        grad_norm_rel=[abs(a - b) / abs(b) for a, b in zip(got[1], want[1])],
        update_rel_l2=rel_l2((a - p.to(a.device), b - p.to(a.device))
                             for a, b, p in zip(got_p, want_p, p0)),
        params_rel_l2=rel_l2(zip(got_p, want_p)))


def _sharded_train(rank: int, seed: int, device_type: str, dev, report) -> None:
    """Check 3: the sharded step against the one-process step, in f32."""
    from repro_torch.launch import make_mesh_compat

    cfg, shape_of, batches, opt_cfg = _train_setup(device_type)
    shape = shape_of(TRAIN_SHAPE[2])
    # the training phases' draw, held; the shared init rule's, printed
    for draw, make in _draws(cfg, seed, dev):
        params0 = make()
        want = _train_run(cfg, shape, opt_cfg, batches, params0, dev)
        for name, mesh_shape in (("2x2", (2, 2)), ("4x1", (4, 1))):
            mesh = _mesh(mesh_shape, device_type)
            got = _train_run(cfg, shape, opt_cfg, batches, params0, dev, mesh)
            gap = _compare(got, want, params0)
            launches = got[3]
            ran = device_type != "cuda" or min(launches) > 0
            held = draw == "fan_in"
            report("sharded_train_f32", not held or (
                gap["loss_rel"] <= LOSS_LIMIT and max(gap["grad_norm_rel"]) <= LOSS_LIMIT
                and gap["update_rel_l2"] <= UPDATE_LIMIT and ran), draw=draw, held=held,
                mesh=name, model=cfg.name, layers=cfg.n_layers, seq=shape.seq_len,
                flash_launches=launches[0], flash_bwd_launches=launches[1], **gap)
            del got
        del params0, want


class _RouteLog:
    """Within it, every MoE route records its experts (N, k) and which
    entries its capacity keeps, in entry order (``moe._top_k`` and
    ``moe._pack_by_group`` wrapped), call by call."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.calls = moe, []
        self.saved = (moe._top_k, moe._pack_by_group)
        top_k, pack = self.saved

        def logged_top_k(*a, **k):
            res = top_k(*a, **k)
            self.calls.append({"experts": res[2]})
            return res

        def logged_pack(groups, *a, **k):
            order, gs, pos, keep = res = pack(groups, *a, **k)
            if self.calls and "keep" not in self.calls[-1]:
                entry = torch.empty_like(keep)
                entry[order] = keep
                self.calls[-1]["keep"] = entry
            return res

        moe._top_k, moe._pack_by_group = logged_top_k, logged_pack
        return self

    def __exit__(self, *exc):
        self.moe._top_k, self.moe._pack_by_group = self.saved
        return False


def _route_departures(got: list, want: list, rank: int, n_ranks: int) -> int:
    """Routed entries of this rank's rows (the ``rank``-th of ``n_ranks``
    blocks of each one-process call's) whose expert or keep differs, summed
    over the calls."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} MoE routes against {len(want)}")
    n = 0
    for g, w in zip(got, want):
        rows = w["experts"].shape[0] // n_ranks
        we = w["experts"][rank * rows:(rank + 1) * rows]
        k = we.shape[1]
        wk = w["keep"][rank * rows * k:(rank + 1) * rows * k].view(rows, k)
        n += int(((g["experts"] != we) | (g["keep"].view(rows, k) != wk)).sum())
    return n


def _sharded_mixers(rank: int, seed: int, device_type: str, dev, report) -> None:
    """Check 4: the sharded step of the SSM, RG-LRU and MLA/MoE
    configurations against the one-process step, in f32."""
    import chip_smoke
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import reduced_for_smoke
    from repro_torch.tree import tree_map

    _, shape_of, _, opt_cfg = _train_setup(device_type)
    for name, model, periods, mesh_shape, cf, aux, (batch, seq) in MIXER_CASES:
        shape = replace(shape_of(TRAIN_SHAPE[2]), global_batch=batch,
                        seq_len=seq if device_type == "cuda" else 32)
        cfg = replace(get_config(model), n_periods=periods)
        if device_type != "cuda":
            cfg = reduced_for_smoke(cfg)
        if cf is not None:
            cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
        batches = _batches(cfg, shape)
        # on the host: recurrentgemma-9b's period holds 13 GB of f32 masters,
        # and a one-process run adds as much in gradients and twice in moments
        params0 = tree_map(lambda t: t.cpu(),
                           chip_smoke._draw_train_params(cfg, seed + 3, dev))
        mesh = _mesh(mesh_shape, device_type)
        with _RouteLog() as want_routes:
            want = _train_run(cfg, shape, opt_cfg, batches, params0, dev, aux_coef=aux)
        with _RouteLog() as got_routes:
            got = _train_run(cfg, shape, opt_cfg, batches, params0, dev, mesh,
                             aux_coef=aux)
        gap = _compare(got, want, params0)
        extra = {}
        if mesh_shape == (4, 1) and cfg.moe is not None:
            moved = torch.tensor(_route_departures(
                got_routes.calls, want_routes.calls, rank, 4), device=dev)
            dist.all_reduce(moved)
            extra["route_departures"] = int(moved)
        launches = got[3]
        report("sharded_mixers_f32", gap["loss_rel"] <= LOSS_LIMIT
               and max(gap["grad_norm_rel"]) <= LOSS_LIMIT
               and gap["update_rel_l2"] <= UPDATE_LIMIT
               and (device_type != "cuda" or min(launches) > 0),
               case=name, model=cfg.name, layers=cfg.n_layers, seq=shape.seq_len,
               batch=batch,
               mesh=list(mesh_shape), capacity_factor=cfg.moe.capacity_factor
               if cfg.moe is not None else None, aux_coef=aux,
               kernel_launches=list(launches), **extra, **gap)
        del got, want, params0, want_routes, got_routes
        chip_smoke.free_card()


def _serve_run(cfg, params0, prompts, forced, dev, mesh, quant: bool, cache_len: int):
    """Prefill ``prompts`` into ``cache_len`` rows, then decode SERVE_STEPS
    steps (teacher-forced on ``forced``, else greedy) from a copy of
    ``params0`` on ``mesh`` (None: one process).  Returns (every step's
    logits, prefill first, whole; the tokens each step was fed; the whole
    final cache's leaves; the prefill's flash or SSD launches; decode's
    launches)."""
    import chip_smoke
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import make_decode_step, make_prefill_step, steps
    from repro_torch.models import ShapeConfig
    from repro_torch.parallel.sharding import (
        P, batch_entry, cache_pspecs, param_pspecs, shard_tree, unshard_tree)
    from repro_torch.tree import tree_leaves, tree_map

    B, T = prompts.shape
    params = tree_map(lambda t: t.to(dev, copy=True), params0)
    rows = lambda t: t  # noqa: E731
    if mesh is not None:
        params = shard_tree(params, param_pspecs(cfg, mesh), mesh)
        b = batch_entry(mesh, B)
        rows = lambda t: shard_tree(t, P(b, *([None] * (t.dim() - 1))), mesh)  # noqa: E731
    dshape = ShapeConfig("d", "decode", cache_len, B)
    prefill = make_prefill_step(cfg, ShapeConfig("p", "prefill", T, B),
                                cache_len=cache_len, mesh=mesh)
    decode = make_decode_step(cfg, dshape, mesh=mesh, quant_cache=quant)
    kernel = ssd_scan if cfg.ssm is not None else fa
    seen, inner = [], steps.decode_step

    def keeping(*a, **kw):
        lo, c = inner(*a, **kw)
        seen.append(lo)
        return lo, c

    with torch.no_grad():
        before = kernel.launches
        logits, cache = prefill(params, {"tokens": rows(prompts)})
        pre = kernel.launches - before
        if quant:
            cache = chip_smoke._quantized(cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        if mesh is not None:
            tok = unshard_tree(tok, P(b, None), mesh)
        fed, before = [], da.launches
        steps.decode_step = keeping
        try:
            for i in range(SERVE_STEPS):
                tok = tok if forced is None else forced[i]
                fed.append(tok)
                tok, cache = decode(params, rows(tok), cache, T + i)
                if mesh is not None:
                    tok = unshard_tree(tok, P(b, None), mesh)
        finally:
            steps.decode_step = inner
        dec = da.launches - before
    del params
    los = [logits] + seen
    if mesh is not None:
        los = [unshard_tree(x, P(b, None), mesh) for x in los]
        cache = unshard_tree(cache, cache_pspecs(cfg, dshape, mesh, quant_attn=quant),
                             mesh)
    return los, fed, tree_leaves(cache), pre, dec


def _sharded_serve(rank: int, seed: int, device_type: str, dev, report) -> None:
    """Check 5: the serving steps on a mesh against the one-process steps,
    in f32, teacher-forced on the one-process run's tokens."""
    import chip_smoke

    from repro_torch.configs import get_config
    from repro_torch.models import reduced_for_smoke
    from repro_torch.tree import tree_map

    for name, model, periods, mesh_shape, cf, prompt, quant in SERVE_CASES:
        cfg = replace(get_config(model), n_periods=periods)
        if device_type != "cuda":
            cfg, prompt = reduced_for_smoke(cfg), 20
        if cf is not None:
            cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
        cache_len = prompt + SERVE_HEADROOM
        params0 = tree_map(lambda t: t.cpu(),
                           chip_smoke._draw_train_params(cfg, seed + 4, dev))
        g = torch.Generator().manual_seed(seed + 5)
        prompts = torch.randint(0, cfg.vocab, (SERVE_PROMPTS, prompt), generator=g,
                                dtype=torch.int32).to(dev)
        want = _serve_run(cfg, params0, prompts, None, dev, None, quant, cache_len)
        got = _serve_run(cfg, params0, prompts, want[1], dev,
                         _mesh(mesh_shape, device_type), quant, cache_len)
        steps_rel = [_rel_l2(a, b) for a, b in zip(got[0], want[0])]
        cache_rel, flips = [], 0.0
        for a, b in zip(got[2], want[2]):
            if a.dtype == torch.int8:
                off = (a.int() - b.int()).abs()
                flips = max(flips, float((off > 0).float().mean()))
                cache_rel.append(float(off.max()))  # levels apart
            else:
                cache_rel.append(_rel_l2(a, b))
        greedy = [torch.argmax(x, dim=-1) for x in got[0][:-1]]
        same_tokens = all(torch.equal(a.to(torch.int64)[:, 0], b)
                          for a, b in zip(want[1], greedy))
        if quant:
            ok = (max(steps_rel) <= INT8_LOGIT_LIMIT and flips <= INT8_FLIPS
                  and max(cache_rel) <= 1)
        else:
            ok = max(steps_rel) <= SERVE_LIMIT and max(cache_rel) <= SERVE_LIMIT
        ran = device_type != "cuda" or (got[3] > 0 and (
            got[4] > 0 or quant or cfg.mla is not None or cfg.ssm is not None))
        report("sharded_serve_f32", ok and same_tokens and ran, case=name,
               model=cfg.name, layers=cfg.n_layers, mesh=list(mesh_shape),
               prompts=SERVE_PROMPTS, prompt=prompt, cache_len=cache_len,
               steps=SERVE_STEPS, int8_cache=quant,
               capacity_factor=cf, logits_rel_l2=steps_rel,
               cache_worst=max(cache_rel), int8_flips=flips if quant else None,
               same_greedy_tokens=same_tokens, prefill_launches=got[3],
               decode_launches=got[4], one_process_launches=[want[3], want[4]])
        del got, want, params0
        chip_smoke.free_card()


def _batches(cfg, shape) -> list:
    """TRAIN_STEPS batches of ``shape`` for ``cfg``'s vocabulary."""
    from repro_torch.data import PipelineConfig, make_batch

    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                          global_batch=shape.global_batch)
    return [make_batch(pipe, s) for s in range(TRAIN_STEPS)]


def _witness(seed: int, device_type: str) -> None:
    """``--witness``, one card and no process group: check 3's one-process
    step with TRAIN_SHAPE's microbatches (4 rows a forward) against the
    same step with 4 and 8 microbatches (2 rows a forward, as a rank of
    the (2, 2) mesh runs them, and 1, as a rank of (4, 1)), from both
    draws.  The same function of the same parameters, summed in another
    order and computed at other shapes, with no sharded code on the way:
    it prints how far each departs, and holds nothing."""
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device(device_type)
    cfg, shape_of, batches, opt_cfg = _train_setup(device_type)
    for draw, make in _draws(cfg, seed, dev):
        params0 = make()
        want = _train_run(cfg, shape_of(TRAIN_SHAPE[2]), opt_cfg, batches, params0, dev)
        for n_mb in WITNESS_MICROBATCHES:
            got = _train_run(cfg, shape_of(n_mb), opt_cfg, batches, params0, dev)
            print(json.dumps({"check": "microbatch_witness", "draw": draw,
                              "microbatches": n_mb, "against": TRAIN_SHAPE[2],
                              "rows_a_forward": TRAIN_SHAPE[0] // n_mb,
                              "model": cfg.name, "layers": cfg.n_layers,
                              "seq": batches[0]["tokens"].shape[1],
                              **_compare(got, want, params0)}), flush=True)
            del got
        del params0, want


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--serve-only", action="store_true",
                    help="run check 5 (the serving steps on a mesh) alone")
    ap.add_argument("--witness", action="store_true",
                    help="on one card: check 3's one-process step at more "
                         "microbatches against its own (nothing held)")
    args = ap.parse_args(argv)
    need = 1 if args.witness else WORLD
    if args.device == "cuda" and torch.cuda.device_count() < need:
        print(f"chip_dist4: needs {need} GPUs, sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    import torch.multiprocessing as mp

    if args.device == "cuda":  # once, before the ranks load the kernels
        # check 4 fills a card with recurrentgemma-9b's f32 step: fewer
        # fragments between its gigabyte leaves
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        _build.build()
    if args.witness:
        _witness(args.seed, args.device)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_dist4_") as tmp:
            mp.start_processes(_rank, args=(args.seed, args.device,
                                            os.path.join(tmp, "rdzv"),
                                            args.serve_only),
                               nprocs=WORLD, join=True, start_method="spawn")
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    print("no multi-GPU time measured", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if args.device == "cuda" else "cpu",
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
