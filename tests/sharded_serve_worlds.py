"""Multi-rank runs for ``tests/test_torch_sharded_serve.py``, as a script.

    python tests/sharded_serve_worlds.py reference OUT  # JAX, 4 host devices
    python tests/sharded_serve_worlds.py port OUT       # gloo worlds of 1, 2, 4

The serving steps, prefill and decode, on a mesh.  The test writes each
variant's f32 parameters into ``OUT/init_{variant}.npz`` (leaves in the
reference's order), then runs both sides, each in a subprocess of its
own.  Every run prefills the same ``B`` prompts of ``T`` tokens into a
cache of ``L`` rows (the int8 cases quantize it, as the KV pager's
demotion does), then decodes ``STEPS`` steps teacher-forced on the same
tokens (``FORCED``), so that one flipped argmax cannot cascade, and
writes ``{ref,port,one}_{case}.npz``: the prefill's logits, each decode
step's logits and greedy tokens, and the final cache, whole (the
unsharded blocks of every rank):

* ``ref_*``: the reference's ``make_prefill_step``/``make_decode_step``
  jitted on a mesh of forced host devices (``REF_CASES``); its prefill
  cache is the prompt's length, padded to ``L`` before decode;
* ``port_*``: the port's steps on gloo worlds of 4 and 2 ranks (``CASES``
  by mesh size) and at world size 1 on a (1, 1) mesh (``W1_CASES``);
* ``one_*``: the port's one-process steps (``mesh=None``) of each
  distinct computation (:func:`one_key`).
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import replace

import numpy as np

DM = ("data", "model")
B, T, L, STEPS = 4, 20, 40, 8
#: a cache length neither 2 nor 4 divides: the global layers' caches stay
#: whole on every rank (``_tp_entry``)
ODD_L = 39
#: top-2 of 8 experts: at 8 no route drops an entry
NO_DROP = 8.0
#: variant -> (arch, fields replaced in the reduced config: "window" cuts
#: every local layer's window to 16, so that the prompt wraps the ring and
#: the decode steps (positions 20-27, slots 4-11) cross from one TP block
#: of it to the next; "capacity_factor" the MoE one).  The reduced
#: configs (4 heads) cut attention's head_dim over TP; qwen16 (16 heads
#: over 2 kv heads) cuts the q heads with the kv projections replicated,
#: qwen48 (48 over 6) splits a kv group unevenly, and mha16 cuts the kv
#: heads too.
VARIANTS = {
    "qwen": ("qwen2.5-3b", {}),
    "qwen16": ("qwen2.5-3b", {"n_heads": 16, "n_kv_heads": 2, "head_dim": 8}),
    "qwen48": ("qwen2.5-3b", {"n_heads": 48, "n_kv_heads": 6, "head_dim": 4}),
    "mha16": ("qwen2.5-3b", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 4}),
    "gemma2": ("gemma2-9b", {"window": 16}),
    "rg": ("recurrentgemma-9b", {"window": 16}),
    "mamba2": ("mamba2-2.7b", {}),
    "deepseek": ("deepseek-v2-lite-16b", {"capacity_factor": NO_DROP}),
}
#: case -> (variant, mesh shape, options: quant (the int8 cache), tp_only
#: (``param_fsdp=False``), cache_len (default L))
CASES = {
    # on 4 ranks
    "qwen_d2m2": ("qwen", (2, 2), {}),
    "qwen_d1m4": ("qwen", (1, 4), {}),
    "qwen_d2m2_quant": ("qwen", (2, 2), {"quant": True}),
    "qwen_d2m2_tponly": ("qwen", (2, 2), {"tp_only": True}),
    "qwen_d1m4_odd": ("qwen", (1, 4), {"cache_len": ODD_L}),
    "qwen16_d1m4": ("qwen16", (1, 4), {}),
    "qwen16_d1m4_quant": ("qwen16", (1, 4), {"quant": True}),
    "qwen48_d1m4": ("qwen48", (1, 4), {}),
    "mha16_d1m4": ("mha16", (1, 4), {}),
    "mha16_d2m2_odd": ("mha16", (2, 2), {"cache_len": ODD_L}),
    "gemma2_d2m2": ("gemma2", (2, 2), {}),
    "rg_d2m2": ("rg", (2, 2), {}),
    "rg_d1m4": ("rg", (1, 4), {}),
    "mamba2_d1m4": ("mamba2", (1, 4), {}),
    "deepseek_d4m1": ("deepseek", (4, 1), {}),
    "deepseek_d2m2": ("deepseek", (2, 2), {}),
    "deepseek_d1m4": ("deepseek", (1, 4), {}),
    # on 2 ranks
    "qwen_d2m1": ("qwen", (2, 1), {}),
    "qwen_d1m2": ("qwen", (1, 2), {}),
    "mha16_d1m2": ("mha16", (1, 2), {}),
    "rg_d1m2": ("rg", (1, 2), {}),
    "mamba2_d1m2": ("mamba2", (1, 2), {}),
    "deepseek_d1m2_odd": ("deepseek", (1, 2), {"cache_len": ODD_L}),
}
#: the reference runs these of CASES (none of them with options)
REF_CASES = ("qwen_d2m2", "gemma2_d2m2", "rg_d2m2", "mamba2_d1m4", "deepseek_d2m2")
#: world size 1, a (1, 1) mesh: the steps are the one-process ones
W1_CASES = {f"{v}_w1": (v, (1, 1), {}) for v in ("qwen", "rg", "mamba2", "deepseek")}
W1_CASES["qwen_w1_quant"] = ("qwen", (1, 1), {"quant": True})


def make_cfg(variant: str, get_config, reduced):
    """The reduced configuration of ``variant`` in either package."""
    arch, kw = VARIANTS[variant]
    cfg = reduced(get_config(arch))
    kw = dict(kw)
    window = kw.pop("window", None)
    if window is not None:
        cfg = replace(cfg, pattern=tuple(
            replace(b, window=window) if b.mixer == "local" else b
            for b in cfg.pattern))
    cf = kw.pop("capacity_factor", None)
    if cf is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=cf))
    return replace(cfg, **kw)


def inputs(vocab: int):
    """(prompts (B, T), forced decode tokens (STEPS, B)), int32."""
    rng = np.random.default_rng(7)
    return (rng.integers(0, vocab, (B, T)).astype(np.int32),
            rng.integers(0, vocab, (STEPS, B)).astype(np.int32))


def one_key(case: str) -> str:
    """The one-process run ``case`` is held to: its variant, int8 cache and
    cache length (the mesh and ``param_fsdp`` do not change it)."""
    variant, _, opts = {**CASES, **W1_CASES}[case]
    parts = [variant] + (["quant"] if opts.get("quant") else []) + (
        [f"L{opts['cache_len']}"] if "cache_len" in opts else [])
    return "_".join(parts)


def _one_specs() -> dict:
    out = {}
    for case, spec in {**CASES, **W1_CASES}.items():
        out.setdefault(one_key(case), spec)
    return out


def save(out: str, name: str, **arrays) -> None:
    np.savez(os.path.join(out, name + ".npz"),
             **{k: np.asarray(v) for k, v in arrays.items()})


def save_run(out: str, name: str, prefill, logits, tokens, cache) -> None:
    save(out, name, prefill=prefill, logits=logits, tokens=tokens,
         **{f"c{i}": x for i, x in enumerate(cache)})


def init_leaves(out: str, variant: str) -> list:
    with np.load(os.path.join(out, f"init_{variant}.npz")) as f:
        return [f[f"p{i}"] for i in range(len(f.files))]


# -- the reference ----------------------------------------------------------

def ref_run(out: str, case: str):
    """``case`` in the reference's steps on a mesh of forced host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import get_config
    from repro.launch import steps
    from repro.models import (ShapeConfig, abstract_params, decode_step, model_defs,
                              reduced_for_smoke)
    from repro.models.attention import AttnCache
    from repro.models.mla import MLACache
    from repro.parallel.sharding import named

    variant, mesh_shape, _ = CASES[case]
    cfg = make_cfg(variant, get_config, reduced_for_smoke)
    mesh = Mesh(np.array(jax.devices()[:math.prod(mesh_shape)]).reshape(mesh_shape), DM)
    treedef = jax.tree_util.tree_structure(abstract_params(model_defs(cfg)))
    params = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(x) for x in init_leaves(out, variant)])
    prompts, forced = inputs(cfg.vocab)
    prefill = steps.make_prefill_step(cfg, ShapeConfig("p", "prefill", T, B),
                                      mesh).jitted(mesh)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompts)})

    def pad(layer):  # the prompt-long caches to L rows (a ring's stay)
        if not isinstance(layer, (AttnCache, MLACache)):
            return layer
        ax = layer[0].ndim - (3 if isinstance(layer, AttnCache) else 2)
        if layer[0].shape[ax] != T:
            return layer
        return type(layer)(*(jnp.pad(c, [(0, 0)] * ax + [(0, L - T)]
                                     + [(0, 0)] * (c.ndim - ax - 1)) for c in layer))

    cache = {k: [pad(c) for c in v] for k, v in cache.items()}
    decode = steps.make_decode_step(cfg, ShapeConfig("d", "decode", L, B), mesh)

    def with_logits(p, tok, c, t):  # the step's own body, its logits kept
        lo, c = decode_step(p, cfg, tok, c, t, steps.make_ctx(mesh))
        return lo, jnp.argmax(lo, axis=-1).astype(jnp.int32)[:, None], c

    fn = jax.jit(with_logits, in_shardings=named(mesh, decode.in_shardings),
                 out_shardings=named(mesh, (decode.out_shardings[0],)
                                     + tuple(decode.out_shardings)))
    los, toks = [], []
    for i in range(STEPS):
        lo, nt, cache = fn(params, jnp.asarray(forced[i][:, None]), cache,
                           jnp.int32(T + i))
        los.append(np.asarray(lo))
        toks.append(np.asarray(nt)[:, 0])
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(cache)]
    return np.asarray(logits), np.stack(los), np.stack(toks), leaves


def run_reference(out: str, *cases: str) -> None:
    """The reference's runs of ``cases`` (default: every REF_CASES one, each
    in a subprocess of its own, at once)."""
    if not cases:
        import subprocess

        procs = [subprocess.Popen([sys.executable, __file__, "reference", out, case])
                 for case in REF_CASES]
        if any(p.wait() for p in procs):
            raise SystemExit("a reference run failed")
        return
    for case in cases:
        save_run(out, f"ref_{case}", *ref_run(out, case))


# -- the port ---------------------------------------------------------------

def quantize(cache):
    """Every attention layer of ``cache`` as its int8 form (the KV pager's
    demotion)."""
    from repro_torch.models.attention import AttnCache
    from repro_torch.models.quant_cache import quantize_cache

    return {k: [quantize_cache(*c) if isinstance(c, AttnCache) else c for c in v]
            for k, v in cache.items()}


def port_run(out: str, spec, mesh):
    """``spec`` (a CASES entry) on ``mesh`` (None: one process): the
    prefill's logits, each decode step's logits and tokens, and the final
    cache's leaves, all whole, on every rank."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import make_decode_step, make_prefill_step, steps
    from repro_torch.launch.train import _skeleton
    from repro_torch.models import ShapeConfig, from_jax_params, reduced_for_smoke
    from repro_torch.parallel.sharding import (
        P, batch_entry, cache_pspecs, param_pspecs, shard_tree, unshard_tree)
    from repro_torch.tree import tree_leaves, tree_unflatten

    variant, _, opts = spec
    cfg = make_cfg(variant, get_config, reduced_for_smoke)
    Lc = opts.get("cache_len", L)
    quant = opts.get("quant", False)
    fsdp = not opts.get("tp_only", False)
    params = from_jax_params(tree_unflatten(_skeleton(cfg)[0], init_leaves(out, variant)),
                             cfg, "cpu")
    prompts, forced = inputs(cfg.vocab)
    prompts, forced = torch.from_numpy(prompts), torch.from_numpy(forced)
    rows = lambda t: t  # noqa: E731
    if mesh is not None:
        params = shard_tree(params, param_pspecs(cfg, mesh, ... if fsdp else None), mesh)
        b = batch_entry(mesh, B)
        rows = lambda t: shard_tree(t, P(b, *([None] * (t.dim() - 1))), mesh)  # noqa: E731
    prefill = make_prefill_step(cfg, ShapeConfig("p", "prefill", T, B), cache_len=Lc,
                                mesh=mesh, param_fsdp=fsdp)
    dshape = ShapeConfig("d", "decode", Lc, B)
    decode = make_decode_step(cfg, dshape, mesh=mesh, param_fsdp=fsdp, quant_cache=quant)
    seen = []
    inner = steps.decode_step

    def keeping(*a, **kw):  # the step's logits, kept for the comparison
        lo, c = inner(*a, **kw)
        seen.append(lo)
        return lo, c

    with torch.no_grad():
        logits, cache = prefill(params, {"tokens": rows(prompts)})
        if quant:
            cache = quantize(cache)
        toks = []
        steps.decode_step = keeping
        try:
            for i in range(STEPS):
                nt, cache = decode(params, rows(forced[i][:, None]), cache, T + i)
                toks.append(nt[:, 0])
        finally:
            steps.decode_step = inner
    los, toks = torch.stack(seen), torch.stack(toks)
    if mesh is not None:
        logits = unshard_tree(logits, P(b, None), mesh)
        los = unshard_tree(los, P(None, b, None), mesh)
        toks = unshard_tree(toks, P(None, b), mesh)
        cache = unshard_tree(cache, cache_pspecs(cfg, dshape, mesh, quant_attn=quant), mesh)
    return (logits.numpy(), los.numpy(), toks.numpy(),
            [(x.float() if x.dtype == torch.bfloat16 else x).numpy()
             for x in tree_leaves(cache)])


def _threads() -> None:
    import torch
    torch.set_num_threads(1)


def _world(rank: int, size: int, part: int, parts: int, out: str) -> None:
    """Every ``parts``-th case of ``size`` ranks from the ``part``-th."""
    from repro_torch.launch import make_mesh_compat, process_group

    _threads()
    mine = [c for c, spec in CASES.items() if math.prod(spec[1]) == size][part::parts]
    with process_group(rank, size, os.path.join(out, f"rdzv{size}_{part}"), "cpu"):
        for case in mine:
            spec = CASES[case]
            res = port_run(out, spec, make_mesh_compat(spec[1], DM, "cpu"))
            if rank == 0:
                save_run(out, f"port_{case}", *res)


def _world1(out: str) -> None:
    """World size 1 in this process: the (1, 1) mesh's runs."""
    from repro_torch.launch import make_mesh_compat, process_group

    _threads()
    with process_group(0, 1, os.path.join(out, "rdzv1"), "cpu"):
        mesh = make_mesh_compat((1, 1), DM, "cpu")
        for case, spec in W1_CASES.items():
            save_run(out, f"port_{case}", *port_run(out, spec, mesh))


def _one(i: int, keys: list, out: str) -> None:
    """The one-process runs of every other key from the ``i``-th."""
    _threads()
    specs = _one_specs()
    for key in keys[i::2]:
        save_run(out, f"one_{key}", *port_run(out, specs[key], None))


def run_port(out: str) -> None:
    """Every world at once (the cases of 4 ranks in two worlds), the
    one-process runs in two more processes."""
    import torch.multiprocessing as mp

    _threads()

    procs = [mp.start_processes(_world, args=(n, part, parts, out), nprocs=n,
                                join=False, start_method="spawn")
             for n, parts in ((4, 2), (2, 1)) for part in range(parts)]
    procs.append(mp.start_processes(_one, args=(sorted(_one_specs()), out), nprocs=2,
                                    join=False, start_method="spawn"))
    _world1(out)
    for p in procs:
        while not p.join():
            pass


if __name__ == "__main__":
    side, folder, *names = sys.argv[1:]
    {"reference": run_reference, "port": run_port}[side](folder, *names)
