"""The port's prefill and decode steps on a mesh, against the reference's
steps on a mesh and against the port's own one-process steps, and the
pieces they stand on: the decode kernel's log-sum-exp output and the
combine of per-block partial attentions.

No process group is made in the test process.  A module fixture draws
each variant's f32 parameters as the card's training phases draw theirs
(``chip_smoke._draw_train_params``), then runs
``tests/sharded_serve_worlds.py`` twice, at once under the world lock
(``tests/world_lock.py``: one world on the host at a time), each in a
fresh session killed whole if it uses more than CPU_LIMIT CPU seconds or
hangs: the reference side (its jitted steps on 4
forced host devices) and the port side (gloo worlds of 1, 2 and 4 ranks
and the one-process runs).  Every case prefills 4 prompts of 20 tokens
into a cache of 40 rows (39 in the ``odd`` cases, which no TP size
divides: the global layers' caches stay whole there) and decodes 8
steps teacher-forced, in f32.  Bounds, relative L2 of each step's
logits and of every unsharded cache leaf:

* against the one-process steps, 1e-5 (measured: 1.5e-6 at most, in
  recurrentgemma-9b on (1, 4)), and the greedy tokens equal.  The int8
  cases quantize k and v computed from inputs a TP sum rounds apart: a
  value at a rounding boundary of its int8 level lands one level off
  (measured: 2e-4 of the int8 entries and 2.6e-4 in the logits of the
  qwen16 (1, 4) case).  There the int8 levels differ by at most one on at
  most 1e-3 of the entries, and the logits by 1e-3;
* against the reference's steps on a mesh, 1e-5 (measured: 1.7e-6);
* at world size 1 on a (1, 1) mesh, bit for bit.
"""

import importlib.util
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_serve_worlds as sv
from world_lock import run_sides
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_torch
from repro_torch.models import reduced_for_smoke
from repro_torch.models.quant_cache import QuantAttnCache, quant_decode_attention, quantize_cache
from repro_torch.parallel.collectives import combine_stacked
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
CPU_LIMIT = 480  # CPU s a side may use; the most a side used was 108 (world_lock.py)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_serve")
    for variant in sv.VARIANTS:
        cfg = sv.make_cfg(variant, get_config, reduced_for_smoke)
        params = chip_smoke._draw_train_params(cfg, 0, torch.device("cpu"))
        np.savez(out / f"init_{variant}.npz",
                 **{f"p{i}": x.numpy() for i, x in enumerate(tree_leaves(params))})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                   "--xla_backend_optimization_level=0 "
                   "--xla_llvm_disable_expensive_passes=true")
    run_sides(ROOT / "tests" / "sharded_serve_worlds.py", out,
              [("reference", ref_env), ("port", env)], CPU_LIMIT)
    return out


def _load(out, name):
    with np.load(out / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _cache(run: dict) -> list:
    return [run[f"c{i}"] for i in range(sum(k.startswith("c") for k in run))]


def _held(got: dict, want: dict, tol: float, quant: bool = False) -> None:
    """Prefill and every step's logits within ``tol``, the same greedy
    tokens, every cache leaf within ``tol`` (int8 levels: module
    docstring)."""
    assert _rel(got["prefill"], want["prefill"]) <= tol
    gaps = [_rel(a, b) for a, b in zip(got["logits"], want["logits"])]
    assert max(gaps) <= (1e-3 if quant else tol), gaps
    assert (got["tokens"] == want["tokens"]).all()
    for i, (a, b) in enumerate(zip(_cache(got), _cache(want))):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        if quant and a.dtype == np.int8:
            off = np.abs(a.astype(np.int32) - b)
            assert off.max() <= 1 and (off > 0).mean() <= 1e-3, (i, off.max())
        elif quant:  # the scales, bf16 of an amax that may round apart
            assert _rel(a, b) <= 1e-2, (i, _rel(a, b))
        else:
            assert _rel(a, b) <= tol, (i, _rel(a, b))


@pytest.mark.parametrize("case", list(sv.CASES))
def test_sharded_serve_matches_one_process(out, case):
    got, want = _load(out, f"port_{case}"), _load(out, f"one_{sv.one_key(case)}")
    _held(got, want, 1e-5, sv.CASES[case][2].get("quant", False))


@pytest.mark.parametrize("case", sv.REF_CASES)
def test_sharded_serve_matches_reference(out, case):
    _held(_load(out, f"port_{case}"), _load(out, f"ref_{case}"), 1e-5)


@pytest.mark.parametrize("case", list(sv.W1_CASES))
def test_world_size_one_is_the_one_process_step_bit_for_bit(out, case):
    got, want = _load(out, f"port_{case}"), _load(out, f"one_{sv.one_key(case)}")
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].tobytes() == want[k].tobytes(), k


# -- the kernel's log-sum-exp and the combine --------------------------------

def _decode_inputs(B=3, S=40, H=8, Kv=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, dh), (B, S, Kv, dh), (B, S, Kv, dh)))
    return q, k, v


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_decode_lse_matches_the_reference_scores(softcap):
    """``return_lse``'s log-sum-exp is that of the reference's masked
    scores (``repro.kernels.ref.decode_attention_ref``'s), per kv head;
    its output is the reference's; a row of length 0 gives zeros and the
    mask value."""
    from repro.kernels.ref import decode_attention_ref

    q, k, v = _decode_inputs()
    lengths = np.array([40, 17, 0], np.int32)
    o, lse = decode_attention_torch(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(lengths),
                                    softcap=softcap, return_lse=True)
    B, H, dh = q.shape
    Kv, rep = k.shape[2], H // k.shape[2]
    for g in range(Kv):
        qg = jnp.asarray(q[:, g * rep:(g + 1) * rep])
        s = jnp.einsum("bhd,bsd->bhs", qg, jnp.asarray(k[:, :, g])) / math.sqrt(dh)
        if softcap is not None:
            s = softcap * jnp.tanh(s / softcap)
        live = jnp.arange(k.shape[1])[None, None, :] < jnp.asarray(lengths)[:, None, None]
        want = np.asarray(jax.nn.logsumexp(jnp.where(live, s, -jnp.inf), axis=-1))
        np.testing.assert_allclose(lse[:2, g * rep:(g + 1) * rep].numpy(), want[:2],
                                   rtol=1e-6, atol=1e-6)
        ref_o = np.asarray(decode_attention_ref(
            qg, jnp.asarray(k[:, :, g]), jnp.asarray(v[:, :, g]),
            jnp.asarray(lengths), softcap=softcap))
        np.testing.assert_allclose(o[:2, g * rep:(g + 1) * rep].numpy(), ref_o[:2],
                                   rtol=1e-5, atol=1e-6)
    assert (o[2] == 0).all() and (lse[2] == -1e30).all()
    # without the flag: the same output alone
    alone = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(lengths),
                             softcap=softcap)
    assert torch.equal(alone, o)


def _blocks(n: int, S: int, lengths: np.ndarray):
    """Each of ``n`` blocks of ``S`` rows: (first row, rows, its lengths)."""
    rows = S // n
    return [(i * rows, rows, np.clip(lengths - i * rows, 0, rows).astype(np.int32))
            for i in range(n)]


@pytest.mark.parametrize("n_blocks", [2, 4, 5])
def test_blocks_combine_to_the_whole_cache(n_blocks):
    """The cache cut into blocks, one decode over each with its own
    lengths (blocks past a row's length are empty: weight 0), combined by
    ``combine_partials``' arithmetic: the decode over the whole cache."""
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(S=40))
    lengths = np.array([40, 9, 21], np.int32)
    whole = decode_attention(q, k, v, torch.from_numpy(lengths), softcap=5.0)
    os_, lses = [], []
    for first, rows, ln in _blocks(n_blocks, 40, lengths):
        o, lse = decode_attention(q, k[:, first:first + rows], v[:, first:first + rows],
                                  torch.from_numpy(ln), softcap=5.0, return_lse=True)
        os_.append(o)
        lses.append(lse)
    got = combine_stacked(torch.stack(os_), torch.stack(lses))
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-6)


def test_int8_blocks_combine_to_the_whole_cache():
    """``quant_decode_attention(return_lse=True)`` over blocks of an int8
    cache, combined: the whole cache's attention, rounded as it rounds."""
    q, k, v = (torch.from_numpy(a) for a in _decode_inputs(S=40))
    cache = quantize_cache(k, v)
    lengths = np.array([40, 9, 21], np.int32)
    whole = quant_decode_attention(q, cache, torch.from_numpy(lengths), s_chunk=16)
    os_, lses = [], []
    for first, rows, ln in _blocks(4, 40, lengths):
        blk = QuantAttnCache(*(t[:, first:first + rows] for t in cache))
        o, lse = quant_decode_attention(q, blk, torch.from_numpy(ln), s_chunk=16,
                                        return_lse=True)
        assert o.dtype == torch.float32
        os_.append(o)
        lses.append(lse)
    got = combine_stacked(torch.stack(os_), torch.stack(lses)).to(torch.bfloat16)
    assert (got.float() - whole.float()).abs().max() <= 2 ** -7 * whole.float().abs().max()
