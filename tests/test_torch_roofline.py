"""The port's roofline (``repro_torch/launch/roofline.py``) against the
reference's ``repro/launch/roofline.py`` and against PERF.md's bounds.

* The traffic model (``analytic_hbm_bytes``, ``_cache_bytes``), the dry
  run's MODEL_FLOPS and ``useful_flops_frac`` are the reference's, so the
  two packages agree exactly (floats compared with ``==``) for every arch,
  runnable shape and pod size.  ``repro.launch.dryrun`` is never imported
  here: it sets ``XLA_FLAGS`` at import (its MODEL_FLOPS rule is restated
  from ``src/repro/launch/dryrun.py:94-104``).
* ``kernel_work`` reproduces the bound column of PERF.md's kernel table
  at each recorded shape, to the printed digits; shapes only, so the
  tensors are on the ``meta`` device.
* The flash pairs' closed form gives the integers of the loops
  ``chip_smoke.py`` summed before, and of the kernel's mask.
"""

import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.shapes import shapes_for as jshapes_for
from repro.launch import roofline as jrl
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import shapes_for
from repro_torch.kernels.flash_attention import live_mask
from repro_torch.launch import roofline as rl
from repro_torch.launch.cost_analysis import ModuleCosts
from repro_torch.launch.dryrun import model_flops
from repro_torch.launch.mesh import production_mesh_shape


def test_constants_are_the_h100_data_sheet():
    assert (rl.PEAK_FLOPS, rl.TF32_FLOPS, rl.HBM_BW, rl.HBM_PER_CARD) == (
        989e12, 495e12, 3.35e12, 80e9)
    assert (rl.NVLINK_BW, rl.NET_BW, rl.NODE) == (450e9, 50e9, 8)


def test_arch_ids_match_reference():
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_traffic_model_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes, jshapes = shapes_for(cfg), jshapes_for(jcfg)
    assert list(shapes) == list(jshapes)
    for name in shapes:
        assert rl._cache_bytes(cfg, shapes[name]) == jrl._cache_bytes(jcfg, jshapes[name])
        for n_dev in (256, 512):
            assert (rl.analytic_hbm_bytes(cfg, shapes[name], n_dev)
                    == jrl.analytic_hbm_bytes(jcfg, jshapes[name], n_dev)), (name, n_dev)


def _ref_model_flops(cfg, shape) -> float:
    """The reference's MODEL_FLOPS (``src/repro/launch/dryrun.py:94-104``)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_params()
    if cfg.frontend in ("tokens", "tokens+patches"):
        n_active -= cfg.vocab * cfg.d_model
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    return 2.0 * n_active * tokens


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    jshapes = jshapes_for(jcfg)
    for name, shape in shapes_for(cfg).items():
        assert model_flops(cfg, shape) == _ref_model_flops(jcfg, jshapes[name]), name


@pytest.mark.parametrize("flops,model", [(3.7e15, 1.2e15), (5.0e9, None), (0.0, 2.0e9)])
def test_useful_flops_frac_matches_reference(flops, model):
    mine = rl.Roofline("a", "s", "16x16", flops=flops, hbm_bytes=1e9, coll_bytes=0,
                       model_flops=model)
    ref = jrl.Roofline("a", "s", "16x16", flops=flops, hbm_bytes=1e9, coll_bytes=0,
                       model_flops=model)
    assert mine.useful_flops_frac == ref.useful_flops_frac


def test_roofline_prices_each_collective_by_its_links():
    r = rl.Roofline("a", "s", "16x16", flops=0.0, hbm_bytes=0.0, coll_bytes=3 * 10**9,
                    coll_link_bytes={"nvlink": 10**9, "net": 2 * 10**9})
    assert r.t_collective == 10**9 / 450e9 + 2 * 10**9 / 50e9
    assert r.bottleneck == "collective"
    assert rl.link_of(range(8)) == "nvlink" and rl.link_of([8, 15]) == "nvlink"
    assert rl.link_of([7, 8]) == "net"
    # the production pod's 16-wide TP axis spans two nodes, as does "data"
    (data, model), _ = production_mesh_shape()
    assert rl.link_of(range(model)) == "net"
    assert rl.link_of(range(0, data * model, model)) == "net"


def test_derive_adds_the_kernels_at_their_peaks():
    costs = ModuleCosts(dot_flops=2e12)
    costs.kernel_flops = {"flash_attention": 1e12, "ssd_chunk": 4.95e11}
    costs.kernel_compute_s = {"flash_attention": 1e12 / 989e12, "ssd_chunk": 1e-3}
    costs.kernel_calls = {"flash_attention": 3, "ssd_chunk": 1}
    costs.collective_bytes["all-gather"] = 100
    costs.link_bytes["net"] = 100
    cfg = get_config("qwen2.5-3b")
    shape = shapes_for(cfg)["train_4k"]
    r = rl.derive("qwen2.5-3b", "train_4k", "16x16", costs, 256, cfg, shape,
                  model_flops_global=256e12, peak_memory_bytes=81e9)
    assert r.flops == 2e12 + 1.495e12 and r.kernel_flops == 1.495e12
    assert r.t_compute == pytest.approx(2e12 / 989e12 + 1e12 / 989e12 + 1e-3, rel=1e-12)
    assert r.coll_bytes == 100 and r.coll_breakdown["all-gather"] == 100
    assert r.t_collective == 100 / 50e9
    assert r.hbm_bytes == rl.analytic_hbm_bytes(cfg, shape, 256)
    assert r.model_flops == 1e12 and r.fits_hbm is False
    d = r.to_dict()
    assert d["kernel_calls"] == {"flash_attention": 3, "ssd_chunk": 1}
    assert {"t_compute", "t_memory", "t_collective", "bottleneck", "useful_flops_frac",
            "roofline_frac", "fits_hbm"} <= set(d)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _flash(dqk, dv, kv):
    return _meta(1, 4096, 16, dqk), _meta(1, 4096, kv, dqk), _meta(1, 4096, kv, dv)


def _bwd(dqk, dv, kv):
    q, k, v = _flash(dqk, dv, kv)
    o = _meta(1, 4096, 16, dv)
    return q, k, v, o, o, _meta(1, 16, 4096, dtype=torch.float32)


def _ssd_fwd():
    f32 = torch.float32
    bc = _meta(16, 256, 1, 128, dtype=f32).expand(16, 256, 80, 128)  # one group
    dt = _meta(16, 256, 80, dtype=f32)
    return _meta(16, 256, 80, 64, dtype=f32), dt, dt, bc, bc


def _ssd_bwd():
    f32 = torch.float32
    x, dt = _meta(16, 256, 80, 64, dtype=f32), _meta(16, 256, 80, dtype=f32)
    bc = _meta(16, 256, 1, 128, dtype=f32)
    return x, dt, dt, bc, bc, x, _meta(16, 80, 64, 128, dtype=f32)


#: PERF.md §6's bound column: (kernel, arguments, keywords, GFLOP or None,
#: MB or None, bound ms; each to the digits printed there)
PERF_ROWS = {
    "flash_qwen_training": ("flash_attention", _flash(128, 128, 2), {}, 68.7, None,
                            0.0695),
    "flash_bwd_dh128": ("flash_attention_bwd", _bwd(128, 128, 2), {}, 171.8, None,
                        0.1738),
    "flash_bwd_mla": ("flash_attention_bwd", _bwd(192, 128, 16), {}, 223.4, None,
                      0.2259),
    "decode_qwen_length_1025": ("decode_attention",
                                (_meta(1, 16, 128), _meta(1, 1088, 2, 128),
                                 _meta(1, 1088, 2, 128)), {"rows": 1025}, None, None,
                                0.000316),
    "ssd_chunk_training": ("ssd_chunk", _ssd_fwd(), {}, None, None, 0.06464),
    "ssd_chunk_bwd_training": ("ssd_chunk_bwd", _ssd_bwd(), {}, None, 307.2, 0.09171),
    "histogram_2^28": ("bucket_histogram",
                       (_meta(1 << 28, dtype=torch.int32), 4), {}, None, None, 0.3205),
}


def _digits(x: float) -> int:
    """Decimals printed in ``x``."""
    text = repr(x)
    return len(text.split(".")[1]) if "." in text else 0


@pytest.mark.parametrize("row", PERF_ROWS)
def test_kernel_work_reproduces_perf_bounds(row):
    name, args, kw, gflop, mb, bound_ms = PERF_ROWS[row]
    work = rl.kernel_work(name, *args, **kw)
    assert round(work.bound_ms, _digits(bound_ms)) == bound_ms
    if gflop is not None:
        assert round(work.flops / 1e9, 1) == gflop and work.bound_by == "operations"
    if mb is not None:
        assert round(work.bytes / 1e6, 1) == mb and work.bound_by == "bytes"


def test_flash_backward_as_run_bound():
    q, k, v, *_ = _bwd(128, 128, 2)
    flops = rl.flash_bwd_as_run_flops(q, k, v)
    assert round(flops / rl.PEAK_FLOPS * 1e3, 4) == 0.2433


def _fwd_loop(T, Tk, causal, window):
    """The pairs loop ``chip_smoke.measure_flash`` summed."""
    return sum(min(i + 1, Tk) - (max(0, i - window + 1) if window else 0)
               if causal else Tk for i in range(T))


def _bwd_loop(T, causal, window):
    """The pairs sum ``chip_smoke.measure_flash_bwd`` took (Tk = T)."""
    return (sum(i + 1 - max(0, i - window + 1) for i in range(T)) if window
            else T * (T + 1) // 2 if causal else T * T)


@pytest.mark.parametrize("T,Tk,causal,window", [
    (4096, 4096, True, None), (4096, 4096, True, 2048), (1024, 1024, True, 2048),
    (333, 333, True, 100), (63, 129, True, None), (129, 63, True, None),
    (129, 63, True, 40), (1, 1, True, None), (200, 300, False, None),
])
def test_attention_pairs_closed_form_matches_the_loops(T, Tk, causal, window):
    pairs = rl.attention_pairs(T, Tk, causal, window)
    assert pairs == int(live_mask(T, Tk, causal, window, "cpu").sum())
    if window is None or T - window <= Tk:  # else the loop counts rows below 0
        assert pairs == _fwd_loop(T, Tk, causal, window)
    if T == Tk and (causal or window is None):
        assert pairs == _bwd_loop(T, causal, window)
