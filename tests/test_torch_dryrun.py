"""The port's dry run (``repro_torch/launch/dryrun.py``), cost counter
(``cost_analysis.py``) and hillclimb driver against the reference's
``repro/launch/dryrun.py``, ``hlo_analysis.py`` and ``hillclimb.py``.

No process group is made in the test process.  A module fixture runs
``tests/dryrun_worlds.py`` twice, at once under the world lock
(``tests/world_lock.py``: one world on the host at a time), each in a
fresh session killed whole if it uses more than CPU_LIMIT CPU seconds or
hangs: the port side (a gloo world of 4 and a fake world of
4 counting the reduced qwen2.5-3b train step on rank 0, and the
reference test's cells of ``tests/test_dryrun.py`` traced at full width
on fake CPU tensors, each in a fake world of 256 or 512) and the
reference side (its variant parse; ``repro.launch.dryrun`` sets
``XLA_FLAGS`` at import, so it is imported there only).

What is exact, with no tolerance: the fake trace of a reduced one-process
train step counts the dot FLOPs and the kernels' calls, FLOPs and bytes
of the real CPU run (where the kernels' plain versions run and their own
ops are not counted); the fake world's rank 0 counts the collective bytes
of the gloo world's rank 0, kind by kind.
"""

import json
import os
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import dryrun_worlds as dw
from world_lock import run_sides
from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.configs.shapes import skip_reason as jskip_reason
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, shapes_for, skip_reason
from repro_torch.data import PipelineConfig, make_batch
from repro_torch.kernels import bucket_histogram as bh
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fb
from repro_torch.kernels import ssd_scan, ssd_scan_bwd
from repro_torch.launch import CostCounter, dryrun, hillclimb, make_train_step
from repro_torch.launch.cost_analysis import COLLECTIVE_KINDS
from repro_torch.models import ShapeConfig, init_params, model_defs, reduced_for_smoke
from repro_torch.optim import adamw_init

ROOT = Path(__file__).resolve().parents[1]
CPU_LIMIT = 240  # CPU s a side may use; the most a side used was 54 (world_lock.py)


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=512")
    run_sides(ROOT / "tests" / "dryrun_worlds.py", out,
              [("port", env), ("reference", ref_env)], CPU_LIMIT)
    return out


def _load(out: Path, name: str) -> dict:
    with open(out / f"{name}.json") as f:
        return json.load(f)


# -- skips, variants, the CLI and hillclimb (no world needed) ------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_skip_records_match_reference(arch):
    assert tuple(SHAPES) == tuple(JSHAPES)
    for shape in SHAPES:
        want = jskip_reason(jget_config(arch), shape)
        assert skip_reason(get_config(arch), shape) == want
        if want is not None:  # skipped before any world is made
            for multi, mesh in ((False, "16x16"), (True, "2x16x16")):
                assert dryrun.run_cell(arch, shape, multi, device="cpu") == {
                    "arch": arch, "shape": shape, "mesh": mesh, "status": "skipped",
                    "reason": want}


@pytest.mark.parametrize("i", range(len(dw.VARIANTS)))
def test_variants_parse_as_the_reference(out, i):
    arch, shape_name, variant = dw.VARIANTS[i]
    cfg = get_config(arch)
    cfg, shape, (mesh, axes), kw = dryrun._apply_variant(
        cfg, shapes_for(cfg)[shape_name], False, variant)
    want = _load(out, "ref_variants")["parsed"][i]
    assert {"pad_heads": cfg.pad_heads, "mesh": list(mesh), "axes": list(axes),
            "step_kw": kw, "remat": shape.remat,
            "microbatches": shape.microbatches} == want


def test_unknown_variant_token_raises_as_the_reference(out):
    cfg = get_config("qwen2.5-3b")
    with pytest.raises(ValueError) as e:
        dryrun._apply_variant(cfg, shapes_for(cfg)["train_4k"], False, "tp3")
    assert str(e.value) == _load(out, "ref_variants")["unknown"]


def test_cli_exits_1_on_an_errored_cell(tmp_path, capsys):
    path = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--variant",
                        "bogus", "--device", "cpu", "--out", str(path)]) == 1
    [rec] = json.loads(path.read_text())
    assert rec["status"] == "error" and "bogus" in rec["error"]
    assert "1 errors" in capsys.readouterr().out


def test_hillclimb_records_a_skip_and_an_error(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert hillclimb.OUT_PATH == "results/perf_iterations_torch.json"
    for _ in range(2):  # appends to what is there
        hillclimb.main(["--device", "cpu", "hubert-xlarge:decode_32k",
                        "qwen2.5-3b:train_4k:bogus"])
    recs = json.loads((tmp_path / hillclimb.OUT_PATH).read_text())
    assert [r["status"] for r in recs] == ["skipped", "error"] * 2
    assert recs[0]["reason"] == jskip_reason(jget_config("hubert-xlarge"), "decode_32k")
    assert recs[1]["variant"] == "bogus" and "bogus" in recs[1]["error"]


# -- the fake trace against real runs --------------------------------------------

SHAPE = ShapeConfig(name="t", kind="train", seq_len=32, global_batch=4, microbatches=2,
                    q_chunk=16, kv_chunk=16, loss_chunk=16, remat="full")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-2.7b", "recurrentgemma-9b",
                                  "deepseek-v2-lite-16b"])
def test_fake_trace_counts_as_the_real_step(arch):
    cfg = reduced_for_smoke(get_config(arch))
    params = init_params(model_defs(cfg), torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.float32)
    batch = make_batch(PipelineConfig(vocab=cfg.vocab, seq_len=SHAPE.seq_len,
                                      global_batch=SHAPE.global_batch), 0)
    with CostCounter() as counter:
        make_train_step(cfg, SHAPE, device="cpu")(params, adamw_init(params), batch)
    real = counter.costs
    fake, arg_bytes = dryrun.trace(cfg, SHAPE, None, "cpu")
    assert real.kernel_calls and fake.kernel_calls == real.kernel_calls
    assert fake.dot_flops == real.dot_flops > 0
    assert fake.kernel_flops == real.kernel_flops
    assert fake.kernel_bytes == real.kernel_bytes
    assert fake.total_collective_bytes == real.total_collective_bytes == 0
    n_params = sum(p.numel() for p in torch.utils._pytree.tree_leaves(params))
    assert arg_bytes >= 3 * 4 * n_params  # masters and both moments, f32
    assert fake.peak_bytes > 0


@pytest.mark.parametrize("kind", COLLECTIVE_KINDS)
def test_fake_world_counts_the_gloo_world_collectives(out, kind):
    real, fake = _load(out, "real_world4"), _load(out, "fake_world4")
    assert fake["collective_bytes"][kind] == real["collective_bytes"][kind]
    if kind in ("all-gather", "all-reduce", "reduce-scatter"):  # FSDP and TP
        assert real["collective_bytes"][kind] > 0


def test_fake_world_counts_the_gloo_world_step(out):
    real, fake = _load(out, "real_world4"), _load(out, "fake_world4")
    assert fake["link_bytes"] == real["link_bytes"]
    assert real["link_bytes"]["net"] == 0  # 4 ranks: one node
    assert fake["dot_flops"] == real["dot_flops"] > 0
    assert fake["kernel_calls"] == real["kernel_calls"]


def test_fake_world_refuses_a_process_in_a_real_world(out):
    assert "already initialised" in _load(out, "real_world4")["refused"]


# -- the reference test's cells at full width ---------------------------------

@pytest.mark.parametrize("i", range(3))
def test_reference_cells_trace_at_full_width(out, i):
    arch, shape, multi = dw.CELLS[i]
    rec = _load(out, "cells")["cells"][i]
    assert (rec["arch"], rec["shape"], rec["status"]) == (arch, shape, "ok")
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")
    assert rec["flops"] > 0 and rec["coll_bytes"] >= 0
    assert rec["device"] == "cpu" and rec["step"] == f"decode:{arch}:{shape}"
    assert rec["kernel_calls"].get("decode_attention", 0) > 0 or arch.startswith("mamba")
    ma = rec["memory_analysis"]
    assert set(ma) == {"argument_size_in_bytes", "output_size_in_bytes",
                       "temp_size_in_bytes"}
    assert rec["peak_memory_bytes"] == sum(ma.values()) and rec["fits_hbm"]
    assert "compile_s" not in rec and "n_while" not in rec


@pytest.mark.parametrize("i", [3, 4])
def test_reference_skips_in_the_dry_run(out, i):
    arch, shape, _ = dw.CELLS[i]
    rec = _load(out, "cells")["cells"][i]
    assert rec["status"] == "skipped"
    assert rec["reason"] == jskip_reason(jget_config(arch), shape)


def test_cli_records_the_multi_pod_cell_and_leaves_no_world(out):
    cells = _load(out, "cells")
    assert cells["cli_rc"] == 0 and not cells["left_initialised"]
    [rec] = cells["cli"]
    assert (rec["status"], rec["mesh"]) == ("ok", "2x16x16")
    assert rec["coll_bytes"] == cells["cells"][2]["coll_bytes"]


# -- the wrappers' fake path --------------------------------------------------------

def _raise(*a, **k):
    raise AssertionError("a fake tensor reached a plain version or a launcher")


@pytest.fixture
def no_plain_or_launch(monkeypatch):
    """Every plain version, launcher and call preparation raises."""
    for mod, names in ((fa, ("flash_attention_torch", "_launcher", "_prepare")),
                       (fb, ("flash_attention_bwd_torch", "_launcher", "_prepare")),
                       (da, ("decode_attention_torch", "_launcher", "_prepare")),
                       (ssd_scan, ("ssd_chunk_torch", "_launcher", "_prepare")),
                       (ssd_scan_bwd, ("ssd_chunk_bwd_torch", "_launcher", "_prepare")),
                       (bh, ("bucket_histogram_torch", "_launcher", "_call_for"))):
        for name in names:
            monkeypatch.setattr(mod, name, _raise)


def _calls(device):
    """(kernel, call, its output's shapes and types) at small shapes."""
    bf, f32 = torch.bfloat16, torch.float32
    e = lambda *s, dtype=bf: torch.empty(s, dtype=dtype, device=device)  # noqa: E731
    q, k = e(2, 8, 4, 64), e(2, 8, 2, 64)
    lse = e(2, 4, 8, dtype=f32)
    x, dt, B = e(2, 16, 4, 8, dtype=f32), e(2, 16, 4, dtype=f32), e(2, 16, 1, 16, dtype=f32)
    return {
        "flash_attention": (lambda: fa.flash_attention(q, k, k, return_lse=True),
                            [((2, 8, 4, 64), bf), ((2, 4, 8), f32)]),
        "flash_attention_bwd": (lambda: fb.flash_attention_bwd(q, k, k, q, q, lse),
                                [((2, 8, 4, 64), bf), ((2, 8, 2, 64), bf),
                                 ((2, 8, 2, 64), bf)]),
        "decode_attention": (lambda: da.decode_attention(
            e(2, 4, 64), e(2, 32, 2, 64), e(2, 32, 2, 64), e(2, dtype=torch.int32),
            return_lse=True), [((2, 4, 64), bf), ((2, 4), f32)]),
        "ssd_chunk": (lambda: ssd_scan.ssd_chunk_fwd(x, dt, dt, B.expand(2, 16, 4, 16),
                                                     B.expand(2, 16, 4, 16)),
                      [((2, 16, 4, 8), f32), ((2, 4, 8, 16), f32)]),
        "ssd_chunk_bwd": (lambda: ssd_scan_bwd.ssd_chunk_bwd(
            x, dt, dt, B, B, x, e(2, 4, 8, 16, dtype=f32)),
            [(s, f32) for s in ((2, 16, 4, 8), (2, 16, 4), (2, 16, 4), (2, 16, 1, 16),
                                (2, 16, 1, 16))]),
        "bucket_histogram": (lambda: bh.bucket_histogram(e(100, dtype=torch.int32), 7),
                             [((7,), torch.int32)]),
    }


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_attention_bwd",
                                    "decode_attention", "ssd_chunk", "ssd_chunk_bwd",
                                    "bucket_histogram"])
def test_fake_inputs_reach_no_plain_version_or_launcher(no_plain_or_launch, kernel):
    launches = {m: m.launches for m in (fa, fb, da, ssd_scan, ssd_scan_bwd, bh)}
    with FakeTensorMode():
        call, want = _calls("cpu")[kernel]
        with CostCounter() as counter:
            got = call()
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == want
    assert all(t.device.type == "cpu" for t in got)
    assert counter.costs.kernel_calls == {kernel: 1}
    assert counter.costs.dot_flops == 0
    assert {m: m.launches for m in launches} == launches


def test_fake_train_step_reaches_no_plain_version_or_launcher(no_plain_or_launch):
    cfg = reduced_for_smoke(get_config("mamba2-2.7b"))
    costs, _ = dryrun.trace(cfg, SHAPE, None, "cpu")
    assert costs.kernel_calls == {"ssd_chunk": 8, "ssd_chunk_bwd": 4}
