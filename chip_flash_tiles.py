#!/usr/bin/env python3
"""Time the flash kernel's tile choices on one GPU.

    python3 chip_flash_tiles.py

Run from the root of a checkout on an H100 (or another sm_90a card).  It
compiles ``src/repro_torch/csrc/flash_attention.cu`` as built and in two
variants, made by editing a copy of the source under
``build/flash_tiles/``: a three-stage K/V ring instead of two, and one
consumer warpgroup (64 query rows a block) instead of two for head dim
128.  Each is checked against the plain version at the qwen2.5-3b
prefill's shape (B=1, T=1024, H=16, Kv=2, dh=128, causal, bf16;
tolerance 2e-2) and timed on the device with ``torch.profiler`` (the
median of 3 windows of 30 calls), beside SDPA's time on the same inputs.
It prints the card's name and power limit, one JSON line per variant
with ptxas's registers and spilled bytes, then the port's own wrapper
(``flash_attention``) and SDPA event-timed around each call as
``chip_smoke.py`` times them (median of 15 after 3 warm-ups), in 5
alternating rounds, and exits non-zero without a card or if a variant
disagrees.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "flash_tiles"
TOL = 2e-2  # bf16 against the plain version in f32 (chip_smoke.ATTN_TOL)
# (name, [(text in the source, its replacement)], query rows per block)
VARIANTS = (
    ("built: 2 consumer warpgroups, 2 stages", [], 128),
    ("3 stages", [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
     128),
    ("1 consumer warpgroup", [
        ("return tc_launch<T, 128, 128, 2>(a, maps, device, stream);",
         "return tc_launch<T, 128, 128, 1>(a, maps, device, stream);"),
        ("block_q != (dqk == 256 ? 64 : 128)",
         "block_q != (dqk == 256 || dqk == 128 ? 64 : 128)"),
    ], 64),
)


def build(source: str, name: str, nvcc: str, flags) -> tuple:
    """Compile ``source`` into ``OUT/<name>.so``; return its path and the
    flash_wgmma_kernel<bf16, 128, ...> registers and spilled bytes."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(source)
    done = subprocess.run([nvcc, *flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    log = done.stdout + done.stderr
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if ("Function properties for" in line and "flash_wgmma_kernel" in line
                and "nv_bfloat16Li128E" in line):
            nums = [int(w) for w in lines[i + 1].replace(",", " ").split()
                    if w.isdigit()]
            regs = int(lines[i + 2].split("Used")[1].split("registers")[0])
            return lib, regs, nums[1] + nums[2]
    raise RuntimeError(f"no ptxas report for the dh 128 bf16 kernel of {name}")


def device_ms(fn, windows: int = 3, reps: int = 30) -> float:
    """Median over ``windows`` profiler windows of the device time per
    call of ``fn`` in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total <= 0:
            raise RuntimeError("the profiler saw no device time")
        times.append(total / reps / 1e3)
    return statistics.median(times)


def event_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median time of ``fn`` in ms from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_tiles: no CUDA device; this script runs on the GPU "
              "only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
               for shape in ((1, 1024, 16, 128), (1, 1024, 2, 128),
                             (1, 1024, 2, 128)))
    want = fa.flash_attention_torch(q.float(), k.float(), v.float())
    call = fa._prepare(q, k, v, True, None, None, None)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    ok = True
    for i, (name, edits, block_q) in enumerate(VARIANTS):
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        # the copy includes the kernels' shared headers from the package
        lib_path, regs, spilled = build(text, f"variant{i}", _build._nvcc(),
                                        (*_build.NVCC_FLAGS, "-I", str(_build.CSRC)))
        fn = ctypes.CDLL(str(lib_path)).flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 7
        fn.restype = ctypes.c_int
        params = fa._Params.from_buffer_copy(call.params)
        params.block_q = block_q

        def run():
            out = q.new_empty(q.shape)
            err = fn(ctypes.addressof(params), q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), out.data_ptr(), None,  # no lse
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")
            return out

        err = float((run().float() - want).abs().max())
        ok &= err <= TOL
        print(json.dumps({"variant": name, "block_q": block_q,
                          "device_ms": device_ms(run), "max_abs_err": err,
                          "registers": regs, "spill_bytes": spilled}),
              flush=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)

    print(json.dumps({"sdpa_device_ms": device_ms(sdpa)}), flush=True)
    for rnd in range(5):  # the wrapper's host time counts in these
        pair = [("flash_attention", lambda: fa.flash_attention(q, k, v)),
                ("sdpa", sdpa)]
        for name, fn in pair if rnd % 2 == 0 else pair[::-1]:
            print(json.dumps({"round": rnd, "call": name,
                              "event_ms": event_ms(fn)}), flush=True)
    print(json.dumps({"card": card, "ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
