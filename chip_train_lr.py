#!/usr/bin/env python3
"""Train qwen2.5-3b at full width on the card at two AdamW rates, and
take the kernels and bf16 out of the higher rate's path one at a time.

    python3 chip_train_lr.py [--seed N]

Run from the root of a checkout on a machine with an H100.  Every run
starts from the same seeded weights and takes ``chip_smoke.py``'s
training steps (4 sequences of 4096 tokens in 4 microbatches a step,
remat "full", f32 masters, AdamW with weight decay 0) over the same
batches, for 6 steps:

- ``kernels_bf16_3e-3``: the reference launcher's default rate, 3e-3;
- ``sdpa_bf16_3e-3``: the same with PyTorch's
  ``scaled_dot_product_attention`` in place of both flash kernels;
- ``kernels_f32_3e-3``: the same with f32 compute;
- ``kernels_bf16_2layers_3e-3``: the same at 2 layers;
- ``kernels_bf16_3e-4``: ``chip_smoke.py``'s training phase itself
  (``phase_training``, all its checks) at its rate, 3e-4.

It prints a ``train_step`` line per step (loss, grad norm, step ms, the
flash kernels' launches) and a summary line per run, then the card's
name and power limit and one JSON line of every run's losses.  If the
loss rises at 3e-3 with SDPA and with f32 compute as with the kernels
in bf16, the rate is at fault, not the kernels or bf16.  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace

import torch
import torch.nn.functional as F

import chip_smoke as cs

#: (name, attention, compute dtype, layers or None for all 36, rate)
RUNS = (
    ("kernels_bf16_3e-3", "kernels", torch.bfloat16, None, 3e-3),
    ("sdpa_bf16_3e-3", "sdpa", torch.bfloat16, None, 3e-3),
    ("kernels_f32_3e-3", "kernels", torch.float32, None, 3e-3),
    ("kernels_bf16_2layers_3e-3", "kernels", torch.bfloat16, 2, 3e-3),
)


def _sdpa(q, k, v, causal=True, scale=None, softcap=None, window=None):
    """``ops.flash_attention``'s contract ((B, T, H, dh) in and out) on
    PyTorch's attention, for the dense causal path only."""
    if softcap is not None or window is not None:
        raise ValueError("the SDPA stand-in takes no softcap or window")
    o = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), is_causal=causal,
                                       scale=scale, enable_gqa=True)
    return o.transpose(1, 2)


def run(dev, seed: int, name: str, attention: str, dtype, layers, lr) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ops
    from repro_torch.launch import make_train_step, steps
    from repro_torch.models import ShapeConfig
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = get_config(cs.TRAIN_MODEL)
    if layers is not None:
        cfg = replace(cfg, n_periods=layers)
    params = cs.draw_params(cfg, seed, dev)
    cs._to_f32_in_place(params, dev)
    opt = adamw_init(params)
    shape = ShapeConfig(name="train_4k_cut", kind="train", seq_len=cs.TRAIN_SEQ,
                        global_batch=cs.TRAIN_BATCH,
                        microbatches=cs.TRAIN_MICROBATCHES, q_chunk=512,
                        kv_chunk=1024, loss_chunk=512, remat="full")
    step_fn = make_train_step(cfg, shape, AdamWConfig(lr=lr, weight_decay=0.0),
                              device=dev)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=cs.TRAIN_SEQ,
                          global_batch=cs.TRAIN_BATCH)
    saved = (ops.flash_attention, steps.COMPUTE_DTYPE)
    if attention == "sdpa":
        ops.flash_attention = _sdpa
    steps.COMPUTE_DTYPE = dtype
    losses, norms = [], []
    try:
        for step in range(cs.TRAIN_STEPS):
            before = (fa.launches, fb.launches)
            t = time.perf_counter()
            params, opt, m = step_fn(params, opt, make_batch(pipe, step))
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            dt = time.perf_counter() - t
            losses.append(loss)
            norms.append(gnorm)
            cs.emit("train_step", run=name, step=step + 1, loss=loss,
                    grad_norm=gnorm, step_ms=dt * 1e3,
                    flash_launches=fa.launches - before[0],
                    flash_bwd_launches=fb.launches - before[1])
    finally:
        ops.flash_attention, steps.COMPUTE_DTYPE = saved
    del params, opt, step_fn
    cs.free_card()
    return {"run": name, "attention": attention, "dtype": str(dtype),
            "layers": cfg.n_layers, "lr": lr, "losses": losses,
            "grad_norms": norms, "last_below_first": losses[-1] < losses[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_train_lr: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.ROOT / "src"))
    from repro_torch.kernels import _build

    card = cs._card()
    dev = torch.device("cuda", 0)
    _build.build("flash_attention", "flash_attention_bwd")
    results = []
    for spec in RUNS:
        results.append(run(dev, args.seed, *spec))
        cs.emit("lr_run", **results[-1])
    out = cs.phase_training(dev, args.seed)  # its own checks fail the script
    results.append({"run": "kernels_bf16_3e-4", "attention": "kernels",
                    "dtype": str(torch.bfloat16), "layers": None, "lr": cs.TRAIN_LR,
                    "losses": out["losses"], "grad_norms": out["grad_norms"],
                    "last_below_first": out["losses"][-1] < out["losses"][0]})
    print(card, flush=True)
    print(json.dumps({"lr_runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
