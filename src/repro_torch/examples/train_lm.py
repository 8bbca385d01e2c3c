"""End-to-end example: train a ~100M-param LM for a few hundred steps with
the full stack: the train step, the deterministic pipeline, async PMEM
checkpoints through the client's tier.

The port of ``examples/train_lm.py`` for one card: the same model, step,
batches and checkpoints, with no mesh (the reference's smoke mesh has one
device).  Defaults are CPU-sized (reduced qwen2.5-3b, 200 steps); pass
``--hundred-m`` for the genuine ~100M-parameter run (same code path).
It trains on the card unless ``--device cpu`` is given.

Usage:
  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
      [--hundred-m] [--device cpu] [--ckpt-dir DIR]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.api import ClusterConfig, MarvelClient, TierSpec
from repro_torch.configs import get_config
from repro_torch.data.pipeline import PipelineConfig, make_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import ShapeConfig, init_params, model_defs, reduced_for_smoke
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.storage import CheckpointManager
from repro_torch.tree import tree_leaves

__all__ = ["hundred_m_config", "build", "run", "main"]


def hundred_m_config() -> ModelConfig:
    """~100M dense decoder (GPT-2-small-class), qwen-style blocks."""
    return ModelConfig(
        name="lm-100m", d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
        d_ff=3072, vocab=32000,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),), n_periods=12,
        act="silu",
    )


def build(hundred_m: bool, seq: int, batch: int):
    """The example's config and train shape."""
    cfg = (hundred_m_config() if hundred_m
           else reduced_for_smoke(get_config("qwen2.5-3b")))
    shape = ShapeConfig(name="ex", kind="train", seq_len=seq, global_batch=batch,
                        microbatches=1, q_chunk=min(256, seq),
                        kv_chunk=min(512, seq), loss_chunk=min(256, seq),
                        remat="none")
    return cfg, shape


def run(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    steps: int,
    lr: float,
    ckpt_every: int,
    ckpt_dir: str,
    device: Any = "cuda",
    params: Optional[Dict[str, Any]] = None,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Train ``steps`` steps from ``params`` (default: f32 weights drawn
    from seed 0 on ``device``), checkpointing every ``ckpt_every`` steps
    to the PMEM tier at ``ckpt_dir`` through a :class:`MarvelClient`.
    Returns the trained parameters, each step's loss and grad norm, the
    durable checkpoints' steps and the tokens per second of the steps
    (checkpoint staging included, the final drain not)."""
    device = torch.device(device)
    step_fn = make_train_step(cfg, shape, AdamWConfig(lr=lr, weight_decay=0.01),
                              device=device)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = init_params(model_defs(cfg), gen, device, dtype=torch.float32)
    opt = adamw_init(params)
    metrics = []
    # the checkpoint home is the client's declarative PMEM tier, the same
    # config surface every other Marvel workload uses
    with MarvelClient(ClusterConfig(
        name="train-lm", journal="none", invokers=1,
        tiers=(TierSpec("pmem", path=ckpt_dir),),
    )) as client:
        ckpt = CheckpointManager(client.state, cfg.name, keep=2)
        pipe = PipelineConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                              global_batch=shape.global_batch)
        t0 = time.perf_counter()
        try:
            for step in range(steps):
                params, opt, m = step_fn(params, opt, make_batch(pipe, step))
                metrics.append((m["loss"], m["grad_norm"]))
                if (step + 1) % 20 == 0:
                    dt = time.perf_counter() - t0
                    tok_s = (step + 1) * shape.global_batch * shape.seq_len / dt
                    log(f"step {step + 1:4d}  loss {float(m['loss']):.4f}  "
                        f"gnorm {float(m['grad_norm']):.2f}  {tok_s:,.0f} tok/s")
                if (step + 1) % ckpt_every == 0:
                    ckpt.save(step + 1, {"params": tree_leaves(params),
                                         "opt": tree_leaves(opt)})
            losses = [float(x) for x, _ in metrics]  # waits for the last step
            train_s = time.perf_counter() - t0
            ckpt.wait()
            dt = time.perf_counter() - t0
            durable = ckpt.steps()
            log(f"done in {dt:.1f}s; durable checkpoints at steps {durable}")
        finally:
            ckpt.close()
    return {"params": params, "losses": losses, "grad_norms": [float(g) for _, g in metrics],
            "checkpoints": durable,
            "tokens_per_s": steps * shape.global_batch * shape.seq_len / train_s}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--hundred-m", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "marvel_train_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, shape = build(args.hundred_m, args.seq, args.batch)
    print(f"model {cfg.name}: {cfg.approx_params() / 1e6:.1f}M params")
    return run(cfg, shape, steps=args.steps, lr=args.lr, ckpt_every=args.ckpt_every,
               ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
