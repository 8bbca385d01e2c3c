"""Serving launcher: batched prefill, then the decode loop.

The port of ``repro/launch/serve.py`` for one card.  A batch of prompts
is prefilled once (``make_prefill_step``: the caches collected with
headroom for every token to come), then decoded one token a step, greedy
or sampled at a temperature from an explicit ``torch.Generator``.  The
reference jits its steps; here they run eagerly, through the flash
kernel at prefill and the decode kernel at every step.  The reference
always serves its reduced config; ``--full`` serves the config at its
published widths.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --tokens 32 [--full] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import (
    ModelConfig,
    ShapeConfig,
    decode_step,
    init_params,
    model_defs,
    reduced_for_smoke,
)

__all__ = ["generate", "main"]


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) f32 logits -> (B, 1) int32: the argmax, or a draw from the
    softmax at ``temperature``."""
    if temperature <= 0:
        tok = torch.argmax(logits, dim=-1)
    else:
        probs = torch.softmax(logits / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return tok.to(torch.int32)[:, None]


def generate(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prompts: torch.Tensor,  # (B, P) int32, on the params' device
    tokens: int,
    *,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, Any]:
    """Prefill ``prompts`` with room for ``tokens`` more, then decode:
    the first new token from the prefill's last logits, each next one from
    a ``decode_step`` at the position after the last.  Returns the new
    tokens ``(B, tokens)`` int32 and the prefill's and decode loop's wall
    seconds (each ending in a device synchronise)."""
    B, P = prompts.shape
    shape = ShapeConfig(name="serve", kind="prefill", seq_len=P, global_batch=B,
                        remat="none")
    prefill = make_prefill_step(cfg, shape, cache_len=P + tokens)
    sync = (torch.cuda.synchronize if prompts.is_cuda else (lambda: None))
    with torch.no_grad():
        t0 = time.perf_counter()
        last_logits, caches = prefill(params, {"tokens": prompts})
        tok = _sample(last_logits, temperature, generator)
        sync()
        prefill_s = time.perf_counter() - t0
        out = [tok]
        t0 = time.perf_counter()
        for i in range(tokens - 1):
            logits, caches = decode_step(params, cfg, tok, caches, P + i)
            tok = _sample(logits, temperature, generator)
            out.append(tok)
        sync()
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prefill_s": prefill_s,
            "decode_s": decode_s}


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    if cfg.frontend != "tokens":
        raise SystemExit("the serving launcher takes token LMs")
    device = torch.device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(model_defs(cfg), gen, device)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=device, dtype=torch.int32)
    out = generate(params, cfg, prompts, args.tokens,
                   temperature=args.temperature, generator=gen)
    B, n = args.batch, args.tokens
    gen_tokens = out["tokens"].cpu().numpy()
    print(f"prefill {args.prompt_len} tok x{B}: {out['prefill_s'] * 1e3:.1f} ms")
    print(f"decode {n - 1} steps: {out['decode_s'] * 1e3:.1f} ms "
          f"({(n - 1) * B / max(out['decode_s'], 1e-9):.1f} tok/s)")
    for b in range(min(B, 2)):
        print(f"session {b}: {gen_tokens[b][:16].tolist()}...")
    return {**out, "tokens": gen_tokens}


if __name__ == "__main__":
    main()
