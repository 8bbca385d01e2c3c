#!/usr/bin/env python3
"""Drive Marvel's PyTorch/CUDA port on one GPU and check what comes out.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with an NVIDIA H100 (or
another sm_90a card).  It builds the port's CUDA kernels from
``src/repro_torch/csrc`` with ``nvcc`` into ``build/repro_torch/``, then:

1. prints the card's name and power limit, the torch and CUDA versions
   and the kernel build time; then makes the first launches of the flash,
   decode and SSD kernels (bf16 and f32) from 4 threads released at once,
   which races each kernel's per-device setup: every thread's output must
   be the bytes of a later call, which must match the plain version;
2. holds ``bucket_histogram`` against its plain PyTorch version and
   ``torch.bincount`` on the card, exactly: the contract's edge cases;
   every route edge (n_buckets in {1, 4, 16, 17, 58112, 58113, 131072,
   929792, 929793}, each below and above the one-cluster crossover); N in
   {1, 3, an unaligned view of 4099, 131032, the crossover - 1, itself and
   + 1}; all keys in one bucket; then 2^28 int32 keys (1 GiB, 10 %
   padding, 1 % >= n_buckets) for n_buckets in {4, 128, 32000, 131072}
   and 2^28 Zipf(1.1) keys over 32000, each with the kernel's route,
   event-timed and profiler device time, device operations a call, the
   plain version's and ``torch.bincount``'s times (CUDA events, median of
   15 after warm-up) beside the memory bound.  Every route (``regs``,
   ``smem``, ``global``) must have run;
3. runs ``device_histogram`` over 2^28 Zipf tokens (vocab 32000) against
   ``host_histogram``, and ``storage_histogram`` (8 shards through a DRAM
   tier) over 2^24 of them against the device result;
4. drives the main path, ``MarvelClient`` in device mode: WordCount over a
   64 MiB Zipf(0.5) corpus (the paper runs 1-15 GB; 64 MiB is what the
   host-side Python mapper gets through within the time limit), TeraSort
   over 2^19 100-byte records, WordCount with capacity spill over an 8 MiB
   Zipf(0.5) corpus of its own, and WordCount over a Zipf(1.1) corpus,
   whose reduces fall back to the host.
   Each output must be byte-identical to the same job in host mode, the
   first WordCount must reduce wholly on the device, and every kernel
   must have launched during this phase;
5. times ``bucket_histogram`` at the main path's largest shape, beside
   a launch floor (a one-element ``add_``): there a call must be one
   device operation, and a profiled window of 15 calls must show no
   device-attribute, function-attribute or occupancy query (a first call,
   profiled with the caches cleared, shows the profiler records them);
6. holds ``flash_attention`` and ``decode_attention`` against their plain
   versions (run in f32; tolerance 2e-2 for bf16, 2e-5 for f32) on the
   card: flash prefill at B=1, T=1024, H=16, Kv=2, dh=128, causal, then
   ragged T, T=1, softcap, dh 64 and 256 (and 256 with a window), MHA,
   non-causal, a window, f32 and f16, MLA's q/k head dim 192 against v
   head dim 128 (deepseek's prefill shape B=1, T=1024, H=16, then ragged
   T, T=1, non-causal Tq < Tk and f32), recurrentgemma's local shape
   (T=1024, 16 heads of 256 over one kv head, window 2048), T in {63, 64,
   65, 127, 129} causal and with a window (the edges of the 64-row
   tiles), Tq < Tk and Tq > Tk;
   every flash case on the route its type must take (tensor cores for
   bf16/f16) and run twice for the same bytes; a view whose strides TMA
   cannot take must raise ``ValueError``; decode over S=1088 at every
   length from 1 to S, rep 8, 6 (dbrx) and 1, dh 64, 128 and 256,
   softcap, a batch of 8 with mixed lengths, f32, a zero length (zeros
   out), recurrentgemma's full 2048-slot ring (16 heads of 256 over one
   kv head), and decode
   captured alone in a CUDA graph and replayed with new lengths (the
   bytes of the eager call); decode's log-sum-exp (``return_lse``)
   against the plain version's at the three decode path shapes (qwen S
   1088, recurrentgemma's ring S 1056 at dh 256, dbrx S 1032; lengths
   1025 and 500; 2e-2 abs, as flash's) with the output unchanged by the flag, and the
   qwen cache cut into 4 blocks of 272 rows, one launch a block with its
   own lengths, combined by ``combine_partials``' arithmetic against one
   launch over the whole (the decode tolerance); the flag's time there;
7. drives the serving path, ``MarvelClient.serving`` over a DRAM + PMEM
   tier stack with a PMEM journal, at the full width of qwen2.5-3b (36
   layers, d_model 2048, 16 heads over 2 kv heads, vocab 151936; random
   bf16 weights drawn on the card from ``--seed``), prompts of 1024
   tokens and 64 tokens of headroom: 8 conversations interleaved over a
   warm pool of 4, so evictions demote their KV caches to int8 and their
   next steps decode from it (tokens per second printed); a lossless pool
   where a conversation suspended to PMEM and resumed decodes the same
   tokens and leaves byte-identical block blobs as one never suspended; a
   restart (a second client over the same durable config) that re-adopts
   every session and decodes on exactly as the uninterrupted run; and
   decode-step logits against a fresh prefill over the same tokens
   (relative L2 error <= 2e-2).  Both attention kernels must have
   launched after the resume and after the restart;
8. replays a seeded multi-tenant trace (``core/loadgen.py``) at
   ``MarvelClient.serving`` over phase 7's weights: 3 tenants (Zipf 0.8)
   of 4 conversations, 12 s, a 4x burst on t0 from 4 s for 3 s, the base
   rate half the hot steps per second one invoker sustained in phase 7's
   lossless pool; a lossless pool over a warm pool of 4, so evictions
   demote while other conversations decode.  Cell ``fixed`` has one
   invoker; cell ``auto`` runs under ``MarvelClient.autoscaler`` (1 to 4
   invokers, pumped from the replay), so decode steps and demotions run on
   several invoker threads at once.  Each cell prints its p99 latency per
   tenant and overall, windowed p99-under-SLO share (1000 ms, 1 s
   windows), goodput, sheds, decode tokens per second, scale actions,
   peak invokers, t0's isolation ratio and the KV pressure; it must have
   no error, conserve every tenant's counts, and launch flash 36 times a
   conversation started and decode 36 times a step; ``auto`` must scale
   up, reach 2 invokers or more and come back to 1 after the drain.
   Every conversation's tokens must equal the same conversation's served
   alone in a fresh pool;
9. holds ``ssd_chunk`` (the Mamba-2 SSD within-chunk kernel) against its
   plain version (tolerance 2e-3 abs and rel; every case run twice and
   compared bit for bit): the prefill's shape (BC=4, Q=256, H=80, P=64,
   N=128, B/C one group read with a head stride of 0, which must give
   the bytes of a per-head copy), per-head B/C, Q in {1, 37}, H=6 and
   H=13 (no multiple of a block's heads), P and N over {16, 32, 64, 128},
   and a strongly negative dA_cs whose upper-triangle exp overflows in
   the exp-then-mask oracle;
10. drives ``MarvelClient.serving`` over Mamba-2 at the full width of
   mamba2-2.7b (64 SSD layers, d_model 2560, 80 heads of 64, d_state
   128, chunk 256, vocab 50280; random bf16 weights drawn on the card
   from ``--seed``, dt, A and the output projection as Mamba-2's
   published init sets them), prompts of 1024 tokens, the same tier
   stack and journal: 4 conversations interleaved over a warm pool of 2, so every step evicts a conversation's recurrent state
   (64 x 80 x 64 x 128 f32, 168 MB, and a 2 MB conv window) to PMEM and
   resumes another onto the card; lossless suspend/resume byte
   identity; a restart that re-adopts every session; decode-step logits
   (the recurrent form) against a fresh prefill over 1024 plus the new
   tokens (the kernel, with the chunk padding), relative L2 <= 2e-2 with
   the served weights computed in f32 (the bf16 error, which this random
   64-layer model amplifies to a few percent, is printed beside it).
   The SSD kernel must have launched after the resume and after the
   restart;
11. serves recurrentgemma-9b at full width (38 blocks: 26 RG-LRU, 12
   local attention with a 2048-slot ring; d_model 4096, lru_width 4096,
   16 heads of 256 over 1 kv head, vocab 256000; 10.4 B parameters) the
   way phase 10 serves Mamba-2: 4 conversations over a warm pool of 2,
   prompts of 1024 tokens, lossless, each eviction pushing the RG-LRU
   states and the attention rings to PMEM; lossless suspend/resume byte
   identity; a restart that re-adopts every session; decode-step logits
   against a fresh prefill (relative L2 <= 2e-2, the served weights
   computed in f32, the bf16 error printed beside it); a profile of the
   bare step.  Flash and decode must have launched after the resume and
   after the restart;
12. the same for deepseek-v2-lite-16b at full width (27 layers, MLA with
   kv_lora 512, 64 routed experts top-6 and 2 shared, vocab 102400; 15.7
   B parameters): the expanded prefill runs flash at q/k 192 against v
   128, decode is the absorbed form over a 34 MB latent cache that the
   pager writes whole every step (its share of the step printed), the
   MoE decode reads every expert (its device time printed beside the
   bound of that read); each MoE layer's expert histogram over the
   prefill, with the embedding drawn at unit variance as served and at
   its own init scale; decode against prefill at capacity factor 8, as
   the reference's own decode test sets it;
13. runs dbrx-132b at full width cut to 2 layers (d_model 6144, 48 heads
   over 8, 16 experts top-4 of 10752; 7.7 B parameters): one 1024-token
   prefill, 8 greedy decode steps, its routing as in 12, decode against
   prefill at capacity factor 8 in f32, and a profile of the bare step;
   then times flash and decode at its shapes on seeded inputs;
14. training, last: holds the flash forward's log-sum-exp and the flash
   backward kernel (``csrc/flash_attention_bwd.cu``) against their plain
   versions in f32 (relative L2 of dq, dk, dv <= 2e-2 for bf16/f16, 1e-4
   for f32), every case run twice for the same bits: the training shape
   (B=1, T=4096, H=16, Kv=2, dh 128, causal, bf16), dh 64 and 256 over
   one kv head, rep 1 not causal, gemma2-9b's softcap 50 and window 4096
   over 4160 tokens, T=1000, f32, f16 with a window at dh 64 and at dh
   256 over 333 tokens, and 1000 queries over 1536 keys not causal with
   a softcap (TMA's rows past Tq); bf16 and f16 take the tensor-core
   route at every head dim, f32 the 3xTF32 one (``tf32x3``); times the backward
   at the training shape (event and device ms) beside SDPA's forward and
   backward, the plain version
   and its bounds, and the forward at T=4096; holds the f32 route
   (``tf32x3``) forward and backward at every pair of head dims (dh 64
   ragged, dh 256 with a window, dh 128 with a softcap not causal over
   more keys than queries, MLA's (192, 128) ragged; forward 2e-5,
   backward 1e-4, each backward run twice for the same bits); times both
   f32 routes at the ``f32_route`` case's shape the same way
   (``flash_f32_path_shape``, ``flash_bwd_f32_shape``: event and device
   ms, the bound at the TF32 peak, SDPA's f32 calls and their backend, the
   plain versions) and the f32 decode route at the qwen decode shape
   (``decode_f32_path_shape``); then ``loss.backward()`` of qwen2.5-3b at full
   width cut to 2 layers (one sequence of 1024, f32, remat "full")
   through the kernels and through the plain versions, each parameter's
   gradient within relative L2 1e-3; then trains qwen2.5-3b at full width
   (36 layers, f32 masters, bf16 compute, 4 sequences of 4096 tokens in 4
   microbatches a step, remat "full", AdamW lr 3e-4) for 4 steps through
   ``make_train_step``: every loss and grad norm finite, the last loss
   below the first, the forward and backward kernels launched 288 and
   144 times a step, no plain version reached; it prints each step's
   loss, grad norm, ms and tokens/s, the peak memory, one profiled
   step's device ms split into GEMMs, flash forward and backward and the
   rest, AdamW's and the loss's ms; then the training loop of
   ``launch.train`` (``train``) over the model cut to 2 layers, straight
   through 3 steps and again with a checkpoint to a PMEM tier at step 2
   and a crash at step 3: the replayed losses must equal the
   uninterrupted run's (checkpoint bytes, staging, drain and restore
   times printed);
15. training the recurrent mixers: holds the SSD chunk's backward kernel
   (``csrc/ssd_scan_bwd.cu``) against its plain version (relative L2 of
   dx, ddt, ddA_cs, dB, dC <= 1e-4, f32; every case run twice for the
   same bits, every gradient finite): mamba2-2.7b's training shape (BC
   16, Q 256, H 80, P 64, N 128, one B/C group), a ragged Q of 100,
   per-head B/C at H 8, P = N = 16, and a strong decay (dt 0.7, A -1,
   Q 256) whose upper-triangle exp overflows; times it at the training
   shape (event and device ms, by kernel) beside the plain version and
   its bound, and the forward there; then ``loss.backward()`` of
   mamba2-2.7b at full width cut to 2 layers (seq 1024, f32, remat
   "full") through both SSD kernels and through their plain versions,
   every gradient within relative L2 1e-3 and the launches exactly 2 a
   layer forward and 1 backward; then trains mamba2-2.7b at full width
   cut to 16 of its 64 layers (4 x 4096 tokens a step in 4 microbatches,
   remat "full", bf16 compute, AdamW lr 3e-4, Mamba-2's published dt and
   A) for 3 steps and recurrentgemma-9b at full width cut to one period
   (5 blocks) for 2, each as phase 14 trains qwen2.5-3b: finite losses
   and grad norms, the last loss below the first, ``ssd_chunk`` launched
   128 times a step forward and its backward 64 (recurrentgemma: flash 8
   and 4), no plain version reached, one profiled step's device ms split
   into GEMMs, the flash and SSD kernels and the rest; and times the
   flash backward (route ``wgmma``, its device ms below SDPA's forward
   and backward) and forward at recurrentgemma's local training shape
   (16 heads of 256 over one, window 2048, T 4096);
16. training MLA and MoE: holds the flash backward at MLA's (q/k, v)
   head dims (192, 128) against its plain version, every case run twice
   for the same bits: deepseek-v2-lite-16b's training shape (B=1, T=4096,
   16 heads over 16, causal, scale 1/√192, bf16), T=1000, T=1 (where dq
   and dk cancel to 0 in exact arithmetic: held against the norm of the
   cancelling terms), f16, f32 (route ``tf32x3``) and 1000 queries
   over 1536 keys not causal (relative L2 <= 2e-2 for bf16/f16, 1e-4 for
   f32; bf16/f16 on route ``wgmma``), and a q view whose strides TMA
   cannot take must raise ``ValueError``; times it at the training shape
   (event and device ms by kernel) beside SDPA's forward and backward
   (the backend SDPA picks printed), the plain version and the bounds,
   and the forward there; then ``loss.backward()`` of deepseek-v2-lite-16b
   at full width cut to the dense prelude and one MoE period (seq 1024,
   f32, remat "full") through the kernels, twice (every gradient the same
   bits) and through the plain versions (relative L2 1e-3); one MoE
   layer at full width forward and backward twice (the same bits) and
   under ``torch.use_deterministic_algorithms(True)``, which must not
   raise; then trains deepseek-v2-lite-16b at full width (d_model 2048,
   MLA kv_lora 512, 64 experts top-6 and 2 shared, vocab 102400) cut to
   the dense prelude and 4 MoE periods (2.84 B parameters) as phase 14
   trains qwen2.5-3b: 3 steps of 4 x 4096 tokens in 4 microbatches,
   remat "full", bf16 compute, AdamW lr 3e-4; finite losses and grad
   norms, the last loss below the first, flash launched 36 times a step
   forward (the prelude once, each MoE period's layer twice under remat,
   per microbatch) and 20 backward, no plain version reached; then
   ``python -m repro_torch.examples.train_lm --hundred-m`` for 20 steps
   (losses finite and falling, its checkpoint durable in the client's
   PMEM tier) and the serving launcher ``python -m
   repro_torch.launch.serve --full --arch gemma-2b`` (4 prompts of 32
   tokens, 16 greedy tokens each; flash once a layer, decode once a layer
   a step); then the reference's other examples on the port:
   ``repro_torch.examples.mapreduce_device`` at the reference's size
   (2^16 tokens over a vocab of 8192: the three paths' counts equal, 0
   dropped, ``bucket_histogram`` launched), ``serve_lm``'s ``run`` over
   the reference's Zipf trace (23 conversations, prompts of 8 tokens, 16
   tokens each, a warm pool of 8 over PMEM, then a restart) at
   qwen2.5-3b's full width in bf16 (every token in the vocabulary,
   demotions and resumes, every conversation re-adopted, flash once a
   layer a prefill and decode once a layer a decode step), and
   ``quickstart`` and ``iterative_dataflow`` on the card's host (every
   tier's output the same, the quota error raised, every task resumed,
   PageRank's outputs identical, TeraSort globally sorted);
17. sharding over ``torch.distributed`` on the one card: NCCL at world
   size 1 through ``launch.process_group`` (a file rendezvous in the
   run's temporary directory), meshes (1,) over "data" and (1, 1) over
   ("data", "model"); ``device_histogram`` through the (1,) mesh, byte
   for byte the one-device call on 2^24 Zipf(1.1) keys over 32000
   buckets (both calls' ms printed); ``moe_apply_a2a`` and
   ``moe_apply_gather`` on the (1, 1) mesh for one deepseek-v2-lite-16b
   MoE layer at full width (2 x 512 tokens) against ``moe_apply_dense``
   in f32 (2e-4 abs and rel, the reference's own limit) and in bf16
   (relative L2 2e-2 against the dense path in f32); the process group
   is gone afterwards.  No time across cards is measured;
18. the sharded train step at world size 1 (``phase_sharded_train``): NCCL,
   a (1, 1) mesh, qwen2.5-3b at full width cut to 4 layers, 3 steps of 2
   sequences of 4096 in 2 microbatches, bf16, remat "full":
   ``make_train_step(mesh=...)`` with ``zero1`` off and on and with
   ``compress_grads``, each against ``mesh=None`` from the same drawn
   parameters and batches: losses and grad norms within 1e-6 relative,
   the parameters within 1e-6 relative L2, whether they are bit-equal,
   the flash forward and backward launches a step equal to the
   one-process step's, each run's peak memory and seconds; at most 40 s;
19. the sharded train step of the other mixers at world size 1
   (``phase_sharded_mixers``): NCCL, a (1, 1) mesh, mamba2-2.7b cut to 2
   layers at 4096, recurrentgemma-9b at one (R, R, L) period and
   deepseek-v2-lite-16b at its prelude and 1 MoE period at 2048, 2 steps
   of 2 sequences in 2 microbatches each, bf16, remat "full", against
   ``mesh=None`` from the same drawn parameters and batches: losses, grad
   norms and parameters bit-equal, the SSD chunk's or flash attention's
   forward and backward launches a step equal to the one-process step's,
   each run's peak memory and seconds; at most 30 s;
20. prefill and decode on a mesh at world size 1
   (``phase_sharded_serve``): NCCL, a (1, 1) mesh, bf16, qwen2.5-3b at
   full width (36 layers; 2 prompts of 1024 tokens into a cache of 1040,
   16 greedy steps, and again from the cache quantized to int8),
   mamba2-2.7b at 2 layers, recurrentgemma-9b at one (R, R, L) period and
   its postlude, deepseek-v2-lite-16b at its prelude and 1 MoE period (2
   prompts of 1024, 8 steps each): ``make_prefill_step`` and
   ``make_decode_step(mesh=...)`` against ``mesh=None``, the logits,
   greedy tokens and every cache leaf bit-equal, the prefill's flash or
   SSD launches and decode's launches a step equal (one a step for each
   attention layer); each run's launches, peak memory and seconds; at
   most 25 s;
21. the dry run and a whole step's roofline (``phase_dryrun``): the
   dry-run CLI (``repro_torch.launch.dryrun``) in a subprocess on the
   reference test's cells, each traced on fake ``cuda`` tensors as rank 0
   of a fake world of 256 or 512 (gemma-2b decode_32k on 16x16 and
   2x16x16, mamba2-2.7b long_500k; hubert-xlarge decode_32k and
   qwen2.5-3b long_500k skipped with the reference's reasons), started
   before phase 17 and run beside phases 17-20 (``DryrunCells``: a fresh
   interpreter there spends most of its run on imports), every record's
   roofline terms printed; three steps counted for real on the card
   under ``CostCounter`` and traced on fake stand-ins
   (qwen2.5-3b's train step at 4 layers, 2 x 4096; mamba2-2.7b's prefill
   at 2 layers; one qwen2.5-3b decode step at 36 layers over 1040 rows):
   dot FLOPs and the kernels' calls, FLOPs and bytes equal, the calls
   equal to the launch counters' deltas, no collective bytes, the fake
   peak memory within 0.5-2x of the card's; qwen's step roofline from
   its counts beside the median of 3 timed steps; at most 30 s;
22. prints a ``kernels`` JSON line: each kernel's launches on its path
   (counts set to 0 just before the path runs and read just after), its
   checks and largest error, and its times at its path's shape beside
   the plain version's, the PyTorch library call's (``torch.bincount``,
   ``scaled_dot_product_attention``; a yardstick only; none computes the
   SSD chunk) and the bound; every row also carries its kernel route and
   its device-only time from the profiler (and the library call's for
   the histogram, flash and decode; flash and decode also carry their
   launches on phase 8's path and on phases 11-13's, and their times at
   those paths' shapes: flash at recurrentgemma's local and deepseek's
   MLA prefill, dbrx's and the training shapes, decode at recurrentgemma's
   ring and dbrx's), since an event-timed ``ms`` includes
   the wrapper's host time.  The ``flash_attention_bwd`` row counts its
   launches on the training path and carries SDPA's forward and backward
   as its library time (and the backend SDPA picked), recurrentgemma's and
   deepseek's training launches and shapes, and the f32 route's time at
   its case's shape beside its bound at the TF32 peak and SDPA's f32
   forward and backward;
   the ``ssd_chunk`` row its mamba2-2.7b training launches and shape, and
   the ``ssd_chunk_bwd`` row its launches there, its checks and time; the
   ``decode_attention`` row also its time with ``return_lse`` and phase
   20's launches a step.
   Decode and the SSD forward must make one launch a call, of their own
   kernel, the SSD backward three.

The build prints ptxas's registers, shared memory and spills for every
kernel, and fails if a flash forward or backward, decode, SSD forward or
SSD backward kernel spills.  The serving
phases' profiles also read one prefill's device time and the flash and
SSD kernels' shares of it, and a decode step's launches and decode
kernels.

Every check that fails raises, and the script exits non-zero.  The last
line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
REPS = 15
START = time.perf_counter()  # the run's clock for the profiler's lines
# Sizes of the run (see the module docstring for why these).
KERNEL_KEYS = 1 << 28  # 1 GiB of int32 keys
SHUFFLE_TOKENS = 1 << 28  # 1 GiB of tokens plus 1 GiB of values
STORAGE_TOKENS = 1 << 24
CORPUS_BYTES = 64 << 20
SPILL_CORPUS_BYTES = 8 << 20  # the capacity-spill WordCount's own corpus
TERASORT_RECORDS = 1 << 19
SERVE_MODEL = "qwen2.5-3b"  # full width: 36 layers, d_model 2048, GQA 16/2
SERVE_PROMPT = 1024
SERVE_MAX_TOKENS = 64
SERVE_CONVS = 8  # twice the warm pool, so evictions demote to int8
INT8_STEPS = 6  # decode steps per conversation in the int8 pool
LOSSLESS_STEPS = 16  # decode steps of the lossless identity check
SSM_MODEL = "mamba2-2.7b"  # full width: 64 layers, d_model 2560, 80 heads of 64
SSM_PROMPT = 1024
SSM_MAX_TOKENS = 32
SSM_CONVS = 4  # twice the warm pool of 2, so every step evicts and resumes
SSM_STEPS = 3  # interleaved decode steps per conversation
SSM_LOSSLESS_STEPS = 8
RG_MODEL = "recurrentgemma-9b"  # full width: 38 blocks, d_model 4096, 16 heads of 256 over 1
MLA_MODEL = "deepseek-v2-lite-16b"  # full width: 27 layers, MLA, 64 experts top-6 + 2
MOE_MODEL = "dbrx-132b"  # full width, depth cut: d_model 6144, 16 experts top-4
MIXER_PROMPT = 1024
MIXER_MAX_TOKENS = 32
MIXER_CONVS = 4  # twice the warm pool of 2, so every step evicts and resumes
MIXER_STEPS = 2  # interleaved decode steps per conversation
MIXER_LOSSLESS_STEPS = 8
MOE_LAYERS = 2  # dbrx-132b's 40 layers cut to 2 (7.7 B parameters)
MOE_STEPS = 8
MOE_EMBED_GAIN = 50.0  # a MoE model's embedding init 0.02 -> unit variance
MOE_CAPACITY = 8.0  # decode-vs-prefill capacity factor, as the reference's test


class SmokeError(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, reps: int = REPS, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
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


def bytes_bound_ms(nbytes: int) -> float:
    """``nbytes`` over the card's memory rate (``launch/roofline.py``'s
    data-sheet constant), in ms."""
    from repro_torch.launch.roofline import HBM_BW

    return nbytes / HBM_BW * 1e3


# -- phase 1b: first launches from several threads at once -------------------

FIRST_LAUNCH_THREADS = 4


def phase_first_launch_threads(dev, seed: int) -> None:
    """The first launches in this process of the flash, decode and SSD
    kernels (bf16 and f32 routes), made by several threads released at
    once: each kernel sets its attributes on its first launch on a device,
    so this races that setup.  Every thread's output must be the bytes of
    a later call on the main thread, which must match the plain version."""
    import threading

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan

    g = torch.Generator(device=dev).manual_seed(seed + 11)
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = flash_inputs(g, dev, 1, 128, 16, 2, 128, dtype)
        cases.append((f"flash_{str(dtype)[6:]}", fa.flash_attention, (q, k, v)))
        lengths = torch.tensor([100, 256], dtype=torch.int32, device=dev)
        dargs = (_randn(g, (2, 16, 128), dtype, dev),
                 _randn(g, (2, 256, 2, 128), dtype, dev),
                 _randn(g, (2, 256, 2, 128), dtype, dev), lengths)
        cases.append((f"decode_{str(dtype)[6:]}", da.decode_attention, dargs))
    cases.append(("ssd_chunk", ssd_scan.ssd_chunk_fwd,
                  ssd_inputs(g, dev, 2, 64, 8, 64, 128)))
    torch.cuda.synchronize()
    barrier = threading.Barrier(FIRST_LAUNCH_THREADS)
    outs = [None] * FIRST_LAUNCH_THREADS
    failures = []

    def run(i: int) -> None:
        try:
            barrier.wait()
            outs[i] = [fn(*args) for _, fn, args in cases]
            torch.cuda.synchronize()
        except BaseException as exc:  # reported below, on the main thread
            failures.append(f"thread {i}: {exc!r}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(FIRST_LAUNCH_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not failures, f"first launches from {FIRST_LAUNCH_THREADS} "
          f"threads failed: {failures}")
    flash_rec, decode_rec, ssd_rec = (AttnRecord("flash_attention"),
                                      AttnRecord("decode_attention"), SSDRecord())
    errs = {}
    for c, (case, fn, args) in enumerate(cases):
        again = fn(*args)
        for i in range(FIRST_LAUNCH_THREADS):
            got = outs[i][c]
            same = (all(torch.equal(a, b) for a, b in zip(got, again))
                    if isinstance(got, tuple) else torch.equal(got, again))
            check(same, f"{case}: thread {i}'s first launch gave other bytes "
                  "than a later call")
        if case.startswith("flash"):
            q, k, v = args
            errs[case] = flash_rec.compare(case, again, fa.flash_attention_torch(
                q.float(), k.float(), v.float()), q.dtype)
        elif case.startswith("decode"):
            q, kc, vc, lengths = args
            errs[case] = decode_rec.compare(case, again, da.decode_attention_torch(
                q.float(), kc.float(), vc.float(), lengths), q.dtype)
        else:
            errs[case] = ssd_rec.compare(case, args)
    emit("first_launch_threads", threads=FIRST_LAUNCH_THREADS,
         max_abs_err=errs, identical_across_threads=True, ok=True)


# -- phase 2: the kernel against its plain version ----------------------------

class KernelRecord:
    """What the ``kernels`` line reports for ``bucket_histogram``, and the
    routes its checks ran."""

    def __init__(self) -> None:
        self.max_abs_err = 0
        self.checks = 0
        self.routes: set = set()

    def compare(self, keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
        from repro_torch.kernels import bucket_histogram as bh

        got = bh.bucket_histogram(keys, n_buckets)
        plain = bh.bucket_histogram_torch(keys, n_buckets)
        valid = keys[(keys >= 0) & (keys < n_buckets)]
        library = torch.bincount(valid, minlength=n_buckets)
        torch.cuda.synchronize()
        err = int((got.long() - plain.long()).abs().max())
        self.max_abs_err = max(self.max_abs_err, err)
        self.checks += 1
        self.routes.add(hist_plan(keys, n_buckets).route)
        check(got.dtype == torch.int32 and got.shape == (n_buckets,),
              f"kernel output {got.dtype} {tuple(got.shape)}")
        check(torch.equal(got, plain), f"kernel != plain (n={keys.numel()}, "
              f"n_buckets={n_buckets}, max abs err {err})")
        check(torch.equal(got.long(), library),
              f"kernel != torch.bincount (n={keys.numel()}, n_buckets={n_buckets})")
        return got

    def measure(self, keys: torch.Tensor, n_buckets: int) -> dict:
        """The kernel's route, event-timed and device time and device
        operations a call, the plain version's and ``torch.bincount``'s
        times, and the bound (the keys read and the counts written once)."""
        from repro_torch.kernels import bucket_histogram as bh
        from repro_torch.launch.roofline import kernel_work

        self.compare(keys, n_buckets)
        valid = keys[(keys >= 0) & (keys < n_buckets)]
        kernel = lambda: bh.bucket_histogram(keys, n_buckets)  # noqa: E731
        library = lambda: torch.bincount(valid, minlength=n_buckets)  # noqa: E731
        before = bh.launches
        kernel_ms = time_ms(kernel)
        launches = bh.launches - before
        dev_ms, ops, _, _ = device_profile(kernel, op_keys=OP_KEYS)
        plain_ms = time_ms(lambda: bh.bucket_histogram_torch(keys, n_buckets))
        library_ms = time_ms(library)
        n = keys.numel()
        plan = hist_plan(keys, n_buckets)
        work = kernel_work("bucket_histogram", keys, n_buckets)
        return {
            "n": n, "n_buckets": n_buckets, "kernel_route": plan.route,
            "one_cluster": plan.single, "kernel_ms": kernel_ms,
            "device_ms": dev_ms, "device_ops_per_call": ops,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": device_ms(library),
            "bound_ms": work.bound_ms, "bound_by": work.bound_by,
            "launches": launches,
        }


def hist_plan(keys: torch.Tensor, n_buckets: int):
    """The plan ``bucket_histogram`` runs for these keys (prepared by the
    call before it)."""
    from repro_torch.kernels import bucket_histogram as bh

    return bh._call_for(keys.get_device(), keys.numel(), n_buckets).plan


#: n_buckets at the edges of the histogram's routes: regs up to 16, smem
#: up to what one block's shared memory holds (58112 on the H100), global
#: above it (and past 16 blocks of it)
HIST_ROUTE_EDGES = (1, 4, 16, 17, 58112, 58113, 131072, 929792, 929793)


def phase_kernel(dev, seed: int, rec: KernelRecord, n: int) -> None:
    from repro_torch.kernels import bucket_histogram as bh

    g = torch.Generator(device=dev).manual_seed(seed)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device=dev,
                             dtype=torch.int32)

    exact = torch.zeros((1 << 24) + 65, dtype=torch.int32, device=dev)
    exact[-64:] = 2
    edges = {
        "empty": (torch.zeros(0, dtype=torch.int32, device=dev), 8),
        "below_block": (randint(-1, 8, 5), 8),
        "all_padding": (torch.full((64,), -1, dtype=torch.int32, device=dev), 8),
        "over_range": (randint(-3, 20, 777), 8),
        "unaligned_view": (randint(-1, 9, 4099)[3:], 8),
        "global_70000": (randint(-1, 70000, 100003), 70000),
    }
    for name, (keys, nb) in edges.items():
        got = rec.compare(keys.contiguous(), nb)
        emit("kernel_edge", case=name, n=keys.numel(), n_buckets=nb, ok=True,
             total=int(got.sum()))
    got = rec.compare(exact, 4)
    check(int(got[0]) == (1 << 24) + 1, "int32 count past 2^24 is not exact")
    emit("kernel_edge", case="exact_past_2^24", n=exact.numel(), n_buckets=4,
         ok=True, count=int(got[0]))
    f32 = bh.bucket_histogram(exact, 4, out_dtype=torch.float32)
    check(f32.dtype == torch.float32, "out_dtype float32 ignored")
    del exact

    # every route edge, as one cluster and as a grid of clusters
    over = 4 * bh.CROSSOVER + 5
    for nb in HIST_ROUTE_EDGES:
        for m in (100003, over):
            keys = randint(-1, nb + nb // 50 + 2, m)
            rec.compare(keys, nb)
            plan = hist_plan(keys, nb)
            emit("kernel_edge", case="route_edge", n=m, n_buckets=nb,
                 route=plan.route, one_cluster=plan.single, ok=True)
    # N at its edges: tiny, unaligned, the main path's, the crossover
    sizes = {"1": (1, 0), "3": (3, 0), "unaligned_4099": (4099, 3),
             "131032": (131032, 0)}
    for d in (-1, 0, 1):
        sizes[f"crossover{d:+d}"] = (bh.CROSSOVER + d, 0)
    for name, (m, offset) in sizes.items():
        for nb in (4, 17, 131072, 929793):
            keys = randint(-1, nb + 2, m + offset)[offset:]
            rec.compare(keys, nb)
        emit("kernel_edge", case=f"n_{name}", n=m, ok=True,
             one_cluster=hist_plan(keys, 4).single)
    card = bh._devices[dev.index]
    check(bh._plan(bh.CROSSOVER, 4, *card).single
          and not bh._plan(bh.CROSSOVER + 1, 4, *card).single,
          "the one-cluster crossover is not where the plan says")
    # worst contention: every key in one bucket
    for nb in (4, 128, 131072, 929793):
        keys = torch.full((1 << 22,), min(nb - 1, 5), dtype=torch.int32,
                          device=dev)
        rec.compare(keys, nb)
        emit("kernel_edge", case="one_bucket", n=keys.numel(), n_buckets=nb,
             route=hist_plan(keys, nb).route, ok=True)
    del keys
    torch.cuda.empty_cache()

    for nb in (4, 128, 32000, 131072, "zipf"):
        if nb == "zipf":  # Zipf(1.1): about 14 % of the keys hit bucket 0
            nb, keys = 32000, zipf_tokens(n, 32000, g, dev)
            label = "zipf1.1"
        else:
            keys = randint(0, nb, n)
            u = torch.rand(n, generator=g, device=dev)
            keys[u < 0.10] = -1  # padding
            keys[(u >= 0.10) & (u < 0.11)] = nb + 7  # dropped: >= n_buckets
            del u
            label = "uniform"
        emit("kernel", keys=label, **rec.measure(keys, nb))
        del keys
        torch.cuda.empty_cache()
    check(rec.routes == {"regs", "smem", "global"},
          f"bucket_histogram routes checked: {sorted(rec.routes)}")


def hist_at_main_shape(rec: KernelRecord, largest: dict) -> dict:
    """``bucket_histogram`` at the main path's largest shape, beside a
    launch floor: one call must be one device operation, and a window of
    15 calls must make no device-attribute, function-attribute or
    occupancy query (and no call of the wrapper's own per-device set-up),
    where a first call with the caches cleared shows that the profiler
    records such queries."""
    from repro_torch.kernels import bucket_histogram as bh

    keys, nb = largest["dest"], largest["n_parts"]
    shape = rec.measure(keys, nb)
    floor = torch.zeros(1, device=keys.device)
    add = lambda: floor.add_(1)  # noqa: E731
    shape["launch_floor_ms"] = time_ms(add)
    shape["launch_floor_device_ms"] = device_ms(add)

    def queries(events) -> list:
        return sorted({e.key for e in events if e.key.startswith(QUERY_KEYS)})

    bh._devices.clear()
    bh._calls.clear()
    first = queries(traced(lambda: bh.bucket_histogram(keys, nb))[0])
    setups = []
    real = bh._configure
    bh._configure = lambda *a: setups.append(a) or real(*a)
    try:
        events = profile_window(lambda: bh.bucket_histogram(keys, nb))[0]
    finally:
        bh._configure = real
    window = queries(events)
    check(bool(first), "the profiler recorded no query of a first call: "
          "the window's check would see nothing")
    shape.update(queries_first_call=first, queries_in_window=window,
                 setups_in_window=len(setups))
    check(shape["device_ops_per_call"] == 1,
          f"bucket_histogram made {shape['device_ops_per_call']} device "
          "operations a call at the main path's shape: want 1")
    check(not window and not setups,
          f"bucket_histogram queried the device per call: {window}, "
          f"{len(setups)} set-ups")
    return shape


# -- phase 3: the device shuffle -----------------------------------------------

def zipf_tokens(n: int, vocab: int, g, dev, a: float = 1.1) -> torch.Tensor:
    """Zipf(a) ranks truncated to ``vocab``, by inverse CDF on the device."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(ranks ** -a, 0)
    cdf = (cdf / cdf[-1]).float()
    u = torch.rand(n, generator=g, device=dev)
    return torch.searchsorted(cdf, u, out_int32=True).clamp_(max=vocab - 1)


def phase_shuffle(dev, seed: int, n: int, n_storage: int) -> None:
    from repro_torch.core.device_shuffle import (
        device_histogram, host_histogram, storage_histogram,
    )
    from repro_torch.storage import DramTier

    vocab = 32000
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    keys = zipf_tokens(n, vocab, g, dev)
    values = torch.ones(n, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = device_histogram(keys, values, 1, vocab=vocab, device=dev)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    keys_h, values_h = keys.cpu().numpy(), values.cpu().numpy()
    t0 = time.perf_counter()
    want = host_histogram(keys_h, values_h, vocab)
    host_s = time.perf_counter() - t0
    got = res.counts.cpu().numpy()
    check(got.dtype == np.int32 and got.shape == (vocab,),
          f"device_histogram counts {got.dtype} {got.shape}")
    check(np.array_equal(got, want), "device_histogram != host_histogram")
    check(int(res.dropped) == 0, f"device_histogram dropped {int(res.dropped)}")
    emit("device_histogram", tokens=n, vocab=vocab, wall_s=device_s,
         host_histogram_s=host_s, shuffled_bytes=res.shuffled_bytes,
         buffer_bytes=res.buffer_bytes, dropped=int(res.dropped), equal=True)
    del res, values
    torch.cuda.empty_cache()

    sub = keys[:n_storage]
    ones = torch.ones(n_storage, dtype=torch.int32, device=dev)
    dev_res = device_histogram(sub, ones, 1, vocab=vocab, device=dev)
    tier = DramTier()
    t0 = time.perf_counter()
    st = storage_histogram(keys_h[:n_storage], values_h[:n_storage], 8, tier,
                           vocab=vocab, spill=True, device=dev)
    storage_s = time.perf_counter() - t0
    check(torch.equal(st.counts, dev_res.counts),
          "storage_histogram != device_histogram")
    check(int(st.dropped) == 0, "storage_histogram dropped pairs")
    emit("storage_histogram", tokens=n_storage, ndev=8, wall_s=storage_s,
         shuffled_bytes=st.shuffled_bytes, buffer_bytes=st.buffer_bytes,
         spilled=st.spilled, equal=True)


# -- phase 4: the main path ------------------------------------------------------

def zipf_corpus(nbytes: int, vocab_size: int, seed: int, a: float) -> bytes:
    """Newline-separated lines of 16 words drawn with Zipf exponent ``a``
    over ``vocab_size`` hex words, the shortest the most frequent
    (leading bytes and lengths vary, so partitions spread)."""
    rng = np.random.default_rng(seed)
    vocab = np.array([f"{i:x}".encode() for i in range(vocab_size)], dtype=object)
    p = np.arange(1, vocab_size + 1, dtype=np.float64) ** -a
    p /= p.sum()
    words: list = []
    size = 0
    while size < nbytes:
        ids = rng.choice(vocab_size, 1 << 20, p=p)
        chunk = vocab[ids]
        lines = [b" ".join(chunk[i : i + 16]) for i in range(0, len(chunk), 16)]
        block = b"\n".join(lines) + b"\n"
        words.append(block)
        size += len(block)
    data = b"".join(words)[:nbytes]
    return data[: data.rfind(b"\n")]


def terasort_parts(n_records: int, n_parts: int, seed: int) -> list:
    """gensort-style ASCII records: a 10-byte printable key, then a row id
    and filler, 100 bytes with the newline."""
    rng = np.random.default_rng(seed)
    rec = np.full((n_records, 100), ord("A"), dtype=np.uint8)
    rec[:, :10] = rng.integers(32, 127, (n_records, 10), dtype=np.uint8)
    rec[:, 10:12] = ord(" ")
    rows = np.char.zfill(np.arange(n_records).astype(str), 32).astype("S32")
    rec[:, 12:44] = np.frombuffer(rows.tobytes(), np.uint8).reshape(-1, 32)
    rec[:, 44:46] = ord(" ")
    rec[:, 99] = ord("\n")
    per = n_records // n_parts
    return [rec[i * per : (i + 1) * per].tobytes() for i in range(n_parts)]


def _read_parts(store, path: str, n: int) -> list:
    return [
        store.read(f"{path}/part_{p:04d}")
        if store.exists(f"{path}/part_{p:04d}") else None
        for p in range(n)
    ]


def phase_main_path(dev, seed: int, corpus_bytes: int, n_records: int):
    from repro_torch.api import ClusterConfig, MarvelClient
    from repro_torch.core.mapreduce import wordcount_job
    from repro_torch.kernels import bucket_histogram as bh
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    # Zipf exponent 0.5 keeps every reduce within the engine's int32 rule
    # (max value x pairs < 2^31), so WordCount runs wholly on the device;
    # at 1.1, as in natural text, that rule sends every reduce to the host.
    corpus = zipf_corpus(corpus_bytes, 1 << 17, seed, a=0.5)
    natural = zipf_corpus(corpus_bytes, 1 << 17, seed + 1, a=1.1)
    spill = zipf_corpus(min(SPILL_CORPUS_BYTES, corpus_bytes), 1 << 17, seed + 2, a=0.5)
    parts = terasort_parts(n_records, 8, seed)
    emit("main_path_data", corpus_bytes=len(corpus), spill_corpus_bytes=len(spill),
         terasort_records=n_records, terasort_bytes=sum(map(len, parts)),
         setup_s=time.perf_counter() - t0,
         cut="WordCount corpus 64 MiB, not the paper's 1-15 GB: the host-side "
             "Python mapper must finish within the time limit; the capacity-"
             "spill run over its own 8 MiB")
    n_red = 4

    def wordcount(device: bool, capacity_factor: float = 1.3, data=corpus):
        cfg = ClusterConfig(tiers=("dram",), block_size=8 << 20, device=True,
                            device_capacity_factor=capacity_factor)
        with MarvelClient(cfg) as c:
            c.store.write("/in", data, record_delim=b"\n")
            t = time.perf_counter()
            h = c.mapreduce(wordcount_job(n_red), "/in", "/out", device=device)
            wall = time.perf_counter() - t
            return _read_parts(c.store, "/out", n_red), h.report, wall

    def terasort(device: bool):
        cfg = ClusterConfig(tiers=("dram",), block_size=8 << 20, device=True)
        with MarvelClient(cfg) as c:
            t = time.perf_counter()
            h = c.terasort("ts", parts, n_ranges=4, device=device)
            return h.result, h.report, time.perf_counter() - t

    # Keep the main path's largest partition input to time the kernel at
    # the shape the path gives it (the spy counts nothing itself).
    largest = {}
    real_partition_counts = ops.partition_counts

    def spy(dest, n_parts):
        if dest.numel() > largest.get("n", -1):
            largest.update(n=dest.numel(), dest=dest.clone(), n_parts=n_parts)
        return real_partition_counts(dest, n_parts)

    ops.partition_counts = spy
    bh.launches = 0  # the main path starts here
    try:
        wc_dev, wc_rep, wc_s = wordcount(device=True)
        ts_dev, ts_rep, ts_s = terasort(device=True)
        sp_dev, sp_rep, sp_s = wordcount(device=True, capacity_factor=0.05, data=spill)
        nat_dev, nat_rep, nat_s = wordcount(device=True, data=natural)
    finally:
        ops.partition_counts = real_partition_counts
    launches = bh.launches  # ... and ends here
    wc_host, _, wc_host_s = wordcount(device=False)
    ts_host, _, ts_host_s = terasort(device=False)
    sp_host, _, sp_host_s = wordcount(device=False, data=spill)
    nat_host, _, nat_host_s = wordcount(device=False, data=natural)

    ex = wc_rep.extra
    check(wc_dev == wc_host and any(wc_dev), "WordCount device != host bytes")
    check(ex["device_pairs"] > 0, "WordCount partitioned nothing on the device")
    check(ex["device_fallback_tasks"] == 0, "WordCount reduce fell back to host")
    check(ts_dev == ts_host and len(ts_dev) == n_records,
          "TeraSort device != host records")
    check(ts_dev == sorted(ts_dev), "TeraSort output is not sorted")
    check(sp_dev == sp_host and any(sp_dev), "spilled WordCount device != host bytes")
    check(sp_rep.extra["device_spilled_pairs"] > 0, "spill path did not run")
    check(nat_dev == nat_host and any(nat_dev),
          "Zipf(1.1) WordCount device != host bytes")
    map_tasks = sum(r.tasks - n_red for r in (wc_rep, sp_rep, nat_rep))
    scatters = ts_rep.extra["device_tasks"]
    check(launches >= map_tasks + scatters,
          f"bucket_histogram launched {launches} times for {map_tasks} map "
          f"and {scatters} scatter tasks")
    emit("wordcount", bytes=len(corpus), device_s=wc_s, host_s=wc_host_s,
         tasks=wc_rep.tasks, device_pairs=ex["device_pairs"],
         device_groups=ex["device_groups"], identical=True)
    emit("terasort", records=n_records, device_s=ts_s, host_s=ts_host_s,
         scatter_tasks=scatters, identical=True)
    emit("wordcount_spill", bytes=len(spill), capacity_factor=0.05, device_s=sp_s,
         host_s=sp_host_s, spilled_pairs=sp_rep.extra["device_spilled_pairs"],
         identical=True)
    emit("wordcount_zipf1.1", bytes=len(natural), device_s=nat_s,
         host_s=nat_host_s, device_pairs=nat_rep.extra["device_pairs"],
         device_fallback_tasks=nat_rep.extra["device_fallback_tasks"],
         identical=True)
    emit("main_path_launches", bucket_histogram=launches,
         map_and_scatter_tasks=map_tasks + scatters)
    return launches, largest


# -- phase 6: the attention kernels against their plain versions -------------

#: tolerance of a kernel against its plain version run in f32, by input
#: type (the reference's own kernel tests: tests/test_kernels.py:42).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}


class AttnRecord:
    """Checks of one attention kernel: its largest error against the plain
    version run in f32, and the number of cases checked."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.max_abs_err = 0.0
        self.checks = 0

    def compare(self, case: str, got: torch.Tensor, want: torch.Tensor,
                dtype: torch.dtype) -> float:
        check(got.shape == want.shape, f"{self.name} {case}: shape "
              f"{tuple(got.shape)} != {tuple(want.shape)}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{self.name} {case}: non-finite output")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        tol = ATTN_TOL[dtype]
        check(err <= tol, f"{self.name} {case}: max abs err {err} > {tol}")
        self.max_abs_err = max(self.max_abs_err, err)
        self.checks += 1
        return err


def _randn(g, shape, dtype, dev):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def flash_inputs(g, dev, B, T, H, Kv, dh, dtype, Tk=None, dv=None):
    """q (B, T, H, dh), k (B, Tk, Kv, dh) and v (B, Tk, Kv, dv), dv = dh
    unless given."""
    Tk = T if Tk is None else Tk
    return (_randn(g, (B, T, H, dh), dtype, dev),
            _randn(g, (B, Tk, Kv, dh), dtype, dev),
            _randn(g, (B, Tk, Kv, dh if dv is None else dv), dtype, dev))


#: the flash kernel's route by input type: wgmma for bf16/f16, 3xTF32 on
#: mma.sync for f32
FLASH_ROUTE = {torch.bfloat16: "wgmma", torch.float16: "wgmma",
               torch.float32: "tf32x3"}


def flash_case(rec: AttnRecord, case: str, q, k, v, **kw) -> None:
    """The kernel against its plain version run in f32, on the route its
    input type must take, and twice: the same bytes both times."""
    from repro_torch.kernels import flash_attention as fa

    route = fa._plan(q, k, v).route
    check(route == FLASH_ROUTE[q.dtype],
          f"flash_attention {case}: {q.dtype} took route {route}")
    got = fa.flash_attention(q, k, v, **kw)
    again = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_torch(q.float(), k.float(), v.float(), **kw)
    err = rec.compare(case, got, want, q.dtype)
    check(torch.equal(got, again),
          f"flash_attention {case}: two calls on the same inputs differ")
    emit("flash_edge", case=case, route=route, shape=list(q.shape),
         kv_len=k.shape[1], kv_heads=k.shape[2], v_head_dim=v.shape[3],
         dtype=str(q.dtype),
         max_abs_err=err, repeatable=True, ok=True,
         **{k_: v_ for k_, v_ in kw.items() if v_ is not None})


def decode_case(rec: AttnRecord, case: str, q, kc, vc, lengths,
                **kw) -> float:
    from repro_torch.kernels import decode_attention as da

    got = da.decode_attention(q, kc, vc, lengths, **kw)
    want = da.decode_attention_torch(q.float(), kc.float(), vc.float(),
                                     lengths, **kw)
    return rec.compare(case, got, want, q.dtype)


def phase_attention_kernels(dev, seed: int, flash: AttnRecord,
                            decode: AttnRecord, T: int, S: int) -> dict:
    """Each attention kernel against its plain version on the card: the
    serving path's shape, then the edge cases of the contract, then
    decode's log-sum-exp (:func:`decode_lse_cases`, whose times it
    returns)."""
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    bf = torch.bfloat16
    H, Kv, dh = 16, 2, 128  # qwen2.5-3b's attention
    flash_case(flash, "path_causal", *flash_inputs(g, dev, 1, T, H, Kv, dh, bf))
    short = T // 2
    for case, (B, t, h, kv, d, dt), kw in (
        ("ragged_T", (2, short - 37, H, Kv, dh, bf), {}),
        ("T=1", (1, 1, H, Kv, dh, bf), {}),
        ("softcap", (1, short, H, Kv, dh, bf), {"softcap": 50.0}),
        ("dh64", (2, short - 5, 8, 2, 64, bf), {}),
        ("dh256_mqa", (1, short + 3, 8, 1, 256, bf), {}),
        ("dh256_window", (1, short - 9, 8, 2, 256, bf), {"window": 70}),
        ("mha", (1, short, H, H, dh, bf), {}),
        ("non_causal", (2, short - 11, H, Kv, dh, bf), {"causal": False}),
        ("window", (1, short + 50, H, Kv, dh, bf), {"window": 96}),
        ("float32", (1, short - 1, H, Kv, dh, torch.float32), {}),
        ("float16", (1, short, H, Kv, dh, torch.float16),
         {"softcap": 30.0, "scale": 0.1}),
    ):
        flash_case(flash, case, *flash_inputs(g, dev, B, t, h, kv, d, dt), **kw)
    # MLA's expanded prefill (deepseek-v2-lite-16b): q/k head dim 192
    # against v head dim 128, 16 heads, scale 1/sqrt(192): its path shape,
    # then ragged T, T = 1 and the f32 route
    mla = {"scale": 1 / math.sqrt(192)}
    for case, (B, t, dt) in (("mla_path_192_128", (1, T, bf)),
                             ("mla_ragged_T", (2, short - 37, bf)),
                             ("mla_T=1", (1, 1, bf)),
                             ("mla_non_causal_Tq<Tk", (1, 77, bf)),
                             ("mla_float32", (1, short - 1, torch.float32))):
        causal = "non_causal" not in case
        tk = 200 if not causal else None
        flash_case(flash, case, *flash_inputs(g, dev, B, t, 16, 16, 192, dt,
                                              Tk=tk, dv=128),
                   causal=causal, **mla)
    # recurrentgemma-9b's local layers: 16 heads of 256 over one kv head,
    # a 2048-key window, at its path shape
    flash_case(flash, "local_path_dh256_mqa_window2048",
               *flash_inputs(g, dev, 1, T, 16, 1, 256, bf), window=2048)
    # the edges of the 64-row q and 64-key kv tiles
    for t in (63, 64, 65, 127, 129):
        for kw in ({}, {"window": 50}):
            name = f"T={t}" + ("_window" if kw else "_causal")
            flash_case(flash, name, *flash_inputs(g, dev, 2, t, H, Kv, dh, bf),
                       **kw)
    # fewer and more queries than keys (rows aligned at the start, as the
    # reference's kernel does)
    for case, (t, tk), kw in (("Tq<Tk", (200, 333), {}),
                              ("Tq>Tk", (333, 200), {}),
                              ("Tq<Tk_non_causal", (77, 300), {"causal": False})):
        flash_case(flash, case,
                   *flash_inputs(g, dev, 1, t, H, Kv, dh, bf, Tk=tk), **kw)
    # TMA's rules: a head stride of 68 elements (136 bytes) must raise
    from repro_torch.kernels import flash_attention as fa

    q, k, v = flash_inputs(g, dev, 1, 64, H, Kv, dh, bf)
    wide = torch.empty(1, 64, H, dh + 4, dtype=bf, device=dev)[..., :dh]
    try:
        fa.flash_attention(wide, k, v)
    except ValueError as exc:
        emit("flash_edge", case="misaligned_view", raised="ValueError",
             message=str(exc)[:120], ok=True)
    else:
        raise SmokeError("flash_attention took a view TMA cannot load")

    # decode: every length from 1 to S at the serving path's shape
    q = _randn(g, (1, H, dh), bf, dev)
    kc = _randn(g, (1, S, Kv, dh), bf, dev)
    vc = _randn(g, (1, S, Kv, dh), bf, dev)
    worst = 0.0
    for n in range(1, S + 1):
        lengths = torch.full((1,), n, dtype=torch.int32, device=dev)
        worst = max(worst, decode_case(decode, f"length={n}", q, kc, vc, lengths))
    emit("decode_edge", case="every_length", S=S, lengths=[1, S],
         max_abs_err=worst, ok=True)
    lengths8 = torch.tensor([1, 2, 31, 32, 33, S // 2, S - 1, S],
                            dtype=torch.int32, device=dev)
    for case, (B, h, kv, d, dt), lens, kw in (
        ("rep8_batch8_mixed", (8, H, Kv, dh, bf), lengths8, {}),
        ("rep1_mha", (2, H, H, dh, bf), None, {}),
        ("dh256_mqa", (2, 8, 1, 256, bf), None, {}),
        ("dh64", (2, 8, 2, 64, bf), None, {}),
        ("rep6_dbrx", (2, 48, 8, dh, bf), None, {}),
        ("softcap", (8, H, Kv, dh, bf), lengths8, {"softcap": 50.0}),
        ("float32", (2, H, Kv, dh, torch.float32), None, {}),
    ):
        q = _randn(g, (B, h, d), dt, dev)
        kc = _randn(g, (B, S, kv, d), dt, dev)
        vc = _randn(g, (B, S, kv, d), dt, dev)
        if lens is None:
            lens = torch.tensor([S // 3, S][:B], dtype=torch.int32, device=dev)
        err = decode_case(decode, case, q, kc, vc, lens, **kw)
        emit("decode_edge", case=case, B=B, S=S, heads=h, kv_heads=kv, dh=d,
             dtype=str(dt), max_abs_err=err, ok=True, **kw)
    # lengths[b] == 0 gives zeros (the TPU kernel's definition)
    from repro_torch.kernels import decode_attention as da

    zero = torch.tensor([0, S], dtype=torch.int32, device=dev)
    q = _randn(g, (2, H, dh), bf, dev)
    kc = _randn(g, (2, S, Kv, dh), bf, dev)
    vc = _randn(g, (2, S, Kv, dh), bf, dev)
    out = da.decode_attention(q, kc, vc, zero)
    check(bool((out[0] == 0).all()), "decode: lengths == 0 must give zeros")
    decode_case(decode, "zero_length", q, kc, vc, zero)
    emit("decode_edge", case="zero_length", ok=True)
    # recurrentgemma-9b's local layers: a full 2048-slot ring, 16 heads of
    # 256 over one kv head, every slot live and a ring still filling
    ring = 2048
    q = _randn(g, (2, 16, 256), bf, dev)
    kc = _randn(g, (2, ring, 1, 256), bf, dev)
    vc = _randn(g, (2, ring, 1, 256), bf, dev)
    lens = torch.tensor([ring, 1187], dtype=torch.int32, device=dev)
    err = decode_case(decode, "ring_S2048_dh256_mqa", q, kc, vc, lens)
    emit("decode_edge", case="ring_S2048_dh256_mqa", B=2, S=ring, heads=16,
         kv_heads=1, dh=256, lengths=lens.tolist(), max_abs_err=err, ok=True)
    decode_graph_case(dev, g, S)
    return decode_lse_cases(decode, g, dev)


#: the decode path shapes (PERF.md §6): (name, H, Kv, dh, S, dtype), length
#: 1025; the qwen shape also in f32, the CUDA-core route's log-sum-exp
DECODE_PATH_SHAPES = (("qwen2.5-3b", 16, 2, 128, 1088, torch.bfloat16),
                      ("recurrentgemma-9b_ring", 16, 1, 256, 1056, torch.bfloat16),
                      ("dbrx-132b", 48, 8, 128, 1032, torch.bfloat16),
                      ("qwen2.5-3b_f32", 16, 2, 128, 1088, torch.float32))
SPLIT_BLOCKS = 4  # the one-card split check: the qwen cache in 4 blocks
#: the split check's bound (max abs against one launch), set from its
#: readings: 9.77e-4 measured, 4e-3 predicted (PERF.md §6, PR 29); a
#: combine that weighted the live blocks equally reads above it
SPLIT_TOL = 4e-3


def decode_lse_cases(decode: AttnRecord, g, dev) -> dict:
    """``decode_attention(return_lse=True)`` against its plain version at
    the decode path shapes (o to the phase's tolerance, the log-sum-exp to
    the flash lse's, ``LSE_TOL``, both by the input type: bf16 on the
    ``mma`` route, f32 on the CUDA-core one), then the split check of the
    sequence-sharded caches on one card: the qwen path's cache cut into
    SPLIT_BLOCKS blocks of rows, one launch a block with the block's own
    lengths (a row of length 500 ends in the second block, so the last two
    are empty for it), combined by ``combine_partials``' arithmetic
    (``collectives.combine_stacked``), against one launch over the whole
    cache, to ``SPLIT_TOL``.  The same blocks averaged with equal weights
    over the live ones are printed beside it (``unweighted_max_abs_err``):
    the reading the bound must stay below.  Returns the times, with and
    without the flag, at the qwen shape in bf16."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.parallel.collectives import combine_stacked

    out = {}
    for name, H, Kv, dh, S, dt in DECODE_PATH_SHAPES:
        q = _randn(g, (2, H, dh), dt, dev)
        kc, vc = (_randn(g, (2, S, Kv, dh), dt, dev) for _ in range(2))
        lengths = torch.tensor([1025, 500], dtype=torch.int32, device=dev)
        o, lse = da.decode_attention(q, kc, vc, lengths, return_lse=True)
        want_o, want_lse = da.decode_attention_torch(
            q.float(), kc.float(), vc.float(), lengths, return_lse=True)
        check(lse.dtype == torch.float32 and lse.shape == (2, H),
              f"decode lse at {name}: {lse.dtype} {tuple(lse.shape)}")
        err = decode.compare(f"lse_path_{name}", o, want_o, dt)
        lse_err = float((lse - want_lse).abs().max())
        check(lse_err <= LSE_TOL[dt], f"decode lse at {name}: max abs err {lse_err}")
        check(torch.equal(o, da.decode_attention(q, kc, vc, lengths)),
              f"decode at {name}: return_lse changed the output")
        rows = S // SPLIT_BLOCKS
        if name == "qwen2.5-3b":
            parts = [da.decode_attention(
                q, kc[:, i * rows:(i + 1) * rows], vc[:, i * rows:(i + 1) * rows],
                (lengths - i * rows).clamp(0, rows).to(torch.int32), return_lse=True)
                for i in range(SPLIT_BLOCKS)]
            po = torch.stack([p[0] for p in parts]).float()
            plse = torch.stack([p[1] for p in parts])
            split = combine_stacked(po, plse)
            check(split.shape == o.shape and bool(torch.isfinite(split).all()),
                  f"decode split: {tuple(split.shape)}, finite "
                  f"{bool(torch.isfinite(split).all())}")
            split_err = float((split - o.float()).abs().max())
            check(split_err <= SPLIT_TOL,
                  f"decode split combine: max abs err {split_err} > {SPLIT_TOL}")
            live = (plse > da.MASK_VALUE / 2).float()[..., None]
            flat = (po * live).sum(0) / live.sum(0).clamp_min(1)
            flat_err = float((flat - o.float()).abs().max())
            emit("decode_split_combine", shape=name, blocks=SPLIT_BLOCKS, rows=rows,
                 lengths=lengths.tolist(), max_abs_err=split_err, tol=SPLIT_TOL,
                 unweighted_max_abs_err=flat_err, ok=True)
            one = q[:1], kc[:1], vc[:1], lengths[:1]
            out = {"shape": {"B": 1, "H": H, "Kv": Kv, "dh": dh, "S": S,
                             "lengths": [1025]},
                   "lse_ms": time_ms(lambda: da.decode_attention(*one, return_lse=True)),
                   "ms": time_ms(lambda: da.decode_attention(*one)),
                   "lse_plain_ms": time_ms(lambda: da.decode_attention_torch(
                       *one, return_lse=True)),
                   "split_combine_max_abs_err": split_err,
                   "split_unweighted_max_abs_err": flat_err}
        emit("decode_lse", shape=name, B=2, H=H, Kv=Kv, dh=dh, S=S, dtype=str(dt),
             lengths=lengths.tolist(), max_abs_err=err, lse_max_abs_err=lse_err, ok=True)
    emit("decode_lse_time", **out)
    return out


def decode_graph_case(dev, g, S: int) -> None:
    """Decode captured alone in a CUDA graph and replayed with new lengths
    (written into the captured tensor) gives the bytes of the eager call:
    a call queries, allocates and synchronises nothing that capture would
    freeze or refuse, and reads lengths on the device."""
    from repro_torch.kernels import decode_attention as da

    bf = torch.bfloat16
    q = _randn(g, (1, 16, 128), bf, dev)
    kc = _randn(g, (1, S, 2, 128), bf, dev)
    vc = _randn(g, (1, S, 2, 128), bf, dev)
    lengths = torch.full((1,), S // 2, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):  # warm up off the capture
        da.decode_attention(q, kc, vc, lengths)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.decode_attention(q, kc, vc, lengths)
    replayed = []
    for n in (1, 17, S // 3, S - 1, S):
        lengths.fill_(n)
        graph.replay()
        eager = da.decode_attention(
            q, kc, vc, torch.full((1,), n, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        check(torch.equal(out, eager),
              f"decode_attention: the graph replayed at length {n} gives "
              "other bytes than the eager call")
        replayed.append(n)
    emit("decode_edge", case="cuda_graph_replay", lengths=replayed,
         matches_eager=True, ok=True)


#: the profiler's names of a kernel launch on the host (a cluster launch
#: through cudaLaunchKernelEx shows as cudaLaunchKernelExC)
LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel",
               "cudaLaunchKernelExC")


#: the profiler's names of the host calls that start a device operation
OP_KEYS = LAUNCH_KEYS + ("cudaMemsetAsync", "cudaMemcpyAsync")
#: runtime queries and settings that a prepared call must not repeat
QUERY_KEYS = ("cudaDeviceGetAttribute", "cudaFuncSetAttribute",
              "cudaOccupancy", "cudaGetDeviceProperties")


def launch_lag_us(prof):
    """Least and median time in us from a kernel's launch on the host to
    its start on the card, over a finished window's launches matched to
    their kernel records by correlation id (None where none match).  The
    profiler stamps both on the host's clock; a lag below zero is the
    error of its device-to-host clock conversion."""
    try:
        raw = prof.profiler.kineto_results.events()
    except (AttributeError, RuntimeError):
        return None
    host, device = {}, {}
    for e in raw:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device[e.correlation_id()] = e.start_ns()
        elif e.name() in LAUNCH_KEYS:
            host[e.correlation_id()] = e.start_ns()
    lags = sorted(device[c] - host[c] for c in host.keys() & device.keys() if c)
    if not lags:
        return None
    return {"min": lags[0] / 1e3, "median": lags[len(lags) // 2] / 1e3,
            "matched": len(lags), "at_s": time.perf_counter() - START}


#: seconds a profiler window stays open before and after its calls
WINDOW_PAD_S = 0.25
#: one-thread spin kernels launched around a window's calls (torch.cuda._sleep)
EDGE_KERNELS = 256


def traced(fn, host: bool = True):
    """The profiler's events (``key_averages``) of ``fn()`` over the host
    (unless ``host`` is False: then the card's records alone, which a
    window of a hundred thousand launches needs, since the host's operator
    events cost minutes to gather) and the card, ``fn`` synchronised
    before the window closes, and what the window lost: its
    launch-to-kernel lag (:func:`launch_lag_us`) and the edge kernels
    whose records it did not return.

    In full runs the trace held back the records of a window's last
    kernels, 12 to 22 of them by the middle of a run (counted against the
    host's launches), and more later: a window of 15 short kernel calls
    came back with its host events and no device record.  So
    ``EDGE_KERNELS`` one-thread spin kernels run before and after
    ``fn``, their records are dropped from the events and their launches
    from the launch count, and the window stays open ``WINDOW_PAD_S``
    either side (the device stamps, converted to the host's clock, were
    off by up to 14 ms).  The trace is freed here: a profiler object sits
    in a reference cycle, and its trace would stay until the cycle
    collector runs."""
    def edge():
        for _ in range(EDGE_KERNELS):
            torch.cuda._sleep(1)

    prof = torch.profiler.profile(activities=[
        *([torch.profiler.ProfilerActivity.CPU] if host else []),
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        time.sleep(WINDOW_PAD_S)
        edge()
        fn()
        edge()
        torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    events = []
    spins = 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" in e.key:
            spins += e.count
            continue
        if e.key == "cudaLaunchKernel":
            e.count -= 2 * EDGE_KERNELS
        events.append(e)
    lost = {"launch_lag_us": launch_lag_us(prof),
            "edge_records_missing": 2 * EDGE_KERNELS - spins}
    prof.profiler = None  # the trace, released now
    gc.collect()
    return events, lost


def profile_window(fn, reps: int = REPS):
    """One profiler window over ``reps`` calls of ``fn`` after a warm-up:
    its events, its device records, their device time in us and what it
    lost (:func:`traced`).  Fails if the window holds no device record."""
    fn()
    torch.cuda.synchronize()
    events, lost = traced(lambda: [fn() for _ in range(reps)])
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels)
    check(total > 0, "the profiler saw no device time")
    return events, kernels, total, lost


def device_profile(fn, reps: int = REPS, op_keys=LAUNCH_KEYS):
    """Device time of one call of ``fn`` in ms, the device operations one
    call starts (kernel launches, or the host calls in ``op_keys``), the
    device ms a call of each kernel name it ran and what the window lost
    (:func:`traced`): one profiler window over ``reps`` calls, without the host time
    that an event pair around each call also holds.  The trace can miss
    some kernel records of a window (seen for the SSD kernel: 7 of 15), so
    where it holds fewer kernel records than host launches the time is
    scaled up by their ratio."""
    events, kernels, total, lost = profile_window(fn, reps)
    launches = sum(e.count for e in events if e.key in LAUNCH_KEYS)
    ops = sum(e.count for e in events if e.key in op_keys)
    check(ops > 0, "the profiler saw no device operation launched")
    records = sum(e.count for e in kernels if "memset" not in e.key.lower())
    missed = max(1.0, launches / records) if records else 1.0
    by_name = {e.key: e.self_device_time_total / reps / 1e3 for e in kernels}
    return total * missed / reps / 1e3, ops / reps, by_name, lost


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of ``fn`` in ms (see device_profile)."""
    return device_profile(fn, reps)[0]


def measure_flash(q, k, v, kw) -> dict:
    """Kernel, plain-version and SDPA times at the path's shape (event-timed
    around each call, so with the wrapper's host time; and the device time
    alone from the profiler), and the bound: the larger of the operations
    (causal and window pairs counted, q.k over dh and p.v over dv) over the
    bf16 peak and the bytes over the memory rate.  SDPA is timed where it
    computes the same function: no softcap, a window that masks given as
    an explicit mask, and head dims it takes (``library_ms`` None where it
    refuses them)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.roofline import kernel_work

    B, T, H, dh = q.shape
    Tk, dv = k.shape[1], v.shape[3]
    causal = kw.get("causal", True)
    window = kw.get("window")
    flash = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = (fa.live_mask(T, Tk, causal, window, q.device)
            if window is not None and window < max(T, Tk) else None)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True, scale=kw.get("scale"))
    library_ms = library_device = backend = None
    if kw.get("softcap") is None:
        try:
            sdpa()
        except RuntimeError as exc:  # a yardstick only: record the refusal
            emit("flash_library_refused", shape=list(q.shape), v_head_dim=dv,
                 error=str(exc)[:160])
        else:
            library_ms, library_device = time_ms(sdpa), device_ms(sdpa)
            backend = sdpa_backend(qt, kt, vt, mask, causal and mask is None,
                                   kw.get("scale"))
    kernel_ms = time_ms(flash)
    dev_ms, per_call, names, lost = device_profile(flash)
    plain_ms = time_ms(lambda: fa.flash_attention_torch(q, k, v, **kw), reps=5)
    work = kernel_work("flash_attention", q, k, v, causal=causal, window=window)
    return {
        "shape": {"B": B, "T": T, "H": H, "Kv": k.shape[2], "dh": dh, "dv": dv,
                  "causal": causal, "window": window, "dtype": str(q.dtype)},
        "kernel_route": fa._plan(q, k, v).route,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "device_ms": dev_ms, "library_device_ms": library_device,
        "library_backend": backend,
        "launches_per_call": per_call, "kernels_seen": sorted(names),
        "window_lost": lost, "bound_ms": work.bound_ms, "bound_by": work.bound_by,
        "flops": work.flops, "bytes": work.bytes,
    }


def sdpa_backend(qt, kt, vt, mask, is_causal: bool, scale) -> str | None:
    """The backend SDPA picks for these (B, H, T, dh) inputs (``enable_gqa``),
    or None where this PyTorch does not say."""
    choice = getattr(torch, "_fused_sdp_choice", None)
    if choice is None:
        return None
    from torch.nn.attention import SDPBackend

    return SDPBackend(choice(qt, kt, vt, mask, 0.0, is_causal, scale=scale,
                             enable_gqa=True)).name


def measure_decode(q, kc, vc, lengths) -> dict:
    """Kernel, plain-version and masked-SDPA times at the path's shape
    (event-timed around each call, so with the wrapper's host time; and
    the device time alone from the profiler, with the device kernels one
    call runs, which must be one), and the bound: q, the cache rows up to
    ``lengths`` and the output, over the memory rate."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.launch.roofline import kernel_work

    B, H, dh = q.shape
    S, Kv = kc.shape[1], kc.shape[2]
    decode = lambda: da.decode_attention(q, kc, vc, lengths)  # noqa: E731
    kernel_ms = time_ms(decode)
    plain_ms = time_ms(lambda: da.decode_attention_torch(q, kc, vc, lengths))
    qt = q[:, :, None, :]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True)
    library_ms = time_ms(sdpa)
    plan = da._plan(B, S, H, Kv, q.dtype, da._sm_count(q.get_device()))
    dev_ms, per_call, names, lost = device_profile(decode)
    check(per_call == 1 and all("decode_mma_kernel" in n or "decode_f32_kernel" in n
                                for n in names),
          f"decode_attention made {per_call} launches a call, of {names}: "
          "want one of its own kernel")
    work = kernel_work("decode_attention", q, kc, vc, lengths,
                       rows=int(lengths.clamp(0, S).sum()))
    return {
        "shape": {"B": B, "H": H, "Kv": Kv, "dh": dh, "S": S,
                  "lengths": lengths.tolist(), "dtype": str(q.dtype)},
        "kernel_route": plan.route,
        "plan": {"n_splits": plan.n_splits, "split_len": plan.split_len,
                 "heads": plan.heads, "groups": plan.groups},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "device_ms": dev_ms, "library_device_ms": device_ms(sdpa),
        "launches_per_call": per_call, "kernels_seen": sorted(names),
        "window_lost": lost, "bound_ms": work.bound_ms, "bound_by": work.bound_by,
        "bytes": work.bytes,
    }


# -- phase 7: serving at full qwen2.5-3b width -------------------------------

def _blobs(pool, conversation: str) -> dict:
    """A conversation's block blobs and meta record, by key suffix."""
    prefix = pool.pager.session_prefix(pool._scoped(conversation))
    store = pool.pager.store
    return {key[len(prefix):]: store.get(key) for key in sorted(store.keys(prefix))}


def _tok(fut) -> int:
    return int(fut.result().reshape(-1)[0])


class _Spy:
    """Wraps a module attribute while installed: counts its calls, keeps
    the last call's arguments and adds up its wall seconds, synchronising
    the card first when ``timed`` (the kernels' own counts stay the
    launch counts); with ``ranged`` each call runs in a profiler range
    named after the attribute (a profile then reads the device time of
    the kernels it launches), with ``keep`` every call's result is kept
    in ``outputs``."""

    def __init__(self, module, name: str, timed: bool = False,
                 ranged: bool = False, keep: bool = False) -> None:
        self.module, self.name, self.timed = module, name, timed
        self.ranged, self.keep = ranged, keep
        self.real = getattr(module, name)
        self.calls = 0
        self.seconds = 0.0
        self.last = None
        self.outputs = []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        t = time.perf_counter()
        if self.ranged:
            with torch.profiler.record_function(self.name):
                out = self.real(*args, **kwargs)
        else:
            out = self.real(*args, **kwargs)
        if self.timed:
            torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t
        self.calls += 1
        self.last = (args, kwargs)
        if self.keep:
            self.outputs.append(out)
        return out

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)


def _blocks(params, cfg):
    """(block parameters, block spec) of every prelude, body (stacked over
    the periods) and postlude block."""
    return [*zip(params["prelude"], cfg.prelude), *zip(params["body"], cfg.pattern),
            *zip(params["postlude"], cfg.postlude)]


def draw_params(cfg, seed: int, dev):
    """Random bf16 weights for ``cfg``, drawn on the card from ``seed``
    with the model's own init, then with the attention projections (GQA
    and MLA) scaled to their true fan-in.

    The shared init rule (``ParamDef.fan_in_scale``, as in the reference
    package) reads ``shape[-2]`` as the fan-in, which for the 3-D
    projections ``wq``/``wk``/``wv`` (D, heads, dh) is the head count and
    for ``wo`` (H, dh, D) is dh.  At full width that makes q and k a few
    hundred times too large: every softmax saturates to a hard argmax, and
    a perturbation of one rounding flips which key wins, so decode and
    prefill give uncorrelated logits over 36 layers however exact the
    kernels (the serving phase prints that error, with the model's own
    init, beside the checked one).  Scaling by the true fan-in (D for
    q/k/v, H*dh for o) gives a model as well conditioned as a trained one,
    on which decode and prefill can be held against each other.  MLA's
    per-head projections have the same fault: ``wq`` (D, H, 192) and
    ``wk_b``/``wv_b`` (r, H, ·) read H as the fan-in, ``wo`` (H, 128, D)
    reads 128; they are scaled to D, r and H*128.  The RG-LRU, MoE and
    dense FFN weights are 2-D or expert-batched with the fan-in at -2, and
    keep the model's own init.

    A MoE model's token embedding is drawn at unit variance
    (``MOE_EMBED_GAIN`` times its init of 0.02, as gemma's sqrt(D) scale
    does for its models): at 0.02 the token's own signal is some 50 times
    smaller than the unit-variance outputs of the blocks above it, whose
    causal-prefix averages all late tokens share, so the router sees
    nearly one input for every token and sends them to one expert.  The
    MoE phases print each layer's routing under both draws
    (:func:`routing`).
    """
    from repro_torch.models import init_params, model_defs

    params = init_params(model_defs(cfg), torch.Generator(device=dev).manual_seed(seed), dev)
    D, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    fixes = {"attn": {"wq": (H / D) ** 0.5, "wk": (Kv / D) ** 0.5,
                      "wv": (Kv / D) ** 0.5, "wo": (dh / (H * dh)) ** 0.5}}
    fixes["local"] = fixes["attn"]
    if cfg.mla is not None:
        r = cfg.mla.kv_lora_rank
        fixes["mla"] = {"wq": (H / D) ** 0.5, "wk_b": (H / r) ** 0.5,
                        "wv_b": (H / r) ** 0.5, "wo": (1 / H) ** 0.5}
    for block, spec in _blocks(params, cfg):
        for name, factor in fixes.get(spec.mixer, {}).items():
            block["mixer"][name].mul_(factor)
    if cfg.moe is not None and not cfg.embed_scale:
        params["embed"].mul_(MOE_EMBED_GAIN)
    return params


def phase_serving(dev, seed: int, cfg, prompt_len: int, max_tokens: int,
                  n_convs: int, int8_steps: int, lossless_steps: int,
                  workdir: Path):
    """Marvel-Serve through ``MarvelClient.serving`` on the card: int8
    demotion under warm-pool pressure, lossless suspend/resume byte
    identity, a restart that re-adopts sessions from PMEM, and the
    prefill/decode consistency check, then a profile of the bare model
    step.  Returns the kernels' launch counts on the path, the arguments
    of the last flash and decode calls on it, the weights, and the hot
    steps per second one invoker sustained in the lossless pool."""
    from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import attention, init_params, model_defs
    from repro_torch.models.quant_cache import QuantAttnCache

    t0 = time.perf_counter()
    params = draw_params(cfg, seed, dev)
    n_params = sum(p.numel() for p in _leaves(params))
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (n_convs, 1, prompt_len), dtype=np.int32)
    torch.cuda.synchronize()
    emit("serving_setup", model=cfg.name, params=n_params,
         param_bytes=sum(p.numel() * p.element_size() for p in _leaves(params)),
         layers=cfg.n_layers, d_model=cfg.d_model, prompt_len=prompt_len,
         max_tokens=max_tokens, conversations=n_convs,
         setup_s=time.perf_counter() - t0)

    def cluster(name: str, lossless: bool, warm_pool: int) -> ClusterConfig:
        root = workdir / name
        return ClusterConfig(
            name=name,
            tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / "pmem"))),
            invokers=1, warm_pool=warm_pool, commit_every=1,
            journal="pmem", journal_path=str(root / "journal"),
            serving=ServingConfig(block_tokens=16, lossless=lossless),
        )

    def serve(client):
        return client.serving(params, cfg, prompt_len=prompt_len,
                              max_tokens=max_tokens, device=dev)

    flash_spy = _Spy(ops, "flash_attention")
    decode_spy = _Spy(ops, "decode_attention")
    quant_spy = _Spy(attention, "quant_decode_attention")
    counts = {}

    def mark(at: str) -> None:
        counts[at] = {"flash_attention": fa.launches,
                      "decode_attention": da.launches,
                      "quant_decode_attention": quant_spy.calls}

    fa.launches = da.launches = 0  # the serving path starts here
    try:
        # (a) int8 pool: more conversations than warm slots, steps
        # interleaved, so every eviction demotes to int8 and every resume
        # decodes through quant_decode_attention.
        with MarvelClient(cluster("int8", lossless=False, warm_pool=4)) as client:
            pool = serve(client)
            convs = [f"c{i}" for i in range(n_convs)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            firsts = [_tok(pool.start(c, prompts[i])) for i, c in enumerate(convs)]
            prefill_s = time.perf_counter() - t
            mark("int8_prefilled")
            t = time.perf_counter()
            streams = {c: [] for c in convs}
            for _ in range(int8_steps):
                for c in convs:
                    streams[c].append(_tok(pool.step(c)))
            torch.cuda.synchronize()
            int8_s = time.perf_counter() - t
            stats = pool.stats()
            sid = pool._scoped(convs[0])
            layers, _ = pool.pager.load(sid)
        mark("int8_done")
        check(stats["demotions"] > 0 and stats["quantized_blocks"] > 0,
              f"no int8 demotion under warm-pool pressure: {stats}")
        check(isinstance(layers[0], QuantAttnCache)
              and layers[0].k_q.device == dev,
              "a demoted session did not come back as an int8 cache on the card")
        check(counts["int8_done"]["quant_decode_attention"] > 0,
              "no decode step ran on the int8 cache")
        toks = [x for c in convs for x in streams[c]] + firsts
        check(all(0 <= x < cfg.vocab for x in toks), "token out of vocabulary")
        emit("serving_int8", conversations=n_convs, steps_each=int8_steps,
             prefill_s=prefill_s, prefill_tokens_per_s=n_convs * prompt_len / prefill_s,
             decode_s=int8_s, tokens_per_s=n_convs * int8_steps / int8_s,
             demotions=stats["demotions"], resumes=stats["resumes"],
             demand_faults=stats["demand_faults"],
             quantized_blocks=stats["quantized_blocks"],
             int8_decode_calls=counts["int8_done"]["quant_decode_attention"])

        # (b) lossless suspend/resume and (c) a restart
        stream_c, hot_rate, _ = lossless_and_restart(
            cluster("lossless", lossless=True, warm_pool=8), serve, prompts,
            firsts, lossless_steps, mark, "serving", dev)
    finally:
        for spy in (flash_spy, decode_spy, quant_spy):
            spy.restore()
    launches = dict(counts["after_restart"])  # ... and ends here
    check(counts["int8_done"]["flash_attention"] > 0,
          "flash_attention did not launch in the int8 pool's prefills")
    for kernel in ("flash_attention", "decode_attention"):
        check(counts["after_resume"][kernel] > counts["resumed"][kernel],
              f"{kernel} did not launch after the resume")
        check(counts["after_restart"][kernel] > counts["after_resume"][kernel],
              f"{kernel} did not launch after the restart")
    emit("serving_launches", **{k: v for k, v in counts.items()})

    # (d) consistency at full width: decode-step logits at position t
    # against a fresh prefill over the same tokens (holds the two kernels
    # against each other).
    tokens = torch.tensor([prompts[0, 0].tolist() + stream_c[:max_tokens]],
                          dtype=torch.int32, device=dev)
    rel, agree, n_dec = decode_vs_prefill(params, cfg, tokens, prompt_len,
                                          max_tokens)
    check(rel <= 2e-2, f"decode vs prefill logits: relative L2 error {rel} > 2e-2")
    # the same with the model's own init (reported, not held to the limit:
    # see draw_params)
    own = init_params(model_defs(cfg), torch.Generator(device=dev).manual_seed(seed), dev)
    own_rel, own_agree, _ = decode_vs_prefill(own, cfg, tokens, prompt_len,
                                              max_tokens)
    del own
    emit("serving_consistency", positions=n_dec, max_rel_l2=rel,
         argmax_agreement=agree, tolerance=2e-2,
         own_init_max_rel_l2=own_rel, own_init_argmax_agreement=own_agree)
    emit("serving_profile", **profile_decode(params, cfg, tokens, prompt_len,
                                             max_tokens))
    return launches, flash_spy.last, decode_spy.last, params, hot_rate


def lossless_and_restart(config, serve, prompts, firsts, lossless_steps: int,
                         mark, label: str, dev):
    """(b) and (c) of a serving phase.  In a lossless pool over
    ``config``, "b" is suspended to PMEM and resumed midway and "a" never
    is: both must decode the same tokens and leave byte-identical blobs;
    "c" runs ahead on the same prompt, timed per step (``decode_step``,
    ``KVPager.load``, ``KVPager.write``).  Then a fresh client over the
    same durable ``config`` re-adopts the three sessions and decodes on
    exactly.  ``serve(client)`` builds the pool; ``mark`` is called at
    "resumed", "after_resume" and "after_restart".  Returns "c"'s
    tokens, the hot steps per second of "a" and "b", and the hot step's
    split (ms a step: the whole step, ``decode_step``, ``load``,
    ``write``) and the bytes of a conversation's blobs."""
    from repro_torch.api import MarvelClient
    from repro_torch.serving import decode_runtime

    half = lossless_steps // 2
    with MarvelClient(config) as client:
        pool = serve(client)
        stream = {c: [_tok(pool.start(c, prompts[0]))] for c in ("a", "b")}
        for c in ("a", "b"):
            for _ in range(half):
                stream[c].append(_tok(pool.step(c)))
        check(pool.suspend("b") and not pool.is_resident("b"),
              "suspend did not demote the conversation")
        check(pool.resume("b"), "resume refused")
        mark("resumed")
        stream["c"] = [_tok(pool.start("c", prompts[0]))]
        timers = [_Spy(decode_runtime, "decode_step", timed=True),
                  _Spy(pool.pager, "load", timed=True),
                  _Spy(pool.pager, "write", timed=True)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            for c in ("a", "b"):
                for _ in range(lossless_steps - half):
                    stream[c].append(_tok(pool.step(c)))
            torch.cuda.synchronize()
            hot_s = time.perf_counter() - t
        finally:
            for timer in timers:
                timer.restore()
        hot_steps = 2 * (lossless_steps - half)
        breakdown = {f"{timer.name}_ms_per_step":
                     timer.seconds / hot_steps * 1e3 for timer in timers}
        mark("after_resume")
        layers, _ = pool.pager.load(pool._scoped("b"))
        check(all(x.device == dev for x in _leaves(layers)),
              "a resumed session decodes on host tensors")
        for _ in range(lossless_steps + 4):
            stream["c"].append(_tok(pool.step("c")))
        check(stream["a"] == stream["b"],
              f"lossless suspend/resume changed the tokens: "
              f"{stream['a']} vs {stream['b']}")
        check(stream["c"][:len(stream["a"])] == stream["a"],
              "the same prompt decoded to different tokens")
        blobs_a, blobs_b = _blobs(pool, "a"), _blobs(pool, "b")
        check(blobs_a.keys() == blobs_b.keys() and blobs_a == blobs_b,
              "lossless paging is not byte-identical")
        client.runtime.commit_all()
        pool.pager.sync()
    emit(f"{label}_lossless", steps=lossless_steps, suspended_at=half,
         identical_tokens=True, identical_blobs=True, blobs=len(blobs_a),
         blob_bytes=sum(map(len, blobs_a.values())),
         hot_decode_s=hot_s, hot_tokens_per_s=hot_steps / hot_s,
         step_ms=hot_s / hot_steps * 1e3, **breakdown)

    # (c) restart: a fresh client over the same durable config
    with MarvelClient(config) as client:
        pool = serve(client)
        adopted = pool.pager.recover()
        check(adopted == 3, f"restart re-adopted {adopted} of 3 sessions")
        resumed = [_tok(pool.step("a")) for _ in range(4)]
        want = stream["c"][len(stream["a"]):len(stream["a"]) + 4]
        check(resumed == want, f"after the restart 'a' decoded {resumed}, "
              f"the uninterrupted run {want}")
        fresh = _tok(pool.start("d", prompts[1]))
        check(fresh == firsts[1], "a new conversation after the restart "
              "did not reproduce the first token of the same prompt")
        mark("after_restart")
    emit(f"{label}_restart", adopted=adopted, continued=resumed, matches=True)
    split = {"step_ms": hot_s / hot_steps * 1e3, **breakdown,
             "blob_bytes": sum(map(len, blobs_a.values()))}
    return stream["c"], hot_steps / hot_s, split


@torch.no_grad()
def decode_vs_prefill(params, cfg, tokens, prompt_len: int, max_tokens: int):
    """Teacher-forced decode-step logits after a prefill of ``prompt_len``
    tokens, against one prefill over all of them: the largest relative L2
    error over the positions, the share of positions whose argmax agrees,
    and the number of positions."""
    from repro_torch.models import decode_step, forward, logits_fn

    n_dec = min(max_tokens, tokens.shape[1] - prompt_len)
    h, _, cache = forward(params, cfg, {"tokens": tokens[:, :prompt_len]},
                          collect_cache=True, cache_len=prompt_len + max_tokens)
    dec = [logits_fn(params, cfg, h[:, -1])]
    for t in range(prompt_len, prompt_len + n_dec - 1):
        lg, cache = decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
        dec.append(lg)
    full, _ = forward(params, cfg, {"tokens": tokens[:, :prompt_len + n_dec - 1]})
    ref = logits_fn(params, cfg, full[0, prompt_len - 1:])
    dec = torch.cat(dec)
    check(bool(torch.isfinite(dec).all()), "non-finite decode logits")
    rel = ((dec - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    return rel, agree, n_dec


@torch.no_grad()
def profile_decode(params, cfg, tokens, prompt_len: int, max_tokens: int,
                   steps: int = 8) -> dict:
    """Where a bare model step's time goes: a prefill ``forward`` and hot
    ``decode_step`` wall times (host clock, synchronised), then one
    profiler window over ``steps`` decode steps for the device time and
    kernel launches per step, and for a MoE model the device time under
    ``moe_apply`` (every expert's weights read each token) beside the
    bound of reading them."""
    from repro_torch.models import decode_step, forward
    from repro_torch.models import moe as moe_module

    def prefill():
        return forward(params, cfg, {"tokens": tokens[:, :prompt_len]},
                       collect_cache=True, cache_len=prompt_len + max_tokens)

    prefill_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, cache = prefill()
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    # one profiler window over a prefill: its device time, and the flash
    # kernel's share of it
    prefill_events, prefill_lost = traced(prefill)
    prefill_kernels = [e for e in prefill_events
                       if e.device_type == torch.autograd.DeviceType.CUDA]
    prefill_device_ms = sum(e.self_device_time_total for e in prefill_kernels) / 1e3
    flash = [e for e in prefill_kernels if "flash_wgmma_kernel" in e.key
             or "flash_tf32_kernel" in e.key]
    ssd = [e for e in prefill_kernels if "ssd_chunk_kernel" in e.key]
    step_ms = []
    for t in range(prompt_len, prompt_len + steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ranges = [_Spy(moe_module, "moe_apply", ranged=True)] if cfg.moe is not None else []
    try:
        events, step_lost = traced(lambda: [
            decode_step(params, cfg, tokens[:, t:t + 1], cache, t)
            for t in range(prompt_len, prompt_len + steps)])
    finally:
        for r in ranges:
            r.restore()
    # a range also shows on the device timeline as an annotation spanning
    # its kernels and the gaps between them: not a kernel of its own
    ranged = {r.name for r in ranges}
    moe = {}
    if cfg.moe is not None:
        m = cfg.moe
        n_moe = sum(blk.ffn == "moe" for blk in cfg.all_blocks())
        expert_bytes = n_moe * m.n_experts * 3 * cfg.d_model * m.d_expert \
            * params["unembed"].element_size()
        moe_us = sum(e.device_time_total for e in events if e.key == "moe_apply"
                     and e.device_type == torch.autograd.DeviceType.CPU)
        moe = {"moe_device_ms_per_step": moe_us / steps / 1e3,
               "moe_expert_bytes_per_step": expert_bytes,
               "moe_expert_read_bound_ms": bytes_bound_ms(expert_bytes)}
    # the kernels themselves (an operator's own entry repeats their time)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranged]
    decode = [e for e in kernels if "decode_mma_kernel" in e.key
              or "decode_f32_kernel" in e.key]
    launches = sum(e.count for e in events if e.key in LAUNCH_KEYS)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {
        "prefill_forward_ms": statistics.median(prefill_ms),
        "prefill_device_ms": prefill_device_ms,
        "flash_ms_per_prefill": sum(e.self_device_time_total for e in flash) / 1e3,
        "flash_launches_per_prefill": sum(e.count for e in flash),
        "ssd_chunk_ms_per_prefill": sum(e.self_device_time_total for e in ssd) / 1e3,
        "ssd_chunk_launches_per_prefill": sum(e.count for e in ssd),
        "decode_step_ms": statistics.median(step_ms),
        "device_ms_per_step":
            sum(e.self_device_time_total for e in kernels) / steps / 1e3,
        "launches_per_step": launches / steps,
        "decode_attention_kernels_per_step": sum(e.count for e in decode) / steps,
        "decode_attention_ms_per_step":
            sum(e.self_device_time_total for e in decode) / steps / 1e3,
        "top_kernels_ms_per_step": {
            e.key[:60]: e.self_device_time_total / steps / 1e3 for e in top},
        "window_lost": {"prefill": prefill_lost, "steps": step_lost},
        **moe,
    }
    check(bool(prefill_kernels) and bool(kernels),
          f"the profiler saw no device time in {cfg.name}'s prefill or steps")
    return out


# -- phase 8: traced multi-tenant serving under the autoscaler --------------

TRACE_TENANTS = 3
TRACE_SESSIONS = 4  # conversations a tenant: 12 in all
TRACE_WARM_POOL = 4  # fewer warm slots than conversations: evictions demote
TRACE_SECONDS = 12.0
TRACE_SLO_MS = 1000.0
TRACE_WINDOW_S = 1.0


class Conversations:
    """The replay's ``submit`` over a serving pool: an arrival of ``(app,
    session)`` starts conversation ``app/session`` (its prompt drawn from
    the seed) on its first admitted arrival and steps it after that.
    Returns the pool's future and keeps each conversation's futures in
    order."""

    def __init__(self, pool, prompts: dict) -> None:
        self.pool, self.prompts = pool, prompts
        self.futures: dict = {}

    def submit(self, fn, app, session, block=True, timeout=None, **inputs):
        check(fn == self.pool.decoder.fn.name and not inputs,
              f"the trace asked for {fn}({inputs})")
        conv = f"{app}/{session}"
        if conv not in self.futures:
            fut = self.pool.start(conv, self.prompts[conv], block=block,
                                  timeout=timeout)
            self.futures[conv] = [fut]
        else:
            fut = self.pool.step(conv, block=block, timeout=timeout)
            self.futures[conv].append(fut)
        return fut


def _finite(x: float):
    return x if math.isfinite(x) else None


def phase_traced_serving(dev, seed: int, cfg, params, hot_tokens_per_s: float,
                         prompt_len: int, max_tokens: int, workdir: Path):
    """A seeded multi-tenant trace replayed at ``MarvelClient.serving``
    over phase 7's weights: 3 tenants of 4 conversations, a 4x burst on
    t0, the base rate half what one invoker sustained hot in phase 7.
    Cell ``fixed`` serves it with one invoker, cell ``auto`` under
    ``MarvelClient.autoscaler`` (1 to 4 invokers), both lossless over a
    warm pool smaller than the conversations, so decode steps run on
    several invoker threads at once beside evictions' demotions.  Every
    conversation must decode the tokens of a sequential pass.  Returns the
    flash and decode launches on the path."""
    from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
    from repro_torch.core.autoscale import PolicySpec
    from repro_torch.core.loadgen import (
        BurstSpec, OpSpec, TraceSpec, generate_trace, rate_at, replay,
    )
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    spec = TraceSpec(
        seed=seed, duration=TRACE_SECONDS, base_rate=hot_tokens_per_s / 2,
        tenants=TRACE_TENANTS, sessions_per_tenant=TRACE_SESSIONS,
        zipf_skew=0.8, amplitude=0.0,
        bursts=(BurstSpec(start=4.0, duration=3.0, factor=4.0, tenant="t0"),),
        ops=(OpSpec("decode"),),
    )
    trace = generate_trace(spec)
    arrivals = Counter(f"{a.tenant}/{a.session}" for a in trace)
    check(max(arrivals.values()) <= max_tokens,
          f"a conversation of the trace has more arrivals than its "
          f"{max_tokens}-token headroom: {arrivals}")
    rng = np.random.default_rng(seed + 1)
    prompts = {f"t{i}/s{j}": rng.integers(0, cfg.vocab, (1, prompt_len), dtype=np.int32)
               for i in range(TRACE_TENANTS) for j in range(TRACE_SESSIONS)}
    emit("traced_setup", one_invoker_hot_tokens_per_s=hot_tokens_per_s,
         base_rate=spec.base_rate, burst_rate=rate_at(spec, 5.0),
         arrivals=len(trace), conversations=len(arrivals),
         max_arrivals_per_conversation=max(arrivals.values()),
         arrivals_per_tenant=Counter(a.tenant for a in trace),
         warm_pool=TRACE_WARM_POOL, slo_ms=TRACE_SLO_MS, window_s=TRACE_WINDOW_S)

    def cluster(name: str) -> ClusterConfig:
        root = workdir / name
        return ClusterConfig(
            name=name,
            tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / "pmem"))),
            invokers=1, warm_pool=TRACE_WARM_POOL, commit_every=1,
            journal="pmem", journal_path=str(root / "journal"),
            serving=ServingConfig(block_tokens=16, lossless=True),
        )

    def serve(client):
        return client.serving(params, cfg, prompt_len=prompt_len,
                              max_tokens=max_tokens, device=dev)

    def cell(name: str, policy) -> dict:
        """Replay the trace at a fresh pool; returns each conversation's
        tokens."""
        with MarvelClient(cluster(name)) as client:
            pool = serve(client)
            auto = client.autoscaler(policy) if policy is not None else None
            adapter = Conversations(pool, prompts)
            torch.cuda.synchronize()
            before = (fa.launches, da.launches)
            cpu0 = time.process_time()
            res = replay(adapter.submit, trace, spec=spec, slo_ms=TRACE_SLO_MS,
                         window_s=TRACE_WINDOW_S, admission="shed",
                         tick=auto.maybe_tick if auto is not None else None,
                         drain_timeout=600.0)
            torch.cuda.synchronize()
            cpu_s = time.process_time() - cpu0  # every thread's host time
            flash_n, decode_n = fa.launches - before[0], da.launches - before[1]
            snap = client.gateway.load_snapshot()
            gstats = client.gateway.stats()
            busy_s = sum(inv.busy_seconds for inv in gstats.invokers)
            streams = {c: [_tok(f) for f in futs]
                       for c, futs in adapter.futures.items()}
            invokers_after = None
            if auto is not None:
                check(client.gateway.quiesce(timeout=60.0),
                      f"{name}: the gateway did not quiesce after the drain")
                for k in range(1, 9):  # idle control ticks, a second apart
                    auto.maybe_tick(res.wall_s + k)
                invokers_after = client.gateway.load_snapshot().invokers
            stats = pool.stats()
        check(res.offered == len(trace) and res.errors == 0,
              f"{name}: {res.errors} errors over {res.offered} of "
              f"{len(trace)} arrivals")
        for tenant, ts in sorted(res.tenants.items()):
            check(ts.offered == ts.completed + ts.shed + ts.errors,
                  f"{name}: tenant {tenant} offered {ts.offered}, completed "
                  f"{ts.completed}, shed {ts.shed}, errors {ts.errors}")
        check(flash_n == cfg.n_layers * len(streams),
              f"{name}: {flash_n} flash launches for {len(streams)} prefills "
              f"of {cfg.n_layers} layers")
        check(decode_n == cfg.n_layers * res.completed > 0,
              f"{name}: {decode_n} decode launches for {res.completed} "
              f"decode steps of {cfg.n_layers} layers")
        iso = res.isolation("t0")
        out = {
            "cell": name, "wall_s": res.wall_s, "offered": res.offered,
            "completed": res.completed, "shed": res.shed,
            "decode_tokens_per_s": res.completed / res.wall_s,
            "p99_ms": res.p99_ms(),
            "p99_ms_per_tenant": {t: res.p99_ms(t) for t in sorted(res.tenants)},
            "p99_under_slo_frac": res.p99_under_slo_frac(),
            "goodput_frac": res.goodput_frac(),
            "goodput_frac_per_tenant": {t: res.goodput_frac(t)
                                        for t in sorted(res.tenants)},
            "isolation_t0_ratio": _finite(iso.ratio),
            "isolation_t0_burst_p99_ms": iso.burst_p99_ms,
            "isolation_t0_calm_p99_ms": iso.calm_p99_ms,
            "scale_actions": auto.scale_actions if auto is not None else 0,
            "peak_invokers": auto.peak_invokers if auto is not None else 1,
            "invokers_after_idle": invokers_after,
            "kv_resident_sessions": snap.resident_sessions,
            "kv_paged_sessions": snap.paged_sessions,
            "demotions": stats["demotions"], "resumes": stats["resumes"],
            "demand_faults": stats["demand_faults"],
            "flash_launches": flash_n, "decode_launches": decode_n,
            # where the time went: invocations' summed service time (each
            # from dispatch to done, on its invoker), the lane wait before
            # dispatch, and the process's host CPU time (all threads)
            "invoker_busy_s": busy_s,
            "service_ms_per_invocation": busy_s / res.completed * 1e3,
            "lane_wait_p99_ms": gstats.lane_wait_p99_ms,
            "host_cpu_s": cpu_s, "host_cores_busy": cpu_s / res.wall_s,
        }
        if auto is not None:
            out["actions"] = [(a["t"], a["kind"], *a["invokers"])
                              for a in auto.actions]
        emit("traced_cell", **out)
        if auto is not None:
            kinds = [a["kind"] for a in auto.actions]
            check("scale_up" in kinds, f"{name}: no scale_up in {kinds}")
            check(auto.peak_invokers >= 2,
                  f"{name}: a peak of {auto.peak_invokers} invokers")
            check(invokers_after == policy.min_invokers,
                  f"{name}: {invokers_after} invokers after the drain and "
                  f"idle ticks, not min_invokers={policy.min_invokers}")
        return streams

    fa.launches = da.launches = 0  # the traced path starts here
    t0 = time.perf_counter()
    cells = {
        "fixed": cell("fixed", None),
        "auto": cell("auto", PolicySpec(
            min_invokers=1, max_invokers=4, target_per_invoker=2,
            down_cooldown_s=0.5, warm_pool_per_invoker=2)),
    }
    launches = {"flash_attention": fa.launches,
                "decode_attention": da.launches}  # ... and ends here
    replay_s = time.perf_counter() - t0

    # the sequential pass: each conversation alone in a fresh pool, to the
    # most steps either cell completed for it
    need = {c: max(len(streams.get(c, ())) for streams in cells.values())
            for c in prompts}
    t0 = time.perf_counter()
    with MarvelClient(cluster("sequential")) as client:
        pool = serve(client)
        alone = {}
        for c, n in need.items():
            if n:
                alone[c] = [_tok(pool.start(c, prompts[c]))]
                alone[c] += [_tok(pool.step(c)) for _ in range(n - 1)]
    sequential_s = time.perf_counter() - t0
    for name, streams in cells.items():
        for c, stream in streams.items():
            check(stream == alone[c][:len(stream)],
                  f"{name}: conversation {c} decoded {stream}, alone "
                  f"{alone[c][:len(stream)]}")
    emit("traced_identity", conversations=len(alone),
         tokens_checked={k: sum(map(len, streams.values()))
                         for k, streams in cells.items()},
         sequential_tokens=sum(map(len, alone.values())),
         identical=True, replay_s=replay_s, sequential_s=sequential_s)
    return launches


# -- phase 9: the SSD kernel against its plain version ----------------------

#: tolerance of the SSD kernel against its plain version, abs and rel: the
#: reference's own kernel test (tests/test_kernels.py:112-115).
SSD_TOL = 2e-3


class SSDRecord:
    """Checks of the SSD kernel: its largest error against the plain
    version, and the number of cases checked."""

    def __init__(self) -> None:
        self.max_abs_err = 0.0
        self.checks = 0

    def compare(self, case: str, args, oracle: bool = False) -> float:
        """Kernel against the plain version on ``args`` (and against the
        exp-then-mask oracle when ``oracle``), with two kernel runs
        compared bit for bit."""
        from repro_torch.kernels import ref, ssd_scan

        got = ssd_scan.ssd_chunk_fwd(*args)
        again = ssd_scan.ssd_chunk_fwd(*args)
        wants = [ssd_scan.ssd_chunk_torch(*args)]
        if oracle:
            wants.append(ref.ssd_chunk_ref(*args))
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"ssd_chunk {case}: two runs on the same inputs differ")
        err = 0.0
        for want in wants:
            for name, g, w in zip(("y_diag", "states"), got, want):
                check(g.shape == w.shape and g.dtype == torch.float32,
                      f"ssd_chunk {case} {name}: {g.dtype} {tuple(g.shape)}, "
                      f"want {tuple(w.shape)}")
                check(bool(torch.isfinite(g).all()),
                      f"ssd_chunk {case} {name}: non-finite output")
                diff = (g - w).abs()
                if diff.numel():
                    worst = float((diff - SSD_TOL * w.abs()).max())
                    check(worst <= SSD_TOL, f"ssd_chunk {case} {name}: "
                          f"|err| - rtol*|want| = {worst} > {SSD_TOL}")
                    err = max(err, float(diff.max()))
        self.max_abs_err = max(self.max_abs_err, err)
        self.checks += 1
        return err


def ssd_inputs(g, dev, BC, Q, H, P, N, decay=0.1, shared=True):
    """x, dt, dA_cs, B, C as the reference's kernel test draws them (dA_cs a
    decreasing cumulative sum within the chunk); ``shared`` hands B and C
    over as one group read by every head (an expand view, head stride 0),
    as the model does."""
    x = torch.randn(BC, Q, H, P, generator=g, device=dev)
    dt = torch.rand(BC, Q, H, generator=g, device=dev)
    dA = -torch.cumsum(torch.rand(BC, Q, H, generator=g, device=dev) * decay, 1)
    heads = 1 if shared else H
    Bm = torch.randn(BC, Q, heads, N, generator=g, device=dev)
    Cm = torch.randn(BC, Q, heads, N, generator=g, device=dev)
    return x, dt, dA, Bm.expand(-1, -1, H, -1), Cm.expand(-1, -1, H, -1)


def phase_ssd_kernel(dev, seed: int, rec: SSDRecord) -> None:
    """The SSD kernel against its plain version on the card: the prefill's
    shape, then the edge cases of the contract."""
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    path = (4, 256, 80, 64, 128)  # a 1024-token mamba2-2.7b prefill
    args = ssd_inputs(g, dev, *path)
    err = rec.compare("path", args)
    emit("ssd_edge", case="path", shape=list(path), max_abs_err=err, ok=True)
    # the shared group read through a head stride of 0 gives the same bytes
    # as the same values copied per head
    from repro_torch.kernels import ssd_scan

    view = ssd_scan.ssd_chunk_fwd(*args)
    copied = ssd_scan.ssd_chunk_fwd(*args[:3], *(t.contiguous() for t in args[3:]))
    check(all(torch.equal(a, b) for a, b in zip(view, copied)),
          "ssd_chunk: a head-stride-0 B/C gives other bytes than its copy")
    emit("ssd_edge", case="stride0_equals_copy", ok=True)
    del args, view, copied
    for case, shape, kw in (
        ("per_head_BC", path, {"shared": False}),
        ("Q=1", (2, 1, 80, 64, 128), {}),
        ("Q=37", (3, 37, 80, 64, 128), {}),
        ("H=6", (2, 100, 6, 16, 16), {}),
        ("P16_N128", (2, 200, 5, 16, 128), {}),
        ("P32_N32", (2, 200, 5, 32, 32), {}),
        ("P128_N64", (2, 200, 5, 128, 64), {"shared": False}),
        ("P128_N128", (2, 256, 5, 128, 128), {}),
        ("P64_N16", (2, 130, 5, 64, 16), {}),
        # 13 heads: the last set of a y block (8) and a state block (4) is short
        ("H=13", (2, 256, 13, 64, 128), {}),
    ):
        err = rec.compare(case, ssd_inputs(g, dev, *shape, **kw))
        emit("ssd_edge", case=case, shape=list(shape), max_abs_err=err, ok=True,
             **kw)
    # dA_cs falling by up to 100 a row: the oracle's exp above the diagonal
    # overflows to inf before its mask, which the kernel never computes
    args = ssd_inputs(g, dev, 2, 256, 8, 64, 128, decay=100.0)
    da = args[2]
    check(bool(torch.isinf(torch.exp(da[:, :, None] - da[:, None])).any()),
          "the strongly negative case does not overflow exp")
    err = rec.compare("strongly_negative", args, oracle=True)
    emit("ssd_edge", case="strongly_negative", decay=100.0, max_abs_err=err,
         ok=True)


def measure_ssd(x, dt, dA_cs, Bm, Cm) -> dict:
    """Kernel and plain-version times at the path's shape (event-timed, and
    the device time alone from the profiler), and the bound: the larger of
    the bytes (each input read once, a stride-0 B/C once per chunk, the
    outputs written once) over the memory rate and the least operations
    (C.B^T once per chunk when every head reads one B/C group, the causal
    products of each head) over the TF32 peak.  No single PyTorch call
    computes this function, so there is no library time."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch.roofline import kernel_work

    BC, Q, H, P = x.shape
    N = Bm.shape[-1]
    ssd = lambda: ssd_scan.ssd_chunk_fwd(x, dt, dA_cs, Bm, Cm)  # noqa: E731
    kernel_ms = time_ms(ssd)
    plain_ms = time_ms(lambda: ssd_scan.ssd_chunk_torch(x, dt, dA_cs, Bm, Cm),
                       reps=5)
    dev_ms, per_call, names, lost = device_profile(ssd)
    check(per_call == 1 and all("ssd_chunk_kernel" in n for n in names),
          f"ssd_chunk made {per_call} launches a call, of {names}")
    one_group = Bm.stride(2) == 0 and Cm.stride(2) == 0
    work = kernel_work("ssd_chunk", x, dt, dA_cs, Bm, Cm)
    plan = ssd_scan._plan(BC, Q, H, P, one_group)
    return {
        "shape": {"BC": BC, "Q": Q, "H": H, "P": P, "N": N,
                  "B_C_head_stride_0": one_group, "dtype": "float32"},
        "kernel_route": "3xTF32: C.B^T on mma.sync, y and states on wgmma",
        "plan": {"y_heads": plan.y_heads, "s_heads": plan.s_heads,
                 "blocks": plan.blocks},
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
        "device_ms": dev_ms, "kernels_seen": sorted(names), "window_lost": lost,
        "bound_ms": work.bound_ms, "bound_by": work.bound_by,
        "flops": work.flops, "bytes": work.bytes,
    }


# -- phase 10: serving Mamba-2 at full mamba2-2.7b width ----------------------

def draw_ssm_params(cfg, seed: int, dev):
    """Random bf16 weights for a Mamba-2 ``cfg``, drawn on the card from
    ``seed`` with the model's own init, then with the three leaves that
    init simplifies set as Mamba-2's published init sets them: ``dt_bias``
    so that softplus gives dt log-uniform in [0.001, 0.1], ``A_log`` as
    log U[1, 16], and the output projection ``wo`` divided by
    sqrt(n_layers) (the pre-norm residual rescaling).

    The model's own init (``dt_bias`` 0, ``A_log`` 0) gives dt near 0.7
    and one decay for every head, so the recurrent state forgets within
    a token or two and a state restored wrongly after a resume would
    barely change the tokens.  With the published dt and A most heads
    carry the state over tens to thousands of tokens, so the paging
    checks depend on it.
    """
    from repro_torch.models import init_params, model_defs

    g = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(model_defs(cfg), g, dev)
    for block in [*params["prelude"], *params["body"], *params["postlude"]]:
        mixer = block["mixer"]
        dt = torch.exp(torch.rand(mixer["dt_bias"].shape, generator=g, device=dev)
                       * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
        dt = dt.clamp_min(1e-4)
        mixer["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
        a = torch.rand(mixer["A_log"].shape, generator=g, device=dev) * 15 + 1
        mixer["A_log"].copy_(torch.log(a))
        mixer["wo"].mul_(1 / math.sqrt(cfg.n_layers))
    return params


def phase_ssm_serving(dev, seed: int, cfg, prompt_len: int, max_tokens: int,
                      n_convs: int, steps: int, lossless_steps: int,
                      workdir: Path):
    """Marvel-Serve over Mamba-2 through ``MarvelClient.serving`` on the
    card: conversations interleaved over a warm pool half their number
    (each eviction pushes a recurrent state to PMEM, each next step resumes
    one), lossless suspend/resume byte identity, a restart that re-adopts
    the sessions, and decode-step logits against a fresh prefill.  Returns
    the SSD kernel's launches on the path and the arguments of its last
    call there."""
    from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.models import init_params, model_defs

    t0 = time.perf_counter()
    params = draw_ssm_params(cfg, seed, dev)
    s = cfg.ssm
    H, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
    convdim = s.d_inner(cfg.d_model) + 2 * s.n_groups * N
    state_bytes = cfg.n_periods * H * P * N * 4
    conv_bytes = cfg.n_periods * (s.d_conv - 1) * convdim * 2
    rng = np.random.default_rng(seed + 3)
    prompts = rng.integers(0, cfg.vocab, (n_convs, 1, prompt_len), dtype=np.int32)
    torch.cuda.synchronize()
    emit("ssm_setup", model=cfg.name, params=sum(p.numel() for p in _leaves(params)),
         param_bytes=sum(p.numel() * p.element_size() for p in _leaves(params)),
         layers=cfg.n_layers, d_model=cfg.d_model, heads=H, head_dim=P,
         d_state=N, chunk=s.chunk, prompt_len=prompt_len,
         conversations=n_convs, state_bytes=state_bytes, conv_bytes=conv_bytes,
         setup_s=time.perf_counter() - t0)

    def cluster(name: str, warm_pool: int) -> ClusterConfig:
        # lossless: a recurrent state has nothing to quantize, and a lossy
        # pager would only rewrite it whole before each demotion
        root = workdir / name
        return ClusterConfig(
            name=name,
            tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / "pmem"))),
            invokers=1, warm_pool=warm_pool, commit_every=1,
            journal="pmem", journal_path=str(root / "journal"),
            serving=ServingConfig(block_tokens=16, lossless=True),
        )

    def serve(client):
        return client.serving(params, cfg, prompt_len=prompt_len,
                              max_tokens=max_tokens, device=dev)

    ssd_spy = _Spy(ops, "ssd_chunk")
    counts = {}

    def mark(at: str) -> None:
        counts[at] = ssd_scan.launches

    ssd_scan.launches = 0  # the Mamba-2 serving path starts here
    try:
        # (a) more conversations than warm slots, steps interleaved: every
        # eviction pushes a state to PMEM, every next step resumes one
        with MarvelClient(cluster("ssm_pool", warm_pool=n_convs // 2)) as client:
            pool = serve(client)
            convs = [f"m{i}" for i in range(n_convs)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            firsts = [_tok(pool.start(c, prompts[i])) for i, c in enumerate(convs)]
            prefill_s = time.perf_counter() - t
            mark("pool_prefilled")
            streams = {c: [] for c in convs}
            t = time.perf_counter()
            for _ in range(steps):
                for c in convs:
                    streams[c].append(_tok(pool.step(c)))
            torch.cuda.synchronize()
            pool_s = time.perf_counter() - t
            stats = pool.stats()
            layers, _ = pool.pager.load(pool._scoped(convs[0]))
        check(stats["demotions"] >= n_convs * steps and stats["resumes"] > 0,
              f"the pool did not evict and resume every step: {stats}")
        check([tuple(l.shape) for l in layers]
              == [(cfg.n_periods, 1, s.d_conv - 1, convdim),
                  (cfg.n_periods, 1, H, P, N)]
              and layers[1].dtype == torch.float32
              and all(l.device == dev for l in layers),
              "a resumed Mamba-2 session did not come back as its conv window "
              "and f32 state on the card")
        del layers
        toks = [x for c in convs for x in streams[c]] + firsts
        check(all(0 <= x < cfg.vocab for x in toks), "token out of vocabulary")
        emit("ssm_pool", conversations=n_convs, warm_pool=n_convs // 2,
             steps_each=steps, prefill_s=prefill_s,
             prefill_tokens_per_s=n_convs * prompt_len / prefill_s,
             decode_s=pool_s, tokens_per_s=n_convs * steps / pool_s,
             demotions=stats["demotions"], resumes=stats["resumes"],
             demand_faults=stats["demand_faults"],
             blocks_written=stats["blocks_written"])
        shutil.rmtree(workdir / "ssm_pool", ignore_errors=True)

        # (b) lossless suspend/resume and (c) a restart
        stream_c, _, _ = lossless_and_restart(
            cluster("ssm_lossless", warm_pool=8), serve, prompts, firsts,
            lossless_steps, mark, "ssm", dev)
    finally:
        ssd_spy.restore()
    launches = counts["after_restart"]  # ... and ends here
    check(counts["pool_prefilled"] >= n_convs * cfg.n_layers,
          f"ssd_chunk launched {counts['pool_prefilled']} times for "
          f"{n_convs} prefills of {cfg.n_layers} layers")
    check(counts["after_resume"] > counts["resumed"],
          "ssd_chunk did not launch after the resume")
    check(counts["after_restart"] > counts["after_resume"],
          "ssd_chunk did not launch after the restart")
    emit("ssm_launches", **counts)

    # (d) decode-step logits (the recurrent form, no kernel) against a fresh
    # prefill over the same tokens (the kernel; 1024 plus the new tokens is
    # no multiple of the chunk, so the zero-dt padding runs), with the
    # served weights computed in f32.  In bf16 this random 64-layer model
    # amplifies the rounding differences of the two forms (their GEMMs
    # see 1 row and 1036) to a few percent: that error is printed beside
    # the checked one, not held.
    tokens = torch.tensor([prompts[0, 0].tolist() + stream_c[:max_tokens]],
                          dtype=torch.int32, device=dev)
    f32 = _tree_map(lambda t: t.float(), params)
    rel, agree, n_dec = decode_vs_prefill(f32, cfg, tokens, prompt_len,
                                          max_tokens)
    del f32
    check(rel <= 2e-2, f"Mamba-2 decode vs prefill logits: relative L2 error "
          f"{rel} > 2e-2")
    bf16_rel, bf16_agree, _ = decode_vs_prefill(params, cfg, tokens,
                                                prompt_len, max_tokens)
    own = init_params(model_defs(cfg), torch.Generator(device=dev).manual_seed(seed), dev)
    own_rel, own_agree, _ = decode_vs_prefill(own, cfg, tokens, prompt_len,
                                              max_tokens)
    del own
    emit("ssm_consistency", positions=n_dec, weights="served, in f32",
         max_rel_l2=rel, argmax_agreement=agree, tolerance=2e-2,
         prefill_tokens=prompt_len + n_dec - 1, chunk=s.chunk,
         bf16_max_rel_l2=bf16_rel, bf16_argmax_agreement=bf16_agree,
         own_init_bf16_max_rel_l2=own_rel,
         own_init_bf16_argmax_agreement=own_agree)
    emit("ssm_profile", **profile_decode(params, cfg, tokens, prompt_len,
                                         max_tokens))
    return launches, ssd_spy.last

# -- phases 11-13: the remaining mixers at full width -------------------------

def free_card() -> None:
    """Return the memory of everything unreachable to the card: a serving
    pool's client, gateway and pager refer to each other, so the weights
    and caches they hold go only when the cycle collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def _to_f32_in_place(tree, dev) -> None:
    """Replace every tensor leaf of a dict/list tree by its f32 copy on
    ``dev``, through the host: the f32 tree of a 16 B-parameter model
    (63 GB) and its bf16 original (31 GB) do not fit on the card together,
    and a card that has served holds cached segments that a leaf-by-leaf
    conversion in place cannot reuse.  So every leaf goes to the host
    first, the card's cache is emptied, and the leaves come back one by
    one.  The tree must hold the only reference to each leaf."""
    slots = []

    def walk(node) -> None:
        for key in list(node) if isinstance(node, dict) else range(len(node)):
            if isinstance(node[key], torch.Tensor):
                slots.append((node, key))
            else:
                walk(node[key])

    walk(tree)
    for node, key in slots:
        node[key] = node[key].cpu()
    free_card()
    for node, key in slots:
        node[key] = node[key].to(dev).float()
        torch.cuda.empty_cache()


@torch.no_grad()
def routing(params, cfg, tokens, own_capacity: float) -> dict:
    """Each MoE layer's routing over one forward of ``tokens``: its expert
    histogram over the N·k entries (uniform: N·k/E each), the most first
    choices one expert took, the experts used, and the entries that a
    capacity factor of ``MOE_CAPACITY`` and the model's own would drop."""
    from repro_torch.models import forward
    from repro_torch.models import moe as moe_module

    m = cfg.moe
    spy = _Spy(moe_module, "_route", keep=True)
    try:
        forward(params, cfg, {"tokens": tokens})
    finally:
        spy.restore()
    N, E = tokens.numel(), m.n_experts
    out = {"histograms": [], "max_first_choices": [], "experts_used": [],
           f"dropped_at_{MOE_CAPACITY:g}": [], "dropped_at_own_capacity": []}
    for _, idx, _ in spy.outputs:
        counts = torch.bincount(idx.reshape(-1), minlength=E)
        out["histograms"].append(counts.tolist())
        out["max_first_choices"].append(int(torch.bincount(idx[:, 0], minlength=E).max()))
        out["experts_used"].append(int((counts > 0).sum()))
        for cf, key in ((MOE_CAPACITY, f"dropped_at_{MOE_CAPACITY:g}"),
                        (own_capacity, "dropped_at_own_capacity")):
            cap = max(1, int(math.ceil(N * m.top_k / E * cf)))  # as moe.py
            out[key].append(int((counts - cap).clamp_min(0).sum()))
    out["max_entries"] = [max(h) for h in out["histograms"]]
    return out


def mixer_consistency(params, cfg, tokens, prompt_len: int, max_tokens: int,
                      label: str) -> None:
    """(d) of a mixer phase: decode-step logits against one prefill over
    the same tokens, relative L2 <= 2e-2, held with the served weights
    computed in f32 (converted in place: the last use of ``params``), as
    the Mamba-2 phase holds it; the bf16 error, which a random deep model
    amplifies, is printed beside it.  A MoE model runs here at capacity
    factor ``MOE_CAPACITY``, as the reference's own decode test does: its
    1024-token prefill would drop, at the model's own 1.25, entries that a
    one-token step keeps.  Its routing over that prefill is printed first,
    with the served embedding and with the embedding at its own init
    scale (:func:`draw_params`)."""
    if cfg.moe is not None:
        own_capacity = cfg.moe.capacity_factor
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=MOE_CAPACITY))
        n_dec = min(max_tokens, tokens.shape[1] - prompt_len)
        prefix = tokens[:, :prompt_len + n_dec - 1]
        served = routing(params, cfg, prefix, own_capacity)
        embed = params["embed"]
        params["embed"] = embed / MOE_EMBED_GAIN
        try:
            own = routing(params, cfg, prefix, own_capacity)
        finally:
            params["embed"] = embed
            del embed  # the tree must hold the only reference below
        own.pop("histograms")
        emit(f"{label}_routing", tokens=prefix.numel(), experts=cfg.moe.n_experts,
             top_k=cfg.moe.top_k,
             uniform_entries=prefix.numel() * cfg.moe.top_k / cfg.moe.n_experts,
             served=served, embedding_at_own_init=own)
    bf16_rel, bf16_agree, _ = decode_vs_prefill(params, cfg, tokens,
                                                prompt_len, max_tokens)
    _to_f32_in_place(params, tokens.device)
    rel, agree, n_dec = decode_vs_prefill(params, cfg, tokens, prompt_len,
                                          max_tokens)
    emit(f"{label}_consistency", positions=n_dec, weights="served, in f32",
         max_rel_l2=rel, argmax_agreement=agree, tolerance=2e-2,
         capacity_factor=cfg.moe.capacity_factor if cfg.moe else None,
         bf16_max_rel_l2=bf16_rel, bf16_argmax_agreement=bf16_agree)
    check(rel <= 2e-2, f"{cfg.name} decode vs prefill logits: relative L2 "
          f"error {rel} > 2e-2")


def phase_mixer_serving(dev, seed: int, cfg, label: str, prompt_len: int,
                        max_tokens: int, n_convs: int, steps: int,
                        lossless_steps: int, workdir: Path):
    """Marvel-Serve over recurrentgemma-9b (RG-LRU beside local attention)
    or deepseek-v2-lite-16b (MLA and MoE) at full width through
    ``MarvelClient.serving`` on the card, lossless: conversations
    interleaved over a warm pool half their number (each eviction pushes a
    conversation's caches to PMEM, each next step resumes one), lossless
    suspend/resume byte identity, a restart that re-adopts the sessions,
    decode-step logits against a fresh prefill, and a profile of the bare
    model step.  Returns the attention kernels' launches on the path and
    the arguments of the last flash and decode calls there."""
    from repro_torch.api import ClusterConfig, MarvelClient, ServingConfig, TierSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache
    from repro_torch.serving import flatten_cache

    t0 = time.perf_counter()
    params = draw_params(cfg, seed, dev)
    rng = np.random.default_rng(seed + 5)
    prompts = rng.integers(0, cfg.vocab, (n_convs, 1, prompt_len), dtype=np.int32)
    want = [l for l in flatten_cache(init_cache(cfg, 1, prompt_len + max_tokens,
                                                device="meta"))[0]]
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(want))
    torch.cuda.synchronize()
    emit(f"{label}_setup", model=cfg.name,
         params=sum(p.numel() for p in _leaves(params)),
         param_bytes=sum(p.numel() * p.element_size() for p in _leaves(params)),
         layers=cfg.n_layers, d_model=cfg.d_model, prompt_len=prompt_len,
         max_tokens=max_tokens, conversations=n_convs,
         cache_bytes_per_conversation=cache_bytes,
         setup_s=time.perf_counter() - t0)

    def cluster(name: str, warm_pool: int) -> ClusterConfig:
        root = workdir / name
        return ClusterConfig(
            name=name,
            tiers=(TierSpec("dram"), TierSpec("pmem", path=str(root / "pmem"))),
            invokers=1, warm_pool=warm_pool, commit_every=1,
            journal="pmem", journal_path=str(root / "journal"),
            serving=ServingConfig(block_tokens=16, lossless=True),
        )

    def serve(client):
        return client.serving(params, cfg, prompt_len=prompt_len,
                              max_tokens=max_tokens, device=dev)

    flash_spy = _Spy(ops, "flash_attention")
    decode_spy = _Spy(ops, "decode_attention")
    counts = {}

    def mark(at: str) -> None:
        counts[at] = {"flash_attention": fa.launches,
                      "decode_attention": da.launches}

    fa.launches = da.launches = 0  # this model's serving path starts here
    try:
        with MarvelClient(cluster(f"{label}_pool", warm_pool=n_convs // 2)) as client:
            pool = serve(client)
            convs = [f"{label}{i}" for i in range(n_convs)]
            torch.cuda.synchronize()
            t = time.perf_counter()
            firsts = [_tok(pool.start(c, prompts[i])) for i, c in enumerate(convs)]
            prefill_s = time.perf_counter() - t
            mark("pool_prefilled")
            streams = {c: [] for c in convs}
            t = time.perf_counter()
            for _ in range(steps):
                for c in convs:
                    streams[c].append(_tok(pool.step(c)))
            torch.cuda.synchronize()
            pool_s = time.perf_counter() - t
            stats = pool.stats()
            layers, _ = pool.pager.load(pool._scoped(convs[0]))
        check(stats["demotions"] >= n_convs * steps and stats["resumes"] > 0,
              f"the {cfg.name} pool did not evict and resume every step: {stats}")
        check([type(l) for l in layers] == [type(w) for w in want]
              and all(tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype
                      and a.device == dev
                      for a, b in zip(_leaves(layers), _leaves(want))),
              f"a resumed {cfg.name} session did not come back as its cache "
              "tree's layers on the card")
        del layers
        toks = [x for c in convs for x in streams[c]] + firsts
        check(all(0 <= x < cfg.vocab for x in toks), "token out of vocabulary")
        emit(f"{label}_pool", conversations=n_convs, warm_pool=n_convs // 2,
             steps_each=steps, prefill_s=prefill_s,
             prefill_tokens_per_s=n_convs * prompt_len / prefill_s,
             decode_s=pool_s, tokens_per_s=n_convs * steps / pool_s,
             demotions=stats["demotions"], resumes=stats["resumes"],
             demand_faults=stats["demand_faults"],
             blocks_written=stats["blocks_written"])
        shutil.rmtree(workdir / f"{label}_pool", ignore_errors=True)

        # (b) lossless suspend/resume and (c) a restart
        stream_c, _, split = lossless_and_restart(
            cluster(f"{label}_lossless", warm_pool=8), serve, prompts, firsts,
            lossless_steps, mark, label, dev)
    finally:
        for spy in (flash_spy, decode_spy):
            spy.restore()
    launches = dict(counts["after_restart"])  # ... and ends here
    path = ["flash_attention"] + (["decode_attention"] if cfg.mla is None else [])
    for kernel in path:
        check(counts["pool_prefilled"][kernel] > 0,
              f"{kernel} did not launch in the {cfg.name} pool")
        check(counts["after_resume"][kernel] > counts["resumed"][kernel],
              f"{kernel} did not launch after the {cfg.name} resume")
        check(counts["after_restart"][kernel] > counts["after_resume"][kernel],
              f"{kernel} did not launch after the {cfg.name} restart")
    # the whole cache is written every step (opaque leaves): its share
    emit(f"{label}_launches", **counts,
         write_share_of_step=split["write_ms_per_step"] / split["step_ms"],
         cache_bytes_written_per_step=cache_bytes)
    tokens = torch.tensor([prompts[0, 0].tolist() + stream_c[:max_tokens]],
                          dtype=torch.int32, device=dev)
    emit(f"{label}_profile", **profile_decode(params, cfg, tokens, prompt_len,
                                              max_tokens))
    mixer_consistency(params, cfg, tokens, prompt_len, max_tokens, label)
    return launches, flash_spy.last, decode_spy.last


@torch.no_grad()
def phase_moe_model(dev, seed: int, cfg, prompt_len: int, steps: int) -> dict:
    """dbrx-132b at full width with its depth cut: one prefill of
    ``prompt_len`` tokens and ``steps`` greedy decode steps through
    ``forward``/``decode_step`` (no serving pool), decode-step logits
    against one prefill, and a profile of the bare step.  Returns the
    attention kernels' launches on the path."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import decode_step, forward, logits_fn

    t0 = time.perf_counter()
    params = draw_params(cfg, seed, dev)
    prompt = torch.from_numpy(np.random.default_rng(seed + 7).integers(
        0, cfg.vocab, (1, prompt_len), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    emit("moe_setup", model=cfg.name, layers=cfg.n_layers,
         params=sum(p.numel() for p in _leaves(params)),
         param_bytes=sum(p.numel() * p.element_size() for p in _leaves(params)),
         d_model=cfg.d_model, experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
         d_expert=cfg.moe.d_expert, prompt_len=prompt_len, steps=steps,
         setup_s=time.perf_counter() - t0)
    fa.launches = da.launches = 0  # this path starts here
    t = time.perf_counter()
    h, aux, cache = forward(params, cfg, {"tokens": prompt}, collect_cache=True,
                            cache_len=prompt_len + steps)
    tok = torch.argmax(logits_fn(params, cfg, h[:, -1]), -1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    check(bool(torch.isfinite(aux)) and float(aux) > 0, f"MoE aux loss {aux}")
    out = [int(tok)]
    t = time.perf_counter()
    for i in range(steps):
        lg, cache = decode_step(params, cfg, tok, cache, prompt_len + i)
        tok = torch.argmax(lg, -1).to(torch.int32)[:, None]
        out.append(int(tok))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
    check(launches["flash_attention"] == cfg.n_layers
          and launches["decode_attention"] == cfg.n_layers * steps,
          f"{cfg.name}: launches {launches} for one prefill and {steps} steps "
          f"of {cfg.n_layers} layers")
    check(all(0 <= x < cfg.vocab for x in out), "token out of vocabulary")
    emit("moe_run", prefill_s=prefill_s,
         prefill_tokens_per_s=prompt_len / prefill_s, decode_s=decode_s,
         hot_tokens_per_s=steps / decode_s, aux_loss=float(aux), tokens=out,
         **launches)
    del cache
    tokens = torch.cat([prompt, torch.tensor([out], dtype=torch.int32, device=dev)],
                       dim=1)
    emit("moe_profile", **profile_decode(params, cfg, tokens, prompt_len, steps))
    mixer_consistency(params, cfg, tokens, prompt_len, steps, "moe")
    return launches


# -- phases 14-17: training at full qwen2.5-3b width ----------------------------

TRAIN_MODEL = "qwen2.5-3b"  # full width: 36 layers, d_model 2048, 3.40 B parameters
TRAIN_SEQ = 4096  # the reference's train_4k length
TRAIN_BATCH = 4  # train_4k's global batch of 256 in 8 microbatches, cut to 4 in 4
TRAIN_MICROBATCHES = 4
TRAIN_STEPS = 4
#: AdamW's rate.  3e-3 (the reference launcher's default, sized for its
#: reduced models) diverges at full width: AdamW's first steps move every
#: weight by about the rate, and the loss rose from 12.33 to 13.61 over 6
#: steps (PERF.md §6); 3e-4 is the optimizer's own default
TRAIN_LR = 3e-4
GRAD_LAYERS = 2  # the whole-model gradient check: full width, 2 layers
GRAD_SEQ = 1024
GRAD_TOL = 1e-3  # relative L2 per parameter, kernels against plain versions, f32
CRASH_LAYERS = 2  # crash and restore: full width, 2 layers (see phase_crash_restore)
CRASH_SEQ = 1024
CRASH_STEPS, CRASH_EVERY, CRASH_AT = 3, 2, 3
#: the backward kernel against its plain version (run in f32): relative L2
#: of dq, dk, dv; the bf16/f16 limit is the forward's
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-2}
SSD_BWD_TOL = 1e-4  # relative L2 per gradient: 3xTF32 products against the plain version
#: a 4096-token mamba2-2.7b microbatch: BC = 4096 / 256 chunks, Q, H, P, N
SSD_TRAIN_SHAPE = (16, 256, 80, 64, 128)
SSM_TRAIN_PERIODS = 16  # mamba2-2.7b's 64 layers cut to 16 (the run's time limit)
SSM_TRAIN_STEPS = 3
RG_TRAIN_PERIODS = 1  # recurrentgemma-9b's 12 (R, R, L) periods cut to 1: 5 blocks
RG_TRAIN_STEPS = 2
SSD_BWD_KERNELS_PER_CALL = 3  # pair_kernel, head_kernel, group_kernel


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))


class BwdRecord:
    """Checks of the backward kernel: its largest relative L2 and absolute
    errors against the plain version run in f32, and the cases checked."""

    def __init__(self) -> None:
        self.max_rel_l2 = 0.0
        self.max_abs_err = 0.0
        self.checks = 0


#: the backward kernel's route by input type: wgmma for bf16/f16, 3xTF32
#: on mma.sync for f32
BWD_ROUTE = {torch.bfloat16: "wgmma", torch.float16: "wgmma",
             torch.float32: "tf32x3"}


def bwd_case(rec: BwdRecord, case: str, q, k, v, do, norms=None, **kw) -> None:
    """The forward kernel's lse and the backward kernel's dq, dk, dv
    against the plain versions in f32 on the same inputs, on the route the
    input type must take, each call made twice: the same bits both times;
    then the backward event-timed.  ``norms`` (name -> norm) replaces the
    plain gradient's norm as the relative error's denominator where the
    gradient cancels to 0 in exact arithmetic (both versions' values are
    then rounding noise): the norm of the terms that cancel."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    o2, lse2 = fa.flash_attention(q, k, v, return_lse=True, **kw)
    route = fb._plan(q, k, v, o, do)
    check(route == BWD_ROUTE[q.dtype],
          f"flash_attention_bwd {case}: {q.dtype} took route {route}")
    got = fb.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fb.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    check(torch.equal(o, o2) and torch.equal(lse, lse2)
          and all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash_attention_bwd {case}: two calls on the same inputs differ")
    _, lse_want = fa.flash_attention_torch(q.float(), k.float(), v.float(),
                                           return_lse=True, **kw)
    lse_err = float((lse - lse_want).abs().max())
    check(lse_err <= LSE_TOL[q.dtype], f"flash lse {case}: max abs err {lse_err}")
    want = fb.flash_attention_bwd_torch(q.float(), k.float(), v.float(), o.float(),
                                        do.float(), lse, **kw)
    rels, abss = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check(g.dtype == q.dtype and g.shape == w.shape
              and bool(torch.isfinite(g.float()).all()),
              f"flash_attention_bwd {case}: {name} {g.dtype} {tuple(g.shape)}")
        rels[name] = (_rel_l2(g, w) if norms is None or name not in norms
                      else float((g.float() - w.float()).norm() / norms[name]))
        abss[name] = float((g.float() - w.float()).abs().max())
        check(rels[name] <= BWD_TOL[q.dtype],
              f"flash_attention_bwd {case}: {name} relative L2 {rels[name]}")
    rec.max_rel_l2 = max(rec.max_rel_l2, *rels.values())
    rec.max_abs_err = max(rec.max_abs_err, *abss.values())
    rec.checks += 1
    ms = time_ms(lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, **kw), reps=5,
                 warmup=1)
    emit("flash_bwd_case", case=case, shape=list(q.shape), keys=k.shape[1],
         kv_heads=k.shape[2], v_head_dim=v.shape[3], dtype=str(q.dtype), route=route,
         ms=ms, rel_l2=rels, max_abs_err=abss, lse_max_abs_err=lse_err,
         tol=BWD_TOL[q.dtype], bit_identical_rerun=True, ok=True,
         **({"cancelling_terms_norm": norms} if norms else {}),
         **{k_: v_ for k_, v_ in kw.items() if v_ is not None})


def phase_flash_backward(dev, seed: int, rec: BwdRecord):
    """The backward kernel's cases; returns the training shape's inputs."""
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    bf16, f32 = torch.bfloat16, torch.float32

    def inputs(B, T, H, Kv, dh, dtype, Tk=None):
        q, k, v = flash_inputs(g, dev, B, T, H, Kv, dh, dtype, Tk=Tk)
        return q, k, v, _randn(g, (B, T, H, dh), dtype, dev)

    train = inputs(1, TRAIN_SEQ, 16, 2, 128, bf16)
    bwd_case(rec, "train_shape", *train, causal=True)
    bwd_case(rec, "dh64_kv1", *inputs(1, 1024, 16, 1, 64, bf16), causal=True)
    bwd_case(rec, "dh256_kv1", *inputs(1, 1024, 16, 1, 256, bf16), causal=True)
    bwd_case(rec, "rep1_full", *inputs(1, 1024, 16, 16, 128, bf16), causal=False)
    # gemma2-9b's attention: 16 heads of 256 over 8, softcap 50, window
    # 4096, over 4160 tokens so that the window masks
    bwd_case(rec, "gemma2_softcap_window", *inputs(1, 4160, 16, 8, 256, bf16),
             causal=True, softcap=50.0, window=4096)
    bwd_case(rec, "ragged_T1000", *inputs(1, 1000, 16, 2, 128, bf16), causal=True)
    bwd_case(rec, "f32_route", *inputs(1, 1024, 16, 2, 128, f32), causal=True)
    bwd_case(rec, "f16_ragged", *inputs(2, 333, 8, 2, 64, torch.float16), causal=True,
             window=100)
    # the split kernels at dh 256 in f16, ragged (the last 64-row tiles
    # part empty), with a window that cuts the walks short
    bwd_case(rec, "f16_dh256_ragged_window", *inputs(2, 333, 8, 2, 256, torch.float16),
             causal=True, window=100)
    # fewer queries than keys, not causal: the q tiles' rows past Tq come
    # in as TMA's zeros; the softcap on the tensor-core route
    bwd_case(rec, "tq_lt_tk_full", *inputs(1, 1000, 16, 2, 128, bf16, Tk=1536),
             causal=False, softcap=30.0)
    return train


def phase_f32_flash(dev, seed: int, flash: AttnRecord, rec: BwdRecord) -> None:
    """The f32 route (``tf32x3``) forward and backward at every pair of
    head dims, beside the ``float32``, ``mla_float32``, ``f32_route`` and
    ``mla_f32_route`` cases: dh 64 over a ragged T, dh 256 with a window,
    dh 128 with a softcap, not causal, over more keys than queries, MLA's
    (192, 128) over a ragged T, and dh 128 from views whose strides
    16-byte copies cannot take (the 4-byte cp.async path).  The forward
    is held to ATTN_TOL (:func:`flash_case`), the backward to BWD_TOL and
    LSE_TOL with each call made twice for the same bits (:func:`bwd_case`)."""
    g = torch.Generator(device=dev).manual_seed(seed + 27)
    f32 = torch.float32
    # (case, (B, T, H, Kv, dh, Tk, dv), options)
    for case, (B, T, H, Kv, dh, Tk, dv), kw in (
        ("f32_dh64_ragged", (2, 333, 8, 2, 64, None, None), {"causal": True}),
        ("f32_dh256_window", (1, 517, 8, 2, 256, None, None),
         {"causal": True, "window": 100}),
        ("f32_dh128_softcap_full_Tq<Tk", (1, 200, 16, 2, 128, 333, None),
         {"causal": False, "softcap": 30.0}),
        ("f32_mla_ragged", (2, 333, 16, 16, 192, None, 128),
         {"causal": True, "scale": 1 / math.sqrt(192)}),
        ("f32_dh128_unaligned_views", (1, 200, 8, 2, 128, None, None),
         {"causal": True}),
    ):
        q, k, v = flash_inputs(g, dev, B, T, H, Kv, dh, f32, Tk=Tk, dv=dv)
        if "unaligned" in case:  # head strides of dh + 1 elements
            q, k, v = (torch.zeros(*x.shape[:3], x.shape[3] + 1, dtype=f32, device=dev)
                       [..., :x.shape[3]].copy_(x) for x in (q, k, v))
        flash_case(flash, case, q, k, v, **kw)
        bwd_case(rec, case, q, k, v, _randn(g, (B, T, H, v.shape[3]), f32, dev), **kw)


class _PlainFlash(torch.autograd.Function):
    """Attention through the plain versions of both kernels, for the
    whole-model gradient check."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, softcap, window):
        from repro_torch.kernels import flash_attention as fa

        ctx.kw = dict(causal=causal, scale=scale, softcap=softcap, window=window)
        o, lse = fa.flash_attention_torch(q, k, v, return_lse=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import flash_attention_bwd as fb

        q, k, v, o, lse = ctx.saved_tensors
        return (*fb.flash_attention_bwd_torch(q, k, v, o, do, lse, **ctx.kw),
                None, None, None, None)


def _kernel_pair(cfg):
    """The modules of the forward and backward kernels that ``cfg``'s
    gradient path runs, and the names the ``kernels`` line gives them:
    the SSD chunk for Mamba-2, flash attention otherwise (RG-LRU's scan is
    torch ops)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ssd_scan, ssd_scan_bwd

    if cfg.ssm is not None:
        return (ssd_scan, ssd_scan_bwd), ("ssd_chunk", "ssd_chunk_bwd")
    return (fa, fb), ("flash_attention", "flash_attention_bwd")


def _path_layers(cfg) -> tuple:
    """Layers of ``cfg`` whose mixer runs the path's kernels (Mamba-2's SSD
    layers, else attention, local attention and MLA): (in the body, whose
    periods remat recomputes; in the prelude and postlude, which it does
    not)."""
    mixers = ("ssm",) if cfg.ssm is not None else ("attn", "local", "mla")
    body = cfg.n_periods * sum(b.mixer in mixers for b in cfg.pattern)
    rest = sum(b.mixer in mixers for b in (*cfg.prelude, *cfg.postlude))
    return body, rest


def _draw_train_params(cfg, seed: int, dev):
    """f32 weights for a training phase: Mamba-2's published dt, A and
    output scale (:func:`draw_ssm_params`), the attention projections at
    their true fan-in otherwise (:func:`draw_params`)."""
    draw = draw_ssm_params if cfg.ssm is not None else draw_params
    params = draw(cfg, seed, dev)
    _to_f32_in_place(params, dev)
    return params


def phase_grad_check(dev, seed: int, model: str = TRAIN_MODEL,
                     n_periods: int = GRAD_LAYERS, rerun: bool = False) -> dict:
    """``loss.backward()`` of ``model`` at full width, its body cut to
    ``n_periods`` periods, one sequence of 1024, f32, remat "full": through
    the kernels, then through the plain versions of both (``_PlainFlash``
    or ``_PlainSSD`` in place of the wrapper); every parameter's gradient
    held to relative L2 GRAD_TOL, and the launches to 2 forward (the
    forward and remat's recompute) and 1 backward a body layer, 1 and 1 a
    prelude or postlude layer.  With ``rerun`` the kernels' pass runs
    twice and every gradient must be the same bits."""
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import autograd_leaves
    from repro_torch.models import forward
    from repro_torch.models.layers import chunked_ce_loss
    from repro_torch.tree import tree_leaves, tree_map

    cfg = replace(get_config(model), n_periods=n_periods)
    params = _draw_train_params(cfg, seed, dev)
    (fwd, bwd), names = _kernel_pair(cfg)
    batch = make_batch(PipelineConfig(vocab=cfg.vocab, seq_len=GRAD_SEQ,
                                      global_batch=1), 0)
    tokens = torch.from_numpy(batch["tokens"]).to(dev)
    labels = torch.from_numpy(batch["labels"]).to(dev)

    def grads():
        buf = tree_map(torch.zeros_like, params)
        leaves = autograd_leaves(params, buf)
        h, aux = forward(leaves, cfg, {"tokens": tokens}, remat="full")
        loss, _ = chunked_ce_loss(h, leaves["unembed"], labels, t_chunk=512)
        (loss + 0.01 * aux).backward()
        torch.cuda.synchronize()
        return float(loss.detach()), tree_leaves(buf)

    fwd.launches = bwd.launches = 0
    loss_k, grads_k = grads()
    launches = {names[0]: fwd.launches, names[1]: bwd.launches}
    body, rest = _path_layers(cfg)
    want = {names[0]: 2 * body + rest, names[1]: body + rest}
    check(launches == want, f"gradient check: launches {launches} for "
          f"{cfg.n_layers} layers under remat full, want {want}")
    equal_rerun = None
    if rerun:
        loss_r, grads_r = grads()
        equal_rerun = loss_r == loss_k and all(
            torch.equal(a, b) for a, b in zip(grads_k, grads_r))
        check(equal_rerun, f"gradient check {cfg.name}: a second backward "
              "gave other gradients")
        del grads_r
        fwd.launches, bwd.launches = launches[names[0]], launches[names[1]]
    if cfg.ssm is not None:
        op, plain = "ssd_chunk", _PlainSSD.apply
    else:
        op = "flash_attention"

        def plain(q, k, v, causal=True, scale=None, softcap=None, window=None):
            return _PlainFlash.apply(q, k, v, causal, scale, softcap, window)
    kernel_fn = getattr(ops, op)
    setattr(ops, op, plain)
    try:
        loss_p, grads_p = grads()
    finally:
        setattr(ops, op, kernel_fn)
    check({names[0]: fwd.launches, names[1]: bwd.launches} == want,
          "the plain pass launched a kernel")
    rels = [_rel_l2(a, b) for a, b in zip(grads_k, grads_p)]
    worst = max(rels)
    check(all(math.isfinite(r) for r in rels) and worst <= GRAD_TOL,
          f"gradient check: worst relative L2 {worst} > {GRAD_TOL}")
    out = {"model": cfg.name, "layers": cfg.n_layers, "seq": GRAD_SEQ,
           "dtype": "float32", "loss_kernels": loss_k, "loss_plain": loss_p,
           "leaves": len(rels), "worst_rel_l2": worst,
           "median_rel_l2": statistics.median(rels), "tol": GRAD_TOL,
           "bit_identical_rerun": equal_rerun, **launches}
    emit("train_grad_check", **out)
    del params, grads_k, grads_p
    free_card()
    return out


def _host_memory() -> dict:
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                info[key] = int(value.split()[0]) * 1024
    return info


class _NoPlain:
    """Within it, a call of a kernel's plain version (flash attention's and
    the SSD chunk's, forward and backward) fails: on the card every
    gradient path must run the kernels."""

    PLAIN = (("flash_attention", "flash_attention_torch"),
             ("flash_attention_bwd", "flash_attention_bwd_torch"),
             ("ssd_scan", "ssd_chunk_torch"),
             ("ssd_scan_bwd", "ssd_chunk_bwd_torch"))

    def __enter__(self):
        import importlib

        def refuse(*a, **k):
            raise SmokeError("a kernel's plain version ran on the training path")

        self.saved = []
        for module, name in self.PLAIN:
            mod = importlib.import_module(f"repro_torch.kernels.{module}")
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, refuse)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


GEMM_KEYS = ("gemm", "xmma", "cutlass", "nvjet", "cublas")
#: device-kernel classes of a profiled step, by name: the kernels' own
#: names (the backward kernels live in the namespaces ``fa_bwd`` and
#: ``ssd_bwd``: their bare names would also match PyTorch's
#: ``at::native::reduce_kernel``) and the kernels each launch makes
KERNEL_CLASSES = (
    ("flash_fwd", ("flash_wgmma_kernel", "flash_tf32_kernel"), 1),
    ("flash_bwd", ("fa_bwd::",), 4),  # delta, dk/dv, dq, the group's reduce
    ("ssd_fwd", ("ssd_chunk_kernel",), 1),
    ("ssd_bwd", ("ssd_bwd::",), SSD_BWD_KERNELS_PER_CALL),
)


def _split_device_ms(events) -> dict:
    """Device ms of a profiled window by kernel class: GEMMs, the flash
    forward and backward kernels, the SSD chunk's forward and backward,
    everything else (and its largest kernels by name)."""
    split = {"gemm": 0.0, **{c: 0.0 for c, _, _ in KERNEL_CLASSES}, "other": 0.0}
    counts = dict.fromkeys(split, 0)
    others = []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = next((c for c, keys, _ in KERNEL_CLASSES
                    if any(k in e.key for k in keys)), None)
        if cls is None:
            name = e.key.lower()
            cls = "gemm" if any(k in name for k in GEMM_KEYS) else "other"
        split[cls] += e.self_device_time_total / 1e3
        counts[cls] += e.count
        if cls == "other":
            others.append((e.self_device_time_total / 1e3, e.count, e.key[:90]))
    top = [{"ms": ms, "count": n, "name": name}
           for ms, n, name in sorted(others, reverse=True)[:8]]
    return {"ms": split, "kernels": counts, "total_ms": sum(split.values()),
            "top_other": top}


def phase_training(dev, seed: int, model: str = TRAIN_MODEL,
                   steps: int = TRAIN_STEPS, n_periods=None) -> dict:
    """``model`` at full width (its body cut to ``n_periods`` periods when
    given): ``steps`` AdamW steps of TRAIN_BATCH sequences of TRAIN_SEQ
    tokens in TRAIN_MICROBATCHES microbatches, remat "full", f32 masters,
    bf16 compute, through ``make_train_step``, inside :class:`_NoPlain`.
    Gates: finite losses and grad norms, the last loss below the first,
    the path's forward kernel launched twice a body layer and once a
    prelude or postlude layer each microbatch (remat recomputes the
    body), its backward kernel once a layer.  Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch import make_train_step
    from repro_torch.models import ShapeConfig
    from repro_torch.models.layers import chunked_ce_loss
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg = get_config(model)
    if n_periods is not None:
        cfg = replace(cfg, n_periods=n_periods)
    params = _draw_train_params(cfg, seed, dev)
    opt = adamw_init(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    (fwd, bwd), names = _kernel_pair(cfg)
    body, rest = _path_layers(cfg)
    want = ((2 * body + rest) * TRAIN_MICROBATCHES, (body + rest) * TRAIN_MICROBATCHES)
    shape = ShapeConfig(name="train_4k_cut", kind="train", seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH, microbatches=TRAIN_MICROBATCHES,
                        q_chunk=512, kv_chunk=1024, loss_chunk=512, remat="full")
    step_fn = make_train_step(cfg, shape, AdamWConfig(lr=TRAIN_LR, weight_decay=0.0),
                              device=dev)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    torch.cuda.synchronize()
    emit("train_setup", model=cfg.name, layers=cfg.n_layers, params=n_params,
         state_bytes=12 * n_params, seq=TRAIN_SEQ, batch=TRAIN_BATCH,
         microbatches=TRAIN_MICROBATCHES, remat=shape.remat, lr=TRAIN_LR,
         steps=steps, setup_s=time.perf_counter() - t0,
         allocated_bytes=torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    losses, norms, per_step, step_ms = [], [], [], []
    with _NoPlain():
        fwd.launches = bwd.launches = 0  # the training path starts here
        for step in range(steps):
            before = (fwd.launches, bwd.launches)
            t = time.perf_counter()
            params, opt, m = step_fn(params, opt, make_batch(pipe, step))
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            dt = time.perf_counter() - t
            losses.append(loss)
            norms.append(gnorm)
            step_ms.append(dt * 1e3)
            per_step.append((fwd.launches - before[0], bwd.launches - before[1]))
            emit("train_step", model=cfg.name, step=step + 1, loss=loss,
                 grad_norm=gnorm, step_ms=dt * 1e3, tokens=int(m["tokens"]),
                 tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / dt,
                 **{f"{names[0]}_launches": per_step[-1][0],
                    f"{names[1]}_launches": per_step[-1][1]})
        launches = {names[0]: fwd.launches, names[1]: bwd.launches}
        peak = torch.cuda.max_memory_allocated()
        check(all(math.isfinite(x) for x in losses + norms),
              f"training {cfg.name}: non-finite loss or grad norm {losses} {norms}")
        check(losses[-1] < losses[0], f"training {cfg.name}: last loss "
              f"{losses[-1]} not below the first {losses[0]}")
        check(all(s == want for s in per_step),
              f"training {cfg.name}: launches a step {per_step}, want {want} "
              "(forward and remat recompute; backward)")
        # one more step under the profiler: device ms by kernel class, each
        # kernel class's records held to the wrappers' launches
        before = (fwd.launches, bwd.launches)
        events, lost = traced(lambda: step_fn(params, opt, make_batch(pipe, steps)),
                              host=False)
        traced_launches = (fwd.launches - before[0], bwd.launches - before[1])
    split = _split_device_ms(events)
    per_call = {c: n for c, _, n in KERNEL_CLASSES}
    fwd_cls, bwd_cls = (("ssd_fwd", "ssd_bwd") if cfg.ssm is not None
                        else ("flash_fwd", "flash_bwd"))
    check(traced_launches == per_step[0]
          and split["kernels"][fwd_cls] == traced_launches[0] * per_call[fwd_cls]
          and split["kernels"][bwd_cls] == traced_launches[1] * per_call[bwd_cls],
          f"the profiled step's kernel records {split['kernels']} do not "
          f"match its launches {traced_launches} (forward; backward, "
          f"{per_call[bwd_cls]} kernels each)")
    # AdamW over the whole state, and the loss of one microbatch, alone
    grads = tree_map(torch.zeros_like, params)
    adamw_ms = time_ms(lambda: adamw_update(params, grads, opt,
                                            AdamWConfig(lr=0.0, weight_decay=0.0)),
                       reps=3, warmup=1)
    del grads
    h = torch.randn(TRAIN_BATCH // TRAIN_MICROBATCHES, TRAIN_SEQ, cfg.d_model,
                    device=dev, dtype=torch.bfloat16, requires_grad=True)
    unembed = params["unembed"].to(torch.bfloat16).requires_grad_()
    labels = torch.from_numpy(make_batch(pipe, 0)["labels"][:1]).to(dev)
    loss_ms = time_ms(lambda: chunked_ce_loss(h, unembed, labels, t_chunk=512,
                                              logit_softcap=cfg.final_softcap)[0]
                      .backward(), reps=3, warmup=1)
    out = {"model": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "losses": losses, "grad_norms": norms, "step_ms": step_ms,
           "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3) for ms in step_ms],
           "launches": launches,
           "launches_per_step": {names[0]: per_step[0][0], names[1]: per_step[0][1]},
           "launches_each_step": per_step,
           "peak_allocated_bytes": peak, "profiled_step": split,
           "profile_lost": lost, "adamw_ms": adamw_ms,
           "loss_fwd_bwd_ms_per_microbatch": loss_ms}
    emit("train_run", **out)
    del params, opt, step_fn, h, unembed
    free_card()
    return out


def measure_flash_bwd(q, k, v, do, kw) -> dict:
    """The backward kernel at a training shape: its route, event-timed
    ms (with the wrapper's host time) and device ms (in all and by
    kernel), beside the plain version, SDPA's forward and backward
    (``enable_gqa``; a window that masks as an explicit mask; the backend
    SDPA picks), and the bound: 5 products over each (row, key) pair the
    mask keeps (Q·Kᵀ, dS·K and dSᵀ·Q of 2·dqk operations, dO·Vᵀ and Pᵀ·dO
    of 2·dv) at the peak of the inputs' type (bf16/f16 on the tensor
    cores; f32 at the TF32 peak), against q, k, v, o, do and lse read once
    and dq, dk, dv written once; ``bound_as_run_ms`` counts the 7 products
    the kernel runs (its dq pass recomputes Q·Kᵀ and dO·Vᵀ)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.launch.roofline import flash_bwd_as_run_flops, kernel_work

    B, T, H, dh = q.shape
    dv = v.shape[3]
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    bwd = lambda: fb.flash_attention_bwd(q, k, v, o, do, lse, **kw)  # noqa: E731
    kernel_ms = time_ms(bwd)
    dev_ms, per_call, names, lost = device_profile(bwd)
    fwd_bwd_ms = time_ms(lambda: (fa.flash_attention(q, k, v, return_lse=True, **kw),
                                  bwd()))
    plain_ms = time_ms(lambda: fb.flash_attention_bwd_torch(
        q, k, v, o, do, lse, **kw), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    dot = do.transpose(1, 2)

    window = kw.get("window")
    mask = (fa.live_mask(T, T, kw["causal"], window, q.device)
            if window is not None and window < T else None)
    causal = kw["causal"] and mask is None

    def sdpa_fwd():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal, scale=kw.get("scale"),
            enable_gqa=True)

    def sdpa():
        return torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    library_ms = library_device = library_fwd_ms = backend = None
    try:
        sdpa()
    except RuntimeError as exc:  # a yardstick only: record the refusal
        emit("flash_bwd_library_refused", error=str(exc)[:160])
    else:
        library_ms, library_device = time_ms(sdpa), device_ms(sdpa)
        with torch.no_grad():
            library_fwd_ms = time_ms(sdpa_fwd)
        backend = sdpa_backend(qt, kt, vt, mask, causal, kw.get("scale"))
    work = kernel_work("flash_attention_bwd", q, k, v, o, do, lse,
                       causal=kw["causal"], window=window)
    flops_as_run = flash_bwd_as_run_flops(q, k, v, causal=kw["causal"], window=window)
    return {
        "shape": {"B": B, "T": T, "H": H, "Kv": k.shape[2], "dh": dh, "dv": dv,
                  "causal": kw["causal"], "window": window, "dtype": str(q.dtype)},
        "kernel_route": fb._plan(q, k, v, o, do),
        "bound_as_run_ms": max(flops_as_run / work.peak * 1e3, work.bytes_ms),
        "kernel_ms": kernel_ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "fwd_bwd_ms": fwd_bwd_ms, "library_ms": library_ms,
        "library_device_ms": library_device, "library_fwd_ms": library_fwd_ms,
        "library_backend": backend,
        "launches_per_call": per_call, "kernels_seen": sorted(names),
        "device_ms_by_kernel": names,
        "window_lost": lost, "bound_ms": work.bound_ms, "bound_by": work.bound_by,
        "peak_flops": work.peak, "flops": work.flops, "flops_as_run": flops_as_run,
        "bytes": work.bytes,
    }


#: the f32 routes' timed shape: qwen2.5-3b's attention (16 heads over 2,
#: dh 128) over 1024 tokens, causal; decode at the qwen decode path's cache
F32_SHAPE = (1, 1024, 16, 2, 128)
F32_DECODE_S, F32_DECODE_LEN = 1088, 1025


def measure_f32_routes(dev, seed: int) -> tuple:
    """The f32 routes at F32_SHAPE: the flash backward
    (:func:`measure_flash_bwd`) and forward (:func:`measure_flash`), each
    beside its bound at the TF32 peak and SDPA's f32 call with the backend
    it picks, and the f32 decode route (:func:`measure_decode`, CUDA cores)
    at one row of length F32_DECODE_LEN in a cache of F32_DECODE_S, beside
    its bytes bound and masked SDPA.  Returns the three records."""
    f32 = torch.float32
    g = torch.Generator(device=dev).manual_seed(seed + 26)
    fq, fk, fv = flash_inputs(g, dev, *F32_SHAPE, f32)
    bwd = measure_flash_bwd(fq, fk, fv, _randn(g, fq.shape, f32, dev), {"causal": True})
    fwd = measure_flash(fq, fk, fv, {"causal": True})
    B, _, H, Kv, dh = F32_SHAPE
    q = _randn(g, (B, H, dh), f32, dev)
    kc, vc = (_randn(g, (B, F32_DECODE_S, Kv, dh), f32, dev) for _ in range(2))
    lengths = torch.full((B,), F32_DECODE_LEN, dtype=torch.int32, device=dev)
    decode = measure_decode(q, kc, vc, lengths)
    return fwd, bwd, decode


def phase_crash_restore(dev, seed: int, workdir: Path) -> dict:
    """The training loop of ``launch.train`` (``train``) over qwen2.5-3b at full
    width cut to CRASH_LAYERS layers, twice from the same weights: straight
    through CRASH_STEPS steps, and with a checkpoint every CRASH_EVERY steps
    to a PMEM tier and a crash at CRASH_AT that drops the device state,
    restores the newest durable checkpoint and replays from it.  The
    replayed losses must equal the uninterrupted run's, bit for bit.

    Depth is cut because a checkpoint is staged in host memory, serialized
    (a second host copy), hashed and written, and read and hashed again on
    restore: at 36 layers that is 40.8 GB a checkpoint (f32 parameters and
    both moments), several times this phase's share of the time limit."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import ShapeConfig, model_defs
    from repro_torch.models.param import tree_map_defs
    from repro_torch.optim import AdamWConfig
    from repro_torch.storage import CheckpointManager, PmemTier
    from repro_torch.tree import tree_leaves

    full = get_config(TRAIN_MODEL)
    full_params = sum(math.prod(pd.shape) for pd in tree_leaves(
        tree_map_defs(lambda pd: pd, model_defs(full))))
    cfg = replace(full, n_periods=CRASH_LAYERS)
    shape = ShapeConfig(name="crash", kind="train", seq_len=CRASH_SEQ,
                        global_batch=1, microbatches=1, loss_chunk=512,
                        remat="full")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.0)
    emit("crash_setup", model=cfg.name, layers=cfg.n_layers, seq=CRASH_SEQ,
         host_memory=_host_memory(), full_depth_state_bytes=12 * full_params,
         disk_free_bytes=shutil.disk_usage(workdir).free)
    runs = {}
    for name, fail_at, every in (("clean", None, 10 ** 9),
                                 ("crash", CRASH_AT, CRASH_EVERY)):
        params = draw_params(cfg, seed, dev)
        _to_f32_in_place(params, dev)
        ckpt = CheckpointManager(PmemTier(str(workdir / name)), f"train/{cfg.name}",
                                 keep=1)
        t0 = time.perf_counter()
        try:
            out = train(cfg, shape, opt_cfg, ckpt, steps=CRASH_STEPS,
                        checkpoint_every=every, fail_at=fail_at, device=dev,
                        params=params, log=lambda s: None)
        finally:
            ckpt.close()
        runs[name] = {"history": out["history"], "saves": out["saves"],
                      "restores": out["restores"], "s": time.perf_counter() - t0}
        del out, params
        free_card()
    clean = [(h["step"], h["loss"]) for h in runs["clean"]["history"]]
    crash = [(h["step"], h["loss"]) for h in runs["crash"]["history"]]
    replay = crash[CRASH_AT:]
    check([s for s, _ in crash] == [1, 2, 3, 3],
          f"crash run stepped {[s for s, _ in crash]}")
    check(crash[:CRASH_AT] == clean[:CRASH_AT] and replay == clean[CRASH_EVERY:],
          f"replayed losses {replay} differ from the uninterrupted run's "
          f"{clean[CRASH_EVERY:]}")
    saves = runs["crash"]["saves"]
    out = {"layers": CRASH_LAYERS, "clean_losses": [x for _, x in clean],
           "replayed_losses": [x for _, x in replay], "equal": True,
           "restored_from_step": runs["crash"]["restores"][0]["step"],
           "checkpoint_bytes": saves[0].nbytes,
           "staging_ms": [s.wall_time * 1e3 for s in saves],
           "drain_s": [s.drain_time for s in saves],
           "restore_s": runs["crash"]["restores"][0]["restore_s"],
           "run_s": {k: v["s"] for k, v in runs.items()}}
    emit("crash_restore", **out)
    return out


# -- training the recurrent mixers: the SSD backward, Mamba-2, RG-LRU --------

class SSDBwdRecord:
    """Checks of the SSD backward kernel: its largest relative L2 and
    absolute errors against the plain version, and the cases checked."""

    def __init__(self) -> None:
        self.max_rel_l2 = 0.0
        self.max_abs_err = 0.0
        self.checks = 0


def ssd_bwd_inputs(g, dev, BC, Q, H, P, N, G=1, strong=False):
    """x, dt, dA_cs, B and C by group (BC, Q, G, N), dy, dS; dA_cs the
    within-chunk cumulative sum of dt * A with A in [-0.5, -0.05] per
    head, or with ``strong`` dt 0.7 and A -1 (mamba2-2.7b's own init)."""
    x = torch.randn(BC, Q, H, P, generator=g, device=dev)
    dt = torch.rand(BC, Q, H, generator=g, device=dev)
    A = -(torch.rand(H, generator=g, device=dev) * 0.45 + 0.05)
    if strong:
        dt.fill_(0.7)
        A.fill_(-1.0)
    dA = torch.cumsum(dt * A, 1)
    Bm = torch.randn(BC, Q, G, N, generator=g, device=dev)
    Cm = torch.randn(BC, Q, G, N, generator=g, device=dev)
    dy = torch.randn(BC, Q, H, P, generator=g, device=dev)
    dS = torch.randn(BC, H, P, N, generator=g, device=dev)
    return x, dt, dA, Bm, Cm, dy, dS


def ssd_bwd_case(rec: SSDBwdRecord, case: str, args) -> None:
    """The backward kernel against its plain version on ``args``, per
    gradient by relative L2, each call made twice for the same bits."""
    from repro_torch.kernels import ssd_scan_bwd as sb

    got = sb.ssd_chunk_bwd(*args)
    again = sb.ssd_chunk_bwd(*args)
    want = sb.ssd_chunk_bwd_torch(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"ssd_chunk_bwd {case}: two calls on the same inputs differ")
    rels, abss = {}, {}
    for name, g_, w in zip(("dx", "ddt", "ddA_cs", "dB", "dC"), got, want):
        check(g_.shape == w.shape and g_.dtype == torch.float32
              and bool(torch.isfinite(g_).all()),
              f"ssd_chunk_bwd {case}: {name} {g_.dtype} {tuple(g_.shape)}, "
              "or non-finite")
        rels[name] = _rel_l2(g_, w)
        abss[name] = float((g_ - w).abs().max()) if w.numel() else 0.0
        check(rels[name] <= SSD_BWD_TOL,
              f"ssd_chunk_bwd {case}: {name} relative L2 {rels[name]}")
    rec.max_rel_l2 = max(rec.max_rel_l2, *rels.values())
    rec.max_abs_err = max(rec.max_abs_err, *abss.values())
    rec.checks += 1
    x, Bm = args[0], args[3]
    emit("ssd_bwd_case", case=case, shape=list(x.shape), groups=Bm.shape[2],
         N=Bm.shape[3], rel_l2=rels, max_abs_err=abss, tol=SSD_BWD_TOL,
         bit_identical_rerun=True, finite=True, ok=True)


def phase_ssd_backward(dev, seed: int, rec: SSDBwdRecord):
    """The SSD backward kernel against its plain version on the card;
    returns the training shape's inputs."""
    g = torch.Generator(device=dev).manual_seed(seed + 22)
    train = ssd_bwd_inputs(g, dev, *SSD_TRAIN_SHAPE)
    ssd_bwd_case(rec, "train_shape", train)
    ssd_bwd_case(rec, "ragged_Q100", ssd_bwd_inputs(g, dev, 4, 100, 80, 64, 128))
    ssd_bwd_case(rec, "per_head_BC_H8", ssd_bwd_inputs(g, dev, 4, 256, 8, 64, 128, G=8))
    ssd_bwd_case(rec, "P16_N16", ssd_bwd_inputs(g, dev, 4, 200, 8, 16, 16))
    # dt 0.7, A -1 over 256 rows: above the diagonal exp would overflow
    strong = ssd_bwd_inputs(g, dev, 2, 256, 8, 64, 128, strong=True)
    da = strong[2]
    check(bool(torch.isinf(torch.exp(da[:, :, None] - da[:, None])).any()),
          "the strong-decay case does not overflow exp")
    ssd_bwd_case(rec, "strong_decay", strong)
    return train


def measure_ssd_bwd(x, dt, dA_cs, Bm, Cm, dy, dS) -> dict:
    """The backward kernel at the training shape: event-timed ms (with the
    wrapper's host time), device ms (in all and by kernel), the plain
    version's ms (not a yardstick) and the bound: the larger of the bytes
    (every input read once, every gradient written once) over the memory
    rate and the operations (per head dW, W^T.Y, B.dS^T and x.dS; per
    group C.B^T, dC and dB's dG^T.C) over the TF32 peak.  No single
    PyTorch call computes it."""
    from repro_torch.kernels import ssd_scan_bwd as sb
    from repro_torch.launch.roofline import kernel_work

    BC, Q, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    args = (x, dt, dA_cs, Bm, Cm, dy, dS)
    bwd = lambda: sb.ssd_chunk_bwd(*args)  # noqa: E731
    kernel_ms = time_ms(bwd)
    dev_ms, per_call, names, lost = device_profile(bwd)
    check(per_call == SSD_BWD_KERNELS_PER_CALL
          and all("ssd_bwd::" in n for n in names),
          f"ssd_chunk_bwd made {per_call} launches a call, of {names}")
    plain_ms = time_ms(lambda: sb.ssd_chunk_bwd_torch(*args), reps=3, warmup=1)
    # the kernel's scratch: C.B^T and dG, one (Qp, Qp) each per chunk and
    # group, none per head
    call = sb._prepare(*args)
    check(call.scratch[:2] == (BC, G),
          f"ssd_chunk_bwd scratch {call.scratch} is not per group")
    scratch_bytes = 4 * (2 * math.prod(call.scratch) + math.prod(call.sums))
    work = kernel_work("ssd_chunk_bwd", *args)
    return {
        "shape": {"BC": BC, "Q": Q, "H": H, "P": P, "N": N, "G": G,
                  "dtype": "float32"},
        "kernel_route": "3xTF32 on mma.sync, 3 launches (C.B^T and dG per "
                        "group; per head; dB and dC per group)",
        "scratch_shape": list(call.scratch), "sums_shape": list(call.sums),
        "scratch_bytes": scratch_bytes,
        "kernel_ms": kernel_ms, "device_ms": dev_ms, "device_ms_by_kernel": names,
        "launches_per_call": per_call, "window_lost": lost, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": work.bound_ms, "bound_by": work.bound_by,
        "ops_bound_ms": work.ops_ms, "bytes_bound_ms": work.bytes_ms,
        "flops": work.flops, "bytes": work.bytes,
    }


class _PlainSSD(torch.autograd.Function):
    """The SSD chunk step through the plain versions of both kernels, for
    the whole-model gradient check (B and C by group)."""

    @staticmethod
    def forward(ctx, x, dt, dA_cs, Bm, Cm):
        from repro_torch.kernels import ssd_scan
        from repro_torch.kernels.ssd_scan_bwd import head_view

        ctx.save_for_backward(x, dt, dA_cs, Bm, Cm)
        H = x.shape[2]
        return ssd_scan.ssd_chunk_torch(x, dt, dA_cs, head_view(Bm, H),
                                        head_view(Cm, H))

    @staticmethod
    def backward(ctx, dy, dS):
        from repro_torch.kernels import ssd_scan_bwd as sb

        return sb.ssd_chunk_bwd_torch(*ctx.saved_tensors, dy, dS)


# -- training MLA and MoE: the backward at (192, 128), deepseek-v2-lite-16b,
# -- the train_lm example, the serving launcher --------------------------------

MLA_HEAD_DIMS = (192, 128)  # deepseek-v2's q/k (128 "nope" + 64 rotary) and v
MLA_GRAD_PERIODS = 1  # the gradient check: the dense prelude and one MoE period
MLA_TRAIN_PERIODS = 4  # deepseek-v2-lite-16b's 26 MoE periods cut to 4: 2.84 B
MLA_TRAIN_STEPS = 3
EXAMPLE_STEPS = 20
EXAMPLE_BATCH, EXAMPLE_SEQ = 8, 128  # the example's defaults
EXAMPLE_HELD = 3  # batches whose loss is read before and after training
EXAMPLE_CKPT_EVERY = 20  # one checkpoint: each is 1.9 GB of f32 state
LAUNCHER_ARCH = "gemma-2b"  # the serving launcher's default model, at full width
LAUNCHER_BATCH, LAUNCHER_PROMPT, LAUNCHER_TOKENS = 4, 32, 16
SERVE_EXAMPLE_SEED = 31  # the serve_lm example's prompts, drawn on the card


def phase_mla_backward(dev, seed: int, rec: BwdRecord) -> tuple:
    """The backward kernel at MLA's (192, 128), 16 heads over 16 (no GQA),
    scale 1/√192: deepseek-v2-lite-16b's training shape (T 4096, causal,
    bf16), T 1000, T 1, f16, f32 (route ``tf32x3``) and 1000 queries
    over 1536 keys not causal.  Returns the training shape's inputs and
    options."""
    g = torch.Generator(device=dev).manual_seed(seed + 24)
    dqk, dv = MLA_HEAD_DIMS
    scale = 1.0 / math.sqrt(dqk)
    kw = {"causal": True, "scale": scale}

    def inputs(B, T, H, dtype, Tk=None):
        q, k, v = flash_inputs(g, dev, B, T, H, H, dqk, dtype, Tk=Tk, dv=dv)
        return q, k, v, _randn(g, (B, T, H, dv), dtype, dev)

    train = inputs(1, TRAIN_SEQ, 16, torch.bfloat16)
    bwd_case(rec, "mla_train_shape", *train, **kw)
    bwd_case(rec, "mla_ragged_T1000", *inputs(1, 1000, 16, torch.bfloat16), **kw)
    # one row over one key: P = 1, so dS = P (dP - D) is 0 in exact
    # arithmetic and both versions' dq and dk are rounding noise; they are
    # held against the norm of the terms that cancel, scale (do.v) k and
    # scale (do.v) q (H = Kv: each head its own kv head)
    q1, k1, v1, do1 = inputs(1, 1, 16, torch.bfloat16)
    dp = (do1.float() * v1.float()).sum(-1, keepdim=True)
    norms = {"dq": float((scale * dp * k1.float()).norm()),
             "dk": float((scale * dp * q1.float()).norm())}
    bwd_case(rec, "mla_T1", q1, k1, v1, do1, norms=norms, **kw)
    bwd_case(rec, "mla_f16", *inputs(2, 333, 16, torch.float16), **kw)
    bwd_case(rec, "mla_f32_route", *inputs(1, 1024, 16, torch.float32), **kw)
    bwd_case(rec, "mla_tq_lt_tk_full", *inputs(1, 1000, 16, torch.bfloat16, Tk=1536),
             causal=False, scale=scale)
    # q as a view whose head stride (196 elements) TMA cannot take: the
    # backward raises rather than run another way
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb

    q, k, v, do = inputs(1, 64, 16, torch.bfloat16)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    wide = torch.zeros(1, 64, 16, dqk + 4, dtype=q.dtype, device=dev)
    wide[..., :dqk] = q
    try:
        fb.flash_attention_bwd(wide[..., :dqk], k, v, o, do, lse, **kw)
    except ValueError as exc:
        check("TMA" in str(exc), f"MLA backward refused a view for {exc}")
        emit("mla_bwd_tma_refusal", head_stride=dqk + 4, error=str(exc)[:120])
    else:
        raise SmokeError("the MLA backward took a q view whose strides TMA cannot take")
    return train, kw


def phase_moe_determinism(dev, seed: int) -> dict:
    """One MoE layer of deepseek-v2-lite-16b at full width (64 experts
    top-6 and 2 shared, capacity factor 1.25), 4096 tokens, bf16: forward
    and backward twice, the same bits both times; then once under
    ``torch.use_deterministic_algorithms(True)``, where PyTorch raises on
    an operation it knows to be nondeterministic on CUDA (the cuBLAS
    setting it asks for, ``CUBLAS_WORKSPACE_CONFIG``, is set for that call
    only).  Prints how far that call's results lie from the first."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, moe
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(MLA_MODEL)
    g = torch.Generator(device=dev).manual_seed(seed + 25)
    p0 = init_params(moe.moe_defs(cfg), g, dev)
    x0 = _randn(g, (1, TRAIN_SEQ, cfg.d_model), torch.bfloat16, dev)
    dy = _randn(g, (1, TRAIN_SEQ, cfg.d_model), torch.bfloat16, dev)

    def run():
        p = tree_map(lambda t: t.detach().requires_grad_(), p0)
        x = x0.detach().requires_grad_()
        out, aux = moe.moe_apply(p, x, cfg)
        torch.autograd.backward((out, aux), (dy, torch.ones_like(aux)))
        torch.cuda.synchronize()
        return [out.detach(), aux.detach(), x.grad] + [t.grad for t in tree_leaves(p)]

    first, second = run(), run()
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "MoE layer: two forward and backward passes differ")
    check(all(bool(torch.isfinite(t.float()).all()) for t in first),
          "MoE layer: a non-finite output or gradient")
    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        flagged = run()
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    out = {"model": cfg.name, "tokens": TRAIN_SEQ, "dtype": "bfloat16",
           "experts": cfg.moe.n_experts, "top_k": cfg.moe.top_k,
           "capacity_factor": cfg.moe.capacity_factor,
           "bit_identical_rerun": True, "deterministic_algorithms": "no error",
           "deterministic_equal": all(torch.equal(a, b) for a, b in zip(first, flagged)),
           "deterministic_max_abs_diff": max(float((a.float() - b.float()).abs().max())
                                             for a, b in zip(first, flagged))}
    emit("moe_determinism", **out)
    del p0, x0, dy, first, second, flagged
    free_card()
    return out


def phase_train_example(dev, workdir: Path) -> dict:
    """``python -m repro_torch.examples.train_lm --hundred-m`` on the card
    for EXAMPLE_STEPS steps, a checkpoint every EXAMPLE_CKPT_EVERY to the
    PMEM tier of its client: losses finite, every checkpoint durable, both
    flash kernels launched.  That the steps learn is read on the same
    batches before and after: the loss of the first EXAMPLE_HELD batches
    (all trained on) at the run's initial weights (drawn here as the
    example draws them; the first must equal the run's first loss) and at
    its trained weights.  Each must fall: a run that updated nothing
    would read them equal.  (Across batches the losses move with the
    data: in 20 steps this config's loss falls by less than the
    step-to-step spread, its gradient norm at init being ~3e6, as the
    reference's own example's is, so the clipped updates are small.)"""
    from repro_torch.data.pipeline import PipelineConfig, make_batch
    from repro_torch.examples import train_lm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.launch.steps import COMPUTE_DTYPE
    from repro_torch.models import forward, init_params, model_defs
    from repro_torch.models.layers import chunked_ce_loss
    from repro_torch.models.transformer import cast_weights

    cfg, shape = train_lm.build(True, EXAMPLE_SEQ, EXAMPLE_BATCH)
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=shape.seq_len,
                          global_batch=shape.global_batch)

    @torch.no_grad()
    def held_losses(params) -> list:
        out = []
        for step in range(EXAMPLE_HELD):
            b = {k: torch.as_tensor(v).to(dev) for k, v in make_batch(pipe, step).items()}
            h, _ = forward(params, cfg, {"tokens": b["tokens"]}, dtype=COMPUTE_DTYPE)
            loss, _ = chunked_ce_loss(h, cast_weights(params["unembed"], COMPUTE_DTYPE),
                                      b["labels"], t_chunk=shape.loss_chunk,
                                      logit_softcap=cfg.final_softcap)
            out.append(float(loss))
        return out

    before = held_losses(init_params(model_defs(cfg),
                                     torch.Generator(device=dev).manual_seed(0), dev,
                                     dtype=torch.float32))
    free_card()
    fa.launches = fb.launches = 0
    t0 = time.perf_counter()
    out = train_lm.main(["--hundred-m", "--steps", str(EXAMPLE_STEPS),
                         "--batch", str(EXAMPLE_BATCH), "--seq", str(EXAMPLE_SEQ),
                         "--ckpt-every", str(EXAMPLE_CKPT_EVERY), "--device", str(dev),
                         "--ckpt-dir", str(workdir)])
    s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "flash_attention_bwd": fb.launches}
    losses = out["losses"]
    after = held_losses(out.pop("params"))
    free_card()
    want_ckpts = list(range(EXAMPLE_CKPT_EVERY, EXAMPLE_STEPS + 1, EXAMPLE_CKPT_EVERY))
    check(all(math.isfinite(x) for x in losses + out["grad_norms"] + before + after),
          f"train_lm example: losses {losses[0]} ... {losses[-1]}")
    check(abs(before[0] - losses[0]) <= 1e-3 * abs(losses[0]),
          f"train_lm example: batch 0 at the initial weights {before[0]}, "
          f"the run's first loss {losses[0]}")
    check(all(a < b for a, b in zip(after, before)),
          f"train_lm example: held batches' losses {before} before, {after} after")
    check(out["checkpoints"] == want_ckpts,
          f"train_lm example: durable checkpoints {out['checkpoints']}, want {want_ckpts}")
    check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
          f"train_lm example: launches {launches}")
    res = {"steps": EXAMPLE_STEPS, "first_loss": losses[0], "last_loss": losses[-1],
           "held_before": before, "held_after": after,
           "grad_norm_first": out["grad_norms"][0],
           "checkpoints": out["checkpoints"], "tokens_per_s": out["tokens_per_s"],
           **launches, "s": s}
    emit("train_example", **res)
    return res


def phase_serve_launcher(dev) -> dict:
    """``python -m repro_torch.launch.serve --full --arch gemma-2b`` on the
    card: LAUNCHER_BATCH prompts of LAUNCHER_PROMPT tokens, LAUNCHER_TOKENS
    greedy tokens each.  The tokens lie in the vocabulary; flash launched
    once a layer (the prefill), decode once a layer a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    cfg = get_config(LAUNCHER_ARCH)
    fa.launches = da.launches = 0
    out = serve.main(["--full", "--arch", LAUNCHER_ARCH, "--batch", str(LAUNCHER_BATCH),
                      "--prompt-len", str(LAUNCHER_PROMPT), "--tokens",
                      str(LAUNCHER_TOKENS), "--device", "cuda"])
    tokens = out["tokens"]
    check(tokens.shape == (LAUNCHER_BATCH, LAUNCHER_TOKENS)
          and 0 <= tokens.min() and tokens.max() < cfg.vocab,
          f"serve launcher: tokens {tokens.shape}")
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (LAUNCHER_TOKENS - 1)}
    got = {"flash_attention": fa.launches, "decode_attention": da.launches}
    check(got == want, f"serve launcher: launches {got}, want {want}")
    res = {"arch": cfg.name, "layers": cfg.n_layers, "batch": LAUNCHER_BATCH,
           "prompt_len": LAUNCHER_PROMPT, "tokens": LAUNCHER_TOKENS,
           "prefill_ms": out["prefill_s"] * 1e3, "decode_ms": out["decode_s"] * 1e3,
           "decode_tokens_per_s": (LAUNCHER_TOKENS - 1) * LAUNCHER_BATCH
           / out["decode_s"], "first_tokens": tokens[0, :8].tolist(), **got}
    emit("serve_launcher", **res)
    free_card()
    return res


def dbrx_path_shapes(dev, seed: int, cfg, prompt_len: int, steps: int) -> tuple:
    """Flash and decode timed at phase 13's shapes (dbrx-132b: 48 heads
    over 8 of 128; a prompt of ``prompt_len``, then a cache of ``prompt_len
    + steps`` rows at length ``prompt_len + 1``), on seeded inputs."""
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    H, Kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = flash_inputs(g, dev, 1, prompt_len, H, Kv, dh, torch.bfloat16)
    flash = measure_flash(q, k, v, {"causal": True})
    S = prompt_len + steps
    dq = _randn(g, (1, H, dh), torch.bfloat16, dev)
    kc = _randn(g, (1, S, Kv, dh), torch.bfloat16, dev)
    vc = _randn(g, (1, S, Kv, dh), torch.bfloat16, dev)
    lengths = torch.tensor([prompt_len + 1], dtype=torch.int32, device=dev)
    decode = measure_decode(dq, kc, vc, lengths)
    emit("flash_dbrx_path_shape", **flash)
    emit("decode_dbrx_path_shape", **decode)
    return flash, decode


def phase_mapreduce_example(dev) -> dict:
    """``python -m repro_torch.examples.mapreduce_device`` on the card at
    the reference's size: the device, host-tier and modeled-S3 paths'
    counts equal (the example holds them so), every token counted, 0
    dropped, ``bucket_histogram`` launched by the device path."""
    from repro_torch.examples import mapreduce_device
    from repro_torch.kernels import bucket_histogram as bh

    bh.launches = 0
    t0 = time.perf_counter()
    out = mapreduce_device.main(["--device", str(dev)])
    s = time.perf_counter() - t0
    launches = bh.launches
    check(out["dropped"] == 0, f"mapreduce example dropped {out['dropped']} pairs")
    check(int(out["counts"].sum()) == 1 << 16,
          f"mapreduce example counted {int(out['counts'].sum())} of {1 << 16} tokens")
    check(launches >= 1, "mapreduce example: bucket_histogram never launched")
    res = {"tokens": 1 << 16, "vocab": len(out["counts"]), "bucket_histogram": launches,
           "shuffled_bytes": out["shuffled_bytes"], "dropped": out["dropped"],
           "device_path_ms": out["device_s"] * 1e3, "host_path_ms": out["host_s"] * 1e3,
           "s3_modeled_ms": out["s3_modeled_s"] * 1e3, "s": s}
    emit("mapreduce_example", **res)
    return res


def phase_serve_example(dev, seed: int, workdir: Path) -> dict:
    """``repro_torch.examples.serve_lm.run`` at qwen2.5-3b's full width in
    bf16 (weights as ``draw_params`` draws them, prompts from a generator
    on the card) over the reference's trace: every token in the
    vocabulary, a conversation for each of the trace's, demotions and
    resumes above 0, every conversation re-adopted after the restart,
    flash launched once a layer for each prefill and decode once a layer
    for each decode step (the restart's included)."""
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_lm
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config(SERVE_MODEL)
    params = draw_params(cfg, seed, dev)
    _, convs = serve_lm.conversations()
    g = torch.Generator(device=dev).manual_seed(seed + SERVE_EXAMPLE_SEED)
    prompts = {c: torch.randint(0, cfg.vocab, (1, serve_lm.PROMPT_LEN), generator=g,
                                device=dev, dtype=torch.int32) for c in convs}
    torch.cuda.synchronize()
    fa.launches = da.launches = 0
    t0 = time.perf_counter()
    out = serve_lm.run(cfg, params, prompts, dev, label=f"{cfg.name} at full width",
                       workdir=workdir)
    s = time.perf_counter() - t0
    launches = {"flash_attention": fa.launches, "decode_attention": da.launches}
    del params
    tokens = [x for v in out["tokens"].values() for x in v] + out["next_token"]
    total = len(tokens) - len(out["next_token"])
    stats = out["stats"]
    check(all(0 <= x < cfg.vocab for x in tokens), "serve example: token out of vocabulary")
    check(out["conversations"] == len(convs),
          f"serve example: {out['conversations']} conversations, the trace has {len(convs)}")
    check(stats["demotions"] > 0 and stats["resumes"] > 0,
          f"serve example: no demotion or resume: {stats}")
    check(out["adopted"] == out["conversations"],
          f"serve example: {out['adopted']} of {out['conversations']} sessions re-adopted")
    prefills = out["conversations"]
    steps = total + 1  # a start prefills, then decodes its first token; +1 after the restart
    want = {"flash_attention": cfg.n_layers * prefills,
            "decode_attention": cfg.n_layers * steps}
    check(launches == want, f"serve example: launches {launches}, want {want}")
    res = {"model": cfg.name, "layers": cfg.n_layers, "conversations": prefills,
           "tokens": total, "decode_steps": steps, "serve_s": out["decode_s"],
           "tokens_per_s": out["tokens_per_s"],
           **{k: stats[k] for k in ("resident_sessions", "paged_sessions", "demotions",
                                    "resumes", "demand_faults")},
           "adopted": out["adopted"], **launches, "s": s}
    emit("serve_example", **res)
    return res


def phase_host_examples(workdir: Path) -> dict:
    """``quickstart`` and ``iterative_dataflow`` on the card's host, held
    to their own invariants: every tier's WordCount output the same, the
    S3 quota error raised, every task resumed from the PMEM journal,
    PageRank's pinned and cold outputs identical, TeraSort globally
    sorted."""
    from repro_torch.examples import iterative_dataflow, quickstart

    t0 = time.perf_counter()
    qs = quickstart.main(["--journal-path", str(workdir / "quickstart_journal")])
    qs_s = time.perf_counter() - t0
    outputs = set(qs["outputs"].values())
    check(len(outputs) == 1 and all(outputs),
          f"quickstart: {len(outputs)} different outputs across the tiers")
    check(qs["quota_error"] is not None and "transfer quota" in qs["quota_error"],
          f"quickstart: the S3 quota error was not raised ({qs['quota_error']})")
    check(qs["resumed_tasks"] == qs["tasks"] > 0,
          f"quickstart: resumed {qs['resumed_tasks']} of {qs['tasks']} tasks")
    t0 = time.perf_counter()
    df = iterative_dataflow.main([])
    df_s = time.perf_counter() - t0
    check(df["pagerank_identical"], "iterative_dataflow: outputs identical: False")
    check(df["globally_sorted"], "iterative_dataflow: globally sorted: False")
    res = {"quickstart_tasks": qs["tasks"], "quickstart_resumed": qs["resumed_tasks"],
           "quickstart_s": qs_s, "pagerank_iterations": df["pagerank_iterations"],
           "kmeans_iterations": df["kmeans_iterations"],
           "kmeans_warm_read_frac": df["warm_read_frac"],
           "terasort_tasks": df["terasort_tasks"], "iterative_dataflow_s": df_s}
    emit("host_examples", **res)
    return res


# -- phases 17-18: sharding over torch.distributed at world size 1 ------------

DIST_TOKENS = 1 << 24  # device_histogram through a mesh, Zipf(1.1) keys
DIST_VOCAB = 32000
DIST_MOE_SHAPE = (2, 512)  # (B, T) through one full-width MoE layer
DIST_F32_LIMIT = 2e-4  # the reference's own tolerance for the EP paths
DIST_BF16_LIMIT = 2e-2  # relative L2, bf16 against f32


def phase_distributed(dev, seed: int, card: str) -> dict:
    """NCCL at world size 1, through the port's mesh helpers: a process
    group from a file rendezvous, meshes (1,) over "data" and (1, 1) over
    ("data", "model"); ``device_histogram`` through the (1,) mesh (two
    ``all_to_all_single`` and the gathers, at size 1) against the
    one-device call on the same 2^24 Zipf keys over 32000 buckets, byte
    for byte; ``moe_apply_a2a`` and ``moe_apply_gather`` called on the
    (1, 1) mesh for one deepseek-v2-lite-16b MoE layer at full width (64
    experts top-6, 2 shared, d_model 2048), against ``moe_apply_dense``:
    in f32 within 2e-4 abs and rel, in bf16 within relative L2 2e-2 of the
    dense path in f32 on the same bf16 inputs and weights.  The group is
    destroyed on the way out, also on failure.  With one card no time
    across cards is measured: the times printed are each call's on one."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import device_histogram
    from repro_torch.launch import make_mesh_compat, process_group
    from repro_torch.models import init_params, moe

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as workdir:
        t0 = time.perf_counter()
        with process_group(0, 1, os.path.join(workdir, "rdzv")):
            mesh1 = make_mesh_compat((1,), ("data",))
            mesh2 = make_mesh_compat((1, 1), ("data", "model"))
            emit("dist_init", backend=dist.get_backend(), world=dist.get_world_size(),
                 meshes=[list(mesh1.mesh_dim_names), list(mesh2.mesh_dim_names)],
                 init_s=time.perf_counter() - t0)
            g = torch.Generator(device=dev).manual_seed(seed + 30)
            keys = zipf_tokens(DIST_TOKENS, DIST_VOCAB, g, dev)
            values = torch.ones_like(keys)

            def one():
                return device_histogram(keys, values, 1, vocab=DIST_VOCAB, device=dev)

            def via_mesh():
                return device_histogram(keys, values, vocab=DIST_VOCAB, mesh=mesh1)

            a, b = one(), via_mesh()
            check(b.counts.device == dev and b.counts.dtype == a.counts.dtype
                  and torch.equal(b.counts, a.counts),
                  "device_histogram through a (1,) mesh != the one-device call")
            fields = ("dropped", "shuffled_bytes", "buffer_bytes", "spilled",
                      "spilled_bytes")
            check(all(int(getattr(a, f)) == int(getattr(b, f)) for f in fields),
                  "device_histogram through a mesh: another accounting")
            out["histogram"] = {
                "tokens": DIST_TOKENS, "vocab": DIST_VOCAB, "byte_equal": True,
                "dropped": int(a.dropped), "one_device_ms": time_ms(one, reps=5),
                "mesh_ms": time_ms(via_mesh, reps=5)}
            emit("dist_histogram", **out["histogram"])
            del a, b, keys, values

            cfg = get_config(MLA_MODEL)
            B, T = DIST_MOE_SHAPE
            p32 = init_params(moe.moe_defs(cfg), g, dev, dtype=torch.float32)
            x32 = _randn(g, (B, T, cfg.d_model), torch.float32, dev)
            paths = {"a2a": moe.moe_apply_a2a, "gather": moe.moe_apply_gather}
            moe_out = {}
            with torch.no_grad():
                for dtype in (torch.float32, torch.bfloat16):
                    p = _cast_moe(p32, dtype)
                    x = x32.to(dtype)
                    # the dense path in f32 on the inputs as given
                    want, want_aux = moe.moe_apply_dense(_cast_moe(p, torch.float32),
                                                         x.float(), cfg)
                    for name, fn in paths.items():
                        def call(fn=fn, p=p, x=x):
                            return fn(p, x, cfg, mesh2, ("data",), "model")

                        got, aux = call()
                        err = float((got.float() - want).abs().max())
                        rel = _rel_l2(got, want)
                        if dtype == torch.float32:
                            ok = bool(torch.allclose(got, want, atol=DIST_F32_LIMIT,
                                                     rtol=DIST_F32_LIMIT))
                            limit = {"atol": DIST_F32_LIMIT, "rtol": DIST_F32_LIMIT}
                        else:
                            ok = rel <= DIST_BF16_LIMIT
                            limit = {"rel_l2": DIST_BF16_LIMIT}
                        check(ok and bool(torch.isfinite(got.float()).all()),
                              f"moe_apply_{name} ({dtype}) departs from the dense "
                              f"path: max abs {err}, rel L2 {rel}")
                        check(abs(float(aux) - float(want_aux))
                              <= 1e-5 * abs(float(want_aux)),
                              f"moe_apply_{name} ({dtype}): aux {float(aux)} "
                              f"against {float(want_aux)}")
                        row = {"path": name, "dtype": str(dtype).split(".")[-1],
                               "tokens": B * T, "experts": cfg.moe.n_experts,
                               "top_k": cfg.moe.top_k, "max_abs_err": err,
                               "rel_l2": rel, "limit": limit,
                               "ms": time_ms(call, reps=5),
                               "dense_ms": time_ms(
                                   lambda p=p, x=x: moe.moe_apply_dense(p, x, cfg),
                                   reps=5)}
                        moe_out[f"{name}_{row['dtype']}"] = row
                        emit("dist_moe", **row)
                    del p, x, want
            out["moe"] = moe_out
            del p32, x32
        check(not dist.is_initialized(), "a process group outlived the phase")
    free_card()
    out["s"] = time.perf_counter() - t0
    emit("dist_done", s=out["s"], group_left=False)
    print(card, flush=True)
    print("no multi-GPU time measured", flush=True)
    return out


SHARD_LAYERS = 4  # qwen2.5-3b at full width, its 36 layers cut to 4
SHARD_BATCH = 2  # sequences of TRAIN_SEQ, in SHARD_MICROBATCHES
SHARD_MICROBATCHES = 2
SHARD_STEPS = 3
SHARD_TOL = 1e-6  # relative: losses, grad norms, the parameters' L2
SHARD_LIMIT_S = 40.0  # the phase's own time limit


def phase_sharded_train(dev, seed: int, card: str) -> dict:
    """Phase 18, the sharded train step at world size 1: NCCL through a
    file rendezvous, a (1, 1) mesh over ("data", "model"), qwen2.5-3b at
    full width cut to SHARD_LAYERS layers, SHARD_STEPS steps of
    SHARD_BATCH sequences of TRAIN_SEQ in SHARD_MICROBATCHES, remat
    "full", bf16 compute.  ``make_train_step(mesh=...)`` with ``zero1``
    off and on, and with ``compress_grads``, each from the same drawn
    parameters and batches as ``mesh=None`` (with compression for the
    compressed run): losses and grad norms within SHARD_TOL relative,
    the final parameters within SHARD_TOL relative L2 (whole tree), and
    whether they are the same bits; the flash forward and backward
    launches a step equal to the one-process step's, inside
    :class:`_NoPlain`.  Prints each run's peak memory and seconds.  The
    group is destroyed on the way out, also on failure.  One card: no
    time across cards is measured."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch import make_mesh_compat, make_train_step, process_group
    from repro_torch.models import ShapeConfig
    from repro_torch.optim import AdamWConfig, adamw_init, ef_init
    from repro_torch.parallel.sharding import param_pspecs, shard_tree, unshard_tree
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    cfg = replace(get_config(TRAIN_MODEL), n_periods=SHARD_LAYERS)
    params0 = _draw_train_params(cfg, seed, dev)
    shape = ShapeConfig(name="train_4k_sharded", kind="train", seq_len=TRAIN_SEQ,
                        global_batch=SHARD_BATCH, microbatches=SHARD_MICROBATCHES,
                        q_chunk=512, kv_chunk=1024, loss_chunk=512, remat="full")
    pipe = PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=SHARD_BATCH)
    batches = [make_batch(pipe, s) for s in range(SHARD_STEPS)]
    (fwd, bwd), names = _kernel_pair(cfg)
    body, rest = _path_layers(cfg)
    want_launches = ((2 * body + rest) * SHARD_MICROBATCHES,
                     (body + rest) * SHARD_MICROBATCHES)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.0)

    def run(mesh, zero1: bool, compress: bool):
        params = tree_map(torch.clone, params0)
        specs = None
        if mesh is not None:
            specs = param_pspecs(cfg, mesh)
            params = shard_tree(params, specs, mesh)
        opt = adamw_init(params)
        ef = ef_init(params) if compress else None
        fn = make_train_step(cfg, shape, opt_cfg, compress_grads=compress, device=dev,
                             mesh=mesh, zero1=zero1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, per_step = [], [], []
        t = time.perf_counter()
        for step in range(SHARD_STEPS):
            before = (fwd.launches, bwd.launches)
            out = fn(params, opt, batches[step], *((ef,) if compress else ()))
            params, opt, m = out[:3]
            ef = out[3] if compress else None
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            per_step.append((fwd.launches - before[0], bwd.launches - before[1]))
        row = {"mesh": None if mesh is None else [1, 1], "zero1": zero1,
               "compress_grads": compress, "losses": losses, "grad_norms": norms,
               f"{names[0]}_launches_per_step": [n for n, _ in per_step],
               f"{names[1]}_launches_per_step": [n for _, n in per_step],
               "steps_s": time.perf_counter() - t,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del opt, ef, out, m
        if mesh is not None:
            params = unshard_tree(params, specs, mesh)
        check(all(p == want_launches for p in per_step),
              f"sharded step {row['mesh']}: launches a step {per_step}, want "
              f"{want_launches}")
        return row, params

    out = {"model": cfg.name, "layers": cfg.n_layers, "seq": TRAIN_SEQ,
           "batch": SHARD_BATCH, "microbatches": SHARD_MICROBATCHES,
           "steps": SHARD_STEPS, "dtype": "bfloat16", "tol": SHARD_TOL, "runs": []}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as workdir:
        with process_group(0, 1, os.path.join(workdir, "rdzv")), _NoPlain():
            mesh = make_mesh_compat((1, 1), ("data", "model"))
            fwd.launches = bwd.launches = 0  # the sharded step's path starts here
            base = {False: run(None, False, False), True: run(None, False, True)}
            for zero1, compress in ((False, False), (True, False), (False, True)):
                row, params = run(mesh, zero1, compress)
                want, want_params = base[compress]
                got_p, want_p = tree_leaves(params), tree_leaves(want_params)
                diff = math.sqrt(sum(float((a.double() - b.double()).square().sum())
                                     for a, b in zip(got_p, want_p)))
                norm = math.sqrt(sum(float(b.double().square().sum()) for b in want_p))
                row.update(
                    loss_rel=max(abs(a - b) / abs(b)
                                 for a, b in zip(row["losses"], want["losses"])),
                    grad_norm_rel=max(abs(a - b) / abs(b) for a, b in
                                      zip(row["grad_norms"], want["grad_norms"])),
                    params_rel_l2=diff / norm,
                    bit_equal=(row["losses"] == want["losses"]
                               and row["grad_norms"] == want["grad_norms"]
                               and all(torch.equal(a, b) for a, b in zip(got_p, want_p))),
                    one_process=want)
                del params, got_p, want_p
                emit("sharded_train_run", **row)
                check(all(math.isfinite(x) for x in row["losses"] + row["grad_norms"])
                      and row["loss_rel"] <= SHARD_TOL
                      and row["grad_norm_rel"] <= SHARD_TOL
                      and row["params_rel_l2"] <= SHARD_TOL,
                      f"sharded step (zero1={zero1}, compress={compress}) departs "
                      f"from the one-process step: loss {row['loss_rel']}, grad norm "
                      f"{row['grad_norm_rel']}, parameters {row['params_rel_l2']}")
                out["runs"].append(row)
            out["launches"] = {names[0]: fwd.launches, names[1]: bwd.launches}
            del base, mesh
        check(not dist.is_initialized(), "a process group outlived the phase")
    del params0
    free_card()
    out["s"] = time.perf_counter() - t0
    emit("sharded_train", card=card, **{k: v for k, v in out.items() if k != "runs"},
         bit_equal=[r["bit_equal"] for r in out["runs"]])
    check(out["s"] <= SHARD_LIMIT_S, f"phase 18 took {out['s']} s, over its "
          f"{SHARD_LIMIT_S} s")
    print(card, flush=True)
    print("no multi-GPU time measured", flush=True)
    return out


# -- phase 19: the sharded step of the other mixers at world size 1 ------------

#: (model, body periods, sequence length): mamba2-2.7b at 2 of its 64
#: layers, recurrentgemma-9b at one (R, R, L) period (and its 2 trailing
#: RG-LRU blocks), deepseek-v2-lite-16b at its dense prelude and 1 MoE period
MIXER_SHARD_CONFIGS = ((SSM_MODEL, 2, 4096), (RG_MODEL, 1, 2048), (MLA_MODEL, 1, 2048))
MIXER_SHARD_BATCH = 2  # sequences, in MIXER_SHARD_MICROBATCHES
MIXER_SHARD_MICROBATCHES = 2
MIXER_SHARD_STEPS = 2
MIXER_SHARD_LIMIT_S = 30.0  # the phase's own time limit
MIXER_SHARD_MARGIN = 4 << 30  # free bytes beyond a run's peak to keep a result on the card


def phase_sharded_mixers(dev, seed: int, card: str) -> dict:
    """Phase 19, the sharded train step of the SSM, RG-LRU and MLA/MoE
    configurations at world size 1: NCCL through a file rendezvous, a
    (1, 1) mesh over ("data", "model"), each of MIXER_SHARD_CONFIGS at
    full width, MIXER_SHARD_STEPS steps of MIXER_SHARD_BATCH sequences in
    MIXER_SHARD_MICROBATCHES, remat "full", bf16 compute, from the
    training phases' draw.  ``make_train_step(mesh=...)`` against
    ``mesh=None`` from the same parameters and batches: losses, grad norms
    and the parameters' relative L2, held to the same bits (an axis of one
    rank skips every collective and every cut, so the two steps run the
    same code); the SSD chunk's (Mamba-2) or flash attention's forward
    and backward launches a step, each equal to the one-process step's,
    inside :class:`_NoPlain`.  Prints each run's peak memory and seconds.
    The group is destroyed on the way out, also on failure.  One card: no
    time across cards is measured."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.launch import make_mesh_compat, make_train_step, process_group
    from repro_torch.models import ShapeConfig
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import param_pspecs, shard_tree, unshard_tree
    from repro_torch.tree import tree_leaves, tree_map

    t0 = time.perf_counter()
    opt_cfg = AdamWConfig(lr=TRAIN_LR, weight_decay=0.0)
    out = {"batch": MIXER_SHARD_BATCH, "microbatches": MIXER_SHARD_MICROBATCHES,
           "steps": MIXER_SHARD_STEPS, "dtype": "bfloat16", "models": []}

    def run(cfg, shape, params0, batches, mesh, kernels):
        """The steps from an f32 copy of ``params0`` (dropped once copied) on
        ``mesh`` (None: one process); returns the row and the final
        parameters."""
        fwd, bwd = kernels
        t_run = time.perf_counter()
        params = tree_map(lambda t: t.to(torch.float32, copy=True), params0)
        del params0
        specs = None
        if mesh is not None:
            specs = param_pspecs(cfg, mesh)
            params = shard_tree(params, specs, mesh)
        opt = adamw_init(params)
        fn = make_train_step(cfg, shape, opt_cfg, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, per_step = [], [], []
        t = time.perf_counter()
        for batch in batches:
            before = (fwd.launches, bwd.launches)
            params, opt, m = fn(params, opt, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            per_step.append([fwd.launches - before[0], bwd.launches - before[1]])
        row = {"losses": losses, "grad_norms": norms, "launches_per_step": per_step,
               "steps_s": time.perf_counter() - t,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        del opt, m
        if mesh is not None:
            params = unshard_tree(params, specs, mesh)
        free_card()
        row["run_s"] = time.perf_counter() - t_run
        return row, params

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mixers_") as workdir:
        with process_group(0, 1, os.path.join(workdir, "rdzv")), _NoPlain():
            mesh = make_mesh_compat((1, 1), ("data", "model"))
            for model, periods, seq in MIXER_SHARD_CONFIGS:
                cfg = replace(get_config(model), n_periods=periods)
                shape = ShapeConfig(name="train_sharded_mixers", kind="train",
                                    seq_len=seq, global_batch=MIXER_SHARD_BATCH,
                                    microbatches=MIXER_SHARD_MICROBATCHES,
                                    q_chunk=512, kv_chunk=1024, loss_chunk=512,
                                    remat="full")
                pipe = PipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=MIXER_SHARD_BATCH)
                batches = [make_batch(pipe, s) for s in range(MIXER_SHARD_STEPS)]
                # each run from an f32 copy of the training phases' draw (bf16,
                # drawn again for the second run); the one-process run's result
                # stays on the card where the second run's peak still fits
                # beside it, else it waits on the host (recurrentgemma-9b's
                # period holds 13 GB of f32 masters, and a run adds as much in
                # gradients and twice in moments)
                draw = draw_ssm_params if cfg.ssm is not None else draw_params
                kernels, names = _kernel_pair(cfg)
                t = time.perf_counter()
                want, want_params = run(cfg, shape, draw(cfg, seed, dev), batches,
                                        None, kernels)
                kept = (torch.cuda.mem_get_info(dev)[0]
                        >= want["peak_allocated_bytes"] + MIXER_SHARD_MARGIN)
                if not kept:
                    want_params = tree_map(lambda t: t.cpu(), want_params)
                    free_card()
                row, params = run(cfg, shape, draw(cfg, seed, dev), batches, mesh,
                                  kernels)
                runs_s = time.perf_counter() - t
                t = time.perf_counter()
                same, diff2, norm2 = [], 0.0, 0.0
                for a, b in zip(tree_leaves(params), tree_leaves(want_params)):
                    b = b.to(dev)
                    same.append(torch.equal(a, b))
                    if not same[-1]:
                        diff2 += float((a - b).norm()) ** 2
                    norm2 += float(b.norm()) ** 2
                    del b
                row.update(
                    model=cfg.name, layers=cfg.n_layers, seq=seq, mesh=[1, 1],
                    kernels=list(names),
                    loss_rel=max(abs(a - b) / abs(b)
                                 for a, b in zip(row["losses"], want["losses"])),
                    grad_norm_rel=max(abs(a - b) / abs(b) for a, b in
                                      zip(row["grad_norms"], want["grad_norms"])),
                    params_rel_l2=math.sqrt(diff2 / norm2),
                    bit_equal=(row["losses"] == want["losses"]
                               and row["grad_norms"] == want["grad_norms"]
                               and all(same)),
                    kept_on_card=kept, runs_s=runs_s, compare_s=time.perf_counter() - t,
                    one_process=want)
                del params, want_params
                free_card()
                emit("sharded_mixers_run", **row)
                check(all(math.isfinite(x) for x in row["losses"] + row["grad_norms"]),
                      f"{cfg.name}: the sharded step's losses or grad norms are not finite")
                check(row["bit_equal"], f"{cfg.name}: the (1, 1) mesh step departs from "
                      f"the one-process step: loss {row['loss_rel']}, grad norm "
                      f"{row['grad_norm_rel']}, parameters {row['params_rel_l2']}")
                check(row["launches_per_step"] == want["launches_per_step"]
                      and all(min(n) > 0 for n in row["launches_per_step"]),
                      f"{cfg.name}: {names} launches a step {row['launches_per_step']}, "
                      f"one process {want['launches_per_step']}")
                out["models"].append(row)
            del mesh
        check(not dist.is_initialized(), "a process group outlived the phase")
    out["s"] = time.perf_counter() - t0
    emit("sharded_mixers", card=card, s=out["s"],
         bit_equal=[r["bit_equal"] for r in out["models"]],
         launches_per_step={r["model"]: r["launches_per_step"][0] for r in out["models"]},
         peak_allocated_bytes={r["model"]: r["peak_allocated_bytes"]
                               for r in out["models"]})
    check(out["s"] <= MIXER_SHARD_LIMIT_S, f"phase 19 took {out['s']} s, over its "
          f"{MIXER_SHARD_LIMIT_S} s")
    print(card, flush=True)
    print("no multi-GPU time measured", flush=True)
    return out


def _cast_moe(tree, dtype):
    """``tree`` with every floating leaf but the f32 router cast to ``dtype``."""
    return {k: _cast_moe(v, dtype) if isinstance(v, dict)
            else v if k == "router" else v.to(dtype) for k, v in tree.items()}


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        for v in tree:
            yield from _leaves(v)



# -- phase 20: prefill and decode on a mesh, at world size 1 -------------------

#: (model, body periods (None: all), decode steps); qwen2.5-3b also decodes
#: from its int8 cache
SERVE_SHARD_CONFIGS = ((SERVE_MODEL, None, 16), (SSM_MODEL, 2, 8), (RG_MODEL, 1, 8),
                       (MLA_MODEL, 1, 8))
SERVE_SHARD_PROMPTS = 2  # prompts of SERVE_SHARD_PROMPT tokens
SERVE_SHARD_PROMPT = 1024
SERVE_SHARD_CACHE = 1040  # the cache's rows: the prompt and 16 steps
SERVE_SHARD_LIMIT_S = 25.0  # the phase's own time limit


def _quantized(cache):
    """``cache`` with every attention layer in its int8 form (the KV pager's
    demotion), as ``make_decode_step(quant_cache=True)`` takes it."""
    from repro_torch.models.attention import AttnCache
    from repro_torch.models.quant_cache import quantize_cache

    return {k: [quantize_cache(*c) if isinstance(c, AttnCache) else c for c in v]
            for k, v in cache.items()}


def phase_sharded_serve(dev, seed: int, card: str) -> dict:
    """Phase 20, the serving steps on a mesh at world size 1: NCCL through a
    file rendezvous, a (1, 1) mesh over ("data", "model"), bf16 weights
    drawn as the serving phases draw them.  For each of
    SERVE_SHARD_CONFIGS at full width (depth cut as listed),
    ``make_prefill_step`` over SERVE_SHARD_PROMPTS prompts of
    SERVE_SHARD_PROMPT tokens into SERVE_SHARD_CACHE rows, then greedy
    ``make_decode_step`` steps, with ``mesh=None`` and on the mesh (the
    parameters cut by ``param_pspecs``, the whole leaves at (1, 1)): the
    prefill's logits, every step's logits and tokens and every cache leaf
    held to the same bits (an axis of one rank skips every collective and
    every cut), and the kernels' launches equal (flash or the SSD chunk in
    the prefill, decode a step where the model has attention layers; the
    int8 cache and MLA decode in torch ops).  qwen2.5-3b also decodes from
    its cache quantized to int8 (``quant_cache=True``).  Inside
    :class:`_NoPlain`; prints each run's launches a step, peak memory and
    seconds.  One card: no time across cards is measured."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import (make_decode_step, make_mesh_compat,
                                    make_prefill_step, process_group, steps)
    from repro_torch.models import ShapeConfig
    from repro_torch.parallel.sharding import param_pspecs, shard_tree
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    T, B = SERVE_SHARD_PROMPT, SERVE_SHARD_PROMPTS
    out = {"prompts": B, "prompt": T, "cache_len": SERVE_SHARD_CACHE,
           "dtype": "bfloat16", "runs": []}

    def run(cfg, params, prompts, mesh, quant: bool, n_steps: int):
        prefill = make_prefill_step(cfg, ShapeConfig("p", "prefill", T, B),
                                    cache_len=SERVE_SHARD_CACHE, mesh=mesh)
        decode = make_decode_step(cfg, ShapeConfig("d", "decode", SERVE_SHARD_CACHE, B),
                                  mesh=mesh, quant_cache=quant)
        seen, inner = [], steps.decode_step

        def keeping(*a, **kw):  # the step's logits, kept for the comparison
            lo, c = inner(*a, **kw)
            seen.append(lo)
            return lo, c

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.launches = da.launches = ssd_scan.launches = 0  # this run starts here
        t = time.perf_counter()
        with torch.no_grad():
            logits, cache = prefill(params, {"tokens": prompts})
            pre = {"flash_attention": fa.launches, "ssd_chunk": ssd_scan.launches}
            if quant:
                cache = _quantized(cache)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks = [tok]
            steps.decode_step = keeping
            try:
                for i in range(n_steps):
                    tok, cache = decode(params, tok, cache, T + i)
                    toks.append(tok)
            finally:
                steps.decode_step = inner
        torch.cuda.synchronize()
        row = {"s": time.perf_counter() - t, "prefill_launches": pre,
               "decode_launches_per_step": da.launches / n_steps,
               "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
        return row, [logits] + seen + toks + tree_leaves(cache)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_mesh_") as workdir:
        with process_group(0, 1, os.path.join(workdir, "rdzv")), _NoPlain():
            mesh = make_mesh_compat((1, 1), ("data", "model"))
            for model, periods, n_steps in SERVE_SHARD_CONFIGS:
                cfg = get_config(model)
                if periods is not None:
                    cfg = replace(cfg, n_periods=periods)
                draw = draw_ssm_params if cfg.ssm is not None else draw_params
                params = draw(cfg, seed, dev)
                g = torch.Generator(device=dev).manual_seed(seed + 41)
                prompts = torch.randint(0, cfg.vocab, (B, T), generator=g, device=dev,
                                        dtype=torch.int32)
                sharded = shard_tree(params, param_pspecs(cfg, mesh), mesh)
                for quant in (False, True) if model == SERVE_MODEL else (False,):
                    want, want_out = run(cfg, params, prompts, None, quant, n_steps)
                    row, got = run(cfg, sharded, prompts, mesh, quant, n_steps)
                    same = [torch.equal(a, b) for a, b in zip(got, want_out)]
                    row.update(model=cfg.name, layers=cfg.n_layers, quant_cache=quant,
                               steps=n_steps, mesh=[1, 1], tensors=len(same),
                               bit_equal=len(got) == len(want_out) and all(same),
                               finite=all(bool(torch.isfinite(t.float()).all())
                                          for t in got if t.is_floating_point()),
                               one_process=want)
                    del got, want_out
                    emit("sharded_serve_run", **row)
                    check(row["finite"], f"{cfg.name}: non-finite logits or cache on "
                          "the mesh")
                    check(row["bit_equal"], f"{cfg.name} (int8 {quant}): the (1, 1) mesh's "
                          f"prefill and decode depart from mesh=None in "
                          f"{row['tensors'] - sum(same)} of {row['tensors']} tensors")
                    check(row["prefill_launches"] == want["prefill_launches"]
                          and row["decode_launches_per_step"]
                          == want["decode_launches_per_step"],
                          f"{cfg.name}: launches {row['prefill_launches']}, "
                          f"{row['decode_launches_per_step']} a step; one process "
                          f"{want['prefill_launches']}, {want['decode_launches_per_step']}")
                    kernel = "ssd_chunk" if cfg.ssm is not None else "flash_attention"
                    check(row["prefill_launches"][kernel] > 0,
                          f"{cfg.name}: {kernel} never launched in the prefill")
                    attn = sum(b.mixer in ("attn", "local") for b in cfg.prelude
                               + cfg.postlude) + cfg.n_periods * sum(
                        b.mixer in ("attn", "local") for b in cfg.pattern)
                    check(row["decode_launches_per_step"] == (0 if quant else attn),
                          f"{cfg.name}: decode launched {row['decode_launches_per_step']} "
                          f"times a step, its attention layers {attn}")
                    out["runs"].append(row)
                del params, sharded
                free_card()
            del mesh
        check(not dist.is_initialized(), "a process group outlived the phase")
    out["s"] = time.perf_counter() - t0
    emit("sharded_serve", card=card, s=out["s"],
         bit_equal={f"{r['model']}{'_int8' if r['quant_cache'] else ''}": r["bit_equal"]
                    for r in out["runs"]},
         decode_launches_per_step={
             f"{r['model']}{'_int8' if r['quant_cache'] else ''}":
             r["decode_launches_per_step"] for r in out["runs"]},
         peak_allocated_bytes={
             f"{r['model']}{'_int8' if r['quant_cache'] else ''}":
             r["peak_allocated_bytes"] for r in out["runs"]})
    check(out["s"] <= SERVE_SHARD_LIMIT_S, f"phase 20 took {out['s']} s, over its "
          f"{SERVE_SHARD_LIMIT_S} s")
    return out

# -- phase 21: the dry run and a whole step's roofline ---------------------------

#: the reference's dry-run test cells (``tests/test_dryrun.py``), as the
#: CLI's ``--cell`` takes them, and the reasons of its two skips
DRYRUN_CELLS = ("gemma-2b:decode_32k", "mamba2-2.7b:long_500k",
                "gemma-2b:decode_32k:multi", "hubert-xlarge:decode_32k",
                "qwen2.5-3b:long_500k")
DRYRUN_SKIPS = {("hubert-xlarge", "decode_32k"): "encoder-only: no decode step",
                ("qwen2.5-3b", "long_500k"):
                    "full attention is quadratic at 512k; skipped per brief"}
DRYRUN_LIMIT_S = 30.0  # the phase's own time limit
DRYRUN_MEMORY_BAND = (0.5, 2.0)  # the fake peak over the card's, a sanity band
DRYRUN_STEP_REPS = 3  # timed train steps without the counter


def _counted(fn, launch_modules: dict):
    """``fn()`` once under a ``CostCounter`` on the card: its counts, the
    wrappers' launch-count deltas by kernel, and the card's peak allocated
    bytes less what was allocated before (the step's own), inside
    :class:`_NoPlain`."""
    from repro_torch.launch import CostCounter

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = {k: m.launches for k, m in launch_modules.items()}
    with _NoPlain(), CostCounter() as counter:
        out = fn()
    torch.cuda.synchronize()
    del out
    launched = {k: m.launches - before[k] for k, m in launch_modules.items()}
    return counter.costs, launched, torch.cuda.max_memory_allocated() - base


def _fidelity(name: str, real, launched: dict, real_peak: int, fake, arg_bytes: int,
              real_arg_bytes: int) -> dict:
    """Hold a step's fake trace to its real run on the card: dot FLOPs and
    the kernels' calls, FLOPs and bytes equal, the calls equal to the
    launch counters' deltas, no collective on one card; the fake peak
    (arguments plus its high-water mark) within DRYRUN_MEMORY_BAND of the
    card's (the arguments plus the step's own peak)."""
    launched = {k: n for k, n in launched.items() if n}
    card_peak = real_arg_bytes + real_peak
    fake_peak = arg_bytes + fake.peak_bytes
    row = {"step": name, "dot_flops": real.dot_flops, "fake_dot_flops": fake.dot_flops,
           "kernel_calls": real.kernel_calls, "fake_kernel_calls": fake.kernel_calls,
           "launches": launched, "kernel_flops": real.kernel_flops,
           "kernel_bytes": real.kernel_bytes,
           "collective_bytes": real.total_collective_bytes,
           "fake_collective_bytes": fake.total_collective_bytes,
           "fake_peak_bytes": fake_peak, "card_peak_bytes": card_peak,
           "memory_ratio": fake_peak / card_peak}
    emit("dryrun_fidelity", **row)
    check(fake.dot_flops == real.dot_flops > 0,
          f"{name}: fake trace counts {fake.dot_flops} dot FLOPs, the card's run "
          f"{real.dot_flops}")
    check(fake.kernel_calls == real.kernel_calls == launched and launched,
          f"{name}: kernel calls fake {fake.kernel_calls}, card {real.kernel_calls}, "
          f"launched {launched}")
    check(fake.kernel_flops == real.kernel_flops
          and fake.kernel_bytes == real.kernel_bytes,
          f"{name}: kernel work fake {fake.kernel_flops} {fake.kernel_bytes}, card "
          f"{real.kernel_flops} {real.kernel_bytes}")
    check(real.total_collective_bytes == fake.total_collective_bytes == 0,
          f"{name}: collective bytes on one card")
    lo, hi = DRYRUN_MEMORY_BAND
    check(lo <= row["memory_ratio"] <= hi,
          f"{name}: fake peak {fake_peak} against the card's {card_peak}")
    return row


class DryrunCells:
    """Phase 21 (a), the dry-run CLI in a subprocess on the reference test's
    cells (DRYRUN_CELLS), on fake tensors of ``fake_device`` each traced
    as rank 0 of a fake world of 256 or 512.  Started ahead of the phase:
    a fresh interpreter on the card's host spends most of its run
    importing torch, its compiler stack and sympy with no bytecode cache,
    so it runs beside the sharding phases (17-20, correctness only), and
    the phase reads its records.  :meth:`stop` kills it if it is still running."""

    def __init__(self, fake_device: str) -> None:
        import threading

        self.fake_device = fake_device
        self.workdir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
        self.cells_path = os.path.join(self.workdir, "cells.json")
        self.log_path = os.path.join(self.workdir, "dryrun.log")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
               fake_device, "--out", self.cells_path]
        for cell in DRYRUN_CELLS:
            cmd += ["--cell", cell]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.start = time.perf_counter()
        self.end = None
        with open(self.log_path, "w") as log_file:
            self.proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log_file,
                                         stderr=subprocess.STDOUT)
        self.waiter = threading.Thread(target=self._wait, daemon=True)
        self.waiter.start()

    def _wait(self) -> None:
        self.proc.wait()
        self.end = time.perf_counter()

    def finish(self, timeout: float) -> list:
        """The records, once the CLI exits 0 within ``timeout`` s."""
        self.waiter.join(timeout)
        if self.proc.poll() is None:
            self.stop()
        with open(self.log_path) as f:
            log = f.read()
        check(self.proc.returncode == 0,
              f"dry-run CLI exited {self.proc.returncode}:\n{log[-3000:]}")
        with open(self.cells_path) as f:
            cells = json.load(f)
        shutil.rmtree(self.workdir, ignore_errors=True)
        return cells

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def phase_dryrun(dev, seed: int, card: str, cells_run: DryrunCells) -> dict:
    """Phase 21, the dry run (``launch/dryrun.py``) and the first whole-step
    roofline of the port.  (a) ``cells_run``'s records of the dry-run CLI
    (:class:`DryrunCells`): every runnable cell "ok" on fake tensors of the
    card's type with FLOPs > 0 and collective bytes >= 0, the skips with
    the reference's reasons; each record's terms printed.  (b) Three steps
    run once for real on the card under ``CostCounter`` (an extra run,
    never timed) and once as a fake trace from fake ``cuda`` stand-ins
    (``dryrun.trace``), held together by :func:`_fidelity`: qwen2.5-3b's
    train step at phase 18's size (SHARD_LAYERS layers, SHARD_BATCH x
    TRAIN_SEQ), mamba2-2.7b's prefill at 2 layers (2 x 1024) and one
    qwen2.5-3b decode step at 36 layers over SERVE_SHARD_CACHE rows; (c)
    qwen's step ``Roofline`` from its counts beside the median of
    DRYRUN_STEP_REPS timed steps without the counter.  At most
    DRYRUN_LIMIT_S, the wait for the CLI included."""
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, make_batch
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ssd_scan
    from repro_torch.launch import (dryrun, make_decode_step, make_prefill_step,
                                    make_train_step)
    from repro_torch.launch import roofline as rl
    from repro_torch.models import ShapeConfig, init_cache, init_params, model_defs
    from repro_torch.optim import AdamWConfig, adamw_init

    t0 = time.perf_counter()
    fake_device = dev.type  # "cuda" on the card
    check(cells_run.fake_device == fake_device, "the dry-run cells' device")
    try:
        rows = []
        # (b) qwen2.5-3b's train step at phase 18's size
        cfg = replace(get_config(TRAIN_MODEL), n_periods=SHARD_LAYERS)
        shape = ShapeConfig(name="train_4k_4_layers", kind="train", seq_len=TRAIN_SEQ,
                            global_batch=SHARD_BATCH, microbatches=SHARD_MICROBATCHES,
                            q_chunk=512, kv_chunk=1024, loss_chunk=512, remat="full")
        g = torch.Generator(device=dev).manual_seed(seed + 21)
        params = init_params(model_defs(cfg), g, dev, dtype=torch.float32)
        opt = adamw_init(params)
        batch = make_batch(PipelineConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                          global_batch=SHARD_BATCH), 0)
        step = make_train_step(cfg, shape, AdamWConfig(lr=TRAIN_LR, weight_decay=0.0),
                               device=dev)
        run = lambda: step(params, opt, batch)  # noqa: E731
        run()  # first call: the kernels' per-signature preparation
        real, launched, peak = _counted(run, {"flash_attention": fa,
                                              "flash_attention_bwd": fb})
        parts = {"train_real_s": time.perf_counter() - t0}
        fake, arg_bytes = dryrun.trace(cfg, shape, None, fake_device)
        parts["train_fake_s"] = time.perf_counter() - t0 - sum(parts.values())
        rows.append(_fidelity("qwen2.5-3b_train", real, launched, peak, fake, arg_bytes,
                              dryrun.storage_bytes((params, opt))))
        train_costs = real
        times = []
        for _ in range(DRYRUN_STEP_REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        step_ms = statistics.median(times)
        roof = rl.derive(cfg.name, shape.name, "1", train_costs, 1, cfg, shape,
                         model_flops_global=dryrun.model_flops(cfg, shape),
                         peak_memory_bytes=float(rows[0]["fake_peak_bytes"]))
        bound_ms = max(roof.t_compute, roof.t_memory, roof.t_collective) * 1e3
        roofline = {"card": card, "step": roof.to_dict(), "measured_ms": step_ms,
                    "measured_all_ms": times, "bound_ms": bound_ms,
                    "bound_share": bound_ms / step_ms,
                    "mfu": roof.model_flops / (step_ms / 1e3) / rl.PEAK_FLOPS}
        emit("step_roofline", **roofline)
        del params, opt, step, run
        free_card()
        parts["train_timed_s"] = time.perf_counter() - t0 - sum(parts.values())

        # mamba2-2.7b's prefill at 2 layers
        cfg = replace(get_config(SSM_MODEL), n_periods=2)
        shape = ShapeConfig(name="prefill_2x1024", kind="prefill",
                            seq_len=SERVE_SHARD_PROMPT, global_batch=SERVE_SHARD_PROMPTS)
        params = init_params(model_defs(cfg), g, dev)
        prompts = torch.randint(0, cfg.vocab, (SERVE_SHARD_PROMPTS, SERVE_SHARD_PROMPT),
                                generator=g, device=dev, dtype=torch.int32)
        prefill = make_prefill_step(cfg, shape)
        prefill(params, {"tokens": prompts})
        real, launched, peak = _counted(lambda: prefill(params, {"tokens": prompts}),
                                        {"ssd_chunk": ssd_scan,
                                         "flash_attention": fa})
        fake, arg_bytes = dryrun.trace(cfg, shape, None, fake_device)
        rows.append(_fidelity("mamba2-2.7b_prefill", real, launched, peak, fake,
                              arg_bytes, dryrun.storage_bytes((params, prompts))))
        del params, prefill
        free_card()
        parts["prefill_s"] = time.perf_counter() - t0 - sum(parts.values())

        # one qwen2.5-3b decode step at 36 layers
        cfg = get_config(SERVE_MODEL)
        shape = ShapeConfig(name="decode_1040", kind="decode", seq_len=SERVE_SHARD_CACHE,
                            global_batch=SERVE_SHARD_PROMPTS)
        params = init_params(model_defs(cfg), g, dev)
        cache = init_cache(cfg, SERVE_SHARD_PROMPTS, SERVE_SHARD_CACHE, device=dev)
        tokens = torch.zeros((SERVE_SHARD_PROMPTS, 1), dtype=torch.int32, device=dev)
        decode = make_decode_step(cfg, shape)
        t_last = SERVE_SHARD_CACHE - 1  # the stand-ins' position
        decode(params, tokens, cache, t_last)
        real, launched, peak = _counted(lambda: decode(params, tokens, cache, t_last),
                                        {"decode_attention": da})
        fake, arg_bytes = dryrun.trace(cfg, shape, None, fake_device)
        rows.append(_fidelity("qwen2.5-3b_decode", real, launched, peak, fake,
                              arg_bytes, dryrun.storage_bytes((params, tokens, cache))))
        del params, cache, decode
        free_card()
        parts["decode_s"] = time.perf_counter() - t0 - sum(parts.values())

        # (a) the dry-run cells
        cells = cells_run.finish(max(1.0, DRYRUN_LIMIT_S - (time.perf_counter() - t0)))
        parts["cells_wait_s"] = time.perf_counter() - t0 - sum(parts.values())
    finally:
        cells_run.stop()
    check(len(cells) == len(DRYRUN_CELLS), f"dry run recorded {len(cells)} cells")
    for rec in cells:
        keys = ("arch", "shape", "mesh", "status", "reason", "device", "step", "flops",
                "coll_bytes", "coll_breakdown", "coll_link_bytes", "kernel_calls",
                "t_compute", "t_memory", "t_collective", "bottleneck",
                "useful_flops_frac", "roofline_frac", "peak_memory_bytes", "fits_hbm",
                "memory_analysis", "trace_s")
        emit("dryrun_cell", **{k: rec[k] for k in keys if k in rec})
        want = DRYRUN_SKIPS.get((rec["arch"], rec["shape"]))
        if want is not None:
            check(rec["status"] == "skipped" and rec["reason"] == want,
                  f"dry run {rec['arch']} {rec['shape']}: {rec}")
            continue
        check(rec["status"] == "ok" and rec["device"] == fake_device and rec["flops"] > 0
              and rec["coll_bytes"] >= 0, f"dry run {rec['arch']} {rec['shape']} "
              f"{rec['mesh']}: {rec.get('error', rec['status'])}")
    check(sorted(r["mesh"] for r in cells if r["status"] == "ok")
          == ["16x16", "16x16", "2x16x16"], "dry-run meshes")
    out = {"card": card, "cells": len(cells), "fidelity": rows, "roofline": roofline,
           "s": time.perf_counter() - t0}
    out["cli_s"] = cells_run.end - cells_run.start
    emit("dryrun", card=card, s=out["s"], parts=parts, cli_s=out["cli_s"], memory_ratio={
        r["step"]: r["memory_ratio"] for r in rows})
    check(out["s"] <= DRYRUN_LIMIT_S, f"phase 21 took {out['s']} s, over its "
          f"{DRYRUN_LIMIT_S} s")
    return out


def _card() -> str:
    """Select card 0, print its name and power limit and return them."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    return card


def ptxas_report(logs: dict) -> dict:
    """Print one line per compiled kernel from ``nvcc -Xptxas -v``: its
    registers and spilled bytes (stores + loads); return the spilled bytes
    by (source, kernel)."""
    spills = {}
    for name, log in logs.items():
        kernel = spilled = None
        for line in log.splitlines():
            if "Function properties for" in line:
                kernel = line.split("Function properties for")[-1].strip()
            elif "spill stores" in line and kernel is not None:
                nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
                spilled = nums[1] + nums[2]  # stack frame, stores, loads
                spills[(name, kernel)] = spilled
            elif "Used" in line and "registers" in line and spilled is not None:
                regs = line.split("Used")[1].split("registers")[0].strip()
                print(f"ptxas {name}: {kernel[-70:]}: {regs} registers, "
                      f"{spilled} spill bytes")
                kernel = spilled = None
    return spills


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    card = _card()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    emit("build", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         build_s=build_s, sources=list(_build.SOURCES))
    spills = ptxas_report(_build.build_logs)
    tc_spills = {fn: n for (src, fn), n in spills.items()
                 if src in ("flash_attention", "flash_attention_bwd",
                            "decode_attention", "ssd_scan", "ssd_scan_bwd") and n}
    check(not tc_spills, f"ptxas spills in the attention and SSD kernels: {tc_spills}")
    phase_first_launch_threads(dev, args.seed)

    rec = KernelRecord()
    t0 = time.perf_counter()
    phase_kernel(dev, args.seed, rec, KERNEL_KEYS)
    emit("phase_done", name="kernel", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_shuffle(dev, args.seed, SHUFFLE_TOKENS, STORAGE_TOKENS)
    torch.cuda.empty_cache()
    emit("phase_done", name="shuffle", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches, largest = phase_main_path(
        dev, args.seed, CORPUS_BYTES, TERASORT_RECORDS
    )
    emit("phase_done", name="main_path", s=time.perf_counter() - t0)

    check(launches > 0, "bucket_histogram never launched on the main path")
    shape = hist_at_main_shape(rec, largest)
    emit("kernel_main_path_shape", **shape)

    flash_rec = AttnRecord("flash_attention")
    decode_rec = AttnRecord("decode_attention")
    t0 = time.perf_counter()
    decode_lse = phase_attention_kernels(dev, args.seed, flash_rec, decode_rec,
                                         SERVE_PROMPT, SERVE_PROMPT + SERVE_MAX_TOKENS)
    emit("phase_done", name="attention_kernels", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    from repro_torch.configs import get_config

    serve_cfg = get_config(SERVE_MODEL)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as workdir:
        serve_launches, flash_last, decode_last, params, hot_rate = phase_serving(
            dev, args.seed, serve_cfg, SERVE_PROMPT,
            SERVE_MAX_TOKENS, SERVE_CONVS, INT8_STEPS, LOSSLESS_STEPS,
            Path(workdir),
        )
    emit("phase_done", name="serving", s=time.perf_counter() - t0)
    (fq, fk, fv), fkw = flash_last
    flash_shape = measure_flash(fq, fk, fv, fkw)
    emit("flash_path_shape", **flash_shape)
    (dq, dk, dv, dlen), _ = decode_last
    decode_shape = measure_decode(dq, dk, dv, dlen)
    emit("decode_path_shape", **decode_shape)
    del flash_last, decode_last, fq, fk, fv, dq, dk, dv
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_traced_") as workdir:
        traced_launches = phase_traced_serving(
            dev, args.seed, serve_cfg, params, hot_rate, SERVE_PROMPT,
            SERVE_MAX_TOKENS, Path(workdir),
        )
    del params
    free_card()
    emit("phase_done", name="traced_serving", s=time.perf_counter() - t0)

    ssd_rec = SSDRecord()
    t0 = time.perf_counter()
    phase_ssd_kernel(dev, args.seed, ssd_rec)
    torch.cuda.empty_cache()
    emit("phase_done", name="ssd_kernel", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ssm_") as workdir:
        ssd_launches, ssd_last = phase_ssm_serving(
            dev, args.seed, get_config(SSM_MODEL), SSM_PROMPT, SSM_MAX_TOKENS,
            SSM_CONVS, SSM_STEPS, SSM_LOSSLESS_STEPS, Path(workdir),
        )
    emit("phase_done", name="ssm_serving", s=time.perf_counter() - t0)
    from repro_torch.kernels.ssd_scan_bwd import head_view

    x, dt, da, Bg, Cg = ssd_last[0]  # ops.ssd_chunk takes B and C by group
    ssd_shape = measure_ssd(x, dt, da, head_view(Bg, x.shape[2]),
                            head_view(Cg, x.shape[2]))
    del x, dt, da, Bg, Cg
    emit("ssd_path_shape", **ssd_shape)
    del ssd_last
    free_card()

    # the remaining mixers: RG-LRU (recurrentgemma-9b), MLA and MoE
    # (deepseek-v2-lite-16b), MoE with GQA (dbrx-132b, 2 layers)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rg_") as workdir:
        rg_launches, rg_flash, rg_decode = phase_mixer_serving(
            dev, args.seed, get_config(RG_MODEL), "rg", MIXER_PROMPT,
            MIXER_MAX_TOKENS, MIXER_CONVS, MIXER_STEPS, MIXER_LOSSLESS_STEPS,
            Path(workdir))
    free_card()
    emit("phase_done", name="recurrentgemma_serving", s=time.perf_counter() - t0)
    local_shape = measure_flash(*rg_flash[0], rg_flash[1])
    emit("flash_local_path_shape", **local_shape)
    (dq, dk, dv, dlen), _ = rg_decode
    ring_shape = measure_decode(dq, dk, dv, dlen)
    emit("decode_ring_path_shape", **ring_shape)
    del rg_flash, rg_decode, dq, dk, dv, dlen
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mla_") as workdir:
        mla_launches, mla_flash, _ = phase_mixer_serving(
            dev, args.seed, get_config(MLA_MODEL), "mla", MIXER_PROMPT,
            MIXER_MAX_TOKENS, MIXER_CONVS, MIXER_STEPS, MIXER_LOSSLESS_STEPS,
            Path(workdir))
    free_card()
    emit("phase_done", name="deepseek_serving", s=time.perf_counter() - t0)
    mla_shape = measure_flash(*mla_flash[0], mla_flash[1])
    emit("flash_mla_path_shape", **mla_shape)
    del mla_flash
    t0 = time.perf_counter()
    moe_launches = phase_moe_model(
        dev, args.seed, replace(get_config(MOE_MODEL), n_periods=MOE_LAYERS),
        MIXER_PROMPT, MOE_STEPS)
    dbrx_flash, dbrx_decode = dbrx_path_shapes(
        dev, args.seed, get_config(MOE_MODEL), MIXER_PROMPT, MOE_STEPS)
    free_card()
    emit("phase_done", name="dbrx", s=time.perf_counter() - t0)

    # training: the backward kernel, whole-model gradients, full-width
    # steps, crash and restore
    bwd_rec = BwdRecord()
    t0 = time.perf_counter()
    tq, tk, tv, tdo = phase_flash_backward(dev, args.seed, bwd_rec)
    phase_f32_flash(dev, args.seed, flash_rec, bwd_rec)
    bwd_shape = measure_flash_bwd(tq, tk, tv, tdo, {"causal": True})
    emit("flash_bwd_train_shape", card=card, **bwd_shape)
    check(bwd_shape["kernel_route"] == "wgmma",
          f"the training shape's backward took route {bwd_shape['kernel_route']}")
    flash_train_shape = measure_flash(tq, tk, tv, {"causal": True})
    emit("flash_train_path_shape", **flash_train_shape)
    del tq, tk, tv, tdo
    # the f32 routes (3xTF32) at the f32_route case's shape, and the f32
    # decode route (CUDA cores)
    f32_shape, bwd_f32_shape, decode_f32_shape = measure_f32_routes(dev, args.seed)
    emit("flash_bwd_f32_shape", card=card, **bwd_f32_shape)
    emit("flash_f32_path_shape", card=card, **f32_shape)
    emit("decode_f32_path_shape", card=card, **decode_f32_shape)
    check(bwd_f32_shape["kernel_route"] == f32_shape["kernel_route"] == "tf32x3",
          f"the f32 backward and forward took routes {bwd_f32_shape['kernel_route']} "
          f"and {f32_shape['kernel_route']}")
    free_card()
    emit("phase_done", name="flash_backward", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    grad_out = phase_grad_check(dev, args.seed)  # f32: the tf32x3 routes
    train_out = phase_training(dev, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as workdir:
        phase_crash_restore(dev, args.seed, Path(workdir))
    free_card()
    emit("phase_done", name="training", s=time.perf_counter() - t0)
    train_launches = train_out["launches"]

    # training the recurrent mixers: the SSD backward kernel, mamba2-2.7b's
    # whole-model gradients and full-width steps, recurrentgemma-9b's steps
    ssd_bwd_rec = SSDBwdRecord()
    t0 = time.perf_counter()
    sx, sdt, sda, sB, sC, sdy, sdS = phase_ssd_backward(dev, args.seed, ssd_bwd_rec)
    ssd_bwd_shape = measure_ssd_bwd(sx, sdt, sda, sB, sC, sdy, sdS)
    emit("ssd_bwd_train_shape", card=card, **ssd_bwd_shape)
    H = sx.shape[2]
    ssd_train_shape = measure_ssd(sx, sdt, sda, head_view(sB, H), head_view(sC, H))
    emit("ssd_train_path_shape", **ssd_train_shape)
    del sx, sdt, sda, sB, sC, sdy, sdS
    free_card()
    emit("phase_done", name="ssd_backward", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    phase_grad_check(dev, args.seed, SSM_MODEL)
    ssm_train = phase_training(dev, args.seed, SSM_MODEL, SSM_TRAIN_STEPS,
                               n_periods=SSM_TRAIN_PERIODS)
    emit("phase_done", name="mamba2_training", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    rg_cfg = get_config(RG_MODEL)
    rg_train = phase_training(dev, args.seed, RG_MODEL, RG_TRAIN_STEPS,
                              n_periods=RG_TRAIN_PERIODS)
    # the flash kernels at its local attention's training shape: 16 heads
    # of 256 over one kv head, window 2048 over 4096 tokens, bf16
    g = torch.Generator(device=dev).manual_seed(args.seed + 23)
    rkw = {"causal": True, "window": rg_cfg.pattern[-1].window}
    rq, rk, rv = flash_inputs(g, dev, 1, TRAIN_SEQ, rg_cfg.n_heads, rg_cfg.n_kv_heads,
                              rg_cfg.head_dim, torch.bfloat16)
    rdo = _randn(g, rq.shape, torch.bfloat16, dev)
    rg_bwd_shape = measure_flash_bwd(rq, rk, rv, rdo, rkw)
    emit("flash_bwd_rg_train_shape", card=card, **rg_bwd_shape)
    check(rg_bwd_shape["kernel_route"] == "wgmma",
          f"recurrentgemma's backward took route {rg_bwd_shape['kernel_route']}")
    check(rg_bwd_shape["library_device_ms"] is not None
          and rg_bwd_shape["device_ms"] < rg_bwd_shape["library_device_ms"],
          f"recurrentgemma's backward takes {rg_bwd_shape['device_ms']} device ms, "
          f"SDPA's forward and backward {rg_bwd_shape['library_device_ms']}")
    rg_fwd_shape = measure_flash(rq, rk, rv, rkw)
    emit("flash_rg_train_path_shape", **rg_fwd_shape)
    del rq, rk, rv, rdo
    free_card()
    emit("phase_done", name="recurrentgemma_training", s=time.perf_counter() - t0)

    # training MLA and MoE: the backward kernel at (192, 128), deepseek-v2-
    # lite-16b's whole-model gradients, determinism and full-width steps;
    # the train_lm example; the serving launcher
    t0 = time.perf_counter()
    (mq, mk, mv, mdo), mkw = phase_mla_backward(dev, args.seed, bwd_rec)
    mla_bwd_shape = measure_flash_bwd(mq, mk, mv, mdo, mkw)
    emit("flash_bwd_mla_train_shape", card=card, **mla_bwd_shape)
    check(mla_bwd_shape["kernel_route"] == "wgmma",
          f"MLA's backward took route {mla_bwd_shape['kernel_route']}")
    mla_fwd_shape = measure_flash(mq, mk, mv, mkw)
    emit("flash_mla_train_path_shape", **mla_fwd_shape)
    del mq, mk, mv, mdo
    free_card()
    emit("phase_done", name="mla_backward", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mla_grad = phase_grad_check(dev, args.seed, MLA_MODEL, n_periods=MLA_GRAD_PERIODS,
                                rerun=True)
    moe_det = phase_moe_determinism(dev, args.seed)
    mla_train = phase_training(dev, args.seed, MLA_MODEL, MLA_TRAIN_STEPS,
                               n_periods=MLA_TRAIN_PERIODS)
    emit("phase_done", name="deepseek_training", s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as workdir:
        example = phase_train_example(dev, Path(workdir))
    free_card()
    launcher = phase_serve_launcher(dev)
    mapreduce_ex = phase_mapreduce_example(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as workdir:
        serve_ex = phase_serve_example(dev, args.seed, Path(workdir))
        free_card()
        host_ex = phase_host_examples(Path(workdir))
    emit("phase_done", name="example_and_launcher", s=time.perf_counter() - t0)
    emit("mla_moe_training", gradient_check=mla_grad, moe_determinism=moe_det,
         example=example, serve_launcher=launcher, mapreduce_example=mapreduce_ex,
         serve_example=serve_ex, host_examples=host_ex)

    # the dry-run CLI for phase 21 runs beside the sharding phases
    cells_run = DryrunCells(dev.type)
    try:
        # sharding over torch.distributed: NCCL at world size 1
        t0 = time.perf_counter()
        phase_distributed(dev, args.seed, card)
        emit("phase_done", name="distributed", s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        phase_sharded_train(dev, args.seed, card)
        emit("phase_done", name="sharded_train", s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        phase_sharded_mixers(dev, args.seed, card)
        emit("phase_done", name="sharded_mixers", s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        sharded_serve = phase_sharded_serve(dev, args.seed, card)
        emit("phase_done", name="sharded_serve", s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        phase_dryrun(dev, args.seed, card, cells_run)
        emit("phase_done", name="dryrun", s=time.perf_counter() - t0)
    finally:
        cells_run.stop()

    def path_row(m, launches):
        return {"shape": m["shape"], "launches": launches, "ms": m["kernel_ms"],
                "device_ms": m["device_ms"], "plain_ms": m["plain_ms"],
                "library_ms": m["library_ms"],
                "library_device_ms": m.get("library_device_ms"),
                "bound_ms": m["bound_ms"], "bound_by": m["bound_by"]}

    def row(name, source, replaces, n, record_err, checks, m, extra):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n, "max_abs_err": record_err,
            "checks": checks, "ms": m["kernel_ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "shape": extra,
        }

    print(card, flush=True)  # again, beside the numbers below
    print(json.dumps({"kernels": [
        {**row("bucket_histogram", "src/repro_torch/csrc/bucket_histogram.cu",
               "src/repro/kernels/bucket_histogram.py:79", launches,
               rec.max_abs_err, rec.checks, shape,
               {"n": shape["n"], "n_buckets": shape["n_buckets"]}),
         "kernel_route": shape["kernel_route"],
         "device_ms": shape["device_ms"],
         "library_device_ms": shape["library_device_ms"],
         "device_ops_per_call": shape["device_ops_per_call"],
         "launch_floor_ms": shape["launch_floor_ms"],
         "launch_floor_device_ms": shape["launch_floor_device_ms"]},
        {**row("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:138",
               serve_launches["flash_attention"], flash_rec.max_abs_err,
               flash_rec.checks, flash_shape, flash_shape["shape"]),
         "kernel_route": flash_shape["kernel_route"],
         "device_ms": flash_shape["device_ms"],
         "library_device_ms": flash_shape["library_device_ms"],
         "traced_launches": traced_launches["flash_attention"],
         "path_launches": {
             "recurrentgemma-9b": rg_launches["flash_attention"],
             "deepseek-v2-lite-16b": mla_launches["flash_attention"],
             "dbrx-132b_2_layers": moe_launches["flash_attention"]},
         "path_shapes": {
             "recurrentgemma-9b_local": path_row(
                 local_shape, rg_launches["flash_attention"]),
             "deepseek-v2-lite-16b_mla": path_row(
                 mla_shape, mla_launches["flash_attention"]),
             "dbrx-132b_2_layers": path_row(
                 dbrx_flash, moe_launches["flash_attention"]),
             "qwen2.5-3b_train_4k": path_row(
                 flash_train_shape, train_launches["flash_attention"]),
             "recurrentgemma-9b_train_4k": path_row(
                 rg_fwd_shape, rg_train["launches"]["flash_attention"]),
             "deepseek-v2-lite-16b_train_4k": path_row(
                 mla_fwd_shape, mla_train["launches"]["flash_attention"]),
             "f32_route": {
                 **path_row(f32_shape, grad_out["flash_attention"]),
                 "kernel_route": f32_shape["kernel_route"],
                 "library_backend": f32_shape["library_backend"]}},
         "training_launches": train_launches["flash_attention"],
         "training_launches_deepseek-v2-lite-16b":
             mla_train["launches"]["flash_attention"],
         "launches_per_step_deepseek-v2-lite-16b":
             mla_train["launches_per_step"]["flash_attention"],
         "training_launches_recurrentgemma-9b": rg_train["launches"]["flash_attention"],
         "launches_per_step_recurrentgemma-9b":
             rg_train["launches_per_step"]["flash_attention"]},
        {**row("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
               "jax.vjp of src/repro/models/layers.py:112 chunked_attention",
               train_launches["flash_attention_bwd"], bwd_rec.max_abs_err,
               bwd_rec.checks, bwd_shape, bwd_shape["shape"]),
         "kernel_route": bwd_shape["kernel_route"],
         "device_ms": bwd_shape["device_ms"],
         "bound_as_run_ms": bwd_shape["bound_as_run_ms"],
         "library_device_ms": bwd_shape["library_device_ms"],
         "library": "scaled_dot_product_attention forward + backward",
         "library_fwd_ms": bwd_shape["library_fwd_ms"],
         "library_backend": bwd_shape["library_backend"],
         "fwd_bwd_ms": bwd_shape["fwd_bwd_ms"],
         "max_rel_l2": bwd_rec.max_rel_l2,
         "launches_per_step": train_out["launches_per_step"]["flash_attention_bwd"],
         "training_launches_recurrentgemma-9b":
             rg_train["launches"]["flash_attention_bwd"],
         "launches_per_step_recurrentgemma-9b":
             rg_train["launches_per_step"]["flash_attention_bwd"],
         "training_launches_deepseek-v2-lite-16b":
             mla_train["launches"]["flash_attention_bwd"],
         "launches_per_step_deepseek-v2-lite-16b":
             mla_train["launches_per_step"]["flash_attention_bwd"],
         "path_shapes": {
             "recurrentgemma-9b_train_4k": {
                 **path_row(rg_bwd_shape, rg_train["launches"]["flash_attention_bwd"]),
                 "kernel_route": rg_bwd_shape["kernel_route"]},
             "deepseek-v2-lite-16b_train_4k": {
                 **path_row(mla_bwd_shape, mla_train["launches"]["flash_attention_bwd"]),
                 "kernel_route": mla_bwd_shape["kernel_route"],
                 "bound_as_run_ms": mla_bwd_shape["bound_as_run_ms"],
                 "device_ms_by_kernel": mla_bwd_shape["device_ms_by_kernel"],
                 "library_fwd_ms": mla_bwd_shape["library_fwd_ms"],
                 "library_backend": mla_bwd_shape["library_backend"]},
             "f32_route": {
                 **path_row(bwd_f32_shape, grad_out["flash_attention_bwd"]),
                 "kernel_route": bwd_f32_shape["kernel_route"],
                 "bound_as_run_ms": bwd_f32_shape["bound_as_run_ms"],
                 "library_fwd_ms": bwd_f32_shape["library_fwd_ms"],
                 "library_backend": bwd_f32_shape["library_backend"]}}},
        {**row("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention.py:127",
               serve_launches["decode_attention"], decode_rec.max_abs_err,
               decode_rec.checks, decode_shape, decode_shape["shape"]),
         "kernel_route": decode_shape["kernel_route"],
         "device_ms": decode_shape["device_ms"],
         "library_device_ms": decode_shape["library_device_ms"],
         "traced_launches": traced_launches["decode_attention"],
         "path_launches": {
             "recurrentgemma-9b": rg_launches["decode_attention"],
             "dbrx-132b_2_layers": moe_launches["decode_attention"]},
         "path_shapes": {
             "recurrentgemma-9b_ring": path_row(
                 ring_shape, rg_launches["decode_attention"]),
             "dbrx-132b_2_layers": path_row(
                 dbrx_decode, moe_launches["decode_attention"]),
             "qwen2.5-3b_f32": {**path_row(decode_f32_shape, None),
                                "kernel_route": decode_f32_shape["kernel_route"]}},
         "return_lse": decode_lse,
         "sharded_serve_launches_per_step": {
             f"{r['model']}{'_int8' if r['quant_cache'] else ''}":
             r["decode_launches_per_step"] for r in sharded_serve["runs"]}},
        {**row("ssd_chunk", "src/repro_torch/csrc/ssd_scan.cu",
               "src/repro/kernels/ssd_scan.py:80", ssd_launches,
               ssd_rec.max_abs_err, ssd_rec.checks, ssd_shape,
               ssd_shape["shape"]),
         "kernel_route": ssd_shape["kernel_route"],
         "device_ms": ssd_shape["device_ms"],
         "training_launches": ssm_train["launches"]["ssd_chunk"],
         "launches_per_step": ssm_train["launches_per_step"]["ssd_chunk"],
         "path_shapes": {"mamba2-2.7b_train_4k": path_row(
             ssd_train_shape, ssm_train["launches"]["ssd_chunk"])}},
        {**row("ssd_chunk_bwd", "src/repro_torch/csrc/ssd_scan_bwd.cu",
               "jax.vjp of src/repro/models/ssm.py:64 _ssd_chunked",
               ssm_train["launches"]["ssd_chunk_bwd"], ssd_bwd_rec.max_abs_err,
               ssd_bwd_rec.checks, ssd_bwd_shape, ssd_bwd_shape["shape"]),
         "kernel_route": ssd_bwd_shape["kernel_route"],
         "device_ms": ssd_bwd_shape["device_ms"],
         "device_ms_by_kernel": ssd_bwd_shape["device_ms_by_kernel"],
         "max_rel_l2": ssd_bwd_rec.max_rel_l2,
         "launches_per_step": ssm_train["launches_per_step"]["ssd_chunk_bwd"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
