"""Smoke run of the torch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build      - compile kernels B1, B2, B3 and B4 from
                ``src/repro_torch/kernels/csrc``; print the card's name and
                power limit (``nvidia-smi``) and ptxas's register and spill
                lines.
2. kernels    - each kernel against its plain PyTorch version on the card:
                B1 and B2 at small shapes, float32 and float64, ragged row
                ranges/chunks; B3 at the shapes of ``tests/test_kernels.py``
                plus (S, T, K, G, hd) = (1000, 1000, 2, 6, 128) and edge
                shapes (hd 24, 80 and 112, G = 1, rows and keys off the
                kernel's 128-row and 128-key tiles), float32 and bfloat16,
                causal, windows 32 and 200 and non-causal, and ``q_offset``
                cases with T > S, each also with its logsumexp (lse against
                the plain version's, the output bit for bit the launch
                without lse); B3's gradients under autograd (f32, causal,
                window 32 or none, G = 1 and 6) against autograd through the
                einsum route; B4 at the shapes of
                ``tests/test_kernels.py``, a ragged s = 1000, the serving
                shape (b 4, s 2048, h 32, p 64, n 128, chunk 64), s = 4096
                and a near 0, float32 and bfloat16; B3 also at the
                granite-moe heads (hd 64, K 8, G 2 and 3, S = T = 2048) and
                InternVL's (hd 128, K 8, G 6, S = T = 1280); B4's gradients
                under autograd (its forward, the plain backward) against
                autograd through the plain version, f32 and bf16.
3. reference  - the examples' own small configurations through the port
                against float64 numpy programs written here: quickstart
                N-body and WaveSim 256 x 128 on 2 x 2; examples/nbody.py's
                energy and momentum reductions (N = 512) on 1 x 1, 2 x 2,
                3 x 1 and 2 x 2 unfused, E and Mx held bit for bit against
                math.fsum of numpy's per-body energies and momenta of the
                port's own gathered state; the WaveSim residual against the
                fsum of its fields; both memory-budget demos at their
                example sizes.
4. nbody      - the N-body through ``repro_torch.core.Runtime`` on 2 nodes x
                2 devices: 2^17 float32 bodies, 20 steps, E and Mx reduced
                every 10 steps, held against the same 20 steps run without
                the runtime (positions bitwise; E and Mx bitwise equal to
                math.fsum of the per-body energies and momenta computed on
                the whole range); the same run on 1 x 1 and 3 x 1 gives the
                same bits; the fused exchange's message count.
5. wavesim    - WaveSim on 2 x 2: an 8192 x 8192 float32 field, 50 steps,
                held against 50 whole-field kernel steps without the
                runtime; then the residual, bitwise equal to math.fsum of
                the squared difference of the gathered fields.
                Phases 4 and 5 time their steps inside the run: the first
                step (which also seeds the buffers on the card) and the
                steps after it, each ended by ``rt.sync()``, then the
                gather; the energy steps and the residual are timed apart.
5b. trace     - instruction records of traced runs on the card: the N-body
                (2^17 bodies, 10 steps) and WaveSim (8192^2, 20 steps) on
                2 x 2 with ``trace=True``: every record ordered, wait sums
                exact, every device lane's record stamped with its launch
                and sync in between (``t_start <= t_launched <= t_synced
                <= t_done``); the critical path; a Perfetto export with
                events on every device lane; steps/s traced, with metrics
                only and bare, in turns.
6. serve-reference - reduced qwen2-1.5b, mamba2-370m and zamba2-7b in float32
                on the card (B3 on; B4 in every Mamba2 layer's prefill)
                against the same weights served by the port on the CPU, which
                the tests hold against the JAX package.
6a. zoo-reference - reduced granite-moe-1b-a400m, granite-moe-3b-a800m,
                whisper-tiny and internvl2-26b in float32 on the card (B3 on)
                against the same weights on the CPU: forward logits, the
                family's prefill step plus 4 decode steps, the loss and
                every gradient; the loss and gradients also of reduced
                mamba2-370m and zamba2-7b (B4 under autograd); the card's
                B3 and B4 launches.
6b. train-reference - reduced qwen2-1.5b in f32 with B3, three TrainLoop
                steps on the card against the CPU port on the same weights
                and batches; a run failing at step 5 restored from its
                checkpoint against the uninterrupted run; ElasticTrainer
                through one injected failure.
6c. remat     - qwen2-1.5b and granite-moe-1b-a400m (B3) and mamba2-370m
                (B4) at full width, f32 weights and moments, bf16
                activations, 2 x 2048 tokens a step, each with ``cfg.remat``
                on and off in this call: the first step's loss and grad norm
                under both (within 1e-6 and 1e-5 relative, and whether they
                and every gradient were bitwise equal), a warm-up train
                step, then 2 timed steps (median ms per step, tokens/s),
                peak memory from a reset (lower with remat on), and the
                kernel's launches per step: twice per layer with remat on
                (the forward and the backward's recompute), once without.
6c2. dryrun   - the dry-run (``repro_torch.launch.dryrun``) over fake CUDA
                tensors, no kernel launched: ``lower_cell`` of qwen2-1.5b,
                granite-moe-3b-a800m and mamba2-370m at ``train_4k`` and
                ``prefill_32k`` and qwen2-1.5b at ``decode_32k``, each on the
                (16, 16) and (2, 16, 16) meshes (one process a cell, run
                side by side), every record printed; then, at mesh (1, 1),
                qwen2-1.5b, granite-moe-1b-a400m and mamba2-370m at the remat
                phase's setting (2 x 2048 tokens, f32 weights and moments,
                bf16 activations, B3/B4, remat on): the trace's per-card peak
                (argument + temp) against ``max_memory_allocated`` of a real
                train step after a warm-up step (within 10%), its FLOPs
                against a ``FlopCounterMode`` count of a real step (within
                1e-6), and its roofline step time ``max(flops / peak,
                bytes / HBM)`` beside the measured step.
6d. train     - qwen2-1.5b at full width (f32 weights, bf16 activations,
                B3 in every layer's forward, remat on as the JAX package
                configures it) through ``TrainLoop``: the first step's loss
                and grad norm against the einsum route, a warm-up step,
                then 4 steps of 2 x 2048 tokens (ms per step, tokens/s,
                peak memory, 56 B3 launches a step: 28 in the forward, 28
                in the recompute; the held-out batch's loss lower after 20
                steps than before); then ``python -m
                repro_torch.launch.train --full --flash --steps 2 --batch 1
                --seq 1024`` once.
6e. moe-train - granite-moe-1b-a400m at full width through ``TrainLoop``
                under the train phase's rules (B3 forward and recompute,
                plain backward, the einsum route as reference, the held-out
                check).
6f. ssm-train - mamba2-370m at full width through ``TrainLoop``: B4 under
                autograd in every layer (the kernel's forward, again in the
                recompute, the plain backward with its recurrence over
                chunks as two state-pass launches), the first step against
                the plain scan on the card (loss within 1e-3, grad norm
                within 1e-2 relative), a warm-up step, then 4 steps of 2 x
                2048 tokens, with ssd_state_pass.launches 2 a layer a step.
6g. audio     - whisper-tiny at full width (1500 frames) in f32: encode, the
                audio prefill step, 32 decode steps from an empty cache
                against the teacher-forced decoder on the same tokens
                (1e-4); then 4 ``TrainLoop`` steps of 4 x 448 tokens in
                bf16.  No kernel runs (the einsum route, as the reference).
6h. moe-serve - granite-moe-3b-a800m at full width through ``ServeLoop``:
                the serve phase's traffic with prompt lengths rounded to
                multiples of 128 (4 x S divides into MoE groups of 512),
                f32 weights, bf16 activations, B3 in every prefill layer,
                after a warm-up batch; one prefill batch in f32 activations
                held against the einsum route (1e-3 of the largest logit),
                the same in bf16 printed; then the launcher once.
6i. vlm       - internvl2-26b at full width with bf16 weights (40 GB): 2
                requests of 256 image and 1024 text tokens through the vlm
                prefill step (B3 in each of 48 layers) and 16 decode steps,
                after a warm-up; held against the einsum route by the serve
                rule.
7. serve      - qwen2-1.5b at full width through ``repro_torch.runtime.
                ServeLoop``: 8 requests of 1024-2048 tokens, 4 per batch, 32
                new tokens each, f32 weights, bf16 activations, flash
                attention on (B3 in every layer's prefill), after a short
                warm-up batch.  Prefill and decode are timed per call, each
                window ended by ``torch.cuda.synchronize()``.  Held against
                the same requests served with flash attention off (the
                einsum route); then the launcher
                ``python -m repro_torch.launch.serve --full`` once.
8. ssm-serve  - mamba2-370m at full width through ``ServeLoop``: the same
                traffic, f32 weights, bf16 activations, B4 in every layer's
                prefill, after a warm-up batch.  Held by prefill of a batch's
                first S - 1 tokens plus one recurrent decode step of the last
                against the whole prefill; then the launcher
                ``python -m repro_torch.launch.serve --arch mamba2-370m
                --full`` once.
9. timing     - each kernel at the shapes phases 4, 5, 7 and 8 give it, by
                CUDA events, beside its bound, its plain version, for B3 one
                PyTorch call (``scaled_dot_product_attention``), and its
                error against the plain version there; B1's, B3's and B4's
                achieved TFLOP/s; B3 at the train shape with and without
                lse, beside the plain backward; B3 at granite-moe-3b's
                serving heads beside the library call and its plain
                backward; B4 at the ssm-train shape and its plain backward;
                B4's forward and backward (the recurrence over chunks as its
                two state-pass launches, then as ssd_state_pass_plain), and
                the recurrence alone (ssd_state_pass: hprev, hlast and the
                states' gradient bit for bit, the decays' within 1e-6 of
                its largest, against ssd_state_pass_plain, both timed,
                beside the launches' byte bound), at the ssm-train shape
                and at one Mamba2 layer of the granite training cell
                (b 2, s 8192, h 128).
10. budget    - both memory-budget demos on the card at 50% of their
                unbudgeted device high-water mark: three phased N-body
                simulations of 2^17 float32 bodies (1 x 1, 8 steps each,
                with energies) and three interleaved WaveSims of 2048 x 4096
                float32 fields (2 x 2, 12 steps each, with residuals).
                Results bitwise equal to the unbudgeted run, the runtime's
                device peak under the budget, spills and reloads > 0.
11. lookahead - RSim (T = 64, W = 2^20, float32, 1 x 2) with lookahead on
                and off: allocation counts equal to the CPU port's for the
                same program, fields close to each other and to a float64
                numpy recurrence.
12. serving-runtime - ``repro_torch.core.ServingRuntime`` on 2 x 2 with two
                tenants submitting from two client threads at once, one step
                a window: WaveSim (8192 x 8192 float32, 40 windows, B2) and
                the N-body (2^17 float32 bodies, 10 windows, B1).  Three
                runs: memo on; memo off; memo on with renaming, two windows
                in flight and the sanitizer (``verify="window"``, then
                ``verify_now()``).  Each run's results bitwise equal to the
                same steps without the runtime, its memo counts equal to the
                CPU port's for the same window sequence at a small size, and
                windows x 4 launches of B2 and B1; per-window latency p50
                and p99 per tenant, the memo's patch time, the device peak.
                Then the pipelined runs of fault C6: clients that submit
                every window after the first and then drain, memo on,
                renaming off and on, ``max_inflight_windows`` 1 and 2 in
                turns (1, 2, 2, 1), each bitwise equal to the runtime-free
                steps with the CPU port's memo counts and windows x 4
                launches; windows per second at depth 2 against depth 1
                printed beside the card's name and power limit.  Then
                fault C5's program: one tenant on ``ServingRuntime(2, 1,
                max_inflight_per_tenant=1)`` whose two windows exchange
                halves between the nodes, with neighborhood and all-range
                reads, each within 30 s and with the bytes of the uncapped
                run.
13. faults    - on the card: the N-body (2^17 bodies, 2 x 2, 10 steps) under
                a chaos plan of drops, duplicates, delays and pilot drops,
                bitwise equal to the fault-free run with retries and equal
                logical traffic (in a fresh process, so that the plan hits
                the same messages on every run); node 1 fail-stopping in a
                WaveSim 8192 x 8192 run on 2 x 2, which must abort naming N1
                within 2 s; ``Runtime.run_supervised`` of WaveSim 4096 x
                8192 on 2 x 2, 20 steps, checkpoints every 5, node 1 failing
                after the first: one restart, one node, bitwise equal to the
                runtime-free steps.  Afterwards PyTorch holds the device
                memory it held before the phase.
14. scheduler-launcher - ``python -m repro_torch.launch.serve --engine
                scheduler --tenants 4 --windows 50 --nodes 2 --devices 1``
                once: exit 0 and "results verified".
15. profile   - N-body (10 steps; and one step plus one energy step),
                WaveSim (20 steps), one qwen2 serve batch
                and one mamba2 serve batch under torch.profiler: the
                device's busy and idle share of the run's wall time, and
                device time by kernel.
16. the ``kernels`` summary line, then the device line.

Phases 4, 5, 6d, 6e, 6f, 6h, 6i, 7 and 8, each run of phase 6c, the real
steps of phase 6c2 and each run of phase 12 are the main path: every launch
count is set to 0 just before each and read just after.

Any failed phase exits non-zero.  Without a CUDA card the script exits 1
before printing anything on standard output.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, bf16 dense on the
# tensor cores, HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

NODES, DEVICES = 2, 2
NBODY_N, NBODY_STEPS, DT, MASS = 1 << 17, 20, 1e-3, 1.0 / (1 << 17)
ENERGY_EVERY = 10
WAVE_H = WAVE_W = 8192
WAVE_STEPS, WAVE_C = 50, 0.25
SEED = 11
# budget demos on the card: bodies and steps of the N-body one (1 x 1),
# field and steps of the WaveSim one (2 x 2)
BUDGET_BODIES, BUDGET_NBODY_STEPS = 1 << 17, 8
BUDGET_FIELD, BUDGET_WAVE_STEPS = (2048, 4096), 12
# RSim: steps and columns (1 x 2, float32: a 268 MB buffer)
RSIM_T, RSIM_W = 64, 1 << 20
# RSim in float32 against the float64 recurrence: row t sums t rows of
# positive values, each sum within (t - 1) f32 roundings plus two for the
# halving and the add, and inherits at most the largest relative error of
# the rows it sums, so row 63 is within sum_{t=1..63} (t + 1) 2^-24 =
# 1.24e-4 of the recurrence
RSIM_RTOL = 1.3e-4
# serving-runtime: ServingRuntime on NODES x DEVICES with a WaveSim tenant
# (WAVE_H x WAVE_W float32) and an N-body tenant (NBODY_N float32 bodies),
# one step a window, submitted from two client threads at once; the three
# runs, each held against the CPU port's memo counts for the same window
# sequence at a small size
SERVE_RT_WAVE_WINDOWS, SERVE_RT_NBODY_WINDOWS = 40, 10
SERVE_RT_RUNS = {"memo": dict(memo=True), "memo_off": dict(memo=False),
                 "memo_renaming": dict(memo=True, renaming=True,
                                       max_inflight_windows=2,
                                       verify="window")}
# the pipelined runs (fault C6): clients that submit every window and then
# drain, memo on, renaming off and on, one and two windows in flight, in
# turns depth 1, 2, 2, 1 for each renaming setting
SERVE_RT_PIPELINED_DEPTHS = (1, 2, 2, 1)
# faults: the chaos plan of tests/test_faults.py's smoke case on the N-body
# (NBODY_N bodies, NODES x DEVICES); a fail-stop of node 1 at its
# CRASH_AT-th issued instruction in CRASH_STEPS WaveSim steps (WAVE_H x
# WAVE_W), which must abort within CRASH_LIMIT_S; and a supervised WaveSim
# run of SUPERVISED_STEPS steps on a SUPERVISED_FIELD field, checkpointed
# every CHECKPOINT_EVERY steps, whose node 1 fail-stops after the first
# checkpoint (about step 8)
FAULT_NBODY_STEPS = 10
FAULT_PLAN = dict(seed=5, drop=0.08, duplicate=0.08, delay=0.08,
                  delay_s=0.004, pilot_drop=0.2)
FAULT_RETRANSMIT_S, WATCHDOG_S = 0.01, 0.3
CRASH_STEPS, CRASH_AT, CRASH_LIMIT_S = 10, 40, 2.0
SUPERVISED_FIELD, SUPERVISED_STEPS, CHECKPOINT_EVERY = (4096, 8192), 20, 5
SUPERVISED_CRASH_AT = 100
# the serving main path: qwen2-1.5b at full width
SERVE_ARCH, SERVE_REQUESTS, SERVE_MAX_BATCH = "qwen2-1.5b", 8, 4
SERVE_PROMPT_LENS, SERVE_MAX_NEW, SERVE_MAX_LEN = (1024, 2048), 32, 2080
# the SSM serving main path: mamba2-370m at full width, the same traffic
SSM_ARCH = "mamba2-370m"
# B4 at one layer of a full mamba2-370m prefill batch: b, s, h, p, n, chunk
SSD_MAIN = (SERVE_MAX_BATCH, SERVE_PROMPT_LENS[1], 32, 64, 128, 64)
# B4 at one Mamba2 layer of the granite training cell: b, s, h, p, n, chunk
SSD_GRANITE = (2, 8192, 128, 64, 128, 64)

# kernel-versus-plain tolerances: |kernel - plain| <= atol + rtol * scale
# B1: scale = sum_j |term_ij| (nbody_error_scale).  The kernel sums N f32
#     terms in another order than torch, and rsqrtf is within 2 ulp where
#     torch.rsqrt rounds correctly; the force may cancel to near zero, so
#     the error is relative to the terms' magnitudes and not to the result.
# B2: scale = |plain|.  The kernel's fused multiply-adds round once where
#     torch rounds twice.
# B3: scale = |plain|; tests/test_kernels.py's tolerances.  The two sum in
#     other orders; in bf16 both round the softmax weights to bf16 before
#     the product with v, but relative to running maxima over key blocks of
#     different sizes (64 and 1024), and both round the output.
# B4: scale = the sum of the terms' magnitudes (ssd_error_scale): y cancels,
#     so an error relative to |y| says nothing near y = 0.  f32: the two sum
#     up to chunk + 2n products at each of three levels in other orders, and
#     expf is within 2 ulp; 1e-5 is about 100 f32 epsilons.  bf16: both
#     round the same f32 y once, which differs by one bf16 step (up to 2^-7
#     of |y|) where the sums fall on two sides of a rounding boundary, and
#     h_prev, rounded to bf16 by both, can do the same (up to 2^-8 of its
#     product with C): 2^-7 + 2^-8 < 1.2e-2 of the scale.
TOL = {"nbody_forces_rows": dict(rtol=1e-4, atol=1e-6),
       "wave_step_rows": dict(rtol=1e-5, atol=1e-5),
       "flash_attention.float32": dict(rtol=2e-5, atol=2e-5),
       "flash_attention.bfloat16": dict(rtol=2e-2, atol=2e-2),
       # B3's lse against the plain version's, both dtypes: the logits are
       # exact f32 products of the same inputs in both, so lse = m + log(l)
       # differs only by the order of l's sum and ex2's 2 ulp (bf16 path),
       # a few f32 epsilons of l and so of log(l)
       "flash_attention.lse": dict(rtol=1e-5, atol=1e-5),
       "ssd_scan.float32": dict(rtol=1e-5, atol=1e-6),
       "ssd_scan.bfloat16": dict(rtol=1.2e-2, atol=1e-6)}
# serve-reference: reduced models in f32, card against CPU: prefill and
# decode logits within 1e-4 (f32 sums in other orders over two to four
# layers).
SERVE_REF_TOL = 1e-4
# serve: flash route (B3) against the einsum route at full width in bf16;
# the last-token logits must agree within this share of their largest
# magnitude.  The two routes round at different points (the einsum route
# rounds the logits to bf16 before scaling them), and each layer adds two
# bf16 outputs (attention, MLP) to the residual stream, each rounded to
# 2^-8 of its size: 56 such differences add like a random walk, about
# 2^-8 * sqrt(56) = 0.029; the tolerance leaves room above that estimate
# (measured on an H100: up to 0.022, over a first guess of 0.02).
SERVE_TOL = 4e-2
# ssm-serve: prefill of S - 1 tokens plus one recurrent decode step against
# the whole prefill, mamba2-370m at full width in bf16; the last-token
# logits must agree within this share of their largest magnitude.  The two
# paths round at different points (the chunked scan keeps its state in f32
# and rounds y once; the recurrent step rounds the state, the conv and y to
# bf16; the prefill's conv rounds after each of its four products), a
# bf16 step or two of each layer's mixer output.  Estimated before the
# first run on the card from the same check on the CPU at reduced width
# (d_model 128-256, n 128, chunk 64, 300-token prompts): 0.006-0.012 at 2
# layers, 0.010-0.024 at 8, 0.016-0.027 at 24, growing as the square root
# of the depth, so about 0.03-0.04 at 48 layers; the tolerance leaves room
# above that.
SSM_TOL = 5e-2
# kernels: B3's gradients (the autograd Function: the kernel's forward with
# lse, the plain backward) against autograd through the einsum route, f32:
# within this share of the largest magnitude.
FLASH_GRAD_TOL = 1e-4
# timing: B3's gradients at the train shape in bf16 (the Function: the
# kernel's forward, the plain backward in f32 from bf16 inputs, gradients
# rounded once) against autograd through the einsum route in bf16, which
# rounds the logits, the softmax weights, the gradient of the logits and
# every product's output to bf16 (each 2^-9 of its value, and a logit's
# error moves its weight by as much relative to the logit's size, up to
# about 4 here): about 1% of an element, summed over up to 2048 keys with
# random signs; within this share of the largest magnitude.  A wrong lse
# row scales that row's weights and is off by its whole size.
FLASH_GRAD_BF16_TOL = 5e-2
# trace: the steps of the traced N-body and WaveSim runs
TRACE_NBODY_STEPS, TRACE_WAVE_STEPS = 10, 20
# instructions the receive arbiter completes, and graph syncs: no card work
ARBITER_KINDS = ("receive", "split_receive", "await_receive",
                 "gather_receive", "coll_recv", "horizon", "epoch")
# train-reference: reduced qwen2-1.5b in f32, card against CPU, 3 TrainLoop
# steps; losses within 1e-4 relative (f32 sums in other orders over two
# layers, three optimizer steps)
TRAIN_REF_BATCH, TRAIN_REF_SEQ, TRAIN_REF_STEPS, TRAIN_REF_TOL = 4, 64, 3, 1e-4
# train: qwen2-1.5b at full width, f32 weights, bf16 activations, B3 on, 2 x
# 2048 tokens a step; the first step's loss and grad norm on the flash route
# against the einsum route: the two round at different points (see
# SERVE_TOL), which moves a mean of 4094 token losses little (1e-3) and the
# norm of 1.5e9 gradients more (1e-2)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
# the loss must fall on a batch never trained on (its index is past every
# step's), read before the warm-up step and after TRAIN_FALL_STEPS steps
TRAIN_HELD_OUT, TRAIN_FALL_STEPS = 10**6, 20
TRAIN_LOSS_RTOL, TRAIN_GRAD_NORM_RTOL = 1e-3, 1e-2
# zoo-reference: reduced models in f32, card against CPU on the same
# weights: logits within SERVE_REF_TOL, losses within ZOO_LOSS_RTOL relative
# and every gradient within ZOO_GRAD_TOL of the largest of the CPU's
# (tests/test_torch_train.py's tolerances)
ZOO_REF_ARCHS = ("granite-moe-1b-a400m", "granite-moe-3b-a800m",
                 "whisper-tiny", "internvl2-26b")
ZOO_TRAIN_ARCHS = ZOO_REF_ARCHS + (SSM_ARCH, "zamba2-7b")
ZOO_LOSS_RTOL, ZOO_GRAD_TOL = 1e-5, 1e-4
# moe-serve: granite-moe-3b-a800m at full width through ServeLoop, the
# serve phase's traffic with every prompt a multiple of MOE_PROMPT_STEP
# tokens long, so that a batch's 4 x S tokens divide into MoE groups of
# moe_group = 512 (the model refuses other counts, as the reference does)
MOE_SERVE_ARCH, MOE_PROMPT_STEP = "granite-moe-3b-a800m", 128
# moe-serve's gate: one prefill batch with f32 activations, B3 against the
# einsum route.  Each B3 launch is held against the einsum route on the same
# q, k, v (TOL's f32 tolerance), and the last-token logits of every row that
# no routing flip touched within this share of their largest magnitude (f32
# sums in other orders, 32 layers).  A flip (a token whose top-8 experts
# differ between the routes, from two probabilities within the f32 sums'
# error of each other) is not rare at this width (7168 tokens x 8 argmax
# rounds a layer; PERF.md §6), and a flip also moves the capacity slots of
# the rest of its 512-token group, so the rows it touches are printed, not
# gated; so is the whole comparison in bf16.
MOE_F32_TOL = 1e-3
# moe-train: granite-moe-1b-a400m at full width through TrainLoop, under the
# train phase's rules and sizes
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
# remat: the three full-width training models, each with cfg.remat on and
# off (f32 weights and moments, bf16 activations, TRAIN_BATCH x TRAIN_SEQ
# tokens a step), REMAT_STEPS timed train steps after a warm-up step.  The
# recompute runs the same kernels on the same inputs, so the first step's
# loss and gradients are expected bitwise equal; the bounds allow for a
# library routine that sums in another order in the recompute, and the
# phase prints whether they were bitwise equal.
REMAT_ARCHS = (SERVE_ARCH, MOE_TRAIN_ARCH, SSM_ARCH)
REMAT_STEPS = 2
REMAT_LOSS_RTOL, REMAT_GRAD_NORM_RTOL = 1e-6, 1e-5
# dryrun: the production cells traced over fake CUDA tensors on both
# meshes, and the archs held against a real step at mesh (1, 1) under the
# remat phase's setting: the predicted peak within DRYRUN_PEAK_RTOL of
# max_memory_allocated, the FLOPs within DRYRUN_FLOPS_RTOL of a
# FlopCounterMode count of the real step (the same ops)
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k"), ("granite-moe-3b-a800m", "train_4k"),
                ("mamba2-370m", "train_4k"), ("qwen2-1.5b", "prefill_32k"),
                ("granite-moe-3b-a800m", "prefill_32k"),
                ("mamba2-370m", "prefill_32k"), ("qwen2-1.5b", "decode_32k"))
DRYRUN_CARD_ARCHS = REMAT_ARCHS
DRYRUN_PEAK_RTOL, DRYRUN_FLOPS_RTOL = 0.10, 1e-6
# serving-runtime's fault C5 case: a ServingRuntime(2, 1) with an admission
# cap of 1 per tenant, two windows that exchange halves between the nodes,
# each run under this deadline
C5_DEADLINE_S = 30.0
# audio: whisper-tiny at full width (1500 frames); decode steps from an
# empty cache against the teacher-forced decoder on the same tokens, f32
# activations, within AUDIO_TOL absolute; then TrainLoop steps
AUDIO_ARCH, AUDIO_BATCH, AUDIO_SEQ = "whisper-tiny", 4, 448
AUDIO_DECODE_STEPS, AUDIO_TRAIN_STEPS, AUDIO_TOL = 32, 4, 1e-4
# vlm: internvl2-26b at full width with bf16 weights (f32 would be 80 GB):
# VLM_REQUESTS requests of vis_tokens image and VLM_TEXT text tokens, then
# VLM_DECODE_STEPS decode steps; held against the einsum route by SERVE_TOL
VLM_ARCH, VLM_REQUESTS, VLM_TEXT, VLM_DECODE_STEPS = "internvl2-26b", 2, 1024, 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def errors(got: torch.Tensor, exp: torch.Tensor, name: str,
           scale: torch.Tensor | None = None) -> dict:
    g, e = got.double(), exp.double()
    diff = (g - e).abs()
    scale = e.abs() if scale is None else scale.double()
    tol = TOL[name]
    ok = bool((diff <= tol["atol"] + tol["rtol"] * scale).all())
    rel = diff / scale.clamp_min(1e-30)
    return dict(max_abs_err=float(diff.max()),
                max_err_over_scale=float(rel.max()), ok=ok, **tol)


def nbody_error_scale(p: torch.Tensor, lo: int, hi: int,
                      soft: float = 1e-3) -> torch.Tensor:
    """``sum_j |d_ij| / r_ij^3`` per row and component, in f32: the scale of
    the rounding error of any f32 sum of B1's force terms, whatever its
    order.  Rows go in blocks of 256 to bound the ``[rows, N, 3]``
    temporaries."""
    pa = p.float()
    out = torch.empty((hi - lo, 3), device=p.device)
    for b in range(lo, hi, 256):
        e = min(hi, b + 256)
        d = pa[None, :, :] - pa[b:e, None, :]
        w = torch.rsqrt((d * d).sum(-1) + soft) ** 3
        out[b - lo:e - lo] = (d.abs() * w[..., None]).sum(1)
    return out


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """The host's time to enqueue one call of ``fn``, from a synchronized
    start, without waiting for the card (``reps`` calls must fit the
    launch queue): a wrapper's dispatch cost apart from its kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return dt


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def phase_build() -> str:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    seconds = time.perf_counter() - t0
    smi = nvidia_smi()
    print(smi, flush=True)
    log = (lib_path.parent / "build.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln
             or "Function properties" in ln]
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "library": str(lib_path.relative_to(ROOT)), "nvidia_smi": smi,
          "ptxas": ptxas})
    return smi


def phase_kernels(dev) -> dict:
    from repro_torch.kernels.nbody import (nbody_forces_rows,
                                           nbody_forces_rows_plain)
    from repro_torch.kernels.stencil5 import (halo_rows, wave_step_rows,
                                              wave_step_rows_plain)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    cases, ok = [], True
    for N in (1000, 4096):
        for dtype in (torch.float32, torch.float64):
            p = torch.randn(N, 3, generator=g).to(dev, dtype)
            full = nbody_forces_rows(p, 0, N)
            for lo, hi in ((0, N), (0, N // 3), (N // 3, N), (N - 1, N),
                           (17, 17 + N // 2)):
                got = nbody_forces_rows(p, lo, hi)
                e = errors(got, nbody_forces_rows_plain(p, lo, hi),
                           "nbody_forces_rows", nbody_error_scale(p, lo, hi))
                e["rows_of_full"] = bool(torch.equal(got, full[lo:hi]))
                ok &= e["ok"] and e["rows_of_full"]
                cases.append({"kernel": "nbody_forces_rows", "N": N,
                              "dtype": str(dtype), "rows": [lo, hi], **e})
    for H, W, cuts in ((1000, 777, (1, 250, 251, 600, 999)),
                       (4096, 4096, (1000, 2048, 3001))):
        for dtype in (torch.float32, torch.float64):
            um = torch.randn(H, W, generator=g).to(dev, dtype)
            u = torch.randn(H, W, generator=g).to(dev, dtype)
            whole = wave_step_rows(um, u, 0, H)
            edges = [0, *cuts, H]
            parts = []
            for lo, hi in zip(edges[:-1], edges[1:]):
                top, bottom = halo_rows(lo, hi - lo, H)
                parts.append(wave_step_rows(um[lo:hi],
                                            u[lo - top:hi + bottom], lo, H))
            e = errors(whole, wave_step_rows_plain(um, u, 0, H),
                       "wave_step_rows")
            e["chunks_equal_whole"] = bool(torch.equal(torch.cat(parts),
                                                       whole))
            ok &= e["ok"] and e["chunks_equal_whole"]
            cases.append({"kernel": "wave_step_rows", "H": H, "W": W,
                          "dtype": str(dtype), "cuts": list(cuts), **e})
    cases += flash_cases(dev, g)
    cases += ssd_cases(dev, g)
    torch.cuda.synchronize()
    ok = ok and all(c["ok"] for c in cases)
    worst = {}
    for c in cases:
        worst[c["kernel"]] = max(worst.get(c["kernel"], 0.0), c["max_abs_err"])
    emit({"phase": "kernels", "ok": ok, "cases": len(cases),
          "max_abs_err": worst, "failed": [c for c in cases if not c["ok"]]})
    if not ok:
        raise SystemExit("kernel-versus-plain check failed")
    return worst


def flash_cases(dev, g: torch.Generator) -> list[dict]:
    """B3 against its plain version on the card."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    cases = []
    # (S, T, K, G, hd): tests/test_kernels.py's shapes; the serving heads
    # (G 6, hd 128); hd 80 (h2o-danube) and 24; zamba2-7b's shared block
    # (hd 112, G 1); S * G not a multiple of the bf16 kernel's 128-row blocks
    # and T not a multiple of its 128-key tiles; the granite-moe heads (hd
    # 64, K 8, G 2 and 3) at a 2048-token prefill and InternVL's (hd 128,
    # K 8, G 6) at its 1280
    shapes = [(64, 64, 2, 3, 32), (128, 128, 1, 4, 64), (48, 96, 2, 1, 16),
              (256, 256, 4, 2, 128), (1000, 1000, 2, 6, 128),
              (300, 333, 2, 4, 80), (77, 77, 2, 5, 24), (300, 333, 1, 1, 112),
              (257, 300, 2, 6, 80), (2048, 2048, 8, 2, 64),
              (2048, 2048, 8, 3, 64), (1280, 1280, 8, 6, 128)]
    for S, T, K, G, hd in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            name = f"flash_attention.{str(dtype).split('.')[1]}"
            q = torch.randn(2, S, K, G, hd, generator=g).to(dev, dtype)
            k = torch.randn(2, T, K, hd, generator=g).to(dev, dtype)
            v = torch.randn(2, T, K, hd, generator=g).to(dev, dtype)
            # windows smaller (32) and larger (200) than one key tile
            for causal, window in ((True, None), (True, 32), (True, 200),
                                   (False, None)):
                got = flash_attention(q, k, v, causal=causal, window=window)
                exp, exp_lse = flash_attention_plain(
                    q, k, v, causal=causal, window=window, return_lse=True)
                e = errors(got, exp, name)
                # the launch with lse: the same output, and lse
                got2, lse = flash_attention(q, k, v, causal=causal,
                                            window=window, return_lse=True)
                e["lse"] = errors(lse, exp_lse, "flash_attention.lse")
                e["out_equal_without_lse"] = bool(torch.equal(got, got2))
                e["ok"] = (e["ok"] and e["lse"]["ok"]
                           and e["out_equal_without_lse"])
                cases.append({"kernel": "flash_attention",
                              "shape": [S, T, K, G, hd], "dtype": str(dtype),
                              "causal": causal, "window": window, **e})
    # decode-style queries: the last S of T positions at q_offset T - S,
    # against the whole run's rows (T, S, G, hd, window)
    for T, S, G, hd, window in ((64, 16, 2, 32, None), (300, 100, 6, 128, None),
                                (333, 77, 1, 112, None), (300, 130, 3, 80, 96)):
        for dtype in (torch.float32, torch.bfloat16):
            name = f"flash_attention.{str(dtype).split('.')[1]}"
            q = torch.randn(1, T, 2, G, hd, generator=g).to(dev, dtype)
            k = torch.randn(1, T, 2, hd, generator=g).to(dev, dtype)
            v = torch.randn(1, T, 2, hd, generator=g).to(dev, dtype)
            part = flash_attention(q[:, T - S:].contiguous(), k, v,
                                   window=window, q_offset=T - S)
            e = errors(part, flash_attention_plain(q, k, v, window=window)
                       [:, T - S:], name)
            cases.append({"kernel": "flash_attention",
                          "shape": [S, T, 2, G, hd], "dtype": str(dtype),
                          "window": window, "q_offset": T - S, **e})
    return cases + flash_grad_cases(dev, g)


def flash_grad_cases(dev, g: torch.Generator) -> list[dict]:
    """B3 under autograd (its forward with lse, the plain blockwise
    backward) against autograd through the einsum route, f32, causal, with
    and without a window of 32, G = 1 and 6."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.layers import _sdpa, causal_mask
    cases = []
    B, S, K, hd = 2, 256, 2, 64
    for G in (1, 6):
        for window in (None, 32):
            base = [torch.randn(B, S, K, G, hd, generator=g),
                    torch.randn(B, S, K, hd, generator=g),
                    torch.randn(B, S, K, hd, generator=g)]
            dout = torch.randn(B, S, K, G, hd, generator=g).to(dev)
            mask = causal_mask(S, S, window=window, device=dev)
            grads = []
            for route in ("kernel", "einsum"):
                qkv = [t.to(dev).requires_grad_() for t in base]
                out = (flash_attention(*qkv, window=window)
                       if route == "kernel" else _sdpa(*qkv, mask))
                (out * dout).sum().backward()
                grads.append([t.grad for t in qkv])
            errs = {n: float((a - b).abs().max() / b.abs().max())
                    for n, a, b in zip("qkv", *grads)}
            cases.append({"kernel": "flash_attention", "gradients": True,
                          "shape": [S, S, K, G, hd], "dtype": "torch.float32",
                          "causal": True, "window": window,
                          "max_err_over_largest": errs,
                          "max_abs_err": max(float((a - b).abs().max())
                                             for a, b in zip(*grads)),
                          "tol": FLASH_GRAD_TOL,
                          "ok": max(errs.values()) <= FLASH_GRAD_TOL})
    return cases


def ssd_inputs(b, s, h, p, n, dtype, dev, g: torch.Generator,
               a_scale: float = 1.0):
    """B4's inputs: x, B, C normal in ``dtype``, a = -a_scale *
    softplus(normal) in f32 (a log-decay, as ``tests/test_kernels.py``
    draws it for ``a_scale`` 1)."""
    x = torch.randn(b, s, h, p, generator=g).to(dev, dtype)
    a = -a_scale * torch.nn.functional.softplus(torch.randn(b, s, h,
                                                            generator=g))
    B = torch.randn(b, s, n, generator=g).to(dev, dtype)
    C = torch.randn(b, s, n, generator=g).to(dev, dtype)
    return x, a.to(dev), B, C


def ssd_error_scale(x, a, B, C, chunk: int):
    """B4's plain version on ``|x|``, ``|B|``, ``|C|`` in f32: for each output
    (y and the final state), the sum of the magnitudes of the terms that
    make it up (the decays are positive), the scale of the rounding error of
    any f32 sum of them, whatever its order."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    return ssd_scan_plain(x.float().abs(), a, B.float().abs(),
                          C.float().abs(), chunk)


def ssd_cases(dev, g: torch.Generator) -> list[dict]:
    """B4 against its plain version on the card: the shapes of
    ``tests/test_kernels.py``, a ragged s = 1000, the serving shape, 64
    chunks (s = 4096, the state carried far), a near 0 (decay about 1,
    the state grows: its f32 tolerance is the tightest) and a chunk of 48,
    not a multiple of the bf16 kernel's 16-step tiles, with a ragged s."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    cases = []
    shapes = [(2, 64, 2, 8, 4, 16, 1.0), (2, 128, 4, 64, 16, 64, 1.0),
              (2, 96, 1, 16, 8, 32, 1.0), (2, 1000, 2, 64, 128, 64, 1.0),
              (*SSD_MAIN, 1.0), (1, 4096, 2, 64, 128, 64, 1.0),
              (2, 2048, 2, 64, 128, 64, 1e-4), (2, 100, 2, 64, 128, 48, 1.0)]
    for b, s, h, p, n, chunk, a_scale in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, a, B, C = ssd_inputs(b, s, h, p, n, dtype, dev, g, a_scale)
            y, st = ssd_scan(x, a, B, C, chunk)
            ye, ste = ssd_scan_plain(x, a, B, C, chunk)
            y_scale, st_scale = ssd_error_scale(x, a, B, C, chunk)
            e = errors(y, ye, f"ssd_scan.{str(dtype).split('.')[1]}", y_scale)
            # the final state is f32 in both dtypes
            e["state"] = errors(st, ste, "ssd_scan.float32", st_scale)
            e["ok"] = e["ok"] and e["state"]["ok"]
            cases.append({"kernel": "ssd_scan", "shape": [b, s, h, p, n, chunk],
                          "a_scale": a_scale, "dtype": str(dtype), **e})
    return cases + ssd_grad_cases(dev, g)


def ssd_grad_cases(dev, g: torch.Generator) -> list[dict]:
    """B4 under autograd (its forward, the backward autograd of the plain
    version recomputed from the inputs) against autograd through the plain
    version on the card, f32 and bf16, a loss on y alone and on y and the
    final state: the same backward from the same inputs, so the gradients
    agree within 1e-6 of the largest."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    cases = []
    b, s, h, p, n, chunk = 2, 300, 4, 64, 128, 64
    for dtype in (torch.float32, torch.bfloat16):
        base = ssd_inputs(b, s, h, p, n, dtype, dev, g)
        dy = torch.randn(b, s, h, p, generator=g).to(dev)
        dst = torch.randn(b, h, p, n, generator=g).to(dev)
        for use_state in (False, True):
            grads = []
            for fn in (ssd_scan, ssd_scan_plain):
                ins = [t.detach().clone().requires_grad_() for t in base]
                y, st = fn(*ins, chunk)
                loss = (y.float() * dy).sum()
                if use_state:
                    loss = loss + (st * dst).sum()
                loss.backward()
                grads.append([t.grad.float() for t in ins])
            errs = {k: float((a - e).abs().max() / e.abs().max())
                    for k, a, e in zip(("x", "a", "B", "C"), *grads)}
            cases.append({"kernel": "ssd_scan", "gradients": True,
                          "shape": [b, s, h, p, n, chunk], "dtype": str(dtype),
                          "use_state": use_state,
                          "max_err_over_largest": errs,
                          "max_abs_err": max(float((a - e).abs().max())
                                             for a, e in zip(*grads)),
                          "tol": 1e-6, "ok": max(errs.values()) <= 1e-6})
    return cases


def gravity_forces(P: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """``examples/quickstart.py``'s numpy forces, in float64."""
    d = P[None, :, :] - P[lo:hi, None, :]
    r2 = (d * d).sum(-1) + 1e-3
    return (d / r2[..., None] ** 1.5).sum(1)


def wave_step_f64(um: np.ndarray, u: np.ndarray, c: float) -> np.ndarray:
    """``examples/wavesim.py``'s numpy step, in float64 on the whole field."""
    un = np.zeros_like(u)
    un[1:-1, 1:-1] = (2 * u[1:-1, 1:-1] - um[1:-1, 1:-1] + c * (
        u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:]
        - 4 * u[1:-1, 1:-1]))
    return un


def body_energies_f64(P: np.ndarray, V: np.ndarray, mass: float,
                      eps: float = 1e-3) -> np.ndarray:
    """``examples/nbody.py``'s per-body energies in float64 numpy, on all
    rows."""
    d = P[None, :, :] - P[:, None, :]
    r2 = (d * d).sum(-1) + eps
    pot = -0.5 * mass * mass / np.sqrt(r2)
    np.fill_diagonal(pot, 0.0)                   # no self-interaction
    kin = 0.5 * mass * (V ** 2).sum(-1)
    return kin + pot.sum(1)


def reference_energies() -> tuple[bool, dict]:
    """``examples/nbody.py``'s energy program (N = 512, 8 steps, E and Mx
    every 4) on 1 x 1, 2 x 2, 3 x 1 and 2 x 2 unfused: positions within
    1e-4 of the float64 program, E, Mx and positions bit-identical across
    the grids, E and Mx bitwise equal to math.fsum of numpy's per-body
    energies and momenta of the port's gathered state, one reduction
    exchange per energy step fused and two unfused."""
    from repro_torch.apps import NBody
    from repro_torch.core import Runtime
    from repro_torch.core.collective import allreduce_message_count
    n, steps, every, dt, mass = 512, 8, 4, 0.01, 1.0
    rng = np.random.default_rng(42)
    P0, V0 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3)) * 0.1
    runs = {}
    for nodes, devices, fusion in ((1, 1, True), (2, 2, True), (3, 1, True),
                                   (2, 2, False)):
        with Runtime(nodes, devices, device="cuda",
                     reduction_fusion=fusion) as rt:
            sim = NBody(rt, P0, V0, dt, mass)
            sim.advance(steps, energy_every=every)
            E, Mx = sim.energy()
            P, V = sim.gather(), sim.gather_velocities()
            group = tuple(range(nodes))
            per = allreduce_message_count(group, group, 1) if nodes > 1 else 0
            exchanges = rt.comm_stats()["red_messages"] // per if per else 0
            warnings = rt.warnings
        runs[f"{nodes}x{devices}" + ("" if fusion else " unfused")] = dict(
            E=E, Mx=Mx, P=P, V=V, exchanges=exchanges, warnings=warnings,
            want=0 if nodes == 1 else steps // every * (1 if fusion else 2))
    P, V = P0, V0
    for _ in range(steps):
        V = V + gravity_forces(P, 0, n) * dt
        P = P + V * dt
    first = next(iter(runs.values()))
    e_np = math.fsum(body_energies_f64(first["P"], first["V"], mass))
    mx_np = math.fsum(mass * first["V"][:, 0])
    out, ok = {}, True
    for name, r in runs.items():
        err = float(np.abs(r["P"] - P).max())
        same = (bool(np.array_equal(r["P"], first["P"]))
                and bool(np.array_equal(r["V"], first["V"]))
                and (r["E"], r["Mx"]) == (first["E"], first["Mx"]))
        row = {"E": r["E"], "Mx": r["Mx"], "positions_max_abs_err": err,
               "bit_identical_across_grids": same,
               "E_equals_numpy_fsum": r["E"] == e_np,
               "Mx_equals_numpy_fsum": r["Mx"] == mx_np,
               "exchanges": r["exchanges"], "exchanges_expected": r["want"]}
        ok &= (err <= 1e-4 * np.abs(P).max() and same and r["E"] == e_np
               and r["Mx"] == mx_np and r["exchanges"] == r["want"]
               and not r["warnings"])
        out[name] = row
    return ok, {"bodies": n, "steps": steps, "energy_every": every,
                "E_numpy_fsum": e_np, "Mx_numpy_fsum": mx_np, "runs": out}


def budget_check(run, nodes: int, devices: int) -> tuple[list, dict]:
    """``run(rt)`` on the card unbudgeted, then with the device budget at
    50% of its device high-water mark; the budgeted results and a report
    (the check of results is the caller's)."""
    from repro_torch.core import Runtime
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Runtime(nodes, devices, device="cuda") as rt:
        base = run(rt)
        hwm = rt.device_peak_bytes()
        warnings = list(rt.warnings)
    t1 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    budget = hwm // 2
    with Runtime(nodes, devices, device="cuda",
                 device_memory_budget=budget) as rt:
        out = run(rt)
        reports = rt.memory_report()
        peak = rt.device_peak_bytes()
        warnings += rt.warnings
    t2 = time.perf_counter()
    spills = sum(r["spills"] for r in reports)
    reloads = sum(r["reloads"] for r in reports)
    rep = {"grid": [nodes, devices], "unbudgeted_peak_bytes": hwm,
           "budget_bytes": budget, "device_peak_bytes": peak,
           "spills": spills, "reloads": reloads,
           "evictions": sum(r["evictions"] for r in reports),
           "torch_max_memory_allocated": torch.cuda.max_memory_allocated(),
           "unbudgeted_s": t1 - t0, "budgeted_s": t2 - t1,
           "warnings": warnings,
           "ok": (peak <= budget and spills > 0 and reloads > 0
                  and not warnings)}
    return [base, out], rep


def nbody_budget(bodies: int, steps: int, dt: float, mass: float,
                 dtype) -> dict:
    """``examples/nbody.py``'s budget demo (three phased simulations, 1 x 1)
    on the card."""
    from repro_torch.apps.nbody import budget_program
    inits = []
    for i in range(3):
        rng = np.random.default_rng(100 + i)
        inits.append((rng.normal(size=(bodies, 3)).astype(dtype),
                      (rng.normal(size=(bodies, 3)) * 0.1).astype(dtype)))
    (base, out), rep = budget_check(
        lambda rt: budget_program(rt, inits, steps, dt, mass), 1, 1)
    rep.update(bodies=bodies, steps=steps, dtype=np.dtype(dtype).name,
               energies=out, equal_to_unbudgeted=out == base)
    rep["ok"] = (rep["ok"] and out == base
                 and all(math.isfinite(e) for e in out))
    return rep


def wave_budget(H: int, W: int, steps: int, dtype) -> dict:
    """``examples/wavesim.py``'s budget demo (three interleaved simulations,
    2 x 2) on the card; each residual also against the fsum of its
    gathered fields."""
    from repro_torch.apps.wavesim import budget_program
    (base, out), rep = budget_check(
        lambda rt: budget_program(rt, H, W, steps, dtype=dtype),
        NODES, DEVICES)
    equal = all(np.array_equal(fb, fu) and np.array_equal(pb, pu) and rb == ru
                for (fb, pb, rb), (fu, pu, ru) in zip(out, base))
    t0 = time.perf_counter()
    fsum = [math.fsum(((f - p) ** 2).ravel()) == r for f, p, r in out]
    rep.update(field=[H, W], steps=steps, dtype=np.dtype(dtype).name,
               residuals=[r for _, _, r in out], equal_to_unbudgeted=equal,
               residuals_equal_fsum=fsum, fsum_s=time.perf_counter() - t0)
    rep["ok"] = rep["ok"] and equal and all(fsum)
    return rep


def phase_reference() -> None:
    """The examples' own small configurations through the port on the card
    (float64 storage) against their float64 numpy programs."""
    from repro_torch.apps import WaveSim, run_nbody
    from repro_torch.core import Runtime
    # examples/quickstart.py: N = 1024, 10 steps, seed 42.  The kernel
    # computes forces in f32 (as the TPU kernel does), and close encounters
    # (soft = 1e-3) amplify that rounding: positions agree to 1e-4 of their
    # scale (8.5e-5 absolute for the plain version on the CPU).
    rng = np.random.default_rng(42)
    P0, V0 = rng.normal(size=(1024, 3)), rng.normal(size=(1024, 3)) * 0.1
    with Runtime(NODES, DEVICES, device="cuda") as rt:
        got = run_nbody(rt, P0, V0, 10, 0.01, 1.0)
    P, V = P0, V0
    for _ in range(10):
        V = V + gravity_forces(P, 0, len(P)) * 0.01
        P = P + V * 0.01
    nbody_err, nbody_tol = float(np.abs(got - P).max()), 1e-4 * np.abs(P).max()
    # examples/wavesim.py: a 256 x 128 splash, 20 steps, error under 1e-4,
    # and the residual of the two newest fields
    u1 = np.zeros((256, 128))
    u1[124:132, 60:68] = 1.0
    with Runtime(NODES, DEVICES, device="cuda") as rt:
        sim = WaveSim(rt, u1.copy(), u1, WAVE_C)
        sim.advance(20)
        sim.residual()
        gotw, prevw = sim.gather(), sim.gather_previous()
        res2 = sim.residual_value()
    um, u = u1, u1
    for _ in range(20):
        um, u = u, wave_step_f64(um, u, WAVE_C)
    wave_err = float(np.abs(gotw - u).max())
    res2_fsum = math.fsum(((gotw - prevw) ** 2).ravel())
    energies_ok, energies = reference_energies()
    budget_nbody = nbody_budget(256, 8, 0.01, 1.0, np.float64)
    budget_wave = wave_budget(128, 64, 12, np.float64)
    ok = (nbody_err <= nbody_tol and wave_err < 1e-4 and res2 == res2_fsum
          and energies_ok and budget_nbody["ok"] and budget_wave["ok"])
    emit({"phase": "reference", "ok": ok,
          "nbody": {"bodies": 1024, "steps": 10, "max_abs_err": nbody_err,
                    "tol": nbody_tol},
          "wavesim": {"field": [256, 128], "steps": 20,
                      "max_abs_err": wave_err, "tol": 1e-4,
                      "residual": res2, "residual_equals_fsum":
                      res2 == res2_fsum},
          "nbody_energy": energies, "nbody_budget": budget_nbody,
          "wavesim_budget": budget_wave})
    if not ok:
        raise SystemExit("the examples disagree with their float64 programs")


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import (flash_attention, nbody_forces_rows,
                                     ssd_scan, ssd_state_pass, wave_step_rows)
    nbody_forces_rows.launches = wave_step_rows.launches = 0
    flash_attention.launches = ssd_scan.launches = 0
    ssd_state_pass.launches = 0


def timed_run(sim, steps: int, measure_every: int = 0,
              measure=None) -> tuple[np.ndarray, dict, list]:
    """Run ``sim`` (an ``NBody`` or a ``WaveSim`` on its runtime) for
    ``steps`` steps; time the first step, the steps after it and the gather,
    each window ended by a sync.  With ``measure_every``, ``measure()``
    follows every step whose count is a multiple of it, outside the steps'
    windows; what it returns is collected in order."""
    t0 = time.perf_counter()
    sim.advance(1)
    sim.rt.sync()
    t1 = time.perf_counter()
    steps_s, measured, done = 0.0, [], 1
    while done < steps:
        k = steps - done
        if measure_every:
            k = min(k, measure_every - done % measure_every)
        ta = time.perf_counter()
        sim.advance(k)
        sim.rt.sync()
        steps_s += time.perf_counter() - ta
        done += k
        if measure_every and done % measure_every == 0:
            measured.append(measure())
    t2 = time.perf_counter()
    out = sim.gather()
    t3 = time.perf_counter()
    return out, {"first_step_s": t1 - t0, "steps_s": steps_s,
                 "gather_s": t3 - t2, "total_s": t3 - t0,
                 "steps_per_s": (steps - 1) / steps_s}, measured


def nbody_energy_run(nodes: int, devices: int, P0: np.ndarray,
                     V0: np.ndarray) -> dict:
    """``NBODY_STEPS`` steps of the N-body on a grid, E and Mx reduced every
    ``ENERGY_EVERY`` steps (each reduction timed apart: ``measure()`` then
    ``rt.sync()``; the gathers of E and Mx come after the window)."""
    from repro_torch.apps import NBody
    from repro_torch.core import Runtime
    from repro_torch.kernels.nbody import nbody_forces_rows
    with Runtime(nodes, devices, device="cuda") as rt:
        sim = NBody(rt, P0, V0, DT, MASS)

        def measure():
            """One energy step, timed (submit, then sync); then E and Mx."""
            t0 = time.perf_counter()
            sim.measure()
            rt.sync()
            return time.perf_counter() - t0, sim.energy()

        reset_launches()
        got, times, measured = timed_run(sim, NBODY_STEPS, ENERGY_EVERY,
                                         measure)
        launches = nbody_forces_rows.launches
        times["energy_step_s"] = [t for t, _ in measured]
        return {"P": got, "energies": [e for _, e in measured],
                "times": times,
                "launches": launches, "comm": rt.comm_stats(),
                "instructions": rt.total_instructions(),
                "warnings": list(rt.warnings)}


def phase_nbody(dev) -> dict:
    from repro_torch.apps import body_energies
    from repro_torch.core.collective import allreduce_message_count
    from repro_torch.kernels.nbody import nbody_forces_rows
    rng = np.random.default_rng(SEED)
    P0 = rng.standard_normal((NBODY_N, 3), dtype=np.float32)
    V0 = (rng.standard_normal((NBODY_N, 3), dtype=np.float32) * 0.1)
    main = nbody_energy_run(NODES, DEVICES, P0, V0)
    launches = main["launches"]
    others = {f"{n}x{d}": nbody_energy_run(n, d, P0, V0)
              for n, d in ((1, 1), (3, 1))}
    # the same steps without the runtime: B1 on the whole array, the same
    # torch update expressions; E and Mx as math.fsum of the per-body
    # energies and momenta computed on the whole range
    P, V = torch.from_numpy(P0).to(dev), torch.from_numpy(V0).to(dev)
    exp_energies = []
    t0 = time.perf_counter()
    for s in range(1, NBODY_STEPS + 1):
        F = nbody_forces_rows(P, 0, NBODY_N)
        V = V + MASS * F * DT
        P = P + V * DT
        if s % ENERGY_EVERY == 0:
            e = body_energies(P, V, 0, NBODY_N, MASS).cpu().numpy()
            mx = (MASS * V[:, 0]).cpu().numpy()
            exp_energies.append((math.fsum(e), math.fsum(mx)))
    runtime_free_s = time.perf_counter() - t0
    exp = P.cpu().numpy()
    got = main["P"]
    identical = bool(np.array_equal(got, exp))
    finite = bool(np.isfinite(got).all()) and got.shape == (NBODY_N, 3)
    energies_equal = main["energies"] == exp_energies
    grids_equal = {k: bool(np.array_equal(r["P"], got))
                   and r["energies"] == main["energies"]
                   for k, r in others.items()}
    group = tuple(range(NODES))
    want_msgs = (NBODY_STEPS // ENERGY_EVERY
                 * allreduce_message_count(group, group, 1))
    warnings = main["warnings"] + [w for r in others.values()
                                   for w in r["warnings"]]
    ok = (identical and finite and launches > 0 and energies_equal
          and all(grids_equal.values())
          and main["comm"]["red_messages"] == want_msgs and not warnings)
    res = {"phase": "nbody", "ok": ok, "grid": [NODES, DEVICES],
           "bodies": NBODY_N, "steps": NBODY_STEPS, "dtype": "float32",
           "energy_every": ENERGY_EVERY,
           "bit_identical_to_runtime_free": identical,
           "max_abs_diff": float(np.abs(got - exp).max()),
           "energies": main["energies"],
           "energies_equal_runtime_free_fsum": energies_equal,
           "grids_bit_identical": grids_equal,
           "red_messages": main["comm"]["red_messages"],
           "red_messages_expected": want_msgs,
           "launches": launches, **main["times"],
           "other_grids_s": {k: r["times"]["total_s"]
                             for k, r in others.items()},
           "runtime_free_s": runtime_free_s,
           "instructions": main["instructions"],
           "comm_bytes": main["comm"]["bytes"],
           "comm_messages": main["comm"]["messages"], "warnings": warnings}
    emit(res)
    if not ok:
        raise SystemExit("N-body phase failed")
    return res


def phase_wave(dev) -> dict:
    from repro_torch.apps import WaveSim
    from repro_torch.core import Runtime
    from repro_torch.kernels.stencil5 import wave_step_rows
    rng = np.random.default_rng(SEED + 1)
    u0 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)
    u1 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)
    torch.cuda.reset_peak_memory_stats()
    with Runtime(NODES, DEVICES, device="cuda") as rt:
        sim = WaveSim(rt, u0, u1, WAVE_C)
        reset_launches()
        got, times, _ = timed_run(sim, WAVE_STEPS)
        launches = wave_step_rows.launches
        comm = rt.comm_stats()
        device_peak = rt.device_peak_bytes()
        # the residual of the two newest fields, outside the step window
        t0 = time.perf_counter()
        sim.residual()
        rt.sync()
        residual_s = time.perf_counter() - t0
        res2 = sim.residual_value()
        prev = sim.gather_previous()
        warnings = list(rt.warnings)
    torch_peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    res2_fsum = math.fsum(((got - prev) ** 2).ravel())
    fsum_s = time.perf_counter() - t0
    um, u = torch.from_numpy(u0).to(dev), torch.from_numpy(u1).to(dev)
    for _ in range(WAVE_STEPS):
        um, u = u, wave_step_rows(um, u, 0, WAVE_H, WAVE_C)
    exp = u.cpu().numpy()
    identical = bool(np.array_equal(got, exp))
    finite = bool(np.isfinite(got).all()) and got.shape == (WAVE_H, WAVE_W)
    ok = (identical and finite and launches > 0 and res2 == res2_fsum
          and not warnings)
    res = {"phase": "wavesim", "ok": ok, "grid": [NODES, DEVICES],
           "field": [WAVE_H, WAVE_W], "steps": WAVE_STEPS, "dtype": "float32",
           "bit_identical_to_runtime_free": identical,
           "max_abs_diff": float(np.abs(got - exp).max()),
           "launches": launches, **times,
           "residual": res2, "residual_equals_fsum": res2 == res2_fsum,
           "residual_s": residual_s, "residual_fsum_s": fsum_s,
           "comm_bytes_sent": comm["bytes"], "comm_messages": comm["messages"],
           "device_peak_bytes": device_peak,
           "torch_max_memory_allocated": torch_peak, "warnings": warnings}
    emit(res)
    if not ok:
        raise SystemExit("WaveSim phase failed")
    return res


def phase_budget() -> dict:
    """Both budget demos on the card at sizes where the spills move real
    bytes."""
    nbody = nbody_budget(BUDGET_BODIES, BUDGET_NBODY_STEPS, DT, MASS,
                         np.float32)
    wave = wave_budget(*BUDGET_FIELD, BUDGET_WAVE_STEPS, np.float32)
    ok = nbody["ok"] and wave["ok"]
    res = {"phase": "budget", "ok": ok, "nbody": nbody, "wavesim": wave}
    emit(res)
    if not ok:
        raise SystemExit("budget phase failed")
    return res


def phase_lookahead() -> dict:
    """RSim on the card with lookahead on and off, against the CPU port's
    allocation counts for the same program and a float64 recurrence."""
    from repro_torch.apps import run_rsim
    runs = {}
    for device in ("cuda", "cpu"):
        for la in (True, False):
            t0 = time.perf_counter()
            field, allocs, stats = run_rsim(RSIM_T, RSIM_W, lookahead=la,
                                            dtype=np.float32, device=device)
            runs[(device, la)] = dict(
                field=field, allocs=allocs, wall_s=time.perf_counter() - t0,
                flushes=stats.flushes,
                commands_queued_peak=stats.commands_queued_peak)
    rec = np.empty(RSIM_T)
    total = 0.0
    for t in range(RSIM_T):
        rec[t] = 1.0 if t == 0 else total * 0.5 + 1.0
        total += rec[t]
    on, off = runs[("cuda", True)]["field"], runs[("cuda", False)]["field"]
    rel = float((np.abs(on - rec[:, None]) / rec[:, None]).max())
    counts = {f"{d}/{'on' if la else 'off'}": r["allocs"]
              for (d, la), r in runs.items()}
    ok = (counts["cuda/on"] == counts["cpu/on"]
          and counts["cuda/off"] == counts["cpu/off"]
          and counts["cuda/on"] < counts["cuda/off"]
          and bool(np.allclose(on, off, rtol=1e-6, atol=0))
          and rel <= RSIM_RTOL and on.shape == (RSIM_T, RSIM_W))
    res = {"phase": "lookahead", "ok": ok, "T": RSIM_T, "W": RSIM_W,
           "grid": [1, 2], "dtype": "float32", "allocations": counts,
           "on_off_bitwise": bool(np.array_equal(on, off)),
           "max_rel_err_vs_recurrence": rel, "rtol": RSIM_RTOL,
           **{f"{d}_{'on' if la else 'off'}": {k: v for k, v in r.items()
                                                if k != "field"}
              for (d, la), r in runs.items()}}
    emit(res)
    if not ok:
        raise SystemExit("lookahead phase failed")
    return res


def percentiles(xs: list[float]) -> dict:
    """p50 and p99 of per-window latencies, in ms (the launcher's rule)."""
    s = sorted(xs)
    return {"p50_ms": s[len(s) // 2] * 1e3,
            "p99_ms": s[min(len(s) - 1, int(len(s) * 0.99))] * 1e3}


def memo_counts(stats: dict) -> dict:
    return {"hits": int(stats["hits"]), "misses": int(stats["misses"]),
            "unreplayable": int(stats["unreplayable"]),
            "tenants": {n: [t["lowered"], t["replayed"]]
                        for n, t in sorted(stats["tenants"].items())}}


def served_run(device: str, kw: dict, u0, u1, P0, V0,
               wait: bool = True) -> dict:
    """One ``serve_simulations`` run on a ServingRuntime(NODES, DEVICES)."""
    from repro_torch.apps import serve_simulations
    from repro_torch.core import ServingRuntime
    from repro_torch.kernels import nbody_forces_rows, wave_step_rows
    mass = 1.0 / P0.shape[0]
    with ServingRuntime(NODES, DEVICES, device=device, **kw) as srv:
        reset_launches()
        t0 = time.perf_counter()
        out = serve_simulations(srv, u0, u1, P0, V0,
                                wave_windows=SERVE_RT_WAVE_WINDOWS,
                                nbody_windows=SERVE_RT_NBODY_WINDOWS,
                                dt=DT, mass=mass, c=WAVE_C, wait=wait)
        wall = time.perf_counter() - t0
        launches = {"nbody_forces_rows": nbody_forces_rows.launches,
                    "wave_step_rows": wave_step_rows.launches}
        stats = srv.memo_stats()
        verified = None
        if srv.verifier is not None:
            # raises VerificationError on any issue
            rep = srv.verify_now()
            verified = {"ok": rep.ok, "instructions": rep.instructions}
        peak = max((v for ex in srv.executors
                    for mid, v in ex.mem_peak.items() if mid >= 2), default=0)
    return {"out": out, "wall_s": wall, "launches": launches,
            "counts": memo_counts(stats), "patch_us": stats["patch_us"],
            "verified": verified, "device_peak_bytes": peak}


def exchange_windows(device: str, reads: str, cap) -> dict:
    """Fault C5's program on ``ServingRuntime(2, 1,
    max_inflight_per_tenant=cap)``: one tenant, float64 buffers A = 0..63
    and B, window 1 ``B <- A + 1`` and window 2 ``A <- B + 1``, each
    reading its source through ``reads`` (so each node receives the other
    node's half), then A gathered."""
    from repro_torch.core import (ServingRuntime, all_range, neighborhood,
                                  one_to_one, read, write)
    mapper = neighborhood((1,)) if reads == "neighborhood" else all_range()
    t0 = time.perf_counter()
    with ServingRuntime(2, 1, max_inflight_per_tenant=cap,
                        device=device) as srv:
        t = srv.tenant("t0")
        a = t.buffer((64,), init=np.arange(64, dtype=np.float64), name="A")
        b = t.buffer((64,), init=np.zeros(64), name="B")
        for src, dst in ((a, b), (b, a)):
            t.submit(f"{dst.name} <- {src.name} + 1", (64,),
                     [read(src, mapper), write(dst, one_to_one())],
                     lambda c, sv, dv: dv.set(c, sv.get(c) + 1.0))
            t.run()
        out = t.gather(a)
        t.drain()
        inflight = [v for ex in srv.executors
                    for v in ex._tenant_inflight.values()]
    return {"A": out, "inflight_after": inflight,
            "seconds": time.perf_counter() - t0}


def admission_cap_case(dev) -> dict:
    """Fault C5 on the card: the exchanging program with a cap of 1, run on
    a daemon thread joined after C5_DEADLINE_S, against the uncapped run,
    for ``neighborhood`` and ``all_range`` reads."""
    import threading
    out = {}
    for reads in ("neighborhood", "all_range"):
        box = {}

        def capped():
            try:
                box["run"] = exchange_windows(dev.type, reads, 1)
            except Exception as e:           # reported below
                box["error"] = repr(e)

        th = threading.Thread(target=capped, daemon=True)
        th.start()
        th.join(C5_DEADLINE_S)
        if th.is_alive() or "error" in box:
            out[reads] = {"ok": False, "finished": not th.is_alive(),
                          "error": box.get("error"),
                          "deadline_s": C5_DEADLINE_S}
            continue
        got, want = box["run"], exchange_windows(dev.type, reads, None)
        checks = {
            "bytes_equal_uncapped": bool(np.array_equal(got["A"],
                                                        want["A"])),
            "values": bool(np.array_equal(want["A"],
                                          np.arange(64) + 2.0)),
            "inflight_drained": all(v == 0 for v in got["inflight_after"])}
        out[reads] = {"ok": all(checks.values()), **checks,
                      "capped_s": got["seconds"],
                      "uncapped_s": want["seconds"],
                      "deadline_s": C5_DEADLINE_S}
    return out


def pipelined_runs(dev, u0, u1, P0, V0, exp_field, exp_P, small) -> dict:
    """Fault C6 on the card: both tenants with clients that submit every
    window and then drain, memo on, one and two windows in flight
    (``SERVE_RT_PIPELINED_DEPTHS`` in turns), renaming off and on.  Each
    run's results bitwise equal to the runtime-free steps, its memo counts
    equal to the CPU port's for the same runtime and window sequence at a
    small size, B2 and B1 launched windows x devices times.  Prints windows
    per second (after the first window, which seeds the buffers) at depth
    2 against depth 1 beside the card's name and power limit."""
    want_launches = {"nbody_forces_rows":
                     SERVE_RT_NBODY_WINDOWS * NODES * DEVICES,
                     "wave_step_rows": SERVE_RT_WAVE_WINDOWS * NODES * DEVICES}
    windows = {"wave": SERVE_RT_WAVE_WINDOWS, "nbody": SERVE_RT_NBODY_WINDOWS}
    out, ok = {}, True
    for renaming in (False, True):
        name = "renaming" if renaming else "plain"
        runs, rates = [], {1: [], 2: []}
        for depth in SERVE_RT_PIPELINED_DEPTHS:
            kw = dict(memo=True, renaming=renaming,
                      max_inflight_windows=depth)
            cpu = served_run("cpu", kw, *small, wait=False)
            r = served_run(dev.type, kw, u0, u1, P0, V0, wait=False)
            checks = {
                "wave_bit_identical_to_runtime_free": bool(np.array_equal(
                    r["out"]["wave"]["field"], exp_field)),
                "nbody_bit_identical_to_runtime_free": bool(np.array_equal(
                    r["out"]["nbody"]["P"], exp_P)),
                "memo_counts_equal_cpu": r["counts"] == cpu["counts"],
                "launches_equal_windows_x_devices":
                    r["launches"] == want_launches}
            ok = ok and all(checks.values())
            # windows 1..N-1: the first window seeds the buffers
            rate = {t: (windows[t] - 1) / r["out"][t]["seconds"]
                    for t in windows}
            rates[depth].append(rate)
            runs.append({"depth": depth, **checks, "windows_per_s": rate,
                         "seconds": {t: r["out"][t]["seconds"]
                                     for t in windows},
                         "wall_s": r["wall_s"], "memo_counts": r["counts"],
                         "memo_counts_cpu": cpu["counts"]})
        best = {d: {t: max(x[t] for x in rates[d]) for t in windows}
                for d in rates}
        out[name] = {"runs": runs, "best_windows_per_s": best,
                     "depth2_over_depth1": {t: best[2][t] / best[1][t]
                                            for t in windows}}
    out["ok"] = ok
    smi = out["nvidia_smi"] = nvidia_smi()
    for name in ("plain", "renaming"):
        b = out[name]["best_windows_per_s"]
        print(f"serving-runtime pipelined ({name}, no-wait clients, best of "
              f"2): wave {b[1]['wave']:.2f} -> {b[2]['wave']:.2f} windows/s, "
              f"nbody {b[1]['nbody']:.2f} -> {b[2]['nbody']:.2f} windows/s "
              f"(depth 1 -> 2) on {smi}", flush=True)
    return out


def phase_serving_runtime(dev) -> dict:
    """Two tenants on ServingRuntime(NODES, DEVICES) on the card, memo on,
    off, and on with renaming, two windows in flight and the sanitizer;
    each run's results bitwise against the same steps without the runtime,
    its memo counts against the CPU port's on the same window sequence;
    then the pipelined runs of clients that do not wait
    (``pipelined_runs``) and fault C5's case (``admission_cap_case``)."""
    t_phase = time.perf_counter()
    from repro_torch.kernels.nbody import nbody_forces_rows
    from repro_torch.kernels.stencil5 import wave_step_rows
    rng = np.random.default_rng(SEED + 4)
    u0 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)
    u1 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)
    P0 = rng.standard_normal((NBODY_N, 3), dtype=np.float32)
    V0 = rng.standard_normal((NBODY_N, 3), dtype=np.float32) * 0.1
    # the same steps without the runtime: B2 and B1 on the whole arrays
    um, u = torch.from_numpy(u0).to(dev), torch.from_numpy(u1).to(dev)
    for _ in range(SERVE_RT_WAVE_WINDOWS):
        um, u = u, wave_step_rows(um, u, 0, WAVE_H, WAVE_C)
    exp_field = u.cpu().numpy()
    P, V = torch.from_numpy(P0).to(dev), torch.from_numpy(V0).to(dev)
    mass = 1.0 / NBODY_N
    for _ in range(SERVE_RT_NBODY_WINDOWS):
        F = nbody_forces_rows(P, 0, NBODY_N)
        V = V + mass * F * DT
        P = P + V * DT
    exp_P = P.cpu().numpy()
    del um, u, P, V, F
    # the CPU port's counts for the same window sequence, at a small size
    small = np.random.default_rng(SEED + 5)
    su0 = small.standard_normal((64, 32), dtype=np.float32)
    sP0 = small.standard_normal((64, 3), dtype=np.float32)
    runs, ok = {}, True
    for name, kw in SERVE_RT_RUNS.items():
        cpu = served_run("cpu", kw, su0, su0 * 0.5, sP0, sP0 * 0.1)
        torch.cuda.reset_peak_memory_stats()
        r = served_run(dev.type, kw, u0, u1, P0, V0)
        field = r["out"]["wave"]["field"]
        pos = r["out"]["nbody"]["P"]
        want_launches = {"nbody_forces_rows":
                         SERVE_RT_NBODY_WINDOWS * NODES * DEVICES,
                         "wave_step_rows":
                         SERVE_RT_WAVE_WINDOWS * NODES * DEVICES}
        checks = {
            "wave_bit_identical_to_runtime_free":
                bool(np.array_equal(field, exp_field)),
            "nbody_bit_identical_to_runtime_free":
                bool(np.array_equal(pos, exp_P)),
            "memo_counts_equal_cpu": r["counts"] == cpu["counts"],
            "launches_equal_windows_x_devices":
                r["launches"] == want_launches,
            "finite": bool(np.isfinite(field).all() and np.isfinite(pos).all()),
            "verified": r["verified"] is None or r["verified"]["ok"]}
        ok = ok and all(checks.values())
        runs[name] = {
            **checks, "memo_counts": r["counts"],
            "memo_counts_cpu": cpu["counts"], "launches": r["launches"],
            "wall_s": r["wall_s"],
            "latency": {t: percentiles(r["out"][t]["latency_s"])
                        for t in ("wave", "nbody")},
            "first_window_ms": {t: r["out"][t]["latency_s"][0] * 1e3
                                for t in ("wave", "nbody")},
            "patch_us": r["patch_us"], "verify": r["verified"],
            "device_peak_bytes": r["device_peak_bytes"],
            "torch_max_memory_allocated": torch.cuda.max_memory_allocated()}
    pipelined = pipelined_runs(dev, u0, u1, P0, V0, exp_field, exp_P,
                               (su0, su0 * 0.5, sP0, sP0 * 0.1))
    ok = ok and pipelined["ok"]
    cap_one = admission_cap_case(dev)
    ok = ok and all(r["ok"] for r in cap_one.values())
    res = {"phase": "serving-runtime", "ok": ok, "grid": [NODES, DEVICES],
           "wave": {"field": [WAVE_H, WAVE_W],
                    "windows": SERVE_RT_WAVE_WINDOWS},
           "nbody": {"bodies": NBODY_N, "windows": SERVE_RT_NBODY_WINDOWS},
           "dtype": "float32", "runs": runs, "pipelined": pipelined,
           "admission_cap_1": cap_one,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    if not ok:
        raise SystemExit("serving-runtime phase failed")
    return res


def fault_chaos(dev) -> dict:
    """The N-body under the chaos plan against the same run fault-free.
    The plan's fates hash the transfer ids, which come from process-wide
    counters, so ``chaos_in_fresh_process`` runs this where they start from
    zero: the same messages are dropped on every run."""
    from repro_torch.apps import run_nbody
    from repro_torch.core import FaultPlan, Runtime
    rng = np.random.default_rng(SEED + 6)
    P0 = rng.standard_normal((NBODY_N, 3), dtype=np.float32)
    V0 = rng.standard_normal((NBODY_N, 3), dtype=np.float32) * 0.1
    runs = {}
    for name, plan in (("fault_free", None),
                       ("chaos", FaultPlan(**FAULT_PLAN))):
        t0 = time.perf_counter()
        with Runtime(NODES, DEVICES, device=dev.type, fault_plan=plan,
                     retransmit_timeout=FAULT_RETRANSMIT_S) as rt:
            P = run_nbody(rt, P0, V0, FAULT_NBODY_STEPS, DT, MASS)
            comm = rt.comm_stats()
            warnings = list(rt.warnings)
        runs[name] = {"P": P, "comm": comm, "warnings": warnings,
                      "seconds": time.perf_counter() - t0}
    clean, chaos = runs["fault_free"], runs["chaos"]
    logical = ("messages", "bytes")
    checks = {"bit_identical_to_fault_free":
                  bool(np.array_equal(chaos["P"], clean["P"])),
              "retries": chaos["comm"]["retries"] > 0,
              "logical_traffic_equal": all(chaos["comm"][k] == clean["comm"][k]
                                           for k in logical),
              "no_warnings": not clean["warnings"] and not chaos["warnings"]}
    return {"ok": all(checks.values()), **checks, "steps": FAULT_NBODY_STEPS,
            "device": dev.type,
            "plan": FAULT_PLAN, "retransmit_timeout_s": FAULT_RETRANSMIT_S,
            "comm_fault_free": clean["comm"], "comm_chaos": chaos["comm"],
            "seconds": {k: r["seconds"] for k, r in runs.items()}}


def chaos_in_fresh_process() -> dict:
    """``fault_chaos`` on the card in a new Python process."""
    code = ("import json, torch, chip_smoke; print(json.dumps("
            "chip_smoke.fault_chaos(torch.device('cuda', 0))))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        return {"ok": False, "returncode": r.returncode,
                "stderr_tail": r.stderr[-2000:]}
    return json.loads(r.stdout.splitlines()[-1])


def fault_crash(dev) -> dict:
    """Node 1 fail-stops in a WaveSim run: ``sync`` must raise
    ExecutionAborted naming N1 within CRASH_LIMIT_S.  The first step, which
    seeds the fields (pinned host allocations of hundreds of MB take longer
    than the watchdog's deadline), is synced before the crash can come."""
    from repro_torch.apps import WaveSim
    from repro_torch.core import ExecutionAborted, FaultPlan, Runtime
    rng = np.random.default_rng(SEED + 7)
    u0 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)
    u1 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)
    rt = Runtime(NODES, DEVICES, device=dev.type,
                 fault_plan=FaultPlan(crash={1: CRASH_AT}),
                 watchdog_timeout=WATCHDOG_S)
    err = None
    try:
        sim = WaveSim(rt, u0, u1, WAVE_C)
        sim.advance(1)
        rt.sync()
        sim.advance(CRASH_STEPS - 1)
        t0 = time.monotonic()
        try:
            rt.sync(timeout=30.0)
        except ExecutionAborted as e:   # the outcome this case asks for
            err = e
        elapsed = time.monotonic() - t0
    finally:
        rt.shutdown()
    msg = str(err) if err is not None else ""
    failures = {n: type(e).__name__ for n, e in err.failures} if err else {}
    checks = {"aborted": err is not None,
              "names_n1": "N1" in msg and failures.get(1) == "InjectedCrash",
              "within_limit": elapsed < CRASH_LIMIT_S,
              "no_leaked_threads": rt.thread_report()["total_leaked"] == 0}
    return {"ok": all(checks.values()), **checks, "seconds": elapsed,
            "limit_s": CRASH_LIMIT_S, "crash_at": CRASH_AT,
            "failures": failures, "message": msg[:400]}


def fault_supervised(dev) -> dict:
    """``Runtime.run_supervised`` of WaveSim with node 1 crashing after the
    first checkpoint: one restart on one node, the result bitwise equal to
    the same steps without the runtime."""
    from repro_torch.core import (FaultPlan, Runtime, neighborhood,
                                  one_to_one, read, write)
    from repro_torch.apps.wavesim import make_step_kernel
    from repro_torch.kernels.stencil5 import wave_step_rows
    H, W = SUPERVISED_FIELD
    rng = np.random.default_rng(SEED + 8)
    u0 = rng.standard_normal((H, W), dtype=np.float32)
    u1 = rng.standard_normal((H, W), dtype=np.float32)
    kernel = make_step_kernel(H, W, WAVE_C)

    def build(rt, init):
        snap = init or {"B0": u0, "B1": u1, "B2": np.zeros_like(u1)}
        return {k: rt.buffer((H, W), dtype=np.float32, init=v, name=k)
                for k, v in snap.items()}

    def step(rt, bufs, i):
        um, u, un = (bufs[f"B{(i + k) % 3}"] for k in range(3))
        rt.submit("wave", (H, W), [read(um, one_to_one()),
                                   read(u, neighborhood((1, 0))),
                                   write(un, one_to_one())], kernel)

    t0 = time.perf_counter()
    res = Runtime.run_supervised(
        build, step, steps=SUPERVISED_STEPS, num_nodes=NODES,
        devices_per_node=DEVICES, checkpoint_every=CHECKPOINT_EVERY,
        fault_plan=FaultPlan(crash={1: SUPERVISED_CRASH_AT}),
        watchdog_timeout=WATCHDOG_S, device=dev.type)
    seconds = time.perf_counter() - t0
    um, u = torch.from_numpy(u0).to(dev), torch.from_numpy(u1).to(dev)
    for _ in range(SUPERVISED_STEPS):
        um, u = u, wave_step_rows(um, u, 0, H, WAVE_C)
    exp = u.cpu().numpy()
    del um, u
    got = res.results[f"B{(SUPERVISED_STEPS + 1) % 3}"]
    checks = {"restarts": res.restarts == 1, "world": res.world == 1,
              "steps": res.steps == SUPERVISED_STEPS,
              "bit_identical_to_runtime_free": bool(np.array_equal(got, exp))}
    return {"ok": all(checks.values()), **checks, "restarts_seen": res.restarts,
            "world_seen": res.world, "field": [H, W],
            "checkpoint_every": CHECKPOINT_EVERY,
            "crash_at": SUPERVISED_CRASH_AT, "seconds": seconds}


def phase_faults(dev) -> dict:
    """Chaos, crash and supervised restart on the card; afterwards the
    device memory PyTorch holds is back at its level before the phase."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    chaos, crash = chaos_in_fresh_process(), fault_crash(dev)
    supervised = fault_supervised(dev)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    ok = chaos["ok"] and crash["ok"] and supervised["ok"] and after == before
    res = {"phase": "faults", "ok": ok, "grid": [NODES, DEVICES],
           "chaos": chaos, "crash": crash, "supervised": supervised,
           "memory_allocated_before": before, "memory_allocated_after": after,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    if not ok:
        raise SystemExit("faults phase failed")
    return res


def phase_scheduler_launcher() -> dict:
    """``python -m repro_torch.launch.serve --engine scheduler`` once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--engine", "scheduler", "--tenants", "4",
                        "--windows", "50", "--nodes", "2", "--devices", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=600)
    ok = (r.returncode == 0 and "(cuda)" in r.stdout
          and "results verified: every element == 50.0" in r.stdout)
    res = {"phase": "scheduler-launcher", "ok": ok,
           "returncode": r.returncode, "stdout": r.stdout.splitlines()[:8],
           "seconds": time.perf_counter() - t0,
           "stderr_tail": "" if ok else r.stderr[-2000:]}
    emit(res)
    if not ok:
        raise SystemExit("scheduler launcher failed")
    return res


def serve_reference_one(dev, arch: str) -> dict:
    """Reduced ``arch`` in float32, B3 on, against the same weights on the CPU
    (the tests hold the CPU port against the JAX package): prefill and eight
    decode steps fed the CPU run's tokens.  Checks the kernel launches of the
    card's run: B3 once per attention layer's prefill, B4 once per Mamba2
    layer's prefill."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              flash_attention=True)
    cpu = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    card = copy.deepcopy(cpu).to(dev)
    # 100 tokens: ragged against the reduced ssm_chunk of 16
    ids = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (3, 100))
    ids[0, :37] = 0                       # left-padded, as ServeLoop pads
    counters = {"flash_attention": flash_attention, "ssd_scan": ssd_scan}
    n0 = {k: f.launches for k, f in counters.items()}
    with torch.inference_mode():
        ref, ref_cache = cpu.prefill(torch.from_numpy(ids), max_len=128)
        got, cache = card.prefill(torch.from_numpy(ids).to(dev), max_len=128)
        steps = [(ref, got.cpu())]
        for _ in range(8):
            tok = ref.argmax(-1)[:, None]
            ref, ref_cache = cpu.decode_step(ref_cache, tok)
            got, cache = card.decode_step(cache, tok.to(dev))
            steps.append((ref, got.cpu()))
    launches = {k: f.launches - n0[k] for k, f in counters.items()}
    groups = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    want = {"dense": {"flash_attention": cfg.num_layers, "ssd_scan": 0},
            "ssm": {"flash_attention": 0, "ssd_scan": cfg.num_layers},
            "hybrid": {"flash_attention": groups,
                       "ssd_scan": cfg.num_layers}}[cfg.family]
    errs, compared, mismatched = [], 0, 0
    for ref, got in steps:
        errs.append(float((got - ref).abs().max()))
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > SERVE_REF_TOL
        compared += int(decided.sum())
        mismatched += int((got.argmax(-1) != ref.argmax(-1))[decided].sum())
    ok = max(errs) <= SERVE_REF_TOL and mismatched == 0 and launches == want
    return {"ok": ok, "arch": cfg.name, "family": cfg.family,
            "reduced": True, "dtype": cfg.dtype, "layers": cfg.num_layers,
            "batch": list(ids.shape), "prefill_max_abs_err": errs[0],
            "decode_max_abs_err": max(errs[1:]), "tol": SERVE_REF_TOL,
            "tokens_compared": compared, "tokens_mismatched": mismatched,
            "launches": launches, "launches_expected": want}


def phase_serve_reference(dev) -> None:
    runs = [serve_reference_one(dev, arch)
            for arch in (SERVE_ARCH, SSM_ARCH, "zamba2-7b")]
    ok = all(r["ok"] for r in runs)
    emit({"phase": "serve-reference", "ok": ok, "runs": runs})
    if not ok:
        raise SystemExit("a reduced model on the card disagrees with the CPU's")


def zoo_batch(cfg, dev, seq: int = 64) -> dict:
    """A training batch of 2 x ``seq`` tokens (with frames or image features
    for audio and vlm), drawn with numpy from SEED, on ``dev``."""
    from repro_torch.launch.inputs import train_batch
    return train_batch(cfg, 2, seq, rng=np.random.default_rng(SEED),
                       device=dev)


def zoo_forward(model, cfg, batch):
    if cfg.family in ("audio", "vlm"):
        return model.forward(batch)[0]
    return model.forward(batch["tokens"])[0]


def zoo_prefill_decode(model, cfg, batch, steps: int = 4) -> list:
    """The family's prefill step, then ``steps`` decode steps fed the
    batch's own tokens; the logits of each.  The audio prefill step gives
    logits alone, so its decode steps start from an empty cache."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    prefill = make_prefill_step(model, cfg, 96)
    decode = make_decode_step(model, cfg)
    toks = batch["tokens"]
    if cfg.family == "audio":
        out = [prefill(batch)]
        enc = model.encode(batch["frames"])
        cache = model.init_cache(toks.shape[0], 96, toks.device)
        for t in range(steps):
            logits, cache = decode(cache, toks[:, t:t + 1], enc)
            out.append(logits)
        return out
    logits, cache = prefill(batch)
    out = [logits]
    for t in range(steps):
        logits, cache = decode(cache, toks[:, t:t + 1])
        out.append(logits)
    return out


def zoo_reference_one(dev, arch: str) -> dict:
    """Reduced ``arch`` in f32 (B3 and B4 on) on the card against the same
    weights on the CPU: forward logits and prefill plus 4 decode steps
    (not for the ssm and hybrid families, which serve-reference holds), the
    loss and every gradient; the card's kernel launches."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              flash_attention=True)
    cpu = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    card = copy.deepcopy(cpu).to(dev)
    res = {"arch": cfg.name, "family": cfg.family, "reduced": True,
           "dtype": cfg.dtype, "layers": cfg.num_layers}
    serves = arch in ZOO_REF_ARCHS
    counters = {"flash_attention": flash_attention, "ssd_scan": ssd_scan}
    n0 = {k: f.launches for k, f in counters.items()}
    errs = []
    if serves:
        with torch.inference_mode():
            outs = []
            for model, d in ((cpu, "cpu"), (card, dev)):
                batch = zoo_batch(cfg, d)
                outs.append([zoo_forward(model, cfg, batch)]
                            + zoo_prefill_decode(model, cfg, batch))
        errs = [float((g.cpu() - r).abs().max()) for r, g in zip(*outs)]
        res.update(forward_max_abs_err=errs[0], prefill_max_abs_err=errs[1],
                   decode_max_abs_err=max(errs[2:]), tol=SERVE_REF_TOL)
    losses, grads = [], []
    for model, d in ((cpu, "cpu"), (card, dev)):
        model.requires_grad_(True)
        loss = model.loss(zoo_batch(cfg, d))
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad for k, p in model.named_parameters()})
    grad_err = max(float((grads[1][k].cpu() - g).abs().max()
                         / g.abs().max().clamp_min(1e-30))
                   for k, g in grads[0].items())
    launches = {k: f.launches - n0[k] for k, f in counters.items()}
    # B3 in every attention layer of a forward (the forward, the prefill
    # and the loss's; the decode steps take the einsum route), B4 in every
    # Mamba2 layer's; with cfg.remat the loss's backward runs the
    # checkpointed layers' forward again (not Zamba2's shared attention
    # block, which the JAX model does not checkpoint either)
    attn = {"moe": cfg.num_layers, "vlm": cfg.num_layers, "audio": 0,
            "ssm": 0, "hybrid": cfg.num_layers // max(cfg.attn_every, 1)}
    mamba = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    forwards = 3 if serves else 1
    again = 1 if cfg.remat else 0
    want = {"flash_attention": attn[cfg.family] * (
                forwards + (0 if cfg.family == "hybrid" else again)),
            "ssd_scan": mamba * (forwards + again)}
    loss_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    res.update(cpu_loss=losses[0], card_loss=losses[1], loss_rel_diff=loss_rel,
               loss_rtol=ZOO_LOSS_RTOL, grad_max_err_over_largest=grad_err,
               grad_tol=ZOO_GRAD_TOL, launches=launches,
               launches_expected=want)
    res["ok"] = (all(e <= SERVE_REF_TOL for e in errs)
                 and loss_rel <= ZOO_LOSS_RTOL and grad_err <= ZOO_GRAD_TOL
                 and launches == want)
    return res


def phase_zoo_reference(dev) -> None:
    runs = [zoo_reference_one(dev, arch) for arch in ZOO_TRAIN_ARCHS]
    ok = all(r["ok"] for r in runs)
    emit({"phase": "zoo-reference", "ok": ok, "runs": runs})
    if not ok:
        raise SystemExit("a reduced zoo model on the card disagrees with the "
                         "CPU's")


def logit_agreement(got: torch.Tensor, ref: torch.Tensor, tol: float) -> dict:
    """Last-token logits ``got`` against ``ref`` (``[rows, V]``): each row's
    largest difference over ``ref``'s largest magnitude, and the rows whose
    first token (the argmax) differs where ``ref``'s top-2 margin exceeds
    ``tol`` of that magnitude."""
    got, ref = got.float(), ref.float()
    scale = ref.abs().amax(-1)
    top2 = ref.topk(2, dim=-1).values
    decided = ((top2[:, 0] - top2[:, 1]) > tol * scale).tolist()
    differ = (got.argmax(-1) != ref.argmax(-1)).tolist()
    return {"last_logit_err_over_max":
                ((got - ref).abs().amax(-1) / scale).tolist(),
            "tol": tol, "first_token_decided": decided,
            "first_token_mismatched": [i for i, (d, x) in
                                       enumerate(zip(decided, differ))
                                       if d and x],
            "finite": bool(torch.isfinite(got).all()
                           and torch.isfinite(ref).all())}


def serve_prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(SEED)
    lo, hi = SERVE_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, size=SERVE_REQUESTS)
    return [rng.integers(0, vocab, size=int(n)) for n in lens]


def serve_once(cfg, model, prompts, dev) -> dict:
    """Serve ``prompts`` through a ServeLoop on ``model`` under ``cfg``; time
    every prefill and decode call, each window ended by a synchronize, and
    keep each prefill's last-token logits."""
    from repro_torch.runtime import ServeLoop
    model.cfg = cfg            # the model reads its attention route here
    sl = ServeLoop(cfg, model, max_batch=SERVE_MAX_BATCH,
                   max_len=SERVE_MAX_LEN, device=dev)
    rec = {"prefill": [], "decode": [], "logits": [], "shapes": []}

    def timed(fn, key):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            rec[key].append(time.perf_counter() - t0)
            if key == "prefill":
                rec["logits"].append(out[0].float().cpu())
                rec["shapes"].append(list(args[0].shape))
            return out
        return call

    model.prefill = timed(model.prefill, "prefill")
    model.decode_step = timed(model.decode_step, "decode")
    reqs = [sl.submit(p, max_new=SERVE_MAX_NEW) for p in prompts]
    torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev)
    try:
        t0 = time.perf_counter()
        sl.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    tokens = sum(len(r.output) for r in reqs)
    prefill_tokens = sum(b * s for b, s in rec["shapes"])
    decode_ms = sorted(x * 1e3 for x in rec["decode"])
    return {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "prefill_shapes": rec["shapes"],
            "prefill_ms": [x * 1e3 for x in rec["prefill"]],
            "prefill_tokens_per_s": prefill_tokens / sum(rec["prefill"]),
            "decode_steps": len(decode_ms),
            "decode_ms_mean": sum(decode_ms) / len(decode_ms),
            "decode_ms_median": decode_ms[len(decode_ms) // 2],
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "memory_allocated_at_start": resident,
            "stats": dict(sl.stats), "outputs": [r.output for r in reqs],
            "logits": torch.cat(rec["logits"])}


def run_launcher(arch: str) -> dict:
    """``python -m repro_torch.launch.serve --arch <arch> --full`` once, with
    its defaults (8 requests of 12 tokens, 16 new tokens each)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", arch, "--full"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.splitlines()
    summary = lines[0] if lines else ""
    want = (rf"\[serve\] {re.escape(arch)}: 8 requests, 128 tokens in \S+s "
            r"\(\S+ tok/s\), 2 batches, 30 decode steps on cuda")
    ok = r.returncode == 0 and re.fullmatch(want, summary) is not None
    return {"ok": ok, "returncode": r.returncode, "summary": summary,
            "seconds": time.perf_counter() - t0,
            "stderr_tail": "" if ok else r.stderr[-2000:]}


def warm_up(cfg, model, prompts, dev) -> float:
    """One short batch before the main path: the first prefill and decode
    at new shapes set up cuBLAS and grow the allocator's pool; timed apart
    from the main path."""
    from repro_torch.runtime import ServeLoop
    t0 = time.perf_counter()
    warm = ServeLoop(cfg, model, max_batch=SERVE_MAX_BATCH,
                     max_len=SERVE_MAX_LEN, device=dev)
    for p in prompts[:SERVE_MAX_BATCH]:
        warm.submit(p[:256], max_new=2)
    warm.run_until_idle()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_serve(dev, model, cfg) -> dict:
    """The serving main path at full width with B3, held against the einsum
    route on the same requests and weights."""
    from repro_torch.kernels import flash_attention
    prompts = serve_prompts(cfg.vocab_size)
    warmup_s = warm_up(cfg, model, prompts, dev)
    reset_launches()
    flash = serve_once(cfg, model, prompts, dev)
    launches = flash_attention.launches
    reset_launches()
    einsum = serve_once(dataclasses.replace(cfg, flash_attention=False),
                        model, prompts, dev)
    einsum_launches = flash_attention.launches
    model.cfg = cfg
    f, e = flash.pop("logits"), einsum.pop("logits")
    routes = logit_agreement(f, e, SERVE_TOL)
    same = sum(a == b for of, oe in zip(flash["outputs"], einsum["outputs"])
               for a, b in zip(of, oe))
    well_formed = (bool(torch.isfinite(f).all())
                   and all(len(o) == SERVE_MAX_NEW
                           and all(0 <= x < cfg.vocab_size for x in o)
                           for o in flash["outputs"]))
    batches = flash["stats"]["batches"]
    launcher = run_launcher(SERVE_ARCH)
    ok = (well_formed and launches == cfg.num_layers * batches
          and einsum_launches == 0
          and max(routes["last_logit_err_over_max"]) <= SERVE_TOL
          and not routes["first_token_mismatched"] and launcher["ok"])
    res = {"phase": "serve", "ok": ok, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
           "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts],
           "max_batch": SERVE_MAX_BATCH, "max_new": SERVE_MAX_NEW,
           "max_len": SERVE_MAX_LEN, "warmup_s": warmup_s,
           "launches": launches,
           "launches_per_prefill_batch": launches / batches,
           "flash": {k: v for k, v in flash.items() if k != "outputs"},
           "einsum": {k: v for k, v in einsum.items() if k != "outputs"},
           "einsum_b3_launches": einsum_launches, **routes,
           "tokens_equal_between_routes": same,
           "tokens": flash["tokens"], "launcher": launcher}
    emit(res)
    if not ok:
        raise SystemExit("serve phase failed")
    return res


def moe_prompts(vocab: int) -> list[np.ndarray]:
    """The serve phase's traffic with each length rounded down to a multiple
    of MOE_PROMPT_STEP (SERVE_REQUESTS prompts of 1024-2048 tokens)."""
    return [p[:len(p) // MOE_PROMPT_STEP * MOE_PROMPT_STEP]
            for p in serve_prompts(vocab)]


def left_padded(prompts, dev) -> torch.Tensor:
    """One batch of ``prompts``, left-padded with token 0 to the longest, as
    ServeLoop pads them."""
    S = max(len(p) for p in prompts)
    ids = np.zeros((len(prompts), S), np.int64)
    for i, p in enumerate(prompts):
        ids[i, S - len(p):] = p
    return torch.from_numpy(ids).to(dev)


@torch.inference_mode()
def moe_routes(model, cfg, ids, tol: float) -> dict:
    """The prefill of ``ids`` under ``cfg`` with B3 and on the einsum route.
    Each MoE layer's routing (every token's top-k experts, which the K
    argmax rounds pick whatever the capacity) is recorded on both routes;
    a token whose experts differ is a flip, and a flip changes the
    capacity slots of the rest of its group of ``moe_group`` tokens.  In
    f32 each B3 launch is also held against the einsum route on the same
    q, k, v (TOL's f32 tolerance).  Reports the last-token logits'
    difference over their largest magnitude per row, the flips per layer,
    the rows that no flipped group touches, and first tokens where the
    einsum route's top-2 margin exceeds ``tol`` of that magnitude."""
    from repro_torch.models import layers as L
    real_moe, real_sdpa = L.moe, L._sdpa
    picks = {True: [], False: []}
    attention = []
    f32 = cfg.adt == torch.float32

    def moe(p, c, x, *, group_size=512):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"]["w"], dim=-1)
        picks[route].append(probs.topk(c.top_k, dim=-1).indices.sort(-1)[0])
        return real_moe(p, c, x, group_size=group_size)

    def sdpa(q, k, v, mask, *, use_kernel=False, causal=False, window=None,
             scale=None):
        out = real_sdpa(q, k, v, mask, use_kernel=use_kernel, causal=causal,
                        window=window, scale=scale)
        if f32 and use_kernel and q.shape[1] > 1:
            ref = real_sdpa(q, k, v, mask, causal=causal, window=window,
                            scale=scale)
            attention.append(errors(out, ref, "flash_attention.float32"))
        return out

    logits = {}
    L.moe, L._sdpa = moe, sdpa
    try:
        for route in (True, False):
            model.cfg = dataclasses.replace(cfg, flash_attention=route)
            logits[route] = model.prefill(
                ids, max_len=ids.shape[1] + 1)[0].float()
    finally:
        L.moe, L._sdpa = real_moe, real_sdpa
        model.cfg = cfg
    B, S = ids.shape
    flipped = [(a != b).any(-1) for a, b in zip(picks[True], picks[False])]
    Gs = min(cfg.moe_group, B * S)
    groups = torch.stack(flipped).any(0).reshape(-1, Gs).any(-1)
    token_groups = torch.arange(B * S, device=ids.device) // Gs
    clean = [not bool(groups[token_groups[r * S:(r + 1) * S]].any())
             for r in range(B)]
    res = {"dtype": cfg.dtype,
           **logit_agreement(logits[True], logits[False], tol),
           "flips_per_layer": [int(x.sum()) for x in flipped],
           "rows_untouched_by_flips": clean}
    if f32:
        res["attention_layers_checked"] = len(attention)
        res["attention_max_abs_err"] = max(a["max_abs_err"] for a in attention)
        res["attention_ok"] = (len(attention) == cfg.num_layers
                               and all(a["ok"] for a in attention))
    return res


def phase_moe_serve(dev) -> dict:
    """granite-moe-3b-a800m at full width through ServeLoop: f32 weights,
    bf16 activations, B3 in every prefill layer, after a warm-up batch.
    Gated on one prefill batch in f32 activations against the einsum
    route; the same comparison in bf16 is printed.  Then the launcher."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(MOE_SERVE_ARCH), flash_attention=True)
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED))
    prompts = moe_prompts(cfg.vocab_size)
    warmup_s = warm_up(cfg, model, prompts, dev)
    reset_launches()
    run = serve_once(cfg, model, prompts, dev)
    launches = flash_attention.launches
    logits = run.pop("logits")
    batches = run["stats"]["batches"]
    ids = left_padded(prompts[:SERVE_MAX_BATCH], dev)
    f32 = moe_routes(model, dataclasses.replace(cfg, dtype="float32"), ids,
                     MOE_F32_TOL)
    f32["ok"] = (f32["finite"] and f32["attention_ok"]
                 and all(err <= MOE_F32_TOL for err, clean in zip(
                     f32["last_logit_err_over_max"],
                     f32["rows_untouched_by_flips"]) if clean))
    bf16 = moe_routes(model, cfg, ids, SERVE_TOL)
    bf16["checked"] = False
    well_formed = (bool(torch.isfinite(logits).all())
                   and all(len(o) == SERVE_MAX_NEW
                           and all(0 <= x < cfg.vocab_size for x in o)
                           for o in run["outputs"]))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    launcher = run_launcher(MOE_SERVE_ARCH)
    ok = (well_formed and launches == cfg.num_layers * batches
          and f32["ok"] and launcher["ok"])
    res = {"phase": "moe-serve", "ok": ok, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "experts": cfg.num_experts, "top_k": cfg.top_k,
           "moe_group": cfg.moe_group,
           "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
           "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
           "max_batch": SERVE_MAX_BATCH, "max_new": SERVE_MAX_NEW,
           "warmup_s": warmup_s, "launches": launches,
           "launches_per_prefill_batch": launches / batches,
           **{k: v for k, v in run.items() if k != "outputs"},
           "routes_f32": f32, "routes_bf16_not_gated": bf16,
           "launcher": launcher}
    emit(res)
    if not ok:
        raise SystemExit("moe-serve phase failed")
    return res


@torch.inference_mode()
def decode_against_prefill(model, prompts, dev) -> dict:
    """One batch of ``prompts``, left-padded to the longest S as ServeLoop
    pads them: prefill of the first S - 1 tokens plus one decode step of the
    last against the prefill of all S.  Crosses B4's y and final state
    (which prime the cache) with the recurrent decode, which does not use
    B4."""
    ids = left_padded(prompts, dev)
    full, _ = model.prefill(ids, max_len=SERVE_MAX_LEN)
    _, cache = model.prefill(ids[:, :-1], max_len=SERVE_MAX_LEN)
    step, _ = model.decode_step(cache, ids[:, -1:])
    res = logit_agreement(step, full, SSM_TOL)
    res["ok"] = (res["finite"] and max(res["last_logit_err_over_max"])
                 <= SSM_TOL and not res["first_token_mismatched"])
    return {"batch": list(ids.shape), **res}


def phase_ssm_serve(dev, model, cfg) -> dict:
    """The SSM serving main path: mamba2-370m at full width through
    ServeLoop, B4 in every layer's prefill; held by prefill against decode
    on the first batch, then the launcher once."""
    from repro_torch.kernels import ssd_scan
    prompts = serve_prompts(cfg.vocab_size)
    warmup_s = warm_up(cfg, model, prompts, dev)
    reset_launches()
    run = serve_once(cfg, model, prompts, dev)
    launches = ssd_scan.launches
    logits = run.pop("logits")
    check = decode_against_prefill(model, prompts[:SERVE_MAX_BATCH], dev)
    launcher = run_launcher(SSM_ARCH)
    well_formed = (bool(torch.isfinite(logits).all())
                   and all(len(o) == SERVE_MAX_NEW
                           and all(0 <= x < cfg.vocab_size for x in o)
                           for o in run["outputs"]))
    batches = run["stats"]["batches"]
    ok = (well_formed and launches == cfg.num_layers * batches
          and check["ok"] and launcher["ok"])
    res = {"phase": "ssm-serve", "ok": ok, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "ssm_heads": model.nheads, "headdim": model.headdim,
           "ssm_state": cfg.ssm_state, "vocab": cfg.vocab_size,
           "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
           "requests": len(prompts), "prompt_lens": [len(p) for p in prompts],
           "max_batch": SERVE_MAX_BATCH, "max_new": SERVE_MAX_NEW,
           "warmup_s": warmup_s, "launches": launches,
           "launches_per_prefill_batch": launches / batches,
           **{k: v for k, v in run.items() if k != "outputs"},
           "decode_against_prefill": check, "launcher": launcher}
    emit(res)
    if not ok:
        raise SystemExit("ssm-serve phase failed")
    return res


def timed_sync(fn, *args):
    """``fn(*args)`` and its seconds, from a synchronize to a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_audio(dev) -> dict:
    """whisper-tiny at full width (1500 frames), f32 activations: encode,
    the audio prefill step, and AUDIO_DECODE_STEPS decode steps from an
    empty cache against the teacher-forced decoder on the same tokens; then
    AUDIO_TRAIN_STEPS TrainLoop steps in bf16 activations.  Every attention
    takes the einsum route: no kernel runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    from repro_torch.runtime import TrainLoop
    cfg = dataclasses.replace(get_config(AUDIO_ARCH), dtype="float32")
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal(
        (AUDIO_BATCH, cfg.enc_frames, cfg.d_model), dtype=np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (AUDIO_BATCH, AUDIO_SEQ))).to(dev)
    reset_launches()
    with torch.inference_mode():
        prefill = make_prefill_step(model, cfg, AUDIO_SEQ)
        prefill({"frames": frames, "tokens": toks})        # warm-up
        enc, encode_s = timed_sync(model.encode, frames)
        last, prefill_s = timed_sync(prefill, {"frames": frames,
                                               "tokens": toks})
        n = AUDIO_DECODE_STEPS
        teacher = model.decode_train(enc, toks[:, :n])
        decode = make_decode_step(model, cfg)
        cache = model.init_cache(AUDIO_BATCH, n, dev)
        errs, step_s = [], []
        for t in range(n):
            (logits, cache), dt = timed_sync(decode, cache, toks[:, t:t + 1],
                                             enc)
            errs.append(float((logits - teacher[:, t]).abs().max()))
            step_s.append(dt)
    finite = bool(torch.isfinite(last).all() and torch.isfinite(teacher).all())
    del model, enc, cache
    train_cfg = get_config(AUDIO_ARCH)
    loop = TrainLoop(train_cfg, global_batch=AUDIO_BATCH, seq_len=AUDIO_SEQ,
                     seed=SEED, device=dev)
    state = loop.init_state()
    _, state, warm = loop.run(1, start_step=0, state=state)
    t0 = time.perf_counter()
    _, state, m = loop.run(AUDIO_TRAIN_STEPS, start_step=1, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}
    losses = warm.losses + m.losses
    del loop, state
    gc.collect()
    torch.cuda.empty_cache()
    ok = (finite and max(errs) <= AUDIO_TOL
          and all(math.isfinite(x) for x in losses)
          and launches == {"flash_attention": 0, "ssd_scan": 0})
    res = {"phase": "audio", "ok": ok, "arch": cfg.name,
           "layers": [cfg.enc_layers, cfg.num_layers], "d_model": cfg.d_model,
           "frames": cfg.enc_frames, "vocab": cfg.vocab_size,
           "batch": [AUDIO_BATCH, AUDIO_SEQ], "dtype": cfg.dtype,
           "encode_ms": encode_s * 1e3, "prefill_step_ms": prefill_s * 1e3,
           "decode_steps": n, "decode_ms_mean": sum(step_s) / n * 1e3,
           "decode_max_abs_err": max(errs), "tol": AUDIO_TOL,
           "train": {"dtype": train_cfg.dtype, "steps": AUDIO_TRAIN_STEPS,
                     "losses": losses, "wall_s": wall,
                     "ms_per_step": wall / AUDIO_TRAIN_STEPS * 1e3,
                     "tokens_per_s":
                         AUDIO_TRAIN_STEPS * AUDIO_BATCH * AUDIO_SEQ / wall},
           "launches": launches}
    emit(res)
    if not ok:
        raise SystemExit("audio phase failed")
    return res


def phase_vlm(dev) -> dict:
    """internvl2-26b at full width with bf16 weights: VLM_REQUESTS requests
    of an image and VLM_TEXT text tokens through the vlm prefill step (B3
    in every layer) and VLM_DECODE_STEPS decode steps, after a short
    warm-up; held against the einsum route by the serve rule."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import D_VIS
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(VLM_ARCH), param_dtype="bfloat16",
                              flash_attention=True)
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    B = VLM_REQUESTS
    vis = torch.from_numpy(rng.standard_normal(
        (B, cfg.vis_tokens, D_VIS), dtype=np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (B, VLM_TEXT))).to(dev)
    max_len = cfg.vis_tokens + VLM_TEXT + VLM_DECODE_STEPS
    prefill = make_prefill_step(model, cfg, max_len)
    decode = make_decode_step(model, cfg)
    with torch.inference_mode():
        prefill({"vis": vis, "tokens": toks[:, :64]})       # warm-up
        reset_launches()
        (logits, cache), prefill_s = timed_sync(prefill, {"vis": vis,
                                                          "tokens": toks})
        launches = flash_attention.launches
        first = logits
        tok, out, step_s = logits.argmax(-1), [], []
        for _ in range(VLM_DECODE_STEPS):
            out.append(tok.tolist())
            (logits, cache), dt = timed_sync(decode, cache, tok[:, None])
            step_s.append(dt)
            tok = logits.argmax(-1)
        finite = bool(torch.isfinite(logits).all())
        del cache
        model.lm.cfg = dataclasses.replace(cfg, flash_attention=False)
        einsum, _ = prefill({"vis": vis, "tokens": toks})
        model.lm.cfg = cfg
    peak = torch.cuda.max_memory_allocated(dev)
    routes = logit_agreement(first, einsum, SERVE_TOL)
    params = sum(p.numel() for p in model.parameters())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ok = (finite and routes["finite"] and launches == cfg.num_layers
          and max(routes["last_logit_err_over_max"]) <= SERVE_TOL
          and not routes["first_token_mismatched"])
    res = {"phase": "vlm", "ok": ok, "arch": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.hd],
           "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
           "params": params, "requests": B,
           "tokens": [cfg.vis_tokens, VLM_TEXT],
           "prefill_ms": prefill_s * 1e3,
           "prefill_tokens_per_s": B * (cfg.vis_tokens + VLM_TEXT) / prefill_s,
           "decode_steps": VLM_DECODE_STEPS,
           "decode_ms_mean": sum(step_s) / len(step_s) * 1e3,
           "decode_ms_median": sorted(step_s)[len(step_s) // 2] * 1e3,
           "launches": launches, "launches_expected": cfg.num_layers,
           **routes, "outputs": out,
           "max_memory_allocated": peak}
    emit(res)
    if not ok:
        raise SystemExit("vlm phase failed")
    return res


def phase_timing(dev) -> list[dict]:
    from repro_torch.kernels.nbody import (FLOPS_PER_PAIR, nbody_forces_rows,
                                           nbody_forces_rows_plain)
    from repro_torch.kernels.stencil5 import (halo_rows, wave_step_rows,
                                              wave_step_rows_plain)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    out = []

    # B1: one device's chunk of the N-body timestep
    rows = NBODY_N // (NODES * DEVICES)
    p = torch.randn(NBODY_N, 3, generator=g).to(dev)
    ms = cuda_ms(lambda: nbody_forces_rows(p, 0, rows), reps=5)
    plain_ms = cuda_ms(lambda: nbody_forces_rows_plain(p, 0, rows), reps=2)
    e = errors(nbody_forces_rows(p, 0, rows),
               nbody_forces_rows_plain(p, 0, rows), "nbody_forces_rows",
               nbody_error_scale(p, 0, rows))
    flops = FLOPS_PER_PAIR * rows * NBODY_N
    nbytes = p.numel() * 4 + rows * 3 * 4
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    out.append({"name": "nbody_forces_rows", "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "operations",
                "share_of_bound": bound_ms / ms, "shape": [rows, NBODY_N],
                "flops": flops, "tflops": flops / ms / 1e9, **e})

    # B2: the four device chunks of one WaveSim step
    H, W = WAVE_H, WAVE_W
    um = torch.randn(H, W, generator=g).to(dev)
    u = torch.randn(H, W, generator=g).to(dev)
    step = H // (NODES * DEVICES)
    chunks = []
    for lo in range(0, H, step):
        top, bottom = halo_rows(lo, step, H)
        chunks.append((um[lo:lo + step], u[lo - top:lo + step + bottom], lo))
    n = len(chunks)

    def run(fn):
        return [fn(a, b, lo, H, WAVE_C) for a, b, lo in chunks]

    ms = cuda_ms(lambda: run(wave_step_rows), reps=20, warmup=3) / n
    plain_ms = cuda_ms(lambda: run(wave_step_rows_plain), reps=5) / n
    e = errors(torch.cat(run(wave_step_rows)),
               torch.cat(run(wave_step_rows_plain)), "wave_step_rows")
    nbytes = sum((a.numel() * 2 + b.numel()) * 4 for a, b, _ in chunks) / n
    flops = 10 * step * W
    bound_ms = max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    out.append({"name": "wave_step_rows", "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "bytes",
                "share_of_bound": bound_ms / ms, "shape": [step, W],
                "bytes": nbytes, **e})
    flash = flash_timing(dev, g)
    flash["train"] = flash_train_timing(dev, g)
    flash["granite_serve"] = flash_granite_timing(dev, g)
    flash["ok"] = (flash["ok"] and flash["train"]["ok"]
                   and flash["granite_serve"]["ok"])
    out.append(flash)
    ssd = ssd_timing(dev, g)
    ssd["train"] = ssd_train_timing(dev, g)
    _, s, h, p, n, chunk = SSD_MAIN
    ssd["train"]["backward"] = ssd_backward_timing(
        dev, g, TRAIN_BATCH, s, h, p, n, chunk)
    ssd["granite_train"] = ssd_backward_timing(dev, g, *SSD_GRANITE)
    ssd["ok"] = ssd["ok"] and ssd["train"]["ok"]
    out.append(ssd)
    state_pass = state_pass_timing(dev, TRAIN_BATCH, -(-s // chunk), h, p, n)
    gb, gs, gh, gp, gn, gchunk = SSD_GRANITE
    state_pass["granite_train"] = state_pass_timing(dev, gb, -(-gs // gchunk),
                                                    gh, gp, gn)
    state_pass["ok"] = state_pass["ok"] and state_pass["granite_train"]["ok"]
    out.append(state_pass)
    ok = all(t["ok"] for t in out)
    emit({"phase": "timing", "ok": ok, "kernels": out})
    if not ok:
        raise SystemExit("kernel-versus-plain check at main-path shapes failed")
    return out


def flash_timing(dev, g: torch.Generator) -> dict:
    """B3 at one prefill layer of a full serve batch (B = 4, S = T = 2048,
    qwen2-1.5b's heads), bf16, causal; beside it one PyTorch call,
    ``scaled_dot_product_attention`` on ``[B, H, S, hd]`` views made before
    the timed region."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    B, S, K, G, hd = SERVE_MAX_BATCH, SERVE_PROMPT_LENS[1], 2, 6, 128
    q = torch.randn(B, S, K, G, hd, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(B, S, K, hd, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(B, S, K, hd, generator=g).to(dev, torch.bfloat16)
    ms = cuda_ms(lambda: flash_attention(q, k, v), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), reps=3)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, hd)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)

    library_ms = cuda_ms(sdpa, reps=10, warmup=2)
    got = flash_attention(q, k, v)
    e = errors(got, flash_attention_plain(q, k, v), "flash_attention.bfloat16")
    lib = sdpa().reshape(B, K, G, S, hd).permute(0, 3, 1, 2, 4)
    flops = 4 * B * K * G * hd * S * (S + 1) // 2      # live causal pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    t_ops = flops / PEAK_BF16_TENSOR_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    return {"name": "flash_attention", "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": bound_ms / ms, "shape": [B, S, S, K, G, hd],
            "dtype": "bfloat16", "causal": True, "flops": flops,
            "tflops": flops / ms / 1e9,
            "library_tflops": flops / library_ms / 1e9,
            "bytes": nbytes,
            "library_max_abs_diff": float((lib.float() - got.float()).abs().max()),
            **e}


def ssd_timing(dev, g: torch.Generator) -> dict:
    """B4 at one layer of a full mamba2-370m prefill batch (``SSD_MAIN``),
    bf16.  No single PyTorch call computes this function."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    b, s, h, p, n, chunk = SSD_MAIN
    x, a, B, C = ssd_inputs(b, s, h, p, n, torch.bfloat16, dev, g)
    ms = cuda_ms(lambda: ssd_scan(x, a, B, C, chunk), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: ssd_scan_plain(x, a, B, C, chunk), reps=3)
    y, _ = ssd_scan(x, a, B, C, chunk)
    ye, _ = ssd_scan_plain(x, a, B, C, chunk)
    e = errors(y, ye, "ssd_scan.bfloat16",
               ssd_error_scale(x, a, B, C, chunk)[0])
    # per (batch, head, chunk): C B^T and its product with x over the live
    # (causal) pairs, C h_prev, and the state update x^T B
    pairs = chunk * (chunk + 1) // 2
    flops = b * h * (s // chunk) * (2 * pairs * n + 2 * pairs * p
                                    + 4 * chunk * n * p)
    nbytes = (2 * x.numel() + B.numel() + C.numel()) * 2 + a.numel() * 4 \
        + b * h * p * n * 4                      # x, y, B, C, a, state
    t_ops = flops / PEAK_BF16_TENSOR_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    return {"name": "ssd_scan", "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": bound_ms / ms, "shape": list(SSD_MAIN),
            "dtype": "bfloat16", "flops": flops, "tflops": flops / ms / 1e9,
            "bytes": nbytes, **e}


def flash_granite_timing(dev, g: torch.Generator) -> dict:
    """B3 at one prefill layer of a granite-moe-3b-a800m serve batch (B 4,
    S = T = 2048, K 8, G 3, hd 64, bf16, causal): forward beside its plain
    version, ``scaled_dot_product_attention`` and its bound; the plain
    blockwise backward from the forward's lse."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_plain)
    B, S, K, G, hd = SERVE_MAX_BATCH, SERVE_PROMPT_LENS[1], 8, 3, 64
    q = torch.randn(B, S, K, G, hd, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(B, S, K, hd, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(B, S, K, hd, generator=g).to(dev, torch.bfloat16)
    dout = torch.randn(B, S, K, G, hd, generator=g).to(dev, torch.bfloat16)
    ms = cuda_ms(lambda: flash_attention(q, k, v), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), reps=3)
    qh = q.permute(0, 2, 3, 1, 4).reshape(B, K * G, S, hd)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=True), reps=10, warmup=2)
    out, lse = flash_attention(q, k, v, return_lse=True)
    exp, exp_lse = flash_attention_plain(q, k, v, return_lse=True)
    checks = {"out": errors(out, exp, "flash_attention.bfloat16"),
              "lse": errors(lse, exp_lse, "flash_attention.lse")}
    backward_ms = cuda_ms(lambda: flash_attention_backward(
        q, k, v, out, lse, dout), reps=3)
    flops = 4 * B * K * G * hd * S * (S + 1) // 2      # live causal pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    t_ops = flops / PEAK_BF16_TENSOR_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes) * 1e3
    return {"shape": [B, S, S, K, G, hd], "dtype": "bfloat16",
            "causal": True, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "share_of_bound": bound_ms / ms, "backward_plain_ms": backward_ms,
            **checks, "ok": all(c["ok"] for c in checks.values())}


def ssd_train_timing(dev, g: torch.Generator) -> dict:
    """B4 at one layer of the ssm-train step (b 2, s 2048, mamba2-370m's
    heads, bf16): the forward beside its plain version, and the Function's
    backward (autograd of the plain version recomputed from the inputs)."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    _, s, h, p, n, chunk = SSD_MAIN
    x, a, B, C = ssd_inputs(TRAIN_BATCH, s, h, p, n, torch.bfloat16, dev, g)
    ms = cuda_ms(lambda: ssd_scan(x, a, B, C, chunk), reps=10, warmup=2)
    def op():
        return torch.ops.repro_torch.ssd_scan_fwd(x, a, B, C, chunk)

    op_ms = cuda_ms(op, reps=10, warmup=2)
    enqueue = {"host_ms": host_ms(lambda: ssd_scan(x, a, B, C, chunk),
                                  reps=10),
             "op_host_ms": host_ms(op, reps=10)}
    plain_ms = cuda_ms(lambda: ssd_scan_plain(x, a, B, C, chunk), reps=3)
    y, _ = ssd_scan(x, a, B, C, chunk)
    e = errors(y, ssd_scan_plain(x, a, B, C, chunk)[0], "ssd_scan.bfloat16",
               ssd_error_scale(x, a, B, C, chunk)[0])
    ins = [t.detach().clone().requires_grad_() for t in (x, a, B, C)]
    yg, _ = ssd_scan(*ins, chunk)
    dy = torch.randn(yg.shape, generator=g).to(dev, yg.dtype)
    backward_ms = cuda_ms(lambda: torch.autograd.grad(
        yg, ins, dy, retain_graph=True), reps=3)
    return {"shape": [TRAIN_BATCH, s, h, p, n, chunk], "dtype": "bfloat16",
            "ms": ms, "op_ms": op_ms, "op_dispatch_ms": op_ms - ms, **enqueue,
            "plain_ms": plain_ms, "backward_plain_ms": backward_ms,
            **e}


def ssd_backward_timing(dev, g: torch.Generator, b, s, h, p, n,
                        chunk) -> dict:
    """B4 at one Mamba2 layer of a training step, bf16: its forward and
    backward (the Function's: the kernel forward, the plain backward
    recomputed), with the recurrence over chunks of that backward the two
    state-pass launches and, beside it, ``ssd_state_pass_plain``."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_state_pass_plain
    ssd_module = sys.modules["repro_torch.kernels.ssd_scan"]
    ins = [t.requires_grad_() for t in
           ssd_inputs(b, s, h, p, n, torch.bfloat16, dev, g)]
    dy = torch.randn(b, s, h, p, generator=g).to(dev, torch.bfloat16)

    def forward_backward():
        y, _ = ssd_scan(*ins, chunk)
        torch.autograd.grad(y, ins, dy)

    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(forward_backward, reps=3)
    peak = torch.cuda.max_memory_allocated(dev)
    kernels = ssd_module.ssd_state_pass
    ssd_module.ssd_state_pass = ssd_state_pass_plain
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        plain_pass_ms = cuda_ms(forward_backward, reps=3)
        plain_pass_peak = torch.cuda.max_memory_allocated(dev)
    finally:
        ssd_module.ssd_state_pass = kernels
    return {"shape": [b, s, h, p, n, chunk], "dtype": "bfloat16",
            "forward_backward_ms": ms, "peak_bytes": peak,
            "forward_backward_plain_pass_ms": plain_pass_ms,
            "plain_pass_peak_bytes": plain_pass_peak}


def state_pass_timing(dev, b, c, h, p, n) -> dict:
    """B4's recurrence over chunks, ``ssd_state_pass``, on card tensors of
    ``[b, c, h, p, n]`` states, forward and backward as a training step runs
    it (the final state brings no gradient), against
    ``ssd_state_pass_plain`` on the same inputs: ``hprev``, ``hlast`` and
    the states' gradient bit for bit, the decays' within 1e-6 of its
    largest and the same in a second run.  Both timed; the bound is bytes:
    the forward reads the states and writes ``hprev`` and ``hlast``, the
    reverse reads ``hprev`` and ``dhprev`` and writes the states'
    gradient."""
    from repro_torch.kernels.ssd_scan import (ssd_state_pass,
                                              ssd_state_pass_plain)
    gd = torch.Generator(device=dev).manual_seed(SEED)
    states = torch.randn(b, c, h, p, n, device=dev,
                         generator=gd).requires_grad_()
    # decays in (0.5, 1]: the state neither dies nor grows far over c chunks
    decay = (1 - 0.5 * torch.rand(b, c, h, device=dev, generator=gd)
             ).requires_grad_()
    dhprev = torch.randn(b, c, h, p, n, device=dev, generator=gd)

    def run(fn):
        hprev, hlast = fn(states, decay)
        return (hprev.detach(), hlast.detach(),
                *torch.autograd.grad(hprev, (states, decay), dhprev))

    got, again = run(ssd_state_pass), run(ssd_state_pass)
    want = run(ssd_state_pass_plain)
    exact = {k: torch.equal(a, e) for k, a, e in
             zip(("hprev", "hlast", "dstates"), got, want)}
    ddecay_err = float((got[3] - want[3]).abs().max())
    ddecay_max = float(want[3].abs().max())
    deterministic = torch.equal(got[3], again[3])
    ok = (all(exact.values()) and deterministic
          and ddecay_err <= 1e-6 * ddecay_max)
    del got, again, want
    ms = cuda_ms(lambda: run(ssd_state_pass), reps=10, warmup=2)
    plain_ms = cuda_ms(lambda: run(ssd_state_pass_plain), reps=3)
    big, small = states.numel() * 4, decay.numel() * 4
    nbytes = (2 * big + small + big // c) + (3 * big + 2 * small)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"name": "ssd_state_pass", "ok": ok, "shape": [b, c, h, p, n],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "share_of_bound": bound_ms / ms,
            "bytes": nbytes, "bitwise": exact,
            "max_abs_err": ddecay_err, "ddecay_max_abs": ddecay_max,
            "ddecay_deterministic": deterministic}


def device_activity(run) -> dict:
    """Run ``run()`` under torch.profiler; the union of the card's activity
    intervals (kernels and copies, over all streams) against wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = union_s(spans)             # in us
    by_name: dict[str, float] = {}
    for ev in prof.key_averages():       # the card's kernels and copies only
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.self_device_time_total > 0):
            # names cut to 60 characters can collide: add them up
            key = ev.key[:60]
            by_name[key] = (by_name.get(key, 0.0)
                            + ev.self_device_time_total / 1e3)
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_events": len(spans), "device_ms_by_name": top}


def phase_profile(dev, models) -> None:
    """``models``: (name, cfg, model) of each serving path; one batch each."""
    from repro_torch.apps import NBody, run_nbody, run_wave
    from repro_torch.core import Runtime
    rng = np.random.default_rng(SEED + 3)
    P0 = rng.standard_normal((NBODY_N, 3), dtype=np.float32)
    V0 = rng.standard_normal((NBODY_N, 3), dtype=np.float32) * 0.1
    u0 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)
    u1 = rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32)

    def nbody_energy(rt):
        """One step, then one energy step (E and Mx)."""
        sim = NBody(rt, P0, V0, DT, MASS)
        sim.advance(1, energy_every=1)
        return sim.energy()

    runs = {"nbody": lambda rt: run_nbody(rt, P0, V0, 10, DT, MASS),
            "nbody_energy": nbody_energy,
            "wavesim": lambda rt: run_wave(rt, u0, u1, 20, WAVE_C)}
    out = {}
    for name, run in runs.items():
        with Runtime(NODES, DEVICES, device="cuda") as rt:
            out[name] = device_activity(lambda: run(rt))
    from repro_torch.runtime import ServeLoop
    for name, cfg, model in models:
        sl = ServeLoop(cfg, model, max_batch=SERVE_MAX_BATCH,
                       max_len=SERVE_MAX_LEN, device=dev)
        prompts = serve_prompts(cfg.vocab_size)[:SERVE_MAX_BATCH]

        def serve_batch():
            for p in prompts:
                sl.submit(p, max_new=SERVE_MAX_NEW)
            sl.run_until_idle()

        out[name] = device_activity(serve_batch)
    ok = all(r["device_events"] > 0 for r in out.values())
    emit({"phase": "profile", "ok": ok,
          "note": "N-body and WaveSim wall includes buffer seeding and the "
                  "final gather; nbody_energy is one step and one energy "
                  "step",
          "nbody_steps": 10, "wavesim_steps": 20,
          "serve_batches": f"one batch of {SERVE_MAX_BATCH} requests, "
                           f"{SERVE_MAX_NEW} new tokens each, per model",
          **out})
    if not ok:
        raise SystemExit("the profiler saw no device activity")


# -- trace: instruction records of traced runs on the card -------------------------
def union_s(intervals) -> float:
    """Length of the union of ``(t0, t1)`` intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def device_lane_records(records) -> list:
    """Records of instructions that a device lane ran on its stream (the
    receives the arbiter completes and the graph syncs have no card work)."""
    return [r for r in records if re.fullmatch(r"N\d+\.device\.\d+", r.lane)
            and r.kind not in ARBITER_KINDS]


def record_checks(run: dict) -> dict:
    """The A10 invariants over one traced run's records: ``t_reg <= t_ready
    <= t_start <= t_done``, the issue latency equal to its pending plus
    queue wait within 1%, and every device lane's record stamped with its
    launch and sync in between: ``t_start <= t_launched <= t_synced <=
    t_done``."""
    records = run["records"]
    lanes = device_lane_records(records)
    ordered = all(r.t_reg <= r.t_ready + 1e-9 and r.t_ready <= r.t_start + 1e-9
                  and r.t_start <= r.t_done + 1e-9 for r in records)
    stamped = [r for r in lanes
               if r.t_launched is not None and r.t_synced is not None]
    stamps_ordered = all(r.t_start <= r.t_launched <= r.t_synced <= r.t_done
                         for r in stamped)
    wait_err = max(abs((r.t_ready - r.t_reg) + (r.t_start - r.t_ready)
                       - (r.t_start - r.t_reg))
                   / max(r.t_start - r.t_reg, 1e-12) for r in records)
    return {"records": len(records), "device_lane_records": len(lanes),
            "stamped": len(stamped), "ordered": ordered,
            "stamps_ordered": stamps_ordered,
            "wait_sum_max_rel_err": wait_err,
            "ok": (len(lanes) > 0 and len(stamped) == len(lanes) and ordered
                   and stamps_ordered and wait_err <= 0.01)}


def perfetto_summary(path: Path) -> dict:
    """Load an exported trace; count execution events per device lane."""
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in events if e["ph"] == "M"}
    per_lane: dict[str, int] = {}
    for e in events:
        if e["ph"] == "X" and re.fullmatch(r"N\d+\.device\.\d+",
                                           names.get(e["tid"], "")):
            per_lane[names[e["tid"]]] = per_lane.get(names[e["tid"]], 0) + 1
    lanes = sorted(n for n in names.values()
                   if re.fullmatch(r"N\d+\.device\.\d+", n))
    return {"file": str(path.relative_to(ROOT)), "events": len(events),
            "device_lanes": lanes, "events_per_device_lane": per_lane,
            "ok": bool(lanes) and all(per_lane.get(n, 0) > 0 for n in lanes)}


def trace_inputs(app: str):
    rng = np.random.default_rng(SEED + 5)
    if app == "nbody":
        return (rng.standard_normal((NBODY_N, 3), dtype=np.float32),
                rng.standard_normal((NBODY_N, 3), dtype=np.float32) * 0.1)
    return (rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32),
            rng.standard_normal((WAVE_H, WAVE_W), dtype=np.float32))


def trace_run(app: str, nodes: int, devices: int, *, trace: bool,
              metrics: bool = True) -> dict:
    """One N-body or WaveSim run on a grid: step 1 (which seeds the buffers),
    steps 2..N and the gather, each ended by a sync.  Traced runs keep their
    records, critical path and Perfetto export."""
    from repro_torch.apps import NBody, WaveSim
    from repro_torch.core import Runtime
    a, b = trace_inputs(app)
    steps = TRACE_NBODY_STEPS if app == "nbody" else TRACE_WAVE_STEPS
    with Runtime(nodes, devices, device="cuda", trace=trace,
                 metrics=metrics) as rt:
        sim = (NBody(rt, a, b, DT, MASS) if app == "nbody"
               else WaveSim(rt, a, b, WAVE_C))
        t0 = time.perf_counter()
        sim.advance(1)
        rt.sync()
        t1 = time.perf_counter()
        sim.advance(steps - 1)
        rt.sync()
        t2 = time.perf_counter()
        sim.gather()
        t3 = time.perf_counter()
        out = {"grid": [nodes, devices], "steps": steps, "trace": trace,
               "metrics": metrics, "steps_per_s": (steps - 1) / (t2 - t1),
               "first_step_s": t1 - t0, "gather_s": t3 - t2}
        if trace:
            out["records"] = list(rt.tracer.records)
            out["critical_path"] = rt.critical_path_report().as_dict()
            path = ROOT / "build" / "traces" / f"{app}_{nodes}x{devices}.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            rt.tracer.to_chrome_trace(path)
            out["perfetto"] = perfetto_summary(path)
    return out


def phase_trace() -> dict:
    """A10 on the card: the records of traced N-body and WaveSim runs on
    2 x 2, and steps/s traced, with metrics only and bare, in turns."""
    out, ok = {}, True
    for app in ("nbody", "wavesim"):
        main = trace_run(app, NODES, DEVICES, trace=True)
        # steps/s traced (stamped lanes), with metrics only (the default)
        # and bare, in turns
        configs = {"trace": dict(trace=True), "metrics_only": dict(trace=False),
                   "bare": dict(trace=False, metrics=False)}
        rates = {}
        for name in [*configs, *reversed(configs)]:
            rates.setdefault(name, []).append(
                trace_run(app, NODES, DEVICES, **configs[name]))
        res = {"checks_2x2": record_checks(main),
               "critical_path_2x2": main["critical_path"],
               "perfetto_2x2": main["perfetto"],
               "steps_per_s": {k: [r["steps_per_s"] for r in runs]
                               for k, runs in rates.items()},
               "traced_run": {k: main[k] for k in ("steps_per_s",
                                                   "first_step_s",
                                                   "gather_s")}}
        res["ok"] = res["checks_2x2"]["ok"] and res["perfetto_2x2"]["ok"]
        ok &= res["ok"]
        out[app] = res
    emit({"phase": "trace", "ok": ok, "bodies": NBODY_N,
          "field": [WAVE_H, WAVE_W], **out})
    if not ok:
        raise SystemExit("trace phase failed")
    return out


# -- training ----------------------------------------------------------------------
def train_loop(cfg, dev, base, ckpt_dir=None, **kw):
    """A TrainLoop whose weights are a copy of ``base`` on ``dev``."""
    import copy

    from repro_torch.runtime import TrainLoop
    return TrainLoop(cfg, device=dev, ckpt_dir=ckpt_dir,
                     init=lambda: copy.deepcopy(base).to(dev), **kw)


def phase_train_reference(dev) -> None:
    """Reduced qwen2-1.5b in f32 with B3 on the card against the CPU port on
    the same weights and batches; restart from a checkpoint; ElasticTrainer
    through one injected failure."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import ElasticTrainer
    cfg = dataclasses.replace(get_config(SERVE_ARCH, reduced=True),
                              flash_attention=True)
    base = build_model(cfg).init(torch.Generator().manual_seed(SEED))
    kw = dict(global_batch=TRAIN_REF_BATCH, seq_len=TRAIN_REF_SEQ, seed=SEED)
    cpu = train_loop(cfg, "cpu", base, **kw).run(TRAIN_REF_STEPS)[2].losses
    card = train_loop(cfg, dev, base, **kw).run(TRAIN_REF_STEPS)[2].losses
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    # restart: 8 steps with a failure at step 5, checkpoints every 4
    ref_losses = train_loop(cfg, dev, base, **kw).run(8)[2].losses
    loop = train_loop(cfg, dev, base, ckpt / "restart", ckpt_interval=4, **kw)
    failed = False
    try:
        loop.run(8, fail_at=5)
    except RuntimeError:
        failed = True
    loop2 = train_loop(cfg, dev, base, ckpt / "restart", ckpt_interval=4, **kw)
    start, state = loop2.restore_or_init()
    resumed = loop2.run(8 - start, start_step=start, state=state)[2].losses
    restart_rel = max(abs(a - b) / abs(b)
                      for a, b in zip(resumed, ref_losses[start:]))
    restart = {"failed_at_5": failed, "resumed_at": start,
               "losses": resumed, "uninterrupted": ref_losses[start:],
               "bitwise": resumed == ref_losses[start:],
               "max_rel_diff": restart_rel,
               "ok": failed and start == 5 and restart_rel <= 1e-6}
    calls = []

    def make_loop(world):
        calls.append(world)
        return train_loop(cfg, dev, base, ckpt / "elastic", ckpt_interval=3,
                          **kw)

    _, metrics, world = ElasticTrainer(make_loop).run(10, world_size=4,
                                                      fail_at=7)
    elastic = {"restarts": metrics.restarts, "world": world, "calls": calls,
               "last_step": max(metrics.steps),
               "ok": metrics.restarts == 1 and max(metrics.steps) == 9}
    shutil.rmtree(ckpt, ignore_errors=True)
    ok = rel <= TRAIN_REF_TOL and restart["ok"] and elastic["ok"]
    emit({"phase": "train-reference", "ok": ok, "arch": cfg.name,
          "reduced": True, "dtype": cfg.dtype, "flash_attention": True,
          "batch": [TRAIN_REF_BATCH, TRAIN_REF_SEQ], "steps": TRAIN_REF_STEPS,
          "card_losses": card, "cpu_losses": cpu, "max_rel_diff": rel,
          "tol": TRAIN_REF_TOL, "restart": restart, "elastic": elastic})
    if not ok:
        raise SystemExit("training on the card disagrees with the CPU's")


def loss_and_grad_norm(model, batch) -> tuple[float, float]:
    """One forward and backward without an update; the gradients are
    dropped after their norm is taken."""
    loss = model.loss(batch)
    loss.backward()
    params = list(model.parameters())
    gn = torch.sqrt(sum(torch.sum(torch.square(p.grad.float()))
                        for p in params))
    for p in params:
        p.grad = None
    return loss.item(), gn.item()


def run_train_launcher() -> dict:
    """``python -m repro_torch.launch.train --full --flash --steps 2 --batch
    1 --seq 1024`` once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--full", "--flash", "--steps", "2", "--batch", "1",
                        "--seq", "1024"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    lines = r.stdout.splitlines()
    loss = [ln for ln in lines if ln.startswith("[train] loss")]
    ok = r.returncode == 0 and len(loss) == 1
    return {"ok": ok, "returncode": r.returncode, "stdout": lines,
            "seconds": time.perf_counter() - t0,
            "stderr_tail": "" if ok else r.stderr[-2000:]}


def held_out_loss(model, loop, dev) -> float:
    """Loss, without gradients, on a batch that the loop never trains on."""
    toks = torch.from_numpy(
        loop.data.local_batch(TRAIN_HELD_OUT)["tokens"]).to(dev)
    with torch.no_grad():
        return model.loss({"tokens": toks, "labels": toks}).item()


def flash_route(model, cfg, kernel: bool):
    """Run ``model`` with B3 (``kernel``) or on the einsum route."""
    model.cfg = dataclasses.replace(cfg, flash_attention=kernel)


def ssd_route(model, cfg, kernel: bool):
    """Run the Mamba2 layers' scan through B4's wrapper (``kernel``) or
    through its plain version on the card, for the route comparison."""
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.models import mamba2
    mamba2.ssd_scan = ssd_scan if kernel else ssd_scan_plain


def train_main_path(dev, cfg, kernel, set_route, held_out: bool) -> dict:
    """``cfg`` at full width through TrainLoop (f32 weights and moments,
    ``cfg.dtype`` activations, TRAIN_BATCH x TRAIN_SEQ tokens a step): the
    first step's loss and grad norm on ``kernel``'s route against the
    reference route (``set_route(model, cfg, False)``), a warm-up step,
    then the main path of TRAIN_STEPS steps with ``kernel`` launched once
    per layer a step in the forward and, with ``cfg.remat`` (the default,
    as in the JAX package), once more in the backward's recompute; with
    ``held_out``, more steps up to TRAIN_FALL_STEPS
    and the loss of a batch never trained on must fall."""
    from repro_torch.kernels import ssd_scan, ssd_state_pass
    from repro_torch.models import build_model
    from repro_torch.runtime import TrainLoop
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED)).requires_grad_(True)
    loop = TrainLoop(cfg, global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     prefetch_depth=2, seed=SEED, device=dev,
                     init=lambda: model)
    toks = torch.from_numpy(loop.data.local_batch(0)["tokens"]).to(dev)
    batch = {"tokens": toks, "labels": toks}
    routes = {}
    try:
        for name in ("reference", "kernel"):
            set_route(model, cfg, name == "kernel")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[name] = (*loss_and_grad_norm(model, batch),
                            time.perf_counter() - t0)
    finally:
        set_route(model, cfg, True)
    held_before = held_out_loss(model, loop, dev) if held_out else None
    (rl, rg, rs), (kl, kg, ks) = routes["reference"], routes["kernel"]
    route_check = {"reference": {"loss": rl, "grad_norm": rg, "seconds": rs},
                   "kernel": {"loss": kl, "grad_norm": kg, "seconds": ks},
                   "loss_rel_diff": abs(kl - rl) / abs(rl),
                   "grad_norm_rel_diff": abs(kg - rg) / abs(rg)}
    route_check["ok"] = (route_check["loss_rel_diff"] <= TRAIN_LOSS_RTOL
                         and route_check["grad_norm_rel_diff"]
                         <= TRAIN_GRAD_NORM_RTOL)
    state = loop.init_state()
    t0 = time.perf_counter()
    _, state, warm = loop.run(1, start_step=0, state=state)
    torch.cuda.synchronize()
    warmup_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    _, state, m = loop.run(TRAIN_STEPS, start_step=1, state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    state_pass_launches = ssd_state_pass.launches
    peak = torch.cuda.max_memory_allocated(dev)
    losses = warm.losses + m.losses
    res = {"arch": cfg.name, "full": True, "family": cfg.family,
           "param_dtype": cfg.param_dtype, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in model.parameters()),
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "steps": TRAIN_STEPS,
           "routes_first_step": route_check, "losses": losses,
           "warmup_step_s": warmup_s, "wall_s": wall,
           "ms_per_step": wall / TRAIN_STEPS * 1e3,
           "tokens_per_s": TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall,
           "grad_norms": warm.grad_norms + m.grad_norms,
           "overlap": loop.overlap, "kernel": kernel.__name__,
           "remat": cfg.remat, "launches": launches,
           "launches_expected": (cfg.num_layers * TRAIN_STEPS
                                 * (2 if cfg.remat else 1)),
           # B4's backward: one forward and one reverse launch of its
           # recurrence over chunks in each layer a step, remat or not
           "state_pass_launches": state_pass_launches,
           "state_pass_launches_expected": (
               2 * cfg.num_layers * TRAIN_STEPS if kernel is ssd_scan
               else 0),
           "max_memory_allocated": peak}
    ok = (route_check["ok"] and launches == res["launches_expected"]
          and state_pass_launches == res["state_pass_launches_expected"]
          and all(math.isfinite(x) for x in losses))
    if held_out:
        # the first Adam steps from random weights raise the loss of batches
        # they have not seen (PERF.md §6): the fall is read on a held-out
        # batch after TRAIN_FALL_STEPS steps
        steps = 1 + TRAIN_STEPS
        _, state, more = loop.run(TRAIN_FALL_STEPS - steps, start_step=steps,
                                  state=state)
        held_after = held_out_loss(model, loop, dev)
        res.update(losses_after_main_path=more.losses,
                   held_out_batch=TRAIN_HELD_OUT,
                   held_out_loss_before=held_before,
                   held_out_loss_after=held_after,
                   steps_before_held_out_check=TRAIN_FALL_STEPS)
        ok = (ok and all(math.isfinite(x) for x in more.losses)
              and math.isfinite(held_after) and held_after < held_before)
    res["ok"] = ok
    del loop, state, model, batch, toks
    gc.collect()
    torch.cuda.empty_cache()
    return res


def grad_bits(params) -> list[int]:
    """Per f32 gradient, the sum of its 32-bit patterns: lists that differ
    mean gradients that differ in some bit."""
    return torch.stack([p.grad.view(torch.int32).sum(dtype=torch.int64)
                        for p in params]).tolist()


def card_busy(run) -> dict:
    """``run()`` under torch.profiler recording the card's activity alone
    (cheaper to read back than ``device_activity``'s host and card
    events): the wall time, the union of the card's kernel and copy
    intervals, and the card's time by name (the ten largest)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = union_s((a, b) for _, a, b in spans) / 1e6
    by_name: dict[str, float] = {}
    for name, a, b in spans:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (b - a) / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    return {"wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1.0 - busy / wall,
            "device_events": len(spans), "device_ms_by_name": top}


def remat_run(dev, arch: str, remat: bool, kernel,
              profiled: bool = False) -> dict:
    """``arch`` at full width with ``cfg.remat`` set to ``remat``: the
    first step's loss, grad norm and gradient bits (no update), a warm-up
    train step (``launch/steps.py``), then REMAT_STEPS timed train steps,
    each ended by a sync, and with ``profiled`` one step under the
    profiler (``card_busy``); peak memory over the run from a reset."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_config(arch), remat=remat,
                              flash_attention=True)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED)).requires_grad_(True)
    data = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)

    def batch(i):
        toks = torch.from_numpy(data.local_batch(i)["tokens"]).to(dev)
        return {"tokens": toks, "labels": toks}

    params = dict(model.named_parameters())
    loss = model.loss(batch(0))
    loss.backward()
    gn = torch.sqrt(sum(torch.sum(torch.square(p.grad.float()))
                        for p in params.values()))
    first = {"loss": loss.item(), "grad_norm": gn.item(),
             "grad_bits": grad_bits(params.values())}
    del loss, gn
    for p in params.values():
        p.grad = None
    step = make_train_step(model)
    opt = adamw_init(params)
    params, opt, _ = step(params, opt, batch(1))
    torch.cuda.synchronize()
    reset_launches()
    times, losses = [], []
    for i in range(REMAT_STEPS):
        b = batch(2 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
    launches = kernel.launches
    prof = None
    if profiled:
        # one more step under the profiler: how busy the card is in a step
        b, out = batch(2 + REMAT_STEPS), {}

        def one_step():
            out["step"] = step(params, opt, b)

        prof = card_busy(one_step)
        params, opt, _ = out.pop("step")
    peak = torch.cuda.max_memory_allocated(dev)
    step_s = statistics.median(times)
    res = {"remat": remat, "layers": cfg.num_layers, "first_step": first,
           "step_s": times, "ms_per_step": step_s * 1e3,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "losses": losses, "launches": launches,
           "launches_per_step": launches / REMAT_STEPS,
           "max_memory_allocated": peak, "profiled_step": prof}
    del model, params, opt, step, data
    gc.collect()
    torch.cuda.empty_cache()
    return res


def remat_setting(runs: list[dict]) -> dict:
    """The runs of one remat setting together: the median over all their
    timed steps, the largest peak, each run's launches per step, and the
    first run's profiled step."""
    times = [t for r in runs for t in r["step_s"]]
    step_s = statistics.median(times)
    return {"runs": len(runs), "step_s": times, "ms_per_step": step_s * 1e3,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
            "max_memory_allocated": max(r["max_memory_allocated"]
                                        for r in runs),
            "launches_per_step": [r["launches_per_step"] for r in runs],
            "losses": [x for r in runs for x in r["losses"]],
            "profiled_step": runs[0]["profiled_step"]}


def phase_remat(dev) -> dict:
    """Each of REMAT_ARCHS with remat on and off in this call, in turns
    (on, off, off, on): ms per step, tokens/s, peak memory, kernel launches
    per step, the card's busy time in a profiled step of the first run of
    each setting, and the first
    step's loss and grad norm under both, with whether they and the
    gradients were bitwise equal.  Fails unless the loss and grad norm
    agree within REMAT_LOSS_RTOL and REMAT_GRAD_NORM_RTOL, the peak is
    lower with remat on, and the kernel (B3, or B4 for the Mamba2 model)
    runs twice per layer a step with remat on (forward and recompute) and
    once with it off."""
    from repro_torch.kernels import flash_attention, ssd_scan
    t_phase = time.perf_counter()
    models, ok = {}, True
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for arch in REMAT_ARCHS:
        kernel = ssd_scan if arch == SSM_ARCH else flash_attention
        runs = {True: [], False: []}
        for i, remat in enumerate((True, False, False, True)):
            r = remat_run(dev, arch, remat, kernel, profiled=i < 2)
            launches[kernel.__name__] += r["launches"]
            runs[remat].append(r)
        first = {k: [r.pop("first_step") for r in v] for k, v in runs.items()}
        f_on, f_off = first[True][0], first[False][0]
        on, off = remat_setting(runs[True]), remat_setting(runs[False])
        layers = runs[True][0]["layers"]
        loss_rel = abs(f_on["loss"] - f_off["loss"]) / abs(f_off["loss"])
        gn_rel = (abs(f_on["grad_norm"] - f_off["grad_norm"])
                  / abs(f_off["grad_norm"]))
        checks = {
            "loss_within_tol": loss_rel <= REMAT_LOSS_RTOL,
            "grad_norm_within_tol": gn_rel <= REMAT_GRAD_NORM_RTOL,
            "peak_lower_with_remat": (on["max_memory_allocated"]
                                      < off["max_memory_allocated"]),
            "launches_twice_per_layer_with_remat": all(
                n == 2 * layers for n in on["launches_per_step"]),
            "launches_once_per_layer_without": all(
                n == layers for n in off["launches_per_step"]),
            "finite": all(math.isfinite(x) for x in (
                f_on["loss"], f_on["grad_norm"], *on["losses"],
                *off["losses"]))}
        ok = ok and all(checks.values())
        models[arch] = {
            "kernel": kernel.__name__, "layers": layers, **checks,
            "first_step": {
                "remat_on": {k: f_on[k] for k in ("loss", "grad_norm")},
                "remat_off": {k: f_off[k] for k in ("loss", "grad_norm")},
                "loss_rel_diff": loss_rel, "grad_norm_rel_diff": gn_rel,
                "loss_bitwise": f_on["loss"] == f_off["loss"],
                "grad_norm_bitwise": f_on["grad_norm"] == f_off["grad_norm"],
                "gradients_bitwise": f_on["grad_bits"] == f_off["grad_bits"],
                "repeat_runs_bitwise": all(f == first[k][0]
                                           for k in first
                                           for f in first[k])},
            "step_time_ratio": on["ms_per_step"] / off["ms_per_step"],
            "peak_ratio": (on["max_memory_allocated"]
                           / off["max_memory_allocated"]),
            "remat_on": on, "remat_off": off}
    res = {"phase": "remat", "ok": ok, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "order": "on, off, off, on", "timed_steps_per_run": REMAT_STEPS,
           "param_dtype": "float32", "dtype": "bfloat16",
           "loss_rtol": REMAT_LOSS_RTOL,
           "grad_norm_rtol": REMAT_GRAD_NORM_RTOL, "models": models,
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    emit(res)
    if not ok:
        raise SystemExit("remat phase failed")
    return res


DRYRUN_CHILD = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention, ssd_scan
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_dev_mesh
arch, shape, mesh, batch, seq = sys.argv[1:4] + [int(a) for a in sys.argv[4:]]
if mesh == "card":
    # mesh (1, 1) at the card check's setting: B3/B4 on, remat on
    cfg = dataclasses.replace(get_config(arch), flash_attention=True)
    spec = dict(seq_len=seq, global_batch=batch, kind="train")
    cells = [dict(cfg=cfg, spec=spec,
                  mesh=make_dev_mesh(1, 1, device="cuda"))]
else:
    cells = [dict(multi_pod=m) for m in (False, True)
             if mesh == "both" or m == (mesh == "multi")]
recs = []
for kw in cells:
    n0 = flash_attention.launches + ssd_scan.launches
    try:
        rec = lower_cell(arch, shape, device="cuda", **kw)
    except Exception as e:  # recorded as the cell's failure
        rec = {"arch": arch, "shape": shape,
               "multi_pod": kw.get("multi_pod", False),
               "error": f"{type(e).__name__}: {e}"}
    rec["kernel_launches"] = flash_attention.launches + ssd_scan.launches - n0
    recs.append(rec)
print(json.dumps(recs))
"""


def dryrun_summary(rec: dict) -> dict:
    """A production record's per-card numbers, in GB and TFLOP."""
    if "error" in rec:
        return rec
    mem = rec["memory"]
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "trace_s": rec["trace_s"], "tflops": rec["flops"] / 1e12,
            "bytes_gb": rec["bytes_accessed"] / 1e9,
            "collective_gb": {k: v / 1e9 for k, v in
                              rec["collectives"].items()},
            "collective_counts": rec["collective_counts"],
            "collective_link_gb": {k: v / 1e9 for k, v in
                                   rec["collective_links"].items()},
            "argument_gb": mem["argument_bytes"] / 1e9,
            "temp_gb": mem["temp_bytes"] / 1e9,
            "flops_rawhlo": rec["flops_rawhlo"],
            "kernel_launches": rec["kernel_launches"]}


def dryrun_card_one(dev, arch: str, kernel, rec: dict) -> dict:
    """``arch`` at mesh (1, 1) under the remat phase's setting: the trace's
    record ``rec`` (made in a child process) against a warm-up train step,
    a step timed and measured for peak memory from a reset, and a step
    under ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    cfg = dataclasses.replace(get_config(arch), flash_attention=True)
    traced_launches = rec["kernel_launches"]
    predicted = (rec["memory"]["argument_bytes"]
                 + rec["memory"]["temp_bytes"])
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    model = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED)).requires_grad_(True)
    data = SyntheticLMData(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)

    def batch(i):
        toks = torch.from_numpy(data.local_batch(i)["tokens"]).to(dev)
        return {"tokens": toks, "labels": toks}

    params = dict(model.named_parameters())
    opt = adamw_init(params)
    step = make_train_step(model)
    b1, b2, b3 = batch(0), batch(1), batch(2)
    params, opt, _ = step(params, opt, b1)
    del b1
    torch.cuda.synchronize(dev)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, b2)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    with FlopCounterMode(display=False) as fc:
        params, opt, m = step(params, opt, b3)
    torch.cuda.synchronize(dev)
    launches = kernel.launches        # the two real steps since the reset
    real_flops = fc.get_total_flops()
    roofline_s = max(rec["flops"] / PEAK_FLOPS_BF16,
                     rec["bytes_accessed"] / HBM_BW)
    peak_rel = abs(predicted - peak) / peak
    flops_rel = abs(rec["flops"] - real_flops) / real_flops
    checks = {"peak_within_tol": peak_rel <= DRYRUN_PEAK_RTOL,
              "flops_within_tol": flops_rel <= DRYRUN_FLOPS_RTOL,
              "trace_launched_nothing": traced_launches == 0,
              "finite": math.isfinite(m["loss"].item())}
    res = {"arch": arch, "kernel": kernel.__name__, **checks,
           "trace_s": rec["trace_s"],
           "argument_bytes": rec["memory"]["argument_bytes"],
           "temp_bytes": rec["memory"]["temp_bytes"],
           "predicted_peak_bytes": predicted,
           "max_memory_allocated": peak, "peak_rel_diff": peak_rel,
           "dryrun_flops": rec["flops"], "real_step_flops": real_flops,
           "flops_rel_diff": flops_rel,
           "dryrun_bytes": rec["bytes_accessed"],
           "roofline_step_ms": roofline_s * 1e3,
           "measured_step_ms": step_s * 1e3,
           "roofline_fraction": roofline_s / step_s,
           "launches": launches}
    del model, params, opt, step, data, m
    gc.collect()
    torch.cuda.empty_cache()
    return res


def dryrun_traces() -> tuple[list[dict], dict]:
    """Each training cell of DRYRUN_CELLS on each production mesh, each of
    DRYRUN_CARD_ARCHS at mesh (1, 1), and each other cell on both meshes,
    in a child process of its own (one intra-op thread: a trace computes
    nothing), as many at once as the host has cores, the longest first
    (training traces, the Mamba2 and MoE models' longest); a child's
    failure is recorded as its cells' error.  Returns the production
    records and the (1, 1) records by arch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    jobs = [(a, s, m) for a, s in reversed(DRYRUN_CELLS) if s == "train_4k"
            for m in ("single", "multi")] + [
        (a, "train", "card") for a in reversed(DRYRUN_CARD_ARCHS)] + [
        (a, s, "both") for a, s in DRYRUN_CELLS if s != "train_4k"]
    pending, running, done = list(jobs), [], {}
    t0 = time.perf_counter()
    while pending or running:
        while pending and len(running) < (os.cpu_count() or 1):
            job = pending.pop(0)
            # output to files: a pipe left unread would stall the child
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            running.append((job, out, err, subprocess.Popen(
                [sys.executable, "-c", DRYRUN_CHILD, *job, str(TRAIN_BATCH),
                 str(TRAIN_SEQ)], cwd=ROOT, env=env, stdout=out, stderr=err,
                text=True)))
        time.sleep(0.2)
        for item in [r for r in running if r[3].poll() is not None
                     or time.perf_counter() - t0 > 900]:
            job, out, err, proc = item
            running.remove(item)
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.seek(0), err.seek(0)
            lines = out.read().splitlines()
            done[job] = (json.loads(lines[-1]) if proc.returncode == 0
                         else [{"arch": job[0], "shape": job[1],
                                "multi_pod": multi, "kernel_launches": 0,
                                "error": f"exit {proc.returncode}",
                                "stderr_tail": err.read()[-2000:]}
                               for multi in (False, True)
                               if job[2] in ("both", "card")
                               or multi == (job[2] == "multi")][
                                   :1 if job[2] == "card" else None])
            out.close(), err.close()
    records = [r for j in jobs if j[2] != "card" for r in done[j]]
    return records, {j[0]: done[j][0] for j in jobs if j[2] == "card"}


def phase_dryrun(dev) -> dict:
    """The traces (``dryrun_traces``), then the (1, 1) predictions held
    against real steps on the card (``dryrun_card_one``; after the children
    have exited, so that they take no host time from the timed step).
    Fails on any trace error, any launch during a trace, or a (1, 1) check
    out of its bound."""
    from repro_torch.kernels import flash_attention, ssd_scan
    t_phase = time.perf_counter()
    records, traced = dryrun_traces()
    traces_s = time.perf_counter() - t_phase
    ok = len(records) == 2 * len(DRYRUN_CELLS)
    for rec in records:
        emit({"phase": "dryrun", "record": dryrun_summary(rec)})
        ok = ok and "error" not in rec and rec["kernel_launches"] == 0
    card = {}
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for arch in DRYRUN_CARD_ARCHS:
        rec = traced.get(arch, {"error": "no record"})
        if "error" in rec:
            card[arch] = {"arch": arch, "error": rec["error"],
                          "stderr_tail": rec.get("stderr_tail", "")}
            emit({"phase": "dryrun", "mesh_1x1": card[arch]})
            ok = False
            continue
        kernel = ssd_scan if arch == SSM_ARCH else flash_attention
        card[arch] = dryrun_card_one(dev, arch, kernel, rec)
        launches[kernel.__name__] += card[arch]["launches"]
        emit({"phase": "dryrun", "mesh_1x1": card[arch]})
        ok = ok and all(card[arch][k] for k in (
            "peak_within_tol", "flops_within_tol", "trace_launched_nothing",
            "finite"))
    res = {"phase": "dryrun", "ok": ok, "cells": len(records),
           "trace_s": {f"{r['arch']}/{r['shape']}/"
                       f"{'multi' if r.get('multi_pod') else 'single'}":
                       r.get("trace_s") for r in records},
           "traces_wall_s": traces_s, "batch": [TRAIN_BATCH, TRAIN_SEQ],
           "peak_rtol": DRYRUN_PEAK_RTOL, "flops_rtol": DRYRUN_FLOPS_RTOL,
           "launches": launches, "seconds": time.perf_counter() - t_phase}
    emit(res)
    if not ok:
        raise SystemExit("dryrun phase failed")
    return res


def phase_train(dev) -> dict:
    """qwen2-1.5b at full width through TrainLoop with B3 in every layer's
    forward (``train_main_path``, the einsum route as reference, the
    held-out check); then the launcher once."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    cfg = dataclasses.replace(get_config(SERVE_ARCH), flash_attention=True)
    res = {"phase": "train", **train_main_path(dev, cfg, flash_attention,
                                               flash_route, held_out=True)}
    res["launcher"] = run_train_launcher()
    res["ok"] = res["ok"] and res["launcher"]["ok"]
    emit(res)
    if not res["ok"]:
        raise SystemExit("training at full width failed")
    return res


def phase_moe_train(dev) -> dict:
    """granite-moe-1b-a400m at full width through TrainLoop under the train
    phase's rules: B3 in every layer's forward, the einsum route as
    reference, the held-out check."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    cfg = dataclasses.replace(get_config(MOE_TRAIN_ARCH),
                              flash_attention=True)
    res = {"phase": "moe-train", "experts": cfg.num_experts,
           "top_k": cfg.top_k, "moe_group": cfg.moe_group,
           **train_main_path(dev, cfg, flash_attention, flash_route,
                             held_out=True)}
    emit(res)
    if not res["ok"]:
        raise SystemExit("MoE training at full width failed")
    return res


def phase_ssm_train(dev) -> dict:
    """mamba2-370m at full width through TrainLoop: B4 under autograd in
    every layer (its forward, the plain backward), held against the plain
    scan on the card for the first step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan
    cfg = get_config(SSM_ARCH)
    res = {"phase": "ssm-train",
           **train_main_path(dev, cfg, ssd_scan, ssd_route, held_out=False)}
    emit(res)
    if not res["ok"]:
        raise SystemExit("SSM training at full width failed")
    return res


def flash_train_timing(dev, g: torch.Generator) -> dict:
    """B3 at one layer of the train phase (B = 2, S = T = 2048, qwen2's
    heads, bf16, causal): the output and lse against the plain version's,
    the gradients under autograd against the einsum route's, the forward
    timed with and without lse, and the plain blockwise backward beside
    it."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_plain)
    from repro_torch.models.layers import _sdpa, causal_mask
    B, S, K, G, hd = TRAIN_BATCH, TRAIN_SEQ, 2, 6, 128
    q = torch.randn(B, S, K, G, hd, generator=g).to(dev, torch.bfloat16)
    k = torch.randn(B, S, K, hd, generator=g).to(dev, torch.bfloat16)
    v = torch.randn(B, S, K, hd, generator=g).to(dev, torch.bfloat16)
    dout = torch.randn(B, S, K, G, hd, generator=g).to(dev, torch.bfloat16)
    ms = cuda_ms(lambda: flash_attention(q, k, v), reps=10, warmup=2)
    lse_ms = cuda_ms(lambda: flash_attention(q, k, v, return_lse=True),
                     reps=10, warmup=2)
    # the same launch through the custom op (the dry-run's route): its
    # dispatch cost apart from the kernel's, on the card's clock and on the
    # host's (a dispatch shorter than the kernel hides in back-to-back
    # launches)
    def op():
        return torch.ops.repro_torch.flash_attention_fwd(q, k, v, True, 0, 0,
                                                         False)

    op_ms = cuda_ms(op, reps=10, warmup=2)
    enqueue = {"host_ms": host_ms(lambda: flash_attention(q, k, v), reps=10),
             "op_host_ms": host_ms(op, reps=10)}
    out, lse = flash_attention(q, k, v, return_lse=True)
    exp, exp_lse = flash_attention_plain(q, k, v, return_lse=True)
    checks = {"out": errors(out, exp, "flash_attention.bfloat16"),
              "lse": errors(lse, exp_lse, "flash_attention.lse")}
    backward_ms = cuda_ms(lambda: flash_attention_backward(
        q, k, v, out, lse, dout), reps=3)
    mask = causal_mask(S, S, device=dev)
    grads = []
    for route in ("kernel", "einsum"):
        qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*qkv) if route == "kernel" else _sdpa(*qkv, mask)
        (o.float() * dout.float()).sum().backward()
        grads.append([t.grad.float() for t in qkv])
    errs = {n: float((a - b).abs().max() / b.abs().max())
            for n, a, b in zip("qkv", *grads)}
    checks["gradients"] = {"max_err_over_largest": errs,
                           "tol": FLASH_GRAD_BF16_TOL,
                           "ok": max(errs.values()) <= FLASH_GRAD_BF16_TOL}
    return {"shape": [B, S, S, K, G, hd], "dtype": "bfloat16",
            "causal": True, "ms": ms, "lse_ms": lse_ms, "op_ms": op_ms,
            "op_dispatch_ms": op_ms - ms, **enqueue,
            "backward_plain_ms": backward_ms, **checks,
            "ok": all(c["ok"] for c in checks.values())}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_build()
    phase_kernels(dev)
    phase_reference()
    nbody = phase_nbody(dev)
    wave = phase_wave(dev)
    phase_trace()
    phase_budget()
    phase_lookahead()
    phase_serving_runtime(dev)
    phase_faults(dev)
    phase_scheduler_launcher()
    phase_serve_reference(dev)
    phase_zoo_reference(dev)
    phase_train_reference(dev)
    remat = phase_remat(dev)
    dryrun = phase_dryrun(dev)
    train = phase_train(dev)
    moe_train = phase_moe_train(dev)
    ssm_train = phase_ssm_train(dev)
    phase_audio(dev)
    # the largest models first, each freed after its phase: granite-moe-3b
    # (13.2 GB of f32 weights), internvl2-26b (40 GB of bf16 weights)
    moe_serve = phase_moe_serve(dev)
    vlm = phase_vlm(dev)
    # full width: f32 weights drawn on the card from SEED, bf16 activations
    serve_cfg = dataclasses.replace(get_config(SERVE_ARCH),
                                    flash_attention=True)
    model = build_model(serve_cfg).init(
        torch.Generator(device=dev).manual_seed(SEED))
    serve = phase_serve(dev, model, serve_cfg)
    ssm_cfg = get_config(SSM_ARCH)
    ssm_model = build_model(ssm_cfg).init(
        torch.Generator(device=dev).manual_seed(SEED))
    ssm = phase_ssm_serve(dev, ssm_model, ssm_cfg)
    timing = {t["name"]: t for t in phase_timing(dev)}
    phase_profile(dev, [("serve", serve_cfg, model),
                        ("ssm_serve", ssm_cfg, ssm_model)])
    launches = {"nbody_forces_rows": nbody["launches"],
                "wave_step_rows": wave["launches"],
                "flash_attention": sum(r["launches"] for r in (
                    serve, train, moe_serve, moe_train, vlm))
                + remat["launches"]["flash_attention"]
                + dryrun["launches"]["flash_attention"],
                "ssd_scan": ssm["launches"] + ssm_train["launches"]
                + remat["launches"]["ssd_scan"]
                + dryrun["launches"]["ssd_scan"],
                "ssd_state_pass": ssm_train["state_pass_launches"]}
    sources = {"nbody_forces_rows": ("src/repro_torch/kernels/csrc/nbody.cu",
                                     "src/repro/kernels/nbody.py:23"),
               "wave_step_rows": ("src/repro_torch/kernels/csrc/stencil5.cu",
                                  "src/repro/kernels/stencil5.py:22"),
               "flash_attention": (
                   "src/repro_torch/kernels/csrc/flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:28"),
               "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:27"),
               "ssd_state_pass": (
                   "src/repro_torch/kernels/csrc/ssd_state_pass.cu",
                   "src/repro/models/mamba2.py:75")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t.get("library_ms")})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
