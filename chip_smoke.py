#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FedZO on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout (it imports ``src/repro_torch``). Phases,
each of which raises on a failure (the script then exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc.
2. Hold every kernel against its plain PyTorch version on the card, at the
   main paths' shapes, and time it with CUDA events beside its plain
   version, its bound and (where one exists) one PyTorch library call.
   - The four ZO kernels at the flat round's shapes (M = 10 clients,
     n_pad = 65,536, d = 7,850, b2 = 20), for both direction kinds and a
     ragged length that is not a multiple of the CUDA block. Tolerances:
     the sign kind bitwise; the normal kind within 4 ulp of the magnitude of
     the summed terms; the reductions within a relative 1e-5 (another
     summation order).
     zo_dirnorms also bitwise the torch twin of its summation order
     (``dirnorm_order_sum``; the sign kind from the plain directions, the
     normal kind on the kernels' own directions) and over two calls.
     aircomp_reduce's mean bitwise, its norms bitwise their twin
     (``aircomp_sq_order_sum``), also ragged and at an odd offset; timed
     beside its previous two-launch design.
   - zo_walk, zo_replay and zo_dirnorms again at the Qwen2-0.5B train
     step's width (M = 1, n_pad = 494,075,904, d = 494,032,768, b2 = 8);
     the norms' finish is also timed on its own. aircomp_reduce at the flat
     Qwen2-0.5B round's [4, 494,075,904], beside its previous design.
   - rmsnorm ([512, 896] and the [7168, 64] rows of a qk_norm) and
     flash_attention (q [4, 128, 14, 64], k/v [4, 128, 2, 64], causal; a
     ragged S = 100, a window of 32, a non-causal call, causal S = 512, a
     ragged S = 1,000 with a window of 256), each in float32 and bfloat16.
     Tolerances: float32 within a relative 1e-5 (another summation order);
     bfloat16 within 1 bf16 ulp of the output (the two float32 results
     round to neighbouring bf16 values at most). rmsnorm is also bitwise
     the torch twin of its summation order (``rmsnorm_kernel_order``), also
     at an odd element offset and with a ``[G, D]`` scale (G = 1 and 4, the
     client-batched forward), timed with G = 4 beside G = 1. Attention
     again at head dims 16, 128 and 256 (causal, window, GQA, ragged),
     timed against SDPA at [4, 128, 14, 32 or 8, D]; and at the transformer track's
     shapes (q [250 or 5,000, 8, 2, 16 or 8], float32), timed against
     SDPA, with RMSNorm over 10 and 200 groups of 200 rows of D = 32.
   - zo_axpy and zo_axpy2, bitwise, for x, u and v each float32 or
     bfloat16 (all eight mixes): ragged n (1, 7, 65,537), views at odd
     element offsets, and Qwen2-0.5B's largest leaves (the tied embedding
     [151,936, 896], the stacked w_gate [24, 896, 4,864]); timed at the
     embedding beside torch.add.
3. The main paths, through the entry points a user calls:
   - softmax regression 784x10 (the paper's Sec. V-B model) on 50 clients
     with the FedZOConfig defaults (N=50, M=10, H=5, b1=25, b2=20),
     flat_params and size-weighted aggregation, 5 rounds; the same with
     AirComp (channel scheduling, 5 dB); the SmallCNN (28x28x1, width 8),
     2 rounds;
   - the cross-silo FedZO train step on Qwen2-0.5B at full width in
     float32 (arXiv:2407.10671; 494 M parameters, random weights from seed
     0), batch 4 x seq 128 of the synthetic LM stream, b2 = 8, 4 steps;
     then one more step through ``fedzo.local_iterate`` at mu = 16, each
     coefficient held to its recomputation without a ZO kernel
     (``check_estimator``: every loss difference at least 256 ulps).
   - the flat FedZO round on the same model (``fedzo.round_simulated``, M =
     4 clients, H = 2, b2 = 8), once with the plain mean and once with
     AirComp: the cohort's forwards go through the model's client-batched
     loss, so the launch counts are those of one client; the batched loss
     against each client's own loss; kernel time by kind of a profiled
     AirComp round; ms per round and peak memory.
   - the pytree route (the reference's default): ``ops.tree_axpy2`` once
     over the full-width Qwen2-0.5B tree (14 leaves, held against the plain
     version leaf by leaf); the training CLI ``repro_torch.launch.train``
     on Qwen2-0.5B in float32, 3 steps (2·b2 zo_axpy launches per leaf and
     step); softmax 784x10 with flat_params off, 2 rounds, and one AirComp
     round.
   - phase "transformer and wide rounds": the neural transformer track
     (784 features in 8 patch tokens, d_model 32, 2 heads, 1 layer) at the
     same N, M, H, b1, b2 and its own lr (``neural.default_config``):
     flat 3 rounds, flat AirComp 2, pytree 1 round cut to H = 1, and the
     same pytree round with bfloat16 directions (sphere and gaussian); the
     wide route (batch_directions, block directions) on softmax and on the
     track, 3 rounds each, and on softmax one round of each of the tree,
     channel and surrogate conventions and of block with AirComp; one
     profiled round of three of them.
   The launch counters are set to 0 before each run (each train step) and
   must equal exactly what it implies.
4. Small-input references: a short softmax run on each route, 3 train
   steps of qwen2-0.5b-smoke on each route and one flat round of it over 3
   clients, 2 rounds of the transformer track at its test size (head dim
   8) on the flat, pytree and wide routes and on the pytree route with
   bfloat16 directions (sphere and gaussian), each on the card against the
   same run on the CPU (plain versions), within the float32 tolerance of a
   ZO trajectory; bfloat16 normals drawn on the card bitwise the CPU's.

5. Phase "algorithms and uplinks" (the strategy layer, FedAvg, the
   seed-compressed uplink and ``FedServer``), each part's seconds and peak
   memory printed:
   (a) softmax 784x10 at the phase-3 settings, 3 rounds each: fedprox
       (prox_mu 0.01), feddyn (dyn_alpha 0.01) and scaffold on the flat
       route, scaffold on the wide route, fedprox with AirComp, fedavg (lr
       0.05); each strategy launches exactly the fedzo round's kernels on
       its route, fedavg none; the loss falls.
   (b) the transformer track at its lr 5e-3: fedprox (flat) and fedavg, one
       round each, M-free attention and RMSNorm counts; one client's FedAvg
       gradient on the card against the CPU's (every leaf within 1e-4 of
       its largest entry: a backward that skipped the kernels' inputs
       would leave the attention and norm weights at zero).
   (c) the autograd wrappers' backward at Qwen2-0.5B's shapes (batch 1 x
       seq 16), the track's, a [G, D] scale and head dims 8-256, float32
       and bfloat16, bitwise the plain version's autograd on the card, and
       timed at the Qwen step's and the track round's shapes; then 3 steps
       of ``repro_torch.launch.train --algo fedavg --opt adam`` on
       Qwen2-0.5B at full width (float32, batch 4 x seq 128): ms per step,
       peak memory, the losses, one forward's launches a step, and the
       recompute's share of a step.
   (d) ``run_seed_compressed_round`` on Qwen2-0.5B (flat, M = 4, H = 2, b2
       = 8) against a dense ``fedzo.round_simulated`` on the same batches
       and keys: the replayed weights within H + 2 ulps of each leaf's
       largest weight, exactly 1 zo_dirnorms and M.H zo_replay in the
       aggregate, M.(8 + 4.H.b2 + 4) wire bytes and the compression ratio.
   (e) one ZO-FedProx flat round on Qwen2-0.5B (M = 4, H = 2, b2 = 8): ms,
       peak memory, the fedzo round's launch counts.
   (f) ``FedServer`` on softmax, 2 rounds: the host loop with fedzo and
       fedavg, the store path with all five strategies; exact counts and
       the ledger's columns on every row.
   Then one round each of fedprox (flat), scaffold (wide) and fedavg on the
   transformer track at its test size, card against CPU (1e-3; FedAvg
   1e-5).
6. Phase "faults, channel and durability" (fault injection, the wireless
   channel chain, durable checkpointed runs, taps, manifests and the
   paper's Sec. V-A attack), each part's seconds and peak memory printed:
   (a) the flat AirComp round on Qwen2-0.5B (M = 4, H = 2, b2 = 8, 5 dB)
       under a correlated, energy-gated channel with client 2 poisoned
       (NaN, guard on): weights bitwise those of the round with client 2
       masked, the chain's m_effective and m_corrupt 1, non-finite weights
       with the guard off, the plain AirComp round's launches, peak memory
       at most one [n_pad] float32 row above it; ms beside it.
   (b) softmax 784x10 at phase 3's N, M, H with AirComp under dropout,
       stragglers, NaN uploads and the channel, 6 rounds: taps every 2
       rounds equal to the history rows; 2-round segments, and a run
       killed after 2 segments then resumed, bitwise the single-shot run;
       the manifest read back; a divergence drill (a rollback, then
       DivergenceError); a poisoned pytree round (H = 1) bitwise the
       masked one.
   (c) the attack at the reference task's width (32x32x3 images, 10 uneven
       shards of 512 images): the classifier trained on the card, 5 flat
       rounds (H = 20, b2 = 20) with exact launches, and the SNR {0, 10, 20}
       dB x seeds {0, 1} sweep into a CSV that covers every scenario and
       round.
   Then the first FAULT_REF_ROUNDS rounds of (b)'s run on the CPU against
   the card's: the chains and masks equal, the weights within 1e-3.
7. Phase "tiered, hypertune and kernel timing" (budget 90 s, the data's
   generation included), each part's seconds and peak memory printed, each
   number with the card's name and power limit:
   (a) tiered_100k: softmax 784x10 over N = 100,000 ragged clients of 6-12
       rows (seed 1) in a 4-bucket ``HostStore``; 8 flat rounds (M = 32,
       H = 2, b1 = 4, b2 = 20, lr 1e-3, mu 1e-3) in segments of 4, the next
       segment staged on a worker thread into pinned buffers and copied on
       a side stream; then the same run on the resident store: params, key
       and metrics bitwise, exact launches, ms a round of each tier and the
       overhead, stall_pct, host bytes, the staged device bytes (two
       segments under 2 % of the resident store) and each run's peak.
   (b) tiered_aircomp_faulted: the same population, flat AirComp under
       faults and an energy-gated channel, 8 rounds: single-shot, killed
       after one 4-round segment and resumed, and resident, all bitwise.
   (c) hypertune: ``make_task()`` at the reference's defaults, 6 rounds on
       the pytree and the flat route, exact launches, each within 1e-4 of
       the CPU's run, the validation loss falling by a fifth.
   (d) ``obs.kernel_report`` at the softmax pad and at the Qwen2-0.5B flat
       pad: measured us beside the 3.35 TB/s model, the full-width times
       within 10 % of the kernel table's.
8. Phase "fast strategy and batched sweeps" (budget 60 s):
   (a) philox_bits (XLA's RngBitGenerator layout) bitwise its plain
       version at [10, 20, 65,536], ragged, across the 128-bit carry and
       from an odd start, timed against its bound;
   (b) the reference's quickstart through ``FedServer`` under
       ``sim.fast_sim_config`` (unsafe_rbg keys on the wide route) and
       under threefry, 20 rounds, test accuracy at least 0.5; (c) with
       AirComp, exactly 1 aircomp_reduce, 1 zo_walk and H philox_bits a
       round;
   (d) the attack's SNR sweep batched (one [60, n] cohort) against the
       sequential loop, a one-scenario group bitwise its single run; then
       the card against the CPU under unsafe_rbg on the wide and pytree
       routes.
9. Phase "serve and sharded rounds" (budget 90 s), each part's seconds and
   peak memory printed, each number with the card's name and power limit.
   Before each served model runs, its kernels are held against their
   plain versions at the shapes it gives them (phase 2's tolerances, both
   dtypes: rmsnorm over the d_model rows of prefill and decode and the qk
   norms' head_dim rows, attention at [B, S, Hq/Hkv, D]).
   (a) ``launch/serve.py``'s ``main`` on qwen2-0.5b at full width in
       bfloat16 (batch 4 x prompt 32, 16 greedy steps), then the same
       prefill and decode loop warm: tokens per second of each, the
       launches exact (per layer two RMSNorms and one attention in
       prefill, two RMSNorms in decode, the final norm per forward), the
       warm tokens the CLI's; one decode step at position S against a
       prefill of S + 1 tokens within SERVE_BF16_TOL of the largest logit
       (bfloat16: the reasoning stands beside the constant); a ring
       narrower than the prompt decodes finite logits.
   (b) qwen3-4b (head dim 128, qk_norm) and gemma-2b (head dim 256, one kv
       head, GeGLU, the tied 256,000-row embedding) at full width in
       bfloat16: init, one prefill of batch 2 x 64 and 4 decode steps,
       exact launches, the same consistency check, the unembedding's
       device time against a decode step; qwen1.5-32b's full-width count
       on the ``meta`` device and its ``-smoke`` config on the card
       (float32, the reference's bound).
   (c) the sharded round: a one-rank nccl group, ``neural.run(mesh=)`` of
       softmax_flat, softmax_aircomp and phase 6(b)'s faulted AirComp
       config, 3 rounds each, bitwise the unsharded runs with equal
       launches; two gloo ranks spawned on the card (joined with a
       timeout), one round of softmax_flat and of softmax_aircomp each,
       within GLOO_REL of the one-rank round's largest parameter (the
       round's update at least 10x that bound).
   (d) ``fedzo.make_pod_round_step`` on Qwen2-0.5B at full width in float32,
       2 pods of batch 2 x seq 128 (the grouped loss), flat route, b2 = 8,
       2 steps with exact launches and ms a step;
       ``make_delta_agg_step`` on two per-pod delta trees at smoke size,
       with and without AirComp.

10. Phase "moe serving" (budget 150 s), each part's seconds and peak
   memory printed, each number with the card's name and power limit.
   Before each served model runs, its kernels are held at its shapes as in
   phase 9 (rmsnorm at widths 2,048, 7,168, 1,536, 512 and the qk-norm
   rows of 128; attention at [2, 64, 32/4, 128] and, with v's head dim
   apart from q's, [2, 64, 128/128, (192, 128)]).
   (a) ``launch/serve.py``'s ``main`` on qwen3-moe-30b-a3b
       (hf:Qwen/Qwen3-30B-A3B) at full width and depth in bfloat16, batch
       2 x prompt 64, 4 greedy steps: init seconds, peak memory from before
       the init (under 64 GiB: the 56.89 GiB of weights held once), exact
       launches, the share of routed assignments dropped at capacity
       factor 1.25; a warm prefill and decode loop; one decode step
       against a prefill of S + 1 tokens within SERVE_BF16_TOL at the
       capacity factor E / k, which drops nothing; moe_fwd bitwise run to
       run on layer 0.
   (b) deepseek-v3-671b (arXiv:2412.19437) at full width, reduced in depth
       only to 4 layers (3 dense, 1 MoE, the MTP block): the 61-layer count
       on ``meta``, init, prefill 2 x 64 and 4 decode steps with exact
       launches, the same consistency check, the loss at 2 x 64 finite
       with a positive MTP term.
   (c) both ``-smoke`` configs in float32 on the card against the CPU:
       prefill, 4 decode steps, the loss (aux and MTP), one pytree FedZO
       train step (b2 2, mu 1e-2), exact launches, moe_fwd bitwise.
   Then flash_attention at (192, 128), [2, 64, 128/128], both dtypes,
   timed against SDPA and its bound.

11. Phase "moe cohort, ssm and hybrid" (budget 150 s), each part's seconds
   and peak memory printed, each number with the card's name and power
   limit; each model's kernels first held at its shapes against their
   plain versions under phase 2's tolerances.
   (a) ``fedzo.round_simulated`` on qwen3-moe-30b-a3b (hf:Qwen/Qwen3-30B-A3B)
       at full width (128 experts, d 2,048, the full vocabulary), reduced
       in depth only to its first (MoE) layer, in float32: M = 2, H = 2, b2
       = 8, batch 4 x 128 a client, mu 1e-3, plain mean and AirComp; the
       reckoned peak printed first; exact launches (those of one client:
       16 zo_walk, +1 with AirComp, 2 zo_replay, 2 zo_dirnorms, 90 rmsnorm,
       18 flash_attention), ms a round and peak; the mean round bitwise a
       second run; the batched loss against each client's own and the
       routing integers (idx, keep) of the one against the other, at
       capacity factor E / k and at 1.25. Kernels held: rmsnorm with an [M,
       128] scale over the qk norms' rows, attention over the cohort's M.B
       rows [8, 128, 32/4, 128] in float32.
   (b) qwen3-moe-30b-a3b-smoke and deepseek-v3-671b-smoke in float32, one
       flat, one flat AirComp and one wide (block) round each (M = 3, H =
       1, b2 = 4; COHORT_SMOKE_H says why one iterate) on the card against
       the CPU within COHORT_SMOKE_TOL, exact launches.
   (c) hymba-1.5b (arXiv:2411.13676) at full width and depth in bfloat16
       through ``launch/serve.py`` (batch 2 x prompt 2,048, so its window of
       1,024 bites; 8 greedy steps): init seconds, peak from before the
       init, exact launches (prefill 32 attention, 65 rmsnorm; 65 rmsnorm a
       decode step), a warm loop, decode against prefill within
       SERVE_BF16_TOL; then its cross-silo train step at full width in
       float32, 2 flat steps (b2 8, batch 2 x 256), finite, exact launches,
       bitwise a second run.
   (d) rwkv6-7b (arXiv:2404.05892) at full width and depth in bfloat16
       through ``launch/serve.py`` (batch 2 x prompt 512, 8 greedy steps):
       init, peak, prefill and decode times; no kernel launched (its counts
       all 0: layernorms and a plain-torch WKV, as the reference's jnp);
       decode against prefill; the cache's size independent of its width.
   (e) rwkv6-7b-smoke and hymba-1.5b-smoke in float32 on the card against
       the CPU: prefill, 4 decode steps, the loss, one pytree train step.
   Then flash_attention at hymba's prefill shape with the window of 1,024
   (and without it), both dtypes, against SDPA with the boolean window
   mask and the bound of the pairs the window keeps; rmsnorm over
   [4,096, 1,600] against ``F.rms_norm``.

12. Phase "encdec, vlm and the ssm cohort" (budget 150 s), each part's
   seconds and peak memory printed, each number with the card's name and
   power limit; each model's kernels first held at its shapes against their
   plain versions under phase 2's tolerances (the cross q and k norms'
   rows a head dim wide, attention causal, non-causal over the memory, at
   one query, the encoder's non-causal self-attention, and ragged).
   (a) seamless-m4t-large-v2 (arXiv:2308.11596) at full width and depth in
       bfloat16 through ``launch/serve.py`` (batch 2 x prompt 128 over
       4,096 source frames, 8 greedy steps): init seconds, peak from before
       the init, the cross cache's size, exact launches (a prefill 72
       attention and 48 rmsnorm, a decode step 24 and 24), a warm loop,
       decode against prefill within SERVE_BF16_TOL; then its cross-silo
       train step in float32 at full width and depth, 2 flat steps (b2 8,
       batch 2 x 128 and 4,096 frames), finite, exact launches, bitwise a
       second run.
   (b) llama-3.2-vision-90b at full width, reduced in depth only to 10 of
       100 layers (2 groups of 4 self layers and one gated cross layer),
       bfloat16: the 100-layer count on ``meta``, init, the gates set to
       0.5 after the init (the reference's zero gates hide the cross path;
       the logits then differ), prefill 2 x 128 over 1,600 patch
       embeddings and 8 decode steps with exact launches, decode against
       prefill.
   (c) seamless-m4t-large-v2-smoke and llama-3.2-vision-90b-smoke (gates
       0.5) in float32 on the card against the CPU: prefill, 4 decode
       steps, the loss, one pytree train step, exact launches.
   (d) ``fedzo.round_simulated`` through the ssm and hybrid cohort loss in
       float32 (M 2, H 2, b2 8, batch 2 x 256 a client, mu 1e-3, plain mean
       and AirComp) on hymba-1.5b at full width and depth and on rwkv6-7b at
       full width cut to 2 of 32 layers: the reckoned peak first, exact
       M-free launches, ms a round and peak, the mean round bitwise a
       second run, the cohort loss against each client's own; then the
       rwkv6 and hymba -smoke rounds (flat, AirComp, wide) on the card
       against the CPU (``smoke_rounds_card_vs_cpu``).
   (e) flash_attention non-causal at the encoder's [2, 4,096, 16, 64], the
       two cross shapes at prefill and one query over 4,096 and 1,600 keys,
       both dtypes, against SDPA without a mask and the bound; rmsnorm over
       the cross norms' rows against ``F.rms_norm``.

13. Phase "encdec and vlm cohort, strategy sweeps" (budget 150 s): the
   flat round on seamless-m4t-large-v2 at full width and depth through the
   enc-dec cohort loss; llama-3.2-vision-90b's one-group cohort loss; both
   ``-smoke`` configs' flat, AirComp and wide rounds card against CPU;
   strategy sweep groups under unsafe_rbg (``run_xattn_cohort_sweeps``).

14. Phase "production mesh" (budget 90 s), each number with the card's
   name and power limit. 4 gloo ranks spawned on the one card as
   ``make_host_mesh(model_axis=2)``, a (2, 2) ``("data", "model")`` mesh
   (gloo all-reduces CUDA tensors; ``launch/mesh.bridge_gloo_cuda`` builds
   DTensor's other collectives from that), parameters, batches and caches
   DTensors laid out by ``launch/sharding.py``; parts (a) and (b) print
   each rank's seconds and peak memory:
   (a) the expert-parallel ``moe_fwd`` on qwen3-moe-30b-a3b's MoE layer at
       full width (128 experts, d 2,048, FFN 768), float32, batch 4 x 128
       (the train layout: tokens over data, experts over model, the FFN dim
       gathered over data) and 3 x 1 (the decode layout) at capacity
       factor E/k, held against the one-rank forward within PROD_MOE_ATOL
       (the train layout also bitwise a second run: the forward of its
       backward below), and the train layout
       at 1.25 (each rank's dropped share printed); then the layer's
       backward in both layouts at E/k: the gradient of ``sum(out · w) +
       aux`` (w a fixed random tensor) with respect to x, the router and
       the expert weights, each rank's block held against the same block
       of one rank's autograd within PROD_GRAD_REL of that gradient's
       largest magnitude.
   (b) qwen3-moe-30b-a3b cut in depth only to 1 of 48 layers, full width,
       float32: the loss, a prefill of 4 x 128 and PROD_DECODE_STEPS decode
       steps on the mesh against one rank (PROD_LOSS_REL, PROD_LOGIT_REL),
       exact
       per-rank rmsnorm and flash_attention launches (the kernels on each
       rank's local shards), the kernels then held against their plain
       versions at every local shape they saw; one FedZO train step on the
       sharded tree (pytree route, b2 2, mu PROD_MU: each rank draws only
       its shards' directions), its coefficients held to their recomputation
       without a ZO kernel as ``check_estimator`` holds them, 2.b2 zo_axpy
       a leaf; ``ops.tree_axpy2`` over the sharded tree bitwise its plain
       version, one zo_axpy2 a leaf; one FedAvg step (``fedavg.
       make_train_step``, lr 1e-3: the kernels forward, the plain
       recompute backward, the expert-parallel MoE's backward) against one
       rank's step, the loss within PROD_LOSS_REL and each rank's block of
       every updated leaf within PROD_STEP_ATOL of one rank's (some weight
       moving by ten times that), the forward's rmsnorm and
       flash_attention launches exact a rank, its ms and each rank's peak.
   (c) ``launch/dryrun.run_case`` on torch's fake 256- and 512-rank group:
       qwen2-0.5b x train_4k (single pod and multi-pod, with the delta
       program), qwen3-moe-30b-a3b x prefill_32k and decode_32k, and
       qwen3-moe-30b-a3b x train_4k with ``algo="fedavg"``, the records
       printed (roofline seconds from H100 data-sheet peaks); in a thread
       of the parent while the ranks run, the FedAvg case in a process of
       its own beside them.

The line before the last is the JSON kernel table, the last line
``{"ok": true, "device": {...}}``. ``--profile DIR`` adds torch.profiler
traces of one softmax round and one Qwen2-0.5B train step (kernel time by
name, device busy share), written to DIR, and the kernel table (no
timeline) of one pytree softmax round and one pytree Qwen2-0.5B step.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

# the card's peak rates (H100 SXM data sheet, at the 700 W limit): HBM3
# 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s = 132 SMs x 128
# lanes x 2 (FMA) x 1.98 GHz; an SM has 64 int32 lanes, so int32 is a
# quarter of that: 16.7 T op/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT32_OP_PER_S = FP32_FLOP_PER_S / 4
# bfloat16 on the tensor cores, dense (data sheet)
BF16_FLOP_PER_S = 989e12
# int32 operations of the Threefry-2x32 evaluations a kernel makes
# (csrc/threefry.cuh). Each evaluation: 20 rounds of (add, rotate, xor), five
# key injections of two adds, and the add of the counter word that changes
# from one evaluation of a thread to the next (the direction index n in walk
# and replay, the flat index in dirnorms): 71. Once per thread: k2 = k0^k1^C
# (2), the five injected constants k + s (5), and the add of the counter word
# that stays fixed for the thread: 8. Box-Muller's float work runs on other
# pipes and is not counted, so the bound stays a least time.
THREEFRY_EVAL_OPS = 71
THREEFRY_THREAD_OPS = 8

M, N_PAD, D, B2 = 10, 65536, 7850, 20
RAGGED = N_PAD + 77
# the Qwen2-0.5B train step: flat buffer of one client, b2 = 8 directions,
# batch 4 x seq 128 = 512 token rows of d_model 896; 14 q heads over 2 kv
# heads of dim 64
QWEN_D, QWEN_N_PAD, QWEN_B2 = 494_032_768, 494_075_904, 8
# the flat Qwen2-0.5B round: M = 4 clients, H = 2 iterates each
QWEN_M, QWEN_H = 4, 2
LM_B, LM_S, LM_HQ, LM_HKV, LM_HD, LM_DM = 4, 128, 14, 2, 64, 896
# the Qwen2-0.5B parameter tree: 14 leaves; the largest are the tied
# embedding and the stacked MLP weights
QWEN_LEAVES, QWEN_EMBED, QWEN_W_GATE = 14, (151_936, 896), (24, 896, 4_864)
# The estimator check (check_estimator). At the launcher's mu = 1e-3 a
# coefficient d.(L(x + mu.v) - L(x))/mu of Qwen2-0.5B is a whole number of
# float32 ulps of the loss: the ulp of L at about 12.1 is 9.5e-7, so one ulp
# moves a coefficient by d.ulp/mu = 4.7e5, and the four steps read
# coefficient norms of 0 to 1.2e6 over 8 directions: |L(x + mu.v) - L(x)|
# of about 1 ulp, so the directional slopes |dL/dv| are about 1e-3 and the
# forward's rounding decides each coefficient. The check needs every
# difference to be at least CHECK_MIN_ULPS = 256 ulps (2.4e-4): mu = 0.25
# for a slope of 1e-3, and the smallest of 8 slopes can be ten times
# smaller, so mu = 16 for a margin of about 6. The step mu/sqrt(d) = 7e-4
# per weight stays well below the weights' 0.02. The check prints the
# differences; on an H100 the smallest read 902 ulps.
QWEN_CHECK_MU = 16.0
CHECK_MIN_ULPS = 256
# Tolerance of a coefficient against its recomputation: the kernel's point
# x + mu.v_n (reached by the walk, which adds and removes the steps in
# float32, with the kernel's Box-Muller and float32 norm) and the
# recomputed one (float64 norm) differ per weight by about an ulp, which
# moves L by the forward's float32 rounding noise: a few loss ulps, and
# CHECK_TOL_ULPS = 8 of them in the coefficient's units d.ulp/mu; plus the
# norms' relative difference (at most 1e-4, the full-width dirnorms
# tolerance) of the coefficient itself. 8 ulps are 1/32 of the smallest
# difference allowed, so a zeroed or sign-flipped coefficient cannot pass.
CHECK_TOL_ULPS = 8
CHECK_NORM_REL = 1e-4


# names of the port's CUDA kernels in a profiler trace
PORT_KERNELS = ("zo_walk_kernel", "zo_replay_kernel", "dirnorm_kernel",
                "aircomp_reduce_kernel", "axpy_kernel", "rmsnorm_kernel",
                "rmsnorm_long_kernel", "flash_fwd")


def die(msg):
    print(msg, file=sys.stderr)
    sys.exit(2)


def check(cond, msg):
    """A failed check raises, so the script exits non-zero (even under -O)."""
    if not cond:
        raise RuntimeError(msg)


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps, trials=3):
    """Device time of one ``fn()`` call: CUDA events around ``reps`` calls
    enqueued back to back, median over ``trials``
    (``obs.kernel_timing.device_ms``).

    A wrapper's host work (checks, allocation, the ctypes call) takes longer
    than a small kernel runs, so events around calls issued one by one would
    time the host. There a ``torch.cuda._sleep`` spin holds the stream while
    the host enqueues all ``reps`` calls, and the events bracket only the
    calls, which then run back to back on the device.
    """
    from repro_torch.obs.kernel_timing import device_ms
    return device_ms(fn, reps, trials)


def ulp_err(torch, got, want, scale):
    """max |got - want| in units of the float32 spacing of ``scale``."""
    spacing = torch.nextafter(scale, torch.full_like(scale, float("inf"))) \
        - scale
    return float(((got - want).abs() / spacing).max())


def check_kernels(torch, ops, plain, plain_air):
    """Phase 2. Returns {kernel: row of the JSON table, without launches}."""
    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def keys(m):
        return torch.randint(0, 2 ** 32, (m, 2), generator=g, device=dev,
                             dtype=torch.int64)

    rows = {}
    lines = []

    # zo_walk: x + a.v(n0) + b.v(n1)
    errs = []
    for kind in ("normal", "sign"):
        for n in (N_PAD, RAGGED):
            x, k, ab = rnd(M, n), keys(M), rnd(M, 2)
            got = ops.zo_walk(x, k, (3, 4), ab, kind=kind)
            want = plain.zo_walk_plain(x, k, (3, 4), ab, kind=kind)
            gp = plain.counter_gen(kind, k[:, :1], k[:, 1:], 3,
                                   torch.arange(n, device=dev))
            gn = plain.counter_gen(kind, k[:, :1], k[:, 1:], 4,
                                   torch.arange(n, device=dev))
            scale = x.abs() + (ab[:, :1] * gp).abs() + (ab[:, 1:] * gn).abs()
            if kind == "sign":
                check(torch.equal(got, want), f"zo_walk sign n={n} differs")
            else:
                u = ulp_err(torch, got, want, scale)
                check(u <= 4, f"zo_walk normal n={n}: {u} ulp")
            errs.append(float((got - want).abs().max()))
            lines.append(f"zo_walk {kind} n={n}: max_abs_err {errs[-1]:.3e}")
    # the AirComp noise pass: one row, one channel key, ab = (noise_std, 0),
    # nn = (0, 0)
    x, k = rnd(1, N_PAD) * 1e-3, keys(1)
    ab = torch.tensor([[2e-4, 0.0]], device=dev)
    got = ops.zo_walk(x, k, (0, 0), ab, kind="normal")
    want = plain.zo_walk_plain(x, k, (0, 0), ab, kind="normal")
    g0 = plain.counter_gen("normal", k[:, :1], k[:, 1:], 0,
                           torch.arange(N_PAD, device=dev))
    u = ulp_err(torch, got, want, x.abs() + (ab[:, :1] * g0).abs())
    check(u <= 4, f"zo_walk noise pass (M=1): {u} ulp")
    errs.append(float((got - want).abs().max()))
    lines.append(f"zo_walk normal M=1 noise pass: max_abs_err {errs[-1]:.3e}")
    x, k, ab = rnd(M, N_PAD), keys(M), rnd(M, 2)
    ms = median_ms(torch, lambda: ops.zo_walk(x, k, (3, 4), ab), 50)
    plain_ms = median_ms(torch, lambda: plain.zo_walk_plain(x, k, (3, 4), ab),
                         5)
    rows["zo_walk"] = dict(
        source="src/repro_torch/kernels/csrc/zo_axpy.cu",
        replaces="src/repro/kernels/zo_axpy.py:215", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(M * N_PAD * 8, threefry_ops(2 * M * N_PAD, M * N_PAD),
                "int"))

    # zo_replay: x + sum_n c[n].v(n)
    errs = []
    for kind in ("normal", "sign"):
        for n in (N_PAD, RAGGED):
            x, k, c = rnd(M, n), keys(M), rnd(M, B2) * 0.01
            got = ops.zo_replay(x, k, c, kind=kind)
            want = plain.zo_replay_plain(x, k, c, kind=kind)
            if kind == "sign":
                check(torch.equal(got, want), f"zo_replay sign n={n} differs")
            else:
                idx = torch.arange(n, device=dev)
                scale = x.abs()
                for j in range(B2):
                    scale = scale + (c[:, j:j + 1] * plain.counter_gen(
                        kind, k[:, :1], k[:, 1:], j, idx)).abs()
                u = ulp_err(torch, got, want, scale)
                check(u <= 4, f"zo_replay normal n={n}: {u} ulp")
            errs.append(float((got - want).abs().max()))
            lines.append(f"zo_replay {kind} n={n}: max_abs_err "
                         f"{errs[-1]:.3e}")
    x, k, c = rnd(M, N_PAD), keys(M), rnd(M, B2)
    ms = median_ms(torch, lambda: ops.zo_replay(x, k, c), 30)
    plain_ms = median_ms(torch, lambda: plain.zo_replay_plain(x, k, c), 3)
    rows["zo_replay"] = dict(
        source="src/repro_torch/kernels/csrc/zo_axpy.cu",
        replaces="src/repro/kernels/zo_axpy.py:259", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(M * N_PAD * 8 + M * B2 * 4,
                threefry_ops(B2 * M * N_PAD, M * N_PAD), "int"))

    # zo_dirnorms: [M, b2] of |v_n[:d]|^2
    errs = []
    for kind in ("normal", "sign"):
        for d in (D, RAGGED):
            k = keys(M)
            got = ops.zo_dirnorms(k, d, b2=B2, kind=kind)
            want = plain.zo_dirnorms_plain(k, d, b2=B2, kind=kind)
            rel = float(((got - want).abs() / want.abs()).max())
            check(rel <= 1e-5, f"zo_dirnorms {kind} d={d}: rel {rel}")
            errs.append(float((got - want).abs().max()))
            lines.append(f"zo_dirnorms {kind} d={d}: max_abs_err "
                         f"{errs[-1]:.3e} rel {rel:.2e}")
    # bitwise its summation order's torch twin: the sign kind from the plain
    # directions; the normal kind from the kernels' own directions (zo_walk
    # of zeros with ab = (1, 0) returns v_n exactly), whose squares the twin
    # sums; and the same result from a second call
    for d in (D, RAGGED):
        k = keys(M)
        got = ops.zo_dirnorms(k, d, b2=B2, kind="sign")
        check(torch.equal(got, plain.zo_dirnorms_kernel_order(
            k, d, b2=B2, kind="sign")),
              f"zo_dirnorms sign d={d}: not its twin")
        got = ops.zo_dirnorms(k, d, b2=B2)
        check(torch.equal(got, dirnorms_from_walk(torch, ops, plain, k, d,
                                                  B2)),
              f"zo_dirnorms normal d={d}: not its twin's sum of its squares")
        check(torch.equal(got, ops.zo_dirnorms(k, d, b2=B2)),
              f"zo_dirnorms d={d}: two calls differ")
    lines.append("zo_dirnorms: bitwise its twin (sign kind; normal kind on "
                 "the kernels' own directions) and over two calls")
    k = keys(M)
    per, chunks = plain.dirnorm_geometry(D, M * B2)
    ms = median_ms(torch, lambda: ops.zo_dirnorms(k, D, b2=B2), 50)
    plain_ms = median_ms(torch, lambda: plain.zo_dirnorms_plain(k, D, b2=B2),
                         3)
    rows["zo_dirnorms"] = dict(
        source="src/repro_torch/kernels/csrc/zo_axpy.cu",
        replaces="src/repro/kernels/zo_axpy.py:302", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=None,
        **bound(M * 16 + M * B2 * 4,
                threefry_ops(M * B2 * D, M * B2 * chunks * 256), "int"))
    r = rows["zo_dirnorms"]
    lines.append(f"zo_dirnorms M={M} b2={B2} d={D} ({per} evaluations a "
                 f"thread, {chunks} chunks): ms {ms:.5f} bound "
                 f"{r['bound_ms']:.5f} ({r['bound_ms'] / ms:.1%} of it)")

    # aircomp_reduce: (sum_m s[m].x[m], |x[m, :d]|^2). The mean bitwise the
    # plain version; the norms within 1e-5 relative of it (another order)
    # and bitwise the twin of the kernel's own order; a view at an odd
    # offset takes the scalar loads
    errs = []
    for n, off in ((N_PAD, 0), (RAGGED, 0), (N_PAD, 1)):
        x = (rnd(M * n + off) * 1e-3)[off:].view(M, n)
        s = torch.rand(M, generator=g, device=dev)
        mean, sq = ops.aircomp_reduce(x, s, D)
        pmean, psq = plain_air.aircomp_reduce_plain(x, s, D)
        check(torch.equal(mean, pmean), f"aircomp_reduce mean n={n} differs")
        rel = float(((sq - psq).abs() / psq.abs()).max())
        check(rel <= 1e-5, f"aircomp_reduce sq n={n}: rel {rel}")
        per, grid = ops.aircomp_geometry(n, x.device)
        check(torch.equal(sq, plain_air.aircomp_sq_order_sum(
            x, D, per=per, grid=grid)), f"aircomp_reduce sq n={n}: not its "
              f"twin")
        errs.append(max(float((mean - pmean).abs().max()),
                        float((sq - psq).abs().max())))
        lines.append(f"aircomp_reduce n={n} offset {off}: mean bitwise, sq "
                     f"rel {rel:.2e}, sq bitwise its twin (per {per}, grid "
                     f"{grid})")
    x, s = rnd(M, N_PAD) * 1e-3, torch.rand(M, generator=g, device=dev)
    row = aircomp_times(torch, ops, plain_air, x, s, D, 50)
    row.update(source="src/repro_torch/kernels/csrc/zo_aircomp.cu",
               replaces="src/repro/kernels/zo_aircomp.py:75",
               max_abs_err=max(errs))
    rows["aircomp_reduce"] = row
    lines.append(aircomp_line(f"[{M}, {N_PAD}]", row))
    for line in lines:
        print(line)
    return rows


def aircomp_twopass(torch, ops, x, s, d):
    """The previous two-launch AirComp reduction (its second kernel one
    thread per row summing every block partial in series), kept in
    ``csrc/zo_aircomp.cu`` only to be timed here beside the one-launch
    design. Not on any path."""
    lib = ops.build.load()["zo_aircomp"]
    m, n = x.shape
    partial = torch.empty((m, -(-n // lib.aircomp_twopass_block_cols())),
                          device=x.device)
    mean = torch.empty(n, device=x.device)
    sq = torch.empty(m, device=x.device)
    ops._check(lib.aircomp_reduce_twopass_launch(
        x.data_ptr(), s.data_ptr(), mean.data_ptr(), partial.data_ptr(),
        sq.data_ptr(), m, n, d, ops._stream()), "aircomp_reduce twopass")
    return mean, sq


def aircomp_times(torch, ops, plain_air, x, s, d, reps):
    """Times of the AirComp reduction over x ``[M, N]``: the kernel, the
    previous two-launch design, the plain version and one library call,
    beside the byte bound (each element read once, the mean written once).
    The previous design's mean must be the kernel's, bit for bit."""
    m, n = x.shape
    check(torch.equal(aircomp_twopass(torch, ops, x, s, d)[0],
                      ops.aircomp_reduce(x, s, d)[0]),
          "aircomp_reduce: the previous design's mean differs")
    ms = median_ms(torch, lambda: ops.aircomp_reduce(x, s, d), reps)
    prev = median_ms(torch, lambda: aircomp_twopass(torch, ops, x, s, d),
                     reps)
    plain_ms = median_ms(
        torch, lambda: plain_air.aircomp_reduce_plain(x, s, d),
        max(1, reps // 10), trials=3 if reps >= 10 else 1)
    # yardstick only, never called by the port: one matvec + one row norm
    library_ms = median_ms(
        torch, lambda: (s @ x, x[:, :d].square().sum(1)), reps)
    return dict(ms=ms, previous_ms=prev, plain_ms=plain_ms,
                library_ms=library_ms,
                **bound(m * n * 4 + n * 4 + m * 8, 2 * m * n + 2 * m * d,
                        "fp32"))


def aircomp_line(shape, r):
    return (f"aircomp_reduce {shape}: ms {r['ms']:.5f} (previous two-launch "
            f"design {r['previous_ms']:.5f}, {r['previous_ms'] / r['ms']:.2f}x)"
            f" plain {r['plain_ms']:.4f} library {r['library_ms']:.5f} bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it)")


def dirnorms_from_walk(torch, ops, plain, k, d, b2):
    """[M, b2] squared norms of the CUDA kernels' own normal directions
    (zo_walk of zeros with ab = (1, 0): v_n exactly, up to the sign of a
    zero) summed in the norms kernel's order by its torch twin."""
    m = k.shape[0]
    zeros = torch.zeros(m, d, device=k.device)
    ab = torch.tensor([[1.0, 0.0]] * m, device=k.device)
    per = plain.dirnorm_geometry(d, m * b2)[0]
    out = []
    for n in range(b2):
        g = ops.zo_walk(zeros, k, (n, n), ab)
        out.append(plain.dirnorm_order_sum(g * g, per))
    return torch.stack(out, dim=1)


def threefry_ops(evals, threads):
    """int32 operations of ``evals`` Threefry evaluations made by
    ``threads`` threads."""
    return evals * THREEFRY_EVAL_OPS + threads * THREEFRY_THREAD_OPS


def bound(nbytes, ops, kind):
    """Least time: the larger of bytes over HBM rate and operations over the
    peak rate of their type."""
    rate = {"int": INT32_OP_PER_S, "fp32": FP32_FLOP_PER_S,
            "bf16": BF16_FLOP_PER_S}[kind]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def bf16_ulp_err(torch, got, want, floor):
    """max |got - want| in units of the bfloat16 spacing at |want|, the
    spacing taken no finer than at ``floor``."""
    w = want.float().abs().clamp_min(floor)
    _, e = torch.frexp(w)                 # w = m * 2**e, m in [0.5, 1)
    spacing = torch.ldexp(torch.ones_like(w), e - 8)  # 8 significant bits
    return float(((got.float() - want.float()).abs() / spacing).max())


def hold_rmsnorm(torch, ops, plain_rms, x, sc):
    """``ops.rmsnorm(x, sc)`` on rows ``x`` ``[R, D]`` against its plain
    version. float32: elementwise relative 1e-5 (another summation order
    of the mean square); bf16: 1 ulp of the output. Returns (the kernel's
    output, its max abs error, the printed note)."""
    got = ops.rmsnorm(x, sc, eps=1e-6)
    want = plain_rms.rmsnorm_plain(x, sc, eps=1e-6)
    tag = (f"rmsnorm {'fp32' if x.dtype == torch.float32 else 'bf16'} "
           f"{list(x.shape)}")
    check(got.dtype == x.dtype and got.shape == x.shape,
          f"{tag}: output {got.dtype} {tuple(got.shape)}")
    if x.dtype == torch.float32:
        rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
        check(rel <= 1e-5, f"{tag}: rel {rel}")
        note = f"{tag}: max rel {rel:.2e}"
    else:
        u = bf16_ulp_err(torch, got, want, 1e-30)
        check(u <= 1, f"{tag}: {u} bf16 ulp")
        note = f"{tag}: {u:.0f} bf16 ulp, bitwise {torch.equal(got, want)}"
    return got, float((got.float() - want.float()).abs().max()), note


def hold_attention(torch, ops, plain_flash, q, k, v, causal, window):
    """``ops.attention`` on ``[B, S, H, D]`` (v's head dim Dv may differ)
    against its plain version, at the default scale 1/√D. float32: max
    |err| within 1e-5 of max |out|; bf16: the rule of
    ``bf16_attention_errs``. Returns (max abs error, the printed note)."""
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = plain_flash.flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
    dv = v.shape[3]
    tag = (f"attention {'fp32' if q.dtype == torch.float32 else 'bf16'} "
           f"{list(q.shape[:2])}"
           f"{'' if k.shape[1] == q.shape[1] else f' over Sk {k.shape[1]}'} "
           f"{q.shape[2]}/{k.shape[2]} D={q.shape[3]}"
           f"{'' if dv == q.shape[3] else f' Dv={dv}'}"
           f"{'' if causal else ' non-causal'}"
           f"{f' window {window}' if window else ''}")
    check(got.dtype == q.dtype and got.shape == q.shape[:3] + (dv,),
          f"{tag}: output {got.dtype} {tuple(got.shape)}")
    if q.dtype == torch.float32:
        rel = float((got - want).abs().max()) / float(want.abs().max())
        check(rel <= 1e-5, f"{tag}: rel {rel}")
        note = f"{tag}: max err / max |out| {rel:.2e}"
    else:
        u, r, t = bf16_attention_errs(torch, q, k, v, got, want, causal,
                                      window)
        check(u <= (1 if r <= 1 else 1 + r), f"{tag}: {u} bf16 ulp from the "
              f"plain version, which is {r} from float64")
        note = (f"{tag}: {u:.2f} bf16 ulp from the plain version ({r:.2f} "
                f"from float64; the kernel {t:.2f})")
    return float((got.float() - want.float()).abs().max()), note


def hold_attention_long(torch, ops, plain_flash, q, k, v, causal, window):
    """``hold_attention`` for the cross-attention families' long calls
    (Sk 1,000 to 4,096 keys a query, non-causal). float32 as phase 2:
    max |err| within 1e-5 of max |out|. bfloat16: each element within one
    bf16 ulp of |want| plus that float32 tolerance. Both outputs are their
    float32 values rounded once to bfloat16 (the kernel carries p in three
    bf16 pieces, so its P.V is float32 arithmetic), and phase 2 holds the
    two float32 values within 1e-5 of max |out| of each other; each
    rounding moves a value by at most half an ulp. Phase 2's bfloat16 rule
    (1 ulp, or 1 + r where the plain version is r ulps from float64)
    assumes the kernel within 1 ulp of float64 everywhere; over thousands
    of keys float32 sums put both versions 1.3-2.2 ulps from float64 at
    outputs far below max |out|, whose ulp is fine (H100 80GB HBM3, phase
    12 and the card tests), and the rule then fails on some draws: the
    note prints its three distances beside the check. Returns (max abs
    error, the printed note)."""
    if q.dtype == torch.float32:
        return hold_attention(torch, ops, plain_flash, q, k, v, causal,
                              window)
    got = ops.attention(q, k, v, causal=causal, window=window)
    want = plain_flash.flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
    tag = (f"attention bf16 {list(q.shape[:2])} over Sk {k.shape[1]} "
           f"{q.shape[2]}/{k.shape[2]} D={q.shape[3]}"
           f"{'' if causal else ' non-causal'}")
    check(got.dtype == q.dtype and got.shape == q.shape[:3] + v.shape[3:],
          f"{tag}: output {got.dtype} {tuple(got.shape)}")
    w = want.float()
    tol = 1e-5 * float(w.abs().max())
    err = (got.float() - w).abs()
    _, e = torch.frexp(w.abs().clamp_min(1e-30))   # |w| = m * 2**e
    spacing = torch.ldexp(torch.ones_like(w), e - 8)
    worst = float((err / (spacing + tol)).max())
    check(worst <= 1, f"{tag}: |err| up to {worst:.3f} of one bf16 ulp + "
          f"1e-5 max |out|")
    u, r, t = bf16_attention_errs(torch, q, k, v, got, want, causal, window)
    note = (f"{tag}: |err| at most {worst:.3f} of one bf16 ulp + 1e-5 max "
            f"|out| ({u:.2f} bf16 ulp from the plain version, {r:.2f} "
            f"from float64; the kernel {t:.2f})")
    return float(err.max()), note


def check_lm_kernels(torch, ops, plain_rms, plain_flash):
    """Phase 2, transformer kernels. Returns {kernel: row of the JSON
    table, without launches}."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = "cuda"
    rows, lines = {}, []

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    # rmsnorm: the block norms' [B*S, d_model] and a qk_norm's
    # [B*S*Hq, head_dim] rows. float32: elementwise relative 1e-5 (another
    # summation order of the mean square); bf16: 1 ulp of the output
    errs = []
    for r, d in ((LM_B * LM_S, LM_DM), (LM_B * LM_S * LM_HQ, LM_HD)):
        for dt in (torch.float32, torch.bfloat16):
            x, sc = rnd(r, d, dtype=dt), (1.0 + 0.1 * rnd(d)).to(dt)
            got, err, note = hold_rmsnorm(torch, ops, plain_rms, x, sc)
            lines.append(note)
            errs.append(err)
            check(torch.equal(got, plain_rms.rmsnorm_kernel_order(
                x, sc, eps=1e-6)), f"rmsnorm {dt} [{r}, {d}]: not its twin")
            # a view one element past a 16-byte boundary: scalar loads
            xo = torch.empty(r * d + 1, device=dev, dtype=dt)[1:].view(r, d)
            xo.copy_(x)
            check(torch.equal(ops.rmsnorm(xo, sc, eps=1e-6), got),
                  f"rmsnorm {dt} [{r}, {d}] at an odd offset differs")
    lines.append("rmsnorm: bitwise its twin (rmsnorm_kernel_order) at both "
                 "shapes and dtypes, and at an odd element offset")
    r, d = LM_B * LM_S, LM_DM
    x, sc = rnd(r, d), 1.0 + 0.1 * rnd(d)
    ms = median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 100)
    plain_ms = median_ms(torch,
                         lambda: plain_rms.rmsnorm_plain(x, sc, eps=1e-6), 50)
    # yardstick only, never called by the port
    library_ms = median_ms(
        torch, lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-6), 100)
    rows["rmsnorm"] = dict(
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:29", max_abs_err=max(errs),
        ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        **bound(2 * r * d * 4 + d * 4, 4 * r * d, "fp32"))
    xb, scb = x.bfloat16(), sc.bfloat16()
    rows["rmsnorm"]["bf16"] = dict(
        ms=median_ms(torch, lambda: ops.rmsnorm(xb, scb), 100),
        plain_ms=median_ms(torch, lambda: plain_rms.rmsnorm_plain(xb, scb),
                           50),
        library_ms=median_ms(torch, lambda: F.rms_norm(
            xb, (d,), weight=scb, eps=1e-6), 100),
        **bound(2 * r * d * 2 + d * 2, 4 * r * d, "fp32"))
    for tag, f in (("fp32", rows["rmsnorm"]),
                   ("bf16", rows["rmsnorm"]["bf16"])):
        lines.append(f"rmsnorm {tag} [{r}, {d}]: ms {f['ms']:.5f} plain "
                     f"{f['plain_ms']:.5f} library {f['library_ms']:.5f} "
                     f"({f['ms'] / f['library_ms']:.2f}x F.rms_norm) bound "
                     f"{f['bound_ms']:.5f} ({f['bound_by']}, "
                     f"{f['bound_ms'] / f['ms']:.1%} of it)")
    xq = rnd(LM_B * LM_S * LM_HQ, LM_HD)
    sq = 1.0 + 0.1 * rnd(LM_HD)
    lines.append("rmsnorm fp32 [{}, {}]: ms {:.5f} library {:.5f}".format(
        *xq.shape, median_ms(torch, lambda: ops.rmsnorm(xq, sq), 100),
        median_ms(torch, lambda: F.rms_norm(xq, (LM_HD,), weight=sq,
                                            eps=1e-6), 100)))
    # a [G, D] scale (the client-batched forward: G clients' rows, each
    # group under its own scale row, read as a strided layer slice): bitwise
    # the twin at the batched Qwen2 forward's shapes, G = 1 and 4
    for lead, dd in (((LM_B * LM_S,), LM_DM),
                     ((QWEN_M, LM_B * LM_S), LM_DM),
                     ((QWEN_M, LM_B * LM_S * LM_HQ), LM_HD)):
        for dt in (torch.float32, torch.bfloat16):
            G = lead[0] if len(lead) > 1 else 1
            xg = rnd(*lead, dd, dtype=dt)
            scv = (1.0 + 0.1 * rnd(G, 3, dd)).to(dt)[:, 1]
            scv = scv if G > 1 else scv[0]
            check(torch.equal(ops.rmsnorm(xg, scv),
                              plain_rms.rmsnorm_kernel_order(xg, scv)),
                  f"rmsnorm {dt} G={G} {list(lead)}: not its twin")
    lines.append("rmsnorm: bitwise its twin with a [G, D] scale view, G = 1 "
                 "and 4, at the batched forward's shapes, both dtypes")
    # the same [512, 896] float32 rows as one group and as four, in turns
    scg = 1.0 + 0.1 * rnd(4, d)
    g1 = [median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 100)]
    g4 = [median_ms(torch, lambda: ops.rmsnorm(x, scg, eps=1e-6), 100)]
    g1.append(median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 100))
    g4.append(median_ms(torch, lambda: ops.rmsnorm(x, scg, eps=1e-6), 100))
    g1, g4 = min(g1), min(g4)
    rows["rmsnorm"]["groups4_ms"] = g4
    lines.append(f"rmsnorm fp32 [{r}, {d}]: G = 1 {g1:.5f} ms, G = 4 "
                 f"{g4:.5f} ms ({g4 / g1:.3f}x G = 1, {g4 / library_ms:.2f}x "
                 f"F.rms_norm)")
    xb4 = rnd(QWEN_M * r, d)
    sc4 = 1.0 + 0.1 * rnd(QWEN_M, d)
    lines.append("rmsnorm fp32 [{}, {}] G = {} (the batched flat round's "
                 "norms): ms {:.5f}".format(
                     QWEN_M * r, d, QWEN_M,
                     median_ms(torch, lambda: ops.rmsnorm(xb4, sc4), 100)))

    # flash attention, [B, S, H, D] layout. float32: max |err| within 1e-5
    # of max |out| (the dot products and the softmax sums run in another
    # order); bf16: 1 bf16 ulp of the output, the ulp taken no finer than at
    # 1e-5 * max |out| (below that the float32 reordering, not the final
    # rounding, decides which neighbour the two results round to)
    errs = []
    cases = [("main", LM_B, LM_S, True, 0), ("ragged S=100", 2, 100, True, 0),
             ("window 32", 2, LM_S, True, 32),
             ("non-causal S=100", 2, 100, False, 0),
             # several K/V tiles through the two staging buffers
             ("causal S=512", 1, 512, True, 0),
             ("ragged S=1000 window 256", 1, 1000, True, 256)]
    for name, b, sq, causal, window in cases:
        for dt in (torch.float32, torch.bfloat16):
            q = rnd(b, sq, LM_HQ, LM_HD, dtype=dt)
            k = rnd(b, sq, LM_HKV, LM_HD, dtype=dt)
            v = rnd(b, sq, LM_HKV, LM_HD, dtype=dt)
            got = ops.attention(q, k, v, causal=causal, window=window)
            want = plain_flash.flash_attention_plain(q, k, v, causal=causal,
                                                     window=window)
            check(got.dtype == dt and got.shape == q.shape,
                  f"attention {name}: output {got.dtype} {tuple(got.shape)}")
            top = float(want.float().abs().max())
            if dt == torch.float32:
                rel = float((got - want).abs().max()) / top
                check(rel <= 1e-5, f"attention {name} fp32: rel {rel}")
                lines.append(f"flash_attention {name} fp32: max err / max "
                             f"|out| {rel:.2e}")
            else:
                u = bf16_ulp_err(torch, got, want, 1e-5 * top)
                check(u <= 1, f"attention {name} bf16: {u} bf16 ulp")
                lines.append(f"flash_attention {name} bf16: {u:.2f} bf16 "
                             f"ulp, bitwise {torch.equal(got, want)}")
            errs.append(float((got.float() - want.float()).abs().max()))
    q = rnd(LM_B, LM_S, LM_HQ, LM_HD)
    k, v = rnd(LM_B, LM_S, LM_HKV, LM_HD), rnd(LM_B, LM_S, LM_HKV, LM_HD)

    def sdpa(q, k, v):
        # yardstick only, never called by the port: [B, H, S, D] views
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    ms = median_ms(torch, lambda: ops.attention(q, k, v, causal=True), 50)
    plain_ms = median_ms(
        torch, lambda: plain_flash.flash_attention_plain(q, k, v), 20)
    library_ms = median_ms(torch, lambda: sdpa(q, k, v), 50)
    pairs = LM_S * (LM_S + 1) // 2          # causal (q, k) pairs per head
    flops = 4 * LM_HD * pairs * LM_B * LM_HQ  # q.k and p.v multiply-adds
    nbytes = 4 * LM_B * LM_S * LM_HD * (2 * LM_HQ + 2 * LM_HKV)
    rows["flash_attention"] = dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:90",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, **bound(nbytes, flops, "fp32"))
    r = rows["flash_attention"]
    lines.append(
        f"flash_attention fp32 main: ms {ms:.5f} plain {plain_ms:.5f} library "
        f"{library_ms:.5f} ({ms / library_ms:.2f}x SDPA) bound "
        f"{r['bound_ms']:.5f} ({r['bound_by']}, {r['bound_ms'] / ms:.1%} of "
        f"it)")
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    bb = bound(nbytes // 2, flops, "bf16")
    ms_b = median_ms(torch, lambda: ops.attention(qb, kb, vb), 50)
    lib_b = median_ms(torch, lambda: sdpa(qb, kb, vb), 50)
    lines.append(
        "flash_attention bf16 main: ms {:.5f} plain {:.5f} library {:.5f} "
        "({:.2f}x SDPA) bound {:.5f} ({}, {:.1%} of it)".format(
            ms_b,
            median_ms(torch, lambda: plain_flash.flash_attention_plain(
                qb, kb, vb), 20),
            lib_b, ms_b / lib_b, bb["bound_ms"], bb["bound_by"],
            bb["bound_ms"] / ms_b))
    lines += check_attention_head_dims(torch, ops, plain_flash, rnd, rows)
    lines += check_classifier_kernels(torch, ops, plain_rms, plain_flash,
                                      rnd, rows)
    for line in lines:
        print(line)
    return rows


# head dims beyond the main shape's: 16 (the neural transformer track's
# d_model 32 over 2 heads; here with Qwen2-0.5B's 14 q over 2 kv heads),
# 128 (Qwen3-4B: 32 q heads over 8 kv heads) and 256 (Gemma-2B: 8 q heads
# over 1 kv head)
EXTRA_HEAD_DIMS = {16: (14, 2), 128: (32, 8), 256: (8, 1)}


def attention_f64(torch, q, k, v, causal, window):
    """softmax(q kᵀ / √D + mask) v in float64 (GQA by head repetition; v's
    head dim may differ from D), on q's device."""
    Sq, Hq, D = q.shape[1:]
    Sk, Hkv = k.shape[1], k.shape[2]
    kk, vv = (t.double().repeat_interleave(Hq // Hkv, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.double() / math.sqrt(D), kk)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vv)


def bf16_attention_errs(torch, q, k, v, got, want, causal, window):
    """(kernel vs plain, plain vs float64, kernel vs float64) in bf16 ulps,
    the ulp taken no finer than at 1e-5 · max |out|. The rule of the bf16
    design's CPU test (``tests/test_torch_lm_kernels.py``): the kernel is
    held within 1 ulp of the plain version, or 1 + r where the plain
    version's own float32 rounding puts it r > 1 ulp from the float64
    values (triangle inequality). At head dim 256 a score sums 256
    products, and on an H100 the plain version read up to 1.67 ulp from
    float64 while the kernel stayed within 1."""
    truth = attention_f64(torch, q, k, v, causal, window).float()
    floor = 1e-5 * float(truth.abs().max())
    return (bf16_ulp_err(torch, got, want, floor),
            bf16_ulp_err(torch, want, truth, floor),
            bf16_ulp_err(torch, got, truth, floor))


def check_attention_head_dims(torch, ops, plain_flash, rnd, rows):
    """Phase 2: flash attention at head dims 16, 128 and 256, both dtypes,
    under ``hold_attention``'s tolerances (causal, sliding window, GQA,
    ragged S), and timed against SDPA at [4, 128, Hq, D]. Returns the printed lines; the
    times go to the attention row's ``head_dims`` entry."""
    import torch.nn.functional as F
    lines, out = [], {}
    for hd, (hq, hkv) in EXTRA_HEAD_DIMS.items():
        cases = [("causal", LM_B, LM_S, True, 0),
                 ("window 32, ragged S=100", 2, 100, True, 32),
                 ("non-causal S=130", 1, 130, False, 0),
                 ("causal S=300", 1, 300, True, 0)]
        for name, b, sq, causal, window in cases:
            for dt in (torch.float32, torch.bfloat16):
                q = rnd(b, sq, hq, hd, dtype=dt)
                k = rnd(b, sq, hkv, hd, dtype=dt)
                v = rnd(b, sq, hkv, hd, dtype=dt)
                lines.append(hold_attention(torch, ops, plain_flash, q, k, v,
                                            causal, window)[1])
        q = rnd(LM_B, LM_S, hq, hd)
        k, v = rnd(LM_B, LM_S, hkv, hd), rnd(LM_B, LM_S, hkv, hd)
        pairs = LM_S * (LM_S + 1) // 2
        flops = 4 * hd * pairs * LM_B * hq
        nbytes = 4 * LM_B * LM_S * hd * (2 * hq + 2 * hkv)
        for dt, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            ms = median_ms(torch, lambda: ops.attention(qd, kd, vd), 50)
            lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
                qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
                is_causal=True, enable_gqa=True), 50)
            plain_ms = median_ms(torch, lambda: plain_flash
                                 .flash_attention_plain(qd, kd, vd), 10)
            bd = bound(nbytes // (1 if dt == torch.float32 else 2), flops,
                       kind)
            out[f"{hd} {kind}"] = dict(ms=ms, plain_ms=plain_ms,
                                       library_ms=lib, **bd)
            lines.append(
                f"flash_attention D={hd} {kind} [{LM_B}, {LM_S}, {hq}/{hkv}, "
                f"{hd}] causal: ms {ms:.5f} plain {plain_ms:.4f} library "
                f"{lib:.5f} ({ms / lib:.2f}x SDPA) bound {bd['bound_ms']:.5f}"
                f" ({bd['bound_by']}, {bd['bound_ms'] / ms:.1%} of it)")
    rows["flash_attention"]["head_dims"] = out
    return lines


# the neural transformer track (workloads/neural.py): S = 8 patch tokens,
# 2 heads; head dim 16 at its default d_model 32, 8 at the reference's test
# and figure sizes (d_model 16). Batch rows: M.b1 = 250 on the flat round,
# M.b2.b1 = 5,000 on the wide route's perturbed cohort (M 10, b1 25, b2 20)
CLS_S, CLS_H, CLS_M, CLS_B1, CLS_B2 = 8, 2, 10, 25, 20


def check_classifier_kernels(torch, ops, plain_rms, plain_flash, rnd, rows):
    """Phase 2: flash attention at the transformer track's shapes (float32,
    causal, [250 or 5,000, 8, 2, 16 or 8]) against its plain version
    within 1e-5 of max |out| and timed beside SDPA; RMSNorm over the wide
    cohort's 200 groups of 200 rows of D = 32 and the flat round's 10 of
    200, bitwise its twin. Times go to the attention row's ``classifier``
    entry. Returns the printed lines."""
    import torch.nn.functional as F
    lines, out = [], {}
    pairs = CLS_S * (CLS_S + 1) // 2   # causal (q, k) pairs per head
    for hd in (16, 8):
        for b in (CLS_M * CLS_B1, CLS_M * CLS_B2 * CLS_B1):
            q, k, v = (rnd(b, CLS_S, CLS_H, hd) for _ in range(3))
            got = ops.attention(q, k, v)
            want = plain_flash.flash_attention_plain(q, k, v)
            rel = float((got - want).abs().max()) / float(want.abs().max())
            tag = f"attention [{b}, {CLS_S}, {CLS_H}, {hd}] fp32"
            check(rel <= 1e-5, f"{tag}: rel {rel}")
            ms = median_ms(torch, lambda: ops.attention(q, k, v), 50)
            lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True), 50)
            plain_ms = median_ms(torch, lambda: plain_flash
                                 .flash_attention_plain(q, k, v), 10)
            # q, k, v read and out written; q.k and p.v multiply-adds
            bd = bound(4 * 4 * b * CLS_S * CLS_H * hd,
                       4 * hd * pairs * b * CLS_H, "fp32")
            out[f"{b}x{hd}"] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib, max_rel_err=rel, **bd)
            lines.append(
                f"{tag}: max err / max |out| {rel:.2e}; ms {ms:.5f} plain "
                f"{plain_ms:.4f} library {lib:.5f} ({ms / lib:.2f}x SDPA) "
                f"bound {bd['bound_ms']:.5f} ({bd['bound_by']}, "
                f"{bd['bound_ms'] / ms:.1%} of it)")
    rows["flash_attention"]["classifier"] = out
    for g in (CLS_M, CLS_M * CLS_B2):
        x = rnd(g, CLS_B1 * CLS_S, 32)
        sc = (1.0 + 0.1 * rnd(g, 3, 32))[:, 1]
        check(torch.equal(ops.rmsnorm(x, sc),
                          plain_rms.rmsnorm_kernel_order(x, sc)),
              f"rmsnorm [{g}, {CLS_B1 * CLS_S}, 32]: not its twin")
        ms = median_ms(torch, lambda: ops.rmsnorm(x, sc), 100)
        lines.append(f"rmsnorm fp32 [{g * CLS_B1 * CLS_S}, 32] in {g} "
                     f"groups: bitwise its twin; ms {ms:.5f}")
    return lines


def check_full_width(torch, ops, plain, plain_air):
    """Phase 2, the flat kernels at the Qwen2-0.5B train step's width: one
    client row of n_pad = 494,075,904, b2 = 8. Returns {kernel: fields for
    the row's ``full_width`` entry}. Same tolerances as at the round's
    shapes, except the norms: a float32 sum of 120,615 chunk partials (the
    kernel) against one of 7,539 block sums (the plain version) differs by
    about sqrt(n)·ulp of the total, so a relative 1e-4."""
    g = torch.Generator(device="cuda").manual_seed(3)
    dev = "cuda"
    x = torch.randn(1, QWEN_N_PAD, generator=g, device=dev) * 0.02
    k = torch.randint(0, 2 ** 32, (1, 2), generator=g, device=dev,
                      dtype=torch.int64)
    # the walk's and replay's own scales: mu/|v| and lr·coeff/(b2·|v|)
    ab = torch.randn(1, 2, generator=g, device=dev) * 5e-8
    c = torch.randn(1, QWEN_B2, generator=g, device=dev) * 1e-9
    # |v| <= 5.9 for Box-Muller on 24-bit uniforms: a bound on the summed
    # terms' magnitude for the 4-ulp check
    out, lines = {}, []

    got = ops.zo_walk(x, k, (3, 4), ab)
    want = plain.zo_walk_plain(x, k, (3, 4), ab)
    exact = torch.equal(got, want)
    u = 0.0 if exact else ulp_err(
        torch, got, want, x.abs() + 5.9 * ab.abs().sum(1, keepdim=True))
    check(u <= 4, f"zo_walk full width: {u} ulp")
    walk_err = float((got - want).abs().max())
    lines.append(f"zo_walk full width: bitwise {exact}, max_abs_err "
                 f"{walk_err:.3e}")
    del got, want
    got = ops.zo_replay(x, k, c)
    want = plain.zo_replay_plain(x, k, c)
    exact = torch.equal(got, want)
    u = 0.0 if exact else ulp_err(
        torch, got, want, x.abs() + 5.9 * c.abs().sum(1, keepdim=True))
    check(u <= 4, f"zo_replay full width: {u} ulp")
    replay_err = float((got - want).abs().max())
    lines.append(f"zo_replay full width: bitwise {exact}, max_abs_err "
                 f"{replay_err:.3e}")
    del got, want
    got = ops.zo_dirnorms(k, QWEN_D, b2=QWEN_B2)
    want = plain.zo_dirnorms_plain(k, QWEN_D, b2=QWEN_B2)
    rel = float(((got - want).abs() / want.abs()).max())
    check(rel <= 1e-4, f"zo_dirnorms full width: rel {rel}")
    check(torch.equal(got, ops.zo_dirnorms(k, QWEN_D, b2=QWEN_B2)),
          "zo_dirnorms full width: two calls differ")
    lines.append(f"zo_dirnorms full width: rel {rel:.2e}, two calls bitwise "
                 f"(norms^2/d {(got / QWEN_D).flatten().tolist()})")

    m, n, b2, d = 1, QWEN_N_PAD, QWEN_B2, QWEN_D
    per, chunks = plain.dirnorm_geometry(d, m * b2)
    # the finish alone (the last block's sum of an output's chunk partials),
    # launched as its own kernel on partials of the same shape
    parts = torch.rand(m * b2, chunks, generator=g, device=dev)
    fin = torch.empty(m * b2, device=dev)
    lib = ops.build.load()["zo_axpy"]

    def finish():
        ops._check(lib.zo_dirnorms_finish_launch(
            parts.data_ptr(), fin.data_ptr(), m * b2, chunks, ops._stream()),
            "zo_dirnorms finish")

    finish_ms = median_ms(torch, finish, 20)
    want_fin = parts.double().sum(1)
    check(float(((fin.double() - want_fin).abs() / want_fin).max()) <= 1e-5,
          "zo_dirnorms finish: not the sum of its partials")
    out["zo_walk"] = dict(
        max_abs_err=walk_err,
        ms=median_ms(torch, lambda: ops.zo_walk(x, k, (3, 4), ab), 8),
        plain_ms=median_ms(torch, lambda: plain.zo_walk_plain(
            x, k, (3, 4), ab), 1, trials=1),
        **bound(m * n * 8, threefry_ops(2 * m * n, m * n), "int"))
    out["zo_replay"] = dict(
        max_abs_err=replay_err,
        ms=median_ms(torch, lambda: ops.zo_replay(x, k, c), 8),
        plain_ms=median_ms(torch, lambda: plain.zo_replay_plain(x, k, c), 1,
                           trials=1),
        **bound(m * n * 8 + m * b2 * 4, threefry_ops(b2 * m * n, m * n),
                "int"))
    out["zo_dirnorms"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=median_ms(torch, lambda: ops.zo_dirnorms(k, d, b2=b2), 8),
        plain_ms=median_ms(torch, lambda: plain.zo_dirnorms_plain(
            k, d, b2=b2), 1, trials=1),
        finish_ms=finish_ms, evals_per_thread=per, chunks=chunks,
        **bound(m * 16 + m * b2 * 4,
                threefry_ops(m * b2 * d, m * b2 * chunks * 256), "int"))
    for name, f in out.items():
        lines.append(f"{name} full width: ms {f['ms']:.4f} plain "
                     f"{f['plain_ms']:.1f} bound {f['bound_ms']:.4f} "
                     f"({f['bound_by']}, {f['bound_ms'] / f['ms']:.1%} of it)")
    lines.append(f"zo_dirnorms full width: finish alone {finish_ms:.5f} ms "
                 f"({chunks} partials an output, {per} evaluations a thread)")
    del x, got, want, parts
    torch.cuda.empty_cache()

    # aircomp_reduce at the flat Qwen2-0.5B AirComp round: M = 4 client
    # deltas of n_pad. The norms within 1e-4 relative of the plain version
    # (the full-width dirnorms argument: a float32 sum of ~7,500 block sums
    # against one of ~460 tile totals a block, each off by about
    # sqrt(n)·ulp of the total) and bitwise the twin
    ma = QWEN_M
    x = torch.randn(ma, QWEN_N_PAD, generator=g, device=dev) * 1e-5
    s = torch.rand(ma, generator=g, device=dev)
    mean, sq = ops.aircomp_reduce(x, s, QWEN_D)
    pmean, psq = plain_air.aircomp_reduce_plain(x, s, QWEN_D)
    check(torch.equal(mean, pmean), "aircomp_reduce full width: mean differs")
    rel = float(((sq - psq).abs() / psq).max())
    check(rel <= 1e-4, f"aircomp_reduce full width: sq rel {rel}")
    err = max(float((mean - pmean).abs().max()), float((sq - psq).abs().max()))
    del pmean, psq
    per_a, grid_a = ops.aircomp_geometry(QWEN_N_PAD, x.device)
    check(torch.equal(sq, plain_air.aircomp_sq_order_sum(
        x, QWEN_D, per=per_a, grid=grid_a)),
          "aircomp_reduce full width: sq not its twin")
    f = aircomp_times(torch, ops, plain_air, x, s, QWEN_D, 8)
    f["max_abs_err"] = err
    out["aircomp_reduce"] = f
    lines = [f"aircomp_reduce full width: mean bitwise, sq rel {rel:.2e}, sq "
             f"bitwise its twin (per {per_a}, grid {grid_a})",
             aircomp_line(f"[{ma}, {QWEN_N_PAD}]", f)]
    for line in lines:
        print(line)
    return out


def check_axpy_kernels(torch, ops, plain):
    """Phase 2, zo_axpy and zo_axpy2: bitwise against their plain versions
    (both round the product, then the sum, in float32; the build never
    contracts them into an FMA). Returns {kernel: row of the JSON table,
    without launches}."""
    g = torch.Generator(device="cuda").manual_seed(4)
    dev, f32, bf16 = "cuda", torch.float32, torch.bfloat16
    lines, errs = [], {"zo_axpy": [], "zo_axpy2": []}

    def view(shape, dt, off):
        base = torch.randn(math.prod(shape) + off, generator=g,
                           device=dev).to(dt)
        return base[off:].view(shape)

    # the pytree route's scalars: mu and lr*c_n/b2, tensors on the card
    a, b = torch.randn(2, generator=g, device=dev) * 1e-3
    cases = [((1,), (0, 0, 0)), ((7,), (0, 0, 0)), ((65_537,), (0, 0, 0)),
             ((65_537,), (1, 1, 1)), ((65_537,), (3, 0, 5)),
             (QWEN_EMBED, (0, 0, 0)), (QWEN_W_GATE, (0, 0, 0))]
    for dts in itertools.product((f32, bf16), repeat=3):
        for shape, offs in cases:
            x, u, v = (view(shape, dt, off) for dt, off in zip(dts, offs))
            tag = (f"{'/'.join(str(t)[6:] for t in dts)} {list(shape)} "
                   f"offsets {offs}")
            got = ops.axpy(x, u, a)
            want = plain.zo_axpy_plain(x, u, a)
            check(got.dtype == x.dtype and torch.equal(got, want),
                  f"zo_axpy {tag} differs")
            errs["zo_axpy"].append(float((got.float() - want.float())
                                         .abs().max()))
            got = ops.axpy2(x, u, v, a, b)
            want = plain.zo_axpy2_plain(x, u, v, torch.stack([a, b]))
            check(got.dtype == x.dtype and torch.equal(got, want),
                  f"zo_axpy2 {tag} differs")
            errs["zo_axpy2"].append(float((got.float() - want.float())
                                          .abs().max()))
            del x, u, v, got, want
    lines.append(f"zo_axpy, zo_axpy2: bitwise in all {len(errs['zo_axpy'])} "
                 f"cases (8 dtype mixes, ragged, offsets, Qwen2 leaves)")
    # times at the embedding leaf in float32: each array read once, the
    # output written once; two flops per term
    x, u, v = (view(QWEN_EMBED, f32, 0) for _ in range(3))
    n = x.numel()
    mu = torch.full((), 1e-3, device=dev)
    rows = {
        "zo_axpy": dict(
            source="src/repro_torch/kernels/csrc/axpy.cu",
            replaces="src/repro/kernels/zo_axpy.py:103",
            max_abs_err=max(errs["zo_axpy"]),
            ms=median_ms(torch, lambda: ops.axpy(x, u, mu), 20),
            plain_ms=median_ms(torch, lambda: plain.zo_axpy_plain(x, u, mu),
                               5),
            # yardstick only, never called by the port
            library_ms=median_ms(torch, lambda: torch.add(x, u, alpha=1e-3),
                                 20),
            **bound(12 * n, 2 * n, "fp32")),
        "zo_axpy2": dict(
            source="src/repro_torch/kernels/csrc/axpy.cu",
            replaces="src/repro/kernels/zo_axpy.py:80",
            max_abs_err=max(errs["zo_axpy2"]),
            ms=median_ms(torch, lambda: ops.axpy2(x, u, v, -mu, mu), 20),
            plain_ms=median_ms(torch, lambda: plain.zo_axpy2_plain(
                x, u, v, torch.stack([-mu, mu])), 5),
            library_ms=None, **bound(16 * n, 4 * n, "fp32"))}
    # bf16 weights moved by a float32 direction, and float32 weights by a
    # bf16 tree-convention direction
    for tag, xx, uu, per in (("bf16 x, f32 u", x.bfloat16(), u, 8),
                             ("f32 x, bf16 u", x, u.bfloat16(), 10)):
        ms_b = median_ms(torch, lambda: ops.axpy(xx, uu, mu), 20)
        bound_b = bound(per * n, 2 * n, "fp32")["bound_ms"]
        lines.append("zo_axpy {} {}: ms {:.5f} plain {:.5f} library {:.5f} "
                     "bound {:.5f} ({:.1%} of it)".format(
                         tag, list(QWEN_EMBED), ms_b,
                         median_ms(torch, lambda: plain.zo_axpy_plain(
                             xx, uu, mu), 5),
                         median_ms(torch, lambda: torch.add(
                             xx, uu, alpha=1e-3), 20),
                         bound_b, bound_b / ms_b))
    # a direction that is a view at an odd element offset (the counter
    # convention slices one flat buffer) takes the scalar loop throughout
    uo = view(QWEN_EMBED, f32, 1)
    lines.append("zo_axpy float32 {}, u at element offset 1 (scalar loop): "
                 "ms {:.5f} bound {:.5f}".format(
                     list(QWEN_EMBED),
                     median_ms(torch, lambda: ops.axpy(x, uo, mu), 20),
                     rows["zo_axpy"]["bound_ms"]))
    del uo
    for name, per in (("zo_axpy", 12), ("zo_axpy2", 16)):
        r = rows[name]
        lines.append(f"{name} float32 {list(QWEN_EMBED)}: ms {r['ms']:.5f} "
                     f"plain {r['plain_ms']:.5f} library {r['library_ms']} "
                     f"bound {r['bound_ms']:.5f} ({r['bound_by']}, "
                     f"{r['bound_ms'] / r['ms']:.1%} of it); whole "
                     f"Qwen2-0.5B tree ({QWEN_D:,} float32) bound "
                     f"{per * QWEN_D / HBM_BYTES_PER_S * 1e3:.3f} ms")
    for line in lines:
        print(line)
    return rows


def run_main_path(torch, ops, neural, FedZOConfig):
    """Phase 3. Returns {kernel: launches summed over the runs}."""
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    cnn = neural.make_task("cnn", image_shape=(28, 28, 1), width=8,
                           n_clients=50)
    base = dict(flat_params=True, weight_by_size=True)
    air = dict(aircomp=True, channel_schedule=True, snr_db=5.0)
    runs = [("softmax_flat", softmax, FedZOConfig(**base), 5),
            ("softmax_aircomp", softmax, FedZOConfig(**base, **air), 5),
            ("cnn_flat", cnn, FedZOConfig(**base), 2),
            # the pytree route, the reference's default (flat_params off)
            ("softmax_pytree", softmax, FedZOConfig(weight_by_size=True), 2),
            ("softmax_aircomp_pytree", softmax,
             FedZOConfig(weight_by_size=True, **air), 1)]
    return drive_runs(torch, ops, neural, [
        (name, task, cfg, rounds,
         round_launches(ops, cfg, rounds, 2 if task is softmax else 4),
         "local")
        for name, task, cfg, rounds in runs])


# the least fall of the test loss, as a share of the starting weights' test
# loss, that the "test" descent rule accepts
TEST_DESCENT = 0.02


def drive_runs(torch, ops, neural, runs):
    """Drive each ``(name, task, cfg, rounds, want, descend)`` run
    through ``neural.run``, one round per call with the carry passed back
    in, so each round is timed on its own. The launch counters are set to
    0 before the run and must equal ``want`` after it; the test set is
    evaluated once, after the counts. Checks that metrics, evals and
    weights are finite and that the loss went down by the run's rule:
    ``"local"``, the last round's mean local loss below the first
    iterate's loss of round 1; ``"test"``, the test loss at least
    ``TEST_DESCENT`` of the start below that of the starting weights (the
    transformer track's per-round losses on fresh batches move by more
    than a round's progress); None, no check (a run of one round of one
    iterate); ``"mean"``, the last round's mean local loss below the first
    round's (FedAvg, whose metrics have no first-iterate loss). A run's
    strategy (``cfg.strategy``) carries its state from round to round.
    Prints ms per round, the peak memory and the counts. Returns {kernel:
    launches summed over the runs}."""
    from repro_torch.utils.tree import tree_leaves
    total = {k: 0 for k in ops.LAUNCHES}
    for name, task, cfg, rounds, want, descend in runs:
        if descend == "test":
            before = float(neural.task_eval(task)(neural.params_init(
                task, cfg.seed))["test_loss"])
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        params = key = momentum = zstate = None
        per_round, mets = [], {}
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = neural.run(task, cfg, 1, eval_every=0, params=params,
                             key=key, momentum=momentum, zstate=zstate)
            torch.cuda.synchronize()
            per_round.append(1e3 * (time.perf_counter() - t0))
            params, key, momentum, zstate = (res.params, res.key,
                                             res.momentum,
                                             res.strategy_state)
            for k, v in res.metrics.items():
                mets.setdefault(k, []).extend(v.cpu().tolist())
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(counts == want, f"{name}: launches {counts} != {want}")
        evals = {k: float(v)
                 for k, v in neural.task_eval(task)(params).items()}
        for k, v in list(mets.items()) + [(k, [v]) for k, v in evals.items()]:
            check(all(map(math.isfinite, v)), f"{name}: {k} not finite: {v}")
        for p in tree_leaves(params):
            check(bool(torch.isfinite(p).all()), f"{name}: param not finite")
        if descend == "local":
            check(mets["mean_local_loss"][-1] < mets["first_loss"][0],
                  f"{name}: loss did not descend: {mets}")
        elif descend == "mean":
            check(mets["mean_local_loss"][-1] < mets["mean_local_loss"][0],
                  f"{name}: loss did not descend: {mets}")
        elif descend == "test":
            check(evals["test_loss"] <= (1 - TEST_DESCENT) * before,
                  f"{name}: test loss {evals['test_loss']} not "
                  f"{TEST_DESCENT:.0%} below {before} at the start")
        # round 1 carries one-time set-up (a one-round run has only it)
        steady = sorted(per_round[1:]) or per_round
        print(f"{name}: ms/round {[round(t, 3) for t in per_round]} "
              f"(median after round 1 {steady[len(steady) // 2]:.3f}); peak "
              f"memory {peak:.3f} GiB; launches {counts}")
        print(f"{name}: metrics {json.dumps(mets)}")
        print(f"{name}: evals {json.dumps(evals)}")
        for k in total:
            total[k] += counts[k]
    return total


# the transformer track's stack: 1 layer, 12 parameter leaves
CLS_LAYERS, CLS_LEAVES = 1, 12


def round_launches(ops, cfg, rounds, n_leaves=0, L=0):
    """Launches of ``rounds`` simulated rounds of a model with ``n_leaves``
    parameter leaves whose forward runs 2L + 1 RMSNorms and L attentions.
    Per iterate: on the flat route b2 walks, one replay, one norms launch
    and b2 + 1 batched forwards (one launch covers the cohort, whatever M
    is); on the pytree route 2·b2 zo_axpy per client and leaf and M·(b2 +
    1) forwards; on the wide route no walk, replay or norms (its directions
    come from the torch Threefry chain) and two batched forwards, the base
    and the M·b2 perturbed copies (three with a central difference).
    AirComp adds its reduction and the noise walk on the flat and wide
    routes."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    iters = rounds * cfg.local_iters
    air = rounds if cfg.aircomp else 0
    if cfg.batch_directions:
        want.update(zo_walk=air, aircomp_reduce=air)
        forwards = iters * (3 if cfg.central else 2)
    elif cfg.flat_params:
        want.update(zo_walk=iters * cfg.b2 + air, zo_replay=iters,
                    zo_dirnorms=iters, aircomp_reduce=air)
        forwards = iters * (cfg.b2 + 1)
    else:
        want["zo_axpy"] = (iters * cfg.n_participating * 2 * cfg.b2
                           * n_leaves)
        forwards = iters * cfg.n_participating * (cfg.b2 + 1)
    if L:
        want.update(rmsnorm=forwards * (2 * L + 1),
                    flash_attention=forwards * L)
    return want


def run_track_rounds(torch, ops, neural, FedZOConfig):
    """Phase 3, the transformer track and the wide route, at the other
    rounds' settings (N = 50, M = 10, H = 5, b1 = 25, b2 = 20, size-
    weighted): the track at its defaults (784 features in 8 patch tokens,
    d_model 32 over 2 heads, d_ff 64, 1 layer; d = 12,000) and at its own
    lr (``neural.default_config``: 5e-3 where the softmax runs take
    FedZOConfig's 1e-3) on the flat route 3 rounds, flat with AirComp 2
    rounds, and one pytree round cut to H = 1 (a whole one is 24,000
    zo_axpy launches), also with bfloat16 tree-convention directions
    (sphere and gaussian: float32 weights, bfloat16 directions into
    zo_axpy); the wide route (``batch_directions``) on softmax and on the
    track with ``block`` directions, 3 rounds each, and on softmax one
    round each of ``tree``, ``channel``, ``surrogate`` and ``block`` with
    AirComp. Returns {kernel: launches}."""
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    track = neural.make_task("transformer", n_clients=50)
    base = dict(weight_by_size=True)
    flat = dict(flat_params=True)
    wide = dict(batch_directions=True, direction_conv="block")
    air = dict(aircomp=True, channel_schedule=True, snr_db=5.0)
    bf16 = dict(local_iters=1, direction_dtype="bfloat16")

    def on_track(**kw):
        return neural.default_config(track, n_participating=10, **kw)

    def conv(c):
        return FedZOConfig(**base, **dict(wide, direction_conv=c))

    runs = [("transformer_flat", track, on_track(**flat), 3),
            ("transformer_aircomp", track, on_track(**flat, **air), 2),
            ("transformer_pytree", track, on_track(local_iters=1), 1),
            ("transformer_pytree_bf16_sphere", track, on_track(**bf16), 1),
            ("transformer_pytree_bf16_gaussian", track,
             on_track(**bf16, estimator="gaussian"), 1),
            ("softmax_wide", softmax, FedZOConfig(**base, **wide), 3),
            ("transformer_wide", track, on_track(**wide), 3),
            ("softmax_wide_tree", softmax, conv("tree"), 1),
            ("softmax_wide_channel", softmax, conv("channel"), 1),
            ("softmax_wide_surrogate", softmax, conv("surrogate"), 1),
            ("softmax_wide_aircomp", softmax,
             FedZOConfig(**base, **wide, **air), 1)]
    print(f"transformer_pytree: cut to H = 1 (a round of H = 5 is "
          f"{5 * 10 * 2 * 20 * CLS_LEAVES:,} zo_axpy launches)")
    total = drive_runs(torch, ops, neural, [
        (name, task, cfg, rounds,
         round_launches(ops, cfg, rounds,
                        CLS_LEAVES if task is track else 2,
                        CLS_LAYERS if task is track else 0),
         None if cfg.local_iters == 1
         else "test" if task is track else "local")
        for name, task, cfg, rounds in runs])
    # where a round's time goes: one more round of three runs under the
    # profiler (not counted in the launches)
    for name, task, cfg, _ in runs:
        if name not in ("transformer_flat", "softmax_wide",
                        "transformer_wide"):
            continue
        wall, busy, kinds = kernel_time_by_kind(
            torch, lambda: neural.run(task, cfg, 1, eval_every=0))
        print(f"{name}, profiled round: wall {wall:.1f} ms, kernel time "
              f"{sum(kinds.values()):.2f} ms, busy share {busy:.3f}; by kind "
              f"(ms) {json.dumps({k: round(v, 3) for k, v in kinds.items()})}")
    return total


def lm_setup(arch, dtype, **overrides):
    """(model, token stream) of the cross-silo train step as
    ``repro/launch/train.py`` sets it up, for ``arch`` (its config's
    ``overrides`` applied: a depth cut)."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.models import api
    cfg = get_config(arch).replace(dtype=dtype, **overrides)
    model = api.build(cfg)
    # the launcher's synthetic stream: 200k tokens over a 4096-token subset
    toks = lm_token_stream(200_000, min(cfg.vocab, 4096), seed=0)
    return model, toks


def lm_batch(torch, toks, rng, batch, seq, device):
    from repro_torch.data.synthetic import lm_batches
    b = lm_batches(toks, batch, seq, rng)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def run_qwen_train(torch, ops, FedZOConfig, steps=4, profile_dir=None):
    """Phase 3, the Qwen2-0.5B train step at full width. Returns {kernel:
    launches summed over the steps}."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten

    model, toks = lm_setup("qwen2-0.5b", "float32")
    cfg = model.cfg
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    spec = flat_spec(params)
    check(spec.d == QWEN_D and spec.n_pad == QWEN_N_PAD,
          f"qwen2-0.5b: d {spec.d}, n_pad {spec.n_pad}")
    fcfg = FedZOConfig(lr=1e-4, mu=1e-3, b2=QWEN_B2, estimator="sphere",
                       flat_params=True)
    step = fedzo.make_train_step(model.loss, fcfg)
    rng, key = np.random.default_rng(0), prng.key(1)
    L = cfg.n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(zo_walk=fcfg.b2, zo_replay=1, zo_dirnorms=1,
                rmsnorm=(1 + fcfg.b2) * (2 * L + 1),
                flash_attention=(1 + fcfg.b2) * L)
    total = {k: 0 for k in ops.LAUNCHES}
    per_step, losses, norms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        batch = lm_batch(torch, toks, rng, 4, 128, "cuda")
        ks = prng.split(key, 2)
        key, sub = ks[0], ks[1]
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, mets = step(params, batch, sub)
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.perf_counter() - t0))
        counts = dict(ops.LAUNCHES)
        check(counts == want, f"qwen2-0.5b step: launches {counts} != {want}")
        for k in total:
            total[k] += counts[k]
        losses.append(float(mets["loss"]))
        norms.append(float(mets["coeff_norm"]))
    peak = torch.cuda.max_memory_allocated()
    for name, vals in (("loss", losses), ("coeff_norm", norms)):
        check(all(map(math.isfinite, vals)), f"qwen2-0.5b: {name} {vals}")
    check(bool(torch.isfinite(flatten(params, spec)).all()),
          "qwen2-0.5b: parameters not finite")
    steady = sorted(per_step[1:])  # step 1 carries one-time set-up
    print(f"qwen2_0_5b_train: d {spec.d} n_pad {spec.n_pad}; init "
          f"{init_s:.2f} s; ms/step {[round(t, 2) for t in per_step]} "
          f"(median after step 1 {steady[len(steady) // 2]:.2f}); peak "
          f"memory {peak / 2**30:.2f} GiB; launches per step {want}")
    print(f"qwen2_0_5b_train: loss {losses} coeff_norm {norms}")
    # one more full-width step from these weights, at a mu where every loss
    # difference is hundreds of ulps, against an independent recomputation
    batch = lm_batch(torch, toks, rng, 4, 128, "cuda")
    ks = prng.split(key, 2)
    key, sub = ks[0], ks[1]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = check_estimator(model, params, batch, sub, "cuda", mu=QWEN_CHECK_MU)
    print(f"qwen2_0_5b estimator check: {time.perf_counter() - t0:.1f} s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; mu {r['mu']}, loss {r['loss']} (ulp "
          f"{r['ulp']:.3e}); |L(x+mu.v_n) - L(x)| in ulps "
          f"{[round(u, 1) for u in r['diff_ulps']]} (least allowed "
          f"{CHECK_MIN_ULPS}); coefficients {r['coeffs']}; recomputed "
          f"{r['ref']}; largest relative error {r['max_rel_err']:.3e}, "
          f"largest error / tolerance {r['max_err_over_tol']:.3f}")
    if profile_dir:
        batch = lm_batch(torch, toks, rng, 4, 128, "cuda")
        profile_call(torch, lambda: step(params, batch, key),
                     profile_dir, "qwen2_train_step")
    return total


# kernel kinds of a profiled flat round, by a piece of the kernel's name
KERNEL_KINDS = (("flash_attention", ("flash_fwd",)),
                ("rmsnorm", ("rmsnorm",)),
                ("zo_walk", ("zo_walk",)), ("zo_replay", ("zo_replay",)),
                ("zo_dirnorms", ("dirnorm",)),
                ("aircomp_reduce", ("aircomp_reduce",)),
                ("float32 GEMM", ("gemm", "xmma", "cutlass", "Kernel2")))


def kernel_time_by_kind(torch, fn):
    """``fn()`` once under torch.profiler: wall ms, device busy share and
    kernel ms by kind (``KERNEL_KINDS``, the rest as "other")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kinds = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kind = next((k for k, keys in KERNEL_KINDS
                     if any(w in e.key for w in keys)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3
    busy = sum(kinds.values())
    return wall, busy / wall, dict(sorted(kinds.items(),
                                          key=lambda kv: -kv[1]))


def run_qwen_flat_round(torch, ops, FedZOConfig):
    """Phase 3, the flat FedZO round on Qwen2-0.5B at full width and depth
    in float32 (random weights from seed 0) through
    ``fedzo.round_simulated``: M = 4 clients, H = 2 iterates each on batch
    4 x seq 128 of the synthetic LM stream, b2 = 8 sphere directions,
    mu = 1e-3, lr = 1e-4; one round with the plain mean, one with AirComp
    (channel scheduling, 5 dB). The cohort's forwards run through the
    model's client-batched loss, so the launch counts are those of one
    client. Then the batched loss against each client's own ``model.loss``
    and a profiled AirComp round (kernel time by kind). Returns the
    launches of the two counted rounds."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten
    from repro_torch.utils.tree import tree_leaves

    model, toks = lm_setup("qwen2-0.5b", "float32")
    L, m, h = model.cfg.n_layers, QWEN_M, QWEN_H
    params = model.init(prng.key(0), device="cuda")
    spec = flat_spec(params)
    rng = np.random.default_rng(1)
    per = [lm_batch(torch, toks, rng, LM_B, LM_S, "cuda")
           for _ in range(m * h)]
    batches = {k: torch.stack([b[k] for b in per]).reshape(
        (m, h, LM_B, LM_S)) for k in ("tokens", "labels")}
    keys = prng.split(prng.key(1), m)
    base = dict(n_participating=m, local_iters=h, lr=1e-4, mu=1e-3,
                b2=QWEN_B2, estimator="sphere", flat_params=True)
    cfgs = {"mean": FedZOConfig(**base),
            "aircomp": FedZOConfig(**base, aircomp=True,
                                   channel_schedule=True, snr_db=5.0)}
    total = dict.fromkeys(ops.LAUNCHES, 0)
    mem = 4 * spec.n_pad
    print(f"qwen flat round: d {spec.d}, n_pad {spec.n_pad}; expected peak "
          f"about {(2 + 3 * m) * mem / 2**30:.1f} GiB of buffers (weights "
          f"and buf0, {m * mem / 2**30:.2f} GiB for each [M, n_pad] of the "
          f"cohort, the walked copy and the deltas) plus the forward's "
          f"[{m * LM_B * LM_S}, {model.cfg.vocab}] float32 logits "
          f"({m * LM_B * LM_S * model.cfg.vocab * 4 / 2**30:.2f} GiB)")
    for name, cfg in cfgs.items():
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = fedzo.round_simulated(model.loss, params, batches, keys,
                                         cfg, channel_rng=prng.key(2))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(ops.LAUNCHES)
        want = round_launches(ops, cfg, 1, L=L)
        check(counts == want, f"qwen flat round {name}: launches {counts} "
              f"!= {want}")
        for k in total:
            total[k] += counts[k]
        mets = {k: float(v) for k, v in met.items()}
        check(all(map(math.isfinite, mets.values())),
              f"qwen flat round {name}: metrics {mets}")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
              f"qwen flat round {name}: parameters not finite")
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(new), tree_leaves(params)))
        check(moved > 0, f"qwen flat round {name}: no weight moved")
        del new
        print(f"qwen flat round {name}: M {m}, H {h}, b2 {cfg.b2}: ms/round "
              f"{ms:.1f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"metrics {json.dumps(mets)}; largest weight move {moved:.3e};"
              f" launches {counts} (M-independent)")
        torch.cuda.empty_cache()

    # the batched loss on m clients' own weights (the server weights plus a
    # per-client offset, as views of one [m, n_pad] buffer) against each
    # client's own loss: the RMSNorm and attention launches are the same
    # rows either way, the batched GEMMs may take other cuBLAS algorithms,
    # so 1e-5 relative, as the card-vs-CPU loss checks allow
    g = torch.Generator(device="cuda").manual_seed(5)
    buf = flatten(params, spec)[None].repeat(m, 1)
    buf += 1e-3 * torch.randn(buf.shape, generator=g, device="cuda")
    b0 = {k: v[:, 0] for k, v in batches.items()}
    got = model.loss_batched(unflatten(buf, spec), b0)
    each = torch.stack([model.loss(unflatten(buf[i], spec),
                                   {k: v[i] for k, v in b0.items()})
                        for i in range(m)])
    rel = float(((got - each).abs() / each.abs()).max())
    ulp = torch.nextafter(each, torch.full_like(each, math.inf)) - each
    check(rel <= 1e-5, f"qwen batched loss vs each client: rel {rel}")
    print(f"qwen batched loss: {got.tolist()} against each client's own "
          f"{each.tolist()}: rel {rel:.2e} "
          f"({float(((got - each).abs() / ulp).max()):.1f} ulps)")
    del buf
    torch.cuda.empty_cache()
    wall, busy, kinds = kernel_time_by_kind(
        torch, lambda: fedzo.round_simulated(
            model.loss, params, batches, keys, cfgs["aircomp"],
            channel_rng=prng.key(2)))
    print(f"qwen flat round aircomp, profiled: wall {wall:.1f} ms, kernel "
          f"time {sum(kinds.values()):.1f} ms, busy share {busy:.3f}; by "
          f"kind (ms) {json.dumps({k: round(v, 3) for k, v in kinds.items()})}")
    return total


def check_estimator(model, params, batch, key, device, *, mu, b2=QWEN_B2,
                    min_ulps=CHECK_MIN_ULPS, tol_ulps=CHECK_TOL_ULPS,
                    norm_rel=CHECK_NORM_REL):
    """Hold one flat-route sphere step to the estimator's definition.

    ``fedzo.local_iterate`` (the walk, the norms kernel, the loss
    forwards) returns the b2 coefficients and the base loss at ``mu``. Each
    is recomputed without a ZO kernel: v_n from the plain counter-convention
    generator (``kernels/zo_axpy.counter_direction_flat``) on ``device``,
    its norm summed in float64, L_n = loss(x + mu.v_n/|v_n|) and
    c_n = d.(L_n - L_0)/mu by the estimator's formula
    (``core/estimator.py:flat_coefficients``). Raises, with the readings,
    unless every |L_n - L_0| is at least ``min_ulps`` float32 ulps of L_0 (so
    the coefficients are a signal, not rounding) and every c_n is within
    d.tol_ulps.ulp/mu + norm_rel.|ref_n| of its recomputation, and the base
    loss within tol_ulps ulps of L_0. Returns the readings."""
    import torch
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.core import fedzo
    from repro_torch.kernels.zo_axpy import counter_direction_flat
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    cfg = FedZOConfig(mu=mu, b2=b2, estimator="sphere", flat_params=True)
    _, coeffs, base = fedzo.local_iterate(model.loss, params, batch, key,
                                          cfg)
    spec = flat_spec(params)
    d = spec.d
    x = flatten(params, spec)
    loss0 = model.loss(params, batch).to(torch.float32)
    ulp = float(torch.nextafter(loss0, torch.full_like(loss0, math.inf))
                - loss0)
    kdev = key.to(device)
    ref, diffs = [], []
    for n in range(b2):
        g = counter_direction_flat(kdev, n, d, kind="normal")
        norm = math.sqrt(float(torch.sum(torch.square(g.double()))))
        xp = x.clone()
        xp[:d] += (mu / norm) * g
        del g
        ln = model.loss(unflatten(xp, spec), batch).to(torch.float32)
        del xp
        diffs.append(float(ln - loss0) / ulp)
        ref.append(float(float(d) * (ln - loss0).to(torch.float32) / mu))
    coeffs = [float(c) for c in coeffs.reshape(-1)]
    unit = d * ulp / mu          # one loss ulp in a coefficient
    tols = [tol_ulps * unit + norm_rel * abs(r) for r in ref]
    errs = [abs(c - r) for c, r in zip(coeffs, ref)]
    out = dict(mu=mu, loss=float(loss0), base=float(base), ulp=ulp,
               diff_ulps=diffs, coeffs=coeffs, ref=ref,
               max_rel_err=max(e / abs(r) for e, r in zip(errs, ref)),
               max_err_over_tol=max(e / t for e, t in zip(errs, tols)))
    check(all(abs(u) >= min_ulps for u in diffs),
          f"estimator check: a loss difference below {min_ulps} ulps at mu "
          f"{mu}, the coefficients would be rounding: {out}")
    check(abs(float(base) - float(loss0)) <= tol_ulps * ulp,
          f"estimator check: base loss {float(base)} against {float(loss0)}")
    check(all(e <= t for e, t in zip(errs, tols)),
          f"estimator check: a coefficient differs from its recomputation "
          f"by more than its tolerance: {out}")
    return out


def run_tree_axpy2(torch, ops, plain):
    """Phase 3, ``ops.tree_axpy2`` (the MeZO unperturb-and-reperturb pass)
    once over the full-width Qwen2-0.5B tree in float32: x the weights, u
    and v two sphere directions, (a, b) = (-mu, +mu) with mu = 1e-3 on the
    card. One zo_axpy2 per leaf; each leaf bitwise its plain version.
    Returns the launches."""
    from repro_torch.core import estimator
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import _leaves

    model, _ = lm_setup("qwen2-0.5b", "float32")
    params = model.init(prng.key(0), device="cuda")
    u = estimator.sample_direction(prng.key(7), params, "sphere")
    v = estimator.sample_direction(prng.key(8), params, "sphere")
    mu = torch.full((), 1e-3, device="cuda")
    ops.reset_launches()
    out = ops.tree_axpy2(params, u, v, -mu, mu)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["zo_axpy2"] = QWEN_LEAVES
    check(counts == want, f"tree_axpy2: launches {counts} != {want}")
    ab = torch.stack([-mu, mu])
    for (path, got), (_, x), (_, uu), (_, vv) in zip(
            _leaves(out), _leaves(params), _leaves(u), _leaves(v)):
        check(torch.equal(got, plain.zo_axpy2_plain(x, uu, vv, ab)),
              f"tree_axpy2 leaf {'/'.join(path)} differs")
    print(f"tree_axpy2 (Qwen2-0.5B, {len(_leaves(out))} leaves): every leaf "
          f"bitwise its plain version; launches {counts}")
    return counts


def run_qwen_pytree_cli(torch, ops, steps=3):
    """Phase 3, the pytree train step at full width through the training
    CLI in this process: Qwen2-0.5B in float32 (as the flat run, for the
    same reason), the launcher's batch 4 x seq 128, b2 = 8, mu = 1e-3, lr =
    1e-4. Per step: 2·b2 zo_axpy per leaf (b2 perturbations, b2 replayed
    updates), nine forwards' RMSNorms and attentions, nothing else.
    Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_leaves

    cfg = get_config("qwen2-0.5b")
    b2, L = 8, cfg.n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(zo_axpy=2 * b2 * QWEN_LEAVES,
                rmsnorm=(1 + b2) * (2 * L + 1), flash_attention=(1 + b2) * L)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(["--arch", "qwen2-0.5b", "--override", "dtype=float32",
                      "--steps", str(steps), "--batch", "4", "--seq", "128",
                      "--b2", str(b2), "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prev = dict.fromkeys(ops.LAUNCHES, 0)
    for i, cum in enumerate(res.launches):
        per = {k: cum[k] - prev[k] for k in cum}
        check(per == want, f"pytree CLI step {i}: launches {per} != {want}")
        prev = cum
    check(all(map(math.isfinite, res.history)),
          f"pytree CLI: loss {res.history}")
    check(all(bool(torch.isfinite(t).all()) for t in
              tree_leaves(res.params)), "pytree CLI: parameters not finite")
    steady = sorted(res.step_ms[1:]) or res.step_ms
    print(f"qwen2_0_5b_pytree_cli: ms/step "
          f"{[round(t, 1) for t in res.step_ms]} (median after step 1 "
          f"{steady[len(steady) // 2]:.1f}); whole CLI {wall:.1f} s; peak "
          f"memory {peak / 2**30:.2f} GiB; loss {res.history}; launches per "
          f"step {want}")
    return dict(res.launches[-1])


def check_small_reference(torch, neural, FedZOConfig):
    """Phase 4: the same short run on the card and on the CPU."""
    kw = dict(n_train=320, n_test=96, n_clients=6, n_features=24,
              n_classes=4, alpha=0.5)
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=8,
                      b2=4, lr=5e-2, mu=1e-3, flat_params=True,
                      flat_block_rows=4, weight_by_size=True, seed=11)
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("softmax", device=dev, **kw)
        res = neural.run(task, cfg, 4, eval_rows=96)
        out[dev] = {k: v.cpu() for k, v in res.params.items()}
    # each coefficient is d.(L+ - L)/mu: one float32 ulp of the loss (the
    # card's matmul sums in another order) moves it by d.ulp/mu ~ 0.012 here;
    # the port-vs-reference runs of this config differ by < 2e-4 on the CPU
    worst = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
                for k in out["cpu"])
    check(worst <= 2e-3, f"card vs CPU run: max |diff| {worst}")
    print(f"small reference (softmax 24x4, 4 rounds): card vs CPU max |diff| "
          f"{worst:.3e}")


def check_pytree_small_reference(torch, neural, FedZOConfig):
    """Phase 4: the golden softmax_counter configuration (the pytree route
    with the counter convention; 6 clients, 24x4 softmax), 8 rounds on the
    card and on the CPU. Same limit as the flat run's, for the same
    reason (a loss ulp moves a coefficient by d.ulp/mu ~ 0.012); port vs
    JAX on the CPU reads 1.2e-4 for this config."""
    kw = dict(n_train=320, n_test=96, n_clients=6, n_features=24,
              n_classes=4, alpha=0.5)
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=8,
                      b2=4, lr=5e-2, mu=1e-3, direction_conv="counter",
                      weight_by_size=True, seed=11)
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("softmax", device=dev, **kw)
        res = neural.run(task, cfg, 8, eval_rows=96)
        out[dev] = {k: v.cpu() for k, v in res.params.items()}
    worst = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
                for k in out["cpu"])
    check(worst <= 2e-3, f"pytree card vs CPU run: max |diff| {worst}")
    print(f"small reference (softmax_counter, pytree, 8 rounds): card vs CPU "
          f"max |diff| {worst:.3e}")


# the transformer track at the reference's test size (tests/test_neural.py):
# 24 features in 4 patch tokens, d_model 16 over 2 heads of 8, d = 2,320
TRACK_SMALL = dict(n_train=180, n_test=48, n_clients=6, n_features=24,
                   n_classes=4, n_patches=4, d_model=16, d_ff=32, n_heads=2)


def check_track_small_reference(torch, ops, neural, FedZOConfig, route):
    """Phase 4: 2 rounds of the transformer track at its test size (the
    head dim 8 kernel) on the card and on the CPU, on the flat, pytree or
    wide (``block``) route, or on the pytree route with bfloat16 sphere or
    gaussian directions (float32 weights, bfloat16 directions into
    zo_axpy). The card run's launch counts are exact. A loss ulp moves a
    coefficient by d.ulp/mu ~ 0.28 here and a weight by lr/b2 of that along
    a unit direction, so the two runs drift like port and JAX on the CPU
    (2e-4 to 6e-4 there, tests/test_torch_transformer_track.py and
    tests/test_torch_wide.py): within the ZO trajectory tolerance 1e-3."""
    from repro_torch.utils.tree import tree_leaves
    over = {"flat": dict(flat_params=True, flat_block_rows=4),
            "pytree": {},
            "pytree bf16 sphere": dict(direction_dtype="bfloat16"),
            "pytree bf16 gaussian": dict(direction_dtype="bfloat16",
                                         estimator="gaussian"),
            "wide": dict(batch_directions=True, direction_conv="block")}
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=6,
                      b2=3, lr=2e-2, mu=1e-3, seed=7, **over[route])
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("transformer", device=dev, **TRACK_SMALL)
        ops.reset_launches()
        res = neural.run(task, cfg, 2, eval_every=0)
        if dev == "cuda":
            want = round_launches(ops, cfg, 2, CLS_LEAVES, CLS_LAYERS)
            check(dict(ops.LAUNCHES) == want, f"transformer {route}: "
                  f"launches {dict(ops.LAUNCHES)} != {want}")
        out[dev] = [t.cpu() for t in tree_leaves(res.params)]
    worst = max(float((a - b).abs().max()) for a, b in zip(*out.values()))
    check(worst <= 1e-3, f"transformer {route} card vs CPU: max |diff| "
          f"{worst}")
    print(f"small reference (transformer track at its test size, {route}, "
          f"2 rounds): card vs CPU max |diff| {worst:.3e}")


def check_bf16_draws(torch):
    """Phase 4: bfloat16 normals (the tree convention's draws) made on the
    card bitwise the CPU's, over ragged shapes: a bf16 draw is one of 128
    values, and its float32 erfinv rounds to bf16."""
    from repro_torch.utils import prng
    n = 0
    for seed, shape in ((0, (7,)), (1, (1000, 37)), (2, (3, 4097)),
                        (3, (784, 32))):
        k = prng.key(seed)
        got = prng.normal(k, shape, dtype=torch.bfloat16, device="cuda")
        want = prng.normal(k, shape, dtype=torch.bfloat16)
        check(torch.equal(got.cpu(), want), f"bf16 normal {shape} differs "
              f"between the card and the CPU")
        n += got.numel()
    print(f"bf16 normals: card bitwise the CPU over {n:,} draws")


def check_lm_small_reference(torch, FedZOConfig, flat_params=True):
    """Phase 4: 3 train steps of qwen2-0.5b-smoke on the card and on the
    CPU (plain versions) from the same init, on the flat or the pytree
    route."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    model, toks = lm_setup("qwen2-0.5b-smoke", "float32")
    fcfg = FedZOConfig(lr=1e-3, mu=1e-2, b2=4, flat_params=flat_params)
    step = fedzo.make_train_step(model.loss, fcfg)
    init = model.init(prng.key(0), device="cpu")
    spec = flat_spec(init)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = unflatten(flatten(init, spec).to(dev), spec)
        rng, key, mets = np.random.default_rng(0), prng.key(1), []
        for _ in range(3):
            batch = lm_batch(torch, toks, rng, 2, 16, dev)
            ks = prng.split(key, 2)
            key, sub = ks[0], ks[1]
            params, m = step(params, batch, sub)
            mets.append((float(m["loss"]), float(m["coeff_norm"])))
        runs[dev] = (flatten(params, spec).cpu(), mets)
    # each coefficient is d.(L+ - L)/mu with d = 361,600: one float32 ulp of
    # the loss (4.8e-7 at 6.3; the card sums the matmuls in another order)
    # moves it by 17, and a step moves each weight by lr/b2 of the
    # coefficient-weighted unit directions (|v_i| <= ~8e-3): ~1e-4 per ulp
    # per step, so 1e-3 over 3 steps; port vs JAX on the CPU reads 2.1e-4
    # (flat route) and 3.2e-4 (pytree route)
    route = "flat" if flat_params else "pytree"
    worst = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(worst <= 1e-3, f"qwen2-0.5b-smoke {route} card vs CPU: max |diff| "
          f"{worst}")
    print(f"small reference (qwen2-0.5b-smoke, {route}, 3 train steps): card "
          f"vs CPU max |param diff| {worst:.3e}; (loss, coeff_norm) card "
          f"{runs['cuda'][1]} cpu {runs['cpu'][1]}")


def check_lm_round_small_reference(torch, FedZOConfig):
    """Phase 4: one flat round of qwen2-0.5b-smoke (M = 3 clients, H = 2,
    b2 = 4, mu = 1e-2, lr = 1e-3) on the card (the client-batched forward
    with the kernels) and on the CPU (plain versions), from the same
    weights, batches and keys."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten

    model, toks = lm_setup("qwen2-0.5b-smoke", "float32")
    m, h = 3, 2
    cfg = FedZOConfig(n_participating=m, local_iters=h, lr=1e-3, mu=1e-2,
                      b2=4, flat_params=True)
    init = model.init(prng.key(0), device="cpu")
    spec = flat_spec(init)
    rng = np.random.default_rng(0)
    per = [lm_batch(torch, toks, rng, 2, 16, "cpu") for _ in range(m * h)]
    batches = {k: torch.stack([b[k] for b in per]).reshape((m, h, 2, 16))
               for k in ("tokens", "labels")}
    runs = {}
    for dev in ("cuda", "cpu"):
        params = unflatten(flatten(init, spec).to(dev), spec)
        new, met = fedzo.round_simulated(
            model.loss, params, {k: v.to(dev) for k, v in batches.items()},
            prng.split(prng.key(1), m), cfg)
        runs[dev] = (flatten(new, spec).cpu(),
                     float(met["mean_local_loss"]))
    # check_lm_small_reference's argument: a loss ulp moves a coefficient
    # by d.ulp/mu ~ 17 and a weight by ~1e-4 per iterate, so a client's
    # H = 2 iterates at a few ulps each stay within 1e-3; the mean over the
    # clients does not add to it (port vs JAX on the CPU reads 1.1e-4)
    worst = float((runs["cuda"][0] - runs["cpu"][0]).abs().max())
    check(worst <= 1e-3, f"qwen2-0.5b-smoke flat round card vs CPU: max "
          f"|diff| {worst}")
    print(f"small reference (qwen2-0.5b-smoke, flat round, M {m}, H {h}): "
          f"card vs CPU max |param diff| {worst:.3e}; mean local loss card "
          f"{runs['cuda'][1]} cpu {runs['cpu'][1]}")


# ---------------------------------------------------------------------------
# phase "algorithms and uplinks": the strategies, FedAvg, the seed-compressed
# uplink and FedServer


def fedavg_launches(ops, cfg, rounds, L=0):
    """Launches of ``rounds`` FedAvg rounds: no ZO kernel; per local step
    one batched forward of the cohort (2L + 1 RMSNorms, L attentions,
    whatever M is); the backward recomputes the plain versions and
    launches nothing."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if L:
        steps = rounds * cfg.local_iters
        want.update(rmsnorm=steps * (2 * L + 1), flash_attention=steps * L)
    return want


def run_strategy_rounds(torch, ops, neural, FedZOConfig):
    """Parts (a) and (b) at the other rounds' settings (N = 50, M = 10,
    H = 5, b1 = 25, b2 = 20, size-weighted). Softmax 784x10, 3 rounds each:
    fedprox (prox_mu 0.01), feddyn (dyn_alpha 0.01) and scaffold on the
    flat route, scaffold on the wide route, fedprox with AirComp, and
    fedavg at a first-order lr of 0.05 (FedZOConfig's 1e-3 is a ZO step).
    The transformer track at its lr 5e-3: fedprox on the flat route and
    fedavg, one round each. The hooks add no ZO kernel launch: each
    strategy's counts are the fedzo round's on its route, M-free; fedavg
    launches no ZO kernel, and on the track one batched forward a step.
    Then one client's FedAvg gradient of the track on the card against the
    CPU's. Returns {kernel: launches}."""
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    track = neural.make_task("transformer", n_clients=50)
    base = dict(weight_by_size=True)
    flat = dict(flat_params=True)
    wide = dict(batch_directions=True, direction_conv="block")
    air = dict(aircomp=True, channel_schedule=True, snr_db=5.0)
    prox = dict(strategy="fedprox", prox_mu=0.01)

    def on_track(**kw):
        return neural.default_config(track, n_participating=10, **kw)

    runs = [("softmax_fedprox", softmax, FedZOConfig(**base, **flat, **prox),
             3, "local"),
            ("softmax_feddyn", softmax, FedZOConfig(
                **base, **flat, strategy="feddyn", dyn_alpha=0.01), 3,
             "local"),
            ("softmax_scaffold", softmax, FedZOConfig(
                **base, **flat, strategy="scaffold"), 3, "local"),
            ("softmax_scaffold_wide", softmax, FedZOConfig(
                **base, **wide, strategy="scaffold"), 3, "local"),
            ("softmax_fedprox_aircomp", softmax, FedZOConfig(
                **base, **flat, **air, **prox), 3, "local"),
            ("softmax_fedavg", softmax, FedZOConfig(
                **base, strategy="fedavg", lr=0.05), 3, "mean"),
            ("transformer_fedprox", track, on_track(**flat, **prox), 1,
             None),
            ("transformer_fedavg", track, on_track(strategy="fedavg"), 1,
             None)]

    def want(task, cfg, rounds):
        L = CLS_LAYERS if task is track else 0
        if cfg.strategy == "fedavg":
            return fedavg_launches(ops, cfg, rounds, L)
        return round_launches(ops, cfg, rounds,
                              CLS_LEAVES if task is track else 2, L)

    total = drive_runs(torch, ops, neural, [
        (name, task, cfg, rounds, want(task, cfg, rounds), descend)
        for name, task, cfg, rounds, descend in runs])
    check_fedavg_gradient(torch, ops, neural, track)
    return total


# A FedAvg gradient on the card against the CPU's: the forward kernels
# agree with the plain versions within a relative 1e-5 (attention, float32)
# or bitwise (RMSNorm's order twin), the GEMMs sum in other orders, and the
# backward is the plain version's on both: every leaf within a relative
# 1e-4 of its largest entry. A gradient that skipped the kernels' inputs
# (a launch output with no grad_fn) would leave the attention and norm
# weights at zero, which no tolerance passes.
GRAD_REL = 1e-4


def check_fedavg_gradient(torch, ops, neural, track):
    """One client's FedAvg gradient (``fedavg.value_and_grad`` of the
    track's loss on its first 25 rows) on the card and on the CPU from the
    same weights; the card's forward launches its kernels once."""
    from repro_torch.core import fedavg
    from repro_torch.utils.flatparams import _leaves
    from repro_torch.utils.tree import tree_map
    params = neural.params_init(track, 0)
    batch = {k: v[0, :25] for k, v in track.store.data.items()}
    ops.reset_launches()
    loss, grad = fedavg.value_and_grad(track.loss, params, batch)
    check(ops.LAUNCHES["rmsnorm"] == 2 * CLS_LAYERS + 1
          and ops.LAUNCHES["flash_attention"] == CLS_LAYERS,
          f"track gradient: launches {dict(ops.LAUNCHES)}")
    loss_c, grad_c = fedavg.value_and_grad(
        track.loss, tree_map(lambda v: v.cpu(), params),
        {k: v.cpu() for k, v in batch.items()})
    want = dict(_leaves(grad_c))
    worst = 0.0
    for path, g in _leaves(grad):
        big = float(want[path].abs().max())
        check(big > 0, f"track gradient {path}: zero on the CPU")
        rel = float((g.cpu() - want[path]).abs().max()) / big
        check(rel <= GRAD_REL, f"track gradient {path}: card vs CPU "
              f"relative {rel} > {GRAD_REL}")
        worst = max(worst, rel)
    check(abs(float(loss) - float(loss_c)) <= 1e-5 * abs(float(loss_c)),
          f"track loss card {float(loss)} cpu {float(loss_c)}")
    print(f"transformer_fedavg gradient: {len(want)} leaves, card vs CPU "
          f"largest relative difference {worst:.3e} (limit {GRAD_REL}); "
          f"loss {float(loss)} vs {float(loss_c)}")


def backward_inputs(torch, kind, shape, dtype, gen):
    """Random inputs and a cotangent on the card for a backward check:
    ``rmsnorm`` shape (x shape, groups), ``attention`` shape (B, S, Hq,
    Hkv, D, window)."""
    def rnd(*s):
        return torch.randn(s, generator=gen, device="cuda").to(dtype)
    if kind == "rmsnorm":
        xs, groups = shape
        d = xs[-1]
        ins = [rnd(*xs), 1 + 0.1 * rnd(*((d,) if groups == 1
                                         else (groups, d)))]
        return ins, rnd(*xs), {}
    b, s, hq, hkv, d, window = shape
    ins = [rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d)]
    return ins, rnd(b, s, hq, d), {"window": window}


def check_backward(torch, ops, kind, shape, dtype, gen, time_reps=0):
    """``ops.rmsnorm``/``ops.attention`` with inputs that require a
    gradient on the card: the forward is the kernel (one launch, bitwise
    the direct call's output) and the gradients are bitwise autograd of
    the plain version on the same card tensors, and not all zero. With
    ``time_reps``, the backward's device time (ms, the recompute and
    ``autograd.grad``). Returns (max |grad|, ms or None)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    fwd = ops.rmsnorm if kind == "rmsnorm" else ops.attention
    plain = rmsnorm_plain if kind == "rmsnorm" else flash_attention_plain
    ins, g, kw = backward_inputs(torch, kind, shape, dtype, gen)
    name = "rmsnorm" if kind == "rmsnorm" else "flash_attention"
    leaves = [t.clone().requires_grad_() for t in ins]
    before = ops.LAUNCHES[name]
    out = fwd(*leaves, **kw)
    check(ops.LAUNCHES[name] == before + 1 and out.grad_fn is not None,
          f"{kind} {shape}: the forward did not launch through autograd")
    check(torch.equal(out, fwd(*ins, **kw)),
          f"{kind} {shape}: forward differs from the kernel's")
    got = torch.autograd.grad(out, leaves, g, retain_graph=True)
    ref = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(plain(*ref, **kw), ref, g)
    for a, b in zip(got, want):
        check(a.shape == b.shape and torch.equal(a, b),
              f"{kind} {shape} {dtype}: gradient differs from the plain "
              f"version's autograd")
    big = max(float(a.abs().max()) for a in got)
    check(big > 0, f"{kind} {shape}: zero gradient")
    ms = (median_ms(torch, lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True), time_reps)
        if time_reps else None)
    return big, ms


# backward checks: Qwen2-0.5B's shapes at batch 1 x seq 16 (d_model 896,
# 14 q heads over 2 kv heads of 64), the transformer track's ([250, 8]
# rows of d_model 32 in 10 client groups, 2 heads of 16 or 8), the [G, D]
# scale, and every head dim the attention builds (8 in float32 only)
BACKWARD_CASES = (
    [("rmsnorm", ((1, 16, LM_DM), 1), dt) for dt in ("float32", "bfloat16")]
    + [("attention", (1, 16, LM_HQ, LM_HKV, LM_HD, 0), dt)
       for dt in ("float32", "bfloat16")]
    + [("rmsnorm", ((4, 2, 3, 64), 4), "float32"),
       ("rmsnorm", ((10, 25, 8, 32), 10), "bfloat16"),
       ("attention", (250, 8, 2, 2, 8, 0), "float32"),
       ("attention", (250, 8, 2, 2, 16, 0), "float32")]
    + [("attention", (2, 70, 4, 2, d, w), dt) for d in (16, 32, 128, 256)
       for dt in ("float32", "bfloat16") for w in (0, 24)])
# the backward timed at the shapes a step runs: the Qwen2-0.5B FedAvg step
# (batch 4 x seq 128) and the track's FedAvg round (M.b1 = 250 rows)
BACKWARD_TIMED = (
    ("qwen rmsnorm", "rmsnorm", ((LM_B, LM_S, LM_DM), 1)),
    ("qwen attention", "attention", (LM_B, LM_S, LM_HQ, LM_HKV, LM_HD, 0)),
    ("track rmsnorm", "rmsnorm", ((10, 25, 8, 32), 10)),
    ("track attention", "attention", (250, 8, 2, 2, 16, 0)))


def check_backwards(torch, ops):
    """Part (c)'s backward check over ``BACKWARD_CASES``, then the
    backward's device time at ``BACKWARD_TIMED`` (float32). Returns {name:
    ms}."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    for kind, shape, dt in BACKWARD_CASES:
        check_backward(torch, ops, kind, shape, getattr(torch, dt), gen)
    times = {}
    for name, kind, shape in BACKWARD_TIMED:
        _, times[name] = check_backward(torch, ops, kind, shape,
                                        torch.float32, gen, time_reps=20)
    print(f"backward (plain recompute + autograd.grad): "
          f"{len(BACKWARD_CASES)} cases bitwise the plain version's "
          f"autograd on the card; device ms {json.dumps(times)}")
    return times


def run_qwen_fedavg_cli(torch, ops, bwd_ms, steps=3):
    """Part (c): ``repro_torch.launch.train --algo fedavg --opt adam`` on
    Qwen2-0.5B at full width in float32, batch 4 x seq 128, 3 steps: per
    step one forward (2L + 1 RMSNorms and L attentions through the
    kernels), the backward through the plain versions (no launch), one
    Adam step. Prints ms per step, peak memory, the losses, and the
    backward recompute's share of a step estimated from ``bwd_ms`` (its
    device time at the step's shapes, times the calls a step makes).
    Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.utils.tree import tree_leaves

    L = get_config("qwen2-0.5b").n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(rmsnorm=2 * L + 1, flash_attention=L)
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train.main(["--arch", "qwen2-0.5b", "--override", "dtype=float32",
                      "--algo", "fedavg", "--opt", "adam", "--steps",
                      str(steps), "--batch", str(LM_B), "--seq", str(LM_S),
                      "--log-every", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    prev = dict.fromkeys(ops.LAUNCHES, 0)
    for i, cum in enumerate(res.launches):
        per = {k: cum[k] - prev[k] for k in cum}
        check(per == want, f"fedavg CLI step {i}: launches {per} != {want}")
        prev = cum
    check(all(map(math.isfinite, res.history)),
          f"fedavg CLI: loss {res.history}")
    leaves = tree_leaves(res.params)
    check(all(bool(torch.isfinite(t).all()) and not t.requires_grad
              for t in leaves), "fedavg CLI: parameters not finite or "
          "still requiring a gradient")
    steady = sorted(res.step_ms[1:]) or res.step_ms
    med = steady[len(steady) // 2]
    recompute = L * bwd_ms["qwen attention"] \
        + (2 * L + 1) * bwd_ms["qwen rmsnorm"]
    print(f"qwen2_0_5b_fedavg_adam_cli: ms/step "
          f"{[round(t, 1) for t in res.step_ms]} (median after step 1 "
          f"{med:.1f}); whole CLI {wall:.1f} s; peak memory "
          f"{peak / 2**30:.2f} GiB; loss {res.history}; launches per step "
          f"{want}; backward recompute of RMSNorm and attention "
          f"{recompute:.2f} ms of device time a step "
          f"({recompute / med:.3f} of the step)")
    return dict(res.launches[-1])


def qwen_round_inputs(torch):
    """Qwen2-0.5B in float32 from seed 0, the flat round's M x H batches of
    4 x 128 tokens (as phase "qwen flat round") and the M client keys."""
    import numpy as np
    from repro_torch.utils import prng
    model, toks = lm_setup("qwen2-0.5b", "float32")
    params = model.init(prng.key(0), device="cuda")
    rng = np.random.default_rng(1)
    per = [lm_batch(torch, toks, rng, LM_B, LM_S, "cuda")
           for _ in range(QWEN_M * QWEN_H)]
    batches = {k: torch.stack([b[k] for b in per]).reshape(
        (QWEN_M, QWEN_H, LM_B, LM_S)) for k in ("tokens", "labels")}
    return model, params, batches


def seed_ulps(torch, got, want):
    """Largest |got - want| of each leaf in ulps of that leaf's largest
    |weight|: the worst over the leaves."""
    from repro_torch.utils.flatparams import _leaves
    worst = 0.0
    w = dict(_leaves(want))
    for path, g in _leaves(got):
        big = w[path].abs().max()
        ulp = float(torch.nextafter(big, big + 1) - big)
        worst = max(worst, float((g - w[path]).abs().max()) / ulp)
    return worst


def run_qwen_seed_round(torch, ops, FedZOConfig):
    """Part (d): ``run_seed_compressed_round`` on Qwen2-0.5B, flat route, M
    = 4, H = 2, b2 = 8, against a dense ``fedzo.round_simulated`` on the
    same batches and keys. Both run the same cohort phase (the same
    coefficients and updates); the dense round rounds each weight once per
    iterate, the replay sums a client's updates first, and both round the
    mean and the final add once: each weight within H + 2 ulps of its
    leaf's largest weight (2.x ulps by that count; the CPU test reads 3 at
    softmax size). The seed round's launches are the dense round's plus
    the aggregate's: exactly 1 zo_dirnorms and M.H zo_replay. Wire bytes
    M.(8 + 4.H.b2 + 4). Returns the launches of both rounds."""
    from repro_torch.core import fedzo
    from repro_torch.fed.server import run_seed_compressed_round
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_bytes

    model, params, batches = qwen_round_inputs(torch)
    L, m, h = model.cfg.n_layers, QWEN_M, QWEN_H
    keys = prng.split(prng.key(1), m)
    cfg = FedZOConfig(n_participating=m, local_iters=h, lr=1e-4, mu=1e-3,
                      b2=QWEN_B2, estimator="sphere", flat_params=True)
    counts, ms, out = {}, {}, {}
    for name in ("dense", "seed"):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "dense":
            out[name], _ = fedzo.round_simulated(model.loss, params, batches,
                                                 keys, cfg)
        else:
            out[name], wire, dense_bytes = run_seed_compressed_round(
                model.loss, params, batches, keys, cfg)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        counts[name] = dict(ops.LAUNCHES)
        print(f"qwen seed round, {name}: ms {ms[name]:.1f}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"launches {counts[name]}")
        torch.cuda.empty_cache()
    want = round_launches(ops, cfg, 1, L=L)
    check(counts["dense"] == want, f"qwen dense round: launches "
          f"{counts['dense']} != {want}")
    agg = {k: counts["seed"][k] - counts["dense"][k] for k in want}
    want_agg = dict.fromkeys(ops.LAUNCHES, 0)
    want_agg.update(zo_dirnorms=1, zo_replay=m * h)
    check(agg == want_agg, f"qwen seed aggregate: launches {agg} != "
          f"{want_agg}")
    msg_bytes = 8 + 4 * h * cfg.b2 + 4
    check(wire == m * msg_bytes, f"wire bytes {wire} != {m * msg_bytes}")
    check(dense_bytes == m * tree_bytes(params), "dense bytes")
    ulps = seed_ulps(torch, out["seed"], out["dense"])
    check(ulps <= h + 2, f"qwen seed replay vs dense round: {ulps} ulps "
          f"> {h + 2}")
    print(f"qwen seed round: wire {wire} bytes for M = {m} "
          f"({msg_bytes} a client), dense {dense_bytes} bytes: compression "
          f"{dense_bytes / wire:.4e}x; replay vs dense round {ulps:.2f} "
          f"ulps of each leaf's largest weight (limit {h + 2}); aggregate "
          f"launches {agg}")
    return {k: counts["dense"][k] + counts["seed"][k] for k in want}


def run_qwen_fedprox_round(torch, ops, FedZOConfig):
    """Part (e): one ZO-FedProx flat round on Qwen2-0.5B (prox_mu 0.01; M =
    4, H = 2, b2 = 8, the flat round's batches) through the strategy's
    ``run_round``: ms, peak memory, and launches equal to the fedzo
    round's (the proximal term is tree ops over the cohort's rows).
    Returns the launches."""
    from repro_torch.core import strategy
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves

    model, params, batches = qwen_round_inputs(torch)
    cfg = FedZOConfig(n_participating=QWEN_M, local_iters=QWEN_H, lr=1e-4,
                      mu=1e-3, b2=QWEN_B2, estimator="sphere",
                      flat_params=True, strategy="fedprox", prox_mu=0.01)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, met, _, _ = strategy.get("fedprox").run_round(
        model.loss, params, batches, prng.key(1), cfg)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = dict(ops.LAUNCHES)
    want = round_launches(ops, cfg, 1, L=model.cfg.n_layers)
    check(counts == want, f"qwen fedprox round: launches {counts} != "
          f"{want}")
    mets = {k: float(v) for k, v in met.items()}
    check(all(map(math.isfinite, mets.values())), f"qwen fedprox {mets}")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
          "qwen fedprox round: parameters not finite")
    print(f"qwen fedprox round: M {QWEN_M}, H {QWEN_H}, b2 {QWEN_B2}: "
          f"ms/round {ms:.1f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; metrics "
          f"{json.dumps(mets)}; launches {counts} (the fedzo round's)")
    return counts


LEDGER_COLUMNS = ("wire_bytes", "dense_bytes", "downlink_bytes",
                  "wire_bytes_total", "downlink_bytes_total",
                  "compression_ratio")


def run_fedserver(torch, ops, neural, FedZOConfig):
    """Part (f): ``FedServer`` on the card, softmax 784x10 on 50 clients,
    flat route, 2 rounds: the host loop with fedzo and fedavg (numpy
    sampling, batches moved to the card), the store path with all five
    strategies (``run``: the engine's round loop). Exact launch counts,
    finite rows numbered 0 and 1 with the ledger's columns. Returns the
    launches."""
    from repro_torch.fed.server import FedServer
    softmax = neural.make_task("softmax", n_features=784, n_classes=10,
                               n_clients=50)
    total = dict.fromkeys(ops.LAUNCHES, 0)
    runs = [("host", "fedzo"), ("host", "fedavg")] + [
        ("store", s) for s in ("fedzo", "fedavg", "fedprox", "feddyn",
                               "scaffold")]
    for driver, name in runs:
        kw = dict(flat_params=True, weight_by_size=True, prox_mu=0.01,
                  dyn_alpha=0.01, lr=0.05 if name == "fedavg" else 1e-3)
        cfg = FedZOConfig(**kw)
        srv = FedServer(softmax.loss, neural.params_init(softmax, 0),
                        softmax.clients, cfg, strategy=name,
                        store=softmax.store if driver == "store" else None)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = srv.run(2)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 2
        counts = dict(ops.LAUNCHES)
        want = (fedavg_launches(ops, cfg, 2) if name == "fedavg"
                else round_launches(ops, cfg, 2, 2))
        check(counts == want, f"FedServer {driver} {name}: launches "
              f"{counts} != {want}")
        check([r["round"] for r in hist] == [0, 1],
              f"FedServer {driver} {name}: rows {hist}")
        for r in hist:
            check(all(c in r for c in LEDGER_COLUMNS),
                  f"FedServer {driver} {name}: ledger columns missing {r}")
            check(all(math.isfinite(v) for v in r.values()
                      if isinstance(v, float)),
                  f"FedServer {driver} {name}: row not finite {r}")
        print(f"FedServer {driver} {name}: {ms:.1f} ms/round; losses "
              f"{[round(r['mean_local_loss'], 5) for r in hist]}; wire "
              f"{hist[-1]['wire_bytes']} bytes/round; launches {counts}")
        for k in total:
            total[k] += counts[k]
    return total


def check_strategy_small_reference(torch, ops, neural, FedZOConfig, name):
    """Phase "algorithms and uplinks": one round of the transformer track
    at its test size (head dim 8) on the card and on the CPU, under
    fedprox (flat route), scaffold (wide route) or fedavg; exact launch
    counts on the card. ZO rounds within the trajectory tolerance 1e-3
    (``check_track_small_reference``); FedAvg within 1e-5: its gradients
    agree to float32 reordering (the card's forward kernels within 1e-5
    relative of the plain versions) and lr.H = 0.04 scales them down."""
    from repro_torch.utils.tree import tree_leaves
    over = {"fedprox": dict(flat_params=True, flat_block_rows=4,
                            strategy="fedprox", prox_mu=0.1),
            "scaffold": dict(batch_directions=True, direction_conv="block",
                             strategy="scaffold"),
            "fedavg": dict(strategy="fedavg")}
    cfg = FedZOConfig(n_devices=6, n_participating=3, local_iters=2, b1=6,
                      b2=3, lr=2e-2, mu=1e-3, seed=7, **over[name])
    out = {}
    for dev in ("cuda", "cpu"):
        task = neural.make_task("transformer", device=dev, **TRACK_SMALL)
        ops.reset_launches()
        res = neural.run(task, cfg, 1, eval_every=0)
        if dev == "cuda":
            want = (fedavg_launches(ops, cfg, 1, CLS_LAYERS)
                    if name == "fedavg" else
                    round_launches(ops, cfg, 1, CLS_LEAVES, CLS_LAYERS))
            check(dict(ops.LAUNCHES) == want, f"transformer {name}: "
                  f"launches {dict(ops.LAUNCHES)} != {want}")
        out[dev] = [t.cpu() for t in tree_leaves(res.params)]
    worst = max(float((a - b).abs().max()) for a, b in zip(*out.values()))
    limit = 1e-5 if name == "fedavg" else 1e-3
    check(worst <= limit, f"transformer {name} card vs CPU: max |diff| "
          f"{worst} > {limit}")
    print(f"small reference (transformer track at its test size, {name}, "
          f"1 round): card vs CPU max |diff| {worst:.3e} (limit {limit})")


def run_algorithms(torch, ops, neural, FedZOConfig):
    """Phase "algorithms and uplinks", parts (a)-(f) and the card-against-
    CPU references. Prints each part's seconds and peak memory; returns
    {kernel: launches} of its counted runs."""
    total = dict.fromkeys(ops.LAUNCHES, 0)
    bwd = {}

    def part(name, fn):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got = fn()
        print(f"part {name}: {time.perf_counter() - t:.1f} s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
        return got

    for name, fn in (
            ("strategy rounds", lambda: run_strategy_rounds(
                torch, ops, neural, FedZOConfig)),
            ("backward checks", lambda: bwd.update(check_backwards(
                torch, ops)) or {}),
            ("qwen fedavg cli", lambda: run_qwen_fedavg_cli(torch, ops,
                                                            bwd)),
            ("qwen seed round", lambda: run_qwen_seed_round(
                torch, ops, FedZOConfig)),
            ("qwen fedprox round", lambda: run_qwen_fedprox_round(
                torch, ops, FedZOConfig)),
            ("fedserver", lambda: run_fedserver(torch, ops, neural,
                                                FedZOConfig))):
        for k, n in part(name, fn).items():
            total[k] += n
    part("references", lambda: [check_strategy_small_reference(
        torch, ops, neural, FedZOConfig, s)
        for s in ("fedprox", "scaffold", "fedavg")])
    return total


# Phase "faults, channel and durability": the fault processes, the
# wireless chain and the durable segment runner on the card. The neural
# run is softmax 784x10 at phase 3's N = 50, M = 10, H = 5 with AirComp,
# under these processes (FAULT_KW: dropout, stragglers, NaN uploads).
FAULT_KW = dict(p_fail=0.1, p_recover=0.5, deadline=2.0, p_corrupt=0.1)
CHANNEL_KW = dict(rho=0.9, battery=20.0, tx_cost=1.0)
FAULT_ROUNDS = 6
# the CPU reference of part (b)'s run: its first rounds (the CPU run costs
# about 15 s a round)
FAULT_REF_ROUNDS = 3


def _leaves_equal(torch, a, b):
    """Whether two parameter trees are bitwise equal (b may be on the
    CPU)."""
    from repro_torch.utils.tree import tree_leaves
    return all(torch.equal(x.cpu(), y.cpu())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def run_faulted_qwen_round(torch, ops, FedZOConfig):
    """Part (a): the flat AirComp round on Qwen2-0.5B (M = 4, H = 2, b2 =
    8, 5 dB; ``qwen_round_inputs``) under a ``RoundChannel`` from
    ``ChannelModel(rho=0.9, battery=3.0, tx_cost=1.0).step`` over the 4
    clients (its key chosen so that the chain masks client 3 and client 2
    transmits) and a ``RoundFaults`` that poisons client 2 with NaN (guard
    on). Five rounds: the plain AirComp round (the i.i.d. channel draw, no
    faults; a warm-up), the round with client 2 masked, the poisoned
    round, the poisoned round with the guard off, and the plain round
    again, which the poisoned round's time is set beside. Checks: the
    poisoned round's weights bitwise the masked round's; ``m_effective``
    the chain's transmitting clients other than client 2 and
    ``m_corrupt`` 1; the guard off leaves non-finite weights; every
    round's launches exactly the plain round's; the poisoned round's peak
    memory at most one [n_pad] float32 row above the plain round's.
    Returns the launches."""
    from repro_torch.core import fedzo
    from repro_torch.sim import ChannelModel, FaultModel, RoundFaults
    from repro_torch.sim.channel import init_key
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves

    model, params, batches = qwen_round_inputs(torch)
    m = QWEN_M
    keys = prng.split(prng.key(1), m)
    cfg = FedZOConfig(n_participating=m, local_iters=QWEN_H, lr=1e-4,
                      mu=1e-3, b2=QWEN_B2, estimator="sphere",
                      flat_params=True, aircomp=True, channel_schedule=True,
                      snr_db=5.0)
    cm = ChannelModel(rho=0.9, battery=3.0, tx_cost=1.0)
    _, chan = cm.step(prng.key(8), cm.init_state(m, init_key(prng.key(0))),
                      torch.arange(m), h_min=cfg.h_min,
                      schedule=cfg.channel_schedule)
    check(chan.mask.tolist() == [True, True, True, False],
          f"qwen faulted round: channel mask {chan.mask.tolist()}")
    poison = torch.tensor([False, False, True, False])
    up, none = torch.ones(m, dtype=torch.bool), torch.zeros(
        m, dtype=torch.bool)
    runs = {"aircomp": {},
            "masked": dict(channel=chan, faults=RoundFaults(
                FaultModel(), ~poison, none)),
            "poisoned": dict(channel=chan, faults=RoundFaults(
                FaultModel(p_corrupt=0.5), up, poison)),
            "guard off": dict(channel=chan, faults=RoundFaults(
                FaultModel(p_corrupt=0.5, guard=False), up, poison)),
            "aircomp again": {}}
    want = round_launches(ops, cfg, 1, L=model.cfg.n_layers)
    total = dict.fromkeys(ops.LAUNCHES, 0)
    ms, peak, kept = {}, {}, None
    m_eff = float((chan.mask & ~poison).sum())
    for name, kw in runs.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = fedzo.round_simulated(model.loss, params, batches, keys,
                                         cfg, channel_rng=prng.key(2), **kw)
        torch.cuda.synchronize()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        peak[name] = torch.cuda.max_memory_allocated()
        counts = dict(ops.LAUNCHES)
        check(counts == want, f"qwen faulted round {name}: launches "
              f"{counts} != {want}")
        for k in total:
            total[k] += counts[k]
        mets = {k: float(v) for k, v in met.items()}
        finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(new))
        if name == "guard off":
            check(not finite, "qwen round with the guard off: the poison "
                  "did not reach the weights")
        else:
            check(finite, f"qwen faulted round {name}: weights not finite")
        if name == "masked":
            kept = [t.cpu() for t in tree_leaves(new)]
        if name == "poisoned":
            check(all(torch.equal(a.cpu(), b) for a, b in
                      zip(tree_leaves(new), kept)),
                  "qwen poisoned round: weights differ from the masked "
                  "round's")
        if name in ("masked", "poisoned"):
            check(mets["m_effective"] == m_eff and mets["m_corrupt"] == (
                1.0 if name == "poisoned" else 0.0),
                f"qwen faulted round {name}: m_effective "
                f"{mets['m_effective']} (want {m_eff}), m_corrupt "
                f"{mets['m_corrupt']}")
        print(f"qwen faulted round {name}: ms/round {ms[name]:.1f}; peak "
              f"memory {peak[name] / 2**30:.2f} GiB; metrics "
              f"{json.dumps(mets)}; launches {counts}")
        del new
    extra = peak["poisoned"] - peak["aircomp again"]
    check(extra <= 4 * QWEN_N_PAD, f"qwen poisoned round: peak "
          f"{extra / 2**30:.3f} GiB above the plain AirComp round's")
    plain = ms["aircomp again"]
    print(f"qwen faulted round: channel mask {chan.mask.tolist()}, poisoned "
          f"client 2; poisoned = masked bitwise; poisoned {ms['poisoned']:.1f}"
          f" ms against the plain AirComp round's {plain:.1f} "
          f"({ms['poisoned'] / plain - 1:+.2%}); peak {extra / 2**30:+.3f} "
          f"GiB (limit +{4 * QWEN_N_PAD / 2**30:.2f})")
    return total


def _same_run(torch, a, b):
    """Whether two engine results are bitwise equal: weights, metrics,
    evals, key, and the fault and channel states where the run has them."""
    pairs = [(a.key, b.key)]
    if a.fault_state is not None or b.fault_state is not None:
        pairs.append((a.fault_state, b.fault_state))
    if a.channel_state is not None or b.channel_state is not None:
        pairs += zip(a.channel_state, b.channel_state)
    pairs += [(a.metrics[k], b.metrics[k]) for k in a.metrics]
    pairs += [(a.evals[k], b.evals[k]) for k in a.evals]
    return (sorted(a.metrics) == sorted(b.metrics)
            and _leaves_equal(torch, a.params, b.params)
            and all(torch.equal(x.cpu(), y.cpu()) for x, y in pairs))


def faulted_softmax(neural, FedZOConfig, device):
    """The softmax task, config and fault model of part (b)."""
    from repro_torch.sim import ChannelModel, FaultModel
    task = neural.make_task("softmax", n_features=784, n_classes=10,
                            n_clients=50, device=device)
    cfg = FedZOConfig(flat_params=True, weight_by_size=True, aircomp=True,
                      channel_schedule=True, snr_db=5.0,
                      channel_model=ChannelModel(**CHANNEL_KW))
    return task, cfg, FaultModel(**FAULT_KW)


def run_neural_durability(torch, ops, neural, FedZOConfig, tmp):
    """Part (b): softmax 784x10 (N = 50, M = 10, H = 5, flat, AirComp,
    size-weighted) under ``FAULT_KW`` and ``ChannelModel(**CHANNEL_KW)``
    for 6 rounds with the eval every 2, taps into a ``JsonlSink`` every 2
    rounds: exact launches; the tap rows equal ``history()``'s; the same
    run in 2-round segments (``checkpoint_every=2``) and killed after 2
    segments then resumed are bitwise the single-shot run; the manifest
    is written and read back (its config hash the snapshot's). A
    divergence drill (lr 1e6 on an exploding loss) rolls back once and
    finishes, and with no lr backoff ends in ``DivergenceError``. One
    pytree round (H = 1) with client 3 poisoned is bitwise the round with
    it masked (``scrub_tree``, the ``zo_axpy`` leaves). Returns (the
    6-round result, the launches)."""
    from repro_torch import obs
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import fedzo
    from repro_torch.data.synthetic import make_classification, noniid_shards
    from repro_torch.sim import (DivergenceError, FaultModel, RoundFaults,
                                 build_store, run_experiment)
    from repro_torch.sim.channel import battery
    from repro_torch.sim.store import sample_batches, sample_participants
    from repro_torch.utils import prng

    total = dict.fromkeys(ops.LAUNCHES, 0)

    def add():
        for k in total:
            total[k] += ops.LAUNCHES[k]
        ops.reset_launches()

    task, cfg, faults = faulted_softmax(neural, FedZOConfig, "cuda")
    path = os.path.join(tmp, "taps.jsonl")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.JsonlSink(path) as sink:
        one = neural.run(task, cfg, FAULT_ROUNDS, faults=faults, sink=sink,
                         tap_every=2)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / FAULT_ROUNDS
    want = round_launches(ops, cfg, FAULT_ROUNDS)
    check(dict(ops.LAUNCHES) == want, f"faulted softmax: launches "
          f"{dict(ops.LAUNCHES)} != {want}")
    add()
    hist = one.history()
    rows = obs.read_jsonl(path)
    check([r["round"] for r in rows] == [0, 2, 4] and all(
        v == hist[r["round"]][k] for r in rows for k, v in r.items()),
        f"faulted softmax: tap rows {rows} differ from history")
    check(all(math.isfinite(v) for r in hist for v in r.values()
              if isinstance(v, float)), "faulted softmax: rows not finite")
    print(f"faulted softmax: {ms:.1f} ms/round (6 rounds with evals, taps "
          f"and the manifest); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"m_effective {[r['m_effective'] for r in hist]}; m_corrupt "
          f"{[r['m_corrupt'] for r in hist]}; energy "
          f"{[r['energy_spent'] for r in hist]}; batteries "
          f"{battery(one.channel_state).tolist()}; test_acc "
          f"{[round(r['test_acc'], 4) for r in hist if 'test_acc' in r]}")
    ck = os.path.join(tmp, "chunked")
    chunked = neural.run(task, cfg, FAULT_ROUNDS, faults=faults,
                         checkpoint_every=2, checkpoint_dir=ck)
    check(_same_run(torch, one, chunked), "faulted softmax: 2-round "
          "segments differ from the single-shot run")
    kill = os.path.join(tmp, "killed")
    part = neural.run(task, cfg, FAULT_ROUNDS, faults=faults,
                      checkpoint_every=2, checkpoint_dir=kill,
                      max_segments=2)
    check(part.rounds == 4, f"killed run stopped at {part.rounds}")
    resumed = neural.run(task, cfg, FAULT_ROUNDS, faults=faults,
                         checkpoint_every=2, checkpoint_dir=kill,
                         resume=True)
    check(_same_run(torch, one, resumed), "faulted softmax: the resumed "
          "run differs from the single-shot run")
    add()
    man = obs.read_manifest(ck)
    side = ckpt.read_sidecar(ckpt.latest_run_state(ck))
    check(man["config_hash"] == side["config_hash"]
          and man["rounds_done"] == FAULT_ROUNDS and "faults" in man
          and man["channel"]["energy_gated"]
          and obs.read_manifest(f"{path}.manifest.json")["tap_every"] == 2,
          f"manifest {man}")
    print(f"faulted softmax: chunked = killed-and-resumed = single-shot, "
          f"bitwise; manifest {man['config_hash']} on "
          f"{man['topology']['devices']}, snapshots "
          f"{sorted(os.listdir(ck))}")

    x, y = make_classification(320, 4, 2, seed=1)
    store = build_store(noniid_shards(x, y, 8), device="cuda")

    def explode(p, b):
        return torch.exp(torch.sum(torch.square(p["x"] - 0.1)))

    dcfg = FedZOConfig(n_devices=8, n_participating=4, local_iters=2,
                       lr=1e6, mu=1e-3, b1=8, b2=4, seed=3)
    res = run_experiment(explode, {"x": torch.zeros(4, device="cuda")},
                         store, dcfg, 4, checkpoint_every=2,
                         checkpoint_dir=os.path.join(tmp, "drill"),
                         lr_backoff=1e-8)
    check([e["event"] for e in res.events] == ["rollback"]
          and bool(torch.isfinite(res.params["x"]).all()),
          f"divergence drill: events {res.events}")
    try:
        run_experiment(explode, {"x": torch.zeros(4, device="cuda")}, store,
                       dcfg, 4, checkpoint_every=2,
                       checkpoint_dir=os.path.join(tmp, "drill2"),
                       max_retries=2, lr_backoff=1.0)
        check(False, "divergence drill: no DivergenceError")
    except DivergenceError as e:
        check(e.retries == 2 and e.round == 2, f"divergence drill: {e}")
        print(f"divergence drill: rollback events {res.events}; then "
              f"DivergenceError: {e}")
    add()

    pcfg = FedZOConfig(weight_by_size=True, local_iters=1)
    ks = prng.split(prng.key(5), 3)
    idx = sample_participants(ks[0], task.store.n_clients,
                              pcfg.n_participating)
    batches = sample_batches(task.store, idx, ks[1], 1, pcfg.b1)
    rngs = prng.split(ks[2], pcfg.n_participating)
    p0 = neural.params_init(task, 0)
    bad = torch.zeros(pcfg.n_participating, dtype=torch.bool)
    bad[3] = True
    out = {}
    for name, rf in (("poisoned", RoundFaults(FaultModel(p_corrupt=0.5),
                                              ~torch.zeros_like(bad), bad)),
                     ("masked", RoundFaults(FaultModel(), ~bad,
                                            torch.zeros_like(bad)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fedzo.round_simulated(task.loss, p0, batches, rngs,
                                          pcfg, faults=rf)
        torch.cuda.synchronize()
        want = round_launches(ops, pcfg, 1, 2)
        check(dict(ops.LAUNCHES) == want, f"pytree faulted round {name}: "
              f"launches {dict(ops.LAUNCHES)} != {want}")
        add()
        print(f"pytree softmax round (H = 1) {name}: "
              f"{1e3 * (time.perf_counter() - t0):.1f} ms; metrics "
              f"{ {k: float(v) for k, v in out[name][1].items()} }")
    check(_leaves_equal(torch, out["poisoned"][0], out["masked"][0]),
          "pytree poisoned round differs from the masked round")
    return one, total


def run_attack(torch, ops, tmp):
    """Part (c): the paper's Sec. V-A federated black-box attack at the
    reference task's width (32x32x3 images, d = 3,072; 10 clients with
    uneven shards, 512 attack images): ``attack.make_task`` on the card
    (300 SGD steps), then ``attack.run`` on the flat route (H = 20, b2 =
    20, full participation) for 5 rounds with the eval every 5 (exact
    launches), then ``attack.run_sweep`` over SNR {0, 10, 20} dB x seeds
    {0, 1}, 3 rounds each, into a CSV that must cover every scenario,
    round and metric. Returns the launches."""
    from repro_torch.workloads import attack

    total = dict.fromkeys(ops.LAUNCHES, 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    task = attack.make_task(device="cuda")
    torch.cuda.synchronize()
    print(f"attack task: classifier trained in "
          f"{time.perf_counter() - t0:.1f} s; clean accuracy "
          f"{task.clean_accuracy:.4f}; shards "
          f"{[len(c['y']) for c in task.clients]}")
    cfg = attack.default_config(task, flat_params=True)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = attack.run(task, cfg, 5, eval_every=5)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / 5
    want = round_launches(ops, cfg, 5)
    check(dict(ops.LAUNCHES) == want, f"attack: launches "
          f"{dict(ops.LAUNCHES)} != {want}")
    for k in total:
        total[k] += ops.LAUNCHES[k]
    hist = res.history()
    check(all(math.isfinite(v) for r in hist for v in r.values()
              if isinstance(v, float)), f"attack: rows not finite {hist}")
    print(f"attack (flat, H {cfg.local_iters}, b2 {cfg.b2}, M "
          f"{cfg.n_participating}): {ms:.1f} ms/round; losses "
          f"{[round(r['mean_local_loss'], 5) for r in hist]}; "
          f"attack_success {float(res.evals['attack_success'][0]):.4f}, "
          f"eval CW loss {float(res.evals['eval_cw_loss'][0]):.5f} after "
          f"round 0; launches {dict(ops.LAUNCHES)}")
    out = os.path.join(tmp, "attack_snr.csv")
    ops.reset_launches()
    t0 = time.perf_counter()
    recs = attack.run_sweep(task, cfg, snr_dbs=(0.0, 10.0, 20.0),
                            seeds=(0, 1), rounds=3, eval_every=1,
                            out_csv=out)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    for k in total:
        total[k] += ops.LAUNCHES[k]
    with open(out) as f:
        lines = f.read().splitlines()
    n_rows = sum(3 * (len(r["metrics"]) + len(r["evals"])) for r in recs)
    tags = {ln.split(",")[0] for ln in lines[1:]}
    check(len(recs) == 6 and lines[0] == "scenario,round,metric,value"
          and len(lines) == 1 + n_rows and len(tags) == 6,
          f"attack sweep CSV: {len(lines)} lines, {len(tags)} scenarios")
    noise = {s: sum(float(r["metrics"]["aircomp_noise_std"].mean())
                    for r in recs if r["scenario"]["snr_db"] == s) / 2
             for s in (0.0, 10.0, 20.0)}
    check(noise[0.0] > noise[10.0] > noise[20.0] > 0,
          f"attack sweep: AirComp noise by SNR {noise}")
    succ = {s: [round(float(r["evals"]["attack_success"][-1]), 4)
                for r in recs if r["scenario"]["snr_db"] == s]
            for s in (0.0, 10.0, 20.0)}
    print(f"attack sweep: 6 scenarios x 3 rounds in {sweep_s:.1f} s; "
          f"noise std by SNR {json.dumps(noise)}; attack_success after "
          f"round 2 by SNR (seeds 0, 1) {json.dumps(succ)}; {len(lines)} "
          f"CSV lines")
    return total


def run_faults_channel(torch, ops, neural, FedZOConfig):
    """Phase "faults, channel and durability", parts (a)-(c). Prints each
    part's seconds and peak memory; returns (the 6-round faulted softmax
    result, {kernel: launches})."""
    import tempfile
    total = dict.fromkeys(ops.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (
                ("qwen faulted round", lambda: run_faulted_qwen_round(
                    torch, ops, FedZOConfig)),
                ("neural durability", lambda: run_neural_durability(
                    torch, ops, neural, FedZOConfig, tmp)),
                ("attack", lambda: run_attack(torch, ops, tmp))):
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            got = fn()
            if isinstance(got, tuple):
                one, got = got
            print(f"part {name}: {time.perf_counter() - t:.1f} s, peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB")
            torch.cuda.empty_cache()
            for k in total:
                total[k] += got[k]
    return one, total


def check_faulted_reference(torch, neural, FedZOConfig):
    """References: the first FAULT_REF_ROUNDS rounds of part (b)'s faulted
    softmax run on the card and on the CPU: the fault and channel chains
    bitwise (they run on the CPU either way), the surviving and poisoned
    counts equal every round, the weights within the flat route's
    trajectory tolerance 1e-3 (a loss ulp moves a ZO coefficient by
    d.ulp/mu)."""
    task, cfg, faults = faulted_softmax(neural, FedZOConfig, "cuda")
    card = neural.run(task, cfg, FAULT_REF_ROUNDS, faults=faults)
    task, cfg, faults = faulted_softmax(neural, FedZOConfig, "cpu")
    cpu = neural.run(task, cfg, FAULT_REF_ROUNDS, faults=faults)
    check(torch.equal(cpu.fault_state, card.fault_state) and all(
        torch.equal(a, b) for a, b in zip(cpu.channel_state,
                                          card.channel_state)),
        "faulted softmax card vs CPU: chains differ")
    for k in ("m_effective", "m_corrupt"):
        check(torch.equal(cpu.metrics[k], card.metrics[k].cpu()),
              f"faulted softmax card vs CPU: {k} differs")
    worst = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        card.params.values(), cpu.params.values()))
    check(worst <= 1e-3, f"faulted softmax card vs CPU: max |diff| {worst}")
    print(f"small reference (faulted softmax 784x10, {FAULT_REF_ROUNDS} "
          f"rounds, faults and "
          f"channel): card vs CPU max |diff| {worst:.3e} (limit 1e-3); "
          f"chains and masks equal")


# Phase "tiered, hypertune and kernel timing": the tiered client store at
# the paper's partial participation, federated hyperparameter tuning and the
# kernel-timing harness. The population: softmax 784x10 (Sec. V-B width)
# over N = 100,000 ragged clients of 6-12 rows, seed 1 (the reference's
# tiered population, examples/tiered_scale.py, at the track's width); the
# round: the reference's scale100k round on the flat route (M = 32, H = 2,
# b1 = 4, b2 = 20, lr 1e-3, mu 1e-3, threefry).
TIERED_N, TIERED_ROWS, TIERED_BUCKETS = 100_000, (6, 13), 4
# 8 rounds (16 until PR 27, cut in depth to keep the script inside its
# time limit when phase 14 came)
TIERED_ROUNDS, TIERED_SEGMENT = 8, 4
TIERED_FAULT_KW = dict(p_fail=0.1, p_recover=0.5, p_corrupt=0.1)
TIERED_FAULT_ROUNDS, TIERED_CKPT = 8, 4
# hypertune on the card against the CPU: the same tolerance as the port
# against the reference (tests/test_torch_hypertune.py)
HYPERTUNE_ROUNDS, HYPERTUNE_ATOL = 6, 1e-4
# kernel_report at the softmax pad and at the Qwen2-0.5B flat pad, held to
# within 10 % of the kernel table's full-width times (PERF.md section 6,
# the phase "full width" timings of earlier runs): zo_walk 5.755 ms,
# zo_replay (b2 8) 22.74 ms, aircomp_reduce [4, n] 3.202 ms
KERNEL_REPORT_SIZES = ((N_PAD, B2, M), (QWEN_N_PAD, QWEN_B2, QWEN_M))
KERNEL_TABLE_MS = {"zo_walk": 5.755, "zo_replay": 22.74,
                   "aircomp_reduce": 3.202}


class _RoundClock:
    """A metrics sink that stamps the host clock at every tapped round (the
    tap syncs the round's metrics, in either tier alike)."""

    def __init__(self):
        self.stamps = []

    def write(self, row):
        self.stamps.append(time.perf_counter())

    def close(self):
        pass


def _round_ms(clock, skip):
    """(mean, median) ms a round over the rounds after the first ``skip``
    (one segment). The mean carries the tiered runner's per-segment work
    (the next segment's plan, the wait on its staging), which falls on one
    round in a segment and which the median leaves out."""
    gaps = [b - a for a, b in zip(clock.stamps, clock.stamps[1:])][skip - 1:]
    mean = 1e3 * sum(gaps) / len(gaps)
    gaps.sort()
    return mean, 1e3 * gaps[len(gaps) // 2]


def tiered_population():
    """The N = 100,000 ragged clients (host numpy views of one pool)."""
    import numpy as np
    from repro_torch.data.synthetic import make_classification
    rng = np.random.default_rng(1)
    sizes = rng.integers(*TIERED_ROWS, size=TIERED_N)
    x, y = make_classification(int(sizes.sum()), 784, 10, seed=1)
    ends = np.cumsum(sizes)
    return [{"x": x[e - s:e], "y": y[e - s:e]} for s, e in zip(sizes, ends)]


def run_tiered_100k(torch, ops, FedZOConfig, smi, tmp):
    """Parts (a) and (b). (a) the population built into a ``HostStore`` (4
    buckets); 8 rounds through ``sim.run_experiment`` in segments of 4,
    prefetched, then the same experiment on the resident ``ClientStore``
    (``to_resident``, bitwise ``build_store``): params, key and metrics
    ring bitwise, exact and equal launches, ms a round of each tier after
    the first segment (a tap every round; mean and median), the overhead
    of the means, the stall share, host bytes, the staged device bytes (two segments in flight
    under 2 % of the resident store) and each run's peak memory. (b) the
    flat AirComp round under faults and an energy-gated channel, 8 rounds:
    single-shot, killed after one 4-round segment and resumed, and
    resident, all bitwise. Returns the launches."""
    from repro_torch import sim
    from repro_torch.models.simple import softmax_init, softmax_loss

    total = dict.fromkeys(ops.LAUNCHES, 0)

    def add():
        for k in total:
            total[k] += ops.LAUNCHES[k]

    t0 = time.perf_counter()
    clients = tiered_population()
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = sim.build_host_store(clients, n_buckets=TIERED_BUCKETS)
    del clients
    build_s = time.perf_counter() - t0
    print(f"tiered population: N {host.n_clients}, {int(host.sizes.sum())} "
          f"rows of 784 features, buckets {[b.cap for b in host.buckets]} "
          f"rows; generated in {gen_s:.1f} s, bucketed in {build_s:.1f} s; "
          f"host store {host.nbytes / 1e9:.3f} GB [{smi}]")
    cfg = FedZOConfig(n_devices=TIERED_N, n_participating=32,
                      local_iters=2, lr=1e-3, mu=1e-3, b1=4, b2=20,
                      flat_params=True)
    want = round_launches(ops, cfg, TIERED_ROUNDS)

    def timed_run(store, run_cfg=cfg, run_want=want, **kw):
        clock = _RoundClock()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        res = sim.run_experiment(softmax_loss, softmax_init(784, 10), store,
                                 run_cfg, TIERED_ROUNDS, sink=clock,
                                 tap_every=1, **kw)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        add()
        check(launches == run_want,
              f"tiered_100k launches {launches} != {run_want}")
        return (res, _round_ms(clock, TIERED_SEGMENT),
                torch.cuda.max_memory_allocated())

    tier, tier_ms, tier_peak = timed_run(host, stream_segment=TIERED_SEGMENT)
    pf = tier.prefetch
    t0 = time.perf_counter()
    resident = host.to_resident(device="cuda")
    torch.cuda.synchronize()
    res_bytes = sum(v.numel() * v.element_size()
                    for v in resident.data.values())
    print(f"tiered resident store: {res_bytes / 1e9:.3f} GB on the card, "
          f"materialized in {time.perf_counter() - t0:.1f} s [{smi}]")
    res, res_ms, res_peak = timed_run(resident)
    check(_same_run(torch, tier, res),
          "tiered_100k: tiered and resident runs differ")
    staged = 2 * pf["device_segment_bytes_max"]
    check(staged < 0.02 * res_bytes,
          f"tiered_100k: {staged} staged bytes >= 2 % of {res_bytes}")
    losses = [round(float(v), 5) for v in tier.metrics["mean_local_loss"]]
    check(all(math.isfinite(v) for v in losses),
          f"tiered_100k: losses {losses}")
    print(f"tiered_100k (N {TIERED_N}, M 32, H 2, b1 4, b2 20, flat, "
          f"{TIERED_ROUNDS} rounds, segments of {TIERED_SEGMENT}): ms/round "
          f"after the first segment, mean (median): tiered {tier_ms[0]:.2f} "
          f"({tier_ms[1]:.2f}), resident {res_ms[0]:.2f} ({res_ms[1]:.2f}); "
          f"overhead {100 * (tier_ms[0] / res_ms[0] - 1):+.2f} %; stall_pct "
          f"{pf['stall_pct']:.3f} ({pf['stall_s'] * 1e3:.2f} ms of "
          f"{pf['wall_s']:.3f} s), staging {pf['stage_s'] * 1e3:.1f} ms on "
          f"the worker; host bytes {pf['host_bytes']}, "
          f"device_segment_bytes_max {pf['device_segment_bytes_max']} "
          f"({100 * staged / res_bytes:.3f} % of the resident store for two "
          f"segments); peak memory tiered {tier_peak / 2**30:.3f} GiB, "
          f"resident {res_peak / 2**30:.3f} GiB (its store "
          f"{res_bytes / 2**30:.3f} GiB); bitwise equal; launches "
          f"{want} [{smi}]")

    # the reference's scale100k configuration (benchmarks/sim_bench.py:
    # 376-380): the quickstart's fast_sim_config at N 100k, M 32, b1 4, H 2
    qcfg = dataclasses.replace(sim.fast_sim_config(cfg), flat_params=False)
    qwant = fast_launches(ops, qcfg, TIERED_ROUNDS)
    qtier, qtier_ms, qtier_peak = timed_run(
        host, qcfg, qwant, stream_segment=TIERED_SEGMENT)
    qres, qres_ms, qres_peak = timed_run(resident, qcfg, qwant)
    check(_same_run(torch, qtier, qres),
          "tiered_100k fast_sim_config: tiered and resident runs differ")
    print(f"tiered_100k fast_sim_config (the reference's scale100k: wide "
          f"block, unsafe_rbg, {TIERED_ROUNDS} rounds): ms/round after the "
          f"first segment, mean (median): tiered {qtier_ms[0]:.2f} "
          f"({qtier_ms[1]:.2f}), resident {qres_ms[0]:.2f} "
          f"({qres_ms[1]:.2f}); peak tiered {qtier_peak / 2**30:.3f} GiB, "
          f"resident {qres_peak / 2**30:.3f} GiB; bitwise equal; launches "
          f"{qwant} [{smi}]")

    fcfg = FedZOConfig(n_devices=TIERED_N, n_participating=32,
                       local_iters=2, lr=1e-3, mu=1e-3, b1=4, b2=20,
                       flat_params=True, aircomp=True, channel_schedule=True,
                       snr_db=5.0,
                       channel_model=sim.ChannelModel(**CHANNEL_KW))
    faults = sim.FaultModel(**TIERED_FAULT_KW)
    fwant = round_launches(ops, fcfg, TIERED_FAULT_ROUNDS)
    runs, times = {}, {}
    d = os.path.join(tmp, "tiered_ckpt")
    for name, store, kw in (
            ("single", host, {}),
            ("killed", host, dict(checkpoint_every=TIERED_CKPT,
                                  checkpoint_dir=d, max_segments=1)),
            ("resumed", host, dict(checkpoint_every=TIERED_CKPT,
                                   checkpoint_dir=d, resume=True)),
            ("resident", resident, {})):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[name] = sim.run_experiment(
            softmax_loss, softmax_init(784, 10), store, fcfg,
            TIERED_FAULT_ROUNDS, faults=faults, stream_segment=TIERED_SEGMENT,
            **kw)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        add()
        if name in ("single", "resident"):
            check(launches == fwant, f"tiered_aircomp_faulted {name}: "
                  f"launches {launches} != {fwant}")
    check(runs["killed"].rounds == TIERED_CKPT
          and runs["resumed"].rounds == TIERED_FAULT_ROUNDS,
          "tiered_aircomp_faulted: the kill or the resume stopped early")
    for name in ("resumed", "resident"):
        check(_same_run(torch, runs["single"], runs[name]),
              f"tiered_aircomp_faulted: {name} differs from single-shot")
    m_eff = runs["single"].metrics["m_effective"].cpu().tolist()
    print(f"tiered_aircomp_faulted (N {TIERED_N}, M 32, flat AirComp, "
          f"faults {TIERED_FAULT_KW}, channel {CHANNEL_KW}, "
          f"{TIERED_FAULT_ROUNDS} rounds): single-shot "
          f"{times['single']:.2f} s, killed after {TIERED_CKPT} rounds and "
          f"resumed {times['killed'] + times['resumed']:.2f} s, resident "
          f"{times['resident']:.2f} s; all bitwise equal; m_effective "
          f"{m_eff}; launches a run {fwant} [{smi}]")
    del resident
    return total


def run_hypertune(torch, ops, FedZOConfig, smi):
    """Part (c): ``hypertune.make_task()`` at the reference's defaults on
    the card, 10 rounds with the eval every 2 on the pytree route
    (``default_config``) and on the flat route, exact launches; each
    against the same run on the CPU (the hyperparameters and evals within
    ``HYPERTUNE_ATOL``); the pooled validation loss falls by a fifth.
    Returns the launches."""
    from repro_torch.workloads import hypertune

    total = dict.fromkeys(ops.LAUNCHES, 0)
    task = hypertune.make_task(device="cuda")
    cpu_task = hypertune.make_task(device="cpu")
    for route, kw in (("pytree", {}),
                      ("flat", dict(flat_params=True, flat_block_rows=4))):
        cfg = hypertune.default_config(task, **kw)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = hypertune.run(task, cfg, HYPERTUNE_ROUNDS, eval_every=2)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / HYPERTUNE_ROUNDS
        want = round_launches(ops, cfg, HYPERTUNE_ROUNDS, n_leaves=1)
        check(dict(ops.LAUNCHES) == want, f"hypertune {route}: launches "
              f"{dict(ops.LAUNCHES)} != {want}")
        for k in total:
            total[k] += ops.LAUNCHES[k]
        t0 = time.perf_counter()
        cpu = hypertune.run(cpu_task, cfg, HYPERTUNE_ROUNDS, eval_every=2)
        cpu_s = time.perf_counter() - t0
        worst = max([float((res.params["h"].cpu() - cpu.params["h"])
                           .abs().max())]
                    + [float((res.evals[k].cpu() - cpu.evals[k]).abs().max())
                       for k in res.evals])
        check(worst <= HYPERTUNE_ATOL, f"hypertune {route}: card vs CPU "
              f"max |diff| {worst}")
        val = [round(float(v), 5) for v in res.evals["val_loss"].cpu()]
        lr = [round(float(v), 5) for v in res.evals["log_lr"].cpu()]
        check(val[-1] < 0.8 * val[0] and lr[-1] > lr[0],
              f"hypertune {route}: val_loss {val}, log_lr {lr}")
        print(f"hypertune {route} (N 8, M 4, H 2, b2 6, {HYPERTUNE_ROUNDS} "
              f"rounds): {ms:.1f} ms/round; val_loss by eval {val}; log_lr "
              f"{lr}; card vs CPU max |diff| {worst:.3e} (limit "
              f"{HYPERTUNE_ATOL}; CPU run {cpu_s:.1f} s); launches {want} "
              f"[{smi}]")
    return total


def run_kernel_report(torch, ops, smi):
    """Part (d): ``obs.kernel_timing.kernel_report`` on the card at the
    softmax pad (n 65,536, b2 20, m 10) and the Qwen2-0.5B flat pad (n
    494,075,904, b2 8, m 4), measured us beside the 3.35 TB/s model; the
    full-width times within 10 % of the kernel table's."""
    from repro_torch.obs import kernel_report

    for n, b2, m in KERNEL_REPORT_SIZES:
        rows = kernel_report(n=n, b2=b2, m=m)
        for r in rows:
            check(math.isfinite(r.measured_us) and r.measured_us > 0,
                  f"kernel_report {r.name}: {r.measured_us}")
            print(f"kernel_report {r.name}: {r.measured_us:.3f} us, model "
                  f"{r.model_us:.3f} us ({r.hbm_passes:g} passes, "
                  f"{r.hbm_bytes} bytes), {r.model_us / r.measured_us:.1%} "
                  f"of the byte model [{smi}]")
            if n == QWEN_N_PAD:
                kernel = r.name.split("_n")[0].split("_m")[0]
                ref = KERNEL_TABLE_MS[kernel]
                got = r.measured_us / 1e3
                check(abs(got / ref - 1) <= 0.10,
                      f"kernel_report {r.name}: {got:.4f} ms is not within "
                      f"10 % of the table's {ref} ms")
        torch.cuda.empty_cache()


def run_tiered_hypertune(torch, ops, FedZOConfig):
    """Phase "tiered, hypertune and kernel timing", parts (a)-(d). Prints
    each part's seconds and peak memory; returns the launches of (a)-(c)
    (the harness's timing launches of (d) are not a main path's)."""
    import tempfile
    smi = smi_line()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (
                ("tiered", lambda: run_tiered_100k(torch, ops, FedZOConfig,
                                                   smi, tmp)),
                ("hypertune", lambda: run_hypertune(torch, ops, FedZOConfig,
                                                    smi)),
                ("kernel report", lambda: run_kernel_report(torch, ops,
                                                            smi))):
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            got = fn()
            print(f"part {name}: {time.perf_counter() - t:.1f} s, peak "
                  f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB")
            torch.cuda.empty_cache()
            for k in (got or {}):
                total[k] += got[k]
    ops.reset_launches()
    return total


# phase "fast strategy and batched sweeps": the reference's fast execution
# strategy (sim.fast_sim_config: the wide block route, unsafe_rbg keys)
FAST_BUDGET_S = 60.0
# the quickstart's AirComp direction block, one philox_bits launch per
# iterate: [M, b2, n_pad] = [10, 20, 65,536] words
PHILOX_SHAPE = (10, 20, 65_536)
# int32 operations of one Philox-4x32-10 block as the compiler can issue
# them: per round two 32x32 -> 64-bit multiplies (one IMAD.WIDE each gives
# the high and the low word) and two three-input XORs (LOP3), 4; the key
# schedule is the same for every thread (uniform registers), so it is not
# counted per block; the counter's 64-bit add with its carry, 4
PHILOX_BLOCK_OPS = 10 * 4 + 4
QUICKSTART = dict(n_devices=50, n_participating=10, local_iters=5, lr=1e-3,
                  mu=1e-3, b1=25, b2=20)
QS_ROUNDS, QS_EVAL = 20, 5
# the port's trajectory tolerance (tests/test_torch_slice.py; AirComp 2e-3)
FAST_ATOL = 2e-3
# the attack's batched sweep against its sequential runs, relative, on the
# losses (run_attack_sweeps says why the card's records separate; an H100
# read 1.0e-3 on mean_local_loss and 2.1e-3 on first_loss, losses near 4.9,
# and 0.24 on delta_max)
ATTACK_LOSS_RTOL = 5e-3


def fast_launches(ops, cfg, rounds):
    """``round_launches`` plus the Philox draws of a wide route under rbg
    or unsafe_rbg keys: one ``philox_bits`` launch per iterate (the
    cohort's direction block); the integer draws of the round (keys,
    participants, rows) run on the host's CPU and launch nothing."""
    want = round_launches(ops, cfg, rounds)
    if cfg.batch_directions and cfg.prng_impl != "threefry2x32":
        want["philox_bits"] = rounds * cfg.local_iters
    return want


def check_philox(torch, ops, smi):
    """Part (a): philox_bits bitwise its plain version (the plain version
    on the card too) at the quickstart's AirComp block, at a ragged n,
    across the 128-bit counter's carry and from an odd start word; timed
    beside the plain version and its bound. No library call computes XLA's
    layout (torch's own Philox is another stream). Returns the row."""
    from repro_torch.kernels.philox import philox_bits_plain
    from repro_torch.utils import prng
    key = tuple(prng.split(prng.key(0, "unsafe_rbg"), 2,
                           "unsafe_rbg")[1].tolist())
    n = math.prod(PHILOX_SHAPE)
    cases = (("block", key, n, 0), ("ragged", key, 1_000_003, 0),
             ("carry", (5, 7, 0xFFFFFFFE, 0xFFFFFFFF), 4 * 4096 + 5, 0),
             ("offset", key, 65_537, 13))
    for name, words, count, start in cases:
        got = ops.philox_bits(words, count, device="cuda", start=start)
        want = philox_bits_plain(words, count, start=start, device="cuda")
        check(torch.equal(got, want), f"philox_bits {name}: not bitwise "
              f"the plain version")
    ms = median_ms(torch, lambda: ops.philox_bits(key, n, device="cuda"), 50)
    plain_ms = median_ms(
        torch, lambda: philox_bits_plain(key, n, device="cuda"), 3)
    b = bound(4 * n, (n // 4) * PHILOX_BLOCK_OPS, "int")
    print(f"philox_bits {list(PHILOX_SHAPE)} ({n} words): bitwise the plain "
          f"version (also ragged, across the carry, from word 13); "
          f"{ms:.5f} ms, plain {plain_ms:.3f} ms, bound {b['bound_ms']:.5f} "
          f"ms by {b['bound_by']} ({100 * b['bound_ms'] / ms:.1f} %) [{smi}]")
    return {"source": "src/repro_torch/kernels/csrc/philox.cu",
            "replaces": "src/repro/core/estimator.py:335 (jax.random.normal "
                        "over an rbg key: XLA's RngBitGenerator, not a "
                        "Pallas kernel)",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def quickstart_data(torch):
    from repro_torch.data.synthetic import make_classification, noniid_shards
    x, y = make_classification(7000, 784, 10, seed=0)
    clients = noniid_shards(x[:6000], y[:6000], 50)
    test = {"x": torch.from_numpy(x[6000:]).cuda(),
            "y": torch.from_numpy(y[6000:]).cuda()}
    return clients, test


def run_quickstart(torch, ops, FedZOConfig, data, impl, aircomp, total):
    """The quickstart through ``FedServer`` over the store: the scanned
    driver with the eval every 5 rounds (exact launches, peak memory, the
    final test accuracy), then the host-driven rounds of the same server
    without the eval (ms a round after the first, bitwise the scanned
    run). Returns a summary dict."""
    from repro_torch import sim
    from repro_torch.fed.server import FedServer
    from repro_torch.models.simple import (softmax_accuracy, softmax_init,
                                           softmax_loss)
    clients, test = data
    cfg = dataclasses.replace(sim.fast_sim_config(
        FedZOConfig(**QUICKSTART, aircomp=aircomp)), prng_impl=impl)
    store = sim.build_store(clients, device="cuda")
    want = fast_launches(ops, cfg, QS_ROUNDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    srv = FedServer(softmax_loss, softmax_init(784, 10, device="cuda"),
                    clients, cfg, store=store,
                    jit_eval=lambda p: {"test_acc": softmax_accuracy(p, test)},
                    eval_every=QS_EVAL)
    srv.run(QS_ROUNDS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for k in total:
        total[k] += launches[k]
    check(launches == want, f"quickstart {impl} aircomp={aircomp}: launches "
          f"{launches} != {want}")
    peak = torch.cuda.max_memory_allocated()
    acc = float(softmax_accuracy(srv.params, test))
    host = FedServer(softmax_loss, softmax_init(784, 10, device="cuda"),
                     clients, cfg, store=store)
    rows = host.run(QS_ROUNDS, driver="host")
    check(_leaves_equal(torch, host.params, srv.params),
          f"quickstart {impl}: host-driven rounds differ from the scanned")
    gaps = sorted(r["round_ms"] for r in rows[1:])
    mean = sum(gaps) / len(gaps)
    losses = [r["mean_local_loss"] for r in rows]
    check(all(math.isfinite(v) for v in losses), f"quickstart: {losses}")
    return {"wall_s": wall, "ms_mean": mean, "ms_median": gaps[len(gaps) // 2],
            "peak_gib": peak / 2**30, "acc": acc, "launches": launches,
            "loss": (losses[0], losses[-1])}


def check_fast_card_vs_cpu(torch, neural):
    """Card against CPU at the golden size under unsafe_rbg with AirComp,
    on the wide route (``fast_sim_config``) and the pytree route (each
    client's per-leaf draws its slice of one Philox stream, drawn from a
    word offset): the round's integer draws and the direction bits
    bitwise (philox_bits on the card, its plain version on the CPU), the
    trajectories within the port's tolerance."""
    from repro_torch import sim
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec
    kw = dict(n_train=320, n_test=96, n_clients=8, n_features=24,
              n_classes=4, alpha=0.5)
    for route in ("wide", "pytree"):
        out = {}
        for dev in ("cuda", "cpu"):
            task = neural.make_task("softmax", device=dev, **kw)
            cfg = neural.default_config(
                task, n_participating=4, local_iters=2, b1=8, b2=4,
                lr=5e-2, mu=1e-3, seed=11, aircomp=True,
                prng_impl="unsafe_rbg")
            if route == "wide":
                cfg = sim.fast_sim_config(cfg)
            res = neural.run(task, cfg, 4 if route == "wide" else 2,
                             eval_rows=96)
            spec = flat_spec(res.params, block=128)
            keys = prng.split(prng.key(3, "unsafe_rbg"), 4, "unsafe_rbg")
            lane = prng.lanes(keys, "unsafe_rbg")[3]
            out[dev] = (res, prng.random_bits(keys, (4, spec.n_pad),
                                              impl="unsafe_rbg", device=dev),
                        prng.random_bits(lane, (5, 77), impl="unsafe_rbg",
                                         device=dev))
        check(torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
              and torch.equal(out["cuda"][2].cpu(), out["cpu"][2]),
              "fast strategy: card bits differ from the CPU's")
        a, b = out["cuda"][0], out["cpu"][0]
        check(torch.equal(a.key, b.key), "fast strategy: key chains differ")
        check(torch.equal(a.metrics["m_effective"].cpu(),
                          b.metrics["m_effective"].cpu()),
              "m_effective differs")
        worst = max(float((a.params[k].cpu() - b.params[k]).abs().max())
                    for k in b.params)
        mworst = max(float((a.metrics[k].cpu() - b.metrics[k]).abs().max())
                     for k in b.metrics)
        check(max(worst, mworst) <= FAST_ATOL, f"unsafe_rbg {route} card vs "
              f"CPU: params {worst}, metrics {mworst}")
        print(f"unsafe_rbg {route} card vs CPU (softmax 24x4, AirComp): bits "
              f"(also a lane's offset draw) and key chain bitwise; max "
              f"|diff| params {worst:.3e}, metrics {mworst:.3e}")


def run_attack_sweeps(torch, ops, smi, total):
    """Part (d): the attack's SNR sweep, 6 scenarios (SNR {0, 10, 20} dB x
    seeds {0, 1}, 3 rounds, flat route, AirComp) as one batched group
    against the sequential loop of ``attack.run`` calls under threefry,
    then the sweep once under ``fast_sim_config``.

    A one-scenario group is bitwise its single run. The six-scenario
    group's forward runs 60 rows where a single run's runs 10, and the
    card's convolutions and matmuls pick their kernels (and summation
    orders) by shape: a loss ulp moves a coefficient by d·ulp/μ = 3,072 x
    4.8e-7 / 1e-3 = 1.5, so the records separate within a round. They are
    held to a relative ATTACK_LOSS_RTOL on the losses the attack reports
    and exactly on m_effective; the spread of delta_max is printed."""
    from repro_torch import sim
    from repro_torch.workloads import attack
    task = attack.make_task(device="cuda")
    cfg = attack.default_config(task, flat_params=True)
    kw = dict(snr_dbs=(0.0, 10.0, 20.0), seeds=(0, 1), rounds=3,
              eval_every=1)
    times = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = []
    for s in (0.0, 10.0, 20.0):
        for seed in (0, 1):
            seq.append(attack.run(task, dataclasses.replace(
                cfg, aircomp=True, snr_db=s, seed=seed), 3, eval_every=1))
    torch.cuda.synchronize()
    times["sequential"] = time.perf_counter() - t0
    one = sim.run_sweep(attack.attack_loss(task), attack.pert_init("cuda"),
                        task.store, dataclasses.replace(cfg, aircomp=True),
                        [{"snr_db": 0.0, "seed": 0}], 3,
                        eval_fn=attack.attack_eval(task), eval_every=1)[0]
    check(all((one["metrics"][k] == v.cpu().numpy()).all()
              for k, v in seq[0].metrics.items()),
          "one-scenario sweep is not bitwise its single run")
    ops.reset_launches()
    t0 = time.perf_counter()
    recs = attack.run_sweep(task, cfg, **kw)
    torch.cuda.synchronize()
    times["batched"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    for k in total:
        total[k] += launches[k]
    want = round_launches(ops, dataclasses.replace(cfg, aircomp=True), 3)
    check(launches["aircomp_reduce"] == 6 * want["aircomp_reduce"]
          and launches["zo_replay"] == want["zo_replay"],
          f"batched attack sweep launches {launches}: one replay launch per "
          f"iterate for the 60-row cohort, an aircomp_reduce per scenario "
          f"and round")
    rel = dict.fromkeys(("mean_local_loss", "first_loss", "delta_max"), 0.0)
    for rec, res in zip(recs, seq):
        check((rec["metrics"]["m_effective"]
               == res.metrics["m_effective"].cpu().numpy()).all(),
              "batched sweep: m_effective differs")
        for k in rel:
            want_v = res.metrics[k].cpu().numpy()
            rel[k] = max(rel[k], float((abs(rec["metrics"][k] - want_v)
                                        / abs(want_v)).max()))
    check(max(rel["mean_local_loss"], rel["first_loss"]) <= ATTACK_LOSS_RTOL,
          f"batched sweep vs sequential: relative differences {rel}")
    ops.reset_launches()
    t0 = time.perf_counter()
    frecs = attack.run_sweep(task, sim.fast_sim_config(cfg), **kw)
    torch.cuda.synchronize()
    times["fast"] = time.perf_counter() - t0
    flaunch = dict(ops.LAUNCHES)
    for k in total:
        total[k] += flaunch[k]
    check(flaunch["philox_bits"] == 3 * cfg.local_iters
          and flaunch["aircomp_reduce"] == 6 * 3,
          f"fast attack sweep launches {flaunch}")
    check(all(math.isfinite(float(r["metrics"]["mean_local_loss"][-1]))
              for r in frecs), "fast attack sweep diverged")
    print(f"attack SNR sweep (6 scenarios x 3 rounds, M 10, H 20, b2 20): "
          f"sequential {times['sequential']:.2f} s, batched (one [60, n] "
          f"cohort, flat) {times['batched']:.2f} s; one-scenario group "
          f"bitwise its run; six-scenario records against the sequential "
          f"runs, max relative difference {json.dumps(rel)}; "
          f"fast_sim_config (wide, unsafe_rbg) {times['fast']:.2f} s; "
          f"launches batched {launches}, fast {flaunch} [{smi}]")


def run_fast_strategy(torch, ops, neural, FedZOConfig, smi):
    """Phase "fast strategy and batched sweeps": parts (a) to (d) and the
    card against the CPU; budget FAST_BUDGET_S. Returns (philox row,
    launches of the main-path runs)."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    row = check_philox(torch, ops, smi)
    data = quickstart_data(torch)
    qs = {}
    for impl, air in (("unsafe_rbg", False), ("threefry2x32", False),
                      ("unsafe_rbg", True)):
        qs[impl, air] = r = run_quickstart(torch, ops, FedZOConfig, data,
                                           impl, air, total)
        print(f"quickstart {'fast_sim_config' if impl != 'threefry2x32' else 'wide threefry'}"
              f"{' + AirComp' if air else ''} (N 50, M 10, H 5, b1 25, b2 "
              f"20, {QS_ROUNDS} rounds, eval every {QS_EVAL}, FedServer on "
              f"the store): {r['wall_s']:.2f} s scanned; ms/round after the "
              f"first (host-driven) mean {r['ms_mean']:.2f}, median "
              f"{r['ms_median']:.2f}; peak {r['peak_gib']:.3f} GiB; final "
              f"test accuracy {r['acc']:.4f}; loss {r['loss'][0]:.4f} -> "
              f"{r['loss'][1]:.4f}; launches {r['launches']} [{smi}]")
    air = qs["unsafe_rbg", True]["launches"]
    per_round = {k: air[k] / QS_ROUNDS for k in
                 ("aircomp_reduce", "zo_walk", "philox_bits")}
    check(per_round == {"aircomp_reduce": 1, "zo_walk": 1,
                        "philox_bits": QUICKSTART["local_iters"]},
          f"fast AirComp launches a round {per_round}")
    print(f"fast AirComp round launches: {per_round}")
    check(qs["unsafe_rbg", False]["acc"] >= 0.5,
          f"quickstart accuracy {qs['unsafe_rbg', False]['acc']}")
    run_attack_sweeps(torch, ops, smi, total)
    check_fast_card_vs_cpu(torch, neural)
    took = time.perf_counter() - t_phase
    print(f"fast strategy and batched sweeps: {took:.1f} s of the "
          f"{FAST_BUDGET_S:.0f} s budget")
    return row, total


# ---------------------------------------------------------------------------
# phase "serve and sharded rounds"

SERVE_BUDGET_S = 90.0
# qwen2-0.5b through the serve CLI: batch 4 x prompt 32, 16 greedy steps
SERVE_B, SERVE_S, SERVE_GEN = 4, 32, 16
# qwen3-4b and gemma-2b: one prefill of batch 2 x 64 and 4 decode steps
BIG_B, BIG_S, BIG_GEN = 2, 64, 4
# Decode against prefill in bfloat16. The decode step at position S and
# the prefill of S + 1 tokens compute that token's logits by two routes:
# the prefill's flash kernel against the decode's float32 attention over
# the cache, and bfloat16 GEMMs of B.(S + 1) rows against B rows (cuBLAS
# picks other algorithms). Each of the L layers rounds the residual
# stream and each product to bfloat16 (unit roundoff 2^-9 of a value; one
# ulp 2^-8 relative to 2^-7), at other points on each route, so the two
# routes' hidden states drift apart by a few bfloat16 ulps a layer, as a
# random walk over L = 18-36 layers: about sqrt(L) x 2 ulps of 2^-8, 5 %
# of a logit's scale at L = 36. SERVE_BF16_TOL bounds |dec - ref| by that
# share of max |ref| (the float32 reference check, tests/test_arch_smoke
# .py, holds 2e-4 absolute; a decode that read a wrong slot or position
# misses the bound by a logit's whole scale).
SERVE_BF16_TOL = 0.08
# two gloo ranks sharing the card against the one-rank round. Each rank
# computes its rows' losses and deltas as the one rank does (the batched
# forward is per row), so what differs is the order of the float32 sum of
# the two [n_pad] partials against the one rank's sum of M = 10 rows, and
# one rounding into the parameters: a few float32 ulps (1.2e-7 relative
# each) of the largest parameter. GLOO_REL bounds |two ranks - one rank| by
# 1e-6 of max |params| (8 ulps); on an H100 the reading was 1 ulp. The
# round's own update must be at least 10x the bound, so that a rank's
# partial left out, or a sum divided by m where M belongs (errors of the
# update's own size), cannot pass.
GLOO_REL = 1e-6
# the pod step: Qwen2-0.5B in float32, 2 pods of batch 2 x seq 128, b2 8
POD_N, POD_B, POD_S, POD_STEPS = 2, 2, 128, 2


def layer_norms(cfg):
    """RMSNorm launches of one block: two, and the q and k norms under
    qk_norm, MLA's q and kv norms under MLA; none under layernorm (plain
    torch: rwkv6)."""
    if cfg.norm != "rmsnorm":
        return 0
    return 2 + 2 * (cfg.qk_norm or cfg.mla is not None)


def xattn_launches(cfg, kind):
    """rmsnorm and flash_attention launches of one ``kind`` ("prefill", the
    train forward's too, or "decode") forward of an encdec or vlm model.
    encdec (E encoder, L decoder layers): a prefill makes E + 2L attentions
    (the non-causal encoder, the causal self, the non-causal cross) and 2L
    cross q and k norms, a decode step L cross attentions at one query and
    L q norms (its self-attention is the plain one-token form); and under
    rmsnorm 2E + 3L + 2 (prefill) or 3L + 1 block norms. vlm (G groups of
    n_self self layers and one gated cross layer): per self layer two
    norms and, in prefill, one attention; per cross layer its two norms,
    the q norm, in prefill the k norm, and one attention; the final
    norm."""
    rms = cfg.norm == "rmsnorm"
    if cfg.family == "encdec":
        E, L = cfg.encoder_layers, cfg.n_layers
        if kind == "prefill":
            return {"rmsnorm": 2 * L + rms * (2 * E + 3 * L + 2),
                    "flash_attention": E + 2 * L}
        return {"rmsnorm": L + rms * (3 * L + 1), "flash_attention": L}
    G, n = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    pre = kind == "prefill"
    return {"rmsnorm": G * (2 * rms * n + 1 + pre + 2 * rms) + rms,
            "flash_attention": G * (pre * n + 1)}


def serve_launches(cfg, prefills, decodes):
    """rmsnorm and flash_attention launches of ``prefills`` prefills and
    ``decodes`` decode steps of a served model: per layer two RMSNorms
    (and the q and k norms under qk_norm, MLA's q and kv norms under MLA)
    and, in prefill, one attention (none in an ssm layer); the final norm
    once per forward (none of these under layernorm). Decode's one-token
    attention (MLA's absorbed form too), the MoE layers and the ssm and
    Mamba layers are plain torch. encdec and vlm: ``xattn_launches``."""
    if cfg.family in ("encdec", "vlm"):
        p, d = xattn_launches(cfg, "prefill"), xattn_launches(cfg, "decode")
        return {k: prefills * p[k] + decodes * d[k] for k in p}
    per = layer_norms(cfg) * cfg.n_layers + (cfg.norm == "rmsnorm")
    attn = 0 if cfg.family == "ssm" else cfg.n_layers
    return {"rmsnorm": per * (prefills + decodes),
            "flash_attention": attn * prefills}


def dense_param_count(cfg):
    """A dense config's parameter count from its fields (the reference's
    tree: padded embedding, untied unembedding, final norm, L blocks)."""
    vp = cfg.vocab + (-cfg.vocab) % 32
    d, hq, hkv, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    attn = d * hq * hd * 2 + 2 * d * hkv * hd
    attn += (hq + 2 * hkv) * hd if cfg.qkv_bias else 0
    attn += 2 * hd if cfg.qk_norm else 0
    mlp = (3 if cfg.act in ("swiglu", "geglu") else 2) * d * ff
    return (vp * d * (1 if cfg.tie_embeddings else 2) + d
            + cfg.n_layers * (2 * d + attn + mlp))


def decode_vs_prefill(torch, model, params, batch, tol_rel):
    """The reference's consistency check: one decode step at position S
    after a prefill of S tokens against the last logits of a prefill of
    S + 1 tokens. Returns (max |dec - ref| / max |ref| over the real
    vocabulary, the argmax agreement)."""
    from repro_torch.utils import prng
    S = batch["tokens"].shape[1]
    _, cache = model.prefill(params, batch, S + 4)
    nxt = prng.randint(prng.key(5), (batch["tokens"].shape[0], 1), 0,
                       model.cfg.vocab).to("cuda")
    dec, _ = model.decode(params, {"tokens": nxt}, cache,
                          torch.tensor(S, device="cuda"))
    ref, _ = model.prefill(params, {**batch, "tokens": torch.cat(
        [batch["tokens"], nxt], 1)}, S + 5)
    # the padded vocabulary's columns hold -1e30 in both: left out
    v = model.cfg.vocab
    dec, ref = dec[:, :v].float(), ref[:, :v].float()
    rel = float((dec - ref).abs().max() / ref.abs().max())
    check(rel <= tol_rel, f"{model.cfg.name}: decode vs prefill rel {rel} "
          f"> {tol_rel}")
    agree = float((dec.argmax(-1) == ref.argmax(-1)).float().mean())
    return rel, agree


def hold_served_kernels(torch, ops, cfg, b, s, rows):
    """A served model's kernels at the shapes its prefill and decode give
    them, against their plain versions under phase 2's tolerances, in
    float32 and bfloat16: rmsnorm over the block norms' ``[b.s, d_model]``
    and ``[b, d_model]`` rows and, under qk_norm, the q and k norms'
    ``[rows.heads, head_dim]``, under MLA its q and kv norms' ``[rows,
    q_lora]`` and ``[rows, kv_lora]``; attention at ``[b, s, n_heads /
    n_kv_heads, head_dim]`` (MLA: ``n_heads`` kv heads, q/k of nope + rope
    and v of v_head_dim), causal under the config's window. The largest
    errors join the kernels' ``max_abs_err``. Not counted: run before the
    served path's counts are set to 0."""
    from repro_torch.kernels import flash_attention as plain_flash
    from repro_torch.kernels import rmsnorm as plain_rms
    g = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    hq, hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dv = hd
    widths = [(b * s, d), (b, d)]
    if cfg.mla is not None:
        m = cfg.mla
        hkv, hd, dv = hq, m.qk_nope_dim + m.qk_rope_dim, m.v_head_dim
        widths += [(r, w) for r in (b * s, b)
                   for w in (m.q_lora_rank, m.kv_lora_rank)]
    elif cfg.qk_norm:
        widths += [(r * h, hd) for r in (b * s, b) for h in (hq, hkv)]
    notes, err = [], dict.fromkeys(("rmsnorm", "flash_attention"), 0.0)
    for dt in (torch.float32, torch.bfloat16):
        for r, w in widths:
            _, e, note = hold_rmsnorm(torch, ops, plain_rms, rnd(
                r, w, dtype=dt), (1.0 + 0.1 * rnd(w)).to(dt))
            err["rmsnorm"] = max(err["rmsnorm"], e)
            notes.append(note)
        e, note = hold_attention(torch, ops, plain_flash,
                                 rnd(b, s, hq, hd, dtype=dt),
                                 rnd(b, s, hkv, hd, dtype=dt),
                                 rnd(b, s, hkv, dv, dtype=dt), True,
                                 cfg.sliding_window)
        err["flash_attention"] = max(err["flash_attention"], e)
        notes.append(note)
    for k, e in err.items():
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], e)
    print(f"{cfg.name} served shapes against the plain versions: "
          + "; ".join(notes))


def serve_qwen2(torch, ops, smi, total, rows):
    """Part (a): ``launch/serve.py``'s ``main`` on qwen2-0.5b at full width
    in bfloat16, then a steady-state prefill and decode loop on its
    weights, the consistency check and a ring-width run."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    hold_served_kernels(torch, ops, get_config("qwen2-0.5b"), SERVE_B,
                        SERVE_S, rows)
    argv = ["--arch", "qwen2-0.5b", "--batch", str(SERVE_B),
            "--prompt-len", str(SERVE_S), "--gen", str(SERVE_GEN)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve.main(argv)
    cli_s = time.perf_counter() - t0
    model, params, batch = res.model, res.params, res.batch
    cfg = model.cfg
    for got, want in ((res.prefill_launches, serve_launches(cfg, 1, 0)),
                      (res.decode_launches,
                       serve_launches(cfg, 0, SERVE_GEN))):
        want = {**dict.fromkeys(ops.LAUNCHES, 0), **want}
        check(got == want, f"serve qwen2-0.5b: launches {got} != {want}")
        for k in total:
            total[k] += got[k]
    # the same prefill and decode loop again, warm: the steady rates
    width = SERVE_S + SERVE_GEN
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, width)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    pos = torch.tensor(SERVE_S, device="cuda")
    toks = [tok]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SERVE_GEN):
        logits, cache = model.decode(params, {"tokens": tok}, cache, pos + i)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        toks.append(tok)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    want = {**dict.fromkeys(ops.LAUNCHES, 0),
            **serve_launches(cfg, 1, SERVE_GEN)}
    check(counts == want, f"serve qwen2-0.5b warm: {counts} != {want}")
    for k in total:
        total[k] += counts[k]
    again = torch.cat(toks, 1).cpu().numpy()
    check((again == res.tokens).all(), "serve qwen2-0.5b: the warm loop's "
          "tokens are not the CLI's")
    # one decode step and one prefill under the profiler (the last slot is
    # written again): device busy share and kernel time by kind
    prof = {name: kernel_time_by_kind(torch, fn) for name, fn in (
        ("decode step", lambda: model.decode(params, {"tokens": tok}, cache,
                                             pos + SERVE_GEN - 1)),
        ("prefill", lambda: model.prefill(params, batch, width)))}
    rel, agree = decode_vs_prefill(torch, model, params, batch,
                                   SERVE_BF16_TOL)
    # a ring narrower than the prompt: slots pos % 16, finite logits
    lg, ring = model.prefill(params, batch, 16)
    for i in range(4):
        tok = torch.argmax(lg, -1)[:, None].to(torch.int32)
        lg, ring = model.decode(params, {"tokens": tok}, ring, pos + i)
    check(bool(torch.isfinite(lg).all()), "serve qwen2-0.5b ring: logits")
    print(f"qwen2_0_5b_serve (bfloat16, batch {SERVE_B} x prompt {SERVE_S},"
          f" {SERVE_GEN} greedy steps): CLI {cli_s:.2f} s with the init; "
          f"CLI prefill {SERVE_B * SERVE_S / res.prefill_s:.1f} tok/s "
          f"({1e3 * res.prefill_s:.2f} ms), decode "
          f"{SERVE_B * SERVE_GEN / res.decode_s:.1f} tok/s "
          f"({1e3 * res.decode_s / SERVE_GEN:.2f} ms a step); warm prefill "
          f"{SERVE_B * SERVE_S / pre_s:.1f} tok/s ({1e3 * pre_s:.2f} ms), "
          f"decode {SERVE_B * SERVE_GEN / dec_s:.1f} tok/s "
          f"({1e3 * dec_s / SERVE_GEN:.3f} ms a step); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; decode vs "
          f"prefill rel {rel:.3e} (bound {SERVE_BF16_TOL}), argmax agree "
          f"{agree:.2f}; ring width 16 finite; launches prefill "
          f"{res.prefill_launches['rmsnorm']} rmsnorm "
          f"{res.prefill_launches['flash_attention']} attention, decode "
          f"{res.decode_launches['rmsnorm']} rmsnorm [{smi}]")
    for name, (wall, busy, kinds) in prof.items():
        print(f"qwen2_0_5b_serve {name}, profiled: wall {wall:.2f} ms, "
              f"kernel time {sum(kinds.values()):.3f} ms, busy share "
              f"{busy:.3f}; by kind (ms) "
              f"{json.dumps({k: round(v, 4) for k, v in kinds.items()})}")
    del params, cache, ring, res
    torch.cuda.empty_cache()


def serve_big(torch, ops, arch, smi, total, rows):
    """Part (b): one prefill of batch 2 x 64 and 4 greedy decode steps of
    ``arch`` at full width in bfloat16, exact launches, the consistency
    check; the tied unembedding's share of a decode step."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    from repro_torch.models.layers import unembed_fwd
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_size
    model = api.build(get_config(arch))
    cfg = model.cfg
    hold_served_kernels(torch, ops, cfg, BIG_B, BIG_S, rows)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = tree_size(params)
    check(n == dense_param_count(cfg), f"{arch}: {n} parameters")
    batch = api.make_batch(model, ShapeConfig("serve", BIG_S, BIG_B,
                                              "prefill"), prng.key(1),
                           device="cuda")
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, BIG_S + BIG_GEN)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pos = torch.tensor(BIG_S, device="cuda")
    step_s = []
    for i in range(BIG_GEN):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode(params, {"tokens": tok}, cache, pos + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = dict(ops.LAUNCHES)
    want = {**dict.fromkeys(ops.LAUNCHES, 0),
            **serve_launches(cfg, 1, BIG_GEN)}
    check(counts == want, f"{arch}: launches {counts} != {want}")
    check(bool(torch.isfinite(logits).all()), f"{arch}: logits not finite")
    for k in total:
        total[k] += counts[k]
    rel, agree = decode_vs_prefill(torch, model, params, batch,
                                   SERVE_BF16_TOL)
    # the unembedding GEMM of one decode step alone, on the device
    hf = torch.randn((BIG_B, 1, cfg.d_model), device="cuda").to(
        torch.bfloat16)
    un_ms = median_ms(torch, lambda: unembed_fwd(
        params["embed"], hf, cfg.tie_embeddings, cfg.vocab), 20)
    step_ms = 1e3 * sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(f"{arch.replace('-', '_').replace('.', '_')}_serve (bfloat16, "
          f"{n} parameters, init {init_s:.2f} s): prefill batch {BIG_B} x "
          f"{BIG_S} {1e3 * pre_s:.2f} ms ({BIG_B * BIG_S / pre_s:.1f} "
          f"tok/s); decode ms a step {[round(1e3 * s, 3) for s in step_s]} "
          f"({BIG_B / (step_ms / 1e3):.1f} tok/s after the first); the "
          f"{'tied' if cfg.tie_embeddings else 'untied'} [{cfg.d_model}, "
          f"{cfg.vocab}] unembedding {un_ms:.4f} ms on the device, "
          f"{un_ms / step_ms:.3f} of a decode step's host-clock time; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; decode vs "
          f"prefill rel {rel:.3e} (bound {SERVE_BF16_TOL}), argmax agree "
          f"{agree:.2f}; launches {counts['rmsnorm']} rmsnorm "
          f"{counts['flash_attention']} attention [{smi}]")
    del params, cache
    torch.cuda.empty_cache()


def serve_qwen15_smoke(torch, ops, total):
    """Part (b), qwen1.5-32b: its full-width count on ``meta``, and the
    ``-smoke`` config on the card (float32, the reference's tolerance)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api, transformer
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec
    full = get_config("qwen1.5-32b")
    n = flat_spec(transformer.init_params(prng.key(0), full,
                                          device="meta")).d
    check(n == dense_param_count(full) == 35_197_096_960,
          f"qwen1.5-32b: {n} parameters on meta")
    model = api.build(get_config("qwen1.5-32b-smoke"))
    params = model.init(prng.key(0), device="cuda")
    batch = api.make_batch(model, ShapeConfig("serve", BIG_S, BIG_B,
                                              "prefill"), prng.key(1),
                           device="cuda")
    ops.reset_launches()
    logits, cache = model.prefill(params, batch, BIG_S + BIG_GEN)
    for i in range(BIG_GEN):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        logits, cache = model.decode(params, {"tokens": tok}, cache,
                                     torch.tensor(BIG_S + i, device="cuda"))
    counts = dict(ops.LAUNCHES)
    want = {**dict.fromkeys(ops.LAUNCHES, 0),
            **serve_launches(model.cfg, 1, BIG_GEN)}
    check(counts == want, f"qwen1.5-32b-smoke: {counts} != {want}")
    for k in total:
        total[k] += counts[k]
    # float32: the reference's own bound (atol 2e-4, rtol 2e-3), as a share
    rel, agree = decode_vs_prefill(torch, model, params, batch, 2e-3)
    print(f"qwen1_5_32b: {n} parameters on meta; -smoke on the card "
          f"(float32): decode vs prefill rel {rel:.3e}, argmax agree "
          f"{agree:.2f}; launches {counts['rmsnorm']} rmsnorm "
          f"{counts['flash_attention']} attention")


def _gloo_rank(rank, world, out, src, cfgs):
    """A spawned rank of part (c): one round of each config over the
    ``world``-rank clients mesh, every rank on the one card."""
    sys.path.insert(0, src)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import sim
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.workloads import neural
    task = neural.make_task("softmax", n_features=784, n_classes=10,
                            n_clients=50)
    mesh = sim.make_clients_mesh(world)
    res = [neural.run(task, FedZOConfig(**kw), 1, eval_every=0, mesh=mesh)
           for kw in cfgs]
    if rank == 0:
        torch.save([{k: v.cpu() for k, v in r.params.items()} for r in res],
                   out)


def sharded_rounds(torch, ops, neural, FedZOConfig, tmp, total):
    """Part (c): the sharded round on one card. A one-rank nccl group:
    ``neural.run(mesh=)`` bitwise the unsharded run with equal launches,
    3 rounds each of softmax_flat, softmax_aircomp and the faulted AirComp
    config of phase 6(b); then two gloo ranks spawned on the card, one
    round of softmax_flat and softmax_aircomp each, within GLOO_REL of the
    one-rank round's max |params|."""
    import torch.distributed as dist
    from repro_torch import sim
    from repro_torch.launch.mesh import run_ranks
    task = neural.make_task("softmax", n_features=784, n_classes=10,
                            n_clients=50)
    base = dict(flat_params=True, weight_by_size=True)
    air = dict(aircomp=True, channel_schedule=True, snr_db=5.0)
    ftask, fcfg, faults = faulted_softmax(neural, FedZOConfig, "cuda")
    runs = [("softmax_flat_sharded", task, FedZOConfig(**base), None),
            ("softmax_aircomp_sharded", task, FedZOConfig(**base, **air),
             None),
            ("softmax_faulted_sharded", ftask, fcfg, faults)]
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl_init",
                            world_size=1, rank=0)
    try:
        mesh = sim.make_clients_mesh()
        for name, tk, cfg, fm in runs:
            out, counts, ms = [], [], []
            for m in (None, mesh):
                ops.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out.append(neural.run(tk, cfg, 3, eval_every=0, faults=fm,
                                      mesh=m))
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0) / 3)
                counts.append(dict(ops.LAUNCHES))
            check(_same_run(torch, out[0], out[1]),
                  f"{name}: the one-rank sharded run is not the unsharded "
                  f"run bitwise")
            check(counts[0] == counts[1], f"{name}: launches {counts}")
            for k in total:
                total[k] += counts[1][k]
            print(f"{name} (one-rank nccl group, 3 rounds): bitwise the "
                  f"unsharded run; ms/round {ms[1]:.2f} sharded, {ms[0]:.2f} "
                  f"unsharded (first rounds included); launches {counts[1]}")
    finally:
        dist.destroy_process_group()
    cfgs = [base, {**base, **air}]
    out = os.path.join(tmp, "gloo.pt")
    t0 = time.perf_counter()
    run_ranks(_gloo_rank, 2, backend="gloo", init_dir=tmp,
              args=(out, SRC, cfgs), timeout=240)
    spawn_s = time.perf_counter() - t0
    got = torch.load(out)
    p0 = neural.params_init(task)
    for kw, g in zip(cfgs, got):
        one = neural.run(task, FedZOConfig(**kw), 1, eval_every=0)
        err = max(float((g[k] - one.params[k].cpu()).abs().max())
                  for k in g)
        top = max(float(v.abs().max()) for v in one.params.values())
        upd = max(float((one.params[k] - p0[k]).abs().max()) for k in p0)
        tol = GLOO_REL * top
        name = "softmax_aircomp" if kw.get("aircomp") else "softmax_flat"
        check(upd >= 10 * tol, f"two gloo ranks {name}: the round's update "
              f"{upd} is not 10x the bound {tol}")
        check(err <= tol, f"two gloo ranks {name}: {err} > {tol}")
        print(f"two gloo ranks on the card, one round of {name}: max |two "
              f"ranks - one rank| {err:.3e} (bound {tol:.3e} = {GLOO_REL} x "
              f"max |params| {top:.4e}; the round's update {upd:.4e})")
    print(f"two gloo ranks: {spawn_s:.1f} s spawned, joined")


def pod_step(torch, ops, FedZOConfig, smi, total):
    """Part (d): ``make_pod_round_step`` on Qwen2-0.5B at full width in
    float32, 2 pods of batch 2 x seq 128 (the grouped loss), flat route,
    b2 = 8, 2 steps with exact launches; ``make_delta_agg_step`` on two
    per-pod delta trees at smoke size."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.launch.mesh import make_pod_mesh
    from repro_torch.models import api
    from repro_torch.configs import get_config
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves, tree_map
    model, toks = lm_setup("qwen2-0.5b", "float32")
    L = model.cfg.n_layers
    params = model.init(prng.key(0), device="cuda")
    cfg = FedZOConfig(lr=1e-4, mu=1e-3, b2=QWEN_B2, flat_params=True)
    step = fedzo.make_pod_round_step(
        lambda p, b: model.loss(p, b, n_groups=POD_N), cfg,
        make_pod_mesh(POD_N))
    want = {**dict.fromkeys(ops.LAUNCHES, 0), "zo_walk": cfg.b2,
            "zo_replay": 1, "zo_dirnorms": 1,
            "rmsnorm": (1 + cfg.b2) * (2 * L + 1),
            "flash_attention": (1 + cfg.b2) * L}
    rng, key = np.random.default_rng(3), prng.key(6)
    torch.cuda.reset_peak_memory_stats()
    ms, mets = [], []
    for _ in range(POD_STEPS):
        batch = lm_batch(torch, toks, rng, POD_N * POD_B, POD_S, "cuda")
        ks = prng.split(key, 2)
        key, sub = ks[0], ks[1]
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, met = step(params, batch, sub)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        counts = dict(ops.LAUNCHES)
        check(counts == want, f"pod step: launches {counts} != {want}")
        for k in total:
            total[k] += counts[k]
        mets.append({k: v.tolist() for k, v in met.items()})
    check(all(math.isfinite(x) for m in mets for x in m["per_pod_loss"]),
          f"pod step: {mets}")
    check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)),
          "pod step: parameters not finite")
    print(f"qwen2_0_5b_pod_step (float32, {POD_N} pods of batch {POD_B} x "
          f"{POD_S}, flat, b2 {cfg.b2}): ms a step "
          f"{[round(t, 2) for t in ms]}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; metrics "
          f"{json.dumps(mets)}; launches a step {want} [{smi}]")
    del params
    torch.cuda.empty_cache()
    # the dense-uplink aggregation of two per-pod delta trees (smoke size)
    sm = api.build(get_config("qwen2-0.5b-smoke"))
    trees = [sm.init(prng.key(s), device="cuda") for s in (1, 2)]
    deltas = tree_map(lambda a, b: torch.stack([a, b]), *trees)
    mean = fedzo.make_delta_agg_step(FedZOConfig(), POD_N)(deltas,
                                                           prng.key(0))
    noisy = fedzo.make_delta_agg_step(FedZOConfig(aircomp=True, snr_db=30.0),
                                      POD_N)(deltas, prng.key(0))
    for a, b, m in zip(tree_leaves(trees[0]), tree_leaves(trees[1]),
                       tree_leaves(mean)):
        check(torch.equal(m, (a + b) / 2), "delta agg: not the mean")
    dev = max(float((n - m).abs().max()) for n, m in
              zip(tree_leaves(noisy), tree_leaves(mean)))
    check(math.isfinite(dev) and dev > 0, f"delta agg aircomp: {dev}")
    print(f"make_delta_agg_step (2 pods, qwen2-0.5b-smoke trees): mean "
          f"exact; AirComp at 30 dB within {dev:.3e} of it")


def run_serve_sharded(torch, ops, neural, FedZOConfig, smi, rows):
    """Phase "serve and sharded rounds": parts (a) to (d), each part's
    seconds and peak memory printed; budget SERVE_BUDGET_S. The served
    shapes' kernel checks fold their errors into ``rows``. Returns the
    launches of its main-path runs."""
    import tempfile
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    with tempfile.TemporaryDirectory() as tmp:
        for name, part in (
                ("(a) serve qwen2-0.5b", lambda: serve_qwen2(
                    torch, ops, smi, total, rows)),
                ("(b) serve qwen3-4b", lambda: serve_big(
                    torch, ops, "qwen3-4b", smi, total, rows)),
                ("(b) serve gemma-2b", lambda: serve_big(
                    torch, ops, "gemma-2b", smi, total, rows)),
                ("(b) qwen1.5-32b", lambda: serve_qwen15_smoke(
                    torch, ops, total)),
                ("(c) sharded rounds", lambda: sharded_rounds(
                    torch, ops, neural, FedZOConfig, tmp, total)),
                ("(d) pod step", lambda: pod_step(
                    torch, ops, FedZOConfig, smi, total))):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            part()
            print(f"part {name}: {time.perf_counter() - t0:.1f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"serve and sharded rounds: {took:.1f} s of the "
          f"{SERVE_BUDGET_S:.0f} s budget [{smi}]")
    return total


# ---------------------------------------------------------------------------
# phase "moe serving": qwen3-moe-30b-a3b at full width and depth,
# deepseek-v3-671b at full width cut to 4 layers, both -smoke configs on
# the card against the CPU

MOE_BUDGET_S = 150.0
# one prefill of batch 2 x 64 and 4 greedy decode steps
MOE_B, MOE_S, MOE_GEN = 2, 64, 4
# deepseek-v3-671b cut in depth only: its 3 dense layers, 1 MoE layer and
# the MTP block at full width (15,694,592,000 parameters, 29.24 GiB bf16)
DEEPSEEK_LAYERS = 4
DEEPSEEK_4L_PARAMS = 15_694_592_000
DEEPSEEK_PARAMS = 671_609_894_912
QWEN3_MOE_PARAMS = 30_532_122_624
# qwen3-moe-30b-a3b's bfloat16 weights are 56.89 GiB; beside them the init
# holds one layer while it is copied into the stack (1.2 GB) and one draw
# chunk's temporaries (prng.DRAW_CHUNK: 2 GiB). A peak from before the init
# below 64 GiB shows the stack is not held twice (114 GiB) and no leaf was
# drawn whole (about 67 GiB).
MOE_PEAK_GIB = 64.0
# The -smoke configs on the card against the CPU, in float32. Logits,
# caches and losses: within SMOKE_CARD_REL of the largest magnitude, as the
# dense smoke configs' serving check (the GEMMs and the kernels sum in
# other orders; readings of a few 1e-7). The pytree train step: a
# coefficient is d.(L(x + mu.v) - L(x))/mu, and one loss ulp (4.8e-7 near
# 6.6) moves it by d.ulp/mu = 30 at d = 624,384 and mu = 1e-2, and a weight
# by lr/b2 . 30 . max |v_i| = 1e-3/2 . 30 . 6.3e-3 = 9.5e-5 (a unit
# direction's largest entry in 624,384 dims is about 5/sqrt(d)).
# MOE_STEP_TOL = 1e-3 allows about ten loss ulps, as the dense smoke steps'
# card-vs-CPU bound; the step must move a weight by at least ten times it,
# so a lost or doubled update cannot pass (the port against JAX on the CPU
# reads 2.1e-4 and 1.2e-7, tests/test_torch_moe.py).
SMOKE_CARD_REL = 1e-5
MOE_STEP_TOL = 1e-3
SMOKE_S = 32    # the -smoke configs' prompt and train sequence


def moe_drop_spy():
    """Record (tokens, kept, assignments) of every MoE routing while it is
    installed; returns (records, uninstall). The counts stay on the device
    until read."""
    from repro_torch.models import moe
    orig, seen = moe.route, []

    def spy(x_flat, *a, **k):
        r = orig(x_flat, *a, **k)
        seen.append((x_flat.shape[0], r["keep"].sum(), r["keep"].numel()))
        return r

    moe.route = spy

    def undo():
        moe.route = orig
    return seen, undo


def moe_bitwise_twice(torch, cfg, p, gen, dtype):
    """``moe_fwd`` twice on the same [MOE_B, MOE_S, d] input on the card:
    bitwise equal outputs and aux."""
    from repro_torch.models import moe
    x = torch.randn((MOE_B, MOE_S, cfg.d_model), generator=gen,
                    device="cuda").to(dtype)
    a, aux_a = moe.moe_fwd(p, cfg, x)
    b, aux_b = moe.moe_fwd(p, cfg, x)
    check(torch.equal(a, b) and torch.equal(aux_a, aux_b),
          f"{cfg.name}: moe_fwd differs between two runs on the card")


def serve_moe_loop(torch, ops, model, params, batch, cfg, total,
                   s=MOE_S, gen=MOE_GEN):
    """One warm prefill of the batch (prompt ``s``) and ``gen`` greedy
    decode steps, each timed between synchronisations, exact launches.
    Returns (prefill s, decode s per step)."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, s + gen)
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    pos = torch.tensor(s, device="cuda")
    steps = []
    for i in range(gen):
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.decode(params, {"tokens": tok}, cache, pos + i)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    counts = dict(ops.LAUNCHES)
    want = {**dict.fromkeys(ops.LAUNCHES, 0), **serve_launches(cfg, 1, gen)}
    check(counts == want, f"{cfg.name}: launches {counts} != {want}")
    check(bool(torch.isfinite(logits).all()), f"{cfg.name}: logits")
    for k in total:
        total[k] += counts[k]
    return pre_s, steps


def serve_qwen3_moe(torch, ops, smi, total, rows):
    """Part (a): ``launch/serve.py``'s ``main`` on qwen3-moe-30b-a3b at full
    width and depth in bfloat16 (batch 2 x prompt 64, 4 greedy steps):
    init seconds, peak memory from before the init, exact launches, the
    share of routed assignments dropped at the published capacity factor;
    a warm prefill and decode loop; decode against prefill on the
    no-drop capacity; moe_fwd bitwise run to run at full width."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api, transformer
    from repro_torch.utils.tree import tree_size
    cfg = get_config("qwen3-moe-30b-a3b")
    hold_served_kernels(torch, ops, cfg, MOE_B, MOE_S, rows)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seen, undo = moe_drop_spy()
    try:
        res = serve.main(["--arch", cfg.name, "--batch", str(MOE_B),
                          "--prompt-len", str(MOE_S), "--gen",
                          str(MOE_GEN)])
    finally:
        undo()
    peak = torch.cuda.max_memory_allocated() / 2**30
    model, params, batch = res.model, res.params, res.batch
    n = tree_size(params)
    check(n == QWEN3_MOE_PARAMS, f"{cfg.name}: {n} parameters")
    check(peak < MOE_PEAK_GIB, f"{cfg.name}: peak {peak:.2f} GiB from "
          f"before the init, bound {MOE_PEAK_GIB}")
    for got, want in ((res.prefill_launches, serve_launches(cfg, 1, 0)),
                      (res.decode_launches,
                       serve_launches(cfg, 0, MOE_GEN))):
        want = {**dict.fromkeys(ops.LAUNCHES, 0), **want}
        check(got == want, f"serve {cfg.name}: launches {got} != {want}")
        for k in total:
            total[k] += got[k]
    pre = [(k, t) for T, k, t in seen if T == MOE_B * MOE_S]
    check(len(pre) == cfg.n_layers, f"{cfg.name}: {len(pre)} prefill "
          f"routings")
    kept = sum(int(k) for k, _ in pre)
    routed = sum(t for _, t in pre)
    dropped = 1.0 - kept / routed
    pre_s, steps = serve_moe_loop(torch, ops, model, params, batch, cfg,
                                  total)
    # Capacity drops differ between a batched prefill (T = B.S tokens
    # share each expert's C slots) and a one-token decode by design, which
    # is why the reference's reduced() uses capacity 4.0: the check runs
    # on the same weights at the capacity factor E / k, which drops nothing
    nodrop = api.build(cfg.replace(capacity_factor=cfg.n_experts
                                   / cfg.top_k))
    rel, agree = decode_vs_prefill(torch, nodrop, params, batch,
                                   SERVE_BF16_TOL)
    g = torch.Generator(device="cuda").manual_seed(7)
    moe_bitwise_twice(torch, cfg, transformer._layer(
        params["moe_blocks"]["moe"], 0), g, torch.bfloat16)
    step_ms = 1e3 * sorted(steps[1:])[len(steps[1:]) // 2]
    print(f"qwen3_moe_30b_a3b_serve (bfloat16, full width and depth, {n} "
          f"parameters): init {res.init_s:.2f} s; peak {peak:.3f} GiB from "
          f"before the init (bound {MOE_PEAK_GIB}); CLI prefill batch "
          f"{MOE_B} x {MOE_S} {1e3 * res.prefill_s:.2f} ms "
          f"({MOE_B * MOE_S / res.prefill_s:.1f} tok/s), decode "
          f"{1e3 * res.decode_s / MOE_GEN:.2f} ms a step; warm prefill "
          f"{1e3 * pre_s:.2f} ms ({MOE_B * MOE_S / pre_s:.1f} tok/s), decode "
          f"ms a step {[round(1e3 * t, 3) for t in steps]} ({step_ms:.3f} "
          f"median after the first, {MOE_B / (step_ms / 1e3):.1f} tok/s); "
          f"dropped at capacity factor {cfg.capacity_factor}: "
          f"{routed - kept} of {routed} routed assignments in the prefill "
          f"({dropped:.4f}); decode vs prefill at capacity factor "
          f"{cfg.n_experts / cfg.top_k} rel {rel:.3e} (bound "
          f"{SERVE_BF16_TOL}), argmax agree {agree:.2f}; moe_fwd bitwise "
          f"run to run; launches prefill {res.prefill_launches['rmsnorm']} "
          f"rmsnorm {res.prefill_launches['flash_attention']} attention, "
          f"decode {res.decode_launches['rmsnorm']} rmsnorm [{smi}]")
    del params, res, model, batch
    torch.cuda.empty_cache()


def serve_deepseek_4l(torch, ops, smi, total, rows):
    """Part (b): deepseek-v3-671b at full width with its depth cut to
    DEEPSEEK_LAYERS (3 dense, 1 MoE, the MTP block) in bfloat16: the
    61-layer count on ``meta``, init, prefill 2 x 64 and 4 decode steps
    with exact launches, decode against prefill on the no-drop capacity,
    the loss at 2 x 64 with its MTP term."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api, transformer
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec
    from repro_torch.utils.tree import tree_size
    full = get_config("deepseek-v3-671b")
    n_full = flat_spec(transformer.init_params(prng.key(0), full,
                                               device="meta")).d
    check(n_full == DEEPSEEK_PARAMS, f"deepseek-v3-671b: {n_full} on meta")
    cfg = full.replace(n_layers=DEEPSEEK_LAYERS)
    hold_served_kernels(torch, ops, cfg, MOE_B, MOE_S, rows)
    model = api.build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = tree_size(params)
    check(n == DEEPSEEK_4L_PARAMS, f"deepseek-v3-671b 4L: {n} parameters")
    batch = api.make_batch(model, ShapeConfig("serve", MOE_S, MOE_B,
                                              "prefill"), prng.key(1),
                           device="cuda")
    pre_s, steps = serve_moe_loop(torch, ops, model, params, batch, cfg,
                                  total)
    nodrop = api.build(cfg.replace(capacity_factor=cfg.n_experts
                                   / cfg.top_k))
    rel, agree = decode_vs_prefill(torch, nodrop, params, batch,
                                   SERVE_BF16_TOL)
    # the train forward: cross entropy + the MoE aux + 0.3 x the MTP
    # block's cross entropy; per forward 4 norms a layer (2 block, MLA's q
    # and kv), the final norm, the MTP norm and block (5), L + 1 attentions
    tb = api.make_batch(model, ShapeConfig("train", MOE_S, MOE_B, "train"),
                        prng.key(2), device="cuda")
    ops.reset_launches()
    loss = float(model.loss(params, tb))
    counts = dict(ops.LAUNCHES)
    want = {**dict.fromkeys(ops.LAUNCHES, 0),
            "rmsnorm": 4 * DEEPSEEK_LAYERS + 1 + 5,
            "flash_attention": DEEPSEEK_LAYERS + 1}
    check(counts == want, f"deepseek loss: launches {counts} != {want}")
    for k in total:
        total[k] += counts[k]
    no_mtp = float(transformer.loss_fn(params, tb, cfg.replace(mtp=False)))
    mtp_term = loss - no_mtp
    check(math.isfinite(loss) and math.isfinite(no_mtp) and mtp_term > 0,
          f"deepseek loss {loss}, without MTP {no_mtp}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = 1e3 * sorted(steps[1:])[len(steps[1:]) // 2]
    print(f"deepseek_v3_4l_serve (bfloat16, full width, reduced: depth only,"
          f" n_layers {DEEPSEEK_LAYERS} of {full.n_layers}; {n} parameters, "
          f"{n_full} at full depth on meta): init {init_s:.2f} s; prefill "
          f"batch {MOE_B} x {MOE_S} {1e3 * pre_s:.2f} ms "
          f"({MOE_B * MOE_S / pre_s:.1f} tok/s); decode ms a step "
          f"{[round(1e3 * t, 3) for t in steps]} ({step_ms:.3f} median after "
          f"the first); peak {peak:.3f} GiB from before the init; decode vs "
          f"prefill at capacity factor {cfg.n_experts / cfg.top_k} rel "
          f"{rel:.3e} (bound {SERVE_BF16_TOL}), argmax agree {agree:.2f}; "
          f"loss at {MOE_B} x {MOE_S} {loss:.6f}, MTP term {mtp_term:.6f}; "
          f"launches {counts['rmsnorm']} rmsnorm "
          f"{counts['flash_attention']} attention a loss [{smi}]")
    del params
    torch.cuda.empty_cache()


def smoke_runs(torch, ops, model, init, fcfg, gen, losses):
    """A -smoke model on the CPU, then on the card from the same weights
    ``init``: a prefill of batch MOE_B x SMOKE_S, ``gen`` decode steps on
    the CPU's greedy tokens, ``losses(params, train batch)`` (a list of
    floats) and one pytree FedZO train step under ``fcfg``. Returns {device:
    (logits, cache leaves, losses, the stepped leaves, the serving
    launches, the step's launches, the step's forwards)}, tensors on the
    CPU."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import fedzo
    from repro_torch.models import api
    from repro_torch.utils import convert, prng
    from repro_torch.utils.flatparams import _leaves
    shape = ShapeConfig("p", SMOKE_S, MOE_B, "prefill")
    tshape = ShapeConfig("t", SMOKE_S, MOE_B, "train")
    calls = [0]

    def loss(p, b):
        calls[0] += 1
        return model.loss(p, b)

    out, toks = {}, []
    for dev in ("cpu", "cuda"):
        p = init if dev == "cpu" else convert.to_torch(
            convert.to_numpy(init), device="cuda")
        b = api.make_batch(model, shape, prng.key(1), device=dev)
        tb = api.make_batch(model, tshape, prng.key(2), device=dev)
        ops.reset_launches()
        lg, c = model.prefill(p, b, shape.seq_len + gen)
        logits = [lg.cpu()]
        for i in range(gen):
            if dev == "cpu":
                toks.append(torch.argmax(lg, -1)[:, None].to(torch.int32))
            lg, c = model.decode(p, {"tokens": toks[i].to(dev)}, c,
                                 torch.tensor(shape.seq_len + i, device=dev))
            logits.append(lg.cpu())
        serve_counts = dict(ops.LAUNCHES)
        vals = losses(p, tb)
        calls[0] = 0
        ops.reset_launches()
        new, _ = fedzo.make_train_step(loss, fcfg)(p, tb, prng.key(3))
        out[dev] = (logits, [t.cpu() for _, t in _leaves(c)], vals,
                    [t.cpu() for _, t in _leaves(new)], serve_counts,
                    dict(ops.LAUNCHES), calls[0])
    return out


def moe_smoke_card_vs_cpu(torch, ops, FedZOConfig, total):
    """Part (c): both -smoke configs in float32 on the card against the
    same port on the CPU from the same weights: prefill and 4 decode steps
    on the CPU's greedy tokens (logits and caches), the loss with and
    without the aux (and the MTP term), one pytree FedZO train step (b2 2,
    mu 1e-2) with exact launches, and moe_fwd bitwise run to run."""
    from repro_torch.configs import get_config
    from repro_torch.models import api, transformer
    from repro_torch.utils import convert, prng
    from repro_torch.utils.flatparams import _leaves
    notes = []
    for arch in ("qwen3-moe-30b-a3b-smoke", "deepseek-v3-671b-smoke"):
        model = api.build(get_config(arch))
        cfg = model.cfg
        init = model.init(prng.key(0), device="cpu")
        fcfg = FedZOConfig(lr=1e-3, mu=1e-2, b2=2)

        def losses(p, tb):
            vals = [float(model.loss(p, tb)), float(transformer.loss_fn(
                p, tb, cfg.replace(router_aux_coef=0.0)))]
            if cfg.mtp:
                vals.append(float(transformer.loss_fn(
                    p, tb, cfg.replace(mtp=False))))
            return vals

        out = smoke_runs(torch, ops, model, init, fcfg, MOE_GEN, losses)
        cpu, card = out["cpu"], out["cuda"]
        worst = 0.0
        for g, w in zip(card[0] + card[1], cpu[0] + cpu[1]):
            worst = max(worst, float((g - w).abs().max() / w.abs().max()))
        check(worst <= SMOKE_CARD_REL, f"{arch}: serve card vs CPU {worst}")
        lrel = max(abs(a - b) / abs(b) for a, b in zip(card[2], cpu[2]))
        check(lrel <= SMOKE_CARD_REL, f"{arch}: losses {card[2]} {cpu[2]}")
        check(cpu[2][0] > cpu[2][1], f"{arch}: no aux in the loss")
        if cfg.mtp:
            check(abs(cpu[2][0] - cpu[2][2]) > 1e-3, f"{arch}: no MTP term")
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(cpu[3], (t for _, t in _leaves(init))))
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(card[3], cpu[3]))
        check(diff <= MOE_STEP_TOL and moved >= 10 * MOE_STEP_TOL,
              f"{arch}: step card vs CPU {diff}, moved {moved}")
        want = {**dict.fromkeys(ops.LAUNCHES, 0),
                **serve_launches(cfg, 1, MOE_GEN)}
        check(card[4] == want, f"{arch}: serve launches {card[4]} != {want}")
        # a forward: the blocks' norms, the final norm, and under MTP its
        # norm and block
        per_norm = serve_launches(cfg, 1, 0)["rmsnorm"] \
            + cfg.mtp * (1 + layer_norms(cfg))
        per_attn = cfg.n_layers + cfg.mtp
        n_leaves = len(_leaves(init))
        want = {**dict.fromkeys(ops.LAUNCHES, 0),
                "rmsnorm": card[6] * per_norm,
                "flash_attention": card[6] * per_attn,
                "zo_axpy": 2 * fcfg.b2 * n_leaves}
        check(card[6] == cpu[6] == fcfg.b2 + 1 and card[5] == want,
              f"{arch}: step launches {card[5]} != {want} ({card[6]} "
              f"forwards)")
        for counts in (card[4], card[5]):
            for k in total:
                total[k] += counts[k]
        p = transformer._layer(convert.to_torch(convert.to_numpy(
            init["moe_blocks"]["moe"]), device="cuda"), 0)
        moe_bitwise_twice(torch, cfg, p, torch.Generator(
            device="cuda").manual_seed(8), torch.float32)
        notes.append(f"{arch}: serve card vs CPU {worst:.3e}, losses "
                     f"{lrel:.3e} (bound {SMOKE_CARD_REL}); step "
                     f"{diff:.3e} (bound {MOE_STEP_TOL}) against a move of "
                     f"{moved:.4g}; moe_fwd bitwise run to run")
    print("moe smoke configs (float32) on the card against the CPU: "
          + "; ".join(notes))


def time_mla_attention(torch, ops, smi, rows):
    """flash_attention at DeepSeek-V3's prefill pair (192, 128), [2, 64,
    128/128 heads], causal, both dtypes, against SDPA and the bound;
    stored in the attention row's ``mla`` entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as plain_flash
    g = torch.Generator(device="cuda").manual_seed(9)
    b, s, h, dk, dv = MOE_B, MOE_S, 128, 192, 128
    q, k = (torch.randn(b, s, h, dk, generator=g, device="cuda")
            for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=g, device="cuda")
    pairs = s * (s + 1) // 2            # causal (q, k) pairs per head
    flops = 2 * (dk + dv) * pairs * b * h   # q.k and p.v multiply-adds
    elems = b * s * h * (2 * dk + 2 * dv)   # q, k, v read, out written
    out, lines = {}, []
    for dt, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        ms = median_ms(torch, lambda: ops.attention(qd, kd, vd), 50)
        lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            is_causal=True), 50)
        plain_ms = median_ms(torch, lambda: plain_flash
                             .flash_attention_plain(qd, kd, vd), 10)
        bd = bound(elems * (4 if dt == torch.float32 else 2), flops, kind)
        out[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, **bd)
        lines.append(f"flash_attention (192, 128) {kind} [{b}, {s}, {h}/{h}]"
                     f" causal: ms {ms:.5f} plain {plain_ms:.4f} library "
                     f"{lib:.5f} ({ms / lib:.2f}x SDPA) bound "
                     f"{bd['bound_ms']:.5f} ({bd['bound_by']}, "
                     f"{bd['bound_ms'] / ms:.1%} of it) [{smi}]")
    rows["flash_attention"]["mla"] = out
    for line in lines:
        print(line)


def run_moe_serving(torch, ops, FedZOConfig, smi, rows):
    """Phase "moe serving": parts (a) to (c) and the (192, 128) attention
    timing, each part's seconds and peak memory printed; budget
    MOE_BUDGET_S. Returns the launches of its main-path runs."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    for name, part in (
            ("(a) serve qwen3-moe-30b-a3b", lambda: serve_qwen3_moe(
                torch, ops, smi, total, rows)),
            ("(b) serve deepseek-v3-671b, 4 layers", lambda: serve_deepseek_4l(
                torch, ops, smi, total, rows)),
            ("(c) smoke configs card vs CPU", lambda: moe_smoke_card_vs_cpu(
                torch, ops, FedZOConfig, total)),
            ("attention (192, 128) timing", lambda: time_mla_attention(
                torch, ops, smi, rows))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        part()
        print(f"part {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"moe serving: {took:.1f} s of the {MOE_BUDGET_S:.0f} s budget "
          f"[{smi}]")
    return total


# ---------------------------------------------------------------------------
# phase "moe cohort, ssm and hybrid": the flat FedZO round on
# qwen3-moe-30b-a3b at full width (depth cut to one layer), hymba-1.5b and
# rwkv6-7b served at full width and depth, the -smoke configs on the card
# against the CPU

COHORT_BUDGET_S = 150.0
# qwen3-moe-30b-a3b at full width (all 128 experts, d 2,048, the full
# 151,936-token vocabulary), its depth cut to the first layer (a MoE
# layer): 1,245,452,544 parameters, 4.64 GiB a float32 copy. The flat round
# holds about 2 + 4M such copies at M clients (the flat Qwen2-0.5B round
# of phase "qwen flat round" holds 33.19 GiB at M = 4 on an H100, 18
# copies of 1.84 GiB): about 46 GiB at M = 2, and past 65 GiB at two
# layers or M = 4; hence one layer and M = 2.
COHORT_LAYERS, COHORT_PARAMS = 1, 1_245_452_544
COHORT_M, COHORT_H, COHORT_B2 = 2, 2, 8
COHORT_B, COHORT_S = 4, 128       # per client, of the synthetic LM stream
# hymba-1.5b served: batch 2 x prompt 2,048, so the sliding window of
# 1,024 bites, and 8 greedy steps; then the cross-silo train step in
# float32, 2 flat steps (b2 8) of batch 2 x 256
HYMBA_B, HYMBA_S, HYMBA_GEN = 2, 2_048, 8
HYMBA_PARAMS = 1_393_000_000
HYMBA_STEP_B, HYMBA_STEP_S, HYMBA_STEPS = 2, 256, 2
# rwkv6-7b served: batch 2 x prompt 512, 8 greedy steps
RWKV_B, RWKV_S, RWKV_GEN = 2, 512, 8
RWKV_PARAMS = 7_534_944_256
# The -smoke rounds on the card against the CPU (qwen3-moe and deepseek-v3,
# M = 3, b2 = 4, mu = 1e-2, lr = 1e-3): a loss ulp moves a weight by about
# 1e-4 an iterate (check_lm_round_small_reference's argument), so one
# iterate stays within 1e-3. One iterate (H = 1), not two: at random
# weights a perturbed point that crosses a routing boundary gives a
# coefficient of millions, and the second iterate starts from weights
# that such a coefficient moved by up to 0.6, where a 1e-6 relative
# difference in the start moves the round's result by 0.43 (qwen3-moe-smoke
# on this stream, measured on the CPU; with H = 1 a 1e-5 relative
# difference moves it by 1.2e-4 at most, and the card's forwards differ
# from the CPU's by about 1e-7).
COHORT_SMOKE_H = 1
COHORT_SMOKE_TOL = 1e-3
# The ssm and hybrid -smoke pytree steps: MOE_STEP_TOL's argument (a loss
# ulp moves a weight by about 1e-4 at lr 1e-3, b2 2, mu 1e-2); the step
# must move a weight by at least five times the bound (hymba-1.5b-smoke's
# step moves its largest weight by 9.7e-3, tests/test_torch_ssm.py).
SSM_STEP_MOVE = 5 * MOE_STEP_TOL
SSM_SMOKE_GEN = 4   # the ssm and hybrid -smoke configs' decode steps


def cohort_launches(ops, mcfg, fcfg):
    """Launches of one simulated round of the LM ``mcfg`` under ``fcfg``
    (flat or wide): ``round_launches``' ZO kernels, and per forward the
    blocks' RMSNorms, the final norm and, under MTP, its norm and block
    (none under layernorm: rwkv6); one attention a layer (and the MTP
    block's; none in an ssm layer). An encdec or vlm cohort forward makes
    a one-client train forward's launches (``xattn_launches``)."""
    want = round_launches(ops, fcfg, 1)
    forwards = fcfg.local_iters * (2 if fcfg.batch_directions
                                   else fcfg.b2 + 1)
    if mcfg.family in ("encdec", "vlm"):
        per = xattn_launches(mcfg, "prefill")
        want.update({k: forwards * n for k, n in per.items()})
        return want
    rms = mcfg.norm == "rmsnorm"
    norms = (layer_norms(mcfg) * mcfg.n_layers + rms
             + mcfg.mtp * (1 + layer_norms(mcfg)))
    attn = 0 if mcfg.family == "ssm" else mcfg.n_layers + mcfg.mtp
    want.update(rmsnorm=forwards * norms, flash_attention=forwards * attn)
    return want


def routing_spy():
    """Record (idx, keep) of every ``route`` and ``route_batched`` while it
    is installed; returns (records, uninstall)."""
    from repro_torch.models import moe
    orig = (moe.route, moe.route_batched)
    seen = {"single": [], "batched": []}

    def spy(kind, fn):
        def wrapped(*a, **k):
            r = fn(*a, **k)
            seen[kind].append((r["idx"], r["keep"]))
            return r
        return wrapped

    moe.route = spy("single", orig[0])
    moe.route_batched = spy("batched", orig[1])

    def undo():
        moe.route, moe.route_batched = orig
    return seen, undo


def cohort_vs_each(torch, model, buf, spec, batch):
    """The batched loss of the clients' weights (rows of ``buf``) against
    each client's own ``model.loss``, and the routing integers of the one
    against the other. Returns (rel, ulps, routing differences, routed
    assignments, dropped share)."""
    from repro_torch.utils.flatparams import unflatten
    m = buf.shape[0]
    seen, undo = routing_spy()
    try:
        got = model.loss_batched(unflatten(buf, spec), batch)
        each = torch.stack([model.loss(unflatten(buf[i], spec),
                                       {k: v[i] for k, v in batch.items()})
                            for i in range(m)])
    finally:
        undo()
    (idx_b, keep_b), = seen["batched"]
    check(len(seen["single"]) == m, f"{len(seen['single'])} routings")
    flips, routed, kept = 0, 0, 0
    for i, (idx, keep) in enumerate(seen["single"]):
        n = keep.numel()
        flips += int((idx_b[i] != idx).sum()) + int(
            (keep_b[i * n:(i + 1) * n] != keep).sum())
        routed += n
        kept += int(keep.sum())
    rel = float(((got - each).abs() / each.abs()).max())
    ulp = torch.nextafter(each, torch.full_like(each, math.inf)) - each
    return (rel, float(((got - each).abs() / ulp).max()), flips, routed,
            1.0 - kept / routed)


def run_moe_cohort_round(torch, ops, FedZOConfig, smi, total, rows):
    """Part (a): ``fedzo.round_simulated`` on qwen3-moe-30b-a3b at full
    width, depth cut to one layer, in float32 (M = 2, H = 2, b2 = 8, batch
    4 x 128 a client, mu 1e-3), plain mean and AirComp: exact launches
    (those of one client whatever M is), ms a round and peak memory; the
    mean round bitwise a second run of itself; the batched loss against
    each client's own, and the routing integers, at capacity factor E / k
    (nothing drops) and at the published 1.25."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import fedzo
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.kernels import flash_attention as plain_flash
    from repro_torch.kernels import rmsnorm as plain_rms
    from repro_torch.models import api
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten
    from repro_torch.utils.tree import tree_leaves, tree_size

    cfg = get_config("qwen3-moe-30b-a3b").replace(
        n_layers=COHORT_LAYERS, dtype="float32")
    m, h, b, s = COHORT_M, COHORT_H, COHORT_B, COHORT_S
    # the cohort's kernels at its shapes: the qk norms' rows under an [M,
    # 128] scale, the block norms' [M, B.S, 2,048] rows, one attention over
    # the M.B rows
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    notes, err = [], dict.fromkeys(("rmsnorm", "flash_attention"), 0.0)
    for x, sc in ((rnd(m, b * s * cfg.n_heads, cfg.head_dim),
                   1.0 + 0.1 * rnd(m, cfg.head_dim)),
                  (rnd(m, b * s, cfg.d_model), 1.0 + 0.1 * rnd(m, cfg.d_model))):
        _, e, note = hold_rmsnorm(torch, ops, plain_rms, x, sc)
        err["rmsnorm"] = max(err["rmsnorm"], e)
        notes.append(note + f" ({x.shape[0]} scales)")
    e, note = hold_attention(torch, ops, plain_flash,
                             rnd(m * b, s, cfg.n_heads, cfg.head_dim),
                             rnd(m * b, s, cfg.n_kv_heads, cfg.head_dim),
                             rnd(m * b, s, cfg.n_kv_heads, cfg.head_dim),
                             True, 0)
    err["flash_attention"] = max(err["flash_attention"], e)
    notes.append(note)
    for k, e in err.items():
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], e)
    print("moe cohort shapes against the plain versions: " + "; ".join(notes))

    model = api.build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(prng.key(0), device="cuda")
    n = tree_size(params)
    check(n == COHORT_PARAMS, f"qwen3-moe 1 layer: {n} parameters")
    spec = flat_spec(params)
    toks = lm_token_stream(200_000, min(cfg.vocab, 4096), seed=0)
    rng = np.random.default_rng(1)
    per = [lm_batch(torch, toks, rng, b, s, "cuda") for _ in range(m * h)]
    batches = {k: torch.stack([x[k] for x in per]).reshape((m, h, b, s))
               for k in ("tokens", "labels")}
    keys = prng.split(prng.key(1), m)
    base = dict(n_participating=m, local_iters=h, lr=1e-4, mu=1e-3,
                b2=COHORT_B2, estimator="sphere", flat_params=True)
    cfgs = {"mean": FedZOConfig(**base),
            "aircomp": FedZOConfig(**base, aircomp=True,
                                   channel_schedule=True, snr_db=5.0)}
    copy = 4 * spec.n_pad / 2**30
    print(f"moe cohort round: d {spec.d}, n_pad {spec.n_pad}; reckoned peak "
          f"{(2 + 4 * m) * copy:.1f} GiB ({2 + 4 * m} float32 copies of "
          f"{copy:.2f} GiB: the flat Qwen2-0.5B round holds 18 copies at M "
          f"= 4) [{smi}]")
    first = None
    for name in ("mean", "aircomp", "mean"):
        fcfg = cfgs[name]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = fedzo.round_simulated(model.loss, params, batches, keys,
                                         fcfg, channel_rng=prng.key(2))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(ops.LAUNCHES)
        want = cohort_launches(ops, cfg, fcfg)
        check(counts == want, f"moe cohort round {name}: launches {counts} "
              f"!= {want}")
        for k in total:
            total[k] += counts[k]
        mets = {k: float(v) for k, v in met.items()}
        check(all(map(math.isfinite, mets.values())),
              f"moe cohort round {name}: metrics {mets}")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
              f"moe cohort round {name}: parameters not finite")
        moved = max(float((a - c).abs().max()) for a, c in
                    zip(tree_leaves(new), tree_leaves(params)))
        check(moved > 0, f"moe cohort round {name}: no weight moved")
        again = ""
        if name == "mean" and first is None:
            first = new
        elif name == "mean":
            check(all(torch.equal(a, c) for a, c in
                      zip(tree_leaves(new), tree_leaves(first))),
                  "moe cohort round: a second run differs")
            again = "; bitwise the first mean round"
            first = None
        del new
        print(f"qwen3_moe_1l_flat_round {name} (float32, full width, "
              f"reduced: depth only, n_layers {COHORT_LAYERS} of 48; M {m}, "
              f"H {h}, b2 {fcfg.b2}, batch {b} x {s} a client): ms/round "
              f"{ms:.1f}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; metrics {json.dumps(mets)}; largest weight move "
              f"{moved:.3e}; launches {counts} (M-independent){again} "
              f"[{smi}]")
        torch.cuda.empty_cache()
    # each client's own weights: the server weights plus a per-client
    # offset, as rows of one [M, n_pad] buffer
    buf = flatten(params, spec)[None].repeat(m, 1)
    buf += 1e-3 * torch.randn(buf.shape, generator=g, device="cuda")
    b0 = {k: v[:, 0] for k, v in batches.items()}
    for factor in (cfg.n_experts / cfg.top_k, cfg.capacity_factor):
        mdl = api.build(cfg.replace(capacity_factor=factor))
        rel, ulps, flips, routed, dropped = cohort_vs_each(
            torch, mdl, buf, spec, b0)
        check(rel <= 1e-5, f"moe cohort loss vs each client at capacity "
              f"factor {factor}: rel {rel}")
        print(f"moe cohort loss vs each client's own at capacity factor "
              f"{factor}: rel {rel:.2e} ({ulps:.1f} ulps); routing integers "
              f"(idx, keep) differing: {flips} of {2 * routed}; dropped "
              f"{dropped:.4f} of {routed} routed assignments a client")
    del buf, params, first
    torch.cuda.empty_cache()


def smoke_rounds_card_vs_cpu(torch, ops, FedZOConfig, total,
                             archs=("qwen3-moe-30b-a3b-smoke",
                                    "deepseek-v3-671b-smoke"), lr=1e-3):
    """Phase 11 part (b) (the moe -smoke configs; phase 12 part (d) the ssm
    and hybrid ones; phase 13 part (c) the encdec and vlm ones, their
    frontend stubs' embeddings 0.1·normal, a vlm's gates at VISION_GATE):
    in float32, one flat round, one flat AirComp round and one wide round
    (batch_directions, block directions) of each of ``archs`` (M = 3, H =
    COHORT_SMOKE_H, b2 = 4, mu 1e-2, ``lr``), on the card against the same
    round on the CPU: the weights within COHORT_SMOKE_TOL while the round
    moves a weight by at least 10x that, the card's launches exact."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import fedzo
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.models import api
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten
    m, h = 3, COHORT_SMOKE_H
    base = dict(n_participating=m, local_iters=h, lr=lr, mu=1e-2, b2=4,
                flat_params=True)
    fcfgs = {"flat": FedZOConfig(**base),
             "aircomp": FedZOConfig(**base, aircomp=True,
                                    channel_schedule=True, snr_db=5.0),
             "wide": FedZOConfig(**base, batch_directions=True,
                                 direction_conv="block")}
    notes = []
    for arch in archs:
        model = api.build(get_config(arch))
        cfg = model.cfg
        init = model.init(prng.key(0), device="cpu")
        if cfg.family == "vlm":
            for g in ("gate_attn", "gate_mlp"):
                init["cross_blocks"][g].fill_(VISION_GATE)
        spec = flat_spec(init)
        toks = lm_token_stream(20_000, 512, seed=0)
        rng = np.random.default_rng(0)
        per = [lm_batch(torch, toks, rng, 2, 16, "cpu") for _ in range(m * h)]
        batches = {k: torch.stack([x[k] for x in per]).reshape((m, h, 2, 16))
                   for k in ("tokens", "labels")}
        frontend = {"encdec": "src_embeds",
                    "vlm": "vision_embeds"}.get(cfg.family)
        if frontend:
            batches[frontend] = torch.from_numpy((0.1 * rng.standard_normal(
                (m, h, 2, cfg.n_frontend_tokens, cfg.d_model))).astype(
                np.float32))
        for name, fcfg in fcfgs.items():
            out = {}
            for dev in ("cuda", "cpu"):
                params = unflatten(flatten(init, spec).to(dev), spec)
                ops.reset_launches()
                new, _ = fedzo.round_simulated(
                    model.loss, params,
                    {k: v.to(dev) for k, v in batches.items()},
                    prng.split(prng.key(1), m), fcfg,
                    channel_rng=prng.key(2))
                out[dev] = (flatten(new, spec).cpu(), dict(ops.LAUNCHES))
            want = cohort_launches(ops, cfg, fcfg)
            check(out["cuda"][1] == want, f"{arch} {name} round: launches "
                  f"{out['cuda'][1]} != {want}")
            for k in total:
                total[k] += out["cuda"][1][k]
            worst = float((out["cuda"][0] - out["cpu"][0]).abs().max())
            moved = float((out["cpu"][0] - flatten(init, spec)).abs().max())
            check(worst <= COHORT_SMOKE_TOL and moved >= 10 * COHORT_SMOKE_TOL,
                  f"{arch} {name} round card vs CPU {worst}, moved {moved}")
            notes.append(f"{arch} {name} {worst:.2e} (moved {moved:.3g})")
    print(f"smoke rounds (float32) on the card against the CPU, max "
          f"|param diff| (bound {COHORT_SMOKE_TOL}): " + "; ".join(notes))


def window_pairs(s, w):
    """(q, k) pairs a causal window of ``w`` keeps over ``s`` positions."""
    w = min(w, s)
    return w * (w + 1) // 2 + (s - w) * w


def time_window_attention(torch, ops, smi, rows):
    """flash_attention at hymba-1.5b's prefill shape (q [2, 2,048, 25, 64],
    k/v [2, 2,048, 5, 64], causal, window 1,024), both dtypes: the
    kernel, its plain version, SDPA with the boolean window mask and the
    bound of the pairs the window keeps; and the kernel without the window
    at the same shape (a kernel that skips the key tiles wholly outside
    the window runs the windowed call faster). Stored in the attention
    row's ``window`` entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as plain_flash
    g = torch.Generator(device="cuda").manual_seed(12)
    b, s, hq, hkv, d, w = HYMBA_B, HYMBA_S, 25, 5, 64, 1_024
    q = torch.randn(b, s, hq, d, generator=g, device="cuda")
    k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda")
            for _ in range(2))
    i = torch.arange(s, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < w)
    pairs = window_pairs(s, w)
    flops = 2 * (d + d) * pairs * b * hq         # q.k and p.v multiply-adds
    elems = b * s * (2 * hq * d + 2 * hkv * d)   # q, k, v read, out written
    out, lines = {}, []
    for dt, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
        ms = median_ms(torch, lambda: ops.attention(qd, kd, vd, window=w), 20)
        causal_ms = median_ms(torch, lambda: ops.attention(qd, kd, vd), 20)
        lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, enable_gqa=True), 20)
        plain_ms = median_ms(torch, lambda: plain_flash.flash_attention_plain(
            qd, kd, vd, window=w), 3)
        bd = bound(elems * (4 if dt == torch.float32 else 2), flops, kind)
        out[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                         causal_ms=causal_ms, **bd)
        lines.append(f"flash_attention window {w} {kind} [{b}, {s}, {hq}/"
                     f"{hkv}, {d}] (hymba-1.5b prefill): ms {ms:.5f}, "
                     f"without the window {causal_ms:.5f} ({ms / causal_ms:.3f}"
                     f"; the window keeps {pairs / (s * (s + 1) // 2):.3f} of "
                     f"the causal pairs), plain {plain_ms:.4f}, SDPA with the "
                     f"boolean mask {lib:.5f} ({ms / lib:.2f}x), bound "
                     f"{bd['bound_ms']:.5f} ({bd['bound_by']}, "
                     f"{bd['bound_ms'] / ms:.1%} of it) [{smi}]")
    rows["flash_attention"]["window"] = out
    for line in lines:
        print(line)


def time_rmsnorm_1600(torch, ops, smi, rows):
    """rmsnorm over hymba-1.5b's prefill rows [4,096, 1,600], both dtypes:
    the kernel, its plain version, ``F.rms_norm`` and the bound. Stored in
    the rmsnorm row's ``d1600`` entry."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as plain_rms
    g = torch.Generator(device="cuda").manual_seed(13)
    r, d = HYMBA_B * HYMBA_S, 1_600
    out, lines = {}, []
    for dt, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        x = torch.randn(r, d, generator=g, device="cuda").to(dt)
        sc = (1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
        ms = median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 50)
        lib = median_ms(torch, lambda: F.rms_norm(x, (d,), sc, eps=1e-6), 50)
        plain_ms = median_ms(torch, lambda: plain_rms.rmsnorm_plain(
            x, sc, eps=1e-6), 10)
        bd = bound((2 * r * d + d) * x.element_size(), 4 * r * d, "fp32")
        out[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, **bd)
        lines.append(f"rmsnorm {kind} [{r}, {d}] (hymba-1.5b prefill): ms "
                     f"{ms:.5f}, plain {plain_ms:.4f}, F.rms_norm {lib:.5f}, "
                     f"bound {bd['bound_ms']:.5f} ({bd['bound_by']}, "
                     f"{bd['bound_ms'] / ms:.1%} of it) [{smi}]")
    rows["rmsnorm"]["d1600"] = out
    for line in lines:
        print(line)


def serve_full(torch, ops, arch, b, s, gen, smi, total):
    """``launch/serve.py``'s ``main`` on ``arch`` at full width and depth
    in bfloat16, batch ``b`` x prompt ``s``, ``gen`` greedy steps: init
    seconds, peak memory from before the init, exact launches; a warm
    prefill and decode loop; one decode step against a prefill of S + 1
    tokens within SERVE_BF16_TOL. Returns (result, peak GiB, warm prefill
    s, warm decode s a step, rel, argmax agreement)."""
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(["--arch", arch, "--batch", str(b), "--prompt-len",
                      str(s), "--gen", str(gen)])
    cfg = res.model.cfg
    for got, want in ((res.prefill_launches, serve_launches(cfg, 1, 0)),
                      (res.decode_launches, serve_launches(cfg, 0, gen))):
        want = {**dict.fromkeys(ops.LAUNCHES, 0), **want}
        check(got == want, f"serve {arch}: launches {got} != {want}")
        for k in total:
            total[k] += got[k]
    pre_s, steps = serve_moe_loop(torch, ops, res.model, res.params,
                                  res.batch, cfg, total, s=s, gen=gen)
    rel, agree = decode_vs_prefill(torch, res.model, res.params, res.batch,
                                   SERVE_BF16_TOL)
    peak = torch.cuda.max_memory_allocated() / 2**30
    return res, peak, pre_s, sorted(steps[1:])[len(steps[1:]) // 2], rel, \
        agree


def serve_hymba(torch, ops, FedZOConfig, smi, total, rows):
    """Part (c): hymba-1.5b (arXiv:2411.13676) at full width and depth in
    bfloat16 through ``launch/serve.py`` (batch 2 x prompt 2,048, the
    window of 1,024 biting, 8 greedy steps), its kernels first held at its
    shapes; then the cross-silo train step at full width in float32: 2 flat
    steps (b2 8, batch 2 x 256), finite, exact launches, bitwise a second
    run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import fedzo
    from repro_torch.data.synthetic import lm_token_stream
    from repro_torch.models import api
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves, tree_size
    cfg = get_config("hymba-1.5b")
    hold_served_kernels(torch, ops, cfg, HYMBA_B, HYMBA_S, rows)
    res, peak, pre_s, step_s, rel, agree = serve_full(
        torch, ops, cfg.name, HYMBA_B, HYMBA_S, HYMBA_GEN, smi, total)
    n = tree_size(res.params)
    check(n == HYMBA_PARAMS, f"hymba-1.5b: {n} parameters")
    print(f"hymba_1_5b_serve (bfloat16, full width and depth, {n} "
          f"parameters): init {res.init_s:.2f} s; peak {peak:.3f} GiB from "
          f"before the init; CLI prefill batch {HYMBA_B} x {HYMBA_S} "
          f"{1e3 * res.prefill_s:.2f} ms, decode "
          f"{1e3 * res.decode_s / HYMBA_GEN:.2f} ms a step; warm prefill "
          f"{1e3 * pre_s:.2f} ms ({HYMBA_B * HYMBA_S / pre_s:.1f} tok/s), "
          f"decode {1e3 * step_s:.3f} ms a step (median after the first, "
          f"{HYMBA_B / step_s:.1f} tok/s); decode vs prefill rel {rel:.3e} "
          f"(bound {SERVE_BF16_TOL}), argmax agree {agree:.2f}; launches "
          f"prefill {res.prefill_launches['rmsnorm']} rmsnorm "
          f"{res.prefill_launches['flash_attention']} attention, decode "
          f"{res.decode_launches['rmsnorm']} rmsnorm "
          f"{res.decode_launches['flash_attention']} attention [{smi}]")
    del res
    torch.cuda.empty_cache()

    model = api.build(cfg.replace(dtype="float32"))
    torch.cuda.reset_peak_memory_stats()
    params = model.init(prng.key(0), device="cuda")
    toks = lm_token_stream(200_000, min(cfg.vocab, 4096), seed=0)
    rng = np.random.default_rng(0)
    batches = [lm_batch(torch, toks, rng, HYMBA_STEP_B, HYMBA_STEP_S, "cuda")
               for _ in range(HYMBA_STEPS)]
    fcfg = FedZOConfig(lr=1e-4, mu=1e-3, b2=COHORT_B2, flat_params=True)
    step = fedzo.make_train_step(model.loss, fcfg)
    per = serve_launches(cfg, 1, 0)
    want = {**dict.fromkeys(ops.LAUNCHES, 0), "zo_walk": fcfg.b2,
            "zo_replay": 1, "zo_dirnorms": 1,
            "rmsnorm": (fcfg.b2 + 1) * per["rmsnorm"],
            "flash_attention": (fcfg.b2 + 1) * per["flash_attention"]}
    runs = []
    for run in range(2):
        p, losses, ms = params, [], []
        for i, batch in enumerate(batches):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, met = step(p, batch, prng.key(10 + i))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            counts = dict(ops.LAUNCHES)
            check(counts == want, f"hymba step: launches {counts} != {want}")
            if run == 0:
                for k in total:
                    total[k] += counts[k]
            losses.append(float(met["loss"]))
        check(all(map(math.isfinite, losses)) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(p)),
            f"hymba step: losses {losses}")
        runs.append((p, losses, ms))
    check(all(torch.equal(a, c) for a, c in zip(tree_leaves(runs[0][0]),
                                                tree_leaves(runs[1][0]))),
          "hymba step: a second run differs")
    moved = max(float((a - c).abs().max()) for a, c in
                zip(tree_leaves(runs[0][0]), tree_leaves(params)))
    print(f"hymba_1_5b_train (float32, full width and depth, flat route, b2 "
          f"{fcfg.b2}, batch {HYMBA_STEP_B} x {HYMBA_STEP_S}): ms a step "
          f"{[round(t, 1) for t in runs[0][2] + runs[1][2]]}; losses "
          f"{runs[0][1]}; largest weight move {moved:.3e}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bitwise a "
          f"second run; launches a step {want} [{smi}]")
    del params, runs, p
    torch.cuda.empty_cache()


def serve_rwkv(torch, ops, smi, total):
    """Part (d): rwkv6-7b (arXiv:2404.05892) at full width and depth in
    bfloat16 through ``launch/serve.py`` (batch 2 x prompt 512, 8 greedy
    steps): init seconds, peak, prefill and decode times; no kernel
    launches (layernorms, no attention: its counts are all 0); decode
    against prefill; a cache whose size does not depend on its width."""
    from repro_torch.utils.tree import tree_leaves, tree_size
    res, peak, pre_s, step_s, rel, agree = serve_full(
        torch, ops, "rwkv6-7b", RWKV_B, RWKV_S, RWKV_GEN, smi, total)
    n = tree_size(res.params)
    check(n == RWKV_PARAMS, f"rwkv6-7b: {n} parameters")
    zero = dict.fromkeys(ops.LAUNCHES, 0)
    check(res.prefill_launches == zero and res.decode_launches == zero,
          f"rwkv6-7b launched {res.prefill_launches} {res.decode_launches}")
    sizes = [sum(t.numel() for t in tree_leaves(res.model.init_cache(
        RWKV_B, w, device="cuda"))) for w in (16, RWKV_S + RWKV_GEN)]
    check(sizes[0] == sizes[1], f"rwkv6-7b cache sizes {sizes}")
    print(f"rwkv6_7b_serve (bfloat16, full width and depth, {n} parameters):"
          f" init {res.init_s:.2f} s; peak {peak:.3f} GiB from before the "
          f"init; CLI prefill batch {RWKV_B} x {RWKV_S} "
          f"{1e3 * res.prefill_s:.2f} ms, decode "
          f"{1e3 * res.decode_s / RWKV_GEN:.2f} ms a step; warm prefill "
          f"{1e3 * pre_s:.2f} ms ({RWKV_B * RWKV_S / pre_s:.1f} tok/s), "
          f"decode {1e3 * step_s:.3f} ms a step (median after the first, "
          f"{RWKV_B / step_s:.1f} tok/s); decode vs prefill rel {rel:.3e} "
          f"(bound {SERVE_BF16_TOL}), argmax agree {agree:.2f}; cache "
          f"{sizes[0]} elements at widths 16 and {RWKV_S + RWKV_GEN}; no "
          f"kernel launched (counts all 0: layernorm and the WKV are plain "
          f"torch, as the reference's jnp) [{smi}]")
    del res
    torch.cuda.empty_cache()


def family_smoke_card_vs_cpu(torch, ops, FedZOConfig, total,
                             archs=("rwkv6-7b-smoke", "hymba-1.5b-smoke")):
    """Phase 11 part (e) (rwkv6-7b-smoke, hymba-1.5b-smoke; phase 12 part
    (c) the encdec and vlm ones): in float32 on the card against the same
    port on the CPU from the same weights (``smoke_runs``): prefill and 4
    decode steps on the CPU's greedy tokens (logits and every cache leaf),
    the loss, one pytree FedZO train step (b2 2, mu 1e-2) with exact
    launches. A vlm's gates are set to VISION_GATE first: at zero the
    cross layers add nothing."""
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import _leaves
    notes = []
    for arch in archs:
        model = api.build(get_config(arch))
        cfg = model.cfg
        init = model.init(prng.key(0), device="cpu")
        if cfg.family == "vlm":
            for g in ("gate_attn", "gate_mlp"):
                init["cross_blocks"][g].fill_(VISION_GATE)
        fcfg = FedZOConfig(lr=1e-3, mu=1e-2, b2=2)
        out = smoke_runs(torch, ops, model, init, fcfg, SSM_SMOKE_GEN,
                         lambda p, tb: [float(model.loss(p, tb))])
        cpu, card = out["cpu"], out["cuda"]
        worst = 0.0
        for g, w in zip(card[0] + card[1], cpu[0] + cpu[1]):
            worst = max(worst, float((g - w).abs().max() / w.abs().max()))
        check(worst <= SMOKE_CARD_REL, f"{arch}: serve card vs CPU {worst}")
        lrel = abs(card[2][0] - cpu[2][0]) / abs(cpu[2][0])
        check(lrel <= SMOKE_CARD_REL, f"{arch}: loss {card[2]} {cpu[2]}")
        moved = max(float((a - c).abs().max()) for a, c in
                    zip(cpu[3], (t for _, t in _leaves(init))))
        diff = max(float((a - c).abs().max()) for a, c in
                   zip(card[3], cpu[3]))
        check(diff <= MOE_STEP_TOL and moved >= SSM_STEP_MOVE,
              f"{arch}: step card vs CPU {diff}, moved {moved}")
        want = {**dict.fromkeys(ops.LAUNCHES, 0),
                **serve_launches(cfg, 1, SSM_SMOKE_GEN)}
        check(card[4] == want, f"{arch}: serve launches {card[4]} != {want}")
        per = serve_launches(cfg, 1, 0)
        want = {**dict.fromkeys(ops.LAUNCHES, 0),
                "rmsnorm": (fcfg.b2 + 1) * per["rmsnorm"],
                "flash_attention": (fcfg.b2 + 1) * per["flash_attention"],
                "zo_axpy": 2 * fcfg.b2 * len(_leaves(init))}
        check(card[6] == cpu[6] == fcfg.b2 + 1 and card[5] == want,
              f"{arch}: step launches {card[5]} != {want} ({card[6]} "
              f"forwards)")
        for counts in (card[4], card[5]):
            for k in total:
                total[k] += counts[k]
        notes.append(f"{arch}: serve card vs CPU {worst:.3e}, loss "
                     f"{lrel:.3e} (bound {SMOKE_CARD_REL}); step {diff:.3e} "
                     f"(bound {MOE_STEP_TOL}) against a move of {moved:.4g}")
    print("smoke configs (float32) on the card against the CPU: "
          + "; ".join(notes))


def run_cohort_ssm(torch, ops, FedZOConfig, smi, rows):
    """Phase "moe cohort, ssm and hybrid": parts (a) to (e) and the
    windowed attention and 1,600-wide RMSNorm timings, each part's seconds
    and peak memory printed; budget COHORT_BUDGET_S. Returns the launches
    of its main-path runs."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    for name, part in (
            ("(a) moe flat round", lambda: run_moe_cohort_round(
                torch, ops, FedZOConfig, smi, total, rows)),
            ("(b) moe smoke rounds card vs CPU",
             lambda: smoke_rounds_card_vs_cpu(torch, ops, FedZOConfig,
                                              total)),
            ("(c) hymba-1.5b", lambda: serve_hymba(
                torch, ops, FedZOConfig, smi, total, rows)),
            ("(d) rwkv6-7b", lambda: serve_rwkv(torch, ops, smi, total)),
            ("(e) ssm smoke configs card vs CPU",
             lambda: family_smoke_card_vs_cpu(torch, ops, FedZOConfig,
                                              total)),
            ("windowed attention and rmsnorm timing", lambda: (
                time_window_attention(torch, ops, smi, rows),
                time_rmsnorm_1600(torch, ops, smi, rows)))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        part()
        print(f"part {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"moe cohort, ssm and hybrid: {took:.1f} s of the "
          f"{COHORT_BUDGET_S:.0f} s budget [{smi}]")
    return total


# ---------------------------------------------------------------------------
# phase "encdec, vlm and the ssm cohort": seamless-m4t-large-v2 and
# llama-3.2-vision-90b served (cross-attention on the flash kernel), the
# flat round on hymba-1.5b and rwkv6-7b through the ssm and hybrid cohort
# loss, the -smoke configs on the card against the CPU, the kernels timed
# at the new shapes

XATTN_BUDGET_S = 150.0
# seamless-m4t-large-v2 (arXiv:2308.11596) at full width and depth in
# bfloat16 through launch/serve.py: batch 2 x prompt 128 over 4,096 source
# frames, 8 greedy steps. Its cross cache: 24 layers x k and v x [2, 4,096,
# 16, 64] bfloat16 = 0.75 GiB, written once at prefill.
SEAMLESS_B, SEAMLESS_S, SEAMLESS_GEN = 2, 128, 8
SEAMLESS_PARAMS = 1_632_295_936
# then its cross-silo train step in float32 (6.08 GiB a copy), flat route,
# b2 8, batch 2 x 128 of the synthetic stream and the launcher's 4,096
# frames of 0.1.normal, 2 steps, twice
SEAMLESS_STEPS = 2
# llama-3.2-vision-90b at full width, reduced in depth only: 10 of 100
# layers (2 groups of 4 self layers and one gated cross layer),
# 10,892,780,036 parameters, 20.29 GiB of bfloat16 (the full depth's
# 167.67 GiB does not fit one card); batch 2 x prompt 128 over 1,600 patch
# embeddings, 8 greedy steps. The gates are set to VISION_GATE after the
# init: the reference's zero gates give tanh(0) = 0, and the cross layers
# would add nothing to the logits.
VISION_LAYERS, VISION_PARAMS = 10, 10_892_780_036
VISION_B, VISION_S, VISION_GEN = 2, 128, 8
VISION_GATE = 0.5
# the flat round through the ssm and hybrid cohort loss, float32: M 2, H
# 2, b2 8, batch 2 x 256 a client, mu 1e-3. hymba-1.5b at full width and
# depth (5.19 GiB a copy); rwkv6-7b at full width, reduced in depth only to
# 2 of 32 layers (974,258,176 parameters, 3.63 GiB a copy). A round holds
# about 2 + 4M copies (phase 11's moe round: 46-51 GiB for 10 copies of
# 4.64 GiB), one more with AirComp: hymba's 52 GiB, rwkv6's 36 GiB.
SSM_ROUND_M, SSM_ROUND_H, SSM_ROUND_B2 = 2, 2, 8
SSM_ROUND_B, SSM_ROUND_S = 2, 256
RWKV_ROUND_LAYERS, RWKV_ROUND_PARAMS = 2, 974_258_176
# The ssm and hybrid -smoke rounds on the card against the CPU run
# ``smoke_rounds_card_vs_cpu`` at COHORT_SMOKE_H = 1 and COHORT_SMOKE_TOL.
# These families route nothing, so the chaos that COHORT_SMOKE_H argues
# for the moe rounds does not arise (the port against the reference on the
# CPU, tests/test_torch_ssm_cohort.py: one H = 2 round within 4.3e-4); one
# iterate keeps the CPU half of the check (the plain kernels' Threefry
# draws) within the phase's budget, and a loss ulp moves a weight by about
# 1e-4 an iterate, so 1e-3 is about ten of them.
# The new shapes: the cross norms' rows (a head dim wide on the q and k
# side) and the flash kernel non-causal over Sk != Sq and at one query.
XATTN_TIMED = (
    # name, q [B, Sq, Hq, D], kv [Sk, Hkv]
    ("encoder", (2, 4096, 16, 64), (4096, 16)),
    ("seamless_cross", (2, 128, 16, 64), (4096, 16)),
    ("vision_cross", (2, 128, 64, 128), (1600, 64)),
    ("seamless_decode", (2, 1, 16, 64), (4096, 16)),
    ("vision_decode", (2, 1, 64, 128), (1600, 64)),
)
XATTN_NORM_ROWS = (("seamless_q", 2 * 128 * 16, 64),
                   ("seamless_k", 2 * 4096 * 16, 64),
                   ("vision_q", 2 * 128 * 64, 128),
                   ("vision_k", 2 * 1600 * 64, 128))


def hold_xattn_kernels(torch, ops, cfg, b, s, rows):
    """An encdec or vlm model's kernels at the shapes its prefill and
    decode give them, against their plain versions under phase 2's
    tolerances, in float32 and bfloat16: rmsnorm over the cross q and k
    norms' rows (``[b.s.Hq, hd]``, ``[b.n_frontend.Hq, hd]``, decode's
    ``[b.Hq, hd]``) and, under rmsnorm, the block norms' ``[b.s, d]`` and
    ``[b, d]``; attention causal at ``[b, s, Hq/Hkv, hd]``, non-causal
    over the memory at ``[b, s, Hq/Hq, hd]`` and at one query, the
    encoder's non-causal ``[b, n_frontend, Hq/Hkv, hd]``, and a ragged
    non-causal call (5 queries over 1,000 keys). The largest errors join
    the kernels' ``max_abs_err``. Not counted: run before the served
    path's counts are set to 0."""
    from repro_torch.kernels import flash_attention as plain_flash
    from repro_torch.kernels import rmsnorm as plain_rms
    g = torch.Generator(device="cuda").manual_seed(21)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    hq, hkv, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    sm = cfg.n_frontend_tokens
    widths = [(b * s * hq, hd), (b * sm * hq, hd), (b * hq, hd)]
    if cfg.norm == "rmsnorm":
        widths += [(b * s, d), (b, d)]
    # (q rows, q heads, k rows, kv heads, causal): the causal self call
    # under phase 2's rule, the long non-causal ones (over the memory, at one
    # query, ragged, the encoder's) under ``hold_attention_long``'s
    calls = [(s, hq, s, hkv, True), (s, hq, sm, hq, False),
             (1, hq, sm, hq, False), (5, hq, 1000, hq, False)]
    if cfg.family == "encdec":
        calls.append((sm, hq, sm, hkv, False))
    notes, err = [], dict.fromkeys(("rmsnorm", "flash_attention"), 0.0)
    for dt in (torch.float32, torch.bfloat16):
        for r, w in widths:
            _, e, note = hold_rmsnorm(torch, ops, plain_rms, rnd(
                r, w, dtype=dt), (1.0 + 0.1 * rnd(w)).to(dt))
            err["rmsnorm"] = max(err["rmsnorm"], e)
            notes.append(note)
        for sq, qh, sk, kh, causal in calls:
            hold = hold_attention if causal else hold_attention_long
            e, note = hold(torch, ops, plain_flash,
                           rnd(b, sq, qh, hd, dtype=dt),
                           rnd(b, sk, kh, hd, dtype=dt),
                           rnd(b, sk, kh, hd, dtype=dt), causal, 0)
            err["flash_attention"] = max(err["flash_attention"], e)
            notes.append(note)
    for k, e in err.items():
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"], e)
    print(f"{cfg.name} served shapes against the plain versions: "
          + "; ".join(notes))


def flat_steps_twice(torch, ops, model, params, batches, fcfg, total, tag):
    """The cross-silo flat train step (``fedzo.make_train_step``) over
    ``batches``, twice from ``params``: exact launches every step (b2
    zo_walk, one zo_replay and one zo_dirnorms; b2 + 1 forwards of the
    model's prefill launches), finite, the second run bitwise the first.
    Returns (ms a step of both runs, the losses, the largest weight
    move)."""
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_leaves
    step = fedzo.make_train_step(model.loss, fcfg)
    per = serve_launches(model.cfg, 1, 0)
    want = {**dict.fromkeys(ops.LAUNCHES, 0), "zo_walk": fcfg.b2,
            "zo_replay": 1, "zo_dirnorms": 1,
            **{k: (fcfg.b2 + 1) * n for k, n in per.items()}}
    runs = []
    for run in range(2):
        p, losses, ms = params, [], []
        for i, batch in enumerate(batches):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, met = step(p, batch, prng.key(10 + i))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            counts = dict(ops.LAUNCHES)
            check(counts == want, f"{tag}: launches {counts} != {want}")
            if run == 0:
                for k in total:
                    total[k] += counts[k]
            losses.append(float(met["loss"]))
        check(all(map(math.isfinite, losses)) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(p)),
            f"{tag}: losses {losses}")
        runs.append((p, losses, ms))
    check(all(torch.equal(a, c) for a, c in zip(tree_leaves(runs[0][0]),
                                                tree_leaves(runs[1][0]))),
          f"{tag}: a second run differs")
    moved = max(float((a - c).abs().max()) for a, c in
                zip(tree_leaves(runs[0][0]), tree_leaves(params)))
    return runs[0][2] + runs[1][2], runs[0][1], moved


def serve_seamless(torch, ops, FedZOConfig, smi, total, rows):
    """Part (a): seamless-m4t-large-v2 (arXiv:2308.11596) at full width and
    depth in bfloat16 through ``launch/serve.py`` (batch 2 x prompt 128
    over 4,096 source frames, 8 greedy steps), its kernels first held at
    its shapes: init seconds, peak from before the init, exact launches,
    a warm loop, decode against prefill within SERVE_BF16_TOL; then its
    cross-silo train step at full width and depth in float32: 2 flat steps
    (b2 8), finite, exact launches, bitwise a second run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.train import frontend_inputs
    from repro_torch.utils import prng
    from repro_torch.utils.tree import tree_bytes, tree_size
    cfg = get_config("seamless-m4t-large-v2")
    hold_xattn_kernels(torch, ops, cfg, SEAMLESS_B, SEAMLESS_S, rows)
    res, peak, pre_s, step_s, rel, agree = serve_full(
        torch, ops, cfg.name, SEAMLESS_B, SEAMLESS_S, SEAMLESS_GEN, smi,
        total)
    n = tree_size(res.params)
    check(n == SEAMLESS_PARAMS, f"seamless-m4t-large-v2: {n} parameters")
    cache = res.model.init_cache(SEAMLESS_B, SEAMLESS_S + SEAMLESS_GEN,
                                 device="meta")
    cross = tree_bytes({k: cache[k] for k in ("cross_k", "cross_v")})
    print(f"seamless_m4t_large_v2_serve (bfloat16, full width and depth, "
          f"{n} parameters): init {res.init_s:.2f} s; peak {peak:.3f} GiB "
          f"from before the init (cross cache {cross / 2**30:.3f} GiB); CLI "
          f"prefill batch {SEAMLESS_B} x {SEAMLESS_S} over "
          f"{cfg.n_frontend_tokens} frames {1e3 * res.prefill_s:.2f} ms, "
          f"decode {1e3 * res.decode_s / SEAMLESS_GEN:.2f} ms a step; warm "
          f"prefill {1e3 * pre_s:.2f} ms "
          f"({SEAMLESS_B * SEAMLESS_S / pre_s:.1f} tok/s), decode "
          f"{1e3 * step_s:.3f} ms a step (median after the first, "
          f"{SEAMLESS_B / step_s:.1f} tok/s); decode vs prefill rel "
          f"{rel:.3e} (bound {SERVE_BF16_TOL}), argmax agree {agree:.2f}; "
          f"launches prefill {res.prefill_launches['rmsnorm']} rmsnorm "
          f"{res.prefill_launches['flash_attention']} attention, a decode "
          f"step {res.decode_launches['rmsnorm'] // SEAMLESS_GEN} rmsnorm "
          f"{res.decode_launches['flash_attention'] // SEAMLESS_GEN} "
          f"attention [{smi}]")
    del res
    torch.cuda.empty_cache()

    model, toks = lm_setup(cfg.name, "float32")
    torch.cuda.reset_peak_memory_stats()
    params = model.init(prng.key(0), device="cuda")
    rng = np.random.default_rng(0)
    key = prng.key(1)
    batches = [{**lm_batch(torch, toks, rng, SEAMLESS_B, SEAMLESS_S, "cuda"),
                **frontend_inputs(model.cfg, SEAMLESS_B, key, i,
                                  torch.device("cuda"))}
               for i in range(SEAMLESS_STEPS)]
    fcfg = FedZOConfig(lr=1e-4, mu=1e-3, b2=SSM_ROUND_B2, flat_params=True)
    ms, losses, moved = flat_steps_twice(torch, ops, model, params, batches,
                                         fcfg, total, "seamless step")
    print(f"seamless_m4t_large_v2_train (float32, full width and depth, "
          f"flat route, b2 {fcfg.b2}, batch {SEAMLESS_B} x {SEAMLESS_S} and "
          f"{cfg.n_frontend_tokens} frames): ms a step "
          f"{[round(t, 1) for t in ms]}; losses {losses}; largest weight "
          f"move {moved:.3e}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; bitwise a "
          f"second run; launches a step {serve_launches(model.cfg, 1, 0)} x "
          f"{fcfg.b2 + 1} forwards [{smi}]")
    del params, batches
    torch.cuda.empty_cache()


def serve_vision(torch, ops, smi, total, rows):
    """Part (b): llama-3.2-vision-90b at full width, depth cut to
    VISION_LAYERS, in bfloat16: the 100-layer count on ``meta``, init, the
    gates set to VISION_GATE (the logits then differ from the zero gates'),
    prefill 2 x 128 over 1,600 patch embeddings and 8 decode steps with
    exact launches, decode against prefill within SERVE_BF16_TOL."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api, vlm
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec
    from repro_torch.utils.tree import tree_size
    full = get_config("llama-3.2-vision-90b")
    n_full = flat_spec(vlm.init_params(prng.key(0), full, device="meta")).d
    cfg = full.replace(n_layers=VISION_LAYERS)
    hold_xattn_kernels(torch, ops, cfg, VISION_B, VISION_S, rows)
    model = api.build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = tree_size(params)
    check(n == VISION_PARAMS, f"llama-3.2-vision-90b 10L: {n} parameters")
    batch = api.make_batch(model, ShapeConfig(
        "serve", VISION_S, VISION_B, "prefill"), prng.key(1), device="cuda")
    shut, _ = model.prefill(params, batch, VISION_S)
    for g in ("gate_attn", "gate_mlp"):
        params["cross_blocks"][g].fill_(VISION_GATE)
    opened, _ = model.prefill(params, batch, VISION_S)
    moved = float((opened.float() - shut.float()).abs().max())
    check(moved > 0, "llama-3.2-vision-90b: the gates do not reach the "
          "logits")
    pre_s, steps = serve_moe_loop(torch, ops, model, params, batch, cfg,
                                  total, s=VISION_S, gen=VISION_GEN)
    rel, agree = decode_vs_prefill(torch, model, params, batch,
                                   SERVE_BF16_TOL)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = 1e3 * sorted(steps[1:])[len(steps[1:]) // 2]
    per_pre, per_dec = serve_launches(cfg, 1, 0), serve_launches(cfg, 0, 1)
    print(f"llama_3_2_vision_90b_10l_serve (bfloat16, full width, reduced: "
          f"depth only, n_layers {VISION_LAYERS} of {full.n_layers}; {n} "
          f"parameters, {n_full} at full depth on meta): init {init_s:.2f} "
          f"s; gates set to {VISION_GATE} after the init (the zero gates' "
          f"logits differ by up to {moved:.3g}); prefill batch {VISION_B} x "
          f"{VISION_S} over {cfg.n_frontend_tokens} patches "
          f"{1e3 * pre_s:.2f} ms ({VISION_B * VISION_S / pre_s:.1f} tok/s); "
          f"decode ms a step {[round(1e3 * t, 3) for t in steps]} "
          f"({step_ms:.3f} median after the first); peak {peak:.3f} GiB from "
          f"before the init; decode vs prefill rel {rel:.3e} (bound "
          f"{SERVE_BF16_TOL}), argmax agree {agree:.2f}; launches prefill "
          f"{per_pre}, a decode step {per_dec} [{smi}]")
    del params
    torch.cuda.empty_cache()


def hold_cohort_kernels(torch, ops, cfg, m, b, s, rows):
    """A hybrid cohort's kernels at its shapes against their plain versions
    in float32: rmsnorm over the ``[M, B.S, d]`` rows with an ``[M, d]``
    scale, attention over the ``[M.B, S, Hq/Hkv, hd]`` rows under the
    window. Returns the printed notes."""
    from repro_torch.kernels import flash_attention as plain_flash
    from repro_torch.kernels import rmsnorm as plain_rms
    g = torch.Generator(device="cuda").manual_seed(22)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    _, e_rms, note = hold_rmsnorm(torch, ops, plain_rms,
                                  rnd(m, b * s, cfg.d_model),
                                  1.0 + 0.1 * rnd(m, cfg.d_model))
    e_att, note2 = hold_attention(
        torch, ops, plain_flash, rnd(m * b, s, cfg.n_heads, cfg.head_dim),
        rnd(m * b, s, cfg.n_kv_heads, cfg.head_dim),
        rnd(m * b, s, cfg.n_kv_heads, cfg.head_dim), True,
        cfg.sliding_window)
    rows["rmsnorm"]["max_abs_err"] = max(rows["rmsnorm"]["max_abs_err"],
                                         e_rms)
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], e_att)
    return [note + f" ({m} scales)", note2]


def run_ssm_cohort_round(torch, ops, FedZOConfig, smi, total, rows, arch,
                         layers=0):
    """Part (d): ``fedzo.round_simulated`` on ``arch`` at full width (depth
    cut to ``layers`` if given) in float32 (M 2, H 2, b2 8, batch 2 x 256 a
    client, mu 1e-3), plain mean and AirComp, through the ssm and hybrid
    cohort loss: the reckoned peak first; exact launches (those of one
    client whatever M is), ms a round and peak; the mean round bitwise a
    second run; the batched loss against each client's own."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten
    from repro_torch.utils.tree import tree_leaves, tree_size
    model, toks = lm_setup(arch, "float32",
                           **({"n_layers": layers} if layers else {}))
    cfg = model.cfg
    m, h, b, s = SSM_ROUND_M, SSM_ROUND_H, SSM_ROUND_B, SSM_ROUND_S
    if cfg.family == "hybrid":
        print(f"{arch} cohort shapes against the plain versions: "
              + "; ".join(hold_cohort_kernels(torch, ops, cfg, m, b, s,
                                              rows)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(prng.key(0), device="cuda")
    n = tree_size(params)
    spec = flat_spec(params)
    copy = 4 * spec.n_pad / 2**30
    print(f"{arch} cohort round: {n} parameters, n_pad {spec.n_pad}; "
          f"reckoned peak {(2 + 4 * m) * copy:.1f} GiB ({2 + 4 * m} float32 "
          f"copies of {copy:.2f} GiB; one more with AirComp) [{smi}]")
    rng = np.random.default_rng(1)
    per = [lm_batch(torch, toks, rng, b, s, "cuda") for _ in range(m * h)]
    batches = {k: torch.stack([x[k] for x in per]).reshape((m, h, b, s))
               for k in ("tokens", "labels")}
    keys = prng.split(prng.key(1), m)
    base = dict(n_participating=m, local_iters=h, lr=1e-4, mu=1e-3,
                b2=SSM_ROUND_B2, estimator="sphere", flat_params=True)
    cfgs = {"mean": FedZOConfig(**base),
            "aircomp": FedZOConfig(**base, aircomp=True,
                                   channel_schedule=True, snr_db=5.0)}
    first, lines = None, []
    for name in ("mean", "aircomp", "mean"):
        fcfg = cfgs[name]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = fedzo.round_simulated(model.loss, params, batches, keys,
                                         fcfg, channel_rng=prng.key(2))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(ops.LAUNCHES)
        want = cohort_launches(ops, cfg, fcfg)
        check(counts == want, f"{arch} round {name}: launches {counts} != "
              f"{want}")
        for k in total:
            total[k] += counts[k]
        mets = {k: float(v) for k, v in met.items()}
        check(all(map(math.isfinite, mets.values())) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
            f"{arch} round {name}: metrics {mets}")
        moved = max(float((a - c).abs().max()) for a, c in
                    zip(tree_leaves(new), tree_leaves(params)))
        check(moved > 0, f"{arch} round {name}: no weight moved")
        again = ""
        if name == "mean" and first is None:
            first = new
        elif name == "mean":
            check(all(torch.equal(a, c) for a, c in
                      zip(tree_leaves(new), tree_leaves(first))),
                  f"{arch} round: a second run differs")
            again = "; bitwise the first mean round"
            first = None
        del new
        lines.append(f"{name}: ms/round {ms:.1f}; peak "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                     f"metrics {json.dumps(mets)}; largest weight move "
                     f"{moved:.3e}; launches {counts}{again}")
        torch.cuda.empty_cache()
    # each client's own weights: the server weights plus a per-client
    # offset, as rows of one [M, n_pad] buffer
    g = torch.Generator(device="cuda").manual_seed(23)
    buf = flatten(params, spec)[None].repeat(m, 1)
    buf += 1e-3 * torch.randn(buf.shape, generator=g, device="cuda")
    b0 = {k: v[:, 0] for k, v in batches.items()}
    got = model.loss_batched(unflatten(buf, spec), b0)
    each = torch.stack([model.loss(unflatten(buf[i], spec),
                                   {k: v[i] for k, v in b0.items()})
                        for i in range(m)])
    rel = float(((got - each).abs() / each.abs()).max())
    ulp = torch.nextafter(each, torch.full_like(each, math.inf)) - each
    ulps = float(((got - each).abs() / ulp).max())
    check(rel <= 1e-5, f"{arch} cohort loss vs each client: rel {rel}")
    tag = "full width and depth" if not layers else (
        f"full width, reduced: depth only, n_layers {layers} of "
        f"{get_config(arch).n_layers}")
    print(f"{arch.replace('-', '_').replace('.', '_')}_flat_round (float32, "
          f"{tag}; M {m}, H {h}, b2 {SSM_ROUND_B2}, batch {b} x {s} a "
          f"client): " + " | ".join(lines) + f"; the cohort loss vs each "
          f"client's own rel {rel:.2e} ({ulps:.1f} ulps) [{smi}]")
    del buf, params, first
    torch.cuda.empty_cache()


def time_xattn_kernels(torch, ops, smi, rows):
    """Part (e): flash_attention at the new shapes (XATTN_TIMED: the
    encoder's non-causal [2, 4,096, 16, 64], the two cross shapes at
    prefill, one query over 4,096 and 1,600 keys), both dtypes: the
    kernel, its plain version, SDPA without a mask and the bound; rmsnorm
    over the cross norms' rows (XATTN_NORM_ROWS) against ``F.rms_norm``.
    Stored in the attention and rmsnorm rows' ``xattn`` entries."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as plain_flash
    from repro_torch.kernels import rmsnorm as plain_rms
    g = torch.Generator(device="cuda").manual_seed(24)
    att, lines = {}, []
    for name, (b, sq, hq, d), (sk, hkv) in XATTN_TIMED:
        q = torch.randn(b, sq, hq, d, generator=g, device="cuda")
        k, v = (torch.randn(b, sk, hkv, d, generator=g, device="cuda")
                for _ in range(2))
        flops = 4 * b * hq * sq * sk * d      # q.k and p.v multiply-adds
        elems = b * (2 * sq * hq * d + 2 * sk * hkv * d)
        att[name] = {}
        for dt, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            reps = 200 if sq == 1 else 20
            ms = median_ms(torch, lambda: ops.attention(qd, kd, vd,
                                                        causal=False), reps)
            lib = median_ms(torch, lambda: F.scaled_dot_product_attention(
                qd.transpose(1, 2), kd.transpose(1, 2), vd.transpose(1, 2)),
                reps)
            plain_ms = median_ms(torch, lambda: plain_flash
                                 .flash_attention_plain(qd, kd, vd,
                                                        causal=False), 3)
            bd = bound(elems * qd.element_size(), flops, kind)
            att[name][kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                                   **bd)
            lines.append(f"flash_attention {name} {kind} q [{b}, {sq}, {hq}, "
                         f"{d}] over k/v [{b}, {sk}, {hkv}, {d}] non-causal: "
                         f"ms {ms:.5f}, plain {plain_ms:.4f}, SDPA {lib:.5f} "
                         f"({ms / lib:.2f}x), bound {bd['bound_ms']:.5f} "
                         f"({bd['bound_by']}, {bd['bound_ms'] / ms:.1%} of "
                         f"it) [{smi}]")
    norms = {}
    for name, r, d in XATTN_NORM_ROWS:
        norms[name] = {}
        for dt, kind in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            x = torch.randn(r, d, generator=g, device="cuda").to(dt)
            sc = (1.0 + 0.1 * torch.randn(d, generator=g, device="cuda")) \
                .to(dt)
            ms = median_ms(torch, lambda: ops.rmsnorm(x, sc, eps=1e-6), 50)
            lib = median_ms(torch, lambda: F.rms_norm(x, (d,), sc, eps=1e-6),
                            50)
            plain_ms = median_ms(torch, lambda: plain_rms.rmsnorm_plain(
                x, sc, eps=1e-6), 10)
            bd = bound((2 * r * d + d) * x.element_size(), 4 * r * d, "fp32")
            norms[name][kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                                     **bd)
            lines.append(f"rmsnorm {name} {kind} [{r}, {d}]: ms {ms:.5f}, "
                         f"plain {plain_ms:.4f}, F.rms_norm {lib:.5f}, bound "
                         f"{bd['bound_ms']:.5f} ({bd['bound_by']}, "
                         f"{bd['bound_ms'] / ms:.1%} of it) [{smi}]")
    rows["flash_attention"]["xattn"] = att
    rows["rmsnorm"]["xattn"] = norms
    for line in lines:
        print(line)


def run_xattn_ssm_cohort(torch, ops, FedZOConfig, smi, rows):
    """Phase "encdec, vlm and the ssm cohort": parts (a) to (e), each
    part's seconds and peak memory printed; budget XATTN_BUDGET_S. Returns
    the launches of its main-path runs."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    smokes = ("seamless-m4t-large-v2-smoke", "llama-3.2-vision-90b-smoke")
    for name, part in (
            ("(a) seamless-m4t-large-v2", lambda: serve_seamless(
                torch, ops, FedZOConfig, smi, total, rows)),
            ("(b) llama-3.2-vision-90b, 10 layers", lambda: serve_vision(
                torch, ops, smi, total, rows)),
            ("(c) encdec and vlm smoke configs card vs CPU",
             lambda: family_smoke_card_vs_cpu(torch, ops, FedZOConfig, total,
                                              smokes)),
            ("(d) hymba-1.5b flat round", lambda: run_ssm_cohort_round(
                torch, ops, FedZOConfig, smi, total, rows, "hymba-1.5b")),
            ("(d) rwkv6-7b flat round, 2 layers", lambda: run_ssm_cohort_round(
                torch, ops, FedZOConfig, smi, total, rows, "rwkv6-7b",
                RWKV_ROUND_LAYERS)),
            ("(d) ssm and hybrid smoke rounds card vs CPU",
             lambda: smoke_rounds_card_vs_cpu(
                 torch, ops, FedZOConfig, total,
                 ("rwkv6-7b-smoke", "hymba-1.5b-smoke"))),
            ("(e) cross-attention kernel timing", lambda: time_xattn_kernels(
                torch, ops, smi, rows))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        part()
        print(f"part {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"encdec, vlm and the ssm cohort: {took:.1f} s of the "
          f"{XATTN_BUDGET_S:.0f} s budget [{smi}]")
    return total


# ---------------------------------------------------------------------------
# phase "encdec and vlm cohort, strategy sweeps"

XCOHORT_BUDGET_S = 150.0
# seamless-m4t-large-v2 (arXiv:2308.11596) at full width and depth through
# the enc-dec cohort loss, float32 (6.08 GiB a copy): M 2, H 1 (2 until PR
# 27, cut in depth to keep the script inside its time limit), b2 8, mu
# 1e-3, each client 2 x 128 tokens of the launcher's stream over its 4,096
# stub frames (0.1.normal). A round holds about 2 + 4M copies (phase 12's
# hymba round: 52 GiB for 10 copies of 5.19 GiB), one more with AirComp:
# about 61 and 67 GiB, and 2 GiB of activations.
XC_M, XC_H, XC_B2, XC_B, XC_S = 2, 1, 8, 2, 128
# llama-3.2-vision-90b at full width, reduced in depth only to one group:
# 5 of 100 layers (4 self layers and one gated cross layer) over its 1,600
# stub patches, 6,497,067,266 parameters, float32 (24.20 GiB a copy); a
# flat round's 2 + 4M copies do not fit one card even at M 1, so the
# cohort loss alone at M 2 (48.41 GiB of stacked weights, initialised in
# bfloat16 and widened), gates VISION_GATE, each client's weights offset
# by 1e-3.normal
VISION_COHORT_LAYERS, VISION_COHORT_PARAMS = 5, 6_497_067_266
XC_LOSS_ULPS = 2
# the encdec and vlm -smoke rounds on the card against the CPU at twice
# the other families' lr: at 1e-3 seamless-m4t-large-v2-smoke's wide round
# (block directions) moves its largest weight by 9.0e-3, under the
# 10 x COHORT_SMOKE_TOL that makes the comparison mean something, while
# the card reads 5.4e-5 from the CPU (H100 80GB HBM3)
XC_SMOKE_LR = 2e-3
# the strategy sweeps: the paper's Sec. V-B softmax model (784 x 10 + 10
# = 7,850 weights) at N 50, M 10, H 5, b1 25, b2 20, flat route (4-row
# blocks: n_pad 8,192), unsafe_rbg, AirComp; S = 4 scenarios over {lr,
# snr_db} a group, 2 rounds; a ZO group's lr {1e-3, 5e-4}, FedAvg's
# {5e-2, 2.5e-2}
SWEEP_SNRS = (0.0, 20.0)
SWEEP_ROUNDS = 2
# the first round's records on the card against the CPU: the losses
# within FAST_ATOL, the other float records (delta_max, the noise's std)
# within a relative SWEEP_REL, m_effective bitwise. A loss ulp moves a
# coefficient by d·ulp/mu = 7,850 x 1.2e-7 / 1e-3, about 0.9, so the
# card's other summation orders move a row's delta within the round
# (delta_max, about 7.8, 2.7e-4 to 3.4e-4 apart relative, the noise's std
# 1.4e-4 to 1.7e-4, on an H100 80GB HBM3), as in the attack sweep
# (ATTACK_LOSS_RTOL)
SWEEP_LOSSES = ("mean_local_loss", "first_loss")
SWEEP_REL = 5e-3
SWEEP_STRATEGIES = (("fedzo", {}), ("fedprox", dict(prox_mu=0.01)),
                    ("feddyn", dict(dyn_alpha=0.01)), ("scaffold", {}),
                    ("fedavg", dict(lr=5e-2)))


def hold_xcohort_kernels(torch, ops, rows):
    """The enc-dec cohort's new kernel shapes against the plain versions in
    float32 under phase 2's rules: the non-causal encoder attention over
    the ``[M.B = 4, 4,096, 16, 64]`` rows, and the cross q and k norms'
    rows (``[2, 4,096, 64]`` and ``[2, 131,072, 64]``) under ``[2, 64]``
    group scales. Returns the printed notes."""
    from repro_torch.kernels import flash_attention as plain_flash
    from repro_torch.kernels import rmsnorm as plain_rms
    g = torch.Generator(device="cuda").manual_seed(25)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    notes, e_rms = [], 0.0
    for r in (XC_B * XC_S * 16, XC_B * 4096 * 16):
        _, e, note = hold_rmsnorm(torch, ops, plain_rms, rnd(XC_M, r, 64),
                                  1.0 + 0.1 * rnd(XC_M, 64))
        e_rms = max(e_rms, e)
        notes.append(note + f" ({XC_M} scales)")
    e_att, note = hold_attention_long(
        torch, ops, plain_flash, *(rnd(XC_M * XC_B, 4096, 16, 64)
                                   for _ in range(3)), False, 0)
    notes.append(note)
    rows["rmsnorm"]["max_abs_err"] = max(rows["rmsnorm"]["max_abs_err"],
                                         e_rms)
    rows["flash_attention"]["max_abs_err"] = max(
        rows["flash_attention"]["max_abs_err"], e_att)
    return notes


def loss_ulps(torch, got, each):
    """(max relative difference, max ulps of ``each``) of two loss rows."""
    ulp = torch.nextafter(each, torch.full_like(each, math.inf)) - each
    return (float(((got - each).abs() / each.abs()).max()),
            float(((got - each).abs() / ulp).max()))


def run_seamless_cohort_round(torch, ops, FedZOConfig, smi, total, rows):
    """Part (a): ``fedzo.round_simulated`` on seamless-m4t-large-v2 at full
    width and depth in float32 through the enc-dec cohort loss: a warm-up
    mean round, a mean round bitwise the warm-up's, an AirComp round
    (channel scheduling at 5 dB); each with its ms, peak and exact
    launches (one client's forward launches whatever M is); the reckoned
    peak first; then the cohort loss against each client's own within
    XC_LOSS_ULPS."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import flat_spec, flatten, unflatten
    from repro_torch.utils.tree import tree_leaves, tree_size
    model, toks = lm_setup("seamless-m4t-large-v2", "float32")
    cfg = model.cfg
    m, h, b, s = XC_M, XC_H, XC_B, XC_S
    print("seamless-m4t-large-v2 cohort shapes against the plain versions: "
          + "; ".join(hold_xcohort_kernels(torch, ops, rows)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(prng.key(0), device="cuda")
    n = tree_size(params)
    check(n == SEAMLESS_PARAMS, f"seamless-m4t-large-v2: {n} parameters")
    spec = flat_spec(params)
    copy = 4 * spec.n_pad / 2**30
    print(f"seamless-m4t-large-v2 cohort round: {n} parameters, n_pad "
          f"{spec.n_pad}; reckoned peak {(2 + 4 * m) * copy:.1f} GiB "
          f"({2 + 4 * m} float32 copies of {copy:.2f} GiB; one more with "
          f"AirComp) [{smi}]")
    rng = np.random.default_rng(1)
    per = [lm_batch(torch, toks, rng, b, s, "cuda") for _ in range(m * h)]
    batches = {k: torch.stack([x[k] for x in per]).reshape((m, h, b, s))
               for k in ("tokens", "labels")}
    g = torch.Generator(device="cuda").manual_seed(26)
    batches["src_embeds"] = 0.1 * torch.randn(
        (m, h, b, cfg.n_frontend_tokens, cfg.d_model), generator=g,
        device="cuda")
    keys = prng.split(prng.key(1), m)
    base = dict(n_participating=m, local_iters=h, lr=1e-4, mu=1e-3,
                b2=XC_B2, estimator="sphere", flat_params=True)
    cfgs = {"mean": FedZOConfig(**base),
            "aircomp": FedZOConfig(**base, aircomp=True,
                                   channel_schedule=True, snr_db=5.0)}
    first, lines = None, []
    for name in ("warm-up mean", "mean", "aircomp"):
        fcfg = cfgs[name.split()[-1]]
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = fedzo.round_simulated(model.loss, params, batches, keys,
                                         fcfg, channel_rng=prng.key(2))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(ops.LAUNCHES)
        want = cohort_launches(ops, cfg, fcfg)
        check(counts == want, f"seamless round {name}: launches {counts} "
              f"!= {want}")
        for k in total:
            total[k] += counts[k]
        mets = {k: float(v) for k, v in met.items()}
        check(all(map(math.isfinite, mets.values())) and all(
            bool(torch.isfinite(t).all()) for t in tree_leaves(new)),
            f"seamless round {name}: metrics {mets}")
        moved = max(float((a - c).abs().max()) for a, c in
                    zip(tree_leaves(new), tree_leaves(params)))
        check(moved > 0, f"seamless round {name}: no weight moved")
        again = ""
        if first is None:
            first = [t.cpu() for t in tree_leaves(new)]
        elif name == "mean":
            check(all(torch.equal(a.cpu(), c) for a, c in
                      zip(tree_leaves(new), first)),
                  "seamless round: a second run differs")
            again = "; bitwise the warm-up round"
        del new
        lines.append(f"{name}: ms/round {ms:.1f}; peak "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                     f"metrics {json.dumps(mets)}; largest weight move "
                     f"{moved:.3e}; launches {counts}{again}")
        torch.cuda.empty_cache()
    del first
    # each client's own weights: the server weights plus a per-client
    # offset, as rows of one [M, n_pad] buffer
    buf = flatten(params, spec)[None].repeat(m, 1)
    buf += 1e-3 * torch.randn(buf.shape, generator=g, device="cuda")
    b0 = {k: v[:, 0] for k, v in batches.items()}
    got = model.loss_batched(unflatten(buf, spec), b0)
    each = torch.stack([model.loss(unflatten(buf[i], spec),
                                   {k: v[i] for k, v in b0.items()})
                        for i in range(m)])
    rel, ulps = loss_ulps(torch, got, each)
    check(ulps <= XC_LOSS_ULPS, f"seamless cohort loss vs each client: "
          f"{ulps} ulps")
    print(f"seamless_m4t_large_v2_flat_round (float32, full width and depth; "
          f"M {m}, H {h}, b2 {XC_B2}, batch {b} x {s} a client over "
          f"{cfg.n_frontend_tokens} frames): " + " | ".join(lines)
          + f"; the cohort loss vs each client's own rel {rel:.2e} "
          f"({ulps:.1f} ulps, bound {XC_LOSS_ULPS}) [{smi}]")
    del buf, params, batches
    torch.cuda.empty_cache()


def run_vision_cohort_loss(torch, ops, smi, rows):
    """Part (b): llama-3.2-vision-90b at full width, cut to one group
    (VISION_COHORT_LAYERS), float32: its cohort loss at M 2 (each client's
    weights a row of one ``[2, n_pad]`` buffer, the gates VISION_GATE plus
    the offset), 2 x 128 tokens each over 1,600 patch embeddings: against
    each client's own loss within XC_LOSS_ULPS, and its RMSNorm and
    attention launches at M 2 those at M 1 and a one-client forward's."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    from repro_torch.utils import prng
    from repro_torch.utils.flatparams import _leaves, flat_spec, unflatten
    cfg = get_config("llama-3.2-vision-90b").replace(
        n_layers=VISION_COHORT_LAYERS, dtype="float32")
    model = api.build(cfg)
    m, b, s = XC_M, XC_B, XC_S
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spec = flat_spec(model.init(prng.key(0), device="meta"))
    check(spec.d == VISION_COHORT_PARAMS, f"vision 5L: {spec.d} parameters")
    t0 = time.perf_counter()
    half = api.build(cfg.replace(dtype="bfloat16")).init(prng.key(0),
                                                         device="cuda")
    buf = torch.empty((m, spec.n_pad), device="cuda")
    buf[0, spec.d:] = 0.0
    for (_, dst), (_, src) in zip(_leaves(unflatten(buf[0], spec)),
                                  _leaves(half)):
        dst.copy_(src)
    del half
    unflatten(buf[0], spec)["cross_blocks"]["gate_attn"].fill_(VISION_GATE)
    unflatten(buf[0], spec)["cross_blocks"]["gate_mlp"].fill_(VISION_GATE)
    g = torch.Generator(device="cuda").manual_seed(27)
    chunk = 1 << 28
    for i in range(0, spec.n_pad, chunk):
        c = min(chunk, spec.n_pad - i)
        buf[1, i:i + c] = buf[0, i:i + c] + 1e-3 * torch.randn(
            c, generator=g, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    per = [api.make_batch(model, ShapeConfig("t", s, b, "train"),
                          prng.key(10 + i), device="cuda") for i in range(m)]
    for i, x in enumerate(per):   # patches of 0.1.normal (make_batch's: 1)
        x["vision_embeds"] = 0.1 * x["vision_embeds"]
    batch = {k: torch.stack([x[k] for x in per]) for k in per[0]}
    seen = []
    for rows_m in (m, 1):
        ops.reset_launches()
        got = model.loss_batched(unflatten(buf[:rows_m], spec),
                                 {k: v[:rows_m] for k, v in batch.items()})
        torch.cuda.synchronize()
        seen.append({k: ops.LAUNCHES[k] for k in ("rmsnorm",
                                                  "flash_attention")})
        if rows_m == m:
            cohort = got
    ops.reset_launches()
    each = torch.stack([model.loss(unflatten(buf[i], spec), per[i])
                        for i in range(m)])
    torch.cuda.synchronize()
    single = {k: ops.LAUNCHES[k] // m for k in ("rmsnorm",
                                                 "flash_attention")}
    want = xattn_launches(cfg, "prefill")
    check(seen[0] == seen[1] == single == want, f"vision cohort launches "
          f"M {m} {seen[0]}, M 1 {seen[1]}, one client {single} != {want}")
    rel, ulps = loss_ulps(torch, cohort, each)
    check(ulps <= XC_LOSS_ULPS and bool(torch.isfinite(cohort).all()),
          f"vision cohort loss vs each client: {ulps} ulps")
    print(f"llama_3_2_vision_90b_1g_cohort_loss (float32, full width, "
          f"reduced: depth only, n_layers {VISION_COHORT_LAYERS} of 100, "
          f"{spec.d} parameters; M {m}, batch {b} x {s} a client over "
          f"{cfg.n_frontend_tokens} patches, gates {VISION_GATE}): stacked "
          f"weights {4 * m * spec.n_pad / 2**30:.2f} GiB built in "
          f"{init_s:.2f} s; losses {[round(float(v), 4) for v in cohort]}; "
          f"vs each client's own rel {rel:.2e} ({ulps:.1f} ulps, bound "
          f"{XC_LOSS_ULPS}); launches a cohort forward {seen[0]} at M {m} "
          f"and at M 1; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB [{smi}]")
    del buf, batch, per
    torch.cuda.empty_cache()


def sweep_launches(ops, cfg, S, rounds):
    """ZO launches of a batched flat AirComp group of S scenarios: per
    iterate b2 walks, one replay and one norms launch over all S.M rows;
    per round each scenario's aircomp_reduce and noise walk. FedAvg
    launches no ZO kernel (its AirComp is the pytree route's)."""
    want = dict.fromkeys(ops.LAUNCHES, 0)
    if cfg.strategy != "fedavg":
        iters = rounds * cfg.local_iters
        want.update(zo_walk=iters * cfg.b2 + rounds * S, zo_replay=iters,
                    zo_dirnorms=iters, aircomp_reduce=rounds * S)
    return want


def run_strategy_sweeps(torch, ops, FedZOConfig, smi, total):
    """Part (d): ``sim.run_sweep`` on the Sec. V-B softmax model (N 50, M
    10, H 5, b1 25, b2 20, flat route, unsafe_rbg, AirComp), one group of
    S = 4 scenarios over {lr, snr_db} per strategy, each one batched loop
    over the [S.M] cohort: fedzo, then fedprox, feddyn, scaffold and
    fedavg (which raised under rbg keys before). Per group: the seconds on
    the card of a first and a second call, the second's exact ZO launches
    (``sweep_launches``), the
    philox_bits launches (each ZO group's the fedzo group's), and every
    scenario's first-round records of the four strategies against the
    same group's on the CPU (m_effective bitwise, the losses within
    FAST_ATOL, the rest within a relative SWEEP_REL)."""
    import numpy as np
    from repro_torch import sim
    from repro_torch.workloads import neural
    kw = dict(n_features=784, n_classes=10, n_clients=50)
    tasks = {dev: neural.make_task("softmax", device=dev, **kw)
             for dev in ("cuda", "cpu")}
    lines, philox = [], None
    for name, extra in SWEEP_STRATEGIES:
        cfg = neural.default_config(
            tasks["cuda"], n_participating=10, local_iters=5, b1=25, b2=20,
            flat_params=True, flat_block_rows=4, aircomp=True,
            prng_impl="unsafe_rbg", strategy=name, **extra)
        scen = sim.scenario_grid(lr=(cfg.lr, cfg.lr / 2), snr_db=SWEEP_SNRS)
        recs, secs = {}, []
        # the card's group twice (the first call's seconds beside the
        # warm one's), then the CPU's first round (fedzo's group is the
        # timing baseline; phase "fast strategy and batched sweeps" holds
        # its batched records)
        runs = [("cuda", SWEEP_ROUNDS)] * 2 + [("cpu", 1)] * (name != "fedzo")
        for dev, rounds in runs:
            task = tasks[dev]
            ops.reset_launches()
            if dev == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs[dev] = sim.run_sweep(task.loss, neural.params_init(task, 0),
                                      task.store, cfg, scen, rounds)
            if dev == "cuda":
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
                counts = dict(ops.LAUNCHES)
        want = sweep_launches(ops, cfg, len(scen), SWEEP_ROUNDS)
        zo = {k: counts[k] for k in want if k != "philox_bits"}
        check(zo == {k: v for k, v in want.items() if k != "philox_bits"},
              f"{name} sweep launches {counts} != {want}")
        if name == "fedzo":
            philox = counts["philox_bits"]
        elif name != "fedavg":
            check(counts["philox_bits"] == philox, f"{name} sweep: "
                  f"{counts['philox_bits']} philox_bits, fedzo's {philox}")
        for k in total:
            total[k] += counts[k]
        worst = {}
        for a, c in zip(recs["cuda"], recs.get("cpu", ())):
            check(a["strategy"] == name and np.array_equal(
                a["metrics"]["m_effective"][:1],
                c["metrics"]["m_effective"]), f"{name} sweep: m_effective")
            for k, v in c["metrics"].items():
                got = a["metrics"][k]
                check(np.isfinite(got).all(), f"{name} sweep: {k} {got}")
                if k == "m_effective":
                    continue
                d = np.abs(got[:1] - v)
                if k not in SWEEP_LOSSES:
                    d = d / np.abs(v)
                worst[k] = max(worst.get(k, 0.0), float(d.max()))
        check(all(v <= (FAST_ATOL if k in SWEEP_LOSSES else SWEEP_REL)
                  for k, v in worst.items()),
              f"{name} sweep card vs CPU {worst}")
        per_round = {k: v / SWEEP_ROUNDS for k, v in counts.items() if v}
        vs = ({k: float(f"{v:.3g}") for k, v in worst.items()} if worst
              else "the timing baseline")
        lines.append(f"{name} {secs[1]:.3f} s (first call {secs[0]:.3f}; "
                     f"card vs CPU {vs}; launches a round {per_round})")
    print(f"strategy sweeps (softmax 784x10, N 50, M 10, H 5, b1 25, b2 20, "
          f"flat, unsafe_rbg, AirComp; S {len(scen)} over lr x snr_db, "
          f"{SWEEP_ROUNDS} rounds; first-round records card vs CPU, the "
          f"losses absolute (bound {FAST_ATOL}), the rest relative (bound "
          f"{SWEEP_REL})): " + "; ".join(lines) + f" [{smi}]")


def run_xattn_cohort_sweeps(torch, ops, FedZOConfig, smi, rows):
    """Phase "encdec and vlm cohort, strategy sweeps": parts (a) to (d),
    each part's seconds and peak memory printed; budget XCOHORT_BUDGET_S.
    Returns the launches of its main-path runs."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    for name, part in (
            ("(a) seamless-m4t-large-v2 flat round",
             lambda: run_seamless_cohort_round(torch, ops, FedZOConfig, smi,
                                               total, rows)),
            ("(b) llama-3.2-vision-90b one-group cohort loss",
             lambda: run_vision_cohort_loss(torch, ops, smi, rows)),
            ("(c) encdec and vlm smoke rounds card vs CPU",
             lambda: smoke_rounds_card_vs_cpu(
                 torch, ops, FedZOConfig, total,
                 ("seamless-m4t-large-v2-smoke",
                  "llama-3.2-vision-90b-smoke"), lr=XC_SMOKE_LR)),
            ("(d) strategy sweeps under unsafe_rbg",
             lambda: run_strategy_sweeps(torch, ops, FedZOConfig, smi,
                                         total))):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        part()
        print(f"part {name}: {time.perf_counter() - t0:.1f} s, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"encdec and vlm cohort, strategy sweeps: {took:.1f} s of the "
          f"{XCOHORT_BUDGET_S:.0f} s budget [{smi}]")
    return total


# ---------------------------------------------------------------------------
# phase 14: the production mesh (4 gloo ranks sharing the card as a (2, 2)
# mesh, DTensors laid out by launch/sharding.py; the dry-run's records)

PROD_BUDGET_S = 90.0
PROD_ARCH = "qwen3-moe-30b-a3b"
# the sharded forwards against one rank, float32 at full width: the MoE
# layer's partial outputs are summed over the model axis and each rank's
# expert GEMMs see their shard's capacity (another shape, another
# summation order), so the reference's own sharded-vs-oracle atol (2e-4,
# tests/test_moe.py) holds the layer, and logits are held within 1e-4 of
# their largest magnitude (2,048-wide float32 rows; the measured gap is
# printed)
PROD_MOE_ATOL = 2e-4
PROD_LOGIT_REL = 1e-4
PROD_LOSS_REL = 1e-5
# the sharded train step's mu: at QWEN_CHECK_MU = 16 one of qwen3-moe's two
# directions read a loss difference of 95 ulps at one layer (d 1.25e9),
# under CHECK_MIN_ULPS; at 64 the step is mu/sqrt(d) = 1.8e-3 a weight,
# below the weights' 0.02
PROD_MU = 64.0
# decode steps of part (b) on the mesh (4 before the FedAvg step joined the
# phase: each sharded step is 2.0-2.3 s of gloo bridge on one card)
PROD_DECODE_STEPS = 1
# the MoE layer's gradients on the mesh against one rank's, relative to each
# gradient's largest magnitude: float32 sums in other orders (the expert
# GEMMs at the shard's capacity, the reduce-scatters and the partial sums
# over ranks); 3e-7 at smoke size on the CPU
# (tests/test_torch_sharded_fedavg.py), while a backward that misses a sum
# over a mesh axis is off by tens of percent
PROD_GRAD_REL = 1e-4
# an updated leaf of the FedAvg step on the mesh against one rank's: lr 1e-3
# times the gradients' float32 differences (7.5e-9 on an H100 at this
# phase's shapes); the largest move of a weight is 1.26e-5, 126 times it
PROD_STEP_ATOL = 1e-7
PROD_LR = 1e-3
# the dry-run cases of part (c): (arch, shape, multi_pod, algo)
PROD_DRYRUN = (("qwen2-0.5b", "train_4k", False, "fedzo"),
               ("qwen2-0.5b", "train_4k", True, "fedzo"),
               (PROD_ARCH, "prefill_32k", False, "fedzo"),
               (PROD_ARCH, "decode_32k", False, "fedzo"),
               (PROD_ARCH, "train_4k", False, "fedavg"))


def _spy_kernels(ops):
    """Record the shapes ``ops._rmsnorm`` and ``ops._attention`` see (the
    local shards); returns (shapes, undo)."""
    seen = {"rmsnorm": set(), "flash_attention": set()}
    rms, att = ops._rmsnorm, ops._attention

    def rms_spy(x, scale, eps):
        seen["rmsnorm"].add((tuple(x.shape), tuple(scale.shape), x.dtype))
        return rms(x, scale, eps)

    def att_spy(q, k, v, causal, window, scale):
        seen["flash_attention"].add((tuple(q.shape), tuple(k.shape),
                                     tuple(v.shape), q.dtype, bool(causal),
                                     int(window)))
        return att(q, k, v, causal, window, scale)

    ops._rmsnorm, ops._attention = rms_spy, att_spy

    def undo():
        ops._rmsnorm, ops._attention = rms, att
    return seen, undo


def _hold_local_kernels(torch, ops, seen):
    """Each local-shard shape the sharded forwards gave the kernels, held
    against the plain versions on random inputs (float32: relative 1e-5,
    phase 2's rule). Returns the worst relative errors."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    g = torch.Generator(device="cuda").manual_seed(14)
    worst = {"rmsnorm": 0.0, "flash_attention": 0.0}
    for xs, ss, dt in sorted(seen["rmsnorm"], key=str):
        x = torch.randn(xs, device="cuda", generator=g).to(dt)
        s = (1 + 0.1 * torch.randn(ss, device="cuda", generator=g)).to(dt)
        got, want = ops.rmsnorm(x, s), rmsnorm_plain(x, s)
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel <= 1e-5, f"rmsnorm at the local shape {xs}: {rel}")
        worst["rmsnorm"] = max(worst["rmsnorm"], rel)
    for qs, ks, vs, dt, causal, window in sorted(seen["flash_attention"],
                                                 key=str):
        q, k, v = (torch.randn(s, device="cuda", generator=g).to(dt)
                   for s in (qs, ks, vs))
        got = ops.attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel <= 1e-5, f"attention at the local shape {qs}: {rel}")
        worst["flash_attention"] = max(worst["flash_attention"], rel)
    return worst


def _block(whole, dt):
    """The block of the whole tensor ``whole`` that DTensor ``dt``'s local
    shard holds on this rank."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    ls, off = compute_local_shape_and_global_offset(
        tuple(whole.shape), dt.device_mesh, dt.placements)
    return whole[tuple(slice(o, o + n) for o, n in zip(off, ls))]


def _moe_backward(torch, dist, moe, shr, prng, mesh, p, dp, cfg, lay, B, S,
                  sync_ms):
    """Part (a)'s backward: the gradient of ``sum(out · w) + aux`` of the
    expert-parallel layer with respect to x and every leaf, each gradient
    laid out as its input (partial sums reduced), against one rank's
    autograd on this rank's block. Returns (ms, worst relative error a
    gradient, largest magnitude a gradient, the forward's local out and
    aux), the errors over all ranks."""
    from repro_torch.utils.shardutil import on_dtensors
    dev = mesh.device
    x = 0.5 * prng.normal(prng.key(1), (B, S, cfg.d_model), device=dev)
    w = prng.normal(prng.key(2), (B, S, cfg.d_model), device=dev)
    db = shr.distribute({"x": x, "w": w},
                        shr.batch_shardings({"x": x, "w": w}, mesh))
    names = sorted(dp)
    ins = [db["x"].detach().requires_grad_()] + [
        dp[n].detach().requires_grad_() for n in names]

    def sharded():
        o, aux = moe.moe_fwd(dict(zip(names, ins[1:])), cfg, ins[0],
                             mesh=mesh)
        with on_dtensors(ins):
            g = torch.autograd.grad(torch.sum(o * db["w"]) + aux, ins)
        return [t.redistribute(t.device_mesh, i.placements)
                if tuple(t.placements) != tuple(i.placements) else t
                for t, i in zip(g, ins)], (o.detach().to_local(),
                                            aux.detach().to_local())
    (got, fwd), ms = sync_ms(sharded)
    one = [x.detach().requires_grad_()] + [
        p[n].detach().requires_grad_() for n in names]
    o1, a1 = moe.moe_fwd(dict(zip(names, one[1:])), cfg, one[0])
    want = torch.autograd.grad(torch.sum(o1 * w) + a1, one)
    errs = {n: float((g.to_local() - _block(t, g)).abs().max())
            for n, g, t in zip(["x"] + names, got, want)}
    tops = {n: float(t.abs().max()) for n, t in zip(["x"] + names, want)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, errs)
    worst = {n: max(e[n] for e in every) / tops[n] for n in errs}
    return ms, worst, tops, fwd


def _fedavg_vs_one_rank(torch, dist, fedavg, FedZOConfig, model, params,
                        dparams, train, new, key):
    """Each rank in turn runs one rank's FedAvg step on the whole tree (a
    step holds three copies of it: one at a time fits the card) and holds
    its block of every updated leaf of the sharded step ``new`` against
    the same block of that step's. Returns (one rank's loss, the largest
    error of a leaf over all ranks, the largest move of a weight)."""
    from repro_torch.utils.tree import tree_leaves
    rank = dist.get_rank()
    res = None
    for r in range(dist.get_world_size()):
        if r == rank:
            step = fedavg.make_train_step(model.loss, FedZOConfig(lr=PROD_LR))
            new1, m1 = step(params, train, key)
            err = max(float((a.to_local() - _block(b, a)).abs().max())
                      for a, b in zip(tree_leaves(new), tree_leaves(new1)))
            moved = max(float((b - b0).abs().max()) for b, b0 in zip(
                tree_leaves(new1), tree_leaves(params)))
            res = (float(m1["loss"]), err, moved)
            del new1, step
            torch.cuda.empty_cache()
        dist.barrier()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, res)
    return every[0][0], max(e[1] for e in every), every[0][2]


def _production_rank(rank, world, out, src):
    """A spawned rank of phase 14 (a) and (b): 4 gloo ranks on the one card
    as ``make_host_mesh(model_axis=2)``. Rank 0 also runs the one-rank
    forwards and saves every reading."""
    sys.path.insert(0, src)
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)
    from repro_torch.configs import get_config
    from repro_torch.configs.base import FedZOConfig
    from repro_torch.core import estimator, fedavg, fedzo
    from repro_torch.kernels import ops
    from repro_torch.kernels.zo_axpy import zo_axpy2_plain
    from repro_torch.launch import sharding as shr
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api, moe
    from repro_torch.utils import prng
    from repro_torch.utils.shardutil import is_dtensor
    from repro_torch.utils.tree import tree_leaves, tree_map

    mesh = make_host_mesh(2)
    dev = mesh.device
    res = {"moe": [], "moe_bwd": [], "lm": {}}
    t_rank = time.perf_counter()

    def say(what):
        if rank == 0:
            print(f"  rank 0 at {time.perf_counter() - t_rank:.1f} s: "
                  f"{what}", flush=True)

    def full(t):
        if is_dtensor(t):
            t = t.full_tensor()
            t = t.wait() if hasattr(t, "wait") else t
        return t.detach()

    def sync_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t0)

    # (a) the MoE layer at full width: both layouts at factor E/k, the
    # train layout (where the shard's capacity binds) at 1.25; the layer is
    # the one of part (b)'s 1-layer model, drawn once
    torch.cuda.reset_peak_memory_stats()
    base = get_config(PROD_ARCH).replace(dtype="float32")
    E, k = base.n_experts, base.top_k
    cfg = get_config(PROD_ARCH).replace(n_layers=1, dtype="float32",
                                        capacity_factor=E / k)
    model = api.build(cfg)
    params = model.init(prng.key(0), device=dev)
    p = {n: v[0] for n, v in params["moe_blocks"]["moe"].items()}
    say("the 1-layer model initialised")
    psh = {n: shr.NamedSharding(mesh, shr.leaf_spec(
        shr.keystr(("moe", n)), tuple(v.shape), mesh)) for n, v in p.items()}
    dp = shr.distribute(p, psh)
    for factor, lay, (B, S) in ((E / k, "train", (4, 128)),
                                (E / k, "decode", (3, 1)),
                                (1.25, "train", (4, 128))):
        cfg = base.replace(capacity_factor=factor)
        x = 0.5 * prng.normal(prng.key(1), (B, S, cfg.d_model),
                              device=dev)
        dx = shr.distribute({"x": x}, shr.batch_shardings({"x": x},
                                                          mesh))["x"]
        (o1, a1), ms = sync_ms(lambda: moe.moe_fwd(dp, cfg, dx,
                                                   mesh=mesh))
        rec = {"factor": factor, "layout": lay, "ms": ms,
               "placements": str(o1.placements)}
        if factor == E / k and lay == "train":
            # held bitwise against the forward of the backward below
            first = (o1.to_local(), a1.to_local())
        # each shard's dropped share of its local assignments
        T = B * S
        n_data = mesh.shape["data"]
        e_local = E // mesh.shape["model"]
        if T % n_data == 0:
            xl = x.reshape(T, -1).chunk(n_data)[mesh.axis_rank("data")]
            cap = moe._capacity(T // n_data, cfg, e_local)
        else:
            xl, cap = x.reshape(T, -1), moe._capacity(T, cfg, e_local)
        r = moe.route(xl, p["router"], cfg=cfg,
                      e_offset=mesh.axis_rank("model") * e_local,
                      e_local=e_local, capacity=cap)
        mine = (r["se"] < e_local).sum().float()
        share = torch.zeros(world, device=dev)
        share[rank] = 1.0 - r["keep"].sum().float() / mine
        dist.all_reduce(share)
        rec["dropped"] = share.tolist()
        of, af = full(o1), full(a1)
        if rank == 0:
            ref, ms1 = sync_ms(lambda: moe.moe_fwd(p, cfg, x))
            rec.update(one_rank_ms=ms1,
                       err=float((of - ref[0]).abs().max()),
                       aux_rel=float(abs(af - ref[1]) / ref[1]),
                       top=float(ref[0].abs().max()))
        res["moe"].append(rec)
        say(f"moe_fwd {lay} at factor {factor:g}")
    for lay, (B, S) in (("train", (4, 128)), ("decode", (3, 1))):
        ms, worst, tops, again = _moe_backward(
            torch, dist, moe, shr, prng, mesh, p, dp,
            base.replace(capacity_factor=E / k), lay, B, S, sync_ms)
        res["moe_bwd"].append({"layout": lay, "ms": ms, "rel": worst,
                               "top": tops})
        if lay == "train":
            same = all(torch.equal(u_, v_) for u_, v_ in zip(first, again))
            flags = torch.tensor([0.0 if same else 1.0], device=dev)
            dist.all_reduce(flags)
            res["moe"][0]["bitwise_twice"] = float(flags) == 0.0
        say(f"moe_fwd backward {lay} {ms:.1f} ms")
    part = {"a": (time.perf_counter() - t_rank,
                  torch.cuda.max_memory_allocated())}
    del p, dp, psh, first, again
    torch.cuda.empty_cache()
    say("the MoE layer done")
    t_b = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()

    # (b) the model cut in depth to 1 of 48 layers, full width, float32
    dparams = shr.distribute(params, shr.param_shardings(
        model.param_specs(), mesh))
    torch.cuda.empty_cache()
    say("the 1-layer model laid out")
    gen = torch.Generator(device=dev).manual_seed(5)

    def toks(*shape):
        return torch.randint(0, cfg.vocab, shape, device=dev, generator=gen,
                             dtype=torch.int32)
    B, S, W = 4, 128, 160
    train = {"tokens": toks(B, S), "labels": toks(B, S)}
    steps = [toks(B, 1) for _ in range(PROD_DECODE_STEPS)]

    def put(b):
        return shr.distribute(b, shr.batch_shardings(b, mesh))
    seen, undo = _spy_kernels(ops)
    counts = {}

    def counted(name, fn):
        ops.reset_launches()
        out_, ms_ = sync_ms(fn)
        counts[name] = dict(ops.LAUNCHES)
        res["lm"][f"{name}_ms"] = ms_
        say(f"{name} {ms_:.1f} ms")
        return out_
    loss = counted("loss", lambda: model.loss(dparams, put(train),
                                              mesh=mesh))
    logits, cache = counted("prefill", lambda: model.prefill(
        dparams, put({"tokens": train["tokens"]}), W, mesh=mesh))
    dec = []
    for i, tok in enumerate(steps):
        lg, cache = counted(f"decode{i}", lambda: model.decode(
            dparams, put({"tokens": tok}), cache, torch.tensor(S + i),
            mesh=mesh))
        dec.append(full(lg))
    undo()
    res["lm"].update(counts=counts, loss=full(loss), prefill=full(logits))
    if rank == 0:
        ops.reset_launches()
        (l1, ms1) = sync_ms(lambda: model.loss(params, train))
        res["lm"]["one_rank_counts"] = dict(ops.LAUNCHES)
        lg1, c1 = model.prefill(params, {"tokens": train["tokens"]}, W)
        # (the sharded values were gathered above by every rank: a gather
        # is a collective)
        errs = [float((res["lm"]["prefill"] - lg1).abs().max())]
        tops = [float(lg1.abs().max())]
        for i, tok in enumerate(steps):
            lg, c1 = model.decode(params, {"tokens": tok}, c1,
                                  torch.tensor(S + i))
            errs.append(float((dec[i] - lg).abs().max()))
            tops.append(float(lg.abs().max()))
        res["lm"].update(one_rank_loss=float(l1), one_rank_loss_ms=ms1,
                         logit_errs=errs, logit_tops=tops)
        del c1
    del cache
    torch.cuda.empty_cache()

    # one FedZO train step (pytree route, b2 2, mu 16) on the sharded tree,
    # each coefficient held to its recomputation without a ZO kernel
    fcfg = FedZOConfig(b2=2, mu=PROD_MU, lr=1e-3)
    key = prng.key(11)
    dtrain = put(train)

    def lossm(q, b):
        return model.loss(q, b, mesh=mesh)
    ops.reset_launches()
    (new, coeffs, base_l), ms = sync_ms(lambda: fedzo.local_iterate(
        lossm, dparams, dtrain, key, fcfg))
    counts["train_step"] = dict(ops.LAUNCHES)
    res["lm"]["train_step_ms"] = ms
    say(f"train step {ms:.1f} ms")
    n_leaves = len(tree_leaves(dparams))
    d = sum(t.numel() for t in tree_leaves(dparams))
    # the base loss: the same sharded forward as the loss above, whose
    # value it is bitwise (the layer is bitwise a second run, part (a))
    l0 = res["lm"]["loss"].float()
    ulp = float(torch.nextafter(l0, torch.full_like(l0, math.inf)) - l0)
    ref, diffs = [], []
    for n in range(fcfg.b2):
        v = estimator.sample_direction(prng.fold_in(key, n), dparams,
                                       "sphere")
        xp = tree_map(lambda a, b: (a + fcfg.mu * b).to(a.dtype), dparams, v)
        ln = full(lossm(xp, dtrain)).float()
        diffs.append(float(ln - l0) / ulp)
        ref.append(float(d * (ln - l0) / fcfg.mu))
        del v, xp
    say("coefficients recomputed")
    got = [float(c) for c in full(coeffs).reshape(-1)]
    unit = d * ulp / fcfg.mu
    res["lm"]["estimator"] = dict(
        coeffs=got, ref=ref, diff_ulps=diffs, base=float(full(base_l)),
        loss=float(l0), ulp=ulp, n_leaves=n_leaves,
        max_err_over_tol=max(abs(c - r) / (CHECK_TOL_ULPS * unit
                                          + CHECK_NORM_REL * abs(r))
                             for c, r in zip(got, ref)))
    del new
    # ops.tree_axpy2 over the sharded tree: the kernel on each local shard,
    # bitwise its plain version
    ops.reset_launches()
    u = estimator.sample_direction(prng.fold_in(key, 7), dparams, "sphere")
    out2 = ops.tree_axpy2(dparams, u, u, 0.5, -0.25)
    counts["tree_axpy2"] = dict(ops.LAUNCHES)
    same = all(torch.equal(o.to_local(), zo_axpy2_plain(
        x.to_local(), w.to_local(), w.to_local(), (0.5, -0.25)))
        for o, x, w in zip(tree_leaves(out2), tree_leaves(dparams),
                           tree_leaves(u)))
    res["lm"]["tree_axpy2_bitwise"] = same
    res["kernel_shapes"] = {k_: sorted(map(str, v_)) for k_, v_ in
                            seen.items()}
    part["b"] = (time.perf_counter() - t_b, torch.cuda.max_memory_allocated())
    del out2, u
    torch.cuda.empty_cache()

    # one FedAvg step on the sharded tree against one rank's
    t_fa = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    (new, mets), ms = sync_ms(lambda: fedavg.make_train_step(
        lossm, FedZOConfig(lr=PROD_LR))(dparams, dtrain, key))
    counts["fedavg_step"] = dict(ops.LAUNCHES)
    res["lm"]["fedavg_step_ms"] = ms
    say(f"FedAvg step {ms:.1f} ms")
    peak_fa = torch.cuda.max_memory_allocated()
    loss_fa = float(full(mets["loss"]))
    one_loss, err, moved = _fedavg_vs_one_rank(
        torch, dist, fedavg, FedZOConfig, model, params, dparams, train, new,
        key)
    res["lm"]["fedavg"] = dict(loss=loss_fa, one_rank_loss=one_loss,
                               err=err, moved=moved)
    del new, params
    part["fedavg"] = (time.perf_counter() - t_fa, peak_fa)
    say("FedAvg step held against one rank's")
    all_counts, all_parts = [None] * world, [None] * world
    dist.all_gather_object(all_counts, counts)
    dist.all_gather_object(all_parts, part)
    res["lm"]["rank_counts"] = all_counts
    res["rank_parts"] = all_parts
    if rank == 0:
        res["worst_local"] = _hold_local_kernels(torch, ops, seen)
        torch.save(res, out)


def _dry_case(src, arch, shape, multi_pod, algo):
    """One ``launch/dryrun.run_case`` record and its seconds (a module-level
    function: part (c) runs the FedAvg case in a spawned process)."""
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.launch import dryrun
    t = time.perf_counter()
    rec = dryrun.run_case(arch, shape, multi_pod=multi_pod, algo=algo)
    return rec, time.perf_counter() - t


def _expected_lm_launches(cfg):
    """Per rank, as on one rank: a forward launches ``layer_norms`` RMSNorms
    a layer and the final norm, one attention a layer; a decode step the
    norms and no kernel attention."""
    norms = cfg.n_layers * layer_norms(cfg) + 1
    fwd = {"rmsnorm": norms, "flash_attention": cfg.n_layers}
    return {"loss": fwd, "prefill": fwd,
            "decode": {"rmsnorm": norms, "flash_attention": 0}}


def run_production_mesh(torch, ops, FedZOConfig, smi, rows):
    """Phase "production mesh": parts (a) to (c); budget PROD_BUDGET_S.
    Returns the launches of its main-path runs (the ranks' sharded
    forwards, train steps and tree_axpy2, each rank's own)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    t_phase = time.perf_counter()
    total = dict.fromkeys(ops.LAUNCHES, 0)
    import threading
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prod_")
    out = os.path.join(tmp, "prod.pt")
    # (c), the dry-run on the host, runs while the 4 ranks work on the card:
    # the FedAvg cases (a backward on every layer, about a minute each) in a
    # process of their own, the others in a thread of this one
    dry = []

    def dry_cases():
        try:
            for case in PROD_DRYRUN:
                if case[3] != "fedavg":
                    dry.append(_dry_case(SRC, *case))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            dry.append(e)
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        pending = [pool.apply_async(_dry_case, (SRC,) + case)
                   for case in PROD_DRYRUN if case[3] == "fedavg"]
        worker = threading.Thread(target=dry_cases)
        t0 = time.perf_counter()
        worker.start()
        try:
            run_ranks(_production_rank, 4, backend="gloo", init_dir=tmp,
                      args=(out, SRC), timeout=600)
        finally:
            worker.join()
        spawn_s = time.perf_counter() - t0
        dry += [job.get(timeout=600) for job in pending]
    finally:
        pool.terminate()
        pool.join()
    res = torch.load(out, weights_only=False)
    base = get_config(PROD_ARCH)
    E, k = base.n_experts, base.top_k
    print(f"(a)+(b) 4 gloo ranks on the card as make_host_mesh(2): "
          f"{spawn_s:.1f} s spawned, joined, (c) beside them [{smi}]")
    for name in ("a", "b", "fedavg"):
        each = [rp[name] for rp in res["rank_parts"]]
        print(f"({name}) per rank: seconds {[round(s_, 1) for s_, _ in each]}"
              f", peak memory {[round(b_ / 2**30, 2) for _, b_ in each]} "
              f"GiB (every rank also holds the whole one-rank tree) [{smi}]")
    for rec in res["moe"]:
        if rec["factor"] == E / k:
            check(rec["err"] <= PROD_MOE_ATOL, f"sharded moe_fwd {rec}")
            check(rec["aux_rel"] <= 1e-4, f"sharded moe aux {rec}")
        check(rec.get("bitwise_twice", True), f"sharded moe_fwd not "
              f"bitwise twice {rec}")
        want = "Shard(dim=0)" if rec["layout"] == "train" else "Replicate()"
        check(rec["placements"].startswith(f"({want}"), f"layout {rec}")
        extra = (f", max |sharded - one rank| {rec['err']:.3e} (atol "
                 f"{PROD_MOE_ATOL}; max |out| {rec['top']:.3e}), aux rel "
                 f"{rec['aux_rel']:.2e}, one rank {rec['one_rank_ms']:.2f} "
                 f"ms") if "err" in rec else ""
        twice = ", bitwise a second run" if "bitwise_twice" in rec else ""
        print(f"(a) moe_fwd {PROD_ARCH} layer (E {E}, d {base.d_model}, "
              f"f {base.moe_d_ff}) fp32, {rec['layout']} layout, capacity "
              f"factor {rec['factor']:g}: {rec['ms']:.2f} ms sharded"
              f"{twice}, out {rec['placements']}{extra}; dropped share per "
              f"rank {[round(s, 4) for s in rec['dropped']]} [{smi}]")
    for rec in res["moe_bwd"]:
        for name, rel in rec["rel"].items():
            check(rel <= PROD_GRAD_REL, f"sharded moe_fwd backward "
                  f"{rec['layout']} d{name}: {rel:.3e} of its largest "
                  f"magnitude {rec['top'][name]:.3e} (> {PROD_GRAD_REL})")
        print(f"(a) moe_fwd backward {PROD_ARCH} layer fp32, "
              f"{rec['layout']} layout, capacity factor E/k: "
              f"{rec['ms']:.2f} ms sharded (forward and backward); max "
              f"|sharded - one rank| over each gradient's largest magnitude "
              f"{ {n: f'{v:.2e}' for n, v in rec['rel'].items()} } "
              f"(PROD_GRAD_REL {PROD_GRAD_REL}) [{smi}]")
    lm = res["lm"]
    cfg = get_config(PROD_ARCH).replace(n_layers=1)
    exp = _expected_lm_launches(cfg)
    for r, counts in enumerate(lm["rank_counts"]):
        for name, c in counts.items():
            kind = "decode" if name.startswith("decode") else name
            if kind in exp:
                for kern, n in exp[kind].items():
                    check(c[kern] == n, f"rank {r} {name}: {kern} {c[kern]} "
                          f"!= {n}")
        n_leaves = lm["estimator"]["n_leaves"]
        check(counts["train_step"]["zo_axpy"] == 2 * 2 * n_leaves,
              f"rank {r} train step zo_axpy {counts['train_step']}")
        check(counts["tree_axpy2"]["zo_axpy2"] == n_leaves,
              f"rank {r} tree_axpy2 {counts['tree_axpy2']}")
        fa = counts["fedavg_step"]
        for kern, n in exp["loss"].items():
            check(fa[kern] == n, f"rank {r} FedAvg step: {kern} {fa[kern]} "
                  f"!= {n}")
        check(fa["zo_axpy"] == 0 and fa["zo_axpy2"] == 0,
              f"rank {r} FedAvg step {fa}")
        for c in counts.values():
            for kern in total:
                total[kern] += c[kern]
    check(lm["one_rank_counts"]["rmsnorm"] == exp["loss"]["rmsnorm"],
          f"one-rank loss launches {lm['one_rank_counts']}")
    lrel = abs(float(lm["loss"]) - lm["one_rank_loss"]) / lm["one_rank_loss"]
    check(lrel <= PROD_LOSS_REL, f"sharded loss {float(lm['loss'])} against "
          f"one rank {lm['one_rank_loss']}")
    for i, (e, t) in enumerate(zip(lm["logit_errs"], lm["logit_tops"])):
        check(e <= PROD_LOGIT_REL * t, f"logits {i}: {e} > "
              f"{PROD_LOGIT_REL} x {t}")
    est = lm["estimator"]
    check(all(abs(u) >= CHECK_MIN_ULPS for u in est["diff_ulps"]),
          f"sharded estimator: a loss difference below {CHECK_MIN_ULPS} "
          f"ulps {est}")
    check(est["max_err_over_tol"] <= 1.0, f"sharded estimator {est}")
    check(lm["tree_axpy2_bitwise"], "tree_axpy2 on the sharded tree is not "
          "its plain version bitwise")
    n_dec = PROD_DECODE_STEPS
    print(f"(b) {PROD_ARCH} 1 of 48 layers, full width, fp32, (2, 2) mesh: "
          f"loss {float(lm['loss']):.6f} (one rank {lm['one_rank_loss']:.6f},"
          f" rel {lrel:.1e}) {lm['loss_ms']:.1f} ms (one rank "
          f"{lm['one_rank_loss_ms']:.1f}); prefill 4 x 128 "
          f"{lm['prefill_ms']:.1f} ms, {n_dec} decode steps "
          f"{[round(lm[f'decode{i}_ms'], 1) for i in range(n_dec)]} "
          f"ms; max "
          f"|logits - one rank| {[f'{e:.2e}' for e in lm['logit_errs']]} "
          f"(of max |logits| {[round(t, 2) for t in lm['logit_tops']]}); "
          f"per-rank launches {exp} on every rank [{smi}]")
    print(f"(b) FedZO train step on the sharded tree (b2 2, mu "
          f"{PROD_MU:g}): {lm['train_step_ms']:.1f} ms, "
          f"{2 * 2 * est['n_leaves']} zo_axpy a rank; loss differences "
          f"{[round(u) for u in est['diff_ulps']]} ulps, coefficients "
          f"{[f'{c:.4e}' for c in est['coeffs']]} (max err / tol "
          f"{est['max_err_over_tol']:.3f}); tree_axpy2 bitwise [{smi}]")
    fa = lm["fedavg"]
    frel = abs(fa["loss"] - fa["one_rank_loss"]) / fa["one_rank_loss"]
    check(frel <= PROD_LOSS_REL, f"sharded FedAvg loss {fa}")
    check(fa["err"] <= PROD_STEP_ATOL, f"sharded FedAvg step {fa}")
    check(fa["moved"] >= 10 * PROD_STEP_ATOL, f"FedAvg step moved no "
          f"weight by 10 x {PROD_STEP_ATOL}: {fa}")
    print(f"(b) FedAvg step on the sharded tree (lr {PROD_LR:g}): "
          f"{lm['fedavg_step_ms']:.1f} ms, loss {fa['loss']:.6f} (one rank "
          f"{fa['one_rank_loss']:.6f}, rel {frel:.1e}); max |updated leaf - "
          f"one rank's| {fa['err']:.3e} (atol {PROD_STEP_ATOL}), largest "
          f"move of a weight {fa['moved']:.3e}; per-rank launches "
          f"{exp['loss']} in its forward, no ZO kernel [{smi}]")
    print(f"(b) kernels at the local shards' shapes {res['kernel_shapes']}: "
          f"worst relative error {res['worst_local']} [{smi}]")
    # (c) the dry-run on the fake group, in this process
    for item in dry:
        if isinstance(item, BaseException):
            raise item
    check(len(dry) == len(PROD_DRYRUN), f"dry-run cases: {dry}")
    for rec, took_s in dry:
        arch, shape = rec["arch"], rec["shape"]
        keep = {k_: rec[k_] for k_ in (
            "arch", "shape", "mesh", "n_params", "n_active_params", "memory",
            "hlo_flops_per_device", "hlo_bytes_per_device",
            "collective_bytes_per_device", "collective_counts", "roofline_s",
            "dominant_term", "useful_flops_ratio", "hbm_ok", "kernel_calls",
            "compile_s")}
        if "delta_agg_program" in rec:
            keep["delta_agg_program"] = rec["delta_agg_program"]
        check(rec["hlo_flops_per_device"] > 0
              and rec["memory"]["total_bytes_per_device"] > 0,
              f"dry-run {arch} {shape}: {rec}")
        print(f"(c) dry-run {arch} x {shape} x {rec['mesh']} "
              f"({rec['algo']}) "
              f"({took_s:.1f} s, beside the ranks; H100 data-sheet peaks): "
              f"{json.dumps(keep)} [{smi}]")
    took = time.perf_counter() - t_phase
    print(f"production mesh: {took:.1f} s of the {PROD_BUDGET_S:.0f} s "
          f"budget [{smi}]")
    return total


def profile_call(torch, fn, out_dir, tag, timeline=True):
    """torch.profiler trace of one ``fn()`` after a warm-up call: kernel
    time by name and the device busy share (kernel time over wall time),
    written to ``out_dir/<tag>_profile.txt`` and, with ``timeline``, the
    chrome trace ``<tag>_trace.json`` (left out for calls of hundreds of
    thousands of launches, whose trace is larger than the run may bring
    back)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(out_dir, exist_ok=True)
    if timeline:
        prof.export_chrome_trace(os.path.join(out_dir, f"{tag}_trace.json"))
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=25)
    with open(os.path.join(out_dir, f"{tag}_profile.txt"), "w") as f:
        f.write(table)
    # kernels are the events on the CUDA device; aten ops on the CPU carry a
    # copy of their kernels' time and are left out so nothing counts twice
    device_us = sum(e.self_device_time_total for e in avgs
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"profile {tag}: wall {wall * 1e3:.3f} ms, kernel time "
          f"{device_us / 1e3:.3f} ms, device busy share "
          f"{device_us / 1e3 / (wall * 1e3):.3f}")
    # the port's own kernels, which the table may leave below its cut
    for e in avgs:
        if e.device_type == torch.autograd.DeviceType.CUDA and any(
                k in e.key for k in PORT_KERNELS):
            print(f"profile {tag}: {e.key[:72]}: "
                  f"{e.self_device_time_total / 1e3:.3f} ms in {e.count} "
                  f"launches")
    print(table)


def profile_round(torch, neural, FedZOConfig, out_dir):
    """One softmax round (no eval) under the profiler, on each route."""
    task = neural.make_task("softmax", n_features=784, n_classes=10,
                            n_clients=50)
    cfg = FedZOConfig(flat_params=True, weight_by_size=True)
    profile_call(torch, lambda: neural.run(task, cfg, 1, eval_every=0),
                 out_dir, "softmax_round")
    cfg = FedZOConfig(weight_by_size=True)
    profile_call(torch, lambda: neural.run(task, cfg, 1, eval_every=0),
                 out_dir, "softmax_pytree_round", timeline=False)


def profile_pytree_step(torch, FedZOConfig, out_dir):
    """One pytree Qwen2-0.5B train step (the CLI's configuration) under the
    profiler: kernel time by name and the busy share."""
    import numpy as np
    from repro_torch.core import fedzo
    from repro_torch.utils import prng

    model, toks = lm_setup("qwen2-0.5b", "float32")
    params = model.init(prng.key(0), device="cuda")
    step = fedzo.make_train_step(model.loss, FedZOConfig(
        lr=1e-4, mu=1e-3, b2=QWEN_B2))
    batch = lm_batch(torch, toks, np.random.default_rng(0), 4, 128, "cuda")
    profile_call(torch, lambda: step(params, batch, prng.key(2)), out_dir,
                 "qwen2_pytree_step", timeline=False)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile a softmax round and a Qwen2-0.5B "
                    "train step on each route into DIR")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        die("chip_smoke: no CUDA device; this script runs the port on a GPU")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        die("chip_smoke: src/repro_torch not found; run from a checkout")
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.base import FedZOConfig
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import (flash_attention, rmsnorm, zo_aircomp,
                                     zo_axpy)
    from repro_torch.workloads import neural

    smi = smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    build.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_LOG.get('seconds', 0.0):.1f} s)")
    spills = []
    for src, log in build.BUILD_LOG.items():
        if src != "seconds":
            for line in log.splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    print(f"ptxas {src}: {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if m and int(m.group(1)):
                    spills.append(f"{src}: {line.strip()}")
    print(f"ptxas spills: {spills or 'none'}")

    def timed(name, fn):
        """Run one phase, free its cached blocks, print its time."""
        t = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s")
        return out

    rows = timed("kernels", lambda: check_kernels(torch, ops, zo_axpy,
                                                  zo_aircomp))
    rows.update(timed("lm kernels", lambda: check_lm_kernels(
        torch, ops, rmsnorm, flash_attention)))
    for name, f in timed("full width", lambda: check_full_width(
            torch, ops, zo_axpy, zo_aircomp)).items():
        rows[name]["full_width"] = f
    rows.update(timed("axpy kernels", lambda: check_axpy_kernels(
        torch, ops, zo_axpy)))
    launches = timed("rounds", lambda: run_main_path(torch, ops, neural,
                                                     FedZOConfig))
    for k, n in timed("transformer and wide rounds", lambda: run_track_rounds(
            torch, ops, neural, FedZOConfig)).items():
        launches[k] += n
    for name, phase in (
            ("qwen flat", lambda: run_qwen_train(torch, ops, FedZOConfig,
                                                 profile_dir=args.profile)),
            ("qwen flat round", lambda: run_qwen_flat_round(
                torch, ops, FedZOConfig)),
            ("tree_axpy2", lambda: run_tree_axpy2(torch, ops, zo_axpy)),
            ("qwen pytree cli", lambda: run_qwen_pytree_cli(torch, ops))):
        for k, n in timed(name, phase).items():
            launches[k] += n
    timed("references", lambda: (
        check_small_reference(torch, neural, FedZOConfig),
        check_pytree_small_reference(torch, neural, FedZOConfig),
        check_lm_small_reference(torch, FedZOConfig),
        check_lm_small_reference(torch, FedZOConfig, flat_params=False),
        check_lm_round_small_reference(torch, FedZOConfig),
        check_bf16_draws(torch),
        *(check_track_small_reference(torch, ops, neural, FedZOConfig, route)
          for route in ("flat", "pytree", "pytree bf16 sphere",
                        "pytree bf16 gaussian", "wide"))))
    for k, n in timed("algorithms and uplinks", lambda: run_algorithms(
            torch, ops, neural, FedZOConfig)).items():
        launches[k] += n
    _, counts = timed("faults, channel and durability",
                            lambda: run_faults_channel(torch, ops, neural,
                                                       FedZOConfig))
    for k, n in counts.items():
        launches[k] += n
    timed("faults references", lambda: check_faulted_reference(
        torch, neural, FedZOConfig))
    for k, n in timed("tiered, hypertune and kernel timing",
                      lambda: run_tiered_hypertune(torch, ops,
                                                   FedZOConfig)).items():
        launches[k] += n
    rows["philox_bits"], counts = timed(
        "fast strategy and batched sweeps",
        lambda: run_fast_strategy(torch, ops, neural, FedZOConfig, smi))
    for k, n in counts.items():
        launches[k] += n
    for k, n in timed("serve and sharded rounds", lambda: run_serve_sharded(
            torch, ops, neural, FedZOConfig, smi, rows)).items():
        launches[k] += n
    for k, n in timed("moe serving", lambda: run_moe_serving(
            torch, ops, FedZOConfig, smi, rows)).items():
        launches[k] += n
    for k, n in timed("moe cohort, ssm and hybrid", lambda: run_cohort_ssm(
            torch, ops, FedZOConfig, smi, rows)).items():
        launches[k] += n
    for k, n in timed("encdec, vlm and the ssm cohort",
                      lambda: run_xattn_ssm_cohort(
                          torch, ops, FedZOConfig, smi, rows)).items():
        launches[k] += n
    for k, n in timed("encdec and vlm cohort, strategy sweeps",
                      lambda: run_xattn_cohort_sweeps(
                          torch, ops, FedZOConfig, smi, rows)).items():
        launches[k] += n
    for k, n in timed("production mesh", lambda: run_production_mesh(
            torch, ops, FedZOConfig, smi, rows)).items():
        launches[k] += n
    if args.profile:
        timed("profiles", lambda: (
            profile_round(torch, neural, FedZOConfig, args.profile),
            profile_pytree_step(torch, FedZOConfig, args.profile)))
    print(f"total: {time.perf_counter() - t0:.1f} s")

    kernels = []
    for name in ("zo_walk", "zo_replay", "zo_dirnorms", "aircomp_reduce",
                 "zo_axpy2", "zo_axpy", "rmsnorm", "flash_attention",
                 "philox_bits"):
        check(launches[name] > 0, f"{name} never launched on the main path")
        kernels.append({"name": name, "route": "cuda", **rows[name],
                        "launches": launches[name]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
