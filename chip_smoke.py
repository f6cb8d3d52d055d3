#!/usr/bin/env python3
"""Drives the PyTorch port on one NVIDIA card and checks it end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result lines:

1. build   - compiles the Hopper kernels (csrc/fused_norm.cu) with nvcc for
             sm_90a; prints the build seconds and the card's name and power
             limit.
2. kernels - runs the forward (``bn_stats_act``, and ``bn_stats`` alone)
             and the backward (``bn_act_bwd``, directly and through
             ``FusedBNLeakyReLU``, from the Function's saved statistics) at
             the shapes the flagship serve path gives them (4 tasks x 64
             filters folded into 256 channels; support N=5 and query N=15
             at the 28, 14, 7 and 3 pixel stages), at those of the train
             path (8 tasks, 512 channels, N=5) and at the north-star
             support and target shapes of every normed stage (25|75, 96,
             84|42|21|10); both also on their streamed path, forced, at
             (25, 96, 84, 84).
             Holds forward y/mean/var and backward dx/dgamma/dbeta to the
             plain PyTorch version, each kernel's two calls, the forward's
             two entries' statistics and the backward's two routes to each
             other bitwise, and times each kernel beside its plain version,
             its bound and the library yardsticks, with its launch plan.
             The same at the north star's serve shapes (4 tasks x 48
             filters folded into 192 channels, N=25|15, at 84, 42, 21 and
             10 pixels). The same at ResNet-12's fused sites at its LeakyReLU slope
             0.1 (train and eval: 8 tasks x 64|128|256|512 filters, N=5, at
             28|14|7|3 pixels, up to 4096 channels of 45 rows; serve: 4
             tasks, N=5|15) and at the stride-2 VGG's (5, 512, 4|2).
   pool    - K5 (``bn_act_pool_apply``) against ``plain_pool_apply`` at the
             train path's pooled stages (5, 512, 28, 28) and (5, 512, 14,
             14) and at the north star's (25|75, 96, 84|42|10); the same
             timings.
   functions - the any-order Functions on the card: forward, first-order
             gradients of a loss over y, mean and var, and the
             reverse-over-reverse composition, against the plain
             composition differentiated by autograd, at (5, 512, 28, 28)
             (pooled) and (5, 512, 7, 7) (any order).
3. serve   - the MAML++ Omniglot flagship config with
             use_pallas_fused_norm=True, random weights from a seed: a
             ServingEngine(meta_batch_size=4) serves 32 binary-image
             episodes of bucket 5x1x15 (one support set repeated, so one is
             a cache hit). The launch counts are zeroed just before and
             read just after; each kernel must have run as often as the
             path calls it (per dispatch: bn_stats_act 24, bn_act_bwd 20,
             bn_stats 0). Logits must be
             finite, the same when served again, and match a
             use_pallas_fused_norm=False engine on the same state (the
             tolerances below say how).
4. train   - the same flagship config with fused_norm_train=True and
             fused_norm_pool=True (remat_inner_steps=False), learner from
             seed 104: 10 second-order ``run_train_iter`` at epoch 0 on one
             synthetic binary batch of 8 tasks, 5-way 1-shot, 1 target per
             class, each a replay of the step's CUDA graph (captured in a
             warm-up call), with the launch counts zeroed just before and
             read just after. A replay runs no kernel wrapper: the graph
             keeps the launches its capture recorded (per iteration
             bn_stats 20, bn_stats_act 20, K5 20), and the run's launches
             are those times its replays, the wrappers' counts staying 0.
             The kernel nodes of each graph, read from the driver (a
             replay launches every node), must be the launches its capture
             recorded (so in the graph and CLI phases). Losses finite and
             falling; a rerun from the same state bitwise equal; the first
             loss and meta-gradient against a plain-norm learner on the
             same state; one past-horizon iteration's launches; one
             ``run_validation_iter`` with finite logits.
   resnet serve - the same on the Omniglot ResNet-12 JSON, random weights
             from seed 104 (per dispatch bn_stats_act 48, bn_act_bwd 40,
             bn_stats and K5 0); ResNet-12 from random weights is chaotic
             through its inner steps, so whole episodes are held to the
             plain engine as SENSITIVITY_* says, classify alone to the
             CLASSIFY bar.
   serve http - the flagship JSON (use_pallas_fused_norm) behind
             ``make_http_server`` on an ephemeral loopback port with
             ``ServeConfig`` defaults (meta-batch 4, a 2 ms window):
             ``/healthz`` 503 before the 5x1x15 warmup and 200 after; 31
             episodes POSTed from 4 client threads, then a repeat of
             episode 0's support set, which alone must hit the cache.
             Launches held exactly to the dispatches the metrics counted
             (per dispatch that adapts a miss bn_stats_act 24, bn_act_bwd
             20; per dispatch that only classifies 4 and 0); logits held to
             the plain-norm engine at the serve bars, classify alone to the
             CLASSIFY bar, and bit for bit to a fresh engine's dispatch in
             groups of 4 (an episode's bits do not depend on its batch
             mates); ``/admin/promote`` of a checkpoint the port saved bumps
             ``state_version``, a corrupt copy answers 409 and the promoted
             state's logits stay bitwise the same; ``/metrics`` scraped for
             the adapt, classify and request p50 and p99.
   serve cli - ``python3 -m howtotrainyourmamlpytorch_tpu_torch.serve_maml``
             on the flagship JSON (``--use_pallas_fused_norm True
             --init_from_scratch --port 0 --port_file --warmup 5x1x15``) as
             a subprocess: it names its port, answers /healthz and one
             episode, and exits 0 on SIGTERM. It runs beside
             [control_plane]'s second trainer process.
   serve api north star - the north-star JSON (use_pallas_fused_norm)
             through ``ServingAPI``, warmed at 5x5x15: 8 episodes of 84x84
             RGB from 4 threads, launches held exactly as above; from
             random weights the north star's inner loop is chaotic at the
             serve bars, so whole episodes are held to the plain engine as
             SENSITIVITY_* says, classify alone to the CLASSIFY bar, and
             bit for bit to a fresh engine.
   serve pool - the supervised replica pool and the durable tier at the
             flagship's full width (meta-batch 4, fused norm, warmed at
             5x1x15). Part 1: two worker processes of ``serve_maml`` (each
             with its CUDA context and its tier) under ``ReplicaPool`` with
             digest routing behind ``make_http_server``; worker 0's first
             spawn armed with replica_kill_at_request=3, worker 1's with
             wedge_replica_at_request=6 (POOL_FAULTS); 32 episodes, 8 of
             them repeated support sets, from up to 4 loopback clients in
             the order the ring makes deterministic: no failed request, 2
             deaths, 2 restarts, a retry, each answer held to one
             in-process engine (bitwise, else the serve bars); seconds from
             each fault to HEALTHY and the wedge's detection; the respawned
             worker 0 answers a support set it cached before its death from
             its rehydrated spill (launches 4/0), its kernel library from
             the executable cache, no nvcc build; a corrupt promote's 409
             with no worker touched, a good one's 200 with worker 0 swapped
             first; no worker left. ``serve_maml --replicas 2`` as a command
             line, started after Part 1 so that it boots beside Part 2: one
             episode, exit 0 on SIGTERM, no worker left.
             Part 2, in process: a LocalReplica pool of two engines with
             tiers: launches per cache-miss (24/20), RAM-hit and spill-hit
             (4/0) dispatch held exactly; /admin/scale 2 -> 3 -> 2; the
             port's load test at POOL_LOADTEST_QPS with a kill (the verdict
             must pass, no error); a stale executable-cache fence rebuilt
             with nvcc, the logits unchanged. The live workers' kernel
             shapes join [coverage].
   graph   - the flagship and north-star learners with remat on, as the
             CLIs train, from one state over 3 batches: ``run_train_iters``
             (K=3 replays of the captured step) against 3 eager
             ``_train_step`` bit for bit (state, Adam moments, per-iteration
             loss, accuracy, nonfinite) at epoch 0, at epoch 1 (the same
             graph, another learning rate and importance vector) and at
             epoch 2 (past an MSL horizon of 2: the final-only graph); a
             state held from before each dispatch unchanged; every kernel
             launch captured on the capture's stream; the captures'
             launches held to the CLI's per-iteration counts and to the
             kernel nodes of each graph. Prints, per
             width, capture ms per branch and, over TIMING_REPEATS (1)
             repeats, replay and
             eager ms per iteration. (The north star's learning rate is
             constant in its config; the phase lowers its floor to move it.)
   remat   - remat_inner_steps on, as the CLI trains, at flagship width
             (the train phase's batch) and at north-star width (2 tasks, 5
             support and 15 target 84x84 RGB images a class): the fused
             learner's first loss and meta-gradient bitwise equal to its
             own without remat, and held to the plain-norm learner's under
             the train phase's tolerances.
   resnet graph - the ResNet-12 learner from its JSON with the three fused
             flags and remat on, through the graph phase's checks at K=3
             (GRAPH_PHASE_ITERS) and one timing repeat (captured
             launches per iteration bn_stats_act 200 MSL, 128 final-only;
             bn_stats and K5 0) and the remat phase's, its first loss and
             meta-gradient held to the plain-norm learner's as
             SENSITIVITY_* says; capture, replay and eager ms and the peak
             memory.
   backbone options - the flagship JSON with max_pooling False (stride-2
             convs, the fused norm unpooled, a global average pool),
             norm_layer layer_norm and block_order norm_conv (no fused
             site), remat off: one first second-order step against the
             plain-norm learner (the train phase's bars where the kernels
             run, bitwise where none does) and one run_validation_iter
             with finite logits; their launches held exactly.
5. cli flagship - the training command line
             (``train_maml_system.main``, in this process) on the flagship
             JSON with the three fused flags, over a synthetic Omniglot-shaped
             tree of 250 classes x 20 binary 28x28 PNGs (a made-up
             dataset_name, so it is not count-checked), an MSL horizon of 2
             epochs: 2 epochs of 10 iterations with 8 validation tasks and
             the ensemble test, then ``--continue_from_epoch latest`` to 3
             epochs (past the horizon: the final-only graph), then to 4 with
             ``--iters_per_dispatch 5``, then to 5 at K=5 and to 6 at K=1
             with ``--device_prefetch 0`` (no stager). Each call returns;
             the CSV has 6 rows, every loss is finite, the test accuracy is
             in [0, 1] and the resumed runs start at iterations 30, 45, 60
             and 75. Launches of each kernel per train iteration (counted
             at capture, times the replays; each graph's kernel nodes
             agree) and per eval iteration are held exactly
             (remat_inner_steps on, the config default). The first call
             synchronizes after each learner call, for per-step times; the
             resumed ones run as the CLI does, for the whole loop's rate at
             K=1 and at K=5, with the prefetcher at auto depth and off.
6. cli north star - the same on the mini-ImageNet north-star JSON
             (84x84x3, 48 filters, 2 tasks 5-way 5-shot, 15 targets) over a
             pre-split tree of 64/16/20 classes x 20 RGB PNGs (600 images a
             class cut to 20), an MSL horizon of 1 epoch: 1 epoch of 6
             iterations, 10 evaluation tasks, the ensemble
             over the one
             model, then ``latest`` to 2 epochs, to 3 at K=5, then to 4
             at K=5 and to 5 at K=1 with ``--device_prefetch 0``.
             Both CLI phases print, per step, meta-iterations/s and step p50
             over the synchronized iterations after the first two of a call
             and the share of that time the loop spent blocked on its input;
             for the whole loop, each unsynchronized call's train iterations
             over its train loop's wall time, capture and epoch boundaries
             included, and the seconds it waited for its input, at K=1 and
             at K=5, prefetcher on and off; peak
             device memory, the validation and test accuracy and the
             launches. Phases 3-9 (the serve CLI's subprocess aside) record every kernel call's input shape
             and LeakyReLU slope (a replay runs no wrapper; its calls are
             those of its capture); each (shape, slope) must be one the
             kernel and pool phases held to the plain version.
7. zoo plain - gradient descent, matching nets (their published JSONs),
             ANIL and ProtoNets (the flagship's) with the three fused flags
             against their plain-norm twins from the same weights on the
             train phase's batch: the first update's loss and gradient
             (gradient descent's first support step of task 0, matching
             nets' task 0, ANIL's and ProtoNets' first train step) under
             the train phase's tolerances.
8. cli zoo - each zoo learner's entry point (``train_<learner>_system.main``)
             with the three fused flags on one flagship-width Omniglot tree
             (written once): 2 epochs of 4 iterations,
             synchronized after
             each learner call, 8 evaluation tasks and
             the ensemble, then
             ``latest`` to a 3rd epoch as the CLI runs (gradient descent at
             ``--iters_per_dispatch 5``, which it does not act on; ANIL past
             an MSL horizon of 2). Launches per train and eval iteration
             held exactly to ``CLI_GD_*``, ``CLI_MATCHING_NETS_*``,
             ``CLI_ANIL_*`` and ``CLI_PROTONETS_*``
             (tests/test_torch_zoo_launches.py counts them on the CPU);
             ``bn_act_bwd`` runs on the train path of the three learners
             without an inner loop. Each prints the lines of the CLI phases
             above and the eval ms per iteration. ANIL's captured graphs
             are held to their kernel nodes as MAML's are.
9. cli resnet12 - train_maml_system.main on the ResNet-12 JSON with the
             three fused flags over the zoo's Omniglot tree: 2 epochs of 4
             iterations (synchronized), 24 evaluation tasks and the
             ensemble, then ``latest`` to a 3rd epoch at
             ``--iters_per_dispatch 5`` past an MSL horizon of 2; launches
             per train and eval iteration held to CLI_RESNET12_*
             (tests/test_torch_resnet.py counts them on the CPU).
   kernels_bf16 - (after the functions phase) all four kernels on
             bfloat16 x and cotangent at the bf16 flagship's shapes (5, 512,
             28|14|7|3), K5 at the pooled two, against their bfloat16 plain
             versions on the same inputs and statistics: mean and var within
             1e-5 of the plain ones' largest value, y, dx and the pooled y
             per element within one bfloat16 ulp (+ 1e-5 near 0) with a
             median gap of 0, dgamma and dbeta at the float32 bar; graph
             replay times against bounds at 2-byte I/O.
10. compute options - the MAML learner's options, on the Omniglot tree of
             phase 8:
             graph bf16: the graph phase on the bf16 flagship JSON
             (``experiment_config_local/omniglot_maml++-omniglot-bf16_1_8_0.1_64_5_1.json``)
             with ``compute_dtype`` bfloat16: replays bitwise equal to eager
             steps on both branches, kernel nodes held to the flagship's
             counts. cli bf16: ``train_maml_system.main`` on that JSON with
             the three fused flags, first at ``--compute_dtype float32`` (2
             epochs of 10 iterations), then at ``bfloat16``:
             2 epochs of 10 with 16 validation tasks and the ensemble,
             ``latest`` to a 3rd epoch at K=1 and a 4th at K=5; launches per
             iteration the flagship's, the first 20 losses finite and within
             JAX's bf16
             bar (rtol 0.1, atol 0.05) of the float32 run's. device augment:
             the flagship CLI with ``--device_augment True`` against host
             rotation, 3 replayed iterations and the checkpoint bitwise
             equal. task chunk: the flagship at ``task_chunk`` 2 and 4, the
             north star at 1, each against its full batch from one state:
             the first loss within 1e-5 relative, the meta-gradient at the
             GRAD bar, a K=3 dispatch's losses within 1e-5, launches per
             replay the full batch's per chunk, peak memory of each. lane
             pad: the north star at ``lane_pad_channels`` (48 -> 64)
             against unpadded from the same weights: served episodes and
             eval logits within twice the unpadded engine's one-ulp spread
             (chaotic from random weights), the first step under the train
             phase's tolerances with a zero gradient on the padding, replay
             ms and launches, a padded checkpoint into an unpadded learner
             and back bit for bit. Every (shape, slope, dtype) a kernel ran
             at is in ``[coverage]``, and each kernel must have run in
             bfloat16 on a main path.
11. chaos  - the training CLI's operations plane on CHAOS_CONFIG (the
             flagship JSON) at full width with the three fused flags, on
             the tree of phase 8 (3 epochs of 4 iterations, 8 evaluation
             tasks, watchdog_min_s CHAOS_WATCHDOG_MIN_S): an unfaulted twin
             (in another process, beside the rollback and OOM checks below
             and the supervised run's first phase), and one supervised run
             of enospc,sigterm,kill,hang through
             ``train_maml_system_dispatch`` (``chaos_train.run_chaos``):
             phases exit 75, killed, 76, 0; the final train_model_latest
             and summary_statistics.csv (its wall-clock columns aside)
             equal the twin's bit for bit; train_recovery_s per class. In
             this process: a NaN batch under ``--on_nonfinite rollback``
             (the restored iteration, the first replay after the rollback
             bitwise equal to an eager step from the restored state, no new
             capture, finite losses to the end); ``oom_at_iter`` (a real
             torch.OutOfMemoryError, exit 77, oom_report.json with the
             card's memory); the CLI's per-step p50 with telemetry and the
             watchdog off, then on (1 epoch of 12), and a resumed epoch with
             them on in which every train dispatch between boundaries runs
             under ``torch.cuda.set_sync_debug_mode`` with no
             synchronisation.
   control plane - the serving control plane (``[control_plane]``) at
             the flagship's width, fused: the promote loop
             (``chaos_train.run_promote_chaos``: a trainer process killed
             mid-publish and resumed, two in-process replicas behind the
             HTTP front door under the load test, the promotion daemon in
             its own process with a corrupt candidate, SIGKILLed after its
             first promotion and restarted, a regressing last candidate
             rolled back) with, beside its first trainer process, the
             autoscale loop (``run_autoscale_chaos``: the autoscaler in its
             own process killed with a scale-up journaled; thresholds from
             latencies probed here; a replica killed under cache hits), and
             serve cli beside the second. After each promotion and the
             rollback ``/healthz``
             names the staged file and 4 answers equal a fresh engine's on
             it bit for bit; launches equal 24/20 per cache-miss dispatch,
             warmup or canary and 4/0 per hit; neither daemon holds
             ``/dev/nvidia*`` open; the promote loop mines at least one hard
             episode from its serving telemetry.
   feedback - the hard-episode loop and the operations toolkit: the
             promote loop's serving telemetry mined into a replay manifest
             (``python3 -m howtotrainyourmamlpytorch_tpu_torch.episode_miner
             --max-margin 1.0 --top 64``); in this process, on the host, the
             first 3 train batches of the spawned ``process`` loader bitwise
             equal to the thread loader's on that manifest, every replay
             slot's episode ``get_set(seed=<mined seed>)``'s; the flagship
             CLI (CHAOS_CONFIG, fused) on the manifest with the process
             backend and telemetry on, 1 epoch of 6 iterations and 8
             validation tasks, launches per train and eval iteration held as
             in cli flagship, losses finite; ``telemetry_report`` on the run
             (text and ``--json``: its step samples, the config fingerprint
             on every step event and in status.json, the captured train
             programs in the device section); the overhead bench at
             flagship width (``--overhead-bench --budget-s 2 --windows 3``,
             in this process), its ``telemetry_overhead_pct`` printed
             beside the card's name and power limit. Also: serve pool's in-process part runs under the
             port's lock sanitizer (no cycle, every serve hold under 2.0 s),
             and serve http's ``/metrics`` holds a ``maml_serve_program_flops``
             row above 0 for each warmed bucket's adapt and classify.
   fleet  - (run after control plane, before feedback) data-parallel
             meta-training across processes, on the same tree: the flagship (CHAOS_CONFIG, fused, 2 epochs of 4, K=2, 8
             validation tasks) as a two-rank fleet through the port's
             dispatcher (``--num_processes 2``), both ranks on this card
             over gloo (NCCL refuses two ranks on one device), each rank's
             step split at the reduction (graph A, all-reduce, graph B),
             against one process with ``--task_chunk 4``: theta, LSLR and
             the Adam moments of train_model_latest bitwise, the BN state
             at the CPU test's bar, each rank's launches per replay equal
             to the chunked run's per chunk, step events and a heartbeat
             per rank, rank 0 the only checkpoint writer; each rank's and
             the chunked run's meta-iterations/s and the reduction's ms per
             meta-update. A one-rank nccl group in this process, while
             the fleet's ranks start: ``fused_psum`` of the flagship's
             gradients bitwise its input, one all-reduce per dtype. The
             kill-host loop (``chaos_train.run_killhost_chaos``: rank 1
             SIGKILLed at iteration 3, the dispatcher resumes on one
             process) at flagship width, 3 epochs of 2, beside
             [feedback], [task_chunk] and [lane_pad]: its verdict ok and
             ``multihost_recovery_s``.
12. result - a [replay] line with each captured graph's kernel nodes, each
             phase's seconds, one JSON line listing the kernels (with their
             bfloat16 ms, bound, largest error and ulps, launches in the
             bf16 CLI, and launches per rank per iteration in [fleet]), the
             nvidia-smi line, and the last line
             ``{"ok": true, "device": {...}}``.

Imports nothing of JAX; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(
    REPO, "experiment_config", "omniglot_maml++-omniglot_1_8_0.1_64_5_0.json"
)
NORTH_STAR = os.path.join(
    REPO, "experiment_config", "mini-imagenet_maml++-mini-imagenet_5_2_0.01_48_5_0.json"
)
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and non-tensor float32 rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Norm-wise tolerance of a kernel against its plain version:
# max|kernel - plain| <= ATOL + RTOL * max|plain|. Reductions over up to
# 176,400 elements are summed in another order than PyTorch's; elementwise
# outputs differ by rsqrtf and fused multiply-add rounding.
RTOL, ATOL = 1e-4, 1e-5
# Served logits, fused-kernel engine against the plain-norm engine, both in
# float32 with TF32 off and deterministic cuDNN; their batch statistics
# differ in rounding (shifted single pass against two-pass).
# - Classify alone, on the same adapted weights: a forward pass, continuous
#   in its inputs. Measured 3.6e-6 against logits up to 6.9.
CLASSIFY_RTOL, CLASSIFY_ATOL = 1e-4, 1e-4
# - Whole episodes: the inner gradient routes through LeakyReLU branches and
#   max-pool argmaxes, and where two values lie within rounding of each
#   other the two versions can route differently; five inner steps carry
#   such a flip into the logits. Measured on an H100: 1 of 32 episodes
#   moved by 1.03e-2, the rest stayed within 1e-4. So the median episode
#   must agree to EPISODE_MEDIAN_ATOL and every episode to EPISODE_MAX_ATOL.
EPISODE_MEDIAN_ATOL, EPISODE_MAX_ATOL = 1e-4, 5e-2

# Meta-gradient of the fused train step against the plain-norm learner's,
# per leaf: max|fused - plain| <= GRAD_ATOL + GRAD_RTOL * max|plain|. Where
# a LeakyReLU branch or a pool argmax routes differently (two values within
# rounding, see the serve tolerances above) a leaf may move further; it is
# printed with its gap and held to ROUTING_RTOL * max|plain|.
GRAD_RTOL, GRAD_ATOL, ROUTING_RTOL = 1e-3, 1e-5, 5e-2
TRAIN_LOSS_RTOL = 1e-4
# ResNet-12 from random weights is chaotic through its 5 inner steps at
# rate 0.1: the plain-norm path alone, its weights moved by one unit in
# the last place, moves served logits by a median 1.65 (of up to 96) and
# the first train loss by 3.5e-3 relative (this script on an NVIDIA H100
# 80GB HBM3, PERF.md §6), so the bars above cannot separate the kernels
# from rounding there.
# On ResNet-12 the fused path's gap to the plain path is held to
# SENSITIVITY_FACTOR times the plain path's own gap under such a move
# (the largest over SENSITIVITY_SEEDS draws), or to the bar above where
# that is larger; the kernels themselves are held to their plain versions
# at every ResNet shape and slope in the kernel phase, and classify alone
# (a forward pass) to the CLASSIFY bar.
SENSITIVITY_FACTOR, SENSITIVITY_SEEDS = 2.0, (1, 2)
TRAIN_ITERS = 10

FLAGSHIP_SHAPES = [
    (n, 256, hw, hw) for n in (5, 15) for hw in (28, 14, 7, 3)
]
# The train path: 8 tasks x 64 filters folded into 512 channels, N=5 for
# the support and the target set alike.
TRAIN_SHAPES = [(5, 512, hw, hw) for hw in (28, 14, 7, 3)]
NORTH_STAR_SHAPE = (25, 96, 84, 84)
# The north-star target set: 15 queries x 5 classes, 2 tasks folded.
NORTH_STAR_TARGET = (75, 96, 84, 84)
# The north star's later stages as the CLI gives them (support N=25,
# target N=75, 2 tasks x 48 filters): 42 and 10 pooled, 21 not.
NORTH_STAR_STAGES = [(n, 96, hw, hw) for n in (25, 75) for hw in (42, 21, 10)]
# Both kernels forced onto their streamed path (the backward takes it at
# NORTH_STAR_TARGET; the forward at no shape of the repo).
STREAMED_SHAPE = NORTH_STAR_SHAPE
# One task of 64 filters, N=5: the gradient-descent and matching-nets
# learners train task by task (and gradient descent evaluates so).
ZOO_SHAPES = [(5, 64, hw, hw) for hw in (28, 14, 7, 3)]
# The north star served at meta-batch 4 (bucket 5x5x15): 4 tasks x 48
# filters folded into 192 channels, support N=25 and query N=15 at the
# 84, 42, 21 and 10 pixel stages (the one-level op, pool separate).
NORTH_STAR_SERVE_SHAPES = [(n, 192, hw, hw) for n in (25, 15) for hw in (84, 42, 21, 10)]
# The VGG without max pooling (stride-2 convs, the flagship's width): 8
# tasks x 64 filters at 14, 7, 4 and 2 pixels, none pooled.
STRIDE2_SHAPES = [(5, 512, hw, hw) for hw in (14, 7, 4, 2)]
# The task_chunk phase's chunks: the flagship's 8 tasks 2 and 4 at a time
# (2|4 tasks x 64 filters folded; 256 channels are the serve shapes'), the
# north star's 2 tasks one at a time (48 channels).
CHUNK_SHAPES = ([(5, 128, hw, hw) for hw in (28, 14, 7, 3)]
                + [(n, 48, hw, hw) for n in (25, 75) for hw in (84, 42, 21, 10)])
# The north star lane-padded, 48 -> 64 filters: 2 tasks fold 128 channels
# in training and eval, 4 fold 256 served at meta-batch 4 (the lane_pad
# phase serves through the pooled op, so the unpadded 192 channels run K5
# too).
PADDED_SHAPES = [(n, 128, hw, hw) for n in (25, 75) for hw in (84, 42, 21, 10)]
PADDED_SERVE_SHAPES = [(n, 256, hw, hw) for n in (25, 15) for hw in (84, 42, 21, 10)]
KERNEL_SHAPES = (FLAGSHIP_SHAPES + TRAIN_SHAPES + [NORTH_STAR_SHAPE, NORTH_STAR_TARGET]
                 + NORTH_STAR_STAGES + ZOO_SHAPES
                 + [s for s in STRIDE2_SHAPES if s not in TRAIN_SHAPES]
                 + NORTH_STAR_SERVE_SHAPES + CHUNK_SHAPES + PADDED_SHAPES
                 + PADDED_SERVE_SHAPES)
# The VGG's LeakyReLU slope and ResNet-12's.
SLOPE, RESNET_SLOPE = 0.01, 0.1
RESNET12 = os.path.join(
    REPO, "experiment_config_local", "omniglot_maml++-omniglot-resnet12_1_8_0.1_64_5_1.json"
)
# ResNet-12's fused sites (conv0 and conv1 of each stage) at the Omniglot
# JSON's widths 64, 128, 256 and 512, at the stage inputs 28, 14, 7 and 3:
# train and eval fold 8 tasks (5 support and 5 target images), serve 4
# tasks (5 support, 15 queries).
RESNET_STAGES = tuple(zip((64, 128, 256, 512), (28, 14, 7, 3)))
RESNET_TRAIN_SHAPES = [(5, 8 * w, hw, hw) for w, hw in RESNET_STAGES]
RESNET_SERVE_SHAPES = [(n, 4 * w, hw, hw) for n in (5, 15) for w, hw in RESNET_STAGES]
# Every (shape, slope) the kernel phase holds bn_stats_act and bn_act_bwd
# to their plain versions at (bn_stats takes no slope; it is checked at
# every shape).
KERNEL_CASES = ([(s, SLOPE) for s in KERNEL_SHAPES]
                + [(s, RESNET_SLOPE) for s in RESNET_TRAIN_SHAPES + RESNET_SERVE_SHAPES])
POOL_SHAPES = [TRAIN_SHAPES[0], TRAIN_SHAPES[1], NORTH_STAR_SHAPE, NORTH_STAR_TARGET,
               *(s for s in NORTH_STAR_STAGES if s[2] % 2 == 0), *ZOO_SHAPES[:2],
               *(s for s in FLAGSHIP_SHAPES[:2] + CHUNK_SHAPES + PADDED_SHAPES
                 + NORTH_STAR_SERVE_SHAPES + PADDED_SERVE_SHAPES
                 if s[2] % 2 == 0 and s[2] > 3)]
# Launches of each kernel per serve dispatch of 4 episodes (4 stages x (5
# adapt steps + 1 classify) forwards, 5 x 4 backwards) and per flagship
# MSL train iteration (5 steps x support and target x 4 stages; stages 0-1
# pooled).
SERVE_LAUNCHES = {"bn_stats": 0, "bn_stats_act": 24, "bn_act_bwd": 20,
                  "bn_act_pool_apply": 0}
# A serve dispatch whose episodes all hit the adapted-params cache: the
# classify forward alone, one launch a stage.
SERVE_HIT_LAUNCHES = {"bn_stats": 0, "bn_stats_act": 4, "bn_act_bwd": 0,
                      "bn_act_pool_apply": 0}
TRAIN_LAUNCHES = {"bn_stats": 20, "bn_stats_act": 20, "bn_act_bwd": 0,
                  "bn_act_pool_apply": 20}
# The CLI phases (fused_norm_train, fused_norm_pool, use_pallas_fused_norm,
# remat_inner_steps on as the configs leave it). A train iteration: 5 inner
# steps x support and target over the pooled stages (bn_stats + K5) and the
# others (bn_stats_act), the checkpointed steps recomputing 1.5 of every 2
# forwards in the outer backward. An eval iteration: 5 support + 1 target
# forwards a stage, a bn_act_bwd for each inner gradient of an unpooled
# stage. Flagship stages 28, 14 pooled, 7, 3 not; north star 84, 42, 10
# pooled, 21 not.
CLI_FLAGSHIP_TRAIN = {"bn_stats": 50, "bn_stats_act": 50, "bn_act_bwd": 0,
                      "bn_act_pool_apply": 50}
CLI_FLAGSHIP_EVAL = {"bn_stats": 12, "bn_stats_act": 12, "bn_act_bwd": 10,
                     "bn_act_pool_apply": 12}
CLI_NORTH_TRAIN = {"bn_stats": 75, "bn_stats_act": 25, "bn_act_bwd": 0,
                   "bn_act_pool_apply": 75}
CLI_NORTH_EVAL = {"bn_stats": 18, "bn_stats_act": 6, "bn_act_bwd": 5,
                  "bn_act_pool_apply": 18}
# Past the MSL horizon (final-only, remat on): 5 inner steps of support
# forwards (each recomputed for the outer backward) and one target forward,
# 3.2 forwards a stage against MSL's 5 (counted from the Functions'
# forwards on the CPU).
CLI_FLAGSHIP_TRAIN_FINAL = {"bn_stats": 32, "bn_stats_act": 32, "bn_act_bwd": 0,
                            "bn_act_pool_apply": 32}
CLI_NORTH_TRAIN_FINAL = {"bn_stats": 48, "bn_stats_act": 16, "bn_act_bwd": 0,
                         "bn_act_pool_apply": 48}
# The learner zoo's CLI phases (the three fused flags): flagship width, the
# published gradient-descent and matching-nets JSONs, ANIL and ProtoNets on
# the flagship's. Each forward pass runs the pooled op at the 28 and 14
# pixel stages (bn_stats + K5) and the one-level op at 7 and 3
# (bn_stats_act), whose backward is bn_act_bwd. Gradient descent: per
# iteration, train and eval alike, 8 tasks in turn x (5 support + 1 target)
# passes of one task. Matching nets: in training 8 tasks in turn x a
# support and a target forward and their backward; in eval the 8 tasks
# folded, no backward. ProtoNets: the 8 tasks folded, a support and a
# target forward (and, in training, their backward). ANIL: MAML's step
# with the head alone adapted (remat on; counted from the Functions'
# forwards on the CPU, tests/test_torch_zoo_launches.py); its eval's
# head-only inner gradient reaches no norm.
GD_CONFIG = os.path.join(
    REPO, "experiment_config", "omniglot_gradient-descent-omniglot_1_8_0.1_64_5_1.json"
)
MATCHING_NETS_CONFIG = os.path.join(
    REPO, "experiment_config", "omniglot_matching-nets-omniglot_1_8_0.1_64_5_1.json"
)
CLI_GD_TRAIN = dict.fromkeys(("bn_stats", "bn_stats_act", "bn_act_bwd",
                              "bn_act_pool_apply"), 96)
CLI_GD_EVAL = CLI_GD_TRAIN
CLI_MATCHING_NETS_TRAIN = dict.fromkeys(CLI_GD_TRAIN, 32)
CLI_MATCHING_NETS_EVAL = {"bn_stats": 4, "bn_stats_act": 4, "bn_act_bwd": 0,
                          "bn_act_pool_apply": 4}
CLI_PROTONETS_TRAIN = dict.fromkeys(CLI_GD_TRAIN, 4)
CLI_PROTONETS_EVAL = CLI_MATCHING_NETS_EVAL
CLI_ANIL_TRAIN = {"bn_stats": 50, "bn_stats_act": 50, "bn_act_bwd": 0,
                  "bn_act_pool_apply": 50}
CLI_ANIL_TRAIN_FINAL = {"bn_stats": 32, "bn_stats_act": 32, "bn_act_bwd": 0,
                        "bn_act_pool_apply": 32}
CLI_ANIL_EVAL = {"bn_stats": 12, "bn_stats_act": 12, "bn_act_bwd": 0,
                 "bn_act_pool_apply": 12}
# ResNet-12 (the three fused flags, remat on): 8 fused sites a forward
# pass, none pooled, so no bn_stats and no K5; the any-order op on the
# train path (5 inner steps x support and target, 1.5 of every 2 forwards
# recomputed: 25 forwards a site; past the MSL horizon 16), the one-level
# op in eval and serving (5 support + 1 target forwards a site and a
# bn_act_bwd for each of the 5 inner gradients). Counted on the CPU in
# tests/test_torch_resnet.py.
CLI_RESNET12_TRAIN = {"bn_stats": 0, "bn_stats_act": 200, "bn_act_bwd": 0,
                      "bn_act_pool_apply": 0}
CLI_RESNET12_TRAIN_FINAL = {"bn_stats": 0, "bn_stats_act": 128, "bn_act_bwd": 0,
                            "bn_act_pool_apply": 0}
CLI_RESNET12_EVAL = {"bn_stats": 0, "bn_stats_act": 48, "bn_act_bwd": 40,
                     "bn_act_pool_apply": 0}
RESNET_SERVE_LAUNCHES = CLI_RESNET12_EVAL
# The VGG's other options on the flagship JSON (the backbone_options
# phase), and the launches of its first second-order step without remat (5
# inner steps x support and target forwards a stage: the any-order op)
# plus one eval iteration (5 + 1 forwards a stage and 5 backwards, the
# one-level op): only the stride-2 VGG has fused sites.
BACKBONE_OPTIONS = (("stride2", {"max_pooling": False}),
                    ("layer_norm", {"norm_layer": "layer_norm"}),
                    ("norm_conv", {"block_order": "norm_conv"}))
BACKBONE_OPTION_LAUNCHES = {
    "stride2": {"bn_stats": 0, "bn_stats_act": 64, "bn_act_bwd": 20,
                "bn_act_pool_apply": 0},
    "layer_norm": dict.fromkeys(("bn_stats", "bn_stats_act", "bn_act_bwd",
                                 "bn_act_pool_apply"), 0),
}
BACKBONE_OPTION_LAUNCHES["norm_conv"] = BACKBONE_OPTION_LAUNCHES["layer_norm"]
# (kind, config, learner class, entry point module) of each zoo learner,
# and its launches per train iteration (MSL, final-only) and eval iteration.
ZOO = (
    ("gd", GD_CONFIG, "GradientDescentLearner", "train_gradient_descent_system"),
    ("matching_nets", MATCHING_NETS_CONFIG, "MatchingNetsLearner",
     "train_matching_nets_system"),
    ("anil", FLAGSHIP, "ANILLearner", "train_anil_system"),
    ("protonets", FLAGSHIP, "ProtoNetsLearner", "train_protonets_system"),
)
ZOO_LAUNCHES = {
    "gd": (CLI_GD_TRAIN, CLI_GD_TRAIN, CLI_GD_EVAL),
    "matching_nets": (CLI_MATCHING_NETS_TRAIN, CLI_MATCHING_NETS_TRAIN,
                      CLI_MATCHING_NETS_EVAL),
    "anil": (CLI_ANIL_TRAIN, CLI_ANIL_TRAIN_FINAL, CLI_ANIL_EVAL),
    "protonets": (CLI_PROTONETS_TRAIN, CLI_PROTONETS_TRAIN, CLI_PROTONETS_EVAL),
}
# Meta-updates a dispatch in the CLI's K>1 calls.
GRAPH_ITERS = 5
#: K of the graph, task-chunk and lane-padding phases' dispatches (replays
#: held to as many eager steps; an eager ResNet-12 step takes over a second).
GRAPH_PHASE_ITERS = 3
#: Repeats of the graph phases' replay and eager timings.
TIMING_REPEATS = 1
# Each wrapper's device kernel in csrc/fused_norm.cu, as it stands in the
# mangled name the driver gives a graph's kernel node (bn_stats and
# bn_stats_act are two instances of one template).
KERNEL_SYMBOLS = {"bn_stats": "13bn_fwd_kernelILb0E",
                  "bn_stats_act": "13bn_fwd_kernelILb1E",
                  "bn_act_bwd": "13bn_bwd_kernel",
                  "bn_act_pool_apply": "24bn_act_pool_apply_kernel"}
# The fused-norm kernel nodes of each captured graph (check_replay), for
# the [replay] line.
REPLAY_NODES = []
FUSED_ARGV = ["--use_pallas_fused_norm", "True", "--fused_norm_train", "True",
              "--fused_norm_pool", "True"]
# Flops per input element each kernel does, counted from its source
# (bn_act_bwd: 8 in the reduce, 10 in the apply, the LeakyReLU's slope
# product counted on every element).
FLOPS_PER_ELEMENT = {
    "bn_stats": 4, "bn_stats_act": 8, "bn_act_bwd": 18, "bn_act_pool_apply": 6,
}
# Full-size tensors each kernel reads or writes (the pooled output is a
# quarter of one), and per-channel vectors.
TENSORS = {"bn_stats": 1, "bn_stats_act": 2, "bn_act_bwd": 3, "bn_act_pool_apply": 1.25}
VECTORS = {"bn_stats": 2, "bn_stats_act": 4, "bn_act_bwd": 6, "bn_act_pool_apply": 4}
PALLAS = "howtotrainyourmamlpytorch_tpu/ops/pallas_fused_norm.py"

# The MAML learner's compute options. The bf16 flagship: the flagship's
# hyperparameters, train seed 1, run with --compute_dtype bfloat16.
BF16_CONFIG = os.path.join(
    REPO, "experiment_config_local", "omniglot_maml++-omniglot-bf16_1_8_0.1_64_5_1.json"
)
BF16_ARGV = ["--compute_dtype", "bfloat16"]
# Its kernel shapes are the f32 flagship's train stages, in bfloat16, for
# training, its validation and its ensemble test alike: all four kernels
# at slope 0.01, K5 at the two pooled stages.
BF16_SHAPES = TRAIN_SHAPES
BF16_POOL_SHAPES = TRAIN_SHAPES[:2]
# A bf16 kernel against its bf16 plain version on the same input (both
# compute in float32 and round once): the float32 statistics within
# BF16_STAT_RTOL of the plain ones' largest value; y and dx per element
# within one bfloat16 unit in the last place of the plain element (two
# float32 values within one ulp round at most one apart), plus ATOL where
# the two float32 results cancel to near 0, with a median gap of 0;
# dgamma and dbeta at the float32 bar.
BF16_STAT_RTOL = 1e-5
# A bf16 run's loss against the float32 run's: JAX's own bf16 bar
# (tests/test_bf16.py:88-143).
BF16_LOSS_RTOL, BF16_LOSS_ATOL = 0.1, 0.05

REPLACES = {
    "bn_stats": f"{PALLAS}:147,248",
    "bn_stats_act": f"{PALLAS}:93,183,194",
    "bn_act_bwd": f"{PALLAS}:113,206,226",
    "bn_act_pool_apply": f"{PALLAS}:147,267",
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 5) -> float:
    """Milliseconds per ``fn()`` over ``reps`` back-to-back eager calls
    between CUDA events, after ``warmup`` calls. For small kernels this is
    the host's launch rate, not the kernel's device time."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, calls: int, replays: int = 10) -> float:
    """Device milliseconds per ``fn()``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. The replay runs
    the same kernels without the Python and launch cost of each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    from howtotrainyourmamlpytorch_tpu_torch.models.step_graph import (
        collector_paused,
    )

    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    torch.cuda.empty_cache()
    return ms


def err_ok(got, want) -> tuple[float, bool]:
    err = float((got - want).abs().max())
    return err, err <= ATOL + RTOL * float(want.abs().max())


def one_ulp(torch, tree, seed: int):
    """``tree`` with every float leaf moved by one unit in the last place
    (2^-23 relative, a random sign per element drawn from ``seed``)."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_map

    gen = torch.Generator().manual_seed(seed)

    def move(a):
        sign = torch.randint(0, 2, a.shape, generator=gen).to(a.device) * 2 - 1
        return a * (1 + sign * 2.0 ** -23)

    return tree_map(move, tree)


def bound_ms(name: str, shape, elem_bytes: int = 4) -> tuple[float, str]:
    """Least time for the work: bytes each input read once and each output
    written once (full-size tensors at ``elem_bytes`` an element, 2 for
    bfloat16; per-channel vectors float32), against float32 operations at
    the non-tensor peak (the kernels compute in float32 either way)."""
    n, c, h, w = shape
    elems = n * c * h * w
    t_bytes = (elem_bytes * TENSORS[name] * elems + 4 * VECTORS[name] * c) \
        / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_ELEMENT[name] * elems / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _inputs(torch, shape, gen):
    dev = torch.device("cuda")
    x = torch.randn(shape, device=dev, generator=gen)
    c = shape[1]
    gamma = torch.rand(c, device=dev, generator=gen) + 0.5
    beta = 0.1 * torch.randn(c, device=dev, generator=gen)
    return x, gamma, beta


def check_and_time_forward(torch, fn, x, gamma, beta, reps, streamed=False,
                           slope=SLOPE):
    """``bn_stats_act`` at ``slope`` and ``bn_stats`` on ``x`` against the
    plain version, two calls bitwise equal and both entries' statistics
    bitwise equal; then times, with the launch plan."""
    eps = fn.EPS
    plan = fn.fwd_plan(x, streamed=streamed)
    y, mean, var = fn.bn_stats_act(x, gamma, beta, eps, slope, plan=plan)
    again = fn.bn_stats_act(x, gamma, beta, eps, slope, plan=plan)
    stats = fn.bn_stats(x, plan=plan)
    torch.cuda.synchronize()
    shape = tuple(x.shape)
    if not all(torch.equal(a, b) for a, b in zip((y, mean, var), again)):
        fail(f"bn_stats_act at {shape} ({plan}) differs between two calls")
    if not all(torch.equal(a, b) for a, b in zip((mean, var), stats)):
        fail(f"bn_stats and bn_stats_act statistics differ at {shape} ({plan})")
    p_mean, p_var = fn.plain_stats(x)
    p_y = fn.plain_apply(x, p_mean, p_var, gamma, beta, eps, slope)
    out = {}
    for name, pairs in (
        ("bn_stats", [(mean, p_mean), (var, p_var)]),
        ("bn_stats_act", [(y, p_y), (mean, p_mean), (var, p_var)]),
    ):
        errs = [err_ok(a, b) for a, b in pairs]
        if not all(ok for _, ok in errs):
            fail(f"{name} at {shape} slope {slope} ({plan}) disagrees with its "
                 f"plain version: max_abs_err {[e for e, _ in errs]}")
        out[name] = {"max_abs_err": max(e for e, _ in errs), "plan": plan._asdict()}
    runs = {
        "bn_stats": (lambda: fn.bn_stats(x, plan=plan), lambda: fn.plain_stats(x)),
        "bn_stats_act": (
            lambda: fn.bn_stats_act(x, gamma, beta, eps, slope, plan=plan),
            lambda: fn.plain_apply(x, *fn.plain_stats(x), gamma, beta, eps, slope),
        ),
    }
    calls = max(2, reps // 5)
    for name, (kernel, plain) in runs.items():
        b, by = bound_ms(name, shape)
        out[name].update(
            ms=graph_ms(torch, kernel, calls),
            plain_ms=graph_ms(torch, plain, calls),
            eager_ms=cuda_ms(torch, kernel, reps),
            eager_plain_ms=cuda_ms(torch, plain, reps),
            bound_ms=b, bound_by=by, library_ms=None,
        )
    out["bn_stats"]["library_ms"] = graph_ms(
        torch, lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0), calls
    )
    return out


def check_and_time_backward(torch, fn, x, gamma, beta, g, reps, streamed=False,
                            slope=SLOPE):
    """``bn_act_bwd`` at ``slope`` from the statistics ``FusedBNLeakyReLU``
    saved, called directly and (on its own plan) through the Function's
    backward, against ``plain_bwd`` on the same statistics, so that both
    take the same LeakyReLU branch where pre lies within rounding of 0; two
    calls and the two routes bitwise equal; then times, with the launch
    plan."""
    shape, eps = tuple(x.shape), fn.EPS
    plan = fn.bwd_plan(x, streamed=streamed)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y, mean, var = fn.FusedBNLeakyReLU.apply(*leaves, eps, slope)
    through = torch.autograd.grad(y, leaves, g)
    mean, var = mean.detach(), var.detach()
    got = fn.bn_act_bwd(x, g, mean, var, gamma, beta, eps, slope, plan=plan)
    again = fn.bn_act_bwd(x, g, mean, var, gamma, beta, eps, slope, plan=plan)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"bn_act_bwd at {shape} ({plan}) differs between two calls")
    if not streamed and not all(torch.equal(a, b) for a, b in zip(got, through)):
        fail(f"bn_act_bwd at {shape} ({plan}) differs from the Function's backward")
    want = fn.plain_bwd(x, g, mean, var, gamma, beta, eps, slope)
    errs = [err_ok(a, b) for a, b in zip((*got, *through), (*want, *want))]
    if not all(ok for _, ok in errs):
        fail(f"bn_act_bwd at {shape} slope {slope} ({plan}) disagrees with its "
             f"plain version: max_abs_err {[e for e, _ in errs]}")
    kernel = lambda: fn.bn_act_bwd(x, g, mean, var, gamma, beta, eps, slope,  # noqa: E731
                                   plan=plan)
    plain = lambda: fn.plain_bwd(x, g, mean, var, gamma, beta, eps, slope)  # noqa: E731
    b, by = bound_ms("bn_act_bwd", shape)
    calls = max(2, reps // 5)
    return {
        "max_abs_err": max(e for e, _ in errs), "plan": plan._asdict(),
        "ms": graph_ms(torch, kernel, calls), "plain_ms": graph_ms(torch, plain, calls),
        "eager_ms": cuda_ms(torch, kernel, reps),
        "eager_plain_ms": cuda_ms(torch, plain, reps),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }


def check_and_time_kernels(torch, fn, shape, gen, reps, slope=SLOPE) -> dict:
    """The forward and the backward (above) at ``slope``, then, at the VGG's
    slope, the pair yardsticks."""
    import torch.nn.functional as F

    x, gamma, beta = _inputs(torch, shape, gen)
    g = torch.randn(shape, device=x.device, generator=gen)
    out = check_and_time_forward(torch, fn, x, gamma, beta, reps, slope=slope)
    out["bn_act_bwd"] = check_and_time_backward(
        torch, fn, x, gamma, beta, g, reps, slope=slope
    )
    if slope != fn.SLOPE:
        return out

    # Pair yardsticks: the whole forward and backward against PyTorch's
    # batch norm (training mode) + LeakyReLU and their autograd backward.
    xk, gk, bk = (t.clone().requires_grad_() for t in (x, gamma, beta))
    xl, gl, bl = (t.clone().requires_grad_() for t in (x, gamma, beta))

    def lib_fwd():
        return F.leaky_relu(
            F.batch_norm(xl, None, None, gl, bl, training=True, eps=fn.EPS),
            fn.SLOPE,
        )

    y_lib = lib_fwd()
    y_fused = fn.FusedBNLeakyReLU.apply(xk, gk, bk, fn.EPS, fn.SLOPE)[0]
    out["pairs"] = {
        "forward_ms": cuda_ms(
            torch, lambda: fn.FusedBNLeakyReLU.apply(x, gamma, beta, fn.EPS, fn.SLOPE),
            reps,
        ),
        "library_forward_ms": cuda_ms(torch, lib_fwd, reps),
        "backward_ms": cuda_ms(
            torch,
            lambda: torch.autograd.grad(y_fused, (xk, gk, bk), g, retain_graph=True),
            reps,
        ),
        "library_backward_ms": cuda_ms(
            torch,
            lambda: torch.autograd.grad(y_lib, (xl, gl, bl), g, retain_graph=True),
            reps,
        ),
    }
    return out


def check_and_time_pool(torch, fn, shape, gen, reps) -> dict:
    """K5 against ``plain_pool_apply`` on the same statistics, then times."""
    x, gamma, beta = _inputs(torch, shape, gen)
    mean, var = fn.bn_stats(x)
    got = fn.bn_act_pool_apply(x, mean, var, gamma, beta)
    torch.cuda.synchronize()
    err, ok = err_ok(got, fn.plain_pool_apply(x, mean, var, gamma, beta))
    if not ok:
        fail(f"bn_act_pool_apply at {shape} disagrees with its plain version: "
             f"max_abs_err {err}")
    kernel = lambda: fn.bn_act_pool_apply(x, mean, var, gamma, beta)  # noqa: E731
    plain = lambda: fn.plain_pool_apply(x, mean, var, gamma, beta)  # noqa: E731
    b, by = bound_ms("bn_act_pool_apply", shape)
    calls = max(2, reps // 5)
    return {
        "max_abs_err": err, "ms": graph_ms(torch, kernel, calls),
        "plain_ms": graph_ms(torch, plain, calls),
        "eager_ms": cuda_ms(torch, kernel, reps),
        "eager_plain_ms": cuda_ms(torch, plain, reps),
        "bound_ms": b, "bound_by": by, "library_ms": None,
    }


def check_functions(torch, fn, gen) -> dict:
    """Both any-order Functions against the plain composition differentiated
    by autograd: forward, the first-order gradients of a loss over y, mean
    and var, and the reverse-over-reverse composition. The plain composition
    takes the kernels' statistics as values (with its own gradient), so both
    take the same LeakyReLU branch and window maximum where two values lie
    within rounding."""
    import torch.nn.functional as F

    dev = torch.device("cuda")

    def plain_op(x, gamma, beta, pool, stats):
        mean, var = fn.plain_stats(x)
        mean = mean + (stats[0] - mean).detach()
        var = var + (stats[1] - var).detach()
        y = fn.plain_apply(x, mean, var, gamma, beta)
        return (F.max_pool2d(y, 2, 2) if pool else y), mean, var

    out = {}
    for name, op, shape in (
        ("pool", fn.fused_bn_leaky_relu_pool, TRAIN_SHAPES[0]),
        ("ho", fn.fused_bn_leaky_relu_ho, TRAIN_SHAPES[2]),
    ):
        pool = name == "pool"
        x = torch.randn(shape, device=dev, generator=gen)
        gamma = torch.rand(shape[1], device=dev, generator=gen) + 0.5
        beta = 0.1 * torch.randn(shape[1], device=dev, generator=gen)
        stats = fn.bn_stats(x)
        t = torch.randn_like(op(x, gamma, beta)[0])

        def grads(f):
            leaves = [a.clone().requires_grad_() for a in (x, gamma, beta)]
            y, mean, var = f(*leaves)
            first = torch.autograd.grad(
                (y * t).sum() + mean.sum() + var.sum(), leaves
            )
            xx, gg = (a.clone().requires_grad_() for a in (x, gamma))
            (g,) = torch.autograd.grad(
                (f(xx, gg, beta)[0] ** 2).sum(), gg, create_graph=True
            )
            (second,) = torch.autograd.grad(f(xx, gg - 0.1 * g, beta)[0].sum(), xx)
            return [a.detach() for a in (y, *first, second)]

        got = grads(op)
        want = grads(lambda *a: plain_op(*a, pool, stats))  # noqa: B023
        torch.cuda.synchronize()
        errs = [err_ok(a, b) for a, b in zip(got, want)]
        out[name] = dict(zip(("y", "dx", "dgamma", "dbeta", "rev_over_rev_dx"),
                             (e for e, _ in errs)))
        if not all(ok for _, ok in errs):
            fail(f"the {name} Function at {shape} disagrees with the plain "
                 f"composition: {out[name]}")
    return out


def make_episodes(rng, count, query=15):
    """Binary 28x28 episodes, sparse strokes on a blank ground like
    Omniglot's 0/1 pixels; episode count // 2 repeats episode 0's support."""
    eps = []
    for i in range(count):
        xs = (rng.rand(5, 1, 1, 28, 28) > 0.8).astype(np.float32)
        if i == count // 2:
            xs = eps[0][0]
        xq = (rng.rand(query, 1, 28, 28) > 0.8).astype(np.float32)
        eps.append((xs, np.arange(5).reshape(5, 1), xq))
    return eps


def classify_alone(torch, learner, plain_learner, istate, eps, tag) -> float:
    """The fused learner's classify of ``eps`` (a task axis) against the
    plain one's, both on the plain learner's adapted weights: a forward
    pass, held to the CLASSIFY bar."""
    dev = istate.theta["linear"]["weight"].device
    xs, ys, xq = (
        torch.from_numpy(np.stack([getattr(ep, k) for ep in eps])).to(dev)
        for k in ("x_support", "y_support", "x_query")
    )
    fast = plain_learner.serve_adapt(istate, xs, ys)
    a = learner.serve_classify(istate, fast, xq)
    b = plain_learner.serve_classify(istate, fast, xq)
    err = float((a - b).abs().max())
    if err > CLASSIFY_ATOL + CLASSIFY_RTOL * float(b.abs().max()):
        fail(f"{tag}: fused classify differs from the plain-norm one by {err}")
    return err


def episode_bars(torch, plain_learner, istate, raw, ref, chaotic):
    """``(median bar, max bar, one-ulp gaps)`` for whole served episodes
    against the plain-norm engine's logits ``ref`` of ``raw``: the serve
    bars, or with ``chaotic`` at least ``SENSITIVITY_FACTOR`` times the
    plain engine's own per-episode gap when its weights move by one ulp
    (each of ``SENSITIVITY_SEEDS``)."""
    from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingEngine

    median_bar, max_bar, sensitivity = EPISODE_MEDIAN_ATOL, EPISODE_MAX_ATOL, []
    if chaotic:
        for seed in SENSITIVITY_SEEDS:
            moved = ServingEngine(plain_learner, istate._replace(
                theta=one_ulp(torch, istate.theta, seed)
            ), ServeConfig(meta_batch_size=4))
            gap = np.abs(np.stack(moved.dispatch(
                [moved.prepare_episode(*e) for e in raw])) - ref)
            sensitivity.append(gap.reshape(len(raw), -1).max(axis=1))
        median_bar = max(median_bar, SENSITIVITY_FACTOR * max(
            float(np.median(g)) for g in sensitivity))
        max_bar = max(max_bar, SENSITIVITY_FACTOR * max(float(g.max()) for g in sensitivity))
    return median_bar, max_bar, sensitivity


def serve_phase(torch, fn, config=FLAGSHIP, per_dispatch=SERVE_LAUNCHES,
                chaotic=False):
    """32 episodes of bucket 5x1x15 served by a ``use_pallas_fused_norm``
    engine on ``config`` (meta-batch 4, one support set repeated), held to
    ``per_dispatch`` launches and as ``hold_episodes`` says."""
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        ServeConfig,
        ServeMetrics,
        ServingEngine,
    )
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        load_maml_config,
    )

    cfg = load_maml_config(config, use_pallas_fused_norm=True)
    learner = MAMLFewShotLearner(cfg)
    istate = learner.init_inference_state(torch.Generator().manual_seed(104))
    plain_learner = MAMLFewShotLearner(dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_fused_norm=False)))
    engine = ServingEngine(learner, istate, ServeConfig(meta_batch_size=4))
    rng = np.random.RandomState(0)
    engine.dispatch([engine.prepare_episode(*e) for e in make_episodes(rng, 4)])
    engine.metrics = metrics = ServeMetrics()

    raw = make_episodes(rng, 32)
    eps = [engine.prepare_episode(*e) for e in raw]
    if {ep.bucket for ep in eps} != {(5, 1, 15)}:
        fail(f"unexpected buckets {sorted({ep.bucket for ep in eps})}")
    fn.reset_launch_counts()
    t0 = time.perf_counter()
    logits = engine.dispatch(eps)
    wall = time.perf_counter() - t0
    launches = dict(fn.launch_counts)
    dispatches = metrics.batches_dispatched.value
    want = {k: n * dispatches for k, n in per_dispatch.items()}
    if launches != want:
        fail(f"serve launches {launches} over {dispatches} "
             f"dispatches, expected {per_dispatch} per dispatch")
    if metrics.cache_hits.value != 1:
        fail(f"expected one cache hit, got {metrics.cache_hits.value}")
    held = hold_episodes(torch, logits, learner, plain_learner, istate, raw,
                         "[serve]", chaotic)
    return {
        "episodes": len(eps),
        "dispatches": dispatches,
        "cache_hits": metrics.cache_hits.value,
        "adapt_p50_ms": metrics.adapt_latency.percentile(50),
        "classify_p50_ms": metrics.classify_latency.percentile(50),
        "episodes_per_s": len(eps) / wall,
        **held,
        "launches": launches,
        "launches_per_dispatch": {k: v / dispatches for k, v in launches.items()},
    }


def http_call(url, payload=None, timeout=300):
    """``(status, body bytes, headers)`` of one loopback request (a POST
    of ``payload`` as JSON, else a GET); an HTTP error status is an answer
    too."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as err:
        return err.code, err.read(), err.headers


def episode_json(xs, ys, xq) -> dict:
    return {"support": np.asarray(xs).tolist(),
            "support_labels": np.asarray(ys).reshape(-1).tolist(),
            "query": np.asarray(xq).tolist()}


def post_concurrently(base, episodes, clients=4) -> tuple[list, float]:
    """POSTs ``episodes`` to ``/v1/episode`` from ``clients`` threads (client
    ``c`` sends episodes ``c, c + clients, ...`` in turn); returns each
    episode's ``(status, body)`` in order and the wall seconds."""
    import threading

    answers = [None] * len(episodes)

    def client(c):
        for i in range(c, len(episodes), clients):
            status, body, _ = http_call(f"{base}/v1/episode", episode_json(*episodes[i]))
            answers[i] = (status, json.loads(body))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or None in answers:
        fail("an HTTP client did not finish")
    return answers, wall


def expected_serve_launches(metrics, before) -> tuple[dict, int, int]:
    """The launches the dispatches ``metrics`` counted since ``before``
    (``(batches, adapt count)``) call for: ``SERVE_LAUNCHES`` for each
    dispatch that adapted a cache miss, ``SERVE_HIT_LAUNCHES`` for each
    that only classified."""
    misses = metrics.adapt_latency.snapshot()["count"] - before[1]
    hits_only = metrics.batches_dispatched.value - before[0] - misses
    want = {k: SERVE_LAUNCHES[k] * misses + SERVE_HIT_LAUNCHES[k] * hits_only
            for k in SERVE_LAUNCHES}
    return want, misses, hits_only


def metric_counts(metrics) -> tuple[int, int]:
    return metrics.batches_dispatched.value, metrics.adapt_latency.snapshot()["count"]


def scrape_quantiles(text: str) -> dict:
    """``{"adapt_p50_ms": ..., "adapt_p99_ms": ..., ...}`` from the
    ``/metrics`` text's latency summaries."""
    out = {}
    for line in text.splitlines():
        if line.startswith("maml_serve_") and "_latency_ms{quantile=" in line:
            name, value = line.rsplit(" ", 1)
            stage = name[len("maml_serve_"):name.index("_latency_ms")]
            q = name.split('quantile="')[1].rstrip('"}')
            out[f"{stage}_p{round(float(q) * 100)}_ms"] = float(value)
    return out


def hold_episodes(torch, got, learner, plain_learner, istate, raw, tag,
                  chaotic=False) -> dict:
    """Served logits ``got`` (per episode) held to the plain-norm engine's
    dispatch of ``raw`` (as ``episode_bars`` says), classify alone to the
    CLASSIFY bar, and every episode bit for bit to a fresh fused engine's
    dispatch in groups of 4 (an episode's bits do not depend on the
    traffic it was batched with)."""
    from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingEngine

    plain = ServingEngine(plain_learner, istate, ServeConfig(meta_batch_size=4))
    engine = ServingEngine(learner, istate, ServeConfig(meta_batch_size=4))
    ref = np.stack(plain.dispatch([plain.prepare_episode(*e) for e in raw]))
    eps = [engine.prepare_episode(*e) for e in raw]
    again = np.stack(engine.dispatch(eps))
    got = np.stack(got)
    if got.shape != ref.shape or not np.isfinite(got).all():
        fail(f"{tag}: logits of shape {got.shape}, finite={np.isfinite(got).all()}")
    classify_err = classify_alone(torch, learner, plain_learner, istate, eps[:4], tag)
    per_episode = np.abs(got - ref).reshape(len(raw), -1).max(axis=1)
    median_bar, max_bar, sensitivity = episode_bars(
        torch, plain_learner, istate, raw, ref, chaotic)
    if np.median(per_episode) > median_bar or per_episode.max() > max_bar:
        fail(f"{tag}: served episodes differ from the plain-norm engine beyond "
             f"median {median_bar} and max {max_bar}: {per_episode.tolist()}")
    moved = np.abs(got - again).reshape(len(raw), -1).max(axis=1)
    if moved.max() > 0:
        fail(f"{tag}: {int((moved > 0).sum())} of {len(raw)} episodes moved against a "
             f"fresh engine's dispatch in groups of 4, by up to {moved.max()}")
    return {
        "classify_max_abs_err_vs_plain": classify_err,
        "episode_max_abs_err_vs_plain": float(per_episode.max()),
        "episode_median_abs_err_vs_plain": float(np.median(per_episode)),
        "episodes_over_1e-4": int((per_episode > 1e-4).sum()),
        "max_abs_logit": float(np.abs(ref).max()),
        "episode_bars": {"median": median_bar, "max": max_bar},
        "plain_one_ulp_episode_gap": [
            {"median": float(np.median(g)), "max": float(g.max())} for g in sensitivity
        ],
        "bitwise_vs_fresh_engine": True,
    }


def serve_http_phase(torch, fn) -> dict:
    """The flagship JSON (``use_pallas_fused_norm``) behind
    ``make_http_server`` on an ephemeral port, ``ServeConfig`` defaults
    (meta-batch 4, 2 ms window): ``/healthz`` 503 before the 5x1x15 warmup
    and 200 after; 31 episodes from 4 client threads over loopback, then a
    repeat of episode 0's support set, which must come from the cache;
    launches held exactly to the dispatches the metrics counted; logits
    held to the plain-norm engine and to a fresh engine bit for bit; a
    promote of a checkpoint the port saved, a corrupt copy's 409 with the
    promoted state's logits unmoved; ``/metrics`` scraped."""
    import shutil
    import tempfile
    import threading

    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        ServeConfig,
        ServingAPI,
        make_http_server,
    )
    from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import checkpoint_digest
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config

    cfg = load_maml_config(FLAGSHIP, use_pallas_fused_norm=True)
    learner = MAMLFewShotLearner(cfg)
    istate = learner.init_inference_state(torch.Generator().manual_seed(104))
    plain_learner = MAMLFewShotLearner(dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_fused_norm=False)))
    api = ServingAPI(learner, istate, ServeConfig())
    server = make_http_server(api, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        if http_call(f"{base}/healthz")[0] != 503:
            fail("[serve_http] /healthz answered other than 503 before warmup")
        api.warmup([(5, 1, 15)])
        if http_call(f"{base}/healthz")[0] != 200:
            fail("[serve_http] /healthz answered other than 200 after warmup")

        raw = make_episodes(np.random.RandomState(0), 32)
        repeat = raw.pop(16)  # episode 0's support set, new queries
        fn.reset_launch_counts()
        before = metric_counts(api.metrics)
        answers, wall = post_concurrently(base, raw)
        status, body, _ = http_call(f"{base}/v1/episode", episode_json(*repeat))
        answers.append((status, json.loads(body)))
        launches = dict(fn.launch_counts)
        want, misses, hits_only = expected_serve_launches(api.metrics, before)
        if launches != want:
            fail(f"[serve_http] launches {launches} over {misses} cache-miss and "
                 f"{hits_only} cache-hit dispatches, expected {want}")
        if any(s != 200 for s, _ in answers):
            fail(f"[serve_http] statuses {[s for s, _ in answers]}")
        if not answers[-1][1]["cache_hit"] or any(b["cache_hit"] for _, b in answers[:-1]):
            fail("[serve_http] the repeated support set, and only it, must hit the cache")
        raw.append(repeat)
        got = [np.asarray(b["logits"], np.float32) for _, b in answers]
        held = hold_episodes(torch, got, learner, plain_learner, istate, raw,
                             "[serve_http]")
        text = http_call(f"{base}/metrics")[1].decode()
        quantiles = scrape_quantiles(text)
        if 'maml_serve_program_compiles{program="adapt:4x5"} 1' not in text:
            fail("[serve_http] /metrics lacks the adapt:4x5 signature")
        ledger = program_ledger_rows(text)
        for bucket in api.engine.warmed_buckets():
            label = "x".join(map(str, bucket))
            rows = {k: v for k, v in ledger.items() if k[2] == label}
            if (sorted(k[1].split(":")[0] for k in rows if k[0] == "flops")
                    != ["adapt", "classify"]
                    or not all(v > 0 for k, v in rows.items())):
                fail(f"[serve_http] /metrics program ledger rows for {label}: {rows}")

        with tempfile.TemporaryDirectory(prefix="chip_smoke_promote_") as tmp:
            ckpt, bad = os.path.join(tmp, "train_model_7"), os.path.join(tmp, "corrupt")
            learner.save_model(ckpt, learner.init_state(torch.Generator().manual_seed(7)),
                               {"current_iter": 0})
            status, body, _ = http_call(f"{base}/admin/promote", {"checkpoint": ckpt})
            promoted = json.loads(body)
            if status != 200 or promoted["state_version"] != 1:
                fail(f"[serve_http] promote answered {status} {promoted}")
            probe = episode_json(*raw[1])
            _, after, _ = http_call(f"{base}/v1/episode", probe)
            after = json.loads(after)
            shutil.copy(ckpt, bad)
            with open(bad, "r+b") as f:
                f.truncate(128)
            status, body, _ = http_call(f"{base}/admin/promote", {"checkpoint": bad})
            if status != 409 or json.loads(body)["reason"] != "corrupt_checkpoint":
                fail(f"[serve_http] a corrupt checkpoint's promote answered {status} {body!r}")
            api.engine.cache.clear()  # so that the promoted state adapts again
            _, still, _ = http_call(f"{base}/v1/episode", probe)
            still = json.loads(still)
            health = json.loads(http_call(f"{base}/healthz")[1])
            if (after["state_version"], still["state_version"]) != (1, 1) or still["cache_hit"]:
                fail(f"[serve_http] versions {after['state_version']}, "
                     f"{still['state_version']}; second answer cache_hit {still['cache_hit']}")
            if still["logits"] != after["logits"]:
                fail("[serve_http] the promoted state's logits moved after a rejected promote")
            if after["logits"] == answers[1][1]["logits"]:
                fail("[serve_http] the promoted state answered the old state's logits")
            if health["checkpoint_digest"] != checkpoint_digest(ckpt):
                fail("[serve_http] /healthz does not name the promoted checkpoint")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        api.close()
    return {
        "episodes": len(raw),
        "clients": 4,
        "episodes_per_s": (len(raw) - 1) / wall,
        **quantiles,
        "dispatches": misses + hits_only,
        "cache_miss_dispatches": misses,
        "cache_hit_dispatches": hits_only,
        **held,
        "promote": {"state_version": promoted["state_version"],
                    "buckets_canaried": promoted["buckets_canaried"],
                    "corrupt_copy": 409, "logits_unmoved": True},
        "program_ledger": {f"{k[0]}:{k[1]}@{k[2]}": v for k, v in ledger.items()},
        "launches": launches,
    }


def program_ledger_rows(text: str) -> dict:
    """``{(field, program, bucket): value}`` of the ``/metrics`` program
    ledger gauges (``maml_serve_program_flops``, ``_hbm_peak_bytes``)."""
    import re

    rows = {}
    for field in ("flops", "hbm_peak_bytes"):
        pattern = re.compile(rf'^maml_serve_program_{field}\{{program="([^"]+)",'
                             rf'bucket="([^"]*)"\}} (\S+)$')
        for line in text.splitlines():
            match = pattern.match(line)
            if match:
                rows[field, match[1], match[2]] = float(match[3])
    return rows


def serve_cli_phase(torch) -> dict:
    """``python3 -m howtotrainyourmamlpytorch_tpu_torch.serve_maml`` on the
    flagship JSON with ``--use_pallas_fused_norm True --init_from_scratch
    --port 0 --port_file <file> --warmup 5x1x15`` as a subprocess: it names
    its port, answers ``/healthz`` and one episode, and exits 0 on
    SIGTERM. The process is killed if anything fails."""
    import signal
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_cli_") as tmp:
        port_file = os.path.join(tmp, "serve.port")
        log_path = os.path.join(tmp, "serve.log")
        cmd = [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve_maml",
               "--config", FLAGSHIP, "--init_from_scratch", "--port", "0",
               "--port_file", port_file, "--warmup", "5x1x15",
               "--use_pallas_fused_norm", "True"]
        with open(log_path, "w") as log:
            t0 = time.perf_counter()
            proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        try:
            while not os.path.exists(port_file):
                if proc.poll() is not None or time.perf_counter() - t0 > 300:
                    fail(f"[serve_cli] the server did not come up:\n{open(log_path).read()}")
                time.sleep(0.05)
            ready_s = time.perf_counter() - t0
            with open(port_file) as f:
                base = f"http://127.0.0.1:{f.read().strip()}"
            status, body, _ = http_call(f"{base}/healthz")
            if status != 200 or not json.loads(body)["ready"]:
                fail(f"[serve_cli] /healthz answered {status} {body!r}")
            t1 = time.perf_counter()
            status, body, _ = http_call(
                f"{base}/v1/episode",
                episode_json(*make_episodes(np.random.RandomState(2), 2)[0]))
            episode_ms = (time.perf_counter() - t1) * 1e3
            logits = np.asarray(json.loads(body).get("logits", []), np.float32)
            if status != 200 or logits.shape != (15, 5) or not np.isfinite(logits).all():
                fail(f"[serve_cli] the episode answered {status}, logits {logits.shape}")
            proc.send_signal(signal.SIGTERM)
            code = proc.wait(timeout=120)
            if code != 0:
                fail(f"[serve_cli] exit code {code} on SIGTERM:\n{open(log_path).read()}")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        lines = open(log_path).read().splitlines()
    return {"ready_s": ready_s, "first_episode_ms": episode_ms, "exit_code": code,
            "log": [line for line in lines if line.startswith(("serving", "warming"))]}


def north_star_episodes(rng, count):
    """Normalised 84x84 RGB episodes of bucket 5x5x15."""
    return [(rng.randn(5, 5, 3, 84, 84).astype(np.float32),
             np.tile(np.arange(5)[:, None], (1, 5)),
             rng.randn(15, 3, 84, 84).astype(np.float32)) for _ in range(count)]


def serve_api_north_star_phase(torch, fn) -> dict:
    """The north-star JSON (``use_pallas_fused_norm``) through
    ``ServingAPI`` with ``ServeConfig`` defaults, warmed at 5x5x15: 8
    episodes from 4 threads, launches held exactly to the dispatches the
    metrics counted, logits held to the plain-norm engine and to a fresh
    engine bit for bit."""
    import threading

    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingAPI
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config

    cfg = load_maml_config(NORTH_STAR, use_pallas_fused_norm=True)
    learner = MAMLFewShotLearner(cfg)
    istate = learner.init_inference_state(torch.Generator().manual_seed(104))
    plain_learner = MAMLFewShotLearner(dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, use_pallas_fused_norm=False)))
    api = ServingAPI(learner, istate, ServeConfig())
    raw = north_star_episodes(np.random.RandomState(1), 8)
    answers = [None] * len(raw)

    def client(c):
        for i in range(c, len(raw), 4):
            answers[i] = api.classify(*raw[i])

    try:
        api.warmup([(5, 5, 15)])
        fn.reset_launch_counts()
        before = metric_counts(api.metrics)
        threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = dict(fn.launch_counts)
        if None in answers:
            fail("[serve_api_north_star] a client did not finish")
        want, misses, hits_only = expected_serve_launches(api.metrics, before)
        if launches != want or hits_only:
            fail(f"[serve_api_north_star] launches {launches} over {misses} cache-miss "
                 f"and {hits_only} cache-hit dispatches, expected {want}")
        if {a["bucket"] for a in answers} != {"5x5x15"}:
            fail(f"[serve_api_north_star] buckets {[a['bucket'] for a in answers]}")
        held = hold_episodes(torch, [a["logits"] for a in answers], learner,
                             plain_learner, istate, raw, "[serve_api_north_star]",
                             chaotic=True)
        quantiles = scrape_quantiles(api.metrics_text())
    finally:
        api.close()
    return {"episodes": len(raw), "clients": 4, "episodes_per_s": len(raw) / wall,
            **quantiles, "dispatches": misses, **held, "launches": launches}


def train_batch(rng, tasks=8):
    """Binary 28x28 episodes of 5 classes, 1 support and 1 target image
    each: ``(B, N, K, C, H, W)`` images and ``(B, N, K)`` labels."""
    xs = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    xt = (rng.rand(tasks, 5, 1, 1, 28, 28) > 0.8).astype(np.float32)
    ys = np.tile(np.arange(5).reshape(1, 5, 1), (tasks, 1, 1))
    return xs, xt, ys, ys.copy()


def first_step(learner, state0, batch):
    """The first second-order MSL step's loss and meta-gradient."""
    dbatch = learner._device_batch(state0, batch)
    importance = learner._importance(state0, learner._train_importance(0))
    loss, _, _, grads = learner._meta_grads(
        state0, dbatch, importance, second_order=True, final_only=False
    )
    return loss, grads


def _gaps(candidate, reference) -> tuple[float, float]:
    """``(relative loss gap, worst leaf's gradient gap over its GRAD bar)``
    of one ``first_step`` against another."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    (loss, grads), (ref_loss, ref_grads) = candidate, reference
    worst = max(
        float((a - b).abs().max()) / (GRAD_ATOL + GRAD_RTOL * float(b.abs().max()))
        for a, b in zip(tree_leaves(grads), tree_leaves(ref_grads))
    )
    return abs(float(loss) - float(ref_loss)) / abs(float(ref_loss)), worst


def compare_with_plain(fused, plain, tag, sensitivity=None) -> dict:
    """``first_step`` of the fused learner against the plain-norm learner's
    on the same state and batch, per leaf under the GRAD/ROUTING
    tolerances; or, given ``sensitivity`` (the plain learner's
    ``first_step`` from one-ulp moves of the state), the loss gap and the
    worst leaf's gap over its GRAD bar against SENSITIVITY_FACTOR times the
    plain learner's own."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import (
        tree_leaves,
        tree_map_with_path,
    )

    (fused_loss, fused_grads), (plain_loss, plain_grads) = fused, plain
    loss_gap, worst = _gaps(fused, plain)
    if sensitivity is not None:
        own = [_gaps(moved, plain) for moved in sensitivity]
        loss_bar = max(TRAIN_LOSS_RTOL, SENSITIVITY_FACTOR * max(g for g, _ in own))
        worst_bar = max(1.0, SENSITIVITY_FACTOR * max(w for _, w in own))
        if loss_gap > loss_bar or worst > worst_bar:
            fail(f"{tag}: first loss gap {loss_gap} (bar {loss_bar}) or worst "
                 f"gradient leaf at {worst} of its bar (bar {worst_bar}) beyond "
                 f"the plain learner's own one-ulp gaps {own}")
        return {"first_loss_rel_gap_vs_plain": loss_gap,
                "worst_grad_gap_over_tolerance": worst,
                "plain_one_ulp_gaps": own, "bars": [loss_bar, worst_bar]}
    if loss_gap > TRAIN_LOSS_RTOL:
        fail(f"{tag}: first loss {float(fused_loss)} vs plain {float(plain_loss)}")
    routed = []
    names = tree_leaves(tree_map_with_path(
        lambda p, a: None if a is None else "/".join(p), plain_grads
    ))
    for name, a, b in zip(names, tree_leaves(fused_grads), tree_leaves(plain_grads)):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max())
        if gap > GRAD_ATOL + GRAD_RTOL * scale:
            routed.append((name, gap, scale))
            print(f"[{tag}] routing gap: {name} max|fused-plain| {gap:.3e} "
                  f"against max|plain| {scale:.3e}")
            if gap > ROUTING_RTOL * scale:
                fail(f"{tag}: meta-gradient leaf {name} off by {gap} "
                     f"(max|plain| {scale})")
    return {
        "first_loss_rel_gap_vs_plain": loss_gap,
        "worst_grad_gap_over_tolerance": worst,
        "routing_gap_leaves": routed,
    }


def fused_and_plain(config, cls=None, **overrides):
    """Learners ``cls`` (MAML's by default) of ``config`` (and the JSON
    keys in ``overrides``) with the three fused flags on and off."""
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        load_maml_config,
    )

    cls = cls or MAMLFewShotLearner
    return [
        cls(load_maml_config(config, **overrides, **dict.fromkeys(
            ("use_pallas_fused_norm", "fused_norm_train", "fused_norm_pool"), on
        )))
        for on in (True, False)
    ]


def zoo_first_step(kind, learner, state, batch):
    """``(loss, gradient over the trained leaves)`` of a zoo learner's first
    update on ``batch``: gradient descent's first support step of task 0,
    matching nets' task 0, ProtoNets' and ANIL's first train step."""
    if kind == "anil":
        return first_step(learner, state, batch)
    xs, xt, ys, yt = learner._decode(learner._device_batch(state, batch))
    bn = state.bn_state
    if kind == "gd":
        loss, _, _, grads = learner._task_step(state.theta, bn, xs[:1], ys[:1])
        return loss, grads
    if kind == "matching_nets":
        def loss_fn(p):
            return learner._task_losses(p, bn, xs[:1], ys[:1], xt[:1], yt[:1])[0][0], None
    else:
        def loss_fn(p):
            return learner._batch_loss(p, bn, xs, ys, xt, yt)
    loss, _, grads = learner._grads(loss_fn, state.theta)
    return loss, grads


def zoo_plain_phase(torch) -> dict:
    """Each zoo learner with the three fused flags against its plain-norm
    twin from the same weights (seed 104) on the train phase's batch: the
    first update's loss and gradient under the train phase's tolerances."""
    from howtotrainyourmamlpytorch_tpu_torch import models

    out = {}
    batch = train_batch(np.random.RandomState(2))
    for kind, config, cls_name, _ in ZOO:
        learner, plain = fused_and_plain(config, getattr(models, cls_name))
        state0 = learner.init_state(torch.Generator().manual_seed(104))
        out[kind] = compare_with_plain(
            zoo_first_step(kind, learner, state0, batch),
            zoo_first_step(kind, plain, state0, batch), f"zoo_plain {kind}",
        )
        del learner, plain, state0
    torch.cuda.empty_cache()
    return out


def north_star_batch(rng):
    """Random normalised 84x84 RGB images in the north star's episode
    shapes: 2 tasks, 5 classes, 5 support and 15 target images each."""
    xs = rng.randn(2, 5, 5, 3, 84, 84).astype(np.float32)
    xt = rng.randn(2, 5, 15, 3, 84, 84).astype(np.float32)
    ys = np.tile(np.arange(5).reshape(1, 5, 1), (2, 1, 5))
    yt = np.tile(np.arange(5).reshape(1, 5, 1), (2, 1, 15))
    return xs, xt, ys, yt


def remat_phase(torch, cases=None, chaotic=False) -> dict:
    """``remat_inner_steps`` on, as the CLI trains (the configs leave it at
    its default), at flagship width on the train phase's batch and at
    north-star width: the fused learner's first loss and meta-gradient
    bitwise equal to its own without remat (remat changes what a step
    keeps, not what it computes), and held to the plain-norm learner's
    with remat under the train phase's tolerances."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    out = {}
    for tag, config, batch in cases or (
        ("remat_flagship", FLAGSHIP, train_batch(np.random.RandomState(2))),
        ("remat_north_star", NORTH_STAR, north_star_batch(np.random.RandomState(3))),
    ):
        learner, plain = fused_and_plain(config)
        if not (learner.cfg.remat_inner_steps and plain.cfg.remat_inner_steps):
            fail(f"{tag}: remat_inner_steps is off")
        no_remat = type(learner)(dataclasses.replace(learner.cfg, remat_inner_steps=False))
        state0 = learner.init_state(torch.Generator().manual_seed(104))
        fused = first_step(learner, state0, batch)
        kept = first_step(no_remat, state0, batch)
        same = torch.equal(fused[0], kept[0]) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(fused[1]), tree_leaves(kept[1]))
        )
        if not same:
            fail(f"{tag}: remat changed the fused learner's first loss or "
                 f"meta-gradient ({float(fused[0])} against {float(kept[0])})")
        sensitivity = [
            first_step(plain, state0._replace(theta=one_ulp(torch, state0.theta, seed)),
                       batch)
            for seed in (SENSITIVITY_SEEDS if chaotic else ())
        ]
        out[tag] = {"bitwise_equal_without_remat": same, **compare_with_plain(
            fused, first_step(plain, state0, batch), tag, sensitivity or None
        )}
        del learner, plain, no_remat, state0, fused, kept
        torch.cuda.empty_cache()
    return out


def eager_steps(learner, state, batches, epoch):
    """The eager ``_train_step`` over ``batches`` at ``epoch``'s program
    variant, learning rate and importance vector: what ``run_train_iters``
    replays. Returns ``(state, {metric: (K,)})``."""
    import torch

    from howtotrainyourmamlpytorch_tpu_torch.models.common import set_injected_lr

    state = state._replace(opt_state=set_injected_lr(
        state.opt_state, learner._epoch_lr(epoch)
    ))
    importance = learner._importance(state, learner._train_importance(epoch))
    steps = []
    for batch in batches:
        state, m = learner._train_step(
            state, learner._device_batch(state, batch), importance,
            second_order=learner._use_second_order(epoch),
            final_only=learner._final_only(epoch),
        )
        steps.append(m)
    return state, {k: torch.stack([m[k] for m in steps])
                   for k in ("loss", "accuracy", "nonfinite")}


def graph_phase(torch, fn, cases=None, iters=GRAPH_PHASE_ITERS,
                repeats=TIMING_REPEATS) -> dict:
    """The captured train step against the eager one at both widths (or
    ``cases``: (tag, config, batch maker, MSL and final-only launches per
    iteration[, JSON keys])), remat on: K=``iters`` replays bit for bit
    against as many eager steps across both branches and an epoch change, a
    held state unchanged, every captured launch on the capture's stream;
    then capture, and over ``repeats`` repeats replay and eager, times."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    captured_streams = set()
    stream_of = fn._stream

    def recording_stream(x):
        handle = stream_of(x)
        if torch.cuda.is_current_stream_capturing():
            captured_streams.add(handle.value)
        return handle

    out = {}
    fn._stream = recording_stream
    try:
        for tag, config, make, msl, final, *overrides in cases or (
            ("flagship", FLAGSHIP, train_batch, CLI_FLAGSHIP_TRAIN,
             CLI_FLAGSHIP_TRAIN_FINAL),
            ("north_star", NORTH_STAR, north_star_batch, CLI_NORTH_TRAIN,
             CLI_NORTH_TRAIN_FINAL),
        ):
            captured_streams.clear()
            torch.cuda.reset_peak_memory_stats()
            base, _ = fused_and_plain(config, **(overrides[0] if overrides else {}))
            # An MSL horizon of 2 puts epoch 2 on the final-only branch. The
            # north star's schedule starts at its floor (constant 1e-3): a
            # floor a hundredth of the start makes the learning rate move.
            learner = type(base)(dataclasses.replace(
                base.cfg, multi_step_loss_num_epochs=2,
                min_learning_rate=base.cfg.meta_learning_rate / 100,
            ))
            if not learner.cfg.remat_inner_steps:
                fail(f"graph {tag}: remat_inner_steps is off")
            state = learner.init_state(torch.Generator().manual_seed(104))
            batches = [make(np.random.RandomState(20 + i)) for i in range(iters)]
            if learner._epoch_lr(0) == learner._epoch_lr(1):
                fail(f"graph {tag}: epochs 0 and 1 have one learning rate")
            checked = []
            for epoch in (0, 1, 2):
                held = [a.clone() for a in tree_leaves(state)]
                want, want_m = eager_steps(learner, state, batches, epoch)
                got, got_m = learner.run_train_iters(state, batches, epoch)
                torch.cuda.synchronize()
                for k in want_m:
                    if not torch.equal(got_m[k], want_m[k]):
                        fail(f"graph {tag} epoch {epoch}: {k} {got_m[k].tolist()} "
                             f"replayed, {want_m[k].tolist()} eager")
                if not same(got, want):
                    differ = [i for i, (x, y) in enumerate(
                        zip(tree_leaves(got), tree_leaves(want))) if not torch.equal(x, y)]
                    fail(f"graph {tag} epoch {epoch}: the replayed state differs "
                         f"from the eager steps' at leaves {differ}")
                if not all(torch.equal(a, b) for a, b in zip(tree_leaves(state), held)):
                    fail(f"graph {tag} epoch {epoch}: the dispatch changed the "
                         "state it was given")
                checked.append({"epoch": epoch, "final_only": learner._final_only(epoch),
                                "learning_rate": learner._epoch_lr(epoch),
                                "losses": got_m["loss"].tolist()})
                state = got
            graphs = learner._step_graphs
            branches = {g.key: g for g in graphs.graphs.values()}
            if set(branches) != {(True, False), (True, True)}:
                fail(f"graph {tag}: captured branches {sorted(branches)}")
            for key, want_launches in (((True, False), msl), ((True, True), final)):
                if branches[key].launches != want_launches:
                    fail(f"graph {tag} {key}: captured launches "
                         f"{branches[key].launches}, expected {want_launches}")
            if captured_streams != {graphs.stream.cuda_stream}:
                fail(f"graph {tag}: captured kernels on streams {captured_streams}, "
                     f"the capture's is {graphs.stream.cuda_stream}")
            replay_ms, eager_ms = [], []
            for _ in range(repeats):
                t0 = time.perf_counter()
                learner.run_train_iters(state, batches, 0)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                eager_steps(learner, state, batches, 0)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                replay_ms.append((t1 - t0) * 1e3 / iters)
                eager_ms.append((t2 - t1) * 1e3 / iters)
            for g in branches.values():
                check_replay(g, f"graph {tag}")
            out[tag] = {
                "iters": iters, "bitwise_equal_to_eager": True, "epochs": checked,
                "capture_ms": {("final_only" if k[1] else "msl"): g.capture_s * 1e3
                               for k, g in branches.items()},
                "replay_ms_per_iter": replay_ms, "eager_ms_per_iter": eager_ms,
                "launches_per_replay": {("final_only" if k[1] else "msl"): g.launches
                                        for k, g in branches.items()},
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            }
            del learner, state, graphs, branches
            torch.cuda.empty_cache()
    finally:
        fn._stream = stream_of
    return out


def graph_kernel_names(graph) -> list:
    """The function names of the kernel nodes of a captured
    ``torch.cuda.CUDAGraph`` kept with ``keep_graph=True``, read from the
    driver: every kernel a replay launches. Fails on a child-graph or
    conditional node (whose kernels this count would miss) and on a kernel
    node that the instantiated graph has disabled."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")

    def call(fn_name, *args):
        rc = getattr(cuda, fn_name)(*args)
        if rc != 0:
            fail(f"{fn_name} failed: CUresult {rc}")

    class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p),
                    *((d, ctypes.c_uint) for d in ("grid_x", "grid_y", "grid_z", "block_x",
                                                   "block_y", "block_z", "smem_bytes")),
                    ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                    ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    kernel, child, conditional = 0, 4, 13  # CUgraphNodeType
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    executable = ctypes.c_void_p(graph.raw_cuda_graph_exec())
    count = ctypes.c_size_t(0)
    call("cuGraphGetNodes", handle, None, ctypes.byref(count))
    nodes = (ctypes.c_void_p * count.value)()
    call("cuGraphGetNodes", handle, nodes, ctypes.byref(count))
    names = []
    for node in map(ctypes.c_void_p, nodes):
        kind = ctypes.c_int()
        call("cuGraphNodeGetType", node, ctypes.byref(kind))
        if kind.value in (child, conditional):
            fail(f"a captured graph holds a node of type {kind.value}")
        if kind.value != kernel:
            continue
        enabled = ctypes.c_uint()
        call("cuGraphNodeGetEnabled", executable, node, ctypes.byref(enabled))
        if not enabled.value:
            fail("a kernel node of a captured graph is disabled")
        params = KernelNodeParams()
        call("cuGraphKernelNodeGetParams_v2", node, ctypes.byref(params))
        name = ctypes.c_char_p()
        if params.func:
            call("cuFuncGetName", ctypes.byref(name), ctypes.c_void_p(params.func))
        else:
            call("cuKernelGetName", ctypes.byref(name), ctypes.c_void_p(params.kern))
        names.append(name.value.decode())
    return names


def check_replay(graph, tag) -> dict:
    """The fused-norm kernels one replay of a captured train step launches,
    counted in its graph's kernel nodes: they must be the launches its
    capture counted, which the launch numbers of the train and CLI phases
    multiply by the replays."""
    names = graph_kernel_names(graph.graph)
    nodes = {k: sum(symbol in n for n in names)
             for k, symbol in KERNEL_SYMBOLS.items()}
    if nodes != graph.launches:
        fail(f"{tag}: the {graph.key} graph holds the kernel nodes {nodes}, its "
             f"capture counted {graph.launches}")
    REPLAY_NODES.append({"phase": tag, "second_order": graph.key[0],
                         "final_only": graph.key[1], "kernel_nodes": len(names),
                         "kernels": nodes})
    return nodes


def graph_records(learner) -> dict:
    """``{key: (replays, launches per replay)}`` of the learner's captured
    train steps."""
    graphs = getattr(learner, "_step_graphs", None)
    if graphs is None:
        return {}
    return {key: (g.replays, dict(g.launches)) for key, g in graphs.graphs.items()}


def replayed_launches(before: dict, after: dict) -> dict:
    """Kernel launches the replays between two ``graph_records`` ran: each
    graph's captured launches times its new replays."""
    out = {}
    for key, (replays, launches) in after.items():
        n = replays - before.get(key, (0, None))[0]
        for name, count in launches.items():
            out[name] = out.get(name, 0) + n * count
    return out


def train_phase(torch, fn):
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        load_maml_config,
    )
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    cfg = load_maml_config(FLAGSHIP, fused_norm_train=True, fused_norm_pool=True)
    cfg = dataclasses.replace(cfg, remat_inner_steps=False)
    learner = MAMLFewShotLearner(cfg)
    plain = MAMLFewShotLearner(dataclasses.replace(cfg, backbone=dataclasses.replace(
        cfg.backbone, fused_norm_train=False, fused_norm_pool=False
    )))
    state0 = learner.init_state(torch.Generator().manual_seed(104))
    rng = np.random.RandomState(2)
    batch = train_batch(rng)
    learner.run_train_iter(state0, train_batch(rng), epoch=0)  # warm-up
    torch.cuda.synchronize()

    def run():
        state, losses, step_ms = state0, [], []
        for _ in range(TRAIN_ITERS):
            t0 = time.perf_counter()
            state, m = learner.run_train_iter(state, batch, epoch=0)
            losses.append(float(m["loss"]))  # synchronizes
            step_ms.append((time.perf_counter() - t0) * 1e3)
        return state, losses, step_ms

    graphs_before = graph_records(learner)
    (captured,) = [launches for _, launches in graphs_before.values()]
    if captured != TRAIN_LAUNCHES:
        fail(f"the captured train step launches {captured}, expected {TRAIN_LAUNCHES}")
    fn.reset_launch_counts()
    state, losses, step_ms = run()
    wrappers = dict(fn.launch_counts)
    launches = replayed_launches(graphs_before, graph_records(learner))
    if any(wrappers.values()) or launches != {
        k: n * TRAIN_ITERS for k, n in TRAIN_LAUNCHES.items()
    }:
        fail(f"train launches {launches} by replays and {wrappers} by the "
             f"wrappers over {TRAIN_ITERS} iterations, expected "
             f"{TRAIN_LAUNCHES} per iteration, all by replays")
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"train losses not finite and falling: {losses}")
    again, losses_again, _ = run()
    same = losses_again == losses and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(state))
    )
    if not same:
        fail(f"a rerun from the same state differs: {losses} vs {losses_again}")

    # The first step against the plain-norm learner on the same state.
    vs_plain = compare_with_plain(
        first_step(learner, state0, batch), first_step(plain, state0, batch), "train"
    )

    # One past-horizon iteration (its own graph): only the last step's
    # target pass runs.
    known = set(graph_records(learner))
    learner.run_train_iter(state, batch, epoch=cfg.multi_step_loss_num_epochs)
    torch.cuda.synchronize()
    (final_only_launches,) = [
        launches for key, (_, launches) in graph_records(learner).items()
        if key not in known
    ]

    for g in learner._step_graphs.graphs.values():
        check_replay(g, "train")

    _, vm, logits = learner.run_validation_iter(state, train_batch(rng))
    if logits.shape != (8, 5, 5) or not torch.isfinite(logits).all():
        fail(f"validation logits {tuple(logits.shape)} not finite")
    return {
        "iterations": TRAIN_ITERS,
        "meta_iters_per_s": TRAIN_ITERS / (sum(step_ms) / 1e3),
        "step_p50_ms": float(np.median(step_ms)),
        "step_ms": step_ms,
        "losses": losses,
        "rerun_bitwise_equal": same,
        **vs_plain,
        "launches": launches,
        "launches_per_iter": {k: v / TRAIN_ITERS for k, v in launches.items()},
        "final_only_launches_per_iter": final_only_launches,
        "validation_loss": float(vm["loss"]),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }



def write_omniglot_tree(root, classes=250, images=20):
    """``root/alphabet<a>/character<c>/<i>.png``: 28x28 1-bit images,
    sparse strokes on a blank ground."""
    from PIL import Image

    rng = np.random.RandomState(5)
    for c in range(classes):
        d = os.path.join(root, f"alphabet{c // 10:02d}", f"character{c % 10:02d}")
        os.makedirs(d)
        proto = rng.rand(28, 28) > 0.85
        for i in range(images):
            img = proto ^ (rng.rand(28, 28) > 0.97)
            Image.fromarray(img).save(os.path.join(d, f"{i}.png"))


def write_imagenet_tree(root, images=20):
    """``root/{train,val,test}/n<c>/<i>.png``: 84x84 RGB, 64/16/20 classes."""
    from PIL import Image

    rng = np.random.RandomState(6)
    for split, classes in (("train", 64), ("val", 16), ("test", 20)):
        for c in range(classes):
            d = os.path.join(root, split, f"n{c:04d}")
            os.makedirs(d)
            base = rng.randint(0, 256, (84, 84, 3))
            for i in range(images):
                pixels = (base + rng.randint(-40, 41, (84, 84, 3))).clip(0, 255)
                Image.fromarray(pixels.astype(np.uint8)).save(
                    os.path.join(d, f"{i}.png")
                )


class CliProbe:
    """Records, around each learner call that a CLI run makes, the kernel
    launches it made and its wall time, how long the loop was blocked on
    its input, and the wall time of each train loop (capture and epoch
    boundaries included). A MAML-family train call's launches are its
    replays' (each graph's captured launches times its new replays) and,
    when it captured a graph, the wrappers' launches of the warm-up and the
    capture; a shared-weights learner's train call (one iteration, eager)
    launches through the wrappers alone. With ``sync`` set, each learner
    call ends in a synchronize, so that its wall time is its own; without,
    the loop runs as the CLI runs it. Train iterations are numbered from
    the builder's ``current_iter`` at each train loop's start."""

    def __init__(self, torch, fn):
        from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import (
            ExperimentBuilder,
        )
        from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
        from howtotrainyourmamlpytorch_tpu_torch.models.common import (
            SharedWeightsLearner,
        )

        self.torch, self.fn = torch, fn
        self.targets = [(MAMLFewShotLearner, "run_train_iter"),
                        (MAMLFewShotLearner, "run_train_iters"),
                        (SharedWeightsLearner, "run_train_iter"),
                        (MAMLFewShotLearner, "run_validation_iter"),
                        (SharedWeightsLearner, "run_validation_iter"),
                        (ExperimentBuilder, "_pop_input_waits"),
                        (ExperimentBuilder, "_train_loop")]
        self.train, self.eval, self.waits, self.loops = [], [], [], []
        self.sync = True
        self.k = 1
        self.prefetch = -1
        self.next_iteration = None
        # Graphs captured by the current CLI call, for check_replay.
        self.captured = []

    def _timed(self, orig, log, train):
        def call(learner, state, *args, **kwargs):
            before = dict(self.fn.launch_counts)
            graphs_before = graph_records(learner) if train else {}
            t0 = time.perf_counter()
            out = orig(learner, state, *args, **kwargs)
            if self.sync:
                self.torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec = {"t0": t0, "t1": t1, "synchronized": self.sync,
                   "launches": {k: self.fn.launch_counts[k] - before[k]
                                for k in before}}
            if train:  # each meta-update's loss, read after the phase
                rec["loss"] = out[1]["loss"]
            if train and not hasattr(learner, "_step_graphs"):
                rec.update(iterations=1, k=self.k, final_only=False, per_replay=None,
                           captured={}, replayed=None, iteration=self.next_iteration)
                self.next_iteration += 1
            elif train:
                after = graph_records(learner)
                replayed = [k for k in after
                            if after[k][0] != graphs_before.get(k, (0, None))[0]]
                if len(replayed) != 1:
                    fail(f"a train call replayed the graphs {replayed}")
                (key,) = replayed
                self.captured.extend((learner, learner._step_graphs.graphs[k])
                                     for k in after if k not in graphs_before)
                rec.update(
                    iterations=after[key][0] - graphs_before.get(key, (0, None))[0],
                    k=self.k, final_only=key[1], per_replay=after[key][1],
                    captured={k: after[k][1] for k in after if k not in graphs_before},
                    replayed=replayed_launches(graphs_before, after),
                )
                rec["iteration"] = self.next_iteration
                self.next_iteration += rec["iterations"]
            log.append(rec)
            return out
        return call

    def __enter__(self):
        self.saved = [getattr(cls, name) for cls, name in self.targets]
        train, train_k, train_shared, evaluate, evaluate_shared, waits_of, loop = (
            self.saved
        )

        def pop_input_waits(builder):
            data_wait, stage_wait = waits_of(builder)
            # What blocked the loop: the staged group, or the loader inline.
            self.waits.append(stage_wait if builder._stager is not None else data_wait)
            return data_wait, stage_wait

        def train_loop(builder, total_iters):
            start, t0 = len(self.train), time.perf_counter()
            waits = len(self.waits)
            self.next_iteration = int(builder.state["current_iter"])
            try:
                return loop(builder, total_iters)
            finally:
                seconds = time.perf_counter() - t0
                iterations = sum(r["iterations"] for r in self.train[start:])
                self.loops.append({
                    "synchronized": self.sync, "k": self.k,
                    "device_prefetch": self.prefetch,
                    "iterations": iterations, "seconds": seconds,
                    "meta_iters_per_s": iterations / seconds,
                    "input_wait_s": sum(self.waits[waits:]),
                })

        for (cls, name), fn in zip(self.targets, (
            self._timed(train, self.train, True),
            self._timed(train_k, self.train, True),
            self._timed(train_shared, self.train, True),
            self._timed(evaluate, self.eval, False),
            self._timed(evaluate_shared, self.eval, False),
            pop_input_waits, train_loop,
        )):
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for (cls, name), fn in zip(self.targets, self.saved):
            setattr(cls, name, fn)

    def per_step(self, starts, per_epoch: int) -> dict:
        """Meta-iterations/s, step p50 ms and the input-wait share over the
        synchronized K=1 train iterations after the first two of each call
        (``starts``: the index of each call's first), leaving out the
        cycles that hold an epoch boundary."""
        steps, cycles, waits = [], [], []
        ends = [*starts[1:], len(self.train)]
        for start, end in zip(starts, ends):
            for i in range(start + 2, end):
                rec = self.train[i]
                if (rec["iteration"] % per_epoch == 0 or not rec["synchronized"]
                        or rec["k"] != 1):
                    continue
                steps.append((rec["t1"] - rec["t0"]) * 1e3)
                cycles.append(rec["t1"] - self.train[i - 1]["t1"])
                waits.append(self.waits[i])
        return {
            "timed_iterations": len(steps),
            "meta_iters_per_s": len(cycles) / sum(cycles),
            "step_p50_ms": float(np.median(steps)),
            "input_wait_share": sum(waits) / sum(cycles),
        }


def run_cli(main, argv) -> dict:
    try:
        return main(argv)
    except SystemExit as exc:
        fail(f"the CLI exited early ({exc.code}) on {argv}")


def cli_phase(torch, fn, name, config, tree_writer, overrides, calls, want_train,
              want_train_final, want_eval, main=None, dataset_dir=None, inspect=None):
    """Writes the tree (unless ``dataset_dir`` already holds it) and a
    derived JSON under a temporary directory and drives the entry point's
    ``main`` (``train_maml_system.main`` by default) once per entry of
    ``calls`` (extra JSON keys, extra argv, whether the probe synchronizes
    after each learner call, K, ``--device_prefetch``); after each, holds
    each graph it captured to its kernel nodes (``check_replay``). Returns the
    phase's measurements, each meta-update's train loss and the last
    checkpoint's arrays, and ``inspect(experiment_dir, argv)``'s result
    (the last call's argv) under ``inspected``. The directory is removed at
    the end."""
    import tempfile

    from howtotrainyourmamlpytorch_tpu_torch.data.fast_synth import native_available
    from howtotrainyourmamlpytorch_tpu_torch.models.step_graph import WARMUP_STEPS
    from howtotrainyourmamlpytorch_tpu_torch import train_maml_system

    main = main or train_maml_system.main
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmp:
        dataset = overrides["dataset_name"]
        t0 = time.perf_counter()
        if dataset_dir is None:
            tree_writer(os.path.join(tmp, dataset))
        tree_s = time.perf_counter() - t0
        os.environ["DATASET_DIR"] = dataset_dir or tmp
        with open(config) as f:
            base = json.load(f)
        base.update(overrides, dataset_path=dataset,
                    experiment_name=os.path.join(tmp, "experiment"))
        logs = os.path.join(tmp, "experiment", "logs")
        results, probe = [], CliProbe(torch, fn)
        torch.cuda.reset_peak_memory_stats()
        start_gb = torch.cuda.memory_allocated() / 1e9
        fn.reset_launch_counts()
        with probe:
            for extra_json, extra_argv, sync, k, prefetch in calls:
                probe.sync, probe.k, probe.next_iteration = sync, k, None
                probe.prefetch = prefetch
                path = os.path.join(tmp, f"config_{len(results)}.json")
                with open(path, "w") as f:
                    json.dump({**base, **extra_json}, f)
                start = len(probe.train)
                argv = ["--name_of_args_json_file", path, *FUSED_ARGV,
                        "--iters_per_dispatch", str(k),
                        "--device_prefetch", str(prefetch), *extra_argv]
                test = run_cli(main, argv)
                results.append({"test": {k: float(v) for k, v in test.items()},
                                "start": start, "k": k, "device_prefetch": prefetch,
                                "first_iteration": probe.train[start]["iteration"]})
                for learner, graph in probe.captured:
                    check_replay(graph, name)
                probe.captured.clear()
        wrappers = dict(fn.launch_counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # Train calls: each replay runs the launches its capture recorded;
        # a call that captured ran the wrappers for the warm-up and capture.
        executed = dict.fromkeys(wrappers, 0)
        counted = dict.fromkeys(wrappers, 0)
        for rec in probe.train:
            want = want_train_final if rec["final_only"] else want_train
            if rec["per_replay"] is None:  # an eager learner's iteration
                if rec["launches"] != want:
                    fail(f"{name}: a train iteration launches {rec['launches']}, "
                         f"expected {want}")
                for k in wrappers:
                    counted[k] += want[k]
                    executed[k] += want[k]
                continue
            if rec["per_replay"] != want:
                fail(f"{name}: a train iteration launches {rec['per_replay']} on "
                     f"replay, expected {want}")
            capture = {k: sum(c[k] for c in rec["captured"].values()) for k in wrappers}
            if rec["launches"] != {k: (WARMUP_STEPS + 1) * v for k, v in capture.items()}:
                fail(f"{name}: a train call's wrappers launched {rec['launches']}, "
                     f"its captures recorded {capture}")
            for k in wrappers:
                counted[k] += rec["launches"][k]
                executed[k] += rec["replayed"][k] + WARMUP_STEPS * capture[k]
        bad = [r["launches"] for r in probe.eval if r["launches"] != want_eval]
        if bad:
            fail(f"{name}: eval iteration launches {bad[0]}, expected {want_eval}")
        for k in wrappers:
            counted[k] += len(probe.eval) * want_eval[k]
            executed[k] += len(probe.eval) * want_eval[k]
        if wrappers != counted or not all(executed[k] for k in executed
                                          if want_train[k] or want_eval[k]):
            fail(f"{name}: wrapper launches {wrappers}, expected {counted}")
        with open(os.path.join(logs, "summary_statistics.json")) as f:
            stats = json.load(f)
        with np.load(os.path.join(tmp, "experiment", "saved_models",
                                  "train_model_latest")) as z:
            archive = {k: z[k] for k in z.files if not k.startswith("__")}
        train_losses = torch.cat([r["loss"].reshape(-1).float() for r in probe.train])
        with open(os.path.join(logs, "summary_statistics.csv")) as f:
            csv_rows = len(f.read().splitlines()) - 1
        losses = [v for k, vs in stats.items() if "loss" in k and "importance" not in k
                  for v in vs]
        if not np.isfinite(losses).all():
            fail(f"{name}: non-finite losses in the statistics: {stats}")
        for r in results:
            if not 0.0 <= r["test"]["test_accuracy_mean"] <= 1.0:
                fail(f"{name}: test accuracy {r['test']}")
        per_epoch = int(base["total_iter_per_epoch"])
        eval_ms = [(r["t1"] - r["t0"]) * 1e3 for r in probe.eval if r["synchronized"]]
        inspected = inspect(os.path.join(tmp, "experiment"), argv) if inspect else None
        return {
            "native_episode_assembly": native_available(),
            "eval_ms_per_iter_p50": float(np.median(eval_ms)),
            "tree_write_s": tree_s,
            "epochs": csv_rows,
            "train_iterations": sum(r["iterations"] for r in probe.train),
            "train_calls": len(probe.train),
            "eval_iterations": len(probe.eval),
            "per_step": probe.per_step(
                [r["start"] for r in results], per_epoch
            ),
            "window": probe.loops,
            "peak_mem_gb": peak_gb,
            "mem_at_start_gb": start_gb,
            "val_accuracy": stats["val_accuracy_mean"],
            "train_loss": stats["train_loss_mean"],
            "val_loss": stats["val_loss_mean"],
            "calls": results,
            "launches": executed,
            "wrapper_launches": wrappers,
            "launches_per_train_iter": {"msl": want_train, "final_only": want_train_final},
            "launches_per_eval_iter": want_eval,
            "train_losses": train_losses.cpu().tolist(),
            "archive": archive,
            "inspected": inspected,
        }


def cli_flagship_phase(torch, fn, dataset_dir):
    per_epoch = 10
    latest = ["--continue_from_epoch", "latest"]
    out = cli_phase(
        torch, fn, "cli_flagship", FLAGSHIP, write_omniglot_tree,
        {"dataset_name": "omniglot_synth", "total_epochs": 2,
         "total_iter_per_epoch": per_epoch, "num_evaluation_tasks": 8,
         "multi_step_loss_num_epochs": 2},
        [({}, [], True, 1, -1),
         ({"total_epochs": 3}, latest, False, 1, -1),
         ({"total_epochs": 4}, latest, False, GRAPH_ITERS, -1),
         ({"total_epochs": 5}, latest, False, GRAPH_ITERS, 0),
         ({"total_epochs": 6}, latest, False, 1, 0)],
        CLI_FLAGSHIP_TRAIN, CLI_FLAGSHIP_TRAIN_FINAL, CLI_FLAGSHIP_EVAL,
        dataset_dir=dataset_dir,
    )
    if out["epochs"] != 6:
        fail(f"cli_flagship: {out['epochs']} CSV rows, expected 6")
    if [c["first_iteration"] for c in out["calls"]] != [
        0, *(e * per_epoch for e in range(2, 6))
    ]:
        fail(f"cli_flagship: the calls started at {out['calls']}")
    return out


def cli_north_star_phase(torch, fn):
    per_epoch = 6
    latest = ["--continue_from_epoch", "latest"]
    out = cli_phase(
        torch, fn, "cli_north_star", NORTH_STAR, write_imagenet_tree,
        {"dataset_name": "imagenet_synth", "total_epochs": 1,
         "total_iter_per_epoch": per_epoch, "num_evaluation_tasks": 4,
         "multi_step_loss_num_epochs": 1},
        [({}, [], True, 1, -1),
         ({"total_epochs": 2}, latest, False, 1, -1),
         ({"total_epochs": 3}, latest, False, GRAPH_ITERS, -1),
         ({"total_epochs": 4}, latest, False, GRAPH_ITERS, 0),
         ({"total_epochs": 5}, latest, False, 1, 0)],
        CLI_NORTH_TRAIN, CLI_NORTH_TRAIN_FINAL, CLI_NORTH_EVAL,
    )
    if out["epochs"] != 5:
        fail(f"cli_north_star: {out['epochs']} CSV rows, expected 5")
    if [c["first_iteration"] for c in out["calls"]] != [e * per_epoch for e in range(5)]:
        fail(f"cli_north_star: the calls started at {out['calls']}")
    return out

def cli_zoo_phase(torch, fn, kind, dataset_dir):
    """A zoo learner's entry point on the Omniglot tree in ``dataset_dir``
    with the three fused flags: 2 epochs of 4 iterations (synchronized
    after each learner call), 8 evaluation tasks and the ensemble test,
    then ``latest`` to a 3rd epoch as the CLI runs (gradient descent at
    ``--iters_per_dispatch 5``, which it does not act on; ANIL past an MSL
    horizon of 2, its final-only graph)."""
    import importlib

    per_epoch = 4
    _, config, _, module = next(z for z in ZOO if z[0] == kind)
    main = importlib.import_module(
        f"howtotrainyourmamlpytorch_tpu_torch.{module}"
    ).main
    want_train, want_train_final, want_eval = ZOO_LAUNCHES[kind]
    out = cli_phase(
        torch, fn, f"cli_{kind}", config, write_omniglot_tree,
        {"dataset_name": "omniglot_synth", "total_epochs": 2,
         "total_iter_per_epoch": per_epoch, "num_evaluation_tasks": 8,
         "multi_step_loss_num_epochs": 2},
        [({}, [], True, 1, -1),
         ({"total_epochs": 3}, ["--continue_from_epoch", "latest"], False,
          GRAPH_ITERS if kind == "gd" else 1, -1)],
        want_train, want_train_final, want_eval, main=main, dataset_dir=dataset_dir,
    )
    if out["epochs"] != 3:
        fail(f"cli_{kind}: {out['epochs']} CSV rows, expected 3")
    if [c["first_iteration"] for c in out["calls"]] != [0, 2 * per_epoch]:
        fail(f"cli_{kind}: the calls started at {out['calls']}")
    if out["train_iterations"] != 3 * per_epoch:
        fail(f"cli_{kind}: {out['train_iterations']} train iterations, expected "
             f"{3 * per_epoch}")
    return out


def resnet_graph_phase(torch, fn) -> dict:
    """The ResNet-12 learner from its JSON with the three fused flags and
    remat on, as the CLI trains: the graph phase's checks (K=3 replays
    bitwise equal to 3 eager steps at epochs 0, 1 and 2, past an MSL horizon
    of 2; the captures' launches and every graph's kernel nodes held to
    ``CLI_RESNET12_*``; one timing repeat: an eager ResNet-12 step takes
    over a second) and the remat phase's (the first loss and meta-gradient
    bitwise equal without remat, and held to the plain-norm learner's)."""
    out = graph_phase(torch, fn, [("resnet12", RESNET12, train_batch,
                                   CLI_RESNET12_TRAIN, CLI_RESNET12_TRAIN_FINAL)],
                      repeats=1)
    out.update(remat_phase(torch, [
        ("remat_resnet12", RESNET12, train_batch(np.random.RandomState(2))),
    ], chaotic=True))
    return out


def cli_resnet12_phase(torch, fn, dataset_dir):
    """``train_maml_system.main`` on the ResNet-12 JSON with the three fused
    flags over the Omniglot tree in ``dataset_dir``: 2 epochs of 4
    iterations (synchronized after each learner call), 8 evaluation tasks
    and the ensemble test, then ``latest`` to a 3rd epoch at
    ``--iters_per_dispatch 5``, past an MSL horizon of 2 (the final-only
    graph). Launches per iteration held to ``CLI_RESNET12_*``."""
    per_epoch = 4
    out = cli_phase(
        torch, fn, "cli_resnet12", RESNET12, write_omniglot_tree,
        {"dataset_name": "omniglot_synth", "total_epochs": 2,
         "total_iter_per_epoch": per_epoch, "num_evaluation_tasks": 8,
         "multi_step_loss_num_epochs": 2},
        [({}, [], True, 1, -1),
         ({"total_epochs": 3}, ["--continue_from_epoch", "latest"], False,
          GRAPH_ITERS, -1)],
        CLI_RESNET12_TRAIN, CLI_RESNET12_TRAIN_FINAL, CLI_RESNET12_EVAL,
        dataset_dir=dataset_dir,
    )
    if out["epochs"] != 3:
        fail(f"cli_resnet12: {out['epochs']} CSV rows, expected 3")
    if [c["first_iteration"] for c in out["calls"]] != [0, 2 * per_epoch]:
        fail(f"cli_resnet12: the calls started at {out['calls']}")
    if out["train_iterations"] != 3 * per_epoch:
        fail(f"cli_resnet12: {out['train_iterations']} train iterations")
    return out


def backbone_options_phase(torch, fn) -> dict:
    """The VGG's other options on the flagship JSON, the three fused flags
    on, remat off: ``max_pooling False`` (stride-2 convs, the fused norm
    unpooled at 14, 7, 4 and 2 pixels, a global average pool),
    ``norm_layer layer_norm`` and ``block_order norm_conv`` (neither has a
    fused site). For each, the first second-order step's loss and
    meta-gradient against the plain-norm learner's (held to the train
    phase's tolerances where the kernels run, bitwise where none does) and
    one ``run_validation_iter`` with finite logits; the launches of both
    held to ``BACKBONE_OPTION_LAUNCHES``."""
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    out = {}
    batch = train_batch(np.random.RandomState(2))
    for tag, overrides in BACKBONE_OPTIONS:
        learner, plain = (
            type(a)(dataclasses.replace(a.cfg, remat_inner_steps=False))
            for a in fused_and_plain(FLAGSHIP, **overrides)
        )
        state0 = learner.init_state(torch.Generator().manual_seed(104))
        fn.reset_launch_counts()
        fused = first_step(learner, state0, batch)
        _, metrics, logits = learner.run_validation_iter(
            state0, train_batch(np.random.RandomState(3))
        )
        torch.cuda.synchronize()
        launches = dict(fn.launch_counts)
        if launches != BACKBONE_OPTION_LAUNCHES[tag]:
            fail(f"backbone_options {tag}: launches {launches}, expected "
                 f"{BACKBONE_OPTION_LAUNCHES[tag]}")
        if logits.shape != (8, 5, 5) or not torch.isfinite(logits).all():
            fail(f"backbone_options {tag}: validation logits {tuple(logits.shape)}")
        reference = first_step(plain, state0, batch)
        res = {"launches": launches, "validation_loss": float(metrics["loss"]),
               "first_loss": float(fused[0])}
        if any(launches.values()):
            res.update(compare_with_plain(fused, reference, f"backbone_options {tag}"))
        elif not (torch.equal(fused[0], reference[0]) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(fused[1]),
                                                  tree_leaves(reference[1])))):
            fail(f"backbone_options {tag}: no kernel runs, yet the first step "
                 "differs from the plain-norm learner's")
        out[tag] = res
        del learner, plain, state0, fused, reference
    torch.cuda.empty_cache()
    return out


def bf16_gap(torch, got, want) -> tuple[float, float, float]:
    """``(largest gap over its bar, median gap, largest gap in bfloat16
    ulps)`` of bfloat16 ``got`` against ``want``: the bar of each element is
    one bfloat16 ulp of ``want`` plus ATOL."""
    gap = (got.float() - want.float()).abs()
    _, exponent = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(gap), exponent - 8)
    return (float((gap / (ulp + ATOL)).max()), float(gap.median()),
            float((gap / ulp).max()))


def check_bf16_kernels(torch, fn, shape, gen, pool: bool, slope=SLOPE) -> dict:
    """All four kernels on bfloat16 ``x`` and cotangent at ``shape`` (K5
    where ``pool``), against their bfloat16 plain versions on the same
    inputs and statistics (``BF16_*`` bars), two calls bitwise equal, both
    forward entries' statistics bitwise equal; then graph-replay times at
    2-byte I/O bounds."""
    x32, gamma, beta = _inputs(torch, shape, gen)
    x = x32.to(torch.bfloat16)
    g = torch.randn(shape, device=x.device, generator=gen).to(torch.bfloat16)
    eps = fn.EPS
    y, mean, var = fn.bn_stats_act(x, gamma, beta, eps, slope)
    stats = fn.bn_stats(x)
    bwd = fn.bn_act_bwd(x, g, mean, var, gamma, beta, eps, slope)
    again = fn.bn_act_bwd(x, g, mean, var, gamma, beta, eps, slope)
    pooled = fn.bn_act_pool_apply(x, mean, var, gamma, beta, eps, slope) if pool else None
    torch.cuda.synchronize()
    if y.dtype != torch.bfloat16 or bwd[0].dtype != torch.bfloat16:
        fail(f"bf16 kernels at {shape} returned {y.dtype} and {bwd[0].dtype}")
    if not all(torch.equal(a, b) for a, b in zip((mean, var, *bwd), (*stats, *again))):
        fail(f"bf16 kernels at {shape}: two calls or the two forward entries differ")
    p_mean, p_var = fn.plain_stats(x)
    p_dx, p_dgamma, p_dbeta = fn.plain_bwd(x, g, mean, var, gamma, beta, eps, slope)
    errs = {}
    for name, got, want in (("mean", mean, p_mean), ("var", var, p_var)):
        err = float((got - want).abs().max())
        if err > BF16_STAT_RTOL * float(want.abs().max()):
            fail(f"bn_stats in bf16 at {shape}: {name} off by {err}")
        errs[name] = err
    full = [("y", y, fn.plain_apply(x, mean, var, gamma, beta, eps, slope)),
            ("dx", bwd[0], p_dx)]
    if pool:
        full.append(("pooled", pooled, fn.plain_pool_apply(x, mean, var, gamma, beta,
                                                            eps, slope)))
    for name, got, want in full:
        over, median, ulps = bf16_gap(torch, got, want)
        if over > 1.0 or median != 0.0:
            fail(f"bf16 kernels at {shape} slope {slope}: {name} past one bfloat16 "
                 f"ulp (+{ATOL}) by {over}x, median gap {median}")
        errs[name] = float((got.float() - want.float()).abs().max())
        errs[f"{name}_ulps"] = ulps
    for name, got, want in (("dgamma", bwd[1], p_dgamma), ("dbeta", bwd[2], p_dbeta)):
        err, ok = err_ok(got, want)
        if not ok:
            fail(f"bn_act_bwd in bf16 at {shape}: {name} off by {err}")
        errs[name] = err
    runs = {
        "bn_stats": (lambda: fn.bn_stats(x), lambda: fn.plain_stats(x),
                     ("mean", "var")),
        "bn_stats_act": (lambda: fn.bn_stats_act(x, gamma, beta, eps, slope),
                         lambda: fn.plain_apply(x, *fn.plain_stats(x), gamma, beta,
                                                eps, slope), ("y", "mean", "var")),
        "bn_act_bwd": (lambda: fn.bn_act_bwd(x, g, mean, var, gamma, beta, eps, slope),
                       lambda: fn.plain_bwd(x, g, mean, var, gamma, beta, eps, slope),
                       ("dx", "dgamma", "dbeta")),
    }
    if pool:
        runs["bn_act_pool_apply"] = (
            lambda: fn.bn_act_pool_apply(x, mean, var, gamma, beta, eps, slope),
            lambda: fn.plain_pool_apply(x, mean, var, gamma, beta, eps, slope),
            ("pooled",))
    calls = max(2, timing_reps(shape) // 5)
    out = {}
    for name, (kernel, plain, keys) in runs.items():
        b, by = bound_ms(name, shape, elem_bytes=2)
        out[name] = {
            "max_abs_err": max(errs[k] for k in keys),
            "max_ulps": max((errs.get(f"{k}_ulps", 0.0) for k in keys)),
            "ms": graph_ms(torch, kernel, calls), "plain_ms": graph_ms(torch, plain, calls),
            "bound_ms": b, "bound_by": by,
        }
    return out


def cli_bf16_phase(torch, fn, dataset_dir) -> dict:
    """``train_maml_system.main`` on the bf16 flagship JSON with the three
    fused flags over the Omniglot tree in ``dataset_dir``, MSL horizon 2:
    first at ``--compute_dtype float32`` (2 epochs of 10 iterations, the
    reference), then at ``--compute_dtype bfloat16``: 2 epochs of 10
    iterations with 16 validation tasks and the ensemble, ``latest`` to a
    3rd epoch at K=1 and to a 4th at K=5 (both final-only). Launches per
    iteration held to the flagship's counts (the dtype routes nothing
    elsewhere); every loss finite; within JAX's bf16 bar of the float32
    run: the first iteration's loss (one state, one batch: the dtype alone)
    and both epochs' mean train and validation losses. Past the first
    update the two runs' losses part iteration by iteration: Adam moves
    every parameter by about its learning rate whatever the gradient's
    size, so a rounding-level difference in a near-zero gradient becomes a
    full step (the task_chunk phase's float32 reassociation moves the
    second loss by 2%); the per-iteration gaps over the first 20 are
    printed."""
    per_epoch = 10
    latest = ["--continue_from_epoch", "latest"]
    base = {"dataset_name": "omniglot_synth", "total_epochs": 2,
            "total_iter_per_epoch": per_epoch, "num_evaluation_tasks": 16,
            "multi_step_loss_num_epochs": 2}
    want = (CLI_FLAGSHIP_TRAIN, CLI_FLAGSHIP_TRAIN_FINAL, CLI_FLAGSHIP_EVAL)
    f32 = cli_phase(torch, fn, "cli_bf16_f32", BF16_CONFIG, write_omniglot_tree, base,
                    [({}, ["--compute_dtype", "float32"], True, 1, -1)], *want,
                    dataset_dir=dataset_dir)
    out = cli_phase(
        torch, fn, "cli_bf16", BF16_CONFIG, write_omniglot_tree, base,
        [({}, BF16_ARGV, True, 1, -1),
         ({"total_epochs": 3}, latest + BF16_ARGV, False, 1, -1),
         ({"total_epochs": 4}, latest + BF16_ARGV, False, GRAPH_ITERS, -1)],
        *want, dataset_dir=dataset_dir,
    )
    if out["epochs"] != 4 or [c["first_iteration"] for c in out["calls"]] != [
            0, 2 * per_epoch, 3 * per_epoch]:
        fail(f"cli_bf16: {out['epochs']} CSV rows, calls at {out['calls']}")
    losses = np.asarray(out["train_losses"])
    ref = np.asarray(f32["train_losses"])
    n = 2 * per_epoch
    if len(losses) != 4 * per_epoch or len(ref) != n or not np.isfinite(losses).all():
        fail(f"cli_bf16: {len(losses)} bf16 and {len(ref)} float32 losses")
    gap = np.abs(losses[:n] - ref)
    means = [(out[key][:2], f32[key]) for key in ("train_loss", "val_loss")]
    held = [(losses[:1], ref[:1])] + means
    if any((np.abs(np.asarray(a) - np.asarray(b))
            > BF16_LOSS_ATOL + BF16_LOSS_RTOL * np.abs(np.asarray(b))).any()
           for a, b in held):
        fail(f"cli_bf16: losses past JAX's bf16 bar of the float32 run: first "
             f"iteration {losses[0]} against {ref[0]}, epoch means {means}")
    out["float32_reference"] = {k: f32[k] for k in (
        "per_step", "window", "peak_mem_gb", "val_accuracy", "train_loss", "launches")}
    out["loss_gap_vs_float32"] = {
        "max": float(gap.max()), "mean": float(gap.mean()),
        "first": float(gap[0]),
        "past_bar": int((gap > BF16_LOSS_ATOL + BF16_LOSS_RTOL * np.abs(ref)).sum()),
        "epoch_means": {k: [list(map(float, a)), list(map(float, b))]
                        for k, (a, b) in zip(("train", "val"), means)},
    }
    cli_f32 = {k: v for k, v in f32.items() if k != "archive"}
    return out, cli_f32


def device_augment_phase(torch, fn, dataset_dir) -> dict:
    """The flagship CLI (three fused flags) with ``--device_augment True``
    (raw episodes and their quarter turns staged to the card, rotated in
    the replayed step) against the same CLI rotating on the host: one
    epoch of 3 replayed iterations from one seed, 8 validation tasks and
    the ensemble. Each iteration's loss and the last checkpoint bitwise
    equal (JAX's contract, tests/test_wire_codec.py:222-285)."""
    base = {"dataset_name": "omniglot_synth", "total_epochs": 1,
            "total_iter_per_epoch": 3, "num_evaluation_tasks": 8}
    runs = {}
    for tag, argv in (("device_augment", ["--device_augment", "True"]),
                      ("device_augment_host", [])):
        runs[tag] = cli_phase(
            torch, fn, tag, FLAGSHIP, write_omniglot_tree, base,
            [({}, argv, True, 1, -1)], CLI_FLAGSHIP_TRAIN, CLI_FLAGSHIP_TRAIN_FINAL,
            CLI_FLAGSHIP_EVAL, dataset_dir=dataset_dir,
        )
    dev, host = runs["device_augment"], runs["device_augment_host"]
    if dev["train_losses"] != host["train_losses"] or len(dev["train_losses"]) != 3:
        fail(f"device_augment: losses {dev['train_losses']} against the host's "
             f"{host['train_losses']}")
    if dev["archive"].keys() != host["archive"].keys() or not all(
            np.array_equal(dev["archive"][k], host["archive"][k]) for k in dev["archive"]):
        fail("device_augment: the checkpoint differs from the host-rotated run's")
    return {tag: {k: v for k, v in r.items() if k != "archive"}
            for tag, r in runs.items()}


def _phase_launches(fn, learners, records) -> dict:
    """The kernel launches since the last ``reset_launch_counts``: the
    wrappers' and, for each learner's captured steps, the replays since
    ``records`` (per learner, ``graph_records`` when the phase began)."""
    out = dict(fn.launch_counts)
    for learner, before in zip(learners, records):
        for k, v in replayed_launches(before, graph_records(learner)).items():
            out[k] += v
    return out


def task_chunk_phase(torch, fn) -> dict:
    """``task_chunk`` against the full batch from one state (seed 104), the
    three fused flags and remat on: the flagship's 8 tasks in chunks of 2
    and of 4, the north star's 2 in chunks of 1. The first second-order
    step's loss within 1e-5 relative (tests/test_task_chunk.py:107) and
    each meta-gradient leaf at the GRAD bar, or within ROUTING_RTOL where a
    tie routes otherwise (cuDNN's algorithm for a group count of its own
    moves the inputs by an ulp; the north star's step is ill-conditioned
    at its ties, §C of ROADMAP.md); then one K=3 dispatch of each
    (the chunked step captured and replayed), the chunked one bitwise equal
    to five eager chunked steps and a replay's launches the full batch's
    times the chunks; the peak device memory of each step and dispatch, and
    the dispatch's losses against the full batch's (reported: Adam carries
    a first step's rounding into every parameter, so the later losses
    part)."""
    out, learners, records = {}, [], []
    fn.reset_launch_counts()
    for tag, config, make, chunk, msl in (
        ("flagship_chunk2", FLAGSHIP, train_batch, 2, CLI_FLAGSHIP_TRAIN),
        ("flagship_chunk4", FLAGSHIP, train_batch, 4, CLI_FLAGSHIP_TRAIN),
        ("north_star_chunk1", NORTH_STAR, north_star_batch, 1, CLI_NORTH_TRAIN),
    ):
        full, _ = fused_and_plain(config)
        chunked = type(full)(dataclasses.replace(full.cfg, task_chunk=chunk))
        state0 = full.init_state(torch.Generator().manual_seed(104))
        batch = make(np.random.RandomState(2))
        res = {}
        steps = {}
        for name, learner in (("full", full), ("chunked", chunked)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            steps[name] = first_step(learner, state0, batch)
            torch.cuda.synchronize()
            res[f"{name}_step_peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
        (loss, _), (ref_loss, _) = steps["chunked"], steps["full"]
        loss_gap = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
        if loss_gap > 1e-5:
            fail(f"task_chunk {tag}: first loss gap {loss_gap}")
        res.update(compare_with_plain(steps["chunked"], steps["full"], f"task_chunk {tag}"))
        batches = [make(np.random.RandomState(30 + i)) for i in range(GRAPH_PHASE_ITERS)]
        dispatched = {}
        for name, learner in (("full", full), ("chunked", chunked)):
            learners.append(learner)
            records.append(graph_records(learner))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            _, m = learner.run_train_iters(state0, batches, 0)
            torch.cuda.synchronize()
            res[f"{name}_dispatch_peak_gb"] = (torch.cuda.max_memory_allocated() - held) / 1e9
            t0 = time.perf_counter()
            learner.run_train_iters(state0, batches, 0)
            torch.cuda.synchronize()
            res[f"{name}_replay_ms_per_iter"] = (time.perf_counter() - t0) * 1e3 / GRAPH_PHASE_ITERS
            dispatched[name] = m["loss"]
        chunks = batch[0].shape[0] // chunk
        (graph,) = chunked._step_graphs.graphs.values()
        if graph.launches != {k: chunks * v for k, v in msl.items()}:
            fail(f"task_chunk {tag}: a replay launches {graph.launches}, expected "
                 f"{chunks} x {msl}")
        check_replay(graph, f"task_chunk {tag}")
        _, eager = eager_steps(chunked, state0, batches, 0)
        if not torch.equal(eager["loss"], dispatched["chunked"]):
            fail(f"task_chunk {tag}: replayed losses {dispatched['chunked'].tolist()} "
                 f"against the eager chunked steps' {eager['loss'].tolist()}")
        gap = ((dispatched["chunked"] - dispatched["full"]).abs()
               / dispatched["full"].abs())
        res.update(first_loss_rel_gap=loss_gap, replay_bitwise_equal_to_eager=True,
                   replayed_loss_rel_gap_vs_full=gap.tolist(), chunks=chunks,
                   launches_per_replay=graph.launches)
        out[tag] = res
        del full, chunked, state0
        torch.cuda.empty_cache()
    out["launches"] = _phase_launches(fn, learners, records)
    return out


def lane_pad_phase(torch, fn) -> dict:
    """The north-star JSON with the three fused flags and
    ``lane_pad_channels`` (48 -> 64 filters) against the unpadded learner
    from the same weights (seed 104): 8 served episodes (5x5x15, meta-batch
    4) and an eval iteration's logits at the serve bars or, the north star
    being chaotic from random weights, within twice the unpadded engine's
    own gap when its weights move by one ulp (cuDNN may take another
    algorithm for 64 channels than for 48); the first second-order step's
    loss and meta-gradient under the train phase's tolerances, the
    padding's gradient exactly 0; a K=3 dispatch of each (capture, replay
    ms, launches per replay the unpadded counts); a padded checkpoint into
    an unpadded learner and back, bit for bit (but the padding lanes of the
    BN running variance, which decay from 1 towards the all-zero channel's
    0 as in JAX, never reach an output and are not archived)."""
    import tempfile

    from howtotrainyourmamlpytorch_tpu_torch.ops.layout import strip_tree
    from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingEngine
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))

    fn.reset_launch_counts()
    unpadded, _ = fused_and_plain(NORTH_STAR)
    padded = type(unpadded)(dataclasses.replace(unpadded.cfg, backbone=dataclasses.replace(
        unpadded.cfg.backbone, lane_pad_channels=True)))
    su = unpadded.init_state(torch.Generator().manual_seed(104))
    sp = padded.init_state(torch.Generator().manual_seed(104))
    if padded.cfg.backbone.conv_channels != 64 or not same(strip_tree(sp, su), su):
        fail("lane_pad: the padded state's real slice is not the unpadded state")
    out = {}
    raw = north_star_episodes(np.random.RandomState(1), 8)
    served = {}
    for name, learner, state in (("padded", padded, sp), ("unpadded", unpadded, su)):
        engine = ServingEngine(learner, learner.inference_state(state),
                               ServeConfig(meta_batch_size=4))
        served[name] = np.stack(engine.dispatch([engine.prepare_episode(*e) for e in raw]))
    median_bar, max_bar, sensitivity = episode_bars(
        torch, unpadded, unpadded.inference_state(su), raw, served["unpadded"], True)
    per_episode = np.abs(served["padded"] - served["unpadded"]).reshape(len(raw), -1).max(1)
    if np.median(per_episode) > median_bar or per_episode.max() > max_bar:
        fail(f"lane_pad: served episodes past median {median_bar}, max {max_bar}: "
             f"{per_episode.tolist()}")
    batch = north_star_batch(np.random.RandomState(3))
    logits = [learner.run_validation_iter(state, batch)[2]
              for learner, state in ((padded, sp), (unpadded, su))]
    eval_gap = float((logits[0] - logits[1]).abs().max())
    if eval_gap > max_bar:
        fail(f"lane_pad: eval logits off by {eval_gap} (bar {max_bar})")
    out.update(episode_max_abs_err=float(per_episode.max()),
               episode_median_abs_err=float(np.median(per_episode)),
               episode_bars={"median": median_bar, "max": max_bar},
               unpadded_one_ulp_episode_gap=[
                   {"median": float(np.median(g)), "max": float(g.max())}
                   for g in sensitivity],
               eval_logit_max_abs_err=eval_gap,
               bitwise_served=bool(np.array_equal(served["padded"], served["unpadded"])))
    p_loss, p_grads = first_step(padded, sp, batch)
    u_step = first_step(unpadded, su, batch)
    stripped = strip_tree(p_grads, u_step[1])
    for a, b in zip(tree_leaves(p_grads), tree_leaves(stripped)):
        padding = a.clone()
        padding[tuple(slice(0, d) for d in b.shape)] = 0
        if bool(padding.any()):
            fail("lane_pad: the padding's meta-gradient is not 0")
    out.update(compare_with_plain((p_loss, stripped), u_step, "lane_pad"))
    batches = [north_star_batch(np.random.RandomState(40 + i)) for i in range(GRAPH_PHASE_ITERS)]
    records = [graph_records(padded), graph_records(unpadded)]
    states = {}
    for name, learner, state in (("padded", padded, sp), ("unpadded", unpadded, su)):
        states[name], _ = learner.run_train_iters(state, batches, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        learner.run_train_iters(state, batches, 0)
        torch.cuda.synchronize()
        out[f"{name}_replay_ms_per_iter"] = (time.perf_counter() - t0) * 1e3 / GRAPH_PHASE_ITERS
        (graph,) = learner._step_graphs.graphs.values()
        if graph.launches != CLI_NORTH_TRAIN:
            fail(f"lane_pad {name}: a replay launches {graph.launches}")
        check_replay(graph, f"lane_pad {name}")
        out[f"{name}_capture_ms"] = graph.capture_s * 1e3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lane_pad_") as tmp:
        exp = {"current_iter": GRAPH_PHASE_ITERS}
        padded.save_model(os.path.join(tmp, "train_model_1"), states["padded"], exp)
        into_unpadded, _ = unpadded.load_model(tmp, "train_model", 1)
        if not same(into_unpadded, strip_tree(states["padded"], su)):
            fail("lane_pad: the padded checkpoint loaded into the unpadded learner differs")
        unpadded.save_model(os.path.join(tmp, "train_model_2"), into_unpadded, exp)
        back, _ = padded.load_model(tmp, "train_model", 2)
        if not (same(strip_tree(back, su), strip_tree(states["padded"], su))
                and same(back[:2], states["padded"][:2])
                and same(back.opt_state, states["padded"].opt_state)):
            fail("lane_pad: the round trip back into the padded learner differs")
    out["checkpoints_bitwise"] = True
    out["launches"] = _phase_launches(fn, [padded, unpadded], records)
    return out


#: The chaos phase: the flagship JSON the operations plane is checked on,
#: at full width, cut to 3 epochs of 4 iterations and 8 evaluation tasks.
CHAOS_CONFIG = os.path.join(
    REPO, "experiment_config", "omniglot_maml++-omniglot_1_8_0.1_64_5_1.json"
)
CHAOS_SCHEDULE = ["enospc", "sigterm", "kill", "hang"]
CHAOS_EPOCHS, CHAOS_ITERS, CHAOS_EVAL_TASKS = 3, 4, 8
#: Above a process's first dispatch on the card, which holds the libraries'
#: first use and the capture (10-13 s on the H100, PERF.md section 6); small
#: against the supervised run.
CHAOS_WATCHDOG_MIN_S = 25.0
#: Iterations of each per-step run of the telemetry on/off comparison.
TELEMETRY_ITERS = 12


def chaos_config(**overrides) -> dict:
    """``CHAOS_CONFIG`` over the phase's tree, with its resilience knobs."""
    with open(CHAOS_CONFIG) as f:
        cfg = json.load(f)
    cfg.update(dataset_name="omniglot_synth", dataset_path="omniglot_synth",
               total_epochs=CHAOS_EPOCHS, total_iter_per_epoch=CHAOS_ITERS,
               num_evaluation_tasks=CHAOS_EVAL_TASKS, total_epochs_before_pause=100,
               watchdog=True, watchdog_min_s=CHAOS_WATCHDOG_MIN_S, watchdog_factor=20.0,
               checkpoint_async=True, telemetry=True)
    cfg.update(overrides)
    return cfg


def _chaos_builder(work, name, dataset_dir, **overrides):
    """An ``ExperimentBuilder`` of the flagship learner on the card, as
    ``train_maml_system`` builds it, for the in-process checks."""
    from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
    from howtotrainyourmamlpytorch_tpu_torch.experiment_builder import ExperimentBuilder
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        args_to_maml_config,
        get_args,
    )

    path = os.path.join(work, f"{name}.json")
    with open(path, "w") as f:
        json.dump(chaos_config(experiment_name=os.path.join(work, name), **overrides), f)
    os.environ["DATASET_DIR"] = dataset_dir
    args, device = get_args(["--name_of_args_json_file", path, *FUSED_ARGV])
    return ExperimentBuilder(args=args, data=MetaLearningSystemDataLoader,
                             model=MAMLFewShotLearner(args_to_maml_config(args)),
                             device=device)


def chaos_rollback(torch, work, dataset_dir) -> dict:
    """``nan_at_iter`` at the first iteration of epoch 2 under
    ``--on_nonfinite rollback``, in this process: the poisoned epoch trips
    the sentinel at its boundary, the run reloads epoch 1's checkpoint and
    replays. Holds the restored iteration, the first dispatch after the
    rollback (a replay of the graph captured before it, fed the restored
    state) to an eager ``_train_step`` from that state on the same batch bit
    for bit, no new capture, and finite losses and weights to the end."""
    from howtotrainyourmamlpytorch_tpu_torch.models.common import set_injected_lr
    from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    builder = _chaos_builder(work, "rollback", dataset_dir, total_epochs=2,
                             on_nonfinite="rollback")
    learner = builder.model
    seen = {}
    perform, run_iters = builder._perform_rollback, learner.run_train_iters

    def rollback(trip):
        seen["captures_before"] = builder._captures()
        perform(trip)
        seen["restored_iter"] = int(builder.state["current_iter"])

    def run_train_iters(state, batches, epoch):
        out = run_iters(state, batches, epoch)
        if "restored_iter" in seen and "replay" not in seen:
            group = tuple(a.clone() for a in batches.arrays)
            seen["replay"] = (state, group, epoch, out)
        return out

    builder._perform_rollback = rollback
    learner.run_train_iters = run_train_iters
    faultinject.activate(faultinject.FaultPlan(nan_at_iter=CHAOS_ITERS))
    try:
        builder.run_experiment()
    finally:
        faultinject.deactivate()
    if seen.get("restored_iter") != CHAOS_ITERS:
        fail(f"chaos rollback: restored iteration {seen.get('restored_iter')}, "
             f"expected {CHAOS_ITERS}")
    state, group, epoch, (new_state, losses) = seen["replay"]
    epoch = int(epoch)
    importance = learner._importance(state, learner._train_importance(epoch))
    eager = state._replace(opt_state=set_injected_lr(state.opt_state,
                                                     learner._epoch_lr(epoch)))
    metrics = []
    for k in range(group[0].shape[0]):
        eager, m = learner._train_step(
            eager, tuple(a[k] for a in group), importance,
            second_order=learner._use_second_order(epoch),
            final_only=learner._final_only(epoch),
        )
        metrics.append(m)
    bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(new_state),
                                                      tree_leaves(eager)))
    bitwise = bitwise and all(torch.equal(losses[key], torch.stack([m[key] for m in metrics]))
                              for key in ("loss", "accuracy", "nonfinite"))
    if not bitwise:
        fail("chaos rollback: the replay after the rollback differs from an eager "
             "step from the restored state")
    captures = builder._captures()
    if captures != seen["captures_before"]:
        fail(f"chaos rollback: {captures - seen['captures_before']} new capture(s) "
             "after the rollback")
    with open(os.path.join(work, "rollback", "logs", "summary_statistics.json")) as f:
        stats = json.load(f)
    losses = [v for k, vs in stats.items() if "loss" in k and "importance" not in k
              for v in vs]
    final = tree_leaves(builder.train_state)
    if not (np.isfinite(losses).all() and all(bool(torch.isfinite(a).all()) for a in final
                                              if a.is_floating_point())):
        fail(f"chaos rollback: non-finite losses or weights at the end: {stats}")
    with np.load(os.path.join(work, "rollback", "saved_models",
                              "train_model_latest")) as z:
        exp = json.loads(bytes(z["__experiment_state__"]).decode())
    if exp.get("nonfinite_rollbacks") != 1:
        fail(f"chaos rollback: nonfinite_rollbacks {exp.get('nonfinite_rollbacks')}")
    return {"restored_iter": seen["restored_iter"], "replay_bitwise_vs_eager": bitwise,
            "captures": captures, "recaptures_after_rollback": 0,
            "nonfinite_rollbacks": exp["nonfinite_rollbacks"],
            "nonfinite_trips_total": exp.get("nonfinite_trips_total"),
            "epochs": len(stats["val_accuracy_mean"])}


def chaos_oom(torch, work, dataset_dir) -> dict:
    """``oom_at_iter`` 1 in this process: a real ``torch.OutOfMemoryError``
    (an allocation larger than the card's free memory) at the second
    dispatch, ``logs/oom_report.json`` with the card's memory, exit 77."""
    from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject

    builder = _chaos_builder(work, "oom", dataset_dir)
    faultinject.activate(faultinject.FaultPlan(oom_at_iter=1))
    code = None
    try:
        builder.run_experiment()
    except SystemExit as exc:
        code = exc.code
    finally:
        faultinject.deactivate()
    if code != 77:
        fail(f"chaos oom: exit code {code}, expected 77")
    with open(os.path.join(work, "oom", "logs", "oom_report.json")) as f:
        report = json.load(f)
    marks = report.get("memory_watermarks") or [{}]
    total = torch.cuda.get_device_properties(0).total_memory
    if not (str(report.get("error_type", "")).endswith("OutOfMemoryError")
            and "out of memory" in str(report.get("error", "")).lower()
            and marks[0].get("bytes_limit") == total
            and marks[0].get("bytes_in_use", 0) > 0
            and report.get("exit_code") == 77):
        fail(f"chaos oom: report {report}")
    return {"exit_code": code, "error_type": report["error_type"],
            "error": report["error"][:120], "bytes_in_use": marks[0]["bytes_in_use"],
            "peak_bytes_in_use": marks[0]["peak_bytes_in_use"],
            "bytes_limit": marks[0]["bytes_limit"], "current_iter": report["current_iter"],
            "levers": report["config_levers"]}


class SyncCounter:
    """Counts CUDA synchronisations (``torch.cuda.set_sync_debug_mode``
    warnings) in train dispatches that reach no log or epoch boundary and
    capture no graph, from ``from_iter`` on."""

    def __init__(self, torch, from_iter):
        self.torch, self.from_iter = torch, from_iter
        self.dispatches, self.syncs = 0, 0

    def __enter__(self):
        import warnings

        from howtotrainyourmamlpytorch_tpu_torch import experiment_builder as eb

        self.cls = eb.ExperimentBuilder
        self.orig = orig = self.cls.train_iteration
        counter, torch = self, self.torch

        def train_iteration(builder, samples, epoch_idx, total_losses, current_iter):
            n = eb.dispatch_multiplier(samples)
            end = current_iter + n
            quiet = (current_iter >= counter.from_iter and not eb._log_due(end, n)
                     and end % builder.args.total_iter_per_epoch)
            if not quiet:
                return orig(builder, samples, epoch_idx, total_losses, current_iter)
            captures = builder._captures()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = orig(builder, samples, epoch_idx, total_losses, current_iter)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            if builder._captures() == captures:
                counter.dispatches += 1
                counter.syncs += sum("synchroniz" in str(w.message) for w in caught)
            return out

        self.cls.train_iteration = train_iteration
        return self

    def __exit__(self, *exc):
        self.cls.train_iteration = self.orig


def chaos_telemetry(torch, fn, dataset_dir) -> dict:
    """The flagship CLI's per-step p50 (a synchronize after each learner
    call) with telemetry and the watchdog off, then on, on the chaos tree
    (1 epoch of ``TELEMETRY_ITERS``); the run with them on then resumes to a
    2nd epoch as the CLI runs, with every train dispatch between
    boundaries watched for synchronisations."""
    latest = ["--continue_from_epoch", "latest"]
    runs = {}
    for name, on in (("off", False), ("on", True)):
        overrides = chaos_config(total_epochs=1, total_iter_per_epoch=TELEMETRY_ITERS,
                                 telemetry=on, watchdog=on,
                                 watchdog_min_s=CHAOS_WATCHDOG_MIN_S)
        calls = [({}, [], True, 1, -1)]
        counter = SyncCounter(torch, TELEMETRY_ITERS)
        if on:
            calls.append(({"total_epochs": 2}, latest, False, 1, -1))
        with counter:
            runs[name] = cli_phase(torch, fn, f"telemetry_{name}", CHAOS_CONFIG, None,
                                   overrides, calls, CLI_FLAGSHIP_TRAIN,
                                   CLI_FLAGSHIP_TRAIN_FINAL, CLI_FLAGSHIP_EVAL,
                                   dataset_dir=dataset_dir)
        runs[name]["sync_watch"] = {"dispatches": counter.dispatches,
                                    "syncs": counter.syncs}
    watch = runs["on"]["sync_watch"]
    if watch["dispatches"] < TELEMETRY_ITERS - 3 or watch["syncs"]:
        fail(f"chaos telemetry: {watch} (dispatches between boundaries, syncs)")
    off = runs["off"]["per_step"]["step_p50_ms"]
    on = runs["on"]["per_step"]["step_p50_ms"]
    return {"step_p50_ms_off": off, "step_p50_ms_on": on, "ratio_on_off": on / off,
            "sync_watch": watch,
            "launches": {k: runs["off"]["launches"][k] + runs["on"]["launches"][k]
                         for k in runs["on"]["launches"]}}


def chaos_phase(torch, fn, dataset_dir) -> dict:
    """The operations plane on the card, at flagship width on the tree in
    ``dataset_dir``: the unfaulted twin and one supervised run of
    ``CHAOS_SCHEDULE`` through the port's dispatcher
    (``chaos_train.run_chaos``), bit for bit equal at the end, with
    ``train_recovery_s`` per class; then, in this process, a NaN under
    ``rollback``, an out-of-memory, and telemetry on against off."""
    import tempfile

    from howtotrainyourmamlpytorch_tpu_torch import chaos_train

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chaos_") as work:
        # The twin runs beside the rollback and OOM checks and into the
        # supervised run's first phase, which ends in its first fault
        # after the twin is done (only the twin's bits are read; the
        # recoveries are timed from the faults on); the timed telemetry
        # runs alone.
        twin_cfg = os.path.join(work, "chaos_baseline.json")
        with open(twin_cfg, "w") as f:
            json.dump(chaos_config(experiment_name=os.path.join(work, "chaos_baseline")), f)
        env = {**os.environ, "DATASET_DIR": dataset_dir,
               "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        env.pop("MAML_FAULTS", None)
        with open(os.path.join(work, "chaos_baseline.log"), "w") as log:
            twin = subprocess.Popen(
                [sys.executable, "-u", "-m", "howtotrainyourmamlpytorch_tpu_torch.train_maml_system",
                 "--name_of_args_json_file", twin_cfg, *FUSED_ARGV],
                env=env, stdout=log, stderr=subprocess.STDOUT,
            )
        try:
            with phase_timer("chaos_rollback"):
                out["rollback"] = chaos_rollback(torch, work, dataset_dir)
            with phase_timer("chaos_oom"):
                out["oom"] = chaos_oom(torch, work, dataset_dir)
            t0 = time.perf_counter()
            verdict = chaos_train.run_chaos(
                work, CHAOS_SCHEDULE, config=chaos_config(), dataset_dir=dataset_dir,
                extra_argv=FUSED_ARGV,
            )
            out["supervised_s"] = time.perf_counter() - t0
            twin_rc = twin.wait(timeout=chaos_train.RUN_TIMEOUT_S)
            twin_end = os.path.getmtime(os.path.join(work, "chaos_baseline.log"))
            with open(os.path.join(work, "chaos_phases.jsonl")) as f:
                first_fault = json.loads(f.readline())["t_exit"]
            out["twin_ended_before_first_fault"] = twin_end < first_fault
        finally:
            if twin.poll() is None:
                twin.kill()
        exp, base = (os.path.join(work, name) for name in ("chaos_exp", "chaos_baseline"))
        try:
            got, want = chaos_train.final_leaves(exp), chaos_train.final_leaves(base)
            bitexact = (twin_rc == 0 and set(got) == set(want)
                        and all(np.array_equal(got[k], want[k]) for k in got)
                        and chaos_train.summary_rows(exp) == chaos_train.summary_rows(base))
            verdict.update(bitexact_vs_baseline=bitexact, leaves=len(got),
                           summary_rows=len(chaos_train.summary_rows(exp)))
        except OSError:
            verdict["bitexact_vs_baseline"] = False
        rcs = [p["rc"] for p in verdict["phases"]]
        if not verdict["ok"] or verdict["bitexact_vs_baseline"] is not True or rcs != [
            75, -9, 76, 0
        ]:
            for log in ("chaos_exp.log", "chaos_baseline.log"):
                with open(os.path.join(work, log)) as f:
                    print(f"[chaos] tail of {log}:\n" + f.read()[-6000:], flush=True)
            fail(f"chaos: supervised run {json.dumps(verdict)}")
        out["supervised"] = verdict
    with phase_timer("chaos_telemetry"):
        out["telemetry"] = chaos_telemetry(torch, fn, dataset_dir)
    return out


# ---------------------------------------------------------------------------
# [serve_pool]: the supervised replica pool and the durable tier
# ---------------------------------------------------------------------------

#: Faults armed in the first spawn of each worker (MAML_FAULTS); a respawn
#: runs clean.
POOL_FAULTS = {0: "replica_kill_at_request=3", 1: "wedge_replica_at_request=6"}
#: Supervision of the worker pool: a warmed worker answers a dispatch in
#: tens of ms and a probe in ms, while a process takes 10-13 s to its first
#: dispatch on the card (PERF.md §5): probes every 0.25 s with a 1 s budget,
#: a wedged request given up after 10 s (by then the other worker is back),
#: restarts after 0.2 s.
POOL_SUPERVISION = dict(health_interval_s=0.25, health_timeout_s=1.0, unhealthy_after=2,
                        restart_backoff_s=0.2, restart_backoff_max_s=2.0,
                        dispatch_timeout_s=10.0)
POOL_EPISODES = 32  # 24 support sets, 8 repeats
POOL_WARMUP = "5x1x15"
FUSED_FLAG = ["--use_pallas_fused_norm", "True"]
#: The in-process load test: open-loop Poisson arrivals at this rate for
#: this long, the replica serving request POOL_LOADTEST_KILL_AT killed.
POOL_LOADTEST_QPS, POOL_LOADTEST_S, POOL_LOADTEST_KILL_AT = 20.0, 3.0, 20
POOL_LOADTEST_P99_MS = 2000.0


def child_pids(pid: int) -> list[int]:
    """The live children of ``pid``, read from /proc."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid and fields[0] != "Z":
                out.append(int(entry))
    return out


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def pool_episodes(owner_of):
    """The 32 flagship episodes of Part 1 in their phases: ``a0`` two
    support sets worker 0 owns (one client, before its fault); ``a`` two
    more of worker 0's (the third kills it) and two of worker 1's; ``r``
    a repeat of ``a0[0]``'s support set with new queries; ``b`` the rest,
    7 of them repeats. ``owner_of`` maps an episode to its ring owner."""
    rng = np.random.RandomState(12)
    fresh = []
    while len(fresh) < 24:
        xs = (rng.rand(5, 1, 1, 28, 28) > 0.8).astype(np.float32)
        xq = (rng.rand(15, 1, 28, 28) > 0.8).astype(np.float32)
        fresh.append((xs, np.arange(5).reshape(5, 1), xq))
    owners = [owner_of(e) for e in fresh]
    zero = [i for i, o in enumerate(owners) if o == 0]
    one = [i for i, o in enumerate(owners) if o == 1]
    if len(zero) < 6 or len(one) < 6:
        fail(f"[serve_pool] the ring gave owners {owners}")
    a0 = [fresh[i] for i in zero[:2]]
    a = [fresh[zero[2]], fresh[one[0]], fresh[zero[3]], fresh[one[1]]]
    used = set(zero[:4] + one[:2])
    rest = [e for i, e in enumerate(fresh) if i not in used]

    def repeat(ep, seed):
        q = (np.random.RandomState(seed).rand(15, 1, 28, 28) > 0.8).astype(np.float32)
        return (ep[0], ep[1], q)

    r = [repeat(a0[0], 100)]
    repeats = [repeat(e, 101 + i) for i, e in enumerate(a0[1:] + a + rest[:2])]
    b = [e for pair in zip(rest, repeats + [None] * len(rest)) for e in pair if e is not None]
    if len(a0) + len(a) + len(r) + len(b) != POOL_EPISODES:
        fail("[serve_pool] episode plan does not add up")
    return {"a0": a0, "a": a, "r": r, "b": b}


def read_worker_events(paths) -> list[dict]:
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.events import read_events

    return [e for p in paths if os.path.exists(p) for e in read_events(p)]


def serve_pool_workers(torch, work, reference) -> dict:
    """Part 1: two worker processes of ``serve_maml`` (flagship, fused norm,
    warmed at 5x1x15, each with its tier) under a ``ReplicaPool`` with
    digest routing behind ``make_http_server``; worker 0's first spawn is
    killed at its 3rd request, worker 1's wedged at its 6th; 32 episodes
    from 4 loopback clients answered with no failure and held to the
    in-process engine ``reference``; the respawned worker 0 answers a
    support set it cached before its death from its rehydrated spill with
    no adapt launch and no nvcc build; a corrupt promote's 409 and a good
    one's 200 on both workers; no worker left."""
    import shutil
    import threading

    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        PoolConfig,
        ReplicaPool,
        make_http_server,
        routing_digest,
    )
    from howtotrainyourmamlpytorch_tpu_torch.serve.resilience.replica import (
        SubprocessReplica,
        serve_maml_argv,
    )
    from howtotrainyourmamlpytorch_tpu_torch.serve.tier import HashRing
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import load_maml_config

    tier_root = os.path.join(work, "tier")
    spawns, worker_logs, telemetry = [], [], []
    armed = dict(POOL_FAULTS)

    def factory(index: int):
        spawn = sum(1 for s in spawns if s["index"] == index)
        tag = f"worker{index}_spawn{spawn}"
        port_file = os.path.join(work, f"{tag}.port")
        env = {k: v for k, v in os.environ.items() if k != "MAML_FAULTS"}
        fault = armed.pop(index, None)
        if fault:
            env["MAML_FAULTS"] = fault
        log = os.path.join(work, f"{tag}.log")
        tel = os.path.join(work, f"{tag}.jsonl")
        worker_logs.append(log)
        telemetry.append(tel)
        argv = serve_maml_argv(FLAGSHIP, port_file=port_file, warmup=POOL_WARMUP,
                               telemetry=tel, tier_dir=os.path.join(tier_root,
                                                                     f"replica-{index}"),
                               debug_kernels=True, train_flags=FUSED_FLAG)
        replica = SubprocessReplica(argv, replica_id=tag, env=env, port_file=port_file,
                                    log_path=log, startup_timeout_s=300.0)
        spawns.append({"index": index, "spawn": spawn, "replica": replica,
                       "port_file": port_file, "fault": fault})
        return replica

    def worker_url(spawn):
        with open(spawn["port_file"]) as f:
            return f"http://127.0.0.1:{f.read().strip()}"

    def worker_health(spawn):
        return json.loads(http_call(f"{worker_url(spawn)}/healthz", timeout=30)[1])

    def worker_kernels(spawn):
        return json.loads(http_call(f"{worker_url(spawn)}/debug/kernels", timeout=30)[1])

    def worker_metric(spawn, name):
        text = http_call(f"{worker_url(spawn)}/metrics", timeout=30)[1].decode()
        return next(float(line.split()[-1]) for line in text.splitlines()
                    if line.startswith(f"maml_serve_{name} "))

    def tail_logs():
        for log in worker_logs:
            if os.path.exists(log):
                print(f"[serve_pool] tail of {log}:\n" + open(log).read()[-3000:],
                      flush=True)

    log = events.EventLog(os.path.join(work, "pool_events.jsonl"))
    previous = events.install(log)
    pool = server = thread = None
    t0 = time.perf_counter()
    try:
        pool = ReplicaPool(factory, PoolConfig(n_replicas=2, route_by_digest=True,
                                               tier_root=tier_root, **POOL_SUPERVISION))
        if not pool.wait_ready(timeout=300):
            tail_logs()
            fail("[serve_pool] the worker pool did not come up")
        up_s = time.perf_counter() - t0
        server = make_http_server(pool, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        ring = HashRing(pool.config.ring_vnodes)
        ring.add(0)
        ring.add(1)

        def owner_of(ep):
            payload = episode_json(*ep)
            return ring.route(routing_digest(np.asarray(payload["support"]),
                                             np.asarray(payload["support_labels"])))

        plan = pool_episodes(owner_of)
        answers = {}
        t_traffic = time.perf_counter()
        # a0: worker 0 answers two support sets; wait until its spill holds
        # them (the writes run on its writer thread).
        answers["a0"] = post_concurrently(base, plan["a0"], clients=1)[0]
        spill0 = os.path.join(tier_root, "replica-0", "spill")
        deadline = time.monotonic() + 30
        while sum(len(f) for _, _, f in os.walk(spill0)) < 2:
            if time.monotonic() > deadline:
                fail("[serve_pool] worker 0's spill never held its two entries")
            time.sleep(0.05)
        answers["a"] = post_concurrently(base, plan["a"], clients=4)[0]
        deadline = time.monotonic() + 300
        while pool.metrics.replica_restarts_total.value < 1 or not pool.wait_ready(0.1):
            if time.monotonic() > deadline:
                tail_logs()
                fail(f"[serve_pool] worker 0 did not come back: {pool.stats()}")
            time.sleep(0.1)
        respawn0 = spawns[-1]
        if respawn0["index"] != 0 or respawn0["spawn"] != 1:
            fail(f"[serve_pool] unexpected spawns {[(s['index'], s['spawn']) for s in spawns]}")
        before = worker_kernels(respawn0)
        answers["r"] = post_concurrently(base, plan["r"], clients=1)[0]
        after = worker_kernels(respawn0)
        tier0 = worker_health(respawn0)["tier"]
        answers["b"] = post_concurrently(base, plan["b"], clients=4)[0]
        deadline = time.monotonic() + 300
        while pool.metrics.replica_restarts_total.value < 2 or not pool.wait_ready(0.1):
            if time.monotonic() > deadline:
                tail_logs()
                fail(f"[serve_pool] worker 1 did not come back: {pool.stats()}")
            time.sleep(0.1)
        traffic_s = time.perf_counter() - t_traffic
        stats = pool.stats()

        # Every request answered, and each answer the in-process engine's,
        # bit for bit: grouping moves no bit of a task's logits (§7).
        flat = [(k, i, ep, answers[k][i]) for k in ("a0", "a", "r", "b")
                for i, ep in enumerate(plan[k])]
        statuses = [s for *_, (s, _) in flat]
        if any(s != 200 for s in statuses) or stats["request_errors"]:
            tail_logs()
            fail(f"[serve_pool] statuses {statuses}, errors "
                 f"{[(k, i, b) for k, i, _, (s, b) in flat if s != 200]}, pool {stats}")
        got = np.stack([np.asarray(b["logits"], np.float32) for *_, (_, b) in flat])
        want = np.stack(reference([ep for _, _, ep, _ in flat]))
        gap = np.abs(got - want).reshape(len(flat), -1).max(axis=1)
        bitwise = int((gap == 0).sum())
        if bitwise != len(flat):
            fail(f"[serve_pool] {len(flat) - bitwise} answers differ from the in-process "
                 f"engine's: {gap.tolist()}")
        if (stats["replica_deaths_total"], stats["replica_restarts_total"]) != (2, 2) \
                or stats["retry_total"] < 1:
            fail(f"[serve_pool] deaths/restarts/retries {stats}")
        first0 = spawns[0]["replica"]
        if first0.returncode != 86:
            fail(f"[serve_pool] the killed worker exited {first0.returncode}, not 86")

        # The respawned worker 0: the repeated support set from its
        # rehydrated spill, no adapt launch, no nvcc build, an exec hit.
        hit = answers["r"][0][1]
        launched = {k: after["launches"][k] - before["launches"][k]
                    for k in SERVE_HIT_LAUNCHES}
        if not hit["cache_hit"] or launched != SERVE_HIT_LAUNCHES:
            fail(f"[serve_pool] the respawn's repeat: cache_hit {hit['cache_hit']}, "
                 f"launches {launched}")
        if (tier0["spill"]["hits"] < 2 or tier0["nvcc_builds"] != 0
                or tier0["kernel_library"] != "exec_cache" or tier0["exec"]["hits"] != 1):
            fail(f"[serve_pool] the respawned worker's tier {tier0}")

        # Seconds from each fault to HEALTHY, and the wedge's detection.
        log.flush()
        pool_events = events.read_events(log.path)
        worker_events = read_worker_events(telemetry)
        dead = {e["slot"]: e["t"] for e in pool_events if e["type"] == "replica_dead"}
        healthy = {}
        for e in pool_events:
            if e["type"] == "replica_healthy" and e["slot"] in dead and e["t"] > dead[e["slot"]]:
                healthy.setdefault(e["slot"], e["t"])
        wedged = [e["t"] for e in worker_events
                  if e["type"] == "serve_fault" and e["fault"] == "wedge"]
        if set(dead) != {0, 1} or set(healthy) != {0, 1} or len(wedged) != 1:
            fail(f"[serve_pool] events: dead {dead}, healthy {healthy}, wedge {wedged}")
        cfg = pool.config
        budget = cfg.unhealthy_after * cfg.health_interval_s + cfg.health_timeout_s
        probe_bound = cfg.unhealthy_after * (cfg.health_interval_s + cfg.health_timeout_s)
        detect_s = dead[1] - wedged[0]
        if detect_s > probe_bound + 1.0:
            fail(f"[serve_pool] the wedge took {detect_s:.3f} s to detect "
                 f"(probe bound {probe_bound} s)")
        recovery = {"kill": healthy[0] - dead[0], "wedge": healthy[1] - wedged[0]}

        # Promotion through the pool: a corrupt copy's 409 at the front
        # door, no worker touched; a good one's 200 on both, replica 0
        # canaried first.
        live = [s for s in spawns if s["replica"].returncode is None]
        learner = MAMLFewShotLearner(load_maml_config(FLAGSHIP, use_pallas_fused_norm=True))
        ckpt, bad = os.path.join(work, "train_model_7"), os.path.join(work, "corrupt")
        learner.save_model(ckpt, learner.init_state(torch.Generator().manual_seed(7)),
                           {"current_iter": 0})
        shutil.copy(ckpt, bad)
        with open(bad, "r+b") as f:
            f.truncate(128)
        probe = episode_json(*plan["b"][0])
        first = json.loads(http_call(f"{base}/v1/episode", probe)[1])
        status_bad, body_bad, _ = http_call(f"{base}/admin/promote", {"checkpoint": bad})
        second = json.loads(http_call(f"{base}/v1/episode", probe)[1])
        touched = [(worker_health(s)["state_version"], worker_metric(s, "swap_rejected_total"))
                   for s in live]
        if (status_bad != 409 or json.loads(body_bad)["reason"] != "corrupt_checkpoint"
                or touched != [(0, 0), (0, 0)] or first["logits"] != second["logits"]):
            fail(f"[serve_pool] corrupt promote: {status_bad} {body_bad!r}, workers' "
                 f"(version, rejections) {touched}")
        status_good, body_good, _ = http_call(f"{base}/admin/promote", {"checkpoint": ckpt})
        promoted = json.loads(body_good)
        versions = [worker_health(s)["state_version"] for s in live]
        time.sleep(1.5)  # the workers flush their telemetry each second
        swaps = [name for _, name in sorted(
            (e["t"], os.path.basename(path)[:7]) for path in telemetry
            for e in read_worker_events([path]) if e["type"] == "swap_promoted")]
        if (status_good != 200 or promoted != {"promoted_replicas": 2, "state_version": 1}
                or versions != [1, 1] or swaps != ["worker0", "worker1"]):
            fail(f"[serve_pool] good promote: {status_good} {promoted}, versions "
                 f"{versions}, swaps in order {swaps}")
        worker_shapes = {}
        for s in live:
            for name, keys in worker_kernels(s)["shapes"].items():
                worker_shapes.setdefault(name, set()).update(
                    (tuple(k[0]), *k[1:]) for k in keys)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        if pool is not None:
            pool.close()
        events.install(previous)
    left = [s["replica"].pid for s in spawns if pid_alive(s["replica"].pid)]
    if left:
        fail(f"[serve_pool] worker pids left after close: {left}")
    return {
        "pool_up_s": up_s, "traffic_s": traffic_s, "episodes": len(flat), "clients": 4,
        "failed_requests": stats["request_errors"],
        "replica_deaths_total": stats["replica_deaths_total"],
        "replica_restarts_total": stats["replica_restarts_total"],
        "retry_total": stats["retry_total"],
        "rehydrations_total": stats["rehydrations_total"],
        "bitwise_vs_in_process": bitwise, "max_abs_err_vs_in_process": float(gap.max()),
        "recovery_s": recovery, "wedge_detect_s": detect_s,
        "wedge_budget_s": budget, "wedge_probe_bound_s": probe_bound,
        "killed_exit": first0.returncode,
        "wedged_exit": spawns[1]["replica"].returncode,
        "respawn0": {"cache_hit": hit["cache_hit"], "launches": launched,
                     "spill_hits": tier0["spill"]["hits"], "nvcc_builds": tier0["nvcc_builds"],
                     "kernel_library": tier0["kernel_library"], "exec": tier0["exec"],
                     "spill_write_s": tier0["spill_write_s"]},
        "replica_ready_s": stats["replica_ready_s"],
        "promote": {"corrupt": status_bad, "good": status_good, "versions": versions,
                    "swap_order": swaps},
        "worker_shapes": {k: sorted(v, key=repr) for k, v in worker_shapes.items()},
        "spawns": len(spawns),
    }


class PoolCli:
    """``python3 -m ...serve_maml --replicas 2`` on the flagship JSON as a
    command line, started at once and left to boot beside other work (a
    thread notes when its pool is ready); ``finish`` sends one episode,
    then SIGTERM, and holds it to exit 0 with both workers stopped."""

    def __init__(self, work):
        import threading

        self.port_file = os.path.join(work, "front.port")
        self.log_path = os.path.join(work, "front.log")
        cmd = [sys.executable, "-m", "howtotrainyourmamlpytorch_tpu_torch.serve_maml",
               "--config", FLAGSHIP, "--init_from_scratch", "--replicas", "2",
               "--warmup", POOL_WARMUP, "--port", "0", "--port_file", self.port_file,
               "--health_interval_s", "0.25", *FUSED_FLAG]
        env = {k: v for k, v in os.environ.items() if k != "MAML_FAULTS"}
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                         stderr=subprocess.STDOUT)
        self.ready_s = self.base = None
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    def _watch(self):
        while self.proc.poll() is None and time.perf_counter() - self.t0 < 300:
            if os.path.exists(self.port_file):
                base = f"http://127.0.0.1:{open(self.port_file).read().strip()}"
                status, body, _ = http_call(f"{base}/healthz")
                if status == 200 and json.loads(body)["healthy_replicas"] == 2:
                    self.ready_s, self.base = time.perf_counter() - self.t0, base
                    return
            time.sleep(0.1)

    def finish(self) -> dict:
        import signal

        self.watcher.join(timeout=300)
        if self.base is None:
            fail(f"[serve_pool] the CLI pool did not come up:\n{open(self.log_path).read()}")
        status, body, _ = http_call(
            f"{self.base}/v1/episode",
            episode_json(*make_episodes(np.random.RandomState(3), 2)[0]))
        logits = np.asarray(json.loads(body).get("logits", []), np.float32)
        if status != 200 or logits.shape != (15, 5) or not np.isfinite(logits).all():
            fail(f"[serve_pool] the CLI pool answered {status}, logits {logits.shape}")
        workers = child_pids(self.proc.pid)
        t1 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        code = self.proc.wait(timeout=120)
        drain_s = time.perf_counter() - t1
        left = [pid for pid in workers if pid_alive(pid)]
        if code != 0 or len(workers) != 2 or left:
            fail(f"[serve_pool] CLI exit {code} on SIGTERM, workers {workers}, left "
                 f"{left}:\n" + open(self.log_path).read()[-3000:])
        return {"ready_s": self.ready_s, "exit_code": code, "workers": len(workers),
                "drain_s": drain_s, "workers_left": 0}

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def serve_pool_in_process(fn, work) -> dict:
    """Part 2: a ``LocalReplica`` pool of two flagship engines with tiers in
    this process: launches per cache-miss, RAM-hit and spill-hit dispatch
    held exactly; ``/admin/scale`` 2 -> 3 -> 2; the load test with a kill;
    a stale executable-cache fence, typed and rebuilt."""
    import threading

    from howtotrainyourmamlpytorch_tpu_torch import serve_maml
    from howtotrainyourmamlpytorch_tpu_torch.serve import (
        PoolConfig,
        ReplicaPool,
        make_http_server,
    )
    from howtotrainyourmamlpytorch_tpu_torch.serve.resilience import LocalReplica
    from howtotrainyourmamlpytorch_tpu_torch.serve_loadtest import (
        run_loadtest,
        synth_episodes,
        verdict_line,
    )
    from howtotrainyourmamlpytorch_tpu_torch.telemetry import events
    from howtotrainyourmamlpytorch_tpu_torch.utils import faultinject

    tier_root = os.path.join(work, "tier_in_process")
    opts, flags = serve_maml.get_parser().parse_known_args(
        ["--config", FLAGSHIP, "--init_from_scratch", "--warmup", POOL_WARMUP, *FUSED_FLAG])

    def build(index):
        opts.tier_dir = os.path.join(tier_root, f"replica-{index}")
        return serve_maml.build_api(opts, flags)[0]

    pool = ReplicaPool(lambda i: LocalReplica(build(i), f"local-{i}"), PoolConfig(
        n_replicas=2, health_interval_s=0.1, restart_backoff_s=0.1, min_uptime_s=0.5,
        route_by_digest=True, tier_root=tier_root))
    server = thread = None
    out = {}
    try:
        if not pool.wait_ready(timeout=300):
            fail("[serve_pool] the in-process pool did not come up")
        raw = make_episodes(np.random.RandomState(21), 10)[:4]  # distinct support sets
        first = None

        def repeats(seed):
            return [(xs, ys, (np.random.RandomState(seed + i).rand(15, 1, 28, 28) > 0.8)
                     .astype(np.float32)) for i, (xs, ys, _) in enumerate(raw[:2])]

        launches = {}
        for kind, eps in (("miss", raw), ("hit", repeats(200)), ("spill_hit", repeats(300))):
            if kind == "spill_hit":
                for slot in pool._slots:
                    slot.replica.api.engine.cache.flush_spill()
                    slot.replica.api.engine.cache.clear()
            fn.reset_launch_counts()
            answers = [pool.classify(*ep) for ep in eps]
            launches[kind] = dict(fn.launch_counts)
            if first is None:
                first = answers[0]["logits"]
            per = SERVE_LAUNCHES if kind == "miss" else SERVE_HIT_LAUNCHES
            want = {k: v * len(eps) for k, v in per.items()}
            if launches[kind] != want or any(a["cache_hit"] != (kind != "miss")
                                             for a in answers):
                fail(f"[serve_pool] {kind} dispatches launched {launches[kind]}, expected "
                     f"{want}; cache hits {[a['cache_hit'] for a in answers]}")
        promotions = sum(s.replica.api.engine.cache.spill_hits for s in pool._slots)
        if promotions != 2:
            fail(f"[serve_pool] {promotions} spill promotions, expected 2")
        tiers = [s.replica.api.engine.tier_stats() for s in pool._slots]
        writes = sum(t["spill"]["writes"] for t in tiers)
        out["spill_writes"] = writes
        out["spill_write_ms_each"] = 1e3 * sum(t["spill_write_s"] for t in tiers) / writes
        out["launches"] = {k: {n: v // (4 if k == "miss" else 2) for n, v in d.items()}
                           for k, d in launches.items()}
        out["launches_total"] = {n: sum(d[n] for d in launches.values()) for n in fn.KERNELS}

        # /admin/scale 2 -> 3 -> 2 through the HTTP front door.
        server = make_http_server(pool, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        scale = []
        for size in (3, 2):
            t0 = time.perf_counter()
            status, body, _ = http_call(f"{base}/admin/scale", {"pool_size": size})
            if status != 200 or not pool.wait_ready(timeout=120):
                fail(f"[serve_pool] /admin/scale to {size}: {status} {body!r}")
            health = json.loads(http_call(f"{base}/healthz")[1])
            if (health["pool_size"], health["healthy_replicas"]) != (size, size):
                fail(f"[serve_pool] /healthz after scaling to {size}: {health}")
            scale.append({"to": size, "status": status, "s": time.perf_counter() - t0})
        out["scale"] = scale

        # The load test, the replica serving request K killed.
        episodes = synth_episodes(16, way=5, shot=1, query=15, image_shape=(1, 28, 28))
        faultinject.activate(faultinject.FaultPlan(
            replica_kill_at_request=POOL_LOADTEST_KILL_AT))
        try:
            result = run_loadtest(pool, episodes, rate_qps=POOL_LOADTEST_QPS,
                                  duration_s=POOL_LOADTEST_S,
                                  p99_budget_ms=POOL_LOADTEST_P99_MS, error_slo=0.01,
                                  timeout_s=30.0, seed=0)
        finally:
            faultinject.deactivate()
        print(f"[serve_pool] load test {verdict_line(result)}", flush=True)
        if not result["slo_pass"] or result["completed_ok"] != result["offered"]:
            fail(f"[serve_pool] the load test failed its verdict: {result}")
        if not result["serve_recovery_s"]:
            fail("[serve_pool] the load test saw no degraded window: the kill did not land")
        out["loadtest"] = result
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        pool.close()

    # A stale executable-cache fence: typed, sent to telemetry, rebuilt
    # with nvcc; the engine then serves the same logits as before.
    log = events.EventLog(os.path.join(work, "stale_events.jsonl"))
    previous = events.install(log)
    nvcc_before = fn.build_stats["nvcc_builds"]
    faultinject.activate(faultinject.FaultPlan(stale_exec_cache_at=1))
    try:
        t0 = time.perf_counter()
        api = build(0)
        rebuild_s = time.perf_counter() - t0
        try:
            answer = api.classify(*raw[0])
            tier = api.engine.tier_stats()
        finally:
            api.close()
        fired = list(faultinject.events)
    finally:
        faultinject.deactivate()
        events.install(previous)
    log.flush()
    kinds = [e["type"] for e in events.read_events(log.path)]
    if (fired != ["stale-exec-fence"] or tier["exec"]["stale"] != 1
            or tier["exec"]["writes"] != 1 or fn.build_stats["nvcc_builds"] != nvcc_before + 1
            or "tier_exec_stale" not in kinds or "tier_exec_rebuilt" not in kinds
            or not np.array_equal(answer["logits"], first)):
        fail(f"[serve_pool] stale fence: events {fired}, exec {tier['exec']}, nvcc builds "
             f"{fn.build_stats['nvcc_builds'] - nvcc_before}, telemetry {kinds}")
    out["stale_fence"] = {"exec": tier["exec"], "nvcc_rebuilds": 1, "engine_s": rebuild_s,
                          "nvcc_s": next(e["nvcc_s"] for e in events.read_events(log.path)
                                         if e["type"] == "tier_exec_rebuilt"),
                          "logits_bitwise_as_before": True}
    return out


def lock_verdict(san) -> dict:
    """The sanitizer's verdict on a serve run: no cycle in the observed
    acquisition order and every lock created under the port's ``serve/``
    held under the 2.0 s budget, else the run fails; the cycle count and
    the longest serve hold with its site."""
    from howtotrainyourmamlpytorch_tpu_torch.utils import locksan

    cycles = san.cycles()
    over = san.over_budget(locksan.SERVE_HOLD_BUDGET_S, locksan.SERVE_MATCH)
    site, hold = locksan.longest_hold(san, locksan.SERVE_MATCH)
    report = san.report()
    if cycles or over or site is None:
        fail(f"[serve_pool] lock sanitizer: cycles {cycles}, serve holds over "
             f"{locksan.SERVE_HOLD_BUDGET_S} s {over}, serve sites seen {site is not None}")
    return {"cycles": len(cycles), "longest_serve_hold_s": hold,
            "longest_serve_hold_site": os.path.relpath(site.rsplit(":", 1)[0], REPO)
            + ":" + site.rsplit(":", 1)[1],
            "sites": report["sites"], "acquisitions": report["acquisitions"],
            "edges": len(report["edges"]),
            "budget_s": locksan.SERVE_HOLD_BUDGET_S}


def serve_pool_phase(torch, fn) -> dict:
    """[serve_pool]: Part 1 (worker processes, then the command line) and
    Part 2 (in process, under the port's lock sanitizer), at the flagship's
    full width."""
    import tempfile

    from howtotrainyourmamlpytorch_tpu_torch import serve_maml
    from howtotrainyourmamlpytorch_tpu_torch.utils import locksan

    opts, flags = serve_maml.get_parser().parse_known_args(
        ["--config", FLAGSHIP, "--init_from_scratch", "--warmup", POOL_WARMUP, *FUSED_FLAG])
    reference_api = serve_maml.build_api(opts, flags)[0]

    def reference(eps):
        return [reference_api.classify(*ep)["logits"] for ep in eps]

    out = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_pool_") as work:
            with phase_timer("serve_pool_workers"):
                out["workers"] = serve_pool_workers(torch, work, reference)
            cli = PoolCli(work)  # boots beside Part 2; Part 1's times stay clean
            try:
                with phase_timer("serve_pool_in_process"):
                    # Every lock Part 2 creates is instrumented: the pool,
                    # the batchers, the engines, the caches and the tiers.
                    with locksan.LockSanitizer() as san:
                        out["in_process"] = serve_pool_in_process(fn, work)
                    out["in_process"]["locksan"] = lock_verdict(san)
                with phase_timer("serve_pool_cli"):
                    out["cli"] = cli.finish()
            finally:
                cli.kill()
    finally:
        reference_api.close()
    out["launches"] = out["in_process"]["launches_total"]
    return out


# ---------------------------------------------------------------------------
# [control_plane]: the promotion daemon and the autoscaler over the pool
# ---------------------------------------------------------------------------

#: The promote loop's trainer (``chaos_train.PROMOTE_EPOCHS`` epochs of 1
#: iteration) validates on 8 tasks (600): one meta-batch. Its watchdog is
#: off: work beside its first process can stretch a first dispatch past
#: the watchdog's floor, and its exit 76 would cost the kill mid-publish.
CONTROL_EVAL_TASKS = 8
#: The pool's replicas: the [serve_pool] shape (meta-batch 4, 5x1x15), so
#: a fresh engine's answers are comparable bit for bit.
CONTROL_SERVE = {"meta_batch_size": 4, "max_wait_ms": 0.0}
CONTROL_QUERY = 15
#: Probe episodes answered by the fleet after each promotion and by a
#: fresh engine on the staged file.
CONTROL_PROBES = 4
#: The promotion daemon's SLO window and cadence here, shorter than JAX's
#: defaults (10 s, 0.5 s): at the load test's 8 requests/s a 1 s window
#: holds ~8 answers (none with probability e^-8), and the regression's NaN
#: answers start with the first request after the publish.
CONTROL_DAEMON = {"slo_watch_s": 1.0, "slo_poll_s": 0.1}


def cuda_holders(pids) -> dict:
    """``{pid: (holds /dev/nvidia*, listed by nvidia-smi as a compute app)}``
    for each live pid: a process with a CUDA context holds the driver's
    device files open and is a compute app of the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.split()
    out = {}
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue  # gone
        held = False
        for fd in fds:
            try:
                held |= os.readlink(f"/proc/{pid}/fd/{fd}").startswith("/dev/nvidia")
            except OSError:
                pass
        out[pid] = (held, str(pid) in smi)
    return out


class ControlMonitor:
    """``chaos_train.ControlPlaneMonitor`` for the card: counts each
    engine's probes (warmups and canaries), holds the fleet after each
    promotion and after the rollback to the staged file (``/healthz``
    digest, answers bitwise against a fresh engine), and samples the
    daemons for a CUDA context while they run."""

    def __init__(self, work, probe_eps):
        import threading

        from howtotrainyourmamlpytorch_tpu_torch.chaos_train import PROMOTE_EPOCHS

        self.work, self.probe_eps = work, probe_eps
        self.bad_name = f"train_model_{PROMOTE_EPOCHS + 40}"  # the regressing candidate
        self.engines = []  # (engine, probe counter)
        self.daemons = []  # (name, proc)
        self.starts = {}
        self.held = []
        self.cuda_samples = []
        self._learner = None
        self._stop = threading.Event()
        self._sampler = threading.Thread(target=self._sample, daemon=True)
        self._sampler.start()

    # chaos_train calls these three
    def replica_built(self, index, api):
        self._count_probes(api.engine)

    def daemon_started(self, proc, name):
        self.daemons.append((name, proc))

    def journal_row(self, row, pool):
        if "decision_id" in row:
            return
        if row["phase"] == "start":
            self.starts[row["digest"]] = row
        elif row["phase"] == "promoted":
            self._hold(row["digest"], pool, "promoted")
        elif row["phase"] == "rolled_back":
            self._hold(row["to"], pool, "rolled_back")

    def _count_probes(self, engine):
        count = [0]
        probe = engine._probe

        def counted(istate, ep):
            count[0] += 1
            return probe(istate, ep)

        engine._probe = counted
        self.engines.append((engine, count))

    def _hold(self, digest, pool, why):
        from howtotrainyourmamlpytorch_tpu_torch import serve_maml
        from howtotrainyourmamlpytorch_tpu_torch.serve import ServeConfig, ServingEngine
        from howtotrainyourmamlpytorch_tpu_torch.utils.checkpoint import checkpoint_digest

        staged = self.starts[digest]["staged"]
        health = pool.healthz()
        record = {"why": why, "digest": digest[:16],
                  "healthz_digest_is_staged": (health["last_promoted_digest"] == digest
                                               == checkpoint_digest(staged))}
        if not record["healthz_digest_is_staged"]:
            fail(f"[control_plane] after {why} /healthz serves "
                 f"{health['last_promoted_digest']}, the staged file is {digest}")
        if os.path.basename(self.starts[digest]["path"]) == self.bad_name:
            record["answers"] = "NaN by regress_after_promote: not compared"
            self.held.append(record)
            return
        got = [pool.classify(*ep, timeout=120.0)["logits"] for ep in self.probe_eps]
        if self._learner is None:
            self._learner, _ = serve_maml.build_learner(
                "maml", os.path.join(self.work, "chaos_promote.json"), FUSED_FLAG)
        istate, _ = self._learner.load_inference_state(staged)
        engine = ServingEngine(self._learner, istate, ServeConfig(**CONTROL_SERVE))
        self._count_probes(engine)
        want = engine.dispatch([engine.prepare_episode(*ep) for ep in self.probe_eps])
        gap = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            fail(f"[control_plane] after {why} of {digest[:16]} the fleet's answers "
                 f"differ from a fresh engine's on the staged file by up to {gap}")
        record["answers_bitwise_vs_fresh_engine"] = len(got)
        self.held.append(record)

    def _sample(self):
        while not self._stop.wait(1.0):
            live = [(n, p.pid) for n, p in self.daemons if p.poll() is None]
            if live:
                seen = cuda_holders([pid for _, pid in live] + [os.getpid()])
                self.cuda_samples.append(
                    {name: seen.get(pid) for name, pid in live} | {"self": seen.get(os.getpid())})

    def close(self):
        self._stop.set()
        self._sampler.join(timeout=60)


def control_plane_phase(torch, fn, dataset_dir, background=None,
                        keep_telemetry=None) -> dict:
    """[control_plane]: the port's serving control plane at the flagship's
    full width, fused norm, on the tree in ``dataset_dir``: the promote loop
    (``chaos_train.run_promote_chaos``: the trainer as a subprocess, two
    in-process replicas behind the HTTP front door under load-test traffic,
    the promotion daemon as its own process; the trainer killed mid-publish,
    a corrupt candidate, the daemon SIGKILLed and restarted, a regressing
    last candidate rolled back), with the autoscale loop
    (``run_autoscale_chaos``: one replica, the autoscaler as its own process
    killed with a scale-up journaled, thresholds from latencies probed
    here, a replica killed under cache hits) run beside its first trainer
    process, before its pool exists; then ``background`` (a callable) runs
    on a thread to the phase's end, its result the phase's ``background``.
    The promote loop's telemetry (its serving events among the trainer's)
    is copied to ``keep_telemetry``; the loop's verdict requires hard
    episodes mined from it.
    After each promotion and the rollback
    the fleet's digest and answers are held to the staged file; the
    launches to the engines' dispatches and probes; the daemons must hold
    no CUDA context."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from howtotrainyourmamlpytorch_tpu_torch import chaos_train
    from howtotrainyourmamlpytorch_tpu_torch.serve.resilience.promotion import PromotionJournal

    out = {}
    probe_eps = make_episodes(np.random.RandomState(31), CONTROL_PROBES)
    fn.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_control_") as work:
        journal = PromotionJournal(os.path.join(work, "fsync_probe.jsonl"))
        t0 = time.perf_counter()
        for i in range(20):
            journal.append("probe", digest=f"{i:064x}")
        out["journal_append_ms"] = (time.perf_counter() - t0) * 50.0
        monitor = ControlMonitor(work, probe_eps)
        def tails(*logs):
            for log in logs:
                path = os.path.join(work, log)
                if os.path.exists(path):
                    with open(path) as f:
                        print(f"[control_plane] tail of {log}:\n" + f.read()[-6000:],
                              flush=True)

        def beside():
            # Beside the promote loop's first trainer process, before its
            # pool exists: the in-process faults of the two loops never meet.
            with phase_timer("control_plane_autoscale"):
                try:
                    scale = chaos_train.run_autoscale_chaos(
                        work, config=chaos_config(), serve_flags=FUSED_FLAG,
                        query=CONTROL_QUERY, serve_config=CONTROL_SERVE, monitor=monitor)
                except Exception as exc:
                    tails("chaos_autoscaler_daemon.log")
                    fail(f"[control_plane] autoscale loop: {type(exc).__name__}: {exc}")
            if not scale["ok"]:
                tails("chaos_autoscaler_daemon.log")
                fail(f"[control_plane] autoscale loop {json.dumps(scale)}")
            return scale, background and executor.submit(background)

        executor = ThreadPoolExecutor(max_workers=1)
        try:
            with phase_timer("control_plane_promote"):
                try:
                    promote = chaos_train.run_promote_chaos(
                        work, config=chaos_config(num_evaluation_tasks=CONTROL_EVAL_TASKS,
                                                  watchdog=False),
                        dataset_dir=dataset_dir, train_flags=FUSED_ARGV,
                        serve_flags=FUSED_FLAG, query=CONTROL_QUERY,
                        serve_config=CONTROL_SERVE, daemon=CONTROL_DAEMON, monitor=monitor,
                        beside=beside)
                except Exception as exc:
                    tails("chaos_promote.log", "chaos_promotion_daemon.log")
                    fail(f"[control_plane] promote loop: {type(exc).__name__}: {exc}")
            if not promote["ok"]:
                tails("chaos_promote.log", "chaos_promotion_daemon.log")
                fail(f"[control_plane] promote loop {json.dumps(promote)}")
            if keep_telemetry is not None:
                shutil.copyfile(promote["telemetry"], keep_telemetry)
            scale, later = promote.pop("beside")
            out["background"] = later and later.result()
        finally:
            executor.shutdown(wait=True)
            monitor.close()
    launches = dict(fn.launch_counts)
    misses = hits_only = probes = 0
    for engine, count in monitor.engines:
        m = engine.metrics
        adapts = m.adapt_latency.snapshot()["count"]
        misses += adapts
        hits_only += m.batches_dispatched.value - adapts
        probes += count[0]
    want = {k: SERVE_LAUNCHES[k] * (misses + probes) + SERVE_HIT_LAUNCHES[k] * hits_only
            for k in SERVE_LAUNCHES}
    if launches != want:
        fail(f"[control_plane] launches {launches} over {misses} cache-miss and "
             f"{hits_only} cache-hit dispatches and {probes} warmup and canary probes, "
             f"expected {want}")
    promoted = [h for h in monitor.held if h["why"] == "promoted"]
    compared = [h for h in monitor.held if "answers_bitwise_vs_fresh_engine" in h]
    if (len(promoted) < 4 or not any(h["why"] == "rolled_back" for h in compared)
            or len(compared) < 4):
        fail(f"[control_plane] the fleet was held after {monitor.held}")
    if not monitor.cuda_samples:
        fail("[control_plane] the daemons were never sampled for a CUDA context")
    holders = [s for s in monitor.cuda_samples
               if any(v and (v[0] or v[1]) for k, v in s.items() if k != "self")]
    if holders or not all(s["self"] and s["self"][0] for s in monitor.cuda_samples):
        fail(f"[control_plane] a daemon held a CUDA context, or this process showed "
             f"none: {holders or monitor.cuda_samples}")
    out.update(promote=promote, autoscale=scale, held=monitor.held,
               dispatches={"cache_miss": misses, "cache_hit": hits_only, "probes": probes},
               cuda_samples=len(monitor.cuda_samples),
               smi_lists_this_process=any(s["self"][1] for s in monitor.cuda_samples),
               launches=launches)
    return out


# ---------------------------------------------------------------------------
# [feedback]: the hard-episode loop and the operations toolkit
# ---------------------------------------------------------------------------

#: The feedback run: the flagship JSON, fused, 1 epoch of 6 iterations and
#: 8 validation tasks (500 and 600), a mined episode every 2nd train slot,
#: the spawned loader with 2 workers.
FEEDBACK_ITERS, FEEDBACK_EVAL_TASKS, FEEDBACK_REPLAY_EVERY = 6, 8, 2
#: Train batches the smoke process holds, spawned against threads.
FEEDBACK_LOADER_BATCHES = 3
#: The overhead bench's budget and windows (the JAX protocol's 6 s, 3).
OVERHEAD_BUDGET_S, OVERHEAD_WINDOWS = 2.0, 3


def port_module(module, *argv, timeout=600) -> subprocess.CompletedProcess:
    """``python3 -m howtotrainyourmamlpytorch_tpu_torch.<module> argv``."""
    return subprocess.run(
        [sys.executable, "-m", f"howtotrainyourmamlpytorch_tpu_torch.{module}", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=timeout)


def feedback_loaders(config_path, argv) -> dict:
    """In this process, on the host: the first train batches of the
    spawned backend against the thread backend's on the same tree and
    manifest, bit for bit, and each replay slot's episode against the
    dataset's ``get_set("train", seed=<mined seed>)``."""
    from howtotrainyourmamlpytorch_tpu_torch.data import MetaLearningSystemDataLoader
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import get_args

    args, _ = get_args(["--name_of_args_json_file", config_path, *argv])
    batches, startup, mined, dataset = {}, None, None, None
    for backend in ("thread", "process"):
        args.dataprovider_backend = backend
        loader = MetaLearningSystemDataLoader(args)
        try:
            if backend == "process":
                startup = loader.worker_startup_s
            gen = loader.get_train_batches(total_batches=FEEDBACK_LOADER_BATCHES)
            batches[backend] = [next(gen) for _ in range(FEEDBACK_LOADER_BATCHES)]
            gen.close()
            if backend == "thread":
                dataset, mined = loader.dataset, set(loader.replay_seeds)
        finally:
            loader.close()
    for a, b in zip(batches["thread"], batches["process"]):
        if len(a) != len(b) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
            fail("[feedback] the spawned backend's train batches differ from the "
                 "thread backend's")
    replays = 0
    for b, batch in enumerate(batches["thread"]):
        for j, seed in enumerate(batch[4]):
            slot = b * len(batch[4]) + j
            if (slot + 1) % FEEDBACK_REPLAY_EVERY:
                continue
            if int(seed) not in mined:
                fail(f"[feedback] replay slot {slot} drew seed {seed}, not a mined one")
            episode = dataset.get_set("train", seed=int(seed))
            if not all(np.array_equal(batch[f][j], episode[f]) for f in range(4)):
                fail(f"[feedback] replay slot {slot} is not get_set(seed={seed})'s episode")
            replays += 1
    return {"batches": FEEDBACK_LOADER_BATCHES, "replay_slots_checked": replays,
            "worker_startup_s": startup, "spawned_bitwise_vs_threads": True}


def feedback_report(exp_dir, argv) -> dict:
    """``telemetry_report`` on the run, as text and as ``--json``: the step
    count, the fingerprint on every ``step`` event and in ``status.json``,
    the captured train programs in the device section."""
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.events import read_events
    from howtotrainyourmamlpytorch_tpu_torch.tune.space import fingerprint_from_args
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import get_args

    text = port_module("telemetry_report", exp_dir, timeout=120)
    as_json = port_module("telemetry_report", exp_dir, "--json", timeout=120)
    if text.returncode or as_json.returncode:
        fail(f"[feedback] telemetry_report: {text.stderr[-2000:]}{as_json.stderr[-2000:]}")
    summary = json.loads(as_json.stdout)
    args, _ = get_args(argv)
    want = fingerprint_from_args(args)
    stream = read_events(os.path.join(exp_dir, "logs", "telemetry.jsonl"))
    steps = [e for e in stream if e["type"] == "step"]
    with open(os.path.join(exp_dir, "logs", "status.json")) as f:
        status = json.load(f)
    stamped = {e.get("config_fingerprint") for e in steps}
    if not steps or stamped != {want} or status.get("config_fingerprint") != want:
        fail(f"[feedback] fingerprints on steps {stamped}, in status.json "
             f"{status.get('config_fingerprint')}, expected {want}")
    # The first dispatch of an epoch only anchors the step clock (both
    # packages): one epoch of N iterations gives N - 1 step samples.
    if summary["iters"] != FEEDBACK_ITERS - 1 or steps[-1]["iter"] != FEEDBACK_ITERS:
        fail(f"[feedback] the report counts {summary['iters']} steps up to iteration "
             f"{steps[-1]['iter']}, expected {FEEDBACK_ITERS - 1} up to {FEEDBACK_ITERS}")
    captured = sorted({c["name"] for c in summary["compiles"] if c["kind"] == "capture"})
    programs = sorted({p["name"] for p in (summary["device"] or {}).get("programs", [])
                       if p["role"] == "train"})
    if not captured or programs != captured:
        fail(f"[feedback] the device section lists {programs}, the run captured {captured}")
    flops = [p["flops"] for p in summary["device"]["programs"] if p["role"] == "train"]
    if not all(f and f > 0 for f in flops):
        fail(f"[feedback] train programs without FLOPs: {summary['device']}")
    return {"fingerprint": want, "report_steps": summary["iters"],
            "captured_programs": captured, "train_program_flops": flops,
            "mfu_pct": summary["device"].get("mfu_pct"),
            "report_text_lines": len(text.stdout.splitlines()),
            "event_counts": summary["event_counts"]}


def feedback_phase(torch, fn, dataset_dir, serve_telemetry) -> dict:
    """[feedback]: the promote loop's serving telemetry mined into a
    replay manifest (``episode_miner``, margin 1.0, top 64); the spawned
    loader held to the thread loader on that manifest in this process (on
    a thread, host only, beside the CLI run); the flagship trained on it
    through the CLI (fused, the ``process`` backend, telemetry on; launches
    per train and eval iteration held as [cli_flagship] holds them, losses
    finite); ``telemetry_report`` on the run; then the overhead bench at
    flagship width through ``telemetry_report``'s command line, in this
    process (its learner runs no fused kernel)."""
    import contextlib
    import io
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from howtotrainyourmamlpytorch_tpu_torch import telemetry_report

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_feedback_") as work:
        manifest = os.path.join(work, "replay_manifest.json")
        mined = port_module("episode_miner", "--telemetry", serve_telemetry, "--out",
                            manifest, "--max-margin", "1.0", "--top", "64", "--json",
                            timeout=120)
        if mined.returncode:
            fail(f"[feedback] episode_miner exited {mined.returncode}: "
                 f"{mined.stdout[-2000:]}{mined.stderr[-2000:]}")
        out["miner"] = json.loads(mined.stdout)
        if not out["miner"]["mined"]:
            fail(f"[feedback] nothing mined: {out['miner']}")
        replay_argv = ["--replay_manifest", manifest,
                       "--replay_every", str(FEEDBACK_REPLAY_EVERY),
                       "--dataprovider_backend", "process",
                       "--num_dataprovider_workers", "2"]
        with open(CHAOS_CONFIG) as f:
            base = json.load(f)
        base.update(dataset_name="omniglot_synth", dataset_path="omniglot_synth",
                    total_epochs=1, total_iter_per_epoch=FEEDBACK_ITERS,
                    num_evaluation_tasks=FEEDBACK_EVAL_TASKS, telemetry=True,
                    experiment_name=os.path.join(work, "loaders"))
        config_path = os.path.join(work, "loaders.json")
        with open(config_path, "w") as f:
            json.dump(base, f)
        os.environ["DATASET_DIR"] = dataset_dir

        def loaders():
            with phase_timer("feedback_loaders"):
                return feedback_loaders(config_path, replay_argv)

        with ThreadPoolExecutor(max_workers=1) as beside:
            checked = beside.submit(loaders)
            with phase_timer("feedback_cli"):
                out["cli"] = cli_phase(
                    torch, fn, "feedback", CHAOS_CONFIG, write_omniglot_tree,
                    {"dataset_name": "omniglot_synth", "total_epochs": 1,
                     "total_iter_per_epoch": FEEDBACK_ITERS,
                     "num_evaluation_tasks": FEEDBACK_EVAL_TASKS, "telemetry": True},
                    [({}, replay_argv, True, 1, -1)],
                    CLI_FLAGSHIP_TRAIN, CLI_FLAGSHIP_TRAIN_FINAL, CLI_FLAGSHIP_EVAL,
                    dataset_dir=dataset_dir, inspect=feedback_report)
            out["loaders"] = checked.result()
        cli = out["cli"]
        if cli["train_iterations"] != FEEDBACK_ITERS or cli["epochs"] != 1:
            fail(f"[feedback] {cli['train_iterations']} train iterations over "
                 f"{cli['epochs']} epochs, expected {FEEDBACK_ITERS} over 1")
        if not np.isfinite(cli["train_losses"]).all():
            fail(f"[feedback] non-finite train losses {cli['train_losses']}")
    printed = io.StringIO()
    with phase_timer("feedback_overhead"), contextlib.redirect_stdout(printed):
        code = telemetry_report.main([
            "--overhead-bench", "--budget-s", str(OVERHEAD_BUDGET_S),
            "--windows", str(OVERHEAD_WINDOWS)])
    lines = printed.getvalue().splitlines()
    if code or not lines:
        fail(f"[feedback] the overhead bench returned {code}: {lines[-40:]}")
    out["overhead"] = json.loads(lines[-1])
    out["launches"] = out["cli"]["launches"]
    return out


# ---------------------------------------------------------------------------
# [fleet]: data-parallel meta-training across processes
# ---------------------------------------------------------------------------

#: The fleet's depth: epochs of iterations, K meta-updates a dispatch, and
#: validation tasks (at least the meta-batch, and a whole batch a rank).
FLEET_EPOCHS, FLEET_ITERS, FLEET_K, FLEET_EVAL_TASKS = 2, 6, 2, 8
#: The kill-host loop's depth: rank 1 dies after iteration 3, past the
#: first epoch's checkpoint.
KILLHOST_EPOCHS, KILLHOST_ITERS = 3, 2
#: The BN state of the fleet against the chunked run: the CPU test's bar
#: (ranks average it as "local mean / dp, summed").
FLEET_BN_RTOL, FLEET_BN_ATOL = 1e-4, 1e-5


def fleet_config(**overrides) -> dict:
    """The flagship JSON over the phase's tree, at the fleet's depth."""
    return chaos_config(**{"total_epochs": FLEET_EPOCHS,
                           "total_iter_per_epoch": FLEET_ITERS,
                           "num_evaluation_tasks": FLEET_EVAL_TASKS, **overrides})


def _run_logged(argv, env, log_path, timeout=600) -> tuple[int, float]:
    """``argv`` to completion with its output in ``log_path``: (rc, s)."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        rc = subprocess.run(argv, env=env, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT, timeout=timeout).returncode
    return rc, time.perf_counter() - t0


def _rank_rates(events) -> dict:
    """Per rank from a run's telemetry: the meta-iterations/s of the first
    epoch after its first dispatch (which holds the capture): the
    iterations between the first log read and the epoch's summary read,
    over the seconds between the two (each read waits for the card, so
    the window holds those iterations' device time); the reduction's ms
    per meta-update and bytes per step; the launches a replay of each
    captured step makes; the step events."""
    out = {}
    for rank in sorted({int(e.get("process_index", 0)) for e in events
                        if e.get("type") == "step"}):
        mine = [e for e in events if int(e.get("process_index", 0)) == rank]
        reads = [e for e in mine if e.get("type") == "host_sync"]
        first = next(e for e in reads if e["reason"] == "log")
        summary = next(e for e in reads if e["reason"] == "epoch_summary")
        reduces = [e for e in mine if e.get("type") == "reduce"]
        out[rank] = {
            "meta_iters_per_s": (summary["iter"] - first["iter"]) / (summary["t"] - first["t"]),
            "timed_iters": summary["iter"] - first["iter"],
            "steps": sum(e.get("type") == "step" for e in mine),
            "captures": {e["name"]: e["launches"] for e in mine
                         if e.get("type") == "capture"},
        }
        if reduces:
            out[rank]["reduce_ms_per_iter"] = (
                1e3 * sum(e["reduce_s"] for e in reduces) / sum(e["k"] for e in reduces))
            out[rank]["reduce_bytes_per_iter"] = reduces[-1]["bytes"]
    return out


def _final_states(torch, config_path, exp_dirs):
    """Each experiment's ``train_model_latest`` loaded on the CPU by one
    learner of the config."""
    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.utils.parser_utils import (
        args_to_maml_config,
    )

    with open(config_path) as f:
        learner = MAMLFewShotLearner(args_to_maml_config(json.load(f)))
    return [learner.load_model(os.path.join(d, "saved_models"), "train_model",
                               "latest", "cpu") for d in exp_dirs]


def fleet_nccl_world1(torch) -> dict:
    """A one-rank ``nccl`` group in this process: ``fused_psum`` of the
    flagship's first meta-gradient parts (fused kernels, seed 104) is
    bitwise its input, with one all-reduce per dtype bucket; the group is
    left after."""
    from howtotrainyourmamlpytorch_tpu_torch.parallel import collectives, distributed
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    address = f"127.0.0.1:{distributed.find_free_port()}"
    if not distributed.initialize_distributed(address, 1, 0, 60.0):
        fail("[fleet] the one-rank group did not start")
    try:
        import torch.distributed as dist

        backend = dist.get_backend()
        if backend != "nccl":
            fail(f"[fleet] one rank on one card chose {backend}, not nccl")
        t0 = time.perf_counter()
        learner, _ = fused_and_plain(FLAGSHIP)
        state0 = learner.init_state(torch.Generator().manual_seed(104))
        batch = learner._device_batch(state0, train_batch(np.random.RandomState(2)))
        parts = learner._meta_grads_local(
            state0, batch, learner._importance(state0, learner._train_importance(0)),
            second_order=True, final_only=False)
        torch.cuda.synchronize()
        grads_s = time.perf_counter() - t0
        before = collectives.collective_counts["all_reduce"]
        times = []
        for _ in range(2):  # the first sets the communicator up
            t0 = time.perf_counter()
            reduced = collectives.fused_psum(parts)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        count = (collectives.collective_counts["all_reduce"] - before) // 2
        _, spec = collectives.flatten_buckets(parts)
        leaves = list(zip(tree_leaves(parts), tree_leaves(reduced)))
        if count != len(spec.dtypes) or not all(torch.equal(a, b) for a, b in leaves):
            fail(f"[fleet] nccl world 1: {count} all-reduces for dtypes {spec.dtypes}, "
                 f"bitwise {[torch.equal(a, b) for a, b in leaves]}")
        return {"backend": backend, "collectives": count, "dtypes": list(spec.dtypes),
                "leaves": len(leaves), "bytes": sum(a.numel() * a.element_size()
                                                    for a, _ in leaves),
                "first_reduce_ms": times[0], "reduce_ms": times[1], "bitwise": True,
                "grads_s": grads_s}
    finally:
        t0 = time.perf_counter()
        distributed.shutdown_distributed()
        PHASE_SECONDS["fleet_nccl_shutdown"] = time.perf_counter() - t0


def fleet_phase(torch, fn, dataset_dir) -> dict:
    """[fleet]: the flagship (``CHAOS_CONFIG`` at ``FLEET_*`` depth, the
    three fused flags, K = ``FLEET_K``) as a two-rank fleet through the
    port's dispatcher, both ranks on this card over gloo, held to one
    process with ``--task_chunk 4`` on the same tree: theta, LSLR and the
    Adam moments of ``train_model_latest`` bitwise, the BN state at
    ``FLEET_BN_*``; each rank's launches per replay exactly the chunked
    run's per chunk (and ``CLI_FLAGSHIP_TRAIN``); step events and a
    heartbeat per rank; rank 0 the only writer of ``saved_models/``. The
    one-rank nccl reduction (``fleet_nccl_world1``) runs in this process
    while the fleet's ranks start. (The kill-host loop is
    ``killhost_phase``.)"""
    import tempfile

    from howtotrainyourmamlpytorch_tpu_torch.telemetry.events import read_events
    from howtotrainyourmamlpytorch_tpu_torch.telemetry.heartbeat import read_heartbeat
    from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves

    out = {}
    env = {**os.environ, "DATASET_DIR": dataset_dir,
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("MAML_FAULTS", None)
    argv = [*FUSED_ARGV, "--iters_per_dispatch", str(FLEET_K)]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as work:
        paths, dirs = {}, {}
        for name, overrides in (("fleet", {"data_parallel_devices": 2}),
                                ("chunked", {"task_chunk": 4})):
            dirs[name] = os.path.join(work, name)
            paths[name] = os.path.join(work, f"{name}.json")
            with open(paths[name], "w") as f:
                json.dump(fleet_config(experiment_name=dirs[name], **overrides), f)
        module = "howtotrainyourmamlpytorch_tpu_torch"
        # The one-rank nccl check runs here while the fleet's ranks start
        # (interpreters, the data, the first eager step), before their
        # first timed window.
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as beside:
            fleet_run = beside.submit(_run_logged, [
                sys.executable, "-u", "-m", f"{module}.train_maml_system_dispatch",
                paths["fleet"], "--num_processes", "2", "--fleet_grace_s", "25",
                *argv], env, os.path.join(work, "fleet.log"))
            with phase_timer("fleet_nccl"):
                out["nccl_world1"] = fleet_nccl_world1(torch)
            rc, out["fleet_s"] = fleet_run.result()
        rc_chunked, out["chunked_s"] = _run_logged(
            [sys.executable, "-u", "-m", f"{module}.train_maml_system",
             "--name_of_args_json_file", paths["chunked"], *argv],
            env, os.path.join(work, "chunked.log"))
        if rc or rc_chunked:
            for log in ("fleet.log", "chunked.log"):
                with open(os.path.join(work, log)) as f:
                    print(f"[fleet] tail of {log}:\n" + f.read()[-6000:], flush=True)
            fail(f"[fleet] the fleet exited {rc}, the chunked run {rc_chunked}")
        (fleet, _), (chunked, _) = _final_states(
            torch, paths["fleet"], [dirs["fleet"], dirs["chunked"]])
        for field in ("theta", "lslr", "opt_state", "iteration"):
            got, want = tree_leaves(getattr(fleet, field)), tree_leaves(getattr(chunked, field))
            if len(got) != len(want) or not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"[fleet] {field} of the fleet's train_model_latest is not the "
                     "chunked run's bit for bit")
        bn_gap = max(float(((a - b).abs() - FLEET_BN_RTOL * b.abs()).max())
                     for a, b in zip(tree_leaves(fleet.bn_state),
                                     tree_leaves(chunked.bn_state)))
        if bn_gap > FLEET_BN_ATOL:
            fail(f"[fleet] BN state past the bar by {bn_gap}")
        out["bn_excess_over_rtol"] = bn_gap
        events = {name: read_events(os.path.join(dirs[name], "logs", "telemetry.jsonl"))
                  for name in dirs}
        rates = {name: _rank_rates(events[name]) for name in dirs}
        if sorted(rates["fleet"]) != [0, 1]:
            fail(f"[fleet] step events of ranks {sorted(rates['fleet'])}, expected 0 and 1")
        (chunk_captures,) = [r["captures"] for r in rates["chunked"].values()]
        per_chunk = {prog: {k: v // 2 for k, v in launches.items()}
                     for prog, launches in chunk_captures.items()}
        for rank, r in rates["fleet"].items():
            if not r["captures"] or "reduce_ms_per_iter" not in r:
                fail(f"[fleet] rank {rank} replayed no split step: {r}")
            if r["captures"] != per_chunk or any(
                    launches != CLI_FLAGSHIP_TRAIN for launches in r["captures"].values()):
                fail(f"[fleet] rank {rank} launches a replay {r['captures']}, the "
                     f"chunked run a chunk {per_chunk} (expected {CLI_FLAGSHIP_TRAIN})")
        logs = os.path.join(dirs["fleet"], "logs")
        beats = {rank: read_heartbeat(os.path.join(logs, name)) for rank, name in
                 ((0, "status.json"), (1, "status.r1.json"))}
        if any(b is None or b.get("process_index") != rank for rank, b in beats.items()):
            fail(f"[fleet] per-rank heartbeats {beats}")
        writers = {int(e.get("process_index", -1)) for e in events["fleet"]
                   if e.get("type") in ("checkpoint_submit", "checkpoint_save")}
        saved = sorted(os.listdir(os.path.join(dirs["fleet"], "saved_models")))
        if writers != {0} or saved != sorted(os.listdir(os.path.join(dirs["chunked"],
                                                                    "saved_models"))):
            fail(f"[fleet] checkpoint writers {writers}, saved {saved}")
        out.update(rates=rates, launches_per_rank_iter=rates["fleet"][0]["captures"],
                   chunked_launches_per_chunk=per_chunk, writers=sorted(writers),
                   saved=saved, heartbeats_iter=[b["current_iter"] for b in beats.values()])
    return out


def killhost_phase(dataset_dir) -> dict:
    """[fleet]'s kill-host loop (``chaos_train.run_killhost_chaos``) at the
    flagship's width and ``KILLHOST_*`` depth on ``dataset_dir``: its
    verdict, which must be ``ok``."""
    import tempfile

    from howtotrainyourmamlpytorch_tpu_torch import chaos_train

    with phase_timer("fleet_killhost"), tempfile.TemporaryDirectory(
            prefix="chip_smoke_killhost_") as work:
        verdict = chaos_train.run_killhost_chaos(
            work, config=fleet_config(total_epochs=KILLHOST_EPOCHS,
                                      total_iter_per_epoch=KILLHOST_ITERS),
            dataset_dir=dataset_dir, extra_argv=FUSED_ARGV)
        if not verdict["ok"]:
            with open(os.path.join(work, "chaos_killhost.log")) as f:
                print("[fleet] tail of the kill-host run:\n" + f.read()[-6000:], flush=True)
            fail(f"[fleet] kill-host verdict {json.dumps(verdict)}")
    return verdict


def print_fleet(r, smi) -> None:
    """The fleet phase's lines, each time with the card's name and limit."""
    rates = r["rates"]
    ranks = " ".join(f"rank {k} {v['meta_iters_per_s']:.3f} (reduce "
                     f"{v['reduce_ms_per_iter']:.3f} ms/iter of "
                     f"{v['reduce_bytes_per_iter']} bytes)"
                     for k, v in rates["fleet"].items())
    (single,) = rates["chunked"].values()
    print(f"[fleet] flagship, 2 ranks on one card over gloo, K={FLEET_K}, against one "
          f"process --task_chunk 4: theta, LSLR, Adam bitwise; BN within the bar; "
          f"launches per rank per iteration {json.dumps(r['launches_per_rank_iter'])} = "
          f"the chunked run's per chunk; writers {r['writers']}; meta-iters/s {ranks}; "
          f"chunked {single['meta_iters_per_s']:.3f}; run s fleet {r['fleet_s']:.1f} "
          f"chunked {r['chunked_s']:.1f} | {smi}", flush=True)
    n = r["nccl_world1"]
    print(f"[fleet] nccl, world 1: fused_psum of the flagship's {n['leaves']} gradient "
          f"parts ({n['bytes']} bytes) bitwise the input, {n['collectives']} all-reduce "
          f"for {n['dtypes']}, {n['reduce_ms']:.3f} ms ({n['first_reduce_ms']:.3f} ms the "
          f"first, with the communicator's set-up) | {smi}", flush=True)
    k = r["killhost"]
    print(f"[fleet] kill-host: ok {k['ok']}, multihost_recovery_s "
          f"{k['multihost_recovery_s']}, survivor hang event {k['survivor_hang_detected']},"
          f" wall {k['wall_s']} s, rows {k['host_loss_audit_rows']} | {smi}", flush=True)
    print(f"[fleet] {json.dumps(r)}", flush=True)


def print_feedback(r, smi) -> None:
    """The feedback phase's lines, with the card's name and power limit
    beside the times."""
    m, lo, cli, o = r["miner"], r["loaders"], r["cli"], r["overhead"]
    rep = cli["inspected"]
    print(f"[feedback] mined {m['mined']} hard episodes of {m['tagged_episodes']} tagged "
          f"(min margin {m['min_margin']}) from the promote loop's serving telemetry; "
          f"spawned loader bitwise equal to threads over {lo['batches']} train batches, "
          f"{lo['replay_slots_checked']} replay slots equal to get_set(seed), workers "
          f"started in {lo['worker_startup_s']:.3f} s | {smi}", flush=True)
    print(f"[feedback] CLI on the manifest (process backend): {cli['train_iterations']} "
          f"train and {cli['eval_iterations']} eval iterations, launches per train "
          f"iteration {json.dumps(cli['launches_per_train_iter']['msl'])}, per eval "
          f"iteration {json.dumps(cli['launches_per_eval_iter'])}, losses "
          f"{cli['train_loss']}; per step meta_iters_per_s "
          f"{cli['per_step']['meta_iters_per_s']:.3f} | {smi}", flush=True)
    print(f"[feedback] telemetry_report: {rep['report_steps']} step samples, fingerprint "
          f"{rep['fingerprint']} on every step and in status.json, captured "
          f"{rep['captured_programs']} (FLOPs per iteration {rep['train_program_flops']}, "
          f"MFU {rep['mfu_pct']}%) | telemetry_overhead_pct {o['value']} (plain "
          f"{o['plain_iters_per_s']} / telemetry {o['telemetry_iters_per_s']} "
          f"meta-iters/s, pairs {o['pair_overheads_pct']}) | {smi}",
          flush=True)
    print(f"[feedback] {PHASE_SECONDS['feedback']:.1f} s | "
          f"{json.dumps({k: v for k, v in r.items() if k != 'cli'}, default=str)}",
          flush=True)


def print_serve_cli(r) -> None:
    print(f"[serve_cli] ready after {r['ready_s']:.1f} s (beside [control_plane]'s "
          f"second trainer process), first episode {r['first_episode_ms']:.1f} ms, exit "
          f"{r['exit_code']} on SIGTERM | {json.dumps(r)}", flush=True)


def print_control_plane(r, smi) -> None:
    """The control plane's lines, with the card's name and power limit
    beside the times."""
    p, a = r["promote"], r["autoscale"]
    print(f"[control_plane] promote loop at bucket {p['bucket']}: {p['promotions']} clean "
          f"promotions, corrupt rejected {p['corrupt_rejected']} ({p['rejected_reasons']}), "
          f"trainer killed mid-publish {p.get('trainer_killed_mid_publish')}, daemon "
          f"SIGKILLed and resumed {p.get('daemon_killed_mid_run')} (double promotes "
          f"{p['double_promoted']}), rollback to the last-known-good {p['rollback_to_lkg']}"
          f", terminal rows per digest {p['terminal_rows_per_digest']}; load test "
          f"{p['loadtest_offered']} offered, {p['loadtest_failed']} failed; hard "
          f"episodes mined from its telemetry {p['mined_episodes']}", flush=True)
    print(f"[control_plane] daemon settings {json.dumps(p['daemon_settings'])}; publish to "
          f"promoted s {json.dumps(p['publish_to_promoted_s'])}; regression to rollback_start "
          f"{p.get('regression_detect_s')} s, to rolled_back "
          f"{p.get('regression_to_rolled_back_s')} s; fsync'd journal append "
          f"{r['journal_append_ms']:.3f} ms | {smi}", flush=True)
    print(f"[control_plane] held after each promotion and the rollback: "
          f"{json.dumps(r['held'])}; launches {json.dumps(r['launches'])} over "
          f"{json.dumps(r['dispatches'])} (24/20 a cache-miss dispatch or probe, 4/0 a hit); "
          f"daemons with a CUDA context in {r['cuda_samples']} samples: none (nvidia-smi "
          f"lists this process: {r['smi_lists_this_process']})", flush=True)
    print(f"[control_plane] autoscale loop: probes {json.dumps(a['probes'])}; scale-ups "
          f"{a['scale_ups']}, scale-downs {a['scale_downs']}, decided to settled s "
          f"{json.dumps(a['decided_to_settled_s'])}; autoscaler SIGKILLed "
          f"{a.get('daemon_sigkilled')} with the fleet untouched "
          f"{a.get('fleet_untouched_at_kill')}, resumed {a['resumed_rows']}x; replicas "
          f"built {a['replicas_built']} of {a['replicas_expected']}, the same target again "
          f"spawned {a.get('second_resize_spawned')}; replica deaths "
          f"{a.get('replica_deaths')}; requests {a['requests_offered']} offered, "
          f"{a['requests_failed']} failed | {smi}", flush=True)
    print(f"[control_plane] {PHASE_SECONDS['control_plane']:.1f} s (the promote loop "
          f"{PHASE_SECONDS['control_plane_promote']:.1f}, the autoscale loop within it, "
          f"beside its first trainer process, {PHASE_SECONDS['control_plane_autoscale']:.1f}) | "
          f"{json.dumps(r, default=str)}", flush=True)


def timing_reps(shape) -> int:
    """Fewer timed calls for the large north-star shapes."""
    return 10 if np.prod(shape) >= 4_000_000 else 50


def kernel_cells(res) -> str:
    """One shape's kernel times (graph, plain graph, bound, eager, plain
    eager) and, once for each plan, the launch plan."""
    cells, last_plan = [], None
    for k, v in res.items():
        if k == "pairs":
            continue
        plan = tuple(v["plan"].values())
        cells.append(
            f"{k}={v['ms']:.4f}/{v['plain_ms']:.4f}/{v['bound_ms']:.4f}"
            f"/{v['eager_ms']:.4f}/{v['eager_plain_ms']:.4f}"
            + ("" if plan == last_plan else f" plan {plan}")
        )
        last_plan = plan
    return " ".join(cells)


#: Seconds each phase of this run took, in order.
PHASE_SECONDS = {}


class phase_timer:
    """Adds the wall seconds of its block to ``PHASE_SECONDS[name]``."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        PHASE_SECONDS[self.name] = time.perf_counter() - self.t0


def print_graph(phase, tag, g) -> None:
    """A graph phase's line: capture, replay and eager ms, then everything
    as JSON."""
    print(f"[{phase}] {tag}: run_train_iters(K={g['iters']}) bitwise equal to "
          f"{g['iters']} eager steps at epochs 0, 1 (lr and importance moved) "
          f"and 2 (final-only), held state unchanged | capture ms "
          + " ".join(f"{k} {v:.1f}" for k, v in g["capture_ms"].items())
          + " | replay ms per iteration "
          + " ".join(f"{v:.2f}" for v in g["replay_ms_per_iter"])
          + " | eager ms per iteration "
          + " ".join(f"{v:.2f}" for v in g["eager_ms_per_iter"])
          + f" | peak_mem_gb {g['peak_mem_gb']:.3f} | {json.dumps(g)}", flush=True)


def print_serve(name, r) -> None:
    """A serving front-door phase's line: episodes/s, the latency
    quantiles scraped from /metrics, the gaps to the plain engine, then
    everything as JSON."""
    print(f"[{name}] episodes_per_s {r['episodes_per_s']:.2f} ({r['episodes']} episodes, "
          f"{r['clients']} clients) | ms p50/p99 adapt {r['adapt_p50_ms']:.2f}/"
          f"{r['adapt_p99_ms']:.2f} classify {r['classify_p50_ms']:.2f}/"
          f"{r['classify_p99_ms']:.2f} request {r['request_p50_ms']:.2f}/"
          f"{r['request_p99_ms']:.2f} | vs plain engine median "
          f"{r['episode_median_abs_err_vs_plain']:.3e} max "
          f"{r['episode_max_abs_err_vs_plain']:.3e}, bitwise vs a fresh engine | "
          f"{PHASE_SECONDS[name]:.1f} s | {json.dumps(r)}", flush=True)


def print_cli(name, r) -> None:
    """A CLI phase's line: per step (the synchronized call), the whole
    loop of each unsynchronized call, eval ms, peak memory, launches per
    iteration, the phase's seconds, then everything as JSON."""
    step = r["per_step"]
    windows = " | ".join(
        f"K={w['k']} device_prefetch {w['device_prefetch']} meta_iters_per_s "
        f"{w['meta_iters_per_s']:.3f} over {w['iterations']} iterations, "
        f"input wait {w['input_wait_s']:.4f} s"
        for w in r["window"] if not w["synchronized"]
    )
    print(f"[{name}] per step (K=1, a synchronize after each): "
          f"meta_iters_per_s {step['meta_iters_per_s']:.3f} step_p50_ms "
          f"{step['step_p50_ms']:.2f} input_wait_share "
          f"{step['input_wait_share']:.4f} | whole loop (no added "
          f"synchronize, capture and epoch boundary included): {windows} "
          f"| eval_ms_per_iter_p50 {r['eval_ms_per_iter_p50']:.2f} "
          f"| peak_mem_gb {r['peak_mem_gb']:.3f} (held at the start "
          f"{r['mem_at_start_gb']:.3f}) | launches per train iteration "
          f"{json.dumps(r['launches_per_train_iter'])}, per eval iteration "
          f"{json.dumps(r['launches_per_eval_iter'])} | {PHASE_SECONDS[name]:.1f} s "
          f"| {json.dumps({k: v for k, v in r.items() if k != 'archive'})}", flush=True)


def print_chaos(r, smi) -> None:
    """The chaos phase's lines, one a check, with the card's name and
    power limit beside the times."""
    v = r["supervised"]
    rows = "; ".join(f"{'+'.join(p['faults']) or 'clean'} rc {p['rc']}"
                     for p in v["phases"])
    print(f"[chaos] supervised run of {','.join(CHAOS_SCHEDULE)} through the "
          f"port's dispatcher (rc {v['dispatcher_rc']}): phases {rows}; requeued on "
          f"75, hang-requeued on 76 | {r['supervised_s']:.1f} s", flush=True)
    print(f"[chaos] bit-exact against the unfaulted twin (train_model_latest's "
          f"{v['leaves']} leaves and summary_statistics.csv's {v['summary_rows']} rows "
          f"without their wall-clock columns): {v['bitexact_vs_baseline']}; every "
          f"fault recovered: "
          f"{all(f.get('recovered') for f in v['faults'].values())}", flush=True)
    print("[chaos] train_recovery_s (fault exit to the resumed process's checkpoint "
          "load) " + " ".join(f"{k} {t:.3f}" for k, t in v["mttr_s"].items())
          + f" | {smi}", flush=True)
    rb = r["rollback"]
    print(f"[chaos] nan under rollback: restored iteration {rb['restored_iter']}, "
          f"rollbacks {rb['nonfinite_rollbacks']}, the replay after the rollback "
          f"bitwise equal to an eager step from the restored state "
          f"{rb['replay_bitwise_vs_eager']}, recaptures {rb['recaptures_after_rollback']}"
          f", losses finite to epoch {rb['epochs']} | "
          f"{PHASE_SECONDS['chaos_rollback']:.1f} s", flush=True)
    o = r["oom"]
    print(f"[chaos] oom: exit {o['exit_code']}, {o['error_type']} in oom_report.json "
          f"({o['error']!r}), memory from the card: in use {o['bytes_in_use']} B, "
          f"peak {o['peak_bytes_in_use']} B, limit {o['bytes_limit']} B | {smi}",
          flush=True)
    t = r["telemetry"]
    print(f"[chaos] telemetry and watchdog on/off, flagship CLI per step: p50 "
          f"{t['step_p50_ms_on']:.2f} / {t['step_p50_ms_off']:.2f} ms, ratio "
          f"{t['ratio_on_off']:.4f}; synchronisations in "
          f"{t['sync_watch']['dispatches']} dispatches between boundaries: "
          f"{t['sync_watch']['syncs']} | {smi}", flush=True)
    print(f"[chaos] {PHASE_SECONDS['chaos']:.1f} s | "
          f"{json.dumps({k: v for k, v in r.items() if k != 'telemetry'}, default=str)}",
          flush=True)


def print_serve_pool(r, smi) -> None:
    """The pool phase's lines, with the card's name and power limit beside
    the times."""
    w, c, p = r["workers"], r["cli"], r["in_process"]
    print(f"[serve_pool] workers: {w['episodes']} episodes from {w['clients']} clients, "
          f"failed {w['failed_requests']}, deaths {w['replica_deaths_total']}, restarts "
          f"{w['replica_restarts_total']}, retries {w['retry_total']}; answers bitwise "
          f"equal to the in-process engine {w['bitwise_vs_in_process']} of {w['episodes']} "
          f"(max gap {w['max_abs_err_vs_in_process']:.3e}); fault to HEALTHY kill "
          f"{w['recovery_s']['kill']:.3f} s, wedge {w['recovery_s']['wedge']:.3f} s; wedge "
          f"detected in {w['wedge_detect_s']:.3f} s (unhealthy_after x interval + timeout "
          f"{w['wedge_budget_s']:.2f} s, probe bound {w['wedge_probe_bound_s']:.2f} s) | "
          f"{smi}", flush=True)
    print(f"[serve_pool] respawned worker 0: repeat support set cache_hit "
          f"{w['respawn0']['cache_hit']}, launches {json.dumps(w['respawn0']['launches'])}, "
          f"spill hits {w['respawn0']['spill_hits']}, kernel library from "
          f"{w['respawn0']['kernel_library']}, nvcc builds {w['respawn0']['nvcc_builds']}; "
          f"promote corrupt {w['promote']['corrupt']}, good {w['promote']['good']} "
          f"(swaps in order {w['promote']['swap_order']}); killed worker exit "
          f"{w['killed_exit']}, wedged worker exit {w['wedged_exit']}; no worker left",
          flush=True)
    lt = p["loadtest"]
    print(f"[serve_pool] cli --replicas 2 (booted beside the in-process part): ready "
          f"{c['ready_s']:.1f} s, exit {c['exit_code']} "
          f"on SIGTERM after {c['drain_s']:.2f} s, workers left {c['workers_left']} | in "
          f"process: launches per dispatch {json.dumps(p['launches'])}; spill write-through "
          f"{p['spill_write_ms_each']:.2f} ms each on the writer thread ({p['spill_writes']}); scale "
          f"{[(s['to'], s['status']) for s in p['scale']]}; load test at "
          f"{POOL_LOADTEST_QPS} qps for {POOL_LOADTEST_S} s, kill at request "
          f"{POOL_LOADTEST_KILL_AT}: serve_slo_p99_ms {lt['serve_slo_p99_ms']} "
          f"serve_loadtest_p99_ms {lt['serve_loadtest_p99_ms']} serve_error_rate "
          f"{lt['serve_error_rate']} serve_recovery_s {lt['serve_recovery_s']}; stale fence "
          f"{json.dumps(p['stale_fence'])} | {smi}", flush=True)
    ls = p["locksan"]
    print(f"[serve_pool] in process under the lock sanitizer: {ls['cycles']} cycles over "
          f"{ls['edges']} edges of {ls['sites']} sites ({ls['acquisitions']} "
          f"acquisitions); longest serve hold {ls['longest_serve_hold_s']:.6f} s at "
          f"{ls['longest_serve_hold_site']} (budget {ls['budget_s']} s) | {smi}", flush=True)
    print(f"[serve_pool] {PHASE_SECONDS['serve_pool']:.1f} s (workers "
          f"{PHASE_SECONDS['serve_pool_workers']:.1f}, cli {PHASE_SECONDS['serve_pool_cli']:.1f}"
          f", in process {PHASE_SECONDS['serve_pool_in_process']:.1f}) | "
          f"{json.dumps(r, default=str)}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from howtotrainyourmamlpytorch_tpu_torch.ops import fused_norm as fn

    # 1. build
    path, build_s, compiler_out = fn.build()
    smi = gpu_line()
    print(f"[build] {os.path.relpath(path, REPO)} in {build_s:.2f} s")
    for line in compiler_out.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    print(f"[build] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | {smi}", flush=True)

    PHASE_SECONDS["build"] = build_s

    # 2. kernels
    t_kernels = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape = {}
    for shape, slope in KERNEL_CASES:
        res = check_and_time_kernels(torch, fn, shape, gen, timing_reps(shape), slope)
        per_shape[shape, slope] = res
        pairs = " ".join(f"{k}={v:.4f}" for k, v in res.get("pairs", {}).items())
        print(f"[kernels] {shape} slope {slope} ms graph/plain graph/bound/eager/"
              f"plain eager {kernel_cells(res)} | var_mean graph="
              f"{res['bn_stats']['library_ms']:.4f}"
              + (f" | eager pairs {pairs}" if pairs else ""), flush=True)
    x, gamma, beta = _inputs(torch, STREAMED_SHAPE, gen)
    streamed = check_and_time_forward(torch, fn, x, gamma, beta, 20, streamed=True)
    g = torch.randn(STREAMED_SHAPE, device=x.device, generator=gen)
    streamed["bn_act_bwd"] = check_and_time_backward(
        torch, fn, x, gamma, beta, g, 20, streamed=True
    )
    print(f"[kernels] {STREAMED_SHAPE} streamed ms graph/plain graph/bound/eager/"
          f"plain eager {kernel_cells(streamed)} | var_mean graph="
          f"{streamed['bn_stats']['library_ms']:.4f}", flush=True)
    cases = [*per_shape.items(), ((STREAMED_SHAPE, "streamed"), streamed)]
    worst = {
        k: max(((r[k]["max_abs_err"], case) for case, r in cases if k in r),
               key=lambda e: e[0])
        for k in fn.KERNELS if k != "bn_act_pool_apply"
    }
    errs = {k: e for k, (e, _) in worst.items()}
    pool = {}
    for shape in POOL_SHAPES:
        pool[shape] = r = check_and_time_pool(torch, fn, shape, gen, timing_reps(shape))
        print(f"[pool] {shape} bn_act_pool_apply ms graph/plain graph/bound/"
              f"eager/plain eager {r['ms']:.4f}/{r['plain_ms']:.4f}/"
              f"{r['bound_ms']:.4f}/{r['eager_ms']:.4f}/{r['eager_plain_ms']:.4f}"
              f" max_abs_err {r['max_abs_err']:.3e}", flush=True)
    errs["bn_act_pool_apply"] = max(r["max_abs_err"] for r in pool.values())
    print(f"[kernels] max_abs_err over all shapes {errs}, each at (shape, slope) "
          f"{ {k: case for k, (_, case) in worst.items()} }")
    functions = check_functions(torch, fn, gen)
    PHASE_SECONDS["kernels"] = time.perf_counter() - t_kernels
    print(f"[functions] max_abs_err vs plain composition {json.dumps(functions)}",
          flush=True)

    # The four kernels on bfloat16 at the bf16 flagship's shapes.
    with phase_timer("kernels_bf16"):
        bf16 = {shape: check_bf16_kernels(torch, fn, shape, gen, shape in BF16_POOL_SHAPES)
                for shape in BF16_SHAPES}
    for shape, res in bf16.items():
        print(f"[kernels_bf16] {shape} slope {SLOPE} ms graph/plain graph/bound(2-byte "
              f"I/O), max_abs_err, max ulps: " + " ".join(
                  f"{k}={v['ms']:.4f}/{v['plain_ms']:.4f}/{v['bound_ms']:.4f} "
                  f"{v['max_abs_err']:.3e} {v['max_ulps']:.0f}" for k, v in res.items()),
              flush=True)
    errs_bf16 = {k: max(r[k]["max_abs_err"] for r in bf16.values() if k in r)
                 for k in fn.KERNELS}

    # 3-8. the main paths, every kernel launch's input shape recorded in
    # ``fn.launch_shapes`` from here on.
    fn.reset_launch_shapes()
    # 3. serve, MAML++ on the VGG and on ResNet-12
    with phase_timer("serve"):
        serve = serve_phase(torch, fn)
    print(f"[serve] {json.dumps(serve)}", flush=True)
    with phase_timer("resnet_serve"):
        resnet_serve = serve_phase(torch, fn, RESNET12, RESNET_SERVE_LAUNCHES,
                                   chaotic=True)
    print(f"[resnet_serve] {json.dumps(resnet_serve)}", flush=True)
    # The serving runtime's front door: HTTP, the command line, and the
    # in-process API at north-star width.
    with phase_timer("serve_http"):
        serve_http = serve_http_phase(torch, fn)
    print_serve("serve_http", serve_http)
    # [serve_cli] runs later, beside [control_plane]'s second trainer
    # process.
    with phase_timer("serve_api_north_star"):
        serve_north = serve_api_north_star_phase(torch, fn)
    print_serve("serve_api_north_star", serve_north)
    # The supervised replica pool and the durable tier.
    with phase_timer("serve_pool"):
        serve_pool = serve_pool_phase(torch, fn)
    print_serve_pool(serve_pool, smi)

    # 4. train
    with phase_timer("train"):
        train = train_phase(torch, fn)
    print(f"[train] meta_iters_per_s {train['meta_iters_per_s']:.3f} step_p50_ms "
          f"{train['step_p50_ms']:.2f} | {json.dumps(train)}", flush=True)
    with phase_timer("graph"):
        graph = graph_phase(torch, fn)
    for tag, g in graph.items():
        print_graph("graph", tag, g)
    with phase_timer("remat"):
        remat = remat_phase(torch)
    print(f"[remat] fused against plain-norm learners, remat_inner_steps on "
          f"{json.dumps(remat)}", flush=True)
    with phase_timer("resnet_graph"):
        resnet_graph = resnet_graph_phase(torch, fn)
    print_graph("resnet_graph", "resnet12", resnet_graph["resnet12"])
    print(f"[resnet_graph] fused against the plain-norm learner, remat on, "
          f"and remat on against off: {json.dumps(resnet_graph['remat_resnet12'])}",
          flush=True)
    with phase_timer("backbone_options"):
        options = backbone_options_phase(torch, fn)
    print(f"[backbone_options] {json.dumps(options)}", flush=True)

    # 5-6. the training command line. One Omniglot tree serves the
    # flagship CLI, the zoo, ResNet-12, the compute options, [chaos] and
    # [control_plane].
    import tempfile

    tree_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_tree_")
    tree = tree_dir.name
    with phase_timer("zoo_tree"):
        write_omniglot_tree(os.path.join(tree, "omniglot_synth"))
    cli = {}
    with phase_timer("cli_flagship"):
        cli["cli_flagship"] = cli_flagship_phase(torch, fn, tree)
    print_cli("cli_flagship", cli["cli_flagship"])
    with phase_timer("cli_north_star"):
        cli["cli_north_star"] = cli_north_star_phase(torch, fn)
    print_cli("cli_north_star", cli["cli_north_star"])

    # 7-8. the learner zoo: fused against plain, then each entry point
    # on the shared tree.
    with phase_timer("zoo_plain"):
        zoo_plain = zoo_plain_phase(torch)
    print(f"[zoo_plain] first update, fused against plain-norm learners "
          f"{json.dumps(zoo_plain)}", flush=True)
    for kind, *_ in ZOO:
        name = f"cli_{kind}"
        with phase_timer(name):
            cli[name] = cli_zoo_phase(torch, fn, kind, tree)
        print_cli(name, cli[name])
    # 9. MAML++ on ResNet-12 through the same entry point.
    with phase_timer("cli_resnet12"):
        cli["cli_resnet12"] = cli_resnet12_phase(torch, fn, tree)
    print_cli("cli_resnet12", cli["cli_resnet12"])

    # 10. The MAML learner's compute options: bfloat16 (the step
    # graph and the CLI), on-device augmentation, task chunks and
    # lane padding.
    with phase_timer("graph_bf16"):
        graph_bf16 = graph_phase(torch, fn, [(
            "flagship_bf16", BF16_CONFIG, train_batch, CLI_FLAGSHIP_TRAIN,
            CLI_FLAGSHIP_TRAIN_FINAL, {"compute_dtype": "bfloat16"},
        )])
    print_graph("graph_bf16", "flagship_bf16", graph_bf16["flagship_bf16"])
    with phase_timer("cli_bf16"):
        cli["cli_bf16"], cli_bf16_f32 = cli_bf16_phase(torch, fn, tree)
    print(f"[cli_bf16] losses against the float32 run, first 20 iterations: "
          f"max gap {cli['cli_bf16']['loss_gap_vs_float32']['max']:.4f}, "
          f"mean {cli['cli_bf16']['loss_gap_vs_float32']['mean']:.4f} (bar "
          f"{BF16_LOSS_ATOL} + {BF16_LOSS_RTOL} x |float32|); float32 per "
          f"step meta_iters_per_s {cli_bf16_f32['per_step']['meta_iters_per_s']:.3f}"
          f" step_p50_ms {cli_bf16_f32['per_step']['step_p50_ms']:.2f} peak_mem_gb "
          f"{cli_bf16_f32['peak_mem_gb']:.3f}", flush=True)
    print_cli("cli_bf16", cli["cli_bf16"])
    with phase_timer("device_augment"):
        augmented = device_augment_phase(torch, fn, tree)
    print(f"[device_augment] 3 replayed iterations and the checkpoint bitwise "
          f"equal to the host-rotated run's: losses "
          f"{augmented['device_augment']['train_losses']} | per step ms p50 "
          f"{augmented['device_augment']['per_step']['step_p50_ms']:.2f} "
          f"(host-rotated {augmented['device_augment_host']['per_step']['step_p50_ms']:.2f})"
          f" | {PHASE_SECONDS['device_augment']:.1f} s | {json.dumps(augmented)}",
          flush=True)
    # 11. The operations plane on the same tree.
    with phase_timer("chaos"):
        chaos = chaos_phase(torch, fn, tree)
    print_chaos(chaos, smi)
    # 12. The serving control plane: the trainer's checkpoints promoted
    # into a live pool, and the pool's size following its load.
    def serve_cli():
        with phase_timer("serve_cli"):
            return serve_cli_phase(torch)

    serve_telemetry = os.path.join(tree, "promote_telemetry.jsonl")
    with phase_timer("control_plane"):
        control = control_plane_phase(torch, fn, tree, serve_cli,
                                      keep_telemetry=serve_telemetry)
    print_serve_cli(control.pop("background"))
    print_control_plane(control, smi)
    # 13. Data-parallel meta-training across processes, on the same tree,
    # alone (its ranks' rates are timed); then the kill-host loop (process
    # starts and a resume, timed from the death) beside [feedback],
    # [task_chunk] and [lane_pad].
    from concurrent.futures import ThreadPoolExecutor

    with phase_timer("fleet"):
        fleet = fleet_phase(torch, fn, tree)
    beside = ThreadPoolExecutor(max_workers=1)
    killhost = beside.submit(killhost_phase, tree)
    # 14. The hard-episode loop: the promote loop's serving telemetry mined,
    # the flagship trained on the manifest, its telemetry reported.
    with phase_timer("feedback"):
        feedback = feedback_phase(torch, fn, tree, serve_telemetry)
    print_feedback(feedback, smi)
    with phase_timer("task_chunk"):
        chunked = task_chunk_phase(torch, fn)
    print("[task_chunk] " + " | ".join(
        f"{tag}: step peak GB chunked {r['chunked_step_peak_gb']:.3f} full "
        f"{r['full_step_peak_gb']:.3f}, dispatch peak GB chunked "
        f"{r['chunked_dispatch_peak_gb']:.3f} full {r['full_dispatch_peak_gb']:.3f}, "
        f"replay ms/iter chunked {r['chunked_replay_ms_per_iter']:.2f} full "
        f"{r['full_replay_ms_per_iter']:.2f}, first loss gap {r['first_loss_rel_gap']:.2e}"
        for tag, r in chunked.items() if tag != "launches")
        + f" | {PHASE_SECONDS['task_chunk']:.1f} s | {json.dumps(chunked)}", flush=True)
    with phase_timer("lane_pad"):
        lane_pad = lane_pad_phase(torch, fn)
    print(f"[lane_pad] north star 48 -> 64 filters against unpadded: served "
          f"episodes max {lane_pad['episode_max_abs_err']:.3e} median "
          f"{lane_pad['episode_median_abs_err']:.3e} (bars {lane_pad['episode_bars']}), "
          f"eval logits {lane_pad['eval_logit_max_abs_err']:.3e}, first loss gap "
          f"{lane_pad['first_loss_rel_gap_vs_plain']:.2e}; replay ms/iter padded "
          f"{lane_pad['padded_replay_ms_per_iter']:.2f} unpadded "
          f"{lane_pad['unpadded_replay_ms_per_iter']:.2f}; checkpoints both ways "
          f"bitwise | {PHASE_SECONDS['lane_pad']:.1f} s | {json.dumps(lane_pad)}",
          flush=True)
    fleet["killhost"] = killhost.result()
    beside.shutdown()
    tree_dir.cleanup()
    print_fleet(fleet, smi)

    print("[replay] fused-norm kernel nodes of each captured graph, each equal "
          f"to the launches its capture counted: {json.dumps(REPLAY_NODES)}",
          flush=True)

    # Every (shape, slope) a kernel was called at on the main paths was held
    # to the plain version above.
    checked = {name: set(per_shape) for name in ("bn_stats_act", "bn_act_bwd")}
    checked["bn_stats"] = {(shape, None) for shape, _ in per_shape}
    checked["bn_act_pool_apply"] = {(shape, SLOPE) for shape in pool}
    for shape, res in bf16.items():
        for name in res:
            checked[name].add((shape, None if name == "bn_stats" else SLOPE, "bfloat16"))
    # The shapes the main paths launched at here and in the live pool
    # workers.
    ran = {name: set(keys) for name, keys in fn.launch_shapes.items()}
    for name, keys in serve_pool["workers"]["worker_shapes"].items():
        ran[name].update(keys)
    unchecked = {k: sorted(v - checked[k]) for k, v in ran.items() if v - checked[k]}
    if unchecked:
        fail(f"kernel (shape, slope) pairs of the main paths that no check "
             f"compared with the plain version: {unchecked}")
    no_bf16 = [k for k, v in ran.items() if not any(len(c) == 3 for c in v)]
    if no_bf16:
        fail(f"kernels that no bfloat16 path launched: {no_bf16}")
    print("[coverage] (shape, slope) each kernel ran at on the main paths, each "
          f"checked above: {json.dumps({k: sorted(v) for k, v in ran.items()})}",
          flush=True)

    # 9. result: bn_stats_act and bn_act_bwd at the serve path's support
    # stage-0 shape, the largest of their adapt shapes (the rows earlier
    # slices reported; the kernel lines above give every other shape);
    # bn_stats and K5 at the train path's stage 0, where they run together.
    # Launches are those the serve, train and CLI runs executed together, a
    # replay counting the launches its graph captured (which its kernel
    # nodes confirmed).
    # The bf16 columns: each kernel at (5, 512, 28, 28) in bfloat16 (the
    # bytes of the float32 rows' (5, 256, 28, 28)), its largest error over
    # the bf16 shapes, and the bf16 CLI's launches.
    paths = [serve, resnet_serve, serve_http, serve_north, serve_pool, train, *cli.values(),
             cli_bf16_f32, *augmented.values(), chaos["telemetry"], control, feedback,
             chunked, lane_pad]
    kernels = []
    for name in fn.KERNELS:
        if name == "bn_act_pool_apply":
            r = pool[POOL_SHAPES[0]]
        elif name == "bn_stats":
            r = per_shape[TRAIN_SHAPES[0], SLOPE][name]
        else:
            r = per_shape[FLAGSHIP_SHAPES[0], SLOPE][name]
        b = bf16[TRAIN_SHAPES[0]][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "howtotrainyourmamlpytorch_tpu_torch/csrc/fused_norm.cu",
            "replaces": REPLACES[name],
            "launches": sum(p["launches"][name] for p in paths),
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "bf16_ms": b["ms"], "bf16_plain_ms": b["plain_ms"],
            "bf16_bound_ms": b["bound_ms"], "bf16_bound_by": b["bound_by"],
            "bf16_max_abs_err": errs_bf16[name], "bf16_max_ulps": max(
                res[name]["max_ulps"] for res in bf16.values() if name in res),
            "bf16_launches": cli["cli_bf16"]["launches"][name],
            "fleet_launches_per_rank_iter": {
                prog: launches[name]
                for prog, launches in fleet["launches_per_rank_iter"].items()},
        })
    print(f"[seconds] each phase: {json.dumps(PHASE_SECONDS)}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
