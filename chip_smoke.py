"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: its name and power limit (nvidia-smi) and torch's view;
  2. the build: every CUDA kernel of the port, one ``nvcc`` each, all
     started together; the script waits for ``scored_reduce``'s alone and
     runs the FL phases (3's ``scored_reduce`` checks, 4's small runs and
     precision check, 5-6j, 6h) while the flash kernels' builds finish,
     then waits for those before the phases that launch them (3's flash
     checks, 4's small transformer, 7-8);
  3. the kernels: each kernel against its plain PyTorch version on the card
     at its path's shapes and at ragged ones, with times (CUDA events)
     beside the least time the card could take and one PyTorch library
     call that computes the same function; flash attention is timed twice
     at the prefill shape, on contiguous inputs and on the model's strided
     (B, S, H, D) views, and checked with v narrower than q and k (MLA's
     192/128 and other pairs); ptxas must report no spill in any
     instantiation of the Hopper flash kernel; ``scored_reduce`` also at
     the FCN's cluster-block (32, N) and tier-2 (8, N) shapes of 6g;
  4. small runs on the card against the same runs on the CPU (whose plain
     paths the CPU tests tie to the JAX reference): the harness with each
     of the six algorithms and the genie on the MLP, OSAFL on the CNN,
     SqueezeNet and LSTM, and the loop engine with the six algorithms on
     the MLP and OSAFL on the CNN; the CNN's and SqueezeNet's gradients
     on one batch in full f32 (and, as a control the check must see, with
     cuDNN's TF32 on); and a reduced deepseek-coder-33b (7:1 head groups
     kept) through prefill and decode;
  5. the FL main path: ``repro_torch.harness.run("osafl", ...)`` on the FCN
     at the paper's U=256 clients, with the kernels' launch counts reset
     just before and read just after;
  5b. the list API at full width: one round of real ``ClientUpdate``s of
     the FCN at U=256 from ``local_train`` on the card, fed to each loop
     server and to its stacked counterpart's ``round(updates)``, for the
     six algorithms, from the same weights;
  5c. the loop engine at full width: ``run("osafl", engine="loop")`` on the
     main path's configuration, 2 rounds;
  6. a breakdown of an FL main-path round by stage;
  6b. the paper's comparison grid at its widths and U=256, depth cut to 2-3
     rounds: the five baselines and the genie on the FCN (Dataset-1; OSAFL
     there is the main path's run), and OSAFL on the CNN, SqueezeNet
     (Dataset-1) and LSTM (Dataset-2, Table IV's recipe), each run with the
     launch counts reset just before and read just after;
  6c. determinism: the grid's CNN and SqueezeNet runs again, which must
     repeat bit for bit, in turns with the same runs with cuDNN free to
     pick its algorithms (the harness's hold bypassed), a control that
     times what the hold costs;
  6d. the request model: the main path's configuration again with the
     stacked request model and with the python streams, in turns
     (``request_gen_s``, ``round_s``, peak memory of each); then both
     paper presets as configured (stacked requests), cut to 3 rounds:
     Table II (FCN, topk 2, capacities 80-160) and Table IV (LSTM,
     Dataset-2, capacities 320-640, ``local_lr`` 0.2, ``global_lr`` 20);
     small stacked-request runs on the card against the CPU;
  6e. the f32 resource solve: one U=256 batch through the x64 and the f32
     solve on the card, timed, held to DESIGN.md's tolerance; then the
     main path with ``resource_backend="f32"``;
  6f. checkpoints at full width: the main path with stacked requests, 4
     rounds, a snapshot every 2 (async v2 writer, ``keep_last=1``, round 2
     claimed), then a run resumed from round 2 whose rounds 2-3 and final
     snapshot must equal the first run's bit for bit; snapshot bytes, the
     time ``submit`` holds the loop, the writer's and the loads' times,
     free disk and host memory; then the loop engine's blocking v1 resume
     on the MLP;
  6g. cohorts, clusters, scenarios and sketches at full width (FCN,
     Dataset-1, capacities 320-640, 3 rounds): the sparse cohort (U=1024
     registered users, C=256 slots, participation 0.5, stacked requests),
     the main path with 8 edge clusters, all of them together under
     ``churn+flash_crowd+cluster_churn``, Fig. 1's paper preset (MLP,
     Dataset-2, U=256) with and without ``quiet(scale=0.0)``, and the main
     path with 256-dim sketched scores, each with the launch counts reset
     just before and read just after; a breakdown of the hierarchical,
     the sparse and the sketched round by stage; small runs card against
     CPU of every algorithm with a cohort and with 2 clusters, of OSAFL
     under every registry scenario on the dense and the sparse path and
     sketched; and a sparse hierarchical run resumed on the card, bit for
     bit;
  6i. the pod engine: the main path's configuration through
     ``run(..., mesh=make_host_mesh(), pod_engine=...)``, OSAFL on each of
     the four pod engines and FedAvg on the fedavg engine, launch counts and
     peak memory reset just before each run and read just after; exact_tp
     and OSAFL on fedavg equal phase 5's rounds bit for bit, recompute
     (host-bound; its two runs cut to 2 rounds) with phase 5's
     participants and, at ``global_lr=1`` against a stacked run there,
     within 1e-5 (its gap at 16 printed beside that of the
     stacked run with its weights moved one ulp), stale finite and unlike
     exact_tp, FedAvg equal to the grid's FedAvg run; small pod runs card
     against CPU (each engine, both
     request models); a "pod" snapshot resumed on the card, bit for bit;
     then the three FL examples: ``launch/quickstart.run()`` (the loss
     falls over 15 rounds), ``launch/resource_optimization.run()`` and
     ``launch/train_fl_video_caching.run(steps=20)`` at its ~100M config
     (the loss falls; steady step time and peak memory);
  6j. the pod engine over client rows (one ``torch.distributed`` rank a
     row): two gloo ranks spawned on the card after the kernels are
     built, each on its 128 of the 256 clients (its rows of the FIFO
     buffer and of the (U, N) contribution buffer, its ``scored_reduce``
     launch at (128, N) once an OSAFL round), run OSAFL on exact_tp at
     ``global_lr=1`` (within 1e-5 of 6i's stacked run, participants
     exact; at 16 a split sum rounds like a one-ulp change of the
     weights, which ``tools/pod_mesh_probe.py`` reads) and FedAvg (within
     1e-5 of the grid's); every rank's history the same; while they
     start, this process checks the kernel at (128, N) f32 against its
     plain version, timed beside its bound, and, the one rank of an NCCL
     group, runs OSAFL on exact_tp, bit for bit phase 5's run. The ranks
     also run 6g's hierarchical run (K=8: 4 cluster blocks of 32 slots a
     rank) and its sparse hierarchical run under churn, flash crowds and
     cluster moves (U=1024 behind C=256 slots, K=8) at ``global_lr=1``,
     each within 1e-5 of the same run in one process here, participants
     exact, with ``scored_reduce`` launched K/R + 1 = 5 times a round on
     each rank; here the kernel is also checked and timed at the ranks'
     (32, N) block and (8, N) tier-2 shapes. Per rank: each
     round's own seconds, seconds and calls in collectives (the sparse
     cohort's table gathers at admission counted apart), peak memory and
     the launches;
  6h. the fused round, each segment of ``rounds_per_dispatch`` rounds one
     captured CUDA graph replayed once: the main path's configuration
     with stacked requests and the f32 solve in 3-round segments over 6
     rounds and 1-round segments over 3 (the first 3 rounds bit for bit),
     beside the dispatch round on it (``round_s``, capture seconds, peak
     memory, launches = rounds); replay parity (the dispatch components fed
     the fused draws, x64) on the small MLP and at full width, with peak
     memory after one and two captured lengths and a profiled warm
     segment (one ``cudaGraphLaunch``, no ``cudaLaunchKernel``);
     ``scored_reduce`` inside a graph beside its launched time; Fig. 1's
     preset as one 8-round segment beside its dispatch run; small fused
     runs card against CPU; train-while-serve: the fused main path writing
     a snapshot every 2 of 4 rounds while ``repro_torch.launch.serve``
     scores request batches on the card, its round-4 logits bit for bit
     the trainer's;
  7. the serving path: deepseek-coder-33b at full width (d_model 7168,
     56/8 heads, head_dim 128), depth cut to 8 layers, random weights from
     a seed: ``make_prefill_step`` on 4 x 4096-token prompts, then
     ``serve_decode.run`` (batch 8, 32-token prompts, 32 decode steps,
     4096-position cache), launch counts reset just before and read just
     after; a profile of one prefill call by kernel; then the flash
     prefill against the KV-cache decode path on one prompt;
  7b. the MoE serving path: the flash kernel at deepseek-v3's MLA prefill
     shape (q/k head dim 192, v head dim 128, nothing padded: the Hopper
     kernel's <192, 128>) against
     its plain version, repeated bit for bit, timed beside its bound,
     ``scaled_dot_product_attention`` on the same tensors and, in turns,
     the padded problem (v zero-padded to 192) on the kept ``mma.sync``
     route; then
     arctic-480b (2 of 35 layers) and deepseek-v3-671b (5 of 61: 3 dense,
     2 MoE, the MTP block) at full width with seeded random bf16 weights,
     one config at a time: two timed ``make_prefill_step`` calls on 4 x
     4096 prompts (flash once a layer, the same tokens bit for bit), a
     third that counts each MoE layer's capacity and dropped assignments,
     a profiled one (whose flash kernels must all be the Hopper kernel,
     once a layer), forward against decode at ``capacity_factor`` 50 (f32
     compute and cache; the bf16 row beside it), then
     ``serve_decode.run`` (batch 8, 4096-position cache);
  7c. the recurrent serving path: the flash kernel at zamba2's shared
     attention shape (4, 32, 32, 4096, 80; the Hopper kernel's <128, 128>,
     columns 80-127 filled with zeros) against its plain version, repeated
     bit for bit, timed beside its bound and
     ``scaled_dot_product_attention``; then zamba2-2.7b (54 Mamba2 layers
     and 9 applications of the shared attention block) and xlstm-350m (21
     mLSTM and 3 sLSTM blocks) at full width and depth with seeded random
     f32 weights, one config at a time: two timed ``make_prefill_step``
     calls on 4 x 4096 prompts (flash 9 times a zamba2 call, never in
     xLSTM; the second with each block kind's span on the device
     timeline), a profiled one (zamba2's flash kernels all <128, 128>),
     forward against decode on 2 x 512 tokens over the first groups of the
     same weights (zamba2 2 of 9, xLSTM 1 of 3: chunked SSD and chunked
     mLSTM against their recurrences; f32 compute and caches at atol
     6e-3, rtol 1e-2; the bf16 row beside it), then
     ``serve_decode.run`` (batch 8, 4096-position cache) and the peak
     device memory;
  7d. the cross-attention serving path: the flash kernel at whisper-medium's
     decoder self-attention (8, 16, 16, 448, 64; the Hopper kernel's <64,
     64>) and llama-3.2-vision-11b's self layers (4, 32, 8, 4096, 128; GQA
     4:1 at <128, 128>) against its plain version, repeated bit for bit,
     timed beside its bound and ``scaled_dot_product_attention``; then
     both at full width and depth with seeded random f32 weights (the
     vision decoder's tanh gates at 0.5, not their zero init), one at a
     time: whisper's encoder over 8 x 1,500 frames alone, two timed
     ``make_prefill_step`` calls (whisper 8 x 448 tokens with its frames,
     the vision decoder 4 x 4096 with 4 x 1,601 patches; flash once a
     causal self-attention layer, 24 and 32; never in the encoder or a
     cross-attention), a profiled one (its flash kernels the shape's
     symbol alone, once a layer), forward against decode over the memory
     on 2 x 128 tokens (f32 compute and caches within 2e-2; the bf16 row
     beside it), then ``serve_decode.run`` (batch 8; whisper's cache 448
     positions, the vision decoder's 4096), the peak device memory and
     each leg's seconds;
  8. the training path: the flash backward kernels against their plain
     version (log-sum-exp of the forward included) at the training shape,
     ragged and small shapes, f32 and bf16, causal and not, and timed at
     the serving prefill shape beside its bound and the backward of
     ``scaled_dot_product_attention`` (the forward timed there with and
     without its log-sum-exp); then ``repro_torch.launch.train.run`` on
     qwen1.5-4b at full width, depth cut to 8 layers, batch 8 x 1024, 5
     steps of each engine at lr 0.005 (recompute and stale with 4
     clients, fedavg, exact_tp on the one client row), launch counts
     reset just before and read just after each run and held to layers x
     passes a step; exact_tp against fedavg on one step; recompute's first
     step twice, bit for bit; small float32 runs of every engine card
     against CPU; a profiled fedavg step, whose flash backward must be the
     Hopper route's kernels, each once a layer. The Hopper backward's
     ptxas report (from the build, or kept beside a library built before)
     must show no spill.
Convolutions run in full f32 and deterministic inside every harness run
(cuDNN's TF32 and benchmarking are held off and restored after). The line
before the last is one JSON object with every kernel's numbers
("launches" from the kernel's own main path, "launches_by_path" from
every path); the last line is the result. Exits non-zero, with no result,
when there is no CUDA card or the port's sources are not beside this
file.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

MAIN_U = 256                        # the paper's cohort
MAIN_RUN = dict(model="fcn", dataset=1, num_clients=MAIN_U,
                capacity=(320, 640), arrivals=8, batch=16, rounds=3, seed=0)
MAIN_EVAL = 512
# scored_reduce on the FL main path and the grid's other OSAFL paths: the
# (U, N) buffers of the FCN, CNN, SqueezeNet and LSTM at U=256, N from each
# model's codec (the CNN's and the LSTM's N are not multiples of 8)
SCORED_MODELS = ("fcn", "cnn", "squeezenet", "lstm")
# the paper's comparison grid (benchmarks/table2_dataset1.py: every
# algorithm and the genie over fcn and cnn on Dataset-1; table4_dataset2.py
# :33-36: lstm on Dataset-2) at U=256, depth cut to 2 (FCN) or 3 rounds;
# OSAFL on the FCN is the FL main path's run
ALGS = ("osafl", "fedavg", "fedprox", "fednova", "afa_cd", "feddisco",
        "centralized")
GRID_D1 = dict(dataset=1, num_clients=MAIN_U, capacity=(320, 640),
               arrivals=8, batch=16, seed=0)
GRID_RUNS = (
    [(alg, dict(GRID_D1, model="fcn", rounds=2)) for alg in ALGS[1:]]
    + [("osafl", dict(GRID_D1, model=m, rounds=3))
       for m in ("cnn", "squeezenet")]
    + [("osafl", dict(GRID_D1, model="lstm", dataset=2, local_lr=0.2,
                      global_lr=20.0, rounds=3))])
GRID_EVAL = 512
# small runs, card against CPU: every algorithm and the genie on the MLP;
# OSAFL on the three other models. The CNN and SqueezeNet take global_lr=1:
# at the default 16 a one-ulp change of their weights moves a later
# round's loss by more than the 1e-4 gate (tests/test_torch_precision.py).
SMALL_MLP = dict(model="mlp", dataset=2, num_clients=16, rounds=3,
                 capacity=(16, 32), seed=3)
SMALL_CONV = dict(dataset=1, num_clients=4, rounds=2, capacity=(16, 32),
                  global_lr=1.0, seed=3)
SMALL_RUNS = (
    [(alg, SMALL_MLP) for alg in ALGS]
    + [("osafl", dict(SMALL_CONV, model=m)) for m in ("cnn", "squeezenet")]
    + [("osafl", dict(model="lstm", dataset=2, num_clients=8, rounds=3,
                      capacity=(16, 32), seed=3))]
    # the loop engine: every algorithm on the MLP, OSAFL on the CNN
    + [(alg, dict(SMALL_MLP, engine="loop")) for alg in ALGS[:-1]]
    + [("osafl", dict(SMALL_CONV, model="cnn", engine="loop"))])
# the list API and the loop engine at full width: the main path's FCN
# configuration (the loop engine's run cut to 2 rounds)
LOOP_RUN = dict(MAIN_RUN, rounds=2, engine="loop")
LIST_TOL = 1e-5         # tests/test_stacked_engine.py's loop-against-stacked
# The gate's loss cannot see cuDNN's TF32 at global_lr=1 (about 1e-5 from
# the CPU on an NVIDIA H100): the CNN's and SqueezeNet's gradients on
# one batch are held to the CPU's within GRAD_TOL (relative L2) in full f32,
# and must miss it with TF32 on
GRAD_TOL = 1e-5
# norms/mean_sq: the reference kernel test's rtol; dots: the same factor
# times sqrt(norms * mean_sq), the size of the terms a dot sums
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}

# flash attention: the serving path's prefill (B, H, Hkv, S, D), bf16,
# causal, timed on contiguous (B, H, S, D) inputs and on the model's
# (B, S, H, D) views; ragged and small shapes: S of one key, S ending
# mid-tile above one tile, D = 40 (filled to the 64 bucket), zamba2's
# D = 80 (filled to the 128 bucket), D = 256 (the mma.sync kernel);
# whisper-medium's decoder (D = 64) and llama-3.2-vision-11b's self layers
# (GQA 4:1) at their prefill shapes; tests/test_kernels.py:26's tolerances
FLASH_MAIN = (4, 56, 8, 4096, 128)
# v narrower than q and k (B, H, Hkv, S, D, Dv): MLA's 192/128 at a ragged
# S of one tile and past one, 256/128 (the Hopper kernel's <256, 128>), a
# ragged pair, and Dv = 40 in the <128, 128> bucket (v's second box lies
# wholly past Dv: TMA fills it with zeros)
FLASH_DV_SHAPES = ((1, 4, 4, 77, 192, 128), (2, 8, 2, 130, 192, 128),
                   (1, 4, 2, 130, 256, 128), (2, 8, 2, 130, 136, 72),
                   (1, 4, 2, 77, 128, 40))
FLASH_SHAPES = ((1, 7, 1, 1, 128), (2, 14, 2, 77, 64), (1, 4, 4, 130, 64),
                (2, 56, 8, 24, 128), (1, 8, 2, 512, 128), (2, 14, 2, 300, 128),
                (2, 14, 2, 130, 40), (1, 8, 2, 130, 256),
                (2, 32, 32, 130, 80), (8, 16, 16, 448, 64),
                (4, 32, 8, 4096, 128))
# the kernels of csrc/flash_attention.cu, by symbol (prefill_breakdown)
FLASH_SYMBOLS = ("flash_bf16_wgmma_kernel", "flash_bf16_kernel",
                 "flash_f32_kernel")
# and of csrc/flash_attention_bwd.cu: the Hopper route (bf16, D <= 128)
# first, then the mma.sync (bf16, D > 128) and f32 routes
FLASH_BWD_HOPPER = ("stats_kernel", "bwd_bf16_wgmma_kernel",
                    "dq_convert_kernel")
FLASH_BWD_SYMBOLS = (*FLASH_BWD_HOPPER, "delta_kernel", "dkdv_bf16_kernel",
                     "dq_bf16_kernel", "dkdv_f32_kernel", "dq_f32_kernel")
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the paper presets as configured (benchmarks/table2_dataset1.py:31-36 and
# table4_dataset2.py:30-36: U=256, stacked requests), depth cut to 3 rounds
PRESET_RUNS = (
    ("table II", dict(model="fcn", dataset=1, num_clients=MAIN_U,
                      capacity=(80, 160), topk=2, rounds=3, seed=0,
                      request_backend="stacked")),
    ("table IV", dict(model="lstm", dataset=2, num_clients=MAIN_U,
                      capacity=(320, 640), arrivals=8, local_lr=0.2,
                      global_lr=20.0, topk=1, rounds=3, seed=0,
                      request_backend="stacked")))
# stacked requests, card against CPU (the noise is drawn on the host, so
# the card's stream is the CPU's)
STACKED_SMALL = (
    ("osafl", dict(SMALL_MLP, request_backend="stacked")),
    ("osafl", dict(model="fcn", dataset=1, num_clients=8, rounds=2,
                   capacity=(16, 32), seed=3, request_backend="stacked")))
# checkpoint and resume at full width: the main path with stacked requests,
# 4 rounds, a snapshot every 2; at Table II's capacities when the machine
# cannot hold two full-width snapshots on disk and both loaded in memory
CKPT_RUN = dict(MAIN_RUN, rounds=4, request_backend="stacked")
CKPT_EVERY = 2
LOOP_RESUME = dict(SMALL_MLP, rounds=4, engine="loop")
# DESIGN.md's f32 solve contract against x64
F32_FLIPS, F32_MEDIAN_REL = 0.10, 1e-3
# cohorts, clusters, scenarios and sketches at full width (phase 6g); the
# sparse runs register 1024 users, a population a dense (U, N) buffer of the
# FCN cannot hold (16 GB), behind the main path's 256 slots
COHORT_U, COHORT_C, CLUSTERS = 1024, 256, 8
COHORT_RUNS = (
    ("cohort", dict(MAIN_RUN, num_clients=COHORT_U, cohort_size=COHORT_C,
                    participation=0.5, request_backend="stacked")),
    ("hier", dict(MAIN_RUN, num_clusters=CLUSTERS)),
    ("combined", dict(MAIN_RUN, num_clients=COHORT_U, cohort_size=COHORT_C,
                      participation=0.5, num_clusters=CLUSTERS,
                      request_backend="stacked",
                      scenario="churn(p_away=0.3)+flash_crowd(period=8,"
                               "scale=3)+cluster_churn(rate=0.05)")),
    # benchmarks/fig1_static_vs_timevarying.py:33-35, cut to 3 rounds
    ("fig1", dict(model="mlp", dataset=2, num_clients=MAIN_U, rounds=3,
                  arrivals=8, capacity=(320, 640), seed=0,
                  request_backend="stacked")),
    ("fig1", dict(model="mlp", dataset=2, num_clients=MAIN_U, rounds=3,
                  arrivals=8, capacity=(320, 640), seed=0,
                  request_backend="stacked", scenario="quiet(scale=0.0)")),
    # benchmarks/ablation_scores.py:30
    ("sketch", dict(MAIN_RUN, score_sketch_dim=256)))
FIG1_EVAL = 400                     # the figure script's harness default
# the registry's scenarios, each on the dense and on the sparse path of the
# small MLP run (cluster_churn moves members only with clusters and a pool)
SCENARIOS = ("churn(p_away=0.3)", "flash_crowd(period=2,scale=3)",
             "quiet(scale=0.5)", "radius_step(at=1,factor=1.67)",
             "device_classes", "cluster_churn(rate=0.3)",
             "pareto_select(alpha=1.5)")
SMALL_SPARSE = dict(SMALL_MLP, cohort_size=8, participation=0.5)
COHORT_SMALL = (
    [(alg, SMALL_SPARSE) for alg in ALGS[:-1]]
    + [(alg, dict(SMALL_MLP, num_clusters=2)) for alg in ALGS[:-1]]
    + [("osafl", dict(SMALL_MLP, scenario=scn)) for scn in SCENARIOS]
    + [("osafl", dict(SMALL_SPARSE, scenario=scn,
                      num_clusters=2 if "cluster" in scn else 0))
       for scn in SCENARIOS]
    + [("osafl", dict(SMALL_MLP, score_sketch_dim=64))])
HIER_RESUME = dict(SMALL_SPARSE, rounds=4, num_clusters=2,
                   request_backend="stacked",
                   scenario="cluster_churn(rate=0.3)")
# the fused round (phase 6h): the main path's configuration with stacked
# requests and the f32 solve, as CUDA-graph segments of 3 rounds over 6 and
# of 1 round over 3 (the first 3 rounds must agree bit for bit), beside the
# dispatch round on the same configuration
FUSED_KW = dict(request_backend="stacked", round_backend="fused")
FUSED_RUN = dict(MAIN_RUN, **FUSED_KW, resource_backend="f32", rounds=6,
                 rounds_per_dispatch=3)
FUSED_ONE = dict(FUSED_RUN, rounds=3, rounds_per_dispatch=1)
FUSED_DISPATCH = dict(MAIN_RUN, request_backend="stacked",
                      resource_backend="f32")
# replay parity: the dispatch components fed the fused engine's draws, x64
FUSED_PARITY = (dict(SMALL_MLP, **FUSED_KW),
                dict(MAIN_RUN, **FUSED_KW))
# Fig. 1's paper preset (cohort phase's "fig1") as one 8-round segment
FUSED_FIG1 = dict(next(kw for name, kw in COHORT_RUNS if name == "fig1"),
                  **FUSED_KW, rounds=8, rounds_per_dispatch=8)
# small fused runs, card against CPU: each model with both solves, and one
# sketched run; 2-round segments, so a 3-round run captures two lengths
FUSED_SMALL = [("osafl", dict(kw, **FUSED_KW, resource_backend=b,
                              rounds_per_dispatch=2))
               for kw in (SMALL_MLP,
                          dict(model="fcn", dataset=1, num_clients=8,
                               rounds=2, capacity=(16, 32), seed=3),
                          dict(SMALL_CONV, model="cnn"),
                          dict(model="lstm", dataset=2, num_clients=8,
                               rounds=3, capacity=(16, 32), seed=3))
               for b in ("f32", "x64")] + [
    ("osafl", dict(SMALL_MLP, **FUSED_KW, resource_backend="f32",
                   rounds_per_dispatch=2, score_sketch_dim=64))]
# train-while-serve: the fused main path writing a snapshot every 2 of 4
# rounds while a model server scores Dataset-1 request batches on the card
SERVE_TRAIN = dict(FUSED_RUN, rounds=4)
SERVE_EVERY = 2
# the FL harness's pod engine (phase 6i): the main path's configuration on
# the one client row of make_host_mesh(), OSAFL on each pod engine and
# FedAvg on the fedavg engine; exact_tp and OSAFL on the fedavg engine run
# the stacked engine's gather and vmapped products, so their rounds must be
# phase 5's bit for bit; recompute (one client at a time) is held to the
# stacked engine at the reference's pod-parity bar
# (tests/test_pod_online.py:65-68) at global_lr=1 (pod_phase says why)
POD_ENGINES = ("exact_tp", "recompute", "stale", "fedavg")
POD_BITWISE = ("exact_tp", "fedavg")
POD_TOL = 1e-5
POD_SMALL = dict(model="mlp", dataset=2, num_clients=8, rounds=3,
                 capacity=(12, 24), arrivals=4, batch=8, seed=5,
                 engine="pod")
POD_SMALL_RUNS = (
    [("osafl", dict(POD_SMALL, pod_engine=e, request_backend=b))
     for e in POD_ENGINES for b in ("python", "stacked")]
    + [("fedavg", dict(POD_SMALL, pod_engine="fedavg"))])
POD_RESUME = dict(POD_SMALL, rounds=4, pod_engine="exact_tp")
POD_LR1 = dict(MAIN_RUN, global_lr=1.0)
# recompute is host-bound (one client at a time, ~4-6 s a round at full
# width), so its two runs are cut to 2 of the main path's 3 rounds; its
# gates compare the rounds it ran
POD_RECOMPUTE_ROUNDS = 2
# phase 6j: the pod engine over client rows, each row one process of a
# torch.distributed group: two gloo ranks sharing the card (U/2 = 128
# clients each) and one NCCL rank; (label, alg, pod engine, config)
MESH_RANKS = 2
# 6g's hierarchical run (U=256, K=8: each rank 4 blocks of 32 slots) and its
# run of everything together (U=1024 behind C=256 slots, K=8, churn, flash
# crowds and cluster moves; each rank 128 slots, 4 blocks) at global_lr=1,
# on the two gloo ranks and, in the parent, in one process
MESH_CLUSTER_RUNS = tuple(
    (f"{name} global_lr=1", "osafl", "exact_tp",
     dict(dict(COHORT_RUNS)[name], global_lr=1.0))
    for name in ("hier", "combined"))
MESH_GLOO_RUNS = (
    ("osafl exact_tp global_lr=1", "osafl", "exact_tp", POD_LR1),
    # the grid's FedAvg run (2 rounds)
    ("fedavg fedavg", "fedavg", "fedavg", dict(MAIN_RUN, rounds=2)),
    *MESH_CLUSTER_RUNS)
MESH_NCCL_RUNS = (("osafl exact_tp", "osafl", "exact_tp", MAIN_RUN),)
# the three FL examples at their own sizes: the quickstart's 15 rounds and
# 20 steps of the ~100M h2o-danube-3 example (its sliding window keeps its
# attention on _sdpa's mask: no flash launch)
EXAMPLE_STEPS = 20

# the serving path: deepseek-coder-33b, depth cut 62 -> 8 (f32 weights of
# all 62 layers are 133 GB, more than the card holds)
SERVE_LAYERS = 8
SERVE_PREFILL = dict(batch=4, seq=4096)
SERVE_DECODE = dict(batch=8, prompt_len=32, decode_steps=32, cache_len=4096,
                    seed=1)
LOGIT_TOL = 2e-2                 # bf16 (tests/test_kernels.py:26)
# the MoE serving path (phase 7b): both MoE decoders at full width (bf16
# weights, their own param_dtype), depth cut so that one fits beside its
# prefill: arctic-480b 35 -> 2 MoE layers (~55.4 GB; one layer's 128
# experts are 26.8 GB), deepseek-v3-671b 61 -> its 3 dense layers and 2
# MoE layers (~54.6 GB with the MTP block); the prefill and decode shapes
# of the serving path
MOE_SERVE = (("arctic-480b", 2), ("deepseek-v3-671b", 5))
# deepseek-v3's MLA prefill attention through the flash kernel (B, H, Hkv,
# S, D): q/k head dim 192, v head dim 128, passed as they are
MLA_FLASH = (4, 128, 128, 4096, 192)
MLA_V_DIM = 128
# the Hopper kernel's instantiation it must run: deepseek-v3's profiled
# prefill call must show it once a layer (a profile of this kernel alone,
# late in the script, came back empty)
MLA_SYMBOL = "flash_bf16_wgmma_kernel<192, 128>"
# forward against decode routes alike only when nothing is dropped
# (tests/test_models.py:66-70)
MOE_GATE_CAPACITY = 50.0
# the recurrent serving path (phase 7c): both families at full width and
# depth, f32 weights from seed 0: zamba2-2.7b (54 Mamba2 layers in 9 groups
# of 6, the shared attention block after each group; ~2.42 B parameters,
# 9.7 GB) and xlstm-350m (24 blocks: 3 groups of 7 mLSTM + 1 sLSTM; ~0.52
# B, 2.1 GB); the serving path's prefill and decode shapes
RECURRENT_SERVE = ("zamba2-2.7b", "xlstm-350m")
# forward against decode: a prompt that is a multiple of the SSD's chunk
# (64) and of the mLSTM's (256) and at least twice the latter, so both
# chunked forms are held to their recurrences, at the reference's own
# tolerance (tests/test_models.py:91-94), f32 compute and caches
RECURRENT_GATE_SEQ = 512
RECURRENT_GATE_TOL = dict(atol=6e-3, rtol=1e-2)
# ... over the first groups of the full-depth weights: 512 decode steps
# of all 54 + 9 zamba2 blocks and all 24 xLSTM blocks, in f32 and in bf16,
# took 129 s of a 1,094 s script (measured on one NVIDIA H100 80GB HBM3,
# 700.00 W); two groups of zamba2 (12 Mamba2 layers, the shared
# block twice) and one of xLSTM (7 mLSTM blocks and the sLSTM block) run
# every block kind and both chunked forms
RECURRENT_GATE_LAYERS = {"zamba2-2.7b": 12, "xlstm-350m": 8}
# the flash kernel at zamba2's shared attention (B, H, Hkv, S, D): head dim
# 2560 / 32 = 80, run by the Hopper kernel's <128, 128> (TMA fills columns
# 80-127 with zeros); each profiled zamba2 prefill call must show it alone,
# once a shared-block application
ZAMBA_FLASH = (4, 32, 32, 4096, 80)
ZAMBA_SYMBOL = "flash_bf16_wgmma_kernel<128, 128>"
# the cross-attention serving path (phase 7d): whisper-medium (24 encoder
# blocks over 1,500 frame embeddings, 24 decoder blocks of causal
# self-attention, cross-attention and a gelu MLP; d_model 1024, 16 heads of
# 64; ~0.81 B parameters, 3.2 GB) and llama-3.2-vision-11b (8 groups of 4
# self-attention layers and one gated cross layer over 1,601 projected
# patches of width 1280; d_model 4096, 32/8 heads of 128; ~9.78 B, 39.1
# GB) at full width and depth, f32 weights from seed 0; the cross layers'
# tanh gates set to CROSS_GATE (at their zero init a cross layer adds
# nothing). whisper prefills its decoder's whole context, 8 x 448 tokens,
# over 8 x 1,500 frames; the vision decoder the serving path's 4 x 4096
# over 4 x 1,601 patches. Decode: whisper's cache holds its 448 positions,
# the vision decoder's the serving path's 4096
CROSS_SERVE = ("whisper-medium", "llama-3.2-vision-11b")
CROSS_GATE = 0.5
CROSS_PREFILL = {"whisper-medium": dict(batch=8, seq=448),
                 "llama-3.2-vision-11b": SERVE_PREFILL}
CROSS_DECODE = {"whisper-medium": dict(SERVE_DECODE, cache_len=448),
                "llama-3.2-vision-11b": SERVE_DECODE}
# forward against decode over the memory, f32 compute and caches, at the
# serving tolerance (LOGIT_TOL), the bf16 row beside it
CROSS_GATE_SEQ = 128
# the flash kernel at each one's causal self-attention (B, H, Hkv, S, D):
# whisper's decoder (D = 64: the Hopper kernel's <64, 64>) and the vision
# decoder's self layers (GQA 4:1 at D = 128: <128, 128>); each profiled
# prefill call must show its symbol alone, once a self-attention layer
CROSS_FLASH = {"whisper-medium": ((8, 16, 16, 448, 64),
                                  "flash_bf16_wgmma_kernel<64, 64>"),
               "llama-3.2-vision-11b": ((4, 32, 8, 4096, 128),
                                        "flash_bf16_wgmma_kernel<128, 128>")}
# the transformer zoo's training path (phase 8): qwen1.5-4b at full width
# (d_model 2560, 20 heads x 128, d_ff 6912, vocab 151,936, qkv bias; bf16
# compute, f32 params), depth cut 40 -> 8: recompute holds five
# parameter-sized f32 trees, 28 GB at 8 layers and ~79 GB at 40; batch 8 x
# 1024 of the learnable task, 5 steps per engine, lr 0.005. Plain SGD's
# step on the logits grows with d_model (the final norm gives the hidden
# state a norm of ~sqrt(2560)): at the trainer's default lr of 0.1
# recompute's loss went 12.67, 5.81, 2.23, 24.59, 48.72, at 0.02 12.67,
# 7.05, 0.92, 7.06, 9.25 (NVIDIA H100 80GB HBM3, 700 W)
TRAIN_ARCH = "qwen1.5-4b"
TRAIN_LAYERS = 8
TRAIN_RUN = dict(batch=8, seq=1024, lr=0.005, seed=0)
TRAIN_STEPS = 5
TRAIN_CLIENTS = {"recompute": 4, "stale": 4, "fedavg": 1, "exact_tp": 1}
# each layer's forward (and backward) passes in a step: clients x passes
TRAIN_PASSES = {"recompute": 8, "stale": 4, "fedavg": 1, "exact_tp": 1}
# small runs card against CPU: reduced configs in float32 (deepseek-coder's
# keeps GQA, G = 2), every engine, 2 steps, two clients of two sequences
TRAIN_SMALL = ("qwen1.5-4b", "deepseek-coder-33b")
TRAIN_SMALL_RUN = dict(batch=4, seq=64, lr=0.1, steps=2, num_clients=2)
TRAIN_TOL = 1e-4
# the backward kernels against their plain version (B, H, Hkv, S, D): the
# training shape, S of one key, S ending mid-tile, D = 40 (filled to the
# 64 bucket), 64 and 256 (two column blocks); for the Hopper route's
# ordered dq, eight key tiles of an 8:1 group at a ragged S, and
# h2o-danube's D = 120 and zamba2's D = 80 (ragged in the 128 bucket);
# the serving prefill shape is timed, each of its kernels also alone.
# Each gradient is held on its own (grad_errors): its largest error to
# FLASH_TOL of its own largest magnitude, its error's Frobenius norm to
# FRO_TOL of its own; the log-sum-exp to LSE_TOL (absolute)
BWD_TRAIN = (2, 20, 20, 1024, 128)
# ops.flash_attention's autograd on bf16 model-layout (B, S, H, D) tensors,
# as the full-width fedavg and exact_tp steps give them (B, H, Hkv, S, D)
BWD_MODEL_LAYOUT = (8, 20, 20, 1024, 128)
FRO_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
BWD_SHAPES = ((1, 7, 1, 1, 128), (2, 14, 2, 130, 128), (2, 14, 2, 130, 40),
              (1, 4, 4, 130, 64), (1, 8, 2, 130, 256), (1, 16, 2, 1000, 128),
              (2, 8, 8, 777, 120), (2, 32, 32, 130, 80))
LSE_TOL = 1e-4


def say(*parts) -> None:
    print(*parts, flush=True)


def card() -> tuple:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say(f"card: {smi}")
    say(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{name} count {torch.cuda.device_count()}; matmul tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}; cudnn tf32 "
        f"{torch.backends.cudnn.allow_tf32} (held off inside harness runs)")
    return name, smi


FLASH_KERNELS = ("flash_attention", "flash_attention_bwd")


def start_flash_build():
    """The flash kernels' builds (one ``nvcc`` each) started on a thread
    of their own: returns a future of ``build_kernels(FLASH_KERNELS)``."""
    import concurrent.futures

    from repro_torch.kernels.build import build as build_kernels
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(build_kernels, FLASH_KERNELS)
    pool.shutdown(wait=False)
    return future


def build(names=("scored_reduce",)) -> dict:
    """Build the ``names`` kernel libraries (one nvcc each, in parallel)
    and print ptxas's report; returns the build's ``{name: info}``."""
    from repro_torch.kernels.build import build as build_kernels
    t0 = time.perf_counter()
    return report_build(build_kernels(names), time.perf_counter() - t0)


def report_build(out: dict, seconds: float) -> dict:
    """Print a build's libraries and ptxas's report; returns ``out``."""
    say(f"build: {len(out)} kernel(s) in {seconds:.3f} s")
    for name, info in out.items():
        say(f"  {name}: {info['seconds']:.3f} s -> {info['path'].name}"
            + ("" if info["seconds"] else " (built before; its report:)"))
        # ptxas per kernel: registers and shared memory, the stack and
        # spill line under "Function properties", and any warning (a
        # serialised wgmma among them)
        for line in info["log"].splitlines():
            if any(w in line for w in ("registers", "Compiling", "spill",
                                       "Function properties", "arning")):
                say(f"    {line.strip()}")
    return out


def flash_build(future) -> dict:
    """Wait for ``start_flash_build``'s builds and print them; returns
    ptxas's lines for each instantiation of the backward's Hopper kernel,
    by its D bucket ("bwd"), and of the forward's, by its (DQK, DV)
    buckets ("fwd")."""
    out = future.result()
    report_build(out, max(info["seconds"] for info in out.values()))
    return {"bwd": hopper_bwd_report(out["flash_attention_bwd"]["log"]),
            "fwd": hopper_fwd_report(out["flash_attention"]["log"])}


def hopper_bwd_report(log: str) -> dict:
    """ptxas's stack-and-spill and register lines for each instantiation
    of the backward's Hopper kernel in a build log, by its D bucket."""
    lines = log.splitlines()
    report = {}
    for i, line in enumerate(lines):
        if "Function properties" in line and "bwd_bf16_wgmma_kernel" in line:
            bucket = "128" if "ILi128E" in line else "64"
            report[bucket] = [x.strip() for x in lines[i + 1:i + 3]]
    return report


def hopper_fwd_report(log: str) -> dict:
    """ptxas's stack-and-spill and register lines for each instantiation
    of the forward's Hopper kernel in a build log, by "DQK/DV"."""
    lines = log.splitlines()
    report = {}
    for i, line in enumerate(lines):
        got = re.search(r"flash_bf16_wgmma_kernelILi(\d+)ELi(\d+)E", line)
        if got and "Function properties" in line:
            report[f"{got[1]}/{got[2]}"] = [x.strip()
                                            for x in lines[i + 1:i + 3]]
    return report


def no_spill(report: dict) -> bool:
    """Every instantiation's stack line reads 0 bytes spilled both ways."""
    return bool(report) and all(
        "0 bytes spill stores, 0 bytes spill loads" in lines[0]
        for lines in report.values())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_scored_reduce(U: int, N: int, dtype, timed: bool) -> dict:
    from repro_torch.kernels import scored_reduce as sr
    gen = torch.Generator(device="cuda").manual_seed(U * 7919 + N)
    d = torch.randn((U, N), generator=gen, device="cuda").to(dtype)
    mean = d.float().mean(0)
    dots, norms, msq = sr.scored_reduce(d, mean)
    pd, pn, pm = sr.scored_reduce_plain(d, mean)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    scale = torch.sqrt(pn * pm)
    err = {"dots": float((dots - pd).abs().max()),
           "norms": float((norms - pn).abs().max()),
           "mean_sq": float((msq - pm).abs())}
    ok = (bool(((dots - pd).abs() <= tol * scale).all())
          and bool(((norms - pn).abs() <= tol * pn.abs()).all())
          and bool((msq - pm).abs() <= tol * pm.abs()))
    again = sr.scored_reduce(d, mean)
    same = all(torch.equal(a, b) for a, b in zip((dots, norms, msq), again))
    row = {"U": U, "N": N, "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": tol, "ok": ok, "bitwise_repeat": same}
    if timed:
        row["ms"] = time_ms(lambda: sr.scored_reduce(d, mean), 30)
        row["plain_ms"] = time_ms(
            lambda: sr.scored_reduce_plain(d, mean), 10)
        df = d.float() if dtype != torch.float32 else d
        row["library_ms"] = time_ms(
            lambda: (torch.mv(df, mean),
                     torch.linalg.vector_norm(df, dim=1) ** 2,
                     torch.dot(mean, mean)), 10)
        t_bytes = sr.bound_bytes(d) / HBM_BYTES_PER_S * 1e3
        t_ops = sr.bound_flops(d) / F32_FLOPS_PER_S * 1e3
        row["bound_ms"] = max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["gb_per_s"] = sr.bound_bytes(d) / row["ms"] / 1e6
    say("scored_reduce " + json.dumps(row))
    if not (ok and same):
        raise AssertionError(f"scored_reduce disagrees with its plain "
                             f"version or is not repeatable: {row}")
    return row


def buffer_n(model: str) -> int:
    """N of a model's (U, N) contribution buffer: its codec's length."""
    from repro_torch.core.flatten import make_codec
    from repro_torch.models.small import init_small
    return make_codec(init_small(0, model, "cpu")).n


def kernels_phase() -> dict:
    n = {model: buffer_n(model) for model in SCORED_MODELS}
    rows = [check_scored_reduce(MAIN_U, n["fcn"], torch.float32, timed=True)]
    torch.cuda.empty_cache()
    rows.append(check_scored_reduce(MAIN_U, n["fcn"], torch.bfloat16,
                                    timed=True))
    torch.cuda.empty_cache()
    # the grid's other OSAFL paths: f32 timed, bf16 checked
    grid = {}
    for model in SCORED_MODELS[1:]:
        grid[model] = check_scored_reduce(MAIN_U, n[model], torch.float32,
                                          timed=True)
        rows.append(grid[model])
        rows.append(check_scored_reduce(MAIN_U, n[model], torch.bfloat16,
                                        timed=False))
        torch.cuda.empty_cache()
    # the FCN's cluster blocks (U/K rows of the main path's buffer) and
    # tier-2 aggregates (K rows) of phase 6g, f32 timed
    blocks = {}
    for U in (MAIN_U // CLUSTERS, CLUSTERS):
        blocks[U] = check_scored_reduce(U, n["fcn"], torch.float32,
                                        timed=True)
        rows.append(blocks[U])
        torch.cuda.empty_cache()
    for U, N in ((16, 18_404), (1, 17), (3, 131), (17, 4_099)):
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(check_scored_reduce(U, N, dtype, timed=False))
    return {"main": rows[0], "grid": grid, "blocks": blocks, "rows": rows}


def check_flash(shape, dtype, causal: bool, timed: bool,
                model_layout: bool = False, dv: int | None = None) -> dict:
    """The kernel against its plain version on one draw, v of head dim
    ``dv`` (D if not given). With ``model_layout`` the inputs are (B, S,
    H, D) tensors that go through ``ops.flash_attention`` as the model
    calls it (strided (B, H, S, D) views, no copies); the plain version and
    the library call take the same views."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, H, Hkv, S, D = shape
    Dv = D if dv is None else dv
    gen = torch.Generator(device="cuda").manual_seed(S * 131 + H * 7 + D)
    if model_layout:
        qm = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dtype)
        km = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
        vm = torch.randn((B, S, Hkv, Dv), generator=gen,
                         device="cuda").to(dtype)
        q, k, v = (x.transpose(1, 2) for x in (qm, km, vm))

        def kernel():
            return ops.flash_attention(qm, km, vm, causal=causal).transpose(1, 2)
    else:
        q = torch.randn((B, H, S, D), generator=gen, device="cuda").to(dtype)
        k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").to(dtype)
        v = torch.randn((B, Hkv, S, Dv), generator=gen,
                        device="cuda").to(dtype)

        def kernel():
            return fa.flash_attention_bhsd(q, k, v, causal=causal)
    out = kernel()
    plain = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    err = float((out.float() - plain.float()).abs().max())
    ok = torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
    same = torch.equal(out, kernel())
    del plain
    row = {"shape": list(shape), "dv": Dv,
           "dtype": str(dtype).replace("torch.", ""),
           "causal": causal, "layout": "BSHD views" if model_layout
           else "BHSD", "max_abs_err": err, "tol": tol, "ok": ok,
           "bitwise_repeat": same}
    if timed:
        flops = fa.bound_flops(q, k, v, causal=causal)
        nbytes = fa.bound_bytes(q, k, v)
        row["ms"] = time_ms(kernel, 20)
        row["plain_ms"] = time_ms(
            lambda: fa.flash_attention_plain(q, k, v, causal=causal), 2,
            warmup=1)
        row["library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=D ** -0.5,
                enable_gqa=H != Hkv), 5)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflop_per_s"] = flops / row["ms"] / 1e9
    say("flash_attention " + json.dumps(row))
    if not (ok and same):
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version or is not repeatable: {row}")
    return row


def flash_phase(ptxas_fwd: dict) -> dict:
    say("flash ptxas " + json.dumps(ptxas_fwd))
    if sorted(ptxas_fwd) != ["128/128", "192/128", "256/128", "64/64"]:
        raise AssertionError(f"the build's report lacks an instantiation of "
                             f"the Hopper flash kernel: {sorted(ptxas_fwd)}")
    if not no_spill(ptxas_fwd):
        raise AssertionError(f"ptxas spilled in the Hopper flash kernel "
                             f"(which then serialises its wgmma): "
                             f"{ptxas_fwd}")
    main = check_flash(FLASH_MAIN, torch.bfloat16, causal=True, timed=True)
    torch.cuda.empty_cache()
    main["model_layout"] = check_flash(FLASH_MAIN, torch.bfloat16,
                                       causal=True, timed=True,
                                       model_layout=True)
    torch.cuda.empty_cache()
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                check_flash(shape, dtype, causal, timed=False)
    for *shape, dv in FLASH_DV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                check_flash(tuple(shape), dtype, causal, timed=False, dv=dv)
    # the plain versions at the 4096-token shapes of FLASH_SHAPES leave
    # segments of several GB in the allocator's pool: release them before
    # later phases place long-lived tensors in them (with one of those
    # pinned, phase 7b's f32 gate ran out of device memory)
    torch.cuda.empty_cache()
    main["ptxas"] = ptxas_fwd
    return main


def _close_tokens(a_logits, b_logits, tol: float) -> bool:
    """Greedy tokens agree wherever b's top-2 gap exceeds ``tol``."""
    top2 = torch.topk(b_logits.float(), 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > tol
    same = torch.argmax(a_logits, -1) == torch.argmax(b_logits, -1)
    return bool((same | ~clear).all())


def small_transformer_phase() -> None:
    """Reduced deepseek-coder-33b with its 7:1 head groups (14 over 2,
    d_model 448), the same imported weights on the card and on the CPU:
    ``make_prefill_step`` on a prompt, then 8 decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("deepseek-coder-33b").reduced(),
                              n_heads=14, n_kv_heads=2, d_model=448)
    host = T.init_model(torch.Generator().manual_seed(5), cfg)
    tree = tree_map(lambda t: t.numpy(), host)
    B, S, steps = 2, 24, 8
    prompt = torch.randint(0, cfg.vocab_size, (B, S + steps),
                           generator=torch.Generator().manual_seed(6))
    res = {}
    for dev in ("cuda", "cpu"):
        params = T.params_from_numpy(tree, cfg, device=dev)
        tok = prompt.to(dev)
        with torch.inference_mode():
            logits, _ = T.forward(params, {"tokens": tok[:, :S]}, cfg)
            nxt = make_prefill_step(cfg)(params, {"tokens": tok[:, :S]})
            # the prompt into the cache, then 8 steps (teacher-forced, so
            # both devices see the same tokens)
            cache = T.init_cache(cfg, B, S + steps, device=dev)
            dec = []
            for i in range(S + steps):
                dl, cache = T.decode_step(params, cache, tok[:, i:i + 1], i,
                                          cfg)
                if i >= S:
                    dec.append(dl[:, -1].float().cpu())
        res[dev] = (logits.float().cpu(), nxt.cpu(), torch.stack(dec, 1))
    (gl, gn, gd), (cl, cn, cd) = res["cuda"], res["cpu"]
    err = {"prefill_logits": float((gl - cl).abs().max()),
           "decode_logits": float((gd - cd).abs().max())}
    ok = (torch.allclose(gl, cl, atol=LOGIT_TOL, rtol=LOGIT_TOL)
          and torch.allclose(gd, cd, atol=LOGIT_TOL, rtol=LOGIT_TOL)
          and _close_tokens(gl[:, -1], cl[:, -1], LOGIT_TOL)
          and _close_tokens(gd, cd, LOGIT_TOL)
          and bool(torch.isfinite(gl).all() and torch.isfinite(gd).all()))
    say(f"small transformer (reduced deepseek-coder-33b, 14/2 heads, "
        f"d_model 448, bf16): cuda vs cpu max abs err {json.dumps(err)} "
        f"(tol {LOGIT_TOL}); prefill next tokens {gn.tolist()} / "
        f"{cn.tolist()}")
    if not ok:
        raise AssertionError("the transformer on the card drifted from the "
                             f"CPU run: {err}")


def scored_launches(alg: str, xc, rows: int = 1) -> int:
    """``scored_reduce`` launches a round should make: one in the stacked
    OSAFL round, K + 1 in its K > 1 cluster tier (one per block and one for
    the (K, N) aggregates), none with sketched scores, in the loop oracle
    (whose scores are the independent implementation the kernel is held
    against), a baseline or the genie. Over ``rows`` client rows, each
    rank's: one, or K/rows + 1 (its blocks, and the aggregates)."""
    if alg != "osafl" or xc.engine == "loop" or xc.score_sketch_dim:
        return 0
    return xc.num_clusters // rows + 1 if xc.num_clusters > 1 else 1


def small_key(kw: dict) -> str:
    """The knobs of phases 6g, 6h and 6i that a run sets, as a short
    label."""
    return " ".join(f"{k}={kw[k]}" for k in (
        "cohort_size", "participation", "num_clusters", "scenario",
        "score_sketch_dim", "round_backend", "resource_backend",
        "rounds_per_dispatch", "pod_engine", "request_backend") if kw.get(k))


def small_run_phase(runs=SMALL_RUNS) -> dict:
    """Each small run on the card and on the CPU with the same seed (native
    weights drawn on the host, so both start from the same numbers):
    participants exact, ``test_loss`` within rtol 1e-4, ``scored_reduce``
    launched as ``scored_launches`` says. Returns the loop runs' launches
    and those of the stacked-request runs."""
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.kernels import scored_reduce as sr
    loop_launches = {}
    for alg, kw in runs:
        xc = ExperimentConfig(**kw)
        sr.scored_reduce.launches = 0
        gpu = run(alg, xc, eval_samples=64)
        launches = sr.scored_reduce.launches
        if launches != xc.rounds * scored_launches(alg, xc):
            raise AssertionError(f"small run {alg} {kw}: scored_reduce "
                                 f"launched {launches} times")
        if (xc.engine == "loop" or xc.request_backend == "stacked"
                or runs is not SMALL_RUNS):
            loop_launches[" ".join(filter(None, (
                alg, kw["model"], small_key(kw))))] = launches
        cpu = run(alg, xc, eval_samples=64, device="cpu")
        for g, c in zip(gpu, cpu):
            say(f"small run {alg} {kw['model']} {xc.engine} "
                f"{xc.request_backend} requests {small_key(kw)} round "
                f"{g['round']}: cuda "
                f"loss {g['test_loss']:.6f} cpu loss {c['test_loss']:.6f} "
                f"rel {abs(g['test_loss'] / c['test_loss'] - 1):.2e} "
                f"participants {g.get('participants')}/"
                f"{c.get('participants')}")
            if (g.get("participants") != c.get("participants")
                    or abs(g["test_loss"] - c["test_loss"])
                    > 1e-4 * abs(c["test_loss"])):
                raise AssertionError("the run on the card drifted from the "
                                     f"CPU run: {alg} {kw}: {g} vs {c}")
        if len(gpu) != len(cpu) or len(gpu) != xc.rounds:
            raise AssertionError(f"{alg} {kw}: {len(gpu)} rounds on the "
                                 f"card, {len(cpu)} on the CPU")
    return loop_launches


def conv_grads(model: str, device: str) -> tuple:
    """Gradient (flat, float64 on the host) and loss of ``model``'s seeded
    weights on the eval batch of the CNN's and SqueezeNet's small run."""
    from repro_torch.harness import ExperimentConfig
    from repro_torch.harness.experiments import _stacked_setup
    from repro_torch.models.small import init_small, small_loss
    kw = next(kw for alg, kw in SMALL_RUNS if kw["model"] == model)
    xc = ExperimentConfig(**kw)
    batch = _stacked_setup("osafl", xc, 64, torch.device(device)).test_batch
    grads, loss = torch.func.grad_and_value(
        lambda p: small_loss(p, batch, model)[0])(
            init_small(xc.seed, model, device))
    leaves = torch.utils._pytree.tree_leaves(grads)
    return (torch.cat([g.reshape(-1).double().cpu() for g in leaves]),
            float(loss))


def conv_precision_phase() -> None:
    """The CNN's and SqueezeNet's gradients on the card against the CPU's:
    within GRAD_TOL (relative L2) with convolutions in full f32, as a run
    holds them (``full_f32_convolutions``, entered with the caller's TF32
    on), and past it with cuDNN's TF32 on, which shows the check sees it."""
    from repro_torch.device import full_f32_convolutions
    before = torch.backends.cudnn.allow_tf32
    try:
        for model in ("cnn", "squeezenet"):
            cpu, cpu_loss = conv_grads(model, "cpu")
            torch.backends.cudnn.allow_tf32 = True
            with full_f32_convolutions():
                f32, f32_loss = conv_grads(model, "cuda")
            tf32, tf32_loss = conv_grads(model, "cuda")
            row = {"model": model, "grad_tol": GRAD_TOL}
            for name, g, loss in (("f32", f32, f32_loss),
                                  ("tf32", tf32, tf32_loss)):
                row[name] = {"grad_rel_l2": float((g - cpu).norm()
                                                  / cpu.norm()),
                             "loss_rel": abs(loss / cpu_loss - 1)}
            say("convolution precision " + json.dumps(row))
            if not row["f32"]["grad_rel_l2"] <= GRAD_TOL:
                raise AssertionError(f"{model}: full-f32 gradients on the "
                                     f"card drifted from the CPU's: {row}")
            if not row["tf32"]["grad_rel_l2"] > GRAD_TOL:
                raise AssertionError(f"{model}: the gradient check cannot "
                                     f"see TF32: {row}")
    finally:
        torch.backends.cudnn.allow_tf32 = before


def fl_run(label: str, alg: str, kw: dict, eval_samples: int,
           start_round: int = 0, **run_kw) -> dict:
    """One ``repro_torch.harness.run`` on the card (``run_kw``: its
    checkpoint arguments) with the launch counts reset just before and read
    just after; prints its rounds, wall time, peak memory and launches as
    one JSON line. Gates: ``scored_reduce`` launched as ``scored_launches``
    says (once a round of stacked OSAFL, for the rounds run after
    ``start_round``) and nothing launches flash attention; finite losses for
    every round; some participants (but in the genie, which has none)."""
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    xc = ExperimentConfig(**kw)
    t0 = time.perf_counter()
    sr.scored_reduce.launches = 0
    fa.flash_attention_bhsd.launches = 0
    hist = run(alg, xc, eval_samples=eval_samples, **run_kw)
    launches = {"scored_reduce": sr.scored_reduce.launches,
                "flash_attention": fa.flash_attention_bhsd.launches}
    wall = time.perf_counter() - t0
    row = {"alg": alg, "config": kw, "eval_samples": eval_samples,
           "wall_s": wall, "launches": launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "rounds": [{k: h.get(k) for k in (
               "round", "test_loss", "test_acc", "participants",
               "round_s", "request_gen_s")} for h in hist]}
    say(f"{label} " + json.dumps(row))
    want = (xc.rounds - start_round) * scored_launches(alg, xc)
    if launches != {"scored_reduce": want, "flash_attention": 0}:
        raise AssertionError(f"{label} {alg} {kw['model']}: launches "
                             f"{launches}, expected scored_reduce {want}")
    if len(hist) != xc.rounds or not all(
            math.isfinite(h["test_loss"]) for h in hist):
        raise AssertionError(f"{label} {alg} {kw['model']}: non-finite or "
                             f"missing rounds: {hist}")
    if alg != "centralized" and not any(h["participants"] for h in hist):
        raise AssertionError(f"{label} {alg} {kw['model']}: no round had "
                             "participants")
    return row


def list_api_phase() -> dict:
    """One round of real ``ClientUpdate``s at full width (``LOOP_RUN``: the
    FCN, U=256): each client's arrivals, the scalar resource solve and
    ``local_train`` on the card, drawn as the loop engine's first round
    draws them; then the same list through each loop server and through
    its stacked counterpart's ``round(updates)``, both from the same
    weights. Gates: weights within LIST_TOL, OSAFL's scores within
    LIST_TOL, ``scored_reduce`` launched once by the stacked OSAFL round
    and by no other, flash attention by none. Prints each server round's
    synchronized time; returns each round's launches."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.baselines import make_server
    from repro_torch.core.client import local_train
    from repro_torch.core.flatten import tree_get, tree_paths
    from repro_torch.core.osafl import ClientUpdate
    from repro_torch.core.resource import (NetworkConfig, make_clients,
                                           optimize_round)
    from repro_torch.harness import MODEL_PARAMS, ExperimentConfig
    from repro_torch.harness.experiments import _arrive, _client_setup
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.models.small import init_small, small_loss
    dev = torch.device("cuda")
    xc = ExperimentConfig(**LOOP_RUN)
    U = xc.num_clients
    streams, rng, bufs, _ = _client_setup(xc, MAIN_EVAL, dev)
    w0 = init_small(xc.seed, xc.model, dev)
    clients = make_clients(rng, U, cell_radius_m=xc.cell_radius_m)
    grad_fn = torch.func.grad(lambda p, b: small_loss(p, b, xc.model)[0])
    t0 = _clock()
    decisions = optimize_round(rng, NetworkConfig(), clients,
                               MODEL_PARAMS[xc.model])
    solve_s = _clock() - t0
    ups = {"d": [], "w": []}
    for c in range(U):
        _arrive(rng, streams, bufs, xc, c)
        kappa = decisions[c].kappa
        if kappa < 1:
            continue                          # straggler
        d, w = local_train(w0, grad_fn, bufs[c], kappa, xc.local_lr,
                           xc.batch, rng)
        for key, tree in (("d", d), ("w", w)):
            ups[key].append(ClientUpdate(
                c, tree, kappa, data_size=bufs[c].size,
                label_hist=bufs[c].label_histogram()))
    train_s = _clock() - solve_s - t0
    out = {"config": LOOP_RUN, "updates": len(ups["d"]),
           "resource_solve_s": solve_s, "arrivals_local_train_s": train_s,
           "rounds": []}
    for alg in ALGS[:-1]:
        fl = FLConfig(num_clients=U, local_lr=xc.local_lr,
                      global_lr=(xc.global_lr if alg in ("osafl", "afa_cd")
                                 else 1.0), algorithm=alg)
        upd = ups["d" if alg in ("osafl", "fednova", "afa_cd") else "w"]
        row, got = {"alg": alg}, {}
        for engine in ("loop", "stacked"):
            srv = make_server(w0, dataclasses.replace(fl, engine=engine), U,
                              device=dev)
            sr.scored_reduce.launches = 0
            fa.flash_attention_bhsd.launches = 0
            t0 = _clock()
            params = srv.round(upd)
            row[f"{engine}_s"] = _clock() - t0
            row[f"{engine}_launches"] = {
                "scored_reduce": sr.scored_reduce.launches,
                "flash_attention": fa.flash_attention_bhsd.launches}
            got[engine] = (params, getattr(srv, "last_scores", None))
            del srv, params
            torch.cuda.empty_cache()
        (lp, ls), (sp, ss) = got["loop"], got["stacked"]
        row["max_abs_err"] = max(
            float((tree_get(lp, p) - tree_get(sp, p)).abs().max())
            for p in tree_paths(lp))
        if alg == "osafl":
            row["scores_max_abs_err"] = float(abs(ls - ss).max())
        del got, lp, sp
        say("list api " + json.dumps(row))
        want = 1 if alg == "osafl" else 0
        none = {"scored_reduce": 0, "flash_attention": 0}
        if (row["loop_launches"] != none or row["stacked_launches"]
                != dict(none, scored_reduce=want)):
            raise AssertionError(f"list api {alg}: launches {row}")
        if not (row["max_abs_err"] <= LIST_TOL
                and row.get("scores_max_abs_err", 0.0) <= LIST_TOL):
            raise AssertionError(f"list api {alg}: the stacked round "
                                 f"drifted from the loop server's: {row}")
        out["rounds"].append(row)
    say("list api setup " + json.dumps({k: v for k, v in out.items()
                                        if k != "rounds"}))
    if not 0 < out["updates"] < U:
        raise AssertionError(f"list api: {out['updates']} updates of {U} "
                             "clients, expected some and some stragglers")
    return out


def breakdown_phase(run_kw: dict, rounds: int = 2) -> None:
    """Where an OSAFL round's time goes: the stages of the harness's
    round (``repro_torch.harness.experiments._run_stacked``) in its order,
    each ended by a synchronize so that stages cannot overlap, plus the
    resource solve on the CPU for comparison; convolutions in full f32 and
    deterministic, as in a run. A sparse-cohort run adds the participation
    sample with its admissions and ``reset_rows`` before the requests, and
    splits the server round into the inner (slot-width) round and the
    per-user tables' write-back. A separate run after the main path; its
    launches are not counted."""
    import numpy as np
    from repro_torch.core.client import make_vmapped_local_train
    from repro_torch.core.cohort import sample_participants
    from repro_torch.core.hierarchy import sample_participants_clustered
    from repro_torch.core.resource_stacked import optimize_round_batched
    from repro_torch.data.online import (binomial_arrivals_batched,
                                         draw_arrival_batch)
    from repro_torch.harness import ExperimentConfig
    from repro_torch.harness.experiments import (_admitted, _gather_sys,
                                                 _stacked_setup)
    from repro_torch.device import (deterministic_convolutions,
                                    full_f32_convolutions)
    from repro_torch.models.small import small_loss
    dev = torch.device("cuda")
    xc = ExperimentConfig(**run_kw)
    s = _stacked_setup("osafl", xc, MAIN_EVAL, dev)
    if s.scn is not None:
        raise ValueError("breakdown_phase runs without a scenario")
    step = make_vmapped_local_train(s.grad_fn, s.fl.local_lr,
                                    s.fl.kappa_max)

    def lap() -> float:
        torch.cuda.synchronize()
        return time.perf_counter()

    with full_f32_convolutions(), deterministic_convolutions():
        for t in range(rounds):
            marks = [("start", lap())]
            cohort, sel, p_ac = None, None, s.p_ac
            if s.sparse:
                if s.resample:
                    if s.K >= 1:
                        sel = sample_participants_clustered(
                            s.rng, s.server.assign, s.K, s.m_active,
                            s.C // s.K)
                    else:
                        sel = sample_participants(s.rng, s.U, s.m_active)
                    _admitted(s, sel, s.server.admit(sel))
                    marks.append(("admissions_reset_rows", lap()))
                cohort = s.server.cohort
                p_ac = s.p_ac[cohort]
            counts = binomial_arrivals_batched(s.rng, xc.arrivals, p_ac)
            if s.stacked_req:
                if s.sparse:
                    full = np.zeros(s.U, counts.dtype)
                    full[cohort] = counts
                    xs, ys, cnt = s.rstream.draw(full, xc.dataset,
                                                 s.arr_width)
                    rows = torch.as_tensor(cohort, device=dev)
                    arrivals = (xs[rows], ys[rows], cnt[cohort])
                else:
                    arrivals = s.rstream.draw(counts, xc.dataset,
                                              s.arr_width)
            else:
                arrivals = draw_arrival_batch(s.streams, counts, xc.dataset,
                                              width=s.arr_width)
            marks.append(("requests", lap()))
            s.sbuf.stage(*arrivals)
            s.sbuf.commit()
            marks.append(("fifo_commit", lap()))
            sysb = _gather_sys(s.sysb, cohort) if s.sparse else s.sysb
            kappas = optimize_round_batched(
                s.rng, s.net, sysb, s.n_params,
                backend=xc.resource_backend, device=dev).kappa
            marks.append(("resource_solve", lap()))
            active = kappas >= 1
            if sel is not None:
                sel_mask = np.zeros(s.C, bool)
                sel_mask[s.server.pool.user_slot[sel]] = True
                active = active & sel_mask & (s.sbuf.sizes > 0)
            slots = s.sbuf.sample_slots(s.rng, (s.fl.kappa_max, xc.batch))
            batch = s.sbuf.gather(slots)
            marks.append(("slots_gather", lap()))
            d, _ = step(s.server.params, batch,
                        torch.as_tensor(kappas, device=dev))
            upd = s.codec.flatten_stacked(d)
            del d, batch
            marks.append(("local_sgd", lap()))
            if s.sparse:
                s.server.inner.round_stacked(upd, active)
                marks.append(("server_round", lap()))
                s.server._write_back()
                marks.append(("tables_write_back", lap()))
            else:
                s.server.round_stacked(upd, active)
                marks.append(("server_round", lap()))
            del upd
            float(small_loss(s.server.params, s.test_batch, s.model)[0])
            marks.append(("eval", lap()))
            stages = {name: marks[i + 1][1] - marks[i][1]
                      for i, (name, _) in enumerate(marks[1:])}
            stages["total"] = marks[-1][1] - marks[0][1]
            t0 = time.perf_counter()
            optimize_round_batched(np.random.default_rng(t), s.net, sysb,
                                   s.n_params, device="cpu")
            stages["resource_solve_on_cpu"] = time.perf_counter() - t0
            say(f"breakdown {xc.model} {xc.request_backend} requests "
                f"{small_key(run_kw)} round {t} (s): {json.dumps(stages)}")


def grid_phase(main: dict) -> list:
    """The paper's comparison grid at full width: the FL main path's run
    (``main``, OSAFL on the FCN) and ``GRID_RUNS``, each through
    ``fl_run``."""
    return [main] + [fl_run("grid run", alg, kw, GRID_EVAL)
                     for alg, kw in GRID_RUNS]


def determinism_phase(grid: list) -> list:
    """The grid's CNN and SqueezeNet runs again with the same seed: their
    ``test_loss``, ``test_acc`` and ``participants`` must repeat bit for
    bit. Around the rerun, the same run with cuDNN free to pick
    nondeterministic algorithms (the harness's
    ``deterministic_convolutions`` bypassed), so held and free runs
    alternate: the free runs' ``round_s`` beside the held runs' is what
    the hold costs; they are printed, not gated. Returns the reruns' and
    the free runs' rows."""
    import contextlib

    import repro_torch.harness.experiments as tex
    keys = ("test_loss", "test_acc", "participants")

    def free(first: dict) -> dict:
        held = tex.deterministic_convolutions
        tex.deterministic_convolutions = contextlib.nullcontext
        try:
            return fl_run("determinism control (cuDNN free)", first["alg"],
                          first["config"], GRID_EVAL)
        finally:
            tex.deterministic_convolutions = held

    rows = []
    for first in grid:
        if first["config"]["model"] not in ("cnn", "squeezenet"):
            continue
        before = free(first)
        again = fl_run("determinism rerun", first["alg"], first["config"],
                       GRID_EVAL)
        after = free(first)
        same = ([[r[k] for k in keys] for r in first["rounds"]]
                == [[r[k] for k in keys] for r in again["rounds"]])
        say("determinism " + json.dumps({
            "model": first["config"]["model"], "bit_identical": same,
            "round_s": {name: [r["round_s"] for r in x["rounds"]]
                        for name, x in (("held", first), ("free", before),
                                        ("held_again", again),
                                        ("free_again", after))}}))
        if not same:
            raise AssertionError(f"{first['config']['model']}: the same "
                                 "seed gave another history on the card")
        rows += [before, again, after]
    return rows


def requests_phase(main: dict) -> dict:
    """The main path's configuration with the stacked request model and
    with the python streams, in turns (the main path's own run is the first
    python one): one summary line of each backend's ``request_gen_s``,
    ``round_s`` and peak memory. Then the two paper presets as configured,
    each through ``fl_run``."""
    stacked = dict(MAIN_RUN, request_backend="stacked")
    runs = {"python": [main], "stacked": []}
    for backend, kw in (("stacked", stacked), ("python", MAIN_RUN),
                        ("stacked", stacked)):
        runs[backend].append(fl_run(f"requests {backend}", "osafl", kw,
                                    MAIN_EVAL))
    say("requests " + json.dumps({
        backend: {k: [[r[k] for r in row["rounds"]] for row in rows]
                  for k in ("request_gen_s", "round_s")}
        | {"max_memory_allocated": [row["max_memory_allocated"]
                                    for row in rows]}
        for backend, rows in runs.items()}))
    presets = [fl_run(f"paper preset {name}", "osafl", kw, MAIN_EVAL)
               for name, kw in PRESET_RUNS]
    return {"runs": runs["stacked"] + runs["python"][1:],
            "presets": presets}


def f32_solve_phase() -> dict:
    """One U=256 batch (the main path's system draw and one round of
    channels) through the x64 and the f32 solve on the card, each timed
    (synchronized, after a warm-up) and the f32 one held to DESIGN.md's
    tolerance against x64; then the main path with the f32 solve."""
    import numpy as np
    from repro_torch.core import resource as tres
    from repro_torch.core import resource_stacked as trs
    from repro_torch.harness import MODEL_PARAMS
    net = tres.NetworkConfig()
    rng = np.random.default_rng(0)
    sysb = trs.stack_clients(tres.make_clients(
        rng, MAIN_U, cell_radius_m=600.0))
    chb = trs.sample_channels(rng, sysb)
    n_params = MODEL_PARAMS["fcn"]
    dec, secs = {}, {}
    for backend in ("x64", "f32"):
        trs.optimize_clients_batched(net, sysb, chb, n_params,
                                     backend=backend, device="cuda")
        times = []
        for _ in range(5):
            t0 = _clock()
            dec[backend] = trs.optimize_clients_batched(
                net, sysb, chb, n_params, backend=backend, device="cuda")
            times.append(_clock() - t0)
        secs[backend] = times
    dx, df = dec["x64"], dec["f32"]
    flips = df.kappa != dx.kappa
    m = dx.feasible & ~flips
    med = {k: float(np.median(np.abs(getattr(df, k)[m] - getattr(dx, k)[m])
                              / np.abs(getattr(dx, k)[m])))
           for k in ("f", "p", "e_total")}
    row = {"U": MAIN_U, "n_params": n_params, "seconds": secs,
           "feasible": int(dx.feasible.sum()),
           "feasibility_equal": bool(np.array_equal(df.feasible,
                                                    dx.feasible)),
           "kappa_flips": float(flips.mean()), "median_rel": med,
           "tol": {"flips": F32_FLIPS, "median_rel": F32_MEDIAN_REL}}
    say("f32 solve " + json.dumps(row))
    if not (row["feasibility_equal"] and row["kappa_flips"] <= F32_FLIPS
            and max(med.values()) <= F32_MEDIAN_REL):
        raise AssertionError(f"the f32 solve misses DESIGN.md's contract "
                             f"on the card: {row}")
    row["fl"] = fl_run("f32 solve main path", "osafl",
                       dict(MAIN_RUN, resource_backend="f32"), MAIN_EVAL)
    return row


def _host_memory_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    return 0


def checkpoint_phase() -> dict:
    """Checkpoint and resume at full width (``CKPT_RUN``): run A takes 4
    rounds with a snapshot every 2 through the async v2 writer with
    ``keep_last=1`` (round 2 claimed, as a server reading it would, so
    retention keeps it beside round 4); run A's round 4 is loaded and its
    directory removed; run B resumes from round 2 and writes its round 4.
    Gates: rounds 2-3 of both runs and the two round-4 snapshots (weights,
    contribution buffer, FIFO state, scores, RNG and stream state) equal
    bit for bit; retention left A's claimed round 2 and round 4. Prints
    the snapshot bytes, the seconds ``submit`` held the round loop, the
    writer's and the loads' seconds, free disk and host memory before."""
    import shutil
    import tempfile

    import repro_torch.harness.experiments as tex
    from repro_torch import checkpoint
    from repro_torch.harness import MODEL_PARAMS, checkpoint_path
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    writers, loads = [], []
    make_writer, load = tex._make_ckpt_writer, checkpoint.load_run_state

    def recording_writer(*args):
        writers.append(make_writer(*args))
        return writers[-1]

    def timed_load(path, **kw):
        t0 = time.perf_counter()
        out = load(path, **kw)
        loads.append({"path": str(path),
                      "seconds": time.perf_counter() - t0})
        return out
    try:
        free_disk = shutil.disk_usage(root).free
        free_mem = _host_memory_available()
        kw = dict(CKPT_RUN)
        n = buffer_n(kw["model"])
        est = kw["num_clients"] * 4 * (n + (kw["capacity"][1] - 1)
                                       * 3168 + kw["arrivals"] * 3168)
        if free_disk < 2.2 * est or free_mem < 3 * est:
            kw["capacity"] = (80, 160)      # Table II's capacities
        say("checkpoint setup " + json.dumps({
            "dir_free_disk_bytes": free_disk,
            "host_mem_available_bytes": free_mem,
            "full_width_snapshot_estimate_bytes": est,
            "capacity": kw["capacity"], "n_params": MODEL_PARAMS["fcn"]}))
        tex._make_ckpt_writer = recording_writer
        checkpoint.load_run_state = timed_load
        da, db = root / "a", root / "b"
        checkpoint.write_claim(da, "chip_smoke", [checkpoint_path(da, 2)])
        a = fl_run("checkpoint run A", "osafl", kw, MAIN_EVAL,
                   save_every_k=CKPT_EVERY, checkpoint_dir=da, keep_last=1)
        kept = [p.name for p in checkpoint.committed_snapshots(da)]
        snap_a = timed_load(checkpoint_path(da, 4))
        checkpoint.delete_snapshot(checkpoint_path(da, 4))
        b = fl_run("checkpoint run B (resumed)", "osafl", kw, MAIN_EVAL,
                   start_round=2, save_every_k=CKPT_EVERY,
                   checkpoint_dir=db, keep_last=1,
                   resume_from=checkpoint_path(da, 2))
        snap_b = timed_load(checkpoint_path(db, 4))
        diffs = checkpoint.diff_snapshots(snap_a, snap_b)
        del snap_a, snap_b
        keys = ("round", "test_loss", "test_acc", "participants")
        same = ([[r[k] for k in keys] for r in a["rounds"][2:]]
                == [[r[k] for k in keys] for r in b["rounds"][2:]])
        row = {"capacity": kw["capacity"], "kept_after_run_a": kept,
               "rounds_2_3_bit_identical": same,
               "snapshot_diffs": diffs[:8],
               "writers": [{"stats": w.stats,
                            "peak_held_bytes": getattr(
                                w, "peak_held_bytes", None),
                            "queue_size": getattr(w, "queue_size", None)}
                           for w in writers],
               "loads": loads}
        say("checkpoint " + json.dumps(row))
        if not same or diffs or kept != ["round_00002", "round_00004"]:
            raise AssertionError("the resumed run did not repeat the "
                                 f"straight one: {row}")
        return {"runs": [a, b], **row}
    finally:
        tex._make_ckpt_writer = make_writer
        checkpoint.load_run_state = load
        shutil.rmtree(root, ignore_errors=True)


def resume_phase(label: str, kw: dict) -> dict:
    """A run's snapshots on the card (``kw``: 4 rounds): 4 rounds straight
    against 2 + save + resume + 2; histories and final snapshots bit for
    bit. The loop engine writes blocking v1 snapshots, the stacked engine
    async v2."""
    import shutil
    import tempfile

    from repro_torch import checkpoint
    from repro_torch.harness import checkpoint_path
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
    try:
        full = fl_run(f"{label} straight", "osafl", kw, 64,
                      save_every_k=4, checkpoint_dir=root / "a")
        half = dict(kw, rounds=2)
        fl_run(f"{label} first half", "osafl", half, 64,
               save_every_k=2, checkpoint_dir=root / "b")
        resumed = fl_run(f"{label} second half", "osafl", kw,
                         64, start_round=2, save_every_k=2,
                         checkpoint_dir=root / "b",
                         resume_from=checkpoint_path(root / "b", 2))
        keys = ("round", "test_loss", "test_acc", "participants")
        same = ([[r[k] for k in keys] for r in full["rounds"]]
                == [[r[k] for k in keys] for r in resumed["rounds"]])
        diffs = checkpoint.diff_snapshots(
            checkpoint.load_run_state(checkpoint_path(root / "a", 4)),
            checkpoint.load_run_state(checkpoint_path(root / "b", 4)))
        say(f"{label} " + json.dumps({"bit_identical": same,
                                      "snapshot_diffs": diffs[:8]}))
        if not same or diffs:
            raise AssertionError(f"{label}: the resumed run did not repeat "
                                 f"the straight one: {diffs}")
        return {"runs": [full, resumed]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def loop_resume_phase() -> dict:
    """The loop engine's blocking v1 snapshots on the card (``LOOP_RESUME``,
    the MLP at U=16)."""
    return resume_phase("loop resume", LOOP_RESUME)


def cohort_phase() -> dict:
    """Phase 6g: ``COHORT_RUNS`` at full width through ``fl_run`` (launch
    gate: ``scored_launches`` a round), one summary line of their
    ``round_s``, ``request_gen_s``, participants and peaks; breakdowns of
    the hierarchical, the sparse and the sketched round; ``COHORT_SMALL``
    card against CPU; the sparse hierarchical resume (``HIER_RESUME``) bit
    for bit."""
    runs = [(name, fl_run(f"cohort phase {name}", "osafl", kw,
                          FIG1_EVAL if name == "fig1" else MAIN_EVAL))
            for name, kw in COHORT_RUNS]
    say("cohort phase " + json.dumps({
        f"{name} {small_key(row['config'])}": {
            k: [r[k] for r in row["rounds"]]
            for k in ("round_s", "request_gen_s", "participants")}
        | {"max_memory_allocated": row["max_memory_allocated"],
           "scored_reduce": row["launches"]["scored_reduce"]}
        for name, row in runs}))
    for name in ("hier", "cohort", "sketch"):
        breakdown_phase(dict(COHORT_RUNS)[name])
    small = small_run_phase(COHORT_SMALL)
    resume = resume_phase("sparse hierarchical resume", HIER_RESUME)
    return {"runs": runs, "small": small, "resume": resume}


def _same_rounds(a: dict, b: dict, tol: float = 0.0, rounds=None) -> bool:
    """Rounds of two ``fl_run`` rows: participants equal and ``test_loss``/
    ``test_acc`` within ``tol`` (0: bit for bit)."""
    ra, rb = a["rounds"], b["rounds"]
    rounds = range(min(len(ra), len(rb))) if rounds is None else rounds
    return all(ra[t]["participants"] == rb[t]["participants"]
               and abs(ra[t]["test_loss"] - rb[t]["test_loss"]) <= tol
               and abs(ra[t]["test_acc"] - rb[t]["test_acc"]) <= tol
               for t in rounds)


def examples_phase() -> dict:
    """The three FL examples on the card: the quickstart's 15 rounds (the
    loss must fall), the resource solve of ``resource_optimization`` (host
    numpy) and ``EXAMPLE_STEPS`` steps of the ~100M example with its
    checkpoint written to a scratch directory (the loss must end below
    its start and dip below half of it; nothing launches flash attention,
    whose windowed variant does not exist).
    Prints each one's seconds, the 100M example's steady step time (steps
    1 on) and peak memory."""
    import shutil
    import tempfile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch import (quickstart, resource_optimization,
                                    train_fl_video_caching)
    sr.scored_reduce.launches = 0
    fa.flash_attention_bhsd.launches = 0
    fa.flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    rows = quickstart.run()
    quick_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = resource_optimization.run()
    solve_s = time.perf_counter() - t0
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_fl100m_"))
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        big = train_fl_video_caching.run(steps=EXAMPLE_STEPS,
                                         ckpt=root / "fl_100m.npz",
                                         verbose=False)
        big_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = sum(f.stat().st_size for f in root.iterdir())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {"scored_reduce": sr.scored_reduce.launches,
                "flash_attention": fa.flash_attention_bhsd.launches,
                "flash_attention_bwd": fa.flash_attention_bwd.launches}
    steps = [h["step_s"] for h in big["history"]]
    losses = [h["loss"] for h in big["history"]]
    row = {"quickstart": {"wall_s": quick_s,
                          "loss": [r["loss"] for r in rows],
                          "acc": [r["acc"] for r in rows],
                          "last_scores": rows[-1]["scores"].tolist()},
           "resource_optimization": {"wall_s": solve_s,
                                     "payloads": res["payloads"]},
           "fl_100m": {"wall_s": big_s, "param_count": big["param_count"],
                       "loss": losses, "step_s": steps,
                       "steady_step_s": [min(steps[1:]), max(steps[1:])],
                       "max_memory_allocated": peak,
                       "checkpoint_bytes": ckpt_bytes,
                       "wireless": big["wireless"], "lines": big["lines"]},
           "launches": launches}
    say("fl examples " + json.dumps(row, default=float))
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"quickstart: the loss did not fall: {row}")
    # the example's SGD (the reference's lr 0.05) learns the task within a
    # few steps, then climbs back, as the reference's step does at this
    # width: both the dip and the net fall are held
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] and min(losses) < 0.5 * losses[0]):
        raise AssertionError(f"the 100M example's loss did not fall: {row}")
    if any(launches.values()):
        raise AssertionError(f"the FL examples launched a kernel: {row}")
    return row


@contextlib.contextmanager
def _one_ulp_moved_weights():
    """The harness's seeded weights with a random half of their entries
    moved up by one ulp (``tests/test_torch_precision.py``'s perturbation)
    while the context is entered: a run's sensitivity to rounding."""
    import repro_torch.harness.experiments as tex
    from repro_torch.core.flatten import tree_map
    seeded = tex.init_small
    gen = torch.Generator().manual_seed(0)

    def init(seed, name, device):
        return tree_map(lambda w: torch.where(
            torch.rand(w.shape, generator=gen).to(w.device) < 0.5,
            torch.nextafter(w, torch.full_like(w, math.inf)), w),
            seeded(seed, name, device))
    tex.init_small = init
    try:
        yield
    finally:
        tex.init_small = seeded


def _loss_gaps(a: dict, b: dict) -> list:
    return [abs(x["test_loss"] - y["test_loss"])
            for x, y in zip(a["rounds"], b["rounds"])]


def pod_phase(main: dict, grid: list) -> dict:
    """Phase 6i: the main path's configuration on the pod engine
    (``fl_run``'s launch gate: ``scored_reduce`` once an OSAFL round, none
    for FedAvg), small pod runs card against CPU, a pod resume bit for bit
    and the FL examples. recompute's one-client products round unlike the
    vmapped ones (cuBLAS's per-client GEMM against its batched GEMM), and
    at the paper's ``global_lr=16`` three rounds amplify that past 1e-5
    as they amplify a one-ulp change of the initial weights, which the
    phase measures on the stacked run; so recompute is held to the stacked
    engine within 1e-5 at ``global_lr=1`` (the precision test's rate for
    models that amplify rounding), and at 16 its gap is printed beside the
    one-ulp gap. Returns the full-width runs (keyed "alg engine"), the
    small runs' launches, the resume and the examples."""
    from repro_torch.launch.mesh import make_host_mesh
    runs = {}
    for alg, engine in [("osafl", e) for e in POD_ENGINES] + [
            ("fedavg", "fedavg")]:
        kw = (dict(MAIN_RUN, rounds=POD_RECOMPUTE_ROUNDS)
              if engine == "recompute" else MAIN_RUN)
        runs[f"{alg} {engine}"] = fl_run(
            f"pod phase {alg} {engine}", alg, kw, MAIN_EVAL,
            mesh=make_host_mesh(), pod_engine=engine)
    with _one_ulp_moved_weights():
        runs["stacked one-ulp"] = fl_run(
            "pod phase stacked osafl, weights moved one ulp", "osafl",
            MAIN_RUN, MAIN_EVAL)
    runs["stacked global_lr=1"] = fl_run(
        "pod phase stacked osafl global_lr=1", "osafl", POD_LR1, MAIN_EVAL)
    runs["osafl recompute global_lr=1"] = fl_run(
        "pod phase osafl recompute global_lr=1", "osafl",
        dict(POD_LR1, rounds=POD_RECOMPUTE_ROUNDS), MAIN_EVAL,
        mesh=make_host_mesh(), pod_engine="recompute")
    fedavg = next(g for g in grid if g["alg"] == "fedavg"
                  and g["config"]["model"] == MAIN_RUN["model"])
    gates = {f"osafl {e} bit for bit": _same_rounds(runs[f"osafl {e}"], main)
             for e in POD_BITWISE}
    gates["osafl recompute participants"] = _same_rounds(
        runs["osafl recompute"], main, tol=math.inf)
    gates["osafl recompute within 1e-5 at global_lr=1"] = _same_rounds(
        runs["osafl recompute global_lr=1"], runs["stacked global_lr=1"],
        POD_TOL)
    gates["osafl stale finite"] = all(
        math.isfinite(r["test_loss"]) for r in runs["osafl stale"]["rounds"])
    gates["osafl stale unlike exact_tp"] = not _same_rounds(
        runs["osafl stale"], runs["osafl exact_tp"])
    gates["fedavg fedavg bit for bit with the grid's"] = _same_rounds(
        runs["fedavg fedavg"], fedavg,
        rounds=range(len(fedavg["rounds"])))
    summary = {name: {"round_s": [r["round_s"] for r in row["rounds"]],
                      "request_gen_s": [r["request_gen_s"]
                                        for r in row["rounds"]],
                      "test_loss": [r["test_loss"] for r in row["rounds"]],
                      "max_memory_allocated": row["max_memory_allocated"],
                      "launches": row["launches"]}
               for name, row in runs.items()}
    summary["stacked (phase 5)"] = {
        "round_s": [r["round_s"] for r in main["rounds"]],
        "test_loss": [r["test_loss"] for r in main["rounds"]],
        "max_memory_allocated": main["max_memory_allocated"]}
    gaps = {"recompute vs stacked, global_lr=16":
            _loss_gaps(runs["osafl recompute"], main),
            "stacked one-ulp vs stacked, global_lr=16":
            _loss_gaps(runs["stacked one-ulp"], main),
            "recompute vs stacked, global_lr=1":
            _loss_gaps(runs["osafl recompute global_lr=1"],
                       runs["stacked global_lr=1"])}
    say("pod phase " + json.dumps({"gates": gates, "test_loss_gaps": gaps,
                                   "runs": summary}))
    if not all(gates.values()):
        raise AssertionError(f"pod phase gates failed: {gates}")
    small = small_run_phase(POD_SMALL_RUNS)
    resume = resume_phase("pod resume", POD_RESUME)
    examples = examples_phase()
    return {"runs": runs, "small": small, "resume": resume,
            "examples": examples}


def _rank_runs(runs) -> list:
    """Each of ``runs`` through ``run(..., mesh=make_host_mesh(device=
    "cuda:0"))`` on this rank of the running process group, with the
    launch counts and peak memory reset just before and read just after,
    the rank's own seconds of each round (before the ranks agree on the
    slowest) and the seconds its ``all_gather``s took inside each round (a
    synchronize either side; the setup's are left out), those of the
    sparse cohort's table gathers at admission counted apart from the
    rest. Returns one row a run."""
    import torch.distributed as dist

    import repro_torch.harness.experiments as tex
    from repro_torch.core.cohort import CohortTables
    from repro_torch.harness import ExperimentConfig, run
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch.mesh import make_host_mesh
    spent = {"s": 0.0, "calls": 0, "table_s": 0.0, "table_calls": 0,
             "in_tables": False}
    gather, agree, draws = dist.all_gather, tex._round_times, \
        tex._draw_round_inputs
    table_gather = CohortTables.gather
    own, opened, rows = [], [], []

    def timed_gather(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = gather(*args, **kwargs)
        torch.cuda.synchronize()
        part = "table_" if spent["in_tables"] else ""
        spent[f"{part}s"] += time.perf_counter() - t0
        spent[f"{part}calls"] += 1
        return result

    def tables_gather(self, users):
        spent["in_tables"] = True
        try:
            return table_gather(self, users)
        finally:
            spent["in_tables"] = False

    def round_opens(*args, **kwargs):
        opened.append(dict(spent))
        return draws(*args, **kwargs)

    def own_times(mesh, device, req_s, round_s):
        start = opened[len(own)]
        own.append({
            "round_s": round_s,
            "collective_s": spent["s"] - start["s"],
            "collective_calls": spent["calls"] - start["calls"],
            "table_gather_s": spent["table_s"] - start["table_s"],
            "table_gather_calls": spent["table_calls"]
            - start["table_calls"]})
        return agree(mesh, device, req_s, round_s)
    dist.all_gather, tex._round_times = timed_gather, own_times
    tex._draw_round_inputs = round_opens
    CohortTables.gather = tables_gather
    try:
        for label, alg, engine, kw in runs:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            sr.scored_reduce.launches = 0
            fa.flash_attention_bhsd.launches = 0
            own.clear()
            opened.clear()
            t0 = time.perf_counter()
            hist = run(alg, ExperimentConfig(**kw), eval_samples=MAIN_EVAL,
                       mesh=make_host_mesh(device="cuda:0"),
                       pod_engine=engine)
            rows.append({
                "label": label, "alg": alg, "config": kw,
                "rank": dist.get_rank(), "ranks": dist.get_world_size(),
                "backend": dist.get_backend(),
                "wall_s": time.perf_counter() - t0,
                "launches": {
                    "scored_reduce": sr.scored_reduce.launches,
                    "flash_attention": fa.flash_attention_bhsd.launches},
                "max_memory_allocated": torch.cuda.max_memory_allocated(),
                "own_rounds": list(own),
                "rounds": [{k: h.get(k) for k in (
                    "round", "test_loss", "test_acc", "participants",
                    "round_s", "request_gen_s")} for h in hist]})
    finally:
        dist.all_gather, tex._round_times = gather, agree
        tex._draw_round_inputs = draws
        CohortTables.gather = table_gather
    return rows


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_rank(rank: int, ranks: int, port: int, backend: str, runs,
               out: str) -> None:
    """One rank of phase 6j, in its own process: joins the ``backend``
    group of ``ranks`` ranks on card 0, runs ``_rank_runs(runs)`` and
    writes one JSON file a run into ``out``."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=ranks, rank=rank)
    try:
        for row in _rank_runs(runs):
            with open(Path(out) / f"{row['label']} rank{rank}.json",
                      "w") as f:
                json.dump(row, f)
    finally:
        dist.destroy_process_group()


def mesh_ranks(ranks: int, backend: str, runs, meanwhile=None) -> tuple:
    """``ranks`` processes of a ``backend`` group on the card, started
    together, and ``meanwhile()`` called here while they run; a rank that
    fails fails the phase. Returns ``({label: [each rank's row]}, what
    meanwhile returned)``."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ctx = mp.start_processes(
            _mesh_rank, args=(ranks, _free_port(), backend, runs, str(out)),
            nprocs=ranks, join=False, start_method="spawn")
        done = meanwhile() if meanwhile is not None else None
        while not ctx.join():
            pass
        rows = {}
        for label, *_ in runs:
            rows[label] = []
            for r in range(ranks):
                with open(out / f"{label} rank{r}.json") as f:
                    rows[label].append(json.load(f))
        return rows, done
    finally:
        shutil.rmtree(out, ignore_errors=True)


def nccl_one_rank(runs) -> dict:
    """``runs`` in this process as the one rank of an NCCL group (the
    group is made for them and destroyed after)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{_free_port()}")
    try:
        return {row["label"]: [row] for row in _rank_runs(runs)}
    finally:
        dist.destroy_process_group()


def pod_mesh_phase(main: dict, pods: dict, grid: list) -> dict:
    """Phase 6j (module docstring): two gloo ranks on the card, and here,
    while they start, the kernel at each rank's (128, N) block and at its
    cluster blocks' (32, N) and tier-2 (8, N) shapes, then one NCCL rank
    and the cluster runs in one process. Gates: ``scored_reduce`` once an
    OSAFL round on each rank (K/R + 1 with K > 1 clusters) and never for
    FedAvg, no flash launch; every rank's rounds the same; OSAFL at
    ``global_lr=1`` within 1e-5 of 6i's stacked run, FedAvg of the grid's
    and each cluster run of its run in one process, participants exact;
    the NCCL rank's rounds phase 5's bit for bit. Returns the kernel's
    rows and the runs."""
    from repro_torch.harness import ExperimentConfig
    from repro_torch.launch.mesh import make_host_mesh
    n = buffer_n("fcn")

    def meanwhile():
        shapes = {}
        for U in (MAIN_U // MESH_RANKS, MAIN_U // CLUSTERS, CLUSTERS):
            shapes[U] = check_scored_reduce(U, n, torch.float32, timed=True)
            torch.cuda.empty_cache()
        nccl = nccl_one_rank(MESH_NCCL_RUNS)
        one = {label: fl_run(f"pod mesh phase one process {label}", alg, kw,
                             MAIN_EVAL, mesh=make_host_mesh(),
                             pod_engine=engine)
               for label, alg, engine, kw in MESH_CLUSTER_RUNS}
        torch.cuda.empty_cache()
        return shapes, nccl, one
    gloo, (shapes, nccl, one) = mesh_ranks(MESH_RANKS, "gloo",
                                           MESH_GLOO_RUNS,
                                           meanwhile=meanwhile)
    block = shapes[MAIN_U // MESH_RANKS]
    fedavg = next(g for g in grid if g["alg"] == "fedavg"
                  and g["config"]["model"] == MAIN_RUN["model"])
    gates = {}
    for group, rows in (("gloo", gloo), ("nccl", nccl)):
        for label, ranks_rows in rows.items():
            first = ranks_rows[0]
            want = len(first["rounds"]) * scored_launches(
                first["alg"], ExperimentConfig(**first["config"]),
                first["ranks"])
            gates[f"{group} {label} launches"] = all(
                r["launches"] == {"scored_reduce": want,
                                  "flash_attention": 0}
                for r in ranks_rows)
            gates[f"{group} {label} every rank's rounds the same"] = all(
                r["rounds"] == ranks_rows[0]["rounds"] for r in ranks_rows)
    gates["gloo osafl exact_tp global_lr=1 within 1e-5 of 6i's stacked"] = (
        _same_rounds(gloo["osafl exact_tp global_lr=1"][0],
                     pods["runs"]["stacked global_lr=1"], POD_TOL))
    gates["gloo fedavg within 1e-5 of the grid's"] = _same_rounds(
        gloo["fedavg fedavg"][0], fedavg, POD_TOL)
    for label in one:
        gates[f"gloo {label} within 1e-5 of one process"] = _same_rounds(
            gloo[label][0], one[label], POD_TOL)
    gates["nccl osafl exact_tp bit for bit phase 5's"] = _same_rounds(
        nccl["osafl exact_tp"][0], main)
    gaps = {"two ranks vs stacked, global_lr=1": _loss_gaps(
                gloo["osafl exact_tp global_lr=1"][0],
                pods["runs"]["stacked global_lr=1"]),
            "fedavg two ranks vs grid": _loss_gaps(
                gloo["fedavg fedavg"][0], fedavg),
            **{f"{label} two ranks vs one process": _loss_gaps(
                gloo[label][0], one[label]) for label in one}}
    per_rank = {f"{group} {label} rank{r['rank']}": {
        "own_round_s": [x["round_s"] for x in r["own_rounds"]],
        "collective_s": [x["collective_s"] for x in r["own_rounds"]],
        "collective_calls": [x["collective_calls"]
                             for x in r["own_rounds"]],
        "table_gather_s": [x["table_gather_s"] for x in r["own_rounds"]],
        "table_gather_calls": [x["table_gather_calls"]
                               for x in r["own_rounds"]],
        "round_s": [x["round_s"] for x in r["rounds"]],
        "max_memory_allocated": r["max_memory_allocated"],
        "wall_s": r["wall_s"], "launches": r["launches"]}
        for group, rows in (("gloo", gloo), ("nccl", nccl))
        for label, ranks_rows in rows.items() for r in ranks_rows}
    per_rank.update({f"one process {label}": {
        "round_s": [x["round_s"] for x in row["rounds"]],
        "max_memory_allocated": row["max_memory_allocated"],
        "wall_s": row["wall_s"], "launches": row["launches"]}
        for label, row in one.items()})
    say("pod mesh phase " + json.dumps({
        "gates": gates, "test_loss_gaps": gaps, "per_rank": per_rank,
        "scored_reduce_block": block,
        "scored_reduce_cluster_shapes": [shapes[MAIN_U // CLUSTERS],
                                         shapes[CLUSTERS]]}))
    if not all(gates.values()):
        raise AssertionError(f"pod mesh phase gates failed: {gates}")
    return {"block": block, "shapes": shapes, "gloo": gloo, "nccl": nccl,
            "one": one}


def _clock() -> float:
    torch.cuda.synchronize()
    return time.perf_counter()


class _EngineRecorder:
    """Records every ``(engine, setup)`` that ``build_fused_engine`` makes
    while it is entered, so a phase can read a harness run's captured
    graphs and its final state."""

    def __enter__(self):
        import repro_torch.harness.experiments as tex
        self._tex, self._build = tex, tex.build_fused_engine
        self.made = []

        def build(*args, **kwargs):
            self.made.append(self._build(*args, **kwargs))
            return self.made[-1]
        tex.build_fused_engine = build
        return self

    def __exit__(self, *exc):
        self._tex.build_fused_engine = self._build
        return False


def fused_fl_run(label: str, kw: dict, eval_samples: int,
                 keep_setup: bool = False, **run_kw) -> dict:
    """``fl_run`` of a fused configuration, with each capture's seconds,
    warm-up seconds and launches per replay added to its row (and, with
    ``keep_setup``, the run's setup namespace under ``"setup"``, whose
    server holds the final weights)."""
    with _EngineRecorder() as rec:
        row = fl_run(label, "osafl", kw, eval_samples, **run_kw)
    row["captured"] = [c for eng, _ in rec.made for c in eng.capture_log]
    say(f"{label} captured " + json.dumps(row["captured"]))
    if keep_setup:
        row["setup"] = rec.made[-1][1]
    return row


def fused_parity(kw: dict, lengths=(1, 2)) -> dict:
    """Replay parity on the card: the fused engine runs segments of
    ``lengths`` (x64 solve), printing the peak memory after each capture;
    then the dispatch round's components, fed the same draws, must give
    the same losses, participants, weights, contribution buffer, FIFO and
    stream state. At full width a difference is printed and ``test_loss``
    held to rtol 1e-5 with participants exact. Then one more, warm,
    segment is profiled: one ``cudaGraphLaunch`` and no
    ``cudaLaunchKernel`` from the host."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import round_fused as rf
    from repro_torch.core.client import make_vmapped_local_train
    from repro_torch.core.resource import pathloss_linear
    from repro_torch.core.resource_stacked import (ChannelBatch,
                                                   optimize_clients_batched)
    from repro_torch.device import (deterministic_convolutions,
                                    full_f32_convolutions)
    from repro_torch.harness import ExperimentConfig, build_fused_engine
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.models.small import small_loss
    dev = torch.device("cuda")
    xc = ExperimentConfig(**dict(kw, resource_backend="x64"))
    ev = MAIN_EVAL if xc.num_clients == MAIN_U else 64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    row = {"config": dict(kw, resource_backend="x64"), "segments": []}
    with full_f32_convolutions(), deterministic_convolutions():
        eng, s = build_fused_engine("osafl", xc, ev)
        carry = eng.init_carry(s.server, s.sbuf, s.rstream, 0)
        outs = []
        for n in lengths:
            t0 = _clock()
            outs.append(eng.run_segment(carry, n)[1])
            row["segments"].append({
                "length": n, "seconds": _clock() - t0,
                "capture_s": eng.capture_log[-1]["capture_s"],
                "max_memory_allocated": torch.cuda.max_memory_allocated()})
        fused = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        rounds = sum(lengths)
        _, s2 = build_fused_engine("osafl", xc, ev)
        step = make_vmapped_local_train(s2.grad_fn, s2.fl.local_lr,
                                        s2.fl.kappa_max)
        xi = pathloss_linear(s2.sysb.distance)
        losses, parts = [], []
        for t in range(rounds):
            dr = rf.round_draws(eng.spec, torch.tensor(t, device=dev))
            counts = rf.draw_counts(dr.arrivals, eng.p_ac).cpu().numpy()
            s2.rstream._noise = lambda L, noise=dr.noise: noise
            s2.sbuf.stage(*s2.rstream.draw(counts, xc.dataset, xc.arrivals))
            s2.sbuf.commit()
            gamma = 10.0 ** (rf.draw_shadowing_db(dr.normals).double()
                             / 10.0)
            dec = optimize_clients_batched(
                s2.net, s2.sysb, ChannelBatch(xi=xi,
                                              gamma=gamma.cpu().numpy()),
                s2.n_params, backend="x64", device=dev)
            st = s2.sbuf.state
            slots = rf.draw_slots(dr.slots, st.size, st.head, st.cap)
            d, _ = step(s2.server.params, s2.sbuf.gather(
                slots.cpu().numpy()), torch.as_tensor(dec.kappa, device=dev))
            upd = s2.codec.flatten_stacked(d)
            del d
            s2.server.round_stacked(upd, dec.kappa >= 1)
            del upd
            losses.append(float(small_loss(s2.server.params,
                                           s2.test_batch, s2.model)[0]))
            parts.append(int((dec.kappa >= 1).sum()))
        same = {
            "test_loss": fused["test_loss"].tolist() == losses,
            "participants": fused["participants"].tolist() == parts,
            "w": torch.equal(carry.w, s2.server.w),
            "d_buffer": torch.equal(carry.d_buffer, s2.server.d_buffer),
            "buffer": all(torch.equal(getattr(carry.buf, f),
                                      getattr(s2.sbuf.state, f))
                          for f in carry.buf._fields),
            "stream": all(torch.equal(getattr(carry.stream, f),
                                      getattr(s2.rstream.state, f))
                          for f in carry.stream._fields)}
        row["bit_for_bit"] = same
        row["max_abs_diff"] = {
            "test_loss": max(abs(a - b) for a, b in
                             zip(fused["test_loss"].tolist(), losses)),
            "w": float((carry.w - s2.server.w).abs().max()),
            "d_buffer": float((carry.d_buffer
                               - s2.server.d_buffer).abs().max())}
        row["losses"] = {"fused": fused["test_loss"].tolist(),
                         "dispatch": losses}
        del s2
        torch.cuda.empty_cache()
        before = sr.scored_reduce.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.run_segment(carry, lengths[0])
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()]
        row["warm_segment"] = {
            "length": lengths[0],
            "cudaGraphLaunch": names.count("cudaGraphLaunch"),
            "cudaLaunchKernel": names.count("cudaLaunchKernel"),
            "scored_reduce_launches": sr.scored_reduce.launches - before}
    eng.release()
    del eng, carry, s
    torch.cuda.empty_cache()
    say("fused parity " + json.dumps(row))
    if not (same["participants"] and all(same.values()) or (
            xc.num_clients == MAIN_U and same["participants"]
            and all(abs(a - b) <= 1e-5 * abs(b)
                    for a, b in zip(fused["test_loss"].tolist(), losses)))):
        raise AssertionError(f"fused replay parity failed: {row}")
    ws = row["warm_segment"]
    if (ws["cudaGraphLaunch"], ws["cudaLaunchKernel"]) != (1, 0) or \
            ws["scored_reduce_launches"] != lengths[0] * (
                0 if xc.score_sketch_dim else 1):
        raise AssertionError(f"a warm fused segment is not one graph "
                             f"launch: {ws}")
    return row


def warm_replay_round_s(kw: dict, eval_samples: int) -> float:
    """Seconds a round of ``kw``'s fused segment takes once its graph is
    captured: the engine's second segment of ``rounds_per_dispatch``
    rounds, synchronized, over its length."""
    from repro_torch.harness import ExperimentConfig, build_fused_engine
    xc = ExperimentConfig(**kw)
    eng, s = build_fused_engine("osafl", xc, eval_samples)
    carry = eng.init_carry(s.server, s.sbuf, s.rstream, 0)
    n = xc.rounds_per_dispatch
    eng.run_segment(carry, n)
    t0 = _clock()
    eng.run_segment(carry, n)
    out = (_clock() - t0) / n
    eng.release()
    del eng, s, carry
    torch.cuda.empty_cache()
    return out


def scored_in_graph() -> dict:
    """``scored_reduce`` at the FCN's (256, N) f32 inside a captured CUDA
    graph (one launch a replay, timed by CUDA events over replays) beside
    the same call launched from the host."""
    from repro_torch.kernels import scored_reduce as sr
    N = buffer_n("fcn")
    gen = torch.Generator(device="cuda").manual_seed(7)
    d = torch.randn((MAIN_U, N), generator=gen, device="cuda")
    mean = d.mean(0)
    want = sr.scored_reduce(d, mean)
    torch.cuda.synchronize()
    sr.prepare(d.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = sr.scored_reduce(d, mean)
    graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    row = {"U": MAIN_U, "N": N, "bitwise_equal": same,
           "graph_ms": time_ms(graph.replay, 30),
           "launched_ms": time_ms(lambda: sr.scored_reduce(d, mean), 30)}
    del d, mean, graph, got, want
    torch.cuda.empty_cache()
    say("scored_reduce in a graph " + json.dumps(row))
    if not same:
        raise AssertionError(f"scored_reduce in a graph disagrees: {row}")
    return row


def serve_phase() -> dict:
    """Train-while-serve at full width: the fused main path (``SERVE_TRAIN``)
    in a thread, writing an async snapshot every 2 of its 4 rounds
    (``keep_last=1``), while ``serve_loop`` maps them and scores Dataset-1
    request batches on the card. Gates: the server reaches round 4 with no
    failed load, and the logits it serves there equal, bit for bit, those
    of the trainer's final weights on the same batch."""
    import shutil
    import tempfile
    import threading

    import numpy as np
    from repro_torch.launch.serve import (ModelServer, make_request_batch,
                                          serve_loop)
    from repro_torch.models.small import small_forward
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    model, dataset = SERVE_TRAIN["model"], SERVE_TRAIN["dataset"]
    result = {}

    def train():
        try:
            result["row"] = fused_fl_run(
                "train-while-serve trainer", SERVE_TRAIN, MAIN_EVAL,
                keep_setup=True, save_every_k=SERVE_EVERY,
                checkpoint_dir=root, keep_last=1)
        except BaseException as e:       # raised again below
            result["error"] = e
    trainer = threading.Thread(target=train, daemon=True)
    try:
        trainer.start()
        try:
            stats = serve_loop(root, until_round=SERVE_TRAIN["rounds"],
                               poll_s=0.05, batch=32, dataset=dataset,
                               timeout_s=900.0)
        finally:
            trainer.join(timeout=900.0)
        if trainer.is_alive() or "error" in result:
            raise result.get("error") or AssertionError(
                "the train-while-serve trainer did not finish")
        row = result["row"]
        s = row.pop("setup")
        x = make_request_batch(np.random.default_rng(3), 32, dataset)
        with ModelServer(root, claim=False) as server:
            server.poll()
            served = server.score(x)
            mapped = server.mapped_round
        with torch.no_grad():
            want = small_forward(s.codec.unflatten(s.server.w),
                                 torch.as_tensor(x, device="cuda"),
                                 model).cpu().numpy()
        del s
        out = {"reloads": stats["reloads"],
               "behind_at_swap": [r["behind"] for r in stats["reloads"]],
               "mapped_rounds": stats["mapped_rounds"],
               "failed_loads": stats["failed_loads"],
               "batches": stats["batches"],
               "requests_scored": stats["requests_scored"],
               "score_s_per_batch": {
                   "median": float(np.median(stats["score_s"])),
                   "min": min(stats["score_s"]),
                   "max": max(stats["score_s"])},
               "final_mapped_round": mapped,
               "logits_bit_identical": bool(np.array_equal(served, want)),
               "logits_max_abs_diff": float(np.abs(served - want).max())}
        say("train-while-serve " + json.dumps(out))
        if not (out["logits_bit_identical"]
                and mapped == SERVE_TRAIN["rounds"]
                and stats["failed_loads"] == 0):
            raise AssertionError(f"train-while-serve failed: {out}")
        return {"trainer": row, **out}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fused_phase() -> dict:
    """Phase 6h: the fused round as CUDA-graph segments. The main path's
    configuration (stacked requests, f32 solve) as 3-round segments over 6
    rounds and 1-round segments over 3 (their first 3 rounds bit for bit),
    and the dispatch round on it; replay parity on the small MLP and at
    full width, each with a profiled warm segment; ``scored_reduce`` inside
    a graph; Fig. 1's preset as one 8-round segment beside its dispatch
    run; small fused runs card against CPU; train-while-serve."""
    runs = [fused_fl_run("fused main path", FUSED_RUN, MAIN_EVAL),
            fused_fl_run("fused main path, 1-round segments", FUSED_ONE,
                         MAIN_EVAL)]
    dispatch = fl_run("fused main path's dispatch round", "osafl",
                      FUSED_DISPATCH, MAIN_EVAL)
    keys = ("test_loss", "test_acc", "participants")
    head = [[[r[k] for k in keys] for r in row["rounds"][:3]]
            for row in runs]
    summary = {
        "segment_invariance_bit_for_bit": head[0] == head[1],
        "round_s": {"fused_3": [r["round_s"] for r in runs[0]["rounds"]],
                    "fused_1": [r["round_s"] for r in runs[1]["rounds"]],
                    "dispatch": [r["round_s"] for r in dispatch["rounds"]]},
        "max_memory_allocated": {
            "fused_3": runs[0]["max_memory_allocated"],
            "fused_1": runs[1]["max_memory_allocated"],
            "dispatch": dispatch["max_memory_allocated"]},
        "captured": {"fused_3": runs[0]["captured"],
                     "fused_1": runs[1]["captured"]},
        "scored_reduce": [r["launches"]["scored_reduce"] for r in runs]}
    say("fused main path " + json.dumps(summary))
    if not summary["segment_invariance_bit_for_bit"]:
        raise AssertionError("the fused main path's first 3 rounds differ "
                             f"between segment lengths 3 and 1: {head}")
    parity = [fused_parity(kw) for kw in FUSED_PARITY]
    in_graph = scored_in_graph()
    fig1 = fused_fl_run("fused fig1 preset", FUSED_FIG1, FIG1_EVAL)
    fig1_dispatch = fl_run("fig1 preset, dispatch round", "osafl",
                           dict(FUSED_FIG1, round_backend="dispatch"),
                           FIG1_EVAL)
    say("fused fig1 " + json.dumps({
        "round_s": {"fused_8": [r["round_s"] for r in fig1["rounds"]],
                    "fused_8_warm_replay": warm_replay_round_s(FUSED_FIG1,
                                                               FIG1_EVAL),
                    "dispatch": [r["round_s"]
                                 for r in fig1_dispatch["rounds"]]},
        "max_memory_allocated": [fig1["max_memory_allocated"],
                                 fig1_dispatch["max_memory_allocated"]]}))
    small = small_run_phase(FUSED_SMALL)
    serve = serve_phase()
    return {"runs": runs, "dispatch": dispatch, "parity": parity,
            "in_graph": in_graph, "fig1": fig1, "fig1_dispatch":
            fig1_dispatch, "small": small, "serve": serve}


def forward_vs_decode(params, cfg, prompt, cache_dtype, exact=None,
                      atol=LOGIT_TOL, rtol=LOGIT_TOL, extra=None) -> dict:
    """Last-position logits of ``forward`` (the flash path; the chunked
    recurrent forms) against those of sequential ``decode_step``s over a
    cache (``_sdpa``, MLA's absorbed form, the recurrences), same prompt,
    held to ``atol``/``rtol``. ``extra`` (frames or patches) goes into the
    forward's batch, and the decode steps attend to its memory as the
    forward builds it. ``exact``, the f32 run's forward logits, measures
    how far each path is from it; the run's own forward logits are
    returned beside the row."""
    from repro_torch.models import transformer as T
    B, S = prompt.shape
    extra = extra or {}
    with torch.inference_mode():
        lf, _ = T.forward(params, {"tokens": prompt, **extra}, cfg)
        memory = T.memory_of(params, extra, cfg)
        cache = T.init_cache(cfg, B, S, device=prompt.device,
                             dtype=cache_dtype)
        for i in range(S):
            ld, cache = T.decode_step(params, cache, prompt[:, i:i + 1], i,
                                      cfg, memory=memory)
    a, b = lf[:, -1].float(), ld[:, -1].float()
    out = {"compute": cfg.dtype,
           "cache": str(cache_dtype).replace("torch.", ""),
           "max_abs_err": float((a - b).abs().max()),
           "mean_abs_logit": float(b.abs().mean()),
           "finite": bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
           "atol": atol, "rtol": rtol,
           "allclose": torch.allclose(a, b, atol=atol, rtol=rtol),
           "tokens_agree": _close_tokens(a, b, atol)}
    if exact is not None:
        out["forward_vs_f32_max_abs"] = float((a - exact).abs().max())
        out["decode_vs_f32_max_abs"] = float((b - exact).abs().max())
    return out, a


def device_breakdown(fn) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler),
    grouped into the flash forward, its backward, matrix products and
    everything else. The profiler's raw device events are summed by name:
    ``key_averages()`` builds the whole event tree first, which took 150 s
    against 7.7 s for xlstm-350m's prefill call (266,447 device events;
    ``tools/recurrent_probe.py``, NVIDIA H100 80GB HBM3, 700.00 W)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name == "CUDA" and not ev.is_user_annotation():
            ms, count = by_name.get(ev.name(), (0.0, 0))
            by_name[ev.name()] = (ms + ev.duration_ns() / 1e6, count + 1)
    kernels = [(name, ms, c) for name, (ms, c) in by_name.items() if ms > 0]
    groups = {"flash_attention": 0.0, "flash_attention_bwd": 0.0,
              "matmul": 0.0, "other": 0.0}
    for name, ms, _ in kernels:
        low = name.lower()
        if any(sym in low for sym in FLASH_BWD_SYMBOLS):
            groups["flash_attention_bwd"] += ms
        elif any(sym in low for sym in FLASH_SYMBOLS):
            groups["flash_attention"] += ms
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass",
                                    "sm90_")):     # cuBLAS's kernel names
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    bwd_kernels, fwd_kernels = {}, {}
    for name, ms, c in kernels:
        for sym in FLASH_BWD_SYMBOLS:
            if sym in name.lower():
                got = bwd_kernels.setdefault(sym, {"ms": 0.0, "count": 0})
                got["ms"] += ms
                got["count"] += c
        if (any(sym in name for sym in FLASH_SYMBOLS)
                and not any(sym in name for sym in FLASH_BWD_SYMBOLS)):
            # the forward's kernels by their instantiation, e.g.
            # "flash_bf16_wgmma_kernel<192, 128>"
            key = re.sub(r"^.*?(flash_\w+<[^>]*>).*$", r"\1", name)
            got = fwd_kernels.setdefault(key, {"ms": 0.0, "count": 0})
            got["ms"] += ms
            got["count"] += c
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    # zero fills: a training step's count shows whether gradients of the
    # stacked layers scatter into whole-stack zeros
    fills = [(ms, c) for name, ms, c in kernels if "FillFunctor" in name]
    return {"device_ms": sum(groups.values()), "by_group_ms": groups,
            "launches": sum(c for _, _, c in kernels),
            "fills": {"ms": sum(ms for ms, _ in fills),
                      "count": sum(c for _, c in fills)},
            "flash_bwd_kernels": bwd_kernels,
            "flash_kernels": fwd_kernels,
            "top_kernels": [{"name": n[:80], "ms": ms, "count": c}
                            for n, ms, c in top]}


def prefill_breakdown(prefill, params, tokens) -> dict:
    """``device_breakdown`` of one prefill call."""
    with torch.inference_mode():
        return device_breakdown(lambda: prefill(params, {"tokens": tokens}))


def serving_phase() -> dict:
    """deepseek-coder-33b at full width, 8 layers, seeded random weights on
    the card: prefill, then batched decode, then flash against the cache."""
    from repro_torch.configs import get_config
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch import serve_decode
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("deepseek-coder-33b"),
                              n_layers=SERVE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = _clock()
    params = T.init_model(gen, cfg)
    init_s = _clock() - t0
    n_params = T.param_count(params)
    B, S = SERVE_PREFILL["batch"], SERVE_PREFILL["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device="cuda")
    prefill = make_prefill_step(cfg)

    fa.flash_attention_bhsd.launches = 0
    sr.scored_reduce.launches = 0
    prefill_s, per_call = [], []
    with torch.inference_mode():
        for _ in range(2):                 # the first call warms up cuBLAS
            before = fa.flash_attention_bhsd.launches
            t0 = _clock()
            nxt = prefill(params, {"tokens": tokens})
            prefill_s.append(_clock() - t0)
            per_call.append(fa.flash_attention_bhsd.launches - before)
    launches = {"flash_attention": fa.flash_attention_bhsd.launches,
                "scored_reduce": sr.scored_reduce.launches}
    breakdown = prefill_breakdown(prefill, params, tokens)
    breakdown["busy_share_of_timed_call"] = (breakdown["device_ms"] / 1e3
                                             / prefill_s[-1])
    prompt = tokens[:2, :SERVE_DECODE["prompt_len"]]
    del tokens
    gate, exact = forward_vs_decode(
        params, dataclasses.replace(cfg, dtype="float32"), prompt,
        torch.float32)
    checks = [gate, forward_vs_decode(params, cfg, prompt, torch.bfloat16,
                                      exact)[0]]
    del params
    torch.cuda.empty_cache()
    # the second leg of the path (the checks above launch too, so the
    # counts restart here)
    fa.flash_attention_bhsd.launches = 0
    sr.scored_reduce.launches = 0
    dec = serve_decode.run(cfg, **SERVE_DECODE)
    launches["flash_attention"] += fa.flash_attention_bhsd.launches
    launches["scored_reduce"] += sr.scored_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    nb, npl, nd = (SERVE_DECODE["batch"], SERVE_DECODE["prompt_len"],
                   SERVE_DECODE["decode_steps"])
    out = {"config": f"{cfg.name} n_layers={cfg.n_layers} d_model="
                     f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
                     f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
                     f"vocab={cfg.vocab_size}",
           "params": n_params, "init_s": init_s,
           "prefill": {"batch": B, "seq": S, "seconds": prefill_s,
                       "tokens_per_s": [B * S / t for t in prefill_s],
                       "flash_launches_per_call": per_call},
           "decode": {**SERVE_DECODE, "prefill_s": dec["prefill_s"],
                      "decode_s": dec["decode_s"],
                      "prefill_tokens_per_s": nb * npl / dec["prefill_s"],
                      "decode_tokens_per_s": nb * nd / dec["decode_s"]},
           "max_memory_allocated": peak, "launches": launches,
           "prefill_breakdown": breakdown, "forward_vs_decode": checks}
    say("serving path " + json.dumps(out))
    toks = dec["tokens"]
    if per_call != [cfg.n_layers] * len(per_call):
        raise AssertionError(f"flash_attention launched {per_call} times per "
                             f"prefill call, not {cfg.n_layers}")
    if not (bool(((nxt >= 0) & (nxt < cfg.vocab_size)).all())
            and toks.shape == (nb, nd)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
        raise AssertionError("the serving path gave tokens outside the "
                             "vocabulary")
    # the gate: f32 compute with an f32 cache, where the two paths differ
    # only in their order of sums. In bf16 the cache path's _sdpa rounds
    # its logits to bf16 (as the reference's does), so the bf16 row is
    # printed beside it with each path's distance from the f32 logits.
    if not (gate["finite"] and gate["allclose"] and gate["tokens_agree"]
            and checks[1]["finite"]):
        raise AssertionError(f"forward (flash) and decode (cache) disagree: "
                             f"{checks}")
    return out


def mla_flash_phase() -> dict:
    """The flash kernel at deepseek-v3's MLA prefill shape as the model
    calls it (q/k head dim 192, v head dim 128, nothing padded) against
    its plain version, repeated bit for bit and timed beside its bound and
    ``scaled_dot_product_attention`` on the same tensors (``check_flash``);
    then, in turns with it, the padded problem that the prefill ran before
    (v zero-padded to 192, so Dv > 128: the kept ``mma.sync`` route), its
    first 128 columns held to the unpadded output within FLASH_TOL."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    row = check_flash(MLA_FLASH, torch.bfloat16, causal=True, timed=True,
                      dv=MLA_V_DIM)
    B, H, Hkv, S, D = MLA_FLASH
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, H, S, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Hkv, S, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, Hkv, S, MLA_V_DIM), generator=gen,
                    device="cuda").bfloat16()
    vp = F.pad(v, (0, D - MLA_V_DIM))
    out = fa.flash_attention_bhsd(q, k, v)
    padded = fa.flash_attention_bhsd(q, k, vp)
    torch.cuda.synchronize()
    tol = FLASH_TOL[torch.bfloat16]
    row["padded_max_abs_diff"] = float(
        (padded[..., :MLA_V_DIM].float() - out.float()).abs().max())
    row["padded_close"] = torch.allclose(padded[..., :MLA_V_DIM].float(),
                                         out.float(), atol=tol, rtol=tol)
    del out, padded
    turns = {"unpadded": [], "padded": []}
    for name in ("unpadded", "padded", "padded", "unpadded"):
        vv = v if name == "unpadded" else vp
        turns[name].append(time_ms(lambda: fa.flash_attention_bhsd(q, k, vv),
                                   10))
    row["ms_in_turns"] = turns["unpadded"]
    row["padded_mma_sync_ms_in_turns"] = turns["padded"]
    row["padded_mma_sync_ms"] = sum(turns["padded"]) / 2
    row["symbol"] = MLA_SYMBOL
    del q, k, v, vp
    torch.cuda.empty_cache()
    say("flash_attention at the MLA prefill shape " + json.dumps(row))
    if not row["padded_close"]:
        raise AssertionError(f"the padded mma.sync route and the unpadded "
                             f"Hopper kernel disagree: {row}")
    return row


def moe_serving_phase() -> dict:
    """The MoE decoders at full width, depth cut (``MOE_SERVE``), seeded
    random bf16 weights drawn on the card and freed before the next
    config: ``make_prefill_step`` on 4 x 4096-token prompts (two timed
    calls, then one more that counts each MoE layer's capacity and drops,
    then a profiled one), the f32 forward-against-decode gate at
    ``capacity_factor`` 50 with the bf16 row beside it, then
    ``serve_decode.run`` (batch 8, 4096-position cache); launch counts
    reset just before each leg and read just after."""
    from repro_torch.configs import get_config
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch import serve_decode
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    mla = mla_flash_phase()
    rows = {}
    for arch, layers in MOE_SERVE:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = _clock()
        params = T.init_model(gen, cfg)
        init_s = _clock() - t0
        weights = torch.cuda.memory_allocated()
        B, S = SERVE_PREFILL["batch"], SERVE_PREFILL["seq"]
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda")
        prefill = make_prefill_step(cfg)
        fa.flash_attention_bhsd.launches = 0
        sr.scored_reduce.launches = 0
        prefill_s, per_call, nxt = [], [], []
        with torch.inference_mode():
            for _ in range(2):             # the first call warms up cuBLAS
                before = fa.flash_attention_bhsd.launches
                t0 = _clock()
                nxt.append(prefill(params, {"tokens": tokens}))
                prefill_s.append(_clock() - t0)
                per_call.append(fa.flash_attention_bhsd.launches - before)
        launches = {"flash_attention": fa.flash_attention_bhsd.launches,
                    "scored_reduce": sr.scored_reduce.launches}
        prefill_peak = torch.cuda.max_memory_allocated()
        # each MoE layer's routing of the same prompts, on a third call
        stats = []
        real = T.moe_fwd

        def counting(p, x, c):
            stats.append(moe.dispatch_stats(p, x, c))
            return real(p, x, c)
        T.moe_fwd = counting
        try:
            with torch.inference_mode():
                nxt.append(prefill(params, {"tokens": tokens}))
        finally:
            T.moe_fwd = real
        dispatch = [{k: int(v) for k, v in st.items()} for st in stats]
        breakdown = prefill_breakdown(prefill, params, tokens)
        # the forward's flash kernels in the profiled call: the Hopper
        # kernel alone, once a layer (MLA at <192, 128>)
        flash_kernels = breakdown["flash_kernels"]
        hopper_only = (
            all(name.startswith("flash_bf16_wgmma_kernel<")
                for name in flash_kernels)
            and sum(x["count"] for x in flash_kernels.values())
            == cfg.n_layers
            and (cfg.attention != "mla" or MLA_SYMBOL in flash_kernels))
        breakdown["busy_share_of_timed_call"] = (breakdown["device_ms"]
                                                 / 1e3 / prefill_s[-1])
        prompt = tokens[:2, :SERVE_DECODE["prompt_len"]]
        del tokens
        torch.cuda.empty_cache()
        # the gate in f32 over all layers: an f32 product casts one expert
        # stack at a time (17.8 GB for arctic, 15.0 for deepseek-v3), which
        # fits beside the bf16 weights
        say(f"moe serving {arch}: before the f32 gate "
            f"{torch.cuda.memory_allocated()} B allocated, "
            f"{torch.cuda.memory_reserved()} B reserved")
        wide = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_GATE_CAPACITY))
        gate, exact = forward_vs_decode(
            params, dataclasses.replace(wide, dtype="float32"), prompt,
            torch.float32)
        torch.cuda.empty_cache()
        checks = [gate, forward_vs_decode(params, wide, prompt,
                                          torch.bfloat16, exact)[0]]
        del params
        torch.cuda.empty_cache()
        fa.flash_attention_bhsd.launches = 0
        sr.scored_reduce.launches = 0
        dec = serve_decode.run(cfg, **SERVE_DECODE)
        launches["flash_attention"] += fa.flash_attention_bhsd.launches
        launches["scored_reduce"] += sr.scored_reduce.launches
        peak = torch.cuda.max_memory_allocated()
        nb, npl, nd = (SERVE_DECODE["batch"], SERVE_DECODE["prompt_len"],
                       SERVE_DECODE["decode_steps"])
        m = cfg.moe
        row = {"config": f"{cfg.name} n_layers={cfg.n_layers} (dense "
                         f"{m.first_dense_layers}) d_model={cfg.d_model} "
                         f"heads={cfg.n_heads}/{cfg.n_kv_heads} attention="
                         f"{cfg.attention} experts={m.num_experts} top_k="
                         f"{m.top_k} d_ff_expert={m.d_ff_expert} shared="
                         f"{m.num_shared_experts} dense_residual="
                         f"{m.dense_residual_d_ff} mtp={cfg.mtp_depth} "
                         f"vocab={cfg.vocab_size} params={cfg.param_dtype}",
               "weights_bytes": weights, "init_s": init_s,
               "prefill": {"batch": B, "seq": S, "seconds": prefill_s,
                           "tokens_per_s": [B * S / t for t in prefill_s],
                           "flash_launches_per_call": per_call,
                           "max_memory_allocated": prefill_peak,
                           "bitwise_repeat": all(torch.equal(nxt[0], t)
                                                 for t in nxt[1:]),
                           "dispatch": dispatch},
               "decode": {**SERVE_DECODE, "prefill_s": dec["prefill_s"],
                          "decode_s": dec["decode_s"],
                          "prefill_tokens_per_s": nb * npl / dec["prefill_s"],
                          "decode_tokens_per_s": nb * nd / dec["decode_s"],
                          "ms_per_step": dec["decode_s"] / nd * 1e3},
               "max_memory_allocated": peak, "launches": launches,
               "prefill_breakdown": breakdown,
               "forward_vs_decode": checks}
        say("moe serving path " + json.dumps(row))
        toks = dec["tokens"]
        if per_call != [cfg.n_layers] * len(per_call):
            raise AssertionError(f"{arch}: flash_attention launched "
                                 f"{per_call} times per prefill call, not "
                                 f"{cfg.n_layers}")
        if not row["prefill"]["bitwise_repeat"]:
            raise AssertionError(f"{arch}: prefill calls on the same weights "
                                 f"gave other tokens: {nxt}")
        if not hopper_only:
            raise AssertionError(f"{arch}: a profiled prefill call ran flash "
                                 f"kernels other than the Hopper kernel "
                                 f"once a layer: {flash_kernels}")
        if not (all(bool(((t >= 0) & (t < cfg.vocab_size)).all())
                    for t in nxt) and toks.shape == (nb, nd)
                and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
            raise AssertionError(f"{arch}: the serving path gave tokens "
                                 f"outside the vocabulary")
        if not (gate["finite"] and gate["allclose"] and gate["tokens_agree"]
                and checks[1]["finite"]):
            raise AssertionError(f"{arch}: forward (flash) and decode "
                                 f"(cache) disagree: {checks}")
        rows[arch] = row
        torch.cuda.empty_cache()
    return {"mla_flash": mla, "runs": rows}


class _Spans:
    """While entered, each call of the named functions (``{label: (module,
    attribute)}``) is bracketed by CUDA events on the current stream, with
    no synchronisation; ``ms()`` sums each label's spans on the device
    timeline (idle gaps inside a call included) and counts the calls."""

    def __init__(self, targets: dict):
        self.targets = targets
        self.events = {label: [] for label in targets}

    def __enter__(self):
        self.real = {}
        for label, (mod, attr) in self.targets.items():
            real = self.real[label] = getattr(mod, attr)

            def timed(*args, _real=real, _label=label, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _real(*args, **kwargs)
                end.record()
                self.events[_label].append((start, end))
                return out
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for label, (mod, attr) in self.targets.items():
            setattr(mod, attr, self.real[label])
        return False

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {label: {"ms": sum(a.elapsed_time(b) for a, b in evs),
                        "calls": len(evs)}
                for label, evs in self.events.items() if evs}


def _first_groups(params, cfg, n_layers: int) -> tuple:
    """zamba2's or xLSTM's config and weights cut to their first
    ``n_layers`` (whole groups): views of the stacked layers, no copies."""
    from repro_torch.core.flatten import tree_map
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    every = (cfg.hybrid.shared_attn_every if cfg.hybrid
             else cfg.ssm.slstm_every)
    groups = n_layers // every
    stacks = (("mamba_layers",) if cfg.hybrid
              else ("mlstm_layers", "slstm_layers"))
    return cut, {k: (tree_map(lambda t: t[:groups], v) if k in stacks
                     else v) for k, v in params.items()}


def recurrent_serving_phase() -> dict:
    """The flash kernel at zamba2's shared-attention shape (D = 80) against
    its plain version, repeated bit for bit and timed beside its bound and
    ``scaled_dot_product_attention`` (``check_flash``); then zamba2-2.7b and
    xlstm-350m at full width and depth, seeded random f32 weights drawn on
    the card and freed before the next config: two timed
    ``make_prefill_step`` calls on 4 x 4096 prompts (flash once a shared
    block application), each block kind's span on the device timeline
    (Mamba2, the shared block, mLSTM, sLSTM's token loop) in the second,
    a profiled one, the f32 forward-against-decode gate on 2 x 512 tokens
    over the first groups of the same weights (``RECURRENT_GATE_LAYERS``;
    the bf16 row beside it), then ``serve_decode.run`` (batch 8,
    4096-position cache); launch counts reset just before each leg and
    read just after."""
    from repro_torch.configs import get_config
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch import serve_decode
    from repro_torch.models import ssm
    from repro_torch.models import transformer as T
    flash = check_flash(ZAMBA_FLASH, torch.bfloat16, causal=True, timed=True)
    flash["symbol"] = ZAMBA_SYMBOL
    torch.cuda.empty_cache()
    rows = {}
    for arch in RECURRENT_SERVE:
        cfg = get_config(arch)
        n_attn = (cfg.n_layers // cfg.hybrid.shared_attn_every
                  if cfg.hybrid else 0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        t_arch = _clock()
        base = torch.cuda.memory_allocated()      # earlier phases' caches
        params = T.init_model(gen, cfg)
        init_s = _clock() - t_arch
        weights = torch.cuda.memory_allocated() - base
        B, S = SERVE_PREFILL["batch"], SERVE_PREFILL["seq"]
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda")
        prefill = make_prefill_step(cfg)
        fa.flash_attention_bhsd.launches = 0
        sr.scored_reduce.launches = 0
        # the first call warms up cuBLAS; the second brackets each block
        # call with CUDA events (150 events, no synchronisation)
        spans = _Spans({"mamba2": (ssm, "mamba_fwd"),
                        "shared_block": (T, "block_fwd"),
                        "mlstm": (ssm, "mlstm_fwd"),
                        "slstm": (ssm, "slstm_fwd")})
        prefill_s, per_call, nxt = [], [], []
        with torch.inference_mode():
            for watch in (contextlib.nullcontext(), spans):
                before = fa.flash_attention_bhsd.launches
                with watch:
                    t0 = _clock()
                    nxt.append(prefill(params, {"tokens": tokens}))
                    prefill_s.append(_clock() - t0)
                per_call.append(fa.flash_attention_bhsd.launches - before)
        launches = {"flash_attention": fa.flash_attention_bhsd.launches,
                    "scored_reduce": sr.scored_reduce.launches}
        prefill_peak = torch.cuda.max_memory_allocated()
        block_ms = spans.ms()
        legs = {"prefill_calls": _clock() - t_arch}
        breakdown = prefill_breakdown(prefill, params, tokens)
        legs["profiled_call"] = _clock() - t_arch - sum(legs.values())
        flash_kernels = breakdown["flash_kernels"]
        flash_ok = (set(flash_kernels) == ({ZAMBA_SYMBOL} if n_attn else set())
                    and sum(x["count"] for x in flash_kernels.values())
                    == n_attn)
        breakdown["busy_share_of_timed_call"] = (breakdown["device_ms"]
                                                 / 1e3 / prefill_s[-1])
        prompt = tokens[:2, :RECURRENT_GATE_SEQ]
        del tokens
        torch.cuda.empty_cache()
        gate_cfg, gate_params = _first_groups(params, cfg,
                                              RECURRENT_GATE_LAYERS[arch])
        gate, exact = forward_vs_decode(
            gate_params, dataclasses.replace(gate_cfg, dtype="float32"),
            prompt, torch.float32, **RECURRENT_GATE_TOL)
        checks = [gate, forward_vs_decode(gate_params, gate_cfg, prompt,
                                          torch.bfloat16, exact)[0]]
        for row in checks:
            row["n_layers"] = gate_cfg.n_layers
        legs["forward_vs_decode"] = _clock() - t_arch - sum(legs.values())
        del params, gate_params
        torch.cuda.empty_cache()
        fa.flash_attention_bhsd.launches = 0
        sr.scored_reduce.launches = 0
        dec = serve_decode.run(cfg, **SERVE_DECODE)
        launches["flash_attention"] += fa.flash_attention_bhsd.launches
        launches["scored_reduce"] += sr.scored_reduce.launches
        peak = torch.cuda.max_memory_allocated()
        legs["serve_decode"] = _clock() - t_arch - sum(legs.values())
        nb, npl, nd = (SERVE_DECODE["batch"], SERVE_DECODE["prompt_len"],
                       SERVE_DECODE["decode_steps"])
        s_cfg = cfg.ssm
        row = {"config": f"{cfg.name} n_layers={cfg.n_layers} d_model="
                         f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}"
                         f" attention={cfg.attention} ssm={s_cfg.kind} "
                         f"d_state={s_cfg.d_state} chunk={s_cfg.chunk_size} "
                         f"shared_attn_every="
                         f"{cfg.hybrid.shared_attn_every if cfg.hybrid else 0}"
                         f" slstm_every={s_cfg.slstm_every} vocab="
                         f"{cfg.vocab_size} params={cfg.param_dtype}",
               "params": T.param_count(T.init_model(None, cfg)),
               "weights_bytes": weights, "init_s": init_s,
               "prefill": {"batch": B, "seq": S, "seconds": prefill_s,
                           "tokens_per_s": [B * S / t for t in prefill_s],
                           "flash_launches_per_call": per_call,
                           "max_memory_allocated": prefill_peak,
                           "bitwise_repeat": all(torch.equal(nxt[0], t)
                                                 for t in nxt[1:]),
                           "block_span_ms": block_ms},
               "decode": {**SERVE_DECODE, "prefill_s": dec["prefill_s"],
                          "decode_s": dec["decode_s"],
                          "prefill_tokens_per_s": nb * npl / dec["prefill_s"],
                          "decode_tokens_per_s": nb * nd / dec["decode_s"],
                          "ms_per_step": dec["decode_s"] / nd * 1e3},
               "max_memory_allocated": peak, "allocated_before": base,
               "launches": launches, "prefill_breakdown": breakdown,
               "forward_vs_decode": checks, "leg_seconds": legs}
        say("recurrent serving path " + json.dumps(row))
        toks = dec["tokens"]
        if per_call != [n_attn] * len(per_call):
            raise AssertionError(f"{arch}: flash_attention launched "
                                 f"{per_call} times per prefill call, not "
                                 f"{n_attn}")
        if not flash_ok:
            raise AssertionError(f"{arch}: a profiled prefill call ran flash "
                                 f"kernels other than {ZAMBA_SYMBOL} once a "
                                 f"shared-block application: {flash_kernels}")
        if not (all(bool(((t >= 0) & (t < cfg.vocab_size)).all())
                    for t in nxt) and toks.shape == (nb, nd)
                and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())):
            raise AssertionError(f"{arch}: the serving path gave tokens "
                                 f"outside the vocabulary")
        if not (gate["finite"] and gate["allclose"] and gate["tokens_agree"]
                and checks[1]["finite"]):
            raise AssertionError(f"{arch}: forward (chunked) and decode "
                                 f"(recurrent) disagree: {checks}")
        rows[arch] = row
        torch.cuda.empty_cache()
    return {"zamba_flash": flash, "runs": rows}


def _set_gates(params) -> None:
    """The vision decoder's cross-layer gates at CROSS_GATE, in place."""
    if "cross_layers" in params:
        params["cross_layers"]["gate_attn"].fill_(CROSS_GATE)
        params["cross_layers"]["gate_mlp"].fill_(CROSS_GATE)


def _memory_inputs(cfg, batch: int, gen) -> dict:
    """0.02 N(0, 1) frames (whisper) or patches (the vision decoder) on the
    card, as the reference's serving example draws them."""
    if cfg.encoder is not None:
        return {"frames": 0.02 * torch.randn(
            (batch, cfg.encoder.n_frames, cfg.d_model), generator=gen,
            device="cuda")}
    return {"patches": 0.02 * torch.randn(
        (batch, cfg.vision.n_patches, cfg.vision.d_vision), generator=gen,
        device="cuda")}


def cross_serving_phase() -> dict:
    """The flash kernel at whisper-medium's decoder shape and the vision
    decoder's self-attention shape against its plain version, repeated bit
    for bit and timed beside its bound and ``scaled_dot_product_attention``
    (``check_flash``); then whisper-medium and llama-3.2-vision-11b at full
    width and depth, seeded random f32 weights drawn on the card (the
    vision decoder's gates at CROSS_GATE) and freed before the next
    config: whisper's ``whisper_encode`` of 8 x 1,500 frames alone (twice),
    two timed ``make_prefill_step`` calls (the memory built inside, flash
    once a causal self-attention layer, the same tokens bit for bit), a
    profiled one (its flash kernels: the shape's symbol alone, once a
    layer), the f32 forward-against-decode gate on 2 x 128 tokens over the
    memory (the bf16 row beside it), then ``serve_decode.run`` (batch 8;
    the gates set by wrapping its ``init_model``), the peak memory and each
    leg's seconds; launch counts reset just before each leg and read just
    after."""
    from repro_torch.configs import get_config
    from repro_torch.core.pod import make_prefill_step
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch import serve_decode
    from repro_torch.models import transformer as T
    flash = {}
    for arch in CROSS_SERVE:
        shape, symbol = CROSS_FLASH[arch]
        flash[arch] = check_flash(shape, torch.bfloat16, causal=True,
                                  timed=True)
        flash[arch]["symbol"] = symbol
        torch.cuda.empty_cache()
    rows = {}
    real_init = serve_decode.init_model

    def gated_init(gen, cfg):
        params = real_init(gen, cfg)
        _set_gates(params)
        return params
    for arch in CROSS_SERVE:
        cfg = get_config(arch)
        symbol = CROSS_FLASH[arch][1]
        n_self = (cfg.n_layers if cfg.encoder else
                  cfg.n_layers // cfg.vision.cross_attn_every
                  * (cfg.vision.cross_attn_every - 1))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(0)
        t_arch = _clock()
        base = torch.cuda.memory_allocated()      # earlier phases' caches
        params = T.init_model(gen, cfg)
        _set_gates(params)
        init_s = _clock() - t_arch
        weights = torch.cuda.memory_allocated() - base
        B, S = CROSS_PREFILL[arch]["batch"], CROSS_PREFILL[arch]["seq"]
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device="cuda")
        extra = _memory_inputs(cfg, B, gen)
        batch = {"tokens": tokens, **extra}
        encode_s = []
        if cfg.encoder is not None:
            with torch.inference_mode():
                for _ in range(2):         # the first call warms up cuBLAS
                    t0 = _clock()
                    memory = T.whisper_encode(params, extra["frames"], cfg)
                    encode_s.append(_clock() - t0)
            encode_finite = bool(torch.isfinite(memory).all())
            del memory
        prefill = make_prefill_step(cfg)
        fa.flash_attention_bhsd.launches = 0
        sr.scored_reduce.launches = 0
        prefill_s, per_call, nxt = [], [], []
        with torch.inference_mode():
            for _ in range(2):
                before = fa.flash_attention_bhsd.launches
                t0 = _clock()
                nxt.append(prefill(params, batch))
                prefill_s.append(_clock() - t0)
                per_call.append(fa.flash_attention_bhsd.launches - before)
        launches = {"flash_attention": fa.flash_attention_bhsd.launches,
                    "scored_reduce": sr.scored_reduce.launches}
        prefill_peak = torch.cuda.max_memory_allocated()
        legs = {"prefill_calls": _clock() - t_arch}
        with torch.inference_mode():
            breakdown = device_breakdown(lambda: prefill(params, batch))
        legs["profiled_call"] = _clock() - t_arch - sum(legs.values())
        flash_kernels = breakdown["flash_kernels"]
        flash_ok = (set(flash_kernels) == {symbol}
                    and flash_kernels[symbol]["count"] == n_self)
        breakdown["busy_share_of_timed_call"] = (breakdown["device_ms"]
                                                 / 1e3 / prefill_s[-1])
        prompt = tokens[:2, :CROSS_GATE_SEQ]
        gate_extra = {k: t[:2] for k, t in extra.items()}
        del tokens, batch
        torch.cuda.empty_cache()
        gate, exact = forward_vs_decode(
            params, dataclasses.replace(cfg, dtype="float32"), prompt,
            torch.float32, extra=gate_extra)
        torch.cuda.empty_cache()
        checks = [gate, forward_vs_decode(params, cfg, prompt,
                                          torch.bfloat16, exact,
                                          extra=gate_extra)[0]]
        legs["forward_vs_decode"] = _clock() - t_arch - sum(legs.values())
        del params, extra, gate_extra
        torch.cuda.empty_cache()
        fa.flash_attention_bhsd.launches = 0
        sr.scored_reduce.launches = 0
        dec_kw = CROSS_DECODE[arch]
        serve_decode.init_model = gated_init
        try:
            dec = serve_decode.run(cfg, **dec_kw)
        finally:
            serve_decode.init_model = real_init
        launches["flash_attention"] += fa.flash_attention_bhsd.launches
        launches["scored_reduce"] += sr.scored_reduce.launches
        peak = torch.cuda.max_memory_allocated()
        legs["serve_decode"] = _clock() - t_arch - sum(legs.values())
        nb, npl, nd = (dec_kw["batch"], dec_kw["prompt_len"],
                       dec_kw["decode_steps"])
        kind = (f"encoder_layers={cfg.encoder.n_layers} n_frames="
                f"{cfg.encoder.n_frames} max_decoder_len="
                f"{cfg.encoder.max_decoder_len}" if cfg.encoder else
                f"cross_attn_every={cfg.vision.cross_attn_every} n_patches="
                f"{cfg.vision.n_patches} d_vision={cfg.vision.d_vision} "
                f"gates={CROSS_GATE}")
        row = {"config": f"{cfg.name} n_layers={cfg.n_layers} d_model="
                         f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}"
                         f" head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff}"
                         f" mlp={cfg.mlp} {kind} vocab={cfg.vocab_size} "
                         f"params={cfg.param_dtype}",
               "params": T.param_count(T.init_model(None, cfg)),
               "weights_bytes": weights, "init_s": init_s,
               "encode_s": encode_s,
               "prefill": {"batch": B, "seq": S, "seconds": prefill_s,
                           "tokens_per_s": [B * S / t for t in prefill_s],
                           "flash_launches_per_call": per_call,
                           "max_memory_allocated": prefill_peak,
                           "bitwise_repeat": all(torch.equal(nxt[0], t)
                                                 for t in nxt[1:])},
               "decode": {**dec_kw, "memory_s": dec["memory_s"],
                          "prefill_s": dec["prefill_s"],
                          "decode_s": dec["decode_s"],
                          "prefill_tokens_per_s": nb * npl / dec["prefill_s"],
                          "decode_tokens_per_s": nb * nd / dec["decode_s"],
                          "ms_per_step": dec["decode_s"] / nd * 1e3},
               "max_memory_allocated": peak, "allocated_before": base,
               "launches": launches, "prefill_breakdown": breakdown,
               "forward_vs_decode": checks, "leg_seconds": legs}
        say("cross serving path " + json.dumps(row))
        toks = dec["tokens"]
        if per_call != [n_self] * len(per_call):
            raise AssertionError(f"{arch}: flash_attention launched "
                                 f"{per_call} times per prefill call, not "
                                 f"{n_self}")
        if not row["prefill"]["bitwise_repeat"]:
            raise AssertionError(f"{arch}: prefill calls on the same weights "
                                 f"gave other tokens: {nxt}")
        if not flash_ok:
            raise AssertionError(f"{arch}: a profiled prefill call ran flash "
                                 f"kernels other than {symbol} once a "
                                 f"self-attention layer: {flash_kernels}")
        if cfg.encoder is not None and not encode_finite:
            raise AssertionError(f"{arch}: the encoder's output is not "
                                 f"finite")
        if not (all(bool(((t >= 0) & (t < cfg.vocab_size)).all())
                    for t in nxt) and toks.shape == (nb, nd)
                and bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
                and bool(torch.isfinite(dec["memory"]).all())):
            raise AssertionError(f"{arch}: the serving path gave tokens "
                                 f"outside the vocabulary or a memory that "
                                 f"is not finite")
        if not (gate["finite"] and gate["allclose"] and gate["tokens_agree"]
                and checks[1]["finite"]):
            raise AssertionError(f"{arch}: forward (flash) and decode "
                                 f"(cache) disagree over the memory: "
                                 f"{checks}")
        del dec
        rows[arch] = row
        torch.cuda.empty_cache()
    return {"flash": flash, "runs": rows}


def grad_errors(got, want, dtype) -> tuple:
    """dq, dk, dv against their plain versions, each on its own: the
    largest error within FLASH_TOL of the gradient's own largest magnitude
    and the error's Frobenius norm within FRO_TOL of its own. With one key,
    dS = P (dp - delta) cancels to rounding noise in dq and dk, so at S = 1
    both are taken over the largest among the three instead. Returns
    (ok, {name: readings, with the gradient's median magnitude})."""
    want = [w.float() for w in want]
    one_key = want[0].shape[-2] == 1
    top = max(float(w.abs().max()) for w in want)
    top_fro = max(float(w.norm()) for w in want)
    ok, out = True, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        e = g.float() - w
        largest, fro = ((top, top_fro) if one_key
                        else (float(w.abs().max()), float(w.norm())))
        r = {"max_abs_err": float(e.abs().max()), "largest": largest,
             "max_err_share": float(e.abs().max()) / largest,
             "fro_err_share": float(e.norm()) / fro,
             "median_abs": float(w.abs().median()),
             "tol": FLASH_TOL[dtype], "fro_tol": FRO_TOL[dtype]}
        ok &= (r["max_err_share"] <= r["tol"]
               and r["fro_err_share"] <= r["fro_tol"]
               and bool(torch.isfinite(g).all()))
        out[name] = r
        del e
    return ok, out


def check_flash_bwd(shape, dtype, causal: bool, timed: bool) -> dict:
    """The backward kernels against their plain version on one draw, with
    the forward's log-sum-exp against the plain one's; timed: the
    backward, its plain version, the backward of
    ``scaled_dot_product_attention`` through autograd on the same inputs,
    and the forward without and with the log-sum-exp, in turns."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    B, H, Hkv, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(S * 131 + H * 7 + D + 1)
    q, do = (torch.randn((B, H, S, D), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((B, Hkv, S, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    lse = torch.empty((B, H, S), device="cuda")
    o = fa.flash_attention_bhsd(q, k, v, causal=causal, lse=lse)
    lse_err = float((lse - fa.flash_attention_plain(
        q, k, v, causal=causal, return_lse=True)[1]).abs().max())

    def kernel():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    got = kernel()
    want = fa.flash_attention_plain_bwd(q, k, v, o, lse, do, causal=causal)
    ok, err = grad_errors(got, want, dtype)
    del want
    ok = ok and lse_err <= LSE_TOL
    same = all(torch.equal(a, b) for a, b in zip(got, kernel()))
    row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "causal": causal, "gradients": err,
           "max_abs_err": max(e["max_abs_err"] for e in err.values()),
           "lse_max_abs_err": lse_err, "ok": ok, "bitwise_repeat": same}
    if timed:
        row["ms"] = time_ms(kernel, 10)
        row["split_ms"] = bwd_split_ms(q, k, v, o, lse, do, causal)
        row["plain_ms"] = time_ms(lambda: fa.flash_attention_plain_bwd(
            q, k, v, o, lse, do, causal=causal), 1, warmup=1)
        torch.cuda.empty_cache()
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        out = F.scaled_dot_product_attention(
            qq, kk, vv, is_causal=causal, scale=D ** -0.5, enable_gqa=True)
        row["library_ms"] = time_ms(lambda: torch.autograd.grad(
            out, (qq, kk, vv), do, retain_graph=True), 5)
        del out, qq, kk, vv
        flops = fa.bound_flops_bwd(q, k, causal=causal)
        nbytes = fa.bound_bytes_bwd(q, k, v)
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        t_ops = flops / peak * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_ms"] = max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["tflop_per_s"] = flops / row["ms"] / 1e9

        def fwd(with_lse):
            return time_ms(lambda: fa.flash_attention_bhsd(
                q, k, v, causal=causal, lse=lse if with_lse else None), 20)
        turns = [fwd(False), fwd(True), fwd(True), fwd(False)]
        row["forward_ms"] = {"without_lse": [turns[0], turns[3]],
                             "with_lse": [turns[1], turns[2]]}
    say("flash_attention_bwd " + json.dumps(row))
    if not (ok and same):
        raise AssertionError(f"flash_attention_bwd disagrees with its plain "
                             f"version or is not repeatable: {row}")
    return row


def bwd_split_ms(q, k, v, o, lse, do, causal: bool) -> dict:
    """Each kernel of the backward alone: CUDA events around separate
    launches of the C entry point, one phase each (the preprocess, the
    main kernel, dq). On the Hopper route the main kernel's turn counters
    are zeroed before each of its runs; that fill is timed apart and taken
    off the main kernel's time."""
    from repro_torch.kernels import flash_attention as fa
    scale = q.shape[-1] ** -0.5
    out = [torch.empty_like(x) for x in (q, k, v)]
    scratch = fa._bwd_scratch(q)
    turns = scratch["turns"]

    def zero():
        if turns is not None:
            turns.zero_()
    zero()
    fa._launch_bwd(q, k, v, o, lse, do, *out, scratch, causal, scale, 7)
    split = {}
    for name, phase in fa.BWD_PHASES.items():
        def run(phase=phase):
            if phase == fa.BWD_PHASES["main"]:
                zero()
            fa._launch_bwd(q, k, v, o, lse, do, *out, scratch, causal,
                           scale, phase)
        split[name] = time_ms(run, 10)
    split["turns_fill"] = time_ms(zero, 10) if turns is not None else 0.0
    split["main"] -= split["turns_fill"]
    return split


def check_flash_model_layout(shape) -> dict:
    """``ops.flash_attention`` forward and backward through autograd on bf16
    model-layout tensors (B, S, H, D), which the kernels read and write
    through strides as the training path has them do, against the plain
    forward and backward on the (B, H, S, D) views of the same inputs."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    B, H, Hkv, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(S + H + D + 5)
    q, do = (torch.randn((B, S, H, D), generator=gen, device="cuda")
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    before = fa.flash_attention_bwd.launches
    ops.flash_attention(qg, kg, vg, causal=True).backward(do)
    torch.cuda.synchronize()
    launched = fa.flash_attention_bwd.launches - before
    bq, bk, bv, bdo = (x.transpose(1, 2) for x in (q, k, v, do))
    o, lse = fa.flash_attention_plain(bq, bk, bv, causal=True,
                                      return_lse=True)
    want = fa.flash_attention_plain_bwd(bq, bk, bv, o, lse, bdo, causal=True)
    ok, err = grad_errors([x.grad.transpose(1, 2) for x in (qg, kg, vg)],
                          want, torch.bfloat16)
    row = {"shape": list(shape), "layout": "B S H D (strided views)",
           "dtype": "bfloat16", "causal": True, "gradients": err,
           "backward_launches": launched, "ok": ok and launched == 1}
    say("flash_attention_bwd model layout " + json.dumps(row))
    if not row["ok"]:
        raise AssertionError(f"ops.flash_attention's gradient on model-layout "
                             f"views disagrees with the plain version: {row}")
    return row


def flash_bwd_phase(ptxas: dict) -> dict:
    """The backward's checks and times; ``ptxas`` is ``build``'s report of
    its Hopper kernel, which must show no spill (a spill serialises every
    wgmma)."""
    t0 = _clock()
    say("flash_attention_bwd ptxas " + json.dumps(ptxas))
    if sorted(ptxas) != ["128", "64"]:
        raise AssertionError(f"the build log holds no ptxas report of the "
                             f"backward's Hopper kernel for both D buckets: "
                             f"{ptxas}")
    spilled = {b: lines for b, lines in ptxas.items()
               if " 0 bytes spill stores, 0 bytes spill loads" not in
               " " + lines[0]}
    if spilled:
        raise AssertionError(f"the backward's Hopper kernel spills: {spilled}")
    main = check_flash_bwd(FLASH_MAIN, torch.bfloat16, causal=True,
                           timed=True)
    main["ptxas"] = ptxas
    torch.cuda.empty_cache()
    main["train_shape"] = check_flash_bwd(BWD_TRAIN, torch.bfloat16,
                                          causal=True, timed=True)
    torch.cuda.empty_cache()
    main["model_layout"] = check_flash_model_layout(BWD_MODEL_LAYOUT)
    torch.cuda.empty_cache()
    for shape in BWD_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                check_flash_bwd(shape, dtype, causal, timed=False)
    say(f"flash_attention_bwd phase: {_clock() - t0:.3f} s")
    return main


def _params_close(a: dict, b: dict, rtol: float) -> tuple:
    """Whether two parameter trees agree leaf by leaf to ``rtol`` with an
    absolute floor of ``rtol`` times the leaf's largest magnitude, and the
    largest error relative to that leaf magnitude."""
    from repro_torch.core.flatten import tree_get, tree_paths
    ok, worst = True, 0.0
    for path in tree_paths(b):
        x, y = tree_get(a, path).float(), tree_get(b, path).float()
        y = y.to(x.device)
        top = float(y.abs().max())
        ok &= bool(torch.allclose(x, y, rtol=rtol, atol=rtol * top))
        worst = max(worst, float((x - y).abs().max()) / max(top, 1e-30))
    return ok, worst


def _train(engine: str, cfg, steps: int = TRAIN_STEPS, **kw):
    """``repro_torch.launch.train.run`` with the flash counts reset just
    before and read just after: (params, history, launches)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import scored_reduce as sr
    from repro_torch.launch import train
    fa.flash_attention_bhsd.launches = 0
    fa.flash_attention_bwd.launches = 0
    sr.scored_reduce.launches = 0
    params, hist = train.run(TRAIN_ARCH, cfg=cfg, engine=engine,
                             steps=steps, log_every=steps, **kw)
    return params, hist, {"flash_attention": fa.flash_attention_bhsd.launches,
                          "flash_attention_bwd": fa.flash_attention_bwd.launches,
                          "scored_reduce": sr.scored_reduce.launches}


def small_train_phase(devices=("cuda", "cpu")) -> list:
    """Reduced configs in float32, every engine for 2 steps on the card and
    on the CPU from the same weights and batches (``train.run``'s weight
    draw and batch draw replaced by CPU draws moved to the device), full
    f32 matrix products on the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_map
    from repro_torch.data import synthetic
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    saved = (train.init_model, train.learnable_sequence_batch,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for arch in TRAIN_SMALL:
            cfg = dataclasses.replace(get_config(arch).reduced(),
                                      dtype="float32")
            tree = tree_map(lambda t: t.numpy(), T.init_model(
                torch.Generator().manual_seed(7), cfg))
            for engine in train.ENGINES:
                res = {}
                for dev in devices:
                    draws = torch.Generator().manual_seed(11)
                    train.init_model = (lambda gen, c, dev=dev:
                                        T.params_from_numpy(tree, c, dev))
                    train.learnable_sequence_batch = (
                        lambda gen, c, b, s, dev=dev, draws=draws: {
                            k: x.to(dev) for k, x in synthetic.
                            learnable_sequence_batch(draws, c, b, s).items()})
                    params, hist, launches = _train(
                        engine, cfg, device=dev, **TRAIN_SMALL_RUN)
                    res[dev] = (params, [h["loss"] for h in hist], launches)
                (gp, gl, gn), (cp, cl, _) = (res[d] for d in devices)
                ok, worst = _params_close(gp, cp, TRAIN_TOL)
                loss_err = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
                ok &= (loss_err <= TRAIN_TOL and gn["flash_attention"] > 0
                       and gn["flash_attention_bwd"] > 0)
                row = {"arch": arch, "engine": engine,
                       "params_rel_err": worst, "loss_rel_err": loss_err,
                       "losses": {"cuda": gl, "cpu": cl}, "launches": gn,
                       "ok": ok}
                say("small train run " + json.dumps(row))
                if not ok:
                    raise AssertionError(f"a training run on the card "
                                         f"drifted from the CPU's: {row}")
                rows.append(row)
    finally:
        (train.init_model, train.learnable_sequence_batch,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return rows


def train_phase() -> dict:
    """The training path at full width (qwen1.5-4b, 8 layers): every
    engine for 5 steps through ``repro_torch.launch.train.run``; then
    exact_tp against fedavg on one step, recompute's first step twice, and
    the small runs card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.flatten import tree_get, tree_paths
    t_phase = _clock()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    out = {"config": f"{cfg.name} n_layers={cfg.n_layers} (of 40) d_model="
                     f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads} "
                     f"head_dim={cfg.resolved_head_dim} d_ff={cfg.d_ff} "
                     f"vocab={cfg.vocab_size} dtype={cfg.dtype}",
           "reduced": "depth 40 -> 8 layers: recompute's five f32 "
                      "parameter-sized trees are ~79 GB at 40",
           "runs": {}}
    chi = 1.0                                     # FLConfig's default
    for engine in ("recompute", "stale", "fedavg", "exact_tp"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = _clock()
        params, hist, launches = _train(engine, cfg,
                                        num_clients=TRAIN_CLIENTS[engine],
                                        **TRAIN_RUN)
        wall = _clock() - t0
        del params
        per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
        want = TRAIN_LAYERS * TRAIN_PASSES[engine]
        row = {"engine": engine, "clients": TRAIN_CLIENTS[engine],
               "history": hist, "step_s": [h["step_s"] for h in hist],
               "seconds": wall, "max_memory_allocated":
               torch.cuda.max_memory_allocated(), "launches": launches,
               "launches_per_step": per_step,
               "tokens_per_s": [TRAIN_RUN["batch"] * TRAIN_RUN["seq"]
                                / h["step_s"] for h in hist]}
        out["runs"][engine] = row
        say("training run " + json.dumps(row))
        losses = [h["loss"] for h in hist]
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"{engine}: the loss did not fall: "
                                 f"{losses}")
        if per_step["flash_attention"] != want or \
                per_step["flash_attention_bwd"] != want:
            raise AssertionError(f"{engine}: flash launched {per_step} a "
                                 f"step, not {want} forward and backward")
        if engine == "recompute" and not all(
                (chi - 1) / (chi + 1) <= h["lambda_min"]
                <= h["lambda_max"] <= 1 + 1e-6 for h in hist):
            raise AssertionError(f"recompute's lambdas left [0, 1]: {hist}")
    torch.cuda.empty_cache()
    # exact_tp on one row is fedavg up to its lambda (one step, same
    # weights and batch); recompute's first step repeats bit for bit
    tp, tp_hist, _ = _train("exact_tp", cfg, steps=1, **TRAIN_RUN)
    fedavg, _, _ = _train("fedavg", cfg, steps=1, **TRAIN_RUN)
    same_ok, same_err = _params_close(tp, fedavg, 1e-6)
    del tp, fedavg
    torch.cuda.empty_cache()
    a, _, _ = _train("recompute", cfg, steps=1, num_clients=4, **TRAIN_RUN)
    b, _, _ = _train("recompute", cfg, steps=1, num_clients=4, **TRAIN_RUN)
    rerun = all(torch.equal(tree_get(a, p), tree_get(b, p))
                for p in tree_paths(a))
    del a, b
    torch.cuda.empty_cache()
    out["fedavg_step"] = fedavg_step_breakdown(cfg)
    out["exact_tp_vs_fedavg"] = {"ok": same_ok, "max_rel_err": same_err,
                                 "lambda": tp_hist[0]["lambda_mean"]}
    out["recompute_rerun_bitwise"] = rerun
    say("training checks " + json.dumps(
        {k: out[k] for k in ("exact_tp_vs_fedavg",
                             "recompute_rerun_bitwise")}))
    if not (same_ok and rerun):
        raise AssertionError(f"exact_tp left fedavg or recompute did not "
                             f"repeat: {out['exact_tp_vs_fedavg']}, {rerun}")
    out["small"] = small_train_phase()
    out["seconds"] = _clock() - t_phase
    say(f"training phase: {out['seconds']:.3f} s")
    return out


def fedavg_step_breakdown(cfg) -> dict:
    """Where a full-width training step's device time goes: one warm
    fedavg step (its own forward and backward, nothing else), timed and
    then profiled by kernel group."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.core.pod import make_fedavg_train_step
    from repro_torch.data.synthetic import learnable_sequence_batch
    from repro_torch.models.transformer import init_model
    gen = torch.Generator(device="cuda").manual_seed(TRAIN_RUN["seed"])
    params = init_model(gen, cfg)
    batch = learnable_sequence_batch(gen, cfg, TRAIN_RUN["batch"],
                                     TRAIN_RUN["seq"])
    step = make_fedavg_train_step(cfg, FLConfig(kappa_max=1,
                                                local_lr=TRAIN_RUN["lr"]))
    step(params, batch)                          # warm-up
    t0 = _clock()
    step(params, batch)
    step_s = _clock() - t0
    row = device_breakdown(lambda: step(params, batch))
    row["step_s"] = step_s
    row["busy_share_of_timed_step"] = row["device_ms"] / 1e3 / step_s
    del params
    torch.cuda.empty_cache()
    say("fedavg step breakdown " + json.dumps(row))
    # the step's backward (bf16, D = 128) takes the Hopper route: each of
    # its kernels once a layer, and no kernel of another route
    counts = {sym: got["count"] for sym, got in
              row["flash_bwd_kernels"].items()}
    if counts != {sym: cfg.n_layers for sym in FLASH_BWD_HOPPER}:
        raise AssertionError(f"the fedavg step's flash backward ran "
                             f"{counts}, not each of {FLASH_BWD_HOPPER} "
                             f"{cfg.n_layers} times and nothing else")
    return row


def timed(label: str, fn, *args):
    """``fn(*args)``; prints its wall seconds as ``phase <label>: <s> s``."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    kind, smi = card()
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    # every nvcc starts now; the FL phases need only scored_reduce's build
    flash_future = start_flash_build()
    timed("2 build", build)
    kern = timed("3 kernels", kernels_phase)
    small_loop = timed("4 small runs", small_run_phase)
    timed("4 conv precision", conv_precision_phase)
    main = timed("5 main path", fl_run, "main path", "osafl", MAIN_RUN,
                 MAIN_EVAL)
    list_api = timed("5b list api", list_api_phase)
    loop = timed("5c loop engine", fl_run, "loop engine", "osafl", LOOP_RUN,
                 MAIN_EVAL)
    timed("6 breakdown", breakdown_phase, MAIN_RUN)
    grid = timed("6b grid", grid_phase, main)
    determinism = timed("6c determinism", determinism_phase, grid)
    for alg, kw in GRID_RUNS:
        if kw["model"] != "fcn":
            timed(f"6 breakdown {kw['model']}", breakdown_phase, kw)
    requests = timed("6d requests", requests_phase, main)
    stacked_small = timed("6d small stacked", small_run_phase,
                          STACKED_SMALL)
    f32 = timed("6e f32 solve", f32_solve_phase)
    ckpt = timed("6f checkpoint", checkpoint_phase)
    loop_resume = timed("6f loop resume", loop_resume_phase)
    timed("6 breakdown stacked requests", breakdown_phase,
          dict(MAIN_RUN, request_backend="stacked"))
    cohorts = timed("6g cohorts", cohort_phase)
    pods = timed("6i pod", pod_phase, main, grid)
    mesh = timed("6j pod mesh", pod_mesh_phase, main, pods, grid)
    fused = timed("6h fused", fused_phase)
    ptxas = timed("2 flash build", flash_build, flash_future)
    flash = timed("3 flash", flash_phase, ptxas["fwd"])
    timed("4 small transformer", small_transformer_phase)
    serving = timed("7 serving", serving_phase)
    moe_serving = timed("7b moe serving", moe_serving_phase)
    recurrent = timed("7c recurrent serving", recurrent_serving_phase)
    cross = timed("7d cross serving", cross_serving_phase)
    bwd = timed("8 flash backward", flash_bwd_phase, ptxas["bwd"])
    training = timed("8 training", train_phase)
    m = kern["main"]
    # each path's own counts, each read after a reset: the FL main path,
    # every run of the grid (the main path's among them) and its
    # determinism reruns, the loop engine at full width and its small runs,
    # each server round of the list API, and the serving path; "launches"
    # is the count of the kernel's own main path
    by_path = {k: {"fl_main": main["launches"][k],
                   "grid": {f"{g['alg']} {g['config']['model']}":
                            g["launches"][k] for g in grid},
                   "determinism": [g["launches"][k] for g in determinism],
                   "loop_fl": loop["launches"][k],
                   "list_api": {f"{r['alg']} {e}": r[f"{e}_launches"][k]
                                for r in list_api["rounds"]
                                for e in ("loop", "stacked")},
                   "requests": {
                       f"{r['config'].get('request_backend', 'python')} "
                       f"{i}": r["launches"][k]
                       for i, r in enumerate(requests["runs"])},
                   "presets": {f"{name} {r['config']['model']}":
                               r["launches"][k] for (name, _), r in
                               zip(PRESET_RUNS, requests["presets"])},
                   "f32_fl": f32["fl"]["launches"][k],
                   "checkpoint": [r["launches"][k] for r in ckpt["runs"]],
                   "loop_resume": [r["launches"][k]
                                   for r in loop_resume["runs"]],
                   "serving": serving["launches"][k]}
               for k in ("scored_reduce", "flash_attention")}
    for path in dict(COHORT_RUNS):
        for k in by_path:
            got = [row["launches"][k] for n, row in cohorts["runs"]
                   if n == path]
            by_path[k][path] = got[0] if len(got) == 1 else got
    by_path["scored_reduce"]["cohort_small"] = cohorts["small"]
    by_path["scored_reduce"]["hier_resume"] = [
        r["launches"]["scored_reduce"] for r in cohorts["resume"]["runs"]]
    by_path["scored_reduce"]["loop_small"] = small_loop
    by_path["scored_reduce"]["stacked_small"] = stacked_small
    for k in by_path:
        by_path[k]["fused"] = [r["launches"][k] for r in fused["runs"]]
        by_path[k]["fused_fig1"] = fused["fig1"]["launches"][k]
        by_path[k]["serve"] = fused["serve"]["trainer"]["launches"][k]
    for k in by_path:
        for arch, row in moe_serving["runs"].items():
            by_path[k][f"moe_serving {arch}"] = row["launches"][k]
        for arch, row in recurrent["runs"].items():
            by_path[k][f"recurrent_serving {arch}"] = row["launches"][k]
        for arch, row in cross["runs"].items():
            by_path[k][f"cross_serving {arch}"] = row["launches"][k]
        for engine, row in training["runs"].items():
            by_path[k][f"train_{engine}"] = row["launches"][k]
    for k in by_path:
        for run_name, row in pods["runs"].items():
            by_path[k][f"pod {run_name}"] = row["launches"][k]
        by_path[k]["pod_resume"] = [r["launches"][k]
                                    for r in pods["resume"]["runs"]]
        by_path[k]["fl_examples"] = pods["examples"]["launches"][k]
        for group in ("gloo", "nccl"):
            for label, rows in mesh[group].items():
                by_path[k][f"pod_mesh {group} {label}"] = [
                    r["launches"][k] for r in rows]
        for label, row in mesh["one"].items():
            by_path[k][f"pod_mesh one process {label}"] = row["launches"][k]
    by_path["scored_reduce"]["pod_small"] = pods["small"]
    by_path["scored_reduce"]["fused_small"] = fused["small"]
    by_path["scored_reduce"]["fused_parity_warm_segment"] = [
        p["warm_segment"]["scored_reduce_launches"] for p in fused["parity"]]
    line = {"kernels": [{
        "name": "scored_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scored_reduce.cu",
        "replaces": "src/repro/kernels/scored_reduce.py:32",
        "launches": main["launches"]["scored_reduce"],
        "launches_by_path": by_path["scored_reduce"],
        "max_abs_err": max(m["max_abs_err"].values()),
        "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"], "library_ms": m["library_ms"],
        "in_graph_ms": fused["in_graph"]["graph_ms"],
        "mesh_block_shape": {
            "launches_per_rank": by_path["scored_reduce"][
                "pod_mesh gloo osafl exact_tp global_lr=1"],
            **{key: mesh["block"][key] for key in (
                "U", "N", "max_abs_err", "bitwise_repeat", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "share_of_bound")}},
        # each rank's cluster blocks and tier-2 aggregates over two rows
        "mesh_cluster_shapes": {
            "launches_per_rank": {
                label: by_path["scored_reduce"][f"pod_mesh gloo {label}"]
                for label, *_ in MESH_CLUSTER_RUNS},
            **{f"({U}, N)": {key: mesh["shapes"][U][key] for key in (
                "U", "N", "max_abs_err", "bitwise_repeat", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "share_of_bound")} for U in (MAIN_U // CLUSTERS,
                                             CLUSTERS)}}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": serving["launches"]["flash_attention"],
        "launches_by_path": by_path["flash_attention"],
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "ptxas": flash["ptxas"],
        "mla_prefill_shape": {
            "launches": by_path["flash_attention"][
                "moe_serving deepseek-v3-671b"],
            **{key: moe_serving["mla_flash"][key] for key in (
                "shape", "dv", "symbol", "max_abs_err", "bitwise_repeat",
                "ms", "ms_in_turns", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "share_of_bound", "padded_mma_sync_ms",
                "padded_mma_sync_ms_in_turns", "padded_max_abs_diff")}},
        "zamba_prefill_shape": {
            "launches": by_path["flash_attention"][
                "recurrent_serving zamba2-2.7b"],
            **{key: recurrent["zamba_flash"][key] for key in (
                "shape", "symbol", "max_abs_err", "bitwise_repeat", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "share_of_bound")}},
        **{f"{arch}_prefill_shape": {
            "launches": by_path["flash_attention"][f"cross_serving {arch}"],
            **{key: cross["flash"][arch][key] for key in (
                "shape", "symbol", "max_abs_err", "bitwise_repeat", "ms",
                "plain_ms", "library_ms", "bound_ms", "bound_by",
                "share_of_bound")}} for arch in CROSS_SERVE}}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": sum(r["launches"]["flash_attention_bwd"]
                        for r in training["runs"].values()),
        "launches_by_path": {
            **{f"train_{e}": r["launches"]["flash_attention_bwd"]
               for e, r in training["runs"].items()},
            "train_small": [r["launches"]["flash_attention_bwd"]
                            for r in training["small"]]},
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"],
        "split_ms": bwd["split_ms"], "ptxas": bwd["ptxas"]}]}
    say(smi)                        # the card's name and power limit
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
