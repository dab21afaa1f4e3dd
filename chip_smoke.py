#!/usr/bin/env python3
"""Build the port's CUDA kernels and drive its LaneGCN eval and train paths on
one GPU, on each of the three LaneGCN pack geometries the port serves, then
its LaneRCNN eval and train paths, then LaneGCN with the window plan inside
the LaneConv layer kernel, with the unfused LaneConv layer, and on packs
without band masks; then its CLI (train, preempt and resume, eval,
preprocess), its loader, its Argoverse reader (scenario CSVs into both
models, the raster path, segment_softmax) and its multi-GPU split (on the
one card).

    python3 chip_smoke.py            # one card, no arguments
    python3 chip_smoke.py mesh-witness   # the build, then mesh_witness_phase alone

It also serves and trains the half-width LaneGCN (n_map = n_actor = 64) on
the bench layout, its kernels at W = 64 both ways, and in the two other
layer settings: merged (lane_plan) and unfused (band_conv) at W = 64; and
serves the double-width LaneGCN (n_map = n_actor = 256) on the CLI's
layout, its three forward kernels at W = 256.

Geometries (lanegcn_tpu_torch/config.py), driven in this order:
  windowed    windowed_pack_config(256): node_stride 768, window plan 2048,
              actor_stride 128, fusion pair plans, spill_pairs off (the
              plan's residue rides the classic lists).
  bench       bench_pack_config(256), the headline: the same layout with
              spill_pairs on (the residue rides the spill plan, pair_agg).
  contiguous  contiguous_pack_config(32), the CLI's default: no windows,
              left/right neighbour tables, flat fusion lists (edge_mlp).
  lanercnn    lanercnn_pack_config(256), LaneRCNN (get_model("lanercnn"):
              AdamW, weight decay 0.01): 256-row RoI windows with an
              ungrouped 512-slot plan, 768-row global windows with a
              2048-slot plan, window-chunked pool edges (window_scatter),
              LanePooling's edge chain (edge_mlp_pool) and two-Linear tail
              (row_tail2), each with its backward kernel.
  merged      bench_pack_config(256) with ModelConfig(merge_plan_agg="auto"):
              the window plan runs inside the LaneConv layer kernel
              (lane_plan and lane_plan_bwd) in place of lane_layer and
              scenario_agg.
  unfused     windowed_pack_config(256) with ModelConfig(pallas_bands="off"):
              the unfused LaneConv layer, band_conv (and band_conv_bwd)
              then the row tail, in place of lane_layer.
  flat        flat_pack_config(32) packed with split_bands=False,
              split_tables=False, scenario_plan=False (the JAX CLI's
              explicit graph-parallel pack): no band masks, tables or
              plan; every relation rides the residue lists and each
              LaneConv layer runs the row tail.
  widths      contiguous_pack_config(32) with ModelConfig(n_actor=64):
              128-wide lanes beside a 64-wide actor branch. A2M is
              Att(128, 64) and M2A Att(64, 128), which take the
              unequal-width branch (the edge chain as PyTorch products,
              then the scatter and the row tail at n_agt's width); A2A is
              Att(64, 64): edge_mlp and row_tail at width 64.
  half        bench_pack_config(256) with ModelConfig(n_map=64, n_actor=64):
              lane_layer, scenario_agg, pair_agg, win_edge, row_tail and
              their backwards all at W = 64 (the bench launches).
  half_merged  merged at n_map = n_actor = 64: lane_plan and lane_plan_bwd
              (lane_plan_tc_kernel<64>, msg_tc_kernel<false, WindowPlan,
              bf16, 64>, band_t_tc_kernel<float, true, 64>) in place of
              lane_layer and scenario_agg, pair_agg, win_edge and row_tail
              at 64 (the merged launches).
  half_unfused  unfused at n_map = n_actor = 64: band_conv and band_conv_bwd
              (band_conv_tc_kernel<64>, band_t_tc_kernel<bf16, false, 64>,
              band_dw_tc_kernel<64>) then the row tail, in place of
              lane_layer (the unfused launches).
  half_lanercnn  lanercnn at n_map = n_actor = 64: every LaneRCNN kernel at
              W = 64 both ways, window_scatter, row_tail2 and
              edge_mlp_pool among them (the lanercnn launches).
  double      contiguous at n_map = n_actor = 256, full depth: lane_layer,
              Att's edge_mlp and row_tail at W = 256 both ways
              (csrc/wide.cuh's and csrc/wide_bwd.cuh's kernels; the
              contiguous launches); every phase of contiguous, then
              serve_rerun and refused_serve.

Phases, one JSON line each (tagged with the geometry); any failure raises
and exits non-zero:
  env     torch / CUDA / Triton / nvcc versions, the card's name and power
          limit, and the kernels' build time (one nvcc per source, in
          parallel), with ptxas's registers and spills of the 256-wide
          kernels (`ptxas_wide`).
  pack    2 packs of synthetic urban scenarios, zero drops asserted; the
          edges left in the classic residue lists and, on the bench
          geometry, the spill-plan edges (asserted > 0); on lanercnn the
          RoIs, RoI, interest and global nodes, pool edges (live against
          capacity) and plan and residue edges of both node spaces, zero
          `dropped_*` and `graph_dropped_*` asserted.
  kernel  each kernel the geometry runs at shapes of its own, against its
          plain PyTorch version on the inputs the eval path hands it
          (captured from one forward), in float32 (TF32 off) and bfloat16:
          the error beside its tolerance and the output's scale, kernel and
          plain times (CUDA events, median of 25 runs), and the bound from
          the work these inputs need; lane_layer's and lane_plan's saved
          fp32 temp against the plain temp. windowed: lane_layer (and its
          edge cases, `LANE_ROWS`: its largest call cut to 1, 191 and 193
          rows, around the bf16 kernel's 192-row blocks, and to 385 rows
          with one relation's band mask all zero; each without and with
          the saved temp), scenario_agg (and its edge cases, `PLAN_CASES`: an empty plan,
          whose output must be temp bitwise, one relation only, relation
          runs that straddle the kernels' 64-edge tiles, a window with all
          2,048 slots applied, 300 edges into one row, a grouped plan that
          drops misplaced edges), win_edge (and `WIN_CASES`: an empty plan,
          whose output must be temp bitwise, a destination window no edge
          reaches, tail chunks all padding, runs of many chunks, runs of
          one chunk), row_tail (and `TAIL_ROWS`: its largest call cut to
          1, 63 and 65 rows, around the bf16 kernel's 64-row tiles); bench:
          pair_agg (and `SPILL_CASES`: an empty spill plan, whose output
          must be temp bitwise, tail chunks all padding, a relation with
          one edge beside relations with none, rows past n, runs of one
          chunk, one window's run of many chunks, 1,536-row windows) and
          row_tail; contiguous: lane_layer (no
          node windows), row_tail (A2M and 512 actor rows) and edge_mlp
          (and `EDGE_ROWS`: 1, 63, 65 and 12,345 rows, and an all-padding
          call, whose rows must all equal row 0);
          lanercnn: lane_layer and scenario_agg at the RoI and global
          shapes, window_scatter (both pool scatters, beside one `index_add`
          call on the same inputs, and `SCATTER_CASES`: an empty plan, whose
          output must be temp bitwise, a window no edge reaches, tail
          chunks all padding, a run over three chunks, runs across 128-row
          blocks, a 200-row stride), row_tail2 (its three row counts, and
          `TAIL_ROWS`: 1, 63, 65 and 12,345 rows) and edge_mlp_pool (and
          `EDGE_ROWS` and an all-padding call, as edge_mlp's);
          merged: lane_plan (and `PLAN_CASES`, each with random band masks
          over ±1 .. ±32 shifts and tail weights, `PLAN_SHIFTS`: windows of
          256, 512, 768 and 1,024 rows, which its bf16 kernel's 192-row
          blocks straddle) and row_tail; unfused: band_conv (and
          `LANE_ROWS`' cuts of its largest call, around the bf16 kernel's
          192-row blocks, and 385 rows with relation 0's band mask all
          zero) and row_tail (the LaneConv tails at N rows beside Att's); flat:
          row_tail (the LaneConv tails); widths: row_tail at 128 (A2M) and
          64 (M2A, A2A; and `TAIL_ROWS` cut from the largest 64-wide call)
          and edge_mlp at 64 (A2A; `EDGE_ROWS` and the all-padding call);
          half: lane_layer (and `LANE_ROWS`' cuts), scenario_agg, pair_agg,
          win_edge and row_tail (and `TAIL_ROWS`' cuts), all at W = 64;
          half_merged: lane_plan (and `PLAN_CASES` at W = 64) and row_tail;
          half_unfused: band_conv (and `LANE_ROWS`' cuts) and row_tail, at
          W = 64.
  kernel_bwd  the same kernels' backwards against their plain backwards on
          the inputs and cotangent one bf16 train step hands them, with a
          rerun that must be bitwise equal (lanercnn: lane_layer_bwd and
          scenario_agg_bwd at the RoI and global shapes, window_scatter_bwd
          beside one `index_select` call and on `SCATTER_CASES` (the empty
          plan's gradient all zero), row_tail2_bwd, edge_mlp_pool_bwd
          with `EDGE_ROWS` and the all-padding call, whose outputs must all
          be zero; contiguous and double (W = 256): edge_mlp_bwd likewise;
          merged: lane_plan_bwd (and `PLAN_CASES`); unfused: band_conv_bwd;
          half_merged and half_unfused: the same at W = 64 (band_conv_bwd's
          cuts also to `RAGGED_NARROW_ROWS`);
          widths: row_tail_bwd at 128 and 64 and edge_mlp_bwd at 64, with
          `EDGE_ROWS`, the all-padding call and the 64-wide row_tail_bwd
          cut to `RAGGED_NARROW_ROWS`;
          windowed: scenario_agg_bwd on `PLAN_CASES` too, and win_edge_bwd on
          `WIN_CASES`; bench: pair_agg_bwd on `SPILL_CASES` too; half: the
          five backwards at W = 64, pair_agg_bwd on `SPILL_CASES` at 64
          too, lane_layer_bwd's cuts also to `RAGGED_NARROW_ROWS`), and
          lane_layer_bwd, band_conv_bwd, row_tail_bwd and row_tail2_bwd
          again on their largest call cut to 1,000 and 20,000 rows
          (`RAGGED_ROWS`: no multiple of their tensor-core passes' row
          blocks), row_tail2_bwd also to 1, 63, 65, 127 and 129 rows
          (`RAGGED_EXTRA_ROWS`: around its 64-row chain tiles and 128-row
          weight-gradient tiles). A few rows whose
          ReLU pre-activation ties at zero on the plain side (see TIE_EPS)
          may get a zero cotangent before the comparison.
  kernel_step  segment_sum on every call shape of that train step (the
          scatters' forwards and the gathers' backwards), fp32 and bf16, a
          bitwise rerun, beside one `index_add` call on the same inputs; on
          the windowed geometry also the edge cases of its block partition
          (`SEGMENT_CASES`: a run longer than a block's rows, runs across
          block boundaries, every edge dropped, no edges, a row count that
          is no multiple of the block's, rows of 6 channels, 128-row
          blocks), each with and without `out`.
  parity  the full float32 forward + loss on the card (kernels) against the
          same on the CPU (plain versions), 8 scenarios of the geometry,
          same weights; on lanercnn the segmented-NMS picks must be equal,
          beside the smallest logit gap around them.
  train_parity  one float32 make_train_step on 8 scenarios on the card and on
          the CPU from the same weights: the loss, every parameter's gradient
          (same names, none missing) and the parameters after the step (the
          share of elements apart, beside a control with perturbed
          gradients). Where a leaf misses and a ReLU tie is confirmed (an
          input within rounding of zero that a CPU step from parameters
          moved by `TIE_PERTURB` puts on the other side, that move carries
          a missing leaf past its tolerance, and it reproduces the card's
          miss: every leaf that missed lies within tolerance of the moved
          step), the whole step is held to the moved CPU step
          (`reference`); every move tried is printed (`tie_tries`). On
          lanercnn (AdamW) the NMS picks must be equal.
  serve   make_eval_step in bfloat16 over the 2 packs, several rounds: ms per
          pack, scen/s, loss/ade/fde/mr, peak device memory, and the kernel
          launch counts of that run, asserted per forward (the geometry's
          `per_forward` in GEOMETRIES).
  profile device time by kernel name over one forward per pack (torch.profiler,
          after the counted serve run), the device's idle share and the host
          syncs (nonzero / item calls) per step; none of either asserted.
  train   make_train_step in bfloat16 over fp32 params on the 2 packs: 2 warm
          steps, then 10 steps alternating the packs: ms per step, scen/s,
          first and last loss (finite), skipped steps (0), peak device
          memory, and the launch counts, asserted per step (`per_train_step`).
  remat   (lanercnn) one train step with remat=False and one with remat=True
          from the same weights on the same pack: the losses bitwise equal,
          both steps' NMS picks equal (with the smallest logit gap), each
          step's peak memory (remat's must be lower), the remat step's
          launches with the LanePooling forwards doubled (`per_remat_step`).
  profile_train  the same profile over one train step.
  rerun   two bf16 train steps from the same fresh weights on the same pack:
          loss, every gradient and every parameter after the step bitwise
          equal; then one under torch.use_deterministic_algorithms(True,
          warn_only=True), listing what PyTorch flags as nondeterministic.
  ab      (merged, unfused, half_merged, half_unfused) the device busy
          time per serve forward and per train step of two settings of one
          ModelConfig field, same packs and weights, profiled in turns:
          merged, the separate kernels against the merged layer
          (merge_plan_agg); unfused, the fused layer against the unfused
          one (pallas_bands).
  serve_rerun  (half, double) two bf16 eval forwards of one pack bitwise
          equal.
  refused_train  (half_lanercnn) one bf16 train step of the same model
          with the geometry's `refused` fields (n_map = n_actor = 96, a
          width no kernel takes): it must raise ValueError naming the
          first width-checked kernel it reaches (`NARROW_REFUSED`:
          scenario_agg, in LaneRoI's first LaneConv layer) and the width,
          after no launch but the any-width segment sum's, that kernel's
          entries never launched, no backward launched, no plain version
          of the refusing kernel or plain backward run on the card.
  refused_serve  (double) one bf16 eval forward of the double-width model on 8
          scenarios of the bench layout: it must raise ValueError at
          scenario_agg (`WIDE_REFUSED_SERVE`) after only segment sums.
After the geometries, phases without a geometry:
  cli     python -m lanegcn_tpu_torch.cli as a user runs it (bf16, 2 pack
          workers, packs of 32): preprocess 128 urban scenarios to shards
          (a subprocess; meanwhile LaneRCNN's fp32 forward at the CLI's
          RoI pack, card against CPU, zero drops, equal NMS picks, tagged
          cli_lanercnn); train R1 for 2 epochs with validation, in this
          process with every launch count from 0 (asserted: 8 steps and 2
          forwards of the contiguous geometry's counts); R2, the same run
          as a subprocess, sent SIGTERM after its 5th step line (exit 0,
          'SIGTERM: saved'), then resumed: its 2.000.ckpt bitwise R1's
          (state_dict, flat_adam, step); eval by --weight and by
          --torch-weight (subprocesses) print R1's last validation lines,
          and the submission holds 64·6·30 rows; one epoch of LaneRCNN at
          the CLI's RoI pack (launches counted, lane_layer, row_tail2,
          edge_mlp_pool and segment_sum asserted). Every step line finite,
          none with a drop. Prints the warm step ms and scen/s from the
          logs' time and the launches per step of both families.
  loader  PackedLoader (to_device) into the bench train step
          (bench_pack_config(256), bf16) on 512 urban scenarios made
          once with their pack caches: 2 epochs of 2 packs with 1, 2, 4, 4,
          2 and 1 pack workers; scen/s (the first pack left out), host pack s and
          transfer ms per pack, the same steps' scen/s on the packs already
          on the card; zero drops; losses bitwise equal across worker
          counts.
  argoverse  the Argoverse reader (lanegcn_tpu_torch/data/argoverse.py): 256
          scenario CSVs written from the synthetic urban worlds (7
          corridors, 16 actors; UUID-style TRACK_IDs, shuffled rows, 0.1 s
          timestamps, repr floats; a process pool), read back through
          ArgoScenarioDataset with `WorldMap` (each world's lanes with a
          centerline point within the Manhattan radius) as the map: host s
          per scenario to read and build, lanes out of the radius and
          clipped by pred_range; every scenario bitwise the same world
          built without the CSV, its actor leaves bitwise
          make_urban_scenario's (the whole dict where no lane was left
          out). LaneGCN through PackedLoader(to_device) on
          bench_pack_config(256), bf16: 2 packs served and 3 train steps,
          zero drops, the bench launches, the packs, outputs and losses
          bitwise those of the worlds built without the CSV. LaneRCNN with
          RoIs on lanercnn_pack_config(256), 192 scenarios a pack: one
          serve and one train step, zero drops of both kinds and no skipped
          scenario, its launches. Then fp32, card against CPU within
          TOL["float32"]: segment_softmax on A2M-sized inputs (one
          segment_sum launch), get_pixel_feat and get_roi_feat on a
          RasterMapQuery raster of one scenario, Conv2dBlock and PostRes
          (stride 2, with downsample) on the RoI crops. The phase's seconds.
  mesh    the multi-GPU trainer (lanegcn_tpu_torch/parallel/); first the
          windowed data×graph split:
          (a) 3 bf16 steps of the windowed step in a one-rank NCCL world
          (bench_pack_config(256), full width) against make_train_step
          from the same weights on the same packs: loss, metrics, every
          gradient and the parameters bitwise equal, the bench launches a
          step; (b) two ranks (torch.multiprocessing spawn, tcp init) on
          the one card over gloo (NCCL on two cards where the machine has
          them), fp32, one SGD step (lr 0.1) each: LaneGCN at D=1×G=2
          (one group of 256 split by balance_scenarios, packed at the
          mesh's subdivided capacities) and D=2×G=1 (two packs of 256),
          LaneRCNN at D=1×G=2 (lanercnn_pack_config(256)), against the
          single-device step on the union packs (the columns' scenarios
          in column order) or the mean of the rows' steps: the loss within
          MESH_LOSS_RTOL, the support counts equal, the mean gradient and
          each rank's SGD update within MESH_TOL/MESH_RMS_TOL of the
          reference's scale, both ranks' parameters equal, zero drops of
          both kinds, each rank's launches those of the single-device step;
          (c) `python -m torch.distributed.run --nproc-per-node 1 -m
          lanegcn_tpu_torch.cli train --mesh 1x1` (contiguous packs of 32,
          bf16, 2 pack workers, 2 epochs of urban:64): a run beside a
          second one sent SIGTERM to its worker after its 2nd step line
          (both exit 0), then resumed: its 2.000.ckpt bitwise the first
          run's. Each run's step ms by host clock and device busy, its
          collectives a step and their bytes, and peak memory (gloo's
          times are not NCCL's). Then the explicit graph-parallel split
          (--graph-parallel explicit) on the first 32 scenarios of each
          family, LaneGCN on flat_pack_config(32), LaneRCNN on the CLI's
          flat RoI pack: (a) a one-rank NCCL world, an fp32 step within
          the train_parity tolerances of make_train_step and 3 bf16 steps
          bitwise on a rerun (each also reported bitwise against
          make_train_step), the launches a step of the kernels the
          explicit layers run (row_tail, row_tail2, edge_mlp with Att's
          and LanePooling's flags, segment_sum) and the collectives
          against their predicted calls and bytes; (b) two ranks over
          gloo at D=1×G=2, fp32 SGD, checked as the windowed (b) against
          the single-device step on the whole pack, with each rank's live
          rows and edges; (c) the CLI at --mesh 1x1 --graph-parallel
          explicit --bf16 on urban:64, preempted and resumed bitwise, no
          drop in its log. The part's seconds are printed.
Then the seconds of each geometry and phase (`seconds`), the `kernels`
summary line (all 23 kernels, each from the first geometry that checks
it, with the launches of that geometry's serve or train run, and under
`also_checked` its checks on the later geometries; `by_width` gives each
row width a kernel was checked at, 128 and, for row_tail, row_tail_bwd,
edge_mlp and edge_mlp_bwd (widths), lane_layer, scenario_agg, pair_agg,
win_edge, row_tail and their backwards (half), lane_plan and lane_plan_bwd
(half_merged), band_conv and band_conv_bwd (half_unfused), window_scatter,
row_tail2, edge_mlp_pool and their backwards (half_lanercnn), 64, and for
lane_layer, edge_mlp, row_tail and their backwards (double), 256, with the
geometry that checked it),
the nvidia-smi name/power-limit line, and last the `ok` line with the
device.

Weights are random (seeded); no dataset or checkpoint is needed.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense): bf16 tensor-core rate and HBM rate.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel-vs-plain tolerances, scaled by the plain output's RMS (its typical
# magnitude: the maximum of an accumulated sum can be many times larger).
# Each element: |kernel − plain| ≤ TOL · (rms + |plain|). Over the output:
# rms(kernel − plain) ≤ RMS_TOL · rms.
# float32: both sum 128-term products in fp32 in different orders, and the
# GroupNorms divide by row deviations; 1e-4 per element and 1e-5 in RMS
# leave ~100x room over the expected 1e-7..1e-6 reorder error.
# bfloat16: both round the same intermediates to bf16, but a reorder can
# flip one rounding (one bf16 ulp = 2^-8 relative), which then propagates
# through a GN and a product; 3e-2 is ~8 ulps per element. Flips are rare,
# so over the output the error stays near one final rounding (~2^-9 RMS):
# 1e-2 (~2.5 ulps RMS) holds it there, where a wrong bf16 load or store
# gives an RMS error of order 1.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
RMS_TOL = {"float32": 1e-5, "bfloat16": 1e-2}

# name: (source, TPU kernel it replaces, C entry points whose launches it counts)
KERNEL_META = {
    "lane_layer": ("lanegcn_tpu_torch/csrc/lane_layer.cu",
                   "lanegcn_tpu/ops/pallas_lane_layer.py:254", ("lane_layer_fwd",)),
    "scenario_agg": ("lanegcn_tpu_torch/csrc/scenario_agg.cu",
                     "lanegcn_tpu/ops/pallas_scenario_agg.py:252", ("scenario_agg_fwd",)),
    "win_edge": ("lanegcn_tpu_torch/csrc/win_edge.cu",
                 "lanegcn_tpu/ops/pallas_win_edge.py:262", ("win_edge_fwd",)),
    "row_tail": ("lanegcn_tpu_torch/csrc/row_tail.cu",
                 "lanegcn_tpu/ops/pallas_row_tail.py:152", ("row_tail_fwd",)),
    "lane_layer_bwd": ("lanegcn_tpu_torch/csrc/lane_layer.cu",
                       "lanegcn_tpu/ops/pallas_lane_layer.py:303", ("lane_layer_bwd",)),
    "scenario_agg_bwd": ("lanegcn_tpu_torch/csrc/scenario_agg.cu",
                         "lanegcn_tpu/ops/pallas_scenario_agg.py:292", ("scenario_agg_bwd",)),
    "win_edge_bwd": ("lanegcn_tpu_torch/csrc/win_edge.cu",
                     "lanegcn_tpu/ops/pallas_win_edge.py:316", ("win_edge_bwd",)),
    "row_tail_bwd": ("lanegcn_tpu_torch/csrc/row_tail.cu",
                     "lanegcn_tpu/ops/pallas_row_tail.py:169", ("row_tail_bwd",)),
    "pair_agg": ("lanegcn_tpu_torch/csrc/pair_agg.cu",
                 "lanegcn_tpu/ops/pallas_pair_agg.py:138", ("pair_agg_fwd",)),
    "pair_agg_bwd": ("lanegcn_tpu_torch/csrc/pair_agg.cu",
                     "lanegcn_tpu/ops/pallas_pair_agg.py:171", ("pair_agg_bwd",)),
    "edge_mlp": ("lanegcn_tpu_torch/csrc/edge_mlp.cu",
                 "lanegcn_tpu/ops/pallas_edge_mlp.py:226", ("edge_mlp_fwd",)),
    "edge_mlp_bwd": ("lanegcn_tpu_torch/csrc/edge_mlp.cu",
                     "lanegcn_tpu/ops/pallas_edge_mlp.py:246", ("edge_mlp_bwd",)),
    "window_scatter": ("lanegcn_tpu_torch/csrc/window_scatter.cu",
                       "lanegcn_tpu/ops/pallas_window_scatter.py:82", ("window_scatter_fwd",)),
    "row_tail2": ("lanegcn_tpu_torch/csrc/row_tail.cu",
                  "lanegcn_tpu/ops/pallas_row_tail.py:152", ("row_tail2_fwd",)),
    "edge_mlp_pool": ("lanegcn_tpu_torch/csrc/edge_mlp.cu",
                      "lanegcn_tpu/ops/pallas_edge_mlp.py:226", ("edge_mlp_pool_fwd",)),
    "window_scatter_bwd": ("lanegcn_tpu_torch/csrc/window_scatter.cu",
                           "lanegcn_tpu/ops/pallas_window_scatter.py:111",
                           ("window_scatter_bwd",)),
    "row_tail2_bwd": ("lanegcn_tpu_torch/csrc/row_tail.cu",
                      "lanegcn_tpu/ops/pallas_row_tail.py:169", ("row_tail2_bwd",)),
    "edge_mlp_pool_bwd": ("lanegcn_tpu_torch/csrc/edge_mlp.cu",
                          "lanegcn_tpu/ops/pallas_edge_mlp.py:246", ("edge_mlp_pool_bwd",)),
    "segment_sum": ("lanegcn_tpu_torch/csrc/segment_sum.cu",
                    "lanegcn_tpu/ops/pallas_scatter.py:29", ("segment_sum",)),
    "lane_plan": ("lanegcn_tpu_torch/csrc/lane_plan.cu",
                  "lanegcn_tpu/ops/pallas_lane_layer.py:709", ("lane_plan_fwd",)),
    "lane_plan_bwd": ("lanegcn_tpu_torch/csrc/lane_plan.cu",
                      "lanegcn_tpu/ops/pallas_lane_layer.py:771", ("lane_plan_bwd",)),
    "band_conv": ("lanegcn_tpu_torch/csrc/band_conv.cu",
                  "lanegcn_tpu/ops/pallas_band_conv.py:131", ("band_conv_fwd",)),
    "band_conv_bwd": ("lanegcn_tpu_torch/csrc/band_conv.cu",
                      "lanegcn_tpu/ops/pallas_band_conv.py:153", ("band_conv_bwd",)),
}
# Each geometry: its model, its pack config (by name in
# lanegcn_tpu_torch.config) and ModelConfig fields, the scenarios per pack,
# the kernels it runs at shapes of its own (checked against their plain
# versions on the eval path's inputs and, backwards, on a train step's), the
# kernels checked on a train step's calls (`step_kernels`: segment_sum runs
# in the forward's scatters and in the gathers' backward) and the launches
# of each C entry point per eval forward and per train step (every other
# entry: 0); where set, `serve_rerun` (two eval forwards bitwise equal,
# `serve_rerun_phase`), `ab` (`ab_phase`) and `refused` (ModelConfig fields
# under which a train step must refuse, `refused_train_phase`).
_WINDOWED_FWD = {"lane_layer_fwd": 8, "scenario_agg_fwd": 8, "win_edge_fwd": 6,
                 "row_tail_fwd": 6, "segment_sum": 8}
_WINDOWED_STEP = {**_WINDOWED_FWD, "lane_layer_bwd": 8, "scenario_agg_bwd": 8,
                  "win_edge_bwd": 6, "row_tail_bwd": 6, "segment_sum": 16}
_PAIR_BWD = {"pair_agg_bwd": 8}
# merge_plan_agg="auto": the plan inside the layer kernel, so no lane_layer
# and no scenario_agg launch.
_SEPARATE = ("lane_layer", "scenario_agg")
_MERGED_FWD = {**{k: v for k, v in _WINDOWED_FWD.items() if not k.startswith(_SEPARATE)},
               "pair_agg_fwd": 8, "lane_plan_fwd": 8}
_MERGED_STEP = {**{k: v for k, v in _WINDOWED_STEP.items() if not k.startswith(_SEPARATE)},
                "pair_agg_fwd": 8, **_PAIR_BWD, "lane_plan_fwd": 8, "lane_plan_bwd": 8}
_CONTIGUOUS_FWD = {"lane_layer_fwd": 8, "edge_mlp_fwd": 6, "row_tail_fwd": 6, "segment_sum": 14}
# pallas_bands="off" on the windowed packs: band_conv and the row tail in
# place of lane_layer (8 LaneConv tails beside Att's 6).
_UNFUSED_FWD = {**{k: v for k, v in _WINDOWED_FWD.items() if not k.startswith("lane_layer")},
                "band_conv_fwd": 8, "row_tail_fwd": 14}
_UNFUSED_STEP = {**{k: v for k, v in _WINDOWED_STEP.items() if not k.startswith("lane_layer")},
                 "band_conv_fwd": 8, "band_conv_bwd": 8, "row_tail_fwd": 14, "row_tail_bwd": 14}
# The flat packs: no bands, no tables, no plan; every relation rides the
# residue lists (one scatter per layer, and its gather's backward), and
# the LaneConv tails run as row tails.
_FLAT_FWD = {"row_tail_fwd": 14, "edge_mlp_fwd": 6, "segment_sum": 14}
# n_actor = 64 beside n_map = 128 on the contiguous packs: A2M and M2A take
# Att's unequal-width branch (no edge_mlp), A2A's two layers run edge_mlp at
# 64; all six Att layers end in row_tail (A2M's at 128, the rest at 64);
# the scatters and the gathers' backwards as on contiguous.
_WIDTHS_FWD = {**_CONTIGUOUS_FWD, "edge_mlp_fwd": 2}
_WIDTHS_STEP = {**_WIDTHS_FWD, "lane_layer_bwd": 8, "edge_mlp_bwd": 2, "row_tail_bwd": 6,
                "segment_sum": 42}
_RCNN_FWD = {"lane_layer_fwd": 12, "scenario_agg_fwd": 12, "window_scatter_fwd": 2,
             "edge_mlp_pool_fwd": 3, "row_tail2_fwd": 3, "segment_sum": 14}
_RCNN_STEP = {**_RCNN_FWD, "lane_layer_bwd": 12, "scenario_agg_bwd": 12,
              "window_scatter_bwd": 2, "edge_mlp_pool_bwd": 3, "row_tail2_bwd": 3,
              "segment_sum": 30}
_RCNN_REMAT_STEP = {**_RCNN_STEP, "window_scatter_fwd": 4, "edge_mlp_pool_fwd": 6,
                    "row_tail2_fwd": 6, "segment_sum": 31}
# The double geometry's refusal: the first kernel an eval forward at 256 on
# the bench layout reaches that is not built at 256, by its C entries: the
# window plan's aggregate, after LaneInput's segment sums.
WIDE_REFUSED_SERVE = {"scenario_agg": ("scenario_agg_fwd",)}
GEOMETRIES = {
    "windowed": dict(model="lanegcn", config="windowed_pack_config", s=256,
                     kernels=("lane_layer", "scenario_agg", "win_edge", "row_tail"),
                     step_kernels=("segment_sum",),
                     per_forward=_WINDOWED_FWD, per_train_step=_WINDOWED_STEP),
    "bench": dict(model="lanegcn", config="bench_pack_config", s=256,
                  kernels=("pair_agg", "row_tail"),
                  step_kernels=("segment_sum",),
                  per_forward={**_WINDOWED_FWD, "pair_agg_fwd": 8},
                  per_train_step={**_WINDOWED_STEP, "pair_agg_fwd": 8, **_PAIR_BWD}),
    "contiguous": dict(model="lanegcn", config="contiguous_pack_config", s=32,
                       kernels=("lane_layer", "row_tail", "edge_mlp"),
                       step_kernels=("segment_sum",),
                       per_forward=_CONTIGUOUS_FWD,
                       per_train_step={**_CONTIGUOUS_FWD, "lane_layer_bwd": 8,
                                       "edge_mlp_bwd": 6, "row_tail_bwd": 6,
                                       "segment_sum": 42}),
    # LaneRCNN: 12 LaneConv layers (RoI stack, global stack, RoI stack; the
    # RoI plan is ungrouped, 512 slots per 256-row window), three
    # LanePoolings (r2g and g2r window-chunked, a2r flat). With remat the
    # LanePoolings' forwards run again in the backward.
    "lanercnn": dict(model="lanercnn", config="lanercnn_pack_config", s=256,
                     kernels=("lane_layer", "scenario_agg", "window_scatter", "row_tail2",
                              "edge_mlp_pool"),
                     step_kernels=("segment_sum",),
                     per_forward=_RCNN_FWD, per_train_step=_RCNN_STEP,
                     per_remat_step=_RCNN_REMAT_STEP),
    # The bench geometry with the window plan inside the LaneConv layer
    # kernel (merge_plan_agg="auto"); the `ab` phase profiles it beside the
    # separate kernels on the same packs and weights.
    "merged": dict(model="lanegcn", config="bench_pack_config", s=256,
                   model_fields=dict(merge_plan_agg="auto"), kernels=("lane_plan", "row_tail"),
                   step_kernels=("segment_sum",), per_forward=_MERGED_FWD,
                   per_train_step=_MERGED_STEP,
                   ab=("merge_plan_agg", ("off", "separate"), ("auto", "merged"))),
    # The windowed packs with the unfused LaneConv layer (pallas_bands="off"):
    # band_conv, then the row tail; `ab` profiles it beside the fused layer
    # on the same packs and weights.
    "unfused": dict(model="lanegcn", config="windowed_pack_config", s=256,
                    model_fields=dict(pallas_bands="off"), kernels=("band_conv", "row_tail"),
                    step_kernels=("segment_sum",), per_forward=_UNFUSED_FWD,
                    per_train_step=_UNFUSED_STEP,
                    ab=("pallas_bands", ("auto", "fused"), ("off", "unfused"))),
    # The pack the JAX CLI's explicit graph-parallel path trains on, for
    # one device: contiguous nodes without band masks, tables or plan.
    "flat": dict(model="lanegcn", config="flat_pack_config", s=32,
                 pack_kwargs=dict(split_bands=False, split_tables=False, scenario_plan=False),
                 kernels=("row_tail",), step_kernels=("segment_sum",), per_forward=_FLAT_FWD,
                 per_train_step={**_FLAT_FWD, "row_tail_bwd": 14, "edge_mlp_bwd": 6,
                                 "segment_sum": 34}),
    # 128-wide lanes beside a 64-wide actor branch (n_map != n_actor).
    "widths": dict(model="lanegcn", config="contiguous_pack_config", s=32,
                   model_fields=dict(n_actor=64), kernels=("row_tail", "edge_mlp"),
                   step_kernels=("segment_sum",), per_forward=_WIDTHS_FWD,
                   per_train_step=_WIDTHS_STEP),
    # The half-width model (n_map = n_actor = 64) on the bench layout: every
    # kernel of the bench train step at W = 64, the bench launches.
    "half": dict(model="lanegcn", config="bench_pack_config", s=256,
                 model_fields=dict(n_map=64, n_actor=64),
                 kernels=("lane_layer", "scenario_agg", "pair_agg", "win_edge", "row_tail"),
                 step_kernels=("segment_sum",),
                 per_forward={**_WINDOWED_FWD, "pair_agg_fwd": 8},
                 per_train_step={**_WINDOWED_STEP, "pair_agg_fwd": 8, **_PAIR_BWD},
                 serve_rerun=True),
    # The half-width model merged (merge_plan_agg="auto"): lane_plan at W = 64.
    "half_merged": dict(model="lanegcn", config="bench_pack_config", s=256,
                        model_fields=dict(n_map=64, n_actor=64, merge_plan_agg="auto"),
                        kernels=("lane_plan", "row_tail"), step_kernels=("segment_sum",),
                        per_forward=_MERGED_FWD, per_train_step=_MERGED_STEP,
                        ab=("merge_plan_agg", ("off", "separate"), ("auto", "merged"))),
    # The half-width model unfused (pallas_bands="off"): band_conv at W = 64.
    "half_unfused": dict(model="lanegcn", config="windowed_pack_config", s=256,
                         model_fields=dict(n_map=64, n_actor=64, pallas_bands="off"),
                         kernels=("band_conv", "row_tail"), step_kernels=("segment_sum",),
                         per_forward=_UNFUSED_FWD, per_train_step=_UNFUSED_STEP,
                         ab=("pallas_bands", ("auto", "fused"), ("off", "unfused"))),
    # The half-width LaneRCNN (n_map = n_actor = 64): every LaneRCNN kernel
    # at W = 64, the lanercnn launches; a train step at 96 must refuse.
    "half_lanercnn": dict(model="lanercnn", config="lanercnn_pack_config", s=256,
                          model_fields=dict(n_map=64, n_actor=64),
                          kernels=("lane_layer", "scenario_agg", "window_scatter", "row_tail2",
                                   "edge_mlp_pool"),
                          step_kernels=("segment_sum",),
                          per_forward=_RCNN_FWD, per_train_step=_RCNN_STEP,
                          per_remat_step=_RCNN_REMAT_STEP,
                          refused=dict(n_map=96, n_actor=96)),
    # The double-width model (n_map = n_actor = 256) on the CLI's contiguous
    # layout at full depth: lane_layer, Att's edge_mlp and row_tail at W =
    # 256 both ways (csrc/wide.cuh, csrc/wide_bwd.cuh), the contiguous
    # launches; an eval forward at 256 on the bench layout must stop at its
    # first kernel not built at 256 (`refused_serve`: the geometry and the
    # refusal).
    "double": dict(model="lanegcn", config="contiguous_pack_config", s=32,
                   model_fields=dict(n_map=256, n_actor=256),
                   kernels=("lane_layer", "edge_mlp", "row_tail"),
                   step_kernels=("segment_sum",), per_forward=_CONTIGUOUS_FWD,
                   per_train_step={**_CONTIGUOUS_FWD, "lane_layer_bwd": 8, "edge_mlp_bwd": 6,
                                   "row_tail_bwd": 6, "segment_sum": 42},
                   serve_rerun=True, refused_serve=("bench", WIDE_REFUSED_SERVE)),
}
# The first width-checked kernel a LaneRCNN train step reaches at a width
# no kernel takes (the half_lanercnn geometry's `refused` fields), by its C
# entries: the step must stop there. Only the segment sum, which takes any
# width, launches before it (LaneInput's and the first LaneConv stack's
# scatters).
NARROW_REFUSED = {"scenario_agg": ("scenario_agg_fwd", "scenario_agg_bwd")}
ANY_WIDTH = ("segment_sum",)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not ok:
        raise RuntimeError(msg)


class ScenarioCache:
    """Each synthetic scenario made once a run, by (kind, seed): the
    geometries draw the same seeds (the five 256-scenario LaneGCN ones the
    same 512). `get` hands out a shallow copy of the scenario as it was
    made: the packers memoize their per-scenario blobs on the dict they are
    given (`_fusion`, `_pack`, `_roi_pack`), so every geometry packs from
    cold blobs, its `pack_s` times the work a fresh scenario needs, and its
    packs are those of fresh scenarios."""

    def __init__(self):
        self.made = {}

    def get(self, seed: int, roi: bool):
        from lanegcn_tpu_torch.data.synthetic import make_roi_scenario, make_urban_scenario

        key = (roi, seed)
        if key not in self.made:
            self.made[key] = (
                make_roi_scenario(seed=seed, num_corridors=7, num_actors=12, urban=True) if roi
                else make_urban_scenario(seed=seed, num_corridors=7, num_actors=16))
        return dict(self.made[key])


SCENARIOS = ScenarioCache()


def make_packs(cfg, num_packs: int, s: int, seed0: int, roi: bool = False, pack_kw=None):
    """Synthetic urban scenarios packed for LaneGCN (16 actors, pack_batch
    with the keyword arguments pack_kw) or, with roi, for LaneRCNN (12
    actors with their LaneRoIs, pack_roi_batch); zero drops of any kind (the
    RoI pack's global-graph lists included) and no skipped scenario
    asserted. The scenarios come from `SCENARIOS` (`gen_s`: the time to make
    the ones no earlier call made; `pack_s` packs from cold blobs)."""
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch

    t0 = time.perf_counter()
    scens = [SCENARIOS.get(seed0 + i, roi) for i in range(num_packs * s)]
    gen_s = time.perf_counter() - t0
    packs, stats = [], []
    t0 = time.perf_counter()
    for p in range(num_packs):
        part = scens[p * s:(p + 1) * s]
        if roi:
            b, st = pack_roi_batch(part, cfg.roi_pack, cfg.model)
        else:
            b, st = pack_batch(part, cfg.pack, cfg.model, **(pack_kw or {}))
        packs.append(b)
        stats.append(st)
    pack_s = time.perf_counter() - t0
    for st in stats:
        bad = {k: v for k, v in st.items()
               if k.startswith(("dropped", "graph_dropped", "skipped")) and v}
        check(not bad, f"pack dropped edges or skipped scenarios: {bad}")
        check(st["packed_scenarios"] == s, f"packed {st['packed_scenarios']} of {s}")
    return packs, stats, gen_s, pack_s


def time_ms(fn, runs: int = 25, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cast_args(args, dtype):
    """bf16 tensors → dtype; everything else unchanged."""
    import torch

    out = []
    for a in args:
        if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
            a = a.to(dtype)
        out.append(a)
    return out


class Capture:
    """Records, per input shape, the first call's positional arguments of
    each wrapped function (module attribute), then calls through (keyword
    arguments too: win_edge's `prep` is not recorded, and the recorded call
    prepares the plan itself). `targets` lists (module, attribute, kernel
    name)."""

    def __init__(self, targets):
        self.targets = targets
        self.calls = {name: {} for _, _, name in self.targets}
        self.counts = {name: {} for _, _, name in self.targets}

    def __enter__(self):
        import torch

        self.saved = []
        for mod, attr, name in self.targets:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))

            def rec(*args, _fn=fn, _name=name, **kw):
                key = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
                self.counts[_name][key] = self.counts[_name].get(key, 0) + 1
                if key not in self.calls[_name]:
                    self.calls[_name][key] = [
                        a.clone() if isinstance(a, torch.Tensor) else a for a in args
                    ]
                return _fn(*args, **kw)

            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def forward_capture():
    """The kernel wrappers as the model modules call them (eval forward)."""
    from lanegcn_tpu_torch.models import fusion, lanercnn, map_net

    return Capture([
        (map_net, "fused_lane_layer", "lane_layer"),
        (map_net, "band_conv", "band_conv"),
        (map_net, "fused_row_tail", "row_tail"),
        (map_net, "scenario_aggregate", "scenario_agg"),
        (map_net, "fused_lane_layer_plan", "lane_plan"),
        (map_net, "pair_aggregate", "pair_agg"),
        (fusion, "win_edge_mlp", "win_edge"),
        (fusion, "fused_row_tail", "row_tail"),
        (fusion, "fused_edge_mlp", "edge_mlp"),
        (lanercnn, "window_scatter_add", "window_scatter"),
        (lanercnn, "fused_row_tail2", "row_tail2"),
        (lanercnn, "fused_edge_mlp", "edge_mlp_pool"),
    ])


def backward_capture():
    """The backward kernels' launchers as the autograd Functions call them
    (inputs and cotangent of one train step), and the segment sum as the
    scatters and the gathers' backward call it in that step."""
    from lanegcn_tpu_torch.ops import band_conv, edge_mlp, lane_layer, pair_agg, row_tail
    from lanegcn_tpu_torch.ops import scenario_agg, segment_sum, win_edge, window_scatter

    return Capture([
        (segment_sum, "sorted_segment_sum", "segment_sum"),
        (band_conv, "band_conv_bwd_cuda", "band_conv_bwd"),
        (lane_layer, "lane_plan_bwd_cuda", "lane_plan_bwd"),
        (lane_layer, "lane_layer_bwd_cuda", "lane_layer_bwd"),
        (scenario_agg, "scenario_agg_bwd_cuda", "scenario_agg_bwd"),
        (win_edge, "win_edge_bwd_cuda", "win_edge_bwd"),
        (row_tail, "row_tail_bwd_cuda", "row_tail_bwd"),
        (pair_agg, "pair_agg_bwd_cuda", "pair_agg_bwd"),
        (edge_mlp, "edge_mlp_bwd_cuda", "edge_mlp_bwd"),
        (window_scatter, "window_scatter_bwd_cuda", "window_scatter_bwd"),
        (row_tail, "row_tail2_bwd_cuda", "row_tail2_bwd"),
        (edge_mlp, "edge_mlp_pool_bwd_cuda", "edge_mlp_pool_bwd"),
    ])


def forward_ops(names):
    """{kernel: (public op, plain version)} for the named forward kernels."""
    from lanegcn_tpu_torch.ops import band_conv, edge_mlp, lane_layer, pair_agg, row_tail
    from lanegcn_tpu_torch.ops import scenario_agg, segment_sum, win_edge, window_scatter

    ops = {
        "lane_layer": (lane_layer.fused_lane_layer, lane_layer.lane_layer_plain),
        "band_conv": (band_conv.band_conv, band_conv.band_conv_plain),
        # The model hands the layer eps and its prepared plan (arguments 16
        # and 17); the plain version works from the plan itself.
        "lane_plan": (lane_layer.fused_lane_layer_plan,
                      lambda *a: lane_layer.lane_plan_plain(*a[:17])),
        "segment_sum": (segment_sum.sorted_segment_sum, segment_sum.segment_sum_plain),
        "scenario_agg": (scenario_agg.scenario_aggregate, scenario_agg.scenario_agg_plain),
        "win_edge": (win_edge.win_edge_mlp, win_edge.win_edge_plain),
        "row_tail": (row_tail.fused_row_tail, row_tail.row_tail_plain),
        "pair_agg": (pair_agg.pair_aggregate, pair_agg.pair_agg_plain),
        "edge_mlp": (edge_mlp.fused_edge_mlp, edge_mlp.edge_mlp_plain),
        "window_scatter": (window_scatter.window_scatter_add,
                           window_scatter.window_scatter_plain),
        "row_tail2": (row_tail.fused_row_tail2, row_tail.row_tail2_plain),
        "edge_mlp_pool": (edge_mlp.fused_edge_mlp, edge_mlp.edge_mlp_plain),
    }
    return {name: ops[name] for name in names}


def library_call(name, a):
    """One PyTorch call that computes the kernel's function on the same
    inputs (a yardstick the port never calls), or None where there is none.
    window_scatter: index_add over the valid edges' flat destinations;
    window_scatter_bwd: index_select of g's rows at every edge's
    destination (padding clamped to the last row); segment_sum: index_add
    of the kept edges' rows into out (or zeros); the indices are
    precomputed, outside the timing."""
    if name not in ("window_scatter", "window_scatter_bwd", "segment_sum"):
        return None
    from lanegcn_tpu_torch.ops import window_scatter

    if name == "segment_sum":
        data, seg, n = a[:3]
        base = a[3] if len(a) > 3 and a[3] is not None else data.new_zeros((n,) + data.shape[1:])
        keep = (seg < n).nonzero().squeeze(1)
        seg_k, data_k = seg[keep], data[keep]
        return lambda: base.index_add(0, seg_k, data_k)
    if name == "window_scatter_bwd":
        g, lu, wchunk, stride = a[:4]
        n = g.shape[0]
        dst = window_scatter.flat_destinations(lu, wchunk, stride, n).clamp(max=n - 1)
        return lambda: g.index_select(0, dst)
    msg, temp, lu, wchunk, stride = a[:5]
    dst = window_scatter.flat_destinations(lu, wchunk, stride, temp.shape[0])
    keep = (dst < temp.shape[0]).nonzero().squeeze(1)
    dst, msg = dst[keep], msg[keep]
    return lambda: temp.index_add(0, dst, msg)


def backward_ops(names):
    """{kernel_bwd: (kernel launcher, plain backward)} for the named kernels."""
    from lanegcn_tpu_torch.ops import band_conv, edge_mlp, lane_layer, pair_agg, row_tail
    from lanegcn_tpu_torch.ops import scenario_agg, win_edge, window_scatter

    ops = {
        "lane_layer": (lane_layer.lane_layer_bwd_cuda, lane_layer.lane_layer_bwd_plain),
        "band_conv": (band_conv.band_conv_bwd_cuda, band_conv.band_conv_bwd_plain),
        "lane_plan": (lane_layer.lane_plan_bwd_cuda,
                      lambda *a: lane_layer.lane_plan_bwd_plain(*a[:18])),
        "scenario_agg": (scenario_agg.scenario_agg_bwd_cuda,
                         scenario_agg.scenario_agg_bwd_plain),
        "win_edge": (win_edge.win_edge_bwd_cuda, win_edge.win_edge_bwd_plain),
        "row_tail": (row_tail.row_tail_bwd_cuda, row_tail.row_tail_bwd_plain),
        "pair_agg": (pair_agg.pair_agg_bwd_cuda, pair_agg.pair_agg_bwd_plain),
        "edge_mlp": (edge_mlp.edge_mlp_bwd_cuda, edge_mlp.edge_mlp_bwd_plain),
        "window_scatter": (window_scatter.window_scatter_bwd_cuda,
                           window_scatter.window_scatter_bwd_plain),
        "row_tail2": (row_tail.row_tail2_bwd_cuda, row_tail.row_tail2_bwd_plain),
        # The model skips dd (d is pack data); the check asks for it, so
        # that the kernel's dd is held to the plain one too.
        "edge_mlp_pool": (lambda *a: edge_mlp.edge_mlp_pool_bwd_cuda(*a[:10], True),
                          lambda *a: edge_mlp.edge_mlp_pool_bwd_plain(*a[:10])),
    }
    return {f"{name}_bwd": ops[name] for name in names}


def compare(name, tag, out_k, out_p):
    """Every output of a kernel against its plain version under TOL/RMS_TOL
    (an all-zero plain output must come back all zero); returns the worst
    output's numbers and one [max_abs_err, rms, err_over_tol, rel_rms_err]
    row per output."""
    import torch

    outs_k = out_k if isinstance(out_k, (tuple, list)) else (out_k,)
    outs_p = out_p if isinstance(out_p, (tuple, list)) else (out_p,)
    check(len(outs_k) == len(outs_p), f"{name}: {len(outs_k)} outputs, plain has {len(outs_p)}")
    rows = []
    for i, (k, p) in enumerate(zip(outs_k, outs_p)):
        check(k.shape == p.shape, f"{name} {tag} output {i}: shape {tuple(k.shape)} != "
              f"{tuple(p.shape)}")
        check(bool(torch.isfinite(k).all()), f"{name} {tag} output {i}: non-finite values")
        ref = p.float()
        diff = (k.float() - ref).abs()
        rms = float(ref.square().mean().sqrt()) if ref.numel() else 0.0
        err = float(diff.max()) if diff.numel() else 0.0
        if rms == 0.0:
            check(err == 0.0, f"{name} {tag} output {i}: plain is all zeros, kernel is not")
            rows.append([err, rms, 0.0, 0.0])
            continue
        # worst element's error as a share of its own tolerance
        worst = float((diff / (TOL[tag] * (rms + ref.abs()))).max())
        rel_rms = float(diff.square().mean().sqrt()) / rms
        check(worst <= 1.0, f"{name} {tag} output {i}: an element's error is {worst} x its "
              f"tolerance {TOL[tag]} * (rms {rms} + |plain|)")
        check(rel_rms <= RMS_TOL[tag], f"{name} {tag} output {i}: RMS error {rel_rms} of the "
              f"output's RMS > {RMS_TOL[tag]}")
        rows.append([err, rms, worst, rel_rms])
    first = outs_p[0].float()
    return {"max_abs_err": max(r[0] for r in rows), "rms": rows[0][1],
            "max_abs": float(first.abs().max()), "tol_abs": TOL[tag] * rows[0][1],
            "tol_rel": TOL[tag], "err_over_tol": max(r[2] for r in rows),
            "rel_rms_err": max(r[3] for r in rows), "rel_rms_tol": RMS_TOL[tag],
            "shape": list(outs_k[0].shape), "outputs": rows}


# ReLU ties in the backward checks. Where a ReLU's pre-activation lies
# within the kernel-vs-plain difference of zero, the two may take opposite
# sides of its mask, and that row's cotangent then flows differently
# through the two (an error of the cotangent's size, not of a rounding).
# A row of the outputs that follow the cotangent's rows (TIE_OUTPUTS) that
# misses its tolerance is excused only if the plain side puts one of that
# row's ReLU pre-activations within TIE_EPS of zero, relative to that
# pre-activation's RMS: in float32 1e-5, ~10x the reorder error of a
# 128-term fp32 sum and a GroupNorm; in bfloat16 one bf16 ulp at 1 (2^-7),
# about what one flipped rounding of h, t1 or t2 moves a later
# pre-activation. In float32 that marks well under 1 % of the rows (random
# inputs); in bfloat16 most rows hold such a pre-activation, so there the
# share cap does the bounding. At most TIE_SHARE of the rows (at least 1)
# are excused: their cotangent is zeroed and every output is held to the
# tolerances again. scenario_agg_bwd and pair_agg_bwd are linear: they have
# no ties. In bfloat16, win_edge_bwd's source-side outputs (dPs, dCs:
# TIE_SRC_OUTPUTS) sum only the edges from a source row (often one), so a
# near tie on one of them shows there undiluted: a ReLU pre-activation near
# zero, or an fp32 value near a bf16 rounding midpoint, which the kernel's
# and the plain version's fp32 sums, in different orders, round to
# different sides (one bf16 ulp of a GN backward's output moves a channel
# of a loud row by more than the tolerance where that channel is small). A
# source row that misses is excused only if its kernel rows meet the
# tolerance against a second evaluation of the plain arithmetic: the row's
# edges one at a time (`edge_chain`), as they come, or with one near tie
# on one edge taken the other way (a ReLU pre-activation within TIE_EPS of
# zero, relative to its row's RMS, or a rounding within ROUND_EPS of a
# bf16 ulp from the midpoint). A dropped, doubled or misrouted edge is
# none of these. The destination rows of its edges then join the excused
# rows (under the same cap); a source row that nothing explains fails. In
# float32 a source-side miss is never excused.
TIE_OUTPUTS = {"row_tail_bwd": (0, 1), "lane_layer_bwd": (1,), "win_edge_bwd": (0, 1),
               "edge_mlp_bwd": (0, 1, 2), "row_tail2_bwd": (0, 1), "edge_mlp_pool_bwd": (0, 1),
               "lane_plan_bwd": (1,)}
TIE_SRC_OUTPUTS = {"win_edge_bwd": (2, 3)}
COTANGENT_ARG = {"row_tail_bwd": 7, "lane_layer_bwd": 9, "win_edge_bwd": 13,
                 "edge_mlp_bwd": 12, "row_tail2_bwd": 10, "edge_mlp_pool_bwd": 8,
                 "lane_plan_bwd": 15}
TIE_EPS = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TIE_SHARE = 1e-4
# A rounding near tie: the fp32 value lies within ROUND_EPS of a bf16 ulp
# of the midpoint between its two bf16 neighbours. One fp32 ulp is 2^-16 of
# a bf16 ulp; a 128-term sum reordered moves it by ~10 fp32 ulps, and a GN
# backward's mean subtraction amplifies that up to ~100x.
ROUND_EPS = 2.0 ** -6
MAX_SRC_TIES = 64  # source rows that may miss in one call (the share cap is tighter)
MAX_FLIPS = 32     # near ties tried per source row, nearest first


def tie_rows(name, tag, out_k, out_p, a):
    """Rows (of the cotangent) where a row-aligned output misses its
    tolerance and, in bfloat16 (TIE_SRC_OUTPUTS), the destination rows of
    the edges from each source row that misses and `src_tie` explains (a
    source row that it does not explain fails); and {source row: how it
    was explained}."""
    import torch
    from lanegcn_tpu_torch.ops import win_edge

    def miss(i):
        ref = out_p[i].float()
        rms = float(ref.square().mean().sqrt())
        return ((out_k[i].float() - ref).abs() > TOL[tag] * (rms + ref.abs())).any(1)

    bad = None
    for i in TIE_OUTPUTS[name]:
        bad = miss(i) if bad is None else bad | miss(i)
    outs = TIE_SRC_OUTPUTS.get(name, ()) if tag == "bfloat16" else ()
    src = (torch.nonzero(torch.stack([miss(i) for i in outs]).any(0)).squeeze(1).tolist()
           if outs else [])
    how = {}
    if src:
        check(len(src) <= MAX_SRC_TIES, f"{name} {tag}: {len(src)} source rows miss the "
              f"tolerance, more than near ties explain ({MAX_SRC_TIES})")
        _, u, v = win_edge._edge_rows(a[12], a[0].shape[0], a[2].shape[0])
        for r in src:
            dst = u[v == r]
            how[r] = src_tie(a, out_k, out_p, outs, tag, r, dst)
            check(how[r] is not None, f"{name} {tag}: source row {r} misses the tolerance in "
                  f"outputs {outs}, and neither its edges one at a time nor one near tie "
                  f"taken the other way on one of them explain it")
            bad[dst] = True
    return torch.nonzero(bad).squeeze(1), how


def src_tie(a, out_k, out_p, outs, tag, r, dst):
    """How win_edge_bwd's kernel rows r of `outs` (dPs, dCs) meet the
    tolerance against the plain arithmetic over the row's edges (their
    destination rows `dst`) evaluated one edge at a time, as {"by": "one at
    a time" or the near tie taken the other way, "edges", "vs_plain",
    "vs_evaluation": the worst error over the tolerance}; or None."""
    import torch

    ref = [out_p[i].float() for i in outs]
    scale = TOL[tag] * torch.cat([x[r].abs() + float(x.square().mean().sqrt()) for x in ref])
    kern = torch.cat([out_k[i][r].float() for i in outs])
    worst = lambda emu: float(((kern - emu).abs() / scale).max())
    logs = [{} for _ in dst]
    base = [edge_chain(a, int(k), r, log=lg) for k, lg in zip(dst, logs)]
    total = sum(base)
    how = {"edges": len(base), "vs_plain": worst(torch.cat([x[r] for x in ref]))}
    if worst(total) <= 1:
        return {"by": "one at a time", **how, "vs_evaluation": worst(total)}
    cands = []
    for j, lg in enumerate(logs):
        for (kind, what), (x, y) in lg.items():
            if kind == "relu":
                near = x.abs() / x.square().mean().sqrt() / TIE_EPS[tag]
            else:
                o = bf16_other(y, x)
                near = (x - (y + o) / 2).abs() / (y - o).abs() / ROUND_EPS
                near = torch.where(y != 0, near, torch.full_like(near, 2.0))
            cands += [(float(near[c]), j, kind, what, c)
                      for c in torch.nonzero(near <= 1).squeeze(1).tolist()]
    for near, j, kind, what, c in sorted(cands)[:MAX_FLIPS]:
        emu = total - base[j] + edge_chain(a, int(dst[j]), r, flip=(kind, what, c))
        if worst(emu) <= 1:
            return {"by": f"{kind} {what}[{c}] of edge {int(dst[j])} <- {r} taken the other "
                          f"way ({near:.3g} of its eps)", **how, "vs_evaluation": worst(emu)}
    return None


def bf16_other(y, x):
    """The other bf16 neighbour of fp32 x, whose rounding is y."""
    import torch

    bits = y.to(torch.bfloat16).view(torch.int16)
    step = torch.where(y.abs() < x.abs(), 1, -1).to(torch.int16)  # away from zero if y is nearer it
    return (bits + step).view(torch.bfloat16).float()


def edge_chain(a, k, r, flip=None, log=None):
    """win_edge_bwd_plain's arithmetic for the one edge k <- r of its
    inputs `a` (bfloat16): that edge's rows rnd(d_t1p) | rnd(d_s) [256]
    fp32, which its dPs and dCs rows sum. `log` gets each ReLU's
    pre-activation (("relu", name): (pre, None)) and each rounding's fp32
    value and result (("round", name): (x, y)); `flip` = (kind, name, c)
    takes that one the other way at channel c."""
    import torch
    from lanegcn_tpu_torch.ops.norm import gn_bwd, gn_stats

    pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, _, g = a[:14]
    dt, f = pd.dtype, (lambda x: x.float())

    def relu(name, pre):
        if log is not None:
            log[("relu", name)] = (pre[0], None)
        if flip is not None and flip[:2] == ("relu", name):
            pre = pre.clone()
            pre[0, flip[2]] = -pre[0, flip[2]]
        return torch.relu(pre)

    def rnd(name, x):
        y = x.to(dt).float()
        if log is not None:
            log[("round", name)] = (x[0], y[0])
        if flip is not None and flip[:2] == ("round", name):
            y = y.clone()
            y[0, flip[2]] = bf16_other(y[0, flip[2]], x[0, flip[2]])
        return y

    w_do, w_1, w_out = (f(w.to(dt)) for w in (kdo, k1, kout))
    t1 = rnd("t1", relu("t1", f(pd[k:k + 1]) + f(ps[r:r + 1]) + f(bd)))
    nrm_z, inv_z = gn_stats(t1 @ w_do)
    t2 = rnd("t2", relu("z", nrm_z * f(gdow) + f(gdob)))
    nrm_s, inv_s = gn_stats(t2 @ w_1 + f(cs[r:r + 1]) + f(qd[k:k + 1]))
    e1 = rnd("e1", relu("s", nrm_s * f(gchw) + f(gchb)))
    d_gn_s = torch.where(e1 > 0, f(g[k:k + 1].to(dt)) @ w_out.t(), 0.0)
    d_s = rnd("d_s", gn_bwd(d_gn_s, nrm_s, inv_s, gchw))
    d_gn_z = torch.where(t2 > 0, d_s @ w_1.t(), 0.0)
    d_z = rnd("d_z", gn_bwd(d_gn_z, nrm_z, inv_z, gdow))
    d_t1p = rnd("d_t1p", torch.where(t1 > 0, d_z @ w_do.t(), 0.0))
    return torch.cat([d_t1p, d_s], 1)[0]


def relu_pre(name, a):
    """The plain side's ReLU pre-activations of a backward's inputs `a`, as
    ([rows, C] pre-activation, the cotangent row of each row or None where
    the rows are the cotangent's) pairs."""
    import torch
    from lanegcn_tpu_torch.ops import win_edge
    from lanegcn_tpu_torch.ops.norm import group_norm

    if name in ("row_tail_bwd", "lane_layer_bwd", "lane_plan_bwd"):
        if name == "row_tail_bwd":
            x, res, w, g1w, g1b, g2w, g2b = a[:7]
        else:  # lane_layer_bwd, lane_plan_bwd: the tail of temp, with feat as the residual
            res, x, _, _, w, g1w, g1b, g2w, g2b = a[:9]
        dt = res.dtype
        h_pre = group_norm(x.float(), g1w, g1b)
        y = group_norm(torch.relu(h_pre).to(dt).float() @ w.to(dt).float(), g2w, g2b)
        return [(h_pre, None), (y + res.float(), None)]
    if name == "row_tail2_bwd":
        x, res, w1, w2, g1w, g1b, g2w, g2b, g3w, g3b = a[:10]
        dt = x.dtype
        h1_pre = group_norm(x.float(), g1w, g1b)
        h2_pre = group_norm(torch.relu(h1_pre).to(dt).float() @ w1.to(dt).float(), g2w, g2b)
        y = group_norm(torch.relu(h2_pre).to(dt).float() @ w2.to(dt).float(), g3w, g3b)
        return [(h1_pre, None), (h2_pre, None), (y + res.float(), None)]
    if name == "edge_mlp_pool_bwd":
        d, cg, kd, bd, k1, gchw, gchb = a[:7]
        rnd = lambda x: x.to(cg.dtype).float()
        t1_pre = rnd(d) @ rnd(kd) + bd.float()
        s_pre = group_norm(rnd(torch.relu(t1_pre)) @ rnd(k1) + cg.float(), gchw, gchb)
        return [(t1_pre, None), (s_pre, None)]
    if name == "edge_mlp_bwd":
        d, qg, cg, kd, bd, kdo, gdow, gdob, k1, gchw, gchb = a[:11]
        rnd = lambda x: x.to(cg.dtype).float()
        t1_pre = rnd(d) @ rnd(kd) + bd.float()
        z_pre = group_norm(rnd(torch.relu(t1_pre)) @ rnd(kdo), gdow, gdob)
        s_pre = group_norm(rnd(torch.relu(z_pre)) @ rnd(k1) + cg.float() + qg.float(),
                           gchw, gchb)
        return [(t1_pre, None), (z_pre, None), (s_pre, None)]
    pd, qd, ps, cs, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, plan = a[:13]
    rnd = lambda x: x.to(pd.dtype).float()
    _, u, v = win_edge._edge_rows(plan, pd.shape[0], ps.shape[0])
    t1_pre = pd[u].float() + ps[v].float() + bd.float()
    z_pre = group_norm(rnd(torch.relu(t1_pre)) @ rnd(kdo), gdow, gdob)
    s_pre = group_norm(rnd(torch.relu(z_pre)) @ rnd(k1) + cs[v].float() + qd[u].float(),
                       gchw, gchb)
    return [(t1_pre, u), (z_pre, u), (s_pre, u)]


def near_zero_rows(name, tag, a, n_rows):
    """[n_rows] bool: the cotangent rows with a ReLU pre-activation within
    TIE_EPS[tag] of zero (relative to its RMS) on the plain side."""
    import torch

    near = torch.zeros(n_rows, dtype=torch.bool, device=a[0].device)
    for pre, rows in relu_pre(name, a):
        hit = (pre.abs() <= TIE_EPS[tag] * pre.square().mean().sqrt()).any(1)
        if rows is None:
            near |= hit
        else:
            near[rows[hit]] = True
    return near


def check_temp(name, a, out):
    """The forward kernel's saved fp32 temp (lane_layer, lane_plan), which
    its backward consumes, against the plain temp under the float32
    tolerances in both dtypes (both sum products of the same dtype-valued
    operands in fp32; only the order differs; lane_plan's bf16 plan
    messages up to their rounding ties, `plan_temp_ref`), and the out of
    that launch bitwise equal to the eval path's `out`."""
    import torch
    from lanegcn_tpu_torch.ops import lane_layer

    moved = 0
    if name == "lane_layer":
        out_t, temp = lane_layer._fwd_cuda(*a[:10], 1e-5, save_temp=True)
        plain = lane_layer._temp_plain(a[0], a[1], a[2], a[3], a[9])
    else:
        eps, prep = (a[16], a[17]) if len(a) > 16 else (1e-5, None)
        out_t, temp = lane_layer._plan_fwd_cuda(*a[:16], eps, prep, save_temp=True)
        plain = lane_layer._plan_temp_plain(a[0], a[1], a[2], a[3], a[14], *a[9:14], a[15])
        if a[0].dtype == torch.bfloat16:
            plain, moved = plan_temp_ref(a, temp, plain)
    check(torch.equal(out_t, out), f"{name}: out with save_temp differs from out without")
    return {**compare(f"{name} temp", "float32", temp, plain), "rounding_tie_elements": moved}


def plan_temp_ref(a, temp, plain):
    """lane_plan's bf16 temp reference. Each plan message is the bf16
    rounding of an fp32 product that the kernel (wgmma) and the plain
    version (cuBLAS) sum in other orders, so where that product lies within
    ROUND_EPS of a bf16 ulp of the midpoint between its two bf16 neighbours
    the two may round it to opposite sides: one ulp of that message apart
    in temp, which the float32 tolerance does not cover. The reference is
    the plain temp moved toward the kernel's, per element, by at most the
    sum of such flips of its row's messages (none elsewhere); every other
    difference is held to the float32 tolerance as before. Returns (the
    reference, the elements where the plain temp itself misses the float32
    tolerance)."""
    import torch
    from lanegcn_tpu_torch.ops import lane_layer
    from lanegcn_tpu_torch.ops.scenario_agg import _per_relation

    feat, w_rel = a[0], a[9]
    u, v, counts = lane_layer._plan_rows(feat, w_rel, *a[10:14], a[15])
    x = _per_relation(feat[v].float(), w_rel, counts)
    y = x.to(feat.dtype).float()
    o = bf16_other(y, x)
    near = (x - (y + o) / 2).abs() <= ROUND_EPS * (y - o).abs()
    step = torch.where(near, o - y, torch.zeros_like(x))
    lo = plain.index_add(0, u, step.clamp(max=0))
    hi = plain.index_add(0, u, step.clamp(min=0))
    ref = torch.minimum(torch.maximum(temp, lo), hi)
    tol = TOL["float32"] * (plain.square().mean().sqrt() + plain.abs())
    return ref, int(((temp - plain).abs() > tol).sum())


def kernel_phase(phase, geom, ops, calls, counts):
    """Kernel vs plain on the captured inputs, in float32 and bfloat16, with
    a rerun of the kernel that must be bitwise equal; returns per-kernel
    results of the call shape with the most rows (N rows; A2M for win_edge
    and edge_mlp), with `ms_per_step`: the kernel time of every call shape
    times its calls in the captured step, and `by_call`: each call shape's
    errors, times and bound."""
    import torch

    summary = {}
    for name, (fn, plain) in ops.items():
        check(bool(calls[name]), f"{name}: the path never called this kernel")
        per_step, by_call = 0.0, []
        shapes = list(calls[name].items())
        main_call = max(range(len(shapes)), key=lambda i: (shapes[i][0][0][0], -i))
        for ci, (key, args) in enumerate(shapes):
            res = {"phase": phase, "geometry": geom, "name": name, "call": ci,
                   "calls_per_step": counts[name][key]}
            for dtype in (torch.float32, torch.bfloat16):
                a = cast_args(args, dtype)
                out_k = fn(*a)
                out_p = plain(*a)
                tag = str(dtype).split(".")[-1]
                ties, src_ties = 0, {}
                if name in TIE_OUTPUTS:
                    rows, src_ties = tie_rows(name, tag, out_k, out_p, a)
                    ties = int(rows.numel())
                    if ties:
                        n_rows = a[COTANGENT_ARG[name]].shape[0]
                        lone = rows[~near_zero_rows(name, tag, a, n_rows)[rows]]
                        check(not lone.numel(), f"{name} {tag}: rows {lone[:8].tolist()} "
                              f"({lone.numel()}) miss the tolerance and hold no ReLU "
                              f"pre-activation within {TIE_EPS[tag]} of zero")
                        check(ties <= max(1, TIE_SHARE * n_rows),
                              f"{name} {tag}: {ties} of {n_rows} rows miss the tolerance, "
                              f"more than ReLU ties explain ({TIE_SHARE} of the rows)")
                        g = a[COTANGENT_ARG[name]].clone()
                        g[rows] = 0
                        a[COTANGENT_ARG[name]] = g
                        out_k = fn(*a)
                        out_p = plain(*a)
                again = fn(*a)
                torch.cuda.synchronize()
                res[tag] = compare(name, tag, out_k, out_p)
                res[tag]["tie_rows"] = ties
                res[tag]["src_ties"] = {str(r): how for r, how in src_ties.items()}
                if name in ("lane_layer", "lane_plan"):
                    res[tag]["temp"] = check_temp(name, a, out_k)
                outs = out_k if isinstance(out_k, (tuple, list)) else (out_k,)
                agains = again if isinstance(again, (tuple, list)) else (again,)
                check(all(torch.equal(x, y) for x, y in zip(outs, agains)),
                      f"{name} {tag}: a rerun of the kernel is not bitwise equal")
                res[tag]["bitwise_rerun"] = True
                del out_k, out_p, again, outs, agains
                if dtype == torch.bfloat16:
                    res["ms"] = time_ms(lambda: fn(*a))
                    res["plain_ms"] = time_ms(lambda: plain(*a))
                    lib = library_call(name, a)
                    res["library_ms"] = None if lib is None else time_ms(lib)
                    res["work"] = work_of(name, a)
            emit(res)
            per_step += res["ms"] * counts[name][key]
            by_call.append({"shape": res["bfloat16"]["shape"], "width": call_width(name, args),
                            "calls_per_step": counts[name][key],
                            "err_over_tol": res["bfloat16"]["err_over_tol"],
                            "err_over_tol_fp32": res["float32"]["err_over_tol"],
                            "ms": res["ms"], "plain_ms": res["plain_ms"],
                            "bound_ms": res["work"]["bound_ms"],
                            "library_ms": res["library_ms"]})
            if ci == main_call:
                summary[name] = res
        summary[name]["ms_per_step"] = per_step
        summary[name]["by_call"] = by_call
        summary[name]["by_width"] = by_width(by_call)
    return summary


# The argument that holds a call's rows, for every kernel (row_tail's and
# row_tail2's x, Att's edge_mlp's and LanePooling's cg, lane_layer's,
# scenario_agg's, pair_agg's, lane_plan's and band_conv's feat, win_edge's
# Pd, window_scatter's msg and g, both ways; segment_sum's data, any width).
ROWS_ARG = {"edge_mlp": 2, "edge_mlp_bwd": 2, "edge_mlp_pool": 2, "edge_mlp_pool_bwd": 1,
            "segment_sum": 0,
            **{k: 0 for name in ("lane_layer", "scenario_agg", "pair_agg", "win_edge",
                                 "lane_plan", "band_conv", "row_tail", "row_tail2",
                                 "window_scatter")
               for k in (name, name + "_bwd")}}


def call_width(name, args):
    """The row width of a call of kernel `name`."""
    return args[ROWS_ARG[name]].shape[1]


def by_width(by_call):
    """{width: the worst bf16 and fp32 error over tolerance of the calls at
    that width, and the times and bound of its call with the most calls a
    step (ties: the first)}."""
    out = {}
    for w in sorted({c["width"] for c in by_call}):
        at = [c for c in by_call if c["width"] == w]
        top = max(at, key=lambda c: c["calls_per_step"])
        out[str(w)] = {"calls": len(at),
                       "err_over_tol": max(c["err_over_tol"] for c in at),
                       "err_over_tol_fp32": max(c["err_over_tol_fp32"] for c in at),
                       "shape": top["shape"], "calls_per_step": top["calls_per_step"],
                       "ms": top["ms"], "plain_ms": top["plain_ms"],
                       "bound_ms": top["bound_ms"], "library_ms": top["library_ms"]}
    return out


def work_of(name, a):
    from lanegcn_tpu_torch.ops import band_conv, edge_mlp, lane_layer, pair_agg, row_tail
    from lanegcn_tpu_torch.ops import scenario_agg, segment_sum, win_edge, window_scatter

    works = {
        "lane_layer": lambda: lane_layer.work(a[0], a[2]),
        "band_conv": lambda: band_conv.work(a[0], a[1]),
        "band_conv_bwd": lambda: band_conv.work_bwd(a[0], a[1]),
        "lane_plan": lambda: lane_layer.work_plan(a[0], a[2], a[10], a[12], a[9], a[13],
                                                  a[15] if len(a) > 15 else None),
        "lane_plan_bwd": lambda: lane_layer.work_plan_bwd(a[0], a[2], a[10], a[12], a[9],
                                                          a[13], a[14]),
        "segment_sum": lambda: segment_sum.work(a[0], a[1], a[2], a[3] if len(a) > 3 else None),
        "scenario_agg": lambda: scenario_agg.work(a[0], a[3], a[4], a[5], a[2], a[6], a[7]),
        "win_edge": lambda: win_edge.work(a[0], a[2], a[13]),
        "row_tail": lambda: row_tail.work(a[0].shape[0], a[0].element_size(),
                                          call_width(name, a)),
        "pair_agg": lambda: pair_agg.work(a[0], a[2], a[3]),
        "edge_mlp": lambda: edge_mlp.work(a[0], a[1], a[2]),
        "lane_layer_bwd": lambda: lane_layer.work_bwd(a[0], a[2]),
        "scenario_agg_bwd": lambda: scenario_agg.work_bwd(a[0], a[2], a[3], a[4], a[1], a[5],
                                                          a[6]),
        "win_edge_bwd": lambda: win_edge.work_bwd(a[0], a[2], a[12]),
        "row_tail_bwd": lambda: row_tail.work_bwd(a[0].shape[0], a[0].element_size(),
                                                  call_width(name, a)),
        "pair_agg_bwd": lambda: pair_agg.work_bwd(a[0], a[1], a[2]),
        "edge_mlp_bwd": lambda: edge_mlp.work_bwd(a[0], a[1], a[2], a[12]),
        "window_scatter": lambda: window_scatter.work(a[0], a[1], a[2], a[3], a[4]),
        "row_tail2": lambda: row_tail.work2(a[0].shape[0], a[0].element_size(),
                                            call_width(name, a)),
        "edge_mlp_pool": lambda: edge_mlp.work(a[0], a[1], a[2], a[12]),
        "window_scatter_bwd": lambda: window_scatter.work_bwd(a[0], a[1], a[2], a[3]),
        "row_tail2_bwd": lambda: row_tail.work2_bwd(a[0].shape[0], a[0].element_size(),
                                                    call_width(name, a)),
        "edge_mlp_pool_bwd": lambda: edge_mlp.work_pool_bwd(a[0], a[1], a[8]),
    }
    w = works[name]()
    t_bytes = w["bytes"] / PEAK_HBM_BYTES * 1e3
    t_ops = w["flops"] / PEAK_BF16_FLOPS * 1e3
    w["bound_ms"] = max(t_bytes, t_ops)
    w["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return w


def pack_kwargs(geom):
    """The geometry's pack_batch keyword arguments."""
    return GEOMETRIES[geom].get("pack_kwargs", {})


def pack_config(geom, s):
    from lanegcn_tpu_torch import config

    spec = GEOMETRIES[geom]
    field = "roi_pack" if spec["model"] == "lanercnn" else "pack"
    model = config.ModelConfig(**spec.get("model_fields", {}))
    return config.Config(model=model, **{field: getattr(config, spec["config"])(s)})


def parity_phase(geom):
    """Full float32 forward + loss: card (kernels) vs CPU (plain versions)."""
    import torch
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.train.loop import make_eval_step

    s = 8
    cfg = pack_config(geom, s)
    packs, _, _, _ = make_packs(cfg, 1, s, seed0=10_000, pack_kw=pack_kwargs(geom))
    batch = PackedBatch.from_numpy(packs[0])
    net_gpu = LaneGCN(cfg.model, dtype=torch.float32, device="cuda", seed=1)
    net_cpu = LaneGCN(cfg.model, dtype=torch.float32, device="cpu", seed=1)
    net_cpu.load_state_dict({k: v.cpu() for k, v in net_gpu.state_dict().items()})
    out_g, m_g = make_eval_step(cfg, net_gpu)(batch)
    out_c, m_c = make_eval_step(cfg, net_cpu, device="cpu")(batch)
    err = {k: float((out_g[k].cpu() - out_c[k]).abs().max()) for k in ("cls", "reg")}
    scale = {k: max(1.0, float(out_c[k].abs().max())) for k in ("cls", "reg")}
    loss_g, loss_c = float(m_g["loss"]), float(m_c["loss"])
    err["loss"] = abs(loss_g - loss_c)
    scale["loss"] = max(1.0, abs(loss_c))
    # float32 on both sides; the card sums in other orders (kernels, cuBLAS,
    # cuDNN without TF32) through ~20 GroupNorm'd layers: 1e-3 relative.
    tol = {k: 1e-3 * scale[k] for k in err}
    emit({"phase": "parity", "geometry": geom, "scenarios": s, "max_abs_err": err, "tol": tol,
          "loss_gpu": loss_g, "loss_cpu": loss_c})
    for k in err:
        check(err[k] <= tol[k], f"parity {k}: {err[k]} > {tol[k]}")


@contextlib.contextmanager
def nms_recorder(picks, key):
    """Within the block, records the first segmented_nms call's picks and
    arguments (on the CPU) under picks[key]."""
    import torch
    from lanegcn_tpu_torch.models import lanercnn

    nms = lanercnn.segmented_nms

    def rec(*a):
        sel = nms(*a)
        picks.setdefault(key, (
            sel.cpu(), [x.detach().cpu() if isinstance(x, torch.Tensor) else x for x in a]))
        return sel

    lanercnn.segmented_nms = rec
    try:
        yield
    finally:
        lanercnn.segmented_nms = nms


def nms_report(picks, a="cuda", b="cpu"):
    """Two runs' NMS picks compared (the card's and the CPU's by default),
    beside the smallest gap between a picked logit and another node's logit
    of its segment (run b's side), so that a near-tie flip can be told from
    a bug."""
    import torch

    sel_g, sel_c = picks[a][0], picks[b][0]
    xy, logits, seg, mask, num_seg = picks[b][1][:5]
    l = logits.float()
    onehot = (seg[None, :] == torch.arange(num_seg)[:, None]) & mask[None, :]  # [B, MI]
    other = onehot[:, None, :] & (torch.arange(l.shape[0])[None, None, :] != sel_c[:, :, None])
    other &= onehot.any(1)[:, None, None]
    gap = (l[sel_c][:, :, None] - l[None, None, :]).abs()[other]
    return {"nms_picks": list(sel_c.shape), "nms_picks_differ": int((sel_g != sel_c).sum()),
            "min_logit_gap_at_picks": float(gap.min()) if gap.numel() else None}


def roi_parity_phase(geom, cfg=None, s=8):
    """LaneRCNN's full float32 forward + roi_loss: card (kernels) vs CPU
    (plain versions), s scenarios packed by `cfg` (default: the geometry's
    config for s), same weights; zero drops of either kind asserted
    (`make_packs`); the segmented-NMS picks must be equal on both sides
    (`nms_report`)."""
    import torch
    from lanegcn_tpu_torch.graph import RoiPackedBatch
    from lanegcn_tpu_torch.models import lanercnn
    from lanegcn_tpu_torch.train.loop import make_eval_step

    cfg = cfg or pack_config(geom, s)
    packs, _, _, _ = make_packs(cfg, 1, s, seed0=10_000, roi=True)
    batch = RoiPackedBatch.from_numpy(packs[0])
    net_gpu = lanercnn.LaneRCNN(cfg.model, dtype=torch.float32, device="cuda", seed=1)
    net_cpu = lanercnn.LaneRCNN(cfg.model, dtype=torch.float32, device="cpu", seed=1)
    net_cpu.load_state_dict({k: v.cpu() for k, v in net_gpu.state_dict().items()})
    picks = {}

    def run(net, device):
        with nms_recorder(picks, device):
            return make_eval_step(cfg, net, device=device, loss_fn=lanercnn.roi_loss,
                                  metrics_fn=lanercnn.roi_metrics)(batch)

    out_g, m_g = run(net_gpu, "cuda")
    out_c, m_c = run(net_cpu, "cpu")
    keys = ("pred_logics", "pred_goals", "pred_trajs")
    err = {k: float((out_g[k].cpu() - out_c[k]).abs().max()) for k in keys}
    scale = {k: max(1.0, float(out_c[k].abs().max())) for k in keys}
    loss_g, loss_c = float(m_g["loss"]), float(m_c["loss"])
    err["loss"], scale["loss"] = abs(loss_g - loss_c), max(1.0, abs(loss_c))
    # As `parity_phase`: float32 on both sides through ~20 GroupNorm'd
    # layers, 1e-3 relative; the trajectories' scale is their largest
    # element (Decode's divisions are well away from zero at these inputs).
    tol = {k: 1e-3 * scale[k] for k in err}
    nms = nms_report(picks)
    emit({"phase": "parity", "geometry": geom, "scenarios": s, "max_abs_err": err, "tol": tol,
          "loss_gpu": loss_g, "loss_cpu": loss_c, **nms})
    check(nms["nms_picks_differ"] == 0, f"parity: {nms['nms_picks_differ']} NMS picks differ")
    for k in err:
        check(err[k] <= tol[k], f"parity {k}: {err[k]} > {tol[k]}")


# Gradient parity, card vs CPU (float32): each leaf's max error within
# GRAD_TOL of that leaf's max |g| on the CPU. The gradients carry the
# forward's reorder error (1e-6..1e-5 relative, see parity) through a
# second chain of reordered sums (the backward kernels' per-block partials,
# cuBLAS, index_add_); 2e-3 leaves ~100x room over that. A leaf whose
# gradient cancels to zero by construction (the mode score's bias: the
# max-margin loss sees only score differences) holds rounding noise only,
# so a leaf's scale is floored at GRAD_FLOOR of the model's largest
# gradient element; every other leaf of the model is above that floor
# (the smallest is ~1.7e-3 of the largest at S=8).
GRAD_TOL = 2e-3
GRAD_FLOOR = 1e-4
# Params after the step: Adam's first step moves each element by about
# lr·sign(g), so where |g| lies at the reorder noise the card and the CPU
# may step apart (up to 2·lr) while every gradient passes. At most
# PARAM_FAR_SHARE of the elements may differ by more than PARAM_FAR: runs
# of this check measured 846-852 of 3,701,161 (2.3e-4). A wrong step rule
# (bias correction, lr, coefficient, clip) moves every element, and the
# control (the CPU's step redone with each gradient leaf moved by uniform
# noise of GRAD_TOL of its scale, what the gradient check lets through) is
# printed beside it.
PARAM_FAR = 1e-6
PARAM_FAR_SHARE = 1e-3
# A ReLU tie: a pre-activation within fp32 rounding of zero takes one side
# on the card and the other on the CPU, and moves every gradient fed
# through it by far more than rounding (the widths geometry at S=8: a
# 128-wide Att tail's h at -2.2e-7 on the CPU moved a2m.att.1's edge-chain
# leaves to 5.5x their tolerance, exactly as a 1e-7 relative move of the
# CPU's own parameters does; upstream of that tail MapNet's leaves moved
# to 0.99x and 6,310 parameters stepped apart, on the card as on the
# CPU). This loosens the check: where a leaf misses, the CPU step is taken
# again from the same parameters and then from parameters moved by
# TIE_PERTURB of their size (seeded: 1, 2, ..., at most TIE_MOVES moves),
# recording every torch.relu input (`relu_recorder`). A tie is confirmed
# by the first move for which all three hold: a ReLU input within
# TIE_EPS["float32"] of zero (relative to its RMS) takes the other side in
# the moved step (`relu_flips`); the move carries a missing leaf's own
# gradient past its tolerance; and the moved step reproduces the card's
# miss, every leaf that missed against the first CPU step lying within
# its tolerance of the moved one. Then the card's whole step (every
# gradient leaf and every parameter after it) is held to the moved CPU
# step (`reference`), never a mix of the two; otherwise (no move
# confirms) to the first CPU step alone, as before. A random move of
# 1e-7 need not flip the input the card flipped, hence several seeds (the
# half geometry at S=8: seed 1 flipped no ReLU); a kernel fault is not
# a ReLU flip, so no move reproduces it.
TIE_PERTURB = 1e-7
TIE_MOVES = 8


def relu_recorder(near=None):
    """A TorchFunctionMode that records each torch.relu input in call order:
    where `near` is None, the elements within TIE_EPS["float32"] of zero,
    relative to the input's RMS, as (flat index, value); else, call by call,
    the values at the indices `near` (an earlier run's `calls`) holds."""
    import torch
    from torch.overrides import TorchFunctionMode

    class ReluInputs(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.relu, torch.nn.functional.relu):
                x = args[0].detach().reshape(-1).float()
                if near is None:
                    rms = x.square().mean().sqrt() if x.numel() else 0.0
                    idx = (x.abs() <= TIE_EPS["float32"] * rms).nonzero().reshape(-1)
                else:
                    idx = near[len(self.calls)][0]
                self.calls.append((idx, x[idx]))
            return func(*args, **(kwargs or {}))

    return ReluInputs()


def relu_flips(near, moved):
    """[(call, element, first, second)]: the ReLU inputs within rounding of
    zero in one run (`near`, a relu_recorder's calls) that take the other
    side of zero in a second run of the same calls (`moved`), nearest zero
    first."""
    flips = []
    for k, ((idx, a), (_, b)) in enumerate(zip(near, moved)):
        for i in ((a > 0) != (b > 0)).nonzero().reshape(-1).tolist():
            flips.append((k, int(idx[i]), float(a[i]), float(b[i])))
    return sorted(flips, key=lambda f: abs(f[2]))


def train_parity_phase(geom):
    """One float32 make_train_step, 8 scenarios: card vs CPU from the same
    weights, with the model's optimizer (get_model: LaneRCNN's AdamW).
    Loss, every gradient, and the parameters after the step; on LaneRCNN
    the NMS picks of the two forwards must be equal."""
    import torch
    from lanegcn_tpu_torch.graph import PackedBatch, RoiPackedBatch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    s = 8
    family = GEOMETRIES[geom]["model"]
    roi = family == "lanercnn"
    cfg = pack_config(geom, s)
    # The RoI pack is the parity phase's (seeds 20,000-20,007 overflow
    # lanercnn_pack_config(8)'s RoI capacity: one scenario is skipped).
    packs, _, _, _ = make_packs(cfg, 1, s, seed0=10_000 if roi else 20_000, roi=roi,
                                pack_kw=pack_kwargs(geom))
    batch = (RoiPackedBatch if roi else PackedBatch).from_numpy(packs[0])
    bundle = get_model(family, cfg, device="cuda", seed=2)
    cfg = bundle.config
    net_g = bundle.net
    net_c = get_model(family, cfg, device="cpu", seed=2).net
    net_c.load_state_dict({k: v.cpu() for k, v in net_g.state_dict().items()})
    start = {k: v.clone() for k, v in net_c.state_dict().items()}
    fns = dict(loss_fn=bundle.loss_fn, metrics_fn=bundle.metrics_fn)
    net_g, state_g = init_state(cfg, net=net_g)
    net_c, state_c = init_state(cfg, net=net_c, device="cpu")
    picks = {}
    with nms_recorder(picks, "cuda"):
        m_g = make_train_step(cfg, net_g, state_g, **fns)(batch, 0.0)
    with nms_recorder(picks, "cpu"):
        m_c = make_train_step(cfg, net_c, state_c, device="cpu", **fns)(batch, 0.0)
    loss_g, loss_c = float(m_g["loss"]), float(m_c["loss"])
    grads_g = {n: p.grad for n, p in net_g.named_parameters()}
    grads_c = {n: p.grad for n, p in net_c.named_parameters()}
    check(set(grads_g) == set(grads_c), "train_parity: parameter names differ")
    missing = sorted(n for n in grads_g if grads_g[n] is None or grads_c[n] is None)
    check(not missing, f"train_parity: no gradient for {missing[:5]} ({len(missing)})")
    top = max(float(g.abs().max()) for g in grads_c.values())
    scales = {n: max(float(g.abs().max()), GRAD_FLOOR * top) for n, g in grads_c.items()}

    def grad_shares(grads_ref):
        """{leaf: (error over tolerance, error, max |g|)} of the card's
        gradients against one CPU step's."""
        out = {}
        for n, ref in grads_ref.items():
            err = float((grads_g[n].cpu() - ref).abs().max())
            out[n] = (err / (GRAD_TOL * scales[n]), err, float(ref.abs().max()))
        return out

    def cpu_step(move, near=None):
        """The CPU step again from `start` (moved by TIE_PERTURB with seed
        `move`, where it is not 0), with its ReLU inputs recorded: (net,
        calls)."""
        net = get_model(family, cfg, device="cpu", seed=2).net
        net.load_state_dict(start)
        if move:
            gen = torch.Generator().manual_seed(move)
            with torch.no_grad():
                for p in net.parameters():
                    p.mul_(1 + TIE_PERTURB * torch.randn(p.shape, generator=gen))
        net, state = init_state(cfg, net=net, device="cpu")
        rec = relu_recorder(near)
        with rec:
            make_train_step(cfg, net, state, device="cpu", **fns)(batch, 0.0)
        return net, rec.calls

    shares = grad_shares(grads_c)
    worst_vs_cpu = max(v[0] for v in shares.values())
    reference, net_ref, tie_leaves, flips, tie_move = "cpu", net_c, [], [], None
    tries = []
    if worst_vs_cpu > 1.0:
        missed = sorted(n for n in shares if shares[n][0] > 1.0)
        _, near = cpu_step(0)
        for move in range(1, TIE_MOVES + 1):
            net_t, moved = cpu_step(move, near)
            check(len(moved) == len(near), f"train_parity: the moved CPU step made "
                  f"{len(moved)} ReLU calls, the first {len(near)}")
            flips = relu_flips(near, moved)
            grads_t = {n: p.grad for n, p in net_t.named_parameters()}
            tie_leaves = [n for n in missed if float(
                (grads_t[n] - grads_c[n]).abs().max()) > GRAD_TOL * scales[n]]
            shares_t = grad_shares(grads_t)
            tries.append({"seed": move, "relu_flips": len(flips),
                          "nearest_relu_flips": flips[:3], "carried": tie_leaves,
                          "missed_vs_moved": {n: shares_t[n][0] for n in missed}})
            if flips and tie_leaves and all(shares_t[n][0] <= 1.0 for n in missed):
                tie_move, reference, net_ref, shares = move, "cpu_moved", net_t, shares_t
                break
    ranked = sorted(shares, key=lambda n: -shares[n][0])
    worst, worst_name = shares[ranked[0]][0], ranked[0]

    # The control: the CPU's step from the same start, each gradient leaf
    # moved by uniform noise of GRAD_TOL of its scale.
    net_x = get_model(family, cfg, device="cpu", seed=2).net
    net_x.load_state_dict(start)
    net_x, state_x = init_state(cfg, net=net_x, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for n, p in net_x.named_parameters():
        noise = 2 * torch.rand(p.shape, generator=gen) - 1
        p.grad = grads_c[n] + GRAD_TOL * scales[n] * noise
    state_x.opt.step(m_c["lr"])

    def apart(net, ref):
        """The largest distance from `ref`'s parameters, the elements farther
        than PARAM_FAR and the five leaves with the most of them."""
        refs = dict(ref.named_parameters())
        diffs = {n: (p.detach().cpu() - refs[n].detach()).abs() for n, p in net.named_parameters()}
        far = {n: int((d > PARAM_FAR).sum()) for n, d in diffs.items()}
        top = sorted(far, key=lambda n: -far[n])[:5]
        return (max(float(d.max()) for d in diffs.values()), sum(far.values()),
                [[n, far[n]] for n in top])

    lr = float(m_c["lr"])
    p_err, n_far, far_leaves = apart(net_g, net_ref)
    _, n_far_control, _ = apart(net_x, net_c)
    n_params = sum(p.numel() for p in net_c.parameters())
    nms = nms_report(picks) if roi else {}
    emit({"phase": "train_parity", "geometry": geom, "scenarios": s, "opt": cfg.train.opt,
          "weight_decay": cfg.train.weight_decay, "loss_gpu": loss_g, "loss_cpu": loss_c,
          "leaves": len(grads_g), "grad_tol_rel": GRAD_TOL, "grad_floor": GRAD_FLOOR * top,
          "worst_grad_err_over_tol": worst, "worst_grad_leaf": worst_name,
          "worst_leaves": [[n, *shares[n]] for n in ranked[:5]],
          "reference": reference, "worst_grad_err_over_tol_vs_cpu": worst_vs_cpu,
          "tie_leaves": tie_leaves, "tie_perturb": TIE_PERTURB, "tie_move": tie_move,
          "relu_flips": len(flips), "nearest_relu_flips": flips[:3], "tie_tries": tries,
          "param_max_abs_err": p_err, "param_max_tol": 2 * lr, "param_far": PARAM_FAR,
          "params_far": n_far, "params_far_limit": PARAM_FAR_SHARE * n_params,
          "far_leaves": far_leaves,
          "params_far_control": n_far_control, "params": n_params, **nms})
    if roi:
        check(nms["nms_picks_differ"] == 0,
              f"train_parity: {nms['nms_picks_differ']} NMS picks differ")
    check(abs(loss_g - loss_c) <= 1e-3 * max(1.0, abs(loss_c)),
          f"train_parity loss: {loss_g} vs {loss_c}")
    check(worst <= 1.0, f"train_parity: {worst_name}'s gradient error is {worst} x its "
          f"tolerance ({GRAD_TOL} of the leaf's max |g|)")
    check(p_err <= 2 * lr, f"train_parity: params differ by {p_err} > 2·lr = {2 * lr}")
    check(n_far <= PARAM_FAR_SHARE * n_params, f"train_parity: {n_far} of {n_params} params "
          f"differ by more than {PARAM_FAR}, more than {PARAM_FAR_SHARE} of them")
    check(n_far_control > PARAM_FAR_SHARE * n_params, f"train_parity: the control moved only "
          f"{n_far_control} params, so the params check cannot tell gradients apart")


# Host calls that wait for the device: `nonzero` (a compaction) and
# `_local_scalar_dense` (.item()). A step must make no `nonzero` call.
HOST_SYNCS = ("aten::nonzero", "aten::_local_scalar_dense")


def _union_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy


def profile_phase(phase, geom, step, items, top_n=40) -> dict:
    """torch.profiler (CUPTI) over step(item) for each item: device time by
    kernel name, the device's idle share of the host wall time (which
    includes the profiler's own overhead, so the share is an upper bound),
    and the host syncs per step (no `nonzero` or `_local_scalar_dense`,
    asserted); returns the emitted numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in items:
            step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    syncs = dict.fromkeys(HOST_SYNCS, 0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.name in syncs:
                syncs[e.name] += 1
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + (t1 - t0))
    check(bool(spans), f"{phase}: no device activity was traced")
    busy = _union_us(spans)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top_n]
    res = {"phase": phase, "geometry": geom, "steps": len(items), "wall_ms": wall_us / 1e3,
           "device_busy_ms": busy / 1e3, "busy_ms_per_step": busy / 1e3 / len(items),
           "idle_share": 1.0 - busy / wall_us,
           "host_syncs_per_step": {k: v / len(items) for k, v in syncs.items()},
           "by_name": [[name[:90], n, us / 1e3] for name, (n, us) in top]}
    emit(res)
    for name in HOST_SYNCS:
        check(syncs[name] == 0, f"{phase}: {syncs[name]} {name} host syncs in {len(items)} steps")
    return res


def check_counts(counts, per, steps, what):
    for entry, n in counts.items():
        want = per.get(entry, 0) * steps
        check(n == want, f"{what}: {entry} launched {n} times in {steps} steps, "
              f"expected {per.get(entry, 0)} each")


def drive(geom):
    """Every phase of one geometry; returns its kernel results and the
    launch counts of its serve and train runs."""
    import torch
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    spec = GEOMETRIES[geom]
    if spec["model"] == "lanercnn":
        return drive_lanercnn(geom)
    s = spec["s"]
    cfg = pack_config(geom, s)

    # --- pack ---
    packs, stats, gen_s, pack_s = make_packs(cfg, 2, s, seed0=0, pack_kw=pack_kwargs(geom))
    t0 = time.perf_counter()
    batches = [PackedBatch.from_numpy(b).to("cuda") for b in packs]
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    st = stats[0]
    residue = [sum(int(e.mask.sum()) for e in b.graph.edges.values()) for b in packs]
    spill = [x.get("spill_pair_edges", 0) for x in stats]
    emit({"phase": "pack", "geometry": geom, "scenarios_per_pack": s, "packs": len(packs),
          "gen_s": gen_s, "pack_s": pack_s, "transfer_s": transfer_s,
          "nodes": st["num_nodes"], "node_cap": cfg.pack.max_nodes,
          "actors": st["num_actors"], "plan_edges": st.get("plan_edges", 0),
          "spilled_plan_edges": st.get("spilled_plan_edges", 0), "spill_pair_edges": spill,
          "residue_list_edges": residue,
          "residue_list_slots": sum(cfg.pack.edge_capacity(nm) for nm in packs[0].graph.edges)})
    if cfg.pack.spill_pairs:
        check(all(x > 0 for x in spill), f"{geom}: no spill-plan edges {spill}")

    # The entry points a user calls: the registry's net, then the eval step.
    net = get_model("lanegcn", cfg, dtype=torch.bfloat16, device="cuda", seed=0).net
    step = make_eval_step(cfg, net)

    # --- kernels against their plain versions, on the eval path's inputs ---
    with forward_capture() as cap:
        step(batches[0])
    torch.cuda.synchronize()
    if geom == "windowed":
        calls, counts, empty = plan_case_calls(backward=False)
        cap.calls["scenario_agg"].update(calls)
        cap.counts["scenario_agg"].update(counts)
        check_empty_plan(calls[empty])
        calls, counts = lane_case_calls(cap.calls["lane_layer"])
        cap.calls["lane_layer"].update(calls)
        cap.counts["lane_layer"].update(counts)
        calls, counts, empty = win_case_calls(forward=True)
        cap.calls["win_edge"].update(calls)
        cap.counts["win_edge"].update(counts)
        check_empty_win(calls[empty])
        add_tail_cases("row_tail", cap)
    if geom == "bench":
        calls, counts, empty = spill_case_calls(backward=False)
        cap.calls["pair_agg"].update(calls)
        cap.counts["pair_agg"].update(counts)
        check_empty_spill(calls[empty])
    if geom in ("unfused", "half_unfused"):
        calls, counts = lane_case_calls(cap.calls["band_conv"], "band_conv")
        cap.calls["band_conv"].update(calls)
        cap.counts["band_conv"].update(counts)
    if geom in ("merged", "half_merged"):
        calls, counts, _ = plan_case_calls(backward=False, layer=True, width=cfg.model.n_map)
        cap.calls["lane_plan"].update(calls)
        cap.counts["lane_plan"].update(counts)
    if geom == "widths":
        add_tail_cases("row_tail", cap, width=64)
    if geom in ("half", "double"):
        calls, counts = lane_case_calls(cap.calls["lane_layer"])
        cap.calls["lane_layer"].update(calls)
        cap.counts["lane_layer"].update(counts)
        add_tail_cases("row_tail", cap, width=cfg.model.n_actor)
    edge_pad = (add_edge_cases("edge_mlp", cap) if geom in ("contiguous", "widths", "double")
                else None)
    results = kernel_phase("kernel", geom, forward_ops(spec["kernels"]), cap.calls, cap.counts)
    if edge_pad is not None:
        check_edge_padding(geom, "edge_mlp", edge_pad)
    del cap, edge_pad
    # --- backward kernels against their plain backwards, on a train step's inputs ---
    net_t, state = init_state(cfg, dtype=torch.bfloat16)
    tstep = make_train_step(cfg, net_t, state)
    with backward_capture() as cap:
        tstep(batches[0], 0.0)
    torch.cuda.synchronize()
    results.update(step_kernel_phases(geom, cap))
    del cap

    # --- card vs CPU, float32 ---
    parity_phase(geom)
    train_parity_phase(geom)

    serve = serve_phase(geom, step, batches, results, pack_s)
    train = train_phase(geom, tstep, batches, results)
    profile_phase("profile_train", geom, lambda b: tstep(b, 0.5), batches[:1])
    rerun_phase(geom, cfg, lambda: LaneGCN(cfg.model, dtype=torch.bfloat16, device="cuda",
                                           seed=0), batches[0], {})
    if "ab" in spec:
        ab_phase(geom, batches)
    if spec.get("serve_rerun"):
        serve_rerun_phase(geom, step, batches[0])
    if "refused_serve" in spec:
        refused_serve_phase(geom)
    return results, serve, train


# segment_sum's edge cases (name, num_segments, seg, channels): the kernel's
# blocks own 32 destination rows each below 32,768 rows and 128 from there
# ("128-row-blocks"), and take 16-byte chunks where a row allows them.
SEGMENT_CASES = (
    ("long-run", 700, lambda rng: np.sort(np.concatenate([np.full(600, 5),
                                                          rng.integers(0, 700, 301)])), 128),
    ("across-blocks", 1000, lambda rng: np.concatenate([np.sort(rng.integers(250, 270, 502)),
                                                        np.full(20, 1000)]), 128),
    ("all-dropped", 300, lambda rng: np.array([300] * 50 + [305] * 5), 128),
    ("no-edges", 301, lambda rng: np.zeros(0, np.int64), 128),
    ("ragged-rows", 777, lambda rng: np.sort(rng.integers(0, 790, 2003)), 128),
    ("6-channels", 300, lambda rng: np.sort(rng.integers(0, 300, 907)), 6),
    ("128-row-blocks", 40003, lambda rng: np.sort(np.concatenate([
        rng.integers(120, 140, 500), np.full(300, 20000), rng.integers(0, 40010, 2000)])), 128),
)


def segment_case_calls():
    """{shapes: args} and {shapes: 0} of SEGMENT_CASES, with and without
    out, bf16 on the card (kernel_phase casts them to fp32 too)."""
    import torch

    rng = np.random.default_rng(11)
    calls, counts = {}, {}
    for _, n, make, c in SEGMENT_CASES:
        seg = torch.as_tensor(make(rng).astype(np.int64), device="cuda")
        data = torch.as_tensor(rng.normal(size=(seg.shape[0], c)), dtype=torch.bfloat16,
                               device="cuda")
        out = torch.as_tensor(rng.normal(size=(n, c)), dtype=torch.bfloat16, device="cuda")
        for args in ([data, seg, n], [data, seg, n, out]):
            key = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            calls[key], counts[key] = args, 0
    return calls, counts


# scenario_agg's edge cases (name, windows, window rows, plan slots per
# window, grouped, fill): the kernels walk the applied edges in 64-edge tiles
# of one relation each (runs that end inside, at and past a tile boundary),
# write each message at its destination position and sum the positions of a
# row in a fixed order (a row with 300 edges); a grouped plan drops the
# edges outside their chunk's relation group ("unaligned-groups"), and an
# empty plan leaves temp as it is (bitwise). `fill(rng, lu, lv, rel)` writes
# the [windows, slots] plan.
def _plan_runs(runs, hot=None, window=0):
    """Fill window `window` with relation runs {relation: edges}, in
    relation order (every destination `hot` where given)."""
    def fill(rng, lu, lv, rel, stride):
        o = 0
        for r, k in runs.items():
            lu[window, o:o + k] = rng.integers(0, stride, k) if hot is None else hot
            lv[window, o:o + k] = rng.integers(0, stride, k)
            rel[window, o:o + k] = r
            o += k
    return fill


def _plan_grouped(per_window, misplace=False):
    """Grouped layout: per window (left/right edges, dilated edges), the
    dilated ones from the next 512-slot chunk; `misplace` moves one dilated
    relation into each window's left/right chunk and one left/right
    relation into its dilated chunk (both dropped)."""
    def fill(rng, lu, lv, rel, stride):
        for w, (k_lr, k_dil) in enumerate(per_window):
            lu[w, :k_lr] = rng.integers(0, stride, k_lr)
            lv[w, :k_lr] = rng.integers(0, stride, k_lr)
            rel[w, :k_lr] = rng.choice([12, 13], k_lr)
            o = -(-k_lr // 512) * 512
            lu[w, o:o + k_dil] = rng.integers(0, stride, k_dil)
            lv[w, o:o + k_dil] = rng.integers(0, stride, k_dil)
            rel[w, o:o + k_dil] = np.sort(rng.integers(0, 12, k_dil))
            if misplace and k_lr and k_dil:
                rel[w, 0], rel[w, o] = 3, 13
    return fill


PLAN_CASES = (
    ("empty", 4, 768, 2048, True, lambda *a: None),
    ("one-relation", 5, 512, 1024, False, _plan_runs({5: 900})),
    ("tile-straddle", 6, 256, 1024, False, _plan_runs({0: 63, 1: 64, 2: 65, 3: 129, 9: 1})),
    ("full-window", 2, 768, 2048, True, _plan_grouped([(1024, 1024), (300, 700)])),
    ("hot-row", 2, 1024, 1024, False, _plan_runs({2: 100, 7: 150, 12: 50}, hot=7)),
    ("unaligned-groups", 3, 768, 2048, True,
     _plan_grouped([(600, 900), (40, 300), (0, 0)], misplace=True)),
)


# lane_plan's band shifts in its PLAN_CASES calls: ±1 .. ±32 (the model's
# dilations), so that the band products reach the ±32-row halo.
PLAN_SHIFTS = tuple(s for k in range(6) for s in (-(1 << k), 1 << k))


def plan_case_calls(backward: bool, layer: bool = False, dev: str = "cuda", width: int = 128):
    """{shapes: args} and {shapes: 0} of PLAN_CASES on `width`-wide rows,
    bf16 on `dev` (kernel_phase casts them to fp32 too), as scenario_agg's
    forward (feat, temp, w_rel, lu, lv, rel, windows, groups) or backward
    launcher (feat, w_rel, lu, lv, rel, windows, groups, g) takes them, or
    with `layer` as lane_plan's (`plan_layer_args`); and the key of the
    empty plan."""
    import torch

    rng, layer_rng = np.random.default_rng(13), np.random.default_rng(17)
    calls, counts, empty = {}, {}, None
    bf = lambda *shape, scale=1.0: torch.as_tensor(rng.normal(size=shape) * scale,
                                                   dtype=torch.bfloat16, device=dev)

    for name, num_win, stride, ecap, grouped, fill in PLAN_CASES:
        lu = np.full((num_win, ecap), -1, np.int32)
        lv, rel = lu.copy(), lu.copy()
        fill(rng, lu, lv, rel, stride)
        plan = [torch.as_tensor(x.reshape(-1, 1), device=dev) for x in (lu, lv, rel)]
        groups = (tuple(range(12, 14)), tuple(range(12))) if grouped else None
        n = num_win * stride
        feat, w_rel = bf(n, width), bf(14, width, width, scale=width ** -0.5)
        args = ([feat, w_rel, *plan, num_win, groups, bf(n, width)] if backward
                else [feat, bf(n, width), w_rel, *plan, num_win, groups])
        if layer:  # the same plans; the layer's other inputs from a generator of their own
            args = plan_layer_args(layer_rng, feat, w_rel, plan, num_win, groups, backward)
        key = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
        calls[key], counts[key] = args, 0
        if name == "empty":
            empty = key
    return calls, counts, empty


def plan_layer_args(rng, feat, w_rel, plan, num_win, groups, backward):
    """lane_plan's arguments on one plan case: random band masks (half the
    rows) over PLAN_SHIFTS, band and tail weights and GN vectors at feat's
    width; forward (feat, pre, masks, wb, w2, g1w, g1b, g2w, g2b, w_rel, lu,
    lv, rel, windows, shifts, groups) or backward launcher (feat, temp,
    masks, wb, w2, the GN vectors, w_rel, lu, lv, rel, windows, groups, g,
    shifts), temp the plain forward's fp32 temp on the forward case's
    inputs."""
    import torch
    from lanegcn_tpu_torch.ops import lane_layer

    (n, c), j, dev = feat.shape, len(PLAN_SHIFTS), feat.device
    bf = lambda *shape, scale=1.0: torch.as_tensor(rng.normal(size=shape) * scale,
                                                   dtype=torch.bfloat16, device=dev)
    masks = torch.as_tensor(rng.random((j, n)) < 0.5, device=dev)
    wb, w2 = bf(j, c, c, scale=c ** -0.5), bf(c, c, scale=c ** -0.5)
    gns = [torch.as_tensor(1.0 + 0.1 * rng.normal(size=c) if k % 2 == 0
                           else 0.1 * rng.normal(size=c), dtype=torch.float32,
                           device=dev) for k in range(4)]
    pre, g = bf(n, c), bf(n, c)  # both drawn either way: the cases match
    if not backward:
        return [feat, pre, masks, wb, w2, *gns, w_rel, *plan, num_win, PLAN_SHIFTS, groups]
    temp = lane_layer._plan_temp_plain(feat, pre, masks, wb, PLAN_SHIFTS, w_rel, *plan, num_win,
                                       groups)
    return [feat, temp, masks, wb, w2, *gns, w_rel, *plan, num_win, groups, g, PLAN_SHIFTS]


def check_empty_plan(fwd_args):
    """The empty plan's forward returns temp bitwise, in both dtypes."""
    import torch
    from lanegcn_tpu_torch.ops import scenario_agg

    for dtype in (torch.float32, torch.bfloat16):
        a = cast_args(fwd_args, dtype)
        check(torch.equal(scenario_agg.scenario_aggregate(*a), a[1]),
              f"scenario_agg {dtype}: the empty plan's output is not temp")


# Row counts that are no multiple of the tensor-core backward passes' row
# blocks (192 rows in the band passes, 128 in the row pass, 64 and 128 in
# row_tail2_bwd's chain and weight-gradient passes), so that their partial
# tiles run: the row guards and the zeroed halo and mask rows. The K = 2
# tail's backward also runs one row, a chain tile less and more a row, and
# a weight-gradient tile less and more a row (RAGGED_EXTRA_ROWS).
RAGGED_ROWS = (1000, 20000)
RAGGED_BWD = ("lane_layer_bwd", "band_conv_bwd", "row_tail_bwd", "row_tail2_bwd")
RAGGED_EXTRA_ROWS = {"row_tail2_bwd": (1, 63, 65, 127, 129)}
# Calls narrower than 128 (row_tail_bwd on 64-wide actor rows, a few
# hundred of them): also cut around the bf16 row pass's 128-row tiles.
RAGGED_NARROW_ROWS = (1, 127, 129)


def cut_rows(args, n):
    """A captured call's arguments with every [N, ...] tensor cut to its
    first n rows and every [J, N] band mask to its first n columns (N: the
    first argument's rows)."""
    import torch

    big = args[0].shape[0]
    return [a if not isinstance(a, torch.Tensor)
            else a[:n].clone() if a.shape[0] == big
            else a[:, :n].contiguous() if a.dim() == 2 and a.shape[1] == big
            else a for a in args]


def shape_key(args):
    import torch

    return tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))


def ragged_calls(calls):
    """{kernel: {shapes: args}}: each RAGGED_BWD kernel's captured call with
    the most rows, of each row width it was called at, cut to each of
    RAGGED_ROWS rows (and of its RAGGED_EXTRA_ROWS; below 128 wide, of
    RAGGED_NARROW_ROWS)."""
    cut = {}
    for name in RAGGED_BWD:
        if not calls.get(name):
            continue
        cut[name] = {}
        for width in sorted({call_width(name, a) for a in calls[name].values()}):
            args = max((a for a in calls[name].values() if call_width(name, a) == width),
                       key=lambda a: a[0].shape[0])
            rows = RAGGED_EXTRA_ROWS.get(name, ()) + RAGGED_ROWS
            if width < 128:
                rows = RAGGED_NARROW_ROWS + rows
            for n in (n for n in rows if n < args[0].shape[0]):
                part = cut_rows(args, n)
                cut[name][shape_key(part)] = part
    return cut


# lane_layer's and band_conv's edge cases: their bf16 forwards' blocks own
# 192 rows (three warpgroups of 64; band_conv runs lane_layer's band loop),
# so the captured call with the most rows is cut to one row, one row short
# of a block and one row past it (LANE_ROWS), and to two blocks and a row
# with relation 0's band mask all zero (every warpgroup skips that
# relation). kernel_phase runs each lane_layer case without temp_out and,
# through check_temp, with it.
LANE_ROWS = (1, 191, 193)
LANE_ZERO_REL_ROWS = 385
LANE_MASK_ARG = {"lane_layer": 2, "band_conv": 1}  # the band masks' argument


def lane_case_calls(calls, name="lane_layer"):
    """{shapes: args} and {shapes: 0} of lane_layer's (or band_conv's) edge
    cases, cut from its captured forward calls."""
    args = max(calls.values(), key=lambda a: a[0].shape[0])
    m = LANE_MASK_ARG[name]
    cases, counts = {}, {}
    for n in LANE_ROWS + (LANE_ZERO_REL_ROWS,):
        part = cut_rows(args, n)
        if n == LANE_ZERO_REL_ROWS:
            part[m] = part[m].clone()
            part[m][0] = 0
        cases[shape_key(part)], counts[shape_key(part)] = part, 0
    return cases, counts


# The row tails' edge cases: the bf16 forward's warpgroups own 64-row tiles,
# so the captured call with the most rows is cut to one row, one row short
# of a tile and one row past it, and (K = 2) to a ragged count of many
# tiles.
TAIL_ROWS = {"row_tail": (1, 63, 65), "row_tail2": (1, 63, 65, 12345)}


def add_tail_cases(name, cap, width=None):
    """Adds TAIL_ROWS[name]'s cuts of the row tail's largest captured
    forward call (of that row width, where given) to the capture (0 calls a
    step each)."""
    args = max((a for a in cap.calls[name].values() if width in (None, a[0].shape[1])),
               key=lambda a: a[0].shape[0])
    for n in TAIL_ROWS[name]:
        part = cut_rows(args, n)
        cap.calls[name][shape_key(part)] = part
        cap.counts[name][shape_key(part)] = 0


# The flat edge MLPs' edge cases (Att's edge_mlp on the contiguous
# geometry, LanePooling's edge_mlp_pool on lanercnn): their bf16 kernels'
# warpgroups own 64-row tiles (the backwards' weight-gradient passes 64- or
# 128-edge tiles), so the largest captured forward and backward call is cut
# to one row, one row short of a tile, one past it and a ragged count of
# many tiles (EDGE_ROWS), and to EDGE_PAD_ROWS rows made all padding (d =
# cg = 0, and qg = 0 for Att's; a zero cotangent), which
# `check_edge_padding` also holds to its exact answer: every output row
# equal to row 0, every gradient, dd, dcg (and dqg) zero.
EDGE_ROWS = (1, 63, 65, 12345)
EDGE_PAD_ROWS = 3000
EDGE_PAD_ARGS = {"edge_mlp": (0, 1, 2), "edge_mlp_bwd": (0, 1, 2, 12),  # d, qg, cg (, g)
                 "edge_mlp_pool": (0, 2), "edge_mlp_pool_bwd": (0, 1, 8)}  # d, cg (, g)


def add_edge_cases(name, cap):
    """Adds EDGE_ROWS' cuts of the largest captured call of `name`
    (edge_mlp, edge_mlp_pool or their backwards) and its all-padding call
    to the capture (0 calls a step each); returns the all-padding call."""
    import torch

    args = max(cap.calls[name].values(), key=lambda a: a[0].shape[0])
    pad = cut_rows(args, EDGE_PAD_ROWS)
    for i in EDGE_PAD_ARGS[name]:
        pad[i] = torch.zeros_like(pad[i])
    for part in [cut_rows(args, n) for n in EDGE_ROWS if n < args[0].shape[0]] + [pad]:
        cap.calls[name][shape_key(part)] = part
        cap.counts[name][shape_key(part)] = 0
    return pad


def check_edge_padding(geom, name, a):
    """The all-padding call through the kernel in fp32 and bf16: the
    forward's rows all equal to row 0; every output of the backward (dd,
    dcg (and dqg) and the gradients) exactly zero."""
    import torch

    res = {"phase": "edge_padding", "geometry": geom, "name": name, "rows": EDGE_PAD_ROWS}
    for dtype in (torch.float32, torch.bfloat16):
        x = cast_args(a, dtype)
        tag = str(dtype).split(".")[-1]
        if name.endswith("_bwd"):
            outs = backward_ops([name[:-len("_bwd")]])[name][0](*x)
            res[tag] = [float(o.abs().max()) for o in outs]
            check(not any(res[tag]), f"{name} {tag}: an all-padding call's outputs are not "
                  f"all zero: {res[tag]}")
        else:
            out = forward_ops([name])[name][0](*x)
            res[tag] = bool(torch.equal(out, out[:1].expand_as(out)))
            check(res[tag], f"{name} {tag}: an all-padding call's rows differ from row 0")
    emit(res)


# win_edge's edge cases (name, destination windows x rows, source windows x
# rows, slot capacity, edges, destination window left untouched), for the
# forward and the backward. The forward's chain pass takes the plan's
# 64-slot tiles in turn and skips those without an edge; its sum pass
# finds each destination window's chunks by a search in dwin and adds a
# row's edges in slot order. The backward walks the valid edges in 64-edge
# tiles of the destination order and sums dPd/dQd and dPs/dCs over the
# destination and the source orders. The cases: an empty plan (the
# forward's output is temp, the backward's four zero), a destination
# window no edge reaches (temp / zero rows), a capacity far past the edges
# (tail chunks all padding), an M2A-like plan (two destination windows,
# one run of many chunks each, into 768-row source windows), and runs of
# one chunk (each destination window's edges from one source window,
# fewer than a chunk).
WIN_CASES = (
    ("empty", (3, 128), (4, 128), 1024, 0, None),
    ("untouched-window", (6, 128), (3, 768), 4096, 3000, 2),
    ("padding-chunks", (4, 128), (4, 128), 8192, 300, None),
    ("long-runs", (2, 128), (8, 768), 8192, 5000, None),
    ("one-chunk-runs", (8, 128), (8, 768), 4096, 600, None),
)


def win_case_calls(dev="cuda", forward=False):
    """{shapes: args} and {shapes: 0} of WIN_CASES as win_edge's forward op
    (pd, qd, ps, cs, temp, bd, kdo, gdow, gdob, k1, gchw, gchb, kout, plan)
    or its backward launcher (pd, qd, ps, cs, bd, ..., kout, plan, g) takes
    them, bf16 rows on the card (kernel_phase casts them to fp32 too), fp32
    weights and vectors as the model hands them; and the key of the empty
    plan."""
    import torch
    from lanegcn_tpu_torch.data.packing import build_pair_plan
    from lanegcn_tpu_torch.graph import PairPlan

    rng = np.random.default_rng(17)
    calls, counts, empty = {}, {}, None
    for name, (nwd, sd), (nws, ss), cap, n_edges, skip in WIN_CASES:
        nd, ns = nwd * sd, nws * ss
        u, v = rng.integers(0, nd, n_edges), rng.integers(0, ns, n_edges)
        if name == "one-chunk-runs":
            v = u // sd * ss + v % ss
        if skip is not None:
            keep = u // sd != skip
            u, v = u[keep], v[keep]
        d, dropped = build_pair_plan(u, v, sd, ss, cap, 128)
        check(dropped == 0, f"win_edge case: {dropped} edges dropped")
        idx = np.concatenate([d["lu"], d["lv"]], axis=1)
        meta = np.stack([d[k] for k in ("dwin", "swin", "first", "sperm", "sswin", "sfirst")])
        plan = PairPlan(idx=torch.as_tensor(idx, device=dev), meta=torch.as_tensor(meta, device=dev),
                        chunk=128, dst_stride=sd, src_stride=ss)
        rows = lambda k: torch.as_tensor(rng.normal(size=(k, 128)) * 0.5, dtype=torch.bfloat16,
                                         device=dev)
        f32 = lambda *shape, loc=0.0: torch.as_tensor(rng.normal(size=shape) * 0.1 + loc,
                                                     dtype=torch.float32, device=dev)
        w = lambda: f32(128, 128) * 0.9
        params = [f32(128), w(), f32(128, loc=1.0), f32(128), w(), f32(128, loc=1.0), f32(128),
                  w()]
        args = ([rows(nd), rows(nd), rows(ns), rows(ns), rows(nd), *params, plan] if forward
                else [rows(nd), rows(nd), rows(ns), rows(ns), *params, plan, rows(nd)])
        calls[shape_key(args)], counts[shape_key(args)] = args, 0
        if name == "empty":
            empty = shape_key(args)
    return calls, counts, empty


def check_empty_win(fwd_args):
    """The empty pair plan's forward returns temp bitwise, in both dtypes."""
    import torch
    from lanegcn_tpu_torch.ops import win_edge

    for dtype in (torch.float32, torch.bfloat16):
        a = cast_args(fwd_args, dtype)
        check(torch.equal(win_edge.win_edge_mlp(*a), a[4]),
              f"win_edge {dtype}: the empty plan's output is not temp")


# window_scatter's edge cases (name, windows, rows a window, slot capacity,
# edge maker): the forward sums a segment-sum key derived from (wchunk, lu)
# over blocks of flat rows (128 rows from 32,768 rows on, else 32, which
# straddle windows), passing over padding; the backward gathers g's rows in
# 64-slot tiles of one chunk. Built by the port's window_chunked_edges, as
# the packer builds LanePooling's edges. The cases: an empty plan (the
# forward's output is temp bitwise, the backward's all zero), a destination
# window no edge reaches, a capacity far past the edges (tail chunks all
# padding), one row whose run spans more than two 512-slot chunks, rows
# with edges on both sides of 128-row block boundaries, and a 200-row
# stride (no multiple of the block's rows: blocks straddle windows). `make(rng,
# windows, stride)` returns the edges' flat destination rows.
# segment_sum.cuh's forward blocks: ROWS_BIG rows from BIG_FROM rows on, else ROWS_SMALL.
SCATTER_BLOCKS = {"ROWS_BIG": 128, "ROWS_SMALL": 32, "BIG_FROM": 32768}
SCATTER_CASES = (
    ("empty", 3, 256, 1024, lambda rng, nw, sd: np.zeros(0, np.int64)),
    ("untouched-window", 5, 256, 4096,
     lambda rng, nw, sd: np.concatenate([rng.integers(0, 2 * sd, 900),
                                         rng.integers(3 * sd, nw * sd, 900)])),
    ("padding-chunks", 4, 256, 8192, lambda rng, nw, sd: rng.integers(0, nw * sd, 300)),
    ("long-run", 3, 256, 8704,
     lambda rng, nw, sd: np.concatenate([np.full(1300, sd + 77),
                                         rng.integers(0, nw * sd, 1500)])),
    ("across-blocks", 130, 256, 69632,
     lambda rng, nw, sd: np.concatenate([w * sd + rng.integers(120, 136, 40)
                                         for w in range(0, nw, 3)] +
                                        [rng.integers(0, nw * sd, 20000)])),
    ("stride-200", 170, 200, 90112, lambda rng, nw, sd: rng.integers(0, nw * sd, 30000)),
)


def scatter_case_calls(backward: bool, dev: str = "cuda", width: int = 128):
    """{shapes: args} and {shapes: 0} of SCATTER_CASES, bf16 rows `width`
    wide (kernel_phase casts them to fp32 too), as window_scatter's forward
    op (msg, temp, lu, wchunk, stride) or its backward launcher (g, lu,
    wchunk, stride) takes them; and the key of the empty plan."""
    import torch
    from lanegcn_tpu_torch.data.packing import window_chunked_edges

    rng = np.random.default_rng(23)
    calls, counts, empty = {}, {}, None
    for name, num_win, stride, cap, make in SCATTER_CASES:
        u = make(rng, num_win, stride)
        es, dropped = window_chunked_edges(u, rng.integers(0, 50, len(u)), cap, stride, 50)
        check(dropped == 0, f"window_scatter case {name}: {dropped} edges dropped")
        lu = torch.as_tensor(es.win_lu, device=dev)
        wchunk = torch.as_tensor(es.win_chunk, device=dev)
        rows = lambda k: torch.as_tensor(rng.normal(size=(k, width)), dtype=torch.bfloat16,
                                         device=dev)
        n = num_win * stride
        args = ([rows(n), lu, wchunk, stride] if backward
                else [rows(cap), rows(n), lu, wchunk, stride])
        key = shape_key(args)
        check(key not in calls, f"window_scatter case {name}: its shapes repeat another case's")
        calls[key], counts[key] = args, 0
        if name == "empty":
            empty = key
    return calls, counts, empty


def check_empty_scatter(args, backward: bool):
    """The empty plan, in both dtypes: the forward returns temp bitwise, the
    backward all zeros."""
    import torch
    from lanegcn_tpu_torch.ops import window_scatter

    for dtype in (torch.float32, torch.bfloat16):
        a = cast_args(args, dtype)
        if backward:
            out = window_scatter.window_scatter_bwd_cuda(*a)
            check(not bool(out.any()), f"window_scatter_bwd {dtype}: the empty plan's "
                  f"gradient is not all zero")
        else:
            check(torch.equal(window_scatter.window_scatter_add(*a), a[1]),
                  f"window_scatter {dtype}: the empty plan's output is not temp")


# pair_agg's edge cases on the spill plan (name, windows, rows a window,
# slot capacity, {relation: edges}, destination window of every edge or
# None, each destination window's edges from its own source window, rows
# cut off the end of the node rows): both directions walk the valid slots
# in 64-edge tiles of one relation each, write each message at its
# destination (source) position and sum a row's positions in a fixed order
# from temp (from zero). An empty plan (the forward's output is temp
# bitwise, the backward's zero), a capacity far past the edges (tail chunks
# all padding), a relation with one edge beside relations with none, rows
# past n (the edges into and out of the last 100 rows are not valid), runs
# of one chunk, one destination window's run of many chunks, and 1,536-row
# windows (no window sits in shared memory: any stride is taken).
# Each case has a row count of its own: the captures key calls by shapes.
SPILL_CASES = (
    ("empty", 4, 768, 1024, {}, None, False, 0),
    ("padding-chunks", 2, 768, 8192, {4: 150, 11: 50}, None, False, 0),
    ("one-edge-relation", 6, 768, 8192, {0: 700, 5: 1, 13: 400}, None, False, 0),
    ("rows-past-n", 5, 768, 8192, {3: 900, 8: 600}, None, False, 100),
    ("one-chunk-runs", 8, 768, 4096, {2: 300, 9: 200}, None, True, 0),
    ("long-run", 5, 768, 8192, {1: 1500, 7: 1500}, 2, False, 0),
    ("1536-row-windows", 5, 1536, 8192, {0: 800, 6: 900, 12: 700}, None, False, 0),
)


def spill_case_calls(backward: bool, width: int = 128):
    """{shapes: args} and {shapes: 0} of SPILL_CASES on `width`-wide rows,
    bf16 on the card (kernel_phase casts them to fp32 too), as pair_agg's
    forward op (feat, temp, w_rel, plan, prep) or its backward launcher
    (feat, w_rel, plan, g, prep) takes them, each with the plan's
    `prepare_spill` (forward-only for the forward), as a LaneGCN forward
    hands it; and the key of the empty plan."""
    import torch
    from lanegcn_tpu_torch.data.packing import build_pair_plan
    from lanegcn_tpu_torch.graph import PairPlan
    from lanegcn_tpu_torch.ops import pair_agg

    rng = np.random.default_rng(19)
    calls, counts, empty = {}, {}, None
    bf = lambda *shape, scale=1.0: torch.as_tensor(rng.normal(size=shape) * scale,
                                                   dtype=torch.bfloat16, device="cuda")
    for name, num_win, stride, cap, rels, dst_win, same_win, cut in SPILL_CASES:
        rows = num_win * stride
        k = sum(rels.values())
        u, v = rng.integers(0, rows, k), rng.integers(0, rows, k)
        if dst_win is not None:
            u = dst_win * stride + u % stride
        if same_win:
            v = u // stride * stride + v % stride
        rel = np.repeat(np.array(list(rels), np.int32), list(rels.values()))
        d, dropped, _ = build_pair_plan(u, v, stride, stride, cap, 128, rel=rel,
                                        return_residue=True)
        check(dropped == 0, f"pair_agg case {name}: {dropped} edges dropped")
        idx = np.concatenate([d["lu"], d["lv"], d["rel"]], axis=1)
        meta = np.stack([d[x] for x in ("dwin", "swin", "first", "sperm", "sswin", "sfirst")])
        plan = PairPlan(idx=torch.as_tensor(idx, device="cuda"),
                        meta=torch.as_tensor(meta, device="cuda"), chunk=128,
                        dst_stride=stride, src_stride=stride)
        n = rows - cut
        feat, w_rel = bf(n, width), bf(14, width, width, scale=width ** -0.5)
        prep = pair_agg.prepare_spill(plan, n, 14, backward=backward)
        args = ([feat, w_rel, plan, bf(n, width), prep] if backward
                else [feat, bf(n, width), w_rel, plan, prep])
        key = shape_key(args)
        check(key not in calls, f"pair_agg case {name}: its shapes repeat another case's")
        calls[key], counts[key] = args, 0
        if name == "empty":
            empty = key
    return calls, counts, empty


def check_empty_spill(fwd_args):
    """The empty spill plan's forward returns temp bitwise, in both dtypes."""
    import torch
    from lanegcn_tpu_torch.ops import pair_agg

    for dtype in (torch.float32, torch.bfloat16):
        a = cast_args(fwd_args, dtype)
        check(torch.equal(pair_agg.pair_aggregate(*a), a[1]),
              f"pair_agg {dtype}: the empty plan's output is not temp")


def step_kernel_phases(geom, cap):
    """kernel_bwd (the backward kernels on one train step's inputs and
    cotangents, and RAGGED_BWD's calls cut to RAGGED_ROWS) and kernel_step
    (the geometry's step_kernels on that step's calls, and SEGMENT_CASES on
    the windowed geometry) from one backward_capture."""
    spec = GEOMETRIES[geom]
    for name, calls in ragged_calls(cap.calls).items():
        cap.calls[name].update(calls)
        cap.counts[name].update(dict.fromkeys(calls, 0))
    if geom == "windowed":
        calls, counts, _ = plan_case_calls(backward=True)
        cap.calls["scenario_agg_bwd"].update(calls)
        cap.counts["scenario_agg_bwd"].update(counts)
        calls, counts, _ = win_case_calls()
        cap.calls["win_edge_bwd"].update(calls)
        cap.counts["win_edge_bwd"].update(counts)
    if geom in ("bench", "half"):
        width = spec.get("model_fields", {}).get("n_map", 128)
        calls, counts, _ = spill_case_calls(backward=True, width=width)
        cap.calls["pair_agg_bwd"].update(calls)
        cap.counts["pair_agg_bwd"].update(counts)
    if geom in ("merged", "half_merged"):
        width = spec.get("model_fields", {}).get("n_map", 128)
        calls, counts, _ = plan_case_calls(backward=True, layer=True, width=width)
        cap.calls["lane_plan_bwd"].update(calls)
        cap.counts["lane_plan_bwd"].update(counts)
    if spec["model"] == "lanercnn":
        width = spec.get("model_fields", {}).get("n_map", 128)
        calls, counts, empty = scatter_case_calls(backward=True, width=width)
        cap.calls["window_scatter_bwd"].update(calls)
        cap.counts["window_scatter_bwd"].update(counts)
        check_empty_scatter(calls[empty], backward=True)
    edge = {"lanercnn": "edge_mlp_pool_bwd", "half_lanercnn": "edge_mlp_pool_bwd",
            "contiguous": "edge_mlp_bwd", "widths": "edge_mlp_bwd",
            "double": "edge_mlp_bwd"}.get(geom)
    edge_pad = add_edge_cases(edge, cap) if edge else None
    results = kernel_phase("kernel_bwd", geom, backward_ops(spec["kernels"]), cap.calls,
                           cap.counts)
    if edge:
        check_edge_padding(geom, edge, edge_pad)
    if geom == "windowed":
        calls, counts = segment_case_calls()
        cap.calls["segment_sum"].update(calls)
        cap.counts["segment_sum"].update(counts)
    results.update(kernel_phase("kernel_step", geom, forward_ops(spec["step_kernels"]),
                                cap.calls, cap.counts))
    return results


def rerun_phase(geom, cfg, make_net, batch, fns):
    """Two bf16 train steps, each from the same fresh weights (make_net) on
    the same pack: the loss, every gradient and every parameter after the
    step must be bitwise equal. Then a third under
    torch.use_deterministic_algorithms(True, warn_only=True), which lists
    what PyTorch itself names nondeterministic in the step (the flag is off
    again after it)."""
    import warnings

    import torch
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    runs, flagged = [], []
    for k in range(3):
        net, state = init_state(cfg, net=make_net())
        step = make_train_step(cfg, net, state, **fns)
        torch.cuda.synchronize()
        if k < 2:
            m = step(batch, 0.0)
        else:
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    m = step(batch, 0.0)
                    torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
            flagged = sorted({str(w.message).splitlines()[0][:160] for w in caught})
        torch.cuda.synchronize()
        runs.append((m["loss"].clone(),
                     {n: p.grad.clone() for n, p in net.named_parameters() if p.grad is not None},
                     {n: p.detach().clone() for n, p in net.named_parameters()}))
        del net, state, step, m
    (l0, g0, p0), (l1, g1, p1), (l2, _, _) = runs
    grads_apart = sorted(n for n in g0 if n not in g1 or not torch.equal(g0[n], g1[n]))
    params_apart = sorted(n for n in p0 if not torch.equal(p0[n], p1[n]))
    emit({"phase": "rerun", "geometry": geom, "loss": [float(l0), float(l1)],
          "loss_bitwise_equal": bool(torch.equal(l0, l1)), "grad_leaves": len(g0),
          "grad_leaves_apart": grads_apart[:8], "params_apart": params_apart[:8],
          "loss_under_deterministic_flag": float(l2),
          "equal_under_deterministic_flag": bool(torch.equal(l0, l2)),
          "flagged_nondeterministic": flagged})
    check(torch.equal(l0, l1), f"rerun: loss {float(l0)!r} then {float(l1)!r}")
    check(len(g0) == len(g1) and not grads_apart,
          f"rerun: {len(grads_apart)} gradient leaves differ, e.g. {grads_apart[:3]}")
    check(not params_apart, f"rerun: {len(params_apart)} parameters differ after the step")


def ab_phase(geom, batches):
    """Two settings of one ModelConfig field (the geometry's `ab`: the
    field, then the base and the other (value, label)) on the same packs
    and weights: the device busy time per serve forward (both packs) and
    per train step (one pack), profiled in turns (base, other, other,
    base). merged: the separate kernels (the bench geometry's
    configuration) against the merged layer; unfused: the fused layer (the
    windowed geometry's) against the unfused one."""
    import dataclasses

    import torch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    field, (base, base_label), (other, label) = GEOMETRIES[geom]["ab"]
    cfg = pack_config(geom, GEOMETRIES[geom]["s"])
    steps = {}
    for value in (base, other):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **{field: value}))
        serve = make_eval_step(c, LaneGCN(c.model, dtype=torch.bfloat16, device="cuda", seed=0))
        net, state = init_state(c, dtype=torch.bfloat16)
        train = make_train_step(c, net, state)
        serve(batches[0])
        train(batches[0], 0.0)
        steps[value] = (serve, train)
    busy = {v: {"serve": [], "train": []} for v in (base, other)}
    for value in (base, other, other, base):
        serve, train = steps[value]
        for kind, fn, items in (("serve", serve, batches), ("train", lambda b: train(b, 0.5),
                                                             batches[:1])):
            r = profile_phase(f"ab_{kind}", f"{geom}:{value}", fn, items, top_n=8)
            busy[value][kind].append(r["busy_ms_per_step"])
    mean = {v: {k: statistics.mean(x) for k, x in d.items()} for v, d in busy.items()}
    emit({"phase": "ab", "geometry": geom, "field": field,
          "order": [base_label, label, label, base_label],
          f"busy_ms_{base_label}": busy[base], f"busy_ms_{label}": busy[other],
          "serve_busy_ms": {base_label: mean[base]["serve"], label: mean[other]["serve"]},
          "train_busy_ms": {base_label: mean[base]["train"], label: mean[other]["train"]},
          f"{label}_over_{base_label}": {k: mean[other][k] / mean[base][k] for k in mean[base]}})


def train_phase(geom, tstep, batches, results):
    """The train path: 2 warm steps, then 10 counted steps alternating the
    packs (every launch count from 0 just before, read just after; no
    plain backward may run in a kernel's place, `plain_backward_watch`);
    returns the launch counts and the number of steps."""
    import torch
    from lanegcn_tpu_torch.ops import cuda

    spec = GEOMETRIES[geom]
    s = spec["s"]
    for i in range(2):
        tstep(batches[i % 2], (1 + i) / 100.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = 10
    plain = plain_backward_watch()
    cuda.reset_launch_counts()
    with plain:
        t0 = time.perf_counter()
        metrics = [tstep(batches[i % 2], (3 + i) / 100.0) for i in range(steps)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    train_counts = cuda.launch_counts()
    plain_calls = {k: sum(v.values()) for k, v in plain.counts.items() if v}
    losses = [float(m["loss"]) for m in metrics]
    skipped = sum(float(m["skipped"]) for m in metrics)
    emit({"phase": "train", "geometry": geom, "scenarios_per_pack": s, "steps": steps,
          "ms_per_step": dt / steps * 1e3, "scen_per_s": s * steps / dt,
          "first_loss": losses[0], "last_loss": losses[-1], "skipped": skipped,
          "lr": float(metrics[-1]["lr"]),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "kernel_ms_per_step_checked": sum(r["ms_per_step"] for r in results.values()),
          "launches": train_counts,
          "launches_per_step": {k: v / steps for k, v in train_counts.items()},
          "plain_backward_calls": plain_calls})
    check(not plain_calls, f"{geom}: plain backwards ran on the card: {plain_calls}")
    check(all(math.isfinite(x) for x in losses), f"{geom}: non-finite train loss: {losses}")
    check(skipped == 0, f"{geom}: the NaN guard skipped {skipped} of {steps} steps")
    check_counts(train_counts, spec["per_train_step"], steps, f"{geom} train")
    return train_counts, steps


def serve_phase(geom, step, batches, results, pack_s):
    """The eval path over the packs, 5 rounds, counted (every launch count
    from 0 just before, read just after), then its profile; returns the
    launch counts and the number of forwards."""
    import torch
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.train.loop import MetricAccumulator

    spec = GEOMETRIES[geom]
    s = spec["s"]
    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rounds = 5
    acc = MetricAccumulator()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(rounds * len(batches)):
        _, m = step(batches[i % len(batches)])
        acc.update(m)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    serve_counts = cuda.launch_counts()
    forwards = rounds * len(batches)
    summ = acc.summary()
    emit({"phase": "serve", "geometry": geom, "scenarios_per_pack": s, "forwards": forwards,
          "ms_per_pack": dt / forwards * 1e3, "scen_per_s": s * forwards / dt,
          "loss": summ["loss"], "ade": summ["ade"], "fde": summ["fde"], "mr": summ["mr"],
          "host_pack_s_per_pack": pack_s / len(batches),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "kernel_ms_per_forward_checked": sum(results[k]["ms_per_step"] for k in spec["kernels"]),
          "launches": serve_counts,
          "launches_per_forward": {k: v / forwards for k, v in serve_counts.items()}})
    for k in ("loss", "ade", "fde", "mr"):
        check(math.isfinite(summ[k]), f"{geom}: non-finite {k}: {summ[k]}")
    check_counts(serve_counts, spec["per_forward"], forwards, f"{geom} serve")
    profile_phase("profile", geom, step, batches)
    return serve_counts, forwards


def serve_rerun_phase(geom, step, batch):
    """Two bf16 eval forwards of the same pack: every output bitwise equal."""
    import torch

    (out0, m0), (out1, m1) = step(batch), step(batch)
    torch.cuda.synchronize()
    apart = sorted(k for k in out0 if not torch.equal(out0[k], out1[k]))
    emit({"phase": "serve_rerun", "geometry": geom, "outputs": sorted(out0),
          "outputs_apart": apart, "loss": [float(m0["loss"]), float(m1["loss"])]})
    check(not apart, f"{geom}: a rerun of the eval forward differs in {apart}")


def refusal_phase(phase, geom, width, run, refusing, extra=None):
    """run() must raise a ValueError naming a kernel of `refusing` ({kernel:
    its C entries}) and the width (the kernel's check: "not <width>"),
    before any of that kernel's entries launches (their counts stay 0),
    with nothing but ANY_WIDTH's entries launched ahead of it and no plain
    version of a refusing kernel or plain backward run in a kernel's place
    on the card (both watched). What launched before it is printed."""
    import torch
    from lanegcn_tpu_torch.ops import cuda

    plain = plain_backward_watch(forward=True)
    cuda.reset_launch_counts()
    err = None
    with plain:
        try:
            run()
        except ValueError as e:
            err = str(e)
    torch.cuda.synchronize()
    counts = cuda.launch_counts()
    named = [k for k in refusing if err is not None and err.startswith(k + ":")]
    plain_calls = {k: sum(v.values()) for k, v in plain.counts.items() if v}
    launched = {k: v for k, v in counts.items() if v}
    emit({"phase": phase, "geometry": geom, "width": width, **(extra or {}), "error": err,
          "refused_at": named[0] if named else None, "launched": launched,
          "plain_calls": plain_calls})
    check(err is not None, f"{geom} {phase}: a run at width {width} ended without a ValueError")
    check(bool(named) and f"not {width}" in err,
          f"{geom} {phase}: the ValueError names no refusing kernel and width {width}: {err}")
    check(all(counts[e] == 0 for e in refusing[named[0]]),
          f"{geom} {phase}: {named[0]} launched before it refused: {launched}")
    check(set(launched) <= set(ANY_WIDTH),
          f"{geom} {phase}: a kernel other than {ANY_WIDTH} launched before the refusal: "
          f"{launched}")
    check(not plain_calls, f"{geom} {phase}: plain versions ran on the card: {plain_calls}")


def refused_train_phase(geom, cfg, batch):
    """A bf16 train step of the geometry's model with its `refused` fields
    (LaneRCNN at n_map = n_actor = 96) must refuse at NARROW_REFUSED's
    kernel (by its check: the kernels take rows 64 or 128 wide) with
    nothing launched but ANY_WIDTH's entries (`refusal_phase`)."""
    import dataclasses

    import torch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    spec = GEOMETRIES[geom]
    rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **spec["refused"]))
    bundle = get_model(spec["model"], rcfg, dtype=torch.bfloat16, seed=0)
    net, state = init_state(bundle.config, net=bundle.net)
    tstep = make_train_step(bundle.config, net, state, loss_fn=bundle.loss_fn,
                            metrics_fn=bundle.metrics_fn)
    refusal_phase("refused_train", geom, rcfg.model.n_map, lambda: tstep(batch, 0.0),
                  NARROW_REFUSED, {"fields": spec["refused"]})


def refused_serve_phase(geom):
    """The double geometry's refusal (`refusal_phase`): an eval forward of
    its model on 8 scenarios of the `refused_serve` geometry's layout must
    stop at that geometry's first kernel not built at the model's width,
    with nothing launched but ANY_WIDTH's."""
    import dataclasses

    import torch
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.loop import make_eval_step

    spec = GEOMETRIES[geom]
    width = spec["model_fields"]["n_map"]
    other, refusing = spec["refused_serve"]
    s = 8
    ocfg = pack_config(other, s)
    ocfg = dataclasses.replace(ocfg, model=dataclasses.replace(ocfg.model,
                                                               **spec["model_fields"]))
    packs, _, _, _ = make_packs(ocfg, 1, s, seed0=0, pack_kw=pack_kwargs(other))
    step = make_eval_step(ocfg, get_model("lanegcn", ocfg, dtype=torch.bfloat16, seed=0).net)
    obatch = PackedBatch.from_numpy(packs[0]).to("cuda")
    refusal_phase("refused_serve", geom, width, lambda: step(obatch), refusing,
                  {"layout": GEOMETRIES[other]["config"], "scenarios": s})


def plain_backward_watch(forward=False):
    """A Capture of every plain backward the autograd Functions can call
    (lane_plan's and band_conv's at W = 64 and 128 among them) and, with
    `forward`, of the plain forward of NARROW_REFUSED's kernel (it may not
    run on CUDA tensors)."""
    from lanegcn_tpu_torch.ops import band_conv, edge_mlp, lane_layer, pair_agg, row_tail
    from lanegcn_tpu_torch.ops import scenario_agg, win_edge, window_scatter

    fwd = ((scenario_agg, "scenario_agg_plain"),) if forward else ()
    return Capture([(mod, attr, attr) for mod, attr in fwd + (
        (lane_layer, "lane_layer_bwd_plain"), (lane_layer, "lane_plan_bwd_plain"),
        (band_conv, "band_conv_bwd_plain"), (scenario_agg, "scenario_agg_bwd_plain"),
        (pair_agg, "pair_agg_bwd_plain"), (win_edge, "win_edge_bwd_plain"),
        (row_tail, "row_tail_bwd_plain"), (row_tail, "row_tail2_bwd_plain"),
        (edge_mlp, "edge_mlp_bwd_plain"), (edge_mlp, "edge_mlp_pool_bwd_plain"),
        (window_scatter, "window_scatter_bwd_plain"))])


def drive_lanercnn(geom):
    """LaneRCNN's phases: pack, kernel, kernel_bwd, parity, train_parity,
    serve (+ profile), train, remat, profile_train, rerun and (with the
    geometry's `refused` fields) refused_train; returns its kernel
    results and the serve and train runs' launch counts."""
    import torch
    from lanegcn_tpu_torch.graph import RoiPackedBatch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    spec = GEOMETRIES[geom]
    s = spec["s"]
    cfg = pack_config(geom, s)
    rc = cfg.roi_pack

    # --- pack ---
    packs, stats, gen_s, pack_s = make_packs(cfg, 2, s, seed0=0, roi=True)
    t0 = time.perf_counter()
    batches = [RoiPackedBatch.from_numpy(b).to("cuda") for b in packs]
    torch.cuda.synchronize()
    transfer_s = time.perf_counter() - t0
    live = lambda e: int(e.mask.sum())
    emit({"phase": "pack", "geometry": geom, "scenarios_per_pack": s, "packs": len(packs),
          "gen_s": gen_s, "pack_s": pack_s, "transfer_s": transfer_s,
          "rois": [x["num_rois"] for x in stats], "roi_cap": rc.max_rois,
          "roi_nodes": [x["num_roi_nodes"] for x in stats], "roi_node_cap": rc.max_roi_nodes,
          "interest_nodes": [x["num_interest_nodes"] for x in stats],
          "interest_node_cap": rc.max_interest_nodes,
          "global_nodes": [int(b.graph.node_mask.sum()) for b in packs],
          "global_node_cap": rc.max_global_nodes,
          "r2g_edges": [live(b.r2g) for b in packs], "g2r_edges": [live(b.g2r) for b in packs],
          "pool_edge_cap": rc.max_pool_edges,
          "a2m_edges": [live(b.a2m) for b in packs], "a2r_edges": [live(b.a2r) for b in packs],
          "roi_plan_edges": [x["plan_edges"] for x in stats],
          "global_plan_edges": [int((b.graph.plan_lu >= 0).sum()) for b in packs],
          "roi_residue_list_edges": [sum(live(e) for e in b.edges.values()) for b in packs],
          "global_residue_list_edges": [sum(live(e) for e in b.graph.edges.values())
                                        for b in packs],
          "residue_list_slots": sum(rc.edge_capacity(nm) for nm in packs[0].edges),
          "dropped": 0})

    serve_bundle = get_model("lanercnn", cfg, dtype=torch.bfloat16, seed=0)
    fns = dict(loss_fn=serve_bundle.loss_fn, metrics_fn=serve_bundle.metrics_fn)
    step = make_eval_step(cfg, serve_bundle.net, **fns)

    # --- kernels against their plain versions, on the eval path's inputs ---
    with forward_capture() as cap:
        step(batches[0])
    torch.cuda.synchronize()
    add_tail_cases("row_tail2", cap)
    edge_pad = add_edge_cases("edge_mlp_pool", cap)
    calls, counts, empty = scatter_case_calls(backward=False, width=cfg.model.n_map)
    cap.calls["window_scatter"].update(calls)
    cap.counts["window_scatter"].update(counts)
    check_empty_scatter(calls[empty], backward=False)
    results = kernel_phase("kernel", geom, forward_ops(spec["kernels"]), cap.calls, cap.counts)
    check_edge_padding(geom, "edge_mlp_pool", edge_pad)
    del cap, edge_pad

    # --- backward kernels against their plain backwards, on a train step's inputs ---
    bundle = get_model("lanercnn", cfg, dtype=torch.bfloat16, seed=0)
    tcfg = bundle.config  # AdamW, weight decay 0.01
    net_t, state = init_state(tcfg, net=bundle.net)
    tstep = make_train_step(tcfg, net_t, state, **fns)
    with backward_capture() as cap:
        tstep(batches[0], 0.0)
    torch.cuda.synchronize()
    results.update(step_kernel_phases(geom, cap))
    del cap

    # --- card vs CPU, float32 ---
    roi_parity_phase(geom)
    train_parity_phase(geom)

    serve = serve_phase(geom, step, batches, results, pack_s)
    train = train_phase(geom, tstep, batches, results)
    remat_phase(geom, tcfg, batches[0], fns)
    profile_phase("profile_train", geom, lambda b: tstep(b, 0.5), batches[:1])
    rerun_phase(geom, tcfg, lambda: get_model("lanercnn", cfg, dtype=torch.bfloat16,
                                              seed=0).net, batches[0], fns)
    if "refused" in spec:
        refused_train_phase(geom, cfg, batches[0])
    return results, serve, train


def remat_phase(geom, cfg, batch, fns):
    """One bf16 train step with remat=False and one with remat=True, from
    the same weights on the same pack: the losses bitwise equal (the
    forwards are the same ops, and every sum runs in a fixed order), both
    steps' NMS picks equal beside the smallest logit gap around them, each
    step's peak memory (remat's must be lower: the LanePoolings' [E, 128]
    tensors are not kept), and the remat step's launches, the LanePooling
    forwards doubled."""
    import torch
    from lanegcn_tpu_torch.models.lanercnn import LaneRCNN
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    res, picks = {}, {}
    for remat in (False, True):
        net, state = init_state(cfg, net=LaneRCNN(cfg.model, dtype=torch.bfloat16, seed=5,
                                                  remat=remat))
        step = make_train_step(cfg, net, state, **fns)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        with nms_recorder(picks, "remat" if remat else "plain"):
            m = step(batch, 0.0)
        torch.cuda.synchronize()
        res[remat] = {"loss": float(m["loss"]), "loss_t": m["loss"].clone(),
                      "skipped": float(m["skipped"]),
                      "ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "launches": cuda.launch_counts()}
        del net, state, step, m
    plain, rem = res[False], res[True]
    nms = nms_report(picks, "remat", "plain")
    emit({"phase": "remat", "geometry": geom, "loss": plain["loss"], "loss_remat": rem["loss"],
          "loss_bitwise_equal": bool(torch.equal(plain["loss_t"], rem["loss_t"])),
          "peak_mem_gib": plain["peak_mem_gib"], "peak_mem_gib_remat": rem["peak_mem_gib"],
          "ms_one_step": plain["ms"], "ms_one_step_remat": rem["ms"],
          "launches_remat": rem["launches"], **nms})
    check(all(math.isfinite(r["loss"]) and r["skipped"] == 0 for r in res.values()),
          f"remat: non-finite or skipped step {res}")
    check(nms["nms_picks_differ"] == 0, f"remat: {nms['nms_picks_differ']} NMS picks differ")
    check(torch.equal(plain["loss_t"], rem["loss_t"]),
          f"remat: loss {rem['loss']!r} vs {plain['loss']!r}, not bitwise equal")
    check(rem["peak_mem_gib"] < plain["peak_mem_gib"],
          f"remat: peak {rem['peak_mem_gib']} GiB is not below {plain['peak_mem_gib']} GiB")
    check_counts(plain["launches"], GEOMETRIES[geom]["per_train_step"], 1, f"{geom} step")
    check_counts(rem["launches"], GEOMETRIES[geom]["per_remat_step"], 1, f"{geom} remat step")


# The CLI's runs in the `cli` phase: LaneGCN on CLI_N preprocessed urban
# scenarios (7 corridors, 16 actors; shards of CLI_SHARD), packs of CLI_B,
# 2 epochs, with CLI_VAL_N generated for validation; LaneRCNN on
# CLI_RCNN_N urban RoI scenarios (12 actors) for one epoch.
CLI_B, CLI_N, CLI_SHARD, CLI_VAL_N, CLI_RCNN_N = 32, 128, 64, 64, 128
CLI_EPOCHS = 2
CLI_PREEMPT_AT = 5  # SIGTERM once the preempted run has logged this many steps
# LaneRCNN at the CLI's RoI pack (flat RoI and global node spaces, flat pool
# edges): the C entries that must run in each train step.
CLI_RCNN_ENTRIES = ("lane_layer_fwd", "lane_layer_bwd", "row_tail2_fwd", "row_tail2_bwd",
                    "edge_mlp_pool_fwd", "edge_mlp_pool_bwd", "segment_sum")


def _cli_env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def _cli_proc(args, cwd, name, launcher=()):
    """`python [LAUNCHER] -m lanegcn_tpu_torch.cli ARGS` started in cwd,
    its stdout on a pipe and its stderr into cwd/NAME.err. A launcher's run
    gets a session of its own, so `_stop_session` ends its workers too."""
    err_path = os.path.join(cwd, name + ".err")
    with open(err_path, "w") as err:
        proc = subprocess.Popen([sys.executable, *launcher, "-m", "lanegcn_tpu_torch.cli",
                                 *args], start_new_session=bool(launcher),
                                cwd=cwd, env=_cli_env(), stdout=subprocess.PIPE, stderr=err,
                                text=True)
    proc.err_path = err_path
    return proc


def _stop_session(proc):
    """Kill what is left of a process started in a session of its own."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _cli_wait(proc, what, timeout=600):
    """The process's stdout after it exited with code 0."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"cli {what}: no exit within {timeout} s")
    with open(proc.err_path) as f:
        err = f.read()
    check(proc.returncode == 0, f"cli {what}: exit code {proc.returncode}\n{err[-4000:]}")
    return out or ""


def _cli_here(args):
    """The CLI's main(args) in this process (so its launches are counted),
    its stdout captured; returns (stdout, seconds)."""
    import io

    from lanegcn_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(list(args))
    return buf.getvalue(), time.perf_counter() - t0


@contextlib.contextmanager
def _step_clock(ends):
    """Within the block, every train step the CLI makes appends to `ends`
    the host clock once its work on the card has ended (a synchronize after
    the step; at --display-every 1 the CLI syncs at each display anyway)."""
    import torch
    from lanegcn_tpu_torch.train import loop

    make = loop.make_train_step

    def timed_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def timed(*a, **kw):
            out = step(*a, **kw)
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            return out

        return timed

    loop.make_train_step = timed_make
    try:
        yield
    finally:
        loop.make_train_step = make


def _warm_step_ms(ends, steps_per_epoch):
    """The CLI's step times (ms) between the ends of successive steps:
    what a step costs the trainer, the loader's wait, the display and the
    copies to the card included. Leaves out the first two steps (warm-up)
    and each epoch's first, which also holds the last epoch's checkpoint,
    validation and the loader's start; returns them all and their
    median, least and most."""
    ms = [(ends[i] - ends[i - 1]) * 1e3 for i in range(2, len(ends))
          if i % steps_per_epoch]
    srt = sorted(ms)
    return {"ms": ms, "n": len(ms), "median": srt[len(srt) // 2], "min": srt[0],
            "max": srt[-1]}


@contextlib.contextmanager
def _torch_defaults():
    """PyTorch's own TF32 defaults (cuBLAS off, cuDNN on) within the block,
    as a CLI process has them; this script turns both off for its checks."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _step_lines(text):
    """The display lines of a train log (--display-every 1: one a step)."""
    return [ln for ln in text.splitlines() if ln.startswith("epoch ")]


def _metric_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith(("  minADE", "  minFDE", "  MR_"))]


def _check_step_lines(lines, what, steps):
    """`steps` display lines, each with a finite loss and no drop counter
    (the CLI adds ', dropped {...}' for any dropped_*, skipped_*, spilled_*
    or graph_dropped_* count); returns each line's loss."""
    check(len(lines) == steps, f"cli {what}: {len(lines)} step lines, expected {steps}")
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in lines]
    check(all(math.isfinite(x) for x in losses), f"cli {what}: non-finite loss {losses}")
    bad = [ln for ln in lines if "dropped" in ln]
    check(not bad, f"cli {what}: the packs dropped edges or scenarios: {bad[:2]}")
    return losses


def _same_checkpoints(a, b):
    """Bitwise equal state_dict, flat_adam and step."""
    import torch

    return (a["step"] == b["step"] and a["state_dict"].keys() == b["state_dict"].keys()
            and all(torch.equal(a["state_dict"][k], b["state_dict"][k]) for k in a["state_dict"])
            and all(torch.equal(a["flat_adam"][k], b["flat_adam"][k])
                    for k in ("flat", "mu", "nu", "count")))


def _submission_rows(path):
    if os.path.exists(path + ".npz"):
        return np.load(path + ".npz")["argoverse_forecasting"]
    import h5py  # where the card's machine has it, write_submission wrote .h5

    with h5py.File(path + ".h5", "r") as f:
        return f["argoverse_forecasting"][:]


def cli_phase():
    """The port's CLI as a user runs it, on the card (bf16, 2 pack workers):
    preprocess to shards; train R1 in this process (launches counted) for 2
    epochs with validation and a checkpoint each epoch; the same run R2 as
    a subprocess, sent SIGTERM after CLI_PREEMPT_AT steps, then resumed: its
    2.000.ckpt must equal R1's bitwise; eval by --weight and by
    --torch-weight (subprocesses, beside R2) must print R1's last
    validation; LaneRCNN's fp32 forward at the CLI's RoI pack, card against
    CPU, then one epoch of LaneRCNN training (launches counted). The
    in-process runs' steps are timed by `_step_clock`."""
    import argparse
    import shutil
    import signal
    import threading

    import torch
    from lanegcn_tpu_torch import cli
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.train.checkpoint import load_checkpoint

    t_phase = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    root = os.path.join(REPO, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shards, r1, r2 = (os.path.join(root, d) for d in ("shards", "r1", "r2"))
    b, val = str(CLI_B), f"urban:{CLI_VAL_N}:7:16"
    train = lambda save_dir, *extra: [
        "train", "--data", shards, "--batch-size", b, "--epochs", str(CLI_EPOCHS), "--bf16",
        "--workers", "2", "--save-freq", "1", "--display-every", "1", "--save-dir", save_dir,
        *extra]

    pre = _cli_proc(["preprocess", "--data", f"urban:{CLI_N}:7:16", "--out", shards,
                     "--shard-size", str(CLI_SHARD)], root, "preprocess")
    # While the shards are written: LaneRCNN's fp32 forward on the CLI's
    # RoI pack of CLI_B, card against CPU, zero drops of either kind.
    rcfg = cli._default_config(argparse.Namespace(batch_size=CLI_B, seed=None))
    roi_parity_phase("cli_lanercnn", cfg=rcfg, s=CLI_B)
    _cli_wait(pre, "preprocess")
    check(len(os.listdir(shards)) == -(-CLI_N // CLI_SHARD),
          f"cli preprocess: {sorted(os.listdir(shards))}")

    # --- R1: the uninterrupted run, in this process ---
    ends1 = []
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with _torch_defaults(), _step_clock(ends1):
        out1, r1_s = _cli_here(train(r1, "--val-data", val))
    torch.cuda.synchronize()
    gcn_counts = cuda.launch_counts()
    with open(os.path.join(r1, "log")) as f:
        log1 = f.read()
    steps = CLI_EPOCHS * -(-CLI_N // CLI_B)
    losses1 = _check_step_lines(_step_lines(log1), "R1", steps)
    check(len(ends1) == steps, f"cli R1: {len(ends1)} steps timed, expected {steps}")
    check(f"steps/epoch on {card}" in log1, f"cli R1: the start line does not name {card}")
    last = "%3.3f.ckpt" % CLI_EPOCHS
    for e in range(1, CLI_EPOCHS + 1):
        name = "%3.3f.ckpt" % e
        check(os.path.exists(os.path.join(r1, name)), f"cli R1: no {name}")
    val1 = _metric_lines(log1)
    check(len(val1) == 6 and all(math.isfinite(float(ln.split(": ")[1])) for ln in val1),
          f"cli R1: validation {val1}")
    check(f"validation: {CLI_VAL_N} scenarios" in log1 and "WARNING" not in log1,
          "cli R1: validation")
    # The train steps and validation forwards of the contiguous geometry.
    spec = GEOMETRIES["contiguous"]
    forwards = -(-CLI_VAL_N // CLI_B)
    want = {e: steps * spec["per_train_step"].get(e, 0) + forwards * spec["per_forward"].get(e, 0)
            for e in gcn_counts}
    check(gcn_counts == want, f"cli R1: launches {gcn_counts}, expected {want}")

    # --- eval by --weight and --torch-weight, and the preempted R2, at once ---
    # Both read R1's checkpoint, and from it that R1 computed in bf16.
    ckpt = os.path.join(r1, last)
    sub = os.path.join(root, "submission")
    evals = {
        "weight": _cli_proc(["eval", "--weight", ckpt, "--data", val, "--batch-size", b,
                             "--submission", sub], root, "eval_weight"),
        "torch_weight": _cli_proc(["eval", "--torch-weight", ckpt, "--data", val,
                                   "--batch-size", b], root, "eval_torch_weight"),
    }
    proc = _cli_proc(train(r2), root, "r2")
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    lines, sent = [], False
    for ln in proc.stdout:
        lines.append(ln)
        if not sent and len(_step_lines("".join(lines))) == CLI_PREEMPT_AT:
            proc.send_signal(signal.SIGTERM)
            sent = True
    rc = proc.wait()
    watchdog.cancel()
    out2 = "".join(lines)
    check(sent and rc == 0, f"cli R2: exit code {rc} after SIGTERM (sent: {sent})")
    saved = [ln for ln in out2.splitlines() if ln.startswith("SIGTERM: saved ")]
    check(len(saved) == 1, f"cli R2: no 'SIGTERM: saved' line:\n{out2[-2000:]}")
    cut = saved[0][len("SIGTERM: saved "):-len(", exiting")]
    cut_step = load_checkpoint(cut)["step"]
    check(CLI_PREEMPT_AT <= cut_step < steps, f"cli R2: preempted at step {cut_step}")
    with _torch_defaults():
        out2r, _ = _cli_here(train(r2, "--resume", cut))
    check(f"resumed from {cut} at epoch" in out2r, "cli R2: no 'resumed from' line")
    _check_step_lines(_step_lines(out2r), "R2 resumed", steps - cut_step)
    resumed_equal = _same_checkpoints(load_checkpoint(ckpt),
                                      load_checkpoint(os.path.join(r2, last)))
    check(resumed_equal, f"cli R2: resumed from step {cut_step}, {last} differs from R1's")
    eval_out = {k: _cli_wait(p, f"eval --{k.replace('_', '-')}") for k, p in evals.items()}
    for k, text in eval_out.items():
        check(_metric_lines(text) == val1,
              f"cli eval --{k}: {_metric_lines(text)} != R1's validation {val1}")
    rows = _submission_rows(sub)
    check(rows.shape == (CLI_VAL_N * 6 * 30, 5), f"cli eval: submission of {rows.shape}")

    # --- LaneRCNN, one epoch, in this process ---
    ends3 = []
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    with _torch_defaults(), _step_clock(ends3):
        out3, _ = _cli_here(["train", "--model", "lanercnn", "--data",
                             f"urban:{CLI_RCNN_N}:7:12", "--batch-size", b, "--epochs", "1",
                             "--bf16", "--workers", "2", "--display-every", "1"])
    torch.cuda.synchronize()
    rcnn_counts = cuda.launch_counts()
    rcnn_steps = -(-CLI_RCNN_N // CLI_B)
    losses3 = _check_step_lines(_step_lines(out3), "lanercnn", rcnn_steps)
    check(len(ends3) == rcnn_steps, f"cli lanercnn: {len(ends3)} steps timed")
    missing = [e for e in CLI_RCNN_ENTRIES if rcnn_counts[e] == 0]
    check(not missing, f"cli lanercnn: no launch of {missing}: {rcnn_counts}")

    gcn_ms = _warm_step_ms(ends1, steps // CLI_EPOCHS)
    rcnn_ms = _warm_step_ms(ends3, rcnn_steps)
    emit({"phase": "cli", "card": card, "seconds": time.perf_counter() - t_phase,
          "lanegcn": {"steps": steps, "scenarios_per_pack": CLI_B, "first_loss": losses1[0],
                      "last_loss": losses1[-1], "warm_step_ms": gcn_ms,
                      "scen_per_s_median": CLI_B / gcn_ms["median"] * 1e3,
                      "r1_run_s": r1_s, "validation": val1,
                      "launches_per_step": {e: spec["per_train_step"].get(e, 0)
                                            for e in gcn_counts if want[e]},
                      "launches": {e: n for e, n in gcn_counts.items() if n}},
          "preempted_at_step": cut_step, "resumed_bitwise_equal": resumed_equal,
          "eval_lines_equal": True, "submission_rows": int(rows.shape[0]),
          "lanercnn": {"steps": rcnn_steps, "scenarios_per_pack": CLI_B, "losses": losses3,
                       "warm_step_ms": rcnn_ms,
                       "scen_per_s_median": CLI_B / rcnn_ms["median"] * 1e3,
                       "launches_per_step": {e: n / rcnn_steps
                                             for e, n in rcnn_counts.items() if n},
                       "launches": {e: n for e, n in rcnn_counts.items() if n}}})
    shutil.rmtree(root, ignore_errors=True)


# The loader phase: 2 packs of 256 an epoch, 2 epochs, per worker count;
# the counts in turns, each twice, since the host's clock drifts within a
# call.
LOADER_S, LOADER_PACKS, LOADER_EPOCHS, LOADER_WORKERS = 256, 2, 2, (1, 2, 4, 4, 2, 1)


def urban_scenarios(seeds):
    """Urban scenarios (7 corridors, 16 actors) with their pack caches, for
    a process pool (a module-level function: spawn imports it)."""
    from lanegcn_tpu_torch.config import ModelConfig
    from lanegcn_tpu_torch.data.packing import precompute_pack_cache
    from lanegcn_tpu_torch.data.synthetic import make_urban_scenario

    out = []
    for seed in seeds:
        scen = make_urban_scenario(seed=seed, num_corridors=7, num_actors=16)
        precompute_pack_cache(scen, ModelConfig())
        out.append(scen)
    return out


def loader_phase():
    """The PackedLoader (to_device: packs copied to the card on a side
    stream) into the bench train step (bench_pack_config(256), bf16), for
    LOADER_EPOCHS epochs of LOADER_PACKS packs with 1, 2 and 4 pack workers
    in turns (LOADER_WORKERS, each count twice), on scenarios generated once
    and held in memory with their pack caches:
    scen/s through the loader (the first pack left out), host pack s and
    transfer ms per pack, and the same steps' scen/s on the packs already
    on the card; zero drops, and the losses bitwise equal whatever the
    worker count."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from lanegcn_tpu_torch.config import Config, bench_pack_config
    from lanegcn_tpu_torch.data.dataset import PackedLoader
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    t_phase = time.perf_counter()
    n = LOADER_S * LOADER_PACKS
    t0 = time.perf_counter()
    procs = max(1, min(8, len(os.sched_getaffinity(0))))
    chunks = [list(range(i * n // procs, (i + 1) * n // procs)) for i in range(procs)]
    with ProcessPoolExecutor(procs, mp_context=mp.get_context("spawn")) as pool:
        scens = [sc for part in pool.map(urban_scenarios, chunks) for sc in part]
    gen_s = time.perf_counter() - t0
    cfg = Config(pack=bench_pack_config(LOADER_S))
    rows, losses = {}, []
    for workers in LOADER_WORKERS:
        stats = []
        loader = PackedLoader(scens, cfg, seed=0, pack_workers=workers, drop_stats=stats,
                              to_device=True)
        net, state = init_state(cfg, dtype=torch.bfloat16)
        step = make_train_step(cfg, net, state)
        batches, loss = [], []
        pack_s = transfer_s = 0.0
        torch.cuda.synchronize()
        for e in range(LOADER_EPOCHS):
            for b in loader.epoch(e):
                loss.append(step(b, len(batches) / LOADER_PACKS)["loss"])
                batches.append(b)
                if len(batches) == 1:  # the first pack is left out of the timing
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
            pack_s += loader.pack_s
            transfer_s += loader.transfer_s
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        timed = len(batches) - 1
        # The same steps on the packs already on the card.
        t2 = time.perf_counter()
        for i, b in enumerate(batches[1:], 1):
            step(b, i / LOADER_PACKS)
        torch.cuda.synchronize()
        dt_dev = time.perf_counter() - t2
        drops = {k: v for st in stats for k, v in st.items()
                 if k.startswith(("dropped", "skipped", "graph_dropped")) and v}
        check(not drops, f"loader workers={workers}: drops {drops}")
        check(len(batches) == LOADER_EPOCHS * LOADER_PACKS, f"loader: {len(batches)} packs")
        losses.append(torch.stack(loss).cpu())
        for key, val in (("scen_per_s", timed * LOADER_S / dt),
                         ("host_pack_s_per_pack", pack_s / len(batches)),
                         ("transfer_ms_per_pack", transfer_s / len(batches) * 1e3),
                         ("step_only_scen_per_s", timed * LOADER_S / dt_dev)):
            rows.setdefault(workers, {}).setdefault(key, []).append(val)
        del net, state, step, batches, loader
        torch.cuda.empty_cache()
    same = all(torch.equal(l, losses[0]) for l in losses)
    emit({"phase": "loader", "card": torch.cuda.get_device_name(0),
          "seconds": time.perf_counter() - t_phase,
          "scenarios": n, "gen_s": gen_s, "gen_processes": procs,
          "scenarios_per_pack": LOADER_S, "packs": LOADER_EPOCHS * LOADER_PACKS,
          "timed_packs": LOADER_EPOCHS * LOADER_PACKS - 1, "order": LOADER_WORKERS,
          "by_workers": rows, "losses_bitwise_equal": same, "losses": losses[0].tolist()})
    check(same, f"loader: losses differ by worker count {[l.tolist() for l in losses]}")


# The argoverse phase: ARGO_S scenario CSVs written from _synthetic_world
# (urban, ARGO_CORRIDORS corridors and ARGO_ACTORS actors, the bench
# geometry's scenes), read back through ArgoScenarioDataset with WorldMap as
# the map, into LaneGCN (bench_pack_config(ARGO_S)) and LaneRCNN
# (lanercnn_pack_config(ARGO_S), ARGO_RCNN_SPP scenarios a pack: with 16
# actors these scenes carry more RoIs than the 6 a scenario the config
# sizes, so a pack of ARGO_S of them would skip scenarios), then the raster
# path and segment_softmax on the card.
ARGO_S, ARGO_CORRIDORS, ARGO_ACTORS = 256, 7, 16
ARGO_RCNN_SPP, ARGO_TRAIN_STEPS = 192, 3
ARGO_RADIUS = 200.0  # the map radius build_scenario asks for: max|x| + max|y| of pred_range
ARGO_TS0 = 315969629.0  # the first timestamp of a written scenario, s
ARGO_HEADER = ("TIMESTAMP", "TRACK_ID", "OBJECT_TYPE", "X", "Y", "CITY_NAME")
# The raster checks: a RASTER_SCALE px/m crop of RASTER_RANGE around the
# agent, RASTER_ROI x RASTER_ROI bins per actor box of RASTER_BOX m, with
# RASTER_CHANNELS - 1 seeded noise channels beside the raster.
RASTER_SCALE, RASTER_RANGE, RASTER_ROI, RASTER_BOX, RASTER_CHANNELS = (
    2, (-100.0, 100.0, -100.0, 100.0), 32, 40.0, 4)
# segment_softmax: a SOFTMAX_LIVE share of the edges live, their
# destinations among the first 1/SOFTMAX_SPREAD of the node rows (several
# edges a segment; the other rows empty, as map nodes far from any actor).
SOFTMAX_LIVE, SOFTMAX_SPREAD = 0.9, 16


def write_argo_csv(path, trajs, steps, city, seed):
    """One scenario as an Argoverse v1.1 CSV: UUID-style TRACK_IDs drawn
    from `seed`, sorted so that the tracks after the AGENT (trajs[0], whose
    ID is any of them) read back in the order given; rows shuffled;
    timestamps ARGO_TS0 + 0.1 s a step; coordinates as repr(float), so
    that they read back exactly."""
    import csv
    import uuid

    rng = np.random.default_rng(seed)
    ids = sorted(str(uuid.UUID(bytes=rng.bytes(16), version=4)) for _ in trajs)
    ids.insert(0, ids.pop(int(rng.integers(len(ids)))))
    types = ["AGENT"] + ["AV" if i == 1 else "OTHERS" for i in range(1, len(trajs))]
    rows = [(repr(ARGO_TS0 + 0.1 * int(s)), tid, typ, repr(float(x)), repr(float(y)), city)
            for tid, typ, xy, st in zip(ids, types, trajs, steps)
            for (x, y), s in zip(xy, st)]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(ARGO_HEADER)
        w.writerows(rows[i] for i in rng.permutation(len(rows)))


def write_world_csv(root, seed, num_corridors=ARGO_CORRIDORS, num_actors=ARGO_ACTORS):
    """The actors of the urban _synthetic_world(seed) as root/<seed>.csv,
    city SYN<seed>; returns the path."""
    from lanegcn_tpu_torch.data.synthetic import _synthetic_world

    _, trajs, steps = _synthetic_world(seed, num_corridors, num_actors, urban=True)
    path = os.path.join(root, f"{seed}.csv")
    write_argo_csv(path, trajs, steps, f"SYN{seed}", seed)
    return path


class WorldMap:
    """A MapProvider over the synthetic worlds: city SYN<seed> holds the
    lanes of the urban _synthetic_world(seed) (world frame, in its order),
    of which lanes_in_radius returns those with a centerline point within
    `radius` of `center` in Manhattan distance."""

    def __init__(self, num_corridors=ARGO_CORRIDORS):
        self.num_corridors = num_corridors

    def world(self, city):
        from lanegcn_tpu_torch.data.synthetic import _synthetic_world

        return _synthetic_world(int(city[3:]), self.num_corridors, urban=True)[0]

    def lanes_in_radius(self, center, city, radius):
        return lanes_near(self.world(city), center, radius)


def lanes_near(lanes, center, radius):
    """The lanes with a centerline point within `radius` of `center` in
    Manhattan distance, in their order."""
    c = np.asarray(center, np.float32)
    return [ln for ln in lanes if (np.abs(ln.centerline - c).sum(1) <= radius).any()]


def argo_worlds(args):
    """(root, seeds) → for each seed: write its CSV, and return the
    scenario built from the same world without the CSV (build_scenario on
    its trajs and WorldMap), make_urban_scenario(seed), and the world's
    lanes and those WorldMap returns for the scenario (a module-level
    function: spawn imports it)."""
    from lanegcn_tpu_torch.data.argoverse import build_scenario
    from lanegcn_tpu_torch.data.synthetic import _synthetic_world, make_urban_scenario

    root, seeds = args
    out = []
    for seed in seeds:
        lanes, trajs, steps = _synthetic_world(seed, ARGO_CORRIDORS, ARGO_ACTORS, urban=True)
        city = f"SYN{seed}"
        write_argo_csv(os.path.join(root, f"{seed}.csv"), trajs, steps, city, seed)
        scen = build_scenario({"city": city, "trajs": trajs, "steps": steps}, WorldMap())
        scen["seq_id"] = seed
        out.append((scen,
                    make_urban_scenario(seed, num_corridors=ARGO_CORRIDORS,
                                        num_actors=ARGO_ACTORS),
                    len(lanes), len(lanes_near(lanes, scen["orig"], ARGO_RADIUS))))
    return out


def tree_equal(a, b) -> bool:
    """Scenario dicts (numpy, lists, scalars) or batch trees (tensors) equal
    bitwise, leaf by leaf."""
    import torch

    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(tree_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if hasattr(a, "leaves"):
        return type(a) is type(b) and tree_equal(a.leaves(), b.leaves())
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def surface_check(what, got, want, results):
    """A card result against its CPU plain version: elementwise within
    TOL["float32"] · (rms + |plain|); records the error over the tolerance.
    The samplers' outputs are ill-conditioned in their positions: a map
    steps by up to 1 between neighbouring pixels, so one ulp of a sample's
    fp32 position (which the card may round otherwise, contracting products
    into FMAs) moves the sample by a good share of that tolerance."""
    import torch

    got, want = got.detach().float().cpu(), want.detach().float()
    rms = float(want.square().mean().sqrt()) if want.numel() else 0.0
    err = float((got - want).abs().max()) if want.numel() else 0.0
    over = float(((got - want).abs() / (TOL["float32"] * (rms + want.abs()))).max()) \
        if want.numel() and rms > 0 else (0.0 if err == 0 else math.inf)
    results[what] = {"shape": list(want.shape), "max_abs_err": err, "rms": rms,
                     "err_over_tol": over}
    check(torch.isfinite(got).all().item(), f"argoverse {what}: non-finite values on the card")
    check(over <= 1.0, f"argoverse {what}: card vs CPU {err} (x{over:.2f} of the tolerance)")


def serve_summary(metrics, what="lanegcn"):
    """loss/ade/fde/mr over eval steps' metrics (MetricAccumulator), each
    asserted finite."""
    from lanegcn_tpu_torch.train.loop import MetricAccumulator

    acc = MetricAccumulator()
    for m in metrics:
        acc.update(m)
    summ = {k: acc.summary()[k] for k in ("loss", "ade", "fde", "mr")}
    check(all(math.isfinite(v) for v in summ.values()), f"argoverse {what}: serve {summ}")
    return summ


def argo_surface(scen, pack_cfg, device, results):
    """segment_softmax on A2M-sized inputs (the A2M capacity and node rows
    of `pack_cfg`; seeded logits and destinations, see SOFTMAX_SPREAD; its
    segment-sum launches counted), get_pixel_feat and get_roi_feat on the raster of
    `scen`'s lane graph, and Conv2dBlock and PostRes (stride 2, with
    downsample) on those RoI crops: fp32, card against CPU."""
    import copy

    import torch
    from lanegcn_tpu_torch.data.raster import RasterMapQuery
    from lanegcn_tpu_torch.models.layers import Conv2dBlock, PostRes, init_parameters
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.ops.roi import get_pixel_feat, get_roi_feat
    from lanegcn_tpu_torch.ops.scatter import segment_softmax

    gen = torch.Generator().manual_seed(0)
    n_edges, n_nodes = pack_cfg.max_a2m_edges, pack_cfg.max_nodes
    logits = torch.randn(n_edges, generator=gen) * 4.0
    idx = torch.randint(0, n_nodes // SOFTMAX_SPREAD, (n_edges,), generator=gen)
    mask = torch.rand(n_edges, generator=gen) < SOFTMAX_LIVE
    args = [logits, idx, n_nodes, mask]
    want = segment_softmax(*args)
    dev = [t.to(device) if isinstance(t, torch.Tensor) else t for t in args]
    cuda.reset_launch_counts()
    got = segment_softmax(*dev)
    _sync(device)
    launches = cuda.launch_counts()
    surface_check("segment_softmax", got, want, results)
    results["segment_softmax"].update(edges=n_edges, live=int(mask.sum()), segments=n_nodes,
                                      launches={k: v for k, v in launches.items() if v})
    if device.type == "cuda":
        check(launches["segment_sum"] == 1 and sum(launches.values()) == 1,
              f"argoverse segment_softmax: launches {launches}")

    g = scen["graph"]
    q = RasterMapQuery.from_lane_graph(g["ctrs"], g["feats"], scale=RASTER_SCALE)
    raster = np.ascontiguousarray(q.query(RASTER_RANGE[:4], theta=0.0))
    fm = torch.cat([torch.from_numpy(raster)[None],
                    torch.rand((RASTER_CHANNELS - 1,) + raster.shape, generator=gen)])
    pts = torch.from_numpy(np.asarray(g["ctrs"], np.float32))
    ctrs = torch.from_numpy(scen["ctrs"])
    heading = torch.rand(len(ctrs), generator=gen) * (2 * math.pi)
    boxes = torch.cat([ctrs, torch.full((len(ctrs), 2), RASTER_BOX), heading[:, None]], 1)
    surface_check("get_pixel_feat", get_pixel_feat(fm.to(device), pts.to(device), RASTER_RANGE),
                  get_pixel_feat(fm, pts, RASTER_RANGE), results)
    crops = get_roi_feat(fm, boxes, RASTER_ROI, RASTER_RANGE)
    surface_check("get_roi_feat", get_roi_feat(fm.to(device), boxes.to(device), RASTER_ROI,
                                               RASTER_RANGE), crops, results)
    results["get_roi_feat"]["raster_lane_px"] = int(raster.sum())
    for name, block in (("Conv2dBlock", Conv2dBlock(RASTER_CHANNELS, 32)),
                        ("PostRes", PostRes(RASTER_CHANNELS, 64, stride=2))):
        init_parameters(block, seed=0)
        on_card = copy.deepcopy(block).to(device)
        with torch.no_grad():
            surface_check(name, on_card(crops.to(device)), block(crops), results)


def argoverse_phase(device_type="cuda"):
    """The Argoverse reader on the card's paths: ARGO_S CSVs written from
    the synthetic worlds (a process pool), each read and built
    (ArgoScenarioDataset, WorldMap) and held against the same world built
    without the CSV (bitwise) and against make_urban_scenario (its actor
    leaves bitwise; the whole dict where no lane was left out); LaneGCN
    through PackedLoader(to_device) on bench_pack_config(ARGO_S), bf16: 2
    packs served and ARGO_TRAIN_STEPS train steps, the bench launches, zero
    drops, the packs bitwise those of the worlds built without the CSV and
    so the outputs and losses; LaneRCNN with RoIs on
    lanercnn_pack_config(ARGO_S): one serve and one train step, zero drops
    of both kinds, its launches; then `argo_surface`."""
    import multiprocessing as mp
    import shutil
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from lanegcn_tpu_torch.config import Config, bench_pack_config, lanercnn_pack_config
    from lanegcn_tpu_torch.data.argoverse import ArgoScenarioDataset
    from lanegcn_tpu_torch.data.dataset import PackedLoader
    from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch
    from lanegcn_tpu_torch.models.lanegcn import LaneGCN
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.train.loop import init_state, make_eval_step, make_train_step

    t_phase = time.perf_counter()
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    on_card = device.type == "cuda"
    root = os.path.join(REPO, "build", "chip_smoke_argo")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # --- write the CSVs; the same worlds built without them ---
    t0 = time.perf_counter()
    procs = max(1, min(8, len(os.sched_getaffinity(0))))
    chunks = [(root, list(range(i * ARGO_S // procs, (i + 1) * ARGO_S // procs)))
              for i in range(procs)]
    with ProcessPoolExecutor(procs, mp_context=mp.get_context("spawn")) as pool:
        refs = [r for part in pool.map(argo_worlds, chunks) for r in part]
    write_s = time.perf_counter() - t0

    # --- read and build each CSV; against the references ---
    ds = ArgoScenarioDataset(root, WorldMap())
    check(len(ds) == ARGO_S, f"argoverse: {len(ds)} CSVs of {ARGO_S}")
    t0 = time.perf_counter()
    items = [ds[i] for i in range(len(ds))]
    read_s = time.perf_counter() - t0
    refs = [refs[it["seq_id"]] for it in items]
    mem = [r[0] for r in refs]
    world_lanes = out_of_radius = clipped = unclipped = 0
    actor_keys = ("feats", "ctrs", "orig", "theta", "rot", "gt_preds", "has_preds", "obs_trajs")
    for it, (m, sy, n_world, n_radius) in zip(items, refs):
        city = it["city"]
        check(city == f"SYN{it['seq_id']}", f"argoverse: city {city} for seq {it['seq_id']}")
        check(tree_equal(it, m), f"argoverse {city}: the CSV route differs from the world's")
        check(all(tree_equal(it[k], sy[k]) for k in actor_keys),
              f"argoverse {city}: actor features differ from make_urban_scenario's")
        n_graph = len(np.unique(it["graph"]["lane_idcs"]))
        world_lanes += n_world
        out_of_radius += n_world - n_radius
        clipped += n_radius - n_graph
        if n_graph == n_world:
            unclipped += 1
            check(tree_equal({k: v for k, v in it.items() if k != "city"},
                             {k: v for k, v in sy.items() if k != "city"}),
                  f"argoverse {city}: no lane clipped, yet differs from make_urban_scenario")

    # --- LaneGCN: the CSVs through the loader, beside the worlds' packs ---
    cfg = Config(pack=bench_pack_config(ARGO_S))
    spec = GEOMETRIES["bench"]

    def loader_packs(dataset, stats):
        loader = PackedLoader(dataset, cfg, seed=0, drop_stats=stats, to_device=True,
                              device=device, pack_workers=2)
        packs = [b for e in range(2) for b in loader.epoch(e)]
        return packs, loader.pack_s

    stats = []
    t0 = time.perf_counter()
    packs, pack_s = loader_packs(ds, stats)
    loader_s = time.perf_counter() - t0
    ref_packs, _ = loader_packs(mem, [])
    drops = {k: v for st in stats for k, v in st.items()
             if k.startswith(("dropped", "skipped", "graph_dropped")) and v}
    check(not drops, f"argoverse lanegcn: drops {drops}")
    check(len(packs) == 2, f"argoverse lanegcn: {len(packs)} packs")
    check(all(tree_equal(a, b) for a, b in zip(packs, ref_packs)),
          "argoverse lanegcn: the CSV packs differ from the worlds' packs")

    net = LaneGCN(cfg.model, dtype=torch.bfloat16, device=device, seed=0)
    step = make_eval_step(cfg, net, device=device)
    cuda.reset_launch_counts()
    outs = [step(b) for b in packs]
    _sync(device)
    serve_counts = cuda.launch_counts()
    ref_outs = [step(b) for b in ref_packs]
    nets = [init_state(cfg, dtype=torch.bfloat16, device=device) for _ in range(2)]
    tsteps = [make_train_step(cfg, n, s, device=device) for n, s in nets]
    cuda.reset_launch_counts()
    train = [tsteps[0](packs[i % 2], i / 100.0) for i in range(ARGO_TRAIN_STEPS)]
    _sync(device)
    train_counts = cuda.launch_counts()
    ref_train = [tsteps[1](ref_packs[i % 2], i / 100.0) for i in range(ARGO_TRAIN_STEPS)]
    gcn = {"serve": serve_summary([m for _, m in outs]),
           "train_loss": [float(m["loss"]) for m in train],
           "skipped": sum(float(m["skipped"]) for m in train)}
    check(all(math.isfinite(x) for x in gcn["train_loss"]) and gcn["skipped"] == 0,
          f"argoverse lanegcn: train {gcn}")
    check(tree_equal(outs, ref_outs), "argoverse lanegcn: equal packs, outputs differ")
    check(tree_equal([m["loss"] for m in train], [m["loss"] for m in ref_train]),
          "argoverse lanegcn: equal packs, train losses differ")
    if on_card:
        check_counts(serve_counts, spec["per_forward"], len(packs), "argoverse lanegcn serve")
        check_counts(train_counts, spec["per_train_step"], ARGO_TRAIN_STEPS,
                     "argoverse lanegcn train")
    del net, step, nets, tsteps, outs, ref_outs, ref_packs

    # --- LaneRCNN: the same CSVs with their RoIs ---
    rcfg = Config(roi_pack=lanercnn_pack_config(ARGO_S))
    rds = ArgoScenarioDataset(root, WorldMap(), with_rois=True)
    rstats = []
    t0 = time.perf_counter()
    rloader = PackedLoader(rds, rcfg, seed=0, drop_stats=rstats, to_device=True, device=device,
                           packer=lambda sc, c: pack_roi_batch(sc, c.roi_pack, c.model),
                           scen_per_pack=ARGO_RCNN_SPP, pack_workers=2)
    rpacks = list(rloader.epoch(0))
    rcnn_loader_s = time.perf_counter() - t0
    rdrops = {k: v for st in rstats for k, v in st.items()
              if k.startswith(("dropped", "skipped", "graph_dropped")) and v}
    check(not rdrops, f"argoverse lanercnn: drops {rdrops}")
    bundle = get_model("lanercnn", rcfg, dtype=torch.bfloat16, device=device, seed=0)
    fns = dict(loss_fn=bundle.loss_fn, metrics_fn=bundle.metrics_fn)
    cuda.reset_launch_counts()
    _, rm = make_eval_step(rcfg, bundle.net, device=device, **fns)(rpacks[0])
    _sync(device)
    rserve_counts = cuda.launch_counts()
    rnet, rstate = init_state(bundle.config, net=bundle.net, device=device)
    rtstep = make_train_step(bundle.config, rnet, rstate, device=device, **fns)
    cuda.reset_launch_counts()
    rtm = rtstep(rpacks[0], 0.0)
    _sync(device)
    rtrain_counts = cuda.launch_counts()
    rcnn = {"serve": serve_summary([rm], "lanercnn"), "train_loss": float(rtm["loss"]),
            "skipped": float(rtm["skipped"]), "packs": len(rpacks),
            "rois": [st["num_rois"] for st in rstats],
            "packed_scenarios": [st["packed_scenarios"] for st in rstats]}
    check(math.isfinite(rcnn["train_loss"]) and rcnn["skipped"] == 0,
          f"argoverse lanercnn: train {rcnn}")
    check(sum(rcnn["packed_scenarios"]) == ARGO_S, f"argoverse lanercnn: {rcnn}")
    if on_card:
        rspec = GEOMETRIES["lanercnn"]
        check_counts(rserve_counts, rspec["per_forward"], 1, "argoverse lanercnn serve")
        check_counts(rtrain_counts, rspec["per_train_step"], 1, "argoverse lanercnn train")
    del bundle, rnet, rstate, rtstep, rpacks

    # --- the rest of the surface, fp32, card against CPU ---
    surface = {}
    argo_surface(max(items, key=lambda it: len(it["ctrs"])), cfg.pack, device, surface)
    emit({"phase": "argoverse", "device": _device_label(device),
          "seconds": time.perf_counter() - t_phase, "scenarios": ARGO_S,
          "write_s": write_s, "write_processes": procs,
          "read_build_s_per_scenario": read_s / ARGO_S,
          "world_lanes": world_lanes, "lanes_out_of_radius": out_of_radius,
          "lanes_clipped_by_pred_range": clipped, "scenarios_whole": unclipped,
          "lanegcn_loader_s": loader_s, "lanegcn_pack_s": pack_s,
          "lanegcn_serve_launches": serve_counts, "lanegcn_train_launches": train_counts,
          "lanegcn": gcn, "lanercnn_loader_s": rcnn_loader_s, "lanercnn": rcnn,
          "lanercnn_serve_launches": rserve_counts,
          "lanercnn_train_launches": rtrain_counts, "surface": surface})
    shutil.rmtree(root, ignore_errors=True)


# The mesh phase: the windowed data×graph split (lanegcn_tpu_torch/parallel/)
# on bench_pack_config(MESH_S) and lanercnn_pack_config(MESH_S) at full width:
# (a) MESH_A_STEPS bf16 steps of a one-rank NCCL world against make_train_step
# from the same weights and packs, bitwise; (b) one fp32 SGD step (lr
# MESH_LR, TF32 off) of two ranks on one card over gloo (NCCL on two cards
# where the machine has them) at D=1×G=2 and D=2×G=1 for LaneGCN and
# D=1×G=2 for LaneRCNN, against the single-device step on the union packs;
# (c) the CLI under torch.distributed.run, --mesh 1x1, preempted and resumed.
MESH_S, MESH_A_STEPS, MESH_SEED, MESH_LR = 256, 3, 11, 0.1
# The scenarios' seeds: LaneGCN's 2·MESH_S from MESH_GCN_SEED0, LaneRCNN's
# MESH_S from MESH_RCNN_SEED0 (lanercnn_pack_config(256) skips scenarios of
# some draws of 256 even whole: ROADMAP.md §3).
MESH_GCN_SEED0, MESH_RCNN_SEED0 = 40_000, 0
# (b)'s flat gradient and SGD update, elementwise within
# MESH_TOL · (rms(reference) + |reference|), and in RMS within
# MESH_RMS_TOL · rms(reference). Both sides are fp32 with TF32 off; the
# ranks' kernels sum each gradient over sub-packs (other block partitions,
# other segment and partial-sum orders, then one all_reduce) where the
# reference sums the union pack: a reorder error of ~1e-6 of the summed
# terms, which a gradient element that cancels can make 1e-5..1e-4 of its
# own size. A missed rank or a gradient scaled by G is off by ~100 % in RMS.
MESH_TOL, MESH_RMS_TOL = 1e-3, 1e-4
MESH_LOSS_RTOL = 1e-4
# (c): LaneGCN on urban:MESH_CLI_N (generated in the loader), packs of
# MESH_CLI_B on the contiguous geometry, MESH_CLI_EPOCHS epochs, SIGTERM to
# the worker after MESH_CLI_PREEMPT_AT step lines.
MESH_CLI_B, MESH_CLI_N, MESH_CLI_EPOCHS, MESH_CLI_PREEMPT_AT = 32, 64, 2, 2
MESH_TIMEOUT = 600  # seconds for the ranks of (b), and for each CLI run
# The phase's explicit part (--graph-parallel explicit, parallel/
# graph_parallel.py), at full width on EX_B scenarios (the first EX_B of
# the phase's LaneGCN and LaneRCNN scenarios): LaneGCN on flat_pack_config
# (EX_B), LaneRCNN on the CLI's flat RoI pack at EX_B (cli._default_config).
# (a) a one-rank NCCL world, G = 1: an fp32 step within the train_parity
# tolerances of make_train_step on the same pack (GRAD_TOL, GRAD_FLOOR),
# then EX_A_STEPS bf16 steps from the same weights bitwise on a rerun, both
# also reported against make_train_step bitwise (the layers add in the
# one-card order; at bf16 a formulation that rounded otherwise would flip
# the max-margin loss's selections and move the mode head's gradients by up
# to a leaf's size, so no tolerance short of bitwise holds there); (b) two ranks on one card over
# gloo at D=1×G=2, fp32, SGD, against the single-device step on the whole
# pack, as the windowed (b); (c) the CLI under torch.distributed.run,
# --mesh 1x1 --graph-parallel explicit --bf16, on urban:EX_CLI_N, preempted
# after EX_CLI_PREEMPT_AT steps and resumed bitwise, no drop in its log.
EX_B, EX_A_STEPS, EX_CLI_N, EX_CLI_PREEMPT_AT = 32, 3, 64, 2
# The launches of a train step: LaneGCN's are the flat geometry's (8
# LaneConv and 6 Att row tails, 6 Att edge chains, 14 scatters and 20
# gathers' backward on segment_sum); LaneRCNN's 12 LaneConv row tails,
# r2g, g2r and a2r's edge chains and K = 2 tails, and segment_sum for the
# a2m, 12 LaneConv, 2 pool and a2r scatters and 16 gathers' backward.
_EX_STEP = {"lanegcn": GEOMETRIES["flat"]["per_train_step"],
            "lanercnn": {"row_tail_fwd": 12, "row_tail_bwd": 12, "row_tail2_fwd": 3,
                         "row_tail2_bwd": 3, "edge_mlp_pool_fwd": 3, "edge_mlp_pool_bwd": 3,
                         "segment_sum": 32}}


def roi_scenarios(seeds):
    """Urban RoI scenarios (7 corridors, 12 actors) with their pack caches,
    for a process pool (a module-level function: spawn imports it)."""
    from lanegcn_tpu_torch.config import ModelConfig
    from lanegcn_tpu_torch.data.packing import precompute_pack_cache
    from lanegcn_tpu_torch.data.packing_roi import precompute_roi_cache
    from lanegcn_tpu_torch.data.synthetic import make_roi_scenario

    out = []
    for seed in seeds:
        scen = make_roi_scenario(seed=seed, num_corridors=7, num_actors=12, urban=True)
        precompute_pack_cache(scen, ModelConfig())
        precompute_roi_cache(scen, ModelConfig())
        out.append(scen)
    return out


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _busy_ms(prof) -> float:
    """The union of the device intervals a torch.profiler trace holds, ms."""
    import torch

    return _union_us([(e.time_range.start, e.time_range.end) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]) / 1e3


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_step(step, batch, epoch, device):
    """(metrics, host ms) of one step, from a synchronize to the next."""
    _sync(device)
    t0 = time.perf_counter()
    m = step(batch, epoch)
    _sync(device)
    return m, (time.perf_counter() - t0) * 1e3


def _profiled_ms(step, batch, epoch, device):
    """(host ms, device busy ms) of one more step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, epoch)
        _sync(device)
        host = (time.perf_counter() - t0) * 1e3
    return host, _busy_ms(prof)


def _peak_gib(device, reset=False):
    """Peak device memory since the last reset (0 off the card)."""
    import torch

    if device.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.max_memory_allocated(device) / 2**30


def _device_label(device):
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def _mesh_config(family, s, train):
    from lanegcn_tpu_torch.config import Config, bench_pack_config, lanercnn_pack_config

    if family == "lanercnn":
        return Config(roi_pack=lanercnn_pack_config(s), train=train)
    return Config(pack=bench_pack_config(s), train=train)


def _explicit_config(train):
    """The explicit part's config: the CLI's under --graph-parallel
    explicit at EX_B scenarios a pack (LaneGCN flat_pack_config, LaneRCNN
    the flat RoI pack)."""
    import dataclasses
    import types

    from lanegcn_tpu_torch import cli

    args = types.SimpleNamespace(batch_size=EX_B, seed=None, graph_parallel="explicit")
    return dataclasses.replace(cli._default_config(args), train=train)


def _case_config(case, train, s=None):
    """The config of a (path, family, D, G) case of the mesh phase (a
    windowed one at packs of `s` scenarios, by default MESH_S)."""
    path, family = case[:2]
    if path == "explicit":
        return _explicit_config(train)
    return _mesh_config(family, MESH_S if s is None else s, train)


def explicit_collectives(family, pack, dtype_bytes, model):
    """(calls, bytes) a train step of each of reduce_scatter and all_gather
    at G > 1 (every tensor counted at its whole [G·n, ...] size): each
    forward reduce-scatter's backward is an all-gather of the same size and
    each all-gather's a reduce-scatter. LaneGCN: 8 LaneConv partials [N, C]
    and 6 Att partials (A2M's [N, C], M2A's and A2A's [A, C]) reduce-
    scattered; 6 Att queries ([N, C], then [A, C]) and the fp32 outputs
    [A, K·(1 + 2T)] gathered. LaneRCNN: 8 RoI LaneConv [M, C], 4 global
    LaneConv [Ng, C] and the two pools' [Ng, C], [M, C] partials; the RoI
    features [M, C] gathered once. C and K from `model` (a ModelConfig)."""
    c = model.n_map
    if family == "lanercnn":
        m, ng = pack.node_feats.shape[0], pack.graph.ctrs.shape[0]
        return 15, (10 * m + 5 * ng) * c * dtype_bytes
    n, a = pack.graph.ctrs.shape[0], pack.actors.ctrs.shape[0]
    k, t = model.num_mods, pack.gt_preds.shape[1]
    partials = (10 * n + 4 * a) * c * dtype_bytes
    queries = (2 * n + 4 * a) * c * dtype_bytes
    outputs = a * k * (1 + 2 * t) * 4
    return 21, partials + queries + outputs


def _mesh_sgd():
    from lanegcn_tpu_torch.config import TrainConfig

    return TrainConfig(opt="sgd", lr=(MESH_LR,), lr_epochs=())


def _flat_grad(net):
    import torch

    return torch.cat([p.grad.reshape(-1).float() for p in net.parameters()])


def mesh_rank(rank, port, path, two_cards, device_type="cuda", s=None):
    """One rank of (b): the windowed or explicit step of each (path,
    family, D, G) case in `path` (one SGD step, fp32), then a warm step
    timed and one profiled; its results to path.rankR. On one card the two
    ranks share it over gloo; on two cards each rank takes its own, over
    NCCL."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from lanegcn_tpu_torch.graph import tree_kind
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.parallel.graph_parallel import make_explicit_parallel_train_step
    from lanegcn_tpu_torch.parallel.mesh import init_mesh
    from lanegcn_tpu_torch.parallel.windowed_parallel import make_windowed_parallel_train_step
    from lanegcn_tpu_torch.train.loop import init_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = (torch.device(device_type, rank if two_cards else 0) if device_type == "cuda"
              else torch.device("cpu"))
    backend = "nccl" if two_cards else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    inputs = torch.load(path, weights_only=False)
    out = {}
    if device.type == "cuda" and not two_cards:
        # NCCL with both ranks on this one card must raise, not switch.
        try:
            init_mesh(1, 2, device=device, backend="nccl")
            out["nccl_one_card"] = "no error"
        except RuntimeError as e:
            out["nccl_one_card"] = str(e)[:120]
    for case, packs in inputs.items():
        path_, family, d, g = case
        mesh = init_mesh(d, g, device=device, backend=backend)
        bundle = get_model(family, _case_config(case, _mesh_sgd(), s), device=device,
                           seed=MESH_SEED)
        net, state = init_state(bundle.config, net=bundle.net, device=device)
        make = (make_explicit_parallel_train_step if path_ == "explicit"
                else make_windowed_parallel_train_step)
        step = make(bundle.config, net, state, mesh, device, bundle.loss_fn, bundle.metrics_fn)
        batch = tree_kind(packs[rank]).from_numpy(packs[rank]).to(device)
        before = state.opt.flat.clone()
        _sync(device)
        _peak_gib(device, reset=True)
        cuda.reset_launch_counts()
        m, first_ms = _timed_step(step, batch, 0.0, device)
        counts = cuda.launch_counts()
        collectives = dict(mesh.counts)
        res = dict(metrics={k: float(v) for k, v in m.items()}, grad=_flat_grad(net).cpu(),
                   leaves=[(n, p.numel()) for n, p in net.named_parameters()],
                   before=before.cpu(), after=state.opt.flat.clone().cpu(), launches=counts,
                   collectives=collectives, first_ms=first_ms, peak_gib=_peak_gib(device))
        _, res["warm_ms"] = _timed_step(step, batch, 0.0, device)
        res["profiled_ms"], res["busy_ms"] = _profiled_ms(step, batch, 0.0, device)
        out[case] = res
        del net, state, step, bundle, batch
    torch.save(out, f"{path}.rank{rank}")
    dist.destroy_process_group()


def _mesh_reference(case, packs, device, s=None):
    """The single-device fp32 SGD step from the same seeded weights on each
    of `packs` (the case's family and config): the mean loss, the other
    metrics summed, the launches of one step, the mean flat gradient and
    the SGD update on that mean."""
    import torch
    from lanegcn_tpu_torch.graph import PackedBatch, RoiPackedBatch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    family = case[1]
    kind = RoiPackedBatch if family == "lanercnn" else PackedBatch
    cfg = _case_config(case, _mesh_sgd(), s)
    losses, grads, sums, launches = [], [], {}, None
    for p in packs:
        bundle = get_model(family, cfg, device=device, seed=MESH_SEED)
        net, state = init_state(bundle.config, net=bundle.net, device=device)
        step = make_train_step(bundle.config, net, state, device, bundle.loss_fn,
                               bundle.metrics_fn)
        _sync(device)
        cuda.reset_launch_counts()
        m = step(kind.from_numpy(p).to(device), 0.0)
        _sync(device)
        launches = cuda.launch_counts()
        losses.append(float(m["loss"]))
        grads.append(_flat_grad(net))
        for k, v in m.items():
            if k not in ("loss", "lr", "skipped"):
                sums[k] = sums.get(k, 0.0) + float(v)
        del net, state, step, bundle
    grad = torch.stack(grads).mean(0)
    bundle = get_model(family, cfg, device=device, seed=MESH_SEED)
    net, state = init_state(bundle.config, net=bundle.net, device=device)
    before = state.opt.flat.clone()
    state.opt.step(state.lr_fn(0.0, device), reduce=lambda g: grad.clone())
    return dict(loss=sum(losses) / len(losses), sums=sums, launches=launches,
                grad=grad.cpu(), update=(state.opt.flat - before).cpu(), before=before.cpu())


def mesh_errors(got, want, eps=0.0):
    """(worst |got − want| / (MESH_TOL · (rms + |want|) + eps), rms(got −
    want) / (MESH_RMS_TOL · rms(want))): each must be ≤ 1. eps covers the
    fp32 rounding of a parameter update read as after − before."""
    rms = float(want.square().mean().sqrt())
    err = (got - want).abs()
    worst = float((err / (MESH_TOL * (rms + want.abs()) + eps)).max())
    rel_rms = float(err.square().mean().sqrt()) / (MESH_RMS_TOL * max(rms, 1e-30))
    return worst, rel_rms


def worst_element(got, want, leaves, parts):
    """Where mesh_errors's elementwise error peaks: the leaf, the element,
    the reference, the mean of the ranks and each rank's own gradient."""
    rms = float(want.square().mean().sqrt())
    i = int(((got - want).abs() / (rms + want.abs())).argmax())
    off = 0
    for name, n in leaves:
        if i < off + n:
            return {"leaf": name, "element": i - off, "want": float(want[i]),
                    "got": float(got[i]), "ranks": [float(p[i]) for p in parts]}
        off += n
    return {}


def mesh_union_order(scens, g):
    """Each graph column's scenarios of one group, in column order, and
    their union: the order the step's gathers lay the group out in."""
    from lanegcn_tpu_torch.parallel.windowed_parallel import balance_scenarios

    parts = balance_scenarios(scens, g, max_per_group=-(-len(scens) // g))
    cols = [[scens[i] for i in grp] for grp in parts]
    return cols, [s for col in cols for s in col]


def _mesh_one_rank(packs, device):
    """(a): MESH_A_STEPS bf16 steps of the windowed step in a one-rank
    NCCL world and of make_train_step, from the same weights on the same
    packs: loss, every gradient and the parameters after each step bitwise
    equal; launches, collectives, step ms and peak memory."""
    import torch
    from lanegcn_tpu_torch.config import TrainConfig
    from lanegcn_tpu_torch.graph import PackedBatch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.parallel.mesh import destroy, init_mesh
    from lanegcn_tpu_torch.parallel.windowed_parallel import make_windowed_parallel_train_step
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    mesh = init_mesh(1, 1, device=device, init_method=f"tcp://127.0.0.1:{_free_port()}")
    try:
        check(mesh.backend == ("nccl" if device.type == "cuda" else "gloo"),
              f"mesh (a): backend {mesh.backend}")
        cfg = _mesh_config("lanegcn", MESH_S, TrainConfig())
        nets = []
        for _ in range(2):
            bundle = get_model("lanegcn", cfg, dtype=torch.bfloat16, device=device,
                               seed=MESH_SEED)
            nets.append(init_state(bundle.config, net=bundle.net, device=device))
        (net_w, st_w), (net_s, st_s) = nets
        step_w = make_windowed_parallel_train_step(cfg, net_w, st_w, mesh, device)
        step_s = make_train_step(cfg, net_s, st_s, device)
        batches = [PackedBatch.from_numpy(p).to(device) for p in packs]
        apart = []
        _sync(device)
        _peak_gib(device, reset=True)
        mesh.counts.clear()
        ms_w, ms_s, counts_w, counts_s = [], [], {}, {}

        def counted(step, acc, b, e):
            cuda.reset_launch_counts()
            m, t = _timed_step(step, b, e, device)
            for k, v in cuda.launch_counts().items():
                acc[k] = acc.get(k, 0) + v
            return m, t

        for i in range(MESH_A_STEPS):
            b, e = batches[i % len(batches)], i / 100.0
            m_w, t_w = counted(step_w, counts_w, b, e)
            ms_w.append(t_w)
            m_s, t_s = counted(step_s, counts_s, b, e)
            ms_s.append(t_s)
            if not torch.equal(m_w["loss"], m_s["loss"]):
                apart.append(f"step {i} loss {float(m_w['loss'])!r} {float(m_s['loss'])!r}")
            if not torch.equal(_flat_grad(net_w), _flat_grad(net_s)):
                apart.append(f"step {i} gradient")
            if not torch.equal(st_w.opt.flat, st_s.opt.flat):
                apart.append(f"step {i} parameters")
            for k in m_s:
                if not torch.equal(m_w[k], m_s[k]):
                    apart.append(f"step {i} metric {k}")
        peak = _peak_gib(device)
        coll = {k: v / MESH_A_STEPS for k, v in mesh.counts.items()}
        spec = GEOMETRIES["bench"]["per_train_step"]
        host_w, busy_w = _profiled_ms(step_w, batches[0], 0.5, device)
        host_s, busy_s = _profiled_ms(step_s, batches[0], 0.5, device)
        res = {"case": "a", "backend": mesh.backend, "world": 1, "dtype": "bfloat16",
               "steps": MESH_A_STEPS, "bitwise_equal": not apart, "apart": apart[:6],
               "step_ms_host": ms_w, "single_device_step_ms_host": ms_s,
               "profiled_step_ms_host": host_w, "busy_ms": busy_w,
               "single_device_profiled_ms_host": host_s, "single_device_busy_ms": busy_s,
               "collectives_per_step": coll, "peak_gib_both_nets": peak,
               "launches_per_step": {k: v / MESH_A_STEPS for k, v in counts_w.items() if v}}
        emit({"phase": "mesh", **res})
        check(not apart, f"mesh (a): the one-rank windowed step differs from make_train_step: "
              f"{apart[:4]}")
        check_counts(counts_w, spec, MESH_A_STEPS, "mesh (a) windowed")
        check_counts(counts_s, spec, MESH_A_STEPS, "mesh (a) single-device")
        check(coll.get("all_gather") == 2 and coll.get("reduce_scatter") == 1
              and coll.get("all_reduce") == 2, f"mesh (a): collectives a step {coll}")
        return res
    finally:
        destroy()


def _mesh_cli(root, device, explicit=False):
    """(c): `python -m torch.distributed.run --nproc-per-node 1 -m
    lanegcn_tpu_torch.cli train --mesh 1x1` (LaneGCN, contiguous packs, bf16,
    2 pack workers; with explicit, `--graph-parallel explicit` on its flat
    packs, urban:EX_CLI_N, SIGTERM after EX_CLI_PREEMPT_AT step lines, and
    no drop in either log): R1 uninterrupted; R2 beside it, SIGTERM to its
    worker after MESH_CLI_PREEMPT_AT step lines (the launcher and the
    worker exit 0, 'SIGTERM: saved'), then resumed: its last checkpoint
    bitwise R1's."""
    import signal
    import threading

    from lanegcn_tpu_torch.train.checkpoint import load_checkpoint

    n, preempt_at = (EX_CLI_N, EX_CLI_PREEMPT_AT) if explicit else (MESH_CLI_N,
                                                                   MESH_CLI_PREEMPT_AT)
    tag = "explicit (c)" if explicit else "mesh (c)"
    root = os.path.join(root, "explicit" if explicit else "windowed")
    os.makedirs(root)

    def start(save_dir, name, *extra):
        return _cli_proc(
            ["train", "--mesh", "1x1", "--data", f"urban:{n}:7:16", "--batch-size",
             str(MESH_CLI_B), "--epochs", str(MESH_CLI_EPOCHS), "--bf16", "--workers", "2",
             "--save-freq", "1", "--display-every", "1", "--save-dir", save_dir, *extra,
             *(["--graph-parallel", "explicit"] if explicit else []),
             *(["--device", "cpu"] if device.type == "cpu" else [])], root, name,
            launcher=("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1"))

    def workers(pid):
        out = []
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
                with open(f"/proc/{entry}/cmdline") as f:
                    cmd = f.read()
            except OSError:
                continue
            if ppid == pid and "lanegcn_tpu_torch.cli" in cmd:
                out.append(int(entry))
        return out

    t0 = time.perf_counter()
    r1, r2 = os.path.join(root, "r1"), os.path.join(root, "r2")
    procs = [start(r1, "r1"), start(r2, "r2")]
    p1, p2 = procs
    watchdog = [threading.Timer(MESH_TIMEOUT, _stop_session, (p,)) for p in procs]
    for w in watchdog:
        w.start()
    try:
        lines, sent = [], False
        for ln in p2.stdout:
            lines.append(ln)
            if not sent and len(_step_lines("".join(lines))) == preempt_at:
                pids = workers(p2.pid)
                check(len(pids) == 1, f"{tag}: workers of the launcher {pids}")
                os.kill(pids[0], signal.SIGTERM)
                sent = True
        rc2 = p2.wait()
        out1 = _cli_wait(p1, "mesh R1", timeout=MESH_TIMEOUT)
        out2 = "".join(lines)
        with open(p2.err_path) as f:
            err2 = f.read()
        check(sent and rc2 == 0, f"{tag} R2: exit code {rc2} after SIGTERM (sent: {sent})\n"
              f"{err2[-3000:]}")
        steps = MESH_CLI_EPOCHS * (n // MESH_CLI_B)
        saved = [ln for ln in out2.splitlines() if ln.startswith("SIGTERM: saved ")]
        check(len(saved) == 1, f"{tag} R2: no 'SIGTERM: saved' line:\n{out2[-2000:]}")
        cut = os.path.join(root, saved[0][len("SIGTERM: saved "):-len(", exiting")])
        cut_step = load_checkpoint(cut)["step"]
        check(preempt_at <= cut_step < steps, f"{tag}: preempted at step {cut_step}")
        procs.append(start(r2, "r2_resumed", "--resume", cut))
        out3 = _cli_wait(procs[-1], "mesh R2 resumed", timeout=MESH_TIMEOUT)
    finally:
        for w in watchdog:
            w.cancel()
        for p in procs:  # a failed check leaves no launcher or worker behind
            _stop_session(p)
    losses1 = _check_step_lines(_step_lines(out1), "mesh R1", steps)
    backend = "nccl" if device.type == "cuda" else "gloo"
    axis = "explicit (source-partitioned)" if explicit else "windowed (scenario-aligned)"
    check(f"mesh: data=1 x graph=1, 1 process(es), {backend}, graph axis: {axis}" in out1,
          f"{tag}: no mesh line")
    _check_step_lines(_step_lines(out3), "mesh R2 resumed", steps - cut_step)
    last = "%3.3f.ckpt" % MESH_CLI_EPOCHS
    equal = _same_checkpoints(load_checkpoint(os.path.join(r1, last)),
                              load_checkpoint(os.path.join(r2, last)))
    coll = [ln for ln in out1.splitlines() if ln.startswith("mesh collectives: ")]
    check(len(coll) == 1, f"{tag}: no 'mesh collectives' line")
    coll = json.loads(coll[0][len("mesh collectives: "):])
    step_s = [float(ln.rsplit("time ", 1)[1].split(",")[0]) for ln in _step_lines(out1)]
    res = {"case": "explicit_c" if explicit else "c",
           "launcher": "torch.distributed.run --nproc-per-node 1",
           "mesh": "1x1", "backend": backend, "scenarios": n, "steps": steps, "preempted_at_step": cut_step,
           "resumed_bitwise_equal": equal, "first_loss": losses1[0], "last_loss": losses1[-1],
           # The log's `time` of each step line (display every step: the step,
           # the loader's wait and the display), first two left out.
           "step_ms_host_from_log": [t * 1e3 for t in step_s[2:]],
           "busy_ms": "not measured", "peak_gib": "not measured",
           "collectives_per_step": {k: v / steps for k, v in coll.items()
                                    if not k.startswith("broadcast")},
           "broadcast_at_start": {k: v for k, v in coll.items() if k.startswith("broadcast")},
           "seconds": time.perf_counter() - t0}
    emit({"phase": "mesh", **res})
    check(equal, f"{tag}: resumed from step {cut_step}, {last} differs from R1's")
    return res


def mesh_packs(s, families=("lanegcn", "lanercnn")):
    """The mesh phase's windowed packs, {("windowed", family, D, G): packs}:
    each rank's and the single-device references' (zero drops of any kind
    asserted), and the scenarios themselves. LaneGCN: 2·s urban scenarios
    in two data rows of bench_pack_config(s) packs, the first row also split
    in two columns at the mesh's subdivided capacities (graph_split) and its
    union in column order; LaneRCNN: s urban RoI scenarios split in two
    columns of lanercnn_pack_config(s) likewise, and their union. Scenarios
    made by a pool of up to 8 processes; those of `families` only."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    from lanegcn_tpu_torch.parallel.windowed_parallel import graph_split

    t0 = time.perf_counter()
    procs = max(1, min(8, len(os.sched_getaffinity(0))))
    with ProcessPoolExecutor(procs, mp_context=mp.get_context("spawn")) as pool:
        gcn = pool.map(urban_scenarios, [range(MESH_GCN_SEED0 + i, MESH_GCN_SEED0 + 2 * s, procs)
                                         for i in range(procs if "lanegcn" in families else 0)])
        rcnn = pool.map(roi_scenarios, [range(MESH_RCNN_SEED0 + i, MESH_RCNN_SEED0 + s, procs)
                                        for i in range(procs if "lanercnn" in families else 0)])
        gcn = [sc for part in gcn for sc in part]
        rcnn = [sc for part in rcnn for sc in part]
    gen_s = time.perf_counter() - t0

    class _Col:  # the graph column count graph_split reads
        def __init__(self, g):
            self.graph, self.g = g, 0

    t0 = time.perf_counter()
    inputs, refs_from = {}, {}
    rows = [gcn[:s], gcn[s:]]
    for family, group_scens, d, g in (("lanegcn", rows, 2, 1), ("lanegcn", rows[:1], 1, 2),
                                      ("lanercnn", [rcnn], 1, 2)):
        if family not in families:
            continue
        case = ("windowed", family, d, g)
        cfg = _mesh_config(family, s, _mesh_sgd())
        if g == 1:
            packs = [_packed(family, r, cfg) for r in group_scens]
            inputs[case], refs_from[case] = packs, packs
        else:
            cols, union = mesh_union_order(group_scens[0], g)
            sub = graph_split(cfg, _Col(g), family).config
            inputs[case] = [_packed(family, c, sub) for c in cols]
            refs_from[case] = [_packed(family, union, cfg)]
    pack_s = time.perf_counter() - t0
    return inputs, refs_from, {"gen_s": gen_s, "gen_processes": procs, "pack_s": pack_s}, \
        {"lanegcn": gcn, "lanercnn": rcnn}


def _packed(family, scens, cfg, packer=None):
    """One pack of `scens` (the family's default packer, or `packer`);
    zero drops and skips of any kind asserted (dropped_shard_edges too)."""
    from lanegcn_tpu_torch.data.packing import pack_batch
    from lanegcn_tpu_torch.data.packing_roi import pack_roi_batch

    if packer is not None:
        b, st = packer(scens, cfg)
    elif family == "lanercnn":
        b, st = pack_roi_batch(scens, cfg.roi_pack, cfg.model)
    else:
        b, st = pack_batch(scens, cfg.pack, cfg.model)
    bad = {k: v for k, v in st.items()
           if k.startswith(("dropped", "graph_dropped", "skipped")) and v}
    check(not bad and st["packed_scenarios"] == len(scens),
          f"mesh: {family} pack of {len(scens)} dropped {bad} "
          f"(packed {st['packed_scenarios']})")
    return b


def explicit_packs(scens):
    """The explicit part's packs from the first EX_B scenarios of each
    family: {("explicit", family, 1, G): [each column's ShardedPack]} at
    G = 1 and 2, each packed and partitioned as the CLI's loader does
    (explicit_packer), zero drops asserted."""
    from lanegcn_tpu_torch.parallel.graph_parallel import explicit_packer

    cfg = _explicit_config(_mesh_sgd())
    return {("explicit", fam, 1, g): [_packed(fam, scens[fam][:EX_B], cfg,
                                              explicit_packer(fam, g, col))
                                      for col in range(g)]
            for fam in ("lanegcn", "lanercnn") for g in (1, 2)}


def rank_share(family, sp, g, col):
    """Graph column col's live rows of each node space and live edges of its
    partition, of a ShardedPack (the flat packs fill their rows from 0, so
    the first columns hold most of them)."""
    p = sp.pack
    spaces = ({"roi_nodes": p.node_mask, "global_nodes": p.graph.node_mask}
              if family == "lanercnn" else
              {"lane_nodes": p.graph.node_mask, "actors": p.actors.mask})

    def edges(x):
        if isinstance(x, dict):
            return sum(edges(v) for v in x.values())
        return int(x.mask.sum())

    out = {}
    for name, live in spaces.items():
        n = live.shape[0] // g
        out[name] = int(live[col * n:(col + 1) * n].sum())
    out["edges"] = edges(sp.edges)
    return out


def _explicit_one_rank(packs, device):
    """(a) of the explicit part: a one-rank NCCL world, G = 1, LaneGCN and
    LaneRCNN at full width on their EX_B packs. An fp32 explicit step
    (TF32 off, the model's optimizer) within the train_parity tolerances of
    make_train_step from the same weights: the loss within 1e-3, every
    gradient within GRAD_TOL of its leaf's max |g| (floored at GRAD_FLOOR
    of the largest); whether it is bitwise make_train_step's is reported
    (at G = 1 the layers add in the one-card order). Then EX_A_STEPS bf16
    steps run twice from the same weights, bitwise equal (loss, gradient,
    parameters), with their launches a step against the layer layout's,
    collectives, host ms, device busy ms (profiled, one more step) and peak
    memory, beside make_train_step's from the same weights."""
    import torch
    from lanegcn_tpu_torch.config import TrainConfig
    from lanegcn_tpu_torch.graph import ShardedPack
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.ops import cuda
    from lanegcn_tpu_torch.parallel.graph_parallel import make_explicit_parallel_train_step
    from lanegcn_tpu_torch.parallel.mesh import destroy, init_mesh
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    mesh = init_mesh(1, 1, device=device, init_method=f"tcp://127.0.0.1:{_free_port()}")
    cfg = _explicit_config(TrainConfig())
    out = []
    try:
        check(mesh.backend == ("nccl" if device.type == "cuda" else "gloo"),
              f"explicit (a): backend {mesh.backend}")
        for family in ("lanegcn", "lanercnn"):
            sp = ShardedPack.from_numpy(packs[("explicit", family, 1, 1)][0]).to(device)

            def net_state(dtype):
                bundle = get_model(family, cfg, dtype=dtype, device=device, seed=MESH_SEED)
                net, state = init_state(bundle.config, net=bundle.net, device=device)
                return bundle, net, state

            # fp32: the explicit step against make_train_step.
            grads, losses = [], []
            for explicit in (True, False):
                bundle, net, state = net_state(torch.float32)
                if explicit:
                    step = make_explicit_parallel_train_step(
                        bundle.config, net, state, mesh, device, bundle.loss_fn,
                        bundle.metrics_fn)
                    m = step(sp, 0.0)
                else:
                    m = make_train_step(bundle.config, net, state, device, bundle.loss_fn,
                                        bundle.metrics_fn)(sp.pack, 0.0)
                losses.append(float(m["loss"]))
                grads.append({n: p.grad.detach().clone() for n, p in net.named_parameters()})
                del bundle, net, state
            top = max(float(g.abs().max()) for g in grads[1].values())
            shares = {n: float((grads[0][n] - g).abs().max())
                      / (GRAD_TOL * max(float(g.abs().max()), GRAD_FLOOR * top))
                      for n, g in grads[1].items()}
            worst = max(shares, key=shares.get)
            fp32_bitwise = losses[0] == losses[1] and all(
                torch.equal(grads[0][n], g) for n, g in grads[1].items())

            # bf16: EX_A_STEPS explicit steps twice from the same weights, then
            # make_train_step's.
            runs = []
            for explicit in (True, True, False):
                bundle, net, state = net_state(torch.bfloat16)
                if explicit:
                    step = make_explicit_parallel_train_step(
                        bundle.config, net, state, mesh, device, bundle.loss_fn,
                        bundle.metrics_fn)
                    batch = sp
                else:
                    step = make_train_step(bundle.config, net, state, device, bundle.loss_fn,
                                           bundle.metrics_fn)
                    batch = sp.pack
                mesh.counts.clear()
                _sync(device)
                _peak_gib(device, reset=True)
                cuda.reset_launch_counts()
                ls, ms, skipped = [], [], 0.0
                for i in range(EX_A_STEPS):
                    m, t = _timed_step(step, batch, i / 100.0, device)
                    ls.append(m["loss"].clone())
                    ms.append(t)
                    skipped += float(m["skipped"])
                launches = cuda.launch_counts()
                coll = {k: v / EX_A_STEPS for k, v in mesh.counts.items()}
                peak = _peak_gib(device)
                host, busy = _profiled_ms(step, batch, 0.5, device)
                runs.append(dict(losses=torch.stack(ls), grad=_flat_grad(net),
                                 flat=state.opt.flat.clone(), launches=launches, coll=coll,
                                 ms=ms, host=host, busy=busy, peak=peak, skipped=skipped))
                del bundle, net, state, step
            r1, r2, single = runs
            same = lambda a, b: all(torch.equal(a[k], b[k])  # noqa: E731
                                    for k in ("losses", "grad", "flat"))
            bitwise = same(r1, r2)
            calls, nbytes = explicit_collectives(family, sp.pack, 2, cfg.model)
            res = {"case": "explicit_a", "family": family, "backend": mesh.backend, "world": 1,
                   "pack": f"flat, {EX_B} scenarios", "fp32_loss": losses[0],
                   "fp32_loss_make_train_step": losses[1],
                   "fp32_worst_grad_err_over_tol": shares[worst], "fp32_worst_grad_leaf": worst,
                   "fp32_bitwise_equal_make_train_step": fp32_bitwise,
                   "grad_tol_rel": GRAD_TOL, "bf16_steps": EX_A_STEPS,
                   "bf16_losses": r1["losses"].tolist(), "bf16_skipped": r1["skipped"],
                   "bf16_rerun_bitwise_equal": bitwise,
                   "bf16_bitwise_equal_make_train_step": same(r1, single),
                   "step_ms_host": r1["ms"] + r2["ms"], "profiled_step_ms_host": r1["host"],
                   "busy_ms": [r1["busy"], r2["busy"]], "peak_gib": r1["peak"],
                   "single_device_step_ms_host": single["ms"],
                   "single_device_busy_ms": single["busy"],
                   "single_device_peak_gib": single["peak"],
                   "launches_per_step": {k: v / EX_A_STEPS for k, v in r1["launches"].items()
                                         if v},
                   "collectives_per_step": r1["coll"],
                   "predicted_collectives_per_step": {"reduce_scatter": calls,
                                                      "reduce_scatter_bytes": nbytes,
                                                      "all_gather": calls,
                                                      "all_gather_bytes": nbytes}}
            emit({"phase": "mesh", **res})
            out.append(res)
            what = f"explicit (a) {family}"
            check(abs(losses[0] - losses[1]) <= 1e-3 * max(1.0, abs(losses[1])),
                  f"{what}: fp32 loss {losses[0]} vs make_train_step's {losses[1]}")
            check(shares[worst] <= 1.0, f"{what}: fp32 {worst}'s gradient off by "
                  f"{shares[worst]} x its tolerance")
            check(bitwise, f"{what}: bf16 steps differ on a rerun")
            check(r1["skipped"] == 0.0, f"{what}: the guard skipped {r1['skipped']} bf16 steps")
            check_counts(r1["launches"], _EX_STEP[family], EX_A_STEPS, what)
            for k in ("reduce_scatter", "all_gather", "reduce_scatter_bytes", "all_gather_bytes"):
                want = res["predicted_collectives_per_step"][k]
                check(r1["coll"].get(k) == want, f"{what}: {k} {r1['coll'].get(k)} a step, "
                      f"predicted {want}")
            if device.type == "cuda":
                torch.cuda.empty_cache()
        return out
    finally:
        destroy()


def _run_ranks(inputs, device, root, tag, s=None):
    """mesh_rank on two ranks over every case of `inputs` (gloo on one card
    or on the CPU, NCCL on two cards): (each rank's results, whether it
    took two cards, seconds of the ranks)."""
    import torch
    import torch.multiprocessing as tmp

    two_cards = device.type == "cuda" and torch.cuda.device_count() >= 2
    path = os.path.join(root, f"{tag}.pt")
    torch.save(inputs, path)
    t0 = time.perf_counter()
    ctx = tmp.start_processes(mesh_rank, args=(_free_port(), path, two_cards, device.type, s),
                              nprocs=2, join=False, start_method="spawn")
    try:
        while not ctx.join(timeout=5):
            check(time.perf_counter() - t0 < MESH_TIMEOUT,
                  f"mesh (b): the ranks did not end within {MESH_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(f"{path}.rank{r}", weights_only=False) for r in range(2)]
    return ranks, two_cards, time.perf_counter() - t0


def _two_ranks(inputs, refs_from, device, root, tag):
    """(b): every case of `inputs` on two ranks (gloo on one card, NCCL on
    two) against the single-device step on its reference packs, checked
    and emitted; returns (results, seconds of the ranks)."""
    import torch

    refs = {case: _mesh_reference(case, packs, device) for case, packs in refs_from.items()}
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ranks, two_cards, ranks_s = _run_ranks(inputs, device, root, tag)
    backend = "nccl, two cards" if two_cards else "gloo, two ranks on one card"
    if device.type == "cuda" and not two_cards:
        refusals = [r.pop("nccl_one_card") for r in ranks]
        emit({"phase": "mesh", "case": "nccl_two_ranks_one_card", "raised": refusals})
        check(all("two ranks on one card" in e for e in refusals),
              f"mesh: NCCL with two ranks on one card did not raise: {refusals}")
    b_results = []
    for case, ref in refs.items():
        path_, family, d, g = case
        r0, r1 = (r[case] for r in ranks)
        grad = (r0["grad"] + r1["grad"]) / 2
        g_worst, g_rms = mesh_errors(grad, ref["grad"])
        eps = 4 * torch.finfo(torch.float32).eps * ref["before"].abs()
        rows_ = []
        for i, r in enumerate((r0, r1)):
            u_worst, u_rms = mesh_errors(r["after"] - r["before"], ref["update"], eps)
            m = r["metrics"]
            rows_.append({
                "loss": m["loss"], "loss_ref": ref["loss"],
                "counts": {k: m[k] for k in ref["sums"] if k.startswith("num_")},
                "update_err_over_tol": u_worst, "update_rms_err_over_tol": u_rms,
                "skipped": m["skipped"], "launches_equal_single_device":
                    r["launches"] == ref["launches"],
                "first_step_ms_host": r["first_ms"], "warm_step_ms_host": r["warm_ms"],
                "profiled_step_ms_host": r["profiled_ms"], "busy_ms": r["busy_ms"],
                "peak_gib": r["peak_gib"], "collectives_first_step": r["collectives"]})
            if path_ == "explicit":
                rows_[-1]["live"] = rank_share(family, inputs[case][i], g, i)
        res = {"case": "b", "path": path_, "family": family, "mesh": f"{d}x{g}",
               "backend": backend, "dtype": "float32", "opt": "sgd", "lr": MESH_LR,
               "tol": MESH_TOL, "rms_tol": MESH_RMS_TOL,
               "grad_err_over_tol": g_worst, "grad_rms_err_over_tol": g_rms,
               "grad_worst_element": worst_element(grad, ref["grad"], r0["leaves"],
                                                   (r0["grad"], r1["grad"])),
               "ranks": rows_, "ranks_params_equal": torch.equal(r0["after"], r1["after"]),
               "launches_per_step": {k: v for k, v in r0["launches"].items() if v}}
        if path_ == "explicit":
            calls, nbytes = explicit_collectives(family, refs_from[case][0], 4,
                                                 _case_config(case, _mesh_sgd()).model)
            res["predicted_collectives_per_step"] = {"reduce_scatter": calls,
                                                     "reduce_scatter_bytes": nbytes}
        emit({"phase": "mesh", **res})
        b_results.append(res)
        per_step = (_EX_STEP[family] if path_ == "explicit" else
                    GEOMETRIES["lanercnn" if family == "lanercnn" else "bench"]["per_train_step"])
        for i, (r, row) in enumerate(zip((r0, r1), rows_)):
            what = f"mesh (b) {path_} {family} {d}x{g} rank {i}"
            check(abs(row["loss"] - ref["loss"]) <= MESH_LOSS_RTOL * abs(ref["loss"]),
                  f"{what}: loss {row['loss']} vs {ref['loss']}")
            for k, v in ref["sums"].items():
                if k.startswith("num_"):
                    check(r["metrics"][k] == v, f"{what}: {k} {r['metrics'][k]} vs {v}")
            check(row["skipped"] == 0.0, f"{what}: the guard skipped the step")
            check(row["update_err_over_tol"] <= 1.0 and row["update_rms_err_over_tol"] <= 1.0,
                  f"{what}: SGD update off by {row['update_err_over_tol']} x the tolerance "
                  f"(RMS {row['update_rms_err_over_tol']})")
            check_counts(r["launches"], per_step, 1, what)
            check(row["launches_equal_single_device"], f"{what}: launches {r['launches']} vs "
                  f"the single-device step's {ref['launches']}")
            if path_ == "explicit":
                coll = r["collectives"]
                for k in ("reduce_scatter", "all_gather"):
                    check(coll.get(k) == calls and coll.get(k + "_bytes") == nbytes,
                          f"{what}: {k} {coll.get(k)} calls, {coll.get(k + '_bytes')} bytes; "
                          f"predicted {calls}, {nbytes}")
                check(coll.get("all_reduce") == 2, f"{what}: all_reduce {coll.get('all_reduce')}")
        check(g_worst <= 1.0 and g_rms <= 1.0, f"mesh (b) {path_} {family} {d}x{g}: gradient "
              f"off by {g_worst} x the tolerance (RMS {g_rms})")
        check(res["ranks_params_equal"], f"mesh (b) {path_} {family} {d}x{g}: ranks' params "
              f"differ")
    return b_results, ranks_s


def mesh_phase(device_type="cuda"):
    """The multi-GPU trainer. The windowed data×graph split: (a) a one-rank
    NCCL world bitwise against make_train_step; (b) two ranks (gloo on one
    card, NCCL on two) against the single-device step on the union packs;
    (c) the CLI under torch.distributed.run, preempted and resumed bitwise.
    Then the explicit graph-parallel split's (a), (b) and (c) (see EX_B).
    Each run's step ms (host clock and device busy), collectives a step and
    their bytes, and peak memory; gloo's times are not NCCL's."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    # The card's index; the CPU takes none (Module.to("cpu:0") copies the
    # parameters out of the flat optimizer's buffer).
    device = torch.device(device_type, 0) if device_type == "cuda" else torch.device("cpu")
    root = os.path.join(REPO, "build", "chip_smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    inputs, refs_from, sizes, scens = mesh_packs(MESH_S)

    # (a) on the bench packs of the two data rows.
    a = _mesh_one_rank(inputs[("windowed", "lanegcn", 2, 1)], device)
    b_results, ranks_s = _two_ranks(inputs, refs_from, device, root, "windowed")
    c = _mesh_cli(root, device)
    t_windowed = time.perf_counter() - t_phase

    # The explicit part.
    t0 = time.perf_counter()
    ex = explicit_packs(scens)
    ex_pack_s = time.perf_counter() - t0
    ex_a = _explicit_one_rank(ex, device)
    ex_inputs = {k: v for k, v in ex.items() if k[3] == 2}
    ex_refs = {k: [v[0].pack] for k, v in ex_inputs.items()}
    ex_b, ex_ranks_s = _two_ranks(ex_inputs, ex_refs, device, root, "explicit")
    ex_c = _mesh_cli(root, device, explicit=True)
    ex_s = time.perf_counter() - t0
    emit({"phase": "mesh", "device": _device_label(device), "backend_b": ex_b[0]["backend"],
          "seconds": time.perf_counter() - t_phase, "windowed_seconds": t_windowed,
          "explicit_seconds": ex_s, "explicit_pack_s": ex_pack_s,
          "explicit_ranks_s": ex_ranks_s, **sizes, "ranks_s": ranks_s,
          "a_bitwise": a["bitwise_equal"], "b_cases": len(b_results),
          "c_resumed_bitwise": c["resumed_bitwise_equal"],
          "explicit_a_bitwise": all(r["bf16_rerun_bitwise_equal"] for r in ex_a),
          "explicit_b_cases": len(ex_b),
          "explicit_c_resumed_bitwise": ex_c["resumed_bitwise_equal"]})
    shutil.rmtree(root, ignore_errors=True)


# The mesh witness (`python3 chip_smoke.py mesh-witness`, no other phase):
# (b)'s windowed LaneRCNN 1x2 case on packs of MESH_WITNESS_S scenarios,
# the cut at which the card's update once missed MESH_TOL at one element
# (ROADMAP.md §3); the card's single-device step is moved by TIE_PERTURB
# with each of MESH_WITNESS_MOVES seeds.
MESH_WITNESS_S, MESH_WITNESS_MOVES = 128, 8


def mesh_witness_phase(s=MESH_WITNESS_S, devices=("cuda", "cpu")):
    """(b)'s LaneRCNN 1x2 case on packs of `s` scenarios: the two ranks'
    mean gradient against the single-device step on the union pack, on
    each of `devices` (two gloo ranks). Then, as train_parity_phase takes
    it, the CPU's single-device step again with every torch.relu input
    recorded, from the same parameters and from parameters moved by
    TIE_PERTURB; and on the card the single-device step once more from the
    same parameters (a rerun, bitwise) and from MESH_WITNESS_MOVES moves.
    The worst element of the first device's ranks is a tie (`tie`) where a
    ReLU input near zero takes the other side under the CPU's move and a
    move alone carries that element past its tolerance. Emits what it
    found; fails only where a run fails."""
    import contextlib
    import shutil

    import torch
    from lanegcn_tpu_torch.graph import RoiPackedBatch
    from lanegcn_tpu_torch.models.registry import get_model
    from lanegcn_tpu_torch.train.loop import init_state, make_train_step

    t_phase = time.perf_counter()
    case = ("windowed", "lanercnn", 1, 2)
    root = os.path.join(REPO, "build", "chip_smoke_witness")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    inputs, refs_from, _, _ = mesh_packs(s, families=("lanercnn",))
    union = refs_from[case]
    found, grads = {}, {}
    for kind in devices:
        device = torch.device(kind, 0) if kind == "cuda" else torch.device("cpu")
        ref = _mesh_reference(case, union, device, s)
        ranks, _, ranks_s = _run_ranks(inputs, device, root, kind, s)
        r0, r1 = (r[case] for r in ranks)
        grad = (r0["grad"] + r1["grad"]) / 2
        worst, rms = mesh_errors(grad, ref["grad"])
        grads[kind] = (grad, ref["grad"])
        leaves = r0["leaves"]
        found[kind] = {"grad_err_over_tol": worst, "grad_rms_err_over_tol": rms,
                       "worst_element": worst_element(grad, ref["grad"], leaves,
                                                      (r0["grad"], r1["grad"])),
                       "ranks_s": ranks_s}
        del ranks, r0, r1
        if kind == "cuda":
            torch.cuda.empty_cache()

    cfg = _case_config(case, _mesh_sgd(), s)
    batch = RoiPackedBatch.from_numpy(union[0])

    def step_grad(device, seed=None, near=None, record=True):
        """The single-device step's flat gradient on the union pack from the
        seeded weights, moved by TIE_PERTURB with generator `seed` (None:
        not moved), with its torch.relu inputs recorded where `record`:
        (gradient, calls)."""
        bundle = get_model("lanercnn", cfg, device=device, seed=MESH_SEED)
        if seed is not None:
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                for p in bundle.net.parameters():
                    p.mul_(1 + TIE_PERTURB * torch.randn(p.shape, generator=gen).to(p.device))
        net, state = init_state(bundle.config, net=bundle.net, device=device)
        step = make_train_step(bundle.config, net, state, device, bundle.loss_fn,
                               bundle.metrics_fn)
        rec = relu_recorder(near) if record else contextlib.nullcontext()
        with rec:
            step(batch.to(device), 0.0)
        return _flat_grad(net).cpu(), rec.calls if record else None

    g0, near = step_grad("cpu")
    g1, moved = step_grad("cpu", seed=1, near=near)
    flips = relu_flips(near, moved)
    del near, moved
    # The first device's worst element and its tolerance against the CPU's
    # reference; how far each move alone carries it, in those units.
    got, want = grads[devices[0]]
    rms = float(want.square().mean().sqrt())
    i = int(((got - want).abs() / (rms + want.abs())).argmax())
    tol_i = MESH_TOL * (float(g0.square().mean().sqrt()) + abs(float(g0[i])))
    cpu_move = abs(float(g1[i] - g0[i])) / tol_i
    move_worst, move_rms = mesh_errors(g1, g0)
    card = {}
    if "cuda" in devices:
        card_ref = grads["cuda"][1]
        rerun, _ = step_grad("cuda", record=False)
        card["rerun_bitwise"] = torch.equal(rerun, card_ref)
        card["moves"] = []
        for seed in range(1, MESH_WITNESS_MOVES + 1):
            gm, _ = step_grad("cuda", seed=seed, record=False)
            worst, rms_m = mesh_errors(gm, card_ref)
            card["moves"].append({"seed": seed, "element_over_tol":
                                  abs(float(gm[i] - card_ref[i])) / tol_i,
                                  "grad_err_over_tol": worst, "grad_rms_err_over_tol": rms_m})
        torch.cuda.empty_cache()
    card_move = max((m["element_over_tol"] for m in card.get("moves", [])), default=0.0)
    at = {k: {"ranks": float(g[0][i]), "reference": float(g[1][i])} for k, g in grads.items()}
    emit({"phase": "mesh_witness", "case": "b windowed lanercnn 1x2", "scenarios": s,
          "dtype": "float32", "tol": MESH_TOL, "rms_tol": MESH_RMS_TOL, **found,
          "element": at, "element_tol": tol_i, "cpu_step": float(g0[i]),
          "cpu_moved_step": float(g1[i]), "tie_perturb": TIE_PERTURB,
          "cpu_move_element_over_tol": cpu_move, "cpu_move_grad_err_over_tol": move_worst,
          "cpu_move_grad_rms_err_over_tol": move_rms, "relu_flips": len(flips),
          "nearest_relu_flips": flips[:3], "card": card,
          "tie": bool(flips) and max(cpu_move, card_move) > 1.0,
          "seconds": time.perf_counter() - t_phase})
    shutil.rmtree(root, ignore_errors=True)


def kernel_name(mangled):
    """A kernel's own name inside its mangled entry name (the identifier
    after its length prefix that ends in "_kernel"), else the name itself."""
    for j in range(1, len(mangled)):
        i = j
        while i > 0 and mangled[i - 1].isdigit():
            i -= 1
            name = mangled[j:j + int(mangled[i:j])]
            if name.endswith("_kernel"):
                return name
    return mangled


def ptxas_entries(logs, part):
    """{kernel: its registers and spill lines} from `nvcc -Xptxas -v` logs
    ({library: log}) for the entry functions whose name holds `part`."""
    out, entry = {}, None
    for log in logs.values():
        for ln in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                entry = kernel_name(m.group(1)) if part in m.group(1) else None
            elif entry and ("registers" in ln or "spill" in ln):
                out.setdefault(entry, []).append(ln.split(":", 1)[-1].strip())
    return out


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, REPO)
    from lanegcn_tpu_torch.ops import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- env + build ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([cuda._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    build = cuda.build_all()
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln or "smem" in ln][:12]
        for name, log in build["ptxas"].items()
    }
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "triton": triton_version, "nvcc": nvcc, "gpu": smi,
          "device": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          "build_s": build["seconds"], "ptxas": ptxas,
          "ptxas_wide": ptxas_entries(build["ptxas"], "_wide")})
    if sys.argv[1:] == ["mesh-witness"]:
        mesh_witness_phase()
        print(smi, flush=True)
        return

    kernels, paths, seconds = {}, {}, {}
    for geom in GEOMETRIES:
        t0 = time.perf_counter()
        results, serve, train = drive(geom)
        seconds[geom] = time.perf_counter() - t0
        paths[geom] = (serve, train)
        torch.cuda.empty_cache()
        for name, res in results.items():
            source, replaces, entries = KERNEL_META[name]
            which = 1 if name.endswith("_bwd") else 0
            counts, runs = paths[geom][which]
            launches = counts[entries[0]]
            if name in kernels:  # checked again at this geometry's shapes
                for w, at in res["by_width"].items():  # a width first checked here
                    kernels[name]["by_width"].setdefault(w, {**at, "geometry": geom})
                kernels[name].setdefault("also_checked", {})[geom] = {
                    "shape": res["bfloat16"]["shape"], "launches": launches,
                    "err_over_tol": res["bfloat16"]["err_over_tol"],
                    "rel_rms_err": res["bfloat16"]["rel_rms_err"],
                    "max_abs_err_fp32": res["float32"]["max_abs_err"],
                    "err_over_tol_fp32": res["float32"]["err_over_tol"],
                    "ms": res["ms"], "plain_ms": res["plain_ms"],
                    "bound_ms": res["work"]["bound_ms"], "bound_by": res["work"]["bound_by"],
                    "by_call": res["by_call"], "by_width": res["by_width"]}
                continue
            kernels[name] = {
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "geometry": geom, "launches": launches, "launches_per_step": launches // runs,
                "entries": {e: counts[e] for e in entries},
                "max_abs_err": res["bfloat16"]["max_abs_err"],
                "rms": res["bfloat16"]["rms"], "tol_abs": res["bfloat16"]["tol_abs"],
                "err_over_tol": res["bfloat16"]["err_over_tol"],
                "rel_rms_err": res["bfloat16"]["rel_rms_err"],
                "max_abs_err_fp32": res["float32"]["max_abs_err"],
                "ms": res["ms"], "plain_ms": res["plain_ms"],
                "ms_per_step": res["ms_per_step"],
                "bound_ms": res["work"]["bound_ms"], "bound_by": res["work"]["bound_by"],
                "library_ms": res["library_ms"], "by_width": res["by_width"],
            }
    for phase in (cli_phase, loader_phase, argoverse_phase, mesh_phase):
        t0 = time.perf_counter()
        phase()
        seconds[phase.__name__] = time.perf_counter() - t0
    emit({"phase": "seconds", **seconds})
    kernels = list(kernels.values())
    # Every kernel's launches on every path, beside its home geometry's count
    # (None: the path does not train).
    for k in kernels:
        entry, bwd = KERNEL_META[k["name"]][2][0], k["name"].endswith("_bwd")
        k["launches_by_geometry"] = {g: p[int(bwd)][0][entry] if p[int(bwd)] else None
                                     for g, p in paths.items()}
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()  # any failure raises: traceback and a non-zero exit
