"""Drive the PyTorch/CUDA port (weathermodel_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:
  1. device  - requires CUDA; prints the card and its power limit
  2. build   - compiles csrc/*.cu with nvcc for sm_90a; build time and the
               ptxas report (registers, spills); then the bf16 grouped-matmul
               body's registers, spills and shared memory for each of its
               instantiations (expert_gemm_wgmma_kernel<kTransB, kBias>: B4
               and P3 <false|true, false>, B5's phase 2 <true, true>;
               expert_wgrad_wgmma_kernel<kPartials>: B4t <false>, B6b's
               weight gradients <true>), failing on a serialized-wgmma warning
               (C7512) in any
  3. kernel  - the bf16 attention body's (qkv_attention_wgmma_kernel, B1 and
               B5's first phase) ptxas registers and spills of the eval form,
               short-T and streaming, and its shared memory; the fused QKV
               attention kernel vs its plain PyTorch version at
               WeatherBERT-large's serving shapes (B=256, T=365, H=576, 16
               heads) in fp32 and bf16, with CUDA-event times of both (bf16
               beside the recorded ones); then at the edge shapes (T = 1, 64,
               65, 383, 384 at the four head dims, 453, 512, and past what
               stays on chip: 513, 730, 1024 at each head dim and the limit
               1536), in both dtypes
  4. kernel_outproj - the fused QKV attention + out-projection kernel B5 vs
               its plain version at the same shapes in fp32 and bf16, and with
               dropout 0.1 at B=32 (the same seed on both sides); CUDA-event
               times of the kernel, the plain version, the library call
               (F.linear + scaled_dot_product_attention + F.linear) and B1's
               eval form + F.linear; the body's ptxas report for B5's two
               forms; profiled bf16 calls split into phase 1 (the attention
               body) and phase 2 (the grouped matmul's body with its bias,
               expert_gemm_wgmma_kernel<true, true>; no bf16 outproj_kernel of
               the WMMA tiles may run), phase 2 beside its library call
               F.linear(o, wo, bo) and its bound; bf16 B5's time beside the
               recorded ones;
               the edge shapes, dropout 0 and 0.1
  5. serve   - a seeded WeatherBERT-large saved as a reference .pth and 300
               seeded windows served through the `wm-serve-torch` entry point
               in bf16 (a 256 chunk + 44 rows padded to the 128 bucket), with
               --attention-impl auto (B1 eval must launch 16 times: 8 layers x
               2 chunks) and fused_qkv_op (B5 16 times, B1 none); both agree
               with the plain attention path, in bf16 and in fp32; a
               profiled bf16 call of each must launch the attention body
               and no bf16 instantiation of the scalar
               fused_qkv_attention_kernel, and fused_qkv_op's must run B5's
               phase 2 on the grouped matmul's body and no bf16 outproj_kernel;
               then 64 windows of T = 730 (two
               years) through the same entry point in bf16, auto (8 B1
               eval) and fused_qkv_op (8 B5), each within the serving bound
               of the plain path
  6. serve_daemon - `python -m weathermodel_tpu_torch.cli.serve --daemon` as
               a process serving the same .pth through B5 (fused_qkv_op,
               --batch-size 256, --allow-reload): 8 client threads x 4
               requests x 32 windows, each answer held against the offline
               predictor's for the same windows; /stats must show 1024 rows
               coalesced into batches of more than 32 (p50/p95/p99 latency and
               windows/s printed); POST /reload of a second checkpoint, after
               which an answer matches the new weights; SIGTERM, after which
               the process must exit 0
  7. kernel_train - the fused QKV attention kernel's training form (B1
               train) and its backward kernel (B2) vs their plain versions at
               the training microbatch (B=288, T=365, H=576, 16 heads) in fp32
               and bf16, dropout 0.1 (the same seed on both sides) and 0; CUDA-
               event times of the kernel, the plain version and the library
               call (F.linear + scaled_dot_product_attention, forward; forward
               and backward for B2), naming the SDPA backend; the body's
               ptxas report for the training form and the backward body's
               (attention_bwd_wgmma_kernel: bf16 B2 and B3b) with its shared
               memory; bf16 B1 train's and B2's times beside the recorded
               ones (B2's on the scalar passes), and fp32 B2's on the FFMA
               body (csrc/attention_ffma.cuh) beside its scalar passes'
               recorded time, its bound and its share of it; B2 twice,
               bitwise equal, in both dtypes; B1 train (o and qkv) at the
               edge shapes, and B2 at the backward's edge shapes (the
               backward body's tile edges T = 1, 64, 65, 383, 384 at the
               four head dims, 365, its dispatch boundary 576/577 at hd 36
               and 832/833 at hd 20 and 28, then 600, 1024 at each head dim
               and 1536), dropout 0.1 and 0
  8. train   - a seeded synthetic chunk store written by the port's writer;
               `wm-pretrain-torch`'s run(args) trains WeatherBERT-large in
               bf16, --batch-size 576 --grad-accum 2, dropout 0.1, 2 epochs:
               16 launches of each training kernel per step and 8 of the eval
               form per validation batch, finite losses that fall; ms per
               step, samples/s, TFLOP/s and peak memory; a torch.profiler
               capture of one step, which fails unless B1 train launches the
               attention body and B2 the backward body, and no bf16 scalar
               fused_qkv_attention_kernel, bwd_dq_kernel or bwd_dkdv_kernel
               runs;
               one step of the kernel path against the plain attention path
               at 16 windows, dropout off, fp32 and bf16; per-layer remat: one
               fp32 step at 16 windows with dropout 0.1 from one generator
               seed, --remat against none (the loss and every gradient bitwise
               equal, B1 train launched twice as often, B2 as often), and one
               epoch of the same run with --remat (32 B1 train a step; ms a
               step, samples/s and peak memory beside the run without it)
  9. kernel_flash - the attention kernels on separate q, k, v, B3f and its
               backward B3b, vs their plain versions at WeatherFormer-small's
               batch (B=256, T=365, H=200, 10 heads), on the column slices of
               a packed projection as the model passes them, fp32 and bf16,
               dropout 0.1 (the same seed on both sides) and 0, B3f also on
               three separate tensors; CUDA-event
               times of the kernel, the plain version and SDPA (forward;
               forward and backward for B3b); a profile of each bf16 B3f
               call on slices and on tensors, both rates, which fails unless
               its wgmma body (attention_fwd_wgmma_kernel) runs and no bf16
               scalar flash_attention_kernel does; the forward and the
               backward bodies' ptxas reports (B3b's as its file compiles
               it) and shared memory, and bf16 B3f's and B3b's times beside
               the recorded ones on the scalar bodies; B3f and B3b twice,
               bitwise equal, in both dtypes; the fp32 FFMA bodies'
               (csrc/attention_ffma.cuh) ptxas report and shared memory, a
               profile of fp32 B3f (slices and tensors), B3b and B2 (at
               WeatherBERT-large's width) at both rates, which fails unless
               the FFMA bodies run and no fp32 scalar body does, and fp32
               B3f's and B3b's times at dropout 0.1 and 0 beside the scalar
               bodies' recorded ones, SDPA, the bound and the share of it,
               at B=256 T=365 and at the yield step's 64 x 364; both at the
               edge shapes (the bodies' tile edges and dispatch boundaries,
               the FFMA bodies' too), dropout 0.1 and 0
  10. train_former - `wm-pretrain-torch`'s run(args) with the JAX CLI's
               defaults (WeatherFormer-small, ELBO, beta 0.5, 10 masked
               features, --attention-impl auto) in bf16 at --batch-size 256,
               2 epochs, on the same synthetic store: 4 launches of B3f per
               training step and per validation batch, 4 of B3b per step,
               none of B1/B2; finite losses, the train loss falls; the same
               timings, profile (B3f's forward body and B3b's backward body
               required, their bf16 scalar kernels forbidden) and one-step
               comparison as phase 8, and phase 8's --remat step (8 B3f and
               4 B3b against 4 and 4)
  11. resume - the same run's fault tolerance at 3 epochs: (a)
               uninterrupted; (b) the same argv stopped by a real SIGTERM
               sent while step 3 of epoch 1 runs, which must return
               "preempted", leave a checkpoint with mid_epoch.batch_idx 3
               and restore the SIGTERM handler; (c) (b)'s workdir resumed
               with --resume-from-checkpoint, whose record's losses, best.pth
               and last checkpoint (parameters, Adam's moments and step) must
               equal (a)'s bitwise, with B3f's and B3b's launches over (b) and
               (c) equal to (a)'s; (d) in a child process, 2 epochs with
               WEATHERMODEL_PROFILE_DIR set, whose trace must name B3f's and
               B3b's bf16 bodies; (e) `--model mlp` for 2 epochs (finite
               losses that fall, no kernel launched). Prints the checkpoint's
               MB, the seconds the loop blocked on each background boundary
               save against its write's, the preemption save's seconds and the
               resume's fast-forward seconds
  12. yield  - `wm-yield-torch`'s run(args) with the JAX CLI's defaults
               (WeatherFormer-small, ELBO, beta 1e-4, batch 64, fp32,
               --attention-impl auto) and --country synthetic
               --n-train-years 15 --test-year 2016 --n-epochs 2
               --use-optimal-lr, from a seeded WeatherFormer-small .pth, on
               the synthetic Khaki frame of 1024 counties (T = 364, 10240
               training and 1024 test windows): 4 launches of B3f and B3b
               per training step (the LR range test's steps included) and 4
               of B3f per validation batch, none of B1/B2; finite losses,
               the train loss falls, a finite RMSE and R^2; ms per step,
               windows/s, the fold's seconds and peak memory; then the same
               run in bf16; a profiled fp32 step requiring B3f's and B3b's
               FFMA bodies and forbidding their fp32 scalar ones, with their
               share of device time, and a bf16 one
               requiring their wgmma bodies and forbidding their bf16 scalar
               kernels; one yield step of the kernel path against the plain
               path at 16 windows, dropout off, eps injected, fp32 and bf16
               (the bars of phase 8); `wm-cropnet-torch --crop-type Corn`
               with the CropNet defaults on the synthetic CropNet frame,
               which fails if the crop's result is None
  13. kernel_gmm - the grouped matmul B4 (forward, and with rhs^T as the
               backward's d_lhs) and its weight gradient B4t vs their plain
               versions at the MoE microbatch's shapes (S = 96 x 365 x 2 =
               70080 routed rows, E=8, K x N = 576 x 2304 and 2304 x 576),
               with the group sizes of a top-2 routing of seeded activations
               through a seeded router, in bf16 and fp32; then the edge cases
               (empty first/middle/last groups, boundaries inside a tile, S
               not a multiple of 128, tiny groups sharing a tile); CUDA-event
               times of the kernel, the plain version and the library
               yardstick (torch._grouped_mm where it takes the inputs, else
               one cuBLAS matmul per group); bf16 B4's mean (its four calls
               printed each) and B4t's beside their recorded times on the WMMA
               tiles
  14. train_moe - `wm-pretrain-torch`'s run(args) for the flagship MoE
               configuration: WeatherBERT-large, --moe-experts 8 --moe-top-k 2
               (ragged dispatch), bf16, --batch-size 288 --grad-accum 3,
               dropout 0.1, 2 epochs, on the same store: per step 96 launches
               of B4, 48 of B4t, 24 of B1 train and 24 of B2; per validation
               batch 16 of B4 and 8 of B1 eval; finite losses and moe_aux, the
               train loss falls; the same timings (TFLOP/s from the MoE
               analytic count), profile (the attention and backward bodies
               required, as in phase 8, and the grouped-matmul body's two
               kernels, with no bf16 gmm_kernel or tgmm_kernel of the WMMA
               tiles) and one-step comparison with the plain
               path (plain grouped matmuls, plain attention) as phase 8
  15. kernel_ffn - the bf16 wgmma bodies' (ffn_wgmma_kernel: B6f and B7;
               ffn_bwd_wgmma_kernel: B6b's row work) ptxas registers and
               spills and their shared memory; then the fused FFN +
               residual + LayerNorm B6f, its backward B6b and the fused FFN
               B7 (with and without its hidden output) vs their plain
               versions at the bench microbatch's shapes (M = 288 x 365 =
               105120 rows, H=576, F=2304) in bf16 and fp32, dropout 0.1 (the
               same seeds on both sides) and 0, then at the edge shapes
               H=200/F=800, H=48/F=192, H=576/F=2304 and H=640/F=2560 with M
               not a multiple of the 32-row or the 64-row block (1001, 333,
               65, 97); CUDA-event times of the kernel, the plain
               version and the yardstick (the port's "torch" FFN: F.linear,
               ReLU, F.linear, and for B6 the residual and F.layer_norm; its
               autograd backward for B6b); one profiled bf16 B6b call split
               into its row body, its weight-gradient products (the grouped
               matmul's body, expert_wgrad_wgmma_kernel<true>; no bf16
               wgrad_kernel of the WMMA tiles may run) and its ordered sums,
               the products beside their library pair (two torch.matmul and
               two column sums) and their bound, and B6b beside its recorded
               times
  16. kernel_maskgen - the keep-mask family at the FFN hidden site of the
               bench microbatch (M = 105120 rows, C = 2304, rate 0.1): B8
               (forward and backward) and B8m launched through their public
               functions `kernel_dropout` and `random_keep_mask` with the
               counts at 0 (they have no other path), then B9b, B9p, B8m and
               B8 (bf16 and fp32) held bitwise against their plain versions
               (B9p unpacked against B9b, B8 and its gradient against B8m's
               mask x the dtype-rounded scale x x or dy), keep rates within
               1e-3 of 0.9; CUDA-event times of the kernel, the plain version
               and the library call (bernoulli_ for the bool masks,
               F.dropout for B8, none for B9p) and both bounds (bytes, the
               hash's integer operations)
  17. probes - the ablation probes through the port's ablation scripts,
               `python -m weathermodel_tpu_torch.scripts.abl_headpack`'s and
               `.abl_gemm_probe`'s main() at the JAX scripts' full shapes
               with 5 timed steps: P1 and P2 (per-head and head-packed
               attention matmuls without softmax, q, k, v [224, 384, 576]
               bf16, 16 heads of 36) and P3 (the blocked GEMM at [70144, 576]
               x [576, 2304] bf16, five (bm, bn) arms, beside torch.matmul),
               with the counts at 0: 7 launches each of P1 and P2 (the
               cross-check, a warm-up, 5 timed) and 30 of P3 (5 arms x 6),
               none of the other kernels; then each kernel held against its
               plain version on the region it computes (P2: heads 0-14; P3:
               each arm's covered region) at 2^-6 of the plain output's
               largest magnitude, with at most 1% of the entries differing,
               and a profile of each bf16 P3 call, which fails unless it runs
               the grouped matmul's wgmma body (expert_gemm_wgmma_kernel) and
               no bf16 blocked_mm_kernel of the WMMA tiles; P3's time beside
               the recorded one on the tiles; a profile of each P1 and P2
               call, which fails unless it runs their wgmma body
               (headpack_wgmma_kernel) and no WMMA headpack_kernel; their
               times beside the ones recorded on that kernel, P1's share of
               its bound, P2's of its bound and of its literal products'
               time at the peak; the body's ptxas registers and spills (its
               four instantiations; it fails on spills or serialized
               wgmmas);
               CUDA-event times of the kernel, the plain
               version and the library call (two batched torch.matmul over
               the head views with S in bf16 for P1 and P2, torch.matmul for
               P3) and the bounds
  18. bench - `python -m weathermodel_tpu_torch.bench`'s run(env) at
               WeatherBERT-large, 2 x 288, bf16, dropout 0.1, for
               BENCH_FFN_IMPL torch, fused_ffn_ln and fused_ffn (each JSON
               line printed): per step 16 launches of B1 train and B2 in all
               three, of B6f and B6b with fused_ffn_ln, of B7 with fused_ffn;
               the torch FFN again under the dropout impls maskgen and
               maskgen_bool (ops.dropout.set_impl, as the JAX ablation
               scripts select them): 16 launches per step of B9p or B9b at
               the FFN hidden sites, none of the other kernels of the family
               (the sites with C = 576 take "auto"), and a torch.profiler
               step of maskgen_bool with B9b's and torch.rand's device time;
               BENCH_MODE=eval runs of the two fused impls (8 launches of B6f
               or B7, without its hidden output, per batch) and a
               BENCH_ATTENTION=fused_qkv_op eval run at batch 576 (8 launches
               of B5 per batch, none of B1); finite losses; a
               torch.profiler train and eval step of each fused impl, which
               fails unless bf16 B6f, B7 with h (train) and B7 without
               (eval) launch the wgmma body (ffn_wgmma_kernel), B6b its
               backward body (ffn_bwd_wgmma_kernel) and its weight gradients
               the grouped matmul's body (no bf16 wgrad_kernel), no bf16 row
               kernel (ffn_rows_kernel) runs, B1 (train and
               eval) launches the attention body (qkv_attention_wgmma_kernel)
               and no bf16 scalar fused_qkv_attention_kernel, and B2 (train)
               the backward body (attention_bwd_wgmma_kernel) and no bf16
               scalar pass; one step of each
               fused path against the plain path (plain attention and FFN) at 16
               windows, dropout off, fp32 and bf16
  19. serve_int8 (run after phase 6) - phase 5's checkpoint and 300
               windows through `wm-serve-torch` (bf16, --batch-size 256,
               auto: B1 eval) with --quantize int8, --quantize int8_static
               --calibrate-input (32 seeded windows) and int8_static with the
               attention out-projection quantized too (ops.quant.
               set_attn_out_quant, the WM_QUANT_ATTN_OUT switch), each called
               twice and timed the second time: windows/s beside the bf16
               serve's in the same phase and the relative RMS difference from
               its outputs, at most 5%; B1 eval's launches, 16 per call plus
               8 for the calibration pass's 32 windows; then
               int8_dense_static and int8_expert_einsum on the card against
               the same call on the CPU at K = 576 and 2304 (int8 codes equal,
               outputs bitwise equal), and int8_dense_static's time at the
               serving FFN's shape beside F.linear's and torch._int_mm's
  20. serve_moe_int8 (after 19) - a seeded WeatherBERT-large with 8 experts,
               top-2, served in bf16 through the ragged dispatch (16 B1 eval
               and 32 B4 launches per call) and then with --moe-experts 8
               --quantize int8_static --calibrate-input: the calibration's
               16 B4 launches (ragged, dropless statistics) and none in the
               int8 serving (sort layout); windows/s; the relative RMS
               difference from a bf16 predictor in the sort layout, at most
               5%, and from the bf16 ragged serve, printed with the share of
               routed assignments the sort layout's capacity drops
  21. train_moe_dispatch (after 14) - phase 14's configuration for one epoch
               with --moe-dispatch ragged, sort, scatter and sort
               --moe-remat: 24 launches of B1 train and of B2 per step and 8
               of B1 eval per validation batch, no B4 or B4t outside ragged;
               samples/s and peak GB of each above what is allocated at its
               start, after a garbage collection (remat must lower sort's);
               one step at 16 windows, dropout off, sort against scatter (loss
               and worst gradient within MOE_LAYOUT_TOL), and one step with
               dropout 0.1 from one generator seed, sort with --moe-remat
               against sort without: every gradient bitwise equal
  22. train_ep (after 21) - expert parallelism. (a) The grouped matmul's
               window forms, B4s (gmm_sharded: B4 and its d_lhs form) and B4ts
               (tgmm_sharded), at the routed rows of 288 seeded windows (S =
               210240, E = 8, K x N = 576 x 2304 and back) for every offset at
               e_loc = 4, 2 and 1, bf16 and fp32, each against its plain
               version (zeros outside the window) at the kernels' bars, the
               shards' sum against full B4/B4t (bitwise or within the bars,
               printed), each form's mean time beside full B4/B4t, its bound
               (the window's operations; its rows, weights and whole output
               in bytes) and torch._grouped_mm over the window. (b) The EP
               trainer: parallel/step_check.py under torchrun with 2 and then
               4 ranks pinned to cuda:0 (gloo; meshes 1 x 2 and 2 x 2) on
               WeatherBERT-large with 8 experts, top-2, ragged: one fp32 SGD
               step, dropout off, 4 windows, against the same step in this
               process (loss and aux to 1e-5 relative, each gradient to 1e-3
               in norm, updated parameters to 1e-6; 32 B4s and 16 B4ts a rank,
               no B4/B4t); at three input seeds the 2 x 2 step against a 2 x
               1 step (pure data parallelism in the two-rank job: the same 2
               windows a rank, so a route near a top-2 tie cannot flip
               between them) at those bars, and against one process
               (printed, at the bars for the first seed), then `wm-pretrain-torch --tensor-parallel 2` in
               bf16 at --batch-size 32 for 2 epochs on a small store: per rank
               32 B4s and 16 B4ts a step, 16 B4s a validation batch, none of
               B4/B4t, finite losses that fall; samples/s (not EP's rate: one
               card shared, gloo's host copies), peak memory and the stored
               parameter and Adam entries a rank (held to the sharding rules'
               blocks: the experts and the dense weights over 'model'). Sharded
               storage in the same two jobs, one fp32 step each, compared by
               digests of every gradient and updated parameter against the
               same mesh with only the experts split (bitwise, -0.0 = 0.0):
               --moe-dispatch sort's expert split with the dense split on
               1 x 2 (its pair differs in the dense split alone), --fsdp on
               2 x 1 (dense WeatherBERT-large) and --fsdp --tensor-parallel 2
               on 2 x 2 (the MoE), each rank's stored bytes printed beside one
               process's; the seconds of each part, and of each torchrun task
               on rank 0
  23. export (after serve_moe_int8) - `wm-export-torch --platforms cuda`
               (attention forced to the plain `torch` form) freezes phase 5's
               WeatherBERT-large .pth into torch.export bundles: bf16 at
               buckets 32 and 256, fp32 at 256; each bundle's
               ExportedPredictor against the live `--attention-impl torch`
               predictor on phase 5's 300 windows at the served-output bars
               (SERVE_TOL); a child process that loads the bf16 bundle with
               torch.export.load alone and must import nothing of
               weathermodel_tpu_torch, its answer equal to this process's;
               then serve_moe_int8's E=8 top-2 MoE checkpoint exported in
               bf16 at bucket 256: its program holds the op wm::gmm, serving
               it launches B4 (2 a layer a chunk, nothing else) and matches
               the live MoE predictor; MB, write and load seconds of each
               bundle
  24. serve_bundle (after 23) - `python -m weathermodel_tpu_torch.cli.serve
               --daemon --bundle` on the bf16 bundle with --allow-reload: the
               serve_daemon clients (8 x 4 x 32 windows) held against
               ExportedPredictor; POST /reload {"bundle": ...} of a bundle of
               serve_daemon's second checkpoint, after which an answer
               matches its predictor; a bundle of other buckets refused with
               400 naming them; windows/s and p50/p99 beside serve_daemon's;
               SIGTERM, exit 0
  25. train_cnn (after yield) - the CNN baselines: `wm-pretrain-torch
               --model weathercnn` 2 epochs on the store (masked MSE, fp32,
               falling finite losses, no kernel launched) and `wm-yield-torch
               --model cnnrnn` one fold on the yield phase's synthetic frame
               (cuDNN's LSTM), finite RMSE and R^2; ms a step and samples/s
  26. yield_baselines (after 25) - `wm-yield-torch --model gnnrnn` (one
               graph of 1024 counties x 7 years a step) and `--model chronos`
               (chronos-bolt-tiny from its seeded init, batch 64) with the
               yield phase's flags on its frame, fp32: finite losses that
               fall, finite RMSE and R^2, no kernel of the port launched; one
               step on the card against the CPU (TF32 off) within
               BASELINE_TOL; ms a step, graphs/s or windows/s, the fold's
               seconds and peak memory
With `--ep-cards N` (an even N of at least 2 cards) the script runs only device, build
and the EP comparison on separate cards: train_ep's fp32 step on an (N/2) x 2 mesh of
one card a rank (NCCL, which rank 0 must log) against one process, and
`wm-pretrain-torch --tensor-parallel 2` in bf16 at --batch-size 192 against the same
run in one process on one card (samples/s, peak memory, B4s/B4ts a rank).
The seconds each phase took are printed after the phases; the card's name
and power limit are printed by phase 1 and again before the kernels' JSON
record; the last line is {"ok": true, "device": {...}}.
"""

import functools
import gc
import io
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
N_WINDOWS, SEQ_LEN, N_FEATURES = 300, 365, 31
BATCH = 256
MODEL_SIZE = "large"
# kernel vs plain, same inputs: only the fp32 summation order differs; in
# bf16 that can flip a rounding of q/k/v or of a softmax weight (one bf16
# ulp is 2^-8 relative), hence the wider bf16 bound on O(1) outputs.
KERNEL_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-3),
              torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# and against each output's own scale: max|kernel - plain| <= SCALE_TOL x
# max|plain|. The kernel phases' outputs are far below 1 (a near-uniform
# softmax over 365 keys: |o| ~ 0.04 and |dq|, |dk| ~ 0.015 in kernel_flash),
# where KERNEL_TOL's atol alone would pass a kernel that scaled a gradient
# by 0.8. A flipped bf16 rounding moves an output by one ulp, at most 2^-7 of
# its value; fp32 sums in another order only (about 1e-6 of the largest).
SCALE_TOL = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6}
# served output, kernel path vs plain attention path, as (max|diff|, RMS of
# diff) over the RMS of the plain path's output. In bf16 the two paths round
# the QKV projection at different points (the kernel once after an fp32
# sum plus bias, the plain path as F.linear does), as the JAX package's
# pallas_qkv and xla paths do, and that propagates through 8 layers: on the
# CPU at 10 windows the two differ by 0.039 (max) and 0.0068 (RMS).
SERVE_TOL = {"bfloat16": (0.15, 2e-2), "float32": (1e-4, 1e-5)}
# training: the effective batch as 2 microbatches of 288 (the north-star
# configuration of bench.py:90-91), the reference's dropout rate
TRAIN_BATCH, GRAD_ACCUM, DROPOUT = 576, 2, 0.1
MICRO = TRAIN_BATCH // GRAD_ACCUM
# one step, kernel path vs plain attention path, same weights, batch and
# mask, dropout off: fp32 sums in another order only, so the loss agrees to
# 1e-5 relative and each parameter's gradient to 1e-3 in the L2 norm. Not
# entrywise: the key bias's gradient is zero in exact arithmetic (softmax
# ignores a per-row shift), so its entries are rounding noise. The first
# layers' weight gradients sum, over 16 x 365 rows, a gradient that came
# back through 8 layers: the plain path alone, on the card and on the CPU,
# differs by about 1e-4 there (printed beside the result). bf16 rounds the
# QKV projection at other points on the two paths (see SERVE_TOL).
STEP_WINDOWS = 16
STEP_TOL = {"float32": dict(loss=1e-5, grad=1e-3),
            "bfloat16": dict(loss=1e-2)}
# the flagship MoE configuration (BASELINE.md:836-915): WeatherBERT-large,
# 8 experts, top-2, the effective batch 288 as 3 microbatches of 96
MOE = dict(num_experts=8, moe_top_k=2)
MOE_BATCH, MOE_ACCUM = 288, 3
MOE_MICRO = MOE_BATCH // MOE_ACCUM
# WeatherFormer-small pretraining with the JAX CLI's defaults
# (weathermodel_tpu/cli/pretrain.py:29-56): batch 256, 10 masked features,
# beta 0.5
FORMER_SIZE, FORMER_BATCH = "small", 256
# the card's published peaks (NVIDIA H100 SXM data sheet): dense bf16
# tensor-core rate, fp32 rate outside the tensor cores, HBM bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12
# B5 with dropout on is checked at a smaller batch: its plain version builds
# the int64 keep-mask of [B, 16, 365, 365]
OUTPROJ_DROPOUT_BATCH = 32
# the bf16 body of B1 and of B5's first phase (csrc/attention_hopper.cuh), and
# the scalar body's bf16 instantiation, which no bf16 profile may show
ATTN_BODY = "qkv_attention_wgmma_kernel"
ATTN_SCALAR_BF16 = "fused_qkv_attention_kernel<__nv_bfloat16"
# the bf16 body of B2 and B3b (csrc/attention_bwd_hopper.cuh), and the scalar
# passes' bf16 instantiations, which no bf16 profile at T = 365 may show
ATTN_BWD_BODY = "attention_bwd_wgmma_kernel"
ATTN_BWD_SCALAR_BF16 = ("bwd_dq_kernel<__nv_bfloat16",
                        "bwd_dkdv_kernel<__nv_bfloat16")
# the bf16 body of B4 and B4t (csrc/gmm_hopper.cuh), and the WMMA tiles' bf16
# instantiations, which the MoE profile may not show
GMM_BODY, TGMM_BODY = "expert_gemm_wgmma_kernel", "expert_wgrad_wgmma_kernel"
GMM_TILES_BF16 = ("gmm_kernel<__nv_bfloat16", "tgmm_kernel<__nv_bfloat16")
# the grouped matmul body's instantiations for bf16 B5's phase 2 (B4's
# transposed-weight form with a bias) and B6b's weight-gradient products (B4t's
# with fp32 partial sums), and the WMMA tiles' bf16 kernels they replaced,
# which no profile may show
OUTPROJ_BODY = f"{GMM_BODY}<true, true>"
WGRAD_BODY = f"{TGMM_BODY}<true>"
OUTPROJ_TILES_BF16 = "outproj_kernel<__nv_bfloat16"
WGRAD_TILES_BF16 = "wgrad_kernel<__nv_bfloat16"
# bf16 B6b at the bench microbatch and all of it but its row body (the WMMA
# tiles' weight-gradient passes and the ordered sums, profiled), and bf16 B5
# at B = 256, before both moved onto that body (PERF.md §6; H100 80GB
# HBM3, 700 W), printed beside this run's
WMMA_B6B_MS = {"B6b": 15.231, "passes": 8.714}
WMMA_B5_MS = 1.877
# bf16 B4 (mean of a MoE layer's four calls) and B4t (of two) on the WMMA
# tiles before their wgmma body (PERF.md §6; H100 80GB HBM3, 700 W), printed
# beside this run's
WMMA_GMM_MS = {"B4": 1.891, "B4t": 2.194}
# the bf16 body of B3f (csrc/flash_attention_hopper.cuh), and the scalar
# body's bf16 instantiation, which no bf16 profile at T = 365 may show
FLASH_BODY = "attention_fwd_wgmma_kernel"
FLASH_SCALAR_BF16 = "flash_attention_kernel<__nv_bfloat16"
# P3's bf16 instantiation of the WMMA tiles, which its profile may not show
# (bf16 P3 runs GMM_BODY as one group)
BLOCKED_MM_TILES_BF16 = "blocked_mm_kernel<__nv_bfloat16"
# bf16 B3f (B = 256, T = 365, dropout 0.1) on the scalar body and bf16 P3 (its
# (512, 1152) arm) on the WMMA tiles before their wgmma bodies (PERF.md §6;
# H100 80GB HBM3, 700 W), printed beside this run's
SCALAR_FWD_MS = {"B3f": 4.159}
WMMA_P3_MS = 1.7006
# P1 and P2's wgmma body (csrc/headpack_hopper.cuh), which their profiles
# must show, and the WMMA kernel it replaced, which they may not; that
# kernel's times at the probe's shape (PERF.md §6; H100 80GB HBM3, 700 W),
# printed beside this run's
HEADPACK_BODY = "headpack_wgmma_kernel"
HEADPACK_WMMA = "headpack_kernel"
WMMA_HEADPACK_MS = {"P1": 1.0661, "P2": 2.0242}
# (B, T, H, heads) at the bf16 body's 64-row tile edges (T = 1, 64, 65, 383,
# 384), one at each head dim, then the longest T the fp32 body keeps in
# shared memory at hd 36 (453) and the bf16 body's resident K^T and V^T
# (512); past them the rows stream from a device workspace: T = 513, 730
# (two years of daily windows) and 1024 at each head dim, and the kernels'
# limit MAX_CONTEXT (1536)
ATTN_EDGE_SHAPES = [(4, 1, 576, 16), (4, 64, 336, 12), (4, 65, 200, 10),
                    (4, 383, 48, 4), (4, 384, 576, 16), (2, 453, 576, 16),
                    (1, 512, 576, 16), (1, 513, 576, 16), (2, 730, 576, 16),
                    (1, 1024, 576, 16), (1, 1024, 336, 12),
                    (1, 1024, 200, 10), (1, 1024, 48, 4), (1, 1536, 576, 16)]
# the backward kernels' and B3f's edge shapes: the bf16 bodies' 64-row tile
# edges (T = 1, 64, 65, 383, 384), one at each head dim; T = 365; the backward
# body's dispatch boundary, the largest T it keeps on chip and one more (576
# and 577 at hd 36, 832 and 833 at hd 20 and 28), past which bf16 runs the
# scalar passes; the forward body's (768 and 769 at hd 36, 1152 and 1153 at
# hd 20), past which bf16 B3f runs its scalar body; past the rows the scalar
# passes keep in shared memory (about 530 at hd 36), each head dim at 1024;
# the limit at hd 36 and at hd 12 (the bf16 bodies' own there); the fp32
# FFMA bodies' dispatch boundaries, past which fp32 runs the scalar bodies:
# the backward's 760/761 (hd 36), 968/969 (hd 28) and 1320/1321 (hd 20), the
# forward's 800/801, 1032/1033 and 1448/1449
ATTN_BWD_EDGE_SHAPES = [(2, 1, 576, 16), (2, 64, 336, 12), (2, 65, 200, 10),
                        (2, 383, 48, 4), (2, 384, 576, 16), (2, 365, 576, 16),
                        (1, 576, 576, 16), (1, 577, 576, 16),
                        (1, 832, 200, 10), (1, 833, 336, 12),
                        (1, 768, 576, 16), (1, 769, 576, 16),
                        (1, 1152, 200, 10), (1, 1153, 200, 10),
                        (1, 600, 576, 16), (1, 1024, 576, 16),
                        (1, 1024, 336, 12), (1, 1024, 200, 10),
                        (1, 1024, 48, 4), (1, 1536, 576, 16),
                        (1, 1536, 48, 4), (1, 760, 576, 16),
                        (1, 761, 576, 16), (1, 968, 336, 12),
                        (1, 969, 336, 12), (1, 1320, 200, 10),
                        (1, 1321, 200, 10), (1, 800, 576, 16),
                        (1, 801, 576, 16), (1, 1032, 336, 12),
                        (1, 1033, 336, 12), (1, 1448, 200, 10),
                        (1, 1449, 200, 10)]
# the bf16 times at T = 365 recorded for the attention body before its long-T
# path (B1 eval and B5 at B = 256, B1 train at 288, dropout 0.1; PERF.md §6,
# H100 80GB HBM3, 700 W), printed beside this run's: the short-T path must not
# move
SHORT_T_MS = {"B1 eval": 1.258, "B1 train": 2.073, "B5": 1.914}
# the bf16 times of B2 (B = 288) and B3b (B = 256) at T = 365, dropout 0.1, on
# the scalar passes before their wgmma body (PERF.md §6; H100 80GB
# HBM3, 700 W), printed beside this run's
SCALAR_BWD_MS = {"B2": 34.649, "B3b": 15.594}
# fp32 B3f and B3b (B = 256, T = 365, dropout 0.1) and fp32 B2 (B = 288) on
# the scalar bodies before the FFMA bodies (PERF.md §6; H100 80GB HBM3,
# 700 W), printed beside this run's
SCALAR_FP32_MS = {"B3f": 4.134, "B3b": 15.430, "B2": 34.662}
# WeatherBERT-large served on windows of two years (T = 730), the length
# `wm-serve-torch` takes from its input file
LONG_SEQ_LEN, LONG_WINDOWS = 730, 64
# the online daemon: client threads x requests each x windows a request, and
# the seconds it may take to answer /healthz and to exit after SIGTERM
DAEMON_CLIENTS, DAEMON_REQUESTS, DAEMON_WINDOWS = 8, 4, 32
DAEMON_START_S, DAEMON_STOP_S = 180, 60


def train_flops_per_sample(cfg, out_dim=None) -> float:
    """Matmul FLOPs per sample of one training step (forward + backward) of
    the encoder with an output head of `out_dim` (default cfg.output_dim;
    2F for the WeatherFormer's (mu, log var)): the bench's analytic count
    (77.2 GFLOP for WeatherBERT-large, T=365; with 8 experts, top-2: 123.8)."""
    from weathermodel_tpu_torch.bench import analytic_flops_per_sample

    return analytic_flops_per_sample(cfg, "train", out_dim)


def _bound(flops: float, nbytes: float, dtype):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of the operations at the peak rate of `dtype` and the bytes
    at the memory rate (each input read once, each output written once)."""
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _attention_bound(b, t, h, nh, dtype, train: bool):
    """B1's bound: the projection and the attention products; it reads x,
    w and b and writes o (the training form also writes qkv)."""
    flops = 2.0 * b * t * h * 3 * h + 4.0 * b * nh * t * t * (h // nh)
    elems = 2 * b * t * h + 3 * h * h + 3 * h + (3 * b * t * h if train else 0)
    return _bound(flops, elems * dtype.itemsize, dtype)


def _outproj_bound(b, t, h, nh, dtype):
    """B5's bound: B1's projection and attention products and the
    out-projection's 2 B T H^2; it reads x, w, b, wo and bo and writes y."""
    flops = (2.0 * b * t * h * 3 * h + 4.0 * b * nh * t * t * (h // nh)
             + 2.0 * b * t * h * h)
    elems = 2 * b * t * h + 4 * h * h + 4 * h
    return _bound(flops, elems * dtype.itemsize, dtype)


def _flash_bound(b, t, h, nh, dtype):
    """B3f's bound: two T x T x hd products per (row, head); it reads q, k
    and v and writes o."""
    return _bound(4.0 * b * nh * t * t * (h // nh), 4 * b * t * h *
                  dtype.itemsize, dtype)


def _bwd_bound(b, t, h, nh, dtype):
    """B2's and B3b's bound: five T x T x hd products per (row, head); it
    reads q, k, v and dO and writes dq, dk and dv."""
    return _bound(5 * 2.0 * b * nh * t * t * (h // nh),
                  7 * b * t * h * dtype.itemsize, dtype)


def _heads(a, nh):
    b, t, h = a.shape
    return a.view(b, t, nh, h // nh).transpose(1, 2)


def _library_attention(x, w, b, nh, dropout_p=0.0):
    """The library call beside B1: F.linear for the projection, then
    scaled_dot_product_attention (timed only, never the port's path)."""
    q, k, v = (_heads(a, nh) for a in F.linear(x, w, b).chunk(3, dim=-1))
    return F.scaled_dot_product_attention(q, k, v, dropout_p=dropout_p)


def _library_attention_outproj(x, w, b, wo, bo, nh):
    """The library call beside B5: F.linear, scaled_dot_product_attention and
    F.linear (timed only, never the port's path)."""
    o = _library_attention(x, w, b, nh).transpose(1, 2).reshape(x.shape)
    return F.linear(o, wo, bo)


def _sdpa_backend(q, k, v):
    """The first of SDPA's backends, in the order flash, memory-efficient,
    cuDNN, math, that takes these inputs (forward and backward)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (a.detach().requires_grad_() for a in (q, k, v))
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # each refusal warns
                F.scaled_dot_product_attention(q, k, v).sum().backward()
            return name.lower()
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes these inputs")


def _check_kernel(what, got, want, dtype):
    """A kernel's output against its plain version's, at KERNEL_TOL
    entrywise and at SCALE_TOL of the plain output's largest magnitude:
    (max|diff|, RMS of the plain output, its max magnitude)."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **KERNEL_TOL[dtype],
                               msg=lambda m: f"{what}: {m}")
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    if not err <= SCALE_TOL[dtype] * peak:
        raise AssertionError(f"{what}: max|kernel - plain| {err:.3g} exceeds "
                             f"{SCALE_TOL[dtype]:.3g} x max|plain| {peak:.3g}")
    return err, want.square().mean().sqrt().item(), peak


def _errs_text(errs):
    return ", ".join(f"{name} {err:.3g} (RMS {rms:.3g}, max {peak:.3g})"
                     for name, (err, rms, peak) in errs.items())


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"count {torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def phase_build():
    from weathermodel_tpu_torch.kernels import build

    built = build.load_library()
    report = [ln.strip() for ln in built.ptxas_log.splitlines()
              if "Used" in ln or "spill" in ln]
    print(f"build: {built.seconds:.1f} s nvcc -> {built.path.name}; ptxas: "
          + " | ".join(report), flush=True)
    print("build: " + _gmm_body_report(built), flush=True)


def _gmm_body_report(built):
    """The bf16 grouped-matmul body's ptxas report (registers and spills of
    each instantiation: B4's expert_gemm_wgmma_kernel<kTransB, kBias> at
    <0, 0> and <1, 0> (P3's too), B5's phase 2 at <1, 1>; B4t's
    expert_wgrad_wgmma_kernel<kPartials> at <0>, B6b's weight gradients at
    <1>) and its dynamic shared memory a block; fails on a serialized-wgmma
    warning (C7512) in any of them."""
    import re

    lines = built.ptxas_log.splitlines()
    serialized = [ln for ln in lines if "C7512" in ln and
                  (GMM_BODY in ln or TGMM_BODY in ln)]
    if serialized:
        raise AssertionError(f"the grouped-matmul body's wgmmas are "
                             f"serialized: {serialized}")
    report = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*?(" + GMM_BODY + "|" +
                      TGMM_BODY + r")I((?:Lb\d+E)+)E", line)
        if m is None:
            continue
        block = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        args = ", ".join(re.findall(r"Lb(\d+)E", m.group(2)))
        report[f"{m.group(1)}<{args}>"] = (
            f"{regs.group(1) if regs else '?'} registers, spill "
            f"{'/'.join(spill.groups()) if spill else '?'} B")
    want = {f"{GMM_BODY}<0, 0>", f"{GMM_BODY}<1, 0>", f"{GMM_BODY}<1, 1>",
            f"{TGMM_BODY}<0>", f"{TGMM_BODY}<1>"}
    if set(report) != want:
        raise AssertionError(f"ptxas reported {sorted(report)} for the "
                             f"grouped-matmul body, not {sorted(want)}")
    return ("grouped-matmul body ptxas: "
            + "; ".join(f"{k}: {v}" for k, v in sorted(report.items()))
            + f"; dynamic shared memory a block "
              f"{built.lib.wm_gmm_wgmma_smem()} B")


def _cuda_ms(fn, iters=5, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _attention_inputs(b, t, h, seed):
    """x N(0, 1), w and b U(+-1/sqrt(h)) for B1 and B5, in fp32 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    bound = 1.0 / h ** 0.5
    x = torch.randn(b, t, h, device="cuda", generator=g)
    w = (torch.rand(3 * h, h, device="cuda", generator=g) * 2 - 1) * bound
    bias = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) * bound
    return x, w, bias


def _attention_edges(what, run, plain, seed, shapes=ATTN_EDGE_SHAPES):
    """`run` and `plain` (each taking x, w, b, heads in one dtype and returning
    a tuple of outputs) on `shapes`, fp32 and bf16: the number of cases and
    the largest max|kernel - plain|."""
    errs = []
    for b, t, h, nh in shapes:
        x, w, bias = _attention_inputs(b, t, h, seed)
        for dtype in (torch.float32, torch.bfloat16):
            args = (x.to(dtype), w.to(dtype), bias.to(dtype), nh)
            for i, (got, want) in enumerate(zip(run(*args), plain(*args))):
                errs.append(_check_kernel(
                    f"{what} {i} {dtype} {(b, t, h, nh)}", got, want,
                    dtype)[0])
        del x, w, bias
        torch.cuda.empty_cache()
    return (f"edge shapes (B, T, H, heads) {shapes}, fp32 and bf16: "
            f"{len(errs)} outputs, max|err| {max(errs):.3g}")


def _attention_body_report(forms):
    """The bf16 attention body's ptxas report for the instantiations whose
    (kTrain, kEmitQkv) is in `forms`, short-T (kStream 0) and long-T (1),
    and its dynamic shared memory a block at T = 365, at the longest T whose
    K^T and V^T stay resident (512 at hd 36) and at MAX_CONTEXT, by head
    dim."""
    import re

    from weathermodel_tpu_torch.kernels import build
    from weathermodel_tpu_torch.ops.attention import MAX_CONTEXT

    built = build.load_library()
    lines = built.ptxas_log.splitlines()
    report = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*" + ATTN_BODY +
                      r"ILi(\d+)ELb(\d)ELb(\d)ELb(\d)E", line)
        if m is None or (int(m.group(2)), int(m.group(3))) not in forms:
            continue
        block = []
        for nxt in lines[i + 1:i + 6]:
            if "Compiling entry" in nxt:
                break
            block.append(nxt)
        block = " ".join(block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        report.append(f"<{', '.join(m.groups())}>: "
                      f"{regs.group(1) if regs else '?'} registers, spill "
                      f"{'/'.join(spill.groups()) if spill else '?'} B")
    smem_at = built.lib.wm_qkv_attention_wgmma_smem
    smem = {hd: tuple(smem_at(hd, t) for t in (SEQ_LEN, 512, MAX_CONTEXT))
            for hd in (12, 20, 28, 36)}
    return (f"{ATTN_BODY}<hd, kTrain, kEmitQkv, kStream> ptxas: "
            f"{'; '.join(report)}; dynamic shared memory a block by hd at "
            f"T = ({SEQ_LEN}, 512, {MAX_CONTEXT}): {smem} B")


def _bwd_body_report(source):
    """The bf16 backward body's ptxas report as compiled in `source` (B2's
    fused_qkv_attention_bwd or B3b's flash_attention_bwd), by head dim and
    kBits (the dropout keep bits kept in shared memory), and its dynamic
    shared memory a block without the bits at T = 365, at the largest T it
    keeps on chip (0 past it: the scalar passes run) and at MAX_CONTEXT."""
    import re

    from weathermodel_tpu_torch.kernels import build
    from weathermodel_tpu_torch.ops.attention import MAX_CONTEXT

    built = build.load_library()
    lines = built.ptxas_log.splitlines()
    report = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*" + source + r"_cu.*" +
                      ATTN_BWD_BODY + r"ILi(\d+)ELb(\d)E", line)
        if m is None:
            continue
        block = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        report.append(f"<{m.group(1)}, {m.group(2)}>: "
                      f"{regs.group(1) if regs else '?'} "
                      f"registers, spill "
                      f"{'/'.join(spill.groups()) if spill else '?'} B")
    smem_at = built.lib.wm_attention_bwd_wgmma_smem
    resident = {hd: max(t for t in range(1, MAX_CONTEXT + 1)
                        if smem_at(hd, t) > 0) for hd in (12, 20, 28, 36)}
    smem = {hd: (smem_at(hd, SEQ_LEN), (top, smem_at(hd, top)),
                 smem_at(hd, MAX_CONTEXT)) for hd, top in resident.items()}
    return (f"{ATTN_BWD_BODY}<hd, kBits> ({source}) ptxas: "
            f"{'; '.join(report)}; "
            f"dynamic shared memory a block by hd at T = {SEQ_LEN}, (its "
            f"largest T, there) and {MAX_CONTEXT}: {smem} B")


def _fwd_body_report():
    """bf16 B3f's body's ptxas report (registers and spills by head dim) and
    its dynamic shared memory a block at T = 365, at
    the largest T it keeps on chip (0 past it: the scalar body runs) and at
    MAX_CONTEXT."""
    import re

    from weathermodel_tpu_torch.kernels import build
    from weathermodel_tpu_torch.ops.attention import MAX_CONTEXT

    built = build.load_library()
    lines = built.ptxas_log.splitlines()
    report = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*" + FLASH_BODY +
                      r"ILi(\d+)EE", line)
        if m is None:
            continue
        block = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        report.append(f"<{m.group(1)}>: "
                      f"{regs.group(1) if regs else '?'} registers, spill "
                      f"{'/'.join(spill.groups()) if spill else '?'} B")
    if len(report) != 4:
        raise AssertionError(f"ptxas reported {report} for {FLASH_BODY}, not "
                             f"its 4 head dims")
    smem_at = built.lib.wm_flash_attention_wgmma_smem
    resident = {hd: max(t for t in range(1, MAX_CONTEXT + 1)
                        if smem_at(hd, t) > 0) for hd in (12, 20, 28, 36)}
    smem = {hd: (smem_at(hd, SEQ_LEN), (top, smem_at(hd, top)),
                 smem_at(hd, MAX_CONTEXT)) for hd, top in resident.items()}
    return (f"{FLASH_BODY}<hd> ptxas: {'; '.join(report)}; "
            f"dynamic shared memory a block by hd at T = {SEQ_LEN}, (its "
            f"largest T, there) and {MAX_CONTEXT}: {smem} B")


def _ffma_body_report():
    """The fp32 FFMA bodies' ptxas report (registers and spills of each
    kernel by head dim and dropout) and their dynamic shared memory a block
    at T = 365, at the largest T they take (0 past it: the scalar bodies
    run) and at MAX_CONTEXT, by head dim."""
    import re

    from weathermodel_tpu_torch.kernels import build
    from weathermodel_tpu_torch.ops.attention import MAX_CONTEXT

    built = build.load_library()
    lines = built.ptxas_log.splitlines()
    report = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*(attention_(?:fwd|bwd)_"
                      r"ffma_\w*?kernel)ILi(\d+)ELb([01])EE", line)
        if m is None or m.groups() in report:  # B2's and B3b's files each
            continue                            # compile the backward
        block = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        spilled = "/".join(spill.groups()) if spill else "?"
        report[m.groups()] = (f"{regs.group(1) if regs else '?'} registers, "
                              f"spill {spilled} B")
    if len(report) != 24:
        raise AssertionError(f"ptxas reported {sorted(report)} for the FFMA "
                             f"bodies, not their 3 kernels x 4 head dims x 2")
    text = "; ".join(f"{name}<{hd}, {drop}>: {r}" for (name, hd, drop), r in
                     sorted(report.items()))
    smem = {}
    for label, smem_at in (("fwd", built.lib.wm_flash_attention_ffma_smem),
                           ("bwd", built.lib.wm_attention_bwd_ffma_smem)):
        top = {hd: max(t for t in range(1, MAX_CONTEXT + 1)
                       if smem_at(hd, t) > 0) for hd in (12, 20, 28, 36)}
        smem[label] = {hd: (smem_at(hd, SEQ_LEN), (t, smem_at(hd, t)),
                            smem_at(hd, MAX_CONTEXT))
                       for hd, t in top.items()}
    return (f"FFMA bodies (attention_ffma.cuh) ptxas: {text}; dynamic shared "
            f"memory a block by hd at T = {SEQ_LEN}, (the largest T, there) "
            f"and {MAX_CONTEXT}: {smem} B")


def _check_kernel_names(what, keys, require=(), forbid=()):
    """Fails unless each substring in `require` is in some kernel's name and
    none in `forbid` is."""
    missing = [sub for sub in require if not any(sub in k for k in keys)]
    banned = [k for k in keys if any(sub in k for sub in forbid)]
    if missing or banned:
        raise AssertionError(f"{what}: no kernel holds {missing}, or "
                             f"{banned} launched (kernels: {keys})")


def _profiled(fn):
    """torch.profiler's device kernels over one call of fn."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return _kernel_events(prof)


def phase_kernel():
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_reference,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model_config_for_size(MODEL_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    x, w, b = _attention_inputs(BATCH, SEQ_LEN, h, SEED)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), w.to(dtype), b.to(dtype), nh)
        out = fused_qkv_attention(*args)
        ref = fused_qkv_attention_reference(*args)
        torch.cuda.synchronize()
        err, rms, peak = _check_kernel(f"o {dtype}", out, ref, dtype)
        bound_ms, bound_by = _attention_bound(BATCH, SEQ_LEN, h, nh, dtype,
                                              train=False)
        results[dtype] = dict(
            max_abs_err=err, errs=_errs_text({"o": (err, rms, peak)}),
            ms=_cuda_ms(lambda: fused_qkv_attention(*args)),
            plain_ms=_cuda_ms(lambda: fused_qkv_attention_reference(*args)),
            library_ms=_cuda_ms(lambda: _library_attention(*args)),
            bound_ms=bound_ms, bound_by=bound_by)
    print("kernel: " + _attention_body_report({(0, 0)}), flush=True)
    print("kernel: fused_qkv_attention B=%d T=%d H=%d heads=%d | " % (
        BATCH, SEQ_LEN, h, nh) + " | ".join(
        f"{str(d).split('.')[1]}: max|err| {r['errs']} (tol {KERNEL_TOL[d]}"
        f", {SCALE_TOL[d]:.3g} x max), kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, F.linear+SDPA {r['library_ms']:.3f} ms, "
        f"bound {r['bound_ms']:.3f} ms by {r['bound_by']}"
        for d, r in results.items()), flush=True)
    print(f"kernel: bf16 B1 eval at T={SEQ_LEN} "
          f"{results[torch.bfloat16]['ms']:.3f} ms (recorded: "
          f"{SHORT_T_MS['B1 eval']} ms)", flush=True)
    print("kernel: B1 eval " + _attention_edges(
        "B1 eval o", lambda *a: (fused_qkv_attention(*a),),
        lambda *a: (fused_qkv_attention_reference(*a),), SEED + 20),
        flush=True)
    return results[torch.bfloat16]


def phase_kernel_outproj():
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_outproj,
        fused_qkv_attention_outproj_reference,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    bound = 1.0 / h ** 0.5

    def uniform(*shape):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) * bound

    x = torch.randn(BATCH, SEQ_LEN, h, device="cuda", generator=g)
    params = (uniform(3 * h, h), uniform(3 * h), uniform(h, h), uniform(h))
    seed = 20260105
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        args = (x.to(dtype), *(a.to(dtype) for a in params))
        errs = {"y": _check_kernel(
            f"B5 y {dtype}", fused_qkv_attention_outproj(*args, nh),
            fused_qkv_attention_outproj_reference(*args, nh), dtype)}
        small = (args[0][:OUTPROJ_DROPOUT_BATCH], *args[1:])
        errs[f"y dropout {DROPOUT} B={OUTPROJ_DROPOUT_BATCH}"] = _check_kernel(
            f"B5 y {dtype} dropout {DROPOUT}",
            fused_qkv_attention_outproj(*small, nh, DROPOUT, seed),
            fused_qkv_attention_outproj_reference(*small, nh, DROPOUT, seed),
            dtype)
        torch.cuda.empty_cache()
        bound_ms, bound_by = _outproj_bound(BATCH, SEQ_LEN, h, nh, dtype)
        results[dtype] = dict(
            max_abs_err=errs["y"][0], errs=_errs_text(errs),
            ms=_cuda_ms(lambda: fused_qkv_attention_outproj(*args, nh)),
            plain_ms=_cuda_ms(lambda: fused_qkv_attention_outproj_reference(
                *args, nh)),
            library_ms=_cuda_ms(lambda: _library_attention_outproj(*args,
                                                                   nh)),
            b1_ms=_cuda_ms(lambda: F.linear(
                fused_qkv_attention(*args[:3], nh), args[3], args[4])),
            bound_ms=bound_ms, bound_by=bound_by)
    # phase 1 (the attention body) and phase 2 (the grouped matmul's body
    # with its bias) of bf16 calls, by the profiler's device time a call;
    # phase 2 beside its library call on an o of the same shape and its bound
    args = (x.to(torch.bfloat16), *(a.to(torch.bfloat16) for a in params))
    reps = 5
    events = _profiled(lambda: [fused_qkv_attention_outproj(*args, nh)
                                for _ in range(reps)])
    _check_kernel_names("B5 bf16", [e.key for e in events],
                        (ATTN_BODY, OUTPROJ_BODY),
                        (ATTN_SCALAR_BF16, OUTPROJ_TILES_BF16))
    split = {name: sum(_device_ms(e) for e in events if sub in e.key) / reps
             for name, sub in (("phase 1", ATTN_BODY),
                               ("phase 2", OUTPROJ_BODY))}
    results[torch.bfloat16]["phase2_share"] = split["phase 2"] / sum(
        split.values())
    o = fused_qkv_attention(*args[:3], nh)
    linear_ms = _cuda_ms(lambda: F.linear(o, args[3], args[4]))
    m = BATCH * SEQ_LEN
    phase2_bound = _bound(2.0 * m * h * h, (2 * m * h + h * h + h) * 2,
                          torch.bfloat16)
    del o
    print("kernel_outproj: " + _attention_body_report({(0, 0), (1, 0)}),
          flush=True)
    print("kernel_outproj: fused_qkv_attention_outproj B=%d T=%d H=%d "
          "heads=%d | " % (BATCH, SEQ_LEN, h, nh) + " | ".join(
              f"{str(d).split('.')[1]}: max|err| {r['errs']} (tol "
              f"{KERNEL_TOL[d]}, {SCALE_TOL[d]:.3g} x max), kernel "
              f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
              f"F.linear+SDPA+F.linear {r['library_ms']:.3f} ms, B1 eval + "
              f"F.linear {r['b1_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
              f"{r['bound_by']}" for d, r in results.items()), flush=True)
    share = results[torch.bfloat16]["phase2_share"]
    print(f"kernel_outproj: bf16 B5 by phase (profiled device ms a call, "
          f"{reps} calls): {split}, phase 2 {share:.3f} of the call, on "
          f"{OUTPROJ_BODY} (no {OUTPROJ_TILES_BF16}); phase 2's library call "
          f"F.linear(o, wo, bo) {linear_ms:.4f} ms, bound "
          f"{phase2_bound[0]:.4f} ms by {phase2_bound[1]}; B5 at T="
          f"{SEQ_LEN} {results[torch.bfloat16]['ms']:.3f} ms (recorded: "
          f"{SHORT_T_MS['B5']} ms with phase 1 on the wgmma body, "
          f"{WMMA_B5_MS} ms with phase 2 on the WMMA tiles)", flush=True)
    for rate in (0.0, DROPOUT):
        print(f"kernel_outproj: B5 dropout {rate} " + _attention_edges(
            "B5 y", lambda *a: (fused_qkv_attention_outproj(
                *a[:3], *_outproj_weights(a[0]), a[3], rate, seed),),
            lambda *a: (fused_qkv_attention_outproj_reference(
                *a[:3], *_outproj_weights(a[0]), a[3], rate, seed),),
            SEED + 21), flush=True)
    return results[torch.bfloat16]


def _outproj_weights(x):
    """wo [H, H] and bo [H] for B5's edge shapes: U(+-1/sqrt(H)) from a seed,
    in x's dtype (the same for the kernel and its plain version)."""
    h = x.shape[-1]
    g = torch.Generator(device="cuda").manual_seed(SEED + 22)
    wo = (torch.rand(h, h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
    bo = (torch.rand(h, device="cuda", generator=g) * 2 - 1) / h ** 0.5
    return wo.to(x.dtype), bo.to(x.dtype)


def _windows(rng, n, t=SEQ_LEN):
    """n seeded windows of T = t with every input of the request schema."""
    return dict(
        weather=rng.standard_normal((n, t, N_FEATURES), dtype=np.float32),
        coords=np.stack([rng.uniform(-60, 60, n), rng.uniform(-180, 180, n)],
                        axis=-1).astype(np.float32),
        year=(rng.integers(1984, 2002, (n, 1)) + np.arange(t) / t
              ).astype(np.float32),
        interval=np.full((n, 1), 1.0, np.float32),
        mask=rng.random((n, t, N_FEATURES)) < 0.15)


def _write_checkpoint(path: Path, seed: int):
    from weathermodel_tpu_torch.models.weatherbert import WeatherBERT
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    model = WeatherBERT(model_config_for_size(MODEL_SIZE, max_len=SEQ_LEN))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), path)


def _write_inputs(tmp: Path):
    _write_checkpoint(tmp / "weatherbert_large.pth", SEED)
    np.savez(tmp / "windows.npz",
             **_windows(np.random.default_rng(SEED), N_WINDOWS))
    np.savez(tmp / f"windows_{LONG_SEQ_LEN}.npz",
             **_windows(np.random.default_rng(SEED + 1), LONG_WINDOWS,
                        LONG_SEQ_LEN))


def _serve(tmp: Path, impl: str, dtype: str, windows: str = "windows"):
    from weathermodel_tpu_torch.cli import serve

    out_path = tmp / f"out_{windows}_{impl}_{dtype}.npz"
    args = serve.build_parser().parse_args([
        "--checkpoint", str(tmp / "weatherbert_large.pth"),
        "--model", "weatherbert", "--model-size", MODEL_SIZE,
        "--input", str(tmp / f"{windows}.npz"), "--output", str(out_path),
        "--batch-size", str(BATCH), "--compute-dtype", dtype,
        "--attention-impl", impl, "--device", "cuda"])
    t0 = time.perf_counter()
    res = serve.run(args)
    wall = time.perf_counter() - t0
    with np.load(out_path) as z:
        out = z["output"]
    return out, res["predict_s"], wall


def _serve_err(got, want):
    """(max, RMS) of |got - want| over the RMS of want."""
    diff = got - want
    rms = float(np.sqrt(np.mean(np.square(want))))
    return (float(np.abs(diff).max()) / rms,
            float(np.sqrt(np.mean(np.square(diff)))) / rms)


def _check_serve_err(what, err, dtype):
    if not all(e <= tol for e, tol in zip(err, SERVE_TOL[dtype])):
        raise AssertionError(f"{what} {dtype}: (max, RMS) of |diff| / RMS = "
                             f"{err} exceeds {SERVE_TOL[dtype]}")


def phase_serve(smi: str, tmp: Path):
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_outproj,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    n_layers = model_config_for_size(MODEL_SIZE).num_layers
    expected = n_layers * -(-N_WINDOWS // BATCH)
    counted = (fused_qkv_attention, fused_qkv_attention_outproj)
    launches, outs, rates = {}, {}, {}
    _serve(tmp, "auto", "bfloat16")  # warm-up: lazy CUDA module loads
    for impl in ("auto", "fused_qkv_op"):
        for fn in counted:
            fn.launches = 0
        out, predict_s, wall = _serve(tmp, impl, "bfloat16")
        launches[impl] = {fn.__name__: fn.launches for fn in counted}
        if out.shape != (N_WINDOWS, SEQ_LEN, N_FEATURES):
            raise AssertionError(f"{impl}: output shape {out.shape}")
        if not np.isfinite(out).all():
            raise AssertionError(f"{impl}: non-finite served output")
        outs[impl, "bfloat16"] = out
        rates[impl] = (N_WINDOWS / predict_s, predict_s, wall)
    # B1 eval (auto) and B5's first phase (fused_qkv_op) run the bf16 body,
    # B5's second phase the grouped matmul's
    served = {}
    for impl, need, banned in (
            ("auto", (ATTN_BODY,), (ATTN_SCALAR_BF16,)),
            ("fused_qkv_op", (ATTN_BODY, OUTPROJ_BODY),
             (ATTN_SCALAR_BF16, OUTPROJ_TILES_BF16))):
        events = _profiled(lambda: _serve(tmp, impl, "bfloat16"))
        _check_kernel_names(f"serve {impl} bf16", [e.key for e in events],
                            need, banned)
        body = [e for e in events if ATTN_BODY in e.key]
        served[impl] = (f"{sum(_device_ms(e) for e in body):.1f} ms x"
                        f"{sum(e.count for e in body)}")
    want = {"auto": dict(fused_qkv_attention=expected,
                         fused_qkv_attention_outproj=0),
            "fused_qkv_op": dict(fused_qkv_attention=0,
                                 fused_qkv_attention_outproj=expected)}
    if launches != want:
        raise AssertionError(f"kernel launches on the serve path {launches}, "
                             f"expected {want}")
    errs = {}
    for dtype in ("bfloat16", "float32"):
        ref, ref_s, _ = _serve(tmp, "torch", dtype)
        if dtype == "bfloat16":
            rates["torch"] = (N_WINDOWS / ref_s, ref_s, None)
        for impl, key in (("fused_qkv", "auto"),
                          ("fused_qkv_op", "fused_qkv_op")):
            got = outs.get((key, dtype))
            if got is None:
                got = _serve(tmp, impl, dtype)[0]
            errs[impl, dtype] = _serve_err(got, ref)
            _check_serve_err(f"served output of {impl} vs the plain path",
                             errs[impl, dtype], dtype)
    print(f"serve: {N_WINDOWS} windows WeatherBERT-{MODEL_SIZE} bf16 "
          f"--batch-size {BATCH}: kernel launches {launches}; "
          + "; ".join(f"{impl} {r[0]:.1f} windows/s (predict {r[1]:.3f} s)"
                      for impl, r in rates.items())
          + f"; |kernel - plain| (max, RMS)/RMS {errs} (bars {SERVE_TOL}); "
          f"{ATTN_BODY} in a profiled bf16 call {served}; card {smi}",
          flush=True)
    _serve_long(tmp, n_layers)
    return launches


def _serve_long(tmp: Path, n_layers: int):
    """A file of T = 730 windows through `wm-serve-torch` at large in bf16,
    with `auto` (B1 eval, its streaming body) and `fused_qkv_op` (B5), each
    held against the plain path at the serving bound."""
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_outproj,
    )

    name = f"windows_{LONG_SEQ_LEN}"
    ref = _serve(tmp, "torch", "bfloat16", name)[0]
    expected = n_layers * -(-LONG_WINDOWS // BATCH)
    report = []
    for impl, fn in (("auto", fused_qkv_attention),
                     ("fused_qkv_op", fused_qkv_attention_outproj)):
        fn.launches = 0
        out, predict_s, _ = _serve(tmp, impl, "bfloat16", name)
        if fn.launches != expected:
            raise AssertionError(f"serve T={LONG_SEQ_LEN} {impl}: "
                                 f"{fn.launches} launches of {fn.__name__}, "
                                 f"expected {expected}")
        if out.shape != (LONG_WINDOWS, LONG_SEQ_LEN, N_FEATURES) or \
                not np.isfinite(out).all():
            raise AssertionError(
                f"serve T={LONG_SEQ_LEN} {impl}: output {out.shape}, finite "
                f"{np.isfinite(out).all()}")
        err = _serve_err(out, ref)
        _check_serve_err(f"T={LONG_SEQ_LEN} served output of {impl} vs the "
                         f"plain path", err, "bfloat16")
        report.append(f"{impl} {fn.__name__} x{fn.launches}, "
                      f"{LONG_WINDOWS / predict_s:.1f} windows/s, |kernel - "
                      f"plain| (max, RMS)/RMS ({err[0]:.4f}, {err[1]:.5f})")
    print(f"serve: {LONG_WINDOWS} windows of T={LONG_SEQ_LEN} "
          f"WeatherBERT-{MODEL_SIZE} bf16: " + "; ".join(report)
          + f" (bar {SERVE_TOL['bfloat16']})", flush=True)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http(port, method, path, body=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _npz_bytes(arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _predict(port, arrays):
    status, data = _http(port, "POST", "/predict", _npz_bytes(arrays))
    if status != 200:
        raise AssertionError(f"/predict answered {status}: {data[:300]}")
    with np.load(io.BytesIO(data)) as z:
        return z["output"]


def _wait_healthy(proc, port, log_path):
    deadline = time.perf_counter() + DAEMON_START_S
    while True:
        try:
            if _http(port, "GET", "/healthz")[0] == 200:
                return
        except OSError:
            pass
        if proc.poll() is not None:
            raise AssertionError(f"the daemon exited with {proc.returncode}: "
                                 f"{log_path.read_text()[-2000:]}")
        if time.perf_counter() > deadline:
            raise AssertionError(f"no /healthz within {DAEMON_START_S} s")
        time.sleep(0.5)


def _offline(path: Path, windows):
    """The offline predictor's bf16 answers through B5 for `windows`."""
    from weathermodel_tpu_torch.serve import load_weather_predictor

    predictor = load_weather_predictor(
        str(path), MODEL_SIZE, attention_impl="fused_qkv_op",
        max_len=SEQ_LEN, buckets=(8, 32, 128, BATCH), device="cuda")
    return predictor(windows["weather"], windows["coords"], windows["year"],
                     windows["interval"], windows["mask"])


def phase_serve_daemon(smi: str, tmp: Path):
    first, second = tmp / "weatherbert_large.pth", tmp / "second.pth"
    _write_checkpoint(second, SEED + 1)
    n = DAEMON_CLIENTS * DAEMON_REQUESTS * DAEMON_WINDOWS
    windows = _windows(np.random.default_rng(SEED + 3), n)
    port = _free_port()
    log_path = tmp / "daemon.log"
    cmd = [sys.executable, "-m", "weathermodel_tpu_torch.cli.serve",
           "--daemon", "--checkpoint", str(first), "--model", "weatherbert",
           "--model-size", MODEL_SIZE, "--attention-impl", "fused_qkv_op",
           "--batch-size", str(BATCH), "--seq-len", str(SEQ_LEN),
           "--allow-reload", "--port", str(port), "--device", "cuda"]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=Path(__file__).resolve().parent)
    try:
        _wait_healthy(proc, port, log_path)
        start_s = time.perf_counter() - t0
        answers, errors = {}, []

        def client(c):
            try:
                for r in range(DAEMON_REQUESTS):
                    i0 = (c * DAEMON_REQUESTS + r) * DAEMON_WINDOWS
                    answers[i0] = _predict(port, {
                        k: v[i0:i0 + DAEMON_WINDOWS]
                        for k, v in windows.items()})
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(DAEMON_CLIENTS)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t1
        if errors:
            raise errors[0]
        got = np.concatenate([answers[i] for i in sorted(answers)])
        err = _serve_err(got, _offline(first, windows))
        _check_serve_err("daemon answers vs the offline predictor", err,
                         "bfloat16")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        if stats["n_rows"] != n or not stats["rows_per_batch"] > \
                DAEMON_WINDOWS:
            raise AssertionError(f"/stats {stats}: expected {n} rows in "
                                 f"batches of more than {DAEMON_WINDOWS}")
        status, data = _http(port, "POST", "/reload", json.dumps(
            {"checkpoint": str(second)}).encode())
        if status != 200:
            raise AssertionError(f"/reload answered {status}: {data[:300]}")
        head = {k: v[:DAEMON_WINDOWS] for k, v in windows.items()}
        reloaded = _predict(port, head)
        reload_err = _serve_err(reloaded, _offline(second, head))
        _check_serve_err("daemon answer after /reload vs the new weights",
                         reload_err, "bfloat16")
        if np.allclose(reloaded, got[:DAEMON_WINDOWS]):
            raise AssertionError("/reload did not change the answers")
        t2 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=DAEMON_STOP_S)
        if rc != 0:
            raise AssertionError(f"the daemon exited with {rc} on SIGTERM: "
                                 f"{log_path.read_text()[-2000:]}")
        stop_s = time.perf_counter() - t2
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lat = stats["latency_ms"]
    print(f"serve_daemon: wm-serve-torch --daemon WeatherBERT-{MODEL_SIZE} "
          f"bf16 --attention-impl fused_qkv_op --batch-size {BATCH}: "
          f"/healthz after {start_s:.1f} s (start, load, warm-up of buckets "
          f"8/32/128/{BATCH}); {DAEMON_CLIENTS} clients x {DAEMON_REQUESTS} "
          f"requests x {DAEMON_WINDOWS} windows: {n / wall:.1f} windows/s "
          f"({wall:.3f} s), latency p50 {lat['p50']} ms, p95 {lat['p95']} "
          f"ms, p99 {lat['p99']} ms, {stats['n_batches']} batches of "
          f"{stats['rows_per_batch']} rows; vs the offline predictor "
          f"(max, RMS)/RMS {err}, after /reload {reload_err} (bar "
          f"{SERVE_TOL['bfloat16']}); exit 0 {stop_s:.1f} s after SIGTERM; "
          f"card {smi}", flush=True)
    return {**stats, "windows_per_s": n / wall}


def _train_kernels_case(x, w, b, do, nh, dtype, rate, seed, timed: bool):
    """B1 train and B2 against their plain versions on one set of inputs
    (B2 on the plain forward's qkv, so both see the same residual)."""
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_bwd,
        fused_qkv_attention_bwd_reference,
        fused_qkv_attention_train,
        fused_qkv_attention_train_reference,
    )

    args = (x.to(dtype), w.to(dtype), b.to(dtype), nh)
    g = do.to(dtype)
    o, qkv = fused_qkv_attention_train(*args, rate, seed)
    o_ref, qkv_ref = fused_qkv_attention_train_reference(*args, rate, seed)
    dqkv = fused_qkv_attention_bwd(qkv_ref, g, nh, rate, seed)
    dqkv_ref = fused_qkv_attention_bwd_reference(qkv_ref, g, nh, rate, seed)
    if not torch.equal(dqkv, fused_qkv_attention_bwd(qkv_ref, g, nh, rate,
                                                     seed)):
        raise AssertionError(f"B2 {dtype} dropout {rate}: two calls gave "
                             f"different bits")
    torch.cuda.synchronize()
    errs = {name: _check_kernel(f"{name} {dtype} dropout {rate}", got, want,
                                dtype)
            for name, got, want in (("o", o, o_ref), ("qkv", qkv, qkv_ref),
                                    ("dqkv", dqkv, dqkv_ref))}
    r = dict(fwd_err=max(errs["o"][0], errs["qkv"][0]),
             bwd_err=errs["dqkv"][0], errs=_errs_text(errs))
    del o, qkv, o_ref, dqkv, dqkv_ref
    if not timed:
        return r
    torch.cuda.empty_cache()
    q, k, v = (_heads(a, nh).detach().requires_grad_()
               for a in qkv_ref.chunk(3, dim=-1))
    g_heads = _heads(g, nh)

    def library_bwd():
        out = F.scaled_dot_product_attention(q, k, v, dropout_p=rate)
        return torch.autograd.grad(out, (q, k, v), g_heads)

    r.update(
        fwd_ms=_cuda_ms(lambda: fused_qkv_attention_train(*args, rate, seed)),
        fwd_plain_ms=_cuda_ms(lambda: fused_qkv_attention_train_reference(
            *args, rate, seed), iters=3, warmup=1),
        fwd_library_ms=_cuda_ms(lambda: _library_attention(*args, rate)),
        bwd_ms=_cuda_ms(lambda: fused_qkv_attention_bwd(qkv_ref, g, nh, rate,
                                                        seed)),
        bwd_plain_ms=_cuda_ms(lambda: fused_qkv_attention_bwd_reference(
            qkv_ref, g, nh, rate, seed), iters=3, warmup=1),
        bwd_library_ms=_cuda_ms(library_bwd),
        sdpa_backend=_sdpa_backend(q, k, v))
    return r


def phase_kernel_train():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bound = 1.0 / h ** 0.5
    x = torch.randn(MICRO, SEQ_LEN, h, device="cuda", generator=g)
    w = (torch.rand(3 * h, h, device="cuda", generator=g) * 2 - 1) * bound
    b = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) * bound
    do = torch.randn(MICRO, SEQ_LEN, h, device="cuda", generator=g)
    seed = 20260101
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (DROPOUT, 0.0):
            results[dtype, rate] = _train_kernels_case(
                x, w, b, do, nh, dtype, rate, seed, timed=rate == DROPOUT)
    lines = []
    for (dtype, rate), r in results.items():
        line = (f"{str(dtype).split('.')[1]} dropout {rate}: max|err| "
                f"{r['errs']}")
        if "fwd_ms" in r:
            r["fwd_bound"] = _attention_bound(MICRO, SEQ_LEN, h, nh, dtype,
                                              train=True)
            r["bwd_bound"] = _bwd_bound(MICRO, SEQ_LEN, h, nh, dtype)
            line += (
                f"; B1 train kernel {r['fwd_ms']:.3f} ms, plain "
                f"{r['fwd_plain_ms']:.3f}, F.linear+SDPA "
                f"{r['fwd_library_ms']:.3f}, bound {r['fwd_bound'][0]:.3f} "
                f"by {r['fwd_bound'][1]}; B2 kernel {r['bwd_ms']:.3f} ms, "
                f"plain {r['bwd_plain_ms']:.3f}, SDPA fwd+bwd "
                f"{r['bwd_library_ms']:.3f}, bound {r['bwd_bound'][0]:.3f} by "
                f"{r['bwd_bound'][1]}; SDPA backend {r['sdpa_backend']}")
        lines.append(line)
    print("kernel_train: " + _attention_body_report({(1, 1)}), flush=True)
    print("kernel_train: " + _bwd_body_report("fused_qkv_attention_bwd"),
          flush=True)
    print(f"kernel_train: B={MICRO} T={SEQ_LEN} H={h} heads={nh} (tol "
          f"{KERNEL_TOL}, {SCALE_TOL} x max) | " + " | ".join(lines),
          flush=True)
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_train,
        fused_qkv_attention_train_reference,
    )

    print(f"kernel_train: bf16 B1 train at T={SEQ_LEN} "
          f"{results[torch.bfloat16, DROPOUT]['fwd_ms']:.3f} ms (recorded: "
          f"{SHORT_T_MS['B1 train']} ms); bf16 B2 on its wgmma body "
          f"{results[torch.bfloat16, DROPOUT]['bwd_ms']:.3f} ms (recorded on "
          f"the scalar passes: {SCALAR_BWD_MS['B2']} ms)", flush=True)
    f32 = results[torch.float32, DROPOUT]
    print(f"kernel_train: fp32 B2 on its FFMA body at T={SEQ_LEN} "
          f"{f32['bwd_ms']:.3f} ms (recorded on the scalar passes: "
          f"{SCALAR_FP32_MS['B2']} ms), SDPA fwd+bwd "
          f"{f32['bwd_library_ms']:.3f}, bound {f32['bwd_bound'][0]:.3f} ms "
          f"by {f32['bwd_bound'][1]}, "
          f"{f32['bwd_bound'][0] / f32['bwd_ms']:.3f} of it", flush=True)
    for rate in (DROPOUT, 0.0):
        print(f"kernel_train: B1 train (o, qkv) dropout {rate} "
              + _attention_edges(
                  "B1 train", lambda *a: fused_qkv_attention_train(
                      *a, rate, seed),
                  lambda *a: fused_qkv_attention_train_reference(
                      *a, rate, seed), SEED + 23), flush=True)
        print(f"kernel_train: B2 (dqkv on the plain forward's qkv) dropout "
              f"{rate} " + _attention_edges(
                  "B2", lambda *a: _bwd_edge_case(a, rate, seed, False),
                  lambda *a: _bwd_edge_case(a, rate, seed, True), SEED + 24,
                  ATTN_BWD_EDGE_SHAPES), flush=True)
    return results[torch.bfloat16, DROPOUT]


def _bwd_edge_case(args, rate, seed, plain: bool):
    """(dqkv,) of B2 or of its plain version on the plain training forward's
    qkv of (x, w, b, heads) and a cotangent from the seed."""
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_bwd,
        fused_qkv_attention_bwd_reference,
        fused_qkv_attention_train_reference,
    )

    nh = args[3]
    qkv = fused_qkv_attention_train_reference(*args, rate, seed)[1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3,
                     device="cuda", generator=g).to(qkv.dtype)
    fn = fused_qkv_attention_bwd_reference if plain else \
        fused_qkv_attention_bwd
    return (fn(qkv, do, nh, rate, seed),)


def _windows_batch(n, seed):
    """A numpy Batch of n seeded windows (z-scored weather, coords, years,
    weekly interval) and a bool [n, T, F] mask at p=0.15."""
    from weathermodel_tpu_torch.train.steps import Batch

    rng = np.random.default_rng(seed)
    batch = Batch(
        rng.standard_normal((n, SEQ_LEN, N_FEATURES), dtype=np.float32),
        np.stack([rng.uniform(-55, 60, n), rng.uniform(-170, 170, n)],
                 axis=1).astype(np.float32),
        (rng.integers(1984, 1995, (n, 1)) + np.arange(SEQ_LEN) * 7 / 365
         ).astype(np.float32),
        np.full((n, 1), 7.0, np.float32))
    return batch, rng.random((n, SEQ_LEN, N_FEATURES)) < 0.15


def _device_ms(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    if us is None:
        us = event.self_cuda_time_total
    return us / 1e3


def _kernel_events(prof):
    """The profile's device kernels (not the host-side ops that launched
    them: the fused kernels' time would count twice, under the autograd
    Function's name too), by device time."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(kernels, key=_device_ms, reverse=True)


def _train_step_fn(name, cfg, impl, device, grad_accum=1, gmm_impl="kernel",
                   ffn_impl="torch", remat=False):
    """A seeded model `name` on `device` (with `remat`, each encoder layer
    recomputed in the backward) and its train step with the model's
    objective (beta 0.5, the CLI's default)."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.train.state import make_optimizer
    from weathermodel_tpu_torch.train.steps import (
        OBJECTIVE_FOR_MODEL,
        make_train_step,
    )

    model = make_model(name, cfg, impl, ffn_impl, gmm_impl, remat=remat)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    model = model.to(device)
    objective, masking = OBJECTIVE_FOR_MODEL[name]
    return model, make_train_step(model, make_optimizer(model), masking,
                                  grad_accum=grad_accum, objective=objective,
                                  beta=0.5)


def _profile_step(name, cfg, impl, batch_size, grad_accum=1,
                  ffn_impl="torch", named=(), mode="train", require=(),
                  forbid=()):
    """torch.profiler over one train step, or one eval step with mode
    "eval" (after a warm-up step): device time by op and the device's busy
    share of the step; for each (label, substring) in `named`, the device
    time and count of the kernels whose name holds the substring. Fails
    unless each substring in `require` is in some kernel's name and none in
    `forbid` is."""
    from weathermodel_tpu_torch.train.steps import (
        OBJECTIVE_FOR_MODEL,
        batch_to_device,
        make_eval_step,
    )

    model, step = _train_step_fn(name, cfg, impl, "cuda", grad_accum,
                                 ffn_impl=ffn_impl)
    if mode == "eval":
        objective, masking = OBJECTIVE_FOR_MODEL[name]
        eval_step = make_eval_step(model, masking, objective=objective)

        def step(batch, gen, lr, n_masked):
            return eval_step(batch, gen, n_masked)

    batch = batch_to_device(_windows_batch(batch_size, SEED)[0], "cuda")
    gen = torch.Generator().manual_seed(SEED)
    float(step(batch, gen, 1e-4, 10)["total_loss"])  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step(batch, gen, 1e-4, 10)["total_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _kernel_events(prof)
    _check_kernel_names(f"{name} {mode} step ({impl}, {ffn_impl})",
                        [e.key for e in events], require, forbid)
    total = sum(_device_ms(e) for e in events)
    top = ", ".join(f"{e.key[:60]} {_device_ms(e):.1f} ms x{e.count}"
                    for e in events[:12])
    picked = "".join(
        f"; {label}: "
        f"{sum(_device_ms(e) for e in events if sub in e.key):.2f} ms x"
        f"{sum(e.count for e in events if sub in e.key)}"
        for label, sub in named)
    return (f"profile of one step: kernels {total:.1f} ms of device time in "
            f"{wall_ms:.1f} ms profiled (busy {total / wall_ms:.2f}){picked}; "
            f"top: {top or 'none'}")


def _grad_rel(a, b, skip=()):
    """The worst parameter's ||grad_a - grad_b|| / ||grad_b|| and its name,
    over the parameters not named in `skip`."""
    return max((((pa.grad.cpu() - pb.grad.cpu()).norm()
                 / pb.grad.cpu().norm()).item(), name)
               for (name, pa), pb in zip(a.named_parameters(),
                                         b.parameters())
               if name not in skip)


def _step_parity(name, size, impl, dtype: str, moe=None, ffn_impl="torch"):
    """One train step of the kernel path `impl` (with `ffn_impl`) against the
    plain path (plain attention and FFN; with `moe`, the MoE config, also the
    plain grouped matmuls) at STEP_WINDOWS windows, full width, the same
    weights, batch and mask, dropout off: (loss rel diff, worst gradient rel
    diff, its parameter, and in fp32 the same worst gradient diff between
    the plain path on the card and on the CPU: the noise floor of two plain
    fp32 runs)."""
    from weathermodel_tpu_torch.train.steps import batch_to_device
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(size, compute_dtype=dtype, **(moe or {}))
    batch, mask = _windows_batch(STEP_WINDOWS, SEED + 2)
    runs = [(impl, ffn_impl, "kernel", "cuda"),
            ("torch", "torch", "plain", "cuda")]
    if dtype == "float32":
        runs.append(("torch", "torch", "plain", "cpu"))
    models, losses = [], []
    for run_impl, run_ffn, gmm_impl, device in runs:
        model, step = _train_step_fn(name, cfg, run_impl, device,
                                     gmm_impl=gmm_impl, ffn_impl=run_ffn)
        out = step(batch_to_device(batch, device),
                   torch.Generator().manual_seed(SEED), 0.0, 10,
                   mask=torch.from_numpy(mask).to(device), dropout_rate=0.0)
        models.append(model)
        losses.append(float(out["total_loss"]))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    floor = _grad_rel(models[1], models[2])[0] if len(models) > 2 else None
    return (loss_rel, *_grad_rel(models[0], models[1]), floor)


def _check_step_parity(name, size, impl, moe=None, ffn_impl="torch"):
    parity = {}
    for dtype in ("float32", "bfloat16"):
        parity[dtype] = _step_parity(name, size, impl, dtype, moe, ffn_impl)
        loss_rel, grad_rel, _, _ = parity[dtype]
        tol = STEP_TOL[dtype]
        if loss_rel > tol["loss"] or grad_rel > tol.get("grad", np.inf):
            raise AssertionError(
                f"{name} {dtype}: one step, kernel path vs plain path (loss "
                f"rel, worst gradient, its parameter) {parity[dtype]}, bars "
                f"{tol}")
    what = ("attention and grouped matmuls" if moe else "attention"
            if ffn_impl == "torch" else f"attention and {ffn_impl}")
    return (f"one step at {STEP_WINDOWS} windows, kernel path vs plain "
            f"path ({what}), dropout off, (loss rel, worst gradient "
            "||diff||/||grad||, its parameter, the plain path's card-vs-CPU "
            f"worst gradient diff): {parity}; bars {STEP_TOL}")


def _remat_step(name, size, impl, fwd, bwd):
    """One fp32 train step at STEP_WINDOWS windows with dropout (the
    model's 0.1) and the attention kernels (`impl`), with and without
    --remat, from one generator seed: every gradient and the loss must be
    bitwise equal (the recompute draws the forward's masks), the forward
    kernel `fwd` must launch twice as often under remat (each layer's
    forward runs again in the backward) and the backward kernel `bwd` as
    often. Returns the printed text."""
    from weathermodel_tpu_torch.train.steps import batch_to_device
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(size, compute_dtype="float32")
    batch, mask = _windows_batch(STEP_WINDOWS, SEED + 2)
    runs = []
    for remat in (False, True):
        model, step = _train_step_fn(name, cfg, impl, "cuda", remat=remat)
        for fn in (fwd, bwd):
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out = step(batch_to_device(batch, "cuda"),
                   torch.Generator().manual_seed(SEED), 0.0, 10,
                   mask=torch.from_numpy(mask).to("cuda"))
        loss = float(out["total_loss"])
        runs.append((loss, {k: p.grad for k, p in model.named_parameters()},
                     fwd.launches, bwd.launches,
                     torch.cuda.max_memory_allocated() / 1e9))
        del model, step
    (l0, g0, f0, b0, m0), (l1, g1, f1, b1, m1) = runs
    unequal = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    if l0 != l1 or unequal or f1 != 2 * f0 or b1 != b0 or not f0:
        raise AssertionError(
            f"{name} --remat step: loss {l1!r} against {l0!r}, gradients "
            f"not bitwise equal {unequal[:5]}, {fwd.__name__} {f0} -> {f1} "
            f"(expected doubled), {bwd.__name__} {b0} -> {b1}")
    gc.collect()
    torch.cuda.empty_cache()
    return (f"one fp32 step at {STEP_WINDOWS} windows, dropout "
            f"{cfg.dropout_rate}, {impl} kernels, --remat against none: loss "
            f"{l1:.7f} and all {len(g0)} gradients bitwise equal; "
            f"{fwd.__name__} {f0} -> {f1}, {bwd.__name__} {b0} -> {b1}; peak "
            f"{m0:.2f} -> {m1:.2f} GB")


def _write_store(root: Path) -> Path:
    """A seeded synthetic chunk store written by the port's writer: 8 chunks
    (train 0-6, validation 7) of 1000 windows, of which the cutoff year
    keeps about 2/3."""
    from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset

    data = root / "data"
    write_synthetic_dataset(str(data), n_chunks=8, n_samples=1000,
                            seq_len=SEQ_LEN, seed=SEED)
    return data


def _store_batches(data: Path, batch_size: int):
    """(train batches, validation windows) per epoch of the store."""
    from weathermodel_tpu_torch.data.pretraining import (
        PretrainDataConfig,
        pretrain_batches,
    )

    dcfg = PretrainDataConfig(data_dir=str(data), batch_size=batch_size)
    n_train = sum(1 for _ in pretrain_batches("train", dcfg))
    n_val = sum(int(bt.weight.sum()) if bt.weight is not None
                else batch_size for bt in pretrain_batches("validation",
                                                           dcfg))
    if n_train < 4 or n_val < batch_size:
        raise AssertionError(f"synthetic store too small: {n_train} train "
                             f"batches, {n_val} validation windows")
    return n_train, n_val


def _run_pretrain(argv, counted):
    """`wm-pretrain-torch`'s run(args) on argv with every wrapper in
    `counted` set to 0 just before: (result, launches by wrapper name,
    wall seconds, peak GB, the output json)."""
    from weathermodel_tpu_torch.cli import pretrain

    args = pretrain.build_parser().parse_args(argv)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = pretrain.run(args)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    workdir = Path(args.workdir)
    records = list(workdir.glob("*_output.json"))
    if len(records) != 1 or not (workdir / "best.pth").exists():
        raise AssertionError(f"wm-pretrain-torch wrote {records} and "
                             "no best.pth")
    with open(records[0]) as f:
        record = json.load(f)
    return result, launches, wall, peak_gb, record


def _all_kernels():
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention,
        fused_qkv_attention_bwd,
        fused_qkv_attention_outproj,
        fused_qkv_attention_train,
    )
    from weathermodel_tpu_torch.ops.fused_ffn import fused_ffn
    from weathermodel_tpu_torch.ops.fused_ffn_ln import (
        fused_ffn_ln,
        fused_ffn_ln_bwd,
    )
    from weathermodel_tpu_torch.ops.blocked_mm import blocked_mm
    from weathermodel_tpu_torch.ops.gmm import gmm, tgmm
    from weathermodel_tpu_torch.ops.headpack import headpack_v0, headpack_v1
    from weathermodel_tpu_torch.ops.kernel_dropout import (
        lane_dropout,
        random_keep_mask,
    )
    from weathermodel_tpu_torch.ops.maskgen import (
        bool_keep_mask,
        packed_keep_mask,
    )

    return (fused_qkv_attention, fused_qkv_attention_train,
            fused_qkv_attention_bwd, flash_attention_fwd, flash_attention_bwd,
            gmm, tgmm, fused_ffn_ln, fused_ffn_ln_bwd, fused_ffn,
            fused_qkv_attention_outproj, packed_keep_mask, bool_keep_mask,
            lane_dropout, random_keep_mask, headpack_v0, headpack_v1,
            blocked_mm)


# the kernels no training run launches: the FFN kernels (the bench's only),
# B5 (serving and the bench's eval mode only), the keep-mask family (the
# maskgen dropout impls, which only the bench's maskgen lines select, and
# B8/B8m, which no layer calls) and the probes (the ablation scripts' only)
NOT_IN_TRAINING = {"fused_ffn_ln": 0, "fused_ffn_ln_bwd": 0, "fused_ffn": 0,
                   "fused_qkv_attention_outproj": 0, "packed_keep_mask": 0,
                   "bool_keep_mask": 0, "lane_dropout": 0,
                   "random_keep_mask": 0, "headpack_v0": 0, "headpack_v1": 0,
                   "blocked_mm": 0}


def _check_record(record, keys=("total_loss",)):
    """The losses of both scopes are finite and the train loss falls from
    epoch 1 to epoch 2; returns (train loss, validation loss)."""
    losses = record["losses"]
    for scope in ("train", "val"):
        for k in keys:
            if not np.all(np.isfinite(losses[scope][k])):
                raise AssertionError(f"non-finite {scope} {k}: "
                                     f"{losses[scope][k]}")
    train_loss = losses["train"]["total_loss"]
    if not train_loss[1] < train_loss[0]:
        raise AssertionError(f"train loss did not fall: {train_loss}")
    return train_loss, losses["val"]["total_loss"]


def _check_launches(launches, expected, steps, val_batches):
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} on the train path, "
                             f"expected {expected} ({steps} steps, "
                             f"{val_batches} validation batches)")


def _throughput(result, cfg, batch_size, out_dim=None):
    """Epoch 2's median step: (ms, samples/s, TFLOP/s, GFLOP/sample)."""
    step_s = float(np.median(result["train_step_seconds"][-1]))
    flops = train_flops_per_sample(cfg, out_dim)
    return (step_s * 1e3, batch_size / step_s,
            flops * batch_size / step_s / 1e12, flops / 1e9)


def phase_train(smi: str, data: Path):
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16")
    n_train, n_val = _store_batches(data, TRAIN_BATCH)
    with tempfile.TemporaryDirectory() as workdir:
        result, launches, wall, peak_gb, record = _run_pretrain([
            "--model", "weatherbert", "--model-size", MODEL_SIZE,
            "--batch-size", str(TRAIN_BATCH), "--grad-accum", str(GRAD_ACCUM),
            "--n-epochs", "2", "--n-warmup-epochs", "0",
            "--masking-prob", "0.15", "--data-dir", str(data),
            "--workdir", workdir, "--compute-dtype", "bfloat16",
            "--device", "cuda"], _all_kernels())
    steps = sum(len(s) for s in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    per_step = GRAD_ACCUM * cfg.num_layers
    _check_launches(launches, {
        "fused_qkv_attention": cfg.num_layers * val_batches,
        "fused_qkv_attention_train": per_step * steps,
        "fused_qkv_attention_bwd": per_step * steps,
        "flash_attention_fwd": 0, "flash_attention_bwd": 0, "gmm": 0,
        "tgmm": 0, **NOT_IN_TRAINING}, steps, val_batches)
    train_loss, val_loss = _check_record(record)
    ms, rate, tflops, gflop = _throughput(result, cfg, TRAIN_BATCH)
    print(f"train: wm-pretrain-torch WeatherBERT-{MODEL_SIZE} bf16 "
          f"--batch-size {TRAIN_BATCH} --grad-accum {GRAD_ACCUM}, dropout "
          f"{cfg.dropout_rate}, 2 epochs, lr 5e-4: {n_train} train batches "
          f"and {n_val} validation windows per epoch; train loss "
          f"{train_loss}, val loss {val_loss}; {launches}; epoch 2 median "
          f"{ms:.1f} ms/step, {rate:.1f} samples/s, {tflops:.1f} TFLOP/s "
          f"({gflop:.1f} GFLOP/sample); epoch seconds "
          f"{record['metrics']['epoch_seconds']}; run {wall:.1f} s; peak "
          f"memory {peak_gb:.1f} GB; card {smi}", flush=True)
    print("train: " + _profile_step(
        "weatherbert", cfg, "fused_qkv", TRAIN_BATCH, GRAD_ACCUM,
        named=(("B1 train (the bf16 body)", ATTN_BODY),
               ("B2 (the bf16 backward body)", ATTN_BWD_BODY)),
        require=(ATTN_BODY, ATTN_BWD_BODY),
        forbid=(ATTN_SCALAR_BF16, *ATTN_BWD_SCALAR_BF16)), flush=True)
    print("train: " + _check_step_parity("weatherbert", MODEL_SIZE,
                                         "fused_qkv"), flush=True)
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_bwd,
        fused_qkv_attention_train,
    )

    print("train: " + _remat_step("weatherbert", MODEL_SIZE, "fused_qkv",
                                  fused_qkv_attention_train,
                                  fused_qkv_attention_bwd), flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        r_result, r_launches, r_wall, r_peak, r_record = _run_pretrain([
            "--model", "weatherbert", "--model-size", MODEL_SIZE,
            "--batch-size", str(TRAIN_BATCH), "--grad-accum", str(GRAD_ACCUM),
            "--n-epochs", "1", "--n-warmup-epochs", "0",
            "--masking-prob", "0.15", "--data-dir", str(data),
            "--workdir", workdir, "--compute-dtype", "bfloat16",
            "--device", "cuda", "--remat"], _all_kernels())
    r_steps = len(r_result["train_step_seconds"][0])
    r_val = r_result["val_batches"][0]
    _check_launches(r_launches, {
        "fused_qkv_attention": cfg.num_layers * r_val,
        "fused_qkv_attention_train": 2 * per_step * r_steps,
        "fused_qkv_attention_bwd": per_step * r_steps,
        "flash_attention_fwd": 0, "flash_attention_bwd": 0, "gmm": 0,
        "tgmm": 0, **NOT_IN_TRAINING}, r_steps, r_val)
    r_losses = r_record["losses"]
    if not all(np.isfinite(r_losses[scope]["total_loss"]).all()
               for scope in ("train", "val")):
        raise AssertionError(f"--remat: non-finite losses {r_losses}")
    ms_remat = float(np.median(r_result["train_step_seconds"][0])) * 1e3
    ms_plain = [float(np.median(s)) * 1e3
                for s in result["train_step_seconds"]]
    print(f"train: wm-pretrain-torch --remat, the same run for 1 epoch: "
          f"{r_steps} steps, train loss {r_losses['train']['total_loss']} "
          f"(no remat: {train_loss[0]}), val loss "
          f"{r_losses['val']['total_loss']}; {r_launches}; epoch 1 median "
          f"{ms_remat:.1f} ms/step, {TRAIN_BATCH / ms_remat * 1e3:.1f} "
          f"samples/s, against no remat's epoch 1 {ms_plain[0]:.1f} and "
          f"epoch 2 {ms_plain[1]:.1f} ms/step ({ms_remat / ms_plain[0]:.3f}x "
          f"and {ms_remat / ms_plain[1]:.3f}x); peak memory {r_peak:.2f} GB "
          f"against {peak_gb:.2f} GB ({peak_gb - r_peak:.2f} GB less); run "
          f"{r_wall:.1f} s; card {smi}", flush=True)
    return launches


def _flash_case(qkv, do, nh, dtype, rate, seed, timed: bool):
    """B3f and B3b against their plain versions on the column slices of
    one packed projection, as the model passes them."""
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    q, k, v = qkv.to(dtype).chunk(3, dim=-1)
    g = do.to(dtype)
    args = (q, k, v, nh, rate, seed)
    bwd_args = (q, k, v, g, nh, rate, seed)
    o = flash_attention_fwd(*args)
    # B3f on three separate tensors too (the same values)
    o_tensors = flash_attention_fwd(*(a.contiguous() for a in (q, k, v)), nh,
                                    rate, seed)
    o_ref = flash_attention_fwd_reference(*args)
    grads = flash_attention_bwd(*bwd_args)
    grads_ref = flash_attention_bwd_reference(*bwd_args)
    # a fixed summation order and no atomics: a second call gives the bits
    again = (flash_attention_fwd(*args), *flash_attention_bwd(*bwd_args))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((o, *grads), again)):
        raise AssertionError(f"B3f/B3b {dtype} dropout {rate}: two calls "
                             f"gave different bits")
    del again
    errs = {name: _check_kernel(f"{name} {dtype} dropout {rate}", got, want,
                                dtype)
            for name, got, want in (("o", o, o_ref),
                                    ("o on tensors", o_tensors, o_ref),
                                    *zip(("dq", "dk", "dv"), grads,
                                         grads_ref))}
    r = dict(fwd_err=max(errs[n][0] for n in ("o", "o on tensors")),
             bwd_err=max(errs[n][0] for n in ("dq", "dk", "dv")),
             errs=_errs_text(errs))
    del o, o_tensors, o_ref, grads, grads_ref
    if not timed:
        return r
    torch.cuda.empty_cache()
    heads = [_heads(a, nh) for a in (q, k, v)]
    qh, kh, vh = (a.detach().requires_grad_() for a in heads)
    g_heads = _heads(g, nh)

    def library_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(*heads, dropout_p=rate)

    def library_bwd():
        out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate)
        return torch.autograd.grad(out, (qh, kh, vh), g_heads)

    r.update(
        fwd_ms=_cuda_ms(lambda: flash_attention_fwd(*args)),
        fwd_plain_ms=_cuda_ms(lambda: flash_attention_fwd_reference(*args),
                              iters=3, warmup=1),
        fwd_library_ms=_cuda_ms(library_fwd),
        bwd_ms=_cuda_ms(lambda: flash_attention_bwd(*bwd_args)),
        bwd_plain_ms=_cuda_ms(lambda: flash_attention_bwd_reference(
            *bwd_args), iters=3, warmup=1),
        bwd_library_ms=_cuda_ms(library_bwd),
        sdpa_backend=_sdpa_backend(qh, kh, vh))
    return r


def _in_child(code):
    """Runs `code` (Python, with chip_smoke imported as `cs`) in a child
    process and returns its standard output; fails the phase if it raises.
    In this process, after the earlier phases, a profile can come back with
    no kernel events at all (B6b's did, twice, and B3f's first), while a
    fresh process's profile of the same call holds them."""
    return subprocess.run(
        [sys.executable, "-c", "import chip_smoke as cs; " + code],
        check=True, stdout=subprocess.PIPE, text=True, timeout=600,
        cwd=Path(__file__).resolve().parent).stdout


def _b3f_profiles():
    """bf16 B3f at kernel_flash's shape on the column slices of a packed
    projection and on three tensors, dropout 0.1 and 0, each call profiled:
    fails unless it runs the wgmma body and no bf16 scalar body."""
    from weathermodel_tpu_torch.ops.flash_attention import flash_attention_fwd
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(FORMER_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    qkv = torch.randn(FORMER_BATCH, SEQ_LEN, 3 * h, device="cuda",
                      generator=g).to(torch.bfloat16)
    slices = qkv.chunk(3, dim=-1)
    tensors = tuple(a.contiguous() for a in slices)
    for rate in (DROPOUT, 0.0):
        for layout, ops in (("slices", slices), ("tensors", tensors)):
            flash_attention_fwd(*ops, nh, rate, 7)  # warm-up
            _check_kernel_names(
                f"bf16 B3f on {layout}, dropout {rate}",
                [e.key for e in _profiled(
                    lambda: flash_attention_fwd(*ops, nh, rate, 7))],
                require=(FLASH_BODY,), forbid=(FLASH_SCALAR_BF16,))


def _ffma_profiles():
    """fp32 B3f (on the column slices of a packed projection and on three
    tensors) and B3b at kernel_flash's shape, and fp32 B2 at
    WeatherBERT-large's width, dropout 0.1 and 0, each call profiled: fails
    unless the FFMA bodies run and no fp32 scalar body does."""
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )
    from weathermodel_tpu_torch.ops.fused_qkv_attention import (
        fused_qkv_attention_bwd,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    forbid = (FLASH_SCALAR_FP32, *ATTN_BWD_SCALAR_FP32)
    cfg = model_config_for_size(FORMER_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    qkv = torch.randn(FORMER_BATCH, SEQ_LEN, 3 * h, device="cuda", generator=g)
    do = torch.randn(FORMER_BATCH, SEQ_LEN, h, device="cuda", generator=g)
    slices = qkv.chunk(3, dim=-1)
    tensors = tuple(a.contiguous() for a in slices)
    large = model_config_for_size(MODEL_SIZE)
    qkv_l = torch.randn(2, SEQ_LEN, 3 * large.hidden_dim, device="cuda",
                        generator=g)
    do_l = torch.randn(2, SEQ_LEN, large.hidden_dim, device="cuda",
                       generator=g)
    for rate in (DROPOUT, 0.0):
        calls = [(f"fp32 B3f on {layout}", (FLASH_FFMA,),
                  lambda ops=ops: flash_attention_fwd(*ops, nh, rate, 7))
                 for layout, ops in (("slices", slices),
                                     ("tensors", tensors))]
        calls += [("fp32 B3b", ATTN_BWD_FFMA,
                   lambda: flash_attention_bwd(*slices, do, nh, rate, 7)),
                  ("fp32 B2", ATTN_BWD_FFMA,
                   lambda: fused_qkv_attention_bwd(qkv_l, do_l,
                                                   large.num_heads, rate, 7))]
        for what, require, call in calls:
            call()  # warm-up
            _check_kernel_names(f"{what}, dropout {rate}",
                                [e.key for e in _profiled(call)],
                                require=require, forbid=forbid)


def _ffma_timings(b, t, h, nh, r=None):
    """fp32 B3f and B3b at (b, t, h, nh) on the FFMA bodies: kernel ms at
    dropout 0.1 and 0, SDPA ms (forward; forward and backward) at 0.1, the
    bounds and the shares of them, on seeded column slices of a packed
    projection; `r` (kernel_flash's timed fp32 case at that shape) supplies
    the 0.1 readings where given."""
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    qkv = torch.randn(b, t, 3 * h, device="cuda", generator=g)
    do = torch.randn(b, t, h, device="cuda", generator=g)
    q, k, v = qkv.chunk(3, dim=-1)
    if r is None:
        heads = [_heads(a, nh) for a in (q, k, v)]
        qh, kh, vh = (a.detach().requires_grad_() for a in heads)
        g_heads = _heads(do, nh)

        def library_bwd():
            out = F.scaled_dot_product_attention(qh, kh, vh, dropout_p=DROPOUT)
            return torch.autograd.grad(out, (qh, kh, vh), g_heads)

        def library_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(*heads,
                                                      dropout_p=DROPOUT)

        r = dict(
            fwd_ms=_cuda_ms(lambda: flash_attention_fwd(q, k, v, nh, DROPOUT,
                                                        7), iters=20),
            bwd_ms=_cuda_ms(lambda: flash_attention_bwd(q, k, v, do, nh,
                                                        DROPOUT, 7), iters=10),
            fwd_library_ms=_cuda_ms(library_fwd, iters=20),
            bwd_library_ms=_cuda_ms(library_bwd, iters=10))
    r = dict(r,
             fwd0_ms=_cuda_ms(lambda: flash_attention_fwd(q, k, v, nh, 0.0, 7),
                              iters=20),
             bwd0_ms=_cuda_ms(lambda: flash_attention_bwd(q, k, v, do, nh,
                                                          0.0, 7), iters=10),
             fwd_bound=_flash_bound(b, t, h, nh, torch.float32),
             bwd_bound=_bwd_bound(b, t, h, nh, torch.float32))
    text = []
    for name, key in (("B3f", "fwd"), ("B3b", "bwd")):
        ms, lib, (bound, by) = r[key + "_ms"], r[key + "_library_ms"], r[
            key + "_bound"]
        sdpa = "SDPA fwd+bwd" if key == "bwd" else "SDPA"
        text.append(f"{name} {ms:.3f} ms at dropout {DROPOUT}, "
                    f"{r[key + '0_ms']:.3f} at 0, {sdpa} {lib:.3f} (kernel "
                    f"at or below it: {ms <= lib}), bound {bound:.3f} by "
                    f"{by}, {bound / ms:.3f} of it")
    return f"B={b} T={t}: " + "; ".join(text)


def phase_kernel_flash():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(FORMER_SIZE)
    h, nh = cfg.hidden_dim, cfg.num_heads
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bound = 1.0 / h ** 0.5
    x = torch.randn(FORMER_BATCH, SEQ_LEN, h, device="cuda", generator=g)
    w = (torch.rand(3 * h, h, device="cuda", generator=g) * 2 - 1) * bound
    b = (torch.rand(3 * h, device="cuda", generator=g) * 2 - 1) * bound
    qkv = F.linear(x, w, b)  # the model's packed projection
    do = torch.randn(FORMER_BATCH, SEQ_LEN, h, device="cuda", generator=g)
    del x
    seed = 20260102
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        for rate in (DROPOUT, 0.0):
            results[dtype, rate] = _flash_case(qkv, do, nh, dtype, rate, seed,
                                               timed=rate == DROPOUT)
    lines = []
    for (dtype, rate), r in results.items():
        line = (f"{str(dtype).split('.')[1]} dropout {rate}: max|err| "
                f"{r['errs']}")
        if "fwd_ms" in r:
            r["fwd_bound"] = _flash_bound(FORMER_BATCH, SEQ_LEN, h, nh, dtype)
            r["bwd_bound"] = _bwd_bound(FORMER_BATCH, SEQ_LEN, h, nh, dtype)
            line += (
                f"; B3f kernel {r['fwd_ms']:.3f} ms, plain "
                f"{r['fwd_plain_ms']:.3f}, SDPA {r['fwd_library_ms']:.3f}, "
                f"bound {r['fwd_bound'][0]:.3f} by {r['fwd_bound'][1]}; B3b "
                f"kernel {r['bwd_ms']:.3f} ms, plain {r['bwd_plain_ms']:.3f}, "
                f"SDPA fwd+bwd {r['bwd_library_ms']:.3f}, bound "
                f"{r['bwd_bound'][0]:.3f} by {r['bwd_bound'][1]}; SDPA "
                f"backend {r['sdpa_backend']}")
        lines.append(line)
    _in_child("cs._b3f_profiles()")  # bf16 B3f's calls, profiled
    _in_child("cs._ffma_profiles()")  # fp32 B3f's, B3b's and B2's
    print("kernel_flash: " + _fwd_body_report(), flush=True)
    print("kernel_flash: " + _ffma_body_report(), flush=True)
    print("kernel_flash: " + _bwd_body_report("flash_attention_bwd"),
          flush=True)
    print(f"kernel_flash: B={FORMER_BATCH} T={SEQ_LEN} H={h} heads={nh} (tol "
          f"{KERNEL_TOL}, {SCALE_TOL} x max) | " + " | ".join(lines),
          flush=True)
    print(f"kernel_flash: bf16 B3b on its wgmma body at T={SEQ_LEN} "
          f"{results[torch.bfloat16, DROPOUT]['bwd_ms']:.3f} ms (recorded on "
          f"the scalar passes: {SCALAR_BWD_MS['B3b']} ms)", flush=True)
    print(f"kernel_flash: bf16 B3f on its wgmma body at T={SEQ_LEN} "
          f"{results[torch.bfloat16, DROPOUT]['fwd_ms']:.3f} ms (recorded on "
          f"the scalar body: {SCALAR_FWD_MS['B3f']} ms); on the slices and "
          f"on three tensors the profile shows {FLASH_BODY} and no "
          f"{FLASH_SCALAR_BF16}", flush=True)
    print(f"kernel_flash: fp32 on the FFMA bodies (recorded on the scalar "
          f"bodies at B={FORMER_BATCH} T={SEQ_LEN}, dropout {DROPOUT}: B3f "
          f"{SCALAR_FP32_MS['B3f']} ms, B3b {SCALAR_FP32_MS['B3b']} ms; the "
          f"profiles show {FLASH_FFMA} and {ATTN_BWD_FFMA} for B3f, B3b and "
          f"B2, and no fp32 scalar body) | "
          + _ffma_timings(FORMER_BATCH, SEQ_LEN, h, nh,
                          results[torch.float32, DROPOUT])
          + " | " + _ffma_timings(YIELD_BATCH, YIELD_T, h, nh), flush=True)
    for rate in (DROPOUT, 0.0):
        print(f"kernel_flash: B3f and B3b (o, dq, dk, dv) dropout {rate} "
              + _attention_edges(
                  "B3", lambda *a: _flash_edge_case(a, rate, seed, False),
                  lambda *a: _flash_edge_case(a, rate, seed, True), SEED + 25,
                  ATTN_BWD_EDGE_SHAPES), flush=True)
    return results[torch.bfloat16, DROPOUT]


def _flash_edge_case(args, rate, seed, plain: bool):
    """(o, dq, dk, dv) of B3f and B3b, or of their plain versions, on the
    column slices of the projection x . w^T + b."""
    from weathermodel_tpu_torch.ops import flash_attention as fa

    x, w, b, nh = args
    q, k, v = F.linear(x, w, b).chunk(3, dim=-1)
    g = torch.Generator(device="cuda").manual_seed(seed)
    do = torch.randn(x.shape, device="cuda", generator=g).to(x.dtype)
    fwd, bwd = ((fa.flash_attention_fwd_reference,
                 fa.flash_attention_bwd_reference) if plain else
                (fa.flash_attention_fwd, fa.flash_attention_bwd))
    return (fwd(q, k, v, nh, rate, seed), *bwd(q, k, v, do, nh, rate, seed))


def phase_train_former(smi: str, data: Path):
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(FORMER_SIZE, compute_dtype="bfloat16")
    n_train, n_val = _store_batches(data, FORMER_BATCH)
    with tempfile.TemporaryDirectory() as workdir:
        # the JAX CLI's defaults; --attention-impl left at auto
        result, launches, wall, peak_gb, record = _run_pretrain([
            "--model", "weatherformer", "--model-size", FORMER_SIZE,
            "--batch-size", str(FORMER_BATCH), "--n-masked-features", "10",
            "--beta", "0.5", "--compute-dtype", "bfloat16", "--n-epochs", "2",
            "--n-warmup-epochs", "0", "--data-dir", str(data),
            "--workdir", workdir, "--device", "cuda"], _all_kernels())
    steps = sum(len(s) for s in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    n = cfg.num_layers
    _check_launches(launches, {
        "fused_qkv_attention": 0, "fused_qkv_attention_train": 0,
        "fused_qkv_attention_bwd": 0,
        "flash_attention_fwd": n * (steps + val_batches),
        "flash_attention_bwd": n * steps, "gmm": 0, "tgmm": 0,
        **NOT_IN_TRAINING}, steps, val_batches)
    train_loss, val_loss = _check_record(
        record, ("total_loss", "reconstruction", "kl_term"))
    out_dim = 2 * cfg.output_dim
    ms, rate, tflops, gflop = _throughput(result, cfg, FORMER_BATCH, out_dim)
    kl = record["losses"]["train"]["kl_term"]
    print(f"train_former: wm-pretrain-torch WeatherFormer-{FORMER_SIZE} bf16 "
          f"--batch-size {FORMER_BATCH}, ELBO beta 0.5, 10 masked features, "
          f"dropout {cfg.dropout_rate}, 2 epochs, lr 5e-4: {n_train} train "
          f"batches and {n_val} validation windows per epoch; train loss "
          f"{train_loss} (kl_term {kl}), val loss {val_loss}; {launches}; "
          f"epoch 2 median {ms:.1f} ms/step, {rate:.1f} samples/s, "
          f"{tflops:.1f} TFLOP/s ({gflop:.2f} GFLOP/sample); epoch seconds "
          f"{record['metrics']['epoch_seconds']}; run {wall:.1f} s; peak "
          f"memory {peak_gb:.1f} GB; card {smi}", flush=True)
    print("train_former: " + _profile_step(
        "weatherformer", cfg, "flash", FORMER_BATCH,
        named=(("B3f (the bf16 forward body)", FLASH_BODY),
               ("B3b (the bf16 backward body)", ATTN_BWD_BODY)),
        require=(FLASH_BODY, ATTN_BWD_BODY),
        forbid=(FLASH_SCALAR_BF16, *ATTN_BWD_SCALAR_BF16)), flush=True)
    print("train_former: " + _check_step_parity("weatherformer", FORMER_SIZE,
                                                "flash"), flush=True)
    from weathermodel_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd,
    )

    print("train_former: " + _remat_step(
        "weatherformer", FORMER_SIZE, "flash", flash_attention_fwd,
        flash_attention_bwd), flush=True)
    return launches


def _former_argv(data: Path, workdir: Path, epochs: int, *extra):
    """`wm-pretrain-torch` with the JAX CLI's defaults at FORMER_BATCH, as
    in train_former."""
    return ["--model", "weatherformer", "--model-size", FORMER_SIZE,
            "--batch-size", str(FORMER_BATCH), "--compute-dtype", "bfloat16",
            "--n-epochs", str(epochs), "--n-warmup-epochs", "0",
            "--data-dir", str(data), "--workdir", str(workdir),
            "--device", "cuda", *extra]


def _load_run_files(workdir: Path, epoch: int):
    """(record, best.pth, epoch's checkpoint state) of a pretraining run."""
    with open(workdir / "weatherformer_output.json") as f:
        record = json.load(f)
    best = torch.load(workdir / "best.pth", weights_only=True)
    state = torch.load(workdir / "checkpoints" / str(epoch) / "state.pt",
                       weights_only=True)
    return record, best, state


def _check_bitwise(what, want, got):
    """Tensors of two nested dicts equal bit for bit, plain values equal."""
    if isinstance(want, dict):
        if want.keys() != got.keys():
            raise AssertionError(f"{what}: keys {sorted(want)} != "
                                 f"{sorted(got)}")
        for k in want:
            _check_bitwise(f"{what}/{k}", want[k], got[k])
    elif isinstance(want, torch.Tensor):
        if not (want.dtype == got.dtype and want.shape == got.shape
                and torch.equal(want, got)):
            raise AssertionError(f"{what}: differs after preempt + resume")
    elif want != got:
        raise AssertionError(f"{what}: {want} != {got}")


def _resume_profile(data: str):
    """Child-process part of phase_resume: 2 epochs with
    WEATHERMODEL_PROFILE_DIR set; fails unless epoch 1's Chrome trace names
    B3f's and B3b's bf16 bodies. Prints their kernel events' counts."""
    import os

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["WEATHERMODEL_PROFILE_DIR"] = str(Path(tmp) / "prof")
        result, _, _, _, _ = _run_pretrain(
            _former_argv(Path(data), Path(tmp) / "run", 2), ())
        (trace,) = (Path(tmp) / "prof").iterdir()
        mb = trace.stat().st_size / 1e6
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    _check_kernel_names(f"the profiler hook's trace {trace.name}",
                        sorted(set(kernels)),
                        require=(FLASH_BODY, ATTN_BWD_BODY))
    counts = {body: sum(body in k for k in kernels)
              for body in (FLASH_BODY, ATTN_BWD_BODY)}
    print(json.dumps({"trace": trace.name, "mb": mb, "counts": counts,
                      "steps": len(result["train_step_seconds"][1]),
                      "kernel_events": len(kernels)}))


def phase_resume(smi: str, data: Path):
    """Preempt and resume `wm-pretrain-torch` at train_former's
    configuration; the profiler hook; the MLP baseline."""
    from weathermodel_tpu_torch.testing import sigterm_during_step

    t_phase = time.perf_counter()
    epochs = 3
    with tempfile.TemporaryDirectory() as tmp:
        a, b = Path(tmp) / "a", Path(tmp) / "b"
        base, base_launches, base_wall, _, _ = _run_pretrain(
            _former_argv(data, a, epochs), _all_kernels())
        handler = signal.getsignal(signal.SIGTERM)
        with sigterm_during_step(epoch=1, step=3):
            pre, pre_launches, pre_wall, _, _ = _run_pretrain(
                _former_argv(data, b, epochs), _all_kernels())
        if pre.get("preempted") is not True:
            raise AssertionError(f"the SIGTERM did not preempt: {pre}")
        if signal.getsignal(signal.SIGTERM) is not handler:
            raise AssertionError("the trainer left its SIGTERM handler in")
        with open(b / "checkpoints" / "1" / "meta.json") as f:
            mid = json.load(f)["mid_epoch"]
        if mid["batch_idx"] != 3:
            raise AssertionError(f"preemption checkpoint at {mid}")
        res, res_launches, res_wall, _, _ = _run_pretrain(
            _former_argv(data, b, epochs, "--resume-from-checkpoint", str(b)),
            _all_kernels())
        if "preempted" in res:
            raise AssertionError(f"the resumed run stopped: {res}")
        want_record, want_best, want_state = _load_run_files(a, epochs - 1)
        got_record, got_best, got_state = _load_run_files(b, epochs - 1)
        _check_bitwise("output_json losses", want_record["losses"],
                       got_record["losses"])
        _check_bitwise("best.pth", want_best, got_best)
        _check_bitwise(f"checkpoint {epochs - 1}", want_state, got_state)
        ckpt_mb = (a / "checkpoints" / str(epochs - 1) /
                   "state.pt").stat().st_size / 1e6
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        if not base_launches[name] or not res_launches[name]:
            raise AssertionError(f"{name} not launched: {base_launches}, "
                                 f"{res_launches}")
    split = {k: pre_launches[k] + res_launches[k] for k in base_launches}
    if split != base_launches:
        raise AssertionError(f"launches over preempt + resume {split} != "
                             f"uninterrupted {base_launches}")
    boundary = [(s["epoch"], round(s["blocked_s"], 4), round(s["write_s"], 4))
                for s in base["checkpoint_saves"] if not s["wait"]]
    (preempt_save,) = [s for s in pre["checkpoint_saves"] if s["wait"]]
    losses = want_record["losses"]["train"]["total_loss"]
    print(f"resume: wm-pretrain-torch WeatherFormer-{FORMER_SIZE} bf16 "
          f"--batch-size {FORMER_BATCH}, {epochs} epochs: (a) uninterrupted "
          f"{base_wall:.1f} s, train loss {losses}; (b) SIGTERM in step 3 of "
          f"epoch 1 {pre_wall:.1f} s; (c) resumed {res_wall:.1f} s, losses, "
          f"best.pth and checkpoint {epochs - 1} (params, Adam moments and "
          f"step) bitwise equal to (a); B3f/B3b launches (a) "
          f"{base_launches['flash_attention_fwd']}/"
          f"{base_launches['flash_attention_bwd']} = (b) "
          f"{pre_launches['flash_attention_fwd']}/"
          f"{pre_launches['flash_attention_bwd']} + (c) "
          f"{res_launches['flash_attention_fwd']}/"
          f"{res_launches['flash_attention_bwd']}; checkpoint "
          f"{ckpt_mb:.3f} MB; background boundary saves (epoch, loop blocked "
          f"s, write s) {boundary}; preemption save "
          f"{preempt_save['blocked_s']:.4f} s; fast-forward "
          f"{res['fast_forward_seconds']:.4f} s; card {smi}", flush=True)
    print("resume: profiler hook (child process): "
          + _in_child(f"cs._resume_profile({str(data)!r})").strip(),
          flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        result, launches, wall, _, record = _run_pretrain([
            "--model", "mlp", "--batch-size", str(FORMER_BATCH),
            "--n-epochs", "2", "--n-warmup-epochs", "0", "--data-dir",
            str(data), "--workdir", tmp, "--device", "cuda"], _all_kernels())
    _check_launches(launches, dict.fromkeys(launches, 0),
                    sum(map(len, result["train_step_seconds"])),
                    sum(result["val_batches"]))
    train_loss, val_loss = _check_record(record, tuple(
        record["losses"]["train"]))
    print(f"resume: --model mlp, 2 epochs: train loss {train_loss}, val loss "
          f"{val_loss}, {wall:.1f} s; phase {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)


# the yield path: `wm-yield-torch` with the JAX CLI's defaults
# (weathermodel_tpu/cli/yield_main.py:91-122: WeatherFormer-small, ELBO, beta
# 1e-4, batch 64, fp32, --attention-impl auto) on the JAX package's synthetic
# Khaki frame at 1024 counties; 15 train years (the grid search's USA value)
# keep n_past_years 6, so T = 364, and test year 2016 gives 10240 training and
# 1024 test windows, 160 steps an epoch
YIELD_LOCS, YIELD_BATCH = 1024, 64
YIELD_ARGS = ["--country", "synthetic", "--n-train-years", "15",
              "--test-year", "2016", "--n-epochs", "2", "--use-optimal-lr"]
YIELD_T = 7 * 52
# the yield head's pooling-logit bias: the softmax over T is invariant to it,
# so its gradient is zero in exact arithmetic and rounding noise on both
# paths; the one-step comparison leaves it out
YIELD_SHIFT_INVARIANT = ("weather_attention.2.bias",)
# the fp32 FFMA bodies of B3f and of B2's and B3b's backward
# (csrc/attention_ffma.cuh), which every fp32 profile at T = 365 must show,
# and the fp32 scalar bodies they replaced there, which none may show
FLASH_FFMA = "attention_fwd_ffma_kernel"
ATTN_BWD_FFMA = ("attention_bwd_ffma_dq_kernel",
                 "attention_bwd_ffma_dkdv_kernel")
FLASH_SCALAR_FP32 = "flash_attention_kernel<float"
ATTN_BWD_SCALAR_FP32 = ("bwd_dq_kernel<float", "bwd_dkdv_kernel<float")


def _yield_encoder(root: Path) -> Path:
    """A seeded WeatherFormer-small saved by the port's trainer as a
    reference-format .pth."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.train.checkpoint import save_best_params
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    model = make_model("weatherformer", model_config_for_size(FORMER_SIZE),
                       "torch")
    model.reset_parameters(torch.Generator().manual_seed(SEED + 5))
    return Path(save_best_params(str(root), model))


def _yield_batch(n, device, seed):
    """n seeded windows of the yield layout (T = 364, the Khaki static
    mask, 7 past years) as a YieldBatch on `device`."""
    from weathermodel_tpu_torch.train.yield_trainer import YieldBatch

    rng = np.random.default_rng(seed)
    years = 7
    mask = np.ones((n, YIELD_T, N_FEATURES), dtype=bool)
    mask[:, :, [7, 8, 11, 1, 2, 29]] = False
    arrays = (rng.normal(size=(n, YIELD_T, N_FEATURES)),
              rng.uniform(30, 48, (n, 2)),
              2009.0 + np.arange(YIELD_T)[None] / 52 + np.zeros((n, 1)),
              np.full((n, 1), 7.0), mask, rng.normal(size=(n, years)),
              rng.normal(size=(n, 1)), np.ones(n),
              np.zeros((n, years, 11, 6)), np.zeros((n, years, 14)))
    return YieldBatch(*(torch.tensor(a, device=device, dtype=torch.bool
                                     if a.dtype == bool else torch.float32)
                        for a in arrays))


def _yield_model(impl, dtype: str, device):
    from weathermodel_tpu_torch.models.yield_models import (
        WeatherFormerYieldModel,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(FORMER_SIZE, max_len=YIELD_T,
                                compute_dtype=dtype)
    model = WeatherFormerYieldModel(cfg, 6, impl)
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    return model.to(device)


def _kernel_name(key: str) -> str:
    """A profiled kernel's name without its return type, anonymous
    namespace and arguments."""
    key = key.replace("void ", "").replace("(anonymous namespace)::", "")
    return key.split("(")[0][:70]


def _yield_profile(dtype: str, require=(), forbid=()):
    """torch.profiler over one yield train step (WeatherFormer-small, ELBO,
    batch 64, T = 364, dropout 0.1) after a warm-up step: prints device
    time by kernel, the device's busy share, and B3f's and B3b's device
    time (every kernel of their wrappers) with their share of the step's."""
    from weathermodel_tpu_torch.train.state import make_optimizer
    from weathermodel_tpu_torch.train.yield_trainer import (
        make_yield_train_step,
    )

    model = _yield_model("flash", dtype, "cuda")
    step = make_yield_train_step(model, make_optimizer(model), "elbo", 1e-4)
    batch = _yield_batch(YIELD_BATCH, "cuda", SEED + 6)
    gen = torch.Generator().manual_seed(SEED)
    float(step(batch, gen, 1e-4)["total_loss"])  # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        float(step(batch, gen, 1e-4)["total_loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _kernel_events(prof)
    _check_kernel_names(f"{dtype} yield step", [e.key for e in events],
                        require, forbid)
    total = sum(_device_ms(e) for e in events)
    fwd_keys = (FLASH_BODY, FLASH_FFMA, FLASH_SCALAR_FP32, FLASH_SCALAR_BF16)
    bwd_keys = (ATTN_BWD_BODY, *ATTN_BWD_FFMA, *ATTN_BWD_SCALAR_FP32,
                *ATTN_BWD_SCALAR_BF16)
    parts = {}
    for label, keys in (("B3f", fwd_keys), ("B3b", bwd_keys)):
        hit = [e for e in events if any(k in e.key for k in keys)]
        parts[label] = (sum(_device_ms(e) for e in hit),
                        sum(e.count for e in hit),
                        sorted({_kernel_name(e.key) for e in hit}))
    top = ", ".join(f"{e.key[:60]} {_device_ms(e):.2f} ms x{e.count}"
                    for e in events[:10])
    share = "; ".join(f"{label} {ms:.3f} ms x{n} ({ms / total:.3f} of the "
                      f"step's device time; kernels {names})"
                      for label, (ms, n, names) in parts.items())
    print(f"yield: profile of one {dtype} step at batch {YIELD_BATCH}, "
          f"T={YIELD_T}: kernels {total:.2f} ms of device time in "
          f"{wall_ms:.2f} ms profiled (busy {total / wall_ms:.2f}); {share}; "
          f"B3f + B3b {(parts['B3f'][0] + parts['B3b'][0]) / total:.3f} of "
          f"it; top: {top}", flush=True)


def _yield_step_parity(dtype: str):
    """One yield train step of the flash kernel path against the plain
    attention path at STEP_WINDOWS windows, the same weights, batch and eps,
    dropout off (as _step_parity): (loss rel diff, worst gradient rel diff
    outside YIELD_SHIFT_INVARIANT, its parameter, fp32's plain card-vs-CPU
    floor)."""
    from weathermodel_tpu_torch.train.state import make_optimizer
    from weathermodel_tpu_torch.train.yield_trainer import (
        make_yield_train_step,
    )

    cpu_batch = _yield_batch(STEP_WINDOWS, "cpu", SEED + 7)
    eps = torch.randn(cpu_batch.weather.shape,
                      generator=torch.Generator().manual_seed(SEED + 8))
    runs = [("flash", "cuda"), ("torch", "cuda")]
    if dtype == "float32":
        runs.append(("torch", "cpu"))
    models, losses = [], []
    for impl, device in runs:
        model = _yield_model(impl, dtype, device)
        step = make_yield_train_step(model, make_optimizer(model), "elbo",
                                     1e-4)
        batch = type(cpu_batch)(*(a.to(device) for a in cpu_batch))
        out = step(batch, torch.Generator().manual_seed(SEED), 0.0,
                   eps=eps.to(device), dropout_rate=0.0)
        models.append(model)
        losses.append(float(out["total_loss"]))
    loss_rel = abs(losses[0] - losses[1]) / abs(losses[1])
    floor = (_grad_rel(models[1], models[2], YIELD_SHIFT_INVARIANT)[0]
             if len(models) > 2 else None)
    return (loss_rel, *_grad_rel(models[0], models[1], YIELD_SHIFT_INVARIANT),
            floor)


def _run_yield(argv, crop_df, counted):
    """`wm-yield-torch`'s run(args) on argv and the frame `crop_df`, with
    every wrapper in `counted` set to 0 just before: (result, launches by
    wrapper name, wall seconds, peak GB)."""
    from weathermodel_tpu_torch.cli import yield_main

    args = yield_main.build_parser().parse_args(argv)
    args.crop_df = crop_df
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = yield_main.run(args)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    return result, launches, wall, torch.cuda.max_memory_allocated() / 1e9


def _check_yield_run(dtype, result, launches):
    """The run's launch counts (4 B3f and 4 B3b a training step, the LR
    range test's included; 4 B3f a validation batch; nothing else), finite
    losses, a falling train loss and a finite RMSE and R^2: (trainer,
    training steps, range-test steps, validation batches)."""
    (trainer,) = result["trainers"]
    steps = sum(len(s) for s in trainer.train_step_seconds)
    finder = len(trainer.lr_range[0])
    val_batches = len(trainer.train_step_seconds) * -(
        -trainer.test_arrays.weather.shape[0] // YIELD_BATCH)
    n = trainer.model.cfg.num_layers
    _check_launches(launches, {
        "fused_qkv_attention": 0, "fused_qkv_attention_train": 0,
        "fused_qkv_attention_bwd": 0,
        "flash_attention_fwd": n * (steps + finder + val_batches),
        "flash_attention_bwd": n * (steps + finder), "gmm": 0, "tgmm": 0,
        **NOT_IN_TRAINING}, steps + finder, val_batches)
    history = trainer.loss_history
    for scope, keys in (("train", ("total_loss", "yield", "kl_term")),
                        ("val", ("total_loss",))):
        for k in keys:
            if not np.all(np.isfinite(history[scope][k])):
                raise AssertionError(f"{dtype} yield: non-finite {scope} "
                                     f"{k}: {history[scope][k]}")
    train_loss = history["train"]["total_loss"]
    if not train_loss[1] < train_loss[0]:
        raise AssertionError(f"{dtype} yield: train loss did not fall: "
                             f"{train_loss}")
    if not (np.isfinite(result["avg_rmse_bu_acre"])
            and np.isfinite(result["avg_r_squared"])):
        raise AssertionError(f"{dtype} yield: RMSE "
                             f"{result['avg_rmse_bu_acre']}, R^2 "
                             f"{result['avg_r_squared']}")
    return trainer, steps, finder, val_batches


def phase_yield(smi: str, tmp: Path):
    from weathermodel_tpu_torch.cli import cropnet_main
    from weathermodel_tpu_torch.data.cropnet_data import synthetic_cropnet_df
    from weathermodel_tpu_torch.data.yield_data import synthetic_yield_df

    t0 = time.perf_counter()
    crop_df = synthetic_yield_df(seed=SEED, n_locs=YIELD_LOCS)
    frame_s = time.perf_counter() - t0
    encoder = _yield_encoder(tmp / "yield_encoder")
    runs = {}
    for dtype in ("float32", "bfloat16"):
        argv = YIELD_ARGS + ["--pretrained-model-path", str(encoder),
                             "--compute-dtype", dtype, "--device", "cuda"]
        result, launches, wall, peak_gb = _run_yield(argv, crop_df,
                                                     _all_kernels())
        trainer, steps, finder, val_batches = _check_yield_run(
            dtype, result, launches)
        n_train = trainer.train_arrays.weather.shape[0]
        n_test = trainer.test_arrays.weather.shape[0]
        ms = float(np.median(trainer.train_step_seconds[-1])) * 1e3
        rate = n_train / trainer.train_pass_seconds[-1]
        runs[dtype] = launches
        print(f"yield: wm-yield-torch WeatherFormer-{FORMER_SIZE} {dtype} "
              f"ELBO beta 1e-4, batch {YIELD_BATCH}, T={YIELD_T}, attention "
              f"auto, {' '.join(YIELD_ARGS)}, from a seeded .pth, on the "
              f"synthetic frame of {YIELD_LOCS} counties (built in "
              f"{frame_s:.1f} s): {n_train} training and {n_test} test "
              f"windows, {steps} steps + {finder} of the LR range test "
              f"(optimal lr {trainer.optimal_lr:.3e}), {val_batches} "
              f"validation batches; train loss "
              f"{trainer.loss_history['train']['total_loss']}, val RMSE "
              f"{trainer.loss_history['val']['total_loss']}; RMSE "
              f"{result['avg_rmse_bu_acre']:.4f} bu/acre, R^2 "
              f"{result['avg_r_squared']:.4f}; {launches}; epoch 2 median "
              f"{ms:.2f} ms/step, {rate:.1f} windows/s over epoch 2's "
              f"training pass ({trainer.train_pass_seconds[-1]:.2f} s); the "
              f"fold {wall:.1f} s; peak memory {peak_gb:.2f} GB; card {smi}",
              flush=True)
    # profiled in child processes, as _in_child says why
    print(_in_child(
        f"cs._yield_profile('float32', require=({FLASH_FFMA!r}, "
        f"*{ATTN_BWD_FFMA!r}), forbid=({FLASH_SCALAR_FP32!r}, "
        f"*{ATTN_BWD_SCALAR_FP32!r}))"), end="", flush=True)
    print(_in_child(
        f"cs._yield_profile('bfloat16', require=({FLASH_BODY!r}, "
        f"{ATTN_BWD_BODY!r}), forbid=({FLASH_SCALAR_BF16!r}, "
        f"*{ATTN_BWD_SCALAR_BF16!r}))"), end="", flush=True)
    parity = {}
    for dtype in ("float32", "bfloat16"):
        parity[dtype] = _yield_step_parity(dtype)
        loss_rel, grad_rel, _, _ = parity[dtype]
        tol = STEP_TOL[dtype]
        if loss_rel > tol["loss"] or grad_rel > tol.get("grad", np.inf):
            raise AssertionError(
                f"yield {dtype}: one step, kernel path vs plain path (loss "
                f"rel, worst gradient, its parameter) {parity[dtype]}, bars "
                f"{tol}")
    print(f"yield: one step at {STEP_WINDOWS} windows, flash kernel path vs "
          "plain path, dropout off, eps injected, (loss rel, worst gradient "
          "||diff||/||grad||, its parameter, the plain path's card-vs-CPU "
          f"worst gradient diff): {parity}; bars {STEP_TOL}", flush=True)

    counted = _all_kernels()
    for fn in counted:
        fn.launches = 0
    args = cropnet_main.build_parser().parse_args(
        ["--country", "synthetic", "--crop-type", "Corn", "--device",
         "cuda"])
    args.cropnet_df = synthetic_cropnet_df(seed=SEED)
    t0 = time.perf_counter()
    crops = cropnet_main.run(args)
    crop_s = time.perf_counter() - t0
    if crops.get("Corn") is None:
        raise AssertionError(f"wm-cropnet-torch Corn failed: {crops}")
    print(f"yield: wm-cropnet-torch --crop-type Corn with the CropNet "
          f"defaults (mini, 4 train years, 3 past years, attention auto) on "
          f"the synthetic CropNet frame: RMSE {crops['Corn'][0]:.4f} in "
          f"{crop_s:.1f} s; "
          f"{ {fn.__name__: fn.launches for fn in counted if fn.launches} }",
          flush=True)
    return crop_df


# grouped-matmul edge cases (rows per group): boundaries inside a 128-row
# tile, empty first/middle/last groups, S not a multiple of 128, tiny groups
# sharing one tile; at (K, N) = (80, 200), partial slabs and tiles
GMM_EDGE_GROUPS = [[100, 60, 96], [0, 256, 0], [128, 0, 44, 128],
                   [1, 1, 1, 127], [0, 333, 0, 367, 0]]
GMM_EDGE_DIMS = (80, 200)


def _moe_group_sizes(cfg, windows=MOE_MICRO):
    """The per-expert row counts of a MoE microbatch: a top-2 routing of
    `windows` windows of seeded activations through a seeded router, on the
    device."""
    from weathermodel_tpu_torch.models.moe import MoEFFN, ragged_routing

    ffn = MoEFFN(cfg.hidden_dim, cfg.ffn_dim, cfg.num_experts, cfg.moe_top_k)
    ffn.reset_parameters(torch.Generator().manual_seed(SEED))
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.randn(windows, SEQ_LEN, cfg.hidden_dim, device="cuda",
                    generator=g)
    with torch.no_grad():
        idx = ffn.cuda().route(x)[3]
    return ragged_routing(idx.reshape(windows, -1), cfg.num_experts)[2]


def _gmm_library(op, lhs, other, gs):
    """One PyTorch call computing what B4 ("gmm", "gmm_t" for rhs^T) or B4t
    ("tgmm") computes, timed beside the kernel and never the port's path:
    torch._grouped_mm where it takes the inputs (bf16), else one cuBLAS
    matmul per group with the sizes read here, outside the timed region.
    Returns (fn, its name)."""
    ends = torch.cumsum(gs, 0).to(torch.int32)
    grouped = {"gmm": lambda: torch._grouped_mm(lhs, other, offs=ends),
               "gmm_t": lambda: torch._grouped_mm(
                   lhs, other.transpose(1, 2), offs=ends),
               "tgmm": lambda: torch._grouped_mm(lhs.t(), other, offs=ends)}
    if hasattr(torch, "_grouped_mm") and lhs.dtype == torch.bfloat16:
        try:
            grouped[op]()
            torch.cuda.synchronize()
            return grouped[op], "torch._grouped_mm"
        except RuntimeError as err:
            print(f"kernel_gmm: torch._grouped_mm refused {op}: "
                  f"{str(err).splitlines()[0]}", flush=True)
    bounds = torch.cat([ends.new_zeros(1), ends]).tolist()
    slices = list(zip(range(len(gs)), bounds[:-1], bounds[1:]))
    loops = {"gmm": lambda: torch.cat([lhs[a:b] @ other[e]
                                       for e, a, b in slices]),
             "gmm_t": lambda: torch.cat([lhs[a:b] @ other[e].T
                                         for e, a, b in slices]),
             "tgmm": lambda: torch.stack([lhs[a:b].T @ other[a:b]
                                          for _, a, b in slices])}
    return loops[op], "a cuBLAS matmul per group"


def _gmm_cases(s, k, n, e, dtype, seed):
    """The B4/B4t calls of one MoE layer's training step, on seeded inputs
    of the layer's shapes: name -> (op, lhs, other). fwd1/fwd2 are the two
    expert matmuls, dlhs1/dlhs2 their d_lhs (B4 against rhs^T), dw1/dw2
    their weight gradients (B4t). Activations are N(0, 1), weights
    U(+-1/sqrt(fan_in)) and cotangents N(0, E/S): a mean loss's gradient is
    small, and at that scale the weight gradients, sums over S/E rows, come
    out O(1) like the forward's outputs, the scale KERNEL_TOL is set for."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(dtype)

    def uniform(fan_in, *shape):
        return ((torch.rand(*shape, device="cuda", generator=g) * 2 - 1)
                / fan_in ** 0.5).to(dtype)

    x, hdn = normal(s, k), normal(s, n)
    dhdn, dout = ((torch.randn(s, c, device="cuda", generator=g)
                   * (e / s) ** 0.5).to(dtype) for c in (n, k))
    w1, w2 = uniform(k, e, k, n), uniform(n, e, n, k)
    return {"fwd1": ("gmm", x, w1), "fwd2": ("gmm", hdn, w2),
            "dlhs1": ("gmm_t", dhdn, w1), "dlhs2": ("gmm_t", dout, w2),
            "dw1": ("tgmm", x, dhdn), "dw2": ("tgmm", hdn, dout)}


def _gmm_call(op, lhs, other, gs, plain=False):
    from weathermodel_tpu_torch.ops.gmm import (
        gmm,
        gmm_reference,
        tgmm,
        tgmm_reference,
    )

    if op == "tgmm":
        return (tgmm_reference if plain else tgmm)(lhs, other, gs)
    return (gmm_reference if plain else gmm)(lhs, other, gs,
                                             trans_rhs=op == "gmm_t")


def _gmm_bound(op, lhs, other, e, dtype):
    """The least time of one call: 2 S K N operations; it reads lhs and the
    other operand once and writes the output ([S, N], or [E, K, N] for B4t)
    once."""
    s, k = lhs.shape
    if op == "tgmm":
        n = other.shape[1]
        out = e * k * n
    else:
        n = other.shape[1] if op == "gmm_t" else other.shape[2]
        out = s * n
    return _bound(2.0 * s * k * n,
                  (lhs.numel() + other.numel() + out) * dtype.itemsize, dtype)


def phase_kernel_gmm():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, **MOE)
    gs = _moe_group_sizes(cfg)
    s, e = int(gs.sum()), cfg.num_experts
    results = {}
    print(f"kernel_gmm: S={s} (top-2 routing of {MOE_MICRO} x {SEQ_LEN} "
          f"seeded windows, group sizes {gs.tolist()}), E={e}, K x N = "
          f"{cfg.hidden_dim} x {cfg.ffn_dim} and back (tol {KERNEL_TOL}, "
          f"{SCALE_TOL} x max)", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        cases = _gmm_cases(s, cfg.hidden_dim, cfg.ffn_dim, e, dtype, SEED + 5)
        for name, (op, lhs, other) in cases.items():
            got = _gmm_call(op, lhs, other, gs)
            want = _gmm_call(op, lhs, other, gs, plain=True)
            torch.cuda.synchronize()
            err = _check_kernel(f"{name} {dtype}", got, want, dtype)
            del got, want
            library, library_name = _gmm_library(op, lhs, other, gs)
            r = dict(op=op, err=err,
                     bound=_gmm_bound(op, lhs, other, e, dtype),
                     ms=_cuda_ms(lambda: _gmm_call(op, lhs, other, gs)),
                     plain_ms=_cuda_ms(lambda: _gmm_call(op, lhs, other, gs,
                                                         plain=True)),
                     library_ms=_cuda_ms(library), library=library_name)
            results[dtype, name] = r
            print(f"kernel_gmm: {str(dtype).split('.')[1]} {name} ({op}): "
                  f"max|err| {_errs_text({'out': err})}; kernel "
                  f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f}, "
                  f"{library_name} {r['library_ms']:.3f}, bound "
                  f"{r['bound'][0]:.3f} by {r['bound'][1]}", flush=True)
        del cases
        torch.cuda.empty_cache()
    edge = []
    for dtype in (torch.float32, torch.bfloat16):
        for groups in GMM_EDGE_GROUPS:
            gsz = torch.tensor(groups, device="cuda")
            cases = _gmm_cases(sum(groups), *GMM_EDGE_DIMS, len(groups),
                               dtype, SEED + 6)
            for name, (op, lhs, other) in cases.items():
                got = _gmm_call(op, lhs, other, gsz)
                want = _gmm_call(op, lhs, other, gsz, plain=True)
                torch.cuda.synchronize()
                edge.append(_check_kernel(f"edge {groups} {name} {dtype}",
                                          got, want, dtype)[0])
                if op == "tgmm":
                    for g, size in enumerate(groups):
                        if size == 0 and torch.count_nonzero(got[g]):
                            raise AssertionError(f"edge {groups}: B4t wrote "
                                                 f"non-zeros for empty group "
                                                 f"{g}")
    print(f"kernel_gmm: edge cases, {len(edge)} checks of {GMM_EDGE_GROUPS} "
          f"at K x N = {GMM_EDGE_DIMS} in fp32 and bf16: max|err| "
          f"{max(edge):.3g}", flush=True)

    def record(ops):
        """Mean per call over a layer's calls of the kernel, bf16."""
        rs = [r for (d, _), r in results.items()
              if d == torch.bfloat16 and r["op"] in ops]
        mean = {key: sum(r[key] for r in rs) / len(rs)
                for key in ("ms", "plain_ms", "library_ms")}
        return dict(max_abs_err=max(r["err"][0] for r in rs),
                    bound_ms=sum(r["bound"][0] for r in rs) / len(rs),
                    bound_by=rs[0]["bound"][1], **mean)

    b4, b4t = record(("gmm", "gmm_t")), record(("tgmm",))
    print(f"kernel_gmm: bf16 on the wgmma body: B4 {b4['ms']:.3f} ms a call "
          f"(mean of 4; {WMMA_GMM_MS['B4']} on the WMMA tiles), B4t "
          f"{b4t['ms']:.3f} ({WMMA_GMM_MS['B4t']})", flush=True)
    return b4, b4t


def _check_moe_no_host_sync(cfg):
    """One training forward and backward of the MoE kernel path at full
    width, STEP_WINDOWS windows, dropout on, under torch's sync debug mode
    "error": any operation that waits on the host (a group size read back,
    a `bincount` or `nonzero` in the routing) raises."""
    from weathermodel_tpu_torch.train.steps import batch_to_device

    model, _ = _train_step_fn("weatherbert", cfg, "fused_qkv", "cuda")
    batch, mask = _windows_batch(STEP_WINDOWS, SEED + 3)
    batch = batch_to_device(batch, "cuda")
    mask = torch.from_numpy(mask).to("cuda")
    model.train()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = model(*batch[:4], mask,
                         generator=torch.Generator().manual_seed(SEED),
                         return_moe_aux=True)
        (out.square().mean() + cfg.moe_aux_weight * aux).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return (f"one training forward and backward at {STEP_WINDOWS} windows "
            "under torch.cuda.set_sync_debug_mode('error'): no host sync")


def phase_train_moe(smi: str, data: Path):
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16", **MOE)
    n_train, n_val = _store_batches(data, MOE_BATCH)
    with tempfile.TemporaryDirectory() as workdir:
        result, launches, wall, peak_gb, record = _run_pretrain([
            "--model", "weatherbert", "--model-size", MODEL_SIZE,
            "--moe-experts", str(cfg.num_experts), "--moe-top-k",
            str(cfg.moe_top_k), "--batch-size", str(MOE_BATCH),
            "--grad-accum", str(MOE_ACCUM), "--n-epochs", "2",
            "--n-warmup-epochs", "0", "--masking-prob", "0.15",
            "--data-dir", str(data), "--workdir", workdir,
            "--compute-dtype", "bfloat16", "--device", "cuda"], _all_kernels())
    steps = sum(len(s) for s in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    per_step = MOE_ACCUM * cfg.num_layers
    _check_launches(launches, {
        "fused_qkv_attention": cfg.num_layers * val_batches,
        "fused_qkv_attention_train": per_step * steps,
        "fused_qkv_attention_bwd": per_step * steps,
        "flash_attention_fwd": 0, "flash_attention_bwd": 0,
        "gmm": 4 * per_step * steps + 2 * cfg.num_layers * val_batches,
        "tgmm": 2 * per_step * steps, **NOT_IN_TRAINING}, steps,
        val_batches)
    train_loss, val_loss = _check_record(record, ("total_loss", "moe_aux"))
    ms, rate, tflops, gflop = _throughput(result, cfg, MOE_BATCH)
    aux = record["losses"]["train"]["moe_aux"]
    print(f"train_moe: wm-pretrain-torch WeatherBERT-{MODEL_SIZE} MoE "
          f"E={cfg.num_experts} top-{cfg.moe_top_k} ragged bf16 --batch-size "
          f"{MOE_BATCH} --grad-accum {MOE_ACCUM}, dropout {cfg.dropout_rate}, "
          f"2 epochs, lr 5e-4: {n_train} train batches and {n_val} validation "
          f"windows per epoch; train loss {train_loss} (moe_aux {aux}), val "
          f"loss {val_loss}; {launches}; epoch 2 median {ms:.1f} ms/step, "
          f"{rate:.1f} samples/s, {tflops:.1f} TFLOP/s ({gflop:.1f} "
          f"GFLOP/sample); epoch seconds {record['metrics']['epoch_seconds']}"
          f"; run {wall:.1f} s; peak memory {peak_gb:.1f} GB; card {smi}",
          flush=True)
    print("train_moe: " + _profile_step(
        "weatherbert", cfg, "fused_qkv", MOE_BATCH, MOE_ACCUM,
        named=(("B1 train (the bf16 body)", ATTN_BODY),
               ("B2 (the bf16 backward body)", ATTN_BWD_BODY),
               ("B4 (the bf16 grouped-matmul body)", GMM_BODY),
               ("B4t (the bf16 grouped-matmul body)", TGMM_BODY)),
        require=(ATTN_BODY, ATTN_BWD_BODY, GMM_BODY, TGMM_BODY),
        forbid=(ATTN_SCALAR_BF16, *ATTN_BWD_SCALAR_BF16, *GMM_TILES_BF16)),
        flush=True)
    print("train_moe: " + _check_step_parity("weatherbert", MODEL_SIZE,
                                             "fused_qkv", MOE), flush=True)
    print("train_moe: " + _check_moe_no_host_sync(cfg), flush=True)
    return launches


# the bench microbatch's FFN rows (2 x 288 windows of 365 steps: 288 x 365)
# and the edge shapes (M, H, F): M not a multiple of the 32-row block (fp32)
# or of the 64-row block (bf16: 65 = 64 + 1), H and F not multiples of 16 or
# 128; the last at the widest H the kernels take
FFN_ROWS = MICRO * SEQ_LEN
FFN_EDGE_SHAPES = [(1001, 200, 800), (333, 48, 192), (65, 576, 2304),
                   (97, 640, 2560)]
# the bf16 FFN bodies' kernel symbols (B7 and B6f; B6b's row work), and the
# row kernel's, which no bf16 FFN kernel launches any more
FFN_BODY, FFN_BWD_BODY = "ffn_wgmma_kernel", "ffn_bwd_wgmma_kernel"
FFN_ROWS_KERNEL = "ffn_rows_kernel"
FFN_SEEDS = (20260103, 20260104)


def _ffn_inputs(m, h, f, dtype, seed):
    """x [m, h] N(0, 1), weights and biases U(+-1/sqrt(fan_in)) (fp32
    vectors), LN scale 1 + 0.1 N, bias 0.1 N, and a cotangent N(0, 1/m), a
    mean loss's scale, at which the weight gradients (sums over m rows) come
    out O(1) like the other outputs, the scale KERNEL_TOL is set for."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    def uniform(fan_in, *shape):
        return (torch.rand(*shape, device="cuda", generator=g) * 2 - 1) \
            / fan_in ** 0.5

    return dict(x=normal(m, h).to(dtype), w1=uniform(h, h, f).to(dtype),
                b1=uniform(h, f), w2=uniform(f, f, h).to(dtype),
                b2=uniform(f, h), ls=1 + normal(h, scale=0.1),
                lb=normal(h, scale=0.1),
                do=normal(m, h, scale=m ** -0.5).to(dtype))


def _ffn_bounds(m, h, f, dtype):
    """(B6f, B6b, B7 with its hidden output) bounds: 4 M H F operations
    forward, 12 backward; each reads x and the parameters once and writes
    its outputs once (B6b also reads do and writes dx and the parameters'
    gradients; B7 writes f and h)."""
    e = dtype.itemsize
    params = 2 * h * f * e + (f + 3 * h) * 4
    flops = 4.0 * m * h * f
    return dict(
        fwd_bound=_bound(flops, 2 * m * h * e + params, dtype),
        bwd_bound=_bound(3 * flops, 3 * m * h * e + 2 * params, dtype),
        b7_bound=_bound(flops, (2 * m * h + m * f) * e + params - 2 * h * 4,
                        dtype))


def _ffn_yardstick(t, train: bool, ln: bool):
    """The port's "torch" FFN in the compute dtype on the same inputs (no
    dropout): F.linear, ReLU, F.linear, and for B6 the residual and
    F.layer_norm; with `train`, forward and autograd backward. Timed beside
    the kernels, never the port's path."""
    dtype = t["x"].dtype
    w1, w2 = t["w1"].T.contiguous(), t["w2"].T.contiguous()
    b1, b2 = t["b1"].to(dtype), t["b2"].to(dtype)
    leaves = [a.detach().requires_grad_(train) for a in (t["x"], w1, w2)]

    def run():
        x, a, b = leaves
        y = F.linear(F.relu(F.linear(x, a, b1)), b, b2)
        if ln:
            y = F.layer_norm(x + y, y.shape[-1:], t["ls"].to(dtype),
                             t["lb"].to(dtype), 1e-5)
        if train:
            return torch.autograd.grad(y, leaves, t["do"])
        return y

    return run


def _ffn_case(t, rate, timed: bool):
    """B6f, B6b and B7 (with and without h) against their plain versions on
    one set of inputs."""
    from weathermodel_tpu_torch.ops.fused_ffn import (
        fused_ffn,
        fused_ffn_reference,
    )
    from weathermodel_tpu_torch.ops.fused_ffn_ln import (
        fused_ffn_ln,
        fused_ffn_ln_bwd,
        fused_ffn_ln_bwd_reference,
        fused_ffn_ln_reference,
    )

    dtype = t["x"].dtype
    ln_args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["ls"], t["lb"])
    ffn_args = ln_args[:5]
    bwd_args = (*ln_args, t["do"])
    errs = {"out": _check_kernel(
        f"B6f {dtype} dropout {rate}", fused_ffn_ln(*ln_args, rate, FFN_SEEDS),
        fused_ffn_ln_reference(*ln_args, rate, FFN_SEEDS), dtype)}
    got = fused_ffn_ln_bwd(*bwd_args, rate, FFN_SEEDS)
    want = fused_ffn_ln_bwd_reference(*bwd_args, rate, FFN_SEEDS)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2", "dls", "dlb"),
                          got, want):
        errs[name] = _check_kernel(f"B6b {name} {dtype} dropout {rate}", a,
                                   b, dtype)
    del got, want
    f_k, h_k = fused_ffn(*ffn_args, rate, FFN_SEEDS, want_h=True)
    f_p, h_p = fused_ffn_reference(*ffn_args, rate, FFN_SEEDS, True)
    errs["f"] = _check_kernel(f"B7 f {dtype} dropout {rate}", f_k, f_p, dtype)
    errs["h"] = _check_kernel(f"B7 h {dtype} dropout {rate}", h_k, h_p, dtype)
    f_only = fused_ffn(*ffn_args, rate, FFN_SEEDS)
    torch.cuda.synchronize()
    if f_only[1] is not None or not torch.equal(f_only[0], f_k):
        raise AssertionError("B7 without its hidden output differs from B7 "
                             "with it")
    del f_k, h_k, f_p, h_p, f_only
    r = dict(fwd_err=errs["out"][0],
             bwd_err=max(errs[n][0] for n in ("dx", "dw1", "db1", "dw2",
                                               "db2", "dls", "dlb")),
             b7_err=max(errs["f"][0], errs["h"][0]), errs=_errs_text(errs))
    if not timed:
        return r
    torch.cuda.empty_cache()
    r.update(
        fwd_ms=_cuda_ms(lambda: fused_ffn_ln(*ln_args, rate, FFN_SEEDS)),
        fwd_plain_ms=_cuda_ms(lambda: fused_ffn_ln_reference(
            *ln_args, rate, FFN_SEEDS), iters=3, warmup=1),
        fwd_library_ms=_cuda_ms(_ffn_yardstick(t, False, True)),
        bwd_ms=_cuda_ms(lambda: fused_ffn_ln_bwd(*bwd_args, rate, FFN_SEEDS)),
        bwd_plain_ms=_cuda_ms(lambda: fused_ffn_ln_bwd_reference(
            *bwd_args, rate, FFN_SEEDS), iters=3, warmup=1),
        bwd_library_ms=_cuda_ms(_ffn_yardstick(t, True, True)),
        b7_ms=_cuda_ms(lambda: fused_ffn(*ffn_args, rate, FFN_SEEDS,
                                         want_h=True)),
        b7_plain_ms=_cuda_ms(lambda: fused_ffn_reference(
            *ffn_args, rate, FFN_SEEDS, True), iters=3, warmup=1),
        b7_library_ms=_cuda_ms(_ffn_yardstick(t, False, False)),
        b7_eval_ms=_cuda_ms(lambda: fused_ffn(*ffn_args, rate, FFN_SEEDS)))
    return r


def _ffn_body_ptxas(h):
    """The bf16 bodies' ptxas report (registers and spills of each
    instantiation: B7 and B6f, and B6b's row body) and their dynamic shared
    memory by width (B6b's at F = 4 H)."""
    import re

    from weathermodel_tpu_torch.kernels import build

    built = build.load_library()
    lines = built.ptxas_log.splitlines()
    report = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '.*(?:" + FFN_BODY +
                      r"ILi(\d)E|" + FFN_BWD_BODY + r"I)Li(\d+)E", line)
        if m is None:
            continue
        block = []
        for nxt in lines[i + 1:i + 6]:
            if "Compiling entry" in nxt:
                break
            block.append(nxt)
        block = " ".join(block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        kernel = ("B6b" if m.group(1) is None
                  else ("B7", "B6f")[int(m.group(1))])
        report.append(f"{kernel} atoms {m.group(2)}: "
                      f"{regs.group(1) if regs else '?'} registers, spill "
                      f"{'/'.join(spill.groups()) if spill else '?'} B")
    # the model sizes' widths and the widest the bodies take
    widths = (48, 200, 336, h, 640)
    smem = {w: (built.lib.wm_ffn_wgmma_smem(w),
                built.lib.wm_ffn_bwd_wgmma_smem(w, 4 * w)) for w in widths}
    return report, smem


def _ffn_bwd_split(t, rate, reps=3):
    """bf16 B6b's device ms a call by pass over `reps` profiled calls: its
    row body (ffn_bwd_wgmma_kernel), its weight-gradient products (the
    grouped matmul's body, WGRAD_BODY), the ordered sums of their slices'
    partials (wgrad_reduce_kernel) and of the row blocks' LN column sums
    (ln_reduce_kernel), and anything else."""
    from weathermodel_tpu_torch.ops.fused_ffn_ln import fused_ffn_ln_bwd

    args = (t["x"], t["w1"], t["b1"], t["w2"], t["b2"], t["ls"], t["lb"],
            t["do"], rate, FFN_SEEDS)
    fused_ffn_ln_bwd(*args)
    events = _profiled(lambda: [fused_ffn_ln_bwd(*args) for _ in range(reps)])
    keys = [e.key for e in events]
    _check_kernel_names("B6b bf16", keys, (FFN_BWD_BODY, WGRAD_BODY),
                        (FFN_ROWS_KERNEL, "gemm_nt_kernel", WGRAD_TILES_BF16))
    parts = {"row": FFN_BWD_BODY, "products": WGRAD_BODY,
             "sums": "wgrad_reduce_kernel", "ln sums": "ln_reduce_kernel"}
    split = {name: sum(_device_ms(e) for e in events if sub in e.key) / reps
             for name, sub in parts.items()}
    split["other"] = sum(_device_ms(e) for e in events if not any(
        sub in e.key for sub in parts.values())) / reps
    return split


def _ffn_bwd_split_in_child(h, f):
    """`_ffn_bwd_split` on this phase's bf16 inputs, in a child process
    (`_in_child`: in this one its profile came back empty)."""
    out = _in_child(
        "import json, torch; t = cs._ffn_inputs(cs.FFN_ROWS, "
        f"{h}, {f}, torch.bfloat16, cs.SEED + 7); "
        "print(json.dumps(cs._ffn_bwd_split(t, cs.DROPOUT)))")
    return json.loads(out.splitlines()[-1])


def _wgrad_yardstick(m, h, f):
    """B6b's weight-gradient passes' library pair in bf16 on operands of
    their shapes: torch.matmul for hd^T . df and x^T . dz, and the fp32
    column sums of df and dz (timed beside the kernel, never the port's
    path); ms a call, and the passes' bound (each input read once, each
    output written once)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def normal(*shape):
        return torch.randn(*shape, device="cuda", generator=g).to(
            torch.bfloat16)

    hd, dz, df, x = normal(m, f), normal(m, f), normal(m, h), normal(m, h)

    def run():
        return (torch.matmul(hd.T, df), df.sum(0, dtype=torch.float32),
                torch.matmul(x.T, dz), dz.sum(0, dtype=torch.float32))

    ms = _cuda_ms(run)
    bound = _bound(4.0 * m * h * f, (2 * m * f + 2 * m * h) * 2
                   + 2 * h * f * 2 + (h + f) * 4, torch.bfloat16)
    del hd, dz, df, x
    torch.cuda.empty_cache()
    return ms, bound


def phase_kernel_ffn():
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE)
    h, f = cfg.hidden_dim, cfg.ffn_dim
    report, smem = _ffn_body_ptxas(h)
    print(f"kernel_ffn: {FFN_BODY} (bf16 B6f and B7) and {FFN_BWD_BODY} "
          f"(bf16 B6b's row work; their symbols are checked in the bench's "
          f"profiles) ptxas: {'; '.join(report)}; dynamic shared memory a "
          f"block by H (forward, B6b at F = 4 H): {smem} B; cluster 1 (no "
          f"multicast)", flush=True)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        t = _ffn_inputs(FFN_ROWS, h, f, dtype, SEED + 7)
        for rate in (DROPOUT, 0.0):
            r = _ffn_case(t, rate, timed=rate == DROPOUT)
            if dtype == torch.bfloat16 and rate == DROPOUT:
                torch.cuda.empty_cache()  # room for the child's tensors
                r["bwd_split"] = _ffn_bwd_split_in_child(h, f)
                r["wgrad_yardstick"] = _wgrad_yardstick(FFN_ROWS, h, f)
            results[dtype, rate] = r
            line = (f"kernel_ffn: M={FFN_ROWS} H={h} F={f} "
                    f"{str(dtype).split('.')[1]} dropout {rate}: max|err| "
                    f"{r['errs']}")
            if "fwd_ms" in r:
                r.update(_ffn_bounds(FFN_ROWS, h, f, dtype))
                line += "".join(
                    f"; {name} kernel {r[k + '_ms']:.3f} ms, plain "
                    f"{r[k + '_plain_ms']:.3f}, {lib} "
                    f"{r[k + '_library_ms']:.3f}, bound "
                    f"{r[k + '_bound'][0]:.3f} by {r[k + '_bound'][1]}"
                    for name, k, lib in (
                        ("B6f", "fwd", "torch FFN+LN"),
                        ("B6b", "bwd", "torch FFN+LN fwd+bwd"),
                        ("B7 with h", "b7", "torch FFN")))
                line += f"; B7 without h {r['b7_eval_ms']:.3f} ms"
            print(line, flush=True)
        del t
        torch.cuda.empty_cache()
    edge = []
    for m, h_e, f_e in FFN_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            t = _ffn_inputs(m, h_e, f_e, dtype, SEED + 8)
            for rate in (DROPOUT, 0.0):
                r = _ffn_case(t, rate, timed=False)
                edge.append(max(r["fwd_err"], r["bwd_err"], r["b7_err"]))
    print(f"kernel_ffn: edge shapes (M, H, F) {FFN_EDGE_SHAPES}, fp32 and "
          f"bf16, dropout {DROPOUT} and 0: {len(edge)} cases, max|err| "
          f"{max(edge):.3g} (tol {KERNEL_TOL}, {SCALE_TOL} x max)", flush=True)
    bf16 = results[torch.bfloat16, DROPOUT]
    print(f"kernel_ffn: bf16 B7 at M={FFN_ROWS}: with h {bf16['b7_ms']:.3f} ms,"
          f" without h {bf16['b7_eval_ms']:.3f} ms (the h write "
          f"{bf16['b7_ms'] - bf16['b7_eval_ms']:.3f} ms); B6f "
          f"{bf16['fwd_ms']:.3f} ms", flush=True)
    split = bf16["bwd_split"]
    passes = split["products"] + split["sums"]
    rest = passes + split["ln sums"] + split["other"]
    lib_ms, (bound_ms, bound_by) = bf16["wgrad_yardstick"]
    print(f"kernel_ffn: bf16 B6b at M={FFN_ROWS} {bf16['bwd_ms']:.3f} ms "
          f"(recorded on the WMMA tiles {WMMA_B6B_MS['B6b']} ms); profiled "
          f"device ms a call: row body ({FFN_BWD_BODY}) {split['row']:.3f}, "
          f"weight-gradient products ({WGRAD_BODY}, no {WGRAD_TILES_BF16}) "
          f"{split['products']:.3f}, their partials' ordered sums "
          f"{split['sums']:.3f}, the LN column sums {split['ln sums']:.3f}, "
          f"other {split['other']:.3f}; all but the row body "
          f"{rest:.3f} (recorded on the WMMA tiles {WMMA_B6B_MS['passes']} "
          f"ms); the weight-gradient passes (products and their sums) "
          f"{passes:.3f}, their library pair (torch.matmul x2 + two column "
          f"sums) {lib_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}",
          flush=True)
    return bf16


# the keep-mask family at the bench microbatch's FFN hidden site (288 x 365
# rows of 2304): seeds of the masks and of B8's input
MASK_SEEDS = (20260201, 20260202)
# The keep masks' bound on Hopper's issue slots and integer pipes (H100 SXM:
# 132 SMs at the 1.98 GHz boost clock, the clock of the data sheet's peaks).
# Each SM issues four warp instructions a clock (128 lanes); the ALU pipe
# (LOP3, SHF, ISETP, SEL, PRMT, IADD3) and the FMA pipe (IMAD in all its
# forms) take 64 lanes a clock each
SM_COUNT, SM_CLOCK_HZ, ISSUE_LANES, PIPE_LANES = 132, 1.98e9, 128, 64
# The least integer instructions an element the hash needs, with mix32's
# first shift-xor hoisted out of the element loop (K1 = key ^ (key >> 16) per
# row, c0 ^ (c0 >> 16) per run of columns c0 .. c0 + w - 1, c0 a multiple of
# w) and its last shift-xor folded into the compare (bits >= threshold iff
# u ^ (threshold >> 16) >= threshold, u mix32's state before it, and bits <
# threshold likewise): (ALU only, FMA only, either pipe).
#   ALU only: the xor with the element's offset in its run (none for the
#     run's first element: (w - 1) / w), the middle shift-xor's xor and the
#     xor with threshold >> 16 (LOP3); B9p's runs of 4 columns need no xor
#     with the offset but one LOP3 a run, (K1 ^ c0 ^ (c0 >> 16)) & ~3, since
#     an offset's hash input is that plus a permutation of 0 .. 3 and enters
#     the first multiply as its addend (the permutation, undone by masked
#     swaps a word, is not counted): 1 / 4;
#   FMA only: the two multiplies (IMAD);
#   either: the middle right shift (SHF, or the high word of an IMAD by
#     2^17) and the compare (ISETP, or the carry of an add), plus B9b's and
#     B8m's byte packing, 3 for 4 elements (PRMT or IMAD); B9p's shift-or of
#     its bit into the word, 1 (LEA or IMAD); B8's multiply by the scale and
#     its select, 2.
# Split between the pipes as evenly as those allow: B9b and B8m 7.6875 (runs
# of 16: 3.84375 a pipe), B9p 7.25, B8 8.875 in bf16 (runs of 8) and 8.75 in
# fp32 (runs of 4). A row's key costs KEY_OPS more: two mix32, the row's add,
# the seed's xor and the hoist
MASK_OPS = {"bool": (2 + 15 / 16, 2, 2 + 3 / 4), "packed": (2 + 1 / 4, 2, 3),
            "lane bf16": (2 + 7 / 8, 2, 2 + 2),
            "lane fp32": (2 + 3 / 4, 2, 2 + 2)}
KEY_OPS = 20


def _mask_bound(elements, rows, ops, nbytes):
    """(ms, "operations" or "bytes") and the four times it is the greatest
    of: issue (every instruction at ISSUE_LANES an SM a clock), the ALU and
    the FMA pipe (PIPE_LANES each, the instructions either can take split to
    balance them), and the bytes at the memory rate."""
    alu_only, fma_only, either = ops
    total = elements * (alu_only + fma_only + either) + rows * KEY_OPS
    alu = min(max(total / 2, elements * alu_only), total - elements * fma_only)
    fma = total - alu
    lanes_per_s = SM_COUNT * SM_CLOCK_HZ
    times = {"issue": total / (ISSUE_LANES * lanes_per_s) * 1e3,
             "ALU": alu / (PIPE_LANES * lanes_per_s) * 1e3,
             "FMA": fma / (PIPE_LANES * lanes_per_s) * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    top = max(times, key=times.get)
    return (times[top], "bytes" if top == "bytes" else "operations"), times


def _check_equal(what, got, want):
    if not torch.equal(got, want):
        bad = (got != want).sum().item()
        raise AssertionError(f"{what}: {bad} of {want.numel()} elements "
                             "differ from the plain version")


def _keep_rate(what, keep):
    rate = keep.float().mean().item()
    if abs(rate - (1 - DROPOUT)) > 1e-3:
        raise AssertionError(f"{what}: keep rate {rate}, want "
                             f"{1 - DROPOUT} +- 1e-3")
    return rate


def phase_kernel_maskgen():
    """B9b, B9p, B8m and B8 at the FFN hidden site of the bench microbatch
    [105120, 2304]: B8 (forward and backward) and B8m launched once each
    through their public functions with the counts at 0 (their only path),
    then each kernel held bitwise against its plain version, keep rates,
    CUDA-event times of kernel, plain version and library call, bounds."""
    from weathermodel_tpu_torch.ops import kernel_dropout as kd
    from weathermodel_tpu_torch.ops import maskgen as mg
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    m, c = FFN_ROWS, model_config_for_size(MODEL_SIZE).ffn_dim
    shape, n, rate = (MICRO, SEQ_LEN, c), FFN_ROWS * c, DROPOUT
    s1, s2 = MASK_SEEDS
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)
    dy = torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)

    for fn in (kd.lane_dropout, kd.random_keep_mask):
        fn.launches = 0
    leaf = x.detach().requires_grad_()
    y = kd.kernel_dropout(leaf, rate, s1)
    y.backward(dy)
    keep8 = kd.random_keep_mask(shape, rate, s1, "cuda")
    torch.cuda.synchronize()
    launches = dict(lane_dropout=kd.lane_dropout.launches,
                    random_keep_mask=kd.random_keep_mask.launches)
    if launches != dict(lane_dropout=2, random_keep_mask=1):
        raise AssertionError(f"kernel_dropout forward + backward and "
                             f"random_keep_mask launched {launches}")

    r = {"launches": launches}
    _check_equal("B8m", keep8, kd.random_keep_mask_reference(shape, rate, s1,
                                                             "cuda"))
    scale = torch.tensor(1 / (1 - rate), dtype=torch.bfloat16, device="cuda")
    zero = torch.zeros((), dtype=torch.bfloat16, device="cuda")
    _check_equal("B8 bf16 vs its mask x scale", y, torch.where(keep8,
                                                               x * scale, zero))
    _check_equal("B8 gradient vs its forward mask x scale x dy", leaf.grad,
                 torch.where(keep8, dy * scale, zero))
    del leaf, y
    rates = {"B8m": _keep_rate("B8m", keep8)}
    r["b8m_ms"] = _cuda_ms(lambda: kd.random_keep_mask(shape, rate, s1,
                                                      "cuda"))
    r["b8m_plain_ms"] = _cuda_ms(lambda: kd.random_keep_mask_reference(
        shape, rate, s1, "cuda"), iters=3, warmup=1)
    r["b8m_library_ms"] = _cuda_ms(lambda: torch.empty(
        shape, dtype=torch.bool, device="cuda").bernoulli_(1 - rate))
    r["b8m_bound"], r["b8m_times"] = _mask_bound(n, -(-n // kd.LANES),
                                                 MASK_OPS["bool"], n)
    del keep8

    keep = mg.bool_keep_mask(m, c, rate, s2, "cuda")
    _check_equal("B9b", keep, mg.bool_keep_mask_reference(m, c, rate, s2,
                                                          "cuda"))
    packed = mg.packed_keep_mask(m, c, rate, s2, "cuda")
    _check_equal("B9p", packed, mg.packed_keep_mask_reference(m, c, rate, s2,
                                                              "cuda"))
    _check_equal("B9p unpacked vs B9b", mg.unpack_keep(packed, m), keep)
    rates["B9b"] = _keep_rate("B9b", keep)
    del keep, packed
    for key, fn, lib, nbytes, ops in (
            ("b9b", mg.bool_keep_mask, lambda: torch.empty(
                m, c, dtype=torch.bool, device="cuda").bernoulli_(1 - rate),
             m * c, MASK_OPS["bool"]),
            ("b9p", mg.packed_keep_mask, None, m * c // 8,
             MASK_OPS["packed"])):
        ref = getattr(mg, fn.__name__ + "_reference")
        r[key + "_ms"] = _cuda_ms(lambda: fn(m, c, rate, s2, "cuda"))
        r[key + "_plain_ms"] = _cuda_ms(lambda: ref(m, c, rate, s2, "cuda"),
                                        iters=3, warmup=1)
        r[key + "_library_ms"] = _cuda_ms(lib) if lib else None
        r[key + "_bound"], r[key + "_times"] = _mask_bound(m * c, m, ops,
                                                           nbytes)

    for dtype, k, ops in ((torch.bfloat16, "b8", MASK_OPS["lane bf16"]),
                          (torch.float32, "b8_fp32", MASK_OPS["lane fp32"])):
        xd = x.to(dtype)
        got = kd.lane_dropout(xd, rate, s1)
        _check_equal(f"B8 {dtype}", got, kd.lane_dropout_reference(xd, rate,
                                                                   s1))
        rates[f"B8 {dtype}"] = _keep_rate(f"B8 {dtype}", got != 0)
        del got
        r[k + "_ms"] = _cuda_ms(lambda: kd.lane_dropout(xd, rate, s1))
        r[k + "_plain_ms"] = _cuda_ms(lambda: kd.lane_dropout_reference(
            xd, rate, s1), iters=3, warmup=1)
        r[k + "_library_ms"] = _cuda_ms(lambda: F.dropout(xd, rate,
                                                          training=True))
        r[k + "_bound"], r[k + "_times"] = _mask_bound(
            n, -(-n // kd.LANES), ops, 2 * n * dtype.itemsize)
        del xd
    for key in ("b9b", "b9p", "b8m", "b8", "b8_fp32"):
        r[key + "_err"] = 0.0  # held bitwise above
    torch.cuda.empty_cache()
    print(f"kernel_maskgen: [{m}, {c}] (B8/B8m on {list(shape)}), rate "
          f"{rate}: every kernel bitwise equal to its plain version, B8's "
          f"gradient its forward mask x scale x dy; keep rates {rates}; "
          f"launches of the public functions {launches}; " + "; ".join(
              f"{name} kernel {r[k + '_ms']:.4f} ms, plain "
              f"{r[k + '_plain_ms']:.3f}, {lib} "
              + ("none" if r[k + "_library_ms"] is None
                 else f"{r[k + '_library_ms']:.4f}")
              + f", bound {r[k + '_bound'][0]:.4f} by {r[k + '_bound'][1]} "
              "(" + ", ".join(f"{what} {ms:.4f}" for what, ms in
                              r[k + "_times"].items()) + ")"
              for name, k, lib in (
                  ("B9b", "b9b", "bernoulli_"), ("B9p", "b9p", "library"),
                  ("B8m", "b8m", "bernoulli_"), ("B8 bf16", "b8", "F.dropout"),
                  ("B8 fp32", "b8_fp32", "F.dropout"))), flush=True)
    return r


# timed steps of each probe in the ablation scripts (theirs default to 30)
PROBE_STEPS = 5
# the most entries of a probe's output that may differ from its plain
# version's (fp32 sums in another order flip a few roundings)
PROBE_DIFFER_SHARE = 1e-2


def _library_headpack(q, k, v, nh):
    """The library call beside P1 and P2: two batched torch.matmul over the
    [B, NH, T, HD] head views, S materialised in bf16 (timed only)."""
    qh, kh, vh = (_heads(a, nh) for a in (q, k, v))
    return torch.matmul(torch.matmul(qh, kh.transpose(-1, -2)), vh)


def _check_probe(what, got, want):
    """A probe's output against its plain version's at SCALE_TOL (bf16) of
    the plain output's largest magnitude, with at most PROBE_DIFFER_SHARE of
    the entries differing at all (the gpu tests' bar: a kernel that skipped
    rounding S stays within the scale bar at P1/P2's output scale, but
    changes ~40% of the entries): (max|diff|, the share of entries that
    differ, max|plain|)."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    peak = want.abs().max().item()
    share = (got != want).float().mean().item()
    if not err <= SCALE_TOL[torch.bfloat16] * peak:
        raise AssertionError(f"{what}: max|kernel - plain| {err:.3g} exceeds "
                             f"{SCALE_TOL[torch.bfloat16]:.3g} x max|plain| "
                             f"{peak:.3g}")
    if not share <= PROBE_DIFFER_SHARE:
        raise AssertionError(f"{what}: {share:.3g} of the entries differ "
                             f"from the plain version's, over "
                             f"{PROBE_DIFFER_SHARE:.3g}")
    return err, share, peak


def _p3_profiles():
    """bf16 P3 at each arm of the probe, profiled: fails unless it runs the
    grouped matmul's wgmma body and no bf16 WMMA tile."""
    from weathermodel_tpu_torch.ops import blocked_mm as bmm
    from weathermodel_tpu_torch.scripts import abl_gemm_probe

    x, w = abl_gemm_probe.inputs(abl_gemm_probe.M, "cuda")
    for bm, bn in abl_gemm_probe.ARMS:
        bmm.blocked_mm(x, w, bm, bn)  # warm-up
        _check_kernel_names(
            f"bf16 blocked_mm bm={bm} bn={bn}",
            [e.key for e in _profiled(lambda: bmm.blocked_mm(x, w, bm, bn))],
            require=(GMM_BODY,), forbid=(BLOCKED_MM_TILES_BF16,))


def _headpack_profiles():
    """bf16 P1 and P2 at the probe's shape, each call profiled: fails unless it
    runs the wgmma body and no WMMA headpack_kernel."""
    from weathermodel_tpu_torch.ops import headpack as hp
    from weathermodel_tpu_torch.scripts import abl_headpack

    q, k, v = abl_headpack.inputs(abl_headpack.B, "cuda")
    for fn in (hp.headpack_v0, hp.headpack_v1):
        fn(q, k, v)  # warm-up
        _check_kernel_names(
            fn.__name__, [e.key for e in _profiled(lambda: fn(q, k, v))],
            require=(HEADPACK_BODY,), forbid=(HEADPACK_WMMA,))


def _headpack_body_report():
    """The probes' wgmma body's ptxas report: registers and spills of
    headpack_wgmma_kernel<G, kTma> (G = 1 for P1, 3 for P2; TMA loads or
    cp.async); fails on spills or serialized wgmmas (C7511, C7512)."""
    import re

    from weathermodel_tpu_torch.kernels import build

    lines = build.load_library().ptxas_log.splitlines()
    serialized = [ln for ln in lines if HEADPACK_BODY in ln and
                  ("C7511" in ln or "C7512" in ln)]
    if serialized:
        raise AssertionError(f"{HEADPACK_BODY}'s wgmmas are serialized: "
                             f"{serialized}")
    report = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*" + HEADPACK_BODY +
                      r"ILi(\d)ELb(\d)E", line)
        if m is None:
            continue
        block = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        if spill is None or spill.groups() != ("0", "0"):
            raise AssertionError(f"{HEADPACK_BODY}<{m.group(1)}, "
                                 f"{m.group(2)}> spills: {block}")
        report[f"<{m.group(1)}, {m.group(2)}>"] = (
            f"{regs.group(1) if regs else '?'} registers at entry, spill 0/0 B")
    if len(report) != 4:
        raise AssertionError(f"ptxas reported {sorted(report)} for "
                             f"{HEADPACK_BODY}, not its 4 instantiations")
    return (f"{HEADPACK_BODY}<G, kTma> ptxas: "
            + "; ".join(f"{k}: {v}" for k, v in sorted(report.items())))


def phase_probes(smi: str):
    """The port's two ablation scripts at the JAX scripts' full shapes with
    PROBE_STEPS timed steps, every count at 0 just before; then P1, P2 and
    P3 against their plain versions, the plain and library times and the
    bounds."""
    from weathermodel_tpu_torch.ops import blocked_mm as bmm
    from weathermodel_tpu_torch.ops import headpack as hp
    from weathermodel_tpu_torch.scripts import abl_gemm_probe, abl_headpack

    counted = _all_kernels()
    for fn in counted:
        fn.launches = 0
    head = abl_headpack.main("cuda", abl_headpack.B, PROBE_STEPS)
    gemm = abl_gemm_probe.main("cuda", abl_gemm_probe.M, PROBE_STEPS)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    # the cross-check, then one warm-up and the timed steps; P3 per arm
    want = {**{fn.__name__: 0 for fn in counted},
            "headpack_v0": 2 + PROBE_STEPS, "headpack_v1": 2 + PROBE_STEPS,
            "blocked_mm": len(abl_gemm_probe.ARMS) * (1 + PROBE_STEPS)}
    if launches != want:
        raise AssertionError(f"the ablation scripts launched {launches}, "
                             f"expected {want}")
    if not head["rel_err"] <= SCALE_TOL[torch.bfloat16]:
        raise AssertionError(f"abl_headpack: v0 vs v1 rel err "
                             f"{head['rel_err']}")

    b, t, nh, hd, g = (abl_headpack.B, abl_headpack.T, abl_headpack.NH,
                       abl_headpack.HD, abl_headpack.G)
    q, k, v = abl_headpack.inputs(b, "cuda")
    r, errs = {"launches": launches}, {}
    library_ms = _cuda_ms(lambda: _library_headpack(q, k, v, nh))
    for key, fn, heads in (("p1", hp.headpack_v0, nh),
                           ("p2", hp.headpack_v1, nh // g * g)):
        ref = getattr(hp, fn.__name__ + "_reference")
        live = heads * hd
        r[key + "_err"], share, peak = _check_probe(
            fn.__name__, fn(q, k, v)[..., :live], ref(q, k, v)[..., :live])
        errs[fn.__name__] = f"{r[key + '_err']:.3g} of max {peak:.4g} " \
            f"({share:.2e} of the entries differ)"
        r[key + "_ms"] = head["v0_ms" if key == "p1" else "v1_ms"]
        r[key + "_plain_ms"] = _cuda_ms(lambda: ref(q, k, v), iters=3,
                                        warmup=1)
        r[key + "_library_ms"] = library_ms
        # the function's work: the heads it writes (P2's 15), each input
        # read once and o written once
        r[key + "_bound"] = _bound(4.0 * b * heads * t * t * hd,
                                   4 * b * t * live * 2, torch.bfloat16)
    # what P2 multiplies: S3 and O3 over the block-diagonal operands
    packed_flops = 4.0 * b * (nh // g) * t * g * t * g * hd
    r["p2_packed_ms"] = packed_flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    del q, k, v

    x, w = abl_gemm_probe.inputs(abl_gemm_probe.M, "cuda")
    kk, n = abl_gemm_probe.K, abl_gemm_probe.N
    arm_errs = {}
    for arm in gemm["arms"]:
        bm, bn, rows, cols = arm["bm"], arm["bn"], arm["rows"], arm["cols"]
        err, share, peak = _check_probe(
            f"blocked_mm bm={bm} bn={bn}",
            bmm.blocked_mm(x, w, bm, bn)[:rows, :cols],
            bmm.blocked_mm_reference(x, w, bm, bn)[:rows, :cols])
        arm_errs[bm, bn] = f"{err:.3g} of max {peak:.3g} ({share:.2e})"
        if (bm, bn) == abl_gemm_probe.ARMS[0]:  # the arm the record reports
            r["p3_err"], r["p3_ms"] = err, arm["ms"]
            r["p3_plain_ms"] = _cuda_ms(lambda: bmm.blocked_mm_reference(
                x, w, bm, bn), iters=3, warmup=1)
            r["p3_library_ms"] = gemm["matmul_ms"]
            r["p3_bound"] = _bound(2.0 * rows * kk * cols,
                                   (rows * kk + kk * cols + rows * cols) * 2,
                                   torch.bfloat16)
    del x, w
    _in_child("cs._p3_profiles()")
    _in_child("cs._headpack_profiles()")
    torch.cuda.empty_cache()
    print("probes: " + " | ".join(head["lines"][1:] + gemm["lines"][1:]),
          flush=True)
    print(f"probes: launches of the scripts' run {launches}; max|kernel - "
          f"plain| (tol {SCALE_TOL[torch.bfloat16]:.3g} x max|plain|) "
          f"{errs}, P3 arms {arm_errs}; " + "; ".join(
              f"{name} kernel {r[k + '_ms']:.4f} ms, plain "
              f"{r[k + '_plain_ms']:.3f}, {lib} {r[k + '_library_ms']:.4f}, "
              f"bound {r[k + '_bound'][0]:.4f} by {r[k + '_bound'][1]}"
              for name, k, lib in (
                  ("P1", "p1", "torch.matmul x2"),
                  ("P2", "p2", "torch.matmul x2"),
                  (f"P3 {abl_gemm_probe.ARMS[0]}", "p3", "torch.matmul")))
          + f"; P2's packed products alone {r['p2_packed_ms']:.4f} ms at "
          f"the bf16 peak; P1 and P2 on {HEADPACK_BODY} (in their profiles, "
          f"no {HEADPACK_WMMA}), recorded on the WMMA kernel "
          f"{WMMA_HEADPACK_MS['P1']} and {WMMA_HEADPACK_MS['P2']} ms; shares "
          f"of the bound: P1 {r['p1_bound'][0] / r['p1_ms']:.1%} of "
          f"{r['p1_bound'][0]:.4f} ms, P2 {r['p2_bound'][0] / r['p2_ms']:.1%} "
          f"of {r['p2_bound'][0]:.4f} ms and "
          f"{r['p2_packed_ms'] / r['p2_ms']:.1%} of its literal products' "
          f"{r['p2_packed_ms']:.4f} ms; P2/P1 "
          f"{r['p2_ms'] / r['p1_ms']:.2f}; {_headpack_body_report()}; "
          f"P3 on the grouped matmul's wgmma body "
          f"({GMM_BODY} in its profile, no {BLOCKED_MM_TILES_BF16}), "
          f"recorded on the WMMA tiles {WMMA_P3_MS} ms; card {smi}",
          flush=True)
    return r


# bench steps timed per run (after its 3 warm-up steps)
BENCH_STEPS = 3


def _bench(env, counted):
    """The port's bench run(env) with every wrapper in `counted` set to 0
    just before: (its record, launches by wrapper name, steps run)."""
    from weathermodel_tpu_torch import bench

    for fn in counted:
        fn.launches = 0
    record = bench.run({"BENCH_MODEL_SIZE": MODEL_SIZE,
                        "BENCH_DROPOUT_RATE": str(DROPOUT),
                        "BENCH_STEPS": str(BENCH_STEPS), **env}, "cuda")
    if not np.isfinite(record["loss"]):
        raise AssertionError(f"bench {env}: non-finite loss {record}")
    launches = {fn.__name__: fn.launches for fn in counted}
    return record, launches, 3 + BENCH_STEPS


def _nonzero(launches):
    return {run: {k: n for k, n in got.items() if n}
            for run, got in launches.items()}


def phase_bench(smi: str):
    from weathermodel_tpu_torch.ops import dropout
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16")
    per_step = GRAD_ACCUM * cfg.num_layers
    counted = _all_kernels()
    zero = {fn.__name__: 0 for fn in counted}
    launches, lines = {}, []
    for impl in ("torch", "fused_ffn_ln", "fused_ffn"):
        record, got, steps = _bench({"BENCH_FFN_IMPL": impl}, counted)
        n = per_step * steps
        ffn = {"torch": {}, "fused_ffn_ln": dict(fused_ffn_ln=n,
                                                 fused_ffn_ln_bwd=n),
               "fused_ffn": dict(fused_ffn=n)}[impl]
        _check_launches(got, {**zero, "fused_qkv_attention_train": n,
                              "fused_qkv_attention_bwd": n, **ffn}, steps, 0)
        launches[impl] = got
        lines.append(f"{impl}: {record['value']} samples/s, "
                     f"{record['tflops']} TFLOP/s, mfu {record['mfu']}, loss "
                     f"{record['loss']:.4f}")
    for impl, kernel in (("maskgen", "packed_keep_mask"),
                         ("maskgen_bool", "bool_keep_mask")):
        dropout.set_impl(impl)
        try:
            record, got, steps = _bench({"BENCH_FFN_IMPL": "torch"}, counted)
        finally:
            dropout.set_impl("auto")
        n = per_step * steps
        # the FFN hidden site of each layer and microbatch; the attention-out
        # and FFN-out sites (C = 576, not a multiple of 128) take "auto"
        _check_launches(got, {**zero, "fused_qkv_attention_train": n,
                              "fused_qkv_attention_bwd": n, kernel: n},
                        steps, 0)
        launches[impl] = got
        lines.append(f"torch + dropout {impl}: {record['value']} samples/s, "
                     f"{record['tflops']} TFLOP/s, mfu {record['mfu']}, loss "
                     f"{record['loss']:.4f}")
    for name, env, kernels in (
            ("fused_ffn_ln", {"BENCH_FFN_IMPL": "fused_ffn_ln"},
             ("fused_qkv_attention", "fused_ffn_ln")),
            ("fused_ffn", {"BENCH_FFN_IMPL": "fused_ffn"},
             ("fused_qkv_attention", "fused_ffn")),
            ("fused_qkv_op", {"BENCH_ATTENTION": "fused_qkv_op"},
             ("fused_qkv_attention_outproj",))):
        record, got, steps = _bench({**env, "BENCH_MODE": "eval"}, counted)
        n = cfg.num_layers * steps
        _check_launches(got, {**zero, **dict.fromkeys(kernels, n)}, steps, 0)
        launches[name + " eval"] = got
        lines.append(f"{name} eval: {record['value']} samples/s, "
                     f"{record['tflops']} TFLOP/s, loss {record['loss']:.4f}")
    print(f"bench: WeatherBERT-{MODEL_SIZE} bf16, {TRAIN_BATCH} = {GRAD_ACCUM} "
          f"x {MICRO}, dropout {DROPOUT}, 3 warm-up + {BENCH_STEPS} timed "
          f"steps a run: " + "; ".join(lines) + "; launches (the nonzero "
          f"counts; every other kernel 0) {_nonzero(launches)}; card {smi}",
          flush=True)
    dropout.set_impl("maskgen_bool")
    try:
        print("bench: torch + dropout maskgen_bool " + _profile_step(
            "weatherbert", cfg, "fused_qkv", TRAIN_BATCH, GRAD_ACCUM,
            named=(("B9b at the FFN hidden sites", "bool_mask_kernel"),
                   ("torch's distribution kernels (the auto sites' "
                    "torch.rand and the step's own draws)",
                    "distribution_"))),
            flush=True)
    finally:
        dropout.set_impl("auto")
    # bf16 B6f, B7 with h (train) and B7 without (eval) launch the wgmma
    # body, B6b (fused_ffn_ln's train step) its backward body; no bf16 FFN
    # kernel runs the row kernel. B1 (train and eval) runs the attention's
    # wgmma body, never the scalar one
    rows_bf16 = f"{FFN_ROWS_KERNEL}<__nv_bfloat16"
    for impl, body in (("fused_ffn_ln", f"{FFN_BODY}<1,"),
                       ("fused_ffn", f"{FFN_BODY}<0,")):
        for mode, accum in (("train", GRAD_ACCUM), ("eval", 1)):
            need = (body, ATTN_BODY)
            named = ()
            if mode == "train":
                need += (ATTN_BWD_BODY,)
            if impl == "fused_ffn_ln" and mode == "train":
                need += (FFN_BWD_BODY, WGRAD_BODY)
                named = (("B6b's partial sums", "wgrad_reduce_kernel"),
                         ("B6b's LN column sums", "ln_reduce_kernel"))
            print(f"bench: {impl} {mode} " + _profile_step(
                "weatherbert", cfg, "fused_qkv", TRAIN_BATCH, accum,
                ffn_impl=impl, mode=mode,
                named=tuple((n, n) for n in need) + named, require=need,
                forbid=(rows_bf16, ATTN_SCALAR_BF16, *ATTN_BWD_SCALAR_BF16,
                        WGRAD_TILES_BF16)),
                flush=True)
        print(f"bench: {impl} " + _check_step_parity(
            "weatherbert", MODEL_SIZE, "fused_qkv", ffn_impl=impl), flush=True)
    return launches


# int8 serving (phases 19-20): the windows the int8_static scales are
# calibrated on, and the bar on the relative RMS difference of the int8
# outputs from the bf16 serve's
N_CALIBRATION, INT8_DRIFT = 32, 0.05
# the int8 ops on the card against the CPU: rows of the dense form, rows per
# expert of the expert form, at the serving FFN's two matmuls
INT8_ROWS, INT8_EXPERT_ROWS = 1024, 128
# one MoE training step, sort against scatter (phase 21), bf16, dropout off:
# the two layouts run the same bf16 batched products on the same rows and
# combine each token's k outputs in the same order, so only cuBLAS's choice
# of kernel for their different batch shapes may move a sum, by a bf16
# rounding (2^-8) at most: (loss rel, worst gradient ||diff|| / ||grad||)
MOE_LAYOUT_TOL = dict(loss=1e-3, grad=2e-2)
MOE_DISPATCH_RUNS = (("ragged", False), ("sort", False), ("scatter", False),
                     ("sort", True))


def _serve_cli(tmp: Path, checkpoint: str, tag: str, *extra):
    """`wm-serve-torch` on phase 5's 300 windows (WeatherBERT-large, bf16,
    --batch-size 256, auto) with `extra` flags, every kernel count at 0
    just before: (output, predict seconds, launches by wrapper)."""
    from weathermodel_tpu_torch.cli import serve

    out_path = tmp / f"out_{tag}.npz"
    args = serve.build_parser().parse_args([
        "--checkpoint", str(tmp / checkpoint), "--model", "weatherbert",
        "--model-size", MODEL_SIZE, "--input", str(tmp / "windows.npz"),
        "--output", str(out_path), "--batch-size", str(BATCH),
        "--compute-dtype", "bfloat16", "--attention-impl", "auto",
        "--device", "cuda", *extra])
    counted = _all_kernels()
    for fn in counted:
        fn.launches = 0
    res = serve.run(args)
    launches = {fn.__name__: fn.launches for fn in counted}
    with np.load(out_path) as z:
        out = z["output"]
    if out.shape != (N_WINDOWS, SEQ_LEN, N_FEATURES) or \
            not np.isfinite(out).all():
        raise AssertionError(f"{tag}: served output {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    return out, res["predict_s"], launches


def _rms_rel(got, want) -> float:
    return float(np.sqrt(np.mean(np.square(got - want)))
                 / np.sqrt(np.mean(np.square(want))))


def _only(launches, **want):
    """`launches` must be `want` and 0 for every other kernel."""
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{expected}")


def _int8_ops_card_vs_cpu():
    """int8_dense_static and int8_expert_einsum on the card against the same
    call on the CPU, at the serving FFN's two matmuls (K = 576 -> 2304 and
    2304 -> 576), bf16 inputs: the int8 codes equal and the outputs bitwise
    equal. Returns the text of the line."""
    from weathermodel_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(SEED + 7)
    h, f, e = 576, 2304, MOE["num_experts"]
    checked = []
    for k, o in ((h, f), (f, h)):
        x = torch.randn(INT8_ROWS, k, generator=g).to(torch.bfloat16)
        w = torch.randn(o, k, generator=g) / k ** 0.5
        b = torch.randn(o, generator=g)
        amax = x.float().abs().amax(0) * 0.9
        ex = torch.randn(e, INT8_EXPERT_ROWS, k, generator=g).to(
            torch.bfloat16)
        ex[1, 40:] = 0  # capacity padding rows
        ew = torch.randn(e, k, o, generator=g) / k ** 0.5
        eamax = ex.float().abs().amax(1) * 0.9
        for what, fn, args in (
                ("int8_dense_static", quant.int8_dense_static,
                 (x, w, amax, b)),
                ("int8_expert_einsum", quant.int8_expert_einsum,
                 (ex, ew, eamax))):
            cpu = fn(*args)
            card = fn(*(a.cuda() for a in args)).cpu()
            if not torch.equal(card, cpu):
                n = int((card != cpu).sum())
                raise AssertionError(f"{what} K={k}: {n} outputs differ "
                                     "between the card and the CPU")
            checked.append(f"{what} K={k} -> {o}")
        scale = quant._static_scale(amax)
        codes = [quant._codes(xx, ss) for xx, ss in
                 ((x, scale), (x.cuda(), scale.cuda()))]
        wq = [quant.quantize_int8(ww * ss.reshape(1, -1), 1)[0] for ww, ss in
              ((w, scale), (w.cuda(), scale.cuda()))]
        if not (torch.equal(codes[0], codes[1].cpu())
                and torch.equal(wq[0], wq[1].cpu())):
            raise AssertionError(f"int8 codes at K={k} differ between the "
                                 "card and the CPU")
    # the dense form's time at the serving FFN's first matmul
    m = BATCH * SEQ_LEN
    x = torch.randn(m, h, device="cuda", dtype=torch.bfloat16)
    w = torch.randn(f, h, device="cuda") / h ** 0.5
    b = torch.randn(f, device="cuda")
    amax = x.float().abs().amax(0)
    xq = quant._codes(x, quant._static_scale(amax))
    wq = quant.quantize_int8(w, 1)[0].t()
    wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
    times = {"int8_dense_static": _cuda_ms(
                 lambda: quant.int8_dense_static(x, w, amax, b)),
             "torch._int_mm": _cuda_ms(lambda: torch._int_mm(xq, wq)),
             "F.linear bf16": _cuda_ms(lambda: F.linear(x, wb, bb))}
    return (f"{', '.join(checked)} on the card bitwise equal to the CPU "
            f"(int8 codes equal; {INT8_ROWS} rows, {INT8_EXPERT_ROWS} a "
            f"expert); at [{m}, {h}] x [{h}, {f}]: "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items()))


def phase_serve_int8(smi: str, tmp: Path):
    from weathermodel_tpu_torch.ops import quant
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    n_layers = model_config_for_size(MODEL_SIZE).num_layers
    chunks = -(-N_WINDOWS // BATCH)
    np.savez(tmp / "calibration.npz",
             **_windows(np.random.default_rng(SEED + 5), N_CALIBRATION))
    calib = ("--calibrate-input", str(tmp / "calibration.npz"))
    modes = (("bf16", (), False), ("int8", ("--quantize", "int8"), False),
             ("int8_static", ("--quantize", "int8_static", *calib), False),
             ("int8_static + attn out", ("--quantize", "int8_static",
                                         *calib), True))
    rates, drifts, launches, outs = {}, {}, {}, {}
    for mode, flags, attn_out in modes:
        quant.set_attn_out_quant(attn_out)
        try:
            for _ in range(2):  # the second call is timed
                out, predict_s, counts = _serve_cli(
                    tmp, "weatherbert_large.pth", mode.replace(" ", ""),
                    *flags)
        finally:
            quant.set_attn_out_quant(False)
        # B1 eval: 8 layers x 2 chunks, and 8 for a calibration pass over
        # the 32 calibration windows (one batch)
        calibrated = "int8_static" in mode
        _only(counts, fused_qkv_attention=n_layers * chunks
              + (n_layers if calibrated else 0))
        launches[mode] = counts["fused_qkv_attention"]
        rates[mode] = N_WINDOWS / predict_s
        outs[mode] = out
        if mode != "bf16":
            drifts[mode] = _rms_rel(out, outs["bf16"])
            if drifts[mode] > INT8_DRIFT:
                raise AssertionError(
                    f"{mode}: served output's RMS difference from bf16 "
                    f"{drifts[mode]:.4f} exceeds {INT8_DRIFT}")
    if np.array_equal(outs["int8_static"], outs["int8_static + attn out"]):
        raise AssertionError("the attention out-projection's int8_static "
                             "left the output unchanged")
    print(f"serve_int8: {N_WINDOWS} windows WeatherBERT-{MODEL_SIZE} "
          f"--batch-size {BATCH}, auto (B1 eval), int8_static calibrated on "
          f"{N_CALIBRATION} windows: windows/s "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + "; relative RMS difference from bf16 "
          + ", ".join(f"{k} {v:.5f}" for k, v in drifts.items())
          + f" (bar {INT8_DRIFT}); B1 eval launches per call {launches}; "
          f"card {smi}", flush=True)
    print("serve_int8: " + _int8_ops_card_vs_cpu(), flush=True)


def _serve_sort_bf16(tmp: Path, cfg):
    """Phase 5's windows through a bf16 predictor of the MoE checkpoint in
    the sort layout (the layout int8_static serves in; `wm-serve-torch`
    serves bf16 through ragged): (output, share of routed assignments that
    the capacity dropped)."""
    import dataclasses

    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.models import moe
    from weathermodel_tpu_torch.serve import DEFAULT_BUCKETS, WeatherPredictor

    model = make_model("weatherbert", dataclasses.replace(
        cfg, compute_dtype="bfloat16", moe_dispatch="sort"), "fused_qkv")
    model.load_state_dict(torch.load(tmp / "weatherbert_large_moe.pth"))
    predictor = WeatherPredictor(model, tuple(
        b for b in DEFAULT_BUCKETS if b < BATCH) + (BATCH,), device="cuda")
    kept, routed = [], []
    real = moe.sort_routing

    def counting(flat_idx, e, cap):
        out = real(flat_idx, e, cap)
        kept.append(out[1].sum())
        routed.append(out[1].numel())
        return out

    moe.sort_routing = counting
    try:
        with np.load(tmp / "windows.npz") as z:
            out = predictor(z["weather"], z["coords"], z["year"],
                            z["interval"], z["mask"])
    finally:
        moe.sort_routing = real
    return out, 1.0 - float(sum(k.item() for k in kept)) / sum(routed)


def phase_serve_moe_int8(smi: str, tmp: Path):
    from weathermodel_tpu_torch.models.weatherbert import WeatherBERT
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, max_len=SEQ_LEN, **MOE)
    model = WeatherBERT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(SEED + 6))
    torch.save(model.state_dict(), tmp / "weatherbert_large_moe.pth")
    del model
    chunks = -(-N_WINDOWS // BATCH)
    moe = ("--moe-experts", str(cfg.num_experts), "--moe-top-k",
           str(cfg.moe_top_k))
    calib = ("--quantize", "int8_static", "--calibrate-input",
             str(tmp / "calibration.npz"))
    rates, outs = {}, {}
    for mode, flags in (("bf16 ragged", moe), ("int8_static sort",
                                               moe + calib)):
        for _ in range(2):  # the second call is timed
            out, predict_s, counts = _serve_cli(
                tmp, "weatherbert_large_moe.pth", mode.replace(" ", "_"),
                *flags)
        if mode == "bf16 ragged":  # 2 B4 a layer a chunk
            _only(counts, fused_qkv_attention=cfg.num_layers * chunks,
                  gmm=2 * cfg.num_layers * chunks)
        else:  # B4 only in the calibration pass (one batch), none serving
            _only(counts, fused_qkv_attention=cfg.num_layers * (chunks + 1),
                  gmm=2 * cfg.num_layers)
        rates[mode], outs[mode] = N_WINDOWS / predict_s, out
        launches = counts
    # int8_static serves through the capacity layout, which drops the
    # tokens past an expert's capacity (JAX's design, serve.py:233-238): its
    # quantization error is held against the bf16 sort layout's output, and
    # the difference from the dropless ragged serve is printed beside it
    outs["bf16 sort"], dropped = _serve_sort_bf16(tmp, cfg)
    drift = _rms_rel(outs["int8_static sort"], outs["bf16 sort"])
    if drift > INT8_DRIFT:
        raise AssertionError(f"MoE int8_static: served output's RMS "
                             f"difference from the bf16 sort layout's "
                             f"{drift:.4f} exceeds {INT8_DRIFT}")
    print(f"serve_moe_int8: {N_WINDOWS} windows WeatherBERT-{MODEL_SIZE} MoE "
          f"E={cfg.num_experts} top-{cfg.moe_top_k} --batch-size {BATCH}: "
          "windows/s " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; relative RMS difference of int8_static from bf16 sort "
          f"{drift:.5f} (bar {INT8_DRIFT}), from bf16 ragged "
          f"{_rms_rel(outs['int8_static sort'], outs['bf16 ragged']):.5f}; "
          f"bf16 sort from bf16 ragged "
          f"{_rms_rel(outs['bf16 sort'], outs['bf16 ragged']):.5f} (the "
          f"capacity dropped {dropped:.4f} of the routed assignments); "
          f"int8_static call's launches {launches} (B4 in its calibration "
          f"only); card {smi}", flush=True)


def _moe_layout_model(cfg, dispatch):
    """The MoE kernel path with `dispatch` on the card (the smoke's seeded
    weights) and a function running its train step at STEP_WINDOWS windows
    on the smoke's batch, mask and generator seed, lr 0 (the weights stay),
    with dropout `rate`: (model, step(rate) -> loss)."""
    import dataclasses

    from weathermodel_tpu_torch.train.steps import batch_to_device

    batch, mask = _windows_batch(STEP_WINDOWS, SEED + 2)
    batch, mask = batch_to_device(batch, "cuda"), torch.from_numpy(mask)
    model, step = _train_step_fn(
        "weatherbert", dataclasses.replace(cfg, moe_dispatch=dispatch),
        "fused_qkv", "cuda")

    def run(rate):
        return float(step(batch, torch.Generator().manual_seed(SEED), 0.0,
                          10, mask=mask.cuda(), dropout_rate=rate)[
            "total_loss"])

    return model, run


def phase_train_moe_dispatch(smi: str, data: Path):
    from weathermodel_tpu_torch.models.moe import MoEFFN
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, compute_dtype="bfloat16", **MOE)
    n_train, _ = _store_batches(data, MOE_BATCH)
    per_step = MOE_ACCUM * cfg.num_layers
    runs = {}
    for dispatch, remat in MOE_DISPATCH_RUNS:
        # what the earlier runs left (their trainers' reference cycles,
        # collected only when the collector runs) is freed first, and each
        # run's peak is counted above what is still allocated at its start
        gc.collect()
        torch.cuda.empty_cache()
        base_gb = torch.cuda.memory_allocated() / 1e9
        with tempfile.TemporaryDirectory() as workdir:
            result, launches, wall, peak_gb, record = _run_pretrain([
                "--model", "weatherbert", "--model-size", MODEL_SIZE,
                "--moe-experts", str(cfg.num_experts), "--moe-top-k",
                str(cfg.moe_top_k), "--moe-dispatch", dispatch,
                *(("--moe-remat",) if remat else ()),
                "--batch-size", str(MOE_BATCH), "--grad-accum",
                str(MOE_ACCUM), "--n-epochs", "1", "--n-warmup-epochs", "0",
                "--masking-prob", "0.15", "--data-dir", str(data),
                "--workdir", workdir, "--compute-dtype", "bfloat16",
                "--device", "cuda"], _all_kernels())
        steps = sum(len(s) for s in result["train_step_seconds"])
        val_batches = sum(result["val_batches"])
        ragged = dispatch == "ragged"
        _only(launches,
              fused_qkv_attention=cfg.num_layers * val_batches,
              fused_qkv_attention_train=per_step * steps,
              fused_qkv_attention_bwd=per_step * steps,
              gmm=(4 * per_step * steps + 2 * cfg.num_layers * val_batches
                   if ragged else 0),
              tgmm=2 * per_step * steps if ragged else 0)
        losses = record["losses"]["train"]
        if not (np.isfinite(losses["total_loss"]).all()
                and np.isfinite(losses["moe_aux"]).all()):
            raise AssertionError(f"{dispatch}: non-finite losses {losses}")
        ms, rate, _, _ = _throughput(result, cfg, MOE_BATCH)
        name = dispatch + (" remat" if remat else "")
        runs[name] = dict(rate=round(rate, 1), ms=round(ms, 1),
                          peak_gb=round(peak_gb - base_gb, 2),
                          base_gb=round(base_gb, 2),
                          loss=round(losses["total_loss"][0], 5),
                          launches={k: v for k, v in launches.items() if v})
    if not runs["sort remat"]["peak_gb"] < runs["sort"]["peak_gb"]:
        raise AssertionError(f"--moe-remat did not lower sort's peak memory: "
                             f"{runs}")
    sort_model, sort_step = _moe_layout_model(cfg, "sort")
    scatter_model, scatter_step = _moe_layout_model(cfg, "scatter")
    loss_s, loss_c = sort_step(0.0), scatter_step(0.0)
    loss_rel = abs(loss_s - loss_c) / abs(loss_c)
    grad_rel = _grad_rel(sort_model, scatter_model)
    if loss_rel > MOE_LAYOUT_TOL["loss"] or \
            grad_rel[0] > MOE_LAYOUT_TOL["grad"]:
        raise AssertionError(f"one step, sort vs scatter (loss rel, worst "
                             f"gradient, its parameter) {loss_rel}, "
                             f"{grad_rel}, bars {MOE_LAYOUT_TOL}")
    del scatter_model
    # the same weights (lr 0), dropout on, the same generator seed: without
    # and then with the expert region recomputed in the backward
    losses, grads = [], []
    for remat in (False, True):
        for module in sort_model.modules():
            if isinstance(module, MoEFFN):
                module.remat = remat
        losses.append(sort_step(cfg.dropout_rate))
        grads.append({name: p.grad.clone()
                      for name, p in sort_model.named_parameters()})
    if losses[0] != losses[1]:
        raise AssertionError(f"remat changed the loss: {losses}")
    for name, g in grads[0].items():
        if not torch.equal(g, grads[1][name]):
            raise AssertionError(f"remat's gradient of {name} is not the "
                                 "saved-activation step's bit for bit")
    print(f"train_moe_dispatch: wm-pretrain-torch WeatherBERT-{MODEL_SIZE} "
          f"MoE E={cfg.num_experts} top-{cfg.moe_top_k} bf16 --batch-size "
          f"{MOE_BATCH} --grad-accum {MOE_ACCUM}, dropout {cfg.dropout_rate}, "
          f"1 epoch ({n_train} steps) each: {runs}; one step at "
          f"{STEP_WINDOWS} windows, dropout off, sort vs scatter: loss rel "
          f"{loss_rel:.2e}, worst gradient {grad_rel[0]:.2e} ({grad_rel[1]}) "
          f"(bars {MOE_LAYOUT_TOL}); dropout {cfg.dropout_rate}, sort with "
          "--moe-remat vs without: loss and every gradient bitwise equal; "
          f"card {smi}", flush=True)


# expert parallelism (train_ep): the window forms B4s/B4ts at the step's
# routed rows (288 windows of 365, top-2: S = 210240) for each offset of E = 8
# at e_loc = 4 (the main path's: --tensor-parallel 2), 2 and 1; then
# wm-pretrain-torch under torchrun with 2 and 4 ranks sharing the card
EP_WINDOWS = 288
EP_E_LOCS = (4, 2, 1)
EP_MAIN_E_LOC = 4
# the fp32 one-step comparison's global batch, its SGD rate and its bars: the
# loss to 1e-5 relative and each parameter's gradient to 1e-3 in the L2 norm
# (STEP_TOL's), and the updated parameters entrywise to 1e-6 (a step of
# EP_LR times a gradient that differs only in its order of sums)
EP_STEP_BATCH, EP_LR = 4, 0.05
EP_STEP_TOL = dict(loss=1e-5, grad=1e-3, param=1e-6)
# the step's input seeds: the first is held against one process at the bars
# on both meshes; on each, 2 x 2 is held at the bars against 2 x 1 (pure data
# parallelism: the same 2 windows a rank, so the same rounding below the
# router), and 2 x 2 against one process is printed (4 windows in one
# forward round otherwise, and a top-2 near-tie may flip a route)
EP_STEP_SEEDS = (SEED + 8, SEED + 9, SEED + 10)
# the bf16 runs: a global batch of 32, 2 epochs on a store of 8 chunks of 24
EP_BATCH, EP_STORE_SAMPLES = 32, 24
EP_MESHES = ((1, 2), (2, 2))
# the window forms' timing: launches a reading after the warm-up ones (each
# window's form, full B4/B4t and the library call; the plain version one)
EP_TIMING = dict(iters=3, warmup=1)


def _window_call(op, lhs, other, gs, off, e_loc, plain=False):
    """B4s ("gmm", "gmm_t" for rhs^T) or B4ts ("tgmm") on the window [off,
    off + e_loc) of the E groups, or its plain version."""
    from weathermodel_tpu_torch.ops.gmm import (
        gmm_reference,
        gmm_sharded,
        tgmm_reference,
        tgmm_sharded,
    )

    if op == "tgmm":
        return (tgmm_reference if plain else tgmm_sharded)(
            lhs, other, gs, off, e_loc)
    w, trans = other[off:off + e_loc], op == "gmm_t"
    if plain:
        return gmm_reference(lhs, w, gs, trans, group_offset=off)
    return gmm_sharded(lhs, w, gs, off, trans_rhs=trans)


def _window_rows(gs, off, e_loc):
    bounds = [0] + torch.cumsum(gs, 0).tolist()
    return bounds[off], bounds[off + e_loc]


def _window_bound(op, lhs, other, gs, off, e_loc, dtype):
    """A window form's least time: 2 x (the window's rows) x K x N
    operations; it reads the window's rows of lhs (and of dy) and the local
    weights once and writes its output once (B4s: all S rows, zeros outside
    the window)."""
    lo, hi = _window_rows(gs, off, e_loc)
    rows, s, k = hi - lo, lhs.shape[0], lhs.shape[1]
    if op == "tgmm":
        n = other.shape[1]
        elems = rows * (k + n) + e_loc * k * n
    else:
        n = other.shape[1] if op == "gmm_t" else other.shape[2]
        elems = rows * k + e_loc * k * n + s * n
    return _bound(2.0 * rows * k * n, elems * dtype.itemsize, dtype)


def _ep_kernels(cfg):
    """(a): B4s and B4ts against their plain versions for every window, the
    shards' sum against full B4/B4t, times beside full B4 and the library
    call over the window. Returns the main path's (e_loc 4) bf16 records."""
    gs = _moe_group_sizes(cfg, EP_WINDOWS)
    s, e = int(gs.sum()), cfg.num_experts
    print(f"train_ep: kernels at S={s} (top-2 routing of {EP_WINDOWS} x "
          f"{SEQ_LEN} seeded windows, group sizes {gs.tolist()}), E={e}, "
          f"e_loc {EP_E_LOCS}, K x N = {cfg.hidden_dim} x {cfg.ffn_dim} and "
          f"back (tol {KERNEL_TOL}, {SCALE_TOL} x max)", flush=True)
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        cases = _gmm_cases(s, cfg.hidden_dim, cfg.ffn_dim, e, dtype,
                           SEED + 7)
        for name, (op, lhs, other) in cases.items():
            full = _gmm_call(op, lhs, other, gs)
            full_ms = _cuda_ms(lambda: _gmm_call(op, lhs, other, gs),
                               **EP_TIMING)
            for e_loc in EP_E_LOCS:
                parts, total, rs = [], None, []
                for off in range(0, e, e_loc):
                    got = _window_call(op, lhs, other, gs, off, e_loc)
                    want = _window_call(op, lhs, other, gs, off, e_loc,
                                        plain=True)
                    torch.cuda.synchronize()
                    err = _check_kernel(f"{name} e_loc {e_loc} off {off} "
                                        f"{dtype}", got, want, dtype)
                    del want
                    lo, hi = _window_rows(gs, off, e_loc)
                    if op != "tgmm" and (got[:lo].any() or got[hi:].any()):
                        raise AssertionError(f"{name} off {off}: non-zero "
                                             "rows outside the window")
                    if op == "tgmm":
                        parts.append(got)
                    else:  # each row is one window's: the sum is exact
                        total = got if total is None else total + got
                    del got
                    library, library_name = _gmm_library(
                        op, lhs[lo:hi], other[lo:hi] if op == "tgmm"
                        else other[off:off + e_loc], gs[off:off + e_loc])
                    rs.append(dict(
                        err=err[0],
                        bound=_window_bound(op, lhs, other, gs, off, e_loc,
                                            dtype),
                        ms=_cuda_ms(lambda: _window_call(
                            op, lhs, other, gs, off, e_loc), **EP_TIMING),
                        plain_ms=_cuda_ms(lambda: _window_call(
                            op, lhs, other, gs, off, e_loc, plain=True),
                            iters=1, warmup=1),
                        library_ms=_cuda_ms(library, **EP_TIMING),
                        library=library_name))
                if op == "tgmm":
                    total = torch.cat(parts)
                bitwise = torch.equal(total, full)
                if not bitwise:
                    _check_kernel(f"{name} e_loc {e_loc}: the shards' sum",
                                  total, full, dtype)
                del parts, total
                mean = {k: sum(r[k] for r in rs) / len(rs)
                        for k in ("ms", "plain_ms", "library_ms")}
                timed[dtype, name, e_loc] = dict(
                    op=op, full_ms=full_ms, bitwise=bitwise,
                    err=max(r["err"] for r in rs),
                    bound=sum(r["bound"][0] for r in rs) / len(rs),
                    bound_by=rs[0]["bound"][1], library=rs[0]["library"],
                    **mean)
                r = timed[dtype, name, e_loc]
                print(f"train_ep: {str(dtype).split('.')[1]} {name} ({op}) "
                      f"e_loc {e_loc}, {e // e_loc} windows: max|err| "
                      f"{r['err']:.3g}; window form {r['ms']:.3f} ms a "
                      f"window (mean), full {'B4t' if op == 'tgmm' else 'B4'}"
                      f" {full_ms:.3f}, plain {r['plain_ms']:.3f}, "
                      f"{r['library']} {r['library_ms']:.3f}, bound "
                      f"{r['bound']:.3f} by {r['bound_by']}; the shards' sum "
                      f"{'bitwise' if bitwise else 'within the bars of'} the "
                      f"full kernel's", flush=True)
            del full
        del cases
        torch.cuda.empty_cache()

    def record(ops):
        rs = [r for (d, _, e_loc), r in timed.items()
              if d == torch.bfloat16 and e_loc == EP_MAIN_E_LOC
              and r["op"] in ops]
        return dict(max_abs_err=max(r["err"] for r in rs),
                    ms=sum(r["ms"] for r in rs) / len(rs),
                    plain_ms=sum(r["plain_ms"] for r in rs) / len(rs),
                    bound_ms=sum(r["bound"] for r in rs) / len(rs),
                    bound_by=rs[0]["bound_by"],
                    library_ms=sum(r["library_ms"] for r in rs) / len(rs))

    return record(("gmm", "gmm_t")), record(("tgmm",))


def _run_ranks(tmp: Path, jobs, device="cuda:0", backend_name="gloo",
               timeout=600):
    """`torchrun` of parallel/step_check.py for each (name, ranks, tasks) of
    `jobs`, all started together, on `device` (cuda:0: every rank pinned to
    card 0; cuda: one card a rank), from this checkout: {name: (wall
    seconds, rank 0's line naming its backend, which must be
    `backend_name`)}; raises on a failed rank. Every process it starts has
    ended when it returns."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    running = {}
    try:
        for name, n, tasks in jobs:
            job = tmp / f"{name}.json"
            job.write_text(json.dumps({"device": device, "tasks": tasks}))
            logs = [open(tmp / f"{name}.{k}", "w+") for k in ("out", "err")]
            running[name] = (n, logs, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(n), "-m",
                 "weathermodel_tpu_torch.parallel.step_check", str(job)],
                cwd=root, env=env, stdout=logs[0], stderr=logs[1]))
        done, start = {}, time.perf_counter()
        while len(done) < len(running):
            for name, (_, _, t0, proc) in running.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
            if time.perf_counter() - start > timeout:
                raise AssertionError(f"torchrun jobs {sorted(running)}: "
                                     f"not done in {timeout} s")
            time.sleep(0.2)
    finally:
        for _, logs, _, proc in running.values():
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            for log in logs:
                log.seek(0)
    results = {}
    for name, (n, (out, err), _, proc) in running.items():
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        if proc.returncode != 0:
            raise AssertionError(f"{name}: torchrun exited {proc.returncode}"
                                 f":\n{stdout[-3000:]}\n{stderr[-6000:]}")
        backend = [ln.split(" - ")[-1] for ln in stderr.splitlines()
                   if "multihost:" in ln]
        if len(backend) != 1 or f"backend {backend_name}" not in backend[0]:
            raise AssertionError(f"{name}: rank 0 logged {backend}, not one "
                                 f"line naming {backend_name}")
        tasks_s = [ln.split("step_check: ")[-1]
                   for ln in stderr.splitlines() if "step_check: task" in ln]
        beside = sorted(set(running) - {name})
        print(f"{name}: torchrun of {n} ranks {done[name]:.1f} s"
              f"{' beside ' + ', '.join(beside) if beside else ''}; rank 0's "
              f"tasks: {'; '.join(tasks_s)}", flush=True)
        results[name] = (done[name], backend[0])
    return results


def _on_card(step):
    """A step's results (step_task's dict or its npz) with every array on
    the card, for comparing: the 0-dim entries as floats."""
    return {k: float(v) if np.ndim(v) == 0 else torch.from_numpy(
        np.asarray(v)).to("cuda") for k, v in step.items()}


def _ep_step_check(mesh, got, want, check=True):
    """The fp32 mesh step against a reference step (one process, or
    another mesh; both through _on_card), at EP_STEP_TOL when `check`:
    text, and whether every number is bitwise equal."""
    loss = abs(got["metric/total_loss"] - want["metric/total_loss"]) / abs(
        want["metric/total_loss"])
    aux = abs(got["metric/moe_aux"] - want["metric/moe_aux"]) / abs(
        want["metric/moe_aux"])
    grad, worst = max((float((got[k] - want[k]).norm()
                             / max(float(want[k].norm()), 1e-30)), k[5:])
                      for k in want if k.startswith("grad/"))
    param = max(float((got[k] - want[k]).abs().max())
                for k in want if k.startswith("param/"))
    keys = [k for k in want if k.startswith(("metric/", "grad/", "param/"))]
    equal = [k for k in keys if (got[k] == want[k] if k.startswith("metric/")
                                 else torch.equal(got[k], want[k]))]
    bitwise = len(equal) == len(keys)
    if check and not (loss <= EP_STEP_TOL["loss"]
                      and aux <= EP_STEP_TOL["loss"]
                      and grad <= EP_STEP_TOL["grad"]
                      and param <= EP_STEP_TOL["param"]):
        raise AssertionError(f"mesh {mesh} fp32 step: loss {loss:.3g}, aux "
                             f"{aux:.3g}, worst gradient {grad:.3g}, updated "
                             f"parameters {param:.3g} from the reference "
                             f"step (bars {EP_STEP_TOL})")
    return (f"{mesh[0]}x{mesh[1]}: loss {got['metric/total_loss']:.7f} "
            f"(reference {want['metric/total_loss']:.7f}, rel {loss:.3g}), "
            f"aux rel {aux:.3g}, worst gradient {grad:.3g} ({worst}), "
            f"updated parameters max|diff| {param:.3g}; {len(equal)} of "
            f"{len(keys)} metrics, gradients and parameters bitwise equal"
            ), bitwise


def _ep_tasks(tmp: Path, cfg, step_windows, store_samples, batch_size,
              device, seeds=EP_STEP_SEEDS[:1]):
    """The seeded fp32 state, the step inputs of each of `seeds` and the
    store of the EP runs, and step(mesh, seed) / cli(mesh, tag): their
    step_check tasks."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.data.chunks import write_synthetic_dataset
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    overrides = dict(MOE, compute_dtype="float32", dropout_rate=0.0)
    model = make_model("weatherbert",
                       model_config_for_size(MODEL_SIZE, **overrides),
                       "fused_qkv")
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    torch.save(model.state_dict(), tmp / "ep_state.pth")
    del model
    for seed in seeds:
        batch, mask = _windows_batch(step_windows, seed)
        np.savez(tmp / f"ep_inputs_{seed}.npz", weather=batch.weather,
                 coords=batch.coords, year=batch.year,
                 interval=batch.interval, mask=mask)
    store = tmp / "ep_store"
    write_synthetic_dataset(str(store), n_chunks=8, n_samples=store_samples,
                            seq_len=SEQ_LEN, seed=SEED)

    def step(mesh, seed=seeds[0], tag="", state="ep_state.pth", model=None,
             **options):
        """A step task: the MoE model (`model`: other overrides) or
        another state; `options` for step_check (fsdp, storage, digest,
        arrays)."""
        return dict(kind="step", mesh=list(mesh), lr=EP_LR,
                    inputs=str(tmp / f"ep_inputs_{seed}.npz"),
                    state=str(tmp / state),
                    config=dict(size=MODEL_SIZE,
                                overrides=model or overrides,
                                attention_impl="fused_qkv"),
                    out=str(tmp / f"ep_step_{mesh[0]}x{mesh[1]}_{seed}{tag}"
                                  ".npz"), **options)

    def cli(mesh, tag=None):
        tag = tag or f"{mesh[0]}x{mesh[1]}"
        argv = ["--model", "weatherbert", "--model-size", MODEL_SIZE,
                "--moe-experts", str(cfg.num_experts), "--moe-top-k",
                str(cfg.moe_top_k), "--batch-size", str(batch_size),
                "--n-epochs", "2", "--n-warmup-epochs", "0",
                "--masking-prob", "0.15", "--data-dir", str(store),
                "--workdir", str(tmp / f"ep_run_{tag}"), "--compute-dtype",
                "bfloat16", "--device", device]
        if mesh[0] * mesh[1] > 1:
            argv += ["--tensor-parallel", str(mesh[1])]
        return dict(kind="pretrain", out=str(tmp / f"ep_cli_{tag}"),
                    argv=argv)

    return step, cli


# sharded storage in train_ep: the sort dispatch's expert split, and the
# dense WeatherBERT-large (fp32, dropout off) of the --fsdp step
SORT_EP = dict(MOE, compute_dtype="float32", dropout_rate=0.0,
               moe_dispatch="sort")
DENSE_EP = dict(compute_dtype="float32", dropout_rate=0.0)


def _storage_state(tmp: Path) -> dict:
    """The seeded dense WeatherBERT-large's state for the --fsdp step: the
    step options that name it."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    model = make_model("weatherbert", model_config_for_size(
        MODEL_SIZE, **DENSE_EP), "fused_qkv")
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    torch.save(model.state_dict(), tmp / "ep_dense.pth")
    return dict(state="ep_dense.pth", model=DENSE_EP)


def _expected_stored(cfg, mesh, fsdp=False) -> int:
    """The parameter entries a rank of `mesh` holds by the sharding rules,
    for the model of `cfg` (built on the meta device)."""
    from weathermodel_tpu_torch.cli.pretrain import make_model
    from weathermodel_tpu_torch.parallel import mesh as mesh_lib

    with torch.device("meta"):
        model = make_model("weatherbert", cfg, "fused_qkv")
    m = mesh_lib.Mesh(*mesh)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    return mesh_lib.expected_elements(shapes, {
        k: mesh_lib.combined_sharding_rules(k, v, m, fsdp=fsdp)
        for k, v in shapes.items()}, m)


def _storage_check(tmp: Path, what, mesh, tag, plain, full, seed, smi):
    """A step with sharded storage against the same mesh's step without it
    (only the experts split): the metrics and the digest of every gradient
    and updated parameter must be equal (bitwise, -0.0 = 0.0), each rank's
    stored parameters those its blocks hold by the rules and its kernel
    launches the plain step's. `full`: one process's parameter entries
    (None: the plain step's)."""
    def read(suffix):
        with np.load(tmp / f"ep_step_{mesh[0]}x{mesh[1]}_{seed}{suffix}.npz"
                     ) as z:
            return {k: z[k] for k in z if not k.startswith(("grad/",
                                                            "param/"))}

    got, want = read(tag), read(plain)
    keys = [k for k in want if k.startswith(("metric/", "hash/"))]
    equal = [k for k in keys if np.array_equal(got[k], want[k])]
    stored = got["stored/params"]
    launches = {k[len("launches/"):]: got[k].astype(int).tolist()
                for k in got if k.startswith("launches/") and got[k].any()}
    if len(equal) != len(keys) or len(keys) < 3 or not np.array_equal(
            stored, got["stored/by_rules"]) or launches != {
                k[len("launches/"):]: want[k].astype(int).tolist()
                for k in want if k.startswith("launches/") and want[k].any()}:
        raise AssertionError(
            f"{what} on {mesh}: {len(equal)} of {len(keys)} metrics and "
            f"digests equal to the mesh without sharded storage (unequal: "
            f"{sorted(set(keys) - set(equal))[:6]}); stored entries a rank "
            f"{stored.tolist()}, by the rules "
            f"{got['stored/by_rules'].tolist()}"
            f"; launches a rank {launches}, without sharded storage "
            f"{ {k: want[k].tolist() for k in want if 'launches/' in k} }")
    full = int(want["stored/params"][0]) if full is None else full
    return (f"sharded storage, {what}, mesh {mesh[0]}x{mesh[1]}, one fp32 "
            f"step: all {len(keys)} metrics and gradient and parameter "
            f"digests bitwise equal to the same mesh without sharded storage, "
            f"and its launches a rank {launches}; "
            f"stored parameters + Adam moments a rank "
            f"{[round(12 * x / 1e9, 3) for x in stored.tolist()]} GB (the "
            f"rules' blocks, {stored.astype(int).tolist()} parameters) "
            f"against {12 * full / 1e9:.3f} GB in one process; card {smi}")


def phase_train_ep(smi: str, tmp: Path):
    """(a) the window forms B4s/B4ts; (b) the EP trainer under torchrun on
    WeatherBERT-large E=8 top-2 (ragged): an fp32 step on meshes 1x2 and
    2x2 against the one-process step, then wm-pretrain-torch in bf16."""
    from weathermodel_tpu_torch.parallel.step_check import step_task
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    cfg = model_config_for_size(MODEL_SIZE, **MOE)
    parts, t0 = {}, time.perf_counter()
    b4s, b4ts = _ep_kernels(cfg)
    parts["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, cli = _ep_tasks(tmp, cfg, EP_STEP_BATCH, EP_STORE_SAMPLES,
                          EP_BATCH, "cuda:0", seeds=EP_STEP_SEEDS)
    dense = _storage_state(tmp)
    parts["inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    main_seed = EP_STEP_SEEDS[0]
    ones = {}
    for seed in EP_STEP_SEEDS:
        ones[seed] = _on_card(step_task(step((1, 1), seed),
                                        torch.device("cuda")))
        gc.collect()
        torch.cuda.empty_cache()
    # the sort dispatch's one-process step, which its 1 x 2 split must match
    one_sort = _on_card(step_task(step((1, 1), tag="-sort", model=SORT_EP),
                                  torch.device("cuda")))
    gc.collect()
    torch.cuda.empty_cache()
    parts["one-process steps"] = time.perf_counter() - t0
    # 2 x 1 runs in the two-rank job, beside 1 x 2; the two jobs run side by
    # side (6 ranks on the card). Sharded storage: each case's step and the
    # same mesh's without it (only the experts split), compared by digests
    # (sort on 1 x 2 also holds the dense split: its pair differs in that
    # alone; its arrays are held against the one-process sort step too)
    hashed = dict(digest=True, arrays=False)
    tasks = {(1, 2): [step((1, 2)),
                      *(step((2, 1), seed) for seed in EP_STEP_SEEDS),
                      step((1, 2), tag="-sort", model=SORT_EP, digest=True),
                      step((1, 2), tag="-sort-experts", model=SORT_EP,
                           storage="experts", **hashed),
                      step((2, 1), tag="-dense", **dense, **hashed),
                      step((2, 1), tag="-dense-fsdp", fsdp=True, **dense,
                           **hashed)],
             (2, 2): [*(step((2, 2), seed) for seed in EP_STEP_SEEDS),
                      step((2, 2), tag="-fsdp", fsdp=True, **hashed),
                      step((2, 2), tag="-experts", storage="experts",
                           **hashed)]}
    t0 = time.perf_counter()
    runs = _run_ranks(tmp, [(f"ep_{m[0]}x{m[1]}", m[0] * m[1],
                             tasks[m] + [cli(m)]) for m in EP_MESHES])
    wall = {m: runs[f"ep_{m[0]}x{m[1]}"][0] for m in EP_MESHES}
    backend = {m: runs[f"ep_{m[0]}x{m[1]}"][1] for m in EP_MESHES}
    parts["torchrun jobs"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    @functools.cache
    def load(mesh, seed):
        with np.load(tmp / f"ep_step_{mesh[0]}x{mesh[1]}_{seed}.npz") as z:
            return _on_card(z)

    def check_launches(mesh, got, want):
        for k in ("gmm", "tgmm", "gmm_sharded", "tgmm_sharded"):
            if got[f"launches/{k}"].tolist() != [want.get(k, 0)] * len(
                    got[f"launches/{k}"]):
                raise AssertionError(f"mesh {mesh} step: {k} launches "
                                     f"{got[f'launches/{k}']}, expected "
                                     f"{want.get(k, 0)} a rank")

    layers = cfg.num_layers
    per_rank_step = {"gmm_sharded": 4 * layers, "tgmm_sharded": 2 * layers}
    full_step = {"gmm": 4 * layers, "tgmm": 2 * layers}
    for seed, one in ones.items():
        check_launches((1, 1), one, full_step)
    main_launches, against_one = None, {}
    for mesh in EP_MESHES:
        n = mesh[0] * mesh[1]
        got = load(mesh, main_seed)
        text, _ = _ep_step_check(mesh, got, ones[main_seed])
        against_one[mesh] = text
        check_launches(mesh, got, per_rank_step)
        print(f"train_ep: fp32 step, WeatherBERT-{MODEL_SIZE} E="
              f"{cfg.num_experts} top-{cfg.moe_top_k}, {EP_STEP_BATCH} "
              f"windows (input seed {main_seed}), SGD {EP_LR}, {n} ranks on "
              f"cuda:0 (gloo) against one process: {text}; masked counts a "
              f"rank {got['mask_counts'].tolist()}; B4s/B4ts launches a rank "
              f"{got['launches/gmm_sharded'].tolist()} / "
              f"{got['launches/tgmm_sharded'].tolist()} (expected "
              f"{per_rank_step['gmm_sharded']} / "
              f"{per_rank_step['tgmm_sharded']} a microbatch)", flush=True)
        if mesh == (2, 2):
            for seed in EP_STEP_SEEDS:
                ep, dp = load((2, 2), seed), load((2, 1), seed)
                check_launches((2, 2), ep, per_rank_step)
                check_launches((2, 1), dp, full_step)
                vs_dp, _ = _ep_step_check((2, 2), ep, dp)
                dp_one, _ = _ep_step_check((2, 1), dp, ones[seed],
                                           check=False)
                # at the main seed: the check at the bars above
                ep_one = (against_one[2, 2] if seed == main_seed else
                          _ep_step_check((2, 2), ep, ones[seed],
                                         check=False)[0])
                print(f"train_ep: fp32 step, input seed {seed}: 2x2 against "
                      f"2x1 (the same 2 windows a rank; bars): {vs_dp}; 2x1 "
                      f"against one process (printed): {dp_one}; 2x2 "
                      f"against one process ("
                      f"{'bars' if seed == main_seed else 'printed'}): "
                      f"{ep_one}", flush=True)
        ranks = [json.loads((tmp / f"ep_cli_{mesh[0]}x{mesh[1]}.rank{r}.json")
                 .read_text()) for r in range(n)]
        result = ranks[0]["result"]
        steps = sum(len(x) for x in result["train_step_seconds"])
        val_batches = sum(result["val_batches"])
        expected = {"gmm_sharded": 32 * steps + 16 * val_batches,
                    "tgmm_sharded": 16 * steps, "gmm": 0, "tgmm": 0,
                    "fused_qkv_attention": cfg.num_layers * val_batches,
                    "fused_qkv_attention_train": cfg.num_layers * steps,
                    "fused_qkv_attention_bwd": cfg.num_layers * steps}
        for r in ranks:
            if r["launches"] != expected:
                raise AssertionError(f"mesh {mesh} rank {r['rank']}: "
                                     f"launches {r['launches']}, expected "
                                     f"{expected} ({steps} steps, "
                                     f"{val_batches} validation batches)")
        record = json.loads((tmp / f"ep_run_{mesh[0]}x{mesh[1]}" /
                             "weatherbert_output.json").read_text())
        train_loss, val_loss = _check_record(record, ("total_loss",
                                                      "moe_aux"))
        if record["model_config"]["n_devices"] != n:
            raise AssertionError(f"n_devices {record['model_config']}")
        stored = [r["result"]["stored_elements"] for r in ranks]
        want = _expected_stored(cfg, mesh)
        if any(x != {"params": want, "optimizer": 2 * want} for x in stored):
            raise AssertionError(f"mesh {mesh}: stored entries a rank "
                                 f"{stored}, the rules give {want} "
                                 "parameters and twice that in Adam")
        step_s = float(np.median(result["train_step_seconds"][-1]))
        if mesh == EP_MESHES[0]:
            main_launches = {k: sum(r["launches"][k] for r in ranks)
                             for k in ("gmm_sharded", "tgmm_sharded")}
        print(f"train_ep: wm-pretrain-torch --tensor-parallel {mesh[1]} on "
              f"{n} ranks sharing cuda:0 (mesh {mesh[0]}x{mesh[1]}, gloo), "
              f"bf16 --batch-size {EP_BATCH}, 2 epochs: {steps} steps and "
              f"{val_batches} validation batches; train loss {train_loss} "
              f"(moe_aux {record['losses']['train']['moe_aux']}), val loss "
              f"{val_loss}; launches a rank {expected} (a rank per "
              f"microbatch: 32 B4s, 16 B4ts); epoch 2 median "
              f"{step_s * 1e3:.1f} ms/step, {EP_BATCH / step_s:.2f} samples/s "
              f"(one card: the ranks take turns on it, the other job's "
              f"ranks beside them, and gloo copies each all_reduce through "
              f"the host, so this is not EP's rate); peak memory a rank "
              f"{[round(r['peak_gb'], 2) for r in ranks]} GB; stored "
              f"parameters and Adam moments a rank {12 * want / 1e9:.3f} GB "
              f"(the rules' blocks: the experts and the dense weights split "
              f"over 'model'); torchrun "
              f"{wall[mesh]:.1f} s, rank 0 logged '{backend[mesh]}'; card "
              f"{smi}", flush=True)
    sort_text, _ = _ep_step_check((1, 2), load((1, 2), f"{main_seed}-sort"),
                                  one_sort)
    print(f"train_ep: fp32 step, --moe-dispatch sort, "
          f"{EP_STEP_BATCH} windows, 2 ranks on cuda:0 (each its 4 experts' "
          f"window of the capacity buffer, the dense weights split over "
          f"'model') against the one-process sort step: {sort_text}; card "
          f"{smi}", flush=True)
    del one_sort
    load.cache_clear()
    one_full = int(ones[main_seed]["stored/params"].sum())
    for what, mesh, tag, plain, full in (
            ("--moe-dispatch sort's expert split (each rank its 4 experts' "
             "window of the capacity buffer) with the dense weights split "
             "over 'model'", (1, 2), "-sort", "-sort-experts", one_full),
            ("--fsdp (dense WeatherBERT-large)", (2, 1), "-dense-fsdp",
             "-dense", None),
            ("--fsdp --tensor-parallel 2 (MoE, ragged)", (2, 2), "-fsdp",
             "-experts", one_full)):
        print("train_ep: " + _storage_check(tmp, what, mesh, tag, plain, full,
                                           main_seed, smi), flush=True)
    parts["checks"] = time.perf_counter() - t0
    print(f"train_ep: seconds by part "
          f"{ {k: round(v, 1) for k, v in parts.items()} }", flush=True)
    return (dict(b4s, launches=main_launches["gmm_sharded"]),
            dict(b4ts, launches=main_launches["tgmm_sharded"]))


# expert parallelism on separate cards, `python3 chip_smoke.py --ep-cards N`
# (not part of the default run, which needs one card): a (N/2) x 2 mesh, one
# card a rank under NCCL, against one process on one card, at a batch where
# the one-card MoE step is compute-bound (2 epochs of 4 steps of 192)
EP_CARDS_BATCH, EP_CARDS_STORE_SAMPLES, EP_CARDS_STEP_WINDOWS = 192, 168, 8


def phase_ep_cards(smi: str, tmp: Path, n_cards: int):
    from weathermodel_tpu_torch.cli import pretrain
    from weathermodel_tpu_torch.parallel.step_check import (
        counted_kernels,
        step_task,
    )
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    if n_cards < 2 or n_cards % 2 or torch.cuda.device_count() < n_cards:
        raise SystemExit(f"--ep-cards {n_cards}: needs an even count of at "
                         f"least 2 of the {torch.cuda.device_count()} cards")
    cfg = model_config_for_size(MODEL_SIZE, **MOE)
    mesh = (n_cards // 2, 2)
    step, cli = _ep_tasks(tmp, cfg, EP_CARDS_STEP_WINDOWS,
                          EP_CARDS_STORE_SAMPLES, EP_CARDS_BATCH, "cuda")
    ((wall, backend),) = _run_ranks(
        tmp, [("ep_cards", n_cards, [step(mesh), cli(mesh)])],
        device="cuda", backend_name="nccl", timeout=1200).values()
    one = _on_card(step_task(step((1, 1)), torch.device("cuda:0")))
    with np.load(tmp / f"ep_step_{mesh[0]}x{mesh[1]}_{EP_STEP_SEEDS[0]}.npz"
                 ) as z:
        text, _ = _ep_step_check(mesh, _on_card(z), one)
    print(f"ep_cards: fp32 step, {EP_CARDS_STEP_WINDOWS} windows, {n_cards} "
          f"ranks a card each against one process: {text}", flush=True)
    ranks = [json.loads((tmp / f"ep_cli_{mesh[0]}x{mesh[1]}.rank{r}.json")
             .read_text()) for r in range(n_cards)]
    result = ranks[0]["result"]
    steps = sum(len(x) for x in result["train_step_seconds"])
    val_batches = sum(result["val_batches"])
    want = {"gmm_sharded": 32 * steps + 16 * val_batches,
            "tgmm_sharded": 16 * steps, "gmm": 0, "tgmm": 0}
    for r in ranks:
        got = {k: r["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"ep_cards rank {r['rank']}: {got}, "
                                 f"expected {want}")
    ep_s = float(np.median(result["train_step_seconds"][-1]))
    kernels = counted_kernels()
    for fn in kernels:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    one_run = pretrain.run(pretrain.build_parser().parse_args(
        cli((1, 1), "one")["argv"]))
    one_s = float(np.median(one_run["train_step_seconds"][-1]))
    one_gb = torch.cuda.max_memory_allocated() / 1e9
    for tag in (f"{mesh[0]}x{mesh[1]}", "one"):
        record = json.loads((tmp / f"ep_run_{tag}" /
                             "weatherbert_output.json").read_text())
        _check_record(record, ("total_loss", "moe_aux"))
    print(f"ep_cards: wm-pretrain-torch --tensor-parallel 2 on {n_cards} "
          f"cards (mesh {mesh[0]}x{mesh[1]}, rank 0 logged '{backend}'), "
          f"bf16 --batch-size {EP_CARDS_BATCH}, 2 epochs of {steps // 2} "
          f"steps: epoch 2 median {ep_s * 1e3:.1f} ms/step, "
          f"{EP_CARDS_BATCH / ep_s:.1f} samples/s, peak "
          f"{[round(r['peak_gb'], 2) for r in ranks]} GB a rank, B4s/B4ts "
          f"{want['gmm_sharded']}/{want['tgmm_sharded']} a rank; one process "
          f"on one card: {one_s * 1e3:.1f} ms/step, "
          f"{EP_CARDS_BATCH / one_s:.1f} samples/s, peak {one_gb:.2f} GB, "
          f"{dict((fn.__name__, fn.launches) for fn in kernels)}; torchrun "
          f"{wall:.1f} s; cards {smi} x {n_cards}", flush=True)


# the export: two padding buckets (daemon batches and small requests), the
# MoE bundle one (its program holds ~170 M fp32 parameters, 0.7 GB)
EXPORT_BUCKETS, EXPORT_MOE_BUCKETS = (32, BATCH), (BATCH,)
# a child process loads a bundle with torch alone and reports which modules
# of the port it imported (none may be)
EXPORT_CHILD = """
import io, json, sys
import numpy as np, torch
import time
path, bucket, inputs, out = sys.argv[1:5]
t0 = time.perf_counter()
with np.load(path) as z:
    manifest = json.loads(bytes(z["manifest"].tobytes()).decode())
    blob = z[f"bucket_{bucket}_cuda"].tobytes()
fn = torch.export.load(io.BytesIO(blob)).module()
load_s = time.perf_counter() - t0
with np.load(inputs) as z:
    args = [torch.from_numpy(z[k]).cuda() for k in
            ("weather", "coords", "year", "interval", "mask")]
with torch.inference_mode():
    np.save(out, fn(*args).float().cpu().numpy())
print(json.dumps({"format": manifest["format"], "ops": manifest["ops"],
                  "load_s": load_s,
                  "port_modules": sorted(m for m in sys.modules
                                         if m.startswith("weathermodel"))}))
"""


def _export_cli(checkpoint: Path, out: Path, dtype: str, buckets, *extra):
    """`wm-export-torch --platforms cuda` of `checkpoint`: (manifest, MB)."""
    from weathermodel_tpu_torch.cli import export

    manifest = export.main([
        "--checkpoint", str(checkpoint), "--model", "weatherbert",
        "--model-size", MODEL_SIZE, "--output", str(out), "--seq-len",
        str(SEQ_LEN), "--buckets", ",".join(map(str, buckets)),
        "--platforms", "cuda", "--compute-dtype", dtype, *extra])
    if manifest["platforms"] != ["cuda"] or manifest["buckets"] != list(
            buckets):
        raise AssertionError(f"wm-export-torch manifest {manifest}")
    return manifest


def _bundle_serve(path: Path, windows, counted=()):
    """ExportedPredictor of `path` on the card over `windows`, every wrapper
    in `counted` at 0 just before: (output, load seconds, predict seconds,
    launches by wrapper, the predictor)."""
    from weathermodel_tpu_torch.export_artifact import ExportedPredictor

    pred = ExportedPredictor(str(path), "cuda")
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pred(windows["weather"], windows["coords"], windows["year"],
               windows["interval"], windows["mask"])
    predict_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    if not np.isfinite(out).all():
        raise AssertionError(f"{path.name}: non-finite served output")
    return out, pred.load_seconds, predict_s, launches, pred


def _live_torch(checkpoint: Path, dtype: str, windows, **moe):
    from weathermodel_tpu_torch.serve import load_weather_predictor

    predictor = load_weather_predictor(
        str(checkpoint), MODEL_SIZE, attention_impl="torch", max_len=SEQ_LEN,
        buckets=EXPORT_BUCKETS, compute_dtype=dtype, device="cuda", **moe)
    out = predictor(windows["weather"], windows["coords"], windows["year"],
                    windows["interval"], windows["mask"])
    del predictor
    torch.cuda.empty_cache()
    return out


def phase_export(smi: str, tmp: Path):
    from weathermodel_tpu_torch.ops.gmm import gmm
    from weathermodel_tpu_torch.utils.config import model_config_for_size

    with np.load(tmp / "windows.npz") as z:
        windows = dict(z)
    counted = _all_kernels()
    lines, served, child = [], None, None
    head = {k: v[:EXPORT_BUCKETS[0]] for k, v in windows.items()}
    np.savez(tmp / "export_head.npz", **head)
    try:
        for dtype, buckets in (("bfloat16", EXPORT_BUCKETS),
                               ("float32", EXPORT_BUCKETS[-1:])):
            path = tmp / f"large_{dtype}.wmx"
            manifest = _export_cli(tmp / "weatherbert_large.pth", path,
                                   dtype, buckets)
            if manifest["ops"]:
                raise AssertionError(f"the dense bundle holds ops "
                                     f"{manifest['ops']}")
            if dtype == "bfloat16":
                # a process that imports nothing of the port loads the
                # bundle, beside the exports below
                child = subprocess.Popen(
                    [sys.executable, "-c", EXPORT_CHILD, str(path),
                     str(EXPORT_BUCKETS[0]), str(tmp / "export_head.npz"),
                     str(tmp / "export_child.npy")], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, cwd=str(tmp))
            out, load_s, predict_s, launches, pred = _bundle_serve(
                path, windows, counted)
            _only(launches)  # the plain attention: no kernel of the port
            err = _serve_err(out, _live_torch(tmp / "weatherbert_large.pth",
                                              dtype, windows))
            _check_serve_err("bundle vs the live torch predictor", err,
                             dtype)
            if dtype == "bfloat16":
                served = pred
            lines.append(f"{dtype} buckets {list(buckets)}: "
                         f"{manifest['mb']:.1f} MB, written in "
                         f"{manifest['write_seconds']:.1f} s (trace "
                         f"{sum(manifest['export_seconds'].values()):.1f} "
                         f"s), loaded in {load_s:.1f} s, {N_WINDOWS} windows "
                         f"in {predict_s:.3f} s, (max, RMS)/RMS vs live "
                         f"{err}")
        # the MoE checkpoint of serve_moe_int8: B4 inside the program
        moe = ("--moe-experts", str(MOE["num_experts"]), "--moe-top-k",
               str(MOE["moe_top_k"]))
        path = tmp / "large_moe.wmx"
        manifest = _export_cli(tmp / "weatherbert_large_moe.pth", path,
                               "bfloat16", EXPORT_MOE_BUCKETS, *moe)
        if manifest["ops"] != ["wm::gmm"]:
            raise AssertionError(f"the MoE bundle's ops {manifest['ops']}")
        out, load_s, predict_s, launches, _ = _bundle_serve(path, windows,
                                                             counted)
        chunks = -(-N_WINDOWS // EXPORT_MOE_BUCKETS[-1])
        layers = model_config_for_size(MODEL_SIZE).num_layers
        _only(launches, gmm=2 * layers * chunks)
        moe_err = _serve_err(out, _live_torch(
            tmp / "weatherbert_large_moe.pth", "bfloat16", windows,
            num_experts=MOE["num_experts"], moe_top_k=MOE["moe_top_k"]))
        _check_serve_err("MoE bundle vs the live MoE predictor", moe_err,
                         "bfloat16")
        lines.append(f"MoE E={MOE['num_experts']} top-{MOE['moe_top_k']} "
                     f"bf16 bucket {EXPORT_MOE_BUCKETS[0]}: "
                     f"{manifest['mb']:.1f} MB, written in "
                     f"{manifest['write_seconds']:.1f} s, loaded in "
                     f"{load_s:.1f} s, {N_WINDOWS} windows in "
                     f"{predict_s:.3f} s, launches "
                     f"{ {gmm.__name__: launches['gmm']} }, (max, RMS)/RMS "
                     f"vs live {moe_err}")
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
    if child.returncode != 0:
        raise AssertionError(f"the bundle's child process failed: "
                             f"{stderr[-2000:]}")
    report = json.loads(stdout.strip().splitlines()[-1])
    if report["port_modules"]:
        raise AssertionError(f"loading a dense bundle imported "
                             f"{report['port_modules']}")
    want = served(*(head[k] for k in ("weather", "coords", "year",
                                      "interval", "mask")))
    if not np.array_equal(np.load(tmp / "export_child.npy"), want):
        raise AssertionError("the child's answer differs from "
                             "ExportedPredictor's for the same bucket")
    print(f"export: wm-export-torch WeatherBERT-{MODEL_SIZE} --platforms "
          f"cuda, attention torch: " + "; ".join(lines) + f"; bar "
          f"{SERVE_TOL}; a child process loaded the bf16 bundle in "
          f"{report['load_s']:.1f} s importing {report['port_modules']} of "
          f"the port, its answer bitwise ExportedPredictor's; card {smi}",
          flush=True)
    return served


def phase_serve_bundle(smi: str, tmp: Path, daemon_stats: dict, exported):
    """`exported` is phase_export's ExportedPredictor of the served bundle."""
    from weathermodel_tpu_torch.export_artifact import ExportedPredictor

    served, second = tmp / "large_bfloat16.wmx", tmp / "second.wmx"
    n = DAEMON_CLIENTS * DAEMON_REQUESTS * DAEMON_WINDOWS
    windows = _windows(np.random.default_rng(SEED + 3), n)
    port = _free_port()
    log_path = tmp / "bundle_daemon.log"
    cmd = [sys.executable, "-m", "weathermodel_tpu_torch.cli.serve",
           "--daemon", "--bundle", str(served), "--allow-reload",
           "--port", str(port), "--device", "cuda"]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=Path(__file__).resolve().parent)
    try:
        # the reload's bundle is written while the daemon starts
        _export_cli(tmp / "second.pth", second, "bfloat16", EXPORT_BUCKETS)
        _wait_healthy(proc, port, log_path)
        start_s = time.perf_counter() - t0
        answers, errors = {}, []

        def client(c):
            try:
                for r in range(DAEMON_REQUESTS):
                    i0 = (c * DAEMON_REQUESTS + r) * DAEMON_WINDOWS
                    answers[i0] = _predict(port, {
                        k: v[i0:i0 + DAEMON_WINDOWS]
                        for k, v in windows.items()})
            except Exception as e:  # re-raised below, in the main thread
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(DAEMON_CLIENTS)]
        t1 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t1
        if errors:
            raise errors[0]
        got = np.concatenate([answers[i] for i in sorted(answers)])

        def run(pred, w):
            return pred(w["weather"], w["coords"], w["year"], w["interval"],
                        w["mask"])

        err = _serve_err(got, run(exported, windows))
        _check_serve_err("bundle daemon vs ExportedPredictor", err,
                         "bfloat16")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        if stats["n_rows"] != n or not stats["bundle"]:
            raise AssertionError(f"/stats {stats}: expected {n} rows of a "
                                 "bundle")
        refused, body = _http(port, "POST", "/reload", json.dumps(
            {"bundle": str(tmp / "large_float32.wmx")}).encode())
        if refused != 400 or b"buckets" not in body:
            raise AssertionError(f"/reload of a bundle of other buckets "
                                 f"answered {refused}: {body[:300]}")
        status, data = _http(port, "POST", "/reload", json.dumps(
            {"bundle": str(second)}).encode())
        if status != 200:
            raise AssertionError(f"/reload answered {status}: {data[:300]}")
        head = {k: v[:DAEMON_WINDOWS] for k, v in windows.items()}
        reloaded = _predict(port, head)
        reload_err = _serve_err(reloaded, run(
            ExportedPredictor(str(second), "cuda"), head))
        _check_serve_err("bundle daemon after /reload vs the new bundle",
                         reload_err, "bfloat16")
        if np.allclose(reloaded, got[:DAEMON_WINDOWS]):
            raise AssertionError("/reload did not change the answers")
        stats = json.loads(_http(port, "GET", "/stats")[1])
        if stats["n_reloads"] != 1 or stats["checkpoint"] != str(second):
            raise AssertionError(f"/stats after /reload {stats}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=DAEMON_STOP_S)
        if rc != 0:
            raise AssertionError(f"the daemon exited with {rc} on SIGTERM: "
                                 f"{log_path.read_text()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lat, ck = stats["latency_ms"], daemon_stats["latency_ms"]
    print(f"serve_bundle: wm-serve-torch --daemon --bundle (bf16, buckets "
          f"{list(EXPORT_BUCKETS)}): /healthz after {start_s:.1f} s (start, "
          f"load, warm-up; the reload's bundle written meanwhile); "
          f"{DAEMON_CLIENTS} clients x {DAEMON_REQUESTS} x {DAEMON_WINDOWS} "
          f"windows: {n / wall:.1f} windows/s, p50 {lat['p50']} ms, p99 "
          f"{lat['p99']} ms (checkpoint daemon, fused_qkv_op: "
          f"{daemon_stats['windows_per_s']:.1f} windows/s, p50 {ck['p50']} "
          f"ms, p99 {ck['p99']} ms); vs ExportedPredictor (max, RMS)/RMS "
          f"{err}, after /reload {{\"bundle\": ...}} {reload_err}; a "
          f"bundle of other buckets refused (400); exit 0 on SIGTERM; card "
          f"{smi}", flush=True)


def phase_train_cnn(smi: str, data: Path, tmp: Path, crop_df):
    """`crop_df` is the yield phase's synthetic frame."""
    counted = _all_kernels()
    argv = ["--model", "weathercnn", "--batch-size", str(FORMER_BATCH),
            "--n-epochs", "2", "--n-warmup-epochs", "0", "--data-dir",
            str(data), "--workdir", str(tmp / "cnn_pretrain"), "--device",
            "cuda"]
    result, launches, wall, peak_gb, record = _run_pretrain(argv, counted)
    _only(launches)
    train_loss, val_loss = _check_record(record)
    step_ms = float(np.median(result["train_step_seconds"][-1])) * 1e3
    yargv = ["--model", "cnnrnn", "--device", "cuda", "--country",
             "synthetic", "--n-train-years", "15", "--test-year", "2016",
             "--n-epochs", "2"]
    yres, ylaunches, ywall, ypeak = _run_yield(yargv, crop_df, counted)
    _only(ylaunches)
    (trainer,) = yres["trainers"]
    history = trainer.loss_history["train"]["total_loss"]
    if not (np.all(np.isfinite(history))
            and np.isfinite(yres["avg_rmse_bu_acre"])
            and np.isfinite(yres["avg_r_squared"])):
        raise AssertionError(f"cnnrnn: losses {history}, RMSE "
                             f"{yres['avg_rmse_bu_acre']}, R^2 "
                             f"{yres['avg_r_squared']}")
    ystep_ms = float(np.median(trainer.train_step_seconds[-1])) * 1e3
    print(f"train_cnn: wm-pretrain-torch --model weathercnn --batch-size "
          f"{FORMER_BATCH}, 2 epochs: train loss {train_loss}, val "
          f"{val_loss}, {step_ms:.2f} ms a step "
          f"({FORMER_BATCH / step_ms * 1e3:.1f} samples/s), {wall:.1f} s, peak {peak_gb:.2f} GB; wm-yield-torch "
          f"--model cnnrnn, one fold (test 2016), 2 epochs: train loss "
          f"{history}, RMSE {yres['avg_rmse_bu_acre']:.3f} bu/acre, R^2 "
          f"{yres['avg_r_squared']:.3f}, {ystep_ms:.2f} ms a step "
          f"({YIELD_BATCH / ystep_ms * 1e3:.1f} windows/s), {ywall:.1f} s, "
          f"peak {ypeak:.2f} GB; no kernel of the port launched; card {smi}",
          flush=True)


# the yield baselines (yield_baselines): wm-yield-torch --model gnnrnn and
# --model chronos with YIELD_ARGS on the yield phase's frame, at the JAX
# CLI's defaults (GNN-RNN: z_dim 128, 3 SAGE layers, dropout 0.1, n_past 6,
# one graph of 1024 counties x 7 years a step; Chronos: chronos-bolt-tiny
# from its seeded init, batch 64, 31 series of 364 weeks a window, 23
# patches + REG). Neither reaches a kernel of the port: their convs,
# matmuls, LSTMs and attention are plain ops, as JAX runs them outside
# Pallas. One fp32 step on the card is held against the CPU's with TF32 off
# (main sets both switches): the forward's max |diff| and the loss to
# 1e-4 of their scale, each gradient's L2 to 1e-3, on a graph of 256
# counties and on 8 windows
BASELINE_TOL = dict(out=1e-4, grad=1e-3)
BASELINE_STEP = {"gnnrnn": 256, "chronos": 8}
# Chronos's pooling logit bias: the softmax over patches is invariant to
# it, so its gradient is rounding noise on both devices
BASELINE_SHIFT_INVARIANT = ("attn_fc2.bias",)


def _baseline_card_vs_cpu(name):
    """(forward max|diff| / max|cpu|, loss rel diff, worst gradient
    ||diff|| / ||cpu||, its parameter) of one step on the card against the
    CPU; raises past BASELINE_TOL."""
    from weathermodel_tpu_torch.testing import yield_baseline_step

    n = BASELINE_STEP[name]
    out, loss, grads = yield_baseline_step(name, "cuda", n, SEED + 11)
    want_out, want_loss, want_grads = yield_baseline_step(name, "cpu", n,
                                                          SEED + 11)
    out_err = float((out - want_out).abs().max() / want_out.abs().max())
    loss_rel = abs(loss - want_loss) / abs(want_loss)
    if set(grads) != set(want_grads):
        raise AssertionError(f"{name}: gradients of {sorted(grads)} on the "
                             f"card, {sorted(want_grads)} on the CPU")
    grad, worst = max((float((grads[k] - g).norm() / max(g.norm(), 1e-30)),
                       k) for k, g in want_grads.items()
                      if k not in BASELINE_SHIFT_INVARIANT)
    if (out_err > BASELINE_TOL["out"] or loss_rel > BASELINE_TOL["out"]
            or grad > BASELINE_TOL["grad"]):
        raise AssertionError(f"{name}: one step, card vs CPU: forward "
                             f"{out_err:.3g}, loss {loss_rel:.3g}, worst "
                             f"gradient {grad:.3g} ({worst}); bars "
                             f"{BASELINE_TOL}")
    return out_err, loss_rel, grad, worst


def phase_yield_baselines(smi: str, crop_df):
    """`crop_df` is the yield phase's synthetic frame."""
    counted = _all_kernels()
    lines = []
    for name, unit, per_step in (("gnnrnn", "graphs/s", 1),
                                 ("chronos", "windows/s", YIELD_BATCH)):
        argv = ["--model", name, "--device", "cuda", *YIELD_ARGS]
        result, launches, wall, peak_gb = _run_yield(argv, crop_df, counted)
        _only(launches)
        (trainer,) = result["trainers"]
        history = trainer.loss_history
        for scope in ("train", "val"):
            if not np.all(np.isfinite(history[scope]["total_loss"])):
                raise AssertionError(f"{name}: non-finite {scope} loss "
                                     f"{history[scope]['total_loss']}")
        train_loss = history["train"]["total_loss"]
        if not train_loss[1] < train_loss[0]:
            raise AssertionError(f"{name}: train loss did not fall: "
                                 f"{train_loss}")
        if not (np.isfinite(result["avg_rmse_bu_acre"])
                and np.isfinite(result["avg_r_squared"])):
            raise AssertionError(f"{name}: RMSE {result['avg_rmse_bu_acre']}"
                                 f", R^2 {result['avg_r_squared']}")
        steps = sum(len(x) for x in trainer.train_step_seconds)
        step_s = float(np.median(trainer.train_step_seconds[-1]))
        out_err, loss_rel, grad, worst = _baseline_card_vs_cpu(name)
        lines.append(
            f"--model {name}: {steps} steps and {len(trainer.lr_range[0])} "
            f"range-test steps, train loss {train_loss}, val "
            f"{history['val']['total_loss']}, RMSE "
            f"{result['avg_rmse_bu_acre']:.3f} bu/acre, R^2 "
            f"{result['avg_r_squared']:.3f}; epoch 2 median "
            f"{step_s * 1e3:.2f} ms a step ({per_step / step_s:.1f} {unit}), "
            f"fold {wall:.1f} s, peak {peak_gb:.2f} GB; one step card vs CPU "
            f"at {BASELINE_STEP[name]} "
            f"{'counties' if name == 'gnnrnn' else 'windows'}: forward "
            f"{out_err:.3g}, loss {loss_rel:.3g}, worst gradient {grad:.3g} "
            f"({worst})")
    print(f"yield_baselines: wm-yield-torch {' '.join(YIELD_ARGS)}, fp32: "
          f"{'; '.join(lines)}; bars {BASELINE_TOL}; no kernel of the port "
          f"launched; TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cuDNN {torch.backends.cudnn.allow_tf32}; card {smi}", flush=True)


def _record(name, source, replaces, launches, k, prefix,
            folder="weathermodel_tpu/ops/"):
    """One kernel's entry of the JSON line: `replaces` is "file:line" under
    `folder`, `k` a kernel phase's result and `prefix` ("fwd", "bwd", ...)
    picks the kernel's numbers in it."""
    bound_ms, bound_by = k[prefix + "_bound"]
    return dict(name=name, route="cuda",
                source="weathermodel_tpu_torch/csrc/" + source,
                replaces=folder + replaces,
                launches=launches, max_abs_err=k[prefix + "_err"],
                ms=k[prefix + "_ms"], plain_ms=k[prefix + "_plain_ms"],
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=k[prefix + "_library_ms"])


def main(argv=None):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        if len(argv) != 2 or argv[0] != "--ep-cards":
            raise SystemExit("usage: chip_smoke.py [--ep-cards N]")
        smi = phase_device()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase_ep_cards(smi, Path(tmp), int(argv[1]))
        return 0
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed("device", phase_device)
    timed("build", phase_build)
    kernel = timed("kernel", phase_kernel)
    outproj_kernel = timed("kernel_outproj", phase_kernel_outproj)
    with tempfile.TemporaryDirectory() as tmp:
        _write_inputs(Path(tmp))
        serve_launches = timed("serve", phase_serve, smi, Path(tmp))
        daemon_stats = timed("serve_daemon", phase_serve_daemon, smi,
                             Path(tmp))
        timed("serve_int8", phase_serve_int8, smi, Path(tmp))
        timed("serve_moe_int8", phase_serve_moe_int8, smi, Path(tmp))
        served = timed("export", phase_export, smi, Path(tmp))
        timed("serve_bundle", phase_serve_bundle, smi, Path(tmp),
              daemon_stats, served)
    train_kernels = timed("kernel_train", phase_kernel_train)
    with tempfile.TemporaryDirectory() as tmp:
        data = _write_store(Path(tmp))
        train_launches = timed("train", phase_train, smi, data)
        flash_kernels = timed("kernel_flash", phase_kernel_flash)
        former_launches = timed("train_former", phase_train_former, smi, data)
        timed("resume", phase_resume, smi, data)
        crop_df = timed("yield", phase_yield, smi, Path(tmp))
        timed("train_cnn", phase_train_cnn, smi, data, Path(tmp), crop_df)
        timed("yield_baselines", phase_yield_baselines, smi, crop_df)
        gmm_kernel, tgmm_kernel = timed("kernel_gmm", phase_kernel_gmm)
        moe_launches = timed("train_moe", phase_train_moe, smi, data)
        timed("train_moe_dispatch", phase_train_moe_dispatch, smi, data)
        b4s, b4ts = timed("train_ep", phase_train_ep, smi, Path(tmp))
    ffn_kernels = timed("kernel_ffn", phase_kernel_ffn)
    mask_kernels = timed("kernel_maskgen", phase_kernel_maskgen)
    probes = timed("probes", phase_probes, smi)
    bench_launches = timed("bench", phase_bench, smi)
    tk, fk = train_kernels, flash_kernels
    records = [
        dict(name="fused_qkv_attention", route="cuda",
             source="weathermodel_tpu_torch/csrc/fused_qkv_attention.cu",
             replaces="weathermodel_tpu/ops/pallas_attention.py:242",
             launches=serve_launches["auto"]["fused_qkv_attention"],
             max_abs_err=kernel["max_abs_err"],
             ms=kernel["ms"], plain_ms=kernel["plain_ms"],
             bound_ms=kernel["bound_ms"], bound_by=kernel["bound_by"],
             library_ms=kernel["library_ms"]),
        _record("fused_qkv_attention_train", "fused_qkv_attention.cu",
                "pallas_attention.py:242",
                train_launches["fused_qkv_attention_train"], tk, "fwd"),
        _record("fused_qkv_attention_bwd", "fused_qkv_attention_bwd.cu",
                "pallas_attention.py:391", train_launches["fused_qkv_attention_bwd"], tk, "bwd"),
        _record("flash_attention_fwd", "flash_attention.cu",
                "pallas_attention.py:199",
                former_launches["flash_attention_fwd"], fk, "fwd"),
        _record("flash_attention_bwd", "flash_attention_bwd.cu",
                "pallas_attention.py:288",
                former_launches["flash_attention_bwd"], fk, "bwd"),
        *(dict(name=name, route="cuda",
               source=f"weathermodel_tpu_torch/csrc/{name}.cu",
               replaces=f"weathermodel_tpu/ops/pallas_gmm.py:{line}",
               launches=moe_launches[name], **k)
          for name, line, k in (("gmm", 155, gmm_kernel),
                                ("tgmm", 233, tgmm_kernel))),
        # the window forms, launched by wm-pretrain-torch --tensor-parallel 2
        # on two ranks (their launches summed)
        *(dict(name=name, route="cuda",
               source=f"weathermodel_tpu_torch/csrc/{source}.cu",
               replaces=f"weathermodel_tpu/ops/pallas_gmm.py:{line}", **k)
          for name, source, line, k in (("gmm_sharded", "gmm", 192, b4s),
                                        ("tgmm_sharded", "tgmm", 262,
                                         b4ts))),
        _record("fused_ffn_ln", "fused_ffn_ln.cu", "pallas_ffn.py:63",
                bench_launches["fused_ffn_ln"]["fused_ffn_ln"], ffn_kernels,
                "fwd"),
        _record("fused_ffn_ln_bwd", "fused_ffn_ln_bwd.cu", "pallas_ffn.py:94",
                bench_launches["fused_ffn_ln"]["fused_ffn_ln_bwd"],
                ffn_kernels, "bwd"),
        _record("fused_ffn", "fused_ffn.cu", "pallas_ffn2.py:55",
                bench_launches["fused_ffn"]["fused_ffn"], ffn_kernels, "b7"),
        dict(name="fused_qkv_attention_outproj", route="cuda",
             source="weathermodel_tpu_torch/csrc/"
                    "fused_qkv_attention_outproj.cu",
             replaces="weathermodel_tpu/ops/pallas_attention.py:258",
             launches=serve_launches["fused_qkv_op"][
                 "fused_qkv_attention_outproj"],
             **{k: outproj_kernel[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}),
        # B9p and B9b launched by the bench's maskgen lines; B8 and B8m by
        # their public functions in kernel_maskgen, their only path
        _record("packed_keep_mask", "keep_mask.cu", "pallas_maskgen.py:35",
                bench_launches["maskgen"]["packed_keep_mask"], mask_kernels,
                "b9p"),
        _record("bool_keep_mask", "keep_mask.cu", "pallas_maskgen.py:113",
                bench_launches["maskgen_bool"]["bool_keep_mask"],
                mask_kernels, "b9b"),
        _record("lane_dropout", "keep_mask.cu", "pallas_dropout.py:38",
                mask_kernels["launches"]["lane_dropout"], mask_kernels, "b8"),
        _record("random_keep_mask", "keep_mask.cu", "pallas_dropout.py:89",
                mask_kernels["launches"]["random_keep_mask"], mask_kernels,
                "b8m"),
        # launched by the ablation scripts, their only path; P3's times are
        # its (512, 1152) arm's, its launches all five arms'
        *(_record(name, source, replaces, probes["launches"][name], probes,
                  prefix, folder="scripts/")
          for name, source, replaces, prefix in (
              ("headpack_v0", "headpack.cu", "abl_headpack.py:115", "p1"),
              ("headpack_v1", "headpack.cu", "abl_headpack.py:125", "p2"),
              ("blocked_mm", "blocked_mm.cu", "abl_gemm_probe.py:46",
               "p3"))),
    ]
    print(f"phase seconds: {seconds}")
    print(f"card: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
