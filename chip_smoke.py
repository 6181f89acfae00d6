#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (the quickest proof that
the port still starts on the card).

    python3 chip_smoke.py

Run from the repo root, with nothing but the checkout: it builds every
kernel from ``src/repro_torch/kernels/csrc/`` into ``build/`` (one ``nvcc``
for each source, all started together), then

  0. prints each kernel's registers and spills (``-Xptxas=-v``; any spill
     fails) and, where ``cuobjdump`` is present, the count of ``HGMMA``
     (wgmma) instructions in the bf16 flash kernel's SASS (none fails);
  1. holds each kernel against its plain PyTorch version on the card over
     the reference test matrices, fp32 and bf16 (the two flash kernels),
     at the shapes of the training paths, at the prefill shape (1, 32768,
     16, 16, 256) on its first and last 512 rows, q scaled by 8 so each
     row's softmax picks a few keys and a lost or misplaced key tile moves
     the output by O(1) (a full plain version would need a 68 GB score
     tensor), at deepseek-moe-16b's path shape (2, 2048, 16, 16, 128),
     arctic-480b's attention (1, 2048, 56, 8, 128: 7 query heads a kv
     head) and whisper-small's decoder (8, 512, 12, 12, 64), at
     llama-3.2-vision-90b's prefill shape (1, 32768, 64, 8, 128) on its
     first and last 512 rows as at the prefill shape, and each autograd
     op's gradients against plain autograd, the scan's also at its path
     shape (forward and the kernel's reverse mode);
  2. checks each model on the card against itself with the kernels off
     (gemma-7b smoke config with head_dim 64 in fp32 and head_dim 256 in
     bf16, recurrentgemma-2b smoke in fp32, and whisper-small smoke with
     head_dim 64 in fp32, its frames given; S = 256: loss and gradients);
  3. drives each training path through ``repro_torch.launch.train.run``,
     5 AdamW steps at B = 2, S = 2048, bf16, remat, kernels on, with the
     launch counts set to 0 just before and read just after:
       - gemma-7b at full width with 4 of its 28 layers (flash attention);
       - recurrentgemma-2b at full width with all 26 layers (rglru_scan);
     and holds each path's step-1 loss to the one recorded in PERF.md;
  4. times each kernel, its plain version and the nearest PyTorch library
     call at its path's shape, beside the card's bound, with the achieved
     TFLOP/s (flash, also at deepseek-moe-16b's and whisper-small's path
     shapes) and GB/s (scan, both directions);
  5. profiles one more training step of each path (device time by kernel,
     idle share);
  6. closes the paper's loop on the card (``repro_torch.core``):
       a. counts the FLOPs of one bf16 gemma smoke step (head_dim 256,
          S = 256) with the flash kernel on the card, against the same
          step on the CPU (plain version) and with the kernel off, then of
          one full-width 4-layer gemma-7b step, beside 6·N·D;
       b. takes the 4-layer step's utilization (its FLOPs over the phase 3
          step time at the bf16 peak), calibrates the GPU step DAG with it
          and predicts that step; counts a 2-layer step, runs it through
          ``train.run`` (5 steps, launch counts set to 0 before and read
          after) and predicts it from the 4-layer utilization; each
          prediction within 2x of its measurement;
       c. predicts full 28-layer gemma-7b at ``train_4k`` over 1, 2 and 4
          nodes of 8 GPUs through ``launch/whatif.py`` (straggler 1.3, int8
          0.25, chunks of 64/16/4 MB), with the orderings the reference's
          adapter keeps; its utilization is 6b's times the DAG's share of
          the 28-layer step's FLOPs, counted on fake tensors at one
          sequence of ``train_4k`` (the DAG holds only 6·P_layer·D);
       d. runs the torch waterfill backend on the card over 8192 star and
          grouped problems against the numpy backend (rtol 2e-4);
  7. serves through ``repro_torch.launch.serve.run`` at full width and
     depth, bf16, B = 8, a prompt of 128 tokens fed through ``serve_step``
     and 128 greedy tokens, with the launch counts set to 0 just before and
     read just after (the decode path runs no kernel: both stay 0):
       a. gemma-7b, 28 layers (a KV cache a layer);
       b. recurrentgemma-2b, 26 layers (RG-LRU state and a local ring);
     each then feeds what it served (the prompt and the generated ids,
     256 tokens) through ``serve_step`` again, with the same weights and a
     state of the served max_len, and holds every position's logits to
     ``forward`` on the same tokens (the reference's bound, 2e-2 of
     max(|logits|, 1)); then times the host's enqueue of one decode step
     against the synchronised step and profiles 4 decode steps;
       c. prefills gemma-7b, 28 layers, B = 1, S = 32768 (``prefill_32k``
          for one card) through ``launch.steps.make_prefill_step`` with the
          flash kernel on: one warm-up, then 3 timed runs, 28 flash launches
          each, finite logits, and a profile of one more prefill;
  8. drives the rest of the training driver (``train.run`` with the launch
     counts set to 0 before each run and read after), its checkpoints in
     ``build/phase8/``, removed at the end:
       a. the phase-3 gemma-7b path with ``--ckpt-dir``: a run with
          ``--fail-at 2`` (saves step 0, then raises exactly "simulated
          node failure at step 2"), the same command again (restores step
          0, runs steps 1-4, saves step 4), its losses within 1e-4 relative
          of phase 3's; the step-4 checkpoint, evicted from the page cache,
          restored into fresh tensors and ``torch.equal`` to the run's
          final state; bytes, save and restore seconds. It first requires
          free disk of 2.2x a checkpoint, and cuts to 2 layers, saying so,
          if the disk holds only that;
       b. ``CheckpointCostModel.calibrate`` at 2^24, 2^26, 2^28 fp32
          elements on that disk, and its predicted restore of 8a's
          checkpoint against 8a's measured restores;
       c. the 2-layer gemma-7b path of 6b with ``--async-staleness 2
          --compress int8`` (step-0 loss bit-equal to 6b's) and with
          ``--compress topk``; the compressors on one step's gradients at
          full width (int8 wire bytes, top-k index count, compress and
          decompress ms) and on layer 0's MLP weight gradient on the card
          against the CPU (equal payloads);
       d. three updates of momentum, adamw_bf16 and adafactor on one
          (3072, 24576) leaf, card against CPU (1e-6), and an adamw_bf16
          state of it saved and restored bit-equal;
  9. xlstm-350m, whose sLSTM and mLSTM blocks are plain PyTorch (no kernel:
     the reference has none there either):
       a. the smoke model (4 layers, d_model 64, fp32, S = 64) on the card
          against the CPU from the same numpy weights and batch: loss within
          1e-5 relative, every gradient within 1e-4; as configured, then
          with remat and a time chunk of 16;
       b. trains at full width and depth (24 layers, d_model 1024, vocab
          50304) through ``train.run``, 3 AdamW steps at B = 4, S = 128,
          bf16, remat, with the launch counts set to 0 just before and read
          just after (both stay 0), and holds its step-1 loss to the
          recorded one;
       c. profiles one more step of that run: kernels a step and a layer
          and time step, device busy against the unprofiled step;
       d. serves it as phase 7 does (B = 8, 128 + 128 tokens, the
          teacher-forced bound);
       e. runs 9b's path with a checkpoint every step, failed at step 2,
          then resumed: losses 1-3 within 1e-4 relative of 9b's, the
          checkpoint's bytes and save and restore seconds (in
          ``build/phase9/``, removed at the end);
 10. the MoE block (``models/moe.py``; no kernel of its own, its attention
     runs the flash kernel):
       a. the deepseek-moe-16b and arctic-480b smoke models (fp32, S = 64)
          on the card against the CPU from the same numpy weights and
          batch, as configured and with remat: loss within 1e-5 relative,
          every gradient within 1e-4;
       b. trains deepseek-moe-16b at full width with 4 of its 28 layers
          through ``train.run``, as phase 3 (5 AdamW steps, B = 2,
          S = 2048, bf16, remat, kernels on, launch counts set to 0 just
          before and read just after: 40 flash launches, no scan), its peak
          under 75 GB, the step-1 ``ce``, ``aux_loss`` and ``z_loss``, and
          the routed assignments dropped at its capacity held to the
          recorded count;
       c. profiles one more step of that run, and counts one step's FLOPs
          on fake tensors beside 6·N_active·D and the dense dispatch and
          combine products' share;
       d. serves deepseek-moe-16b at full width and depth as phase 7 (B = 8,
          128 + 128 tokens); the teacher-forced check is gated in fp32 at a
          capacity factor that drops nothing (E/k: C = G in the forward,
          C = B in decode; at the served factor the forward drops what
          decode keeps), the bf16 error at that factor printed beside it
          and split by whether decode picked the forward's experts, and
          the assignments decode and the forward each drop at the served
          factor held to the recorded counts;
       e. serves one full-width arctic-480b layer (56.3 GB of fp32 weights)
          through ``serve.run --full --layers 1``, B = 8, 32 + 32 tokens,
          checked as 10d;
 11. the encoder and cross-attention (no kernel of their own: the encoder's
     bidirectional attention and every cross-attention are plain einsums,
     as in the reference; the decoders' causal self-attention runs the
     flash kernel). Every ``xattn`` gate, 0 at the reference's init (so
     that the cross-attention would add nothing), is set to a nonzero
     value first:
       a. the whisper-small and llama-3.2-vision-90b smoke models (fp32,
          S = 64, gates 0.5, their frames or patch embeddings given) on the
          card against the CPU from the same numpy weights and batch, remat
          off and on, as 9a;
       b. trains whisper-small at full width and depth (12 encoder and 12
          decoder layers) through ``train.run``: 5 AdamW steps, B = 8,
          S = 512, frames (8, 1500, 768), bf16, remat, kernels on, launch
          counts set to 0 just before and read just after (120 flash
          launches, no scan), its peak under 75 GB and its step-1 loss held
          to the recorded one; a profile of one more step, and the step's
          FLOPs on fake tensors beside 6·N·D over the decoder's tokens and
          beside 6·N·D over the matrix products' parameters, the encoder's
          over its 1,500 frames a row;
       c. serves whisper-small at full depth as phase 7 (B = 8, 128 + 128
          tokens, the encoder states and cross K/V filled once), the
          teacher-forced check in bf16 on the same frames, and another draw
          of frames moving the logits by more than 10x the check's error;
       d. serves one full-width llama-3.2-vision-90b pattern group (4
          ``attn`` + 1 ``xattn`` layer, 25.5 GB of fp32 weights) through
          ``serve.run --full --layers 5`` with every gate at 1.0, checked
          as 11c through its patch embeddings (8, 1601, 8192) but gated in
          fp32: another draw of them moves the logits by about 0.01, under
          the bf16 check's error, so only the fp32 check sees the
          cross-attention (the bf16 error is printed); with the gates at 0
          another draw leaves the logits bit-equal;
       e. prefills that group at ``prefill_32k`` for one card (B = 1,
          S = 32768) through ``make_prefill_step``, the flash kernel on: one
          warm-up, 3 timed runs of 4 flash launches each, finite logits, the
          peak, and a profile of one more prefill;
 12. the sharding layer (``parallel/sharding.py``, ``launch/mesh.py``) on
     an NCCL process group of world size 1 (its store in ``build/phase12/``,
     removed at the end; no fallback to gloo or the CPU) and
     ``make_debug_mesh((1, 1))`` on the card:
       a. phase 3's gemma-7b path (4 of 28 layers at full width, bf16, fp32
          params, remat, AdamW, B = 2, S = 2048, the same seed and batches)
          with params, optimizer state and batches as DTensors
          (``params_shardings``, ``batch_shardings``), 5 steps through
          ``make_train_step(cfg, opt, mesh)``, the launch counts set to 0
          just before and read just after: every loss within 1e-5 relative
          of phase 3's (bit-equal or not, printed), 40 flash launches
          through the kernel's custom op, every param and optimizer-state
          leaf still a DTensor with its rule's placements, peak under
          75 GB; ms a step, tokens/s against phase 3's, the idle share of
          one more profiled step, and the regions that ran under
          ``local_map`` in the 5 steps, with their runs;
       b. that state saved, evicted from the page cache, and restored onto
          the mesh (``restore(..., mesh=mesh)``) from ``meta`` targets:
          every leaf ``torch.equal`` to the saved one, with the
          restore-time rules' placements; save and restore GB/s beside
          8a's;
       c. the scan kernel forward and reverse on DTensor inputs at its path
          shape (2, 2048, 2560) fp32, batch over data and width over model,
          bit-equal to the plain tensors' call;
     and, while the group is up, one more step of 12a's path with its FLOPs
     counted by ``FlopCounterMode`` and its collectives by ``CommDebugMode``
     (launch counts set to 0 just before and read just after: 8 flash
     launches);
 13. the dry-run (``launch/dryrun.py``) on fake ``cuda`` tensors over fake
     process groups, after phase 12's group is destroyed:
       a. 12a's step traced through ``dryrun.trace_step`` on a (1, 1) mesh
          over a fake group of world size 1: its FLOPs equal to the real
          step's (relative 1e-9), its collectives equal by kind and count,
          its peak of live bytes within 10% of 12a's
          ``max_memory_allocated`` (the ratio printed);
       b. the production cells gemma-7b ``train_4k``, ``prefill_32k`` and
          ``decode_32k`` on 16 x 16, gemma-7b ``train_4k`` on 2 x 16 x 16,
          arctic-480b and llama-3.2-vision-90b ``train_4k`` on 16 x 16
          through ``dryrun_cell``: each ``ok``, with its bytes and FLOPs a
          device, collective wire bytes by kind, the three roofline terms
          under the H100 SXM5 constants, the bottleneck, ``mfu_bound`` and
          the trace's seconds; each train cell's ``useful_flops_ratio`` at
          most 1; and xlstm-350m ``train_4k`` on 16 x 16, whose sLSTM /
          mLSTM time loop is traced at S = 16 and 32 and extrapolated to
          4096 (its record's ``extrapolated`` key printed);
 14. the paper's PS-cluster pipeline (``core/predictor.py``, the cluster
     emulator, the DES; host Python, no tensor work) on the card machine's
     own Python and torch, its times host seconds:
       a. the reference test's saturated case (alexnet, batch 16,
          ``private_cpu``, profile 40, sim 250, W = 6, measured over 120
          steps): the DES's error under 0.12 and under the larger of the
          Lin and Cynthia baselines' errors; ``predict_many`` at W = 1, 2,
          4 through the process pool equal bit for bit to its serial run
          (``REPRO_SWEEP_SERIAL=1``);
       b. ``python -m repro_torch.launch.whatif --ps-cluster`` (alexnet,
          batch 8, W = 2 and 4, 2 PS shards behind a 4x oversubscribed
          rack, sync with one backup worker, crash churn, profile 10 and
          sim 60 steps, a Chrome trace exported, ``REPRO_SWEEP_SERIAL=1``)
          as a subprocess, its ledger at ``REPRO_LEDGER`` (both in
          ``build/phase14/``, removed at the end): exit 0, the trace
          valid by ``obs.view.validate_chrome_trace``, the ledger read back
          by ``obs.report.summarize``;
 15. the lockstep batched engine and the multi-tenant fleet engine
     (``core/batched.py``, ``core/fleet.py``; host numpy and Python, no
     tensor work), its times host seconds:
       a. ``run_scenarios`` over 64 scenarios of the reference test's
          ``w8_ps2_2tpl`` family (seeds 0-63, ``min_batch=1``), the
          ``auto`` engine against the ``scalar`` one: every fingerprint
          (completions, staleness, end time, events, versions) equal; then
          ``predict_many(batch=True)`` on alexnet's profiled templates
          (batch 8, profile 10, sim 60, W = 2 and 4, 2 runs) equal bit for
          bit to the serial ``predict_many``, the case where the
          reference's batched engine misses its scalar engine in the last
          bits (ROADMAP §3); the fallback histogram, the share that ran
          lockstep and both engines' seconds;
       b. ``python -m repro_torch.launch.whatif --fleet examples/fleet.json
          --scale-job A:3 --export-trace ...`` as a subprocess
          (``REPRO_SWEEP_SERIAL=1``, its trace and ``REPRO_LEDGER`` in
          ``build/phase15/``, removed at the end): exit 0, the table's
          lines equal to the reference's (``FLEET_LINES``), the trace
          valid, no ledger record;
       c. the reference test's two-job fleet at oversubscriptions 1, 2 and
          4 through ``simulate_fleets``'s process pool, equal to the serial
          run; the ``FleetEmulator`` two-job parity case: each job's DES
          throughput within 0.35 of the emulator's, contended no faster
          than alone;
 16. placement search and closed-loop calibration
     (``core/placement_search.py``, ``calibrate/``; host Python but for c),
     its times host seconds:
       a. ``examples/calibration.md``'s drifted cluster (alexnet, batch 64,
          ``private_cpu`` with compute 20% slower and the NIC 30% below
          nominal, observed at W = 3 over 50 steps) saved as a trace corpus
          in ``build/phase16/`` (removed at the end): the open-loop error
          over ``DEFAULT_GATE``, ``fit_from_runs`` shrinking it, the digest
          and both errors beside a CPU host's; the identity profile leaving
          a DES trace bit-equal; a nominal ``ClosedLoop`` that never
          recalibrates in 2 rounds and a drifted one that fires in round 0,
          its ``recalibrated`` ledger record read back; then ``python -m
          repro_torch.calibrate fit``, ``show`` and ``check`` against the
          identity profile (exit codes 0, 0, 1) and ``whatif --ps-cluster
          ... --calibrate`` as serial subprocesses;
       b. ``tests/test_placement_search.py``'s rack-pool topology at 2
          shards: greedy equal to the exhaustive oracle, anneal no worse,
          every strategy over 1.5x the default; the surrogate against the
          oracle over the PS hosts and on the loopback-bypass topology with
          colocation; the evaluator's process pool equal to the serial
          scores over all 49 candidates; ``whatif --ps-cluster ...
          --optimize-placement greedy`` as a serial subprocess, its three
          lines equal to a CPU host's (``PLACE_LINES``);
       c. ``surrogate_scores`` over the 729 candidates of the 3-shard
          bypass topology, each of its two waterfill problems also solved
          by ``batched_waterfill(backend="torch")`` on the card: shares
          within rtol 2e-4 of numpy's and the same top-ranked candidate.

Each result is printed as it comes; the line before the card's name is one
JSON object with the kernels, and the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero without it.
It exits non-zero at once when CUDA is not available, and after 1140 s,
with every thread's stack on stderr.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import faulthandler
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
START = time.time()
# the run must end within 1200 s: past this, every thread's stack is
# dumped to stderr and the run exits non-zero
WATCHDOG_S = 1140

# Published dense peaks of one H100 SXM (NVIDIA data sheet).
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

COMMON_ARGV = ["--full", "--batch", "2", "--seq", "2048", "--steps", "5",
               "--device", "cuda", "--log-every", "1"]
# gemma-7b at full width, 4 of its 28 layers (params, grads and AdamW
# moments of all 28 would take 137 GB).
GEMMA_ARGV = ["--arch", "gemma-7b", "--layers", "4", *COMMON_ARGV]
# recurrentgemma-2b at full width and depth: 26 layers, 46.3 GB of state.
RG_ARGV = ["--arch", "recurrentgemma-2b", *COMMON_ARGV]
SLICE = (2, 2048, 16, 16, 256)          # flash b, s, h, kv, d on its path
MOE_SLICE = (2, 2048, 16, 16, 128)      # ... on the deepseek-moe-16b path
ARCTIC_SLICE = (1, 2048, 56, 8, 128)    # ... arctic-480b's, 7 q a kv head
PREFILL = (1, 32768, 16, 16, 256)       # ... on the prefill path
PREFILL_ROWS = 512                      # rows held against the plain version
PREFILL_Q_SCALE = 8     # peaks the softmax there, so each output is O(1)
# serving at full width and depth: B = 8, a 128-token prompt, 128 greedy
# tokens; gemma-7b's fp32 weights take 34.2 GB, recurrentgemma-2b's 11.6 GB
SERVE_ARGV = ["--full", "--batch", "8", "--prompt-len", "128", "--gen",
              "128", "--device", "cuda"]
RG_SHAPE = (2, 2048, 2560)              # rglru_scan (B, S, R) on its path
# phase 8's checkpoints, inside the checkout (``build/`` is ignored by git);
# removed when the phase ends, passed or failed
PHASE8_DIR = ROOT / "build" / "phase8"
# free disk asked for before 8a: two checkpoints on disk and some room
DISK_FACTOR = 2.2
RESTART_TOL = 1e-4      # the reference's restart bound (relative)
OPT_SHAPE = (3072, 24576)               # 8d: one full-width MLP weight
# Profile groups, by kernel name (first match wins).
KERNEL_GROUPS = [
    ("flash_attention", ("attn_fwd",)),
    ("rglru_scan", ("rglru_scan",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass")),
    ("softmax/reduce", ("softmax", "reduce", "logsumexp")),
    ("copy/cast", ("copy",)),
    ("elementwise", ("elementwise",)),
    # the MoE top-k's sort and slot cumsum, and embedding-backward sorts
    ("sort/scan", ("Sort", "sort", "scan_")),
]
XLSTM = "xlstm-350m"
# xlstm-350m at full width and depth: 24 layers, 242,394,208 parameters,
# 3.88 GB of state. S is cut from 2048 to 128: its blocks are a Python
# loop over time on the card, 96 kernels a layer and time step with remat
# and the backward pass, and at S = 256 a step took 19.5 s (NVIDIA H100
# 80GB HBM3, 700 W)
XLSTM_ARGV = ["--arch", XLSTM, "--full", "--batch", "4", "--seq", "128",
              "--steps", "3", "--device", "cuda", "--log-every", "1"]
XLSTM_SMOKE_SEQ = 64                    # 9a: the smoke model, card vs CPU
# phase 9e's checkpoints, removed when the phase ends, passed or failed
PHASE9_DIR = ROOT / "build" / "phase9"
DEEPSEEK, ARCTIC = "deepseek-moe-16b", "arctic-480b"
# deepseek-moe-16b at full width, 4 of its 28 layers: 2,770,880,512
# parameters, 44.3 GB of fp32 state (params, grads, two AdamW moments); all
# 28 layers would take 270 GB
DEEPSEEK_ARGV = ["--arch", DEEPSEEK, "--layers", "4", *COMMON_ARGV]
# one full-width arctic-480b layer: 14,073,615,360 parameters, 56.3 GB of
# fp32 weights (its training state, 225 GB, waits for sharding)
ARCTIC_SERVE_ARGV = ["--full", "--layers", "1", "--batch", "8",
                     "--prompt-len", "32", "--gen", "32", "--device", "cuda"]
MOE_SMOKE_SEQ = 64                      # 10a: the smoke models, card vs CPU
WHISPER, LLAMA = "whisper-small", "llama-3.2-vision-90b"
WHISPER_SLICE = (8, 512, 12, 12, 64)    # flash on whisper-small's decoder
LLAMA_PREFILL = (1, 32768, 64, 8, 128)  # ... llama-3.2-vision-90b's prefill
# whisper-small at full width and depth: 12 encoder and 12 decoder layers,
# 304,809,984 parameters, 4.88 GB of fp32 state. S = 512 is the nearest
# length to its 448-token text context that the flash kernel's block rule
# admits: B = 8 gives 4,096 decoder tokens a step, as the other paths
WHISPER_ARGV = ["--arch", WHISPER, "--full", "--batch", "8", "--seq", "512",
                "--steps", "5", "--device", "cuda", "--log-every", "1"]
# one full-width llama-3.2-vision-90b pattern group (4 attn + 1 gated xattn
# layer): 6,383,820,801 parameters, 25.5 GB of fp32 weights; its AdamW
# state (102 GB) waits for sharding
LLAMA_SERVE_ARGV = ["--full", "--layers", "5", *SERVE_ARGV[1:]]
XATTN_SMOKE_SEQ = 64                    # 11a: the smoke models, card vs CPU
# phase 12's NCCL store and checkpoint, inside the checkout (``build/`` is
# ignored by git); removed when the phase ends, passed or failed
PHASE12_DIR = ROOT / "build" / "phase12"
# phase 14b's trace and ledger, removed when the phase ends
PHASE14_DIR = ROOT / "build" / "phase14"
# 14a: the reference test's saturated case (tests/test_paper_system.py,
# TestBaselinesWorse) and its gates
PAPER_CASE = dict(dnn="alexnet", batch_size=16, platform="private_cpu",
                  profile_steps=40, sim_steps=250)
PAPER_W, PAPER_MEASURE_STEPS, PAPER_ERR = 6, 120, 0.12
PAPER_SWEEP_W = [1, 2, 4]
# 14b: the what-if's PS-cluster mode, its flags the reference's (W = 1
# is left out: one backup worker of one leaves a sync barrier no quorum,
# which the reference refuses too). Profile and simulation steps are the
# reference tests' smallest: at the defaults (30, 250) the phase took
# 114.5 s on a slow host (PR 23 call 1) against 34 s on a quiet one
WHATIF_ARGV = ["--ps-cluster", "--dnn", "alexnet", "--batch", "8",
               "--workers", "2", "4", "--num-ps", "2", "--oversub", "4",
               "--sync-mode", "sync", "--backup-workers", "1", "--mttf",
               "60", "--mttr", "5", "--fault-seed", "1", "--profile-steps",
               "10", "--sim-steps", "60"]
# phase 15b's trace and ledger, removed when the phase ends
PHASE15_DIR = ROOT / "build" / "phase15"
BATCHED_SEEDS = 64      # 15a: scenarios of the w8_ps2_2tpl family
# 15a: the cheap paper case where the reference's batched engine and its
# scalar engine part (W = 4: 3.35262 against 3.39494 ex/s)
BATCHED_CASE = dict(dnn="alexnet", batch_size=8, platform="private_cpu",
                    profile_steps=10, sim_steps=60)
BATCHED_W, BATCHED_RUNS = [2, 4], 2
# 15b: the fleet what-if, and the lines the reference prints for it (the
# first names the spec's path, the last the trace's)
FLEET_SPEC = "examples/fleet.json"
FLEET_ARGV = ["--fleet", FLEET_SPEC, "--scale-job", "A:3"]
FLEET_LINES = [
    "# fleet examples/fleet.json: 2 jobs on 7 nodes, bw=1e+09 B/s",
    "     job   W       ex/s      alone slowdown  share",
    "       A   4      17.38      19.95     1.15  0.871",
    "       B   2       7.98      16.51     2.07  0.484",
    "# jain fairness index = 0.9244",
    "# what-if: job A at 3x workers (4 -> 12)",
    "     job   W       ex/s        was  delta%  share",
    "       A  12      22.45      17.38   +29.2  0.973",
    "       B   2       4.01       7.98   -49.7  0.243",
    "# jain fairness index = 0.7351 (was 0.9244)",
    "# exported Chrome trace -> ... (4253 events; open in ui.perfetto.dev)"]
FLEET_PARITY = 0.35     # 15c: DES against emulator, tests/test_fleet.py
# phase 16a's trace corpus, profiles and ledger, removed when the phase ends
PHASE16_DIR = ROOT / "build" / "phase16"
# 16a: examples/calibration.md's drifted cluster (compute 20% slower, NIC
# 30% below nominal) observed at W = 3 over 50 steps, and the run that
# predicts it; the fitted digest and both errors the same code gives on a
# CPU host (printed beside the card host's, not gated: the DES sums floats
# in numpy)
CAL_COMPUTE, CAL_NIC, CAL_W, CAL_STEPS = 1.2, 0.7, 3, 50
CAL_RUN = dict(dnn="alexnet", batch_size=64, platform="private_cpu",
               profile_steps=10, sim_steps=40, warmup_steps=5)
CAL_CPU = ("5143346ec49c55b2", 0.3442874353174872, 0.07468418052901432)
CAL_LOOP_GATE = 0.10    # the walkthrough's ClosedLoop gate
# the keys of a "recalibrated" ledger record
RECALIBRATED_KEYS = {"ts", "kind", "config_digest", "predicted", "measured",
                     "error", "wall_s", "calibration_digest", "err_before",
                     "round", "corpus_steps"}
CAL_WHATIF_ARGV = ["--ps-cluster", "--dnn", "alexnet", "--batch", "64",
                   "--workers", "3", "--profile-steps", "10", "--sim-steps",
                   "40", "--calibrate"]
# 16b: tests/test_placement_search.py's rack_pool_topology (its default
# placement behind an 8x oversubscribed rack) and comm_heavy_steps, then
# the what-if's placement search and the lines it prints
PLACE_SHARDS, PLACE_W, PLACE_STEPS, PLACE_SEED = 2, 3, 12, 11
PLACE_WHATIF_ARGV = ["--ps-cluster", "--dnn", "alexnet", "--batch", "16",
                     "--workers", "2", "4", "--num-ps", "2", "--oversub",
                     "4", "--profile-steps", "10", "--sim-steps", "60",
                     "--optimize-placement", "greedy"]
PLACE_LINES = ["# placement search (greedy, W=4): 22 candidate placements "
               "evaluated",
               "#   default   ps0/ps1: 2.30 ex/s",
               "#   optimized w1/w0: 7.74 ex/s (3.36x)"]
# 16c: the surrogate's problems of the 3-shard loopback-bypass topology
# (9 hosts: 729 candidates), torch on the card against numpy (6d's rtol)
SURROGATE_SHARDS, SURROGATE_RTOL = 3, 2e-4
MESH_LOSS_TOL = 1e-5    # 12a: the DTensor path's losses against phase 3's
DRYRUN_FLOP_TOL = 1e-9  # 13a: traced FLOPs against the real step's
DRYRUN_PEAK_TOL = 0.10  # 13a: traced peak bytes against 12a's measured one
DRYRUN_CELLS = [        # 13b: (arch, shape, multi_pod)
    ("gemma-7b", "train_4k", False), ("gemma-7b", "prefill_32k", False),
    ("gemma-7b", "decode_32k", False), ("gemma-7b", "train_4k", True),
    ("arctic-480b", "train_4k", False),
    ("llama-3.2-vision-90b", "train_4k", False),
    # the sLSTM / mLSTM time loop: traced at S = 16 and 32, extrapolated
    (XLSTM, "train_4k", False)]
COMM_KINDS = (("all_gather", "all-gather"), ("reduce_scatter",
              "reduce-scatter"), ("all_reduce", "all-reduce"),
              ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))
SMOKE_GATE = 0.5        # xattn gates of the smoke models (11a)
SERVE_GATE = 1.0        # ... of the served llama-3.2-vision-90b group (11d)
PEAK_LIMIT = 75e9       # a path that peaks above this has its depth cut
LOSS_LINE = re.compile(r"^step\s+\d+ loss\s+(\S+)", re.M)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_TOL = 3e-5     # the reference's tolerance for the RG-LRU scan
DTYPES = ("float32", "bfloat16")
# Step-1 losses of the seeded training paths as PERF.md records them (the
# same seeds, the same data; a kernel that is right moves them by far less).
STEP1_LOSS = {"gemma-7b": 13.2019, "recurrentgemma-2b": 12.9457,
              XLSTM: 11.3643, DEEPSEEK: 12.8005, WHISPER: 11.3512}
STEP1_TOL = 0.01
# Routed MoE assignments (dropped, assigned) at the configs' own capacity
# factor, as PERF.md records them (the same seeds and data, NVIDIA H100
# 80GB HBM3): 10b's training run (forward and remat recompute), and in
# 10d and 10e the served decode and the forward over the same tokens. A
# count may move by DROP_TOL of the assignments (bf16 rounding that flips
# a pick); a routing or slot fault moves it by far more.
MOE_DROPS = {"10b": (677928, 983040),
             "10d decode": (114768, 344064), "10d forward": (158103, 344064),
             "10e decode": (84, 1024), "10e forward": (277, 1024)}
DROP_TOL = 0.002


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "nvidia-smi: " + out.stderr.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
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


def attention_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the attention visits for these shapes."""
    if not causal:
        return s * t
    total = 0
    for i in range(s):
        qa = i + t - s
        lo = max(0, qa - window + 1) if window > 0 else 0
        total += max(0, min(t, qa + 1) - lo)
    return total


def bound(flops: float, nbytes: float, dtype: str):
    """(bound_ms, bound_by): the larger of FLOPs over peak and bytes over
    memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def attention_bound(b, s, h, kv, d, t, dtype: str, causal=True, window=0):
    """q, k, v read once and o written once; 4 FLOPs a (pair, dim)."""
    flops = 4 * b * h * d * attention_pairs(s, t, causal, window)
    elem = 2 if dtype == "bfloat16" else 4
    return bound(flops, elem * d * (2 * b * s * h + 2 * b * t * kv), dtype)


def scan_bound(n, s, r, dtype: str):
    """a, b read once and h written once; a multiply and an add in fp32 a
    step."""
    elem = 2 if dtype == "bfloat16" else 4
    return bound(2 * n * s * r, 3 * elem * n * s * r, "float32")


def time_flash(shape, inputs, kernel, plain) -> dict:
    """Phase 4: the bf16 causal flash kernel at a path's shape against its
    plain version and SDPA, beside the bound; the kernel JSON's numbers."""
    import torch.nn.functional as F
    b, s, h, kv, d = shape
    q, k, v = inputs(b, s, h, kv, d, "bfloat16")
    ms = cuda_ms(lambda: kernel(q, k, v), iters=20)
    plain_ms = cuda_ms(lambda: plain(q, k, v), iters=5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=h != kv), iters=20)
    bound_ms, by = attention_bound(b, s, h, kv, d, s, "bfloat16")
    flops = 4 * b * h * d * attention_pairs(s, s, True, 0)
    print(f"flash_attention at {shape} bf16 causal: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms, "
          f"sdpa {lib:.4f} ms ({flops / lib / 1e9:.1f} TFLOP/s), "
          f"bound {bound_ms:.4f} ms ({by}, {bound_ms / ms:.3f} of it "
          f"reached)", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib}


def check_close(label: str, out, want, tol: float) -> float:
    diff = (out.float() - want.float()).abs()
    err = diff.max().item()
    ok = bool((diff <= tol * (1 + want.float().abs())).all())
    print(f"{label}: max_abs_err {err:.3e} (tol {tol}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    require(ok and math.isfinite(err), f"{label}: out of tolerance")
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         rglru_scan_bwd_ref, rglru_scan_ref)
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd, rglru_scan_fwd

    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- build: one nvcc per source, all started together -------------------
    t0 = time.time()
    built = kbuild.build("flash_attention.cu", "rglru_scan.cu")
    print(f"build: {', '.join(p.name for p, _ in built.values())} in "
          f"{time.time() - t0:.1f} s")
    for _, log in built.values():
        print_ptxas(log)
    check_hgmma(built["flash_attention.cu"][0])

    gen = torch.Generator(device="cuda").manual_seed(0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(b, s, h, kv, d, dtype, t=None):
        t = t or s
        return [torch.randn(shape, device="cuda", generator=gen)
                .to(dtypes[dtype]) for shape in
                ((b, s, h, d), (b, t, kv, d), (b, t, kv, d))]

    def scan_inputs(shape, dtype="float32", rounded=False):
        """The reference's inputs: a in (0.8, 1), b ~ 0.1 N(0, 1)."""
        a = torch.sigmoid(torch.randn(shape, device="cuda",
                                      generator=gen)) * 0.2 + 0.8
        b = 0.1 * torch.randn(shape, device="cuda", generator=gen)
        if rounded:
            a, b = (x.bfloat16().float() for x in (a, b))
        return a.to(dtypes[dtype]), b.to(dtypes[dtype])

    # -- phase 1a: flash kernel against its plain version -------------------
    mark("1")
    # every row in fp32 (the CUDA-core kernel) and bf16 (the tensor-core
    # kernel): causal sweep, windows, non-causal, T > S, D = 64, 128, 256
    rows = [(shape, True, 0, None)
            for shape in [(1, 128, 1, 1, 64), (2, 256, 4, 2, 64),
                          (1, 512, 8, 8, 128), (2, 384, 6, 2, 64),
                          (1, 256, 4, 1, 128)]]
    rows += [((1, 512, 4, 2, 64), True, w, None) for w in (64, 128, 256)]
    rows += [((2, 256, 4, 4, 64), False, 0, None),
             ((1, 256, 4, 2, 64), True, 0, 512),     # T > S
             ((1, 256, 4, 2, 64), True, 128, 512),
             ((1, 256, 2, 2, 256), True, 0, None),
             ((1, 64, 2, 2, 64), True, 0, None),     # S, T under a tile
             ((1, 32, 2, 1, 128), True, 0, 96)]      # ... and a ragged T
    cases = [(shape, dt, causal, window, t)
             for shape, causal, window, t in rows for dt in DTYPES]
    cases += [(shape, "bfloat16", True, 0, None)
              for shape in (SLICE, MOE_SLICE, ARCTIC_SLICE, WHISPER_SLICE)]
    slice_err = {}
    for shape, dt, causal, window, t in cases:
        q, k, v = inputs(*shape, dt, t=t)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        err = check_close(f"flash kernel-vs-plain {shape} t={t or shape[1]} "
                          f"{dt} causal={causal} window={window}", out, want,
                          TOL[dt])
        if shape in (SLICE, MOE_SLICE, WHISPER_SLICE) and dt == "bfloat16":
            slice_err[shape] = err
        del q, k, v, out, want

    prefill, llama_prefill = (
        prefill_rows(inputs, flash_attention_fwd, flash_attention_ref, shape)
        for shape in (PREFILL, LLAMA_PREFILL))

    # the autograd op on CUDA tensors: kernel forward, reference backward
    q, k, v = (x.requires_grad_() for x in inputs(1, 256, 2, 2, 64,
                                                 "float32"))
    before = flash_attention_fwd.launches
    (ops.flash_attention(q, k, v, True, 0) ** 2).sum().backward()
    require(flash_attention_fwd.launches == before + 1,
            "ops.flash_attention did not launch the kernel")
    grads = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    (flash_attention_ref(q, k, v, True, 0) ** 2).sum().backward()
    gerr = max((a - x.grad).abs().max().item() for a, x in zip(grads, (q, k, v)))
    print(f"flash op gradients vs plain autograd: max_abs_err {gerr:.3e} "
          f"(tol 1e-4)")
    require(gerr <= 1e-4, "flash op gradients disagree")

    # -- phase 1b: rglru_scan kernel against its plain version --------------
    scan_cases = [(shape, "float32", rounded)
                  for shape in [(1, 256, 128), (2, 512, 256), (3, 256, 384)]
                  for rounded in (False, True)]
    scan_cases += [((2, 512, 256), "bfloat16", False),
                   (RG_SHAPE, "float32", False)]
    rg_err = None
    for shape, dt, rounded in scan_cases:
        a, b = scan_inputs(shape, dt, rounded)
        out = rglru_scan_fwd(a, b)
        torch.cuda.synchronize()
        tol = SCAN_TOL if dt == "float32" else TOL[dt]
        err = check_close(f"rglru kernel-vs-plain {shape} {dt}"
                          f"{' bf16-rounded' if rounded else ''}", out,
                          rglru_scan_ref(a, b), tol)
        if shape == RG_SHAPE:
            rg_err = err
        # the reverse mode against the plain adjoint, on the same inputs
        g = torch.randn(shape, device="cuda", generator=gen).to(a.dtype)
        for name, x, want in zip(("da", "db"), rglru_scan_bwd(a, g, out),
                                 rglru_scan_bwd_ref(a, g, out)):
            check_close(f"rglru reverse-vs-plain {name} {shape} {dt}", x,
                        want, tol)
    a, b = scan_inputs((2, 2, 256, 128))                 # leading dims
    check_close("rglru op-vs-plain (2, 2, 256, 128) float32",
                ops.rglru_scan(a, b), rglru_scan_ref(a, b), SCAN_TOL)
    a = torch.full((1, 2048, 64), 0.99, device="cuda")   # decay stability
    h = rglru_scan_fwd(a, torch.full_like(a, 0.01))
    check_close("rglru kernel-vs-plain (1, 2048, 64) decay", h,
                rglru_scan_ref(a, torch.full_like(a, 0.01)), SCAN_TOL)
    require(h.abs().max().item() < 2.0, "rglru scan is not bounded")

    # the autograd op on CUDA tensors: kernel forward and adjoint
    a, b = scan_inputs((1, 256, 128))
    a = (a * 0.5).requires_grad_()
    b = b.requires_grad_()
    before = rglru_scan_fwd.launches
    (ops.rglru_scan(a, b) ** 2).sum().backward()
    require(rglru_scan_fwd.launches == before + 2,
            "ops.rglru_scan did not launch the kernel forward and backward")
    grads = [a.grad.clone(), b.grad.clone()]
    a.grad = b.grad = None
    (rglru_scan_ref(a, b) ** 2).sum().backward()
    gerr = max((g - x.grad).abs().max().item()
               for g, x in zip(grads, (a, b)))
    print(f"rglru op gradients (a and b) vs plain autograd: max_abs_err "
          f"{gerr:.3e} (tol 1e-4)")
    require(gerr <= 1e-4, "rglru op gradients disagree")
    # the same at the path shape, through the kernel's reverse mode
    a, b = scan_inputs(RG_SHAPE)
    a, b = a.requires_grad_(), b.requires_grad_()
    g = torch.randn(RG_SHAPE, device="cuda", generator=gen)
    before = rglru_scan_fwd.launches
    ops.rglru_scan(a, b).backward(g)
    require(rglru_scan_fwd.launches == before + 2,
            "ops.rglru_scan did not launch the kernel forward and backward")
    grads = [a.grad.clone(), b.grad.clone()]
    a.grad = b.grad = None
    rglru_scan_ref(a, b).backward(g)
    gerr = max((x - y.grad).abs().max().item()
               for x, y in zip(grads, (a, b)))
    print(f"rglru op gradients at {RG_SHAPE} vs plain autograd: max_abs_err "
          f"{gerr:.3e} (tol 1e-4)")
    require(gerr <= 1e-4, "rglru op gradients disagree at the path shape")
    del a, b, g, h, out, grads

    # -- phase 2: the models on the card, kernels on vs off -----------------
    mark("2")
    # head_dim 64 and 256: the flash kernel is built for head widths 64,
    # 128, 256; fp32 runs the CUDA-core kernel, bf16 the tensor-core one
    model_on_off("gemma-7b", head_dim=64)
    model_on_off("gemma-7b", head_dim=256, dtype="bfloat16")
    model_on_off("recurrentgemma-2b")
    model_on_off(WHISPER, head_dim=64)

    # -- phase 3: the training paths ----------------------------------------
    mark("3")
    counters = {"flash_attention": flash_attention_fwd,
                "rglru_scan": rglru_scan_fwd}
    gemma = drive("gemma-7b", GEMMA_ARGV, counters)
    require(gemma["launches"]["flash_attention"]
            == gemma["per_step"]["attn"] * gemma["steps"],
            "flash kernel launch count is off on the gemma-7b path")
    rg = drive("recurrentgemma-2b", RG_ARGV, counters)
    require(rg["launches"]["rglru_scan"]
            == rg["per_step"]["rglru"] * rg["steps"],
            "rglru_scan kernel launch count is off on the recurrentgemma "
            "path")
    for path in (gemma, rg):
        check_step1("", path["label"], path["losses"][0])

    # -- phase 4: timings at each kernel's path shape -----------------------
    mark("4")
    saved = {k: c.launches for k, c in counters.items()}
    fa = {shape: time_flash(shape, inputs, flash_attention_fwd,
                            flash_attention_ref)
          for shape in (SLICE, MOE_SLICE, WHISPER_SLICE)}

    a, b = scan_inputs(RG_SHAPE)
    rg_ms = cuda_ms(lambda: rglru_scan_fwd(a, b), iters=50)
    rg_plain = cuda_ms(lambda: rglru_scan_ref(a, b), iters=3, warmup=1)
    rg_bound, rg_by = scan_bound(*RG_SHAPE, "float32")
    rg_bytes = 3 * 4 * math.prod(RG_SHAPE)
    print(f"rglru_scan at {RG_SHAPE} fp32: kernel {rg_ms:.4f} ms "
          f"({rg_bytes / rg_ms / 1e6:.1f} GB/s), plain {rg_plain:.3f} ms, "
          f"bound {rg_bound:.4f} ms ({rg_by}, {rg_bound / rg_ms:.3f} of it "
          f"reached); library: none (no single PyTorch call computes a "
          f"linear recurrence)", flush=True)
    # the reverse mode (the op's adjoint): reads a, g, h, writes da, db
    g = torch.randn(RG_SHAPE, device="cuda", generator=gen)
    h = rglru_scan_fwd(a, b)
    bwd_ms = cuda_ms(lambda: rglru_scan_bwd(a, g, h), iters=50)
    bwd_plain = cuda_ms(lambda: rglru_scan_bwd_ref(a, g, h), iters=3,
                        warmup=1)
    bwd_bound = 5 * 4 * math.prod(RG_SHAPE) / PEAK_BYTES * 1e3
    print(f"rglru_scan reverse mode at {RG_SHAPE} fp32: kernel "
          f"{bwd_ms:.4f} ms ({5 * 4 * math.prod(RG_SHAPE) / bwd_ms / 1e6:.1f}"
          f" GB/s), plain {bwd_plain:.3f} ms, bound {bwd_bound:.4f} ms "
          f"(bytes, {bwd_bound / bwd_ms:.3f} of it reached)", flush=True)
    del a, b, g, h
    for name, c in counters.items():
        c.launches = saved[name]

    # -- phase 5: device time of one training step of each path -------------
    mark("5")
    profile_step(gemma)
    profile_step(rg)

    # -- phase 6: FLOP count -> calibrated step DAG -> DES predictions -------
    mark("6")
    two = predict_phase(gemma, counters)
    waterfill_phase()

    # -- phase 7: serving: decode at full depth, prefill at prefill_32k -----
    mark("7")
    for label, arch in (("7a", "gemma-7b"), ("7b", "recurrentgemma-2b")):
        serve_phase(label, arch, counters)
    mark("7c")
    prefill_launches = prefill_phase(counters)

    # -- phase 8: the training driver in full -------------------------------
    mark("8")
    try:
        restart = restart_phase(gemma, two, counters)
        calibrate_phase(restart)
        async_launches = async_phase(two, counters)
        optimizer_phase()
    finally:
        shutil.rmtree(PHASE8_DIR, ignore_errors=True)

    # -- phase 9: xlstm-350m at full width and depth, no kernel -------------
    mark("9")
    card_vs_cpu("9a", XLSTM, XLSTM_SMOKE_SEQ,
                ({}, {"remat": True, "time_chunk": 16}))
    try:
        xlstm = xlstm_phase(counters)
    finally:
        shutil.rmtree(PHASE9_DIR, ignore_errors=True)
    check_step1("9b ", XLSTM, xlstm["losses"][0])

    # -- phase 10: the MoE block: deepseek-moe-16b, arctic-480b -------------
    mark("10")
    for arch in (DEEPSEEK, ARCTIC):
        card_vs_cpu("10a", arch, MOE_SMOKE_SEQ, ({}, {"remat": True}))
    deepseek = moe_train_phase(counters)
    serve_phase("10d", DEEPSEEK, counters, gate_dtype="float32")
    serve_phase("10e", ARCTIC, counters, gate_dtype="float32",
                argv=ARCTIC_SERVE_ARGV)

    # -- phase 11: the encoder and cross-attention --------------------------
    mark("11")
    for arch in (WHISPER, LLAMA):
        card_vs_cpu("11a", arch, XATTN_SMOKE_SEQ, ({}, {"remat": True}))
    whisper = whisper_train_phase(counters)
    serve_phase("11c", WHISPER, counters)
    # gated in fp32: the patch embeddings move the logits by less than the
    # bf16 check's own error, which could not tell a lost cross K/V
    serve_phase("11d", LLAMA, counters, gate_dtype="float32",
                argv=LLAMA_SERVE_ARGV, gate=SERVE_GATE)
    mark("11e")
    llama_prefill_launches = prefill_phase(counters, "11e", LLAMA, layers=5)

    # -- phase 12: sharding: the gemma path as DTensors on a 1x1 mesh -------
    mark("12")
    mesh_launches, counted = mesh_phase(gemma, restart, counters)

    # -- phase 13: the dry-run on fake cuda tensors --------------------------
    mark("13a")
    dryrun_phase(gemma, counted)

    # -- phase 14: the paper's PS-cluster pipeline on the host ---------------
    mark("14a")
    paper_phase(card)
    mark("14b")
    whatif_phase(card)

    # -- phase 15: the batched and fleet engines on the host -----------------
    mark("15a")
    batched_phase(card)
    mark("15b")
    fleet_whatif_phase(card)
    mark("15c")
    fleet_phase(card)

    # -- phase 16: placement search and closed-loop calibration --------------
    mark("16a")
    calibration_phase(card)
    mark("16b")
    placement_phase(card)
    mark("16c")
    surrogate_phase(card)

    flash_launches = {"train gemma-7b 4 layers x 5 steps":
                      gemma["launches"]["flash_attention"],
                      "train deepseek-moe-16b 4 layers x 5 steps":
                      deepseek["launches"]["flash_attention"],
                      "train whisper-small 12 layers x 5 steps":
                      whisper["launches"]["flash_attention"],
                      "prefill gemma-7b 28 layers x 3 runs": prefill_launches,
                      "prefill llama-3.2-vision-90b 5 layers x 3 runs":
                      llama_prefill_launches,
                      "train gemma-7b 4 layers x 5 steps as DTensors on a "
                      "1x1 mesh": mesh_launches,
                      "train gemma-7b 4 layers x 1 step as DTensors, "
                      "counted (13a)": counted["launches"],
                      **restart["launches"], **async_launches}
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:29",
        "launches": sum(flash_launches.values()),
        "launches_by_path": flash_launches,
        "max_abs_err": slice_err[SLICE],
        **fa[SLICE],
        "deepseek_shape": list(MOE_SLICE),
        "deepseek_max_abs_err": slice_err[MOE_SLICE],
        **{f"deepseek_{k}": x for k, x in fa[MOE_SLICE].items()},
        "prefill_shape": list(PREFILL),
        "prefill_max_abs_err_first_rows": prefill["err_first"],
        "prefill_max_abs_err_last_rows": prefill["err_last"],
        "prefill_ms": prefill["ms"],
        "prefill_bound_ms": prefill["bound_ms"],
        "prefill_library_ms": prefill["library_ms"],
        "whisper_shape": list(WHISPER_SLICE),
        "whisper_max_abs_err": slice_err[WHISPER_SLICE],
        **{f"whisper_{k}": x for k, x in fa[WHISPER_SLICE].items()},
        "llama_prefill_shape": list(LLAMA_PREFILL),
        "llama_prefill_max_abs_err_first_rows": llama_prefill["err_first"],
        "llama_prefill_max_abs_err_last_rows": llama_prefill["err_last"],
        "llama_prefill_ms": llama_prefill["ms"],
        "llama_prefill_bound_ms": llama_prefill["bound_ms"],
        "llama_prefill_bound_by": llama_prefill["bound_by"],
        "llama_prefill_library_ms": llama_prefill["library_ms"],
    }, {
        "name": "rglru_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:25",
        "launches": rg["launches"]["rglru_scan"],
        "max_abs_err": rg_err,
        "ms": rg_ms,
        "plain_ms": rg_plain,
        "bound_ms": rg_bound,
        "bound_by": rg_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def state_bytes(cfg) -> int:
    """fp32 params and AdamW's two fp32 moments: 12 bytes a parameter."""
    from repro_torch.models.transformer import param_count_cfg
    return 12 * param_count_cfg(cfg)


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def evict(path: Path) -> None:
    """Drops a checkpoint's files from the page cache (fsync, then
    ``POSIX_FADV_DONTNEED``), so that the next read comes from the disk."""
    for f in path.rglob("*"):
        if f.is_file():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def same_state(want, got) -> int:
    """Leaves of two ``{"params", "opt_state"}`` trees, matched by key,
    that differ (``torch.equal``; an ``int`` step by value)."""
    from repro_torch.tree import leaves, tree_map
    return sum(leaves(tree_map(
        lambda w, g: int(w != g if isinstance(w, int)
                         else not torch_equal(w, g)), want, got)))


def torch_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def restart_phase(gemma: dict, two: dict, counters) -> dict:
    """Phase 8a: the phase-3 path through ``train.run`` with checkpoints:
    a simulated failure at step 2, a resume from step 0, the resumed losses
    against phase 3's, and the last checkpoint restored (read from the
    disk, not the page cache) into fresh tensors against the run's final
    state. Returns what 8b compares with."""
    import gc

    import torch
    from repro_torch import checkpoint as ck
    from repro_torch.launch import train
    from repro_torch.tree import tree_map
    d = PHASE8_DIR / "restart"
    d.mkdir(parents=True, exist_ok=True)
    usage = shutil.disk_usage(d)
    b4, b2 = state_bytes(gemma["config"]), state_bytes(two["config"])
    print(f"8a disk at {d}: total {usage.total / 1e9:.1f} GB, free "
          f"{usage.free / 1e9:.1f} GB; a checkpoint of the "
          f"{gemma['config'].n_layers}-layer state is {b4 / 1e9:.2f} GB "
          f"(12 B a parameter), {DISK_FACTOR}x that is "
          f"{DISK_FACTOR * b4 / 1e9:.1f} GB", flush=True)
    path = gemma
    if usage.free < DISK_FACTOR * b4:
        require(usage.free >= DISK_FACTOR * b2,
                f"8a: {usage.free / 1e9:.1f} GB free, under {DISK_FACTOR}x "
                f"even the 2-layer checkpoint ({b2 / 1e9:.2f} GB)")
        print(f"8a: depth cut to {two['config'].n_layers} layers: the disk's "
              f"free space is under {DISK_FACTOR}x the "
              f"{gemma['config'].n_layers}-layer checkpoint", flush=True)
        path = two
    label = f"8a {path['label']}"
    argv = [*path["argv"], "--ckpt-dir", str(d), "--ckpt-every", "100"]

    # the first run: saves step 0, fails at step 2
    args = train.build_argparser().parse_args([*argv, "--fail-at", "2"])
    for c in counters.values():
        c.launches = 0
    try:
        train.run(args, use_flash_kernel=True)
    except RuntimeError as e:
        if str(e) != "simulated node failure at step 2":
            raise
    else:
        raise SmokeFailure("8a: --fail-at 2 did not stop the run")
    crashed = counters["flash_attention"].launches
    gc.collect()
    print(f"{label}: the run with --fail-at 2 raised 'simulated node failure "
          f"at step 2'; flash launches {crashed} (expected "
          f"{2 * path['per_step']['attn']}); latest checkpoint step "
          f"{ck.latest_step(str(d))}", flush=True)
    require(crashed == 2 * path["per_step"]["attn"],
            "8a: flash launch count is off on the failed run")
    require(ck.latest_step(str(d)) == 0, "8a: no checkpoint of step 0")

    # the same command again: restores step 0, runs steps 1-4, saves step 4
    res = drive(f"{label} resumed", argv, counters, keep=True)
    require(res["launches"]["flash_attention"]
            == res["per_step"]["attn"] * res["steps"] and res["steps"] == 4,
            "8a: the resumed run did not run steps 1-4 through flash")
    rel = [abs(a - b) / abs(b) for a, b in zip(res["losses"],
                                                path["losses"][1:])]
    print(f"{label}: resumed losses 1-4 against phase 3's "
          + " ".join(f"{x:.6f}" for x in path["losses"][1:])
          + f": largest relative difference {max(rel):.3e} (bound "
          f"{RESTART_TOL})", flush=True)
    require(max(rel) <= RESTART_TOL, "8a: the resumed losses moved")

    result = res.pop("result")
    final = {"params": result["params"], "opt_state": result["opt_state"]}
    step_dir = d / "step_00000004"
    nbytes = dir_bytes(step_dir)
    save_s, warm_s = result["ckpt_seconds"][-1], result["restore_seconds"]
    del result
    fresh = tree_map(lambda x: torch.empty_like(x)
                     if isinstance(x, torch.Tensor) else 0, final)
    evict(step_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, meta = ck.restore(str(d), fresh, step=4)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    bad = same_state(final, tree)
    print(f"{label}: checkpoint of step 4 {nbytes} bytes ({nbytes / 1e9:.2f}"
          f" GB); save {save_s:.3f} s ({nbytes / save_s / 1e9:.2f} GB/s); "
          f"restore of step 0 in the resumed run {warm_s:.3f} s "
          f"({nbytes / warm_s / 1e9:.2f} GB/s, warm: written seconds "
          f"before); restore of step 4 into fresh tensors {cold_s:.3f} s "
          f"({nbytes / cold_s / 1e9:.2f} GB/s, cold: evicted from the page "
          f"cache first); leaves unequal to the run's final state: {bad}",
          flush=True)
    require(bad == 0 and meta["step"] == 4,
            "8a: the restored state differs from the run's final state")
    del final, fresh, tree
    torch.cuda.empty_cache()
    return {"bytes": nbytes, "save_s": save_s, "warm_s": warm_s,
            "cold_s": cold_s, "launches": {f"{label} failed run x 2 steps": crashed,
                         f"{label} resumed x 4 steps":
                         res["launches"]["flash_attention"]}}


def calibrate_phase(restart: dict) -> None:
    """Phase 8b: the port's ``CheckpointCostModel.calibrate`` on the same
    disk, and its predicted restore of 8a's checkpoint."""
    from repro_torch.core.faults import CheckpointCostModel
    sizes = (1 << 24, 1 << 26, 1 << 28)
    t0 = time.perf_counter()
    model = CheckpointCostModel.calibrate(str(PHASE8_DIR / "calibrate"),
                                          sizes=sizes)
    pred = model.restore_cost(restart["bytes"])
    warm, cold = restart["warm_s"], restart["cold_s"]
    print(f"8b CheckpointCostModel.calibrate at {', '.join(map(str, sizes))} "
          f"fp32 elements onto the card ({time.perf_counter() - t0:.1f} s; "
          f"its reads are warm, each file written just before): alpha "
          f"{model.alpha:.4e} s/B ({1 / max(model.alpha, 1e-30) / 1e9:.2f} "
          f"GB/s), beta {model.beta:.4f} s; predicted restore of 8a's "
          f"{restart['bytes'] / 1e9:.2f} GB checkpoint {pred:.3f} s against "
          f"{warm:.3f} s measured warm ({pred / warm - 1:+.3f}) and "
          f"{cold:.3f} s cold ({pred / cold - 1:+.3f})", flush=True)
    require(all(math.isfinite(x) and x >= 0 for x in (model.alpha,
                                                      model.beta)),
            "8b: the fitted restore cost is not finite and non-negative")


def async_phase(two: dict, counters) -> dict:
    """Phase 8c: the 2-layer path with async SGD (staleness 2) and int8
    compression, and synchronous with top-k; the payloads of one step's
    gradients at full width, and one leaf compressed on the card against
    the CPU. Returns the flash launches of the two runs."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_grad_step
    from repro_torch.optim import make_compressor
    from repro_torch.tree import leaves
    launches = {}
    runs = (("8c async tau=2 int8", ["--async-staleness", "2", "--compress",
                                     "int8"], "int8"),
            ("8c sync topk", ["--compress", "topk"], "topk"))
    for label, extra, name in runs:
        res = drive(label, [*two["argv"], *extra], counters, keep=True)
        launches[f"{label} x {res['steps']} steps"] = \
            res["launches"]["flash_attention"]
        require(res["launches"]["flash_attention"]
                == res["per_step"]["attn"] * res["steps"],
                f"{label}: flash launch count is off")
        if name == "int8":
            print(f"{label}: step-0 loss {res['losses'][0]!r} against the "
                  f"2-layer drive's {two['losses'][0]!r}", flush=True)
            require(res["losses"][0] == two["losses"][0],
                    f"{label}: step-0 loss is not the 2-layer drive's")
        params, cfg = res.pop("result")["params"], res["config"]
        torch.cuda.empty_cache()
        data = SyntheticLM(cfg, two["args"].batch, two["args"].seq, seed=0)
        batch = {k: v.cuda() for k, v in data.next_batch().items()}
        grads, _ = make_grad_step(cfg)(params, batch)
        comp = make_compressor(name)
        err = comp.init(params)
        compress_ms = cuda_ms(lambda: comp.compress(grads, err), iters=3)
        payload, _ = comp.compress(grads, err)
        decompress_ms = cuda_ms(lambda: comp.decompress(payload), iters=3)
        sizes = [x.numel() for x in leaves(params)]
        if name == "int8":
            got, want = comp.wire_bytes(payload), sum(sizes) + 4 * len(sizes)
            what = "wire bytes"
        else:
            got = sum(x.numel() for x in leaves(payload)
                      if isinstance(x, torch.Tensor)
                      and x.dtype == torch.int32)
            want = sum(max(int(0.01 * n), 1) for n in sizes)
            what = "indices"
        wire, n = comp.wire_bytes(payload), sum(sizes)
        print(f"{label}: one step's gradients of the final weights ({n} "
              f"elements in {len(sizes)} leaves): compress "
              f"{compress_ms:.3f} ms, decompress {decompress_ms:.3f} ms; "
              f"{what} {got} (expected {want}); wire bytes {wire} "
              f"({wire / (4 * n):.4f} of fp32)", flush=True)
        require(got == want, f"{label}: {what} {got}, expected {want}")
        del payload, err

        # the card against the CPU on layer 0's MLP weight gradient
        g0 = grads["scan"]["s0_attn"]["mlp"]["wi"][0].contiguous()
        del grads
        outs = []
        for g in (g0, g0.cpu()):
            pay, _ = comp.compress({"w": g}, comp.init({"w": g}))
            outs.append({k: v.cpu() if isinstance(v, torch.Tensor) else v
                         for k, v in pay["w"].items()})
        card, cpu = outs
        eq = {k: torch_equal(v, cpu[k]) if isinstance(v, torch.Tensor)
              else v == cpu[k] for k, v in card.items()}
        print(f"{label}: {name} compress of layer 0's MLP weight gradient "
              f"{tuple(g0.shape)} on the card against the CPU: "
              + ", ".join(f"{k} {'equal' if e else 'DIFFERENT'}"
                          for k, e in eq.items()), flush=True)
        require(all(eq.values()),
                f"{label}: the card's payload differs from the CPU's")
        del params, g0, outs, card, cpu
        torch.cuda.empty_cache()
    return launches


def optimizer_phase() -> None:
    """Phase 8d: three updates of momentum, adamw_bf16 and adafactor on one
    full-width leaf, card against CPU from the same numpy data; then an
    adamw_bf16 state of that leaf saved and restored on the card."""
    import numpy as np
    import torch
    from repro_torch import checkpoint as ck
    from repro_torch.optim import make_optimizer
    from repro_torch.tree import leaves, tree_map
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(OPT_SHAPE, dtype=np.float32)
    gs = [rng.standard_normal(OPT_SHAPE, dtype=np.float32) for _ in range(3)]
    for name in ("momentum", "adamw_bf16", "adafactor"):
        out = {}
        for dev in ("cuda", "cpu"):
            opt = make_optimizer(name, lr=1e-2)
            p = {"w": torch.tensor(p0, device=dev)}
            st = opt.init(p)
            for g in gs:
                p, st = opt.update({"w": torch.tensor(g, device=dev)}, st, p)
            out[dev] = {"params": p, "opt_state": st}
        card, cpu = out["cuda"], out["cpu"]
        w, want = card["params"]["w"].cpu(), cpu["params"]["w"]
        rel = ((w - want).norm() / want.norm()).item()
        check_close(f"8d {name} {OPT_SHAPE} x 3 updates, card vs CPU params "
                    f"(relative norm error {rel:.3e})", w, want, 1e-6)
        # state: fp32 to 1e-6; bf16 moments to one bf16 step, since both
        # devices round an fp32 value that may differ in its last bits
        for x, y in zip(leaves(card["opt_state"]),
                        leaves(cpu["opt_state"])):
            if isinstance(x, int):
                require(x == y == 3, f"8d {name}: step {x} vs {y}")
                continue
            tol = 2 ** -8 if x.dtype == torch.bfloat16 else 1e-6
            check_close(f"8d {name} state {tuple(x.shape)} {x.dtype}, card "
                        f"vs CPU", x.cpu(), y, tol)
        if name == "adamw_bf16":
            d = PHASE8_DIR / "bf16"
            ck.save(str(d), 3, card)
            fresh = tree_map(lambda x: torch.empty_like(x)
                             if isinstance(x, torch.Tensor) else 0, card)
            tree, _ = ck.restore(str(d), fresh)
            bad = same_state(card, tree)
            print(f"8d adamw_bf16 state of {OPT_SHAPE} saved and restored on "
                  f"the card: moments {card['opt_state']['mu']['w'].dtype}, "
                  f"{dir_bytes(d)} bytes on disk; leaves unequal: {bad}",
                  flush=True)
            require(bad == 0, "8d: the restored bf16 state differs")
        del out, card, cpu
    torch.cuda.empty_cache()


def check_drops(label: str, tally) -> None:
    """Holds a ``counted_drops`` tally to the one ``MOE_DROPS`` records."""
    dropped, assigned = MOE_DROPS[label]
    got = tally.dropped()
    print(f"{label}: dropped {got} of {tally.assigned} routed assignments, "
          f"recorded {dropped} of {assigned} (tolerance "
          f"{DROP_TOL * assigned:.0f})", flush=True)
    require(tally.assigned == assigned
            and abs(got - dropped) <= DROP_TOL * assigned,
            f"{label}: the dropped assignments moved from the recorded ones")


def check_step1(prefix: str, arch: str, got: float) -> None:
    """A path's step-1 loss against the one PERF.md records."""
    want = STEP1_LOSS[arch]
    print(f"{prefix}{arch} step-1 loss {got:.4f} vs recorded {want} "
          f"(tol {STEP1_TOL})", flush=True)
    require(abs(got - want) <= STEP1_TOL, f"{arch}: step-1 loss moved")


def card_vs_cpu(label: str, arch: str, seq: int, overrides) -> None:
    """Phases 9a, 10a and 11a: an arch's smoke model (fp32) on the card
    against the CPU, from the same numpy weights and batch (B = 2, S =
    ``seq``; an encoder arch's frames and a cross-attention arch's patch
    embeddings, 0.1·N(0, 1), and every ``xattn`` gate at ``SMOKE_GATE``):
    the loss within 1e-5 relative and every gradient within 1e-4, once for
    each dict of config ``overrides`` (9a: as configured, then with remat
    and a time chunk of 16, the chunked time scan under the group remat)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import stub_inputs
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.models import transformer
    from repro_torch.tree import leaves
    base = get_config(arch, smoke=True)
    weights = params_to_numpy(transformer.init_params(
        torch.Generator().manual_seed(3), base))
    set_gates(weights, SMOKE_GATE)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, base.vocab, (2, seq + 1))
    stubs = {name: rng.standard_normal(shape, dtype=np.float32) * 0.1
             for name, (shape, _) in stub_inputs(base, 2).items()}
    for over in overrides:
        cfg = base.replace(**over)
        res = {}
        for dev in ("cuda", "cpu"):
            params = params_from_numpy(weights, dev)
            t = torch.from_numpy(toks).to(dev)
            loss, _ = transformer.loss_fn(
                params, {"tokens": t[:, :-1], "labels": t[:, 1:],
                         **{k: torch.from_numpy(v).to(dev)
                            for k, v in stubs.items()}}, cfg)
            grads = torch.autograd.grad(loss, list(leaves(params)))
            res[dev] = (loss.item(), [g.cpu() for g in grads])
        (card, gcard), (cpu, gcpu) = res["cuda"], res["cpu"]
        rel = abs(card - cpu) / abs(cpu)
        gerr = max(((a - b).abs() / (1 + b.abs())).max().item()
                   for a, b in zip(gcard, gcpu))
        print(f"{label} {arch} smoke (layers {cfg.n_layers}, d_model "
              f"{cfg.d_model}, {cfg.dtype}, S={seq}, remat "
              f"{cfg.remat}, time_chunk {cfg.time_chunk}) card vs CPU: loss "
              f"{card:.7f} vs {cpu:.7f} (rel {rel:.2e}, tol 1e-5); "
              f"{len(gcpu)} gradients, max |card - CPU| / (1 + |CPU|) "
              f"{gerr:.2e} (tol 1e-4)", flush=True)
        require(rel <= 1e-5 and gerr <= 1e-4,
                f"{label}: {arch} on the card differs from the CPU")


def xlstm_phase(counters) -> dict:
    """Phases 9b-9e: xlstm-350m at full width and depth through
    ``train.run`` (3 steps, launch counts set to 0 just before and read
    just after: the path runs neither kernel), a profile of one more step
    of that run, decode through ``serve.run`` (``serve_phase``), and a run
    failed at step 2 and resumed. Returns the 9b path."""
    import torch
    path = drive(f"9b {XLSTM}", XLSTM_ARGV, counters, keep=True)
    require(all(n == 0 for n in path["launches"].values()),
            f"9b: the {XLSTM} path launched a kernel")
    cfg, args = path["config"], path["args"]
    print(f"9b {XLSTM}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}, vocab "
          f"{cfg.vocab} padded to {cfg.padded_vocab}; ms a step "
          f"{path['steady_ms']:.1f} (median of steps 2-3), tokens/s "
          f"{args.batch * args.seq / path['steady_ms'] * 1e3:.1f}, peak "
          f"{path['peak'] / 1e9:.2f} GB, step-1 loss "
          f"{path['losses'][0]:.4f}", flush=True)

    # 9c: one more step of the same run, profiled
    result = path.pop("result")
    busy, kernels = profile_step(path, result)
    del result
    torch.cuda.empty_cache()
    steps = cfg.n_layers * args.seq
    print(f"9c {XLSTM}: {kernels} device kernels a step, "
          f"{kernels / steps:.1f} a layer and time step; device busy "
          f"{busy:.1f} ms against the unprofiled {path['steady_ms']:.1f} ms "
          f"a step ({1 - busy / path['steady_ms']:.3f} idle)", flush=True)

    # gated in fp32: in bf16, 24 recurrent layers carry each rounding that
    # a product's shape changes, and forward's own rows differ by more than
    # the bound between B = 1 and B = 8 (printed beside the bf16 error)
    serve_phase("9d", XLSTM, counters, gate_dtype="float32")
    xlstm_restart(path, counters)
    return path


def xlstm_restart(path: dict, counters) -> None:
    """Phase 9e: 9b's path with a checkpoint every step, failed at step 2
    (it saves steps 0 and 1, then raises), then resumed (restores step 1,
    runs step 2): losses 1-3 against 9b's within the restart bound (the
    failed run's two as it prints them, to 4 decimals)."""
    import contextlib
    import io

    import torch
    from repro_torch import checkpoint as ck
    from repro_torch.launch import train
    argv = [*XLSTM_ARGV, "--ckpt-dir", str(PHASE9_DIR), "--ckpt-every", "1"]
    for c in counters.values():
        c.launches = 0
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            train.run(train.build_argparser().parse_args(
                [*argv, "--fail-at", "2"]), use_flash_kernel=True)
    except RuntimeError as e:
        if str(e) != "simulated node failure at step 2":
            raise
    else:
        raise SmokeFailure("9e: --fail-at 2 did not stop the run")
    finally:
        sys.stdout.write(out.getvalue())
    first = [float(x) for x in LOSS_LINE.findall(out.getvalue())]
    latest = ck.latest_step(str(PHASE9_DIR))
    print(f"9e {XLSTM}: the run with --fail-at 2 raised 'simulated node "
          f"failure at step 2' after losses {first}; latest checkpoint step "
          f"{latest}", flush=True)
    require(len(first) == 2 and latest == 1,
            "9e: the failed run did not save steps 0 and 1")
    torch.cuda.empty_cache()
    res = drive(f"9e {XLSTM} resumed", argv, counters, keep=True)
    result = res.pop("result")
    losses = first + res["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, path["losses"])]
    step_dir = PHASE9_DIR / "step_00000002"
    nbytes, want = dir_bytes(step_dir), state_bytes(path["config"])
    save_s, restore_s = result["ckpt_seconds"][-1], result["restore_seconds"]
    del result
    print(f"9e {XLSTM}: losses 1-3 " + " ".join(f"{x:.6f}" for x in losses)
          + " against 9b's " + " ".join(f"{x:.6f}" for x in path["losses"])
          + f": largest relative difference {max(rel):.3e} (bound "
          f"{RESTART_TOL}); checkpoint of step 2 {nbytes} bytes "
          f"({nbytes / 1e9:.2f} GB; 12 B a parameter is {want / 1e9:.2f} "
          f"GB), save {save_s:.3f} s ({nbytes / save_s / 1e9:.2f} GB/s), "
          f"restore of step 1 {restore_s:.3f} s "
          f"({nbytes / restore_s / 1e9:.2f} GB/s)", flush=True)
    require(len(losses) == 3 and res["steps"] == 1
            and max(rel) <= RESTART_TOL, "9e: the resumed losses moved")
    require(all(n == 0 for n in res["launches"].values()),
            "9e: the resumed run launched a kernel")
    torch.cuda.empty_cache()


def prefill_rows(inputs, kernel, plain, shape) -> dict:
    """Phase 1a at a prefill shape (gemma-7b's, llama-3.2-vision-90b's):
    the kernel's first and last ``PREFILL_ROWS`` rows against the plain
    version (the last rows right-aligned against all T keys), its time,
    SDPA's (with its grouped-query option where H > Kv), and the bound.

    q is scaled by ``PREFILL_Q_SCALE`` (exact in bf16): with N(0, 1) inputs
    the last rows would average v over 32k keys, outputs of about 0.007
    that the 2e-2 tolerance could not tell from a kernel that drops a key
    tile; with the softmax peaked on a few keys they are O(1)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, s, h, kv, d = shape
    n = PREFILL_ROWS
    q, k, v = inputs(*shape, "bfloat16")
    q.mul_(PREFILL_Q_SCALE)
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    errs = []
    for rows, got, want in (
            (f"0:{n}", out[:, :n], plain(q[:, :n], k[:, :n], v[:, :n])),
            (f"{s - n}:{s}", out[:, -n:], plain(q[:, -n:], k, v))):
        rel = (got.float() - want.float()).norm() / want.float().norm()
        print(f"flash at {shape}, rows {rows}: max |plain| "
              f"{want.float().abs().max().item():.3f}, relative norm error "
              f"{rel.item():.3e}")
        errs.append(check_close(
            f"flash kernel-vs-plain {shape} bf16 causal, q x "
            f"{PREFILL_Q_SCALE}, rows {rows}", got, want, TOL["bfloat16"]))
    del out, got, want
    ms = cuda_ms(lambda: kernel(q, k, v), iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    # no math backend: its score tensor would not fit
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    with sdpa_kernel(fused):
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=h != kv), iters=5,
            warmup=1)
    del qt, kt, vt
    bound_ms, by = attention_bound(b, s, h, kv, d, s, "bfloat16")
    flops = 4 * b * h * d * attention_pairs(s, s, True, 0)
    print(f"flash_attention at {shape} bf16 causal: kernel {ms:.4f} ms "
          f"({flops / ms / 1e9:.1f} TFLOP/s), sdpa {lib:.4f} ms "
          f"({flops / lib / 1e9:.1f} TFLOP/s), bound "
          f"{bound_ms:.4f} ms ({by}, "
          f"{bound_ms / ms:.3f} of it reached); plain: not run at this "
          f"shape (its score tensor would take "
          f"{4 * b * h * s * s / 1e9:.1f} GB)", flush=True)
    return {"err_first": errs[0], "err_last": errs[1], "ms": ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib}


def teacher_forced(params, cfg, toks, stubs):
    """``serve_step`` over ``toks`` (B, T) from a fresh state of length T
    (its cross K/V filled from ``stubs``, the frames or patch embeddings, in
    ``cfg.dtype``), each position's logits against ``forward``'s on the
    same tokens and stubs, over the real vocab. Returns the max error at
    each position (on the host), ``forward``'s logits, the decode's argmax
    (B, T) on the host and the final decode state."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers import dtype_of
    b, t = toks.shape
    stubs = {k: v.to(dtype_of(cfg.dtype)) for k, v in stubs.items()}
    with torch.inference_mode():
        full = transformer.forward(params, {"tokens": toks, **stubs}, cfg)[0]
    full = full[..., :cfg.vocab]
    state = transformer.init_decode_state(cfg, b, t, "cuda")
    if cfg.cross_len:
        with torch.no_grad():
            enc = transformer._get_encoder_states(params, stubs, cfg)
        state = transformer.precompute_cross_kv(
            params, state, enc.to(dtype_of(cfg.dtype)), cfg)
        del enc
    errs, greedy = [], []
    for i in range(t):
        li, state = transformer.serve_step(params, state, toks[:, i], cfg)
        errs.append((li[:, :cfg.vocab].float() - full[:, i].float())
                    .abs().max())
        greedy.append(li.argmax(-1))
    return (torch.stack(errs).cpu(), full, torch.stack(greedy, 1).cpu(),
            state)


def serve_phase(label: str, arch: str, counters, gate_dtype: str = "",
                argv=SERVE_ARGV, gate: float = 0.0) -> None:
    """Phases 7a, 7b, 9d, 10d, 10e, 11c and 11d: ``serve.run`` (``argv``:
    full width and depth unless it cuts them), then decode with teacher
    forcing against ``forward``, gated at the reference's bound in
    ``gate_dtype`` when it is given (the served dtype's error is then
    printed beside the forward's own spread), else in the served dtype.

    A cross-attention arch serves with every ``xattn`` gate at ``gate``
    (set in the weights ``serve.run`` draws), decodes from the cross K/V of
    the frames or patch embeddings it returns, and its logits are then held
    to move under another draw of them (``cross_matters``).

    An MoE arch's teacher-forced passes run at a capacity factor of E/k,
    where nothing drops (C = G in the forward, C = B in decode; each pass
    must drop nothing): at the served factor a decode step routes B tokens
    where the forward routes B·S, so the forward drops assignments that
    decode keeps, in the reference too. The assignments that decode (in
    ``serve.run``) and ``forward`` (over the same served tokens) each drop
    at the served factor are held to ``MOE_DROPS``; where the served dtype
    is not gated, its error is split by whether decode routed each
    position as the forward did."""
    import dataclasses

    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    args = serve.build_argparser().parse_args(["--arch", arch, *argv])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    with counted_drops() as served_drops, gates_at(serve, gate):
        res = serve.run(args)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg, ids = res["config"], res["ids"]
    dec = [1e3 * t for t in res["decode_seconds"]]
    pre = [1e3 * t for t in res["prefill_seconds"]]
    med = statistics.median(dec)
    kinds = [k for _ in range(cfg.n_groups) for k in cfg.pattern] \
        + list(cfg.tail_pattern)
    print(f"{label} serve {arch}: layers {cfg.n_layers} "
          f"({' '.join(kinds)}) d_model {cfg.d_model} dtype {cfg.dtype}, "
          f"B={args.batch}, prompt {args.prompt_len}, gen {args.gen}, "
          f"max_len {args.prompt_len + args.gen}", flush=True)
    print(f"{label} serve {arch}: ms a token step {med:.3f} (median of "
          f"{len(dec)} decode steps; min {min(dec):.3f}, max "
          f"{max(dec):.3f}); decode tokens/s {args.batch / med * 1e3:.1f}; "
          f"prefill {sum(pre) / 1e3:.3f} s ({len(pre)} steps, first "
          f"{pre[0]:.1f} ms, median {statistics.median(pre):.3f} ms); peak "
          f"memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB); launches "
          + ", ".join(f"{k} {n}" for k, n in launches.items())
          + " (the decode path runs no kernel)", flush=True)
    print(f"{label} serve {arch}: first generated ids "
          f"{ids[0, :12].tolist()}", flush=True)
    require(tuple(ids.shape) == (args.batch, args.gen)
            and int(ids.min()) >= 0 and int(ids.max()) < cfg.vocab,
            f"{label}: generated ids out of range")
    require(all(n == 0 for n in launches.values()),
            f"{label}: the decode path launched a kernel")
    params, prompts, stubs = res["params"], res["prompts"], res["stubs"]
    del res

    # teacher forcing on what was served: the same weights, a state of the
    # served max_len, the prompt and the generated ids fed through
    # serve_step; every position's logits held to forward's on the same
    # tokens (the reference's test_decode_matches_forward_teacher_forced),
    # in ``gate_dtype`` where it is given, then in the served dtype
    max_len = args.prompt_len + args.gen
    toks = torch.cat([prompts, ids.to(prompts.device)], dim=1)
    checked, no_drop = cfg, cfg.moe is not None
    if no_drop:
        m = cfg.moe
        checked = cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
    gate = checked.replace(dtype=gate_dtype) if gate_dtype else checked
    torch.cuda.reset_peak_memory_stats()
    for c in (gate, checked) if gate_dtype else (checked,):
        with counted_drops() as drops:
            errs, full, greedy, state = teacher_forced(params, c, toks,
                                                       stubs)
        err = errs.max().item()
        # over the real vocab: a padded tail holds -finfo.max / 2
        scale = full.float().abs().max().item()
        tol = 2e-2 * max(scale, 1.0)
        # the served ids against the argmax of these logits (informational)
        same = (greedy[:, args.prompt_len - 1:-1] == ids).float().mean()
        line = (f"{label} serve {arch}: teacher-forced decode vs forward in "
                f"{c.dtype} over the served {max_len} tokens (prompt + "
                f"generated) at B={args.batch}, same weights, max_len "
                f"{max_len}: max_abs_err {err:.4e} (prompt positions "
                f"{errs[:args.prompt_len].max().item():.4e}, generated "
                f"{errs[args.prompt_len:].max().item():.4e}), max |logits| "
                f"{scale:.3f}, bound {tol:.4e}")
        if no_drop:
            line += (f"; capacity factor {c.moe.capacity_factor:g}, "
                     f"assignments dropped {drops.dropped()} of "
                     f"{drops.assigned}")
            require(drops.dropped() == 0,
                    f"{label}: the no-drop capacity dropped an assignment")
        if c is not gate:
            if no_drop:
                line += routing_split(drops.picks, errs, args.batch)
            # not gated: the served dtype's forward disagrees with itself
            # by more than the bound when only the batch changes
            with torch.inference_mode():
                one, _ = transformer.forward(params, {"tokens": toks[:1], **{
                    k: v[:1] for k, v in stubs.items()}}, c)
            spread = (one[0, :, :c.vocab].float()
                      - full[0].float()).abs().max().item()
            print(f"{line}, not gated; forward of row 0 alone against its "
                  f"row at B={args.batch}: max_abs_err {spread:.4e}; served "
                  f"ids equal to this decode's argmax: {same:.4f}",
                  flush=True)
            del one
            continue
        print(f"{line} {'ok' if err < tol else 'FAIL'}; served ids equal to "
              f"this decode's argmax: {same:.4f}", flush=True)
        require(math.isfinite(err) and err < tol,
                f"{label}: decode disagrees with forward")
        gated = (c, err, tol)
    del full, greedy
    if stubs:
        cross_matters(label, params, *gated, toks, stubs)
    checked_peak = torch.cuda.max_memory_allocated()
    print(f"{label} serve {arch}: peak memory of the teacher-forced passes "
          f"{checked_peak / 2**30:.2f} GiB ({checked_peak / 1e9:.2f} GB)",
          flush=True)
    if no_drop:
        with counted_drops() as fwd_drops, torch.inference_mode():
            transformer.forward(params, {"tokens": toks}, cfg)
        cap = moe_split(cfg, args.batch * max_len)[2]
        print(f"{label} serve {arch}: at the served capacity factor "
              f"{cfg.moe.capacity_factor:g}, decode dropped "
              f"{served_drops.dropped()} of {served_drops.assigned} routed "
              f"assignments over its {max_len} steps (C = "
              f"{moe_split(cfg, args.batch)[2]} a step, one group of "
              f"{args.batch} tokens) and forward over the same tokens "
              f"{fwd_drops.dropped()} of {fwd_drops.assigned} (C = {cap})",
              flush=True)
        check_drops(f"{label} decode", served_drops)
        check_drops(f"{label} forward", fwd_drops)

    # the host's share of a token step: time to enqueue one step with the
    # device idle, against the same step synchronised (a gap near 0 means
    # the device waited on the host), then the device time of 4 steps; at
    # the serving shape (B = 8, max_len 256) from position 128
    state["pos"].fill_(args.prompt_len)
    tok = toks[:, args.prompt_len]

    def step():
        nonlocal state
        _, state = transformer.serve_step(params, state, tok, cfg)

    for _ in range(2):
        step()
    enq, synced = [], []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append((t1 - t0) * 1e3)
        synced.append((time.perf_counter() - t0) * 1e3)
    print(f"{label} serve {arch}: host enqueue of one decode step "
          f"{statistics.median(enq):.3f} ms, synchronised "
          f"{statistics.median(synced):.3f} ms (medians of 8; enqueue "
          f"{min(enq):.3f}-{max(enq):.3f}, synchronised "
          f"{min(synced):.3f}-{max(synced):.3f})", flush=True)
    prof, wall_ms = profiled(step, n=4)
    report_profile(f"{label} serve {arch}: profile of 4 decode steps", prof,
                   wall_ms)
    del params, state


def gate_leaves(tree) -> list:
    """Every ``gate`` leaf (an ``xattn`` layer's tanh gate) of a weight
    tree."""
    found = []
    for key, sub in tree.items():
        if key == "gate":
            found.append(sub)
        elif isinstance(sub, dict):
            found += gate_leaves(sub)
    return found


def set_gates(tree, value: float) -> None:
    """Sets every gate leaf of a weight tree, numpy or torch, to ``value``
    in place."""
    import torch
    for g in gate_leaves(tree):
        if isinstance(g, torch.Tensor):
            with torch.no_grad():
                g.fill_(value)
        else:
            g[...] = value


@contextlib.contextmanager
def gates_at(serve, value: float):
    """Inside the block, ``serve.run`` serves weights whose ``xattn`` gates
    are at ``value`` (the reference draws them at 0); nothing at 0."""
    real = serve.init_params

    def init_params(gen, cfg):
        params = real(gen, cfg)
        set_gates(params, value)
        return params

    if value:
        serve.init_params = init_params
    try:
        yield
    finally:
        serve.init_params = real


def stub_tensors(cfg, b: int, seed: int) -> dict:
    """The arch's frames or patch embeddings for a batch of ``b`` rows on the
    card: 0.1·N(0, 1) in ``cfg.dtype``, from a seeded generator."""
    import torch
    from repro_torch.configs.shapes import stub_inputs
    from repro_torch.models.layers import dtype_of
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {name: torch.randn(shape, device="cuda", generator=gen).mul_(0.1)
            .to(dtype_of(dtype))
            for name, (shape, dtype) in stub_inputs(cfg, b).items()}


def cross_matters(label: str, params, cfg, err: float, tol: float, toks,
                  stubs) -> None:
    """Phases 11c and 11d: the teacher-forced check sees the
    cross-attention. ``forward`` over the served tokens in ``cfg`` (the
    gated check's: its error ``err``, its bound ``tol``) moves by more than
    10x that error under another draw of the frames or patch embeddings,
    so a decode that lost its cross K/V would fail the check; the move is
    printed against 10x the bound too. With every gate at 0 (the
    reference's init) another draw leaves the logits bit-equal."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.layers import dtype_of
    stubs = {k: v.to(dtype_of(cfg.dtype)) for k, v in stubs.items()}
    other = stub_tensors(cfg, toks.shape[0], seed=7)

    def moved():
        with torch.inference_mode():
            a, b = (transformer.forward(params, {"tokens": toks, **st}, cfg)[0]
                    [..., :cfg.vocab].float() for st in (stubs, other))
        return (a - b).abs().max().item()

    names = ", ".join(stubs)
    by = moved()
    print(f"{label} {cfg.name}: another draw of {names} moves the "
          f"{cfg.dtype} logits over the served tokens by {by:.4e}: 10x the "
          f"teacher-forced error is {10 * err:.4e}, 10x its bound "
          f"{10 * tol:.4e}", flush=True)
    require(by > 10 * err, f"{label}: the {names} move the logits by less "
            "than 10x the teacher-forced error")
    gates = gate_leaves(params)
    if gates:
        kept = [g.detach().clone() for g in gates]
        set_gates(params, 0.0)
        try:
            still = moved()
        finally:
            with torch.no_grad():
                for g, k in zip(gates, kept):
                    g.copy_(k)
        print(f"{label} {cfg.name}: with the {len(gates)} gate leaves at 0 "
              f"another draw moves them by {still:.4e}", flush=True)
        require(still == 0.0, f"{label}: the {names} reach the logits "
                "through a zero gate")


class DropCount:
    """Routed MoE assignments and the slots they got, summed on the device
    over every ``moe.assign_slots`` call inside ``counted_drops``, and each
    call's picked experts (n, G, k) in call order."""

    def __init__(self):
        self.assigned = 0
        self.kept = 0
        self.picks = []

    def dropped(self) -> int:
        return self.assigned - int(self.kept)


@contextlib.contextmanager
def counted_drops():
    """Counts, without a host sync, the routed assignments of every MoE
    layer called inside the block and those dropped for want of a slot."""
    from repro_torch.models import moe
    real, tally = moe.assign_slots, DropCount()

    def assign_slots(gate_idx, gate_vals, num_experts, cap):
        dispatch, combine = real(gate_idx, gate_vals, num_experts, cap)
        tally.assigned += gate_idx.numel()
        tally.kept = tally.kept + dispatch.detach().sum()
        tally.picks.append(gate_idx.detach())
        return dispatch, combine

    moe.assign_slots = assign_slots
    try:
        yield tally
    finally:
        moe.assign_slots = real


def routing_split(picks, errs, b: int) -> str:
    """Where ``teacher_forced``'s decode routed a token to other experts
    than its ``forward`` did, and its error split by that: ``picks`` holds
    the forward's calls, one a layer, then decode's, one a layer and step;
    ``errs`` the max error at each position."""
    import torch
    t = errs.numel()
    layers = len(picks) // (t + 1)
    require(len(picks) == layers * (t + 1), "routing calls do not add up")
    fwd = torch.stack([p.reshape(b, t, -1) for p in picks[:layers]])
    dec = torch.stack(picks[layers:]).reshape(t, layers, b, -1)
    dec = dec.permute(1, 2, 0, 3)                       # (layers, B, T, k)
    moved = (fwd.sort(-1).values != dec.sort(-1).values).any(-1)
    at = moved.any(1).any(0).cpu()                      # (T,)
    same = errs[~at].max().item() if (~at).any() else 0.0
    other = errs[at].max().item() if at.any() else 0.0
    return (f"; routed to other experts than the forward's at "
            f"{int(moved.sum())} of {moved.numel()} (layer, token) pairs, "
            f"in {int(at.sum())} of {t} positions: max_abs_err where none "
            f"moved {same:.4e}, where one did {other:.4e}")


def moe_split(cfg, tokens: int):
    """(groups n, tokens a group G, capacity C) of an MoE call on
    ``tokens`` tokens, as ``moe.apply_moe`` splits them."""
    from repro_torch.models.moe import capacity, group_split
    n, g = group_split(tokens, cfg.moe.group_size)
    return n, g, capacity(cfg, g)


def moe_layer_flops(cfg, b: int, s: int) -> dict:
    """Forward FLOPs of one ``moe`` block at B x S, by product (the dense
    dispatch and combine as the reference computes them)."""
    t, d, e = b * s, cfg.d_model, cfg.moe.num_experts
    n, g, c = moe_split(cfg, t)
    f, hd = cfg.d_expert_eff, cfg.head_dim
    slots = n * g * e * c
    n_slots = n * e * c
    return {
        "attention projections": 2 * t * d * hd * (2 * cfg.n_heads
                                                   + 2 * cfg.n_kv),
        "attention scores and values": 4 * b * cfg.n_heads * hd
        * attention_pairs(s, s, True, 0),
        "router": 2 * t * d * e,
        "dispatch": 2 * slots * d,
        "experts": 3 * 2 * n_slots * d * f,
        "combine": 2 * slots * d,
        "shared experts": 3 * 2 * t * d * f * cfg.moe.num_shared,
        "dense residual FFN": 3 * 2 * t * d * cfg.dense_residual_ff,
    }


def moe_train_phase(counters) -> dict:
    """Phases 10b and 10c: deepseek-moe-16b at full width, 4 layers,
    through ``train.run`` (launch counts set to 0 just before and read just
    after; routed assignments and drops counted), the step-1 loss terms at
    the seeded init, then a profile of one more step and the step's FLOPs
    on fake tensors. Returns the 10b path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.flop_count import (H100_SXM, count_train_flops,
                                             model_flops_train)
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import active_param_count, transformer
    label = f"10b {DEEPSEEK}"
    args = train.build_argparser().parse_args(DEEPSEEK_ARGV)
    cfg = get_config(args.arch, smoke=args.smoke).replace(
        n_layers=args.layers, use_flash_kernel=True)

    # the loss terms of step 1: the run's seeded init and first batch
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg)
    batch = {k: v.cuda() for k, v in SyntheticLM(
        cfg, args.batch, args.seq, seed=args.seed).next_batch().items()}
    with torch.no_grad():
        loss, metrics = transformer.loss_fn(params, batch, cfg)
    first = {"loss": loss.item(), **{k: v.item() for k, v in metrics.items()}}
    del params, batch, loss, metrics
    torch.cuda.empty_cache()

    with counted_drops() as drops:
        path = drive(label, DEEPSEEK_ARGV, counters, keep=True)
    launches, per_step = path["launches"], path["per_step"]
    _, group, cap = moe_split(cfg, args.batch * args.seq)
    share = drops.dropped() / drops.assigned
    print(f"{label}: step-1 loss terms at the seeded init: ce "
          f"{first['ce']:.6f}, aux_loss {first['aux_loss']:.6f}, z_loss "
          f"{first['z_loss']:.6f}; their sum {first['loss']:.6f} against "
          f"the run's step-1 loss {path['losses'][0]:.6f}", flush=True)
    print(f"{label}: routed assignments over the {path['steps']} steps "
          f"(forward and remat recompute) {drops.assigned}, dropped "
          f"{drops.dropped()} ({share:.4f}) at C = {cap} (G = {group}, k = "
          f"{cfg.moe.top_k}, E = {cfg.moe.num_experts}, capacity factor "
          f"{cfg.moe.capacity_factor:g}); peak {path['peak'] / 1e9:.2f} GB "
          f"(limit {PEAK_LIMIT / 1e9:g})", flush=True)
    require(launches["flash_attention"] == per_step["attn"] * path["steps"]
            and launches["rglru_scan"] == 0,
            f"{label}: the flash launch count is off")
    require(path["peak"] < PEAK_LIMIT, f"{label}: peak over the limit")
    require(abs(first["loss"] - path["losses"][0]) <= STEP1_TOL,
            f"{label}: the step-1 loss terms do not sum to the step-1 loss")
    # every MoE call of every step routed B·S·k assignments (forward and
    # remat recompute); the drops are held to the recorded count. Most
    # are dropped: at the seeded init the attention output (``wo``'s
    # fan-in is the head count, as in the reference) outweighs the
    # residual, and most tokens of a group pick the same few experts
    calls = cfg.n_layers * (2 if cfg.remat else 1) * path["steps"]
    require(drops.assigned == calls * args.batch * args.seq * cfg.moe.top_k,
            f"{label}: the routed assignments do not add up")
    check_drops("10b", drops)
    check_step1("10b ", DEEPSEEK, path["losses"][0])

    # 10c: one more step of the same run, profiled; the step's FLOPs
    result = path.pop("result")
    busy, kernels = profile_step(path, result)
    del result
    torch.cuda.empty_cache()
    tokens = args.batch * args.seq
    counted = count_train_flops(cfg, args.batch, args.seq)
    model = model_flops_train(cfg, tokens)
    layer = moe_layer_flops(cfg, args.batch, args.seq)
    routed = layer["dispatch"] + layer["combine"]
    steady = path["steady_ms"] / 1e3
    print(f"10c {DEEPSEEK}: device busy {busy:.1f} ms in {kernels} kernels "
          f"against the unprofiled {path['steady_ms']:.1f} ms a step "
          f"({1 - busy / path['steady_ms']:.3f} idle); FLOPs of one step "
          f"(FlopCounterMode on fake tensors) {counted:.6e}, 6·N_active·D "
          f"{model:.6e} (N_active = {active_param_count(cfg)}), ratio "
          f"{counted / model:.4f}; utilization {counted / steady / H100_SXM.peak_flops:.4f}"
          f" of the bf16 peak at the 10b step", flush=True)
    print(f"10c {DEEPSEEK}: forward FLOPs of one layer by product: "
          + ", ".join(f"{k} {v:.4e}" for k, v in layer.items() if v)
          + f"; the dense dispatch and combine {routed / sum(layer.values()):.4f}"
          " of it", flush=True)
    require(counted > model, "10c: the counted step has fewer FLOPs than "
            "6·N_active·D")
    return path


def whisper_train_phase(counters) -> dict:
    """Phase 11b: whisper-small at full width and depth through
    ``train.run`` (launch counts set to 0 just before and read just after),
    then a profile of one more step of that run and the step's FLOPs on
    fake tensors, beside 6·N·D over the decoder's tokens and beside the
    same with the encoder's parameters over its frames. Returns the path."""
    import torch
    from repro_torch.core.flop_count import (H100_SXM, count_train_flops,
                                             model_flops_train)
    from repro_torch.models.transformer import param_count_cfg, param_shapes
    from repro_torch.tree import leaves
    label = f"11b {WHISPER}"
    path = drive(label, WHISPER_ARGV, counters, keep=True)
    cfg, args = path["config"], path["args"]
    launches, per_step = path["launches"], path["per_step"]
    tokens = args.batch * args.seq
    print(f"{label}: {cfg.encoder_layers} encoder + {cfg.n_layers} decoder "
          f"layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.head_dim}, frames ({args.batch}, {cfg.encoder_len}, "
          f"{cfg.d_model}); ms a step {path['steady_ms']:.1f} (median of "
          f"steps 2-5), decoder tokens/s "
          f"{tokens / path['steady_ms'] * 1e3:.1f}, peak "
          f"{path['peak'] / 1e9:.2f} GB (limit {PEAK_LIMIT / 1e9:g}), "
          f"step-1 loss {path['losses'][0]:.4f}", flush=True)
    require(launches["flash_attention"] == per_step["attn"] * path["steps"]
            and launches["rglru_scan"] == 0,
            f"{label}: the flash launch count is off")
    require(path["peak"] < PEAK_LIMIT, f"{label}: peak over the limit")
    check_step1("11b ", WHISPER, path["losses"][0])

    # one more step of the same run, profiled; the step's FLOPs
    result = path.pop("result")
    busy, kernels = profile_step(path, result)
    del result
    torch.cuda.empty_cache()
    counted = count_train_flops(cfg, args.batch, args.seq)
    model = model_flops_train(cfg, tokens)
    # the parameters of matrix products: the token embedding and both
    # position tables are lookups
    shapes = param_shapes(cfg)
    n_enc = sum(math.prod(x) for x in leaves(shapes["encoder"])) \
        - math.prod(shapes["encoder"]["pos"])
    n_dec = param_count_cfg(cfg) - n_enc - math.prod(shapes["embed"]) \
        - math.prod(shapes["pos_embed"]) - math.prod(shapes["encoder"]["pos"])
    frames = args.batch * cfg.encoder_len
    split = 6 * n_dec * tokens + 6 * n_enc * frames
    steady = path["steady_ms"] / 1e3
    print(f"{label}: device busy {busy:.1f} ms in {kernels} kernels against "
          f"the unprofiled {path['steady_ms']:.1f} ms a step "
          f"({1 - busy / path['steady_ms']:.3f} idle); FLOPs of one step "
          f"(FlopCounterMode on fake tensors, the frames included) "
          f"{counted:.6e}; 6·N·D over the {tokens} decoder tokens "
          f"{model:.6e} (ratio {counted / model:.4f}); 6·N·D over the "
          f"parameters of matrix products, the encoder's {n_enc} over its "
          f"{frames} frames and the decoder's {n_dec} over the tokens, "
          f"{split:.6e} (ratio "
          f"{counted / split:.4f}): the encoder's share is counted over "
          f"{cfg.encoder_len} frames a row, not S = {args.seq} tokens; "
          f"utilization {counted / steady / H100_SXM.peak_flops:.4f} of the "
          f"bf16 peak", flush=True)
    require(counted > split, f"{label}: the counted step has fewer FLOPs "
            "than 6·N·D of its matrix products over the frames and tokens")
    return path


def prefill_phase(counters, label: str = "7c", arch: str = "gemma-7b",
                  layers: int = 0) -> int:
    """Phases 7c and 11e: an arch's prefill at ``prefill_32k`` (B = 1 a
    card) through ``make_prefill_step``, the flash kernel on, with its
    patch embeddings where it has them and its gates at ``SERVE_GATE``;
    ``layers`` cuts the depth. Returns the flash launches of the 3 timed
    runs."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer
    seq = SHAPES["prefill_32k"].seq_len
    cfg = get_config(arch).replace(use_flash_kernel=True)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    name = f"{label} prefill {arch}"
    torch.cuda.empty_cache()
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    set_gates(params, SERVE_GATE)
    batch = {k: v.cuda() for k, v in SyntheticLM(
        cfg, 1, seq, seed=0).next_batch().items() if k != "labels"}
    step = make_prefill_step(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    logits = step(params, batch)                 # warm-up
    torch.cuda.synchronize()
    del logits
    for c in counters.values():
        c.launches = 0
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        logits = step(params, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if len(ms) < 3:
            del logits
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    real = logits[..., :cfg.vocab]        # a padded tail holds -finfo.max/2
    lo, hi = real.amin().float().item(), real.amax().float().item()
    del real
    shape = tuple(logits.shape)
    del logits
    prof, wall_ms = profiled(lambda: step(params, batch))
    report_profile(f"{name}: profile of one prefill", prof, wall_ms)
    del params, batch
    n_attn = sum(k == "attn" for k in cfg.pattern) * cfg.n_groups
    n_x = sum(k == "xattn" for k in cfg.pattern) * cfg.n_groups
    t = cfg.cross_len
    # 2·N·S over the parameters of the matrix products (an untied
    # embedding is a lookup), the cross-attention's K and V over the T
    # patches, not the S tokens; then the self- and cross-attention
    xkv = n_x * 2 * cfg.d_model * cfg.n_kv * cfg.head_dim
    n_mm = transformer.param_count_cfg(cfg) - xkv - (
        0 if cfg.tie_embeddings else cfg.padded_vocab * cfg.d_model)
    flops = 2 * n_mm * seq + 2 * xkv * t \
        + 4 * cfg.n_heads * cfg.head_dim * (
            n_attn * attention_pairs(seq, seq, True, 0) + n_x * seq * t)
    med = statistics.median(ms)
    bound_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    print(f"{name}: layers {cfg.n_layers}, B=1, S={seq}, "
          f"bf16, flash kernel on: ms " + " / ".join(f"{x:.1f}" for x in ms)
          + f" (median {med:.1f}); tokens/s {seq / med * 1e3:.1f}; model "
          f"FLOPs {flops:.4e} (2·N·S + attention), {flops / med / 1e9:.1f} "
          f"TFLOP/s, bound {bound_ms:.1f} ms ({bound_ms / med:.3f} of it "
          f"reached); peak memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} "
          f"GB); launches " + ", ".join(f"{k} {n}" for k, n in
                                        launches.items())
          + f" ({launches['flash_attention'] / 3:g} a prefill, expected "
          f"{n_attn}); logits {shape} in [{lo:.3f}, {hi:.3f}]", flush=True)
    require(launches["flash_attention"] == 3 * n_attn,
            f"{label}: the prefill did not launch the flash kernel once an "
            "attention layer")
    require(shape == (1, seq, cfg.padded_vocab) and math.isfinite(lo)
            and math.isfinite(hi), f"{label}: prefill logits not finite")
    require(peak < PEAK_LIMIT, f"{label}: peak over the limit")
    return launches["flash_attention"]


def predict_phase(gemma: dict, counters) -> dict:
    """Phases 6a-6c: count, calibrate, predict (see the module docstring);
    returns the 2-layer path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import gpu_adapter as ga
    from repro_torch.core.flop_count import (H100_SXM, count_step_flops,
                                             count_train_flops,
                                             model_flops_train)
    from repro_torch.launch import whatif
    from repro_torch.models import transformer
    from repro_torch.tree import tree_map
    peak = H100_SXM.peak_flops

    def step_flops(cfg, params, batch):
        """FLOPs of one AdamW step of ``cfg`` (it updates ``params``)."""
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim import make_optimizer
        opt = make_optimizer("adamw", lr=3e-4)
        return count_step_flops(make_train_step(cfg, opt), params,
                                opt.init(params), batch)

    def copy(tree, device):
        return tree_map(lambda x: x.detach().to(device, copy=True)
                        .requires_grad_(x.requires_grad), tree)

    def path_batch(cfg, batch, seq, seed):
        from repro_torch.data import SyntheticLM
        data = SyntheticLM(cfg, batch, seq, seed=seed)
        return {k: v.cuda() for k, v in data.next_batch().items()}

    # 6a: the flash kernel's products are counted on the card
    cfg = get_config("gemma-7b", smoke=True).replace(
        remat=True, head_dim=256, dtype="bfloat16", use_flash_kernel=True)
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg)
    batch = path_batch(cfg, 2, 256, 2)
    n_attn = cfg.n_layers
    before = counters["flash_attention"].launches
    on_card = step_flops(cfg, copy(params, "cuda"), batch)
    require(counters["flash_attention"].launches == before + 2 * n_attn,
            "the counted smoke step did not run the flash kernel")
    on_cpu = step_flops(cfg, copy(params, "cpu"), copy(batch, "cpu"))
    off_card = step_flops(cfg.replace(use_flash_kernel=False),
                          copy(params, "cuda"), batch)
    # the kernel-off path computes the same products except the plain
    # VJP's recomputed forward (two products a layer, 2·B·H·S·T·D each)
    vjp = n_attn * 2 * (2 * 2 * cfg.n_heads * 256 * 256 * cfg.head_dim)
    print(f"6a FLOPs of one gemma smoke step (bf16, head_dim 256, S=256, "
          f"remat): kernel on, card {on_card:.6e}; kernel on, CPU (plain "
          f"version) {on_cpu:.6e}; kernel off, card {off_card:.6e} "
          f"(+ {vjp:.6e} of the plain VJP's recomputed forward = "
          f"{off_card + vjp:.6e})", flush=True)
    require(abs(on_card - on_cpu) <= 1e-9 * on_cpu,
            "the card's FLOP count differs from the CPU's")
    require(off_card + vjp == on_card,
            "the kernel-off count differs by more than the VJP's forward")
    del params, batch

    def count_path(cfg):
        torch.cuda.empty_cache()
        params = transformer.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg)
        flops = step_flops(cfg, params, path_batch(cfg, 2, 2048, 0))
        del params
        torch.cuda.empty_cache()
        return flops

    cfg4 = gemma["config"]
    f4 = count_path(cfg4)
    tokens = gemma["args"].batch * gemma["args"].seq
    mf4 = model_flops_train(cfg4, tokens)
    print(f"6a FLOPs of one gemma-7b step at full width, {cfg4.n_layers} "
          f"layers, kernel on: {f4:.6e}; 6·N·D {mf4:.6e} "
          f"(N = {transformer.active_param_count(cfg4)}); ratio "
          f"{f4 / mf4:.4f}", flush=True)
    require(f4 > mf4, "the counted step has fewer FLOPs than 6·N·D")

    # 6b: calibrate on the 4-layer step, predict it and a 2-layer step
    t4 = gemma["steady_ms"] / 1e3
    util = f4 / (t4 * peak)
    one_gpu = ga.MeshFactors(data=1, model=1, pods=1, mfu=util)

    def dag_flops(cfg, mesh, n_tokens):
        """The FLOPs the uncalibrated DAG gives its tensor-core segments."""
        dag = ga.build_step_dag(cfg, mesh, n_tokens)
        return sum(o.duration for o in dag.ops if o.res == "tensor") \
            * peak * mesh.mfu

    def predict(cfg, flops):
        dag = ga.build_step_dag(cfg, one_gpu, tokens)
        return ga.predict_step_time(ga.calibrate(dag, flops, mfu=util))

    p4 = predict(cfg4, f4)
    print(f"6b utilization of the {cfg4.n_layers}-layer step: {util:.4f} "
          f"({f4:.4e} FLOPs in {t4 * 1e3:.1f} ms at {peak:.4g} FLOP/s; "
          f"the uncalibrated DAG gives its segments "
          f"{dag_flops(cfg4, one_gpu, tokens):.4e}); predicted "
          f"{p4 * 1e3:.1f} ms vs measured {t4 * 1e3:.1f} ms (error "
          f"{p4 / t4 - 1:+.4f})", flush=True)
    cfg2 = cfg4.replace(n_layers=2)
    f2 = count_path(cfg2)
    argv2 = [*GEMMA_ARGV]
    argv2[argv2.index("--layers") + 1] = "2"
    two = drive("gemma-7b-2l", argv2, counters)
    require(two["launches"]["flash_attention"]
            == two["per_step"]["attn"] * two["steps"],
            "flash kernel launch count is off on the 2-layer path")
    t2 = two["steady_ms"] / 1e3
    p2 = predict(cfg2, f2)
    print(f"6b gemma-7b 2 layers: {f2:.4e} FLOPs; predicted from the "
          f"{cfg4.n_layers}-layer utilization {p2 * 1e3:.1f} ms vs measured "
          f"{t2 * 1e3:.1f} ms (error {p2 / t2 - 1:+.4f})", flush=True)
    for label, p, t in (("4-layer", p4, t4), ("2-layer", p2, t2)):
        require(math.isfinite(p) and p > 0 and 0.5 <= p / t <= 2.0,
                f"the {label} prediction is not within 2x of its step")

    # 6c: full gemma-7b over nodes of 8 GPUs (the DES runs take about a
    # second, so in this process: no worker processes to start or stop).
    # The utilization was taken against the counted FLOPs (head, remat
    # recompute, attention), the DAG's segments hold only 6·P_layer·D: the
    # what-if gets the utilization times the DAG's share of the 28-layer
    # step's count (on fake tensors; FLOPs are linear in B at a fixed S)
    os.environ["REPRO_SWEEP_SERIAL"] = "1"
    wins = (64e6, 16e6, 4e6)
    sp = whatif.SHAPES["train_4k"]
    cfg28 = cfg4.replace(n_layers=get_config("gemma-7b").n_layers)
    counted28 = count_train_flops(cfg28, 1, sp.seq_len)
    ratio = counted28 / dag_flops(cfg28, one_gpu, sp.seq_len)
    mfu28 = util / ratio
    print(f"6c gemma-7b, 28 layers, one sequence of train_4k (S = "
          f"{sp.seq_len}) counted on fake tensors: {counted28:.6e} FLOPs "
          f"against the DAG's {counted28 / ratio:.6e}: ratio {ratio:.4f}; "
          f"the what-if's mfu {util:.4f} / {ratio:.4f} = {mfu28:.4f}",
          flush=True)
    rows = whatif.node_table("gemma-7b", "train_4k", [1, 2, 4],
                             gpus_per_node=8, straggler=1.3, compress=0.25,
                             wins=wins, mfu=mfu28)
    tokens28 = sp.seq_len * sp.global_batch
    print(f"6c gemma-7b, 28 layers, train_4k, 8 GPUs a node, mfu "
          f"{mfu28:.4f} (the DAG gives a GPU "
          f"{dag_flops(cfg28, ga.MeshFactors(mfu=mfu28), tokens28):.4e} "
          f"FLOPs a step; 6·N·D / 8 is "
          f"{model_flops_train(cfg28, tokens28) / 8:.4e}):\n"
          + whatif.format_table(rows, 1.3, 0.25, wins), flush=True)
    steps = [r[2] for r in rows]
    require(all(math.isfinite(t) and t > 0 for t in steps),
            "a what-if step is not finite and positive")
    require(steps[0] > steps[1] > steps[2],
            "more nodes did not give a shorter step")
    require(all(r[4] >= r[2] for r in rows),
            "the straggler column is shorter than the step")
    require(all(r[5] <= r[2] for r in rows),
            "compression lengthened the step")
    return two


def waterfill_phase() -> None:
    """Phase 6d: the torch waterfill backend on the card against numpy."""
    import random

    import numpy as np
    from repro_torch.core.bandwidth import (BandwidthModel,
                                            GroupedBandwidthModel,
                                            batched_waterfill,
                                            stack_waterfill_problems)
    links = [f"{d}:{p}" for d in ("downlink", "uplink") for p in range(2)]
    models = [
        (BandwidthModel(), [(w, r) for w in range(6) for r in links]),
        (GroupedBandwidthModel(
            link_caps={"downlink:0": 2.0, "uplink:1": 0.5},
            worker_caps={0: 0.5, 3: 2.0},
            extra_groups=[
                ("fabric", 1.5, frozenset({"downlink:0", "downlink:1"})),
                ("pair", 0.8, frozenset({(1, "uplink:0"),
                                         (2, "uplink:0")}))]),
         [(w, r) for w in range(5) for r in links])]
    rng = random.Random(0)
    problems = []
    for model, universe in models:
        for _ in range(4096):
            conns = sorted(rng.sample(universe,
                                      rng.randrange(1, len(universe) + 1)))
            problems.append((conns, *model.groups_for(conns)))
    _, caps, members, weights = stack_waterfill_problems(problems)
    t0 = time.perf_counter()
    want = batched_waterfill(caps, members, weights)
    np_ms = (time.perf_counter() - t0) * 1e3
    batched_waterfill(caps, members, weights, backend="torch")   # warm-up
    t0 = time.perf_counter()
    got = batched_waterfill(caps, members, weights, backend="torch")
    torch_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(got - want).max())
    ok = bool(np.allclose(got, want, rtol=2e-4, atol=1e-12))
    print(f"6d waterfill over {len(problems)} problems {tuple(members.shape)}"
          f": torch on the card {torch_ms:.2f} ms (host clock, copies "
          f"included), numpy {np_ms:.2f} ms; max_abs_err {err:.3e} (rtol "
          f"2e-4) {'ok' if ok else 'FAIL'}", flush=True)
    require(ok, "the torch waterfill disagrees with numpy")


def print_ptxas(log: str) -> None:
    """Registers and spills of each kernel instantiation, from -Xptxas=-v;
    a spill fails. The tensor-core kernel's count is its count at entry:
    setmaxnreg then gives its consumer warpgroups 240 and its producer 24."""
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?((attn_fwd_tc|attn_fwd|"
                      r"rglru_scan_kernel)I\w+?)EEv", line)
        if m:
            name = m[1]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            print(f"  ptxas: {name}: {m[1]} registers")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and (m[1], m[2]) != ("0", "0"):
            print(f"  ptxas: {name}: {line.strip()}")
            raise SmokeFailure(f"{name} spills registers")


def check_hgmma(lib: Path) -> None:
    """Counts HGMMA (wgmma) instructions in the SASS of each instantiation
    of the bf16 flash kernel; fails if one has none. Skipped, and said so,
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("sass: cuobjdump not found, HGMMA not checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\w*?(attn_fwd_tcI\w+?)EEv", part)
        if m:
            counts[m[1]] = part.count("HGMMA")
    print("sass: HGMMA instructions in " + ", ".join(
        f"{name} {n}" for name, n in sorted(counts.items())))
    require(len(counts) == 6 and all(counts.values()),
            "the bf16 flash kernel has no wgmma (HGMMA) in its SASS")


def model_on_off(arch: str, **overrides) -> None:
    """The smoke model on the card with its kernels on and off (S = 256,
    remat on, an encoder arch's frames given): loss and every gradient
    agree.

    In fp32 (the default) both sides do the same arithmetic up to the order
    of sums: loss within 1e-5 relative, gradients within 1e-4. In bf16 the
    tensor-core kernel rounds P to bf16 before P V where the plain path
    keeps it in fp32 (up to 2^-9 relative in each term), and the two paths
    round the attention's output and its neighbours at other places: two
    plain bf16 paths of this model that differ only so already give
    gradients about 1e-2 apart in relative Frobenius norm. So in bf16 the
    loss agrees within 2e-3 relative and each gradient within 5e-2 of its
    own norm; a wrong kernel is off by order 1."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.tree import leaves
    cfg = get_config(arch, smoke=True).replace(remat=True, **overrides)
    params = transformer.init_params(
        torch.Generator(device="cuda").manual_seed(1), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 257), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             **stub_tensors(cfg, 2, seed=3)}
    res = {}
    for flag in (True, False):
        c = cfg.replace(use_flash_kernel=flag)
        loss, _ = transformer.loss_fn(params, batch, c)
        res[flag] = (loss.item(), torch.autograd.grad(loss,
                                                      list(leaves(params))))
    lerr = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    if cfg.dtype == "float32":
        ltol, gtol, what = 1e-5, 1e-4, "max_abs_err"
        gerr = max((a - b).abs().max().item()
                   for a, b in zip(res[True][1], res[False][1]))
    else:
        ltol, gtol, what = 2e-3, 5e-2, "max relative Frobenius error"
        gerr = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                   for a, b in zip(res[True][1], res[False][1]))
    print(f"model ({arch} smoke {overrides or ''}, {cfg.dtype}, S=256) "
          f"kernels on vs off: loss {res[True][0]:.6f} vs "
          f"{res[False][0]:.6f} (rel {lerr:.2e}, tol {ltol}), grads {what} "
          f"{gerr:.2e} (tol {gtol})", flush=True)
    require(lerr <= ltol and gerr <= gtol, f"{arch}: kernel path disagrees")


def drive(label: str, argv, counters, keep: bool = False) -> dict:
    """One training path through ``train.run`` with the kernels on; every
    launch count is set to 0 just before and read just after. With
    ``keep`` the returned dict holds ``run``'s result (its weights and
    optimizer state stay on the card until the caller drops it)."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import active_param_count
    args = train.build_argparser().parse_args(argv)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for c in counters.values():
        c.launches = 0
    result = train.run(args, use_flash_kernel=True)
    launches = {k: c.launches for k, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg = result["config"]
    kinds = [k for _ in range(cfg.n_groups) for k in cfg.pattern] \
        + list(cfg.tail_pattern)
    in_groups = cfg.n_groups * len(cfg.pattern)

    def calls(kind_set, backward: int) -> int:
        """Kernel calls a step: forward, remat recompute inside the
        groups, and ``backward`` per layer."""
        n = sum(k in kind_set for k in kinds)
        recompute = sum(k in kind_set for k in kinds[:in_groups]) \
            if cfg.remat else 0
        return n + recompute + backward * n
    # flash attention: forward only (the VJP is the plain reference), and
    # only where there is no window; rglru_scan: forward and adjoint
    # (an ``moe`` or ``encdec`` block's self-attention is the same
    # attention block)
    per_step = {"attn": calls({"attn", "moe", "encdec"}, 0),
                "rglru": calls({"rglru"}, 1)}
    step_ms = [1e3 * s for s in result["step_seconds"]]
    steady = statistics.median(step_ms[1:]) if len(step_ms) > 1 else step_ms[0]
    tokens = args.batch * args.seq
    # model FLOPs of a step: 6 N T for the parameter matmuls (N the active
    # parameters, the tied head included) plus forward + backward attention;
    # remat recompute excluded
    n_params = result["param_count"]
    attn = 0
    for kind in kinds:
        if kind in ("attn", "local", "moe", "encdec"):
            w = cfg.window if kind == "local" else 0
            attn += 3 * 4 * args.batch * cfg.n_heads * cfg.head_dim \
                * attention_pairs(args.seq, args.seq, True, w)
    flops = 6 * active_param_count(cfg) * tokens + attn
    print(f"{label} path: d_model {cfg.d_model} heads {cfg.n_heads}x"
          f"{cfg.head_dim} kv {cfg.n_kv} d_ff {cfg.d_ff} rnn "
          f"{cfg.rnn_width} vocab {cfg.vocab} layers {cfg.n_layers} "
          f"({' '.join(kinds)}) dtype {cfg.dtype} remat {cfg.remat} "
          f"kernels {cfg.use_flash_kernel}")
    print(f"{label} losses: " + " ".join(f"{x:.4f}" for x in result["losses"]))
    print(f"{label} ms/step: " + " ".join(f"{x:.1f}" for x in step_ms)
          + f" (median after the first {steady:.1f})")
    print(f"{label} params {n_params} model FLOPs/step {flops:.4e} "
          f"achieved {flops / steady / 1e9:.1f} TFLOP/s "
          f"({flops / steady / 1e9 / (PEAK_FLOPS['bfloat16'] / 1e12):.3f}"
          f" of the bf16 peak)")
    print(f"{label} tokens/s: {tokens / steady * 1e3:.1f}  peak memory "
          f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)  launches "
          + ", ".join(f"{k} {n}" for k, n in launches.items())
          + f" (expected a step: flash_attention {per_step['attn']}, "
          f"rglru_scan {per_step['rglru']}; x {result['steps']} steps)",
          flush=True)
    require(all(math.isfinite(x) for x in result["losses"]),
            f"non-finite loss on the {label} path")
    path = {"label": label, "argv": list(argv), "args": args, "config": cfg,
            "launches": launches, "per_step": per_step,
            "steps": result["steps"], "losses": result["losses"],
            "steady_ms": steady, "peak": peak}
    if keep:
        path["result"] = result
    return path


def profile_step(path: dict, result: dict = None):
    """Device time of one steady training step of a path, by kernel, and
    the share of the step's host wall time the device was idle (the
    profiler's own host cost makes that share an upper bound). With
    ``result`` (``train.run``'s) the step continues that run, else it
    follows two warm-up steps from a fresh init. Returns the device-busy
    ms and the kernel count of the step."""
    import torch
    from repro_torch.configs import get_optimizer_name
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer

    args, cfg, label = path["args"], path["config"], path["label"]
    torch.cuda.empty_cache()
    opt = make_optimizer(args.optimizer or get_optimizer_name(args.arch),
                         lr=args.lr)
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    if result is None:
        params = init_params(
            torch.Generator(device="cuda").manual_seed(args.seed), cfg)
        state = opt.init(params)
    else:
        params, state = result["params"], result["opt_state"]
    step_fn = make_train_step(cfg, opt)

    def step():
        nonlocal params, state
        batch = {k: x.cuda() for k, x in data.next_batch().items()}
        params, state, metrics = step_fn(params, state, batch)
        return float(metrics["loss"])

    if result is None:          # a fresh init: two warm-up steps first
        for _ in range(2):
            step()
    prof, wall_ms = profiled(step)
    del params, state
    return report_profile(f"{label} profile of one step", prof, wall_ms)


def profiled(fn, n: int = 1):
    """(profile, wall ms) of ``n`` calls of ``fn``, ending in a
    synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    return prof, wall_ms


def report_profile(label: str, prof, wall_ms: float):
    """Device time by kernel group and the top kernels of a profile, and
    the share of the wall time the device was idle (the profiler's own
    host cost makes that share an upper bound). Returns the device-busy ms
    and the kernel count."""
    import torch
    # summed from the profiler's raw events: ``key_averages`` builds a
    # Python object per event, minutes for a step of 10^5-10^6 kernels
    sums = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ms, n = sums.get(e.name(), (0.0, 0))
            sums[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    rows = [(name, ms, n) for name, (ms, n) in sums.items()]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    kernels = sum(r[2] for r in rows)
    require(busy > 0, f"{label}: no device time in the trace")
    print(f"{label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}, "
          f"{kernels} kernels")
    groups = {}
    for name, ms, _ in rows:
        cat = next((c for c, keys in KERNEL_GROUPS if any(
            key in name for key in keys)), "other")
        groups[cat] = groups.get(cat, 0.0) + ms
    print(f"{label} by group: " + ", ".join(
        f"{c} {ms:.1f} ms ({ms / busy:.3f})"
        for c, ms in sorted(groups.items(), key=lambda kv: -kv[1])))
    for name, ms, n in rows[:15]:
        print(f"  {ms:9.2f} ms {n:5d}x  {name[:110]}", flush=True)
    return busy, kernels


def mesh_phase(gemma: dict, restart: dict, counters) -> int:
    """Phase 12 on an NCCL process group of world size 1 and a (1, 1)
    mesh on the card; returns 12a's flash launches. The group is destroyed
    and the phase's files removed at the end, passed or failed."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import make_debug_mesh
    shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    PHASE12_DIR.mkdir(parents=True)
    dist.init_process_group(
        "nccl", init_method=f"file://{PHASE12_DIR / 'store'}", rank=0,
        world_size=1)
    try:
        mesh = make_debug_mesh((1, 1))
        print(f"12 mesh {mesh} over {dist.get_backend()} (NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))})",
              flush=True)
        run = mesh_train_phase(gemma, mesh, counters)
        mark("12b")
        mesh_restore_phase(run, restart, mesh)
        launches, counted = run["launches"], run["counted"]
        del run
        torch.cuda.empty_cache()
        mark("12c")
        mesh_scan_phase(mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(PHASE12_DIR, ignore_errors=True)
    return launches, counted


def dryrun_phase(gemma: dict, real: dict) -> None:
    """Phase 13, the dry-run (``launch/dryrun.py``) on fake ``cuda``
    tensors over fake process groups: 12a's step against its real count,
    then the production cells."""
    from repro_torch.configs import ShapeSpec, get_optimizer_name
    from repro_torch.launch import dryrun, make_debug_mesh
    args, cfg = gemma["args"], gemma["config"]
    label = "13a gemma-7b fake vs real"
    with dryrun.fake_process_group(1):
        out = dryrun.trace_step(
            cfg, ShapeSpec("12a", args.seq, args.batch, "train"),
            make_debug_mesh((1, 1)),
            args.optimizer or get_optimizer_name(args.arch))
    c = out["counts"]
    rel = abs(c.flops - real["flops"]) / real["flops"]
    ratio = c.peak_bytes / real["peak"]
    print(f"{label}: FLOPs {c.flops} traced, {real['flops']} counted on the "
          f"real step (relative difference {rel:.3e}, bound "
          f"{DRYRUN_FLOP_TOL}); collectives by kind {c.collectives.count_by_kind}"
          f" traced, {real['collectives']} on the real step; peak bytes "
          f"{c.peak_bytes} traced ({c.peak_bytes / 1e9:.2f} GB, arguments "
          f"{c.argument_bytes / 1e9:.2f} GB) against 12a's "
          f"max_memory_allocated {real['peak'] / 1e9:.2f} GB: ratio "
          f"{ratio:.4f} (bound 1 +- {DRYRUN_PEAK_TOL}); trace "
          f"{out['seconds']:.1f} s; the real step's flash launches "
          f"{real['launches']}", flush=True)
    require(rel <= DRYRUN_FLOP_TOL, "13a: the trace's FLOPs are off")
    require(c.collectives.count_by_kind == real["collectives"],
            "13a: the trace's collectives differ from the real step's")
    require(abs(ratio - 1) <= DRYRUN_PEAK_TOL,
            "13a: the trace's peak is off the measured one")
    mark("13b")
    from repro_torch.launch.dryrun import dryrun_cell
    for arch, shape, multi_pod in DRYRUN_CELLS:
        rec = dryrun_cell(arch, shape, multi_pod=multi_pod, verbose=False)
        head = f"13b [{rec['mesh']}] {arch} {shape}"
        if rec["status"] != "ok":
            print(f"{head}: {rec['status']} {rec.get('error', '')}\n"
                  f"{rec.get('traceback', '')}", flush=True)
        require(rec["status"] == "ok", f"{head}: {rec['status']}")
        r, coll = rec["roofline"], rec["collectives"]["bytes_by_kind"]
        print(f"{head}: bytes a device "
              f"{rec['memory']['total_bytes_per_device'] / 2**30:.2f} GiB "
              f"(arguments {rec['memory']['argument_size_in_bytes'] / 2**30:.2f}"
              f" GiB), FLOPs a device {r['flops']:.4e}, local op bytes "
              f"{r['hbm_bytes']:.4e}, collective wire bytes "
              + ", ".join(f"{k} {v:.4e}" for k, v in sorted(coll.items()))
              + f"; under {r['device']} constants t_compute "
              f"{r['t_compute_s'] * 1e3:.2f} ms, t_memory "
              f"{r['t_memory_s'] * 1e3:.2f} ms, t_collective "
              f"{r['t_collective_s'] * 1e3:.2f} ms, bound {r['bottleneck']}, "
              f"mfu_bound {r['mfu_bound']:.4f}, useful_flops_ratio "
              f"{r['useful_flops_ratio']:.4f}; trace {rec['lower_s']:.1f} s"
              + (f"; extrapolated {rec['extrapolated']}"
                 if "extrapolated" in rec else ""), flush=True)
        require(("extrapolated" in rec) == (arch == XLSTM),
                f"{head}: extrapolated where it should not be, or not "
                f"where it should")
        if rec["kind"] == "train":
            require(r["useful_flops_ratio"] <= 1,
                    f"{head}: more useful FLOPs than counted ones")


def paper_phase(card: str) -> None:
    """14a: profile, preprocess, predict and measure (``PredictionRun``)
    at the reference test's saturated case, against the Lin and Cynthia
    baselines; then ``predict_many``'s pool against its serial run."""
    from repro_torch.core.predictor import PredictionRun, prediction_error
    from repro_torch.core.sweep import predict_many
    t0 = time.time()
    run = PredictionRun(**PAPER_CASE).prepare()
    t_prep = time.time() - t0
    meas = run.measure(PAPER_W, steps=PAPER_MEASURE_STEPS)
    pred = run.predict(PAPER_W)
    errs = {"des": prediction_error(pred, meas)}
    for method in ("lin", "cynthia"):
        errs[method] = prediction_error(
            run.predict_baseline(PAPER_W, method), meas)
    t_all = time.time() - t0
    print(f"14a {PAPER_CASE['dnn']} batch {PAPER_CASE['batch_size']} on "
          f"{PAPER_CASE['platform']}, W = {PAPER_W}: measured {meas!r} ex/s, "
          f"DES {pred!r} ex/s; errors DES {errs['des']:.4f} (bound "
          f"{PAPER_ERR}), Lin {errs['lin']:.4f}, Cynthia "
          f"{errs['cynthia']:.4f}; host seconds: profile and calibration "
          f"{t_prep:.2f}, all {t_all:.2f} (host time; card {card})",
          flush=True)
    require(errs["des"] < PAPER_ERR, "14a: the DES's error is over its bound")
    require(errs["des"] < max(errs["lin"], errs["cynthia"]),
            "14a: the DES does not beat the baselines at saturation")
    t0 = time.time()
    parallel = predict_many(run, PAPER_SWEEP_W)
    t_par = time.time() - t0
    os.environ["REPRO_SWEEP_SERIAL"] = "1"
    try:
        t0 = time.time()
        serial = predict_many(run, PAPER_SWEEP_W)
        t_ser = time.time() - t0
    finally:
        del os.environ["REPRO_SWEEP_SERIAL"]
    print(f"14a predict_many W = {PAPER_SWEEP_W}: pool {parallel}, serial "
          f"{serial}, bit-equal {parallel == serial}; host seconds pool "
          f"{t_par:.2f}, serial {t_ser:.2f} (host time; card {card})",
          flush=True)
    require(parallel == serial, "14a: the pool's predictions differ from "
            "the serial run's")


def run_module(label: str, module: str, argv, led: Path, timeout: int):
    """``python -m module argv`` from the checkout's root with its ledger
    at ``led``, each stdout line printed under ``label``. Serial
    (``REPRO_SWEEP_SERIAL=1``): the pool's workers would each re-import
    the module, and with it torch (about 50 s of host time on an H100
    machine); 14a, 15c and 16b hold the pools against serial runs.
    Returns the exit code, the stdout lines and the host seconds."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_LEDGER": str(led), "REPRO_SWEEP_SERIAL": "1"}
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    seconds = time.time() - t0
    lines = out.stdout.splitlines()
    for line in lines:
        print(f"{label} | {line}")
    if out.returncode:
        print(out.stderr[-4000:], flush=True)
    return out.returncode, lines, seconds


def run_whatif(label: str, argv, led: Path, timeout: int):
    """``python -m repro_torch.launch.whatif argv`` through
    :func:`run_module`; a non-zero exit fails. Returns the stdout lines
    and the host seconds."""
    code, lines, seconds = run_module(label, "repro_torch.launch.whatif",
                                      argv, led, timeout)
    require(code == 0, f"{label}: the what-if exited {code}")
    return lines, seconds


def whatif_phase(card: str) -> None:
    """14b: the what-if's PS-cluster mode as a user runs it, with a trace
    exported and the run ledger on; the trace validated and the ledger
    read back."""
    from repro_torch.obs import ledger, report
    from repro_torch.obs.view import summarize, validate_chrome_trace
    PHASE14_DIR.mkdir(parents=True, exist_ok=True)
    try:
        trace, led = PHASE14_DIR / "t.json", PHASE14_DIR / "l.jsonl"
        _, seconds = run_whatif("14b", [*WHATIF_ARGV, "--export-trace",
                                        str(trace)], led, timeout=600)
        with open(trace) as f:
            doc = json.load(f)
        problems = validate_chrome_trace(doc)
        records = ledger.read(str(led))
        summary = report.summarize(records)
        print(f"14b what-if --ps-cluster: exit 0 in {seconds:.2f} host "
              f"seconds (host time; card {card}); trace "
              f"{summarize(doc)['events']} events, problems {problems}; "
              f"ledger {[r['kind'] for r in records]}, report {summary}",
              flush=True)
        require(not problems, "14b: the exported trace is not valid")
        require(list(summary) == ["whatif_ps"]
                and summary["whatif_ps"]["runs"] == 1,
                "14b: the ledger does not hold the what-if's record")
    finally:
        shutil.rmtree(PHASE14_DIR, ignore_errors=True)


def ps_template(ev, layers: int, seed: int, num_ps: int = 1,
                size=(2e6, 3e7), fwd=(.005, .05), bwd=(.01, .08)):
    """The reference tests' PS-shaped synthetic step: download -> fwd per
    layer, then bwd -> upload, layers round-robin over the PS shards. The
    default ranges are ``tests/test_batched_equivalence.py``'s, 15c passes
    ``tests/test_fleet.py``'s."""
    import random
    rng = random.Random(seed)

    def link(kind, i):
        return kind if num_ps == 1 else f"{kind}:{i % num_ps}"

    ops, fwd_prev = [], None
    for i in range(layers):
        dl = len(ops)
        ops.append(ev.Op(f"dl{i}", link("downlink", i),
                         size=rng.uniform(*size)))
        deps = (dl,) if fwd_prev is None else (dl, fwd_prev)
        fwd_prev = len(ops)
        ops.append(ev.Op(f"fwd{i}", "worker", duration=rng.uniform(*fwd),
                         deps=deps))
    bwd_prev = fwd_prev
    for i in reversed(range(layers)):
        b = len(ops)
        ops.append(ev.Op(f"bwd{i}", "worker", duration=rng.uniform(*bwd),
                         deps=(bwd_prev,)))
        bwd_prev = b
        ops.append(ev.Op(f"ul{i}", link("uplink", i),
                         size=rng.uniform(*size), deps=(b,)))
    return ev.StepTemplate(ops=ops)


def batched_phase(card: str) -> None:
    """15a: the lockstep engine against the scalar engine on a synthetic
    family, then on the paper's profiled templates."""
    from repro_torch.core import events as ev
    from repro_torch.core.batched import (Scenario, fallback_histogram,
                                          run_scenarios)
    from repro_torch.core.predictor import PredictionRun
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.sweep import predict_many

    def fingerprint(tr):
        return (tr.step_completions, tr.staleness, tr.meta["sim_end_time"],
                tr.meta["num_events"], tr.meta["num_versions"])

    tpls = [ps_template(ev, 3, 0, num_ps=2), ps_template(ev, 4, 1, num_ps=2)]
    scens = [Scenario(SimConfig(
        resources=ev.ps_resources(1e9, 2), link_policy="http2", win=2.8e6,
        steps_per_worker=5, warmup_steps=2, seed=s, service_jitter=0.08,
        stall_alpha=2e-9, stall_rtt=5e-4), tpls, 8)
        for s in range(BATCHED_SEEDS)]
    t0 = time.time()
    auto = run_scenarios(scens, engine="auto", min_batch=1)
    t_auto = time.time() - t0
    t0 = time.time()
    scalar = run_scenarios(scens, engine="scalar")
    t_scalar = time.time() - t0
    same = sum(fingerprint(a) == fingerprint(b)
               for a, b in zip(auto, scalar))
    lockstep = sum(t.meta["engine"] == "batched" for t in auto)
    print(f"15a w8_ps2_2tpl x {len(scens)}: {same}/{len(scens)} "
          f"fingerprints equal; lockstep {lockstep}/{len(scens)}, fallback "
          f"histogram {fallback_histogram(auto)}; host seconds batched "
          f"{t_auto:.2f}, scalar {t_scalar:.2f} (host time; card {card})",
          flush=True)
    require(same == len(scens), "15a: the batched engine's traces differ "
            "from the scalar engine's")
    require(lockstep > 0, "15a: no scenario ran lockstep")
    run = PredictionRun(**BATCHED_CASE).prepare()
    t0 = time.time()
    batched = predict_many(run, BATCHED_W, n_runs=BATCHED_RUNS, batch=True)
    t_b = time.time() - t0
    os.environ["REPRO_SWEEP_SERIAL"] = "1"
    try:
        t0 = time.time()
        serial = predict_many(run, BATCHED_W, n_runs=BATCHED_RUNS)
        t_s = time.time() - t0
    finally:
        del os.environ["REPRO_SWEEP_SERIAL"]
    print(f"15a predict_many {BATCHED_CASE['dnn']} batch "
          f"{BATCHED_CASE['batch_size']} W = {BATCHED_W} x {BATCHED_RUNS} "
          f"runs: batched {batched}, serial {serial}, bit-equal "
          f"{batched == serial}; host seconds batched {t_b:.2f}, serial "
          f"{t_s:.2f} (host time; card {card})", flush=True)
    require(batched == serial, "15a: predict_many(batch=True) differs from "
            "the serial run on the paper's templates")


def fleet_whatif_phase(card: str) -> None:
    """15b: the fleet what-if as a user runs it, with a trace exported and
    the ledger pointed into the phase's directory (fleet mode writes no
    record)."""
    from repro_torch.obs.view import summarize, validate_chrome_trace
    PHASE15_DIR.mkdir(parents=True, exist_ok=True)
    try:
        trace, led = PHASE15_DIR / "fleet.json", PHASE15_DIR / "l.jsonl"
        lines, seconds = run_whatif("15b", [*FLEET_ARGV, "--export-trace",
                                            str(trace)], led, timeout=300)
        got = [line.replace(str(trace), "...") for line in lines]
        with open(trace) as f:
            doc = json.load(f)
        problems = validate_chrome_trace(doc)
        print(f"15b what-if --fleet: exit 0 in {seconds:.2f} host seconds "
              f"(host time; card {card}); lines equal to the reference's "
              f"{got == FLEET_LINES}; trace {summarize(doc)['events']} "
              f"events, problems {problems}; ledger written "
              f"{led.exists()}", flush=True)
        require(got == FLEET_LINES,
                "15b: the fleet what-if's lines differ from the reference's")
        require(not problems, "15b: the exported trace is not valid")
        require(not led.exists(), "15b: fleet mode wrote a ledger record")
    finally:
        shutil.rmtree(PHASE15_DIR, ignore_errors=True)


def fleet_phase(card: str) -> None:
    """15c: the fleet engine through the process pool against its serial
    run, and the ``FleetEmulator`` against the merged DES."""
    from repro_torch.core import events as ev
    from repro_torch.core.fleet import (FleetConfig, FleetJob,
                                        FleetSimulation)
    from repro_torch.core.paper_models import PAPER_DNNS, PLATFORMS
    from repro_torch.core.predictor import (calibrate_overhead,
                                            preprocess_profile)
    from repro_torch.core.sweep import simulate_fleet_task, simulate_fleets
    from repro_torch.core.topology import Node, Placement, Rack, Topology
    from repro_torch.emulator.cluster import (FleetEmulator,
                                              profile_single_worker)

    def job(name, workers, seed, **kw):
        return FleetJob(name=name, workers=workers, ps_hosts=("h0",),
                        seed=seed, batch_size=8, steps_per_worker=40,
                        warmup_steps=8, **kw)

    tasks = []
    for oversub in (1.0, 2.0, 4.0):
        cfg = FleetConfig(topology=Topology(
            workers=(Node("h0", rack="r0", nic=2.0),)
            + tuple(Node(f"w{i}", rack="r1") for i in range(6)),
            racks=(Rack("r0", oversubscription=oversub), Rack("r1")),
            placement=Placement(("h0",)), bandwidth=1e9), jobs=(
            job("A", ("w0", "w1", "w2"), 0, service_jitter=0.05),
            job("B", ("w4", "w5"), 1)))
        steps = [ps_template(ev, 4, s, size=(2e6, 2e7), fwd=(.004, .03),
                             bwd=(.008, .05)) for s in range(2)]
        tasks.append((cfg, {"A": steps, "B": steps}, True))
    t0 = time.time()
    pooled = simulate_fleets(tasks, max_workers=len(tasks))
    t_pool = time.time() - t0
    t0 = time.time()
    serial = [simulate_fleet_task(t) for t in tasks]
    t_ser = time.time() - t0
    tputs = [ft.throughputs(t[0]) for ft, t in zip(pooled, tasks)]
    print(f"15c simulate_fleets, the two-job pair at oversubscription 1, 2, "
          f"4: {tputs}; pool bit-equal to serial {pooled == serial}; host "
          f"seconds pool {t_pool:.2f}, serial {t_ser:.2f} (host time; card "
          f"{card})", flush=True)
    require(pooled == serial, "15c: the pool's fleet runs differ from the "
            "serial runs")

    plat, dnn, batch = PLATFORMS["private_cpu"], PAPER_DNNS["alexnet"], 8
    topo = Topology(workers=(Node("h0", nic=2.0),)
                    + tuple(Node(f"w{i}") for i in range(4)),
                    placement=Placement(("h0",)), bandwidth=plat.bandwidth)
    overhead = calibrate_overhead(plat, seed=0)
    tpls = preprocess_profile(profile_single_worker(
        dnn, batch, plat, steps=14, seed=0), overhead)
    jobs = tuple(FleetJob(
        name=n, workers=ws, ps_hosts=("h0",), batch_size=batch,
        steps_per_worker=30, warmup_steps=6, seed=sd, win=plat.win_mu,
        stall_alpha=overhead.alpha, stall_rtt=plat.rtt,
        service_jitter=plat.noise_bandwidth)
        for n, ws, sd in (("A", ("w0", "w1"), 0), ("B", ("w2", "w3"), 1)))
    cfg = FleetConfig(topology=topo, jobs=jobs)
    t0 = time.time()
    sim = FleetSimulation(cfg)
    des = sim.run({"A": tpls, "B": tpls}, merged=True).throughputs(cfg)
    alone = {j.name: sim.run_alone(j.name, {"A": tpls, "B": tpls},
                                   merged=True).jobs[j.name].throughput(
                 j.batch_size, warmup_steps=j.warmup_steps)
             for j in jobs}
    wl = dict(dnn=dnn, batch_size=batch, platform=plat)
    emu = FleetEmulator(cfg, {"A": dict(wl), "B": dict(wl)})
    emu.run(steps_per_worker=30)
    emu_tput = emu.throughputs(warmup_steps=6)
    seconds = time.time() - t0
    rel = {n: abs(des[n] - emu_tput[n]) / emu_tput[n] for n in des}
    print(f"15c FleetEmulator parity (alexnet batch 8, two jobs of 2 "
          f"workers on one PS host): DES {des}, alone {alone}, emulator "
          f"{emu_tput}, relative gap {rel} (bound {FLEET_PARITY}); "
          f"{seconds:.2f} host seconds (host time; card {card})",
          flush=True)
    require(all(r < FLEET_PARITY for r in rel.values()),
            "15c: the DES and the fleet emulator disagree past the bound")
    require(all(des[n] <= alone[n] * (1 + 1e-9) for n in des),
            "15c: a job ran faster contended than alone")


def mesh_train_phase(gemma: dict, mesh, counters) -> dict:
    """12a: phase 3's gemma-7b path with params, optimizer state and
    batches as DTensors over ``mesh``, through ``make_train_step(cfg, opt,
    mesh)``; gated against phase 3's run of the same seed and batches."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_optimizer_name
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (batch_shardings, make_train_step,
                                          opt_state_shardings)
    from repro_torch.models import init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.parallel.sharding import distribute, params_shardings
    from repro_torch.tree import leaves

    args, cfg, label = gemma["args"], gemma["config"], "12a gemma-7b mesh"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    data = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)
    params = init_params(
        torch.Generator(device="cuda").manual_seed(args.seed), cfg)
    psh = params_shardings(params, mesh)
    params = distribute(params, psh)
    opt = make_optimizer(args.optimizer or get_optimizer_name(args.arch),
                         lr=args.lr)
    state = opt.init(params)
    osh = opt_state_shardings(state, mesh)
    step_fn = make_train_step(cfg, opt, mesh)

    def next_batch() -> dict:
        batch = {k: x.cuda() for k, x in data.next_batch().items()}
        return distribute(batch, batch_shardings(batch, mesh))

    def train(batch) -> float:
        nonlocal params, state
        params, state, metrics = step_fn(params, state, batch)
        return float(metrics["loss"])          # waits for the step

    def step() -> float:
        return train(next_batch())

    for c in counters.values():
        c.launches = 0
    ops.local_map_calls.clear()
    losses, step_ms = [], []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        losses.append(step())
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {k: c.launches for k, c in counters.items()}
    regions = dict(ops.local_map_calls)
    peak = torch.cuda.max_memory_allocated()
    misplaced = sum(not isinstance(x, DTensor) or x.placements != s.placements
                    for x, s in zip(leaves(params), leaves(psh)))
    misplaced += sum(not isinstance(x, int) and (
        not isinstance(x, DTensor) or x.placements != s.placements)
        for x, s in zip(leaves(state), leaves(osh)))
    n_leaves = len(list(leaves(params))) + len(list(leaves(state)))
    steady = statistics.median(step_ms[1:])
    tokens = args.batch * args.seq
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, gemma["losses"]))
    print(f"{label}: param placements, e.g. embed "
          f"{params['embed'].placements}, scan/s0_attn/mlp/wo "
          f"{params['scan']['s0_attn']['mlp']['wo'].placements}")
    print(f"{label} losses: " + " ".join(f"{x:.6f}" for x in losses)
          + "; phase 3's: " + " ".join(f"{x:.6f}" for x in gemma["losses"])
          + f"; largest relative difference {rel:.3e} (bound "
          f"{MESH_LOSS_TOL}), bit-equal: {losses == gemma['losses']}")
    print(f"{label} ms/step: " + " ".join(f"{x:.1f}" for x in step_ms)
          + f" (median after the first {steady:.1f}; phase 3's "
          f"{gemma['steady_ms']:.1f})")
    print(f"{label} tokens/s: {tokens / steady * 1e3:.1f}, phase 3's "
          f"{tokens / gemma['steady_ms'] * 1e3:.1f} (ratio "
          f"{gemma['steady_ms'] / steady:.4f})  peak memory "
          f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB)  launches "
          + ", ".join(f"{k} {n}" for k, n in launches.items())
          + f"; leaves not DTensors with their rule's placements: "
          f"{misplaced} of {n_leaves}")
    print(f"{label}: regions run under local_map: {len(regions)} ("
          + "; ".join(f"{k} {n}x" for k, n in regions.items()) + ")",
          flush=True)
    require(launches["flash_attention"]
            == gemma["per_step"]["attn"] * args.steps,
            "12a: flash launch count is off on the DTensor path")
    require(rel <= MESH_LOSS_TOL, "12a: the DTensor path's losses moved")
    require(misplaced == 0, "12a: a leaf lost its DTensor placements")
    require(peak < PEAK_LIMIT, f"12a: peak {peak / 1e9:.2f} GB")
    prof, wall_ms = profiled(step)
    report_profile(f"{label} profile of one more step", prof, wall_ms)
    return {"params": params, "opt_state": state, "config": cfg,
            "launches": launches["flash_attention"],
            "counted": counted_step(train, next_batch(), counters, peak)}


def counted_step(train, batch, counters, peak: int) -> dict:
    """13a's real side: one more step of 12a's path on a batch already on
    the mesh, its FLOPs counted by ``FlopCounterMode`` and its collectives
    by ``CommDebugMode`` (entered first, so that the FLOP counter, on top,
    sees each DTensor op once), launch counts set to 0 just before and
    read just after."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode
    for c in counters.values():
        c.launches = 0
    with CommDebugMode() as comm, FlopCounterMode(display=False) as flops:
        train(batch)
    kinds = {}
    for op, n in comm.get_comm_counts().items():
        name = getattr(op, "__name__", str(op))
        kind = next((k for part, k in COMM_KINDS if part in name), name)
        kinds[kind] = kinds.get(kind, 0) + n
    return {"flops": flops.get_total_flops(),
            "collectives": {k: n for k, n in kinds.items() if n},
            "launches": counters["flash_attention"].launches, "peak": peak}


def mesh_restore_phase(run: dict, restart: dict, mesh) -> None:
    """12b: 12a's final state saved, evicted from the page cache, and
    restored onto the mesh from ``meta`` targets; every leaf against the
    saved one and the restore-time rules."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import checkpoint as ck
    from repro_torch.parallel.sharding import params_shardings
    from repro_torch.tree import leaves, tree_map
    label = "12b gemma-7b mesh"
    d = PHASE12_DIR / "ckpt"
    d.mkdir()
    want = state_bytes(run["config"])
    free = shutil.disk_usage(d).free
    require(free >= DISK_FACTOR * want,
            f"12b: {free / 1e9:.1f} GB free, under {DISK_FACTOR}x the "
            f"{want / 1e9:.2f} GB checkpoint")
    saved = {"params": run["params"], "opt_state": run["opt_state"]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step_dir = Path(ck.save(str(d), 5, saved, metadata={"step": 5}))
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(step_dir)
    evict(step_dir)
    targets = tree_map(lambda x: x if isinstance(x, int) else torch.empty(
        x.shape, dtype=x.dtype, device="meta").requires_grad_(
        x.requires_grad), saved)
    t0 = time.perf_counter()
    got, meta = ck.restore(str(d), targets, mesh=mesh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0

    def unequal(w, g, s) -> int:
        if isinstance(w, int):
            return int(w != g)
        return int(not (isinstance(g, DTensor)
                        and g.placements == s.placements
                        and g.requires_grad == w.requires_grad
                        and torch_equal(w.full_tensor(), g.full_tensor())))
    # matched by key: the restored tree's dicts are in sorted-key order
    bad = sum(leaves(tree_map(unequal, saved, got,
                              params_shardings(targets, mesh))))
    print(f"{label}: checkpoint {nbytes} bytes ({nbytes / 1e9:.2f} GB); save "
          f"of the DTensor state {save_s:.3f} s ({nbytes / save_s / 1e9:.2f} "
          f"GB/s; 8a: {restart['bytes'] / restart['save_s'] / 1e9:.2f}); "
          f"restore onto the mesh {restore_s:.3f} s "
          f"({nbytes / restore_s / 1e9:.2f} GB/s, cold; 8a into fresh tensors: "
          f"{restart['bytes'] / restart['cold_s'] / 1e9:.2f}); leaves unequal "
          f"or off their rules' placements: {bad} of "
          f"{len(list(leaves(saved)))}", flush=True)
    require(bad == 0 and meta["step"] == 5,
            "12b: the state restored onto the mesh differs")


def mesh_scan_phase(mesh) -> None:
    """12c: the scan kernel forward and reverse on DTensors at its path
    shape, against the plain tensors' call: bit-equal."""
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.kernels import ops
    from repro_torch.kernels.rglru_scan import rglru_scan_fwd
    gen = torch.Generator(device="cuda").manual_seed(12)
    a = torch.sigmoid(torch.randn(RG_SHAPE, device="cuda",
                                  generator=gen)) * 0.2 + 0.8
    b = 0.1 * torch.randn(RG_SHAPE, device="cuda", generator=gen)
    g = torch.randn(RG_SHAPE, device="cuda", generator=gen)
    placements = (Shard(0), Shard(2))      # act_rnn: batch, width
    plain = [x.clone().requires_grad_() for x in (a, b)]
    dts = [distribute_tensor(x, mesh, placements).requires_grad_()
           for x in (a, b)]
    before = rglru_scan_fwd.launches
    h = ops.rglru_scan(*dts)
    h.backward(distribute_tensor(g, mesh, h.placements))
    launched = rglru_scan_fwd.launches - before
    want = ops.rglru_scan(*plain)
    want.backward(g)
    torch.cuda.synchronize()
    same = [torch_equal(x.full_tensor(), y) for x, y in
            ((h, want), (dts[0].grad, plain[0].grad),
             (dts[1].grad, plain[1].grad))]
    print(f"12c rglru_scan on DTensors {RG_SHAPE} fp32 {placements}: "
          f"launches {launched} (forward and reverse), h {h.placements}; "
          f"bit-equal to the plain call: h {same[0]}, da {same[1]}, "
          f"db {same[2]}", flush=True)
    require(launched == 2 and all(same),
            "12c: the scan on DTensors differs from the plain call")


def calibration_phase(card: str) -> None:
    """16a: ``examples/calibration.md``'s drifted cluster through the
    calibration package: observe, save the corpus, fit, re-predict; the
    identity profile's inertness; a nominal and a drifted ``ClosedLoop``
    with the ledger on; then the calibration CLI and ``whatif
    --calibrate`` as a user runs them."""
    from dataclasses import replace

    from repro_torch.calibrate.extract import load_trace_runs, save_traces
    from repro_torch.calibrate.loop import (DEFAULT_GATE, ClosedLoop,
                                            fit_from_runs, identity_profile)
    from repro_torch.core.paper_models import PAPER_DNNS, PLATFORMS
    from repro_torch.core.predictor import PredictionRun, prediction_error
    from repro_torch.core.simulator import Simulation
    from repro_torch.emulator.cluster import observe_run
    from repro_torch.obs import ledger, report
    shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    traces = PHASE16_DIR / "traces"
    try:
        t0 = time.time()
        nominal = PLATFORMS[CAL_RUN["platform"]]
        drifted = replace(nominal,
                          worker_flops=nominal.worker_flops / CAL_COMPUTE,
                          ps_update_bw=nominal.ps_update_bw / CAL_COMPUTE,
                          bandwidth=nominal.bandwidth * CAL_NIC)
        run = PredictionRun(**CAL_RUN).prepare()
        dnn = PAPER_DNNS[CAL_RUN["dnn"]]
        measured, steps = observe_run(dnn, CAL_RUN["batch_size"], drifted,
                                      num_workers=CAL_W, steps=CAL_STEPS,
                                      warmup_steps=CAL_STEPS)
        save_traces(str(traces / "run0.json"), steps)
        open_loop = run.predict(CAL_W)
        prof = fit_from_runs(load_trace_runs(str(traces)), run=run)
        fitted = run.with_calibration(prof).predict(CAL_W)
        errs = (prediction_error(open_loop, measured),
                prediction_error(fitted, measured))
        print(f"16a {CAL_RUN['dnn']} batch {CAL_RUN['batch_size']} on "
              f"{CAL_RUN['platform']} drifted (compute x{CAL_COMPUTE}, NIC "
              f"x{CAL_NIC}), W = {CAL_W}: measured {measured!r} ex/s, "
              f"open loop {open_loop!r} (error {errs[0]!r}), fitted "
              f"{fitted!r} (error {errs[1]!r}); profile {prof.digest}, "
              f"{prof.sample_counts}; on a CPU host: profile {CAL_CPU[0]}, "
              f"errors {CAL_CPU[1]!r} -> {CAL_CPU[2]!r}, equal "
              f"{(prof.digest, *errs) == CAL_CPU}; {time.time() - t0:.2f} "
              f"host seconds (host time; card {card})", flush=True)
        require(errs[0] > DEFAULT_GATE, "16a: the drifted cluster's "
                "open-loop error is under the gate")
        require(errs[1] < errs[0], "16a: the fit does not shrink the error")

        def trace_of(r):
            cfg, tpls, w, _b, _warm = r.prediction_tasks(CAL_W, 1)[0]
            cfg.record_trace = True
            return Simulation(cfg).run(tpls, w)
        ident = identity_profile(run)
        plain, cal = trace_of(run), trace_of(run.with_calibration(ident))
        inert = (plain.step_completions == cal.step_completions
                 and [(r.name, r.start, r.end) for r in plain.records]
                 == [(r.name, r.start, r.end) for r in cal.records])
        print(f"16a identity profile {ident.digest}: DES trace of "
              f"{len(cal.records)} records bit-equal {inert}, digest "
              f"stamped {cal.meta.get('calibration_digest') == ident.digest}",
              flush=True)
        require(inert and cal.meta.get("calibration_digest") == ident.digest,
                "16a: the identity profile moves the DES")

        t0 = time.time()
        nominal_loop = ClosedLoop(run=run, num_workers=2, n_runs=1)
        for _ in range(2):
            nominal_loop.round()
        led = PHASE16_DIR / "ledger.jsonl"

        def observe(r, w):
            return observe_run(PAPER_DNNS[r.dnn], r.batch_size, drifted, w,
                               steps=CAL_STEPS, warmup_steps=CAL_STEPS)
        ledger.enable(str(led))
        try:
            drift_loop = ClosedLoop(run=run, num_workers=CAL_W,
                                    observe=observe, gate=CAL_LOOP_GATE)
            for _ in range(2):
                drift_loop.round()
        finally:
            ledger.disable()
        recs = [r for r in ledger.read(str(led))
                if r["kind"] == "recalibrated"]
        first = drift_loop.history[0]
        print(f"16a ClosedLoop nominal W = 2, 2 rounds: errors "
              f"{nominal_loop.errors()}, recalibrated "
              f"{[h.recalibrated for h in nominal_loop.history]}; drifted W "
              f"= {CAL_W} gate {CAL_LOOP_GATE}: errors "
              f"{drift_loop.errors()}, recalibrated "
              f"{[h.recalibrated for h in drift_loop.history]}, round 0 "
              f"{first.err_before!r} -> {first.err_after!r} profile "
              f"{first.profile_digest}; ledger records {len(recs)} "
              f"recalibrated, report {report.summarize(recs)}; "
              f"{time.time() - t0:.2f} host seconds (host time; card "
              f"{card})", flush=True)
        require(not any(h.recalibrated for h in nominal_loop.history),
                "16a: the nominal platform recalibrated")
        require(first.recalibrated and first.err_after < first.err_before,
                "16a: the drifted loop did not refit in round 0")
        require(len(recs) == sum(h.recalibrated for h in drift_loop.history)
                and all(set(r) == RECALIBRATED_KEYS for r in recs)
                and recs[0]["calibration_digest"] == first.profile_digest
                and recs[0]["round"] == 0
                and recs[0]["err_before"] == first.err_before,
                "16a: the recalibrated ledger record is not the round's")

        fitted_path, ident_path = (PHASE16_DIR / "profile.json",
                                   PHASE16_DIR / "identity.json")
        ident.save(str(ident_path))
        runs = [run_module("16a", "repro_torch.calibrate", argv,
                           PHASE16_DIR / "cli.jsonl", 300)
                for argv in (["fit", str(traces), "--platform",
                              CAL_RUN["platform"], "-o", str(fitted_path)],
                             ["show", str(fitted_path)],
                             ["check", str(fitted_path), str(ident_path)])]
        codes, wrote = [r[0] for r in runs], runs[0][1]
        seconds = sum(r[2] for r in runs)
        lines, s = run_whatif("16a", [*CAL_WHATIF_ARGV, str(traces)],
                              PHASE16_DIR / "whatif.jsonl", timeout=300)
        seconds += s
        want = (f"# calibration: {traces} -> profile {prof.digest} "
                f"({len(steps)} steps, {len(prof.op_times)} ops, "
                f"{len(prof.link_capacity)} links)")
        print(f"16a python -m repro_torch.calibrate fit / show / check: exit "
              f"codes {codes}; whatif --calibrate: exit 0, its calibration "
              f"line the fit's {lines[:1] == [want]}; {seconds:.2f} host "
              f"seconds, 4 processes (host time; card {card})", flush=True)
        require(codes == [0, 0, 1], "16a: the calibration CLI's exit codes "
                "are not 0, 0, 1")
        require(wrote == [f"wrote {fitted_path} (digest {prof.digest}, "
                          f"{len(steps)} steps)"],
                "16a: the CLI's fit is not the in-process fit")
        require(lines[:1] == [want],
                "16a: whatif --calibrate's profile is not the fit's")
    finally:
        shutil.rmtree(PHASE16_DIR, ignore_errors=True)


def rack_pool_topology(num_shards: int, oversub: float = 8.0,
                       bypass: bool = False):
    """``tests/test_placement_search.py``'s topology: the default placement
    behind an oversubscribed rack uplink, as many free nodes in the flat
    rack (``bypass``: its ``bypass_topology``, colocated conns skipping
    the NIC and rack groups)."""
    from repro_torch.core.topology import Node, Rack, Topology
    bad = tuple(Node(f"bad{p}", rack="r0") for p in range(num_shards))
    good = tuple(Node(f"good{p}", rack="r1") for p in range(num_shards))
    return Topology(
        workers=tuple(Node(f"w{i}", rack="r1") for i in range(3)),
        ps_nodes=bad + good,
        racks=(Rack("r0", oversubscription=oversub), Rack("r1")),
        bandwidth=1e2, loopback_bypass=bypass,
    ).with_placement(tuple(n.name for n in bad))


def placement_evaluator(topo, parallel: bool = True):
    """The reference test's evaluator: ``comm_heavy_steps`` (3 layers of
    200-byte pulls and pushes round-robin over the shards, 0.02 s of
    compute) at W = 3, one run of 12 steps a worker, FIFO links."""
    from repro_torch.core.events import Op, StepTemplate
    from repro_torch.core.placement_search import evaluator_from_templates
    m, ops = topo.num_shards, []
    for i in range(3):
        dn = "downlink" if m == 1 else f"downlink:{i % m}"
        up = "uplink" if m == 1 else f"uplink:{i % m}"
        dl = len(ops)
        ops.append(Op(f"d{i}", dn, size=200.0))
        ops.append(Op(f"f{i}", "worker", duration=0.02, deps=(dl,)))
        ops.append(Op(f"u{i}", up, size=200.0, deps=(dl + 1,)))
    return evaluator_from_templates(
        topo, [StepTemplate(ops=ops)], num_workers=PLACE_W, n_runs=1,
        steps_per_worker=PLACE_STEPS, link_policy="fifo", parallel=parallel)


def placement_phase(card: str) -> None:
    """16b: every strategy on the reference test's rack-pool topology, the
    surrogate against the oracle where the reference gates it, the
    evaluator's process pool against its serial run, then ``whatif
    --optimize-placement`` as a user runs it."""
    import itertools

    from repro_torch.core.placement_search import search_placement
    topo = rack_pool_topology(PLACE_SHARDS)
    t0 = time.time()
    os.environ["REPRO_SWEEP_SERIAL"] = "1"
    try:
        with placement_evaluator(topo) as ev:
            res = {s: search_placement(ev, s, seed=PLACE_SEED)
                   for s in ("exhaustive", "greedy", "anneal")}
            cands = list(itertools.product(ev.candidate_hosts(),
                                           repeat=PLACE_SHARDS))
            serial = ev.score_many(cands)
        ps_hosts = tuple(n.name for n in topo.ps_nodes)
        bypass = rack_pool_topology(PLACE_SHARDS, bypass=True)
        sur = {}
        for name, t, hosts in (("ps hosts", topo, ps_hosts),
                               ("bypass, colocated", bypass, None)):
            sur[name] = [search_placement(placement_evaluator(t), s,
                                          hosts=hosts)
                         for s in ("exhaustive", "surrogate")]
    finally:
        del os.environ["REPRO_SWEEP_SERIAL"]
    t_serial = time.time() - t0
    t0 = time.time()
    with placement_evaluator(topo, parallel=True) as ev:
        pooled = ev.score_many(cands)
    t_pool = time.time() - t0
    for s, r in res.items():
        print(f"16b {r.summary()}, rounds {r.rounds}", flush=True)
    for name, (exact, proxy) in sur.items():
        print(f"16b surrogate on {name}: {proxy.summary()}; oracle "
              f"{'/'.join(exact.placement)} {exact.throughput!r}", flush=True)
    print(f"16b {len(cands)} candidates scored through the pool equal to "
          f"the serial scores {pooled == serial}; host seconds serial "
          f"searches {t_serial:.2f}, pool {t_pool:.2f} (host time; card "
          f"{card})", flush=True)
    exact, greedy, anneal = (res[s] for s in ("exhaustive", "greedy",
                                              "anneal"))
    require(greedy.placement == exact.placement
            and greedy.throughput == exact.throughput,
            "16b: greedy does not find the oracle's placement")
    require(anneal.throughput >= greedy.throughput,
            "16b: anneal is worse than greedy")
    require(all(r.throughput > 1.5 * r.baseline_throughput
                for r in res.values()),
            "16b: a search does not escape the oversubscribed default")
    require(all(p.placement == e.placement or p.throughput == e.throughput
                for e, p in sur.values()),
            "16b: the surrogate's choice is not the oracle's")
    require(pooled == serial, "16b: the pool's scores differ from the "
            "serial run's")
    PHASE16_DIR.mkdir(parents=True, exist_ok=True)
    try:
        lines, seconds = run_whatif("16b", PLACE_WHATIF_ARGV,
                                    PHASE16_DIR / "l.jsonl", timeout=300)
    finally:
        shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    print(f"16b what-if --optimize-placement greedy: exit 0 in "
          f"{seconds:.2f} host seconds (host time; card {card}); its three "
          f"lines equal to the CPU host's {lines[-3:] == PLACE_LINES}",
          flush=True)
    require(lines[-3:] == PLACE_LINES, "16b: the placement what-if's lines "
            "differ from the CPU host's")


def surrogate_phase(card: str) -> None:
    """16c: ``surrogate_scores`` over every candidate of the 3-shard bypass
    topology with colocation, its waterfill problems solved on the card
    (``batched_waterfill(backend="torch")``) against numpy: shares within
    6d's rtol, the same top-ranked candidate."""
    import itertools

    import numpy as np
    from repro_torch.core import placement_search
    topo = rack_pool_topology(SURROGATE_SHARDS, bypass=True)
    ev = placement_evaluator(topo, parallel=False)
    cands = list(itertools.product(ev.candidate_hosts(),
                                   repeat=SURROGATE_SHARDS))
    numpy_fill = placement_search.batched_waterfill
    solved, seconds = [], {"numpy": 0.0, "torch": 0.0}

    def on_card(caps, members, weights):
        """The surrogate's call, solved by both backends."""
        t0 = time.perf_counter()
        want = numpy_fill(caps, members, weights)
        seconds["numpy"] += time.perf_counter() - t0
        numpy_fill(caps, members, weights, backend="torch")   # warm-up
        t0 = time.perf_counter()
        got = numpy_fill(caps, members, weights, backend="torch",
                         device="cuda")
        seconds["torch"] += time.perf_counter() - t0
        solved.append((members.shape, want, got))
        return got
    t0 = time.time()
    want = placement_search.surrogate_scores(ev, cands)
    t_np = time.time() - t0
    placement_search.batched_waterfill = on_card
    try:
        got = placement_search.surrogate_scores(ev, cands)
    finally:
        placement_search.batched_waterfill = numpy_fill
    ok = all(np.allclose(g, w, rtol=SURROGATE_RTOL, atol=1e-12)
             for _, w, g in solved)
    err = max(float(np.abs(g - w).max()) for _, w, g in solved)
    top = (int(np.argmax(want)), int(np.argmax(got)))
    print(f"16c surrogate of {len(cands)} candidates ({SURROGATE_SHARDS} "
          f"shards over {len(ev.candidate_hosts())} hosts, bypass): "
          f"{len(solved)} phases of problems {[s for s, _, _ in solved]}; "
          f"shares max_abs_err {err:.3e} (rtol {SURROGATE_RTOL}) "
          f"{'ok' if ok else 'FAIL'}; top candidate numpy "
          f"{'/'.join(cands[top[0]])}, card {'/'.join(cands[top[1]])}; "
          f"seconds numpy {seconds['numpy']:.4f}, torch on the card "
          f"{seconds['torch']:.4f} (host clock, copies included), the "
          f"whole numpy surrogate {t_np:.3f} (host time; card {card})",
          flush=True)
    require(ok, "16c: the card's waterfill disagrees with numpy on the "
            "surrogate's problems")
    require(top[0] == top[1] and np.allclose(got, want, rtol=SURROGATE_RTOL),
            "16c: the card's surrogate ranks another candidate first")


def mark(phase: str) -> None:
    """The seconds since the start, as each phase begins."""
    print(f"[{time.time() - START:.0f} s] phase {phase}", flush=True)


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)   # whole lines reach a log
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        code = main()
    except Exception:   # report any phase's failure and exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
